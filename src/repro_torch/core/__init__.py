"""Core BCR sparsity library (the paper's contribution)."""

from repro_torch.core.bcr import (  # noqa: F401
    BCRSpec, bcr_indices, bcr_mask, bcr_project, block_grid,
    choose_block_shape, density, is_bcr_set_member, mask_from_indices,
    pruning_rate,
)
from repro_torch.core.bcrc import (  # noqa: F401
    BCRC, TBCRC, bcrc_pack, bcrc_unpack, csr_extra_bytes, tbcrc_pack,
    tbcrc_stats, tbcrc_unpack,
)
from repro_torch.core.sparse_linear import (  # noqa: F401
    linear_apply, linear_init, pack_linear, spec_for_shape,
)
