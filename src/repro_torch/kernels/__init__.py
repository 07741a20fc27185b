"""The port's kernels: hand-written CUDA for Hopper behind wrappers that run
their plain PyTorch versions on CPU tensors.

The block-skipping matmul's names are exported here, as the reference
exports them. ``bcr_spmm_skip`` is then the function: reach that module's
launch counter with ``from repro_torch.kernels.bcr_spmm_skip import
LAUNCHES``. The other kernels' functions are not exported here, so
``from repro_torch.kernels import bcr_spmm`` (and ``paged_decode_attention``)
stay their modules."""

from repro_torch.kernels.bcr_spmm_skip import (  # noqa: F401
    SkipPacked, bcr_spmm_skip, pack_skip,
)
from repro_torch.kernels.ref import bcr_spmm_skip_ref  # noqa: F401
