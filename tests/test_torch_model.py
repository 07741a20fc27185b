"""Port vs reference, model functions: ``prefill``, paged ``decode_step`` and
``prefill_append`` logits on converted params, dense and BCR-packed, fp32
smoke config with fp32 KV pages. The reference runs its paged attention and
BCR kernels as Pallas in interpret mode (``attn_impl="paged_interpret"``,
``kernel_impl="interpret"``).

Tolerance: ``atol = rtol = 1e-4`` on logits (summation order differs
between XLA and PyTorch across two layers)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch.serve import pack_params as jpack_params  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import causal_lm  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
PS = 4                       # page size
B, S, S2 = 2, 7, 5           # batch, prompt, appended suffix


def _cfgs():
    over = dict(bcr_keep_frac=0.25, bcr_block=(16, 16), cache_dtype="float32")
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"),
                               attn_impl="paged_interpret",
                               kernel_impl="interpret", **over)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"), **over)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["dense", "packed"])
def models(request):
    jcfg, tcfg = _cfgs()
    params = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    if request.param == "packed":
        params = jpack_params(jcfg, params)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _tables(n_cols):
    # slot b owns pages 1 + b, 1 + b + B, ... (interleaved, not contiguous)
    return (1 + np.arange(n_cols)[None, :] * B
            + np.arange(B)[:, None]).astype(np.int32)


def _seat_jax(cache, pcache, dest):
    def put(pool, new):
        l = pool.shape[0]
        flat = pool.reshape(l, -1, *pool.shape[3:])
        rows = new.reshape(l, -1, *new.shape[3:])
        return flat.at[:, dest].set(rows.astype(pool.dtype)).reshape(
            pool.shape)
    st, pst = cache["stack"][0]["mixer"], pcache["stack"][0]["mixer"]
    cache["stack"][0]["mixer"] = {"k": put(st["k"], pst["k"]),
                                  "v": put(st["v"], pst["v"])}
    return cache


def test_prefill_decode_append_logits_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    jfns = jmodel_fns(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    length = np.asarray([S, S - 3], np.int32)

    # prefill (right-padded row 1 reads its logits at length - 1)
    jl, jpc = jax.jit(jfns.prefill)(jparams, {"tokens": jnp.asarray(toks),
                                              "length": jnp.asarray(length)})
    tl, tpc = causal_lm.prefill(tcfg, tparams, torch.as_tensor(toks),
                                length=torch.as_tensor(length))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # seat both prefill caches into the same page tables
    n_cols = -(-(S + 1 + S2) // PS)
    bt = _tables(n_cols)
    n_pages = 1 + B * n_cols
    pos = np.arange(S)
    dest = (bt[:, pos // PS] * PS + pos % PS).reshape(-1)
    jcache = _seat_jax(jfns.init_cache(B, 64, kv_pages=n_pages, page_size=PS),
                       jpc, jnp.asarray(dest))
    tcache = causal_lm.init_cache(tcfg, kv_pages=n_pages, page_size=PS,
                                  device="cpu")
    dt = torch.as_tensor(dest)
    for pool, new in zip(tcache, tpc):
        for key in ("k", "v"):
            pool[key].view(-1, *pool[key].shape[2:]).index_copy_(
                0, dt, new[key].reshape(-1, *new[key].shape[2:]))

    # one paged decode step from each slot's own length
    step = rng.integers(0, tcfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jcache = jax.jit(jfns.decode_step)(
        jparams, {"tokens": jnp.asarray(step),
                  "cache_len": jnp.asarray(length),
                  "block_tables": jnp.asarray(bt)}, jcache)
    tl, tcache = causal_lm.decode_step(
        tcfg, tparams, torch.as_tensor(step), tcache, torch.as_tensor(length),
        block_tables=torch.as_tensor(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # prefill-append a suffix over the cached prefix, every position scored
    suffix = rng.integers(0, tcfg.vocab_size, size=(B, S2)).astype(np.int32)
    plen = length + 1
    slen = np.asarray([S2, 2], np.int32)
    # (eager: the reference reads all_logits as a static Python flag)
    jl, _ = jfns.prefill_append(
        jparams, {"tokens": jnp.asarray(suffix),
                  "prefix_len": jnp.asarray(plen),
                  "length": jnp.asarray(slen),
                  "block_tables": jnp.asarray(bt), "all_logits": True},
        jcache)
    tl, _ = causal_lm.prefill_append(
        tcfg, tparams, torch.as_tensor(suffix), tcache,
        torch.as_tensor(plen), torch.as_tensor(bt),
        length=torch.as_tensor(slen), all_logits=True)
    for b, sl in enumerate(slen):          # rows past slen are garbage
        np.testing.assert_allclose(tl[b, :sl].numpy(),
                                   np.asarray(jl)[b, :sl], **TOL)
