"""Port vs reference, the block forms of the recurrent mixers
(``models/mixers.py``: ``rwkv_tm_apply_seq`` and ``mamba_apply_seq`` over
``layers.block_scan``), at SMOKE widths in fp32.

Inputs, cotangents and the bonus ``u`` come from a numpy seed; the other
parameters are the reference's init of one SMOKE layer (rwkv6-3b's time
mix, jamba's mamba mixer), the same numbers in both packages. Two decay
settings: the init's, and strong ones (``w0`` = +2, so w ≈ e^-7.4 a step;
``dt_proj``'s bias spread over 0..20, so Δ reaches 20), which a factored
``exp(A_t)·exp(-A_τ)`` form would overflow and a difference of long
cumulative sums would lose digits on. Lengths 3, 12, 37, 64 and 256 cover
one short block, lengths the chunk (8) does not divide (a padded tail
block) and several groups of blocks.

Compared: outputs, the final state, and gradients with respect to x and
every parameter (of a fixed random projection of the outputs and the
state) against ``jax.grad`` of the reference; the block forms against the
plain per-token loop (``chunked_checkpoint_scan`` over ``_rwkv_step`` /
``_mamba_step``); the aten ops one scan dispatches against that loop's;
and, on a fake 8-rank mesh under ``TRAIN_RULES``, that the scan runs on
local shards and equals the plain path there.

Tolerance: ``atol = rtol = 1e-5`` on outputs and states (fp32; the block
forms sum in another order than a step at a time), as
``tests/test_torch_mixers.py``. Gradients: ``rtol = 1e-5`` and ``atol =
1e-5`` times the largest magnitude of the leaf's gradient. A parameter's
gradient sums B·S tokens' terms, and under the strong decays RWKV's
(through the per-head RMS norm) cancel to elements far below the leaf's
scale: elementwise, the port's per-token loop, step for step the
reference's scan, misses the reference by up to 2.9e-5 of the leaf's
scale (``/u`` at S = 256), the block form by up to 7.2e-6 (CPU runs).
Against the per-token loop the block form's gradients are held to 5e-5 of
the scale: the two forms' distances from the reference add (the largest
seen, 2.0e-5, is d/dx at S = 3, where a head's first output is the bonus
alone and the RMS norm divides by its small size).
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import mixers as jmix  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mixers as tmix  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B = 2
LENGTHS = [3, 12, 37, 64, 256]
ARCH = {"rwkv": "rwkv6-3b", "mamba": "jamba-v0.1-52b"}
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(kind):
    jcfg = jcfgs.get_smoke_config(ARCH[kind])
    tcfg = tcfgs.get_smoke_config(ARCH[kind])
    if kind == "rwkv":
        return (dataclasses.replace(jcfg, cache_dtype="float32"),
                dataclasses.replace(tcfg, cache_dtype="float32"))
    return jcfg, tcfg


def _numpy_params(kind, decay):
    """One SMOKE layer's mixer params (numpy, fp32): the reference's init
    (key 0), ``u`` drawn from a seed, and with ``decay == "strong"`` the
    strong decays of the module docstring."""
    jcfg, _ = _cfgs(kind)
    init = jmix.rwkv_tm_init if kind == "rwkv" else jmix.mamba_init
    p = jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32),
                               init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    if kind == "rwkv":
        p["u"] = rng.normal(size=p["u"].shape).astype(np.float32) * 0.5
        if decay == "strong":
            p["w0"] = np.full_like(p["w0"], 2.0)
    elif decay == "strong":
        p["dt_proj"]["b"] = np.linspace(0.0, 20.0, p["dt_proj"]["b"].size,
                                        dtype=np.float32)
    return p


def _inputs(kind, s, seed=0):
    """x ``(B, S, d)`` and the cotangents of the outputs and the state."""
    _, tcfg = _cfgs(kind)
    rng = np.random.default_rng(seed + s)
    x = rng.normal(size=(B, s, tcfg.d_model)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    if kind == "rwkv":
        hs = tcfg.rwkv_head_size
        gs = rng.normal(size=(B, tcfg.d_model // hs, hs, hs))
    else:
        gs = rng.normal(size=(B, tcfg.mamba_expand * tcfg.d_model,
                              tcfg.mamba_d_state))
    return x, gy, gs.astype(np.float32)


def _state_key(kind):
    return "s" if kind == "rwkv" else "h"


def _tree_torch(p, grad=True):
    if isinstance(p, dict):
        return {k: _tree_torch(v, grad) for k, v in p.items()}
    return torch.tensor(p, requires_grad=grad)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _reference(kind, p, x, gy, gs):
    """The reference's (y, state, d/dx, d/dparams) of ``sum(y·gy) +
    sum(state·gs)``."""
    jcfg, _ = _cfgs(kind)
    seq = jmix.rwkv_tm_apply_seq if kind == "rwkv" else jmix.mamba_apply_seq
    key = _state_key(kind)

    def loss(params, xx):
        y, st = seq(params, xx, jcfg, impl="ref", return_state=True)
        return jnp.sum(y * gy) + jnp.sum(st[key] * gs), (y, st)

    (_, (y, st)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    return y, st, gx, gp


def _port(fn, kind, p, x, gy, gs):
    """(y, state, d/dx, d/dparams) of ``fn`` (the port's sequence form or
    the plain loop below), as :func:`_reference`."""
    _, tcfg = _cfgs(kind)
    tp = _tree_torch(p)
    tx = torch.tensor(x, requires_grad=True)
    y, st = fn(tp, tx, tcfg, return_state=True)
    loss = (y * torch.as_tensor(gy)).sum() + \
        (st[_state_key(kind)] * torch.as_tensor(gs)).sum()
    loss.backward()
    grads = {k: v.grad for k, v in _flat(tp).items()}
    return y, st, tx.grad, grads


def _plain_rwkv(params, x, cfg, return_state=False):
    """``rwkv_tm_apply_seq`` with its scan a step a token: the reference's
    form, ``chunked_checkpoint_scan`` over ``_rwkv_step``."""
    b, s_len, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    r, k, v, g, lw = tmix._rwkv_tm_inputs(params, x, tmix._shifted(x))
    u = params["u"].float()

    def body(s, inp):
        return tmix._rwkv_step(h, hs, u, s, *inp[:3], torch.exp(inp[3]))

    s0 = torch.zeros((b, h, hs, hs))
    xs = tuple(t.transpose(0, 1) for t in (r, k, v, lw))
    s_final, ys = tlayers.chunked_checkpoint_scan(
        body, s0, xs, tmix.scan_chunk(cfg, s_len))
    out = tmix._rwkv_out(params, ys.transpose(0, 1), g)
    return out, {"s": s_final, "shift": x[:, -1].to(cfg.c_dtype)}


def _plain_mamba(params, x, cfg, return_state=False):
    """``mamba_apply_seq`` with its scan a step a token
    (``chunked_checkpoint_scan`` over ``_mamba_step``)."""
    b, s, _ = x.shape
    d_in = cfg.mamba_expand * cfg.d_model
    u, z, delta, bmat, cmat, conv = tmix._mamba_ssm_inputs(params, x, cfg)
    a = -torch.exp(params["A_log"].float())

    def body(h, inp):
        return tmix._mamba_step(a, params["D"], h, *inp)

    h0 = torch.zeros((b, d_in, cfg.mamba_d_state))
    xs = tuple(t.transpose(0, 1) for t in (u, delta, bmat, cmat))
    h_final, ys = tlayers.chunked_checkpoint_scan(body, h0, xs,
                                                  tmix.scan_chunk(cfg, s))
    y = ys.transpose(0, 1).to(x.dtype) * torch.nn.functional.silu(z)
    return (tmix.linear_apply(params["out_proj"], y),
            {"h": h_final, "conv": conv})


SEQ = {"rwkv": tmix.rwkv_tm_apply_seq, "mamba": tmix.mamba_apply_seq}
PLAIN = {"rwkv": _plain_rwkv, "mamba": _plain_mamba}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=what, **TOL)


def _grad_close(got, want, what, of_scale=1e-5):
    """A gradient leaf within ``of_scale`` of its own scale (module
    docstring)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=1e-5,
                               atol=of_scale * scale, err_msg=what)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("decay", ["init", "strong"])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_block_form_matches_reference(kind, decay, s):
    """Outputs, every state leaf, and the gradients with respect to x and
    every parameter, against the reference's ``lax.scan`` and
    ``jax.grad``."""
    p = _numpy_params(kind, decay)
    x, gy, gs = _inputs(kind, s)
    jy, jst, jgx, jgp = _reference(kind, p, x, gy, gs)
    ty, tst, tgx, tgp = _port(SEQ[kind], kind, p, x, gy, gs)
    _close(ty, jy, "y")
    for key in jst:
        _close(tst[key], jst[key], f"state {key}")
    _grad_close(tgx, jgx, "d/dx")
    jflat = _flat(jgp)
    assert sorted(jflat) == sorted(tgp)
    for name, want in jflat.items():
        _grad_close(tgp[name], want, f"d/d{name}")
    assert np.isfinite(np.asarray(jy)).all()


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("decay", ["init", "strong"])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_block_form_equals_the_per_token_loop(kind, decay, s):
    """The block form against its plain version, the per-token loop, on
    the same tensors: outputs, final state and every gradient."""
    p = _numpy_params(kind, decay)
    x, gy, gs = _inputs(kind, s, seed=1)
    got = _port(SEQ[kind], kind, p, x, gy, gs)
    want = _port(PLAIN[kind], kind, p, x, gy, gs)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for key in want[1]:
        torch.testing.assert_close(got[1][key], want[1][key], **TOL)
    _grad_close(got[2], want[2], "d/dx", 5e-5)
    for name in want[3]:
        _grad_close(got[3][name], want[3][name], f"d/d{name}", 5e-5)


def test_the_scan_takes_no_chunk_rule_fallback():
    """A length the chunk does not divide (12 at chunk 8) runs padded
    blocks, not the reference's chunk-1 fallback: the block body sees two
    blocks of 8, and the padding leaves the state as 12 steps leave it."""
    seen = []
    real = tmix._wkv_blocks

    def spy(u, s, r, k, v, lw):
        seen.append(tuple(r.shape))
        return real(u, s, r, k, v, lw)

    p = _numpy_params("rwkv", "init")
    x, gy, gs = _inputs("rwkv", 12)
    tmix._wkv_blocks = spy
    try:
        _, st = tmix.rwkv_tm_apply_seq(_tree_torch(p, False),
                                       torch.as_tensor(x),
                                       _cfgs("rwkv")[1], return_state=True)
    finally:
        tmix._wkv_blocks = real
    cfg = _cfgs("rwkv")[1]
    assert seen == [(B, 2, 8, cfg.d_model // cfg.rwkv_head_size,
                     cfg.rwkv_head_size)]
    _, want = _plain_rwkv(_tree_torch(p, False), torch.as_tensor(x), cfg)
    torch.testing.assert_close(st["s"], want["s"], **TOL)


def _aten_ops(fn, kind, s):
    """Aten ops one call of ``fn`` dispatches on fake tensors at length
    ``s``, batch 2, SMOKE width (no gradient)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "aten":
                self.n += 1
            return func(*args, **(kwargs or {}))

    _, tcfg = _cfgs(kind)
    params = _tree_torch(_numpy_params(kind, "init"), False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty((B, s, tcfg.d_model))
        count = Count()
        with torch.no_grad(), count:
            fn(params, x, tcfg, return_state=True)
    return count.n


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_dispatch_count_is_a_thirty_second_of_the_loop(kind):
    """One sequence form at S = 1024 dispatches at most 1/32 of the aten
    ops the per-token loop does (~20 a token), so the loop cannot come
    back unnoticed."""
    block = _aten_ops(SEQ[kind], kind, 1024)
    plain = _aten_ops(PLAIN[kind], kind, 1024)
    assert plain > 1024 * 10, plain
    assert block * 32 <= plain, (block, plain)


_MESH = """
    import functools, json, tempfile
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import fake_group, make_mesh, run_cell
    from repro_torch.models import layers as L, mixers as M
    from repro_torch.runtime import partitioning as part
    from repro_torch.runtime.hlo_analysis import is_dtensor_type

    class NoDTensor(TorchDispatchMode):
        seen, ops = [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            NoDTensor.ops += 1
            if any(is_dtensor_type(t) for t in types):
                NoDTensor.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    def watched(real):
        def run(*args):
            assert not any(part.is_dtensor(a) for a in args)
            with NoDTensor():
                return real(*args)
        return run

    out = {}
    # (1) a train cell on a fake 2 x 4 (data x model) mesh, fake tensors:
    # no op inside either scan body (forward and recompute) sees a DTensor
    M._wkv_blocks = watched(M._wkv_blocks)
    M._ssm_blocks = watched(M._ssm_blocks)
    with tempfile.TemporaryDirectory() as td:
        for arch in ("rwkv6-3b", "jamba-v0.1-52b"):
            rec = run_cell(arch, "t", multi_pod=False, out_dir=td,
                           force=True, device="cpu", exact=True,
                           cfg_override=get_smoke_config(arch),
                           shape_override=ShapeSpec("t", 20, 8, "train"),
                           mesh_shape=(2, 4))
            out[arch] = [rec["status"], rec.get("error")]
    out["body_ops"], out["dtensor_ops"] = NoDTensor.ops, NoDTensor.seen

    # (2) real values on rank 0 of the same group: inputs laid out as the
    # scan takes them (no redistribution, so no collective is needed), the
    # scan's local result against the plain per-token loop on rank 0's
    # batch rows and channels
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    rng = np.random.default_rng(3)

    def dt(local, pl, shape):
        return DTensor.from_local(torch.as_tensor(local), mesh, pl,
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape).stride())

    errs = {}
    with part.use_rules(part.TRAIN_RULES, mesh):
        cfg = get_smoke_config("rwkv6-3b")
        b, s, d, hs = 4, 37, cfg.d_model, cfg.rwkv_head_size
        h = d // hs
        rows = [rng.normal(size=(b // 2, s, d)).astype(np.float32)
                for _ in range(3)]
        lw = -np.exp(rng.normal(size=(b // 2, s, d)).astype(np.float32))
        u = rng.normal(size=(h, hs)).astype(np.float32)
        rep = (Shard(0), Replicate())
        ins = [dt(t, rep, (b, s, d)) for t in rows + [lw]]
        y, st = M._wkv_seq(*ins, dt(u, (Replicate(), Replicate()), (h, hs)),
                           cfg)
        uu = torch.as_tensor(u)
        body = lambda c, i: M._rwkv_step(h, hs, uu, c, *i[:3],
                                         torch.exp(i[3]))
        want_s, want_y = L.chunked_checkpoint_scan(
            body, torch.zeros(b // 2, h, hs, hs),
            tuple(torch.as_tensor(t).transpose(0, 1) for t in rows + [lw]),
            1)
        errs["rwkv_y"] = float((y.to_local() - want_y.transpose(0, 1)
                                .flatten(2)).abs().max())
        errs["rwkv_s"] = float((st.to_local() - want_s).abs().max())
        errs["rwkv_placements"] = [str(y.placements), str(st.placements),
                                   list(st.shape)]

        cfg = get_smoke_config("jamba-v0.1-52b")
        d_in, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
        dl = d_in // 4
        u_l = rng.normal(size=(b // 2, s, dl)).astype(np.float32)
        delta_l = np.log1p(np.exp(rng.normal(size=(b // 2, s, dl))))
        delta_l = delta_l.astype(np.float32)
        bc = [rng.normal(size=(b // 2, s, n)).astype(np.float32)
              for _ in range(2)]
        a_log = np.log(rng.uniform(1, n, size=(dl, n))).astype(np.float32)
        d_p = rng.normal(size=(dl,)).astype(np.float32)
        ch = (Shard(0), Shard(2))
        y, hh = M._ssm_seq(dt(u_l, ch, (b, s, d_in)),
                           dt(delta_l, ch, (b, s, d_in)),
                           dt(bc[0], rep, (b, s, n)), dt(bc[1], rep, (b, s, n)),
                           dt(a_log, (Replicate(), Shard(0)), (d_in, n)),
                           dt(d_p, (Replicate(), Shard(0)), (d_in,)), cfg)
        a = -torch.exp(torch.as_tensor(a_log))
        body = lambda c, i: M._mamba_step(a, torch.as_tensor(d_p), c, *i)
        want_h, want_y = L.chunked_checkpoint_scan(
            body, torch.zeros(b // 2, dl, n),
            tuple(torch.as_tensor(t).transpose(0, 1)
                  for t in (u_l, delta_l, bc[0], bc[1])), 1)
        errs["mamba_y"] = float((y.to_local() - want_y.transpose(0, 1))
                                .abs().max())
        errs["mamba_h"] = float((hh.to_local() - want_h).abs().max())
        errs["mamba_placements"] = [str(y.placements), str(hh.placements),
                                    list(hh.shape)]
    out["errs"] = errs
    print(json.dumps(out))
"""


def test_scans_run_on_local_shards_of_a_fake_mesh():
    """Under ``TRAIN_RULES`` on a fake 8-rank (2 x 4) mesh: a train step of
    each SMOKE model runs ``ok`` with no op inside either scan body on a
    ``DTensor`` (the bodies get plain local tensors), and with real values
    on rank 0 the scan's local shard equals the plain per-token loop on
    rank 0's rows and channels (1e-5), handed back laid out as its inputs.
    In a subprocess: the fake group must not become this process's."""
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_MESH)], capture_output=True,
        text=True, timeout=600, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch in ("rwkv6-3b", "jamba-v0.1-52b"):
        assert out[arch][0] == "ok", out[arch]
    assert out["body_ops"] > 0
    assert out["dtensor_ops"] == []
    errs = out["errs"]
    for key in ("rwkv_y", "rwkv_s", "mamba_y", "mamba_h"):
        assert errs[key] <= 1e-5, (key, errs[key])
    assert errs["rwkv_placements"][:2] == ["(Shard(dim=0), Replicate())"] * 2
    assert errs["rwkv_placements"][2] == [4, 4, 16, 16]
    assert errs["mamba_placements"][:2] == ["(Shard(dim=0), Shard(dim=2))",
                                            "(Shard(dim=0), Shard(dim=1))"]
    assert errs["mamba_placements"][2] == [4, 128, 8]
