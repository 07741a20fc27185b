"""Port vs reference, the training half: AdamW (schedule, update, the
stacked decay-mask rule), ADMM (init, penalty, dual update, residual,
finalize) for balanced and unbalanced specs, the data pipeline (bit-equal
batches), checkpointing, the training forward and loss, ``make_train_step``
from converted state on the same batches, and ``train_loop`` (phases,
resume, CLI) on the CPU. Inputs come from numpy with a fixed seed.

Tolerances (fp32 throughout): AdamW and ADMM leaves within 1e-6 absolute
(the same elementwise ops, summed norms in another order); logits, loss and
grads within 1e-5 relative to their scale (matmuls summed in another
order); ``make_train_step`` loss within 1e-5 relative per step and params
within 5e-5 absolute after 3 steps (Adam's normalised step amplifies
grad noise near zero)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.checkpoint import checkpointing as jckpt  # noqa: E402
from repro.core import admm as jadmm  # noqa: E402
from repro.core import bcr as jbcr  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import causal_lm as jlm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.checkpoint.checkpointing import CheckpointManager  # noqa: E402
from repro_torch.convert import (from_jax_params,  # noqa: E402
                                 from_jax_train_state)
from repro_torch.core import admm as tadmm  # noqa: E402
from repro_torch.core import bcr as tbcr  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import causal_lm as tlm  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime.fault_tolerance import StragglerDetector  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _smoke(**kw):
    return (dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"), **kw),
            dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"), **kw))


def _close_trees(got, want, atol, what=""):
    """``got`` (port tree) against ``want`` (port tree converted from the
    reference), leaf by leaf."""
    for (path, g), w in zip(flatten(got), leaves(want)):
        if w is None:
            assert g is None, path
            continue
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   w.detach().float().numpy(), rtol=0,
                                   atol=atol, err_msg=f"{what}{path}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10_000, 20_000])
def test_schedule_matches_reference(step):
    cfg_j = jadamw.AdamWConfig()
    cfg_t = tadamw.AdamWConfig()
    want = float(jadamw.schedule(cfg_j, jnp.asarray(step, jnp.int32)))
    assert float(tadamw.schedule(cfg_t, step)) == pytest.approx(want,
                                                                rel=1e-6)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_decay_mask_follows_the_stacked_layout(scan_layers):
    """The reference decays ``ndim >= 2`` leaves of its own layout: under
    ``scan_layers`` a layer's RMSNorm scale is (L, d) and decayed, the final
    norm (d,) is not."""
    jc, tc = _smoke(scan_layers=scan_layers)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = from_jax_params(_np_tree(jp), tc, device="cpu")
    mask = dict(flatten(tadamw.decay_mask(tp, scan_layers=scan_layers)))
    assert mask["['final_norm']['scale']"] == 0.0
    assert mask["['layers'][0]['norm1']['scale']"] == float(scan_layers)
    assert mask["['layers'][1]['mixer']['wq']['w']"] == 1.0
    assert mask["['embed']['table']"] == 1.0


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(scan_layers, clip):
    jc, tc = _smoke(scan_layers=scan_layers)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**opt), tadamw.AdamWConfig(**opt)
    js = jadamw.init(jp)
    tp = from_jax_params(_np_tree(jp), tc, device="cpu")
    ts = tadamw.init(tp)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
            jp)
        jp, js, jm = jadamw.update(jcfg, grads, js, jp)
        tg = from_jax_params(_np_tree(grads), tc, device="cpu")
        tp, ts, tm = tadamw.update(
            tcfg, tg, ts, tp,
            decay_mask=tadamw.decay_mask(tp, scan_layers=scan_layers))
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
    assert int(ts.step) == int(js.step) == 3
    _close_trees(tp, from_jax_params(_np_tree(jp), tc, device="cpu"), 1e-6)
    _close_trees(ts.m, from_jax_params(_np_tree(js.m), tc, device="cpu"),
                 1e-6, "m")
    _close_trees(ts.v, from_jax_params(_np_tree(js.v), tc, device="cpu"),
                 1e-6, "v")


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": [rng.normal(size=(7,)).astype(np.float32) * 10]}
    want_tree, want_norm = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    ttree = {"a": torch.from_numpy(tree["a"].copy()),
             "b": [torch.from_numpy(tree["b"][0].copy())]}
    assert float(tadamw.global_norm(ttree)) == pytest.approx(
        float(jadamw.global_norm(tree)), rel=1e-6)
    got_tree, got_norm = tadamw.clip_by_global_norm(ttree, 1.0)
    assert float(got_norm) == pytest.approx(float(want_norm), rel=1e-6)
    np.testing.assert_allclose(got_tree["b"][0].numpy(),
                               np.asarray(want_tree["b"][0]), rtol=1e-6)


# ---------------------------------------------------------------------------
# ADMM
# ---------------------------------------------------------------------------


def _toy(seed=0):
    rng = np.random.default_rng(seed)
    return {"lin": {"w": rng.normal(size=(16, 32)).astype(np.float32)},
            "head": {"w": rng.normal(size=(8, 16)).astype(np.float32)},
            "stack": {"w": rng.normal(size=(2, 16, 16)).astype(np.float32)},
            "norm": {"scale": np.ones((16,), np.float32)}}


def _toy_pair(balanced, seed=0):
    kw = dict(block_shape=(8, 8), keep_frac=0.25, align=2, balanced=balanced)
    jspec, tspec = jbcr.BCRSpec(**kw), tbcr.BCRSpec(**kw)
    params = _toy(seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                     params)
    jspecs = jadmm.specs_for(
        jparams, lambda path, leaf: jspec if jax.tree_util.keystr(
            path).endswith("['w']") else None)
    tspecs = tadmm.specs_for(
        tparams, lambda path, leaf: tspec if path.endswith("['w']")
        else None)
    return jparams, tparams, jspecs, tspecs


def _toy_close(got, want, atol=1e-6):
    """Leaf by path (jax orders dict keys, the port keeps insertion)."""
    by_path = dict(flatten(jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), want,
        is_leaf=lambda x: x is None)))
    for path, g in flatten(got):
        w = by_path[path]
        if w is None:
            assert g is None, path
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                       err_msg=path)


@pytest.mark.parametrize("balanced", [True, False])
def test_admm_matches_reference(balanced):
    jp, tp, jspecs, tspecs = _toy_pair(balanced)
    assert sorted(tspecs) == sorted(jax.tree_util.keystr(k) for k in jspecs)
    cfg_j, cfg_t = jadmm.ADMMConfig(), tadmm.ADMMConfig()
    js = jadmm.admm_init(jp, jspecs)
    ts = tadmm.admm_init(tp, tspecs)
    _toy_close(ts.z, js.z)
    _toy_close(ts.u, js.u)
    rng = np.random.default_rng(2)
    for it in range(3):
        # a W-step stand-in: the same perturbation on both sides
        delta = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.1, jp)
        jp = jax.tree_util.tree_map(lambda a, d: a + d, jp, delta)
        tp = jax.tree_util.tree_map(
            lambda a, d: a + torch.from_numpy(np.asarray(d)), tp, delta)
        assert float(tadmm.admm_penalty(tp, ts, tspecs, cfg_t)) == \
            pytest.approx(float(jadmm.admm_penalty(jp, js, jspecs, cfg_j)),
                          rel=1e-5)
        js = jadmm.admm_dual_update(jp, js, jspecs)
        ts = tadmm.admm_dual_update(tp, ts, tspecs)
        assert int(ts.admm_iter) == int(js.admm_iter) == it + 1
        _toy_close(ts.z, js.z)
        _toy_close(ts.u, js.u)
        assert float(tadmm.primal_residual(tp, ts, tspecs)) == pytest.approx(
            float(jadmm.primal_residual(jp, js, jspecs)), rel=1e-5)
        assert float(cfg_t.rho_at(ts.admm_iter)) == pytest.approx(
            float(cfg_j.rho_at(js.admm_iter)), rel=1e-6)
    jpruned, jmasks = jadmm.finalize(jp, jspecs)
    tpruned, tmasks = tadmm.finalize(tp, tspecs)
    _toy_close(tmasks, jmasks, atol=0)
    _toy_close(tpruned, jpruned, atol=0)
    for path, spec in tspecs.items():
        w = dict(flatten(tpruned))[path]
        for mat in w.reshape(-1, *w.shape[-2:]):
            if balanced:
                assert tbcr.is_bcr_set_member(mat, spec)
    again = tadmm.apply_masks(tpruned, tmasks)
    _toy_close(again, jadmm.apply_masks(jpruned, jmasks), atol=0)


def test_admm_penalty_is_differentiable_in_w_only():
    _, tp, _, tspecs = _toy_pair(True)
    for leaf in leaves(tp):
        leaf.requires_grad_(True)
    st = tadmm.admm_init(tp, tspecs)
    pen = tadmm.admm_penalty(tp, st, tspecs, tadmm.ADMMConfig())
    pen.backward()
    rho = float(tadmm.ADMMConfig().rho_at(0))
    w, z = tp["lin"]["w"], st.z["lin"]["w"]
    torch.testing.assert_close(w.grad, rho * (w - z).detach())
    assert tp["norm"]["scale"].grad is None
    assert not st.z["lin"]["w"].requires_grad


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["synthetic", "markov", "file"])
def test_token_batches_are_bit_equal(kind, tmp_path):
    path = None
    if kind == "file":
        path = str(tmp_path / "toks.bin")
        np.random.default_rng(0).integers(0, 300, size=4096).astype(
            np.uint16).tofile(path)
    kw = dict(vocab_size=300, seq_len=16, global_batch=3, seed=5, kind=kind,
              path=path)
    js = jdata.TokenSource(jdata.DataConfig(**kw))
    ts = tdata.TokenSource(tdata.DataConfig(**kw))
    for step in (0, 1, 7):
        want, got = js.batch(step), ts.batch(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    dev = ts.device_batch(3, "cpu")
    np.testing.assert_array_equal(dev["tokens"].numpy(),
                                  js.batch(3)["tokens"])
    assert dev["tokens"].dtype == torch.int32


def test_synthetic_datasets_are_bit_equal():
    for fn in ("classification_dataset", "sequence_dataset"):
        args = (50, 8, 4) if fn == "classification_dataset" else (50, 8, 20,
                                                                   4)
        for a, b in zip(getattr(jdata, fn)(*args, seed=3),
                        getattr(tdata, fn)(*args, seed=3)):
            np.testing.assert_array_equal(a, b)


def test_file_source_needs_a_path():
    with pytest.raises(ValueError):
        tdata.TokenSource(tdata.DataConfig(8, 4, 1, kind="file"))


# ---------------------------------------------------------------------------
# Checkpointing (after the reference's tests/test_substrate.py)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor(3, dtype=torch.int32)}, "n": None}
    for step in (1, 2, 3):
        mgr.save(step, tree)
    assert mgr.all_steps() == [2, 3]
    out = mgr.restore(3, tree)
    assert torch.equal(out["a"], tree["a"]) and int(out["b"]["c"]) == 3
    assert out["n"] is None
    names = np.load(tmp_path / "step_00000003" / "shard_0.npz").files
    assert sorted(names) == ["00000::['a']", "00001::['b']['c']"]


def test_checkpoint_async_save_snapshots_now(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones((128, 128))
    mgr.save_async(7, {"w": w})
    w.add_(1.0)                # the loop updates in place right away
    mgr.wait()
    assert mgr.latest_step() == 7
    assert float(mgr.restore(7, {"w": w})["w"].max()) == 1.0


def test_checkpoint_torn_write_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000005")   # no COMMITTED marker
    assert mgr.latest_step() is None


def test_checkpoint_restore_casts_dtype_and_keeps_grad(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.full((4,), 1.5, dtype=torch.bfloat16),
            "p": torch.ones(3, requires_grad=True)}
    mgr.save(1, tree)
    out = mgr.restore(1, tree)
    assert out["w"].dtype == torch.bfloat16 and float(out["w"][0]) == 1.5
    assert out["p"].requires_grad and out["p"].is_leaf
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": tree["w"]})


def test_checkpoint_reads_reference_layout(tmp_path):
    """Same layout as the reference: a reference checkpoint of a tree with
    the same leaf order restores into the port (bf16 tag included)."""
    jmgr = jckpt.CheckpointManager(str(tmp_path))
    jmgr.save(4, {"a": jnp.arange(3, dtype=jnp.float32),
                  "b": jnp.ones((2,), jnp.bfloat16)})
    out = CheckpointManager(str(tmp_path)).restore(
        4, {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert out["a"].tolist() == [0.0, 1.0, 2.0]
    assert out["b"].dtype == torch.bfloat16 and out["b"].tolist() == [1, 1]


def test_straggler_detector_matches_reference():
    from repro.runtime.fault_tolerance import StragglerDetector as J
    j, t = J(min_steps=2), StragglerDetector(min_steps=2)
    for host, dt in [(0, 1.0), (1, 1.1), (2, 3.0)] * 3:
        j.record(host, dt)
        t.record(host, dt)
    assert t.stragglers() == j.stragglers() == [2]


# ---------------------------------------------------------------------------
# Model: forward, loss, grads
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = float(jlayers.cross_entropy(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m)))
        got = float(tlayers.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m)))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("remat", [True, False])
def test_forward_loss_and_grads_match_reference(remat):
    jc, tc = _smoke(remat=remat)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = from_jax_params(_np_tree(jp), tc, device="cpu")
    for leaf in leaves(tp):
        leaf.requires_grad_(True)
    b = jdata.TokenSource(jdata.DataConfig(jc.vocab_size, 12, 2)).batch(0)
    want_logits = np.asarray(jlm.forward(jc, jp, jnp.asarray(b["tokens"])))
    got_logits = tlm.forward(tc, tp, torch.from_numpy(b["tokens"]))
    scale = float(np.abs(want_logits).max())
    np.testing.assert_allclose(got_logits.detach().numpy(), want_logits,
                               rtol=0, atol=1e-5 * scale)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, jbatch))(jp)
    loss = tlm.loss_fn(tc, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want_g = from_jax_params(_np_tree(want_grads), tc, device="cpu")
    for (path, p), g in zip(flatten(tp), leaves(want_g)):
        gs = max(float(g.abs().max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * gs, err_msg=path)


def test_flash_kernel_under_a_gradient_raises_as_the_reference_cannot():
    """The reference's Pallas ``flash_attention_fused`` has no backward
    (``jax.grad`` through its ``pallas_call`` fails); the port's flash
    kernel has none either and says so."""
    from repro.kernels.flash_attention import flash_attention_fused
    q = jnp.ones((2, 16, 16))
    with pytest.raises(Exception):
        jax.grad(lambda q: flash_attention_fused(
            q, q, q, q_chunk=16, kv_chunk=16, interpret=True).sum())(q)
    _, tc = _smoke(attn_impl="pallas_interpret")
    tp = tlm.init_params(tc, 0, device="cpu")
    for leaf in leaves(tp):
        leaf.requires_grad_(True)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="backward"):
        tlm.loss_fn(tc, tp, {"tokens": toks, "targets": toks})
    with torch.no_grad():      # no gradient: the kernel's plain version runs
        assert tlm.forward(tc, tp, toks).shape == (1, 8, tc.vocab_size)


# ---------------------------------------------------------------------------
# make_train_step from converted state, on the same batches
# ---------------------------------------------------------------------------


def _prune_cfgs(**kw):
    return _smoke(bcr_keep_frac=0.25, bcr_block=(16, 16), **kw)


@pytest.mark.parametrize("phase", ["admm", "retrain"])
@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_matches_reference(accum, phase):
    jc, tc = _prune_cfgs(grad_accum=accum)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=6)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    jspecs = jadmm.specs_for(jp, jtrain.default_prune_filter(jc))
    admm_cfg = dict(steps_per_admm=5)
    if phase == "admm":
        jstate = jtrain.TrainState(jp, jadamw.init(jp),
                                   jadmm.admm_init(jp, jspecs), None)
    else:
        pruned, masks = jadmm.finalize(jp, jspecs)
        jstate = jtrain.TrainState(pruned, jadamw.init(pruned), None, masks)
    tstate = from_jax_train_state(_np_tree(jstate), tc, device="cpu")
    tspecs = tadmm.specs_for(tstate.params, ttrain.default_prune_filter(tc))
    assert len(tspecs) == 7 * tc.num_layers + 1      # 7 per layer + lm_head
    jstep = jax.jit(jtrain.make_train_step(
        jc, jadamw.AdamWConfig(**opt), jadmm.ADMMConfig(**admm_cfg), jspecs))
    tstep = ttrain.make_train_step(
        tc, tadamw.AdamWConfig(**opt), tadmm.ADMMConfig(**admm_cfg), tspecs)
    data = jdata.TokenSource(jdata.DataConfig(jc.vocab_size, 16, 4, seed=1))
    for step in range(3):
        b = data.batch(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    want = from_jax_params(_np_tree(jstate.params), tc, device="cpu")
    _close_trees(tstate.params, want, 5e-5)
    assert int(tstate.opt.step) == 3
    if phase == "retrain":
        for path, spec in tspecs.items():
            assert tbcr.is_bcr_set_member(
                dict(flatten(tstate.params))[path].detach(), spec)


# ---------------------------------------------------------------------------
# train_loop (after the reference's tests/test_integration.py)
# ---------------------------------------------------------------------------

TINY = tcfgs.ModelConfig(
    name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
    attn_impl="dense", bcr_keep_frac=0.25, bcr_block=(16, 16))


def _quiet(*a):
    pass


def test_train_loop_phases_prune_and_loss_decreases(tmp_path):
    tc = ttrain.TrainerConfig(steps=24, batch=4, seq=32, admm_start=8,
                              retrain_start=16, data_kind="markov",
                              ckpt_dir=str(tmp_path), ckpt_every=12,
                              log_every=100, device="cpu")
    out = ttrain.train_loop(TINY, tc, tadamw.AdamWConfig(lr=2e-3,
                                                         total_steps=24),
                            log=_quiet)
    hist = out["history"]
    assert len(hist) == 24 and np.isfinite(hist).all()
    assert hist[-1] < hist[0] * 1.05
    assert out["phases"] == ["dense"] * 8 + ["admm"] * 8 + ["retrain"] * 8
    assert len(out["transition_ms"]["dual_update"]) == 2  # at steps 10, 15
    state = out["state"]
    assert state.masks is not None and state.admm is None
    flat = dict(flatten(state.params))
    for path, spec in out["specs"].items():
        assert tbcr.is_bcr_set_member(flat[path].detach(), spec), path
    assert CheckpointManager(str(tmp_path)).all_steps() == [12, 24]


def test_resume_from_checkpoint(tmp_path):
    cfg = dataclasses.replace(TINY, bcr_keep_frac=0.0)
    tc = ttrain.TrainerConfig(steps=6, batch=2, seq=16,
                              ckpt_dir=str(tmp_path), ckpt_every=3,
                              log_every=100, device="cpu")
    ttrain.train_loop(cfg, tc, tadamw.AdamWConfig(lr=1e-3, total_steps=6),
                      log=_quiet)
    tc2 = dataclasses.replace(tc, steps=8, ckpt_every=100)
    out = ttrain.train_loop(cfg, tc2, tadamw.AdamWConfig(lr=1e-3,
                                                         total_steps=8),
                            log=_quiet)
    assert int(out["state"].opt.step) == 8
    assert len(out["history"]) == 2


@pytest.mark.parametrize("stop", [4, 7])
def test_resume_mid_admm_and_mid_retrain_matches_uninterrupted(tmp_path,
                                                               stop):
    """A checkpoint written inside the ADMM phase (Z/U, before the dual
    update at step 5) or the retrain phase (masks) resumes to the losses of
    the run that never stopped."""
    kw = dict(batch=2, seq=16, admm_start=2, retrain_start=6,
              data_kind="markov", log_every=100, device="cpu")
    opt = tadamw.AdamWConfig(lr=2e-3, total_steps=8)
    whole = ttrain.train_loop(TINY, ttrain.TrainerConfig(steps=8, **kw), opt,
                              log=_quiet)
    ttrain.train_loop(TINY, ttrain.TrainerConfig(
        steps=stop, ckpt_dir=str(tmp_path), ckpt_every=stop, **kw), opt,
        log=_quiet)
    resumed = ttrain.train_loop(TINY, ttrain.TrainerConfig(
        steps=8, ckpt_dir=str(tmp_path), ckpt_every=100, **kw), opt,
        log=_quiet)
    np.testing.assert_allclose(resumed["history"], whole["history"][stop:],
                               rtol=1e-5)
    assert resumed["phases"] == whole["phases"][stop:]
    _close_trees(resumed["state"].params, whole["state"].params, 1e-5)


def test_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "llama3.2-1b", "--smoke", "--steps", "3",
        "--batch", "2", "--seq", "16", "--device", "cpu"])
    ttrain.main()
    assert "step     0 loss" in capsys.readouterr().out
