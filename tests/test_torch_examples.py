"""The port's five examples (``src/repro_torch/examples``), run end to end
through their ``main`` on the CPU (``--device cpu``), the training ones
with their steps cut through ``--steps``; ``serve_decode`` and ``train_lm``
also held to the reference's examples (its dense and packed greedy tokens
on converted weights; its trained masks' density); and their default
device, the card, which they refuse to replace with the CPU when none is
visible."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.examples import (cnn_im2col, gru_rnn, quickstart,
                                  serve_decode, train_lm)
from repro_torch.tree import leaves

torch.set_num_threads(2)


def _run(capsys, main, *args):
    main(["--device", "cpu", *args])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "OK"
    return lines


def test_quickstart(capsys):
    out = _run(capsys, quickstart.main)
    assert out[0].startswith("density after BCR projection: 0.1250")
    assert any(ln.startswith("BCRC index overhead") for ln in out)


def test_gru_rnn(capsys):
    out = _run(capsys, gru_rnn.main, "--steps", "3")
    assert "step 1: BCR masks frozen (10x), retraining" in out
    steps = [ln for ln in out if "GRU step (batch 32)" in ln]
    assert len(steps) == 2 and all("host CPU wall" in ln for ln in steps)
    bound = [ln for ln in out if ln.startswith("H100 byte bound")]
    assert len(bound) == 1 and "no card in this run" in bound[0]
    assert not any("v5e" in ln for ln in out)


def test_cnn_im2col(capsys):
    out = _run(capsys, cnn_im2col.main, "--steps", "9")
    acc = next(ln for ln in out if ln.startswith("accuracy with 4x BCR"))
    assert float(acc.split()[-1]) > 0.8
    assert any(ln.startswith("im2col skip:") for ln in out)


def test_serve_decode(capsys):
    out = _run(capsys, serve_decode.main, "--batch", "2", "--gen", "4")
    assert "greedy tokens identical: True" in out
    assert any(ln.startswith("packed weight bytes") for ln in out)


def test_serve_decode_holds_to_the_reference():
    """The reference example's pipeline (init, hard BCR projection, the
    static ``generate`` over dense then packed weights) and the port's on
    the reference's projected weights and prompts: the same greedy tokens,
    dense and packed."""
    jax = pytest.importorskip("jax")
    from repro import configs as jcfgs
    from repro.core import admm as jadmm
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import generate as jgenerate
    from repro.launch.serve import pack_params as jpack_params
    from repro.launch.train import default_prune_filter as jfilter
    from repro.models.api import model_fns as jmodel_fns

    from repro_torch import configs as tcfgs
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.serve import ServeConfig

    over = dict(bcr_keep_frac=0.25, bcr_block=(16, 16))
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("llama3.2-1b"), **over)
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"), **over)
    params = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    projected, _ = jadmm.finalize(params, jadmm.specs_for(params,
                                                          jfilter(jcfg)))
    sc = JServeConfig(batch=2, prompt_len=8, gen_tokens=4, capacity=64)
    log = lambda *a, **k: None  # noqa: E731
    want_dense = np.asarray(jgenerate(jcfg, projected, sc, log=log)["tokens"])
    want_packed = np.asarray(jgenerate(
        jcfg, jpack_params(jcfg, projected), sc, log=log)["tokens"])
    prompts = torch.as_tensor(np.array(jax.random.randint(
        jax.random.PRNGKey(sc.seed), (sc.batch, sc.prompt_len), 0,
        jcfg.vocab_size)))
    got = serve_decode.dense_vs_packed(
        tcfg, from_jax_params(jax.tree_util.tree_map(np.asarray, projected),
                              tcfg, device="cpu"),
        ServeConfig(batch=2, prompt_len=8, gen_tokens=4, capacity=64),
        prompts=prompts, log=log)
    np.testing.assert_array_equal(got["dense"].numpy(), want_dense)
    np.testing.assert_array_equal(got["packed"].numpy(), want_packed)


def test_train_lm_tiny_ends_at_the_reference_density(capsys):
    """``--preset tiny`` through dense, ADMM and retraining: the loss falls
    and the frozen masks keep the density the reference's run keeps."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.core.bcr import density as jdensity
    from repro.launch.train import TrainerConfig as JTrainerConfig
    from repro.launch.train import train_loop as jtrain_loop
    from repro.optim import adamw as jadamw

    args = ("--steps", "6", "--admm-start", "2", "--retrain-start", "4")
    state = train_lm.main(["--device", "cpu", *args])["state"]
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "OK"
    line = next(ln for ln in out if ln.startswith("BCR-pruned tensors"))
    ref = jtrain_loop(JModelConfig(**dataclasses.asdict(
        train_lm.PRESETS["tiny"])), JTrainerConfig(
        steps=6, batch=8, seq=64, admm_start=2, retrain_start=4,
        data_kind="markov"), jadamw.AdamWConfig(lr=1e-3, total_steps=6),
        log=lambda *a, **k: None)["state"]
    # the reference stacks its layers' masks on a leading axis; the kept
    # share of every mask, and of all of them together, is the same
    jmasks = [np.asarray(m) for m in jax.tree_util.tree_leaves(
        ref.masks, is_leaf=lambda x: x is None) if m is not None]
    tmasks = [m.numpy() for m in leaves(state.masks) if m is not None]
    assert sum(m.size for m in tmasks) == sum(m.size for m in jmasks)
    assert sum(int(m.sum()) for m in tmasks) == \
        sum(int(m.sum()) for m in jmasks)
    assert set(train_lm.mask_densities(state)) == {
        float(jdensity(m)) for m in jmasks}
    kept = sum(int(m.sum()) for m in jmasks) / sum(m.size for m in jmasks)
    assert f"mean kept density {kept:.3f}" in line


@pytest.mark.parametrize("main", [quickstart.main, gru_rnn.main,
                                  cnn_im2col.main, serve_decode.main,
                                  train_lm.main],
                         ids=["quickstart", "gru_rnn", "cnn_im2col",
                              "serve_decode", "train_lm"])
def test_examples_default_to_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError):
        main([])
