"""Port vs reference, the serve CLI's static loop (``launch/serve.py``'s
``ServeConfig`` and static ``generate``; the port's ``generate_static``):
on the reference's own prompts at fp32 SMOKE, the port's greedy tokens
equal the reference's (flip rate 0), dense and BCR-packed; inside the port
they equal the naive ``generate`` (the engine's oracle) bit for bit; ``main
--mode static`` runs on the CPU; encdec is refused.

Tolerance: none. Tokens are compared exactly."""

import dataclasses
import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import model_fns as jmodel_fns  # noqa: E402

from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

torch.set_num_threads(2)
ARCH = "llama3.2-1b"
SC = dict(batch=3, prompt_len=12, gen_tokens=8, capacity=32, seed=4)


def _cfgs(keep):
    over = dict(bcr_keep_frac=keep, bcr_block=(16, 16),
                cache_dtype="float32")
    return (dataclasses.replace(jcfgs.get_smoke_config(ARCH), **over),
            dataclasses.replace(tcfgs.get_smoke_config(ARCH), **over))


@pytest.mark.parametrize("keep", [0.0, 0.25])
def test_static_tokens_match_reference(keep):
    """The reference draws its prompts from ``jax.random`` under the
    config's seed; the port takes the same prompts through ``prompts=``."""
    jcfg, tcfg = _cfgs(keep)
    jp = jmodel_fns(jcfg).init_params(jax.random.PRNGKey(0))
    if keep:
        jp = jserve.pack_params(jcfg, jp)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    want = jserve.generate(jcfg, jp, jserve.ServeConfig(**SC),
                           log=lambda *_: None)
    prompts = np.array(jax.random.randint(
        jax.random.PRNGKey(SC["seed"]), (SC["batch"], SC["prompt_len"]), 0,
        jcfg.vocab_size, jax.numpy.int32))
    got = tserve.generate_static(tcfg, tp, tserve.ServeConfig(**SC),
                                 prompts=torch.from_numpy(prompts),
                                 log=lambda *_: None)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["prefill_s"] > 0 and got["decode_s"] > 0


def test_static_tokens_equal_naive_generate():
    """Its own seeded prompts: the capacity-dense static loop against the
    paged naive oracle, bit for bit."""
    _, tcfg = _cfgs(0.25)
    params = tserve.build_params(tcfg, log=lambda *_: None, device="cpu",
                                 decode_m=SC["batch"])
    got = tserve.generate_static(tcfg, params, tserve.ServeConfig(**SC),
                                 log=lambda *_: None)
    gen = torch.Generator()
    gen.manual_seed(SC["seed"])
    prompts = torch.randint(0, tcfg.vocab_size,
                            (SC["batch"], SC["prompt_len"]), generator=gen,
                            dtype=torch.int32)
    want = tserve.generate(tcfg, params, prompts,
                           gen_tokens=SC["gen_tokens"], page_size=4)
    assert torch.equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (SC["batch"], SC["gen_tokens"])


def test_main_static_mode_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "static.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--smoke", "--device", "cpu", "--mode",
        "static", "--batch", "2", "--prompt-len", "8", "--gen", "4",
        "--bcr-keep", "0.25", "--capacity", "32", "--json-out", str(out)])
    tserve.main()
    rec = json.loads(out.read_text())
    assert np.asarray(rec["tokens"]).shape == (2, 4)
    text = capsys.readouterr().out
    assert "prefill 8 tok x2" in text and "decode 4 tok x2" in text


def test_static_refuses_encdec():
    cfg = tcfgs.get_smoke_config("whisper-large-v3")
    params = tserve.model_fns(cfg).init_params(0, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tserve.generate_static(cfg, params, tserve.ServeConfig(**SC))
