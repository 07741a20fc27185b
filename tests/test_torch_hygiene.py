"""Rules of the port, checked on its source and its behaviour.

* No file of ``src/repro_torch/`` or ``chip_smoke.py`` imports ``jax`` or the
  reference package ``repro``.
* The port never calls ``scaled_dot_product_attention`` or
  ``torch.compile``. ``chip_smoke.py`` may time one library call beside a
  kernel as its yardstick, only inside a ``_library_*`` function.
* Entry points (serving and training) default to the card: without one
  visible they raise instead of running on the CPU.
* Options not ported yet raise ``NotImplementedError`` (the hybrid, SSM,
  encdec and vlm families among them); the quantized serving options, the
  prefix cache, speculative decoding, the capacity-dense pool and the MoE
  family are accepted, and an unknown ``attn_impl`` raises.
"""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.launch.serve import build_params, pack_params
from repro_torch.serving import EngineConfig, InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN_CALLS = ("scaled_dot_product_attention",)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _bad_import(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def _forbidden_uses(tree, allow_in=()):
    """(line, what) for every SDPA or torch.compile reference outside the
    functions whose names start with one of ``allow_in``."""
    found = []

    def visit(node, fn_name):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn_name = node.name
        names = []
        if isinstance(node, ast.Attribute):
            names.append(node.attr)
            if node.attr == "compile" and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                found.append((node.lineno, "torch.compile"))
        elif isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.alias):
            names.append(node.name.split(".")[-1])
        for n in names:
            if n in FORBIDDEN_CALLS and not (
                    fn_name and fn_name.startswith(allow_in or ("\0",))):
                found.append((getattr(node, "lineno", 0), n))
        for child in ast.iter_child_nodes(node):
            visit(child, fn_name)

    visit(tree, None)
    return found


def test_port_files_exist():
    assert len(PORT_FILES) > 15 and SMOKE.exists()
    # the port keeps its own copies of the reference's numpy-only modules
    for name in ("scheduler.py", "faults.py", "admission.py",
                 "speculative.py"):
        assert ROOT / "src" / "repro_torch" / "serving" / name in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imports(tree) if _bad_import(n)]
    assert not bad, f"{path}: imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_calls_sdpa_or_compile(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not _forbidden_uses(tree)


def test_chip_smoke_uses_library_calls_only_as_yardsticks():
    tree = ast.parse(SMOKE.read_text(), filename=str(SMOKE))
    assert not _forbidden_uses(tree, allow_in=("_library",))


def test_hygiene_check_catches_a_forbidden_call():
    src = ("import torch.nn.functional as F\n"
           "def f(q):\n    return F.scaled_dot_product_attention(q, q, q)\n"
           "g = torch.compile(f)\n")
    assert len(_forbidden_uses(ast.parse(src))) == 2
    assert _bad_import("jax.numpy") and _bad_import("repro.core.bcr")
    assert not _bad_import("repro_torch.core.bcr")


def _smoke_cfg(**kw):
    return dataclasses.replace(tcfgs.get_smoke_config("llama3.2-1b"), **kw)


def test_entry_points_default_to_the_card():
    """The model and engine default to the card, so do the HTTP entry
    point's ``--device`` and the serving CLI's; ``start_in_thread`` takes no
    device of its own but the engine's."""
    import inspect

    from repro_torch.launch import api
    from repro_torch.serving import start_in_thread
    assert api.parse_args(["--arch", "llama3.2-1b"]).device == "cuda"
    assert "device" not in inspect.signature(start_in_thread).parameters
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    cfg = _smoke_cfg()
    with pytest.raises(RuntimeError):
        build_params(cfg)
    params = build_params(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        InferenceEngine(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError):
        api.main(["--arch", "llama3.2-1b", "--smoke"])
    eng = InferenceEngine(cfg, params, EngineConfig(n_slots=1, capacity=32,
                                                    page_size=4),
                          device="cpu")
    h = start_in_thread(eng)
    try:
        assert h.server.engine.device == torch.device("cpu")
    finally:
        h.request_drain()
        h.wait_closed(30)
    assert h.server.conservation_ok


@pytest.mark.parametrize("option", [dict(mesh_model=2)])
def test_unported_engine_options_raise(option):
    """No silent fallback: a mesh the machine cannot give (fewer cards than
    ranks, no device list) and configurations the sharded engine does not
    serve raise at engine build, never falling back to the CPU or to mesh
    1."""
    cfg = _smoke_cfg()
    params = build_params(cfg, device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA devices visible"):
            InferenceEngine(cfg, params, EngineConfig(**option),
                            device="cpu")
    with pytest.raises(ValueError, match="paged KV pool"):
        InferenceEngine(cfg, params, EngineConfig(page_size=0, **option),
                        device="cpu")
    with pytest.raises(ValueError, match="mesh_devices"):
        EngineConfig(mesh_devices=("cpu",), **option)


@pytest.mark.parametrize("option", [dict(spec_k=2), dict(page_size=0)])
def test_ported_engine_options_serve(option):
    """Speculative decoding (with an oracle drafter) and the capacity-dense
    pool build an engine that serves a request on the CPU."""
    from repro_torch.serving import OracleDraft
    cfg = _smoke_cfg()
    ec = dict(n_slots=2, capacity=32, page_size=4)
    ec.update(option)
    eng = InferenceEngine(cfg, build_params(cfg, device="cpu"),
                          EngineConfig(**ec), device="cpu",
                          drafter=OracleDraft() if ec.get("spec_k") else None)
    assert len(eng.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 3
    assert eng.paged == (ec["page_size"] > 0)
    assert eng.stats["spec_steps"] == (2 if eng.spec else 0)
    eng.check_conservation()


def test_prefix_cache_engine_serves():
    """``prefix_cache=True`` builds an engine that serves: a repeated prompt
    is admitted through the suffix-only ``prefill_append`` over its adopted
    pages and gives the same tokens as the cold admission."""
    cfg = _smoke_cfg()
    eng = InferenceEngine(cfg, build_params(cfg, device="cpu"), EngineConfig(
        n_slots=2, capacity=32, page_size=4, prefix_cache=True),
        device="cpu")
    prompt = list(range(1, 11))
    [cold] = eng.generate([prompt], max_new_tokens=3)
    [hot] = eng.generate([prompt], max_new_tokens=3)
    assert hot == cold and len(hot) == 3
    assert eng.stats["prefix_hit_tokens"] == 8
    eng.check_conservation()


@pytest.mark.parametrize("family", ["encdec"])
def test_unported_model_options_raise(family):
    """encdec is not a causal LM: ``causal_lm`` refuses it at its entry
    point, while ``model_fns`` serves it through ``models/encdec.py``."""
    from repro_torch.models import causal_lm, encdec
    from repro_torch.models.api import model_fns
    cfg = tcfgs.ModelConfig(
        name="x", family=family, num_layers=1, d_model=8, num_heads=2,
        num_kv_heads=2, d_ff=8, vocab_size=8, encoder_seq=4)
    with pytest.raises(NotImplementedError, match="encdec"):
        causal_lm.init_params(cfg, device="cpu")
    fns = model_fns(cfg)
    assert fns.init_params.func is encdec.init_params
    assert fns.prefill_append is None
    params = fns.init_params(0, device="cpu")
    assert len(params["enc_layers"]) == len(params["dec_layers"]) == 1


@pytest.mark.parametrize("option", ["kv_dtype", "weight_dtype"])
def test_quantized_engine_options_are_served(option):
    """``kv_dtype``/``weight_dtype="int8"`` build an engine that serves:
    int8 pools with scale siblings, or int8 tiles with per-tile scales."""
    cfg = _smoke_cfg(bcr_keep_frac=0.25, bcr_block=(16, 16))
    params = build_params(cfg, log=lambda *_: None, device="cpu")
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=32, page_size=4, **{option: "int8"}),
        device="cpu")
    if option == "kv_dtype":
        layer = eng.pool.cache[0]
        assert layer["k"].dtype == torch.int8
        assert tuple(layer["k_scale"].shape) == tuple(layer["k"].shape[:3])
    else:
        wg = eng.params["layers"][0]["ffn"]["wgi"]["w_group"]
        assert wg.vals.dtype == torch.int8
        assert tuple(wg.plan.block_scales.shape) == tuple(wg.vals.shape[:3])
    out = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=3)
    assert [len(o) for o in out] == [3, 3]
    eng.pool.check_consistency()


def test_int8_packing_and_pages_on_model_entry_points():
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.models import causal_lm
    cfg = _smoke_cfg(bcr_keep_frac=0.25, bcr_block=(16, 16))
    packed = pack_params(cfg, build_params(_smoke_cfg(), device="cpu"),
                         weight_dtype="int8")
    lm = packed["lm_head"]["w_packed"]
    assert lm.vals.dtype == torch.int8 and lm.plan.block_scales is not None
    cache = causal_lm.init_cache(_smoke_cfg(kv_dtype="int8"), kv_pages=4,
                                 page_size=4, device="cpu")
    assert set(cache[0]) == {"k", "v", "k_scale", "v_scale"}
    q = torch.zeros(1, 1, 2, 4)
    out = paged_decode_attention(
        q, torch.ones(2, 4, 2, 4, dtype=torch.int8),
        torch.ones(2, 4, 2, 4, dtype=torch.int8),
        torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
        k_scale=torch.ones(2, 4, 2), v_scale=torch.full((2, 4, 2), 0.5))
    torch.testing.assert_close(out, torch.full((1, 1, 2, 4), 0.5))
    with pytest.raises(ValueError):
        pack_params(cfg, build_params(_smoke_cfg(), device="cpu"),
                    weight_dtype="int4")


def test_unknown_attn_impl_raises():
    """No silent fallback: an ``attn_impl`` the reference does not know
    raises at every model entry point, the engine and the cold prefill."""
    from repro_torch.models import causal_lm, layers
    bad = _smoke_cfg(attn_impl="triton")
    with pytest.raises(ValueError):
        causal_lm.init_params(bad, device="cpu")
    params = build_params(_smoke_cfg(), device="cpu")
    with pytest.raises(ValueError):
        causal_lm.prefill(bad, params, torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        InferenceEngine(bad, params, EngineConfig(), device="cpu")
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        layers.cold_attention(q, q, q, attn_impl="ring", q_chunk=4,
                              kv_chunk=4)


@pytest.mark.parametrize("name", [
    "core/admm.py", "kernels/bcr_spmm_skip.py", "optim/adamw.py",
    "data/pipeline.py", "checkpoint/checkpointing.py",
    "runtime/fault_tolerance.py", "launch/train.py", "tree.py"])
def test_training_slice_files_are_scanned(name):
    assert ROOT / "src" / "repro_torch" / name in PORT_FILES
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
            / "bcr_spmm_skip.cu").exists()


@pytest.mark.parametrize("name", ["serving/server.py", "launch/api.py"])
def test_serving_entry_point_files_are_scanned(name):
    """The import scan globs every port file, the HTTP front end and its
    CLI included."""
    path = ROOT / "src" / "repro_torch" / name
    assert path in PORT_FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n for n in _imports(tree) if _bad_import(n)]


def test_train_entry_points_default_to_the_card(monkeypatch):
    import sys
    from repro_torch.launch import train
    assert train.TrainerConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError):
        train.train_loop(_smoke_cfg(), train.TrainerConfig(steps=1))
    with pytest.raises(RuntimeError):
        train.init_state(_smoke_cfg(), 0, "cuda")
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "llama3.2-1b",
                                      "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError):
        train.main()
