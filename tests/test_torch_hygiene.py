"""Rules of the port, checked on its source and its behaviour.

* No file of ``src/repro_torch/`` or ``chip_smoke.py`` imports ``jax`` or the
  reference package ``repro``.
* The port never calls ``scaled_dot_product_attention`` or
  ``torch.compile``. ``chip_smoke.py`` may time one library call beside a
  kernel as its yardstick, only inside a ``_library_*`` function.
* Entry points default to the card: without one visible they raise instead
  of running on the CPU.
* Options not ported yet raise ``NotImplementedError``.
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
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    cfg = _smoke_cfg()
    with pytest.raises(RuntimeError):
        build_params(cfg)
    params = build_params(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        InferenceEngine(cfg, params, EngineConfig())


@pytest.mark.parametrize("option", [
    dict(kv_dtype="int8"), dict(weight_dtype="int8"),
    dict(prefix_cache=True), dict(spec_k=2), dict(page_size=0),
    dict(mesh_model=2)])
def test_unported_engine_options_raise(option):
    with pytest.raises(NotImplementedError):
        EngineConfig(**option)


def test_unported_model_options_raise():
    cfg = _smoke_cfg(bcr_keep_frac=0.25, bcr_block=(16, 16))
    params = build_params(_smoke_cfg(), device="cpu")
    with pytest.raises(NotImplementedError):
        pack_params(cfg, params, weight_dtype="int8")
    from repro_torch.models import causal_lm
    with pytest.raises(NotImplementedError):
        causal_lm.init_cache(_smoke_cfg(kv_dtype="int8"), kv_pages=4,
                             page_size=4, device="cpu")
    with pytest.raises(NotImplementedError):
        causal_lm.init_params(tcfgs.ModelConfig(
            name="x", family="moe", num_layers=1, d_model=8, num_heads=2,
            num_kv_heads=2, d_ff=8, vocab_size=8), device="cpu")
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(NotImplementedError):
        paged_decode_attention(q, torch.zeros(2, 4, 2, 4),
                               torch.zeros(2, 4, 2, 4),
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32),
                               k_scale=torch.zeros(2, 4, 2))
