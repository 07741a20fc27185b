"""The port's pod-scale dry run (``launch/dryrun.py``) against the
reference's: which cells run and which are skipped (with the same reason),
the analytic terms, the per-rank FLOPs and collectives of a decode, a
prefill and a train cell against the reference's own dry run of the same
cells, every family's SMOKE config on the fake 16×16 mesh, and the depth
and microbatch extrapolation against a full run. Cells run in
subprocesses: their fake 256-rank group must not become this process's.
The reference's own two cells (``tests/test_dryrun_smoke.py``) are here at
full size with the H100's 80 GiB, slow-marked as the reference's are."""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest

from repro import configs as jcfgs
from repro.runtime import analytic as janalytic
from repro_torch import configs as tcfgs
from repro_torch.runtime import analytic as tanalytic

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
       "JAX_PLATFORMS": "cpu"}


def _run(code: str, timeout: int = 300) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("shape", list(tcfgs.SHAPES))
def test_cells_skip_where_the_reference_skips(shape):
    for arch in tcfgs.ARCH_IDS:
        got = tcfgs.shape_applicable(tcfgs.get_config(arch),
                                     tcfgs.SHAPES[shape])
        want = jcfgs.shape_applicable(jcfgs.get_config(arch),
                                      jcfgs.SHAPES[shape])
        assert got == want, (arch, shape)
    assert len(tcfgs.all_cells()) * 2 == 80    # the sweep's records


def test_skipped_cells_write_the_reference_record(tmp_path):
    from repro_torch.launch.dryrun import run_cell
    n = 0
    for arch, shape in tcfgs.all_cells():
        ok, why = jcfgs.shape_applicable(jcfgs.get_config(arch),
                                         jcfgs.SHAPES[shape])
        if ok:
            continue
        for mp in (False, True):
            rec = run_cell(arch, shape, multi_pod=mp, out_dir=str(tmp_path),
                           device="cpu")
            assert rec["status"] == "skipped" and rec["reason"] == why
            assert "sub-quadratic" in rec["reason"]
            mesh = "pod2x16x16" if mp else "pod16x16"
            path = tmp_path / f"{arch}__{shape}__{mesh}.json"
            assert json.loads(path.read_text()) == rec
            n += 1
    assert n == 2 * 8      # long_500k on every full-attention arch


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_analytic_equals_the_reference(arch):
    for shape in tcfgs.SHAPES:
        tcfg, jcfg = tcfgs.get_config(arch), jcfgs.get_config(arch)
        for over in ({}, {"param_dtype": "bfloat16"}):
            import dataclasses
            tc = dataclasses.replace(tcfg, **over)
            jc = dataclasses.replace(jcfg, **over)
            assert tanalytic.model_flops(tc, tcfgs.SHAPES[shape]) == \
                janalytic.model_flops(jc, jcfgs.SHAPES[shape])
            for n in (256, 512):
                assert tanalytic.ideal_bytes_per_chip(
                    tc, tcfgs.SHAPES[shape], n) == \
                    janalytic.ideal_bytes_per_chip(jc, jcfgs.SHAPES[shape], n)


# Cells both dry runs take at their SMOKE widths on pod16x16.
COMPARED = [("llama3.2-1b", "decode_32k"), ("llama3.2-1b", "prefill_32k"),
            ("qwen1.5-4b", "train_4k")]

# The reference's dry run, its CLI's cells, on 512 host placeholder devices.
# jax >= 0.7's ``make_mesh`` makes Explicit axes by default, under which the
# reference's ``with_sharding_constraint`` raises; its mesh is rebuilt here
# with the Auto axes it was written for (the same shape and names).
_REFERENCE = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, tempfile
    import jax
    from repro.configs import get_smoke_config
    import repro.launch.dryrun as dr

    def mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, names, axis_types=(
            jax.sharding.AxisType.Auto,) * len(shape))

    dr.make_production_mesh = mesh
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for arch, shape in CELLS:
            out[f"{arch}/{shape}"] = dr.run_cell(
                arch, shape, multi_pod=False, out_dir=td, force=True,
                cfg_override=get_smoke_config(arch))
    print(json.dumps(out, default=str))
"""

_PORT = """
    import json, tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import run_cell
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for arch, shape in CELLS:
            out[f"{arch}/{shape}"] = run_cell(
                arch, shape, multi_pod=False, out_dir=td, force=True,
                device="cpu", cfg_override=get_smoke_config(arch))
    print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def both_dry_runs():
    """``{cell: (reference record, port record)}`` of :data:`COMPARED`,
    the two dry runs in two processes at once."""
    cells = f"CELLS = {COMPARED!r}\n"
    procs = [subprocess.Popen(
        [sys.executable, "-c", cells + textwrap.dedent(code)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=ENV) for code in (_REFERENCE, _PORT)]
    recs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        recs.append(json.loads(out.strip().splitlines()[-1]))
    return {cell: (recs[0][cell], recs[1][cell]) for cell in recs[0]}


@pytest.mark.parametrize("arch,shape", COMPARED)
def test_per_rank_counts_match_the_reference_dry_run(both_dry_runs, arch,
                                                     shape):
    """Rank 0's FLOPs against the reference's per-device program, cell by
    cell, within 3%. Read: the port over the reference 1.0147 (decode),
    1.0145 (prefill), 1.0035 (train); both count every op by the same
    rules, and what is left is the reductions that XLA fuses into a
    softmax, which the reference's parse of the fused program counts
    short. A rank that did redundant work (a softmax over the whole
    context-parallel cache on every rank was 17% over) fails here.

    Collectives by op are compared where the two layouts agree: the decode
    step's all-reduces, the context-parallel softmax's max and sum and the
    row-parallel projections' sums, are the same bytes. In prefill and
    train the port reduce-scatters into the sequence-parallel residual
    where XLA all-reduces and slices, and gathers a weight where XLA
    chooses otherwise, so their collectives differ by design and are not
    compared. Neither are bytes accessed or the peak: the port counts
    eager torch, whose every op reads and writes memory and holds its
    output, and the reference XLA's fused program."""
    ref, got = both_dry_runs[f"{arch}/{shape}"]
    assert ref["status"] == "ok", ref.get("error")
    assert got["status"] == "ok", (got.get("error"), got.get("traceback"))
    want, have = ref["hlo_corrected"], got["hlo_corrected"]
    assert abs(have["flops"] - want["flops"]) <= 0.03 * want["flops"], (
        have["flops"], want["flops"])
    assert got["roofline"]["n_chips"] == ref["roofline"]["n_chips"] == 256
    if shape == "decode_32k":
        assert have["collective_bytes:all-reduce"] == \
            want["collective_bytes:all-reduce"]
        assert have["collective_bytes"] <= want["collective_bytes"]


def test_every_family_smoke_config_runs_on_the_production_mesh():
    """Each family's SMOKE config through ``run_cell(cfg_override=...)``
    on pod16x16: a decode cell of each, and a prefill and a train cell of
    the dense family, every one ``ok`` with the reference's record keys."""
    out = _run("""
        import json, tempfile
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.dryrun import run_cell
        cells = [("llama3.2-1b", "decode_32k"), ("deepseek-moe-16b",
                 "decode_32k"), ("pixtral-12b", "decode_32k"),
                 ("rwkv6-3b", "decode_32k"), ("jamba-v0.1-52b",
                 "long_500k"), ("whisper-large-v3", "decode_32k"),
                 ("llama3.2-1b", "prefill_32k"), ("qwen1.5-4b", "train_4k")]
        out = {}
        with tempfile.TemporaryDirectory() as td:
            for arch, shape in cells:
                rec = run_cell(arch, shape, multi_pod=False, out_dir=td,
                               force=True, device="cpu",
                               cfg_override=get_smoke_config(arch))
                out[f"{arch}/{shape}"] = rec
        print(json.dumps(out, default=str))
    """, timeout=600)
    recs = json.loads(out.strip().splitlines()[-1])
    for cell, rec in recs.items():
        assert rec["status"] == "ok", (cell, rec.get("error"),
                                       rec.get("traceback"))
        assert rec["mesh"] == "pod16x16"
        for key in ("memory_analysis", "torch_flop_counter", "hlo_corrected",
                    "analytic", "timings", "roofline"):
            assert key in rec, (cell, key)
        r = rec["roofline"]
        assert r["n_chips"] == 256
        assert r["dominant"] in ("compute", "memory", "collective")
        assert rec["hlo_corrected"]["flops"] > 0
        assert rec["memory_analysis"]["peak_memory_in_bytes"] >= \
            rec["memory_analysis"]["argument_size_in_bytes"] > 0
        assert r["compute_s"] == rec["hlo_corrected"]["flops"] / 989e12
    # the train cell's layers, one a repeat: run at 1 and 2, carried to all
    layers = tcfgs.get_smoke_config("qwen1.5-4b").num_layers
    assert recs["qwen1.5-4b/train_4k"]["extrapolated"]["to_repeats"] == layers
    assert "extrapolated" not in recs["llama3.2-1b/decode_32k"]


def test_extrapolation_equals_a_full_run():
    """A 4-layer model accumulating 4 microbatches: the counts carried from
    1–2 layers × 1–2 microbatches equal a run of every layer and
    microbatch (FLOPs to 0.1%, bytes and collective bytes to 2%, the peak
    to 1%)."""
    out = _run("""
        import dataclasses, json, tempfile
        from repro_torch.configs import get_smoke_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch.dryrun import run_cell
        cfg = dataclasses.replace(get_smoke_config("llama3-405b"),
                                  num_layers=4, grad_accum=4,
                                  attn_impl="flash", q_chunk=128,
                                  kv_chunk=128)
        shape = ShapeSpec("train_small", 256, 64, "train")
        recs = {}
        with tempfile.TemporaryDirectory() as td:
            for exact in (False, True):
                recs[exact] = run_cell("llama3-405b", "train_small",
                                       multi_pod=False, out_dir=td,
                                       force=True, device="cpu",
                                       cfg_override=cfg, exact=exact,
                                       shape_override=shape)
        print(json.dumps({str(k): v for k, v in recs.items()}, default=str))
    """, timeout=600)
    recs = json.loads(out.strip().splitlines()[-1])
    est, full = recs["False"], recs["True"]
    assert est["status"] == full["status"] == "ok", (est.get("error"),
                                                     full.get("error"))
    assert est["extrapolated"]["to_repeats"] == 4
    assert est["extrapolated"]["to_microbatches"] == 4
    assert "extrapolated" not in full
    e, f = est["hlo_corrected"], full["hlo_corrected"]
    assert abs(e["flops"] - f["flops"]) <= 1e-3 * f["flops"]
    for k in ("bytes_accessed", "collective_bytes"):
        assert abs(e[k] - f[k]) <= 0.02 * f[k], (k, e[k], f[k])
    pe = est["memory_analysis"]["peak_memory_in_bytes"]
    pf = full["memory_analysis"]["peak_memory_in_bytes"]
    assert abs(pe - pf) <= 0.01 * pf, (pe, pf)
    assert est["memory_analysis"]["argument_size_in_bytes"] == \
        full["memory_analysis"]["argument_size_in_bytes"]


@pytest.mark.slow
def test_dryrun_cell_end_to_end():
    """The reference's cell, full size, against the H100's 80 GiB."""
    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", "llama3.2-1b", "--shape", "decode_32k",
             "--out-dir", td, "--force", "--device", "cpu"],
            capture_output=True, text=True, timeout=560,
            env=dict(os.environ, PYTHONPATH="src"), cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        path = os.path.join(td, "llama3.2-1b__decode_32k__pod16x16.json")
        with open(path) as f:
            rec = json.load(f)
        assert rec["status"] == "ok"
        assert rec["roofline"]["n_chips"] == 256
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["memory_analysis"]["peak_memory_in_bytes"] < 80 * 2**30, \
            "decode cell must fit H100 HBM"
        assert rec["hlo_corrected"]["flops"] > 0


@pytest.mark.slow
def test_dryrun_skip_cell():
    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", "llama3.2-1b", "--shape", "long_500k",
             "--out-dir", td, "--device", "cpu"],
            capture_output=True, text=True, timeout=200,
            env=dict(os.environ, PYTHONPATH="src"), cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        path = os.path.join(td, "llama3.2-1b__long_500k__pod16x16.json")
        with open(path) as f:
            rec = json.load(f)
        assert rec["status"] == "skipped"
        assert "sub-quadratic" in rec["reason"]
