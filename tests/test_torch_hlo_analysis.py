"""The port's per-rank cost accounting (``runtime/hlo_analysis.py``, aten
ops counted as they dispatch) against the reference's (its compiled HLO,
``while`` bodies times their trip counts), and on fake meshes."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.runtime.hlo_analysis import analyze as janalyze
from repro_torch.runtime.hlo_analysis import analyze

ROOT = Path(__file__).resolve().parents[1]


def _inputs(n=64, layers=0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)).astype(np.float32)
    w = rng.standard_normal(((layers,) if layers else ()) + (n, n)).astype(
        np.float32) * n ** -0.5
    return x, w


def test_two_matmuls_and_a_tanh_match_the_reference():
    x, w = _inputs()
    hlo = jax.jit(lambda a, b: jnp.tanh(a @ b) @ b).lower(
        x, w).compile().as_text()
    want = janalyze(hlo)["flops"]
    tx, tw = torch.as_tensor(x), torch.as_tensor(w)
    got = analyze(lambda: torch.tanh(tx @ tw) @ tw)
    assert abs(got["flops"] - want) <= 0.05 * want, (got, want)
    # 2 products of 2·64³ and a tanh a element
    assert got["flops"] == 2 * 2 * 64 ** 3 + 64 * 64
    assert got["collective_bytes"] == 0 and got["collective_count"] == 0
    assert got["bytes_accessed"] > 0


def test_a_python_loop_of_layers_matches_the_reference_scan():
    x, ws = _inputs(layers=6)

    def scanned(a, w):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, a, w)[0]

    hlo = jax.jit(scanned).lower(x, ws).compile().as_text()
    want = janalyze(hlo)["flops"]
    tx, tws = torch.as_tensor(x), torch.as_tensor(ws)

    def looped():
        h = tx
        for i in range(6):
            h = torch.tanh(h @ tws[i])
        return h

    got = analyze(looped)["flops"]
    assert abs(got - want) <= 0.02 * want, (got, want)


def test_views_cost_nothing_and_in_place_updates_move_their_source():
    cache = torch.zeros((8, 1024, 64))
    new = torch.ones((8, 64))
    rows = torch.arange(8)
    pos = torch.full((8,), 3)
    got = analyze(lambda: cache.view(8, 1024, 8, 8).transpose(1, 2))
    assert got == {"flops": 0.0, "bytes_accessed": 0.0,
                   "collective_bytes": 0.0, "collective_count": 0.0}
    got = analyze(lambda: cache.index_put_((rows, pos), new))
    # twice the update and its indices, not the 2 MiB destination
    assert got["bytes_accessed"] == 2 * (new.numel() * 4 + 2 * 8 * 8)


def test_collectives_and_tensor_parallel_flops_on_fake_meshes():
    """An all-gather of known shape on a fake 8-rank mesh counts exactly
    its operand; a Megatron MLP on a fake 1×4 mesh counts a quarter of the
    unsharded FLOPs a rank (in a subprocess: the fake group must not
    become this process's)."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.dryrun import fake_group
        from repro_torch.runtime.hlo_analysis import analyze
        fake_group(8)
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        x = torch.ones(16, 32)
        got = analyze(lambda: funcol.all_gather_tensor(x, 0, mesh))
        assert got["collective_bytes"] == 16 * 32 * 4, got
        assert got["collective_bytes:all-gather"] == 16 * 32 * 4, got
        assert got["collective_count"] == 1, got
        got = analyze(lambda: funcol.all_reduce(x, "sum", mesh))
        assert got["collective_bytes:all-reduce"] == 2 * 16 * 32 * 4, got
        dist.destroy_process_group()

        fake_group(4)
        mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data",
                                                                "model"))
        b, d, f = 64, 128, 512
        with FakeTensorMode():
            xg, w1g, w2g = (torch.empty(b, d), torch.empty(f, d),
                            torch.empty(d, f))
            plain = analyze(lambda: torch.relu(xg @ w1g.T) @ w2g.T)
            x = DTensor.from_local(torch.empty(b, d), mesh,
                                   [Replicate(), Replicate()],
                                   run_check=False)
            w1 = DTensor.from_local(torch.empty(f // 4, d), mesh,
                                    [Replicate(), Shard(0)],
                                    run_check=False, shape=(f, d),
                                    stride=(d, 1))
            w2 = DTensor.from_local(torch.empty(d, f // 4), mesh,
                                    [Replicate(), Shard(1)],
                                    run_check=False, shape=(d, f),
                                    stride=(f, 1))
            def mlp():
                y = torch.relu(x @ w1.T) @ w2.T       # a partial sum
                return y.redistribute(mesh, [Replicate(), Replicate()])
            rank = analyze(mlp)
        assert rank["flops"] * 4 == plain["flops"], (rank, plain)
        assert rank["collective_bytes:all-reduce"] == 2 * b * d * 4, rank
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
