"""Port vs reference, GRIM §5.1's block-size search (Listing 1):
``synthesize``, ``find_opt_blk`` (choice and log) under one deterministic
fake latency backend, and ``default_candidates``; then the port's own
backend, the wall-clock runner, on the CPU's plain version.

Tolerances: none for the search. Both packages get the same fake latencies,
so the chosen block and the log are equal."""

import functools
import math

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import block_search as jbs  # noqa: E402

from repro_torch.core import block_search as tbs  # noqa: E402

torch.set_num_threads(2)

SMALL = [(8, 8), (8, 16), (16, 16), (32, 32), (64, 64), (128, 128)]


def fake_latency(layer) -> float:
    """A deterministic stand-in for a card: a per-block issue cost that
    makes small blocks slow, a byte term for the kept weights, and a
    penalty for huge blocks."""
    br, bc = layer.block_shape
    blocks = (layer.n // br) * (layer.k // bc)
    kept = layer.keep_frac * layer.n * layer.k
    return (2e-7 * blocks + 2e-12 * kept * (1 + layer.m / 64)
            + 1e-9 * math.sqrt(br * bc) * layer.m)


@pytest.mark.parametrize("m,k,n", [(1, 1024, 1024), (32, 1024, 1024),
                                   (8, 8192, 2048), (256, 144, 32)])
@pytest.mark.parametrize("keep", [0.1, 0.25])
@pytest.mark.parametrize("threshold", [1.0, 1.1, 2.0])
def test_find_opt_blk_matches_reference(m, k, n, keep, threshold):
    cands = SMALL + tbs.default_candidates(n, k)
    got = tbs.find_opt_blk(m, k, n, keep, cands, run_layer=fake_latency,
                           threshold=threshold)
    want = jbs.find_opt_blk(m, k, n, keep, cands, run_layer=fake_latency,
                            threshold=threshold)
    assert got == want
    size, log = got
    assert size in [s for s, _ in log]


@pytest.mark.parametrize("n,k", [(1024, 1024), (2048, 8192), (32, 144),
                                 (96, 96), (100, 60)])
def test_default_candidates_match_reference(n, k):
    assert tbs.default_candidates(n, k) == jbs.default_candidates(n, k)


def test_synthesize_matches_reference():
    got = tbs.synthesize(32, 1024, 512, 0.25, (8, 16))
    want = jbs.synthesize(32, 1024, 512, 0.25, (8, 16))
    assert (got.m, got.k, got.n, got.keep_frac, got.block_shape) \
        == (want.m, want.k, want.n, want.keep_frac, want.block_shape)


def test_no_dividing_candidate_raises_in_both():
    for mod in (tbs, jbs):
        with pytest.raises(ValueError):
            mod.find_opt_blk(1, 100, 60, 0.25, [(64, 64)],
                             run_layer=fake_latency)


def test_infinite_latency_is_never_chosen():
    """A block the kernel cannot launch scores inf; the search picks among
    the rest, as the reference's does."""
    def run(layer):
        return math.inf if layer.block_shape == (8, 8) else \
            fake_latency(layer)
    got = tbs.find_opt_blk(1, 256, 256, 0.25, SMALL, run_layer=run)
    assert got == jbs.find_opt_blk(1, 256, 256, 0.25, SMALL, run_layer=run)
    assert got[0] != (8, 8)


def test_wallclock_runner_on_the_cpu():
    """The port's backend times its own ``bcr_spmm``: on the CPU the plain
    version, at fp32 and bf16; the search over it returns a candidate."""
    for dtype in (torch.float32, torch.bfloat16):
        t = tbs.wallclock_runner(tbs.synthesize(4, 128, 64, 0.25, (16, 16)),
                                 iters=2, device="cpu", dtype=dtype)
        assert 0 < t < 10
    run = functools.partial(tbs.wallclock_runner, iters=1, device="cpu")
    size, log = tbs.find_opt_blk(2, 128, 64, 0.25, SMALL, run_layer=run)
    assert [s for s, _ in log] == [s for s in SMALL
                                   if 64 % s[0] == 0 and 128 % s[1] == 0]
    assert size in [s for s, _ in log]
    assert all(0 < t < 10 for _, t in log)


def test_default_backend_is_the_card():
    """The default ``run_layer`` times the CUDA kernel on the card: with no
    card visible it raises instead of timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError):
        tbs.find_opt_blk(1, 64, 64, 0.25, [(16, 16)])
