"""K3's work tally on the card (marked ``gpu``: each test skips without a
CUDA card).  This file imports no JAX, so it runs on a machine that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_k3_counters_card.py

Both of ``mu_h_solve_columns``' paths (W resident at R=200, streamed from
L2 at the exemplar width R=1000) add the columns they solved and their
trips to the counters ``k3.columns`` and ``k3.column_trips``
(``runtime.profiling``): they equal the trips the launches return, read
after the launches under an active profiler.  The streaming path also adds
the W chunks its blocks took from their rings, ``k3.ring_chunks``: the
chunks its schedule implies for each tile's trips (the first L pass, then
a numerator and an L pass a trip but for the cap's L), and those not yet
landed at warp 0's first probe, ``k3.ring_waits``; the resident path adds
neither.  A call adds no launch and no synchronisation for them; the fast
plan at the exemplar width runs one K3 launch a call, on the streaming
path, and counts every column of it.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import preset
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.runtime.profiling import span

torch.set_num_threads(1)
F = 513


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    return require_cuda()


@contextlib.contextmanager
def _session():
    """A profiled session of its own, with CUDA activities alone."""
    with span("unseen"):
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with span("session"):
            assert torch._C._autograd._profiler_enabled()
        yield prof


def _args(dev, r, n, seed=3):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    v = t(rng.gamma(0.6, 2.0, (n, F))).t()          # the fast plan's view
    w = t(rng.random((F, r)) + 1e-3)
    h0 = t(rng.random((r, 1)))
    return v, w, h0, 50, 1e-3, 5.0, 1e-9


def ring_chunks(shape: dict, f: int, r: int, trips, cap: int) -> int:
    """The chunks the streaming path's consumers take for a launch: a tile
    of 16 columns runs as many trips as its slowest column; it takes the
    first L pass, then a numerator pass and an L pass a trip, but for the L
    of a trip at the cap; a pass sweeps its layout's chunks once a round of
    rows."""
    num = shape["num_rounds"] * -(-f // shape["chunk_rows_f"])
    lam = shape["lam_rounds"] * -(-r // shape["chunk_rows_r"])
    t = trips.cpu().numpy()
    tiles = [int(t[i:i + 16].max()) for i in range(0, len(t), 16)]
    return sum(lam + k * num + (k - (k == cap)) * lam for k in tiles if cap)


@pytest.mark.gpu
@pytest.mark.parametrize("r,resident", [(200, 1), (1000, 0)])
def test_k3_counters_equal_the_returned_trips(r, resident):
    dev = _card()
    n = 2000
    args = _args(dev, r, n)
    shape = mu.mu_h_solve_columns_shape(F, r, n)
    assert shape["resident"] == resident
    with _session():
        h, trips = mu.mu_h_solve_columns(*args)
        h2, trips2 = mu.mu_h_solve_columns(*args)
    c = profiling.counters()
    assert torch.equal(h, h2) and torch.equal(trips, trips2)
    assert int(trips.min()) > 0 and int(trips.max()) <= 50
    assert c["k3.columns"] == 2 * n
    assert c["k3.column_trips"] == 2 * int(trips.sum())
    want = 0 if resident else 2 * ring_chunks(shape, F, r, trips, 50)
    assert c["k3.ring_chunks"] == want
    assert 0 <= c["k3.ring_waits"] <= want


@pytest.mark.gpu
@pytest.mark.parametrize("f,r,n,cap,eps", [(513, 1000, 1003, 22, 0.0),
                                           (513, 1000, 1003, 1, 1e-3),
                                           (400, 1200, 600, 30, 1e-3),
                                           (1100, 600, 100, 12, 1e-3)])
def test_k3_ring_chunks_follow_the_schedule(f, r, n, cap, eps):
    """Fixed trips, the cap of one trip, a shape whose numerator pass takes
    two rounds of rows (R=1200: 1,024 rows a round) and one whose L pass
    takes three (F=1100: 512 rows a round, more than two left over)."""
    dev = _card()
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    args = (t(rng.gamma(0.6, 2.0, (n, f))).t(), t(rng.random((f, r)) + 1e-3),
            t(rng.random((r, 1))), cap, eps, 5.0, 1e-9)
    shape = mu.mu_h_solve_columns_shape(f, r, n)
    assert shape["resident"] == 0 and shape["ring_stages"] >= 2
    assert shape["num_rounds"] == -(-r // 1024)
    with _session():
        _, trips = mu.mu_h_solve_columns(*args)
    c = profiling.counters()
    assert c["k3.ring_chunks"] == ring_chunks(shape, f, r, trips, cap)
    assert 0 <= c["k3.ring_waits"] <= c["k3.ring_chunks"]


@pytest.mark.gpu
@pytest.mark.parametrize("r,kernels", [(200, 1), (1000, 2)])
def test_k3_counts_with_no_launch_or_synchronisation(r, kernels):
    dev = _card()
    args = _args(dev, r, 1000)
    mu.mu_h_solve_columns(*args)            # the counters' buffer
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            mu.mu_h_solve_columns(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(dev)
    from torch.autograd import DeviceType
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == DeviceType.CUDA
             and not ev.name().startswith(("Memcpy", "Memset"))]
    assert len(names) == kernels, names


@pytest.mark.gpu
def test_the_exemplar_fast_plan_at_its_widths_counts_one_streaming_launch():
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    dev = _card()
    cfg = preset("exemplar")
    bx, bd = fixtures.structured_bases(F, 500, 500, seed=0)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, dft_matmul=True)
    assert enh.fast_run is not None
    xs = [fixtures.noisy_utterance(54880, seed=i) for i in range(64)]
    enh.enhance_batch(xs, micro_batch=None)
    n = 64 * 384                              # 347 frames, a bucket of 128
    assert mu.mu_h_solve_columns_shape(F, 1000, n)["resident"] == 0
    n0 = mu.mu_h_solve_columns.launches
    with _session():
        outs = enh.enhance_batch(xs, micro_batch=None)
    c = profiling.counters()
    assert mu.mu_h_solve_columns.launches - n0 == 1
    assert c["k3.columns"] == n
    assert c["k3.ring_chunks"] > 0
    assert 1 <= c["k3.column_trips"] / n <= 50
    assert len(outs) == 64 and all(y.dtype == np.int16 for y in outs)
