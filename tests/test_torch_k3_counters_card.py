"""K3's work tally on the card (marked ``gpu``: each test skips without a
CUDA card).  This file imports no JAX, so it runs on a machine that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_k3_counters_card.py

Both of ``mu_h_solve_columns``' paths (W resident at R=200, streamed from
L2 at the exemplar width R=1000) add the columns they solved and their
trips to the counters ``k3.columns`` and ``k3.column_trips``
(``runtime.profiling``): they equal the trips the launches return, read
after the launches under an active profiler.  A call adds no launch and no
synchronisation for them; the fast plan at the exemplar width runs one K3
launch a call, on the streaming path, and counts every column of it.
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


@pytest.mark.gpu
@pytest.mark.parametrize("r,resident", [(200, 1), (1000, 0)])
def test_k3_counters_equal_the_returned_trips(r, resident):
    dev = _card()
    n = 2000
    args = _args(dev, r, n)
    assert mu.mu_h_solve_columns_shape(F, r, n)["resident"] == resident
    with _session():
        h, trips = mu.mu_h_solve_columns(*args)
        h2, trips2 = mu.mu_h_solve_columns(*args)
    c = profiling.counters()
    assert torch.equal(h, h2) and torch.equal(trips, trips2)
    assert int(trips.min()) > 0 and int(trips.max()) <= 50
    assert c["k3.columns"] == 2 * n
    assert c["k3.column_trips"] == 2 * int(trips.sum())


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
    assert 1 <= c["k3.column_trips"] / n <= 50
    assert len(outs) == 64 and all(y.dtype == np.int16 for y in outs)
