"""K2's work tally on the card (marked ``gpu``: each test skips without a
CUDA card).  This file imports no JAX, so it runs on a machine that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_k2_counters_card.py

``w_lanes_kernel`` adds its active lanes' trips and their number to the
counters ``k2.lane_trips`` and ``k2.active_lanes`` (``runtime.profiling``):
they equal the trips the launches return, and a captured block graph adds
on every replay what the eager step adds.  A profiler with CUDA activities
alone, as the benchmark opens it, counts as one that looks.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.runtime.profiling import span

torch.set_num_threads(1)


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


@pytest.mark.gpu
def test_k2_counters_equal_the_returned_trips():
    dev = _card()
    rng = np.random.default_rng(3)
    b, f, r, m = 16, 513, 50, 100
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    mask = rng.random((b, r)) > 0.3
    v = t(rng.gamma(0.6, 2.0, (b, f, m)))
    w0 = t((rng.random((b, f, r)) + 1e-3) * mask[:, None, :])
    h = t(rng.random((b, r, m)) * mask[:, :, None])
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[[1, b - 2]] = False
    args = (v, w0, h, active, 100, 1e-3, 5.0, 1e-9)
    with _session():
        w, trips = mu.mu_w_solve_lanes(*args)
        w2, trips2 = mu.mu_w_solve_lanes(*args)
    c = profiling.counters()
    assert torch.equal(w, w2) and torch.equal(trips, trips2)
    assert int(trips[~active].sum()) == 0 and int(trips[active].min()) > 0
    assert c["k2.lane_trips"] == 2 * int(trips.sum())
    assert c["k2.active_lanes"] == 2 * (b - 2)


def _enhancer(dev, k_block=8):
    from se_snmf_nat_tpu_torch.headline import HEADLINE_PLAN
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    plan = dict(HEADLINE_PLAN, block_adapt=k_block, frame_bucket=k_block)
    return SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, **plan)


@pytest.mark.gpu
def test_k2_counters_advance_on_each_replay_of_a_block_graph():
    dev = _card()
    enh = _enhancer(dev)
    xs = [fixtures.noisy_utterance(16000 + 800 * i, seed=i) for i in range(5)]
    step = enh.run.step
    step._use_graph = False
    with _session():
        eager = enh.enhance_batch(xs, micro_batch=None)
    want = profiling.counters()
    assert want["k2.active_lanes"] > 0 and want["k2.lane_trips"] > 0
    step._use_graph = True
    enh.enhance_batch(xs, micro_batch=None)      # the capture
    assert list(step._graphs) == [(5, 8)]
    n0 = mu.mu_w_solve_lanes.launches
    with _session():
        for _ in range(2):
            for e, g in zip(eager, enh.enhance_batch(xs, micro_batch=None)):
                assert np.array_equal(e, g)
    got = profiling.counters()
    frames = (16000 + 800 * 4) // 160 + 4        # the longest lane's
    blocks = -(-frames // 8)
    assert mu.mu_w_solve_lanes.launches - n0 == 2 * blocks
    assert got["k2.lane_trips"] == 2 * want["k2.lane_trips"]
    assert got["k2.active_lanes"] == 2 * want["k2.active_lanes"]
