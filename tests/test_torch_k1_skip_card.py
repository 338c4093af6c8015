"""K1's per-lane flag on the card (marked ``gpu``: each test skips without a
CUDA card).  This file imports no JAX, so it runs on a machine that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_k1_skip_card.py

K1 takes an optional ``active`` flag a lane: a lane whose flag is clear
returns its H0 columns and 0 trips, and the solved lanes keep the bits of a
launch with no flag, at every count of active lanes, those in the wave
tail's narrower column groups included (the kernel maps its units onto the
active lanes).  The block step passes "this
lane has a true frame in the block", so ``enhance_batch`` on a batch of
mixed lengths gives the int16 bits of the same batch with every lane
solved.  The narrow path (N <= 4, blocks of 4 frames or fewer) takes the
same flag.  The unit of a lane's first group adds the lane to
``k1.lanes`` and, skipped, to ``k1.lanes_skipped``: direct launches and
every replay of a block graph.
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
F, R, K = 513, 200, 88


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


def _lanes(dev, b, seed=3, h0_lanes=False):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    v = t(rng.gamma(0.6, 2.0, (b, F, K)))
    w = t(rng.random((b, F, R)) + 1e-3)
    h0 = t(rng.random((b, R, K)) if h0_lanes else rng.random((R, K)))
    return v, w, h0


@pytest.mark.gpu
@pytest.mark.parametrize("h0_lanes", [False, True])
@pytest.mark.parametrize("cap,eps", [(22, 0.0), (100, 1e-3)])
def test_k1_flag_keeps_the_solved_lanes_bits(cap, eps, h0_lanes):
    dev = _card()
    b = 64
    shape = mu.h_solve_lanes_shape(b, F, R, K)
    assert shape["path"] == "wide" and shape["lanes_full"] < b
    v, w, h0 = _lanes(dev, b, h0_lanes=h0_lanes)
    args = (v, w, h0, cap, eps, 5.0, 1e-9)
    h_all, trips_all = mu.mu_h_solve_lanes(*args)
    rng = np.random.default_rng(11)
    on = rng.random(b) > 0.4
    on[shape["lanes_full"]:] = [True, False, True, False]   # the wave tail
    ok = torch.zeros((b, K), dtype=torch.bool, device=dev)
    ok[torch.as_tensor(on, device=dev)] = True
    active = ok[:, 0]                                        # a strided view
    assert active.stride(0) == K
    n0 = mu.mu_h_solve_lanes.launches
    with _session():
        h, trips = mu.mu_h_solve_lanes(*args, active=active)
        h2, trips2 = mu.mu_h_solve_lanes(*args, active=active)
    c = profiling.counters()
    assert mu.mu_h_solve_lanes.launches == n0 + 2
    assert torch.equal(h, h2) and torch.equal(trips, trips2)
    sel = torch.as_tensor(on, device=dev)
    assert torch.equal(h[sel], h_all[sel])
    assert torch.equal(trips[sel], trips_all[sel])
    assert int(trips_all[~sel].min()) > 0
    assert torch.equal(h[~sel], h0.expand(b, R, K)[~sel])
    assert not bool(trips[~sel].any())
    assert c["k1.lanes"] == 2 * b
    assert c["k1.lanes_skipped"] == 2 * int((~sel).sum())
    h_on, trips_on = mu.mu_h_solve_lanes(
        *args, active=torch.ones(b, dtype=torch.bool, device=dev))
    assert torch.equal(h_on, h_all) and torch.equal(trips_on, trips_all)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [17, 64])
def test_k1_every_count_of_active_lanes_keeps_the_bits(b):
    """The kernel plans its units from the flags: for every count of
    active lanes (scattered; the wave-tail cut then falls on other lanes and
    other group sizes) the solved lanes keep the bits of a launch with no
    flag, and the clear ones return H0 and 0 trips."""
    dev = _card()
    v, w, h0 = _lanes(dev, b, seed=5)
    args = (v, w, h0, 22, 0.0, 5.0, 1e-9)
    h_all, trips_all = mu.mu_h_solve_lanes(*args)
    rng = np.random.default_rng(b)
    for n_on in range(b + 1):
        sel = torch.zeros(b, dtype=torch.bool, device=dev)
        sel[torch.as_tensor(rng.permutation(b)[:n_on], device=dev)] = True
        h, trips = mu.mu_h_solve_lanes(*args, active=sel)
        assert torch.equal(h[sel], h_all[sel]), n_on
        assert torch.equal(trips[sel], trips_all[sel]), n_on
        assert torch.equal(h[~sel], h0.expand(b, R, K)[~sel]), n_on
        assert not bool(trips[~sel].any()), n_on


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 4])
def test_k1_narrow_path_honours_the_flag(n):
    """The narrow path (N <= 4 columns a lane, one cluster a lane) reads
    the same flag: the solved lanes keep the bits of a launch with no flag,
    a clear lane returns H0 and 0 trips, and both are counted."""
    dev = _card()
    b = 64
    assert mu.h_solve_lanes_shape(b, F, R, n)["path"] == "narrow"
    v, w, h0 = _lanes(dev, b, seed=7)
    v, h0 = v[:, :, :n].contiguous(), h0[:, :n].contiguous()
    args = (v, w, h0, 100, 1e-3, 5.0, 1e-9)
    h_all, trips_all = mu.mu_h_solve_lanes(*args)
    sel = torch.as_tensor(np.random.default_rng(n).random(b) > 0.4,
                          device=dev)
    active = sel[:, None].expand(b, n).contiguous()[:, 0]
    with _session():
        h, trips = mu.mu_h_solve_lanes(*args, active=active)
    c = profiling.counters()
    assert torch.equal(h[sel], h_all[sel])
    assert torch.equal(trips[sel], trips_all[sel])
    assert torch.equal(h[~sel], h0.expand(b, R, n)[~sel])
    assert not bool(trips[~sel].any())
    assert c["k1.lanes"] == b
    assert c["k1.lanes_skipped"] == int((~sel).sum()) > 0


def _enhancer(dev, **plan):
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    return SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, **plan)


def _mixed(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [np.rint(fixtures.noisy_utterance(int(m), seed=i))
            for i, m in enumerate(rng.integers(lo, hi, n))]


@pytest.mark.gpu
def test_k1_counters_advance_on_each_replay_of_a_block_graph():
    dev = _card()
    from se_snmf_nat_tpu_torch.headline import HEADLINE_PLAN
    enh = _enhancer(dev, **dict(HEADLINE_PLAN, block_adapt=8,
                                frame_bucket=8))
    xs = [fixtures.noisy_utterance(n, seed=i)
          for i, n in enumerate((16000, 3000, 9000, 1200, 12000))]
    step = enh.run.step
    step._use_graph = False
    with _session():
        eager = enh.enhance_batch(xs, micro_batch=None)
    want = profiling.counters()
    frames = 16000 // 160 + 4                    # the longest lane's
    blocks = -(-frames // 8)
    skipped = sum(blocks - -(-(n // 160 + 4) // 8)
                  for n in (16000, 3000, 9000, 1200, 12000))
    assert want["k1.lanes"] == 5 * blocks
    assert want["k1.lanes_skipped"] == skipped > 0
    step._use_graph = True
    enh.enhance_batch(xs, micro_batch=None)      # the capture
    assert list(step._graphs) == [(5, 8)]
    with _session():
        for _ in range(2):
            for e, g in zip(eager, enh.enhance_batch(xs, micro_batch=None)):
                assert np.array_equal(e, g)
    got = profiling.counters()
    assert got["k1.lanes"] == 2 * want["k1.lanes"]
    assert got["k1.lanes_skipped"] == 2 * want["k1.lanes_skipped"]


@pytest.mark.gpu
def test_enhance_batch_of_mixed_lengths_gives_the_bits_of_every_lane_solved(
        monkeypatch):
    """``nat_block88.mixed64``'s shape: 64 lanes of 2-12 s on the headline
    plan (K=88, bucket 88), through the block graphs, against an enhancer
    whose block step makes K1 solve every lane of every block."""
    dev = _card()
    from se_snmf_nat_tpu_torch.headline import HEADLINE_PLAN
    from se_snmf_nat_tpu_torch.stream import block_adaptive
    xs = _mixed(64, 32000, 192000, seed=7)
    enh = _enhancer(dev, **HEADLINE_PLAN)
    with _session():
        got = enh.enhance_batch(xs, micro_batch=None)
        got = enh.enhance_batch(xs, micro_batch=None)   # a graph's replay
    c = profiling.counters()
    assert 0 < c["k1.lanes_skipped"] < c["k1.lanes"]
    real = block_adaptive.mu_h_solve_lanes

    def solve_all(*args, active, **kw):
        return real(*args, active=torch.ones_like(active), **kw)

    monkeypatch.setattr(block_adaptive, "mu_h_solve_lanes", solve_all)
    every = _enhancer(dev, **HEADLINE_PLAN)
    want = every.enhance_batch(xs, micro_batch=None)
    want = every.enhance_batch(xs, micro_batch=None)
    for a, b in zip(got, want):
        assert a.dtype == np.int16 and np.array_equal(a, b)


@pytest.mark.gpu
def test_block_adaptive_runs_of_4_frames_give_the_bits_of_every_lane_solved(
        monkeypatch):
    """Blocks of 4 frames take K1's narrow path with the block step's flag:
    a block-adaptive session and fleet of ``block_frames=4`` and
    ``enhance_batch`` at ``block_adapt=4`` on mixed lengths give the int16
    bits of the same runs with K1 given no flag, as it was called before
    it took one."""
    dev = _card()
    from se_snmf_nat_tpu_torch.stream import block_adaptive
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
    lanes, n = 4, 8000
    xs = np.stack([fixtures.noisy_utterance(n, seed=20 + i)
                   for i in range(lanes)])
    batch = _mixed(6, 1200, 16000, seed=3)

    def runs():
        enh = _enhancer(dev, block_adapt=4, block_iter_cap=22)
        fleet = MultiStreamSession(enh, lanes, block_frames=4,
                                   use_block_adaptive=True)
        parts = [fleet.push_per_lane(xs[:, i: i + 1280])
                 for i in range(0, n, 1280)] + [list(fleet.flush())]
        out = {f"fleet{i}": np.concatenate([p[i] for p in parts])
               for i in range(lanes)}
        sess = StreamingSession(enh, block_frames=4, use_block_adaptive=True)
        out["session"] = np.concatenate(
            [sess.push(xs[0, i: i + 160]) for i in range(0, n, 160)]
            + [sess.flush()])
        for i, y in enumerate(enh.enhance_batch(batch, micro_batch=None)):
            out[f"batch{i}"] = y
        return out

    with _session():
        got = runs()
    c = profiling.counters()
    assert 0 < c["k1.lanes_skipped"] < c["k1.lanes"]
    real = block_adaptive.mu_h_solve_lanes

    def no_flag(*args, active, **kw):
        return real(*args, **kw)

    monkeypatch.setattr(block_adaptive, "mu_h_solve_lanes", no_flag)
    want = runs()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == np.int16 and got[k].size > 0, k
        assert np.array_equal(got[k], want[k]), k
