"""The exact plan's frame loop under CUDA graphs on the card (marked
``gpu``: each test skips without a CUDA card).  This file imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_frame_graph_card.py

``SnmfEnhancer.frame_loop`` on the kernel route runs as replays of
``_FrameGraph``s; ``enh._graph_frames = False`` runs the same loop step by
step, which these tests hold the graphs to, bit for bit in float32: at 1,
16 and 200 lanes over 56 frames (crossing ``l == 1``, ``init_n_len`` 15
and ``P_len_l`` 20), with lanes of mixed lengths, through ``enhance_batch``,
and with two sessions taking turns on one enhancer.  A replay adds to
``frame.steps_graphed`` as to ``frame.steps``, and K1's and K2's launch
counts and K2's device counters advance as in the step-by-step loop.
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.enhance.state import EngineState, batch_state
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

torch.set_num_threads(1)
T = 56


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    return require_cuda()


def _enhancer(dev):
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=1)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev)
    assert enh._graph_frames
    assert enh.engine.h_solver == enh.engine.w_solver == "kernel"
    return enh


def _spectra(enh, lanes, t=T):
    s = enh.cfg.signal
    n = (t - enh.cfg.delay - 1) * s.frameshift
    frames = np.stack([enh.frames_for(fixtures.noisy_utterance(n, seed=k))
                       for k in range(lanes)])[:, :t]
    mag, _ = enh.analysis(torch.as_tensor(frames, dtype=enh.dtype,
                                          device=enh.device))
    return mag


def _tallies(dev):
    """K1's and K2's launches, K2's device counters and the frame
    counters, as they stand."""
    torch.cuda.synchronize(dev)
    k2 = profiling.device_counters(mu.K2_COUNTERS, dev).tolist()
    host = profiling.RECORDER.host
    return np.array([mu.mu_h_solve_lanes.launches,
                     mu.mu_w_solve_lanes.launches, *k2,
                     host.get("frame.steps", 0),
                     host.get("frame.steps_graphed", 0)])


def _run(enh, mag, n_valid, graphed, l0=1):
    enh._graph_frames = graphed
    eng = enh.engine
    with torch.no_grad():
        st0 = batch_state(eng.init_state(), mag.shape[0])
        before = _tallies(enh.device)
        st, (xm,) = enh.frame_loop(eng, mag, st0, n_valid, l0)
        return st, xm, _tallies(enh.device) - before


def _same(a, b):
    st_a, xm_a, _ = a
    st_b, xm_b, _ = b
    assert torch.equal(xm_a, xm_b)
    for name in EngineState._fields:
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 16, 200])
def test_graphed_loop_gives_the_eager_bits(lanes):
    dev = _card()
    enh = _enhancer(dev)
    mag = _spectra(enh, lanes)
    n_valid = [T] * lanes
    eager = _run(enh, mag, n_valid, False)
    first = _run(enh, mag, n_valid, True)       # warm-up chunks, captures
    again = _run(enh, mag, n_valid, True)       # every chunk a replay
    _same(first, eager)
    _same(again, eager)
    graphs = enh._frame_graphs[(enh.engine, lanes)].graphs
    assert sorted(graphs) == [(8, False), (16, False)]
    d_eager, d_again = eager[2], again[2]
    # K1 and K2 launches, K2's lane-trips and active lanes
    assert np.array_equal(d_again[:4], d_eager[:4])
    assert d_eager[0] == d_eager[1] == T
    assert np.array_equal(first[2][:2], d_eager[:2])
    assert d_again[4] == d_again[5] == T
    # the first call runs the first 16-frame chunk and the 8-frame tail
    # eagerly, each before its capture
    assert d_eager[5] == 0 and first[2][5] == T - 16 - 8


@pytest.mark.gpu
def test_graphed_loop_keeps_lanes_past_their_end():
    """Lanes of mixed lengths: the masked graphs keep a finished lane's
    state and zero its outputs, the bits of the step-by-step loop."""
    dev = _card()
    enh = _enhancer(dev)
    lanes = 16
    n_valid = list(np.random.default_rng(7).integers(20, T + 1, lanes))
    n_valid[3] = T
    mag = _spectra(enh, lanes)
    eager = _run(enh, mag, n_valid, False)
    for _ in range(2):
        got = _run(enh, mag, n_valid, True)
        _same(got, eager)
    for lane, n in enumerate(n_valid):
        assert not got[1][lane, n:].any()
    keys = enh._frame_graphs[(enh.engine, lanes)].graphs
    assert any(masked for _, masked in keys)
    assert np.array_equal(got[2][:4], eager[2][:4])


@pytest.mark.gpu
def test_graphed_exact_batch_gives_the_eager_int16():
    """``enhance_batch`` on the exact plan (16 lanes of unequal lengths):
    the graphed loop's int16 are the step-by-step loop's."""
    dev = _card()
    enh = _enhancer(dev)
    assert enh.run is None and enh.fast_run is None
    hop = enh.cfg.signal.frameshift
    xs = [fixtures.noisy_utterance(hop * (150 + 9 * k), seed=20 + k)
          for k in range(16)]
    enh._graph_frames = False
    want = enh.enhance_batch(xs, micro_batch=None)
    enh._graph_frames = True
    for _ in range(2):
        got = enh.enhance_batch(xs, micro_batch=None)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


@pytest.mark.gpu
def test_sessions_take_turns_on_one_graphed_enhancer():
    """Two ``StreamingSession``s (a frame a push) on one enhancer, pushing
    in turn through its one-frame graph, each give the int16 they give
    alone on an enhancer that steps frame by frame."""
    dev = _card()
    hop = default_config().signal.frameshift
    xs = [fixtures.noisy_utterance(T * hop, seed=k) for k in (5, 6)]
    alone = []
    for x in xs:
        enh = _enhancer(dev)
        enh._graph_frames = False
        sess = StreamingSession(enh)
        alone.append(np.concatenate(
            [sess.push(x[i: i + hop]) for i in range(0, len(x), hop)]
            + [sess.flush()]))
    enh = _enhancer(dev)
    sessions = [StreamingSession(enh) for _ in xs]
    got = [[], []]
    for i in range(0, T * hop, hop):
        for k, sess in enumerate(sessions):
            got[k].append(sess.push(xs[k][i: i + hop]))
    for k, sess in enumerate(sessions):
        got[k].append(sess.flush())
    for k in range(2):
        assert np.array_equal(np.concatenate(got[k]), alone[k])
    assert list(enh._frame_graphs[(enh.engine, 1)].graphs) == [(1, False)]
