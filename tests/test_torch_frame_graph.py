"""The exact plan's graphed frame loop, rehearsed on the CPU.

On the card, where both of the engine's solvers are kernels,
``SnmfEnhancer.frame_loop`` runs as replays of CUDA graphs of
``pipeline.frame_chunk``: C steps with a (B,) tensor frame number, and a
mask that keeps the state of a lane past its last real frame and zeroes its
output.  Here the chunk body runs eagerly and is held to the host-integer
loop bit for bit; then the graphed loop's bookkeeping (a capture a (lanes,
C, masked), the state chained through static buffers, sessions taking
turns on one enhancer) runs with the CUDA graph replaced by a re-run of the
captured body on the static buffers.  The card's own graphs are held to the
eager loop in ``tests/test_torch_frame_graph_card.py``.

The configuration is the reference's default at narrow dictionaries
(r_x = r_d = 16, r_a = 8, m_a = 12), so 48 frames cross ``l == 1``,
``init_n_len`` (15) and ``P_len_l`` (20), and the adaptation refits.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.enhance.state import EngineState, batch_state
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.stream import pipeline as pl
from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

torch.set_num_threads(1)
T = 48
T_PAD = 64
LANES = 3


def _cfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=16, r_d=16),
                      adapt=replace(cfg.adapt, r_a=8, m_a=12))


def _enhancer(dtype=torch.float32):
    cfg = _cfg()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 16, 16, seed=2)
    return pl.SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu", dtype=dtype)


def _spectra(enh, lanes=LANES, t=T_PAD):
    """Spectra (lanes, t, F) of noisy utterances, a seed a lane."""
    s = enh.cfg.signal
    n = (t - enh.cfg.delay - 1) * s.frameshift
    frames = np.stack([enh.frames_for(fixtures.noisy_utterance(n, seed=k))
                       for k in range(lanes)])[:, :t]
    mag, _ = enh.analysis(torch.as_tensor(frames, dtype=enh.dtype))
    return mag


def _states_equal(a: EngineState, b: EngineState) -> None:
    for name in EngineState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _host_counts():
    return {k: profiling.RECORDER.host.get(k, 0)
            for k in ("frame.steps", "frame.steps_graphed")}


# (each lane's real frames, the chunks' lengths, every chunk masked)
CHUNKS = {
    "equal_lanes": ([T, T, T], [16, 16, 16], False),
    "unequal_lanes": ([T, 30, 17], [16, 16, 16], False),
    "straddling_chunk": ([T, 40, 21], [20, 28], False),
    "one_frame_chunks": ([T, 33, 9], [1] * T, False),
    "mask_everywhere": ([T, T, T], [7, 41], True),
}


@pytest.mark.parametrize("case", list(CHUNKS))
def test_frame_chunk_gives_the_host_integer_loop_bits(case):
    """The chunk body with a (B,) tensor frame number and the device limit
    (``l + n_valid``), chunk after chunk, gives the bits of the step-by-step
    loop with host-integer frame numbers: every output frame (zero past a
    lane's end) and the final state."""
    n_valid, splits, mask_all = CHUNKS[case]
    enh = _enhancer()
    eng = enh.engine
    assert (eng.h_solver, eng.w_solver) == ("kernel", "kernel")
    mag = _spectra(enh)
    with torch.no_grad():
        st0 = batch_state(eng.init_state(), LANES)
        want_st, (want,) = enh.frame_loop(eng, mag, st0, n_valid)
        lim = torch.as_tensor(n_valid, dtype=torch.int64) + 1
        state, got, i = st0, [], 0
        for c in splits:
            masked = mask_all or i + c > min(n_valid)
            state, (xm,) = pl.frame_chunk(
                eng, state, mag[:, i: i + c],
                torch.full((LANES,), 1 + i, dtype=torch.int64), lim, masked)
            got.append(xm)
            i += c
    assert torch.equal(torch.cat(got, dim=1), want[:, :T])
    assert not want[:, T:].any()
    for lane, n in enumerate(n_valid):
        assert not want[lane, n:].any()
    _states_equal(state, want_st)


class _FakeGraph:
    """A CUDA graph whose replay re-runs the captured body."""

    def __init__(self):
        self.fn = None

    def replay(self):
        self.fn()


class _FakeContext:
    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _fake_cuda_graphs(monkeypatch):
    """CUDA graphs replaced on the CPU; returns the captures' keys and
    pools, in order."""
    captures = []
    real = pl._FrameGraph.capture

    def capture(fg, engine, key, outs, pool):
        real(fg, engine, key, outs, pool)
        graph, *_, body = fg.graphs[key]
        graph.fn = body
        captures.append((engine, fg.l.shape[0], key, pool))

    monkeypatch.setattr(pl.torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(pl.torch.cuda, "graph", _FakeContext)
    monkeypatch.setattr(pl.torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(pl.torch.cuda, "device", _FakeContext)
    monkeypatch.setattr(pl._FrameGraph, "capture", capture)
    return captures


@pytest.mark.parametrize("n_valid,keys", [
    ([T, 30, 17], [(16, False), (16, True)]),
    ([45, 45, 45], [(16, False), (13, False)]),
    ([45, 20, 45], [(16, False), (16, True), (13, True)]),
])
def test_graphed_loop_bookkeeping_on_the_cpu(n_valid, keys, monkeypatch):
    """The graphed loop with the graph replaced by its body: the eager
    loop's bits on a first call (each new (C, masked) eager, then captured)
    and on a second (every chunk a replay, the state chained through the
    static buffers); one capture a key, all in one pool; ``frame.steps``
    counts every frame stepped, ``frame.steps_graphed`` those replayed."""
    captures = _fake_cuda_graphs(monkeypatch)
    monkeypatch.setattr(pl, "FRAME_CHUNK", 16)
    enh = _enhancer()
    eng = enh.engine
    mag = _spectra(enh)
    n_run = max(n_valid)
    with torch.no_grad():
        st0 = batch_state(eng.init_state(), LANES)
        want_st, (want,) = enh.frame_loop(eng, mag, st0, n_valid)
        enh._graph_frames = True
        before = _host_counts()
        runs = [enh.frame_loop(eng, mag, st0, n_valid) for _ in range(2)]
        after = _host_counts()
    assert [k for _, _, k, _ in captures] == keys
    assert all(e is eng and b == LANES for e, b, _, _ in captures)
    assert len({id(p) for *_, p in captures}) == 1
    assert list(enh._frame_graphs) == [(eng, LANES)]
    for st, (xm,) in runs:
        assert torch.equal(xm, want)
        _states_equal(st, want_st)
    first_eager = sum(c for c, _ in keys)
    assert after["frame.steps"] - before["frame.steps"] == 2 * n_run
    assert (after["frame.steps_graphed"] - before["frame.steps_graphed"]
            == 2 * n_run - first_eager)


def test_graphed_loop_with_tensor_frame_numbers(monkeypatch):
    """A (B,) tensor ``l0`` (a fleet's per-lane clocks, lanes started at
    other frames) takes the same graphs and gives the bits of the eager
    loop with that tensor, on a first call and on a second that replays
    every chunk."""
    _fake_cuda_graphs(monkeypatch)
    enh = _enhancer()
    eng = enh.engine
    mag = _spectra(enh, t=24)
    l0 = torch.tensor([1, 9, 17])
    with torch.no_grad():
        st0 = batch_state(eng.init_state(), LANES)
        want_st, (want,) = enh.frame_loop(eng, mag, st0, [24] * LANES, l0)
        enh._graph_frames = True
        runs = [enh.frame_loop(eng, mag, st0, [24] * LANES, l0)
                for _ in range(2)]
    assert list(enh._frame_graphs[(eng, LANES)].graphs) == [(16, False),
                                                           (8, False)]
    for st, (xm,) in runs:
        assert torch.equal(xm, want)
        _states_equal(st, want_st)


def test_graphed_separation_takes_its_own_graphs(monkeypatch):
    """``separate``'s engine (three outputs a step) gets graphs of its own
    key beside the enhancing engine's, and its bits."""
    _fake_cuda_graphs(monkeypatch)
    enh = _enhancer()
    x = fixtures.noisy_utterance(40 * enh.cfg.signal.frameshift, seed=4)
    want = enh.separate(x)
    enh._graph_frames = True
    enh.enhance(x, return_state=True)
    for _ in range(2):
        got = enh.separate(x)
        for key in ("enhanced", "events", "noises"):
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(want[key])), key
    engines = [e for e, _ in enh._frame_graphs]
    assert engines == [enh.engine, enh._source_engine]


def test_sessions_take_turns_on_one_graphed_enhancer(monkeypatch):
    """Two ``StreamingSession``s (a frame a push) on one graphed enhancer,
    pushing in turn, share its graphs and each gives the output it gives
    alone on an eager enhancer."""
    _fake_cuda_graphs(monkeypatch)
    hop = _enhancer().cfg.signal.frameshift
    xs = [fixtures.noisy_utterance(T * hop, seed=k) for k in (5, 6)]
    alone = []
    for x in xs:
        sess = StreamingSession(_enhancer())
        alone.append(np.concatenate([sess.push(x[i: i + hop])
                                     for i in range(0, len(x), hop)]
                                    + [sess.flush()]))
    enh = _enhancer()
    enh._graph_frames = True
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frame_counters_on_the_eager_routes(dtype):
    """Off the card (and on the plain solvers, float64) the loop runs step
    by step: ``frame.steps`` counts every frame it steps, past the shortest
    lane's end too, and ``frame.steps_graphed`` stays where it was."""
    enh = _enhancer(dtype)
    eng = enh.engine
    assert not enh._graph_frames
    assert eng.h_solver == ("kernel" if dtype == torch.float32 else "plain")
    mag = _spectra(enh, t=24)
    before = _host_counts()
    with torch.no_grad():
        enh.frame_loop(eng, mag, batch_state(eng.init_state(), LANES),
                       [20, 11, 5])
    after = _host_counts()
    assert after["frame.steps"] - before["frame.steps"] == 20
    assert after["frame.steps_graphed"] == before["frame.steps_graphed"]
