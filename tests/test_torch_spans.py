"""The port's span recorder (``runtime/profiling.py``): ``span``, the
stages that tile a request (``request``, ``stage``) and the counters, on the
CPU under a CPU-only ``torch.profiler``.  Nothing is recorded without a
profiler; a new profiled session clears the spans and takes the counters'
starts, and both stay readable after the profiler stops; the four stages
tile a call of ``enhance_batch``, a ``StreamingSession.push`` and a
samples-wire ``MultiStreamSession.push`` (one span each, end to start, their
sum the call's wall), ``enhance_batch`` on the int16 and on the float
upload too; the padding counters on known lengths; the lanes sent and those
sent as int16; K2's work tally on the plain path."""

import contextlib
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.runtime.profiling import count, span
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

torch.set_num_threads(1)
STAGES = ("prep", "launch", "fetch", "emit")
SHIFT = 160


@contextlib.contextmanager
def _profiled():
    """A profiled session of its own: a span outside a profiler first
    (profilers opened one after the other with no span between them are
    one session)."""
    with span("unseen"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def _names():
    return [n for n, _, _ in profiling.spans()]


def _cfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                      adapt=replace(cfg.adapt, r_a=4, m_a=10),
                      nmf=replace(cfg.nmf, max_iter=6))


def _bases(cfg):
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 8, 8, seed=0)
    return bx, bd, bx, bd


@pytest.fixture(scope="module")
def block_enh():
    cfg = _cfg()
    return SnmfEnhancer(cfg, *_bases(cfg), device="cpu", block_adapt=8,
                        frame_bucket=8, block_iter_cap=6, block_refit_cap=6,
                        block_fixed_iter=True, dft_matmul=True)


@pytest.fixture(scope="module")
def exact_enh():
    cfg = _cfg()
    return SnmfEnhancer(cfg, *_bases(cfg), device="cpu")


def test_nothing_is_recorded_without_a_profiler():
    with _profiled():
        with span("kept"):
            pass
    assert _names() == ["kept"]
    with span("a"):
        with span("b"):
            pass
    with profiling.request("r.prep"):
        profiling.stage("r.launch")
    profiling.stage("r.emit")
    assert _names() == ["kept"]
    # off, a span is one shared do-nothing context manager
    assert span("a") is span("b") is profiling.request("r.prep")


def test_nested_and_repeated_spans_inside_one_profile():
    with _profiled() as prof:
        t0 = time.perf_counter()
        with span("outer"):
            for _ in range(3):
                with span("inner"):
                    sum(range(2000))
        t1 = time.perf_counter()
    got = profiling.spans()
    assert _names() == ["inner"] * 3 + ["outer"]
    _, a, b = got[-1]
    assert t0 <= a < b <= t1
    inner = [(s, e) for _, s, e in got[:3]]
    for (s, e), (s2, _) in zip(inner, inner[1:]):
        assert s < e <= s2
    assert all(a <= s and e <= b for s, e in inner)
    # each span opened a record_function: its name is in the trace
    names = {e.name for e in prof.events()}
    assert {"outer", "inner"} <= names


def test_a_new_session_resets_the_spans_and_the_counters():
    count("test.items", 5)
    with _profiled():
        with span("first"):
            count("test.items", 2)
        count("test.items", 1)
    # readable after the profiler stopped
    assert _names() == ["first"]
    assert profiling.counters()["test.items"] == 3
    with span("unseen"):
        count("test.items", 100)            # between two sessions
    assert profiling.counters()["test.items"] == 103
    with _profiled():
        with profiling.request("second.prep"):
            count("test.items", 4)
    assert _names() == ["second.prep"]
    assert profiling.counters()["test.items"] == 4


def _assert_tiled(prefix, t0, t1):
    got = sorted((a, b, n) for n, a, b in profiling.spans()
                 if n.startswith(prefix))
    assert [n for _, _, n in got] == [prefix + s for s in STAGES]
    for (_, end, _), (start, _, _) in zip(got, got[1:]):
        assert start == end                 # one clock reading between
    assert t0 <= got[0][0] and got[-1][1] <= t1
    total = sum(b - a for a, b, _ in got)
    assert total == pytest.approx(t1 - t0, rel=0.02)


def test_four_stages_tile_enhance_batch(block_enh):
    xs = [fixtures.noisy_utterance(n, seed=i)
          for i, n in enumerate((3300, 2080, 4800))]
    want = block_enh.enhance_batch(xs, micro_batch=None)
    with _profiled():
        t0 = time.perf_counter()
        got = block_enh.enhance_batch(xs, micro_batch=None)
        t1 = time.perf_counter()
    _assert_tiled("batch.", t0, t1)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def _lanes_sent_as(kind):
    """Three lanes, integer-valued float64 (``float``), int16 (``int16``)
    or float64 with a half sample in the second (``fraction``)."""
    xs = [fixtures.noisy_utterance(n, seed=i)
          for i, n in enumerate((3300, 2080, 4800))]
    if kind == "int16":
        return [x.astype(np.int16) for x in xs]
    if kind == "fraction":
        xs[1][7] += 0.5
    return xs


@pytest.mark.parametrize("kind", ["int16", "fraction"])
def test_four_stages_tile_enhance_batch_on_either_upload(block_enh, kind):
    xs = _lanes_sent_as(kind)
    want = block_enh.enhance_batch(xs, micro_batch=None)
    with _profiled():
        t0 = time.perf_counter()
        got = block_enh.enhance_batch(xs, micro_batch=None)
        t1 = time.perf_counter()
    _assert_tiled("batch.", t0, t1)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,sent_int16", [("int16", 3), ("float", 3),
                                             ("fraction", 0)])
@pytest.mark.parametrize("micro_batch", [None, 2])
def test_lane_counters_count_what_was_sent(block_enh, kind, sent_int16,
                                           micro_batch):
    with _profiled():
        block_enh.enhance_batch(_lanes_sent_as(kind),
                                micro_batch=micro_batch)
    c = profiling.counters()
    assert c["batch.lanes"] == 3
    assert c["batch.lanes_int16"] == sent_int16


def test_four_stages_tile_a_session_push(exact_enh):
    x = fixtures.noisy_utterance(8 * SHIFT, seed=4)
    sess = StreamingSession(exact_enh)
    for i in range(5):
        sess.push(x[i * SHIFT: (i + 1) * SHIFT])
    with _profiled():
        t0 = time.perf_counter()
        y = sess.push(x[5 * SHIFT: 6 * SHIFT])
        t1 = time.perf_counter()
    assert len(y) == SHIFT
    _assert_tiled("stream.", t0, t1)


def test_four_stages_tile_a_samples_wire_fleet_push(exact_enh):
    lanes, k = 3, 4
    x = np.stack([fixtures.noisy_utterance(3 * k * SHIFT, seed=10 + i)
                  for i in range(lanes)])
    fleet = MultiStreamSession(exact_enh, lanes, block_frames=k,
                               wire="samples")
    fleet.push(x[:, : k * SHIFT])
    with _profiled():
        t0 = time.perf_counter()
        y = fleet.push(x[:, k * SHIFT: 2 * k * SHIFT])
        t1 = time.perf_counter()
    assert y.shape == (lanes, k * SHIFT)
    _assert_tiled("stream.", t0, t1)


@pytest.mark.parametrize("micro_batch,computed", [(None, 3 * 40),
                                                  (2, 2 * 2 * 40)])
def test_padding_counters_on_known_lengths(block_enh, micro_batch,
                                           computed):
    # 20, 13 and 30 hops: 24, 17 and 34 frames with the delay's 3 and the
    # flush frame, in a bucket of 40 frames (5 blocks of 8)
    xs = [fixtures.noisy_utterance(n, seed=i)
          for i, n in enumerate((20 * SHIFT + 37, 13 * SHIFT, 30 * SHIFT))]
    assert block_enh.cfg.delay == 3
    with _profiled():
        block_enh.enhance_batch(xs, micro_batch=micro_batch)
    c = profiling.counters()
    assert c["batch.frames_true"] == 24 + 17 + 34
    assert c["batch.frames_computed"] == computed


def test_k2_counters_on_the_plain_path():
    rng = np.random.default_rng(5)
    b, f, r, m = 5, 33, 4, 6
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    v = t(rng.gamma(0.8, 2.0, (b, f, m)))
    w0 = t(rng.random((b, f, r)) + 0.05)
    h = t(rng.random((b, r, m)))
    active = torch.tensor([True, False, True, True, False])
    with _profiled():
        with span("k2"):
            _, trips = mu.mu_w_solve_lanes(v, w0, h, active, 12, 1e-3, 5.0,
                                           1e-9)
            _, trips2 = mu.mu_w_solve_lanes(v, w0, h, active, 12, 1e-3, 5.0,
                                            1e-9)
    c = profiling.counters()
    assert int(trips[~active].sum()) == 0 and int(trips[active].min()) > 0
    assert c["k2.lane_trips"] == int(trips[active].sum()) \
        + int(trips2[active].sum())
    assert c["k2.active_lanes"] == 2 * 3
