"""Port parity of the serving fleet: ``MultiStreamSession`` and
``ShardedFleet`` of ``se_snmf_nat_tpu_torch.stream.serving`` against solo
port ``StreamingSession``s and against the JAX package's fleet, at narrow
widths (r_x = r_d = 8, r_a = 4, m_a = 10, 6 trips) on seeded synthetic
utterances of about half a second, on the CPU in float64: the int16 streams
are identical, and float outputs agree within 1e-9 relative."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu.stream.serving import MultiStreamSession as JFleet
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.enhance.state import EngineState, lane_state
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.serving import (
    MultiStreamSession, ShardedFleet)
from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

torch.set_num_threads(1)
N = 8320          # 52 hops + 4 flush frames = 56 frames = 7 blocks of 8
SHIFT = 160


def _cfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                      adapt=replace(cfg.adapt, r_a=4, m_a=10),
                      nmf=replace(cfg.nmf, max_iter=6))


def _port(cfg, bases, **kw):
    return SnmfEnhancer(config_from_jax(cfg), *bases, device="cpu",
                        dtype=torch.float64, matlab_ad_blk_init=False, **kw)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    bx, bd = fixtures.synthetic_bases(cfg.signal.n_bins, 8, 8, seed=0)
    bases = (bx, bd, bx, bd)
    ref = JEnhancer(cfg, *bases, dtype=jnp.float64, matlab_ad_blk_init=False)
    return cfg, bases, ref, _port(cfg, bases)


def _lanes(n, length=N, seed=0):
    return np.stack([fixtures.noisy_utterance(length, seed=seed + i)
                     for i in range(n)])


def _run(fleet, xs):
    return np.concatenate([fleet.push(xs), fleet.flush()], axis=1)


def _solo(enh, x, **kw):
    sess = StreamingSession(enh, **kw)
    return np.concatenate([sess.push(x), sess.flush()])


def _chunked(fleet, xs, seed):
    rng = np.random.default_rng(seed)
    parts, i = [], 0
    while i < xs.shape[1]:
        n = int(rng.integers(1, 700))
        parts.append(fleet.push(xs[:, i: i + n]))
        i += n
    parts.append(fleet.flush())
    return np.concatenate([p for p in parts if p.shape[1]], axis=1)


@pytest.mark.parametrize("block_frames", [1, 8])
def test_fleet_equals_solo_sessions_and_jax_fleet(setup, block_frames):
    _, _, ref, enh = setup
    xs = _lanes(3)
    fleet = MultiStreamSession(enh, 3, block_frames=block_frames)
    got = _run(fleet, xs)
    assert got.dtype == np.int16 and got.shape == (3, N + SHIFT)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], _solo(enh, xs[i], block_frames=block_frames))
    np.testing.assert_array_equal(
        got, _run(JFleet(ref, 3, block_frames=block_frames), xs))
    # the refits moved the lanes' dictionaries, each its own way
    head0 = enh.initial_state().b_d_head
    assert (fleet.state.b_d_head[0] - head0).abs().max() > 1e-3
    assert not torch.equal(fleet.state.b_d_head[0], fleet.state.b_d_head[1])
    assert fleet.state.b_d_head.device == head0.device


def test_fleet_irregular_lockstep_chunks(setup):
    """Chunks of 1..700 samples give the streams of one big push."""
    _, _, _, enh = setup
    xs = _lanes(2)
    want = _run(MultiStreamSession(enh, 2), xs)
    np.testing.assert_array_equal(
        _chunked(MultiStreamSession(enh, 2), xs, 3), want)


def test_fleet_dft_matmul_equals_solo_session(setup):
    """The enhancer's matrix-product transform carries into the fleet."""
    cfg, bases, _, _ = setup
    enh_dm = _port(cfg, bases, dft_matmul=True)
    xs = _lanes(2)
    got = _run(MultiStreamSession(enh_dm, 2, block_frames=8), xs)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], _solo(enh_dm, xs[i], block_frames=8))


def test_fleet_resumes_lanes_from_carried_states(setup):
    """``states=``: lanes seeded with carried states equal solo sessions
    seeded with them."""
    _, _, _, enh = setup
    xs = _lanes(2)
    sts = [enh.enhance(x, return_state=True)[1] for x in xs]
    states = EngineState(*(torch.stack(f) for f in zip(*sts)))
    got = _run(MultiStreamSession(enh, 2, states=states, block_frames=4), xs)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], _solo(enh, xs[i], state=sts[i], block_frames=4))
    assert np.any(got[0] != _solo(enh, xs[0], block_frames=4))
    with pytest.raises(ValueError, match="lanes"):
        MultiStreamSession(enh, 3, states=states)


@pytest.mark.parametrize("case", ["one_push", "irregular_chunks",
                                  "float_samples", "partial_tail"])
def test_samples_wire_equals_frames_wire(setup, case):
    """``wire="samples"`` (hops up, framing, overlap-add and the int16
    write on the device, PCM down) gives the frames wire's int16, through
    the flush fallback too; the JAX fleet's samples wire gives the same."""
    _, _, ref, enh = setup
    xs = _lanes(3)
    if case == "float_samples":
        xs = xs + 0.25                   # not integer-valued: a float upload
    if case == "partial_tail":
        xs = xs[:, :-3 * SHIFT]          # 53 frames: 6 blocks of 8 and 5
    drive = (lambda f: _chunked(f, xs, 5)) if case == "irregular_chunks" \
        else (lambda f: _run(f, xs))
    want = drive(MultiStreamSession(enh, 3, block_frames=8))
    fleet = MultiStreamSession(enh, 3, block_frames=8, wire="samples")
    got = drive(fleet)
    np.testing.assert_array_equal(got, want)
    if case == "one_push":
        np.testing.assert_array_equal(
            got, _run(JFleet(ref, 3, block_frames=8, wire="samples"), xs))
        np.testing.assert_array_equal(got[1],
                                      _solo(enh, xs[1], block_frames=8))


def _tenant_swap(make, xs, new, blk):
    """Two lanes through four blocks, lane 1 reset and fed ``new`` for four
    more: the per-lane streams."""
    fleet = make()
    chunks = [fleet.push_per_lane(xs[:, :4 * blk])]
    fleet.reset_lanes([1])
    with pytest.raises(ValueError, match="diverged"):
        fleet.flush()
    chunks.append(fleet.push_per_lane(
        np.stack([xs[0, 4 * blk: 8 * blk], new[: 4 * blk]])))
    return [np.concatenate([c[i] for c in chunks]) for i in range(2)]


def test_reset_lanes_in_mid_session_with_ragged_emission(setup):
    """A tenant swap on lane 1: both wires, the JAX fleet and solo sessions
    agree.  The fresh lane emits nothing until its own clock passes the
    delay, so the lanes' emissions are ragged."""
    cfg, _, ref, enh = setup
    xs = _lanes(2)
    new = fixtures.noisy_utterance(N, seed=11)
    blk = 4 * SHIFT
    outs = {
        wire: _tenant_swap(lambda: MultiStreamSession(
            enh, 2, block_frames=4, wire=wire), xs, new, blk)
        for wire in ("frames", "samples")}
    jax_out = _tenant_swap(lambda: JFleet(ref, 2, block_frames=4), xs, new,
                           blk)
    for i in range(2):
        np.testing.assert_array_equal(outs["samples"][i], outs["frames"][i])
        np.testing.assert_array_equal(outs["frames"][i], jax_out[i])
    delay = cfg.delay * SHIFT
    assert len(outs["frames"][0]) == 8 * blk - delay
    assert len(outs["frames"][1]) == 8 * blk - 2 * delay
    # lane 0 never noticed; lane 1's second tenant got a fresh session
    sess = StreamingSession(enh, block_frames=4)
    np.testing.assert_array_equal(outs["frames"][0],
                                  sess.push(xs[0, : 8 * blk]))
    sess = StreamingSession(enh, block_frames=4)
    np.testing.assert_array_equal(outs["frames"][1][4 * blk - delay:],
                                  sess.push(new[: 4 * blk]))


@pytest.mark.parametrize("partial_tail", [False, True])
def test_pipelined_ticks_equal_unpipelined_after_drain(setup, partial_tail):
    """``pipeline_ticks``: a push returns the tick before the one it
    started; ``drain`` settles the last, and the whole stream is the
    unpipelined one."""
    _, _, _, enh = setup
    xs = _lanes(2)[:, : N - (3 * SHIFT if partial_tail else 0)]
    want = _run(MultiStreamSession(enh, 2, block_frames=8, wire="samples"),
                xs)
    fleet = MultiStreamSession(enh, 2, block_frames=8, wire="samples",
                               pipeline_ticks=True)
    first = fleet.push(xs)
    plain = MultiStreamSession(enh, 2, block_frames=8, wire="samples")
    assert plain.push(xs).shape[1] - first.shape[1] == 8 * SHIFT
    np.testing.assert_array_equal(
        np.concatenate([first, fleet.flush()], axis=1), want)
    # drain alone hands over the tick in flight, once
    fleet = MultiStreamSession(enh, 2, block_frames=8, wire="samples",
                               pipeline_ticks=True)
    first = fleet.push(xs[:, : 16 * SHIFT])
    owed = fleet.drain()
    assert [len(o) for o in owed] == [8 * SHIFT] * 2
    assert [len(o) for o in fleet.drain()] == [0, 0]
    np.testing.assert_array_equal(
        np.concatenate([first, np.stack(owed)], axis=1),
        want[:, : first.shape[1] + 8 * SHIFT])


@pytest.mark.parametrize("partial_tail", [False, True])
def test_block_adaptive_fleet_equals_solo_sessions(setup, partial_tail):
    """``use_block_adaptive`` with a ring pointer per lane: every lane
    equals a solo block-adaptive session, also when a partial tail goes
    through the exact loop; and the JAX fleet."""
    _, _, ref, enh = setup
    xs = _lanes(3)[:, : N - (3 * SHIFT if partial_tail else 0)]
    kw = dict(block_frames=8, use_block_adaptive=True)
    fleet = MultiStreamSession(enh, 3, **kw)
    got = _run(fleet, xs)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _solo(enh, xs[i], **kw))
    assert np.any(got[0] != _solo(enh, xs[0], block_frames=8))
    if partial_tail:
        np.testing.assert_array_equal(got, _run(JFleet(ref, 3, **kw), xs))
        sess = StreamingSession(enh, **kw)
        sess.push(xs[2])
        sess.flush()
        for name in EngineState._fields:
            assert torch.allclose(
                lane_state(fleet.state, 2)._asdict()[name].double(),
                sess.state._asdict()[name].double(), rtol=1e-12,
                atol=1e-14), name


def test_per_lane_set_adaptation(setup):
    """Toggling one lane off freezes that lane's dictionary alone; the
    other lanes stay identical to an untouched fleet; toggling back on
    resumes.  Pending frames flush under the previous setting."""
    _, _, _, enh = setup
    xs, xs2 = _lanes(3), _lanes(3, seed=20)
    ref = MultiStreamSession(enh, 3, block_frames=4)
    tog = MultiStreamSession(enh, 3, block_frames=4)
    cut = 32 * SHIFT                       # a block boundary
    a = [ref.push_per_lane(xs[:, :cut]), ref.push_per_lane(xs[:, cut:])]
    b = [tog.push_per_lane(xs[:, :cut]),
         tog.set_adaptation(False, lanes=[1]),
         tog.push_per_lane(xs[:, cut:])]
    assert [len(o) for o in b[1]] == [0] * 3           # nothing was pending
    for lane in (0, 2):
        np.testing.assert_array_equal(
            np.concatenate([c[lane] for c in a]),
            np.concatenate([c[lane] for c in b]))
    # two frames into a block of four: they flush first, as pushed
    mid = MultiStreamSession(enh, 3, block_frames=4)
    c = [mid.push_per_lane(xs[:, :cut - 2 * SHIFT]),
         mid.set_adaptation(False, lanes=[1])]
    assert [len(o) for o in c[1]] == [2 * SHIFT] * 3
    got0 = np.concatenate([p[0] for p in c])
    np.testing.assert_array_equal(got0, a[0][0][: len(got0)])
    assert tog.state.adapt_on.tolist() == [True, False, True]
    frozen = tog.state.b_d_head[1].clone()
    out_ref, out_tog = ref.push(xs2), tog.push(xs2)
    assert torch.equal(tog.state.b_d_head[1], frozen)
    assert not torch.equal(ref.state.b_d_head[1], frozen)
    for lane in (0, 2):
        np.testing.assert_array_equal(out_tog[lane], out_ref[lane])
        assert torch.equal(tog.state.b_d_head[lane],
                           ref.state.b_d_head[lane])
    tog.set_adaptation(True)                # the whole fleet
    assert tog.state.adapt_on.tolist() == [True] * 3
    tog.push(xs)
    assert not torch.equal(tog.state.b_d_head[1], frozen)


def test_set_adaptation_mid_block_defers_on_a_block_adaptive_fleet(setup):
    """A mid-block ``set_adaptation`` on a block-adaptive fleet waits for
    the block boundary, several calls in order: outputs and states equal
    the same calls made at the boundary."""
    _, _, _, enh = setup
    xs = _lanes(2)

    def run(cut):
        fleet = MultiStreamSession(enh, 2, block_frames=8,
                                   use_block_adaptive=True)
        out = [fleet.push(xs[:, :cut]),
               np.stack(fleet.set_adaptation(False)),
               np.stack(fleet.set_adaptation(True, lanes=[0])),
               fleet.push(xs[:, cut:]), fleet.flush()]
        return np.concatenate(out, axis=1), fleet.state

    out_a, st_a = run(SHIFT * 19)           # three hops into block three
    out_b, st_b = run(SHIFT * 24)           # at its end
    np.testing.assert_array_equal(out_a, out_b)
    for name in EngineState._fields:
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name
    assert st_a.adapt_on.tolist() == [True, False]
    on = MultiStreamSession(enh, 2, block_frames=8, use_block_adaptive=True)
    assert np.any(out_a[1] != _run(on, xs)[1])


@pytest.mark.parametrize("wire", ["frames", "samples"])
def test_zero_queue_rows_reproduces_a_solo_flush(setup, wire):
    """One lane ends its stream while the other carries on: zeroing its
    queue row before each drain tick and feeding it zero hops gives the solo
    session's ``flush`` on that lane, in mid-block too."""
    cfg, _, _, enh = setup
    xs = _lanes(2)
    n0 = 21 * SHIFT                          # lane 0 ends in mid-block
    fleet = MultiStreamSession(enh, 2, block_frames=4, wire=wire)
    chunks = [fleet.push_per_lane(xs[:, :n0])]
    for t in range(cfg.delay + 1):
        fleet.zero_queue_rows([0])
        hop = np.stack([np.zeros(SHIFT),
                        xs[1, n0 + t * SHIFT: n0 + (t + 1) * SHIFT]])
        chunks.append(fleet.push_per_lane(hop))
    tail = n0 + (cfg.delay + 1) * SHIFT
    more = (-tail // SHIFT) % 4 * SHIFT      # up to the block boundary
    chunks.append(fleet.push_per_lane(
        np.stack([np.zeros(more), xs[1, tail: tail + more]])))
    got0 = np.concatenate([c[0] for c in chunks])
    want0 = _solo(enh, xs[0, :n0], block_frames=4)
    np.testing.assert_array_equal(got0[: len(want0)], want0)
    sess = StreamingSession(enh, block_frames=4)
    np.testing.assert_array_equal(
        np.concatenate([c[1] for c in chunks]),
        sess.push(xs[1, : tail + more]))


@pytest.mark.parametrize("wire", ["frames", "samples"])
def test_quantize_false_returns_float64(setup, wire):
    """Float outputs are float64 on both wires and from a float32 fleet; on
    the frames wire they agree with the JAX fleet's within 1e-9."""
    cfg, bases, ref, enh = setup
    xs = _lanes(2)[:, :3200]
    fleet = MultiStreamSession(enh, 2, block_frames=4, wire=wire)
    got = np.concatenate([fleet.push(xs, quantize=False),
                          fleet.flush(quantize=False)], axis=1)
    assert got.dtype == np.float64
    if wire == "frames":
        jf = JFleet(ref, 2, block_frames=4)
        want = np.concatenate([jf.push(xs, quantize=False),
                               jf.flush(quantize=False)], axis=1)
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    enh32 = SnmfEnhancer(config_from_jax(cfg), *bases, device="cpu",
                         matlab_ad_blk_init=False)
    f32 = MultiStreamSession(enh32, 2, block_frames=4, wire=wire)
    parts = [f32.push(xs, quantize=False),
             np.stack(f32.set_adaptation(False, quantize=False)),
             np.stack(f32.drain(quantize=False)),
             f32.flush(quantize=False)]
    assert all(p.dtype == np.float64 for p in parts)


def test_float32_fleet_lane_equals_float32_solo_session(setup):
    """The overlap-add order is the solo session's on both wires: in
    float32 on one device a fleet of one lane gives the session's bits."""
    cfg, bases, _, _ = setup
    enh32 = SnmfEnhancer(config_from_jax(cfg), *bases, device="cpu",
                         matlab_ad_blk_init=False)
    x = _lanes(1)
    sess = StreamingSession(enh32, block_frames=8)
    want = np.concatenate([sess.push(x[0], quantize=False),
                           sess.flush(quantize=False)])
    fleet = MultiStreamSession(enh32, 1, block_frames=8)
    got = np.concatenate([fleet.push(x, quantize=False),
                          fleet.flush(quantize=False)], axis=1)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(
        _run(MultiStreamSession(enh32, 1, block_frames=8, wire="samples"),
             x)[0], _solo(enh32, x[0], block_frames=8))


# ---------------------------------------------------------------------------
# ShardedFleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(wire="samples", pipeline_ticks=True),
    dict(use_block_adaptive=True)], ids=["samples_pipelined",
                                         "block_adaptive"])
def test_sharded_fleet_equals_one_fleet(setup, kw):
    _, _, _, enh = setup
    xs = _lanes(4)
    one = {k: v for k, v in kw.items() if k != "pipeline_ticks"}
    want = _run(MultiStreamSession(enh, 4, block_frames=8, **one), xs)
    fleet = ShardedFleet(enh, 4, sub_fleets=2, block_frames=8, **kw)
    assert fleet._block == 8 and fleet.n == 4 and fleet.enh is enh
    np.testing.assert_array_equal(_run(fleet, xs), want)


def test_sharded_fleet_routes_the_lane_lifecycle_globally(setup):
    """``reset_lanes``, ``zero_queue_rows`` and ``set_adaptation`` with
    global lane indices land on the right shard: the outputs equal the
    unsharded fleet's through the same lifecycle."""
    _, _, _, enh = setup
    xs = _lanes(4, length=9600)
    blk = 4 * SHIFT
    outs = []
    for make in (lambda: MultiStreamSession(enh, 4, block_frames=4,
                                            wire="samples"),
                 lambda: ShardedFleet(enh, 4, sub_fleets=2, block_frames=4,
                                      wire="samples")):
        fleet = make()
        chunks = [fleet.push_per_lane(xs[:, :4 * blk]),
                  fleet.set_adaptation(False, lanes=[1, 3])]
        fleet.reset_lanes([2])               # shard 1, local lane 0
        assert fleet._l.tolist() == [16, 16, 0, 16]
        fleet.zero_queue_rows([3])
        chunks.append(fleet.push_per_lane(xs[:, 4 * blk: 8 * blk]))
        assert not len(fleet._pending)
        chunks.append(fleet.drain())
        outs.append([np.concatenate([c[i] for c in chunks])
                     for i in range(4)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert len(outs[0][2]) < len(outs[0][0])      # ragged after the reset


# ---------------------------------------------------------------------------
# The error cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,exc", [
    (dict(block_frames=8, pipeline_ticks=True), ValueError),
    (dict(wire="packets"), ValueError),
    (dict(wire="samples", block_frames=8, use_block_adaptive=True),
     ValueError),
    (dict(mesh=object()), NotImplementedError),
])
def test_constructor_refusals(setup, kw, exc):
    with pytest.raises(exc):
        MultiStreamSession(setup[3], 2, **kw)
    with pytest.raises(exc):
        ShardedFleet(setup[3], 2, sub_fleets=2, **kw)


def test_push_shape_check(setup):
    for fleet in (MultiStreamSession(setup[3], 2),
                  ShardedFleet(setup[3], 2, sub_fleets=2)):
        for bad in (np.zeros(100), np.zeros((3, 100))):
            with pytest.raises(ValueError, match="expects"):
                fleet.push(bad)


def test_sharded_fleet_validates_divisibility_and_range(setup):
    with pytest.raises(ValueError):
        ShardedFleet(setup[3], 5, sub_fleets=2)
    fleet = ShardedFleet(setup[3], 4, sub_fleets=2)
    with pytest.raises(ValueError):
        fleet.reset_lanes([4])


@pytest.mark.parametrize("make,n,lane", [
    (lambda enh: MultiStreamSession(enh, 2), 2, 0),
    (lambda enh: ShardedFleet(enh, 4, sub_fleets=2), 4, 0),
    # the clocks differ only between the shards: no shard sees it alone
    (lambda enh: ShardedFleet(enh, 2, sub_fleets=2), 2, 1),
], ids=["fleet", "sharded", "sharded_between_shards"])
def test_push_with_diverged_clocks_raises_before_mutation(setup, make, n,
                                                          lane):
    """The divergence check comes first, in ``push`` and in ``flush``: the
    raising call consumes nothing on any lane (on no shard of a sharded
    fleet either), so ``push_per_lane`` afterwards gives what it would have
    given."""
    enh = setup[3]
    hops = np.round(np.random.default_rng(3).standard_normal((n, SHIFT))
                    * 1000.0)
    fleet, want = make(enh), make(enh)
    for f in (fleet, want):
        f.push(hops)
        f.reset_lanes([lane])                # the lanes' clocks now differ
    clocks = [1] * n
    clocks[lane] = 0
    for call in (lambda: fleet.push(hops), fleet.flush):
        with pytest.raises(ValueError, match="diverged"):
            call()
        assert fleet._l.tolist() == clocks and not fleet._pending
    for g, r in zip(fleet.push_per_lane(hops), want.push_per_lane(hops)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["hold", "pending", "in_flight"])
def test_reset_lanes_refusals(setup, case):
    enh = setup[3]
    x = _lanes(2)
    if case == "hold":
        fleet = MultiStreamSession(enh, 2)
        fleet.push(x[:, : SHIFT + 3])        # leaves three samples held
    elif case == "pending":
        fleet = MultiStreamSession(enh, 2, block_frames=4)
        fleet.push(x[:, : 2 * SHIFT])        # half a block
    else:
        fleet = MultiStreamSession(enh, 2, block_frames=4, wire="samples",
                                   pipeline_ticks=True)
        fleet.push(x[:, : 4 * SHIFT])        # one tick, still in flight
    with pytest.raises(RuntimeError, match=case.replace("_", " ")):
        fleet.reset_lanes([0])
    if case == "in_flight":
        fleet.drain()
        fleet.reset_lanes([0])
        assert fleet._l.tolist() == [0, 4]
