"""Port parity of the hop-by-hop session: ``StreamingSession`` of
``se_snmf_nat_tpu_torch.stream.streaming`` against the JAX package's session
and against the port's own offline plans, at narrow widths (r_x = r_d = 8,
r_a = 4, m_a = 10, 6 trips) on seeded synthetic utterances, in float64: the
int16 streams are identical."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu.stream.streaming import StreamingSession as JSession
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import config_from_jax, state_to_numpy
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

torch.set_num_threads(1)
N = 8320          # 52 hops + 4 flush frames = 56 frames = 7 blocks of 8


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
    x = fixtures.noisy_utterance(N, seed=3)
    return cfg, bases, ref, _port(cfg, bases), x


def _stream(sess, x, chunk=160):
    parts = [sess.push(x[i: i + chunk]) for i in range(0, len(x), chunk)]
    parts.append(sess.flush())
    return np.concatenate([p for p in parts if len(p)])


def test_hop_by_hop_identical_to_offline_and_to_jax(setup):
    cfg, _, ref, enh, x = setup
    want = enh.enhance(x)
    sess = StreamingSession(enh)
    got = _stream(sess, x, cfg.signal.frameshift)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _stream(JSession(ref), x))
    # the refits moved the dictionary, and the state stayed a device tensor
    head0 = enh.initial_state().b_d_head
    assert (sess.state.b_d_head - head0).abs().max() > 1e-3
    assert sess.state.b_d_head.device == head0.device


def test_pushes_emit_after_the_delay(setup):
    cfg, _, _, enh, x = setup
    shift = cfg.signal.frameshift
    sess = StreamingSession(enh)
    sizes = [len(sess.push(x[i * shift: (i + 1) * shift]))
             for i in range(cfg.delay + 2)]
    assert sizes == [0] * cfg.delay + [shift, shift]


def test_irregular_chunks(setup):
    """Chunk sizes of 1..700 samples give the same stream as one push."""
    _, _, _, enh, x = setup
    want = enh.enhance(x)
    sess = StreamingSession(enh)
    rng = np.random.default_rng(1)
    parts, i = [], 0
    while i < len(x):
        n = int(rng.integers(1, 700))
        parts.append(sess.push(x[i: i + n]))
        i += n
    parts.append(sess.flush())
    np.testing.assert_array_equal(
        np.concatenate([p for p in parts if len(p)]), want)


def test_state_continues(setup):
    """A session seeded with a previous utterance's state equals the
    chained offline call, here and in the reference."""
    _, _, ref, enh, x = setup
    _, st = enh.enhance(x, return_state=True)
    want = enh.enhance(x, state=st)
    sess = StreamingSession(enh, state=st)
    got = np.concatenate([sess.push(x), sess.flush()])
    np.testing.assert_array_equal(got, want)
    _, st_ref = ref.enhance(x, return_state=True)
    np.testing.assert_array_equal(got, ref.enhance(x, state=st_ref))
    assert np.any(got != enh.enhance(x))


def test_block_frames_8_identical(setup):
    _, _, _, enh, x = setup
    sess = StreamingSession(enh, block_frames=8)
    got = np.concatenate([sess.push(x), sess.flush()])
    np.testing.assert_array_equal(got, enh.enhance(x))
    # a partial tail block (5 frames) drains at flush
    sess = StreamingSession(enh, block_frames=8)
    got = np.concatenate([sess.push(x[:-480]), sess.flush()])
    np.testing.assert_array_equal(got, enh.enhance(x[:-480]))


def test_block_adaptive_session_equals_offline_block_plan(setup):
    """``use_block_adaptive`` reproduces the offline block-adaptive plan
    (the same plan behind another driver) and the reference's session."""
    cfg, bases, ref, enh, x = setup
    want = _port(cfg, bases, block_adapt=8).enhance(x)
    sess = StreamingSession(enh, block_frames=8, use_block_adaptive=True)
    got = np.concatenate([sess.push(x), sess.flush()])
    np.testing.assert_array_equal(got, want)
    assert np.any(got != enh.enhance(x))       # not the exact plan
    jsess = JSession(ref, block_frames=8, use_block_adaptive=True)
    np.testing.assert_array_equal(
        got, np.concatenate([jsess.push(x), jsess.flush()]))


def test_block_adaptive_session_partial_tail(setup):
    """A tail of fewer than ``block_frames`` frames goes through the exact
    loop on the rings in shift layout, as in the reference's session."""
    _, _, ref, enh, x = setup
    x = x[:-480]                                # 53 frames: 6 blocks + 5
    sess = StreamingSession(enh, block_frames=8, use_block_adaptive=True)
    got = np.concatenate([sess.push(x), sess.flush()])
    jsess = JSession(ref, block_frames=8, use_block_adaptive=True)
    np.testing.assert_array_equal(
        got, np.concatenate([jsess.push(x), jsess.flush()]))
    st, st_ref = state_to_numpy(sess.state), jsess.state
    for name in st._fields:
        np.testing.assert_allclose(
            getattr(st, name).astype(float),
            np.asarray(getattr(st_ref, name)).astype(float), rtol=1e-9,
            atol=1e-12, err_msg=name)


def test_sessions_share_one_block_step_with_the_iteration_cap_only(setup):
    """An enhancer builds one session step a K (``block_step``) that its
    block-adaptive sessions and fleets all run, taking ``block_iter_cap``
    without the offline plan's refit cap and fixed trips, as the
    reference's sessions do; sessions pushed in turn on it keep their own
    streams."""
    cfg, bases, _, _, x = setup
    enh = _port(cfg, bases, block_adapt=8, block_iter_cap=4,
                block_refit_cap=2, block_fixed_iter=True)
    kw = dict(block_frames=8, use_block_adaptive=True)
    a, b = StreamingSession(enh, **kw), StreamingSession(enh, **kw)
    fleet = MultiStreamSession(enh, 2, **kw)
    assert a._ba_step is b._ba_step is fleet._ba_step is enh.block_step(8)
    assert enh.block_step(16) is not enh.block_step(8)
    step, offline = enh.block_step(8), enh.run.step
    assert (step.h_iters, step.w_iters, step.h_eps) == (
        4, 4, cfg.nmf.conv_eps)
    assert (offline.h_iters, offline.w_iters, offline.h_eps) == (4, 2, 0.0)
    x2 = np.ascontiguousarray(x[::-1])
    pa, pb = [], []
    for i in range(0, len(x), 1280):
        pa.append(a.push(x[i: i + 1280]))
        pb.append(b.push(x2[i: i + 1280]))
    for sess, parts, sig in ((a, pa, x), (b, pb, x2)):
        alone = StreamingSession(_port(cfg, bases, block_adapt=8,
                                       block_iter_cap=4), **kw)
        np.testing.assert_array_equal(
            np.concatenate(parts + [sess.flush()]),
            np.concatenate([alone.push(sig), alone.flush()]))


def test_dft_matmul_propagates_to_streaming(setup):
    """An enhancer built with ``dft_matmul=True`` streams through the same
    matrix-product transform it uses offline (values agree to rounding: a
    block's product is tiled differently from the whole utterance's)."""
    cfg, bases, _, enh, x = setup
    enh_dm = _port(cfg, bases, dft_matmul=True)
    assert enh_dm.cs is not None and enh.cs is None
    sess = StreamingSession(enh_dm, block_frames=8)
    want = enh_dm.enhance(x, quantize=False)
    got = np.concatenate([sess.push(x, quantize=False),
                          sess.flush(quantize=False)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_adaptation_toggle_off_equals_config_off(setup):
    """A session with ``set_adaptation(False)`` from the start gives the
    output of a plan built with adaptation off in the config, and leaves the
    dictionary head as it was."""
    cfg, bases, _, enh, x = setup
    cfg_off = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    enh_off = _port(cfg_off, bases)
    assert enh_off.fast_run is not None
    sess = StreamingSession(enh, block_frames=4)
    assert len(sess.set_adaptation(False)) == 0
    got = np.concatenate([sess.push(x), sess.flush()])
    assert torch.equal(sess.state.b_d_head, enh.initial_state().b_d_head)
    # the config-off enhancer's exact loop (a returned state selects it)
    want, _ = enh_off.enhance(x, return_state=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, enh_off.enhance(x))   # its fast plan


def test_adaptation_toggle_mid_stream(setup):
    """Toggling off mid-stream freezes the dictionary and toggling back on
    resumes the adaptation; the stream differs from the always-on one only
    after the first toggle, here as in the reference's session."""
    cfg, _, ref, enh, x = setup
    x = np.concatenate([x, fixtures.noisy_utterance(N, seed=4)])
    third = len(x) // 3 // 160 * 160

    def toggled(make):
        sess = make()
        out = [sess.push(x[:third]), sess.set_adaptation(False)]
        head1 = np.asarray(state_to_numpy(sess.state).b_d_head) \
            if make is port else None
        out.append(sess.push(x[third: 2 * third]))
        head2 = np.asarray(state_to_numpy(sess.state).b_d_head) \
            if make is port else None
        out.append(sess.set_adaptation(True))
        out.append(sess.push(x[2 * third:]))
        out.append(sess.flush())
        return np.concatenate([p for p in out if len(p)]), head1, head2, sess

    def port():
        return StreamingSession(enh, block_frames=4)

    got, head1, head2, sess = toggled(port)
    np.testing.assert_array_equal(head1, head2)       # untouched while off
    assert not np.array_equal(state_to_numpy(sess.state).b_d_head, head2)
    want_on = _stream(StreamingSession(enh, block_frames=4), x, len(x))
    assert got.shape == want_on.shape and not np.array_equal(got, want_on)
    n_pre = third - (cfg.delay + 4) * cfg.signal.frameshift
    np.testing.assert_array_equal(got[:n_pre], want_on[:n_pre])
    ref_got, *_ = toggled(lambda: JSession(ref, block_frames=4))
    np.testing.assert_array_equal(got, ref_got)


def test_adaptation_toggle_mid_block_defers_to_boundary(setup):
    """A mid-block ``set_adaptation`` on a block-adaptive session waits for
    the block boundary: it equals the call made at the boundary, in output
    and in every state field."""
    cfg, _, _, enh, x = setup
    shift, blk = cfg.signal.frameshift, 8

    def run(cut):
        sess = StreamingSession(enh, block_frames=blk,
                                use_block_adaptive=True)
        out = [sess.push(x[:cut]), sess.set_adaptation(False),
               sess.push(x[cut:]), sess.flush()]
        return np.concatenate(out), sess.state

    out_a, st_a = run(shift * (2 * blk + 3))      # 3 hops into block three
    out_b, st_b = run(shift * (3 * blk))          # at its end
    np.testing.assert_array_equal(out_a, out_b)
    for name in st_a._fields:
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name
    on, _ = StreamingSession(enh, block_frames=blk,
                             use_block_adaptive=True), None
    assert np.any(out_a != np.concatenate([on.push(x), on.flush()]))


@pytest.mark.parametrize("block_adaptive", [False, True])
def test_warmed_then_reset_equals_fresh(setup, block_adaptive):
    _, _, _, enh, x = setup
    kw = dict(block_frames=8, use_block_adaptive=block_adaptive)
    fresh = StreamingSession(enh, **kw)
    want = np.concatenate([fresh.push(x), fresh.flush()])
    sess = StreamingSession(enh, **kw)
    sess.push(x[:5000])
    sess.set_adaptation(False)
    sess.reset()
    got = np.concatenate([sess.push(x), sess.flush()])
    np.testing.assert_array_equal(got, want)
    # reset onto a carried state
    _, st = enh.enhance(x, return_state=True)
    sess.reset(st)
    seeded = StreamingSession(enh, state=st, **kw)
    np.testing.assert_array_equal(
        np.concatenate([sess.push(x), sess.flush()]),
        np.concatenate([seeded.push(x), seeded.flush()]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quantize_false_returns_float64(setup, dtype):
    """``push``, ``flush`` and ``set_adaptation`` return float64 with
    ``quantize=False`` whatever the session's dtype (the reference's host
    accumulator is float64), and the values are the ones the int16 stream
    quantises."""
    cfg, bases, _, _, x = setup
    enh = SnmfEnhancer(config_from_jax(cfg), *bases, device="cpu",
                       dtype=dtype, matlab_ad_blk_init=False)
    x = x[:3200]
    sess = StreamingSession(enh, block_frames=4)
    parts = [sess.push(x[:1000], quantize=False),
             sess.set_adaptation(False, quantize=False),
             sess.push(x[1000:], quantize=False),
             sess.flush(quantize=False)]
    assert all(p.dtype == np.float64 for p in parts)
    assert len(parts[1])                   # the toggle flushed pending frames
    sess.reset()
    ints = [sess.push(x[:1000]), sess.set_adaptation(False),
            sess.push(x[1000:]), sess.flush()]
    from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
    np.testing.assert_array_equal(
        enhanced_quantize(np.concatenate(parts)), np.concatenate(ints))
    if dtype == torch.float32:
        # the float32 overlap-add stays: the values are float32 numbers
        y = np.concatenate(parts)
        np.testing.assert_array_equal(y, y.astype(np.float32))
