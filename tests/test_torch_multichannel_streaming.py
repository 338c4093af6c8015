"""The port's streaming multichannel path (``multichannel/streaming.py``)
on the CPU: the counterpart of each case of the reference package's
tests/test_multichannel_streaming.py, and the cases against the reference
itself — the step, the per-frame plan and its state in x64 within 1e-9
with identical int16; a reference stream's state carried into the port
(and back) continuing the stream; online NTF against the reference's.
The per-frame and whole-utterance plans give the same bits, and a lane
gives the bits of its own single-lane run, in float64 and float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu import multichannel as J
from se_snmf_nat_tpu.config import default_config as j_default_config
from se_snmf_nat_tpu.utils.matlab_compat import matlab_int16_write
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.convert import (
    pmwf_state_from_jax, pmwf_state_to_numpy)
from se_snmf_nat_tpu_torch.multichannel import (
    NtfStreamingSession, PmwfEnhancer, PmwfParams, PmwfStreamingSession,
    make_pmwf_batch_run, make_pmwf_batch_run_fast, make_pmwf_stream_step,
    make_pmwf_streaming_run, make_pmwf_streaming_run_fast, ntf_solve,
    pmwf_stream_init, pmwf_streaming_enhance, window_cov)
from se_snmf_nat_tpu_torch.multichannel.fixture import (
    segsnr_vs_source, synth_mixture)
from se_snmf_nat_tpu_torch.multichannel.ntf import default_c_init
from se_snmf_nat_tpu_torch.multichannel.pmwf import frames_of
from se_snmf_nat_tpu_torch.multichannel.streaming import batch_stream_state

torch.set_num_threads(1)
C = 4
CPU64 = dict(dtype=torch.float64, device="cpu")


def _rel(got, want):
    """Max error relative to the largest reference value (0 for two
    all-zero arrays)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    return err / float(np.max(np.abs(want))) if err else 0.0


@pytest.fixture(scope="module")
def mix():
    return synth_mixture(n=12000, n_ch=C)


@pytest.fixture(scope="module")
def cfg():
    return default_config()


def _init(n_ch=C, cdtype=torch.complex128, params=None):
    return pmwf_stream_init(params or PmwfParams(), n_ch, 513, cdtype, "cpu")


def _offline(x, dtype=torch.float64):
    return pmwf_streaming_enhance(x, dtype=dtype, device="cpu")


@pytest.mark.parametrize("block_frames", [1, 4, 8])
def test_session_bit_identical_to_offline(mix, block_frames):
    x = mix[0]
    want = _offline(x)
    sess = PmwfStreamingSession(n_ch=C, block_frames=block_frames, **CPU64)
    assert sess.block_frames == block_frames
    got = np.concatenate([sess.push(x), sess.flush()], axis=1)
    np.testing.assert_array_equal(got, want)


def test_float32_session_bit_identical_to_offline(mix):
    """In float32 too: the session adds a hop's frames in the one-shot
    overlap-add's order and dtype."""
    x = mix[0][:, :9600]
    want = pmwf_streaming_enhance(x, quantize=False, device="cpu")
    sess = PmwfStreamingSession(n_ch=C, block_frames=8, device="cpu")
    got = np.concatenate([sess.push(x[:, i: i + 1000], quantize=False)
                          for i in range(0, x.shape[1], 1000)]
                         + [sess.flush(quantize=False)], axis=1)
    assert got.dtype == np.float64 and want.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float64))


def test_session_irregular_chunks(mix):
    """Mic-style irregular chunk sizes give the same stream."""
    x = mix[0][:, :9600]
    want = _offline(x)
    sess = PmwfStreamingSession(n_ch=C, block_frames=4, **CPU64)
    rng = np.random.default_rng(1)
    parts, i = [], 0
    while i < x.shape[1]:
        n = int(rng.integers(1, 900))
        parts.append(sess.push(x[:, i: i + n]))
        i += n
    parts.append(sess.flush())
    got = np.concatenate([p for p in parts if p.shape[1]], axis=1)
    np.testing.assert_array_equal(got, want)


def test_session_reset_and_carried_state(mix, cfg):
    """``reset(state)`` continues a stream from another run's state: past
    the overlap-add seam (the frames before the split are not re-added),
    the samples equal the uninterrupted stream's."""
    x = mix[0][:, :9600]
    k = 24                                        # hops before the split
    sess = PmwfStreamingSession(n_ch=C, block_frames=8, **CPU64)
    full = np.concatenate([sess.push(x), sess.flush()], axis=1)
    run = make_pmwf_streaming_run(cfg, PmwfParams(), **CPU64)
    _, st = run(frames_of(x, cfg)[:, :k], _init())
    sess.reset(st)
    sess._framer.queue = np.concatenate(           # the split's queue
        [np.zeros((C, 480)), x[:, : k * 160]], axis=1)[:, -640:]
    sess._framer.l[:] = k
    tail = np.concatenate([sess.push(x[:, k * 160:]), sess.flush()], axis=1)
    start, seam = (k - cfg.delay) * 160, 640 - 160
    assert tail.shape[1] == full.shape[1] - start
    np.testing.assert_array_equal(tail[:, seam:], full[:, start + seam:])


def test_state_carry_continues_stream(mix, cfg):
    x = mix[0]
    _, st_full = pmwf_streaming_enhance(x, return_state=True, **CPU64)
    run = make_pmwf_streaming_run(cfg, PmwfParams(), **CPU64)
    fr = frames_of(x, cfg)
    _, st_a = run(fr[:, :40], _init())
    _, st_b = run(fr[:, 40:], st_a)
    assert int(st_b.l) == fr.shape[1]
    for a, b in zip(st_b, st_full):
        assert torch.equal(a, b)


def test_ncov_freezes_after_init(cfg):
    """Reference W-flag semantics: Ncov tracks Ycov through init_n_len
    frames then never changes (NTF_sep_event_RT.m:91-96)."""
    x = synth_mixture(n=16000, n_ch=C)[0]
    p = PmwfParams()
    run = make_pmwf_streaming_run(cfg, p, **CPU64)
    fr = frames_of(x, cfg)
    _, st_init = run(fr[:, : p.init_n_len], _init())
    assert torch.equal(st_init.ncov, st_init.ycov)
    _, st_late = run(fr[:, p.init_n_len:], st_init)
    assert torch.equal(st_late.ncov, st_init.ncov)
    assert not torch.equal(st_late.ycov, st_init.ncov)


def _rand_frames(seed, n, f=9, c=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((c, f)) + 1j * rng.standard_normal((c, f))
            for _ in range(n)]


def test_window_cov_matches_reference():
    rng = np.random.default_rng(2)
    y_win = rng.standard_normal((3, 11, 5)) \
        + 1j * rng.standard_normal((3, 11, 5))
    got = window_cov(torch.as_tensor(y_win), 2)
    want = J.window_cov(jnp.asarray(y_win), 2)
    assert got.shape == (11, 3, 3)
    assert _rel(got, want) <= 1e-12


def test_periodic_normalize_quirk():
    """The running Ycov divides IN PLACE by (norm_period-1) every
    norm_period frames (PMWF_sep_event_RT_CHiME.m:137-140)."""
    p = PmwfParams(norm_period=4, init_n_len=2)
    step = make_pmwf_stream_step(p)
    st = pmwf_stream_init(p, 2, 9, torch.complex128, "cpu")
    acc = np.zeros((9, 2, 2), complex)
    win = np.zeros((2, 9, 2 * p.l_nbr + 1), complex)
    for l, y in enumerate(_rand_frames(0, 8), start=1):
        st, _ = step(st, torch.as_tensor(y))
        win = np.concatenate([win[:, :, 1:], y[:, :, None]], axis=2)
        acc = acc + window_cov(torch.as_tensor(win), p.m_nbr).numpy()
        if l % p.norm_period == 0:
            acc = acc / (p.norm_period - 1)
        np.testing.assert_allclose(st.ycov.numpy(), acc, rtol=1e-9)


def test_step_matches_reference_x64():
    """The step against the reference's over a stream that crosses the init
    freeze (frame 5) and two periodic divides (frames 4 and 8)."""
    p = PmwfParams(norm_period=4, init_n_len=5)
    j_p = J.PmwfParams(norm_period=4, init_n_len=5)
    step, j_step = make_pmwf_stream_step(p), J.make_pmwf_stream_step(j_p)
    st = pmwf_stream_init(p, 3, 9, torch.complex128, "cpu")
    j_st = J.pmwf_stream_init(j_p, 3, 9, jnp.complex128)
    for y in _rand_frames(1, 10, c=3):
        st, d = step(st, torch.as_tensor(y))
        j_st, j_d = j_step(j_st, jnp.asarray(y))
        assert _rel(d, j_d) <= 1e-9
        for f in ("y_win", "ycov", "ncov"):
            assert _rel(getattr(st, f), getattr(j_st, f)) <= 1e-9, f
        assert int(st.l) == int(j_st.l)


def test_streaming_run_matches_reference_x64(mix, cfg):
    x = mix[0]
    want, j_st = J.pmwf_streaming_enhance(x, dtype=jnp.float64,
                                          quantize=False, return_state=True)
    got, st = pmwf_streaming_enhance(x, quantize=False, return_state=True,
                                     **CPU64)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-9
    np.testing.assert_array_equal(matlab_int16_write(got),
                                  matlab_int16_write(want))
    for f in ("y_win", "ycov", "ncov"):
        assert _rel(getattr(st, f), getattr(j_st, f)) <= 1e-9, f
    assert int(st.l) == int(j_st.l)


@pytest.mark.parametrize("fast", [False, True], ids=["per_frame", "whole"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batch_run_lanes_equal_single_lanes(cfg, fast, dtype):
    """Lanes of a batch give the bits of their own single-lane runs."""
    frames = np.stack([frames_of(synth_mixture(n=8000, n_ch=C, seed=s)[0],
                                 cfg) for s in range(3)])
    p = PmwfParams()
    st0 = _init(cdtype=torch.complex128 if dtype == torch.float64
                else torch.complex64)
    batch = (make_pmwf_batch_run_fast if fast else make_pmwf_batch_run)(
        cfg, p, dtype, "cpu")
    single = (make_pmwf_streaming_run_fast if fast
              else make_pmwf_streaming_run)(cfg, p, dtype, "cpu")
    ys, sts = batch(frames, batch_stream_state(st0, 3))
    for i in range(3):
        y, st = single(frames[i], st0)
        assert torch.equal(ys[i], y)
        for a, b in zip(sts, st):
            assert torch.equal(a[i], b)


def test_whole_utterance_plan_equals_per_frame_plan(cfg):
    """The same bits and the same carried state, across the init freeze
    and the periodic divides inside the call (float64 int16 identical, as
    the reference gates it, and here bit for bit)."""
    x = synth_mixture(n=16000, n_ch=C)[0]
    fr = frames_of(x, cfg)
    p = PmwfParams()
    y_w, st_w = make_pmwf_streaming_run(cfg, p, **CPU64)(fr, _init())
    y_g, st_g = make_pmwf_streaming_run_fast(cfg, p, **CPU64)(fr, _init())
    np.testing.assert_array_equal(matlab_int16_write(y_g.numpy()),
                                  matlab_int16_write(y_w.numpy()))
    assert torch.equal(y_g, y_w)
    for a, b in zip(st_g, st_w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [7, 40])
def test_whole_utterance_plan_state_carry_chunks(mix, cfg, k):
    """Two chunked calls == one whole call (y_win tail, Ycov, the frozen
    Ncov continuing across the call boundary; k=7 splits inside the init
    period)."""
    fr = frames_of(mix[0], cfg)
    fast = make_pmwf_streaming_run_fast(cfg, PmwfParams(), **CPU64)
    y_full, st_full = fast(fr, _init())
    y_a, st_a = fast(fr[:, :k], _init())
    y_b, st_b = fast(fr[:, k:], st_a)
    for a, b in zip(st_b, st_full):
        assert torch.equal(a, b)
    # the chunks' frames are the whole call's, up to the OLA seam
    n_a = k * 160
    assert torch.equal(y_a[:, :n_a - 480], y_full[:, :n_a - 480])


def test_whole_utterance_plan_f32_finite_and_close(cfg):
    x = synth_mixture(n=16000, n_ch=C)[0]
    fr = frames_of(x, cfg)
    p = PmwfParams()
    st0 = _init(cdtype=torch.complex64)
    y_w, _ = make_pmwf_streaming_run(cfg, p, device="cpu")(fr, st0)
    y_g, _ = make_pmwf_streaming_run_fast(cfg, p, device="cpu")(fr, st0)
    y64, _ = make_pmwf_streaming_run(cfg, p, **CPU64)(fr, _init())
    assert torch.isfinite(y_g).all()
    c = np.corrcoef(y64.numpy().ravel(), y_g.numpy().ravel())[0, 1]
    assert c > 0.9999, c
    assert torch.equal(y_g, y_w)


def test_streaming_enhance_fast_flag(mix):
    x = mix[0][:, :9600]
    np.testing.assert_array_equal(
        pmwf_streaming_enhance(x, fast=True, **CPU64), _offline(x))


def test_reference_state_continues_in_the_port_and_back(mix, cfg):
    """A reference stream's state after 40 frames, carried into the port by
    ``pmwf_state_from_jax``, continues the stream as the reference does;
    the port's state carried back continues it in the reference."""
    x = mix[0]
    fr = frames_of(x, cfg)
    j_cfg = j_default_config()
    j_run = J.make_pmwf_streaming_run(j_cfg, J.PmwfParams(), jnp.float64)
    j_st0 = J.pmwf_stream_init(J.PmwfParams(), C, 513, jnp.complex128)
    _, j_a = j_run(jnp.asarray(fr[:, :40]), j_st0)
    j_y, j_b = j_run(jnp.asarray(fr[:, 40:]), j_a)
    run = make_pmwf_streaming_run(cfg, PmwfParams(), **CPU64)
    st_a = pmwf_state_from_jax(
        J.PmwfStreamState(*(np.asarray(f) for f in j_a)), device="cpu",
        dtype=torch.float64)
    assert st_a.y_win.dtype == torch.complex128 and int(st_a.l) == 40
    y, st_b = run(fr[:, 40:], st_a)
    assert _rel(y, j_y) <= 1e-9
    np.testing.assert_array_equal(matlab_int16_write(y.numpy()),
                                  matlab_int16_write(np.asarray(j_y)))
    assert _rel(st_b.ycov, j_b.ycov) <= 1e-9
    # and back: the port's state after 40 frames into the reference
    _, p_a = run(fr[:, :40], _init())
    back = J.PmwfStreamState(**pmwf_state_to_numpy(p_a)._asdict())
    j_y2, _ = j_run(jnp.asarray(fr[:, 40:]),
                    J.PmwfStreamState(*(jnp.asarray(f) for f in back)))
    assert _rel(j_y2, j_y) <= 1e-9


def test_coherent_input_finite_float32():
    """Six copies of one signal offset by 7 samples through the session in
    float32 (the coherent-covariance NaN gate of the reference package):
    finite and not all zero."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(9000) * 3000.0
    xs = np.stack([np.roll(x, 7 * c) for c in range(6)])
    sess = PmwfStreamingSession(n_ch=6, block_frames=8, device="cpu")
    outs = [sess.push(xs[:, i: i + 1600], quantize=False)
            for i in range(0, 9000, 1600)]
    y = np.concatenate([o for o in outs if o.size]
                       + [sess.flush(quantize=False)], axis=1)
    assert y.size and np.isfinite(y).all()
    assert float(np.abs(y).max()) > 1.0


def test_streaming_pmwf_enhances(mix):
    """Property gate: on the directional mixture the streaming beamformer
    raises the correlation with the clean source against the best input
    channel (within 0.02) and suppresses the noise-only span."""
    x, src = mix
    y = pmwf_streaming_enhance(x, quantize=False, **CPU64)

    def best_corr(sig, ref, max_lag=800):
        best = 0.0
        for lag in range(0, max_lag, 20):
            a = sig[lag: lag + len(ref) - max_lag]
            b = ref[: len(ref) - max_lag - lag]
            n = min(len(a), len(b))
            best = max(best, abs(float(np.corrcoef(a[:n], b[:n])[0, 1])))
        return best

    act = slice(8000, min(y.shape[1], x.shape[1]) - 2000)
    corr_in = max(best_corr(x[j, act], src[act]) for j in range(C))
    assert best_corr(y[0, act], src[act]) > corr_in - 0.02
    noise_span = slice(1000, 5000)
    assert (y[0, noise_span] ** 2).mean() < 0.5 * (
        x[0, noise_span] ** 2).mean()


def test_multichannel_quality_pinned():
    """The reference package's pinned batteries on its 6-channel fixture
    (best input 8.72 dB, offline PMWF 20.34, streaming PMWF 17.52 dB
    segmental SNR against the known source, recorded by the reference;
    the same thresholds)."""
    x, src = synth_mixture(n_ch=6)
    seg_in = max(segsnr_vs_source(x[j], src) for j in range(6))
    y_off = PmwfEnhancer(device="cpu").enhance(x, quantize=False)
    seg_off = segsnr_vs_source(y_off[0], src)
    y_str = pmwf_streaming_enhance(x, quantize=False, fast=True,
                                   device="cpu")
    seg_str = segsnr_vs_source(y_str[0], src)
    assert 8.0 < seg_in < 10.0, seg_in
    assert seg_off >= 19.3, seg_off
    assert seg_str >= 16.5, seg_str
    assert seg_off - seg_in >= 10.0
    assert seg_str - seg_in >= 7.0


# ---------------------------------------------------------------------------
# online NTF
# ---------------------------------------------------------------------------

def _ntf_blocks(seed=0, n_blocks=6):
    rng = np.random.default_rng(seed)
    b = np.abs(rng.random((64, 10))) + 1e-3
    blks = np.abs(rng.random((n_blocks, C, 64, 16))) + 1e-3
    return b, blks


def test_ntf_online_matches_reference_x64():
    b, blks = _ntf_blocks()
    ref = J.NtfStreamingSession(b, C, dtype=jnp.float64)
    sess = NtfStreamingSession(b, C, **CPU64)
    for blk in blks:
        assert _rel(sess.push_block(blk), ref.push_block(blk)) <= 1e-9
    assert _rel(sess.loadings, ref.loadings) <= 1e-9
    assert int(sess.state.l) == int(ref.state.l) == len(blks)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ntf_push_blocks_matches_per_block(dtype):
    b, blks = _ntf_blocks(1)
    s1 = NtfStreamingSession(b, C, dtype=dtype, device="cpu")
    outs1 = np.stack([s1.push_block(blk) for blk in blks])
    s2 = NtfStreamingSession(b, C, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(s2.push_blocks(blks), outs1)
    assert torch.equal(s2.state.c, s1.state.c)
    assert int(s2.state.l) == int(s1.state.l) == len(blks)


def test_ntf_online_converges_to_batch():
    """On a stationary stream the warm-started per-block C-step converges
    to the batch ``ntf_solve`` loadings (cosine per column)."""
    rng = np.random.default_rng(5)
    c_ch, n_bins, k = 3, 24, 4
    b = rng.random((n_bins, k)) + 0.05
    c_true = rng.random((c_ch, k)) + 0.05
    m_blk, n_blocks = 16, 30
    a = rng.random((m_blk * n_blocks, k)) + 0.05
    s_full = np.einsum("ck,nk,mk->cnm", c_true, b, a)
    res = ntf_solve(s_full, b, default_c_init(c_ch, k),
                    np.ones((s_full.shape[2], k)), sparsity=0.0,
                    max_iter=300, conv_eps=0.0, **CPU64)
    sess = NtfStreamingSession(b, c_ch, sparsity=0.0, inner_iters=6,
                               **CPU64)
    sess.push_blocks(np.stack([s_full[:, :, i * m_blk: (i + 1) * m_blk]
                               for i in range(n_blocks)]))
    c_on, c_batch = sess.loadings, res.c.numpy()
    for j in range(k):
        u, v = c_on[:, j], c_batch[:, j]
        assert float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v))) \
            > 0.995, j
