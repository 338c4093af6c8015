"""The port's Bayesian-NMF enhancer (``bnmf/``) against the reference
package's on the CPU: the VB core (``vb_train`` with its bound trace,
``vb_h_infer``), the speech model, online and supervised ``enhance`` and
``BnmfStreamingSession``, in float64 within 1e-9 relative of the reference
run in x64 with identical int16; the online enhancer in float32 within
twice the reference's own float32-to-x64 gap on the same clip; and the
inputs the reference rejects.  A speech model trained by the reference
package crosses over with ``convert.bnmf_model_from_jax``.

Cuts from ``BnmfParams()``, as the reference's own tests make them: 12
speech components (not 100), 30 training trips (not 100), 50 noise-init
trips (not 1,000) and 10 VB trips a frame (not 25); the rest (F=257, hop
256, 15 noise components, the 50-column buffer, a refit every 10 pushes,
the WADA window) as published."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu import bnmf as jb
from se_snmf_nat_tpu.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch import bnmf as tb
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import bnmf_model_from_jax

torch.set_num_threads(1)
SMALL = dict(k_speech=12, train_iters=30, noise_init_iters=50, n_infer=10)
J_SMALL = jb.BnmfParams(**SMALL)
T_SMALL = tb.BnmfParams(**SMALL)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def signals():
    return {"speech": fixtures.speechlike(16000, seed=3),
            "noise": fixtures.noise(16000, seed=5, level=1500.0),
            "mix": fixtures.noisy_utterance(24000, seed=0),   # 92 frames
            "clean": fixtures.clean_utterance(24000, seed=0)}


@pytest.fixture(scope="module")
def models(signals):
    """The speech model trained by the reference in x64, and the port's
    enhancer and the reference's on it."""
    jm, _ = jb.train_speech_model(signals["speech"], J_SMALL,
                                  dtype=jnp.float64)
    port = tb.BnmfEnhancer(bnmf_model_from_jax(jm, **CPU64), params=T_SMALL,
                           **CPU64)
    ref = jb.BnmfEnhancer(jm, params=J_SMALL, dtype=jnp.float64)
    return jm, port, ref


@pytest.fixture(scope="module")
def offline(signals, models):
    _, port, ref = models
    return (port.enhance(signals["mix"], quantize=False),
            ref.enhance(signals["mix"], quantize=False))


@pytest.mark.parametrize("trace_bound", [False, True])
def test_vb_train_matches_reference_x64(trace_bound):
    x = np.random.default_rng(0).gamma(2.0, 1.0, (48, 30))
    w0, h0, b0w, b0h = jb.init_train(x, 6, seed=3)
    jw, jh, jtr = jb.vb_train(jnp.asarray(x), jnp.asarray(w0),
                              jnp.asarray(h0), b0w, b0h, n_iter=25,
                              trace_bound=trace_bound)
    tw, th, ttr = tb.vb_train(_t(x), _t(w0), _t(h0), b0w, b0h, n_iter=25,
                              trace_bound=trace_bound)
    for got, want in ((tw.shape, jw.shape), (tw.scale, jw.scale),
                      (th.shape, jh.shape), (th.scale, jh.scale)):
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-9
    if trace_bound:
        tr = ttr.numpy()
        assert _rel(tr, np.asarray(jtr)) <= 1e-9
        assert np.all(np.diff(tr) >= -1e-8 * np.abs(tr[:-1]))
        assert tr[-1] > tr[0]
    else:
        assert not torch.any(ttr)


def test_init_train_is_the_reference_draw():
    x = np.random.default_rng(1).gamma(2.0, 1.0, (20, 9))
    for got, want in zip(tb.init_train(x, 4, seed=7),
                         jb.init_train(x, 4, seed=7)):
        np.testing.assert_array_equal(got, want)


def test_vb_h_infer_matches_reference_x64():
    rng = np.random.default_rng(2)
    y = rng.gamma(2.0, 1.0, (40, 7))
    shape, scale = rng.uniform(1, 300, (40, 9)), rng.uniform(0.01, 1, (40, 9))
    u = rng.uniform(0.1, 2.0, (9, 7))
    phi = np.concatenate([np.zeros((5, 1)), np.full((4, 1), 100.0)])
    want = jb.vb_h_infer(jnp.asarray(y), jb.GammaPost(jnp.asarray(shape),
                                                      jnp.asarray(scale)),
                         jnp.asarray(u), jnp.asarray(phi), n_iter=12)
    got = tb.vb_h_infer(_t(y), tb.GammaPost(_t(shape), _t(scale)), _t(u),
                        _t(phi), n_iter=12)
    assert _rel(got.shape.numpy(), np.asarray(want.shape)) <= 1e-9
    assert _rel(got.scale.numpy(), np.asarray(want.scale)) <= 1e-9


def test_clamp_min_shape_preserves_mean():
    post = tb.GammaPost(_t([[2.0, 500.0]]), _t([[3.0, 0.1]]))
    out = tb.clamp_min_shape(post, 200.0)
    torch.testing.assert_close(out.mean, post.mean, rtol=1e-12, atol=0)
    assert torch.all(out.shape >= 200.0)


def test_train_speech_model_matches_reference_x64(signals, models):
    jm = models[0]
    tm, trace = tb.train_speech_model(signals["speech"], T_SMALL,
                                      trace_bound=True, **CPU64)
    f = T_SMALL.alen // 2 + 1
    assert tm.w.shape.shape == (f, T_SMALL.k_speech)
    assert tm.u0.shape == (T_SMALL.k_speech, 1)
    assert _rel(tm.w.shape.numpy(), np.asarray(jm.w.shape)) <= 1e-9
    assert _rel(tm.w.scale.numpy(), np.asarray(jm.w.scale)) <= 1e-9
    assert _rel(tm.u0.numpy(), np.asarray(jm.u0)) <= 1e-9
    tr = trace.numpy()
    assert np.all(np.diff(tr) >= -1e-8 * np.abs(tr[:-1]))


def test_online_enhance_of_a_reference_model_matches_x64(signals, models,
                                                         offline):
    """The reference's trained model carried across: the same int16, and
    the online loop's noise refit fires (the init's pushes alone pass
    ``refit_every``)."""
    got, want = offline
    assert got.dtype == np.float64 and got.shape == want.shape
    assert _rel(got, want) <= 1e-9
    np.testing.assert_array_equal(enhanced_quantize(got),
                                  enhanced_quantize(want))
    port = models[1]
    assert port.refits > 0
    q = port.enhance(signals["mix"])
    assert q.dtype == np.int16
    np.testing.assert_array_equal(q, enhanced_quantize(want))


def test_online_enhancement_improves_the_segmental_snr(signals, offline):
    from se_snmf_nat_tpu_torch.metrics import segmental_snr
    got = offline[0]
    clean, mix = signals["clean"], signals["mix"]
    assert segmental_snr(clean, got, 16000) \
        > segmental_snr(clean, mix, 16000)


def test_supervised_matches_reference_x64(signals, models):
    jm = models[0]
    port = tb.BnmfEnhancer(bnmf_model_from_jax(jm, **CPU64),
                           noise=signals["noise"], method="supervised",
                           params=T_SMALL, **CPU64)
    ref = jb.BnmfEnhancer(jm, noise=signals["noise"], method="supervised",
                          params=J_SMALL, dtype=jnp.float64)
    got = port.enhance(signals["mix"], quantize=False)
    want = ref.enhance(signals["mix"], quantize=False)
    assert _rel(got, want) <= 1e-9
    np.testing.assert_array_equal(port.enhance(signals["mix"]),
                                  ref.enhance(signals["mix"]))


@pytest.mark.parametrize("block_frames,chunk", [(1, 160), (3, 997),
                                                (8, 160)])
def test_streaming_session_equals_offline_x64(signals, models, offline,
                                             block_frames, chunk):
    port = models[1]
    sess = tb.BnmfStreamingSession(port, block_frames=block_frames)
    mix = signals["mix"]
    outs = [sess.push(mix[i: i + chunk], quantize=False)
            for i in range(0, len(mix), chunk)]
    outs.append(sess.flush(quantize=False))
    got = np.concatenate(outs)
    assert got.shape == offline[0].shape
    np.testing.assert_array_equal(got, offline[0])
    assert _rel(got, offline[1]) <= 1e-9


def test_streaming_short_input_matches_offline(signals, models):
    """Input shorter than the init head: the noise init trains on what
    arrived, at flush, as offline ``enhance`` of the same samples."""
    port, ref = models[1], models[2]
    short = signals["mix"][: T_SMALL.init_hops * T_SMALL.ulen - 100]
    want = port.enhance(short, quantize=False)
    sess = tb.BnmfStreamingSession(port, block_frames=4)
    got = np.concatenate([sess.push(short, quantize=False),
                          sess.flush(quantize=False)])
    np.testing.assert_array_equal(got, want)
    assert _rel(got, ref.enhance(short, quantize=False)) <= 1e-9


def test_streaming_flush_is_idempotent(signals, models):
    sess = tb.BnmfStreamingSession(models[1], block_frames=4)
    sess.push(signals["mix"][:16000])
    assert len(sess.flush(quantize=False)) > 0
    assert sess.flush(quantize=False).shape == (0,)
    with pytest.raises(RuntimeError):
        sess.push(signals["mix"][:100])


def test_online_float32_within_reference_envelope(signals, models, offline):
    jm = models[0]
    with jax.enable_x64(False):
        jm32 = jb.BnmfModel(
            jb.GammaPost(jnp.asarray(np.asarray(jm.w.shape), jnp.float32),
                         jnp.asarray(np.asarray(jm.w.scale), jnp.float32)),
            jnp.asarray(np.asarray(jm.u0), jnp.float32))
        want32 = jb.BnmfEnhancer(jm32, params=J_SMALL, dtype=jnp.float32) \
            .enhance(signals["mix"], quantize=False)
    port = tb.BnmfEnhancer(bnmf_model_from_jax(jm, device="cpu"),
                           params=T_SMALL, device="cpu")
    got = port.enhance(signals["mix"], quantize=False)
    want64 = offline[1]
    env = _rel(want32, want64)
    assert _rel(got, want32) <= 2 * env + 1e-6, (_rel(got, want32), env)


def test_empty_short_and_silent_inputs(signals, models):
    port = models[1]
    assert port.enhance(np.zeros(100)).shape == (0,)
    assert port.enhance(np.zeros(100)).dtype == np.int16
    silent = signals["mix"].copy()
    silent[: T_SMALL.init_hops * T_SMALL.ulen] = 0.0
    assert np.all(np.isfinite(port.enhance(silent, quantize=False)))


def test_rejects_what_the_reference_rejects(signals, models):
    model = bnmf_model_from_jax(models[0], **CPU64)
    with pytest.raises(ValueError, match="alen"):
        tb.BnmfEnhancer(model, params=T_SMALL._replace(alen=512, ulen=128),
                        **CPU64)
    with pytest.raises(ValueError, match="noise"):
        tb.BnmfEnhancer(model, method="supervised", params=T_SMALL, **CPU64)
    with pytest.raises(ValueError, match="speech"):
        tb.BnmfEnhancer(params=T_SMALL, **CPU64)
    sup = tb.BnmfEnhancer(model, noise=signals["noise"], method="supervised",
                          params=T_SMALL, **CPU64)
    with pytest.raises(ValueError):
        tb.BnmfStreamingSession(sup)
