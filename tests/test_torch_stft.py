"""Port parity: framing, analysis/synthesis transforms, overlap-add and the
int16 write of ``se_snmf_nat_tpu_torch.dsp.stft`` against the JAX package
(x64 on the CPU).  Tolerance: 1e-12 relative to the largest magnitude in
float64 (only summation order differs); the int16 write is bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.dsp import stft as jstft
from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic as j_win
from se_snmf_nat_tpu.utils.matlab_compat import matlab_int16_write_jax
from se_snmf_nat_tpu_torch.dsp import stft as tstft
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write_torch)

torch.set_num_threads(1)
S = default_config().signal
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _frames(seed=0, n=6000):
    x = np.random.default_rng(seed).standard_normal(n) * 1000.0
    return tstft.stream_frames(x, S.framelength, S.frameshift, n_flush=4)


def test_window_copy_matches():
    np.testing.assert_array_equal(sqrt_hann_periodic(S.framelength),
                                  j_win(S.framelength))


def test_stream_frames_numpy_matches():
    x = np.random.default_rng(1).standard_normal(5000)
    np.testing.assert_array_equal(
        tstft.stream_frames(x, S.framelength, S.frameshift, 4),
        jstft.stream_frames(x, S.framelength, S.frameshift, 4))


@pytest.mark.parametrize("n_hops", [0, 7, 20])
def test_stream_frames_torch_matches_jax(n_hops):
    """Batched gather on two lanes == the JAX per-lane gather, bit-equal."""
    rng = np.random.default_rng(2)
    t_bucket = 24
    smp = np.zeros((2, t_bucket * S.frameshift))
    smp[0, : n_hops * S.frameshift] = rng.standard_normal(
        n_hops * S.frameshift)
    smp[1, : 5 * S.frameshift] = rng.standard_normal(5 * S.frameshift)
    nh = np.array([n_hops, 5])
    got = tstft.stream_frames_torch(torch.as_tensor(smp),
                                    torch.as_tensor(nh), S.framelength,
                                    S.frameshift).numpy()
    for i in range(2):
        ref = jstft.stream_frames_jax(jnp.asarray(smp[i]), nh[i],
                                      S.framelength, S.frameshift)
        np.testing.assert_array_equal(got[i], np.asarray(ref))


def test_pack_samples_for_upload_matches():
    ints = np.array([[0.0, -32768.0, 32767.0, 12.0]])
    floats = np.array([[0.5, 1.0]])
    for a in (ints, floats):
        got = tstft.pack_samples_for_upload(a)
        ref = jstft.pack_samples_for_upload(a)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_dft_matrices_match():
    for got, ref in zip(tstft.dft_matrices_stacked(S.framelength,
                                                   S.fftlength),
                        jstft.dft_matrices_stacked(S.framelength,
                                                   S.fftlength, np.float64)):
        assert _rel(got, ref) < RTOL


@pytest.mark.parametrize("dft_matmul", [False, True])
@pytest.mark.parametrize("preemph", [0.0, 0.92])
def test_analysis_matches_jax(dft_matmul, preemph):
    frames = _frames(3)
    win = sqrt_hann_periodic(S.framelength)
    mag_r, ph_r = jstft.analysis_frames(
        jnp.asarray(frames), jnp.asarray(win), S.fftlength, S.pow, S.dc_bin,
        S.nonzerofloor, preemph, dft_matmul=dft_matmul)
    mag, ph = tstft.analysis_frames(
        torch.as_tensor(frames), torch.as_tensor(win), S.fftlength, S.pow,
        S.dc_bin, S.nonzerofloor, preemph, dft_matmul=dft_matmul)
    assert mag.shape == mag_r.shape and ph.shape == ph_r.shape
    assert _rel(mag, mag_r) < RTOL
    if dft_matmul:                    # unit phasor [cos | sin]
        assert _rel(ph, ph_r) < RTOL
    else:
        # an angle is defined up to 2*pi, and not at all for a zero bin
        # (the flush frames): compare wrapped, where the magnitude is real
        d = np.angle(np.exp(1j * (ph.numpy() - np.asarray(ph_r))))
        live = np.asarray(mag_r) > 1e-6 * np.asarray(mag_r).max()
        assert np.abs(d[live]).max() < RTOL * np.pi


@pytest.mark.parametrize("dft_matmul", [False, True])
@pytest.mark.parametrize("preemph", [0.0, 0.92])
def test_synthesis_and_ola_match_jax(dft_matmul, preemph):
    frames = _frames(4)
    win = sqrt_hann_periodic(S.framelength)
    mag, ph = jstft.analysis_frames(
        jnp.asarray(frames), jnp.asarray(win), S.fftlength, S.pow, S.dc_bin,
        S.nonzerofloor, preemph, dft_matmul=dft_matmul)
    mag, ph = np.array(mag) * 0.7, np.array(ph)
    ref = jstft.synthesis_frames(
        jnp.asarray(mag), jnp.asarray(ph), S.framelength, S.fftlength,
        jnp.asarray(win), S.pow, S.dc_bin_back, S.overlapscale, preemph,
        dft_matmul=dft_matmul)
    got = tstft.synthesis_frames(
        torch.as_tensor(mag), torch.as_tensor(ph), S.framelength,
        S.fftlength, torch.as_tensor(win), S.pow, S.dc_bin_back,
        S.overlapscale, preemph, dft_matmul=dft_matmul)
    assert _rel(got, ref) < RTOL
    y_ref = jstft.overlap_add(ref, S.frameshift)
    y = tstft.overlap_add(got, S.frameshift)
    assert y.shape == y_ref.shape
    assert _rel(y, y_ref) < RTOL


def test_overlap_add_batched_matches_per_lane():
    frames = np.random.default_rng(5).standard_normal((3, 10, S.framelength))
    got = tstft.overlap_add(torch.as_tensor(frames), S.frameshift).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jstft.overlap_add(jnp.asarray(frames[i]),
                                                 S.frameshift)))


def test_overlap_add_rejects_non_integer_ratio():
    with pytest.raises(ValueError):
        tstft.overlap_add(torch.zeros(3, 100), 30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_int16_write_bit_equal(dtype):
    """Round half away from zero and saturate, as MATLAB fwrite does."""
    rng = np.random.default_rng(6)
    y = np.concatenate([rng.standard_normal(2000) * 20000.0,
                        [0.5, -0.5, 1.5, -1.5, 2.5, 40000.0, -40000.0,
                         32767.5, -32768.5, 0.0]])
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    y = y.astype(np_dt)
    got = matlab_int16_write_torch(torch.as_tensor(y)).numpy()
    ref = np.asarray(matlab_int16_write_jax(jnp.asarray(y)))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref)
