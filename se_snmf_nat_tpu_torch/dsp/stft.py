"""Batched STFT / iSTFT on tensors (port of ``se_snmf_nat_tpu.dsp.stft``).

Semantics are the reference's streaming DFT path: per-frame FIR
pre-emphasis, sqrt-periodic-Hann window, zero-pad to fftlength, ``|Y|**pow``
over bins 0..fftlen/2 with the lowest ``dc_bin`` bins zeroed and
``nonzerofloor`` added; synthesis zeroes ``dc_bin_back`` rows, takes the
pow-th root, inverts, windows, de-emphasises, scales by overlapscale and
overlap-adds at the hop.

Every function takes any number of leading batch dimensions: ``(..., T, L)``
frames and ``(..., T, F)`` spectra.  The transforms are plain matrix
products or ``torch.fft`` calls; on the card they run in full f32
(``device.full_f32``).
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def stream_frames(x: np.ndarray, framelength: int, frameshift: int,
                  n_flush: int) -> np.ndarray:
    """Frames exactly as the reference's streaming queue produces them
    (NumPy): frame l of the signal zero-prepended by framelength-frameshift
    samples, the trailing partial hop dropped, then ``n_flush`` zero frames.

    Returns (T, framelength) float64 with T = floor(len/shift) + n_flush."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n_hops = len(x) // frameshift
    pad = framelength - frameshift
    xp = np.concatenate([np.zeros(pad), x[: n_hops * frameshift]])
    idx = np.arange(framelength)[None, :] + \
        frameshift * np.arange(n_hops)[:, None]
    frames = xp[idx]
    if n_flush:
        frames = np.concatenate(
            [frames, np.zeros((n_flush, framelength))], axis=0)
    return frames


def stream_frames_torch(samples: torch.Tensor, n_hops: torch.Tensor,
                        framelength: int, frameshift: int) -> torch.Tensor:
    """``stream_frames`` on the device, as one index gather.

    ``samples``: (..., S) with S = T * frameshift for the bucketed frame
    count T; entries beyond ``n_hops * frameshift`` must be zero.
    ``n_hops``: (...,) integer tensor; frames at l >= n_hops are zeroed
    (the reference's flush frames and the bucket's padding frames).
    Returns (..., T, framelength)."""
    t_bucket = samples.shape[-1] // frameshift
    pad = framelength - frameshift
    xp = torch.nn.functional.pad(samples, (pad, framelength))
    dev = samples.device
    idx = (torch.arange(framelength, device=dev)[None, :]
           + frameshift * torch.arange(t_bucket, device=dev)[:, None])
    frames = xp[..., idx]
    mask = (torch.arange(t_bucket, device=dev)
            < torch.as_tensor(n_hops, device=dev)[..., None])
    return frames * mask[..., None].to(frames.dtype)


def pack_samples_for_upload(smp: np.ndarray,
                            np_dtype=np.float32) -> np.ndarray:
    """The narrowest exact upload dtype: int16 when every sample is an
    integer in int16 range (every wav read), else ``np_dtype``.  The cast to
    the compute dtype on the device is exact either way."""
    if (smp.size
            and np.all(smp == np.floor(smp))
            and smp.min() >= -32768 and smp.max() <= 32767):
        return smp.astype(np.int16)
    return np.asarray(smp, np_dtype)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def preemphasis(frames: torch.Tensor, coeff: float) -> torch.Tensor:
    """Per-frame FIR pre-emphasis y[k] = x[k] - a*x[k-1], y[0] = x[0]."""
    if coeff == 0.0:
        return frames
    shifted = torch.nn.functional.pad(frames[..., :-1], (1, 0))
    return frames - coeff * shifted


def deemphasis(frames: torch.Tensor, coeff: float) -> torch.Tensor:
    """Per-frame IIR de-emphasis y[k] = x[k] + a*y[k-1], as a product with
    the lower-triangular power matrix."""
    if coeff == 0.0:
        return frames
    n = frames.shape[-1]
    k = torch.arange(n, device=frames.device)
    expo = (k[:, None] - k[None, :]).to(frames.dtype)
    mat = torch.where(expo >= 0, coeff ** expo, torch.zeros_like(expo))
    return frames @ mat.T


def dft_matrices(framelength: int, fftlength: int, dtype=np.float64):
    """Real DFT as matmul operands (NumPy): forward ``re = y @ C``,
    ``im = y @ S`` of shape (framelength, F); inverse (F, framelength)
    ``y = re @ Ci + im @ Si`` of the conjugate-symmetric spectrum,
    truncated to framelength."""
    f = fftlength // 2 + 1
    k = np.arange(fftlength)[:framelength, None] * np.arange(f)[None, :] \
        * (2.0 * np.pi / fftlength)
    c = np.cos(k)
    s = -np.sin(k)
    wk = np.full((f, 1), 2.0)
    wk[0] = 1.0
    if fftlength % 2 == 0:
        wk[-1] = 1.0
    n = np.arange(framelength)[None, :]
    ki = np.arange(f)[:, None] * n * (2.0 * np.pi / fftlength)
    ci = wk * np.cos(ki) / fftlength
    si = -wk * np.sin(ki) / fftlength
    return tuple(np.asarray(a, dtype) for a in (c, s, ci, si))


def dft_matrices_stacked(framelength: int, fftlength: int,
                         dtype=np.float64):
    """Forward (framelength, 2F) = [C | S] and inverse (2F, framelength) =
    [Ci ; Si], one matmul per direction."""
    c, s, ci, si = dft_matrices(framelength, fftlength, dtype)
    return (np.concatenate([c, s], axis=1),
            np.concatenate([ci, si], axis=0))


def _stacked_tensors(framelength, fftlength, like: torch.Tensor):
    cs, cisi = dft_matrices_stacked(framelength, fftlength)
    return (torch.as_tensor(cs, dtype=like.dtype, device=like.device),
            torch.as_tensor(cisi, dtype=like.dtype, device=like.device))


def analysis_frames(frames: torch.Tensor, win: torch.Tensor, fftlength: int,
                    pow_: float, dc_bin: int, nonzerofloor: float,
                    preemph: float = 0.0, dft_matmul: bool = False,
                    cs: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, framelength) frames -> (mag**pow (..., T, F), phase).

    ``dft_matmul=True``: one stacked (framelength, 2F) product and the phase
    as a unit phasor [cos | sin] of shape (..., T, 2F); ``cs`` is the
    forward operand from ``dft_matrices_stacked`` (built here when None).
    Otherwise ``torch.fft.rfft`` and the phase angle (..., T, F)."""
    y = preemphasis(frames, preemph) * win
    if dft_matmul:
        if cs is None:
            cs, _ = _stacked_tensors(y.shape[-1], fftlength, y)
        reim = torch.matmul(y, cs)
        f = fftlength // 2 + 1
        re, im = reim[..., :f], reim[..., f:]
        r2 = re * re + im * im
        mag = r2 ** (pow_ / 2.0)
        # bins with 0 < r2 < tiny would get a clamped rsqrt and a phasor of
        # norm << 1; below the floor they take the r == 0 convention
        # (angle 0: cos 1, sin 0)
        tiny = torch.finfo(r2.dtype).tiny
        big = r2 >= tiny
        rs = torch.where(big, torch.rsqrt(torch.clamp(r2, min=tiny)),
                         torch.zeros_like(r2))
        cosp = torch.where(big, re * rs, torch.ones_like(r2))
        sinp = im * rs
        phase = torch.cat([cosp, sinp], dim=-1)
    else:
        spec = torch.fft.rfft(y, n=fftlength, dim=-1)
        phase = torch.angle(spec)
        mag = torch.abs(spec) ** pow_
    if dc_bin > 0:
        mag = mag.clone()
        mag[..., :dc_bin] = 0.0
    return mag + nonzerofloor, phase


def synthesis_frames(mag: torch.Tensor, phase: torch.Tensor,
                     framelength: int, fftlength: int, win: torch.Tensor,
                     pow_: float, dc_bin_back: int, overlapscale: float,
                     preemph: float = 0.0, dft_matmul: bool = False,
                     cisi: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T, F) mag**pow + phase -> (..., T, framelength) windowed time
    frames.  With ``dft_matmul`` the inverse is one product with ``cisi``
    (built when None); the phase may be a unit phasor (..., T, 2F) or an
    angle (..., T, F)."""
    if dc_bin_back > 0:
        mag = mag.clone()
        mag[..., :dc_bin_back] = 0.0
    amp = mag ** (1.0 / pow_)
    if dft_matmul:
        if cisi is None:
            _, cisi = _stacked_tensors(framelength, fftlength, amp)
        f = mag.shape[-1]
        if phase.shape[-1] == 2 * f:
            cosp, sinp = phase[..., :f], phase[..., f:]
        else:
            cosp, sinp = torch.cos(phase), torch.sin(phase)
        y = torch.matmul(torch.cat([amp * cosp, amp * sinp], dim=-1), cisi)
    else:
        spec = torch.polar(amp, phase)
        y = torch.fft.irfft(spec, n=fftlength, dim=-1)[..., :framelength]
    y = y * win
    y = deemphasis(y, preemph)
    return y * overlapscale


def overlap_add(frames: torch.Tensor, frameshift: int) -> torch.Tensor:
    """OLA of (..., T, framelength) frames at hop ``frameshift``: frame t
    covers samples [t*hop, t*hop + framelength).  Chunk c of every frame
    adds in at hop t + c, in the reference's order of c."""
    t, n = frames.shape[-2:]
    if n % frameshift:
        raise ValueError(
            f"overlap_add requires framelength ({n}) divisible by "
            f"frameshift ({frameshift})")
    ratio = n // frameshift
    total = (t - 1) * frameshift + n
    lead = frames.shape[:-2]
    chunks = frames.reshape(*lead, t, ratio, frameshift)
    out = frames.new_zeros(*lead, t + ratio - 1, frameshift)
    for c in range(ratio):
        out[..., c: c + t, :] += chunks[..., :, c, :]
    return out.reshape(*lead, -1)[..., :total]
