"""Parameterized Multichannel Wiener Filter with spectro-temporal
covariances — the offline beamformer on the card.  Counterpart of the
reference package's ``multichannel/pmwf.py``.

Reference math: src/PSD_cov_mat.m (Jin/Shin/Kim SPL 2015 spectro-temporal
covariance) + src/PMWF_sep_event_RT_CHiME.m:120-177 (noise covariance frozen
from the init period, Ecov = Ycov - Ncov, per-bin filter
H_j = (Ncov+eps I)^-1 Ecov / (beta + trace) u_j).  The offline plan:

  device: per-channel batched STFT -> complex spectra Y (C, F, T)
          -> neighborhood covariances (T, F, C, C)
          -> Ncov = sum over the init period; per-block Ycov sums
          -> batched (F, C, C) unrolled Cholesky solves + trace -> filters
          -> filtered spectra -> batched iSTFT + OLA per output channel

Boundary semantics of PSD_cov_mat.m:13-17 are kept: frequency bins within
M_PMWF of either edge collapse the whole frequency neighborhood onto the
center bin.  Parameters all come from the shipped settings
(initial_setting_SNMF_NAT.m:78-85).

Complex arithmetic: every product, quotient and magnitude of complex
values runs through its real and imaginary parts (``cmul``, ``cmul_conj``,
``cdiv``), a separate elementwise launch for each real operation.  PyTorch's
fused complex kernels round differently in their vectorised and scalar
paths on the CPU, so a value would depend on where it falls in a tensor;
real adds, products and quotients are IEEE-exact either way.  So a lane
gives the same bits alone as in a batch on the CPU and on the card, and
the products are rounded as the reference's compiled complex products
are.  Sums over channels, shifts and frames are explicit ordered adds.
All of this is plain PyTorch: the reference computes it outside Pallas.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from se_snmf_nat_tpu_torch.config import PipelineConfig, default_config
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import overlap_add, stream_frames
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write


@dataclass(frozen=True)
class PmwfParams:
    """initial_setting_SNMF_NAT.m:78-85 (+ init_N_len :57)."""

    beta: float = 10.0           # p.BETA_PMWF (0: MVDR-like, >0: PMWF)
    m_nbr: int = 2               # p.M_PMWF spectral neighbor radius
    l_nbr: int = 2               # p.L_PMWF temporal neighbor radius
    init_n_len: int = 15         # noise-only init frames
    norm_period: int = 15        # p.norm_period block size for Ycov means
    diag_load: float = 1e-3      # eps*I on Ncov before the solve (:148)
    ref_ch: int | None = None    # None: output all channels; else one


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of a real compute dtype (the reference's cdtype)."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# ---------------------------------------------------------------------------
# Complex arithmetic through real parts
# ---------------------------------------------------------------------------

def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b: (ar*br - ai*bi, ar*bi + ai*br)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def cmul_conj(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * conj(b): (ar*br + ai*bi, ai*br - ar*bi)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br + ai * bi, ai * br - ar * bi)


def cdiv_real(a: torch.Tensor, r) -> torch.Tensor:
    """a / r for a real r (a tensor or a number): each part divided, as a
    complex division by (r, 0) gives it."""
    return torch.complex(a.real / r, a.imag / r)


def cdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b by Smith's algorithm (the reference compiler's complex
    division; it does not overflow where |b|^2 would)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    big_re = torch.abs(br) >= torch.abs(bi)
    r = torch.where(big_re, bi / br, br / bi)
    den = torch.where(big_re, br + bi * r, bi + br * r)
    re = torch.where(big_re, ar + ai * r, ar * r + ai) / den
    im = torch.where(big_re, ai - ar * r, ai * r - ar) / den
    return torch.complex(re, im)


def ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as x[0] + x[1] + ... in index order."""
    x = x.movedim(dim, 0)
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


# ---------------------------------------------------------------------------
# Covariances, solves, filters
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def collapse_index(f: int, m_nbr: int, device) -> torch.Tensor:
    """(2M+1, F) frequency index of each shift: bin f + dm inside the
    interior, the bin itself within M of either edge (PSD_cov_mat.m:13-17,
    the reference package's roll-and-select)."""
    bins = torch.arange(f, device=device)
    interior = (bins >= m_nbr) & (bins < f - m_nbr)
    return torch.stack([torch.where(interior, bins + dm, bins)
                        for dm in range(-m_nbr, m_nbr + 1)])


def frame_cov(z: torch.Tensor) -> torch.Tensor:
    """Per-frame frequency-neighborhood covariance: z (..., C, M, F) (the
    2M+1 shifted spectra of one frame) -> (..., C, C, F), the sum over the
    shifts in index order of outer(z_m, conj(z_m))."""
    p = cmul_conj(z[..., :, None, :, :], z[..., None, :, :, :])
    return ordered_sum(p, -2)


def spectro_temporal_cov(y: torch.Tensor, m_nbr: int, l_nbr: int
                         ) -> torch.Tensor:
    """Per-frame spectro-temporal covariances.

    y: (C, F, T) complex spectra.  Returns (T, F, C, C) where entry t is
    the sum over the (2*m_nbr+1)x(2*l_nbr+1) neighborhood of frame t
    (PSD_cov_mat.m with the boundary-collapse rule; time edges clamp to the
    valid range, matching the reference's behavior of only evaluating
    frames with a full temporal neighborhood)."""
    _, f, t = y.shape
    idx = collapse_index(f, m_nbr, y.device)
    z = y[:, idx, :].permute(3, 0, 1, 2)          # (T, C, M, F)
    r = frame_cov(z).permute(0, 3, 1, 2)          # (T, F, C, C)
    # temporal box sum of width 2L+1 with edge clamping, as the reference
    # package's cumulative-sum difference
    if l_nbr > 0:
        pad = torch.cat([r[:1].expand(l_nbr, -1, -1, -1), r,
                         r[-1:].expand(l_nbr, -1, -1, -1)], dim=0)
        cs = torch.cat([torch.zeros_like(pad[:1]),
                        torch.cumsum(pad, dim=0)], dim=0)
        r = cs[2 * l_nbr + 1:] - cs[:t]
    return r


def _real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def solve_hpd_small(a: torch.Tensor, b: torch.Tensor,
                    max_unrolled: int = 8) -> torch.Tensor:
    """Batched A^-1 B for small Hermitian-positive-definite A — unrolled
    Cholesky + triangular substitutions in elementwise ops.

    a: (..., C, C) HPD (the diagonally loaded noise covariance — PSD outer
    product sums + eps*I, so no pivoting is needed); b: (..., C, K).

    The reference's form, each sum subtracting in ascending k; here a
    column of L is computed for all its rows at once and the forward
    substitution updates all later rows at once, which keeps every sum's
    order.  C larger than ``max_unrolled`` takes ``torch.linalg.solve``.

    Pivot floor: coherent multichannel input (e.g. copies of one signal
    with sample offsets — also real mic arrays at low frequencies) makes
    the covariance rank-1 with entries >> diag_load, so the absolute eps*I
    the reference adds (PMWF_sep_event_RT_CHiME.m:148) is below the
    working dtype's rounding and the Schur complement can round NEGATIVE
    -> sqrt -> NaN.  Each pivot is clamped to an eps-relative floor of its
    own diagonal entry: bit-exact (max(x, smaller)=x) whenever the solve is
    well-conditioned.  ``torch.linalg.cholesky`` has no such floor."""
    c = a.shape[-1]
    if c > max_unrolled:
        return torch.linalg.solve(a, b)
    rdt = _real_dtype(a.dtype)
    eps, tiny = torch.finfo(rdt).eps, torch.finfo(rdt).tiny
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*lead, c, c)
    b = b.expand(*lead, *b.shape[-2:])
    flr = eps * torch.diagonal(a, dim1=-2, dim2=-1).real + tiny   # (..., C)
    # Cholesky a = L L^H, column by column
    lo = torch.zeros_like(a)
    piv = []                                      # real pivots L_jj
    for j in range(c):
        s = a[..., j:, j]                         # (..., C-j)
        if j:
            p = cmul_conj(lo[..., j:, :j], lo[..., j:j + 1, :j])
            for k in range(j):
                s = s - p[..., k]
        d = torch.sqrt(torch.maximum(s[..., 0].real, flr[..., j]))
        piv.append(d)
        lo[..., j, j] = d.to(a.dtype)
        if j + 1 < c:
            lo[..., j + 1:, j] = cdiv_real(s[..., 1:], d[..., None])
    # forward substitution L y = b (columns of b together; row i takes its
    # updates in ascending k)
    y = b.clone()
    for k in range(c):
        y[..., k, :] = cdiv_real(y[..., k, :], piv[k][..., None])
        if k + 1 < c:
            y[..., k + 1:, :] = y[..., k + 1:, :] - cmul(
                lo[..., k + 1:, k, None], y[..., k:k + 1, :])
    # backward substitution L^H x = y (row i's sum in ascending k)
    x = torch.empty_like(y)
    for i in reversed(range(c)):
        s = y[..., i, :]
        if i + 1 < c:
            p = cmul_conj(x[..., i + 1:, :], lo[..., i + 1:, i, None])
            for k in range(c - i - 1):
                s = s - p[..., k, :]
        x[..., i, :] = cdiv_real(s, piv[i][..., None])
    return x


def pmwf_filters(ncov: torch.Tensor, ecov: torch.Tensor, beta: float,
                 diag_load: float, flr: float = 1e-9) -> torch.Tensor:
    """(..., F, C, C) covariances -> (..., F, C, C) filter bank H with
    H[f, j, :] = column j of (Ncov+eps I)^-1 Ecov scaled by
    1/(beta + trace + flr)  (PMWF_sep_event_RT_CHiME.m:148-165).

    Loading is the reference's ABSOLUTE diag_load plus an eps-RELATIVE
    term at the working precision (eps * trace/C per bin): coherent
    channels make Ncov rank-1 with entries many orders above diag_load, so
    the absolute load alone is below the dtype's rounding and the solve
    overflows float32; the relative term bounds the condition number at
    ~C/eps while perturbing well-conditioned solves only at rounding
    level."""
    c = ncov.shape[-1]
    eps = torch.finfo(_real_dtype(ncov.dtype)).eps
    tr_n = ordered_sum(torch.diagonal(ncov, dim1=-2, dim2=-1).real, -1)
    load = diag_load + eps * tr_n / c
    a = ncov.clone()
    a.real.diagonal(dim1=-2, dim2=-1).add_(load[..., None])
    necov = solve_hpd_small(a, ecov)
    lam = ordered_sum(torch.diagonal(necov, dim1=-2, dim2=-1), -1)
    scaled = cdiv(necov, ((beta + lam) + flr)[..., None, None])
    # H[j,:,f] = scaled[:, j] -> arrange as (F, out_ch j, in_ch c)
    return scaled.transpose(-1, -2)


def apply_filters(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d[j] = sum_c conj(h[..., j, c]) * y[c] in channel order.

    h: (..., J, C, F) filter bank; y: (..., C, F) -> (..., J, F)."""
    return ordered_sum(cmul_conj(y[..., None, :, :], h), -2)


# ---------------------------------------------------------------------------
# Analysis and synthesis
# ---------------------------------------------------------------------------

FFT_ROWS = 1024     # rows in every transform call (see ``fixed_rows``)


def fixed_rows(fft, x: torch.Tensor, n: int) -> torch.Tensor:
    """``fft(rows, n=n)`` over the last axis in calls of exactly
    ``FFT_ROWS`` rows, the last call's padded with zeros.  cuFFT's float32
    transforms at n=1024 take another algorithm from 2,048 rows on (H100,
    CUDA 12.8), so a row's bits would depend on how many rows share its
    call: a lane alone against a batch, a session block against the whole
    utterance.  One call shape for all gives each row the same bits."""
    rows = x.reshape(-1, x.shape[-1])
    m = rows.shape[0]
    pad = -m % FFT_ROWS
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, rows.shape[1])])
    out = torch.cat([fft(c, n=n, dim=-1) for c in rows.split(FFT_ROWS)])
    return out[:m].reshape(*x.shape[:-1], -1)


def analysis(frames: torch.Tensor, win: torch.Tensor, s,
             cdtype: torch.dtype) -> torch.Tensor:
    """(..., T, L) frames -> (..., T, F) spectra (``fixed_rows``) with the
    reference's floor/DC magnitude semantics: |Y| with the lowest ``dc_bin`` bins
    zeroed, ``nonzerofloor`` added to every bin, times the phase
    factor Y/|Y| (1 where Y is 0)."""
    spec = fixed_rows(torch.fft.rfft, frames * win, s.fftlength)
    re, im = spec.real, spec.imag
    mag = torch.sqrt(re * re + im * im)
    nz = mag > 0
    ur = torch.where(nz, re / mag, torch.ones_like(mag))
    ui = torch.where(nz, im / mag, torch.zeros_like(mag))
    mag[..., : s.dc_bin] = 0.0
    mag = mag + s.nonzerofloor
    return torch.complex(mag * ur, mag * ui).to(cdtype)


def synthesis(d: torch.Tensor, win: torch.Tensor, s,
              dtype: torch.dtype) -> torch.Tensor:
    """(..., T, F) filtered spectra -> (..., T, L) windowed frames: the
    lowest ``dc_bin`` bins zeroed (the reference's amplitude/phase rebuild
    of the other bins is the spectrum itself), iSTFT over fftlength, the
    first ``framelength`` samples, window, ``overlapscale``."""
    bins = torch.arange(d.shape[-1], device=d.device)
    d = torch.where(bins < s.dc_bin, torch.zeros_like(d), d)
    fr = fixed_rows(torch.fft.irfft, d, s.fftlength)[..., : s.framelength]
    return fr.to(dtype) * win * s.overlapscale


def frames_of(x: np.ndarray, cfg: PipelineConfig) -> np.ndarray:
    """(C, N) samples -> (C, T, framelength) streaming frames with the
    engine's delay+1 flush frames (NumPy float64)."""
    s = cfg.signal
    return np.stack([stream_frames(ch, s.framelength, s.frameshift,
                                   n_flush=cfg.delay + 1) for ch in x])


def emit_samples(y: np.ndarray, n_frames: int, cfg: PipelineConfig,
                 ref_ch: int | None) -> np.ndarray:
    """The delay-trimmed output of a (C, n) OLA waveform of ``n_frames``
    frames (one channel with ``ref_ch``)."""
    s = cfg.signal
    start = cfg.delay * s.frameshift
    emit = y[:, start: start + (n_frames - cfg.delay) * s.frameshift]
    if ref_ch is not None:
        emit = emit[ref_ch: ref_ch + 1]
    return emit


class PmwfEnhancer:
    """Offline multichannel PMWF enhancement (on the card unless
    ``device`` names another)."""

    def __init__(self, cfg: PipelineConfig | None = None,
                 params: PmwfParams | None = None, dtype=torch.float32,
                 device=None):
        self.cfg = cfg or default_config()
        self.params = params or PmwfParams()
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cdtype = complex_dtype(dtype)
        self.win = torch.as_tensor(
            sqrt_hann_periodic(self.cfg.signal.framelength), dtype=dtype,
            device=self.device)

    def run(self, frames: torch.Tensor) -> torch.Tensor:
        """(C, T, framelength) frames -> (C, n) OLA waveforms."""
        s, p = self.cfg.signal, self.params
        t = frames.shape[1]
        y = analysis(frames.to(self.dtype), self.win, s,
                     self.cdtype).transpose(1, 2)            # (C, F, T)
        covs = spectro_temporal_cov(y, p.m_nbr, p.l_nbr)     # (T,F,C,C)
        n_init = min(p.init_n_len, t)
        # the reference normalizes accumulated covariances by
        # (norm_period - 1) — sum/(n-1), not a mean — and the scale does
        # NOT cancel through (Ncov+dI)^-1 Ecov/(beta+tr) because diag_load
        # and beta are absolute (PMWF_sep_event_RT_CHiME.m:117,138)
        ncov = cdiv_real(ordered_sum(covs[:n_init], 0), max(n_init - 1, 1))
        # per-block accumulated noisy covariance (norm_period frames)
        n_blocks = -(-t // p.norm_period)
        pad_t = n_blocks * p.norm_period - t
        if pad_t:
            covs = torch.cat([covs, covs[-1:].expand(pad_t, -1, -1, -1)])
        blocks = covs.reshape(n_blocks, p.norm_period, *covs.shape[1:])
        ycov_blocks = cdiv_real(ordered_sum(blocks, 1), p.norm_period - 1)
        ecov_blocks = ycov_blocks - ncov[None]
        h = pmwf_filters(ncov.expand_as(ecov_blocks), ecov_blocks, p.beta,
                         p.diag_load)                        # (nb,F,J,C)
        block_idx = torch.clamp_max(
            torch.arange(t, device=frames.device) // p.norm_period,
            n_blocks - 1)
        h_t = h[block_idx].permute(0, 2, 3, 1)               # (T,J,C,F)
        d = apply_filters(h_t, y.permute(2, 0, 1))           # (T, J, F)
        return overlap_add(synthesis(d.transpose(0, 1), self.win, s,
                                     self.dtype), s.frameshift)

    def enhance(self, x: np.ndarray, quantize: bool = True) -> np.ndarray:
        """x: (C, N) int16-scale multichannel samples -> (C or 1, N_out)."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        frames = frames_of(x, self.cfg)
        y = self.run(torch.as_tensor(frames, dtype=self.dtype,
                                     device=self.device))
        emit = emit_samples(y.cpu().numpy(), frames.shape[1], self.cfg,
                            self.params.ref_ch)
        return matlab_int16_write(emit) if quantize else emit
