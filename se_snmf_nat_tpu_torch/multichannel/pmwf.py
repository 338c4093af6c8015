"""Parameterized Multichannel Wiener Filter with spectro-temporal
covariances — the offline beamformer on the card.  Counterpart of the
reference package's ``multichannel/pmwf.py``.

Reference math: src/PSD_cov_mat.m (Jin/Shin/Kim SPL 2015 spectro-temporal
covariance) + src/PMWF_sep_event_RT_CHiME.m:120-177 (noise covariance frozen
from the init period, Ecov = Ycov - Ncov, per-bin filter
H_j = (Ncov+eps I)^-1 Ecov / (beta + trace) u_j).  The offline plan, over
a lane axis (one utterance a lane, each its own length):

  host:   the int16 host half (``stream/batch_host.BatchHost``): each
          lane's channels packed as int16, one upload a chunk
  device: framing -> per-channel STFT -> complex spectra Y (B, C, F, T)
          -> neighborhood covariances (B, T, F, C, C)
          -> a lane's Ncov = sum over its init period; per-block Ycov sums
          -> batched (F, C, C) unrolled Cholesky solves + trace -> filters
          -> filtered spectra -> iSTFT + OLA per output channel
          -> MATLAB's int16 write
  host:   int16 PCM fetched, a copy a lane

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
from se_snmf_nat_tpu_torch.dsp.stft import (
    overlap_add, stream_frames, stream_frames_torch)
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.stream.batch_host import BatchHost


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
    frames with a full temporal neighborhood): ``lane_box_cov`` of one
    lane."""
    return lane_box_cov(y[None], np.asarray([y.shape[-1]]), m_nbr,
                        l_nbr)[0]


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


# ---------------------------------------------------------------------------
# The offline plan over lanes
# ---------------------------------------------------------------------------

def lane_box_cov(y: torch.Tensor, t_true: np.ndarray, m_nbr: int,
                 l_nbr: int) -> torch.Tensor:
    """The spectro-temporal covariances of each lane of y (B, C, F, T) over
    its own first ``t_true[b]`` frames: (B, T, F, C, C), entries past a
    lane's frames unspecified.  At each frame the outer products of the
    2M+1 shifted spectra are summed into one accumulator in shift order
    (``frame_cov``'s sum, without its (..., M, F) product); then the
    temporal box of 2L+1 frames as the difference of a prefix sum over the
    frames, clamped at the lane's own first and last frame.  A prefix sum
    adds in frame order, so a lane's entries do not depend on the other
    lanes."""
    b, _, f, t = y.shape
    idx = collapse_index(f, m_nbr, y.device)
    z = y[:, :, idx, :].permute(0, 4, 1, 2, 3)      # (B, T, C, M, F)
    r = None
    for m in range(idx.shape[0]):
        zm = z[..., m, :]
        p = cmul_conj(zm[..., :, None, :], zm[..., None, :, :])
        r = p if r is None else r + p
    del z, p
    r = r.permute(0, 1, 4, 2, 3)                    # (B, T, F, C, C)
    if l_nbr > 0:
        tt = torch.as_tensor(t_true, device=y.device)
        ti = torch.arange(-l_nbr, t + l_nbr, device=y.device)[None]
        ti = torch.minimum(ti.clamp(min=0), (tt - 1)[:, None])
        pad = r[torch.arange(b, device=y.device)[:, None], ti]
        del r
        cs = torch.cat([torch.zeros_like(pad[:, :1]),
                        torch.cumsum(pad, dim=1)], dim=1)
        del pad
        r = cs[:, 2 * l_nbr + 1:] - cs[:, :t]
    return r


def _lane_divide(x: torch.Tensor, divisors: np.ndarray) -> torch.Tensor:
    """``cdiv_real(x[b], divisors[b])`` for each lane b of x (B, ...), each
    lane divided by its divisor as a number, as ``cdiv_real`` of one lane
    divides."""
    out = None
    for v in np.unique(divisors):
        part = cdiv_real(x, int(v))
        if out is None:
            out = part
        else:
            sel = torch.as_tensor(divisors == v, device=x.device)
            out = torch.where(sel.reshape((-1,) + (1,) * (x.dim() - 1)),
                              part, out)
    return out


def lane_ncov(covs: torch.Tensor, t_true: np.ndarray,
              p: PmwfParams) -> torch.Tensor:
    """Each lane's noise covariance (B, F, C, C) from covs (B, T, F, C, C):
    the sum of its first ``init_n_len`` frames (all of them when it has
    fewer), in frame order, over that count less one."""
    dev = covs.device
    n_init = np.minimum(p.init_n_len, t_true)
    ncov = covs[:, 0]
    for k in range(1, int(n_init.max())):
        on = torch.as_tensor(k < n_init, device=dev)[:, None, None, None]
        ncov = torch.where(on, ncov + covs[:, k], ncov)
    return _lane_divide(ncov, np.maximum(n_init - 1, 1))


def lane_filters(covs: torch.Tensor, t_true: np.ndarray,
                 p: PmwfParams) -> torch.Tensor:
    """The filter bank of each lane's blocks: covs (B, T, F, C, C) ->
    (B, NB, F, J, C) for NB = the longest lane's ``norm_period`` blocks.
    Each lane's Ncov is ``lane_ncov``'s; each block's Ycov the sum of its
    ``norm_period`` frames over ``norm_period`` - 1, a lane's last block
    filled with its last frame (PMWF_sep_event_RT_CHiME.m:117, :138: the
    reference's sum/(n-1) normalisation, which does not cancel through
    (Ncov+dI)^-1 Ecov/(beta+tr) because diag_load and beta are
    absolute)."""
    b, t = covs.shape[:2]
    dev = covs.device
    ncov = lane_ncov(covs, t_true, p)
    n_blocks = -(-t // p.norm_period)
    lanes = torch.arange(b, device=dev)[:, None]
    first = torch.arange(n_blocks, device=dev)[None] * p.norm_period
    last = torch.as_tensor(t_true - 1, device=dev)[:, None]
    ysum = covs[lanes, torch.minimum(first, last)]
    for j in range(1, p.norm_period):
        ysum = ysum + covs[lanes, torch.minimum(first + j, last)]
    ecov = cdiv_real(ysum, p.norm_period - 1) - ncov[:, None]
    return pmwf_filters(ncov[:, None].expand_as(ecov), ecov, p.beta,
                        p.diag_load)


class PmwfEnhancer:
    """Offline multichannel PMWF enhancement (on the card unless
    ``device`` names another): ``enhance`` one (C, n) utterance,
    ``enhance_batch`` many as the lanes of one plan (``run_lanes``), through
    the int16 host half the SNMF enhancer uses (``stream/batch_host``)."""

    # the share of the card's memory a chunk's lanes may take
    MEMORY_SHARE = 0.3

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
        self._batch_host = BatchHost(self.device, dtype,
                                     self.cfg.signal.frameshift,
                                     self.cfg.delay)

    def run_lanes(self, frames: torch.Tensor, t_true) -> torch.Tensor:
        """(B, C, T, framelength) frames, lane b's first ``t_true[b]`` its
        own -> (B, J, n) OLA waveforms (J = C, or 1 with ``ref_ch``).  A
        lane's samples over its own frames are those of the lane alone."""
        s, p = self.cfg.signal, self.params
        tt = np.asarray(t_true, np.int64).reshape(-1)
        t = frames.shape[2]
        y = analysis(frames.to(self.dtype), self.win, s,
                     self.cdtype).transpose(-1, -2)         # (B, C, F, T)
        h = lane_filters(lane_box_cov(y, tt, p.m_nbr, p.l_nbr), tt, p)
        block_idx = torch.clamp_max(
            torch.arange(t, device=frames.device) // p.norm_period,
            h.shape[1] - 1)
        h_t = h[:, block_idx]                               # (B,T,F,J,C)
        if p.ref_ch is not None:
            h_t = h_t[..., p.ref_ch: p.ref_ch + 1, :]
        d = apply_filters(h_t.permute(0, 1, 3, 4, 2),
                          y.permute(0, 3, 1, 2))            # (B, T, J, F)
        return overlap_add(synthesis(d.transpose(1, 2), self.win, s,
                                     self.dtype), s.frameshift)

    def run(self, frames: torch.Tensor) -> torch.Tensor:
        """(C, T, framelength) frames -> (C, n) OLA waveforms (one channel
        with ``ref_ch``)."""
        return self.run_lanes(frames[None], [frames.shape[1]])[0]

    def chunk_lanes(self, n_lanes: int, n_frames: int, n_ch: int) -> int:
        """Lanes a chunk, for ``n_lanes`` lanes of ``n_ch`` channels and up
        to ``n_frames`` frames: as many as keep a chunk's tensors (six
        (T, F, C, C) complex covariances a lane at their peak: 268 MB a
        lane of 6 channels and 351 frames, measured on an H100) within
        ``MEMORY_SHARE`` of the card, in chunks of equal size."""
        if self.device.type != "cuda":
            return n_lanes
        total = torch.cuda.get_device_properties(self.device).total_memory
        per_lane = 6 * n_frames * self.cfg.signal.n_bins * n_ch ** 2 \
            * torch.empty((), dtype=self.cdtype).element_size()
        cap = max(int(self.MEMORY_SHARE * total // per_lane), 1)
        n_chunks = -(-n_lanes // cap)
        return -(-n_lanes // n_chunks)

    @torch.no_grad()
    def enhance_batch(self, xs: list, quantize: bool = True,
                      micro_batch: int | None = None) -> list[np.ndarray]:
        """Enhance (C, n_i) multichannel utterances (int16 values, or any
        float samples) as lanes of the offline plan: each lane's output is
        ``enhance``'s on that lane alone, (C or 1, (n_i // hop + 1) * hop),
        int16 after the MATLAB int16 write with ``quantize``, else the
        float samples.  Samples cross the host as int16 (``BatchHost``);
        ``micro_batch`` lanes a chunk, None: as many as ``chunk_lanes``
        allows.  Traced: the ``batch.*`` spans and counters, and
        ``pmwf.cov_frames`` (lane-frames whose covariance was built) and
        ``pmwf.solves`` (per-bin Ncov solves: lanes x blocks x F)."""
        s = self.cfg.signal
        xs = [np.atleast_2d(np.asarray(x)) for x in xs]
        frames_true = np.asarray([x.shape[1] // s.frameshift for x in xs]) \
            + self.cfg.delay + 1
        if micro_batch is None:
            micro_batch = self.chunk_lanes(len(xs), int(frames_true.max()),
                                           xs[0].shape[0])
        n_blocks = -(-frames_true // self.params.norm_period)
        work = {"pmwf.cov_frames": int(frames_true.sum()),
                "pmwf.solves": int(n_blocks.sum()) * s.n_bins}

        def launch(smp, n_hops, t_true):
            frames = stream_frames_torch(smp, n_hops[:, None],
                                         s.framelength, s.frameshift)
            return self.run_lanes(frames, t_true)

        return self._batch_host.run(xs, launch,
                                    "int16" if quantize else "float",
                                    micro_batch, work)

    def enhance(self, x: np.ndarray, quantize: bool = True) -> np.ndarray:
        """x: (C, N) int16-scale multichannel samples -> (C or 1, N_out):
        ``enhance_batch`` of one lane."""
        return self.enhance_batch([x], quantize, micro_batch=1)[0]
