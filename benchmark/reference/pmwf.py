"""Plain reference of the offline PMWF beamformer with spectro-temporal
covariances, written from the reference's MATLAB (src/PSD_cov_mat.m,
src/PMWF_sep_event_RT_CHiME.m:120-177; Jin, Shin and Kim, IEEE SPL 2015)
with plain PyTorch operations and nothing else: no program code, no
kernel, no batching of lanes (one utterance at a time).

For each utterance of C channels:

* frames of 640 samples a 160-sample hop (the stream's queue: zeros before
  the start, the trailing partial hop dropped, ``delay + 1`` zero frames
  after), a periodic square-root Hann window, a 1,024-point DFT; the bins
  below ``dc_freq`` set to 0 and ``nonzerofloor`` added to every magnitude,
  the phase kept (``Y / |Y|``, 1 where Y is 0);
* at each frame t and bin f the spectro-temporal covariance
  R(t, f) = sum over dt in [-L, L] and df in [-M, M] of y y^H with
  y = Y(:, f + df, t + dt): the frames clamped to the utterance, and every
  shift of a bin within M of either edge taken at the bin itself
  (PSD_cov_mat.m:13-17);
* Ncov = the sum of R over the first ``init_n_len`` frames (all of them
  when there are fewer) over that count less one; for each block of
  ``norm_period`` frames (the last one filled with the last frame),
  Ycov = the block's sum over ``norm_period`` - 1 and Ecov = Ycov - Ncov
  (:117, :138);
* per bin and block, X = (Ncov + load I)^-1 Ecov and the filter bank
  X / (beta + trace X + 1e-9) (:148-165); output channel j of a frame is
  sum over c of conj(X[c, j]) Y[c] / (...), the column of channel j;
* the inverse DFT's first 640 samples, the window, 2 x hop / 640, the
  bins below ``dc_freq`` zeroed, overlap-add; the output from the delay
  on, (hops + 1) x hop samples a channel, written as MATLAB's
  ``fwrite(..., 'int16')`` (round half away from zero, saturate).

Departures from the MATLAB, each the program's too:

* the load on Ncov's diagonal is the reference's absolute ``diag_load``
  plus eps x trace(Ncov) / C, eps that of the working precision (coherent
  channels make Ncov near rank one, and the absolute load alone falls
  below float32's rounding);
* the solve here is ``torch.linalg.solve``; the program solves by an
  unrolled Cholesky factorisation (the same matrix, another rounding).

``offline(xs, config, bases, dtype=, device=)``: float64 is the reference;
``dtype=torch.bfloat16`` is the control that the comparison must reject:
the same computation in float32 with the spectra, the covariances and the
filters rounded to bfloat16 (each real part) between the stages (torch has
no complex bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Plan:
    """The sizes of a configuration file's ``signal`` and ``pmwf``
    sections."""

    def __init__(self, params: dict):
        s, p = params["signal"], params["pmwf"]
        self.flen = int(math.floor(s["wintime"] * s["fs"] + 0.5))
        self.shift = int(math.floor(s["hoptime"] * s["fs"] + 0.5))
        self.nfft = 1 << math.ceil(math.log2(self.flen))
        self.f = self.nfft // 2 + 1
        self.dc = int(math.floor(s["dc_freq"] / (s["fs"] / self.nfft) + 0.5))
        self.floor = float(s["nonzerofloor"])
        self.olap = 2.0 * self.shift / self.flen
        self.delay = 1 + int(math.floor(s["wintime"] / s["hoptime"] / 2
                                        + 0.5))
        self.beta, self.load = float(p["beta"]), float(p["diag_load"])
        self.m, self.l = int(p["m_nbr"]), int(p["l_nbr"])
        self.init, self.period = int(p["init_n_len"]), int(p["norm_period"])
        self.ref_ch = p["ref_ch"]


def _rounder(dtype):
    """The rounding between stages: none, or each real part to bfloat16."""
    if dtype != torch.bfloat16:
        return lambda z: z

    def rnd(z):
        if z.is_complex():
            return torch.complex(z.real.to(torch.bfloat16).float(),
                                 z.imag.to(torch.bfloat16).float())
        return z.to(torch.bfloat16).float()
    return rnd


def enhance_lane(x: np.ndarray, pl: Plan, dtype, device) -> torch.Tensor:
    """One utterance (C, n) -> its float output (C or 1, (hops + 1) x
    hop)."""
    rnd = _rounder(dtype)
    rdt = torch.float32 if dtype == torch.bfloat16 else dtype
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    eps = torch.finfo(rdt).eps
    x = torch.as_tensor(np.asarray(x, np.float64), dtype=rdt, device=device)
    c, n = x.shape
    hops = n // pl.shift
    t = hops + pl.delay + 1
    # frames: frame k holds samples [k hop - (flen - hop), k hop + hop)
    xp = torch.zeros((c, (t + 3) * pl.shift + pl.flen), dtype=rdt,
                     device=device)
    xp[:, pl.flen - pl.shift: pl.flen - pl.shift + hops * pl.shift] = \
        x[:, : hops * pl.shift]
    k = torch.arange(t, device=device)
    idx = k[:, None] * pl.shift + torch.arange(pl.flen, device=device)
    frames = xp[:, idx] * (k < hops)[None, :, None].to(rdt)     # (C, T, L)
    nn = torch.arange(pl.flen, device=device, dtype=torch.float64)
    win = torch.sqrt(0.5 * (1 - torch.cos(2 * math.pi * nn / pl.flen)))
    win = win.to(rdt)
    spec = torch.fft.rfft(frames * win, n=pl.nfft, dim=-1)      # (C, T, F)
    mag = spec.abs()
    phase = torch.where(mag > 0, spec / torch.where(mag > 0, mag, 1.0),
                        torch.ones((), dtype=cdt, device=device))
    mag = torch.where(torch.arange(pl.f, device=device) < pl.dc, 0.0, mag)
    y = rnd((mag + pl.floor) * phase)                            # (C, T, F)

    # spectro-temporal covariances R (T, F, C, C)
    bins = torch.arange(pl.f, device=device)
    inner = (bins >= pl.m) & (bins < pl.f - pl.m)
    s = torch.zeros((t, pl.f, c, c), dtype=cdt, device=device)
    for df in range(-pl.m, pl.m + 1):
        yf = y[:, :, torch.where(inner, bins + df, bins)]
        s = s + torch.einsum("ctf,dtf->tfcd", yf, yf.conj())
    r = torch.zeros_like(s)
    for dt in range(-pl.l, pl.l + 1):
        r = r + s[torch.clamp(k + dt, 0, t - 1)]
    r = rnd(r)

    n_init = min(pl.init, t)
    ncov = r[:n_init].sum(0) / max(n_init - 1, 1)                # (F, C, C)
    n_blocks = -(-t // pl.period)
    fill = torch.clamp(torch.arange(n_blocks * pl.period, device=device),
                       max=t - 1)
    ycov = r[fill].reshape(n_blocks, pl.period, pl.f, c, c).sum(1) \
        / (pl.period - 1)
    ecov = ycov - ncov
    load = pl.load + eps * torch.diagonal(ncov, dim1=-2, dim2=-1).real \
        .sum(-1) / c
    a = ncov + load[:, None, None] * torch.eye(c, dtype=cdt, device=device)
    xsol = torch.linalg.solve(a.expand(n_blocks, -1, -1, -1), ecov)
    lam = torch.diagonal(xsol, dim1=-2, dim2=-1).sum(-1)
    h = rnd(xsol / (pl.beta + lam + 1e-9)[..., None, None])    # (NB,F,C,J)

    hb = h[torch.clamp(k // pl.period, max=n_blocks - 1)]       # (T,F,C,J)
    d = torch.einsum("tfcj,ctf->jtf", hb.conj(), y)             # (J, T, F)
    if pl.ref_ch is not None:
        d = d[pl.ref_ch: pl.ref_ch + 1]
    d = torch.where(bins < pl.dc, torch.zeros((), dtype=cdt, device=device),
                    d)
    fr = torch.fft.irfft(d, n=pl.nfft, dim=-1)[..., : pl.flen] * win \
        * pl.olap                                               # (J, T, L)
    j = fr.shape[0]
    out = torch.zeros((j, (t - 1) * pl.shift + pl.flen), dtype=rdt,
                      device=device)
    for q in range(pl.flen // pl.shift):
        out[:, q * pl.shift: q * pl.shift + t * pl.shift] += \
            fr[..., q * pl.shift: (q + 1) * pl.shift].reshape(j, -1)
    start = pl.delay * pl.shift
    return out[:, start: start + (t - pl.delay) * pl.shift]


def written_int16(y: torch.Tensor) -> np.ndarray:
    """MATLAB's ``fwrite(..., 'int16')``: round half away from zero,
    saturate."""
    y = y.to(torch.float64).cpu().numpy()
    pcm = np.sign(y) * np.floor(np.abs(y) + 0.5)
    return np.clip(pcm, -32768, 32767).astype(np.int16)


def offline(xs: list, config: dict, bases=None, dtype=torch.float64,
            device="cpu") -> list[np.ndarray]:
    """Each (C, n) utterance's int16 output, (C or 1, (hops + 1) x hop),
    one utterance at a time."""
    del bases
    pl = Plan(config["algorithm"])
    before = torch.backends.cuda.matmul.allow_tf32
    if dtype != torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return [written_int16(enhance_lane(x, pl, dtype, device))
                for x in xs]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
