"""Plain reference of sparse-NMF speech enhancement on fixed dictionaries:
the reference's non-adaptive baselines (its Exemplar and SNMF settings
files), written from the algorithm's description with plain PyTorch
operations and nothing else (no kernel, no graph, no program code).

Per frame of each utterance:

* analysis: the frame's pre-emphasis (y[k] = x[k] - a x[k-1] inside the
  frame, y[0] = x[0]), the periodic square-root Hann window, the power
  spectrum with the bins below the DC cut zeroed and the floor added;
* the KL sparse H-solve on the fixed dictionary [B_x B_d], W's columns
  normalised and H started from the reference's seeded MATLAB V4 column
  scaled by W's column norms; each column stops on its own when its cost
  moves by less than ``conv_eps`` relatively, or at the cap ``max_iter``;
* the speech and noise reconstructions B_x H_x and B_d H_d, the Wiener gain
  min(X / (X + D), 1) (0 where both underflow to 0), the noise floor as the
  gain of the first ``init_n_len`` frames;
* synthesis with the noisy phase (the bins below the DC cut zeroed), the
  window, the frame's de-emphasis (y[k] = x[k] + a y[k-1]) and the overlap
  scale; overlap-add; the int16 PCM the reference's write chain stores.

Departures from the reference's MATLAB, each inert for the output: every
frame of a batch is solved as one column of one product (the columns do
not interact); a stopped column is frozen by a select and the host looks
whether any column still runs every few trips, so trips past a column's
stop change nothing; the enhancement's ``beta`` (the noise-bias floor) is
carried by the configuration but read by no part of the Wiener output,
since in the reference it enters only the noise PSD that the MMSE gain
reads.

The frame, overlap-add and int16 helpers and the V4 generator are those of
``snmf_nat``.  Every function takes the dtype and device of its inputs:
float64 is the reference; float32 with TF32 products, or bfloat16, is the
control that the comparison must reject.  ``config`` is a configuration
file under ``benchmark/configs/`` that names this module by its
``reference`` key.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.snmf_nat import (
    CHECK_EVERY, frames_of, overlap_add, v4_rand, written_int16)


class Plan:
    """The derived sizes and the constant matrices of a configuration, in
    one dtype on one device."""

    def __init__(self, params: dict, dtype, device):
        s, nmf, sep = params["signal"], params["nmf"], params["sep"]
        ad, blk, en = params["adapt"], params["blk"], params["enhance"]
        if nmf["cf"] != "kl" or sep["b_sep_mode"] != "DFT" \
                or sep["blk_len_sep"] != 1 or sep["splice"] != 0 \
                or sep["basis_update_n"] or sep["basis_update_e"] \
                or ad["adapt_train_n"] or blk["enabled"] \
                or en["method"] != "Wiener":
            raise ValueError("the reference covers the DFT-domain KL plan on "
                             "fixed dictionaries with the Wiener gain")
        self.flen = int(math.floor(s["wintime"] * s["fs"] + 0.5))
        self.shift = int(math.floor(s["hoptime"] * s["fs"] + 0.5))
        self.nfft = 1 << math.ceil(math.log2(self.flen))
        self.f = self.nfft // 2 + 1
        self.pow = float(s["pow"])
        self.flr = float(s["nonzerofloor"])
        self.dc = int(math.floor(s["dc_freq"] / (s["fs"] / self.nfft) + 0.5))
        self.olap = 2.0 * self.shift / self.flen
        self.delay = 1 + int(math.floor(s["wintime"] / s["hoptime"] / 2
                                        + 0.5))
        self.a = float(s["preemph"])
        self.r_x, self.r_d = sep["r_x"], sep["r_d"]
        self.init_n = ad["init_n_len"]
        self.sp = float(nmf["sparsity"])
        self.max_iter, self.eps = nmf["max_iter"], float(nmf["conv_eps"])
        self.solve_flr = 1e-9
        self.dtype, self.device = dtype, device

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        n = np.arange(self.flen)
        self.win = t(np.sqrt(0.5 * (1.0 - np.cos(2 * np.pi * n / self.flen))))
        k = np.arange(self.f)
        ang = 2 * np.pi * np.outer(n, k) / self.nfft        # (L, F)
        self.dft_c, self.dft_s = t(np.cos(ang)), t(-np.sin(ang))
        wk = np.full(self.f, 2.0)
        wk[0] = wk[-1] = 1.0
        self.idft_c = t(wk[:, None] * np.cos(ang.T) / self.nfft)
        self.idft_s = t(-wk[:, None] * np.sin(ang.T) / self.nfft)
        # pre-emphasis (I - a S) and de-emphasis (its inverse, a^(k-j) below
        # the diagonal) as (L, L) products on a frame's row
        self.pre = t(np.eye(self.flen) - self.a * np.eye(self.flen, k=1))
        kk = n[:, None] - n[None, :]
        self.de = t(np.where(kk >= 0, self.a ** np.maximum(kk, 0), 0.0).T)
        self.h0 = t(v4_rand(self.r_x + self.r_d, 1, nmf["random_seed"]))


def analysis(frames: torch.Tensor, p: Plan):
    """(power spectra (..., F) with the DC bins zeroed and the floor added,
    real part, imaginary part) of the pre-emphasised, windowed frames."""
    y = (frames @ p.pre) * p.win
    re, im = y @ p.dft_c, y @ p.dft_s
    mag = (re * re + im * im) ** (p.pow / 2.0)
    mag = torch.cat([torch.zeros_like(mag[..., : p.dc]), mag[..., p.dc:]],
                    dim=-1)
    return mag + p.flr, re, im


def synthesis(xm: torch.Tensor, re: torch.Tensor, im: torch.Tensor,
              p: Plan) -> torch.Tensor:
    """Enhanced spectra with the noisy phase -> windowed, de-emphasised
    frames (..., L)."""
    amp = xm ** (1.0 / p.pow)
    amp = torch.cat([torch.zeros_like(amp[..., : p.dc]), amp[..., p.dc:]],
                    dim=-1)
    r2 = re * re + im * im
    nz = r2 > 0
    inv = torch.where(nz, 1.0 / torch.sqrt(torch.where(nz, r2, 1.0)), 0.0)
    cos = torch.where(nz, re * inv, 1.0)
    sin = im * inv
    y = ((amp * cos) @ p.idft_c + (amp * sin) @ p.idft_s) * p.win
    return (y @ p.de) * p.olap


def h_solve(v: torch.Tensor, w: torch.Tensor, p: Plan) -> torch.Tensor:
    """KL sparse-NMF activations (R, N) of the columns v (F, N) over the
    fixed w (F, R): W normalised, every column from the V4 seed column
    scaled by W's column norms, each stopping on its own when its cost moves
    by less than ``eps`` relatively, at most ``max_iter`` updates."""
    flr, sp = p.solve_flr, p.sp
    v = torch.clamp(v, min=flr)
    norm = torch.sqrt(torch.sum(w * w, dim=0))
    w = w / torch.where(norm > 0, norm, 1.0)[None, :]
    h = (p.h0 * norm[:, None]).expand(-1, v.shape[1]).contiguous()
    wt = w.T
    lam = torch.clamp(w @ h, min=flr)
    den = torch.clamp(torch.sum(w, dim=0)[:, None] + sp, min=flr)
    run = torch.ones(v.shape[1], dtype=torch.bool, device=v.device)
    last = None
    for it in range(p.max_iter):
        if p.eps > 0 and it % CHECK_EVERY == 0 and not bool(run.any()):
            break
        h = torch.where(run[None, :], h * (wt @ (v / lam)) / den, h)
        lam = torch.clamp(w @ h, min=flr)
        if p.eps > 0:
            cost = torch.sum(v * torch.log(v / lam) - v + lam, dim=0) \
                + sp * torch.sum(h, dim=0)
            if it > 0:
                run = run & ~(torch.abs(cost - last) / torch.abs(last)
                              < p.eps)
            last = cost
    return h


def offline(xs: list[np.ndarray], config: dict, bases,
            dtype=torch.float64, device="cpu") -> list[np.ndarray]:
    """Offline utterances through a configuration file's plan, as one
    batch: each utterance's hops, then ``delay + 1`` zero frames.  Returns
    each utterance's int16 output ((hops + 1) * shift samples)."""
    p = Plan(config["algorithm"], dtype, device)
    n_hops = np.asarray([len(x) // p.shift for x in xs])
    t_true = n_hops + p.delay + 1
    t_all = int(t_true.max())
    smp = np.zeros((len(xs), int(n_hops.max()) * p.shift))
    for i, x in enumerate(xs):
        smp[i, : n_hops[i] * p.shift] = np.asarray(x)[: n_hops[i] * p.shift]
    x_t = torch.as_tensor(smp, dtype=dtype, device=device)
    mag, re, im = analysis(frames_of(x_t, n_hops, t_all, p), p)  # (B, T, F)
    bx, bd = (torch.as_tensor(b, dtype=dtype, device=device) for b in bases)
    b, t = mag.shape[:2]
    h = h_solve(mag.reshape(b * t, -1).T, torch.cat([bx, bd], dim=1), p)
    xm = (bx @ h[: p.r_x]).T.reshape(b, t, -1)
    dm = (bd @ h[p.r_x:]).T.reshape(b, t, -1)
    gain = torch.clamp(torch.nan_to_num(xm / (xm + dm), nan=0.0), max=1.0)
    gain[:, : p.init_n] = p.flr
    y = overlap_add(synthesis(gain * mag, re, im, p), p)
    start = p.delay * p.shift
    return [written_int16(y[i, start: start + (int(t_true[i]) - p.delay)
                            * p.shift]) for i in range(len(xs))]
