"""Plain reference of SNMF-NAT speech enhancement: both plans the benchmark
times, written from the algorithm's description with plain PyTorch
operations and nothing else (no kernel, no graph, no program code).

* the block-adaptive plan (K frames a block, one H-solve of the block at a
  fixed trip count, a per-frame gain scan, one W-only refit of the adapted
  noise columns at the block's end);
* the reference's per-frame SNMF-NAT (one H-solve a frame with its
  relative-cost stop, the gain, and a W-only refit of the adapted noise
  columns on every frame whose trigger fires).

Each loop of the harness calls its own entry point: ``offline`` (a batch
of utterances, either plan) and ``live`` (streams from their start, the
per-frame plan).

Both return the int16 PCM the reference's write chain stores: MATLAB's
``fwrite(..., 'int16')`` of the overlap-added samples, then ``wavwrite``
of that PCM over 32767.  Lanes are independent streams batched on a
leading axis.  Every function takes the dtype and device of its inputs:
float64 is the reference; float32 with TF32 products, or bfloat16, is the
control that the comparison must reject.

``config`` is a configuration file under ``benchmark/configs/`` that
names this module by its ``reference`` key.  The two
generators of the reference's initial state (MATLAB's legacy V4
``rand('seed', s)`` and its startup Mersenne Twister) are written out
below.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ------------------------------------------------------------ generators


def v4_rand(m: int, n: int, seed: int) -> np.ndarray:
    """MATLAB ``rand('seed', seed); rand(m, n)``: the Lehmer generator
    x <- 16807 x mod (2^31 - 1), filled column by column."""
    mod, x = 2 ** 31 - 1, int(seed) % (2 ** 31 - 1) or 1
    out = np.empty(m * n)
    for i in range(m * n):
        x = 16807 * x % mod
        out[i] = x / mod
    return out.reshape(n, m).T


def twister_rand(draws: list[tuple[int, int]], seed: int = 0):
    """MATLAB's Mersenne Twister from ``rng(seed)``: ``rand(m, n)`` for each
    (m, n) of ``draws`` in turn (53-bit doubles, column-major)."""
    n_st, mid = 624, 397
    mt = [0] * n_st
    mt[0] = seed & 0xFFFFFFFF
    for i in range(1, n_st):
        mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) \
            & 0xFFFFFFFF
    idx = n_st

    def word():
        nonlocal idx
        if idx >= n_st:
            for i in range(n_st):
                y = (mt[i] & 0x80000000) | (mt[(i + 1) % n_st] & 0x7FFFFFFF)
                mt[i] = mt[(i + mid) % n_st] ^ (y >> 1) ^ \
                    (0x9908B0DF if y & 1 else 0)
            idx = 0
        y = mt[idx]
        idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    outs = []
    for m, n in draws:
        vals = np.empty(m * n)
        for i in range(m * n):
            a, b = word() >> 5, word() >> 6
            vals[i] = (a * 67108864.0 + b) / 9007199254740992.0
        outs.append(vals.reshape(n, m).T)
    return outs


# ------------------------------------------------------------- constants

class Plan:
    """The derived sizes and the constant matrices of a configuration, in
    one dtype on one device."""

    def __init__(self, params: dict, dtype, device):
        s, nmf, sep = params["signal"], params["nmf"], params["sep"]
        ad, blk, en = params["adapt"], params["blk"], params["enhance"]
        self.fs = s["fs"]
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
        if s["preemph"] != 0.0 or nmf["cf"] != "kl" \
                or sep["b_sep_mode"] != "DFT" or sep["blk_len_sep"] != 1 \
                or sep["splice"] != 0 or sep["basis_update_n"] \
                or sep["basis_update_e"] or not ad["adapt_train_n"]:
            raise ValueError("the reference covers the DFT-domain KL plan "
                             "with online noise adaptation and no "
                             "pre-emphasis")
        self.r_x, self.r_d = sep["r_x"], sep["r_d"]
        self.r_a, self.m_a = ad["r_a"], ad["m_a"]
        self.init_n = ad["init_n_len"]
        self.ar_up = float(ad["ar_up"])
        self.period = max(int(math.floor(ad["overlap_m_a"] * ad["m_a"])), 1)
        self.sp = float(nmf["sparsity"])
        self.max_iter, self.eps = nmf["max_iter"], float(nmf["conv_eps"])
        self.seed = nmf["random_seed"]
        self.solve_flr = 1e-9
        self.alpha_d, self.alpha_eta = en["alpha_d"], en["alpha_eta"]
        self.eta_floor = en["eta_floor"]
        self.beta, self.beta_max = en["beta"], en["beta_max"]
        if en["method"] != "MMSE" or not blk["enabled"]:
            raise ValueError("the reference covers the MMSE gain with Q")
        self.p_k, self.p_l = blk["p_len_k"], blk["p_len_l"]
        self.alpha_p, self.gap = blk["alpha_p"], blk["blk_gap"]
        if self.gap < 3:
            raise ValueError("the reference covers blk_gap >= 3")
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
        r = self.r_x + self.r_d
        self.h0 = t(v4_rand(r, 1, self.seed))               # (R, 1)
        _, ad_blk = twister_rand([(self.r_d, 1), (self.r_a, self.m_a)])
        self.ad_blk0 = t(ad_blk)
        # Q: window centers, the band matrix and the map back to bins
        half = self.p_k // 2
        ks = np.arange(half + self.dc, self.f - half + 1, self.gap)
        fi = np.arange(self.f)[:, None]
        self.wf = t((fi >= ks - half) & (fi <= ks + half - 1))
        ci = np.clip(np.round((np.arange(self.f) - (ks[0] - 1)) / self.gap)
                     .astype(int), 0, len(ks) - 1)
        self.ci = torch.as_tensor(ci, device=device)
        self.covered = torch.as_tensor(
            np.abs(np.arange(self.f) - ks[ci] + 1) <= (self.gap - 1) // 2,
            device=device)
        self.sqrt_n = math.sqrt(self.p_k * self.p_l)


# ------------------------------------------------------------ transforms

def frames_of(x: torch.Tensor, n_hops, n_frames: int, p: Plan):
    """Frames (B, T, L) of samples x (B, S): frame t holds the samples of
    hops t-3..t (zeros before the start); frames at t >= n_hops (B,) are
    zero (the end-of-stream flush and padding)."""
    pad = p.flen - p.shift
    need = n_frames * p.shift + p.flen
    xp = torch.zeros((x.shape[0], need), dtype=x.dtype, device=x.device)
    xp[:, pad: pad + min(x.shape[1], need - pad)] = x[:, : need - pad]
    idx = (torch.arange(p.flen, device=x.device)[None, :]
           + p.shift * torch.arange(n_frames, device=x.device)[:, None])
    fr = xp[:, idx]
    live = torch.arange(n_frames, device=x.device)[None, :] \
        < torch.as_tensor(n_hops, device=x.device)[:, None]
    return fr * live[..., None].to(fr.dtype)


def analysis(frames: torch.Tensor, p: Plan):
    """(power spectra (..., F) with the DC bins zeroed and the floor added,
    real part, imaginary part)."""
    y = frames * p.win
    re, im = y @ p.dft_c, y @ p.dft_s
    mag = (re * re + im * im) ** (p.pow / 2.0)
    mag = torch.cat([torch.zeros_like(mag[..., : p.dc]), mag[..., p.dc:]],
                    dim=-1)
    return mag + p.flr, re, im


def synthesis(xm: torch.Tensor, re: torch.Tensor, im: torch.Tensor,
              p: Plan) -> torch.Tensor:
    """Enhanced spectra with the noisy phase -> windowed frames (..., L)."""
    amp = xm ** (1.0 / p.pow)
    amp = torch.cat([torch.zeros_like(amp[..., : p.dc]), amp[..., p.dc:]],
                    dim=-1)
    r2 = re * re + im * im
    nz = r2 > 0
    inv = torch.where(nz, 1.0 / torch.sqrt(torch.where(nz, r2, 1.0)), 0.0)
    cos = torch.where(nz, re * inv, 1.0)
    sin = im * inv
    y = (amp * cos) @ p.idft_c + (amp * sin) @ p.idft_s
    return y * p.win * p.olap


def overlap_add(frames: torch.Tensor, p: Plan) -> torch.Tensor:
    """(B, T, L) -> (B, (T - 1) * shift + L)."""
    b, t, n = frames.shape
    out = torch.zeros((b, (t - 1) * p.shift + n), dtype=frames.dtype,
                      device=frames.device)
    for c in range(n // p.shift):
        seg = frames[..., c * p.shift: (c + 1) * p.shift].reshape(b, -1)
        out[:, c * p.shift: c * p.shift + t * p.shift] += seg
    return out


def written_int16(y: torch.Tensor) -> np.ndarray:
    """``fwrite(..., 'int16')`` then ``wavwrite(pcm / 32767)``: both round
    half away from zero and saturate."""
    y = y.to(torch.float64).cpu().numpy()
    pcm = np.clip(np.sign(y) * np.floor(np.abs(y) + 0.5), -32768, 32767)
    z = pcm / 32767.0 * 32768.0
    return np.clip(np.sign(z) * np.floor(np.abs(z) + 0.5), -32768,
                   32767).astype(np.int16)


# --------------------------------------------------------------- solvers

CHECK_EVERY = 4     # trips between the host's looks at whether any column
#                     still runs: a stopped column is frozen by a select, so
#                     trips past its stop change nothing

def _unit_columns(w: torch.Tensor):
    n = torch.sqrt(torch.sum(w * w, dim=-2))
    return w / torch.where(n > 0, n, 1.0)[..., None, :], n


def h_solve(v, w, p: Plan, trips: int, eps: float):
    """KL sparse-NMF activations of v (B, F, N) over w (B, F, R), W held:
    every column from the V4 seed column scaled by W's column norms, W
    normalised; each column stops on its own when its cost moves by less
    than ``eps`` relatively (eps = 0: ``trips`` trips)."""
    flr, sp = p.solve_flr, p.sp
    v = torch.clamp(v, min=flr)
    w, wn = _unit_columns(w)
    h = p.h0[None] * wn[..., None]
    h = h.expand(-1, -1, v.shape[-1]).contiguous()
    wt = w.transpose(-1, -2)
    lam = torch.clamp(w @ h, min=flr)
    den = torch.clamp(torch.sum(w, dim=-2)[..., None] + sp, min=flr)
    run = torch.ones(v.shape[0], v.shape[-1], dtype=torch.bool,
                     device=v.device)
    last = None
    for it in range(trips):
        if eps > 0 and it % CHECK_EVERY == 0 and not bool(run.any()):
            break
        h = torch.where(run[:, None, :], h * (wt @ (v / lam)) / den, h)
        lam = torch.clamp(w @ h, min=flr)
        if eps > 0:
            cost = torch.sum(v * torch.log(v / lam) - v + lam, dim=-2) \
                + sp * torch.sum(h, dim=-2)
            if it > 0:
                run = run & ~(torch.abs(cost - last) / torch.abs(last) < eps)
            last = cost
    return h


def w_refit(v, w0, h, active, p: Plan, trips: int, eps: float):
    """KL W-only refit of v (B, F, M) with activations h (B, R, M) held:
    each lane whose ``active`` is set runs the tangent-corrected
    multiplicative update with unit columns until its cost moves by less
    than ``eps`` relatively or ``trips`` trips have run."""
    flr = p.solve_flr
    v = torch.clamp(v, min=flr)
    w, wn = _unit_columns(w0)
    h = h * wn[..., None]
    lam = torch.clamp(w @ h, min=flr)
    sumh = torch.sum(h, dim=-1)                                  # (B, R)
    pen = p.sp * torch.sum(h, dim=(-2, -1))
    run = active.clone()
    last = torch.full(run.shape, math.inf, dtype=v.dtype, device=v.device)
    for it in range(trips):
        if it % CHECK_EVERY == 0 and not bool(run.any()):
            break
        c = (v / lam) @ h.transpose(-1, -2)                      # (B, F, R)
        dpw = sumh[:, None, :] + torch.sum(c * w, dim=-2)[:, None, :] * w
        dmw = c + (sumh * torch.sum(w, dim=-2))[:, None, :] * w
        w2, _ = _unit_columns(w * dmw / torch.clamp(dpw, min=flr))
        lam2 = torch.clamp(w2 @ h, min=flr)
        sel = run[:, None, None]
        w, lam = torch.where(sel, w2, w), torch.where(sel, lam2, lam)
        cost = torch.sum(v * torch.log(v / lam2) - v + lam2,
                         dim=(-2, -1)) + pen
        done = (torch.abs(cost - last) / torch.abs(last) < eps) & (it > 0)
        last = torch.where(run, cost, last)
        run = run & ~done
    return w


def merge_head(head, w_new, r_up, refit):
    """Refit columns replace their old ones, then the refit columns move to
    the end of the head in their order (the reference's rebuild of the
    noise dictionary as [kept, refit])."""
    merged = torch.where(r_up[:, None, :], w_new, head)
    order = torch.argsort(r_up.to(torch.int32), dim=-1, stable=True)
    merged = torch.gather(merged, -1,
                          order[:, None, :].expand(-1, head.shape[1], -1))
    return torch.where(refit[:, None, None], merged, head)


# -------------------------------------------------------------------- Q

def q_stat(ring: torch.Tensor, l: int, p: Plan) -> torch.Tensor:
    """The local block sparsity Q (B, F) of the SNR ring (B, F, P) at frame
    number l (1-based): 0.1 until the ring has filled, then
    alpha_p * 0.1 + (1 - alpha_p) * Hoyer(window) a centre, spread to the
    bins around each centre, the low bins copied from bin P_len_k + dc."""
    b = ring.shape[0]
    q0 = torch.full((b, p.f), 0.1, dtype=ring.dtype, device=ring.device)
    q0[:, : p.dc] = 0.0
    if l <= p.p_l:
        return q0
    l1 = torch.sum(ring, dim=-1) @ p.wf
    l2 = torch.sqrt(torch.sum(ring * ring, dim=-1) @ p.wf)
    ratio = torch.nan_to_num(l1 / l2, nan=p.sqrt_n)
    pv = p.alpha_p * 0.1 + (1 - p.alpha_p) * (p.sqrt_n - ratio) \
        / (p.sqrt_n - 1)
    q = torch.where(p.covered, pv[:, p.ci], 0.1)
    at = p.p_k + p.dc - 1
    q[:, : p.p_k - 1] = q[:, at: at + 1]
    q[:, : p.dc] = 0.0
    return q


def snr_col(xm, dm, p: Plan):
    snr = xm / torch.clamp(dm, min=p.flr)
    peak = torch.amax(snr, dim=-1, keepdim=True)
    return snr / torch.where(peak > 0, peak, 1.0)


def _shift(ring, col, on):
    """Push col (B, rows) into the rings (B, rows, m) of the lanes ``on``."""
    new = torch.cat([ring[..., 1:], col[..., None]], dim=-1)
    return torch.where(on[:, None, None], new, ring)


# ---------------------------------------------------------------- state

class State:
    """Per-lane streaming state (B lanes) as the reference starts a stream
    (``init_buff.m``), and a count of the refits that ran."""

    def __init__(self, bd: torch.Tensor, n_lanes: int, p: Plan):
        def rep(a):
            return a[None].expand((n_lanes,) + a.shape).clone()
        z = torch.zeros((n_lanes, p.f), dtype=p.dtype, device=p.device)
        self.head = rep(bd[:, : p.r_a])
        self.lam_dav, self.xm_prev = z.clone(), z.clone()
        self.ring_q = torch.zeros((n_lanes, p.f, p.p_l), dtype=p.dtype,
                                  device=p.device)
        self.ring_d = torch.zeros((n_lanes, p.f, p.m_a), dtype=p.dtype,
                                  device=p.device)
        self.ring_a = rep(p.ad_blk0)
        self.switch = torch.ones(n_lanes, dtype=torch.int64, device=p.device)
        self.refits = 0


def _gain(ym, xm, dm, q, ad, ax, l, st: State, p: Plan):
    """One frame's noise PSD, MMSE gain and enhanced spectrum; returns
    (xm_tilde, gain, lam_dav, a_x_mag as gated)."""
    lam = ym if l == 1 else st.lam_dav
    ratio = torch.nan_to_num(ad / ax, nan=1.0)
    bias = torch.clamp(20.0 * torch.log10(ratio) * p.beta, p.beta,
                       p.beta_max)
    lam = p.alpha_d * lam + (1 - p.alpha_d) * dm * bias[:, None]
    if l <= p.init_n:
        gain = torch.full_like(ym, p.flr)
        ax = torch.full_like(ax, p.flr)
    else:
        eta = (p.alpha_eta * st.xm_prev + (1 - p.alpha_eta) * xm * q) \
            / torch.clamp(lam, min=p.flr)
        eta = torch.clamp(eta, min=p.eta_floor)
        gain = torch.clamp(eta / (eta + 1.0), max=1.0)
    return gain * ym, gain, lam, ax


def _noise_ref(ym, gain, l, p: Plan):
    if l <= p.init_n:
        return ym
    m = 1.0 - gain
    m[:, : p.dc] = p.flr
    return ym * m


def _run_frames(mag, st: State, bx, bd, p: Plan, n_valid):
    """The per-frame plan over spectra (B, T, F), frames numbered 1 .. T;
    lane frames past ``n_valid`` (B,) leave its state alone.
    Returns the enhanced spectra (B, T, F)."""
    b, t_all, _ = mag.shape
    r_x = p.r_x
    out = torch.zeros_like(mag)
    valid = torch.as_tensor(n_valid, device=mag.device)
    for i in range(t_all):
        l = i + 1
        ok = valid >= i + 1
        ym = mag[:, i]
        w = torch.cat([bx[None].expand(b, -1, -1), st.head,
                       bd[None, :, p.r_a:].expand(b, -1, -1)], dim=-1)
        a = h_solve(ym[..., None], w, p, p.max_iter, p.eps)[..., 0]
        xm = (w[..., :r_x] @ a[:, :r_x, None])[..., 0]
        dm = (w[..., r_x:] @ a[:, r_x:, None])[..., 0]
        ring_q = torch.cat([st.ring_q[..., 1:], snr_col(xm, dm, p)[..., None]],
                           dim=-1)
        q = q_stat(ring_q, l, p)
        ad = torch.sum(a[:, r_x:], dim=-1) / p.r_d
        ax = torch.sum(a[:, :r_x], dim=-1) / r_x
        xt, gain, lam, ax = _gain(ym, xm, dm, q, ad, ax, l, st, p)
        qc = (1.0 - torch.mean(q, dim=-1)) * p.ar_up
        trig = (qc * ad > ax) & ok
        ring_d = _shift(st.ring_d, _noise_ref(ym, gain, l, p), trig)
        ring_a = _shift(st.ring_a, a[:, r_x: r_x + p.r_a], trig)
        r_up = qc[:, None] * torch.mean(ring_a, dim=-1) > ax[:, None]
        refit = trig & (st.switch == p.period)
        n_refit = int(refit.sum())
        if n_refit:
            st.refits += n_refit
            upf = r_up.to(mag.dtype)
            w_new = w_refit(ring_d, st.head * upf[:, None, :],
                            ring_a * upf[..., None], refit, p, p.max_iter,
                            p.eps)
            st.head = merge_head(st.head, w_new, r_up, refit)
        st.switch = torch.where(trig, torch.where(st.switch == p.period, 1,
                                                  st.switch + 1), st.switch)
        st.ring_d, st.ring_a = ring_d, ring_a
        okc = ok[:, None]
        st.ring_q = torch.where(okc[..., None], ring_q, st.ring_q)
        st.lam_dav = torch.where(okc, lam, st.lam_dav)
        st.xm_prev = torch.where(okc, xt, st.xm_prev)
        out[:, i] = torch.where(okc, xt, 0.0)
    return out


def _run_blocks(mag, st: State, bx, bd, p: Plan, n_valid, k_block: int,
                h_trips: int, w_trips: int):
    """The block-adaptive plan over spectra (B, T, F), T a multiple of K:
    each block's H-solve with the dictionary of the block's start, the
    frames' gains in order, the triggered frames pushed into the rings,
    one refit at the block's end.  Returns the enhanced spectra."""
    b, t_all, _ = mag.shape
    r_x = p.r_x
    out = torch.zeros_like(mag)
    valid = torch.as_tensor(n_valid, device=mag.device)
    for b0 in range(0, t_all, k_block):
        blk = mag[:, b0: b0 + k_block]                          # (B, K, F)
        w = torch.cat([bx[None].expand(b, -1, -1), st.head,
                       bd[None, :, p.r_a:].expand(b, -1, -1)], dim=-1)
        a = h_solve(blk.transpose(-1, -2), w, p, h_trips, 0.0)  # (B, R, K)
        xm = (w[..., :r_x] @ a[:, :r_x]).transpose(-1, -2)
        dm = (w[..., r_x:] @ a[:, r_x:]).transpose(-1, -2)
        any_refit = torch.zeros(b, dtype=torch.bool, device=mag.device)
        qc_last = torch.zeros(b, dtype=mag.dtype, device=mag.device)
        ax_last = torch.full((b,), p.flr, dtype=mag.dtype, device=mag.device)
        for k in range(k_block):
            l = b0 + k + 1
            ok = valid >= l
            okc = ok[:, None]
            ym = blk[:, k]
            ring_q = torch.cat([st.ring_q[..., 1:],
                                snr_col(xm[:, k], dm[:, k], p)[..., None]],
                               dim=-1)
            q = q_stat(ring_q, l, p)
            ad = torch.sum(a[:, r_x:, k], dim=-1) / p.r_d
            ax = torch.sum(a[:, :r_x, k], dim=-1) / r_x
            xt, gain, lam, ax = _gain(ym, xm[:, k], dm[:, k], q, ad, ax, l,
                                      st, p)
            qc = (1.0 - torch.mean(q, dim=-1)) * p.ar_up
            trig = (qc * ad > ax) & ok
            st.ring_d = _shift(st.ring_d, _noise_ref(ym, gain, l, p), trig)
            st.ring_a = _shift(st.ring_a, a[:, r_x: r_x + p.r_a, k], trig)
            due = trig & (st.switch == p.period)
            st.switch = torch.where(trig, torch.where(due, 1, st.switch + 1),
                                    st.switch)
            qc_last = torch.where(due, qc, qc_last)
            ax_last = torch.where(due, ax, ax_last)
            any_refit = any_refit | due
            st.ring_q = torch.where(okc[..., None], ring_q, st.ring_q)
            st.lam_dav = torch.where(okc, lam, st.lam_dav)
            st.xm_prev = torch.where(okc, xt, st.xm_prev)
            out[:, b0 + k] = torch.where(okc, xt, 0.0)
        r_up = qc_last[:, None] * torch.mean(st.ring_a, dim=-1) \
            > ax_last[:, None]
        n_refit = int(any_refit.sum())
        if n_refit:
            st.refits += n_refit
            upf = r_up.to(mag.dtype)
            w_new = w_refit(st.ring_d, st.head * upf[:, None, :],
                            st.ring_a * upf[..., None], any_refit, p,
                            w_trips, p.eps)
            st.head = merge_head(st.head, w_new, r_up, any_refit)
    return out


# ---------------------------------------------------------------- plans

def _bases(bases, p: Plan):
    bx, bd = bases
    return (torch.as_tensor(bx, dtype=p.dtype, device=p.device),
            torch.as_tensor(bd, dtype=p.dtype, device=p.device))


def offline(xs: list[np.ndarray], config: dict, bases,
            dtype=torch.float64, device="cpu") -> list[np.ndarray]:
    """Offline utterances through a configuration file's plan, as one
    batch: each utterance's hops, then ``delay + 1`` zero frames; the
    block-adaptive plan in blocks of ``block_adapt`` frames from the first
    where the file's ``program`` section sets it, else the per-frame plan.
    Returns each utterance's int16 output ((hops + 1) * shift samples)."""
    p = Plan(config["algorithm"], dtype, device)
    plan = config["program"]
    k_block = plan.get("block_adapt", 0)
    n_hops = np.asarray([len(x) // p.shift for x in xs])
    t_true = n_hops + p.delay + 1
    t_all = int(t_true.max())
    if k_block:
        t_all = -(-t_all // k_block) * k_block
    smp = np.zeros((len(xs), int(n_hops.max()) * p.shift))
    for i, x in enumerate(xs):
        smp[i, : n_hops[i] * p.shift] = np.asarray(x)[: n_hops[i] * p.shift]
    x_t = torch.as_tensor(smp, dtype=dtype, device=device)
    mag, re, im = analysis(frames_of(x_t, n_hops, t_all, p), p)
    bx, bd = _bases(bases, p)
    st = State(bd, len(xs), p)
    if k_block:
        h_trips = min(p.max_iter, plan["block_iter_cap"])
        xm = _run_blocks(mag, st, bx, bd, p, t_true, k_block, h_trips,
                         min(h_trips, plan["block_refit_cap"]))
    else:
        xm = _run_frames(mag, st, bx, bd, p, t_true)
    y = overlap_add(synthesis(xm, re, im, p), p)
    start = p.delay * p.shift
    return [written_int16(y[i, start: start + (int(t_true[i]) - p.delay)
                            * p.shift]) for i in range(len(xs))]


def live(x: np.ndarray, n_frames: int, config: dict, bases,
         dtype=torch.float64, device="cpu") -> tuple[np.ndarray, int]:
    """Live streams through a configuration file's per-frame plan from the
    stream's start: lanes of samples x (B, S), S >= n_frames * shift,
    pushed hop by hop into a queue of zeros, for frames 1 .. n_frames.
    Returns the int16 hops those frames emit, (B, (n_frames - delay) *
    shift), and the number of (lane, frame) refits that ran."""
    if config["program"].get("block_adapt"):
        raise ValueError("the reference runs live streams of the per-frame "
                         "plan only")
    p = Plan(config["algorithm"], dtype, device)
    x_t = torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                          device=device)
    n_hops = np.full(x_t.shape[0], n_frames)
    mag, re, im = analysis(frames_of(x_t, n_hops, n_frames, p), p)
    bx, bd = _bases(bases, p)
    st = State(bd, x_t.shape[0], p)
    xm = _run_frames(mag, st, bx, bd, p, n_hops)
    y = overlap_add(synthesis(xm, re, im, p), p)
    return (written_int16(y[:, p.delay * p.shift: n_frames * p.shift]),
            st.refits)
