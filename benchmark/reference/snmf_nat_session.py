"""Plain reference of SNMF-NAT served live in blocks: each lane a stream
from its first sample, its frames numbered from 1 and run in blocks of K
frames from frame 1 (K the configuration's ``session.block_frames``), as
the block-adaptive serving fleet runs every lane, written with plain
PyTorch operations and nothing else (no kernel, no graph, no program code).

A block: one H-solve of its K columns with the dictionary of the block's
start, each column stopping on its own when its cost moves by less than
``nmf.conv_eps`` relatively, within ``program.block_iter_cap`` trips; the
frames' gains in order; the triggered frames pushed into the rings; one
W-only refit of the adapted noise columns at the block's end on the lanes
where a frame scheduled one, with the same cap and stop.

This is ``snmf_nat._run_blocks`` with these departures:

* the H-solve stops column by column at the relative-cost stop within the
  cap, where ``_run_blocks`` runs a fixed trip count: a session's block
  step takes the iteration cap only (no fixed trips);
* the refit runs under the same cap (no refit cap of its own) and with
  the same stop as ``_run_blocks``'s;
* every frame of every lane is a true frame: a live stream has no padding
  and no end, so no lane's frames are masked;
* K is the session's block, not ``program.block_adapt`` (the offline
  plan's, which a session does not run); ``n_frames`` is a whole number
  of blocks.

The entry point ``live`` returns the int16 PCM the reference's write chain
stores, as ``snmf_nat.live`` does; every helper it calls is
``snmf_nat``'s.  Every function takes the dtype and device of its inputs:
float64 is the reference; float32 with TF32 products, or bfloat16, is the
control that the comparison must reject.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.snmf_nat import (
    Plan, State, _bases, _gain, _noise_ref, _shift, analysis, frames_of,
    h_solve, merge_head, overlap_add, q_stat, snr_col, synthesis, w_refit,
    written_int16)


def _run_blocks(mag, st: State, bx, bd, p: Plan, k_block: int, trips: int):
    """The session's blocks over spectra (B, T, F), T a multiple of K,
    frames numbered 1 .. T.  Returns the enhanced spectra (B, T, F)."""
    b, t_all, _ = mag.shape
    r_x = p.r_x
    out = torch.zeros_like(mag)
    for b0 in range(0, t_all, k_block):
        blk = mag[:, b0: b0 + k_block]                          # (B, K, F)
        w = torch.cat([bx[None].expand(b, -1, -1), st.head,
                       bd[None, :, p.r_a:].expand(b, -1, -1)], dim=-1)
        a = h_solve(blk.transpose(-1, -2), w, p, trips, p.eps)  # (B, R, K)
        xm = (w[..., :r_x] @ a[:, :r_x]).transpose(-1, -2)
        dm = (w[..., r_x:] @ a[:, r_x:]).transpose(-1, -2)
        any_refit = torch.zeros(b, dtype=torch.bool, device=mag.device)
        qc_last = torch.zeros(b, dtype=mag.dtype, device=mag.device)
        ax_last = torch.full((b,), p.flr, dtype=mag.dtype, device=mag.device)
        for k in range(k_block):
            l = b0 + k + 1
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
            trig = qc * ad > ax
            st.ring_d = _shift(st.ring_d, _noise_ref(ym, gain, l, p), trig)
            st.ring_a = _shift(st.ring_a, a[:, r_x: r_x + p.r_a, k], trig)
            due = trig & (st.switch == p.period)
            st.switch = torch.where(trig, torch.where(due, 1, st.switch + 1),
                                    st.switch)
            qc_last = torch.where(due, qc, qc_last)
            ax_last = torch.where(due, ax, ax_last)
            any_refit = any_refit | due
            st.ring_q, st.lam_dav, st.xm_prev = ring_q, lam, xt
            out[:, b0 + k] = xt
        r_up = qc_last[:, None] * torch.mean(st.ring_a, dim=-1) \
            > ax_last[:, None]
        n_refit = int(any_refit.sum())
        if n_refit:
            st.refits += n_refit
            upf = r_up.to(mag.dtype)
            w_new = w_refit(st.ring_d, st.head * upf[:, None, :],
                            st.ring_a * upf[..., None], any_refit, p,
                            trips, p.eps)
            st.head = merge_head(st.head, w_new, r_up, any_refit)
    return out


def live(x: np.ndarray, n_frames: int, config: dict, bases,
         dtype=torch.float64, device="cpu",
         block_frames: int | None = None) -> tuple[np.ndarray, int]:
    """Live streams through a configuration file's session blocks from the
    stream's start: lanes of samples x (B, S), S >= n_frames * shift,
    pushed hop by hop into a queue of zeros, for frames 1 .. n_frames, a
    whole number of blocks.  ``block_frames``, the block the program ran
    at, must be the configuration's (None: the configuration's).
    Returns the int16 hops those frames emit, (B, (n_frames - delay) *
    shift), and the number of (lane, block) refits that ran."""
    k_block = int(config["session"]["block_frames"])
    if block_frames is not None and int(block_frames) != k_block:
        raise ValueError(f"the configuration's session runs blocks of "
                         f"{k_block} frames, not {block_frames}")
    if n_frames % k_block:
        raise ValueError(f"{n_frames} frames are not a whole number of "
                         f"{k_block}-frame blocks")
    p = Plan(config["algorithm"], dtype, device)
    cap = int(config["program"].get("block_iter_cap", 0))
    trips = min(p.max_iter, cap) if cap else p.max_iter
    x_t = torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                          device=device)
    n_hops = np.full(x_t.shape[0], n_frames)
    mag, re, im = analysis(frames_of(x_t, n_hops, n_frames, p), p)
    bx, bd = _bases(bases, p)
    st = State(bd, x_t.shape[0], p)
    xm = _run_blocks(mag, st, bx, bd, p, k_block, trips)
    y = overlap_add(synthesis(xm, re, im, p), p)
    return (written_int16(y[:, p.delay * p.shift: n_frames * p.shift]),
            st.refits)
