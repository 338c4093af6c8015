"""Local block-sparsity statistic Q (port of
``se_snmf_nat_tpu.enhance.blk_sparse``), whole-block banded-product form.

With blk_gap >= 3 (the reference default) the smoothing term of the
statistic always reads its 0.1 initialisation, so Q is
alpha_p*0.1 + (1-alpha_p)*Hoyer(window) for every center, and a block's K
frames need no sequential pass: both window sums are products with banded
0/1 matrices, once per block.  blk_gap < 3 makes Q a recurrence over centers
(the sequential form), which is not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def _centers(n_bins: int, p_len_k: int, dc_bin: int, gap: int) -> np.ndarray:
    """1-based block centers: half+dcbin : gap : n_bins-half."""
    half = p_len_k // 2
    return np.arange(half + dc_bin, n_bins - half + 1, gap)


def snr_column(xm: torch.Tensor, dm: torch.Tensor,
               nonzerofloor: float) -> torch.Tensor:
    """Max-normalised local-SNR columns (..., F) the ring stores.  A column
    whose speech reconstruction is all zero (a silent frame in float32 with
    denormals flushed to zero) stays zero: the reference's 0/0 there gives
    NaN, which the banded window products then spread to every frame of the
    utterance (0 * NaN)."""
    snr = xm / torch.clamp(dm, min=nonzerofloor)
    peak = torch.amax(snr, dim=-1, keepdim=True)
    return snr / torch.where(peak > 0, peak, torch.ones_like(peak))


def make_block_sparsity_q_block(k_block: int, *, n_bins: int, p_len_k: int,
                                p_len_l: int, dc_bin: int, gap: int,
                                alpha_p: float, device=None,
                                dtype=torch.float32):
    """Whole-block Q over lanes.

    Returns ``q_block(snr_cols (B, K, F), r_ring (B, F, P), ls (K,),
    n_valid (B,)) -> (q (B, K, F), r_ring_new (B, F, P))``: ``ls`` are the
    block's 1-based frame numbers, ``n_valid`` counts each lane's
    non-padding frames (the ring advances past exactly those).

      * time: ext = [ring | block columns] (F, P+K); rs = ext @ W_t with
        W_t[c, j] = 1 iff frame j's P-deep window covers column c;
      * frequency: l1 = rs' @ W_f with W_f[f, c] = 1 iff bin f lies in
        center c's P_len_k window.
    """
    if gap < 3:
        raise NotImplementedError(
            "blk_gap < 3 makes Q a recurrence over centers (the sequential "
            "form), which the port does not have yet")
    half = p_len_k // 2
    sqrt_n = float(np.sqrt(p_len_k * p_len_l))
    ks = _centers(n_bins, p_len_k, dc_bin, gap)
    gap2 = (gap - 1) // 2

    c_idx = np.arange(p_len_l + k_block)[:, None]
    j_idx = np.arange(k_block)[None, :]
    w_time = (c_idx >= j_idx + 1) & (c_idx <= j_idx + p_len_l)
    f_idx = np.arange(n_bins)[:, None]
    w_freq = (f_idx >= ks[None, :] - half) & (f_idx <= ks[None, :] + half - 1)
    j = np.arange(n_bins)
    ci = np.clip(np.round((j - (ks[0] - 1)) / gap).astype(int), 0,
                 len(ks) - 1)
    covered = np.abs(j - ks[ci] + 1) <= gap2

    wt = torch.as_tensor(w_time, dtype=dtype, device=device)
    wf = torch.as_tensor(w_freq, dtype=dtype, device=device)
    ci_t = torch.as_tensor(ci, device=device)
    cov_t = torch.as_tensor(covered, device=device)
    q_init = torch.full((n_bins,), 0.1, dtype=dtype, device=device)
    q_init[:dc_bin] = 0.0
    ring_idx = torch.arange(p_len_l, device=device)

    def q_block(snr_cols, r_ring, ls, n_valid):
        ext = torch.cat([r_ring, snr_cols.transpose(-1, -2)], dim=-1)
        rs = ext @ wt                                       # (B, F, K)
        rq = (ext * ext) @ wt
        l1 = rs.transpose(-1, -2) @ wf                      # (B, K, C)
        l2 = torch.sqrt(rq.transpose(-1, -2) @ wf)
        p_tmp = (sqrt_n - l1 / l2) / (sqrt_n - 1.0)
        p_val = alpha_p * 0.1 + (1.0 - alpha_p) * p_tmp
        q = torch.where(cov_t, p_val[..., ci_t],
                        torch.full_like(p_val[..., ci_t], 0.1))
        q[..., : p_len_k - 1] = q[..., p_len_k + dc_bin - 1: p_len_k + dc_bin]
        late = torch.as_tensor(np.asarray(ls) > p_len_l, device=q.device)
        q = torch.where(late[:, None], q, q_init)
        q[..., :dc_bin] = 0.0
        idx = (n_valid[:, None].to(torch.int64) + ring_idx)   # (B, P)
        ring_new = torch.gather(
            ext, -1, idx[:, None, :].expand(-1, ext.shape[-2], -1))
        return q, ring_new

    return q_block
