"""Local block-sparsity statistic Q (port of
``se_snmf_nat_tpu.enhance.blk_sparse``): the per-frame form of the exact
engine and the whole-block banded-product form of the block and fast plans.

The statistic of a block center is alpha_p * Q(previous center) +
(1 - alpha_p) * Hoyer(window).  With blk_gap >= 3 (the reference default)
the smoothing term always reads its 0.1 initialisation, so every center is
independent.  With blk_gap < 3 it is a linear recurrence over the centers,
p_k = alpha_p * p_(k-1) + (1 - alpha_p) * t_k seeded with 0.1; here that is
one product with the lower-triangular matrix of powers of alpha_p, so both
forms stay free of a loop over centers and serve every gap.

Both window sums are products with banded 0/1 matrices: over the ring's
time axis, and over the P_len_k bins of each center.
"""

from __future__ import annotations

import functools
import math

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


def noise_bias(a_d_mag: torch.Tensor, a_x_mag: torch.Tensor, beta: float,
               beta_max: float) -> torch.Tensor:
    """The noise-bias factor ``clamp(20 log10(a_d / a_x) * beta, beta,
    beta_max)`` of the mean noise and speech activations.  A frame whose
    activations all underflow to 0 (a floored frame in float32: with sparse
    trained dictionaries the solve drives them below the smallest denormal)
    gives 0/0; its ratio is taken as 1, so the factor sits at its floor.
    The reference's NaN there enters the noise estimate and every later
    frame's output.  float64 never underflows there."""
    ratio = torch.nan_to_num(a_d_mag / a_x_mag, nan=1.0, posinf=math.inf)
    return torch.clamp(20.0 * torch.log10(ratio) * beta, beta, beta_max)


def wiener_gain(xm: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """``xm / (xm + dm)``, and 0 where both reconstructions underflow to
    0 (the reference's 0/0, see ``noise_bias``)."""
    return torch.nan_to_num(xm / (xm + dm), nan=0.0, posinf=math.inf)


class _QMaps:
    """The constants of one (window, gap) layout on one device: the
    frequency band matrix, the map from centers back to bins, the
    recurrence's matrix of powers (gap < 3) and the statistic's value before
    the ring has filled."""

    def __init__(self, n_bins, p_len_k, p_len_l, dc_bin, gap, alpha_p,
                 device, dtype):
        half = p_len_k // 2
        gap2 = (gap - 1) // 2
        ks = _centers(n_bins, p_len_k, dc_bin, gap)
        f_idx = np.arange(n_bins)[:, None]
        w_freq = ((f_idx >= ks[None, :] - half)
                  & (f_idx <= ks[None, :] + half - 1))
        j = np.arange(n_bins)
        ci = np.clip(np.round((j - (ks[0] - 1)) / gap).astype(int), 0,
                     len(ks) - 1)
        covered = np.abs(j - ks[ci] + 1) <= gap2
        self.sqrt_n = float(np.sqrt(p_len_k * p_len_l))
        self.alpha_p = alpha_p
        self.p_len_k, self.p_len_l, self.dc_bin = p_len_k, p_len_l, dc_bin
        self.wf = torch.as_tensor(w_freq, dtype=dtype, device=device)
        self.ci = torch.as_tensor(ci, device=device)
        self.covered = torch.as_tensor(covered, device=device)
        self.q_init = torch.full((n_bins,), 0.1, dtype=dtype, device=device)
        self.q_init[:dc_bin] = 0.0
        self.tri_t = None
        if gap < 3:
            # p = b @ tri_t with tri_t[j, k] = alpha_p**(k - j) for k >= j
            k_idx = np.arange(len(ks))
            expo = k_idx[None, :] - k_idx[:, None]
            tri_t = np.where(expo >= 0, alpha_p ** np.maximum(expo, 0), 0.0)
            self.tri_t = torch.as_tensor(tri_t, dtype=dtype, device=device)

    def q_of_windows(self, l1: torch.Tensor, l2: torch.Tensor,
                     late) -> torch.Tensor:
        """Q (..., F) from the centers' window sums l1 and root sums of
        squares l2 (..., C); ``late`` says where the ring has filled
        (l > P_len_l): True everywhere, or a bool tensor broadcasting
        against (..., 1).  A window of zero columns only (float32 frames
        whose speech reconstruction underflowed, see ``snr_column``) gives
        0/0, which the reference passes on as NaN; its ratio is taken as
        that of a flat window, sqrt(n): not sparse."""
        ratio = torch.nan_to_num(l1 / l2, nan=self.sqrt_n)
        p_tmp = (self.sqrt_n - ratio) / (self.sqrt_n - 1.0)
        if self.tri_t is None:
            p_val = self.alpha_p * 0.1 + (1.0 - self.alpha_p) * p_tmp
        else:
            b = (1.0 - self.alpha_p) * p_tmp
            b[..., 0] += self.alpha_p * 0.1
            p_val = torch.matmul(b, self.tri_t)
        spread = p_val[..., self.ci]
        q = torch.where(self.covered, spread, torch.full_like(spread, 0.1))
        # low-bin backfill: Q(1:P_len_k-1) = Q(P_len_k + dc_bin)
        at = self.p_len_k + self.dc_bin - 1
        q[..., : self.p_len_k - 1] = q[..., at: at + 1]
        if torch.is_tensor(late):
            q = torch.where(late, q, self.q_init)
        q[..., : self.dc_bin] = 0.0
        return q


@functools.lru_cache(maxsize=16)     # one entry a layout, device and dtype
def _q_maps(n_bins, p_len_k, p_len_l, dc_bin, gap, alpha_p, device, dtype):
    return _QMaps(n_bins, p_len_k, p_len_l, dc_bin, gap, alpha_p, device,
                  dtype)


def block_sparsity_stat(r_ring: torch.Tensor, l, *, n_bins: int,
                        p_len_k: int, p_len_l: int, dc_bin: int, gap: int,
                        alpha_p: float) -> torch.Tensor:
    """Q (..., F) of the current ring contents r_ring (..., F, P_len_l), in
    any column order (every window statistic is a sum over the ring's time
    axis).  ``l`` is the 1-based frame number: up to P_len_l the statistic
    keeps its initial value.  A host integer serves every lane and skips the
    window sums while the ring fills; an integer tensor of the ring's leading
    shape (...,) gives each lane its own number as a select, and nothing is
    read on the host."""
    maps = _q_maps(n_bins, p_len_k, p_len_l, dc_bin, gap, alpha_p,
                   r_ring.device, r_ring.dtype)
    per_lane = torch.is_tensor(l)
    if not per_lane and int(l) <= p_len_l:
        return maps.q_init.expand(r_ring.shape[:-1]).clone()
    rs = torch.sum(r_ring, dim=-1)
    rq = torch.sum(r_ring * r_ring, dim=-1)
    l1 = torch.matmul(rs, maps.wf)                          # (..., C)
    l2 = torch.sqrt(torch.matmul(rq, maps.wf))
    return maps.q_of_windows(l1, l2,
                             (l > p_len_l)[..., None] if per_lane else True)


def block_sparsity_q(xm: torch.Tensor, dm: torch.Tensor, r_blk: torch.Tensor,
                     l, *, n_bins: int, p_len_k: int, p_len_l: int,
                     dc_bin: int, gap: int, alpha_p: float,
                     nonzerofloor: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame with shift-ring semantics (the exact engine).  xm, dm:
    (..., F) reconstructions; r_blk: (..., F, P_len_l) ring; ``l``: the
    1-based frame number, a host integer or a (...,) integer tensor with a
    number per lane (see ``block_sparsity_stat``).  Returns (q (..., F),
    r_blk_new)."""
    snr = snr_column(xm, dm, nonzerofloor)
    r_new = torch.cat([r_blk[..., 1:], snr[..., None]], dim=-1)
    q = block_sparsity_stat(r_new, l, n_bins=n_bins, p_len_k=p_len_k,
                            p_len_l=p_len_l, dc_bin=dc_bin, gap=gap,
                            alpha_p=alpha_p)
    return q, r_new


def make_block_sparsity_q_block(k_block: int, *, n_bins: int, p_len_k: int,
                                p_len_l: int, dc_bin: int, gap: int,
                                alpha_p: float, device=None,
                                dtype=torch.float32):
    """Whole-block Q over lanes.

    Returns ``q_block(snr_cols (B, K, F), r_ring (B, F, P), ls,
    n_valid (B,)) -> (q (B, K, F), r_ring_new (B, F, P))``: ``ls`` are the
    block's 1-based frame numbers, (K,) host integers or an integer tensor
    (K,) or (B, K) (a row per lane) on the ring's device; ``n_valid`` counts
    each lane's non-padding frames (the ring advances past exactly those).

      * time: ext = [ring | block columns] (F, P+K); rs = ext @ W_t with
        W_t[c, j] = 1 iff frame j's P-deep window covers column c;
      * frequency: l1 = rs' @ W_f with W_f[f, c] = 1 iff bin f lies in
        center c's P_len_k window.

    No frame's statistic reads another frame's, at any gap: with gap < 3
    the recurrence runs over the centers of one frame (module docstring),
    where the reference keeps Q inside its frame scan.
    """
    maps = _q_maps(n_bins, p_len_k, p_len_l, dc_bin, gap, alpha_p,
                   torch.device(device) if device is not None else None,
                   dtype)
    c_idx = np.arange(p_len_l + k_block)[:, None]
    j_idx = np.arange(k_block)[None, :]
    w_time = (c_idx >= j_idx + 1) & (c_idx <= j_idx + p_len_l)
    wt = torch.as_tensor(w_time, dtype=dtype, device=device)
    ring_idx = torch.arange(p_len_l, device=device)

    def q_block(snr_cols, r_ring, ls, n_valid):
        ext = torch.cat([r_ring, snr_cols.transpose(-1, -2)], dim=-1)
        rs = ext @ wt                                       # (B, F, K)
        rq = (ext * ext) @ wt
        l1 = rs.transpose(-1, -2) @ maps.wf                 # (B, K, C)
        l2 = torch.sqrt(rq.transpose(-1, -2) @ maps.wf)
        late = (ls > p_len_l if torch.is_tensor(ls) else torch.as_tensor(
            np.asarray(ls) > p_len_l, device=ext.device))
        q = maps.q_of_windows(l1, l2, late[..., None])
        idx = (n_valid[:, None].to(torch.int64) + ring_idx)   # (B, P)
        ring_new = torch.gather(
            ext, -1, idx[:, None, :].expand(-1, ext.shape[-2], -1))
        return q, ring_new

    return q_block
