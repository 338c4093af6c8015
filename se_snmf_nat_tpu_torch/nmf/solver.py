"""KL sparse-NMF multiplicative-update solvers on tensors (port of
``se_snmf_nat_tpu.nmf.solver``).

These plain versions are the oracles of the two CUDA kernels
(``kernels/mu.py``) and the CPU path of the port.  Every function takes any
number of leading batch dimensions (lanes); lanes are independent problems,
and a lane that stops early is frozen by a per-lane select, exactly as the
reference's ``vmap``-ed ``while_loop`` behaves.

Update rules (beta=1, KL; V (m, n), W (m, r), H (r, n), Λ = max(WH, flr)):
    H <- H ⊙ Wᵀ(V/Λ) / max(1ᵀW + sparsity, flr)
    W <- W ⊙ [(V/Λ)Hᵀ + (1ᵀH ⊙ 1ᵀW) W] / max(1ᵀH + (1ᵀ((V/Λ)Hᵀ ⊙ W)) W, flr),
         then columns renormalised to unit L2 norm
    cost = Σ V log(V/Λ) − V + Λ  +  Σ sparsity·H
Only KL is ported; the other betas raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

FLR = 1e-9


@dataclasses.dataclass(frozen=True)
class SnmfParams:
    beta: float = 1.0          # only 1 (KL) is ported
    sparsity: float = 5.0
    max_iter: int = 100
    conv_eps: float = 1e-3     # 0 disables early stopping
    flr: float = FLR


class SnmfResult(NamedTuple):
    w: torch.Tensor
    h: torch.Tensor
    iters: torch.Tensor   # trips run: per lane (snmf_solve) or per column
    div: torch.Tensor     # final divergence per lane
    cost: torch.Tensor    # final cost per lane (div + sparsity penalty)


def _require_kl(params: SnmfParams) -> None:
    if params.beta != 1.0:
        raise NotImplementedError(
            f"beta={params.beta}: only the KL solver (beta=1) is ported")


def normalize_columns(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-normalise the columns of (..., m, r); zero columns stay zero.
    Returns (w_normalised, norms (..., r))."""
    wn = torch.sqrt(torch.sum(w * w, dim=-2))
    safe = torch.where(wn > 0.0, wn, torch.ones_like(wn))
    return w / safe[..., None, :], wn


def _kl_terms(v: torch.Tensor, lamb: torch.Tensor) -> torch.Tensor:
    return v * torch.log(v / lamb) - v + lamb


def _lamb(w, h, flr):
    return torch.clamp(torch.matmul(w, h), min=flr)


def snmf_h_solve_columns(v: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
                         params: SnmfParams) -> SnmfResult:
    """Activation solve with every column an independent problem.

    v: (..., m, n); w: (..., m, r), normalised here; h0: (..., r, n) before
    the rescale by the column norms.  Each column updates while it is
    active and freezes at its own relative-cost stop; with ``conv_eps <= 0``
    every column runs ``max_iter`` trips and the per-trip cost is skipped.
    ``iters`` holds each column's trip count (..., n)."""
    _require_kl(params)
    flr, sp = params.flr, params.sparsity
    v = torch.clamp(v, min=flr)
    w, wn = normalize_columns(w)
    h = h0 * wn[..., :, None]
    lamb = _lamb(w, h, flr)
    dph = torch.clamp(torch.sum(w, dim=-2)[..., :, None] + sp, min=flr)
    wt = w.transpose(-1, -2)
    col_shape = torch.broadcast_shapes(v.shape[:-2], h.shape[:-2]) \
        + (v.shape[-1],)
    active = torch.ones(col_shape, dtype=torch.bool, device=v.device)
    trips = torch.zeros(col_shape, dtype=torch.int32, device=v.device)
    last = torch.full(col_shape, float("inf"), dtype=v.dtype,
                      device=v.device)
    early = params.conv_eps > 0
    for it in range(params.max_iter):
        if early and not bool(active.any()):
            break
        h_new = h * torch.matmul(wt, v / lamb) / dph
        h = torch.where(active[..., None, :], h_new, h)
        trips = trips + active.to(torch.int32)
        lamb = _lamb(w, h, flr)
        if early:
            cost = (torch.sum(_kl_terms(v, lamb), dim=-2)
                    + torch.sum(sp * h, dim=-2))
            rel = torch.abs(cost - last) / torch.abs(last)
            if it > 0:
                active = active & ~(rel < params.conv_eps)
            last = cost
    div = torch.sum(_kl_terms(v, lamb), dim=(-2, -1))
    cost = (torch.sum(last, dim=-1) if early
            else div + torch.sum(sp * h, dim=(-2, -1)))
    return SnmfResult(w=w, h=h, iters=trips, div=div, cost=cost)


def _h_step(v, w, h, lamb, sp, flr, h_mask):
    wm = w * h_mask[..., None, :]
    dph = torch.clamp(torch.sum(wm, dim=-2)[..., :, None] + sp, min=flr)
    h_new = h * torch.matmul(wm.transpose(-1, -2), v / lamb) / dph
    return torch.where(h_mask[..., :, None], h_new, h)


def _w_step(v, w, h, lamb, flr, w_mask):
    hm = h * w_mask[..., :, None]
    sumh = torch.sum(hm, dim=-1)                          # (..., r)
    c = torch.matmul(v / lamb, hm.transpose(-1, -2))      # (..., m, r)
    corr_p = torch.sum(c * w, dim=-2)
    dpw = torch.clamp(sumh[..., None, :] + corr_p[..., None, :] * w, min=flr)
    corr_m = sumh * torch.sum(w, dim=-2)
    dmw = c + corr_m[..., None, :] * w
    w_new = torch.where(w_mask[..., None, :], w * dmw / dpw, w)
    return normalize_columns(w_new)[0]


def snmf_solve(v: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor,
               w_mask: torch.Tensor, h_mask: torch.Tensor,
               params: SnmfParams, update_w: bool = True,
               update_h: bool = True, active: torch.Tensor | None = None,
               need_stats: bool = True) -> SnmfResult:
    """Sparse-NMF solve with the reference's semantics, per lane.

    v: (..., m, n); w0: (..., m, r); h0: (..., r, n); w_mask / h_mask:
    (..., r) bool — which columns / rows update.  ``active`` (..., bool):
    a lane with False runs zero trips and returns its entry-normalised
    factors.  Each lane stops at its own relative-cost test; ``iters`` is
    per lane."""
    _require_kl(params)
    flr, sp = params.flr, params.sparsity
    v = torch.clamp(v, min=flr)
    w, wn = normalize_columns(w0)
    h = h0 * wn[..., :, None]
    lamb = _lamb(w, h, flr)
    lane_shape = torch.broadcast_shapes(v.shape[:-2], w.shape[:-2],
                                        h.shape[:-2])
    dev = v.device
    run = torch.ones(lane_shape, dtype=torch.bool, device=dev)
    if active is not None:
        run = run & active.to(torch.bool)
    it = torch.zeros(lane_shape, dtype=torch.int32, device=dev)
    last = torch.full(lane_shape, float("inf"), dtype=v.dtype, device=dev)
    for _ in range(params.max_iter):
        if not bool(run.any()):
            break
        w2, h2, lamb2 = w, h, lamb
        if update_h:
            h2 = _h_step(v, w2, h2, lamb2, sp, flr, h_mask)
            lamb2 = _lamb(w2, h2, flr)
        if update_w:
            w2 = _w_step(v, w2, h2, lamb2, flr, w_mask)
            lamb2 = _lamb(w2, h2, flr)
        sel = run[..., None, None]
        w = torch.where(sel, w2, w)
        h = torch.where(sel, h2, h)
        lamb = torch.where(sel, lamb2, lamb)
        if params.conv_eps > 0:
            cost = (torch.sum(_kl_terms(v, lamb2), dim=(-2, -1))
                    + torch.sum(sp * h2, dim=(-2, -1)))
            rel = torch.abs(cost - last) / torch.abs(last)
            done = (it > 0) & (rel < params.conv_eps)
            last = torch.where(run, cost, last)
            it = it + run.to(torch.int32)
            run = run & ~done
        else:
            it = it + run.to(torch.int32)
    if not need_stats:
        zero = torch.zeros(lane_shape, dtype=v.dtype, device=dev)
        return SnmfResult(w=w, h=h, iters=it, div=zero, cost=zero)
    div = torch.sum(_kl_terms(v, lamb), dim=(-2, -1))
    cost = (last if params.conv_eps > 0
            else div + torch.sum(sp * h, dim=(-2, -1)))
    return SnmfResult(w=w, h=h, iters=it, div=div, cost=cost)
