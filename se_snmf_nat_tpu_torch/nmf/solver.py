"""Sparse-NMF multiplicative-update solvers on tensors (port of
``se_snmf_nat_tpu.nmf.solver``).

These plain versions are the oracles of the CUDA kernels (``kernels/mu.py``,
KL only), the CPU path of the port, and the solvers of the configurations
the kernels do not cover (a beta other than 1, the semi-supervised
per-frame W+H solve).  Every function takes any number of leading batch
dimensions (lanes); lanes are independent problems, and a lane that stops
early is frozen by a per-lane select, exactly as the reference's
``vmap``-ed ``while_loop`` behaves.

Update rules (V (m, n), W (m, r), H (r, n), Λ = max(WH, flr)); beta=1 (KL):
    H <- H ⊙ Wᵀ(V/Λ) / max(1ᵀW + sparsity, flr)
    W <- W ⊙ [(V/Λ)Hᵀ + (1ᵀH ⊙ 1ᵀW) W] / max(1ᵀH + (1ᵀ((V/Λ)Hᵀ ⊙ W)) W, flr),
         then columns renormalised to unit L2 norm
    cost = Σ V log(V/Λ) − V + Λ  +  Σ sparsity·H
beta=2 (ED) and any other beta (0: IS) use the beta-divergence forms
    H <- H ⊙ Wᵀ(V Λ^(β-2)) / max(WᵀΛ^(β-1) + sparsity, flr)
and the matching tangent-corrected W update.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

FLR = 1e-9


@dataclasses.dataclass(frozen=True)
class SnmfParams:
    beta: float = 1.0          # 0: IS, 1: KL, 2: ED, else general
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


def normalize_columns(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-normalise the columns of (..., m, r); zero columns stay zero.
    Returns (w_normalised, norms (..., r))."""
    wn = torch.sqrt(torch.sum(w * w, dim=-2))
    safe = torch.where(wn > 0.0, wn, torch.ones_like(wn))
    return w / safe[..., None, :], wn


def _div_terms(v: torch.Tensor, lamb: torch.Tensor,
               beta: float) -> torch.Tensor:
    """Elementwise beta-divergence terms d(v | lamb)."""
    if beta == 1.0:
        return v * torch.log(v / lamb) - v + lamb
    if beta == 2.0:
        return (v - lamb) ** 2
    if beta == 0.0:
        return v / lamb - torch.log(v / lamb) - 1.0
    return (v ** beta + (beta - 1.0) * lamb ** beta
            - beta * v * lamb ** (beta - 1.0)) / (beta * (beta - 1.0))


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
    flr, sp, beta = params.flr, params.sparsity, params.beta
    v = torch.clamp(v, min=flr)
    w, wn = normalize_columns(w)
    h = h0 * wn[..., :, None]
    lamb = _lamb(w, h, flr)
    if beta == 1.0:           # constant over the trips for KL
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
        if beta == 1.0:
            h_new = h * torch.matmul(wt, v / lamb) / dph
        elif beta == 2.0:
            dph_t = torch.clamp(torch.matmul(wt, lamb) + sp, min=flr)
            h_new = h * torch.matmul(wt, v) / dph_t
        else:
            dph_t = torch.clamp(
                torch.matmul(wt, lamb ** (beta - 1.0)) + sp, min=flr)
            h_new = h * torch.matmul(wt, v * lamb ** (beta - 2.0)) / dph_t
        h = torch.where(active[..., None, :], h_new, h)
        trips = trips + active.to(torch.int32)
        lamb = _lamb(w, h, flr)
        if early:
            cost = (torch.sum(_div_terms(v, lamb, beta), dim=-2)
                    + torch.sum(sp * h, dim=-2))
            rel = torch.abs(cost - last) / torch.abs(last)
            if it > 0:
                active = active & ~(rel < params.conv_eps)
            last = cost
    div = torch.sum(_div_terms(v, lamb, beta), dim=(-2, -1))
    cost = (torch.sum(last, dim=-1) if early
            else div + torch.sum(sp * h, dim=(-2, -1)))
    return SnmfResult(w=w, h=h, iters=trips, div=div, cost=cost)


def _h_step(v, w, h, lamb, sp, beta, flr, h_mask):
    """One multiplicative H update restricted to the ``h_mask`` rows."""
    wm = w * h_mask[..., None, :]
    wmt = wm.transpose(-1, -2)
    if beta == 1.0:
        dph = torch.sum(wm, dim=-2)[..., :, None] + sp
        dmh = torch.matmul(wmt, v / lamb)
    elif beta == 2.0:
        dph = torch.matmul(wmt, lamb) + sp
        dmh = torch.matmul(wmt, v)
    else:
        dph = torch.matmul(wmt, lamb ** (beta - 1.0)) + sp
        dmh = torch.matmul(wmt, v * lamb ** (beta - 2.0))
    h_new = h * dmh / torch.clamp(dph, min=flr)
    return torch.where(h_mask[..., :, None], h_new, h)


def _w_step(v, w, h, lamb, beta, flr, w_mask):
    """One multiplicative W update (tangent-corrected, unit columns)
    restricted to the ``w_mask`` columns; rows of h outside the mask are
    left out of every sum."""
    hm = h * w_mask[..., :, None]
    hmt = hm.transpose(-1, -2)                            # (..., n, r)
    if beta == 1.0:
        sumh = torch.sum(hm, dim=-1)                      # (..., r)
        c = torch.matmul(v / lamb, hmt)                   # (..., m, r)
        corr_p = torch.sum(c * w, dim=-2)
        dpw = sumh[..., None, :] + corr_p[..., None, :] * w
        corr_m = sumh * torch.sum(w, dim=-2)
        dmw = c + corr_m[..., None, :] * w
    else:
        if beta == 2.0:
            lh = torch.matmul(lamb, hmt)
            vh = torch.matmul(v, hmt)
        else:
            lh = torch.matmul(lamb ** (beta - 1.0), hmt)
            vh = torch.matmul(v * lamb ** (beta - 2.0), hmt)
        dpw = lh + torch.sum(vh * w, dim=-2)[..., None, :] * w
        dmw = vh + torch.sum(lh * w, dim=-2)[..., None, :] * w
    w_new = w * dmw / torch.clamp(dpw, min=flr)
    w_new = torch.where(w_mask[..., None, :], w_new, w)
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
    return _solve(v, w0, h0, w_mask, h_mask, params, update_w, update_h,
                  active, need_stats, trace=False)[0]


def snmf_solve_traced(v: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor,
                      w_mask: torch.Tensor, h_mask: torch.Tensor,
                      params: SnmfParams, update_w: bool = True,
                      update_h: bool = True
                      ) -> tuple[SnmfResult, dict[str, torch.Tensor]]:
    """``snmf_solve`` with the reference's per-trip objective trace
    (sparse_nmf.m:260-270 ``objective.div/cost``), a diagnostic surface:
    the cost it records every trip is the pass the fixed-trip solves skip.

    Returns ``(result, {"div": (..., max_iter), "cost": (..., max_iter)})``
    with a lane's entries past its ``iters`` zero.  The update sequence is
    ``snmf_solve``'s, so the final factors are the same."""
    return _solve(v, w0, h0, w_mask, h_mask, params, update_w, update_h,
                  None, True, trace=True)


def _solve(v, w0, h0, w_mask, h_mask, params, update_w, update_h, active,
           need_stats, trace):
    flr, sp, beta = params.flr, params.sparsity, params.beta
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
    hist = ({k: torch.zeros(lane_shape + (params.max_iter,), dtype=v.dtype,
                            device=dev) for k in ("div", "cost")}
            if trace else None)
    for k in range(params.max_iter):
        if not bool(run.any()):
            break
        w2, h2, lamb2 = w, h, lamb
        if update_h:
            h2 = _h_step(v, w2, h2, lamb2, sp, beta, flr, h_mask)
            lamb2 = _lamb(w2, h2, flr)
        if update_w:
            w2 = _w_step(v, w2, h2, lamb2, beta, flr, w_mask)
            lamb2 = _lamb(w2, h2, flr)
        sel = run[..., None, None]
        w = torch.where(sel, w2, w)
        h = torch.where(sel, h2, h)
        lamb = torch.where(sel, lamb2, lamb)
        if params.conv_eps > 0 or trace:
            div = torch.sum(_div_terms(v, lamb2, beta), dim=(-2, -1))
            cost = div + torch.sum(sp * h2, dim=(-2, -1))
            if trace:
                hist["div"][..., k] = torch.where(run, div, 0.0)
                hist["cost"][..., k] = torch.where(run, cost, 0.0)
            rel = torch.abs(cost - last) / torch.abs(last)
            done = ((it > 0) & (rel < params.conv_eps)
                    if params.conv_eps > 0 else torch.zeros_like(run))
            last = torch.where(run, cost, last)
            it = it + run.to(torch.int32)
            run = run & ~done
        else:
            it = it + run.to(torch.int32)
    if not need_stats:
        zero = torch.zeros(lane_shape, dtype=v.dtype, device=dev)
        return SnmfResult(w=w, h=h, iters=it, div=zero, cost=zero), hist
    div = torch.sum(_div_terms(v, lamb, beta), dim=(-2, -1))
    cost = (last if params.conv_eps > 0
            else div + torch.sum(sp * h, dim=(-2, -1)))
    return SnmfResult(w=w, h=h, iters=it, div=div, cost=cost), hist
