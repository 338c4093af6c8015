"""Model-parallel solves: dictionary columns split over 'model' (port of
``se_snmf_nat_tpu.parallel.model_shard``).

The reference's largest factorizations are the exemplar configs (R = 500+
per class) and the NTF unfoldings; SURVEY §2.7 names column sharding over
a 'model' axis as the TP story:

  W (F, R)  — columns split over 'model'
  H (R, N)  — rows split over 'model' (each shard owns its atoms'
              activations)
  V (F, N)  — replicated

Each trip every shard computes its partial reconstruction W_s H_s; ONE
all-reduce over 'model' (``mesh.psum``) gives the global Λ (F x N values,
the only cross-shard traffic of a rebuild).  Given the global Λ every
β-divergence update of the reference family (IS, KL, ED, general β) is
local: the H update's numerator and denominator touch only the shard's
atoms, and the tangent-corrected W update's cross terms are per-column
sums over F.

Every loop decision is taken from all-reduced values, never from a shard's
own: the per-column stop reads the cost of the global Λ plus the
all-reduced sparsity term, the scalar stop of the full solve the same, so
every shard (and every process of a group) runs the same trips and freezes
the same columns.  The updates are the unsharded solver's (``_h_step``,
``_w_step`` of ``nmf/solver.py``); results match it up to the order of
the sums.
"""

from __future__ import annotations

import torch

from se_snmf_nat_tpu_torch.nmf.solver import (
    SnmfParams, SnmfResult, _div_terms, _h_step, _w_step, normalize_columns)
from se_snmf_nat_tpu_torch.parallel.mesh import Mesh, model_sharding, psum


def _split(mesh: Mesh, w, h0, masks=()):
    """W's columns, H's rows and the (R,) masks as this process's shards;
    raises unless the global rank divides over the model axis."""
    mp = mesh.shape["model"]
    r = w.shape[1] * mp // mesh.local_shape["model"]
    if r % mp or w.shape[1] % mesh.local_shape["model"]:
        raise ValueError(f"rank {r} not divisible by model axis {mp}")
    cols, rows = model_sharding(mesh, 2, 1), model_sharding(mesh, 2, 0)
    vec = model_sharding(mesh, 1, 0)
    return (cols, rows, cols.split(w), rows.split(h0),
            *(vec.split(m) for m in masks))


def _normalised(ws, hs):
    """Entry normalisation (sparse_nmf.m:157-160): columnwise, local."""
    out_w, out_h = [], []
    for w_s, h_s in zip(ws, hs):
        w_s, wn = normalize_columns(w_s)
        out_w.append(w_s)
        out_h.append(h_s * wn[:, None])
    return out_w, out_h


@torch.no_grad()
def snmf_h_solve_columns_model_sharded(v, w, h0, params: SnmfParams,
                                       mesh: Mesh) -> SnmfResult:
    """Model-parallel drop-in for ``snmf_h_solve_columns`` (all β).

    v: (F, N) replicated; w: (F, R) and h0: (R, N) split over 'model' on
    the R axis (a process's block under a group; R must divide by the
    'model' axis).  Returns the same ``SnmfResult`` (w normalised, h
    solved, trips per column, div, cost) with w and h joined from this
    process's shards."""
    cols, rows, ws, hs = _split(mesh, w, h0)
    flr, sp, beta = params.flr, params.sparsity, params.beta
    dev = ws[0].device
    v = torch.clamp(v.to(dev), min=flr)
    ws, hs = _normalised(ws, hs)

    def global_lambda(hs):
        part = psum([torch.matmul(w_s, h_s) for w_s, h_s in zip(ws, hs)],
                    mesh, "model")
        return torch.clamp(part, min=flr)

    def sparsity_cost(hs):
        return psum([torch.sum(sp * h_s, dim=0) for h_s in hs], mesh,
                    "model")

    lamb = global_lambda(hs)
    if beta == 1.0:            # constant over the trips for KL
        dph = [torch.clamp(torch.sum(w_s, dim=0)[:, None] + sp, min=flr)
               for w_s in ws]
    n = v.shape[1]
    active = torch.ones(n, dtype=torch.bool, device=dev)
    trips = torch.zeros(n, dtype=torch.int32, device=dev)
    last = torch.full((n,), float("inf"), dtype=v.dtype, device=dev)
    early = params.conv_eps > 0
    for it in range(params.max_iter):
        if early and not bool(active.any()):
            break
        new = []
        for k, (w_s, h_s) in enumerate(zip(ws, hs)):
            lam, vv, wt = lamb.to(w_s.device), v.to(w_s.device), w_s.T
            if beta == 1.0:
                h_new = h_s * torch.matmul(wt, vv / lam) / dph[k]
            elif beta == 2.0:
                d = torch.clamp(torch.matmul(wt, lam) + sp, min=flr)
                h_new = h_s * torch.matmul(wt, vv) / d
            else:
                d = torch.clamp(torch.matmul(wt, lam ** (beta - 1.0)) + sp,
                                min=flr)
                h_new = h_s * torch.matmul(wt, vv * lam ** (beta - 2.0)) / d
            new.append(torch.where(active.to(w_s.device)[None, :], h_new,
                                   h_s))
        hs = new
        trips = trips + active.to(torch.int32)
        lamb = global_lambda(hs)
        if early:
            cost = (torch.sum(_div_terms(v, lamb, beta), dim=0)
                    + sparsity_cost(hs).to(dev))
            rel = torch.abs(cost - last) / torch.abs(last)
            if it > 0:
                active = active & ~(rel < params.conv_eps)
            last = cost
    div = torch.sum(_div_terms(v, lamb, beta))
    cost = (torch.sum(last) if early
            else div + psum([torch.sum(sp * h_s) for h_s in hs], mesh,
                            "model").to(dev))
    return SnmfResult(w=cols.join(ws), h=rows.join(hs), iters=trips,
                      div=div, cost=cost)


@torch.no_grad()
def snmf_solve_model_sharded(v, w0, h0, params: SnmfParams, mesh: Mesh,
                             w_mask=None, h_mask=None,
                             update_w: bool = True,
                             update_h: bool = True) -> SnmfResult:
    """Model-parallel drop-in for ``snmf_solve`` (training and the online
    dictionary refit, all β).

    v: (F, N) replicated; w0: (F, R), h0: (R, N), and the optional (R,)
    masks split over 'model' on the R axis.  ``iters`` is the trips run."""
    r = w0.shape[1]
    ones = torch.ones(r, dtype=torch.bool, device=w0.device)
    w_mask = ones if w_mask is None else w_mask
    h_mask = ones if h_mask is None else h_mask
    cols, rows, ws, hs, wms, hms = _split(mesh, w0, h0, (w_mask, h_mask))
    flr, sp, beta = params.flr, params.sparsity, params.beta
    dev = ws[0].device
    v = torch.clamp(v.to(dev), min=flr)
    ws, hs = _normalised(ws, hs)

    def global_lambda(ws, hs):
        part = psum([torch.matmul(w_s, h_s) for w_s, h_s in zip(ws, hs)],
                    mesh, "model")
        return torch.clamp(part, min=flr)

    def penalty(hs):
        return psum([torch.sum(sp * h_s) for h_s in hs], mesh,
                    "model").to(dev)

    lamb = global_lambda(ws, hs)
    it = 0
    last = torch.tensor(float("inf"), dtype=v.dtype, device=dev)
    for _ in range(params.max_iter):
        if update_h:
            hs = [_h_step(v.to(h_s.device), w_s, h_s, lamb.to(h_s.device),
                          sp, beta, flr, hm)
                  for w_s, h_s, hm in zip(ws, hs, hms)]
            lamb = global_lambda(ws, hs)
        if update_w:
            ws = [_w_step(v.to(w_s.device), w_s, h_s, lamb.to(w_s.device),
                          beta, flr, wm)
                  for w_s, h_s, wm in zip(ws, hs, wms)]
            lamb = global_lambda(ws, hs)
        it += 1
        if params.conv_eps > 0:
            cost = torch.sum(_div_terms(v, lamb, beta)) + penalty(hs)
            rel = torch.abs(cost - last) / torch.abs(last)
            done = it > 1 and bool(rel < params.conv_eps)
            last = cost
            if done:
                break
    div = torch.sum(_div_terms(v, lamb, beta))
    cost = last if params.conv_eps > 0 else div + penalty(hs)
    return SnmfResult(w=cols.join(ws), h=rows.join(hs),
                      iters=torch.tensor(it, dtype=torch.int32), div=div,
                      cost=cost)
