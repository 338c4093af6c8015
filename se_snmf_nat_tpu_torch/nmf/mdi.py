"""Sparse NMF with missing-data imputation (MDI), on tensors (port of
``se_snmf_nat_tpu.nmf.mdi``).

Reference: src/snmf_mdi.m (hard observed-mask Dm) and src/snmf_mdi_Sm.m
(soft mask Sm): the sparse_nmf MU loop with, each trip, the missing (or
soft-weighted) entries of V re-imputed from the current model W@H, and a
final per-frame gain-matched merge (snmf_mdi.m:175,251-254,297-303;
snmf_mdi_Sm.m:251-260,303-309).  The soft variant with a 0/1 mask reduces
exactly to the hard variant.  One problem a call; the loop stops on the
whole matrix's relative cost, as the reference's ``while_loop`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.nmf.solver import (
    SnmfParams, _div_terms, _h_step, _lamb, _w_step, normalize_columns)


class MdiResult(NamedTuple):
    v_mdi: torch.Tensor   # gain-matched imputed spectrogram
    w: torch.Tensor
    h: torch.Tensor
    iters: int
    div: torch.Tensor
    cost: torch.Tensor


def snmf_mdi_solve(v, mask, w0, h0, w_mask, h_mask, params: SnmfParams,
                   update_w: bool = True, update_h: bool = True,
                   soft: bool = False, *, device=None,
                   dtype=torch.float32) -> MdiResult:
    """v: (m, n) data; mask: (m, n): the hard 0/1 observed mask Dm, or a
    soft reliability mask Sm in [0, 1] when ``soft``.  w0 (m, r), h0 (r, n),
    w_mask / h_mask (r,) bool and the rest follow ``nmf.solver.snmf_solve``.
    Arrays or tensors; they are taken to ``device`` (the card unless named)
    as ``dtype``."""
    dev = resolve_device(device)
    v, mask, w0, h0 = (torch.as_tensor(a, dtype=dtype, device=dev)
                       for a in (v, mask, w0, h0))
    w_mask, h_mask = (torch.as_tensor(a, dtype=torch.bool, device=dev)
                      for a in (w_mask, h_mask))
    flr, sp, beta = params.flr, params.sparsity, params.beta
    keep = mask if soft else (mask > 0).to(dtype)
    miss = (1.0 - mask) if soft else (1.0 - keep)

    v = torch.clamp(v * keep, min=flr)              # masked init (:175)
    w, wn = normalize_columns(w0)
    h = h0 * wn[:, None]
    lamb = _lamb(w, h, flr)
    cost = torch.tensor(float("inf"), dtype=dtype, device=dev)
    it = 0
    while it < params.max_iter:
        if update_h:
            h = _h_step(v, w, h, lamb, sp, beta, flr, h_mask)
            lamb = _lamb(w, h, flr)
        if update_w:
            w = _w_step(v, w, h, lamb, beta, flr, w_mask)
            lamb = _lamb(w, h, flr)
        # imputation from the current model Lambda = WH (:251-254)
        v = torch.clamp(v * keep + lamb * miss, min=flr)
        last, cost = cost, torch.sum(_div_terms(v, lamb, beta)) \
            + torch.sum(sp * h)
        it += 1
        if (params.conv_eps > 0 and it > 1 and bool(
                torch.abs(cost - last) / torch.abs(last) < params.conv_eps)):
            break

    # final gain-matched merge (:297-303); Lambda is the final W@H
    nt = (torch.sum(v * keep, dim=0)
          / torch.clamp(torch.sum(lamb * keep, dim=0), min=flr))
    v_mdi = torch.clamp(v * keep + (nt[None, :] * lamb) * miss, min=flr)
    div = torch.sum(_div_terms(v, lamb, beta))
    return MdiResult(v_mdi=v_mdi, w=w, h=h, iters=it, div=div, cost=cost)
