"""Distributed sparse-NMF training step (port of
``se_snmf_nat_tpu.parallel.train_step``).

The reference trains dictionaries with a single-process MU loop over a
513 x ~72k spectrogram (run_basis_train.m:84-95).  Here one MU step runs
over a mesh's 'data' axis:

  V (F, T)  — frames split over 'data' (T axis)
  W (F, R)  — replicated
  H (R, T)  — T split over 'data'

The H update is embarrassingly parallel in T.  The W update needs the
T-contractions (V/Λ)Hᵀ and the row sums of H: each shard's (F,R) and (R,)
statistics are flattened into one buffer and summed over the shards in
one all-reduce a trip (``mesh.psum``), F·R + R values, the count the
reference's test holds XLA to.  The normalisation terms are computed on
the merged statistics, so the update is the single-device one up to the
order of the sums.
"""

from __future__ import annotations

import torch

from se_snmf_nat_tpu_torch.nmf.solver import normalize_columns
from se_snmf_nat_tpu_torch.parallel.mesh import Mesh, data_sharding, psum


def _h_update(v, w, h, sparsity, flr):
    """The shard-local half: the H update and this shard's W statistics
    flattened as [vec((V/Λ)Hᵀ), 1ᵀHᵀ] (F·R + R values)."""
    lamb = torch.clamp(torch.matmul(w, h), min=flr)
    dph = torch.clamp(torch.sum(w, dim=0)[:, None] + sparsity, min=flr)
    h = h * torch.matmul(w.T, v / lamb) / dph
    lamb = torch.clamp(torch.matmul(w, h), min=flr)
    c = torch.matmul(v / lamb, h.T)                          # (F, R)
    return h, torch.cat([c.reshape(-1), torch.sum(h, dim=1)])


def _w_update(w, stats, flr):
    """The W update from the merged statistics, columns renormalised."""
    f, r = w.shape
    c, sumh = stats[: f * r].reshape(f, r), stats[f * r:]
    corr_p = torch.sum(c * w, dim=0)
    dpw = torch.clamp(sumh[None, :] + corr_p[None, :] * w, min=flr)
    dmw = c + (sumh * torch.sum(w, dim=0))[None, :] * w
    return normalize_columns(w * dmw / dpw)[0]


def _kl_mu_step_local(v, w, h, sparsity, flr):
    """One KL MU step on one device's whole problem (the reference's
    ``axis=None`` form)."""
    h, stats = _h_update(v, w, h, sparsity, flr)
    return _w_update(w, stats, flr), h


def _sharded_steps(vs, w, hs, n_iter, sparsity, flr, mesh):
    for _ in range(n_iter):
        parts = [_h_update(v, w.to(v.device), h, sparsity, flr)
                 for v, h in zip(vs, hs)]
        hs = [p[0] for p in parts]
        stats = psum([p[1] for p in parts], mesh, "data")
        w = _w_update(w, stats.to(w.device), flr)
    return w, hs


def distributed_mu_step(v, w, h, *, sparsity: float = 5.0,
                        flr: float = 1e-9, mesh: Mesh | None = None):
    """One data-parallel KL MU step.  With a mesh, V and H split over
    'data' (a process's block of columns under a group); without, the
    identical single-device math.  Returns (w, h)."""
    if mesh is None:
        return _kl_mu_step_local(v, w, h, sparsity, flr)
    return make_distributed_train_step(mesh, 1, sparsity, flr)(v, w, h)


def make_distributed_train_step(mesh: Mesh, n_iter: int = 1,
                                sparsity: float = 5.0, flr: float = 1e-9):
    """``train_step(v, w, h) -> (w, h)``: ``n_iter`` MU steps with V and H
    split over 'data' once and W replicated."""
    vh = data_sharding(mesh, 2, 1)

    @torch.no_grad()
    def train_step(v, w, h):
        w, hs = _sharded_steps(vh.split(v), w, vh.split(h), n_iter,
                               sparsity, flr, mesh)
        return w, vh.join(hs)

    return train_step
