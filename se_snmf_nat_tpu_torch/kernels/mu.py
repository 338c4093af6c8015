"""The MU-solve kernels of the port, with their plain PyTorch versions.

* ``mu_h_solve_lanes`` (``csrc/mu_h_solve.cu``) replaces the TPU kernel
  ``se_snmf_nat_tpu/kernels/mu_pallas.py:_h_solve_kernel`` /
  ``pallas_h_solve`` with the per-column stop of ``snmf_h_solve_columns``:
  the block step's H-solve.  Bound on the H100: shared-memory and f32 FMA
  throughput; a lane's W (513 x 200 f32, 410 KB) exceeds a block's 227 KB of
  shared memory, so one block takes a (lane, 16-column) tile and streams W
  from L2 (see the source).
* ``mu_w_solve_lanes`` (``csrc/mu_w_solve.cu``) replaces
  ``mu_pallas.py:_w_solve_kernel`` / ``pallas_w_solve`` and adds the
  per-lane ``active`` flag of ``snmf_solve``: the per-block refit.  Bound:
  per-trip reductions over the whole lane, so one block per lane; with B
  lanes it fills at most B SMs and is latency-bound.
* ``mu_h_solve_columns`` (``csrc/mu_h_cols.cu``) replaces
  ``mu_pallas.py:_h_cols_kernel`` / ``pallas_h_solve_columns``: the fast
  plan's one H-solve of every frame of a batch on one shared W.  Bound as
  K1 (the same tile loop, ``csrc/mu_tile.cuh``); the grid runs over column
  tiles only, so at the fast plan's N = B*T columns it fills every SM.

Each wrapper takes its plain version (``*_ref``) only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; it never falls back.
Each keeps a plain integer count of kernel launches (``.launches``).
"""

from __future__ import annotations

import torch

from se_snmf_nat_tpu_torch.nmf.solver import (
    SnmfParams, snmf_h_solve_columns, snmf_solve)


def mu_h_solve_lanes_ref(v, w, h0, max_iter: int, conv_eps: float,
                         sparsity: float, flr: float):
    """Plain version of ``mu_h_solve_lanes``: the per-column solver."""
    res = snmf_h_solve_columns(
        v, w, h0, SnmfParams(sparsity=sparsity, max_iter=max_iter,
                             conv_eps=conv_eps, flr=flr))
    return res.h, res.iters


def mu_h_solve_columns_ref(v, w, h0, max_iter: int, conv_eps: float,
                           sparsity: float, flr: float):
    """Plain version of ``mu_h_solve_columns``: the per-column solver, with
    a one-column h0 broadcast over the N columns first (as the reference's
    fast plan does, so the first product is the same (R, N) one)."""
    return mu_h_solve_lanes_ref(v, w, h0.expand(-1, v.shape[-1]), max_iter,
                                conv_eps, sparsity, flr)


def mu_w_solve_lanes_ref(v, w0, h, active, max_iter: int, conv_eps: float,
                         sparsity: float, flr: float):
    """Plain version of ``mu_w_solve_lanes``: the W-only solver, every
    column updating (masked columns arrive zeroed and stay zero)."""
    b, r = w0.shape[0], w0.shape[-1]
    ones = torch.ones((b, r), dtype=torch.bool, device=w0.device)
    res = snmf_solve(v, w0, h, ones, ~ones,
                     SnmfParams(sparsity=sparsity, max_iter=max_iter,
                                conv_eps=conv_eps, flr=flr),
                     update_w=True, update_h=False, active=active,
                     need_stats=False)
    return res.w, res.iters


def _check(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str):
    if rc == -1:
        raise ValueError(f"{name}: a 16-column tile of this F and R does not "
                         f"fit in a block's 227 KB of shared memory")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def mu_h_solve_lanes(v: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
                     max_iter: int, conv_eps: float, sparsity: float,
                     flr: float):
    """Per-column KL H-solve of B independent lanes.

    v (B, F, N), w (B, F, R), h0 (B, R, N) or (R, N) shared by every lane.
    Returns (h (B, R, N), trips (B, N) int32): each column freezes at its
    own relative-cost stop; ``conv_eps <= 0`` runs ``max_iter`` trips."""
    if v.device.type == "cpu":
        return mu_h_solve_lanes_ref(v, w, h0, max_iter, conv_eps, sparsity,
                                    flr)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    from se_snmf_nat_tpu_torch.kernels.build import load
    b, f, n = v.shape
    r = w.shape[-1]
    dev = v.device
    _check("v", v, (b, f, n), dev)
    _check("w", w, (b, f, r), dev)
    if h0.dim() == 2:
        _check("h0", h0, (r, n), dev)
        stride = 0
    else:
        _check("h0", h0, (b, r, n), dev)
        stride = r * n
    h = torch.empty((b, r, n), dtype=torch.float32, device=dev)
    trips = torch.empty((b, n), dtype=torch.int32, device=dev)
    wn = torch.empty((b, r), dtype=torch.float32, device=dev)
    dph = torch.empty((b, r), dtype=torch.float32, device=dev)
    w_n = torch.empty((b, f, r), dtype=torch.float32, device=dev)
    w_t = torch.empty((b, r, f), dtype=torch.float32, device=dev)
    lib = load().lib
    rc = lib.mu_h_solve_lanes(
        v.data_ptr(), w.data_ptr(), h0.data_ptr(), stride, h.data_ptr(),
        trips.data_ptr(), wn.data_ptr(), dph.data_ptr(), w_n.data_ptr(),
        w_t.data_ptr(), b, f, r, n, int(max_iter), float(conv_eps),
        float(sparsity), float(flr),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mu_h_solve_lanes")
    mu_h_solve_lanes.launches += 1
    return h, trips


mu_h_solve_lanes.launches = 0


def mu_h_solve_columns(v: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
                       max_iter: int, conv_eps: float, sparsity: float,
                       flr: float):
    """Per-column KL H-solve of N columns on one shared dictionary.

    v (F, N) and h0 (R, N) or one (R, 1) column shared by every column; any
    strides (the fast plan passes its frame-major (N, F) spectra as the
    transposed view), w (F, R) contiguous.  Returns (h (R, N), trips (N,)
    int32): each column freezes at its own relative-cost stop;
    ``conv_eps <= 0`` runs ``max_iter`` trips.  On the card h is the
    transposed view of a frame-major (N, R) tensor."""
    if v.device.type == "cpu":
        return mu_h_solve_columns_ref(v, w, h0, max_iter, conv_eps, sparsity,
                                      flr)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    from se_snmf_nat_tpu_torch.kernels.build import load
    f, n = v.shape
    r = w.shape[-1]
    dev = v.device
    for name, t in (("v", v), ("h0", h0)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
    if h0.dim() != 2 or h0.shape[0] != r or h0.shape[1] not in (1, n):
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected ({r}, 1) "
                         f"or ({r}, {n})")
    _check("w", w, (f, r), dev)
    h0 = h0.expand(r, n)
    h = torch.empty((n, r), dtype=torch.float32, device=dev).t()
    trips = torch.empty((n,), dtype=torch.int32, device=dev)
    wn = torch.empty((r,), dtype=torch.float32, device=dev)
    dph = torch.empty((r,), dtype=torch.float32, device=dev)
    w_n = torch.empty((f, r), dtype=torch.float32, device=dev)
    w_t = torch.empty((r, f), dtype=torch.float32, device=dev)
    lib = load().lib
    rc = lib.mu_h_solve_columns(
        v.data_ptr(), *v.stride(), w.data_ptr(), h0.data_ptr(), *h0.stride(),
        h.data_ptr(), *h.stride(), trips.data_ptr(), wn.data_ptr(),
        dph.data_ptr(), w_n.data_ptr(), w_t.data_ptr(), f, r, n,
        int(max_iter), float(conv_eps), float(sparsity), float(flr),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mu_h_solve_columns")
    mu_h_solve_columns.launches += 1
    return h, trips


mu_h_solve_columns.launches = 0


def mu_w_solve_lanes(v: torch.Tensor, w0: torch.Tensor, h: torch.Tensor,
                     active: torch.Tensor, max_iter: int, conv_eps: float,
                     sparsity: float, flr: float):
    """W-only KL solve of B independent lanes with H fixed.

    v (B, F, M), w0 (B, F, R), h (B, R, M), active (B,) bool.  Masked
    columns arrive zeroed in w0 and in the rows of h.  Returns
    (w (B, F, R), trips (B,) int32); an inactive lane runs zero trips and
    returns its entry-normalised w0."""
    if v.device.type == "cpu":
        return mu_w_solve_lanes_ref(v, w0, h, active, max_iter, conv_eps,
                                    sparsity, flr)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    from se_snmf_nat_tpu_torch.kernels.build import load
    b, f, m = v.shape
    r = w0.shape[-1]
    dev = v.device
    _check("v", v, (b, f, m), dev)
    _check("w0", w0, (b, f, r), dev)
    _check("h", h, (b, r, m), dev)
    if active.device != dev or tuple(active.shape) != (b,):
        raise ValueError(f"active must be ({b},) on {dev}")
    act = active.to(torch.int32).contiguous()
    w = torch.empty((b, f, r), dtype=torch.float32, device=dev)
    trips = torch.empty((b,), dtype=torch.int32, device=dev)
    u_scr = torch.empty((b, f, m), dtype=torch.float32, device=dev)
    c_scr = torch.empty((b, f, r), dtype=torch.float32, device=dev)
    lib = load().lib
    rc = lib.mu_w_solve_lanes(
        v.data_ptr(), w0.data_ptr(), h.data_ptr(), act.data_ptr(),
        w.data_ptr(), trips.data_ptr(), u_scr.data_ptr(), c_scr.data_ptr(),
        b, f, r, m, int(max_iter), float(conv_eps), float(sparsity),
        float(flr), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mu_w_solve_lanes")
    mu_w_solve_lanes.launches += 1
    return w, trips


mu_w_solve_lanes.launches = 0
