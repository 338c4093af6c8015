"""The MU-solve kernels of the port, with their plain PyTorch versions.

* ``mu_h_solve_lanes`` (``csrc/mu_h_solve.cu``) replaces the TPU kernel
  ``se_snmf_nat_tpu/kernels/mu_pallas.py:_h_solve_kernel`` /
  ``pallas_h_solve`` with the per-column stop of ``snmf_h_solve_columns``:
  the block step's H-solve.  Bound on the H100: f32 FMA and shared-memory
  throughput.  A lane's W (513 x 200 f32, 410 KB) exceeds a block's 227 KB
  of shared memory, so a cluster of blocks takes one lane's group of up to
  96 columns, F split over the blocks with each block's slice of W resident
  for every trip, and the partial numerators summed through distributed
  shared memory (see the source).  ``mu_h_solve_lanes_twin`` is the plain
  version of that schedule, for the tests.
* ``mu_w_solve_lanes`` (``csrc/mu_w_solve.cu``) replaces
  ``mu_pallas.py:_w_solve_kernel`` / ``pallas_w_solve`` and adds the
  per-lane ``active`` flag of ``snmf_solve``: the per-block refit.  Bound:
  per-trip reductions over the whole lane, so one block per lane; with B
  lanes it fills at most B SMs and is latency-bound.
* ``mu_h_solve_columns`` (``csrc/mu_h_cols.cu``) replaces
  ``mu_pallas.py:_h_cols_kernel`` / ``pallas_h_solve_columns``: the fast
  plan's one H-solve of every frame of a batch on one shared W.  One block
  per 16-column tile (``csrc/mu_tile.cuh``) with W streamed from L2; the
  grid runs over column tiles only, so at the fast plan's N = B*T columns
  it fills every SM.

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


def mu_h_solve_lanes_twin(v, w, h0, max_iter: int, conv_eps: float,
                          sparsity: float, flr: float, cluster: int,
                          group: int):
    """Plain version of ``csrc/mu_h_solve.cu``'s schedule, for the tests
    (nothing on the main path uses it): the columns in groups of ``group``,
    F split into ``cluster`` row slices as the kernel splits it (the first
    F % cluster slices one row longer), and every cross-slice sum taken in
    slice order from zero: W's sums of squares and column sums, the partial
    numerators W_k'U_k, and each column's cost as the sum over k of slice
    k's KL terms plus the penalty of the k-th ceil(R/cluster) rows of H.
    Each trip's L is computed after the stop test of the trip before,
    together with the next numerator, and the last trip's is skipped, as in
    the kernel.  Same arguments and results as ``mu_h_solve_lanes``."""
    b, f, n = v.shape
    r = w.shape[-1]
    h0 = h0.expand(b, r, n)
    base, rem = divmod(f, cluster)
    cuts = [k * base + min(k, rem) for k in range(cluster + 1)]
    rows = [slice(cuts[k], cuts[k + 1]) for k in range(cluster)]
    rc = -(-r // cluster)
    owned = [slice(min(r, k * rc), min(r, (k + 1) * rc))
             for k in range(cluster)]
    v = torch.clamp(v, min=flr)
    ss = 0.0
    for s in rows:
        ss = ss + torch.sum(w[:, s] * w[:, s], dim=1)
    norm = torch.sqrt(ss)
    w = w / torch.where(norm > 0.0, norm, torch.ones_like(norm))[:, None, :]
    cs = 0.0
    for s in rows:
        cs = cs + torch.sum(w[:, s], dim=1)
    dph = torch.clamp(cs + sparsity, min=flr)[:, :, None]
    early = conv_eps > 0
    h_out, trips_out = [], []
    for g0 in range(0, n, group):
        vg = v[..., g0:g0 + group]

        def partials(h, cost):
            num, tot = 0.0, 0.0
            for s, o in zip(rows, owned):
                lam = torch.clamp(torch.matmul(w[:, s], h), min=flr)
                u = vg[:, s] / lam
                num = num + torch.matmul(w[:, s].transpose(-1, -2), u)
                if cost:
                    kl = torch.sum(vg[:, s] * torch.log(u) - vg[:, s] + lam,
                                   dim=1)
                    tot = tot + (kl + torch.sum(sparsity * h[:, o], dim=1))
            return num, tot

        h = h0[..., g0:g0 + group] * norm[:, :, None]
        num, _ = partials(h, False)
        active = torch.ones((b, vg.shape[-1]), dtype=torch.bool,
                            device=v.device)
        trips = torch.zeros(active.shape, dtype=torch.int32, device=v.device)
        last = torch.full(active.shape, float("inf"), dtype=v.dtype,
                          device=v.device)
        for it in range(max_iter):
            if early and not bool(active.any()):
                break
            h = torch.where(active[:, None, :], h * num / dph, h)
            trips = trips + active.to(torch.int32)
            if it == max_iter - 1:
                break
            num, cost = partials(h, early)
            if early:
                rel = torch.abs(cost - last) / torch.abs(last)
                if it > 0:
                    active = active & ~(rel < conv_eps)
                last = cost
        h_out.append(h)
        trips_out.append(trips)
    return torch.cat(h_out, dim=-1), torch.cat(trips_out, dim=-1)


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


def _raise_on(rc: int, name: str, unit: str = "a 16-column tile"):
    if rc == -1:
        raise ValueError(f"{name}: {unit} of this F and R does not fit in a "
                         f"block's 227 KB of shared memory")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


_GROUP = "a column group of 4 columns and the cluster's slice of W"


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
    lib = load().lib
    rc = lib.mu_h_solve_lanes(
        v.data_ptr(), w.data_ptr(), h0.data_ptr(), stride, h.data_ptr(),
        trips.data_ptr(), b, f, r, n, int(max_iter), float(conv_eps),
        float(sparsity), float(flr),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mu_h_solve_lanes", _GROUP)
    mu_h_solve_lanes.launches += 1
    return h, trips


mu_h_solve_lanes.launches = 0


def h_solve_lanes_shape(b: int, f: int, r: int, n: int) -> dict:
    """K1's launch for B lanes of (F, R, N columns): cluster size, group
    (columns a cluster), groups a lane, shared-memory bytes and threads per
    block, clusters the card holds at once, the lanes solved in full
    groups, the narrower group of the last wave's lanes, and the clusters
    launched.  Needs the built library and the card."""
    import ctypes

    from se_snmf_nat_tpu_torch.kernels.build import load
    out = (ctypes.c_int * 9)()
    rc = load().lib.mu_h_solve_lanes_shape(b, f, r, n, ctypes.addressof(out))
    _raise_on(rc, "mu_h_solve_lanes", _GROUP)
    return dict(zip(("cluster", "group", "groups", "smem_bytes", "threads",
                     "resident_clusters", "lanes_full", "tail_group",
                     "clusters"), out))


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
