"""The MU-solve kernels of the port, with their plain PyTorch versions.

* ``mu_h_solve_lanes`` (``csrc/mu_h_solve.cu``) replaces the TPU kernel
  ``se_snmf_nat_tpu/kernels/mu_pallas.py:_h_solve_kernel`` /
  ``pallas_h_solve`` with the per-column stop of ``snmf_h_solve_columns``.
  A lane's W (513 x 200 f32, 410 KB) exceeds a block's 227 KB of shared
  memory, so a cluster of 8 blocks takes a lane, F split over the blocks
  with each block's slice of W resident for every trip and the partial
  numerators summed through distributed shared memory (see the source).
  Two paths, chosen by the library from (F, R, N) alone: the wide one for
  the block step's H-solve (groups of up to 96 columns, register-tiled FFMA
  products; bound by f32 FMA and shared-memory throughput), and the narrow
  one for N <= N* (``NARROW_MAX``) columns a lane, the exact plan's one
  column a frame (a warp a row group, both products from one sweep of W in
  registers, 4 blocks a SM; bound by that sweep and a trip's barriers).
  ``mu_h_solve_lanes_twin`` and ``mu_h_solve_lanes_narrow_twin`` are the
  plain versions of the two schedules, for the tests.
* ``mu_w_solve_lanes`` (``csrc/mu_w_solve.cu``) replaces
  ``mu_pallas.py:_w_solve_kernel`` / ``pallas_w_solve`` and adds the
  per-lane ``active`` flag of ``snmf_solve``: the per-block refit.  Bound:
  f32 FMA.  One cluster of 8 blocks a lane, F split over the blocks, each
  block's slice of W, U and C and both layouts of H resident in shared
  memory for every trip, register-tiled FFMA products, and the per-trip sums
  over F (column norms, ``corr_p``, ``1'W``, the cost) added through
  distributed shared memory in rank order.  ``mu_w_solve_lanes_twin`` is the
  plain version of that schedule, for the tests.
* ``mu_h_solve_columns`` (``csrc/mu_h_cols.cu``) replaces
  ``mu_pallas.py:_h_cols_kernel`` / ``pallas_h_solve_columns``: the fast
  plan's one H-solve of every frame of a batch on one shared W.  Bound: f32
  FMA.  Persistent clusters of 8 blocks keep their slice of W in shared
  memory for the whole call and walk over the columns in slots that are
  refilled as columns stop; where W's slice does not fit (the exemplar
  width) one block per 16-column tile streams W from L2 through a ring of
  bulk-copied chunks in shared memory into register-blocked FFMA tiles
  (``csrc/mu_tile.cuh``).

Each wrapper takes its plain version (``*_ref``) only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; it never falls back.
Each keeps a plain integer count of kernel launches (``.launches``); a
launch recorded into a CUDA graph counts when the graph replays
(``captured_launches``, ``count_replay``).  K2 also tallies its work in the
counters ``K2_COUNTERS`` (``runtime.profiling``): the lane-trips its active
lanes ran and the number of active lanes, added by the kernel on the card
(every replay of a graph adds too) and on the host by the plain path.  K3
tallies its own in ``K3_COUNTERS``: the columns it solved and their trips,
added by either of its paths on the card and on the host by the plain path,
and, on the streaming path alone, the W chunks its blocks took from their
rings and those that warp 0 found not yet landed (the plain path has no
ring and adds nothing to them).
"""

from __future__ import annotations

import contextlib

import torch

from se_snmf_nat_tpu_torch.nmf.solver import (
    SnmfParams, snmf_h_solve_columns, snmf_solve)

K2_COUNTERS = ("k2.lane_trips", "k2.active_lanes")
K3_COUNTERS = ("k3.columns", "k3.column_trips", "k3.ring_chunks",
               "k3.ring_waits")


_TALLY: dict | None = None    # the launches a graph being captured records


def count_launch(wrapper) -> None:
    """One launch of a kernel wrapper: added to ``wrapper.launches`` at
    once, or, inside ``captured_launches``, to the capture's tally."""
    if _TALLY is None:
        wrapper.launches += 1
    else:
        _TALLY[wrapper] = _TALLY.get(wrapper, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph's capture: the wrappers' launches recorded into
    the graph are tallied (yielded: wrapper -> launches a replay), not
    counted, since the capture runs nothing."""
    global _TALLY
    _TALLY = {}
    try:
        yield _TALLY
    finally:
        _TALLY = None


def count_replay(tally: dict) -> None:
    """One replay of a captured graph: its launches, counted."""
    for wrapper, n in tally.items():
        wrapper.launches += n


def mu_h_solve_lanes_ref(v, w, h0, max_iter: int, conv_eps: float,
                         sparsity: float, flr: float):
    """Plain version of ``mu_h_solve_lanes``: the per-column solver."""
    res = snmf_h_solve_columns(
        v, w, h0, SnmfParams(sparsity=sparsity, max_iter=max_iter,
                             conv_eps=conv_eps, flr=flr))
    return res.h, res.iters


def _twin_trips(h, num, partials, dph, max_iter: int, conv_eps: float):
    """The H-solve kernels' trip loop over (B, R, K) columns, as the twins
    run it: each trip's update from the numerator of the pass before, then
    (but on the last trip) the pass over the new h, whose cost is tested
    against the last; ``partials(h, cost)`` gives (numerator, cost).
    Returns (h, trips (B, K))."""
    b, _, k = h.shape
    early = conv_eps > 0
    active = torch.ones((b, k), dtype=torch.bool, device=h.device)
    trips = torch.zeros(active.shape, dtype=torch.int32, device=h.device)
    last = torch.full(active.shape, float("inf"), dtype=h.dtype,
                      device=h.device)
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
    return h, trips


def _row_slices(f: int, cluster: int) -> list[slice]:
    """F split into ``cluster`` row slices as the kernels split it (the
    first F % cluster slices one row longer)."""
    base, rem = divmod(f, cluster)
    cuts = [k * base + min(k, rem) for k in range(cluster + 1)]
    return [slice(cuts[k], cuts[k + 1]) for k in range(cluster)]


def mu_h_solve_lanes_twin(v, w, h0, max_iter: int, conv_eps: float,
                          sparsity: float, flr: float, cluster: int,
                          group: int):
    """Plain version of ``csrc/mu_h_solve.cu``'s wide schedule, for the
    tests (nothing on the main path uses it): the columns in groups of
    ``group``, F split into ``cluster`` row slices as the kernel splits it,
    and every cross-slice sum taken in slice order from zero: W's sums of
    squares and column sums, the partial numerators W_k'U_k, and each
    column's cost as the sum over k of slice k's KL terms plus the penalty
    of the k-th ceil(R/cluster) rows of H.  Each trip's L is computed after
    the stop test of the trip before, together with the next numerator, and
    the last trip's is skipped, as in the kernel.  Same arguments and
    results as ``mu_h_solve_lanes``."""
    b, f, n = v.shape
    r = w.shape[-1]
    h0 = h0.expand(b, r, n)
    rows = _row_slices(f, cluster)
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
        h, trips = _twin_trips(h, num, partials, dph, max_iter, conv_eps)
        h_out.append(h)
        trips_out.append(trips)
    return torch.cat(h_out, dim=-1), torch.cat(trips_out, dim=-1)


# The narrow path of csrc/mu_h_solve.cu: the most columns a lane it takes
# (MU_H_NARROW_MAX, N*), its cluster size (MU_H_NARROW_CLUSTER) and warps a
# block (1,024 threads over the cluster).
NARROW_MAX = 4
NARROW_CLUSTER = 8
NARROW_WARPS = 32 // NARROW_CLUSTER


def _tree_sum(parts):
    """The narrow kernel's sum of its warps' partials: part i plus part
    i + W/2, then pairwise for k = W/4, ..., 1 (at 4 warps (p0 + p2) +
    (p1 + p3))."""
    w = len(parts)
    acc = [parts[i] + parts[i + w // 2] for i in range(w // 2)]
    k = w // 4
    while k >= 1:
        acc = [acc[i] + acc[i + k] for i in range(k)]
        k //= 2
    return acc[0]


def _narrow_warp_rows(nf: int, nc: int) -> list[list[int]]:
    """The narrow kernel's rows of a slice of nf rows, a list a warp:
    groups of 8 // nc rows dealt to the warps by group index, then the rows
    past the last full group one at a time, continuing the round."""
    g = 8 // nc
    ng = nf // g
    out = [[] for _ in range(NARROW_WARPS)]
    for i in range(ng):
        out[i % NARROW_WARPS] += range(i * g, (i + 1) * g)
    for k in range(nf - ng * g):
        out[(ng + k) % NARROW_WARPS].append(ng * g + k)
    return out


def mu_h_solve_lanes_narrow_twin(v, w, h0, max_iter: int, conv_eps: float,
                                 sparsity: float, flr: float):
    """Plain version of ``csrc/mu_h_solve.cu``'s narrow schedule (N <= N*
    columns a lane), for the tests (nothing on the main path uses it): F
    split into ``NARROW_CLUSTER`` row slices as the kernel splits it, each
    slice's rows dealt to ``NARROW_WARPS`` warps as the kernel deals them
    (``_narrow_warp_rows``), each sum over F taken as the warps' partials
    added in the kernel's tree (``_tree_sum``) and the slices' sums in
    slice order from zero: the partial numerators and the
    KL terms; W's sums of squares and raw column sums in slice order, 1'W as
    the raw sum over the norm; the cost as the KL sum plus sparsity * sum(h).
    The trips as in ``_twin_trips``.  Same arguments and results as
    ``mu_h_solve_lanes``."""
    b, f, n = v.shape
    r = w.shape[-1]
    if not 1 <= n <= 4:
        raise ValueError(f"the narrow path takes 1 to 4 columns, not {n}")
    nc = 1 if n == 1 else 2 if n == 2 else 4
    h0 = h0.expand(b, r, n)
    slices = _row_slices(f, NARROW_CLUSTER)
    warp_rows = [[torch.as_tensor([s.start + i for i in rows],
                                  dtype=torch.long, device=v.device)
                  for rows in _narrow_warp_rows(s.stop - s.start, nc)]
                 for s in slices]
    v = torch.clamp(v, min=flr)
    ss, cs = 0.0, 0.0
    for s in slices:
        ss = ss + torch.sum(w[:, s] * w[:, s], dim=1)
        cs = cs + torch.sum(w[:, s], dim=1)
    norm = torch.sqrt(ss)
    safe = torch.where(norm > 0.0, norm, torch.ones_like(norm))
    w = w / safe[:, None, :]
    dph = torch.clamp(cs / safe + sparsity, min=flr)[:, :, None]

    def partials(h, cost):
        num, div = 0.0, 0.0
        for rows in warp_rows:
            nums, kls = [], []
            for idx in rows:
                if len(idx) == 0:
                    nums.append(0.0)
                    kls.append(0.0)
                    continue
                wk, vk = w[:, idx], v[:, idx]
                lam = torch.clamp(torch.matmul(wk, h), min=flr)
                u = vk / lam
                nums.append(torch.matmul(wk.transpose(-1, -2), u))
                kls.append(torch.sum(vk * torch.log(u) - vk + lam, dim=1)
                           if cost else 0.0)
            num = num + _tree_sum(nums)
            div = div + _tree_sum(kls)
        return num, div + sparsity * torch.sum(h, dim=1)

    h = h0 * norm[:, :, None]
    num, _ = partials(h, False)
    return _twin_trips(h, num, partials, dph, max_iter, conv_eps)


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


def mu_w_solve_lanes_twin(v, w0, h, active, max_iter: int, conv_eps: float,
                          sparsity: float, flr: float, cluster: int):
    """Plain version of ``csrc/mu_w_solve.cu``'s schedule, for the tests
    (nothing on the main path uses it): F split into ``cluster`` row slices
    as the kernel splits it (the first F % cluster slices one row longer),
    and every sum over F taken as per-slice partials added in slice order
    from zero: the column norms, ``corr_p``, ``1'W`` and the scalar cost.
    A trip's cost is tested at the start of the next trip, after the next
    ``C = U H'`` (its partials travel with that trip's column sums), and the
    last trip's L is skipped, as in the kernel.  Same arguments and results
    as ``mu_w_solve_lanes``."""
    b, f, _ = v.shape
    rows = _row_slices(f, cluster)

    def over_slices(fn):
        tot = 0.0
        for s in rows:
            tot = tot + fn(s)
        return tot

    def normalised(w):
        norm = torch.sqrt(over_slices(
            lambda s: torch.sum(w[:, s] * w[:, s], dim=1)))
        safe = torch.where(norm > 0.0, norm, torch.ones_like(norm))
        return w / safe[:, None, :], norm

    v = torch.clamp(v, min=flr)
    w, norm = normalised(w0)
    hs = h * norm[:, :, None]
    sumh = torch.sum(hs, dim=-1)                                 # (B, R)
    pen = torch.sum(sparsity * hs, dim=(-2, -1))
    hst = hs.transpose(-1, -2)
    early = conv_eps > 0

    def lambda_pass(w, cost):
        """U = V / L per slice, and each slice's KL terms."""
        us, kls = [], []
        for s in rows:
            lam = torch.clamp(torch.matmul(w[:, s], hs), min=flr)
            u = v[:, s] / lam
            us.append(u)
            if cost:
                kls.append(torch.sum(v[:, s] * torch.log(u) - v[:, s] + lam,
                                     dim=(-2, -1)))
        return torch.cat(us, dim=1), kls

    run = active.to(torch.bool).clone()
    trips = torch.zeros((b,), dtype=torch.int32, device=v.device)
    last = torch.full((b,), float("inf"), dtype=v.dtype, device=v.device)
    u, kls = lambda_pass(w, False)
    for it in range(max_iter):
        c = torch.matmul(u, hst)                                 # (B, F, R)
        corr_p = over_slices(lambda s: torch.sum(c[:, s] * w[:, s], dim=1))
        colsum = over_slices(lambda s: torch.sum(w[:, s], dim=1))
        if early and it > 0:
            cost = 0.0
            for kl in kls:
                cost = cost + kl
            cost = cost + pen
            rel = torch.abs(cost - last) / torch.abs(last)
            done = rel < conv_eps if it > 1 else torch.zeros_like(run)
            last = torch.where(run, cost, last)
            run = run & ~done
        if not bool(run.any()):
            break
        trips = trips + run.to(torch.int32)
        dpw = torch.clamp(sumh[:, None, :] + corr_p[:, None, :] * w, min=flr)
        dmw = c + (sumh * colsum)[:, None, :] * w
        w = torch.where(run[:, None, None], normalised(w * dmw / dpw)[0], w)
        if it == max_iter - 1:
            break
        u, kls = lambda_pass(w, early)
    return w, trips


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


def _raise_on(rc: int, name: str, unit: str):
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
    count_launch(mu_h_solve_lanes)
    return h, trips


mu_h_solve_lanes.launches = 0


def h_solve_lanes_shape(b: int, f: int, r: int, n: int) -> dict:
    """K1's launch for B lanes of (F, R, N columns): cluster size, group
    (columns a cluster), groups a lane, shared-memory bytes and threads per
    block, clusters the card holds at once, the lanes solved in full
    groups, the narrower group of the last wave's lanes, the clusters
    launched, the path ("wide" or "narrow": one cluster a lane, the group N
    padded to 1, 2 or 4) and the waves of resident clusters.  Needs the
    built library and the card."""
    import ctypes

    from se_snmf_nat_tpu_torch.kernels.build import load
    out = (ctypes.c_int * 11)()
    rc = load().lib.mu_h_solve_lanes_shape(b, f, r, n, ctypes.addressof(out))
    _raise_on(rc, "mu_h_solve_lanes", _GROUP)
    shape = dict(zip(("cluster", "group", "groups", "smem_bytes", "threads",
                      "resident_clusters", "lanes_full", "tail_group",
                      "clusters", "path", "waves"), out))
    shape["path"] = ("wide", "narrow")[shape["path"]]
    return shape


def mu_h_solve_columns(v: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
                       max_iter: int, conv_eps: float, sparsity: float,
                       flr: float):
    """Per-column KL H-solve of N columns on one shared dictionary.

    v (F, N) and h0 (R, N) or one (R, 1) column shared by every column; any
    strides (the fast plan passes its frame-major (N, F) spectra as the
    transposed view), w (F, R) contiguous.  Returns (h (R, N), trips (N,)
    int32): each column freezes at its own relative-cost stop;
    ``conv_eps <= 0`` runs ``max_iter`` trips.  On the card h is the
    transposed view of a frame-major (N, R) tensor.  The columns and their
    trips are added to ``K3_COUNTERS`` (the streaming path adds its ring's
    chunks and waits too)."""
    from se_snmf_nat_tpu_torch.runtime.profiling import count, device_counters
    if v.device.type == "cpu":
        h, trips = mu_h_solve_columns_ref(v, w, h0, max_iter, conv_eps,
                                          sparsity, flr)
        count(K3_COUNTERS[0], trips.numel())
        count(K3_COUNTERS[1], int(trips.sum()))
        return h, trips
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
    # the streaming path's scratch: W's norms, dph and W normalised in both
    # layouts, rows padded to 4 floats (the resident path keeps all of it in
    # shared memory and leaves these untouched; the library alone decides
    # the path)
    padded = (f + 3) // 4 * 4 * ((r + 3) // 4 * 4)
    wn, dph, w_n, w_t = (torch.empty((k,), dtype=torch.float32, device=dev)
                         for k in (r, r, padded, padded))
    counts = device_counters(K3_COUNTERS, dev)
    lib = load().lib
    rc = lib.mu_h_solve_columns(
        v.data_ptr(), *v.stride(), w.data_ptr(), h0.data_ptr(), *h0.stride(),
        h.data_ptr(), *h.stride(), trips.data_ptr(), counts.data_ptr(),
        wn.data_ptr(), dph.data_ptr(), w_n.data_ptr(), w_t.data_ptr(), f, r, n,
        int(max_iter), float(conv_eps), float(sparsity), float(flr),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mu_h_solve_columns", _TILE)
    count_launch(mu_h_solve_columns)
    return h, trips


mu_h_solve_columns.launches = 0

_TILE = "a cluster's slice of W with 4 column slots, or a 16-column tile,"


def mu_h_solve_columns_shape(f: int, r: int, n: int) -> dict:
    """K3's launch for N columns on an (F, R) dictionary: whether W's slice
    stays resident in a persistent cluster's shared memory (else the
    L2-streaming path of 16-column tiles), the column slots of a cluster (or
    columns of a tile), shared-memory bytes and threads per block, the
    clusters (or blocks) launched, the clusters the card holds at once, and
    the streaming path's ring of W chunks: its stages, the rows of W a
    numerator chunk holds, the rows of W' an L chunk holds, and the rounds
    of rows for which the numerator and the L pass each sweep their layout
    of W once (0 on the resident path).  Needs the built library and the
    card."""
    import ctypes

    from se_snmf_nat_tpu_torch.kernels.build import load
    out = (ctypes.c_int * 11)()
    rc = load().lib.mu_h_solve_columns_shape(f, r, n, ctypes.addressof(out))
    _raise_on(rc, "mu_h_solve_columns", _TILE)
    return dict(zip(("resident", "slots", "smem_bytes", "threads", "clusters",
                     "resident_clusters", "ring_stages", "chunk_rows_f",
                     "chunk_rows_r", "num_rounds", "lam_rounds"), out))


def mu_w_solve_lanes(v: torch.Tensor, w0: torch.Tensor, h: torch.Tensor,
                     active: torch.Tensor, max_iter: int, conv_eps: float,
                     sparsity: float, flr: float):
    """W-only KL solve of B independent lanes with H fixed.

    v (B, F, M), w0 (B, F, R), h (B, R, M), active (B,) bool.  Masked
    columns arrive zeroed in w0 and in the rows of h.  Returns
    (w (B, F, R), trips (B,) int32); an inactive lane runs zero trips and
    returns its entry-normalised w0."""
    # imported here: the runtime package imports the engine, which imports
    # this module
    from se_snmf_nat_tpu_torch.runtime.profiling import count, device_counters
    if v.device.type == "cpu":
        w, trips = mu_w_solve_lanes_ref(v, w0, h, active, max_iter, conv_eps,
                                        sparsity, flr)
        count(K2_COUNTERS[0], int(trips.sum()))
        count(K2_COUNTERS[1], int(active.sum()))
        return w, trips
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
    counts = device_counters(K2_COUNTERS, dev)
    rc = load().lib.mu_w_solve_lanes(
        v.data_ptr(), w0.data_ptr(), h.data_ptr(), act.data_ptr(),
        w.data_ptr(), trips.data_ptr(), counts.data_ptr(), b, f, r, m,
        int(max_iter), float(conv_eps), float(sparsity), float(flr),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mu_w_solve_lanes", _LANE)
    count_launch(mu_w_solve_lanes)
    return w, trips


mu_w_solve_lanes.launches = 0

_LANE = "a lane's slice of W, U and C beside H in both layouts"


def w_solve_lanes_shape(b: int, f: int, r: int, m: int) -> dict:
    """K2's launch for B lanes of (F, R, M): cluster size (blocks a lane),
    shared-memory bytes and threads per block, clusters the card holds at
    once and the waves of clusters the B lanes take.  Needs the built
    library and the card."""
    import ctypes

    from se_snmf_nat_tpu_torch.kernels.build import load
    out = (ctypes.c_int * 5)()
    rc = load().lib.mu_w_solve_lanes_shape(b, f, r, m, ctypes.addressof(out))
    _raise_on(rc, "mu_w_solve_lanes", _LANE)
    return dict(zip(("cluster", "smem_bytes", "threads", "resident_clusters",
                     "waves"), out))
