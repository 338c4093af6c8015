"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an H100 and the CUDA
toolkit (no JAX needed).  Phases, one line each; any failure raises and the
exit code is non-zero.  There is no CPU path: without a card it exits 1
before printing any result.

1. device: ``require_cuda()``; the card's name and power limit;
2. build: the CUDA sources of ``se_snmf_nat_tpu_torch/csrc`` (into
   ``build/kernels/``), with the build seconds;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, on entries above 1e-6 of the largest:
   within 1e-4 relative of the plain version run in float64, or, where
   float32 itself is further off (the W-solve's 22 trips amplify f32
   rounding to ~2e-4 on small entries), within twice the float32 plain
   version's own error; where early stops differ only agreeing
   columns/lanes compare.  K1 and K2 run at the main path's B=16 and B=64
   (K1's last wave takes narrower column groups, also held alone; K2 with
   its early stop and with fixed trips, a lane alone against the lane in
   its batch), print their launch shapes and
   ptxas's registers and spills, and two launches on the same inputs must
   give the same bits.  K3 runs on the fast plan's own spectra, as the
   frame-major view it gets there, at R=200, at the exemplar width R=1000
   (the streaming path) and in the Mel mode (F=64), says which path each
   shape took; at the fast plan's own shapes (B=16: N=6,144, cap 25; B=64:
   N=24,576, cap 25 and cap 100) it is held to the plain version on every
   column, launched twice (bit-identical) and, at B=64, timed.  Each
   kernel's time beside the plain version's (in turns:
   plain, kernel, kernel, plain) and beside its bound: the larger of its
   operations over the card's 67 TFLOP/s float32 peak and its bytes (each
   input read once, each output written once) over 3.35 TB/s, from this
   run's shapes and trip counts.  No single PyTorch call computes an
   iterative MU solve, so there is no library yardstick (``library_ms``
   is null);
4. main path: the headline plan (``HEADLINE_PLAN``) at full width on
   synthetic dictionaries: ``enhance_batch`` on 16 utterances of 3.43 s
   (347 frames, 4 blocks of 88) with the kernels' launch counts, output
   checks, the correlation with the port's float64 CPU run on 2 lanes,
   warm batch times at B=16 and B=64, a profile of one B=64 batch, and K2
   timed on the refit inputs of that batch's blocks (the main path's
   ``active`` mix and early stops);
5. fast plan: ``preset("snmf")`` with ``block_adapt=0`` at full width:
   ``enhance_batch`` on 16 utterances with the launch counts (K3 once per
   chunk, K1 and K2 never), the same output checks and correlation, warm
   batch times at B=16 and B=64 and a profile of one B=64 batch; then the
   MMSE+Q fixed variant (``default_config()`` with ``adapt_train_n=False``)
   with the same checks and times;
6. a JSON line of the kernels, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H_REPLACES = "se_snmf_nat_tpu/kernels/mu_pallas.py:122"   # _h_solve_kernel
W_REPLACES = "se_snmf_nat_tpu/kernels/mu_pallas.py:40"    # _w_solve_kernel
C_REPLACES = "se_snmf_nat_tpu/kernels/mu_pallas.py:172"   # _h_cols_kernel
RTOL = 1e-4
PEAK_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM device memory
NO_LIBRARY = ("library_ms null: no single PyTorch call computes an iterative "
              "MU solve")
N_UTT = 16
N_SAMPLES = 54880           # 343 hops + 4 flush frames = 347 frames


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max relative error on entries above 1e-6 of the largest, max abs
    error)."""
    got, ref = got.double(), ref.double()
    if not bool((ref != 0).any()):        # nothing to be relative to
        return (got - ref).abs().max().item(), (got - ref).abs().max().item()
    big = ref.abs() > 1e-6 * ref.abs().max()
    rel = ((got - ref).abs()[big] / ref.abs()[big]).max().item()
    return rel, (got - ref).abs().max().item()


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(bound ms, the resource that sets it): the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def in_turns(kernel_fn, plain_fn):
    """Times in ms, taken in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
    return k1, k2, p1, p2


def compare(name, got, trips, plain_fn, args, lane_axis_trips,
            min_same: float = 0.75):
    """Hold a kernel's result to its plain version on the same inputs:
    within RTOL of the float64 plain version, or (where float32 itself is
    that far off) within twice the float32 plain version's own error.
    Only columns/lanes whose trip counts agree everywhere compare, and at
    least ``min_same`` of them must."""
    ref32, tr32 = plain_fn(*args)
    ref64, tr64 = plain_fn(*(a.double() if torch.is_tensor(a)
                             and a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    same = (trips == tr32) & (trips == tr64)
    sel = lane_axis_trips(same, got)
    err_k, abs_k = rel_err(got[sel], ref64[sel])
    err_p, _ = rel_err(ref32[sel], ref64[sel])
    vs32, abs32 = rel_err(got[sel], ref32[sel])
    limit = max(RTOL, 2.0 * err_p)
    print(f"kernel {name}: max_rel vs plain f64 {err_k:.3e} (plain f32 "
          f"{err_p:.3e}, limit {limit:.3e}); vs plain f32 max_rel "
          f"{vs32:.3e} max_abs {abs32:.3e}; mean_trips "
          f"{trips.float().mean().item():.2f} (plain "
          f"{tr32.float().mean().item():.2f}); other trips "
          f"{int((~same).sum())}/{same.numel()}")
    if err_k > limit or same.float().mean().item() < min_same:
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs32


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas's register and spill lines for one kernel of the build log."""
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            on = kernel in ln
        elif on and ("registers" in ln or "spill" in ln):
            out.append(ln.replace("ptxas info    :", "").strip())
    return out


def check_h_kernel(mu, dev, rng, card, log):
    """K1 at the main path's B=16 and B=64, F=513, R=200, K=88, where the
    last wave's lanes run in narrower column groups: 22 fixed trips, and
    eps 1e-3 / cap 100, each launched twice (bit-identical) and held to the
    plain version on all lanes and on the narrow-group lanes alone; timed
    with 22 fixed trips, in turns with its plain version."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    print(f"kernel K1 ptxas: {' | '.join(ptxas_lines(log, 'h_lanes_kernel'))}")
    h0 = t(rng.random((200, 88)))
    cols = lambda same, h: same[:, None, :].expand_as(h)   # noqa: E731
    max_abs = {}
    times = {}
    for b in (16, 64):
        sh = mu.h_solve_lanes_shape(b, 513, 200, 88)
        lf = sh["lanes_full"]
        print(f"kernel K1 launch B={b} F=513 R=200 K=88: clusters of "
              f"{sh['cluster']} blocks x {sh['threads']} threads, "
              f"{sh['smem_bytes']} B shared memory a block, "
              f"{sh['resident_clusters']} clusters resident at once; "
              f"{lf} lanes in groups of {sh['group']}, the "
              f"rest in groups of {sh['tail_group']}: {sh['clusters']} "
              f"clusters")
        vb = t(rng.gamma(0.6, 2.0, (b, 513, 88)))
        wb = t(rng.random((b, 513, 200)) + 1e-3)
        for max_iter, eps in ((22, 0.0), (100, 1e-3)):
            args = (vb, wb, h0, max_iter, eps, 5.0, 1e-9)
            h, trips = mu.mu_h_solve_lanes(*args)
            err = compare(f"K1 mu_h_solve_lanes B={b} trips={max_iter} "
                          f"eps={eps}", h, trips, mu.mu_h_solve_lanes_ref,
                          args, cols)
            if lf < b:
                compare(f"K1 mu_h_solve_lanes B={b} lanes {lf}-{b - 1} "
                        f"(groups of {sh['tail_group']}) trips={max_iter} "
                        f"eps={eps}", h[lf:], trips[lf:],
                        mu.mu_h_solve_lanes_ref,
                        (vb[lf:], wb[lf:], *args[2:]), cols)
            h2, trips2 = mu.mu_h_solve_lanes(*args)
            same = torch.equal(h, h2) and torch.equal(trips, trips2)
            print(f"kernel K1 B={b} trips={max_iter} eps={eps}: two "
                  f"launches bit-identical {same}")
            if not same:
                raise AssertionError("two K1 launches on the same inputs "
                                     "differ")
            if eps == 0.0:
                max_abs[b] = err
        args = (vb, wb, h0, 22, 0.0, 5.0, 1e-9)
        k1, k2, p1, p2 = in_turns(lambda: mu.mu_h_solve_lanes(*args),
                                  lambda: mu.mu_h_solve_lanes_ref(*args))
        flops = 4.0 * 513 * 200 * 88 * 22 * b
        bnd, by = bound(flops, 4.0 * (b * 513 * 88 + b * 513 * 200 + 200 * 88
                                      + b * 200 * 88 + b * 88))
        times[b] = (min(k1, k2), min(p1, p2), bnd, by)
        print(f"kernel K1 time B={b} F=513 R=200 K=88 22 trips: {k1:.3f}, "
              f"{k2:.3f} ms, plain {p1:.3f}, {p2:.3f} ms (in turns plain, "
              f"kernel, kernel, plain); bound {bnd:.3f} ms by {by}, share "
              f"{bnd / times[b][0]:.1%}; GFLOP/s "
              f"{flops / times[b][0] / 1e6:.1f} (plain "
              f"{flops / times[b][1] / 1e6:.1f}) ({card})")
    return max_abs, times


def w_bound(v, r, trips) -> tuple[float, str]:
    """K2's bound for inputs v (B, F, M), R columns and the lanes' trip
    counts: two products of 2*F*R*M operations a trip; V, W0, H and the
    flags read once, W and the trip counts written once."""
    b, f, m = v.shape
    flops = 4.0 * f * r * m * float(trips.sum().item())
    return bound(flops, 4.0 * (b * f * m + 2 * b * f * r + b * r * m + 2 * b))


def check_w_kernel(mu, dev, rng, card, log):
    """K2 at F=513, R=50, M=100, cap 22, ~30% of the columns masked: B=8
    with lanes 2 and 5 inactive, then the main path's B=16 and B=64 with
    eps 1e-3 and with fixed trips (eps 0), each launched twice
    (bit-identical) and with lanes alone (the same bits as in the batch);
    timed in turns with the plain version."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa

    def inputs(b):
        mask = rng.random((b, 50)) > 0.3
        v = rng.gamma(0.6, 2.0, (b, 513, 100))
        w0 = (rng.random((b, 513, 50)) + 1e-3) * mask[:, None, :]
        h = rng.random((b, 50, 100)) * mask[:, :, None]
        return t(v), t(w0), t(h)

    print(f"kernel K2 ptxas: {' | '.join(ptxas_lines(log, 'w_lanes_kernel'))}")
    lanes = lambda same, w: same[:, None, None].expand_as(w)   # noqa: E731
    v, w0, h = inputs(8)
    act = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool,
                       device=dev)
    args = (v, w0, h, act, 22, 1e-3, 5.0, 1e-9)
    w, trips = mu.mu_w_solve_lanes(*args)
    compare("K2 mu_w_solve_lanes B=8 cap=22 eps=1e-3", w, trips,
            mu.mu_w_solve_lanes_ref, args, lanes)
    print(f"kernel K2 trips per lane {trips.tolist()}")
    if int(trips[2]) or int(trips[5]):
        raise AssertionError("K2 ran trips on an inactive lane")
    max_abs, times = {}, {}
    for b in (16, 64):
        sh = mu.w_solve_lanes_shape(b, 513, 50, 100)
        print(f"kernel K2 launch B={b} F=513 R=50 M=100: {b} clusters of "
              f"{sh['cluster']} blocks x {sh['threads']} threads, "
              f"{sh['smem_bytes']} B shared memory a block, "
              f"{sh['resident_clusters']} clusters resident at once: "
              f"{sh['waves']} waves")
        vb, w0b, hb = inputs(b)
        actb = torch.ones(b, dtype=torch.bool, device=dev)
        for eps in (1e-3, 0.0):
            args = (vb, w0b, hb, actb, 22, eps, 5.0, 1e-9)
            w, trips = mu.mu_w_solve_lanes(*args)
            err = compare(f"K2 mu_w_solve_lanes B={b} cap=22 eps={eps}", w,
                          trips, mu.mu_w_solve_lanes_ref, args, lanes)
            w2, trips2 = mu.mu_w_solve_lanes(*args)
            same = torch.equal(w, w2) and torch.equal(trips, trips2)
            alone = True
            for i in (0, b - 1):
                wi, ti = mu.mu_w_solve_lanes(
                    vb[i:i + 1], w0b[i:i + 1], hb[i:i + 1], actb[:1],
                    *args[4:])
                alone = alone and torch.equal(w[i:i + 1], wi) \
                    and torch.equal(trips[i:i + 1], ti)
            print(f"kernel K2 B={b} eps={eps}: two launches bit-identical "
                  f"{same}; lanes 0 and {b - 1} alone equal to the lane in "
                  f"the batch {alone}")
            if not (same and alone):
                raise AssertionError("K2 launches on the same inputs differ")
            k1, k2, p1, p2 = in_turns(
                lambda: mu.mu_w_solve_lanes(*args),
                lambda: mu.mu_w_solve_lanes_ref(*args))
            bnd, by = w_bound(vb, 50, trips)
            print(f"kernel K2 time B={b} F=513 R=50 M=100 cap 22 eps={eps} "
                  f"(mean trips {trips.float().mean().item():.2f}): "
                  f"{k1:.3f}, {k2:.3f} ms, plain {p1:.3f}, {p2:.3f} ms (in "
                  f"turns plain, kernel, kernel, plain); bound {bnd:.4f} ms "
                  f"by {by}, share {bnd / min(k1, k2):.1%} ({card})")
            if eps > 0:
                max_abs[b] = err
                times[b] = (min(k1, k2), min(p1, p2), bnd, by)
    return max_abs, times


def fast_plan_spectra(cfg, xs, dev):
    """The (F, N) frame-major view of the spectra the fast plan hands K3 for
    a batch (bucketed to 128 frames, flush and padding frames included)."""
    from se_snmf_nat_tpu_torch.dsp.stft import (
        analysis_frames, stream_frames_torch)
    from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
    s = cfg.signal
    n_hops = [len(x) // s.frameshift for x in xs]
    t = -(-(max(n_hops) + cfg.delay + 1) // 128) * 128
    smp = np.zeros((len(xs), t * s.frameshift))
    for i, x in enumerate(xs):
        smp[i, : n_hops[i] * s.frameshift] = x[: n_hops[i] * s.frameshift]
    frames = stream_frames_torch(
        torch.as_tensor(smp, dtype=torch.float32, device=dev),
        torch.as_tensor(n_hops, device=dev), s.framelength, s.frameshift)
    win = torch.as_tensor(sqrt_hann_periodic(s.framelength),
                          dtype=torch.float32, device=dev)
    mag, _ = analysis_frames(frames, win, s.fftlength, s.pow, s.dc_bin,
                             s.nonzerofloor, s.preemph)
    return mag.reshape(-1, mag.shape[-1]).T


def check_cols_kernel(mu, dev, card, log):
    """K3 on the fast plan's spectra of 3.43 s utterances with structured
    dictionaries: N=2048 columns at (F=513, R=200, cap 100), (F=513,
    R=1000, cap 50) and (F=64 Mel, R=200, cap 100), eps 1e-3, with the path
    each shape takes; then the shapes the fast plan launches it at, R=200,
    eps 1e-3: B=16 (N=16*384=6144, the ``snmf`` preset's cap 25) and B=64
    (N=24576, cap 25 and cap 100), every column held to the plain version;
    two launches bit-identical everywhere; the B=64 shapes timed in turns
    with the plain version.  Returns the B=64 shape's max abs errors and
    times by cap."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import preset
    from se_snmf_nat_tpu_torch.dsp.mel import mel_matrix
    from se_snmf_nat_tpu_torch.utils.matlab_compat import (
        matlab_v4_rand_matrix)
    cfg = preset("snmf")
    s = cfg.signal
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    for kernel in ("h_cols_resident_kernel", "h_cols_stream_kernel"):
        print(f"kernel K3 ptxas {kernel}: "
              f"{' | '.join(ptxas_lines(log, kernel))}")
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=200 + i)
          for i in range(64)]
    v = fast_plan_spectra(cfg, xs, dev)                   # (513, 24576)
    melmat = t(mel_matrix(s.fs, s.f_order, s.fftlength, 1.0, s.fs / 2))
    v_mel = torch.matmul(v.T, melmat).T                   # (64, 24576)
    cols = lambda same, h: same[None, :].expand_as(h)    # noqa: E731

    def dictionary(f, r):
        bx, bd = fixtures.structured_bases(f, r // 2, r // 2, seed=0)
        return (t(np.concatenate([bx, bd], axis=1)),
                t(matlab_v4_rand_matrix(r, 1, 1)))

    def launch_line(f, r, n):
        sh = mu.mu_h_solve_columns_shape(f, r, n)
        if sh["resident"]:
            return (f"resident-W path: {sh['clusters']} persistent clusters "
                    f"of 8 blocks x {sh['threads']} threads "
                    f"({sh['resident_clusters']} resident at once), "
                    f"{sh['slots']} column slots a cluster, "
                    f"{sh['smem_bytes']} B shared memory a block")
        return (f"streaming path: {sh['clusters']} blocks x {sh['threads']} "
                f"threads, {sh['slots']} columns a block, "
                f"{sh['smem_bytes']} B shared memory a block")

    for vv, r, cap in ((v, 200, 100), (v, 1000, 50), (v_mel, 200, 100)):
        w, h0 = dictionary(vv.shape[0], r)
        args = (vv[:, :2048], w, h0, cap, 1e-3, 5.0, 1e-9)
        print(f"kernel K3 launch F={vv.shape[0]} R={r} N=2048: "
              f"{launch_line(vv.shape[0], r, 2048)}")
        h, trips = mu.mu_h_solve_columns(*args)
        compare(f"K3 mu_h_solve_columns F={vv.shape[0]} R={r} N=2048 "
                f"cap={cap} eps=1e-3", h, trips, mu.mu_h_solve_columns_ref,
                args, cols)
        h2, trips2 = mu.mu_h_solve_columns(*args)
        same = torch.equal(h, h2) and torch.equal(trips, trips2)
        print(f"kernel K3 F={vv.shape[0]} R={r}: share of columns at the "
              f"cap {(trips == cap).float().mean().item():.4f}; two launches "
              f"bit-identical {same}")
        if not same:
            raise AssertionError("two K3 launches on the same inputs differ")
    w, h0 = dictionary(513, 200)
    n_all = v.shape[1]
    for n in (n_all // 4, n_all):
        print(f"kernel K3 launch F=513 R=200 N={n}: "
              f"{launch_line(513, 200, n)}")
    max_abs, times = {}, {}
    for n, cap in ((n_all // 4, 25), (n_all, 100), (n_all, 25)):
        args = (v[:, :n], w, h0, cap, 1e-3, 5.0, 1e-9)
        h, trips = mu.mu_h_solve_columns(*args)
        err = compare(
            f"K3 mu_h_solve_columns F=513 R=200 N={n} cap={cap} eps=1e-3", h,
            trips, mu.mu_h_solve_columns_ref, args, cols)
        h2, trips2 = mu.mu_h_solve_columns(*args)
        if not (torch.equal(h, h2) and torch.equal(trips, trips2)):
            raise AssertionError("two K3 launches on the same inputs differ")
        if n < n_all:
            print(f"kernel K3 F=513 R=200 N={n} cap {cap}: two launches "
                  f"bit-identical True")
            continue
        max_abs[cap] = err
        col_iters = trips.sum().item()
        k1, k2, p1, p2 = in_turns(lambda: mu.mu_h_solve_columns(*args),
                                  lambda: mu.mu_h_solve_columns_ref(*args))
        ms, plain = min(k1, k2), min(p1, p2)
        flops = 4.0 * 513 * 200 * col_iters    # the two products a trip
        bnd, by = bound(flops, 4.0 * (513 * n + 513 * 200 + 200 + 200 * n
                                      + n))
        times[cap] = (ms, plain, bnd, by)
        print(f"kernel K3 time F=513 R=200 N={n} cap {cap} eps 1e-3: "
              f"{k1:.3f}, {k2:.3f} ms, plain {p1:.3f}, {p2:.3f} ms (in turns "
              f"plain, kernel, kernel, plain); two launches bit-identical "
              f"True; mean trips {trips.float().mean().item():.2f}, share at "
              f"the cap {(trips == cap).float().mean().item():.4f}; "
              f"column-iterations/s {col_iters / ms * 1e3:.4g} (plain "
              f"{col_iters / plain * 1e3:.4g}); useful TFLOP/s "
              f"{flops / ms / 1e9:.2f} (plain {flops / plain / 1e9:.2f}); "
              f"bound {bnd:.3f} ms by {by}, share {bnd / ms:.1%} ({card})")
    return max_abs, times


def profile_batch(enh, batch, *name_groups):
    """Device time by kernel of one warm ``enhance_batch`` call: (wall s,
    ms of the kernels whose names contain one of each group's names in
    turn, other device ms, kernels launched, device busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enh.enhance_batch(batch, micro_batch=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mine = [0.0] * len(name_groups)
    other = 0.0
    n_kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_ms = ev.self_device_time_total / 1e3
        for i, names in enumerate(name_groups):
            if any(name in ev.key for name in names):
                mine[i] += dev_ms
                break
        else:
            other += dev_ms
        n_kernels += ev.count
    busy = (sum(mine) + other) / (wall * 1e3)
    return (wall, *mine, other, n_kernels, busy)


def check_fast_plan(dev, card):
    """Phase 5: the fast plan at full width, ``snmf`` then the MMSE+Q fixed
    variant; returns K3's launch count on the ``snmf`` run and its launches
    in one B=64 batch."""
    from dataclasses import replace

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.kernels import mu
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(N_UTT)]
    dflt = default_config()
    mmse_q = dflt.evolve(adapt=replace(dflt.adapt, adapt_train_n=False))
    k3_launches = per_batch = 0
    for name, cfg in (("snmf", preset("snmf")), ("mmse_q_fixed", mmse_q)):
        enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev)
        mu.mu_h_solve_lanes.launches = 0
        mu.mu_w_solve_lanes.launches = 0
        mu.mu_h_solve_columns.launches = 0
        t0 = time.perf_counter()
        ys = enh.enhance_batch(xs)
        first_s = time.perf_counter() - t0
        launches = {"K1": mu.mu_h_solve_lanes.launches,
                    "K2": mu.mu_w_solve_lanes.launches,
                    "K3": mu.mu_h_solve_columns.launches}
        chunks = -(-len(xs) // 32)                 # micro_batch=32
        print(f"fast plan {name}: enhance_batch B={N_UTT} first call "
              f"{first_s:.3f} s, launches {launches}")
        if launches != {"K1": 0, "K2": 0, "K3": chunks}:
            raise AssertionError(f"fast plan {name}: expected K3 once per "
                                 f"chunk ({chunks}) and no K1/K2: {launches}")
        if name == "snmf":
            k3_launches = launches["K3"]
        n_frames = N_SAMPLES // cfg.signal.frameshift + cfg.delay + 1
        n_out = (n_frames - cfg.delay) * cfg.signal.frameshift
        if not all(y.dtype == np.int16 and y.shape == (n_out,) for y in ys):
            raise AssertionError("outputs are not int16 of the expected "
                                 "length")
        y_float = enh.enhance(xs[0], quantize=False)
        if not np.all(np.isfinite(y_float)):
            raise AssertionError("non-finite enhanced waveform")
        rms_in = float(np.sqrt(np.mean(np.square(xs))))
        rms_out = float(np.sqrt(np.mean(np.square(
            np.stack(ys).astype(float)))))
        if not rms_out < rms_in:
            raise AssertionError(f"output RMS {rms_out} not below input "
                                 f"{rms_in}")
        cpu = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                           dtype=torch.float64)
        corrs = [float(np.corrcoef(a.astype(float), b.astype(float))[0, 1])
                 for a, b in zip(cpu.enhance_batch(xs[:2]), ys[:2])]
        print(f"fast plan {name} outputs: {len(ys)} x int16[{n_out}], "
              f"finite, rms in {rms_in:.1f} -> out {rms_out:.1f}; card f32 "
              f"vs CPU f64 waveform corr "
              f"{', '.join(f'{c:.6f}' for c in corrs)}")
        if min(corrs) < 0.99:
            raise AssertionError(f"card-to-CPU correlation {min(corrs)} < "
                                 f"0.99")
        audio_s = N_SAMPLES / cfg.signal.fs
        for b in (N_UTT, 64):
            batch = [fixtures.noisy_utterance(N_SAMPLES, seed=100 + i)
                     for i in range(b)]
            n0 = mu.mu_h_solve_columns.launches
            enh.enhance_batch(batch, micro_batch=None)          # warm
            if name == "snmf":
                per_batch = mu.mu_h_solve_columns.launches - n0
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                enh.enhance_batch(batch, micro_batch=None)
                times.append(time.perf_counter() - t0)
            best = min(times)
            print(f"fast plan {name} warm enhance_batch B={b} "
                  f"({b * audio_s:.2f} audio s): best {best:.4f} s of "
                  f"{[round(x, 4) for x in times]}, "
                  f"{b * audio_s / best:.1f} audio-s/s ({card})")
        if name == "snmf":
            wall, k3, other, n_k, busy = profile_batch(
                enh, batch, ("h_cols_resident_kernel", "h_cols_stream_kernel",
                             "normalize_w_kernel"))
            print(f"fast plan snmf profile B=64: wall {wall:.4f} s, K3 "
                  f"{k3:.2f} ms, other device {other:.2f} ms, kernels "
                  f"launched {n_k}, device busy {busy:.1%} ({card})")
    return k3_launches, per_batch


def time_w_on_real_refits(mu, enh, batch, card):
    """K2 on the refit inputs of one real headline batch: the block step's
    calls are recorded during one ``enhance_batch`` (with their ``active``
    mix) and replayed, kernel against plain version in turns."""
    from se_snmf_nat_tpu_torch.stream import block_adaptive
    calls = []
    inner = block_adaptive.mu_w_solve_lanes

    def recording(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return inner(*args)

    block_adaptive.mu_w_solve_lanes = recording
    try:
        enh.enhance_batch(batch, micro_batch=None)
    finally:
        block_adaptive.mu_w_solve_lanes = inner
    torch.cuda.synchronize()
    for i, args in enumerate(calls):
        w, trips = mu.mu_w_solve_lanes(*args)
        compare(f"K2 real refit {i} (B={len(batch)})", w, trips,
                mu.mu_w_solve_lanes_ref, args,
                lambda same, w: same[:, None, None].expand_as(w),
                min_same=0.5)
        k1, k2, p1, p2 = in_turns(lambda: mu.mu_w_solve_lanes(*args),
                                  lambda: mu.mu_w_solve_lanes_ref(*args))
        bnd, by = w_bound(args[0], args[1].shape[-1], trips)
        print(f"kernel K2 time on real refit {i} B={len(batch)} "
              f"(active lanes {int(args[3].sum())}, mean trips of the "
              f"active {trips[args[3]].float().mean().item():.2f}): "
              f"{k1:.3f}, {k2:.3f} ms, plain {p1:.3f}, {p2:.3f} ms (in turns "
              f"plain, kernel, kernel, plain); bound {bnd:.4f} ms by {by}, "
              f"share {bnd / min(k1, k2):.1%} ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 1
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.convert import bases_to_torch
    from se_snmf_nat_tpu_torch.device import require_cuda
    from se_snmf_nat_tpu_torch.headline import (
        HEADLINE_BATCH, build_headline_enhancer)
    from se_snmf_nat_tpu_torch.kernels import build, mu

    # 1. device
    dev = require_cuda()
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    lib = build.load()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}; "
          f"ptxas: {' | '.join(ptxas)}")

    # 3. kernels against their plain versions; each check draws its inputs
    # from a generator of its own, so one check's draws never move another's
    h_errs, h_times = check_h_kernel(mu, dev, np.random.default_rng(0), card,
                                     lib.log)
    w_errs, w_times = check_w_kernel(mu, dev, np.random.default_rng(0), card,
                                     lib.log)
    c_errs, c_times = check_cols_kernel(mu, dev, card, lib.log)
    print(NO_LIBRARY)

    # 4. the main path
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    enh = build_headline_enhancer(cfg, bases_to_torch(bx, bd, bx, bd))
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(N_UTT)]
    mu.mu_h_solve_lanes.launches = 0
    mu.mu_w_solve_lanes.launches = 0
    mu.mu_h_solve_columns.launches = 0
    t0 = time.perf_counter()
    ys = enh.enhance_batch(xs)
    first_s = time.perf_counter() - t0
    launches = {"K1": mu.mu_h_solve_lanes.launches,
                "K2": mu.mu_w_solve_lanes.launches,
                "K3": mu.mu_h_solve_columns.launches}
    print(f"main path: enhance_batch B={N_UTT} first call {first_s:.3f} s, "
          f"launches {launches}")
    if launches["K1"] == 0 or launches["K2"] == 0 or launches["K3"] != 0:
        raise AssertionError(f"the headline plan runs K1 and K2 and never "
                             f"K3: {launches}")
    shift = cfg.signal.frameshift
    n_frames = N_SAMPLES // shift + cfg.delay + 1    # data hops + flush
    n_out = (n_frames - cfg.delay) * shift
    rms_in = float(np.sqrt(np.mean(np.square(xs))))
    rms_out = float(np.sqrt(np.mean(np.square(np.stack(ys).astype(float)))))
    if not all(y.dtype == np.int16 and y.shape == (n_out,) for y in ys):
        raise AssertionError("outputs are not int16 of the expected length")
    y_float, st = enh.enhance(xs[0], quantize=False, return_state=True)
    if not np.all(np.isfinite(y_float)):
        raise AssertionError("non-finite enhanced waveform")
    head_moved = (st.b_d_head - enh.initial_state().b_d_head).abs().max()
    if not head_moved.item() > 0.0:
        raise AssertionError("no refit changed the noise dictionary")
    if not rms_out < rms_in:
        raise AssertionError(f"output RMS {rms_out} not below input {rms_in}")
    print(f"main path outputs: {len(ys)} x int16[{n_out}] ({n_frames} "
          f"frames), finite, rms in {rms_in:.1f} -> out {rms_out:.1f}, "
          f"refit moved the noise head by {head_moved.item():.3e}")

    cpu = build_headline_enhancer(cfg, (bx, bd, bx, bd), device="cpu",
                                  dtype=torch.float64)
    corrs = [float(np.corrcoef(a.astype(float), b.astype(float))[0, 1])
             for a, b in zip(cpu.enhance_batch(xs[:2]), ys[:2])]
    print(f"card f32 vs CPU f64 (plain versions) waveform corr: "
          f"{', '.join(f'{c:.6f}' for c in corrs)}")
    if min(corrs) < 0.99:
        raise AssertionError(f"card-to-CPU correlation {min(corrs)} < 0.99")

    audio_s = N_SAMPLES / cfg.signal.fs
    for b in (N_UTT, HEADLINE_BATCH):
        batch = [fixtures.noisy_utterance(N_SAMPLES, seed=100 + i)
                 for i in range(b)]
        n_k1, n_k2 = (mu.mu_h_solve_lanes.launches,
                      mu.mu_w_solve_lanes.launches)
        enh.enhance_batch(batch, micro_batch=None)          # warm
        k1_per_batch = mu.mu_h_solve_lanes.launches - n_k1
        k2_per_batch = mu.mu_w_solve_lanes.launches - n_k2
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh.enhance_batch(batch, micro_batch=None)
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(f"main path warm enhance_batch B={b} ({b * audio_s:.2f} audio "
              f"s): best {best:.4f} s of {[round(x, 4) for x in times]}, "
              f"{b * audio_s / best:.1f} audio-s/s ({card})")
    wall, k1, k2, other, n_k, busy = profile_batch(
        enh, batch, ("h_lanes_kernel",), ("w_lanes_kernel",))
    print(f"main path profile B={b}: wall {wall:.4f} s, K1 {k1:.2f} ms, K2 "
          f"{k2:.2f} ms, other device {other:.2f} ms, kernels launched "
          f"{n_k}, device busy {busy:.1%} ({card})")
    time_w_on_real_refits(mu, enh, batch, card)

    # 5. the fast plan
    c_launches, k3_per_batch = check_fast_plan(dev, card)

    # 6. results
    def entry(name, source, replaces, n_launches, per_batch, err, timing):
        ms, plain, bnd, by = timing
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "launches_per_batch": per_batch, "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("mu_h_solve_lanes", "se_snmf_nat_tpu_torch/csrc/mu_h_solve.cu",
              H_REPLACES, launches["K1"], k1_per_batch,
              h_errs[HEADLINE_BATCH], h_times[HEADLINE_BATCH]),
        entry("mu_w_solve_lanes", "se_snmf_nat_tpu_torch/csrc/mu_w_solve.cu",
              W_REPLACES, launches["K2"], k2_per_batch,
              w_errs[HEADLINE_BATCH], w_times[HEADLINE_BATCH]),
        entry("mu_h_solve_columns", "se_snmf_nat_tpu_torch/csrc/mu_h_cols.cu",
              C_REPLACES, c_launches, k3_per_batch, c_errs[25],
              c_times[25])]}))      # cap 25: the fast plan's own launch
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
