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
   give the same bits.  Both also run at the exact plan's and the fleet's
   shapes: K1 with one column a lane (N=1, cap 100, eps 1e-3, a dictionary
   of its own a lane, real spectra) at B=8 (the server's), 16, 64 and 128,
   with the trip counts compared column by column; K2 at cap 100 and eps
   1e-3 with two lanes inactive at B=16, 64 and 128 (and at cap 22 at
   B=128), held, relaunched and timed like the rest.  K3 runs
   on the fast plan's own spectra, as the
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
6. exact plan: ``default_config()`` with ``block_adapt=0`` at full width
   (F=513, r_x=r_d=100, r_a=50, m_a=100, cap 100, eps 1e-3, MMSE, Q at gap
   3): ``enhance_batch`` on 16 utterances with the launch counts (K1 and K2
   once a frame, K3 never), the same output checks and correlation, warm
   batch times and a profile at B=16 and B=64; ``separate`` on one
   utterance (the number of sources, ``enhanced`` equal to ``enhance``);
7. streaming: one ``StreamingSession`` on that enhancer fed 160-sample hops
   of one utterance, then ``flush``: at ``block_frames`` 1 and 8 the output
   must be identical to ``enhance`` on the card; with
   ``use_block_adaptive`` at 88 frames it is the block plan's; the host
   milliseconds of every push (median, p99, and of the pushes that
   complete a block) beside the audio of a hop and of a block;
8. fleet: ``MultiStreamSession`` on that enhancer at 16, 64 and 128 lanes,
   ``block_frames=8``, a different 3.43 s utterance a lane, on the frames
   wire, the samples wire and the samples wire with ``pipeline_ticks``:
   the wires' int16 identical on every lane, K1 and K2 launched once a
   frame whatever the fleet's size, the host milliseconds of every tick
   (median, p99, max) beside the block's 80 ms of audio with the share of
   ticks that miss it; lanes 0 and B-1 against solo sessions on the card
   (at most 2 int16 steps apart, under 1% of the samples different);
   a lane reset in mid-session against a fresh fleet, bit for bit; one
   block-adaptive fleet (B=64, 88 frames a tick; its lanes 0 and 63 against
   solo block-adaptive sessions likewise); ``ShardedFleet`` 2 x 64
   against two fleets of 64 and beside one fleet of 128; a profile of a
   few ticks at B=64; and float64 on the card (the plain solvers, chosen
   from the dtype) against the float64 CPU run on all three plans;
9. server: ``EnhanceServer`` (8 lanes, ``block_frames=8``) on loopback on
   the card, three concurrent clients and a fourth on a freed lane, each
   stream identical to a fleet run of the same samples; every await has a
   time limit;
10. training: 60 wavs of 12 s a class (speech-like, white noise) in a
    temporary directory; ``train_event_basis_cached`` of each class on the
    card at ``default_config()`` (R=100, cap 100, eps 1e-3; ~72,000 frames,
    V_DFT 513 x ~72,000 float32 uploaded once) with the host seconds of
    each stage (sequence, features, the exemplar draw, the DFT and Mel
    solves, the save), the trips and device ms of each solve beside its
    bound, and a second call that must hit the cache; the card's training
    held to the CPU's on a 30 s sequence of the same data (float64: within
    1e-9, trips equal; float32 at 100 fixed trips: within twice the CPU
    float32 run's own error to CPU float64); ``dnmf_refit`` (DFT, 60 s of
    each class) timed on the card and held likewise; then the trained
    dictionaries, loaded from ``R_100.npz``, through the headline plan (K1,
    K2), the fast plan ``snmf`` (K3) and the ``exemplar`` preset (R=500 a
    class, no solve; K3 on its R=1000 streaming path, that launch held to
    its plain version and timed beside it and its bound) on 16 noisy
    utterances: int16 of the expected length, finite, correlation >= 0.99
    with the port's float64 CPU run on 2 lanes, and the mean segmental SNR
    and STOI of input and output against the clean signal (the segmental
    SNR must rise, as the CPU tests show the reference's does);
11. a JSON line of the kernels (``launches``: the sum over the paths'
    first runs, each counted from zero, also given by path), the card's
    name and power limit, and the result line ``{"ok": true, "device":
    {...}}`` last.
"""

from __future__ import annotations

import asyncio
import contextlib
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
    """K2 at F=513, R=50, M=100, ~30% of the columns masked: B=8 with lanes
    2 and 5 inactive at cap 22, then B=16, B=64 and B=128 at the headline
    plan's cap 22 (eps 1e-3, and fixed trips with eps 0) and at the exact
    plan's and the fleet's cap 100 and eps 1e-3 with lanes 1 and B-2
    inactive; each launched twice (bit-identical) and with lanes alone (the
    same bits as in the batch); timed in turns with the plain version.
    Returns ({B: max abs error}, {B: times}) at cap 22 and eps 1e-3, and
    {B: (max abs error, ms, plain ms, bound ms, bound by)} at cap 100."""
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
    max_abs, times, at_cap100 = {}, {}, {}
    for b in (16, 64, 128):
        sh = mu.w_solve_lanes_shape(b, 513, 50, 100)
        print(f"kernel K2 launch B={b} F=513 R=50 M=100: {b} clusters of "
              f"{sh['cluster']} blocks x {sh['threads']} threads, "
              f"{sh['smem_bytes']} B shared memory a block, "
              f"{sh['resident_clusters']} clusters resident at once: "
              f"{sh['waves']} waves")
        vb, w0b, hb = inputs(b)
        every = torch.ones(b, dtype=torch.bool, device=dev)
        but_two = every.clone()
        but_two[[1, b - 2]] = False
        for cap, eps, actb in ((22, 1e-3, every), (22, 0.0, every),
                               (100, 1e-3, but_two)):
            args = (vb, w0b, hb, actb, cap, eps, 5.0, 1e-9)
            w, trips = mu.mu_w_solve_lanes(*args)
            err = compare(f"K2 mu_w_solve_lanes B={b} cap={cap} eps={eps} "
                          f"({int(actb.sum())} lanes active)", w, trips,
                          mu.mu_w_solve_lanes_ref, args, lanes)
            if bool(trips[~actb].any()):
                raise AssertionError("K2 ran trips on an inactive lane")
            w2, trips2 = mu.mu_w_solve_lanes(*args)
            same = torch.equal(w, w2) and torch.equal(trips, trips2)
            alone = True
            for i in (0, b - 1):
                wi, ti = mu.mu_w_solve_lanes(
                    vb[i:i + 1], w0b[i:i + 1], hb[i:i + 1], actb[i:i + 1],
                    *args[4:])
                alone = alone and torch.equal(w[i:i + 1], wi) \
                    and torch.equal(trips[i:i + 1], ti)
            print(f"kernel K2 B={b} cap={cap} eps={eps}: two launches "
                  f"bit-identical {same}; lanes 0 and {b - 1} alone equal to "
                  f"the lane in the batch {alone}; trips min "
                  f"{int(trips[actb].min())} max {int(trips.max())}")
            if not (same and alone):
                raise AssertionError("K2 launches on the same inputs differ")
            k1, k2, p1, p2 = in_turns(
                lambda: mu.mu_w_solve_lanes(*args),
                lambda: mu.mu_w_solve_lanes_ref(*args))
            bnd, by = w_bound(vb, 50, trips)
            print(f"kernel K2 time B={b} F=513 R=50 M=100 cap {cap} "
                  f"eps={eps} (mean trips "
                  f"{trips.float().mean().item():.2f}): "
                  f"{k1:.3f}, {k2:.3f} ms, plain {p1:.3f}, {p2:.3f} ms (in "
                  f"turns plain, kernel, kernel, plain); bound {bnd:.4f} ms "
                  f"by {by}, share {bnd / min(k1, k2):.1%} ({card})")
            if cap == 100:
                at_cap100[b] = (err, min(k1, k2), min(p1, p2), bnd, by)
            elif eps > 0:
                max_abs[b] = err
                times[b] = (min(k1, k2), min(p1, p2), bnd, by)
    return max_abs, times, at_cap100


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


def profile_call(fn, *name_groups):
    """Device time by kernel of one call of ``fn``: (wall s, ms of the
    kernels whose names contain one of each group's names in turn, other
    device ms, kernels launched, device busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def profile_batch(enh, batch, *name_groups):
    """``profile_call`` of one warm ``enhance_batch`` call."""
    return profile_call(lambda: enh.enhance_batch(batch, micro_batch=None),
                        *name_groups)


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
        reset_launches(mu)
        t0 = time.perf_counter()
        ys = enh.enhance_batch(xs)
        first_s = time.perf_counter() - t0
        launches = read_launches(mu)
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


def check_h_kernel_one_column(mu, dev, card):
    """K1 at the exact plan's and the fleet's shape: one column a lane
    (F=513, R=200, N=1, cap 100, eps 1e-3) at the server's B=8 and at B=16,
    B=64 and B=128 (lanes 64 and up take other frames of the 64
    utterances), each lane on its own
    dictionary
    (the structured bases with the 50 head columns of the noise part
    rescaled per lane, as a refit leaves them) and one frame of a noisy
    utterance's spectrum.  Held to the plain version with the trip counts
    compared column by column, launched twice (bit-identical), timed in
    turns with the plain version, beside the bound of this run's trips.
    Returns {B: (max abs error, ms, plain ms, bound ms, bound by)}."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.utils.matlab_compat import (
        matlab_v4_rand_matrix)
    cfg = default_config()
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    h0 = t(matlab_v4_rand_matrix(200, 1, cfg.nmf.random_seed))
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=300 + i) for i in range(64)]
    spectra = fast_plan_spectra(cfg, xs, dev)             # (513, 64 * 384)
    n_t = spectra.shape[1] // 64
    cols = lambda same, h: same[:, None, :].expand_as(h)   # noqa: E731
    out = {}
    for b in (8, 16, 64, 128):
        sh = mu.h_solve_lanes_shape(b, 513, 200, 1)
        print(f"kernel K1 launch B={b} F=513 R=200 N=1: {sh['clusters']} "
              f"clusters of {sh['cluster']} blocks x {sh['threads']} threads, "
              f"a group of {sh['group']} column, {sh['smem_bytes']} B shared "
              f"memory a block, {sh['resident_clusters']} clusters resident "
              f"at once")
        head = bd[None, :, :50] * (0.5 + rng.random((b, 1, 50)))
        w = np.concatenate([np.broadcast_to(bx, (b,) + bx.shape), head,
                            np.broadcast_to(bd[:, 50:], (b, 513, 50))],
                           axis=-1)
        frames = [(i % 64) * n_t + 40 + 4 * (i % 64) - 30 * (i // 64)
                  for i in range(b)]
        v = spectra[:, frames].T[:, :, None].contiguous()  # (B, 513, 1)
        args = (v, t(w), h0, 100, 1e-3, 5.0, 1e-9)
        h, trips = mu.mu_h_solve_lanes(*args)
        err = compare(f"K1 mu_h_solve_lanes B={b} N=1 cap=100 eps=0.001", h,
                      trips, mu.mu_h_solve_lanes_ref, args, cols)
        h2, trips2 = mu.mu_h_solve_lanes(*args)
        same = torch.equal(h, h2) and torch.equal(trips, trips2)
        print(f"kernel K1 B={b} N=1: two launches bit-identical {same}; "
              f"trips per column min {int(trips.min())} max "
              f"{int(trips.max())}")
        if not same:
            raise AssertionError("two K1 launches on the same inputs differ")
        k1, k2, p1, p2 = in_turns(lambda: mu.mu_h_solve_lanes(*args),
                                  lambda: mu.mu_h_solve_lanes_ref(*args))
        flops = 4.0 * 513 * 200 * float(trips.sum().item())
        bnd, by = bound(flops, 4.0 * (b * 513 + b * 513 * 200 + 200 + b * 200
                                      + b))
        out[b] = (err, min(k1, k2), min(p1, p2), bnd, by)
        print(f"kernel K1 time B={b} F=513 R=200 N=1 cap 100 eps 1e-3 (mean "
              f"trips {trips.float().mean().item():.2f}): {k1:.3f}, {k2:.3f} "
              f"ms, plain {p1:.3f}, {p2:.3f} ms (in turns plain, kernel, "
              f"kernel, plain); bound {bnd:.4f} ms by {by}, share "
              f"{bnd / out[b][1]:.1%}; GFLOP/s {flops / out[b][1] / 1e6:.1f} "
              f"({card})")
    return out


def reset_launches(mu):
    mu.mu_h_solve_lanes.launches = 0
    mu.mu_w_solve_lanes.launches = 0
    mu.mu_h_solve_columns.launches = 0


def read_launches(mu) -> dict:
    return {"K1": mu.mu_h_solve_lanes.launches,
            "K2": mu.mu_w_solve_lanes.launches,
            "K3": mu.mu_h_solve_columns.launches}


def check_exact_plan(mu, dev, card):
    """Phase 6: the exact per-frame plan at full width
    (``default_config()`` with ``block_adapt=0``), then ``separate``.
    Returns (the enhancer, the utterances, the launches of the first
    ``enhance_batch``)."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = default_config()
    s = cfg.signal
    bx, bd = fixtures.structured_bases(s.n_bins, cfg.sep.r_x, cfg.sep.r_d,
                                       seed=0)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev)
    eng = enh.engine
    print(f"exact plan: H-solve by the {eng.h_solver}, refit by the "
          f"{eng.w_solver} (chosen from the config); the refit kernel is "
          f"launched on every frame: only the device knows which lanes refit")
    if (eng.h_solver, eng.w_solver) != ("kernel", "kernel") \
            or enh.run is not None or enh.fast_run is not None:
        raise AssertionError("default_config() with block_adapt=0 must take "
                             "the exact plan with both kernels")
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(N_UTT)]
    n_frames = N_SAMPLES // s.frameshift + cfg.delay + 1
    n_out = (n_frames - cfg.delay) * s.frameshift
    reset_launches(mu)
    t0 = time.perf_counter()
    ys = enh.enhance_batch(xs)
    first_s = time.perf_counter() - t0
    launches = read_launches(mu)
    print(f"exact plan: enhance_batch B={N_UTT} first call {first_s:.3f} s, "
          f"{n_frames} frames, launches {launches}")
    if launches != {"K1": n_frames, "K2": n_frames, "K3": 0}:
        raise AssertionError(f"the exact plan launches K1 and K2 once a "
                             f"frame ({n_frames}) and never K3: {launches}")
    if not all(y.dtype == np.int16 and y.shape == (n_out,) for y in ys):
        raise AssertionError("outputs are not int16 of the expected length")
    y_float, st = enh.enhance(xs[0], quantize=False, return_state=True)
    if not np.all(np.isfinite(y_float)):
        raise AssertionError("non-finite enhanced waveform")
    head_moved = (st.b_d_head - enh.initial_state().b_d_head).abs().max()
    if not head_moved.item() > 0.0:
        raise AssertionError("no refit changed the noise dictionary")
    rms_in = float(np.sqrt(np.mean(np.square(xs))))
    rms_out = float(np.sqrt(np.mean(np.square(np.stack(ys).astype(float)))))
    if not rms_out < rms_in:
        raise AssertionError(f"output RMS {rms_out} not below input {rms_in}")
    cpu = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu", dtype=torch.float64)
    t0 = time.perf_counter()
    corrs = [float(np.corrcoef(a.astype(float), b.astype(float))[0, 1])
             for a, b in zip(cpu.enhance_batch(xs[:2]), ys[:2])]
    print(f"exact plan outputs: {len(ys)} x int16[{n_out}], finite, rms in "
          f"{rms_in:.1f} -> out {rms_out:.1f}, refits moved the noise head by "
          f"{head_moved.item():.3e}; card f32 vs CPU f64 (plain versions, "
          f"{time.perf_counter() - t0:.1f} s) waveform corr "
          f"{', '.join(f'{c:.6f}' for c in corrs)}")
    if min(corrs) < 0.99:
        raise AssertionError(f"card-to-CPU correlation {min(corrs)} < 0.99")
    audio_s = N_SAMPLES / s.fs
    for b, reps in ((N_UTT, 3), (64, 2)):
        batch = [fixtures.noisy_utterance(N_SAMPLES, seed=100 + i)
                 for i in range(b)]
        reset_launches(mu)
        enh.enhance_batch(batch, micro_batch=None)              # warm
        per_batch = read_launches(mu)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh.enhance_batch(batch, micro_batch=None)
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(f"exact plan warm enhance_batch B={b} ({b * audio_s:.2f} audio "
              f"s): best {best:.4f} s of {[round(x, 4) for x in times]}, "
              f"{b * audio_s / best:.1f} audio-s/s, {best / n_frames * 1e3:.3f} "
              f"ms a frame, launches a batch {per_batch} ({card})")
        wall, k1, k2, other, n_k, busy = profile_batch(
            enh, batch, ("h_lanes_kernel",), ("w_lanes_kernel",))
        print(f"exact plan profile B={b}: wall {wall:.4f} s, K1 {k1:.2f} ms, "
              f"K2 {k2:.2f} ms, other device {other:.2f} ms, kernels launched "
              f"{n_k}, device busy {busy:.1%} ({card})")
    reset_launches(mu)
    src = enh.separate(xs[0])
    sep_launches = read_launches(mu)
    n_ev, n_no = len(cfg.sep.event_rank), len(cfg.sep.noise_rank)
    waves = src["events"] + src["noises"]
    if len(src["events"]) != n_ev or len(src["noises"]) != n_no:
        raise AssertionError("separate: wrong number of sources")
    if not all(w.dtype == np.int16 and w.shape == (n_out,) for w in waves):
        raise AssertionError("separate: a source is not int16 of the "
                             "expected length")
    if not np.array_equal(src["enhanced"], enh.enhance(xs[0])):
        raise AssertionError("separate: 'enhanced' differs from enhance()")
    print(f"exact plan separate: {n_ev} event and {n_no} noise waveforms x "
          f"int16[{n_out}], 'enhanced' equal to enhance(); launches "
          f"{sep_launches}")
    return enh, xs, launches


def check_streaming(mu, enh, x, card):
    """Phase 7: ``StreamingSession`` on the card, fed hops of one utterance
    and flushed.  Exact sessions (``block_frames`` 1 and 8) must give the
    offline ``enhance`` output of the same enhancer; each configuration is
    streamed once to warm it, reset, and streamed again with the host clock
    around every push (a push that completes a block ends in a download).
    Returns the kernels' launches of the ``block_frames=1`` stream."""
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
    cfg = enh.cfg
    shift = cfg.signal.frameshift
    want = enh.enhance(x)
    hop_ms = shift / cfg.signal.fs * 1e3
    first = None
    for bf, ba in ((1, False), (8, False), (88, True)):
        sess = StreamingSession(enh, block_frames=bf, use_block_adaptive=ba)
        for timed in (False, True):
            sess.reset()
            reset_launches(mu)
            parts, ms = [], []
            for i in range(0, len(x) - shift + 1, shift):
                t0 = time.perf_counter()
                parts.append(sess.push(x[i: i + shift]))
                ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            parts.append(sess.flush())
            flush_ms = (time.perf_counter() - t0) * 1e3
            launches = read_launches(mu)
        got = np.concatenate([p for p in parts if len(p)])
        if got.dtype != np.int16 or got.shape != want.shape:
            raise AssertionError("streamed output is not int16 of the "
                                 "offline length")
        name = (f"block_frames={bf}"
                + (" use_block_adaptive" if ba else ""))
        if ba:
            corr = float(np.corrcoef(got.astype(float),
                                     want.astype(float))[0, 1])
            verdict = (f"block plan (an approximation): corr with the exact "
                       f"offline output {corr:.6f}")
            if not corr > 0.9:
                raise AssertionError(f"streaming {name}: corr {corr}")
        else:
            if not np.array_equal(got, want):
                diff = np.abs(got.astype(int) - want.astype(int))
                raise AssertionError(
                    f"streaming {name}: output differs from enhance() on "
                    f"{int((diff > 0).sum())} samples, max {int(diff.max())}")
            verdict = "output identical to enhance() on the card"
            if launches["K1"] != len(ms) + cfg.delay + 1 or launches["K3"]:
                raise AssertionError(f"streaming {name}: launches {launches}")
        if first is None:
            first = launches
        ms = np.asarray(ms)
        print(f"streaming {name}: {len(ms)} pushes of {shift} samples + "
              f"flush, {verdict}; ms a push median {np.median(ms):.3f} p99 "
              f"{np.percentile(ms, 99):.3f} max {ms.max():.3f}, of the "
              f"{len(ms[bf - 1::bf])} pushes that complete a block median "
              f"{np.median(ms[bf - 1::bf]):.3f}, flush {flush_ms:.3f} ms, "
              f"against {hop_ms:.0f} ms of audio a hop and "
              f"{bf * hop_ms:.0f} ms a block; launches {launches} ({card})")
    return first


FLEET_BLOCK = 8             # frames a fleet tick: 80 ms of audio
FLEET_ROUNDS = 3            # timed passes over the wires at each fleet size
FLEET_SIZES = (16, 64, 128)  # lanes; the sharded fleet splits the last in two
FLEET_BA_BLOCK = 88         # frames a tick of the block-adaptive fleet


def push_blocks(fleet, xs, block):
    """Feed a fleet the lanes' samples xs (B, n) one block of hops a push.
    Returns (the pushes' outputs, host ms of every push that completed a
    block)."""
    step = block * fleet.enh.cfg.signal.frameshift
    parts, ms = [], []
    for i in range(0, xs.shape[1], step):
        chunk = xs[:, i: i + step]
        t0 = time.perf_counter()
        parts.append(fleet.push(chunk))
        if chunk.shape[1] == step:
            ms.append((time.perf_counter() - t0) * 1e3)
    return parts, np.asarray(ms)


def drive_fleet(fleet, xs, block, pipelined=False):
    """``push_blocks``, then ``drain`` (pipelined fleets) and ``flush``.
    Returns (int16 output (B, m), the ticks' host ms, flush ms)."""
    parts, ms = push_blocks(fleet, xs, block)
    if pipelined:
        parts.append(np.stack(fleet.drain()))
    t0 = time.perf_counter()
    parts.append(fleet.flush())
    flush_ms = (time.perf_counter() - t0) * 1e3
    return (np.concatenate([p for p in parts if p.shape[1]], axis=1), ms,
            flush_ms)


def tick_line(ms, deadline_ms) -> str:
    """Median, p99 and max of the ticks' host ms, and the share of all of
    them (the first included) that took longer than the block's audio."""
    return (f"ms a tick median {np.median(ms):.3f} p99 "
            f"{np.percentile(ms, 99):.3f} max {ms.max():.3f} over "
            f"{len(ms)} ticks (the fleet's first {ms[0]:.3f}), against "
            f"{deadline_ms:.0f} "
            f"ms of audio a tick: {float((ms > deadline_ms).mean()):.4f} of "
            f"the ticks miss it")


def int16_gap(a, b) -> tuple[int, int, float]:
    """(samples that differ, largest difference, correlation)."""
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return (int((d > 0).sum()), int(d.max(initial=0)),
            float(np.corrcoef(a.astype(float), b.astype(float))[0, 1]))


SOLO_MAX_DIFF = 2           # int16 steps between a fleet lane and a solo session
SOLO_MAX_SHARE = 0.01       # of the samples may differ at all


def hold_to_solo(name, y, solo):
    """A fleet lane's int16 output against a solo session's on the same
    samples: at most ``SOLO_MAX_DIFF`` apart anywhere, and different on
    under ``SOLO_MAX_SHARE`` of the samples.  The correlation is printed."""
    n, mx, corr = int16_gap(y, solo)
    print(f"{name} against a solo session on the card: {n} of {len(solo)} "
          f"int16 samples differ, max difference {mx}, corr {corr:.6f}")
    if y.shape != solo.shape or mx > SOLO_MAX_DIFF \
            or n >= SOLO_MAX_SHARE * len(solo):
        raise AssertionError(f"{name}: {n} samples differ from its solo "
                             f"session's, max {mx}")


def check_fleet(mu, enh, card):
    """Phase 8: the serving fleet on the exact-plan enhancer at full width,
    at the three ``FLEET_SIZES``.  Returns the kernels' launches of the
    first fleet run (the smallest fleet, samples wire), counted from
    zero."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.stream.serving import (
        MultiStreamSession, ShardedFleet)
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
    cfg = enh.cfg
    shift = cfg.signal.frameshift
    block = FLEET_BLOCK
    deadline = block * shift / cfg.signal.fs * 1e3
    sizes, n_samples = FLEET_SIZES, N_SAMPLES
    n_frames = n_samples // shift + cfg.delay + 1
    n_out = (n_frames - cfg.delay) * shift
    small, mid, big = sizes
    xs = np.stack([fixtures.noisy_utterance(n_samples, seed=400 + i)
                   for i in range(big)])
    wires = (("frames", dict(wire="frames")),
             ("samples", dict(wire="samples")),
             ("samples+pipeline_ticks", dict(wire="samples",
                                             pipeline_ticks=True)))
    first = None
    outs = {}                          # B -> the samples wire's output
    tick_ms = {}
    for b in sizes:
        # the wires in turns, FLEET_ROUNDS times over: a one-card machine
        # shares its host's cores, and a neighbour's second of load would
        # otherwise land on one wire's row.  The first round is checked.
        got, rounds = {}, {name: [] for name, _ in wires}
        for rnd in range(FLEET_ROUNDS):
            for name, kw in wires:
                fleet = MultiStreamSession(enh, b, block_frames=block, **kw)
                reset_launches(mu)
                y, ms, flush_ms = drive_fleet(
                    fleet, xs[:b], block, pipelined="pipeline_ticks" in kw)
                launches = read_launches(mu)
                rounds[name].append((ms, flush_ms))
                if rnd:
                    continue
                if first is None and name == "samples":
                    first = launches
                if y.dtype != np.int16 or y.shape != (b, n_out):
                    raise AssertionError(f"fleet B={b} {name}: output "
                                         f"{y.dtype}{y.shape}")
                if launches != {"K1": n_frames, "K2": n_frames, "K3": 0}:
                    raise AssertionError(
                        f"fleet B={b} {name}: K1 and K2 are launched once a "
                        f"frame ({n_frames}) whatever B, K3 never: "
                        f"{launches}")
                got[name] = y
        for name, _ in wires:
            ms = np.concatenate([m for m, _ in rounds[name]])
            tick_ms[(b, name)] = ms
            print(f"fleet B={b} block_frames={block} wire={name}: "
                  f"{tick_line(ms, deadline)}; medians by round "
                  f"{', '.join(f'{np.median(m):.3f}' for m, _ in rounds[name])}"
                  f"; flush "
                  f"{', '.join(f'{f:.3f}' for _, f in rounds[name])} ms; "
                  f"launches a run K1 {n_frames} K2 {n_frames} K3 0 ({card})")
        for name in ("frames", "samples+pipeline_ticks"):
            if not np.array_equal(got[name], got["samples"]):
                n, mx, _ = int16_gap(got[name], got["samples"])
                raise AssertionError(
                    f"fleet B={b}: wire {name} differs from the samples "
                    f"wire on {n} samples, max {mx}")
        print(f"fleet B={b}: frames wire, samples wire and pipelined ticks "
              f"(after drain) int16 identical on all {b} lanes")
        outs[b] = got["samples"]
    # lanes against solo sessions on the card: B=1 products may take other
    # cuBLAS kernels than a fleet's, so identity is not asserted, but the
    # gap is (SOLO_MAX_DIFF, SOLO_MAX_SHARE): this is the one check that
    # crosses fleet sizes
    solo = {}
    for lane in sorted({0} | {b - 1 for b in sizes}):
        sess = StreamingSession(enh, block_frames=block)
        solo[lane] = np.concatenate([sess.push(xs[lane]), sess.flush()])
    for b in sizes:
        for lane in (0, b - 1):
            hold_to_solo(f"fleet B={b} lane {lane}", outs[b][lane],
                         solo[lane])
    # a lane reset at a block boundary for a new tenant
    b, lane = small, min(5, small - 1)
    n_blocks = n_samples // (block * shift)
    cut_blocks = n_blocks * 4 // 7
    more_blocks = n_blocks - cut_blocks
    cut, more = cut_blocks * block * shift, more_blocks * block * shift
    new = fixtures.noisy_utterance(n_samples, seed=900)
    fleet = MultiStreamSession(enh, b, block_frames=block, wire="samples")
    before = fleet.push_per_lane(xs[:b, :cut])
    fleet.reset_lanes([lane])
    tail = xs[:b, cut: cut + more].copy()
    tail[lane] = new[:more]
    after = fleet.push_per_lane(tail)
    fresh = MultiStreamSession(enh, b, block_frames=block, wire="samples")
    head = xs[:b, :more].copy()
    head[lane] = new[:more]
    want_new = fresh.push_per_lane(head)[lane]
    if not np.array_equal(after[lane], want_new):
        n, mx, _ = int16_gap(after[lane], want_new)
        raise AssertionError(f"reset_lanes: the new tenant's lane differs "
                             f"from a fresh fleet's on {n} samples, max {mx}")
    for i in range(b):
        if i == lane:
            continue
        y = np.concatenate([before[i], after[i]])
        if not np.array_equal(y, outs[b][i, : len(y)]):
            raise AssertionError(f"reset_lanes: lane {i} was disturbed")
    print(f"fleet B={b} reset_lanes([{lane}]) after {cut_blocks} blocks: the "
          f"new tenant's {len(want_new)} samples bit-identical to lane "
          f"{lane} of a fresh fleet, the other {b - 1} lanes bit-identical "
          f"to the undisturbed run")
    # one block-adaptive fleet
    b, k = mid, FLEET_BA_BLOCK
    fleet = MultiStreamSession(enh, b, block_frames=k,
                               use_block_adaptive=True)
    reset_launches(mu)
    parts, ms = push_blocks(fleet, xs[:b], k)
    launches = read_launches(mu)      # before the partial tail's exact loop
    parts.append(fleet.flush())
    y = np.concatenate([p for p in parts if p.shape[1]], axis=1)
    corrs = [int16_gap(y[i], outs[b][i])[2] for i in range(b)]
    print(f"fleet B={b} block_frames={k} use_block_adaptive (frames wire): "
          f"{len(ms)} full blocks, launches {launches} (once a block), ms a "
          f"tick {', '.join(f'{m:.3f}' for m in ms)} against "
          f"{k * shift / cfg.signal.fs * 1e3:.0f} ms of audio; corr with the "
          f"exact fleet min {min(corrs):.6f} median "
          f"{float(np.median(corrs)):.6f} ({card})")
    if launches != {"K1": len(ms), "K2": len(ms), "K3": 0} \
            or y.shape != (b, n_out) or not min(corrs) > 0.9:
        raise AssertionError(f"block-adaptive fleet: launches {launches}, "
                             f"output {y.shape}, min corr {min(corrs)}")
    for lane in (0, b - 1):
        sess = StreamingSession(enh, block_frames=k, use_block_adaptive=True)
        hold_to_solo(f"block-adaptive fleet B={b} lane {lane}", y[lane],
                     np.concatenate([sess.push(xs[lane]), sess.flush()]))
    # a sharded fleet of two halves beside one fleet of the whole, in turns
    sh_ms, one_ms = [], []
    for rnd in range(FLEET_ROUNDS):
        sharded = ShardedFleet(enh, big, sub_fleets=2, block_frames=block,
                               wire="samples")
        y, ms, _ = drive_fleet(sharded, xs, block)
        sh_ms.append(ms)
        if rnd == 0:
            upper, _, _ = drive_fleet(
                MultiStreamSession(enh, mid, block_frames=block,
                                   wire="samples"), xs[mid:], block)
            if not (np.array_equal(y[:mid], outs[mid])
                    and np.array_equal(y[mid:], upper)):
                raise AssertionError(f"ShardedFleet 2 x {mid} differs from "
                                     f"two fleets of {mid}")
        one_ms.append(drive_fleet(
            MultiStreamSession(enh, big, block_frames=block, wire="samples"),
            xs, block)[1])
    print(f"ShardedFleet 2 x {mid}, samples wire: int16 identical lane by "
          f"lane to two fleets of {mid}; "
          f"{tick_line(np.concatenate(sh_ms), deadline)}; medians by round "
          f"{', '.join(f'{np.median(m):.3f}' for m in sh_ms)}; one fleet of "
          f"{big} in turns with it: "
          f"{tick_line(np.concatenate(one_ms), deadline)}; medians by round "
          f"{', '.join(f'{np.median(m):.3f}' for m in one_ms)} ({card})")
    # a profile of a few ticks at the middle size
    b, n_ticks = mid, 4
    fleet = MultiStreamSession(enh, b, block_frames=block, wire="samples")
    step = block * shift
    fleet.push(xs[:b, : 2 * step])

    def ticks():
        for i in range(2, 2 + n_ticks):
            fleet.push(xs[:b, i * step: (i + 1) * step])

    wall, k1, k2, other, n_k, busy = profile_call(
        ticks, ("h_lanes_kernel",), ("w_lanes_kernel",))
    print(f"fleet profile B={b} wire=samples, {n_ticks} ticks of {block} "
          f"frames: wall {wall * 1e3 / n_ticks:.3f} ms a tick, K1 "
          f"{k1 / n_ticks:.3f} ms, K2 {k2 / n_ticks:.3f} ms, other device "
          f"{other / n_ticks:.3f} ms a tick, kernels launched "
          f"{n_k / n_ticks:.0f} a tick, device busy {busy:.1%} ({card})")
    return first


def check_float64_on_card(mu, dev, card):
    """Phase 8, float64: ``enhance`` of one 1 s utterance at full width on
    the exact plan, the block plan and the fast plan with
    ``dtype=torch.float64`` on the card (the plain solvers, chosen from the
    dtype; no kernel is launched) against the same enhancer on the CPU:
    within 1e-9 relative, int16 identical."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.headline import HEADLINE_PLAN
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    x = fixtures.noisy_utterance(16000, seed=77)
    for name, cfg, kw in (("exact", default_config(), {}),
                          ("block", default_config(), HEADLINE_PLAN),
                          ("fast", preset("snmf"), {})):
        on_card = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev,
                               dtype=torch.float64, **kw)
        on_cpu = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                              dtype=torch.float64, **kw)
        solvers = {"exact": lambda e: (e.engine.h_solver, e.engine.w_solver),
                   "block": lambda e: (e.run.step.h_solver,
                                       e.run.step.w_solver),
                   "fast": lambda e: (e.fast_run.h_solver,)}[name](on_card)
        reset_launches(mu)
        t0 = time.perf_counter()
        got = on_card.enhance(x, quantize=False)
        card_s = time.perf_counter() - t0
        launches = read_launches(mu)
        t0 = time.perf_counter()
        want = on_cpu.enhance(x, quantize=False)
        cpu_s = time.perf_counter() - t0
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        same = np.array_equal(on_card.enhance(x), on_cpu.enhance(x))
        print(f"float64 on the card, {name} plan (solvers "
              f"{'/'.join(solvers)}): 1.00 s utterance in {card_s:.2f} s "
              f"(CPU {cpu_s:.2f} s), max relative difference to the CPU "
              f"{rel:.3e}, int16 identical {same}, launches {launches} "
              f"({card})")
        if set(solvers) != {"plain"} or any(launches.values()) \
                or not rel <= 1e-9 or not same:
            raise AssertionError(f"float64 on the card, {name} plan")


SERVER_TIMEOUT = 120.0      # seconds, on every await of phase 9
SERVER_SAMPLES = 24000 + 57  # a client's stream: 150 hops and a partial one


def check_server(mu, enh, card):
    """Phase 9: ``EnhanceServer`` (8 lanes, ``block_frames=8``, the default
    samples wire) on loopback on the card: three concurrent clients, then a
    fourth on a freed lane; each gets ``(hops + 1) * 160`` int16 samples,
    those of a fleet run of the same samples.  Returns the kernels'
    launches over the server's life, counted from zero."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.runtime.server import (
        EnhanceServer, enhance_over_socket)
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
    shift = enh.cfg.signal.frameshift
    n_lanes, n = 8, SERVER_SAMPLES
    xs = [fixtures.noisy_utterance(n, seed=700 + i) for i in range(4)]

    def fleet_run(lanes):
        smp = np.zeros((n_lanes, n))
        for lane, x in lanes.items():
            smp[lane] = x
        fleet = MultiStreamSession(enh, n_lanes, block_frames=FLEET_BLOCK,
                                   wire="samples")
        return np.concatenate([fleet.push(smp), fleet.flush()], axis=1)

    want = fleet_run({0: xs[0], 1: xs[1], 2: xs[2]})
    want4 = fleet_run({0: xs[3]})[0]

    async def within(coro):
        return await asyncio.wait_for(coro, timeout=SERVER_TIMEOUT)

    async def go():
        srv = await within(EnhanceServer(
            enh, n_lanes=n_lanes, block_frames=FLEET_BLOCK).start())
        try:
            t0 = time.perf_counter()
            three = await within(asyncio.gather(*[
                enhance_over_socket("127.0.0.1", srv.port, x, chunk=4000)
                for x in xs[:3]]))
            three_s = time.perf_counter() - t0
            for _ in range(int(SERVER_TIMEOUT / 0.01)):
                if all(ln.state == "free" for ln in srv.lanes):
                    break
                await asyncio.sleep(0.01)
            else:
                raise AssertionError("server: the lanes did not free")
            fourth = await within(
                enhance_over_socket("127.0.0.1", srv.port, xs[3]))
            return three, fourth, three_s, srv.ticks
        finally:
            t0 = time.perf_counter()
            await within(srv.stop())
            print(f"server: stop() returned in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    reset_launches(mu)
    three, fourth, three_s, ticks = asyncio.run(
        asyncio.wait_for(go(), timeout=4 * SERVER_TIMEOUT))
    launches = read_launches(mu)
    n_out = (n // shift + 1) * shift
    for i, y in enumerate(three + [fourth]):
        if y.dtype != np.int16 or y.shape != (n_out,):
            raise AssertionError(f"server client {i}: {y.dtype}{y.shape}, "
                                 f"expected int16[{n_out}]")
    # a client's lane is whichever was free when it connected; a lane's
    # stream depends on its own samples only
    for i, y in enumerate(three):
        if not np.array_equal(y, want[i]):
            n_d, mx, _ = int16_gap(y, want[i])
            raise AssertionError(f"server client {i} differs from the fleet "
                                 f"run on {n_d} samples, max {mx}")
    if not np.array_equal(fourth, want4):
        n_d, mx, _ = int16_gap(fourth, want4)
        raise AssertionError(f"server: the fourth client (a freed lane) "
                             f"differs from the fleet run on {n_d} samples, "
                             f"max {mx}")
    if launches["K1"] == 0 or launches["K1"] != launches["K2"] \
            or launches["K3"] or not ticks - FLEET_BLOCK < launches["K1"] \
            <= ticks:
        raise AssertionError(f"server: {ticks} hop ticks, launches "
                             f"{launches}")
    print(f"server: {n_lanes} lanes, block_frames={FLEET_BLOCK}, samples "
          f"wire: three concurrent clients of {n / 16000:.2f} s served in "
          f"{three_s:.3f} s, then a fourth on a freed lane; each "
          f"int16[{n_out}], identical to a fleet run of the same samples; "
          f"{ticks} hop ticks, launches {launches} ({card})")
    return launches


TRAIN_CLIPS = 60           # wavs a class, of TRAIN_CLIP_S each: the default
TRAIN_CLIP_S = 12.0        # 720 s sequence cap, ~72,000 frames
TRAIN_SEEDS = {"speech": 1000, "noise": 2000}   # the clips' first seeds
TRAINED_UTT_SEED = 500     # the enhanced utterances: seeds no clip uses
SHUFFLE_SEED = 7           # the training sequences' file order


@contextlib.contextmanager
def recorded(module, stages=(), solves=False):
    """While in the ``with``, the ``stages`` functions of ``module`` log
    ``(name, host s)`` a call and, with ``solves``, ``module.snmf_solve``
    logs ``("solve", trips, device ms, V's shape)`` (device ms from CUDA
    events around the call, None for CPU tensors)."""
    log, saved = [], {}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            log.append((name, time.perf_counter() - t0))
            return out
        return call

    def solve(fn):
        def call(*a, **k):
            if not a[0].is_cuda:
                res = fn(*a, **k)
                log.append(("solve", int(res.iters), None, tuple(a[0].shape)))
                return res
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(*a, **k)
            stop.record()
            torch.cuda.synchronize()
            log.append(("solve", int(res.iters), start.elapsed_time(stop),
                        tuple(a[0].shape)))
            return res
        return call

    for name in stages:
        saved[name] = getattr(module, name)
        setattr(module, name, timed(name, saved[name]))
    if solves:
        saved["snmf_solve"] = module.snmf_solve
        module.snmf_solve = solve(saved["snmf_solve"])
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def rel_np(got, ref) -> float:
    """``rel_err``'s relative error of two arrays."""
    return rel_err(torch.as_tensor(np.asarray(got)),
                   torch.as_tensor(np.asarray(ref)))[0]


def solve_line(entry, r, products=4) -> str:
    """One solve of a log: trips, device ms and the bound of its products a
    trip (W+H: the H and W updates and the two reconstructions; one factor:
    its update and one reconstruction), each 2 F R N operations."""
    _, trips, ms, (f, n) = entry
    bnd, by = bound(2.0 * products * f * r * n * trips,
                    4.0 * (f * n + 2 * r * (f + n)))
    return (f"{f} x {n}: {trips} trips, {ms:.1f} device ms "
            f"({ms / trips:.3f} a trip; bound {bnd:.1f} ms by {by}, share "
            f"{bnd / ms:.1%})")


def train_class(basis, kind, db, out, cfg, dev, card):
    """Phase 10, one class: ``train_event_basis_cached`` on the card
    (float32) with the host seconds of each stage, the trips and device ms
    of each solve; then the cache hit."""
    stages = ("build_training_sequence", "training_features",
              "exemplar_sample_idx", "_solve_full", "save_basis")
    r = cfg.sep.r_x
    with recorded(basis, stages, solves=True) as log:
        t0 = time.perf_counter()
        pair = basis.train_event_basis_cached(
            db, out, cfg, r, shuffle_rng=np.random.default_rng(SHUFFLE_SEED),
            device=dev)
        total = time.perf_counter() - t0
    secs = [e for e in log if e[0] != "solve"]
    solves = [e for e in log if e[0] == "solve"]
    names = [e[0] for e in secs]
    if names != ["build_training_sequence", "training_features",
                 "exemplar_sample_idx", "_solve_full", "_solve_full",
                 "save_basis"] or len(solves) != 2:
        raise AssertionError(f"training {kind}: stages {names}")
    n_frames = solves[0][3][1]
    print(f"training {kind} (float32 on the card, R={r}): sequence "
          f"{secs[0][1]:.2f} s, features {secs[1][1]:.2f} s, exemplar draw "
          f"{secs[2][1]:.2f} s, DFT solve {secs[3][1]:.2f} s, Mel solve "
          f"{secs[4][1]:.2f} s, save {secs[5][1]:.3f} s; total {total:.2f} s "
          f"host; V_DFT 513 x {n_frames} ({513 * n_frames * 4 / 1e6:.1f} MB "
          f"float32 on the card)")
    for dom, e in zip(("DFT", "Mel"), solves):
        print(f"training {kind} {dom} solve {solve_line(e, r)} ({card})")
    t0 = time.perf_counter()
    with recorded(basis, stages) as hit_log:
        again = basis.train_event_basis_cached(db, out, cfg, r, device=dev)
    hit_s = time.perf_counter() - t0
    print(f"training {kind}: second call a cache hit in {hit_s:.4f} s, "
          f"stages run {[e[0] for e in hit_log]}")
    if hit_log or not (np.array_equal(again.b_dft, pair.b_dft)
                       and np.array_equal(again.b_mel, pair.b_mel)):
        raise AssertionError(f"training {kind}: the second call retrained")
    for name, b, f in (("b_dft", pair.b_dft, 513),
                       ("b_mel", pair.b_mel, cfg.signal.f_order)):
        norms = np.sqrt(np.sum((b.astype(np.float64) - 1e-9) ** 2, axis=0))
        if b.shape != (f, r) or not np.all(np.isfinite(b)) \
                or np.abs(norms - 1.0).max() > 1e-5:
            raise AssertionError(f"training {kind}: {name} {b.shape}, "
                                 f"norms {norms.min()}..{norms.max()}")
    return pair, n_frames


def hold_training(basis, db, cfg, dev, card):
    """Phase 10: the card's training against the CPU's on a 30 s sequence
    of the same data: float64 within 1e-9 with equal trips; float32 at 100
    fixed trips within twice the CPU float32 run's own error to CPU
    float64."""
    from dataclasses import replace

    from se_snmf_nat_tpu_torch.train.dataset import build_training_sequence
    from se_snmf_nat_tpu_torch.train.features import training_features
    cfg30 = cfg.evolve(train=replace(cfg.train, train_seq_len_max_s=30.0))
    seq, _ = build_training_sequence(
        db, cfg30, rng=np.random.default_rng(SHUFFLE_SEED))
    feats = training_features(seq, cfg30)
    r = cfg.sep.r_x

    def run(c, device, dtype):
        t0 = time.perf_counter()
        res = basis.train_event_basis(feats, c, r, device=device,
                                      dtype=dtype)
        return res, time.perf_counter() - t0

    (card64, s_card), (cpu64, s_cpu) = (run(cfg30, dev, torch.float64),
                                        run(cfg30, "cpu", torch.float64))
    err = max(rel_np(card64.basis.b_dft, cpu64.basis.b_dft),
              rel_np(card64.basis.b_mel, cpu64.basis.b_mel),
              rel_np(card64.a_dft, cpu64.a_dft))
    trips = ((card64.iters_dft, card64.iters_mel),
             (cpu64.iters_dft, cpu64.iters_mel))
    print(f"training held, 30 s ({feats.tf_mag.shape[1]} frames), float64, "
          f"eps 1e-3: card {s_card:.2f} s, CPU {s_cpu:.2f} s; max relative "
          f"difference {err:.3e} (limit 1e-9); trips DFT/Mel card "
          f"{trips[0]}, CPU {trips[1]} ({card})")
    if not err <= 1e-9 or trips[0] != trips[1]:
        raise AssertionError("card float64 training disagrees with the CPU")
    fixed = cfg30.evolve(nmf=replace(cfg30.nmf, conv_eps=0.0))
    card32, _ = run(fixed, dev, torch.float32)
    ref64, _ = run(fixed, "cpu", torch.float64)
    cpu32, _ = run(fixed, "cpu", torch.float32)
    for name in ("b_dft", "b_mel"):
        e_card = rel_np(getattr(card32.basis, name), getattr(ref64.basis, name))
        e_cpu = rel_np(getattr(cpu32.basis, name), getattr(ref64.basis, name))
        print(f"training held, float32 at {fixed.nmf.max_iter} fixed trips, "
              f"{name}: card {e_card:.3e} of CPU float64 (CPU float32 "
              f"{e_cpu:.3e}, limit {2 * e_cpu:.3e})")
        if not e_card <= 2.0 * e_cpu:
            raise AssertionError(f"card float32 training, {name}")


def hold_dnmf(dnmf, dirs, pairs, cfg, dev, card):
    """Phase 10, DNMF: ``dnmf_refit`` in the DFT domain on 60 s of clean and
    60 s of noise with the two trained dictionaries, on the card (float32,
    timed) and held to the CPU as the training is."""
    from dataclasses import replace

    from se_snmf_nat_tpu_torch.train.dataset import build_training_sequence
    cfg60 = cfg.evolve(train=replace(cfg.train, train_seq_len_max_s=60.0))
    x, d = (build_training_sequence(
        dirs[k], cfg60, rng=np.random.default_rng(SHUFFLE_SEED))[0]
        for k in ("speech", "noise"))
    b = np.concatenate([pairs["speech"].b_dft, pairs["noise"].b_dft],
                       axis=1).astype(np.float64)
    r = b.shape[1]

    def run(c, device, dtype):
        with recorded(dnmf, solves=True) as log:
            t0 = time.perf_counter()
            out = dnmf.dnmf_refit(x, d, b, c, device=device, dtype=dtype)
        return out, time.perf_counter() - t0, log

    got, s32, log = run(cfg, dev, torch.float32)
    if got.shape != b.shape or not np.all(np.isfinite(got)):
        raise AssertionError("DNMF output")
    for what, e, rr in zip(("Eq. 6 H-only", "Eq. 7 W-only speech",
                            "Eq. 7 W-only noise"), log, (r, r // 2, r // 2)):
        print(f"DNMF float32 on the card, {what} solve "
              f"{solve_line(e, rr, products=2)} ({card})")
    (card64, s64, log64), (cpu64, s_cpu, log_cpu) = (
        run(cfg, dev, torch.float64), run(cfg, "cpu", torch.float64))
    err = rel_np(card64, cpu64)
    trips = ([e[1] for e in log64], [e[1] for e in log_cpu])
    print(f"DNMF held, 60 s + 60 s, float64, eps 1e-3: card {s64:.2f} s, "
          f"CPU {s_cpu:.2f} s (float32 card {s32:.2f} s host); max relative "
          f"difference {err:.3e} (limit 1e-9); trips card {trips[0]}, CPU "
          f"{trips[1]} ({card})")
    if not err <= 1e-9 or trips[0] != trips[1]:
        raise AssertionError("card float64 DNMF disagrees with the CPU")
    fixed = cfg.evolve(nmf=replace(cfg.nmf, conv_eps=0.0))
    card32 = run(fixed, dev, torch.float32)[0]
    ref64 = run(fixed, "cpu", torch.float64)[0]
    cpu32 = run(fixed, "cpu", torch.float32)[0]
    e_card, e_cpu = rel_np(card32, ref64), rel_np(cpu32, ref64)
    print(f"DNMF held, float32 at {fixed.nmf.max_iter} fixed trips: card "
          f"{e_card:.3e} of CPU float64 (CPU float32 {e_cpu:.3e}, limit "
          f"{2 * e_cpu:.3e})")
    if not e_card <= 2.0 * e_cpu:
        raise AssertionError("card float32 DNMF")


def enhance_with_trained(mu, dev, card, pairs, exemplar):
    """Phase 10: the trained dictionaries through the three plans on 16
    noisy utterances: the headline block plan (K1, K2), the fast plan
    ``snmf`` (K3) and the ``exemplar`` preset (K3 at R=1000, its streaming
    path); output checks, correlation with the port's float64 CPU run,
    segmental SNR and STOI against the clean signal.  Returns the launches
    of the three plans' runs, counted from zero, and K3's exemplar launch
    held and timed against its plain version."""
    from se_snmf_nat_tpu_torch import fixtures, metrics
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
    from se_snmf_nat_tpu_torch.stream import fast_pipeline
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=TRAINED_UTT_SEED + i)
          for i in range(N_UTT)]
    cleans = [fixtures.clean_utterance(N_SAMPLES, seed=TRAINED_UTT_SEED + i)
              for i in range(N_UTT)]
    sb, nb = pairs["speech"].b_dft, pairs["noise"].b_dft
    se, ne = exemplar["speech"].b_dft, exemplar["noise"].b_dft
    plans = (
        ("headline", default_config(), (sb, nb, sb, nb), (1, 1, 0),
         build_headline_enhancer),
        ("fast snmf", preset("snmf"), (sb, nb, sb, nb), (0, 0, 1),
         lambda c, b, **kw: SnmfEnhancer(c, *b, **kw)),
        ("exemplar", preset("exemplar"), (se, ne, se, ne), (0, 0, 1),
         lambda c, b, **kw: SnmfEnhancer(c, *b, **kw)))
    k3_calls = []
    inner = fast_pipeline.mu_h_solve_columns

    def record_k3(*args):
        k3_calls.append(args)
        return inner(*args)

    reset_launches(mu)
    total = {"K1": 0, "K2": 0, "K3": 0}
    fast_pipeline.mu_h_solve_columns = record_k3
    try:
        for name, cfg, bases, expect, make in plans:
            enh = make(cfg, bases, device=dev)
            before = read_launches(mu)
            k3_calls.clear()
            t0 = time.perf_counter()
            ys = enh.enhance_batch(xs)
            first_s = time.perf_counter() - t0
            y_float = enh.enhance(xs[0], quantize=False)
            now = read_launches(mu)
            launches = {k: now[k] - before[k] for k in now}
            exemplar_args = k3_calls[0] if name == "exemplar" else None
            n_out = (N_SAMPLES // cfg.signal.frameshift + 1) \
                * cfg.signal.frameshift
            if not all(y.dtype == np.int16 and y.shape == (n_out,)
                       for y in ys) or not np.all(np.isfinite(y_float)):
                raise AssertionError(f"trained, {name}: outputs")
            if tuple(int(launches[k] > 0) for k in ("K1", "K2", "K3")) \
                    != expect:
                raise AssertionError(f"trained, {name}: launches {launches}")
            cpu = make(cfg, bases, device="cpu", dtype=torch.float64)
            corrs = [float(np.corrcoef(a.astype(float), b.astype(float))[0, 1])
                     for a, b in zip(cpu.enhance_batch(xs[:2]), ys[:2])]
            snr = [np.mean([metrics.segmental_snr(c, y, 16000)
                            for c, y in zip(cleans, zs)])
                   for zs in (xs, [y.astype(float) for y in ys])]
            stoi = [np.mean([metrics.stoi(c, y, 16000)
                             for c, y in zip(cleans, zs)])
                    for zs in (xs, [y.astype(float) for y in ys])]
            print(f"trained dictionaries, {name} plan: enhance_batch B="
                  f"{N_UTT} first call {first_s:.3f} s, launches {launches}; "
                  f"{len(ys)} x int16[{n_out}], finite; card f32 vs CPU f64 "
                  f"corr {', '.join(f'{c:.6f}' for c in corrs)}; mean "
                  f"segmental SNR {snr[0]:.3f} -> {snr[1]:.3f} dB, STOI "
                  f"{stoi[0]:.4f} -> {stoi[1]:.4f} ({card})")
            if min(corrs) < 0.99:
                raise AssertionError(f"trained, {name}: correlation")
            # the CPU tests show the reference package raising the
            # segmental SNR of such utterances with dictionaries it trained
            if not snr[1] > snr[0]:
                raise AssertionError(f"trained, {name}: no SNR gain")
            for k in total:
                total[k] += launches[k]
    finally:
        fast_pipeline.mu_h_solve_columns = inner

    v, w, h0, cap, eps, sp, flr = exemplar_args
    f, n = v.shape
    r = w.shape[1]
    shape = mu.mu_h_solve_columns_shape(f, r, n)
    if shape["resident"]:
        raise AssertionError("the exemplar K3 launch took the resident path")
    h, trips = mu.mu_h_solve_columns(*exemplar_args)
    cols = lambda same, hh: same[None, :].expand_as(hh)   # noqa: E731
    err = compare(f"K3 mu_h_solve_columns exemplar F={f} R={r} N={n} "
                  f"cap={cap} eps={eps}", h, trips, mu.mu_h_solve_columns_ref,
                  exemplar_args, cols)
    k1, k2, p1, p2 = in_turns(lambda: mu.mu_h_solve_columns(*exemplar_args),
                              lambda: mu.mu_h_solve_columns_ref(
                                  *exemplar_args))
    ms, plain = min(k1, k2), min(p1, p2)
    col_iters = trips.sum().item()
    bnd, by = bound(4.0 * f * r * col_iters,
                    4.0 * (f * n + f * r + r + r * n + n))
    print(f"kernel K3 time exemplar F={f} R={r} N={n} cap {cap} eps {eps} "
          f"(streaming path, {shape['clusters']} blocks x "
          f"{shape['threads']} threads): {k1:.3f}, {k2:.3f} ms, plain "
          f"{p1:.3f}, {p2:.3f} ms (in turns plain, kernel, kernel, plain); "
          f"mean trips {trips.float().mean().item():.2f}; bound {bnd:.3f} ms "
          f"by {by}, share {bnd / ms:.1%} ({card})")
    return total, (err, ms, plain, bnd, by)


def check_training(mu, dev, card):
    """Phase 10: dictionary training at full width on the card, the holds
    against the CPU, DNMF, and the trained dictionaries through K1, K2 and
    K3.  Returns the launches of the enhancement with them and K3's
    exemplar timing."""
    import tempfile
    from pathlib import Path

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.io.basis import load_basis
    from se_snmf_nat_tpu_torch.train import basis, dnmf
    t_phase = time.perf_counter()
    cfg = default_config()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        dirs = {k: fixtures.write_wav_dir(tmp / k, k, TRAIN_CLIPS,
                                          TRAIN_CLIP_S, seed=TRAIN_SEEDS[k])
                for k in TRAIN_SEEDS}
        print(f"training data: {TRAIN_CLIPS} wavs of {TRAIN_CLIP_S:.0f} s a "
              f"class (speech-like, white noise) written in "
              f"{time.perf_counter() - t0:.2f} s")
        for k in dirs:
            train_class(basis, k, dirs[k], tmp / "basis" / k, cfg, dev, card)
        pairs = {k: load_basis(tmp / "basis" / k / f"R_{cfg.sep.r_x}.npz")
                 for k in dirs}
        hold_training(basis, dirs["speech"], cfg, dev, card)
        hold_dnmf(dnmf, dirs, pairs, cfg, dev, card)
        t0 = time.perf_counter()
        ex_cfg = preset("exemplar")
        exemplar = {k: basis.train_event_basis_cached(
            dirs[k], tmp / "exemplar" / k, ex_cfg, ex_cfg.sep.r_x,
            shuffle_rng=np.random.default_rng(SHUFFLE_SEED), device=dev)
            for k in dirs}
        print(f"training exemplar dictionaries (R={ex_cfg.sep.r_x} a class, "
              f"no solve): {time.perf_counter() - t0:.2f} s host")
        launches, k3 = enhance_with_trained(mu, dev, card, pairs, exemplar)
    print(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, k3


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
    h_one = check_h_kernel_one_column(mu, dev, card)
    w_errs, w_times, w_cap100 = check_w_kernel(
        mu, dev, np.random.default_rng(0), card, lib.log)
    c_errs, c_times = check_cols_kernel(mu, dev, card, lib.log)
    print(NO_LIBRARY)

    # 4. the main path
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    enh = build_headline_enhancer(cfg, bases_to_torch(bx, bd, bx, bd))
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(N_UTT)]
    reset_launches(mu)
    t0 = time.perf_counter()
    ys = enh.enhance_batch(xs)
    first_s = time.perf_counter() - t0
    launches = read_launches(mu)
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

    # 6. the exact plan, 7. streaming
    exact_enh, exact_xs, exact_launches = check_exact_plan(mu, dev, card)
    stream_launches = check_streaming(mu, exact_enh, exact_xs[0], card)

    # 8. the fleet and float64 on the card, 9. the server
    fleet_launches = check_fleet(mu, exact_enh, card)
    check_float64_on_card(mu, dev, card)
    server_launches = check_server(mu, exact_enh, card)

    # 10. dictionary training, and the trained dictionaries through K1-K3
    trained_launches, k3_exemplar = check_training(mu, dev, card)

    # 11. results: each path's launches were counted from zero around its
    # own first run (headline, fast plan, exact plan, the hop-by-hop stream,
    # the first fleet, the server's life, the three plans on the trained
    # dictionaries)
    by_path = {"headline": launches, "fast": {"K1": 0, "K2": 0,
                                              "K3": c_launches},
               "exact": exact_launches, "streaming": stream_launches,
               "fleet": fleet_launches, "server": server_launches,
               "trained": trained_launches}

    def entry(key, name, source, replaces, per_batch, err, timing, **more):
        ms, plain, bnd, by = timing
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(p[key] for p in by_path.values()),
                "launches_by_path": {k: p[key] for k, p in by_path.items()},
                "launches_per_batch": per_batch, "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                "library_ms": None, **more}

    def sub(found):
        return dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by"), found))

    print(json.dumps({"kernels": [
        entry("K1", "mu_h_solve_lanes",
              "se_snmf_nat_tpu_torch/csrc/mu_h_solve.cu", H_REPLACES,
              k1_per_batch, h_errs[HEADLINE_BATCH], h_times[HEADLINE_BATCH],
              one_column=sub(h_one[HEADLINE_BATCH]),
              one_column_b8=sub(h_one[8]),
              one_column_b128=sub(h_one[128])),
        entry("K2", "mu_w_solve_lanes",
              "se_snmf_nat_tpu_torch/csrc/mu_w_solve.cu", W_REPLACES,
              k2_per_batch, w_errs[HEADLINE_BATCH], w_times[HEADLINE_BATCH],
              cap100=sub(w_cap100[HEADLINE_BATCH]),
              cap100_b128=sub(w_cap100[128])),
        entry("K3", "mu_h_solve_columns",
              "se_snmf_nat_tpu_torch/csrc/mu_h_cols.cu", C_REPLACES,
              k3_per_batch, c_errs[25],
              c_times[25],          # cap 25: the fast plan's own launch
              exemplar_r1000=sub(k3_exemplar))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
