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
11. baselines: the three baseline enhancers at their published
    parameters on the phase-4 utterances, K1-K3 counted from zero around
    the phase and required to stay at 0.  First, whether cuFFT and the
    halving sum give a row the same bits alone as in a batch (and
    ``torch.sum``, which need not), and the host's time a launch.
    ``OmlsaEnhancer`` (M=512, hop
    128): ``enhance_batch`` at B=16 (int16 of the expected length, finite,
    RMS below the input's), lane 0 int16 identical to ``enhance``,
    correlation >= 0.99 with the port's float64 CPU run on 2 lanes, card
    float64 within 1e-9 of CPU float64 with int16 identical, warm batches
    at B=16 (the better of two calls) and B=64 (one call) in audio-s/s and
    host ms a frame, and a profile of one B=64 call (kernels a frame,
    device busy share; the raw CUDA events are counted, not parsed).
    ``MmseEnhancer`` (ni=160, nf=320): the same for tracker ``martin`` with
    ``lg=1``, then ``martin`` with ``lg=0`` and ``mmse`` timed at B=16
    only; each also streamed in chunks of 1,600 samples with
    ``return_state=True``, int16 identical to the one-shot ``enhance``.
    BNMF at ``BnmfParams()``: the speech model trained on 30 s of clean
    speech (seconds, the 100 trips' device ms); the noise init timed
    alone; online ``enhance`` of two utterances (the second profiled) and
    supervised mode with a noise signal (int16, finite, mean segmental SNR
    above the input's); ``BnmfStreamingSession`` at ``block_frames`` 1 and
    8 in 160-sample hops, int16 identical to ``enhance``; card float64
    within 1e-9 of CPU float64; ms a frame, the refits that fired, and the
    phase's seconds.  Every eager launch costs the host ~11 us there, so
    the phase makes as few full-size calls as its checks need;
12. multichannel: the PMWF beamformer and NTF at their deployment shape
    (``synth_mixture(n_ch=6)``, the CHiME-4 array; 3.43 s utterances, 347
    frames, F=513; ``PmwfParams()``), K1-K3 counted from zero around the
    phase and required to stay at 0: cuFFT's rows at n=1024 alone and in a
    batch, and the host's time a launch; ``PmwfEnhancer.enhance`` (int16
    of the expected length, finite, segmental SNR above the best input
    channel's, card float64 within 1e-9 of CPU float64 with int16
    identical, host seconds); the per-frame plan ``make_pmwf_batch_run``
    at B=8 (lanes 0 and 7 bit-identical to single-lane runs, correlation
    >= 0.99 with the CPU float64 run on 2 lanes, card float64 against it,
    warm audio-s/s, host ms a frame, kernels a frame and device busy share
    from the raw events of one profiled call); the whole-utterance plan
    ``make_pmwf_batch_run_fast`` at B=8 and 32 (float64 int16 identical to
    the per-frame plan, float32 correlation >= 0.9999 with it, finite, warm
    audio-s/s, CUDA-event ms, peak allocated memory);
    ``PmwfStreamingSession`` at ``block_frames=8`` in 160-sample hops
    (int16 identical to the one-shot run, host ms a push and of the pushes
    that complete a block against its 80 ms; a stream checkpointed with
    ``save_pmwf_state`` after 40 frames, loaded and resumed, identical to
    the uninterrupted one); six coherent channels in float32 (finite, not
    zero, one frame's covariance positive semidefinite to 1e-6 of its
    trace); ``ntf_solve`` at C=6, N=513, M=256, K=100, 50 trips (card
    float64 within 1e-9 of the CPU's, trips equal; float32 ms a trip) and
    ``NtfStreamingSession.push_blocks`` over 64 blocks (= 64 ``push_block``
    calls, blocks/s); the native IO library built and its wav round trip
    equal to the Python path's; the phase's seconds;
13. the command line (``se_snmf_nat_tpu_torch.cli``) and the directory
    runner at full width (F=513, R=100 a class, r_a=50, ``default_config()``)
    on ``fixtures.structured_bases`` saved through ``io.basis.save_basis``,
    in a temporary directory, each command through ``cli.main`` in this
    process with the kernels' launches counted from zero around it (the path
    ``cli``), or as a process of its own where said: ``enhance`` of a
    directory of 64 utterances of 3.43 s at B=64 with the headline flags
    (K1, K2, never K3) and with ``--preset snmf`` (K3 only), twice each,
    every file identical to ``enhance_batch`` of the same files in the
    runner's chunk order, the command's seconds, the runner's audio-s/s
    and its stages (wav I/O through ``io.native``) beside the in-process
    call's; the carry path (8 files, exact plan, ``--state-path``) identical
    to an in-process loop that carries ``b_d_head`` only, and a second run
    that skips all 8; ``python -m se_snmf_nat_tpu_torch enhance`` as a
    process with no ``--device`` (it runs on the card; its output = the
    in-process run); ``separate``; ``train`` of both classes on 10 wavs of
    12 s and a second ``train`` that hits the cache; ``dnmf``;
    ``campaign`` over two targets of 8 files with one basename (unique
    keys, a B_D_u each); ``demo`` in the modes snmf (``--toggle-every``,
    both toggles printed), ms, bnmf and pmwf (six channels), each file
    output identical to the port's session or one-shot run of the same
    samples, and a stdin ``--pcm-out`` process; ``serve`` as a process (8
    lanes, ``block_frames=8``; every wait with a time limit, the process
    killed at the end), one client's stream equal to a
    ``MultiStreamSession`` run of the same samples; ``grid`` over the full
    grid (6 noises x 4 SNRs, 3 clips of 2.4 s, rank 100) with ``snmf`` and
    ``snmf_fixed`` on a speech source written from ``fixtures.speechlike``,
    then one condition (``tmetro``, 5 dB) with ``imcra``, ``ms`` and
    ``bnmf``: every algorithm's mean segmental SNR above the noisy
    input's; ``eval`` of an output against itself; K1, K2 and K3 each
    launched on the path; the phase's seconds;
14. the two repaired faults and ``parallel/`` at full width
    (``default_config()``, F=513, R=100 a class, r_a=50, m_a=100): the
    block (headline) and fast (``snmf``) plans with beta 0 and 2 in
    float32, and the exact, fast and block plans in bfloat16 with the
    matmul DFT, on the phase-4 utterances: the plain solvers, no kernel
    launched, finite, correlation >= 0.99 a lane with the port's float64
    CPU run, each batch timed beside the plan's KL float32 run on the
    kernels; the time shard (``parallel.time_shard``) on one synthetic 60 s
    utterance, the sequential exact plan against D=8 and D=16 shards at
    halo 384, each twice, with seconds, audio-s/s, K1 and K2 launched once
    a frame of the window (required; the first D=8 run is the path
    ``parallel``) and the correlation with the sequential output (printed:
    with the adaptation on the adapted head carries the whole history;
    with fixed dictionaries the D=16 shard must reproduce the sequential
    exact run, correlation >= 0.99), then float64 at D=8 on a 5 s clip,
    card against CPU within 1e-9, int16 identical; an NCCL world of one
    (``init_multihost`` on tcp://127.0.0.1): the training step, the merge
    and both TP solves equal to their unsharded forms, the group destroyed
    after; ``audit_all`` on 8 logical shards of the card;
    ``dryrun_multichip(1)``; the phase's seconds;
15. bench: ``python -m se_snmf_nat_tpu_torch bench`` as a process of its
    own at full width (the headline plan at B=64, K3's MU rate against the
    GEMM-only chain, the matmul-DFT analysis), every key finite and
    positive, K1, K2 and K3 each launched (its ``launches``), the
    headline audio-s/s printed beside phase 4's warm B=64 figure; ``bench
    --latency`` likewise (K1 and K2 launched); then, in this process
    through ``bench``'s functions at reduced sizes, ``--serving`` (fleets
    of 16, 64 and 128, 10 ticks; device ceilings at 64 and 128 lanes and 2
    x 64; the shipped path at 1 x 128 and 2 x 64), ``--campaign`` (B=64,
    2 reps), ``--train-rate``, ``--multichannel`` (B=8, one call a row),
    ``--campaign-mixed`` (16 files) and ``--trace``, each line with the
    card's name and power limit; the phase's seconds;
16. a JSON line of the kernels (``launches``: the sum over the paths'
    first runs, each counted from zero, also given by path; the path
    ``bench`` is the two processes of phase 15, each counted from zero in
    its own process), the card's name and power limit, and the result
    line ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from se_snmf_nat_tpu_torch.runtime.profiling import bound, card_line, cuda_ms

H_REPLACES = "se_snmf_nat_tpu/kernels/mu_pallas.py:122"   # _h_solve_kernel
W_REPLACES = "se_snmf_nat_tpu/kernels/mu_pallas.py:40"    # _w_solve_kernel
C_REPLACES = "se_snmf_nat_tpu/kernels/mu_pallas.py:172"   # _h_cols_kernel
RTOL = 1e-4
NO_LIBRARY = ("library_ms null: no single PyTorch call computes an iterative "
              "MU solve")
N_UTT = 16
N_SAMPLES = 54880           # 343 hops + 4 flush frames = 347 frames


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max relative error on entries above 1e-6 of the largest, max abs
    error)."""
    got, ref = got.double(), ref.double()
    if not bool((ref != 0).any()):        # nothing to be relative to
        return (got - ref).abs().max().item(), (got - ref).abs().max().item()
    big = ref.abs() > 1e-6 * ref.abs().max()
    rel = ((got - ref).abs()[big] / ref.abs()[big]).max().item()
    return rel, (got - ref).abs().max().item()


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


BASE_WARM = {N_UTT: 2, 64: 1}   # warm calls a batch size, the best kept
BNMF_TRAIN_S = 30.0         # seconds of clean speech the BNMF model learns
BNMF_SEEDS = {"speech": 900, "noise": 901}    # seeds no utterance uses
MS_CHUNK = 1600             # samples a chunk of the chunked MMSE stream
FS = 16000


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@contextlib.contextmanager
def one_cpu_thread():
    """The CPU references run their small tensors on one thread (the pool's
    hand-offs cost more than the work)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def device_profile(fn):
    """(fn's result, wall s, device ms, kernels, device busy share) of one
    call, from the raw CUDA events of ``torch.profiler`` (the ~10^5-10^6
    events of a baseline's call take minutes to parse into function
    events, so they are only counted and summed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_kernels, dev_ns = 0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            n_kernels += not ev.name().startswith(("Memcpy", "Memset"))
            dev_ns += ev.duration_ns()
    return out, wall, dev_ns / 1e6, n_kernels, dev_ns / 1e9 / wall


def check_lane_invariance(dev, card):
    """Phase 11, first line: whether a row's result depends on the number
    of rows on the card — cuFFT's transforms at the baselines' sizes (n=512
    and 320: 64 rows against the first row alone and the first 8) and a
    sum over 257 bins by ``torch.sum`` and by the halving ``tree_sum`` the
    baselines' steps use (each of 64 rows alone against the batch) — and
    the host's time a launch (10,000 eager multiplications of a (16, 257)
    tensor)."""
    from se_snmf_nat_tpu_torch.utils.special import tree_sum
    gen = torch.Generator().manual_seed(0)
    same = {}
    for n in (512, 320):
        x = (torch.randn(64, 40, n, generator=gen) * 1e3).to(dev)
        spec = torch.fft.rfft(x, dim=-1)
        back = torch.fft.irfft(spec, n=n, dim=-1)
        same[f"rfft {n}"] = all(
            torch.equal(torch.fft.rfft(x[:b], dim=-1), spec[:b])
            for b in (1, 8)) and torch.equal(
                torch.fft.rfft(x[0, :1], dim=-1), spec[0, :1])
        same[f"irfft {n}"] = all(
            torch.equal(torch.fft.irfft(spec[:b], n=n, dim=-1), back[:b])
            for b in (1, 8))
    y = torch.rand(64, 257, generator=gen).to(dev)
    alone = torch.cat([y[i: i + 1].sum(-1) for i in range(64)])
    n_diff = int((alone != y.sum(-1)).sum())
    gap = (alone - y.sum(-1)).abs().max().item()
    same["torch.sum"] = n_diff == 0
    same["tree_sum"] = torch.equal(
        torch.cat([tree_sum(y[i: i + 1]) for i in range(64)]), tree_sum(y))
    a = torch.rand(16, 257, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10000):
        a = a * 1.0000001
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 100
    print(f"baselines lanes: a row's bits alone and in a batch of 64: "
          f"{', '.join(f'{k} {v}' for k, v in same.items())} (torch.sum: "
          f"{n_diff} of 64 rows alone differ from the batch, by up to "
          f"{gap:.3e}); host "
          f"{us:.2f} us a launch ({card})")
    if not all(v for k, v in same.items() if k != "torch.sum"):
        raise AssertionError(f"a row's result depends on the batch: {same}")


def hold_batch_baseline(name, make, dev, card, xs, n_out, n_frames,
                        sizes=None, chunked=False):
    """Phase 11 for an enhancer with ``enhance`` and ``enhance_batch``
    (OM-LSA, MMSE; both write int16 with ``matlab_int16_write``):
    ``enhance_batch`` at B=16 on the card (int16 of the expected length,
    RMS below the input's), ``enhance`` of lane 0 (finite, its int16 that
    of lane 0), two lanes against the float64 CPU run (correlation >=
    0.99), float64 on the card against it (1e-9, int16 identical); warm
    batches at each of ``sizes`` (``BASE_WARM`` calls, the best kept) and
    a profile of one call at the largest; with ``chunked``, ``enhance`` in
    chunks of ``MS_CHUNK`` samples against the one-shot output."""
    from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write
    enh = make(torch.float32, dev)
    t0 = time.perf_counter()
    ys = enh.enhance_batch(xs)
    first_s = time.perf_counter() - t0
    if not all(y.dtype == np.int16 and y.shape == (n_out,) for y in ys):
        raise AssertionError(f"{name}: outputs are not int16[{n_out}]")
    y0 = enh.enhance(xs[0], quantize=False)
    if not np.all(np.isfinite(y0)):
        raise AssertionError(f"{name}: non-finite waveform")
    if not np.array_equal(ys[0], matlab_int16_write(y0)):
        raise AssertionError(f"{name}: lane 0 of the batch differs from "
                             f"enhance() of its utterance")
    rms_in = float(np.sqrt(np.mean(np.square(xs))))
    rms_out = float(np.sqrt(np.mean(np.square(np.stack(ys).astype(float)))))
    if not rms_out < rms_in:
        raise AssertionError(f"{name}: output RMS {rms_out} not below input "
                             f"{rms_in}")
    t0 = time.perf_counter()
    with one_cpu_thread():
        want = make(torch.float64, "cpu").enhance_batch(xs[:2],
                                                        quantize=False)
    cpu_s = time.perf_counter() - t0
    corrs = [float(np.corrcoef(matlab_int16_write(w).astype(float),
                               y.astype(float))[0, 1])
             for w, y in zip(want, ys)]
    if min(corrs) < 0.99:
        raise AssertionError(f"{name}: card-to-CPU correlation {min(corrs)}")
    got64 = make(torch.float64, dev).enhance_batch(xs[:1],
                                                   quantize=False)[0]
    rel = _rel(got64, want[0])
    same64 = np.array_equal(matlab_int16_write(got64),
                            matlab_int16_write(want[0]))
    if not rel <= 1e-9 or not same64:
        raise AssertionError(f"{name}: float64 on the card {rel:.3e} from "
                             f"the CPU, int16 identical {same64}")
    line = (f"baselines {name}: enhance_batch B={len(xs)} first call "
            f"{first_s:.3f} s, {len(ys)} x int16[{n_out}] ({n_frames} "
            f"frames), finite, rms in {rms_in:.1f} -> out {rms_out:.1f}, "
            f"lane 0 = enhance(), card f32 vs CPU f64 ({cpu_s:.1f} s) corr "
            f"{', '.join(f'{c:.6f}' for c in corrs)}, card f64 vs CPU f64 "
            f"{rel:.3e} int16 identical")
    if chunked:
        st, parts = None, []
        for i in range(0, len(xs[0]), MS_CHUNK):
            y, st = enh.enhance(xs[0][i: i + MS_CHUNK], state=st,
                                return_state=True)
            parts.append(y)
        got = np.concatenate(parts)
        if not np.array_equal(got, matlab_int16_write(y0)[: len(got)]):
            raise AssertionError(f"{name}: chunked enhance differs from "
                                 f"one-shot")
        line += (f"; {len(parts)} chunks of {MS_CHUNK} samples = one-shot "
                 f"(int16 identical, {len(got)} of {n_out} samples, the "
                 f"rest held as the tail)")
    print(line)
    audio_s = N_SAMPLES / FS
    out = []
    for b in sizes or (N_UTT, 64):
        batch = [fixtures_noisy(100 + i) for i in range(b)]
        times = []
        for _ in range(BASE_WARM[b]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh.enhance_batch(batch, micro_batch=None)
            times.append(time.perf_counter() - t0)
        best = min(times)
        out.append(f"B={b} best {best:.4f} s of "
                   f"{[round(x, 4) for x in times]}, "
                   f"{b * audio_s / best:.1f} audio-s/s, "
                   f"{best / n_frames * 1e3:.3f} host ms a frame")
    _, wall, dev_ms, n_k, busy = device_profile(
        lambda: enh.enhance_batch(batch, micro_batch=None))
    print(f"baselines {name} times: {'; '.join(out)}; profile B={b}: wall "
          f"{wall:.4f} s, device {dev_ms:.2f} ms, kernels {n_k} "
          f"({n_k / n_frames:.1f} a frame), device busy {busy:.1%} ({card})")


def fixtures_noisy(seed: int) -> np.ndarray:
    from se_snmf_nat_tpu_torch import fixtures
    return fixtures.noisy_utterance(N_SAMPLES, seed=seed)


def check_bnmf(dev, card):
    """Phase 11, BNMF at ``BnmfParams()``: the speech model trained on
    ``BNMF_TRAIN_S`` of clean speech on the card (seconds, and the trips'
    device ms); the noise init timed alone; online ``enhance`` of two
    utterances (the second profiled) and supervised mode with a noise
    signal (int16, finite, mean segmental SNR against the clean signal
    above the input's); ``BnmfStreamingSession`` at ``block_frames`` 1 and
    8 in 160-sample hops against the offline output (int16 identical);
    float64 on the card against the CPU (1e-9, int16 identical); ms and
    kernels a frame and the refits that fired."""
    from se_snmf_nat_tpu_torch import fixtures, metrics
    from se_snmf_nat_tpu_torch.bnmf import (
        BnmfEnhancer, BnmfModel, BnmfParams, BnmfStreamingSession,
        GammaPost, init_train, spectrogram, train_speech_model, vb_train)
    from se_snmf_nat_tpu_torch.bnmf.enhance import _safe_std
    from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
    p = BnmfParams()
    speech = fixtures.clean_utterance(int(BNMF_TRAIN_S * FS),
                                      seed=BNMF_SEEDS["speech"],
                                      lead_silence=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, _ = train_speech_model(speech, p, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    spect = spectrogram(speech / _safe_std(speech), p)
    w0, h0, b0w, b0h = init_train(spect, p.k_speech)
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (spect, w0, h0)]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    w_again, _, _ = vb_train(*args, b0w, b0h, n_iter=p.train_iters)
    stop.record()
    torch.cuda.synchronize()
    trips_ms = start.elapsed_time(stop)
    if not torch.equal(w_again.shape, model.w.shape):
        raise AssertionError("bnmf: training twice gave different bases")
    print(f"baselines bnmf training: {BNMF_TRAIN_S:.0f} s of clean speech "
          f"({spect.shape[1]} frames, F={spect.shape[0]}, K={p.k_speech}) in "
          f"{train_s:.3f} s host, the {p.train_iters} trips "
          f"{trips_ms:.1f} device ms ({card})")

    enh = BnmfEnhancer(model, params=p, device=dev)
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(2)]
    cleans = [fixtures.clean_utterance(N_SAMPLES, seed=i) for i in range(2)]
    n_frames = N_SAMPLES // p.ulen - 1
    n_out = (n_frames + 1) * p.ulen
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enh.init_online_carry(xs[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    refits0 = enh.refits
    t0 = time.perf_counter()
    floats = [enh.enhance(xs[0], quantize=False)]
    first_s = time.perf_counter() - t0
    y1, wall, dev_ms, n_k, busy = device_profile(
        lambda: enh.enhance(xs[1], quantize=False))
    floats.append(y1)
    refits = (enh.refits - refits0) / len(xs)
    noise = fixtures.noise(int(BNMF_TRAIN_S * FS), seed=BNMF_SEEDS["noise"],
                           level=1500.0)
    sup = BnmfEnhancer(model, noise=noise, method="supervised", params=p,
                       device=dev)
    t0 = time.perf_counter()
    sup_floats = [sup.enhance(x, quantize=False) for x in xs]
    sup_s = (time.perf_counter() - t0) / len(xs)

    def snr(ys_):
        return float(np.mean([metrics.segmental_snr(c, y, FS)
                              for c, y in zip(cleans, ys_)]))

    snr_in = snr(xs)
    outs = {}
    for mode, fl in (("online", floats), ("supervised", sup_floats)):
        if not all(np.all(np.isfinite(y)) for y in fl):
            raise AssertionError(f"bnmf {mode}: non-finite waveform")
        outs[mode] = [enhanced_quantize(y) for y in fl]
        if not all(y.dtype == np.int16 and y.shape == (n_out,)
                   for y in outs[mode]):
            raise AssertionError(f"bnmf {mode}: not int16[{n_out}]")
        if not snr(outs[mode]) > snr_in:
            raise AssertionError(f"bnmf {mode}: segmental SNR "
                                 f"{snr(outs[mode])} not above the input's "
                                 f"{snr_in}")
    streams = []
    for bf in (1, 8):
        sess = BnmfStreamingSession(enh, block_frames=bf)
        ms, parts = [], []
        for i in range(0, N_SAMPLES, 160):
            t0 = time.perf_counter()
            parts.append(sess.push(xs[0][i: i + 160]))
            ms.append((time.perf_counter() - t0) * 1e3)
        parts.append(sess.flush())
        if not np.array_equal(np.concatenate(parts), outs["online"][0]):
            raise AssertionError(f"bnmf stream block_frames={bf} differs "
                                 f"from the offline enhance()")
        ms = np.asarray(ms)
        streams.append(f"block_frames={bf} push median "
                       f"{np.median(ms):.3f} ms p99 "
                       f"{np.percentile(ms, 99):.3f} max {ms.max():.3f}")

    def on(device, dtype):
        m = BnmfModel(GammaPost(model.w.shape.to(device, dtype),
                                model.w.scale.to(device, dtype)),
                      model.u0.to(device, dtype))
        return BnmfEnhancer(m, params=p, dtype=dtype, device=device)

    t0 = time.perf_counter()
    with one_cpu_thread():
        want = on("cpu", torch.float64).enhance(xs[0], quantize=False)
    cpu_s = time.perf_counter() - t0
    got = on(dev, torch.float64).enhance(xs[0], quantize=False)
    rel = _rel(got, want)
    same = np.array_equal(enhanced_quantize(got), enhanced_quantize(want))
    if not rel <= 1e-9 or not same:
        raise AssertionError(f"bnmf: float64 on the card {rel:.3e} from the "
                             f"CPU, int16 identical {same}")
    print(f"baselines bnmf: online and supervised {len(xs)} x "
          f"int16[{n_out}] ({n_frames} frames), finite, mean segmental SNR "
          f"{snr_in:.3f} -> {snr(outs['online']):.3f} dB online, "
          f"{snr(outs['supervised']):.3f} dB supervised; streams identical "
          f"to enhance(), {'; '.join(streams)} (a hop is 10 ms of audio); "
          f"card f64 vs CPU f64 {rel:.3e} int16 identical (CPU {cpu_s:.1f} "
          f"s)")
    print(f"baselines bnmf times: noise init ({p.noise_init_iters} trips, "
          f"K={p.k_noise}) {init_s:.3f} s; online enhance {first_s:.3f} s "
          f"with the init, {(first_s - init_s) / n_frames * 1e3:.3f} ms a "
          f"frame without it, refits a run {refits:.1f}; supervised "
          f"{sup_s:.3f} s; profile of the second: wall {wall:.4f} s, device "
          f"{dev_ms:.2f} ms, kernels {n_k} (with the init's), device busy "
          f"{busy:.1%} ({card})")


def check_baselines(mu, dev, card):
    """Phase 11: the three baseline enhancers at their published parameters
    on the phase-4 utterances; K1-K3 must not be launched.  Returns the
    kernels' launches over the phase."""
    from se_snmf_nat_tpu_torch.enhance.imcra import OmlsaEnhancer
    from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
    from se_snmf_nat_tpu_torch.enhance.ms_params import MsParams
    t_phase = time.perf_counter()
    reset_launches(mu)
    check_lane_invariance(dev, card)
    xs = [fixtures_noisy(i) for i in range(N_UTT)]
    om = OmlsaEnhancer(device="cpu")
    t_om = max((N_SAMPLES - om.p.mo) // om.p.mno, 0)
    hold_batch_baseline(
        "omlsa", lambda dt, d: OmlsaEnhancer(dtype=dt, device=d), dev, card,
        xs, t_om * om.p.mno + om.p.mo, t_om)
    ms = MmseEnhancer(device="cpu")
    nr = (N_SAMPLES - ms.d.nf + ms.d.ni) // ms.d.ni
    n_ms = ms.d.ni * (nr + 1)
    for tracker, lg in (("martin", 1), ("martin", 0), ("mmse", 1)):
        hold_batch_baseline(
            f"mmse tracker={tracker} lg={lg}",
            lambda dt, d: MmseEnhancer(params=MsParams(lg=lg), dtype=dt,
                                       tracker=tracker, device=d),
            dev, card, xs, n_ms, nr, chunked=True,
            sizes=None if (tracker, lg) == ("martin", 1) else (N_UTT,))
    check_bnmf(dev, card)
    launches = read_launches(mu)
    print(f"baselines phase: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"the baselines launch no MU kernel: {launches}")
    return launches


MC_CH = 6                   # the CHiME-4 array of synth_mixture(n_ch=6)
MC_LANES = (8, 32)          # lanes of the batch plans
MC_BLOCK = 8                # frames a session block: 80 ms of audio
MC_SPLIT = 40               # frames before the checkpointed interruption
NTF_SHAPE = dict(c=6, n=513, m=256, k=100)
NTF_TRIPS = 50
NTF_ONLINE = dict(m=16, blocks=64, inner=4)


def mc_utterance(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(6, N_SAMPLES) mixture and its clean source, a seed a lane."""
    from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
    return synth_mixture(n=N_SAMPLES, n_ch=MC_CH, seed=seed)


def check_fft_rows(dev, card):
    """Phase 12, first line: whether cuFFT's rfft and irfft at n=1024 (the
    multichannel STFT, 640-sample frames) give a row the same bits alone
    as in a batch of 32 x 6 x 40 rows (float32 takes another algorithm
    from 2,048 rows on), and that the port's fixed-shape calls
    (``pmwf.fixed_rows``) do; the host's time a launch."""
    from se_snmf_nat_tpu_torch.multichannel.pmwf import fixed_rows
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(32, MC_CH, 40, 640, generator=gen) * 1e3).to(dev)
    same = {}
    for name, fn in (("cuFFT", lambda f, v: f(v, n=1024, dim=-1)),
                     ("fixed_rows", lambda f, v: fixed_rows(f, v, 1024))):
        spec = fn(torch.fft.rfft, x)
        back = fn(torch.fft.irfft, spec)
        for what, f, inp, full in (("rfft", torch.fft.rfft, x, spec),
                                   ("irfft", torch.fft.irfft, spec, back)):
            same[f"{name} {what}"] = all(
                torch.equal(fn(f, inp[i]), full[i])
                for i in (np.s_[:1], np.s_[0, :1], np.s_[5, 2, 7]))
    a = torch.rand(8, MC_CH, 513, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10000):
        a = a * 1.0000001
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 100
    rows = ", ".join(f"{k} {v}" for k, v in same.items())
    print(f"multichannel fft rows: a row's bits alone and in a batch of "
          f"32 x {MC_CH} x 40 rows (n=1024, float32): {rows}; host "
          f"{us:.2f} us a launch ({card})")
    if not (same["fixed_rows rfft"] and same["fixed_rows irfft"]):
        raise AssertionError(f"the port's transforms depend on the batch: "
                             f"{same}")


def check_pmwf_offline(dev, card):
    """Phase 12: ``PmwfEnhancer.enhance`` on one 6-channel utterance."""
    from se_snmf_nat_tpu_torch.multichannel import PmwfEnhancer
    from se_snmf_nat_tpu_torch.multichannel.fixture import segsnr_vs_source
    from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write
    x, src = mc_utterance(0)
    enh = PmwfEnhancer(device=dev)
    enh.enhance(x)                                         # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = enh.enhance(x, quantize=False)
    host_s = time.perf_counter() - t0
    n_out = (N_SAMPLES // 160 + 1) * 160
    y16 = matlab_int16_write(y)
    if y16.shape != (MC_CH, n_out) or not np.all(np.isfinite(y)):
        raise AssertionError(f"offline PMWF: {y16.shape}, finite "
                             f"{np.all(np.isfinite(y))}")
    seg_in = max(segsnr_vs_source(x[j], src) for j in range(MC_CH))
    seg_out = segsnr_vs_source(y[0], src)
    if not seg_out > seg_in:
        raise AssertionError(f"offline PMWF segSNR {seg_out} <= {seg_in}")
    got64 = PmwfEnhancer(dtype=torch.float64, device=dev).enhance(
        x, quantize=False)
    want64 = PmwfEnhancer(dtype=torch.float64, device="cpu").enhance(
        x, quantize=False)
    rel = _rel(got64, want64)
    same = np.array_equal(matlab_int16_write(got64),
                          matlab_int16_write(want64))
    if not rel <= 1e-9 or not same:
        raise AssertionError(f"offline PMWF float64 on the card {rel:.3e} "
                             f"from the CPU, int16 identical {same}")
    print(f"multichannel offline: PmwfEnhancer.enhance C={MC_CH} "
          f"int16[{MC_CH}, {n_out}], finite, segSNR best input "
          f"{seg_in:.3f} -> {seg_out:.3f} dB, card f64 vs CPU f64 "
          f"{rel:.3e} int16 identical, warm host {host_s:.4f} s ({card})")


def check_pmwf_per_frame(dev, card):
    """Phase 12: the per-frame plan, ``make_pmwf_batch_run`` at B=8, held
    on lanes 0-1 to the CPU's float64 run (the whole-utterance plan, which
    gives the per-frame plan's bits, as the CPU tests show, in a fraction
    of the CPU's time).  Returns its float64 card output on lanes 0-1 (the
    int16 reference of the whole-utterance plan)."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.multichannel import (
        PmwfParams, make_pmwf_batch_run, make_pmwf_batch_run_fast,
        make_pmwf_streaming_run, pmwf_stream_init)
    from se_snmf_nat_tpu_torch.multichannel.streaming import (
        batch_stream_state)
    from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write
    cfg, p = default_config(), PmwfParams()
    b = MC_LANES[0]
    frames = mc_frames(b)
    n_frames = frames.shape[2]
    cpu64 = make_pmwf_batch_run_fast(cfg, p, torch.float64, "cpu")(
        frames[:2], batch_stream_state(pmwf_stream_init(
            p, MC_CH, cfg.signal.n_bins, torch.complex128, "cpu"), 2))[0]
    cpu64 = cpu64.numpy()
    st0 = pmwf_stream_init(p, MC_CH, cfg.signal.n_bins, device=dev)
    run = make_pmwf_batch_run(cfg, p, device=dev)
    t0 = time.perf_counter()
    ys, _ = run(frames, batch_stream_state(st0, b))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    single = make_pmwf_streaming_run(cfg, p, device=dev)
    lanes = {i: torch.equal(ys[i], single(frames[i], st0)[0])
             for i in (0, b - 1)}
    finite = bool(torch.isfinite(ys).all())
    if not all(lanes.values()) or not finite:
        raise AssertionError(f"per-frame plan: lanes alone = in the batch "
                             f"{lanes}, finite {finite}")
    run64 = make_pmwf_batch_run(cfg, p, torch.float64, dev)
    st64 = pmwf_stream_init(p, MC_CH, cfg.signal.n_bins, torch.complex128,
                            dev)
    y64, _ = run64(frames[:2], batch_stream_state(st64, 2))
    y64 = y64.cpu().numpy()
    rel = _rel(y64, cpu64)
    same = np.array_equal(matlab_int16_write(y64), matlab_int16_write(cpu64))
    y32 = ys[:2].cpu().numpy()
    corrs = [float(np.corrcoef(a.ravel(), w.ravel())[0, 1])
             for a, w in zip(y32, cpu64)]
    if not rel <= 1e-9 or not same or min(corrs) < 0.99:
        raise AssertionError(f"per-frame plan: card f64 {rel:.3e} from CPU "
                             f"f64, int16 identical {same}, f32 corr {corrs}")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(frames, batch_stream_state(st0, b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    _, wall, dev_ms, n_k, busy = device_profile(
        lambda: run(frames, batch_stream_state(st0, b)))
    audio_s = N_SAMPLES / FS
    print(f"multichannel per-frame plan B={b}: first call {first_s:.3f} s, "
          f"lanes 0 and {b - 1} = single-lane runs, finite, card f32 vs CPU "
          f"f64 corr {', '.join(f'{c:.6f}' for c in corrs)}, card f64 vs "
          f"CPU f64 {rel:.3e} int16 identical; warm best {best:.4f} s of "
          f"{[round(t, 4) for t in times]}, {b * audio_s / best:.1f} "
          f"audio-s/s, {best / n_frames * 1e3:.3f} host ms a frame; profile: "
          f"wall {wall:.4f} s, device {dev_ms:.2f} ms, kernels {n_k} "
          f"({n_k / n_frames:.1f} a frame), device busy {busy:.1%} ({card})")
    return y64


def mc_frames(b: int) -> np.ndarray:
    """(B, 6, T, 640) streaming frames of B utterances (seeds 0..B-1)."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.multichannel.pmwf import frames_of
    cfg = default_config()
    return np.stack([frames_of(mc_utterance(i)[0], cfg) for i in range(b)])


def check_pmwf_whole(dev, card, y64_frame):
    """Phase 12: the whole-utterance plan, ``make_pmwf_batch_run_fast``, at
    B=8 and 32: float64 int16 identical to the per-frame plan on two
    lanes, float32 correlation >= 0.9999 with it, finite; warm audio-s/s,
    device ms (CUDA events) and the peak of allocated memory."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.multichannel import (
        PmwfParams, make_pmwf_batch_run_fast, pmwf_stream_init)
    from se_snmf_nat_tpu_torch.multichannel.streaming import (
        batch_stream_state)
    from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write
    cfg, p = default_config(), PmwfParams()
    all_frames = mc_frames(max(MC_LANES))
    n_bins = cfg.signal.n_bins
    run64 = make_pmwf_batch_run_fast(cfg, p, torch.float64, dev)
    st64 = pmwf_stream_init(p, MC_CH, n_bins, torch.complex128, dev)
    g64, _ = run64(all_frames[:2], batch_stream_state(st64, 2))
    g64 = g64.cpu().numpy()
    same = np.array_equal(matlab_int16_write(g64),
                          matlab_int16_write(y64_frame))
    if not same:
        raise AssertionError("whole-utterance plan float64 int16 differs "
                             "from the per-frame plan's")
    run = make_pmwf_batch_run_fast(cfg, p, device=dev)
    st0 = pmwf_stream_init(p, MC_CH, n_bins, device=dev)
    audio_s = N_SAMPLES / FS
    parts = []
    for b in MC_LANES:
        frames = all_frames[:b]
        states = batch_stream_state(st0, b)
        torch.cuda.reset_peak_memory_stats()
        ys, _ = run(frames, states)
        corrs = [float(np.corrcoef(a.ravel(), w.ravel())[0, 1])
                 for a, w in zip(ys[:2].cpu().numpy(), g64)]
        finite = bool(torch.isfinite(ys).all())
        if not finite or min(corrs) < 0.9999:
            raise AssertionError(f"whole-utterance plan B={b}: finite "
                                 f"{finite}, f32 corr {corrs}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del ys
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(frames, states)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        dev_ms = cuda_ms(lambda: run(frames, states), reps=2)
        parts.append(f"B={b}: f32 corr with f64 "
                     f"{', '.join(f'{c:.7f}' for c in corrs)}, finite, warm "
                     f"best {best:.4f} s of {[round(t, 4) for t in times]}, "
                     f"{b * audio_s / best:.1f} audio-s/s, CUDA events "
                     f"{dev_ms:.2f} ms a call, peak allocated {peak:.2f} GiB")
    print(f"multichannel whole-utterance plan: f64 int16 = per-frame plan "
          f"on 2 lanes; {'; '.join(parts)} ({card})")


def check_pmwf_session(dev, card):
    """Phase 12: ``PmwfStreamingSession`` in 160-sample hops against the
    one-shot run; a checkpointed interruption resumed."""
    import tempfile
    from pathlib import Path
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.multichannel import (
        PmwfParams, PmwfStreamingSession, make_pmwf_streaming_run,
        pmwf_stream_init, pmwf_streaming_enhance)
    from se_snmf_nat_tpu_torch.multichannel.pmwf import frames_of
    from se_snmf_nat_tpu_torch.runtime.checkpoint import (
        load_pmwf_state, save_pmwf_state)
    x, _ = mc_utterance(0)
    sess = PmwfStreamingSession(n_ch=MC_CH, block_frames=MC_BLOCK,
                                device=dev)
    ms, block_ms, parts = [], [], []
    for n, i in enumerate(range(0, x.shape[1], 160), start=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts.append(sess.push(x[:, i: i + 160]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if n % MC_BLOCK == 0:                # this hop completed a block
            block_ms.append(ms[-1])
    got = np.concatenate(parts + [sess.flush()], axis=1)
    if not np.array_equal(got, pmwf_streaming_enhance(x, device=dev)):
        raise AssertionError("the session's int16 differs from the one-shot "
                             "run's")
    cfg, p = default_config(), PmwfParams()
    fr = frames_of(x, cfg)
    run = make_pmwf_streaming_run(cfg, p, device=dev)
    st0 = pmwf_stream_init(p, MC_CH, cfg.signal.n_bins, device=dev)
    y_full, st_full = run(fr, st0)
    _, st_a = run(fr[:, :MC_SPLIT], st0)
    with tempfile.TemporaryDirectory() as d:
        save_pmwf_state(Path(d) / "pmwf.npz", st_a)
        st_r = load_pmwf_state(Path(d) / "pmwf.npz", device=dev)
    y_b, st_b = run(fr[:, MC_SPLIT:], st_r)
    seam = 640 - 160
    resumed = (all(torch.equal(a, b) for a, b in zip(st_b, st_full))
               and torch.equal(y_b[:, seam:],
                               y_full[:, MC_SPLIT * 160 + seam:]))
    if not resumed:
        raise AssertionError("the stream resumed from its checkpoint "
                             "differs from the uninterrupted one")
    print(f"multichannel session: block_frames={MC_BLOCK}, {len(ms)} pushes "
          f"of 160 samples, int16 = one-shot; host ms a push median "
          f"{np.median(ms):.3f}, p99 {np.percentile(ms, 99):.3f}; pushes "
          f"that complete a block ({len(block_ms)}) median "
          f"{np.median(block_ms):.3f}, p99 {np.percentile(block_ms, 99):.3f}, "
          f"max {max(block_ms):.3f} against the block's "
          f"{MC_BLOCK * 10} ms; checkpoint at frame {MC_SPLIT} "
          f"(save_pmwf_state, load_pmwf_state) resumed = uninterrupted "
          f"({card})")


def check_pmwf_coherent(dev, card):
    """Phase 12: six copies of one signal 7 samples apart through the
    session in float32: finite, not all zero, and one frame's window
    covariance positive semidefinite to rounding."""
    from se_snmf_nat_tpu_torch.multichannel import PmwfStreamingSession
    from se_snmf_nat_tpu_torch.multichannel.streaming import window_cov
    rng = np.random.default_rng(11)
    x = rng.standard_normal(9000) * 3000.0
    xs = np.stack([np.roll(x, 7 * c) for c in range(MC_CH)])
    sess = PmwfStreamingSession(n_ch=MC_CH, block_frames=MC_BLOCK,
                                device=dev)
    outs = [sess.push(xs[:, i: i + 1600], quantize=False)
            for i in range(0, 9000, 1600)]
    r = window_cov(sess.state.y_win, sess.params.m_nbr).to(
        torch.complex128)                               # (F, C, C)
    eig = torch.linalg.eigvalsh(r)
    trace = torch.diagonal(r, dim1=-2, dim2=-1).real.sum(-1)
    worst = float((eig[:, 0] / trace).min())
    y = np.concatenate([o for o in outs if o.size]
                       + [sess.flush(quantize=False)], axis=1)
    ok = y.size and np.isfinite(y).all() and float(np.abs(y).max()) > 1.0
    print(f"multichannel coherent: {MC_CH} copies 7 samples apart, float32 "
          f"session output finite {bool(np.isfinite(y).all())}, max "
          f"|y| {float(np.abs(y).max()):.1f}; one frame's window covariance "
          f"min eigenvalue / trace {worst:.3e} over {r.shape[0]} bins "
          f"({card})")
    if not ok or worst < -1e-6:
        raise AssertionError("coherent channels: non-finite, zero or "
                             "indefinite")


def check_ntf(dev, card):
    """Phase 12: ``ntf_solve`` at C=6, N=513, M=256, K=100 (card float64
    against CPU float64, trips equal; float32 device ms a trip), then
    ``NtfStreamingSession.push_blocks`` over 64 blocks against 64
    ``push_block`` calls, with blocks/s."""
    from se_snmf_nat_tpu_torch.multichannel import (
        NtfStreamingSession, ntf_solve)
    from se_snmf_nat_tpu_torch.multichannel.ntf import default_c_init
    sh = NTF_SHAPE
    rng = np.random.default_rng(12)
    b = rng.random((sh["n"], sh["k"])) + 0.05
    s = np.einsum("ck,nk,mk->cnm", rng.random((sh["c"], sh["k"])) + 0.05,
                  b, rng.random((sh["m"], sh["k"])) + 0.05)
    c0, a0 = default_c_init(sh["c"], sh["k"]), np.ones((sh["m"], sh["k"]))
    kw = dict(max_iter=NTF_TRIPS)
    card64 = ntf_solve(s, b, c0, a0, device=dev, dtype=torch.float64, **kw)
    t0 = time.perf_counter()
    cpu64 = ntf_solve(s, b, c0, a0, device="cpu", dtype=torch.float64, **kw)
    cpu_s = time.perf_counter() - t0
    rel = _rel(card64.c.cpu().numpy(), cpu64.c.numpy())
    if not rel <= 1e-9 or card64.iters != cpu64.iters:
        raise AssertionError(f"ntf_solve: card f64 {rel:.3e} from CPU f64, "
                             f"trips {card64.iters} vs {cpu64.iters}")
    st = [torch.as_tensor(v, dtype=torch.float32, device=dev)
          for v in (s, b, c0, a0)]
    trip_ms = cuda_ms(lambda: ntf_solve(
        *st, device=dev, max_iter=NTF_TRIPS, conv_eps=0.0), reps=3) \
        / NTF_TRIPS
    on = NTF_ONLINE
    blks = rng.random((on["blocks"], sh["c"], sh["n"], on["m"])) + 1e-3
    s1 = NtfStreamingSession(b, sh["c"], inner_iters=on["inner"], device=dev)
    one = np.stack([s1.push_block(blk) for blk in blks])
    s2 = NtfStreamingSession(b, sh["c"], inner_iters=on["inner"], device=dev)
    blks_dev = torch.as_tensor(blks, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    many = s2.push_blocks(blks_dev)
    blk_s = time.perf_counter() - t0
    if not np.array_equal(many, one) or not torch.equal(s1.state.c,
                                                        s2.state.c):
        raise AssertionError("push_blocks differs from push_block")
    print(f"multichannel ntf: ntf_solve C={sh['c']} N={sh['n']} "
          f"M={sh['m']} K={sh['k']}: card f64 vs CPU f64 ({cpu_s:.1f} s) "
          f"{rel:.3e}, trips {card64.iters} = {cpu64.iters}; float32 "
          f"{trip_ms:.3f} device ms a trip (CUDA events, {NTF_TRIPS} trips); "
          f"push_blocks of {on['blocks']} blocks (M={on['m']}, "
          f"{on['inner']} inner trips) = {on['blocks']} push_block calls, "
          f"{on['blocks'] / blk_s:.1f} blocks/s ({card})")


def check_native_io(card):
    """Phase 12: the native IO library builds on the card's host and its
    wav round trip equals the Python path's."""
    import tempfile
    from pathlib import Path
    from se_snmf_nat_tpu_torch.io import native
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16
    if not native.native_available():
        raise AssertionError("the native IO library did not build")
    x = (np.random.default_rng(13).standard_normal((2, 16000))
         * 9000).astype(np.int16)
    with tempfile.TemporaryDirectory() as d:
        native.write_wav_int16(Path(d) / "n.wav", x, FS)
        write_wav_int16(Path(d) / "p.wav", x, FS)
        same_bytes = ((Path(d) / "n.wav").read_bytes()
                      == (Path(d) / "p.wav").read_bytes())
        got, _ = native.read_wav_int16(Path(d) / "p.wav")
        want, _ = read_wav_int16(Path(d) / "n.wav")
    if not same_bytes or not np.array_equal(got, want):
        raise AssertionError("native wav round trip differs from Python's")
    print(f"multichannel native io: native_available() True "
          f"({native._LIB_PATH.relative_to(native._ROOT)}), a 2-channel wav "
          f"written and read by the library = the Python path's ({card})")


def check_multichannel(mu, dev, card):
    """Phase 12: the multichannel path at its deployment shape; K1-K3 must
    not be launched.  Returns the kernels' launches over the phase."""
    t_phase = time.perf_counter()
    reset_launches(mu)
    check_fft_rows(dev, card)
    check_pmwf_offline(dev, card)
    y64 = check_pmwf_per_frame(dev, card)
    check_pmwf_whole(dev, card, y64)
    check_pmwf_session(dev, card)
    check_pmwf_coherent(dev, card)
    check_ntf(dev, card)
    check_native_io(card)
    launches = read_launches(mu)
    print(f"multichannel phase: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"the multichannel path launches no MU kernel: "
                             f"{launches}")
    return launches


CLI_FILES = 64             # the directory run: B=64 utterances of N_SAMPLES
CLI_CARRY_FILES = 8        # the carry path's files; each campaign target's
CLI_TIMEOUT = 300.0        # seconds, on every wait of a phase-13 process
CLI_SEED = 3000            # the phase's utterances: seeds no other phase uses
CLI_TRAIN_CLIPS = 10       # wavs a class for `train`, of TRAIN_CLIP_S each
BNMF_DEMO_SAMPLES = 25600  # 1.6 s: the BNMF demo's utterance
DEMO_TOGGLE_EVERY = 100    # hops between the snmf demo's adaptation toggles
GRID_CLIPS = 3             # clips a grid condition, of 2.4 s
GRID_SPEECH_S = 17.0       # the grid's speech source: 9 s training + clips
HEADLINE_FLAGS = ["--block-adapt", "88", "--block-iter-cap", "22",
                  "--block-refit-cap", "22", "--block-fixed-iter",
                  "--dft-matmul"]


def cli_call(mu, argv, total):
    """``cli.main(argv)`` in this process, its standard output captured.
    The kernels' launches are counted from zero just before it, read just
    after and added to ``total`` (the path ``cli``).  Returns (stdout, host
    s, the call's launches)."""
    import io

    from se_snmf_nat_tpu_torch import cli
    out = io.StringIO()
    reset_launches(mu)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    seconds = time.perf_counter() - t0
    launches = read_launches(mu)
    for k, v in launches.items():
        total[k] += v
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return out.getvalue(), seconds, launches


def cli_process(args, stdin=None):
    """``python -m se_snmf_nat_tpu_torch <args>`` as a process of its own
    from the checkout's root, with a time limit; fails on a non-zero exit.
    Returns (stdout bytes, stderr text, host s)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "se_snmf_nat_tpu_torch", *map(str, args)],
        input=stdin, capture_output=True, timeout=CLI_TIMEOUT,
        cwd=str(Path(__file__).resolve().parent))
    if proc.returncode != 0:
        raise AssertionError(f"python -m se_snmf_nat_tpu_torch {args[0]} "
                             f"exited {proc.returncode}: "
                             f"{proc.stderr.decode()[-2000:]}")
    return proc.stdout, proc.stderr.decode(), time.perf_counter() - t0


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def same_int16(name, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        n_d, mx, _ = int16_gap(got[: len(want)], want[: len(got)])
        raise AssertionError(f"{name}: {got.shape} against {want.shape}, "
                             f"{n_d} samples differ, max {mx}")


def write_int16(path, x, fs=16000):
    from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
    write_wav_int16(path, np.clip(np.rint(x), -32768, 32767)
                    .astype(np.int16), fs)
    return path


def cli_directory(mu, dev, card, tmp, bases, total):
    """``enhance`` over a directory of CLI_FILES utterances at B=64: the
    headline flags (K1, K2, never K3), then ``--preset snmf`` (K3 only);
    every file identical to ``enhance_batch`` of the same files in the
    runner's chunk order.  Returns the directory."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.io.native import read_wav_int16
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    db = tmp / "db"
    db.mkdir()
    for i in range(CLI_FILES):
        write_int16(db / f"u{i:03d}.wav",
                    fixtures.noisy_utterance(N_SAMPLES, seed=CLI_SEED + i))
    # the runner's chunk order: names sorted, then a stable sort by size
    order = sorted(sorted(db.glob("*.wav")), key=lambda p: p.stat().st_size)
    xs = [read_wav_int16(f)[0] for f in order]
    audio_s = CLI_FILES * N_SAMPLES / 16000
    bx, bd = bases["arrays"]
    plans = (("headline", HEADLINE_FLAGS, default_config(),
              dict(block_adapt=88, block_iter_cap=22, block_refit_cap=22,
                   block_fixed_iter=True, dft_matmul=True), ("K1", "K2")),
             ("fast", ["--preset", "snmf"], preset("snmf"), {}, ("K3",)))
    for name, flags, cfg, kw, used in plans:
        out = tmp / f"out_{name}"
        runs = []
        for force in ([], ["--force"]):
            text, seconds, launches = cli_call(
                mu, ["enhance", db, "-o", out, *flags, "--batch-size",
                     CLI_FILES, "--no-carry-state", *bases["args"], *force],
                total)
            rep = last_json(text)
            if rep["processed"] != CLI_FILES:
                raise AssertionError(f"cli enhance {name}: {rep}")
            if any((launches[k] > 0) != (k in used) for k in launches):
                raise AssertionError(f"cli enhance {name}: launches "
                                     f"{launches}, expected only {used}")
            runs.append((seconds, rep, launches))
        enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, **kw)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = enh.enhance_batch(xs)
            times.append(time.perf_counter() - t0)
        for f, y in zip(order, ys):
            same_int16(f"cli enhance {name} {f.name}",
                       read_wav_int16(out / f"{f.stem}_enh.wav")[0], y)
        for k, (seconds, rep, launches) in enumerate(runs):
            stages = rep["stages"]
            rate = audio_s / sum(stages.values())
            print(f"cli enhance {name} run {k + 1}: {CLI_FILES} files of "
                  f"{N_SAMPLES / 16000:.2f} s at B={CLI_FILES}, the command "
                  f"{seconds:.3f} s; runner {rate:.1f} audio-s/s "
                  f"(realtime_factor {rep['realtime_factor']}), "
                  f"stages {stages}; launches {launches} ({card})")
        print(f"cli enhance {name}: in-process enhance_batch of the same "
              f"files in the runner's chunk order, first {times[0]:.4f} s, "
              f"warm {times[1]:.4f} s ({audio_s / times[1]:.1f} audio-s/s); "
              f"every file int16 identical ({card})")
    return db


def cli_carry(mu, dev, card, tmp, bases, db, total):
    """``enhance`` of CLI_CARRY_FILES files on the exact plan with the
    dictionary carried file to file (``--state-path``); identical to an
    in-process loop that carries ``b_d_head`` only; a second run skips
    every file; one file through ``python -m se_snmf_nat_tpu_torch`` with no
    ``--device`` equals the in-process run; ``separate`` on it.  Returns
    (the carry directory, the exact-plan enhancer)."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.io.native import read_wav_int16
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    db8 = tmp / "db8"
    db8.mkdir()
    files = sorted(db.glob("*.wav"))[:CLI_CARRY_FILES]
    for f in files:
        (db8 / f.name).write_bytes(f.read_bytes())
    out, state_path = tmp / "out_carry", tmp / "B_D_u.npz"
    argv = ["enhance", db8, "-o", out, "--state-path", state_path,
            *bases["args"]]
    text, seconds, launches = cli_call(mu, argv, total)
    if last_json(text)["processed"] != CLI_CARRY_FILES or launches["K3"] \
            or not launches["K1"] or not launches["K2"]:
        raise AssertionError(f"cli carry: {text.strip()[-300:]}, {launches}")
    bx, bd = bases["arrays"]
    enh = SnmfEnhancer(default_config(), bx, bd, bx, bd, device=dev)
    init = enh.initial_state()
    state = init
    t0 = time.perf_counter()
    for f in files:
        x = read_wav_int16(f)[0]
        y, st = enh.enhance(x, state=state, return_state=True)
        state = init._replace(b_d_head=st.b_d_head)
        same_int16(f"cli carry {f.name}",
                   read_wav_int16(out / f"{f.stem}_enh.wav")[0], y)
    loop_s = time.perf_counter() - t0
    with np.load(state_path) as z:
        if not np.array_equal(z["b_d_head"], state.b_d_head.cpu().numpy()):
            raise AssertionError("cli carry: B_D_u is not the last head")
    text2, _, _ = cli_call(mu, argv, total)
    if last_json(text2)["skipped"] != CLI_CARRY_FILES:
        raise AssertionError(f"cli carry: the second run {text2.strip()}")
    print(f"cli carry: {CLI_CARRY_FILES} files on the exact plan, B_D_u "
          f"carried file to file, the command {seconds:.3f} s "
          f"(in-process loop {loop_s:.3f} s), every file int16 identical, "
          f"B_D_u = the last head; the second run skipped "
          f"{CLI_CARRY_FILES}; launches {launches} ({card})")

    src = files[0]
    x = read_wav_int16(src)[0]
    _, _, proc_s = cli_process(["enhance", src, "-o", tmp / "process.wav",
                                *bases["args"]])
    same_int16("python -m se_snmf_nat_tpu_torch enhance",
               read_wav_int16(tmp / "process.wav")[0], enh.enhance(x))
    text, seconds, launches = cli_call(
        mu, ["separate", src, "-o", tmp / "sep", *bases["args"]], total)
    sep = enh.separate(x)
    same_int16("cli separate", read_wav_int16(tmp / "sep_enhanced.wav")[0],
               sep["enhanced"])
    rep = last_json(text)
    if (rep["events"], rep["noises"]) != (len(sep["events"]),
                                          len(sep["noises"])):
        raise AssertionError(f"cli separate: {rep}")
    print(f"cli process: python -m se_snmf_nat_tpu_torch enhance with no "
          f"--device ran on the card in {proc_s:.1f} s (a process of its "
          f"own), its output = the in-process run; separate: "
          f"{rep['events']} events, {rep['noises']} noises, enhanced = "
          f"SnmfEnhancer.separate, {seconds:.3f} s ({card})")
    return db8, enh


def cli_training(mu, card, tmp, db8, total):
    """``train`` of both classes (CLI_TRAIN_CLIPS wavs of 12 s each), a
    second ``train`` that hits the cache, ``dnmf`` on the trained pair, and
    ``campaign`` over two targets with one basename."""
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.io.basis import (
        BasisPair, load_basis, save_basis)
    dbs = {}
    for kind, seed in (("speech", 5000), ("noise", 6000)):
        dbs[kind] = tmp / f"{kind}_db"
        fixtures.write_wav_dir(dbs[kind], kind, CLI_TRAIN_CLIPS,
                               TRAIN_CLIP_S, seed=seed)
    secs = {}
    for kind in dbs:
        argv = ["train", "--db", dbs[kind], "--basis-dir",
                tmp / "basis" / kind, "--rank", 100, "--seed", 0]
        text, s1, _ = cli_call(mu, argv, total)
        ckpt = tmp / "basis" / kind / "R_100.npz"
        stamp = ckpt.stat().st_mtime_ns
        _, s2, _ = cli_call(mu, argv, total)
        if ckpt.stat().st_mtime_ns != stamp or not s2 < s1:
            raise AssertionError(f"cli train {kind}: no cache hit")
        if last_json(text)["b_dft_shape"] != [513, 100]:
            raise AssertionError(f"cli train {kind}: {text.strip()}")
        secs[kind] = (s1, s2)
    sp, nz = (load_basis(tmp / "basis" / k / "R_100.npz") for k in dbs)
    save_basis(tmp / "pair.npz", BasisPair(
        b_dft=np.concatenate([sp.b_dft, nz.b_dft], axis=1),
        b_mel=np.concatenate([sp.b_mel, nz.b_mel], axis=1)))
    clean, noise = (sorted(dbs[k].glob("*.wav"))[0] for k in dbs)
    _, dnmf_s, _ = cli_call(mu, ["dnmf", "--clean", clean, "--noise", noise,
                                 "--basis", tmp / "pair.npz", "--output",
                                 tmp / "dnmf.npz"], total)
    refit = load_basis(tmp / "dnmf.npz").b_dft
    moved = float(np.abs(refit - np.concatenate([sp.b_dft, nz.b_dft],
                                                axis=1)).max())
    if refit.shape != (513, 200) or not np.isfinite(refit).all() \
            or not moved > 0:
        raise AssertionError(f"cli dnmf: {refit.shape}, moved {moved}")
    targets = []
    for cond in ("condA", "condB"):
        t = tmp / cond / "test"
        t.mkdir(parents=True)
        for f in sorted(db8.glob("*.wav")):
            (t / f.name).write_bytes(f.read_bytes())
        targets.append(t)
    out_root = tmp / "campaign"
    text, camp_s, launches = cli_call(
        mu, ["campaign", "--speech-db", dbs["speech"], "--noise-db",
             dbs["noise"], "--basis-root", tmp / "campaign_basis",
             "--out-root", out_root, "--targets", *targets, "--seed", 0],
        total)
    res = last_json(text)
    for key, row in res.items():
        n_out = len(list((out_root / key).glob("*_enh.wav")))
        if row["processed"] != CLI_CARRY_FILES or n_out != CLI_CARRY_FILES \
                or not (out_root / f"B_D_u_{key}.npz").exists():
            raise AssertionError(f"cli campaign {key}: {row}, {n_out} files")
    if len(res) != 2:
        raise AssertionError(f"cli campaign: keys {list(res)}")
    print(f"cli train: {CLI_TRAIN_CLIPS} wavs of {TRAIN_CLIP_S:.0f} s a "
          f"class, rank 100: speech {secs['speech'][0]:.2f} s, noise "
          f"{secs['noise'][0]:.2f} s; second calls cache hits "
          f"({secs['speech'][1]:.3f}, {secs['noise'][1]:.3f} s); dnmf "
          f"{dnmf_s:.2f} s, [B_x, B_d] 513 x 200 moved by {moved:.3e}; "
          f"campaign of two targets named 'test' -> keys {list(res)}, "
          f"{CLI_CARRY_FILES} files and a B_D_u each, {camp_s:.2f} s, "
          f"launches {launches} ({card})")


def cli_demo(mu, dev, card, tmp, bases, db8, total):
    """``demo`` in the modes snmf (with ``--toggle-every``), ms, bnmf and
    pmwf: each file output identical to the port's session or one-shot run
    of the same samples; a stdin ``--pcm-out`` process."""
    from se_snmf_nat_tpu_torch.bnmf import BnmfEnhancer, BnmfParams
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
    from se_snmf_nat_tpu_torch.io.native import read_wav_int16
    from se_snmf_nat_tpu_torch.multichannel import (
        PmwfParams, PmwfStreamingSession)
    from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
    src = sorted(db8.glob("*.wav"))[1]
    x = read_wav_int16(src)[0]
    hop, every = 160, DEMO_TOGGLE_EVERY
    hops = [x[i: i + hop] for i in range(0, len(x) - hop + 1, hop)]
    lines = []

    def demo(mode, inp, *extra):
        out = tmp / f"demo_{mode}.wav"
        text, seconds, launches = cli_call(
            mu, ["demo", inp, "--mode", mode, "-o", out, *extra], total)
        rep = last_json(text)
        lines.append(f"{mode} {rep['hops']} hops, {seconds:.2f} s, p50 "
                     f"{rep['hop_latency_ms']['p50']} ms a hop, launches "
                     f"{launches}")
        return read_wav_int16(out)[0], text

    got, text = demo("snmf", src, "--block", 8, "--toggle-every", every,
                     "--verbose", *bases["args"])
    if "NAT adaptation -> OFF" not in text \
            or "NAT adaptation -> ON" not in text:
        raise AssertionError("cli demo snmf: the toggles were not printed")
    bx, bd = bases["arrays"]
    sess = StreamingSession(SnmfEnhancer(default_config(), bx, bd, bx, bd,
                                         device=dev), block_frames=8)
    ys, on = [], True
    for h, chunk in enumerate(hops):
        want_on = (h // every) % 2 == 0
        if want_on != on:
            ys.append(sess.set_adaptation(want_on))
            on = want_on
        ys.append(sess.push(chunk))
    ys.append(sess.flush())
    same_int16("cli demo snmf", got, np.concatenate(ys))

    got, _ = demo("ms", src)
    want = MmseEnhancer(16000, device=dev).enhance(x)
    if len(got) != len(want) - hop:     # the stream keeps its last tail
        raise AssertionError(f"cli demo ms: {len(got)} of {len(want)}")
    same_int16("cli demo ms", got, want[: len(got)])
    ms_file = got

    short = write_int16(tmp / "bnmf_in.wav", x[:BNMF_DEMO_SAMPLES])
    speech = sorted((tmp / "speech_db").glob("*.wav"))[0]
    got, _ = demo("bnmf", short, "--block", 8, "--bnmf-speech", speech)
    want = BnmfEnhancer(speech=read_wav_int16(speech)[0],
                        params=BnmfParams(k_speech=100),
                        device=dev).enhance(x[:BNMF_DEMO_SAMPLES])
    same_int16("cli demo bnmf", got, want)

    mix, _ = synth_mixture(n=N_SAMPLES, n_ch=6)
    paths = [write_int16(tmp / f"ch{c}.wav", mix[c]) for c in range(6)]
    got, _ = demo("pmwf", ",".join(map(str, paths)), "--block", 8)
    chans = np.stack([read_wav_int16(p)[0] for p in paths])
    sess = PmwfStreamingSession(n_ch=6, params=PmwfParams(), block_frames=8,
                                device=dev)
    ys = [sess.push(chans[:, i: i + hop])[0]
          for i in range(0, chans.shape[1] - hop + 1, hop)]
    ys.append(sess.flush()[0])
    same_int16("cli demo pmwf", got, np.concatenate(ys))

    pcm, err, proc_s = cli_process(
        ["demo", "-", "--mode", "ms", "--pcm-out"],
        stdin=np.asarray(x, np.int16).astype("<i2").tobytes())
    same_int16("cli demo stdin --pcm-out", np.frombuffer(pcm, "<i2"),
               ms_file)
    if last_json(err)["hops"] != len(hops):
        raise AssertionError(f"cli demo stdin: {err.strip()[-300:]}")
    print(f"cli demo: {'; '.join(lines)}; each file = the port's session or "
          f"one-shot run of the same samples (snmf with {len(hops) // every}"
          f" toggles, ms less its held last hop); stdin --pcm-out process "
          f"{proc_s:.1f} s = the file mode ({card})")


def cli_serve(bases, dev, card, db8):
    """``serve`` as a process (8 lanes, ``block_frames=8``): one client
    streams one utterance; its stream equals a ``MultiStreamSession`` run
    of the same samples.  Every read and wait has a time limit and the
    process is killed at the end."""
    import queue
    import threading

    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.io.native import read_wav_int16
    from se_snmf_nat_tpu_torch.runtime.server import enhance_over_socket
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
    x = read_wav_int16(sorted(db8.glob("*.wav"))[2])[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "se_snmf_nat_tpu_torch", "serve", "--lanes",
         "8", "--block-frames", str(FLEET_BLOCK), *map(str, bases["args"])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=str(Path(__file__).resolve().parent))
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        t0 = time.perf_counter()
        try:
            info = json.loads(lines.get(timeout=CLI_TIMEOUT))
        except queue.Empty:
            raise AssertionError("cli serve: no address line") from None
        up_s = time.perf_counter() - t0
        port = int(info["serving"].rsplit(":", 1)[1])
        t0 = time.perf_counter()
        got = asyncio.run(asyncio.wait_for(
            enhance_over_socket("127.0.0.1", port, x), CLI_TIMEOUT))
        stream_s = time.perf_counter() - t0
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    bx, bd = bases["arrays"]
    enh = SnmfEnhancer(default_config(), bx, bd, bx, bd, device=dev)
    smp = np.zeros((8, len(x)))
    smp[0] = x
    fleet = MultiStreamSession(enh, 8, block_frames=FLEET_BLOCK,
                               wire="samples")
    want = np.concatenate([fleet.push(smp), fleet.flush()], axis=1)[0]
    same_int16("cli serve", got, want)
    if info["lanes"] != 8 or info["block_frames"] != FLEET_BLOCK:
        raise AssertionError(f"cli serve: {info}")
    print(f"cli serve: a process, {info}, up in {up_s:.1f} s; one client "
          f"streamed {len(x) / 16000:.2f} s in {stream_s:.2f} s, its stream "
          f"= a MultiStreamSession run of the same samples ({card})")


def cli_grid(mu, card, tmp, total):
    """``grid``: the full grid (6 noises x 4 SNRs, GRID_CLIPS clips of 2.4
    s, rank 100) with ``snmf`` and ``snmf_fixed``; then one condition
    (``tmetro``, 5 dB) with ``imcra``, ``ms`` and ``bnmf``.  Every
    algorithm's mean segmental SNR must rise above the noisy input's.
    Returns an output file for ``eval``."""
    from se_snmf_nat_tpu_torch import fixtures
    speech = write_int16(tmp / "grid_speech.wav", fixtures.speechlike(
        int(GRID_SPEECH_S * 16000), seed=8))
    for name, ws, extra in (
            ("full", tmp / "grid", ["--algorithms", "snmf", "snmf_fixed"]),
            ("baselines", tmp / "grid1",
             ["--noises", "tmetro", "--snrs", 5, "--algorithms", "imcra",
              "ms", "bnmf"])):
        text, seconds, launches = cli_call(
            mu, ["grid", "--workspace", ws, "--speech-wav", speech,
                 "--n-clips", GRID_CLIPS, "--report", ws / "report.json",
                 *extra], total)
        rep = json.loads((ws / "report.json").read_text())
        if rep != last_json(text):
            raise AssertionError(f"cli grid {name}: the report differs")
        means = rep["mean_seg_snr_db"]
        n_cond = len(rep["conditions"])
        if n_cond != (24 if name == "full" else 1) or any(
                not means[a] > means["noisy"] for a in means if a != "noisy"):
            raise AssertionError(f"cli grid {name}: {n_cond} conditions, "
                                 f"mean segSNR {means}")
        print(f"cli grid {name}: {n_cond} conditions x {GRID_CLIPS} clips "
              f"of 2.4 s, rank 100, {seconds:.1f} s; mean segSNR dB {means}"
              + (f", nat_minus_fixed {rep['nat_minus_fixed_seg_snr_db']}"
                 if name == "full" else "")
              + f"; launches {launches} ({card})")
    return tmp / "grid" / "enhanced" / "snmf" / "tmetro" / "5dB" \
        / "clip_00.wav"


def check_cli(mu, dev, card):
    """Phase 13: the command line and the directory runner on the card at
    full width (F=513, R=100 a class, r_a=50, ``default_config()``), on
    ``fixtures.structured_bases`` saved through ``io.basis.save_basis``.
    Returns the kernels' launches over every in-process command, each
    counted from zero around its call (the path ``cli``)."""
    import tempfile

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.io.basis import BasisPair, save_basis
    t_phase = time.perf_counter()
    total = {"K1": 0, "K2": 0, "K3": 0}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
        for name, b in (("bx", bx), ("bd", bd)):
            save_basis(tmp / f"{name}.npz", BasisPair(b_dft=b,
                                                      b_mel=b[:64]))
        bases = {"arrays": (bx, bd),
                 "args": ["--speech-basis", tmp / "bx.npz",
                          "--noise-basis", tmp / "bd.npz"]}
        db = cli_directory(mu, dev, card, tmp, bases, total)
        db8, _ = cli_carry(mu, dev, card, tmp, bases, db, total)
        cli_training(mu, card, tmp, db8, total)
        cli_demo(mu, dev, card, tmp, bases, db8, total)
        cli_serve(bases, dev, card, db8)
        out = cli_grid(mu, card, tmp, total)
        text, _, _ = cli_call(mu, ["eval", "--got", out, "--want", out],
                              total)
        ev = last_json(text)
        if ev["max_abs_err"] != 0.0 or ev["corr"] != 1.0:
            raise AssertionError(f"cli eval of a file against itself: {ev}")
        print(f"cli eval: a grid output against itself, max_abs_err "
              f"{ev['max_abs_err']}, corr {ev['corr']}")
    print(f"cli phase: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{total}")
    if not all(total.values()):
        raise AssertionError(f"the command line launches K1, K2 and K3: "
                             f"{total}")
    return total


TS_SECONDS = 60              # phase 14: the time shard's one long utterance
TS_HALO = 384                # the reference's default warm-up
TS_CLIP = 5                  # seconds of the float64 card-against-CPU clip


def corr_lanes(got, want) -> list[float]:
    return [float(np.corrcoef(a.astype(float), b.astype(float))[0, 1])
            for a, b in zip(got, want)]


def check_beta_and_bfloat16(mu, dev, card):
    """Phase 14, the two repaired faults: the block plan (headline) and the
    fast plan ``snmf`` with beta 0 (IS) and 2 (ED) in float32, and the
    exact, fast and block plans in bfloat16 with the matmul DFT, on the
    phase-4 utterances at full width.  The plain solvers run (the kernels
    are KL and float32 only): K1-K3 must stay at 0.  Each output finite
    and correlated >= 0.99 a lane with the port's float64 CPU run on 2
    lanes; each batch timed warm beside the same plan's KL float32 run on
    the kernels."""
    from dataclasses import replace

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.headline import HEADLINE_PLAN
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(N_UTT)]
    audio_s = N_UTT * N_SAMPLES / 16000

    def with_cf(cfg, cf):
        return cfg.evolve(nmf=replace(cfg.nmf, cf=cf))

    block, fast, exact = (HEADLINE_PLAN, {"dft_matmul": True},
                          {"dft_matmul": True})
    cases = [
        ("block plan, KL float32 (kernels)", default_config(), block,
         torch.float32),
        ("block plan, beta 0 (IS)", with_cf(default_config(), "is"), block,
         torch.float32),
        ("block plan, beta 2 (ED)", with_cf(default_config(), "ed"), block,
         torch.float32),
        ("block plan, bfloat16", default_config(), block, torch.bfloat16),
        ("fast plan, KL float32 (kernels)", preset("snmf"), fast,
         torch.float32),
        ("fast plan, beta 0 (IS)", with_cf(preset("snmf"), "is"), fast,
         torch.float32),
        ("fast plan, beta 2 (ED)", with_cf(preset("snmf"), "ed"), fast,
         torch.float32),
        ("fast plan, bfloat16", preset("snmf"), fast, torch.bfloat16),
        ("exact plan, KL float32 (kernels)", default_config(), exact,
         torch.float32),
        ("exact plan, bfloat16", default_config(), exact, torch.bfloat16)]
    for name, cfg, kw, dtype in cases:
        enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, dtype=dtype, **kw)
        reset_launches(mu)
        t0 = time.perf_counter()
        ys = enh.enhance_batch(xs)
        first = time.perf_counter() - t0
        launches = read_launches(mu)
        t0 = time.perf_counter()
        enh.enhance_batch(xs)
        warm = time.perf_counter() - t0
        finite = bool(np.isfinite(enh.enhance(xs[0], quantize=False)).all())
        cpu = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                           dtype=torch.float64, **kw)
        corrs = corr_lanes(ys[:2], cpu.enhance_batch(xs[:2]))
        kernels = "kernels" in name
        print(f"beta/bfloat16, {name}: B={N_UTT} first {first:.3f} s, warm "
              f"{warm:.3f} s ({audio_s / warm:.1f} audio-s/s), launches "
              f"{launches}, finite {finite}, corr with CPU float64 "
              f"{', '.join(f'{c:.6f}' for c in corrs)} ({card})")
        if not finite or min(corrs) < 0.99 or (
                kernels != bool(launches["K1"] or launches["K3"])):
            raise AssertionError(f"beta/bfloat16 case {name}: {launches}")
        if not kernels and any(launches.values()):
            raise AssertionError(f"{name} launched a kernel: {launches}")


def time_shard_run(enh, x, mesh, halo):
    from se_snmf_nat_tpu_torch.parallel.time_shard import (
        enhance_time_sharded)
    t0 = time.perf_counter()
    y = enhance_time_sharded(enh, x, mesh, halo=halo)
    return y, time.perf_counter() - t0


def check_time_shard(mu, dev, card):
    """Phase 14, the time shard at full width (``default_config()``,
    F=513, r_x=r_d=100, r_a=50, m_a=100, float32) on one synthetic 60 s
    utterance (``fixtures.noisy_utterance``): the sequential exact plan
    against D=8 and D=16 shards at halo 384 as lanes of one frame loop, each
    run twice (the second warm); wall seconds, audio-s/s, K1 and K2
    launches (one each a frame of the window, required), and the
    correlation with the sequential output.  With the online adaptation on
    that correlation is printed, not required: the adapted noise head
    carries the whole history, which a 384-frame warm-up does not rebuild
    on this fixture (the reference's time shard gives the same samples in
    float64, ``tests/test_torch_time_shard.py``).  With fixed dictionaries
    (``adapt_train_n=False``, K1 only) the D=16 shard must reproduce the
    sequential exact run: correlation >= 0.99.  Then the float64 card
    against the CPU at D=8 on a 5 s clip (<= 1e-9, int16 identical).
    Returns the launches of the first D=8 run (the path ``parallel``)."""
    from dataclasses import replace

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
    from se_snmf_nat_tpu_torch.parallel.time_shard import (
        enhance_time_sharded)
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = default_config()
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev)
    x = fixtures.noisy_utterance(TS_SECONDS * 16000, seed=4000)
    t = enh.frames_for(x).shape[0]
    seq_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        seq = enh.enhance(x)
        seq_s.append(time.perf_counter() - t0)
    print(f"time shard: sequential exact plan, {TS_SECONDS} s ({t} frames) "
          f"in {seq_s[0]:.2f} s then {seq_s[1]:.2f} s "
          f"({TS_SECONDS / min(seq_s):.1f} audio-s/s) ({card})")
    path = None
    for d in (8, 16):
        mesh = make_mesh((d, 1), devices=[dev] * d)
        width = TS_HALO + -(-t // d)
        for run in range(2):
            reset_launches(mu)
            y, secs = time_shard_run(enh, x, mesh, TS_HALO)
            launches = read_launches(mu)
            path = path or launches
            c = corr_lanes([y], [seq])[0]
            print(f"time shard D={d}, halo {TS_HALO} (window {width} frames,"
                  f" run {run + 1}): {secs:.2f} s, {TS_SECONDS / secs:.1f} "
                  f"audio-s/s, {min(seq_s) / secs:.2f}x the sequential, "
                  f"launches {launches}, corr with sequential {c:.6f} "
                  f"({card})")
            if launches != {"K1": width, "K2": width, "K3": 0}:
                raise AssertionError(f"time shard D={d}: {launches}")
    fixed = SnmfEnhancer(cfg.evolve(adapt=replace(cfg.adapt,
                                                  adapt_train_n=False)),
                         bx, bd, bx, bd, device=dev)
    t0 = time.perf_counter()
    seq_fixed, _ = fixed.enhance(x, return_state=True)     # the exact plan
    fixed_s = time.perf_counter() - t0
    mesh = make_mesh((16, 1), devices=[dev] * 16)
    reset_launches(mu)
    y, secs = time_shard_run(fixed, x, mesh, TS_HALO)
    launches = read_launches(mu)
    c = corr_lanes([y], [seq_fixed])[0]
    gap = int(np.abs(y.astype(np.int64) - seq_fixed).max())
    print(f"time shard, fixed dictionaries: sequential {fixed_s:.2f} s, "
          f"D=16 {secs:.2f} s, launches {launches}, corr with sequential "
          f"{c:.9f}, largest int16 difference {gap} ({card})")
    if c < 0.99 or launches["K1"] != TS_HALO + -(-t // 16):
        raise AssertionError(f"time shard with fixed dictionaries: {c}")
    x5 = x[: TS_CLIP * 16000]
    outs = []
    for d in (dev, "cpu"):
        e64 = SnmfEnhancer(cfg, bx, bd, bx, bd, device=d, dtype=torch.float64)
        mesh = make_mesh((8, 1), devices=[d] * 8)
        t0 = time.perf_counter()
        outs.append((enhance_time_sharded(e64, x5, mesh, halo=TS_HALO,
                                          quantize=False),
                     enhance_time_sharded(e64, x5, mesh, halo=TS_HALO),
                     time.perf_counter() - t0))
    (cf, cq, cs), (pf, pq, ps) = outs
    rel = float(np.abs(cf - pf).max() / np.abs(pf).max())
    same = bool(np.array_equal(cq, pq))
    print(f"time shard float64, D=8 on {TS_CLIP} s: card against CPU max "
          f"relative difference {rel:.3e}, int16 identical {same} (card "
          f"{cs:.1f} s, CPU {ps:.1f} s for two runs) ({card})")
    if not rel <= 1e-9 or not same:
        raise AssertionError("time shard float64 on the card")
    return path


def check_world_of_one(mu, dev, card):
    """Phase 14: an NCCL world of one (``init_multihost`` on
    tcp://127.0.0.1): the training step (F=513, R=200, T=1024, 4 trips),
    the merge and both TP solves over meshes whose axis spans the group,
    each equal to its unsharded form; the group is destroyed after; then
    ``audit_all`` on 8 logical shards of the card."""
    import socket

    import torch.distributed as dist

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.nmf.solver import (
        SnmfParams, snmf_h_solve_columns, snmf_solve)
    from se_snmf_nat_tpu_torch.parallel.collectives_audit import (
        audit_all, record)
    from se_snmf_nat_tpu_torch.parallel.distributed import (
        init_multihost, merged_dictionary_state)
    from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
    from se_snmf_nat_tpu_torch.parallel.model_shard import (
        snmf_h_solve_columns_model_sharded, snmf_solve_model_sharded)
    from se_snmf_nat_tpu_torch.parallel.train_step import (
        _kl_mu_step_local, make_distributed_train_step)
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        group = dist.group.WORLD
        mesh = make_mesh((1, 1), devices=[dev], group=group)
        tp = make_mesh((1, 1), devices=[dev], group=group,
                       process_axis="model")
        rng = np.random.default_rng(0)
        v, w, h = (torch.as_tensor(rng.random(shape) + 0.01,
                                   dtype=torch.float32, device=dev)
                   for shape in ((513, 1024), (513, 200), (200, 1024)))
        step = make_distributed_train_step(mesh, n_iter=4)
        step(v, w, h)
        torch.cuda.synchronize()
        with record() as rep:
            t0 = time.perf_counter()
            w4, h4 = step(v, w, h)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        wr, hr = w, h
        for _ in range(4):
            wr, hr = _kl_mu_step_local(v, wr, hr, 5.0, 1e-9)
        errs = {"train": max(rel_err(w4, wr)[0], rel_err(h4, hr)[0])}
        bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
        enh = SnmfEnhancer(None, bx, bd, bx, bd, device=dev)
        states = batch_state(enh.initial_state(), 4)
        merged = merged_dictionary_state(states, mesh)
        errs["merge"] = rel_err(merged.b_d_head, states.b_d_head)[0]
        p = SnmfParams(max_iter=40, conv_eps=1e-3)
        v2, h2 = v[:, :256], h[:, :256]
        got = snmf_h_solve_columns_model_sharded(v2, w, h2, p, tp)
        ref = snmf_h_solve_columns(v2, w, h2, p)
        errs["tp_h"] = rel_err(got.h, ref.h)[0]
        trips_equal = bool(torch.equal(got.iters, ref.iters))
        full = snmf_solve_model_sharded(v2, w, h2, p, tp)
        ones = torch.ones(200, dtype=torch.bool, device=dev)
        full_ref = snmf_solve(v2, w, h2, ones, ones, p)
        errs["tp_full"] = rel_err(full.w, full_ref.w)[0]
        trips_equal &= int(full.iters) == int(full_ref.iters)
        print(f"NCCL world of one ({dist.get_backend()}, {info}): train "
              f"step 4 trips at F=513 R=200 T=1024 in {step_s * 1e3:.2f} ms"
              f" warm, {rep.count} all-reduces of "
              f"{rep.ops[0]['bytes']} bytes; max relative difference to the"
              f" unsharded forms {errs}, trips equal {trips_equal} ({card})")
        if max(errs.values()) > 1e-6 or not trips_equal:
            raise AssertionError(f"NCCL world of one: {errs}")
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    audit = audit_all()
    print(f"collective audit on 8 logical shards of the card "
          f"({time.perf_counter() - t0:.1f} s): " + json.dumps(
              {k: {kk: v[kk] for kk in ("n_collectives", "total_bytes")}
               for k, v in audit.items()}))


def check_parallel(mu, dev, card):
    """Phase 14: the two repaired faults on the card, the time shard at
    full width, an NCCL world of one and ``dryrun_multichip(1)``.  Returns
    the launches of the time shard's first D=8 run (the path
    ``parallel``)."""
    from se_snmf_nat_tpu_torch.graft_entry import dryrun_multichip
    t_phase = time.perf_counter()
    check_beta_and_bfloat16(mu, dev, card)
    path = check_time_shard(mu, dev, card)
    check_world_of_one(mu, dev, card)
    reset_launches(mu)
    t0 = time.perf_counter()
    dryrun_multichip(1)
    print(f"dryrun_multichip(1) on the card: {time.perf_counter() - t0:.1f} "
          f"s, launches {read_launches(mu)}")
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s, the time "
          f"shard's launches {path}")
    if not path["K1"] or not path["K2"]:
        raise AssertionError(f"the time shard runs K1 and K2: {path}")
    return path


HEADLINE_KEYS = ("value", "audio_s_per_call", "mu_iters_per_s",
                 "mu_gemm_tflops", "mu_gemm_mfu", "mu_ceiling_tflops",
                 "mu_roofline_frac", "stft_frames_per_s", "stft_tflops",
                 "stft_hbm_gbps", "stft_hbm_frac")
LATENCY_KEYS = ("device_ms_per_hop", "singlehop_wall_ms", "hop_budget_ms",
                "n_frames")


def finite_keys(name, rep, keys):
    """Every key present, a finite positive number."""
    bad = [k for k in keys if not isinstance(rep.get(k), (int, float))
           or not np.isfinite(rep[k]) or rep[k] <= 0]
    if bad:
        raise AssertionError(f"bench {name}: keys missing, not finite or "
                             f"not positive: {bad} in {rep}")


def bench_process(*flags) -> tuple[dict, float]:
    """``python -m se_snmf_nat_tpu_torch bench <flags>`` on the card as a
    process of its own: its JSON line and the process's seconds."""
    out, _, secs = cli_process(["bench", *flags])
    return last_json(out.decode()), secs


def check_bench(mu, dev, card, phase4_b64):
    """Phase 15: the ``bench`` command on the card.  The headline line and
    ``--latency`` as processes of their own at full width (every key
    finite, K1-K3 launched), then ``--serving``, ``--campaign``,
    ``--train-rate``, ``--multichannel``, ``--campaign-mixed`` and
    ``--trace`` in this process through their functions at reduced sizes.
    Returns the launches of the two processes (the path ``bench``)."""
    import tempfile

    from se_snmf_nat_tpu_torch import bench
    t_phase = time.perf_counter()
    head, secs = bench_process()
    finite_keys("headline", head, HEADLINE_KEYS)
    for k in ("metric", "unit", "mu_solver_shape", "card", "input",
              "launches", "timing"):
        if k not in head:
            raise AssertionError(f"bench headline: no {k!r} in {head}")
    launches = dict(head["launches"])
    if min(launches.values()) < 1:
        raise AssertionError(f"bench headline launched K1, K2 and K3 each "
                             f"at least once: {launches}")
    print(f"bench (process, {secs:.1f} s): {json.dumps(head)}")
    print(f"bench headline {head['value']:.1f} audio-s/s (B=64, one "
          f"enhance_batch a batch, best of 3 windows of 20) beside phase 4's "
          f"warm B=64 {phase4_b64:.1f} (best of 3 calls); K3 "
          f"{head['mu_iters_per_s']:.4g} column-iterations/s, "
          f"{head['mu_gemm_tflops']:.2f} TFLOP/s, "
          f"{head['mu_roofline_frac']:.3f} of the GEMM-only chain "
          f"({head['mu_ceiling_tflops']:.2f} TFLOP/s); STFT "
          f"{head['stft_frames_per_s']:.4g} frames/s, "
          f"{head['stft_hbm_frac']:.3f} of 3.35 TB/s ({card})")
    lat, secs = bench_process("--latency")
    finite_keys("--latency", lat, LATENCY_KEYS)
    if not np.isfinite(lat["dispatch_overhead_ms"]):     # a difference
        raise AssertionError(f"--latency: {lat}")
    if not lat["launches"]["K1"] or not lat["launches"]["K2"]:
        raise AssertionError(f"--latency runs K1 and K2: {lat['launches']}")
    print(f"bench --latency (process, {secs:.1f} s): {json.dumps(lat)} "
          f"({card})")
    for k in launches:
        launches[k] += lat["launches"][k]

    t0 = time.perf_counter()
    srv = bench.run_serving(
        dev, fleet_sizes=(16, 64, 128), n_ticks=10, ceiling_sizes=(64, 128),
        n_inner=10, shard_plans=((2, 64),), product_plans=((1, 128), (2, 64)),
        product_ticks=10)
    if not srv["launches"]["K1"] or not srv["launches"]["K2"]:
        raise AssertionError(f"--serving runs K1 and K2: {srv['launches']}")
    rows = [(blk["block_frames"], blk["pipelined"], r)
            for blk in srv["blocks"] for r in blk["table"]]
    ticks = [r["tick_ms"] for _, _, r in rows]
    ticks += [r["device_tick_ms"] for r in srv["device_ceiling"]["table"]]
    ticks += [r["device_round_ms"]
              for r in srv["device_ceiling_sharded"]["table"]]
    ticks += [r["tick_ms"] for r in srv["product_path_sharded"]["table"]]
    if not all(np.isfinite(t) and t > 0 for t in ticks):
        raise AssertionError(f"--serving: a tick time is not finite: {srv}")
    print(f"bench --serving ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(srv)} ({card})")

    t0 = time.perf_counter()
    camp = bench.run_campaign(dev, campaign_batch=64, reps=2)
    for k, row in camp.items():
        if isinstance(row, dict) and "call_s" in row:
            finite_keys(f"--campaign {k}", row, ("call_s",
                                                 "audio_s_per_s_e2e"))
    print(f"bench --campaign ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(camp)} ({card})")

    t0 = time.perf_counter()
    tr = bench.run_train_rate(dev)
    finite_keys("--train-rate", tr, (
        "solve_wall_s", "mu_iters", "train_mu_iters_per_s",
        "train_gemm_tflops", "train_ceiling_tflops", "train_roofline_frac"))
    print(f"bench --train-rate ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(tr)} ({card})")

    t0 = time.perf_counter()
    mc = bench.run_multichannel(dev, lane_grid=(8,), fast_grid=(8,),
                                stream_calls=1, n_hops=80)
    if not all(row["output_finite"] for row in mc.values()
               if isinstance(row, dict) and "output_finite" in row):
        raise AssertionError(f"--multichannel: non-finite output: {mc}")
    print(f"bench --multichannel ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(mc)} ({card})")

    t0 = time.perf_counter()
    mixed = bench.run_campaign_mixed(dev, n_files=16, b_sz=8)
    for tag in ("length_sorted", "unsorted"):
        if mixed[tag]["warm"]["processed"] != 16:
            raise AssertionError(f"--campaign-mixed {tag}: {mixed[tag]}")
    if mixed["rerun_skip_all"]["skipped"] != 16:
        raise AssertionError(f"--campaign-mixed rerun: {mixed}")
    print(f"bench --campaign-mixed, 16 files ({time.perf_counter() - t0:.1f} "
          f"s): {json.dumps(mixed)} ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tr = bench.run_trace(tmp, dev)
        if tr["n_files"] < 1:
            raise AssertionError(f"--trace wrote nothing: {tr}")
        print(f"bench --trace ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(tr)}")
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s, the two "
          f"processes' launches {launches}")
    return launches


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
    warm_rate = {}
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
        warm_rate[b] = b * audio_s / best
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

    # 11. the baseline enhancers (no MU kernel)
    baseline_launches = check_baselines(mu, dev, card)

    # 12. the multichannel path (no MU kernel)
    multichannel_launches = check_multichannel(mu, dev, card)

    # 13. the command line and the directory runner
    cli_launches = check_cli(mu, dev, card)

    # 14. the repaired faults, parallel/ (the time shard's first run is the
    # path), an NCCL world of one, dryrun_multichip(1)
    parallel_launches = check_parallel(mu, dev, card)

    # 15. the bench command (its two processes are the path)
    bench_launches = check_bench(mu, dev, card, warm_rate[HEADLINE_BATCH])

    # 16. results: each path's launches were counted from zero around its
    # own first run (headline, fast plan, exact plan, the hop-by-hop stream,
    # the first fleet, the server's life, the three plans on the trained
    # dictionaries, the baselines' and the multichannel path's whole phase,
    # every in-process command of phase 13, the first time shard, and the
    # two bench processes of phase 15, each from zero in its own process)
    by_path = {"headline": launches, "fast": {"K1": 0, "K2": 0,
                                              "K3": c_launches},
               "exact": exact_launches, "streaming": stream_launches,
               "fleet": fleet_launches, "server": server_launches,
               "trained": trained_launches, "baselines": baseline_launches,
               "multichannel": multichannel_launches, "cli": cli_launches,
               "parallel": parallel_launches, "bench": bench_launches}

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
