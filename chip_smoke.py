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
   columns/lanes compare.  K1 runs at the main path's B=16 and B=64
   (where the last wave's lanes take narrower column groups, also held
   alone), prints its launch shape and ptxas's registers and spills, and
   two launches on the same inputs must give the same bits.  K3 runs on the fast plan's own spectra, as the frame-major
   view it gets there, at R=200, at the exemplar width R=1000 and in the
   Mel mode (F=64).  Each kernel's time beside the plain version's (K1 at
   B=16 and B=64, in turns with it);
4. main path: the headline plan (``HEADLINE_PLAN``) at full width on
   synthetic dictionaries: ``enhance_batch`` on 16 utterances of 3.43 s
   (347 frames, 4 blocks of 88) with the kernels' launch counts, output
   checks, the correlation with the port's float64 CPU run on 2 lanes,
   warm batch times at B=16 and B=64 and a profile of one B=64 batch;
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


def compare(name, got, trips, plain_fn, args, lane_axis_trips):
    """Hold a kernel's result to its plain version on the same inputs:
    within RTOL of the float64 plain version, or (where float32 itself is
    that far off) within twice the float32 plain version's own error.
    Only columns/lanes whose trip counts agree everywhere compare."""
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
    if err_k > limit or same.float().mean().item() < 0.75:
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
        p1 = cuda_ms(lambda: mu.mu_h_solve_lanes_ref(*args))
        k1 = cuda_ms(lambda: mu.mu_h_solve_lanes(*args))
        k2 = cuda_ms(lambda: mu.mu_h_solve_lanes(*args))
        p2 = cuda_ms(lambda: mu.mu_h_solve_lanes_ref(*args))
        times[b] = (min(k1, k2), min(p1, p2))
        gflop = 4.0 * 513 * 200 * 88 * 22 * b / 1e9
        print(f"kernel K1 time B={b} F=513 R=200 K=88 22 trips: {k1:.3f}, "
              f"{k2:.3f} ms, plain {p1:.3f}, {p2:.3f} ms (in turns plain, "
              f"kernel, kernel, plain); GFLOP/s "
              f"{gflop / times[b][0] * 1e3:.1f} (plain "
              f"{gflop / times[b][1] * 1e3:.1f}) ({card})")
    return max_abs, times


def check_w_kernel(mu, dev, rng, card):
    """K2 at B=8, F=513, R=50, M=100, cap 22, eps 1e-3, lanes 2 and 5
    inactive, ~30% of the columns masked; timed at B=64."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa

    def inputs(b):
        mask = rng.random((b, 50)) > 0.3
        v = rng.gamma(0.6, 2.0, (b, 513, 100))
        w0 = (rng.random((b, 513, 50)) + 1e-3) * mask[:, None, :]
        h = rng.random((b, 50, 100)) * mask[:, :, None]
        return t(v), t(w0), t(h)

    v, w0, h = inputs(8)
    act = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool,
                       device=dev)
    args = (v, w0, h, act, 22, 1e-3, 5.0, 1e-9)
    w, trips = mu.mu_w_solve_lanes(*args)
    lanes = lambda same, w: same[:, None, None].expand_as(w)   # noqa: E731
    err = compare("K2 mu_w_solve_lanes cap=22 eps=1e-3", w, trips,
                  mu.mu_w_solve_lanes_ref, args, lanes)
    print(f"kernel K2 trips per lane {trips.tolist()}")
    if int(trips[2]) or int(trips[5]):
        raise AssertionError("K2 ran trips on an inactive lane")
    vb, w0b, hb = inputs(64)
    actb = torch.ones(64, dtype=torch.bool, device=dev)
    ms = cuda_ms(lambda: mu.mu_w_solve_lanes(vb, w0b, hb, actb, 22, 1e-3,
                                             5.0, 1e-9))
    plain = cuda_ms(lambda: mu.mu_w_solve_lanes_ref(vb, w0b, hb, actb, 22,
                                                    1e-3, 5.0, 1e-9))
    print(f"kernel K2 time B=64 F=513 R=50 M=100 cap 22: {ms:.3f} ms, "
          f"plain {plain:.3f} ms ({card})")
    return err, ms, plain


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


def check_cols_kernel(mu, dev, card):
    """K3 on the fast plan's spectra of 3.43 s utterances with structured
    dictionaries: N=2048 columns at (F=513, R=200, cap 100), (F=513,
    R=1000, cap 50) and (F=64 Mel, R=200, cap 100), eps 1e-3; timed at the
    fast plan's B=64 shape, N=64*384=24576, R=200, cap 100, eps 1e-3."""
    from se_snmf_nat_tpu.config import preset
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.dsp.mel import mel_matrix
    from se_snmf_nat_tpu_torch.utils.matlab_compat import (
        matlab_v4_rand_matrix)
    cfg = preset("snmf")
    s = cfg.signal
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
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

    max_abs = 0.0
    for vv, r, cap in ((v, 200, 100), (v, 1000, 50), (v_mel, 200, 100)):
        w, h0 = dictionary(vv.shape[0], r)
        args = (vv[:, :2048], w, h0, cap, 1e-3, 5.0, 1e-9)
        h, trips = mu.mu_h_solve_columns(*args)
        err = compare(f"K3 mu_h_solve_columns F={vv.shape[0]} R={r} "
                      f"N=2048 cap={cap} eps=1e-3", h, trips,
                      mu.mu_h_solve_columns_ref, args, cols)
        print(f"kernel K3 F={vv.shape[0]} R={r}: share of columns at the "
              f"cap {(trips == cap).float().mean().item():.4f}")
        if r == 200 and vv is v:
            max_abs = err
    w, h0 = dictionary(513, 200)
    args = (v, w, h0, 100, 1e-3, 5.0, 1e-9)
    _, trips = mu.mu_h_solve_columns(*args)
    col_iters = trips.sum().item()
    ms = cuda_ms(lambda: mu.mu_h_solve_columns(*args))
    plain = cuda_ms(lambda: mu.mu_h_solve_columns_ref(*args))
    gflop = 4.0 * 513 * 200 * col_iters / 1e9    # the two products a trip
    print(f"kernel K3 time F=513 R=200 N={v.shape[1]} cap 100 eps 1e-3: "
          f"{ms:.3f} ms, plain {plain:.3f} ms; mean trips "
          f"{trips.float().mean().item():.2f}, share at the cap "
          f"{(trips == 100).float().mean().item():.4f}; column-iterations/s "
          f"{col_iters / ms * 1e3:.4g} (plain {col_iters / plain * 1e3:.4g}); "
          f"GFLOP/s {gflop / ms * 1e3:.1f} (plain {gflop / plain * 1e3:.1f}) "
          f"({card})")
    return max_abs, ms, plain


def profile_batch(enh, batch, names):
    """Device time by kernel of one warm ``enhance_batch`` call: (wall s,
    ms of the kernels whose names contain one of ``names``, other device
    ms, kernels launched, device busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enh.enhance_batch(batch, micro_batch=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mine = other = 0.0
    n_kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if any(name in ev.key for name in names):
            mine += dev_us / 1e3
        else:
            other += dev_us / 1e3
        n_kernels += ev.count
    busy = (mine + other) / (wall * 1e3)
    return wall, mine, other, n_kernels, busy


def check_fast_plan(dev, card):
    """Phase 5: the fast plan at full width, ``snmf`` then the MMSE+Q fixed
    variant; returns K3's launch count on the ``snmf`` run."""
    from dataclasses import replace

    from se_snmf_nat_tpu.config import default_config, preset
    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.kernels import mu
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(N_UTT)]
    dflt = default_config()
    mmse_q = dflt.evolve(adapt=replace(dflt.adapt, adapt_train_n=False))
    k3_launches = 0
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
        cpu = SnmfEnhancer(cfg, bx, bd, bx, bd, dtype=torch.float64)
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
            enh.enhance_batch(batch, micro_batch=None)          # warm
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
                enh, batch, ("h_cols_kernel", "normalize_w_kernel"))
            print(f"fast plan snmf profile B=64: wall {wall:.4f} s, K3 "
                  f"{k3:.2f} ms, other device {other:.2f} ms, kernels "
                  f"launched {n_k}, device busy {busy:.1%} ({card})")
    return k3_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 1
    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu_torch import fixtures
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
    h_err = h_errs[HEADLINE_BATCH]
    h_ms, h_plain = h_times[HEADLINE_BATCH]
    w_err, w_ms, w_plain = check_w_kernel(mu, dev, np.random.default_rng(0),
                                          card)
    c_err, c_ms, c_plain = check_cols_kernel(mu, dev, card)

    # 4. the main path
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    enh = build_headline_enhancer(cfg, bases_to_torch(bx, bd, bx, bd, dev),
                                  device=dev)
    xs = [fixtures.noisy_utterance(N_SAMPLES, seed=i) for i in range(N_UTT)]
    mu.mu_h_solve_lanes.launches = 0
    mu.mu_w_solve_lanes.launches = 0
    t0 = time.perf_counter()
    ys = enh.enhance_batch(xs)
    first_s = time.perf_counter() - t0
    launches = {"K1": mu.mu_h_solve_lanes.launches,
                "K2": mu.mu_w_solve_lanes.launches}
    print(f"main path: enhance_batch B={N_UTT} first call {first_s:.3f} s, "
          f"launches {launches}")
    if launches["K1"] == 0 or launches["K2"] == 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
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

    cpu = build_headline_enhancer(cfg, (bx, bd, bx, bd), dtype=torch.float64)
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
        enh.enhance_batch(batch, micro_batch=None)          # warm
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
    wall, k1, other, n_k, busy = profile_batch(enh, batch, ("h_lanes_kernel",))
    print(f"main path profile B={b}: wall {wall:.4f} s, K1 {k1:.2f} ms, "
          f"other device {other:.2f} ms, kernels launched {n_k}, device "
          f"busy {busy:.1%} ({card})")

    # 5. the fast plan
    c_launches = check_fast_plan(dev, card)

    # 6. results
    print(json.dumps({"kernels": [
        {"name": "mu_h_solve_lanes", "route": "cuda",
         "source": "se_snmf_nat_tpu_torch/csrc/mu_h_solve.cu",
         "replaces": H_REPLACES, "launches": launches["K1"],
         "max_abs_err": h_err, "ms": h_ms, "plain_ms": h_plain},
        {"name": "mu_w_solve_lanes", "route": "cuda",
         "source": "se_snmf_nat_tpu_torch/csrc/mu_w_solve.cu",
         "replaces": W_REPLACES, "launches": launches["K2"],
         "max_abs_err": w_err, "ms": w_ms, "plain_ms": w_plain},
        {"name": "mu_h_solve_columns", "route": "cuda",
         "source": "se_snmf_nat_tpu_torch/csrc/mu_h_cols.cu",
         "replaces": C_REPLACES, "launches": c_launches,
         "max_abs_err": c_err, "ms": c_ms, "plain_ms": c_plain}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
