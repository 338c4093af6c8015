"""The measurements of the ``bench`` command on the card (counterpart of the
reference's root ``bench.py`` and of its ``cli bench`` modes).

    python -m se_snmf_nat_tpu_torch bench [--latency | --serving | ...]

Each mode is a function that returns one JSON-able dict; the command prints
it as one line.  ``run_headline`` (no mode flag) reports:

  * ``value`` — audio-seconds a second of the headline plan
    (``headline.HEADLINE_PLAN``): a warm ``enhance_batch`` of
    ``HEADLINE_BATCH`` utterances in one call, the best of 3 windows of 20
    calls by the host clock (each call ends in the int16 PCM's copy to the
    host), counting the utterances' true audio, not the bucket padding;
  * ``mu_*`` — the shared-W H-solve kernel (K3, ``kernels.mu.
    mu_h_solve_columns``) at ``conv_eps=0`` (exactly ``cfg.nmf.max_iter``
    trips) on the bench spectrogram (every frame of the batch a column):
    column-iterations a second, useful TFLOP/s and their share of the
    card's float32 peak, beside a GEMM-only chain of the same two products
    a trip at the same shapes and precision (``mu_gemm_chain``, a
    yardstick, not a kernel): ``mu_roofline_frac`` = chain time / solve
    time;
  * ``stft_*`` — the matmul-DFT analysis over the batch's frames, 32 calls
    a window: frames a second, TFLOP/s, bytes a second and their share of
    the card's memory rate;
  * ``card`` (``nvidia-smi``'s name and power limit), ``input``
    (``"synthetic"`` or ``"reference"``), ``launches`` (K1-K3 launched by
    this run) and ``timing`` (how each number was taken).

Inputs: with ``reference_root`` the reference's M03 clip and pretrained
dictionaries; without, ``fixtures.noisy_utterance`` of the M03 clip's length
class (347 frames, 3.43 s) and ``fixtures.structured_bases`` at the
config's ranks.  Shares of a peak are against the H100's published float32
rates (``runtime.profiling.PEAK_FLOPS``, ``PEAK_BYTES``); the figures are
for one card.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.runtime.profiling import (
    DEVICE_TIMING, PEAK_BYTES, PEAK_FLOPS, card_line, sync, window_ms)

N_SAMPLES = 54880       # 343 hops + 4 flush frames = 347 frames, 3.43 s
REFERENCE_WAV = "wav/M03_423C0213_STR.CH6.wav"
# the GEMM-only chains' constants, the float32 values the reference's
# chains multiply by (exact in float32, so the chains agree in float64 too)
GEMM_CHAIN_SCALE = float(np.float32(9.5e-3))   # keeps the values in range
DECAY = float(np.float32(0.999))
NUDGE = float(np.float32(1e-9))


# ------------------------------------------------------------------ inputs
def bench_inputs(cfg, reference_root=None, n_samples: int = N_SAMPLES):
    """(x, fs, (b1_x, b1_d, b2_x, b2_d), input kind) of a measurement."""
    if reference_root:
        from se_snmf_nat_tpu_torch.io.basis import (
            load_reference_speech_noise)
        from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
        speech, noise = load_reference_speech_noise(cfg.sep.r_d,
                                                    root=reference_root)
        x, fs = read_wav_int16(Path(reference_root) / REFERENCE_WAV)
        return (x, fs, (speech.b_dft, noise.b_dft, speech.b_dft,
                        noise.b_dft), "reference")
    from se_snmf_nat_tpu_torch import fixtures
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    return (fixtures.noisy_utterance(n_samples, seed=0), cfg.signal.fs,
            (bx, bd, bx, bd), "synthetic")


def _card(dev: torch.device) -> str:
    return card_line() if dev.type == "cuda" else "cpu"


def _stamp(report: dict, dev: torch.device, kind: str | None) -> dict:
    report["card"] = _card(dev)
    report["device"] = str(dev)
    if kind is not None:
        report["input"] = kind
    return report


def _launches() -> dict:
    from se_snmf_nat_tpu_torch.kernels import mu
    return {"K1": mu.mu_h_solve_lanes.launches,
            "K2": mu.mu_w_solve_lanes.launches,
            "K3": mu.mu_h_solve_columns.launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _host_best(fn, n: int, windows: int = 3) -> float:
    """Best over windows of the host seconds a call, ``n`` calls a window,
    each call ending in a copy to the host."""
    laps = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        laps.append((time.perf_counter() - t0) / n)
    return min(laps)


# ------------------------------------------------------- the counts behind
def mu_flops_per_iter(f: int, r: int, n: int) -> float:
    """One MU trip of the H-solve: Lambda = W H and W^T (V / Lambda), two
    (F, r) x (r, n) contractions (elementwise work excluded)."""
    return 2 * (2.0 * f * r * n)


def train_flops_per_iter(f: int, r: int, t: int) -> float:
    """One W+H MU trip of training: the H update (2 contractions), the W
    update (2) and two rebuilds of Lambda."""
    return 6 * (2.0 * f * r * t)


def stft_flops_per_frame(framelength: int, n_bins: int) -> float:
    """Two (framelength, F) products a frame (the real and imaginary
    halves of the stacked DFT)."""
    return 2 * (2.0 * framelength * n_bins)


def stft_bytes_per_frame(framelength: int, fftlength: int) -> int:
    """Least memory traffic a frame in float32: read the frame, write the
    magnitude and the (2F) unit-phasor phase."""
    return 4 * (framelength + 3 * (fftlength // 2 + 1))


def mu_gemm_chain(w_norm: torch.Tensor, h: torch.Tensor,
                  n_trips: int) -> torch.Tensor:
    """The H-solve stripped to its two products a trip, at the solve's
    shapes: h <- (W^T (W h)) * 9.5e-3, ``n_trips`` times."""
    wt = w_norm.t()
    for _ in range(n_trips):
        h = torch.matmul(wt, torch.matmul(w_norm, h)).mul_(GEMM_CHAIN_SCALE)
    return h


def train_gemm_chain(w: torch.Tensor, h: torch.Tensor,
                     n_trips: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The W+H training solve stripped to its six products a trip."""
    for _ in range(n_trips):
        lam = torch.matmul(w, h)
        dmh = torch.matmul(w.t(), lam)
        h = h * DECAY + dmh * NUDGE
        lam2 = torch.matmul(w, h)
        c = torch.matmul(lam2, h.t())
        w = w * DECAY + c * NUDGE
        lam3 = torch.matmul(w, h)
        dmh2 = torch.matmul(w.t(), lam3)
        h = h + dmh2 * NUDGE
    return w, h


def mu_rate_inputs(enh, frames: np.ndarray, n_true: int, batch_size: int,
                   bases):
    """(v (F, B*T), w (F, r), h0 (r, B*T)) of the MU-rate measurement: the
    magnitude spectra (the rfft analysis) of the true frames, tiled over
    the batch, on the enhancer's device in its dtype."""
    from se_snmf_nat_tpu_torch.dsp.stft import analysis_frames
    s = enh.cfg.signal
    dev, dt = enh.device, enh.dtype
    fr = torch.as_tensor(frames, dtype=dt, device=dev)
    mag, _ = analysis_frames(fr, enh.win, s.fftlength, s.pow, s.dc_bin,
                             s.nonzerofloor, s.preemph)
    v = mag[:n_true].t().repeat(1, batch_size).contiguous()
    w = torch.as_tensor(np.concatenate([bases[0], bases[1]], axis=1),
                        dtype=dt, device=dev)
    h0 = torch.full((w.shape[1], v.shape[1]), 0.5, dtype=dt, device=dev)
    return v, w, h0


# ---------------------------------------------------------------- headline
def run_headline(device=None, reference_root=None, cfg=None,
                 batch_size: int | None = None, n_rep: int = 20,
                 mu_reps: int = 8, stft_inner: int = 32,
                 n_samples: int = N_SAMPLES) -> dict:
    """The headline line (module docstring).  ``cfg`` and the sizes are
    the test's handles; the defaults are the measurement."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.dsp.stft import analysis_frames
    from se_snmf_nat_tpu_torch.headline import (
        HEADLINE_BATCH, HEADLINE_PLAN, build_headline_enhancer)
    from se_snmf_nat_tpu_torch.kernels.mu import mu_h_solve_columns

    dev = resolve_device(device)
    cfg = cfg or default_config()
    batch_size = batch_size or HEADLINE_BATCH
    x, fs, bases, kind = bench_inputs(cfg, reference_root, n_samples)
    enh = build_headline_enhancer(cfg, bases, device=dev)
    before = _launches()

    # ---- audio-s/s of a warm enhance_batch, one call a batch
    xs = [x] * batch_size
    enh.enhance_batch(xs, micro_batch=None)                 # warm
    elapsed = _host_best(lambda: enh.enhance_batch(xs, micro_batch=None),
                         n_rep)
    audio_seconds = batch_size * len(x) / fs
    value = audio_seconds / elapsed                         # one card

    # ---- K3 at conv_eps=0 on the bench spectrogram
    true_frames = enh.frames_for(np.asarray(x, np.float64))
    n_true = true_frames.shape[0]
    frames = enh._pad_frames(true_frames)
    v, w_sep, h0 = mu_rate_inputs(enh, frames, n_true, batch_size, bases)
    f_bins, n_cols = v.shape
    r = w_sep.shape[1]
    max_iter = cfg.nmf.max_iter
    sparsity = float(cfg.nmf.sparsity)

    def solve():
        return mu_h_solve_columns(v, w_sep, h0, max_iter, 0.0, sparsity,
                                  1e-9)

    _, trips = solve()                                      # warm
    if not bool((trips == max_iter).all()):
        raise AssertionError(f"conv_eps=0 ran {trips.unique().tolist()} "
                             f"trips, not {max_iter}")
    mu_elapsed = window_ms(solve, dev, n=mu_reps) / 1e3
    mu_iters_per_s = max_iter * n_cols / mu_elapsed
    flops_per_iter = mu_flops_per_iter(f_bins, r, n_cols)
    achieved_flops = max_iter * flops_per_iter / mu_elapsed

    w_norm = w_sep / torch.sqrt(torch.sum(w_sep * w_sep, dim=0))[None, :]

    def chain():
        return mu_gemm_chain(w_norm, h0, max_iter)

    chain()                                                 # warm
    ceiling_elapsed = window_ms(chain, dev, n=mu_reps) / 1e3

    # ---- the matmul-DFT analysis over the batch's true frames
    s = cfg.signal
    stft_frames = torch.as_tensor(
        np.tile(np.asarray(true_frames, np.float32), (batch_size, 1)),
        device=dev)

    def stft():
        return analysis_frames(stft_frames, enh.win, s.fftlength, s.pow,
                               s.dc_bin, s.nonzerofloor, s.preemph,
                               dft_matmul=True, cs=enh.cs)

    stft()                                                  # warm
    stft_elapsed = window_ms(stft, dev, n=stft_inner) / 1e3
    n_stft_frames = stft_frames.shape[0]
    stft_frames_per_s = n_stft_frames / stft_elapsed
    stft_tflops = stft_frames_per_s * stft_flops_per_frame(
        s.framelength, s.n_bins) / 1e12
    stft_gbps = stft_frames_per_s * stft_bytes_per_frame(
        s.framelength, s.fftlength) / 1e9

    plan = HEADLINE_PLAN
    return _stamp({
        "metric": "audio_seconds_per_s_per_chip",
        "value": value,
        "unit": f"audio-s/s on one card (adaptive SNMF-NAT enhancement, "
                f"block-adaptive K={plan['block_adapt']} "
                f"cap{plan['block_iter_cap']} "
                f"bucket{plan['frame_bucket']}, matmul DFT, f32 (TF32 off), "
                f"B={batch_size}, one enhance_batch call a batch)",
        "audio_s_per_call": audio_seconds,
        "mu_iters_per_s": mu_iters_per_s,
        "mu_gemm_tflops": achieved_flops / 1e12,
        "mu_gemm_mfu": achieved_flops / PEAK_FLOPS,
        "mu_ceiling_tflops": max_iter * flops_per_iter / ceiling_elapsed
        / 1e12,
        "mu_roofline_frac": ceiling_elapsed / mu_elapsed,
        "mu_solver_shape": f"F={f_bins} r={r} cols={n_cols} iters={max_iter}",
        "stft_frames_per_s": stft_frames_per_s,
        "stft_tflops": stft_tflops,
        "stft_hbm_gbps": stft_gbps,
        "stft_hbm_frac": stft_gbps * 1e9 / PEAK_BYTES,
        "peaks": {"flops": PEAK_FLOPS, "bytes_per_s": PEAK_BYTES},
        "launches": _since(before),
        "timing": {
            "value": f"host clock, best of 3 windows of {n_rep} warm "
                     f"enhance_batch calls",
            "mu": f"{DEVICE_TIMING}; best of 3 windows of {mu_reps} calls "
                  f"(solve and chain)",
            "stft": f"{DEVICE_TIMING}; best of 3 windows of {stft_inner} "
                    f"calls"},
    }, dev, kind)


def main() -> int:
    """Print the headline line (``python -m se_snmf_nat_tpu_torch.bench``)
    on the card."""
    print(json.dumps(run_headline()))
    return 0


# ------------------------------------------------------------------- modes
def _enhancer(cfg, bases, dev, **kw):
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    return SnmfEnhancer(cfg, *bases, device=dev, dtype=torch.float32, **kw)


def run_latency(device=None, reference_root=None, cfg=None, n_rep: int = 3,
                n_calls: int = 60, n_samples: int = N_SAMPLES) -> dict:
    """``--latency``: ``measure_hop_latency`` on the exact plan
    (``default_config()``)."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.runtime.profiling import measure_hop_latency
    dev = resolve_device(device)
    cfg = cfg or default_config()
    x, _, bases, kind = bench_inputs(cfg, reference_root, n_samples)
    enh = _enhancer(cfg, bases, dev)
    before = _launches()
    rep = measure_hop_latency(enh, x, n_rep=n_rep, n_calls=n_calls)
    rep["launches"] = _since(before)
    return _stamp(rep, dev, kind)


def run_serving(device=None, reference_root=None, cfg=None,
                fleet_sizes=(1, 8, 32, 64, 128, 256),
                block_frames_grid=(8, 16), n_ticks: int = 30,
                ceiling_sizes=(128, 256, 384, 512), n_inner: int = 25,
                shard_plans=((2, 128), (3, 96), (4, 80)),
                product_plans=((1, 128), (1, 192), (2, 128), (3, 96),
                               (4, 80)),
                product_ticks: int = 20) -> dict:
    """``--serving``: the four serving helpers in the reference's order on
    the exact-plan enhancer (``default_config()``)."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.runtime.profiling import (
        measure_serving_capacity, measure_serving_device_ceiling,
        measure_serving_device_ceiling_sharded, measure_serving_product_path)
    dev = resolve_device(device)
    cfg = cfg or default_config()
    _, _, bases, kind = bench_inputs(cfg, reference_root)
    enh = _enhancer(cfg, bases, dev)
    before = _launches()
    rep = measure_serving_capacity(enh, fleet_sizes, block_frames_grid,
                                   n_ticks)
    rep["device_ceiling"] = measure_serving_device_ceiling(
        enh, ceiling_sizes, n_inner=n_inner)
    rep["device_ceiling_sharded"] = measure_serving_device_ceiling_sharded(
        enh, shard_plans, n_inner=n_inner)
    rep["product_path_sharded"] = measure_serving_product_path(
        enh, product_plans, n_ticks=product_ticks)
    rep["launches"] = _since(before)
    return _stamp(rep, dev, None)


def training_copies(x: np.ndarray, n_copies: int = 8,
                    seed: int = 1) -> list[np.ndarray]:
    """``n_copies`` of the clip, each scaled by 1 + 0.01 N(0, 1) and
    clipped to int16: the training database of ``--train-rate``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_copies):
        jitter = np.clip(np.asarray(x, np.float64)
                         * (1.0 + 0.01 * rng.standard_normal()),
                         -32768, 32767)
        out.append(jitter.astype(np.int16))
    return out


def run_train_rate(device=None, reference_root=None, cfg=None,
                   n_copies: int = 8, n_samples: int = N_SAMPLES) -> dict:
    """``--train-rate``: one W+H ``snmf_solve`` at a campaign-scale training
    shape (the clip's ``training_copies`` written as wavs, then
    ``build_training_sequence`` and ``training_features``): the solve's
    host seconds (best of 3, fresh random inits, ending in a
    synchronisation), its trips, trips/s and useful TFLOP/s, beside the
    six-product chain at the same shape and trip count."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
    from se_snmf_nat_tpu_torch.nmf.solver import SnmfParams, snmf_solve
    from se_snmf_nat_tpu_torch.train.dataset import build_training_sequence
    from se_snmf_nat_tpu_torch.train.features import training_features
    dev = resolve_device(device)
    cfg = cfg or default_config()
    x, fs, _, kind = bench_inputs(cfg, reference_root, n_samples)
    tmp = Path(tempfile.mkdtemp(prefix="trainbench_"))
    try:
        for i, c in enumerate(training_copies(x, n_copies)):
            write_wav_int16(tmp / f"c{i}.wav", c, fs)
        seq, _ = build_training_sequence(tmp, cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    feats = training_features(seq, cfg, dc_bin=cfg.signal.dc_bin)
    v = torch.as_tensor(feats.tf_mag, dtype=torch.float32, device=dev)
    f_bins, t_cols = v.shape
    r = min(100, t_cols - 1)
    rng = np.random.default_rng(0)
    params = SnmfParams(beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
                        max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps,
                        flr=1e-9)
    mask = torch.ones((r,), dtype=torch.bool, device=dev)

    def inits():
        def draw(shape):
            return torch.as_tensor(np.abs(rng.standard_normal(shape)) + 1e-3,
                                   dtype=torch.float32, device=dev)
        return draw((f_bins, r)), draw((r, t_cols))

    def solve(w0, h0):
        return snmf_solve(v, w0, h0, mask, mask, params, update_w=True,
                          update_h=True)

    solve(*inits())                                         # warm
    sync(dev)
    laps, iters = [], []
    for _ in range(3):
        w0, h0 = inits()
        sync(dev)
        t0 = time.perf_counter()
        res = solve(w0, h0)
        sync(dev)
        laps.append(time.perf_counter() - t0)
        iters.append(int(res.iters))
    el = min(laps)
    it = iters[laps.index(el)]
    flops_per_iter = train_flops_per_iter(f_bins, r, t_cols)
    w0c, h0c = inits()
    wn = w0c / torch.sqrt(torch.sum(w0c * w0c, dim=0))[None, :]
    train_gemm_chain(wn, h0c, it)                           # warm
    ceil_el = window_ms(lambda: train_gemm_chain(wn, h0c, it), dev) / 1e3
    achieved = it * flops_per_iter / el
    return _stamp({
        "train_shape": f"F={f_bins} T={t_cols} r={r}",
        "solve_wall_s": el,
        "mu_iters": it,
        "train_mu_iters_per_s": it / el,
        "train_gemm_tflops": achieved / 1e12,
        "train_mfu_vs_f32_peak": achieved / PEAK_FLOPS,
        "train_ceiling_tflops": it * flops_per_iter / ceil_el / 1e12,
        "train_roofline_frac": ceil_el / el,
        "audio_seconds_trained": n_copies * len(x) / fs,
        "timing": f"solve: host clock, best of 3 (fresh inits) ending in a "
                  f"synchronisation; chain: {DEVICE_TIMING}, best of 3",
    }, dev, kind)


def run_campaign(device=None, reference_root=None, cfg=None,
                 campaign_batch: int = 64, reps: int = 5,
                 micro_batches=(8, 16, 32),
                 n_samples: int = N_SAMPLES) -> dict:
    """``--campaign``: ``enhance_batch`` end to end (samples up, int16 PCM
    down) at ``campaign_batch`` lanes of the clip (circular shifts a lane
    and a rep): the headline plan at its default ``micro_batch`` (the
    directory runner's call), with ``micro_batch`` 8/16/32, ``MmseEnhancer``
    and ``OmlsaEnhancer``; the best of ``reps`` warm calls by the host
    clock."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.enhance.imcra import OmlsaEnhancer
    from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
    from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
    dev = resolve_device(device)
    cfg = cfg or default_config()
    x, fs, bases, kind = bench_inputs(cfg, reference_root, n_samples)
    b_sz = campaign_batch
    au = b_sz * len(x) / fs

    def run_e2e(enh, micro_batch=None):
        kw = {} if micro_batch is None else {"micro_batch": micro_batch}
        enh.enhance_batch([np.roll(x, 61 * i) for i in range(b_sz)], **kw)
        best = float("inf")
        for rep in range(reps):
            xs = [np.roll(x, 9973 * (rep + 1) + 61 * i) for i in range(b_sz)]
            t0 = time.perf_counter()
            enh.enhance_batch(xs, **kw)
            best = min(best, time.perf_counter() - t0)
        return {"call_s": best, "audio_s_per_s_e2e": au / best}

    out = {"batch": b_sz, "wav": "M03" if kind == "reference" else
           "fixtures.noisy_utterance", "audio_s_per_call": au}
    enh = build_headline_enhancer(cfg, bases, device=dev)
    out["snmf_headline"] = run_e2e(enh)
    for mbs in micro_batches:
        out[f"snmf_headline_mb{mbs}"] = run_e2e(enh, micro_batch=mbs)
    out["ms"] = run_e2e(MmseEnhancer(fs, dtype=torch.float32, device=dev))
    out["imcra"] = run_e2e(OmlsaEnhancer(dtype=torch.float32, device=dev))
    out["timing"] = f"host clock, best of {reps} warm calls"
    return _stamp(out, dev, kind)


def mixed_files(x: np.ndarray, fs: int, n_files: int = 80, seed: int = 7,
                length_range_s=(2, 12)) -> list[np.ndarray]:
    """The files of ``--campaign-mixed``: ``n_files`` lengths drawn
    uniformly from ``length_range_s`` seconds, each file a segment of the
    clip repeated from a random start."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(int(length_range_s[0] * fs),
                           int(length_range_s[1] * fs), n_files)
    files = []
    for ln in lengths:
        reps = -(-int(ln) // len(x))
        start = int(rng.integers(0, len(x)))
        files.append(np.tile(np.roll(x, -start), reps)[: int(ln)])
    return files


def pad_stats(lengths, order, b_sz: int, shift: int, n_flush: int,
              bucket: int) -> dict:
    """Distinct padded widths and padding waste of a chunking of files of
    ``lengths`` in ``order`` into ``enhance_batch`` calls of ``b_sz``
    lanes (``enhance_batch``'s t_max; a short last chunk is padded with
    silent lanes)."""
    widths, pad, true = [], 0, 0
    for c0 in range(0, len(order), b_sz):
        chunk = order[c0: c0 + b_sz]
        tt = [int(ln) // shift + n_flush for ln in chunk]
        t_max = -(-max(tt) // bucket) * bucket
        widths.append(t_max)
        pad += sum(t_max - t for t in tt) + (b_sz - len(chunk)) * t_max
        true += sum(tt)
    return {"distinct_padded_widths": len(set(widths)),
            "padding_waste_frac": round(pad / true, 3)}


def run_campaign_mixed(device=None, reference_root=None, cfg=None,
                       n_files: int = 80, b_sz: int = 32,
                       length_range_s=(2, 12),
                       n_samples: int = N_SAMPLES) -> dict:
    """``--campaign-mixed``: ``n_files`` files of 2-12 s (segments of the
    clip) in a temporary directory through ``BatchRunner``'s batch plan,
    length-sorted and unsorted, each cold (the first call of each padded
    width) and warm, then a rerun that skips every file."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
    from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
    from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner
    dev = resolve_device(device)
    cfg = cfg or default_config()
    x, fs, bases, kind = bench_inputs(cfg, reference_root, n_samples)
    files = mixed_files(x, fs, n_files, 7, length_range_s)
    lengths = [len(f) for f in files]
    total_audio = sum(lengths) / fs
    tmp = Path(tempfile.mkdtemp(prefix="mixedcamp_"))
    try:
        for i, seg in enumerate(files):
            write_wav_int16(tmp / f"f{i:03d}.wav", seg.astype(np.int16), fs)
        enh = build_headline_enhancer(cfg, bases, device=dev)
        out = {"files": n_files, "batch": b_sz,
               "audio_s_total": total_audio,
               "length_range_s": list(length_range_s)}
        shift = enh.cfg.signal.frameshift
        n_flush = enh.cfg.delay + 1
        for tag, sort in (("length_sorted", True), ("unsorted", False)):
            runner = BatchRunner(enh, carry_state=False, verbose=False,
                                 length_sort=sort)
            order = sorted(lengths) if sort else list(lengths)
            row = pad_stats(lengths, order, b_sz, shift, n_flush,
                            enh.frame_bucket)
            for phase in ("cold", "warm"):
                t0 = time.perf_counter()
                rep = runner.run(tmp, tmp / f"out_{tag}_{phase}",
                                 batch_size=b_sz)
                wall = time.perf_counter() - t0
                row[phase] = {"wall_s": wall,
                              "files_per_s": n_files / wall,
                              "audio_s_per_s_e2e": total_audio / wall,
                              "processed": len(rep.processed)}
            out[tag] = row
        runner = BatchRunner(enh, carry_state=False, verbose=False)
        t0 = time.perf_counter()
        rep2 = runner.run(tmp, tmp / "out_length_sorted_warm",
                          batch_size=b_sz)
        out["rerun_skip_all"] = {"wall_s": time.perf_counter() - t0,
                                 "skipped": len(rep2.skipped)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["timing"] = ("host clock around BatchRunner.run (wav reads and "
                     "writes included); 'cold' is the first pass of the "
                     "process, nothing is compiled on the card")
    return _stamp(out, dev, kind)


def run_multichannel(device=None, reference_root=None, cfg=None,
                     offline_reps: int = 5, lane_grid=(8, 32),
                     fast_grid=(1, 8, 32), stream_calls: int = 6,
                     n_hops: int = 200, ntf_shape=(513, 256, 100),
                     ntf_iters: int = 50, n_blks: int = 64,
                     n_samples: int = N_SAMPLES) -> dict:
    """``--multichannel``: the PMWF beamformer over 6 channels (circular
    shifts of the clip) offline, the streaming semantics per frame
    (``make_pmwf_batch_run``) and whole-utterance (``..._fast``) over B
    lanes, a ``PmwfStreamingSession`` of 8-frame blocks, ``ntf_solve`` and
    the online NTF session (``push_block`` and ``push_blocks``)."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.dsp.stft import stream_frames
    from se_snmf_nat_tpu_torch.multichannel import (
        NtfStreamingSession, PmwfEnhancer, PmwfParams, PmwfStreamingSession,
        make_pmwf_batch_run, make_pmwf_batch_run_fast, pmwf_stream_init)
    from se_snmf_nat_tpu_torch.multichannel.ntf import ntf_solve
    from se_snmf_nat_tpu_torch.multichannel.pmwf import complex_dtype
    from se_snmf_nat_tpu_torch.multichannel.streaming import (
        batch_stream_state)
    dev = resolve_device(device)
    cfg = cfg or default_config()
    x, fs, _, kind = bench_inputs(cfg, reference_root, n_samples)
    rng = np.random.default_rng(0)
    ch6 = np.stack([np.roll(x, 31 * c) for c in range(6)])
    enh = PmwfEnhancer(cfg, dtype=torch.float32, device=dev)
    enh.enhance(ch6)                                        # warm
    laps = []
    for rep in range(offline_reps):
        xs = np.stack([np.roll(x, 977 * (rep + 1) + 31 * c)
                       for c in range(6)])
        t0 = time.perf_counter()
        y = enh.enhance(xs)
        laps.append(time.perf_counter() - t0)
    pmwf_el = min(laps)
    out = {"pmwf_6ch": {
        "call_s": pmwf_el,
        "audio_s_per_s": len(x) / fs / pmwf_el,
        "output_finite": bool(np.isfinite(np.asarray(y)).all()),
        "note": "offline block-mean plan, one 6-ch utterance per call"}}

    p = PmwfParams()
    s = cfg.signal
    lane_frames = np.stack([
        stream_frames(ch, s.framelength, s.frameshift, n_flush=cfg.delay + 1)
        for ch in ch6])

    def stream_rows(make_run, lanes, tag, note):
        for b_lanes in lanes:
            frames_b = torch.as_tensor(np.stack([lane_frames] * b_lanes),
                                       dtype=torch.float32, device=dev)
            st0 = pmwf_stream_init(p, 6, s.n_bins,
                                   complex_dtype(torch.float32), device=dev)
            states = batch_stream_state(st0, b_lanes)
            batch_run = make_run(cfg, p, torch.float32, device=dev)
            ys, _ = batch_run(frames_b, states)             # warm
            sync(dev)
            el = _host_best(lambda: batch_run(frames_b, states)[0].cpu(),
                            stream_calls)
            ys = ys.cpu().numpy()
            out[f"{tag}{b_lanes}"] = {
                "call_s": el,
                "audio_s_per_s": b_lanes * len(x) / fs / el,
                "output_finite": bool(np.isfinite(ys).all()),
                "note": note.format(b=b_lanes)}

    stream_rows(make_pmwf_batch_run, lane_grid, "pmwf_stream_batch",
                "streaming semantics (running cov + init freeze), {b} lanes "
                "x 6 ch, per-frame filters")
    stream_rows(make_pmwf_batch_run_fast, fast_grid, "pmwf_stream_fast",
                "streaming semantics, whole-utterance batched plan, {b} "
                "lanes x 6 ch")

    sess = PmwfStreamingSession(cfg, p, n_ch=6, block_frames=8,
                                dtype=torch.float32, device=dev)
    hop = s.frameshift
    sess.push(ch6[:, : hop * 8])                            # warm
    sess.reset()
    t0 = time.perf_counter()
    for i in range(0, n_hops * hop, hop * 8):
        sess.push(ch6[:, i: i + hop * 8])
    el = time.perf_counter() - t0
    out["pmwf_session"] = {
        "ms_per_hop": el / n_hops * 1e3,
        "realtime_budget_ms": 10.0,
        "realtime": bool(el / n_hops * 1e3 < 10.0),
        "note": "push-based 6-ch session, block_frames=8, host clock over "
                f"{n_hops} hops"}

    n, m, kk = ntf_shape
    b = rng.random((n, kk)) + 0.01
    c0 = rng.random((6, kk)) + 0.01
    a0 = np.ones((m, kk))
    sm = torch.as_tensor(rng.random((6, n, m)) + 0.01, dtype=torch.float32,
                         device=dev)

    def ntf(scale):
        res = ntf_solve(sm * scale, b, c0, a0, max_iter=ntf_iters,
                        conv_eps=0.0, device=dev)
        sync(dev)
        return res

    ntf(1.0)                                                # warm
    laps = []
    for rep in range(5):
        t0 = time.perf_counter()
        ntf(1.0 + 1e-4 * (rep + 1))
        laps.append(time.perf_counter() - t0)
    el = min(laps)
    out["ntf"] = {"solve_s": el, "mu_iters_per_s": ntf_iters / el,
                  "shape": f"C=6 N={n} M={m} K={kk} iters={ntf_iters}"}

    blk = sm[:, :, :16].cpu().numpy()
    sess_ntf = NtfStreamingSession(b, 6, inner_iters=4, dtype=torch.float32,
                                   device=dev)
    sess_ntf.push_block(blk)                                # warm
    t0 = time.perf_counter()
    for rep in range(20):
        sess_ntf.push_block(blk * (1.0 + 1e-4 * rep))
    el = time.perf_counter() - t0
    out["ntf_online"] = {
        "blocks_per_s": 20 / el,
        "block_audio_s": round(16 * 0.01, 2),
        "audio_s_per_s": 20 * 16 * 0.01 / el,
        "shape": f"C=6 N={n} M=16/blk K={kk}, 4 inner iters",
        "note": "one push_block call a block (upload, 4 trips, download)"}

    sess_b = NtfStreamingSession(b, 6, inner_iters=4, dtype=torch.float32,
                                 device=dev)
    blks = np.stack([blk * (1.0 + 1e-4 * i) for i in range(n_blks)])
    sess_b.push_blocks(blks)                                # warm
    laps = []
    for rep in range(3):
        t0 = time.perf_counter()
        sess_b.push_blocks(blks * (1.0 + 1e-4 * (rep + 1)))
        laps.append(time.perf_counter() - t0)
    el = min(laps)
    out["ntf_online_batched"] = {
        "blocks_per_s": n_blks / el,
        "audio_s_per_s": n_blks * 16 * 0.01 / el,
        "shape": f"C=6 N={n} M=16/blk K={kk}, 4 inner iters, {n_blks} "
                 f"blocks per call",
        "note": "push_blocks: one upload and one download for all blocks, "
                "the bits of per-block pushes"}
    out["timing"] = ("host clock; each call ends in a copy to the host or "
                     "a synchronisation; best of the warm calls")
    return _stamp(out, dev, kind)


def run_scaling(device=None, reference_root=None, cfg=None,
                per_device_batch: int = 16, n_rep: int = 12,
                n_samples: int = N_SAMPLES) -> dict:
    """``--scaling``: ``parallel.scaling.measure_dp_scaling`` of the
    headline plan over the cards of this process."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
    from se_snmf_nat_tpu_torch.parallel.scaling import measure_dp_scaling
    dev = resolve_device(device)
    cfg = cfg or default_config()
    x, fs, bases, kind = bench_inputs(cfg, reference_root, n_samples)
    enh = build_headline_enhancer(cfg, bases, device=dev)
    rep = measure_dp_scaling(enh, x, fs, per_device_batch=per_device_batch,
                             n_rep=n_rep)
    return _stamp({str(k): v for k, v in rep.items()}, dev, kind)


def run_collectives(device=None, per_device_batch: int = 16,
                    cfg=None) -> dict:
    """``--collectives``: ``parallel.collectives_audit.audit_all`` on 8
    logical shards of the device."""
    from se_snmf_nat_tpu_torch.parallel.collectives_audit import audit_all
    from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
    dev = resolve_device(device)
    mesh = make_mesh((8, 1), devices=[dev] * 8)
    return _stamp(audit_all(per_device_batch=max(1, per_device_batch // 8),
                            mesh=mesh, cfg=cfg), dev, None)


def run_trace(trace_dir: str, device=None, reference_root=None, cfg=None,
              n_samples: int = N_SAMPLES) -> dict:
    """``--trace DIR``: a ``torch.profiler`` trace (``runtime.profiling.
    trace``) of one ``enhance`` on the block-adaptive plan at K=32, after
    an untraced warm call."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.runtime.profiling import annotate, trace
    dev = resolve_device(device)
    cfg = cfg or default_config()
    x, _, bases, kind = bench_inputs(cfg, reference_root, n_samples)
    enh = _enhancer(cfg, bases, dev, block_adapt=32)
    y = enh.enhance(x)                                      # warm
    with trace(trace_dir):
        with annotate("block_adaptive_enhance"):
            y = enh.enhance(x)
    files = [str(p.relative_to(trace_dir))
             for p in Path(trace_dir).rglob("*") if p.is_file()]
    return _stamp({"trace_dir": trace_dir, "n_files": len(files),
                   "rms_out": round(float(
                       np.sqrt((y.astype(float) ** 2).mean())), 1)},
                  dev, kind)



# ------------------------------------------------ modes scored on golden wavs
GOLDEN_FIXTURES = (
    ("M03", "wav/M03_423C0213_STR.CH6.wav",
     "wav/M03_423C0213_STR.CH6_out_v3.9_18.wav"),
    ("LM", "wav/LM_in.wav", "wav/LM_in_out_v3.9_18.wav"),
)


def _golden_fixtures(reference_root):
    """[(name, x, golden)] of the reference's two recordings and their
    golden enhanced wavs (int16-scale samples)."""
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
    if not reference_root:
        raise ValueError("the golden-wav modes need reference_root, the "
                         "reference repository's root")
    root = Path(reference_root)
    out = []
    for name, in_path, gold_path in GOLDEN_FIXTURES:
        x, fs = read_wav_int16(root / in_path)
        gold, _ = read_wav_int16(root / gold_path)
        out.append((name, x, gold, fs))
    return out


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    return float(np.corrcoef(np.asarray(a[:n], np.float64),
                             np.asarray(b[:n], np.float64))[0, 1])


def run_quality(device=None, reference_root=None, cfg=None,
                bnmf_params=None) -> dict:
    """``--quality``: every algorithm family on both reference recordings,
    the full ``metrics.quality_report`` battery against the noisy input,
    golden agreement (correlation, mean |LSB|, LSD, battery) for the two
    SNMF block plans, a BNMF row with its speech model trained on the
    fixture's golden wav, and the multichannel battery on the seeded
    synthetic array scene (``multichannel.fixture.synth_mixture``)."""
    from se_snmf_nat_tpu_torch.bnmf import BnmfEnhancer
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.enhance.imcra import OmlsaEnhancer
    from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
    from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
    from se_snmf_nat_tpu_torch.io.basis import load_reference_speech_noise
    from se_snmf_nat_tpu_torch.metrics import (
        log_spectral_distance, quality_report)
    from se_snmf_nat_tpu_torch.multichannel import (
        PmwfEnhancer, pmwf_streaming_enhance)
    from se_snmf_nat_tpu_torch.multichannel.fixture import (
        segsnr_vs_source, synth_mixture)
    dev = resolve_device(device)
    cfg = cfg or default_config()
    fixtures_ = _golden_fixtures(reference_root)
    speech, noise = load_reference_speech_noise(cfg.sep.r_d,
                                                root=reference_root)
    bases = (speech.b_dft, noise.b_dft, speech.b_dft, noise.b_dft)

    def snmf_variant(block_adapt=0, adapt=True):
        c = cfg if adapt else cfg.evolve(
            adapt=replace(cfg.adapt, adapt_train_n=False))
        return _enhancer(c, bases, dev, block_adapt=block_adapt)

    def enhancers(gold):
        yield "snmf_headline", build_headline_enhancer(
            cfg, bases, device=dev), True
        yield "snmf_block16", snmf_variant(block_adapt=16), True
        yield "snmf_fixed_fast", snmf_variant(adapt=False), False
        yield "imcra", OmlsaEnhancer(dtype=torch.float32, device=dev), False
        yield "ms", MmseEnhancer(cfg.signal.fs, dtype=torch.float32,
                                 device=dev), False
        yield "bnmf", BnmfEnhancer(speech=gold, params=bnmf_params,
                                   dtype=torch.float32, seed=0,
                                   device=dev), False

    report = {}
    for fix_name, x, gold, fs in fixtures_:
        rms_in = float(np.sqrt((x.astype(float) ** 2).mean()))
        rows = {}
        for name, enh, vs_golden in enhancers(gold):
            yf = enh.enhance(x).astype(np.float64)
            row = {"rms_in": round(rms_in, 1),
                   "rms_out": round(float(np.sqrt((yf ** 2).mean())), 1)}
            n = min(len(yf), len(x))
            row["battery_vs_input"] = quality_report(
                x[:n].astype(np.float64), yf[:n], fs)
            if vs_golden:
                n = min(len(yf), len(gold))
                g = gold[:n].astype(np.float64)
                row["corr_vs_golden"] = round(_corr(yf, g), 4)
                row["mean_abs_lsb_vs_golden"] = round(
                    float(np.abs(yf[:n] - g).mean()), 1)
                row["lsd_db_vs_golden"] = round(
                    log_spectral_distance(g, yf[:n], fs), 2)
                row["battery_vs_golden"] = quality_report(g, yf[:n], fs)
            rows[name] = row
        report[fix_name] = rows
    xm, src = synth_mixture(n_ch=6)
    seg_in = max(segsnr_vs_source(xm[j], src) for j in range(6))
    y_off = PmwfEnhancer(dtype=torch.float32, device=dev).enhance(
        xm, quantize=False)
    y_str = pmwf_streaming_enhance(xm, dtype=torch.float32, quantize=False,
                                   device=dev)
    report["multichannel_synthetic"] = {
        "fixture": "multichannel/fixture.synth_mixture(n_ch=6, seed=0)",
        "segsnr_db_best_input": round(seg_in, 2),
        "segsnr_db_pmwf_offline": round(segsnr_vs_source(y_off[0], src), 2),
        "segsnr_db_pmwf_streaming": round(
            segsnr_vs_source(y_str[0], src), 2),
        "gates": "tests/test_torch_multichannel_streaming.py"}
    return _stamp(report, dev, "reference")


def run_quality_sharded(device=None, reference_root=None, cfg=None,
                        shards: int = 8, halo: int = 384) -> dict:
    """``--quality-sharded``: one quality row for each sharded plan on
    ``shards`` logical shards of the device: the time shard on both
    recordings against the sequential exact plan and the golden wav, and
    the tensor-parallel H-solve on M03's spectrogram against the unsharded
    solve."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.dsp.stft import analysis_frames
    from se_snmf_nat_tpu_torch.io.basis import load_reference_speech_noise
    from se_snmf_nat_tpu_torch.metrics import log_spectral_distance
    from se_snmf_nat_tpu_torch.nmf.solver import (
        SnmfParams, snmf_h_solve_columns)
    from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
    from se_snmf_nat_tpu_torch.parallel.model_shard import (
        snmf_h_solve_columns_model_sharded)
    from se_snmf_nat_tpu_torch.parallel.time_shard import (
        enhance_time_sharded)
    dev = resolve_device(device)
    cfg = cfg or default_config()
    fixtures_ = _golden_fixtures(reference_root)
    speech, noise = load_reference_speech_noise(cfg.sep.r_d,
                                                root=reference_root)
    bases = (speech.b_dft, noise.b_dft, speech.b_dft, noise.b_dft)
    enh = _enhancer(cfg, bases, dev)
    mesh = make_mesh((shards, 1), devices=[dev] * shards)
    out = {"devices": shards}
    for (name, xf, gf, fsf), tag in zip(fixtures_, ("time_shard",
                                                    "time_shard_LM")):
        gg = gf.astype(np.float64)
        y_seq = enh.enhance(xf).astype(np.float64)
        y_ts = enhance_time_sharded(enh, xf, mesh,
                                    halo=halo).astype(np.float64)
        n = min(len(y_ts), len(y_seq), len(gg))
        out[tag] = {
            "halo": halo, "shards": shards,
            "corr_vs_sequential": round(_corr(y_ts[:n], y_seq[:n]), 6),
            "mean_abs_lsb_vs_sequential": round(
                float(np.abs(y_ts[:n] - y_seq[:n]).mean()), 2),
            "corr_vs_golden": round(_corr(y_ts[:n], gg[:n]), 4),
            "lsd_db_vs_golden": round(
                log_spectral_distance(gg[:n], y_ts[:n], fsf), 2)}
    x = fixtures_[0][1]
    s = cfg.signal
    frames = torch.as_tensor(enh.frames_for(x), dtype=torch.float32,
                             device=dev)
    mag, _ = analysis_frames(frames, enh.win, s.fftlength, s.pow, s.dc_bin,
                             s.nonzerofloor, s.preemph)
    w_sep = torch.as_tensor(np.concatenate([speech.b_dft, noise.b_dft],
                                           axis=1), dtype=torch.float32,
                            device=dev)
    r = w_sep.shape[1]
    params = SnmfParams(beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
                        max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps,
                        flr=1e-9)
    h0 = torch.full((r, mag.shape[0]), 0.5, dtype=torch.float32, device=dev)
    mesh_tp = make_mesh((1, shards), devices=[dev] * shards)
    ref = snmf_h_solve_columns(mag.t(), w_sep, h0, params)
    got = snmf_h_solve_columns_model_sharded(mag.t(), w_sep, h0, params,
                                             mesh_tp)
    ha, hb = ref.h.double().cpu().numpy(), got.h.double().cpu().numpy()
    wn = w_sep.double().cpu().numpy()
    r_x = cfg.sep.r_x

    def rel(a, b):
        return float((np.abs(a - b) / (np.abs(a) + 1e-12)).max())
    out["tp_h_solve"] = {
        "shape": f"F={mag.shape[1]} r={r} cols={mag.shape[0]}",
        "iters_ref": int(ref.iters.max()), "iters_tp": int(got.iters.max()),
        "h_max_rel_diff": rel(ha, hb),
        "xm_max_rel_diff": rel(wn[:, :r_x] @ ha[:r_x], wn[:, :r_x] @ hb[:r_x]),
        "dm_max_rel_diff": rel(wn[:, r_x:] @ ha[r_x:], wn[:, r_x:] @ hb[r_x:])}
    return _stamp(out, dev, "reference")


# (K, cap, bucket, refit_cap, fixed, split, refit_fixed
#  [, dft_prec fwd [, dft_prec inv]]) — the reference's Pareto grid
PARETO_POINTS = (
    (44, 20, 176, 20, True, False, False),
    (44, 20, 176, 20, True, False, True),
    (44, 20, 176, 8, True, False, True),
    (88, 20, 88, 20, True, True, False),
    (64, 20, 64, 12, True, False, False),
    (128, 20, 128, 12, True, False, False),
    (176, 20, 176, 12, True, False, False),
    (88, 16, 88, 12, True, False, False),
    (88, 20, 88, 12, True, False, False),
    (88, 20, 88, 20, True, False, False),
    (88, 22, 88, 12, True, False, False),
    (88, 22, 88, 22, True, False, False),
    (88, 24, 88, 12, True, False, False),
    (88, 24, 88, 24, True, False, False),
    (88, 22, 88, 22, True, False, False, "high", "highest"),
    (88, 22, 88, 22, True, False, False, "default", "highest"),
    (88, 22, 88, 22, True, False, False, "highest", "default"),
    (88, 22, 88, 22, True, False, False, "high", "default"),
    (88, 22, 88, 22, True, False, False, "default", "default"),
    (88, 22, 88, 8, True, False, True, "high", "default"),
    (88, 22, 88, 12, True, False, True, "high", "default"),
)


def pareto_plan(points=PARETO_POINTS):
    """(points the port runs, skipped points with the reason).  The split
    solve and fixed-trip refits were measured and left out of the port;
    the TPU's matmul precision names all mean full float32 here, so points
    that differ only in them are one point."""
    run, skipped, seen = [], [], set()
    for point in points:
        k, cap, bucket, refit_cap, fixed, split, rfix = point[:7]
        if split or rfix:
            skipped.append({"point": list(point),
                            "reason": "split solve / fixed-trip refit: "
                                      "options the port leaves out"})
            continue
        key = (k, cap, bucket, refit_cap, fixed)
        if key in seen:
            skipped.append({"point": list(point),
                            "reason": "differs only in TPU matmul precision "
                                      "names, full float32 on the card"})
            continue
        seen.add(key)
        run.append(key)
    return run, skipped


def run_pareto(device=None, reference_root=None, cfg=None,
               headline_margin: float = 0.004, batch_size: int = 64,
               n_rep: int = 12, points=PARETO_POINTS) -> dict:
    """``--pareto``: the speed/quality surface of the block-adaptive plan
    (K x iteration cap x refit cap, matmul DFT, bucket = K): audio-s/s of
    a warm ``enhance_batch`` of ``batch_size`` copies of M03 in one call
    (best of 3 windows of ``n_rep``), M03 quality from lane 0 of that
    batch and LM quality from ``enhance``, each against its golden wav;
    the pick is the fastest point whose worst-fixture correlation clears
    0.99 + ``headline_margin`` and 0.9955 (the reference's policy)."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.io.basis import load_reference_speech_noise
    from se_snmf_nat_tpu_torch.metrics import log_spectral_distance
    dev = resolve_device(device)
    cfg = cfg or default_config()
    fixtures_ = _golden_fixtures(reference_root)
    speech, noise = load_reference_speech_noise(cfg.sep.r_d,
                                                root=reference_root)
    bases = (speech.b_dft, noise.b_dft, speech.b_dft, noise.b_dft)
    run, skipped = pareto_plan(points)
    x_m03, fs = fixtures_[0][1], fixtures_[0][3]
    rows = []
    for k_blk, cap, bucket, refit_cap, fixed in run:
        enh = _enhancer(cfg, bases, dev, block_adapt=k_blk,
                              frame_bucket=bucket, block_iter_cap=cap,
                              dft_matmul=True, block_refit_cap=refit_cap,
                              block_fixed_iter=fixed)
        xs = [x_m03] * batch_size
        ys = enh.enhance_batch(xs, micro_batch=None)        # warm
        el = _host_best(lambda: enh.enhance_batch(xs, micro_batch=None),
                        n_rep)
        row = {"k": k_blk, "cap": cap, "bucket": bucket,
               "refit_cap": refit_cap, "fixed_iter": fixed,
               "frames_padded": int(enh._pad_frames(
                   enh.frames_for(x_m03)).shape[0]),
               "audio_s_per_s": round(batch_size * len(x_m03) / fs / el, 1)}
        outs = [ys[0].astype(np.float64),
                enh.enhance(fixtures_[1][1]).astype(np.float64)]
        corrs = []
        for (name, _, gold, _), yq in zip(fixtures_, outs):
            g = gold.astype(np.float64)
            n = min(len(yq), len(g))
            corr = _corr(yq[:n], g[:n])
            corrs.append(corr)
            row[name] = {
                "corr": round(corr, 4),
                "lsd_db": round(log_spectral_distance(g[:n], yq[:n], fs), 2),
                "mean_abs_lsb": round(float(np.abs(yq[:n] - g[:n]).mean()),
                                      1)}
        row["corr_margin"] = round(min(corrs) - 0.99, 4)
        rows.append(row)
    ok = [r for r in rows if r["corr_margin"] >= headline_margin
          and min(r["M03"]["corr"], r["LM"]["corr"]) >= 0.9955]
    pick = max(ok, key=lambda r: r["audio_s_per_s"]) if ok else None
    return _stamp({
        "grid": "K x iter_cap x refit_cap, dft_matmul=True, bucket=K, "
                f"B={batch_size}, f32 (TF32 off)",
        "gate": 0.99, "headline_margin_req": headline_margin,
        "test_gate_margin_req": 0.0025,
        "rows": rows, "skipped": skipped, "headline_pick": pick,
        "timing": f"host clock, best of 3 windows of {n_rep} warm "
                  f"enhance_batch calls"}, dev, "reference")

if __name__ == "__main__":
    sys.exit(main())
