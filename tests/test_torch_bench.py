"""The port's measurement code against the JAX package's, on the CPU at
narrow widths (r_x = r_d = 8, r_a = 4, m_a = 10, 6 trips; fleets of 1-2
lanes, 2-3 ticks; a few hundred ms of audio):

* each ``runtime.profiling.measure_*`` helper returns the reference's key
  set (plus the port's ``timing`` and a row's ``peak_mib``) with every
  field that is not a time equal and every time finite and positive;
* the device half of a fleet tick, chained over a window, advances a fleet
  exactly as ``push`` does;
* the counts behind every rate of ``bench`` (column-iterations, FLOPs a
  trip of the H-solve and of training, the STFT's FLOPs and bytes a frame,
  audio seconds a call, the mixed campaign's files and padding) equal the
  reference's for the same shapes, and the MU rate's spectrogram and
  solve agree with the reference in float64;
* the GEMM-only chains equal the reference's in float64 to 1e-12;
* the headline ``enhance_batch`` is int16 identical to the reference's
  ``_block_run_batch`` in float64;
* every mode's report has the reference's keys (the port's additions and
  the TPU-only keys it drops named here) at a small size on the CPU.
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.headline import HEADLINE_PLAN as J_HEADLINE_PLAN
from se_snmf_nat_tpu.runtime import profiling as jprof
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import bench
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession

torch.set_num_threads(1)
N = 8320          # 52 hops + 4 flush frames = 56 frames
F64 = torch.float64

# keys whose values are times (finite, positive), decided by a time (type
# only), or said in words; the port's additions to the reference's keys
TIMES = {"tick_ms", "device_tick_ms", "device_ms_per_lane",
         "device_round_ms", "tick_p90_ms", "device_ms_per_hop",
         "singlehop_wall_ms"}
DECIDED = {"real_time", "max_real_time_fleet", "max_compute_real_time_fleet",
           "max_compute_real_time_streams",
           "max_real_time_streams_shipped_path", "device_within_budget",
           "singlehop_within_budget_here", "dispatch_overhead_ms"}
WORDS = {"note"}
ADDED = {"timing", "peak_mib"}


def _jcfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                      adapt=replace(cfg.adapt, r_a=4, m_a=10),
                      nmf=replace(cfg.nmf, max_iter=6))


@pytest.fixture(scope="module")
def setup():
    cfg = _jcfg()
    pcfg = config_from_jax(cfg)
    x, fs, bases, kind = bench.bench_inputs(pcfg, n_samples=N)
    assert kind == "synthetic" and fs == 16000
    ref = JEnhancer(cfg, *bases, dtype=jnp.float64, matlab_ad_blk_init=False)
    port = SnmfEnhancer(pcfg, *bases, device="cpu", dtype=F64,
                        matlab_ad_blk_init=False)
    return cfg, pcfg, x, bases, ref, port


def _same_report(got, want, path="report"):
    """``got`` has ``want``'s keys plus ``ADDED``; times are finite and
    positive, decided fields have the reference's type, the rest equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) - ADDED == set(want), \
            (path, set(got) ^ set(want))
        for k, w in want.items():
            g = got[k]
            if k in TIMES:
                assert math.isfinite(g) and g > 0, (path, k, g)
                assert math.isfinite(w) and w > 0, (path, k, w)
            elif k in DECIDED:
                assert type(g) is type(w) or (
                    isinstance(g, (int, float)) and isinstance(w, (int, float))
                ), (path, k, g, w)
            elif k not in WORDS:
                _same_report(g, w, f"{path}.{k}")
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_report(g, w, f"{path}[{i}]")
        return
    assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the measure_* helpers against the reference's
# ---------------------------------------------------------------------------


def test_measure_serving_capacity_matches_reference(setup):
    _, _, _, _, ref, port = setup
    kw = dict(fleet_sizes=(1, 2), block_frames_grid=(4,), n_ticks=2)
    got = profiling.measure_serving_capacity(port, **kw)
    _same_report(got, jprof.measure_serving_capacity(ref, **kw))
    assert [b["pipelined"] for b in got["blocks"]] == [False, True]
    assert all(r["peak_mib"] is None for b in got["blocks"]
               for r in b["table"])           # no card: no device memory


def test_measure_serving_device_ceiling_matches_reference(setup):
    _, _, _, _, ref, port = setup
    kw = dict(fleet_sizes=(1, 2), block_frames=4, n_inner=2)
    got = profiling.measure_serving_device_ceiling(port, **kw)
    _same_report(got, jprof.measure_serving_device_ceiling(ref, **kw))
    for row in got["table"]:
        assert row["device_ms_per_lane"] == pytest.approx(
            row["device_tick_ms"] / row["fleet"])


def test_measure_serving_device_ceiling_sharded_matches_reference(setup):
    _, _, _, _, ref, port = setup
    kw = dict(shard_plans=((2, 1),), block_frames=4, n_inner=2)
    got = profiling.measure_serving_device_ceiling_sharded(port, **kw)
    _same_report(got,
                 jprof.measure_serving_device_ceiling_sharded(ref, **kw))
    assert got["shipped_program"] is True


def test_measure_hop_latency_matches_reference(setup):
    _, _, x, _, ref, port = setup
    got = profiling.measure_hop_latency(port, x, n_rep=1, n_calls=3)
    want = jprof.measure_hop_latency(ref, x, n_rep=1, n_calls=3)
    _same_report(got, want)
    assert got["n_frames"] == want["n_frames"] == N // 160 + 4
    assert got["hop_budget_ms"] == 10.0
    assert got["dispatch_overhead_ms"] == pytest.approx(
        got["singlehop_wall_ms"] - got["device_ms_per_hop"])


def test_measure_serving_product_path_matches_reference(setup):
    _, _, _, _, ref, port = setup
    kw = dict(plans=((1, 2), (2, 1)), block_frames=4, n_ticks=2)
    got = profiling.measure_serving_product_path(port, **kw)
    _same_report(got, jprof.measure_serving_product_path(ref, **kw))
    assert [r["total_streams"] for r in got["table"]] == [2, 2]


def test_device_tick_window_advances_a_fleet_as_push_does(setup):
    """``_fleet_tick_window``'s warm window (n_inner device ticks on one
    hop batch) leaves the fleet where ``push`` of the same hops leaves a
    fresh fleet: state, device queue and overlap-add history, bit for
    bit."""
    _, _, _, _, _, port = setup
    lanes, block, n_inner = 2, 4, 3
    hops = np.rint(np.random.default_rng(5).standard_normal(
        (lanes, block, 160)) * 2000.0)
    pushed = MultiStreamSession(port, lanes, block_frames=block,
                                wire="samples")
    for _ in range(n_inner):
        pushed.push(hops.reshape(lanes, -1))
    _, _, carry = profiling._fleet_tick_window(
        port, lanes, block, n_inner, np.random.default_rng(5))
    queue, recent, state, l0 = carry
    assert torch.equal(queue, pushed._queue_dev)
    assert torch.equal(recent, pushed._recent_dev)
    for a, b in zip(state, pushed.state):
        assert torch.equal(a, b)
    assert l0.tolist() == [1 + n_inner * block] * lanes


def test_a_fleet_that_does_not_fit_raises_with_its_size(monkeypatch):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(RuntimeError, match="a fleet of 512 lanes"):
        with profiling._row_memory(torch.device("cpu"),
                                   "a fleet of 512 lanes", []):
            oom()


# ---------------------------------------------------------------------------
# the counts behind the rates
# ---------------------------------------------------------------------------


def test_mu_rate_spectrogram_counts_and_solve_match_reference(setup):
    """The MU rate's spectrogram (the rfft analysis of the bench frames,
    tiled over the batch), its column-iterations and FLOPs a trip, and the
    fixed-trip solve against the reference's in float64."""
    from se_snmf_nat_tpu.dsp.stft import analysis_frames as j_analysis
    from se_snmf_nat_tpu.nmf.solver import SnmfParams as JParams
    from se_snmf_nat_tpu.nmf.solver import snmf_h_solve_columns as j_solve
    from se_snmf_nat_tpu_torch.kernels.mu import mu_h_solve_columns
    cfg, pcfg, x, bases, _, _ = setup
    b = 2
    s = cfg.signal
    j_enh = JEnhancer(cfg, *bases, dtype=jnp.float64, **J_HEADLINE_PLAN)
    p_enh = build_headline_enhancer(pcfg, bases, device="cpu", dtype=F64)
    true_frames = p_enh.frames_for(np.asarray(x, np.float64))
    n_true = true_frames.shape[0]
    frames = p_enh._pad_frames(true_frames)
    np.testing.assert_array_equal(
        frames, j_enh._pad_frames(j_enh.frames_for(x)))
    v, w, h0 = bench.mu_rate_inputs(p_enh, frames, n_true, b, bases)
    mag, _ = j_analysis(jnp.asarray(frames), j_enh.win, s.fftlength, s.pow,
                        s.dc_bin, s.nonzerofloor, s.preemph)
    jv = np.asarray(jnp.tile(mag[:n_true].T, (1, b)))
    jw = np.concatenate([bases[0], bases[1]], axis=1)
    assert v.shape == jv.shape and w.shape == jw.shape
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(w.numpy(), jw)
    f_bins, n_cols = jv.shape
    r = jw.shape[1]
    assert n_cols == b * n_true
    # column-iterations and FLOPs a trip, as the reference counts them
    assert cfg.nmf.max_iter * v.shape[1] == cfg.nmf.max_iter * n_cols
    assert bench.mu_flops_per_iter(*v.shape[:1], w.shape[1], v.shape[1]) \
        == 2 * (2.0 * f_bins * r * n_cols)
    h, trips = mu_h_solve_columns(v, w, h0, cfg.nmf.max_iter, 0.0,
                                  float(cfg.nmf.sparsity), 1e-9)
    assert bool((trips == cfg.nmf.max_iter).all())
    want = j_solve(jnp.asarray(jv), jnp.asarray(jw),
                   jnp.full((r, n_cols), 0.5),
                   JParams(beta=cfg.nmf.beta,
                           sparsity=float(cfg.nmf.sparsity),
                           max_iter=cfg.nmf.max_iter, conv_eps=0.0,
                           flr=1e-9))
    np.testing.assert_allclose(h.numpy(), np.asarray(want.h), rtol=1e-9,
                               atol=1e-12 * float(np.abs(want.h).max()))


def test_stft_counts_match_reference(setup):
    """FLOPs and bytes a frame of the STFT rate, as the reference counts
    them (bench.py: two (T, 640) x (640, F) products; read a frame, write
    the magnitude and the 2F phasor)."""
    cfg = setup[0]
    s = cfg.signal
    assert bench.stft_flops_per_frame(s.framelength, s.n_bins) \
        == 2 * (2.0 * s.framelength * s.n_bins)
    assert bench.stft_bytes_per_frame(s.framelength, s.fftlength) \
        == 4 * (s.framelength + 3 * (s.fftlength // 2 + 1))
    assert bench.stft_flops_per_frame(640, 513) == 1313280.0
    assert bench.stft_bytes_per_frame(640, 1024) == 8716


@pytest.mark.parametrize("chain", ["mu", "train"])
def test_gemm_chains_match_reference_x64(chain):
    """The GEMM-only chains equal the reference's (bench.py's and
    ``cli bench --train-rate``'s, written out here as they stand there) in
    float64 to 1e-12."""
    rng = np.random.default_rng(11)
    f, r, n, trips = 33, 7, 19, 9
    w = np.abs(rng.standard_normal((f, r))) + 1e-3
    h = np.abs(rng.standard_normal((r, n))) + 1e-3
    prec = jax.lax.Precision.DEFAULT
    if chain == "mu":
        jw = jnp.asarray(w)
        w_norm = jw / jnp.sqrt(jnp.sum(jw * jw, axis=0))[None, :]

        def body(hh, _):
            g = jnp.matmul(w_norm, hh, precision=prec)
            g = jnp.matmul(w_norm.T, g, precision=prec)
            return g * jnp.float32(9.5e-3), None
        want = np.asarray(jax.lax.scan(body, jnp.asarray(h), None,
                                       length=trips)[0])
        tw = torch.as_tensor(w)
        got = bench.mu_gemm_chain(
            tw / torch.sqrt(torch.sum(tw * tw, dim=0))[None, :],
            torch.as_tensor(h), trips).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        return

    def body(carry, _):
        w, h = carry
        lam = jnp.matmul(w, h, precision=prec)
        dmh = jnp.matmul(w.T, lam, precision=prec)
        h = h * jnp.float32(0.999) + dmh * jnp.float32(1e-9)
        lam2 = jnp.matmul(w, h, precision=prec)
        c = jnp.matmul(lam2, h.T, precision=prec)
        w = w * jnp.float32(0.999) + c * jnp.float32(1e-9)
        lam3 = jnp.matmul(w, h, precision=prec)
        dmh2 = jnp.matmul(w.T, lam3, precision=prec)
        h = h + dmh2 * jnp.float32(1e-9)
        return (w, h), None
    jw_, jh_ = jax.lax.scan(body, (jnp.asarray(w), jnp.asarray(h)), None,
                            length=trips)[0]
    gw, gh = bench.train_gemm_chain(torch.as_tensor(w), torch.as_tensor(h),
                                    trips)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw_), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jh_), rtol=1e-12,
                               atol=0)


def test_training_shape_and_flops_match_reference(setup, tmp_path):
    """``--train-rate``'s database (the jittered copies), its training
    shape (F, T, r) and FLOPs a trip, against the reference's recipe
    (``cli bench --train-rate``) on the same clip."""
    from se_snmf_nat_tpu.io.wavio import write_wav_int16 as j_write
    from se_snmf_nat_tpu.train.dataset import (
        build_training_sequence as j_sequence)
    from se_snmf_nat_tpu.train.features import (
        training_features as j_features)
    from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
    from se_snmf_nat_tpu_torch.train.dataset import build_training_sequence
    from se_snmf_nat_tpu_torch.train.features import training_features
    cfg, pcfg, x, _, _, _ = setup
    rng0 = np.random.default_rng(1)
    want_copies = []
    for _ in range(3):
        jitter = np.clip(np.asarray(x, np.float64)
                         * (1.0 + 0.01 * rng0.standard_normal()),
                         -32768, 32767)
        want_copies.append(jitter.astype(np.int16))
    got_copies = bench.training_copies(x, 3)
    for g, w in zip(got_copies, want_copies):
        np.testing.assert_array_equal(g, w)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    for i, c in enumerate(want_copies):
        j_write(tmp_path / "j" / f"c{i}.wav", c, 16000)
        write_wav_int16(tmp_path / "p" / f"c{i}.wav", c, 16000)
    j_seq, _ = j_sequence(tmp_path / "j", cfg)
    p_seq, _ = build_training_sequence(tmp_path / "p", pcfg)
    jv = j_features(j_seq, cfg, dc_bin=cfg.signal.dc_bin).tf_mag
    pv = training_features(p_seq, pcfg, dc_bin=pcfg.signal.dc_bin).tf_mag
    assert pv.shape == jv.shape
    f_bins, t_cols = jv.shape
    r = min(100, t_cols - 1)
    assert bench.train_flops_per_iter(*pv.shape[:1], r, pv.shape[1]) \
        == 6 * (2.0 * f_bins * r * t_cols)


def test_mixed_campaign_files_and_padding_match_reference(setup):
    """``--campaign-mixed``'s 80 files at seed 7 (lengths, contents, total
    audio) and both chunkings' padded widths and padding waste, against
    the reference's recipe written out here as it stands in ``cli bench
    --campaign-mixed``."""
    cfg, pcfg, x, bases, _, _ = setup
    fs, n_files, b_sz = 16000, 80, 32
    rng = np.random.default_rng(7)
    lengths = rng.integers(2 * fs, 12 * fs, n_files)
    want_files, total_audio = [], 0.0
    for ln in lengths:
        reps = -(-int(ln) // len(x))
        start = int(rng.integers(0, len(x)))
        want_files.append(np.tile(np.roll(x, -start), reps)[: int(ln)])
        total_audio += int(ln) / fs
    got_files = bench.mixed_files(x, fs)
    assert len(got_files) == n_files
    for g, w in zip(got_files, want_files):
        np.testing.assert_array_equal(g, w)
    assert sum(len(f) for f in got_files) / fs == pytest.approx(
        total_audio, rel=1e-15)
    enh = build_headline_enhancer(pcfg, bases, device="cpu")
    j_bucket = JEnhancer(cfg, *bases, dtype=jnp.float64,
                         **J_HEADLINE_PLAN).frame_bucket
    assert enh.frame_bucket == j_bucket
    shift, n_flush = cfg.signal.frameshift, cfg.delay + 1

    def j_pad_stats(order):
        widths, pad, true = [], 0, 0
        for c0 in range(0, len(order), b_sz):
            chunk = order[c0: c0 + b_sz]
            tt = [int(ln) // shift + n_flush for ln in chunk]
            t_max = -(-max(tt) // j_bucket) * j_bucket
            widths.append(t_max)
            pad += sum(t_max - t for t in tt) \
                + (b_sz - len(chunk)) * t_max
            true += sum(tt)
        return {"distinct_compiled_widths": len(set(widths)),
                "padding_waste_frac": round(pad / true, 3)}

    for order in (sorted(lengths), list(lengths)):
        got = bench.pad_stats(lengths, order, b_sz, shift, n_flush,
                              enh.frame_bucket)
        want = j_pad_stats(order)
        assert got["distinct_padded_widths"] \
            == want["distinct_compiled_widths"]
        assert got["padding_waste_frac"] == want["padding_waste_frac"]


def test_headline_batch_int16_identical_to_reference_x64(setup):
    """The default mode's call: the headline plan's ``enhance_batch`` of B=2
    copies of the bench clip, one chunk, in float64 on the CPU, against the
    reference's ``_block_run_batch`` in x64 on the same batch."""
    from se_snmf_nat_tpu.io.wavio import enhanced_quantize as j_quantize
    cfg, pcfg, _, bases, _, _ = setup
    x = bench.bench_inputs(pcfg, n_samples=30000)[0]
    b = 2
    j_enh = JEnhancer(cfg, *bases, dtype=jnp.float64, **J_HEADLINE_PLAN)
    true_frames = j_enh.frames_for(x)
    n_true = true_frames.shape[0]
    batch = jnp.asarray(np.stack([j_enh._pad_frames(true_frames)] * b))
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (b,) + a.shape),
                          j_enh.initial_state())
    ys, _ = j_enh._block_run_batch(batch, states, j_enh.win,
                                   jnp.full((b,), n_true, jnp.int32))
    start = cfg.delay * cfg.signal.frameshift
    stop = start + (n_true - cfg.delay) * cfg.signal.frameshift
    want = [j_quantize(np.asarray(ys)[i, start:stop]) for i in range(b)]
    p_enh = build_headline_enhancer(pcfg, bases, device="cpu", dtype=F64)
    got = p_enh.enhance_batch([x] * b, micro_batch=None)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)


def test_campaign_audio_seconds_a_call(setup):
    _, pcfg, x, _, _, _ = setup
    rep = bench.run_campaign("cpu", cfg=pcfg, campaign_batch=2, reps=1,
                             micro_batches=(1,), n_samples=N)
    assert rep["audio_s_per_call"] == 2 * len(x) / 16000   # b * len / fs
    assert set(rep) == {"batch", "wav", "audio_s_per_call", "snmf_headline",
                        "snmf_headline_mb1", "ms", "imcra", "timing", "card",
                        "device", "input"}
    for k in ("snmf_headline", "snmf_headline_mb1", "ms", "imcra"):
        assert set(rep[k]) == {"call_s", "audio_s_per_s_e2e"}
        assert rep[k]["audio_s_per_s_e2e"] == pytest.approx(
            rep["audio_s_per_call"] / rep[k]["call_s"])


# ---------------------------------------------------------------------------
# every mode's report at a small size on the CPU
# ---------------------------------------------------------------------------

# root bench.py's keys; the port drops the two that only the TPU's pair
# dispatch and its 100 audio-s/s baseline had, and adds its own
J_HEADLINE_KEYS = {
    "metric", "value", "unit", "vs_baseline",
    "audio_s_per_s_single_dispatch", "mu_iters_per_s", "mu_gemm_tflops",
    "mu_gemm_mfu", "mu_ceiling_tflops", "mu_roofline_frac",
    "mu_solver_shape", "stft_frames_per_s", "stft_tflops", "stft_hbm_gbps",
    "stft_hbm_frac"}
DROPPED = {"vs_baseline", "audio_s_per_s_single_dispatch"}
STAMP = {"card", "device", "input"}


def _finite_positive(rep, keys):
    for k in keys:
        assert math.isfinite(rep[k]) and rep[k] > 0, (k, rep[k])


def test_headline_report(setup):
    _, pcfg, x, _, _, _ = setup
    rep = bench.run_headline("cpu", cfg=pcfg, batch_size=2, n_rep=1,
                             mu_reps=1, stft_inner=1, n_samples=N)
    assert set(rep) == (J_HEADLINE_KEYS - DROPPED) | STAMP | {
        "audio_s_per_call", "peaks", "launches", "timing"}
    _finite_positive(rep, ("value", "mu_iters_per_s", "mu_gemm_tflops",
                           "mu_gemm_mfu", "mu_ceiling_tflops",
                           "mu_roofline_frac", "stft_frames_per_s",
                           "stft_tflops", "stft_hbm_gbps", "stft_hbm_frac"))
    assert rep["audio_s_per_call"] == 2 * len(x) / 16000
    assert rep["mu_solver_shape"] == "F=513 r=16 cols=112 iters=6"
    assert rep["peaks"] == {"flops": 67e12, "bytes_per_s": 3.35e12}
    assert rep["launches"] == {"K1": 0, "K2": 0, "K3": 0}   # plain on CPU
    assert rep["card"] == "cpu" and rep["input"] == "synthetic"
    assert rep["mu_gemm_mfu"] == pytest.approx(
        rep["mu_gemm_tflops"] * 1e12 / 67e12)


def test_train_rate_report(setup):
    pcfg = setup[1]
    rep = bench.run_train_rate("cpu", cfg=pcfg, n_copies=2, n_samples=N)
    # the reference's keys, its share of the TPU's bf16 peak renamed
    assert set(rep) == {
        "train_shape", "solve_wall_s", "mu_iters", "train_mu_iters_per_s",
        "train_gemm_tflops", "train_mfu_vs_f32_peak",
        "train_ceiling_tflops", "train_roofline_frac",
        "audio_seconds_trained", "timing"} | STAMP
    _finite_positive(rep, ("solve_wall_s", "mu_iters", "train_gemm_tflops",
                           "train_ceiling_tflops", "train_roofline_frac"))
    assert rep["audio_seconds_trained"] == 2 * N / 16000


def test_campaign_mixed_report(setup):
    pcfg = setup[1]
    rep = bench.run_campaign_mixed("cpu", cfg=pcfg, n_files=5, b_sz=2,
                                   length_range_s=(0.3, 0.6), n_samples=N)
    assert set(rep) == {"files", "batch", "audio_s_total", "length_range_s",
                        "length_sorted", "unsorted", "rerun_skip_all",
                        "timing"} | STAMP
    for tag in ("length_sorted", "unsorted"):
        row = rep[tag]
        assert set(row) == {"distinct_padded_widths", "padding_waste_frac",
                            "cold", "warm"}
        for phase in ("cold", "warm"):
            assert row[phase]["processed"] == 5
            _finite_positive(row[phase], ("wall_s", "files_per_s",
                                          "audio_s_per_s_e2e"))
    assert rep["rerun_skip_all"]["skipped"] == 5


def test_multichannel_report(setup):
    pcfg = setup[1]
    rep = bench.run_multichannel("cpu", cfg=pcfg, offline_reps=1,
                                 lane_grid=(1,), fast_grid=(1, 2),
                                 stream_calls=1, n_hops=16,
                                 ntf_shape=(33, 16, 4), ntf_iters=3,
                                 n_blks=2, n_samples=4800)
    assert set(rep) == {"pmwf_6ch", "pmwf_stream_batch1",
                        "pmwf_stream_fast1", "pmwf_stream_fast2",
                        "pmwf_session", "ntf", "ntf_online",
                        "ntf_online_batched", "timing"} | STAMP
    for k in ("pmwf_6ch", "pmwf_stream_batch1", "pmwf_stream_fast1",
              "pmwf_stream_fast2"):
        assert rep[k]["output_finite"] is True
        _finite_positive(rep[k], ("call_s", "audio_s_per_s"))
    assert rep["ntf"]["shape"] == "C=6 N=33 M=16 K=4 iters=3"
    _finite_positive(rep["ntf_online_batched"], ("blocks_per_s",))


def test_latency_scaling_and_trace_reports(setup, tmp_path):
    pcfg = setup[1]
    lat = bench.run_latency("cpu", cfg=pcfg, n_rep=1, n_calls=3,
                            n_samples=N)
    assert set(lat) == {"device_ms_per_hop", "singlehop_wall_ms",
                        "dispatch_overhead_ms", "hop_budget_ms",
                        "device_within_budget",
                        "singlehop_within_budget_here", "n_frames",
                        "timing", "launches"} | STAMP
    sc = bench.run_scaling("cpu", cfg=pcfg, per_device_batch=1, n_rep=1,
                           n_samples=N)
    assert sc["plan"] == "block_adaptive" and sc["1"]["devices"] == 1
    tr = bench.run_trace(str(tmp_path / "t"), "cpu", cfg=pcfg, n_samples=N)
    assert tr["n_files"] >= 1 and tr["trace_dir"] == str(tmp_path / "t")


def test_serving_and_collectives_reports(setup):
    pcfg = setup[1]
    rep = bench.run_serving("cpu", cfg=pcfg, fleet_sizes=(1,),
                            block_frames_grid=(4,), n_ticks=2,
                            ceiling_sizes=(1,), n_inner=2,
                            shard_plans=((2, 1),), product_plans=((2, 1),),
                            product_ticks=2)
    assert set(rep) == {"wire", "max_real_time_fleet", "blocks",
                        "device_ceiling", "device_ceiling_sharded",
                        "product_path_sharded", "timing", "launches",
                        "card", "device"}
    col = bench.run_collectives("cpu", per_device_batch=16, cfg=pcfg)
    assert col["pmean_dictionary_merge"]["n_collectives"] == 1



# ---------------------------------------------------------------------------
# the modes scored against golden wavs, on a reference root laid out as the
# reference repository's (its dictionaries as .mat, its four wavs)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory, setup):
    import scipy.io as sio

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
    _, _, _, bases, _, _ = setup
    root = tmp_path_factory.mktemp("reference")
    for sub, b in (("Clean_train_TIMIT_test", bases[0]),
                   ("CHiME3_bgn_ch6", bases[1])):
        d = root / "basis" / sub / "TASLP_Splice0-SNMF_p2_DD0"
        d.mkdir(parents=True)
        sio.savemat(d / "R_100.mat", {"B_DFT_sub": b,
                                      "B_Mel_sub": b[:64] + 1e-3})
    (root / "wav").mkdir()
    for i, (_, in_path, gold_path) in enumerate(bench.GOLDEN_FIXTURES):
        x = fixtures.noisy_utterance(N + 1600 * i, seed=20 + i)
        clean = fixtures.clean_utterance(N + 1600 * i, seed=20 + i)
        write_wav_int16(root / in_path, x.astype(np.int16), 16000)
        write_wav_int16(root / gold_path,
                        np.clip(np.rint(clean), -32768, 32767)
                        .astype(np.int16), 16000)
    return root


def test_reference_root_replaces_the_synthetic_inputs(setup, fake_root):
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
    pcfg = setup[1]
    x, fs, bases, kind = bench.bench_inputs(pcfg, fake_root)
    assert kind == "reference" and fs == 16000
    np.testing.assert_array_equal(
        x, read_wav_int16(fake_root / bench.REFERENCE_WAV)[0])
    np.testing.assert_array_equal(bases[0], setup[3][0])
    rep = bench.run_latency("cpu", fake_root, cfg=pcfg, n_rep=1, n_calls=2)
    assert rep["input"] == "reference" and rep["n_frames"] == N // 160 + 4


def test_quality_report(setup, fake_root):
    from se_snmf_nat_tpu_torch.bnmf import BnmfParams
    pcfg = setup[1]
    rep = bench.run_quality("cpu", fake_root, cfg=pcfg,
                            bnmf_params=BnmfParams(k_speech=4, k_noise=3,
                                                   train_iters=2,
                                                   noise_init_iters=3,
                                                   n_infer=2))
    assert set(rep) == {"M03", "LM", "multichannel_synthetic", "card",
                        "device", "input"}
    for fix in ("M03", "LM"):
        assert set(rep[fix]) == {"snmf_headline", "snmf_block16",
                                 "snmf_fixed_fast", "imcra", "ms", "bnmf"}
        for name, row in rep[fix].items():
            assert "battery_vs_input" in row
            assert ("corr_vs_golden" in row) == (name in ("snmf_headline",
                                                          "snmf_block16"))
        assert 0.0 < rep[fix]["snmf_headline"]["corr_vs_golden"] <= 1.0
    mc = rep["multichannel_synthetic"]
    assert math.isfinite(mc["segsnr_db_pmwf_offline"])


def test_quality_sharded_report(setup, fake_root):
    pcfg = setup[1]
    rep = bench.run_quality_sharded("cpu", fake_root, cfg=pcfg, halo=16)
    assert set(rep) == {"devices", "time_shard", "time_shard_LM",
                        "tp_h_solve", "card", "device", "input"}
    for tag in ("time_shard", "time_shard_LM"):
        assert rep[tag]["shards"] == 8 and rep[tag]["halo"] == 16
        assert -1.0 <= rep[tag]["corr_vs_sequential"] <= 1.0
    tp = rep["tp_h_solve"]
    assert tp["iters_ref"] == tp["iters_tp"]
    assert tp["h_max_rel_diff"] < 1e-4


def test_pareto_runs_the_points_the_port_has(setup, fake_root):
    pcfg = setup[1]
    points = ((16, 5, 16, 5, True, False, False),
              (16, 5, 16, 5, True, True, False),
              (16, 5, 16, 3, True, False, True, "high", "default"),
              (16, 5, 16, 5, True, False, False, "high", "default"))
    run, skipped = bench.pareto_plan(points)
    assert run == [(16, 5, 16, 5, True)] and len(skipped) == 3
    rep = bench.run_pareto("cpu", fake_root, cfg=pcfg, batch_size=2,
                           n_rep=1, points=points)
    (row,) = rep["rows"]
    assert row["k"] == 16 and row["frames_padded"] == 64
    assert set(row) >= {"M03", "LM", "corr_margin", "audio_s_per_s"}
    assert row["corr_margin"] == pytest.approx(
        min(row["M03"]["corr"], row["LM"]["corr"]) - 0.99, abs=1e-4)
    assert rep["skipped"] == skipped
