"""Port parity of the non-adaptive fast plan: ``SnmfEnhancer(block_adapt=0)``
and ``make_fast_run`` of ``se_snmf_nat_tpu_torch`` against the JAX
package's, at narrow widths (r_x = r_d = 16) on ``structured_bases``, three
utterances of different lengths and micro-batches of two.

Configurations: ``snmf`` (Wiener, no Q), the MMSE+Q fixed variant
(``default_config()`` with ``adapt_train_n=False``, Q at gap 3),
``snmf_techwin_rt`` (Wiener, 3 events) and the MMSE+Q fixed variant in the
Mel separation mode.  float64: int16 output identical.  float32: the
port's gap to JAX float32 stays within twice the JAX float32-to-float64 gap
on the same input, plus 1e-6."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import PRESETS, default_config, preset
from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu.stream import fast_pipeline as j_fast
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.dsp.stft import stream_frames
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.stream.fast_pipeline import (
    make_fast_run, supports_fast_plan)
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)
LENGTHS = (5200, 7900, 3700)


def _narrow(cfg):
    return cfg.evolve(sep=replace(cfg.sep, r_x=16, r_d=16))


def _mmse_q_fixed(**sep):
    cfg = default_config()
    return _narrow(cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False),
                              sep=replace(cfg.sep, **sep)))


CONFIGS = {
    "snmf": lambda: _narrow(preset("snmf")),
    "mmse_q_fixed": _mmse_q_fixed,
    "snmf_techwin_rt": lambda: _narrow(preset("snmf_techwin_rt")),
    "mel": lambda: _mmse_q_fixed(b_sep_mode="Mel"),
}


def _bases(cfg):
    """(b1_x, b1_d, b2_x, b2_d): separation bases in the Mel domain in Mel
    mode, DFT bases for the reconstruction."""
    s = cfg.signal
    f_sep = s.f_order if cfg.sep.b_sep_mode == "Mel" else s.n_bins
    b1 = fixtures.structured_bases(f_sep, 16, 16, seed=5)
    b2 = fixtures.structured_bases(s.n_bins, 16, 16, seed=5)
    return b1 + b2


@pytest.fixture(scope="module")
def xs():
    return [fixtures.noisy_utterance(n, seed=i) for i, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def enhancers():
    """name -> (reference, port) float64 enhancers, each built once."""
    built = {}

    def get(name):
        if name not in built:
            cfg = CONFIGS[name]()
            bases = _bases(cfg)
            built[name] = (JEnhancer(cfg, *bases, dtype=jnp.float64),
                           SnmfEnhancer(config_from_jax(cfg), *bases,
                                        device="cpu", dtype=torch.float64))
        return built[name]
    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_enhance_batch_int16_identical_x64(name, xs, enhancers):
    ref, port = enhancers(name)
    assert port.fast_run is not None and port.run is None
    n0 = mu.mu_h_solve_columns.launches
    want = ref.enhance_batch(xs, micro_batch=2)
    got = port.enhance_batch(xs, micro_batch=2)
    assert mu.mu_h_solve_columns.launches == n0     # CPU: plain version
    assert len(got) == len(want) == len(xs)
    for g, w, x in zip(got, want, xs):
        assert g.dtype == np.int16 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert np.sqrt(np.mean(g.astype(float) ** 2)) < np.sqrt(
            np.mean(x ** 2))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_enhance_single_int16_identical_x64(name, xs, enhancers):
    ref, port = enhancers(name)
    np.testing.assert_array_equal(port.enhance(xs[1]), ref.enhance(xs[1]))


def test_enhance_batch_micro_batch_invariant(xs, enhancers):
    _, port = enhancers("mmse_q_fixed")
    for a, b in zip(port.enhance_batch(xs, micro_batch=None),
                    port.enhance_batch(xs, micro_batch=2)):
        np.testing.assert_array_equal(a, b)


def _frames(cfg, xs, silent: bool):
    """The lanes' frames and the output samples their real frames cover.
    ``silent``: with each utterance's zero flush frames and zero padding
    to the longest lane; else only signal frames, cut to the shortest
    lane."""
    s = cfg.signal
    fr = [stream_frames(x, s.framelength, s.frameshift,
                        cfg.delay + 1 if silent else 0) for x in xs]
    t = max(len(f) for f in fr) if silent else min(len(f) for f in fr)
    frames = np.stack([np.concatenate(
        [f[:t], np.zeros((t - len(f[:t]), f.shape[1]))]) for f in fr])
    return frames, [min(len(f), t) * s.frameshift for f in fr]


def _fast_runs(name, xs, silent):
    """(JAX float64, JAX float32, port float32) outputs of the run, each
    lane cut to its real frames' samples."""
    cfg = CONFIGS[name]()
    bases = _bases(cfg)
    frames, n_out = _frames(cfg, xs, silent)
    win = sqrt_hann_periodic(cfg.signal.framelength)
    outs = []
    for dt in (jnp.float64, jnp.float32):
        run = j_fast.make_fast_run(cfg, *bases, dt)
        outs.append([np.asarray(run(jnp.asarray(f, dt),
                                    jnp.asarray(win, dt)))[:n]
                     for f, n in zip(frames, n_out)])
    port = make_fast_run(config_from_jax(cfg), *bases, device="cpu",
                         dtype=torch.float32)
    with torch.no_grad():
        y = port(torch.as_tensor(frames, dtype=torch.float32),
                 torch.as_tensor(win, dtype=torch.float32)).numpy()
    assert y.dtype == np.float32
    outs.append([y[lane, :n] for lane, n in enumerate(n_out)])
    return outs


def _rel_gap(a, b, scale):
    return np.abs(np.asarray(a, np.float64) - b).max() / scale


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fast_run_f32_within_reference_envelope(name, xs):
    """On signal frames: the port's float32 gap to JAX float32 within twice
    JAX's float32-to-float64 gap, plus 1e-6."""
    for y64, y32, y in zip(*_fast_runs(name, xs, silent=False)):
        scale = np.abs(y64).max()
        env = _rel_gap(y32, y64, scale)
        gap = _rel_gap(y, y32, scale)
        assert gap <= 2 * env + 1e-6, (gap, env)


@pytest.mark.parametrize("name", ["mel", "mmse_q_fixed"])
def test_fast_run_f32_silent_frames_stay_finite(name, xs):
    """Zero frames (every utterance's flush frames, bucket padding) with
    denormals flushed to zero, as XLA's CPU float32 and cuBLAS do: a speech
    reconstruction that underflows to 0 must not turn Q, and with it every
    frame of the lane, into NaN (``snr_column``).  The port's float32 output
    stays finite and as close to the float64 reference as without the
    flush."""
    assert torch.set_flush_denormal(True)
    try:
        ref64, _, y_ftz = _fast_runs(name, xs, silent=True)
    finally:
        torch.set_flush_denormal(False)
    _, _, y = _fast_runs(name, xs, silent=True)
    for y64, a, b in zip(ref64, y_ftz, y):
        assert np.all(np.isfinite(a))
        scale = np.abs(y64).max()
        assert _rel_gap(a, y64, scale) <= 2 * _rel_gap(b, y64, scale) + 1e-6


@pytest.mark.parametrize("name", PRESETS)
def test_supports_fast_plan_agrees_with_jax(name):
    cfg = preset(name)
    assert (supports_fast_plan(config_from_jax(cfg))
            == j_fast.supports_fast_plan(cfg))


def test_fast_plan_presets_are_the_fixed_dictionary_ones():
    fast = {n for n in PRESETS
            if supports_fast_plan(config_from_jax(preset(n)))}
    assert {"snmf", "exemplar", "snmf_techwin_rt"} <= fast
    assert not fast & {"snmf_nat", "proposed_is16", "semisupervised"}


@pytest.mark.parametrize("case", ["adaptive_config", "carried_state",
                                  "return_state", "q_sequential"])
def test_plans_beside_the_fast_plan_int16_identical_x64(case, xs, enhancers):
    """What used to raise beside the fast plan now runs and equals the JAX
    package: ``block_adapt=0`` on an adaptive config and a state carried in
    or out of a fixed config take the exact per-frame plan, and
    ``blk_gap=1`` stays on the fast plan."""
    cfg = CONFIGS["mmse_q_fixed"]()
    # the engine's rings need r_a <= r_d
    cfg = cfg.evolve(adapt=replace(cfg.adapt, r_a=8, m_a=12))
    bases = _bases(cfg)
    if case == "adaptive_config":
        cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=True))
    elif case == "q_sequential":
        cfg = cfg.evolve(blk=replace(cfg.blk, blk_gap=1))
    ref = JEnhancer(cfg, *bases, dtype=jnp.float64)
    port = SnmfEnhancer(config_from_jax(cfg), *bases, device="cpu",
                        dtype=torch.float64)
    assert (port.fast_run is None) == (case == "adaptive_config")
    assert port.run is None
    if case in ("adaptive_config", "q_sequential"):
        np.testing.assert_array_equal(port.enhance(xs[2]),
                                      ref.enhance(xs[2]))
        return
    want, st_ref = ref.enhance(xs[2], return_state=True)
    got, st = port.enhance(xs[2], return_state=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port.enhance(xs[2]))    # fast plan
    if case == "return_state":
        for name in st._fields:
            np.testing.assert_allclose(
                getattr(st, name).numpy().astype(float),
                np.asarray(getattr(st_ref, name)).astype(float), rtol=1e-9,
                atol=1e-12, err_msg=name)
    else:
        np.testing.assert_array_equal(port.enhance(xs[0], state=st),
                                      ref.enhance(xs[0], state=st_ref))


@pytest.mark.slow
def test_fast_plan_full_width_int16_identical_x64():
    """``snmf`` at full width (F=513, r_x=r_d=100) on two 3.43 s
    utterances."""
    cfg = preset("snmf")
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 100, 100, seed=0)
    xs = [fixtures.noisy_utterance(54880, seed=i) for i in range(2)]
    ref = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64)
    port = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                        dtype=torch.float64)
    for g, w in zip(port.enhance_batch(xs), ref.enhance_batch(xs)):
        np.testing.assert_array_equal(g, w)
