"""Port parity of the per-frame engine: ``Engine.step`` of
``se_snmf_nat_tpu_torch.enhance.engine`` against the JAX package's
``make_engine(...).step``, frame by frame over 44 frames of two lanes from a
converted state, at narrow widths (r_x = r_d = 16, r_a = 8, m_a = 12,
p_len_l = 4).

float64: every frame's output and, after the last frame, every state field
within 1e-9 relative to the largest entry (summation order only).  float32:
the adaptive trajectory amplifies rounding, so the port's gap to JAX
float32 must stay within twice the JAX float32-to-float64 gap on the same
input, plus 1e-6.

The dictionaries are the uniform random ones: on ``structured_bases`` the
speech reconstruction of a noise-only frame is ~1e-6 of its peak over whole
windows of the local-SNR ring, and there the reference's prefix-sum
differences lose digits that the port's banded sums keep (see
``tests/test_torch_blk_sparse.py``), so the two disagree by more than
summation order in the gain of the few bins above the floor."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.enhance.engine import make_engine as j_make_engine
from se_snmf_nat_tpu.nmf import solver as jsol
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import (
    config_from_jax, state_from_jax, state_to_numpy)
from se_snmf_nat_tpu_torch.dsp.stft import analysis_frames, stream_frames
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.enhance.engine import Engine, make_engine
from se_snmf_nat_tpu_torch.enhance.state import EngineState
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.nmf import solver as tsol

torch.set_num_threads(1)
T = 44
LANES = 2
R_A = 8


def _cfg(**over):
    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=16, r_d=16),
                     adapt=replace(cfg.adapt, r_a=R_A, m_a=12),
                     blk=replace(cfg.blk, p_len_l=4))
    for section, fields in over.items():
        cfg = cfg.evolve(**{section: replace(getattr(cfg, section),
                                             **fields)})
    return cfg


CASES = {
    "default": dict(),
    "wiener": dict(enhance=dict(method="Wiener")),
    "mel_conv": dict(sep=dict(b_sep_mode="Mel", mel_conv=True)),
    "mel_coupled": dict(sep=dict(b_sep_mode="Mel", mel_conv=False)),
    "semisupervised": dict(sep=dict(basis_update_n=True)),
    "adapt_off": dict(),
    "update_period_3": dict(adapt=dict(overlap_m_a=0.25)),
    "emit_sources": dict(sep=dict(event_num=3, event_rank=(1, 5, 9),
                                  noise_num=2, noise_rank=(1, 9))),
    "gap_1": dict(blk=dict(blk_gap=1)),
    "beta_2": dict(nmf=dict(cf="ed")),
}


def _bases(cfg):
    s = cfg.signal
    f_sep = s.f_order if cfg.sep.b_sep_mode == "Mel" else s.n_bins
    b1 = fixtures.synthetic_bases(f_sep, 16, 16, seed=5)
    b2 = fixtures.synthetic_bases(s.n_bins, 16, 16, seed=5)
    return b1 + b2


def _spectra(cfg, lanes=LANES):
    """(lanes, T, F) float64 power spectra of noisy utterances."""
    s = cfg.signal
    win = torch.as_tensor(sqrt_hann_periodic(s.framelength))
    mags = []
    for lane in range(lanes):
        x = fixtures.noisy_utterance(T * s.frameshift, seed=lane + 1)
        fr = stream_frames(x, s.framelength, s.frameshift, n_flush=0)
        mag, _ = analysis_frames(torch.as_tensor(fr), win, s.fftlength,
                                 s.pow, s.dc_bin, s.nonzerofloor, s.preemph)
        mags.append(mag.numpy())
    return np.stack(mags)


def _jax_run(cfg, bases, mags, dt, emit, adapt_on=True):
    eng = j_make_engine(cfg, *bases, dtype=dt, emit_sources=emit)
    step = jax.jit(eng.step)
    st0 = eng.init_state(dt)._replace(adapt_on=jnp.asarray(adapt_on))
    outs, states = [], []
    for lane in range(LANES):
        st, lane_out = st0, []
        for l in range(1, T + 1):
            st, out = step(st, (jnp.asarray(mags[lane, l - 1], dt),
                                jnp.asarray(l, jnp.int32)))
            lane_out.append(jax.tree.map(np.asarray, out))
        outs.append(lane_out)
        states.append(jax.tree.map(np.asarray, st))
    return outs, states, jax.tree.map(np.asarray, st0)


def _port_run(cfg, bases, mags, dtype, emit, st0):
    eng = make_engine(config_from_jax(cfg), *bases, device="cpu",
                      dtype=dtype, emit_sources=emit)
    st = state_from_jax(jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a), (LANES,) + np.shape(a)),
        st0), device="cpu", dtype=dtype)
    outs = []
    with torch.no_grad():
        for l in range(1, T + 1):
            st, out = eng.step(st, torch.as_tensor(mags[:, l - 1],
                                                   dtype=dtype), l)
            outs.append(out)
    return eng, outs, state_to_numpy(st)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_step_matches_jax_x64(case):
    cfg = _cfg(**CASES[case])
    bases = _bases(cfg)
    mags = _spectra(cfg)
    emit = case == "emit_sources"
    adapt_on = case != "adapt_off"
    ref_out, ref_st, st0 = _jax_run(cfg, bases, mags, jnp.float64, emit,
                                    adapt_on)
    eng, outs, st = _port_run(cfg, bases, mags, torch.float64, emit, st0)
    # float64 takes the plain versions by name; float32 the kernels where
    # the configuration is supervised and KL
    assert (eng.h_solver, eng.w_solver) == ("plain", "plain")
    eng32 = make_engine(config_from_jax(cfg), *bases, device="cpu",
                        emit_sources=emit)
    kl = cfg.nmf.beta == 1.0
    assert eng32.h_solver == ("kernel" if kl and case != "semisupervised"
                              else "plain")
    assert eng32.w_solver == ("kernel" if kl else "plain")
    head0 = np.asarray(bases[1])[:, :R_A]
    for lane in range(LANES):
        # the fixture must drive the adaptation: a refit changed the head
        moved = np.abs(ref_st[lane].b_d_head - head0).max()
        assert (moved > 1e-3) == adapt_on, moved
        for l in range(T):
            want, got = ref_out[lane][l], outs[l]
            if emit:
                assert got[1].shape[1] == 3 and got[2].shape[1] == 2
                for g, w in zip(got, want):
                    assert _rel(g[lane].numpy(), w) < 1e-9, (l, lane)
            else:
                assert _rel(got[lane].numpy(), want) < 1e-9, (l, lane)
        for name in EngineState._fields:
            got = getattr(st, name)[lane]
            want = np.asarray(getattr(ref_st[lane], name))
            assert got.shape == want.shape, name
            if got.dtype.kind in "biu":
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                assert _rel(got, want) < 1e-9, name
    if case == "update_period_3":
        assert cfg.adapt.update_period == 3


@pytest.mark.parametrize("case", ["mel_conv", "mel_coupled"])
def test_engine_step_f32_within_reference_envelope(case):
    """Output (every frame) and adapted head (after the last frame), the
    gaps and the envelopes each taken over the test's lanes together.  The
    DFT-mode cases are left out: there a float32 run's solve now and then
    stops one trip away from the float64 run's (the 1e-3 relative-cost
    test on a borderline frame or refit), which moves the Wiener output or
    the refitted head by ~1e-4 of the peak in one step, so the ratio of
    gap to envelope says which of the two float32 runs met such a frame
    first (0.3 to 4 over the cases and lanes), not how precise either is;
    the MMSE outputs of those cases are bit-equal to JAX float32."""
    cfg = _cfg(**CASES[case])
    bases = _bases(cfg)
    mags = _spectra(cfg)
    ref64, st64, _ = _jax_run(cfg, bases, mags, jnp.float64, False)
    ref32, st32, st0_32 = _jax_run(cfg, bases, mags, jnp.float32, False)
    _, outs, st = _port_run(cfg, bases, mags, torch.float32, False, st0_32)
    assert outs[0].dtype == torch.float32
    env = gap = henv = hgap = 0.0
    for lane in range(LANES):
        y64 = np.stack(ref64[lane])
        y32 = np.stack(ref32[lane])
        y = np.stack([o[lane].numpy() for o in outs])
        scale = np.abs(y64).max()
        env = max(env, np.abs(y32 - y64).max() / scale)
        gap = max(gap, np.abs(y - y32).max() / scale)
        h64, h32 = st64[lane].b_d_head, st32[lane].b_d_head
        hscale = np.abs(h64).max()
        henv = max(henv, np.abs(h32 - h64).max() / hscale)
        hgap = max(hgap, np.abs(st.b_d_head[lane] - h32).max() / hscale)
    assert gap <= 2 * env + 1e-6, (gap, env)
    assert hgap <= 2 * henv + 1e-6, (hgap, henv)


@pytest.mark.parametrize("max_iter", [100, 15])
def test_one_column_lanes_solve_equals_snmf_solve(max_iter):
    """With one column a lane, the per-column solver behind
    ``mu_h_solve_lanes`` on the CPU and ``snmf_solve`` (one stop per
    matrix) are the same solve: same activations, same trips, and both
    equal to the JAX ``snmf_solve`` per lane."""
    rng = np.random.default_rng(7)
    b, f, r = 5, 96, 24
    v = rng.gamma(0.8, 2.0, (b, f, 1))
    w = rng.random((b, f, r)) + 0.05
    h0 = rng.random((r, 1))
    n0 = mu.mu_h_solve_lanes.launches
    h, trips = mu.mu_h_solve_lanes(torch.as_tensor(v), torch.as_tensor(w),
                                   torch.as_tensor(h0), max_iter, 1e-3, 5.0,
                                   1e-9)
    assert mu.mu_h_solve_lanes.launches == n0        # CPU: plain version
    ones = torch.ones(r, dtype=torch.bool)
    p = dict(sparsity=5.0, max_iter=max_iter, conv_eps=1e-3)
    res = tsol.snmf_solve(torch.as_tensor(v), torch.as_tensor(w),
                          torch.as_tensor(h0), ~ones, ones,
                          tsol.SnmfParams(**p), update_w=False,
                          update_h=True, need_stats=False)
    assert _rel(h, res.h) < 1e-12
    np.testing.assert_array_equal(trips[:, 0].numpy(), res.iters.numpy())
    assert len(set(trips[:, 0].tolist())) > 1 or max_iter == 15
    for lane in range(b):
        ref = jsol.snmf_solve(
            jnp.asarray(v[lane]), jnp.asarray(w[lane]), jnp.asarray(h0),
            jnp.zeros(r, bool), jnp.ones(r, bool), jsol.SnmfParams(**p),
            update_w=False, update_h=True, need_stats=False)
        assert _rel(h[lane], ref.h) < 1e-10
        assert int(trips[lane, 0]) == int(ref.iters)


def test_engine_is_a_module_with_the_reference_entry_points():
    cfg = config_from_jax(_cfg())
    eng = make_engine(cfg, *_bases(cfg), device="cpu", dtype=torch.float64)
    assert isinstance(eng, Engine) and eng.cfg is cfg
    st = eng.init_state()
    assert st.b_d_head.shape == (cfg.signal.n_bins, R_A)
    assert st.b_d_head.dtype == torch.float64


# ---------------------------------------------------------------------------
# A frame number per lane
# ---------------------------------------------------------------------------

L0 = (1, 3, 25)      # a lane at its first frame, one inside init_n_len and
#                      below p_len_l, one past both
T_MIXED = 30


def _state_rel(got, want, lane_got=None):
    for name in EngineState._fields:
        g = np.asarray(getattr(got, name))
        g = g if lane_got is None else g[lane_got]
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert _rel(g, w) < 1e-9, name


def _mixed_setup(case):
    cfg = _cfg(**CASES[case])
    bases = _bases(cfg)
    mags = _spectra(cfg, lanes=len(L0))[:, :T_MIXED]
    eng = make_engine(config_from_jax(cfg), *bases, device="cpu",
                      dtype=torch.float64)
    return cfg, bases, mags, eng


def _port_loop(eng, mags, l0s, lanes=None):
    """The steps of ``mags[lanes]`` from the engine's initial state; ``l0s``
    a host integer or a (B,) tensor."""
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    lanes = list(range(mags.shape[0])) if lanes is None else lanes
    st = batch_state(eng.init_state(), len(lanes))
    outs = []
    with torch.no_grad():
        for i in range(mags.shape[1]):
            st, out = eng.step(st, torch.as_tensor(mags[lanes, i]), l0s + i)
            outs.append(out)
    return st, torch.stack(outs, dim=1)


@pytest.mark.parametrize("case", ["default", "wiener", "mel_conv"])
def test_engine_step_per_lane_frame_numbers(case):
    """A batch whose lanes carry different frame numbers equals the same
    lanes run alone with a host integer, and the JAX step under ``vmap``
    with a frame number per lane: every output and every state field."""
    cfg, bases, mags, eng = _mixed_setup(case)
    st, out = _port_loop(eng, mags, torch.tensor(L0))
    assert bool(torch.isfinite(out).all())
    for lane, l0 in enumerate(L0):
        st_1, out_1 = _port_loop(eng, mags, l0, lanes=[lane])
        assert _rel(out[lane], out_1[0]) < 1e-12
        _state_rel(state_to_numpy(st), state_to_numpy(
            EngineState(*(f[0] for f in st_1))), lane)
    # the lanes differ in what their clocks gate: the first frames of lanes
    # 0 and 1 are floored, lane 2's are not
    flr = cfg.signal.nonzerofloor
    assert _rel(out[0, 0], flr * mags[0, 0]) < 1e-12
    assert _rel(out[1, 0], flr * mags[1, 0]) < 1e-12
    assert float(out[2, 0].max()) > 1e3 * flr * mags[2, 0].max()
    jeng = j_make_engine(cfg, *bases, dtype=jnp.float64)
    jstep = jax.jit(jax.vmap(jeng.step))
    jst = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (len(L0),) + a.shape),
        jeng.init_state(jnp.float64))
    for i in range(T_MIXED):
        jst, jout = jstep(jst, (jnp.asarray(mags[:, i]),
                                jnp.asarray(L0, jnp.int32) + i))
        assert _rel(out[:, i].numpy(), np.asarray(jout)) < 1e-9, i
    _state_rel(state_to_numpy(st), jax.tree.map(np.asarray, jst))


@pytest.mark.parametrize("l0", [1, 12, 40])
def test_engine_step_host_integer_equals_tensor_route(l0):
    """At equal frame numbers the host-integer route and the per-lane
    tensor route give the same bits (float64): selects pick values, they
    compute none."""
    _, _, mags, eng = _mixed_setup("default")
    st_i, out_i = _port_loop(eng, mags[:, :8], l0)
    st_t, out_t = _port_loop(eng, mags[:, :8],
                             torch.full((len(L0),), l0, dtype=torch.int32))
    assert torch.equal(out_i, out_t)
    for name in EngineState._fields:
        assert torch.equal(getattr(st_i, name), getattr(st_t, name)), name


class _NoHostReads:
    """While active, converting a tensor to a host value raises."""

    NAMES = ("__bool__", "__int__", "__float__", "__index__", "item",
             "tolist", "numpy", "cpu")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(name):
            def fn(*_a, **_k):
                raise AssertionError(f"Tensor.{name} on the tensor route")
            return fn

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)


def _solver_outside(guard, fn):
    """The plain solver ``fn`` run with the guard lifted: on the card its
    place is taken by a kernel launch, which reads nothing."""
    def run(*args, **kwargs):
        guard.__exit__()
        try:
            return fn(*args, **kwargs)
        finally:
            guard.__enter__()
    return run


def test_tensor_route_reads_no_device_value_on_the_host(monkeypatch):
    """``Engine.step`` with a tensor ``l`` and ``frame_loop`` with a tensor
    ``l0`` convert no tensor to a host value outside the solvers (the
    float32 route, whose solvers are kernel launches on the card); with a
    host-read guard in place the float32 results equal the unguarded
    ones."""
    from se_snmf_nat_tpu_torch.enhance import engine as engine_mod
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = _cfg()
    bases = _bases(cfg)
    enh = SnmfEnhancer(config_from_jax(cfg), *bases, device="cpu")
    eng = enh.engine
    assert (eng.h_solver, eng.w_solver) == ("kernel", "kernel")
    mags = torch.as_tensor(_spectra(cfg, lanes=3)[:, :20],
                           dtype=torch.float32)
    l0 = torch.tensor(L0)
    with torch.no_grad():
        st0 = batch_state(eng.init_state(), 3)
        want_st, (want,) = enh.frame_loop(eng, mags, st0, [20] * 3, l0)
        guard = _NoHostReads()
        for name in ("mu_h_solve_lanes", "mu_w_solve_lanes"):
            monkeypatch.setattr(engine_mod, name, _solver_outside(
                guard, getattr(engine_mod, name)))
        with guard:
            got_st, (got,) = enh.frame_loop(eng, mags, st0, [20] * 3, l0)
            with pytest.raises(AssertionError, match="tensor route"):
                bool(l0[0] == 1)
    assert torch.equal(got, want)
    for name in EngineState._fields:
        assert torch.equal(getattr(got_st, name), getattr(want_st, name))


def test_block_step_tensor_route_reads_no_device_value_on_the_host(
        monkeypatch):
    """``BlockStep.forward`` with a (B, K) tensor of frame numbers converts
    no tensor to a host value outside its solvers either."""
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.stream import block_adaptive as ba_mod
    cfg = _cfg()
    bases = _bases(cfg)
    k = 8
    step = ba_mod.make_block_step(config_from_jax(cfg), *bases, device="cpu",
                                  k_block=k)
    mags = torch.as_tensor(_spectra(cfg, lanes=3)[:, :k],
                           dtype=torch.float32)
    ls = torch.tensor(L0)[:, None] + torch.arange(k)
    ok = torch.ones((3, k), dtype=torch.bool)
    with torch.no_grad():
        st0 = batch_state(make_engine(config_from_jax(cfg), *bases,
                                      device="cpu").init_state(), 3)
        ptr = ba_mod.ring_ptr0(3)
        want_st, want_ptr, want = step(st0, ptr, mags, ls, ok)
        guard = _NoHostReads()
        for name in ("mu_h_solve_lanes", "mu_w_solve_lanes"):
            monkeypatch.setattr(ba_mod, name, _solver_outside(
                guard, getattr(ba_mod, name)))
        with guard:
            got_st, got_ptr, got = step(st0, ptr, mags, ls, ok)
    assert torch.equal(got, want) and torch.equal(got_ptr, want_ptr)
    for name in EngineState._fields:
        assert torch.equal(getattr(got_st, name), getattr(want_st, name))


@pytest.mark.parametrize("case", ["default", "mel_conv"])
def test_exact_plan_equals_numpy_oracle(case):
    """``SnmfEnhancer.enhance`` on the exact plan (a loop over
    ``Engine.step``) against the NumPy oracle of the reference package on a
    short synthetic clip, float64: int16 identical."""
    from se_snmf_nat_tpu.oracle.runner_np import enhance_samples_oracle
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = _cfg(**CASES[case])
    bases = _bases(cfg)
    x = fixtures.noisy_utterance(40 * cfg.signal.frameshift, seed=9)
    want = enhance_samples_oracle(x, cfg, *bases)
    enh = SnmfEnhancer(config_from_jax(cfg), *bases, device="cpu",
                       dtype=torch.float64)
    assert enh.run is None and enh.fast_run is None
    got, st = enh.enhance(x, return_state=True)
    assert got.dtype == np.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (st.b_d_head - enh.initial_state().b_d_head).abs().max() > 1e-3
    # the float streams agree past the first frame length (the oracle's
    # overlap-add leaves out the floored frames before the delay, all of
    # them below half an int16 step)
    raw = enhance_samples_oracle(x, cfg, *bases, return_float=True)
    n0 = cfg.signal.framelength
    assert _rel(enh.enhance(x, quantize=False)[n0:], raw[n0:]) < 1e-9
