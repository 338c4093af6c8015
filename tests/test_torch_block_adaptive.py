"""Port parity of the block-adaptive plan: ``make_block_adaptive_run`` of
``se_snmf_nat_tpu_torch.stream.block_adaptive`` against the JAX package's
at narrow widths (r_x = r_d = 16, r_a = 8, m_a = 12, p_len_l = 4), 48
frames with padding frames past ``t_valid``, two lanes in one port call.

float64: output and every field of the returned state within 1e-9
relative to the largest entry (summation order only).  float32: the
adaptive trajectory amplifies rounding, so the port's gap to JAX float32
must stay within twice the JAX float32-to-float64 gap on the same input,
plus 1e-6."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu.enhance.state import init_engine_state as j_init
from se_snmf_nat_tpu.stream.block_adaptive import (
    make_block_adaptive_run as j_make_run)
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import (
    config_from_jax, state_from_jax, state_to_numpy)
from se_snmf_nat_tpu_torch.dsp.stft import stream_frames
from se_snmf_nat_tpu_torch.enhance.state import EngineState
from se_snmf_nat_tpu_torch.stream.block_adaptive import (
    make_block_adaptive_run as t_make_run)

torch.set_num_threads(1)
T = 48
T_VALID = (43, 37)
R_A = 8

# (k_block, plan options): per-column early stop with the FFT transform,
# and the headline's fixed-trip H-solve / capped refit / matmul transform
PLANS = {
    8: dict(iter_cap=0, refit_iter_cap=0, fixed_iter=False,
            dft_matmul=False),
    16: dict(iter_cap=22, refit_iter_cap=22, fixed_iter=True,
             dft_matmul=True),
}


def _cfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=16, r_d=16),
                      adapt=replace(cfg.adapt, r_a=R_A, m_a=12),
                      blk=replace(cfg.blk, p_len_l=4))


def _inputs(cfg):
    s = cfg.signal
    bx, bd = fixtures.synthetic_bases(s.n_bins, 16, 16, seed=3)
    frames = []
    for lane, tv in enumerate(T_VALID):
        x = fixtures.noisy_utterance((tv - 4) * s.frameshift, seed=lane + 1)
        fr = stream_frames(x, s.framelength, s.frameshift, n_flush=4)
        frames.append(np.concatenate(
            [fr, np.zeros((T - len(fr), s.framelength))]))
    return bx, bd, np.stack(frames)


def _jax_run(cfg, bx, bd, frames, k_block, dt):
    s = cfg.signal
    opts = PLANS[k_block]
    run = j_make_run(cfg, bx, bd, bx, bd, dt, k_block, opts["iter_cap"],
                     dft_matmul=opts["dft_matmul"],
                     refit_iter_cap=opts["refit_iter_cap"],
                     fixed_iter=opts["fixed_iter"])
    st0 = j_init(cfg, bd, s.n_bins, dt, True)
    win = jnp.asarray(sqrt_hann_periodic(s.framelength), dt)
    outs = []
    for lane, tv in enumerate(T_VALID):
        y, st = run(jnp.asarray(frames[lane], dt), st0, win,
                    jnp.asarray(tv, jnp.int32))
        outs.append((np.asarray(y), jax.tree.map(np.asarray, st)))
    return outs, st0


def _port_run(cfg, bx, bd, frames, k_block, dtype, st0):
    opts = PLANS[k_block]
    run = t_make_run(config_from_jax(cfg), bx, bd, bx, bd, "cpu", dtype,
                     k_block,
                     opts["iter_cap"], dft_matmul=opts["dft_matmul"],
                     refit_iter_cap=opts["refit_iter_cap"],
                     fixed_iter=opts["fixed_iter"])
    lanes = len(T_VALID)
    st = state_from_jax(jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a), (lanes,) + np.shape(a)),
        st0), device="cpu", dtype=dtype)
    with torch.no_grad():
        y, st_out = run(torch.as_tensor(frames, dtype=dtype), st,
                        torch.as_tensor(T_VALID))
    return y.numpy(), state_to_numpy(st_out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("k_block", sorted(PLANS))
def test_block_run_matches_jax_x64(k_block):
    cfg = _cfg()
    bx, bd, frames = _inputs(cfg)
    ref, st0 = _jax_run(cfg, bx, bd, frames, k_block, jnp.float64)
    # the fixture must drive the adaptation: a refit changed the head
    for _, st in ref:
        assert np.abs(st.b_d_head - bd[:, :R_A]).max() > 1e-3
    y, st = _port_run(cfg, bx, bd, frames, k_block, torch.float64, st0)
    for lane, (y_ref, st_ref) in enumerate(ref):
        assert _rel(y[lane], y_ref) < 1e-9
        for name in EngineState._fields:
            got = getattr(st, name)[lane]
            want = np.asarray(getattr(st_ref, name))
            assert got.shape == want.shape, name
            if got.dtype.kind in "biu":
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                assert _rel(got, want) < 1e-9, name


@pytest.mark.parametrize("k_block", sorted(PLANS))
def test_block_run_f32_within_reference_envelope(k_block):
    cfg = _cfg()
    bx, bd, frames = _inputs(cfg)
    ref64, st0 = _jax_run(cfg, bx, bd, frames, k_block, jnp.float64)
    ref32, st0_32 = _jax_run(cfg, bx, bd, frames, k_block, jnp.float32)
    y, st = _port_run(cfg, bx, bd, frames, k_block, torch.float32, st0_32)
    assert y.dtype == np.float32
    for lane in range(len(T_VALID)):
        y64, s64 = ref64[lane]
        y32, s32 = ref32[lane]
        scale = np.abs(y64).max()
        env = np.abs(y32 - y64).max() / scale
        gap = np.abs(y[lane] - y32).max() / scale
        assert gap <= 2 * env + 1e-6, (gap, env)
        hscale = np.abs(s64.b_d_head).max()
        henv = np.abs(s32.b_d_head - s64.b_d_head).max() / hscale
        hgap = np.abs(st.b_d_head[lane] - s32.b_d_head).max() / hscale
        assert hgap <= 2 * henv + 1e-6, (hgap, henv)


def test_block_run_rejects_unaligned_frames():
    cfg = _cfg()
    bx, bd, frames = _inputs(cfg)
    _, st0 = _jax_run(cfg, bx, bd, frames[:, :16], 16, jnp.float64)
    with pytest.raises(ValueError):
        _port_run(cfg, bx, bd, frames[:, :20], 8, torch.float64, st0)


@pytest.mark.parametrize("mode", ["mel_conv", "mel_coupled"])
def test_block_run_mel_modes_match_jax_x64(mode):
    """The Mel separation mode, with the mel->DFT conversion and with the
    coupled DFT dictionary, which used to raise: output and every state
    field against the JAX run.  (``blk_gap=1``, the other former raise, is
    held on all three plans in ``tests/test_torch_blk_sparse.py``.)"""
    cfg = _cfg()
    cfg = cfg.evolve(sep=replace(cfg.sep, b_sep_mode="Mel",
                                 mel_conv=mode == "mel_conv"))
    s = cfg.signal
    _, _, frames = _inputs(cfg)
    b1 = fixtures.synthetic_bases(s.f_order, 16, 16, seed=3)
    b2 = fixtures.synthetic_bases(s.n_bins, 16, 16, seed=3)
    k_block = 8
    run = j_make_run(cfg, *b1, *b2, jnp.float64, k_block)
    st0 = j_init(cfg, b1[1], s.n_bins, jnp.float64, True)
    win = jnp.asarray(sqrt_hann_periodic(s.framelength), jnp.float64)
    port = t_make_run(config_from_jax(cfg), *b1, *b2, "cpu", torch.float64,
                      k_block)
    lanes = len(T_VALID)
    st = state_from_jax(jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a), (lanes,) + np.shape(a)),
        st0), device="cpu", dtype=torch.float64)
    with torch.no_grad():
        y, st_out = port(torch.as_tensor(frames), st,
                         torch.as_tensor(T_VALID))
    st_out = state_to_numpy(st_out)
    for lane, tv in enumerate(T_VALID):
        y_ref, st_ref = run(jnp.asarray(frames[lane]), st0, win,
                            jnp.asarray(tv, jnp.int32))
        assert np.abs(np.asarray(st_ref.b_d_head)
                      - b1[1][:, :R_A]).max() > 1e-3
        assert _rel(y[lane].numpy(), np.asarray(y_ref)) < 1e-9
        for name in EngineState._fields:
            got = getattr(st_out, name)[lane]
            want = np.asarray(getattr(st_ref, name))
            assert got.shape == want.shape, name
            if got.dtype.kind in "biu":
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                assert _rel(got, want) < 1e-9, name


# ---------------------------------------------------------------------------
# A frame number per lane
# ---------------------------------------------------------------------------

L0 = (1, 3, 25)      # a lane at its first frame, one inside init_n_len and
#                      below p_len_l, one past both
K_MIXED = 8
N_BLOCKS = 3


def _mixed_inputs():
    from se_snmf_nat_tpu_torch.dsp.stft import analysis_frames
    from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic as win_t
    cfg = _cfg()
    s = cfg.signal
    bx, bd = fixtures.synthetic_bases(s.n_bins, 16, 16, seed=3)
    win = torch.as_tensor(win_t(s.framelength))
    mags = []
    for lane in range(len(L0)):
        x = fixtures.noisy_utterance(K_MIXED * N_BLOCKS * s.frameshift,
                                     seed=lane + 1)
        fr = stream_frames(x, s.framelength, s.frameshift, n_flush=0)
        mag, _ = analysis_frames(torch.as_tensor(fr), win, s.fftlength,
                                 s.pow, s.dc_bin, s.nonzerofloor, s.preemph)
        mags.append(mag)
    return cfg, bx, bd, torch.stack(mags)          # (3, K * N_BLOCKS, F)


def _port_blocks(step, st0, mags, ls_of_block, lanes):
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.stream.block_adaptive import (
        ring_ptr0, rings_to_shift_layout)
    st = batch_state(st0, len(lanes))
    ptr = ring_ptr0(len(lanes))
    ok = torch.ones((len(lanes), K_MIXED), dtype=torch.bool)
    outs = []
    with torch.no_grad():
        for b in range(N_BLOCKS):
            st, ptr, xm = step(
                st, ptr, mags[lanes, b * K_MIXED: (b + 1) * K_MIXED],
                ls_of_block(b), ok)
            outs.append(xm)
    return rings_to_shift_layout(st, ptr), torch.cat(outs, dim=1)


def test_block_step_per_lane_frame_numbers():
    """A batch whose lanes carry different frame numbers through
    ``BlockStep.forward`` ((B, K) tensor ``ls``) equals the same lanes run
    alone with host integers and the JAX block step under ``vmap`` with
    per-lane ``ls``: every output and every state field.  A (K,) tensor
    gives the bits of the host integers."""
    from se_snmf_nat_tpu.stream.block_adaptive import (
        make_block_step as j_make_step,
        rings_to_shift_layout as j_to_shift)
    from se_snmf_nat_tpu_torch.enhance.state import init_engine_state
    from se_snmf_nat_tpu_torch.stream.block_adaptive import make_block_step
    cfg, bx, bd, mags = _mixed_inputs()
    step = make_block_step(config_from_jax(cfg), bx, bd, device="cpu",
                           dtype=torch.float64, k_block=K_MIXED)
    assert (step.h_solver, step.w_solver) == ("plain", "plain")
    step32 = make_block_step(config_from_jax(cfg), bx, bd, device="cpu",
                             k_block=K_MIXED)
    assert (step32.h_solver, step32.w_solver) == ("kernel", "kernel")
    st0 = init_engine_state(config_from_jax(cfg), bd, cfg.signal.n_bins,
                            "cpu", torch.float64)
    k = torch.arange(K_MIXED)
    l0 = torch.tensor(L0)
    all_lanes = list(range(len(L0)))
    st, out = _port_blocks(
        step, st0, mags,
        lambda b: l0[:, None] + b * K_MIXED + k[None, :], all_lanes)
    assert bool(torch.isfinite(out).all())
    for lane, first in enumerate(L0):
        st_1, out_1 = _port_blocks(
            step, st0, mags,
            lambda b: np.arange(K_MIXED) + first + b * K_MIXED, [lane])
        assert _rel(out[lane], out_1[0]) < 1e-12
        for name in EngineState._fields:
            got, want = getattr(st, name)[lane], getattr(st_1, name)[0]
            if got.dtype.is_floating_point:
                assert _rel(got, want) < 1e-12, name
            else:
                assert torch.equal(got, want), name
        if lane == 0:
            st_t, out_t = _port_blocks(
                step, st0, mags, lambda b: k + first + b * K_MIXED, [lane])
            assert torch.equal(out_t, out_1)
            for name in EngineState._fields:
                assert torch.equal(getattr(st_t, name), getattr(st_1, name))
    # against the reference under vmap
    jstep = jax.jit(jax.vmap(j_make_step(cfg, bx, bd, bx, bd, jnp.float64,
                                         k_block=K_MIXED)))
    n = len(L0)
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape),
                       j_init(cfg, bd, cfg.signal.n_bins, jnp.float64, True))
    jptr = jnp.zeros((n,), jnp.int32)
    for b in range(N_BLOCKS):
        ls = (jnp.asarray(L0, jnp.int32)[:, None] + b * K_MIXED
              + jnp.arange(K_MIXED, dtype=jnp.int32)[None, :])
        (jst, jptr), jout = jstep(
            (jst, jptr),
            (jnp.asarray(mags[:, b * K_MIXED: (b + 1) * K_MIXED].numpy()),
             ls, jnp.ones((n, K_MIXED), bool)))
        assert _rel(out[:, b * K_MIXED: (b + 1) * K_MIXED].numpy(),
                    np.asarray(jout)) < 1e-9, b
    jst = jax.vmap(j_to_shift)(jst, jptr)
    got_st = state_to_numpy(st)
    for name in EngineState._fields:
        got, want = getattr(got_st, name), np.asarray(getattr(jst, name))
        assert got.shape == want.shape, name
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert _rel(got, want) < 1e-9, name
    # a refit moved some lane's head: the fixture drives the adaptation
    assert np.abs(got_st.b_d_head - bd[None, :, :R_A]).max() > 1e-3


# ---------------------------------------------------------------------------
# Blocks wholly past a lane's end: K1 does not solve them
# ---------------------------------------------------------------------------

# hops a lane: a lane past its end in most blocks, one in the last, one
# ending inside the first block, and the longest lane
SKIP_HOPS = (41, 9, 26, 2)


def _solve_every_lane(monkeypatch):
    """K1 made to solve every lane of every block, as before the skip: the
    block step's flag replaced by all-true."""
    from se_snmf_nat_tpu_torch.stream import block_adaptive
    real = block_adaptive.mu_h_solve_lanes

    def solve_all(*args, active, **kw):
        return real(*args, active=torch.ones_like(active), **kw)

    monkeypatch.setattr(block_adaptive, "mu_h_solve_lanes", solve_all)


def _skip_run(k_block):
    from se_snmf_nat_tpu_torch.kernels import mu
    from se_snmf_nat_tpu_torch.runtime import profiling
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = config_from_jax(_cfg())
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 16, 16, seed=0)
    opts = PLANS[k_block]
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                       block_adapt=k_block, frame_bucket=k_block,
                       block_iter_cap=opts["iter_cap"],
                       block_refit_cap=opts["refit_iter_cap"],
                       block_fixed_iter=opts["fixed_iter"],
                       dft_matmul=opts["dft_matmul"])
    s = cfg.signal
    xs = [np.rint(fixtures.noisy_utterance(n * s.frameshift + 37 * (i % 2),
                                           seed=i + 1))
          for i, n in enumerate(SKIP_HOPS)]
    before = profiling.counters()
    pcm = enh.enhance_batch(xs, micro_batch=None)
    true = [enh.frames_for(x) for x in xs]
    t_valid = [len(f) for f in true]
    t = -(-max(t_valid) // k_block) * k_block
    frames = np.stack([np.concatenate([f, np.zeros((t - len(f), f.shape[1]))])
                       for f in true])
    with torch.no_grad():
        y, st = enh.run_frames(torch.as_tensor(frames, dtype=torch.float32),
                               None, t_valid)
    after = profiling.counters()
    skipped = {k: after.get(k, 0) - before.get(k, 0) for k in mu.K1_COUNTERS}
    return pcm, y, st, skipped, bd


@pytest.mark.parametrize("k_block", sorted(PLANS))
def test_blocks_past_a_lanes_end_are_not_solved_and_change_no_bit(
        k_block, monkeypatch):
    """float32, K1 through its plain path: a batch of mixed lengths gives
    every lane's int16 output, its float output and every field of its final
    state bit for bit as the same batch with K1 made to solve every lane of
    every block, though K1 then returns another H for the blocks wholly past
    a lane's end (the masks of Q, G, the ring push and K2 select on ``ok``
    and ``any_refit``); the skipped lane-blocks are counted."""
    pcm, y, st, skipped, bd = _skip_run(k_block)
    _solve_every_lane(monkeypatch)
    pcm_all, y_all, st_all, skipped_all, _ = _skip_run(k_block)
    frames = max(SKIP_HOPS) + _cfg().delay + 1
    blocks = -(-frames // k_block)
    lane_blocks = len(SKIP_HOPS) * blocks
    # each call (enhance_batch, run_frames) offers every lane-block once
    assert skipped["k1.lanes"] == skipped_all["k1.lanes"] == 2 * lane_blocks
    assert skipped_all["k1.lanes_skipped"] == 0
    n_skip = sum(blocks - -(-(n + _cfg().delay + 1) // k_block)
                 for n in SKIP_HOPS)
    assert n_skip > 0 and skipped["k1.lanes_skipped"] == 2 * n_skip
    for a, b in zip(pcm, pcm_all):
        assert a.dtype == np.int16 and np.array_equal(a, b)
    assert torch.equal(y, y_all)
    for name in EngineState._fields:
        assert torch.equal(getattr(st, name), getattr(st_all, name)), name
    # the fixture drives the adaptation: a refit moved some lane's head
    assert (st.b_d_head - torch.as_tensor(
        bd[:, :R_A], dtype=torch.float32)).abs().max() > 1e-3
