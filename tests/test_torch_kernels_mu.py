"""The MU-solve kernels' plain versions against the TPU kernels they
replace, run in Pallas interpret mode on the CPU, and against the solvers
(all float32, small F).  Tolerance 1e-4 relative on entries above 1e-6 of
the largest (as tests/test_nmf.py holds the Pallas column kernel): the
kernels and the solvers sum their products in different orders.

The wrappers take the plain versions for CPU tensors; the test marked
``gpu`` holds each CUDA kernel to its plain version on the card.  The JAX
package is imported inside the tests that use it, so that the ``gpu`` test
also runs on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_mu.py
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.kernels import mu

torch.set_num_threads(1)
RTOL = 1e-4


def _rel_big(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    big = np.abs(ref) > 1e-6 * np.abs(ref).max()
    return (np.abs(got - ref)[big] / np.abs(ref)[big]).max()


def _h_inputs(seed, b=3, f=64, r=16, n=12):
    rng = np.random.default_rng(seed)
    v = (rng.gamma(0.8, 2.0, (b, f, n))).astype(np.float32)
    w = (rng.random((b, f, r)) + 0.05).astype(np.float32)
    h0 = rng.random((r, n)).astype(np.float32)
    return v, w, h0


def _w_inputs(seed, b=4, f=64, r=8, m=12):
    rng = np.random.default_rng(seed)
    v = rng.gamma(0.8, 2.0, (b, f, m)).astype(np.float32)
    mask = rng.random((b, r)) > 0.3
    w0 = ((rng.random((b, f, r)) + 0.05) * mask[:, None, :]).astype(
        np.float32)
    h = (rng.random((b, r, m)) * mask[:, :, None]).astype(np.float32)
    return v, w0, h, mask


def test_h_ref_matches_pallas_h_solve_fixed():
    """conv_eps=0: fixed trips, the block plan's H-solve."""
    import jax.numpy as jnp
    from se_snmf_nat_tpu.kernels.mu_pallas import pallas_h_solve
    v, w, h0 = _h_inputs(0)
    b = v.shape[0]
    ref = pallas_h_solve(jnp.asarray(v), jnp.asarray(w),
                         jnp.asarray(np.broadcast_to(h0, (b,) + h0.shape)),
                         max_iter=22, conv_eps=0.0, sparsity=5.0, flr=1e-9,
                         interpret=True)
    h, trips = mu.mu_h_solve_lanes_ref(
        torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(h0), 22,
        0.0, 5.0, 1e-9)
    assert _rel_big(h, ref) < RTOL
    assert np.all(trips.numpy() == 22)


def test_h_ref_matches_vmapped_column_solver_with_early_stop():
    """conv_eps>0: every column stops at its own relative-cost test (the
    per-column semantics; the Pallas kernel's single per-matrix stop
    differs there by design)."""
    import jax
    import jax.numpy as jnp
    from se_snmf_nat_tpu.nmf import solver as jsol
    v, w, h0 = _h_inputs(1)
    p = jsol.SnmfParams(sparsity=5.0, max_iter=100, conv_eps=1e-3)
    ref = jax.vmap(lambda a, b: jsol.snmf_h_solve_columns(
        a, b, jnp.asarray(h0), p))(jnp.asarray(v), jnp.asarray(w))
    h, trips = mu.mu_h_solve_lanes_ref(
        torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(h0), 100,
        1e-3, 5.0, 1e-9)
    assert _rel_big(h, ref.h) < RTOL
    np.testing.assert_array_equal(trips.numpy().max(-1),
                                  np.asarray(ref.iters))
    assert trips.numpy().min() < trips.numpy().max()


def test_w_ref_matches_pallas_w_solve():
    """Masked columns zeroed in w0 and in the rows of h, every lane
    active."""
    import jax.numpy as jnp
    from se_snmf_nat_tpu.kernels.mu_pallas import pallas_w_solve
    v, w0, h, _ = _w_inputs(2)
    ref = pallas_w_solve(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h),
                         max_iter=22, conv_eps=1e-3, sparsity=5.0, flr=1e-9,
                         interpret=True)
    w, trips = mu.mu_w_solve_lanes_ref(
        torch.as_tensor(v), torch.as_tensor(w0), torch.as_tensor(h),
        torch.ones(v.shape[0], dtype=torch.bool), 22, 1e-3, 5.0, 1e-9)
    assert _rel_big(w, ref) < RTOL
    assert np.all(trips.numpy() >= 2)


def test_w_ref_matches_masked_solver_with_inactive_lane():
    import jax
    import jax.numpy as jnp
    from se_snmf_nat_tpu.nmf import solver as jsol
    v, w0, h, mask = _w_inputs(3)
    active = np.array([True, False, True, True])
    p = jsol.SnmfParams(sparsity=5.0, max_iter=22, conv_eps=1e-3)

    def one(v, w0, h0, wm, act):
        return jsol.snmf_solve(v, w0, h0, wm, jnp.zeros_like(wm), p,
                               update_w=True, update_h=False, active=act,
                               need_stats=False)

    ref = jax.vmap(one)(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h),
                        jnp.asarray(mask), jnp.asarray(active))
    w, trips = mu.mu_w_solve_lanes_ref(
        torch.as_tensor(v), torch.as_tensor(w0), torch.as_tensor(h),
        torch.as_tensor(active), 22, 1e-3, 5.0, 1e-9)
    assert _rel_big(w, ref.w) < RTOL
    np.testing.assert_array_equal(trips.numpy(), np.asarray(ref.iters))
    assert int(trips[1]) == 0


def test_wrappers_take_plain_versions_on_cpu_only():
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    v, w, h0 = _h_inputs(4)
    n_h, n_w = mu.mu_h_solve_lanes.launches, mu.mu_w_solve_lanes.launches
    args = (torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(h0),
            10, 1e-3, 5.0, 1e-9)
    for a, b in zip(mu.mu_h_solve_lanes(*args),
                    mu.mu_h_solve_lanes_ref(*args)):
        assert torch.equal(a, b)
    vw, w0, h, _ = _w_inputs(5)
    wargs = (torch.as_tensor(vw), torch.as_tensor(w0), torch.as_tensor(h),
             torch.ones(vw.shape[0], dtype=torch.bool), 10, 1e-3, 5.0, 1e-9)
    for a, b in zip(mu.mu_w_solve_lanes(*wargs),
                    mu.mu_w_solve_lanes_ref(*wargs)):
        assert torch.equal(a, b)
    assert (mu.mu_h_solve_lanes.launches, mu.mu_w_solve_lanes.launches) \
        == (n_h, n_w)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 8, 4), device="meta")
    with pytest.raises(ValueError):
        mu.mu_h_solve_lanes(meta, meta, meta, 5, 0.0, 5.0, 1e-9)
    with pytest.raises(ValueError):
        mu.mu_w_solve_lanes(meta, meta, meta, meta, 5, 0.0, 5.0, 1e-9)


def _hold_to_plain(got, trips, plain_fn, args, sel_fn):
    """Within RTOL of the plain version run in float64, or within twice the
    float32 plain version's own error where float32 is further off (the
    W-solve's trips amplify f32 rounding on small entries); columns or
    lanes whose trip counts differ are left out."""
    ref32, tr32 = plain_fn(*args)
    ref64, tr64 = plain_fn(*(a.double() if torch.is_tensor(a)
                             and a.is_floating_point() else a for a in args))
    torch.cuda.synchronize()
    same = ((trips == tr32) & (trips == tr64)).cpu().numpy()
    assert same.mean() > 0.75
    sel = sel_fn(same, got.shape)
    err_k = _rel_big(got.cpu().numpy()[sel], ref64.cpu().numpy()[sel])
    err_p = _rel_big(ref32.cpu().numpy()[sel], ref64.cpu().numpy()[sel])
    assert err_k <= max(RTOL, 2.0 * err_p), (err_k, err_p)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card, at small
    shapes with an inactive lane and masked columns.  K1 at B=1 and 3, K=37,
    88 and 200 columns (200 spans three column groups), R=40 and 200, and
    the block plan's largest shape (F=513, R=400: four groups of 25 at
    K=100); two launches on the same inputs give the same bits, and so does
    a lane solved alone and in a batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    cols = lambda same, shape: np.broadcast_to(    # noqa: E731
        same[:, None, :], shape)
    shapes = [(b, 129, r, k) for b in (1, 3) for k in (37, 88, 200)
              for r in (40, 200)] + [(1, 513, 400, 100)]
    for b, f, r, k in shapes:
        v, w, h0 = _h_inputs(6, b=b, f=f, r=r, n=k)
        for max_iter, eps in ((22, 0.0), (100, 1e-3)):
            args = (t(v), t(w), t(h0), max_iter, eps, 5.0, 1e-9)
            n0 = mu.mu_h_solve_lanes.launches
            h, trips = mu.mu_h_solve_lanes(*args)
            assert mu.mu_h_solve_lanes.launches == n0 + 1
            _hold_to_plain(h, trips, mu.mu_h_solve_lanes_ref, args, cols)
            h2, trips2 = mu.mu_h_solve_lanes(*args)
            assert torch.equal(h, h2) and torch.equal(trips, trips2)
    # a lane gives the same bits alone as in a batch whose last lanes the
    # wave tail cuts into narrower column groups
    v, w, h0 = _h_inputs(8, b=17, f=513, r=200, n=88)
    for max_iter, eps in ((22, 0.0), (100, 1e-3)):
        h, trips = mu.mu_h_solve_lanes(t(v), t(w), t(h0), max_iter, eps, 5.0,
                                       1e-9)
        for i in (0, 16):
            hi, ti = mu.mu_h_solve_lanes(t(v[i:i + 1]), t(w[i:i + 1]), t(h0),
                                         max_iter, eps, 5.0, 1e-9)
            assert torch.equal(h[i:i + 1], hi) and torch.equal(trips[i:i + 1],
                                                               ti)
    vw, w0, hh, _ = _w_inputs(7, b=4, f=129, r=12, m=20)
    act = torch.tensor([True, False, True, True], device=dev)
    args = (t(vw), t(w0), t(hh), act, 22, 1e-3, 5.0, 1e-9)
    wk, tk = mu.mu_w_solve_lanes(*args)
    lanes = lambda same, shape: np.broadcast_to(   # noqa: E731
        same[:, None, None], shape)
    _hold_to_plain(wk, tk, mu.mu_w_solve_lanes_ref, args, lanes)
    assert int(tk[1]) == 0


@pytest.mark.gpu
def test_cuda_h_lanes_one_column_matches_plain_version():
    """K1 at the exact plan's shape, one column a lane (F=513 and the Mel
    F=64, R=200, cap 100 and 15, eps 1e-3) at B=1, 16 and 17, on the narrow
    path: held to the plain version with the trip counts compared, two
    launches the same bits, and each lane alone the same bits as in its
    batch; the same lanes at 88 columns (the wide path) held to the plain
    version too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    cols = lambda same, shape: np.broadcast_to(    # noqa: E731
        same[:, None, :], shape)
    for b, f, cap in ((1, 513, 100), (16, 513, 100), (17, 513, 15),
                      (16, 64, 100)):
        v, w, h0 = _h_inputs(9, b=b, f=f, r=200, n=88)
        v1, h01 = np.ascontiguousarray(v[:, :, :1]), h0[:, :1].copy()
        args = (t(v1), t(w), t(h01), cap, 1e-3, 5.0, 1e-9)
        n0 = mu.mu_h_solve_lanes.launches
        h, trips = mu.mu_h_solve_lanes(*args)
        assert mu.mu_h_solve_lanes.launches == n0 + 1
        assert h.shape == (b, 200, 1) and trips.shape == (b, 1)
        _hold_to_plain(h, trips, mu.mu_h_solve_lanes_ref, args, cols)
        h2, trips2 = mu.mu_h_solve_lanes(*args)
        assert torch.equal(h, h2) and torch.equal(trips, trips2)
        assert mu.h_solve_lanes_shape(b, f, 200, 1)["path"] == "narrow"
        for i in {0, b - 1}:
            hi, ti = mu.mu_h_solve_lanes(t(v1[i:i + 1]), t(w[i:i + 1]),
                                         t(h01), cap, 1e-3, 5.0, 1e-9)
            assert torch.equal(h[i:i + 1], hi) and torch.equal(trips[i:i + 1],
                                                               ti)
        args88 = (t(v), t(w), t(h0), cap, 1e-3, 5.0, 1e-9)
        assert mu.h_solve_lanes_shape(b, f, 200, 88)["path"] == "wide"
        h88, trips88 = mu.mu_h_solve_lanes(*args88)
        _hold_to_plain(h88, trips88, mu.mu_h_solve_lanes_ref, args88, cols)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["exact", "block", "fast"])
def test_float64_on_the_card_takes_the_plain_versions(plan):
    """``dtype=torch.float64`` on the card: each plan chooses the plain
    solvers when it is built (the kernels are float32 only and their
    wrappers go on refusing float64), launches no kernel, and agrees with
    the port's float64 CPU run within 1e-9 relative, int16 identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (float64 on the card against the CPU)")
    from dataclasses import replace

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = preset("snmf") if plan == "fast" else default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                     adapt=replace(cfg.adapt, r_a=4, m_a=10),
                     nmf=replace(cfg.nmf, max_iter=6))
    bx, bd = fixtures.synthetic_bases(cfg.signal.n_bins, 8, 8, seed=0)
    kw = dict(dtype=torch.float64, block_adapt=8 if plan == "block" else 0)
    card = SnmfEnhancer(cfg, bx, bd, bx, bd, **kw)
    cpu = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu", **kw)
    solvers = {"exact": (card.engine.h_solver, card.engine.w_solver),
               "block": (card.run.step.h_solver, card.run.step.w_solver)
               if plan == "block" else None,
               "fast": (card.fast_run.h_solver,) if plan == "fast" else None}
    assert set(solvers[plan]) == {"plain"}
    x = fixtures.noisy_utterance(4800, seed=1)
    n0 = (mu.mu_h_solve_lanes.launches, mu.mu_w_solve_lanes.launches,
          mu.mu_h_solve_columns.launches)
    got, want = card.enhance(x, quantize=False), cpu.enhance(x,
                                                             quantize=False)
    assert n0 == (mu.mu_h_solve_lanes.launches, mu.mu_w_solve_lanes.launches,
                  mu.mu_h_solve_columns.launches)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    np.testing.assert_array_equal(card.enhance(x), cpu.enhance(x))
    v = torch.ones((1, 8, 1), dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        mu.mu_h_solve_lanes(v, v.expand(1, 8, 8).contiguous(), v[0], 5, 0.0,
                            5.0, 1e-9)
