"""Port parity: the solvers of ``se_snmf_nat_tpu_torch.nmf.solver``
against the JAX package on the same seeded inputs.

Tolerances: float64 within 1e-10 relative to the largest entry (only
summation order differs, and MU is contractive over a few dozen trips);
float32 within 1e-5 relative, the rounding of f32 products accumulated
over the trips.  Early-stop trip counts must agree exactly.  The betas
other than KL (IS, ED, 0.5) are held in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.nmf import solver as jsol
from se_snmf_nat_tpu_torch.nmf import solver as tsol

torch.set_num_threads(1)
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _problem(seed, f=96, r=24, n=20):
    rng = np.random.default_rng(seed)
    return (rng.gamma(0.8, 2.0, (f, n)), rng.random((f, r)) + 0.05,
            rng.random((r, n)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("conv_eps,max_iter", [(0.0, 22), (1e-3, 100)])
def test_h_solve_columns_matches_jax(dtype, conv_eps, max_iter):
    v, w, h0 = _problem(0)
    jp = jsol.SnmfParams(sparsity=5.0, max_iter=max_iter, conv_eps=conv_eps)
    tp = tsol.SnmfParams(sparsity=5.0, max_iter=max_iter, conv_eps=conv_eps)
    jd = JDT[dtype]
    ref = jsol.snmf_h_solve_columns(jnp.asarray(v, jd), jnp.asarray(w, jd),
                                    jnp.asarray(h0, jd), jp)
    got = tsol.snmf_h_solve_columns(torch.as_tensor(v, dtype=dtype),
                                    torch.as_tensor(w, dtype=dtype),
                                    torch.as_tensor(h0, dtype=dtype), tp)
    assert got.h.dtype == dtype
    assert _rel(got.h, ref.h) < TOL[dtype]
    assert _rel(got.w, ref.w) < TOL[dtype]
    assert int(got.iters.max()) == int(ref.iters)
    assert _rel(got.cost, ref.cost) < TOL[dtype]
    if conv_eps > 0:      # the columns really stop at different trips
        assert int(got.iters.min()) < int(got.iters.max())


def test_h_solve_columns_lanes_match_vmap():
    """Lanes batched in one call equal the reference's vmap, per lane."""
    rng = np.random.default_rng(1)
    v = rng.gamma(0.8, 2.0, (3, 64, 10))
    w = rng.random((3, 64, 12)) + 0.05
    h0 = rng.random((12, 10))
    p = dict(sparsity=5.0, max_iter=60, conv_eps=1e-3)
    ref = jax.vmap(lambda a, b: jsol.snmf_h_solve_columns(
        a, b, jnp.asarray(h0), jsol.SnmfParams(**p)))(jnp.asarray(v),
                                                      jnp.asarray(w))
    got = tsol.snmf_h_solve_columns(torch.as_tensor(v), torch.as_tensor(w),
                                    torch.as_tensor(h0),
                                    tsol.SnmfParams(**p))
    assert _rel(got.h, ref.h) < 1e-10
    np.testing.assert_array_equal(got.iters.amax(-1).numpy(),
                                  np.asarray(ref.iters))


def _masked_w_problem(seed, lanes=3, f=80, r=10, m=16):
    rng = np.random.default_rng(seed)
    v = rng.gamma(0.8, 2.0, (lanes, f, m))
    mask = rng.random((lanes, r)) > 0.3
    w0 = (rng.random((lanes, f, r)) + 0.05) * mask[:, None, :]
    h0 = rng.random((lanes, r, m)) * mask[:, :, None]
    return v, w0, h0, mask


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_w_only_masked_solve_matches_jax(dtype):
    """The refit's W-only masked solve, one lane inactive (zero trips)."""
    v, w0, h0, mask = _masked_w_problem(2)
    active = np.array([True, False, True])
    jd = JDT[dtype]
    jp = jsol.SnmfParams(sparsity=5.0, max_iter=22, conv_eps=1e-3)

    def one(v, w0, h0, wm, act):
        return jsol.snmf_solve(v, w0, h0, wm, jnp.zeros_like(wm), jp,
                               update_w=True, update_h=False, active=act,
                               need_stats=False)

    ref = jax.vmap(one)(jnp.asarray(v, jd), jnp.asarray(w0, jd),
                        jnp.asarray(h0, jd), jnp.asarray(mask),
                        jnp.asarray(active))
    t = lambda a: torch.as_tensor(a, dtype=dtype)   # noqa: E731
    got = tsol.snmf_solve(
        t(v), t(w0), t(h0), torch.as_tensor(mask),
        torch.zeros(mask.shape, dtype=torch.bool),
        tsol.SnmfParams(sparsity=5.0, max_iter=22, conv_eps=1e-3),
        update_w=True, update_h=False, active=torch.as_tensor(active),
        need_stats=False)
    assert _rel(got.w, ref.w) < TOL[dtype]
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    assert int(got.iters[1]) == 0
    # masked columns stay exactly zero
    assert np.all(got.w.numpy()[~mask[:, None, :].repeat(80, 1)] == 0.0)


@pytest.mark.parametrize("conv_eps", [0.0, 1e-4])
def test_full_solve_matches_jax(conv_eps):
    """W and H both updating, with masks, float64, with the final stats."""
    rng = np.random.default_rng(3)
    v = rng.gamma(0.8, 2.0, (60, 30))
    w0 = rng.random((60, 8)) + 0.05
    h0 = rng.random((8, 30))
    wm = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    hm = np.array([1, 0, 1, 1, 1, 1, 1, 1], bool)
    jp = jsol.SnmfParams(sparsity=2.0, max_iter=40, conv_eps=conv_eps)
    ref = jsol.snmf_solve(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
                          jnp.asarray(wm), jnp.asarray(hm), jp)
    got = tsol.snmf_solve(
        torch.as_tensor(v), torch.as_tensor(w0), torch.as_tensor(h0),
        torch.as_tensor(wm), torch.as_tensor(hm),
        tsol.SnmfParams(sparsity=2.0, max_iter=40, conv_eps=conv_eps))
    for name in ("w", "h", "div", "cost"):
        assert _rel(getattr(got, name), getattr(ref, name)) < 1e-10, name
    assert int(got.iters) == int(ref.iters)


def test_normalize_columns_keeps_zero_columns():
    w = np.random.default_rng(4).random((5, 4))
    w[:, 2] = 0.0
    got, wn = tsol.normalize_columns(torch.as_tensor(w))
    ref, rwn = jsol.normalize_columns(jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-15)
    np.testing.assert_allclose(wn.numpy(), np.asarray(rwn), rtol=1e-15)
    assert np.all(got.numpy()[:, 2] == 0.0)


@pytest.mark.parametrize("beta", [0.0, 2.0, 0.5])
def test_non_kl_betas_h_solve_columns_matches_jax(beta):
    """IS, ED and a general beta in the per-column H-solve, float64."""
    v, w, h0 = _problem(5)
    p = dict(beta=beta, sparsity=0.5, max_iter=60, conv_eps=1e-3)
    ref = jsol.snmf_h_solve_columns(jnp.asarray(v), jnp.asarray(w),
                                    jnp.asarray(h0), jsol.SnmfParams(**p))
    got = tsol.snmf_h_solve_columns(torch.as_tensor(v), torch.as_tensor(w),
                                    torch.as_tensor(h0),
                                    tsol.SnmfParams(**p))
    assert _rel(got.h, ref.h) < 1e-10
    assert int(got.iters.max()) == int(ref.iters)
    assert _rel(got.div, ref.div) < 1e-10
    assert _rel(got.cost, ref.cost) < 1e-10


@pytest.mark.parametrize("update_w,update_h", [(True, True), (False, True),
                                               (True, False)])
@pytest.mark.parametrize("beta", [0.0, 2.0, 0.5])
def test_non_kl_betas_solve_matches_jax(beta, update_w, update_h):
    """IS, ED and a general beta in ``snmf_solve`` with masks, float64: W
    and H both updating, H only (the engine's activation solve) and W only
    (the refit)."""
    rng = np.random.default_rng(6)
    v = rng.gamma(0.8, 2.0, (60, 30)) + 0.05
    w0 = rng.random((60, 8)) + 0.05
    h0 = rng.random((8, 30)) + 0.05
    wm = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    hm = np.array([1, 0, 1, 1, 1, 1, 1, 1], bool)
    p = dict(beta=beta, sparsity=0.5, max_iter=40, conv_eps=1e-4)
    ref = jsol.snmf_solve(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
                          jnp.asarray(wm), jnp.asarray(hm),
                          jsol.SnmfParams(**p), update_w=update_w,
                          update_h=update_h)
    got = tsol.snmf_solve(
        torch.as_tensor(v), torch.as_tensor(w0), torch.as_tensor(h0),
        torch.as_tensor(wm), torch.as_tensor(hm), tsol.SnmfParams(**p),
        update_w=update_w, update_h=update_h)
    for name in ("w", "h", "div", "cost"):
        assert _rel(getattr(got, name), getattr(ref, name)) < 1e-10, name
    assert int(got.iters) == int(ref.iters)
    assert int(got.iters) > 1


@pytest.mark.parametrize("update_w,update_h", [(True, True), (False, True)])
@pytest.mark.parametrize("conv_eps,max_iter", [(0.0, 12), (1e-3, 200)])
def test_solve_traced_matches_jax_and_snmf_solve(conv_eps, max_iter,
                                                 update_w, update_h):
    """``snmf_solve_traced``: the per-trip div and cost histories within
    1e-9 of the JAX package's (zeros past the trips run, trip counts
    equal), and the final factors those of ``snmf_solve`` bit for bit."""
    v, w0, h0 = _problem(7, f=64, r=10, n=30)
    r = w0.shape[1]
    p = dict(sparsity=5.0, max_iter=max_iter, conv_eps=conv_eps)
    ref, ref_hist = jsol.snmf_solve_traced(
        jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
        jnp.ones(r, bool), jnp.ones(r, bool), jsol.SnmfParams(**p),
        update_w=update_w, update_h=update_h)
    args = (torch.as_tensor(v), torch.as_tensor(w0), torch.as_tensor(h0),
            torch.ones(r, dtype=torch.bool), torch.ones(r, dtype=torch.bool),
            tsol.SnmfParams(**p))
    got, hist = tsol.snmf_solve_traced(*args, update_w=update_w,
                                       update_h=update_h)
    plain = tsol.snmf_solve(*args, update_w=update_w, update_h=update_h)
    n_run = int(got.iters)
    assert n_run == int(ref.iters) == int(plain.iters)
    if conv_eps > 0:
        assert 1 < n_run < max_iter
    for key in ("div", "cost"):
        assert hist[key].shape == (max_iter,)
        assert _rel(hist[key], ref_hist[key]) < 1e-9, key
        assert bool((hist[key][n_run:] == 0).all())
        assert bool((hist[key][:n_run] > 0).all())
    for name in ("w", "h", "div", "cost"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
        assert _rel(getattr(got, name), getattr(ref, name)) < 1e-9, name
    if conv_eps > 0:      # the result's cost is the last trip's
        assert float(hist["cost"][n_run - 1]) == float(got.cost)


def test_solve_traced_lanes_stop_on_their_own():
    """Lanes in one call: each lane's history is the one it has alone."""
    rng = np.random.default_rng(8)
    v = rng.gamma(0.8, 2.0, (3, 48, 20)) + 0.05
    w0 = rng.random((3, 48, 6)) + 0.05
    h0 = rng.random((3, 6, 20))
    m = torch.ones(6, dtype=torch.bool)
    p = tsol.SnmfParams(sparsity=1.0, max_iter=150, conv_eps=1e-3)
    got, hist = tsol.snmf_solve_traced(torch.as_tensor(v),
                                       torch.as_tensor(w0),
                                       torch.as_tensor(h0), m, m, p)
    assert len(set(got.iters.tolist())) > 1
    for b in range(3):
        one, one_hist = tsol.snmf_solve_traced(
            torch.as_tensor(v[b]), torch.as_tensor(w0[b]),
            torch.as_tensor(h0[b]), m, m, p)
        assert int(one.iters) == int(got.iters[b])
        assert _rel(hist["cost"][b], one_hist["cost"]) < 1e-12
        assert _rel(got.w[b], one.w) < 1e-12
