"""Port parity: the KL solvers of ``se_snmf_nat_tpu_torch.nmf.solver``
against the JAX package on the same seeded inputs.

Tolerances: float64 within 1e-10 relative to the largest entry (only
summation order differs, and MU is contractive over a few dozen trips);
float32 within 1e-5 relative, the rounding of f32 products accumulated
over the trips.  Early-stop trip counts must agree exactly."""

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
def test_non_kl_betas_raise(beta):
    v, w, h0 = _problem(5)
    t = lambda a: torch.as_tensor(a)   # noqa: E731
    with pytest.raises(NotImplementedError):
        tsol.snmf_h_solve_columns(t(v), t(w), t(h0),
                                  tsol.SnmfParams(beta=beta))
    with pytest.raises(NotImplementedError):
        tsol.snmf_solve(t(v), t(w), t(h0), torch.ones(24, dtype=torch.bool),
                        torch.ones(24, dtype=torch.bool),
                        tsol.SnmfParams(beta=beta))
