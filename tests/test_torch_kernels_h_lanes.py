"""The schedule of K1's CUDA kernel (``csrc/mu_h_solve.cu``), through its
plain twin ``mu_h_solve_lanes_twin``: the columns in groups, F split over a
cluster's blocks, the partial numerators and per-column costs summed in the
kernel's fixed slice order.  Held at small sizes (F=129, R=40, groups of 16
columns, so K=37 spans three groups) against the TPU kernel it replaces
(``pallas_h_solve``, Pallas interpret mode on the CPU, fixed trips) and
against the JAX per-column solver.

Tolerances, on entries above 1e-6 of the largest: 1e-12 relative against
the JAX solver in float64 (summation order only), with identical trip
counts; 1e-4 against the Pallas kernel in float32 (as
tests/test_torch_kernels_mu.py holds the plain version); in float32, the
twin's distance to the JAX float64 solve within twice the JAX float32
solve's own distance to it.
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.kernels import mu

torch.set_num_threads(1)
F, R, B, GROUP = 129, 40, 3, 16
SPARSITY, FLR = 5.0, 1e-9


def _rel_big(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    big = np.abs(ref) > 1e-6 * np.abs(ref).max()
    return (np.abs(got - ref)[big] / np.abs(ref)[big]).max()


def _inputs(k, dtype):
    rng = np.random.default_rng(k)
    v = rng.gamma(0.8, 2.0, (B, F, k)).astype(dtype)
    w = (rng.random((B, F, R)) + 0.05).astype(dtype)
    h0 = rng.random((R, k)).astype(dtype)
    return v, w, h0


def _trips(eps):
    return 22 if eps == 0.0 else 100


_CACHE = {}


def _jax_solve(k, eps, dtype):
    """The JAX per-column solver over the B lanes (computed once a case)."""
    key = ("solver", k, eps, dtype)
    if key not in _CACHE:
        import jax
        import jax.numpy as jnp
        from se_snmf_nat_tpu.nmf import solver as jsol
        v, w, h0 = _inputs(k, dtype)
        p = jsol.SnmfParams(sparsity=SPARSITY, max_iter=_trips(eps),
                            conv_eps=eps, flr=FLR)
        res = jax.vmap(lambda a, b: jsol.snmf_h_solve_columns(
            a, b, jnp.asarray(h0), p))(jnp.asarray(v), jnp.asarray(w))
        _CACHE[key] = (np.asarray(res.h), np.asarray(res.iters))
    return _CACHE[key]


def _pallas(k):
    key = ("pallas", k)
    if key not in _CACHE:
        import jax.numpy as jnp
        from se_snmf_nat_tpu.kernels.mu_pallas import pallas_h_solve
        v, w, h0 = _inputs(k, np.float32)
        _CACHE[key] = np.asarray(pallas_h_solve(
            jnp.asarray(v), jnp.asarray(w),
            jnp.asarray(np.broadcast_to(h0, (B,) + h0.shape)), max_iter=22,
            conv_eps=0.0, sparsity=SPARSITY, flr=FLR, interpret=True))
    return _CACHE[key]


def _twin(k, eps, dtype, cluster):
    t = torch.as_tensor
    v, w, h0 = _inputs(k, dtype)
    return mu.mu_h_solve_lanes_twin(t(v), t(w), t(h0), _trips(eps), eps,
                                    SPARSITY, FLR, cluster, GROUP)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("k", [8, 37])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_h_lanes_schedule_matches_jax_and_pallas(cluster, k, eps):
    t = torch.as_tensor
    # float64: the JAX solver within 1e-12, the same trips per lane, and
    # the same trips per column as the plain version
    ref_h, ref_iters = _jax_solve(k, eps, np.float64)
    h, trips = _twin(k, eps, np.float64, cluster)
    assert h.shape == (B, R, k) and trips.shape == (B, k)
    assert h.dtype == torch.float64
    assert _rel_big(h, ref_h) < 1e-12
    np.testing.assert_array_equal(trips.numpy().max(-1), ref_iters)
    v, w, h0 = _inputs(k, np.float64)
    _, trips_ref = mu.mu_h_solve_lanes_ref(t(v), t(w), t(h0), _trips(eps),
                                           eps, SPARSITY, FLR)
    assert torch.equal(trips, trips_ref)
    if eps == 0.0:
        assert np.all(trips.numpy() == 22)
    else:
        assert trips.numpy().min() < trips.numpy().max()
    # float32: within twice the JAX float32 solve's gap to float64
    h32, _ = _twin(k, eps, np.float32, cluster)
    assert h32.dtype == torch.float32
    gap = _rel_big(_jax_solve(k, eps, np.float32)[0], ref_h)
    assert _rel_big(h32, ref_h) <= 2.0 * gap
    # the TPU kernel it replaces, fixed trips (its one stop per lane differs
    # from the per-column stop by design when eps > 0)
    if eps == 0.0:
        assert _rel_big(h32, _pallas(k)) < 1e-4


def test_h_lanes_twin_one_slice_one_group_is_the_plain_solver_order():
    """With one slice and one group the twin's sums are the plain
    solver's, term for term, so the float64 results agree to the last
    few bits."""
    t = torch.as_tensor
    v, w, h0 = _inputs(37, np.float64)
    args = (100, 1e-3, SPARSITY, FLR)
    h, trips = mu.mu_h_solve_lanes_twin(t(v), t(w), t(h0), *args, 1, 37)
    h_ref, trips_ref = mu.mu_h_solve_lanes_ref(t(v), t(w), t(h0), *args)
    assert torch.equal(trips, trips_ref)
    assert _rel_big(h, h_ref) < 1e-13


def test_h_lanes_wrapper_refuses_other_devices():
    meta = torch.empty((2, 8, 4), device="meta")
    n0 = mu.mu_h_solve_lanes.launches
    with pytest.raises(ValueError):
        mu.mu_h_solve_lanes(meta, meta, meta, 5, 0.0, SPARSITY, FLR)
    assert mu.mu_h_solve_lanes.launches == n0


ACTIVE = (True, False, True)


@pytest.mark.parametrize("h0_lanes", [False, True])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("plain", ["twin", "ref", "narrow"])
def test_h_lanes_inactive_lanes_return_h0_and_no_trips(plain, eps, h0_lanes):
    """A lane whose ``active`` flag is clear comes back unsolved, as the
    kernel's cluster returns it on either path: its h0 columns as given
    (one start shared by every lane, or its own) and 0 trips; the active
    lanes keep the bits of a call with no flag, in every column group of
    the wide schedule (K=37 spans three) and on the narrow one (K=4)."""
    t = torch.as_tensor
    k = 4 if plain == "narrow" else 37
    v, w, h0 = _inputs(k, np.float32)
    if h0_lanes:
        h0 = np.stack([h0 * (1 + i) for i in range(B)])
    if plain == "twin":
        def fn(*a, **kw):
            return mu.mu_h_solve_lanes_twin(*a, 8, GROUP, **kw)
    elif plain == "narrow":
        fn = mu.mu_h_solve_lanes_narrow_twin
    else:
        fn = mu.mu_h_solve_lanes_ref
    args = (t(v), t(w), t(h0), _trips(eps), eps, SPARSITY, FLR)
    h_all, trips_all = fn(*args)
    active = torch.tensor(ACTIVE)
    h, trips = fn(*args, active=active)
    assert torch.equal(h[active], h_all[active])
    assert torch.equal(trips[active], trips_all[active])
    assert int(trips_all[~active].min()) > 0
    assert torch.equal(h[~active], t(h0).expand(B, R, k)[~active])
    assert not bool(trips[~active].any())
    h_on, trips_on = fn(*args, active=torch.ones(B, dtype=torch.bool))
    assert torch.equal(h_on, h_all) and torch.equal(trips_on, trips_all)


def test_h_lanes_wrapper_counts_the_lanes_given_a_flag_on_the_cpu():
    """On the CPU the wrapper adds the lanes of a call given a flag, and
    those skipped, to ``k1.lanes`` and ``k1.lanes_skipped``; a call with no
    flag adds nothing."""
    from se_snmf_nat_tpu_torch.runtime import profiling
    assert mu.K1_COUNTERS == ("k1.lanes", "k1.lanes_skipped")
    t = torch.as_tensor
    v, w, h0 = _inputs(8, np.float32)
    args = (t(v), t(w), t(h0), 5, 0.0, SPARSITY, FLR)
    before = profiling.counters()
    mu.mu_h_solve_lanes(*args)
    h, trips = mu.mu_h_solve_lanes(*args, active=torch.tensor(ACTIVE))
    mu.mu_h_solve_lanes(*args, active=torch.tensor([False] * B))
    after = profiling.counters()
    got = {k: after.get(k, 0) - before.get(k, 0) for k in mu.K1_COUNTERS}
    assert got == {"k1.lanes": 2 * B, "k1.lanes_skipped": 1 + B}
    ref = mu.mu_h_solve_lanes_ref(*args, active=torch.tensor(ACTIVE))
    assert torch.equal(h, ref[0]) and torch.equal(trips, ref[1])
