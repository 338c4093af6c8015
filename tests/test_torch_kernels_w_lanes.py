"""The schedule of K2's CUDA kernel (``csrc/mu_w_solve.cu``), through its
plain twin ``mu_w_solve_lanes_twin``: F split over a cluster's blocks, the
column norms, ``corr_p``, ``1'W`` and the scalar cost summed in the kernel's
fixed slice order, each trip's stop test taken at the start of the next
trip.  Held at small sizes against the plain version
(``mu_w_solve_lanes_ref``) and against the JAX side: the TPU kernel it
replaces (``pallas_w_solve``, Pallas interpret mode on the CPU) where every
lane is active, the masked ``snmf_solve`` with its ``active`` gate
otherwise.  Inputs come from a NumPy seed; masked columns arrive zeroed.

Tolerances, on entries above 1e-6 of the largest: 1e-10 relative in float64
(summation order only) with identical trip counts, 1e-5 in float32 against
the float32 references with identical trip counts (the shapes are small and
the cap short, so float32 rounding is not yet amplified).  The ``gpu``
test holds the CUDA kernel to the twin and to the plain version on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_w_lanes.py
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.kernels import mu

torch.set_num_threads(1)
SPARSITY, FLR = 5.0, 1e-9
# (F, R, M, cluster): F not divisible by the cluster in three of them
SHAPES = [(64, 8, 12, 1), (65, 8, 12, 4), (129, 12, 20, 8), (37, 5, 9, 8),
          (66, 10, 16, 2)]


def _rel_big(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    big = np.abs(ref) > 1e-6 * np.abs(ref).max()
    return (np.abs(got - ref)[big] / np.abs(ref)[big]).max()


def _inputs(f, r, m, dtype, b=4):
    rng = np.random.default_rng(1000 * f + 10 * r + m)
    v = rng.gamma(0.8, 2.0, (b, f, m)).astype(dtype)
    mask = rng.random((b, r)) > 0.3
    w0 = ((rng.random((b, f, r)) + 0.05) * mask[:, None, :]).astype(dtype)
    h = (rng.random((b, r, m)) * mask[:, :, None]).astype(dtype)
    return v, w0, h, mask


def _jax_masked(v, w0, h, mask, active, max_iter, eps):
    import jax
    import jax.numpy as jnp
    from se_snmf_nat_tpu.nmf import solver as jsol
    p = jsol.SnmfParams(sparsity=SPARSITY, max_iter=max_iter, conv_eps=eps,
                        flr=FLR)

    def one(v, w0, h0, wm, act):
        return jsol.snmf_solve(v, w0, h0, wm, jnp.zeros_like(wm), p,
                               update_w=True, update_h=False, active=act,
                               need_stats=False)

    res = jax.vmap(one)(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h),
                        jnp.asarray(mask), jnp.asarray(active))
    return np.asarray(res.w), np.asarray(res.iters)


def _twin(v, w0, h, active, max_iter, eps, cluster):
    t = torch.as_tensor
    return mu.mu_w_solve_lanes_twin(t(v), t(w0), t(h), t(active), max_iter,
                                    eps, SPARSITY, FLR, cluster)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w_lanes_twin_matches_ref_and_masked_jax_solver(shape, eps):
    """Lane 1 inactive, ~30% of the columns masked."""
    f, r, m, cluster = shape
    active = np.array([True, False, True, True])
    t = torch.as_tensor
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 1e-5)):
        v, w0, h, mask = _inputs(f, r, m, dtype)
        w, trips = _twin(v, w0, h, active, 22, eps, cluster)
        assert w.shape == (4, f, r) and trips.shape == (4,)
        assert w.dtype == t(v).dtype and trips.dtype == torch.int32
        w_ref, trips_ref = mu.mu_w_solve_lanes_ref(
            t(v), t(w0), t(h), t(active), 22, eps, SPARSITY, FLR)
        assert torch.equal(trips, trips_ref)
        assert _rel_big(w, w_ref) < tol
        w_jax, trips_jax = _jax_masked(v, w0, h, mask, active, 22, eps)
        np.testing.assert_array_equal(trips.numpy(), trips_jax)
        assert _rel_big(w, w_jax) < tol
        assert int(trips[1]) == 0
        # masked columns stay zero; the inactive lane is its normalised w0
        assert np.all(w.numpy()[~np.broadcast_to(mask[:, None, :],
                                                 w.shape)] == 0.0)
        if eps == 0.0:
            assert trips.tolist() == [22, 0, 22, 22]
        else:
            assert 2 <= int(trips[0]) <= 22


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w_lanes_twin_matches_pallas_w_solve(shape):
    """Every lane active: the TPU kernel the CUDA kernel replaces, in
    Pallas interpret mode (float32)."""
    import jax.numpy as jnp
    from se_snmf_nat_tpu.kernels.mu_pallas import pallas_w_solve
    f, r, m, cluster = shape
    v, w0, h, _ = _inputs(f, r, m, np.float32)
    ref = pallas_w_solve(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h),
                         max_iter=22, conv_eps=1e-3, sparsity=SPARSITY,
                         flr=FLR, interpret=True)
    w, trips = _twin(v, w0, h, np.ones(4, bool), 22, 1e-3, cluster)
    assert _rel_big(w, ref) < 1e-5
    assert np.all(trips.numpy() >= 2)


def test_w_lanes_twin_lane_alone_equals_lane_in_batch():
    """No sum crosses lanes, so a lane's bits do not depend on its batch."""
    v, w0, h, _ = _inputs(65, 8, 12, np.float32)
    act = np.ones(4, bool)
    w, trips = _twin(v, w0, h, act, 22, 1e-3, 4)
    for i in range(4):
        wi, ti = _twin(v[i:i + 1], w0[i:i + 1], h[i:i + 1], act[:1], 22,
                       1e-3, 4)
        assert torch.equal(w[i:i + 1], wi) and torch.equal(trips[i:i + 1], ti)


def test_w_lanes_twin_all_inactive_runs_no_trip():
    v, w0, h, _ = _inputs(37, 5, 9, np.float64)
    w, trips = _twin(v, w0, h, np.zeros(4, bool), 22, 1e-3, 8)
    assert trips.tolist() == [0, 0, 0, 0]
    norm = np.sqrt((w0 * w0).sum(1, keepdims=True))
    np.testing.assert_allclose(w.numpy(), w0 / np.where(norm > 0, norm, 1.0),
                               rtol=1e-14)


def test_w_lanes_wrapper_refuses_other_devices():
    meta = torch.empty((2, 8, 4), device="meta")
    n0 = mu.mu_w_solve_lanes.launches
    with pytest.raises(ValueError):
        mu.mu_w_solve_lanes(meta, meta, meta, meta, 5, 0.0, SPARSITY, FLR)
    assert mu.mu_w_solve_lanes.launches == n0


@pytest.mark.gpu
def test_cuda_w_lanes_kernel_matches_twin_and_plain():
    """K2 on the card against its twin and its plain version over shapes
    with F not divisible by the cluster, masked columns and an inactive
    lane; relaunches and a lane alone give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    active = np.array([True, False, True, True])
    for f, r, m in ((129, 12, 20), (65, 8, 12), (513, 50, 100), (37, 5, 9),
                    (200, 33, 47)):
        v, w0, h, _ = _inputs(f, r, m, np.float32)
        for cap, eps in ((22, 1e-3), (22, 0.0), (1, 1e-3)):
            args = (t(v), t(w0), t(h), t(active), cap, eps, SPARSITY, FLR)
            n0 = mu.mu_w_solve_lanes.launches
            w, trips = mu.mu_w_solve_lanes(*args)
            assert mu.mu_w_solve_lanes.launches == n0 + 1
            cluster = mu.w_solve_lanes_shape(4, f, r, m)["cluster"]
            ref, trips_ref = mu.mu_w_solve_lanes_ref(*args)
            twin, trips_twin = mu.mu_w_solve_lanes_twin(*args, cluster)
            same = (trips == trips_ref) & (trips == trips_twin)
            assert same.float().mean().item() >= 0.75
            sel = same.cpu().numpy()
            ref64, _ = mu.mu_w_solve_lanes_ref(
                *(a.double() if a.is_floating_point() else a
                  for a in args[:4]), *args[4:])
            err_k = _rel_big(w.cpu().numpy()[sel], ref64.cpu().numpy()[sel])
            err_p = _rel_big(ref.cpu().numpy()[sel], ref64.cpu().numpy()[sel])
            assert err_k <= max(1e-4, 2.0 * err_p), (f, r, m, err_k, err_p)
            err_t = _rel_big(w.cpu().numpy()[sel], twin.cpu().numpy()[sel])
            # both are float32 runs of one schedule: each within ~err_p of
            # float64, so up to three times that apart
            assert err_t <= max(2e-4, 3.0 * err_p), (f, r, m, err_t, err_p)
            assert int(trips[1]) == 0
            w2, trips2 = mu.mu_w_solve_lanes(*args)
            assert torch.equal(w, w2) and torch.equal(trips, trips2)
            for i in (0, 3):
                wi, ti = mu.mu_w_solve_lanes(
                    *(a[i:i + 1] for a in args[:4]), *args[4:])
                assert torch.equal(w[i:i + 1], wi)
                assert torch.equal(trips[i:i + 1], ti)
