"""The narrow schedule of K1's CUDA kernel (``csrc/mu_h_solve.cu``, N <= N*
columns a lane: the exact plan's one column a frame), through its plain twin
``mu_h_solve_lanes_narrow_twin``: F in 8 slices, each slice's rows dealt to 4
warps, the warps' and the slices' partials added in the kernel's fixed
order.  Held at small sizes (B=3, F=129, R=40; N=1 and N=N*) against the JAX
per-column solver and against the TPU kernel it replaces (``pallas_h_solve``
in Pallas interpret mode on the CPU, fixed trips).

Tolerances, on entries above 1e-6 of the largest: 1e-12 relative against
the JAX solver in float64 (summation order only), with identical trip
counts; in float32, the twin's distance to the JAX float64 solve within
twice the JAX float32 solve's own distance to it; 1e-4 against the Pallas
kernel in float32 (as tests/test_torch_kernels_mu.py holds the plain
version).  A lane solved alone gives the same bits as in its batch.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.kernels import mu

torch.set_num_threads(1)
F, R, B = 129, 40, 3
SPARSITY, FLR = 5.0, 1e-9
COLUMNS = sorted({1, mu.NARROW_MAX})


def _rel_big(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    big = np.abs(ref) > 1e-6 * np.abs(ref).max()
    return (np.abs(got - ref)[big] / np.abs(ref)[big]).max()


def _inputs(n, dtype):
    rng = np.random.default_rng(10 + n)
    v = rng.gamma(0.8, 2.0, (B, F, n)).astype(dtype)
    w = (rng.random((B, F, R)) + 0.05).astype(dtype)
    h0 = rng.random((R, n)).astype(dtype)
    return v, w, h0


def _trips(eps):
    return 22 if eps == 0.0 else 100


_CACHE = {}


def _jax_solve(n, eps, dtype):
    """The JAX per-column solver over the B lanes (computed once a case)."""
    key = ("solver", n, eps, dtype)
    if key not in _CACHE:
        import jax
        import jax.numpy as jnp
        from se_snmf_nat_tpu.nmf import solver as jsol
        v, w, h0 = _inputs(n, dtype)
        p = jsol.SnmfParams(sparsity=SPARSITY, max_iter=_trips(eps),
                            conv_eps=eps, flr=FLR)
        res = jax.vmap(lambda a, b: jsol.snmf_h_solve_columns(
            a, b, jnp.asarray(h0), p))(jnp.asarray(v), jnp.asarray(w))
        _CACHE[key] = (np.asarray(res.h), np.asarray(res.iters))
    return _CACHE[key]


def _twin(v, w, h0, eps):
    t = torch.as_tensor
    return mu.mu_h_solve_lanes_narrow_twin(t(v), t(w), t(h0), _trips(eps),
                                           eps, SPARSITY, FLR)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("n", COLUMNS)
def test_h_narrow_schedule_matches_jax(n, eps):
    t = torch.as_tensor
    # float64: the JAX solver within 1e-12, the same trips per lane, and the
    # same trips per column as the plain version
    ref_h, ref_iters = _jax_solve(n, eps, np.float64)
    v, w, h0 = _inputs(n, np.float64)
    h, trips = _twin(v, w, h0, eps)
    assert h.shape == (B, R, n) and trips.shape == (B, n)
    assert h.dtype == torch.float64
    assert _rel_big(h, ref_h) < 1e-12
    np.testing.assert_array_equal(trips.numpy().max(-1), ref_iters)
    _, trips_ref = mu.mu_h_solve_lanes_ref(t(v), t(w), t(h0), _trips(eps),
                                           eps, SPARSITY, FLR)
    assert torch.equal(trips, trips_ref)
    if eps == 0.0:
        assert np.all(trips.numpy() == 22)
    else:
        assert trips.numpy().min() < trips.numpy().max()
    # float32: within twice the JAX float32 solve's gap to float64
    h32, _ = _twin(*_inputs(n, np.float32), eps)
    assert h32.dtype == torch.float32
    gap = _rel_big(_jax_solve(n, eps, np.float32)[0], ref_h)
    assert _rel_big(h32, ref_h) <= 2.0 * gap


@pytest.mark.parametrize("n", COLUMNS)
def test_h_narrow_schedule_matches_pallas_fixed_trips(n):
    """The TPU kernel it replaces, 22 fixed trips (its one stop per lane
    differs from the per-column stop by design when eps > 0)."""
    import jax.numpy as jnp
    from se_snmf_nat_tpu.kernels.mu_pallas import pallas_h_solve
    v, w, h0 = _inputs(n, np.float32)
    ref = np.asarray(pallas_h_solve(
        jnp.asarray(v), jnp.asarray(w),
        jnp.asarray(np.broadcast_to(h0, (B,) + h0.shape)), max_iter=22,
        conv_eps=0.0, sparsity=SPARSITY, flr=FLR, interpret=True))
    h, trips = _twin(v, w, h0, 0.0)
    assert np.all(trips.numpy() == 22)
    assert _rel_big(h, ref) < 1e-4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", COLUMNS)
def test_h_narrow_lane_alone_equals_lane_in_batch(n, dtype):
    """Each lane solved alone gives the same bits as in its batch of B, as
    the kernel's one cluster a lane does whatever B."""
    v, w, h0 = _inputs(n, dtype)
    h, trips = _twin(v, w, h0, 1e-3)
    for i in range(B):
        hi, ti = _twin(v[i:i + 1], w[i:i + 1], h0, 1e-3)
        assert torch.equal(h[i:i + 1], hi) and torch.equal(trips[i:i + 1], ti)


@pytest.mark.parametrize("nf", [0, 1, 7, 8, 16, 17, 64, 65])
@pytest.mark.parametrize("nc", [1, 2, 4])
def test_h_narrow_warp_rows_cover_the_slice_once(nf, nc):
    """Each row of a slice goes to one warp: groups of 8 // nc rows round
    the warps, the rows past the last full group one at a time after them;
    at F=513 (slices of 65 and 64 rows, N=1) warp 0 takes the odd row."""
    rows = mu._narrow_warp_rows(nf, nc)
    assert len(rows) == mu.NARROW_WARPS
    assert sorted(r for part in rows for r in part) == list(range(nf))
    g = 8 // nc
    for part in rows:
        full = len(part) - len(part) % g if nf % g == 0 else None
        if full is not None:
            assert all(part[i] % g == i % g for i in range(full))
    if (nf, nc) == (65, 1) and mu.NARROW_WARPS == 4:
        assert [len(p) for p in rows] == [17, 16, 16, 16]


def test_h_narrow_tree_sum_order():
    """The warps' partials add as the kernel adds them: part i plus part
    i + W/2, then pairwise halving (checked on strings, which record the
    order of the additions)."""
    assert mu._tree_sum(list("abcd")) == "acbd"
    assert mu._tree_sum(list("abcdefgh")) == "aecgbfdh"
    parts = [f"({i})" for i in range(16)]
    assert mu._tree_sum(parts) == "".join(
        f"({i})" for i in (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7,
                           15))


def test_h_narrow_twin_refuses_wide_shapes():
    v = torch.ones((1, 8, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="1 to 4 columns"):
        mu.mu_h_solve_lanes_narrow_twin(v, torch.ones((1, 8, 3)),
                                        torch.ones((3, 5)), 5, 0.0, 5.0, 1e-9)


def test_narrow_constants_match_the_source():
    """``mu.NARROW_MAX``, ``NARROW_CLUSTER`` and ``NARROW_WARPS`` mirror
    the kernel's N* (``MU_H_NARROW_MAX``), cluster size and warps."""
    src = (Path(mu.__file__).resolve().parents[1] / "csrc"
           / "mu_h_solve.cu").read_text()
    narrow = src[src.index("namespace narrow {"):]
    assert int(re.search(r"#define MU_H_NARROW_MAX (\d+)", src).group(1)) \
        == mu.NARROW_MAX
    assert int(re.search(r"#define MU_H_NARROW_CLUSTER (\d+)", narrow)
               .group(1)) == mu.NARROW_CLUSTER
    assert "constexpr int THREADS = 1024 / C;" in narrow
    assert 32 * mu.NARROW_WARPS * mu.NARROW_CLUSTER == 1024


@pytest.mark.gpu
def test_cuda_h_narrow_matches_plain_and_twin():
    """The narrow path on the card at 1 to 4 columns a lane (F=513, 129 and
    the Mel F=64; R=200, 40 and 37; B=1, 3 and 17; cap 100 with the 1e-3
    stop and 22 fixed trips): the shape query says "narrow", the result is
    held to the plain version and to the twin (within 1e-4 of their float64
    run, or twice their float32 run's own error, on the columns whose trips
    agree with both), two launches give the same bits and so does each
    lane alone.  Runs without JAX:

        python -m pytest --noconftest -p no:cacheprovider -m gpu \\
            tests/test_torch_kernels_h_narrow.py
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    for b, f, r, n in ((1, 513, 200, 1), (17, 513, 200, 1), (3, 64, 200, 1),
                       (3, 129, 40, 2), (3, 129, 37, 3), (17, 513, 200, 4)):
        assert mu.h_solve_lanes_shape(b, f, r, n)["path"] == (
            "narrow" if n <= mu.NARROW_MAX else "wide")
        rng = np.random.default_rng(b + f + r + n)
        v = rng.gamma(0.8, 2.0, (b, f, n)).astype(np.float32)
        w = (rng.random((b, f, r)) + 0.05).astype(np.float32)
        h0 = rng.random((r, n)).astype(np.float32)
        for cap, eps in ((100, 1e-3), (22, 0.0)):
            args = (torch.as_tensor(v, device=dev),
                    torch.as_tensor(w, device=dev),
                    torch.as_tensor(h0, device=dev), cap, eps, SPARSITY, FLR)
            n0 = mu.mu_h_solve_lanes.launches
            h, trips = mu.mu_h_solve_lanes(*args)
            assert mu.mu_h_solve_lanes.launches == n0 + 1
            for plain in (mu.mu_h_solve_lanes_ref,
                          mu.mu_h_solve_lanes_narrow_twin):
                ref32, tr32 = plain(*args)
                ref64, tr64 = plain(*(a.double() if torch.is_tensor(a)
                                      else a for a in args))
                same = ((trips == tr32) & (trips == tr64)).cpu().numpy()
                assert same.mean() > 0.75
                sel = np.broadcast_to(same[:, None, :], h.shape)
                err = _rel_big(h.cpu().numpy()[sel], ref64.cpu().numpy()[sel])
                own = _rel_big(ref32.cpu().numpy()[sel],
                               ref64.cpu().numpy()[sel])
                assert err <= max(1e-4, 2.0 * own), (b, f, r, n, err, own)
            h2, trips2 = mu.mu_h_solve_lanes(*args)
            assert torch.equal(h, h2) and torch.equal(trips, trips2)
            for i in {0, b - 1}:
                hi, ti = mu.mu_h_solve_lanes(args[0][i:i + 1],
                                             args[1][i:i + 1], *args[2:])
                assert torch.equal(h[i:i + 1], hi)
                assert torch.equal(trips[i:i + 1], ti)
