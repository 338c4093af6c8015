"""The shared-dictionary per-column H-solve kernel (K3, ``csrc/mu_h_cols.cu``)
through its plain version, against the TPU kernel it replaces run in Pallas
interpret mode on the CPU (float32, full-precision products:
``bf16_mxu=False``, as tests/test_nmf.py runs it) and against the JAX
per-column solver in float64.

Tolerances: 1e-4 relative on entries above 1e-6 of the largest against the
Pallas kernel (products summed in another order, in float32); 1e-10 against
the float64 solver (summation order only).

The test marked ``gpu`` holds the CUDA kernel to its plain version on the
card, with the frame-major strided input the fast plan hands it.  The JAX
package is imported inside the tests that use it, so that the ``gpu`` test
also runs on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_h_cols.py
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.kernels import mu

torch.set_num_threads(1)
RTOL = 1e-4
F, R, N = 129, 40, 70          # N is not a multiple of the Pallas tile (32)


def _rel_big(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    big = np.abs(ref) > 1e-6 * np.abs(ref).max()
    return (np.abs(got - ref)[big] / np.abs(ref)[big]).max()


def _inputs(seed, f=F, r=R, n=N, dtype=np.float32):
    rng = np.random.default_rng(seed)
    v = rng.gamma(2.0, 50.0, (f, n)).astype(dtype)
    w = (np.abs(rng.standard_normal((f, r))) + 0.1).astype(dtype)
    h0 = rng.random((r, 1)).astype(dtype)        # one shared start column
    return v, w, h0


@pytest.mark.parametrize("max_iter,eps", [(60, 1e-3), (22, 0.0)])
def test_h_cols_ref_matches_pallas_h_solve_columns(max_iter, eps):
    import jax.numpy as jnp
    from se_snmf_nat_tpu.kernels.mu_pallas import pallas_h_solve_columns
    v, w, h0 = _inputs(0)
    ref = pallas_h_solve_columns(
        jnp.asarray(v), jnp.asarray(w),
        jnp.asarray(np.broadcast_to(h0, (R, N))), max_iter=max_iter,
        conv_eps=eps, sparsity=5.0, flr=1e-9, tile_n=32, bf16_mxu=False,
        interpret=True)
    h, trips = mu.mu_h_solve_columns_ref(
        torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(h0),
        max_iter, eps, 5.0, 1e-9)
    assert h.shape == (R, N) and trips.shape == (N,)
    assert _rel_big(h, ref) < RTOL
    trips = trips.numpy()
    if eps > 0:
        assert trips.min() < trips.max() <= max_iter
    else:
        assert np.all(trips == max_iter)


def test_h_cols_ref_matches_jax_solver_x64():
    import jax.numpy as jnp
    from se_snmf_nat_tpu.nmf import solver as jsol
    v, w, h0 = _inputs(1, dtype=np.float64)
    p = jsol.SnmfParams(sparsity=5.0, max_iter=100, conv_eps=1e-3)
    ref = jsol.snmf_h_solve_columns(
        jnp.asarray(v), jnp.asarray(w),
        jnp.broadcast_to(jnp.asarray(h0), (R, N)), p)
    h, trips = mu.mu_h_solve_columns_ref(
        torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(h0), 100,
        1e-3, 5.0, 1e-9)
    assert h.dtype == torch.float64
    assert _rel_big(h, ref.h) < 1e-10
    assert int(trips.max()) == int(ref.iters)


def test_h_cols_broadcast_start_column_is_bit_equal():
    """One (R, 1) start column broadcast over N equals the (R, N) copy."""
    v, w, h0 = _inputs(2)
    args = (100, 1e-3, 5.0, 1e-9)
    t = torch.as_tensor
    h1, tr1 = mu.mu_h_solve_columns_ref(t(v), t(w), t(h0), *args)
    hn, trn = mu.mu_h_solve_columns_ref(
        t(v), t(w), t(np.ascontiguousarray(np.broadcast_to(h0, (R, N)))),
        *args)
    assert torch.equal(h1, hn) and torch.equal(tr1, trn)


def test_h_cols_frame_major_view_equals_contiguous():
    """The fast plan's (F, N) view of frame-major (N, F) spectra gives the
    same values as the contiguous (F, N) matrix (fixed trips, so that
    rounding cannot move a column's stop)."""
    v, w, h0 = _inputs(3)
    t = torch.as_tensor
    args = (t(w), t(h0), 40, 0.0, 5.0, 1e-9)
    h_c, tr_c = mu.mu_h_solve_columns(t(v), *args)
    h_v, tr_v = mu.mu_h_solve_columns(t(np.ascontiguousarray(v.T)).T, *args)
    torch.testing.assert_close(h_v, h_c, rtol=1e-6, atol=0.0)
    assert torch.equal(tr_v, tr_c)


def test_h_cols_wrapper_takes_plain_version_on_cpu_only():
    v, w, h0 = _inputs(4)
    n0 = mu.mu_h_solve_columns.launches
    args = (torch.as_tensor(v), torch.as_tensor(w), torch.as_tensor(h0), 10,
            1e-3, 5.0, 1e-9)
    for a, b in zip(mu.mu_h_solve_columns(*args),
                    mu.mu_h_solve_columns_ref(*args)):
        assert torch.equal(a, b)
    assert mu.mu_h_solve_columns.launches == n0
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        mu.mu_h_solve_columns(meta, meta, meta, 5, 0.0, 5.0, 1e-9)


def _hold_cols_to_plain(args, h, trips):
    ref32, tr32 = mu.mu_h_solve_columns_ref(*args)
    ref64, tr64 = mu.mu_h_solve_columns_ref(
        *(a.double() for a in args[:3]), *args[3:])
    torch.cuda.synchronize()
    same = ((trips == tr32) & (trips == tr64)).cpu().numpy()
    assert same.mean() > 0.75
    sel = np.broadcast_to(same[None, :], h.shape)
    err_k = _rel_big(h.cpu().numpy()[sel], ref64.cpu().numpy()[sel])
    err_p = _rel_big(ref32.cpu().numpy()[sel], ref64.cpu().numpy()[sel])
    assert err_k <= max(RTOL, 2.0 * err_p), (err_k, err_p)


def _same_bits_among_other_columns(vv, args, h, trips):
    """A column solved among fewer columns, or with the columns permuted,
    gives the bits and trips it has among all: its result depends on
    neither its tile (or slot) nor its neighbours."""
    n = vv.shape[1]
    k = n // 3
    hk, tk = mu.mu_h_solve_columns(vv[:, :k], *args[1:])
    assert torch.equal(h[:, :k], hk)
    assert torch.equal(trips[:k], tk)
    perm = torch.as_tensor(np.random.default_rng(n).permutation(n),
                           device=vv.device)
    hp, tp = mu.mu_h_solve_columns(vv[:, perm], *args[1:])
    assert torch.equal(h[:, perm], hp)
    assert torch.equal(trips[perm], tp)


@pytest.mark.gpu
def test_cuda_h_cols_kernel_matches_plain_version():
    """K3 against its plain version on the card: a ragged last tile, early
    stops and fixed trips, the broadcast start column, and the frame-major
    strided input of the fast plan; on the resident-W path with more columns
    than the clusters hold at once (slots are refilled as columns stop) and
    on the streaming path (R=1000).  Two launches give the same bits, and a
    column solved among fewer columns, or with the columns permuted, gives
    the bits it has among all, on both paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    for f, r, n, resident in ((129, 40, 37, True), (129, 40, 1700, True),
                              (513, 200, 300, True), (64, 200, 100, True),
                              (513, 1000, 40, False)):
        assert bool(mu.mu_h_solve_columns_shape(f, r, n)["resident"]) \
            == resident
        v, w, h0 = _inputs(6, f=f, r=r, n=n)
        v_fm = t(np.ascontiguousarray(v.T)).T       # frame-major (F, N) view
        for vv in (t(v), v_fm):
            for max_iter, eps in ((22, 0.0), (100, 1e-3), (1, 1e-3)):
                args = (vv, t(w), t(h0), max_iter, eps, 5.0, 1e-9)
                n0 = mu.mu_h_solve_columns.launches
                h, trips = mu.mu_h_solve_columns(*args)
                assert mu.mu_h_solve_columns.launches == n0 + 1
                _hold_cols_to_plain(args, h, trips)
                h2, trips2 = mu.mu_h_solve_columns(*args)
                assert torch.equal(h, h2) and torch.equal(trips, trips2)
                _same_bits_among_other_columns(vv, args, h, trips)
        # a start matrix with a column of its own for every column of V
        h0n = t(np.random.default_rng(7).random((r, n)).astype(np.float32))
        args = (t(v), t(w), h0n, 30, 1e-3, 5.0, 1e-9)
        h, trips = mu.mu_h_solve_columns(*args)
        _hold_cols_to_plain(args, h, trips)


@pytest.mark.gpu
@pytest.mark.parametrize("f,r,n", [(513, 1000, 40), (513, 1000, 24576),
                                   (400, 1200, 1003)])
def test_cuda_h_cols_streaming_path_matches_plain_version(f, r, n):
    """The streaming path (W's slice does not fit a resident cluster) at
    the exemplar width, at the fast plan's 64 lanes of 384 frames, and at a
    ragged shape (F and R not multiples of the chunks, R=1200 taking two
    rounds of rows in the numerator pass, a last tile of 11 columns): fixed
    trips, early stops and one trip; the frame-major strided input; the
    broadcast and a full start matrix; held to the plain version; two
    launches the same bits; a column's bits and trips independent of the
    columns solved beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    from se_snmf_nat_tpu_torch.device import require_cuda
    dev = require_cuda()
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    assert mu.mu_h_solve_columns_shape(f, r, n)["resident"] == 0
    v, w, h0 = _inputs(8, f=f, r=r, n=n)
    v_fm = t(np.ascontiguousarray(v.T)).T
    h0n = t(np.random.default_rng(9).random((r, n)).astype(np.float32))
    for h0_t in (t(h0), h0n):
        for max_iter, eps in ((25, 0.0), (50, 1e-3), (1, 1e-3)):
            args = (v_fm, t(w), h0_t, max_iter, eps, 5.0, 1e-9)
            h, trips = mu.mu_h_solve_columns(*args)
            _hold_cols_to_plain(args, h, trips)
            if eps == 0.0 or max_iter == 1:
                assert bool((trips == max_iter).all())
            h2, trips2 = mu.mu_h_solve_columns(*args)
            assert torch.equal(h, h2) and torch.equal(trips, trips2)
            if h0_t.shape[1] == 1 and n <= 2000:
                _same_bits_among_other_columns(v_fm, args, h, trips)
