"""The port's NTF and offline PMWF (``multichannel/{ntf,pmwf}.py``) against
the reference package's on the CPU, on seeded inputs: in float64 within
1e-9 relative of the reference run in x64, with identical int16 and equal
trip counts; in float32 within twice the reference's own float32-to-x64
gap on the same input.  Plus the reference package's own gates of these
modules (Khatri-Rao against ``numpy.kron``, the literal PSD_cov_mat.m loop,
the identity-noise filter, the coherent rank-1 solve)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.multichannel import ntf as j_ntf
from se_snmf_nat_tpu.multichannel import pmwf as j_pmwf
from se_snmf_nat_tpu.multichannel.fixture import synth_mixture
from se_snmf_nat_tpu.utils.matlab_compat import matlab_int16_write
from se_snmf_nat_tpu_torch.multichannel import ntf as t_ntf
from se_snmf_nat_tpu_torch.multichannel import pmwf as t_pmwf

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def np_kr(a, b):
    k = a.shape[1]
    return np.stack([np.kron(a[:, i], b[:, i]) for i in range(k)], axis=1)


def test_khatri_rao_matches_kron_and_reference():
    rng = np.random.default_rng(0)
    a, b, c = rng.random((4, 3)), rng.random((5, 3)), rng.random((2, 3))
    for mats, want in (((a, b), np_kr(a, b)),
                       ((a, b, c), np_kr(a, np_kr(b, c)))):
        got = t_ntf.khatri_rao(*(torch.as_tensor(m) for m in mats))
        ref = j_ntf.khatri_rao(*(jnp.asarray(m) for m in mats))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ten2mat_equals_reference():
    x = np.random.default_rng(1).random((3, 4, 5))
    np.testing.assert_array_equal(t_ntf.ten2mat(torch.as_tensor(x)).numpy(),
                                  np.asarray(j_ntf.ten2mat(jnp.asarray(x))))


def test_default_c_init_equals_reference():
    np.testing.assert_array_equal(t_ntf.default_c_init(6, 100),
                                  np.asarray(j_ntf.default_c_init(6, 100)))


def _synthetic_tensor(rng, c=3, n=32, m=20, k=4):
    b = rng.random((n, k)) + 0.05
    c_true = rng.random((c, k)) + 0.05
    a_true = rng.random((m, k)) + 0.05
    return np.einsum("ck,nk,mk->cnm", c_true, b, a_true), b, a_true


@pytest.mark.parametrize("kw", [
    dict(sparsity=1.0, max_iter=500, conv_eps=1e-4),            # early stop
    dict(sparsity=0.0, max_iter=40, conv_eps=0.0),              # never stop
    dict(sparsity=2.0, max_iter=60, conv_eps=1e-6, update_a=True),
    dict(sparsity=0.5, max_iter=30, conv_eps=1e-3, update_c=False,
         update_a=True),
], ids=["early_stop", "conv_eps_0", "update_a", "a_only"])
def test_ntf_solve_matches_reference_x64(kw):
    s, b, a0 = _synthetic_tensor(np.random.default_rng(2))
    c0 = t_ntf.default_c_init(3, 4)
    want = j_ntf.ntf_solve(jnp.asarray(s), jnp.asarray(b), jnp.asarray(c0),
                           jnp.asarray(a0), **kw)
    got = t_ntf.ntf_solve(s, b, c0, a0, **CPU64, **kw)
    assert got.iters == int(want.iters)
    if kw["conv_eps"] > 0 and kw["max_iter"] == 500:
        assert got.iters < 500
    for g, w in ((got.c, want.c), (got.a, want.a), (got.div, want.div),
                 (got.cost, want.cost)):
        assert _rel(g, w) <= 1e-9


def test_ntf_fits_the_truth_with_b_and_a_fixed():
    """The reference package's gate: with B and A at the truth, C fits the
    tensor closely."""
    s, b, a_true = _synthetic_tensor(np.random.default_rng(1))
    res = t_ntf.ntf_solve(s, b, t_ntf.default_c_init(3, 4), a_true,
                          sparsity=0.0, max_iter=200, conv_eps=0.0, **CPU64)
    xh = np.einsum("ck,nk,mk->cnm", res.c.numpy(),
                   b / np.linalg.norm(b, axis=0), a_true)
    assert np.abs(xh - s).mean() / s.mean() < 5e-3
    # the fit is exact, so the divergence is zero up to rounding (the sum's
    # order decides its sign)
    assert float(res.div) >= -1e-12 * s.sum() and res.iters == 200


def test_ntf_float32_within_reference_envelope():
    s, b, a0 = _synthetic_tensor(np.random.default_rng(3))
    c0 = t_ntf.default_c_init(3, 4)
    kw = dict(sparsity=1.0, max_iter=30, conv_eps=0.0)
    want64 = j_ntf.ntf_solve(jnp.asarray(s), jnp.asarray(b),
                             jnp.asarray(c0), jnp.asarray(a0), **kw).c
    with jax.enable_x64(False):
        want32 = j_ntf.ntf_solve(jnp.asarray(s, jnp.float32),
                                 jnp.asarray(b, jnp.float32),
                                 jnp.asarray(c0, jnp.float32),
                                 jnp.asarray(a0, jnp.float32), **kw).c
    got = t_ntf.ntf_solve(s, b, c0, a0, device="cpu", **kw).c
    assert got.dtype == torch.float32
    assert _rel(got, want64) <= 2.0 * _rel(want32, want64)


def _spectra(rng, c, f, t):
    return rng.standard_normal((c, f, t)) + 1j * rng.standard_normal((c, f, t))


def test_spectro_temporal_cov_matches_reference_and_the_loop():
    """Every frame against the reference package, and the frames with a
    full temporal neighborhood against a literal PSD_cov_mat.m
    transcription, the frequency edges (boundary collapse) included."""
    rng = np.random.default_rng(3)
    c, f, t, m_nbr, l_nbr = 2, 12, 9, 2, 2
    y = _spectra(rng, c, f, t)
    got = t_pmwf.spectro_temporal_cov(torch.as_tensor(y), m_nbr, l_nbr)
    want = j_pmwf.spectro_temporal_cov(jnp.asarray(y), m_nbr, l_nbr)
    assert got.shape == (t, f, c, c)
    assert _rel(got, want) <= 1e-12

    def ref_cov_at(tc):
        scov = np.zeros((f, c, c), complex)
        for fi in range(f):
            cols = []
            for mp in range(-m_nbr, m_nbr + 1):
                for lp in range(-l_nbr, l_nbr + 1):
                    if fi - m_nbr < 0 or fi + m_nbr > f - 1:
                        cols.append(y[:, fi, tc + lp])
                    else:
                        cols.append(y[:, fi + mp, tc + lp])
            stf = np.stack(cols, axis=1)
            scov[fi] = stf @ stf.conj().T
        return scov

    for tc in (2, 4, 6):
        np.testing.assert_allclose(got[tc].numpy(), ref_cov_at(tc),
                                   rtol=1e-10, atol=1e-10)


def _hpd(rng, n, c):
    m = rng.standard_normal((n, c, c)) + 1j * rng.standard_normal((n, c, c))
    return m @ np.conj(np.swapaxes(m, 1, 2)) + np.eye(c)[None]


@pytest.mark.parametrize("c", [3, 6, 9])
def test_solve_hpd_small_matches_reference_and_lapack(c):
    """C <= 8 is the unrolled Cholesky, C=9 the library solve."""
    rng = np.random.default_rng(c)
    a, b = _hpd(rng, 7, c), _spectra(rng, 7, c, c)
    got = t_pmwf.solve_hpd_small(torch.as_tensor(a), torch.as_tensor(b))
    want = j_pmwf.solve_hpd_small(jnp.asarray(a), jnp.asarray(b))
    assert _rel(got, want) <= 1e-12
    assert _rel(got, np.linalg.solve(a, b)) <= 1e-12
    got32 = t_pmwf.solve_hpd_small(torch.as_tensor(a, dtype=torch.complex64),
                                   torch.as_tensor(b, dtype=torch.complex64))
    np.testing.assert_allclose(got32.numpy(), np.linalg.solve(a, b),
                               rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("c", [3, 6])
def test_solve_hpd_small_coherent_rank1_finite(c):
    """The pivot floor: a rank-1 covariance with entries ~1e8 and the
    absolute load 1e-3 stays finite in complex64, as the reference's
    does."""
    rng = np.random.default_rng(3)
    d = (rng.standard_normal(c) + 1j * rng.standard_normal(c)) * 1e4
    a = np.outer(d, d.conj())[None] * np.ones((7, 1, 1)) \
        + 1e-3 * np.eye(c)[None]
    b = _spectra(rng, 7, c, c)
    got = t_pmwf.solve_hpd_small(torch.as_tensor(a, dtype=torch.complex64),
                                 torch.as_tensor(b, dtype=torch.complex64))
    want = np.asarray(j_pmwf.solve_hpd_small(
        jnp.asarray(a, jnp.complex64), jnp.asarray(b, jnp.complex64)))
    assert torch.isfinite(got).all() and np.isfinite(want).all()


def test_pmwf_filters_match_reference_x64():
    rng = np.random.default_rng(5)
    f, c = 9, 4
    ncov = _hpd(rng, f, c)
    ecov = _hpd(rng, f, c) - 0.5 * np.eye(c)[None]
    got = t_pmwf.pmwf_filters(torch.as_tensor(ncov), torch.as_tensor(ecov),
                              10.0, 1e-3)
    want = j_pmwf.pmwf_filters(jnp.asarray(ncov), jnp.asarray(ecov), 10.0,
                               1e-3)
    assert got.shape == (f, c, c)
    assert _rel(got, want) <= 1e-12


def test_pmwf_filter_identity_noise():
    """With Ncov = I and Ecov rank-1, H aligns with the steering direction
    and scales by 1/(beta+lambda)."""
    f, c = 5, 3
    d = np.array([1.0, 0.5 + 0.5j, -0.25j])
    ecov = np.tile(np.outer(d, d.conj()), (f, 1, 1))
    ncov = np.tile(np.eye(c), (f, 1, 1)).astype(complex)
    h = t_pmwf.pmwf_filters(torch.as_tensor(ncov), torch.as_tensor(ecov),
                            10.0, diag_load=0.0).numpy()
    lam = np.real(np.trace(ecov[0]))
    want_col0 = np.outer(d, d.conj())[:, 0] / (10.0 + lam + 1e-9)
    np.testing.assert_allclose(h[0, 0, :], want_col0, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def mix():
    return synth_mixture(n=12000, n_ch=3, seed=4)


@pytest.mark.parametrize("ref_ch", [None, 1])
def test_enhancer_matches_reference_x64(mix, ref_ch):
    x, _ = mix
    params = t_pmwf.PmwfParams(ref_ch=ref_ch)
    want = j_pmwf.PmwfEnhancer(params=j_pmwf.PmwfParams(ref_ch=ref_ch),
                               dtype=jnp.float64).enhance(x, quantize=False)
    port = t_pmwf.PmwfEnhancer(params=params, **CPU64)
    got = port.enhance(x, quantize=False)
    assert got.shape == want.shape == (1 if ref_ch is not None else 3,
                                       (x.shape[1] // 160 + 1) * 160)
    assert _rel(got, want) <= 1e-9
    np.testing.assert_array_equal(port.enhance(x), matlab_int16_write(want))


def test_enhancer_float32_within_reference_envelope(mix):
    x, _ = mix
    want64 = j_pmwf.PmwfEnhancer(dtype=jnp.float64).enhance(x,
                                                            quantize=False)
    with jax.enable_x64(False):
        want32 = j_pmwf.PmwfEnhancer(dtype=jnp.float32).enhance(
            x, quantize=False)
    got = t_pmwf.PmwfEnhancer(device="cpu").enhance(x, quantize=False)
    assert np.isfinite(got).all()
    assert _rel(got, want64) <= 2.0 * _rel(want32, want64)


def test_params_are_the_reference_defaults():
    assert t_pmwf.PmwfParams() == t_pmwf.PmwfParams(
        **vars(j_pmwf.PmwfParams()))


@pytest.mark.parametrize("shape", [(3, 5, 640), (2, 1024, 64), (1100, 40)])
def test_fixed_rows_equals_one_transform(shape):
    """The fixed-shape transform calls give the one-call result (pocketfft
    gives every row the same bits whatever the batch)."""
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(shape))
    spec = t_pmwf.fixed_rows(torch.fft.rfft, x, 128)
    assert torch.equal(spec, torch.fft.rfft(x, n=128, dim=-1))
    assert torch.equal(t_pmwf.fixed_rows(torch.fft.irfft, spec, 128),
                       torch.fft.irfft(spec, n=128, dim=-1))
