"""Port parity of the missing-data-imputation solver
(``se_snmf_nat_tpu_torch.nmf.mdi.snmf_mdi_solve``) against the JAX
package's in x64 on a seeded low-rank problem with 30% of the entries
missing: the hard mask (Dm) and the soft mask (Sm), fixed trips and the
early stop, W+H and the single-factor modes, with sparsity.  With holes the
imputed target keeps moving and the relative-cost stop is seldom reached;
it fires on the fully observed case.

Tolerance: float64 within 1e-9 relative to the largest entry (only the
summation order of the products differs); trip counts equal.  A soft mask
of 0s and 1s gives the hard mask's result bit for bit, as in the
reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.nmf.mdi import snmf_mdi_solve as j_mdi
from se_snmf_nat_tpu.nmf.solver import SnmfParams as JParams
from se_snmf_nat_tpu_torch.nmf import SnmfParams, snmf_mdi_solve

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    m, n, r = 64, 40, 5
    v = (rng.random((m, r)) + 0.05) @ (rng.random((r, n)) + 0.05)
    v += rng.random(v.shape) * 0.2
    dm = (rng.random((m, n)) > 0.3).astype(np.float64)
    sm = np.clip(dm * 0.7 + rng.random((m, n)) * 0.3, 0.0, 1.0)
    w0 = rng.random((m, r)) + 0.05
    h0 = rng.random((r, n)) + 0.05
    return v, dm, sm, w0, h0, r


CASES = {
    "hard_fixed": dict(soft=False, max_iter=30, conv_eps=0.0),
    "soft_fixed": dict(soft=True, max_iter=30, conv_eps=0.0),
    "hard_stop": dict(soft=False, max_iter=100, conv_eps=1e-3),
    "soft_stop": dict(soft=True, max_iter=100, conv_eps=1e-3),
    "observed_stop": dict(soft=False, max_iter=500, conv_eps=5e-3,
                          observed=True),
    "hard_h_only": dict(soft=False, max_iter=20, conv_eps=0.0,
                        update_w=False),
    "soft_w_only_sparse": dict(soft=True, max_iter=20, conv_eps=1e-3,
                               update_h=False, sparsity=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mdi_matches_jax_x64(problem, case):
    v, dm, sm, w0, h0, r = problem
    c = dict(CASES[case])
    soft = c.pop("soft")
    mask = np.ones_like(dm) if c.pop("observed", False) else (
        sm if soft else dm)
    upd = dict(update_w=c.pop("update_w", True),
               update_h=c.pop("update_h", True))
    sparsity = c.pop("sparsity", 0.0)
    w_mask = np.ones(r, bool)
    w_mask[-1] = False
    want = j_mdi(jnp.asarray(v), jnp.asarray(mask), jnp.asarray(w0),
                 jnp.asarray(h0), jnp.asarray(w_mask), jnp.ones(r, bool),
                 JParams(beta=1.0, sparsity=sparsity, flr=1e-9,
                         precision="highest", **c), soft=soft, **upd)
    got = snmf_mdi_solve(v, mask, w0, h0, w_mask, np.ones(r, bool),
                         SnmfParams(beta=1.0, sparsity=sparsity, flr=1e-9,
                                    **c),
                         soft=soft, device="cpu", dtype=torch.float64,
                         **upd)
    assert got.iters == int(want.iters)
    if case == "observed_stop":
        assert got.iters < c["max_iter"]
    for name in ("v_mdi", "w", "h"):
        assert getattr(got, name).dtype == torch.float64
        assert _rel(getattr(got, name), getattr(want, name)) < 1e-9, name
    assert _rel(got.div, want.div) < 1e-9
    assert _rel(got.cost, want.cost) < 1e-9


def test_soft_binary_mask_equals_hard(problem):
    v, dm, _, w0, h0, r = problem
    args = (v, dm, w0, h0, np.ones(r, bool), np.ones(r, bool),
            SnmfParams(beta=1.0, sparsity=0.0, max_iter=50, conv_eps=0.0))
    hard = snmf_mdi_solve(*args, soft=False, device="cpu",
                          dtype=torch.float64)
    soft = snmf_mdi_solve(*args, soft=True, device="cpu",
                          dtype=torch.float64)
    for a, b in zip(hard, soft):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_observed_entries_pass_through(problem):
    v, dm, _, w0, h0, r = problem
    res = snmf_mdi_solve(v, dm, w0, h0, np.ones(r, bool), np.ones(r, bool),
                         SnmfParams(beta=1.0, sparsity=0.0, max_iter=40,
                                    conv_eps=0.0),
                         device="cpu", dtype=torch.float64)
    seen = dm > 0
    np.testing.assert_allclose(res.v_mdi.numpy()[seen],
                               np.maximum(v, 1e-9)[seen], rtol=1e-12)
    np.testing.assert_allclose(torch.linalg.norm(res.w, dim=0).numpy(), 1.0,
                               atol=1e-12)
