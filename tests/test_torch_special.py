"""The port's special functions (``utils/special.py``) against the reference
package's in float64: E1 over (1e-6, 40] and digamma over (1e-3, 1e3) to
1e-12 relative, the Bessel series to 1e-15; and the halving sum, whose
value for a lane does not depend on the other lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import exp1

from se_snmf_nat_tpu.utils import special as j_special
from se_snmf_nat_tpu_torch.utils import special as t_special

torch.set_num_threads(1)


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


def test_expint_e1_matches_reference_x64():
    x = np.concatenate([np.logspace(-6, np.log10(40.0), 1500),
                        np.linspace(1.4, 1.6, 201)])      # both branches
    want = np.asarray(j_special.expint_e1(jnp.asarray(x, jnp.float64)))
    got = t_special.expint_e1(torch.tensor(x, dtype=torch.float64)).numpy()
    assert got.dtype == np.float64
    assert _rel(got, want) <= 1e-12
    assert _rel(got, exp1(x)) <= 1e-12


def test_expint_e1_float32_and_its_edges():
    x = np.logspace(-6, np.log10(40.0), 500).astype(np.float32)
    got = t_special.expint_e1(torch.tensor(x))
    assert got.dtype == torch.float32
    want = np.asarray(j_special.expint_e1(jnp.asarray(x, jnp.float32)))
    assert _rel(got.numpy().astype(np.float64), want.astype(np.float64)) \
        <= 1e-5
    edge = t_special.expint_e1(torch.tensor([0.0, -1.0, 1e-300],
                                            dtype=torch.float64))
    assert torch.isinf(edge[0]) and torch.isinf(edge[1])
    assert torch.isfinite(edge[2])


def test_digamma_matches_reference_x64():
    x = np.concatenate([np.logspace(-3, 3, 2000), np.linspace(7.5, 8.5, 101)])
    want = np.asarray(j_special.digamma(jnp.asarray(x, jnp.float64)))
    got = t_special.digamma(torch.tensor(x, dtype=torch.float64)).numpy()
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= 1e-12


@pytest.mark.parametrize("name", ["bessel_i0_small", "bessel_i1_small"])
def test_bessel_series_match_reference(name):
    x = np.linspace(0.0, 2.0, 401)
    want = np.asarray(getattr(j_special, name)(jnp.asarray(x, jnp.float64)))
    got = getattr(t_special, name)(torch.tensor(x, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 161, 255, 257])
def test_tree_sum_is_the_sum_and_lane_invariant(n):
    x = torch.tensor(np.random.default_rng(n).gamma(1.0, 3.0, (5, n)),
                     dtype=torch.float32)
    got = t_special.tree_sum(x)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.double().numpy(),
                               x.double().sum(-1).numpy(), rtol=1e-6)
    for i in range(5):
        assert torch.equal(t_special.tree_sum(x[i: i + 1]), got[i: i + 1])
