"""A beta other than 1 (IS, ED and a general beta-divergence) on the port's
block-adaptive and fast plans, against the JAX package's ``SnmfEnhancer``:
int16 identical in float64.  The kernels are KL only, so these plans take
the plain solves with the config's beta, as the reference's do; the exact
plan already did (``tests/test_torch_engine.py``)."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)

# (nmf.cf, nmf.beta_div): IS (beta 0), ED (beta 2), a general beta
BETAS = [("is", 1.0), ("ed", 1.0), ("beta", 0.5)]


def _cfg(cf, beta_div, adapt):
    cfg = default_config()
    return cfg.evolve(
        sep=replace(cfg.sep, r_x=8, r_d=8),
        adapt=replace(cfg.adapt, adapt_train_n=adapt, r_a=4, m_a=10),
        nmf=replace(cfg.nmf, cf=cf, beta_div=beta_div, max_iter=10))


def _pair(cfg, block_adapt):
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 8, 8, seed=0)
    j = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64,
                  block_adapt=block_adapt)
    t = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                     dtype=torch.float64, block_adapt=block_adapt)
    return j, t


@pytest.mark.parametrize("cf,beta_div", BETAS, ids=[b[0] for b in BETAS])
def test_block_plan_beta_matches_reference(cf, beta_div):
    """The block plan with adaptation (K=8): the H-solve and the refit."""
    cfg = _cfg(cf, beta_div, adapt=True)
    assert cfg.nmf.beta != 1.0
    j, t = _pair(cfg, block_adapt=8)
    assert t.run.step.h_solver == t.run.step.w_solver == "plain"
    x = fixtures.noisy_utterance(8000, seed=0)
    want = j.enhance(x)
    got = t.enhance(x)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cf,beta_div", BETAS, ids=[b[0] for b in BETAS])
def test_fast_plan_beta_matches_reference(cf, beta_div):
    """The fast plan that ``SnmfEnhancer`` picks by itself (fixed
    dictionaries, ``block_adapt=0``), two utterances as lanes."""
    cfg = _cfg(cf, beta_div, adapt=False)
    j, t = _pair(cfg, block_adapt=0)
    assert t.fast_run is not None and t.fast_run.h_solver == "plain"
    xs = [fixtures.noisy_utterance(8000, seed=0),
          fixtures.noisy_utterance(5600, seed=1)]
    for x in xs:
        np.testing.assert_array_equal(t.enhance(x), j.enhance(x))
    for got, want in zip(t.enhance_batch(xs), j.enhance_batch(xs)):
        np.testing.assert_array_equal(got, want)
