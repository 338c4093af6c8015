"""Port parity of the enhancer facade: ``SnmfEnhancer.enhance_batch`` and
``enhance`` of ``se_snmf_nat_tpu_torch.stream.pipeline`` against the JAX
package's, with the flags of ``HEADLINE_PLAN`` except a 16-frame block and
narrow widths, three utterances of different lengths and micro-batches of
two.  In float64 the int16 outputs are identical."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.headline import HEADLINE_PLAN
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import (
    bases_to_torch, config_from_jax, state_from_jax, state_to_numpy)
from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)
PLAN = dict(HEADLINE_PLAN, block_adapt=16)
LENGTHS = (5200, 7900, 3700)


def _cfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=16, r_d=16),
                      adapt=replace(cfg.adapt, r_a=8, m_a=12),
                      blk=replace(cfg.blk, p_len_l=4))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 16, 16, seed=5)
    xs = [fixtures.noisy_utterance(n, seed=i) for i, n in enumerate(LENGTHS)]
    ref = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64, **PLAN)
    port = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                        dtype=torch.float64, **PLAN)
    return cfg, bx, bd, xs, ref, port


def test_enhance_batch_int16_identical_x64(setup):
    cfg, _, _, xs, ref, port = setup
    want = ref.enhance_batch(xs, micro_batch=2)
    got = port.enhance_batch(xs, micro_batch=2)
    assert len(got) == len(want) == len(xs)
    for g, w, x in zip(got, want, xs):
        assert g.dtype == np.int16 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert np.sqrt(np.mean(g.astype(float) ** 2)) < np.sqrt(
            np.mean(x ** 2))


def test_enhance_batch_micro_batch_invariant(setup):
    _, _, _, xs, _, port = setup
    one = port.enhance_batch(xs, micro_batch=None)
    two = port.enhance_batch(xs, micro_batch=2)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)


def test_enhance_single_matches_jax_and_carries_state(setup):
    _, _, _, xs, ref, port = setup
    want, st_ref = ref.enhance(xs[1], return_state=True)
    got, st = port.enhance(xs[1], return_state=True)
    np.testing.assert_array_equal(got, want)
    st_ref = jax.tree.map(np.asarray, st_ref)
    st_np = state_to_numpy(st)
    for name in st_np._fields:
        a, b = getattr(st_np, name), np.asarray(getattr(st_ref, name))
        np.testing.assert_allclose(a.astype(float), b.astype(float),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    # a carried state seeds the next utterance as in the reference
    np.testing.assert_array_equal(
        port.enhance(xs[2], state=st),
        ref.enhance(xs[2], state=ref.initial_state()._replace(
            **{k: jnp.asarray(v) for k, v in st_ref._asdict().items()})))


def test_state_round_trip(setup):
    _, _, _, _, ref, _ = setup
    st = jax.tree.map(np.asarray, ref.initial_state())
    back = state_to_numpy(state_from_jax(st, device="cpu",
                                         dtype=torch.float64))
    for name in back._fields:
        a, b = getattr(back, name), np.asarray(getattr(st, name))
        assert a.dtype.kind == b.dtype.kind, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_bases_to_torch_and_build_headline_enhancer(setup):
    cfg, bx, bd, xs, _, port = setup
    tb = bases_to_torch(bx, bd, bx, bd, device="cpu", dtype=torch.float64)
    assert all(t.dtype == torch.float64 for t in tb)
    np.testing.assert_array_equal(tb[0].numpy(), bx)
    enh = build_headline_enhancer(config_from_jax(cfg), tb, device="cpu",
                                  dtype=torch.float64)
    assert enh.frame_bucket == HEADLINE_PLAN["frame_bucket"]
    assert enh.run.step.k_block == HEADLINE_PLAN["block_adapt"]
    assert enh.run.step.h_eps == 0.0          # fixed-trip H-solves
    assert enh.run.step.h_iters == HEADLINE_PLAN["block_iter_cap"]
    assert enh.run.step.w_iters == HEADLINE_PLAN["block_refit_cap"]
    assert enh.run.step.w_eps > 0.0           # the refit keeps its stop


def test_exact_plan_not_ported_yet(setup):
    cfg, bx, bd, *_ = setup
    with pytest.raises(NotImplementedError):
        SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                     block_adapt=0)


@pytest.mark.slow
def test_headline_plan_full_width_int16_identical_x64():
    """The production plan at full width (F=513, r_x=r_d=100, r_a=50,
    m_a=100, K=88) on two 3.5 s utterances."""
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 100, 100, seed=0)
    xs = [fixtures.noisy_utterance(54880, seed=i) for i in range(2)]
    ref = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64, **HEADLINE_PLAN)
    port = build_headline_enhancer(config_from_jax(cfg), (bx, bd, bx, bd),
                                   device="cpu", dtype=torch.float64)
    for g, w in zip(port.enhance_batch(xs), ref.enhance_batch(xs)):
        np.testing.assert_array_equal(g, w)
