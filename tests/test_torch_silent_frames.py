"""Frames whose activations underflow in float32.  With sparse dictionaries
(most entries at the 1e-9 floor, as trained ones are) the sparse-NMF solve
drives the activations of a floored frame (digital silence, the flush
frames at the end of an utterance) below the smallest float32 denormal, so
both reconstructions are exactly 0.  The reference then divides 0 by 0 in
three places: the noise-bias factor's ratio of mean activations, the Wiener
gain, and the block-sparsity statistic of a window of zero columns.  The
NaN enters the noise estimate and every later frame of the exact plan.  The
port takes those ratios as 1 (the factor at its floor), 0 (no gain) and a
flat window's (not sparse); float64, which never underflows there, is
unchanged and stays the JAX package's int16."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config as j_default_config
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config, preset
from se_snmf_nat_tpu_torch.enhance.blk_sparse import (
    _q_maps, noise_bias, wiener_gain)
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)


def _sparse_bases(seed, r=100, f=513):
    """Columns that are 7 bins wide over a floor of 1e-9, L2-normalised."""
    rng = np.random.default_rng(seed)
    b = np.full((f, r), 1e-9)
    for j in range(r):
        c = rng.integers(5, f - 5)
        b[c - 3: c + 4, j] = rng.random(7) + 0.1
    return b / np.sqrt((b * b).sum(0))


BX, BD = _sparse_bases(0), _sparse_bases(1)
X = np.concatenate([np.zeros(3200), fixtures.noisy_utterance(16000, seed=1),
                    np.zeros(3200)])
_FIXED = dict(adapt=dict(adapt_train_n=False))
PLANS = {
    "exact": ("snmf_nat", {}, {}, False),
    "exact_fixed": ("snmf_nat", _FIXED, {}, True),
    "block": ("snmf_nat", {}, dict(block_adapt=88, block_iter_cap=22,
                                   block_refit_cap=22, block_fixed_iter=True,
                                   dft_matmul=True), False),
    "fast_wiener": ("snmf", {}, {}, False),
    "fast_mmse": ("snmf_nat", _FIXED, {}, False),
    "exact_wiener": ("snmf", {}, {}, True),
}


def _cfg(pre, over):
    cfg = preset(pre)
    for section, fields in over.items():
        cfg = cfg.evolve(**{section: replace(getattr(cfg, section),
                                             **fields)})
    return cfg


def _run(plan, dtype):
    pre, over, kw, carried = PLANS[plan]
    enh = SnmfEnhancer(_cfg(pre, over), BX, BD, BX, BD, device="cpu",
                       dtype=dtype, **kw)
    if carried:         # a state in selects the exact per-frame plan
        return enh.enhance(X, state=enh.initial_state(), return_state=True,
                           quantize=False)[0]
    return enh.enhance_batch([X], quantize=False)[0]


def test_the_reference_float32_gives_nan_here():
    """The case is the fault's: the JAX package's float32 exact plan turns
    this utterance to NaN from its first silent frames on."""
    cfg = j_default_config()
    cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    enh = JEnhancer(cfg, BX, BD, BX, BD, dtype=jnp.float32)
    y, _ = enh.enhance(X, state=enh.initial_state(), return_state=True,
                       quantize=False)
    assert np.isnan(np.asarray(y)).sum() > len(X) // 2


@pytest.mark.parametrize("plan", list(PLANS))
def test_float32_stays_finite_and_near_float64(plan):
    y32 = _run(plan, torch.float32)
    assert np.isfinite(y32).all()
    y64 = _run(plan, torch.float64)
    assert np.corrcoef(y32, y64)[0, 1] > 0.9999


def test_float64_still_equals_the_reference():
    cfg = j_default_config()
    cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    ref = JEnhancer(cfg, BX, BD, BX, BD, dtype=jnp.float64)
    want = ref.enhance(X, state=ref.initial_state(), return_state=True)[0]
    port = SnmfEnhancer(_cfg("snmf_nat", _FIXED), BX, BD, BX, BD,
                        device="cpu", dtype=torch.float64)
    got = port.enhance(X, state=port.initial_state(), return_state=True)[0]
    np.testing.assert_array_equal(got, want)


def test_the_three_ratios_at_zero():
    z = torch.zeros(3, dtype=torch.float32)
    one = torch.tensor([1.0, 0.0, 2.0])
    np.testing.assert_array_equal(
        noise_bias(z, z, 1.0, 1000.0).numpy(), [1.0, 1.0, 1.0])
    # the reference's values wherever its ratio is defined
    np.testing.assert_array_equal(
        noise_bias(one, torch.tensor([0.0, 1.0, 0.2]), 1.0, 1000.0).numpy(),
        [1000.0, 1.0, 20.0])
    np.testing.assert_array_equal(wiener_gain(z, z).numpy(), [0.0] * 3)
    np.testing.assert_array_equal(wiener_gain(one, one).numpy(),
                                  [0.5, 0.0, 0.5])
    cfg = default_config()
    s, blk = cfg.signal, cfg.blk
    maps = _q_maps(s.n_bins, blk.p_len_k, blk.p_len_l, s.dc_bin,
                   blk.blk_gap, blk.alpha_p, torch.device("cpu"),
                   torch.float32)
    n_c = maps.wf.shape[1]
    q = maps.q_of_windows(torch.zeros(1, n_c), torch.zeros(1, n_c), True)
    assert torch.isfinite(q).all()
    flat = torch.full((1, n_c), maps.sqrt_n)
    np.testing.assert_array_equal(
        q.numpy(), maps.q_of_windows(flat, torch.ones(1, n_c), True).numpy())
