"""Port parity of the block-sparsity statistic Q:
``se_snmf_nat_tpu_torch.enhance.blk_sparse`` against the JAX package's
per-frame form (prefix sums; an associative scan over the centers at
blk_gap < 3) at gaps 1, 2, 3 and 7, before and after the ring has filled, in
float64 within 1e-12; the whole-block form against the per-frame form; and
the block and fast plans at ``blk_gap=1`` against the JAX plans."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.enhance import blk_sparse as jblk
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.enhance import blk_sparse as tblk
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)
F, P_K, P_L, DC = 513, 60, 6, 5
KW = dict(n_bins=F, p_len_k=P_K, p_len_l=P_L, dc_bin=DC, alpha_p=0.4)


def _frames(seed, n, lanes=2):
    rng = np.random.default_rng(seed)
    xm = rng.gamma(0.7, 2.0, (n, lanes, F))
    dm = rng.gamma(0.7, 2.0, (n, lanes, F)) + 0.1
    return xm, dm


@pytest.mark.parametrize("gap", [1, 2, 3, 7])
def test_block_sparsity_q_matches_jax_x64(gap):
    """Ten frames through the shift ring, two lanes in one port call: Q and
    the ring at every frame, on both sides of l > p_len_l."""
    xm, dm = _frames(gap, 10)
    ring_t = torch.zeros((2, F, P_L), dtype=torch.float64)
    rings_j = [jnp.zeros((F, P_L))] * 2
    for l in range(1, 11):
        q, ring_t = tblk.block_sparsity_q(
            torch.as_tensor(xm[l - 1]), torch.as_tensor(dm[l - 1]), ring_t,
            l, gap=gap, nonzerofloor=1e-9, **KW)
        assert q.shape == (2, F) and q.dtype == torch.float64
        for lane in range(2):
            q_ref, rings_j[lane] = jblk.block_sparsity_q(
                jnp.asarray(xm[l - 1, lane]), jnp.asarray(dm[l - 1, lane]),
                rings_j[lane], jnp.asarray(l, jnp.int32), gap=gap,
                nonzerofloor=1e-9, **KW)
            np.testing.assert_allclose(q[lane].numpy(), np.asarray(q_ref),
                                       rtol=0, atol=1e-12)
            np.testing.assert_allclose(ring_t[lane].numpy(),
                                       np.asarray(rings_j[lane]), rtol=0,
                                       atol=1e-15)
        filled = l > P_L
        assert bool((q[:, DC:] != 0.1).any()) == filled
        assert bool((q[:, :DC] == 0).all())


@pytest.mark.parametrize("gap", [1, 3, 7])
def test_block_form_equals_frame_form(gap):
    """The whole-block form over K = 10 frames with a lane that ends at
    frame 7 equals the per-frame form frame by frame, ring included."""
    xm, dm = _frames(10 + gap, 10)
    snr = tblk.snr_column(torch.as_tensor(xm), torch.as_tensor(dm), 1e-9)
    q_fn = tblk.make_block_sparsity_q_block(
        10, gap=gap, device="cpu", dtype=torch.float64, **KW)
    ring0 = torch.as_tensor(np.random.default_rng(0).random((2, F, P_L)))
    n_valid = torch.tensor([10, 7])
    q_blk, ring_blk = q_fn(snr.transpose(0, 1), ring0, np.arange(3, 13),
                           n_valid)
    ring = ring0
    for k in range(10):
        q, ring_new = tblk.block_sparsity_q(
            torch.as_tensor(xm[k]), torch.as_tensor(dm[k]), ring, 3 + k,
            gap=gap, nonzerofloor=1e-9, **KW)
        ok = (k < n_valid)[:, None, None]
        ring = torch.where(ok, ring_new, ring)
        for lane in range(2):
            if k < int(n_valid[lane]):
                np.testing.assert_allclose(q_blk[lane, k].numpy(),
                                           q[lane].numpy(), rtol=0,
                                           atol=1e-12)
    assert torch.equal(ring_blk, ring)


@pytest.mark.parametrize("gap", [1, 3])
def test_late_per_lane(gap):
    """A frame number per lane: lanes below and above ``p_len_l`` in one
    call equal the same lanes with their host integers, in the per-frame
    form (a (B,) tensor) and in the whole-block form ((B, K) and (K,)
    tensors), to summation order between a batch of three and a batch of
    one, and bit for bit between a tensor and host integers on one batch;
    the lane below keeps the initial value, NaN-free."""
    xm, dm = _frames(20 + gap, 1, lanes=3)
    ring = torch.as_tensor(np.random.default_rng(1).random((3, F, P_L)))
    ring[0] = 0.0               # an empty ring: its window sums are 0/0
    ls = (2, P_L, P_L + 5)
    q, ring_new = tblk.block_sparsity_q(
        torch.as_tensor(xm[0]), torch.as_tensor(dm[0]), ring,
        torch.tensor(ls), gap=gap, nonzerofloor=1e-9, **KW)
    assert bool(torch.isfinite(q).all())
    for lane, l in enumerate(ls):
        q_1, ring_1 = tblk.block_sparsity_q(
            torch.as_tensor(xm[0, lane: lane + 1]),
            torch.as_tensor(dm[0, lane: lane + 1]), ring[lane: lane + 1], l,
            gap=gap, nonzerofloor=1e-9, **KW)
        assert (q[lane] - q_1[0]).abs().max() < 1e-13   # summation order
        assert torch.equal(ring_new[lane], ring_1[0])
        assert bool((q[lane, DC:] != 0.1).any()) == (l > P_L)
    # the whole-block form
    k_blk = 5
    xm, dm = _frames(30 + gap, k_blk, lanes=3)
    snr = tblk.snr_column(torch.as_tensor(xm), torch.as_tensor(dm),
                          1e-9).transpose(0, 1)            # (3, K, F)
    q_fn = tblk.make_block_sparsity_q_block(
        k_blk, gap=gap, device="cpu", dtype=torch.float64, **KW)
    n_valid = torch.full((3,), k_blk)
    l0 = torch.tensor((1, P_L - 2, P_L + 5))
    q_b, ring_b = q_fn(snr, ring, l0[:, None] + torch.arange(k_blk), n_valid)
    assert bool(torch.isfinite(q_b).all())
    for lane in range(3):
        host = np.arange(k_blk) + int(l0[lane])
        sl = slice(lane, lane + 1)
        q_1, ring_1 = q_fn(snr[sl], ring[sl], host, n_valid[sl])
        assert (q_b[lane] - q_1[0]).abs().max() < 1e-13
        assert torch.equal(ring_b[lane], ring_1[0])
        q_t, _ = q_fn(snr[sl], ring[sl], torch.as_tensor(host), n_valid[sl])
        assert torch.equal(q_t, q_1)
        filled = torch.as_tensor(host > P_L)
        assert torch.equal((q_b[lane, :, DC:] != 0.1).any(dim=-1), filled)


def test_banded_sums_keep_the_digits_prefix_sums_lose():
    """Where a center's window holds ~1e-8 of the ring's mass below it (a
    noise-only frame on dictionaries that separate well), the reference's
    prefix-sum differences cancel: its float64 Q is off by far more than
    summation order, while the port's banded sums stay at rounding level of
    a long-double evaluation."""
    rng = np.random.default_rng(5)
    ring = rng.random((F, P_L)) * 1e-8
    ring[DC: DC + 25] = rng.random((25, P_L))        # the mass, at low bins
    kw = dict(KW, gap=3)
    q_ref = np.asarray(jblk.block_sparsity_stat(
        jnp.asarray(ring), jnp.asarray(P_L + 1, jnp.int32), **kw))
    q = tblk.block_sparsity_stat(torch.as_tensor(ring), P_L + 1,
                                 **kw).numpy()
    # long-double evaluation at a center whose window is all small values
    k = 200                                           # 1-based center
    assert (k - (P_K // 2 + DC)) % 3 == 0
    win = ring[k - P_K // 2: k + P_K // 2].astype(np.longdouble)
    n = np.sqrt(np.longdouble(P_K * P_L))
    hoyer = (n - win.sum() / np.sqrt((win * win).sum())) / (n - 1)
    exact = float(0.4 * 0.1 + 0.6 * hoyer)
    assert abs(q[k - 1] - exact) < 1e-14
    assert abs(q_ref[k - 1] - exact) > 1e-11


def _gap1_cfg(**adapt):
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=16, r_d=16),
                      adapt=replace(cfg.adapt, r_a=8, m_a=12, **adapt),
                      blk=replace(cfg.blk, p_len_l=4, blk_gap=1))


@pytest.mark.parametrize("plan", ["block", "fast", "exact"])
def test_plans_at_gap_1_int16_identical_x64(plan):
    """``blk_gap=1`` (Q a recurrence over the centers) on the block plan,
    the fast plan and the exact plan against the JAX package's, which keeps
    Q inside its frame scans there."""
    cfg = _gap1_cfg(adapt_train_n=plan != "fast")
    kw = dict(block_adapt=16) if plan == "block" else {}
    bx, bd = fixtures.synthetic_bases(cfg.signal.n_bins, 16, 16, seed=5)
    xs = [fixtures.noisy_utterance(n, seed=i)
          for i, n in enumerate((5200, 3700))]
    ref = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64, frame_bucket=16,
                    **kw)
    port = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                        dtype=torch.float64, frame_bucket=16, **kw)
    assert (port.run is not None) == (plan == "block")
    assert (port.fast_run is not None) == (plan == "fast")
    for g, w in zip(port.enhance_batch(xs), ref.enhance_batch(xs)):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)
