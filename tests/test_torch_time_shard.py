"""The port's time-sharded enhancement against the JAX package's
``enhance_time_sharded`` on the conftest's virtual 8-device mesh: int16
identical in float64 on 8 shards, with halo 0, 16 and 64, adaptation on
and off, and an utterance shorter than halo * shards (the warm-up clamps).
Then the reference tests' own properties on the port
(``tests/test_time_shard.py``): without adaptation a 64-frame halo keeps
the sequential output to 1 LSB on under 1% of samples; with adaptation the
correlation stays above 0.98; no halo is worse than a 64-frame one.  The
audio is synthetic (the reference tests read a recording)."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.parallel.mesh import make_mesh as j_make_mesh
from se_snmf_nat_tpu.parallel.time_shard import (
    enhance_time_sharded as j_time_sharded)
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.parallel.collectives_audit import record
from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
from se_snmf_nat_tpu_torch.parallel.time_shard import (
    _shard_plan, enhance_time_sharded)
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)


def _enhancers(adapt: bool):
    """The reference test's small configuration, in both packages."""
    cfg = default_config()
    cfg = cfg.evolve(
        sep=replace(cfg.sep, r_x=8, r_d=8),
        adapt=replace(cfg.adapt, adapt_train_n=adapt, r_a=4, m_a=10),
        nmf=replace(cfg.nmf, max_iter=10))
    rng = np.random.default_rng(0)
    f = cfg.signal.n_bins
    bx = rng.random((f, 8)) + 1e-3
    bd = rng.random((f, 8)) + 1e-3
    j = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64,
                  matlab_ad_blk_init=False)
    t = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                     dtype=torch.float64, matlab_ad_blk_init=False)
    return j, t


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh((8, 1)), make_mesh((8, 1), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def audio():
    return fixtures.noisy_utterance(16000, seed=0)   # 1 s, 104 frames


@pytest.mark.parametrize("adapt", [False, True], ids=["fixed", "adapt"])
@pytest.mark.parametrize("halo", [0, 16, 64])
def test_time_shard_matches_reference(meshes, audio, adapt, halo):
    j, t = _enhancers(adapt)
    want = j_time_sharded(j, audio, meshes[0], halo=halo)
    with record() as rep:
        got = enhance_time_sharded(t, audio, meshes[1], halo=halo)
    assert rep.count == 0                 # the hot loop is collective-free
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("adapt", [False, True], ids=["fixed", "adapt"])
def test_clamped_halo_matches_reference(meshes, adapt):
    """An utterance shorter than halo * shards: every shard's warm-up
    clamps to the stream start."""
    j, t = _enhancers(adapt)
    x = fixtures.noisy_utterance(3000, seed=2)
    n_frames = t.frames_for(x).shape[0]
    seg, starts = _shard_plan(n_frames, 8, 16)
    assert 16 * 8 > n_frames and (np.minimum(starts, 16) < 16).sum() > 1
    np.testing.assert_array_equal(
        enhance_time_sharded(t, x, meshes[1], halo=16),
        j_time_sharded(j, x, meshes[0], halo=16))


def test_sharded_matches_sequential_no_adapt(meshes, audio):
    _, t = _enhancers(adapt=False)
    want = t.enhance(audio)
    got = enhance_time_sharded(t, audio, meshes[1], halo=64)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_sharded_with_adaptation_close(meshes, audio):
    _, t = _enhancers(adapt=True)
    want = t.enhance(audio).astype(np.float64)
    got = enhance_time_sharded(t, audio, meshes[1], halo=64)
    assert np.corrcoef(got.astype(np.float64), want)[0, 1] > 0.98


def test_sharded_halo_zero_diverges_more(meshes, audio):
    _, t = _enhancers(adapt=False)
    want = t.enhance(audio).astype(np.float64)
    err = {h: np.abs(enhance_time_sharded(t, audio, meshes[1], halo=h)
                     .astype(np.float64) - want).mean() for h in (0, 64)}
    assert err[0] > err[64]
