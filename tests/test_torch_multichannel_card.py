"""The multichannel path on the card against its CPU runs (marked ``gpu``:
it skips without a CUDA card).  This file imports no JAX, so it runs on a
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_multichannel_card.py

In float64 the card's output is within 1e-9 relative of the CPU's with
identical int16; lanes of a batch give the bits of single-lane runs on the
card, the session gives the one-shot run's int16, and six coherent
channels stay finite in float32.
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.multichannel import (
    NtfStreamingSession, PmwfEnhancer, PmwfParams, PmwfStreamingSession,
    make_pmwf_batch_run, make_pmwf_batch_run_fast, make_pmwf_streaming_run,
    make_pmwf_streaming_run_fast, ntf_solve, pmwf_stream_init,
    pmwf_streaming_enhance)
from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
from se_snmf_nat_tpu_torch.multichannel.ntf import default_c_init
from se_snmf_nat_tpu_torch.multichannel.pmwf import frames_of
from se_snmf_nat_tpu_torch.multichannel.streaming import batch_stream_state

torch.set_num_threads(1)
C = 6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    return require_cuda()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def mix():
    return synth_mixture(n=12000, n_ch=C)


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True])
def test_float64_on_the_card_matches_the_cpu(mix, fast):
    dev = _card()
    x = mix[0]
    kw = dict(dtype=torch.float64, quantize=False, fast=fast)
    card = pmwf_streaming_enhance(x, device=dev, **kw)
    cpu = pmwf_streaming_enhance(x, device="cpu", **kw)
    assert _rel(card, cpu) <= 1e-9
    off = [PmwfEnhancer(dtype=torch.float64, device=d).enhance(x)
           for d in (dev, "cpu")]
    np.testing.assert_array_equal(off[0], off[1])


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True])
def test_lanes_on_the_card_equal_single_lanes(fast):
    dev = _card()
    cfg = default_config()
    frames = np.stack([frames_of(synth_mixture(n=8000, n_ch=C, seed=s)[0],
                                 cfg) for s in range(4)])
    p = PmwfParams()
    st0 = pmwf_stream_init(p, C, cfg.signal.n_bins, device=dev)
    batch = (make_pmwf_batch_run_fast if fast else make_pmwf_batch_run)(
        cfg, p, device=dev)
    single = (make_pmwf_streaming_run_fast if fast
              else make_pmwf_streaming_run)(cfg, p, device=dev)
    ys, _ = batch(frames, batch_stream_state(st0, 4))
    for i in (0, 3):
        assert torch.equal(ys[i], single(frames[i], st0)[0])


@pytest.mark.gpu
def test_session_on_the_card_equals_one_shot(mix):
    dev = _card()
    x = mix[0]
    sess = PmwfStreamingSession(n_ch=C, block_frames=8, device=dev)
    got = np.concatenate([sess.push(x[:, i: i + 1600])
                          for i in range(0, x.shape[1], 1600)]
                         + [sess.flush()], axis=1)
    np.testing.assert_array_equal(got, pmwf_streaming_enhance(x, device=dev))


@pytest.mark.gpu
def test_coherent_channels_finite_on_the_card():
    dev = _card()
    rng = np.random.default_rng(11)
    x = rng.standard_normal(9000) * 3000.0
    xs = np.stack([np.roll(x, 7 * c) for c in range(C)])
    y = pmwf_streaming_enhance(xs, quantize=False, device=dev)
    assert np.isfinite(y).all() and float(np.abs(y).max()) > 1.0


@pytest.mark.gpu
def test_ntf_on_the_card_matches_the_cpu():
    dev = _card()
    rng = np.random.default_rng(0)
    b = rng.random((64, 8)) + 0.05
    s = np.einsum("ck,nk,mk->cnm", rng.random((C, 8)) + 0.05, b,
                  rng.random((32, 8)) + 0.05)
    kw = dict(sparsity=1.0, max_iter=50, conv_eps=1e-4, dtype=torch.float64)
    c0, a0 = default_c_init(C, 8), np.ones((32, 8))
    card, cpu = (ntf_solve(s, b, c0, a0, device=d, **kw)
                 for d in (dev, "cpu"))
    assert card.iters == cpu.iters
    assert _rel(card.c.cpu().numpy(), cpu.c.numpy()) <= 1e-9
    blks = rng.random((5, C, 64, 16)) + 1e-3
    s1 = NtfStreamingSession(b, C, device=dev)
    one = np.stack([s1.push_block(blk) for blk in blks])
    np.testing.assert_array_equal(
        NtfStreamingSession(b, C, device=dev).push_blocks(blks), one)
