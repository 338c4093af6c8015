"""``SnmfEnhancer.enhance_batch``'s host half moves int16 only: each lane's
true samples go up as packed int16 and are laid into the padded sample
matrix on the device, and the wavwrite requantisation runs on the device as
a gather of ``matlab_wavwrite_table``.  Held bit for bit to the host chain
it replaced (``_float64_chain``: the float64 sample matrix,
``pack_samples_for_upload``, the int16 PCM fetched and requantised a lane
on the host), on the block, fast and exact plans at narrow widths, lanes
whose lengths are not a multiple of the hop, a padded tail chunk and
``quantize=False``; float lanes that are not int16 values take the float
upload.  This file imports no JAX; its ``gpu`` test runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_batch_host_half.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.dsp.stft import (
    pack_samples_for_upload, stream_frames_torch)
from se_snmf_nat_tpu_torch.enhance.state import batch_state
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write_torch, matlab_wavwrite_quantize,
    matlab_wavwrite_table)

torch.set_num_threads(1)
SHIFT = 160
# 20, 13 and 30 hops and a part of one
LENGTHS = (20 * SHIFT + 37, 13 * SHIFT, 30 * SHIFT + 159)


@torch.no_grad()
def _float64_chain(enh, xs, quantize=True, micro_batch=32):
    """The host chain ``enhance_batch`` ran before its host half moved
    int16 only, written out: a zero float64 matrix of every chunk's lanes,
    ``pack_samples_for_upload``, the upload, framing, the run and the int16
    write on the device, then each lane's PCM widened to float64 and
    requantised on the host."""
    shift, delay = enh.cfg.signal.frameshift, enh.cfg.delay
    n_hops = np.asarray([len(x) // shift for x in xs], np.int64)
    t_true = n_hops + delay + 1
    t_max = -(-int(t_true.max()) // enh.frame_bucket) * enh.frame_bucket
    np_dt = np.float64 if enh.dtype == torch.float64 else np.float32
    mb = len(xs) if not micro_batch else min(int(micro_batch), len(xs))
    outs = []
    for c0 in range(0, len(xs), mb):
        chunk = xs[c0: c0 + mb]
        smp = np.zeros((mb, t_max * shift), np.float64)
        for i, x in enumerate(chunk):
            m = int(n_hops[c0 + i]) * shift
            smp[i, :m] = np.asarray(x)[:m]
        nh = np.zeros((mb,), np.int64)
        nh[: len(chunk)] = n_hops[c0: c0 + mb]
        tt = np.full((mb,), delay + 1, np.int64)
        tt[: len(chunk)] = t_true[c0: c0 + mb]
        smp_dev = torch.as_tensor(pack_samples_for_upload(smp, np_dt),
                                  device=enh.device).to(enh.dtype)
        frames = stream_frames_torch(
            smp_dev, torch.as_tensor(nh, device=enh.device),
            enh.cfg.signal.framelength, shift)
        states = None if enh.fast_run is not None else \
            batch_state(enh.initial_state(), mb)
        ys, _ = enh.run_frames(frames, states, tt)
        ys = matlab_int16_write_torch(ys).cpu().numpy()
        start = delay * shift
        for i in range(len(chunk)):
            g = c0 + i
            emit = ys[i, start: start + (int(t_true[g]) - delay) * shift]
            outs.append(matlab_wavwrite_quantize(
                emit.astype(np.float64) / 32767.0) if quantize
                else emit.astype(np.float64))
    return outs


def _cfg(plan):
    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                     adapt=replace(cfg.adapt, r_a=4, m_a=10),
                     nmf=replace(cfg.nmf, max_iter=6))
    if plan == "fast":
        cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    return cfg


def _enhancer(plan):
    cfg = _cfg(plan)
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 8, 8, seed=0)
    kw = dict(block_adapt=8, frame_bucket=8, block_iter_cap=6,
              block_refit_cap=6, block_fixed_iter=True, dft_matmul=True) \
        if plan == "block" else dict(frame_bucket=8)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                       dtype=torch.float64, **kw)
    assert (enh.run is not None, enh.fast_run is not None) == {
        "block": (True, False), "fast": (False, True),
        "exact": (False, False)}[plan]
    return enh


@pytest.fixture(scope="module")
def enhancers():
    built = {}

    def get(plan):
        if plan not in built:
            built[plan] = _enhancer(plan)
        return built[plan]
    return get


def _lanes(lengths=LENGTHS, seed=0):
    """Integer-valued float64 lanes, as ``fixtures.noisy_utterance`` (and
    every wav read) gives."""
    return [fixtures.noisy_utterance(n, seed=seed + i)
            for i, n in enumerate(lengths)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lo", range(-32768, 32768, 8192))
def test_wavwrite_table_equals_the_host_quantize(lo):
    table = matlab_wavwrite_table()
    assert table.shape == (65536,) and table.dtype == np.int16
    v = np.arange(lo, lo + 8192)
    np.testing.assert_array_equal(
        table[v], matlab_wavwrite_quantize(v / 32767.0))
    # the device's gather reads negative indices the same way
    np.testing.assert_array_equal(
        torch.as_tensor(table)[torch.as_tensor(v)].numpy(), table[v])


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("micro_batch", [None, 2])
@pytest.mark.parametrize("plan", ["block", "fast", "exact"])
def test_int16_and_float_lanes_equal_the_float64_chain(enhancers, plan,
                                                       micro_batch,
                                                       quantize):
    enh = enhancers(plan)
    xs = _lanes()
    want = _float64_chain(enh, xs, quantize, micro_batch)
    as_int16 = [x.astype(np.int16) for x in xs]
    _assert_same(enh.enhance_batch(as_int16, quantize, micro_batch), want)
    _assert_same(enh.enhance_batch(xs, quantize, micro_batch), want)
    assert want[0].dtype == (np.int16 if quantize else np.float64)


@pytest.mark.parametrize("flaw", ["fraction", "out_of_range", "nan"])
def test_a_lane_of_other_values_takes_the_float_upload(enhancers, flaw):
    enh = enhancers("block")
    xs = _lanes()
    x = xs[1].copy()
    x[100] = {"fraction": x[100] + 0.5, "out_of_range": 40000.0,
              "nan": np.nan}[flaw]
    xs[1] = x
    _assert_same(enh.enhance_batch(xs, micro_batch=2),
                 _float64_chain(enh, xs, True, 2))


@pytest.mark.parametrize("quantize", [True, False])
def test_outputs_of_one_call_stay_after_the_next(enhancers, quantize):
    enh = enhancers("block")
    first = enh.enhance_batch(_lanes(), quantize, micro_batch=2)
    kept = [a.copy() for a in first]
    # shorter lanes reuse the buffers, longer ones grow them
    for lengths in ((9 * SHIFT, 4 * SHIFT + 3), (60 * SHIFT, 45 * SHIFT)):
        enh.enhance_batch(_lanes(lengths, seed=7), quantize, micro_batch=2)
        _assert_same(first, kept)


@pytest.mark.gpu
def test_card_b64_int16_host_half_equals_the_float64_chain():
    """On the card, the block plan at full width and B=64: int16 lanes and
    integer-valued float64 lanes give the float64 chain's bits, the host
    buffers are page-locked, and two calls back to back with
    ``micro_batch=16`` keep the first call's outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    from se_snmf_nat_tpu_torch.headline import HEADLINE_PLAN
    dev = require_cuda()
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                       cfg.sep.r_d, seed=0)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, **HEADLINE_PLAN)
    rng = np.random.default_rng(18)
    sizes = [rng.integers(16000, 64000, 64) for _ in range(2)]
    calls = [[fixtures.noisy_utterance(int(n), seed=100 * k + i)
              for i, n in enumerate(lengths)]
             for k, lengths in enumerate(sizes)]
    want = [_float64_chain(enh, xs, True, None) for xs in calls]
    _assert_same(enh.enhance_batch([x.astype(np.int16) for x in calls[0]],
                                   micro_batch=None), want[0])
    _assert_same(enh.enhance_batch(calls[0], micro_batch=None), want[0])
    assert all(b.is_pinned() for b in enh._host_bufs.values())
    assert set(enh._host_bufs) == {"samples", "lanes", "pcm"}
    mb16 = [_float64_chain(enh, xs, True, 16) for xs in calls]
    first = enh.enhance_batch(calls[0], micro_batch=16)
    second = enh.enhance_batch([x.astype(np.int16) for x in calls[1]],
                               micro_batch=16)
    _assert_same(first, mb16[0])
    _assert_same(second, mb16[1])
