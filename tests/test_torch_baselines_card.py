"""The three baseline enhancers on the card against their CPU runs (marked
``gpu``: they skip without a CUDA card).  This file imports no JAX, so it
runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_baselines_card.py

In float64 the card's output is within 1e-9 relative of the CPU's with
identical int16; in float32 a lane of a batch gives the int16 of the same
utterance alone, and the MMSE enhancer's chunks give its one-shot output.
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    return require_cuda()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _xs():
    return [fixtures.noisy_utterance(16000, seed=i) for i in range(3)]


def _hold(make):
    dev = _card()
    xs = _xs()
    card, cpu = make(torch.float64, dev), make(torch.float64, "cpu")
    assert _rel(card.enhance(xs[0], quantize=False),
                cpu.enhance(xs[0], quantize=False)) <= 1e-9
    np.testing.assert_array_equal(card.enhance(xs[0]), cpu.enhance(xs[0]))
    for g, w in zip(card.enhance_batch(xs[:2]), cpu.enhance_batch(xs[:2])):
        np.testing.assert_array_equal(g, w)
    card32 = make(torch.float32, dev)
    ys = card32.enhance_batch(xs)
    for y, x in zip(ys, xs):
        np.testing.assert_array_equal(y, card32.enhance(x))
    return card32, xs


@pytest.mark.gpu
def test_omlsa_on_the_card_matches_the_cpu():
    from se_snmf_nat_tpu_torch.enhance.imcra import OmlsaEnhancer
    _hold(lambda dt, d: OmlsaEnhancer(dtype=dt, device=d))


@pytest.mark.gpu
@pytest.mark.parametrize("tracker,lg", [("martin", 1), ("martin", 0),
                                        ("mmse", 1)])
def test_mmse_on_the_card_matches_the_cpu(tracker, lg):
    from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
    from se_snmf_nat_tpu_torch.enhance.ms_params import MsParams
    enh, xs = _hold(lambda dt, d: MmseEnhancer(
        params=MsParams(lg=lg), dtype=dt, tracker=tracker, device=d))
    st, parts = None, []
    for i in range(0, len(xs[0]), 1600):
        y, st = enh.enhance(xs[0][i: i + 1600], state=st, return_state=True)
        parts.append(y)
    got = np.concatenate(parts)
    np.testing.assert_array_equal(got, enh.enhance(xs[0])[: len(got)])


@pytest.mark.gpu
def test_bnmf_on_the_card_matches_the_cpu():
    from se_snmf_nat_tpu_torch.bnmf import (
        BnmfEnhancer, BnmfModel, BnmfParams, BnmfStreamingSession,
        GammaPost, train_speech_model)
    from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
    dev = _card()
    p = BnmfParams(k_speech=12, train_iters=30, noise_init_iters=50,
                   n_infer=10)
    speech = fixtures.speechlike(16000, seed=3)
    x = fixtures.noisy_utterance(24000, seed=0)
    models = {d: train_speech_model(speech, p, dtype=torch.float64,
                                    device=d)[0] for d in (dev, "cpu")}
    assert _rel(models[dev].w.shape.cpu().numpy(),
                models["cpu"].w.shape.numpy()) <= 1e-9
    m = models["cpu"]
    enh = {d: BnmfEnhancer(BnmfModel(GammaPost(m.w.shape.to(d),
                                               m.w.scale.to(d)),
                                     m.u0.to(d)),
                           params=p, dtype=torch.float64, device=d)
           for d in (dev, "cpu")}
    got = enh[dev].enhance(x, quantize=False)
    want = enh["cpu"].enhance(x, quantize=False)
    assert _rel(got, want) <= 1e-9
    np.testing.assert_array_equal(enhanced_quantize(got),
                                  enhanced_quantize(want))
    card32 = BnmfEnhancer(BnmfModel(GammaPost(m.w.shape.to(dev).float(),
                                              m.w.scale.to(dev).float()),
                                    m.u0.to(dev).float()),
                          params=p, device=dev)
    offline = card32.enhance(x)
    for bf in (1, 8):
        sess = BnmfStreamingSession(card32, block_frames=bf)
        parts = [sess.push(x[i: i + 160]) for i in range(0, len(x), 160)]
        parts.append(sess.flush())
        np.testing.assert_array_equal(np.concatenate(parts), offline)
