"""``PmwfEnhancer.enhance_batch`` on the card (marked ``gpu``: it skips
without a CUDA card): each lane of 64 six-channel utterances of different
lengths gives the bits of ``enhance`` on that lane alone in float32, in
one chunk and in chunks of 7; in float64 too, and the int16 of the CPU's
float64 run.  This file imports no JAX, so it runs on a machine that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_pmwf_batch_card.py
"""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
from se_snmf_nat_tpu_torch.multichannel.pmwf import PmwfEnhancer

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    return require_cuda()


def _lanes(n_lanes, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(rng.integers(1600, 56000, n_lanes)):
        x, _ = synth_mixture(n=int(n), n_ch=6, seed=100 + i)
        out.append(np.clip(np.rint(x * 9000.0), -32768, 32767)
                   .astype(np.int16))
    return out


@pytest.mark.gpu
def test_lanes_on_the_card_give_the_bits_of_single_lanes_float32():
    dev = _card()
    enh = PmwfEnhancer(device=dev)
    xs = _lanes(64)
    whole = enh.enhance_batch(xs, micro_batch=None)
    sevens = enh.enhance_batch(xs, micro_batch=7)
    for x, a, b in zip(xs, whole, sevens):
        one = enh.enhance(x)
        np.testing.assert_array_equal(a, one)
        np.testing.assert_array_equal(b, one)


@pytest.mark.gpu
def test_lanes_on_the_card_in_float64_and_against_the_cpu():
    dev = _card()
    xs = _lanes(6, seed=1)
    card = PmwfEnhancer(dtype=torch.float64, device=dev)
    got = card.enhance_batch(xs, micro_batch=4)
    cpu = PmwfEnhancer(dtype=torch.float64, device="cpu").enhance_batch(xs)
    for x, g, c in zip(xs, got, cpu):
        np.testing.assert_array_equal(g, card.enhance(x))
        np.testing.assert_array_equal(g, c)
