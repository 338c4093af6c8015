"""The port's NumPy copy of the mel filterbank against the JAX package's
(the same NumPy code, so bit-equal), at the Mel separation mode's shape and
at others."""

import numpy as np
import pytest

from se_snmf_nat_tpu.dsp.mel import mel_matrix as j_mel_matrix
from se_snmf_nat_tpu_torch.dsp.mel import mel_matrix


@pytest.mark.parametrize("fs,nb_ch,nfft,warp,fhigh", [
    (16000, 64, 1024, 1.0, 8000.0),      # signal.f_order at the live config
    (16000, 40, 512, 1.0, None),
    (8000, 24, 256, 1.0, 3800.0),
    (16000, 32, 1024, 1.0, 4000.0),
])
def test_mel_matrix_bit_equal(fs, nb_ch, nfft, warp, fhigh):
    got = mel_matrix(fs, nb_ch, nfft, warp, fhigh)
    want = j_mel_matrix(fs, nb_ch, nfft, warp, fhigh)
    assert got.shape == (nfft // 2 + 1, nb_ch)
    np.testing.assert_array_equal(got, want)
    assert np.all(got.sum(0) > 0)
