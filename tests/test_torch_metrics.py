"""The port's copy of the quality metrics (``se_snmf_nat_tpu_torch.metrics``)
gives the reference package's values bit for bit on seeded signals: every
metric and ``quality_report``, at 16 kHz and at 8 kHz (the LPC order
switches at 10 kHz), and the degenerate inputs (shorter than a frame, too
short for STOI).  The copy is also held statement for statement by
tests/test_torch_io.py."""

import numpy as np
import pytest

from se_snmf_nat_tpu import metrics as j_metrics
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch import metrics as t_metrics

METRICS = ("segmental_snr", "log_spectral_distance", "stoi", "llr",
           "itakura_saito", "cepstral_distance", "wss", "fw_seg_snr")


def _pair(seed, fs, seconds=2.0):
    n = int(seconds * fs)
    clean = fixtures.clean_utterance(n, seed=seed)
    deg = clean + fixtures.noise(n, seed=seed + 50, level=1500.0)
    return clean, deg


@pytest.mark.parametrize("fs", [16000, 8000])
@pytest.mark.parametrize("name", METRICS)
def test_metric_bit_equal(name, fs):
    clean, deg = _pair(1, fs)
    got = getattr(t_metrics, name)(clean, deg, fs)
    want = getattr(j_metrics, name)(clean, deg, fs)
    assert isinstance(got, float)
    assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("seed", [0, 3])
def test_quality_report_equal(seed):
    clean, deg = _pair(seed, 16000)
    got = t_metrics.quality_report(clean, deg, 16000)
    assert got == j_metrics.quality_report(clean, deg, 16000)
    assert got["stoi"] is not None and got["seg_snr_db"] is not None


def test_degenerate_inputs_as_the_reference():
    short = np.ones(100)
    for mod in (t_metrics, j_metrics):
        assert np.isnan(mod.segmental_snr(short, short, 16000))
        assert np.isnan(mod.log_spectral_distance(short, short, 16000))
        with pytest.raises(ValueError):
            mod.stoi(short, short, 16000)
    got = t_metrics.quality_report(short, short, 16000)
    assert got == j_metrics.quality_report(short, short, 16000)
    assert got["stoi"] is None
