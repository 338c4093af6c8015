"""Training feature extraction (run_basis_train.m:59-78).

signal -> batch STFT (stft_fft.m semantics) -> drop unproduced all-zero
columns -> context splice -> ``.^pow + floor`` -> optional decision-directed
temporal smoothing -> mel projection per splice block.

Feature assembly is host-side NumPy (cheap, IO-adjacent); the NMF solve that
consumes the features runs on the card (train/basis.py).

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.dsp.mel import mel_matrix
from se_snmf_nat_tpu_torch.dsp.smoothing import tf_dd
from se_snmf_nat_tpu_torch.dsp.splice import frame_splice
from se_snmf_nat_tpu_torch.dsp.stft import stft_batch_train
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic


@dataclass
class TrainingFeatures:
    tf_mag: np.ndarray   # (n_bins*(2*splice+1), T) power features
    tf_mel: np.ndarray   # (f_order*(2*splice+1), T)


def training_features(s: np.ndarray, cfg: PipelineConfig,
                      dc_bin: int | None = None,
                      dd_alpha: float = 0.4) -> TrainingFeatures:
    sig = cfg.signal
    win = sqrt_hann_periodic(sig.framelength)
    mag, _ = stft_batch_train(
        s, sig.framelength, sig.frameshift, sig.fftlength,
        sig.dc_bin if dc_bin is None else dc_bin, win, sig.preemph)
    mag = mag[:, np.any(mag, axis=0)]          # drop all-zero columns
    mag = frame_splice(mag, cfg.sep.splice)
    mag = mag ** sig.pow + sig.nonzerofloor
    if cfg.train.domain_dd:
        mag = tf_dd(mag, dd_alpha)

    melmat = mel_matrix(sig.fs, sig.f_order, sig.fftlength, 1.0, sig.fs / 2).T
    n = sig.n_bins
    blocks = 2 * cfg.sep.splice + 1
    mel = np.zeros((sig.f_order * blocks, mag.shape[1]))
    for k in range(blocks):
        mel[k * sig.f_order: (k + 1) * sig.f_order] = \
            melmat @ mag[k * n: (k + 1) * n]
    return TrainingFeatures(tf_mag=mag, tf_mel=mel)
