"""Triangular mel filterbank matching src/mel_matrix.m exactly (NumPy copy of
``se_snmf_nat_tpu.dsp.mel``: that package's ``dsp`` loads JAX on import).

Returns the (n_bins, nb_ch) dense matrix; callers transpose for the
(nb_ch, n_bins) projection of the Mel separation mode.
"""

from __future__ import annotations

import numpy as np

from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_round


def mel_matrix(fs: int, nb_ch: int, nfft: int, warp: float = 1.0,
               fhigh: float | None = None) -> np.ndarray:
    if fhigh is None:
        fhigh = fs / 2
    low_mel = 2595.0 * np.log10(1.0 + 64.0 / 700.0)
    nyq_mel = 2595.0 * np.log10(1.0 + fhigh / 700.0)

    k = np.arange(nb_ch, dtype=np.float64)
    start_mel = low_mel + k / (nb_ch + 1) * (nyq_mel - low_mel)
    f_cen = warp * 700.0 * (10.0 ** (start_mel / 2595.0) - 1.0)
    start_bin = matlab_round(nfft / fs * f_cen).astype(int) + 1  # 1-based

    end_mel = low_mel + (k + 2) / (nb_ch + 1) * (nyq_mel - low_mel)
    end_bin = matlab_round(
        warp * nfft / fs * 700.0 * (10.0 ** (end_mel / 2595.0) - 1.0)
    ).astype(int) + 1

    tot_len = end_bin - start_bin + 1
    low_len = np.concatenate([start_bin[1:nb_ch], end_bin[nb_ch - 2:nb_ch - 1]])
    low_len = low_len - start_bin + 1
    hi_len = tot_len - low_len + 1

    full_rows = int(np.ceil(warp * nfft / 2 + 1))
    m = np.zeros((full_rows, nb_ch))
    for c in range(nb_ch):
        sb = start_bin[c]
        ll = int(low_len[c])
        # rising ramp over rows sb..sb+ll-1 (1-based)
        m[sb - 1: sb - 1 + ll, c] = np.arange(1, ll + 1) / ll
        eb = end_bin[c]
        hl = int(hi_len[c])
        # falling ramp over rows eb-hl+1..eb (1-based); overwrites the peak
        # row exactly as MATLAB's second assignment does
        m[eb - hl: eb, c] = np.arange(hl, 0, -1) / hl
    return m[: nfft // 2 + 1, :]
