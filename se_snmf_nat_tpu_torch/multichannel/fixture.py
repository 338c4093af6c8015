"""Deterministic synthetic multichannel fixture (NumPy).

The port's own copy of the reference package's ``multichannel/fixture.py``,
held statement for statement equal to it by tests/test_torch_io.py.  No
multichannel golden exists (the reference's PMWF path is dead code), so
quality is pinned on a seeded synthetic scene with a KNOWN clean source.

Scene: a directional two-tone 'speech' source with per-channel gains and
integer-sample inter-channel delays (a crude far-field array), over
independent diffuse Gaussian noise per channel; the first >=0.35 s is
noise-only — the init period the PMWF freezes its noise covariance from
(src/NTF_sep_event_RT.m:91-96).
"""

from __future__ import annotations

import numpy as np


def synth_mixture(n: int = 24000, n_ch: int = 6, seed: int = 0,
                  snr: float = 1.0, fs: int = 16000):
    """Returns (x (C, n) int16-scale mixture, src (n,) clean source)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    burst = (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 950 * t))
    env = (np.sin(2 * np.pi * 1.3 * t) > 0.2).astype(float)
    env[: int(0.35 * fs)] = 0.0             # noise-only init period
    src = burst * env * 8000.0 * snr
    x = np.zeros((n_ch, n))
    for j in range(n_ch):
        d = j * 3                           # inter-channel delay (samples)
        x[j, d:] = src[: n - d] * (1.0 - 0.08 * j)
        x[j] += rng.standard_normal(n) * 2000.0
    return np.clip(x, -32768, 32767), src


def segsnr_vs_source(y: np.ndarray, src: np.ndarray, fs: int = 16000,
                     seg_ms: float = 32.0, max_lag: int = 800) -> float:
    """Segmental SNR of y against the known clean source, maximized over
    alignment lags and per-segment gain (the beamformer output carries the
    L-frame lookahead lag and an arbitrary broadband scale)."""
    y = np.asarray(y, np.float64).reshape(-1)
    seg = int(seg_ms / 1000 * fs)
    best = -np.inf
    for lag in range(0, max_lag, 40):
        a = y[lag: lag + len(src) - max_lag]
        b = src[: len(a)]
        n_seg = len(a) // seg
        vals = []
        for i in range(n_seg):
            sa, sb = a[i * seg: (i + 1) * seg], b[i * seg: (i + 1) * seg]
            pb = float(sb @ sb)
            if pb < 1e-6:                   # skip silent segments
                continue
            g = float(sa @ sb) / max(float(sa @ sa), 1e-12)
            e = g * sa - sb
            vals.append(10 * np.log10(pb / max(float(e @ e), 1e-12)))
        if vals:
            v = float(np.clip(np.asarray(vals), -10, 35).mean())
            best = max(best, v)
    return best
