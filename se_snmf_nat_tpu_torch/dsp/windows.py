"""Analysis/synthesis windows (a copy of the JAX package's NumPy module,
which cannot be imported without JAX because its package imports the JAX
STFT).

The live config uses sqrt(hann(N, 'periodic')) for both analysis and
synthesis; with 75% overlap and overlapscale = 2*hop/frame = 0.5 this gives
perfect reconstruction.
"""

from __future__ import annotations

import numpy as np


def hann_periodic(n: int) -> np.ndarray:
    """MATLAB hann(n, 'periodic') = 0.5*(1 - cos(2*pi*k/n)), k=0..n-1."""
    k = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))


def sqrt_hann_periodic(n: int) -> np.ndarray:
    return np.sqrt(hann_periodic(n))
