"""Rational sample-rate conversion (src/func/srconv.m rebuild).

The reference resamples via MATLAB resample with lcm-derived up/down
factors (srconv.m:14-22); here scipy's polyphase resampler does the same
rational conversion.  Host-side utility (IO-adjacent).

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py."""

from __future__ import annotations

from math import gcd

import numpy as np


def srconv(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Resample x from fs_in to fs_out (rational polyphase)."""
    if fs_in == fs_out:
        return np.asarray(x, np.float64)
    from scipy.signal import resample_poly
    g = gcd(int(fs_in), int(fs_out))
    return resample_poly(np.asarray(x, np.float64),
                         fs_out // g, fs_in // g)
