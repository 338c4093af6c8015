"""Temporal smoothing primitives.

tf_dd: first-order decision-directed smoothing along time
(src/TF_DD.m: X[l] = a*X[l-1] + (1-a)*X[l], X[0] unchanged).

``tf_dd`` is the port's own copy of the reference package's NumPy function
(training path, (K, T) layout), held equal to it by tests/test_torch_io.py;
``tf_dd_torch`` is the counterpart of its ``tf_dd_jax``, in the same
time-major (T, K) layout.
"""

from __future__ import annotations

import numpy as np
import torch


def tf_dd(x: np.ndarray, alpha: float) -> np.ndarray:
    """NumPy reference (training path; (K, T) layout like the MATLAB)."""
    out = np.array(x, dtype=np.float64, copy=True)
    for l in range(1, out.shape[1]):
        out[:, l] = alpha * out[:, l - 1] + (1.0 - alpha) * x[:, l]
    return out


def tf_dd_torch(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """(T, ...) time-major version on the tensor's device: y[0] = x[0],
    y[t] = alpha*y[t-1] + (1-alpha)*x[t], one step a frame (the same
    operations in the same order as ``tf_dd``)."""
    out = x.clone()
    for t in range(1, x.shape[0]):
        out[t] = alpha * out[t - 1] + (1.0 - alpha) * x[t]
    return out
