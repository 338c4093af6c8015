"""Energy VAD for training-data silence stripping.

Reference: src/vadenergy_simple.m — background level from the first
``bg_len`` samples; 20 ms frames at 50% hop; a frame is voiced when its
relative mean-magnitude excess over the background exceeds ``thr``.  The
smoothing passes of src/vadenergy.m are dead code (commented out in the
simple variant and only reachable through the broken sil_remove.m) and are
not rebuilt (SURVEY §7.4).

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.
"""

from __future__ import annotations

import numpy as np


def energy_vad(x: np.ndarray, fs: int, bg_len: int | None = None,
               thr: float = 0.7) -> np.ndarray:
    """Per-sample 0/1 voiced mask (vadenergy_simple.m:1-33).

    The reference's frame loop marks samples [i, i+frame_len) voiced for
    every voiced 20 ms frame (frames overlap 50%, so a sample is voiced if
    EITHER covering frame fires).  Vectorized over frames.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    if bg_len is None:
        bg_len = int(0.05 * fs)  # 50 ms (run_basis_train.m:31)
    bg_mean = np.mean(np.abs(x[:bg_len]))

    frame_len = int(0.02 * fs)
    frame_shift = frame_len // 2
    n_frames = len(x) // frame_shift
    vad = np.zeros(len(x))
    if n_frames < 2:
        return vad
    starts = frame_shift * np.arange(n_frames - 1)
    # guard against the last frame running past the signal end exactly as
    # MATLAB would error there; the reference loop stops at frame_num-1 and
    # x(i:i+frame_len-1) always fits because frame_num = floor(len/shift)
    idx = starts[:, None] + np.arange(frame_len)[None, :]
    valid = idx[:, -1] < len(x)
    means = np.abs(x[idx[valid]]).mean(axis=1)
    fire = (means - bg_mean) / means > thr
    for s in starts[valid][fire]:
        vad[s: s + frame_len] = 1.0
    return vad


def apply_vad(x: np.ndarray, vad: np.ndarray) -> np.ndarray:
    """MATLAB ``nonzeros(s .* vad)``: keep samples where the product is
    nonzero — note a genuinely zero voiced sample is also dropped, matching
    the reference exactly (run_basis_train.m:37)."""
    prod = np.asarray(x, dtype=np.float64) * vad
    return prod[prod != 0.0]
