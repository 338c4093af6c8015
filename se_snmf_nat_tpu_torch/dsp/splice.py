"""Context splicing (src/frame_splice.m): stack +-splice neighbor frames into
supervectors, zero-padded at sequence edges.

Layout matches the reference: output row block k (k = 0..2*splice) holds
frame t + (k - splice); block index splice is the center frame.

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.
"""

from __future__ import annotations

import numpy as np


def frame_splice(feat: np.ndarray, splice: int) -> np.ndarray:
    """(K, T) -> ((2*splice+1)*K, T)."""
    if splice == 0:
        return feat
    k, t = feat.shape
    blocks = []
    for s in range(-splice, splice + 1):
        shifted = np.zeros_like(feat)
        if s < 0:
            shifted[:, -s:] = feat[:, :t + s]
        elif s > 0:
            shifted[:, :t - s] = feat[:, s:]
        else:
            shifted = feat
        blocks.append(shifted)
    return np.concatenate(blocks, axis=0)
