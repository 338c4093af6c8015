"""The benchmark's fixed arithmetic: the card's published peaks, the
operation and byte counts of the kernels and transforms its metrics divide
by, and interval arithmetic over trace events.

The counts are copies of the ones the program's smoke script uses (K1 and
G at the block plan's shapes, the stacked-matmul DFT a frame), kept here so
that a change to the program cannot change the yardstick.
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM, HBM3
G_OPS = 20                  # float operations a (lane, frame, bin) of G


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card can take: the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def k1_counts(b: int, f: int, r: int, n: int, trips: int):
    """K1, the H-solve of B lanes of N columns over an (F, R) dictionary a
    lane: two products of 2 F R N operations a trip; V, W, H0 read once,
    H and the trip counts written once (float32)."""
    flops = 4.0 * f * r * n * trips * b
    n_bytes = 4.0 * (b * f * n + b * f * r + r * n + b * r * n + b * n)
    return flops, n_bytes


def g_counts(b: int, k: int, f: int):
    """G, the gain scan of a K-frame block over B lanes, as the block step
    calls it: four distinct (B, K, F) spectra, three per-frame statistics,
    the flags, the K int64 frame numbers and the carries read once; two
    (B, K, F) spectra, the triggers, the carries and the refit's gate
    statistics written once."""
    reads = 16 * b * k * f + 12 * b * k + b * k + 8 * k + 8 * b * f \
        + 4 * b + b
    writes = 8 * b * k * f + b * k + 8 * b * f + 13 * b
    return float(G_OPS * b * k * f), float(reads + writes)


def dft_flops(framelength: int, n_bins: int) -> float:
    """One frame's analysis or synthesis as a product with the stacked
    (framelength, 2F) DFT matrix."""
    return 2 * (2.0 * framelength * n_bins)


def block_call_flops(true_frames, f: int, r: int, framelength: int,
                     trips: int) -> float:
    """The useful operations of one block-plan call: for every true frame
    of every lane the analysis DFT, K1's trips on its column, the speech
    and noise reconstructions, and the synthesis DFT (K2's refits are left
    out until the program reports its trips).  Padding frames are not
    useful work."""
    frames = float(np.sum(true_frames))
    per_frame = 2 * dft_flops(framelength, f) + 4.0 * f * r * trips \
        + 2.0 * f * r
    return frames * per_frame


# ---------------------------------------------------------------- intervals

def merge(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The union of intervals as sorted disjoint (n, 2) rows."""
    if len(starts) == 0:
        return np.zeros((0, 2))
    order = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts)[order], np.asarray(ends)[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:], len(s)) - 1
    return np.stack([s[idx], run_end[last]], axis=1)


def covered(union: np.ndarray, lo: float, hi: float) -> float:
    """Seconds of [lo, hi) covered by the disjoint sorted intervals."""
    if hi <= lo or len(union) == 0:
        return 0.0
    a = np.clip(union[:, 0], lo, hi)
    b = np.clip(union[:, 1], lo, hi)
    return float(np.sum(b - a))


def covered_many(union: np.ndarray, spans: np.ndarray) -> np.ndarray:
    """``covered`` for each (lo, hi) row of ``spans``, via prefix sums."""
    if len(spans) == 0:
        return np.zeros(0)
    if len(union) == 0:
        return np.zeros(len(spans))
    cum = np.concatenate([[0.0], np.cumsum(union[:, 1] - union[:, 0])])

    def upto(t):
        i = np.searchsorted(union[:, 0], t, side="right")
        j = np.maximum(i - 1, 0)
        part = np.where(i > 0, np.clip(t - union[j, 0], 0,
                                       union[j, 1] - union[j, 0]), 0.0)
        return cum[j] * (i > 0) + part

    return upto(spans[:, 1]) - upto(spans[:, 0])


def count_within(starts: np.ndarray, spans: np.ndarray) -> np.ndarray:
    """How many of the sorted ``starts`` fall in each (lo, hi) span."""
    return (np.searchsorted(starts, spans[:, 1], side="left")
            - np.searchsorted(starts, spans[:, 0], side="left"))

