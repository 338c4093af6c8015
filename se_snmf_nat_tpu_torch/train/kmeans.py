"""Cityblock k-means rank reduction for exemplar over-sampled dictionaries.

Reference: run_basis_train.m:118-134 — kmeans(B', R, 'distance','cityblock',
'emptyaction','singleton', 'onlinephase','off', 'start','cluster'); then the
column closest to each centroid is kept (min over points of the point-to-
centroid distance matrix).

MATLAB's cityblock k-means updates centroids as the componentwise MEDIAN
(the L1 Fermat point per coordinate), batch phase only.  'start','cluster'
initializes by recursively clustering a 10% random subsample.  The RNG
stream cannot be reproduced (MATLAB's kmeans consumes the global stream in
an implementation-defined pattern), so this implementation is seeded
explicitly — deterministic for this framework, documented as not bit-equal
to MATLAB.  Only reachable when cfg.train.cluster_buff > 1 (exemplar
presets); dictionaries trained here never need to match reference .mat
fixtures.

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.
"""

from __future__ import annotations

import numpy as np


def _cityblock(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise L1 distances: (n, d) x (k, d) -> (n, k)."""
    return np.abs(a[:, None, :] - b[None, :, :]).sum(axis=2)


def kmeans_cityblock(points: np.ndarray, k: int, *,
                     rng: np.random.Generator,
                     max_iter: int = 100,
                     init_centers: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch Lloyd iterations with L1 distance and median centroid updates.

    Returns (labels (n,), centers (k, d), dist (n, k))."""
    n = len(points)
    if init_centers is None:
        if n > 10 * k:
            # 'start','cluster': cluster a 10% subsample first
            sub = rng.choice(n, size=max(k, n // 10), replace=False)
            _, init_centers, _ = kmeans_cityblock(
                points[sub], k, rng=rng, max_iter=max_iter)
        else:
            # k-means++-style D-weighted seeding (more robust than MATLAB's
            # plain 'sample' and still deterministic under the given rng)
            first = int(rng.integers(n))
            chosen = [first]
            d = _cityblock(points, points[first: first + 1])[:, 0]
            for _ in range(k - 1):
                w = d * d
                tot = w.sum()
                probs = w / tot if tot > 0 else np.full(n, 1.0 / n)
                nxt = int(rng.choice(n, p=probs))
                chosen.append(nxt)
                d = np.minimum(
                    d, _cityblock(points, points[nxt: nxt + 1])[:, 0])
            init_centers = points[chosen]
    centers = np.array(init_centers, dtype=np.float64, copy=True)
    labels = np.full(n, -1)
    for _ in range(max_iter):
        dist = _cityblock(points, centers)
        new_labels = dist.argmin(axis=1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(k):
            members = points[labels == c]
            if len(members) == 0:
                # 'emptyaction','singleton': move to the farthest point
                far = dist.min(axis=1).argmax()
                centers[c] = points[far]
                labels[far] = c
            else:
                centers[c] = np.median(members, axis=0)
    dist = _cityblock(points, centers)
    return labels, centers, dist


def kmeans_reduce(b_primary: np.ndarray, k: int, *,
                  rng: np.random.Generator | None = None
                  ) -> np.ndarray:
    """Pick k representative column indices of an over-complete dictionary.

    b_primary: (dim, cluster_buff*R) — the reference clusters the MEL basis
    and applies the same column selection to both domains
    (run_basis_train.m:120-130); pass B_Mel here and index both with the
    result.  Returns the indices of the columns nearest each centroid.
    """
    rng = rng or np.random.default_rng(1)
    _, _, dist = kmeans_cityblock(b_primary.T, k, rng=rng)
    return dist.argmin(axis=0)  # [~, Dmin_idx] = min(D): closest point per centroid
