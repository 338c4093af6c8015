"""The offline PMWF plan's operations and least bytes, for
``pmwf_roofline``: the covariance build, the solves and the filtering of a
lane of C channels, F bins and T true frames, in ``norm_period`` blocks,
counted from the traffic's true frames (the bins' neighbourhood of 2M + 1
shifts, the temporal box of 2L + 1 frames).  Each stage reads its inputs
once and writes its outputs once, complex values of ``cbytes`` bytes
(8: complex64).  Kept here so that a change to the program cannot change
the yardstick.

Operations (a complex product 6, a complex add 2, a complex product added
8):

* covariances: at every frame and bin the C x C outer products of the
  2M + 1 shifted spectra, summed (8 (2M + 1) C^2); the temporal box as a
  running sum and a difference (4 C^2); the frame's add into its block's
  sum (2 C^2); the init frames' add into Ncov (2 C^2 each);
* solves, a (block, bin): the Cholesky factor of C x C, (C^3 - C) / 6
  complex products added; the two substitutions with C right-hand sides,
  C^2 (C - 1) of them; 16 C^2 for Ecov = Ycov - Ncov, the load, the
  pivots' divisions and the scaling by 1 / (beta + trace);
* filtering: at every frame and bin, C outputs of C complex products
  added (8 C^2).

Least bytes: the spectra (C F T) read by the covariance build and by the
filtering, the block sums and Ncov written and read, the filters written
and read, the filtered spectra (C F T) written.
"""

from __future__ import annotations

import numpy as np


def pmwf_counts(lane_frames, f: int, c: int, m_nbr: int, l_nbr: int,
                init_n_len: int, norm_period: int,
                cbytes: int = 8) -> tuple[float, float]:
    t = np.asarray(lane_frames, np.float64).reshape(-1)
    nb = np.ceil(t / norm_period)
    n_init = np.minimum(t, init_n_len)
    c2 = c * c
    cov = t * f * c2 * (8 * (2 * m_nbr + 1) + 4 + 2) + n_init * f * c2 * 2
    solve = nb * f * (8 * ((c ** 3 - c) / 6 + c2 * (c - 1)) + 16 * c2)
    filt = t * f * 8 * c2
    flops = float(np.sum(cov + solve + filt))
    spectra = c * f * t * cbytes
    blocks = (nb + 1) * f * c2 * cbytes
    n_bytes = float(np.sum(2 * spectra + 2 * blocks + 2 * nb * f * c2
                           * cbytes + spectra))
    return flops, n_bytes
