"""The OM-LSA/IMCRA constants and windows: the port's own copy of the
parameter half of the reference package's float64 oracle
(``oracle/imcra_np.py``: ``_iround``, ``matlab_hanning``, ``matlab_hamming``,
``ImcraParams``, ``imcra_windows``), held equal to it statement for
statement by the tests.  NumPy only.

Reference: proc_IMCRA.m (Cohen 2003 "omlsa3").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_round


def _iround(x) -> int:
    """int(MATLAB round(x)): half AWAY from zero (Python round is
    half-to-even) for parameter derivations — parity on .5 boundaries."""
    return int(matlab_round(np.asarray(float(x))))


def matlab_hanning(n: int) -> np.ndarray:
    """MATLAB hanning(n): Hann without zero endpoints."""
    k = np.arange(1, n + 1)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (n + 1)))


def matlab_hamming(n: int) -> np.ndarray:
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


@dataclass(frozen=True)
class ImcraParams:
    """proc_IMCRA.m:26-66 constants (at the 16 kHz reference rate)."""

    m: int = 512                 # analysis window
    mo: int = 384                # overlap (75%)
    w: int = 1                   # spectral smoothing half-width
    alpha_s: float = 0.9
    nwin: int = 8                # minima-search resolution (sub-windows)
    vwin: int = 15               # frames per sub-window
    delta_s: float = 1.67
    bmin: float = 1.66
    delta_y: float = 4.6
    delta_yt: float = 3.0
    alpha_d: float = 0.85
    alpha_d_long: float = 0.99
    alpha_xi: float = 0.7
    w_xi_local: int = 1
    w_xi_global: int = 15
    f_u: float = 10e3
    f_l: float = 50.0
    p_min: float = 0.005
    xi_lu_db: float = -5.0
    xi_ll_db: float = -10.0
    xi_gu_db: float = -5.0
    xi_gl_db: float = -10.0
    xi_fu_db: float = -5.0
    xi_fl_db: float = -10.0
    xi_mu_db: float = 10.0
    xi_ml_db: float = 0.0
    q_max: float = 0.998
    alpha_eta: float = 0.95
    eta_min_db: float = -18.0
    broad_flag: bool = True
    tone_flag: bool = True
    nonstat: str = "medium"      # 'low' | 'medium' | 'high'
    zero_thres: float = 1e-10
    fs: int = 16000

    @property
    def mno(self) -> int:
        return self.m - self.mo

    @property
    def m21(self) -> int:
        return self.m // 2 + 1

    @property
    def eta_min(self) -> float:
        return 10.0 ** (self.eta_min_db / 10.0)

    @property
    def g_f(self) -> float:
        return self.eta_min ** 0.5


def imcra_windows(p: ImcraParams) -> tuple[np.ndarray, np.ndarray]:
    """(analysis window, synthesis window) — proc_IMCRA.m:93-106,353.

    MATLAB normalizes hamming(M) by the OLA power factor W0 and energy Cwin,
    then synthesizes with Cwin^2*win; net effect: analysis = win/(W0*Cwin),
    synthesis = Cwin^2 * analysis."""
    win = matlab_hamming(p.m)
    win2 = win * win
    mno = p.mno
    w0 = win2[:mno].copy()
    for k in range(mno, p.m, mno):
        w0 += np.roll(win2, -k)[:mno]
    w0 = np.mean(w0) ** 0.5
    win = win / w0
    cwin = np.sum(win * win) ** 0.5
    win = win / cwin
    return win, cwin * cwin * win
