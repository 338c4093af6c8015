"""The MMSE / minimum-statistics constants: the port's own copy of the
parameter half of the reference package's float64 oracle
(``oracle/ms_np.py``: ``_iround``, ``MsParams``, ``MsDerived``,
``_MH_TABLE``, ``mhvals``, ``ms_derived``, ``MsgParams``), held equal to it
statement for statement by the tests.  NumPy only.

Reference: src/MS/ssubmmse.m, src/MS/estnoisem.m and src/MS/estnoiseg.m
(the GUI's 'MS' mode with init_MS.m's ti=0.01 override).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_round


def _iround(x) -> int:
    """int(MATLAB round(x)): half AWAY from zero (Python round is
    half-to-even) for parameter derivations — parity on .5 boundaries."""
    return int(matlab_round(np.asarray(float(x))))


@dataclass(frozen=True)
class MsParams:
    """ssubmmse.m:108-120 + estnoisem.m:110-124 defaults, with the
    init_MS.m frame-increment override (ti=0.01)."""

    # gain parameters
    of: int = 2                 # overlap factor (fftlen / increment)
    ti: float = 0.01            # frame increment seconds (init_MS.m:1)
    ta: float = 0.396           # SNR smoothing time constant
    gx: float = 1000.0          # max posterior SNR
    xn: float = 0.0             # min prior SNR
    lg: int = 1                 # 1: log-MMSE, 0: amplitude MMSE
    bt: float = -1.0            # binary gain threshold (-1: continuous)
    mx: float = 0.0             # input mixture gain
    # minimum-statistics noise tracker parameters
    taca: float = 0.0449
    tamax: float = 0.392
    taminh: float = 0.0133
    tpfall: float = 0.064
    tbmax: float = 0.0717
    qeqmin: float = 2.0
    qeqmax: float = 14.0
    av: float = 2.12
    td: float = 1.536
    nu: int = 8
    qith: tuple = (0.03, 0.05, 0.06, np.inf)
    nsmdb: tuple = (47.0, 31.4, 15.7, 4.1)


@dataclass
class MsDerived:
    """Constants derived from (params, fs) — shared by oracle and JAX."""

    ni: int; nf: int; tinc: float; a: float
    aca: float; amax: float; aminh: float; bmax: float; snrexp: float
    nv: int; nd: int; md: float; hd: float; mv: float; hv: float
    nsms: np.ndarray; qeqimax: float; qeqimin: float
    win: np.ndarray = field(default=None)


_MH_TABLE = np.array([
    [1, 0, 0], [2, 0.26, 0.15], [5, 0.48, 0.48], [8, 0.58, 0.78],
    [10, 0.61, 0.98], [15, 0.668, 1.55], [20, 0.705, 2], [30, 0.762, 2.3],
    [40, 0.8, 2.52], [60, 0.841, 3.1], [80, 0.865, 3.38], [120, 0.89, 4.15],
    [140, 0.9, 4.35], [160, 0.91, 4.25], [180, 0.92, 3.9], [220, 0.93, 4.1],
    [260, 0.935, 4.7], [300, 0.94, 5]])


def mhvals(d: int) -> tuple[float, float]:
    """M(D), H(D) sqrt-interpolated from Martin 2006 Table 5
    (estnoisem.m:282-329)."""
    dm = _MH_TABLE
    idx = np.nonzero(d <= dm[:, 0])[0]
    if len(idx) == 0:
        i = len(dm) - 1
        j = i
    else:
        i = int(idx[0])
        j = i - 1
    if d == dm[i, 0]:
        return float(dm[i, 1]), float(dm[i, 2])
    qj, qi, q = np.sqrt(dm[i - 1, 0]), np.sqrt(dm[i, 0]), np.sqrt(d)
    h = dm[i, 2] + (q - qi) * (dm[j, 2] - dm[i, 2]) / (qj - qi)
    m = dm[i, 1] + (qi * qj / q - qj) * (dm[j, 1] - dm[i, 1]) / (qi - qj)
    return float(m), float(h)


def ms_derived(p: MsParams, fs: int) -> MsDerived:
    ni = _iround(p.ti * fs)
    nf = ni * _iround(p.of)
    tinc = ni / fs
    nv = _iround(p.td / (tinc * p.nu))
    nu = p.nu
    if nv < 4:
        nv = 4
        nu = max(_iround(p.td / (tinc * nv)), 1)
    nd = nu * nv
    md, hd = mhvals(nd)
    mv, hv = mhvals(nv)
    # analysis/synthesis window: sqrt(hamming(nf+1)) minus last sample,
    # normalized for unit OLA gain (ssubmmse.m:148-150)
    k = np.arange(nf + 1)
    ham = 0.54 - 0.46 * np.cos(2.0 * np.pi * k / nf)
    w = np.sqrt(ham[:nf])
    w = w / np.sqrt(np.sum(w[0:nf:ni] ** 2))
    # scalar fields as PYTHON floats (weak-typed in JAX): np.float64
    # scalars would silently promote float32 scan carries to float64 when
    # x64 is enabled, breaking the jitted MS step's carry invariant
    d = MsDerived(
        ni=ni, nf=nf, tinc=tinc, a=float(np.exp(-tinc / p.ta)),
        aca=float(np.exp(-tinc / p.taca)),
        amax=float(np.exp(-tinc / p.tamax)),
        aminh=float(np.exp(-tinc / p.taminh)),
        bmax=float(np.exp(-tinc / p.tbmax)),
        snrexp=float(-tinc / p.tpfall), nv=nv, nd=nd, md=md, hd=hd,
        mv=mv, hv=hv,
        nsms=10.0 ** (np.asarray(p.nsmdb) * nv * tinc / 10.0),
        qeqimax=float(1.0 / p.qeqmin), qeqimin=float(1.0 / p.qeqmax), win=w)
    d.nu_eff = nu
    return d


@dataclass(frozen=True)
class MsgParams:
    """estnoiseg.m:86-94 defaults."""

    tax: float = 0.0717     # noise output smoothing time constant (8)
    tap: float = 0.152      # speech-prob smoothing time constant (23)
    psthr: float = 0.99     # smoothed speech-prob threshold (24)
    pnsaf: float = 0.01     # noise probability safety value (24)
    pspri: float = 0.5      # prior speech probability (18)
    asnr: float = 15.0      # active SNR in dB (18)
    psini: float = 0.5      # initial speech probability (23)
    tavini: float = 0.064   # assumed speech-absent time at start

