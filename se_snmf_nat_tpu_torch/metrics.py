"""Objective speech-quality metrics.

The reference repo carries no evaluation code (quality tables live in the
paper, SURVEY §6); this module supplies the standard objective metrics the
paper reports around — segmental SNR, log-spectral distance, STOI
(Taal et al. 2010 short-time objective intelligibility), and the classic
Hu & Loizou (IEEE TASLP 2008, "Evaluation of Objective Quality Measures
for Speech Enhancement") LPC/critical-band battery: log-likelihood ratio
(LLR), Itakura-Saito distance, cepstral distance, weighted spectral slope
(Klatt 1982), and frequency-weighted segmental SNR — so campaigns can be
scored without external tooling.  PESQ (and therefore the Csig/Cbak/Covl
composites regressed on it) is deliberately absent: ITU-T P.862 is a
licensed codebase, not a formula.  NumPy implementations, host-side.

The port's own copy of the reference package's module of the same name,
held equal to it statement for statement by tests/test_torch_io.py.
"""

from __future__ import annotations

import numpy as np


def _frames(x: np.ndarray, n: int, hop: int) -> np.ndarray:
    t = max((len(x) - n) // hop + 1, 0)
    idx = hop * np.arange(t)[:, None] + np.arange(n)[None, :]
    return x[idx]


def segmental_snr(ref: np.ndarray, deg: np.ndarray, fs: int,
                  frame_ms: float = 32.0, floor_db: float = -10.0,
                  ceil_db: float = 35.0) -> float:
    """Classic time-domain segmental SNR over energetic frames, clamped to
    [-10, 35] dB per frame."""
    n = min(len(ref), len(deg))
    ref, deg = np.asarray(ref, float)[:n], np.asarray(deg, float)[:n]
    fl = int(frame_ms * fs / 1000)
    rf = _frames(ref, fl, fl // 2)
    df = _frames(deg, fl, fl // 2)
    if rf.shape[0] == 0:          # shorter than one frame: undefined
        return float("nan")
    e_ref = np.sum(rf * rf, axis=1)
    e_err = np.sum((rf - df) ** 2, axis=1)
    keep = e_ref > 1e-8 * e_ref.max()
    snr = 10.0 * np.log10(e_ref[keep] / np.maximum(e_err[keep], 1e-12))
    return float(np.clip(snr, floor_db, ceil_db).mean())


def log_spectral_distance(ref: np.ndarray, deg: np.ndarray, fs: int,
                          nfft: int = 512) -> float:
    """RMS log-spectral distance (dB) over active frames."""
    n = min(len(ref), len(deg))
    ref, deg = np.asarray(ref, float)[:n], np.asarray(deg, float)[:n]
    hop = nfft // 2
    win = np.hanning(nfft)
    if len(ref) < nfft:           # shorter than one frame: undefined
        return float("nan")
    rf = np.abs(np.fft.rfft(_frames(ref, nfft, hop) * win, axis=1)) ** 2
    df = np.abs(np.fft.rfft(_frames(deg, nfft, hop) * win, axis=1)) ** 2
    e = rf.sum(axis=1)
    keep = e > 1e-6 * e.max()
    lr = 10.0 * np.log10(np.maximum(rf[keep], 1e-12))
    ld = 10.0 * np.log10(np.maximum(df[keep], 1e-12))
    return float(np.mean(np.sqrt(np.mean((lr - ld) ** 2, axis=1))))


# ---------------------------------------------------------------------------
# STOI (Taal, Hendriks, Heusdens, Jensen 2010)
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_NFFT = 512
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_SEG = 30          # frames per segment (384 ms)
_STOI_BETA_DB = -15.0   # clipping SDR bound
_STOI_DYN_DB = 40.0     # silent-frame removal threshold


def _thirdoct_matrix(fs: int, nfft: int, n_bands: int, cf_min: float = 150.0
                     ) -> np.ndarray:
    f = np.linspace(0, fs / 2, nfft // 2 + 1)
    k = np.arange(n_bands)
    cfs = cf_min * 2.0 ** (k / 3.0)
    lo = cfs * 2.0 ** (-1.0 / 6.0)
    hi = cfs * 2.0 ** (1.0 / 6.0)
    h = np.zeros((n_bands, len(f)))
    for b in range(n_bands):
        idx_lo = np.argmin((f - lo[b]) ** 2)
        idx_hi = np.argmin((f - hi[b]) ** 2)
        h[b, idx_lo: idx_hi] = 1.0
    return h


def _resample(x: np.ndarray, fs: int, fs_out: int) -> np.ndarray:
    from se_snmf_nat_tpu_torch.dsp.resample import srconv
    return srconv(x, fs, fs_out)


def stoi(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    """Short-time objective intelligibility in [~0, 1]."""
    n = min(len(ref), len(deg))
    x = _resample(np.asarray(ref, float)[:n], fs, _STOI_FS)
    y = _resample(np.asarray(deg, float)[:n], fs, _STOI_FS)

    # remove silent frames (by ref energy, 40 dB dynamic range)
    win = np.hanning(_STOI_FRAME + 2)[1:-1]
    xf = _frames(x, _STOI_FRAME, _STOI_HOP) * win
    yf = _frames(y, _STOI_FRAME, _STOI_HOP) * win
    e = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = e > e.max() - _STOI_DYN_DB
    xf, yf = xf[keep], yf[keep]
    if len(xf) < _STOI_SEG:
        raise ValueError("signal too short / too silent for STOI")

    xs = np.abs(np.fft.rfft(xf, _STOI_NFFT, axis=1)) ** 2
    ys = np.abs(np.fft.rfft(yf, _STOI_NFFT, axis=1)) ** 2
    h = _thirdoct_matrix(_STOI_FS, _STOI_NFFT, _STOI_NBANDS)
    xb = np.sqrt(xs @ h.T)          # (T, bands) band envelopes
    yb = np.sqrt(ys @ h.T)

    c = 10.0 ** (-_STOI_BETA_DB / 20.0)
    scores = []
    for m in range(_STOI_SEG, xb.shape[0] + 1):
        xseg = xb[m - _STOI_SEG: m]          # (N, bands)
        yseg = yb[m - _STOI_SEG: m]
        alpha = np.sqrt((xseg ** 2).sum(0) / ((yseg ** 2).sum(0) + 1e-12))
        yprime = np.minimum(yseg * alpha[None, :], xseg * (1.0 + c))
        xn = xseg - xseg.mean(0)
        yn = yprime - yprime.mean(0)
        num = (xn * yn).sum(0)
        den = np.linalg.norm(xn, axis=0) * np.linalg.norm(yn, axis=0) + 1e-12
        scores.append(num / den)
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# LPC-based measures (Hu & Loizou 2008 §II): LLR, Itakura-Saito, cepstral
# distance.  30 ms Hanning frames, 7.5 ms hop, LPC order 10 (fs < 10 kHz)
# or 16; per-frame distances averaged over the smallest 95% (the standard
# trimming that drops pathological frames).
# ---------------------------------------------------------------------------

_TRIM = 0.95


def _lpc_order(fs: int) -> int:
    return 10 if fs < 10000 else 16


def _analysis_frames_lpc(ref: np.ndarray, deg: np.ndarray, fs: int):
    n = min(len(ref), len(deg))
    ref = np.asarray(ref, float)[:n]
    deg = np.asarray(deg, float)[:n]
    wl = int(round(30 * fs / 1000))
    win = np.hanning(wl)
    return _frames(ref, wl, wl // 4) * win, _frames(deg, wl, wl // 4) * win


def _autocorr(x: np.ndarray, p: int) -> np.ndarray:
    n = len(x)
    return np.array([np.dot(x[: n - k], x[k:]) for k in range(p + 1)])


def _levinson(r: np.ndarray):
    """Levinson-Durbin: autocorrelation (p+1,) -> (LPC polynomial a with
    a[0]=1, prediction-error power e).  Returns None on degenerate frames."""
    p = len(r) - 1
    if r[0] <= 0.0:
        return None
    a = np.zeros(p + 1)
    a[0] = 1.0
    e = float(r[0])
    for i in range(1, p + 1):
        acc = r[i] + np.dot(a[1:i], r[1:i][::-1])
        if e <= 0.0:
            return None
        k = -acc / e
        prev = a[1:i].copy()
        a[1:i] = prev + k * prev[::-1]
        a[i] = k
        e *= 1.0 - k * k
    if e <= 0.0:
        return None
    return a, e


def _quad_toeplitz(r: np.ndarray, a: np.ndarray) -> float:
    """a @ Toeplitz(r) @ a without materializing the matrix:
    r[0]*rho[0] + 2*sum_k r[k]*rho[k], rho = autocorrelation of a."""
    p = len(a) - 1
    rho = np.correlate(a, a, "full")[p:]
    return float(r[0] * rho[0] + 2.0 * np.dot(r[1:], rho[1:]))


def _lpc_frame_pairs(ref: np.ndarray, deg: np.ndarray, fs: int):
    """Yields (a_ref, e_ref, a_deg, e_deg, r_ref, r_deg) per frame."""
    rf, df = _analysis_frames_lpc(ref, deg, fs)
    p = _lpc_order(fs)
    for i in range(rf.shape[0]):
        r_r = _autocorr(rf[i], p)
        r_d = _autocorr(df[i], p)
        lr, ld = _levinson(r_r), _levinson(r_d)
        if lr is None or ld is None:
            continue
        yield lr[0], lr[1], ld[0], ld[1], r_r, r_d


def _trimmed_mean(d: list[float]) -> float:
    if not d:
        return float("nan")
    d = np.sort(np.asarray(d))
    return float(d[: max(int(round(len(d) * _TRIM)), 1)].mean())


def llr(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    """Log-likelihood ratio: log((a_d R_r a_d)/(a_r R_r a_r)) per frame,
    R_r the reference frame's autocorrelation matrix; trimmed mean.
    0 = identical LPC envelopes; larger = worse."""
    out = []
    for a_r, _, a_d, _, r_r, _ in _lpc_frame_pairs(ref, deg, fs):
        num = _quad_toeplitz(r_r, a_d)
        den = _quad_toeplitz(r_r, a_r)
        if den <= 0.0 or num <= 0.0:
            continue
        out.append(np.log(num / den))
    return _trimmed_mean(out)


def itakura_saito(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    """Itakura-Saito distance between the per-frame all-pole models:
    (e_r/e_d)(a_d R_r a_d)/(a_r R_r a_r) + log(e_d/e_r) - 1, trimmed mean,
    per-frame values capped at 100 (the conventional outlier cap)."""
    out = []
    for a_r, e_r, a_d, e_d, r_r, _ in _lpc_frame_pairs(ref, deg, fs):
        num = _quad_toeplitz(r_r, a_d)
        den = _quad_toeplitz(r_r, a_r)
        if den <= 0.0 or num <= 0.0 or e_d <= 0.0 or e_r <= 0.0:
            continue
        d = (e_r / e_d) * (num / den) + np.log(e_d / e_r) - 1.0
        out.append(min(d, 100.0))
    return _trimmed_mean(out)


def _lpc_cepstrum(a: np.ndarray, n_cep: int) -> np.ndarray:
    """Cepstrum of the all-pole model 1/A(z), A(z) = 1 + sum a_k z^-k:
    c[m] = -a[m] - sum_{k<m} (k/m) c[k] a[m-k]."""
    p = len(a) - 1
    c = np.zeros(n_cep + 1)
    for m in range(1, n_cep + 1):
        acc = -a[m] if m <= p else 0.0
        for k in range(1, m):
            if m - k <= p:
                acc -= (k / m) * c[k] * a[m - k]
        c[m] = acc
    return c[1:]


def cepstral_distance(ref: np.ndarray, deg: np.ndarray, fs: int) -> float:
    """LPC cepstral distance (dB): (10/ln10)·sqrt(2·Σ(c_r-c_d)²), trimmed
    mean, per-frame values capped at 10 dB."""
    out = []
    for a_r, _, a_d, _, _, _ in _lpc_frame_pairs(ref, deg, fs):
        n_cep = len(a_r) - 1
        dc = _lpc_cepstrum(a_r, n_cep) - _lpc_cepstrum(a_d, n_cep)
        d = (10.0 / np.log(10.0)) * np.sqrt(2.0 * np.dot(dc, dc))
        out.append(min(d, 10.0))
    return _trimmed_mean(out)


# ---------------------------------------------------------------------------
# Critical-band measures: WSS (Klatt 1982) and frequency-weighted segSNR.
# 25 critical bands, Gaussian-shaped filters with a -30 dB skirt cutoff,
# 30 ms Hanning frames, 7.5 ms hop.
# ---------------------------------------------------------------------------

_CB_CENTER = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63])
_CB_BW = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056, 95.3398,
    105.411, 116.256, 127.914, 140.423, 153.823, 168.154, 183.457,
    199.776, 217.153, 235.631, 255.255, 276.072, 298.126, 321.465,
    346.136])


def _critical_band_filters(fs: int, nfft: int) -> np.ndarray:
    """(25, nfft//2+1) Gaussian critical-band filters, each peak-normalized
    relative to the narrowest band and truncated at its -30 dB point."""
    n_half = nfft // 2 + 1
    bins = np.arange(n_half)
    min_factor = np.exp(-30.0 / (2.0 * 2.303))
    filt = np.zeros((len(_CB_CENTER), n_half))
    for i, (cf, bw) in enumerate(zip(_CB_CENTER, _CB_BW)):
        f0 = (cf / (fs / 2)) * (n_half - 1)
        b = (bw / (fs / 2)) * (n_half - 1)
        norm = np.log(_CB_BW[0]) - np.log(bw)
        g = np.exp(-11.0 * (((bins - np.floor(f0)) / b) ** 2) + norm)
        filt[i] = g * (g > min_factor)
    return filt


def _band_spectra(ref: np.ndarray, deg: np.ndarray, fs: int):
    """Per-frame critical-band power spectra of both signals."""
    rf, df = _analysis_frames_lpc(ref, deg, fs)
    wl = rf.shape[1]
    nfft = int(2 ** np.ceil(np.log2(2 * wl)))
    filt = _critical_band_filters(fs, nfft)
    rs = np.abs(np.fft.rfft(rf, nfft, axis=1)) ** 2
    ds = np.abs(np.fft.rfft(df, nfft, axis=1)) ** 2
    return rs @ filt.T, ds @ filt.T            # (T, 25) each


def _local_peaks(energy: np.ndarray, slope: np.ndarray) -> np.ndarray:
    """Klatt's nearest-local-peak per band: follow the slope uphill."""
    nb = len(energy)
    peak = np.empty(nb - 1)
    for i in range(nb - 1):
        n = i
        if slope[i] > 0.0:                      # rising: next local max
            while n < nb - 1 and slope[n] > 0.0:
                n += 1
            peak[i] = energy[n]
        else:                                   # falling: previous local max
            while n >= 0 and slope[n] <= 0.0:
                n -= 1
            peak[i] = energy[n + 1]
    return peak


def wss(ref: np.ndarray, deg: np.ndarray, fs: int,
        k_max: float = 20.0, k_loc_max: float = 1.0) -> float:
    """Klatt (1982) weighted spectral slope distance over 25 critical
    bands; per-frame weights emphasize bands near spectral peaks; trimmed
    mean over the smallest 95% of frames.  0 = identical; larger = worse."""
    rb, db = _band_spectra(ref, deg, fs)
    out = []
    for t in range(rb.shape[0]):
        e_r = 10.0 * np.log10(np.maximum(rb[t], 1e-10))
        e_d = 10.0 * np.log10(np.maximum(db[t], 1e-10))
        s_r, s_d = np.diff(e_r), np.diff(e_d)
        w_r = (k_max / (k_max + e_r.max() - e_r[:-1])) \
            * (k_loc_max / (k_loc_max + _local_peaks(e_r, s_r) - e_r[:-1]))
        w_d = (k_max / (k_max + e_d.max() - e_d[:-1])) \
            * (k_loc_max / (k_loc_max + _local_peaks(e_d, s_d) - e_d[:-1]))
        w = 0.5 * (w_r + w_d)
        out.append(float(np.sum(w * (s_r - s_d) ** 2) / np.sum(w)))
    return _trimmed_mean(out)


def fw_seg_snr(ref: np.ndarray, deg: np.ndarray, fs: int,
               gamma: float = 0.2, floor_db: float = -10.0,
               ceil_db: float = 35.0) -> float:
    """Frequency-weighted segmental SNR (dB) over 25 critical bands,
    band weights = clean band magnitude^gamma, per-band SNR clamped to
    [-10, 35] dB; mean over frames.  Larger = better."""
    rb, db = _band_spectra(ref, deg, fs)
    xm, ym = np.sqrt(rb), np.sqrt(db)           # band magnitudes
    w = np.maximum(xm, 1e-10) ** gamma
    snr = 10.0 * np.log10(
        np.maximum(xm, 1e-10) ** 2 / np.maximum((xm - ym) ** 2, 1e-10))
    snr = np.clip(snr, floor_db, ceil_db)
    per_frame = np.sum(w * snr, axis=1) / np.sum(w, axis=1)
    if per_frame.size == 0:
        return float("nan")
    return float(per_frame.mean())


def quality_report(ref: np.ndarray, deg: np.ndarray, fs: int) -> dict:
    def _safe(v: float):
        return None if np.isnan(v) else round(v, 2)   # JSON-clean

    out = {
        "seg_snr_db": _safe(segmental_snr(ref, deg, fs)),
        "fw_seg_snr_db": _safe(fw_seg_snr(ref, deg, fs)),
        "lsd_db": _safe(log_spectral_distance(ref, deg, fs)),
        "llr": _safe(llr(ref, deg, fs)),
        "is_dist": _safe(itakura_saito(ref, deg, fs)),
        "cep_dist_db": _safe(cepstral_distance(ref, deg, fs)),
        "wss": _safe(wss(ref, deg, fs)),
    }
    try:
        out["stoi"] = round(stoi(ref, deg, fs), 4)
    except ValueError:
        out["stoi"] = None
    return out
