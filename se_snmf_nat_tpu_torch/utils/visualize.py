"""Observability visuals — the GUI plot analogs, as artifacts (NumPy).

The port's own copy of the reference package's ``utils/visualize.py``, held
statement for statement equal to it by tests/test_torch_io.py; matplotlib
is imported only inside the PNG writers.

Covers the visualization role of the reference GUI (waveform + noise-basis
contour refresh, SE_GUI.m:437-479; spectrogram rendering,
src/func/myspectrogram.m): PNG artifacts per session and an ASCII
spectrogram for terminal use.  Design rules: magnitude data gets a
single-hue sequential ramp (light -> dark), axes/grid stay recessive, one
series per figure.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_SEQ_CMAP = "Blues"          # one hue, light->dark (magnitude job)
_INK = "#333639"
_MUTED = "#6b7075"


def power_spectrogram_db(x: np.ndarray, fs: int, nfft: int = 512,
                         hop: int = 128, dyn_range_db: float = 60.0):
    """Hann-windowed log-power spectrogram (myspectrogram.m defaults:
    per-frame Hanning, dB scale clamped to a fixed dynamic range).
    Returns (s_db (F, T), freqs_hz, times_s)."""
    x = np.asarray(x, np.float64).reshape(-1)
    if len(x) < nfft:
        x = np.concatenate([x, np.zeros(nfft - len(x))])
    n_frames = 1 + (len(x) - nfft) // hop
    idx = hop * np.arange(n_frames)[:, None] + np.arange(nfft)[None, :]
    win = np.hanning(nfft)
    spec = np.fft.rfft(x[idx] * win[None, :], nfft, axis=1)
    p = (spec.real ** 2 + spec.imag ** 2).T            # (F, T)
    s_db = 10.0 * np.log10(np.maximum(p, 1e-12))
    top = s_db.max()
    s_db = np.clip(s_db, top - dyn_range_db, top)
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    times = (hop * np.arange(n_frames) + nfft / 2) / fs
    return s_db, freqs, times


def ascii_spectrogram(x: np.ndarray, fs: int, rows: int = 16,
                      cols: int = 72) -> str:
    """Terminal spectrogram: time left->right, frequency bottom->top,
    density shades by magnitude."""
    s_db, freqs, _ = power_spectrogram_db(x, fs)
    f_bins = np.linspace(0, s_db.shape[0], rows + 1).astype(int)
    t_bins = np.linspace(0, s_db.shape[1], cols + 1).astype(int)
    shades = " .:-=+*#%@"
    lo, hi = s_db.min(), s_db.max()
    span = max(hi - lo, 1e-9)
    lines = []
    for r in range(rows - 1, -1, -1):
        fr = slice(f_bins[r], max(f_bins[r + 1], f_bins[r] + 1))
        row = []
        for c in range(cols):
            tc = slice(t_bins[c], max(t_bins[c + 1], t_bins[c] + 1))
            v = (s_db[fr, tc].mean() - lo) / span
            row.append(shades[min(int(v * (len(shades) - 1)), len(shades) - 1)])
        f_hi = freqs[min(f_bins[r + 1], len(freqs) - 1)] / 1000.0
        lines.append(f"{f_hi:5.1f}k |" + "".join(row))
    lines.append("       +" + "-" * cols)
    dur = len(x) / fs
    lines.append(f"        0s{' ' * (cols - 12)}{dur:6.2f}s")
    return "\n".join(lines)


def _style_axis(ax):
    ax.tick_params(colors=_MUTED, labelsize=8)
    for spine in ax.spines.values():
        spine.set_color(_MUTED)
        spine.set_linewidth(0.6)


def save_spectrogram_png(x: np.ndarray, fs: int, path: str | Path,
                         title: str = "spectrogram") -> Path:
    """myspectrogram.m analog: log-power spectrogram PNG artifact."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s_db, freqs, times = power_spectrogram_db(x, fs)
    fig, ax = plt.subplots(figsize=(8, 3), dpi=110)
    im = ax.imshow(s_db, origin="lower", aspect="auto", cmap=_SEQ_CMAP,
                   extent=[times[0], times[-1], freqs[0] / 1000,
                           freqs[-1] / 1000])
    ax.set_xlabel("time (s)", color=_INK, fontsize=9)
    ax.set_ylabel("frequency (kHz)", color=_INK, fontsize=9)
    ax.set_title(title, color=_INK, fontsize=10, loc="left")
    _style_axis(ax)
    cbar = fig.colorbar(im, ax=ax, pad=0.01)
    cbar.set_label("power (dB)", color=_MUTED, fontsize=8)
    cbar.ax.tick_params(colors=_MUTED, labelsize=7)
    cbar.outline.set_edgecolor(_MUTED)
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path)
    plt.close(fig)
    return path


def save_waveform_png(x_in: np.ndarray, x_out: np.ndarray, fs: int,
                      path: str | Path) -> Path:
    """Waveform before/after panel (SE_GUI.m:446-451 refresh, as two
    stacked single-series axes — never a dual axis)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(8, 3), dpi=110, sharex=True)
    for ax, sig, name in ((axes[0], x_in, "input"),
                          (axes[1], x_out, "enhanced")):
        t = np.arange(len(sig)) / fs
        ax.plot(t, np.asarray(sig, np.float64), lw=0.4, color="#1d5ea8")
        ax.set_title(name, color=_INK, fontsize=9, loc="left")
        ax.set_ylabel("amp", color=_MUTED, fontsize=8)
        _style_axis(ax)
    axes[1].set_xlabel("time (s)", color=_INK, fontsize=9)
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path)
    plt.close(fig)
    return path


def save_basis_evolution_png(snapshots: list, hop_indices: list,
                             path: str | Path) -> Path:
    """Noise-basis evolution (SE_GUI.m:466-479 contour refresh): the
    adapted head at session checkpoints as log-magnitude heatmaps, plus a
    drift curve (per-snapshot L2 distance from the initial head)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    heads = [np.asarray(h, np.float64) for h in snapshots]
    k = len(heads)
    if k == 0:
        # no checkpoints recorded (adaptation never fired): emit an empty
        # placeholder rather than crashing the demo's artifact dump
        fig, ax = plt.subplots(figsize=(3, 3), dpi=110)
        ax.text(0.5, 0.5, "no basis snapshots", ha="center", va="center",
                color=_MUTED)
        ax.set_axis_off()
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return Path(path)
    fig, axes = plt.subplots(1, k + 1, figsize=(2.2 * (k + 1), 3), dpi=110,
                             squeeze=False)
    axes = axes[0]
    vmax = max(np.log10(h + 1e-9).max() for h in heads)
    vmin = vmax - 4.0
    for ax, h, hop in zip(axes[:-1], heads, hop_indices):
        ax.imshow(np.clip(np.log10(h + 1e-9), vmin, vmax), origin="lower",
                  aspect="auto", cmap=_SEQ_CMAP, vmin=vmin, vmax=vmax)
        ax.set_title(f"hop {hop}", color=_INK, fontsize=9, loc="left")
        ax.set_xlabel("atom", color=_MUTED, fontsize=8)
        _style_axis(ax)
    axes[0].set_ylabel("frequency bin", color=_INK, fontsize=9)
    drift = [float(np.linalg.norm(h - heads[0])) for h in heads]
    ax = axes[-1]
    ax.plot(hop_indices, drift, lw=2.0, color="#1d5ea8", marker="o",
            markersize=4)
    ax.set_title("drift from init (L2)", color=_INK, fontsize=9, loc="left")
    ax.set_xlabel("hop", color=_MUTED, fontsize=8)
    ax.grid(True, lw=0.3, color="#d8dadd")
    _style_axis(ax)
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path)
    plt.close(fig)
    return path
