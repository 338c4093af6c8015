"""Seeded synthetic inputs (NumPy only), shared by the port's tests and
``chip_smoke.py``: no reference recordings or trained dictionaries are
needed.  Every generator draws from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FS = 16000


def synthetic_bases(f: int = 513, r_x: int = 100, r_d: int = 100,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Unit-norm uniform stand-in dictionaries (speech (f, r_x), noise
    (f, r_d)), float64."""
    rng = np.random.default_rng(seed)
    bx = rng.random((f, r_x)) + 1e-3
    bd = rng.random((f, r_d)) + 1e-3
    bx /= np.sqrt((bx * bx).sum(0))
    bd /= np.sqrt((bd * bd).sum(0))
    return bx, bd


def structured_bases(f: int = 513, r_x: int = 100, r_d: int = 100,
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Unit-norm dictionaries that tell the fixtures' sources apart:
    speech columns are harmonic combs (narrow peaks at multiples of a
    random fundamental bin, decaying), noise columns are broadband (flat
    with a smooth random ripple).  On ``noisy_utterance`` the noise
    dictionary then explains the noise-only stretch, so the adaptation
    triggers fire and the refits change the noise dictionary."""
    rng = np.random.default_rng(seed)
    bins = np.arange(f)[:, None]
    f0 = rng.uniform(8.0, 30.0, (1, r_x))
    bx = np.full((f, r_x), 1e-3)
    for k in range(1, 9):
        bx += np.exp(-0.5 * ((bins - k * f0) / 1.5) ** 2) / k
    ripple = sum(rng.uniform(-0.15, 0.15, (1, r_d))
                 * np.cos(np.pi * q * bins / f + rng.uniform(0, 6, (1, r_d)))
                 for q in range(1, 5))
    bd = 1.0 + ripple
    bx /= np.sqrt((bx * bx).sum(0))
    bd /= np.sqrt((bd * bd).sum(0))
    return bx, bd


def speechlike(n_samples: int, seed: int = 0, fs: int = FS,
               amplitude: float = 4000.0) -> np.ndarray:
    """Amplitude-modulated multi-tone (int16 scale, float64)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / fs
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    sig = sum(np.sin(2 * np.pi * f0 * t + rng.random() * 6)
              for f0 in (220, 450, 900, 1800, 2600))
    return env * sig * amplitude


def noise(n_samples: int, seed: int = 0, level: float = 1000.0) -> np.ndarray:
    """White Gaussian noise (int16 scale, float64)."""
    return np.random.default_rng(seed).standard_normal(n_samples) * level


def clean_utterance(n_samples: int, seed: int = 0,
                    lead_silence: float = 0.25) -> np.ndarray:
    """The clean signal of ``noisy_utterance``: speech-like after a silent
    lead-in (float64, the reference of the quality scores)."""
    s = speechlike(n_samples, seed=seed)
    s[: int(lead_silence * n_samples)] = 0.0
    return s


def noisy_utterance(n_samples: int, seed: int = 0,
                    lead_silence: float = 0.25,
                    noise_level: float = 1500.0) -> np.ndarray:
    """Speech-like signal behind a noise-only lead-in, plus noise throughout,
    rounded to integers in int16 range (as a wav read gives).  The
    noise-only stretch is what fires the adaptation triggers."""
    s = clean_utterance(n_samples, seed=seed, lead_silence=lead_silence)
    x = s + noise(n_samples, seed=seed + 1000, level=noise_level)
    return np.clip(np.round(x), -32768, 32767)


def write_wav_dir(path, kind: str, n_clips: int, seconds: float,
                  seed: int = 0, fs: int = FS):
    """A directory of ``n_clips`` int16 mono wavs of ``seconds`` each, one
    seed a clip from ``seed`` on: ``kind`` "speech" (``speechlike``) or
    "noise" (``noise``): training data for the dictionaries.  Returns the
    directory as a ``Path``."""
    # imported here: the wav module's package loads torch, this one does not
    from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
    make = {"speech": speechlike, "noise": noise}[kind]
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    n = int(seconds * fs)
    for i in range(n_clips):
        x = np.clip(np.round(make(n, seed=seed + i)), -32768, 32767)
        write_wav_int16(path / f"{kind}_{i:03d}.wav", x.astype(np.int16), fs)
    return path
