"""The benchmark's inputs, made from the run's seed and handed to the
program and to the reference alike.

* ``structured_bases``: a frozen copy of the dictionaries of the program's
  test fixtures (harmonic-comb speech columns, broadband noise columns with
  a smooth ripple, unit norm), so that the adaptation triggers fire on the
  utterances below and the refits change the noise dictionary.
* ``noisy_utterances``: the fixtures' noisy utterance (an amplitude-
  modulated five-tone signal behind a noise-only lead-in, white noise
  throughout, rounded to int16 range as a wav read gives), drawn in bulk
  on the device with a ``torch.Generator``.
* ``lengths``: the utterance lengths a traffic file asks for: one fixed
  length, or lengths drawn uniformly from a range as the program's mixed
  campaign draws its files, from the traffic file's own length seed, so
  that every run seed gets the same sizes in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FS = 16000
TONES = (220.0, 450.0, 900.0, 1800.0, 2600.0)


def structured_bases(f: int = 513, r_x: int = 100, r_d: int = 100,
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Unit-norm speech (f, r_x) and noise (f, r_d) dictionaries, float64."""
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


def lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` utterance lengths in samples: ``spec["samples"]`` each, or
    uniform in [``spec["min_samples"]``, ``spec["max_samples"]``) drawn
    from ``spec["length_seed"]``."""
    if "samples" in spec:
        return np.full(n, int(spec["samples"]), np.int64)
    rng = np.random.default_rng(int(spec["length_seed"]))
    return rng.integers(int(spec["min_samples"]), int(spec["max_samples"]),
                        n).astype(np.int64)


def noisy_utterances(lens, seed: int, device, lead_silence: float = 0.25,
                     speech_level: float = 4000.0,
                     noise_level: float = 1500.0) -> np.ndarray:
    """Utterances of the given lengths as rows of an int16 array
    (len(lens), max(lens)), each row zero past its length."""
    lens = np.asarray(lens, np.int64)
    n, width = len(lens), int(lens.max())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    phase = torch.rand((n, len(TONES), 1), generator=gen, device=device,
                       dtype=torch.float64) * 6.0
    t = torch.arange(width, device=device, dtype=torch.float64) / FS
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * 3.0 * t) ** 2
    freqs = torch.tensor(TONES, device=device, dtype=torch.float64)
    tones = torch.sin(2 * math.pi * freqs[None, :, None] * t + phase)
    speech = env * tones.sum(1) * speech_level
    ln = torch.as_tensor(lens, device=device)
    idx = torch.arange(width, device=device)
    speech = torch.where(idx[None] < (lead_silence * ln)[:, None].floor(),
                         0.0, speech)
    x = speech + torch.randn((n, width), generator=gen, device=device,
                             dtype=torch.float64) * noise_level
    x = torch.clamp(torch.round(x), -32768, 32767)
    x = torch.where(idx[None] < ln[:, None], x, 0.0)
    return x.to(torch.int16).cpu().numpy()
