"""Six-channel inputs for the multichannel cells, made from the run's seed
on the device and handed to the program and to the reference alike.

``tablet_mixtures``: each utterance is the benchmark's speech-like source
(``inputs.noisy_utterances``'s amplitude-modulated five tones, silent over
the first quarter: the noise-only lead-in) arriving from a seeded
direction at the six microphones of CHiME-4's tablet, each microphone's
copy delayed by its own fractional delay, plus noise that is partly
diffuse: a second, broadband source from another seeded direction, delayed
the same way, and sensor noise independent at each microphone.  Rounded to
int16 range as a wav read gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.traffic.inputs import FS, TONES

SOUND = 343.0               # m/s
# CHiME-4's tablet microphones (m, x right, y up, z out of the screen;
# microphone 2 faces the back), after the corpus's documentation
TABLET = ((-0.10, 0.095, 0.0), (0.0, 0.095, -0.02), (0.10, 0.095, 0.0),
          (-0.10, -0.095, 0.0), (0.0, -0.095, 0.0), (0.10, -0.095, 0.0))


def _delayed(sig: torch.Tensor, delays: torch.Tensor) -> torch.Tensor:
    """sig (n, S) delayed by ``delays`` (n, C) samples (fractional, by a
    phase ramp over a zero-padded transform) -> (n, C, S)."""
    s = sig.shape[-1]
    nfft = 1 << math.ceil(math.log2(2 * s))
    spec = torch.fft.rfft(sig, n=nfft)
    freqs = torch.arange(spec.shape[-1], device=sig.device,
                         dtype=torch.float64) / nfft
    ramp = torch.exp(-2j * math.pi * freqs * delays[..., None])
    return torch.fft.irfft(spec[:, None] * ramp, n=nfft)[..., :s]


def _directions(n: int, gen, device) -> torch.Tensor:
    """Unit vectors toward n sources in front of the tablet (azimuth in
    +-80 degrees, elevation in +-30)."""
    az = (torch.rand(n, generator=gen, device=device, dtype=torch.float64)
          - 0.5) * math.radians(160)
    el = (torch.rand(n, generator=gen, device=device, dtype=torch.float64)
          - 0.5) * math.radians(60)
    return torch.stack([torch.sin(az) * torch.cos(el), torch.sin(el),
                        torch.cos(az) * torch.cos(el)], dim=-1)


def tablet_mixtures(lens, seed: int, device, lead_silence: float = 0.25,
                    speech_level: float = 4000.0,
                    noise_level: float = 1200.0,
                    sensor_level: float = 600.0) -> np.ndarray:
    """Utterances of the given lengths as an int16 array (len(lens), 6,
    max(lens)), each zero past its length."""
    lens = np.asarray(lens, np.int64)
    n, width = len(lens), int(lens.max())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    mics = torch.tensor(TABLET, device=device, dtype=torch.float64)
    out = torch.empty((n, len(TABLET), width), device=device,
                      dtype=torch.float64)
    t = torch.arange(width, device=device, dtype=torch.float64) / FS
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * 3.0 * t) ** 2
    freqs = torch.tensor(TONES, device=device, dtype=torch.float64)
    idx = torch.arange(width, device=device)
    for a in range(0, n, 16):           # 16 utterances at a time
        b = min(a + 16, n)
        m = b - a
        phase = torch.rand((m, len(TONES), 1), generator=gen, device=device,
                           dtype=torch.float64) * 6.0
        tones = torch.sin(2 * math.pi * freqs[None, :, None] * t + phase)
        speech = env * tones.sum(1) * speech_level
        ln = torch.as_tensor(lens[a:b], device=device)
        speech = torch.where(idx[None] < (lead_silence * ln)[:, None]
                             .floor(), 0.0, speech)
        d_s = _directions(m, gen, device) @ mics.T * (FS / SOUND)
        d_n = _directions(m, gen, device) @ mics.T * (FS / SOUND)
        noise = torch.randn((m, width), generator=gen, device=device,
                            dtype=torch.float64) * noise_level
        x = _delayed(speech, d_s) + _delayed(noise, d_n) \
            + torch.randn((m, len(TABLET), width), generator=gen,
                          device=device, dtype=torch.float64) * sensor_level
        x = torch.clamp(torch.round(x), -32768, 32767)
        out[a:b] = torch.where(idx < ln[:, None, None], x, 0.0)
    return out.to(torch.int16).cpu().numpy()
