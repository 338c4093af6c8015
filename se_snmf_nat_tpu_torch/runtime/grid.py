"""SNR-grid campaign (port of the reference package's ``runtime/grid.py``):
the reference's actual experiment, self-contained.

Do_MultiBatch_IS16_20160324.m:181-182 defines the IS16 evaluation grid —
six noise types x four SNRs ({'DLIVING','STRAFFIC','PCAFETER','TMETRO',
'NRIVER','OOFFICE'} x {0,10,15,5} dB) — enhanced per condition with the
adapted dictionary reset per condition (``delete('B_D_u.mat')``,
:187-188) and compared across algorithms.  The corpora behind that grid are
not bundled, so ``build_grid_corpus`` synthesizes an equivalent grid from a
clean-speech wav the caller names (``speech_wav``: the port reads no fixed
path): a training portion and held-out test clips of that speech, six
seeded noise generators (a TRAIN segment and a drifted MIX segment each),
and mixtures at exact per-clip SNRs in the reference's
``Noisy_IS16/<noise>/<snr>dB`` shape.  ``NOISE_TYPES``, ``SNR_LIST``,
``_lp``, ``synth_noise``, ``_write`` and ``build_grid_corpus`` are copies
of the reference's (tests/test_torch_io.py holds them statement for
statement), so both packages write the same corpus bytes.

``run_grid`` runs the campaign on the port's trainers and enhancers on
``device`` (the card unless named): train the speech basis once and a
noise basis per noise type, enhance every condition with each algorithm
(SNMF-NAT / SNMF-fixed / IMCRA / MS / BNMF) through ``BatchRunner`` with a
fresh dictionary state per directory, and score every output with
``metrics.quality_report`` against the clean clip.  The report carries the
NAT-minus-fixed segmental-SNR delta.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

NOISE_TYPES = ("dliving", "straffic", "pcafeter", "tmetro", "nriver",
               "ooffice")
SNR_LIST = (0, 10, 15, 5)          # Do_MultiBatch_IS16_20160324.m:182


def _lp(x: np.ndarray, a: float) -> np.ndarray:
    """y[i] = a*y[i-1] + (1-a)*x[i] — dependency-free one-pole shaping
    (scipy is not in the image; generation-time only)."""
    y = np.empty_like(x)
    acc = 0.0
    b = 1.0 - a
    for i in range(len(x)):        # noqa: simple loop, gen-time only
        acc = a * acc + b * x[i]
        y[i] = acc
    return y


def synth_noise(kind: str, n: int, fs: int, rng: np.random.Generator,
                speech: np.ndarray | None = None,
                variant: float = 0.0) -> np.ndarray:
    """Seeded noise generator for one reference-style category.

    Shapes are caricatures of the IS16 categories — what matters for the
    experiment is that the six types span stationary vs nonstationary and
    tonal vs broadband (the axis the NAT-vs-fixed comparison cares
    about), and that successive segments are distinct (held-out mixing).

    ``variant`` drifts the generator's spectral/temporal parameters: the
    grid trains noise bases on variant 0 and MIXES with variant 1 —
    trained-basis mismatch, the operating condition the reference's NAT
    mechanism exists for (a stationary match makes adaptation pure
    downside and measures nothing).
    """
    t = np.arange(n) / fs
    v = float(variant)
    w = rng.standard_normal(n)
    if kind == "dliving":          # domestic: pink-ish + slow activity AM
        base = _lp(w, min(0.92 + 0.05 * v, 0.995))
        am = 1.0 + (0.6 + 0.3 * v) * _lp(rng.standard_normal(n), 0.9995)
        y = base * am
    elif kind == "straffic":       # street: deep rumble + passing swells
        rumble = _lp(w, 0.985 - 0.03 * v)
        swell = 1.0 + (0.8 + 0.6 * v) * np.clip(
            _lp(rng.standard_normal(n), 0.99985) * 8.0, -0.9, 3.0)
        y = rumble * swell + (0.05 + 0.08 * v) * w
    elif kind == "pcafeter":       # cafeteria: babble from shifted speech
        if speech is None:
            raise ValueError("pcafeter needs the speech corpus")
        y = np.zeros(n)
        for _ in range(8 - int(4 * v)):
            off = int(rng.integers(0, len(speech)))
            seg = np.roll(speech, off)[:n] if len(speech) >= n else \
                np.resize(np.roll(speech, off), n)
            y += seg * float(rng.uniform(0.4, 1.0))
        y = y / 8.0 + 0.02 * w * np.std(y)
    elif kind == "tmetro":         # metro: harmonic drone + clatter bursts
        drone = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.28))
                    / k for k in range(1, 6)
                    for f0 in (49.7 * (1.0 + 0.35 * v),))
        gate = (_lp(np.abs(rng.standard_normal(n)), 0.9998)
                > 0.55 - 0.15 * v)
        y = 0.7 * drone + 1.2 * w * _lp(gate.astype(float), 0.99) + 0.1 * w
    elif kind == "nriver":         # river: smoothed broadband wash
        y = _lp(w, 0.7 + 0.15 * v) + 0.4 * _lp(rng.standard_normal(n),
                                               0.95)
        y *= 1.0 + 0.15 * np.sin(2 * np.pi * 0.3 * t)
    elif kind == "ooffice":        # office: mains hum + hiss + clicks
        hum = sum(np.sin(2 * np.pi * 60.0 * (1.0 + 0.3 * v) * k * t
                         + rng.uniform(0, 6.28)) / k for k in (1, 2, 3))
        clicks = np.zeros(n)
        for _ in range(max(1, int(n * (1 + 3 * v)) // (fs * 2))):
            i = int(rng.integers(0, n - 50))
            clicks[i: i + 50] += rng.standard_normal(50) * 4.0
        y = 0.5 * hum + (0.35 + 0.2 * v) * w + clicks
    else:
        raise ValueError(f"unknown noise type {kind!r}")
    return y / (np.std(y) + 1e-12)


def _write(path: Path, x: np.ndarray, fs: int) -> None:
    from se_snmf_nat_tpu_torch.io.native import write_wav_int16
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav_int16(path, np.clip(np.rint(x), -32768, 32767)
                    .astype(np.int16), fs)


def build_grid_corpus(root: str | Path, *,
                      noises=NOISE_TYPES, snrs=SNR_LIST,
                      clip_s: float = 2.4, n_clips: int = 3,
                      train_s: float = 9.0, lead_s: float = 0.6,
                      seed: int = 0,
                      speech_wav: str) -> dict:
    """Synthesize the grid corpus tree; returns the manifest.

    Layout (mirrors the reference's DB shape):
      speech_train/clip_XX.wav        speech-basis training clips
      noise_train/<noise>.wav         per-type noise-basis training audio
      clean/clip_XX.wav               held-out clean test clips
      noisy/<noise>/<snr>dB/clip_XX.wav   test mixtures (exact per-clip SNR)

    Every mixture carries a ``lead_s``-second noise-only LEAD-IN before
    the speech (the shape of the reference corpora and of any real
    recording): the engine's init_N_len noise seeding and the adaptation
    trigger calibrate on it.  Without a lead-in the NAT path seeds its
    noise statistics from speech+noise frames and adapts destructively —
    measured on the first smoke grid (NAT segSNR pinned ~0 dB while
    fixed scored normally).  Eval trims the lead from the outputs.
    """
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16

    root = Path(root)
    rng = np.random.default_rng(seed)
    sp, fs = read_wav_int16(speech_wav)
    sp = sp.astype(np.float64)
    # normalize the speech corpus to CHiME-like level (rms ~2500): the
    # engine's absolute floors/thresholds are tuned for int16-scale
    # speech and the bundled source is ~10x quieter
    sp = sp * (2500.0 / (np.std(sp) + 1e-9))
    n_train = int(train_s * fs)
    n_clip = int(clip_s * fs)
    train = sp[:n_train]
    # speech training clips (chunked so the trainer's VAD/framing treats
    # them as separate utterances, like the reference's file lists)
    chunk = int(3.0 * fs)
    for i in range(0, max(len(train) - fs, 1), chunk):
        _write(root / "speech_train" / f"clip_{i // chunk:02d}.wav",
               train[i: i + chunk], fs)
    clips = []
    for k in range(n_clips):
        lo = n_train + k * n_clip
        c = sp[lo: lo + n_clip]
        if len(c) < n_clip // 2:
            break
        _write(root / "clean" / f"clip_{k:02d}.wav", c, fs)
        clips.append((f"clip_{k:02d}.wav", c))
    # noise: one long stream per type; first part trains, the rest mixes
    n_lead = int(lead_s * fs)
    mix_need = sum(len(c) + n_lead for _, c in clips)
    n_noise_train = int(train_s * fs)
    for kind in noises:
        tr_stream = synth_noise(kind, n_noise_train, fs, rng,
                                speech=train, variant=0.0)
        _write(root / "noise_train" / f"{kind}.wav",
               tr_stream * 2000.0, fs)
        # mixing noise: DRIFTED generator parameters (variant 1) — the
        # trained-basis-mismatch condition NAT exists for
        held = synth_noise(kind, mix_need + fs, fs, rng,
                           speech=train, variant=1.0)
        off = 0
        for name, c in clips:
            nseg = held[off: off + n_lead + len(c)]
            off += n_lead + len(c)
            s_rms = np.sqrt(np.mean(c ** 2)) + 1e-12
            n_rms = np.sqrt(np.mean(nseg[n_lead:] ** 2)) + 1e-12
            for snr in snrs:
                a = s_rms / (n_rms * 10.0 ** (snr / 20.0))
                mix = a * nseg
                mix[n_lead:] += c
                _write(root / "noisy" / kind / f"{snr}dB" / name,
                       mix, fs)
    manifest = {"fs": fs, "noises": list(noises),
                "snrs": [int(s) for s in snrs],
                "clips": [name for name, _ in clips],
                "clip_s": clip_s, "lead": n_lead, "seed": seed}
    (root / "manifest.json").write_text(json.dumps(manifest))
    return manifest


def run_grid(root: str | Path, *,
             algorithms=("snmf", "snmf_fixed", "imcra", "ms", "bnmf"),
             rank: int = 100, dtype=torch.float32,
             max_iter: int | None = None, verbose: bool = True,
             device=None) -> dict:
    """Train -> enhance -> eval over the synthesized grid, on ``device``
    (the card unless named) in ``dtype``.

    Per algorithm and condition dir: outputs under
    ``enhanced/<alg>/<noise>/<snr>dB``; every output is scored against the
    clean clip (metrics.quality_report) and the noisy input's own score is
    the baseline column.  SNMF family: per-noise-type trained basis, and
    the adapted-dictionary state resets per condition (the grid script's
    ``delete('B_D_u.mat')``) because every condition dir gets a fresh
    BatchRunner carry.
    """
    from dataclasses import replace
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.device import resolve_device
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
    from se_snmf_nat_tpu_torch.metrics import quality_report, segmental_snr
    from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    from se_snmf_nat_tpu_torch.train.basis import train_event_basis_cached

    device = resolve_device(device)
    root = Path(root)
    manifest = json.loads((root / "manifest.json").read_text())
    fs = manifest["fs"]
    lead = int(manifest.get("lead", 0))
    cfg = default_config()
    if rank != cfg.sep.r_x:
        # keep the reference's half-adaptive noise dictionary RATIO when
        # scaling rank down (r_a=50 of r_d=100): letting the WHOLE noise
        # dictionary adapt (r_a == r_d) absorbs the speech into the noise
        # model — measured on the smoke grid as near-silent NAT output
        cfg = cfg.evolve(
            sep=replace(cfg.sep, r_x=rank, r_d=rank),
            adapt=replace(cfg.adapt,
                          r_a=min(cfg.adapt.r_a, max(1, rank // 2))))
    if max_iter is not None:
        cfg = cfg.evolve(nmf=replace(cfg.nmf, max_iter=max_iter))

    speech = train_event_basis_cached(
        root / "speech_train", root / "basis" / "speech", cfg, rank,
        dtype=dtype, device=device)
    noise_bases = {}
    for kind in manifest["noises"]:
        nd = root / "noise_train" / f"_{kind}"
        nd.mkdir(exist_ok=True)
        src = root / "noise_train" / f"{kind}.wav"
        if not (nd / src.name).exists():
            (nd / src.name).write_bytes(src.read_bytes())
        noise_bases[kind] = train_event_basis_cached(
            nd, root / "basis" / kind, cfg, rank, dtype=dtype,
            device=device).tiled_to_rank(cfg.sep.r_d)

    def enhancers_for(kind):
        mel = cfg.sep.b_sep_mode == "Mel"
        sp_sep = speech.b_mel if mel else speech.b_dft
        nz = noise_bases[kind]
        nz_sep = nz.b_mel if mel else nz.b_dft
        out = {}
        if "snmf" in algorithms:
            out["snmf"] = SnmfEnhancer(
                cfg, sp_sep, nz_sep, speech.b_dft, nz.b_dft, device=device,
                dtype=dtype)
        if "snmf_fixed" in algorithms:
            cfg_f = cfg.evolve(adapt=replace(cfg.adapt,
                                             adapt_train_n=False))
            out["snmf_fixed"] = SnmfEnhancer(
                cfg_f, sp_sep, nz_sep, speech.b_dft, nz.b_dft,
                device=device, dtype=dtype)
        return out

    shared = {}
    if "imcra" in algorithms:
        from se_snmf_nat_tpu_torch.enhance.imcra import OmlsaEnhancer
        shared["imcra"] = OmlsaEnhancer(dtype=dtype, device=device)
    if "ms" in algorithms:
        from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
        shared["ms"] = MmseEnhancer(fs=fs, dtype=dtype, device=device)
    if "bnmf" in algorithms:
        from se_snmf_nat_tpu_torch.bnmf.enhance import BnmfEnhancer
        sp_sig, _ = read_wav_int16(
            sorted((root / "speech_train").glob("*.wav"))[0])
        shared["bnmf"] = BnmfEnhancer(speech=sp_sig, dtype=dtype,
                                      device=device)

    cleans = {name: read_wav_int16(root / "clean" / name)[0]
              .astype(np.float64) for name in manifest["clips"]}

    table = {}
    for kind in manifest["noises"]:
        per_noise = enhancers_for(kind)
        for snr in manifest["snrs"]:
            cond = f"{kind}/{snr}dB"
            cond_in = root / "noisy" / kind / f"{snr}dB"
            rows = {}
            # the noisy input's own battery = the no-enhancement baseline
            base_seg = []
            for name, clean in cleans.items():
                noisy, _ = read_wav_int16(cond_in / name)
                noisy = noisy[lead:]               # noise-only lead-in
                n = min(len(clean), len(noisy))
                base_seg.append(segmental_snr(clean[:n],
                                              noisy[:n].astype(float), fs))
            rows["noisy"] = {"seg_snr_db": round(float(np.mean(base_seg)),
                                                 2)}
            for alg in algorithms:
                enh = per_noise.get(alg) or shared.get(alg)
                if enh is None:
                    continue
                out_dir = root / "enhanced" / alg / kind / f"{snr}dB"
                runner = BatchRunner(enh, verbose=False,
                                     out_suffix="")
                runner.run(cond_in, out_dir)
                scores = []
                for name, clean in cleans.items():
                    y, _ = read_wav_int16(out_dir / name)
                    y = y[lead:]                   # noise-only lead-in
                    n = min(len(clean), len(y))
                    scores.append(quality_report(clean[:n],
                                                 y[:n].astype(float), fs))
                agg = {}
                for k in scores[0]:
                    vals = [s[k] for s in scores if s[k] is not None]
                    agg[k] = round(float(np.mean(vals)), 3) if vals \
                        else None
                rows[alg] = agg
                if verbose:
                    print(f"[grid] {cond} {alg} "
                          f"segSNR {agg.get('seg_snr_db')}", flush=True)
            table[cond] = rows

    # aggregates + the paper's central claim as a number
    report = {"manifest": manifest, "conditions": table}
    means = {}
    for alg in ("noisy",) + tuple(algorithms):
        segs = [r[alg]["seg_snr_db"] for r in table.values()
                if alg in r and r[alg].get("seg_snr_db") is not None]
        if segs:
            means[alg] = round(float(np.mean(segs)), 3)
    report["mean_seg_snr_db"] = means
    if "snmf" in means and "snmf_fixed" in means:
        report["nat_minus_fixed_seg_snr_db"] = round(
            means["snmf"] - means["snmf_fixed"], 3)
    return report
