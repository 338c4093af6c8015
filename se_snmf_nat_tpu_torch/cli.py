"""Command-line entry points of the port (counterpart of the reference
package's ``cli.py``, its ``bench`` command aside).

Replaces the reference's top-level scripts:
  enhance   — filewise_run_IS16.m / run_ntf_sep_RT.m / run_IMCRA.m
  separate  — the engine's x_hat/d_hat outputs, one wav a source
  train     — run_basis_train.m
  dnmf      — run_basis_DNMF.m / run_basis_DNMF_Mel.m
  campaign  — Do_MultiBatch_IS16_20160324_CHiME4.m (train -> enhance grid,
              adapted-dictionary reset per target condition :193)
  grid      — the IS16 SNR-grid experiment on a synthesized corpus
  serve     — the TCP enhancement server (many streams on one card)
  demo      — the SE_GUI.m real-time loop as a terminal program
  eval      — the golden-output comparison (SURVEY §4); prints JSON metrics

Usage: python -m se_snmf_nat_tpu_torch <command> [options]

Every command that builds an enhancer or trains runs on the card unless
``--device`` names another device (``--device cpu``); without a card it
exits non-zero with ``device.require_cuda()``'s message.  The port reads no
fixed path: the reference's pretrained dictionaries are read only for a
side that neither ``--speech-basis`` nor ``--noise-basis`` names, from
``--reference-root``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import resolve_device


# why the reference raises in bfloat16 where it does
_RFFT = ("its FFT takes only float32 or float64 (\"RFFT input must be "
         "float32 or float64\")")
_COND = ("its frame loop's two branches return bfloat16 and float32 "
         "(\"cond branches must have equal output types\")")


def _torch_dtype(name: str, what: str, bfloat16: bool = False,
                 reason: str = _RFFT):
    """The torch dtype of ``--dtype``.  bfloat16 runs where the reference
    runs it (``bfloat16=True``): the SNMF plans with the matmul DFT
    (``--dft-matmul``), training and DNMF, on the plain solvers (the
    kernels are float32 only).  Where the reference raises in bfloat16 the
    port refuses, naming ``what`` and the reference's ``reason``."""
    if name == "bfloat16" and not bfloat16:
        raise SystemExit(
            f"--dtype bfloat16: {what} does not run in bfloat16, as in the "
            f"reference, where {reason}; use --dtype float32")
    return {"float32": torch.float32, "float64": torch.float64,
            "bfloat16": torch.bfloat16}[name]


def _load_bases(args, cfg):
    """Custom bases are per-side: either flag overrides that side.  The
    reference's pretrained dictionaries are read only for a side that no
    flag names, from ``--reference-root`` (the reference repository's
    root); without it such a side is an error that names the flags."""
    from se_snmf_nat_tpu_torch.io.basis import (
        load_basis, load_reference_speech_noise)
    speech = load_basis(args.speech_basis) if args.speech_basis else None
    noise = (load_basis(args.noise_basis).tiled_to_rank(cfg.sep.r_d)
             if args.noise_basis else None)
    if speech is None or noise is None:
        missing = [flag for flag, pair in (("--speech-basis", speech),
                                           ("--noise-basis", noise))
                   if pair is None]
        if not args.reference_root:
            raise SystemExit(
                f"no dictionary for {' and '.join(missing)}: give "
                f"{' and '.join(missing)} <basis.npz|.mat>, or "
                f"--reference-root <the reference repository's root> to "
                f"read its pretrained pair")
        ref_speech, ref_noise = load_reference_speech_noise(
            cfg.sep.r_d, root=args.reference_root)
        speech = ref_speech if speech is None else speech
        noise = ref_noise if noise is None else noise
    return speech, noise


def _build_enhancer(args):
    from se_snmf_nat_tpu_torch.config import preset
    cfg = preset(args.preset)
    if getattr(args, "max_iter", 0):
        from dataclasses import replace
        cfg = cfg.evolve(nmf=replace(cfg.nmf, max_iter=args.max_iter))
    algo = args.algorithm.lower()
    if algo == "snmf":
        dtype = _torch_dtype(
            args.dtype, "--algorithm snmf without --dft-matmul",
            bfloat16=getattr(args, "dft_matmul", False))
    else:
        dtype = _torch_dtype(args.dtype, f"--algorithm {algo}",
                             reason=_COND if algo == "imcra" else _RFFT)
    device = args.device
    if algo != "snmf":
        # these knobs configure the SNMF plans only; anything else would
        # silently ignore them — refuse instead
        ignored = [flag for flag, attr in
                   (("--dft-matmul", "dft_matmul"), ("--max-iter", "max_iter"),
                    ("--block-adapt", "block_adapt"),
                    ("--block-iter-cap", "block_iter_cap"),
                    ("--block-refit-cap", "block_refit_cap"),
                    ("--block-fixed-iter", "block_fixed_iter"))
                   if getattr(args, attr, 0)]
        if ignored:
            raise SystemExit(
                f"{', '.join(ignored)} only apply to --algorithm snmf "
                f"(they configure the sparse-NMF solver/transform plans); "
                f"got --algorithm {algo}")
    if algo == "snmf":
        from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
        speech, noise = _load_bases(args, cfg)
        if cfg.sep.b_sep_mode == "Mel":
            b1x, b1d = speech.b_mel, noise.b_mel
        else:
            b1x, b1d = speech.b_dft, noise.b_dft
        return SnmfEnhancer(cfg, b1x, b1d, speech.b_dft, noise.b_dft,
                            device=device, dtype=dtype,
                            block_adapt=getattr(args, "block_adapt", 0),
                            block_iter_cap=getattr(args, "block_iter_cap",
                                                   0),
                            block_refit_cap=getattr(args, "block_refit_cap",
                                                    0),
                            block_fixed_iter=getattr(args,
                                                     "block_fixed_iter",
                                                     False),
                            dft_matmul=getattr(args, "dft_matmul", False))
    if algo == "imcra":
        from se_snmf_nat_tpu_torch.enhance.imcra import OmlsaEnhancer
        return OmlsaEnhancer(dtype=dtype, device=device)
    if algo == "ms":
        from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
        return MmseEnhancer(cfg.signal.fs, dtype=dtype,
                            tracker=getattr(args, "tracker", "martin"),
                            device=device)
    if algo == "pmwf":
        from se_snmf_nat_tpu_torch.multichannel.pmwf import PmwfEnhancer
        return PmwfEnhancer(cfg, dtype=dtype, device=device)
    if algo == "bnmf":
        # Mohammadiha TASLP-2013 Bayesian NMF.  The reference dispatches
        # this to an external src/BNMF_nmoh/ package absent from its own
        # repo (proc_BNMF_nmoh.m:3); this slot runs the port's rebuild
        # (bnmf/), which needs a clean-speech training file the same way
        # the wrapper takes fspeech (proc_BNMF_nmoh.m:1,30).
        from se_snmf_nat_tpu_torch.bnmf import BnmfEnhancer, BnmfParams
        from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
        if not getattr(args, "bnmf_speech", None):
            raise SystemExit(
                "algorithm 'bnmf' needs --bnmf-speech <clean speech wav> "
                "to train the speech model (the reference wrapper's "
                "fspeech argument, proc_BNMF_nmoh.m:1)")
        speech, _ = read_wav_int16(args.bnmf_speech)
        mode = getattr(args, "bnmf_mode", "online")
        noise = None
        if mode == "supervised":
            if not getattr(args, "bnmf_noise", None):
                raise SystemExit(
                    "--bnmf-mode supervised needs --bnmf-noise <wav>")
            noise, _ = read_wav_int16(args.bnmf_noise)
        params = BnmfParams(k_speech=cfg.sep.r_x)
        return BnmfEnhancer(speech=speech, noise=noise, method=mode,
                            params=params, dtype=dtype, device=device)
    raise SystemExit(f"unknown algorithm {args.algorithm!r}")


def cmd_enhance(args) -> int:
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16
    enh = _build_enhancer(args)
    src = Path(args.input)
    if src.is_dir():
        from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner
        carry = args.carry_state and args.algorithm.lower() in ("snmf", "ms")
        runner = BatchRunner(enh, carry_state=carry,
                             force_rewrite=args.force,
                             state_path=args.state_path,
                             out_suffix=args.out_suffix)
        rep = runner.run(src, args.output or src.with_name(src.name + "_enh"),
                         batch_size=args.batch_size)
        print(json.dumps({"processed": len(rep.processed),
                          "skipped": len(rep.skipped),
                          "realtime_factor": round(rep.realtime_factor, 1),
                          "stages": rep.timer.report()["stages"]}))
        return 0
    x, fs = read_wav_int16(src)
    y = enh.enhance(x)
    out = Path(args.output) if args.output \
        else src.with_name(src.stem + args.out_suffix + ".wav")
    write_wav_int16(out, np.atleast_1d(np.squeeze(y)), fs)
    print(f"wrote {out}")
    return 0


def cmd_separate(args) -> int:
    """Per-source separation (the reference engine's x_hat/d_hat outputs +
    multi-event Techwin layout)."""
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16
    args.algorithm = "snmf"
    enh = _build_enhancer(args)
    src = Path(args.input)
    x, fs = read_wav_int16(src)
    out = enh.separate(x)
    stem = Path(args.output_prefix) if args.output_prefix \
        else src.with_suffix("")
    write_wav_int16(f"{stem}_enhanced.wav", out["enhanced"], fs)
    for i, e in enumerate(out["events"]):
        write_wav_int16(f"{stem}_event{i}.wav", e, fs)
    for i, d in enumerate(out["noises"]):
        write_wav_int16(f"{stem}_noise{i}.wav", d, fs)
    print(json.dumps({"events": len(out["events"]),
                      "noises": len(out["noises"]),
                      "prefix": str(stem)}))
    return 0


def cmd_train(args) -> int:
    from se_snmf_nat_tpu_torch.config import preset
    from se_snmf_nat_tpu_torch.train.basis import train_event_basis_cached
    cfg = preset(args.preset)
    rng = np.random.default_rng(args.seed) if args.seed is not None else None
    pair = train_event_basis_cached(
        args.db, args.basis_dir, cfg, args.rank, dc_freq=args.dc_freq,
        vad=args.vad, force_retrain=args.force,
        dtype=_torch_dtype(args.dtype, "train", bfloat16=True),
        device=args.device,
        shuffle_rng=rng)
    print(json.dumps({"basis_dir": str(args.basis_dir), "rank": pair.rank,
                      "b_dft_shape": list(pair.b_dft.shape),
                      "b_mel_shape": list(pair.b_mel.shape)}))
    return 0


def cmd_dnmf(args) -> int:
    from se_snmf_nat_tpu_torch.config import preset
    from se_snmf_nat_tpu_torch.io.basis import (
        BasisPair, load_basis, save_basis)
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
    from se_snmf_nat_tpu_torch.train.dnmf import dnmf_refit
    cfg = preset(args.preset)
    dtype = _torch_dtype(args.dtype, "dnmf", bfloat16=True)
    x, _ = read_wav_int16(args.clean)
    d, _ = read_wav_int16(args.noise)
    pair = load_basis(args.basis)
    b = pair.b_mel if args.domain == "Mel" else pair.b_dft
    b_hat = dnmf_refit(x, d, b, cfg, domain=args.domain, dtype=dtype,
                       device=args.device)
    if args.domain == "Mel":
        out = BasisPair(b_dft=pair.b_dft, b_mel=b_hat)
    else:
        out = BasisPair(b_dft=b_hat, b_mel=pair.b_mel)
    save_basis(args.output, out)
    print(f"wrote {args.output}")
    return 0


def cmd_campaign(args) -> int:
    """Train speech+noise bases, then enhance every target directory with a
    fresh adapted dictionary per condition (Do_MultiBatch*:183-221)."""
    from se_snmf_nat_tpu_torch.config import preset
    from se_snmf_nat_tpu_torch.io.basis import BasisPair
    from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    from se_snmf_nat_tpu_torch.train.basis import train_event_basis_cached

    from dataclasses import replace
    cfg = preset(args.preset)
    if args.rank != cfg.sep.r_x or args.rank != cfg.sep.r_d:
        # the reference trains at p.R_x == p.R_d (run_basis_train called
        # with p.R_x, Do_MultiBatch*:108,136); keep config ranks consistent
        # with the trained rank and clamp the adapted head accordingly
        cfg = cfg.evolve(
            sep=replace(cfg.sep, r_x=args.rank, r_d=args.rank),
            adapt=replace(cfg.adapt, r_a=min(cfg.adapt.r_a, args.rank)))
    # the reference trains in bfloat16 and then raises in its enhancer's FFT
    # unless the matmul DFT is on: refused here before the training
    dtype = _torch_dtype(args.dtype, "campaign without --dft-matmul",
                         bfloat16=getattr(args, "dft_matmul", False))
    device = args.device
    root = Path(args.basis_root)
    rng = np.random.default_rng(args.seed) if args.seed is not None else None
    speech = train_event_basis_cached(
        args.speech_db, root / "speech", cfg, args.rank, vad=args.vad,
        dc_freq=args.speech_dc_freq, force_retrain=args.force, dtype=dtype,
        device=device, shuffle_rng=rng)
    noise = train_event_basis_cached(
        args.noise_db, root / "noise", cfg, args.rank,
        dc_freq=args.noise_dc_freq, force_retrain=args.force, dtype=dtype,
        device=device, shuffle_rng=rng)
    noise = noise.tiled_to_rank(cfg.sep.r_d)

    if args.dnmf:
        # refit in the SEPARATION domain (run_basis_DNMF.m vs _Mel.m): a
        # Mel-mode preset separates on b_mel, so the discriminative refit
        # must land there, not only on the DFT reconstruction basis
        from se_snmf_nat_tpu_torch.train.dnmf import dnmf_refit
        from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
        xs, _ = read_wav_int16(sorted(Path(args.speech_db).glob("*.wav"))[0])
        ds, _ = read_wav_int16(sorted(Path(args.noise_db).glob("*.wav"))[0])
        mel_mode = cfg.sep.b_sep_mode == "Mel"
        sx = speech.b_mel if mel_mode else speech.b_dft
        sd = noise.b_mel if mel_mode else noise.b_dft
        b = np.concatenate([sx[:, : cfg.sep.r_x], sd[:, : cfg.sep.r_d]],
                           axis=1)
        b_hat = dnmf_refit(xs, ds, b, cfg,
                           domain="Mel" if mel_mode else "DFT", dtype=dtype,
                           device=device)
        bx_hat, bd_hat = b_hat[:, : cfg.sep.r_x], b_hat[:, cfg.sep.r_x:]
        if mel_mode:
            speech = BasisPair(b_dft=speech.b_dft, b_mel=bx_hat)
            noise = BasisPair(b_dft=noise.b_dft, b_mel=bd_hat)
        else:
            speech = BasisPair(b_dft=bx_hat, b_mel=speech.b_mel)
            noise = BasisPair(b_dft=bd_hat, b_mel=noise.b_mel)

    if cfg.sep.b_sep_mode == "Mel":
        b1x, b1d = speech.b_mel, noise.b_mel
    else:
        b1x, b1d = speech.b_dft, noise.b_dft
    enh = SnmfEnhancer(cfg, b1x, b1d, speech.b_dft, noise.b_dft,
                       device=device, dtype=dtype,
                       block_adapt=args.block_adapt,
                       block_iter_cap=getattr(args, "block_iter_cap", 0),
                       dft_matmul=getattr(args, "dft_matmul", False))

    out_root = Path(args.out_root)
    results = {}
    # unique per-target output keys: duplicate basenames (condA/test,
    # condB/test) would collide on the output dir, the B_D_u state file
    # and the results dict
    from collections import Counter
    base_counts = Counter(Path(t).name for t in args.targets)

    def _key(t: Path) -> str:
        if base_counts[t.name] == 1:
            return t.name
        return "_".join(p for p in t.parts if p not in ("/", "\\", "..", "."))

    for target in args.targets:
        target = Path(target)
        name = _key(target)
        state_file = out_root / f"B_D_u_{name}.npz"
        if state_file.exists():
            state_file.unlink()          # per-condition reset (Do_MultiBatch*:193)
        runner = BatchRunner(enh, carry_state=not args.no_carry,
                             force_rewrite=args.force,
                             state_path=state_file)
        rep = runner.run(target, out_root / name,
                         batch_size=args.batch_size)
        results[name] = {"processed": len(rep.processed),
                         "skipped": len(rep.skipped),
                         "rt_factor": round(rep.realtime_factor, 1)}
    print(json.dumps(results))
    return 0


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def cmd_demo(args) -> int:
    """Simulated real-time streaming demo — the GUI mic loop (SE_GUI.m:
    372-516) as a terminal program: hop-by-hop enhancement with live
    latency/level telemetry.  Modes mirror the GUI: snmf (adaptive,
    SNMF-NA), snmf-fixed (no adaptation), ms (MMSE), bnmf (Bayesian NMF
    online — needs --bnmf-speech), pmwf (the multichannel beamformer).

    Live capture (the dsp_record.m role, device-independent): input '-'
    reads raw little-endian int16 mono PCM from stdin hop by hop, so any
    OS capture tool is the microphone::

        arecord -f S16_LE -r 16000 -c 1 | \\
            python -m se_snmf_nat_tpu_torch demo - --pcm-out > enhanced.pcm

    Input 'mic' captures in-process instead (the SE_GUI.m:374
    dsp.AudioRecorder role) via the optional sounddevice/PortAudio
    dependency (io/capture.py).

    --pcm-out streams enhanced hops to stdout as raw int16 as they are
    produced (telemetry JSON then goes to stderr)."""
    import time
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16

    live = args.input in ("-", "mic")
    if live:
        fs = args.live_rate
    elif args.mode == "pmwf":
        # comma-separated per-channel wavs; the channels are read in the
        # pmwf branch — only the rate is needed up front (for the hop)
        _, fs = read_wav_int16(args.input.split(",")[0])
    else:
        x_file, fs = read_wav_int16(args.input)
    hop = int(0.01 * fs)
    mode = args.mode
    device = args.device
    report_stream = sys.stderr if args.pcm_out else sys.stdout

    def hop_source():
        if args.input == "mic":
            from se_snmf_nat_tpu_torch.io.capture import mic_hops
            yield from mic_hops(fs, hop)
        elif live:
            while True:
                buf = sys.stdin.buffer.read(hop * 2)
                if len(buf) < hop * 2:
                    return
                yield np.frombuffer(buf, "<i2").astype(np.float64)
        else:
            for i in range(0, len(x_file) - hop + 1, hop):
                yield x_file[i: i + hop]

    # --play: the SE_GUI playback surface (SE_GUI.m:533-566 file replay /
    # soundsc) as a headless analog through the optional sounddevice
    # dependency; without it, --pcm-out piped to any OS player (aplay,
    # ffplay) is the route
    _player = None
    if getattr(args, "play", False):
        try:
            import sounddevice as _sd
        except Exception as e:
            raise SystemExit(
                "--play needs the optional 'sounddevice' dependency "
                "(PortAudio); pipe --pcm-out into an OS player instead: "
                f"{e}")
        _player = _sd.OutputStream(samplerate=fs, channels=1,
                                   dtype="int16")
        _player.start()

    def emit(y):
        if args.pcm_out and len(y):
            sys.stdout.buffer.write(
                np.asarray(y, np.int16).astype("<i2").tobytes())
            sys.stdout.buffer.flush()
        if _player is not None and len(y):
            _player.write(np.ascontiguousarray(y, np.int16))

    # retain full waveforms only when something at session end needs them
    # (wav write / plots / ascii spectrogram, or a finite file input).  An
    # indefinite live mic session otherwise runs in O(1) memory: RMS comes
    # from running aggregates, latency from a bounded deque.
    from collections import deque
    retain = bool(args.output or args.viz_dir or args.ascii_spec) or not live
    in_hops: list[np.ndarray] = []
    outs: list[np.ndarray] = []
    lat: deque = deque(maxlen=1_000_000)
    agg = {"in_sq": 0.0, "in_n": 0, "out_sq": 0.0, "out_n": 0}

    def account(chunk, y):
        a = np.asarray(chunk, np.float64)
        agg["in_sq"] += float((a * a).sum())
        agg["in_n"] += a.size
        if y is not None and len(y):
            b = np.asarray(y, np.float64)
            agg["out_sq"] += float((b * b).sum())
            agg["out_n"] += b.size
            if retain:
                outs.append(y)
        if retain:
            in_hops.append(np.asarray(chunk))

    basis_snaps, snap_hops = [], []
    if mode == "ms":
        from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
        enh = MmseEnhancer(fs, device=device,
                           dtype=_torch_dtype(args.dtype, "demo --mode ms"))
        st = None
        for chunk in hop_source():
            t0 = time.perf_counter()
            y, st = enh.enhance(chunk, state=st, return_state=True)
            lat.append(time.perf_counter() - t0)
            account(chunk, y)
            emit(y)
        out = np.concatenate(outs) if outs else np.zeros(0, np.int16)
    elif mode == "pmwf":
        # the multichannel beamformer live (multichannel/streaming.py).
        # Input: comma-separated wav paths (one per channel) or '-' with
        # --channels N reading channel-INTERLEAVED raw int16 from stdin;
        # output/pcm-out carry the reference channel (channel 0).
        from se_snmf_nat_tpu_torch.multichannel import (
            PmwfParams, PmwfStreamingSession)
        if live:
            n_ch = args.channels
        else:
            paths = args.input.split(",")
            n_ch = len(paths)
            if n_ch < 2:
                raise SystemExit(
                    "demo --mode pmwf needs multichannel input: "
                    "comma-separated wavs or '-' with --channels N")
            chans = []
            rates = []
            for pth in paths:
                xc, fs = read_wav_int16(pth)
                chans.append(xc)
                rates.append(fs)
            if len(set(rates)) > 1:
                # mismatched rates would beamform sample-misaligned
                # channels and write the output at the wrong rate
                raise SystemExit(
                    "demo --mode pmwf: channel sample rates differ: "
                    + ", ".join(f"{p}={r}" for p, r in zip(paths, rates)))
            nmin = min(len(c) for c in chans)
            x_mc = np.stack([c[:nmin] for c in chans])

        def mc_hop_source():
            if live:
                while True:
                    buf = sys.stdin.buffer.read(hop * n_ch * 2)
                    if len(buf) < hop * n_ch * 2:
                        return
                    fr = np.frombuffer(buf, "<i2").reshape(hop, n_ch)
                    yield fr.T.astype(np.float64)
            else:
                for i in range(0, x_mc.shape[1] - hop + 1, hop):
                    yield x_mc[:, i: i + hop]

        sess = PmwfStreamingSession(
            n_ch=n_ch, params=PmwfParams(),
            block_frames=max(args.block, 1),
            dtype=_torch_dtype(args.dtype, "demo --mode pmwf"),
            device=device)
        for chunk in mc_hop_source():
            t0 = time.perf_counter()
            y = sess.push(chunk)
            lat.append(time.perf_counter() - t0)
            account(chunk[0], y[0] if y.shape[1] else None)
            emit(y[0] if y.shape[1] else np.zeros(0))
        tail = sess.flush()
        account(np.zeros(0), tail[0] if tail.shape[1] else None)
        emit(tail[0] if tail.shape[1] else np.zeros(0))
        out = np.concatenate(outs) if outs else np.zeros(0, np.int16)
    elif mode == "bnmf":
        # the third algorithm family live (proc_BNMF_nmoh.m's frame loop
        # as a session); needs a clean-speech wav like the enhance slot
        from se_snmf_nat_tpu_torch.bnmf import (
            BnmfEnhancer, BnmfParams, BnmfStreamingSession)
        from se_snmf_nat_tpu_torch.config import preset
        if not getattr(args, "bnmf_speech", None):
            raise SystemExit("demo --mode bnmf needs --bnmf-speech "
                             "<clean speech wav> (proc_BNMF_nmoh.m:1)")
        sp, _ = read_wav_int16(args.bnmf_speech)
        cfg = preset(args.preset)
        enh = BnmfEnhancer(speech=sp,
                           params=BnmfParams(k_speech=cfg.sep.r_x),
                           dtype=_torch_dtype(args.dtype, "demo --mode bnmf"),
                           device=device)
        sess = BnmfStreamingSession(enh, block_frames=max(args.block, 1))
        for chunk in hop_source():
            t0 = time.perf_counter()
            y = sess.push(chunk)
            lat.append(time.perf_counter() - t0)
            account(chunk, y)
            emit(y)
        tail = sess.flush()
        account(np.zeros(0), tail)
        emit(tail)
        out = np.concatenate(outs) if outs else np.zeros(0, np.int16)
    else:
        from se_snmf_nat_tpu_torch.config import preset
        from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
        from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
        from dataclasses import replace
        args.algorithm = "snmf"
        if mode == "snmf-fixed" and args.preset == "snmf_nat":
            # default: the reference's fixed-basis baseline config; an
            # explicit --preset is respected (run with adaptation off)
            args.preset = "snmf"
        cfg = preset(args.preset)
        if mode == "snmf-fixed":
            cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
        dtype = _torch_dtype(args.dtype, f"demo --mode {mode}")
        speech, noise = _load_bases(args, cfg)
        enh = SnmfEnhancer(
            cfg, speech.b_dft, noise.b_dft, speech.b_dft, noise.b_dft,
            device=device, dtype=dtype)
        sess = StreamingSession(enh, block_frames=args.block)
        # a warm push takes the kernels' first launch (and their build)
        # out of the timed hops; reset() returns to a fresh t=0 state, so
        # the output equals a one-shot run
        sess.push(np.zeros(hop * args.block))
        sess.reset()
        # basis-evolution snapshots (the SE_GUI.m:466-479 plot refresh role)
        snap_every = 100 if live else max(
            (len(x_file) - hop) // hop // 4, 1)
        basis_snaps = [_host(sess.state.b_d_head)]
        snap_hops = [0]
        # live adaptation toggle — SE_GUI.m:393-435's push-to-talk NAT
        # switch: `kill -USR1 <pid>` flips it from outside (works in every
        # input mode without touching the audio stdin), --toggle-every N
        # flips it deterministically every N hops.  Applied at the top of
        # the hop loop via StreamingSession.set_adaptation: pending frames
        # flush under the setting they were pushed with.
        toggle_req = {"n": 0}
        if mode == "snmf":
            import signal as _signal
            try:
                _signal.signal(_signal.SIGUSR1,
                               lambda *_: toggle_req.__setitem__(
                                   "n", toggle_req["n"] + 1))
            except ValueError:
                pass            # not the main thread (embedded use)
        adapt_now, n_toggles = True, 0
        for h_idx, chunk in enumerate(hop_source()):
            want_on = (toggle_req["n"] % 2 == 0)
            if args.toggle_every and mode == "snmf":
                want_on ^= (h_idx // args.toggle_every) % 2 == 1
            if want_on != adapt_now:
                y0 = sess.set_adaptation(want_on)
                adapt_now, n_toggles = want_on, n_toggles + 1
                account(np.zeros(0), y0)
                emit(y0)
                if args.verbose:
                    print(f"  hop {h_idx:5d}  NAT adaptation -> "
                          f"{'ON' if want_on else 'OFF'}",
                          file=report_stream)
            t0 = time.perf_counter()
            y = sess.push(chunk)
            lat.append(time.perf_counter() - t0)
            account(chunk, y)
            emit(y)
            if args.viz_dir and h_idx > 0 and h_idx % snap_every == 0:
                basis_snaps.append(_host(sess.state.b_d_head))
                snap_hops.append(h_idx)
            if args.verbose and len(y) and h_idx % 50 == 0:
                rms_in = float(np.sqrt((np.asarray(chunk,
                                                   float) ** 2).mean()))
                rms_out = float(np.sqrt((y.astype(float) ** 2).mean()))
                print(f"  hop {h_idx:5d}  in {rms_in:7.0f}  "
                      f"out {rms_out:7.0f}  {lat[-1] * 1e3:6.2f} ms",
                      file=report_stream)
        tail = sess.flush()
        account(np.zeros(0), tail)
        emit(tail)
        out = np.concatenate(outs) if outs else np.zeros(0, np.int16)
    if not lat:
        print(json.dumps({"mode": mode, "hops": 0}), file=report_stream)
        return 0
    x = (np.concatenate(in_hops) if in_hops
         else np.zeros(0)).astype(np.float64)
    lat_ms = np.asarray(lat) * 1e3
    if args.output:
        write_wav_int16(args.output, out, fs)
    viz_files = []
    if args.ascii_spec:
        from se_snmf_nat_tpu_torch.utils.visualize import ascii_spectrogram
        print("enhanced output spectrogram:", file=report_stream)
        print(ascii_spectrogram(out, fs), file=report_stream)
    if args.viz_dir:
        from se_snmf_nat_tpu_torch.utils.visualize import (
            save_basis_evolution_png, save_spectrogram_png,
            save_waveform_png)
        vd = Path(args.viz_dir)
        vd.mkdir(parents=True, exist_ok=True)
        viz_files = [
            str(save_spectrogram_png(x, fs, vd / "spectrogram_in.png",
                                     "input spectrogram")),
            str(save_spectrogram_png(out, fs, vd / "spectrogram_out.png",
                                     "enhanced spectrogram")),
            str(save_waveform_png(x[: len(out)], out, fs,
                                  vd / "waveform.png")),
        ]
        if mode != "ms" and len(basis_snaps) > 1:
            viz_files.append(str(save_basis_evolution_png(
                basis_snaps, snap_hops, vd / "basis_evolution.png")))
    # steady-state amortized cost per hop (drop the first 10%, which holds
    # the first launches)
    steady = lat_ms[len(lat_ms) // 10:]
    amortized = float(steady.sum() / max(len(steady), 1))
    print(json.dumps({
        "mode": mode, "hops": len(lat),
        "viz": viz_files,
        "hop_latency_ms": {"p50": round(float(np.percentile(lat_ms, 50)), 2),
                           "p95": round(float(np.percentile(lat_ms, 95)), 2),
                           "amortized_steady": round(amortized, 2),
                           "max": round(float(lat_ms.max()), 2)},
        "realtime": bool(amortized < 10.0),
        "rms_in": round(float(np.sqrt(agg["in_sq"]
                                      / max(agg["in_n"], 1))), 1),
        "rms_out": round(float(np.sqrt(agg["out_sq"]
                                       / max(agg["out_n"], 1))), 1),
    }), file=report_stream)
    return 0


def cmd_eval(args) -> int:
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16
    got, fs = read_wav_int16(args.got)
    want, _ = read_wav_int16(args.want)
    n = min(len(got), len(want))
    g, w = got[:n].astype(np.float64), want[:n].astype(np.float64)
    diff = np.abs(g - w)
    report = {
        "n_samples": int(n),
        "len_got": len(got), "len_want": len(want),
        "max_abs_err": float(diff.max()),
        "mean_abs_err": float(diff.mean()),
        "corr": float(np.corrcoef(g, w)[0, 1]),
        "rel_rmse": float(np.sqrt(((g - w) ** 2).mean())
                          / max(np.sqrt((w ** 2).mean()), 1e-12)),
    }
    if args.clean:
        from se_snmf_nat_tpu_torch.metrics import quality_report
        clean, _ = read_wav_int16(args.clean)
        report["quality_vs_clean"] = quality_report(clean, g, fs)
        report["quality_unprocessed"] = quality_report(clean, w, fs)
    print(json.dumps(report))
    return 0


def _device_arg(sp):
    sp.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card, "
                         "and an error without one); 'cpu' runs the plain "
                         "PyTorch versions of the kernels on the CPU")


def _common_enh_args(sp):
    sp.add_argument("--preset", default="snmf_nat")
    sp.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "bfloat16"])
    _device_arg(sp)
    sp.add_argument("--block-adapt", type=int, default=0,
                    help="adaptive-plan block size (0=exact per-frame "
                         "refits; 88 is the production plan's, "
                         "HEADLINE_PLAN)")
    sp.add_argument("--max-iter", type=int, default=0,
                    help="override cfg.nmf.max_iter (0=preset value, 100)")
    sp.add_argument("--dft-matmul", action="store_true",
                    help="run STFT/iSTFT as full-f32 products with the DFT "
                         "matrices instead of torch.fft "
                         "(dsp/stft.dft_matrices_stacked)")
    sp.add_argument("--block-iter-cap", type=int, default=0,
                    help="cap MU iterations in the block plan (0=config "
                         "max_iter)")
    sp.add_argument("--block-refit-cap", type=int, default=0,
                    help="separate cap for the per-block dictionary refit "
                         "W-solve")
    sp.add_argument("--block-fixed-iter", action="store_true",
                    help="capped block H-solves run a FIXED iteration "
                         "count (drops the early stop and its per-trip "
                         "cost pass)")
    sp.add_argument("--tracker", default="martin",
                    choices=["martin", "mmse"],
                    help="MS noise tracker (estnoisem / estnoiseg)")
    sp.add_argument("--speech-basis")
    sp.add_argument("--noise-basis")
    sp.add_argument("--reference-root",
                    help="the reference repository's root: its basis/ "
                         "pretrained pair is read for a side that "
                         "--speech-basis / --noise-basis do not name")
    sp.add_argument("--bnmf-speech",
                    help="clean speech wav for the BNMF speech model "
                         "(the reference wrapper's fspeech)")
    sp.add_argument("--bnmf-noise",
                    help="noise wav for BNMF supervised mode")
    sp.add_argument("--bnmf-mode", default="online",
                    choices=["online", "supervised"])


GRID_SPEECH_RECORD = "speech_source.json"     # beside the manifest


def _speech_source(path) -> dict:
    """What a grid workspace records of the speech wav it was built from:
    the path it was given and the sha256 of its bytes (the check)."""
    import hashlib
    return {"path": str(Path(path).resolve()),
            "sha256": hashlib.sha256(Path(path).read_bytes()).hexdigest()}


def cmd_grid(args) -> int:
    """The reference's actual experiment (Do_MultiBatch_IS16_20160324.m
    :181-221) run end to end on a synthesized grid — see runtime/grid.py
    for the corpus construction and the held-out-segment discipline.  A
    workspace whose manifest was built for another grid (noises, SNRs, clip
    length, clip count or seed) is refused, never reused; so is a
    ``--speech-wav`` whose bytes differ from the wav the workspace records
    beside its manifest (``GRID_SPEECH_RECORD``), or given for a workspace
    that records none."""
    from se_snmf_nat_tpu_torch.runtime.grid import (
        NOISE_TYPES, SNR_LIST, build_grid_corpus, run_grid)
    ws = Path(args.workspace)
    record = ws / GRID_SPEECH_RECORD
    noises = tuple(args.noises) if args.noises else NOISE_TYPES
    snrs = tuple(args.snrs) if args.snrs else SNR_LIST
    manifest = ws / "manifest.json"
    if manifest.exists():
        have = json.loads(manifest.read_text())
        have = {"noises": have["noises"], "snrs": have["snrs"],
                "clip_s": have["clip_s"], "n_clips": len(have["clips"]),
                "seed": have["seed"]}
        want = {"noises": list(noises), "snrs": [int(s) for s in snrs],
                "clip_s": args.clip_seconds, "n_clips": args.n_clips,
                "seed": args.seed}
        differ = [f"{k}: workspace {have[k]}, requested {want[k]}"
                  for k in want if have[k] != want[k]]
        if differ:
            raise SystemExit(
                f"grid: {manifest} was built for another grid "
                f"({'; '.join(differ)}); give another --workspace")
        if args.speech_wav:
            if not record.exists():
                raise SystemExit(
                    f"grid: {ws} records no speech source ({record}); "
                    f"omit --speech-wav to reuse its corpus, or give "
                    f"another --workspace")
            built = json.loads(record.read_text())
            given = _speech_source(args.speech_wav)
            if built["sha256"] != given["sha256"]:
                raise SystemExit(
                    f"grid: {ws} was built from another speech wav "
                    f"({built['path']}, sha256 {built['sha256']}; "
                    f"requested {given['path']}, sha256 "
                    f"{given['sha256']}); give another --workspace")
    else:
        if not args.speech_wav:
            raise SystemExit(
                f"grid: {ws} has no manifest.json; --speech-wav <clean "
                f"speech wav> is needed to build its corpus")
        build_grid_corpus(ws, noises=noises, snrs=snrs,
                          clip_s=args.clip_seconds, n_clips=args.n_clips,
                          seed=args.seed, speech_wav=args.speech_wav)
        record.write_text(json.dumps(_speech_source(args.speech_wav)))
    rep = run_grid(ws, algorithms=tuple(args.algorithms), rank=args.rank,
                   max_iter=args.max_iter, device=args.device)
    out = json.dumps(rep)
    if args.report:
        Path(args.report).write_text(out)
    print(out)
    return 0


def cmd_serve(args) -> int:
    """TCP real-time enhancement daemon: one process owns the card and
    multiplexes N network streams onto the lockstep fleet
    (runtime/server.py; the serving-scale replacement for the reference's
    one-stream-per-MATLAB-process SE_GUI.m loop)."""
    import asyncio
    from se_snmf_nat_tpu_torch.runtime.server import EnhanceServer
    args.algorithm = "snmf"
    enh = _build_enhancer(args)
    srv = EnhanceServer(enh, n_lanes=args.lanes,
                        block_frames=args.block_frames,
                        use_block_adaptive=args.block_adaptive,
                        host=args.host, port=args.port,
                        underrun_pad=args.underrun_pad,
                        sub_fleets=args.sub_fleets)

    async def run():
        await srv.start()
        print(json.dumps({"serving": f"{srv.host}:{srv.port}",
                          "lanes": srv.n,
                          "block_frames": srv.session.block_frames,
                          "hop": srv.hop}), flush=True)
        async with srv._server:
            await srv._server.serve_forever()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="se_snmf_nat_tpu_torch",
        description="sparse-NMF speech enhancement on an NVIDIA Hopper card "
                    "(PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("enhance", help="enhance a wav file or directory")
    e.add_argument("input")
    e.add_argument("-o", "--output")
    e.add_argument("--algorithm", default="snmf",
                   choices=["snmf", "imcra", "ms", "pmwf", "bnmf"])
    _common_enh_args(e)
    e.add_argument("--carry-state", action="store_true", default=True)
    e.add_argument("--no-carry-state", dest="carry_state",
                   action="store_false")
    e.add_argument("--state-path")
    e.add_argument("--batch-size", type=int, default=1)
    e.add_argument("--force", action="store_true")
    e.add_argument("--out-suffix", default="_enh")
    e.set_defaults(fn=cmd_enhance)

    sp = sub.add_parser("separate",
                        help="per-source separation (events + noises)")
    sp.add_argument("input")
    sp.add_argument("-o", "--output-prefix")
    _common_enh_args(sp)
    sp.set_defaults(fn=cmd_separate)

    t = sub.add_parser("train", help="train a dictionary from a wav dir")
    t.add_argument("--db", required=True)
    t.add_argument("--basis-dir", required=True)
    t.add_argument("--rank", type=int, default=100)
    t.add_argument("--preset", default="snmf_nat")
    t.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    _device_arg(t)
    t.add_argument("--dc-freq", type=float)
    t.add_argument("--vad", action="store_true")
    t.add_argument("--force", action="store_true")
    t.add_argument("--seed", type=int)
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("dnmf", help="discriminative dictionary refit")
    d.add_argument("--clean", required=True)
    d.add_argument("--noise", required=True)
    d.add_argument("--basis", required=True)
    d.add_argument("--output", required=True)
    d.add_argument("--domain", default="DFT", choices=["DFT", "Mel"])
    d.add_argument("--preset", default="snmf_nat")
    d.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    _device_arg(d)
    d.set_defaults(fn=cmd_dnmf)

    c = sub.add_parser("campaign", help="train bases then enhance targets")
    c.add_argument("--speech-db", required=True)
    c.add_argument("--noise-db", required=True)
    c.add_argument("--basis-root", required=True)
    c.add_argument("--out-root", required=True)
    c.add_argument("--targets", nargs="+", required=True)
    c.add_argument("--rank", type=int, default=100)
    c.add_argument("--preset", default="snmf_nat")
    c.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    _device_arg(c)
    c.add_argument("--dnmf", action="store_true")
    c.add_argument("--vad", action="store_true")
    c.add_argument("--force", action="store_true")
    c.add_argument("--no-carry", action="store_true")
    c.add_argument("--block-adapt", type=int, default=0)
    c.add_argument("--block-iter-cap", type=int, default=0)
    c.add_argument("--dft-matmul", action="store_true")
    c.add_argument("--speech-dc-freq", type=float, default=None,
                   help="per-class DC cutoff Hz (Do_MultiBatch*'s DC_freq_set)")
    c.add_argument("--noise-dc-freq", type=float, default=None)
    c.add_argument("--batch-size", type=int, default=1)
    c.add_argument("--seed", type=int)
    c.set_defaults(fn=cmd_campaign)

    gr = sub.add_parser(
        "grid", help="the reference's IS16 SNR-grid experiment, "
                     "self-contained: synthesize six-noise x four-SNR "
                     "mixtures from a clean-speech wav, train, enhance "
                     "with every algorithm, report the cross-algorithm "
                     "quality battery")
    gr.add_argument("--workspace", required=True,
                    help="grid corpus + outputs root (created if absent)")
    gr.add_argument("--speech-wav",
                    help="clean speech wav the corpus is built from "
                         "(needed when the workspace has no manifest; "
                         "for one that has, it must be the recorded wav)")
    gr.add_argument("--rank", type=int, default=100)
    gr.add_argument("--algorithms", nargs="+",
                    default=["snmf", "snmf_fixed", "imcra", "ms", "bnmf"])
    gr.add_argument("--noises", nargs="+", default=None,
                    help="subset of the six noise types")
    gr.add_argument("--snrs", nargs="+", type=int, default=None)
    gr.add_argument("--clip-seconds", type=float, default=2.4)
    gr.add_argument("--n-clips", type=int, default=3)
    gr.add_argument("--seed", type=int, default=0)
    gr.add_argument("--max-iter", type=int, default=None)
    gr.add_argument("--report", default=None,
                    help="write the JSON report here too")
    _device_arg(gr)
    gr.set_defaults(fn=cmd_grid)

    sv = sub.add_parser(
        "serve", help="TCP enhancement server (multi-tenant lockstep "
                      "fleet; raw int16 PCM in/out per connection)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="0 = OS-assigned (printed on startup)")
    sv.add_argument("--lanes", type=int, default=8)
    sv.add_argument("--sub-fleets", type=int, default=1,
                    help="shard the fleet into N sub-fleets ticked "
                         "back-to-back (lanes must divide evenly; "
                         "stream/serving.ShardedFleet)")
    sv.add_argument("--block-frames", type=int, default=8,
                    help="frames a fleet tick")
    sv.add_argument("--block-adaptive", action="store_true",
                    help="route full blocks through the block-adaptive "
                         "step (throughput plan) instead of the exact "
                         "per-frame step")
    sv.add_argument("--underrun-pad", action="store_true",
                    help="real-time mode: pad lagging clients with "
                         "silence on a wall-clock deadline instead of "
                         "stalling the lockstep fleet")
    _common_enh_args(sv)
    sv.set_defaults(fn=cmd_serve)

    dm = sub.add_parser("demo", help="simulated real-time streaming demo")
    dm.add_argument("input",
                    help="wav path, '-' (stdin raw int16 PCM), or 'mic' "
                         "(in-process capture via optional sounddevice)")
    dm.add_argument("-o", "--output")
    dm.add_argument("--mode", default="snmf",
                    choices=["snmf", "snmf-fixed", "ms", "bnmf", "pmwf"])
    dm.add_argument("--verbose", action="store_true")
    dm.add_argument("--block", type=int, default=1,
                    help="frames per device call (latency/throughput knob)")
    dm.add_argument("--viz-dir",
                    help="dump session PNGs here: input/enhanced "
                         "spectrograms, waveforms, basis evolution "
                         "(the SE_GUI.m plot analogs)")
    dm.add_argument("--ascii-spec", action="store_true",
                    help="print an ASCII spectrogram of the output")
    dm.add_argument("--live-rate", type=int, default=16000,
                    help="sample rate for '-' (stdin raw int16 PCM) input")
    dm.add_argument("--play", action="store_true",
                    help="play enhanced audio on the default output "
                         "device (optional sounddevice dependency; the "
                         "SE_GUI.m:533-566 replay/soundsc analog)")
    dm.add_argument("--pcm-out", action="store_true",
                    help="stream enhanced raw int16 PCM to stdout "
                         "(telemetry JSON moves to stderr)")
    dm.add_argument("--channels", type=int, default=6,
                    help="channel count for '-' input in --mode pmwf "
                         "(stdin is channel-interleaved raw int16)")
    dm.add_argument("--toggle-every", type=int, default=0,
                    help="flip NAT adaptation every N hops (SE_GUI "
                         "push-to-talk parity; 'kill -USR1 <pid>' toggles "
                         "it live in any input mode)")
    _common_enh_args(dm)
    dm.set_defaults(fn=cmd_demo)

    v = sub.add_parser("eval", help="compare two wavs (JSON metrics)")
    v.add_argument("--got", required=True)
    v.add_argument("--want", required=True)
    v.add_argument("--clean", help="clean reference for segSNR/LSD/STOI")
    v.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if hasattr(args, "device"):
        # the card unless --device names another; without one the command
        # stops here, before it reads or writes anything
        try:
            args.device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"{args.command}: {e}") from None
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
