"""The port's command line (``python -m se_snmf_nat_tpu_torch``) on the CPU
(``--device cpu``); ``bench``'s parser and refusals here, its modes in
``tests/test_torch_bench.py``: in
float64 ``enhance`` (three plans, a file and a directory) and ``separate``
write the int16 of the JAX package's library entry points (the JAX CLI
cannot run ``snmf`` without the reference recordings: its ``_load_bases``
reads them before it looks at the flags), ``imcra``, ``ms``, ``train``,
``dnmf`` and ``eval`` the JAX CLI's own output; the refusals (SNMF-only
flags, the BNMF slot, a missing dictionary, bfloat16, a grid workspace
built for another grid or from another speech wav, no card); ``demo`` in
every mode against the port's own session or one-shot run, and its ``ms``,
``bnmf`` and ``pmwf`` modes against the JAX CLI's ``demo``; ``serve`` as a
process; the graft entry point against the JAX package's."""

import argparse
import builtins
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from se_snmf_nat_tpu.cli import main as j_main
from se_snmf_nat_tpu.config import preset as j_preset
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.cli import main
from se_snmf_nat_tpu_torch.config import preset
from se_snmf_nat_tpu_torch.io.basis import BasisPair, load_basis, save_basis
from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FS = 16000
CPU = ["--device", "cpu"]
F64 = torch.float64
LENGTHS = (6400, 8000, 4800)
PLANS = {
    "exact": ("snmf_nat", []),
    "block": ("snmf_nat", ["--block-adapt", "16", "--block-iter-cap", "5",
                           "--block-refit-cap", "5", "--block-fixed-iter",
                           "--dft-matmul"]),
    "fast": ("snmf", []),
}
PLAN_KW = {"exact": {}, "fast": {},
           "block": dict(block_adapt=16, block_iter_cap=5, block_refit_cap=5,
                         block_fixed_iter=True, dft_matmul=True)}


def _write(path, x, fs=FS):
    write_wav_int16(path, np.clip(np.rint(x), -32768, 32767)
                    .astype(np.int16), fs)
    return path


def _pair(seed):
    rng = np.random.default_rng(seed)
    return BasisPair(b_dft=rng.random((513, 100)) + 1e-3,
                     b_mel=rng.random((64, 100)) + 1e-3)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    db = root / "db"
    db.mkdir()
    for i, n in enumerate(LENGTHS):
        _write(db / f"u{i}.wav", fixtures.noisy_utterance(n, seed=i))
    save_basis(root / "b.npz", _pair(4))
    _write(root / "speech.wav", fixtures.clean_utterance(16000, seed=7))
    return root


def _bases(work):
    return ["--speech-basis", str(work / "b.npz"),
            "--noise-basis", str(work / "b.npz")]


def _wav(path):
    return read_wav_int16(path)[0]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _j_enhancer(name):
    """The reference package's enhancer the CLI's flags describe."""
    pre, _ = PLANS[name]
    cfg = j_preset(pre)
    cfg = cfg.evolve(nmf=replace(cfg.nmf, max_iter=5))
    b = _pair(4).b_dft
    return JEnhancer(cfg, b, b, b, b, dtype=jnp.float64, **PLAN_KW[name])


# ---------------------------------------------------------------------------
# enhance and separate against the reference package's library entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", list(PLANS))
def test_enhance_file_equals_reference_library(work, tmp_path, plan, capsys):
    pre, flags = PLANS[plan]
    out = tmp_path / "e.wav"
    rc = main(["enhance", str(work / "db" / "u0.wav"), "-o", str(out),
               "--preset", pre, "--dtype", "float64", "--max-iter", "5",
               *flags, *_bases(work), *CPU])
    assert rc == 0 and f"wrote {out}" in capsys.readouterr().out
    want = _j_enhancer(plan).enhance(_wav(work / "db" / "u0.wav"))
    np.testing.assert_array_equal(_wav(out), want)


def test_enhance_directory_equals_reference_enhance_batch(work, tmp_path,
                                                          capsys):
    """The batch plan of the runner: files chunked in ascending size, each
    chunk one ``enhance_batch``; the reference's ``enhance_batch`` of the
    same chunks gives the same int16."""
    out = tmp_path / "out"
    rc = main(["enhance", str(work / "db"), "-o", str(out), "--dtype",
               "float64", "--max-iter", "5", "--batch-size", "2",
               "--no-carry-state", *_bases(work), *CPU])
    assert rc == 0
    rep = _last_json(capsys.readouterr().out)
    assert rep["processed"] == 3 and rep["skipped"] == 0
    assert set(rep["stages"]) == {"io_read", "enhance", "io_write"}
    order = [f"u{i}" for i in np.argsort(LENGTHS, kind="stable")]
    ref = _j_enhancer("exact")
    for chunk in (order[:2], order[2:]):
        want = ref.enhance_batch([_wav(work / "db" / f"{n}.wav")
                                  for n in chunk])
        for name, w in zip(chunk, want):
            np.testing.assert_array_equal(_wav(out / f"{name}_enh.wav"), w)
    # a second run skips every file
    main(["enhance", str(work / "db"), "-o", str(out), "--dtype", "float64",
          "--max-iter", "5", "--batch-size", "2", *_bases(work), *CPU])
    assert _last_json(capsys.readouterr().out)["skipped"] == 3


def test_separate_equals_reference_library(work, tmp_path, capsys):
    prefix = tmp_path / "sep"
    rc = main(["separate", str(work / "db" / "u1.wav"), "-o", str(prefix),
               "--dtype", "float64", "--max-iter", "5", *_bases(work), *CPU])
    assert rc == 0
    rep = _last_json(capsys.readouterr().out)
    want = _j_enhancer("exact").separate(_wav(work / "db" / "u1.wav"))
    assert rep["events"] == len(want["events"]) >= 1
    assert rep["noises"] == len(want["noises"]) >= 1
    np.testing.assert_array_equal(_wav(f"{prefix}_enhanced.wav"),
                                  want["enhanced"])
    for kind, key in (("event", "events"), ("noise", "noises")):
        for i, w in enumerate(want[key]):
            np.testing.assert_array_equal(_wav(f"{prefix}_{kind}{i}.wav"), w)


def test_reference_root_fills_only_the_side_no_flag_names(work, tmp_path):
    """The repaired ``_load_bases``: the reference's pair is read only for a
    side that no flag names, from ``--reference-root``; with both flags
    given a root that does not exist is never read."""
    conf = "TASLP_Splice0-SNMF_p2_DD0"
    ref_speech, ref_noise = _pair(5), _pair(6)
    for cls, pair in (("Clean_train_TIMIT_test", ref_speech),
                      ("CHiME3_bgn_ch6", ref_noise)):
        d = tmp_path / "reference" / "basis" / cls / conf
        d.mkdir(parents=True)
        sio.savemat(d / "R_100.mat", {"B_DFT_sub": pair.b_dft,
                                      "B_Mel_sub": pair.b_mel})
    src = work / "db" / "u2.wav"
    mine = load_basis(work / "b.npz").b_dft
    common = ["--dtype", "float64", "--max-iter", "5", *CPU]
    main(["enhance", str(src), "-o", str(tmp_path / "a.wav"),
          "--speech-basis", str(work / "b.npz"),
          "--reference-root", str(tmp_path / "reference"), *common])
    cfg = preset("snmf_nat")
    cfg = cfg.evolve(nmf=replace(cfg.nmf, max_iter=5))
    enh = SnmfEnhancer(cfg, mine, ref_noise.b_dft, mine, ref_noise.b_dft,
                       device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(_wav(tmp_path / "a.wav"),
                                  enh.enhance(_wav(src)))
    main(["enhance", str(src), "-o", str(tmp_path / "b.wav"), *_bases(work),
          "--reference-root", str(tmp_path / "no_such_root"), *common])
    np.testing.assert_array_equal(
        _wav(tmp_path / "b.wav"),
        _j_enhancer("exact").enhance(_wav(src)))


@pytest.mark.parametrize("given,missing", [
    ([], ["--speech-basis", "--noise-basis"]),
    (["--speech-basis"], ["--noise-basis"]),
    (["--noise-basis"], ["--speech-basis"])])
def test_missing_dictionary_names_the_flags(work, given, missing):
    argv = ["enhance", str(work / "db" / "u0.wav"), *CPU]
    for flag in given:
        argv += [flag, str(work / "b.npz")]
    with pytest.raises(SystemExit) as e:
        main(argv)
    msg = str(e.value)
    assert "--reference-root" in msg
    assert all(flag in msg for flag in missing)
    assert not any(flag in msg for flag in given)


# ---------------------------------------------------------------------------
# commands held to the JAX CLI's own output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["imcra", "ms"])
def test_baseline_enhance_equals_reference_cli(work, tmp_path, algorithm,
                                               capsys):
    src = str(work / "db" / "u1.wav")
    assert main(["enhance", src, "-o", str(tmp_path / "t.wav"),
                 "--algorithm", algorithm, "--dtype", "float64", *CPU]) == 0
    assert j_main(["enhance", src, "-o", str(tmp_path / "j.wav"),
                   "--algorithm", algorithm, "--dtype", "float64"]) == 0
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())


def test_ms_directory_equals_reference_cli(work, tmp_path, capsys):
    """``ms`` keeps the carry flag on by default and batches anyway."""
    for fn, tag, extra in ((main, "t", CPU), (j_main, "j", [])):
        assert fn(["enhance", str(work / "db"), "-o", str(tmp_path / tag),
                   "--algorithm", "ms", "--dtype", "float64",
                   "--batch-size", "3", *extra]) == 0
    for i in range(3):
        name = f"u{i}_enh.wav"
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())


def test_eval_equals_reference_cli(work, tmp_path, capsys):
    got = work / "db" / "u0.wav"
    want = _write(tmp_path / "w.wav",
                  _wav(got) * 0.5 + fixtures.noise(len(_wav(got)), seed=3))
    clean = _write(tmp_path / "c.wav",
                   fixtures.clean_utterance(LENGTHS[0], seed=0))
    argv = ["eval", "--got", str(got), "--want", str(want),
            "--clean", str(clean)]
    assert main(argv) == 0
    port = _last_json(capsys.readouterr().out)
    assert j_main(argv) == 0
    assert port == _last_json(capsys.readouterr().out)
    assert main(["eval", "--got", str(got), "--want", str(got)]) == 0
    same = _last_json(capsys.readouterr().out)
    assert same["max_abs_err"] == 0.0 and same["corr"] == 1.0


def test_train_equals_reference_cli(work, tmp_path, capsys):
    argv = ["train", "--db", str(work / "db"), "--rank", "6", "--dtype",
            "float64", "--seed", "0"]
    assert main([*argv, "--basis-dir", str(tmp_path / "t"), *CPU]) == 0
    info = _last_json(capsys.readouterr().out)
    assert info["rank"] == 6 and info["b_dft_shape"] == [513, 6]
    assert j_main([*argv, "--basis-dir", str(tmp_path / "j")]) == 0
    got, want = (load_basis(tmp_path / d / "R_6.npz") for d in "tj")
    for a, b in ((got.b_dft, want.b_dft), (got.b_mel, want.b_mel)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12 * abs(b).max())


def test_dnmf_equals_reference_cli(work, tmp_path, capsys):
    sx, sd = _pair(8), _pair(9)          # [B_x, B_d]: r_x + r_d columns
    save_basis(tmp_path / "b200.npz",
               BasisPair(b_dft=np.concatenate([sx.b_dft, sd.b_dft], axis=1),
                         b_mel=np.concatenate([sx.b_mel, sd.b_mel], axis=1)))
    argv = ["dnmf", "--clean", str(work / "speech.wav"), "--noise",
            str(work / "db" / "u0.wav"), "--basis", str(tmp_path / "b200.npz"),
            "--dtype", "float64"]
    assert main([*argv, "--output", str(tmp_path / "t.npz"), *CPU]) == 0
    assert j_main([*argv, "--output", str(tmp_path / "j.npz")]) == 0
    got, want = (load_basis(tmp_path / f"{d}.npz") for d in "tj")
    np.testing.assert_array_equal(got.b_mel, want.b_mel)
    np.testing.assert_allclose(got.b_dft, want.b_dft, rtol=1e-9,
                               atol=1e-12 * abs(want.b_dft).max())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm,flags", [
    ("imcra", ["--dft-matmul"]), ("ms", ["--max-iter", "40"]),
    ("pmwf", ["--block-adapt", "8"]), ("bnmf", ["--block-fixed-iter"])])
def test_snmf_only_flags_refused_for_other_algorithms(algorithm, flags):
    with pytest.raises(SystemExit) as e:
        main(["enhance", "x.wav", "--algorithm", algorithm, *flags, *CPU])
    assert flags[0] in str(e.value) and "snmf" in str(e.value)


def test_bnmf_slot_clear_errors(work):
    with pytest.raises(SystemExit) as e:
        main(["enhance", "x.wav", "--algorithm", "bnmf", *CPU])
    assert "BNMF_nmoh" in str(e.value)
    with pytest.raises(SystemExit, match="--bnmf-noise"):
        main(["enhance", "x.wav", "--algorithm", "bnmf", "--bnmf-speech",
              str(work / "speech.wav"), "--bnmf-mode", "supervised", *CPU])
    with pytest.raises(SystemExit, match="--bnmf-speech"):
        main(["demo", str(work / "db" / "u0.wav"), "--mode", "bnmf", *CPU])


@pytest.mark.parametrize("argv,what", [
    (["enhance", "x.wav"], "--algorithm snmf without --dft-matmul"),
    (["enhance", "x.wav", "--algorithm", "ms"], "--algorithm ms"),
    (["enhance", "x.wav", "--algorithm", "imcra"], "--algorithm imcra"),
    (["campaign", "--speech-db", "s", "--noise-db", "n", "--basis-root",
      "b", "--out-root", "o", "--targets", "t"],
     "campaign without --dft-matmul"),
    (["demo", "DB0", "--mode", "ms"], "demo --mode ms"),
    (["demo", "DB0", "--mode", "snmf", "--dft-matmul"],
     "demo --mode snmf")])
def test_bfloat16_refused_with_a_message(work, argv, what):
    """Where the reference raises in bfloat16 (its FFT takes float32 or
    float64; OM-LSA's frame loop mixes dtypes; the demo's session takes no
    matmul DFT), the port refuses by name and says why, never mapping the
    choice to another dtype.  Where it runs, so does the port
    (``tests/test_torch_bfloat16.py``)."""
    argv = [str(work / "db" / "u0.wav") if a == "DB0" else a for a in argv]
    with pytest.raises(SystemExit) as e:
        main([*argv, "--dtype", "bfloat16", *CPU])
    assert "bfloat16" in str(e.value) and what in str(e.value)
    assert "reference" in str(e.value)


def test_grid_needs_a_speech_wav_and_refuses_another_grid(work, tmp_path,
                                                          monkeypatch,
                                                          capsys):
    ws = tmp_path / "ws"
    with pytest.raises(SystemExit, match="--speech-wav"):
        main(["grid", "--workspace", str(ws), *CPU])
    from se_snmf_nat_tpu_torch.runtime.grid import build_grid_corpus
    speech = _write(tmp_path / "s.wav", fixtures.speechlike(4 * FS, seed=1))
    build_grid_corpus(ws, noises=("tmetro",), snrs=(5,), clip_s=0.5,
                      n_clips=1, train_s=2.0, speech_wav=str(speech))
    base = ["grid", "--workspace", str(ws), "--noises", "tmetro", "--snrs",
            "5", "--clip-seconds", "0.5", "--n-clips", "1", *CPU]
    for flag, value, key in (("--snrs", "10", "snrs"),
                             ("--noises", "nriver", "noises"),
                             ("--clip-seconds", "1.0", "clip_s"),
                             ("--n-clips", "2", "n_clips"),
                             ("--seed", "1", "seed")):
        argv = list(base)
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
        with pytest.raises(SystemExit, match="another grid") as e:
            main(argv)
        assert f"{key}: workspace" in str(e.value)
    # a workspace that records no speech source takes no --speech-wav
    with pytest.raises(SystemExit, match="records no speech source"):
        main([*base, "--speech-wav", str(speech)])
    assert not (ws / "enhanced").exists() and not (ws / "basis").exists()

    # one built by the command records its wav: another wav is refused,
    # the same wav (or none) reuses the corpus
    from se_snmf_nat_tpu_torch.runtime import grid as t_grid
    runs = []
    monkeypatch.setattr(t_grid, "run_grid",
                        lambda root, **kw: runs.append(root) or {})
    ws2 = tmp_path / "ws2"
    base2 = [a if a != str(ws) else str(ws2) for a in base]
    long = _write(tmp_path / "l.wav", fixtures.speechlike(11 * FS, seed=2))
    assert main([*base2, "--speech-wav", str(long)]) == 0
    assert json.loads((ws2 / "manifest.json").read_text())["clips"]
    other = _write(tmp_path / "o.wav", fixtures.speechlike(11 * FS, seed=3))
    with pytest.raises(SystemExit, match="another speech wav") as e:
        main([*base2, "--speech-wav", str(other)])
    assert str(other.resolve()) in str(e.value)
    assert main([*base2, "--speech-wav", str(long)]) == 0
    assert main(base2) == 0
    assert runs == [ws2] * 3


def test_grid_command_runs(tmp_path, capsys):
    speech = _write(tmp_path / "s.wav", fixtures.speechlike(11 * FS, seed=2))
    report = tmp_path / "grid.json"
    rc = main(["grid", "--workspace", str(tmp_path / "ws"), "--speech-wav",
               str(speech), "--noises", "tmetro", "--snrs", "5",
               "--clip-seconds", "1.0", "--n-clips", "1", "--rank", "8",
               "--max-iter", "8", "--algorithms", "snmf", "ms",
               "--report", str(report), *CPU])
    assert rc == 0
    rep = json.loads(report.read_text())
    assert rep == _last_json(capsys.readouterr().out)
    assert set(rep["conditions"]["tmetro/5dB"]) == {"noisy", "snmf", "ms"}
    assert rep["mean_seg_snr_db"]["snmf"] > rep["mean_seg_snr_db"]["noisy"]


def test_campaign_unique_keys_and_state_files(work, tmp_path, capsys):
    """Two targets with one basename: unique output keys, one B_D_u file
    each, every file enhanced."""
    noise_db = tmp_path / "noise_db"
    fixtures.write_wav_dir(noise_db, "noise", 2, 1.0, seed=3)
    targets = []
    for cond in ("condA", "condB"):
        t = tmp_path / cond / "test"
        t.mkdir(parents=True)
        for i in range(2):
            (t / f"u{i}.wav").write_bytes(
                (work / "db" / f"u{i}.wav").read_bytes())
        targets.append(str(t))
    out_root = tmp_path / "out"
    rc = main(["campaign", "--speech-db", str(work / "db"), "--noise-db",
               str(noise_db), "--basis-root", str(tmp_path / "basis"),
               "--out-root", str(out_root), "--targets", *targets,
               "--rank", "8", "--dtype", "float64", "--seed", "0", *CPU])
    assert rc == 0
    res = _last_json(capsys.readouterr().out)
    assert len(res) == 2
    for key, row in res.items():
        assert row["processed"] == 2 and row["skipped"] == 0
        assert (out_root / f"B_D_u_{key}.npz").exists()
        assert len(list((out_root / key).glob("*_enh.wav"))) == 2
    assert (tmp_path / "basis" / "speech" / "R_8.npz").exists()


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

def test_demo_toggle_every_prints_both_toggles(work, capsys):
    rc = main(["demo", str(work / "db" / "u0.wav"), "--mode", "snmf",
               "--block", "4", "--toggle-every", "15", "--verbose",
               *_bases(work), *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "NAT adaptation -> OFF" in out
    assert "NAT adaptation -> ON" in out
    assert _last_json(out)["hops"] == LENGTHS[0] // 160


def _session_equivalent(mode, x, work):
    """The output of the port's own one-shot run that the demo's file mode
    must reproduce (float64)."""
    if mode in ("snmf", "snmf-fixed"):
        cfg = preset("snmf_nat" if mode == "snmf" else "snmf")
        if mode == "snmf-fixed":
            cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
        b = load_basis(work / "b.npz").b_dft
        enh = SnmfEnhancer(cfg, b, b, b, b, device="cpu", dtype=F64)
        return enh.enhance(x, return_state=True)[0]
    if mode == "ms":
        from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
        return MmseEnhancer(FS, device="cpu", dtype=F64).enhance(x)
    from se_snmf_nat_tpu_torch.bnmf import BnmfEnhancer, BnmfParams
    enh = BnmfEnhancer(speech=_wav(work / "speech.wav"),
                       params=BnmfParams(k_speech=100), device="cpu",
                       dtype=F64)
    return enh.enhance(x)


@pytest.mark.parametrize("mode", ["snmf", "snmf-fixed", "ms", "bnmf"])
def test_demo_file_output_equals_one_shot(work, tmp_path, mode, capsys):
    src = work / "db" / "u1.wav"
    out = tmp_path / "d.wav"
    argv = ["demo", str(src), "--mode", mode, "--block", "4", "-o",
            str(out), "--dtype", "float64", *CPU]
    if mode.startswith("snmf"):
        argv += _bases(work)
    if mode == "bnmf":
        argv += ["--bnmf-speech", str(work / "speech.wav")]
    assert main(argv) == 0
    rep = _last_json(capsys.readouterr().out)
    assert rep["mode"] == mode and rep["hops"] == LENGTHS[1] // 160
    want = _session_equivalent(mode, _wav(src), work)
    got = _wav(out)
    if mode == "ms":
        # the chunked MMSE stream holds back its last hop's overlap-add
        # tail: the demo, as the reference's, never flushes it (the bytes
        # equal the JAX CLI's, test_demo_equals_reference_cli)
        assert len(got) == len(want) - 160
        want = want[: len(got)]
    np.testing.assert_array_equal(got, want)


def test_demo_pmwf_equals_the_session(tmp_path, capsys):
    from se_snmf_nat_tpu_torch.multichannel import (
        PmwfParams, PmwfStreamingSession)
    from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
    x, _ = synth_mixture(n=9600, n_ch=3)
    x = np.rint(x)
    paths = [str(_write(tmp_path / f"ch{c}.wav", x[c])) for c in range(3)]
    out = tmp_path / "pmwf.wav"
    assert main(["demo", ",".join(paths), "--mode", "pmwf", "--block", "8",
                 "-o", str(out), "--dtype", "float64", *CPU]) == 0
    rep = _last_json(capsys.readouterr().out)
    assert rep["mode"] == "pmwf" and rep["hops"] == 60
    sess = PmwfStreamingSession(n_ch=3, params=PmwfParams(), block_frames=8,
                                device="cpu", dtype=F64)
    ys = [sess.push(x[:, i: i + 160])[0] for i in range(0, 9600, 160)]
    ys.append(sess.flush()[0])
    np.testing.assert_array_equal(_wav(out), np.concatenate(ys))


@pytest.mark.parametrize("mode", ["ms", "bnmf", "pmwf"])
def test_demo_equals_reference_cli(work, tmp_path, mode, capsys):
    """The JAX CLI's ``demo`` runs these modes without the reference
    recordings, so the demo itself (hop slicing, flush, what is written)
    is held to it: the same wav bytes and the same telemetry but the
    latencies."""
    if mode == "pmwf":
        from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
        x, _ = synth_mixture(n=9600, n_ch=3)
        src = ",".join(str(_write(tmp_path / f"ch{c}.wav", x[c]))
                       for c in range(3))
    else:
        src = str(work / "db" / "u1.wav")
    argv = ["demo", src, "--mode", mode, "--block", "8" if mode == "pmwf"
            else "4", "--dtype", "float64"]
    if mode == "bnmf":
        argv += ["--bnmf-speech", str(work / "speech.wav")]
    reports = []
    for fn, tag, extra in ((main, "t", CPU), (j_main, "j", [])):
        assert fn([*argv, "-o", str(tmp_path / f"{tag}.wav"), *extra]) == 0
        rep = _last_json(capsys.readouterr().out)
        del rep["hop_latency_ms"], rep["realtime"]
        reports.append(rep)
    assert reports[0] == reports[1] and reports[0]["hops"] > 0
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())


def test_demo_pmwf_refuses_mixed_rates(work, tmp_path):
    x = _wav(work / "db" / "u0.wav")[:4000]
    p0 = _write(tmp_path / "c0.wav", x)
    p1 = _write(tmp_path / "c1.wav", x, FS // 2)
    with pytest.raises(SystemExit, match="sample rates differ"):
        main(["demo", f"{p0},{p1}", "--mode", "pmwf", "--block", "8",
              "-o", str(tmp_path / "out.wav"), *CPU])


def test_demo_play_without_sounddevice_exits_clearly(tmp_path, monkeypatch):
    wav = _write(tmp_path / "in.wav", np.zeros(1600))
    real_import = builtins.__import__

    def fake_import(name, *a, **k):
        if name == "sounddevice":
            raise ImportError("no portaudio")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake_import)
    monkeypatch.delitem(sys.modules, "sounddevice", raising=False)
    with pytest.raises(SystemExit, match="sounddevice"):
        main(["demo", str(wav), "--play", *CPU])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_demo_stdin_pcm_out_equals_file_mode(work, tmp_path, capsys):
    """Live input: raw int16 PCM on stdin, enhanced PCM on stdout hop by
    hop, the telemetry on stderr; the stream equals the file mode."""
    src = work / "db" / "u2.wav"
    x = _wav(src)
    main(["demo", str(src), "--mode", "ms", "-o", str(tmp_path / "f.wav"),
          *CPU])
    capsys.readouterr()
    p = subprocess.run(
        [sys.executable, "-m", "se_snmf_nat_tpu_torch", "demo", "-",
         "--mode", "ms", "--pcm-out", "--live-rate", str(FS), *CPU],
        input=np.asarray(x, np.int16).astype("<i2").tobytes(),
        capture_output=True, env=_env(), cwd=tmp_path, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    assert _last_json(p.stderr.decode())["hops"] == len(x) // 160
    np.testing.assert_array_equal(np.frombuffer(p.stdout, "<i2"),
                                  _wav(tmp_path / "f.wav"))


# ---------------------------------------------------------------------------
# serve, the card rule, the graft entry point
# ---------------------------------------------------------------------------

def test_serve_streams_like_a_fleet(work, tmp_path):
    """``serve`` as a process: one JSON line with the address, then a
    client's stream equals a ``MultiStreamSession`` run of its samples.
    Every read has a time limit and the process is killed at the end."""
    import asyncio

    from se_snmf_nat_tpu_torch.runtime.server import enhance_over_socket
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
    proc = subprocess.Popen(
        [sys.executable, "-m", "se_snmf_nat_tpu_torch", "serve", "--lanes",
         "1", "--block-frames", "8", "--max-iter", "5", "--dtype", "float64",
         *_bases(work), *CPU], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=_env(), cwd=tmp_path)
    try:
        line = asyncio.run(asyncio.wait_for(
            asyncio.to_thread(proc.stdout.readline), 120))
        info = json.loads(line)
        assert info["lanes"] == 1 and info["block_frames"] == 8
        assert info["hop"] == 160
        port = int(info["serving"].rsplit(":", 1)[1])
        x = _wav(work / "db" / "u0.wav")
        got = asyncio.run(asyncio.wait_for(
            enhance_over_socket("127.0.0.1", port, x), 120))
    finally:
        proc.kill()
        proc.wait(timeout=30)
    cfg = preset("snmf_nat")
    cfg = cfg.evolve(nmf=replace(cfg.nmf, max_iter=5))
    b = load_basis(work / "b.npz").b_dft
    fleet = MultiStreamSession(SnmfEnhancer(cfg, b, b, b, b, device="cpu",
                                            dtype=torch.float64),
                               1, block_frames=8)
    want = np.concatenate([fleet.push(x[None]), fleet.flush()], axis=1)[0]
    assert len(got) == (len(x) // 160 + 1) * 160
    np.testing.assert_array_equal(np.asarray(got), want)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


@pytest.mark.parametrize("argv", [
    ["enhance", "x.wav"], ["separate", "x.wav"],
    ["train", "--db", "d", "--basis-dir", "b"],
    ["dnmf", "--clean", "c", "--noise", "n", "--basis", "b", "--output",
     "o"],
    ["campaign", "--speech-db", "s", "--noise-db", "n", "--basis-root", "b",
     "--out-root", "o", "--targets", "t"],
    ["grid", "--workspace", "w"], ["serve"], ["demo", "x.wav"],
    ["bench"], ["bench", "--serving"], ["bench", "--quality"]],
    ids=lambda a: "-".join(a[:2]))
def test_every_command_needs_the_card_unless_told(argv):
    """Without a card and without ``--device cpu`` a command stops with
    ``require_cuda()``'s message before it reads anything."""
    _no_cuda()
    with pytest.raises(SystemExit, match="CUDA is not available"):
        main(argv)


def _bench_options(parser) -> dict:
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {o: a.default for a in sub.choices["bench"]._actions
            for o in a.option_strings}


def test_bench_parser_has_every_reference_option():
    """``bench`` takes every option of the reference's ``bench`` with its
    default, plus ``--device`` and ``--reference-root``."""
    from se_snmf_nat_tpu.cli import build_parser as j_build_parser

    from se_snmf_nat_tpu_torch.cli import build_parser
    got, want = _bench_options(build_parser()), _bench_options(
        j_build_parser())
    assert set(got) == set(want) | {"--device", "--reference-root"}
    assert {o: got[o] for o in want} == want


@pytest.mark.parametrize("flag", ["--quality", "--quality-sharded",
                                  "--pareto"])
def test_bench_golden_modes_need_the_reference_root(flag):
    """The modes that score against the reference's golden wavs refuse
    without ``--reference-root`` and name it; they never score against a
    stand-in."""
    with pytest.raises(SystemExit, match="--reference-root") as e:
        main(["bench", flag, *CPU])
    assert flag in str(e.value)


def test_module_without_device_exits_with_require_cuda_message(work,
                                                               tmp_path):
    _no_cuda()
    p = subprocess.run(
        [sys.executable, "-m", "se_snmf_nat_tpu_torch", "enhance",
         str(work / "db" / "u0.wav"), "-o", str(tmp_path / "o.wav"),
         *_bases(work)], capture_output=True, text=True, env=_env(),
        cwd=tmp_path, timeout=240)
    assert p.returncode != 0
    assert "CUDA is not available" in p.stderr
    assert not (tmp_path / "o.wav").exists()


def test_graft_entry_runs_the_flagship_step():
    import __graft_entry__ as j_entry

    from se_snmf_nat_tpu_torch.graft_entry import _tiny_bases, entry
    for got, want in zip(_tiny_bases(), j_entry._tiny_bases()):
        np.testing.assert_array_equal(got, want)
    fn, (frames, state) = entry(device="cpu")
    assert frames.shape == (32, 640) and frames.dtype == torch.float32
    y = fn(frames, state).numpy()
    j_fn, j_args = j_entry.entry()
    want = np.asarray(j_fn(*j_args))
    assert y.shape == want.shape and np.isfinite(y).all()
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
