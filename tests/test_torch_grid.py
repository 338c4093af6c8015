"""The port's SNR-grid campaign (``se_snmf_nat_tpu_torch.runtime.grid``)
against the JAX package's: the corpus both packages build from the same
synthetic speech wav and seed, byte for byte; every noise generator bit
for bit; and a tiny ``run_grid`` (``tmetro`` at 5 dB, one clip, rank 8,
``snmf``, ``snmf_fixed`` and ``ms``) whose enhanced files are, in float64,
the int16 files of the reference package's ground truth: the JAX grid's
for ``ms``, the NumPy oracle's for the SNMF family."""

from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.runtime import grid as j_grid
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
from se_snmf_nat_tpu_torch.runtime import grid as t_grid

torch.set_num_threads(1)
FS = 16000
TINY = dict(noises=("tmetro",), snrs=(5,), clip_s=1.6, n_clips=1,
            train_s=5.0)
ALGS = ("snmf", "snmf_fixed", "ms")


def _speech_wav(path: Path, seconds: float) -> Path:
    """A clean speech-like wav at the level the corpus normalises to."""
    x = fixtures.speechlike(int(seconds * FS), seed=11)
    write_wav_int16(path, np.clip(np.rint(x), -32768, 32767)
                    .astype(np.int16), FS)
    return path


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kind", t_grid.NOISE_TYPES)
@pytest.mark.parametrize("variant", [0.0, 1.0])
def test_synth_noise_bit_equal(kind, variant):
    speech = np.random.default_rng(3).standard_normal(8000)
    want = j_grid.synth_noise(kind, 6000, FS, np.random.default_rng(0),
                              speech, variant=variant)
    got = t_grid.synth_noise(kind, 6000, FS, np.random.default_rng(0),
                             speech, variant=variant)
    np.testing.assert_array_equal(got, want)


def test_corpus_bytes_identical_to_reference(tmp_path):
    """Every file of the corpus (speech training clips, noise training
    audio, clean clips, all mixtures) and the manifest are the JAX
    package's bytes, for all six noise types."""
    src = _speech_wav(tmp_path / "speech.wav", 4.5)
    kw = dict(noises=t_grid.NOISE_TYPES, snrs=(0, 10), clip_s=0.5,
              n_clips=2, train_s=2.0, seed=3, speech_wav=str(src))
    m_t = t_grid.build_grid_corpus(tmp_path / "t", **kw)
    m_j = j_grid.build_grid_corpus(tmp_path / "j", **kw)
    assert m_t == m_j
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert got.keys() == want.keys()
    assert len(got) == 1 + 6 + 2 + 6 * 2 * 2 + 1   # 2 s of training: one clip
    for name in got:
        assert got[name] == want[name], name


def test_corpus_needs_a_speech_source(tmp_path):
    """The port reads no fixed path: the speech wav is an argument."""
    with pytest.raises(TypeError, match="speech_wav"):
        t_grid.build_grid_corpus(tmp_path, **TINY)


@pytest.fixture(scope="module")
def tiny_grid(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    src = _speech_wav(root / "speech.wav", 8.0)
    t_grid.build_grid_corpus(root / "ws", speech_wav=str(src), **TINY)
    return root / "ws"


def test_tiny_grid_end_to_end(tiny_grid):
    """Corpus -> train -> enhance (3 algorithms) -> battery on the port
    alone (float32 on the CPU): the report's structure, every output
    written, and the SNMF family above the noisy input."""
    rep = t_grid.run_grid(tiny_grid, algorithms=ALGS, rank=8, max_iter=8,
                          verbose=False, device="cpu")
    cond = rep["conditions"]["tmetro/5dB"]
    assert set(cond) == {"noisy", *ALGS}
    for alg in ALGS:
        assert np.isfinite(cond[alg]["seg_snr_db"])
        assert cond[alg]["stoi"] is not None
        assert (tiny_grid / "enhanced" / alg / "tmetro" / "5dB"
                / "clip_00.wav").exists()
    means = rep["mean_seg_snr_db"]
    assert means["snmf"] > means["noisy"]
    assert means["snmf_fixed"] > means["noisy"]
    assert "nat_minus_fixed_seg_snr_db" in rep


def test_tiny_grid_int16_identical_to_reference_and_oracle(tmp_path):
    """In float64 the port's grid writes, for every algorithm, the int16
    file of the reference package's float64 ground truth: the JAX
    ``run_grid``'s for ``ms``, and the NumPy oracle's
    (``oracle.runner_np.enhance_samples_oracle``) on the same dictionaries
    for the SNMF family.  The JAX package's own SNMF outputs miss that
    oracle on this corpus: its noise-only lead-in is where the reference's
    prefix-sum block-sparsity statistic loses digits (ROADMAP §3), so they
    are not the yardstick.  The noisy baseline and ``ms`` rows of the two
    reports are equal."""
    from se_snmf_nat_tpu.config import default_config
    from se_snmf_nat_tpu.oracle.runner_np import enhance_samples_oracle
    from se_snmf_nat_tpu_torch.io.basis import load_basis
    from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16

    src = _speech_wav(tmp_path / "speech.wav", 8.0)
    for tag in ("t", "j"):
        t_grid.build_grid_corpus(tmp_path / tag, speech_wav=str(src), **TINY)
    rep_t = t_grid.run_grid(tmp_path / "t", algorithms=ALGS, rank=8,
                            max_iter=8, verbose=False, device="cpu",
                            dtype=torch.float64)
    rep_j = j_grid.run_grid(tmp_path / "j", algorithms=("ms",), rank=8,
                            max_iter=8, verbose=False, dtype=jnp.float64)
    cond = "tmetro/5dB"
    for row in ("noisy", "ms"):
        assert rep_t["conditions"][cond][row] == rep_j["conditions"][cond][row]
    rel = Path("tmetro") / "5dB" / "clip_00.wav"
    assert ((tmp_path / "t" / "enhanced" / "ms" / rel).read_bytes()
            == (tmp_path / "j" / "enhanced" / "ms" / rel).read_bytes())

    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                     adapt=replace(cfg.adapt, r_a=4),
                     nmf=replace(cfg.nmf, max_iter=8))
    sp = load_basis(tmp_path / "t" / "basis" / "speech" / "R_8.npz")
    nz = load_basis(tmp_path / "t" / "basis" / "tmetro" / "R_8.npz")
    x, _ = read_wav_int16(tmp_path / "t" / "noisy" / rel)
    for alg, c in (("snmf", cfg),
                   ("snmf_fixed", cfg.evolve(adapt=replace(
                       cfg.adapt, adapt_train_n=False)))):
        want = enhance_samples_oracle(x, c, sp.b_dft, nz.b_dft, sp.b_dft,
                                      nz.b_dft)
        got, _ = read_wav_int16(tmp_path / "t" / "enhanced" / alg / rel)
        np.testing.assert_array_equal(got, want, err_msg=alg)
