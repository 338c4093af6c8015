"""Port parity of dictionary training (``se_snmf_nat_tpu_torch.train``)
against the JAX package, on the CPU at small sizes.

- The NumPy copies (VAD, training sequence, annotations, features,
  k-means, the exemplar draw) give the reference's values bit for bit on
  seeded inputs and the same tmp wav directories with the same ``rng``.
- ``train_event_basis`` in float64 within 1e-9 relative (to the largest
  entry) of JAX in x64, at r=8 with 12 fixed trips and at eps 1e-3 with
  equal trip counts, and within 1e-9 of the float64 oracle
  ``oracle/sparse_nmf_np``; the exemplar mode with k-means picks the same
  columns.  float32: the port's gap to JAX float32 stays within twice JAX's
  own float32-to-x64 gap, plus 1e-6 (the ROADMAP's float32 rule).
- ``train_event_basis_cached``: checkpoints that load in either package,
  the cache hit, the stale-options warning.
- ``dnmf_refit`` (DFT and Mel) in float64 within 1e-9 of JAX in x64.
- The slice as a whole: dictionaries trained by each package in float64
  from the same wav directories enhance a noisy utterance on each
  package's exact plan to identical int16 output, and both improve its
  segmental SNR.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu import metrics as j_metrics
from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.io.basis import load_basis as j_load_basis
from se_snmf_nat_tpu.oracle.sparse_nmf_np import sparse_nmf_np
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu.train import basis as j_basis
from se_snmf_nat_tpu.train import dataset as j_dataset
from se_snmf_nat_tpu.train import dnmf as j_dnmf
from se_snmf_nat_tpu.train import features as j_features
from se_snmf_nat_tpu.train import kmeans as j_kmeans
from se_snmf_nat_tpu.train import vad as j_vad
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch import metrics as t_metrics
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.io.basis import load_basis as t_load_basis
from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.train import basis as t_basis
from se_snmf_nat_tpu_torch.train import dataset as t_dataset
from se_snmf_nat_tpu_torch.train import dnmf as t_dnmf
from se_snmf_nat_tpu_torch.train import features as t_features
from se_snmf_nat_tpu_torch.train import kmeans as t_kmeans
from se_snmf_nat_tpu_torch.train import vad as t_vad

torch.set_num_threads(1)
FS = 16000
CPU64 = dict(device="cpu", dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _evolve(cfg, **sections):
    return cfg.evolve(**{k: replace(getattr(cfg, k), **v)
                         for k, v in sections.items()})


# ---------------------------------------------------------------------------
# the NumPy copies, bit for bit
# ---------------------------------------------------------------------------

def _tone_with_silence():
    rng = np.random.default_rng(0)
    sil = rng.standard_normal(int(0.3 * FS)) * 10.0
    tone = np.sin(2 * np.pi * 440 * np.arange(int(0.6 * FS)) / FS) * 8000.0
    return np.concatenate([sil, tone, sil])


@pytest.mark.parametrize("thr,bg_len", [(0.7, None), (0.3, 400)])
def test_energy_vad_and_apply_vad_bit_equal(thr, bg_len):
    x = _tone_with_silence()
    got = t_vad.energy_vad(x, FS, bg_len=bg_len, thr=thr)
    np.testing.assert_array_equal(got, j_vad.energy_vad(x, FS, bg_len, thr))
    assert 0 < got.sum() < len(x)
    np.testing.assert_array_equal(t_vad.apply_vad(x, got),
                                  j_vad.apply_vad(x, got))
    np.testing.assert_array_equal(t_vad.energy_vad(x[:100], FS),
                                  j_vad.energy_vad(x[:100], FS))


def test_normalize_clip_bit_equal():
    x = np.random.default_rng(1).standard_normal(1000) * 123.0
    got = t_dataset.normalize_clip(x)
    np.testing.assert_array_equal(got, j_dataset.normalize_clip(x))
    assert np.max(np.abs(got)) == pytest.approx(30000.0)


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """Speech-like and noise clips (int16 wavs) of different lengths."""
    root = tmp_path_factory.mktemp("wavs")
    speech = fixtures.write_wav_dir(root / "speech", "speech", 3, 2.0,
                                    seed=10)
    noise = fixtures.write_wav_dir(root / "noise", "noise", 3, 2.0, seed=20)
    fixtures.write_wav_dir(root / "short", "speech", 1, 0.5, seed=30)
    (root / "short" / "speech_000.wav").rename(root / "noise" / "tail.wav")
    (root / "vad").mkdir()
    for i in range(2):          # tones between near-silences, for the VAD
        x = np.round(_tone_with_silence() * (1.0 - 0.3 * i))
        write_wav_int16(root / "vad" / f"tone_{i}.wav", x.astype(np.int16),
                        FS)
    return speech, noise


SEQ_CASES = {
    "shuffled": dict(),
    "caps": dict(train=dict(train_file_len_max_s=0.75,
                            train_seq_len_max_s=2.0)),
    "subsample": dict(train=dict(clip_subsample=2)),
    "annotations": dict(train=dict(train_anot=True,
                                   train_file_len_max_s=1.0)),
    "vad": dict(),
}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_build_training_sequence_bit_equal(wav_dirs, tmp_path, case):
    _, noise_dir = wav_dirs
    if case == "vad":
        noise_dir = noise_dir.parent / "vad"
    cfg = _evolve(default_config(), **SEQ_CASES[case])
    anno = tmp_path / "anno"
    anno.mkdir()
    (anno / "noise_001_sid.txt").write_text("0.25 1.5\n")
    outs = []
    for mod in (t_dataset, j_dataset):
        seq, spec = mod.build_training_sequence(
            noise_dir, config_from_jax(cfg) if mod is t_dataset else cfg,
            vad=case == "vad", rng=np.random.default_rng(3),
            anno_dir=anno)
        outs.append((seq, [f.name for f in spec.files], spec.total_samples))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]
    assert len(outs[0][0]) == outs[0][2] > 0
    assert outs[0][1] != sorted(outs[0][1]) or case == "subsample"


def test_load_annotation_equal(tmp_path):
    (tmp_path / "a_sid.txt").write_text("0.0 9.0\n")
    (tmp_path / "b_sid.txt").write_text("0.1234 0.5\n")
    for stem in ("a", "b", "missing"):
        assert (t_dataset.load_annotation(stem, 12000, FS, tmp_path)
                == j_dataset.load_annotation(stem, 12000, FS, tmp_path))


FEATURE_CASES = {
    "default": dict(),
    "splice1_dd": dict(sep=dict(splice=1), train=dict(domain_dd=True)),
    "preemph": dict(signal=dict(preemph=0.97)),
}


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_training_features_bit_equal(case):
    cfg = _evolve(default_config(), **FEATURE_CASES[case])
    s = np.random.default_rng(5).standard_normal(FS) * 5000.0
    for dc_bin in (None, 10):
        got = t_features.training_features(s, config_from_jax(cfg), dc_bin)
        want = j_features.training_features(s, cfg, dc_bin)
        np.testing.assert_array_equal(got.tf_mag, want.tf_mag)
        np.testing.assert_array_equal(got.tf_mel, want.tf_mel)
    blocks = 2 * cfg.sep.splice + 1
    assert got.tf_mel.shape[0] == cfg.signal.f_order * blocks


@pytest.mark.parametrize("n_cols,k", [(16, 8), (200, 8)])
def test_kmeans_bit_equal(n_cols, k):
    """Both seedings: k-means++ (n <= 10k) and the 10% subsample."""
    b = np.random.default_rng(n_cols).random((12, n_cols))
    np.testing.assert_array_equal(
        t_kmeans.kmeans_reduce(b, k, rng=np.random.default_rng(0)),
        j_kmeans.kmeans_reduce(b, k, rng=np.random.default_rng(0)))
    got = t_kmeans.kmeans_cityblock(b.T, k, rng=np.random.default_rng(1))
    want = j_kmeans.kmeans_cityblock(b.T, k, rng=np.random.default_rng(1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_exemplar_sample_idx_equal():
    got = t_basis.exemplar_sample_idx(500, 40, seed=3)
    np.testing.assert_array_equal(got, j_basis.exemplar_sample_idx(500, 40,
                                                                   seed=3))
    assert len(np.unique(got)) == 40


# ---------------------------------------------------------------------------
# train_event_basis against JAX in x64 and the oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_cfg():
    cfg = default_config()
    return cfg.evolve(
        sep=replace(cfg.sep, r_x=8, r_d=8),
        nmf=replace(cfg.nmf, max_iter=12, conv_eps=0.0),
        runtime=replace(cfg.runtime, dtype="float64"),
    )


@pytest.fixture(scope="module")
def features(train_cfg):
    s = np.random.default_rng(5).standard_normal(FS * 2) * 5000.0
    return j_features.training_features(s, train_cfg)


@pytest.mark.parametrize("conv_eps,max_iter", [(0.0, 12), (1e-3, 100)])
def test_train_event_basis_matches_jax_x64(train_cfg, features, conv_eps,
                                           max_iter):
    cfg = _evolve(train_cfg, nmf=dict(conv_eps=conv_eps, max_iter=max_iter))
    want = j_basis.train_event_basis(features, cfg, 8, dtype=jnp.float64)
    got = t_basis.train_event_basis(features, config_from_jax(cfg), 8,
                                    **CPU64)
    assert (got.iters_dft, got.iters_mel) == (want.iters_dft,
                                              want.iters_mel)
    if conv_eps > 0:
        assert 1 < got.iters_dft < max_iter and 1 < got.iters_mel < max_iter
    for name in ("a_dft", "a_mel"):
        assert _rel(getattr(got, name), getattr(want, name)) < 1e-9, name
    for name in ("b_dft", "b_mel"):
        assert _rel(getattr(got.basis, name),
                    getattr(want.basis, name)) < 1e-9, name
    assert got.basis.b_dft.shape == (cfg.signal.n_bins, 8)
    assert got.n_frames == want.n_frames


def test_train_event_basis_matches_oracle(train_cfg, features):
    """The same exemplar init, the V4-seeded H init and the same MU trips
    as the float64 oracle transcription of sparse_nmf.m."""
    got = t_basis.train_event_basis(features, config_from_jax(train_cfg), 8,
                                    **CPU64)
    idx = t_basis.exemplar_sample_idx(features.tf_mag.shape[1], 8, seed=1)
    w_ref, _, _ = sparse_nmf_np(
        features.tf_mag, cf="kl", sparsity=5.0,
        max_iter=train_cfg.nmf.max_iter, conv_eps=0.0, random_seed=1,
        init_w=features.tf_mag[:, idx])
    wn = np.sqrt((w_ref * w_ref).sum(0))
    assert _rel(got.basis.b_dft, w_ref / wn + 1e-9) < 1e-9


def test_train_event_basis_f32_within_reference_envelope(train_cfg,
                                                         features):
    want64 = j_basis.train_event_basis(features, train_cfg, 8,
                                       dtype=jnp.float64)
    want32 = j_basis.train_event_basis(features, train_cfg, 8,
                                       dtype=jnp.float32)
    got = t_basis.train_event_basis(features, config_from_jax(train_cfg), 8,
                                    device="cpu", dtype=torch.float32)
    for name in ("b_dft", "b_mel"):
        g, w32, w64 = (getattr(r.basis, name) for r in (got, want32, want64))
        assert g.dtype == np.float32
        assert _rel(g, w32) <= 2.0 * _rel(w32, w64) + 1e-6, name


def test_exemplar_mode_with_kmeans_picks_the_same_columns(train_cfg,
                                                          features):
    cfg = _evolve(train_cfg, train=dict(train_exemplar=True, cluster_buff=2))
    want = j_basis.train_event_basis(features, cfg, 8, dtype=jnp.float64,
                                     kmeans_rng=np.random.default_rng(0))
    got = t_basis.train_event_basis(features, config_from_jax(cfg), 8,
                                    kmeans_rng=np.random.default_rng(0),
                                    **CPU64)
    assert got.a_dft is None and got.iters_dft == 0
    np.testing.assert_array_equal(got.basis.b_dft, want.basis.b_dft)
    np.testing.assert_array_equal(got.basis.b_mel, want.basis.b_mel)


def test_rank_beyond_the_frames_raises(train_cfg, features):
    t = features.tf_mag.shape[1]
    with pytest.raises(ValueError):
        t_basis.train_event_basis(features, config_from_jax(train_cfg),
                                  t + 1, **CPU64)


def test_cached_round_trip_across_packages(wav_dirs, tmp_path, train_cfg):
    speech_dir, _ = wav_dirs
    cfg = _evolve(train_cfg, train=dict(train_seq_len_max_s=2.0))
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    got = t_basis.train_event_basis_cached(
        speech_dir, port_dir, config_from_jax(cfg), 8,
        shuffle_rng=np.random.default_rng(2), **CPU64)
    want = j_basis.train_event_basis_cached(
        speech_dir, ref_dir, cfg, 8, dtype=jnp.float64,
        shuffle_rng=np.random.default_rng(2))
    assert _rel(got.b_dft, want.b_dft) < 1e-9
    assert (port_dir / "R_8.npz").exists()
    assert (port_dir / "R_8.opts.json").read_text() \
        == (ref_dir / "R_8.opts.json").read_text()
    # each package loads the other's checkpoint, as a cache hit too
    np.testing.assert_array_equal(j_load_basis(port_dir / "R_8.npz").b_mel,
                                  got.b_mel)
    hit = t_basis.train_event_basis_cached(
        speech_dir, ref_dir, config_from_jax(cfg), 8, **CPU64)
    np.testing.assert_array_equal(hit.b_dft, want.b_dft)
    np.testing.assert_array_equal(t_load_basis(ref_dir / "R_8.npz").b_dft,
                                  want.b_dft)
    # a hit under other options warns; force_retrain trains again
    with pytest.warns(UserWarning, match="different training options"):
        t_basis.train_event_basis_cached(speech_dir, port_dir,
                                         config_from_jax(cfg), 8,
                                         vad=True, **CPU64)
    again = t_basis.train_event_basis_cached(
        speech_dir, port_dir, config_from_jax(cfg), 8, force_retrain=True,
        dc_freq=300.0, shuffle_rng=np.random.default_rng(2), **CPU64)
    assert not np.array_equal(again.b_dft, got.b_dft)


# ---------------------------------------------------------------------------
# DNMF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("domain", ["DFT", "Mel"])
def test_dnmf_refit_matches_jax_x64(train_cfg, domain):
    cfg = _evolve(train_cfg, nmf=dict(max_iter=40, conv_eps=1e-3))
    rng = np.random.default_rng(11)
    x = rng.standard_normal(FS) * 4000.0
    d = rng.standard_normal(FS + 500) * 2000.0
    f = cfg.signal.n_bins if domain == "DFT" else cfg.signal.f_order
    b = rng.random((f, 16)) + 1e-3
    want = j_dnmf.dnmf_refit(x, d, b, cfg, domain=domain, dtype=jnp.float64)
    got = t_dnmf.dnmf_refit(x, d, b, config_from_jax(cfg), domain=domain,
                            **CPU64)
    assert got.shape == (f, 16) and got.dtype == np.float64
    assert _rel(got, want) < 1e-9
    np.testing.assert_allclose(np.sqrt((got * got).sum(0)), 1.0, atol=1e-9)
    with pytest.raises(ValueError, match="expected 16"):
        t_dnmf.dnmf_refit(x, d, b[:, :15], config_from_jax(cfg),
                          domain=domain, **CPU64)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_trained_dictionaries_enhance_identically(wav_dirs, tmp_path):
    """Train speech and noise dictionaries with each package in float64
    from the same wav directories (cap 100, eps 1e-3), enhance the same
    noisy utterance on each package's exact plan: identical int16, and the
    segmental SNR against the clean signal improves in both."""
    speech_dir, noise_dir = wav_dirs
    cfg = _evolve(default_config(), sep=dict(r_x=16, r_d=16),
                  adapt=dict(r_a=8, m_a=12), blk=dict(p_len_l=4))
    port_cfg = config_from_jax(cfg)
    bases = {}
    for name, db in (("speech", speech_dir), ("noise", noise_dir)):
        bases["ref", name] = j_basis.train_event_basis_cached(
            db, tmp_path / "ref" / name, cfg, 16, dtype=jnp.float64,
            shuffle_rng=np.random.default_rng(4))
        bases["port", name] = t_basis.train_event_basis_cached(
            db, tmp_path / "port" / name, port_cfg, 16,
            shuffle_rng=np.random.default_rng(4), **CPU64)
        assert _rel(bases["port", name].b_dft, bases["ref", name].b_dft) \
            < 1e-9
    n = 7900
    x = fixtures.noisy_utterance(n, seed=77)
    clean = fixtures.clean_utterance(n, seed=77)
    bx, bd = bases["ref", "speech"].b_dft, bases["ref", "noise"].b_dft
    want = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64).enhance(x)
    bx, bd = bases["port", "speech"].b_dft, bases["port", "noise"].b_dft
    got = SnmfEnhancer(port_cfg, bx, bd, bx, bd, **CPU64).enhance(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    snr_in = t_metrics.segmental_snr(clean, x, FS)
    snr_port = t_metrics.segmental_snr(clean, got.astype(float), FS)
    snr_ref = j_metrics.segmental_snr(clean, want.astype(float), FS)
    print(f"segmental SNR: noisy {snr_in:.3f} dB, port {snr_port:.3f}, "
          f"reference {snr_ref:.3f}")
    assert snr_port == snr_ref
    assert snr_port > snr_in
