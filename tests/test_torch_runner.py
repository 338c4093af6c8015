"""The port's directory runner (``se_snmf_nat_tpu_torch.runtime.runner``)
against the JAX package's ``BatchRunner`` on the same wav directories, in
float64 on the CPU: int16 identical file by file on the carry path (the
reference's B_D_u: only the dictionary head crosses a file), the batch
path with and without ``length_sort``, and ``run_multichannel``; the B_D_u
npz of each package read by the other; skip-if-exists; MS without
cross-file state; a channel group of mixed sample rates refused."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.enhance.ms import MmseEnhancer as JMmse
from se_snmf_nat_tpu.multichannel.pmwf import PmwfEnhancer as JPmwf
from se_snmf_nat_tpu.runtime import checkpoint as j_ckpt
from se_snmf_nat_tpu.runtime.runner import BatchRunner as JRunner
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16
from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
from se_snmf_nat_tpu_torch.multichannel.pmwf import PmwfEnhancer
from se_snmf_nat_tpu_torch.runtime import checkpoint as t_ckpt
from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)
FS = 16000
LENGTHS = (8000, 12000, 6000, 9000)


def _cfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                      adapt=replace(cfg.adapt, r_a=4, m_a=10),
                      nmf=replace(cfg.nmf, max_iter=5))


@pytest.fixture(scope="module")
def enhancers():
    cfg = _cfg()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 8, 8, seed=0)
    ref = JEnhancer(cfg, bx, bd, bx, bd, dtype=jnp.float64)
    port = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                        dtype=torch.float64)
    return ref, port


@pytest.fixture(scope="module")
def wav_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("runner") / "db"
    d.mkdir()
    for i, n in enumerate(LENGTHS):
        x = np.rint(fixtures.noisy_utterance(n, seed=i)).astype(np.int16)
        write_wav_int16(d / f"u{i}.wav", x, FS)
    return d


def _outputs(out_dir, suffix="_enh"):
    return {p.name: read_wav_int16(p)[0]
            for p in sorted(out_dir.glob(f"*{suffix}.wav"))}


def _assert_same_files(got_dir, want_dir, n):
    got, want = _outputs(got_dir), _outputs(want_dir)
    assert len(got) == n and got.keys() == want.keys()
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_carry_path_int16_identical_to_reference(enhancers, wav_db,
                                                 tmp_path):
    ref, port = enhancers
    rep_j = JRunner(ref, carry_state=True, verbose=False,
                    state_path=tmp_path / "j.npz").run(wav_db, tmp_path / "j")
    rep_t = BatchRunner(port, carry_state=True, verbose=False,
                        state_path=tmp_path / "t.npz").run(wav_db,
                                                           tmp_path / "t")
    assert rep_t.processed == rep_j.processed == [f"u{i}.wav"
                                                  for i in range(4)]
    _assert_same_files(tmp_path / "t", tmp_path / "j", 4)
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert a.files == b.files == ["b_d_head"]
        np.testing.assert_allclose(a["b_d_head"], b["b_d_head"], rtol=1e-9,
                                   atol=1e-12)
    assert rep_t.seconds_audio == pytest.approx(sum(LENGTHS) / FS)


def test_carry_is_dictionary_head_only(enhancers, wav_db, tmp_path):
    """File n+1 starts from the initial state with only ``b_d_head`` taken
    from file n (NTF_sep_event_RT.m:28-46,136-139)."""
    _, port = enhancers
    BatchRunner(port, carry_state=True, verbose=False).run(wav_db, tmp_path)
    init = port.initial_state()
    state = init
    for f in sorted(wav_db.iterdir()):
        x, _ = read_wav_int16(f)
        want, st = port.enhance(x, state=state, return_state=True)
        state = init._replace(b_d_head=st.b_d_head)
        got, _ = read_wav_int16(tmp_path / f"{f.stem}_enh.wav")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length_sort", [True, False])
def test_batch_path_int16_identical_to_reference(enhancers, wav_db,
                                                 tmp_path, length_sort):
    ref, port = enhancers
    JRunner(ref, carry_state=False, verbose=False,
            length_sort=length_sort).run(wav_db, tmp_path / "j",
                                         batch_size=3)
    rep = BatchRunner(port, carry_state=False, verbose=False,
                      length_sort=length_sort).run(wav_db, tmp_path / "t",
                                                   batch_size=3)
    order = ([f"u{i}.wav" for i in np.argsort(LENGTHS, kind="stable")]
             if length_sort else [f"u{i}.wav" for i in range(4)])
    assert rep.processed == order
    _assert_same_files(tmp_path / "t", tmp_path / "j", 4)


def test_length_sort_only_reorders(enhancers, wav_db, tmp_path):
    _, port = enhancers
    for tag, on in (("s", True), ("u", False)):
        BatchRunner(port, carry_state=False, verbose=False,
                    length_sort=on).run(wav_db, tmp_path / tag, batch_size=2)
    _assert_same_files(tmp_path / "s", tmp_path / "u", 4)


def test_state_file_crosses_packages(enhancers, wav_db, tmp_path):
    """A B_D_u written by one package seeds the other's runner: the port
    started from the JAX package's file equals the JAX runner started from
    it, and each package's loader reads the other's file."""
    ref, port = enhancers
    first = tmp_path / "first"
    first.mkdir()
    (first / "u0.wav").write_bytes((wav_db / "u0.wav").read_bytes())
    JRunner(ref, verbose=False, state_path=tmp_path / "j.npz").run(
        first, tmp_path / "j0")
    BatchRunner(port, verbose=False, state_path=tmp_path / "t.npz").run(
        first, tmp_path / "t0")
    j_into_t = t_ckpt.load_adapted_dictionary(
        tmp_path / "j.npz", port.initial_state(), torch.float64)
    t_into_j = j_ckpt.load_adapted_dictionary(
        tmp_path / "t.npz", ref.initial_state(), jnp.float64)
    np.testing.assert_allclose(j_into_t.b_d_head.numpy(),
                               np.asarray(t_into_j.b_d_head), rtol=1e-9,
                               atol=1e-12)
    # both runners continue from the JAX package's file over the rest
    rest = tmp_path / "rest"
    rest.mkdir()
    for i in (1, 2, 3):
        (rest / f"u{i}.wav").write_bytes((wav_db / f"u{i}.wav").read_bytes())
    (tmp_path / "j_for_t.npz").write_bytes((tmp_path / "j.npz").read_bytes())
    JRunner(ref, verbose=False, state_path=tmp_path / "j.npz").run(
        rest, tmp_path / "j1")
    BatchRunner(port, verbose=False, state_path=tmp_path / "j_for_t.npz"
                ).run(rest, tmp_path / "t1")
    _assert_same_files(tmp_path / "t1", tmp_path / "j1", 3)


def test_skip_if_exists_and_force(enhancers, wav_db, tmp_path):
    _, port = enhancers
    rep = BatchRunner(port, verbose=False).run(wav_db, tmp_path)
    assert len(rep.processed) == 4 and not rep.skipped
    before = _outputs(tmp_path)
    rep2 = BatchRunner(port, verbose=False).run(wav_db, tmp_path,
                                                batch_size=2)
    assert not rep2.processed and len(rep2.skipped) == 4
    assert rep2.seconds_audio == 0.0
    rep3 = BatchRunner(port, verbose=False, force_rewrite=True,
                       carry_state=True).run(wav_db, tmp_path)
    assert len(rep3.processed) == 4 and not rep3.skipped
    for name, y in _outputs(tmp_path).items():
        np.testing.assert_array_equal(y, before[name])


@pytest.mark.parametrize("batch_size", [1, 3])
def test_ms_runs_one_shot_per_file_and_matches_reference(wav_db, tmp_path,
                                                         batch_size):
    """An enhancer without a dictionary head carries nothing across files,
    and batches despite the carry flag: every output is the one-shot
    enhancement of its file, as the JAX runner's."""
    port = MmseEnhancer(fs=FS, dtype=torch.float64, device="cpu")
    rep = BatchRunner(port, carry_state=True, verbose=False).run(
        wav_db, tmp_path / "t", batch_size=batch_size)
    assert len(rep.processed) == 4
    JRunner(JMmse(fs=FS, dtype=jnp.float64), carry_state=True,
            verbose=False).run(wav_db, tmp_path / "j",
                               batch_size=batch_size)
    _assert_same_files(tmp_path / "t", tmp_path / "j", 4)
    for f in sorted(wav_db.iterdir()):
        x, _ = read_wav_int16(f)
        got, _ = read_wav_int16(tmp_path / "t" / f"{f.stem}_enh.wav")
        np.testing.assert_array_equal(got, port.enhance(x))


def _mc_db(path, rates=(FS, FS)):
    x, _ = synth_mixture(n=12000, n_ch=2)
    path.mkdir()
    for sess in range(2):
        for c in range(2):
            write_wav_int16(path / f"s{sess}_ch{c}.wav",
                            np.rint(x[c] * (1.0 + 0.1 * sess))
                            .astype(np.int16), rates[c])
    return path


def test_run_multichannel_int16_identical_to_reference(tmp_path):
    db = _mc_db(tmp_path / "db")
    port = PmwfEnhancer(dtype=torch.float64, device="cpu")
    rep = BatchRunner(port, verbose=False).run(db, tmp_path / "t", ch=2)
    assert len(rep.processed) == 4 and not rep.skipped
    assert set(rep.timer.stages) == {"io_read", "enhance", "io_write"}
    JRunner(JPmwf(dtype=jnp.float64), verbose=False).run(
        db, tmp_path / "j", ch=2)
    _assert_same_files(tmp_path / "t", tmp_path / "j", 4)
    rep2 = BatchRunner(port, verbose=False).run(db, tmp_path / "t", ch=2)
    assert not rep2.processed and len(rep2.skipped) == 4
    for bad in ({"ch": 0}, {"ch": 2, "filegap": 0}):
        with pytest.raises(ValueError):
            BatchRunner(port, verbose=False).run(db, tmp_path / "t", **bad)


def test_run_multichannel_refuses_mixed_rates(tmp_path):
    """A channel group whose files differ in sample rate would be
    beamformed sample-misaligned; the port raises before enhancing it."""
    db = _mc_db(tmp_path / "db", rates=(FS, FS // 2))
    port = PmwfEnhancer(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="sample rates"):
        BatchRunner(port, verbose=False).run(db, tmp_path / "t", ch=2)
    assert not list((tmp_path / "t").glob("*.wav"))


@pytest.mark.parametrize("batch_size,carry", [(1, True), (2, False)])
def test_report_times_every_stage(enhancers, wav_db, tmp_path, batch_size,
                                  carry):
    _, port = enhancers
    rep = BatchRunner(port, carry_state=carry, verbose=False).run(
        wav_db, tmp_path, batch_size=batch_size)
    assert set(rep.timer.stages) == {"io_read", "enhance", "io_write"}
    assert rep.timer.audio_seconds == pytest.approx(sum(LENGTHS) / FS)
    assert rep.realtime_factor > 0
    assert rep.timer.report()["audio_seconds"] == round(sum(LENGTHS) / FS, 3)
