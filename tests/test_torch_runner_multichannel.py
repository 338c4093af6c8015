"""``BatchRunner.run_multichannel`` with a batch size: its channel groups
go through ``PmwfEnhancer.enhance_batch`` that many at a time (groups of
different lengths, a chunk short at the end), and the wav bytes written
are those of one ``enhance`` a group, for every output channel and for one
reference channel; skip-if-exists, a stride and the refusal of mixed
sample rates hold on the batched path too.  This file imports no JAX."""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
from se_snmf_nat_tpu_torch.multichannel.pmwf import PmwfEnhancer, PmwfParams
from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner

torch.set_num_threads(1)
FS = 16000


def _db(path, n_sessions=5, ch=3, rates=None):
    path.mkdir(parents=True)
    for s in range(n_sessions):
        x, _ = synth_mixture(n=4000 + 700 * s, n_ch=ch, seed=20 + s)
        for c in range(ch):
            write_wav_int16(path / f"s{s}_ch{c}.wav",
                            np.rint(x[c] * 9000.0).astype(np.int16),
                            (rates or [FS] * ch)[c])
    return path


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.wav"))}


@pytest.mark.parametrize("ref_ch", [None, 1])
@pytest.mark.parametrize("batch_size", [2, 3, 8])
def test_batched_groups_write_the_bytes_of_one_enhance_a_group(
        tmp_path, ref_ch, batch_size):
    db = _db(tmp_path / "db")
    enh = PmwfEnhancer(params=PmwfParams(ref_ch=ref_ch), device="cpu")
    one = BatchRunner(enh, verbose=False).run(db, tmp_path / "one", ch=3)
    calls = []
    orig = enh.enhance_batch

    def spy(xs, *args, **kwargs):
        calls.append(len(xs))
        return orig(xs, *args, **kwargs)
    enh.enhance_batch = spy
    rep = BatchRunner(enh, verbose=False).run(db, tmp_path / "many",
                                              batch_size=batch_size, ch=3)
    assert calls == [min(batch_size, 5 - i)
                     for i in range(0, 5, batch_size)]
    assert rep.processed == one.processed and len(rep.processed) == 15
    assert rep.seconds_audio == pytest.approx(one.seconds_audio)
    assert set(rep.timer.stages) == {"io_read", "enhance", "io_write"}
    want = _files(tmp_path / "one")
    assert len(want) == (15 if ref_ch is None else 5)
    assert _files(tmp_path / "many") == want


def test_batched_skip_stride_and_mixed_rates(tmp_path):
    db = _db(tmp_path / "db", n_sessions=4, ch=2)
    enh = PmwfEnhancer(device="cpu")
    BatchRunner(enh, verbose=False).run(db, tmp_path / "a", ch=2, filegap=4)
    first = _files(tmp_path / "a")
    assert len(first) == 4                  # groups 0 and 2 of 4 files each
    rep = BatchRunner(enh, verbose=False).run(db, tmp_path / "b",
                                              batch_size=4, ch=2, filegap=4)
    assert _files(tmp_path / "b") == first and len(rep.processed) == 4
    again = BatchRunner(enh, verbose=False).run(db, tmp_path / "b",
                                                batch_size=4, ch=2)
    assert len(again.skipped) == 4 and len(again.processed) == 4
    bad = _db(tmp_path / "bad", n_sessions=2, ch=2, rates=[FS, FS // 2])
    with pytest.raises(ValueError, match="sample rates"):
        BatchRunner(enh, verbose=False).run(bad, tmp_path / "c",
                                            batch_size=2, ch=2)
    assert not list((tmp_path / "c").glob("*.wav"))
