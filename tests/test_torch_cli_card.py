"""The port's command line on the card (marked ``gpu``: it skips without a
CUDA card).  This file imports no JAX, so it runs on a machine that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cli_card.py

``enhance`` of a small directory with no ``--device`` runs on the card: in
float32 every file correlates >= 0.99 with the CPU's float64 run, in
float64 its int16 is the CPU's; ``demo``'s file mode on the card equals a
``StreamingSession`` of the same hops on the card.
"""

import json

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.cli import main
from se_snmf_nat_tpu_torch.config import preset
from se_snmf_nat_tpu_torch.io.basis import BasisPair, save_basis
from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

torch.set_num_threads(1)
FS = 16000
HEADLINE = ["--block-adapt", "88", "--block-iter-cap", "22",
            "--block-refit-cap", "22", "--block-fixed-iter", "--dft-matmul"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    return require_cuda()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_card")
    db = root / "db"
    db.mkdir()
    for i, n in enumerate((16000, 20000, 12000)):
        x = np.rint(fixtures.noisy_utterance(n, seed=i)).astype(np.int16)
        write_wav_int16(db / f"u{i}.wav", x, FS)
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    save_basis(root / "bx.npz", BasisPair(b_dft=bx, b_mel=bx[:64]))
    save_basis(root / "bd.npz", BasisPair(b_dft=bd, b_mel=bd[:64]))
    return root


def _bases(work):
    return ["--speech-basis", str(work / "bx.npz"),
            "--noise-basis", str(work / "bd.npz")]


def _outs(d):
    return {p.name: read_wav_int16(p)[0] for p in sorted(d.glob("*.wav"))}


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [HEADLINE, ["--preset", "snmf"], []],
                         ids=["headline", "fast", "exact"])
def test_enhance_directory_on_the_card(work, tmp_path, flags, capsys):
    _card()
    common = ["enhance", str(work / "db"), "--batch-size", "3",
              "--no-carry-state", *flags, *_bases(work)]
    assert main([*common, "-o", str(tmp_path / "card")]) == 0
    assert json.loads(capsys.readouterr().out.strip()
                      .splitlines()[-1])["processed"] == 3
    main([*common, "-o", str(tmp_path / "cpu64"), "--dtype", "float64",
          "--device", "cpu"])
    main([*common, "-o", str(tmp_path / "card64"), "--dtype", "float64"])
    card, cpu64 = _outs(tmp_path / "card"), _outs(tmp_path / "cpu64")
    card64 = _outs(tmp_path / "card64")
    assert card.keys() == cpu64.keys() == card64.keys() and len(card) == 3
    for name in card:
        corr = np.corrcoef(card[name], cpu64[name])[0, 1]
        assert corr >= 0.99, (name, corr)
        np.testing.assert_array_equal(card64[name], cpu64[name])


@pytest.mark.gpu
def test_demo_on_the_card_equals_the_session(work, tmp_path, capsys):
    dev = _card()
    src = work / "db" / "u1.wav"
    out = tmp_path / "demo.wav"
    assert main(["demo", str(src), "--mode", "snmf", "--block", "8", "-o",
                 str(out), *_bases(work)]) == 0
    assert json.loads(capsys.readouterr().out.strip()
                      .splitlines()[-1])["hops"] == 125
    bx, bd = fixtures.structured_bases(513, 100, 100, seed=0)
    enh = SnmfEnhancer(preset("snmf_nat"), bx, bd, bx, bd, device=dev)
    sess = StreamingSession(enh, block_frames=8)
    x = read_wav_int16(src)[0]
    ys = [sess.push(x[i: i + 160]) for i in range(0, len(x) - 159, 160)]
    ys.append(sess.flush())
    np.testing.assert_array_equal(read_wav_int16(out)[0], np.concatenate(ys))
