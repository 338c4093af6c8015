"""The plain reference against the program in float64 on the CPU, where
both compute the same plan in the same precision: each entry point gives
the program's int16 PCM sample for sample (the block plan and the per-frame
plan offline, the per-frame plan live through a session and a fleet)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.programs import snmf_enhancer  # noqa: E402
from benchmark.reference import snmf_nat  # noqa: E402
from benchmark.traffic import inputs  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _program(name: str, seed: int):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                     .read_text())
    cfg = copy.deepcopy(cfg)
    cfg["precision"]["dtype"] = "float64"
    bases = inputs.structured_bases(seed=seed)
    cell = SimpleNamespace(config=cfg, params=cfg["algorithm"], bases=bases,
                           device=torch.device("cpu"))
    return snmf_enhancer.build(cell), cfg, bases


@pytest.mark.parametrize("name", ["nat_block88", "nat_frame"])
def test_offline_equals_the_program_in_float64(name):
    enh, cfg, bases = _program(name, 3)
    xs = list(inputs.noisy_utterances([12000, 9000, 16000], 3, "cpu"))
    xs = [x[:n] for x, n in zip(xs, (12000, 9000, 16000))]
    got = enh.enhance_batch(xs, micro_batch=None)
    want = snmf_nat.offline(xs, cfg, bases)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("api", ["session", "fleet"])
def test_live_equals_the_program_in_float64(api):
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
    enh, cfg, bases = _program("nat_frame", 4)
    n_frames, shift = 40, 160
    x = inputs.noisy_utterances([8000, 8000], 4, "cpu")[:, :n_frames * shift]
    if api == "session":
        x = x[:1]
        sess = StreamingSession(enh)
        got = np.concatenate([sess.push(x[0, i * shift: (i + 1) * shift])
                              for i in range(n_frames)])[None]
    else:
        sess = MultiStreamSession(enh, 2, block_frames=8, wire="samples")
        got = np.concatenate([sess.push(x[:, i * 1280: (i + 1) * 1280])
                              for i in range(n_frames // 8)], axis=1)
    want, refits = snmf_nat.live(x, n_frames, cfg, bases)
    assert refits > 0
    np.testing.assert_array_equal(got, want)
