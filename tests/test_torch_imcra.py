"""The port's OM-LSA/IMCRA enhancer (``enhance/imcra.py``) against the
reference package's on the CPU, on seeded synthetic utterances
(``fixtures.noisy_utterance``): in float64 within 1e-9 relative of the
reference run in x64 with identical int16, for ``enhance`` and for
``enhance_batch`` with lanes of unequal length, leading zeros (the
first-nonzero gate), an empty lane and ``micro_batch``; in float32 within
twice the reference's own float32-to-x64 gap on the same clip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.enhance.imcra import OmlsaEnhancer as JOmlsa
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.enhance.imcra import (
    OmlsaEnhancer, init_imcra_state, make_imcra_step)
from se_snmf_nat_tpu_torch.enhance.imcra_params import ImcraParams

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def clips():
    x = fixtures.noisy_utterance(16000, seed=0)             # 1 s, 121 frames
    return {"clip": x,
            "lead_zeros": np.concatenate([np.zeros(1000), x[:9000]]),
            "short": fixtures.noisy_utterance(6000, seed=1),
            "speechlike": np.round(fixtures.speechlike(8000, seed=2)),
            "empty": np.zeros(100)}


@pytest.fixture(scope="module")
def ref64():
    return JOmlsa(dtype=jnp.float64)


@pytest.fixture(scope="module")
def port64():
    return OmlsaEnhancer(**CPU64)


@pytest.mark.parametrize("name", ["clip", "lead_zeros", "speechlike",
                                  "empty"])
def test_enhance_matches_reference_x64(clips, ref64, port64, name):
    x = clips[name]
    want = ref64.enhance(x, quantize=False)
    got = port64.enhance(x, quantize=False)
    assert got.dtype == np.float64 and got.shape == want.shape
    if np.abs(want).max() > 0:
        assert _rel(got, want) <= 1e-9
    else:
        assert not np.any(got)
    np.testing.assert_array_equal(port64.enhance(x), ref64.enhance(x))


@pytest.mark.parametrize("micro_batch", [None, 2])
def test_enhance_batch_matches_reference_x64(clips, ref64, port64,
                                             micro_batch):
    xs = [clips[k] for k in ("clip", "lead_zeros", "short", "empty")]
    want = ref64.enhance_batch(xs, micro_batch=micro_batch)
    got = port64.enhance_batch(xs, micro_batch=micro_batch)
    for g, w, x in zip(got, want, xs):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, port64.enhance(x))
    floats = port64.enhance_batch(xs[:3], quantize=False,
                                  micro_batch=micro_batch)
    for g, x in zip(floats, xs):
        assert _rel(g, ref64.enhance(x, quantize=False)) <= 1e-9


def test_all_lanes_too_short_give_the_overlap_of_zeros(port64, ref64):
    xs = [np.zeros(10), np.ones(300)]
    for g, w in zip(port64.enhance_batch(xs), ref64.enhance_batch(xs)):
        assert g.shape == w.shape == (port64.p.mo,)
        np.testing.assert_array_equal(g, w)


def test_frame_bucket_changes_nothing(clips, port64):
    a = port64.enhance(clips["clip"])
    other = OmlsaEnhancer(**CPU64)
    other.frame_bucket = 1
    np.testing.assert_array_equal(other.enhance(clips["clip"]), a)
    np.testing.assert_array_equal(
        other.enhance_batch([clips["clip"]])[0], a)


def test_skipped_lane_keeps_its_state():
    """A lane whose frame is gated keeps every state field and counts its
    first-nonzero frame on, beside a lane that is processed."""
    p = ImcraParams()
    step = make_imcra_step(p, torch.float64)
    st = init_imcra_state(p, 2, torch.float64, "cpu")
    ya2 = torch.stack([torch.zeros(p.m21, dtype=torch.float64),
                       torch.linspace(1.0, 2.0, p.m21, dtype=torch.float64)])
    on = torch.tensor([False, True])
    new, g = step(st, ya2, 1, on, on)
    assert not torch.any(g[0]) and torch.all(g[1] > 0)
    assert new.l_fnz.tolist() == [2, 1]
    assert new.fnz_flag.tolist() == [False, True]
    for name, a, b in zip(st._fields, new, st):
        if name not in ("l_fnz", "fnz_flag"):
            assert torch.equal(a[0], b[0]), name


def test_float32_within_reference_envelope(clips):
    x = clips["clip"]
    want64 = JOmlsa(dtype=jnp.float64).enhance(x, quantize=False)
    with jax.enable_x64(False):
        want32 = JOmlsa(dtype=jnp.float32).enhance(x, quantize=False)
    port = OmlsaEnhancer(device="cpu")
    got = port.enhance(x, quantize=False)
    env = _rel(want32, want64)
    assert _rel(got, want32) <= 2 * env + 1e-6, (_rel(got, want32), env)
    ys = port.enhance_batch([x, clips["short"]], quantize=False)
    assert ys[0].dtype == np.float32
    assert _rel(ys[0], want32) <= 2 * env + 1e-6
