"""The port's MMSE enhancer (``enhance/ms.py``) against the reference
package's on the CPU, on seeded synthetic utterances, for both noise
trackers (minimum statistics with the log-MMSE and the amplitude-MMSE gain,
and MMSE-SPP): in float64 within 1e-9 relative of the reference run in x64
with identical int16 — one-shot ``enhance``, chunked ``enhance`` with the
state carried, and ``enhance_batch`` with empty, short and non-integer
inputs; in float32 within twice the reference's own float32-to-x64 gap on
the same clip.  The reference's float32 MMSE runs with x64 off: with it on,
its float64 NumPy constants promote the float32 carry of the amplitude gain
and of the MMSE-SPP tracker and ``lax.scan`` refuses the step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.enhance.ms import MmseEnhancer as JMmse
from se_snmf_nat_tpu.oracle.ms_np import MsParams as JMsParams
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
from se_snmf_nat_tpu_torch.enhance.ms_params import MsParams

torch.set_num_threads(1)
FS = 16000
VARIANTS = [("martin", 1), ("martin", 0), ("mmse", 1)]
IDS = ["martin-logmmse", "martin-mmse", "mmse_spp-logmmse"]


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _ref(tracker, lg, dtype=jnp.float64):
    return JMmse(FS, params=JMsParams(lg=lg), dtype=dtype, tracker=tracker)


def _port(tracker, lg, dtype=torch.float64):
    return MmseEnhancer(FS, params=MsParams(lg=lg), dtype=dtype,
                        tracker=tracker, device="cpu")


@pytest.fixture(scope="module")
def clip():
    return fixtures.noisy_utterance(16000, seed=3)            # 99 frames


@pytest.mark.parametrize("tracker,lg", VARIANTS, ids=IDS)
def test_enhance_matches_reference_x64(clip, tracker, lg):
    ref, port = _ref(tracker, lg), _port(tracker, lg)
    want = ref.enhance(clip, quantize=False)
    got = port.enhance(clip, quantize=False)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert _rel(got, want) <= 1e-9
    np.testing.assert_array_equal(port.enhance(clip), ref.enhance(clip))


@pytest.mark.parametrize("tracker,lg", VARIANTS, ids=IDS)
def test_chunked_matches_reference_and_one_shot_x64(clip, tracker, lg):
    """The first chunk holds no frame; the first with frames holds more
    than the MMSE-SPP tracker's seven initial frames (which it takes from
    its first call), so the chunks must give the one-shot output."""
    ref, port = _ref(tracker, lg), _port(tracker, lg)
    bounds = ((0, 100), (100, 2000), (2000, 11000), (11000, len(clip)))
    outs = {}
    for name, enh in (("ref", ref), ("port", port)):
        st, pieces = None, []
        for lo, hi in bounds:
            y, st = enh.enhance(clip[lo:hi], state=st, return_state=True,
                                quantize=False)
            pieces.append(y)
        outs[name] = pieces
    for g, w in zip(outs["port"], outs["ref"]):
        assert g.shape == w.shape
        if w.size:
            assert _rel(g, w) <= 1e-9
    chunked = np.concatenate(outs["port"])
    full = port.enhance(clip, quantize=False)
    np.testing.assert_allclose(chunked, full[: len(chunked)], rtol=0,
                               atol=1e-9 * np.abs(full).max())
    st, q = None, []
    for lo, hi in bounds:
        y, st = port.enhance(clip[lo:hi], state=st, return_state=True)
        q.append(y)
    np.testing.assert_array_equal(np.concatenate(q),
                                  port.enhance(clip)[: len(chunked)])


@pytest.mark.parametrize("tracker,lg", VARIANTS, ids=IDS)
def test_enhance_batch_matches_reference_x64(clip, tracker, lg):
    ref, port = _ref(tracker, lg), _port(tracker, lg)
    xs = [clip, clip[:7001] + 0.25, np.zeros(10), clip[:5000], np.zeros(0)]
    for mb in (None, 2):
        got = port.enhance_batch(xs, micro_batch=mb)
        want = ref.enhance_batch(xs, micro_batch=mb)
        for g, w, x in zip(got, want, xs):
            assert g.dtype == np.int16
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, port.enhance(x))
    floats = port.enhance_batch(xs[:2], quantize=False)
    for g, x in zip(floats, xs):
        assert g.dtype == np.float64
        assert _rel(g, ref.enhance(x, quantize=False)) <= 1e-9


def test_batch_of_empty_and_short_inputs():
    port = _port("martin", 1)
    outs = port.enhance_batch([np.zeros(10), np.zeros(0)])
    assert [o.size for o in outs] == [0, 0]
    assert all(o.dtype == np.int16 for o in outs)
    assert port.enhance_batch([np.zeros(10)], quantize=False)[0].dtype \
        == np.float64
    assert port.enhance(np.zeros(100)).dtype == np.int16
    out, st = port.enhance(np.zeros(100), return_state=True, quantize=False)
    assert out.size == 0 and st.scan is None and st.si.size == 100


def test_batch_bucket_aligned_length_with_trailing_hop():
    """The longest utterance's frame count a multiple of ``frame_bucket``
    plus samples past its last frame (the reference's regression case)."""
    port = _port("martin", 1)
    ni, nf = port.d.ni, port.d.nf
    n = ni * (port.frame_bucket - 1) + nf + 1
    x = np.round(np.random.default_rng(0).uniform(-1000, 1000, n))
    np.testing.assert_array_equal(port.enhance_batch([x])[0],
                                  port.enhance(x))
    np.testing.assert_array_equal(port.enhance_batch([x])[0],
                                  _ref("martin", 1).enhance_batch([x])[0])


@pytest.mark.parametrize("tracker,lg", VARIANTS, ids=IDS)
def test_float32_within_reference_envelope(clip, tracker, lg):
    want64 = _ref(tracker, lg).enhance(clip, quantize=False)
    with jax.enable_x64(False):
        want32 = _ref(tracker, lg, jnp.float32).enhance(clip, quantize=False)
    port = _port(tracker, lg, torch.float32)
    got = port.enhance(clip, quantize=False)
    env = _rel(want32, want64)
    assert _rel(got, want32) <= 2 * env + 1e-6, (_rel(got, want32), env)
    ys = port.enhance_batch([clip, clip[:5000]], quantize=False)
    assert _rel(ys[0], want32) <= 2 * env + 1e-6
    st, pieces = None, []
    for lo in range(0, len(clip), 1600):
        y, st = port.enhance(clip[lo: lo + 1600], state=st,
                             return_state=True)
        pieces.append(y)
    chunked = np.concatenate(pieces)
    np.testing.assert_array_equal(chunked,
                                  port.enhance(clip)[: len(chunked)])
