"""``PmwfEnhancer.enhance_batch``: the offline PMWF plan over a lane axis,
through the int16 host half ``SnmfEnhancer.enhance_batch`` uses
(``stream/batch_host.BatchHost``).  Every lane gives the bits of
``enhance`` on that lane alone, in float32 and float64, for lanes of
different lengths (one shorter than ``init_n_len``, one shorter than
``init_n_len + norm_period``), int16 and float inputs, and any chunking;
``enhance`` is the one-lane case of the same plan, and its output is held
to the host chain it replaced (frames made on the host in float64 and
uploaded, the int16 write on the host).  The program's counters
``pmwf.cov_frames`` and ``pmwf.solves`` count the true work.  This file
imports no JAX."""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
from se_snmf_nat_tpu_torch.multichannel.pmwf import (
    PmwfEnhancer, PmwfParams, emit_samples, frames_of)
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write

torch.set_num_threads(1)
SHIFT = 160
# 60, 32 and 22 hops and a part of one, and 10 hops: T = 64, 36, 26
# (init_n_len + norm_period = 30) and 14 (< init_n_len = 15) frames
LENGTHS = (60 * SHIFT + 77, 32 * SHIFT, 22 * SHIFT + 159, 10 * SHIFT + 3)
C = 4


def _lanes(kind):
    xs = []
    for i, n in enumerate(LENGTHS):
        x, _ = synth_mixture(n=n, n_ch=C, seed=10 + i)
        x = np.clip(np.round(x * 9000.0), -32768, 32767)
        xs.append(x.astype(np.int16) if kind == "int16"
                  else x * 0.61 if kind == "float" else x)
    return xs


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["float32", "float64"])
def enh(request):
    return PmwfEnhancer(dtype=request.param, device="cpu")


@pytest.fixture(scope="module")
def singles(enh):
    return {kind: [(enh.enhance(x), enh.enhance(x, quantize=False))
                   for x in _lanes(kind)]
            for kind in ("int16", "integer_valued", "float")}


@pytest.mark.parametrize("kind", ["int16", "integer_valued", "float"])
@pytest.mark.parametrize("micro_batch", [None, 1, 2, 3])
def test_lanes_give_the_bits_of_single_lanes(enh, singles, kind,
                                             micro_batch):
    xs = _lanes(kind)
    got = enh.enhance_batch(xs, micro_batch=micro_batch)
    flt = enh.enhance_batch(xs, quantize=False, micro_batch=micro_batch)
    for x, g, f, (want, want_f) in zip(xs, got, flt, singles[kind]):
        n_out = (x.shape[1] // SHIFT + 1) * SHIFT
        assert g.dtype == np.int16 and g.shape == (C, n_out)
        np.testing.assert_array_equal(g, want)
        assert f.dtype == np.dtype(str(enh.dtype).split(".")[1])
        np.testing.assert_array_equal(f, want_f)


@pytest.mark.parametrize("kind", ["int16", "float"])
def test_enhance_is_the_host_chain_it_replaced(enh, singles, kind):
    """The parent's ``enhance``: float64 frames on the host, uploaded in
    the compute dtype, ``run``, the delay trim and the int16 write on the
    host."""
    for x, (want, want_f) in zip(_lanes(kind), singles[kind]):
        frames = frames_of(np.asarray(x, np.float64), enh.cfg)
        y = enh.run(torch.as_tensor(frames, dtype=enh.dtype))
        emit = emit_samples(y.numpy(), frames.shape[1], enh.cfg, None)
        np.testing.assert_array_equal(emit, want_f)
        np.testing.assert_array_equal(matlab_int16_write(emit), want)


def test_one_reference_channel_is_that_channel_of_all():
    xs = _lanes("int16")
    full = PmwfEnhancer(device="cpu").enhance_batch(xs)
    one = PmwfEnhancer(params=PmwfParams(ref_ch=2),
                       device="cpu").enhance_batch(xs, micro_batch=3)
    for a, b in zip(full, one):
        np.testing.assert_array_equal(b, a[2:3])


def test_mono_lanes_and_mixed_channel_counts():
    enh = PmwfEnhancer(device="cpu")
    x = _lanes("int16")[0]
    np.testing.assert_array_equal(enh.enhance_batch([x[0], x[1]])[1],
                                  enh.enhance(x[1]))
    with pytest.raises(ValueError, match="same rows"):
        enh.enhance_batch([x, x[:2]])


def test_counters_count_the_true_work():
    enh = PmwfEnhancer(device="cpu")
    xs = _lanes("int16")
    t = np.asarray([n // SHIFT + enh.cfg.delay + 1 for n in LENGTHS])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        enh.enhance_batch(xs, micro_batch=3)
    c = profiling.counters()
    assert c["pmwf.cov_frames"] == int(t.sum())
    assert c["pmwf.solves"] == int(np.ceil(t / 15).sum()) * 513
    assert c["batch.lanes"] == c["batch.lanes_int16"] == len(xs)
    assert c["batch.frames_true"] == int(t.sum())
    assert c["batch.frames_computed"] == 2 * 3 * int(t.max())
    names = {n for n, _, _ in profiling.spans()}
    assert {"batch.prep", "batch.launch", "batch.fetch",
            "batch.emit"} <= names


def test_chunks_on_the_cpu_are_one_and_on_a_card_equal():
    enh = PmwfEnhancer(device="cpu")
    assert enh.chunk_lanes(64, 347, 6) == 64

    class Props:
        total_memory = 80 * 2 ** 30
    enh.device = torch.device("cuda", 0)
    orig = torch.cuda.get_device_properties
    torch.cuda.get_device_properties = lambda d: Props
    try:
        mb = enh.chunk_lanes(64, 347, 6)
        per_lane = 6 * 347 * 513 * 36 * 8
        assert mb * per_lane <= 0.3 * Props.total_memory
        assert -(-64 // mb) * mb - 64 < -(-64 // mb)
        assert enh.chunk_lanes(200, 347, 6) == 67
        assert enh.chunk_lanes(3, 347, 6) == 3
    finally:
        torch.cuda.get_device_properties = orig
