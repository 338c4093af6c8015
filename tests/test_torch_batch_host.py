"""The shared int16 host half (``stream/batch_host.BatchHost``) that
``SnmfEnhancer.enhance_batch`` and ``PmwfEnhancer.enhance_batch`` call:
lanes of one row or of several (a multichannel utterance) packed as int16,
laid into the sample matrix on the device, chunked with a padded tail, and
each lane's output trimmed from the delay on in the form asked for; float
lanes that are not int16 values take the float upload.  And
``SnmfEnhancer.enhance_batch`` through it keeps the bits of the host chain
it replaced on the block, fast and exact plans (``_float64_chain`` of
``test_torch_batch_host_half.py``).  This file imports no JAX."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.stream.batch_host import BatchHost
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write, matlab_wavwrite_quantize)
from test_torch_batch_host_half import _float64_chain

torch.set_num_threads(1)
SHIFT, DELAY = 160, 3
LENGTHS = (20 * SHIFT + 37, 13 * SHIFT, 30 * SHIFT + 159, 5)


def _lanes(rows, kind, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in LENGTHS:
        x = rng.integers(-32768, 32768, (rows, n) if rows else (n,))
        out.append(x.astype(np.int16) if kind == "int16"
                   else x.astype(np.float64) if kind == "integer_valued"
                   else x * 0.5 + 0.25)
    return out


def _identity(seen):
    """A launch that hands back its sample matrix scaled by 1/2 (exact in
    any float dtype), recording what it was given."""
    def launch(smp, n_hops, t_true):
        seen.append((tuple(smp.shape), n_hops.tolist(), list(t_true)))
        return smp * 0.5
    return launch


@pytest.mark.parametrize("rows", [0, 1, 6])
@pytest.mark.parametrize("kind", ["int16", "integer_valued", "float"])
@pytest.mark.parametrize("micro_batch", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lanes_are_laid_out_and_trimmed(rows, kind, micro_batch, dtype):
    host = BatchHost(torch.device("cpu"), dtype, SHIFT, DELAY)
    xs = _lanes(rows, kind)
    seen = []
    outs = host.run(xs, _identity(seen), "float", micro_batch)
    t_max = max(n // SHIFT for n in LENGTHS) + DELAY + 1
    mb = micro_batch or len(xs)
    shape = (mb,) + ((rows,) if rows else ()) + (t_max * SHIFT,)
    assert [s for s, _, _ in seen] == [shape] * -(-len(xs) // mb)
    hops = [n // SHIFT for n in LENGTHS] + [0] * (-len(xs) % mb)
    assert sum((h for _, h, _ in seen), []) == hops
    assert sum((t for _, _, t in seen), []) == [h + DELAY + 1 for h in hops]
    for x, y in zip(xs, outs):
        m = (x.shape[-1] // SHIFT) * SHIFT
        want = np.zeros(x.shape[:-1] + (m + SHIFT,))
        want[..., : max(m - DELAY * SHIFT, 0)] = \
            np.asarray(x, np.float64)[..., DELAY * SHIFT: m]
        np.testing.assert_array_equal(
            y, (want.astype(np.float32) if dtype == torch.float32
                else want) * 0.5)


@pytest.mark.parametrize("output", ["wav", "int16", "written"])
def test_outputs_are_the_int16_write_and_the_wavwrite_table(output):
    host = BatchHost(torch.device("cpu"), torch.float64, SHIFT, DELAY)
    xs = [x * 1.37 for x in _lanes(2, "integer_valued")]

    def launch(smp, n_hops, t_true):
        return smp * 1.37
    got = host.run([x / 1.37 for x in xs], launch, output, 2)
    flt = host.run([x / 1.37 for x in xs], launch, "float", 2)
    for g, f in zip(got, flt):
        pcm = matlab_int16_write(f)
        want = {"wav": matlab_wavwrite_quantize(pcm / 32767.0),
                "int16": pcm, "written": pcm.astype(np.float64)}[output]
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)


def test_counters_and_spans_of_a_call():
    host = BatchHost(torch.device("cpu"), torch.float32, SHIFT, DELAY)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        host.run(_lanes(6, "int16"), _identity([]), "int16", 3,
                 {"extra.count": 7})
    c = profiling.counters()
    t = [n // SHIFT + DELAY + 1 for n in LENGTHS]
    assert c["batch.lanes"] == c["batch.lanes_int16"] == 4
    assert c["batch.frames_true"] == sum(t)
    assert c["batch.frames_computed"] == 2 * 3 * max(t)
    assert c["extra.count"] == 7
    names = [n for n, _, _ in profiling.spans()]
    assert names.count("batch.launch") == 2
    with profile(activities=[ProfilerActivity.CPU]):
        host.run(_lanes(1, "float"), _identity([]), "int16", None)
    c2 = profiling.counters()           # the same session: counts add
    assert c2["batch.lanes"] - c["batch.lanes"] == 4
    assert c2["batch.lanes_int16"] == c["batch.lanes_int16"]


def test_lanes_of_different_rows_are_refused():
    host = BatchHost(torch.device("cpu"), torch.float32, SHIFT, DELAY)
    with pytest.raises(ValueError, match="same rows"):
        host.run([np.zeros((2, 800)), np.zeros((3, 800))], _identity([]))
    with pytest.raises(ValueError, match="output"):
        host.run([np.zeros(800)], _identity([]), "pcm")


def _enhancer(plan, dtype):
    cfg = default_config()
    cfg = replace(cfg, sep=replace(cfg.sep, r_x=12, r_d=12),
                  adapt=replace(cfg.adapt, r_a=6, m_a=8,
                                adapt_train_n=plan != "fast"))
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 12, 12, seed=1)
    kw = {"block": dict(block_adapt=8, block_iter_cap=6,
                        block_refit_cap=4, block_fixed_iter=True,
                        frame_bucket=16),
          "fast": dict(frame_bucket=16), "exact": {}}[plan]
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu", dtype=dtype, **kw)
    assert (enh.run is not None, enh.fast_run is not None) == (
        plan == "block", plan == "fast")
    return enh


@pytest.mark.parametrize("plan", ["block", "fast", "exact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("micro_batch", [None, 3])
def test_snmf_batches_keep_the_host_chains_bits(plan, dtype, micro_batch):
    enh = _enhancer(plan, dtype)
    xs = [fixtures.noisy_utterance(n, seed=30 + i).astype(np.int16)
          for i, n in enumerate((4000, 2570, 3333, 1900))]
    for quantize in (True, False):
        got = enh.enhance_batch(xs, quantize=quantize,
                                micro_batch=micro_batch)
        want = _float64_chain(enh, xs, quantize, micro_batch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
