"""The yardstick's counts against the program's own formulas at the
headline shapes, and its interval arithmetic against brute force."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import yardstick as ys  # noqa: E402

B, F, R, K, TRIPS = 64, 513, 200, 88, 22


def test_k1_counts_are_the_smoke_scripts():
    # chip_smoke.check_h_kernel's launch at B=64: flops and bytes
    flops = 4.0 * 513 * 200 * 88 * 22 * B
    n_bytes = 4.0 * (B * 513 * 88 + B * 513 * 200 + 200 * 88
                     + B * 200 * 88 + B * 88)
    assert ys.k1_counts(B, F, R, K, TRIPS) == (flops, n_bytes)
    from se_snmf_nat_tpu_torch.runtime.profiling import bound
    ms, by = bound(flops, n_bytes)
    assert by == "operations"
    assert ys.bound_s(flops, n_bytes) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_g_counts_are_the_smoke_scripts_on_the_block_steps_arguments():
    import chip_smoke
    from se_snmf_nat_tpu_torch.kernels.gain import GainScan, gain_consts
    from se_snmf_nat_tpu_torch.config import default_config

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32)
    mag = f32(B, K, F)
    args = (mag, mag, f32(B, K, F), f32(B, K, F), f32(B, K, F), f32(B, K),
            f32(B, K), f32(B, K), torch.zeros((B, K), dtype=torch.bool),
            torch.arange(1, K + 1), f32(B, F), f32(B, F),
            torch.ones(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool),
            gain_consts(default_config()))
    out = GainScan(f32(B, K, F), f32(B, F, K),
                   torch.zeros((B, K), dtype=torch.bool), f32(B, F),
                   f32(B, F), torch.ones(B, dtype=torch.int32),
                   torch.zeros(B, dtype=torch.bool), f32(B), f32(B))
    ms, by = chip_smoke.gain_bound(args, out)
    flops, n_bytes = ys.g_counts(B, K, F)
    assert by == "bytes"
    assert ms == pytest.approx(ys.bound_s(flops, n_bytes) * 1e3, rel=1e-12)


def test_dft_counts_are_the_bench_modules():
    from se_snmf_nat_tpu_torch.bench import stft_flops_per_frame
    assert ys.dft_flops(640, F) == stft_flops_per_frame(640, F)


def test_a_calls_useful_operations_at_the_headline_shapes():
    frames = np.full(64, 347)
    got = ys.block_call_flops(frames, F, R, 640, TRIPS)
    want = 64 * 347 * (2 * 2 * 2 * 640 * F + 4 * F * R * TRIPS + 2 * F * R)
    assert got == want
    assert 2.6e11 < got < 2.7e11


def test_interval_arithmetic_matches_brute_force():
    rng = np.random.default_rng(0)
    starts = np.sort(rng.uniform(0, 100, 400))
    ends = starts + rng.uniform(0, 2, 400)
    union = ys.merge(starts, ends)
    grid = np.linspace(0, 103, 206001)
    inside = np.zeros_like(grid, bool)
    for a, b in zip(starts, ends):
        inside |= (grid >= a) & (grid < b)
    spans = np.sort(rng.uniform(0, 103, (50, 2)), axis=1)
    step = grid[1] - grid[0]
    for (lo, hi), got in zip(spans, ys.covered_many(union, spans)):
        sel = (grid >= lo) & (grid < hi)
        assert got == pytest.approx(inside[sel].sum() * step, abs=3 * step)
        assert got == pytest.approx(ys.covered(union, lo, hi), abs=1e-9)
    counts = ys.count_within(starts, spans)
    assert list(counts) == [int(((starts >= lo) & (starts < hi)).sum())
                            for lo, hi in spans]

