"""K3's work tally and the runner's file counter on the CPU, under a
CPU-only ``torch.profiler``: ``mu_h_solve_columns``' plain path adds the
columns it solved and the sum of the ``trips`` it returns to
``k3.columns`` and ``k3.column_trips``; the fast plan's call counts every
column of its one solve (the lanes by the bucket's frames); the directory
runner counts the files it reads, on the batch and the sequential path,
and none that it skips; a session counts only its own work."""

import contextlib
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config, preset
from se_snmf_nat_tpu_torch.io.wavio import write_wav_int16
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.runtime import profiling
from se_snmf_nat_tpu_torch.runtime.profiling import span
from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)
F = 33


@contextlib.contextmanager
def _profiled():
    """A profiled session of its own (see ``tests/test_torch_spans.py``)."""
    with span("unseen"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("session"):
            pass
        yield prof


def _columns(n, seed=5):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    v = t(rng.gamma(0.8, 2.0, (n, F))).T
    w = t(rng.random((F, 6)) + 0.05)
    h0 = t(rng.random((6, 1)))
    return v, w, h0


@pytest.mark.parametrize("cap,eps", [(12, 1e-3), (7, 0.0), (40, 1e-2)])
def test_k3_counters_on_the_plain_path(cap, eps):
    v, w, h0 = _columns(50)
    mu.mu_h_solve_columns(v, w, h0, cap, eps, 5.0, 1e-9)     # not counted
    with _profiled():
        _, trips = mu.mu_h_solve_columns(v, w, h0, cap, eps, 5.0, 1e-9)
        _, trips2 = mu.mu_h_solve_columns(v[:, :20], w, h0, cap, eps, 5.0,
                                          1e-9)
    c = profiling.counters()
    assert int(trips.min()) >= 1 and int(trips.max()) <= cap
    if eps == 0.0:
        assert bool((trips == cap).all())
    assert c["k3.columns"] == 50 + 20
    assert c["k3.column_trips"] == int(trips.sum()) + int(trips2.sum())


@pytest.mark.parametrize("lens,micro_batch", [((9000, 5000, 12000), None),
                                              ((9000, 5000, 12000), 2),
                                              ((30000,), None)])
def test_the_fast_plan_counts_every_column_of_a_call(lens, micro_batch):
    cfg = preset("snmf")
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=6, r_d=6),
                     nmf=replace(cfg.nmf, max_iter=8))
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 6, 6, seed=0)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu", frame_bucket=32)
    assert enh.fast_run is not None
    xs = [fixtures.noisy_utterance(n, seed=i) for i, n in enumerate(lens)]
    with _profiled():
        enh.enhance_batch(xs, micro_batch=micro_batch)
    c = profiling.counters()
    frames = max(n // 160 for n in lens) + cfg.delay + 1
    bucket = -(-frames // 32) * 32
    mb = micro_batch or len(lens)
    chunks = -(-len(lens) // mb)
    assert c["k3.columns"] == chunks * mb * bucket
    assert c["k3.columns"] <= c["k3.column_trips"] <= 8 * c["k3.columns"]


@pytest.fixture(scope="module")
def small_enh():
    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=6, r_d=6),
                     adapt=replace(cfg.adapt, r_a=3, m_a=8),
                     nmf=replace(cfg.nmf, max_iter=4))
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 6, 6, seed=0)
    return SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu")


@pytest.fixture
def wav_dir(tmp_path):
    d = tmp_path / "db"
    d.mkdir()
    for i, n in enumerate((6000, 4000, 7000, 5000, 3000)):
        x = np.rint(fixtures.noisy_utterance(n, seed=i)).astype(np.int16)
        write_wav_int16(d / f"u{i}.wav", x, 16000)
    return d


@pytest.mark.parametrize("batch_size,carry", [(1, True), (1, False),
                                              (2, False), (8, False)])
def test_the_runner_counts_the_files_it_reads(small_enh, wav_dir, tmp_path,
                                              batch_size, carry):
    out = tmp_path / "out"
    runner = BatchRunner(small_enh, carry_state=carry, verbose=False)
    with _profiled():
        rep = runner.run(wav_dir, out, batch_size=batch_size)
    assert len(rep.processed) == 5
    assert profiling.counters()["runner.files"] == 5
    (out / "u1_enh.wav").unlink()               # the one left to do
    with _profiled():
        rep = runner.run(wav_dir, out, batch_size=batch_size)
    assert len(rep.skipped) == 4 and rep.processed == ["u1.wav"]
    assert profiling.counters()["runner.files"] == 1
