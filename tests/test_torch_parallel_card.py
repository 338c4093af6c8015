"""This slice on the card (marked ``gpu``: it skips without a CUDA card).
This file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_parallel_card.py

A beta other than 1 and bfloat16 run the plain solvers on the card and
launch no kernel; the time shard in float32 launches K1 and K2 once a
frame of its window for all its lanes, and with fixed dictionaries it
stays close to the sequential run; in float64 the card's time shard is the CPU's to 1e-9 with identical
int16; the training step, the merge and a TP solve over an NCCL world of
one equal their unsharded forms.
"""

import socket
from dataclasses import replace

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config, preset
from se_snmf_nat_tpu_torch.enhance.state import batch_state
from se_snmf_nat_tpu_torch.kernels import mu
from se_snmf_nat_tpu_torch.nmf.solver import SnmfParams, snmf_h_solve_columns
from se_snmf_nat_tpu_torch.parallel.distributed import (
    init_multihost, merged_dictionary_state)
from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
from se_snmf_nat_tpu_torch.parallel.model_shard import (
    snmf_h_solve_columns_model_sharded)
from se_snmf_nat_tpu_torch.parallel.time_shard import enhance_time_sharded
from se_snmf_nat_tpu_torch.parallel.train_step import (
    _kl_mu_step_local, make_distributed_train_step)
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from se_snmf_nat_tpu_torch.device import require_cuda
    return require_cuda()


def _launches():
    return (mu.mu_h_solve_lanes.launches, mu.mu_w_solve_lanes.launches,
            mu.mu_h_solve_columns.launches)


def _reset():
    mu.mu_h_solve_lanes.launches = mu.mu_w_solve_lanes.launches = 0
    mu.mu_h_solve_columns.launches = 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["is-block", "ed-fast", "bf16-exact",
                                  "bf16-fast", "bf16-block"])
def test_beta_and_bfloat16_launch_no_kernel(case):
    dev = _card()
    what, plan = case.split("-")
    cfg = preset("snmf") if plan == "fast" else default_config()
    dtype = torch.float32
    if what == "bf16":
        dtype = torch.bfloat16
    else:
        cfg = cfg.evolve(nmf=replace(cfg.nmf, cf=what))
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 100, 100)
    kw = dict(dft_matmul=True, block_adapt=8 if plan == "block" else 0)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, dtype=dtype, **kw)
    x = fixtures.noisy_utterance(16000, seed=1)
    _reset()
    y = enh.enhance(x, quantize=False)
    assert _launches() == (0, 0, 0)
    assert np.isfinite(y).all()
    cpu = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                       dtype=torch.float64, **kw).enhance(x)
    assert np.corrcoef(enh.enhance(x).astype(float),
                       cpu.astype(float))[0, 1] >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("adapt", [True, False], ids=["adapt", "fixed"])
def test_time_shard_launches_k1_and_k2_once_a_frame_of_the_window(adapt):
    """K1 (and K2 with the adaptation on) once a frame of the window for
    all the lanes.  With fixed dictionaries the shards reproduce the
    sequential exact run; with the adaptation on they need not (the
    adapted head carries the whole history: ``PERF.md``)."""
    dev = _card()
    cfg = default_config()
    cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=adapt))
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 100, 100)
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev)
    x = fixtures.noisy_utterance(4 * 16000, seed=2)
    mesh = make_mesh((8, 1), devices=[dev] * 8)
    t = enh.frames_for(x).shape[0]
    width = 64 + -(-t // 8)
    _reset()
    y = enhance_time_sharded(enh, x, mesh, halo=64)
    assert _launches() == (width, width if adapt else 0, 0)
    if not adapt:
        seq, _ = enh.enhance(x, return_state=True)       # the exact plan
        assert np.corrcoef(y.astype(float), seq.astype(float))[0, 1] >= 0.99


@pytest.mark.gpu
def test_time_shard_float64_on_the_card_matches_the_cpu():
    dev = _card()
    cfg = default_config()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 100, 100)
    x = fixtures.noisy_utterance(16000, seed=3)
    outs = {}
    for d in (dev, "cpu"):
        enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=d,
                           dtype=torch.float64)
        mesh = make_mesh((8, 1), devices=[d] * 8)
        outs[str(d)] = (enhance_time_sharded(enh, x, mesh, halo=32,
                                             quantize=False),
                        enhance_time_sharded(enh, x, mesh, halo=32))
    (card_f, card_q), (cpu_f, cpu_q) = outs.values()
    assert np.abs(card_f - cpu_f).max() <= 1e-9 * np.abs(cpu_f).max()
    np.testing.assert_array_equal(card_q, cpu_q)


@pytest.mark.gpu
def test_nccl_world_of_one():
    import torch.distributed as dist
    dev = _card()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl" and info["process_count"] == 1
        mesh = make_mesh((1, 1), devices=[dev], group=dist.group.WORLD)
        rng = np.random.default_rng(0)
        v, w, h = (torch.as_tensor(rng.random(s) + 0.01, device=dev)
                   for s in ((64, 32), (64, 8), (8, 32)))
        w1, h1 = make_distributed_train_step(mesh, n_iter=3)(v, w, h)
        wr, hr = w, h
        for _ in range(3):
            wr, hr = _kl_mu_step_local(v, wr, hr, 5.0, 1e-9)
        assert torch.allclose(w1, wr, rtol=1e-12, atol=0)
        cfg = default_config()
        bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 100, 100)
        enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev,
                           dtype=torch.float64)
        states = batch_state(enh.initial_state(), 2)
        merged = merged_dictionary_state(states, mesh)
        assert torch.allclose(merged.b_d_head, states.b_d_head, rtol=1e-15)
        tp = make_mesh((1, 1), devices=[dev], group=dist.group.WORLD,
                       process_axis="model")
        p = SnmfParams(max_iter=30, conv_eps=1e-4)
        got = snmf_h_solve_columns_model_sharded(v, w, h, p, tp)
        ref = snmf_h_solve_columns(v, w, h, p)
        assert torch.equal(got.iters, ref.iters)
        assert torch.allclose(got.h, ref.h, rtol=1e-12, atol=0)
    finally:
        dist.destroy_process_group()
