"""Entry points of the port (counterparts of the repo root's
``__graft_entry__``): the flagship step with an example of its inputs, and
a dry run of every parallel program over a mesh of n shards."""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import resolve_device


def _tiny_bases(f=513, f_mel=64, r_x=100, r_d=100, seed=0):
    """Deterministic stand-in dictionaries: the entry point reads no data."""
    rng = np.random.default_rng(seed)
    bx = rng.random((f, r_x)) + 1e-3
    bd = rng.random((f, r_d)) + 1e-3
    bx /= np.sqrt((bx * bx).sum(0))
    bd /= np.sqrt((bd * bd).sum(0))
    return bx, bd


def entry(device=None):
    """(fn, example_args): the forward step of the flagship pipeline —
    analysis -> the exact frame loop over the sparse-NMF engine with online
    adaptation -> synthesis and overlap-add — on 32 frames, on ``device``
    (the card unless named).  ``fn(frames, state)`` returns the
    overlap-added samples of the frames (T, framelength) from an unbatched
    ``EngineState``."""
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

    device = resolve_device(device)
    cfg = default_config()
    bx, bd = _tiny_bases()
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=device,
                       dtype=torch.float32, matlab_ad_blk_init=False)

    n_frames = 32
    frames = torch.as_tensor(
        np.random.default_rng(1).standard_normal(
            (n_frames, cfg.signal.framelength)) * 1000.0,
        dtype=torch.float32, device=device)
    state = enh.initial_state()

    @torch.no_grad()
    def fn(frames, state):
        y, _ = enh._run_exact(frames[None], batch_state(state, 1),
                              [frames.shape[0]])
        return y[0]

    return fn, (frames, state)


@torch.no_grad()
def dryrun_multichip(n_devices: int, device=None) -> None:
    """Training and every parallel enhancement plan over a mesh of
    ``n_devices`` shards: the distributed training step, DP enhancement on
    the exact, fast and block plans, the time shard, and both TP solves.
    The shards are the first n cards where the process has that many, else
    logical shards on ``device`` (the card unless named)."""
    from dataclasses import replace

    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.nmf.solver import SnmfParams
    from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
    from se_snmf_nat_tpu_torch.parallel.model_shard import (
        snmf_h_solve_columns_model_sharded, snmf_solve_model_sharded)
    from se_snmf_nat_tpu_torch.parallel.scaling import dp_run
    from se_snmf_nat_tpu_torch.parallel.time_shard import (
        enhance_time_sharded)
    from se_snmf_nat_tpu_torch.parallel.train_step import (
        make_distributed_train_step)
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

    dev = resolve_device(device)
    devices = ([torch.device("cuda", i) for i in range(n_devices)]
               if dev.type == "cuda" and device is None
               and torch.cuda.device_count() >= n_devices
               else [dev] * n_devices)
    mesh = make_mesh((n_devices, 1), devices=devices)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    # --- distributed dictionary-training step (dp over frames, one
    # all-reduce of the statistics a trip)
    f, r, n_t = 128, 16, 8 * n_devices
    rng = np.random.default_rng(0)
    v, w, h = (t(rng.random(shape) + 0.01)
               for shape in ((f, n_t), (f, r), (r, n_t)))
    w_out, h_out = make_distributed_train_step(mesh, n_iter=2)(v, w, h)
    assert w_out.shape == (f, r) and h_out.shape == (r, n_t)

    # --- data-parallel enhancement: an utterance batch over 'data'
    cfg = default_config()
    bx, bd = _tiny_bases(f=cfg.signal.n_bins)
    n_frames = 24
    frames = t(np.random.default_rng(2).standard_normal(
        (n_devices, n_frames, cfg.signal.framelength)))
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, dtype=torch.float32,
                       matlab_ad_blk_init=False)
    ys, _ = dp_run(enh, frames, mesh,
                   batch_state(enh.initial_state(), n_devices))
    assert ys.shape[0] == n_devices

    # --- the fast and block-adaptive plans on the mesh too
    cfg_na = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    enh_fast = SnmfEnhancer(cfg_na, bx, bd, bx, bd, device=dev,
                            dtype=torch.float32, matlab_ad_blk_init=False)
    assert enh_fast.fast_run is not None
    ys_fast, _ = dp_run(enh_fast, frames, mesh)
    enh_blk = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev,
                           dtype=torch.float32, matlab_ad_blk_init=False,
                           block_adapt=8)
    ys_blk, _ = dp_run(enh_blk, frames, mesh,
                       batch_state(enh_blk.initial_state(), n_devices),
                       [n_frames] * n_devices)
    assert ys_fast.shape == ys_blk.shape == ys.shape

    # --- sequence (time-axis) sharding: one long utterance over the mesh
    x_long = np.random.default_rng(3).standard_normal(
        n_devices * 8 * cfg.signal.frameshift) * 1000.0
    y_ts = enhance_time_sharded(enh, x_long, mesh, halo=4)
    assert y_ts.ndim == 1 and len(y_ts) > 0

    # --- model parallelism: dictionary columns over 'model'
    mesh_mp = make_mesh((1, n_devices), devices=devices)
    rng4 = np.random.default_rng(4)
    f_mp, r_mp, n_mp = 64, 8 * n_devices, 16

    def problem():
        return (t(rng4.random((f_mp, n_mp)) + 0.01),
                t(rng4.random((f_mp, r_mp)) + 0.01),
                t(rng4.random((r_mp, n_mp)) + 0.01))

    res_mp = snmf_h_solve_columns_model_sharded(
        *problem(), SnmfParams(max_iter=5, conv_eps=1e-3), mesh_mp)
    assert res_mp.h.shape == (r_mp, n_mp)
    # --- full TP solve (training/refit analog, W+H under column sharding)
    res_full = snmf_solve_model_sharded(
        *problem(), SnmfParams(max_iter=4, conv_eps=1e-4), mesh_mp)
    assert res_full.w.shape == (f_mp, r_mp)
