"""Single-device entry point of the port: the flagship step and an example
of its inputs (counterpart of the repo root's ``__graft_entry__.entry``;
its multi-chip dry run waits for the port of ``parallel/``)."""

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
