"""Data-parallel enhancement and its scaling measurement (port of
``se_snmf_nat_tpu.parallel.scaling``).

``dp_run`` is the data-parallel batch program: a batch's lanes split over
the mesh's 'data' axis, one call of the enhancer's batch program a device
(logical shards on one card run as one call).  Lanes never interact, so
it moves nothing between shards.

``measure_dp_scaling`` shards a fixed per-device utterance batch over
growing device counts and measures audio-seconds/s.  On one card this is
k=1 (the scaling table needs several); the CPU validates the mechanics,
never the speed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from se_snmf_nat_tpu_torch.enhance.state import EngineState, batch_state
from se_snmf_nat_tpu_torch.parallel.mesh import Mesh, make_mesh


@torch.no_grad()
def dp_run(enhancer, frames: torch.Tensor, mesh: Mesh, states=None,
           t_valid=None):
    """``enhancer.run_frames`` with the lanes of frames (B, T, L) split
    over 'data' (a process's block of lanes under a group): the fast plan
    where the enhancer has one and ``states`` is None, else the block plan
    or the exact loop from the batched ``states``.  Returns (y (B, S) on
    the first shard's device, state or None)."""
    n = frames.shape[0]
    t_valid = [frames.shape[1]] * n if t_valid is None else list(t_valid)
    ys, sts = [], []
    for dev, sl in mesh.device_blocks("data", n):
        enh = enhancer.on_device(dev)
        st = (None if states is None
              else EngineState(*(f[sl].to(dev) for f in states)))
        y, st = enh.run_frames(frames[sl].to(dev), st, t_valid[sl])
        ys.append(y)
        sts.append(st)
    dev0 = ys[0].device
    y = torch.cat([a.to(dev0) for a in ys])
    if sts[0] is None:
        return y, None
    return y, EngineState(*(torch.cat([f.to(dev0) for f in fs])
                            for fs in zip(*sts)))


def measure_dp_scaling(enhancer, x: np.ndarray, fs: int, *,
                       per_device_batch: int = 16,
                       device_counts: list[int] | None = None,
                       n_rep: int = 12) -> dict:
    """enhancer: ``SnmfEnhancer``; x: one utterance to replicate into
    batches.  Measures the production plan the enhancer carries: the block
    plan where it has one (``"block_adaptive"``), else the exact loop
    (``"exact_scan"``), on the enhancer's device and, on the card, every
    card of the process.  For each k: the best of 3 windows of ``n_rep``
    warm calls by the host clock, each ending in a fetch of the output
    (``audio_s_per_s``), and on the card the same windows by CUDA events
    on the first card's stream (``device_audio_s_per_s``; None on the
    CPU)."""
    cuda = enhancer.device.type == "cuda"
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())] if cuda
               else [enhancer.device])
    counts = device_counts or sorted({1, 2, 4, len(devices)})
    counts = [c for c in counts if c <= len(devices)]
    frames = enhancer._pad_frames(enhancer.frames_for(x))
    t = enhancer.frames_for(x).shape[0]       # true frames: padding masked
    audio_s = len(x) / fs
    use_block = enhancer.run is not None
    results = {"plan": "block_adaptive" if use_block else "exact_scan"}
    for k in counts:
        mesh = make_mesh((k, 1), devices=devices[:k])
        b = per_device_batch * k
        batch = torch.as_tensor(frames, dtype=enhancer.dtype,
                                device=enhancer.device).expand(
                                    (b,) + frames.shape).contiguous()
        states = batch_state(enhancer.initial_state(), b)

        def run():
            return dp_run(enhancer, batch, mesh, states, [t] * b)[0]

        float(torch.sum(run()))                    # warm
        host, device = [], []
        for _ in range(3):
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if cuda else None)
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            for _ in range(n_rep):
                ys = run()
            if ev:
                ev[1].record()
            float(torch.sum(ys))       # the fetch closes the window
            host.append((time.perf_counter() - t0) / n_rep)
            if ev:
                device.append(ev[0].elapsed_time(ev[1]) / 1e3 / n_rep)
        results[k] = {
            "audio_s_per_s": round(b * audio_s / min(host), 1),
            "device_audio_s_per_s": (round(b * audio_s / min(device), 1)
                                     if device else None),
            "devices": k}
    base = results[counts[0]]["audio_s_per_s"] / counts[0]
    for k in counts:
        results[k]["efficiency_vs_1dev"] = round(
            results[k]["audio_s_per_s"] / (k * base), 3)
    return results
