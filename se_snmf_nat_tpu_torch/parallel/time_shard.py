"""Time-axis (sequence/context) parallel enhancement (port of
``se_snmf_nat_tpu.parallel.time_shard``).

The reference handles long audio by streaming with bounded state (SURVEY §5
'Long-context'): every temporal recurrence — DD-smoothed noise PSD
lambda_dav (alpha_d decay), the MMSE prior xm_tilde (1 frame), the
block-sparsity ring r_blk (P_len_l frames), the adaptation rings (m_a
frames) — forgets geometrically or has a fixed window.  That bounded
memory is what makes the time axis shardable: split a long spectrogram
into D contiguous segments, give each shard its segment PLUS a `halo` of
preceding warm-up frames, run each from the fresh initial state, and drop
the halo outputs.  With adaptation off a modest halo reproduces the
sequential run to quantisation exactness; with online adaptation on, the
divergence is bounded by the dictionary drift inside one halo.

On one card the D windows are D lanes of the exact plan's batched frame
loop (``SnmfEnhancer.frame_loop``): lanes of equal width with the frame
numbers 1..width shared by all, one loop a device of the mesh, so a long
utterance takes width steps instead of T.  In float32 every step launches
K1 (one column a lane) and K2 once for all the lanes.  Under a process
group each process runs the windows of its own shards and the outputs are
gathered once at the end (one all-gather); the hot loop is collective-free.
"""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import host_array
from se_snmf_nat_tpu_torch.dsp.stft import overlap_add
from se_snmf_nat_tpu_torch.enhance.state import batch_state
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.parallel.collectives_audit import note
from se_snmf_nat_tpu_torch.parallel.mesh import Mesh


def _shard_plan(t: int, n_shards: int, halo: int) -> tuple[int, np.ndarray]:
    """Segment length (padded) and per-shard start offsets into the padded
    frame array (offsets point at the halo start)."""
    seg = -(-t // n_shards)
    starts = np.arange(n_shards) * seg
    return seg, starts


@torch.no_grad()
def enhance_time_sharded(enhancer, x: np.ndarray, mesh: Mesh, *,
                         halo: int = 384, quantize: bool = True) -> np.ndarray:
    """Enhance one long utterance with its frame axis split over the
    ``mesh.size`` shards of the mesh.

    enhancer: a ``stream.pipeline.SnmfEnhancer`` (its engine, windows and
    transforms are reused); x: int16-scale samples.  Returns the enhanced
    samples with the same emit trim as the sequential path.

    Shard 0 starts at frame 0 with no warm-up (the reference's init_N_len
    gating stays aligned to the true stream start), shards i > 0 start
    ``halo`` frames early; every window is ``halo + seg`` frames wide,
    zero-padded past the end.  The run is causal, so warm-up and overhang
    frames never reach a shard's own segment outputs.  On utterances
    shorter than ``halo * shards`` the warm-up clamps to the stream start.
    """
    cfg = enhancer.cfg
    s = cfg.signal
    n_shards = mesh.size

    frames_np = enhancer.frames_for(x)
    t = frames_np.shape[0]
    seg, starts = _shard_plan(t, n_shards, halo)
    width = halo + seg
    pad_total = n_shards * seg + halo
    padded = np.concatenate(
        [frames_np, np.zeros((max(pad_total - t, 0), s.framelength))], axis=0)
    halo_lens = np.minimum(starts, halo)   # 0 for shard 0; clamps tiny segs
    valid = np.minimum(np.maximum(t - starts, 0), seg)    # frames per shard

    # this process's shards (the mesh's devices in order, a process's
    # block of them under a group), one lane each, one frame loop a device
    if mesh.group is not None and mesh.process_axis != mesh.axis_names[0]:
        raise ValueError("the time shard's process group must span the "
                         "mesh's first axis")
    n_local = int(mesh.devices.size)
    mine = mesh.shard_offset(mesh.process_axis) * (
        n_local // mesh.local_shape[mesh.process_axis]) + np.arange(n_local)
    olas = []
    for dev, block in mesh.device_blocks(None, n_local):
        enh = enhancer.on_device(dev)
        lanes = mine[block]
        win_frames = torch.as_tensor(
            np.stack([padded[st - h: st - h + width]
                      for st, h in zip(starts[lanes], halo_lens[lanes])]),
            dtype=enh.dtype, device=dev)                  # (d, width, L)
        mag, phase = enh._analysis(win_frames)
        _, (xm,) = enh.frame_loop(
            enh.engine, mag, batch_state(enh.initial_state(), len(lanes)),
            [width] * len(lanes), l0=1)
        olas.append(overlap_add(enh._synthesis(xm, phase), s.frameshift))
    ola = torch.cat([o.to(olas[0].device) for o in olas])
    if mesh.group is not None:
        import torch.distributed as dist
        parts = [torch.empty_like(ola)
                 for _ in range(dist.get_world_size(mesh.group))]
        note("all-gather", ola)
        dist.all_gather(parts, ola, group=mesh.group)
        ola = torch.cat(parts)
    olas_np = host_array(ola)

    # stitch: from each shard's OLA stream take its segment samples after
    # the warm-up; frame k of a shard begins at k*shift in its local stream
    hop = s.frameshift
    pieces = []
    for i in range(n_shards):
        if valid[i] <= 0:
            continue
        lo = int(halo_lens[i]) * hop
        pieces.append(olas_np[i, lo: lo + int(valid[i]) * hop])
    y = np.concatenate(pieces)[: t * hop]

    start = cfg.delay * hop
    emit = y[start: start + (t - cfg.delay) * hop]
    return enhanced_quantize(emit) if quantize else emit
