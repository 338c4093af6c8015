"""Collective audit: what each parallel program of the port moves between
its shards (counterpart of ``se_snmf_nat_tpu.parallel.collectives_audit``).

The reference compiles each parallel program on a virtual mesh and parses
XLA's optimised HLO for collective operations.  PyTorch runs eagerly and
writes no such text, so the port records instead: every collective of
``parallel/`` goes through ``mesh.psum`` or ``time_shard``'s gather, which
note their op and bytes to each report being recorded (``record``) while a
program runs.  The counts are of calls made: an all-reduce inside a loop
counts once a trip, where the reference's HLO holds it once a program.  A
collective among logical shards of one process counts as one too: it is
the one the program makes across cards.

``audit_all`` runs every shipped parallel program on a mesh of logical
shards and reports, as the reference states them:

* DP enhancement on the block plan (lanes over 'data'): none;
* the dictionary merge (``distributed.merged_dictionary_state``): one
  all-reduce of the adapted head;
* the distributed MU train step (``train_step``): one all-reduce a trip
  of the flattened (F,R) and (R,) statistics, (F*R + R) * itemsize bytes;
* the TP activation solve (``model_shard``): one (F,N) all-reduce a
  rebuild of the reconstruction, and the per-column cost merge;
* the time shard (``time_shard``): none, the halo rides the input.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch

_RECORDING: contextvars.ContextVar = contextvars.ContextVar(
    "collective_reports", default=())


@dataclass
class CollectiveReport:
    ops: list = field(default_factory=list)   # [{op, bytes, type}]

    @property
    def total_bytes(self) -> int:
        return sum(o["bytes"] for o in self.ops)

    @property
    def count(self) -> int:
        return len(self.ops)

    def summary(self) -> dict:
        by_op: dict[str, dict] = {}
        for o in self.ops:
            e = by_op.setdefault(o["op"], {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += o["bytes"]
        return {"n_collectives": self.count,
                "total_bytes": self.total_bytes, "by_op": by_op}


@contextlib.contextmanager
def record():
    """A report of every collective the code inside the block calls."""
    rep = CollectiveReport()
    token = _RECORDING.set(_RECORDING.get() + (rep,))
    try:
        yield rep
    finally:
        _RECORDING.reset(token)


def note(op: str, t: torch.Tensor) -> None:
    """Count one collective ``op`` on the buffer ``t`` in every report
    being recorded."""
    for rep in _RECORDING.get():
        rep.ops.append({
            "op": op, "bytes": t.numel() * t.element_size(),
            "type": f"{str(t.dtype).removeprefix('torch.')}"
                    f"[{','.join(map(str, t.shape))}]"})


def audit_all(per_device_batch: int = 2, *, mesh=None, cfg=None) -> dict:
    """Run every shipped parallel program on ``mesh`` (default: 8 logical
    shards on the card, the shape of the reference's virtual mesh) at the
    widths of ``cfg`` (default: ``default_config()``) in float32 and return
    the collective table of each."""
    import numpy as np

    from se_snmf_nat_tpu_torch import fixtures
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.device import resolve_device
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.headline import HEADLINE_PLAN
    from se_snmf_nat_tpu_torch.nmf.solver import SnmfParams
    from se_snmf_nat_tpu_torch.parallel.distributed import (
        merged_dictionary_state)
    from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
    from se_snmf_nat_tpu_torch.parallel.model_shard import (
        snmf_h_solve_columns_model_sharded)
    from se_snmf_nat_tpu_torch.parallel.scaling import dp_run
    from se_snmf_nat_tpu_torch.parallel.time_shard import (
        enhance_time_sharded)
    from se_snmf_nat_tpu_torch.parallel.train_step import (
        make_distributed_train_step)
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

    if mesh is None:
        mesh = make_mesh((8, 1), devices=[resolve_device(None)] * 8)
    devices = list(mesh.devices.flat)
    dev, n_dev = devices[0], len(devices)
    cfg = cfg or default_config()
    s, r = cfg.signal, cfg.sep.r_x + cfg.sep.r_d
    bx, bd = fixtures.structured_bases(s.n_bins, cfg.sep.r_x, cfg.sep.r_d)
    x = fixtures.noisy_utterance(176 * s.frameshift, seed=0)
    rng = np.random.default_rng(0)
    out: dict[str, dict] = {}

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    # --- 1. DP enhancement batch: the headline block plan
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev, dtype=torch.float32,
                       **HEADLINE_PLAN)
    frames = enh._pad_frames(enh.frames_for(x))
    b = per_device_batch * mesh.shape["data"]
    batch = t(np.stack([frames] * b))
    states = batch_state(enh.initial_state(), b)
    with record() as rep:
        dp_run(enh, batch, mesh, states, [enh.frames_for(x).shape[0]] * b)
    out["dp_enhance_block_plan"] = {
        **rep.summary(), "per": f"one {b}-utterance batch call",
        "note": "headline program, lanes over 'data'"}

    # --- 2. the dictionary merge
    with record() as rep:
        merged_dictionary_state(states, mesh)
    out["pmean_dictionary_merge"] = {
        **rep.summary(),
        "per": "one merge per campaign (or per checkpoint interval)"}

    # --- 3. the distributed MU train step, n_iter trips
    f, t_cols, n_iter = s.n_bins, 1024, 4
    step = make_distributed_train_step(mesh, n_iter=n_iter)
    v, w, h = (t(rng.random(shape) + 0.01)
               for shape in ((f, t_cols), (f, r), (r, t_cols)))
    with record() as rep:
        step(v, w, h)
    out["train_step_4iter"] = {
        **rep.summary(),
        "per": "one all-reduce a trip of the flattened (F,R) + (R,) "
               "statistics",
        "per_trip_bytes": (f * r + r) * 4, "shape": f"F={f} r={r} T={t_cols}"}

    # --- 4. the TP activation solve (model axis)
    tp_mesh = make_mesh((1, n_dev), devices=devices)
    r2, n2 = r * n_dev, 256
    v2, w2, h2 = (t(rng.random(shape) + 0.01)
                  for shape in ((f, n2), (f, r2), (r2, n2)))
    params = SnmfParams(beta=1.0, max_iter=40, conv_eps=0.0)
    with record() as rep:
        snmf_h_solve_columns_model_sharded(v2, w2, h2, params, tp_mesh)
    out["tp_h_solve"] = {
        **rep.summary(),
        "per": "whole solve: one (F,N) all-reduce at the start and one a "
               "trip, then the sparsity term of the final cost",
        "per_iteration_bytes": f * n2 * 4,
        "shape": f"F={f} R={r2} N={n2} (model axis {n_dev})"}

    # --- 5. the time shard (halo in the input layout)
    enh_exact = SnmfEnhancer(cfg, bx, bd, bx, bd, device=dev,
                             dtype=torch.float32)
    x_ts = fixtures.noisy_utterance(16 * mesh.size * s.frameshift, seed=1)
    with record() as rep:
        enhance_time_sharded(enh_exact, x_ts, mesh, halo=16)
    out["time_sharded_enhance"] = {
        **rep.summary(),
        "per": "one long-utterance call (halo rides the input layout)"}
    return out
