"""Multi-process start-up and cross-shard statistic merging (port of
``se_snmf_nat_tpu.parallel.distributed``).

The reference is single-process; its only cross-run channel is B_D_u.mat
on disk (SURVEY §5).  Across processes:

  * ``init_multihost()`` — ``torch.distributed.init_process_group`` over
    ``tcp://`` (NCCL on the card, gloo on the CPU), so campaigns scale to
    several hosts with per-host file sharding;
  * ``shard_files_for_host()`` — deterministic round-robin split of a
    campaign's file list across processes;
  * ``merged_dictionary_state()`` — mean-merge of per-shard adapted
    dictionary heads, the in-memory replacement for the reference's
    unlocked B_D_u.mat read-modify-write race.
"""

from __future__ import annotations

import torch

from se_snmf_nat_tpu_torch.parallel.mesh import Mesh, data_sharding, psum


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def _process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None) -> dict:
    """Join the default process group when a coordinator
    (``"host:port"``) and a process count are given, a world of one
    included; returns the topology facts either way.  The backend is NCCL
    on the card and gloo on ``device="cpu"``."""
    if coordinator_address is not None and num_processes is not None:
        import torch.distributed as dist
        from se_snmf_nat_tpu_torch.device import resolve_device
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id or 0))
    local = (torch.cuda.device_count()
             if device is None or torch.device(device).type == "cuda" else 1)
    return {
        "process_index": _process_index(),
        "process_count": _process_count(),
        "local_devices": local,
        "global_devices": local * _process_count(),
    }


def shard_files_for_host(files: list, process_index: int | None = None,
                         process_count: int | None = None) -> list:
    """Round-robin file split (deterministic given sorted input)."""
    pi = _process_index() if process_index is None else process_index
    pc = _process_count() if process_count is None else process_count
    return list(files)[pi::pc]


def merged_dictionary_state(states, mesh: Mesh):
    """Mean-merge the adapted dictionary heads of per-shard engine states
    over the mesh 'data' axis; other state fields keep shard-local values
    (they are per-stream recurrences, not statistics).

    states: an ``EngineState`` whose fields carry a leading lane axis
    split over 'data' (a process's block of lanes under a group).  Each
    shard's mean head enters one all-reduce; every lane gets the mean."""
    heads = data_sharding(mesh, states.b_d_head.dim(), 0).split(
        states.b_d_head)
    total = psum([torch.mean(h, dim=0) for h in heads], mesh, "data")
    mean = total / mesh.shape["data"]
    return states._replace(b_d_head=mean.to(states.b_d_head.device)
                           .expand_as(states.b_d_head).contiguous())
