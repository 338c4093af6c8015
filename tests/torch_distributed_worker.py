"""Worker of the port's multi-process test (not a pytest file; imports
torch and the port, never JAX).

``tests/test_torch_distributed.py`` starts N of these with PROC_ID,
N_PROCS, COORD_PORT and PROBLEM (an npz of the training step's inputs and
the JAX package's outputs); each joins a gloo group on localhost with two
logical CPU shards of its own and prints one JSON line:

  * its round-robin share of a campaign's files;
  * the distributed training step over every process's shards against
    the single-process port and the JAX package's result, and a hash of
    its W (every rank must hold the same bits);
  * the merged dictionary head (the mean of the global shard indices);
  * DP block-plan enhancement of its own lanes against single-lane runs;
  * the time shard over every process's shards (its outputs gathered)
    against the same shards in one process;
  * one TP H-solve with W's columns over the processes against the
    unsharded solve, and the hash of its divergence.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch


def _hash(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> None:
    torch.set_num_threads(1)
    proc_id = int(os.environ["PROC_ID"])
    n_procs = int(os.environ["N_PROCS"])
    port = os.environ["COORD_PORT"]
    problem = np.load(os.environ["PROBLEM"])
    local = 2
    n_global = local * n_procs

    import torch.distributed as dist
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.nmf.solver import (
        SnmfParams, snmf_h_solve_columns)
    from se_snmf_nat_tpu_torch.parallel.distributed import (
        init_multihost, merged_dictionary_state, shard_files_for_host)
    from se_snmf_nat_tpu_torch.parallel.mesh import make_mesh
    from se_snmf_nat_tpu_torch.parallel.model_shard import (
        snmf_h_solve_columns_model_sharded)
    from se_snmf_nat_tpu_torch.parallel.scaling import dp_run
    from se_snmf_nat_tpu_torch.parallel.time_shard import (
        enhance_time_sharded)
    from se_snmf_nat_tpu_torch.parallel.train_step import (
        _kl_mu_step_local, make_distributed_train_step)
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

    info = init_multihost(f"localhost:{port}", n_procs, proc_id,
                          device="cpu")
    assert info["process_count"] == n_procs, info
    out = {"proc": proc_id,
           "files": shard_files_for_host([f"u{i}.wav" for i in range(10)])}
    mesh = make_mesh((local, 1), devices=["cpu"] * local,
                     group=dist.group.WORLD)
    assert mesh.shape["data"] == n_global

    # --- the training step: this process's block of V's and H's columns
    v, w, h = (torch.as_tensor(problem[k]) for k in ("v", "w", "h"))
    n_iter = int(problem["n_iter"])
    cols = v.shape[1] // n_procs
    mine = slice(proc_id * cols, (proc_id + 1) * cols)
    step = make_distributed_train_step(mesh, n_iter=n_iter)
    w_dist, h_dist = step(v[:, mine], w, h[:, mine])
    w_ref, h_ref = w, h
    for _ in range(n_iter):
        w_ref, h_ref = _kl_mu_step_local(v, w_ref, h_ref, 5.0, 1e-9)
    out.update(train_rel_port=_rel(w_dist, w_ref),
               train_rel_h=_rel(h_dist, h_ref[:, mine]),
               train_rel_jax=_rel(w_dist, problem["w_jax"]),
               w_hash=_hash(w_dist))

    # --- the dictionary merge: each shard's head holds its global index
    cfg = default_config()
    bx, bd = (torch.as_tensor(problem[k]) for k in ("bx", "bd"))
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                       dtype=torch.float64, block_adapt=16, frame_bucket=16)
    states = batch_state(enh.initial_state(), local)
    first = mesh.shard_offset("data")
    heads = torch.stack([torch.full_like(states.b_d_head[0],
                                         float(first + i))
                         for i in range(local)])
    merged = merged_dictionary_state(states._replace(b_d_head=heads), mesh)
    out["merged_head_value"] = float(merged.b_d_head[0, 0, 0])
    out["merge_ok"] = bool(torch.all(
        merged.b_d_head == (n_global - 1) / 2.0))

    # --- DP block-plan enhancement of this process's lanes
    frames = torch.as_tensor(problem["frames"])
    t_true = int(problem["t_true"])
    ys, _ = dp_run(enh, frames.expand(local, -1, -1).contiguous(), mesh,
                   batch_state(enh.initial_state(), local), [t_true] * local)
    y1, _ = enh.run_frames(frames[None], None, [t_true])
    out["dp_block_err"] = float((ys - y1).abs().max())

    # --- the time shard: this process runs its shards' windows
    x = problem["x"]
    one = make_mesh((n_global, 1), devices=["cpu"] * n_global)
    y_ts = enhance_time_sharded(enh, x, mesh, halo=8, quantize=False)
    out["time_shard_rel"] = _rel(y_ts, enhance_time_sharded(
        enh, x, one, halo=8, quantize=False))
    out["time_shard_hash"] = hashlib.sha256(y_ts.tobytes()).hexdigest()

    # --- one TP H-solve: W's columns over the processes' model shards
    tp = make_mesh((1, local), devices=["cpu"] * local,
                   group=dist.group.WORLD, process_axis="model")
    vv, ww, hh = (torch.as_tensor(problem[k]) for k in ("tp_v", "tp_w",
                                                        "tp_h"))
    r_loc = ww.shape[1] // n_procs
    rows = slice(proc_id * r_loc, (proc_id + 1) * r_loc)
    params = SnmfParams(beta=1.0, sparsity=5.0, max_iter=60, conv_eps=1e-4)
    got = snmf_h_solve_columns_model_sharded(vv, ww[:, rows], hh[rows],
                                             params, tp)
    ref = snmf_h_solve_columns(vv, ww, hh, params)
    out.update(tp_rel=_rel(got.h, ref.h[rows]),
               tp_trips_equal=bool(torch.equal(got.iters, ref.iters)),
               tp_div_hash=_hash(got.div))
    dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
