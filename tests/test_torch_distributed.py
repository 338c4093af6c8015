"""The port's parallel programs across real processes: 2 and 4 gloo
processes on localhost (``tests/torch_distributed_worker.py``, torch
only), two logical CPU shards each, as ``tests/test_distributed.py`` runs
the JAX package's.

Checks: disjoint and complete file sharding; the distributed training step
against the single-process port and the JAX package's result (inputs and
JAX outputs handed over in an npz), W bit-identical on every rank; the
merged dictionary head identical on every rank; DP block-plan enhancement
of each rank's lanes equal to single-lane runs; a TP H-solve over the
ranks equal to the unsharded solve, trips equal, the divergence
bit-identical on every rank; the time shard over the ranks (each runs its
own shards' windows, one all-gather) equal to the same shards in one
process and identical on every rank.  The all-reduces add in another order than
one process does, so float64 agreement is within 1e-12 relative.  Every
child is joined with a time limit and all are killed if one overruns."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from se_snmf_nat_tpu.parallel.mesh import make_mesh as j_make_mesh
from se_snmf_nat_tpu.parallel.train_step import (
    make_distributed_train_step as j_make_step)
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.dsp.stft import stream_frames

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_distributed_worker.py"
TIMEOUT_S = 120           # seconds, each child's own time limit


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _problem(path: Path) -> None:
    """The worker's inputs, and the JAX package's training step on its
    8-shard mesh, as an npz."""
    rng = np.random.default_rng(0)
    f, r, t, n_iter = 32, 8, 16, 3
    v, w, h = (rng.random(s) + 0.01 for s in ((f, t), (f, r), (r, t)))
    w_jax, _ = j_make_step(j_make_mesh((8, 1)), n_iter=n_iter)(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(h))
    cfg = default_config()
    s = cfg.signal
    bx, bd = fixtures.structured_bases(s.n_bins, cfg.sep.r_x, cfg.sep.r_d)
    x = fixtures.noisy_utterance(3200, seed=0)
    fr = stream_frames(x, s.framelength, s.frameshift, n_flush=cfg.delay + 1)
    t_true = len(fr)
    fr = np.concatenate([fr, np.zeros((-len(fr) % 16, s.framelength))])
    tp = np.random.default_rng(5)
    np.savez(path, v=v, w=w, h=h, n_iter=n_iter, w_jax=np.asarray(w_jax),
             bx=bx, bd=bd, frames=fr, t_true=t_true, x=x,
             tp_v=tp.random((48, 24)) + 0.01, tp_w=tp.random((48, 64)) + 0.01,
             tp_h=tp.random((64, 24)) + 0.01)


@pytest.mark.parametrize("n_procs", [2, 4])
def test_multi_process_gloo(n_procs, tmp_path):
    _problem(tmp_path / "problem.npz")
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ, PROC_ID=str(pid), N_PROCS=str(n_procs),
                   COORD_PORT=str(port), PROBLEM=str(tmp_path / "problem.npz"),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.poll() is not None for p in procs)

    by_proc = {o["proc"]: o for o in outs}
    assert set(by_proc) == set(range(n_procs))
    shards = [set(by_proc[i]["files"]) for i in range(n_procs)]
    assert sum(len(s) for s in shards) == 10
    assert set.union(*shards) == {f"u{i}.wav" for i in range(10)}
    for o in outs:
        assert o["train_rel_port"] < 1e-12, o
        assert o["train_rel_h"] < 1e-12, o
        assert o["train_rel_jax"] < 1e-12, o
        assert o["merge_ok"], o
        assert o["dp_block_err"] < 1e-9, o
        assert o["time_shard_rel"] < 1e-9, o
        assert o["tp_rel"] < 1e-12 and o["tp_trips_equal"], o
    # every rank holds the same bits: deterministic collective merges
    for key in ("w_hash", "merged_head_value", "tp_div_hash",
                "time_shard_hash"):
        assert len({o[key] for o in outs}) == 1, key
