"""The port's ``parallel/`` in one process with logical shards, against
the JAX package's on the conftest's virtual 8-device CPU mesh, in float64:
the distributed training step and the jitted n-trip step, the dictionary
merge, both TP solves for beta 0, 1 and 2 with the masked W refit and the
rank guard (within 1e-12 relative, trips equal; the shards' all-reduce
adds in another order than one product), the collective audit's counts
and bytes, the DP scaling measurement's keys, DP enhancement on a mesh, and
the fleet over a mesh (``MultiStreamSession(mesh=...)``), int16 identical
to the fleet without one."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.config import default_config as j_default_config
from se_snmf_nat_tpu.enhance.state import init_engine_state as j_init
from se_snmf_nat_tpu.nmf.solver import SnmfParams as JParams
from se_snmf_nat_tpu.parallel import model_shard as j_ms
from se_snmf_nat_tpu.parallel.distributed import (
    merged_dictionary_state as j_merge)
from se_snmf_nat_tpu.parallel.mesh import make_mesh as j_make_mesh
from se_snmf_nat_tpu.parallel.train_step import (
    distributed_mu_step as j_step, make_distributed_train_step as j_make_step)
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.convert import state_from_jax
from se_snmf_nat_tpu_torch.enhance.state import batch_state
from se_snmf_nat_tpu_torch.nmf.solver import (
    SnmfParams, snmf_h_solve_columns, snmf_solve)
from se_snmf_nat_tpu_torch.parallel import model_shard as ms
from se_snmf_nat_tpu_torch.parallel.collectives_audit import (
    audit_all, record)
from se_snmf_nat_tpu_torch.parallel.distributed import (
    merged_dictionary_state, shard_files_for_host)
from se_snmf_nat_tpu_torch.parallel.mesh import (
    data_sharding, make_mesh, model_sharding, psum, replicated)
from se_snmf_nat_tpu_torch.parallel.scaling import dp_run, measure_dp_scaling
from se_snmf_nat_tpu_torch.parallel.train_step import (
    distributed_mu_step, make_distributed_train_step)
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.serving import (
    MultiStreamSession, ShardedFleet)

torch.set_num_threads(1)
TOL = 1e-12


def _mesh(shape=(8, 1)):
    return make_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _problem(f=64, r=16, t=512, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((f, t)) + 0.01, rng.random((f, r)) + 0.01,
            rng.random((r, t)) + 0.01)


# ---------------------------------------------------------------------------
# the mesh and its shardings
# ---------------------------------------------------------------------------

def test_mesh_shape_shardings_and_psum():
    mesh = _mesh((2, 4))
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.group is None and not mesh.crosses("data")
    x = torch.arange(24.0).reshape(3, 8)
    parts = model_sharding(mesh, 2, 1).split(x)
    assert [tuple(p.shape) for p in parts] == [(3, 2)] * 4
    assert torch.equal(model_sharding(mesh, 2, 1).join(parts), x)
    assert data_sharding(mesh, 2, 1).split(x)[1].shape == (3, 4)
    assert replicated(mesh).split(x) == [x]
    with pytest.raises(ValueError, match="does not split"):
        model_sharding(mesh, 2, 0).split(x)
    with record() as rep:
        total = psum(parts, mesh, "model")
    assert torch.equal(total, sum(parts))
    assert rep.count == 1 and rep.ops[0]["bytes"] == 3 * 2 * 4
    with pytest.raises(ValueError, match="8 devices"):
        make_mesh((3, 2), devices=["cpu"] * 8)
    assert make_mesh(devices=["cpu"] * 4).shape == {"data": 4, "model": 1}


def test_shard_files_for_host_round_robin():
    files = [f"u{i}.wav" for i in range(10)]
    assert shard_files_for_host(files) == files       # one process
    shards = [shard_files_for_host(files, i, 3) for i in range(3)]
    assert shards[1] == ["u1.wav", "u4.wav", "u7.wav"]
    assert sorted(sum(shards, [])) == sorted(files)


# ---------------------------------------------------------------------------
# the distributed training step
# ---------------------------------------------------------------------------

def test_distributed_mu_step_matches_reference():
    v, w, h = _problem()
    jm = j_make_mesh((8, 1))
    w_j, h_j = j_step(jnp.asarray(v), jnp.asarray(w), jnp.asarray(h),
                      mesh=jm)
    with record() as rep:
        w8, h8 = distributed_mu_step(_t(v), _t(w), _t(h), mesh=_mesh())
    w1, h1 = distributed_mu_step(_t(v), _t(w), _t(h))
    for got in ((w8, h8), (w1, h1)):
        assert _rel(got[0], w_j) < TOL and _rel(got[1], h_j) < TOL
    f, r = w.shape
    assert rep.count == 1 and rep.total_bytes == (f * r + r) * 8


def test_jitted_train_step_matches_reference():
    v, w, h = _problem(t=1024)
    w_j, h_j = j_make_step(j_make_mesh((8, 1)), n_iter=5)(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(h))
    with record() as rep:
        w5, h5 = make_distributed_train_step(_mesh(), n_iter=5)(
            _t(v), _t(w), _t(h))
    assert _rel(w5, w_j) < TOL and _rel(h5, h_j) < TOL
    assert rep.count == 5               # one all-reduce a trip
    wr, hr = _t(w), _t(h)
    for _ in range(5):
        wr, hr = distributed_mu_step(_t(v), wr, hr)
    assert _rel(w5, wr) < TOL and _rel(h5, hr) < TOL


# ---------------------------------------------------------------------------
# the dictionary merge
# ---------------------------------------------------------------------------

def test_merged_dictionary_state_matches_reference():
    cfg = j_default_config()
    bd = np.random.default_rng(1).random((cfg.signal.n_bins, cfg.sep.r_d))
    base = j_init(cfg, bd, cfg.signal.n_bins, jnp.float64, True)
    heads = np.random.default_rng(2).random((16,) + base.b_d_head.shape)
    j_states = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (16,) + a.shape), base)
    j_states = j_states._replace(b_d_head=jnp.asarray(heads))
    want = j_merge(j_states, j_make_mesh((8, 1)))
    states = batch_state(state_from_jax(base, device="cpu"), 16)
    states = states._replace(b_d_head=_t(heads))
    with record() as rep:
        got = merged_dictionary_state(states, _mesh())
    assert _rel(got.b_d_head, want.b_d_head) < TOL
    assert torch.equal(got.lambda_dav, states.lambda_dav)
    assert rep.count == 1
    assert rep.total_bytes == int(np.prod(base.b_d_head.shape)) * 8


# ---------------------------------------------------------------------------
# the TP solves (model axis of a 2 x 4 mesh)
# ---------------------------------------------------------------------------

def _tp_case(beta, f, r, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((f, n)) + 0.01, rng.random((f, r)) + 0.01,
            rng.random((r, n)) + 0.01)


@pytest.mark.parametrize("beta,sparsity,max_iter", [
    (1.0, 5.0, 60), (0.0, 2.0, 40), (2.0, 2.0, 40)])
def test_tp_h_solve_matches_reference(beta, sparsity, max_iter):
    v, w, h0 = _tp_case(beta, 48, 64, 24, int(beta) + 3)
    kw = dict(beta=beta, sparsity=sparsity, max_iter=max_iter,
              conv_eps=1e-4, flr=1e-9)
    want = j_ms.snmf_h_solve_columns_model_sharded(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(h0),
        JParams(precision="highest", **kw), j_make_mesh((2, 4)))
    p = SnmfParams(**kw)
    with record() as rep:
        got = ms.snmf_h_solve_columns_model_sharded(_t(v), _t(w), _t(h0),
                                                    p, _mesh((2, 4)))
    ref = snmf_h_solve_columns(_t(v), _t(w), _t(h0), p)
    assert _rel(got.h, want.h) < TOL and _rel(got.w, want.w) < TOL
    assert int(got.iters.max()) == int(want.iters)
    assert torch.equal(got.iters, ref.iters) and _rel(got.h, ref.h) < TOL
    assert _rel(got.div, want.div) < TOL and _rel(got.cost, want.cost) < TOL
    # one (F,N) all-reduce a rebuild and one (N,) cost merge a trip
    trips = int(got.iters.max())
    by_bytes = [o["bytes"] for o in rep.ops]
    assert by_bytes.count(48 * 24 * 8) == trips + 1
    assert by_bytes.count(24 * 8) == trips


@pytest.mark.parametrize("beta", [0.0, 1.0, 2.0])
def test_tp_full_solve_matches_reference(beta):
    v, w0, h0 = _tp_case(beta, 40, 32, 96, int(beta) + 11)
    kw = dict(beta=beta, sparsity=1.0, max_iter=25, conv_eps=1e-5, flr=1e-9)
    want = j_ms.snmf_solve_model_sharded(
        jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
        JParams(precision="highest", **kw), j_make_mesh((2, 4)))
    p = SnmfParams(**kw)
    got = ms.snmf_solve_model_sharded(_t(v), _t(w0), _t(h0), p,
                                      _mesh((2, 4)))
    mask = torch.ones(32, dtype=torch.bool)
    ref = snmf_solve(_t(v), _t(w0), _t(h0), mask, mask, p)
    assert _rel(got.w, want.w) < TOL and _rel(got.h, want.h) < TOL
    assert int(got.iters) == int(want.iters) == int(ref.iters)
    assert _rel(got.cost, want.cost) < TOL and _rel(got.w, ref.w) < TOL


def test_tp_w_refit_masked_matches_reference():
    v, w0, h0 = _tp_case(1.0, 40, 32, 64, 7)
    w_mask = np.random.default_rng(7).random(32) > 0.4
    h_mask = np.ones(32, bool)
    kw = dict(beta=1.0, sparsity=5.0, max_iter=30, conv_eps=1e-4, flr=1e-9)
    want = j_ms.snmf_solve_model_sharded(
        jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
        JParams(precision="highest", **kw), j_make_mesh((2, 4)),
        w_mask=jnp.asarray(w_mask), h_mask=jnp.asarray(h_mask),
        update_w=True, update_h=False)
    got = ms.snmf_solve_model_sharded(
        _t(v), _t(w0), _t(h0), SnmfParams(**kw), _mesh((2, 4)),
        w_mask=_t(w_mask), h_mask=_t(h_mask), update_w=True, update_h=False)
    assert _rel(got.w, want.w) < TOL
    assert int(got.iters) == int(want.iters)
    assert int(got.iters) < kw["max_iter"]          # the stop fired


def test_tp_rank_guard():
    with pytest.raises(ValueError, match="not divisible"):
        ms.snmf_h_solve_columns_model_sharded(
            torch.ones(8, 4), torch.ones(8, 6), torch.ones(6, 4),
            SnmfParams(), _mesh((2, 4)))
    with pytest.raises(ValueError, match="not divisible"):
        ms.snmf_solve_model_sharded(
            torch.ones(8, 4), torch.ones(8, 6), torch.ones(6, 4),
            SnmfParams(), _mesh((2, 4)))


# ---------------------------------------------------------------------------
# the audit, DP enhancement and the scaling measurement
# ---------------------------------------------------------------------------

def _small_cfg():
    cfg = default_config()
    return cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                      adapt=replace(cfg.adapt, r_a=4, m_a=10),
                      nmf=replace(cfg.nmf, max_iter=10))


def test_audit_all_counts_and_bytes():
    cfg = _small_cfg()
    out = audit_all(per_device_batch=2, mesh=_mesh(), cfg=cfg)
    assert set(out) == {"dp_enhance_block_plan", "pmean_dictionary_merge",
                        "train_step_4iter", "tp_h_solve",
                        "time_sharded_enhance"}
    f, r, r_a = cfg.signal.n_bins, 16, cfg.adapt.r_a
    assert out["dp_enhance_block_plan"]["n_collectives"] == 0
    assert out["time_sharded_enhance"]["n_collectives"] == 0
    merge = out["pmean_dictionary_merge"]
    assert merge["n_collectives"] == 1 and merge["total_bytes"] == f * r_a * 4
    train = out["train_step_4iter"]
    assert train["n_collectives"] == 4
    assert train["total_bytes"] == 4 * train["per_trip_bytes"]
    assert train["per_trip_bytes"] == (f * r + r) * 4
    tp = out["tp_h_solve"]             # conv_eps 0: 40 fixed trips
    assert tp["n_collectives"] == 42
    # 41 rebuilds of the (F,N) reconstruction, then the final penalty
    assert tp["total_bytes"] == 41 * tp["per_iteration_bytes"] + 4


def _enhancer(cfg, **kw):
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 8, 8, seed=0)
    return SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                        dtype=torch.float64, **kw)


@pytest.mark.parametrize("plan", ["exact", "fast", "block"])
def test_dp_run_equals_the_unsharded_batch(plan):
    cfg = _small_cfg()
    if plan == "fast":
        cfg = cfg.evolve(adapt=replace(cfg.adapt, adapt_train_n=False))
    enh = _enhancer(cfg, block_adapt=8 if plan == "block" else 0)
    s = cfg.signal
    xs = [fixtures.noisy_utterance(40 * s.frameshift, seed=i)
          for i in range(4)]
    frames = torch.as_tensor(np.stack([enh._pad_frames(enh.frames_for(x))
                                       for x in xs]))
    states = None if plan == "fast" else batch_state(enh.initial_state(), 4)
    with record() as rep:
        y, st = dp_run(enh, frames, _mesh((4, 1)), states)
    want, st_want = enh.run_frames(frames, states)
    assert rep.count == 0
    assert torch.equal(y, want)
    assert (st is None) == (plan == "fast")


def test_measure_dp_scaling_on_the_cpu():
    cfg = _small_cfg()
    x = fixtures.noisy_utterance(20 * cfg.signal.frameshift, seed=0)
    for kw, plan in ((dict(block_adapt=8), "block_adaptive"),
                     ({}, "exact_scan")):
        out = measure_dp_scaling(_enhancer(cfg, **kw), x, 16000,
                                 per_device_batch=2, n_rep=1)
        assert out["plan"] == plan and set(out) == {"plan", 1}
        assert {"audio_s_per_s", "devices",
                "efficiency_vs_1dev"} <= set(out[1])
        assert out[1]["devices"] == 1 and out[1]["efficiency_vs_1dev"] == 1.0
        assert out[1]["device_audio_s_per_s"] is None    # no card here


# ---------------------------------------------------------------------------
# the fleet over a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_fleet_over_a_mesh_equals_one_fleet(shards):
    cfg = _small_cfg()
    cfg = cfg.evolve(nmf=replace(cfg.nmf, max_iter=6))
    enh = _enhancer(cfg, matlab_ad_blk_init=False)
    xs = np.stack([fixtures.noisy_utterance(4160, seed=i) for i in range(4)])
    mesh = _mesh((shards, 1))
    fleet = MultiStreamSession(enh, 4, block_frames=8, mesh=mesh)
    assert isinstance(fleet, ShardedFleet) and fleet.n_shards == shards
    plain = MultiStreamSession(enh, 4, block_frames=8)
    got = np.concatenate([fleet.push(xs), fleet.flush()], axis=1)
    want = np.concatenate([plain.push(xs), plain.flush()], axis=1)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_fleet_over_a_mesh_refusals_and_one_shard():
    enh = _enhancer(_small_cfg())
    with pytest.raises(ValueError, match="must divide the mesh data axis"):
        MultiStreamSession(enh, 6, mesh=_mesh((4, 1)))
    one = MultiStreamSession(enh, 3, mesh=_mesh((1, 1)))
    assert type(one) is MultiStreamSession
