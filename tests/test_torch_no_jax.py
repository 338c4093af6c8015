"""The port never loads JAX nor the JAX package, and its entry points refuse
to run on a machine without a card (unless the caller says ``device="cpu"``)
instead of quietly running on the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", [
    "se_snmf_nat_tpu_torch.stream.pipeline",
    "se_snmf_nat_tpu_torch.stream.batch_host",
    "se_snmf_nat_tpu_torch.headline",
    "se_snmf_nat_tpu_torch.kernels.mu",
    "se_snmf_nat_tpu_torch.kernels.gain",
    "se_snmf_nat_tpu_torch.convert",
    "se_snmf_nat_tpu_torch.fixtures",
    "se_snmf_nat_tpu_torch.stream.fast_pipeline",
    "se_snmf_nat_tpu_torch.dsp.mel",
    "se_snmf_nat_tpu_torch.config",
    "se_snmf_nat_tpu_torch.io.wavio",
    "se_snmf_nat_tpu_torch.utils.matlab_compat",
    "se_snmf_nat_tpu_torch.enhance.state",
    "se_snmf_nat_tpu_torch.stream.block_adaptive",
    "se_snmf_nat_tpu_torch.enhance.engine",
    "se_snmf_nat_tpu_torch.enhance.blk_sparse",
    "se_snmf_nat_tpu_torch.stream.streaming",
    "se_snmf_nat_tpu_torch.nmf.solver",
    "se_snmf_nat_tpu_torch.stream.serving",
    "se_snmf_nat_tpu_torch.runtime.server",
    "se_snmf_nat_tpu_torch.io",
    "se_snmf_nat_tpu_torch.io.basis",
    "se_snmf_nat_tpu_torch.dsp.splice",
    "se_snmf_nat_tpu_torch.dsp.smoothing",
    "se_snmf_nat_tpu_torch.dsp.resample",
    "se_snmf_nat_tpu_torch.train",
    "se_snmf_nat_tpu_torch.train.basis",
    "se_snmf_nat_tpu_torch.train.dnmf",
    "se_snmf_nat_tpu_torch.nmf.mdi",
    "se_snmf_nat_tpu_torch.metrics",
    "se_snmf_nat_tpu_torch.utils.special",
    "se_snmf_nat_tpu_torch.enhance",
    "se_snmf_nat_tpu_torch.enhance.imcra_params",
    "se_snmf_nat_tpu_torch.enhance.imcra",
    "se_snmf_nat_tpu_torch.enhance.ms_params",
    "se_snmf_nat_tpu_torch.enhance.ms",
    "se_snmf_nat_tpu_torch.bnmf",
    "se_snmf_nat_tpu_torch.bnmf.vb",
    "se_snmf_nat_tpu_torch.bnmf.enhance",
    "se_snmf_nat_tpu_torch.bnmf.streaming",
    "se_snmf_nat_tpu_torch.multichannel",
    "se_snmf_nat_tpu_torch.multichannel.fixture",
    "se_snmf_nat_tpu_torch.multichannel.ntf",
    "se_snmf_nat_tpu_torch.multichannel.pmwf",
    "se_snmf_nat_tpu_torch.multichannel.streaming",
    "se_snmf_nat_tpu_torch.runtime.checkpoint",
    "se_snmf_nat_tpu_torch.io.native",
    "se_snmf_nat_tpu_torch.io.capture",
    "se_snmf_nat_tpu_torch.utils.visualize",
    "se_snmf_nat_tpu_torch.cli",
    "se_snmf_nat_tpu_torch.__main__",
    "se_snmf_nat_tpu_torch.graft_entry",
    "se_snmf_nat_tpu_torch.runtime",
    "se_snmf_nat_tpu_torch.runtime.runner",
    "se_snmf_nat_tpu_torch.runtime.grid",
    "se_snmf_nat_tpu_torch.runtime.profiling",
    "se_snmf_nat_tpu_torch.parallel",
    "se_snmf_nat_tpu_torch.parallel.mesh",
    "se_snmf_nat_tpu_torch.parallel.distributed",
    "se_snmf_nat_tpu_torch.parallel.time_shard",
    "se_snmf_nat_tpu_torch.parallel.train_step",
    "se_snmf_nat_tpu_torch.parallel.model_shard",
    "se_snmf_nat_tpu_torch.parallel.scaling",
    "se_snmf_nat_tpu_torch.parallel.collectives_audit",
    "se_snmf_nat_tpu_torch.bench",
])
def test_port_imports_without_jax(module):
    """Importing a port module loads neither ``jax`` nor any module of the
    JAX package."""
    proc = _run(
        f"import sys, importlib; importlib.import_module({module!r});"
        " print(sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'se_snmf_nat_tpu'"
        " or m.startswith('se_snmf_nat_tpu.')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+se_snmf_nat_tpu(\s|\.|$)|from\s+se_snmf_nat_tpu(\.\S*)?"
    r"\s+import|import\s+jax\b|from\s+jax\b)", re.M)


def _port_sources():
    return sorted((ROOT / "se_snmf_nat_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "tools" / "kernel_variants.py",
           ROOT / "tests" / "torch_distributed_worker.py",
           ROOT / "tools" / "fft_rows.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_nothing_of_the_jax_package(path):
    found = _FORBIDDEN.findall(path.read_text())
    assert not found, f"{path}: {found}"


def test_forbidden_import_pattern_matches():
    for line in ("import se_snmf_nat_tpu", "from se_snmf_nat_tpu import config",
                 "    from se_snmf_nat_tpu.config import preset", "import jax",
                 "import se_snmf_nat_tpu.config as c",
                 "from jax import numpy"):
        assert _FORBIDDEN.search(line), line
    for line in ("import se_snmf_nat_tpu_torch",
                 "from se_snmf_nat_tpu_torch.config import preset",
                 "# import se_snmf_nat_tpu"):
        assert not _FORBIDDEN.search(line), line


def _no_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def test_require_cuda_raises_without_a_card():
    _no_cuda()
    from se_snmf_nat_tpu_torch.device import require_cuda
    with pytest.raises(RuntimeError):
        require_cuda()


def _default_device_cases():
    import numpy as np

    from se_snmf_nat_tpu_torch import bench, fixtures
    from se_snmf_nat_tpu_torch.config import default_config, preset
    from se_snmf_nat_tpu_torch.convert import bases_to_torch, state_from_jax
    from se_snmf_nat_tpu_torch.enhance.engine import Engine, make_engine
    from se_snmf_nat_tpu_torch.enhance.state import init_engine_state
    from se_snmf_nat_tpu_torch.headline import build_headline_enhancer
    from se_snmf_nat_tpu_torch.stream.block_adaptive import (
        make_block_adaptive_run, make_block_step)
    from se_snmf_nat_tpu_torch.stream.fast_pipeline import make_fast_run
    from se_snmf_nat_tpu_torch.runtime.server import EnhanceServer
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    from se_snmf_nat_tpu_torch.stream.serving import (
        MultiStreamSession, ShardedFleet)
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession
    from se_snmf_nat_tpu_torch.nmf import SnmfParams, snmf_mdi_solve
    from se_snmf_nat_tpu_torch.bnmf import (
        BnmfEnhancer, BnmfParams, train_speech_model)
    from se_snmf_nat_tpu_torch.convert import bnmf_model_from_jax
    from se_snmf_nat_tpu_torch.enhance.imcra import (
        OmlsaEnhancer, init_imcra_state)
    from se_snmf_nat_tpu_torch.enhance.imcra_params import ImcraParams
    from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer
    from se_snmf_nat_tpu_torch.train.basis import (
        train_event_basis, train_event_basis_cached)
    from se_snmf_nat_tpu_torch.train.dnmf import dnmf_refit
    from se_snmf_nat_tpu_torch.train.features import training_features
    from se_snmf_nat_tpu_torch import multichannel as mc
    from se_snmf_nat_tpu_torch.convert import pmwf_state_from_jax
    from se_snmf_nat_tpu_torch.runtime import checkpoint, grid
    from se_snmf_nat_tpu_torch import graft_entry
    from se_snmf_nat_tpu_torch.parallel import make_mesh
    from se_snmf_nat_tpu_torch.parallel.collectives_audit import audit_all
    from se_snmf_nat_tpu_torch.parallel.distributed import init_multihost
    cfg, fixed = default_config(), preset("snmf")
    bx, bd = fixtures.synthetic_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                      cfg.sep.r_d)
    b4 = (bx, bd, bx, bd)
    cpu_state = init_engine_state(cfg, bd, cfg.signal.n_bins, device="cpu")

    def bnmf_model():
        return train_speech_model(fixtures.speechlike(16000),
                                  BnmfParams(k_speech=4, train_iters=2),
                                  device="cpu")[0]
    return {
        "SnmfEnhancer_block": lambda: SnmfEnhancer(cfg, *b4, block_adapt=8),
        "SnmfEnhancer_fast": lambda: SnmfEnhancer(fixed, *b4),
        "SnmfEnhancer_exact": lambda: SnmfEnhancer(cfg, *b4),
        "Engine": lambda: Engine(cfg, *b4),
        "make_engine": lambda: make_engine(cfg, *b4, emit_sources=True),
        "StreamingSession": lambda: StreamingSession(
            SnmfEnhancer(cfg, *b4), block_frames=8),
        "MultiStreamSession": lambda: MultiStreamSession(
            SnmfEnhancer(cfg, *b4), 2, block_frames=8, wire="samples"),
        "ShardedFleet": lambda: ShardedFleet(
            SnmfEnhancer(cfg, *b4), 4, sub_fleets=2),
        "EnhanceServer": lambda: EnhanceServer(SnmfEnhancer(cfg, *b4)),
        "make_fast_run": lambda: make_fast_run(fixed, *b4),
        "make_block_adaptive_run": lambda: make_block_adaptive_run(cfg, *b4),
        "make_block_step": lambda: make_block_step(cfg, bx, bd),
        "init_engine_state": lambda: init_engine_state(
            cfg, bd, cfg.signal.n_bins),
        "build_headline_enhancer": lambda: build_headline_enhancer(cfg, b4),
        "bases_to_torch": lambda: bases_to_torch(*b4),
        "state_from_jax": lambda: state_from_jax(
            type(cpu_state)(*(np.asarray(f) for f in cpu_state))),
        "train_event_basis": lambda: train_event_basis(
            training_features(fixtures.noise(16000), cfg), cfg, 4),
        "train_event_basis_cached": lambda: train_event_basis_cached(
            ROOT / "no_such_dir", ROOT / "no_such_dir", cfg, 4),
        "dnmf_refit": lambda: dnmf_refit(
            fixtures.speechlike(16000), fixtures.noise(16000),
            np.concatenate([bx, bd], axis=1), cfg),
        "snmf_mdi_solve": lambda: snmf_mdi_solve(
            bx @ bd.T, np.ones((bx.shape[0],) * 2), bx, bd.T,
            np.ones(cfg.sep.r_x, bool), np.ones(cfg.sep.r_x, bool),
            SnmfParams()),
        "OmlsaEnhancer": lambda: OmlsaEnhancer(),
        "init_imcra_state": lambda: init_imcra_state(ImcraParams()),
        "MmseEnhancer": lambda: MmseEnhancer(),
        "MmseEnhancer_mmse": lambda: MmseEnhancer(tracker="mmse"),
        "BnmfEnhancer": lambda: BnmfEnhancer(
            speech=fixtures.speechlike(16000),
            params=BnmfParams(k_speech=4, train_iters=2)),
        "BnmfEnhancer_model": lambda: BnmfEnhancer(bnmf_model()),
        "train_speech_model": lambda: train_speech_model(
            fixtures.speechlike(16000),
            BnmfParams(k_speech=4, train_iters=2)),
        "bnmf_model_from_jax": lambda: bnmf_model_from_jax(bnmf_model()),
        "PmwfEnhancer": lambda: mc.PmwfEnhancer(),
        "PmwfStreamingSession": lambda: mc.PmwfStreamingSession(n_ch=2),
        "pmwf_streaming_enhance": lambda: mc.pmwf_streaming_enhance(
            np.zeros((2, 1600))),
        "make_pmwf_streaming_run": lambda: mc.make_pmwf_streaming_run(
            cfg, mc.PmwfParams()),
        "make_pmwf_streaming_run_fast":
            lambda: mc.make_pmwf_streaming_run_fast(cfg, mc.PmwfParams()),
        "make_pmwf_batch_run": lambda: mc.make_pmwf_batch_run(
            cfg, mc.PmwfParams()),
        "make_pmwf_batch_run_fast": lambda: mc.make_pmwf_batch_run_fast(
            cfg, mc.PmwfParams()),
        "pmwf_stream_init": lambda: mc.pmwf_stream_init(
            mc.PmwfParams(), 2, cfg.signal.n_bins),
        "ntf_solve": lambda: mc.ntf_solve(
            np.ones((2, 8, 4)), np.ones((8, 3)), np.ones((2, 3)),
            np.ones((4, 3))),
        "NtfStreamingSession": lambda: mc.NtfStreamingSession(
            np.ones((8, 3)), 2),
        "pmwf_state_from_jax": lambda: pmwf_state_from_jax(
            mc.pmwf_stream_init(mc.PmwfParams(), 2, 9, device="cpu")),
        "load_pmwf_state": lambda: checkpoint.load_pmwf_state(
            ROOT / "no_such_file.npz"),
        "load_engine_state": lambda: checkpoint.load_engine_state(
            ROOT / "no_such_file.npz"),
        "graft_entry": lambda: graft_entry.entry(),
        "run_grid": lambda: grid.run_grid(ROOT / "no_such_dir"),
        "make_mesh": lambda: make_mesh(),
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(1),
        "audit_all": lambda: audit_all(),
        "init_multihost": lambda: init_multihost("127.0.0.1:1", 1, 0),
        "bench_headline": lambda: bench.run_headline(),
        "bench_latency": lambda: bench.run_latency(),
        "bench_serving": lambda: bench.run_serving(),
        "bench_train_rate": lambda: bench.run_train_rate(),
        "bench_campaign": lambda: bench.run_campaign(),
        "bench_campaign_mixed": lambda: bench.run_campaign_mixed(),
        "bench_multichannel": lambda: bench.run_multichannel(),
        "bench_scaling": lambda: bench.run_scaling(),
        "bench_collectives": lambda: bench.run_collectives(),
        "bench_trace": lambda: bench.run_trace(str(ROOT / "no_such_dir")),
    }


@pytest.mark.parametrize("entry", [
    "SnmfEnhancer_block", "SnmfEnhancer_fast", "make_fast_run",
    "make_block_adaptive_run", "make_block_step", "init_engine_state",
    "build_headline_enhancer", "bases_to_torch", "state_from_jax",
    "SnmfEnhancer_exact", "Engine", "make_engine", "StreamingSession",
    "MultiStreamSession", "ShardedFleet", "EnhanceServer",
    "train_event_basis", "train_event_basis_cached", "dnmf_refit",
    "snmf_mdi_solve", "OmlsaEnhancer", "init_imcra_state", "MmseEnhancer",
    "MmseEnhancer_mmse", "BnmfEnhancer", "BnmfEnhancer_model",
    "train_speech_model", "bnmf_model_from_jax", "PmwfEnhancer",
    "PmwfStreamingSession", "pmwf_streaming_enhance",
    "make_pmwf_streaming_run", "make_pmwf_streaming_run_fast",
    "make_pmwf_batch_run", "make_pmwf_batch_run_fast", "pmwf_stream_init",
    "ntf_solve", "NtfStreamingSession", "pmwf_state_from_jax",
    "load_pmwf_state", "load_engine_state", "graft_entry", "run_grid",
    "make_mesh", "dryrun_multichip", "audit_all", "init_multihost",
    "bench_headline", "bench_latency", "bench_serving", "bench_train_rate",
    "bench_campaign", "bench_campaign_mixed", "bench_multichannel",
    "bench_scaling", "bench_collectives", "bench_trace"])
def test_entry_point_without_device_raises_without_a_card(entry):
    """``device=None`` means the card: without one every entry point raises
    and none carries on on the CPU."""
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _default_device_cases()[entry]()


@pytest.mark.parametrize("path", ["stream/serving.py", "runtime/server.py"])
def test_fleet_and_server_name_no_device_of_their_own(path):
    """The fleet and the server live on their enhancer's device: they take
    no ``device=`` and never name the CPU, so they add no default beside the
    enhancer's (which raises without a card, above)."""
    import inspect

    from se_snmf_nat_tpu_torch.runtime.server import EnhanceServer
    from se_snmf_nat_tpu_torch.stream.serving import (
        MultiStreamSession, ShardedFleet)
    src = (ROOT / "se_snmf_nat_tpu_torch" / path).read_text()
    assert '"cpu"' not in src and "'cpu'" not in src
    assert "resolve_device" not in src and "require_cuda" not in src
    for cls in (MultiStreamSession, ShardedFleet, EnhanceServer):
        assert "device" not in inspect.signature(cls.__init__).parameters


def test_resolve_device_takes_the_cpu_only_when_named():
    from se_snmf_nat_tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    from se_snmf_nat_tpu_torch.kernels import build
    with pytest.raises(RuntimeError):
        build.load()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result without CUDA,
    both in the checkout and alone in an empty directory."""
    _no_cuda()
    for cwd, script in ((ROOT, "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py",
                                               tmp_path))):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
