"""The port never loads JAX, and its CUDA entry points refuse to run on a
machine without a card instead of quietly running on the CPU."""

import os
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
    "se_snmf_nat_tpu_torch.headline",
    "se_snmf_nat_tpu_torch.kernels.mu",
    "se_snmf_nat_tpu_torch.convert",
    "se_snmf_nat_tpu_torch.fixtures",
    "se_snmf_nat_tpu_torch.stream.fast_pipeline",
    "se_snmf_nat_tpu_torch.dsp.mel",
])
def test_port_imports_without_jax(module):
    proc = _run(f"import sys, importlib; importlib.import_module({module!r});"
                " print('jax' in sys.modules)")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def _no_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def test_require_cuda_raises_without_a_card():
    _no_cuda()
    from se_snmf_nat_tpu_torch.device import require_cuda
    with pytest.raises(RuntimeError):
        require_cuda()


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
