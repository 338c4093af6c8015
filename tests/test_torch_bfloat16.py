"""bfloat16 where the JAX package runs it: the SNMF plans with the matmul
DFT (``dft_matmul=True``, the command line's ``--dft-matmul``) and the
trainers, on the plain solvers (the kernels are float32 only).

The envelope rule of the float32 gates, applied to bfloat16: the port's
gap to the JAX package in bfloat16 must be no larger than the JAX
package's own gap from bfloat16 to x64 on the same clip (RMS of the int16
difference, or relative Frobenius norm for dictionaries).  The reference's
exact plan turns most samples of this clip into NaN in bfloat16 (its 0/0
where activations underflow, which the port guards since its float32
repair), so the comparison with it runs on the samples the reference keeps
finite, and the port's output must be finite everywhere."""

from dataclasses import replace

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.cli import main as j_main
from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.stream.pipeline import SnmfEnhancer as JEnhancer
from se_snmf_nat_tpu.stream.serving import MultiStreamSession as JFleet
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.cli import _torch_dtype, main
from se_snmf_nat_tpu_torch.convert import config_from_jax
from se_snmf_nat_tpu_torch.io.basis import BasisPair, load_basis, save_basis
from se_snmf_nat_tpu_torch.io.wavio import read_wav_int16, write_wav_int16
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
J_DTYPES = {"bf16": jnp.bfloat16, "x64": jnp.float64}


def _cfg(adapt=True):
    cfg = default_config()
    return cfg.evolve(
        sep=replace(cfg.sep, r_x=8, r_d=8),
        adapt=replace(cfg.adapt, adapt_train_n=adapt, r_a=4, m_a=10),
        nmf=replace(cfg.nmf, max_iter=10))


def _rms(d):
    return float(np.sqrt(np.mean(np.asarray(d, np.float64) ** 2)))


# plan: (adaptation, block_adapt); block_adapt=0 without adaptation is the
# fast plan SnmfEnhancer picks by itself
PLANS = {"exact": (True, 0), "fast": (False, 0), "block": (True, 8)}


@pytest.mark.parametrize("plan", list(PLANS))
def test_plans_within_the_reference_bfloat16_envelope(plan):
    adapt, block_adapt = PLANS[plan]
    cfg = _cfg(adapt)
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 8, 8, seed=0)
    x = fixtures.noisy_utterance(8000, seed=0)
    j = {k: JEnhancer(cfg, bx, bd, bx, bd, dtype=dt, dft_matmul=True,
                      block_adapt=block_adapt)
         for k, dt in J_DTYPES.items()}
    t = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                     dtype=torch.bfloat16, dft_matmul=True,
                     block_adapt=block_adapt)
    solvers = {"exact": (t.engine.h_solver, t.engine.w_solver),
               "fast": (t.fast_run.h_solver if t.fast_run else None,),
               "block": (t.run.step.h_solver if t.run else None,
                         t.run.step.w_solver if t.run else None)}[plan]
    assert set(solvers) == {"plain"}
    with np.errstate(invalid="ignore"):         # the reference's NaN casts
        j16, j64 = (j[k].enhance(x) for k in ("bf16", "x64"))
        kept = np.isfinite(np.asarray(j["bf16"].enhance(x, quantize=False),
                                      np.float64))
    got_f = t.enhance(x, quantize=False)
    assert np.isfinite(got_f).all()
    got = t.enhance(x)
    assert got.dtype == np.int16 and got.shape == j64.shape
    if plan != "exact":
        assert kept.all()
    port_gap = _rms(got[kept].astype(np.int64) - j16[kept])
    ref_gap = _rms(j16[kept].astype(np.int64) - j64[kept])
    assert 0 < ref_gap and port_gap <= ref_gap, (port_gap, ref_gap)


def test_fleet_runs_in_bfloat16_within_the_envelope():
    """The serving fleet (the ``serve`` command's) on the matmul DFT."""
    cfg = _cfg()
    bx, bd = fixtures.structured_bases(cfg.signal.n_bins, 8, 8, seed=0)
    xs = np.stack([fixtures.noisy_utterance(8000, seed=s) for s in (0, 1)])
    with np.errstate(invalid="ignore"):
        j16, j64 = (JFleet(JEnhancer(cfg, bx, bd, bx, bd, dtype=dt,
                                     dft_matmul=True), 2,
                           block_frames=8).push(xs)
                    for dt in (jnp.bfloat16, jnp.float64))
    t = SnmfEnhancer(config_from_jax(cfg), bx, bd, bx, bd, device="cpu",
                     dtype=torch.bfloat16, dft_matmul=True)
    got = MultiStreamSession(t, 2, block_frames=8).push(xs)
    assert got.shape == j16.shape
    assert _rms(got.astype(np.int64) - j16) <= _rms(
        j16.astype(np.int64) - j64)


def test_torch_dtype_maps_bfloat16_where_the_reference_runs_it():
    assert _torch_dtype("bfloat16", "train", bfloat16=True) is torch.bfloat16
    assert _torch_dtype("float64", "demo") is torch.float64
    with pytest.raises(SystemExit, match="RFFT input must be float32"):
        _torch_dtype("bfloat16", "demo --mode ms")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16")
    (root / "db").mkdir()
    for i in range(2):
        write_wav_int16(root / "db" / f"u{i}.wav", fixtures.noisy_utterance(
            12000, seed=i).astype(np.int16), 16000)
    write_wav_int16(root / "speech.wav", fixtures.clean_utterance(
        16000, seed=7).astype(np.int16), 16000)
    rng = np.random.default_rng(4)
    for name, r in (("b.npz", 100), ("b200.npz", 200)):   # r_x, r_x + r_d
        save_basis(root / name, BasisPair(b_dft=rng.random((513, r)) + 1e-3,
                                          b_mel=rng.random((64, r)) + 1e-3))
    return root


def _f64(a):
    """A dictionary read back from an npz: the reference writes its
    bfloat16 arrays as 2-byte void records (the port widens to float32)."""
    a = np.asarray(a)
    return (a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V"
            else a).astype(np.float64)


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_train_runs_in_bfloat16_as_the_reference(work, tmp_path, capsys):
    argv = ["train", "--db", str(work / "db"), "--rank", "6", "--seed", "0"]
    assert main([*argv, "--dtype", "bfloat16", "--basis-dir",
                 str(tmp_path / "t"), *CPU]) == 0
    capsys.readouterr()
    for dt in ("bfloat16", "float64"):
        assert j_main([*argv, "--dtype", dt, "--basis-dir",
                       str(tmp_path / dt)]) == 0
    got, j16, j64 = (load_basis(tmp_path / d / "R_6.npz")
                     for d in ("t", "bfloat16", "float64"))
    assert np.isfinite(got.b_dft).all() and got.b_dft.shape == (513, 6)
    assert _rel(got.b_dft, j16.b_dft) <= _rel(j16.b_dft, j64.b_dft)


def test_dnmf_runs_in_bfloat16_as_the_reference(work, tmp_path):
    argv = ["dnmf", "--clean", str(work / "speech.wav"), "--noise",
            str(work / "db" / "u0.wav"), "--basis", str(work / "b200.npz")]
    assert main([*argv, "--dtype", "bfloat16", "--output",
                 str(tmp_path / "t.npz"), *CPU]) == 0
    for dt in ("bfloat16", "float64"):
        assert j_main([*argv, "--dtype", dt, "--output",
                       str(tmp_path / f"{dt}.npz")]) == 0
    got, j16, j64 = (load_basis(tmp_path / f"{d}.npz")
                     for d in ("t", "bfloat16", "float64"))
    assert np.isfinite(got.b_dft).all() and got.b_dft.dtype != j16.b_dft.dtype
    assert _rel(got.b_dft, j16.b_dft) <= _rel(j16.b_dft, j64.b_dft)


def test_enhance_command_runs_bfloat16_with_the_matmul_dft(work, tmp_path):
    out = tmp_path / "y.wav"
    assert main(["enhance", str(work / "db" / "u0.wav"), "--output",
                 str(out), "--dtype", "bfloat16", "--dft-matmul",
                 "--preset", "snmf", "--max-iter", "5", "--speech-basis",
                 str(work / "b.npz"), "--noise-basis", str(work / "b.npz"),
                 *CPU]) == 0
    y, _ = read_wav_int16(out)
    assert len(y) > 0 and np.abs(y).max() > 0
