"""The port's npz checkpoints (``runtime/checkpoint.py``) on the CPU: the
engine state, the adapted dictionary and the multichannel stream state
round-trip field for field; a stream resumed from its checkpoint gives the
uninterrupted stream's bits; and the files pass between the packages both
ways (the same keys and dtypes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_snmf_nat_tpu import multichannel as J
from se_snmf_nat_tpu.config import default_config as j_default_config
from se_snmf_nat_tpu.enhance.state import EngineState as JEngineState
from se_snmf_nat_tpu.runtime import checkpoint as j_ckpt
from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.convert import state_to_numpy
from se_snmf_nat_tpu_torch.enhance.state import init_engine_state
from se_snmf_nat_tpu_torch.multichannel import (
    PmwfParams, make_pmwf_streaming_run, pmwf_stream_init,
    pmwf_streaming_enhance)
from se_snmf_nat_tpu_torch.multichannel.fixture import synth_mixture
from se_snmf_nat_tpu_torch.multichannel.pmwf import frames_of
from se_snmf_nat_tpu_torch.runtime import checkpoint as ckpt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine_state():
    cfg = default_config()
    _, bd = fixtures.synthetic_bases(cfg.signal.n_bins, cfg.sep.r_x,
                                     cfg.sep.r_d)
    st = init_engine_state(cfg, bd, cfg.signal.n_bins, device="cpu")
    rng = np.random.default_rng(0)       # a state that has moved
    return st._replace(
        lambda_dav=torch.as_tensor(rng.random(st.lambda_dav.shape),
                                   dtype=torch.float32),
        update_switch=torch.tensor(7, dtype=torch.int32),
        adapt_on=torch.tensor(False))


def _equal_fields(a, b):
    for name, x, y in zip(a._fields, a, b):
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        y = y if torch.is_tensor(y) else torch.as_tensor(np.asarray(y))
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_engine_state_round_trip(tmp_path, engine_state):
    path = tmp_path / "state.npz"
    ckpt.save_engine_state(path, engine_state)
    assert not list(tmp_path.glob("*.tmp.npz"))
    _equal_fields(ckpt.load_engine_state(path, device="cpu"), engine_state)
    st64 = ckpt.load_engine_state(path, dtype=torch.float64, device="cpu")
    assert st64.lambda_dav.dtype == torch.float64
    assert st64.update_switch.dtype == torch.int32


def test_engine_state_files_pass_between_packages(tmp_path, engine_state):
    ckpt.save_engine_state(tmp_path / "port.npz", engine_state)
    ref = JEngineState(**state_to_numpy(engine_state)._asdict())
    j_ckpt.save_engine_state(tmp_path / "ref.npz", ref)
    _equal_fields(ckpt.load_engine_state(tmp_path / "ref.npz", device="cpu"),
                  engine_state)
    got = j_ckpt.load_engine_state(tmp_path / "port.npz")
    for name, x, y in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_engine_state_without_adapt_on_loads(tmp_path, engine_state):
    """Files written before ``adapt_on`` existed load with it on."""
    fields = {f: getattr(engine_state, f).numpy()
              for f in engine_state._fields if f != "adapt_on"}
    np.savez(tmp_path / "old.npz", **fields)
    st = ckpt.load_engine_state(tmp_path / "old.npz", device="cpu")
    assert st.adapt_on.dtype == torch.bool and bool(st.adapt_on)


def test_adapted_dictionary_round_trip(tmp_path, engine_state):
    path = tmp_path / "B_D_u.npz"
    fresh = engine_state._replace(
        b_d_head=torch.zeros_like(engine_state.b_d_head))
    assert ckpt.load_adapted_dictionary(path, fresh) is fresh   # no file
    ckpt.save_adapted_dictionary(path, engine_state)
    got = ckpt.load_adapted_dictionary(path, fresh)
    assert torch.equal(got.b_d_head, engine_state.b_d_head)
    ref = j_ckpt.load_adapted_dictionary(
        path, JEngineState(**state_to_numpy(fresh)._asdict()))
    np.testing.assert_array_equal(np.asarray(ref.b_d_head),
                                  engine_state.b_d_head.numpy())


@pytest.fixture(scope="module")
def stream():
    cfg = default_config()
    x = synth_mixture(n=9600, n_ch=3)[0]
    return cfg, x, frames_of(x, cfg)


def test_pmwf_state_round_trip_resumes_bit_identically(tmp_path, stream):
    cfg, x, fr = stream
    _, st_full = pmwf_streaming_enhance(x, dtype=torch.float64,
                                        return_state=True, device="cpu")
    run = make_pmwf_streaming_run(cfg, PmwfParams(), torch.float64, "cpu")
    _, st_a = run(fr[:, :40], pmwf_stream_init(PmwfParams(), 3, 513,
                                               torch.complex128, "cpu"))
    ckpt.save_pmwf_state(tmp_path / "pmwf.npz", st_a)
    st_r = ckpt.load_pmwf_state(tmp_path / "pmwf.npz", torch.float64, "cpu")
    _equal_fields(st_r, st_a)
    _, st_b = run(fr[:, 40:], st_r)
    _equal_fields(st_b, st_full)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pmwf_state_files_pass_between_packages(tmp_path, stream, dtype):
    cfg, x, fr = stream
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j_run = J.make_pmwf_streaming_run(j_default_config(), J.PmwfParams(),
                                      jdt)
    cdt = jnp.complex128 if dtype == torch.float64 else jnp.complex64
    _, j_a = j_run(jnp.asarray(fr[:, :40], jdt),
                   J.pmwf_stream_init(J.PmwfParams(), 3, 513, cdt))
    j_ckpt.save_pmwf_state(tmp_path / "ref.npz", j_a)
    got = ckpt.load_pmwf_state(tmp_path / "ref.npz", dtype, "cpu")
    for f in J.PmwfStreamState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(j_a, f)))
    assert got.l.dtype == torch.int32
    ckpt.save_pmwf_state(tmp_path / "port.npz", got)
    back = j_ckpt.load_pmwf_state(tmp_path / "port.npz", jdt)
    for f in J.PmwfStreamState._fields:
        a, b = np.asarray(getattr(back, f)), np.asarray(getattr(j_a, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
