"""Carry the JAX side's configuration, dictionaries, engine state, trained
BNMF speech models and multichannel stream states across to the port.

The reference package's config is a tree of dataclasses, its dictionaries
are NumPy arrays and its state is an ``EngineState`` NamedTuple of arrays;
these helpers take them by their field names (any object that has them) so
both packages start from identical values.  Nothing here imports JAX or the
reference package.  Tensors land on the card unless ``device`` names
another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.enhance.state import EngineState

_INT_FIELDS = {"update_switch": torch.int32, "adapt_on": torch.bool}


def _section(cls, src):
    """``cls`` built from the fields of ``src``, nested sections included."""
    vals = {}
    for f in dataclasses.fields(cls):
        val = getattr(src, f.name)
        held = getattr(cls(), f.name)
        vals[f.name] = (_section(type(held), val)
                        if dataclasses.is_dataclass(held) else val)
    return cls(**vals)


def config_from_jax(cfg) -> PipelineConfig:
    """The port's ``PipelineConfig`` from the reference's (or any object with
    its fields): every section and field copied by name."""
    return _section(PipelineConfig, cfg)


def bases_to_torch(b1_x, b1_d, b2_x, b2_d, device=None,
                   dtype=torch.float32):
    """The four (F, r) dictionaries as tensors on ``device``."""
    device = resolve_device(device)
    return tuple(torch.as_tensor(np.asarray(b), dtype=dtype, device=device)
                 for b in (b1_x, b1_d, b2_x, b2_d))


def state_from_jax(state, device=None, dtype=torch.float32) -> EngineState:
    """The port's ``EngineState`` from a reference state of NumPy arrays
    (batched or not: shapes are kept)."""
    device = resolve_device(device)
    fields = {}
    for name in EngineState._fields:
        a = np.array(getattr(state, name))      # a writable copy
        fields[name] = torch.as_tensor(
            a, dtype=_INT_FIELDS.get(name, dtype), device=device)
    return EngineState(**fields)


def state_to_numpy(state: EngineState) -> EngineState:
    """The inverse of ``state_from_jax``: every field as a NumPy array
    (``EngineState(**s._asdict())`` rebuilds the reference's state)."""
    return EngineState(*(f.detach().cpu().numpy() for f in state))


def bnmf_model_from_jax(model, device=None, dtype=torch.float32):
    """The port's ``BnmfModel`` from a reference one (its basis posterior's
    ``shape`` and ``scale`` and its ``u0``, as NumPy arrays or anything
    ``np.asarray`` takes), so both packages enhance with the same trained
    speech model."""
    from se_snmf_nat_tpu_torch.bnmf import BnmfModel, GammaPost
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return BnmfModel(GammaPost(t(model.w.shape), t(model.w.scale)),
                     t(model.u0))


def pmwf_state_from_jax(state, device=None, dtype=torch.float32):
    """The port's ``PmwfStreamState`` from a reference multichannel stream
    state (its ``y_win``, ``ycov``, ``ncov`` and ``l`` as NumPy arrays, a
    leading lane axis or not): the complex fields in the complex dtype of
    ``dtype``, the frame counter int32, so the stream continues in the
    port."""
    from se_snmf_nat_tpu_torch.multichannel.pmwf import complex_dtype
    from se_snmf_nat_tpu_torch.multichannel.streaming import PmwfStreamState
    device = resolve_device(device)
    fields = {}
    for name in PmwfStreamState._fields:
        a = np.array(getattr(state, name))
        fields[name] = torch.as_tensor(
            a, dtype=complex_dtype(dtype) if a.dtype.kind == "c"
            else torch.int32, device=device)
    return PmwfStreamState(**fields)


def pmwf_state_to_numpy(state):
    """The inverse of ``pmwf_state_from_jax``: every field as a NumPy array
    (``PmwfStreamState(**s._asdict())`` rebuilds the reference's state,
    whose stream then continues)."""
    return type(state)(*(f.detach().cpu().numpy() for f in state))
