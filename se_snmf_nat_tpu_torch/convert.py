"""Carry the JAX side's dictionaries and engine state across to the port.

The reference package's dictionaries are NumPy arrays and its state is an
``EngineState`` NamedTuple of arrays; these helpers take them as NumPy (or
anything with the same field names) so both packages start from identical
values.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.enhance.state import EngineState

_INT_FIELDS = {"update_switch": torch.int32, "adapt_on": torch.bool}


def bases_to_torch(b1_x, b1_d, b2_x, b2_d, device=None,
                   dtype=torch.float32):
    """The four (F, r) dictionaries as tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(b), dtype=dtype, device=device)
                 for b in (b1_x, b1_d, b2_x, b2_d))


def state_from_jax(state, device=None, dtype=torch.float32) -> EngineState:
    """The port's ``EngineState`` from a reference state of NumPy arrays
    (batched or not: shapes are kept)."""
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
