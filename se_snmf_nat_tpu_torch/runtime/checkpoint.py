"""Engine-state and multichannel-stream checkpoints (npz).  Counterpart of
the npz half of the reference package's ``runtime/checkpoint.py``.

Reference equivalents:
  * B_D_u.mat — the adapted noise dictionary persisted across utterances
    (src/NTF_sep_event_RT.m:28-38,136-139);
  * the streaming resume structs.

The WHOLE state checkpoints (not just the dictionary), so a resumed stream
is bit-identical to an uninterrupted one.  The files are .npz with the
reference package's keys and dtypes (complex arrays stored as complex), so
each package reads the other's; every write goes to a temporary file that
``os.replace`` moves into place.  Loads put the tensors on the card unless
``device`` names another.  The reference's orbax pair is not ported (orbax
is JAX-only).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from se_snmf_nat_tpu_torch.convert import (
    pmwf_state_from_jax, state_from_jax)
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.enhance.state import EngineState


def _np_savable(a: torch.Tensor) -> np.ndarray:
    """A field as NumPy: np.savez has no bfloat16, so bf16 is stored as
    float32 (exact; the loads cast to the requested dtype anyway)."""
    a = a.detach()
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.cpu().numpy()


def _save(path: str | Path, fields: dict) -> None:
    path = Path(path)
    tmp = path.with_name(path.stem + ".tmp.npz")  # savez appends .npz
    np.savez_compressed(tmp, **fields)
    os.replace(tmp, path)


def save_engine_state(path: str | Path, state: EngineState) -> None:
    _save(path, {f: _np_savable(getattr(state, f)) for f in state._fields})


def load_engine_state(path: str | Path, dtype=torch.float32,
                      device=None) -> EngineState:
    """An ``EngineState`` from an npz of either package.  A field the file
    lacks (``adapt_on``, added later) takes its default, True."""
    device = resolve_device(device)
    with np.load(str(path)) as z:
        fields = {f: z[f] for f in EngineState._fields if f in z.files}
    fields.setdefault("adapt_on", np.asarray(True))
    return state_from_jax(EngineState(**fields), device, dtype)


def save_adapted_dictionary(path: str | Path, state: EngineState) -> None:
    """B_D_u.mat-equivalent: persist only the adapted noise-dictionary head
    (what the reference saves, NTF_sep_event_RT.m:136-139)."""
    _save(path, {"b_d_head": _np_savable(state.b_d_head)})


def load_adapted_dictionary(path: str | Path, state: EngineState,
                            dtype=torch.float32) -> EngineState:
    """Seed a state's dictionary head from a persisted checkpoint
    (NTF_sep_event_RT.m:28-38 try/catch load — missing file = the state
    unchanged), on the state's device."""
    path = Path(path)
    if not path.exists():
        return state
    with np.load(str(path)) as z:
        return state._replace(b_d_head=torch.as_tensor(
            z["b_d_head"], dtype=dtype, device=state.b_d_head.device))


def save_pmwf_state(path: str | Path, state) -> None:
    """A ``multichannel.streaming.PmwfStreamState`` (complex fields stored
    as complex)."""
    _save(path, {f: _np_savable(getattr(state, f)) for f in state._fields})


def load_pmwf_state(path: str | Path, dtype=torch.float32, device=None):
    """A ``PmwfStreamState`` from an npz of either package: complex fields
    in the complex dtype of ``dtype``, the frame counter int32."""
    from se_snmf_nat_tpu_torch.multichannel.streaming import PmwfStreamState
    device = resolve_device(device)
    with np.load(str(path)) as z:
        fields = {f: z[f] for f in PmwfStreamState._fields}
    return pmwf_state_from_jax(PmwfStreamState(**fields), device, dtype)
