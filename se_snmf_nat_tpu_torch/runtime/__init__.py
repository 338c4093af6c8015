"""Runtime services of the port: state checkpointing (the reference's
.mat-file persistence, SURVEY §5 'Checkpoint / resume'), the directory
runner, stage timers and traces; the TCP server (``runtime.server``) and
the SNR-grid campaign (``runtime.grid``) are imported by name."""

from se_snmf_nat_tpu_torch.runtime.checkpoint import (
    save_engine_state, load_engine_state, save_adapted_dictionary,
    load_adapted_dictionary)
from se_snmf_nat_tpu_torch.runtime.runner import BatchRunner, RunReport
from se_snmf_nat_tpu_torch.runtime.profiling import StageTimer, trace, span

__all__ = [
    "save_engine_state", "load_engine_state",
    "save_adapted_dictionary", "load_adapted_dictionary",
    "BatchRunner", "RunReport",
    "StageTimer", "trace", "span",
]
