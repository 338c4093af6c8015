"""Dictionary-training subsystem (reference: run_basis_train.m,
run_basis_DNMF.m, run_basis_DNMF_Mel.m, src/vadenergy_simple.m,
src/load_anot.m)."""

from se_snmf_nat_tpu_torch.train.vad import energy_vad
from se_snmf_nat_tpu_torch.train.dataset import build_training_sequence
from se_snmf_nat_tpu_torch.train.features import training_features
from se_snmf_nat_tpu_torch.train.basis import (
    train_event_basis, BasisTrainResult)
from se_snmf_nat_tpu_torch.train.dnmf import dnmf_refit
from se_snmf_nat_tpu_torch.train.kmeans import kmeans_reduce

__all__ = [
    "energy_vad", "build_training_sequence", "training_features",
    "train_event_basis", "BasisTrainResult", "dnmf_refit", "kmeans_reduce",
]
