from se_snmf_nat_tpu_torch.nmf.solver import (
    SnmfParams,
    snmf_solve,
    snmf_solve_traced,
    snmf_h_solve_columns,
    normalize_columns,
)
from se_snmf_nat_tpu_torch.nmf.mdi import MdiResult, snmf_mdi_solve

__all__ = [
    "SnmfParams",
    "snmf_solve",
    "snmf_solve_traced",
    "snmf_h_solve_columns",
    "normalize_columns",
    "MdiResult",
    "snmf_mdi_solve",
]
