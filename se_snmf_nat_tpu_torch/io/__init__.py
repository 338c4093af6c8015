from se_snmf_nat_tpu_torch.io.wavio import (
    read_wav_int16,
    write_wav_int16,
    write_enhanced_wav,
)
from se_snmf_nat_tpu_torch.io.basis import load_basis_mat, load_basis, save_basis

__all__ = [
    "read_wav_int16",
    "write_wav_int16",
    "write_enhanced_wav",
    "load_basis_mat",
    "load_basis",
    "save_basis",
]
