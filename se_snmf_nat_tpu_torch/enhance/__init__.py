from se_snmf_nat_tpu_torch.enhance.blk_sparse import block_sparsity_q
from se_snmf_nat_tpu_torch.enhance.state import EngineState, init_engine_state
from se_snmf_nat_tpu_torch.enhance.engine import make_engine
from se_snmf_nat_tpu_torch.enhance.imcra import (
    ImcraState, OmlsaEnhancer, make_imcra_step)
from se_snmf_nat_tpu_torch.enhance.ms import MmseEnhancer, MsStreamState

__all__ = [
    "block_sparsity_q",
    "EngineState",
    "init_engine_state",
    "make_engine",
    "OmlsaEnhancer",
    "ImcraState",
    "make_imcra_step",
    "MmseEnhancer",
    "MsStreamState",
]
