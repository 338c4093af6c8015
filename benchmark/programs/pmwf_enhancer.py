"""The program under test for a PMWF configuration: the port's
``PmwfEnhancer``, with the configuration file's ``signal`` section laid
over the program's default configuration, its ``pmwf`` section as the
beamformer's parameters and its ``precision`` as the enhancer's dtype."""

from __future__ import annotations

import dataclasses


def build(cell):
    import torch
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.multichannel.pmwf import (
        PmwfEnhancer, PmwfParams)
    cfg = default_config()
    cfg = dataclasses.replace(cfg, signal=dataclasses.replace(
        cfg.signal, **cell.params["signal"]))
    prec = cell.config["precision"]
    enh = PmwfEnhancer(cfg, PmwfParams(**cell.params["pmwf"]),
                       dtype=getattr(torch, prec["dtype"]),
                       device=cell.device)
    if torch.backends.cuda.matmul.allow_tf32 != prec["tf32"]:
        raise ValueError("the program's TF32 setting is not the one the "
                         "configuration states")
    return enh
