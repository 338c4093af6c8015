"""The program under test for an SNMF-NAT configuration: the port's
``SnmfEnhancer``, with the configuration file's ``algorithm`` sections laid
over the program's default configuration, its ``program`` section as the
enhancer's options, its ``precision`` as the enhancer's dtype, and the
configuration's dictionaries."""

from __future__ import annotations

import dataclasses


def build(cell):
    import torch
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
    cfg = default_config()
    for sec, values in cell.params.items():
        have = getattr(cfg, sec)
        kw = {k: tuple(v) if isinstance(getattr(have, k), tuple) else v
              for k, v in values.items()}
        cfg = dataclasses.replace(cfg, **{sec: dataclasses.replace(have,
                                                                   **kw)})
    prec = cell.config["precision"]
    bx, bd = cell.bases
    enh = SnmfEnhancer(cfg, bx, bd, bx, bd, device=cell.device,
                       dtype=getattr(torch, prec["dtype"]),
                       **cell.config["program"])
    if torch.backends.cuda.matmul.allow_tf32 != prec["tf32"]:
        raise ValueError("the program's TF32 setting is not the one the "
                         "configuration states")
    return enh
