"""The production enhancement plan on the card.

``HEADLINE_PLAN`` and ``HEADLINE_BATCH`` are imported from the reference
package (defined once there): block-adaptive SNMF-NAT, K=88-frame blocks and
bucket 88, 22 fixed H-solve trips, refit cap 22 with its early stop, the
stacked-matmul DFT with the unit phasor, f32, a batch of 64 utterances.
"""

from __future__ import annotations

import torch

from se_snmf_nat_tpu.config import default_config
from se_snmf_nat_tpu.headline import (  # noqa: F401  (shared)
    HEADLINE_BATCH, HEADLINE_PLAN)
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer


def build_headline_enhancer(cfg=None, bases=None, device=None,
                            dtype=torch.float32) -> SnmfEnhancer:
    """The headline enhancer from ``bases = (b1_x, b1_d, b2_x, b2_d)``
    (the dictionaries are passed in: the reference's .mat bases are not
    part of the repository)."""
    if bases is None:
        raise ValueError("bases=(b1_x, b1_d, b2_x, b2_d) is required")
    b1_x, b1_d, b2_x, b2_d = bases
    return SnmfEnhancer(cfg or default_config(), b1_x, b1_d, b2_x, b2_d,
                        device=device, dtype=dtype, **HEADLINE_PLAN)
