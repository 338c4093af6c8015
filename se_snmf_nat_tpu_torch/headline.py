"""The production enhancement plan on the card.

``HEADLINE_PLAN`` and ``HEADLINE_BATCH`` are written out here with the
reference package's values (``tests/test_torch_config.py`` holds them
equal): block-adaptive SNMF-NAT, K=88-frame blocks and bucket 88, 22 fixed
H-solve trips, refit cap 22 with its early stop, the stacked-matmul DFT with
the unit phasor, f32, a batch of 64 utterances.  ``dft_precision`` and
``idft_precision`` are the reference's matmul precision names; on the card
both mean full f32.
"""

from __future__ import annotations

import torch

from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer

HEADLINE_PLAN = dict(
    block_adapt=88,
    frame_bucket=88,
    block_iter_cap=22,
    block_refit_cap=22,
    block_fixed_iter=True,
    dft_matmul=True,
    dft_precision="high",
    idft_precision="default",
)
HEADLINE_BATCH = 64


def build_headline_enhancer(cfg=None, bases=None, device=None,
                            dtype=torch.float32) -> SnmfEnhancer:
    """The headline enhancer from ``bases = (b1_x, b1_d, b2_x, b2_d)``
    (the dictionaries are passed in: the reference's .mat bases are not
    part of the repository), on the card unless ``device`` names another."""
    if bases is None:
        raise ValueError("bases=(b1_x, b1_d, b2_x, b2_d) is required")
    b1_x, b1_d, b2_x, b2_d = bases
    return SnmfEnhancer(cfg or default_config(), b1_x, b1_d, b2_x, b2_d,
                        device=device, dtype=dtype, **HEADLINE_PLAN)
