"""se_snmf_nat_tpu_torch — PyTorch/CUDA port of the sparse-NMF speech
enhancer for NVIDIA Hopper (H100, sm_90a).

The JAX package ``se_snmf_nat_tpu`` stays the reference; this package mirrors
its paths so each module has a counterpart there, and keeps its own copy of
the host-only (NumPy) modules it needs: ``config``, ``headline``'s
``HEADLINE_PLAN``, ``utils.matlab_compat`` and ``io.wavio``.  Nothing here
imports JAX or the reference package.  Entry points run on the card unless
the caller names a device (``device="cpu"`` for the CPU).

Layer map of the ported slices (the block-adaptive production plan and the
non-adaptive fast plan):
  config.py   — the typed configuration and its presets
  device.py   — CUDA/sm_90 check, the card-by-default rule and the full-f32
                (TF32 off) policy
  dsp/        — framing, analysis/synthesis transforms, overlap-add, the
                mel filterbank
  nmf/        — KL sparse-NMF solvers (the oracles of the kernels)
  kernels/    — hand-written CUDA MU-solve kernels (K1, K2 for the block
                plan, K3 for the fast plan) + their plain versions
  enhance/    — engine state, block-sparsity statistic Q
  stream/     — block-adaptive run, fast run and the ``SnmfEnhancer``
                facade (``block_adapt > 0``: block plan; ``block_adapt=0``
                on a fixed-dictionary config: fast plan)
  io/         — the enhanced-output quantisation chain
  convert.py  — config, dictionaries and state carried across from the JAX
                side
  fixtures.py — seeded synthetic bases and signals (NumPy only)
"""

__version__ = "0.1.0"
