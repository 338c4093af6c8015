"""se_snmf_nat_tpu_torch — PyTorch/CUDA port of the sparse-NMF speech
enhancer for NVIDIA Hopper (H100, sm_90a).

The JAX package ``se_snmf_nat_tpu`` stays the reference; this package mirrors
its paths so each module has a counterpart there, and keeps its own copy of
the host-only (NumPy) modules it needs: ``config``, ``headline``'s
``HEADLINE_PLAN``, ``utils.matlab_compat``, ``io.wavio``, ``io.basis``,
``dsp.splice``, ``dsp.resample``, the training data, features and k-means
of ``train``, ``metrics``, and the baselines' parameters
(``enhance.imcra_params``, ``enhance.ms_params``).  Nothing here
imports JAX or the reference package.  Entry points run on the card unless
the caller names a device (``device="cpu"`` for the CPU).

Layer map of the ported slices:
  config.py   — the typed configuration and its presets
  device.py   — CUDA/sm_90 check, the card-by-default rule and the full-f32
                (TF32 off) policy
  dsp/        — framing, analysis/synthesis transforms, overlap-add, the
                mel filterbank; the training STFT, splicing, smoothing,
                resampling
  nmf/        — sparse-NMF solvers (the oracles of the kernels, the W+H
                training solve), missing-data imputation
  kernels/    — hand-written CUDA MU-solve kernels (K1, K2 for the block
                plan, K3 for the fast plan) + their plain versions
  enhance/    — engine state, block-sparsity statistic Q; the OM-LSA/IMCRA
                and MMSE baseline enhancers (``imcra``, ``ms``)
  bnmf/       — the Bayesian-NMF baseline: VB core, online and supervised
                enhancer, streaming session
  utils/      — MATLAB numerics; the gains' special functions (E1,
                digamma, Bessel series) on tensors
  stream/     — block-adaptive run, fast run and the ``SnmfEnhancer``
                facade (``block_adapt > 0``: block plan; ``block_adapt=0``
                on a fixed-dictionary config: fast plan)
  train/      — dictionary training (sequence, features, the W+H solve
                on the card, exemplars, k-means, checkpoints) and DNMF
  io/         — wav files with the reference's quantisation, dictionary
                checkpoints (.npz, .mat)
  metrics.py  — objective quality scores (segmental SNR, STOI, ...)
  convert.py  — config, dictionaries, state and BNMF speech models carried
                across from the JAX side
  fixtures.py — seeded synthetic bases and signals (NumPy only)
"""

__version__ = "0.1.0"
