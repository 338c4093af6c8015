"""MATLAB-compatibility numerics on tensors.

The NumPy generators and rounding (``MatlabTwister``,
``matlab_v4_rand_matrix``, ``matlab_round``, ``matlab_wavwrite_quantize``)
are shared from the
JAX package's host module, which imports no JAX; only the on-device int16
write is ported here.
"""

from __future__ import annotations

import torch

from se_snmf_nat_tpu.utils.matlab_compat import (  # noqa: F401  (shared)
    MatlabTwister, matlab_round, matlab_v4_rand_matrix,
    matlab_wavwrite_quantize)


def matlab_int16_write_torch(y: torch.Tensor) -> torch.Tensor:
    """MATLAB ``fwrite(fid, y, 'int16')`` on the device: round half away
    from zero, saturate, int16.  ``y + 0.5`` and ``floor`` are exact over the
    int16 range in f32, so this equals the host chain bit for bit."""
    r = torch.sign(y) * torch.floor(torch.abs(y) + 0.5)
    return torch.clamp(r, -32768, 32767).to(torch.int16)
