"""The enhanced-output quantisation chain (the port's own copy of
``enhanced_quantize`` of the reference package's ``io.wavio``; wav file
reading and writing are not ported yet).
"""

from __future__ import annotations

import numpy as np

from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write, matlab_wavwrite_quantize)


def enhanced_quantize(samples: np.ndarray) -> np.ndarray:
    """The int16 values the reference's output chain stores: the int16
    write of the float hop samples (round half away from zero, saturate),
    then the reload divided by 32767 and wavwrite's 16-bit quantisation
    round(x * 32768)."""
    pcm = matlab_int16_write(samples)
    return matlab_wavwrite_quantize(pcm.astype(np.float64) / 32767.0)
