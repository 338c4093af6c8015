"""Device and dtype policy of the port.

The hand-written kernels target Hopper only (``sm_90a``), so a CUDA entry
point asks ``require_cuda()`` first: it raises when there is no card or the
card is not compute capability 9.0.  Every entry point runs on the card by
default (``resolve_device(None)``) and on the CPU only when the caller says
``device="cpu"``, as the tests do; there is no CPU fallback for CUDA work.
CPU tensors take the plain PyTorch versions.

Precision: the JAX package names TPU matmul precisions
(``dft_precision="high"``, ``idft_precision="default"``,
``matmul_precision="default"``).  On the card all of them mean full f32:
TF32 is switched off for both matmuls and cuDNN by ``full_f32()``, which
every entry point of the port calls.

bfloat16 has no NumPy dtype: ``host_array`` widens it to float32 (exactly)
where a result leaves the device.
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """Turn TF32 off: every f32 product on the card runs in full f32
    (the TPU precision names of the reference all map to this)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The CUDA device the kernels run on; raises if there is none or it is
    not an sm_90 (Hopper) card.  Counterpart of the reference's
    ``kernels.mu_pallas.pallas_available``."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port's kernels need "
                           "an NVIDIA Hopper (sm_90) card")
    major, minor = torch.cuda.get_device_capability(0)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a; device 0 is "
                           f"sm_{major}{minor} "
                           f"({torch.cuda.get_device_name(0)})")
    full_f32()
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: the card (``require_cuda()``, which
    raises without one) unless the caller names a device; the CPU only on
    ``device="cpu"``."""
    if device is None:
        return require_cuda()
    return torch.device(device)


def host_array(t: torch.Tensor):
    """A tensor as a NumPy array on the host; bfloat16, which NumPy lacks,
    is widened to float32 first (every bfloat16 value is a float32 one)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
