"""Multichannel nonnegative tensor factorization (CP/PARAFAC, KL MU) on the
card.  Counterpart of the reference package's ``multichannel/ntf.py``.

Reference: src/GIST_NTF_C.m / src/GIST_NTF.m — factorize a (C, N, M)
channel x frequency x time magnitude tensor as
X_hat[c,n,m] = sum_k C[c,k] B[n,k] A[m,k] with the spectral basis B fixed,
multiplicative KL updates on the channel loadings C (shipped config:
C_UPDATE=1, A_UPDATE=0, A=ones — GIST_NTF_C.m:4-15) and optionally on the
activations A.

Each three-operand contraction is two products (a Khatri-Rao-like
elementwise product and one matrix product, cuBLAS on the card in full f32),
and the all-ones denominators collapse to outer products of column sums, as
in the reference package.  The early stop reads the relative cost change on
the host once a trip (``conv_eps <= 0``: never stop, no read).  No kernel of
the port computes any of this: the reference computes it outside Pallas.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.utils.matlab_compat import MatlabTwister


def khatri_rao(*mats: torch.Tensor) -> torch.Tensor:
    """Columnwise Kronecker product (src/kr.m): column k of the result is
    kron(U1[:,k], U2[:,k], ...)."""
    k = mats[0].shape[1]
    x = mats[-1]
    for u in mats[-2::-1]:
        x = (u[:, None, :] * x[None, :, :]).reshape(-1, k)
    if x.shape[1] != k:
        raise ValueError("column mismatch")
    return x


class NtfResult(NamedTuple):
    c: torch.Tensor      # (C, K) channel loadings
    a: torch.Tensor      # (M, K) activations
    iters: int           # trips run
    div: torch.Tensor    # KL divergence of the final fit (scalar)
    cost: torch.Tensor   # div + sparsity * sum(C)


def default_c_init(n_ch: int, k: int) -> np.ndarray:
    """The reference's un-seeded rand(Channel, K) (GIST_NTF_C.m:13) drawn
    from MATLAB's startup Twister stream for determinism (float64)."""
    return MatlabTwister(0).rand(n_ch, k)


def cnm_product(c: torch.Tensor, b: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """einsum("ck,nk,mk->cnm") as (C*B rows) @ A^T."""
    cb = (c[:, None, :] * b[None, :, :]).reshape(-1, c.shape[1])
    return (cb @ a.T).reshape(c.shape[0], b.shape[0], a.shape[0])


def ntf_solve(s_mag, b, c0, a0, *, sparsity: float = 5.0,
              max_iter: int = 100, conv_eps: float = 1e-3,
              flr: float = 1e-9, update_c: bool = True,
              update_a: bool = False, device=None,
              dtype=torch.float32) -> NtfResult:
    """s_mag: (C, N, M) nonnegative tensor; b: (N, K) fixed basis;
    c0: (C, K); a0: (M, K) (ones in the shipped config).  Arrays or
    tensors; they are moved to ``device`` (the card unless named) in
    ``dtype``."""
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=dtype, device=device)

    s_mag, b, c, a = t(s_mag), t(b), t(c0), t(a0)

    # normalize B columns, rescale C (GIST_NTF_C.m:27-30)
    bn = torch.sqrt(torch.sum(b * b, dim=0))
    b = b / torch.where(bn > 0, bn, torch.ones_like(bn))
    c = c * bn[None, :]
    sum_b = torch.sum(b, dim=0)                       # (K,)

    def xhat_p(c, a):
        xh = torch.clamp_min(cnm_product(c, b, a), flr)
        return xh, torch.clamp_min(s_mag / xh, flr)

    def cost_of(c, xh):
        div = torch.sum(s_mag * torch.log(s_mag / xh) - s_mag + xh)
        return div, div + torch.sum(sparsity * c)

    last_cost = None
    it = 0
    while it < max_iter:
        if update_a:
            _, pt = xhat_p(c, a)
            cb = c[:, None, :] * b[None, :, :]           # (C, N, K)
            pcb = torch.clamp_min(
                pt.reshape(-1, pt.shape[2]).T @ cb.reshape(-1, b.shape[1]),
                flr)
            ocb = torch.clamp_min(
                (torch.sum(c, dim=0) * sum_b)[None, :].expand_as(a), flr)
            a = torch.clamp_min(a * pcb / (ocb + sparsity), flr)
        if update_c:
            _, pt = xhat_p(c, a)
            pba = torch.clamp_min(
                torch.sum((pt @ a) * b[None, :, :], dim=1), flr)
            oba = torch.clamp_min(
                (sum_b * torch.sum(a, dim=0))[None, :].expand_as(c), flr)
            c = torch.clamp_min(c * pba / (oba + sparsity), flr)
        xh, _ = xhat_p(c, a)
        _, cost = cost_of(c, xh)
        done = (conv_eps > 0 and it > 0 and bool(
            torch.abs(cost - last_cost) / torch.abs(last_cost) < conv_eps))
        it += 1
        last_cost = cost
        if done:
            break
    xh, _ = xhat_p(c, a)
    div, cost = cost_of(c, xh)
    return NtfResult(c=c, a=a, iters=it, div=div, cost=cost)


def ten2mat(t: torch.Tensor) -> torch.Tensor:
    """(n, r, h) tensor -> (n, r*h) frontal-slice concatenation
    (src/ten2mat.m: columns of slice k occupy block k)."""
    n, r, h = t.shape
    return torch.permute(t, (0, 2, 1)).reshape(n, r * h)
