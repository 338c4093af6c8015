"""Special functions of the enhancement gains, on tensors.

``expint_e1``: the exponential integral E1(x) (MATLAB ``expint``), used by
the OM-LSA log-MMSE gain ``exp(0.5*expint(v))`` (proc_IMCRA.m:325,
src/MS/ssubmmse.m:168).  PyTorch has no E1; this one is double-precision
accurate on the domain the gains use (v in (0, ~40]):

  x < 1.5 : power series  E1 = -gamma - ln x + sum (-1)^{k+1} x^k / (k k!)
  x >= 1.5: modified-Lentz continued fraction
            E1 = e^-x / (x+1 - 1/(x+3 - 4/(x+5 - 9/(x+7 - ...))))

Both branches run for every element (fixed trip counts, no data-dependent
control flow) and are chosen by ``where``.  Every operation is elementwise,
so an element's value does not depend on the size of the tensor it is in:
a lane gives the same bits alone as in a batch.

``digamma`` repeats the reference's operations one for one (the float64
gates of the Bayesian NMF rely on the same sequence).
"""

from __future__ import annotations

import torch

_EULER_GAMMA = 0.5772156649015328606
_SERIES_TERMS = 39          # k = 1..39
_CF_TRIPS = 59              # k = 1..59


def expint_e1(x: torch.Tensor) -> torch.Tensor:
    """E1(x) for x > 0; +inf at 0 and garbage for x < 0."""
    if not x.is_floating_point():
        x = x.float()
    tiny = 1e-300 if x.dtype == torch.float64 else 1e-30

    # series branch (safe input: clamped away from 0); the ratios -x/k of
    # all terms in one launch, then term_k = term_{k-1} * (-x/k)
    xs = torch.clamp_min(x, tiny)
    k = torch.arange(1, _SERIES_TERMS + 1, dtype=x.dtype, device=x.device)
    ratio = torch.unsqueeze(-xs, -1) / k
    term = ratio[..., 0]
    ssum = -term
    for j in range(1, _SERIES_TERMS):
        term = term * ratio[..., j]
        ssum = ssum.sub_(term, alpha=1.0 / (j + 1))
    series = (-_EULER_GAMMA - torch.log(xs)) + ssum

    # continued-fraction branch (safe input: clamped to >= 1)
    xc = torch.clamp_min(x, 1.0)
    b0 = xc + 1.0
    f, c = b0, b0
    d = torch.zeros_like(xc)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    for j in range(1, _CF_TRIPS + 1):
        a = -float(j * j)
        b = xc + (2.0 * j + 1.0)
        d = torch.add(b, d, alpha=a).reciprocal_()
        c = torch.addcdiv(b, one, c, value=a)
        f = f * (c * d)
    cf = torch.exp(-xc) / f

    out = torch.where(x < 1.5, series, cf)
    return torch.where(x <= 0.0, torch.inf, out)


def digamma(x: torch.Tensor) -> torch.Tensor:
    """psi(x) for x > 0, the reference's operations one for one.

    Recurrence psi(x) = psi(x+1) - 1/x shifts the argument to >= 8 (eight
    unrolled where-guarded steps), then the Bernoulli asymptotic series
    through x^-12 — double-precision accurate on the shifted domain.  Used
    by the Bayesian-NMF variational updates (bnmf/vb.py), which need
    exp(E[log theta]) = exp(psi(alpha)) * scale for Gamma posteriors."""
    one = torch.ones_like(x)
    acc = torch.zeros_like(x)
    for _ in range(8):
        need = x < 8.0
        acc = acc - torch.where(need, x.reciprocal(), 0.0)
        x = x + torch.where(need, one, 0.0)
    inv = x.reciprocal()
    inv2 = inv * inv
    s = (torch.log(x) - 0.5 * inv
         - inv2 * (1.0 / 12.0
                   - inv2 * (1.0 / 120.0
                             - inv2 * (1.0 / 252.0
                                       - inv2 * (1.0 / 240.0
                                                 - inv2 * (1.0 / 132.0
                                                           - inv2 * (691.0 / 32760.0)))))))
    return s + acc


def bessel_i0_small(x: torch.Tensor, terms: int = 14) -> torch.Tensor:
    """Modified Bessel I0 by power series — double-accurate for |x| <= ~2.
    The amplitude-MMSE gain (src/MS/ssubmmse.m:181-184) only evaluates it
    on v < 0.5, well inside the series radius."""
    q = 0.25 * x * x
    term = torch.ones_like(x)
    s = torch.ones_like(x)
    for k in range(1, terms):
        term = term * q / (k * k)
        s = s + term
    return s


def bessel_i1_small(x: torch.Tensor, terms: int = 14) -> torch.Tensor:
    """Modified Bessel I1 by power series — double-accurate for |x| <= ~2."""
    q = 0.25 * x * x
    term = 0.5 * x
    s = term
    for k in range(1, terms):
        term = term * q / (k * (k + 1))
        s = s + term
    return s


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving (zero-padded to a power of two):
    elementwise adds only, so a lane's sum has the same bits whatever the
    number of lanes — ``torch.sum`` picks its thread layout from the shape
    and may not."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]
