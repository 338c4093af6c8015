"""Variational-Bayes NMF core for the Mohammadiha TASLP-2013 baseline, on
tensors.  Counterpart of the reference package's ``bnmf/vb.py``.

The reference dispatches its third algorithm, BNMF, to an external ``@NMF``
class that is absent from its own repository (proc_BNMF_nmoh.m:3 adds
src/BNMF_nmoh/, which does not exist), so this is the reference package's
fresh implementation of the underlying inference (Cemgil 2009, "Bayesian
inference for nonnegative matrix factorisation models"; Mohammadiha /
Smaragdis / Leijon TASLP 2013 build their enhancer on it).

Model (KL/Poisson compound):
    X_ft = sum_k Z_fkt,   Z_fkt ~ Po(W_fk H_kt)
    W_fk ~ Gamma(shape a0_W, scale b0_W/a0_W)   (mean b0_W)
    H_kt ~ Gamma(shape a0_H, scale b0_H/a0_H)

Variational posteriors are Gamma in shape/scale form, q(W_fk) =
Gamma(aW, sW), q(H_kt) = Gamma(aH, sH).  With LW = exp(psi(aW))*sW
(= exp E[log W]) and EW = aW*sW (posterior mean), one block update is

    Lam  = LW @ LH
    SH   = LH * (LW^T (X / Lam))        # sum_f E[Z_fkt]
    aH   = a0_H + SH
    sH   = 1 / (a0_H/b0_H + sum_f EW)   # rate accumulates basis mass

and symmetrically for W with SW = LW * ((X/Lam) @ LH^T) and the sum_t EH
rate.  Alternating the H and W blocks is coordinate ascent on the ELBO, so
the bound does not decrease.

Every update is two products (``torch.matmul`` in full float32: TF32 is off)
and elementwise work on (F, K) / (K, T) panels, iterated by a Python loop
with fixed trip counts.  A posterior's exp(E[log theta]) is computed once
and handed to the blocks that read it (the reference recomputes it in each:
two digammas a trip instead of four, the same values).  No kernel of the
port computes any of this.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from se_snmf_nat_tpu_torch.utils.special import digamma

_FLR = 1e-30


class GammaPost(NamedTuple):
    """Gamma posterior in shape/scale form (elementwise tensors)."""
    shape: torch.Tensor
    scale: torch.Tensor

    @property
    def mean(self):
        return self.shape * self.scale

    def explog(self):
        """exp(E[log theta]) = exp(psi(shape)) * scale."""
        return torch.exp(digamma(self.shape)) * self.scale


def init_train(x: np.ndarray, k: int, seed: int = 0):
    """Deterministic host-side initialization for vb_train.

    Prior means are set from the data scale so E[Lam] matches mean(X)
    (b0_W = 1, b0_H = mean(X)/k); the posterior means start at the prior
    means perturbed by seeded uniform noise for symmetry breaking (the
    reference class's init is unrecoverable — documented deviation).
    Returns (w0, h0, b0_w, b0_h) as float64 numpy arrays.
    """
    f, t = x.shape
    rng = np.random.RandomState(seed)
    b0_w = 1.0
    b0_h = max(float(np.mean(x)), 1e-6) / k
    w0 = b0_w * (0.5 + rng.rand(f, k))
    h0 = b0_h * (0.5 + rng.rand(k, t))
    return w0, h0, b0_w, b0_h


def _h_block(x, lw, lh, a0_h, scale):
    """One H block update given fixed W statistics.  ``lh`` is exp(E[log
    H]) of the current posterior (its caller has it already: the reference
    recomputes it here, with the same value); ``scale`` is the posterior
    scale 1/(a0_H/b0_H + sum_f E[W]), which does not depend on H (the
    reference recomputes it every block, with the same value)."""
    lam = torch.clamp_min(lw @ lh, _FLR)
    sh = lh * (lw.T @ (x / lam))
    shape = torch.clamp_min(a0_h + sh, 1e-12)
    return GammaPost(shape, scale.expand(shape.shape))


def _h_scale(inv_b0_rate, ew_colsum):
    """The H posterior's scale 1/(a0_H/b0_H + sum_f E[W]); ``ew_colsum`` is
    sum_f E[W] per component, shape (k, 1)."""
    return 1.0 / (inv_b0_rate + ew_colsum)


def _w_block(x, lw, lh, eh_rowsum, a0_w, inv_b0_rate):
    """One W block update given fixed H statistics; ``lw`` is exp(E[log
    W]) of the current posterior, ``eh_rowsum`` is sum_t E[H] per
    component, shape (1, k)."""
    lam = torch.clamp_min(lw @ lh, _FLR)
    sw = lw * ((x / lam) @ lh.T)
    shape = torch.clamp_min(a0_w + sw, 1e-12)
    scale = (1.0 / (inv_b0_rate + eh_rowsum)).expand(shape.shape)
    return GammaPost(shape, scale)


def _gamma_kl(q: GammaPost, shape0, mean0):
    """KL(q || Gamma(shape0, mean0/shape0)), summed over elements."""
    shape0 = torch.as_tensor(shape0, dtype=q.shape.dtype,
                             device=q.shape.device)
    scale0 = mean0 / shape0
    t = ((q.shape - shape0) * digamma(q.shape)
         - torch.lgamma(q.shape) + torch.lgamma(shape0)
         + shape0 * (torch.log(scale0) - torch.log(q.scale))
         + q.shape * (q.scale - scale0) / scale0)
    return torch.sum(t)


def elbo(x, w: GammaPost, h: GammaPost, a0_w, b0_w, a0_h, b0_h):
    """Variational lower bound (up to the constant -sum log(x!), which is
    omitted: it does not depend on the posteriors)."""
    lw, lh = w.explog(), h.explog()
    lam = torch.clamp_min(lw @ lh, _FLR)
    pois = torch.sum(x * torch.log(lam) - w.mean @ h.mean)
    return (pois - _gamma_kl(w, a0_w, b0_w) - _gamma_kl(h, a0_h, b0_h))


def vb_train(x: torch.Tensor, w0: torch.Tensor, h0: torch.Tensor,
             b0_w, b0_h, a_w: float = 1.0, a_h: float = 1.0,
             n_iter: int = 100, trace_bound: bool = False):
    """Full VB training of both factors on a spectrogram ``x`` (F, T), on
    the device of ``x``.

    Posterior means start at (w0, h0) with unit-shape pseudo-posteriors.
    Returns (w_post, h_post, bound_trace) — bound_trace is zeros unless
    ``trace_bound`` (the bound costs two extra products per iteration).
    """
    x = torch.clamp_min(x, _FLR)
    w = GammaPost(torch.full_like(w0, a_w), w0 / a_w)
    h = GammaPost(torch.full_like(h0, a_h), h0 / a_h)
    rw = a_w / b0_w
    rh = a_h / b0_h
    trace = torch.zeros(n_iter, dtype=x.dtype, device=x.device)
    lh = h.explog()
    for i in range(n_iter):
        lw = w.explog()
        h = _h_block(x, lw, lh, a_h,
                     _h_scale(rh, torch.sum(w.mean, 0)[:, None]))
        lh = h.explog()
        w = _w_block(x, lw, lh, torch.sum(h.mean, 1)[None, :], a_w, rw)
        if trace_bound:
            trace[i] = elbo(x, w, h, a_w, b0_w, a_h, b0_h)
    return w, h, trace


def clamp_min_shape(post: GammaPost, min_shape: float) -> GammaPost:
    """Raise the posterior shape to >= min_shape at constant mean — the
    reference's adjust_ShapeparamBasis(200) (proc_BNMF_nmoh.m:104):
    reduces posterior variance of the online noise basis so single frames
    cannot swing it."""
    mean = post.mean
    shape = torch.clamp_min(post.shape, min_shape)
    return GammaPost(shape, mean / shape)


def h_prior(u: torch.Tensor, phi: torch.Tensor):
    """The activations' start posterior and prior rate from prior means
    ``u`` (K, T) and prior shapes ``phi`` (K, 1): phi=0 is the improper
    vague prior the wrapper sets for speech (UserData [0 a_noise],
    proc_BNMF_nmoh.m:110), under which shape = sum E[Z] and the prior mean
    drops out; phi=a_noise pins noise activations near their smoothed
    history (TASLP 2013 §III.C).  Returns (start posterior, prior rate)."""
    inv_rate = torch.where(phi > 0.0, phi / torch.clamp_min(u, _FLR), 0.0)
    h = GammaPost(torch.clamp_min(phi, 1.0) * torch.ones_like(u),
                  torch.clamp_min(u, _FLR) / torch.clamp_min(phi, 1.0))
    return h, inv_rate


def vb_h_infer(y: torch.Tensor, w: GammaPost, u: torch.Tensor,
               phi: torch.Tensor, n_iter: int = 25) -> GammaPost:
    """Activation inference with the basis posterior FIXED.

    y: (F, T) columns to explain (T may be 1 for a single frame).
    u: (K, T) prior means; phi: (K, 1) prior shapes (see ``h_prior``).
    """
    y = torch.clamp_min(y, _FLR)
    lw = w.explog()
    h, inv_rate = h_prior(u, phi)
    scale = _h_scale(inv_rate, torch.sum(w.mean, 0)[:, None])
    for _ in range(n_iter):
        h = _h_block(y, lw, h.explog(), phi, scale)
    return h
