"""The per-frame enhancement engine over a batch of lanes (port of
``se_snmf_nat_tpu.enhance.engine``): the exact plan, one activation solve
and one gated dictionary refit per frame.

One step consumes a power-spectrum column per lane and the 1-based frame
number, carries a batched ``EngineState`` and emits the enhanced spectrum.
It is the same step for offline and streaming use.  The lane (batch)
dimension is written out where the reference used ``vmap``, so its two
nested ``lax.cond``s around the adaptation become per-lane selects:
``trigger`` gates the ring shifts and the refit counter, and
``trigger & do_solve`` is the refit kernel's per-lane ``active`` flag.

Solvers, chosen from the configuration when the engine is built (never from
a failure):

* the activation solve of one column a lane runs in ``mu_h_solve_lanes``
  (kernel K1 on the card) when the configuration is supervised and KL: with
  a single column, the solver's one stop per matrix and the kernel's stop
  per column are the same test.  A semi-supervised configuration
  (``basis_update_n/e``: W and H update together, W's update discarded) or
  another beta takes the plain ``snmf_solve``;
* the refit runs in ``mu_w_solve_lanes`` (kernel K2 on the card) for KL, in
  the plain ``snmf_solve`` for another beta.

``Engine.h_solver`` and ``Engine.w_solver`` say which (``"kernel"`` or
``"plain"``).  A dtype other than float32 takes the plain
versions too: the kernels are float32 only, and the choice is made here,
from the dtype, so no wrapper ever has to give way.  On the kernel route a
step reads no device value on the host, so frames enqueue without waiting;
the refit kernel is launched on every frame, most often with no lane active,
because only the device knows which lanes refit.  The plain solvers end
their loops early by asking the device whether any lane still runs.

The frame number ``l`` is one host integer for all lanes, or an integer
tensor with a number per lane (a serving fleet whose lanes restart their
clocks one by one): then every branch on ``l`` is a per-lane select and the
step converts no tensor to a host value.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.device import full_f32, resolve_device
from se_snmf_nat_tpu_torch.dsp.mel import mel_matrix
from se_snmf_nat_tpu_torch.enhance.blk_sparse import block_sparsity_q
from se_snmf_nat_tpu_torch.enhance.state import (
    EngineState, init_engine_state)
from se_snmf_nat_tpu_torch.kernels.mu import (
    mu_h_solve_lanes, mu_h_solve_lanes_ref, mu_w_solve_lanes,
    mu_w_solve_lanes_ref)
from se_snmf_nat_tpu_torch.nmf.solver import SnmfParams, snmf_solve
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_v4_rand_matrix

SOLVE_FLR = 1e-9     # the solvers' floor (not signal.nonzerofloor, though
#                      equal by default)


def _blocks(starts, total):
    """(lo, hi) column ranges of a class's dictionary blocks from their
    1-based starts; the last block runs to the class end."""
    starts0 = [int(v) - 1 for v in starts]
    return list(zip(starts0, starts0[1:] + [total]))


class Engine(nn.Module):
    """``step(state, ym (B, F), l) -> (state, xm_tilde (B, F))`` with ``l``
    the 1-based frame number: a host integer shared by every lane, or a
    (B,) integer tensor on the state's device with a number per lane.  Given
    a tensor, the step reads no device value on the host (no ``int()``,
    ``bool()`` or ``.item()`` of a tensor outside the plain solvers), so on
    the kernel route it can be enqueued, or captured, without a wait.  With
    ``emit_sources`` the output is ``(xm_tilde, events (B, E, F), noises
    (B, N, F))``, the per-event and per-noise reconstruction spectra of
    ``cfg.sep.event_rank`` / ``noise_rank``.

    ``b1_*``: separation-domain bases (mel or DFT, ``cfg.sep.b_sep_mode``);
    ``b2_*``: DFT reconstruction bases."""

    def __init__(self, cfg: PipelineConfig, b1_x, b1_d, b2_x, b2_d,
                 device=None, dtype=torch.float32,
                 emit_sources: bool = False):
        super().__init__()
        full_f32()
        device = resolve_device(device)
        s, sep, ad = cfg.signal, cfg.sep, cfg.adapt
        if sep.blk_len_sep != 1 or sep.splice != 0:
            raise NotImplementedError(
                "only one-frame separation blocks without splicing are "
                "defined (blk_len_sep=1, splice=0)")
        self.cfg = cfg
        self.dtype = dtype
        self.emit_sources = emit_sources
        self.mel_mode = sep.b_sep_mode == "Mel"
        r_x, r_d, r_a = sep.r_x, sep.r_d, ad.r_a

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        # the whole separation-domain noise basis seeds the initial state
        self.register_buffer("bd_sep", t(b1_d))
        self.register_buffer("bx_sep", t(b1_x))
        self.register_buffer("bd_sep_tail",
                             self.bd_sep[:, r_a:].contiguous())
        self.register_buffer("bx_dft", t(b2_x))
        self.register_buffer("bd_dft", t(b2_d))
        self.register_buffer("h0", t(matlab_v4_rand_matrix(
            r_x + r_d, 1, cfg.nmf.random_seed)))
        self.register_buffer("melmat", t(mel_matrix(
            s.fs, s.f_order, s.fftlength, 1.0, s.fs / 2).T)
            if self.mel_mode else None)

        self.params = SnmfParams(
            beta=cfg.nmf.beta, sparsity=float(cfg.nmf.sparsity),
            max_iter=cfg.nmf.max_iter, conv_eps=cfg.nmf.conv_eps,
            flr=SOLVE_FLR)
        # the separation solve's W mask; its W updates are discarded
        self.semisup = sep.basis_update_n or sep.basis_update_e
        w_mask = np.zeros(r_x + r_d, bool)
        if sep.basis_update_n:
            w_mask[r_x:] = True
        if sep.basis_update_e:
            w_mask[:r_x] = True
        self.register_buffer("w_mask_sep", torch.as_tensor(w_mask,
                                                           device=device))
        self.kl = cfg.nmf.beta == 1.0
        f32 = dtype == torch.float32
        self.h_solver = ("kernel" if self.kl and not self.semisup and f32
                         else "plain")
        self.w_solver = "kernel" if self.kl and f32 else "plain"
        self.event_blocks = _blocks(sep.event_rank, r_x)
        self.noise_blocks = _blocks(sep.noise_rank, r_d)

    def init_state(self, dtype=None, matlab_ad_blk_init: bool = True
                   ) -> EngineState:
        """One utterance's initial state, on the engine's device."""
        return init_engine_state(
            self.cfg, self.bd_sep, self.cfg.signal.n_bins, self.h0.device,
            dtype or self.dtype, matlab_ad_blk_init)

    def _activations(self, y_sep: torch.Tensor,
                     w_sep: torch.Tensor) -> torch.Tensor:
        """The H-solve of one column a lane: (B, R)."""
        p = self.params
        v = y_sep[:, :, None].contiguous()
        if self.kl and not self.semisup:
            solve = (mu_h_solve_lanes if self.h_solver == "kernel"
                     else mu_h_solve_lanes_ref)
            a, _ = solve(v, w_sep, self.h0, p.max_iter, p.conv_eps,
                         p.sparsity, p.flr)
            return a[:, :, 0]
        res = snmf_solve(v, w_sep, self.h0, self.w_mask_sep,
                         torch.ones_like(self.w_mask_sep), p,
                         update_w=self.semisup, update_h=True,
                         need_stats=False)
        return res.h[:, :, 0]

    def _refit(self, target, w0, h0a, r_up, active) -> torch.Tensor:
        """The W-only solve of the triggered head columns: (B, F_sep, R_a)."""
        p = self.params
        if self.kl:
            solve = (mu_w_solve_lanes if self.w_solver == "kernel"
                     else mu_w_solve_lanes_ref)
            w, _ = solve(target.contiguous(), w0, h0a, active, p.max_iter,
                         p.conv_eps, p.sparsity, p.flr)
            return w
        return snmf_solve(target, w0, h0a, r_up, torch.zeros_like(r_up), p,
                          update_w=True, update_h=False, active=active,
                          need_stats=False).w

    def _sources(self, w: torch.Tensor, a: torch.Tensor, blocks, to_dft):
        """Per-block reconstructions w[..., lo:hi] @ a[:, lo:hi] as a list
        of (B, F), in the reference's block order; w is one (F, r)
        dictionary or one per lane (B, F, r)."""
        out = []
        for lo, hi in blocks:
            if w.dim() == 2:
                rec = torch.matmul(a[:, lo:hi], w[:, lo:hi].T)
            else:
                rec = torch.matmul(w[..., lo:hi], a[:, lo:hi, None])[..., 0]
            out.append(to_dft(rec))
        return out

    def step(self, state: EngineState, ym: torch.Tensor, l):
        cfg = self.cfg
        s, sep, ad, en, blk = (cfg.signal, cfg.sep, cfg.adapt, cfg.enhance,
                               cfg.blk)
        r_x, r_d, r_a = sep.r_x, sep.r_d, ad.r_a
        flr = s.nonzerofloor
        per_lane = torch.is_tensor(l)
        l = l.reshape(-1) if per_lane else int(l)
        ym = ym.to(self.dtype)
        n_lanes = ym.shape[0]

        # ---- separation domain
        if self.mel_mode:
            ym_mel = torch.matmul(ym, self.melmat.T)           # (B, F_mel)
            vn = torch.sqrt(torch.sum(ym_mel * ym_mel, dim=-1, keepdim=True))
            tn = torch.sqrt(torch.sum(ym * ym, dim=-1, keepdim=True))
            y_sep = (ym_mel / vn + 1e-9) * tn
        else:
            y_sep = ym
        head = state.b_d_head
        b_sep_d = torch.cat(
            [head, self.bd_sep_tail.expand(n_lanes, -1, -1)], dim=-1)
        w_sep = torch.cat([self.bx_sep.expand(n_lanes, -1, -1), b_sep_d],
                          dim=-1)                              # (B, F_sep, R)

        # ---- activation solve
        a = self._activations(y_sep, w_sep)                    # (B, R)

        # ---- reconstructions
        if self.mel_mode and sep.mel_conv:
            def to_dft(rec):
                return torch.matmul(rec, self.melmat)
            bx_rec, bd_rec = self.bx_sep, b_sep_d
            ym_dft = torch.matmul(y_sep, self.melmat)
        else:
            def to_dft(rec):
                return rec
            # DFT mode: the adapted head doubles as the reconstruction
            # columns.  The coupled-dictionary Mel mode (no mel->DFT
            # conversion) reconstructs with the fixed DFT basis.
            bx_rec, bd_rec = self.bx_dft, self.bd_dft
            if not self.mel_mode:
                bd_rec = torch.cat(
                    [head, bd_rec[:, r_a:].expand(n_lanes, -1, -1)], dim=-1)
            ym_dft = ym
        if self.emit_sources:
            x_srcs = self._sources(bx_rec, a[:, :r_x], self.event_blocks,
                                   to_dft)
            d_srcs = self._sources(bd_rec, a[:, r_x:], self.noise_blocks,
                                   to_dft)
            xm_hat, dm_hat = sum(x_srcs), sum(d_srcs)
        else:
            xm_hat, = self._sources(bx_rec, a[:, :r_x], [(0, r_x)], to_dft)
            dm_hat, = self._sources(bd_rec, a[:, r_x:], [(0, r_d)], to_dft)

        # ---- block sparsity
        if blk.enabled:
            q, r_blk = block_sparsity_q(
                xm_hat, dm_hat, state.r_blk, l, n_bins=s.n_bins,
                p_len_k=blk.p_len_k, p_len_l=blk.p_len_l, dc_bin=s.dc_bin,
                gap=blk.blk_gap, alpha_p=blk.alpha_p, nonzerofloor=flr)
        else:
            q, r_blk = torch.ones_like(ym), state.r_blk

        # ---- adaptive noise floor + gain
        if per_lane:
            lambda_dav = torch.where((l == 1)[:, None], ym_dft,
                                     state.lambda_dav)
        else:
            lambda_dav = ym_dft if l == 1 else state.lambda_dav
        a_d_mag = torch.sum(a[:, r_x:], dim=-1) / r_d          # (B,)
        a_x_mag = torch.sum(a[:, :r_x], dim=-1) / r_x
        beta = torch.clamp(20.0 * torch.log10(a_d_mag / a_x_mag) * en.beta,
                           en.beta, en.beta_max)
        lambda_dav = (en.alpha_d * lambda_dav
                      + (1 - en.alpha_d) * dm_hat * beta[:, None])
        in_init = l <= ad.init_n_len          # bool, or (B,) per lane
        if not per_lane and in_init:
            gain = torch.full_like(ym, flr)
            a_x_mag = torch.full_like(a_x_mag, flr)
        else:
            if en.method == "Wiener":
                gain = xm_hat / (xm_hat + dm_hat)
            else:
                eta = (en.alpha_eta * state.xm_tilde
                       + (1 - en.alpha_eta) * xm_hat * q) \
                    / torch.clamp(lambda_dav, min=flr)
                eta = torch.clamp(eta, min=en.eta_floor)
                gain = eta / (eta + 1.0)
            gain = torch.clamp(gain, max=1.0)
            if per_lane:
                # both sides exist; a 0/0 of the discarded gain stays there
                gain = torch.where(in_init[:, None],
                                   torch.full_like(gain, flr), gain)
                a_x_mag = torch.where(in_init,
                                      torch.full_like(a_x_mag, flr), a_x_mag)
        xm_tilde = gain * ym

        new_state = state._replace(lambda_dav=lambda_dav, xm_tilde=xm_tilde,
                                   r_blk=r_blk)
        # ---- online noise-dictionary adaptation; state.adapt_on is the
        # runtime switch: while off no trigger fires, so the rings, the
        # counter and the dictionary stay untouched
        if ad.adapt_train_n:
            new_state = self._adapt(new_state, state, ym, a, gain, q,
                                    a_d_mag, a_x_mag, in_init)
        if self.emit_sources:
            return new_state, (xm_tilde, torch.stack(x_srcs, dim=1),
                               torch.stack(d_srcs, dim=1))
        return new_state, xm_tilde

    def _adapt(self, new_state, state, ym, a, gain, q, a_d_mag, a_x_mag,
               in_init):
        cfg = self.cfg
        s, ad = cfg.signal, cfg.adapt
        r_x, r_a = cfg.sep.r_x, ad.r_a
        flr = s.nonzerofloor
        q_control = (1.0 - torch.mean(q, dim=-1)) * ad.ar_up       # (B,)
        trigger = state.adapt_on & (q_control * a_d_mag > a_x_mag)
        # the noise reference builds from the raw DFT power spectrum
        per_lane = torch.is_tensor(in_init)
        if not per_lane and in_init:
            d_ref = ym
        else:
            m_ref = 1.0 - gain                 # a tensor of its own
            m_ref[:, : s.dc_bin] = flr
            d_ref = ym * m_ref
            if per_lane:
                d_ref = torch.where(in_init[:, None], ym, d_ref)
        lam_blk = torch.cat([state.lambda_d_blk[..., 1:], d_ref[..., None]],
                            dim=-1)
        ad_blk = torch.cat([state.ad_blk[..., 1:],
                            a[:, r_x: r_x + r_a, None]], dim=-1)
        r_up = (q_control[:, None] * torch.mean(ad_blk, dim=-1)
                > a_x_mag[:, None])                                # (B, R_a)
        do_solve = state.update_switch == ad.update_period
        refit = trigger & do_solve

        head = state.b_d_head
        target = torch.matmul(self.melmat, lam_blk) if self.mel_mode \
            else lam_blk
        upf = r_up.to(head.dtype)
        w_new = self._refit(target, head * upf[:, None, :],
                            ad_blk * upf[:, :, None], r_up, refit)
        merged = torch.where(r_up[:, None, :], w_new, head)
        perm = torch.argsort(r_up.to(torch.int32), dim=-1, stable=True)
        merged = torch.gather(merged, -1,
                              perm[:, None, :].expand(-1, head.shape[-2], -1))
        switch = state.update_switch
        switch_new = torch.where(
            trigger, torch.where(do_solve, torch.ones_like(switch),
                                 switch + 1), switch)
        trig3 = trigger[:, None, None]
        return new_state._replace(
            b_d_head=torch.where(refit[:, None, None], merged, head),
            lambda_d_blk=torch.where(trig3, lam_blk, state.lambda_d_blk),
            ad_blk=torch.where(trig3, ad_blk, state.ad_blk),
            update_switch=switch_new.to(torch.int32))

    forward = step


def make_engine(cfg: PipelineConfig, b1_x, b1_d, b2_x, b2_d, device=None,
                dtype=torch.float32, emit_sources: bool = False) -> Engine:
    """The per-frame engine (see ``Engine``), on the card unless ``device``
    names another."""
    return Engine(cfg, b1_x, b1_d, b2_x, b2_d, device, dtype, emit_sources)
