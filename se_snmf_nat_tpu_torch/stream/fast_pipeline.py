"""Fast execution plan for non-adaptive configurations (port of
``se_snmf_nat_tpu.stream.fast_pipeline``).

With a fixed noise dictionary (``adapt_train_n=False``: the SNMF baseline,
Exemplar and Techwin-SNMF presets) every frame's activation solve is
independent: same dictionary, same seeded start, its own stop.  So over a
batch of lanes the plan is

  1. analysis of every frame of every lane (and the Mel projection in Mel
     mode);
  2. ONE H-solve over all B*T frames as columns (kernel
     ``mu_h_solve_columns``), per-column stops, the same values as the
     reference's one solve per lane;
  3. the reconstructions as matrix products;
  4. the block-sparsity statistic Q of all frames in one banded-product
     pass (causal windows: no frame reads another's result; with
     blk_gap < 3 the recurrence over a frame's centers is one more product,
     see ``enhance/blk_sparse.py``);
  5. the gain pass: Wiener has no recurrence in its output (the noise-PSD
     recursion feeds only MMSE) and runs over all frames at once; MMSE
     carries ``xm_tilde`` from frame to frame and loops over the frames,
     vectorised over lanes and bins;
  6. synthesis and overlap-add.

Frames past a lane's end (bucket padding, silent lanes) are solved like any
other and sliced off by the caller: no real frame reads them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.dsp.mel import mel_matrix
from se_snmf_nat_tpu_torch.dsp.stft import (
    analysis_frames, dft_matrices_stacked, overlap_add, synthesis_frames)
from se_snmf_nat_tpu_torch.enhance.blk_sparse import (
    make_block_sparsity_q_block, noise_bias, snr_column, wiener_gain)
from se_snmf_nat_tpu_torch.kernels.mu import mu_h_solve_columns
from se_snmf_nat_tpu_torch.nmf.solver import SnmfParams, snmf_h_solve_columns
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_v4_rand_matrix

H_SOLVE_FLR = 1e-9    # the solver's floor in the reference plan


def supports_fast_plan(cfg: PipelineConfig) -> bool:
    """The reference's predicate: fixed dictionaries, no per-frame basis
    co-updates, no splicing, one-frame separation blocks."""
    return (not cfg.adapt.adapt_train_n
            and not cfg.sep.basis_update_n
            and not cfg.sep.basis_update_e
            and cfg.sep.splice == 0 and cfg.sep.blk_len_sep == 1)


class FastRun(nn.Module):
    """``run(frames (B, T, L), win (L,)) -> y (B, S)``: the whole-utterance
    non-adaptive plan over B lanes.  ``h_solver`` says ``"kernel"``
    (float32, beta=1) or ``"plain"``: any other dtype, since the kernel is
    float32 only, and a beta other than 1, since it is KL only; the plain
    solve then takes the config's beta, as the reference's does."""

    def __init__(self, cfg: PipelineConfig, b1_x, b1_d, b2_x, b2_d,
                 device=None, dtype=torch.float32, dft_matmul: bool = False):
        super().__init__()
        if not supports_fast_plan(cfg):
            raise ValueError("config requires the scan plan")
        device = resolve_device(device)
        s, sep = cfg.signal, cfg.sep
        self.cfg = cfg
        self.dft_matmul = dft_matmul
        self.beta = cfg.nmf.beta
        self.h_solver = ("kernel" if dtype == torch.float32
                         and self.beta == 1.0 else "plain")
        self.mel_mode = sep.b_sep_mode == "Mel"

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        self.register_buffer("w_sep", torch.cat([t(b1_x), t(b1_d)], dim=1))
        # reconstruction dictionaries: the separation bases, or the DFT
        # bases in Mel mode without the mel->DFT conversion
        rec = (b2_x, b2_d) if self.mel_mode and not sep.mel_conv \
            else (b1_x, b1_d)
        self.register_buffer("bx_rec", t(rec[0]))
        self.register_buffer("bd_rec", t(rec[1]))
        self.register_buffer("h0_col", t(matlab_v4_rand_matrix(
            sep.r_x + sep.r_d, 1, cfg.nmf.random_seed)))
        self.register_buffer("melmat", t(mel_matrix(
            s.fs, s.f_order, s.fftlength, 1.0, s.fs / 2).T)
            if self.mel_mode else None)
        cs, cisi = dft_matrices_stacked(s.framelength, s.fftlength)
        self.register_buffer("cs", t(cs))
        self.register_buffer("cisi", t(cisi))
        self._q_fns = {}          # frame count -> Q of a whole utterance

    def _q_fn(self, t: int, like: torch.Tensor):
        if t not in self._q_fns:
            s, blk = self.cfg.signal, self.cfg.blk
            self._q_fns[t] = make_block_sparsity_q_block(
                t, n_bins=s.n_bins, p_len_k=blk.p_len_k, p_len_l=blk.p_len_l,
                dc_bin=s.dc_bin, gap=blk.blk_gap, alpha_p=blk.alpha_p,
                device=like.device, dtype=like.dtype)
        return self._q_fns[t]

    def forward(self, frames: torch.Tensor, win: torch.Tensor):
        cfg = self.cfg
        s, sep, ad, en, blk = (cfg.signal, cfg.sep, cfg.adapt, cfg.enhance,
                               cfg.blk)
        r_x, r_d = sep.r_x, sep.r_d
        flr = s.nonzerofloor
        mag, phase = analysis_frames(
            frames, win, s.fftlength, s.pow, s.dc_bin, flr, s.preemph,
            dft_matmul=self.dft_matmul, cs=self.cs)          # (B, T, F)
        n_lanes, t, _ = mag.shape
        if self.mel_mode:
            ym_mel = torch.matmul(mag, self.melmat.T)       # (B, T, F_mel)
            vn = torch.sqrt(torch.sum(ym_mel * ym_mel, dim=-1, keepdim=True))
            tn = torch.sqrt(torch.sum(mag * mag, dim=-1, keepdim=True))
            y_sep = (ym_mel / vn + 1e-9) * tn
        else:
            y_sep = mag
        # ONE activation solve over every frame of every lane: the (N, F)
        # frame-major spectra go in as the (F, N) view
        v_sep = y_sep.reshape(n_lanes * t, -1).T
        if self.h_solver == "kernel":
            h, _ = mu_h_solve_columns(
                v_sep, self.w_sep, self.h0_col, cfg.nmf.max_iter,
                cfg.nmf.conv_eps, float(cfg.nmf.sparsity), H_SOLVE_FLR)
        else:
            h = snmf_h_solve_columns(
                v_sep, self.w_sep, self.h0_col.expand(-1, v_sep.shape[-1]),
                SnmfParams(self.beta, float(cfg.nmf.sparsity),
                           cfg.nmf.max_iter, cfg.nmf.conv_eps,
                           H_SOLVE_FLR)).h                    # (R, B*T)
        a = h.T.reshape(n_lanes, t, -1)                      # (B, T, R)
        xm = torch.matmul(a[..., :r_x], self.bx_rec.T)
        dm = torch.matmul(a[..., r_x:], self.bd_rec.T)
        ym_dft = mag
        if self.mel_mode and sep.mel_conv:
            xm = torch.matmul(xm, self.melmat)
            dm = torch.matmul(dm, self.melmat)
            ym_dft = torch.matmul(y_sep, self.melmat)
        n_init = ad.init_n_len             # frames l <= init_n_len: gain flr
        if en.method == "Wiener":
            gain = torch.clamp(wiener_gain(xm, dm), max=1.0)
            gain[:, :n_init] = flr
            xm_tilde = gain * mag
        else:
            if blk.enabled:
                q, _ = self._q_fn(t, mag)(
                    snr_column(xm, dm, flr),
                    mag.new_zeros((n_lanes, s.n_bins, blk.p_len_l)),
                    np.arange(1, t + 1),
                    torch.full((n_lanes,), t, device=mag.device))
                x_in = (1 - en.alpha_eta) * xm * q
            else:
                x_in = (1 - en.alpha_eta) * xm
            a_d_mag = torch.sum(a[..., r_x:], dim=-1) / r_d   # (B, T)
            a_x_mag = torch.sum(a[..., :r_x], dim=-1) / r_x
            beta = noise_bias(a_d_mag, a_x_mag, en.beta, en.beta_max)
            d_in = (1 - en.alpha_d) * dm * beta[..., None]
            lambda_dav = ym_dft[:, 0]
            xm_prev = torch.zeros_like(lambda_dav)
            outs = []
            for k in range(t):
                lambda_dav = en.alpha_d * lambda_dav + d_in[:, k]
                if k < n_init:
                    gain = torch.full_like(lambda_dav, flr)
                else:
                    eta = ((en.alpha_eta * xm_prev + x_in[:, k])
                           / torch.clamp(lambda_dav, min=flr))
                    eta = torch.clamp(eta, min=en.eta_floor)
                    gain = torch.clamp(eta / (eta + 1.0), max=1.0)
                xm_prev = gain * mag[:, k]
                outs.append(xm_prev)
            xm_tilde = torch.stack(outs, dim=1)
        out_frames = synthesis_frames(
            xm_tilde, phase, s.framelength, s.fftlength, win, s.pow,
            s.dc_bin_back, s.overlapscale, s.preemph,
            dft_matmul=self.dft_matmul, cisi=self.cisi)
        return overlap_add(out_frames, s.frameshift)


def make_fast_run(cfg: PipelineConfig, b1_x, b1_d, b2_x, b2_d, device=None,
                  dtype=torch.float32, dft_matmul: bool = False) -> FastRun:
    """The non-adaptive run over lanes (see ``FastRun``), on the card
    unless ``device`` names another."""
    return FastRun(cfg, b1_x, b1_d, b2_x, b2_d, device, dtype, dft_matmul)
