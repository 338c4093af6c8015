"""Streaming engine state (port of ``se_snmf_nat_tpu.enhance.state``).

A NamedTuple of tensors.  ``init_engine_state`` returns one utterance's
state; the batched plans carry the same fields with a leading lane
dimension (``batch_state``).  The adapted part of the noise dictionary is
held apart from its fixed tail: only the leading R_a columns are ever
refit, so the carry is (F, R_a).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    MatlabTwister, matlab_v4_rand_matrix)


class EngineState(NamedTuple):
    b_d_head: torch.Tensor      # (F_sep, R_a) adapted leading noise columns
    lambda_dav: torch.Tensor    # (F,) smoothed noise PSD
    xm_tilde: torch.Tensor      # (F,) previous enhanced spectrum
    r_blk: torch.Tensor         # (F, P_len_l) local-SNR history ring
    lambda_d_blk: torch.Tensor  # (F, m_a) noise-reference ring
    ad_blk: torch.Tensor        # (R_a, m_a) noise-activation ring
    update_switch: torch.Tensor  # int32 scalar: refit-cycle counter
    a_warm: torch.Tensor        # (R,) carried untouched by the block plan
    adapt_on: torch.Tensor      # bool scalar: runtime adaptation switch


def init_engine_state(cfg: PipelineConfig, b_d_sep, n_bins: int,
                      device=None, dtype=torch.float32,
                      matlab_ad_blk_init: bool = True) -> EngineState:
    """The reference's init_buff.m state.  b_d_sep: separation-domain noise
    basis (F, R_d); its leading R_a columns seed the adapted head.

    The state lies on the card unless ``device`` names another.

    matlab_ad_blk_init: seed the activation ring from MATLAB's startup
    Twister stream, as the reference does; else 0.5 everywhere."""
    ad = cfg.adapt
    device = resolve_device(device)
    b_d_sep = torch.as_tensor(b_d_sep, dtype=dtype, device=device)
    if matlab_ad_blk_init:
        tw = MatlabTwister(0)
        _ = tw.rand(b_d_sep.shape[1], cfg.sep.blk_len_sep)  # g.A_d (unused)
        ad_blk = tw.rand(ad.r_a, ad.m_a)
    else:
        ad_blk = np.full((ad.r_a, ad.m_a), 0.5)
    r = cfg.sep.r_x + cfg.sep.r_d
    a0 = matlab_v4_rand_matrix(r, 1, cfg.nmf.random_seed)[:, 0]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return EngineState(
        b_d_head=b_d_sep[:, : ad.r_a].clone(),
        lambda_dav=torch.zeros((n_bins,), dtype=dtype, device=device),
        xm_tilde=torch.zeros((n_bins,), dtype=dtype, device=device),
        r_blk=torch.zeros((n_bins, cfg.blk.p_len_l), dtype=dtype,
                          device=device),
        lambda_d_blk=torch.zeros((n_bins, ad.m_a), dtype=dtype,
                                 device=device),
        ad_blk=t(ad_blk),
        update_switch=torch.tensor(1, dtype=torch.int32, device=device),
        a_warm=t(a0),
        adapt_on=torch.tensor(True, device=device),
    )


def batch_state(state: EngineState, n: int) -> EngineState:
    """One state repeated over ``n`` lanes (a leading lane dimension)."""
    return EngineState(*(f.unsqueeze(0).expand((n,) + f.shape).contiguous()
                         for f in state))


def lane_state(state: EngineState, i: int) -> EngineState:
    """Lane ``i`` of a batched state."""
    return EngineState(*(f[i] for f in state))
