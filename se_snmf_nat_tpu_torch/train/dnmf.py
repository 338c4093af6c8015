"""Discriminative NMF dictionary refit (Weninger et al., Interspeech 2014),
on the card (port of ``se_snmf_nat_tpu.train.dnmf``).

Reference: run_basis_DNMF.m / run_basis_DNMF_Mel.m.  Given parallel clean
speech x and noise d, form the mixture y = x + d and:

  Eq. (6): infer activations A_hat on |Y|^pow with the full dictionary B
           held fixed (H-only solve);
  Eq. (7): refit B_x on |X|^pow and B_d on |D|^pow with the corresponding
           activation blocks held fixed (W-only solves).

Both domains share the code; the mel variant projects each spectrogram
through the filterbank first (run_basis_DNMF_Mel.m:26-69).  All three solves
run through ``nmf.solver.snmf_solve``.  Eq. (6) is not the fast plan's
kernel's function: that kernel freezes each column at its own relative
stop, where this solve stops the whole matrix on one summed cost.
"""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.device import host_array, resolve_device
from se_snmf_nat_tpu_torch.nmf.solver import snmf_solve
from se_snmf_nat_tpu_torch.train.basis import snmf_params
from se_snmf_nat_tpu_torch.train.features import training_features
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_v4_rand_matrix


def dnmf_refit(x: np.ndarray, d: np.ndarray, b: np.ndarray,
               cfg: PipelineConfig, *, domain: str = "DFT",
               dtype=torch.float32, device=None) -> np.ndarray:
    """Return the refit dictionary [B_x_hat, B_d_hat].

    x, d: time-domain int16-scale signals (length-matched by truncation,
    run_basis_DNMF.m:5-10);  b: (F, R_x+R_d) current dictionary in the
    chosen domain;  domain: 'DFT' or 'Mel'.  The solves run on ``device``
    (the card unless named) in ``dtype``."""
    device = resolve_device(device)
    n = min(len(x), len(d))
    x, d = np.asarray(x, np.float64)[:n], np.asarray(d, np.float64)[:n]
    y = x + d

    def feat(sig):
        f = training_features(sig, cfg)
        return f.tf_mel if domain == "Mel" else f.tf_mag

    vx, vd, vy = feat(x), feat(d), feat(y)
    r_x, r_d = cfg.sep.r_x, cfg.sep.r_d
    r = r_x + r_d
    if b.shape[1] != r:
        raise ValueError(f"dictionary has {b.shape[1]} cols, expected {r}")
    params = snmf_params(cfg)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=device)  # noqa
    zeros = lambda k: torch.zeros(k, dtype=torch.bool, device=device)  # noqa

    # Eq. (6): H-solve on the mixture, full dictionary fixed
    h0 = matlab_v4_rand_matrix(r, vy.shape[1], cfg.nmf.random_seed)
    a_hat = snmf_solve(t(vy), t(b), t(h0), zeros(r), ones(r), params,
                       update_w=False, update_h=True).h

    # Eq. (7): W-solves with the inferred activations fixed
    def w_solve(v, w0, h_init):
        rr = w0.shape[1]
        return host_array(snmf_solve(t(v), t(w0), h_init, ones(rr),
                                     zeros(rr), params, update_w=True,
                                     update_h=False).w)

    b_x = w_solve(vx, b[:, :r_x], a_hat[:r_x])
    b_d = w_solve(vd, b[:, r_x:], a_hat[r_x:])
    return np.concatenate([b_x, b_d], axis=1)
