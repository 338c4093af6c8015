"""The block plan's per-frame gain scan, with its plain PyTorch version.

* ``gain_scan_lanes`` (``csrc/gain_scan.cu``, G) replaces no TPU kernel: it
  is the counterpart of the XLA-fused ``lax.scan`` of ``frame_step`` in
  ``se_snmf_nat_tpu/stream/block_adaptive.py`` (the scan at :358 over
  :259-334), which eager PyTorch runs as ~35 launches a frame.  One launch
  walks a block's K frames: one thread a (lane, bin), the carries in
  registers, the lane's trigger recurrence computed beside them.  Bound:
  bytes (five (B, K, F) inputs read, two written).
* ``gain_scan_plain`` is the loop the block step ran before, moved here
  without a change of arithmetic.  The kernel computes it op for op in
  the same float32 rounding, so on the card the two give the same bits.

The wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  It counts its launches
(``.launches``) as the MU wrappers do (``kernels.mu.count_launch``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from se_snmf_nat_tpu_torch.enhance.blk_sparse import noise_bias, wiener_gain
from se_snmf_nat_tpu_torch.kernels.mu import (
    _check, _check_flag, count_launch)


class GainConsts(NamedTuple):
    """The config's constants of the gain scan."""
    wiener: bool
    alpha_d: float
    alpha_eta: float
    eta_floor: float
    beta: float
    beta_max: float
    flr: float
    init_n_len: int
    dc_bin: int
    update_period: int
    adapt_train_n: bool


def gain_consts(cfg) -> GainConsts:
    """The gain scan's constants of a ``PipelineConfig``."""
    en, ad = cfg.enhance, cfg.adapt
    return GainConsts(en.method == "Wiener", en.alpha_d, en.alpha_eta,
                      en.eta_floor, en.beta, en.beta_max,
                      cfg.signal.nonzerofloor, ad.init_n_len,
                      cfg.signal.dc_bin, ad.update_period,
                      bool(ad.adapt_train_n))


class GainScan(NamedTuple):
    """What a block's gain scan gives: the enhanced spectra of its frames
    (B, K, F), zero on padding frames; the ring candidates (B, F, K); the
    triggers (B, K); the carries after the block (lambda_dav and the last
    enhanced spectrum (B, F), the refit counter (B,) int32); whether a frame
    scheduled a refit, and the gate statistics of the last one that did
    (B,)."""
    xm_tilde_seq: torch.Tensor
    d_ref_seq: torch.Tensor
    trig_seq: torch.Tensor
    lambda_dav: torch.Tensor
    xm_tilde: torch.Tensor
    update_switch: torch.Tensor
    any_refit: torch.Tensor
    qctl_last: torch.Tensor
    ax_last: torch.Tensor


def gain_scan_plain(mag_blk, ym_dft_blk, xm, dm, q_blk, a_d_mag, a_x_mag,
                    qc_blk, ok_blk, ls, lambda_dav, xm_tilde, update_switch,
                    adapt_on, c: GainConsts) -> GainScan:
    """Plain version of ``gain_scan_lanes``: a loop over the K frames,
    vectorised over lanes and bins.

    mag_blk, ym_dft_blk (the l == 1 seed of the noise PSD), xm, dm, q_blk
    (B, K, F); a_d_mag, a_x_mag, qc_blk (B, K) float, ok_blk (B, K) bool;
    ``ls`` the block's 1-based frame numbers, an integer tensor (K,) shared
    by every lane or (B, K); the carried lambda_dav, xm_tilde (B, F),
    update_switch (B,) int32 and adapt_on (B,) bool."""
    flr = c.flr
    n_lanes, k_block, _ = mag_blk.shape
    lambda_dav_c, xm_tilde_prev = lambda_dav, xm_tilde
    switch = update_switch
    any_refit = torch.zeros((n_lanes,), dtype=torch.bool,
                            device=mag_blk.device)
    qctl_last = torch.zeros((n_lanes,), dtype=mag_blk.dtype,
                            device=mag_blk.device)
    ax_last = torch.full((n_lanes,), float(flr), dtype=mag_blk.dtype,
                         device=mag_blk.device)
    gate = adapt_on if c.adapt_train_n else torch.zeros_like(adapt_on)
    outs, d_refs, trigs = [], [], []
    for k in range(k_block):
        l = ls[..., k].reshape(-1)     # this frame's numbers, (1,) or (B,)
        ym, xm_hat, dm_hat = mag_blk[:, k], xm[:, k], dm[:, k]
        q, q_control = q_blk[:, k], qc_blk[:, k]
        ad_mag, ax_mag = a_d_mag[:, k], a_x_mag[:, k]
        ok = ok_blk[:, k]
        lam = torch.where((l == 1)[:, None], ym_dft_blk[:, k], lambda_dav_c)
        beta = noise_bias(ad_mag, ax_mag, c.beta, c.beta_max)
        lam = c.alpha_d * lam + (1 - c.alpha_d) * dm_hat * beta[:, None]
        if c.wiener:
            gain = wiener_gain(xm_hat, dm_hat)
        else:
            eta = (c.alpha_eta * xm_tilde_prev
                   + (1 - c.alpha_eta) * xm_hat * q) \
                / torch.clamp(lam, min=flr)
            eta = torch.clamp(eta, min=c.eta_floor)
            gain = eta / (eta + 1.0)
        gain = torch.clamp(gain, max=1.0)
        in_init = l <= c.init_n_len
        gain = torch.where(in_init[:, None], torch.full_like(gain, flr),
                           gain)
        ax_mag = torch.where(in_init, torch.full_like(ax_mag, flr), ax_mag)
        xm_t = gain * ym
        trig = gate & (q_control * ad_mag > ax_mag) & ok
        m_ref = 1.0 - gain                 # a tensor of its own
        m_ref[:, : c.dc_bin] = flr
        d_ref = torch.where(in_init[:, None], ym, ym * m_ref)
        do_solve = trig & (switch == c.update_period)
        switch_new = torch.where(
            trig, torch.where(do_solve, torch.ones_like(switch),
                              switch + 1), switch)
        qctl_last = torch.where(do_solve, q_control, qctl_last)
        ax_last = torch.where(do_solve, ax_mag, ax_last)
        okc = ok[:, None]
        outs.append(torch.where(okc, xm_t, torch.zeros_like(xm_t)))
        d_refs.append(d_ref)
        trigs.append(trig)
        lambda_dav_c = torch.where(okc, lam, lambda_dav_c)
        xm_tilde_prev = torch.where(okc, xm_t, xm_tilde_prev)
        switch = torch.where(ok, switch_new, switch)
        any_refit = any_refit | do_solve
    return GainScan(torch.stack(outs, dim=1), torch.stack(d_refs, dim=-1),
                    torch.stack(trigs, dim=1), lambda_dav_c, xm_tilde_prev,
                    switch.to(torch.int32), any_refit, qctl_last, ax_last)


def gain_scan_lanes(mag_blk, ym_dft_blk, xm, dm, q_blk, a_d_mag, a_x_mag,
                    qc_blk, ok_blk, ls, lambda_dav, xm_tilde, update_switch,
                    adapt_on, c: GainConsts) -> GainScan:
    """The gain scan of one block over B lanes: arguments and results as
    ``gain_scan_plain`` (float32 on the card).  On the card ``d_ref_seq``
    is the (B, F, K) view of a frame-major tensor."""
    if mag_blk.device.type == "cpu":
        return gain_scan_plain(mag_blk, ym_dft_blk, xm, dm, q_blk, a_d_mag,
                               a_x_mag, qc_blk, ok_blk, ls, lambda_dav,
                               xm_tilde, update_switch, adapt_on, c)
    if mag_blk.device.type != "cuda":
        raise ValueError(f"unsupported device {mag_blk.device}")
    from se_snmf_nat_tpu_torch.kernels.build import load
    b, k, f = mag_blk.shape
    dev = mag_blk.device
    blk = [t.contiguous() for t in (mag_blk, ym_dft_blk, xm, dm, q_blk)]
    for name, t in zip(("mag_blk", "ym_dft_blk", "xm", "dm", "q_blk"), blk):
        _check(name, t, (b, k, f), dev)
    per_frame = [t.contiguous() for t in (a_d_mag, a_x_mag, qc_blk)]
    for name, t in zip(("a_d_mag", "a_x_mag", "qc_blk"), per_frame):
        _check(name, t, (b, k), dev)
    carries = [t.contiguous() for t in (lambda_dav, xm_tilde)]
    for name, t in zip(("lambda_dav", "xm_tilde"), carries):
        _check(name, t, (b, f), dev)
    ok = ok_blk.contiguous()
    _check_flag("ok_blk", ok, (b, k), dev)
    on = adapt_on.contiguous()
    _check_flag("adapt_on", on, (b,), dev)
    sw = update_switch.contiguous()
    if sw.device != dev or sw.dtype != torch.int32 or sw.shape != (b,):
        raise ValueError(f"update_switch must be int32 ({b},) on {dev}")
    if ls.device != dev:
        raise ValueError(f"ls must be on {dev}, got {ls.device}")
    frames = ls.to(torch.int64).expand(b, k).contiguous()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = GainScan(empty(b, k, f), empty(b, k, f), empty(b, k,
                                                         dtype=torch.bool),
                   empty(b, f), empty(b, f), empty(b, dtype=torch.int32),
                   empty(b, dtype=torch.bool), empty(b), empty(b))
    rc = load().lib.gain_scan_lanes(
        *(t.data_ptr() for t in blk), *(t.data_ptr() for t in per_frame),
        ok.data_ptr(), frames.data_ptr(), *(t.data_ptr() for t in carries),
        sw.data_ptr(), on.data_ptr(), *(t.data_ptr() for t in out),
        b, k, f, int(c.wiener), c.alpha_d, 1 - c.alpha_d, c.alpha_eta,
        1 - c.alpha_eta, c.eta_floor, c.beta, c.beta_max, c.flr,
        int(c.init_n_len), int(c.dc_bin), int(c.update_period),
        int(c.adapt_train_n), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gain_scan_lanes: CUDA launch failed with error "
                           f"{rc}")
    count_launch(gain_scan_lanes)
    return out._replace(d_ref_seq=out.d_ref_seq.transpose(1, 2))


gain_scan_lanes.launches = 0
