"""OM-LSA / IMCRA baseline enhancer on the card.

Reference: proc_IMCRA.m (Cohen 2003 "omlsa3"; the `p.NMF_algorithm='IMCRA'`
baseline of the campaign scripts, run_IMCRA.m:7-31).  Counterpart of the
reference package's ``enhance/imcra.py``:

  host:   int16 samples (or the (T, 512) stride-128 frame matrix) up
  device: batched rfft -> a Python loop over frames (IMCRA noise tracking +
          OM-LSA gain, all lanes at once) -> batched irfft -> overlap-add
          -> int16 write
  host:   the raw int16 stream (proc_IMCRA.m:360-373 — no pcm2wav rescale)

The per-frame recurrences (minima tracking S/Smin/St/Smint with Vwin=15
sub-window switching, speech-presence q/p-hat, long-term noise PSD) are the
loop's state, one row a lane; the FFTs batch outside the loop.  Gated frames
(leading zeros, silent frames, proc_IMCRA.m:145,355-359) leave a lane's state
untouched: every lane's step is computed and ``torch.where`` keeps the old
state lane by lane (a skipped silent lane's step may hold inf or NaN, which a
select drops and a product with a mask would not).

Every operation of the step is elementwise or a halving sum
(``utils.special.tree_sum``), so a lane gives the same bits alone as in a
batch.  No kernel of the port computes any of this: it is plain PyTorch
with cuFFT transforms, as the JAX package computes it outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from se_snmf_nat_tpu_torch.device import full_f32, resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import pack_samples_for_upload
from se_snmf_nat_tpu_torch.enhance.imcra_params import (
    ImcraParams, _iround, imcra_windows, matlab_hanning)
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write, matlab_int16_write_torch)
from se_snmf_nat_tpu_torch.utils.special import expint_e1, tree_sum


class ImcraState(NamedTuple):
    """The loop's state; every field has a leading lane axis B."""

    lambda_d: torch.Tensor        # (B, F) noise PSD driving the gain
    eta_2term: torch.Tensor       # (B, F) DD prior carry GH1^2*gamma
    xi: torch.Tensor              # (B, F) smoothed prior SNR
    xi_frame: torch.Tensor        # (B,)
    xi_m_db: torch.Tensor         # (B,) frame-prior peak memory
    s: torch.Tensor               # (B, F) smoothed periodogram
    st: torch.Tensor              # (B, F) minima-controlled smoothed
    smin: torch.Tensor
    smint: torch.Tensor
    smact: torch.Tensor
    smactt: torch.Tensor
    sw: torch.Tensor              # (B, F, Nwin) sub-window minima ring
    swt: torch.Tensor
    lambda_dav: torch.Tensor
    lambda_dav_long: torch.Tensor
    sy: torch.Tensor
    l_mod_lswitch: torch.Tensor   # (B,) int32
    l_fnz: torch.Tensor           # (B,) int32 first-nonzero frame counter
    fnz_flag: torch.Tensor        # (B,) bool


def _conv_same(x: torch.Tensor, kernel: list[float], w: int) -> torch.Tensor:
    """conv(b, x) central slice along the last axis (the oracle's
    np.convolve slice): 2w+1 shifted multiply-adds, elementwise."""
    n = x.shape[-1]
    xp = F.pad(x, (w, w))
    out = xp[..., 2 * w: 2 * w + n] * kernel[0]
    for j in range(1, 2 * w + 1):
        out = out.add_(xp[..., 2 * w - j: 2 * w - j + n], alpha=kernel[j])
    return out


def _hann_kernel(w: int) -> list[float]:
    b = matlab_hanning(2 * w + 1)
    return [float(v) for v in b / np.sum(b)]


def make_imcra_step(p: ImcraParams, dtype=torch.float32):
    """``step(state, ya2, l, first_nz, any_nz) -> (state, gains)`` for a
    batch of lanes: ``ya2`` (B, F) periodograms of frame ``l`` (1-based,
    one host integer shared by all lanes), ``first_nz`` and ``any_nz`` (B,)
    the gate's flags."""
    m21 = p.m21
    b = _hann_kernel(p.w)
    b_xi_l = _hann_kernel(p.w_xi_local)
    b_xi_g = _hann_kernel(p.w_xi_global)

    k_u = min(_iround(p.f_u / p.fs * p.m + 1), m21)
    k_l = _iround(p.f_l / p.fs * p.m + 1)
    k2 = _iround(500.0 / p.fs * p.m + 1)
    k3 = _iround(3500.0 / p.fs * p.m + 1)
    eta_min = p.eta_min
    g_f = p.g_f
    nonstat_factor = 2.0 if p.nonstat == "high" else 1.4685
    tone_len = m21 - 15          # lambda_dav_long(8:M21-8) slice length
    n_frame = k_u - (k_l - 1)
    n_local = (k2 + k3 - 3) - 2

    def db(a):
        return torch.where(
            a > 0, 10.0 * torch.log10(torch.clamp_min(a, 1e-300)), -100.0)

    def presence(x_db, lo, hi):
        lin = p.p_min + (x_db - lo) / (hi - lo) * (1 - p.p_min)
        return torch.where(x_db <= lo, p.p_min,
                           torch.where(x_db < hi, lin, 1.0))

    def processed(state: ImcraState, ya2, l: int):
        is_first = (state.l_fnz == l)[:, None]
        warmup = (state.l_fnz > l - 14)[:, None]      # l < 14 + l_fnz

        lambda_d = torch.where(is_first, ya2, state.lambda_d)
        gamma = ya2 / torch.clamp_min(lambda_d, 1e-10)
        eta = p.alpha_eta * state.eta_2term \
            + (1 - p.alpha_eta) * torch.clamp_min(gamma - 1, 0)
        eta = torch.clamp_min(eta, eta_min)
        v = gamma * eta / (1 + eta)

        sf = _conv_same(ya2, b, p.w)
        s = torch.where(is_first, sf,
                        p.alpha_s * state.s + (1 - p.alpha_s) * sf)
        sy = torch.where(is_first, ya2, state.sy)
        lambda_dav = torch.where(is_first, ya2, state.lambda_dav)
        st_mid = torch.where(is_first, sf, state.st)

        smin = torch.where(warmup, s, torch.minimum(state.smin, s))
        smact = torch.where(warmup, s, torch.minimum(state.smact, s))

        i_f = ((ya2 < p.delta_y * p.bmin * smin)
               & (s < p.delta_s * p.bmin * smin)).to(dtype)
        conv_i = _conv_same(i_f, b, p.w)
        conv_y = _conv_same(i_f * ya2, b, p.w)
        some = conv_i > 0
        sft = torch.where(some, conv_y / torch.where(some, conv_i, 1.0),
                          st_mid)
        st = torch.where(warmup, s,
                         p.alpha_s * st_mid + (1 - p.alpha_s) * sft)
        smint = torch.where(warmup, st, torch.minimum(state.smint, st))
        smactt = torch.where(warmup, st, torch.minimum(state.smactt, st))

        ref_min = smin if p.nonstat == "low" else smint
        ref_min = torch.clamp_min(ref_min, 1e-10)
        gamma_mint = ya2 / p.bmin / ref_min
        zetat = s / p.bmin / ref_min
        band = (gamma_mint > 1) & (gamma_mint < p.delta_yt) \
            & (zetat < p.delta_s)
        qhat = torch.where(band, (p.delta_yt - gamma_mint)
                           / (p.delta_yt - 1), 1.0)
        phat = torch.where(
            band,
            1.0 / (1 + qhat / torch.clamp_min(1 - qhat, 1e-300)
                   * (1 + eta) * torch.exp(-v)),
            0.0)
        phat = torch.where((gamma_mint >= p.delta_yt) | (zetat >= p.delta_s),
                           1.0, phat)

        alpha_dt = p.alpha_d + (1 - p.alpha_d) * phat
        lambda_dav = alpha_dt * lambda_dav + (1 - alpha_dt) * ya2
        a_long = p.alpha_d_long + (1 - p.alpha_d_long) * phat
        lambda_dav_long = torch.where(
            warmup, lambda_dav,
            a_long * state.lambda_dav_long + (1 - a_long) * ya2)

        # sub-window minima switch (proc_IMCRA.m:231-246)
        lswitch = state.l_mod_lswitch + 1
        fire = (lswitch == p.vwin)[:, None, None]
        seed = (state.l_fnz == l - (p.vwin - 1))[:, None, None]
        sw_seed = s[:, :, None].expand(-1, -1, p.nwin)
        swt_seed = st[:, :, None].expand(-1, -1, p.nwin)
        sw_roll = torch.cat([state.sw[:, :, 1:], smact[:, :, None]], dim=2)
        swt_roll = torch.cat([state.swt[:, :, 1:], smactt[:, :, None]], dim=2)
        sw = torch.where(fire, torch.where(seed, sw_seed, sw_roll), state.sw)
        swt = torch.where(fire, torch.where(seed, swt_seed, swt_roll),
                          state.swt)
        roll = (fire & ~seed)[:, :, 0]
        smin = torch.where(roll, sw_roll.amin(dim=2), smin)
        smint = torch.where(roll, swt_roll.amin(dim=2), smint)
        smact = torch.where(roll, s, smact)
        smactt = torch.where(roll, st, smactt)
        lswitch = torch.where(fire[:, 0, 0], 0, lswitch).to(torch.int32)

        lambda_d = nonstat_factor * lambda_dav

        # a-priori speech-absence probability (proc_IMCRA.m:257-310)
        xi = p.alpha_xi * state.xi + (1 - p.alpha_xi) * eta
        xi_local = _conv_same(xi, b_xi_l, p.w_xi_local)
        xi_global = _conv_same(xi, b_xi_g, p.w_xi_global)
        xi_frame = tree_sum(xi[:, k_l - 1: k_u]) / n_frame
        dxi = xi_frame - state.xi_frame
        xi_local_db, xi_global_db, xi_frame_db = (
            db(xi_local), db(xi_global), db(xi_frame))

        p_local = presence(xi_local_db, p.xi_ll_db, p.xi_lu_db)
        p_global = presence(xi_global_db, p.xi_gl_db, p.xi_gu_db)

        m_p_local = tree_sum(p_local[:, 2: k2 + k3 - 3]) / n_local
        bins = torch.arange(m21, device=ya2.device)
        reset = (m_p_local < 0.25)[:, None] \
            & ((bins >= k2 - 1) & (bins <= k3 - 1))[None, :]
        p_local = torch.where(reset, p.p_min, p_local)
        if p.tone_flag and l > 120:
            seg = lambda_dav_long
            tone = seg[:, 7: 7 + tone_len] > 2.5 * (seg[:, 9: 9 + tone_len]
                                                     + seg[:, 5: 5 + tone_len])
            tone_mask = torch.zeros_like(p_local, dtype=torch.bool)
            for off in (6, 7, 8):
                tone_mask[:, off: off + tone_len] |= tone
            tone_on = (m_p_local < 0.5)[:, None]
            p_local = torch.where(tone_on & tone_mask, p.p_min, p_local)

        lin_f = p.p_min + (xi_frame_db - state.xi_m_db - p.xi_fl_db) \
            / (p.xi_fu_db - p.xi_fl_db) * (1 - p.p_min)
        p_frame = torch.where(
            xi_frame_db <= p.xi_fl_db, p.p_min,
            torch.where(dxi >= 0, 1.0,
                        torch.where(xi_frame_db >= state.xi_m_db + p.xi_fu_db,
                                    1.0,
                                    torch.where(xi_frame_db
                                                <= state.xi_m_db + p.xi_fl_db,
                                                p.p_min, lin_f))))
        xi_m_db = torch.where((xi_frame_db > p.xi_fl_db) & (dxi >= 0),
                              torch.clamp(xi_frame_db, p.xi_ml_db, p.xi_mu_db),
                              state.xi_m_db)

        q = 1 - p_global * p_local * p_frame[:, None] if p.broad_flag \
            else 1 - p_local * p_frame[:, None]
        q = torch.clamp_max(q, p.q_max)

        # posterior + OM-LSA gain (proc_IMCRA.m:312-342)
        gamma2 = ya2 / torch.clamp_min(lambda_d, 1e-10)
        eta2 = p.alpha_eta * state.eta_2term \
            + (1 - p.alpha_eta) * torch.clamp_min(gamma2 - 1, 0)
        eta2 = torch.clamp_min(eta2, eta_min)
        v2 = gamma2 * eta2 / (1 + eta2)
        ph1 = torch.where(
            q < 0.9,
            1.0 / (1 + q / torch.clamp_min(1 - q, 1e-300)
                   * (1 + eta2) * torch.exp(-v2)),
            0.0)
        wiener = eta2 / (1 + eta2)
        gh1 = torch.where(
            v2 > 5, wiener,
            torch.where(v2 > 0,
                        wiener * torch.exp(0.5 * expint_e1(
                            torch.clamp_min(v2, 1e-300))),
                        1.0))
        if p.tone_flag:
            ldg = lambda_d.clone()
            ldg[:, 3: m21 - 3] = torch.minimum(
                torch.minimum(lambda_d[:, 3: m21 - 3],
                              lambda_d[:, 0: m21 - 6]),
                lambda_d[:, 6: m21])
            sy = 0.8 * sy + 0.2 * ya2
            gh0 = g_f * torch.sqrt(ldg / (sy + 1e-10))
        else:
            gh0 = torch.full_like(ya2, g_f)
        g = gh1 ** ph1 * gh0 ** (1 - ph1)
        eta_2term = gh1 * gh1 * gamma2

        new = ImcraState(
            lambda_d=lambda_d, eta_2term=eta_2term, xi=xi,
            xi_frame=xi_frame, xi_m_db=xi_m_db, s=s, st=st, smin=smin,
            smint=smint, smact=smact, smactt=smactt, sw=sw, swt=swt,
            lambda_dav=lambda_dav, lambda_dav_long=lambda_dav_long, sy=sy,
            l_mod_lswitch=lswitch, l_fnz=state.l_fnz,
            fnz_flag=state.fnz_flag)
        return new, g

    def step(state: ImcraState, ya2, l: int, first_nz, any_nz):
        process = torch.where(state.fnz_flag, any_nz, first_nz)
        new, g = processed(state, ya2, l)
        # the gate lane by lane (lax.cond under vmap): a skipped lane keeps
        # its state and counts its first-nonzero frame on
        kept = []
        for name, a, b_ in zip(ImcraState._fields, new, state):
            if name == "l_fnz":
                kept.append(b_ + (~process & ~state.fnz_flag).to(b_.dtype))
            elif name == "fnz_flag":
                kept.append(process | b_)
            else:
                kept.append(torch.where(
                    process.view((-1,) + (1,) * (a.dim() - 1)), a, b_))
        return ImcraState(*kept), torch.where(process[:, None], g, 0.0)

    return step


def init_imcra_state(p: ImcraParams, n_lanes: int = 1, dtype=torch.float32,
                     device=None) -> ImcraState:
    device = resolve_device(device)
    m21 = p.m21

    def z(*shape):
        return torch.zeros((n_lanes, *shape), dtype=dtype, device=device)

    def i32(v):
        return torch.full((n_lanes,), v, dtype=torch.int32, device=device)

    return ImcraState(
        lambda_d=z(m21), eta_2term=z(m21) + 1, xi=z(m21),
        xi_frame=z(), xi_m_db=z(),
        s=z(m21), st=z(m21), smin=z(m21), smint=z(m21), smact=z(m21),
        smactt=z(m21), sw=z(m21, p.nwin), swt=z(m21, p.nwin),
        lambda_dav=z(m21), lambda_dav_long=z(m21), sy=z(m21),
        l_mod_lswitch=i32(0), l_fnz=i32(1),
        fnz_flag=torch.zeros((n_lanes,), dtype=torch.bool, device=device))


class OmlsaEnhancer:
    """Single-utterance and batched OM-LSA enhancement, on the card unless
    ``device`` names another."""

    # Kept for the reference's interface: there the frame count rounds up
    # to a multiple of it so lengths share one compiled scan, the padding
    # frames being inert (zero frames hit the first-nonzero / silence gate,
    # proc_IMCRA.m:145).  The port's frame loop stops at the last valid
    # frame instead, with the same output; the value changes nothing.
    frame_bucket = 64

    def __init__(self, params: ImcraParams | None = None,
                 dtype=torch.float32, device=None):
        full_f32()
        self.p = params or ImcraParams()
        self.dtype = dtype
        self.device = resolve_device(device)
        win_a, win_s = imcra_windows(self.p)
        self._win_a = torch.as_tensor(win_a, dtype=dtype, device=self.device)
        self._win_s = torch.as_tensor(win_s, dtype=dtype, device=self.device)
        mask = np.zeros(self.p.m21)
        mask[3: self.p.m21 - 1] = 1.0
        self._mask = torch.as_tensor(mask, dtype=dtype, device=self.device)
        self._step = make_imcra_step(self.p, dtype)

    def _run(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, M) frames on the device -> (B, T*Mno + Mo) waveforms."""
        p = self.p
        n_lanes, t = frames.shape[0], frames.shape[1]
        mno, ratio = p.mno, p.m // p.mno
        if t == 0:
            return frames.new_zeros((n_lanes, (ratio - 1) * mno))
        spec = torch.fft.rfft(frames * self._win_a, dim=-1)
        ya2 = spec.abs() ** 2
        first_nz = frames[..., 0].abs() > p.zero_thres
        any_nz = (frames.abs() > p.zero_thres).any(dim=-1)
        state = init_imcra_state(p, n_lanes, self.dtype, frames.device)
        gains = []
        for i in range(t):
            state, g = self._step(state, ya2[:, i], i + 1, first_nz[:, i],
                                  any_nz[:, i])
            gains.append(g)
        xspec = torch.stack(gains, dim=1) * self._mask * spec
        x = torch.fft.irfft(xspec, n=p.m, dim=-1) * self._win_s
        chunks = x.reshape(n_lanes, t, ratio, mno)
        out = frames.new_zeros((n_lanes, t + ratio - 1, mno))
        for c in range(ratio):
            out[:, c: c + t] += chunks[:, :, c]
        return out.reshape(n_lanes, -1)

    def frames_for(self, x: np.ndarray) -> np.ndarray:
        p = self.p
        x = np.asarray(x, np.float64).reshape(-1)
        t = max((len(x) - p.mo) // p.mno, 0)
        idx = np.arange(p.m)[None, :] + p.mno * np.arange(t)[:, None]
        return x[idx]

    def enhance(self, x: np.ndarray, quantize: bool = True) -> np.ndarray:
        """int16-scale samples -> enhanced stream (Nframes*Mno + Mo long,
        matching the reference's emitted raw int16 stream)."""
        frames = torch.as_tensor(self.frames_for(x), dtype=self.dtype,
                                 device=self.device)
        y = self._run(frames[None])[0].cpu().numpy().astype(np.float64)
        return matlab_int16_write(y) if quantize else y

    def enhance_batch(self, xs: list[np.ndarray], quantize: bool = True,
                      micro_batch: int | None = 32):
        """Batch enhancement: raw samples go up (int16 when exact), framing
        and the int16 write run on the device, int16 PCM comes down.  A
        lane's frames past its own length are zeroed, so the silence gate
        leaves its state alone; outputs are those of per-utterance
        ``enhance`` (float64-gated).

        ``micro_batch``: lanes a device call (all calls are enqueued before
        the first result is fetched); None = one call."""
        p = self.p
        ts_all = np.asarray(
            [max((len(np.asarray(x).reshape(-1)) - p.mo) // p.mno, 0)
             for x in xs], np.int64)
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        mb = len(xs) if not micro_batch else min(int(micro_batch), len(xs))

        def dispatch(lo: int):
            hi = min(lo + mb, len(xs))
            ts = ts_all[lo: hi]
            t_max = int(ts.max())
            smp = np.zeros((hi - lo, t_max * p.mno + p.mo), np.float64)
            for j in range(hi - lo):
                x = np.asarray(xs[lo + j], np.float64).reshape(-1)
                n_keep = int(ts[j]) * p.mno + p.mo  # frames_for's last idx+1
                smp[j, : min(n_keep, len(x))] = x[:n_keep]
            smp_dev = torch.as_tensor(pack_samples_for_upload(smp, np_dt),
                                      device=self.device).to(self.dtype)
            frames = (smp_dev.unfold(-1, p.m, p.mno) if t_max
                      else smp_dev.new_zeros((hi - lo, 0, p.m)))
            valid = (torch.arange(t_max, device=self.device)[None, :]
                     < torch.as_tensor(ts, device=self.device)[:, None])
            y = self._run(frames * valid[..., None].to(self.dtype))
            return matlab_int16_write_torch(y) if quantize else y

        pending = [(lo, dispatch(lo)) for lo in range(0, len(xs), mb)]
        outs = []
        for lo, ys in pending:
            fetched = ys.cpu().numpy()
            for j in range(fetched.shape[0]):
                outs.append(fetched[j, : int(ts_all[lo + j]) * p.mno
                                    + p.mo].copy())
        return outs
