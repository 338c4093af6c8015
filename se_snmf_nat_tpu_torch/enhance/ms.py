"""MS enhancement stack on the card: the Ephraim-Malah MMSE / log-MMSE gain
with Rainer Martin's minimum-statistics noise tracking (or the MMSE-SPP
tracker).

Reference: src/MS/ssubmmse.m + src/MS/estnoisem.m (the GUI's 'MS' mode,
SE_GUI.m:420-426, with init_MS.m's ti=0.01 override).  Counterpart of the
reference package's ``enhance/ms.py``: batched rfft before a Python loop
over frames that carries BOTH the tracker state and the decision-directed
xu recurrence (the gain of frame t needs only the tracker state after frame
t), batched irfft and overlap-add after.  Chunked streaming state (input
tail, OLA tail, tracker state, xu — ssubmmse.m:95-128,202-215) is carried
by ``MsStreamState``.

The loop's state has a leading lane axis.  Branches on per-lane values
(the tracker's middle-of-buffer and buffer-switch steps, a lane past its
last frame) are computed for every lane and chosen with ``torch.where``;
sums over the bins are halving sums (``utils.special.tree_sum``), so a lane
gives the same bits alone as in a batch.  Plain PyTorch with cuFFT
transforms: no kernel of the port computes any of this.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import full_f32, resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import pack_samples_for_upload
from se_snmf_nat_tpu_torch.enhance.ms_params import (
    MsDerived, MsgParams, MsParams, _iround, ms_derived)
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write, matlab_int16_write_torch)
from se_snmf_nat_tpu_torch.utils.special import (
    bessel_i0_small, bessel_i1_small, expint_e1, tree_sum)


class MsScanState(NamedTuple):
    """Minimum-statistics carry + the gain's xu; leading lane axis B."""

    p: torch.Tensor           # (B, F) smoothed power spectrum
    sn2: torch.Tensor         # (B, F) noise PSD estimate
    pb: torch.Tensor          # (B, F) smoothed periodogram
    pb2: torch.Tensor         # (B, F) smoothed periodogram^2
    pminu: torch.Tensor       # (B, F) running minimum
    actmin: torch.Tensor      # (B, F) window minimum
    actminsub: torch.Tensor   # (B, F) sub-window minimum
    actbuf: torch.Tensor      # (B, nu, F) sub-window minima ring
    lminflag: torch.Tensor    # (B, F) bool
    ac: torch.Tensor          # (B,) correction factor
    subwc: torch.Tensor       # (B,) int32 sub-window counter
    ibuf: torch.Tensor        # (B,) int32 ring pointer (1-based like MATLAB)
    tcount: torch.Tensor      # (B,) int32 global frame counter (t + nrcum)
    xu: torch.Tensor          # (B, F) unsmoothed prior SNR carry


@dataclass
class MsStreamState:
    """Cross-chunk state (ssubmmse.m zo struct)."""

    scan: MsScanState | MsgScanState | None  # None until a frame is seen
    ssv: np.ndarray            # OLA tail (ni*(of-1),)
    si: np.ndarray             # unconsumed input samples


def _lanes(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) flag shaped to broadcast against ``like`` lane by lane."""
    return flag.view((-1,) + (1,) * (like.dim() - 1))


def _mmse_gain(p: MsParams, a: float, xu, yft, noise):
    """The MMSE gain chain (ssubmmse.m:165-189) given the noise PSD after
    this frame; returns (gain, new xu)."""
    gam = torch.clamp_max(yft / noise, p.gx)
    xi = a * xu + (1 - a) * torch.clamp_min(gam - 1.0, p.xn)
    if p.lg:
        xir = xi / (1.0 + xi)
        arg = torch.clamp_min(xir * gam, 1e-35)
        gi = xir * torch.exp(0.5 * expint_e1(arg))
    else:
        v = 0.5 * xi * gam / (1.0 + xi)
        gam_safe = torch.clamp_min(gam, 1e-35)
        gi_hi = (0.277 + 2.0 * v) / gam_safe
        kk = np.sqrt(2.0 * np.pi)
        gi_lo = kk * torch.sqrt(v) * ((0.5 + v) * bessel_i0_small(v)
                                      + v * bessel_i1_small(v)) \
            / (gam_safe * torch.exp(v))
        gi = torch.where(v < 0.5, gi_lo, gi_hi)
    return gi, gam * gi * gi


def make_ms_step(p: MsParams, d: MsDerived, dtype=torch.float32):
    """``step(state, yft) -> (state, gain)``: one frame of the
    minimum-statistics tracker (estnoisem.m:199-247) and the gain, for a
    batch of lanes (``yft`` (B, F))."""
    nv, nd, nu = d.nv, d.nd, d.nu_eff
    a = d.a
    tables = {}             # device -> (qith, nsms, ring slot numbers)

    def step(st: MsScanState, yft):
        dev = yft.device
        if dev not in tables:
            tables[dev] = (torch.as_tensor(p.qith, dtype=dtype, device=dev),
                           torch.as_tensor(d.nsms, dtype=dtype, device=dev),
                           torch.arange(nu, device=dev))
        qith, nsms, slots = tables[dev]
        sums = tree_sum(torch.stack([st.p, yft, st.sn2]))
        sum_p, sum_y, sum_sn2 = sums[0], sums[1], sums[2]
        acb = 1.0 / (1.0 + (sum_p / sum_y - 1.0) ** 2)
        ac = d.aca * st.ac + (1 - d.aca) * torch.clamp_min(acb, d.aca)
        ah = d.amax * ac[:, None] / (1.0 + (st.p / st.sn2 - 1.0) ** 2)
        snr = sum_p / sum_sn2
        ah = torch.maximum(ah, torch.clamp_max(snr ** d.snrexp,
                                               d.aminh)[:, None])
        pcur = ah * st.p + (1 - ah) * yft
        b = torch.clamp_max(ah * ah, d.bmax)
        pb = b * st.pb + (1 - b) * pcur
        pb2 = b * st.pb2 + (1 - b) * pcur * pcur
        tcount = st.tcount + 1
        qeqi = torch.maximum(
            torch.clamp_max((pb2 - pb * pb) / (2.0 * st.sn2 * st.sn2),
                            d.qeqimax),
            d.qeqimin / tcount.to(dtype)[:, None])
        qiav = tree_sum(qeqi) / yft.shape[-1]
        bc = 1.0 + p.av * torch.sqrt(qiav)
        bmind = 1.0 + 2.0 * (nd - 1) * (1 - d.md) / (1.0 / qeqi - 2.0 * d.md)
        bminv = 1.0 + 2.0 * (nv - 1) * (1 - d.mv) / (1.0 / qeqi - 2.0 * d.mv)
        cand = bc[:, None] * pcur * bmind
        kmod = cand < st.actmin
        actmin = torch.where(kmod, cand, st.actmin)
        actminsub = torch.where(kmod, bc[:, None] * pcur * bminv,
                                st.actminsub)

        middle = ((st.subwc > 1) & (st.subwc < nv))[:, None]
        switch = (st.subwc >= nv)[:, None]

        # middle-of-buffer branch
        lmin_mid = st.lminflag | kmod
        pminu_mid = torch.minimum(actminsub, st.pminu)

        # buffer-switch branch (computed for every lane, selected below)
        ibuf_new = 1 + st.ibuf % nu
        slot = (slots[None, :] == (ibuf_new - 1)[:, None])[:, :, None]
        actbuf_sw = torch.where(slot, actmin[:, None, :], st.actbuf)
        pminu_sw = actbuf_sw.amin(dim=1)
        # first threshold above qiav (qith[-1] is inf: one always is);
        # argmax of a bool tensor is refused, so of its int8 cast
        nsm = nsms[torch.argmax((qiav[:, None] < qith).to(torch.int8),
                                dim=1)]
        lmin = (st.lminflag & ~kmod & (actminsub < nsm[:, None] * pminu_sw)
                & (actminsub > pminu_sw))
        pminu_sw = torch.where(lmin, actminsub, pminu_sw)
        actbuf_sw = torch.where(lmin[:, None, :], pminu_sw[:, None, :],
                                actbuf_sw)

        pminu = torch.where(switch, pminu_sw,
                            torch.where(middle, pminu_mid, st.pminu))
        sn2 = torch.where(middle, pminu_mid, st.sn2)
        lminflag = torch.where(switch, False,
                               torch.where(middle, lmin_mid, st.lminflag))
        actmin = torch.where(switch, torch.inf, actmin)
        actbuf = torch.where(switch[:, :, None], actbuf_sw, st.actbuf)
        ibuf = torch.where(switch[:, 0], ibuf_new, st.ibuf).to(torch.int32)
        subwc = (torch.where(switch[:, 0], 0, st.subwc) + 1).to(torch.int32)

        # MMSE gain (ssubmmse.m:165-189); the noise PSD is sn2 after this
        # frame
        gi, xu = _mmse_gain(p, a, st.xu, yft, sn2)

        new = MsScanState(p=pcur, sn2=sn2, pb=pb, pb2=pb2, pminu=pminu,
                          actmin=actmin, actminsub=actminsub, actbuf=actbuf,
                          lminflag=lminflag, ac=ac, subwc=subwc, ibuf=ibuf,
                          tcount=tcount, xu=xu)
        return new, gi

    return step


def init_ms_scan_state(yp0: torch.Tensor, p: MsParams, d: MsDerived,
                       dtype=torch.float32) -> MsScanState:
    """First-frame initialization (estnoisem.m:186-198) + xu=1
    (ssubmmse.m:160), from the first frame's power spectra ``yp0`` (B, F)
    on the device the state lives on."""
    n_lanes, f = yp0.shape
    dev = yp0.device
    inf = torch.full((n_lanes, f), torch.inf, dtype=dtype, device=dev)
    i32 = lambda v: torch.full((n_lanes,), v, dtype=torch.int32,  # noqa: E731
                               device=dev)
    return MsScanState(
        p=yp0, sn2=yp0, pb=yp0, pb2=yp0 * yp0, pminu=yp0,
        actmin=inf, actminsub=inf.clone(),
        actbuf=torch.full((n_lanes, d.nu_eff, f), torch.inf, dtype=dtype,
                          device=dev),
        lminflag=torch.zeros((n_lanes, f), dtype=torch.bool, device=dev),
        ac=torch.ones((n_lanes,), dtype=dtype, device=dev), subwc=i32(d.nv),
        ibuf=i32(0), tcount=i32(0),
        xu=torch.ones((n_lanes, f), dtype=dtype, device=dev))


class MsgScanState(NamedTuple):
    """MMSE-SPP tracker carry (estnoiseg.m rebuild) + the gain's xu."""

    xt: torch.Tensor      # (B, F) noise PSD estimate
    pslp: torch.Tensor    # (B, F) smoothed speech-presence probability
    xu: torch.Tensor      # (B, F) unsmoothed prior SNR carry


def make_msg_step(p: MsParams, g: MsgParams, d: MsDerived,
                  dtype=torch.float32):
    """Fused MMSE-SPP noise tracking (estnoiseg.m:120-137; the reference
    ships this tracker caller-less — here it is a selectable alternative to
    minimum statistics) + the same MMSE gain chain."""
    tinc = d.tinc
    ax = float(np.exp(-tinc / g.tax))
    ap = float(np.exp(-tinc / g.tap))
    xih1 = 10.0 ** (g.asnr / 10.0)
    xih1r = 1.0 / (1.0 + xih1) - 1.0
    pfac = (1.0 / g.pspri - 1.0) * (1.0 + xih1)
    a = d.a

    def step(st: MsgScanState, yft):
        ph1y = 1.0 / (1.0 + pfac * torch.exp(xih1r * yft / st.xt))
        pslp = ap * st.pslp + (1 - ap) * ph1y
        ph1y = torch.minimum(ph1y, 1.0 - g.pnsaf * (pslp > g.psthr).to(dtype))
        xtr = (1.0 - ph1y) * yft + ph1y * st.xt
        xt = ax * st.xt + (1 - ax) * xtr
        gi, xu = _mmse_gain(p, a, st.xu, yft, xt)
        return MsgScanState(xt=xt, pslp=pslp, xu=xu), gi

    return step


class MmseEnhancer:
    """Chunk-capable MMSE/log-MMSE enhancer (the reference GUI's MS mode),
    on the card unless ``device`` names another.

    tracker: 'martin' (minimum statistics, estnoisem — the reference's live
    choice) or 'mmse' (MMSE-SPP, estnoiseg).
    """

    def __init__(self, fs: int = 16000, params: MsParams | None = None,
                 dtype=torch.float32, tracker: str = "martin",
                 msg_params: MsgParams | None = None, device=None):
        full_f32()
        self.p = params or MsParams()
        self.fs = fs
        self.d = ms_derived(self.p, fs)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tracker = tracker
        self.g = msg_params or MsgParams()
        d, p = self.d, self.p
        self._win = torch.as_tensor(d.win, dtype=dtype, device=self.device)
        if tracker == "mmse":
            self._step = make_msg_step(p, self.g, d, dtype)
        else:
            self._step = make_ms_step(p, d, dtype)
        self._no = _iround(p.of)
        # Kept for the reference's interface (the frame count's rounding
        # there, so lengths share one compiled scan); the port's loop stops
        # at the last valid frame with the same output.
        self.frame_bucket = 64

    def _run(self, frames: torch.Tensor, state0, n_valid: np.ndarray):
        """(B, T, nf) frames -> ((B, (T+of-1)*ni) OLA stream, state after
        each lane's last valid frame).  ``n_valid`` (host, (B,)): frames of
        a lane at or past it leave its state alone and synthesize zeros."""
        d = self.d
        ni, nf = d.ni, d.nf
        n_lanes, t = frames.shape[0], frames.shape[1]
        y = frames * self._win
        yf = torch.fft.rfft(y, nf, dim=-1)
        yp = (yf * yf.conj()).real
        n_all = int(n_valid.min())
        ok_all = (torch.arange(t)[:, None]
                  < torch.as_tensor(n_valid)[None, :]).to(frames.device)
        st = state0
        gains = []
        for i in range(t):
            new_st, g = self._step(st, yp[:, i])
            if i < n_all:
                st = new_st
            else:
                # a lane past its last frame keeps its state; a select, so
                # a placeholder lane's inf/NaN stays out
                ok = ok_all[i]
                st = type(st)(*(torch.where(_lanes(ok, a), a, b)
                                for a, b in zip(new_st, st)))
                g = torch.where(ok[:, None], g, 0.0)
            gains.append(g)
        se = torch.fft.irfft(yf * torch.stack(gains, dim=1), nf, dim=-1) \
            * self._win
        ratio = nf // ni
        chunks = se.reshape(n_lanes, t, ratio, ni)
        out = frames.new_zeros((n_lanes, t + ratio - 1, ni))
        for c in range(ratio):
            out[:, c: c + t] += chunks[:, :, c]
        return out.reshape(n_lanes, -1), st

    def _scan0(self, s: np.ndarray, idx: np.ndarray, nr: int):
        """First-chunk tracker init of one lane, on the host in float64 so
        every plan (single, chunked, batched) starts from the same bits;
        returned as NumPy arrays, one per state field."""
        d, nf = self.d, self.d.nf
        win = d.win
        if self.tracker == "mmse":
            # estnoiseg.m:122-124 init: psini * mean of the first
            # ~tavini seconds of frames
            n0 = max(1, min(nr, _iround(1 + self.g.tavini / d.tinc)))
            y0 = np.fft.rfft(s[idx[:n0]] * win[None, :], nf, axis=1)
            yp0 = (y0 * np.conj(y0)).real
            return (self.g.psini * yp0.mean(axis=0),
                    np.full((nf // 2 + 1,), self.g.psini),
                    np.ones((nf // 2 + 1,)))
        y0 = np.fft.rfft(s[idx[0]] * win, nf)
        return ((y0 * np.conj(y0)).real,)

    def _upload_scan0(self, rows: list[tuple]):
        """The lanes' host inits as one batched state on the device."""
        cols = [torch.as_tensor(np.stack(c), dtype=self.dtype,
                                device=self.device) for c in zip(*rows)]
        if self.tracker == "mmse":
            return MsgScanState(*cols)
        return init_ms_scan_state(cols[0], self.p, self.d, self.dtype)

    def enhance_batch(self, xs: list[np.ndarray], quantize: bool = True,
                      micro_batch: int | None = 32):
        """Batch one-shot enhancement.  Raw samples go up (int16 when
        exact), framing and the int16 write run on the device, int16 PCM
        comes down; the tracker init runs on the host per utterance (one
        float64 rfft), so outputs are those of per-utterance ``enhance``
        (float64-gated).  ``micro_batch``: lanes a device call (all calls
        are enqueued before the first result is fetched); None = one call.
        Empty and too-short inputs give empty outputs."""
        d = self.d
        ni, nf = d.ni, d.nf
        xs_np = [np.asarray(x, np.float64).reshape(-1) for x in xs]
        nrs_all = np.asarray(
            [(len(x) - nf + ni) // ni if len(x) >= nf else 0 for x in xs_np],
            np.int64)
        empty = np.zeros(0, np.int16 if quantize else np.float64)
        if int(nrs_all.max()) == 0:
            return [empty.copy() for _ in xs]
        np_dt = self._np_dtype
        mb = len(xs) if not micro_batch else min(int(micro_batch), len(xs))

        def dispatch(lo: int):
            hi = min(lo + mb, len(xs))
            nrs = nrs_all[lo: hi]
            nr_max = int(nrs.max())
            if nr_max == 0:
                return None
            width = ni * (nr_max - 1) + nf
            smp = np.zeros((hi - lo, width), np.float64)
            scan0s = []
            for j, nr in enumerate(int(n) for n in nrs):
                if nr == 0:
                    # placeholder lane; its outputs are discarded
                    scan0s.append(self._scan0(np.zeros(nf),
                                              np.arange(nf)[None, :], 1))
                    continue
                x = xs_np[lo + j]
                # samples past the last frame (ni*(nr-1)+nf) are never framed
                n_keep = min(len(x), width)
                smp[j, : n_keep] = x[:n_keep]
                idx = ni * np.arange(nr)[:, None] + np.arange(nf)[None, :]
                scan0s.append(self._scan0(x, idx, nr))
            smp_dev = torch.as_tensor(pack_samples_for_upload(smp, np_dt),
                                      device=self.device).to(self.dtype)
            y, _ = self._run(smp_dev.unfold(-1, nf, ni),
                             self._upload_scan0(scan0s), nrs)
            return matlab_int16_write_torch(y) if quantize else y

        pending = [(lo, dispatch(lo)) for lo in range(0, len(xs), mb)]
        outs = []
        for lo, ys in pending:
            fetched = None if ys is None else ys.cpu().numpy()
            for j in range(min(mb, len(xs) - lo)):
                nr = int(nrs_all[lo + j])
                if nr == 0:
                    outs.append(empty.copy())
                    continue
                out = fetched[j, : ni * (nr + self._no - 1)]
                outs.append(out.copy() if quantize
                            else out.astype(np.float64))
        return outs

    def initial_state(self) -> MsStreamState:
        return MsStreamState(scan=None,
                             ssv=np.zeros(self.d.ni * (self._no - 1),
                                          self._np_dtype),
                             si=np.zeros(0))

    @property
    def _np_dtype(self):
        return np.float64 if self.dtype == torch.float64 else np.float32

    def enhance(self, x: np.ndarray, state: MsStreamState | None = None,
                return_state: bool = False, quantize: bool = True):
        """Enhance int16-scale samples.  Without state: one-shot full-stream
        output.  With state/return_state: chunked semantics matching
        ssubmmse's resume protocol."""
        d = self.d
        ni, nf = d.ni, d.nf
        chunked = state is not None or return_state
        st = state or self.initial_state()
        s = np.concatenate([st.si, np.asarray(x, np.float64).reshape(-1)])
        nr = (len(s) - nf + ni) // ni if len(s) >= nf else 0
        tail = ni * (self._no - 1)
        if nr == 0:
            # dtype follows quantize even for empty output, matching the
            # non-empty paths and enhance_batch
            out = np.zeros(0, np.int16) if quantize else np.zeros(0)
            new_state = MsStreamState(scan=st.scan, ssv=st.ssv, si=s)
            if return_state:
                return out, new_state
            return out
        idx = ni * np.arange(nr)[:, None] + np.arange(nf)[None, :]
        frames = torch.as_tensor(s[idx], dtype=self.dtype,
                                 device=self.device)[None]
        scan0 = st.scan if st.scan is not None \
            else self._upload_scan0([self._scan0(s, idx, nr)])
        ss, scan_out = self._run(frames, scan0, np.asarray([nr]))
        # the OLA tail carried from the last chunk is added in the compute
        # dtype, as the one-shot overlap-add adds it, so chunks give the
        # one-shot output bit for bit (the reference adds it in float64)
        ss = ss[0].cpu().numpy()
        ss[:tail] += st.ssv.astype(ss.dtype)
        if not chunked:
            ss = ss.astype(np.float64)
            return matlab_int16_write(ss) if quantize else ss
        emitted = len(ss) - tail
        new_state = MsStreamState(scan=scan_out, ssv=ss[emitted:].copy(),
                                  si=s[emitted:].copy())
        out = ss[:emitted].astype(np.float64)
        out_q = matlab_int16_write(out) if quantize else out
        if return_state:
            return out_q, new_state
        return out_q
