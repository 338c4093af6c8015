"""Real-time streaming multichannel path (PMWF beamformer + online NTF) on
the card.  Counterpart of the reference package's
``multichannel/streaming.py``.

The reference's multichannel runtime is a frame-at-a-time shell: every
frame pushes the C-channel spectra into a buffered window, accumulates the
noisy spectro-temporal covariance as a RUNNING SUM normalized in place
every ``norm_period`` frames, freezes the noise covariance from the
noise-only init period (``W`` flag, src/NTF_sep_event_RT.m:91-96), rebuilds
the per-bin PMWF filter, and emits the filtered CENTER frame of the
2L+1-frame window (src/PMWF_sep_event_RT_CHiME.m:120-203, state slots
src/init_buff_NTF.m:19-36).

Here the frame step (``make_pmwf_stream_step``) is one function of tensors
with any leading lane axes, driven by three callers: the per-frame plan
(``make_pmwf_streaming_run``, a Python loop over frames, one utterance or a
batch of lanes), the push-based :class:`PmwfStreamingSession` (the same
step over each block's valid frames, so any chunking gives the one-shot
output), and the whole-utterance plan (``make_pmwf_streaming_run_fast``).

The whole-utterance plan computes each frame's frequency-collapsed
covariance G once, forms each window's covariance as the box sum of the
2L+1 G's, runs the only sequential part — the running Ycov sum with its
periodic divide — as a loop of in-place adds, reads the frozen Ncov from
that trajectory, and solves the filters of a chunk of frames at once.  It
keeps the covariances as (..., T, F, C, C), the per-frame step's layout:
the card pads no small trailing axis.  Its window covariance adds the same
products in the same order as the step's, and the solves are the same
elementwise function, so both plans give the same bits.

A lane gives the same bits alone as in a batch: every operation is
elementwise or an ordered add, and every FFT call has one shape
(``multichannel.pmwf``).  No kernel of the port computes any of
this; the reference computes it outside Pallas.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from se_snmf_nat_tpu_torch.config import PipelineConfig, default_config
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import overlap_add
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.multichannel.ntf import (
    cnm_product, default_c_init)
from se_snmf_nat_tpu_torch.multichannel.pmwf import (
    PmwfParams, analysis, apply_filters, cdiv_real, cmul_conj,
    collapse_index, complex_dtype, emit_samples, frame_cov, frames_of,
    ordered_sum, pmwf_filters, synthesis)
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write


class PmwfStreamState(NamedTuple):
    """init_buff_NTF.m's PMWF slots; a batch carries a leading lane axis
    on every field."""

    y_win: torch.Tensor  # (C, F, 2L+1) complex — TF_blk window, newest last
    ycov: torch.Tensor   # (F, C, C) complex — running Ycov accumulator
    ncov: torch.Tensor   # (F, C, C) complex — frozen after init_n_len
    l: torch.Tensor      # int32 1-based frame counter (g.cnt)


def pmwf_stream_init(params: PmwfParams, n_ch: int, n_bins: int,
                     cdtype=torch.complex64, device=None) -> PmwfStreamState:
    """A fresh stream's state, on the card unless ``device`` names
    another."""
    device = resolve_device(device)
    ml = 2 * params.l_nbr + 1
    z = torch.zeros((n_bins, n_ch, n_ch), dtype=cdtype, device=device)
    return PmwfStreamState(
        y_win=torch.zeros((n_ch, n_bins, ml), dtype=cdtype, device=device),
        ycov=z, ncov=z.clone(),
        l=torch.tensor(0, dtype=torch.int32, device=device))


def batch_stream_state(state: PmwfStreamState, n: int) -> PmwfStreamState:
    """One stream's state repeated over ``n`` lanes (a leading lane
    axis)."""
    return PmwfStreamState(*(f.unsqueeze(0).expand((n,) + f.shape).clone()
                             for f in state))


def window_cov(y_win: torch.Tensor, m_nbr: int) -> torch.Tensor:
    """PSD_cov_mat.m over ONE temporal window: the sum of outer products
    over the (2M+1)x(2L+1) spectro-temporal neighborhood of the window
    center, with the reference's frequency-boundary collapse.  y_win:
    (..., C, F, 2L+1) complex -> (..., F, C, C): each frame's sum over the
    shifts in order (``pmwf.frame_cov``), then the frames oldest first."""
    idx = collapse_index(y_win.shape[-2], m_nbr, y_win.device)
    z = y_win[..., idx, :].movedim(-1, -4)          # (..., W, C, M, F)
    r = ordered_sum(frame_cov(z), -4)               # (..., C, C, F)
    return r.movedim(-1, -3)


def make_pmwf_stream_step(params: PmwfParams):
    """The per-frame step shared by every caller.

    step(state, y_t (..., C, F) complex) -> (state', d (..., C, F)) where d
    is the filtered CENTER frame of the window (L frames of lookahead
    latency, exactly the reference's D(:,:,L+1) emission —
    PMWF_sep_event_RT_CHiME.m:177-203).  The frame counter may differ by
    lane; nothing is read on the host."""
    p = params

    def step(state: PmwfStreamState, y_t: torch.Tensor):
        y_win = torch.cat([state.y_win[..., 1:], y_t[..., None]], dim=-1)
        l = state.l + 1
        lv = l[..., None, None, None]
        r = window_cov(y_win, p.m_nbr)
        ycov = state.ycov + r
        # running-sum normalize IN PLACE every norm_period frames — the
        # reference's mod(g.cnt, p.norm_period)==0 quirk (:137-140), kept
        ycov = torch.where(lv % p.norm_period == 0,
                           cdiv_real(ycov, p.norm_period - 1), ycov)
        # W flag: noise covariance tracks Ycov through the noise-only init
        # period and freezes after (NTF_sep_event_RT.m:91-96, :143-145)
        ncov = torch.where(lv <= p.init_n_len, ycov, state.ncov)
        h = pmwf_filters(ncov, ycov - ncov, p.beta, p.diag_load)
        d = apply_filters(h.movedim(-3, -1), y_win[..., p.l_nbr])
        return PmwfStreamState(y_win=y_win, ycov=ycov, ncov=ncov, l=l), d

    return step


class _Plan:
    """What every multichannel runner holds: config, parameters, dtypes,
    the device and the analysis window."""

    def __init__(self, cfg: PipelineConfig | None,
                 params: PmwfParams | None, dtype, device):
        self.cfg = cfg or default_config()
        self.params = params or PmwfParams()
        self.dtype = dtype
        self.cdtype = complex_dtype(dtype)
        self.device = resolve_device(device)
        self.win = torch.as_tensor(
            sqrt_hann_periodic(self.cfg.signal.framelength), dtype=dtype,
            device=self.device)

    def spectra(self, frames) -> torch.Tensor:
        """(..., T, framelength) frames (array or tensor) -> (..., T, F)."""
        frames = torch.as_tensor(frames, dtype=self.dtype,
                                 device=self.device)
        return analysis(frames, self.win, self.cfg.signal, self.cdtype)

    def waveforms(self, d_seq: torch.Tensor) -> torch.Tensor:
        """(..., T, F) filtered spectra -> (..., n) OLA waveforms."""
        s = self.cfg.signal
        return overlap_add(synthesis(d_seq, self.win, s, self.dtype),
                           s.frameshift)


class PmwfStreamingRun(_Plan):
    """The per-frame plan of the STREAMING semantics: run(frames
    (..., C, T, framelength), state0) -> ((..., C, n) waveforms, state),
    one step a frame.  With a leading lane axis on the frames and the state
    it is the multi-lane run."""

    def __init__(self, cfg=None, params=None, dtype=torch.float32,
                 device=None):
        super().__init__(cfg, params, dtype, device)
        self.step = make_pmwf_stream_step(self.params)

    def __call__(self, frames, state0: PmwfStreamState):
        y = self.spectra(frames)                             # (..., C, T, F)
        state = state0
        d_seq = torch.empty_like(y)
        for i in range(y.shape[-2]):
            state, d_seq[..., i, :] = self.step(state, y[..., i, :])
        return self.waveforms(d_seq), state


def make_pmwf_streaming_run(cfg: PipelineConfig, params: PmwfParams,
                            dtype=torch.float32, device=None):
    """One-shot offline runner of the STREAMING semantics: run(frames
    (C, T, framelength), state0) -> ((C, n) waveforms, state).  Its step is
    literally the session's — the parity oracle the push-based session is
    held to."""
    return PmwfStreamingRun(cfg, params, dtype, device)


def make_pmwf_batch_run(cfg: PipelineConfig, params: PmwfParams,
                        dtype=torch.float32, device=None):
    """Multi-lane form: run(frames (B, C, T, L), states (B-stacked, see
    ``batch_stream_state``)) -> ((B, C, n), states).  Every lane gives the
    bits of its own single-lane run."""
    return PmwfStreamingRun(cfg, params, dtype, device)


FILTER_CHUNK = 2048      # lanes x frames whose filters are solved at once


class PmwfStreamingRunFast(_Plan):
    """The whole-utterance plan of the streaming semantics (module
    docstring).  run(frames (C, T, L) or (B, C, T, L), state0) -> the
    per-frame plan's result.  The filters are solved ``FILTER_CHUNK``
    lanes x frames at a time, which bounds the solve's temporaries."""

    def __call__(self, frames, state0: PmwfStreamState):
        p = self.params
        y = self.spectra(frames)
        single = y.dim() == 3
        if single:
            y = y[None]
            state0 = PmwfStreamState(*(f[None] for f in state0))
        b, nc, t, f = y.shape
        ml = 2 * p.l_nbr + 1
        # sliding windows continuing from the carried y_win: window t holds
        # frames [t-2L .. t] (the state's tail before the first input)
        tail = state0.y_win[..., 1:].transpose(-1, -2)       # (B,C,ml-1,F)
        ypad = torch.cat([tail, y], dim=-2)                  # (B,C,T',F)
        # G_tau: each frame's covariance summed over the 2M+1 shifts in
        # order, one channel row at a time (bounded temporaries)
        idx = collapse_index(f, p.m_nbr, y.device)
        z = [ypad[..., idx[m]] for m in range(2 * p.m_nbr + 1)]
        g = torch.empty((b, t + ml - 1, f, nc, nc), dtype=self.cdtype,
                        device=y.device)
        for c in range(nc):
            acc = cmul_conj(z[0][:, c: c + 1], z[0])
            for zm in z[1:]:
                acc = acc + cmul_conj(zm[:, c: c + 1], zm)
            g[..., c, :] = acc.permute(0, 2, 3, 1)
        del z
        # R_t: the window's frames, oldest first; then the running Ycov in
        # place, with the periodic divide where a lane's frame count says
        ycovs = g[:, :t].clone()
        for i in range(1, ml):
            ycovs += g[:, i: i + t]
        del g
        l0 = state0.l.cpu().numpy().astype(np.int64)         # one read
        ls = l0[:, None] + 1 + np.arange(t)[None, :]         # (B, T)
        divs = ls % p.norm_period == 0
        prev = state0.ycov
        for i in range(t):
            cur = ycovs[:, i]
            cur += prev
            if divs[:, i].all():
                cur.copy_(cdiv_real(cur, p.norm_period - 1))
            elif divs[:, i].any():
                on = torch.as_tensor(divs[:, i], device=y.device)
                cur.copy_(torch.where(on[:, None, None, None],
                                      cdiv_real(cur, p.norm_period - 1),
                                      cur))
            prev = cur
        # frozen Ncov: the Ycov value at l == init_n_len — inside this call
        # if the lane crosses it here, else the carried state
        stop = p.init_n_len - l0 - 1
        frozen = torch.stack([
            ycovs[k, min(int(stop[k]), t - 1)] if stop[k] >= 0
            else state0.ncov[k] for k in range(b)])           # (B,F,C,C)
        in_init = torch.as_tensor(ls <= p.init_n_len, device=y.device)
        centers = ypad[..., p.l_nbr: p.l_nbr + t, :]         # (B,C,T,F)
        d_seq = torch.empty_like(y)
        step = max(1, FILTER_CHUNK // b)
        for t0 in range(0, t, step):
            sl = slice(t0, min(t, t0 + step))
            yc = ycovs[:, sl]
            ncov = torch.where(in_init[:, sl, None, None, None], yc,
                               frozen[:, None])
            h = pmwf_filters(ncov, yc - ncov, p.beta, p.diag_load)
            d = apply_filters(h.movedim(-3, -1),
                              centers[:, :, sl].transpose(1, 2))
            d_seq[:, :, sl] = d.transpose(1, 2)
        last = ycovs[:, t - 1]
        done = torch.as_tensor(l0 + t <= p.init_n_len, device=y.device)
        state = PmwfStreamState(
            y_win=ypad[..., t - 1: t - 1 + ml, :].transpose(-1, -2).clone(),
            ycov=last.clone(),
            ncov=torch.where(done[:, None, None, None], last, frozen),
            l=state0.l + t)
        out = self.waveforms(d_seq)
        if single:
            return out[0], PmwfStreamState(*(fld[0] for fld in state))
        return out, state


def make_pmwf_streaming_run_fast(cfg: PipelineConfig, params: PmwfParams,
                                 dtype=torch.float32, device=None):
    """Whole-utterance plan of the streaming semantics: run(frames
    (C, T, L), state0) -> ((C, n), state), the per-frame plan's bits."""
    return PmwfStreamingRunFast(cfg, params, dtype, device)


def make_pmwf_batch_run_fast(cfg: PipelineConfig, params: PmwfParams,
                             dtype=torch.float32, device=None):
    """The whole-utterance plan over a lane axis: run(frames
    (B, C, T, L), states (B-stacked)) — the deployment shape of the
    reference's multichannel bench rows."""
    return PmwfStreamingRunFast(cfg, params, dtype, device)


class PmwfStreamingSession:
    """Push-based real-time multichannel PMWF enhancement.

    push(samples (C, n)) consumes int16-scale multichannel audio in any
    chunking and returns finalized (C, m) enhanced samples, bit-identical
    to the one-shot per-frame plan on the same stream: each block runs the
    same step over its valid frames, and a hop is added up from its frames
    in the compute dtype in the one-shot overlap-add's order.  (The
    reference's session adds in float64 on the host, so its float32 output
    can differ from its one-shot run by a rounding.)  Latency = the engine
    delay + the beamformer's L-frame lookahead (the emitted frame is the
    window center).  The state lies on the card unless ``device`` names
    another.
    """

    def __init__(self, cfg: PipelineConfig | None = None,
                 params: PmwfParams | None = None, n_ch: int = 6,
                 block_frames: int = 8, dtype=torch.float32, device=None):
        self._run = PmwfStreamingRun(cfg, params, dtype, device)
        self.cfg, self.params = self._run.cfg, self._run.params
        self.dtype, self.device = dtype, self._run.device
        self._s = self.cfg.signal
        self._delay = self.cfg.delay
        self.n_ch = n_ch
        self._block = max(int(block_frames), 1)
        self.reset()

    @property
    def block_frames(self) -> int:
        return self._block

    def reset(self, state: PmwfStreamState | None = None) -> None:
        s = self._s
        self._queue = np.zeros((self.n_ch, s.framelength))
        self._hold = np.zeros((self.n_ch, 0))
        # the frames before the newest, newest first: a hop is final once
        # the frame it opens has come
        self._recent = np.zeros(
            (s.framelength // s.frameshift - 1, self.n_ch, s.framelength),
            np.float64 if self.dtype == torch.float64 else np.float32)
        self._l = 0
        self._pending: list[np.ndarray] = []
        self.state = state if state is not None else pmwf_stream_init(
            self.params, self.n_ch, s.n_bins, self._run.cdtype, self.device)

    def _flush_pending(self) -> list[np.ndarray]:
        if not self._pending:
            return []
        s = self._s
        k = len(self._pending)
        y = self._run.spectra(np.stack(self._pending))       # (K, C, F)
        d_seq = torch.empty_like(y)
        for i in range(k):
            self.state, d_seq[i] = self._run.step(self.state, y[i])
        # per-frame synthesis; the overlap-add on the host
        outs = synthesis(d_seq, self._run.win, s, self.dtype).cpu().numpy()
        self._pending = []
        l0 = self._l - k + 1
        hs = s.frameshift
        emitted = []
        for i in range(k):
            # chunk c of the frame c hops back, in c order (overlap_add's)
            hop = outs[i][:, :hs]
            for c, prev in enumerate(self._recent, start=1):
                hop = hop + prev[:, c * hs: (c + 1) * hs]
            self._recent = np.concatenate([outs[i][None],
                                           self._recent[:-1]])
            if l0 + i > self._delay:
                emitted.append(hop.astype(np.float64))
        return emitted

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """samples: (C, n) int16-scale; returns (C, m) finalized output."""
        s = self._s
        samples = np.atleast_2d(np.asarray(samples, np.float64))
        buf = np.concatenate([self._hold, samples], axis=1)
        outs = []
        while buf.shape[1] >= s.frameshift:
            hop, buf = buf[:, : s.frameshift], buf[:, s.frameshift:]
            self._queue = np.concatenate(
                [self._queue[:, s.frameshift:], hop], axis=1)
            self._l += 1
            self._pending.append(self._queue.copy())
            if len(self._pending) >= self._block:
                outs.extend(self._flush_pending())
        self._hold = buf
        y = (np.concatenate(outs, axis=1) if outs
             else np.zeros((self.n_ch, 0)))
        return matlab_int16_write(y) if quantize else y

    def flush(self, quantize: bool = True) -> np.ndarray:
        """EOF: drain delay+1 zero-queue flush frames plus the partial
        block (same contract as the single-channel session)."""
        s = self._s
        self._hold = np.zeros((self.n_ch, 0))
        outs = []
        for _ in range(self._delay + 1):
            self._queue = np.zeros((self.n_ch, s.framelength))
            self._l += 1
            self._pending.append(self._queue.copy())
            if len(self._pending) >= self._block:
                outs.extend(self._flush_pending())
        outs.extend(self._flush_pending())
        y = (np.concatenate(outs, axis=1) if outs
             else np.zeros((self.n_ch, 0)))
        return matlab_int16_write(y) if quantize else y


def pmwf_streaming_enhance(x: np.ndarray, cfg: PipelineConfig | None = None,
                           params: PmwfParams | None = None,
                           dtype=torch.float32, quantize: bool = True,
                           state: PmwfStreamState | None = None,
                           return_state: bool = False, fast: bool = False,
                           device=None):
    """Offline convenience wrapper of the STREAMING semantics on one
    (C, n) utterance — frames exactly like PmwfEnhancer.enhance and trims
    the same delay.  ``fast=True`` takes the whole-utterance plan (the same
    bits, one call instead of a loop over frames)."""
    cfg = cfg or default_config()
    params = params or PmwfParams()
    x = np.atleast_2d(np.asarray(x, np.float64))
    frames = frames_of(x, cfg)
    run = (make_pmwf_streaming_run_fast if fast
           else make_pmwf_streaming_run)(cfg, params, dtype, device)
    st0 = state if state is not None else pmwf_stream_init(
        params, x.shape[0], cfg.signal.n_bins, run.cdtype, run.device)
    y, st = run(frames, st0)
    emit = emit_samples(y.cpu().numpy(), frames.shape[1], cfg,
                        params.ref_ch)
    out = matlab_int16_write(emit) if quantize else emit
    return (out, st) if return_state else out


# ---------------------------------------------------------------------------
# Online NTF channel-loading tracking (GIST_NTF.m:88-129 C-step, streaming)
# ---------------------------------------------------------------------------

class NtfOnlineState(NamedTuple):
    c: torch.Tensor      # (C, K) channel loadings, carried across blocks
    l: torch.Tensor      # int32 blocks consumed


def make_ntf_online_step(b: torch.Tensor, *, sparsity: float = 5.0,
                         inner_iters: int = 4, flr: float = 1e-9):
    """Per-block online C-step: a fixed number of KL multiplicative
    channel-loading updates on the incoming block tensor, warm-started
    from the carried loadings — the streaming form of GIST_NTF_C.m's
    C_UPDATE branch (A fixed at ones, the shipped config).  The spectral
    basis ``b`` (N, K) tensor is fixed and L2-normalized once here, exactly
    as the batch solver does at entry (GIST_NTF_C.m:27-30).

    step(state, s_blk (C, N, M)) -> (state', c) — c is the post-update
    loading snapshot for the block."""
    bn = torch.sqrt(torch.sum(b * b, dim=0))
    b = b / torch.where(bn > 0, bn, torch.ones_like(bn))
    sum_b = torch.sum(b, dim=0)

    def step(state: NtfOnlineState, s_blk: torch.Tensor):
        a = torch.ones((s_blk.shape[2], b.shape[1]), dtype=s_blk.dtype,
                       device=s_blk.device)
        oba = torch.clamp_min((sum_b * torch.sum(a, dim=0))[None, :], flr)
        c = state.c.to(s_blk.dtype)
        for _ in range(inner_iters):
            xh = torch.clamp_min(cnm_product(c, b, a), flr)
            pt = torch.clamp_min(s_blk / xh, flr)
            pba = torch.clamp_min(torch.sum((pt @ a) * b[None], dim=1), flr)
            c = torch.clamp_min(c * pba / (oba + sparsity), flr)
        return NtfOnlineState(c=c, l=state.l + 1), c

    return step


class NtfStreamingSession:
    """Block-push online NTF channel-loading tracker.

    push_block(s_blk (C, N, M)) runs ``inner_iters`` warm-started C-updates
    and returns the updated (C, K) loadings.  On a stationary stream the
    carried loadings converge to the batch ``ntf_solve`` solution.  On the
    card unless ``device`` names another."""

    def __init__(self, b: np.ndarray, n_ch: int, *, sparsity: float = 5.0,
                 inner_iters: int = 4, c0: np.ndarray | None = None,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        self.dtype, self.device = dtype, device
        b = torch.as_tensor(np.asarray(b), dtype=dtype, device=device)
        bn = np.sqrt(np.sum(b.cpu().numpy() ** 2, axis=0))
        c_init = (torch.as_tensor(np.asarray(c0), dtype=dtype, device=device)
                  if c0 is not None
                  else torch.as_tensor(default_c_init(n_ch, b.shape[1]),
                                       dtype=dtype, device=device)
                  * torch.as_tensor(bn, dtype=dtype, device=device)[None, :])
        self.state = NtfOnlineState(
            c=c_init, l=torch.tensor(0, dtype=torch.int32, device=device))
        self._step = make_ntf_online_step(b, sparsity=sparsity,
                                          inner_iters=inner_iters)

    @property
    def loadings(self) -> np.ndarray:
        return self.state.c.cpu().numpy()

    def _blocks(self, s) -> torch.Tensor:
        return torch.as_tensor(np.asarray(s) if not torch.is_tensor(s)
                               else s, dtype=self.dtype, device=self.device)

    def push_block(self, s_blk: np.ndarray) -> np.ndarray:
        self.state, c = self._step(self.state, self._blocks(s_blk))
        return c.cpu().numpy()

    def push_blocks(self, s_blks: np.ndarray) -> np.ndarray:
        """Consume MANY blocks in one call: one upload, the same step over
        the leading block axis, one download — the bits of ``push_block``
        per block.  s_blks: (B, C, N, M).  Returns the (B, C, K) loading
        snapshots."""
        blks = self._blocks(s_blks)
        cs = []
        for blk in blks:
            self.state, c = self._step(self.state, blk)
            cs.append(c)
        return torch.stack(cs).cpu().numpy()
