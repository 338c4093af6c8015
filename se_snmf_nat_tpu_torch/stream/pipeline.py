"""Offline / batched enhancement (port of
``se_snmf_nat_tpu.stream.pipeline``): the block-adaptive plan
(``block_adapt > 0``), the non-adaptive fast plan (``block_adapt=0`` on a
config where ``supports_fast_plan`` holds) and the exact per-frame plan
(``block_adapt=0`` on every other config, and wherever a state is carried
in or out).

  host:   int16-scale samples -> zero-padded sample matrix
  device: framing -> analysis -> block-adaptive run, fast run or the frame
          loop over ``Engine.step`` -> synthesis -> OLA -> MATLAB-exact
          int16 write
  host:   delay trim -> wavwrite requantisation

Utterances batch as lanes; right-padding with zero frames is inert because
padding frames leave the state untouched (block and exact plans) or are
independent columns (fast plan), and their outputs are sliced off.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from se_snmf_nat_tpu_torch.config import PipelineConfig, default_config
from se_snmf_nat_tpu_torch.device import full_f32, resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import (
    analysis_frames, dft_matrices_stacked, overlap_add,
    pack_samples_for_upload, stream_frames, stream_frames_torch,
    synthesis_frames)
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.enhance.engine import make_engine
from se_snmf_nat_tpu_torch.enhance.state import (
    EngineState, batch_state, lane_state)
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.stream.block_adaptive import (
    make_block_adaptive_run)
from se_snmf_nat_tpu_torch.stream.fast_pipeline import (
    make_fast_run, supports_fast_plan)
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write_torch, matlab_wavwrite_quantize)


class SnmfEnhancer(nn.Module):
    """SNMF-NAT enhancer on one device (the card unless ``device`` names
    another; ``device="cpu"`` for the CPU): the block-adaptive plan for
    ``block_adapt > 0``; else the fast plan where ``supports_fast_plan``
    holds and no state is carried, and the exact per-frame plan (a loop over
    ``self.engine.step``) everywhere else.

    Bases are (F, r) arrays or tensors.  ``dft_precision`` and
    ``idft_precision`` name TPU matmul precisions and are accepted for the
    reference's signature; on this port every product runs in full f32."""

    def __init__(self, cfg: PipelineConfig | None, b1_x, b1_d, b2_x, b2_d,
                 device=None, dtype=torch.float32,
                 matlab_ad_blk_init: bool = True, frame_bucket: int = 128,
                 block_adapt: int = 0, block_iter_cap: int = 0,
                 dft_matmul: bool = False, block_refit_cap: int = 0,
                 block_fixed_iter: bool = False,
                 dft_precision: str | None = None,
                 idft_precision: str | None = None):
        super().__init__()
        del dft_precision, idft_precision
        full_f32()
        self.cfg = cfg or default_config()
        s = self.cfg.signal
        self.device = resolve_device(device)
        self.dtype = dtype
        self.dft_matmul = bool(dft_matmul)
        self.frame_bucket = max(int(frame_bucket), 1)
        self.block_iter_cap = block_iter_cap if block_adapt > 0 else 0
        self._bases = (b1_x, b1_d, b2_x, b2_d)
        self.engine = make_engine(self.cfg, b1_x, b1_d, b2_x, b2_d,
                                  self.device, dtype)
        self._source_engine = None          # built by separate()

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self.register_buffer("win", t(sqrt_hann_periodic(s.framelength)))
        # the exact plan's transforms as products (the block and fast runs
        # hold their own operands)
        cs, cisi = (map(t, dft_matrices_stacked(s.framelength, s.fftlength))
                    if self.dft_matmul else (None, None))
        self.register_buffer("cs", cs)
        self.register_buffer("cisi", cisi)
        self.run = self.fast_run = None
        if block_adapt > 0:
            if self.frame_bucket % block_adapt:
                # padding frames are inert, so round up to block alignment
                self.frame_bucket = (-(-self.frame_bucket // block_adapt)
                                     * block_adapt)
            self.run = make_block_adaptive_run(
                self.cfg, b1_x, b1_d, b2_x, b2_d, self.device, dtype,
                block_adapt, block_iter_cap, dft_matmul=dft_matmul,
                refit_iter_cap=block_refit_cap, fixed_iter=block_fixed_iter)
        elif supports_fast_plan(self.cfg):
            self.fast_run = make_fast_run(self.cfg, b1_x, b1_d, b2_x, b2_d,
                                          self.device, dtype, dft_matmul)
        self._state0 = self.engine.init_state(dtype, matlab_ad_blk_init)

    def _analysis(self, frames: torch.Tensor):
        s = self.cfg.signal
        return analysis_frames(
            frames, self.win, s.fftlength, s.pow, s.dc_bin, s.nonzerofloor,
            s.preemph, dft_matmul=self.dft_matmul, cs=self.cs)

    def _synthesis(self, xm: torch.Tensor, phase: torch.Tensor):
        s = self.cfg.signal
        return synthesis_frames(
            xm, phase, s.framelength, s.fftlength, self.win, s.pow,
            s.dc_bin_back, s.overlapscale, s.preemph,
            dft_matmul=self.dft_matmul, cisi=self.cisi)

    def frame_loop(self, engine, mag: torch.Tensor, state: EngineState,
                   n_valid, l0=1):
        """The exact plan's loop over ``engine.step`` on spectra
        mag (B, T, F), frame t carrying the number ``l0 + t``: ``l0`` is one
        host integer, or a (B,) integer tensor on the state's device with
        each lane's own first number (then no step reads a device value on
        the host, see ``Engine.step``).  ``n_valid``
        (B host integers) counts each lane's real frames: past them a lane's
        state stays as it is and its output is zero, and past the longest
        lane nothing runs.  Returns (state, outputs): each output of the
        step stacked over the frames, (B, T, ...)."""
        n_valid = np.asarray(n_valid).reshape(-1)
        n_lanes, t = mag.shape[:2]
        outs = []
        for i in range(min(t, int(n_valid.max()))):
            new_state, out = engine.step(state, mag[:, i], l0 + i)
            out = out if isinstance(out, tuple) else (out,)
            if i >= int(n_valid.min()):
                valid = torch.as_tensor(i < n_valid, device=mag.device)

                def sel(a, b):
                    return torch.where(
                        valid.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                new_state = EngineState(*map(sel, new_state, state))
                out = tuple(sel(o, torch.zeros_like(o)) for o in out)
            state = new_state
            outs.append(out)
        stacked = []
        for k, first in enumerate(outs[0]):
            seq = torch.stack([o[k] for o in outs], dim=1)
            pad = first.new_zeros((n_lanes, t - len(outs)) + first.shape[1:])
            stacked.append(torch.cat([seq, pad], dim=1))
        return state, tuple(stacked)

    def _run_exact(self, frames: torch.Tensor, state: EngineState, n_valid):
        """Analysis, the frame loop, synthesis and overlap-add of
        frames (B, T, L): (y (B, S), state)."""
        mag, phase = self._analysis(frames)
        state, (xm,) = self.frame_loop(self.engine, mag, state, n_valid)
        return overlap_add(self._synthesis(xm, phase),
                           self.cfg.signal.frameshift), state

    def _pad_frames(self, frames: np.ndarray) -> np.ndarray:
        t = frames.shape[0]
        t_pad = -(-t // self.frame_bucket) * self.frame_bucket
        if t_pad == t:
            return frames
        return np.concatenate(
            [frames, np.zeros((t_pad - t,) + frames.shape[1:])], axis=0)

    def frames_for(self, x: np.ndarray) -> np.ndarray:
        s = self.cfg.signal
        return stream_frames(x, s.framelength, s.frameshift,
                             n_flush=self.cfg.delay + 1)

    def initial_state(self):
        return self._state0

    @torch.no_grad()
    def enhance(self, x: np.ndarray, state=None, return_state: bool = False,
                quantize: bool = True):
        """Enhance one utterance of int16-scale samples (NumPy in, NumPy
        out); ``state`` is an unbatched ``EngineState``.  The fast plan
        carries no state: ``state`` and ``return_state`` there select the
        exact plan."""
        s = self.cfg.signal
        true_frames = self.frames_for(x)
        t = true_frames.shape[0]
        frames = torch.as_tensor(self._pad_frames(true_frames),
                                 dtype=self.dtype, device=self.device)
        st_out = None
        if (self.fast_run is not None and state is None
                and not return_state):
            y = self.fast_run(frames[None], self.win)
        else:
            st = batch_state(state if state is not None else self._state0, 1)
            if self.run is not None:
                y, st_out = self.run(frames[None], st,
                                     torch.tensor([t], device=self.device))
            else:
                y, st_out = self._run_exact(frames[None], st, [t])
        start = self.cfg.delay * s.frameshift
        emit = y[0, start: start + (t - self.cfg.delay) * s.frameshift]
        emit = emit.cpu().numpy()
        out = enhanced_quantize(emit) if quantize else emit
        return (out, lane_state(st_out, 0)) if return_state else out

    @torch.no_grad()
    def separate(self, x: np.ndarray, state=None, quantize: bool = True):
        """Source separation on the exact plan: per-event and per-noise
        waveforms beside the enhanced signal, each source's NMF
        reconstruction synthesised with the noisy phase.  Returns a dict with
        keys 'enhanced', 'events' (one per ``cfg.sep.event_rank`` block) and
        'noises' (one per ``noise_rank`` block)."""
        s = self.cfg.signal
        if self._source_engine is None:
            self._source_engine = make_engine(
                self.cfg, *self._bases, self.device, self.dtype,
                emit_sources=True)
        true_frames = self.frames_for(x)
        t = true_frames.shape[0]
        frames = torch.as_tensor(self._pad_frames(true_frames),
                                 dtype=self.dtype, device=self.device)
        st = batch_state(state if state is not None else self._state0, 1)
        mag, phase = self._analysis(frames[None])
        _, (xm, x_srcs, d_srcs) = self.frame_loop(self._source_engine, mag,
                                                  st, [t])
        start = self.cfg.delay * s.frameshift
        stop = start + (t - self.cfg.delay) * s.frameshift

        def emit(m):
            y = overlap_add(self._synthesis(m, phase), s.frameshift)
            y = y[0, start:stop].cpu().numpy()
            return enhanced_quantize(y) if quantize else y

        return {"enhanced": emit(xm),
                "events": [emit(x_srcs[:, :, i])
                           for i in range(x_srcs.shape[2])],
                "noises": [emit(d_srcs[:, :, i])
                           for i in range(d_srcs.shape[2])]}

    @torch.no_grad()
    def enhance_batch(self, xs: list[np.ndarray], quantize: bool = True,
                      micro_batch: int | None = 32):
        """Enhance a batch of utterances (padded to the longest bucket).

        Raw samples go to the device (int16 when exact) and int16 PCM comes
        back: framing and the MATLAB int16 write run on the device.
        ``micro_batch`` splits the batch into fixed-size chunks, all
        enqueued before any result is fetched; the tail chunk is padded
        with silent lanes.  None = one chunk.  With ``quantize=False`` the
        floats returned are the int16-written values."""
        s = self.cfg.signal
        shift = s.frameshift
        n_flush = self.cfg.delay + 1
        n_hops_all = np.asarray([len(x) // shift for x in xs], np.int64)
        t_true_all = n_hops_all + n_flush
        t_max = -(-int(t_true_all.max()) // self.frame_bucket) \
            * self.frame_bucket
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        mb = len(xs) if not micro_batch else min(int(micro_batch), len(xs))
        states = batch_state(self._state0, mb) if self.fast_run is None \
            else None

        def dispatch(chunk, n_hops, t_true):
            n = len(chunk)
            smp = np.zeros((mb, t_max * shift), np.float64)
            for i, x in enumerate(chunk):
                m = int(n_hops[i]) * shift       # trailing partial hop drops
                smp[i, :m] = np.asarray(x)[:m]
            nh = np.zeros((mb,), np.int64)
            nh[:n] = n_hops
            tt = np.full((mb,), n_flush, np.int64)
            tt[:n] = t_true
            smp_dev = torch.as_tensor(pack_samples_for_upload(smp, np_dt),
                                      device=self.device).to(self.dtype)
            frames = stream_frames_torch(
                smp_dev, torch.as_tensor(nh, device=self.device),
                s.framelength, shift)
            if self.fast_run is not None:
                ys = self.fast_run(frames, self.win)
            elif self.run is not None:
                ys, _ = self.run(frames, states,
                                 torch.as_tensor(tt, device=self.device))
            else:
                ys, _ = self._run_exact(frames, states, tt)
            return matlab_int16_write_torch(ys)  # on the device, not fetched

        pending = [dispatch(xs[c0: c0 + mb], n_hops_all[c0: c0 + mb],
                            t_true_all[c0: c0 + mb])
                   for c0 in range(0, len(xs), mb)]
        outs = []
        start = self.cfg.delay * shift
        for ci, ys_dev in enumerate(pending):
            ys = ys_dev.cpu().numpy()
            for i in range(min(mb, len(xs) - ci * mb)):
                g = ci * mb + i
                emit = ys[i, start: start
                          + (int(t_true_all[g]) - self.cfg.delay) * shift]
                outs.append(matlab_wavwrite_quantize(
                    emit.astype(np.float64) / 32767.0) if quantize
                    else emit.astype(np.float64))
        return outs
