"""Offline / batched enhancement (port of
``se_snmf_nat_tpu.stream.pipeline``): the block-adaptive plan
(``block_adapt > 0``) and the non-adaptive fast plan (``block_adapt=0`` on
a config where ``supports_fast_plan`` holds).

  host:   int16-scale samples -> zero-padded sample matrix
  device: framing -> analysis -> block-adaptive or fast run -> synthesis
          -> OLA -> MATLAB-exact int16 write
  host:   delay trim -> wavwrite requantisation

Utterances batch as lanes; right-padding with zero frames is inert because
padding frames leave the state untouched (block plan) or are independent
columns (fast plan), and their outputs are sliced off.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from se_snmf_nat_tpu_torch.config import PipelineConfig, default_config
from se_snmf_nat_tpu_torch.device import full_f32, resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import (
    pack_samples_for_upload, stream_frames, stream_frames_torch)
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.enhance.state import (
    batch_state, init_engine_state, lane_state)
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.stream.block_adaptive import (
    make_block_adaptive_run)
from se_snmf_nat_tpu_torch.stream.fast_pipeline import (
    make_fast_run, supports_fast_plan)
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write_torch, matlab_wavwrite_quantize)


_EXACT_PLAN = ("the exact per-frame plan (enhance/engine.py), which the "
               "port does not have yet (see ROADMAP.md, modules to port)")


class SnmfEnhancer(nn.Module):
    """SNMF-NAT enhancer on one device (the card unless ``device`` names
    another; ``device="cpu"`` for the CPU): the block-adaptive plan for
    ``block_adapt > 0``, else the fast plan where ``supports_fast_plan``
    holds.

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
        if block_adapt <= 0 and not supports_fast_plan(self.cfg):
            raise NotImplementedError(
                f"block_adapt=0 on a config with an adaptive dictionary "
                f"selects {_EXACT_PLAN}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.frame_bucket = max(int(frame_bucket), 1)
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
        else:
            self.fast_run = make_fast_run(self.cfg, b1_x, b1_d, b2_x, b2_d,
                                          self.device, dtype, dft_matmul)
            self.register_buffer("win", torch.as_tensor(
                sqrt_hann_periodic(self.cfg.signal.framelength), dtype=dtype,
                device=self.device))
        self._state0 = init_engine_state(
            self.cfg, b1_d, self.cfg.signal.n_bins, self.device, dtype,
            matlab_ad_blk_init)

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
        exact plan, which raises."""
        s = self.cfg.signal
        if self.fast_run is not None and (state is not None or return_state):
            raise NotImplementedError(
                f"a carried state on a fixed-dictionary config selects "
                f"{_EXACT_PLAN}")
        true_frames = self.frames_for(x)
        t = true_frames.shape[0]
        frames = torch.as_tensor(self._pad_frames(true_frames),
                                 dtype=self.dtype, device=self.device)
        st_out = None
        if self.fast_run is not None:
            y = self.fast_run(frames[None], self.win)
        else:
            st = batch_state(state if state is not None else self._state0, 1)
            y, st_out = self.run(frames[None], st,
                                 torch.tensor([t], device=self.device))
        start = self.cfg.delay * s.frameshift
        emit = y[0, start: start + (t - self.cfg.delay) * s.frameshift]
        emit = emit.cpu().numpy()
        out = enhanced_quantize(emit) if quantize else emit
        return (out, lane_state(st_out, 0)) if return_state else out

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
        states = batch_state(self._state0, mb) if self.run is not None \
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
            else:
                ys, _ = self.run(frames, states,
                                 torch.as_tensor(tt, device=self.device))
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
