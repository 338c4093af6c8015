"""Offline / batched enhancement (port of
``se_snmf_nat_tpu.stream.pipeline``): the block-adaptive plan
(``block_adapt > 0``), the non-adaptive fast plan (``block_adapt=0`` on a
config where ``supports_fast_plan`` holds) and the exact per-frame plan
(``block_adapt=0`` on every other config, and wherever a state is carried
in or out).

  host:   each lane's true samples as int16, packed into a page-locked
          buffer (float lanes: one exactness test; else the float sample
          matrix)
  device: the zero-padded sample matrix -> framing -> analysis ->
          block-adaptive run, fast run or the frame loop over
          ``Engine.step`` -> synthesis -> OLA -> MATLAB-exact int16 write ->
          wavwrite requantisation (a table gather)
  host:   int16 PCM into a page-locked buffer -> delay trim, a copy a lane

Utterances batch as lanes; right-padding with zero frames is inert because
padding frames leave the state untouched (block and exact plans) or are
independent columns (fast plan), and their outputs are sliced off.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch import nn

from se_snmf_nat_tpu_torch.config import PipelineConfig, default_config
from se_snmf_nat_tpu_torch.device import full_f32, host_array, resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import (
    analysis_frames, dft_matrices_stacked, overlap_add,
    pack_samples_for_upload, stream_frames, stream_frames_torch,
    synthesis_frames)
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.enhance.engine import make_engine
from se_snmf_nat_tpu_torch.enhance.state import (
    EngineState, batch_state, lane_state)
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.runtime.profiling import count, request, stage
from se_snmf_nat_tpu_torch.stream.block_adaptive import (
    BlockStep, make_block_adaptive_run, make_block_step, ring_ptr0,
    rings_to_shift_layout)
from se_snmf_nat_tpu_torch.stream.fast_pipeline import (
    make_fast_run, supports_fast_plan)
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write_torch, matlab_wavwrite_table)


def _pow2(n: int) -> int:
    """The least power of two at or above ``n`` (1 for 0)."""
    return 1 << max(n - 1, 0).bit_length()


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
        self._options = dict(
            dtype=dtype, matlab_ad_blk_init=matlab_ad_blk_init,
            frame_bucket=frame_bucket, block_adapt=block_adapt,
            block_iter_cap=block_iter_cap, dft_matmul=dft_matmul,
            block_refit_cap=block_refit_cap,
            block_fixed_iter=block_fixed_iter)
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
        self._session_steps: dict[int, BlockStep] = {}   # by block_step()

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
        # enhance_batch's host half: the wavwrite requantisation as a table,
        # host buffers and a column index kept across calls
        self._wav_table = torch.as_tensor(matlab_wavwrite_table(),
                                          device=self.device)
        self._host_bufs: dict[str, torch.Tensor] = {}
        self._cols = torch.zeros(0, dtype=torch.int64, device=self.device)
        self._batch_lock = threading.Lock()

    def _host_buffer(self, key: str, n: int, dtype) -> torch.Tensor:
        """The first ``n`` elements of the host buffer ``key``, kept across
        calls (page-locked when this enhancer is on a card), grown to a
        power of two when short."""
        buf = self._host_bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = self._host_bufs[key] = torch.empty(
                _pow2(n), dtype=dtype, pin_memory=self.device.type == "cuda")
        return buf[:n]

    def _columns(self, n: int) -> torch.Tensor:
        """0..n-1 (int64) on the device, kept across calls."""
        if self._cols.numel() < n:
            self._cols = torch.arange(_pow2(n), device=self.device)
        return self._cols[:n]

    def on_device(self, device) -> "SnmfEnhancer":
        """This enhancer on ``device``: itself when it is there, else one
        built anew with the same configuration, bases and options."""
        device = torch.device(device)
        if device == self.device:
            return self
        return SnmfEnhancer(self.cfg, *self._bases, device=device,
                            **self._options)

    def analysis(self, frames: torch.Tensor):
        """Frames (..., T, L) -> (magnitude, phase) spectra (..., T, F)."""
        s = self.cfg.signal
        return analysis_frames(
            frames, self.win, s.fftlength, s.pow, s.dc_bin, s.nonzerofloor,
            s.preemph, dft_matmul=self.dft_matmul, cs=self.cs)

    def synthesis(self, xm: torch.Tensor, phase: torch.Tensor):
        """(magnitude, phase) (..., T, F) -> windowed frames (..., T, L)."""
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
        mag, phase = self.analysis(frames)
        state, (xm,) = self.frame_loop(self.engine, mag, state, n_valid)
        return overlap_add(self.synthesis(xm, phase),
                           self.cfg.signal.frameshift), state

    def run_frames(self, frames: torch.Tensor, states=None, t_valid=None):
        """The batch program on lanes of frames (B, T, L) on this device:
        the fast plan where it exists and ``states`` is None; else the block
        plan or the exact loop from ``states`` (batched; B initial states
        when None), with ``t_valid`` (B host integers) real frames a lane
        (all T when None).  Returns (y (B, S), state, None on the fast
        plan)."""
        n_lanes, t = frames.shape[:2]
        if self.fast_run is not None and states is None:
            return self.fast_run(frames, self.win), None
        if states is None:
            states = batch_state(self._state0, n_lanes)
        t_valid = [t] * n_lanes if t_valid is None else t_valid
        if self.run is not None:
            return self.run(frames, states,
                            torch.as_tensor(t_valid, device=self.device))
        return self._run_exact(frames, states, t_valid)

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

    def block_step(self, k_block: int) -> BlockStep:
        """The block-adaptive step of ``k_block`` frames for this enhancer's
        push sessions, built once a K: its CUDA graphs (one a lane count)
        serve every session, whose replays run in turn and copy their
        outputs out.  It takes ``block_iter_cap`` only (no refit cap, no
        fixed trips), as the reference's sessions build theirs."""
        step = self._session_steps.get(k_block)
        if step is None:
            step = self._session_steps[k_block] = make_block_step(
                self.cfg, *self._bases, self.device, self.dtype,
                k_block=k_block, iter_cap=self.block_iter_cap)
        return step

    def session_block(self, frames: torch.Tensor, state: EngineState,
                      ring_ptr, l0, step: BlockStep | None = None):
        """A push session's block of frames (B, K, L) numbered from ``l0``
        (as ``frame_loop`` takes it): analysis, then ``step`` on a block of
        ``step.k_block`` frames, else the exact loop on the rings in shift
        layout (the pointers restart), then synthesis.  Returns (state,
        ring pointers, synthesised frames)."""
        n, k = frames.shape[:2]
        mag, phase = self.analysis(frames)
        if step is not None and k == step.k_block:
            ls = torch.arange(k, device=self.device) + (
                l0[:, None] if torch.is_tensor(l0) else l0)
            state, ring_ptr, xm = step(
                state, ring_ptr, mag, ls,
                torch.ones((n, k), dtype=torch.bool, device=self.device))
        else:
            if step is not None:
                state = rings_to_shift_layout(state, ring_ptr)
                ring_ptr = ring_ptr0(n, self.device)
            state, (xm,) = self.frame_loop(self.engine, mag, state, [k] * n,
                                           l0)
        return state, ring_ptr, self.synthesis(xm, phase)

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
        st = None                    # the fast plan where there is one
        if state is not None or return_state:
            st = batch_state(state if state is not None else self._state0, 1)
        y, st_out = self.run_frames(frames[None], st, [t])
        start = self.cfg.delay * s.frameshift
        emit = y[0, start: start + (t - self.cfg.delay) * s.frameshift]
        emit = host_array(emit)
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
        mag, phase = self.analysis(frames[None])
        _, (xm, x_srcs, d_srcs) = self.frame_loop(self._source_engine, mag,
                                                  st, [t])
        start = self.cfg.delay * s.frameshift
        stop = start + (t - self.cfg.delay) * s.frameshift

        def emit(m):
            y = overlap_add(self.synthesis(m, phase), s.frameshift)
            y = host_array(y[0, start:stop])
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

        Samples cross the host as int16 at both ends.  Each lane's true
        hops go into one page-locked int16 buffer, packed one after another
        with a zero after each (an int16 lane as it is; a float lane after
        one test that its samples are int16 values), and go up in one copy
        a chunk; on the device one gather lays them into the zero-padded
        sample matrix.  If a float lane is not int16 values, the call
        uploads the float sample matrix instead.  Framing, the MATLAB int16
        write and, with ``quantize``, the wavwrite requantisation (a
        gather of ``matlab_wavwrite_table``) run on the device; the int16
        PCM comes back into a page-locked buffer and each lane's output is
        a copy of its slice.  ``micro_batch`` splits the batch into
        fixed-size chunks, all enqueued before any result is fetched; the
        tail chunk is padded with silent lanes.  None = one chunk.  With
        ``quantize=False`` the floats returned are the int16-written values.

        Traced, the call is tiled by the spans ``batch.prep`` (packing and
        the upload), ``batch.launch`` (the layout, framing, the run, the
        int16 write and requantisation), ``batch.fetch`` (the PCM to the
        host) and ``batch.emit`` (a copy a lane), each chunk with its own
        prep, launch and fetch; the counters ``batch.frames_computed``
        (lanes x the bucket's frames) and ``batch.frames_true`` (the real
        lanes' hops + delay + 1) give the padding, ``batch.lanes`` and
        ``batch.lanes_int16`` the real lanes and those sent as int16."""
        with self._batch_lock, request("batch.prep"):
            s = self.cfg.signal
            shift = s.frameshift
            n_flush = self.cfg.delay + 1
            n_hops_all = np.asarray([len(x) // shift for x in xs], np.int64)
            t_true_all = n_hops_all + n_flush
            t_max = -(-int(t_true_all.max()) // self.frame_bucket) \
                * self.frame_bucket
            np_dt = np.float64 if self.dtype == torch.float64 else np.float32
            mb = len(xs) if not micro_batch else min(int(micro_batch),
                                                     len(xs))
            states = batch_state(self._state0, mb) \
                if self.fast_run is None else None
            # lane g's true samples at [ends[g] - lens[g], ends[g]), a zero
            # at ends[g] (the trailing partial hop drops)
            lens = n_hops_all * shift
            ends = np.cumsum(lens + 1) - 1
            stage_t = self._host_buffer("samples", int(ends[-1]) + 1,
                                        torch.int16)
            packed = stage_t.numpy()
            exact = True
            with np.errstate(invalid="ignore"):
                for x, e, m in zip(xs, ends, lens):
                    a = np.asarray(x)[:m]
                    dst = packed[e - m: e]
                    np.copyto(dst, a, casting="unsafe")
                    packed[e] = 0
                    if a.dtype != np.int16 and not np.array_equal(dst, a):
                        exact = False
                        break
            count("batch.lanes", len(xs))
            count("batch.lanes_int16", len(xs) if exact else 0)
            n_chunks = -(-len(xs) // mb)
            lanes_t = self._host_buffer("lanes", n_chunks * 3 * mb,
                                        torch.int64).view(n_chunks, 3, mb)
            cols = self._columns(t_max * shift)

            def upload(c, g0, g1):
                """Chunk c's packed samples and its lanes' (3, mb) hops,
                first samples and zeros, the last two counted from the
                chunk's first sample (a silent lane's at the last zero), on
                the device."""
                r0, r1 = int(ends[g0] - lens[g0]), int(ends[g1 - 1])
                meta = lanes_t[c].numpy()
                meta[:] = [[0], [r1 - r0], [r1 - r0]]
                meta[0, : g1 - g0] = n_hops_all[g0:g1]
                meta[2, : g1 - g0] = ends[g0:g1] - r0
                meta[1, : g1 - g0] = meta[2, : g1 - g0] - lens[g0:g1]
                return (stage_t[r0: r1 + 1].to(self.device, non_blocking=True),
                        lanes_t[c].to(self.device, non_blocking=True))

            def dispatch(c):
                stage("batch.prep")
                g0, g1 = c * mb, min((c + 1) * mb, len(xs))
                count("batch.frames_computed", mb * t_max)
                count("batch.frames_true", int(t_true_all[g0:g1].sum()))
                tt = np.full((mb,), n_flush, np.int64)
                tt[: g1 - g0] = t_true_all[g0:g1]
                if exact:
                    packed_dev, lanes = upload(c, g0, g1)
                    nh = lanes[0]
                else:
                    smp = np.zeros((mb, t_max * shift), np.float64)
                    for i in range(g1 - g0):
                        smp[i, : lens[g0 + i]] = \
                            np.asarray(xs[g0 + i])[: lens[g0 + i]]
                    nh = np.zeros((mb,), np.int64)
                    nh[: g1 - g0] = n_hops_all[g0:g1]
                    smp_dev = torch.as_tensor(
                        pack_samples_for_upload(smp, np_dt),
                        device=self.device).to(self.dtype)
                stage("batch.launch")
                if exact:       # lane i's samples, then its zero repeated
                    idx = cols + lanes[1, :, None]
                    smp_dev = packed_dev.to(self.dtype)[
                        torch.minimum(idx, lanes[2, :, None], out=idx)]
                frames = stream_frames_torch(
                    smp_dev, torch.as_tensor(nh, device=self.device),
                    s.framelength, shift)
                ys, _ = self.run_frames(frames, states, tt)
                pcm = matlab_int16_write_torch(ys)          # on the device
                # an int16 value indexes the table as a negative index does
                return self._wav_table[pcm.long()] if quantize else pcm

            pending = [dispatch(c) for c in range(n_chunks)]
            outs = []
            start = self.cfg.delay * shift
            for ci, pcm in enumerate(pending):
                stage("batch.fetch")
                host = self._host_buffer("pcm", pcm.numel(), torch.int16)
                ys = host.view(pcm.shape).copy_(pcm).numpy()
                stage("batch.emit")
                for i in range(min(mb, len(xs) - ci * mb)):
                    g = ci * mb + i
                    emit = ys[i, start: start
                              + (int(t_true_all[g]) - self.cfg.delay) * shift]
                    outs.append(emit.copy() if quantize
                                else emit.astype(np.float64))
            return outs
