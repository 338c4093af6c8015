"""Offline / batched enhancement (port of
``se_snmf_nat_tpu.stream.pipeline``): the block-adaptive plan
(``block_adapt > 0``), the non-adaptive fast plan (``block_adapt=0`` on a
config where ``supports_fast_plan`` holds) and the exact per-frame plan
(``block_adapt=0`` on every other config, and wherever a state is carried
in or out).

  host:   the int16 host half (``stream/batch_host.BatchHost``): each
          lane's true samples packed as int16, one upload a chunk
  device: the zero-padded sample matrix -> framing -> analysis ->
          block-adaptive run, fast run or the frame loop over
          ``Engine.step`` -> synthesis -> OLA -> MATLAB-exact int16 write ->
          wavwrite requantisation (a table gather)
  host:   int16 PCM into a page-locked buffer -> delay trim, a copy a lane

Utterances batch as lanes; right-padding with zero frames is inert because
padding frames leave the state untouched (block and exact plans) or are
independent columns (fast plan), and their outputs are sliced off.

On the card the exact plan's frame loop runs as replays of CUDA graphs
(``_FrameGraph``), as the block plan's block step does: ``Engine.step``
launches ~108 kernels a frame, and the host takes longer to launch them
than the card takes to run them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from se_snmf_nat_tpu_torch.config import PipelineConfig, default_config
from se_snmf_nat_tpu_torch.device import full_f32, host_array, resolve_device
from se_snmf_nat_tpu_torch.dsp.stft import (
    analysis_frames, dft_matrices_stacked, overlap_add, stream_frames,
    stream_frames_torch, synthesis_frames)
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.enhance.engine import make_engine
from se_snmf_nat_tpu_torch.enhance.state import (
    EngineState, batch_state, lane_state)
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.kernels.mu import captured_launches, count_replay
from se_snmf_nat_tpu_torch.runtime.profiling import count
from se_snmf_nat_tpu_torch.stream.batch_host import BatchHost
from se_snmf_nat_tpu_torch.stream.block_adaptive import (
    BlockStep, make_block_adaptive_run, make_block_step, ring_ptr0,
    rings_to_shift_layout)
from se_snmf_nat_tpu_torch.stream.fast_pipeline import (
    make_fast_run, supports_fast_plan)

# frames a replay of the graphed loop where it runs more than that (a
# shorter loop takes one graph of its own length): on an H100 a call of 16
# lanes takes the same time within 2% at 8 to 64, and a capture of 16
# frames stays under ~40 ms
FRAME_CHUNK = 16


def frame_chunk(engine, state: EngineState, mag: torch.Tensor,
                l: torch.Tensor, lim: torch.Tensor, masked: bool):
    """``mag.shape[1]`` consecutive steps of ``engine`` on the spectra
    mag (B, C, F), frame c of a lane carrying the number ``l + c`` (l: a
    (B,) int64 tensor).  With ``masked``, a lane whose number has reached
    its ``lim`` (B,), past its last real frame, keeps its state and outputs
    zero, as in ``SnmfEnhancer.frame_loop``.  It reads no device value on
    the host: this is what a ``_FrameGraph`` captures.  Returns (state,
    outputs): each output of the step stacked over the frames, (B, C,
    ...)."""
    outs = []
    for c in range(mag.shape[1]):
        lc = l if c == 0 else l + c
        new_state, out = engine.step(state, mag[:, c], lc)
        out = out if isinstance(out, tuple) else (out,)
        if masked:
            valid = lc < lim
            new_state = EngineState(*(_where_lanes(valid, a, b)
                                      for a, b in zip(new_state, state)))
            out = tuple(_where_lanes(valid, o, torch.zeros_like(o))
                        for o in out)
        state = new_state
        outs.append(out)
    return state, tuple(torch.stack(o, dim=1) if len(o) > 1
                        else o[0].unsqueeze(1) for o in zip(*outs))


def _where_lanes(valid: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """a in the lanes where ``valid`` (B,) holds, else b (a itself where
    the two are one tensor)."""
    if a is b:
        return a
    return torch.where(valid.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _copy_fields(dsts, srcs) -> None:
    """``dst.copy_(src)`` for each pair that is not one tensor, one foreach
    launch a pair of dtypes."""
    groups: dict = {}
    for dst, src in zip(dsts, srcs):
        if dst is not src:
            ds, ss = groups.setdefault((dst.dtype, src.dtype), ([], []))
            ds.append(dst)
            ss.append(src)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class _FrameGraph:
    """``frame_chunk`` of one engine on B lanes, captured as CUDA graphs
    that share their inputs: the state, each lane's next frame number ``l``
    and its limit ``lim`` live in static buffers, which a replay reads and
    rewrites (the chunk's last state, ``l`` advanced by C), so consecutive
    replays chain on the card with no copy between them.  One graph a
    (C, masked); a replay takes its chunk's spectra into that graph's
    buffer and leaves its outputs (B, C, ...) in static buffers that the
    graph's next replay overwrites.  ``load`` puts a caller's state in,
    ``take`` gives a copy of it out that no replay overwrites.

    The graphs of an enhancer share one memory pool: what a replay writes
    of the scratch of another graph, that graph writes afresh when it
    replays, and every buffer a replay leaves for the host is allocated
    outside the pool.  A graph is captured right after the same chunk has
    run eagerly (the warm-up ``torch.cuda.graph`` asks for); the capture
    runs nothing and counts nothing."""

    def __init__(self, state: EngineState, device):
        self.device = device
        self.state = EngineState(*(
            torch.zeros_like(f, memory_format=torch.contiguous_format)
            for f in state))
        n_lanes = state.b_d_head.shape[0]
        self.l = torch.zeros((n_lanes,), dtype=torch.int64, device=device)
        self.lim = torch.zeros_like(self.l)
        self.graphs: dict[tuple[int, bool], tuple] = {}

    def load(self, state: EngineState, l, lim) -> None:
        _copy_fields(self.state, state)
        for buf, v in ((self.l, l), (self.lim, lim)):
            if torch.is_tensor(v):
                buf.copy_(v)
            else:
                buf.fill_(v)

    def take(self) -> EngineState:
        out = EngineState(*map(torch.empty_like, self.state))
        _copy_fields(out, self.state)
        return out

    def capture(self, engine, key: tuple[int, bool], outs, pool) -> None:
        c, masked = key
        state, l, lim = self.state, self.l, self.lim
        mag = torch.zeros((l.shape[0], c, engine.cfg.signal.n_bins),
                          dtype=engine.dtype, device=self.device)
        out_bufs = tuple(torch.zeros_like(o) for o in outs)

        # the body holds no reference to self: a cycle through the graph
        # would leave its release to the cyclic collector, which may run
        # inside a later capture, where a graph may not be reset
        def body():
            st, got = frame_chunk(engine, state, mag, l, lim, masked)
            _copy_fields(state, st)
            _copy_fields(out_bufs, got)
            l.add_(c)

        with torch.cuda.device(self.device):    # the capture stream's card
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), captured_launches() as tally, \
                    torch.cuda.graph(graph, pool=pool):
                body()
        self.graphs[key] = (graph, mag, out_bufs, dict(tally), body)

    def replay(self, key: tuple[int, bool], mag: torch.Tensor):
        graph, buf, outs, launches, _ = self.graphs[key]
        buf.copy_(mag)
        with torch.cuda.device(self.device):
            graph.replay()
        count_replay(launches)
        return outs


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
        # the frame loop on the kernel route as CUDA graph replays: one
        # _FrameGraph an (engine, lanes), all in one memory pool
        self._graph_frames = self.device.type == "cuda"
        self._frame_graphs: dict[tuple, _FrameGraph] = {}
        self._frame_pool = None

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
        # enhance_batch's host half, its buffers kept across calls
        self._batch_host = BatchHost(self.device, dtype, s.frameshift,
                                     self.cfg.delay, self.frame_bucket)
        self._host_bufs = self._batch_host._bufs

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
        step stacked over the frames, (B, T, ...).

        On the card, where both of the engine's solvers are kernels, the
        loop runs as replays of CUDA graphs of ``frame_chunk``
        (``_graphed_frame_loop``); elsewhere step by step.  Counters:
        ``frame.steps`` (the frames stepped) and ``frame.steps_graphed``
        (those of them stepped inside a replay)."""
        n_valid = np.asarray(n_valid).reshape(-1)
        n_lanes, t = mag.shape[:2]
        n_run = min(t, int(n_valid.max()))
        count("frame.steps", n_run)
        if (self._graph_frames
                and engine.h_solver == engine.w_solver == "kernel"):
            return self._graphed_frame_loop(engine, mag, state, n_valid, l0,
                                            n_run)
        outs = []
        for i in range(n_run):
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

    def _graphed_frame_loop(self, engine, mag: torch.Tensor,
                            state: EngineState, n_valid: np.ndarray, l0,
                            n_run: int):
        """``frame_loop`` as replays of its ``_FrameGraph``: chunks of
        ``FRAME_CHUNK`` frames (all ``n_run`` where fewer), the tail a chunk
        of its own length; a chunk that reaches past the shortest lane's
        end takes the masked graph.  The state goes into the graphs' buffers
        once a call and comes out once; between replays it stays on the
        card.  The first chunk of each (lanes, C, masked) runs eagerly
        through ``frame_chunk`` and is then captured."""
        n_lanes, t = mag.shape[:2]
        dev = mag.device
        fg = self._frame_graphs.get((engine, n_lanes))
        if fg is None:
            fg = self._frame_graphs[(engine, n_lanes)] = _FrameGraph(state,
                                                                     dev)
        short = int(n_valid.min())
        # each lane's first frame number and the number past its last real
        # frame: host integers where one serves every lane
        l = (l0.reshape(-1).to(device=dev, dtype=torch.int64)
             if torch.is_tensor(l0) else int(l0))
        if short == int(n_valid.max()):
            lim = l + short
        elif torch.is_tensor(l):
            lim = l + torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
        else:
            lim = torch.as_tensor(l + n_valid, dtype=torch.int64, device=dev)

        def lanes(v):
            return v if torch.is_tensor(v) else torch.full(
                (n_lanes,), v, dtype=torch.int64, device=dev)

        chunk = min(n_run, FRAME_CHUNK)
        outs = None
        resident = False            # the state lives in fg's buffers
        i = 0
        while i < n_run:
            c = min(chunk, n_run - i)
            key = (c, i + c > short)
            if key in fg.graphs:
                if not resident:
                    fg.load(state, l + i, lim)
                    resident = True
                got = fg.replay(key, mag[:, i: i + c])
                count("frame.steps_graphed", c)
            else:
                if resident:
                    state = fg.take()
                    resident = False
                state, got = frame_chunk(engine, state, mag[:, i: i + c],
                                         lanes(l + i), lanes(lim), key[1])
                if self._frame_pool is None:
                    with torch.cuda.device(dev):
                        self._frame_pool = torch.cuda.graph_pool_handle()
                fg.capture(engine, key, got, self._frame_pool)
            if outs is None:            # zeros past n_run, if any
                alloc = torch.empty if n_run == t else torch.zeros
                outs = tuple(alloc((n_lanes, t) + o.shape[2:], dtype=o.dtype,
                                   device=dev) for o in got)
            for dst, src in zip(outs, got):
                dst[:, i: i + c].copy_(src)
            i += c
        return (fg.take() if resident else state), outs

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
        """Enhance a batch of utterances (padded to the longest bucket)
        through the shared int16 host half (``stream/batch_host.BatchHost``:
        int16 packing and one upload a chunk, framing, the MATLAB int16
        write and, with ``quantize``, the wavwrite requantisation on the
        device, a page-locked fetch and a copy a lane).  ``micro_batch``
        splits the batch into fixed-size chunks, all enqueued before any
        result is fetched; the tail chunk is padded with silent lanes.
        None = one chunk.  With ``quantize=False`` the floats returned are
        the int16-written values.  Traced: the ``batch.*`` spans and
        counters of ``BatchHost.run``."""
        s = self.cfg.signal
        states: dict[int, EngineState] = {}

        def launch(smp, n_hops, t_true):
            mb = smp.shape[0]
            if self.fast_run is None and mb not in states:
                states[mb] = batch_state(self._state0, mb)
            frames = stream_frames_torch(smp, n_hops, s.framelength,
                                         s.frameshift)
            return self.run_frames(frames, states.get(mb), t_true)[0]

        return self._batch_host.run(xs, launch,
                                    "wav" if quantize else "written",
                                    micro_batch)
