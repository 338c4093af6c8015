"""Hop-by-hop real-time streaming session (port of
``se_snmf_nat_tpu.stream.streaming``).

The live paths consume hops of ``frameshift`` samples.  ``StreamingSession``
is that loop as an API: push samples, get back the finalised enhanced
samples (after the algorithmic delay of ``cfg.delay`` hops), with the engine
state carried across pushes on the enhancer's device.  It runs the same
``Engine.step`` as the offline exact plan, frame by frame in the same order,
so the streamed output equals ``SnmfEnhancer.enhance`` on the same device.

The hold, the queue and the pending block are a ``stream.hops.HopFramer``
on the host; each processed block uploads its frames and downloads its
synthesised frames, so a push that completes a block waits for the device.
The overlap-add (``stream.hops.overlap_add_hops``) runs on the host in the
enhancer's dtype, newest frame first as ``dsp.stft.overlap_add`` adds, which
makes the float32 sums the same bits as the offline plan's.  With
``quantize=False`` the samples come back as float64, whatever the session's
dtype.

Traced (``runtime.profiling``), a push is tiled by the spans
``stream.prep`` (the hold, the queue, the frames' upload),
``stream.launch`` (analysis, the frame loop or block step, synthesis),
``stream.fetch`` (the synthesised frames to the host) and ``stream.emit``
(overlap-add, quantize), once for each block the push completes.
"""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import host_array
from se_snmf_nat_tpu_torch.enhance.state import (
    EngineState, batch_state, lane_state)
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.runtime.profiling import request, stage
from se_snmf_nat_tpu_torch.stream.block_adaptive import ring_ptr0
from se_snmf_nat_tpu_torch.stream.hops import HopFramer, overlap_add_hops


class StreamingSession:
    """Wraps a ``SnmfEnhancer`` for one-hop-at-a-time processing on the
    enhancer's device.

    ``block_frames > 1`` trades latency for cost per hop: hops accumulate
    until ``block_frames`` are pending, then one call processes the block
    (one upload, one download; the outputs equal ``block_frames=1``
    because the same steps run in the same order).

    ``use_block_adaptive`` (with ``block_frames > 1``) solves every full
    block through the block-adaptive step (one H-solve per block, one refit
    per block: the documented approximation of ``stream/block_adaptive``);
    the partial tail block at ``flush`` goes through the exact frame loop.

    ``state`` is an unbatched ``EngineState`` on the enhancer's device, as
    ``enhancer.initial_state()`` and ``enhance(return_state=True)`` give."""

    def __init__(self, enhancer, state: EngineState | None = None,
                 block_frames: int = 1, use_block_adaptive: bool = False):
        self.enh = enhancer
        self._np_dtype = (np.float64 if enhancer.dtype == torch.float64
                          else np.float32)
        self._block = max(int(block_frames), 1)
        # a mid-block set_adaptation of a block-adaptive session waits here
        # until the pending block completes
        self._deferred_adapt: bool | None = None
        self._ba_step = None
        if use_block_adaptive and self._block > 1:
            self._ba_step = enhancer.block_step(self._block)
        self.reset(state)

    @property
    def state(self) -> EngineState:
        """The carried engine state (unbatched, on the device)."""
        return lane_state(self._state, 0)

    @state.setter
    def state(self, state: EngineState) -> None:
        self._state = batch_state(state, 1)

    def reset(self, state: EngineState | None = None) -> None:
        """Return the session to t=0 for a new stream: engine state, frame
        queue, overlap-add history, hold, pending block and the frame
        counter all restart.  A warmed-then-reset session equals a fresh
        one."""
        s = self.enh.cfg.signal
        self._framer = HopFramer(self.enh.cfg, 1, self._block)
        # the last framelength/frameshift - 1 synthesised frames, oldest
        # first
        self._recent = np.zeros(
            (1, s.framelength // s.frameshift - 1, s.framelength),
            self._np_dtype)
        self.state = state if state is not None else self.enh.initial_state()
        self._deferred_adapt = None
        # circular write position of the block step's adaptation rings,
        # carried across pushes as the offline block plan carries it
        self._ba_ptr = ring_ptr0(1, self.enh.device)

    def _set_adapt(self, on: bool) -> None:
        self._state = self._state._replace(
            adapt_on=torch.full_like(self._state.adapt_on, bool(on)))

    def set_adaptation(self, on: bool, quantize: bool = True) -> np.ndarray:
        """Live noise-adaptation switch: sets the ``adapt_on`` flag carried
        in the state.  While off, frames are treated as supervised: no
        trigger fires and the rings, the refit counter and the dictionary
        head stay untouched.

        Exact sessions flush the pending frames under the previous setting
        (they were pushed under it) and apply the toggle from the next
        frame.  Block-adaptive sessions defer a mid-block toggle to the next
        block boundary: flushing a partial block early would send those
        frames through the exact plan and shift the session's block cadence.
        Any samples finalised by the flush are returned, as by ``push``."""
        if self._ba_step is not None and self._framer.pending:
            self._deferred_adapt = bool(on)
            return self._emit([], quantize)
        outs = self._run(self._framer.take())
        self._set_adapt(on)
        return self._emit(outs, quantize)

    def _emit(self, outs: list[np.ndarray], quantize: bool) -> np.ndarray:
        y = np.concatenate(outs) if outs else np.zeros(0, self._np_dtype)
        return enhanced_quantize(y) if quantize else y.astype(np.float64)

    @torch.no_grad()
    def _run(self, block) -> list[np.ndarray]:
        """Run a framed block through one call on the device; returns the
        samples it finalises (none for no block)."""
        if block is None:
            return []
        enh = self.enh
        frames = torch.as_tensor(block.frames, dtype=enh.dtype,
                                 device=enh.device)
        stage("stream.launch")
        self._state, self._ba_ptr, ys = enh.session_block(
            frames, self._state, self._ba_ptr, int(block.l0[0]),
            self._ba_step)
        stage("stream.fetch")
        outs = host_array(ys)
        stage("stream.emit")
        if self._deferred_adapt is not None:
            # a mid-block set_adaptation takes effect at the block boundary;
            # the frames above ran under the previous setting, as pushed
            self._set_adapt(self._deferred_adapt)
            self._deferred_adapt = None
        hops, self._recent = overlap_add_hops(self._recent, outs,
                                              enh.cfg.signal.frameshift)
        return [hops[0][block.emit[0]].reshape(-1)]

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """Feed any number of int16-scale samples; returns the finalised
        output samples available so far (possibly empty)."""
        with request("stream.prep"):
            outs = []
            for block in self._framer.push(
                    np.asarray(samples, np.float64).reshape(1, -1)):
                outs.extend(self._run(block))
            stage("stream.emit")
            return self._emit(outs, quantize)

    def flush(self, quantize: bool = True) -> np.ndarray:
        """End of stream: drop the partial hop and process ``delay + 1``
        flush frames with the queue fully zeroed (the reference zeroes the
        whole queue at the end instead of shifting hops in), then drain a
        partial block."""
        outs = []
        for block in self._framer.flush():
            outs.extend(self._run(block))
        return self._emit(outs, quantize)
