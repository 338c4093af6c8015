"""Hop-by-hop real-time streaming session (port of
``se_snmf_nat_tpu.stream.streaming``).

The live paths consume hops of ``frameshift`` samples.  ``StreamingSession``
is that loop as an API: push samples, get back the finalised enhanced
samples (after the algorithmic delay of ``cfg.delay`` hops), with the engine
state carried across pushes on the enhancer's device.  It runs the same
``Engine.step`` as the offline exact plan, frame by frame in the same order,
so the streamed output equals ``SnmfEnhancer.enhance`` on the same device.

The frame queue, the partial-hop hold and the overlap-add stay NumPy on the
host; each processed block uploads its frames and downloads its synthesised
frames, so a push that completes a block waits for the device.  The
overlap-add keeps the synthesised frames in the enhancer's dtype and adds
each output hop's chunks in the order of ``dsp.stft.overlap_add`` (newest
frame first), which makes the float32 sums the same bits as the offline
plan's.  With ``quantize=False`` the samples come back as float64, whatever
the session's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.enhance.state import (
    EngineState, batch_state, lane_state)
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.stream.block_adaptive import (
    make_block_step, ring_ptr0, rings_to_shift_layout)


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
        s = enhancer.cfg.signal
        self._s = s
        self._delay = enhancer.cfg.delay
        self._np_dtype = (np.float64 if enhancer.dtype == torch.float64
                          else np.float32)
        self._block = max(int(block_frames), 1)
        # a mid-block set_adaptation of a block-adaptive session waits here
        # until the pending block completes
        self._deferred_adapt: bool | None = None
        self._ba_step = None
        if use_block_adaptive and self._block > 1:
            self._ba_step = make_block_step(
                enhancer.cfg, *enhancer._bases, enhancer.device,
                enhancer.dtype, k_block=self._block,
                iter_cap=enhancer.block_iter_cap)
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
        s = self._s
        self._queue = np.zeros(s.framelength)
        self._hold = np.zeros(0)            # partial-hop residue
        # the last framelength/frameshift synthesised frames, newest first
        ratio = s.framelength // s.frameshift
        self._recent = [np.zeros(s.framelength, self._np_dtype)] * ratio
        self._l = 0
        self._pending: list[np.ndarray] = []   # queued analysis frames
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
        if self._ba_step is not None and self._pending:
            self._deferred_adapt = bool(on)
            return self._emit([], quantize)
        outs = self._flush_pending()
        self._set_adapt(on)
        return self._emit(outs, quantize)

    def _emit(self, outs: list[np.ndarray], quantize: bool) -> np.ndarray:
        y = np.concatenate(outs) if outs else np.zeros(0, self._np_dtype)
        return enhanced_quantize(y) if quantize else y.astype(np.float64)

    @torch.no_grad()
    def _flush_pending(self) -> list[np.ndarray]:
        """Run the queued frames through one call on the device; returns
        the emitted hop chunks."""
        if not self._pending:
            return []
        s, enh = self._s, self.enh
        k = len(self._pending)
        l0 = self._l - k + 1
        frames = torch.as_tensor(np.stack(self._pending)[None],
                                 dtype=enh.dtype, device=enh.device)
        mag, phase = enh._analysis(frames)
        if self._ba_step is not None and k == self._block:
            self._state, self._ba_ptr, xm = self._ba_step(
                self._state, self._ba_ptr, mag, np.arange(l0, l0 + k),
                torch.ones((1, k), dtype=torch.bool, device=enh.device))
        else:
            if self._ba_step is not None:
                # the partial tail runs through the exact loop: hand it the
                # rings in shift layout and restart the circular pointer
                self._state = rings_to_shift_layout(self._state,
                                                    self._ba_ptr)
                self._ba_ptr = ring_ptr0(1, enh.device)
            self._state, (xm,) = enh.frame_loop(enh.engine, mag, self._state,
                                                [k], l0)
        outs = enh._synthesis(xm, phase)[0].cpu().numpy()
        self._pending = []
        if self._deferred_adapt is not None:
            # a mid-block set_adaptation takes effect at the block boundary;
            # the frames above ran under the previous setting, as pushed
            self._set_adapt(self._deferred_adapt)
            self._deferred_adapt = None
        emitted = []
        shift = s.frameshift
        for i in range(k):
            self._recent = [outs[i]] + self._recent[:-1]
            if l0 + i > self._delay:
                hop = np.zeros(shift, self._np_dtype)
                for c, frame in enumerate(self._recent):
                    hop += frame[c * shift: (c + 1) * shift]
                emitted.append(hop)
        return emitted

    def _process_hop(self, hop: np.ndarray) -> list[np.ndarray]:
        s = self._s
        self._queue = np.concatenate([self._queue[s.frameshift:], hop])
        self._l += 1
        self._pending.append(self._queue.copy())
        if len(self._pending) < self._block:
            return []
        return self._flush_pending()

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """Feed any number of int16-scale samples; returns the finalised
        output samples available so far (possibly empty)."""
        s = self._s
        buf = np.concatenate([self._hold,
                              np.asarray(samples, np.float64).reshape(-1)])
        outs = []
        while len(buf) >= s.frameshift:
            hop, buf = buf[: s.frameshift], buf[s.frameshift:]
            outs.extend(self._process_hop(hop))
        self._hold = buf
        return self._emit(outs, quantize)

    def flush(self, quantize: bool = True) -> np.ndarray:
        """End of stream: drop the partial hop and process ``delay + 1``
        flush frames with the queue fully zeroed (the reference zeroes the
        whole queue at the end instead of shifting hops in), then drain a
        partial block."""
        s = self._s
        self._hold = np.zeros(0)
        outs = []
        for _ in range(self._delay + 1):
            self._queue = np.zeros(s.framelength)   # whole queue, not a shift
            outs.extend(self._process_hop(np.zeros(s.frameshift)))
        outs.extend(self._flush_pending())
        return self._emit(outs, quantize)
