"""The host half that the push sessions share (``StreamingSession``, the
lanes of ``MultiStreamSession``, the channels of ``PmwfStreamingSession``):
a ``HopFramer`` turns pushed samples into blocks of frames, exactly
``dsp.stft.stream_frames`` of each lane's stream in any chunking of the
pushes, and ``overlap_add_hops`` is ``dsp.stft.overlap_add`` carried across
blocks, on NumPy arrays or tensors.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.runtime.profiling import stage


class Block:
    """K frames of N lanes.  ``l0`` (N,): each lane's number of the first
    frame; ``emit`` (N, K): the frames whose output hop is past the delay
    on their lane's clock; ``queue0`` (N, framelength): the queue before
    the block; ``continues``: no queue was zeroed from outside between the
    block before and this one.  ``chains``: each shift chain's queue
    followed by its hops, (N, framelength + m * frameshift)."""

    def __init__(self, chains: list, l0: np.ndarray, emit: np.ndarray,
                 continues: bool, framelength: int, shift: int):
        self._chains, self._n, self._shift = chains, framelength, shift
        self.l0, self.emit, self.continues = l0, emit, continues
        self.k = emit.shape[1]
        self.queue0 = chains[0][:, :framelength]

    @property
    def chain(self) -> np.ndarray | None:
        """``queue0`` followed by the block's hops, (N, framelength + K *
        frameshift): the block's frames are its windows after the first;
        None where a queue zeroed in mid-block broke the shift chain."""
        return self._chains[0] if len(self._chains) == 1 else None

    @cached_property
    def hops(self) -> np.ndarray | None:
        """The block's samples (N, K, frameshift); None where a queue
        zeroed in mid-block broke the shift chain from ``queue0``."""
        ext = self.chain
        if ext is None:
            return None
        return ext[:, self._n:].reshape(ext.shape[0], self.k, self._shift)

    @cached_property
    def frames(self) -> np.ndarray:
        """(N, K, framelength) float64."""
        n, s = self._n, self._shift
        return np.stack([ext[:, i: i + n] for ext in self._chains
                         for i in range(s, ext.shape[1] - n + 1, s)], axis=1)


class HopFramer:
    """N lanes in lockstep: the partial hop held between pushes
    (``hold``), the queue each hop shifts into, a frame clock a lane
    (``l``; ``reset_lanes`` restarts a lane's own) and the pending block,
    handed out as a ``Block`` every ``block_frames`` hops.  A queue zeroed
    from outside (the flush frames, ``zero``, ``reset_lanes``) starts a new
    shift chain in the pending block."""

    def __init__(self, cfg: PipelineConfig, n_lanes: int,
                 block_frames: int):
        s = cfg.signal
        self.n, self.delay = int(n_lanes), cfg.delay
        self.framelength, self.shift = s.framelength, s.frameshift
        self.block = max(int(block_frames), 1)
        self.hold = np.zeros((self.n, 0))
        self.l = np.zeros((self.n,), np.int64)
        self.pending: list[np.ndarray] = []       # the block's (N, shift) hops
        # the block's shift chains: (first hop, the queue before it)
        self._chains = [(0, np.zeros((self.n, self.framelength)))]
        self._continues = True

    @property
    def queue(self) -> np.ndarray:
        """The (N, framelength) queue as the last hop left it."""
        start, queue = self._chains[-1]
        return np.concatenate([queue, *self.pending[start:]],
                              axis=1)[:, -self.framelength:]

    @queue.setter
    def queue(self, queue: np.ndarray) -> None:
        k, queue = len(self.pending), np.array(queue, np.float64)
        if self._chains[-1][0] == k:
            self._chains[-1] = (k, queue)
        else:
            self._chains.append((k, queue))
        self._continues = self._continues and k > 0

    def push(self, samples: np.ndarray):
        """Feed (N, n) samples; yields each block they complete.  Each hop
        opens the ``stream.prep`` stage of the request the push runs in."""
        buf = np.concatenate([self.hold, samples], axis=1)
        n_hops = buf.shape[1] // self.shift
        for i in range(n_hops):
            stage("stream.prep")
            block = self._add(buf[:, i * self.shift: (i + 1) * self.shift])
            if block is not None:
                yield block
        self.hold = buf[:, n_hops * self.shift:]

    def flush(self):
        """End of stream: drops the held samples and yields the blocks of
        ``delay + 1`` whole zero frames (the reference zeroes the whole
        queue at the end instead of shifting hops in), the partial one
        last."""
        self.hold = np.zeros((self.n, 0))
        for _ in range(self.delay + 1):
            self.zero()
            block = self._add(np.zeros((self.n, self.shift)))
            if block is not None:
                yield block
        if self.pending:
            yield self.take()

    def _add(self, hop: np.ndarray) -> Block | None:
        self.pending.append(hop)
        self.l += 1
        return self.take() if len(self.pending) == self.block else None

    def take(self) -> Block | None:
        """The pending block, whole or partial (None when there is none)."""
        k = len(self.pending)
        if not k:
            return None
        ends = [start for start, _ in self._chains[1:]] + [k]
        chains = [np.concatenate([queue, *self.pending[start:end]], axis=1)
                  for (start, queue), end in zip(self._chains, ends)]
        l0 = self.l - (k - 1)
        block = Block(chains, l0, l0[:, None] + np.arange(k) > self.delay,
                      self._continues, self.framelength, self.shift)
        self._chains = [(0, chains[-1][:, -self.framelength:])]
        self.pending, self._continues = [], True
        return block

    def zero(self, lanes=None) -> None:
        """Zero the queue of ``lanes`` (all when None)."""
        queue = self.queue.copy()
        queue[slice(None) if lanes is None else np.asarray(lanes, int)] = 0.0
        self.queue = queue

    def reset_lanes(self, lanes) -> None:
        """Zero the lanes' queues and restart their clocks at frame 0."""
        self.zero(lanes)
        self.l[np.asarray(lanes, int)] = 0


def overlap_add_hops(recent, frames, shift: int):
    """``recent`` (N, ratio-1, L): the synthesised frames before this
    block, oldest first; ``frames`` (N, K, L): the block's.  Returns (hops
    (N, K, shift), the new history).  Output hop i adds chunk c of frame
    i - c for c = 0, 1, ... in that order (newest frame first), as
    ``overlap_add`` does, so float32 sums give the offline plan's bits."""
    xp = torch if torch.is_tensor(frames) else np
    both = (torch.cat if xp is torch else np.concatenate)([recent, frames], 1)
    b, k, n = frames.shape
    ratio = n // shift
    chunks = both.reshape(b, k + ratio - 1, ratio, shift)
    hops = xp.zeros_like(chunks[:, :k, 0])
    for c in range(ratio):
        hops += chunks[:, ratio - 1 - c: ratio - 1 - c + k, c]
    return hops, both[:, k:]
