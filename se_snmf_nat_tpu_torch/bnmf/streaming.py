"""Push-based streaming session for the online Bayesian-NMF enhancer.
Counterpart of the reference package's ``bnmf/streaming.py``.

The reference's BNMF wrapper IS a frame loop (proc_BNMF_nmoh.m:121-135
consumes ulen-sample hops with an alen window), so the algorithm is
inherently streaming.  This session exposes that as the same push/flush
API as stream/streaming.StreamingSession, with the online loop's state
carried across pushes: the shipped int16 output equals the offline
``BnmfEnhancer.enhance`` on the same samples, because both run
``BnmfEnhancer.run_frames`` frame by frame in the same order; blocks only
group the frames of one call.

Startup latency is algorithm-inherent: the online noise model trains on
the first ``init_hops * ulen`` mixture samples (proc_BNMF_nmoh.m:85-99),
so no audio can be emitted before that head has arrived (240 ms at the
reference settings) plus the one-hop OLA delay.
"""

from __future__ import annotations

import numpy as np

from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize


class BnmfStreamingSession:
    """Wraps an online-mode BnmfEnhancer for incremental processing.

    ``block_frames`` groups that many analysis frames a call of the
    enhancer's loop; a partial tail block runs at flush, so any block size
    gives the same samples.
    """

    def __init__(self, enhancer, block_frames: int = 8):
        if enhancer.method != "online":
            raise ValueError("BnmfStreamingSession needs an online-mode "
                             "enhancer (supervised mode is an offline "
                             "batched solve)")
        self.enh = enhancer
        p = enhancer.p
        self._p = p
        self._block = max(int(block_frames), 1)
        self._head: list[np.ndarray] = []     # raw samples until init done
        self._head_n = 0
        self._fq = np.zeros(0)                # unconsumed framer tail
        self._pending: list[np.ndarray] = []  # raw frames awaiting a block
        self._carry = None
        self._sigma = None
        self._l = 0                           # frames processed so far
        self._acc = np.zeros(p.alen)          # OLA accumulator
        self._finished = False

    # ------------------------------------------------------------------
    def _flush_pending(self) -> list[np.ndarray]:
        """Run queued frames through the enhancer's loop; returns the
        emitted ulen-sample hop chunks (already scaled back by sigma)."""
        if not self._pending:
            return []
        p = self._p
        k = len(self._pending)
        frames = self.enh._t(np.stack(self._pending) / self._sigma)
        self._carry, y = self.enh.run_frames(self._carry, frames,
                                             self._l - k + 1)
        y = y.cpu().numpy().astype(np.float64)
        self._pending = []
        emitted = []
        for i in range(k):
            self._acc += y[i]
            emitted.append(self._acc[: p.ulen] * self._sigma)
            self._acc = np.concatenate(
                [self._acc[p.ulen:], np.zeros(p.ulen)])
        return emitted

    def _drain_frames(self) -> list[np.ndarray]:
        """Cut complete analysis frames out of the framer tail and run
        full blocks."""
        p = self._p
        out = []
        while len(self._fq) >= p.alen:
            self._pending.append(self._fq[: p.alen].copy())
            self._fq = self._fq[p.ulen:]
            self._l += 1
            if len(self._pending) == self._block:
                out.extend(self._flush_pending())
        return out

    def _start(self, head: np.ndarray) -> None:
        """Scale and noise init from the head; all its samples enter
        framing."""
        p = self._p
        self._head = []
        self._sigma = self.enh.head_sigma(head)
        self._carry = self.enh.init_online_carry(
            head[: p.init_hops * p.ulen])
        self._fq = head

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """Feed int16-scale samples; returns finalized output samples
        available so far (empty until the init head has arrived)."""
        if self._finished:
            raise RuntimeError("session already flushed; create a new "
                               "BnmfStreamingSession to process more audio")
        p = self._p
        samples = np.asarray(samples, np.float64).reshape(-1)
        need = p.init_hops * p.ulen
        if self._carry is None:
            self._head.append(samples)
            self._head_n += len(samples)
            if self._head_n < need:
                return np.zeros(0, np.int16 if quantize else np.float64)
            self._start(np.concatenate(self._head))
        else:
            self._fq = np.concatenate([self._fq, samples])
        outs = self._drain_frames()
        y = np.concatenate(outs) if outs else np.zeros(0)
        return enhanced_quantize(y) if quantize else y

    def flush(self, quantize: bool = True) -> np.ndarray:
        """EOF: process the partial tail block and emit the final OLA hop
        (the offline pipeline's (T+1)-th hop, proc_BNMF_nmoh.m:131-135).
        Idempotent: the session is finished afterwards — a second flush
        returns empty and further pushes raise."""
        p = self._p
        outs = []
        if not self._finished and self._carry is None and self._head_n:
            # total input shorter than the init head: train the noise
            # init on whatever arrived, exactly like offline enhance on
            # the same samples
            self._start(np.concatenate(self._head))
            outs.extend(self._drain_frames())
        if self._carry is not None and not self._finished:
            outs.extend(self._flush_pending())    # partial block
            outs.append(self._acc[: p.ulen] * self._sigma)
            self._acc = np.concatenate(
                [self._acc[p.ulen:], np.zeros(p.ulen)])
        self._finished = True
        y = np.concatenate(outs) if outs else np.zeros(0)
        return enhanced_quantize(y) if quantize else y
