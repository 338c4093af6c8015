"""The int16 host half of a batched offline call, shared by the enhancers
that batch utterances as lanes (``SnmfEnhancer.enhance_batch``,
``PmwfEnhancer.enhance_batch``):

  host:   each lane's true samples as int16, packed into a page-locked
          buffer (float lanes: one exactness test; else the float sample
          matrix)
  device: the zero-padded sample matrix -> the enhancer's launch (framing,
          its plan, overlap-add) -> MATLAB-exact int16 write -> with a
          wavwrite table, its requantisation (a gather)
  host:   int16 PCM into a page-locked buffer -> delay trim, a copy a lane

A lane is one utterance: (n,) samples, or (C, n) for C channels of one
recording, each channel a row of the sample matrix.  Every lane of a call
has the same number of rows.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from se_snmf_nat_tpu_torch.dsp.stft import pack_samples_for_upload
from se_snmf_nat_tpu_torch.runtime.profiling import count, request, stage
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write_torch, matlab_wavwrite_table)


def _pow2(n: int) -> int:
    """The least power of two at or above ``n`` (1 for 0)."""
    return 1 << max(n - 1, 0).bit_length()


# what a call hands back: "wav" the int16 write and the wavwrite
# requantisation (int16), "int16" the int16 write alone (int16), "written"
# the int16 write as float64 values, "float" the overlap-added samples in
# the compute dtype
OUTPUTS = ("wav", "int16", "written", "float")


class BatchHost:
    """The host buffers, the device's column index and the wavwrite table
    of one enhancer's batched calls, kept across calls; ``run`` is one
    call."""

    def __init__(self, device, dtype, frameshift: int, delay: int,
                 frame_bucket: int = 1):
        self.device = device
        self.dtype = dtype
        self.shift = int(frameshift)
        self.delay = int(delay)
        self.frame_bucket = max(int(frame_bucket), 1)
        self._wav_table = None
        self._bufs: dict[str, torch.Tensor] = {}
        self._cols = torch.zeros(0, dtype=torch.int64, device=device)
        self._lock = threading.Lock()

    def _host_buffer(self, key: str, n: int, dtype) -> torch.Tensor:
        """The first ``n`` elements of the host buffer ``key``, kept across
        calls (page-locked when the enhancer is on a card), grown to a
        power of two when short."""
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < n:
            buf = self._bufs[key] = torch.empty(
                _pow2(n), dtype=dtype,
                pin_memory=self.device.type == "cuda")
        return buf[:n]

    def _columns(self, n: int) -> torch.Tensor:
        """0..n-1 (int64) on the device, kept across calls."""
        if self._cols.numel() < n:
            self._cols = torch.arange(_pow2(n), device=self.device)
        return self._cols[:n]

    def _finish(self, ys: torch.Tensor, output: str) -> torch.Tensor:
        if output == "float":
            return ys
        pcm = matlab_int16_write_torch(ys)
        if output != "wav":
            return pcm
        if self._wav_table is None:
            self._wav_table = torch.as_tensor(matlab_wavwrite_table(),
                                              device=self.device)
        # an int16 value indexes the table as a negative index does
        return self._wav_table[pcm.long()]

    def run(self, xs: list, launch: Callable, output: str = "wav",
            micro_batch: int | None = None,
            counters: dict[str, int] | None = None) -> list[np.ndarray]:
        """One call over the lanes ``xs``.

        ``launch(samples, n_hops, t_true)`` runs a chunk on the device:
        ``samples`` (mb, *rows, S) in the compute dtype, zero past each
        lane's true hops, with S = the call's frames x the hop; ``n_hops``
        (mb,) int64 on the device; ``t_true`` (mb,) host integers, each
        lane's hops + delay + 1 frames (a silent lane's delay + 1).  It
        returns the overlap-added samples (mb, *out_rows, >= S).

        Each lane's true hops go into one page-locked int16 buffer, packed
        one after another with a zero after each (an int16 lane as it is; a
        float lane after one test that its samples are int16 values), and
        go up in one copy a chunk; on the device one gather lays them into
        the zero-padded sample matrix.  If a float lane is not int16
        values, the call uploads the float sample matrix instead.
        ``micro_batch`` splits the lanes into chunks of that many, all
        enqueued before any result is fetched; the tail chunk is padded
        with silent lanes.  None = one chunk.  A lane's output is its
        (*out_rows, (t_true - delay) * hop) samples from the delay on,
        as ``output`` (``OUTPUTS``) says.

        Traced, the call is tiled by the spans ``batch.prep`` (packing and
        the upload), ``batch.launch`` (the layout, ``launch``, the int16
        write and requantisation), ``batch.fetch`` (the PCM to the host)
        and ``batch.emit`` (a copy a lane), each chunk with its own prep,
        launch and fetch; the counters ``batch.frames_computed`` (lanes x
        the call's frames) and ``batch.frames_true`` (the real lanes' hops
        + delay + 1) give the padding, ``batch.lanes`` and
        ``batch.lanes_int16`` the real lanes and those sent as int16;
        ``counters`` (name: n) are the caller's, added inside the call's
        first span."""
        if output not in OUTPUTS:
            raise ValueError(f"output {output!r} is not one of {OUTPUTS}")
        with self._lock, request("batch.prep"):
            shift, n_flush = self.shift, self.delay + 1
            lanes = [np.asarray(x) for x in xs]
            rows = lanes[0].shape[:-1]
            if any(x.shape[:-1] != rows for x in lanes):
                raise ValueError("every lane of a call needs the same "
                                 f"rows: {[x.shape[:-1] for x in lanes]}")
            n_rows = int(np.prod(rows, dtype=np.int64))
            n_hops_all = np.asarray([x.shape[-1] // shift for x in lanes],
                                    np.int64)
            t_true_all = n_hops_all + n_flush
            t_max = -(-int(t_true_all.max()) // self.frame_bucket) \
                * self.frame_bucket
            np_dt = np.float64 if self.dtype == torch.float64 else np.float32
            mb = len(lanes) if not micro_batch else min(int(micro_batch),
                                                        len(lanes))
            # row r of lane g (sub-lane g * n_rows + r) has its true samples
            # at [ends - lens, ends), a zero at ends (the trailing partial
            # hop drops)
            lens = np.repeat(n_hops_all * shift, n_rows)
            ends = np.cumsum(lens + 1) - 1
            stage_t = self._host_buffer("samples", int(ends[-1]) + 1,
                                        torch.int16)
            packed = stage_t.numpy()
            exact = True
            with np.errstate(invalid="ignore"):
                for k, (e, m) in enumerate(zip(ends, lens)):
                    x = lanes[k // n_rows]
                    a = x.reshape(n_rows, -1)[k % n_rows, :m]
                    dst = packed[e - m: e]
                    np.copyto(dst, a, casting="unsafe")
                    packed[e] = 0
                    if a.dtype != np.int16 and not np.array_equal(dst, a):
                        exact = False
                        break
            count("batch.lanes", len(lanes))
            count("batch.lanes_int16", len(lanes) if exact else 0)
            for name, n in (counters or {}).items():
                count(name, n)
            n_chunks = -(-len(lanes) // mb)
            sub = mb * n_rows
            meta_t = self._host_buffer("lanes", n_chunks * 3 * sub,
                                       torch.int64).view(n_chunks, 3, sub)
            cols = self._columns(t_max * shift)

            def upload(c, g0, g1):
                """Chunk c's packed samples and its rows' (3, mb * rows)
                hops, first samples and zeros, the last two counted from
                the chunk's first sample (a silent lane's at the last
                zero), on the device."""
                s0, s1 = g0 * n_rows, g1 * n_rows
                r0, r1 = int(ends[s0] - lens[s0]), int(ends[s1 - 1])
                meta = meta_t[c].numpy()
                meta[:] = [[0], [r1 - r0], [r1 - r0]]
                meta[0, : s1 - s0] = lens[s0:s1] // shift
                meta[2, : s1 - s0] = ends[s0:s1] - r0
                meta[1, : s1 - s0] = meta[2, : s1 - s0] - lens[s0:s1]
                return (stage_t[r0: r1 + 1].to(self.device, non_blocking=True),
                        meta_t[c].to(self.device, non_blocking=True))

            def dispatch(c):
                stage("batch.prep")
                g0, g1 = c * mb, min((c + 1) * mb, len(lanes))
                count("batch.frames_computed", mb * t_max)
                count("batch.frames_true", int(t_true_all[g0:g1].sum()))
                tt = np.full((mb,), n_flush, np.int64)
                tt[: g1 - g0] = t_true_all[g0:g1]
                if exact:
                    packed_dev, meta = upload(c, g0, g1)
                    nh = meta[0].view(mb, n_rows)[:, 0]
                else:
                    smp = np.zeros((mb, n_rows, t_max * shift), np.float64)
                    for i in range(g1 - g0):
                        n = int(n_hops_all[g0 + i]) * shift
                        smp[i, :, :n] = np.asarray(
                            lanes[g0 + i]).reshape(n_rows, -1)[:, :n]
                    nh = np.zeros((mb,), np.int64)
                    nh[: g1 - g0] = n_hops_all[g0:g1]
                    smp_dev = torch.as_tensor(
                        pack_samples_for_upload(smp, np_dt),
                        device=self.device).to(self.dtype)
                    nh = torch.as_tensor(nh, device=self.device)
                stage("batch.launch")
                if exact:       # row i's samples, then its zero repeated
                    idx = cols + meta[1, :, None]
                    smp_dev = packed_dev.to(self.dtype)[
                        torch.minimum(idx, meta[2, :, None], out=idx)]
                ys = launch(smp_dev.reshape(mb, *rows, t_max * shift), nh,
                            tt)
                return self._finish(ys, output)

            pending = [dispatch(c) for c in range(n_chunks)]
            outs = []
            start = self.delay * shift
            for ci, pcm in enumerate(pending):
                stage("batch.fetch")
                key = "pcm" if pcm.dtype == torch.int16 else f"pcm.{pcm.dtype}"
                host = self._host_buffer(key, pcm.numel(), pcm.dtype)
                ys = host.view(pcm.shape).copy_(pcm).numpy()
                stage("batch.emit")
                for i in range(min(mb, len(lanes) - ci * mb)):
                    g = ci * mb + i
                    emit = ys[i, ..., start: start
                              + (int(t_true_all[g]) - self.delay) * shift]
                    outs.append(emit.astype(np.float64) if output == "written"
                                else emit.copy())
            return outs
