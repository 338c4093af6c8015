"""Multi-stream serving session: B concurrent real-time streams, one tick
of device work for all of them (port of ``se_snmf_nat_tpu.stream.serving``).

Every lane is an independent stream (its own engine state, overlap-add
history, clock and output), but a tick runs the lanes together: one
analysis, ``block_frames`` steps of the engine over all lanes (one
activation-solve launch and one refit launch a frame, whatever the fleet's
size), one synthesis.  The launches of a frame are paid once a fleet, not
once a stream.

Lanes advance in lockstep on a shared hop clock, but each keeps its own
frame number: a lane reset for a new tenant (``reset_lanes``) restarts at
frame 0 and replays the engine's first-frame seed, the initial gating and
the emission delay while the others carry on.  The engine takes the frame
numbers as a (B,) tensor (``Engine.step``), so a tick reads no device value
on the host.

Wire formats.  ``wire="frames"`` uploads (B, K, framelength) frames and
downloads the synthesised frames; the overlap-add runs on the host.
``wire="samples"`` uploads the raw hop samples (int16 when they are
integer-valued), builds the frames from a queue that lives on the device,
overlap-adds against the last synthesised frames kept on the device, applies
MATLAB's int16 write there and downloads int16 PCM.  Partial blocks,
``flush``, a queue zeroed in mid-block and lane resets go through the frames
path, and the device copies are re-seeded once afterwards.
``pipeline_ticks`` (samples wire) returns tick n-1 while tick n is in
flight: on the card the PCM of a tick is copied into pinned host memory
without blocking and an event marks it; the next push waits on that event
only.  ``drain`` settles the last tick.

Both wires add an output hop's chunks in the order of ``StreamingSession``
and ``dsp.stft.overlap_add`` (newest frame first), so on one device and
dtype a fleet lane and a solo session differ by nothing the overlap-add
introduces.
"""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import host_array
from se_snmf_nat_tpu_torch.enhance.state import EngineState, batch_state
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.stream.block_adaptive import (
    make_block_step, ring_ptr0, rings_to_shift_layout)
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_int16_write_torch


def _hops_from_frames(recent, outs, shift: int):
    """Overlap-add with a carried history, for NumPy arrays or tensors.
    ``recent`` (B, ratio-1, L): the synthesised frames before this block,
    oldest first; ``outs`` (B, K, L): the block's.  Returns (hops
    (B, K, shift), the new history).  Output hop i adds chunk c of frame
    i - c for c = 0, 1, ... in that order (newest frame first)."""
    xp = torch if torch.is_tensor(outs) else np
    both = (torch.cat if xp is torch else np.concatenate)([recent, outs], 1)
    b, k, n = outs.shape
    ratio = n // shift
    chunks = both.reshape(b, k + ratio - 1, ratio, shift)
    hops = xp.zeros_like(chunks[:, :k, 0])
    for c in range(ratio):
        hops += chunks[:, ratio - 1 - c: ratio - 1 - c + k, c]
    return hops, both[:, k:]


class MultiStreamSession:
    """Lockstep fleet of B streaming lanes over one ``SnmfEnhancer``, on the
    enhancer's device.

    ``push`` and ``flush`` mirror ``StreamingSession`` with a leading lane
    axis: ``push`` takes (B, n) samples (the same n for every lane) and
    returns the (B, m) finalised samples available so far.

    ``states``: per-lane engine states stacked on axis 0, on the enhancer's
    device (lanes resumed from carried states); B copies of the enhancer's
    initial state otherwise.  ``block_frames``: frames a tick.
    ``use_block_adaptive`` (with ``block_frames > 1``): full blocks through
    the block-adaptive step with a ring pointer per lane, a partial block
    through the exact loop.  ``mesh`` (``parallel.mesh.Mesh``): the lanes
    split over the shards of its 'data' axis (``n_streams`` must divide by
    it), one sub-fleet a shard on the shard's device: the constructor then
    returns a ``ShardedFleet`` with that surface (its single-card form,
    where the shards are logical).  A mesh with one 'data' shard is the
    plain fleet on that shard's device.  A fleet serves from one process:
    a mesh with a process group is refused."""

    def __new__(cls, enhancer, n_streams: int, states=None,
                block_frames: int = 1, use_block_adaptive: bool = False,
                mesh=None, wire: str = "frames",
                pipeline_ticks: bool = False):
        if mesh is None or cls is not MultiStreamSession:
            return super().__new__(cls)
        devices = _lane_devices(mesh, int(n_streams))
        if len(devices) == 1:
            return super().__new__(cls)
        return ShardedFleet(enhancer, n_streams, len(devices),
                            block_frames=block_frames,
                            use_block_adaptive=use_block_adaptive,
                            wire=wire, pipeline_ticks=pipeline_ticks,
                            states=states, devices=devices)

    def __init__(self, enhancer, n_streams: int, states=None,
                 block_frames: int = 1, use_block_adaptive: bool = False,
                 mesh=None, wire: str = "frames",
                 pipeline_ticks: bool = False):
        if mesh is not None:
            enhancer = enhancer.on_device(
                _lane_devices(mesh, int(n_streams))[0])
        if wire not in ("frames", "samples"):
            raise ValueError(f"wire must be 'frames' or 'samples': {wire}")
        if pipeline_ticks and wire != "samples":
            raise ValueError("pipeline_ticks requires wire='samples'")
        if wire == "samples" and use_block_adaptive:
            raise ValueError("wire='samples' runs the exact engine; it does "
                             "not combine with use_block_adaptive")
        self.enh = enhancer
        self.n = int(n_streams)
        s = enhancer.cfg.signal
        self._s = s
        self._dev = enhancer.device
        self._delay = enhancer.cfg.delay
        self._np_dtype = (np.float64 if enhancer.dtype == torch.float64
                          else np.float32)
        self._ratio = s.framelength // s.frameshift
        self._queue = np.zeros((self.n, s.framelength))
        self._hold = np.zeros((self.n, 0))
        # the last ratio-1 synthesised frames of every lane, oldest first
        self._recent = np.zeros((self.n, self._ratio - 1, s.framelength),
                                self._np_dtype)
        # a frame clock per lane: lanes tick in lockstep, but a lane reset
        # in mid-session restarts its own clock at 0
        self._l = np.zeros((self.n,), np.int64)
        self._block = max(int(block_frames), 1)
        self._pending: list[np.ndarray] = []      # each (B, framelength)
        # block-adaptive fleets: mid-block set_adaptation calls wait here
        # as (lanes, on), applied in order at the next block boundary
        self._deferred_adapt_ops: list = []
        if states is None:
            states = batch_state(enhancer.initial_state(), self.n)
        else:
            states = EngineState(*states)
            for name, f in zip(EngineState._fields, states):
                if f.device != self._dev or f.shape[0] != self.n:
                    raise ValueError(
                        f"states.{name} must have {self.n} lanes on "
                        f"{self._dev}: {tuple(f.shape)} on {f.device}")
        self.state = states
        self._ba_step = None
        if use_block_adaptive and self._block > 1:
            self._ba_step = make_block_step(
                enhancer.cfg, *enhancer._bases, self._dev, enhancer.dtype,
                k_block=self._block, iter_cap=enhancer.block_iter_cap)
            self._ba_ptr = ring_ptr0(self.n, self._dev)
        # ---- the samples wire: queue and overlap-add history on the device
        self._samples = wire == "samples"
        self._pipeline = bool(pipeline_ticks)
        self._inflight = None
        # device copies current?  a frames-path tick leaves them stale
        self._dev_synced = False
        self._queue_preblock = None
        # a queue zeroed in mid-block (flush, zero_queue_rows) breaks the
        # shift chain the device rebuilds frames from: that block falls back
        self._chain_broken = False
        if self._samples:
            self._queue_dev = torch.zeros((self.n, s.framelength),
                                          dtype=enhancer.dtype,
                                          device=self._dev)
            self._recent_dev = torch.zeros(self._recent.shape,
                                           dtype=enhancer.dtype,
                                           device=self._dev)
            self._dev_synced = True

    @property
    def block_frames(self) -> int:
        """Frames a tick."""
        return self._block

    # ------------------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device.  On the card it goes through pinned
        memory without blocking, so a tick's uploads wait for nothing that
        is in flight.  The tensor never shares memory with ``a``."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._dev.type == "cuda":
            return t.pin_memory().to(self._dev, non_blocking=True)
        return t.clone()

    @torch.no_grad()
    def _flush_pending(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Run the queued frame ticks through one call on the device;
        returns one ((B, frameshift) chunk, (B,) emission mask) pair a tick.
        The mask is per lane because the lanes' clocks may differ after a
        ``reset_lanes``: a fresh lane emits nothing until its own frame
        number passes the algorithmic delay."""
        if not self._pending:
            return []
        k = len(self._pending)
        l0 = self._l - k + 1                       # (B,) first tick's number
        if self._samples and k == self._block and not self._chain_broken:
            return self._tick_samples(k, l0)
        # frames path: settle a pipelined tick first (its audio is older
        # than this block's), then pull the overlap-add history off the
        # device
        pre = self._drain_inflight()
        self._sync_host_recent()
        self._chain_broken = False                 # the chain restarts below
        return pre + self._tick_frames(k, l0)

    def _tick_samples(self, k: int, l0: np.ndarray):
        """The samples-wire tick: raw hops up, int16 PCM down.  The hop of
        pending frame i is its last ``frameshift`` samples; the device
        rebuilds the frames from its carried queue."""
        s, enh = self._s, self.enh
        shift = s.frameshift
        hops = np.stack([p[:, -shift:] for p in self._pending], axis=1)
        if not self._dev_synced:
            # a frames-path tick ran since the last device tick: re-seed
            # the device queue (as it was before this block) and history
            self._queue_dev = self._upload(self._queue_preblock).to(enh.dtype)
            self._recent_dev = self._upload(self._recent).to(enh.dtype)
            self._dev_synced = True
        # integer-valued samples (every int16 capture) go up as int16; the
        # cast to the compute dtype on the device is exact
        if (np.abs(hops).max(initial=0.0) <= 32767.0
                and np.all(hops == np.rint(hops))):
            hops_up = hops.astype(np.int16)
        else:
            hops_up = np.asarray(hops, self._np_dtype)
        hops_dev = self._upload(hops_up).to(enh.dtype)     # (B, K, shift)
        pcm = self._device_tick(hops_dev, self._upload(l0))
        self._pending = []
        self._apply_deferred_adapt()
        # the host history is stale now; the device copy holds until a
        # frames-path tick pulls it (_sync_host_recent)
        if not self._pipeline:
            return self._emit_pcm(pcm.cpu().numpy(), l0, k)
        # pipelined: leave this tick in flight and hand back the one before
        if self._dev.type == "cuda":
            buf = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
            buf.copy_(pcm, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            buf, done = pcm, None
        prev, self._inflight = self._inflight, (buf, done, l0, k)
        return self._settle(prev)

    def _device_tick(self, hops_dev: torch.Tensor,
                     l0_dev: torch.Tensor) -> torch.Tensor:
        """The device half of a samples-wire tick, with no host copy:
        hops (B, K, frameshift) and the lanes' first frame numbers l0 (B,)
        on the device; advances the device queue, the state and the
        overlap-add history and returns the int16-written PCM (B, K *
        frameshift), still on the device."""
        s, enh = self._s, self.enh
        shift = s.frameshift
        ext = torch.cat([self._queue_dev, hops_dev.reshape(self.n, -1)],
                        dim=1)
        frames = ext.unfold(1, s.framelength, shift)[:, 1:]   # (B, K, L)
        self._queue_dev = ext[:, -s.framelength:].contiguous()
        mag, phase = enh._analysis(frames)
        self.state, (xm,) = enh.frame_loop(
            enh.engine, mag, self.state, [hops_dev.shape[1]] * self.n,
            l0_dev)
        out_hops, self._recent_dev = _hops_from_frames(
            self._recent_dev, enh._synthesis(xm, phase), shift)
        return matlab_int16_write_torch(out_hops.reshape(self.n, -1))

    def _settle(self, tick) -> list[tuple[np.ndarray, np.ndarray]]:
        """The emissions of a pipelined tick, once its copy has landed."""
        if tick is None:
            return []
        buf, done, l0, k = tick
        if done is not None:
            done.synchronize()
        return self._emit_pcm(buf.numpy(), l0, k)

    def _emit_pcm(self, pcm: np.ndarray, l0: np.ndarray, k: int):
        shift = self._s.frameshift
        return [(pcm[:, i * shift: (i + 1) * shift].astype(np.float64),
                 l0 + i > self._delay) for i in range(k)]

    def _drain_inflight(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fetch and emit the pipelined tick in flight, if any."""
        tick, self._inflight = self._inflight, None
        return self._settle(tick)

    def drain(self, quantize: bool = True) -> list[np.ndarray]:
        """Emit the pipelined tick still in flight (``pipeline_ticks``
        sessions owe up to one block of audio between pushes)."""
        return self._assemble(self._drain_inflight(), self.n, quantize)

    def _tick_frames(self, k: int, l0: np.ndarray):
        """The frames-wire tick: (B, k, framelength) frames up, synthesised
        frames down, overlap-add on the host (also the samples wire's path
        for partial blocks and broken chains)."""
        enh = self.enh
        frames = self._upload(np.stack(self._pending, axis=1).astype(
            self._np_dtype)).to(enh.dtype)
        mag, phase = enh._analysis(frames)
        l0_dev = self._upload(l0)
        if self._ba_step is not None and k == self._block:
            ls = l0_dev[:, None] + torch.arange(k, device=self._dev)
            self.state, self._ba_ptr, xm = self._ba_step(
                self.state, self._ba_ptr, mag, ls,
                torch.ones((self.n, k), dtype=torch.bool, device=self._dev))
        else:
            if self._ba_step is not None:
                # the partial tail runs through the exact loop: hand it the
                # rings in shift layout and restart the circular pointers
                self.state = rings_to_shift_layout(self.state, self._ba_ptr)
                self._ba_ptr = ring_ptr0(self.n, self._dev)
            self.state, (xm,) = enh.frame_loop(
                enh.engine, mag, self.state, [k] * self.n, l0_dev)
        outs = host_array(enh._synthesis(xm, phase))     # (B, k, L)
        self._pending = []
        self._apply_deferred_adapt()
        hops, self._recent = _hops_from_frames(self._recent, outs,
                                               self._s.frameshift)
        return [(hops[:, i], l0 + i > self._delay) for i in range(k)]

    def _sync_host_recent(self) -> None:
        """Pull the overlap-add history off the device before a frames-path
        tick (where the host's copy counts); the device copies go stale."""
        if self._samples and self._dev_synced:
            self._recent = host_array(self._recent_dev).copy()
            self._dev_synced = False

    def _process_hop(self, hops: np.ndarray):
        s = self._s
        if not self._pending and self._samples:
            # the queue before this block: after a frames-path tick the
            # next samples tick re-seeds the device from here
            self._queue_preblock = self._queue.copy()
        self._queue = np.concatenate(
            [self._queue[:, s.frameshift:], hops], axis=1)
        self._l += 1
        self._pending.append(self._queue.copy())
        if len(self._pending) < self._block:
            return []
        return self._flush_pending()

    @staticmethod
    def _assemble(emitted, n: int, quantize: bool) -> list[np.ndarray]:
        """Per-lane concatenation of the masked emission chunks; float64
        with ``quantize=False``."""
        per_lane: list[list[np.ndarray]] = [[] for _ in range(n)]
        for chunk, mask in emitted:
            for i in np.nonzero(mask)[0]:
                per_lane[i].append(chunk[i])
        out = []
        for lanes in per_lane:
            y = np.concatenate(lanes) if lanes else np.zeros((0,))
            out.append(enhanced_quantize(y) if quantize
                       else y.astype(np.float64))
        return out

    def _clocks_diverged(self) -> bool:
        return np.unique(self._l).size > 1

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        """Feed (B, n) int16-scale samples (lockstep across lanes); returns
        the (B, m) finalised samples available so far.  Lanes whose clocks
        have diverged (after ``reset_lanes``) emit unequal lengths: use
        ``push_per_lane`` then.

        With ``quantize=False`` on the samples wire, the chunks of a device
        tick are the values after the int16 write (the floats before it
        never leave the device) and the chunks of a frames-path tick are
        the floats before it; at ``quantize=True`` both give the same int16
        (the write leaves written values as they are)."""
        # checked before anything is processed: raising afterwards would
        # lose this call's audio with the engine state already advanced
        if self._clocks_diverged():
            raise ValueError("lane clocks diverged (reset_lanes was used); "
                             "call push_per_lane for ragged emission")
        return np.stack(self.push_per_lane(samples, quantize), axis=0)

    def push_per_lane(self, samples: np.ndarray,
                      quantize: bool = True) -> list[np.ndarray]:
        """``push`` returning one 1-D array a lane (lanes may owe different
        lengths when their clocks differ)."""
        s = self._s
        samples = np.asarray(samples, np.float64)
        if samples.ndim != 2 or samples.shape[0] != self.n:
            raise ValueError(f"push expects ({self.n}, n) samples")
        buf = np.concatenate([self._hold, samples], axis=1)
        emitted = []
        while buf.shape[1] >= s.frameshift:
            hops, buf = buf[:, : s.frameshift], buf[:, s.frameshift:]
            emitted.extend(self._process_hop(hops))
        self._hold = buf
        return self._assemble(emitted, self.n, quantize)

    def flush(self, quantize: bool = True) -> np.ndarray:
        """End of stream on every lane: the partial hop is dropped and
        ``delay + 1`` flush frames run with the whole queue zeroed, in
        lockstep; then a partial block and a pipelined tick settle."""
        if self._clocks_diverged():       # before anything is processed
            raise ValueError("lane clocks diverged; drain lanes through "
                             "zero_queue_rows and push_per_lane instead")
        s = self._s
        self._hold = np.zeros((self.n, 0))
        emitted = []
        for _ in range(self._delay + 1):
            self._queue = np.zeros((self.n, s.framelength))
            self._queue_externally_zeroed()
            emitted.extend(self._process_hop(np.zeros((self.n,
                                                       s.frameshift))))
        emitted.extend(self._flush_pending())
        emitted.extend(self._drain_inflight())
        return np.stack(self._assemble(emitted, self.n, quantize), axis=0)

    def set_adaptation(self, on: bool, lanes=None,
                       quantize: bool = True) -> list[np.ndarray]:
        """The noise-adaptation switch of the chosen lanes (``lanes=None``:
        the whole fleet): sets ``adapt_on`` in their engine states, from the
        next frame pushed; the other lanes are undisturbed.  Pending frames
        were pushed under the previous setting, so they flush under it
        first; their per-lane emissions are returned, as by
        ``push_per_lane``.  A block-adaptive fleet defers a mid-block call
        to the block boundary instead (flushing a partial block early would
        send those frames through the exact plan and shift the fleet's
        block cadence)."""
        if self._ba_step is not None and self._pending:
            self._deferred_adapt_ops.append((lanes, bool(on)))
            return self._assemble([], self.n, quantize)
        emitted = self._flush_pending() if self._pending else []
        self._apply_adapt(lanes, on)
        return self._assemble(emitted, self.n, quantize)

    def _apply_adapt(self, lanes, on: bool) -> None:
        sel = np.ones((self.n,), bool)
        if lanes is not None:
            sel[:] = False
            sel[np.asarray(lanes, int)] = True
        ad = self.state.adapt_on
        self.state = self.state._replace(adapt_on=torch.where(
            self._upload(sel), torch.full_like(ad, bool(on)), ad))

    def _apply_deferred_adapt(self) -> None:
        for lanes, on in self._deferred_adapt_ops:
            self._apply_adapt(lanes, on)
        self._deferred_adapt_ops = []

    # ----- the lane lifecycle of a multi-tenant server ------------------
    def _queue_externally_zeroed(self) -> None:
        """The samples wire's bookkeeping after the queue was zeroed from
        outside: in mid-block the shift chain is broken (this block takes
        the frames path); between blocks the next pre-block snapshot holds
        the zeros, but the device's queue is stale."""
        if not self._samples:
            return
        if self._pending:
            self._chain_broken = True
        else:
            self._sync_host_recent()

    def zero_queue_rows(self, lanes) -> None:
        """The flush loop's queue zeroing for single lanes: call before each
        drain tick of a lane at its end of stream (then feed it zero hops)
        to reproduce ``StreamingSession.flush`` on that lane alone."""
        self._queue[np.asarray(lanes, int)] = 0.0
        self._queue_externally_zeroed()

    @torch.no_grad()
    def reset_lanes(self, lanes) -> None:
        """Return lanes to the enhancer's initial state for a new tenant:
        engine state, overlap-add history, frame queue, ring pointer and
        clock restart; the other lanes are untouched.  Only at a tick
        boundary: no pending partial block, no pipelined tick in flight, no
        samples held."""
        if self._pending:
            raise RuntimeError("reset_lanes requires an empty pending "
                               "block (tick until the block flushes)")
        if self._inflight is not None:
            # the tick in flight belongs to the old tenants
            raise RuntimeError("reset_lanes with a pipelined tick in "
                               "flight: call drain() first")
        if self._hold.shape[1]:
            # the hold has one length for all lanes, so one lane's cannot be
            # emptied, and zeros in it would prepend silence to the new
            # tenant's stream
            raise RuntimeError("reset_lanes requires an empty sample hold: "
                               "push whole hops or drain the partial hop "
                               "first")
        # samples wire: pull the live history before the host copy changes;
        # the next device tick re-seeds queue and history from the host
        self._sync_host_recent()
        lanes = np.asarray(lanes, int)
        sel = np.zeros((self.n,), bool)
        sel[lanes] = True
        sel_dev = self._upload(sel)
        self.state = EngineState(*(
            torch.where(sel_dev.reshape((self.n,) + (1,) * ini.dim()),
                        ini[None], full)
            for full, ini in zip(self.state, self.enh.initial_state())))
        if self._ba_step is not None:
            self._ba_ptr = torch.where(sel_dev,
                                       torch.zeros_like(self._ba_ptr),
                                       self._ba_ptr)
        self._queue[lanes] = 0.0
        self._recent[lanes] = 0.0
        self._l[lanes] = 0


def _lane_devices(mesh, n_streams: int) -> list:
    """The devices of a fleet's 'data' shards; raises unless the lanes
    split evenly over them."""
    if mesh.group is not None:
        raise ValueError("a fleet serves from one process: give it a mesh "
                         "without a process group")
    data = mesh.shape["data"]
    if n_streams % data:
        raise ValueError(f"n_streams={n_streams} must divide the mesh data "
                         f"axis ({data})")
    return mesh.axis_devices("data")


class ShardedFleet:
    """N independent ``MultiStreamSession`` sub-fleets behind the surface of
    one: global lanes [i*b, (i+1)*b) live in shard i, and a fleet tick
    dispatches the shards one after another.  With ``pipeline_ticks``
    (samples wire) each shard returns its tick n-1 while its tick n is in
    flight, so one shard's download overlaps the others' device work.

    Per-lane outputs are those of one ``MultiStreamSession`` over the same
    lanes: lanes never interact, and each shard runs the same steps on its
    slice.  ``reset_lanes``, ``zero_queue_rows``, ``set_adaptation`` and the
    pushes route by global lane index, so a server takes a ``ShardedFleet``
    as it takes a single fleet.  Whether a split helps on a given card is a
    question for a measurement, not a property of this class.

    ``devices`` (one a sub-fleet): shard i runs on ``devices[i]`` (the
    enhancer rebuilt there where it is elsewhere), the fleet over a mesh's
    'data' axis that ``MultiStreamSession(mesh=...)`` builds; default: all
    on the enhancer's device.  ``states``: the lanes' carried states, split
    over the shards."""

    def __init__(self, enhancer, n_streams: int, sub_fleets: int,
                 block_frames: int = 1, use_block_adaptive: bool = False,
                 mesh=None, wire: str = "frames",
                 pipeline_ticks: bool = False, states=None, devices=None):
        self.n = int(n_streams)
        self.n_shards = int(sub_fleets)
        if self.n_shards < 1 or self.n % self.n_shards:
            raise ValueError(
                f"n_streams={self.n} must split evenly over "
                f"sub_fleets={self.n_shards}")
        self.lanes_per_shard = b = self.n // self.n_shards
        self.enh = enhancer
        devices = devices or [enhancer.device] * self.n_shards
        if len(devices) != self.n_shards:
            raise ValueError(f"{len(devices)} devices for {self.n_shards} "
                             f"sub-fleets")
        self.shards = []
        for i, dev in enumerate(devices):
            enh = enhancer.on_device(dev)
            st = (None if states is None else EngineState(
                *(f[i * b:(i + 1) * b].to(enh.device) for f in states)))
            self.shards.append(MultiStreamSession(
                enh, b, states=st, block_frames=block_frames,
                use_block_adaptive=use_block_adaptive, mesh=mesh, wire=wire,
                pipeline_ticks=pipeline_ticks))
        self._block = self.shards[0]._block

    # -- what a server reads (the shards tick together, so shard 0 stands
    #    for all) ----------------------------------------------------------
    @property
    def block_frames(self) -> int:
        return self._block

    @property
    def _pending(self):
        return self.shards[0]._pending

    @property
    def _l(self):
        return np.concatenate([sh._l for sh in self.shards])

    def _split(self, a: np.ndarray) -> list[np.ndarray]:
        b = self.lanes_per_shard
        return [a[i * b:(i + 1) * b] for i in range(self.n_shards)]

    def _route(self, lanes) -> list[np.ndarray]:
        """Global lane indices -> one array of local indices a shard."""
        lanes = np.asarray(lanes, int)
        if lanes.size and (lanes.min() < 0 or lanes.max() >= self.n):
            raise ValueError(f"lane index out of range 0..{self.n - 1}")
        b = self.lanes_per_shard
        return [lanes[lanes // b == i] - i * b
                for i in range(self.n_shards)]

    # -- the MultiStreamSession surface ------------------------------------
    def _raise_if_diverged(self) -> None:
        """The fleet-wide check, before any shard is touched: a shard's own
        check would come after the shards before it had advanced (or not at
        all, where the clocks differ only between shards)."""
        if np.unique(self._l).size > 1:
            raise ValueError("lane clocks diverged (reset_lanes was used); "
                             "call push_per_lane for ragged emission, and "
                             "drain lanes through zero_queue_rows")

    def push(self, samples: np.ndarray, quantize: bool = True) -> np.ndarray:
        self._raise_if_diverged()
        return np.stack(self.push_per_lane(samples, quantize), axis=0)

    def push_per_lane(self, samples: np.ndarray,
                      quantize: bool = True) -> list[np.ndarray]:
        samples = np.asarray(samples, np.float64)
        if samples.ndim != 2 or samples.shape[0] != self.n:
            raise ValueError(f"push expects ({self.n}, n) samples")
        out: list[np.ndarray] = []
        for sh, part in zip(self.shards, self._split(samples)):
            out.extend(sh.push_per_lane(part, quantize))
        return out

    def flush(self, quantize: bool = True) -> np.ndarray:
        self._raise_if_diverged()
        return np.concatenate(
            [sh.flush(quantize) for sh in self.shards], axis=0)

    def drain(self, quantize: bool = True) -> list[np.ndarray]:
        out: list[np.ndarray] = []
        for sh in self.shards:
            out.extend(sh.drain(quantize))
        return out

    def set_adaptation(self, on: bool, lanes=None,
                       quantize: bool = True) -> list[np.ndarray]:
        routed = [None] * self.n_shards if lanes is None \
            else self._route(lanes)
        out: list[np.ndarray] = []
        # every shard flushes its pending block, also one with no chosen
        # lane, so the fleet's emission clocks stay in lockstep
        for sh, loc in zip(self.shards, routed):
            out.extend(sh.set_adaptation(on, loc, quantize))
        return out

    def zero_queue_rows(self, lanes) -> None:
        for sh, loc in zip(self.shards, self._route(lanes)):
            if len(loc):
                sh.zero_queue_rows(loc)

    def reset_lanes(self, lanes) -> None:
        for sh, loc in zip(self.shards, self._route(lanes)):
            if len(loc):
                sh.reset_lanes(loc)
