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

Wire formats.  The hold, the queue, the clocks and the pending block are a
``stream.hops.HopFramer``; the overlap-add history stays on the device and
the output hops come down.  ``wire="frames"`` uploads a block's queue
and hops and frames them on the device ((B, K, framelength) frames where a
queue zeroed in mid-block broke the shift chain).  ``wire="samples"``
uploads a block's hops (int16 when they are integer-valued), frames them
from a queue kept on the device, applies MATLAB's int16 write there and
downloads int16 PCM; a block that is not one shift chain (a partial block,
a queue zeroed in mid-block) goes through the frames path, and the next
samples tick after it, or after a queue zeroed between blocks, uploads the
framer's queue.  ``pipeline_ticks`` (samples
wire) returns tick n-1 while tick n is in flight: on the card the PCM of a
tick is copied into pinned host memory without blocking and an event marks
it; the next push waits on that event only.  ``drain`` settles the last
tick.

Both wires add an output hop's chunks in the order of ``StreamingSession``
and ``dsp.stft.overlap_add`` (newest frame first), so on one device and
dtype a fleet lane and a solo session differ by nothing the overlap-add
introduces.

Traced (``runtime.profiling``), a push is tiled by the spans of
``StreamingSession``'s stages: ``stream.prep`` (the hold, the queue, the
hops, chain or frames stacked and cast, the int16 test, the uploads),
``stream.launch`` (``_device_tick``, or analysis, the frame loop or block
step, synthesis and the overlap-add), ``stream.fetch`` (the PCM or hops to
the host, or the pipelined tick's settle) and ``stream.emit``
(``_assemble``, the final stack).
"""

from __future__ import annotations

import numpy as np
import torch

from se_snmf_nat_tpu_torch.device import host_array
from se_snmf_nat_tpu_torch.enhance.state import EngineState, batch_state
from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
from se_snmf_nat_tpu_torch.runtime.profiling import request, stage
from se_snmf_nat_tpu_torch.stream.block_adaptive import ring_ptr0
from se_snmf_nat_tpu_torch.stream.hops import HopFramer, overlap_add_hops
from se_snmf_nat_tpu_torch.utils.matlab_compat import (
    matlab_int16_write_torch, matlab_wavwrite_table)


def _pcm(hops: np.ndarray) -> np.ndarray:
    """``enhanced_quantize`` of (B, ...) float hops, 16 lanes at a time."""
    out = np.empty(hops.shape, np.int16)
    for i in range(0, hops.shape[0], 16):
        out[i:i + 16] = enhanced_quantize(hops[i:i + 16])
    return out


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
        self._np_dtype = (np.float64 if enhancer.dtype == torch.float64
                          else np.float32)
        self._block = max(int(block_frames), 1)
        self._framer = HopFramer(enhancer.cfg, self.n, self._block)
        # the last ratio-1 synthesised frames of every lane, oldest first
        self._recent = torch.zeros(
            (self.n, s.framelength // s.frameshift - 1, s.framelength),
            dtype=enhancer.dtype, device=self._dev)
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
            self._ba_step = enhancer.block_step(self._block)
        self._ba_ptr = ring_ptr0(self.n, self._dev)
        self._wav_table = None
        self._samples = wire == "samples"
        self._pipeline = bool(pipeline_ticks)
        self._inflight = None
        # the samples wire's queue on the device as its last tick left it;
        # None after a frames-path tick (the next tick uploads the framer's)
        self._queue_dev = (torch.zeros((self.n, s.framelength),
                                       dtype=enhancer.dtype, device=self._dev)
                           if self._samples else None)

    @property
    def block_frames(self) -> int:
        """Frames a tick."""
        return self._block

    @property
    def _pending(self) -> list:
        """The pending block's hops."""
        return self._framer.pending

    @property
    def _l(self) -> np.ndarray:
        """Each lane's frame clock."""
        return self._framer.l

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
    def _tick(self, block,
              pcm: bool = False) -> list[tuple[np.ndarray, np.ndarray]]:
        """Run a framed block through one call on the device; returns one
        ((B, K, frameshift) hops, (B, K) emission mask) pair a block.  The
        mask is per lane because the lanes' clocks may differ after a
        ``reset_lanes``: a fresh lane emits nothing until its own frame
        number passes the algorithmic delay.  ``pcm``: the caller quantises,
        so a frames-path tick may bring its hops down as final int16 PCM."""
        if block is None:
            return []
        if self._samples and block.k == self._block \
                and block.hops is not None:
            return self._tick_samples(block)
        # frames path: settle a pipelined tick first (its audio is older
        # than this block's)
        return self._drain_inflight() + self._tick_frames(block, pcm)

    def _tick_samples(self, block):
        """The samples-wire tick: raw hops up, int16 PCM down; the device
        rebuilds the frames from its carried queue."""
        enh = self.enh
        hops = block.hops
        if self._queue_dev is None or not block.continues:
            self._queue_dev = self._upload(block.queue0).to(enh.dtype)
        # integer-valued samples (every int16 capture) go up as int16; the
        # cast to the compute dtype on the device is exact
        if (np.abs(hops).max(initial=0.0) <= 32767.0
                and np.all(hops == np.rint(hops))):
            hops_up = hops.astype(np.int16)
        else:
            hops_up = np.asarray(hops, self._np_dtype)
        hops_dev = self._upload(hops_up).to(enh.dtype)     # (B, K, shift)
        l0_dev = self._upload(block.l0)
        stage("stream.launch")
        pcm = self._device_tick(hops_dev, l0_dev)
        self._apply_deferred_adapt()
        if not self._pipeline:
            stage("stream.fetch")
            return self._settle((pcm.cpu(), None, block.emit))
        # pipelined: leave this tick in flight and hand back the one before
        if self._dev.type == "cuda":
            buf = torch.empty(pcm.shape, dtype=pcm.dtype, pin_memory=True)
            buf.copy_(pcm, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            buf, done = pcm, None
        prev, self._inflight = self._inflight, (buf, done, block.emit)
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
        self.state, _, ys = enh.session_block(frames, self.state, None,
                                              l0_dev)
        out_hops, self._recent = overlap_add_hops(self._recent, ys, shift)
        return matlab_int16_write_torch(out_hops.reshape(self.n, -1))

    def _settle(self, tick) -> list[tuple[np.ndarray, np.ndarray]]:
        """The emissions of a tick, once its PCM has landed on the host."""
        if tick is None:
            return []
        buf, done, emit = tick
        stage("stream.fetch")
        if done is not None:
            done.synchronize()
        pcm = buf.numpy().reshape(emit.shape + (-1,))
        stage("stream.emit")
        return [(pcm.astype(np.float64), emit)]

    def _drain_inflight(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Fetch and emit the pipelined tick in flight, if any."""
        tick, self._inflight = self._inflight, None
        return self._settle(tick)

    def drain(self, quantize: bool = True) -> list[np.ndarray]:
        """Emit the pipelined tick still in flight (``pipeline_ticks``
        sessions owe up to one block of audio between pushes)."""
        return self._assemble(self._drain_inflight(), self.n, quantize)

    def _tick_frames(self, block, pcm: bool = False):
        """The frames-wire tick: the block's frames framed on the device
        from its shift chain (the queue before it and its hops), or, where a
        zeroed queue broke the chain, (B, k, framelength) frames up; output
        hops down (also the samples wire's path for the blocks it cannot
        take).  With ``pcm`` the hops come down as the int16 PCM
        ``enhanced_quantize`` gives: MATLAB's int16 write in float64, the
        host's arithmetic, and wavwrite's requantisation as one gather."""
        enh, s = self.enh, self._s
        stage("stream.prep")
        chain = block.chain
        if chain is None:
            frames = self._upload(block.frames.astype(self._np_dtype)).to(
                enh.dtype)
        else:
            ext = self._upload(chain.astype(self._np_dtype)).to(enh.dtype)
            frames = ext.unfold(1, s.framelength,
                                s.frameshift)[:, 1:].contiguous()
        l0_dev = self._upload(block.l0)
        stage("stream.launch")
        self.state, self._ba_ptr, ys = enh.session_block(
            frames, self.state, self._ba_ptr, l0_dev, self._ba_step)
        hops, self._recent = overlap_add_hops(self._recent, ys,
                                              self._s.frameshift)
        if pcm:
            if self._wav_table is None:
                self._wav_table = torch.as_tensor(matlab_wavwrite_table(),
                                                  device=self._dev)
            # an int16 value indexes the table as a negative index does
            hops = self._wav_table[
                matlab_int16_write_torch(hops.double()).long()]
        self._queue_dev = None
        stage("stream.fetch")
        hops = host_array(hops)                           # (B, k, shift)
        stage("stream.emit")
        self._apply_deferred_adapt()
        return [(hops, block.emit)]

    @staticmethod
    def _assemble(emitted, n: int, quantize: bool) -> list[np.ndarray]:
        """Each lane's emitted hops, concatenated: int16 PCM, or float64
        with ``quantize=False``.  Hops that came down as int16 are PCM
        already; the others are quantised here, 16 lanes at a time
        (temporaries small enough for the heap).  Where every tick emits the
        same hops on every lane (clocks in lockstep) the lanes are cut and
        joined as one (n, m) array, a row a lane; the quantisation acts
        sample by sample, so either way a lane gets what quantising its own
        hops gives."""
        if quantize:
            emitted = [(hops if hops.dtype == np.int16 else _pcm(hops), emit)
                       for hops, emit in emitted]
        dtype = np.int16 if quantize else np.float64
        if all((emit == emit[:1]).all() for _, emit in emitted):
            y = np.concatenate([hops[:, emit[0]].reshape(n, -1)
                                for hops, emit in emitted] or
                               [np.zeros((n, 0), dtype)], axis=1)
            return list(y.astype(dtype, copy=False))
        out = []
        for i in range(n):
            lane = [hops[i][emit[i]].reshape(-1) for hops, emit in emitted]
            y = np.concatenate(lane) if lane else np.zeros((0,), dtype)
            out.append(y.astype(dtype, copy=False))
        return out

    def _clocks_diverged(self) -> bool:
        return np.unique(self._framer.l).size > 1

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
        with request("stream.prep"):
            # checked before anything is processed: raising afterwards
            # would lose this call's audio with the state already advanced
            if self._clocks_diverged():
                raise ValueError("lane clocks diverged (reset_lanes was "
                                 "used); call push_per_lane for ragged "
                                 "emission")
            out = self.push_per_lane(samples, quantize)
            stage("stream.emit")
            return np.stack(out, axis=0)

    def push_per_lane(self, samples: np.ndarray,
                      quantize: bool = True) -> list[np.ndarray]:
        """``push`` returning one 1-D array a lane (lanes may owe different
        lengths when their clocks differ)."""
        with request("stream.prep"):
            samples = np.asarray(samples, np.float64)
            if samples.ndim != 2 or samples.shape[0] != self.n:
                raise ValueError(f"push expects ({self.n}, n) samples")
            emitted = []
            for block in self._framer.push(samples):
                emitted.extend(self._tick(block, quantize))
            stage("stream.emit")
            return self._assemble(emitted, self.n, quantize)

    def flush(self, quantize: bool = True) -> np.ndarray:
        """End of stream on every lane: the partial hop is dropped and
        ``delay + 1`` flush frames run with the whole queue zeroed, in
        lockstep; then a partial block and a pipelined tick settle."""
        if self._clocks_diverged():       # before anything is processed
            raise ValueError("lane clocks diverged; drain lanes through "
                             "zero_queue_rows and push_per_lane instead")
        emitted = []
        for block in self._framer.flush():
            emitted.extend(self._tick(block, quantize))
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
        if self._ba_step is not None and self._framer.pending:
            self._deferred_adapt_ops.append((lanes, bool(on)))
            return self._assemble([], self.n, quantize)
        emitted = self._tick(self._framer.take(), quantize)
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
    def zero_queue_rows(self, lanes) -> None:
        """The flush loop's queue zeroing for single lanes: call before each
        drain tick of a lane at its end of stream (then feed it zero hops)
        to reproduce ``StreamingSession.flush`` on that lane alone."""
        self._framer.zero(lanes)

    @torch.no_grad()
    def reset_lanes(self, lanes) -> None:
        """Return lanes to the enhancer's initial state for a new tenant:
        engine state, overlap-add history, frame queue, ring pointer and
        clock restart; the other lanes are untouched.  Only at a tick
        boundary: no pending partial block, no pipelined tick in flight, no
        samples held."""
        if self._framer.pending:
            raise RuntimeError("reset_lanes requires an empty pending "
                               "block (tick until the block flushes)")
        if self._inflight is not None:
            # the tick in flight belongs to the old tenants
            raise RuntimeError("reset_lanes with a pipelined tick in "
                               "flight: call drain() first")
        if self._framer.hold.shape[1]:
            # the hold has one length for all lanes, so one lane's cannot be
            # emptied, and zeros in it would prepend silence to the new
            # tenant's stream
            raise RuntimeError("reset_lanes requires an empty sample hold: "
                               "push whole hops or drain the partial hop "
                               "first")
        lanes = np.asarray(lanes, int)
        sel = np.zeros((self.n,), bool)
        sel[lanes] = True
        sel_dev = self._upload(sel)
        self.state = EngineState(*(
            torch.where(sel_dev.reshape((self.n,) + (1,) * ini.dim()),
                        ini[None], full)
            for full, ini in zip(self.state, self.enh.initial_state())))
        self._ba_ptr = torch.where(sel_dev, torch.zeros_like(self._ba_ptr),
                                   self._ba_ptr)
        self._recent = self._recent.masked_fill(sel_dev[:, None, None], 0.0)
        self._framer.reset_lanes(lanes)


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
