"""TCP streaming-enhancement server: many tenants on one card (the port's
own copy of ``se_snmf_nat_tpu.runtime.server``; asyncio and NumPy only).

One server process owns the card and multiplexes N concurrent network
streams onto the lockstep ``MultiStreamSession`` fleet
(``stream/serving.py``): every tick runs the engine once for all lanes, so
the launches of a frame (one activation solve, one refit and the small
kernels around them) are paid once a fleet, not once a stream.

Protocol (per connection):
  server -> client   one JSON header line:
                       {"lane": i, "fs": 16000, "hop": 160}
                     or {"error": "busy"} when every lane is taken.
  client -> server   raw little-endian int16 PCM at fs, any chunking.
  server -> client   raw little-endian int16 enhanced PCM (same count as
                     (full input hops + 1) * hop, the offline length
                     contract), then EOF.
  client EOF (write side) starts the drain: the lane replays the flush
  semantics (queue zeroed per flush frame) on its own clock; a trailing
  partial hop of input is discarded exactly as ``StreamingSession.flush``
  discards held samples.

Lane lifecycle: a finished lane is reset (engine state, overlap-add
history, queue, clock) at the next block boundary and handed to the next
client: tenants never see each other's state.  Lane clocks are per lane, so
a client connecting mid-session still gets the first-frame noise seed and
the initial gating phase.

Scheduling is deterministic lockstep: a tick runs when every ACTIVE lane
has a full hop buffered (draining and idle lanes are always ready: they are
fed zeros).  A stalled client therefore stalls the fleet; that is the
lockstep contract (same as ``stream/serving.py``), appropriate for fixed
fleets of same-rate channels.  For best-effort real-time padding pass
``underrun_pad=True``: ticks then also fire on a wall-clock deadline and
lagging lanes are fed silence for the missed hops.

A tick runs on the event loop's thread and blocks it while the host
enqueues the fleet's work and waits for its PCM.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np


class _Lane:
    __slots__ = ("reader", "writer", "inbuf", "state", "hops_in",
                 "sent", "eof", "dead", "gen")

    def __init__(self):
        self.reader = None
        self.writer = None
        self.inbuf = bytearray()
        # free -> pending (awaiting block-boundary reset) -> active
        #      -> draining (buffered hops exhausted after client EOF)
        #      -> done -> free
        self.state = "free"
        self.hops_in = 0
        self.sent = 0
        self.eof = False
        self.dead = False    # writer gone/too slow: tick skips its output
        # tenancy generation: bumped on claim and on free, so a stale
        # reader coroutine from a previous tenant can never inject bytes
        # or EOF into the next tenant's stream
        self.gen = 0

    @property
    def owed(self) -> int:
        # (full input hops + 1) hops of output — the offline contract
        return (self.hops_in + 1)


class EnhanceServer:
    """Asyncio TCP server over a MultiStreamSession fleet."""

    def __init__(self, enhancer, n_lanes: int = 8, block_frames: int = 8,
                 use_block_adaptive: bool = False,
                 host: str = "127.0.0.1", port: int = 0,
                 underrun_pad: bool = False, tick_deadline_s: float = 0.01,
                 max_write_buffer: int = 1 << 20, wire: str | None = None,
                 sub_fleets: int = 1):
        from se_snmf_nat_tpu_torch.stream.serving import (
            MultiStreamSession, ShardedFleet)
        # the samples wire by default (int16 up and down; the lane
        # lifecycle, reset, drain and flush, falls back to the frames path
        # by itself); the block-adaptive serving mode requires the frames
        # wire
        if wire is None:
            wire = "frames" if use_block_adaptive else "samples"
        if sub_fleets > 1:
            # the same tick surface, so the server does not know whether
            # its fleet is sharded
            self.session = ShardedFleet(
                enhancer, n_lanes, sub_fleets, block_frames=block_frames,
                use_block_adaptive=use_block_adaptive, wire=wire)
        else:
            self.session = MultiStreamSession(
                enhancer, n_lanes, block_frames=block_frames,
                use_block_adaptive=use_block_adaptive, wire=wire)
        self.hop = enhancer.cfg.signal.frameshift
        self.n = n_lanes
        self.host, self.port = host, port
        self.lanes = [_Lane() for _ in range(n_lanes)]
        self.underrun_pad = underrun_pad
        self.tick_deadline_s = tick_deadline_s
        self.max_write_buffer = max_write_buffer
        self._wake: asyncio.Event | None = None
        self._server = None
        self._tick_task = None
        self.ticks = 0
        # transports of freed lanes that are still flushing their last
        # bytes, each with the timer that aborts it at its deadline
        self._flushing: dict = {}
        self._flushing_deadline_s = 5.0

    # ------------------------------------------------------------------
    async def start(self):
        self._wake = asyncio.Event()
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._tick_task = asyncio.create_task(self._tick_loop())
        return self

    async def stop(self):
        if self._tick_task:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except asyncio.CancelledError:
                pass
        # abort live lane transports BEFORE wait_closed: py3.12+
        # Server.wait_closed() awaits every client transport, so closing
        # them afterwards would deadlock shutdown with clients connected
        for lane in self.lanes:
            if lane.writer is not None:
                try:
                    lane.writer.transport.abort()
                except Exception:
                    pass
        self._abort_flushing()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self):
        if self._server is None:      # idempotent after start()
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------------
    async def _on_client(self, reader, writer):
        idx = next((i for i, ln in enumerate(self.lanes)
                    if ln.state == "free"), None)
        if idx is None:
            writer.write(json.dumps({"error": "busy"}).encode() + b"\n")
            await writer.drain()
            writer.close()
            return
        lane = self.lanes[idx]
        lane.gen += 1
        gen = lane.gen
        lane.reader, lane.writer = reader, writer
        lane.inbuf = bytearray()
        lane.hops_in = 0
        lane.sent = 0
        lane.eof = False
        lane.dead = False
        lane.state = "pending"        # reset happens at a block boundary
        writer.write(json.dumps(
            {"lane": idx, "fs": self.session.enh.cfg.signal.fs,
             "hop": self.hop}).encode() + b"\n")
        await writer.drain()
        self._wake.set()
        try:
            while True:
                data = await reader.read(65536)
                if not data or lane.gen != gen:
                    break
                if lane.state in ("pending", "active"):
                    lane.inbuf.extend(data)
                    self._wake.set()
                # draining/done lanes no longer consume input: discard so
                # a chatty half-closed client can't grow the buffer
        except OSError:
            pass                       # reset/abort/timeout — all mean EOF
        finally:
            # buffered full hops still play out; the drain (and the
            # discard of a trailing partial hop — flush() hold semantics)
            # starts once the buffer runs dry (_tick_once).  The finally
            # guarantees EOF is recorded however the reader dies, so the
            # lane can never wedge the lockstep fleet; the gen check keeps
            # a stale handler from EOF-ing the NEXT tenant.
            if lane.gen == gen:
                lane.eof = True
                self._wake.set()

    # ------------------------------------------------------------------
    def _hop_bytes(self) -> int:
        return self.hop * 2

    def _tick_ready(self) -> bool:
        """A tick may run iff some lane needs progress and no ACTIVE lane
        would underrun."""
        any_work = False
        for lane in self.lanes:
            if lane.state == "draining":
                any_work = True
            elif lane.state == "active":
                if len(lane.inbuf) >= self._hop_bytes() or lane.eof:
                    any_work = True
                else:
                    if not self.underrun_pad:
                        return False
        if not any_work and self.session._pending and any(
                ln.state in ("pending", "done") for ln in self.lanes):
            # lanes are waiting on a block boundary and nothing else will
            # drive the fleet there — tick the partial block through
            any_work = True
        return any_work

    def _lane_housekeeping(self):
        """Block-boundary lane transitions: activate waiting tenants, free
        finished lanes.  Only legal with no queued partial block."""
        if self.session._pending:
            return
        done = [i for i, ln in enumerate(self.lanes) if ln.state == "done"]
        idxs = [i for i, ln in enumerate(self.lanes)
                if ln.state == "pending"]
        if done or idxs:
            self.session.reset_lanes(done + idxs)
        for i in done:
            ln = self.lanes[i]
            ln.gen += 1               # detach any stale reader coroutine
            if ln.writer is not None:
                # guarantee the transport is CLOSED before the reference
                # is dropped: a client that died mid-write can leave the
                # drain-completion write_eof/close pair half-done, and a
                # leaked open transport makes Server.wait_closed() (which
                # py3.12+ awaits all client transports) hang stop()
                # forever.  abort() is a no-op on closed transports; one
                # that is closing with bytes still unflushed is given a
                # deadline instead (_abort_or_flush).
                try:
                    self._abort_or_flush(ln)
                except Exception:
                    pass
            ln.state = "free"
            ln.reader = ln.writer = None
            ln.dead = False
        for i in idxs:
            self.lanes[i].state = "active"

    def _abort_or_flush(self, ln: _Lane) -> None:
        """Close the transport of a lane that is being freed.  abort() on a
        transport that is closing with bytes still unflushed (a slow reader
        that is alive) would discard the tail of the lane's last PCM: such
        a transport is left to flush, and closes itself when it has.  The
        lane is free by then and ``max_write_buffer`` no longer watches it,
        so a timer aborts it ``_flushing_deadline_s`` later (a no-op if it
        has closed): a client that never reads holds its socket and buffer
        no longer than that.  ``stop`` aborts what is left."""
        transport = ln.writer.transport
        if (ln.dead or not transport.is_closing()
                or transport.get_write_buffer_size() == 0):
            transport.abort()
            return
        self._flushing[transport] = asyncio.get_running_loop().call_later(
            self._flushing_deadline_s, self._abort_flushing, transport)

    def _abort_flushing(self, transport=None) -> None:
        """Abort one flushing transport (its deadline has come), or all of
        them.  One whose buffer is empty by now has closed itself, and is
        only forgotten: abort() on it raises inside asyncio (Python 3.12),
        its loop being gone."""
        for t in list(self._flushing) if transport is None else [transport]:
            timer = self._flushing.pop(t, None)
            if timer is not None:
                timer.cancel()
            try:
                if t.get_write_buffer_size() > 0:
                    t.abort()
            except Exception:
                pass

    def _kill_lane(self, lane: _Lane) -> None:
        """Stop serving a dead or too-slow client without stalling the
        fleet: abort the transport (which also wakes its reader task into
        EOF), mark the lane dead so ticks skip its writes, and let it
        drain out on the lockstep clock so the lane frees normally."""
        lane.dead = True
        lane.eof = True
        try:
            lane.writer.transport.abort()
        except Exception:
            pass

    async def _tick_once(self):
        hb = self._hop_bytes()
        hops = np.zeros((self.n, self.hop))
        drains = []
        for i, lane in enumerate(self.lanes):
            if lane.state == "active":
                if len(lane.inbuf) >= hb:
                    raw = bytes(lane.inbuf[:hb])
                    del lane.inbuf[:hb]
                    hops[i] = np.frombuffer(raw, np.int16).astype(
                        np.float64)
                    lane.hops_in += 1
                    continue
                if lane.eof:
                    lane.inbuf.clear()     # partial-hop discard (flush)
                    lane.state = "draining"
                else:
                    # underrun_pad tick: the lane consumes a silence hop
                    # ON ITS CLOCK, so the output budget advances with the
                    # filler and the real-audio tail stays owed (and is
                    # delivered at drain) instead of being cut off
                    lane.hops_in += 1
            if lane.state == "draining":
                drains.append(i)
        if drains:
            # per-lane reference flush semantics: queue zeroed each drain
            # tick, zero hops in (stream/serving.zero_queue_rows)
            self.session.zero_queue_rows(drains)
        self.ticks += 1
        outs = self.session.push_per_lane(hops)
        for i, lane in enumerate(self.lanes):
            y = outs[i]
            if lane.state not in ("active", "draining") or not len(y):
                continue
            budget = lane.owed * self.hop - lane.sent
            y = y[: max(budget, 0)]
            if not len(y):
                continue
            lane.sent += len(y)
            if lane.dead:
                continue
            # write WITHOUT awaiting drain: one client that stops reading
            # must not stall every other tenant's tick.  asyncio buffers
            # the bytes; a reader lagging past max_write_buffer is cut off.
            try:
                lane.writer.write(y.astype("<i2").tobytes())
                if (lane.writer.transport.get_write_buffer_size()
                        > self.max_write_buffer):
                    self._kill_lane(lane)
            except (OSError, RuntimeError):
                self._kill_lane(lane)
        for i, lane in enumerate(self.lanes):
            if (lane.state == "draining"
                    and lane.sent >= lane.owed * self.hop):
                if not lane.dead:
                    try:
                        lane.writer.write_eof()
                    except (OSError, RuntimeError):
                        pass
                    try:
                        lane.writer.close()   # separate: eof failing must
                    except (OSError, RuntimeError):   # not skip the close
                        pass
                lane.state = "done"

    async def _tick_loop(self):
        while True:
            self._lane_housekeeping()
            if self._tick_ready():
                await self._tick_once()
                # yield so reader tasks can refill between ticks
                await asyncio.sleep(0)
                continue
            if (self.underrun_pad
                    and any(ln.state == "active" for ln in self.lanes)):
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           self.tick_deadline_s)
                except asyncio.TimeoutError:
                    await self._tick_once()   # pad laggards with silence
                    continue
            else:
                await self._wake.wait()
            self._wake.clear()


async def enhance_over_socket(host: str, port: int, samples: np.ndarray,
                              chunk: int = 4096) -> np.ndarray:
    """Minimal reference client: stream int16-scale samples, return the
    enhanced waveform."""
    reader, writer = await asyncio.open_connection(host, port)
    header = json.loads((await reader.readline()).decode())
    if "error" in header:
        writer.close()
        raise RuntimeError(f"server refused: {header['error']}")

    async def feed():
        pcm = np.asarray(samples).astype("<i2").tobytes()
        for off in range(0, len(pcm), chunk):
            writer.write(pcm[off: off + chunk])
            await writer.drain()
        writer.write_eof()

    feed_task = asyncio.create_task(feed())
    out = bytearray()
    while True:
        data = await reader.read(65536)
        if not data:
            break
        out.extend(data)
    await feed_task
    writer.close()
    return np.frombuffer(bytes(out), np.int16)
