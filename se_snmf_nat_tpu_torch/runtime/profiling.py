"""Tracing, stage timers and the measurement helpers of the port
(counterpart of the reference package's ``runtime/profiling.py``).

  * ``trace(dir)``     — a ``torch.profiler.profile`` around the block, CPU
                         activities and, where a card is present, CUDA
                         ones; a Chrome trace lands in ``dir`` (open it in
                         Perfetto or ``chrome://tracing``).
  * ``span(name)``     — the one span primitive: while a torch profiler is
                         active, records (name, start, end) on
                         ``time.perf_counter`` and opens a
                         ``torch.profiler.record_function``, so the span
                         shows up named in a trace; otherwise a flag test
                         and a context manager.  ``request(first)`` and
                         ``stage(name)`` are spans that tile one request
                         stage by stage; ``count`` and ``device_counters``
                         keep counters; ``spans()`` and ``counters()`` read
                         the profiled session's.
  * ``StageTimer``     — named wall-clock stages with audio-second
                         accounting (a copy of the reference's); each stage
                         is also the span ``runner.<stage>``.
  * ``measure_*``      — the serving and latency measurements of the
                         ``bench`` command, each with the reference's
                         arguments, defaults and report keys.
  * ``card_line``, ``cuda_ms``, ``bound`` — the card's name and power
                         limit, CUDA-event timing, and the roofline
                         (H100 float32 peaks) shared by ``bench`` and
                         ``chip_smoke.py``.

How the helpers time, on a card next to its host: a step or request by the
host clock around work that ends in a device synchronisation (or a copy to
the host), the best or median of several warm windows as the reference
takes them; device time by CUDA events around many calls after a warm-up
(the host clock where the device is the CPU).  Every report names its
``timing``.  The fleet rows also carry the peak device memory of the row
(``peak_mib``; None on the CPU), and a fleet that does not fit raises with
its size.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

PEAK_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM device memory


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    RECORDER.live = False                   # a session of its own
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


# ------------------------------------------------------------------- spans
#
# What happens inside a request, named on the host's clock.  Nothing is
# recorded unless a torch profiler is active, so the spans cost a request
# one flag test each when nobody looks.  A profiled session starts at the
# first span that finds the profiler on after one that found it off (or
# after ``trace`` opened the profiler; two profilers opened one after the
# other with no span between them are one session): the span buffer is
# cleared and the counters' starting values are taken (one device-side copy
# a counter buffer); ``spans()`` and ``counters()`` give that session's,
# also after the profiler has stopped, until the next session starts.
# Spans and kernel intervals share ``time.perf_counter`` once the kernels
# are moved onto it by synchronisation markers.
#
# The counters the program keeps, by name: ``batch.frames_computed``,
# ``batch.frames_true``, ``batch.lanes``, ``batch.lanes_int16``
# (``SnmfEnhancer.enhance_batch``, host); ``k2.lane_trips``,
# ``k2.active_lanes`` (K2's work tally) and ``k3.columns``,
# ``k3.column_trips`` (K3's: the columns solved and their trips), added by
# the kernels on the card and by the plain paths on the host
# (``kernels.mu.K2_COUNTERS``, ``K3_COUNTERS``); ``runner.files``
# (``BatchRunner``, host: the files read).

SPAN_CAP = 1 << 20          # spans a session keeps; the rest are counted


class _Open(threading.local):
    """The request open on this thread: its depth and its open stage."""
    depth = 0
    stage = None


class Recorder:
    """The process's spans and counters.

    Host counters (``count``) are running totals; device counters are
    int64 buffers written by kernels (``device_counters``: one buffer a set
    of names and a device, allocated once and never moved, so a CUDA graph
    captured later keeps a valid pointer).  Both are read as the change
    since the session's start."""

    def __init__(self):
        self.live = False
        self.spans: list = []
        self.dropped = 0
        self.host: dict[str, int] = {}
        self.host_start: dict[str, int] = {}
        self.device: dict = {}          # (names, device) -> (buf, start)
        self.open = _Open()
        self.lock = threading.Lock()    # for the host counters

    def start_session(self) -> None:
        self.spans = []
        self.dropped = 0
        with self.lock:
            self.host_start = dict(self.host)
        for buf, start in self.device.values():
            if not torch.cuda.is_current_stream_capturing():
                start.copy_(buf)
        self.live = True

    def add(self, name: str, start: float, end: float) -> None:
        if len(self.spans) < SPAN_CAP:
            self.spans.append((name, start, end))
        else:
            self.dropped += 1

    def device_counters(self, names: tuple, device) -> torch.Tensor:
        key = (names, device)
        entry = self.device.get(key)
        if entry is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the counters {names} are allocated at "
                                   f"their first use, which must not be "
                                   f"captured into a CUDA graph")
            buf = torch.zeros(len(names), dtype=torch.int64, device=device)
            entry = self.device[key] = (buf, torch.zeros_like(buf))
        return entry[0]

    def counters(self) -> dict[str, int]:
        with self.lock:
            out = {k: v - self.host_start.get(k, 0)
                   for k, v in self.host.items()}
        for (names, _), (buf, start) in self.device.items():
            for name, v in zip(names, (buf - start).tolist()):
                out[name] = out.get(name, 0) + int(v)
        return out


RECORDER = Recorder()
_profiler_on = torch._C._autograd._profiler_enabled


class _Off:
    """The span of nobody looking."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """An open span: the record_function's enter and exit lie inside it."""
    __slots__ = ("name", "start", "_rf")

    def __init__(self, name: str):
        self.name = name

    def begin(self, t: float) -> "_Span":
        self.start = t
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def end(self, t: float | None = None) -> None:
        self._rf.__exit__(None, None, None)
        RECORDER.add(self.name, self.start,
                     time.perf_counter() if t is None else t)

    def __enter__(self):
        return self.begin(time.perf_counter())

    def __exit__(self, *exc):
        self.end()
        return False


def span(name: str):
    """A named span around a ``with`` block (see above)."""
    if _profiler_on():
        if not RECORDER.live:
            RECORDER.start_session()
        return _Span(name)
    RECORDER.live = False
    return _OFF


class _Request:
    """A request tiled by its stages: entering opens ``first`` (or, inside
    an open request, moves it to ``first``); leaving the outermost request
    ends whichever stage is open."""
    __slots__ = ("first",)

    def __init__(self, first: str):
        self.first = first

    def __enter__(self):
        op = RECORDER.open
        op.depth += 1
        if op.stage is None:
            op.stage = _Span(self.first).begin(time.perf_counter())
        else:
            stage(self.first)
        return self

    def __exit__(self, *exc):
        op = RECORDER.open
        op.depth -= 1
        if op.depth == 0 and op.stage is not None:
            op.stage.end()
            op.stage = None
        return False


def request(first: str):
    """Around a request whose stages ``stage`` switches between: the
    stages' spans tile it, one clock reading ending one and starting the
    next."""
    if _profiler_on():
        if not RECORDER.live:
            RECORDER.start_session()
        return _Request(first)
    RECORDER.live = False
    return _OFF


def stage(name: str) -> None:
    """The open request's next stage (nothing outside a profiled request,
    nor when ``name`` is the stage already open)."""
    cur = RECORDER.open.stage
    if cur is None or cur.name == name:
        return
    t = time.perf_counter()
    cur.end(t)
    RECORDER.open.stage = _Span(name).begin(t)


def record(name: str, start: float, end: float) -> None:
    """A span timed on another thread, recorded from this one: torch keeps
    the profiler's state a thread's own, so a thread it does not follow
    reads it as off and must not open spans of its own."""
    if _profiler_on():
        if not RECORDER.live:
            RECORDER.start_session()
        RECORDER.add(name, start, end)
    else:
        RECORDER.live = False


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name``."""
    with RECORDER.lock:
        RECORDER.host[name] = RECORDER.host.get(name, 0) + int(n)


def device_counters(names: tuple, device) -> torch.Tensor:
    """The int64 buffer of the counters ``names`` on ``device``, for a
    kernel to add to."""
    return RECORDER.device_counters(names, device)


def spans() -> list[tuple[str, float, float]]:
    """The profiled session's spans: (name, start, end), seconds on
    ``time.perf_counter``, in the order they ended."""
    return list(RECORDER.spans)


def counters() -> dict[str, int]:
    """Each counter's change since the profiled session started (one
    transfer a device buffer)."""
    return RECORDER.counters()


@dataclass
class StageTimer:
    """Accumulates wall time per named stage plus processed audio seconds."""

    stages: dict = field(default_factory=dict)
    audio_seconds: float = 0.0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(f"runner.{name}"):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + time.perf_counter() - t0

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    def report(self) -> dict:
        out = {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.total, 4),
            "audio_seconds_per_s": round(
                self.audio_seconds / self.total, 2) if self.total else 0.0,
            "stages": {k: round(v, 4) for k, v in self.stages.items()},
        }
        return out

    def json(self) -> str:
        return json.dumps(self.report())


# ---------------------------------------------------------------- roofline
def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``reps`` calls
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    return window_ms(fn, torch.device("cuda"), n=reps, windows=1)


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(bound ms, the resource that sets it): the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_ms(fn, device: torch.device, n: int = 1,
              windows: int = 3) -> float:
    """Best over ``windows`` windows of ``n`` calls of ``fn`` of the ms a
    call: CUDA events on the card (device time), the host clock around
    calls that end in a synchronisation elsewhere.  The caller warms
    first."""
    laps = []
    for _ in range(windows):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            stop.record()
            stop.synchronize()
            laps.append(start.elapsed_time(stop) / n)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            laps.append((time.perf_counter() - t0) * 1e3 / n)
    return min(laps)


DEVICE_TIMING = ("CUDA events around the window on the card, the host "
                 "clock on the CPU")


@contextlib.contextmanager
def _row_memory(device: torch.device, what: str, peak: list):
    """Peak device memory of one row into ``peak`` (MiB; None on the CPU);
    a row that does not fit raises with ``what`` in the message."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(f"{what} does not fit on {device}: {e}") from e
    peak.append(torch.cuda.max_memory_allocated(device) / 2 ** 20
                if cuda else None)


def _int_hops(rng, shape) -> np.ndarray:
    # integer-valued synthetic audio: real captures are int16 PCM, which
    # the samples wire uploads at 2 bytes/sample
    return np.rint(rng.standard_normal(shape) * 2000.0)


# ---------------------------------------------------------------- serving
def measure_serving_capacity(enh, fleet_sizes=(1, 8, 32, 64, 128, 256),
                             block_frames_grid=(8, 16),
                             n_ticks: int = 30,
                             wire: str = "samples") -> dict:
    """Largest lockstep fleet that still meets the real-time deadline.

    For each (block_frames, fleet size B), drives a ``MultiStreamSession``
    (stream/serving.py) with ``block_frames``-hop ticks of synthetic audio
    through ``push`` and records the median per-tick host time (upload,
    device work and the PCM back).  A fleet is real-time when one tick
    completes inside its own audio duration (block_frames x 10 ms); the
    report carries the whole grid, a capacity per latency tier.  With
    ``wire='samples'`` a last row per size runs ``pipeline_ticks`` at the
    first block size (a tick's PCM copy overlaps the next tick: one more
    block of latency)."""
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession

    s = enh.cfg.signal
    rng = np.random.default_rng(0)
    blocks = []
    grid = [(bf, False) for bf in block_frames_grid]
    if wire == "samples":
        grid.append((block_frames_grid[0], True))
    for bf, pipelined in grid:
        tick_samples = bf * s.frameshift
        deadline_ms = tick_samples / s.fs * 1e3
        rows = []
        for b in fleet_sizes:
            peak = []
            with _row_memory(enh.device, f"a fleet of {b} lanes", peak):
                fleet = MultiStreamSession(enh, b, block_frames=bf,
                                           wire=wire,
                                           pipeline_ticks=pipelined)
                x = _int_hops(rng, (b, tick_samples))
                for _ in range(3):                      # warm
                    fleet.push(x)
                laps = []
                for _ in range(n_ticks):
                    t0 = time.perf_counter()
                    fleet.push(x)
                    laps.append(time.perf_counter() - t0)
                del fleet
            tick_ms = float(np.median(laps) * 1e3)
            rows.append({"fleet": int(b), "tick_ms": tick_ms,
                         "real_time": bool(tick_ms < deadline_ms),
                         "peak_mib": peak[0]})
        ok = [r["fleet"] for r in rows if r["real_time"]]
        blocks.append({"block_frames": bf, "pipelined": pipelined,
                       "deadline_ms": round(deadline_ms, 1),
                       "latency_blocks": 2 if pipelined else 1,
                       "max_real_time_fleet": max(ok) if ok else 0,
                       "table": rows})
    return {"wire": wire,
            "max_real_time_fleet": max(b["max_real_time_fleet"]
                                       for b in blocks),
            "timing": f"host clock around push, median of {n_ticks} ticks "
                      f"after 3 warm ticks",
            "blocks": blocks}


def _fleet_tick_window(enh, lanes: int, block_frames: int, n_inner: int,
                       rng, session=None):
    """One sub-fleet's window of ``n_inner`` consecutive device ticks — the
    shared core of both device-ceiling measurements.

    Builds one samples-wire ``MultiStreamSession`` of ``lanes`` lanes (or
    measures a caller-provided ``session``, e.g. one ``ShardedFleet``
    shard), and returns ``(ticks, make_hops, carry)``: ``ticks(hops,
    *carry) -> carry'`` runs ``n_inner`` ticks of the session's device half
    (``MultiStreamSession._device_tick``: framing from the device queue,
    analysis, the engine's frame loop, synthesis, overlap-add and the int16
    write; no host copy of the PCM) on hops (lanes, block_frames,
    frameshift) already on the device, the carry (queue, overlap-add
    history, state, first frame numbers) chained tick to tick;
    ``make_hops()`` draws a hop batch on the device.  The window is run
    once, to warm, before it is returned."""
    from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession

    shift = enh.cfg.signal.frameshift
    dev = enh.device
    fleet = session if session is not None else MultiStreamSession(
        enh, lanes, block_frames=block_frames, wire="samples")

    def make_hops():
        return torch.as_tensor(_int_hops(rng, (lanes, block_frames, shift)),
                               dtype=enh.dtype, device=dev)

    @torch.no_grad()
    def ticks(hops, queue, recent, state, l0):
        fleet._queue_dev, fleet._recent, fleet.state = \
            queue, recent, state
        for _ in range(n_inner):
            fleet._device_tick(hops, l0)
            l0 = l0 + block_frames
        return fleet._queue_dev, fleet._recent, fleet.state, l0

    l0 = torch.ones((lanes,), dtype=torch.int64, device=dev)
    carry = ticks(make_hops(), fleet._queue_dev, fleet._recent,
                  fleet.state, l0)                          # warm
    sync(dev)
    return ticks, make_hops, carry


def measure_serving_device_ceiling(enh, fleet_sizes=(128, 256, 384, 512),
                                   block_frames: int = 8,
                                   n_inner: int = 25) -> dict:
    """Device time of a samples-wire fleet tick, the wire excluded: the
    tick's device half (``_fleet_tick_window``) runs ``n_inner``
    consecutive ticks between two CUDA events, so a window's time over
    ``n_inner`` is the device time a tick, with no PCM copy to the host;
    the best of 3 warm windows.  The engine's frame loop is launched from
    the host, so where the host launches more slowly than the card runs,
    the window includes the card waiting for launches.  A fleet is
    compute-real-time when that tick fits its own audio duration."""
    s = enh.cfg.signal
    deadline_ms = block_frames * s.frameshift / s.fs * 1e3
    rng = np.random.default_rng(0)
    rows = []
    for b in fleet_sizes:
        peak = []
        with _row_memory(enh.device, f"a fleet of {b} lanes", peak):
            ticks, make_hops, carry = _fleet_tick_window(
                enh, b, block_frames, n_inner, rng)
            hops = make_hops()

            def window():
                nonlocal carry
                carry = ticks(hops, *carry)
            tick_ms = window_ms(window, enh.device) / n_inner
            del ticks, carry
        rows.append({
            "fleet": int(b),
            "device_tick_ms": tick_ms,
            "device_ms_per_lane": tick_ms / b,
            "real_time": bool(tick_ms < deadline_ms),
            "peak_mib": peak[0]})
    ok = [r["fleet"] for r in rows if r["real_time"]]
    return {"block_frames": block_frames,
            "deadline_ms": round(deadline_ms, 1),
            "max_compute_real_time_fleet": max(ok) if ok else 0,
            "timing": f"{DEVICE_TIMING}; best of 3 windows of {n_inner} "
                      f"chained ticks",
            "note": "the samples-wire tick's device half (no PCM copy to "
                    "the host); the frame loop's launches come from the "
                    "host, so a launch-bound tick includes the card's wait "
                    "for them",
            "table": rows}


def measure_serving_device_ceiling_sharded(
        enh, shard_plans=((2, 128), (3, 96), (4, 80)),
        block_frames: int = 8, n_inner: int = 25) -> dict:
    """Device time of a ``ShardedFleet`` round: its N sub-fleets ticked one
    after another, each through its own ``_fleet_tick_window``, all N
    windows between two CUDA events; the window's time over ``n_inner`` is
    the device time of one round of the whole fleet (best of 3).  The
    program timed is the ``ShardedFleet``'s own shards, the object ``cli
    serve --sub-fleets`` deploys; ``measure_serving_product_path`` drives
    the same object through ``push``."""
    from se_snmf_nat_tpu_torch.stream.serving import ShardedFleet

    s = enh.cfg.signal
    deadline_ms = block_frames * s.frameshift / s.fs * 1e3
    rng = np.random.default_rng(0)
    rows = []
    for n_shards, lanes in shard_plans:
        total = n_shards * lanes
        peak = []
        with _row_memory(enh.device, f"a fleet of {n_shards} x {lanes} "
                                     f"lanes", peak):
            fleet = ShardedFleet(enh, total, sub_fleets=n_shards,
                                 block_frames=block_frames, wire="samples")
            wins = [_fleet_tick_window(enh, lanes, block_frames, n_inner,
                                       rng, session=sh)
                    for sh in fleet.shards]
            hops = [make_hops() for _, make_hops, _ in wins]
            carries = [carry for _, _, carry in wins]

            def window():
                for i, (ticks, _, _) in enumerate(wins):
                    carries[i] = ticks(hops[i], *carries[i])
            tick_ms = window_ms(window, enh.device) / n_inner
            del fleet, wins, carries
        rows.append({
            "shards": int(n_shards), "lanes_per_shard": int(lanes),
            "total_streams": int(total),
            "device_round_ms": tick_ms,
            "device_ms_per_lane": tick_ms / total,
            "real_time": bool(tick_ms < deadline_ms),
            "peak_mib": peak[0]})
    ok = [r["total_streams"] for r in rows if r["real_time"]]
    return {"block_frames": block_frames,
            "deadline_ms": round(deadline_ms, 1),
            "max_compute_real_time_streams": max(ok) if ok else 0,
            "shipped_program": True,
            "timing": f"{DEVICE_TIMING}; best of 3 windows of {n_inner} "
                      f"rounds, every shard's ticks in one window",
            "note": "N sub-fleets of a ShardedFleet ticked one after "
                    "another on one device (the cli serve --sub-fleets "
                    "object), the device half of each tick",
            "table": rows}


def measure_hop_latency(enh, x: "np.ndarray", n_rep: int = 3,
                        n_calls: int = 60) -> dict:
    """Per-hop device time beside a single-hop push's wall time.

    The reference's real-time budget is one 10 ms hop per engine step
    (settings/initial_setting_SNMF_NAT.m:22-27).

      * ``device_ms_per_hop`` — the exact plan (``_run_exact``: analysis,
        the frame loop, synthesis, overlap-add) over the whole utterance,
        ``n_rep`` runs after a warm one between two CUDA events, over the
        frames the loop steps (it stops at the last real frame, so bucket
        padding is not counted).  The loop's launches come from the host,
        so this is the launch-bound step as the card sees it.
      * ``singlehop_wall_ms`` — median host time of a ``block_frames=1``
        ``StreamingSession`` push of one hop.
      * ``dispatch_overhead_ms`` — their difference: what a push costs
        beside the step itself (host queue, upload, the copy back).
    """
    from se_snmf_nat_tpu_torch.enhance.state import batch_state
    from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

    s = enh.cfg.signal
    true_frames = enh.frames_for(np.asarray(x, np.float64))
    t_true = true_frames.shape[0]
    frames = torch.as_tensor(enh._pad_frames(true_frames), dtype=enh.dtype,
                             device=enh.device)[None]
    st0 = batch_state(enh.initial_state(), 1)

    @torch.no_grad()
    def run():
        enh._run_exact(frames, st0, [t_true])

    run()                                                   # warm
    sync(enh.device)
    device_ms_per_hop = window_ms(run, enh.device, n=n_rep,
                                  windows=1) / t_true

    sess = StreamingSession(enh, block_frames=1)
    hop = np.zeros(s.frameshift)
    sess.push(np.asarray(x)[: s.frameshift * 4])            # warm
    laps = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        sess.push(hop, quantize=False)
        laps.append(time.perf_counter() - t0)
    singlehop_wall_ms = float(np.median(laps) * 1e3)

    hop_budget_ms = s.frameshift / s.fs * 1e3
    return {
        "device_ms_per_hop": device_ms_per_hop,
        "singlehop_wall_ms": singlehop_wall_ms,
        "dispatch_overhead_ms": singlehop_wall_ms - device_ms_per_hop,
        "hop_budget_ms": round(hop_budget_ms, 1),
        "device_within_budget": bool(device_ms_per_hop < hop_budget_ms),
        "singlehop_within_budget_here": bool(
            singlehop_wall_ms < hop_budget_ms),
        "n_frames": int(t_true),
        "timing": f"device: {DEVICE_TIMING}, {n_rep} runs of the exact "
                  f"plan after a warm one; push: host clock, median of "
                  f"{n_calls}",
    }


def measure_serving_product_path(
        enh, plans=((1, 128), (1, 192), (2, 128), (3, 96), (4, 80)),
        block_frames: int = 8, n_ticks: int = 20,
        pipeline_ticks: bool = True) -> dict:
    """Real-time capacity through the shipped serving path:
    ``stream/serving.ShardedFleet`` (the object ``cli serve --sub-fleets``
    deploys) through its public ``push``, host queue, upload, device work
    and the PCM back included; median and p90 of ``n_ticks`` ticks after 3
    warm ones.  ``pipeline_ticks`` overlaps each shard's PCM copy with the
    next work.  Inputs rotate over a pool of 4 integer hop batches."""
    from se_snmf_nat_tpu_torch.stream.serving import ShardedFleet

    s = enh.cfg.signal
    tick_samples = block_frames * s.frameshift
    deadline_ms = tick_samples / s.fs * 1e3
    rng = np.random.default_rng(0)
    rows = []
    for n_shards, lanes in plans:
        total = n_shards * lanes
        peak = []
        with _row_memory(enh.device, f"a fleet of {n_shards} x {lanes} "
                                     f"lanes", peak):
            fleet = ShardedFleet(enh, total, sub_fleets=n_shards,
                                 block_frames=block_frames, wire="samples",
                                 pipeline_ticks=pipeline_ticks)
            pool = [_int_hops(rng, (total, tick_samples)) for _ in range(4)]
            for i in range(3):                          # warm
                fleet.push(pool[i % len(pool)])
            laps = []
            for i in range(n_ticks):
                t0 = time.perf_counter()
                fleet.push(pool[i % len(pool)])
                laps.append(time.perf_counter() - t0)
            del fleet
        tick_ms = float(np.median(laps) * 1e3)
        rows.append({
            "shards": int(n_shards), "lanes_per_shard": int(lanes),
            "total_streams": int(total),
            "tick_ms": tick_ms,
            "tick_p90_ms": float(np.percentile(laps, 90) * 1e3),
            "real_time": bool(tick_ms < deadline_ms),
            "peak_mib": peak[0]})
    ok = [r["total_streams"] for r in rows if r["real_time"]]
    return {"block_frames": block_frames,
            "deadline_ms": round(deadline_ms, 1),
            "pipeline_ticks": bool(pipeline_ticks),
            "max_real_time_streams_shipped_path": max(ok) if ok else 0,
            "timing": f"host clock around push, median and p90 of "
                      f"{n_ticks} ticks after 3 warm ticks",
            "note": "ShardedFleet.push end to end (host queue, upload, "
                    "device work, PCM copy back); the device_ceiling rows "
                    "time the same program's device half",
            "table": rows}
