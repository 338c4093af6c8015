"""One run of one cell: find the cell's configuration, traffic and metric
readers by name, build the program and warm it up, measure the window,
read the trace, compare the program's outputs with the plain reference,
and print the result.

Every piece belongs to a file of its own under ``benchmark/``, found by
the name that ``BENCHMARK.json`` or another piece gives it:
``configs/<config>.json`` (the configuration as it is run; its
``builder`` names the program's builder in ``programs/``, its
``reference`` the plain reference's module in ``reference/``, whose entry
point for each loop the loop names), ``traffic/<traffic>.json`` (the
generator's
parameters; its ``driver`` names the loop in ``drivers/``),
``metrics/<metric>.py`` (a per-layer metric's reader) and
``limits/<cell>.json`` (the comparison's limits).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "se_snmf_nat_tpu"}


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class Cell:
    """One cell's configuration, traffic, seed and device, the builder of
    the program under test and the plain reference's module."""

    def __init__(self, workload: str, seed: int, device, bench=None,
                 traffic: dict | None = None):
        bench = bench or spec()
        self.workload = next(w for w in bench["workloads"]
                             if w["name"] == workload)
        self.name = workload
        cfg_entry = next(c for c in bench["configs"]
                         if c["name"] == self.workload["config"])
        self.config = json.loads((ROOT / cfg_entry["file"]).read_text())
        self.traffic = traffic or json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.seed = int(seed)
        self.device = device
        self.params = self.config.get("algorithm", {})
        s = self.params.get("signal")
        if s:
            self.fs = int(s["fs"])
            self.shift = int(math.floor(s["hoptime"] * s["fs"] + 0.5))
            self.delay = 1 + int(math.floor(s["wintime"] / s["hoptime"] / 2
                                            + 0.5))
        self.bases = None
        b = self.config.get("bases")
        if b:
            from benchmark.traffic import inputs
            self.bases = inputs.structured_bases(
                b["f"], b["r_x"], b["r_d"], seed=self.seed % 2 ** 63)
        self.reference = importlib.import_module(
            f"benchmark.reference.{self.config['reference']}")

    def program(self):
        """The program under test, built by the configuration's builder."""
        return importlib.import_module(
            f"benchmark.programs.{self.config['builder']}").build(self)

    def driver(self):
        return importlib.import_module(
            f"benchmark.drivers.{self.traffic['driver']}").Driver(self)


# ------------------------------------------------------------------- trace

class Trace:
    """The kernels of a traced window on the host's clock: names, starts
    and ends (seconds, sorted by start), and their union."""

    def __init__(self, names, starts, ends):
        order = np.argsort(starts, kind="stable")
        self.names = [names[i] for i in order]
        self.starts = np.asarray(starts, float)[order]
        self.ends = np.asarray(ends, float)[order]
        from benchmark.yardstick import merge
        self.union = merge(self.starts, self.ends)


def read_trace(prof, markers) -> Trace:
    """The device kernels of a ``torch.profiler`` run (raw events, never
    parsed into function events), moved onto the host's clock by the
    ``cudaDeviceSynchronize`` calls made at the host times ``markers``
    ((before, after) pairs, seconds)."""
    from torch.autograd import DeviceType
    names, starts, ends, syncs = [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            name = ev.name()
            if name.startswith(("Memcpy", "Memset")):
                continue
            t = ev.start_ns()
            names.append(name)
            starts.append(t)
            ends.append(t + ev.duration_ns())
        elif ev.name() == "cudaDeviceSynchronize":
            syncs.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    if len(syncs) < 2:
        raise RuntimeError("the trace holds no synchronisation markers")
    syncs.sort()
    pairs = [(syncs[0], markers[0]), (syncs[-1], markers[-1])]
    offset = float(np.mean([(a + b) / 2e9 - (h0 + h1) / 2
                            for (a, b), (h0, h1) in pairs]))
    return Trace(names, np.asarray(starts) / 1e9 - offset,
                 np.asarray(ends) / 1e9 - offset)


class Run:
    """What a per-layer reader reads: the cell, the window (t0, t1), the
    harness's spans by name ((n, 2) host seconds), the trace, and the
    driver's counts."""

    def __init__(self, cell, driver, window: dict, spans, trace: Trace):
        self.cell, self.driver, self.counts = cell, driver, window
        self.t0, self.t1 = driver.t0, driver.t1
        self.trace = trace
        self.spans = {}
        for name, a, b in spans:
            self.spans.setdefault(name, []).append((a, b))
        self.spans = {k: np.asarray(v) for k, v in self.spans.items()}

    def span(self, name: str) -> np.ndarray:
        return self.spans.get(name, np.zeros((0, 2)))


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def breakdown(run: Run) -> dict:
    """The device operations that took the most time, and the longest idle
    gaps of the window, each named by the harness span open at its
    middle."""
    tr = run.trace
    by_name: dict[str, float] = {}
    for n, a, b in zip(tr.names, tr.starts, tr.ends):
        if a >= run.t0 and a < run.t1:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + float(b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    u = tr.union[(tr.union[:, 1] > run.t0) & (tr.union[:, 0] < run.t1)]
    edges = np.concatenate([[run.t0], np.clip(u.ravel(), run.t0, run.t1),
                            [run.t1]]).reshape(-1, 2)
    gaps = [(a, b) for a, b in edges if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(((a, b, n) for n, arr in run.spans.items()
                    for a, b in arr), key=lambda s: s[0])
    starts = np.asarray([s[0] for s in spans])

    def label(t):
        i = int(np.searchsorted(starts, t, side="right")) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return "harness"

    idle = [[label((a + b) / 2), float(b - a)] for a, b in gaps[:10]]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}


# --------------------------------------------------------------------- run

def control_numbers(drv, dev) -> dict[str, float]:
    """The comparison's numbers for the control: the reference put in the
    program's place one precision below the configuration's (float32 with
    TF32 products on the card, bfloat16 on the CPU)."""
    import torch
    if dev.type != "cuda":
        return drv.numbers(torch.bfloat16, dev)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return drv.numbers(torch.float32, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, bench=None, traffic=None, t_start=None,
             control: bool = False) -> tuple[dict, list[str]]:
    """One run; returns (the result object, the comparison's stderr
    lines).  ``device`` None is the card; the CPU tests pass "cpu".
    ``control`` adds the control's numbers (calibration only: a
    benchmark run never computes them)."""
    import torch
    from benchmark import compare
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or spec()
    on_card = device is None
    dev = torch.device("cuda", 0) if on_card else torch.device(device)
    t_cell = time.perf_counter()
    cell = Cell(workload, seed, dev, bench, traffic)
    drv = cell.driver()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    spans: list = []
    tr = None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile
        markers = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                h0 = time.perf_counter()
                torch.cuda.synchronize(dev)
                markers.append((h0, time.perf_counter()))
            window = drv.window(seconds, spans)
            h0 = time.perf_counter()
            torch.cuda.synchronize(dev)
            markers.append((h0, time.perf_counter()))
        tr = read_trace(prof, markers)
    else:
        window = drv.window(seconds, spans)
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "count": 1,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                    dev)) if on_card else 0)}
    metrics, result = {}, {}
    if trace:
        run = Run(cell, drv, window, spans, tr) if tr is not None else None
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            val = load_reader(m["name"])(run) if run is not None else None
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        if run is not None:
            from benchmark.yardstick import covered
            dev_info["busy_s"] = covered(tr.union, run.t0, run.t1)
            dev_info["window_s"] = run.t1 - run.t0
            result["breakdown"] = breakdown(run)
    else:
        measured = dict(window["end_to_end"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": float(measured[m["name"]]),
                                      "unit": m["unit"]}
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = drv.numbers(torch.float64, dev)
    lims = compare.limits(workload)
    ok, checks = compare.judge(nums, lims)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in
                      {"before the cell": t_cell - t_start,
                       **drv.setup_parts}.items())
    lines = [f"{window['note']}; setup {setup_s:.3f} s ({parts}); "
             f"reference {time.perf_counter() - t_ref:.3f} s"]
    other = {k: v for k, v in nums.items() if k not in lims}
    if other:
        lines.append("not compared: " + ", ".join(f"{k} {v!r}"
                                                   for k, v in other.items()))
    if control:
        result["control"] = control_numbers(drv, dev)
        lines.append(f"control {result['control']}")
    lines += [f"{k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{', '.join(leaked)}")
    result = {"correct": bool(ok), "attempted": int(window["attempted"]),
              "failed": int(window["failed"]), "metrics": metrics,
              "device": dev_info, **result, "checks": checks}
    return result, lines
