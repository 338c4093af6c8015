"""The ``exemplar1000`` configuration and its plain reference on the CPU:
the reference in float64 gives the program's fast plan int16 for int16 at a
small width, and the comparison rejects its bfloat16 control, a column
whose stop was altered and a changed output sample; the configuration file
is the program's ``exemplar`` preset in every field it sets; K3's counts
are the smoke script's; and the K3 readers on a synthetic run."""

from __future__ import annotations

import copy
import dataclasses
import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import compare  # noqa: E402
from benchmark.harness import load_reader  # noqa: E402
from benchmark.programs import snmf_enhancer  # noqa: E402
from benchmark.reference import snmf_fixed  # noqa: E402
from benchmark.tests.test_perfbench_program_trace import (  # noqa: E402
    _program, _run)
from benchmark.traffic import inputs  # noqa: E402
from benchmark.yardstick import PEAK_FLOPS  # noqa: E402
from benchmark.yardstick_k3 import k3_counts  # noqa: E402

CELL = "exemplar1000.batch64"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "exemplar1000.json")
                    .read_text())
LENS = (12000, 9000, 16000)
ALTERED = 40        # a frame of the first utterance's speech


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(r: int = 20):
    """The configuration at r_x = r_d = ``r``, in float64."""
    cfg = copy.deepcopy(CONFIG)
    cfg["precision"]["dtype"] = "float64"
    cfg["algorithm"]["sep"].update(r_x=r, r_d=r)
    return cfg, inputs.structured_bases(513, r, r, seed=3)


def _alter_one_stop(monkeypatch):
    """The program's H-solve with one column stopped after its first
    trip."""
    from se_snmf_nat_tpu_torch.stream import fast_pipeline
    orig = fast_pipeline.snmf_h_solve_columns

    def solve(v, w, h0, params):
        res = orig(v, w, h0, params)
        k = slice(ALTERED, ALTERED + 1)
        one = orig(v[:, k], w, h0[:, k],
                   dataclasses.replace(params, max_iter=1)).h
        h = res.h.clone()
        h[:, k] = one
        return res._replace(h=h)
    monkeypatch.setattr(fast_pipeline, "snmf_h_solve_columns", solve)


@pytest.mark.parametrize("case,correct", [
    ("program", True), ("bfloat16_control", False),
    ("column_stop_altered", False), ("sample_changed", False)])
def test_the_reference_against_the_fast_plan(monkeypatch, case, correct):
    cfg, bases = _small()
    xs = [x[:n] for x, n in zip(inputs.noisy_utterances(LENS, 3, "cpu"),
                                LENS)]
    want = snmf_fixed.offline(xs, cfg, bases)
    if case == "bfloat16_control":
        got = snmf_fixed.offline(xs, cfg, bases, dtype=torch.bfloat16)
    else:
        if case == "column_stop_altered":
            _alter_one_stop(monkeypatch)
        cell = SimpleNamespace(config=cfg, params=cfg["algorithm"],
                               bases=bases, device=torch.device("cpu"))
        enh = snmf_enhancer.build(cell)
        assert enh.fast_run is not None and enh.run is None
        got = enh.enhance_batch(xs, micro_batch=None)
        if case == "program":
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        if case == "sample_changed":
            got[1] = got[1].copy()
            got[1][4000] += 2048
    ok, checks = compare.judge(compare.lane_numbers(got, want),
                               compare.limits(CELL))
    assert ok == correct, checks


def test_the_configuration_is_the_exemplar_preset():
    from se_snmf_nat_tpu_torch.config import preset
    from se_snmf_nat_tpu_torch.stream.fast_pipeline import supports_fast_plan
    cfg = preset("exemplar")
    assert supports_fast_plan(cfg)
    n = 0
    for sec, values in CONFIG["algorithm"].items():
        have = getattr(cfg, sec)
        for key, value in values.items():
            got = getattr(have, key)
            assert (list(got) if isinstance(got, tuple) else got) == value, \
                (sec, key)
            n += 1
    assert n >= 40
    sep = CONFIG["algorithm"]["sep"]
    assert CONFIG["bases"] == {"kind": "structured", "f": 513,
                               "r_x": sep["r_x"], "r_d": sep["r_d"]}
    assert CONFIG["program"] == {"block_adapt": 0, "frame_bucket": 128,
                                 "dft_matmul": True}
    assert CONFIG["precision"] == {"dtype": "float32", "tf32": False}


def test_the_reference_loads_nothing_of_the_program():
    import subprocess
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark.reference import snmf_fixed
from benchmark.traffic import inputs
cfg = json.load(open({str(ROOT)!r} + "/benchmark/configs/exemplar1000.json"))
cfg["algorithm"]["sep"].update(r_x=8, r_d=8)
x = inputs.noisy_utterances([3200], 1, "cpu")
snmf_fixed.offline([x[0]], cfg, inputs.structured_bases(513, 8, 8, seed=1))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "se_snmf_nat_tpu",
                       "se_snmf_nat_tpu_torch"}


def _smoke_k3_count():
    """The operations and bytes of ``chip_smoke.py``'s K3 exemplar count,
    read from its source."""
    src = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r"bnd, by = bound\((4\.0 \* f \* r \* col_iters),\s*"
                  r"(4\.0 \* \(f \* n \+ f \* r \+ r \+ r \* n \+ n\))\)",
                  src)
    assert m, "chip_smoke.py no longer counts K3 as the yardstick copies"
    return m.group(1), m.group(2)


@pytest.mark.parametrize("f,r,n,trips", [(513, 1000, 24576, 688128),
                                         (513, 200, 2048, 51200),
                                         (513, 1000, 6144, 171_571)])
def test_k3_counts_are_the_smoke_scripts(f, r, n, trips):
    ops, n_bytes = _smoke_k3_count()
    names = {"f": f, "r": r, "n": n, "col_iters": trips}
    assert k3_counts(f, r, n, trips) == (eval(ops, {}, names),
                                         eval(n_bytes, {}, names))
    # a window of launches: the dictionary's bytes once a launch
    two = k3_counts(f, r, 2 * n, 2 * trips, launches=2)
    assert two == (2 * eval(ops, {}, names), 2 * eval(n_bytes, {}, names))


F, R = 513, 1000
COUNTERS = {"k3.columns": 2 * 4096, "k3.column_trips": 2 * 4096 * 40}


def _k3_run(took):
    cell = SimpleNamespace(config={"bases": {"f": F, "r_x": 500,
                                             "r_d": 500}},
                           params={}, traffic={})
    kernels = []
    for a in (1.0, 11.0):
        kernels.append(("void (anonymous namespace)::normalize_w_kernel()",
                        a, a + 0.001))
        kernels.append(("void (anonymous namespace)::h_cols_stream_kernel()",
                        a + 0.002, a + 0.002 + took))
        kernels.append(("void gemm_kernel()", a + 5.0, a + 6.0))
    kernels.append(("h_cols_stream_kernel", 30.0, 31.0))  # after the window
    run = _run("enhance_batch", [(0.0, 10.0), (10.0, 20.0)], kernels)
    run.cell = cell
    return run


def test_k3_readers_on_a_synthetic_window(monkeypatch):
    _program(monkeypatch, counters=COUNTERS)
    flops = 4.0 * F * R * COUNTERS["k3.column_trips"]
    bound = flops / PEAK_FLOPS                  # operations bind: 10 ms
    took = bound - 0.001           # with the normalisation, twice the bound
    run = _k3_run(took)
    assert load_reader("k3_roofline")(run) == pytest.approx(50.0)
    assert load_reader("k3_trips_mean")(run) == pytest.approx(40.0)
    busy = 2 * (0.001 + took + 1.0)
    want = 100.0 * 2 * (0.001 + took) / busy
    assert load_reader("k3_share")(run) == pytest.approx(want)
    # never above 100% when the kernels take exactly the bound
    run = _k3_run(bound / 2 - 0.001 + 1e-12)
    assert load_reader("k3_roofline")(run) <= 100.0 + 1e-9


@pytest.mark.parametrize("name", ["k3_roofline", "k3_trips_mean"])
def test_nothing_from_a_program_without_k3_counters(monkeypatch, name):
    _program(monkeypatch, counters={"batch.lanes": 64})
    assert load_reader(name)(_k3_run(0.1)) is None
    _program(monkeypatch, counters=None)
    assert load_reader(name)(_k3_run(0.1)) is None


SMALL = {"driver": "batch", "lanes": 2, "pool": 4,
         "lengths": {"samples": 8000}, "warmup_calls": 1, "check_calls": 1}


def test_a_small_run_of_the_cell_at_its_widths():
    from benchmark.harness import run_cell, spec
    result, lines = run_cell(CELL, 2 ** 31 + 777, 0.3, False, device="cpu",
                             traffic=SMALL, control=True)
    assert result["correct"], lines
    assert set(result["metrics"]) == {m["name"] for m in spec()["end_to_end"]
                                      if CELL in m.get("workloads", [CELL])}
    assert result["attempted"] > 0 and result["failed"] == 0
    ok, _ = compare.judge(result["control"], compare.limits(CELL))
    assert not ok, lines
