"""The benchmark is driven by data: every configuration, traffic mix,
per-layer metric and cell named in BENCHMARK.json has its file; and
nothing the harness or the reference loads is JAX or the JAX package,
while the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_named_piece_has_its_file():
    """Each name resolves to a file of its own: a new configuration,
    traffic mix, metric or cell is new files and entries only."""
    bench_dir = ROOT / "benchmark"
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (bench_dir / "programs" / f"{cfg['builder']}.py").exists()
        assert (bench_dir / "reference" / f"{cfg['reference']}.py").exists()
    for w in BENCH["workloads"]:
        traffic = json.loads((bench_dir / "traffic"
                              / f"{w['traffic']}.json").read_text())
        driver = bench_dir / "drivers" / f"{traffic['driver']}.py"
        assert "class Driver" in driver.read_text()
        lims = json.loads((bench_dir / "limits"
                           / f"{w['name']}.json").read_text())
        assert lims["limits"] and set(lims["limits"]) <= {
            "err_median", "err_q75", "err_max", "hop_median"}
    for m in BENCH["per_layer"]:
        assert (bench_dir / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def _modules_after(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark.harness import forbidden_modules, load_reader, run_cell, spec
from benchmark.tests.small import SMALL
import benchmark.calibrate, benchmark.traffic.knee_sweep
for m in spec()["per_layer"]:
    load_reader(m["name"])
for cell in ("nat_frame.mic", "nat_block88.batch64"):
    run_cell(cell, 3, 0.2, False, device="cpu", traffic=SMALL[cell])
print(json.dumps(forbidden_modules()))
"""
    assert _modules_after(code) == []


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys
sys.path.insert(0, ROOT)
import numpy as np, torch
torch.set_num_threads(2)
from benchmark.reference import snmf_nat
from benchmark.traffic import inputs
frame = json.load(open(ROOT + "/benchmark/configs/nat_frame.json"))
block = json.load(open(ROOT + "/benchmark/configs/nat_block88.json"))
bases = inputs.structured_bases(seed=1)
x = inputs.noisy_utterances([3200], 1, "cpu").astype(float)
snmf_nat.live(x, 8, frame, bases)
snmf_nat.offline([x[0]], frame, bases)
block["program"]["block_adapt"] = 8
snmf_nat.offline([x[0]], block, bases)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""".replace("ROOT", repr(str(ROOT)))
    tops = set(_modules_after(code))
    assert not tops & {"jax", "jaxlib", "flax", "se_snmf_nat_tpu",
                       "se_snmf_nat_tpu_torch"}
