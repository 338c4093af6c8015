"""The ``pmwf6`` configuration, its cell and its plain reference on the
CPU: a small run of the cell is correct; its bfloat16 control is not; the
planted faults are not (a lane zeroed, one block's filters replaced by the
identity, the neighbourhood cut to the centre bin, Ncov taken from the
frames after the init period); the reference in float64 gives the
program's float64 output (int16 for int16); the reference imports nothing
of the program or of JAX; the configuration is the program's defaults;
the yardstick's count is held to a count made term by term; and the two
readers on a synthetic run."""

from __future__ import annotations

import json
import math
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
from benchmark.harness import Run, Trace, load_reader, run_cell  # noqa: E402
from benchmark.reference import pmwf as ref  # noqa: E402
from benchmark.traffic import inputs_mc  # noqa: E402
from benchmark.yardstick import bound_s  # noqa: E402
from benchmark.yardstick_pmwf import pmwf_counts  # noqa: E402

CELL = "pmwf6.batch64"
SEED = 2 ** 31 + 12345          # more than 32 signed bits hold
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "pmwf6.json")
                    .read_text())
SMALL = {"driver": "batch_multichannel", "lanes": 3, "pool": 6,
         "lengths": {"samples": 9600}, "channels": 6, "warmup_calls": 1,
         "check_calls": 2}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(control=False):
    return run_cell(CELL, SEED, 0.3, False, device="cpu", traffic=SMALL,
                    control=control)


def test_a_small_run_is_correct_and_reports_the_rate():
    result, lines = _run()
    assert result["correct"], lines
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


def test_the_bfloat16_control_is_not_correct():
    result, lines = _run(control=True)
    ok, _ = compare.judge(result["control"], compare.limits(CELL))
    assert result["correct"] and not ok, lines


def _fault(monkeypatch, fault):
    from se_snmf_nat_tpu_torch.multichannel import pmwf
    if fault == "lane_zeroed":
        cls = pmwf.PmwfEnhancer
        orig = cls.enhance_batch

        def patched(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            return [np.zeros_like(out[0])] + out[1:]
        monkeypatch.setattr(cls, "enhance_batch", patched)
    elif fault == "block_identity":
        orig = pmwf.lane_filters

        def filters(covs, t_true, p):
            h = orig(covs, t_true, p)
            h[:, 1] = torch.eye(h.shape[-1], dtype=h.dtype)
            return h
        monkeypatch.setattr(pmwf, "lane_filters", filters)
    elif fault == "centre_bin_only":
        orig = pmwf.collapse_index
        monkeypatch.setattr(pmwf, "collapse_index",
                            lambda f, m, d: orig(f, m, d)[m: m + 1])
    else:
        orig = pmwf.lane_ncov
        monkeypatch.setattr(pmwf, "lane_ncov", lambda covs, tt, p: orig(
            covs[:, p.init_n_len:], tt - p.init_n_len, p))


@pytest.mark.parametrize("fault", ["lane_zeroed", "block_identity",
                                   "centre_bin_only", "ncov_wrong_frames"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    _fault(monkeypatch, fault)
    result, lines = _run()
    assert not result["correct"], lines


def _lanes(lens=(9600, 4000, 2400, 1600), seed=5):
    pool = inputs_mc.tablet_mixtures(lens, seed, "cpu")
    return [x[:, :n] for x, n in zip(pool, lens)]


def _program(dtype):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["precision"]["dtype"] = dtype
    from benchmark.programs import pmwf_enhancer
    return pmwf_enhancer.build(SimpleNamespace(
        config=cfg, params=cfg["algorithm"], device=torch.device("cpu")))


@pytest.mark.parametrize("ref_ch", [None, 4])
def test_the_reference_is_the_program_in_float64(ref_ch):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["algorithm"]["pmwf"]["ref_ch"] = ref_ch
    enh = _program("float64")
    from se_snmf_nat_tpu_torch.multichannel.pmwf import PmwfParams
    enh.params = PmwfParams(**cfg["algorithm"]["pmwf"])
    xs = _lanes()
    got = enh.enhance_batch(xs, quantize=False)
    plan = ref.Plan(cfg["algorithm"])
    for x, g in zip(xs, got):
        want = ref.enhance_lane(x, plan, torch.float64, "cpu").numpy()
        assert g.shape == want.shape
        assert np.abs(g - want).max() <= 1e-9 * np.abs(want).max()
    for g, w in zip(enh.enhance_batch(xs), ref.offline(xs, cfg)):
        np.testing.assert_array_equal(g, w)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    src = (ROOT / "benchmark" / "reference" / "pmwf.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+(\S+)", src, re.M)
    assert imports and not [m for m in imports if m.split(".")[0] in (
        "se_snmf_nat_tpu_torch", "se_snmf_nat_tpu", "jax", "jaxlib",
        "benchmark")]


def test_the_configuration_is_the_programs_default():
    from se_snmf_nat_tpu_torch.config import default_config
    from se_snmf_nat_tpu_torch.multichannel.pmwf import PmwfParams
    assert PmwfParams(**CONFIG["algorithm"]["pmwf"]) == PmwfParams()
    sig = default_config().signal
    for key, value in CONFIG["algorithm"]["signal"].items():
        assert key == "ch" or getattr(sig, key) == value, key
    assert CONFIG["algorithm"]["signal"]["ch"] == CONFIG["channels"] == 6
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "pmwf6")
    assert entry["reduced"] == [] and entry["source"] == CONFIG["source"]


def _count_by_terms(t, f, c, m, l, init, period, cbytes=8):
    """The yardstick's count, made one term at a time."""
    ops = n_bytes = 0.0
    for _ in range(t):
        for _ in range(f):
            ops += (2 * m + 1) * c * c * 8      # the shifts' outer products
            ops += c * c * 4                    # running sum and difference
            ops += c * c * 2                    # into the block's sum
            ops += c * c * 8                    # the filtering
    ops += min(t, init) * f * c * c * 2         # Ncov
    nb = -(-t // period)
    chol = sum((c - j) * j for j in range(c))   # complex products added
    subst = 2 * sum((c - k - 1) * c for k in range(c))
    ops += nb * f * (8 * (chol + subst) + 16 * c * c)
    spectra = c * f * t * cbytes
    n_bytes += 3 * spectra                      # read twice, written once
    n_bytes += 2 * (nb + 1) * f * c * c * cbytes    # block sums and Ncov
    n_bytes += 2 * nb * f * c * c * cbytes          # the filters
    return ops, n_bytes


@pytest.mark.parametrize("t,c", [(347, 6), (14, 6), (31, 2), (60, 4)])
def test_the_yardstick_is_held_to_a_count_by_terms(t, c):
    got = pmwf_counts([t, t], 9, c, 2, 2, 15, 15)
    want = _count_by_terms(t, 9, c, 2, 2, 15, 15)
    assert got == pytest.approx((2 * want[0], 2 * want[1]), rel=1e-12)


def _synthetic(calls, kernels):
    cell = SimpleNamespace(config=CONFIG, params=CONFIG["algorithm"],
                           shift=160)
    frames = np.full(64, 347)
    driver = SimpleNamespace(span="enhance_batch", lanes=64, t0=0.0,
                             t1=10.0,
                             window_lane_frames=lambda n: np.tile(frames, n))
    trace = Trace([n for n, _, _ in kernels],
                  np.asarray([a for _, a, _ in kernels], float),
                  np.asarray([b for _, _, b in kernels], float))
    return Run(cell, driver, {}, [("enhance_batch", a, b) for a, b in calls],
               trace)


def test_the_readers_on_a_synthetic_run():
    calls = [(0.0, 5.0), (5.0, 10.0)]
    kernels = [("k", 1.0, 1.5), ("k", 1.2, 2.0), ("k", 6.0, 6.5),
               ("k", 11.0, 12.0)]
    run = _synthetic(calls, kernels)
    flops, n_bytes = pmwf_counts(np.full(128, 347), 513, 6, 2, 2, 15, 15)
    want = 100.0 * bound_s(flops, n_bytes) / 1.5
    assert load_reader("pmwf_roofline")(run) == pytest.approx(want)
    assert 0 < want < 100
    assert load_reader("pmwf_kernels")(run) == 1.5
    run.trace = None
    assert load_reader("pmwf_roofline")(run) is None
    assert load_reader("pmwf_kernels")(run) is None
    assert math.isfinite(flops) and n_bytes > 0
