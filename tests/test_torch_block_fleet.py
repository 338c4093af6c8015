"""The block-adaptive serving fleet (``serve --block-adaptive``:
``MultiStreamSession(enh, n, block_frames=8, use_block_adaptive=True,
wire="frames")``) on the CPU: the block step's counters on its eager route
and on its graph route (``tests/test_torch_gain_scan.py``'s stand-in for
the CUDA graph, a re-run of the captured step), and the fleet in float64
against the benchmark's plain reference of the session blocks
(``benchmark/reference/snmf_nat_session.py``), int16 for int16, at the
configuration ``nat_block8``'s sizes.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.reference import snmf_nat_session  # noqa: E402
from benchmark.traffic import inputs  # noqa: E402
from se_snmf_nat_tpu_torch.config import default_config  # noqa: E402
from se_snmf_nat_tpu_torch.runtime import profiling  # noqa: E402
from se_snmf_nat_tpu_torch.stream import block_adaptive as ba  # noqa: E402
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer  # noqa: E402
from se_snmf_nat_tpu_torch.stream.serving import (  # noqa: E402
    MultiStreamSession)
from test_torch_gain_scan import _fake_cuda_graph, _flat  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "nat_block8.json")
                    .read_text())
K = CONFIG["session"]["block_frames"]
SHIFT = 160
LANES = 4
TICKS = 6


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _enhancer(dtype):
    """The configuration's program (its ``algorithm`` sections are the
    program's defaults) on the CPU in ``dtype``, and its dictionaries."""
    bases = inputs.structured_bases(seed=5)
    bx, bd = bases
    enh = SnmfEnhancer(default_config(), bx, bd, bx, bd, device="cpu",
                       dtype=dtype, **CONFIG["program"])
    return enh, bases


def _fleet(enh):
    return MultiStreamSession(enh, LANES, block_frames=K,
                              use_block_adaptive=True, wire="frames")


def _streams(n_samples):
    return inputs.noisy_utterances([n_samples] * LANES, 11, "cpu")


def _counts():
    return {k: profiling.RECORDER.host.get(k, 0)
            for k in ("block.steps", "block.steps_graphed")}


def test_the_configuration_is_the_programs_defaults():
    """``algorithm`` lays nothing over the program's default configuration:
    each value equals the default's."""
    cfg = default_config()
    for sec, values in CONFIG["algorithm"].items():
        have = getattr(cfg, sec)
        for k, v in values.items():
            want = getattr(have, k)
            assert (list(want) if isinstance(want, tuple) else want) == v, \
                (sec, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_counters_on_the_eager_route(dtype):
    """Off the card the block step runs eagerly: ``block.steps`` counts
    every block a tick runs, ``block.steps_graphed`` stays where it was."""
    enh, _ = _enhancer(dtype)
    fleet = _fleet(enh)
    assert not fleet._ba_step._use_graph
    x = _streams(3 * K * SHIFT)
    before = _counts()
    with torch.no_grad():
        for t in range(3):
            fleet.push(x[:, t * K * SHIFT: (t + 1) * K * SHIFT])
    after = _counts()
    assert after["block.steps"] - before["block.steps"] == 3
    assert after["block.steps_graphed"] == before["block.steps_graphed"]


def test_block_counters_on_the_graph_route(monkeypatch):
    """On the graph route the first block of a (lanes, K) runs eagerly and
    is captured; each later block is a replay: ``block.steps`` counts all
    of them, ``block.steps_graphed`` the replays, and the fleet gives the
    eager fleet's bits."""
    _fake_cuda_graph(monkeypatch)
    real_init = ba._BlockGraph.__init__

    def init(graph, step, state, ring_ptr, mag_blk):
        real_init(graph, step, state, ring_ptr, mag_blk)

        def replay():
            new = step.eager(*graph.inputs)
            for dst, src in zip(_flat(graph.outputs), _flat(new)):
                dst.copy_(src)
        graph.graph.fn = replay
    monkeypatch.setattr(ba._BlockGraph, "__init__", init)

    x = _streams(4 * K * SHIFT)
    outs = []
    for graphed in (False, True):
        enh, _ = _enhancer(torch.float32)
        fleet = _fleet(enh)
        fleet._ba_step._use_graph = graphed
        before = _counts()
        with torch.no_grad():
            outs.append(np.concatenate(
                [fleet.push(x[:, t * K * SHIFT: (t + 1) * K * SHIFT])
                 for t in range(4)], axis=1))
        after = _counts()
        assert after["block.steps"] - before["block.steps"] == 4
        assert (after["block.steps_graphed"]
                - before["block.steps_graphed"]) == (3 if graphed else 0)
        assert list(fleet._ba_step._graphs) == ([(LANES, K)] if graphed
                                                else [])
    assert np.array_equal(outs[0], outs[1])


def test_the_float64_fleet_gives_the_references_int16():
    """Four lanes of the block-adaptive fleet over six ticks from the
    streams' first sample, in float64 (the plain solvers), against the
    reference's session blocks from the same samples, bit for bit; the
    blocks cross ``init_n_len`` and refit."""
    enh, bases = _enhancer(torch.float64)
    fleet = _fleet(enh)
    n = TICKS * K * SHIFT
    x = _streams(n)
    with torch.no_grad():
        got = np.concatenate(
            [fleet.push(x[:, t * K * SHIFT: (t + 1) * K * SHIFT])
             for t in range(TICKS)], axis=1)
    want, refits = snmf_nat_session.live(x, TICKS * K, CONFIG, bases,
                                         block_frames=K)
    assert got.shape == want.shape == (LANES, (TICKS * K - 3) * SHIFT)
    assert refits > TICKS
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["other_block", "partial_block"])
def test_the_reference_refuses_another_block_length(case):
    """The reference runs the configuration's block only, and whole
    blocks of it."""
    x = _streams(TICKS * K * SHIFT)
    bases = inputs.structured_bases(seed=5)
    with pytest.raises(ValueError):
        if case == "other_block":
            snmf_nat_session.live(x, TICKS * K, CONFIG, bases,
                                  block_frames=2 * K)
        else:
            snmf_nat_session.live(x, TICKS * K - 4, CONFIG, bases)


def test_a_blocks_chain_frames_as_the_framer_does():
    """The frames wire frames a block on the device from its shift chain:
    the chain's windows after the first are the framer's frames; a queue
    zeroed in mid-block leaves no one chain."""
    from se_snmf_nat_tpu_torch.stream.hops import HopFramer
    cfg = default_config()
    s = cfg.signal
    framer = HopFramer(cfg, 3, K)
    x = np.random.default_rng(4).integers(-3000, 3000, (3, K * SHIFT + 70))
    block, = framer.push(x.astype(np.float64))
    ext = torch.from_numpy(block.chain)
    got = ext.unfold(1, s.framelength, s.frameshift)[:, 1:]
    assert np.array_equal(got.numpy(), block.frames)
    assert not list(framer.push(x[:, :3 * SHIFT].astype(np.float64)))
    framer.zero([1])                  # three hops into the next block
    block, = framer.push(x[:, :(K - 3) * SHIFT].astype(np.float64))
    assert block.chain is None and block.hops is None


@pytest.mark.parametrize("quantize,down", [(True, "float"),
                                           (False, "float"),
                                           (True, "pcm")])
@pytest.mark.parametrize("masks", ["none", "all", "late_start", "ragged"])
def test_assemble_gives_each_lane_its_own_hops(quantize, down, masks):
    """Lanes in lockstep are cut and quantised as one array, ragged lanes
    one at a time: either way each lane gets what quantising its own hops
    gives, value and dtype; hops that came down as int16 PCM are taken as
    they are."""
    from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
    rng = np.random.default_rng(9)
    n = 37                      # not a multiple of the 16-row blocks
    emit = {"none": np.zeros((n, K), bool), "all": np.ones((n, K), bool),
            "late_start": np.tile(np.arange(K) >= 3, (n, 1)),
            "ragged": rng.random((n, K)) < 0.5}[masks]
    emitted = [((rng.standard_normal((n, K, SHIFT)) * 9000)
                .astype(np.float32), emit) for _ in range(2)]
    if masks == "none":
        emitted = []
    if down == "pcm":
        emitted = [(enhanced_quantize(h), e) for h, e in emitted]
    got = MultiStreamSession._assemble(emitted, n, quantize)
    assert len(got) == n
    for i in range(n):
        lane = [h[i][e[i]].reshape(-1) for h, e in emitted]
        y = np.concatenate(lane) if lane else np.zeros((0,))
        want = (y.astype(np.int16) if down == "pcm" and lane
                else enhanced_quantize(y) if quantize
                else y.astype(np.float64))
        assert got[i].dtype == want.dtype
        assert np.array_equal(got[i], want)


def test_the_frames_wire_brings_down_the_pcm_the_host_would_quantise():
    """A frames-wire tick asked for PCM writes and requantises on the
    device; the fleet's int16 equals its float hops quantised on the
    host."""
    from se_snmf_nat_tpu_torch.io.wavio import enhanced_quantize
    enh, _ = _enhancer(torch.float32)
    x = _streams(3 * K * SHIFT)
    pcm, floats = _fleet(enh), _fleet(enh)
    for t in range(3):
        chunk = x[:, t * K * SHIFT:(t + 1) * K * SHIFT]
        got = pcm.push(chunk)
        want = floats.push(chunk, quantize=False)
        assert got.dtype == np.int16
        assert np.array_equal(got, enhanced_quantize(want))
