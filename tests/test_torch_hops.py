"""The push sessions' shared host half, ``stream.hops``: the framer's
blocks against ``dsp.stft.stream_frames`` (the port's and the JAX
package's) for any chunking of the pushes, the flush frames, a queue zeroed
in mid-block or between blocks, the per-lane clocks, and
``overlap_add_hops`` against ``dsp.stft.overlap_add``."""

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu.dsp.stft import stream_frames as j_stream_frames
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.dsp.stft import overlap_add, stream_frames
from se_snmf_nat_tpu_torch.stream.hops import HopFramer, overlap_add_hops

CFG = default_config()
L, SHIFT, DELAY = (CFG.signal.framelength, CFG.signal.frameshift, CFG.delay)


def _signal(n_lanes, n, seed):
    rng = np.random.default_rng(seed)
    return np.rint(rng.standard_normal((n_lanes, n)) * 3000.0)


def _chunked(x, seed):
    """``x`` (N, n) cut into random pushes, some shorter than a hop."""
    rng = np.random.default_rng(seed)
    i = 0
    while i < x.shape[1]:
        m = int(rng.integers(1, 3 * SHIFT))
        yield x[:, i: i + m]
        i += m


def _stream(framer, x, seed):
    blocks = [b for part in _chunked(x, seed) for b in framer.push(part)]
    return blocks + list(framer.flush())


def _naive(x, zeros_at):
    """The sessions' former per-hop loop: the queue shifted one hop at a
    time, its rows in ``zeros_at[t]`` zeroed before hop t; (N, T, L)."""
    queue = np.zeros((x.shape[0], L))
    frames = []
    for t in range(x.shape[1] // SHIFT):
        queue[list(zeros_at.get(t, ()))] = 0.0
        queue = np.concatenate([queue[:, SHIFT:],
                                x[:, t * SHIFT: (t + 1) * SHIFT]], axis=1)
        frames.append(queue.copy())
    return np.stack(frames, axis=1)


@pytest.mark.parametrize("block_frames", [1, 8])
@pytest.mark.parametrize("n_lanes", [1, 3, 6], ids=["one", "lanes", "ch6"])
def test_frames_equal_stream_frames_in_any_chunking(n_lanes, block_frames):
    x = _signal(n_lanes, 37 * SHIFT + 71, seed=n_lanes)
    framer = HopFramer(CFG, n_lanes, block_frames)
    blocks = _stream(framer, x, seed=block_frames)
    frames = np.concatenate([b.frames for b in blocks], axis=1)
    t = frames.shape[1]
    assert [b.k for b in blocks[:-1]] == [block_frames] * (len(blocks) - 1)
    np.testing.assert_array_equal(
        np.concatenate([b.l0 for b in blocks]),
        np.repeat(np.arange(1, t + 1, block_frames), n_lanes))
    for lane in range(n_lanes):
        want = stream_frames(x[lane], L, SHIFT, n_flush=DELAY + 1)
        np.testing.assert_array_equal(frames[lane], want)
        np.testing.assert_array_equal(
            frames[lane], j_stream_frames(x[lane], L, SHIFT, DELAY + 1))


@pytest.mark.parametrize("block_frames", [1, 8])
def test_flush_frames_are_whole_zero_frames(block_frames):
    x = _signal(2, 12 * SHIFT + 5, seed=9)
    framer = HopFramer(CFG, 2, block_frames)
    for _ in framer.push(x):
        pass
    assert framer.hold.shape == (2, 5) and framer.queue.any()
    blocks = list(framer.flush())
    frames = np.concatenate([b.frames for b in blocks], axis=1)
    assert frames.shape == (2, 12 % block_frames + DELAY + 1, L)
    np.testing.assert_array_equal(frames[:, -(DELAY + 1):], 0.0)
    assert framer.hold.shape == (2, 0) and not framer.pending
    # a flush frame starts a chain of its own: no hops form in mid-block
    assert all(b.hops is None for b in blocks if b.k > 1)


@pytest.mark.parametrize("at", [3, 0], ids=["mid_block", "between"])
def test_a_zeroed_queue_and_the_hops_form(at):
    """A queue zeroed in mid-block leaves the frames form only; zeroed
    between blocks, the block keeps its hops form from the zeroed queue,
    and ``continues`` says the queue changed."""
    x = _signal(3, 16 * SHIFT, seed=4)
    framer = HopFramer(CFG, 3, 8)
    first = list(framer.push(x[:, : (8 + at) * SHIFT]))
    framer.zero([1])
    second = list(framer.push(x[:, (8 + at) * SHIFT:]))
    (b0,), (b1,) = first, second
    want = _naive(x, {8 + at: [1]})
    np.testing.assert_array_equal(b0.frames, want[:, :8])
    np.testing.assert_array_equal(b1.frames, want[:, 8:])
    assert b0.continues
    np.testing.assert_array_equal(b1.l0, [9, 9, 9])
    if at:
        assert b1.hops is None and b1.continues
        return
    assert not b1.continues
    np.testing.assert_array_equal(
        b1.hops, x[:, 8 * SHIFT:].reshape(3, 8, SHIFT))
    np.testing.assert_array_equal(b1.queue0, want[:, 7] * [[1], [0], [1]])
    # the device rebuilds the frames from queue0 and the hops
    ext = np.concatenate([b1.queue0, x[:, 8 * SHIFT:]], axis=1)
    rebuilt = np.stack([ext[:, (i + 1) * SHIFT: (i + 1) * SHIFT + L]
                        for i in range(8)], axis=1)
    np.testing.assert_array_equal(rebuilt, b1.frames)


@pytest.mark.parametrize("block_frames", [1, 4])
def test_clocks_are_per_lane_after_a_reset(block_frames):
    x = _signal(3, 12 * SHIFT, seed=5)
    framer = HopFramer(CFG, 3, block_frames)
    for _ in framer.push(x[:, : 8 * SHIFT]):
        pass
    framer.reset_lanes([1])
    np.testing.assert_array_equal(framer.l, [8, 0, 8])
    np.testing.assert_array_equal(framer.queue[1], 0.0)
    blocks = list(framer.push(x[:, 8 * SHIFT:]))
    np.testing.assert_array_equal(blocks[0].l0, [9, 1, 9])
    emit = np.concatenate([b.emit for b in blocks], axis=1)
    np.testing.assert_array_equal(emit[[0, 2]], True)
    np.testing.assert_array_equal(emit[1], np.arange(1, 5) > DELAY)
    np.testing.assert_array_equal(framer.l, [12, 4, 12])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_overlap_add_hops_equals_overlap_add(kind, dtype):
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((3, 29, L)).astype(dtype)
    want = overlap_add(torch.from_numpy(frames), SHIFT).numpy()
    if kind == "torch":
        frames = torch.from_numpy(frames)
    recent = (torch.zeros((3, L // SHIFT - 1, L), dtype=frames.dtype)
              if kind == "torch"
              else np.zeros((3, L // SHIFT - 1, L), dtype))
    hops, t0 = [], 0
    for k in (1, 5, 8, 2, 13):
        h, recent = overlap_add_hops(recent, frames[:, t0: t0 + k], SHIFT)
        assert h.dtype == frames.dtype
        hops.append(np.asarray(h))
        t0 += k
    got = np.concatenate(hops, axis=1).reshape(3, -1)
    np.testing.assert_array_equal(got, want[:, : 29 * SHIFT])
    np.testing.assert_array_equal(np.asarray(recent), np.asarray(
        frames[:, -(L // SHIFT - 1):]))
