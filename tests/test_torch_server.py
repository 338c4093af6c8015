"""``EnhanceServer`` of the port over loopback, on the CPU in float64 at
narrow widths (r_x = r_d = 8, r_a = 4, m_a = 10, 6 trips): a network
client's enhanced stream is identical, int16 for int16, to a solo
``StreamingSession`` fed the same samples and to a fleet run of them,
concurrently with other tenants and for a tenant that takes over a freed
lane.  Every await is under ``asyncio.wait_for``: a hang is a failure."""

import asyncio
import socket
import struct
from dataclasses import replace

import numpy as np
import pytest
import torch

from se_snmf_nat_tpu_torch import fixtures
from se_snmf_nat_tpu_torch.config import default_config
from se_snmf_nat_tpu_torch.runtime.server import (
    EnhanceServer, enhance_over_socket)
from se_snmf_nat_tpu_torch.stream.pipeline import SnmfEnhancer
from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
from se_snmf_nat_tpu_torch.stream.streaming import StreamingSession

torch.set_num_threads(1)
HOST = "127.0.0.1"
TIMEOUT = 120


@pytest.fixture(scope="module")
def enh():
    cfg = default_config()
    cfg = cfg.evolve(sep=replace(cfg.sep, r_x=8, r_d=8),
                     adapt=replace(cfg.adapt, r_a=4, m_a=10),
                     nmf=replace(cfg.nmf, max_iter=6))
    bx, bd = fixtures.synthetic_bases(cfg.signal.n_bins, 8, 8, seed=0)
    return SnmfEnhancer(cfg, bx, bd, bx, bd, device="cpu",
                        dtype=torch.float64, matlab_ad_blk_init=False)


def _signals(n, length, seed=7):
    return [fixtures.noisy_utterance(length, seed=seed + i) for i in range(n)]


def _solo(enh, x):
    sess = StreamingSession(enh)
    return np.concatenate([sess.push(x), sess.flush()])


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=TIMEOUT))


def _client(srv, x, **kw):
    return asyncio.wait_for(enhance_over_socket(HOST, srv.port, x, **kw),
                            timeout=TIMEOUT)


async def _until(cond, what):
    for _ in range(2000):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


async def _all_free(srv):
    await _until(lambda: all(ln.state == "free" for ln in srv.lanes),
                 "every lane to free")


@pytest.mark.parametrize("kw", [
    dict(n_lanes=2, block_frames=1),
    dict(n_lanes=2, block_frames=8),
    dict(n_lanes=2, block_frames=8, wire="frames"),
    dict(n_lanes=4, block_frames=4, sub_fleets=2),
], ids=["hop_ticks", "block_mode", "frames_wire", "sub_fleets_2"])
def test_one_client_gets_the_offline_stream(enh, kw):
    """A client alone: ``(hops + 1) * 160`` samples, those of a solo session
    and of a fleet run of the same samples, whatever the tick's size, the
    wire and the sharding."""
    x = _signals(1, 4800 + 37)[0]             # a partial hop at the end
    want = _solo(enh, x)
    fleet = MultiStreamSession(enh, 1, block_frames=kw["block_frames"])
    np.testing.assert_array_equal(
        np.concatenate([fleet.push(x[None]), fleet.flush()], axis=1)[0], want)

    async def go():
        srv = await EnhanceServer(enh, **kw).start()
        try:
            return await _client(srv, x)
        finally:
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    got = _run(go())
    assert got.dtype == np.int16
    assert got.shape == ((len(x) // 160 + 1) * 160,)
    np.testing.assert_array_equal(got, want)


def test_concurrent_clients_are_independent(enh):
    xs = _signals(3, 4800)
    wants = [_solo(enh, x) for x in xs]

    async def go():
        srv = await EnhanceServer(enh, n_lanes=4, block_frames=1).start()
        try:
            return await asyncio.gather(*[
                _client(srv, x, chunk=501) for x in xs])
        finally:
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    for got, want in zip(_run(go()), wants):
        np.testing.assert_array_equal(got, want)


def test_sequential_tenants_get_fresh_lanes(enh):
    """A second tenant on the first one's lane equals a fresh session:
    state, clock and overlap-add history were all reset."""
    xa, xb = _signals(2, 3200, seed=11)
    want_b = _solo(enh, xb)

    async def go():
        srv = await EnhanceServer(enh, n_lanes=1, block_frames=4).start()
        try:
            await _client(srv, xa)
            await _all_free(srv)          # the lane frees after the EOF
            return await _client(srv, xb)
        finally:
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    np.testing.assert_array_equal(_run(go()), want_b)


def test_busy_refusal(enh):
    async def go():
        srv = await EnhanceServer(enh, n_lanes=1, block_frames=1).start()
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(HOST, srv.port), timeout=TIMEOUT)
            await asyncio.wait_for(reader.readline(), timeout=TIMEOUT)
            with pytest.raises(RuntimeError, match="busy"):
                await _client(srv, _signals(1, 800)[0])
            writer.close()
        finally:
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    _run(go())


def test_abrupt_client_death_frees_the_fleet(enh):
    """A client that resets its connection in mid-stream does not wedge the
    lockstep fleet: its lane drains and frees, while a well-behaved client
    beside it gets its whole stream."""
    xa, xb = _signals(2, 4800, seed=17)
    want_b = _solo(enh, xb)

    async def go():
        srv = await EnhanceServer(enh, n_lanes=2, block_frames=1).start()
        try:
            async def rst_client():
                reader, writer = await asyncio.open_connection(HOST,
                                                               srv.port)
                await reader.readline()
                writer.write(np.asarray(xa[:800]).astype("<i2").tobytes())
                await writer.drain()
                await asyncio.sleep(0.05)
                writer.get_extra_info("socket").setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))              # RST on close
                writer.close()

            good = asyncio.create_task(_client(srv, xb, chunk=640))
            await asyncio.wait_for(rst_client(), timeout=TIMEOUT)
            out_b = await good
            await _all_free(srv)
            return out_b
        finally:
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    np.testing.assert_array_equal(_run(go()), want_b)


async def _small_buffers_client(srv):
    """A connection whose receive buffer, and the server's send buffer for
    it, are as small as the host allows, so that unread output backs up into
    the server's transport."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1)
    sock.setblocking(False)
    await asyncio.get_running_loop().sock_connect(sock, (HOST, srv.port))
    reader, writer = await asyncio.open_connection(sock=sock)
    await reader.readline()
    me = writer.get_extra_info("sockname")
    for ln in srv.lanes:
        if ln.writer is None:
            continue
        s = ln.writer.get_extra_info("socket")
        if s is not None and s.getpeername() == me:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1)
            ln.writer.transport.set_write_buffer_limits(0, 0)
    return reader, writer


def test_slow_reader_is_cut_off_without_stalling_the_fleet(enh):
    """A client that keeps sending and never reads is cut off once its
    unread output passes ``max_write_buffer``; the tick never waits for it,
    and the client beside it gets its whole stream."""
    x_good = _signals(1, 6400, seed=23)[0]
    want = _solo(enh, x_good)
    rng = np.random.default_rng(29)

    async def go():
        srv = await EnhanceServer(enh, n_lanes=2, block_frames=1,
                                  max_write_buffer=64).start()
        try:
            cut = asyncio.Event()

            async def slow_client():
                _, writer = await _small_buffers_client(srv)
                try:
                    while True:                # feed for ever, never read
                        hop = np.round(rng.standard_normal(160) * 1000.0)
                        writer.write(hop.astype("<i2").tobytes())
                        await writer.drain()
                        await asyncio.sleep(0)
                except (ConnectionResetError, BrokenPipeError, OSError):
                    cut.set()                  # the server cut us off

            slow_task = asyncio.create_task(slow_client())
            out = await _client(srv, x_good, chunk=640)
            await asyncio.wait_for(cut.wait(), timeout=60)
            slow_task.cancel()
            return out
        finally:
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    np.testing.assert_array_equal(_run(go()), want)


async def _send_all_and_read_nothing(srv, x):
    """A bare socket (nothing reads on its behalf) that sends the whole of x,
    closes its write side and waits, without reading, until the server has
    freed its lane.  Returns the socket."""
    loop = asyncio.get_running_loop()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1)
        sock.setblocking(False)
        await asyncio.wait_for(loop.sock_connect(sock, (HOST, srv.port)),
                               timeout=TIMEOUT)
        header = b""
        while not header.endswith(b"\n"):
            header += await asyncio.wait_for(loop.sock_recv(sock, 1),
                                             timeout=TIMEOUT)
        await _until(lambda: srv.lanes[0].writer is not None, "the lane")
        srv.lanes[0].writer.get_extra_info("socket").setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDBUF, 1)
        await asyncio.wait_for(
            loop.sock_sendall(sock, np.asarray(x).astype("<i2").tobytes()),
            timeout=TIMEOUT)
        sock.shutdown(socket.SHUT_WR)
        await _all_free(srv)
    except BaseException:
        sock.close()
        raise
    return sock


async def _read_to_the_end(sock):
    """What is left to read on the socket, up to EOF or a reset."""
    loop = asyncio.get_running_loop()
    out = bytearray()
    try:
        while True:
            data = await asyncio.wait_for(loop.sock_recv(sock, 65536),
                                          timeout=TIMEOUT)
            if not data:
                break
            out.extend(data)
    except ConnectionError:
        pass
    return np.frombuffer(bytes(out[: len(out) // 2 * 2]), np.int16)


def test_late_reader_of_a_drained_lane_gets_its_tail(enh):
    """A client that sends its whole stream and reads only after the server
    has freed its lane still gets every sample: a transport that is closing
    with bytes unflushed is left to flush, not aborted, and ``stop`` returns
    afterwards.  The client is a bare socket, so nothing reads on its behalf
    while it waits."""
    x = _signals(1, 32000, seed=31)[0]
    want = _solo(enh, x)

    faults = []                  # what the loop's exception handler hears

    async def go():
        asyncio.get_running_loop().set_exception_handler(
            lambda loop, context: faults.append(context))
        srv = await EnhanceServer(enh, n_lanes=1, block_frames=8).start()
        sock = None
        try:
            sock = await _send_all_and_read_nothing(srv, x)
            backlog = sum(t.get_write_buffer_size() for t in srv._flushing)
            got = await _read_to_the_end(sock)
            # the lane serves its next tenant
            again = await _client(srv, x[:1600])
            # the flushed transport, closed by itself, is still on record
            # when stop() goes through the flushing ones
            return got, backlog, len(srv._flushing), again
        finally:
            if sock is not None:
                sock.close()
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)
            await asyncio.sleep(0.05)

    got, backlog, on_record, again = _run(go())
    assert backlog > 0           # the case was met: bytes were still unsent
    assert on_record == 1 and not faults
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, _solo(enh, x[:1600]))


def test_a_drained_lane_that_is_never_read_is_aborted_at_its_deadline(enh):
    """A flushing transport has a deadline: a client that is alive and never
    reads loses its socket and its buffered tail ``_flushing_deadline_s``
    after its lane was freed, with no tick or other event to wake the
    server, and the lane's next tenant is served meanwhile."""
    x = _signals(1, 32000, seed=37)[0]
    want = _solo(enh, x)

    async def go():
        srv = await EnhanceServer(enh, n_lanes=1, block_frames=8).start()
        srv._flushing_deadline_s = 0.5
        sock = None
        try:
            sock = await _send_all_and_read_nothing(srv, x)
            parked = list(srv._flushing)
            backlog = sum(t.get_write_buffer_size() for t in parked)
            again = await _client(srv, x[:1600])
            await _all_free(srv)
            # nothing wakes the tick loop from here on
            await _until(lambda: not srv._flushing, "the deadline")
            left = sum(t.get_write_buffer_size() for t in parked)
            got = await _read_to_the_end(sock)
            return got, len(parked), backlog, left, again
        finally:
            if sock is not None:
                sock.close()
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    got, n_parked, backlog, left, again = _run(go())
    assert n_parked == 1 and backlog > 0
    assert left == 0                       # the buffer went with the abort
    assert len(got) < len(want)            # and so did the stream's tail
    np.testing.assert_array_equal(got, want[: len(got)])
    np.testing.assert_array_equal(again, _solo(enh, x[:1600]))


def test_block_adaptive_server_takes_the_frames_wire(enh):
    """``use_block_adaptive`` serves through the frames wire (the default
    wire follows the mode): a client gets the stream of a solo block-adaptive
    session."""
    x = _signals(1, 4480, seed=41)[0]       # 28 hops + 4 flush frames: 4 blocks
    sess = StreamingSession(enh, block_frames=8, use_block_adaptive=True)
    want = np.concatenate([sess.push(x), sess.flush()])

    async def go():
        srv = await EnhanceServer(enh, n_lanes=2, block_frames=8,
                                  use_block_adaptive=True).start()
        assert not srv.session._samples
        try:
            return await _client(srv, x)
        finally:
            await asyncio.wait_for(srv.stop(), timeout=TIMEOUT)

    np.testing.assert_array_equal(_run(go()), want)
