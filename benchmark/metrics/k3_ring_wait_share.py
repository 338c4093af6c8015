"""The share of the W chunks that K3's streaming path took from its
shared-memory rings which had not landed when warp 0 first looked:
100 x ``k3.ring_waits`` / ``k3.ring_chunks``, the program's counters (%).
Low: the FMA pipes bind; high: L2 does.  Nothing for a program without the
counters, or with no streaming launch in the window."""

from benchmark.program_trace import program_counters


def read(run):
    c = program_counters()
    if not c or c.get("k3.ring_chunks", 0) <= 0:
        return None
    return 100.0 * c.get("k3.ring_waits", 0) / c["k3.ring_chunks"]
