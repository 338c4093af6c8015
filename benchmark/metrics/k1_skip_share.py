"""The share of the lanes offered to K1's wide path with a per-lane flag
that it did not solve, their block lying wholly past the lane's end:
100 x ``k1.lanes_skipped`` / ``k1.lanes``, the program's counters (%).
Nothing for a program without the counters, or with no such launch in the
window."""

from benchmark.program_trace import program_counters


def read(run):
    c = program_counters()
    if not c or c.get("k1.lanes", 0) <= 0:
        return None
    return 100.0 * c.get("k1.lanes_skipped", 0) / c["k1.lanes"]
