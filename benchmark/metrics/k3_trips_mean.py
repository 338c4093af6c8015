"""The mean trips a column of K3's solves ran in the window:
``k3.column_trips`` / ``k3.columns``, the program's counters."""

from benchmark.program_trace import program_counters


def read(run):
    c = program_counters()
    if not c or c.get("k3.columns", 0) <= 0:
        return None
    return c["k3.column_trips"] / c["k3.columns"]
