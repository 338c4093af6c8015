"""The share of the real lanes of the window's ``enhance_batch`` calls that
went up as int16 (each lane's true samples, packed) rather than in the
float sample matrix: 100 x ``batch.lanes_int16`` / ``batch.lanes``, the
program's counters (%)."""

from benchmark.program_trace import program_counters


def read(run):
    c = program_counters()
    if not c or c.get("batch.lanes", 0) <= 0:
        return None
    return 100.0 * c.get("batch.lanes_int16", 0) / c["batch.lanes"]
