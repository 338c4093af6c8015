"""The share of the frames the window's ``enhance_batch`` calls computed
that were padding: 100 x (1 - true frames / frames computed), from the
program's counters ``batch.frames_true`` (each real lane's hops + delay +
1) and ``batch.frames_computed`` (lanes x the bucket's frames) (%)."""

from benchmark.program_trace import program_counters


def read(run):
    c = program_counters()
    if not c or c.get("batch.frames_computed", 0) <= 0:
        return None
    return 100.0 * (1.0 - c["batch.frames_true"]
                    / c["batch.frames_computed"])
