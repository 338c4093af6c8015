"""ms of an ``enhance_batch`` call in its ``batch.emit`` stage (per-lane
slicing and ``matlab_wavwrite_quantize``) during which no kernel runs: the
program's spans of the stage less the kernel union inside them, over the
window's requests."""

from benchmark.program_trace import stage_ms


def read(run):
    return stage_ms(run, "batch.emit")
