"""ms of an ``enhance_batch`` call in its ``batch.fetch`` stage (the int16 PCM
copied to the host) during which no kernel runs: the program's spans of the
stage less the kernel union inside them, over the window's requests."""

from benchmark.program_trace import stage_ms


def read(run):
    return stage_ms(run, "batch.fetch")
