"""ms of an ``enhance_batch`` call in its ``batch.prep`` stage (the sample
matrix, ``pack_samples_for_upload`` and the upload) during which no kernel
runs: the program's spans of the stage less the kernel union inside them,
over the window's requests."""

from benchmark.program_trace import stage_ms


def read(run):
    return stage_ms(run, "batch.prep")
