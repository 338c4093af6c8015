"""ms of a request (a fleet tick's or a session's push) in its
``stream.launch`` stage (analysis, the frame loop or ``_device_tick``,
synthesis and the int16 write enqueued) during which no kernel runs: the
program's spans of the stage less the kernel union inside them, over the
window's requests."""

from benchmark.program_trace import stage_ms


def read(run):
    return stage_ms(run, "stream.launch")
