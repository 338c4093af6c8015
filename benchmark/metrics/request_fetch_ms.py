"""ms of a request (a fleet tick's or a session's push) in its ``stream.fetch``
stage (the PCM or frames copied to the host) during which no kernel runs:
the program's spans of the stage less the kernel union inside them, over the
window's requests."""

from benchmark.program_trace import stage_ms


def read(run):
    return stage_ms(run, "stream.fetch")
