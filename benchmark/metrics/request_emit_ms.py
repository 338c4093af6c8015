"""ms of a request (a fleet tick's or a session's push) in its ``stream.emit``
stage (overlap-add, ``_emit_pcm``, ``_assemble``, quantize and the final
stack) during which no kernel runs: the program's spans of the stage less
the kernel union inside them, over the window's requests."""

from benchmark.program_trace import stage_ms


def read(run):
    return stage_ms(run, "stream.emit")
