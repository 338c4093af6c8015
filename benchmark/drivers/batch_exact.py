"""Closed-loop offline enhancement on the exact per-frame plan: the batch
loop of ``drivers/batch.py`` with a comparison of four numbers.

The per-frame plan decides on float32 values whether each frame's H-solve
stops (a relative cost change under 1e-3), whether the adaptation fires and
which noise columns its refit takes.  A decision within rounding of its
threshold goes the other way in float32 now and then, and the noise
dictionary's refits carry that lane away from float64's for the rest of
the utterance: a whole lane then reads a few percent while every other
lane stays at rounding level.  So the whole-lane numbers are split by
what each can tell:

* ``err_median`` and ``err_q75`` over whole lanes tell the program from a
  lower precision, which moves every lane;
* ``err_max`` over whole lanes guards against gross faults in one lane
  (a lane zeroed reads 1.0), set far above what a flip reads;
* ``err_head_max``, the largest error over each lane's first
  ``head_frames`` frames (the window the stream cells compare), is
  printed beside them: a flip within the head carries a lane as far as a
  lower precision does.

The limits file gives each compared number's limit and the readings it
was set from.
"""

from __future__ import annotations

import math

from benchmark import compare
from benchmark.drivers import batch


class Driver(batch.Driver):

    def numbers(self, dtype, device) -> dict[str, float]:
        """The kept calls' outputs against the reference's on the same
        utterances, all kept lanes in one batch of the reference."""
        got, xs = [], []
        for g, outs in self.kept:
            got += outs
            xs += self.calls[g]
        want = self.cell.reference.offline(
            xs, self.cell.config, self.cell.bases, dtype=dtype,
            device=device) if xs else []
        nums = compare.lane_numbers(got, want)
        head = (int(self.cell.traffic["head_frames"]) - self.cell.delay) \
            * self.cell.shift
        heads = [compare.error(g[:head], w[:head])
                 for g, w in zip(got, want)]
        nums["err_head_max"] = max(heads) if heads else math.inf
        return nums
