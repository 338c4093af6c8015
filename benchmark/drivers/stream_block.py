"""Open-loop live audio through the block-adaptive serving fleet: the loop,
the audio, the checked lanes and the comparison of ``drivers/stream.py``
(its ``fleet`` api), on the fleet that ``serve --block-adaptive`` builds,
``MultiStreamSession(enh, lanes, block_frames=K, use_block_adaptive=True,
wire="frames")``: each tick's K hops a lane run as one block of the
session's block-adaptive step.

K is the configuration's ``session.block_frames``; a traffic file whose
``block_frames`` or ``wire`` says otherwise is refused.  The comparison
holds each checked lane's first ``check_frames`` frames, a whole number of
blocks, to the reference module's ``live`` (``reference/
snmf_nat_session.py``), which is told the block the fleet ran at.
"""

from __future__ import annotations

import numpy as np

from benchmark.drivers import stream


class Driver(stream.Driver):

    def __init__(self, cell):
        t = cell.traffic
        self.block = int(cell.config["session"]["block_frames"])
        if (t["api"] != "fleet" or int(t["block_frames"]) != self.block
                or t["wire"] != "frames"):
            raise ValueError(
                f"the block-adaptive fleet runs blocks of {self.block} "
                f"frames on the frames wire: the traffic asks for "
                f"{t['api']}, {t['block_frames']} frames, {t['wire']}")
        super().__init__(cell)

    def _session(self):
        from se_snmf_nat_tpu_torch.stream.serving import MultiStreamSession
        return MultiStreamSession(self.enh, self.lanes,
                                  block_frames=self.block,
                                  use_block_adaptive=True, wire="frames")

    def numbers(self, dtype, device) -> dict[str, float]:
        """The checked lanes' first ``check_frames`` frames against the
        reference's from the same samples: ``err_median``, ``err_q75`` and
        ``err_max`` over the lanes, and the refits the reference ran."""
        from benchmark import compare
        shift, h = self.cell.shift, self.check_frames
        got = np.concatenate(self.outs, axis=1)[:, :(h - self.cell.delay)
                                                * shift]
        x = self._samples(0, h * shift)[self.checked]
        want, refits = self.cell.reference.live(
            x, h, self.cell.config, self.cell.bases, dtype=dtype,
            device=device, block_frames=self.block)
        return dict(compare.lane_numbers(list(got), list(want)),
                    refits=float(refits))
