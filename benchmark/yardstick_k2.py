"""K2's operations and bytes from its work tally, for ``k2_roofline``.

``chip_smoke.w_bound``'s counts of a launch (two products of 2 F R M
operations a lane-trip; V, W0, H and the flag read once, W and the trip
count written once a lane), taken over the launches of a window from the
kernel's counters: the lane-trips run, the active lane-launches, and the
lane-launches in all.  An inactive lane reads its W0 and writes it back
normalised, with its flag and its trip count, and nothing else.  Copied
here, and held to the original by a test, so that a change to the program
cannot change the yardstick.
"""

from __future__ import annotations


def k2_counts(f: int, r: int, m: int, lane_trips: int, active: int,
              lane_launches: int) -> tuple[float, float]:
    flops = 4.0 * f * r * m * lane_trips
    inactive = lane_launches - active
    n_bytes = 4.0 * (active * (f * m + 2 * f * r + r * m)
                     + inactive * 2 * f * r + 2 * lane_launches)
    return flops, n_bytes
