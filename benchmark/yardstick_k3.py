"""K3's operations and bytes from its work tally, for ``k3_roofline``.

``chip_smoke.py``'s count of a K3 launch (two products of 2 F R operations
a column-trip; V, W, H0 and H's scales read once, H and the trip counts
written once), taken over a window from the kernel's counters: the
columns solved and their trips, and the launches that solved them.  Copied
here, and held to the original by a test, so that a change to the program
cannot change the yardstick.
"""

from __future__ import annotations


def k3_counts(f: int, r: int, columns: int, column_trips: int,
              launches: int = 1) -> tuple[float, float]:
    flops = 4.0 * f * r * column_trips
    n_bytes = 4.0 * (f * columns + launches * (f * r + r) + r * columns
                     + columns)
    return flops, n_bytes


# K3's kernels by name in a device trace: the two solves (W resident in a
# persistent cluster, or streamed from L2 by 16-column tiles) and the
# streaming path's W normalisation
K3_SOLVES = ("h_cols_stream_kernel", "h_cols_resident_kernel")
K3_KERNELS = K3_SOLVES + ("normalize_w_kernel",)
