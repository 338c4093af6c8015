"""K3's share of the device's busy time in the window: the time of K3's
kernels (``yardstick_k3.K3_KERNELS``) over the union of every kernel's
interval in the window (%)."""

import numpy as np

from benchmark.yardstick import covered
from benchmark.yardstick_k3 import K3_KERNELS


def read(run):
    tr = run.trace
    if tr is None:
        return None
    pick = (tr.starts >= run.t0) & (tr.starts < run.t1) & np.asarray(
        [any(n in name for n in K3_KERNELS) for name in tr.names], bool)
    busy = covered(tr.union, run.t0, run.t1)
    if not pick.any() or busy <= 0:
        return None
    return 100.0 * float(np.sum(tr.ends[pick] - tr.starts[pick])) / busy
