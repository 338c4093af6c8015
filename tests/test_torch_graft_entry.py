"""The port's multi-chip dry run (``graft_entry.dryrun_multichip``, the
twin of the repo root's ``__graft_entry__.dryrun_multichip``) on the CPU:
the distributed training step, DP enhancement on the exact, fast and block
plans, the time shard and both TP solves over meshes of 2 and 8 logical
shards, as the reference's test runs its own on 2 and 8 virtual devices."""

import pytest
import torch

from se_snmf_nat_tpu_torch.graft_entry import dryrun_multichip
from se_snmf_nat_tpu_torch.parallel.collectives_audit import record

torch.set_num_threads(1)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_multichip(n_devices):
    with record() as rep:
        dryrun_multichip(n_devices, device="cpu")
    # two train trips, and the TP solves' rebuilds and cost merges
    assert rep.count > 2
    assert {o["op"] for o in rep.ops} == {"all-reduce"}
