"""Parallel enhancement and training on meshes of devices and processes
(port of ``se_snmf_nat_tpu.parallel``)."""

from se_snmf_nat_tpu_torch.parallel.mesh import (
    data_sharding, make_mesh, replicated)
from se_snmf_nat_tpu_torch.parallel.scaling import measure_dp_scaling
from se_snmf_nat_tpu_torch.parallel.time_shard import enhance_time_sharded
from se_snmf_nat_tpu_torch.parallel.train_step import (
    distributed_mu_step, make_distributed_train_step)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "distributed_mu_step",
    "make_distributed_train_step",
    "enhance_time_sharded",
    "measure_dp_scaling",
]
