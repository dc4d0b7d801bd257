"""Data, FSDP and tensor parallelism over ``torch.distributed``
(counterpart of ``sdbc_tpu/parallel``): one process per card, a
``(data, model)`` mesh over the ranks (``mesh``), the JAX package's
partition rules (``specs``), their application to the port's modules
(``shard``) and the collectives (``comm``)."""
from sdbc_tpu_torch.parallel.mesh import (MeshConfig, host_local_batch_slice,
                                          make_mesh, mesh_shape)
from sdbc_tpu_torch.parallel.specs import fsdp_specs, tp_specs, validate_tp

__all__ = ["MeshConfig", "make_mesh", "mesh_shape", "host_local_batch_slice",
           "tp_specs", "fsdp_specs", "validate_tp"]
