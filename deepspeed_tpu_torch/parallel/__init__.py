"""The process mesh (counterpart of ``deepspeed_tpu/parallel``)."""

from .topology import (BATCH_AXES, GRAD_REDUCE_AXES, MESH_AXES,  # noqa: F401
                       MeshTopology, TopologyConfig)
