"""Launcher (counterpart of ``deepspeed_tpu/launcher``): hostfile,
world info, one rank process per slot (or ``--num_gpus`` a host) with
the RANK / LOCAL_RANK / WORLD_SIZE / MASTER_* environment, and the
multinode fan-out commands (pdsh, ssh, gcloud, mpirun, srun)."""

from .hostfile import fetch_hostfile, filter_resources, parse_hostfile  # noqa: F401
from .multinode_runner import (  # noqa: F401
    MultiNodeRunner,
    PDSHRunner,
    SSHRunner,
    GCloudTPURunner,
    OpenMPIRunner,
    SlurmRunner,
    decode_world_info,
    encode_world_info,
    select_runner,
)
