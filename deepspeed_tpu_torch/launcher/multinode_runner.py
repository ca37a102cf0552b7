"""Multi-node runners: build the command that starts ``launch.py`` everywhere.

Counterpart of ``deepspeed_tpu/launcher/multinode_runner.py`` (the
reference's PDSH / OpenMPI / SLURM runners).  Each runner turns
(resources, world-info, user command) into one shell command, as
strings, executed from the launching node: pdsh or an ssh loop start
``deepspeed_tpu_torch.launcher.launch`` on every host with its node
rank; mpirun and srun start the user script directly.  The gcloud
runner of the JAX package (Cloud TPU pods) is kept for its command.
"""

from __future__ import annotations

import abc
import base64
import json
import os
import shlex
import sys
from typing import Dict, List, Optional

from ..utils.logging import logger


def encode_world_info(resources: Dict[str, int]) -> str:
    """base64(JSON) world map, passed on the launch.py command line
    (reference ``runner.py:353``)."""
    return base64.urlsafe_b64encode(
        json.dumps(dict(resources)).encode()).decode()


def decode_world_info(encoded: str) -> Dict[str, int]:
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


class MultiNodeRunner(abc.ABC):
    """Builds the fan-out command for one launcher backend."""

    def __init__(self, args, world_info_b64: str):
        self.args = args
        self.world_info_b64 = world_info_b64
        self.user_arguments: List[str] = list(args.user_args or [])
        # strip the argparse REMAINDER separator once, so direct-exec
        # backends (mpirun/srun) agree with the launch.py path
        if self.user_arguments and self.user_arguments[0] == "--":
            self.user_arguments = self.user_arguments[1:]
        self.user_script: str = args.user_script
        self.exports: Dict[str, str] = {}

    def add_export(self, key: str, var: str) -> None:
        self.exports[key.strip()] = var.strip()

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Runner", "").lower()

    @abc.abstractmethod
    def backend_exists(self) -> bool:
        """Is the launch tool present on this launching node?"""

    @abc.abstractmethod
    def get_cmd(self, environment: Dict[str, str],
                active_resources: Dict[str, int]) -> List[str]:
        """Full argv run from the launching node."""

    def _launch_py_cmd(self, extra: Optional[List[str]] = None) -> List[str]:
        cmd = [
            sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
            f"--world_info={self.world_info_b64}",
            f"--master_addr={self.args.master_addr}",
            f"--master_port={self.args.master_port}",
        ]
        if getattr(self.args, "proc_per_chip", False):
            cmd.append("--proc_per_chip")
        if getattr(self.args, "num_gpus", None):
            cmd.append(f"--num_gpus={self.args.num_gpus}")
        if extra:
            cmd.extend(extra)
        cmd.append(self.user_script)
        cmd.extend(self.user_arguments)
        return cmd


def _which(tool: str) -> bool:
    from shutil import which
    return which(tool) is not None


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out (reference PDSHRunner): one ssh per host, env exported
    inline, each host told its own node rank via ``%n``."""

    def backend_exists(self) -> bool:
        return _which("pdsh")

    def get_cmd(self, environment, active_resources):
        environment = dict(environment)
        environment["PDSH_RCMD_TYPE"] = "ssh"
        hosts = ",".join(active_resources.keys())
        exports = "".join(f"export {k}={shlex.quote(v)}; "
                          for k, v in self.exports.items())
        launch = " ".join(shlex.quote(c) for c in
                          self._launch_py_cmd(extra=["--node_rank=%n"]))
        return ["pdsh", "-S", "-f", "1024", "-w", hosts,
                f"{exports}cd {shlex.quote(os.getcwd())}; {launch}"]


class SSHRunner(MultiNodeRunner):
    """Plain ssh loop, the zero-dependency default.

    Emits a compound shell command that backgrounds one ssh per host and
    waits; each host receives its node rank explicitly.
    """

    def backend_exists(self) -> bool:
        return _which("ssh")

    def get_cmd(self, environment, active_resources):
        exports = "".join(f"export {k}={shlex.quote(v)}; "
                          for k, v in self.exports.items())
        parts = ["pids=()"]
        for rank, host in enumerate(active_resources.keys()):
            launch = " ".join(shlex.quote(c) for c in
                              self._launch_py_cmd(extra=[f"--node_rank={rank}"]))
            remote = f"{exports}cd {shlex.quote(os.getcwd())}; {launch}"
            parts.append(
                f"ssh -o StrictHostKeyChecking=no {shlex.quote(host)} "
                f"{shlex.quote(remote)} & pids+=($!)")
        # propagate the first failing child's exit code (a bare `wait`
        # always returns 0)
        parts.append('rc=0; for p in "${pids[@]}"; do wait "$p" || rc=$?; '
                     'done; exit $rc')
        script = "; ".join(parts)
        return ["/bin/bash", "-c", script]


class GCloudTPURunner(MultiNodeRunner):
    """``gcloud compute tpus tpu-vm ssh --worker=all`` — the Cloud TPU pod
    fan-out.  Node rank is derived on-worker from the TPU metadata env
    (``TPU_WORKER_ID``), so the same command is sent to every worker."""

    def backend_exists(self) -> bool:
        return _which("gcloud")

    def get_cmd(self, environment, active_resources):
        exports = "".join(f"export {k}={shlex.quote(v)}; "
                          for k, v in self.exports.items())
        launch = " ".join(shlex.quote(c) for c in
                          self._launch_py_cmd(extra=["--node_rank=env"]))
        remote = f"{exports}cd {shlex.quote(os.getcwd())}; {launch}"
        tpu_name = getattr(self.args, "tpu_name", None) or os.environ.get(
            "TPU_NAME", "")
        cmd = ["gcloud", "compute", "tpus", "tpu-vm", "ssh", tpu_name,
               "--worker=all", f"--command={remote}"]
        zone = getattr(self.args, "tpu_zone", None)
        if zone:
            cmd.append(f"--zone={zone}")
        return cmd


class OpenMPIRunner(MultiNodeRunner):
    """mpirun fan-out; ranks come from OMPI env on each process."""

    def backend_exists(self) -> bool:
        return _which("mpirun")

    def get_cmd(self, environment, active_resources):
        per_chip = getattr(self.args, "proc_per_chip", False)
        if per_chip:
            total_procs = sum(active_resources.values())
            hosts = ",".join(f"{h}:{s}" for h, s in active_resources.items())
            placement = []
        else:
            # one rank per host: advertise 1 slot each so OMPI's by-slot
            # mapper cannot pack every rank onto the first host
            total_procs = len(active_resources)
            hosts = ",".join(f"{h}:1" for h in active_resources)
            placement = ["--npernode", "1"]
        cmd = (["mpirun", "-n", str(total_procs), "-host", hosts] + placement +
               ["--mca", "btl", "^openib", "--mca", "btl_tcp_if_include", "eth0"])
        for k, v in self.exports.items():
            cmd += ["-x", f"{k}={v}"]
        # mpirun starts the user script directly; the script maps
        # OMPI_COMM_WORLD_RANK to RANK before init_distributed
        cmd += [sys.executable, "-u", self.user_script] + self.user_arguments
        return cmd


class SlurmRunner(MultiNodeRunner):
    def backend_exists(self) -> bool:
        return _which("srun")

    def get_cmd(self, environment, active_resources):
        per_chip = getattr(self.args, "proc_per_chip", False)
        if per_chip:
            slot_counts = set(active_resources.values())
            if len(slot_counts) > 1:
                # srun's --ntasks-per-node is uniform; heterogeneous slot
                # filters would land ranks on excluded chips
                raise ValueError(
                    "slurm per-chip launch requires a uniform slot count "
                    f"per host, got {dict(active_resources)}; use the ssh "
                    "or pdsh launcher for heterogeneous filters")
            total_procs = sum(active_resources.values())
            tasks_per_node = slot_counts.pop()
        else:
            total_procs = len(active_resources)
            tasks_per_node = 1
        cmd = ["srun", "-n", str(total_procs),
               "--ntasks-per-node", str(tasks_per_node),
               # pin placement to the filtered host list; srun would
               # otherwise ignore include/exclude entirely
               "-w", ",".join(active_resources.keys())]
        if self.exports:
            # ALL first: a bare list would REPLACE the environment on the
            # compute nodes (dropping PATH/LD_LIBRARY_PATH/venv vars)
            cmd += ["--export=ALL," + ",".join(
                f"{k}={v}" for k, v in self.exports.items())]
        cmd += [sys.executable, "-u", self.user_script] + self.user_arguments
        return cmd


RUNNER_CLASSES = {
    "pdsh": PDSHRunner,
    "ssh": SSHRunner,
    "gcloud": GCloudTPURunner,
    "openmpi": OpenMPIRunner,
    "slurm": SlurmRunner,
}


def select_runner(launcher: str, args, world_info_b64: str) -> MultiNodeRunner:
    """Pick runner by name or auto-probe (reference ``runner.py:517-527``)."""
    if launcher != "auto":
        cls = RUNNER_CLASSES.get(launcher.lower())
        if cls is None:
            raise ValueError(f"unknown launcher {launcher!r}; "
                             f"options: {sorted(RUNNER_CLASSES)}")
        return cls(args, world_info_b64)
    for name in ("pdsh", "ssh", "openmpi", "slurm"):
        runner = RUNNER_CLASSES[name](args, world_info_b64)
        if runner.backend_exists():
            logger.info("auto-selected %s launcher", name)
            return runner
    raise RuntimeError("no multinode launch backend found "
                       "(tried pdsh, ssh, mpirun, srun)")
