"""Top-level launch CLI: ``python -m deepspeed_tpu_torch.launcher.runner
train.py ...``.

Counterpart of ``deepspeed_tpu/launcher/runner.py`` (the reference's
``runner.py`` ``main``): hostfile, filters, the world-info encoding,
then on one node :mod:`.launch` in this process, or across nodes the
fan-out command of :mod:`.multinode_runner`.  ``--num_gpus N`` starts N
rank processes a host (on a machine with one card they share it, over
gloo); ``--proc_per_chip`` one per slot.  ``--elastic_training`` needs
the elasticity module, which the port does not have yet.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from collections import OrderedDict

from .hostfile import fetch_hostfile, filter_resources
from .multinode_runner import encode_world_info, select_runner
from ..utils.logging import logger

DEFAULT_MASTER_PORT = 29500

#: environment the runner exports to remote hosts
EXPORT_PREFIXES = ("DS_", "NCCL_", "CUDA_", "TORCH_", "PYTHONPATH")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch",
        description="launch a deepspeed_tpu_torch training script across "
                    "hosts")
    p.add_argument("-H", "--hostfile", default="/job/hostfile",
                   help="path to 'host slots=N' hostfile")
    p.add_argument("-i", "--include", default="",
                   help="host[:slots]@host2 inclusion filter")
    p.add_argument("-e", "--exclude", default="",
                   help="host[:slots]@host2 exclusion filter")
    p.add_argument("--num_nodes", type=int, default=-1,
                   help="cap the number of hosts used")
    p.add_argument("--num_gpus", type=int, default=None,
                   help="rank processes a host (they may share a card)")
    p.add_argument("--master_addr", default=None)
    p.add_argument("--master_port", type=int, default=DEFAULT_MASTER_PORT)
    p.add_argument("--launcher", default="auto",
                   choices=["auto", "pdsh", "ssh", "gcloud", "openmpi",
                            "slurm"])
    p.add_argument("--proc_per_chip", action="store_true",
                   help="one process per slot (GPU)")
    p.add_argument("--tpu_name", default=None)
    p.add_argument("--tpu_zone", default=None)
    p.add_argument("--force_multi", action="store_true")
    p.add_argument("--elastic_training", action="store_true")
    p.add_argument("--deepspeed_config", "--config", dest="config",
                   default=None, help="JSON config (for elastic resolution)")
    p.add_argument("user_script", help="training script to launch")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resources = fetch_hostfile(args.hostfile)
    if resources is None:
        # single node: the local cards (or --num_gpus ranks)
        resources = OrderedDict([("localhost", int(os.environ.get(
            "DS_LOCAL_SLOTS", str(args.num_gpus or 1))))])
    resources = filter_resources(resources, args.include, args.exclude)
    if args.num_nodes > 0:
        resources = OrderedDict(list(resources.items())[:args.num_nodes])
    if args.elastic_training:
        raise NotImplementedError(
            "--elastic_training needs the elasticity module, which is not "
            "in the port yet (ROADMAP Queue 1 item 4)")

    if args.master_addr is None:
        first = next(iter(resources))
        args.master_addr = "127.0.0.1" if first == "localhost" else first

    world_info = encode_world_info(resources)
    multi_node = args.force_multi or (
        len(resources) > 1 or next(iter(resources)) != "localhost")

    if not multi_node:
        from .launch import main as launch_main
        launch_argv = [f"--world_info={world_info}", "--node_rank=0",
                       f"--master_addr={args.master_addr}",
                       f"--master_port={args.master_port}"]
        if args.proc_per_chip:
            launch_argv.append("--proc_per_chip")
        if args.num_gpus:
            launch_argv.append(f"--num_gpus={args.num_gpus}")
        launch_argv.append(args.user_script)
        user_args = list(args.user_args)
        if user_args and user_args[0] == "--":
            user_args = user_args[1:]
        launch_argv.extend(user_args)
        return launch_main(launch_argv)

    runner = select_runner(args.launcher, args, world_info)
    if not runner.backend_exists():
        raise RuntimeError(f"launcher backend {runner.name!r} not available")
    for key, val in os.environ.items():
        if key.startswith(EXPORT_PREFIXES):
            runner.add_export(key, val)
    cmd = runner.get_cmd(dict(os.environ), resources)
    logger.info("launching: %s", " ".join(cmd))
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
