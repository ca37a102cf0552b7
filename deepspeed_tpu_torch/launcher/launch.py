"""Per-node process launcher.

Counterpart of ``deepspeed_tpu/launcher/launch.py:1-17`` (the
reference's ``launcher/launch.py``): decode the world map, compute this
node's ranks, and start the user script once per local rank with the
distributed environment contract

    RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_SIZE, CROSS_RANK, CROSS_SIZE,
    MASTER_ADDR, MASTER_PORT

which ``comm.init_distributed`` reads.  ``--proc_per_chip`` starts one
process per slot (a GPU of the host); ``--num_gpus N`` starts N rank
processes on every host whatever its cards (several ranks then share a
card: ``comm.rank_device`` gives each ``cuda:0``, and only gloo can
join them); with neither, one process per host (the JAX package's
default).  The first child that exits non-zero stops the others and its
exit code is the launcher's; SIGINT and SIGTERM are passed on to every
child; ``--timeout`` stops them all after that many seconds (exit code
124).

    python -m deepspeed_tpu_torch.launcher.launch --world_info=<b64> \\
        --num_gpus=4 --master_port=29500 train.py -- --my-args
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .multinode_runner import decode_world_info
from ..utils.logging import logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="deepspeed_tpu_torch per-node launcher")
    p.add_argument("--world_info", default=None,
                   help="base64 JSON {host: slots} (default: localhost "
                        "with --num_gpus slots)")
    p.add_argument("--node_rank", default="0",
                   help="this node's rank, or 'env' to read NODE_RANK")
    p.add_argument("--master_addr", default="127.0.0.1")
    p.add_argument("--master_port", default="29500")
    p.add_argument("--proc_per_chip", action="store_true",
                   help="one process per slot (GPU) of the host")
    p.add_argument("--num_gpus", type=int, default=None,
                   help="this many rank processes on every host")
    p.add_argument("--timeout", type=float, default=None,
                   help="stop every child after this many seconds")
    p.add_argument("user_script")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def free_port() -> int:
    """A TCP port of this host that was free a moment ago (bound to
    port 0, then released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_rank_envs(world: Dict[str, int], node_rank: int,
                    master_addr: str, master_port: str,
                    proc_per_chip: bool,
                    num_gpus: Optional[int] = None) -> List[Dict[str, str]]:
    """Environment dicts, one per local process to start on this
    node."""
    hosts = list(world.keys())
    if not 0 <= node_rank < len(hosts):
        raise ValueError(f"node_rank {node_rank} out of range for {hosts}")
    if num_gpus:
        local_size = int(num_gpus)
        world_size = local_size * len(hosts)
        rank_offset = local_size * node_rank
    elif proc_per_chip:
        local_size = world[hosts[node_rank]]
        world_size = sum(world.values())
        rank_offset = sum(world[h] for h in hosts[:node_rank])
    else:
        local_size = 1
        world_size = len(hosts)
        rank_offset = node_rank
    return [{
        "RANK": str(rank_offset + local_rank),
        "LOCAL_RANK": str(local_rank),
        "WORLD_SIZE": str(world_size),
        "LOCAL_SIZE": str(local_size),
        "CROSS_RANK": str(node_rank),
        "CROSS_SIZE": str(len(hosts)),
        "MASTER_ADDR": master_addr,
        "MASTER_PORT": str(master_port),
    } for local_rank in range(local_size)]


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.world_info is None:
        world = {"localhost": int(args.num_gpus or 1)}
    else:
        world = decode_world_info(args.world_info)
    if args.node_rank == "env":
        node_rank = int(os.environ.get("NODE_RANK", "0"))
    else:
        node_rank = int(args.node_rank)
    rank_envs = build_rank_envs(world, node_rank, args.master_addr,
                                args.master_port, args.proc_per_chip,
                                args.num_gpus)
    logger.info("node %d launching %d process(es) for %s", node_rank,
                len(rank_envs), args.user_script)

    procs: List[subprocess.Popen] = []

    # installed before the spawn loop: a signal arriving while children
    # are still being started stops the ones already running
    def _terminate(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
    signal.signal(signal.SIGINT, _terminate)
    signal.signal(signal.SIGTERM, _terminate)

    user_args = list(args.user_args)
    if user_args and user_args[0] == "--":
        user_args = user_args[1:]
    for env_delta in rank_envs:
        env = {**os.environ, **env_delta}
        cmd = [sys.executable, "-u", args.user_script,
               f"--local_rank={env_delta['LOCAL_RANK']}"] + user_args
        procs.append(subprocess.Popen(cmd, env=env))

    # wait; on the first failure stop the rest and keep its code
    deadline = (time.monotonic() + args.timeout
                if args.timeout is not None else None)
    exit_code = 0
    alive = list(procs)
    while alive:
        if deadline is not None and time.monotonic() > deadline:
            logger.error("launch: --timeout %.0f s passed; stopping %d "
                         "child(ren)", args.timeout, len(alive))
            for q in alive:
                q.kill()
            for q in alive:
                q.wait()
            return 124
        for p in list(alive):
            rc = p.poll()
            if rc is None:
                continue
            alive.remove(p)
            if rc != 0 and exit_code == 0:
                exit_code = rc
                logger.error("child %d exited with %d; terminating peers",
                             p.pid, rc)
                for q in alive:
                    q.terminate()
        time.sleep(0.05)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
