"""Launch the port's gloo rank processes once per test session.

A test file asks :func:`run_ranks` for its plans by key; the first
pytest worker to ask writes the inputs and the plans, starts
``deepspeed_tpu_torch.launcher.launch --num_gpus=W`` over
``tests/torch_rank_worker.py`` on a free port for each (the launches
run at once), and records the exit codes; every other worker waits on
the same file locks and reads what the ranks wrote.  The launcher and
the subprocess each carry a time limit, so a hung rank fails the tests
that read it instead of the run.
"""

import fcntl
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_rank_worker.py")
#: seconds the ranks may take (launcher) and the launch may take
LAUNCH_TIMEOUT_S = 240


def shared_root(tmp_path_factory) -> str:
    """A directory every pytest-xdist worker of this session shares."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return str(base)


def run_ranks(root: str, launches) -> dict:
    """``{key: directory of its results}`` for ``launches``, a list of
    ``(key, world, build_plan)``, launching (all at once) the keys no
    worker has run yet.  ``build_plan(dir)`` writes the inputs and
    returns the plan (``{"scenarios": [...]}``)."""
    from deepspeed_tpu_torch.launcher.launch import free_port
    dirs, locks, procs = {}, [], {}
    try:
        for key, world, build_plan in launches:
            d = os.path.join(root, f"ranks_{key}")
            os.makedirs(d, exist_ok=True)
            dirs[key] = d
            lock = open(os.path.join(d, "lock"), "w")
            locks.append(lock)
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(os.path.join(d, "done.json")):
                continue
            plan = build_plan(d)
            plan["out"] = d
            plan_path = os.path.join(d, "plan.json")
            with open(plan_path, "w") as f:
                json.dump(plan, f)
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("XLA_", "JAX_", "PYTEST_"))}
            env["OMP_NUM_THREADS"] = "1"
            cmd = [sys.executable, "-m",
                   "deepspeed_tpu_torch.launcher.launch",
                   f"--num_gpus={world}", f"--master_port={free_port()}",
                   f"--timeout={LAUNCH_TIMEOUT_S}", WORKER, "--", plan_path]
            with open(os.path.join(d, "stderr.log"), "w") as err:
                procs[key] = subprocess.Popen(cmd, cwd=REPO, env=env,
                                              stdout=subprocess.DEVNULL,
                                              stderr=err)
        for key, p in procs.items():
            try:
                p.wait(timeout=LAUNCH_TIMEOUT_S + 30)
                with open(os.path.join(dirs[key], "stderr.log")) as f:
                    info = {"rc": p.returncode, "stderr": f.read()[-6000:]}
            except subprocess.TimeoutExpired as e:
                p.kill()
                p.wait()
                info = {"rc": 124, "stderr": str(e)}
            with open(os.path.join(dirs[key], "done.json"), "w") as f:
                json.dump(info, f)
    finally:
        for lock in locks:
            fcntl.flock(lock, fcntl.LOCK_UN)
            lock.close()
    for key, d in dirs.items():
        with open(os.path.join(d, "done.json")) as f:
            info = json.load(f)
        if info["rc"] != 0:
            raise AssertionError(f"ranks of {key} exited {info['rc']}:\n"
                                 f"{info['stderr']}")
    return dirs


def result(d: str, name: str, rank: int):
    """What rank ``rank`` wrote for scenario ``name`` (files the ranks of
    this session wrote)."""
    res = torch.load(os.path.join(d, f"{name}.rank{rank}.pt"),
                     weights_only=False)
    if "error" in res:
        raise AssertionError(f"rank {rank} failed {name}:\n{res['error']}")
    return res
