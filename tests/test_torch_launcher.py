"""The port's launcher against the JAX package's
(``tests/test_launcher_elasticity.py:32-163``): the hostfile and its
filters, the world info, each rank's environment, a script started per
rank through ``python -m deepspeed_tpu_torch.launcher.launch``, a
child's failure propagated, and the runners' commands.  Both packages'
pure functions run on the same inputs and give equal results; the
launches start real processes (a few tenths of a second each, with
their own time limit)."""

import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from deepspeed_tpu.launcher import filter_resources as j_filter_resources
from deepspeed_tpu.launcher import parse_hostfile as j_parse_hostfile
from deepspeed_tpu.launcher import select_runner as j_select_runner
from deepspeed_tpu.launcher.launch import build_rank_envs as j_rank_envs
from deepspeed_tpu_torch.launcher import (decode_world_info,
                                          encode_world_info,
                                          filter_resources, parse_hostfile,
                                          select_runner)
from deepspeed_tpu_torch.launcher.launch import build_rank_envs, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch"]


def test_parse_hostfile():
    text = textwrap.dedent("""\
        # comment
        worker-0 slots=4
        worker-1 slots=8

        worker-2
    """)
    res = parse_hostfile(text)
    assert list(res.items()) == [("worker-0", 4), ("worker-1", 8),
                                 ("worker-2", 1)]
    assert res == j_parse_hostfile(text)


def test_parse_hostfile_rejects_bad_line():
    with pytest.raises(ValueError):
        parse_hostfile("worker-0 slots=four")
    with pytest.raises(ValueError):
        parse_hostfile("w0 slots=2\nw0 slots=2")


def test_filter_include_exclude():
    res = parse_hostfile("a slots=4\nb slots=4\nc slots=4")
    inc = filter_resources(res, include="a@c:0,1")
    assert dict(inc) == {"a": 4, "c": 2}
    assert inc == j_filter_resources(res, include="a@c:0,1")
    exc = filter_resources(res, exclude="b")
    assert dict(exc) == {"a": 4, "c": 4}
    with pytest.raises(ValueError):
        filter_resources(res, include="a", exclude="b")
    with pytest.raises(ValueError):
        filter_resources(res, include="nope")


def test_world_info_roundtrip():
    res = parse_hostfile("a slots=4\nb slots=2")
    assert decode_world_info(encode_world_info(res)) == {"a": 4, "b": 2}


@pytest.mark.parametrize("per_chip", [False, True])
def test_build_rank_envs_equal_jax(per_chip):
    world = {"a": 2, "b": 3}
    envs = build_rank_envs(world, node_rank=1, master_addr="a",
                           master_port="1", proc_per_chip=per_chip)
    ref = j_rank_envs(world, node_rank=1, master_addr="a", master_port="1",
                      proc_per_chip=per_chip)
    assert [{k: e[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                               "LOCAL_SIZE", "CROSS_RANK", "CROSS_SIZE",
                               "MASTER_ADDR", "MASTER_PORT")}
            for e in envs] == [{k: e[k] for k in envs[0]} for e in ref]
    if per_chip:
        assert [e["RANK"] for e in envs] == ["2", "3", "4"]
        assert all(e["WORLD_SIZE"] == "5" for e in envs)
    else:
        assert len(envs) == 1 and envs[0]["RANK"] == "1"


def test_num_gpus_starts_that_many_ranks_a_host():
    envs = build_rank_envs({"a": 1, "b": 1}, node_rank=1, master_addr="a",
                           master_port="9", proc_per_chip=False, num_gpus=4)
    assert [e["RANK"] for e in envs] == ["4", "5", "6", "7"]
    assert {e["WORLD_SIZE"] for e in envs} == {"8"}
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "2", "3"]
    assert {e["LOCAL_SIZE"] for e in envs} == {"4"}


def test_launch_runs_script_per_rank(tmp_path):
    """End to end: the launcher starts the ranks with the environment
    contract and the user's arguments."""
    script = tmp_path / "train.py"
    out = tmp_path / "out"
    script.write_text(textwrap.dedent(f"""\
        import os, sys
        rank = os.environ["RANK"]
        with open(r"{out}" + rank, "w") as fh:
            fh.write(",".join([rank, os.environ["WORLD_SIZE"],
                               os.environ["MASTER_ADDR"], sys.argv[1],
                               sys.argv[-1]]))
    """))
    world = encode_world_info({"localhost": 2})
    proc = subprocess.run(
        LAUNCH + [f"--world_info={world}", "--node_rank=0",
                  "--master_addr=127.0.0.1", f"--master_port={free_port()}",
                  "--proc_per_chip", str(script), "--", "xyz"],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "out0").read_text() == \
        "0,2,127.0.0.1,--local_rank=0,xyz"
    assert (tmp_path / "out1").read_text() == \
        "1,2,127.0.0.1,--local_rank=1,xyz"


def test_launch_propagates_child_failure(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text("import sys; sys.exit(3)")
    proc = subprocess.run(
        LAUNCH + ["--num_gpus=2", "--master_addr=x", "--master_port=1",
                  str(script)], capture_output=True, timeout=60, cwd=REPO)
    assert proc.returncode == 3


def test_launch_stops_every_rank_at_its_time_limit(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text("import time; time.sleep(60)")
    t0 = time.monotonic()
    proc = subprocess.run(LAUNCH + ["--num_gpus=2", "--timeout=1",
                                    str(script)],
                          capture_output=True, timeout=60, cwd=REPO)
    assert proc.returncode == 124
    assert time.monotonic() - t0 < 30


def test_sigterm_reaches_every_rank(tmp_path):
    """A SIGTERM to the launcher goes on to each child; the children's
    handlers write a file each, and the launcher exits with their
    code."""
    script = tmp_path / "wait.py"
    script.write_text(textwrap.dedent(f"""\
        import os, signal, sys, time
        def stop(*_):
            open(r"{tmp_path}/term" + os.environ["RANK"], "w").close()
            sys.exit(5)
        signal.signal(signal.SIGTERM, stop)
        open(r"{tmp_path}/up" + os.environ["RANK"], "w").close()
        time.sleep(60)
    """))
    proc = subprocess.Popen(LAUNCH + ["--num_gpus=2", str(script)],
                            cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 30
        while not all((tmp_path / f"up{r}").exists() for r in (0, 1)):
            assert time.monotonic() < deadline, "ranks did not start"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 5
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert (tmp_path / "term0").exists() and (tmp_path / "term1").exists()


def test_runner_cmd_construction():
    class Args:
        master_addr = "w0"
        master_port = 29500
        proc_per_chip = False
        num_gpus = None
        user_script = "train.py"
        user_args = ["--foo", "1"]
        tpu_name = "pod"
        tpu_zone = None

    world = encode_world_info({"w0": 4, "w1": 4})
    ssh = select_runner("ssh", Args(), world)
    ssh.add_export("NCCL_DEBUG", "INFO")
    cmd = ssh.get_cmd({}, {"w0": 4, "w1": 4})
    joined = " ".join(cmd)
    assert cmd[0] == "/bin/bash" and "ssh" in joined
    assert "--node_rank=0" in joined and "--node_rank=1" in joined
    assert "NCCL_DEBUG" in joined
    assert "deepspeed_tpu_torch.launcher.launch" in joined

    pdsh = select_runner("pdsh", Args(), world)
    pcmd = pdsh.get_cmd({}, {"w0": 4, "w1": 4})
    assert pcmd[0] == "pdsh" and "w0,w1" in pcmd
    # the same commands as JAX's but for the launch module's name
    jcmd = j_select_runner("pdsh", Args(), world).get_cmd(
        {}, {"w0": 4, "w1": 4})
    assert pcmd[:-1] == jcmd[:-1]
    assert pcmd[-1] == jcmd[-1].replace("deepspeed_tpu.launcher",
                                        "deepspeed_tpu_torch.launcher")
    for name in ("openmpi", "slurm"):
        assert select_runner(name, Args(), world).get_cmd(
            {}, {"w0": 4, "w1": 4}) == j_select_runner(
            name, Args(), world).get_cmd({}, {"w0": 4, "w1": 4})
    with pytest.raises(ValueError):
        select_runner("bogus", Args(), world)


def test_each_rank_takes_its_card_or_shares_card_0(monkeypatch):
    """``comm.rank_device``: ``cuda:LOCAL_RANK`` when the machine has a
    card for every local rank (the NCCL path), else every rank on card 0
    (ranks sharing one card, over gloo); NCCL on fewer cards than local
    ranks raises instead of switching backend."""
    import torch
    from deepspeed_tpu_torch.comm import comm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [comm.rank_device(r, 4) for r in range(4)] == [0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [comm.rank_device(r, 4) for r in range(4)] == [0, 0, 0, 0]
    monkeypatch.setattr(comm, "_initialized", False)
    for k, v in (("WORLD_SIZE", "4"), ("RANK", "1"), ("LOCAL_RANK", "1"),
                 ("LOCAL_SIZE", "4")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="one card per local rank"):
        comm.init_distributed(dist_backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        comm.init_distributed(dist_backend="mpi")
    assert not comm.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert comm.rank_device(0, 4) is None
