"""The port stands alone: no JAX, no ``deepspeed_tpu``, GPU by default.

``deepspeed_tpu_torch`` and ``chip_smoke.py`` must run on a GPU machine
that has no JAX, so neither may import ``jax``, ``flax`` or any module
of the JAX package (not even its plain-Python ones).  Entry points run
on CUDA unless ``device="cpu"`` is asked for, and raise without a GPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_importing_every_port_module_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + "]\n"
            + "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def _tiny():
    from deepspeed_tpu_torch.inference import v2 as T
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = llama_config("debug", dtype=torch.float32)
    kv = T.KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16,
                         page_size=16, num_pages=8, dtype=torch.float32)
    return T, cfg, kv, init_params


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    T, cfg, kv, init_params = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.InferenceEngineV2(T.RaggedInferenceModel(cfg, params,
                                                   kv_config=kv))
    engine = T.InferenceEngineV2(T.RaggedInferenceModel(
        cfg, params, kv_config=kv, device="cpu"))
    logits = engine.put([0], [[1, 2, 3]])
    assert logits.shape == (1, 128) and logits.device.type == "cpu"


def test_cpu_model_picks_the_plain_versions_and_pins_by_name():
    T, cfg, kv, init_params = _tiny()
    params = init_params(cfg, 0, device="cpu")
    model = T.RaggedInferenceModel(cfg, params, kv_config=kv, device="cpu")
    assert model.implementations["ragged_attention"] == "dense_gather"
    assert model.implementations["norm"] == "plain"
    assert model.implementations["fresh_prefill_attention"] == \
        "mha_reference"
    with pytest.raises(ValueError):        # the kernel needs a CUDA model
        T.RaggedInferenceModel(cfg, params, kv_config=kv, device="cpu",
                               implementations={"norm": "cuda_rmsnorm"})
    with pytest.raises(KeyError):
        T.RaggedInferenceModel(cfg, params, kv_config=kv, device="cpu",
                               implementations={"norm": "no_such_impl"})


def test_kernel_wrappers_take_the_plain_path_only_for_cpu_tensors():
    from deepspeed_tpu_torch.ops import normalization as N
    x = torch.randn(4, 64)
    w = torch.ones(64)
    before = N.KERNEL.launches
    torch.testing.assert_close(N.rmsnorm(x, w), N.rmsnorm_reference(x, w))
    assert N.KERNEL.launches == before     # CPU: no launch, no build


def test_kernel_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """Libraries are named by a hash of the source, the shared headers
    and the flags: an unchanged source is not rebuilt, an edited one is,
    and a failing nvcc raises with its output."""
    from deepspeed_tpu_torch.ops import kernel_loader as KL
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    (csrc / "common.cuh").write_text("// header\n")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    calls = tmp_path / "calls"
    # a stand-in compiler: records the call, writes the -o target, and
    # fails on sources containing "bad"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo x >> {calls}\n"
                    "out=''; prev=''; src=''\n"
                    "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; "
                    "prev=$a; src=$a; done\n"
                    "grep -q bad \"$src\" && { echo 'error: bad'; exit 1; }\n"
                    "echo lib > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    monkeypatch.setattr(KL, "CSRC_DIR", csrc)
    monkeypatch.setattr(KL, "BUILD_DIR", tmp_path / "build")
    k = KL.CudaKernel("k.cu", {})
    first = k.library_path
    KL.build_all([k])
    assert first.exists() and calls.read_text().count("x") == 1
    KL.build_all([k])                          # unchanged: no rebuild
    assert calls.read_text().count("x") == 1
    (csrc / "k.cu").write_text("// v2\n")
    assert k.library_path != first
    k.build()
    assert k.library_path.exists() and calls.read_text().count("x") == 2
    (csrc / "k.cu").write_text("// bad\n")
    with pytest.raises(RuntimeError, match="error: bad"):
        k.build()
    assert not k.library_path.exists()
