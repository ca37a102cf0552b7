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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "deepspeed_tpu")


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


def test_the_scan_covers_every_module_of_the_port():
    """The file list is a glob, so a new module is held to the rule the
    day it lands; these are the ones added with the LayerNorm families,
    int8 pages, Lion, LAMB, the blockwise quantisation, the rest of
    telemetry, the fleet's subprocess tools, the checkpoints, the timers,
    the monitor, the data pipeline, the 1-bit optimizers, Random-LTD and
    the flops profiler."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"chip_smoke.py",
            "deepspeed_tpu_torch/models/gpt.py",
            "deepspeed_tpu_torch/checkpoint/hf.py",
            "deepspeed_tpu_torch/inference/v2/model_implementations.py",
            "deepspeed_tpu_torch/ops/normalization.py",
            "deepspeed_tpu_torch/ops/paged_attention.py",
            "deepspeed_tpu_torch/ops/quantization.py",
            "deepspeed_tpu_torch/ops/fused_optimizer.py",
            "deepspeed_tpu_torch/runtime/optimizers.py",
            "deepspeed_tpu_torch/telemetry/watchdog.py",
            "deepspeed_tpu_torch/telemetry/timeseries.py",
            "deepspeed_tpu_torch/telemetry/memory.py",
            "deepspeed_tpu_torch/telemetry/slo.py",
            "deepspeed_tpu_torch/telemetry/federation.py",
            "deepspeed_tpu_torch/telemetry/server.py",
            "deepspeed_tpu_torch/utils/comms_logging.py",
            "deepspeed_tpu_torch/utils/logging.py",
            "deepspeed_tpu_torch/tools/fleet_replica.py",
            "deepspeed_tpu_torch/tools/fleetctl.py",
            "deepspeed_tpu_torch/checkpoint/engine.py",
            "deepspeed_tpu_torch/checkpoint/universal.py",
            "deepspeed_tpu_torch/checkpoint/zero_to_fp32.py",
            "deepspeed_tpu_torch/monitor/monitor.py",
            "deepspeed_tpu_torch/utils/timer.py",
            "deepspeed_tpu_torch/runtime/data_pipeline/data_sampler.py",
            "deepspeed_tpu_torch/runtime/data_pipeline/indexed_dataset.py",
            "deepspeed_tpu_torch/runtime/data_pipeline/"
            "curriculum_scheduler.py",
            "deepspeed_tpu_torch/ops/op_builder/builder.py",
            "deepspeed_tpu_torch/ops/adam/cpu_adam.py",
            "deepspeed_tpu_torch/ops/aio/async_io.py",
            "deepspeed_tpu_torch/runtime/zero/offload.py",
            "deepspeed_tpu_torch/utils/memory.py",
            "deepspeed_tpu_torch/runtime/comm/compressed.py",
            "deepspeed_tpu_torch/runtime/data_pipeline/data_routing.py",
            "deepspeed_tpu_torch/profiling/flops_profiler.py"} <= names
    assert len(names) >= 74


def test_the_host_op_builder_reads_only_the_ports_sources():
    """The offload optimizers and the async I/O build from the port's own
    copies of the host sources: the builder names no path under the JAX
    package or the root ``csrc/``, and every source it compiles lies
    under ``deepspeed_tpu_torch/csrc/host``."""
    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS, builder
    text = (PORT / "ops" / "op_builder" / "builder.py").read_text()
    assert "deepspeed_tpu/" not in text and '"csrc"' in text
    host = (PORT / "csrc" / "host").resolve()
    assert builder.HOST_SRC_DIR.resolve() == host
    for cls in ALL_OPS.values():
        b = cls()
        for src in b.absolute_sources() + b.include_dirs():
            assert src.resolve().is_relative_to(host), src
            assert src.exists(), src


def test_the_hf_import_modules_are_scanned_and_need_no_transformers():
    """The Hugging Face loaders, the policy table and the engine factory
    are held to the rule too, and importing them loads no
    ``transformers`` (the card's machine has none: only a checkpoint
    directory needs it, imported at the call)."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    mods = ("deepspeed_tpu_torch.checkpoint.hf",
            "deepspeed_tpu_torch.module_inject.policies",
            "deepspeed_tpu_torch.inference.v2.factory")
    assert {m.replace(".", "/") + ".py" for m in mods} <= names
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "assert 'transformers' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


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


def test_family_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    from deepspeed_tpu_torch.inference import v2 as T
    from deepspeed_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = gpt_config("debug", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM("debug").init_params(0)
    params = init_params(cfg, 0, device="cpu")
    for cls in (T.implementation_for("gpt2"), T.implementation_for("opt")):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(cfg, params)
        model = cls(cfg, params, device="cpu")
        assert model.implementations["norm"] == "plain"
        with pytest.raises(ValueError):    # the kernel needs a CUDA model
            cls(cfg, params, device="cpu",
                implementations={"norm": "cuda_layernorm"})
    engine = T.InferenceEngineV2(model, T.RaggedInferenceEngineConfig(
        serving=T.ServingOptimizationConfig(kv_quantization="int8")))
    assert engine.state_manager.kv_cache.data.payload.device.type == "cpu"


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


def _card_cases():
    from deepspeed_tpu_torch.models.gpt import gpt_config
    from deepspeed_tpu_torch.models.llama import llama_config
    bf16 = dict(dtype=torch.bfloat16)
    return {
        # (config, the first op class without a kernel for it; None: the
        # kernels take every op class of the model)
        "fp32 layernorm, head_dim 128": (
            gpt_config("1.3b", dtype=torch.float32), "norm"),
        "fp32 rmsnorm, head_dim 128": (
            llama_config("7b", dtype=torch.float32), "norm"),
        "bf16 gpt 125m, head_dim 64": (gpt_config("125m", **bf16), None),
        "bf16 gpt 2.7b, head_dim 80": (gpt_config("2.7b", **bf16), None),
        "bf16 debug llama, head_dim 16": (llama_config("debug", **bf16),
                                          "ragged_attention"),
        "bf16 llama, head_dim 112": (
            llama_config("7b", head_dim=112, **bf16), "ragged_attention"),
        "bf16 gpt-j width, head_dim 256": (
            gpt_config("1.3b", num_heads=8, **bf16), "ragged_attention"),
    }


@pytest.mark.parametrize("case", sorted(_card_cases()))
def test_registry_off_the_cpu_never_picks_a_plain_version_unasked(case):
    """On the card an op class that has a kernel runs it or raises: a
    model the kernels do not take (fp32, or a head_dim outside 64, 80, 96
    and 128) gets a NotImplementedError naming the ROADMAP item, a model
    they take resolves every op class to its kernel, and the plain
    versions stay reachable by name.  ``resolve`` only reads the device's
    type, so this needs no card."""
    from deepspeed_tpu_torch.inference.v2 import modules
    cfg, first = _card_cases()[case]
    cuda = torch.device("cuda")
    plain = {"norm": "plain", "ragged_attention": "dense_gather",
             "fresh_prefill_attention": "mha_reference"}
    raised = [op for op in plain
              if _raises_11k(lambda: modules.resolve(op, cfg, cuda))]
    if first is None:
        assert raised == []
        assert modules.resolve("ragged_attention", cfg, cuda) == "cuda_paged"
        assert modules.resolve("fresh_prefill_attention", cfg, cuda) == \
            "cuda_flash"
    else:
        assert first in raised
        # flash: bf16 at the kernels' head dims
        assert "fresh_prefill_attention" in raised
    for op, name in plain.items():
        assert modules.resolve(op, cfg, cuda, name) == name
        assert modules.resolve(op, cfg, torch.device("cpu")) == name
    # op classes with no kernel at all keep their one implementation
    assert modules.resolve("embedding", cfg, cuda) == "ragged_embedding"
    assert modules.resolve("unembed", cfg, cuda) == "last_token_gather"


def _raises_11k(fn) -> bool:
    try:
        fn()
    except NotImplementedError as e:
        assert "item 11k" in str(e)
        return True
    return False


def test_registry_on_the_card_picks_the_kernels_for_the_served_models():
    from deepspeed_tpu_torch.inference.v2 import modules
    from deepspeed_tpu_torch.models.gpt import gpt_config
    from deepspeed_tpu_torch.models.llama import llama_config
    cuda = torch.device("cuda")
    want = {"ragged_attention": "cuda_paged",
            "fresh_prefill_attention": "cuda_flash"}
    for cfg, norm in ((gpt_config("1.3b", dtype=torch.bfloat16),
                       "cuda_layernorm"),
                      (llama_config("7b", dtype=torch.bfloat16),
                       "cuda_rmsnorm")):
        for op, name in dict(want, norm=norm).items():
            assert modules.resolve(op, cfg, cuda) == name


@pytest.mark.parametrize("over", [dict(dtype=torch.float32),
                                  dict(dtype=torch.bfloat16)])
def test_model_off_the_cpu_raises_for_a_layout_without_kernels(monkeypatch,
                                                               over):
    """Through the constructors a user calls: the debug OPT-like model
    (head_dim 16) on a device that is not the CPU raises at build instead
    of serving through the plain versions; named, they build.  A meta
    device stands in for the card."""
    from deepspeed_tpu_torch.inference import v2 as T
    from deepspeed_tpu_torch.inference.v2 import model as model_mod
    from deepspeed_tpu_torch.models.gpt import gpt_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = gpt_config("debug", **over)
    params = init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(model_mod, "resolve_device",
                        lambda d: torch.device("meta"))
    for cls in (T.RaggedInferenceModel, T.implementation_for("gpt2")):
        with pytest.raises(NotImplementedError, match="item 11k"):
            cls(cfg, params)
        named = cls(cfg, params, implementations={
            "norm": "plain", "ragged_attention": "dense_gather",
            "fresh_prefill_attention": "mha_reference"})
        assert named.implementations["norm"] == "plain"


def test_kernel_wrappers_take_the_plain_path_only_for_cpu_tensors():
    from deepspeed_tpu_torch.ops import normalization as N
    x = torch.randn(4, 64)
    w = torch.ones(64)
    before = N.KERNEL.launches
    torch.testing.assert_close(N.rmsnorm(x, w), N.rmsnorm_reference(x, w))
    out, res = N.rmsnorm(x, w, residual=x)
    ref, ref_res = N.rmsnorm_res_reference(x, x, w)
    assert torch.equal(out, ref) and torch.equal(res, ref_res)
    assert N.KERNEL.launches == before     # CPU: no launch, no build
    before = N.LN_KERNEL.launches
    assert torch.equal(N.layernorm(x, w, w), N.layernorm_reference(x, w, w))
    assert N.LN_KERNEL.launches == before


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
