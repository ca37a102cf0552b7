"""One rank of the port's multi-rank CPU tests (imports torch, never JAX).

Started by ``deepspeed_tpu_torch.launcher.launch`` (gloo over the host),
it joins the process group, runs every scenario of a JSON plan in order
and writes each scenario's results to ``<out>/<name>.rank<r>.pt``.  The
test files (``tests/test_torch_zero_ranks.py``,
``tests/test_torch_quantized_wire.py``,
``tests/test_torch_tensor_parallel.py``) write the plan and its inputs
(numpy ``.npz`` files made from seeds or from the JAX engine's initial
weights), launch the ranks once per file and hold what the ranks wrote
against the JAX package in the test process.

    python -m deepspeed_tpu_torch.launcher.launch --num_gpus=4 \\
        --master_port=<free> tests/torch_rank_worker.py -- <plan.json>
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

# the repository root, where the package lies (the launcher starts this
# file as a script)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _nest(flat):
    """``a/b/c`` keys -> nested dicts of tensors."""
    tree = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr))
    return tree


def _model(name):
    if name == "llama":
        from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
        return LlamaForCausalLM("debug", dtype=torch.float32)
    if name == "llama_window":
        # the Mistral layout: GQA and a sliding window shorter than S
        from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
        return LlamaForCausalLM("debug", dtype=torch.float32,
                                sliding_window=12)
    if name == "gpt":
        from deepspeed_tpu_torch.models.gpt import GPTForCausalLM
        return GPTForCausalLM("debug", dtype=torch.float32)
    if name == "bloom":
        import dataclasses
        import types
        from deepspeed_tpu_torch.checkpoint.hf import bloom_config_from_hf
        from deepspeed_tpu_torch.models.transformer import CausalLM
        return CausalLM(dataclasses.replace(bloom_config_from_hf(
            types.SimpleNamespace(vocab_size=128, hidden_size=64, n_layer=2,
                                  n_head=4, seq_length=64,
                                  layer_norm_epsilon=1e-5)),
            dtype=torch.float32))
    if name.startswith("simple"):
        from deepspeed_tpu_torch.models.base import SimpleModel
        return SimpleModel(int(name[len("simple"):]))
    raise ValueError(name)


def _pieces(engine):
    """path -> this rank's master piece and optimizer state pieces."""
    out = {}
    state = engine.optimizer.state if engine.optimizer is not None else {}
    for path, m in zip(engine.param_paths, engine.masters):
        out[f"params/{path}"] = m.detach().clone()
        for k, v in state.get(m, {}).items():
            if isinstance(v, torch.Tensor) and v.dim():
                out[f"{k}/{path}"] = v.detach().clone()
    return out


def train(sc, rank):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.tree import tree_leaves
    params = _nest(_load_npz(sc["params"]))
    batches = _load_npz(sc["batches"])
    model = _model(sc["model"])
    engine, *_ = dtt.initialize(model=model, config=sc["config"],
                                model_parameters=params, device="cpu")
    if sc.get("load"):
        engine.load_checkpoint(sc["load"])
    res = {"losses": [], "grad_norms": [], "applied": [],
           "mesh": dict(zip(("pipe", "data", "expert", "fsdp", "hpz", "seq",
                             "tensor"), engine.topology.shape))}
    poison = sc.get("poison")          # [step, rank]: an inf in one row
    for step in range(sc["steps"]):
        batch = {k: v[step] for k, v in batches.items()}
        if poison and poison[0] == step:
            batch = {k: v.copy() for k, v in batch.items()}
            rows = len(batch["x"]) // engine.topology.batch_shard_size
            batch["x"][poison[1] * rows, 0] = np.inf
        res["losses"].append(engine.train_batch(batch))
        res["grad_norms"].append(engine.get_global_grad_norm())
        res["applied"].append(engine.was_step_applied())
        if getattr(engine, "_residuals", None) is not None:
            res.setdefault("residuals_by_step", []).append(
                engine._residuals.clone())
    res["pieces"] = _pieces(engine)
    if engine._multi:
        # the compute copy a step hands the model (stage 3: the pieces)
        compute = engine._compute_params_ranks()
        res["compute_shapes"] = {
            path: tuple(c.shape) for path, c in zip(
                engine.param_paths, tree_leaves(compute))}
    if engine.comm_scheduler is not None:
        res["stats"] = engine.comm_stats()
        res["profile"] = engine.comm_scheduler.profile_buckets(iters=1)
        res["residuals"] = (None if engine._residuals is None
                            else engine._residuals.clone())
    from deepspeed_tpu_torch.tree import tree_map
    shapes = iter(engine.param_shapes)
    res["describe"] = engine.partitioner.describe(tree_map(
        lambda _: torch.empty(next(shapes), device="meta"), engine.params))
    if sc.get("save"):
        engine.save_checkpoint(sc["save"], tag="ranks")
    res["whole"] = engine.get_fp32_state_dict()
    return res


def wire(sc, rank):
    """The six quantised collectives on this rank's rows of seeded
    inputs (the JAX side runs them in shard_map on the same rows)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import quantization as Q
    from deepspeed_tpu_torch.runtime.sparse_tensor import (SparseTensor,
                                                            sparse_allreduce)
    x = _load_npz(sc["inputs"])
    world = comm.get_world_size()

    def mine(name):
        """This rank's input (the arrays lead with the rank axis)."""
        assert x[name].shape[0] == world, name
        return torch.from_numpy(np.array(x[name][rank]))

    out = {}
    a = mine("scatter")
    q, s, _ = Q.quantize_blockwise(a.float().contiguous())
    out["hop1_codes"] = comm.all_to_all(q, None, 0, 0)
    out["hop1_scales"] = comm.all_to_all(s, None, 0, 0)
    out["psum_scatter"] = Q.quantized_psum_scatter(a)
    out["psum_scatter_straddle"] = Q.quantized_psum_scatter(
        mine("straddle"))
    out["allreduce"] = Q.quantized_allreduce(mine("allreduce"))
    g = mine("grad")
    out["grad_shard"] = Q.quantized_grad_reduce_shard(g, 1, None, ())
    out["grad_replicated"] = Q.quantized_grad_reduce_shard(g, None, None,
                                                           ())
    red, err = Q.quantized_allreduce_ef(mine("bucket"), None, world)
    out["allreduce_ef"], out["allreduce_ef_err"] = red, err
    out["all_gather"] = Q.quantized_all_gather(mine("gather"))
    w = mine("gather").clone().requires_grad_()
    full = Q.quantized_all_gather_st(w)
    (full * torch.from_numpy(x["cotangent"])).sum().backward()
    out["all_gather_st"] = full.detach()
    out["all_gather_st_grad"] = w.grad
    st = SparseTensor(mine("sparse_idx"), mine("sparse_val"),
                      tuple(x["sparse_shape"]))
    red = sparse_allreduce(st)
    out["sparse_indices"], out["sparse_values"] = red.indices, red.values
    return out


#: a permutation in which member 1 sends and receives nothing back and
#: member 3 receives without sending
PERMUTE_PAIRS = [(0, 2), (2, 0), (1, 3)]


#: the facade's collectives over the default group, by the names of
#: tests/test_torch_comm.py's OPS (the JAX side runs those)
def _comm_ops():
    from deepspeed_tpu_torch import comm as c
    return {
        "all_reduce": lambda x: c.all_reduce(x, None, "max"),
        "all_gather": lambda x: c.all_gather(x, None, axis=1, tiled=False),
        "reduce_scatter": lambda x: c.reduce_scatter(x, None),
        "all_to_all": lambda x: c.all_to_all(x, None, 0, 1),
        "permute": lambda x: c.permute(x, None, [(0, 0)]),
        "broadcast": lambda x: c.broadcast(x, None, 0),
        "reduce": lambda x: c.reduce(x, None, 0),
        "gather": lambda x: c.gather(x, None, 0),
        "scatter": lambda x: c.scatter(x, None, 0),
        "inference_all_reduce": lambda x: c.inference_all_reduce(x),
        "all_gather_into_tensor": lambda x: c.all_gather_into_tensor(x),
        "reduce_scatter_tensor": lambda x: c.reduce_scatter_tensor(x),
        "all_to_all_single": lambda x: c.all_to_all_single(x),
        "send_recv_next": lambda x: c.send_recv_next(x, None, 1),
        "send_recv_prev": lambda x: c.send_recv_prev(x, None, 1),
        "ring_next": lambda x: c.send_recv_next(x, None, 4),
        "permute_pairs": lambda x: c.permute(x, None, PERMUTE_PAIRS),
        "broadcast_from_2": lambda x: c.broadcast(x, None, 2),
        "reduce_sum_to_1": lambda x: c.reduce(x, None, 1),
    }


def seq_ops(sc, rank):
    """Ring attention (causal, full, windowed; forward, backward and a
    second call), the Ulysses sandwich around a plain local attention,
    and the vocab-parallel cross-entropy, over the default group on this
    rank's block of seeded inputs."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.tensor_parallel import \
        vocab_parallel_cross_entropy
    from deepspeed_tpu_torch.sequence.layer import DistributedAttention
    from deepspeed_tpu_torch.sequence.ring import ring_attention
    x = _load_npz(sc["inputs"])
    world = comm.get_world_size()

    def block(name, dim=2):
        """This rank's block of ``dim`` (the sequence)."""
        n = x[name].shape[dim] // world
        idx = [slice(None)] * x[name].ndim
        idx[dim] = slice(rank * n, (rank + 1) * n)
        return torch.from_numpy(np.array(x[name][tuple(idx)]))
    out = {}
    for case, causal, window in (("causal", True, None),
                                 ("full", False, None),
                                 ("window", True, int(x["window"]))):
        runs = []
        for _ in range(2):
            q, k, v = (block(n).requires_grad_() for n in "qkv")
            o = ring_attention(q, k, v, None, causal=causal, window=window)
            (o * block("ct")).sum().backward()
            runs.append((o.detach(), q.grad, k.grad, v.grad))
        for name, t in zip(("out", "dq", "dk", "dv"), runs[0]):
            out[f"{case}_{name}"] = t
        out[f"{case}_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(*runs))

    # the convenience entry: whole q, k, v on every rank, the whole
    # output back (seq over every rank)
    from deepspeed_tpu_torch.parallel import MeshTopology, TopologyConfig
    from deepspeed_tpu_torch.sequence.ring import ring_attention_sharded
    topo = MeshTopology(TopologyConfig(data=1, seq=world))
    out["sharded_out"] = ring_attention_sharded(
        *(torch.from_numpy(np.array(x[n])) for n in "qkv"), topo)

    def local(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                          float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    q, k, v = (block(n, 1).requires_grad_() for n in ("uq", "uk", "uv"))
    o = DistributedAttention(local)(q, k, v)
    (o * block("uct", 1)).sum().backward()
    out.update(ulysses_out=o.detach(), ulysses_dq=q.grad, ulysses_dk=k.grad,
               ulysses_dv=v.grad)
    # the vocabulary over the ranks: columns rank*V/world on
    nv = x["logits"].shape[-1] // world
    logits = torch.from_numpy(np.array(
        x["logits"][..., rank * nv:(rank + 1) * nv])).requires_grad_()
    labels = torch.from_numpy(x["labels"])
    valid = (labels >= 0) & torch.from_numpy(x["mask"]).bool()
    import torch.distributed as dist
    nll = vocab_parallel_cross_entropy(logits, labels, valid,
                                       dist.group.WORLD, rank * nv)
    loss = nll.sum() / valid.sum()
    loss.backward()
    out.update(ce_loss=loss.detach(), ce_grad=logits.grad)
    return out


def collectives(sc, rank):
    x = torch.from_numpy(np.array(_load_npz(sc["inputs"])["comm"][rank]))
    return {name: fn(x) for name, fn in _comm_ops().items()}


def main():
    plan = json.load(open(sys.argv[-1]))
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm
    comm.init_distributed(dist_backend="gloo", timeout=plan.get("timeout",
                                                                120))
    rank = comm.get_rank()
    for sc in plan["scenarios"]:
        try:
            res = {"train": train, "wire": wire, "seq_ops": seq_ops,
                   "collectives": collectives}[sc["kind"]](sc, rank)
        except Exception:
            res = {"error": traceback.format_exc()}
            torch.save(res, os.path.join(plan["out"],
                                         f"{sc['name']}.rank{rank}.pt"))
            raise
        torch.save(res, os.path.join(plan["out"],
                                     f"{sc['name']}.rank{rank}.pt"))
    comm.barrier()
    comm.destroy_process_group()


if __name__ == "__main__":
    main()
