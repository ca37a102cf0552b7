"""Hugging Face checkpoint import: HF configs and state dicts -> the
port's ``TransformerConfig`` and param tree (counterpart of
``deepspeed_tpu/checkpoint/hf.py``).

Every family the JAX package loads is here: Llama/Mistral, Qwen2,
GPT-NeoX, GPT-2, Falcon (multi-query and the new decoder architecture),
OPT, Phi-1/1.5/2, Phi-3, BLOOM and GPT-J, each a ``*_config_from_hf``
and a ``load_*``.  The config translations read attributes off any
object (a ``transformers`` config, or a ``types.SimpleNamespace``
holding a published ``config.json``'s values).  A loader takes a state
dict (torch tensors or numpy arrays, HF names), re-lays each leaf with
numpy exactly as the JAX loader does, rounds every leaf through
``dtype`` as the JAX loader's cast does, and hands the tree to the
weight bridge (``checkpoint/from_jax.py``: every leaf checked against
the config, norms and biases kept in fp32).  :func:`from_pretrained`
dispatches on ``model_type`` through ``module_inject/policies.py`` and
imports ``transformers`` only for a local checkpoint path.  Mixtral's
loader stacks each layer's experts into the MoE layer's ``[X, in, out]``
leaves (``moe/layer.py``).

RoPE convention: the port rotates interleaved pairs.  HF checkpoints
store q/k rows permuted for the half-split ("rotate_half") convention,
so the loaders apply the inverse permutation to those rows (partial
rotary: the leading rotary lanes of each head only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import DeviceLike
from ..models.transformer import TransformerConfig
from .from_jax import from_jax

Tree = Dict[str, Any]

#: published ``config.json`` fields, as the ``*_config_from_hf`` read
#: them: ``falcon_config_from_hf(types.SimpleNamespace(**fields))``
#: builds the model with no download.  tiiuae/falcon-7b ships no
#: ffn_hidden_size (so 4 * hidden) and no max_position_embeddings (so
#: 2048); its activation is gelu.
PUBLISHED_CONFIGS = {
    "tiiuae/falcon-7b": dict(
        vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
        num_attention_heads=71, multi_query=True,
        new_decoder_architecture=False, parallel_attn=True, bias=False,
        alibi=False, layer_norm_epsilon=1e-5),
    "microsoft/phi-2": dict(
        vocab_size=51200, hidden_size=2560, intermediate_size=10240,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, max_position_embeddings=2048,
        partial_rotary_factor=0.4, hidden_act="gelu_new",
        layer_norm_eps=1e-5, rope_theta=10000.0, qk_layernorm=False,
        tie_word_embeddings=False),
    "microsoft/Phi-3-mini-4k-instruct": dict(
        vocab_size=32064, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, max_position_embeddings=4096,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=2047,
        rope_scaling=None, tie_word_embeddings=False, hidden_act="silu"),
    "mistralai/Mixtral-8x7B-v0.1": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=1e6, sliding_window=None,
        num_local_experts=8, num_experts_per_tok=2,
        tie_word_embeddings=False, hidden_act="silu"),
}


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    try:  # torch tensor
        return t.detach().to("cpu").float().numpy()
    except AttributeError:
        return np.asarray(t)


def _unpermute_rope(w: np.ndarray, n_heads: int, head_dim: int,
                    rot_dim: Optional[int] = None) -> np.ndarray:
    """Convert [H*D, E] projection rows (or [H*D] bias with E absent)
    from half-split ("rotate_half") lane order to interleaved-pair order.
    With ``rot_dim < head_dim`` (partial rotary) only the leading rotary
    lanes of each head are reordered."""
    squeeze = w.ndim == 1
    if squeeze:
        w = w[:, None]
    E = w.shape[1]
    rot = head_dim if rot_dim is None else rot_dim
    w = w.reshape(n_heads, head_dim, E)
    head = w[:, :rot].reshape(n_heads, 2, rot // 2, E)
    head = np.transpose(head, (0, 2, 1, 3)).reshape(n_heads, rot, E)
    w = np.concatenate([head, w[:, rot:]], axis=1)
    w = w.reshape(n_heads * head_dim, E)
    return w[:, 0] if squeeze else w


def _map_hf_act(name: str) -> str:
    """HF activation name -> core activation.  HF's "gelu" is exact erf;
    the tanh approximation goes by gelu_new/gelu_fast/gelu_pytorch_tanh."""
    table = {"gelu": "gelu_exact", "gelu_new": "gelu", "gelu_fast": "gelu",
             "gelu_pytorch_tanh": "gelu", "relu": "relu"}
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unsupported HF activation {name!r} "
                         f"(supported: {sorted(table)})") from None


def _rot_dims(head_dim: int, pct: float) -> int:
    """Even rotary lane count, as ``rope_table`` rounds it."""
    rot = int(head_dim * pct)
    return rot - rot % 2


def _stack(layers: List[Tree]) -> Tree:
    """Per-layer trees -> one tree whose leaves carry a leading L dim."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([l[k] for l in layers]) for k in first}
    return np.stack(layers)


def _layers(cfg: TransformerConfig, layers: List[Tree]) -> Tree:
    return (_stack(layers) if cfg.scan_layers
            else {f"layer_{i}": l for i, l in enumerate(layers)})


def _merge_layer_params(params: Tree, cfg: TransformerConfig, block: str,
                        per_layer: List[Tree]) -> None:
    """Add new leaves into each layer's ``block`` dict (scan-stacked or
    per-layer)."""
    if cfg.scan_layers:
        params["layers"][block].update(_stack(per_layer))
    else:
        for i, extra in enumerate(per_layer):
            params["layers"][f"layer_{i}"][block].update(extra)


def _rounded(tree, dtype: torch.dtype):
    """Every leaf rounded through ``dtype`` (the JAX loader's cast), kept
    as fp32 numpy for the bridge."""
    if isinstance(tree, dict):
        return {k: _rounded(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree, dtype=np.float32))
    return t.to(dtype).float().numpy()


def _to_port(tree: Tree, cfg: TransformerConfig, dtype: torch.dtype,
             device: DeviceLike) -> Tree:
    return from_jax(_rounded(tree, dtype), cfg, device=device, dtype=dtype)


def _key(sd: Dict[str, np.ndarray], *names: str) -> np.ndarray:
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(f"none of {names} in checkpoint (have e.g. "
                   f"{list(sd)[:5]})")


# ---------------------------------------------------------------------------
# Llama / Mistral, Qwen2, Mixtral
# ---------------------------------------------------------------------------

def llama_config_from_hf(hf_cfg) -> TransformerConfig:
    """Llama and Mistral: RMSNorm, SwiGLU, RoPE, grouped KV heads, no
    biases.  ``sliding_window`` (Mistral) applies unless
    ``use_sliding_window`` is false (Qwen2 ships a window it does not
    use); every layer shares the one window."""
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads",
                             hf_cfg.num_attention_heads),
        max_seq_len=getattr(hf_cfg, "max_position_embeddings", 4096),
        norm="rmsnorm", norm_eps=hf_cfg.rms_norm_eps,
        activation="silu_gated", pos_emb="rope",
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        sliding_window=(getattr(hf_cfg, "sliding_window", None)
                        if getattr(hf_cfg, "use_sliding_window", True)
                        else None),
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        use_bias=False, dtype=torch.bfloat16)


def _llama_tree(sd: Dict[str, np.ndarray], cfg: TransformerConfig,
                skip_mlp: bool = False) -> Tree:
    """``skip_mlp``: leave the mlp block out (Mixtral fills it with its
    experts)."""
    E = cfg.hidden_size
    H, K, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        wq = _unpermute_rope(_key(sd, p + "self_attn.q_proj.weight"), H, D)
        wk = _unpermute_rope(_key(sd, p + "self_attn.k_proj.weight"), K, D)
        layer = {
            "attn": {
                "wq": wq.T.reshape(E, H, D),
                "wk": wk.T.reshape(E, K, D),
                "wv": _key(sd, p + "self_attn.v_proj.weight").T.reshape(
                    E, K, D),
                "wo": _key(sd, p + "self_attn.o_proj.weight").T.reshape(
                    H, D, E),
            },
            "norm1": {"scale": _key(sd, p + "input_layernorm.weight")},
            "norm2": {"scale": _key(sd, p + "post_attention_layernorm.weight")},
        }
        if not skip_mlp:
            layer["mlp"] = {
                "wg": _key(sd, p + "mlp.gate_proj.weight").T,
                "wi": _key(sd, p + "mlp.up_proj.weight").T,
                "wo": _key(sd, p + "mlp.down_proj.weight").T,
            }
        layers.append(layer)
    params = {
        "embed": {"tokens": _key(sd, "model.embed_tokens.weight")},
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": _key(sd, "model.norm.weight")},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _key(sd, "lm_head.weight").T
    return params


def load_llama(state_dict: Dict[str, Any], cfg: TransformerConfig,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Tree:
    """HF LLaMA/Mistral state dict -> the port's param tree."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    return _to_port(_llama_tree(sd, cfg), cfg, dtype, device)


def qwen2_config_from_hf(hf_cfg) -> TransformerConfig:
    """Qwen2/Qwen2.5: llama-family geometry + attention-only qkv biases."""
    return dataclasses.replace(llama_config_from_hf(hf_cfg), qkv_bias=True)


def load_qwen2(state_dict: Dict[str, Any], cfg: TransformerConfig,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Tree:
    """HF Qwen2 state dict -> param tree: llama layout + q/k/v biases
    (bias rows take the same rope unpermute as the weight rows)."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params = _llama_tree(sd, cfg)
    H, K, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    biases = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}.self_attn."
        biases.append({
            "bq": _unpermute_rope(sd[p + "q_proj.bias"], H, D).reshape(H, D),
            "bk": _unpermute_rope(sd[p + "k_proj.bias"], K, D).reshape(K, D),
            "bv": sd[p + "v_proj.bias"].reshape(K, D),
        })
    _merge_layer_params(params, cfg, "attn", biases)
    return _to_port(params, cfg, dtype, device)


def mixtral_config_from_hf(hf_cfg) -> TransformerConfig:
    """Llama geometry plus the experts: ``num_local_experts`` and
    ``num_experts_per_tok``."""
    return dataclasses.replace(
        llama_config_from_hf(hf_cfg),
        moe_num_experts=hf_cfg.num_local_experts,
        moe_top_k=hf_cfg.num_experts_per_tok)


def load_mixtral(state_dict: Dict[str, Any], cfg: TransformerConfig,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> Tree:
    """HF Mixtral state dict -> param tree with the stacked-expert MoE
    mlp (reference ``model_implementations/mixtral/model.py``): HF's
    ``w1`` (gate), ``w3`` (up) and ``w2`` (down) of each expert
    transposed into the ``[X, in, out]`` leaves ``wg``, ``wi``, ``wo``;
    the router ``gate.weight`` [X, E] into ``gate`` [E, X]."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params = _llama_tree(sd, cfg, skip_mlp=True)
    n_experts = 0
    while f"model.layers.0.block_sparse_moe.experts.{n_experts}.w1.weight" \
            in sd:
        n_experts += 1
    if n_experts == 0:
        raise KeyError("no block_sparse_moe experts in checkpoint")
    moe_layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}.block_sparse_moe."

        def experts(w, _p=p):
            return np.stack([sd[_p + f"experts.{e}.{w}.weight"].T
                             for e in range(n_experts)])
        moe_layers.append({"gate": sd[p + "gate.weight"].T,
                           "wg": experts("w1"), "wi": experts("w3"),
                           "wo": experts("w2")})
    if cfg.scan_layers:
        params["layers"]["mlp"] = _stack(moe_layers)
    else:
        for i, mlp in enumerate(moe_layers):
            params["layers"][f"layer_{i}"]["mlp"] = mlp
    return _to_port(params, cfg, dtype, device)


# ---------------------------------------------------------------------------
# GPT-NeoX, GPT-2, Falcon, OPT
# ---------------------------------------------------------------------------

def gpt_neox_config_from_hf(hf_cfg) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_attention_heads,
        max_seq_len=hf_cfg.max_position_embeddings,
        norm="layernorm", norm_eps=hf_cfg.layer_norm_eps,
        activation=_map_hf_act(getattr(hf_cfg, "hidden_act", "gelu")),
        pos_emb="rope",
        rope_theta=getattr(hf_cfg, "rotary_emb_base", 10000.0),
        rope_pct=getattr(hf_cfg, "rotary_pct", 1.0),
        parallel_residual=getattr(hf_cfg, "use_parallel_residual", True),
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        use_bias=True, dtype=torch.bfloat16)


def load_gpt_neox(state_dict: Dict[str, Any], cfg: TransformerConfig,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None) -> Tree:
    """HF GPT-NeoX state dict -> param tree.  query_key_value packs
    [H, 3, D] along the output dim; NeoX rotates half-split natively, so
    q/k rows are re-laned to interleaved (only the ``rotary_pct`` leading
    lanes rotate)."""
    sd = {k.removeprefix("gpt_neox."): _np(v)
          for k, v in state_dict.items()}
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.dims_per_head
    rot = _rot_dims(D, cfg.rope_pct)
    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        w = sd[p + "attention.query_key_value.weight"].reshape(H, 3, D, E)
        b = sd[p + "attention.query_key_value.bias"].reshape(H, 3, D)
        wq = _unpermute_rope(w[:, 0].reshape(H * D, E), H, D, rot)
        wk = _unpermute_rope(w[:, 1].reshape(H * D, E), H, D, rot)
        bq = _unpermute_rope(b[:, 0].reshape(H * D), H, D, rot)
        bk = _unpermute_rope(b[:, 1].reshape(H * D), H, D, rot)
        layers.append({
            "attn": {
                "wq": wq.T.reshape(E, H, D),
                "wk": wk.T.reshape(E, H, D),
                "wv": w[:, 2].reshape(H * D, E).T.reshape(E, H, D),
                "wo": sd[p + "attention.dense.weight"].T.reshape(H, D, E),
                "bq": bq.reshape(H, D), "bk": bk.reshape(H, D),
                "bv": b[:, 2].reshape(H, D),
                "bo": sd[p + "attention.dense.bias"],
            },
            "mlp": {
                "wi": sd[p + "mlp.dense_h_to_4h.weight"].T,
                "bi": sd[p + "mlp.dense_h_to_4h.bias"],
                "wo": sd[p + "mlp.dense_4h_to_h.weight"].T,
                "bo": sd[p + "mlp.dense_4h_to_h.bias"],
            },
            "norm1": {"scale": sd[p + "input_layernorm.weight"],
                      "bias": sd[p + "input_layernorm.bias"]},
            "norm2": {"scale": sd[p + "post_attention_layernorm.weight"],
                      "bias": sd[p + "post_attention_layernorm.bias"]},
        })
    params = {
        "embed": {"tokens": sd["embed_in.weight"]},
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": sd["final_layer_norm.weight"],
                       "bias": sd["final_layer_norm.bias"]},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sd["embed_out.weight"].T
    return _to_port(params, cfg, dtype, device)


def gpt2_config_from_hf(hf_cfg) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.n_embd,
        intermediate_size=4 * hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer,
        num_heads=hf_cfg.n_head,
        num_kv_heads=hf_cfg.n_head,
        max_seq_len=hf_cfg.n_positions,
        norm="layernorm", norm_eps=hf_cfg.layer_norm_epsilon,
        activation="gelu", pos_emb="learned",
        tie_embeddings=True, use_bias=True, dtype=torch.bfloat16)


def load_gpt2(state_dict: Dict[str, Any], cfg: TransformerConfig,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = None) -> Tree:
    """HF GPT-2 state dict -> param tree.  GPT-2's Conv1D stores weights
    [in, out] (already the port's orientation)."""
    sd = {k.removeprefix("transformer."): _np(v)
          for k, v in state_dict.items()}
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.dims_per_head
    layers = []
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        wq, wk, wv = np.split(sd[p + "attn.c_attn.weight"], 3, axis=1)
        bq, bk, bv = np.split(sd[p + "attn.c_attn.bias"], 3)
        layers.append({
            "attn": {
                "wq": wq.reshape(E, H, D), "wk": wk.reshape(E, H, D),
                "wv": wv.reshape(E, H, D),
                "wo": sd[p + "attn.c_proj.weight"].reshape(H, D, E),
                "bq": bq.reshape(H, D), "bk": bk.reshape(H, D),
                "bv": bv.reshape(H, D),
                "bo": sd[p + "attn.c_proj.bias"],
            },
            "mlp": {
                "wi": sd[p + "mlp.c_fc.weight"],
                "bi": sd[p + "mlp.c_fc.bias"],
                "wo": sd[p + "mlp.c_proj.weight"],
                "bo": sd[p + "mlp.c_proj.bias"],
            },
            "norm1": {"scale": sd[p + "ln_1.weight"],
                      "bias": sd[p + "ln_1.bias"]},
            "norm2": {"scale": sd[p + "ln_2.weight"],
                      "bias": sd[p + "ln_2.bias"]},
        })
    params = {
        "embed": {"tokens": sd["wte.weight"], "positions": sd["wpe.weight"]},
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }
    return _to_port(params, cfg, dtype, device)


def falcon_config_from_hf(hf_cfg) -> TransformerConfig:
    """Falcon family.  falcon-7b: MQA + parallel attn/mlp sharing ONE
    input layernorm; falcon-40b/falcon2: GQA "new decoder architecture"
    with ln_attn + ln_mlp (or one shared ln when num_ln_in_parallel_attn
    == 1), expressed exactly by duplicating the ln weights into
    norm1/norm2 of the parallel-residual core."""
    if getattr(hf_cfg, "alibi", False):
        raise ValueError("falcon alibi position encoding not supported "
                         "(rope falcons only)")
    if getattr(hf_cfg, "bias", False):
        raise ValueError("falcon with linear biases not supported")
    H = hf_cfg.num_attention_heads
    if hf_cfg.new_decoder_architecture:
        K = hf_cfg.num_kv_heads
    elif getattr(hf_cfg, "multi_query", True):
        K = 1
    else:
        K = H
    parallel = (hf_cfg.new_decoder_architecture
                or getattr(hf_cfg, "parallel_attn", True))
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=getattr(hf_cfg, "ffn_hidden_size",
                                  4 * hf_cfg.hidden_size),
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=H, num_kv_heads=K,
        max_seq_len=getattr(hf_cfg, "max_position_embeddings", 2048),
        norm="layernorm", norm_eps=hf_cfg.layer_norm_epsilon,
        activation=_map_hf_act(getattr(hf_cfg, "activation", "gelu")),
        pos_emb="rope",
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        parallel_residual=parallel,
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        use_bias=False, dtype=torch.bfloat16)


def load_falcon(state_dict: Dict[str, Any], cfg: TransformerConfig,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Tree:
    """HF Falcon state dict -> param tree.  ``query_key_value`` packs
    [H/K q-heads, k, v] per kv-head group, which covers every variant
    (K=1: the multi_query [H q, k, v] packing; K=H: the per-head [q, k,
    v] interleave), so (H, K) from the config determine the split.
    Falcon rotates half-split natively, so q/k rows are re-laned."""
    sd = {k.removeprefix("transformer."): _np(v)
          for k, v in state_dict.items()}
    E, H, K, D = (cfg.hidden_size, cfg.num_heads, cfg.kv_heads,
                  cfg.dims_per_head)
    g = H // K
    layers = []
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        w = sd[p + "self_attention.query_key_value.weight"].reshape(
            K, g + 2, D, E)
        wq = _unpermute_rope(w[:, :g].reshape(H * D, E), H, D)
        wk = _unpermute_rope(w[:, g].reshape(K * D, E), K, D)
        wv = w[:, g + 1].reshape(K * D, E)
        if not cfg.parallel_residual:
            n1 = {"scale": sd[p + "input_layernorm.weight"],
                  "bias": sd[p + "input_layernorm.bias"]}
            n2 = {"scale": sd[p + "post_attention_layernorm.weight"],
                  "bias": sd[p + "post_attention_layernorm.bias"]}
        elif p + "ln_attn.weight" in sd:
            n1 = {"scale": sd[p + "ln_attn.weight"],
                  "bias": sd[p + "ln_attn.bias"]}
            n2 = {"scale": sd[p + "ln_mlp.weight"],
                  "bias": sd[p + "ln_mlp.bias"]}
        else:  # ONE shared input_layernorm feeds both branches
            n1 = {"scale": sd[p + "input_layernorm.weight"],
                  "bias": sd[p + "input_layernorm.bias"]}
            n2 = dict(n1)
        layers.append({
            "attn": {
                "wq": wq.T.reshape(E, H, D),
                "wk": wk.T.reshape(E, K, D),
                "wv": wv.T.reshape(E, K, D),
                "wo": sd[p + "self_attention.dense.weight"].T.reshape(
                    H, D, E),
            },
            "mlp": {
                "wi": sd[p + "mlp.dense_h_to_4h.weight"].T,
                "wo": sd[p + "mlp.dense_4h_to_h.weight"].T,
            },
            "norm1": n1, "norm2": n2,
        })
    params = {
        "embed": {"tokens": sd["word_embeddings.weight"]},
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T
    return _to_port(params, cfg, dtype, device)


def opt_config_from_hf(hf_cfg) -> TransformerConfig:
    """OPT: learned positions (the HF +2 offset is folded into the table
    when weights are loaded), pre-LN decoder, relu MLP, biases
    everywhere."""
    if getattr(hf_cfg, "word_embed_proj_dim",
               hf_cfg.hidden_size) != hf_cfg.hidden_size:
        raise ValueError("OPT word_embed_proj_dim != hidden_size "
                         "(opt-350m style projections) not supported")
    if not getattr(hf_cfg, "do_layer_norm_before", True):
        raise ValueError("OPT post-layernorm variants not supported")
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.ffn_dim,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_attention_heads,
        max_seq_len=hf_cfg.max_position_embeddings,
        norm="layernorm", norm_eps=1e-5,
        activation=_map_hf_act(hf_cfg.activation_function),
        pos_emb="learned",
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", True),
        use_bias=True, dtype=torch.bfloat16)


def load_opt(state_dict: Dict[str, Any], cfg: TransformerConfig,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Tree:
    """HF OPT state dict -> param tree.  ``embed_positions`` carries the
    HF offset of 2; dropping its first two rows makes position i index
    row i + 2, as HF does for unpadded sequences."""
    sd = {k.removeprefix("model.decoder."): _np(v)
          for k, v in state_dict.items()}
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.dims_per_head
    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        a = p + "self_attn."
        layers.append({
            "attn": {
                "wq": sd[a + "q_proj.weight"].T.reshape(E, H, D),
                "wk": sd[a + "k_proj.weight"].T.reshape(E, H, D),
                "wv": sd[a + "v_proj.weight"].T.reshape(E, H, D),
                "wo": sd[a + "out_proj.weight"].T.reshape(H, D, E),
                "bq": sd[a + "q_proj.bias"].reshape(H, D),
                "bk": sd[a + "k_proj.bias"].reshape(H, D),
                "bv": sd[a + "v_proj.bias"].reshape(H, D),
                "bo": sd[a + "out_proj.bias"],
            },
            "mlp": {
                "wi": sd[p + "fc1.weight"].T, "bi": sd[p + "fc1.bias"],
                "wo": sd[p + "fc2.weight"].T, "bo": sd[p + "fc2.bias"],
            },
            "norm1": {"scale": sd[p + "self_attn_layer_norm.weight"],
                      "bias": sd[p + "self_attn_layer_norm.bias"]},
            "norm2": {"scale": sd[p + "final_layer_norm.weight"],
                      "bias": sd[p + "final_layer_norm.bias"]},
        })
    params = {
        "embed": {"tokens": sd["embed_tokens.weight"],
                  "positions": sd["embed_positions.weight"][2:]},
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": sd["final_layer_norm.weight"],
                       "bias": sd["final_layer_norm.bias"]},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T
    return _to_port(params, cfg, dtype, device)


# ---------------------------------------------------------------------------
# Phi, Phi-3, BLOOM, GPT-J
# ---------------------------------------------------------------------------

def phi_config_from_hf(hf_cfg) -> TransformerConfig:
    """Phi-1/1.5/2: parallel attn+mlp off ONE input layernorm, partial
    rotary, biases everywhere including the lm_head."""
    if getattr(hf_cfg, "qk_layernorm", False):
        raise ValueError("phi qk_layernorm not supported")
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads",
                             hf_cfg.num_attention_heads)
        or hf_cfg.num_attention_heads,
        max_seq_len=hf_cfg.max_position_embeddings,
        norm="layernorm", norm_eps=hf_cfg.layer_norm_eps,
        activation=_map_hf_act(getattr(hf_cfg, "hidden_act", "gelu_new")),
        pos_emb="rope",
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        rope_pct=getattr(hf_cfg, "partial_rotary_factor", 1.0),
        parallel_residual=True,
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        use_bias=True, dtype=torch.bfloat16)


def load_phi(state_dict: Dict[str, Any], cfg: TransformerConfig,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Tree:
    """HF Phi state dict -> param tree.  The single input_layernorm goes
    to norm1 and norm2 (both parallel branches read the same normed
    input); the partial-rotary q/k lanes are re-laned."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    E, H, K, D = (cfg.hidden_size, cfg.num_heads, cfg.kv_heads,
                  cfg.dims_per_head)
    rot = _rot_dims(D, cfg.rope_pct)
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        wq = _unpermute_rope(sd[a + "q_proj.weight"], H, D, rot)
        wk = _unpermute_rope(sd[a + "k_proj.weight"], K, D, rot)
        bq = _unpermute_rope(sd[a + "q_proj.bias"], H, D, rot)
        bk = _unpermute_rope(sd[a + "k_proj.bias"], K, D, rot)
        ln = {"scale": sd[p + "input_layernorm.weight"],
              "bias": sd[p + "input_layernorm.bias"]}
        layers.append({
            "attn": {
                "wq": wq.T.reshape(E, H, D),
                "wk": wk.T.reshape(E, K, D),
                "wv": sd[a + "v_proj.weight"].T.reshape(E, K, D),
                "wo": sd[a + "dense.weight"].T.reshape(H, D, E),
                "bq": bq.reshape(H, D), "bk": bk.reshape(K, D),
                "bv": sd[a + "v_proj.bias"].reshape(K, D),
                "bo": sd[a + "dense.bias"],
            },
            "mlp": {
                "wi": sd[p + "mlp.fc1.weight"].T,
                "bi": sd[p + "mlp.fc1.bias"],
                "wo": sd[p + "mlp.fc2.weight"].T,
                "bo": sd[p + "mlp.fc2.bias"],
            },
            "norm1": ln, "norm2": dict(ln),
        })
    params = {
        "embed": {"tokens": sd["model.embed_tokens.weight"]},
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": sd["model.final_layernorm.weight"],
                       "bias": sd["model.final_layernorm.bias"]},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T
        if "lm_head.bias" in sd:
            params["lm_head_bias"] = sd["lm_head.bias"]
    return _to_port(params, cfg, dtype, device)


def phi3_config_from_hf(hf_cfg) -> TransformerConfig:
    """Phi-3: llama-shaped (rmsnorm + SwiGLU + full rope; fused qkv and
    gate_up projections in the checkpoint).  Phi-3-mini-4k's
    ``sliding_window`` (2047) applies to every layer."""
    if getattr(hf_cfg, "rope_scaling", None):
        raise ValueError("phi3 longrope scaling not supported")
    return llama_config_from_hf(hf_cfg)


def load_phi3(state_dict: Dict[str, Any], cfg: TransformerConfig,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = None) -> Tree:
    """HF Phi-3 state dict -> param tree: the fused qkv_proj and
    gate_up_proj rows split into the llama layout."""
    H, K, D = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    F = cfg.intermediate_size
    sd = {}
    for k, v in state_dict.items():
        v = _np(v)
        if k.endswith("self_attn.qkv_proj.weight"):
            base = k.removesuffix("qkv_proj.weight")
            sd[base + "q_proj.weight"] = v[:H * D]
            sd[base + "k_proj.weight"] = v[H * D:H * D + K * D]
            sd[base + "v_proj.weight"] = v[H * D + K * D:]
        elif k.endswith("mlp.gate_up_proj.weight"):
            base = k.removesuffix("gate_up_proj.weight")
            sd[base + "gate_proj.weight"] = v[:F]
            sd[base + "up_proj.weight"] = v[F:]
        else:
            sd[k] = v
    return _to_port(_llama_tree(sd, cfg), cfg, dtype, device)


def bloom_config_from_hf(hf_cfg) -> TransformerConfig:
    """BLOOM: ALiBi positions, post-embedding layernorm, per-head
    interleaved fused QKV, biases everywhere, tied embeddings."""
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=4 * hf_cfg.hidden_size,
        num_layers=hf_cfg.n_layer,
        num_heads=hf_cfg.n_head, num_kv_heads=hf_cfg.n_head,
        max_seq_len=getattr(hf_cfg, "seq_length", 2048),
        norm="layernorm", norm_eps=hf_cfg.layer_norm_epsilon,
        activation="gelu", pos_emb="alibi", embed_layernorm=True,
        tie_embeddings=True, use_bias=True, dtype=torch.bfloat16)


def load_bloom(state_dict: Dict[str, Any], cfg: TransformerConfig,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Tree:
    """HF BLOOM state dict -> param tree.  ``query_key_value`` packs [q,
    k, v] per head along the output dim (ALiBi: no rope re-laning)."""
    sd = {k.removeprefix("transformer."): _np(v)
          for k, v in state_dict.items()}
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.dims_per_head
    layers = []
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        w = sd[p + "self_attention.query_key_value.weight"].reshape(
            H, 3, D, E)
        b = sd[p + "self_attention.query_key_value.bias"].reshape(H, 3, D)
        layers.append({
            "attn": {
                "wq": w[:, 0].reshape(H * D, E).T.reshape(E, H, D),
                "wk": w[:, 1].reshape(H * D, E).T.reshape(E, H, D),
                "wv": w[:, 2].reshape(H * D, E).T.reshape(E, H, D),
                "wo": sd[p + "self_attention.dense.weight"].T.reshape(
                    H, D, E),
                "bq": b[:, 0], "bk": b[:, 1], "bv": b[:, 2],
                "bo": sd[p + "self_attention.dense.bias"],
            },
            "mlp": {
                "wi": sd[p + "mlp.dense_h_to_4h.weight"].T,
                "bi": sd[p + "mlp.dense_h_to_4h.bias"],
                "wo": sd[p + "mlp.dense_4h_to_h.weight"].T,
                "bo": sd[p + "mlp.dense_4h_to_h.bias"],
            },
            "norm1": {"scale": sd[p + "input_layernorm.weight"],
                      "bias": sd[p + "input_layernorm.bias"]},
            "norm2": {"scale": sd[p + "post_attention_layernorm.weight"],
                      "bias": sd[p + "post_attention_layernorm.bias"]},
        })
    params = {
        "embed": {
            "tokens": sd["word_embeddings.weight"],
            "norm": {"scale": sd["word_embeddings_layernorm.weight"],
                     "bias": sd["word_embeddings_layernorm.bias"]},
        },
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }
    return _to_port(params, cfg, dtype, device)


def gptj_config_from_hf(hf_cfg) -> TransformerConfig:
    """GPT-J: parallel attn+mlp off ONE ln, partial interleaved rotary
    (the port's convention: no re-laning), bias-free attention but biased
    MLP and lm_head.  Its head_dim 256 is outside the attention kernels'
    widths: on the card it serves only through the plain versions, named
    (ROADMAP Queue 1 item 11k)."""
    D = hf_cfg.n_embd // hf_cfg.n_head
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.n_embd,
        intermediate_size=getattr(hf_cfg, "n_inner", None)
        or 4 * hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer,
        num_heads=hf_cfg.n_head, num_kv_heads=hf_cfg.n_head,
        max_seq_len=hf_cfg.n_positions,
        norm="layernorm", norm_eps=hf_cfg.layer_norm_epsilon,
        activation=_map_hf_act(getattr(hf_cfg, "activation_function",
                                       "gelu_new")),
        pos_emb="rope",
        rope_pct=(hf_cfg.rotary_dim or D) / D,
        parallel_residual=True,
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        use_bias=True, dtype=torch.bfloat16)


def load_gptj(state_dict: Dict[str, Any], cfg: TransformerConfig,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = None) -> Tree:
    """HF GPT-J state dict -> param tree.  GPT-J rotates interleaved
    pairs natively.  Its attention projections carry no biases; the
    core's use_bias (needed for the MLP and lm_head biases) gets exact
    zero attention biases."""
    sd = {k.removeprefix("transformer."): _np(v)
          for k, v in state_dict.items()}
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.dims_per_head
    layers = []
    for i in range(cfg.num_layers):
        p = f"h.{i}."
        ln = {"scale": sd[p + "ln_1.weight"], "bias": sd[p + "ln_1.bias"]}
        layers.append({
            "attn": {
                "wq": sd[p + "attn.q_proj.weight"].T.reshape(E, H, D),
                "wk": sd[p + "attn.k_proj.weight"].T.reshape(E, H, D),
                "wv": sd[p + "attn.v_proj.weight"].T.reshape(E, H, D),
                "wo": sd[p + "attn.out_proj.weight"].T.reshape(H, D, E),
                "bq": np.zeros((H, D), np.float32),
                "bk": np.zeros((H, D), np.float32),
                "bv": np.zeros((H, D), np.float32),
                "bo": np.zeros((E,), np.float32),
            },
            "mlp": {
                "wi": sd[p + "mlp.fc_in.weight"].T,
                "bi": sd[p + "mlp.fc_in.bias"],
                "wo": sd[p + "mlp.fc_out.weight"].T,
                "bo": sd[p + "mlp.fc_out.bias"],
            },
            "norm1": ln, "norm2": dict(ln),
        })
    params = {
        "embed": {"tokens": sd["wte.weight"]},
        "layers": _layers(cfg, layers),
        "final_norm": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sd["lm_head.weight"].T
        if "lm_head.bias" in sd:
            params["lm_head_bias"] = sd["lm_head.bias"]
    return _to_port(params, cfg, dtype, device)


# ---------------------------------------------------------------------------
# models and checkpoint directories
# ---------------------------------------------------------------------------

def load_hf_model(model_or_path):
    """A ``transformers`` model instance as it is, or a local checkpoint
    directory loaded with ``transformers`` (imported here only: the port
    does not need the package otherwise)."""
    if not isinstance(model_or_path, str):
        return model_or_path
    try:
        import transformers
    except ImportError:
        raise ImportError(
            f"loading the checkpoint directory {model_or_path!r} needs the "
            f"`transformers` package, which is not installed; pass a model "
            f"instance, or build the config with *_config_from_hf and the "
            f"weights with load_* from a state dict") from None
    return transformers.AutoModelForCausalLM.from_pretrained(
        model_or_path, local_files_only=True)


def from_pretrained(model_or_path, dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None
                    ) -> Tuple[TransformerConfig, Tree]:
    """(config, param tree) of a ``transformers`` model instance or a
    local checkpoint directory.  ``module_inject/policies.py`` maps its
    ``model_type`` to (config converter, weight loader), and raises
    ValueError naming the supported set for an unknown architecture."""
    model = load_hf_model(model_or_path)
    from ..module_inject.policies import replace_policy_for
    pol = replace_policy_for(model.config.model_type)
    cfg = pol.config_from_hf(model.config)
    return cfg, pol.load(model.state_dict(), cfg, dtype, device)
