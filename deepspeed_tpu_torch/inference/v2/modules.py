"""Op-class registry: which implementation the serving model runs.

Counterpart of ``deepspeed_tpu/inference/v2/modules.py``.  Each op class
maps to named implementations with a priority and a ``supports(cfg,
device)`` predicate; ``instantiate`` returns the highest-priority one
that supports the model, or exactly the one named.  The hand-written
CUDA kernels register at priority 10 and support a bf16 model at
head_dim 128 on a CUDA device; their plain PyTorch versions register at
priority 0 and support every device.  Unnamed, a plain version is taken
only on the CPU: on the card an op class that has a kernel runs it or
``resolve`` raises, and the plain path runs there only when named.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class _Impl:
    name: str
    priority: int
    supports: Callable[[Any, torch.device], bool]
    factory: Callable[[Any], Callable]


_REGISTRY: Dict[str, List[_Impl]] = {}


def register(op_class: str, name: str, priority: int = 0,
             supports: Optional[Callable[[Any, torch.device], bool]] = None):
    """Decorator: register ``factory(cfg) -> callable`` under an op
    class."""
    def deco(factory):
        impls = _REGISTRY.setdefault(op_class, [])
        if any(i.name == name for i in impls):
            raise ValueError(f"duplicate implementation {op_class}/{name}")
        impls.append(_Impl(name, priority,
                           supports or (lambda cfg, dev: True), factory))
        impls.sort(key=lambda i: -i.priority)
        return factory
    return deco


def implementations(op_class: str) -> Tuple[str, ...]:
    return tuple(i.name for i in _REGISTRY.get(op_class, ()))


def resolve(op_class: str, cfg: Any, device: torch.device,
            name: Optional[str] = None) -> str:
    """Name of the implementation ``instantiate`` would pick."""
    impls = _REGISTRY.get(op_class)
    if not impls:
        raise KeyError(f"unknown op class: {op_class!r}")
    if name is not None:
        for i in impls:
            if i.name == name:
                if not i.supports(cfg, device):
                    raise ValueError(f"{op_class}/{name} does not support "
                                     f"this model on {device}")
                return name
        raise KeyError(f"unknown implementation {op_class}/{name}; "
                       f"registered: {implementations(op_class)}")
    for i in impls:
        if i.supports(cfg, device):
            if (device.type != "cpu" and i.priority == 0
                    and impls[0].priority > 0):
                # the op class has a kernel and it does not take this
                # model: never the plain version in its place, unasked
                raise NotImplementedError(
                    f"no {op_class} kernel takes this model on {device} "
                    f"(dtype {cfg.dtype}, head_dim {cfg.dims_per_head}, "
                    f"norm {cfg.norm!r}; the kernels take torch.bfloat16 "
                    f"at head_dim {_head_dim()}), and the plain version "
                    f"{op_class}/{i.name} runs on the card only when "
                    f"named in `implementations` (ROADMAP Queue 1 item "
                    f"11k: kernels in fp32 and at other head dims)")
            return i.name
    raise ValueError(f"no {op_class} implementation supports this model "
                     f"on {device}")


def instantiate(op_class: str, cfg: Any, device: torch.device,
                name: Optional[str] = None) -> Callable:
    chosen = resolve(op_class, cfg, device, name)
    return next(i for i in _REGISTRY[op_class]
                if i.name == chosen).factory(cfg)


# ---------------------------------------------------------------------------
# registered implementations
# ---------------------------------------------------------------------------

def _cuda_bf16(cfg, device) -> bool:
    # the kernels take bf16 activations
    return device.type == "cuda" and cfg.dtype == torch.bfloat16


def _head_dim() -> int:
    from ...ops.paged_attention import HEAD_DIM
    return HEAD_DIM


def _cuda_attention(cfg, device) -> bool:
    return _cuda_bf16(cfg, device) and cfg.dims_per_head == _head_dim()


def _alibi_for(cfg):
    if getattr(cfg, "pos_emb", None) != "alibi":
        return None
    from ...models.transformer import alibi_slopes
    return alibi_slopes(cfg.num_heads)


@register("ragged_attention", "cuda_paged", priority=10,
          supports=_cuda_attention)
def _cuda_paged(cfg):
    """Any-Q ragged paged attention through ``csrc/paged_attention.cu``,
    over fp pages or int8 ``KVPages``."""
    from ...ops.paged_attention import paged_decode_attention
    slopes = _alibi_for(cfg)
    window = cfg.sliding_window

    def attn(q, kv_layer, page_table, start_pos, q_lens):
        return paged_decode_attention(q, kv_layer, page_table, start_pos,
                                      alibi_slopes=slopes, window=window)
    return attn


@register("ragged_attention", "dense_gather", priority=0)
def _dense_gather(cfg):
    """Plain paged attention (gather the pages, dense masked softmax)."""
    from ...ops.paged_attention import paged_attention
    slopes = _alibi_for(cfg)
    window = cfg.sliding_window

    def attn(q, kv_layer, page_table, start_pos, q_lens):
        return paged_attention(q, kv_layer, page_table, start_pos, q_lens,
                               alibi_slopes=slopes, window=window)
    return attn


def _no_alibi(cfg, device) -> bool:
    # the flash kernel has no additive-bias input; ALiBi prefill stays on
    # the paged path
    return cfg.pos_emb != "alibi"


def _fresh(flash):
    def make(cfg):
        window = cfg.sliding_window

        def attn(q, k_rot, v):
            # [S, Q, H, D] -> [S, H, Q, D] views; the kernel reads the
            # strides in place and maps query head h to kv head h // G
            out = flash(q.transpose(1, 2), k_rot.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=window)
            return out.transpose(1, 2)
        return attn
    return make


@register("fresh_prefill_attention", "cuda_flash", priority=10,
          supports=lambda cfg, dev: _no_alibi(cfg, dev)
          and _cuda_attention(cfg, dev))
def _cuda_flash(cfg):
    """Pure-prefill bucket: every slot's context IS its new tokens, so
    attention runs ``csrc/flash_fwd.cu`` over [S, H, Q, D] with causal
    (+ sliding window) block bounds — no page gather."""
    from ...ops.flash_attention import flash_attention
    return _fresh(flash_attention)(cfg)


@register("fresh_prefill_attention", "mha_reference", priority=0,
          supports=_no_alibi)
def _fresh_reference(cfg):
    from ...ops.flash_attention import mha_reference
    return _fresh(mha_reference)(cfg)


# norm implementations share the (params, x) -> y calling convention
@register("norm", "cuda_rmsnorm", priority=10,
          supports=lambda cfg, dev: _cuda_bf16(cfg, dev)
          and cfg.norm == "rmsnorm")
def _cuda_norm(cfg):
    from ...ops.normalization import rmsnorm
    eps = cfg.norm_eps
    return lambda p, x: rmsnorm(x, p["scale"], eps)


@register("norm", "cuda_layernorm", priority=10,
          supports=lambda cfg, dev: _cuda_bf16(cfg, dev)
          and cfg.norm == "layernorm")
def _cuda_layernorm(cfg):
    from ...ops.normalization import layernorm
    eps = cfg.norm_eps
    return lambda p, x: layernorm(x, p["scale"], p["bias"], eps)


@register("norm", "plain", priority=0)
def _plain_norm(cfg):
    from ...models import transformer as T
    return lambda p, x: T._norm_apply(cfg, p, x)


@register("embedding", "ragged_embedding", priority=0)
def _embedding(cfg):
    def embed(table, token_ids):
        return table[token_ids]
    return embed


@register("unembed", "last_token_gather", priority=0)
def _unembed(cfg):
    from ...ops.paged_attention import gather_last

    def unembed(x, q_lens, lm_head):
        return gather_last(x, q_lens) @ lm_head
    return unembed
