"""Ragged inference model over the shared transformer blocks.

Counterpart of ``deepspeed_tpu/inference/v2/model.py``.  The JAX package
compiles one program per batch bucket ``(S, Q, P)`` and donates the KV
cache to it; here each step runs eagerly and writes the KV cache IN
PLACE (``write_kv``'s indexed assignment into the cache tensor), so the
step methods return only tokens or logits.  Attention, norm, embedding
and unembedding come from the ``modules`` registry: on the card the
hand-written kernels (a model they do not take raises), on the CPU or
when named the plain versions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...accelerator import DeviceLike, resolve_device
from ...models import transformer as T
from ...ops.paged_attention import (KVLayer, rope_write_kv, token_positions,
                                    write_kv)
from ...tree import tree_map
from .modules import instantiate, resolve
from .ragged import KVCacheConfig, RaggedBatch
from .ragged.batch import MIN_SLOTS, _bucket
from .sampling import greedy, sample_dynamic

#: op classes resolved through the registry, in the order they run
OP_CLASSES = ("embedding", "norm", "ragged_attention",
              "fresh_prefill_attention", "unembed")


class RaggedInferenceModel:
    """Eager ragged step over (params, kv cache, batch arrays).

    ``device`` None means the GPU and raises without one; the tests pass
    ``"cpu"``.  ``implementations`` pins an op class to a named
    implementation (e.g. ``{"ragged_attention": "dense_gather"}``);
    unnamed classes take the registry's highest-priority implementation
    that supports this model and device, and on the card never a plain
    version in a kernel's place (``NotImplementedError``)."""

    def __init__(self, cfg: T.TransformerConfig, params: Dict[str, Any],
                 kv_config: Optional[KVCacheConfig] = None,
                 device: DeviceLike = None,
                 implementations: Optional[Dict[str, str]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        names = dict(implementations or {})
        unknown = set(names) - set(OP_CLASSES)
        if unknown:
            raise KeyError(f"unknown op classes {sorted(unknown)}")
        #: op class -> implementation name actually used (None: the op
        #: class has no implementation for this model, e.g. fresh
        #: prefill under ALiBi)
        self.implementations: Dict[str, Optional[str]] = {}
        for op in OP_CLASSES:
            try:
                self.implementations[op] = resolve(op, cfg, self.device,
                                                   names.get(op))
            except ValueError:
                if op != "fresh_prefill_attention" or op in names:
                    raise
                self.implementations[op] = None
        impl = {op: (instantiate(op, cfg, self.device, n)
                     if n is not None else None)
                for op, n in self.implementations.items()}
        self._embed = impl["embedding"]
        self._norm = impl["norm"]
        self._attention = impl["ragged_attention"]
        self._fresh_attention = impl["fresh_prefill_attention"]
        self._unembed = impl["unembed"]
        self.kv_config = kv_config or KVCacheConfig(
            num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
            head_dim=cfg.dims_per_head, dtype=cfg.dtype)

    # -- host -> device batch -----------------------------------------------
    def _batch_tensors(self, batch: RaggedBatch):
        dev = self.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (batch.token_ids, batch.q_lens,
                               batch.start_pos, batch.page_table))

    # -- public steps --------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch: RaggedBatch, kv: KVLayer) -> torch.Tensor:
        """One ragged forward; returns fp32 logits [S, V] (rows past the
        live sequences are padding).  ``kv`` is updated in place."""
        return self._step_impl(self.params, kv, *self._batch_tensors(batch),
                               fresh=batch.fresh)

    @torch.no_grad()
    def sample_step(self, batch: RaggedBatch, kv: KVLayer,
                    generator: torch.Generator, temps, top_ks, top_ps,
                    greedy_only: bool) -> torch.Tensor:
        """Forward + on-device sampling: returns tokens [S] int32 on the
        device (the [S, V] logits never leave it)."""
        return self._sample_step_impl(
            self.params, kv, *self._batch_tensors(batch), generator,
            *self._sample_args(temps, top_ks, top_ps),
            fresh=batch.fresh, greedy_only=greedy_only)

    @torch.no_grad()
    def sample_step_mixed(self, dec_batch: RaggedBatch,
                          pre_batch: RaggedBatch, kv: KVLayer,
                          generator: torch.Generator, temps, top_ks, top_ps,
                          greedy_only: bool) -> torch.Tensor:
        """Mixed SplitFuse step over TWO batch geometries: a decode
        segment [S_d, 1] and a prefill segment [S_p, Q], the KV cache
        written by the first before the second reads it.  Tokens come
        back as [S_d + S_p] (padded to the slot bucket) in segment
        order; the sampling arrays follow that order."""
        if dec_batch.max_q != 1:
            raise ValueError("segment A of a mixed step is decode-only")
        return self._mixed_sample_step_impl(
            self.params, kv, *self._batch_tensors(dec_batch),
            *self._batch_tensors(pre_batch), generator,
            *self._sample_args(temps, top_ks, top_ps),
            fresh_p=pre_batch.fresh, greedy_only=greedy_only)

    def _sample_args(self, temps, top_ks, top_ps):
        dev = self.device
        return (torch.as_tensor(np.asarray(temps, np.float32), device=dev),
                torch.as_tensor(np.asarray(top_ks, np.int32), device=dev),
                torch.as_tensor(np.asarray(top_ps, np.float32), device=dev))

    def _lm_head(self, params) -> torch.Tensor:
        cfg = self.cfg
        return (params["embed"]["tokens"].to(cfg.dtype).T
                if cfg.tie_embeddings
                else params["lm_head"].to(cfg.dtype))

    # -- step bodies (JAX: the traced step kinds) ---------------------------
    def _forward_hidden(self, params, kv, token_ids, q_lens, start_pos,
                        page_table, fresh: bool = False):
        """Embed -> layers -> final norm.  Returns x [S, Q, E]; ``kv``
        [L, pages+1, page, 2, K, D] (a tensor or ``KVPages``) is written
        in place."""
        cfg = self.cfg
        S, Q = token_ids.shape
        x = self._embed(params["embed"]["tokens"].to(cfg.dtype), token_ids)
        pos = token_positions(start_pos, Q)
        if cfg.pos_emb == "learned":
            safe = torch.clamp(pos, max=cfg.max_seq_len - 1)
            x = x + params["embed"]["positions"].to(cfg.dtype)[safe]
        if cfg.embed_layernorm:  # BLOOM word_embeddings_layernorm
            x = self._norm(params["embed"]["norm"], x)
        sin, cos = (T.rope_table(cfg, pos) if cfg.pos_emb == "rope"
                    else (None, None))
        for i in range(cfg.num_layers):
            x = self._layer_body(x, T.layer_params(cfg, params, i), kv[i],
                                 sin=sin, cos=cos, q_lens=q_lens,
                                 start_pos=start_pos, page_table=page_table,
                                 fresh=fresh)
        return self._norm(params["final_norm"], x)

    def _step_impl(self, params, kv, token_ids, q_lens, start_pos,
                   page_table, fresh: bool = False) -> torch.Tensor:
        x = self._forward_hidden(params, kv, token_ids, q_lens, start_pos,
                                 page_table, fresh=fresh)
        logits = self._unembed(x, q_lens, self._lm_head(params))  # [S, V]
        bias = params.get("lm_head_bias")  # the phi family ships one
        if bias is not None:
            logits = logits + bias.to(self.cfg.dtype)
        return logits.float()

    def _sample_tokens(self, logits, generator, temps, top_ks, top_ps,
                       greedy_only: bool) -> torch.Tensor:
        if greedy_only:
            return greedy(logits)
        return sample_dynamic(logits, generator, temps, top_ks, top_ps)

    def _sample_step_impl(self, params, kv, token_ids, q_lens, start_pos,
                          page_table, generator, temps, top_ks, top_ps,
                          fresh: bool = False, greedy_only: bool = False):
        logits = self._step_impl(params, kv, token_ids, q_lens, start_pos,
                                 page_table, fresh=fresh)
        return self._sample_tokens(logits, generator, temps, top_ks, top_ps,
                                   greedy_only)

    def _mixed_sample_step_impl(self, params, kv, d_tok, d_ql, d_sp, d_pt,
                                p_tok, p_ql, p_sp, p_pt, generator, temps,
                                top_ks, top_ps, fresh_p: bool = False,
                                greedy_only: bool = False):
        logits_d = self._step_impl(params, kv, d_tok, d_ql, d_sp, d_pt,
                                   fresh=False)
        logits_p = self._step_impl(params, kv, p_tok, p_ql, p_sp, p_pt,
                                   fresh=fresh_p)
        tokens = self._sample_tokens(torch.cat([logits_d, logits_p]),
                                     generator, temps, top_ks, top_ps,
                                     greedy_only)
        # pad the token vector to the slot bucket, as the JAX step does
        # (its chained step keys on the exact previous-token length)
        pad = _bucket(tokens.shape[0], MIN_SLOTS) - tokens.shape[0]
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros(pad)])
        return tokens

    def _layer_body(self, x, lp, kv_layer, *, sin, cos, q_lens, start_pos,
                    page_table, fresh: bool = False):
        cfg = self.cfg
        dtype = cfg.dtype
        h = self._norm(lp["norm1"], x)
        ap = lp["attn"]
        q = T.proj(h, T._wval(ap["wq"], dtype))
        k = T.proj(h, T._wval(ap["wk"], dtype))
        v = T.proj(h, T._wval(ap["wv"], dtype))
        if cfg.use_bias or cfg.qkv_bias:
            q = q + ap["bq"].to(dtype)
            k = k + ap["bk"].to(dtype)
            v = v + ap["bv"].to(dtype)
        use_fresh = fresh and self._fresh_attention is not None
        k_rot = k
        if cfg.pos_emb == "rope":
            q = T.apply_rope(q, sin, cos)
            if use_fresh:
                # the fresh path reads the rotated K directly: rotate
                # once and write unfused
                k_rot = T.apply_rope(k, sin, cos)
                write_kv(kv_layer, k_rot, v, page_table, start_pos, q_lens)
            else:
                rope_write_kv(kv_layer, k, v, sin, cos, page_table,
                              start_pos, q_lens)
        else:
            write_kv(kv_layer, k, v, page_table, start_pos, q_lens)
        if use_fresh:
            # pure prefill: every slot's context is its own new tokens;
            # padding-tail rows are garbage that only feeds rows the
            # logits gather ignores and KV the null page swallows
            attn = self._fresh_attention(q, k_rot, v)
        else:
            attn = self._attention(q, kv_layer, page_table, start_pos,
                                   q_lens)
        out = T.proj(attn, T._wval(ap["wo"], dtype), n_in=2)
        if cfg.use_bias:
            out = out + ap["bo"].to(dtype)
        if cfg.parallel_residual:
            h2 = self._norm(lp["norm2"], x)
            return x + out.to(x.dtype) + T._mlp_block(cfg, lp["mlp"],
                                                      h2).to(x.dtype)
        x = x + out.to(x.dtype)
        h = self._norm(lp["norm2"], x)
        return x + T._mlp_block(cfg, lp["mlp"], h).to(x.dtype)

    # -- KV requirements (engine contract) ----------------------------------
    def get_kv_requirements(self, seen_tokens: int, allocated_pages: int,
                            max_new_tokens: int, max_new_pages: int
                            ) -> Tuple[int, int]:
        """(tokens schedulable, pages needed) given page headroom."""
        page = self.kv_config.page_size
        capacity = allocated_pages * page - seen_tokens
        if max_new_tokens <= capacity:
            return max_new_tokens, 0
        need = -(-(max_new_tokens - capacity) // page)
        if need <= max_new_pages:
            return max_new_tokens, need
        tokens = capacity + max_new_pages * page
        return max(tokens, 0), max_new_pages
