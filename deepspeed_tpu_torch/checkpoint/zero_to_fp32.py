"""Offline fp32 reconstruction from a checkpoint directory.

Counterpart of ``deepspeed_tpu/checkpoint/zero_to_fp32.py`` (reference
``deepspeed/utils/zero_to_fp32.py``).  On one rank the port's masters are
stored whole in ``mp_rank_00_model_states.pt`` (``checkpoint/engine.py``),
so reconstruction reads that file with torch and hands the tree back as
numpy fp32 arrays; no engine and no card is needed.  The flat key scheme
is the JAX tool's: ``.``-joined tree paths (``sep="/"`` gives the
universal checkpoint's atom keys), dict keys in sorted order.

CLI:  python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.npz> [tag]
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from .engine import read_checkpoint


def _to_numpy(leaf) -> np.ndarray:
    """A host view of a leaf (a copy only off the CPU, or of a bf16 leaf,
    which numpy holds as fp32: an offloaded leaf's compute copy)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def get_fp32_state_dict_from_zero_checkpoint(
        ckpt_dir: str, tag: Optional[str] = None) -> Dict[str, Any]:
    """The fp32 master tree of a checkpoint (``tag``, or the one
    ``latest`` names), as numpy arrays in the model's layout."""
    state, _, _ = read_checkpoint(ckpt_dir, tag, module_only=True)
    return _tree_to_host_fp32(state["module"])


def _tree_to_host_fp32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to_host_fp32(v) for k, v in tree.items()}
    return _to_numpy(tree).astype(np.float32, copy=False)


def flatten_state_dict(tree: Any, prefix: str = "",
                       sep: str = ".") -> Dict[str, np.ndarray]:
    """A tree of dicts -> flat ``{'a.b.c': array}``, the JAX tool's keys
    and order (``sep='/'``: the universal atom keys)."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        else:
            out[prefix + sep.join(path)] = _to_numpy(node)
    walk(tree, ())
    return out


def convert_zero_checkpoint_to_fp32_state_dict(
        ckpt_dir: str, output_file: str, tag: Optional[str] = None) -> None:
    params = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    flat = flatten_state_dict(params)
    np.savez(output_file, **flat)
    total = sum(v.size for v in flat.values())
    print(f"saved {len(flat)} tensors / {total:,} params -> {output_file}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (2, 3):
        print("usage: python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 "
              "<checkpoint_dir> <output.npz> [tag]")
        return 1
    convert_zero_checkpoint_to_fp32_state_dict(
        argv[0], argv[1], argv[2] if len(argv) == 3 else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
