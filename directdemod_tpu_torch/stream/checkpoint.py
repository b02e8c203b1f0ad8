"""Checkpoint / resume of partially processed streams.

Port of `directdemod_tpu/stream/checkpoint.py`, file for file: the state's
leaves (its tensors, in the order `jax.tree.flatten` gives them, None
entries dropped) as `leaf_<i>` arrays of one `.npz`, beside a JSON side file
with the same magic, the stream position and `meta`. So a checkpoint the
JAX package wrote for the same chain restores here and resumes, and the
other way round. The state is a tensor, None, or a list, tuple or dict
(keys in sorted order) of such.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

MAGIC = "directdemod-tpu-ckpt-v1"


def _leaves(state) -> list:
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [leaf for s in state for leaf in _leaves(s)]
    if isinstance(state, dict):
        return [leaf for key in sorted(state) for leaf in _leaves(state[key])]
    return [state]


def _rebuild(like, leaves):
    if like is None:
        return None
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(s, leaves) for s in like)
    if isinstance(like, dict):
        return {key: _rebuild(like[key], leaves) for key in sorted(like)}
    arr = next(leaves)
    return torch.as_tensor(arr, device=getattr(like, "device", "cpu"))


def save(path: str, state, position: int, meta: dict | None = None) -> None:
    """Serialize a pipeline / front-end state and the stream position."""
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": (v.detach().cpu().numpy()
                            if isinstance(v, torch.Tensor) else np.asarray(v))
              for i, v in enumerate(leaves)}
    np.savez(path, **arrays)
    side = {"magic": MAGIC, "position": int(position),
            "n_leaves": len(leaves), "meta": meta or {}}
    with open(path + ".json", "w") as f:
        json.dump(side, f)


def restore(path: str, like_state) -> tuple[object, int, dict]:
    """Rebuild (state, position, meta); `like_state` gives the structure and
    the device of each leaf."""
    with open(path + ".json") as f:
        side = json.load(f)
    if side.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a directdemod-tpu checkpoint")
    data = np.load(path + ".npz" if os.path.exists(path + ".npz") else path,
                   allow_pickle=False)
    n_like = len(_leaves(like_state))
    if side["n_leaves"] != n_like:
        raise ValueError(f"{path}: {side['n_leaves']} leaves, the state has "
                         f"{n_like}")
    leaves = iter([data[f"leaf_{i}"] for i in range(side["n_leaves"])])
    return _rebuild(like_state, leaves), side["position"], side["meta"]
