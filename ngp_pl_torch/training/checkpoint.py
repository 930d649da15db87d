"""Slim checkpoints in the JAX package's npz key format (counterpart of
ngp_pl_tpu/training/checkpoint.py:88-102), and the train state carried
across from and to the JAX package.

A slim checkpoint holds the parameters and the uint8 occupancy grid.  Keys
are the JAX pytree paths, e.g. `params['hash_table']`,
`params['sigma_mlp'][0]`, `params['rgb_mlp'][2]` and `occ_grid`, so a
checkpoint written by either package loads in the other.

The train state is the JAX `TrainState`'s params and optax Adam state
(`mu`, `nu` in the params' nesting, and the step `count`), as numpy arrays:
`load_train_state` puts them into a port model and its `Adam`,
`train_state_numpy` takes them out again.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

_PATH_ITEM = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def flatten_params(params: Dict, prefix: str = "params") -> Dict[str, np.ndarray]:
    """Nested dict/list of arrays -> {"params['name'][i]": array}."""
    out = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{key}['{k}']")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{key}[{i}]")
        else:
            out[key] = np.asarray(node)

    walk(params, prefix)
    return out


def unflatten_params(data: Dict[str, np.ndarray], prefix: str = "params") -> Dict:
    """Inverse of `flatten_params` for the keys that start with prefix."""
    root: Dict = {}
    for key, value in data.items():
        if not key.startswith(prefix + "["):
            continue
        items = [(m.group(1), m.group(2))
                 for m in _PATH_ITEM.finditer(key[len(prefix):])]
        node = root
        for depth, (name, index) in enumerate(items):
            k = name if name is not None else int(index)
            last = depth == len(items) - 1
            if isinstance(node, list):
                while len(node) <= k:
                    node.append(None)
            if last:
                node[k] = value
            else:
                nxt_is_list = items[depth + 1][1] is not None
                if isinstance(node, list):
                    if node[k] is None:
                        node[k] = [] if nxt_is_list else {}
                elif k not in node:
                    node[k] = [] if nxt_is_list else {}
                node = node[k]
    return root


def params_from_numpy(params: Dict, device="cpu") -> Dict:
    """Carry a nested dict of JAX parameters (as numpy arrays) into torch
    tensors on `device`, keeping the nesting."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_from_numpy(v, device) for v in params]
    return torch.tensor(np.array(params, dtype=np.float32), device=device)


def _nested(params: Dict):
    """Leaves of a {'hash_table', 'sigma_mlp': [...], 'rgb_mlp': [...]}
    nest in the model's parameter order."""
    yield params["hash_table"]
    for name in ("sigma_mlp", "rgb_mlp"):
        yield from params[name]


def load_train_state(ngp, opt, params: Dict, mu: Dict, nu: Dict,
                     count: int) -> None:
    """JAX train state -> port: parameters into `ngp`, Adam moments and
    step count into `opt` (an `ngp_pl_torch.training.train_step.Adam` over
    the model's parameters in its `_slots` order)."""
    ngp.load_params(params)
    with torch.no_grad():
        for dst, src in ((opt.mu, mu), (opt.nu, nu)):
            for d, s in zip(dst, _nested(src)):
                d.copy_(torch.as_tensor(np.asarray(s, np.float32)))
    opt.count = int(count)


def train_state_numpy(ngp, opt) -> Tuple[Dict, Dict, Dict, int]:
    """Port -> JAX train state: (params, mu, nu) nests of numpy arrays in
    the JAX layout and the step count."""
    ns = len(ngp.sigma_mlp)

    def nest(tensors):
        ts = [t.detach().cpu().numpy() for t in tensors]
        return {"hash_table": ts[0], "sigma_mlp": ts[1:1 + ns],
                "rgb_mlp": ts[1 + ns:]}

    return ngp.params_numpy(), nest(opt.mu), nest(opt.nu), opt.count


def save_slim_checkpoint(path: str, *, params: Dict, occ_grid) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = flatten_params(params)
    data["occ_grid"] = np.asarray(
        occ_grid.cpu() if isinstance(occ_grid, torch.Tensor) else occ_grid,
        np.uint8)
    np.savez(path, **data)


def load_slim_checkpoint(path: str) -> Tuple[Dict, np.ndarray]:
    """-> (nested params of numpy arrays, occ_grid uint8 (C, G, G, G))."""
    with np.load(path, allow_pickle=False) as f:
        data = dict(f)
    return unflatten_params(data), data["occ_grid"]
