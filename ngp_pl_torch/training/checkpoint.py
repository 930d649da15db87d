"""Full and slim checkpoints in the JAX package's npz key format
(counterpart of ngp_pl_tpu/training/checkpoint.py), and the train state
carried across from and to the JAX package.

Keys are the JAX pytree paths, so a checkpoint written by either package
loads in the other.  A slim checkpoint holds the parameters
(`params['hash_table']`, `params['sigma_mlp'][0]`, `params['rgb_mlp'][2]`,
...) and the uint8 `occ_grid`.  A full one, for resuming, holds the
parameters, the occupancy grid state (`grid.density_grid`, ...,
`grid.win_rows`), the optax Adam state of `optax.adam(schedule)`
(`opt[0].count`, `opt[0].mu[...]`, `opt[0].nu[...]` and the schedule's
`opt[1].count`, which optax advances with the Adam count) and `__step__`.

The train state is the JAX `TrainState`'s params and optax Adam state
(`mu`, `nu` in the params' nesting, and the step `count`), as numpy arrays:
`load_train_state` puts them into a port model and its `Adam`,
`train_state_numpy` takes them out again; `grid_state_numpy` and
`grid_state_from_numpy` do the same for the occupancy grid.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from ngp_pl_torch.models.occupancy import OccupancyGridState, grid_rows

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


# the JAX package's OccupancyGridState fields, in its order; the port's
# state keeps all but the z-lines, which `grid_state_numpy` builds
GRID_FIELDS = ("density_grid", "count_grid", "occ_grid", "mean_density",
               "occ_rows", "dil_rows", "win_rows")
_WORDS = ("occ_rows", "dil_rows", "win_rows")      # uint32 in the archive


def grid_state_numpy(state: OccupancyGridState) -> Dict[str, np.ndarray]:
    """The grid state as the JAX package's fields and dtypes: the packed
    rows as uint32 (the port's int32 words, bit for bit)."""
    occ_rows, dil_rows, _ = grid_rows(state.occ_grid)
    out = {"density_grid": state.density_grid, "count_grid": state.count_grid,
           "occ_grid": state.occ_grid, "mean_density": state.mean_density,
           "occ_rows": occ_rows, "dil_rows": dil_rows,
           "win_rows": state.win_rows}
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    for k in _WORDS:
        out[k] = out[k].view(np.uint32)
    return out


def grid_state_from_numpy(grid: Dict[str, np.ndarray],
                          device) -> OccupancyGridState:
    """The port's grid state from the JAX fields (the z-lines dropped)."""
    def dev(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return OccupancyGridState(
        density_grid=dev(grid["density_grid"], np.float32),
        count_grid=dev(grid["count_grid"], np.float32),
        occ_grid=dev(grid["occ_grid"], np.uint8),
        mean_density=dev(grid["mean_density"], np.float32),
        win_rows=dev(np.asarray(grid["win_rows"]).astype(np.uint32)
                     .view(np.int32), np.int32))


def _full_arrays(params, mu, nu, count, grid) -> Dict[str, np.ndarray]:
    data = flatten_params(params)
    data.update({f"grid.{k}": np.asarray(grid[k]) for k in GRID_FIELDS})
    data["opt[0].count"] = np.asarray(count, np.int32)
    data.update(flatten_params(mu, "opt[0].mu"))
    data.update(flatten_params(nu, "opt[0].nu"))
    data["opt[1].count"] = np.asarray(count, np.int32)
    return data


def save_checkpoint(path: str, *, params: Dict, mu: Dict, nu: Dict,
                    count: int, grid: Dict[str, np.ndarray],
                    step: int) -> None:
    """A full checkpoint (checkpoint.py:54-69) of numpy nests as
    `train_state_numpy` and `grid_state_numpy` give them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = _full_arrays(params, mu, nu, count, grid)
    data["__step__"] = np.asarray(step)
    np.savez(path, **data)


def load_checkpoint(path: str, *, params: Dict, mu: Dict, nu: Dict,
                    count: int, grid: Dict[str, np.ndarray]):
    """Partial-update load (checkpoint.py:28-49, 72-85): the templates give
    the structure, the archive the values where it has them; a leaf whose
    shape differs raises.  Returns (params, mu, nu, count, grid, step),
    step 0 when the archive has none.  Pose-refinement state (`pose[...]`,
    `--optimize_ext`) raises: the port does not train poses yet."""
    with np.load(path, allow_pickle=False) as f:
        data = dict(f)
    if any(k.startswith("pose") for k in data):
        raise NotImplementedError(
            f"{path} holds pose-refinement state (--optimize_ext), which the "
            "port does not train yet")
    out = {}
    for key, leaf in _full_arrays(params, mu, nu, count, grid).items():
        if key not in data:
            out[key] = leaf
            continue
        if tuple(np.shape(data[key])) != tuple(np.shape(leaf)):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {np.shape(data[key])} "
                f"but the model expects {np.shape(leaf)} — the checkpoint "
                "was saved with a different model geometry (check "
                "--n_levels/--n_features/--log2_hashmap_size and --scale; "
                "they must match the training run)")
        out[key] = data[key]
    return (unflatten_params(out), unflatten_params(out, "opt[0].mu"),
            unflatten_params(out, "opt[0].nu"), int(out["opt[0].count"]),
            {k: out[f"grid.{k}"] for k in GRID_FIELDS},
            int(data.get("__step__", 0)))
