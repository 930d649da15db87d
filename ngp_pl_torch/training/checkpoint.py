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
`opt[1].count`, which optax advances with the Adam count) and `__step__`;
with `--optimize_ext` the same state under `multi_transform`'s keys
(`opt.inner_states['net'].inner_state[0].mu['net'][...]`, ...), the pose
optimizer's under `opt.inner_states['pose']...` and the poses under
`pose['dR']`, `pose['dT']`.  The HDR head's tonemappers are parameters
like the others (`params['tonemapper'][i][j]`).

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


def load_train_state(ngp, opt, params: Dict, mu: Dict, nu: Dict,
                     count: int) -> None:
    """JAX train state -> port: parameters into `ngp`, Adam moments and
    step count into `opt` (an `ngp_pl_torch.training.train_step.Adam` over
    the model's parameters in its `_slots` order)."""
    ngp.load_params(params)
    with torch.no_grad():
        for dst, src in ((opt.mu, mu), (opt.nu, nu)):
            for d, (name, i, _) in zip(dst, ngp._slots()):
                d.copy_(torch.as_tensor(np.asarray(
                    ngp._leaf(src, name, i), np.float32)))
    opt.count = int(count)


def _nest_like(ngp, tensors) -> Dict:
    """Tensors in the model's `_slots` order -> numpy arrays in the JAX
    nesting of its parameters."""
    out = ngp.params_numpy()
    for t, (name, i, _) in zip(tensors, ngp._slots()):
        a = t.detach().cpu().numpy()
        if i is None:
            out[name] = a
        elif isinstance(i, tuple):
            out[name][i[0]][i[1]] = a
        else:
            out[name][i] = a
    return out


def train_state_numpy(ngp, opt) -> Tuple[Dict, Dict, Dict, int]:
    """Port -> JAX train state: (params, mu, nu) nests of numpy arrays in
    the JAX layout and the step count."""
    return (ngp.params_numpy(), _nest_like(ngp, opt.mu),
            _nest_like(ngp, opt.nu), opt.count)


def pose_state_numpy(pose) -> Dict:
    """A `PoseRefinement`'s dR, dT and its Adam state as numpy nests
    {'params', 'mu', 'nu': {'dR', 'dT'}, 'count'}."""
    def nest(ts):
        return {k: t.detach().cpu().numpy() for k, t in zip(("dR", "dT"), ts)}

    return {"params": nest((pose.dR, pose.dT)), "mu": nest(pose.opt.mu),
            "nu": nest(pose.opt.nu), "count": pose.opt.count}


def load_pose_state(pose, state: Dict) -> None:
    """`pose_state_numpy`'s inverse, into an existing `PoseRefinement`."""
    with torch.no_grad():
        for dst, src in (((pose.dR, pose.dT), state["params"]),
                         (pose.opt.mu, state["mu"]),
                         (pose.opt.nu, state["nu"])):
            for d, k in zip(dst, ("dR", "dT")):
                d.copy_(torch.as_tensor(np.asarray(src[k], np.float32)))
    pose.opt.count = int(state["count"])


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


# optax's state keys: `optax.adam(schedule)` alone, or under
# `optax.multi_transform({'net': ..., 'pose': adam(pose_lr)})` with
# `--optimize_ext` (train_step.py:53-66), whose inner states nest each
# group's moments under the group's name
_NET = "opt.inner_states['net'].inner_state"
_POSE = "opt.inner_states['pose'].inner_state[0]"


def _net_keys(pose: bool) -> Tuple[str, str, str, str]:
    """The net's Adam state, its mu and nu, and the schedule's state, as
    key prefixes: plain `optax.adam`, or the 'net' group of
    `multi_transform` with --optimize_ext."""
    if not pose:
        return "opt[0]", "opt[0].mu", "opt[0].nu", "opt[1]"
    return (f"{_NET}[0]", f"{_NET}[0].mu['net']", f"{_NET}[0].nu['net']",
            f"{_NET}[1]")


def _full_arrays(params, mu, nu, count, grid, pose=None
                 ) -> Dict[str, np.ndarray]:
    data = flatten_params(params)
    data.update({f"grid.{k}": np.asarray(grid[k]) for k in GRID_FIELDS})
    adam, mu_p, nu_p, sched = _net_keys(pose is not None)
    if pose is not None:
        data.update(flatten_params(pose["params"], "pose"))
        data[f"{_POSE}.count"] = np.asarray(pose["count"], np.int32)
        data.update(flatten_params(pose["mu"], f"{_POSE}.mu['pose']"))
        data.update(flatten_params(pose["nu"], f"{_POSE}.nu['pose']"))
    data[f"{adam}.count"] = np.asarray(count, np.int32)
    data.update(flatten_params(mu, mu_p))
    data.update(flatten_params(nu, nu_p))
    data[f"{sched}.count"] = np.asarray(count, np.int32)
    return data


def save_checkpoint(path: str, *, params: Dict, mu: Dict, nu: Dict,
                    count: int, grid: Dict[str, np.ndarray],
                    step: int, pose: Dict = None) -> None:
    """A full checkpoint (checkpoint.py:54-69) of numpy nests as
    `train_state_numpy`, `grid_state_numpy` and, with `--optimize_ext`,
    `pose_state_numpy` give them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = _full_arrays(params, mu, nu, count, grid, pose)
    data["__step__"] = np.asarray(step)
    np.savez(path, **data)


def load_checkpoint(path: str, *, params: Dict, mu: Dict, nu: Dict,
                    count: int, grid: Dict[str, np.ndarray],
                    pose: Dict = None):
    """Partial-update load (checkpoint.py:28-49, 72-85): the templates give
    the structure, the archive the values where it has them; a leaf whose
    shape differs raises.  Returns (params, mu, nu, count, grid, pose,
    step), step 0 when the archive has none.  `pose` (the template of
    `pose_state_numpy`, `--optimize_ext`) reads the optimizer state under
    `multi_transform`'s keys and the poses under `pose[...]`; without it
    the result's pose is None."""
    with np.load(path, allow_pickle=False) as f:
        data = dict(f)
    out = {}
    for key, leaf in _full_arrays(params, mu, nu, count, grid,
                                  pose).items():
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
    adam, mu_p, nu_p, _ = _net_keys(pose is not None)
    pose_out = None if pose is None else {
        "params": unflatten_params(out, "pose"),
        "mu": unflatten_params(out, f"{_POSE}.mu['pose']"),
        "nu": unflatten_params(out, f"{_POSE}.nu['pose']"),
        "count": int(out[f"{_POSE}.count"])}
    return (unflatten_params(out), unflatten_params(out, mu_p),
            unflatten_params(out, nu_p), int(out[f"{adam}.count"]),
            {k: out[f"grid.{k}"] for k in GRID_FIELDS}, pose_out,
            int(data.get("__step__", 0)))
