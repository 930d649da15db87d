"""The NGP radiance field as an nn.Module (counterpart of
ngp_pl_tpu/models/ngp.py, reference models/networks.py:13-153).

Parameters keep the JAX package's names and layouts, so one set of weights
runs in both: `hash_table` (rows, W), `sigma_mlp` [(L*F, 64), (64, 16)],
`rgb_mlp` [(32, 64), (64, 64), (64, 3)]; the MLPs are bias-free.

`density` is the fused hash encode + first layer (K1) followed by the
second sigma layer as a plain matmul whose bf16 output rounding matches the
JAX package's `_mlp_apply`.  `forward` is K1 followed by the fused field
tail (K7).  Only the Sigmoid head of the reference geometry is covered;
other heads raise until a later slice.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ngp_pl_torch.config import NGPConfig
from ngp_pl_torch.device import resolve_device
from ngp_pl_torch.ops.field_tail import field_tail, field_tail_supported
from ngp_pl_torch.ops.hash_encoding import (
    HashGridSpec,
    _bf,
    hash_encode_fwd,
    init_hash_table,
    make_grid_spec,
    table_f16,
)
from ngp_pl_torch.ops.sh import sh_encode
from ngp_pl_torch.ops.trunc_exp import trunc_exp


def grid_spec_for(cfg: NGPConfig) -> HashGridSpec:
    return make_grid_spec(
        n_levels=cfg.n_levels,
        n_features=cfg.n_features_per_level,
        log2_hashmap_size=cfg.log2_hashmap_size,
        base_resolution=cfg.base_resolution,
        per_level_scale=cfg.per_level_scale,
    )


def _mlp_init(sizes, generator) -> List[torch.Tensor]:
    """He-uniform init for a bias-free ReLU MLP given layer sizes."""
    ws = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = (6.0 / fan_in) ** 0.5
        ws.append(torch.rand((fan_in, fan_out), generator=generator)
                  * (2 * bound) - bound)
    return ws


def init_ngp_params(cfg: NGPConfig, generator: torch.Generator) -> Dict:
    """Seeded parameters in the JAX package's nested layout (CPU tensors).
    torch.Generator and jax.random draw different numbers from one seed;
    parity tests carry JAX's parameters over with `load_params`."""
    spec = grid_spec_for(cfg)
    sh_dim = cfg.sh_degree ** 2
    return {
        "hash_table": init_hash_table(spec, generator),
        "sigma_mlp": _mlp_init(
            [spec.out_dim] + [cfg.sigma_hidden] * cfg.sigma_layers
            + [cfg.geo_features], generator),
        "rgb_mlp": _mlp_init(
            [sh_dim + cfg.geo_features] + [cfg.rgb_hidden] * cfg.rgb_layers
            + [3], generator),
    }


class NGP(nn.Module):
    def __init__(self, cfg: NGPConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if not field_tail_supported(cfg):
            raise NotImplementedError(
                "the port covers the reference field geometry with the "
                "Sigmoid head; HDR/tonemapper mode and other MLP shapes are "
                "a later slice")
        dev = resolve_device(device)
        self.cfg = cfg
        self.spec = grid_spec_for(cfg)
        p = init_ngp_params(cfg, torch.Generator().manual_seed(seed))
        self.hash_table = nn.Parameter(p["hash_table"].to(dev))
        self.sigma_mlp = nn.ParameterList(
            [nn.Parameter(w.to(dev)) for w in p["sigma_mlp"]])
        self.rgb_mlp = nn.ParameterList(
            [nn.Parameter(w.to(dev)) for w in p["rgb_mlp"]])
        self._table16 = None
        self._table16_key = None

    # --- parameters in the JAX layout ---------------------------------
    def _slots(self):
        yield "hash_table", None, self.hash_table
        for name in ("sigma_mlp", "rgb_mlp"):
            for i, w in enumerate(getattr(self, name)):
                yield name, i, w

    @torch.no_grad()
    def load_params(self, params: Dict) -> None:
        """Copy a nested {'hash_table', 'sigma_mlp': [...], 'rgb_mlp': [...]}
        of arrays or tensors into the module; shapes must match."""
        for name, i, w in self._slots():
            src = params[name] if i is None else params[name][i]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src, dtype=np.float32))
            if tuple(src.shape) != tuple(w.shape):
                raise ValueError(
                    f"parameter {name}{'' if i is None else [i]} has shape "
                    f"{tuple(src.shape)}, the model expects {tuple(w.shape)}"
                    " (check --n_levels/--log2_hashmap_size)")
            w.copy_(src.to(w.device, torch.float32))

    def params_numpy(self) -> Dict:
        out: Dict = {"sigma_mlp": [], "rgb_mlp": []}
        for name, i, w in self._slots():
            a = w.detach().cpu().numpy()
            if i is None:
                out[name] = a
            else:
                out[name].append(a)
        return out

    # --- field queries --------------------------------------------------
    def table16(self) -> torch.Tensor:
        """The f16 table copy K1 reads.  It is rebuilt only when the table
        changed: an in-place update (load_params, an optimizer step) bumps
        the parameter's version counter, a move to another device its
        storage."""
        key = (self.hash_table.data_ptr(), self.hash_table._version)
        if key != self._table16_key:
            self._table16 = table_f16(self.hash_table.detach())
            self._table16_key = key
        return self._table16

    def _h1(self, x: torch.Tensor) -> torch.Tensor:
        xn = (x + self.cfg.scale) / (2.0 * self.cfg.scale)     # -> [0, 1]
        return hash_encode_fwd(xn.contiguous(), self.table16(),
                               self.sigma_mlp[0], self.spec)

    def density(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, 3) world positions in [-scale, scale]^3 -> sigma (N,)."""
        h = _bf(_bf(torch.relu(self._h1(x))) @ _bf(self.sigma_mlp[1]))
        return trunc_exp(h[:, 0])

    def forward(self, x: torch.Tensor, d: torch.Tensor):
        """(sigma (N,), rgb (N, 3)) from positions and view directions."""
        h1 = self._h1(x)
        dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        sh = sh_encode((dn + 1.0) * 0.5, self.cfg.sh_degree)
        return field_tail(h1, sh, self.sigma_mlp[1], self.rgb_mlp[0],
                          self.rgb_mlp[1], self.rgb_mlp[2])
