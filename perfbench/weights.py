"""The field's initial weights, made from the run's seed on the device in
one call per tensor: the table U(-1e-4, 1e-4) (tinycudann's init) with
each row's pad lanes 0, the bias-free MLPs He-uniform.  The reference and
the program start from the same tensors."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import field as rf


@torch.no_grad()
def make(model: Dict, seed: int, dev) -> Dict:
    g = rf.grid(model)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    table = torch.rand((g.total_rows, g.row_width), generator=gen,
                       device=dev) * 2e-4 - 1e-4
    table[:, rf.BRICK_PTS ** 3 * g.n_features:] = 0.0
    out = {"hash_table": table}
    for name, shapes in rf.mlp_shapes(model).items():
        out[name] = []
        for fan_in, fan_out in shapes:
            b = (6.0 / fan_in) ** 0.5
            out[name].append(torch.rand((fan_in, fan_out), generator=gen,
                                        device=dev) * (2 * b) - b)
    return out
