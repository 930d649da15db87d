"""Plain float32 field of ngp_pl's NeRF: the multiresolution hash encoding
in the brick-row table layout, the density MLP, the SH direction encoding and
the colour MLP (ngp_pl `models/networks.py:32-77`), in PyTorch operations
with autograd.  It imports nothing of the program: the table layout and the
encoding are frozen copies of the port's plain versions
(`ngp_pl_torch/ops/hash_encoding.py`: `make_grid_spec`,
`slots_local_frac_lm`, `hash_encode_fwd_plain`), without their bf16 rounding
points, and the MLP tail is written out as the reference model defines it.

`quant`, where given, rounds the MLP operands (activations and weights) and
the table values read to a lower precision on the forward pass (the
gradient passes the rounding unchanged): the correctness checks' control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

PRIMES = (1, 2654435761, 805459861)
BRICK_PTS = 3                 # corner points per brick edge (2 cells)
CORNERS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
           (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
SH_C = (0.28209479177387814, 0.48860251190291987, 1.0925484305920792,
        0.94617469575755997, 0.31539156525251999, 0.54627421529603959,
        0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
        0.3731763325901154, 1.4453057213202769)


@dataclass(frozen=True)
class Grid:
    """The brick-row table's geometry: per level a grid of 2x2x2-cell
    bricks, one row per brick of 27 corner points x F features (rows of 64
    lanes at F=2, 128 at F=4); coarse levels dense, fine ones hashed into
    T/32 rows."""

    n_levels: int
    n_features: int
    log2_bricks: int
    resolutions: Tuple[int, ...]
    brick_grids: Tuple[int, ...]
    offsets: Tuple[int, ...]
    dense: Tuple[bool, ...]
    total_rows: int
    row_width: int


def grid(model: Dict) -> Grid:
    """The table geometry of a configuration's `model` group."""
    L, F = model["n_levels"], model["n_features"]
    scale = model["scale"]
    b = math.exp(math.log(model["max_resolution_factor"] * scale
                          / model["base_resolution"]) / (L - 1))
    lb = max(1, model["log2_hashmap_size"] - 5)
    S = 2 ** lb
    res, bricks, offs, dense = [], [], [], []
    off = 0
    for level in range(L):
        R = int(math.floor(model["base_resolution"] * b ** level))
        B = (R + 1) // 2
        size = B ** 3 if B ** 3 <= 2 * S else S
        res.append(R)
        bricks.append(B)
        offs.append(off)
        dense.append(size == B ** 3)
        off += size
    return Grid(L, F, lb, tuple(res), tuple(bricks), tuple(offs),
                tuple(dense), off, 64 if F == 2 else 128)


def mlp_shapes(model: Dict) -> Dict[str, list]:
    """Weight shapes of the bias-free MLPs: density (L*F -> 64 -> 16) and
    colour (16 SH + 16 -> 64 -> 64 -> 3)."""
    d, c = model["density_mlp"], model["color_mlp"]
    d = [model["n_levels"] * model["n_features"]] + d[1:]
    return {"sigma_mlp": list(zip(d[:-1], d[1:])),
            "rgb_mlp": list(zip(c[:-1], c[1:]))}


def _level_slots(x: torch.Tensor, g: Grid):
    """Per level: global row (N,), local corner (N, 3) in {0, 1}, frac (N,
    3); x in [0, 1]^3."""
    for level in range(g.n_levels):
        R = g.resolutions[level]
        pos = x * float(R)
        cell = torch.floor(pos)
        frac = pos - cell
        cell = torch.clamp(cell.to(torch.int64), 0, R - 1)
        brick, local = cell >> 1, cell & 1
        if g.dense[level]:
            B = g.brick_grids[level]
            slot = (brick[:, 0] * B + brick[:, 1]) * B + brick[:, 2]
        else:
            slot = ((brick[:, 0] * PRIMES[0]) ^ (brick[:, 1] * PRIMES[1])
                    ^ (brick[:, 2] * PRIMES[2])) & (2 ** g.log2_bricks - 1)
        yield slot + g.offsets[level], local, frac


def encode(x: torch.Tensor, table: torch.Tensor, g: Grid,
           quant: Optional[Callable] = None) -> torch.Tensor:
    """Trilinear hash features (N, L*F) of positions x (N, 3) in [0, 1]^3
    (clipped) from the f32 table (rows, W)."""
    x = x.clamp(0.0, 1.0)
    F, W = g.n_features, g.row_width
    flat = table.reshape(-1)
    corner = torch.tensor(CORNERS, device=x.device)
    lanes = torch.arange(F, device=x.device)
    out = []
    for slot, local, frac in _level_slots(x, g):
        pt_c = local[:, None, :] + corner[None]                  # (N, 8, 3)
        p = local.to(torch.float32) + frac
        w = torch.clamp_min(1.0 - torch.abs(pt_c.to(torch.float32)
                                            - p[:, None, :]), 0.0)
        w8 = w[..., 0] * w[..., 1] * w[..., 2]                   # (N, 8)
        pt = (pt_c[..., 0] * 3 + pt_c[..., 1]) * 3 + pt_c[..., 2]
        idx = slot[:, None, None] * W + pt[..., None] * F + lanes
        vals = flat[idx]
        if quant is not None:
            vals = quant(vals, "table")
        out.append((vals * w8[..., None]).sum(dim=1))
    return torch.cat(out, dim=1)


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Degree-4 real spherical harmonics (16) of unit directions."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, yz, xz, x2, y2, z2 = x * y, y * z, x * z, x * x, y * y, z * z
    c = SH_C
    return torch.stack([
        torch.full_like(x, c[0]), -c[1] * y, c[1] * z, -c[1] * x,
        c[2] * xy, -c[2] * yz, c[3] * z2 - c[4], -c[2] * xz,
        c[5] * (x2 - y2), c[6] * y * (-3.0 * x2 + y2), c[7] * xy * z,
        c[8] * y * (1.0 - 5.0 * z2), c[9] * z * (5.0 * z2 - 3.0),
        c[8] * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
        c[6] * x * (-x2 + 3.0 * y2)], dim=-1)


class TruncExp(torch.autograd.Function):
    """exp of the input clamped to [-30, 30]; the backward re-exponentiates
    it clamped to [-15, 15] (ngp_pl `models/custom_functions.py`)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, -30.0, 30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def _mm(a, w, quant):
    if quant is None:
        return a @ w
    return quant(a, "act") @ quant(w, "weight")


def geometry(params: Dict, xyz: torch.Tensor, g: Grid, scale: float,
             quant: Optional[Callable] = None) -> torch.Tensor:
    """The density MLP's output h (N, 16) at world positions xyz (N, 3);
    the density is trunc_exp(h[:, 0])."""
    x = (xyz + scale) / (2.0 * scale)
    feats = encode(x, params["hash_table"], g, quant)
    w1, w2 = params["sigma_mlp"]
    return _mm(torch.relu(_mm(feats, w1, quant)), w2, quant)


def field(params: Dict, xyz: torch.Tensor, dirs: torch.Tensor, g: Grid,
          scale: float, quant: Optional[Callable] = None):
    """(sigma (N,), rgb (N, 3)) at world positions xyz (N, 3) seen along
    dirs (N, 3), not necessarily unit."""
    h = geometry(params, xyz, g, scale, quant)                   # (N, 16)
    sigma = TruncExp.apply(h[:, 0])
    dn = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    z = torch.cat([sh4(dn), h], dim=-1)
    wr = params["rgb_mlp"]
    for i, w in enumerate(wr):
        z = _mm(z, w, quant)
        if i < len(wr) - 1:
            z = torch.relu(z)
    return sigma, torch.sigmoid(z)


def leaves(params: Dict):
    """(name, tensor) of every parameter, in the program's order."""
    yield "hash_table", params["hash_table"]
    for name in ("sigma_mlp", "rgb_mlp"):
        for i, w in enumerate(params[name]):
            yield f"{name}[{i}]", w


def fp8_scaled(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448), as an fp8 training recipe scales it."""
    amax = t.detach().abs().max().clamp_min(1e-30)
    s = amax / 448.0
    return (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def lower_precision(kind_by_operand: Dict[str, str]) -> Callable:
    """A `quant` that rounds each operand kind ("table", "act", "weight")
    to the precision named ("bfloat16", "float16" or "fp8_e4m3_scaled");
    the gradient passes unchanged."""
    def rnd(t: torch.Tensor, kind: str) -> torch.Tensor:
        p = kind_by_operand.get(kind)
        if p is None:
            return t
        if p == "fp8_e4m3_scaled":
            q = fp8_scaled(t)
        else:
            q = t.detach().to(getattr(torch, p)).to(torch.float32)
        return t + (q - t.detach())
    return rnd
