"""Mesh extraction from a trained density field (counterpart of
ngp_pl_tpu/utils/mesh.py; the reference's test.ipynb mesh cell).

The density is queried on a dense lattice spanning [-scale, scale]^3 and
the isosurface at `level` is cut out by **marching tetrahedra**: each cube
of the lattice splits into 6 tets, and every tet that crosses the level
emits one or two triangles whose vertices are interpolated along its edges.
The march is tensor code that runs on either device; it returns the
JAX package's vertex numbering and face order:

- cubes in C order of their lattice coordinates, each cube's tets in
  `_TETS` order, a tet's inside and outside corners each in tet order;
- a vertex is numbered by the first edge query that meets its edge (the
  edge being the unordered pair of its corners), and is interpolated from
  the inside corner to the outside one, in float32 as numpy 2 does;
- windings [e0, e2, e1] for three corners in, [e00, e01, e11] and
  [e00, e11, e10] for two in.

Divisions take 0-dim tensors: on CUDA `tensor / python_float` multiplies
by the reciprocal, which moves the last bit.  Export is plain OBJ/PLY
text, byte for byte as the JAX package writes it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# 6-tetrahedra decomposition of a cube, vertex indices into the cube corner
# numbering c = (dx, dy, dz) -> dx*4 + dy*2 + dz
_TETS = ((0, 5, 1, 3), (0, 5, 3, 2), (0, 5, 2, 4), (5, 2, 4, 6),
         (5, 3, 2, 7), (5, 2, 6, 7))
_CORNERS = tuple((x, y, z) for x in range(2) for y in range(2)
                 for z in range(2))
# By a tet's count of inside corners (1, 2, 3): the edge queries in the
# JAX package's call order, as (inside, outside) positions among the tet's
# corners sorted inside first; a fourth query only with two in.
_EDGES = {1: ((0, 1), (0, 2), (0, 3), (0, 0)),
          2: ((0, 2), (0, 3), (1, 2), (1, 3)),
          3: ((0, 3), (1, 3), (2, 3), (0, 0))}
# the triangles of each case as positions among its edge queries; a
# second triangle only with two in
_FACES = {1: ((0, 1, 2), (0, 0, 0)),
          2: ((0, 1, 3), (0, 3, 2)),
          3: ((0, 2, 1), (0, 0, 0))}


def lattice(resolution: int, scale: float, device="cpu") -> torch.Tensor:
    """The (R^3, 3) f32 lattice points, x slowest: `np.linspace` in float64
    cast to float32, as the JAX package makes them (torch.linspace rounds
    other points)."""
    lin = torch.from_numpy(np.linspace(-scale, scale, resolution,
                                       dtype=np.float32)).to(device)
    x, y, z = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


@torch.no_grad()
def density_grid_query(density_fn: Callable, resolution: int, scale: float,
                       chunk: int = 2 ** 17, device="cpu") -> torch.Tensor:
    """sigma on the dense (R, R, R) lattice spanning [-scale, scale]^3, one
    `density_fn` call per `chunk` points, on `device`."""
    pts = lattice(resolution, scale, device)
    out = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
    for i in range(0, pts.shape[0], chunk):
        out[i:i + chunk] = density_fn(pts[i:i + chunk])
    return out.reshape(resolution, resolution, resolution)


def _table(cases: dict, n_in: torch.Tensor) -> torch.Tensor:
    """Row n_in - 1 of the per-case table, for each tet."""
    t = torch.tensor([cases[k] for k in (1, 2, 3)], dtype=torch.int64,
                     device=n_in.device)
    return t[n_in - 1]


@torch.no_grad()
def marching_tetrahedra(values: torch.Tensor, level: float):
    """values: (R, R, R) f32 scalar field.  Returns (verts (V, 3) f32 in
    index space, faces (F, 3) int32), on the field's device."""
    R = values.shape[0]
    dev = values.device
    lvl = torch.tensor(level, dtype=torch.float32, device=dev)
    inside = values > lvl
    occ = inside[:-1, :-1, :-1]
    any_in, all_in = occ.clone(), occ.clone()
    for dx, dy, dz in _CORNERS[1:]:
        c = inside[dx:R - 1 + dx, dy:R - 1 + dy, dz:R - 1 + dz]
        any_in |= c
        all_in &= c
    active = torch.nonzero(any_in & ~all_in)              # C order
    if active.numel() == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))
    # flat indices by products and sums: CUDA has no int64 matmul
    stride = torch.tensor([R * R, R, 1], device=dev)
    corner_off = (torch.tensor(_CORNERS, device=dev) * stride).sum(dim=1)
    cidx = (active * stride).sum(dim=1)[:, None] + corner_off  # (M, 8)
    tets = cidx[:, torch.tensor(_TETS, device=dev)].reshape(-1, 4)
    flat_in = inside.reshape(-1)
    n_in = flat_in[tets].sum(dim=1)
    cut = (n_in > 0) & (n_in < 4)
    tets, n_in = tets[cut], n_in[cut]                     # (K, 4), (K,)
    # inside corners first, each group in tet order
    order = torch.argsort((~flat_in[tets]).to(torch.int8), dim=1,
                          stable=True)
    corners = torch.gather(tets, 1, order)
    # the edge queries, (K, 4) of them in call order, as (inside, outside)
    pairs = _table(_EDGES, n_in)                          # (K, 4, 2)
    ia = torch.gather(corners, 1, pairs[..., 0])
    ib = torch.gather(corners, 1, pairs[..., 1])
    used = torch.ones_like(ia, dtype=torch.bool)
    used[:, 3] = n_in == 2
    ia, ib = ia[used], ib[used]                           # call order
    # a vertex per unordered edge, numbered by its first query
    n = R ** 3
    key = torch.minimum(ia, ib) * n + torch.maximum(ia, ib)
    uniq, inv = torch.unique(key, return_inverse=True)
    pos = torch.arange(key.numel(), device=dev)
    first = torch.full((uniq.numel(),), key.numel(),
                       device=dev).scatter_reduce(0, inv, pos, reduce="amin")
    by_first = torch.argsort(first)
    rank = torch.empty_like(by_first)
    rank[by_first] = torch.arange(uniq.numel(), device=dev)
    call_vert = torch.full(used.shape, -1, dtype=torch.int64, device=dev)
    call_vert[used] = rank[inv]
    # interpolate each vertex from its first query's inside corner
    a, b = ia[first[by_first]], ib[first[by_first]]
    flat = values.reshape(-1)
    va, vb = flat[a], flat[b]
    t = torch.where(vb != va, (lvl - va) / (vb - va),
                    torch.tensor(0.5, dtype=torch.float32, device=dev))

    def coords(i):
        return torch.stack([i // (R * R), (i // R) % R, i % R],
                           dim=-1).to(torch.float32)

    pa, pb = coords(a), coords(b)
    verts = pa + t[:, None] * (pb - pa)
    # triangles in tet order, a tet's two in the order it appends them
    tri = _table(_FACES, n_in)                            # (K, 2, 3)
    faces = torch.gather(call_vert[:, None, :].expand(-1, 2, -1), 2, tri)
    two = torch.ones(faces.shape[:2], dtype=torch.bool, device=dev)
    two[:, 1] = n_in == 2
    return verts, faces[two].to(torch.int32)


def extract_mesh(density_fn: Callable, resolution: int = 128,
                 scale: float = 0.5, level: float = 20.0, device="cpu"):
    """density_fn: (N, 3) world points -> (N,) sigma.  Returns (verts
    (V, 3) f32 in world coordinates, faces (F, 3) int32); the default iso
    level ~20 is the reference notebook's sigma threshold."""
    values = density_grid_query(density_fn, resolution, scale,
                                device=device)
    verts, faces = marching_tetrahedra(values, level)
    return to_world(verts, resolution, scale), faces


def to_world(verts: torch.Tensor, resolution: int, scale: float):
    """Index space -> world: verts / (R - 1) * 2 * scale - scale, four
    float32 operations in that order."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=verts.device)

    return verts / f32(resolution - 1) * f32(2) * f32(scale) - f32(scale)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_mesh_obj(path: str, verts, faces):
    verts, faces = _host(verts), _host(faces)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def save_mesh_ply(path: str, verts, faces, colors=None):
    verts, faces = _host(verts), _host(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
