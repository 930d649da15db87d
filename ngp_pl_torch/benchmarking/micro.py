"""The primitives behind the march and the encode at the bench's shapes, the
counterpart of benchmarking/micro.py.

    python -m ngp_pl_torch.benchmarking.micro [--device cuda] [--N 262144
        --log2_hashmap_size 19 --rays 8192 --chain 896 --pool 262144]

The JAX script's grid, `make_grid_spec()` (L=16, F=2, rows of 64 f32 =
256 B), and its inputs, drawn from `np.random.default_rng(0)` in its
order (`micro_prims.KeyDraws` for the arrays of its one key): the table
(rows, 64) ~ N(0, 1), L x N level-major slots uniform in
each level's range, the ray-coherent slots (runs of max(1, 1176 / R_l)
equal slots), d_rows (L*N, 64) ~ N(0, 1), the occupancy z-lines (16,384 x
4 u32, kept as int32 of the same bits: PyTorch indexes no uint32) and
rays*chain line indices, the top-k keys (rays, 144) ~ N(0, 1), a (rays,
chain) candidate occupancy 30% set, x (N, 3) ~ U(0, 1) and w1 (32, 64) ~
N(0, 1).  The JAX script draws the normal and uniform arrays with
jax.random; here they come from the numpy generator at their place in
that order, so their values differ and their shapes and dtypes do not.

Labels (`LABELS`, the JAX script's): the row gather of L*N slots, random
and ray-coherent; the scatter-add of d_rows into the whole table, per
level, per level ray-coherent, and deduplicated by run (`NOTES`); the
z-line gather; `torch.topk` and `torch.argsort`; the port's
`_compact_to_pool` (`ops/ray_march.py`; its arguments in its own order);
the encode's stages from the port's pieces (`slots_local_frac_lm`, the row
gather, the 27-point lane weights of `_lane_consts`, the product rounded
to bf16, the contraction with the expanded w1 in bf16 with f32 sums).
Beside them (`PORT_LABELS`): K6 (`scatter_rows`) on the per-level and the
ray-coherent inputs, K3 (the encode kernel of this grid) and K1 (the
flagship's L=8, F=4 grid at the same T, its own table drawn after the rest)
on the same x and w1.  `references` pairs each with its primitive.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ngp_pl_torch.benchmarking import micro_prims as mp

SHAPES = dict(N=262144, log2_hashmap_size=19, rays=8192, chain=896,
              pool=262144)
LABELS = ("row gather 4.2M x256B (random)",
          "row gather 4.2M x256B (ray-coherent)",
          "scatter-add 4.2M x256B whole-table",
          "scatter-add 4.2M x256B per-level",
          "scatter-add per-level (ray-coherent)",
          "scatter-add dedup-by-run (ray-coherent)",
          "occ z-line gather 7.3M x16B",
          "top_k (8192,144)->112",
          "argsort (8192,144)",
          "compact_to_pool (8192x896 -> 262144)",
          "encode: slots/frac math only",
          "encode: slots + row gather",
          "encode: + wrow product",
          "encode: + dot_general (full fwd)")
PORT_LABELS = ("port: K6 scatter_rows per-level",
               "port: K6 scatter_rows per-level (ray-coherent)",
               "port: K3 encode fwd (this grid)",
               "port: K1 encode fwd (L8F4 grid)")
KEYS = LABELS + PORT_LABELS
NOTES = {
    "scatter-add dedup-by-run (ray-coherent)": (
        "the JAX script's running sums `csum` and `endv` feed nothing, so "
        "XLA drops them and so does this; the run sums scatter with "
        + mp.DROP_NOTE),
    "occ z-line gather 7.3M x16B": "int32 rows of the u32 bits",
    "encode: + dot_general (full fwd)": (
        "the (L, W) contraction as one (N, L*W) @ (L*W, 64) mm: "
        + mp.BF16_MM_NOTE),
    "port: K1 encode fwd (L8F4 grid)": (
        "the JAX script's grid is L16F2, whose kernel is K3; K1 encodes "
        "the flagship L8F4 grid (the f16 copy of its own N(0, 1) table) on "
        "the same x and w1 (L*F = 32 rows either way), held against its "
        "plain version"),
}
TOPK_COLS, TOPK_K = 144, 112
CORNER_RUN = 1176               # the ray-coherent run length is this / R_l


def inputs(device: str, N: int = 262144, log2_hashmap_size: int = 19,
           rays: int = 8192, chain: int = 896, pool: int = 262144,
           seed: int = 0) -> dict:
    """The JAX script's inputs (see the module note), on `device`."""
    from ngp_pl_torch.config import TrainConfig
    from ngp_pl_torch.models.ngp import grid_spec_for
    from ngp_pl_torch.ops.hash_encoding import make_grid_spec

    spec = make_grid_spec(log2_hashmap_size=log2_hashmap_size)
    L, W = spec.n_levels, spec.row_width
    rng = np.random.default_rng(seed)
    key = mp.KeyDraws(rng)
    f32 = np.float32
    table = key.normal((spec.total_rows, W))
    slot = np.concatenate([
        rng.integers(spec.offsets[l], spec.offsets[l] + spec.sizes[l], N,
                     dtype=np.int32) for l in range(L)])
    slot_coh = []
    for l in range(L):
        run = max(1, int(CORNER_RUN / spec.resolutions[l]))
        s = rng.integers(spec.offsets[l], spec.offsets[l] + spec.sizes[l],
                         N // run + 1, dtype=np.int32)
        slot_coh.append(np.repeat(s, run)[:N])
    slot_coh = np.concatenate(slot_coh)
    d_rows = key.normal((L * N, W))
    occ_rows = rng.integers(0, 2 ** 32, (128 * 128, 4),
                            dtype=np.uint64).astype(np.uint32)
    line_idx = rng.integers(0, 128 * 128, rays * chain, dtype=np.int32)
    keys_a = key.normal((rays, TOPK_COLS))
    occ = rng.random((rays, chain)) < 0.3
    x = rng.random((N, 3), f32)
    w1 = rng.standard_normal((L * spec.n_features, 64), f32)
    spec8 = grid_spec_for(TrainConfig(
        log2_hashmap_size=log2_hashmap_size).ngp_config())
    table8 = rng.standard_normal((spec8.total_rows, spec8.row_width), f32)
    arrays = dict(table=table, slot=slot.astype(np.int64),
                  slot_coh=slot_coh.astype(np.int64), d_rows=d_rows,
                  occ_rows=occ_rows.view(np.int32),
                  line_idx=line_idx.astype(np.int64), keys_a=keys_a, occ=occ,
                  x=x, w1=w1, table8=table8)
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    t["t0"] = torch.zeros(rays, dtype=torch.float32, device=device)
    t.update(spec=spec, spec8=spec8, N=N, rays=rays, chain=chain, pool=pool)
    return t


def wrow_lm(local, frac, consts):
    """(L, N, W) trilinear lane weights, JAX's `_wrow_lm` (the product of
    the three axis weights, then the lane mask, in its order)."""
    cx, cy, cz, _, valid = consts

    def axis(c, a):
        la, fa = local[..., a, None], frac[..., a, None]
        return (c == la) * (1.0 - fa) + (c == la + 1) * fa

    return axis(cx, 0) * axis(cy, 1) * axis(cz, 2) * valid


def encode_fns(x, table, w1, spec) -> dict:
    """The encode's four stages by label, each a call of no arguments."""
    from ngp_pl_torch.ops import hash_encoding as he

    L, W = spec.n_levels, spec.row_width
    N = x.shape[0]
    consts = he._lane_consts(spec, x.device)

    def rows(slot):
        return table[slot.reshape(-1)].reshape(L, N, W)

    def wr():
        slot, local, frac = he.slots_local_frac_lm(x, spec)
        return (rows(slot) * wrow_lm(local, frac, consts)).to(
            torch.bfloat16)

    def full():
        w1big = he.expand_w1(w1, spec)
        return mp.mm_f32_out(wr().permute(1, 0, 2).reshape(N, L * W),
                             w1big.reshape(L * W, -1))

    return dict(zip(LABELS[10:], (
        lambda: he.slots_local_frac_lm(x, spec),
        lambda: rows(he.slots_local_frac_lm(x, spec)[0]),
        wr, full)))


def per_level(slot, d_rows, spec, N, scatter=None):
    """The per-level scatter-add: level l's N rows into its own (size_l,
    W) zeros, by `scatter(n_rows, idx, rows)` (the primitive by default)."""
    scatter = scatter or mp.scatter_add
    return [scatter(spec.sizes[l], slot[l * N:(l + 1) * N] - spec.offsets[l],
                    d_rows[l * N:(l + 1) * N])
            for l in range(spec.n_levels)]


def dedup(slot, d_rows, spec, N):
    """The JAX script's `scatter_dedup`, run for run (NOTES)."""
    parts = []
    for l in range(spec.n_levels):
        s = slot[l * N:(l + 1) * N]
        d = d_rows[l * N:(l + 1) * N]
        new = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device),
                         s[1:] != s[:-1]])
        seg_id = torch.cumsum(new.to(torch.int32), 0).to(torch.int64) - 1
        run_sum = mp.scatter_add(N, seg_id, d)
        size = spec.sizes[l]
        parts.append(mp.scatter_add(
            size, torch.where(new, s - spec.offsets[l], size),
            torch.where(new[:, None], run_sum, 0.0), drop=True))
    return parts


def functions(inp: dict) -> dict:
    """Every label's call of no arguments, LABELS then PORT_LABELS."""
    from ngp_pl_torch.ops import hash_encoding as he
    from ngp_pl_torch.ops.ray_march import _compact_to_pool

    spec, N = inp["spec"], inp["N"]
    table, d_rows = inp["table"], inp["d_rows"]
    slot, coh = inp["slot"], inp["slot_coh"]
    rows_total = spec.total_rows
    fns = dict(zip(LABELS[:10], (
        lambda: table[slot],
        lambda: table[coh],
        lambda: mp.scatter_add(rows_total, slot, d_rows),
        lambda: per_level(slot, d_rows, spec, N),
        lambda: per_level(coh, d_rows, spec, N),
        lambda: dedup(coh, d_rows, spec, N),
        lambda: inp["occ_rows"][inp["line_idx"]],
        lambda: torch.topk(inp["keys_a"], TOPK_K),
        lambda: torch.argsort(inp["keys_a"], dim=1, stable=True),
        lambda: _compact_to_pool(inp["occ"], inp["t0"], 1024, inp["pool"],
                                 0.001, 0.0, 0.01))))
    fns.update(encode_fns(inp["x"], table, inp["w1"], spec))
    spec8 = inp["spec8"]
    t16 = he.table_f16(inp["table8"])
    fns.update(zip(PORT_LABELS, (
        lambda: per_level(slot, d_rows, spec, N, mp.k6_scatter),
        lambda: per_level(coh, d_rows, spec, N, mp.k6_scatter),
        lambda: he.hash_encode_fwd(inp["x"], table, inp["w1"], spec),
        lambda: he.hash_encode_fwd(inp["x"], t16, inp["w1"], spec8))))
    return fns


def references(inp: dict, fns: dict) -> dict:
    """Each `port: ` label's kernel and its primitive's call on the same
    input."""
    from ngp_pl_torch.ops import hash_encoding as he

    t16 = he.table_f16(inp["table8"])
    return {PORT_LABELS[0]: ("K6", fns[LABELS[3]]),
            PORT_LABELS[1]: ("K6", fns[LABELS[4]]),
            PORT_LABELS[2]: ("K3", fns[LABELS[13]]),
            PORT_LABELS[3]: ("K1", lambda: he.hash_encode_fwd_plain(
                inp["x"], t16, inp["w1"], inp["spec8"]))}


def run(device: str = "cuda", runs: int = 20, warmup: int = 3,
        log=sys.stderr, **shape) -> dict:
    """Every label timed; returns {label: {"wall_ms", "device_ms"}}."""
    inp = inputs(device, **shape)
    spec = inp["spec"]
    if log is not None:
        print(f"table rows {spec.total_rows} "
              f"({spec.total_rows * spec.row_width * 4 / 1e6:.0f} MB fp32)",
              file=log)
    return mp.time_labels(functions(inp), device, runs, warmup, log)


def main(argv=None) -> dict:
    return mp.main(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
