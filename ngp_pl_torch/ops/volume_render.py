"""Volume compositing (counterpart of ngp_pl_tpu/ops/volume_render.py):
the CSR train compositor over the flat sample pool (`composite_train`,
reference models/csrc/volumerendering.cu:6-202), its strided form over
(N, S) rows (`composite_train_strided`) and the incremental test-time
round (`composite_test_round`, volumerendering.cu:205-285).

All are plain PyTorch: the JAX package wrote no Pallas kernel here, and
autograd of the train compositor gives the reference's hand-written
backward, as JAX autodiff does."""
from __future__ import annotations

import torch

# Per-sample optical-depth ceiling: alpha = 1 - exp(-25) is 1.0 in f32 and
# the transmittance after such a sample is below every threshold, so the
# clamp changes no image while keeping the running sums finite.
SD_CLAMP = 25.0
# Segment optical depths are >= 0; the CSR training compositor clips its
# differenced prefix sums here (T floor e^-88, harmless).
_EXCL_MAX = 88.0


def segment_excl_cumsum(x, offsets, ray_idx):
    """Exclusive cumsum within the contiguous segments of a flat pool
    (volume_render.py:46-58).  x (P,) is 0 in invalid slots; offsets (N,)
    are segment starts; ray_idx (P,) the owning segment (N when unused).

    The global prefix is accumulated in float64 and rounded to float32 on
    either device, which is what PyTorch's CPU cumsum does for float32
    (bit for bit).  CUDA's float32 cumsum accumulates in float32: a trained
    field's batch sums its optical depths to ~1.8e5 over the pool, so an
    f32 running sum misses a sample's local depth, a difference of two
    prefixes, by up to 0.15 where the double-accumulated prefix misses it
    by 0.03, and on the card training from a fitted state went to twice
    the CPU's loss on the same batches (ROADMAP, PR 11)."""
    c = torch.cumsum(x, dim=0, dtype=torch.float64).to(x.dtype)
    excl = c - x
    # index_select, not x[idx]: its backward is an index_add_, where
    # advanced indexing's sorts the indices on CUDA
    seg_base = excl.index_select(0, torch.clamp(offsets, 0, x.shape[0] - 1))
    ridx = torch.clamp(ray_idx, 0, offsets.shape[0] - 1)
    return torch.clamp(excl - seg_base.index_select(0, ridx), 0.0, _EXCL_MAX)


def composite_train(sigmas, rgbs, deltas, ts, ray_idx, valid, offsets,
                    n_rays: int, T_threshold: float = 1e-4):
    """Differentiable front-to-back compositing of the pool
    (volume_render.py:61-97): per-ray opacity, depth and rgb, the
    per-sample weights `ws` and the per-ray effective sample count
    `vr_samples`.  Early termination is the mask T > T_threshold; the
    segment sums go into N + 1 segments, the last (unused slots) dropped."""
    sd = torch.where(valid, torch.clamp_max(sigmas * deltas, SD_CLAMP), 0.0)
    excl = segment_excl_cumsum(sd, offsets, ray_idx)
    T = torch.exp(-excl)
    alpha = 1.0 - torch.exp(-sd)
    keep = valid & (T > T_threshold)
    w = torch.where(keep, alpha * T, 0.0)
    seg = torch.where(valid, ray_idx, n_rays)
    payload = torch.cat([w[:, None], (w * ts)[:, None], w[:, None] * rgbs,
                         keep[:, None].to(w.dtype)], dim=1)      # (P, 6)
    sums = torch.zeros((n_rays + 1, 6), dtype=w.dtype, device=w.device)
    sums = sums.index_add(0, seg, payload)[:-1]
    return {"opacity": sums[:, 0], "depth": sums[:, 1], "rgb": sums[:, 2:5],
            "ws": w, "vr_samples": sums[:, 5].detach().to(torch.int32)}


def composite_train_strided(sigmas, rgbs, deltas, ts, valid,
                            T_threshold: float = 1e-4):
    """The train compositor over the strided layout (volume_render.py:
    100-130): ray r owns row r, so the segment scan is a cumsum over S and
    each per-ray sum a row sum.  sigmas, deltas, ts, valid (N, S); rgbs
    (N, S, 3), where the JAX package keeps channel-major (3, N, S) rows for
    the TPU's lanes."""
    sd = torch.where(valid, torch.clamp_max(sigmas * deltas, SD_CLAMP), 0.0)
    excl = torch.cumsum(sd, dim=1) - sd
    T = torch.exp(-excl)
    alpha = 1.0 - torch.exp(-sd)
    keep = valid & (T > T_threshold)
    w = torch.where(keep, alpha * T, 0.0)
    return {"opacity": w.sum(dim=1), "depth": (w * ts).sum(dim=1),
            "rgb": (w[:, :, None] * rgbs).sum(dim=1), "ws": w,
            "vr_samples": keep.sum(dim=1, dtype=torch.int32)}


def composite_test_round(sigmas, rgbs, deltas, ts, sample_valid, opacity,
                         depth, rgb, alive, T_threshold: float):
    """One round of incremental compositing: resume at T = 1 - opacity,
    accumulate this round's (N, S) samples, kill converged rays.
    Returns the updated (opacity, depth, rgb, alive)."""
    sd = torch.where(sample_valid & alive[:, None],
                     torch.clamp_max(sigmas * deltas, SD_CLAMP), 0.0)
    excl = torch.cumsum(sd, dim=1) - sd
    T0 = (1.0 - opacity)[:, None]
    T = T0 * torch.exp(-excl)
    alpha = 1.0 - torch.exp(-sd)
    w = torch.where(T > T_threshold, alpha * T, 0.0)

    opacity = opacity + w.sum(dim=1)
    depth = depth + (w * ts).sum(dim=1)
    rgb = rgb + (w[:, :, None] * rgbs).sum(dim=1)

    T_final = T0[:, 0] * torch.exp(-sd.sum(dim=1))
    alive = alive & (T_final > T_threshold)
    return opacity, depth, rgb, alive
