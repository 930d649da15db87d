"""Incremental test-time compositing (counterpart of
ngp_pl_tpu/ops/volume_render.py `composite_test_round`, reference
models/csrc/volumerendering.cu:205-285)."""
from __future__ import annotations

import torch

# Per-sample optical-depth ceiling: alpha = 1 - exp(-25) is 1.0 in f32 and
# the transmittance after such a sample is below every threshold, so the
# clamp changes no image while keeping the running sums finite.
SD_CLAMP = 25.0
# Segment optical depths are >= 0; the CSR training compositor clips its
# differenced prefix sums here (kept for the training slice).
_EXCL_MAX = 88.0


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
