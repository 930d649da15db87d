"""The mip-NeRF 360 distortion loss in the DVGO-v2 prefix-sum form
(counterpart of ngp_pl_tpu/ops/distortion.py; reference
models/csrc/losses.cu:9-175):

    loss_ray = sum_s [ 2 (wts_in_s ws_ex_s - ws_in_s wts_ex_s)
                       + w_s^2 delta_s / 3 ]

with *_in / *_ex the inclusive / exclusive prefix sums of w and w t along
the ray.  The CSR form takes them with the compositor's segment scan, the
strided form as cumsums over S; autograd gives the reference's
hand-written backward.  Plain PyTorch: the JAX package wrote no Pallas
kernel here."""
from __future__ import annotations

import torch

from ngp_pl_torch.ops.volume_render import segment_excl_cumsum


def _per_sample(w, ws_in, ws_ex, wts_in, wts_ex, deltas):
    return 2.0 * (wts_in * ws_ex - ws_in * wts_ex) + (w * w * deltas) / 3.0


def distortion_loss(ws, deltas, ts, ray_idx, valid, offsets,
                    n_rays: int) -> torch.Tensor:
    """Per-ray loss (N,) over the CSR pool (distortion.py:24-43): ws,
    deltas, ts, ray_idx (N on unused slots), valid (P,); offsets (N,)."""
    w = torch.where(valid, ws, 0.0)
    wt = w * ts
    ws_ex = segment_excl_cumsum(w, offsets, ray_idx)
    wts_ex = segment_excl_cumsum(wt, offsets, ray_idx)
    per = _per_sample(w, ws_ex + w, ws_ex, wts_ex + wt, wts_ex, deltas)
    seg = torch.where(valid, ray_idx, n_rays)
    out = torch.zeros(n_rays + 1, dtype=per.dtype, device=per.device)
    return out.index_add(0, seg, per)[:-1]


def distortion_loss_strided(ws, deltas, ts, valid) -> torch.Tensor:
    """Per-ray loss (N,) over the strided (N, S) layout
    (distortion.py:46-61)."""
    w = torch.where(valid, ws, 0.0)
    wt = w * ts
    ws_in = torch.cumsum(w, dim=1)
    wts_in = torch.cumsum(wt, dim=1)
    per = _per_sample(w, ws_in, ws_in - w, wts_in, wts_in - wt, deltas)
    return per.sum(dim=1)
