"""The forward stage by stage from a state whose next step goes
non-finite, on the kernels' path and on the plain path: the counterpart of
benchmarking/nan_probe.py.

`probe(system)` runs from the system's state as it stands (`nan_hunt`
restores the state from just before the failing step).  The batch: the
one the system's next step would draw, from its generators in the step's
order (`NeRFSystem._train_step`: the batch, the rays, the march noise,
the background; the generators advance as the step's would), or `batch`
(rays_o, rays_d, target, noise, bg) given explicitly.  Then, each with
its absmax and its NaN and inf counts (`stat`), under the JAX script's
names:
  params   every parameter leaf
  march    the positions `ts` and steps `deltas` of the CSR pool, its
           total and the largest per-ray count (the JAX script's window
           march into the pool, `rendering.march_train`)
and on each path ("kernels": K1 and K7 on the card; "plain": every hand
kernel replaced by its plain version, `plain.plain_versions`; on the CPU
both are the plain versions):
  h1 (encode+L1), sigma logits h[:,0], sigma (xla stack)   the encode
           and the density MLP as PyTorch ops (`mlp_apply`, TruncExp)
  sigma (full fwd), rgb (full fwd)   `NGP.forward` (the fused tail)
  opacity, rgb composited, depth      `composite_train`
  mse, opacity-entropy                the loss's two terms
  loss, grad[...]                     the step's own loss
           (`train_step.train_render` in the system's layout) and its
           gradient to every parameter
Returns the record: each path's first non-finite stage, the first
non-finite parameter leaf (else the first non-finite gradient leaf of
the kernels' path), and `kernels_vs_plain`: the kernels' path's h1
against the plain path's (error of max |h1|; chip_smoke.py's K1_TOL),
its rgb against the plain tail's on the same h1 and directions (absolute,
K7 alone on the same inputs, with the fused tail only; read: on a trained
state one hidden value that K7's sums round to the other bf16 neighbour
than the plain tail's moves rgb by up to ~7e-3 on an H100), and its rgb
against the plain path's (absolute, read: each bf16 flip of an h1 that
K1 computed within its limit moves rgb ~1e-3).  With the fused tail,
`tail_check(h1, sh, w2, wr1, wr2, wr3)`, where given, is called on the
kernels' path's inputs of the tail and its result kept as `tail_check`
(chip_smoke.py holds K7 there by its own bf16 roundings).
"""
from __future__ import annotations

import math

import torch

PATHS = ("kernels", "plain")


def stat(name, x, out: dict, log=print) -> int:
    """Absmax of the finite values, NaN and inf counts of `x`, logged as
    the JAX script logs them and kept in `out[name]`; returns the count
    of non-finite values."""
    a = torch.as_tensor(x).detach().double().cpu()
    finite = torch.isfinite(a)
    mx = float(a[finite].abs().max()) if bool(finite.any()) else math.nan
    nan, inf = int(torch.isnan(a).sum()), int(torch.isinf(a).sum())
    out[name] = {"absmax": mx, "nan": nan, "inf": inf}
    if log:
        log(f"    {name:32s} absmax {mx:12.4e} nan {nan:6d} inf {inf:6d}")
    return nan + inf


def leaf_name(name, i) -> str:
    """A parameter's name as the JAX script prints its tree path."""
    return f"['{name}']" + ("" if i is None else f"[{i}]")


def next_batch(system):
    """(rays_o, rays_d, target, noise, bg) of the system's next step,
    drawn as `NeRFSystem._train_step` draws them."""
    from ngp_pl_torch import parallel
    from ngp_pl_torch.datasets.ray_utils import get_rays

    tcfg, dev = system.tcfg, system.dev
    img, pix, payload = system.sample_batch()
    if system.pose is not None:
        rays_o, rays_d = system.pose.rays(system.directions[pix],
                                          system.poses, img)
    else:
        rays_o, rays_d = get_rays(system.directions[pix], system.poses[img])
    noise = parallel.shard(torch.rand(tcfg.batch_size,
                                      generator=system.generator,
                                      device=dev))
    return (rays_o.detach().contiguous(), rays_d.detach().contiguous(),
            payload[:, :3], noise, system.background())


def _path(system, m, rays_o, rays_d, target, noise, bg, log) -> dict:
    """The field, compositing and loss stages of one path."""
    from ngp_pl_torch.models.ngp import mlp_apply
    from ngp_pl_torch.ops.ray_march import _fma
    from ngp_pl_torch.ops.trunc_exp import trunc_exp
    from ngp_pl_torch.ops.volume_render import composite_train
    from ngp_pl_torch.training.train_step import train_render

    ngp, rcfg, tcfg = system.ngp, system.rcfg, system.tcfg
    B = rays_o.shape[0]
    stats, first = {}, None

    def note(name, x):
        nonlocal first
        if stat(name, x, stats, log) and first is None:
            first = name

    ridx = torch.clamp(m.ray_idx, 0, B - 1)
    d = rays_d[ridx]
    xyz = _fma(m.ts[:, None], d, rays_o[ridx])
    with torch.no_grad():
        h1 = ngp._h1(xyz)
        note("h1 (encode+L1)", h1)
        h = mlp_apply(ngp.sigma_mlp[1:], torch.relu(h1))
        note("sigma logits h[:,0]", h[:, 0])
        note("sigma (xla stack)", trunc_exp(h[:, 0]))
        sigmas, rgbs = ngp(xyz, d)
        note("sigma (full fwd)", sigmas)
        note("rgb (full fwd)", rgbs)
        out = composite_train(sigmas, rgbs, m.deltas, m.ts, m.ray_idx,
                              m.valid, m.offsets, n_rays=B,
                              T_threshold=rcfg.t_threshold)
        note("opacity", out["opacity"])
        note("rgb composited", out["rgb"])
        note("depth", out["depth"])
        rgb_full = out["rgb"] + bg[None, :] * (1.0 - out["opacity"][:, None])
        note("mse", ((rgb_full - target) ** 2).mean())
        oc = torch.clamp(out["opacity"], 1e-10, 1.0 - 1e-10)
        note("opacity-entropy", -oc * torch.log(oc))
    gs = system.grid_state
    _, loss_of = train_render(
        ngp, gs.win_rows if system.window_march else None, rays_o, rays_d,
        noise, bg, tcfg=tcfg, rcfg=rcfg, n_samples=system._pool_mult,
        chain_length=system.step_chain(), layout=system.layout,
        occ_grid=gs.occ_grid)
    loss = loss_of(target)
    note("loss", loss)
    slots = list(ngp._slots())
    grads = torch.autograd.grad(loss, [w for _, _, w in slots])
    bad_grad = None
    for (name, i, _), g in zip(slots, grads):
        if stat("grad" + leaf_name(name, i), g, stats, log) and (
                bad_grad is None):
            bad_grad = "grad" + leaf_name(name, i)
    return {"stats": stats, "first_bad_stage": first,
            "first_bad_grad": bad_grad, "h1": h1, "rgb": rgbs,
            "sh": ngp._sh(d)}


def probe(system, batch=None, log=print, tail_check=None) -> dict:
    """The stages of the system's next step on both paths; the record
    (see the module's docstring)."""
    from ngp_pl_torch.benchmarking.plain import ALL, plain_versions
    from ngp_pl_torch.models.rendering import march_train
    from ngp_pl_torch.ops.field_tail import field_tail_plain

    rays_o, rays_d, target, noise, bg = batch or next_batch(system)
    if log:
        log("  [probe] params:")
    params = {}
    bad_leaf = None
    for name, i, w in system.ngp._slots():
        if stat(leaf_name(name, i), w, params, log) and bad_leaf is None:
            bad_leaf = "params" + leaf_name(name, i)
    gs = system.grid_state
    m = march_train(system.cfg, system.rcfg, rays_o, rays_d, noise,
                    gs.win_rows if system.window_march else None,
                    layout="csr", slots=system._pool_mult,
                    chain_length=system.chain_length, occ_grid=gs.occ_grid)
    march = {}
    if log:
        log("  [probe] march:")
    stat("ts", m.ts, march, log)
    stat("deltas", m.deltas, march, log)
    march.update(total=int(m.total), rm_max=int(m.rm_counts.max()))
    if log:
        log(f"    total {march['total']} rm_max {march['rm_max']}")
    paths = {}
    for tag in PATHS:
        if log:
            log(f"  [probe] field path = {tag}:")
        args = (system, m, rays_o, rays_d, target, noise, bg, log)
        if tag == "plain":
            with plain_versions(*ALL):
                paths[tag] = _path(*args)
        else:
            paths[tag] = _path(*args)
    k, p = paths["kernels"], paths["plain"]
    compare = {"h1_max_rel_err": float((k["h1"] - p["h1"]).abs().max()
                                       / p["h1"].abs().max()),
               "rgb_paths_max_abs_err": float(
                   (k["rgb"] - p["rgb"]).abs().max())}
    ngp = system.ngp
    if ngp.use_fused:
        ws = [w.detach() for w in (ngp.sigma_mlp[1], *ngp.rgb_mlp)]
        _, rgb = field_tail_plain(k["h1"], k["sh"], *ws)
        compare["k7_rgb_max_abs_err"] = float((k["rgb"] - rgb).abs().max())
    checked = (tail_check(k["h1"], k["sh"], *ws)
               if ngp.use_fused and tail_check else None)
    return {"params": params, "march": march,
            "paths": {t: {"stats": r["stats"],
                          "first_bad_stage": r["first_bad_stage"],
                          "first_bad_grad": r["first_bad_grad"]}
                      for t, r in paths.items()},
            "first_bad_stage": {t: r["first_bad_stage"]
                                for t, r in paths.items()},
            "first_bad_leaf": bad_leaf or k["first_bad_grad"],
            "kernels_vs_plain": compare, "tail_check": checked}
