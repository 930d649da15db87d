"""Port parity for pose refinement (`--optimize_ext`): the rotation of a
pose correction, the hash encode with a position gradient, the field with
gradients to positions and directions, one train step in each layout with
the per-image dR and dT under their own Adam, two blocks of the system
and the full checkpoint's pose state, against the JAX package.

The JAX side runs as the JAX package runs it with `need_x_grad=True`: the
XLA encode `_encode_mlp_cv` and the XLA tail, no Pallas kernel (the
interpreted-Pallas substitution of the other tests ignores `need_x_grad`
and is not used here).  Sizes: grid 32, L=4, log2 T=12, 256 rays of 24x24
views; inputs from numpy seeds, the noise and the batches passed in."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.ray_utils import axisangle_to_R as jax_axisangle
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.ops import ray_march as jrm
from ngp_pl_tpu.training import checkpoint as jckpt
from ngp_pl_tpu.training import train_step as jts
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch.config import NGPConfig, RenderConfig, TrainConfig
from ngp_pl_torch.datasets.ray_utils import axisangle_to_R
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.ops import hash_encoding as the
from ngp_pl_torch.ops import ray_march as trm
from ngp_pl_torch.training import train_step as tts
from ngp_pl_torch.training.checkpoint import (
    grid_state_from_numpy,
    load_pose_state,
    load_train_state,
    pose_state_numpy,
    train_state_numpy,
)
from ngp_pl_torch.training.system import NeRFSystem

torch.set_num_threads(2)

G = 32
KW = dict(scale=0.5, n_levels=4, log2_hashmap_size=12, grid_size=G)


def _of_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_axisangle_to_R_and_its_gradient_match_jax():
    """Rodrigues with the 1e-14 safe norm: R within 1e-6 at random
    axis-angles and at 0; the gradient of sum(R * W) within 1e-6 of its
    max, finite at v = 0, where the plain norm's is 0/0."""
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(6, 3)) * 0.3).astype(np.float32)
    v[0] = 0.0
    W = rng.normal(size=(6, 3, 3)).astype(np.float32)
    r_j = np.asarray(jax_axisangle(jnp.asarray(v)))
    g_j = np.asarray(jax.grad(lambda a: jnp.sum(jax_axisangle(a) * W))(
        jnp.asarray(v)))
    vt = torch.from_numpy(v).requires_grad_(True)
    r_t = axisangle_to_R(vt)
    (g_t,) = torch.autograd.grad((r_t * torch.from_numpy(W)).sum(), vt)
    np.testing.assert_allclose(r_t.detach().numpy(), r_j, atol=1e-6)
    np.testing.assert_allclose(r_t[0].detach().numpy(), np.eye(3), atol=0)
    assert np.isfinite(g_t.numpy()).all()
    assert _of_max(g_t.numpy(), g_j) <= 1e-6
    assert np.abs(g_t[0].numpy()).max() > 0      # v = 0 still moves
    assert axisangle_to_R(vt[1]).shape == (3, 3)


def test_rays_and_pose_products_bit_equal_jax():
    """`get_rays` (one pose per ray and one for all) and the 3x3 products
    of `apply_pose_refinement` sum as XLA's CPU dot does (an FMA chain,
    `_dot3`): the rays are JAX's bit for bit, the refined poses within
    1e-6 (sin and cos differ in the last bits)."""
    from ngp_pl_tpu.datasets.ray_utils import get_rays as jax_get_rays
    from ngp_pl_torch.datasets.ray_utils import get_rays, matmul3

    rng = np.random.default_rng(3)
    c2w = rng.normal(size=(512, 3, 4)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    for pose in (c2w, c2w[0]):
        o_j, d_j = jax.jit(jax_get_rays)(jnp.asarray(d), jnp.asarray(pose))
        o_t, d_t = get_rays(torch.from_numpy(d), torch.from_numpy(pose))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    a, b = c2w[:, :, :3], c2w[::-1, :, :3].copy()
    np.testing.assert_array_equal(
        matmul3(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax.jit(jnp.matmul)(a, b)))
    img = rng.integers(0, 2, 64)
    pp = {k: (rng.normal(size=(2, 3)) * 0.05).astype(np.float32)
          for k in ("dR", "dT")}
    want = np.asarray(jax.jit(jts.apply_pose_refinement)(
        jnp.asarray(c2w[:64]), pp, jnp.asarray(img)))
    got = tts.apply_pose_refinement(
        torch.from_numpy(c2w[:64]), {k: torch.from_numpy(v)
                                     for k, v in pp.items()},
        torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("F", [4, 2])
def test_xgrad_encode_matches_jax(F):
    """`hash_encode_mlp_xgrad` against `_encode_mlp_cv(need_x_grad=True)`
    (what `hash_encode_mlp` runs on any device when positions need a
    gradient), on 300 points of which some lie outside [0, 1]^3: h1 within
    1e-5 of its max; the table and w1 gradients within 1e-5 and the
    position gradient within 1e-4 of their max, 0 outside the open box
    (readings at F=4 / F=2: h1 2.8e-7 / 1.8e-7, d_table 1.3e-7 / 7.7e-8,
    d_w1 1.4e-7 / 2.2e-7, d_x 1.8e-7 / 1.1e-7)."""
    cfg = JaxNGPConfig(**KW, n_features_per_level=F)
    jngp = JaxNGP(cfg, need_x_grad=True)
    params = jngp.init(jax.random.PRNGKey(1))
    table = np.asarray(params["hash_table"]) * 1e3
    w1 = np.array(params["sigma_mlp"][0])
    rng = np.random.default_rng(F)
    x = rng.uniform(-0.05, 1.05, (300, 3)).astype(np.float32)
    g = rng.normal(size=(300, 64)).astype(np.float32)

    def f(x, table, w1):
        return jhe.hash_encode_mlp(x, table, w1, jngp.spec, need_x_grad=True)

    h_j, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(table),
                       jnp.asarray(w1))
    dx_j, dt_j, dw_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    spec = NGP(NGPConfig(**KW, n_features_per_level=F), device="cpu").spec
    xt, tt, wt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, table, w1))
    calls = dict(the.XGRAD_CALLS)
    h_t = the.hash_encode_mlp_xgrad(xt, tt, wt, spec)
    dx_t, dt_t, dw_t = torch.autograd.grad(h_t, (xt, tt, wt),
                                           torch.from_numpy(g))
    assert the.XGRAD_CALLS["xgrad_encode_fwd"] == calls[
        "xgrad_encode_fwd"] + 1
    assert the.XGRAD_CALLS["xgrad_encode_bwd"] == calls[
        "xgrad_encode_bwd"] + 1
    readings = {"h1": _of_max(h_t.detach().numpy(), h_j),
                "d_table": _of_max(dt_t.numpy(), dt_j),
                "d_w1": _of_max(dw_t.numpy(), dw_j),
                "d_x": _of_max(dx_t.numpy(), dx_j)}
    print("x-grad encode readings", F, readings)
    assert readings["h1"] <= 1e-5 and readings["d_table"] <= 1e-5
    assert readings["d_w1"] <= 1e-5 and readings["d_x"] <= 1e-4
    outside = (x <= 0) | (x >= 1)          # per coordinate, as in_box
    assert outside.any() and (dx_t.numpy()[outside] == 0).all()
    assert (dx_j[outside] == 0).all() and np.abs(dx_j[~outside]).max() > 0


def _jax_params(seed=0, hdr=False, F=4):
    cfg = JaxNGPConfig(**KW, n_features_per_level=F,
                       rgb_act="None" if hdr else "Sigmoid")
    jngp = JaxNGP(cfg, need_x_grad=True)
    params = jngp.init(jax.random.PRNGKey(seed))
    params["hash_table"] = params["hash_table"] * 1e3
    params["sigma_mlp"][1] = params["sigma_mlp"][1].at[:, 0].multiply(4.0)
    return jngp, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, hdr=False, F=4, need_x_grad=True):
    ngp = NGP(NGPConfig(**KW, n_features_per_level=F,
                        rgb_act="None" if hdr else "Sigmoid"),
              device="cpu", need_x_grad=need_x_grad)
    ngp.load_params(params)
    return ngp


def _named_grads(ngp, grads):
    return {(n, i): g for (n, i, _), g in zip(ngp._slots(), grads)}


_jax_leaf = NGP._leaf          # a leaf of a nest in the JAX layout


@pytest.mark.parametrize("F", [4, 2])
def test_pose_field_forward_and_gradients_match_jax(F):
    """`NGP(need_x_grad=True)` against JAX's `NGP(need_x_grad=True)` under
    jit: sigma and rgb (the x-grad encode and the XLA tail, no fused
    kernel) and the gradients of a weighted sum to positions, directions
    and every parameter, each within 1e-5 of its max (readings 0 to
    2.8e-7: the tail's rounding points are XLA's, `mlp_apply`)."""
    jngp, params = _jax_params(F=F)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.45, 0.45, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    ws, wr = (rng.normal(size=s).astype(np.float32)
              for s in ((256,), (256, 3)))

    def f(p, x, d):
        s, r = jngp.forward(p, x, d)
        return jnp.sum(s * ws) * 1e-2 + jnp.sum(r * wr), (s, r)

    (_, (s_j, r_j)), g_j = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            jnp.asarray(d))
    ngp = _port_model(params, F=F)
    assert not ngp.use_fused
    xt, dt = (torch.from_numpy(a).requires_grad_(True) for a in (x, d))
    s_t, r_t = ngp(xt, dt)
    obj = (s_t * torch.from_numpy(ws)).sum() * 1e-2 + (
        r_t * torch.from_numpy(wr)).sum()
    ps = [w for _, _, w in ngp._slots()]
    grads = torch.autograd.grad(obj, ps + [xt, dt])
    assert _of_max(s_t.detach().numpy(), s_j) <= 1e-5
    assert _of_max(r_t.detach().numpy(), r_j) <= 1e-5
    for (n, i), g in _named_grads(ngp, grads[:len(ps)]).items():
        assert _of_max(g.numpy(), _jax_leaf(g_j[0], n, i)) <= 1e-5, (n, i)
    assert _of_max(grads[-2].numpy(), g_j[1]) <= 1e-5
    assert _of_max(grads[-1].numpy(), g_j[2]) <= 1e-5
    assert np.abs(np.asarray(g_j[2])).max() > 0


# --- one train step against make_train_step -------------------------------

N_RAYS = 256
STEP_LR = dict(lr=1e-2, num_epochs=2, iters_per_epoch=4)
# (budget, chain) of each layout, as the one-step test of the flagship
LAYOUT_STEP = {"csr": (8, 1152), "strided": (8, 1152), "rounds": (8, 256)}
STEP_LAM = {"csr": 0.0, "strided": 0.0, "rounds": 1e-2}


def _opt_state(opt, trainable, mu, nu, count):
    """optax state of `opt` for `trainable` with its Adam moments set to
    the nests `mu`, `nu` (the trainable's layout) and every count to
    `count` (plain adam, or `multi_transform` with --optimize_ext)."""
    flat = {fmt: {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_flatten_with_path(src)[0]}
            for fmt, src in ((".mu", mu), (".nu", nu))}

    def put(path, leaf):
        k = jax.tree_util.keystr(path)
        if k.endswith("count"):
            return jnp.asarray(count, jnp.int32)
        for tag, src in flat.items():
            if tag in k:
                return jnp.asarray(src[k[k.index(tag) + 3:]])
        return leaf

    return jax.tree_util.tree_map_with_path(put, opt.init(trainable))


def _moments(opt_state, trainable):
    """(mu, nu) of every Adam in `opt_state`, as nests of `trainable`."""
    out = []
    for tag in (".mu", ".nu"):
        got = {}
        for p, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
            k = jax.tree_util.keystr(p)
            if tag in k:
                got[k[k.index(tag) + 3:]] = np.asarray(v)
        paths, treedef = jax.tree_util.tree_flatten_with_path(trainable)
        out.append(jax.tree_util.tree_unflatten(
            treedef, [got[jax.tree_util.keystr(p)] for p, _ in paths]))
    return out


def step_case(layout, *, pose, hdr, exposure=False, F=4):
    """Inputs of one train step: the JAX and port models, the step's
    configs, the scene's poses and directions, a batch (image, pixel, rgb
    and, with `exposure`, a per-ray exposure in 0.25-4), the grid, the
    march noise JAX's step draws from its key, and non-zero poses."""
    jngp, params = _jax_params(seed=2, hdr=hdr, F=F)
    jngp.need_x_grad = pose
    lam = STEP_LAM[layout]
    jcfg = JaxTrainConfig(**STEP_LR, batch_size=N_RAYS, optimize_ext=pose,
                          use_exposure=hdr, distortion_loss_w=lam)
    tcfg = TrainConfig(**STEP_LR, batch_size=N_RAYS, optimize_ext=pose,
                       use_exposure=hdr, distortion_loss_w=lam)
    ds = JaxSynthetic(split="train", img_size=24, n_train=2)
    rng = np.random.default_rng(7)
    img = rng.integers(0, 2, N_RAYS).astype(np.int32)
    pix = rng.integers(0, ds.directions.shape[0], N_RAYS).astype(np.int32)
    batch = {"img_idxs": img, "pix_idxs": pix,
             "rgb": rng.random((N_RAYS, 3)).astype(np.float32)}
    if exposure:
        batch["exposure"] = np.exp(rng.uniform(np.log(0.25), np.log(4.0), (
            N_RAYS, 1))).astype(np.float32)
    from tests.test_torch_train import _shell_grid
    occ = _shell_grid()
    key = jax.random.PRNGKey(11)
    k_noise, _ = jax.random.split(jax.random.fold_in(key, 5))
    noise = np.array(jax.random.uniform(k_noise, (N_RAYS,)))
    pose_params = {k: (rng.normal(size=(2, 3)) * 0.02).astype(np.float32)
                   for k in ("dR", "dT")}
    return dict(jngp=jngp, params=params, jcfg=jcfg, tcfg=tcfg,
                poses=np.asarray(ds.poses, np.float32),
                dirs=np.asarray(ds.directions, np.float32), batch=batch,
                occ=occ, key=key, noise=noise, pose_params=pose_params,
                layout=layout, pose=pose)


def jax_step(c, mu, nu, count=5):
    """JAX's `make_train_step` from the case's params (and poses) with the
    given moments at `count`: (metrics, new TrainState)."""
    pose = c["pose"]
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    pp = jax.tree_util.tree_map(jnp.asarray, c["pose_params"])
    trainable = {"net": params, "pose": pp} if pose else params
    opt = jts.make_optimizer(c["jcfg"])
    st = jts.TrainState(params=params, pose_params=pp if pose else {},
                        opt_state=_opt_state(opt, trainable, mu, nu, count),
                        step=jnp.asarray(count, jnp.int32))
    budget, chain = LAYOUT_STEP[c["layout"]]
    fn = jts.make_train_step(c["jngp"], c["jcfg"], c["jcfg"].render_config())
    occ = jnp.asarray(c["occ"])
    new, metrics = fn(st, occ, jnp.asarray(c["poses"]),
                      jnp.asarray(c["dirs"]),
                      jax.tree_util.tree_map(jnp.asarray, c["batch"]),
                      c["key"], budget, chain,
                      win_rows=jrm.occupancy_windows(occ),
                      layout=c["layout"])
    return metrics, new, trainable


def jax_grads(c):
    """JAX's gradients of the step, read from the first moments of a step
    from zero moments (mu' = 0.1 g): (loss, grads nest of the
    trainable)."""
    pose = c["pose"]
    zeros = jax.tree_util.tree_map(np.zeros_like, (
        {"net": c["params"], "pose": c["pose_params"]} if pose
        else c["params"]))
    metrics, new, trainable = jax_step(c, zeros, zeros)
    mu, _ = _moments(new.opt_state, trainable)
    g = jax.tree_util.tree_map(lambda m: m / np.float32(0.1), mu)
    return float(metrics["loss"]), g


def _net(tree, pose):
    return tree["net"] if pose else tree


def port_step_parts(c):
    """The port's model (, poses) and rays of the case."""
    hdr = c["tcfg"].use_exposure
    ngp = _port_model(c["params"], hdr=hdr, need_x_grad=c["pose"])
    poses = torch.from_numpy(c["poses"])
    img = torch.from_numpy(c["batch"]["img_idxs"].astype(np.int64))
    dirs = torch.from_numpy(c["dirs"])[
        torch.from_numpy(c["batch"]["pix_idxs"].astype(np.int64))]
    pr = None
    if c["pose"]:
        pr = tts.PoseRefinement(2, c["tcfg"].pose_lr, "cpu")
        with torch.no_grad():
            pr.dR.copy_(torch.from_numpy(c["pose_params"]["dR"]))
            pr.dT.copy_(torch.from_numpy(c["pose_params"]["dT"]))
        ro, rd = pr.rays(dirs, poses, img)
    else:
        from ngp_pl_torch.datasets.ray_utils import get_rays
        ro, rd = get_rays(dirs, poses[img])
    return ngp, pr, ro.contiguous(), rd.contiguous()


def bf16_steps(got, want, readings, name):
    """The tail's weight gradients are bf16 (the jitted `_mlp_apply`
    rounds them, and so does `mlp_apply`): where the f32 sums under them
    differ in their last bits (the compositor's prefix sums differ by
    design, float64 in the port), an entry moves by one bf16 step.  Reads
    the largest difference in bf16 steps of the JAX entry (read back from
    the moments, so rounded to bf16 first)."""
    want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16().float(
        ).numpy()
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    readings[f"steps {name}"] = float((np.abs(got - want) / step).max())


def check_one_step(c):
    """The limits of the one-step test: loss within 1e-5, every gradient
    (dR and dT too) within 2e-3 of its max, the updated parameters within
    1e-3 * lr, the moments within 1e-3 of their max, counts advanced.  The
    tail's weight gradients are bf16 in both packages: one of them may
    instead differ from JAX's by at most one bf16 step in each entry
    (`bf16_steps`)."""
    pose, tcfg = c["pose"], c["tcfg"]
    loss_j, g_j = jax_grads(c)
    exp = c["batch"].get("exposure")
    exp_t = None if exp is None else torch.from_numpy(exp)
    target = torch.from_numpy(c["batch"]["rgb"])
    win = trm.occupancy_windows(torch.from_numpy(c["occ"]))
    budget, chain = LAYOUT_STEP[c["layout"]]
    args = dict(tcfg=tcfg, rcfg=RenderConfig(), n_samples=budget,
                chain_length=chain, layout=c["layout"], exposure=exp_t)

    ngp, pr, ro, rd = port_step_parts(c)
    res, loss_of = tts.train_render(ngp, win, ro, rd,
                                    torch.from_numpy(c["noise"]),
                                    torch.ones(3), **args)
    loss_t = loss_of(target)
    ps = [w for _, _, w in ngp._slots()]
    extra = [pr.dR, pr.dT] if pose else []
    grads = torch.autograd.grad(loss_t, ps + extra)
    readings = {"loss": abs(float(loss_t.detach()) - loss_j) / abs(loss_j)}
    gn = _net(g_j, pose)
    for (n, i), g in _named_grads(ngp, grads[:len(ps)]).items():
        want = _jax_leaf(gn, n, i)
        readings[f"grad {n}{i}"] = _of_max(g.numpy(), want)
        if (n, i) != ("sigma_mlp", 0) and n != "hash_table":
            bf16_steps(g.numpy(), want, readings, f"{n}{i}")
    for k, g in zip(("dR", "dT"), grads[len(ps):]):
        readings[f"grad {k}"] = _of_max(g.numpy(), g_j["pose"][k])
        assert np.abs(g_j["pose"][k]).max() > 0
    assert readings["loss"] <= 1e-5, readings
    for k, v in readings.items():
        if k.startswith("grad"):
            assert v <= 2e-3 or readings.get(f"steps {k[5:]}", 2) <= 1, (
                k, readings)

    # the update from moments that damp the sign of tiny gradients
    rng = np.random.default_rng(1)
    mu = jax.tree_util.tree_map(lambda g: (0.5 * g * rng.uniform(
        0.5, 1.5, g.shape)).astype(np.float32), g_j)
    nu = jax.tree_util.tree_map(lambda g: (g * g * rng.uniform(
        1.0, 2.0, g.shape) + 1e-8).astype(np.float32), g_j)
    metrics, new, trainable = jax_step(c, mu, nu)
    mu_j, nu_j = _moments(new.opt_state, trainable)
    ngp, pr, ro, rd = port_step_parts(c)
    opt = tts.Adam(ps_ := [w for _, _, w in ngp._slots()],
                   tts.cosine_epoch_schedule(1e-2, 2, 4, 30.0), eps=1e-15)
    load_train_state(ngp, opt, c["params"], _net(mu, pose), _net(nu, pose),
                     5)
    if pose:
        load_pose_state(pr, {"params": c["pose_params"], "mu": mu["pose"],
                             "nu": nu["pose"], "count": 5})
    m = tts.train_step(ngp, opt, win, ro, rd, target,
                       torch.from_numpy(c["noise"]), torch.ones(3),
                       pose=pr, **args)
    assert bool(m["grads_finite"]) and bool(metrics["grads_finite"])
    assert float(m["loss"]) == pytest.approx(float(metrics["loss"]),
                                             rel=1e-5)
    assert opt.count == 6 and len(ps_) == len(list(ngp._slots()))
    lr = float(tts.cosine_epoch_schedule(1e-2, 2, 4, 30.0)(5))
    p_t, mu_t, nu_t, _ = train_state_numpy(ngp, opt)
    nets = ((p_t, new.params), (mu_t, _net(mu_j, pose)),
            (nu_t, _net(nu_j, pose)))
    for (n, i, _) in ngp._slots():
        a, b = _jax_leaf(nets[0][0], n, i), _jax_leaf(nets[0][1], n, i)
        assert np.abs(a - np.asarray(b)).max() <= 1e-3 * lr, (n, i)
        for got, want in nets[1:]:
            a, b = _jax_leaf(got, n, i), np.asarray(_jax_leaf(want, n, i))
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), (n, i)
    if pose:
        st = pose_state_numpy(pr)
        assert pr.opt.count == 6
        for k in ("dR", "dT"):
            want = np.asarray(new.pose_params[k])
            assert np.abs(st["params"][k] - want).max() <= 1e-3 * 1e-6, k
            assert not np.array_equal(want, c["pose_params"][k])
            for got, mom in ((st["mu"], mu_j), (st["nu"], nu_j)):
                w = np.asarray(mom["pose"][k])
                assert np.abs(got[k] - w).max() <= 1e-3 * np.abs(w).max()
    return readings


@pytest.mark.parametrize("layout", ["csr", "strided", "rounds"])
def test_one_pose_train_step_matches_jax(layout):
    """One --optimize_ext step in each layout (rounds with the distortion
    loss) against `make_train_step`, from non-zero poses, at Adam count 5:
    the limits of `check_one_step`, dR and dT and their own Adam (eps
    1e-8, lr 1e-6) included."""
    readings = check_one_step(step_case(layout, pose=True, hdr=False))
    print("pose step readings", layout, readings)


# --- full checkpoints with --optimize_ext --use_exposure --------------------

@dataclasses.dataclass(frozen=True)
class JaxCkptConfig(JaxTrainConfig):
    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


@dataclasses.dataclass(frozen=True)
class PortCkptConfig(TrainConfig):
    n_levels: int = 4
    log2_hashmap_size: int = 12

    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


CKPT = dict(dataset_name="synthetic", batch_size=N_RAYS, num_epochs=2,
            iters_per_epoch=4, train_layout="csr", optimize_ext=True,
            use_exposure=True)


def test_full_checkpoint_with_poses_and_exposure_both_ways(tmp_path):
    """A JAX `NeRFSystem.save` with --optimize_ext --use_exposure (poses,
    moments and counts set to seeded values) has the port's key set,
    shapes and dtypes (`multi_transform`'s `opt.inner_states[...]`,
    `pose[...]`, `params['tonemapper'][i][j]`); the port loads it bit for
    bit (net params, both Adams' moments and counts, the poses), and
    JAX's `load_checkpoint` reads the port's save of it back bit for bit
    (poses included)."""
    js = JaxSystem(JaxCkptConfig(**CKPT, exp_name="ckpt", no_save_test=True,
                                 num_devices=1),
                   train_dataset=JaxSynthetic(split="train", img_size=24,
                                              n_train=2),
                   test_dataset=JaxSynthetic(split="test", img_size=24,
                                             n_test=1))
    rng = np.random.default_rng(8)

    def seeded(path, a):
        a = np.asarray(a)
        if a.dtype.kind == "i":
            return jnp.asarray(7, a.dtype) if a.ndim == 0 else a
        return jnp.asarray(rng.normal(size=a.shape).astype(a.dtype))

    js.state = js.state._replace(
        pose_params=jax.tree_util.tree_map_with_path(
            seeded, js.state.pose_params),
        opt_state=jax.tree_util.tree_map_with_path(seeded,
                                                   js.state.opt_state),
        step=jnp.asarray(7, jnp.int32))
    jpath = os.path.join(tmp_path, "jax.npz")
    js.save(jpath)
    ps = NeRFSystem(PortCkptConfig(**CKPT), device="cpu",
                    train_dataset=SyntheticDataset(split="train",
                                                   img_size=24, n_train=2,
                                                   device="cpu"),
                    test_dataset=SyntheticDataset(split="test", img_size=24,
                                                  n_test=1, device="cpu"))
    tpath = os.path.join(tmp_path, "port.npz")
    ps.save(tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    ps.load(jpath)
    with np.load(jpath) as a:
        want = dict(a)
    ps.save(tpath)
    with np.load(tpath) as b:
        for k in want:
            if not k.startswith("grid"):
                np.testing.assert_array_equal(b[k], want[k], err_msg=k)
    assert ps.pose.opt.count == ps.optimizer.count == 7 == ps._host_step
    params, grid, opt, pose, step = jckpt.load_checkpoint(
        tpath, params=js.state.params, grid_state=js.grid_state,
        opt_state=js.state.opt_state,
        pose_params=jax.tree_util.tree_map(jnp.zeros_like,
                                           js.state.pose_params))
    for k in ("dR", "dT"):
        np.testing.assert_array_equal(np.asarray(pose[k]),
                                      want[f"pose['{k}']"])
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(opt)[0]}
    for k, v in flat.items():
        np.testing.assert_array_equal(v, want["opt" + k], err_msg=k)
    assert step == 7


# --- two blocks of the system against JAX's NeRFSystem -----------------------

BLOCK_LOOP = dict(dataset_name="synthetic", batch_size=N_RAYS, lr=1e-2,
                  num_epochs=2, iters_per_epoch=16, grid_warmup_steps=16,
                  train_layout="csr", n_levels=4, log2_hashmap_size=12,
                  exp_name="two_blocks", no_save_test=True)


@dataclasses.dataclass(frozen=True)
class JaxLoopConfig(JaxTrainConfig):
    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


@dataclasses.dataclass(frozen=True)
class PortLoopConfig(TrainConfig):
    def ngp_config(self):
        return dataclasses.replace(super().ngp_config(), grid_size=G)


# every second moment starts here in the two-block runs: from nu = 0 the
# first update is lr * sign(g), which parts the two packages by 2 lr at
# every entry whose gradient sits at the rounding floor (the long-horizon
# test's finding); at 1e-9 such an entry moves by far less than lr
NU_FLOOR = 1e-9


def two_blocks(**flags):
    """JAX's NeRFSystem and the port's from one state (JAX's initial
    parameters and marked grid, zero poses, first moments 0, second
    moments `NU_FLOOR`), fed the same batches (drawn with numpy), march
    jitter and refresh jitter, for two blocks of 16 steps (the first in
    grid warmup).  Returns per-step (port, JAX) losses and both systems."""
    from tests.test_torch_long_horizon import (
        _jax_grid_noise,
        _jax_march_noise,
    )
    from ngp_pl_torch.datasets.ray_utils import get_rays
    from ngp_pl_torch.models import occupancy as tocc

    js = JaxSystem(JaxLoopConfig(**BLOCK_LOOP, num_devices=1, **flags),
                   train_dataset=JaxSynthetic(split="train", img_size=24,
                                              n_train=2),
                   test_dataset=JaxSynthetic(split="test", img_size=24,
                                             n_test=1))
    ps = NeRFSystem(PortLoopConfig(**BLOCK_LOOP, **flags), device="cpu",
                    train_dataset=SyntheticDataset(split="train",
                                                   img_size=24, n_train=2,
                                                   device="cpu"),
                    test_dataset=SyntheticDataset(split="test", img_size=24,
                                                  n_test=1, device="cpu"))
    js.on_train_start()
    params = jax.tree_util.tree_map(np.array, js.state.params)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    floor = jax.tree_util.tree_map(lambda a: np.full_like(a, NU_FLOOR),
                                   params)
    load_train_state(ps.ngp, ps.optimizer, params, zeros, floor, 0)
    trainable, mu, nu = params, zeros, floor
    if ps.pose is not None:
        pz = {k: np.zeros((2, 3), np.float32) for k in ("dR", "dT")}
        pf = {k: np.full((2, 3), NU_FLOOR, np.float32) for k in pz}
        load_pose_state(ps.pose, {"params": pz, "mu": pz, "nu": pf,
                                  "count": 0})
        trainable, mu, nu = ({"net": t, "pose": q} for t, q in (
            (params, pz), (zeros, pz), (floor, pf)))
    js.state = js.state._replace(opt_state=_opt_state(
        jts.make_optimizer(js.tcfg), trainable, mu, nu, 0))
    ps.grid_state = grid_state_from_numpy(
        {k: np.array(v) for k, v in js.grid_state._asdict().items()}, "cpu")
    for s in (js, ps):
        s.freeze_buckets = True
        s._pool_mult, s.chain_length, s.layout = 8, 1152, "csr"
    tcfg, noise = ps.tcfg, {}

    def refresh(step_i):
        ps.grid_state = tocc.update_density_grid(
            ps.ngp, ps.grid_state, ps.density_threshold,
            warmup=step_i < tcfg.grid_warmup_steps, phase=(step_i // 16) % 4,
            erode=False, noise=torch.from_numpy(noise["grid"]))

    def train_step():
        img, pix = (torch.from_numpy(noise[k].astype(np.int64))
                    for k in ("img", "pix"))
        if ps.pose is not None:
            ro, rd = ps.pose.rays(ps.directions[pix], ps.poses, img)
        else:
            ro, rd = get_rays(ps.directions[pix], ps.poses[img])
        return tts.train_step(
            ps.ngp, ps.optimizer, ps.grid_state.win_rows, ro.contiguous(),
            rd.contiguous(), torch.from_numpy(noise["rgb"]),
            torch.from_numpy(noise["march"]), ps.background(), tcfg=tcfg,
            rcfg=ps.rcfg, n_samples=8, chain_length=1152, layout="csr",
            pose=ps.pose)

    ps._refresh_grid, ps._train_step = refresh, train_step
    rng = np.random.default_rng(2024)
    rays = np.asarray(js.train_dataset.rays, np.float32)
    losses = []
    for _ in range(32):
        step = js._host_step
        if step % 16 == 0:
            noise["grid"] = _jax_grid_noise(
                js.key, G ** 3 if step < 16 else G ** 3 // 4)
        img = rng.integers(0, 2, N_RAYS).astype(np.int32)
        pix = rng.integers(0, rays.shape[1], N_RAYS).astype(np.int32)
        noise.update(img=img, pix=pix, rgb=rays[img, pix, :3])
        mj = js.step({"img_idxs": img, "pix_idxs": pix,
                      "rgb": rays[img, pix, :3]})
        noise["march"] = _jax_march_noise(js.key, step)
        mt = ps.step()
        assert bool(mj["grads_finite"]) and bool(mt["grads_finite"])
        losses.append((float(mt["loss"]), float(mj["loss"])))
    return np.array(losses), js, ps


def test_two_pose_blocks_match_jax():
    """Two blocks of --optimize_ext (`two_blocks`): every step's loss
    within 1e-4 of JAX's (readings up to 1.3e-5); every parameter within
    0.1 of its max (0.027), dR and dT within 0.1 of theirs (6e-4, 0.034),
    both moved; both optimizers' counts at 32; the grid's bits agree."""
    losses, js, ps = two_blocks(optimize_ext=True)
    rel = np.abs(losses[:, 0] - losses[:, 1]) / np.abs(losses[:, 1])
    print("two pose blocks: loss", rel.max())
    assert rel.max() <= 1e-4
    p_t = ps.ngp.params_numpy()
    for n, i, _ in ps.ngp._slots():
        assert _of_max(_jax_leaf(p_t, n, i),
                       _jax_leaf(js.state.params, n, i)) <= 0.1, (n, i)
    st = pose_state_numpy(ps.pose)
    for k in ("dR", "dT"):
        want = np.asarray(js.state.pose_params[k])
        assert np.abs(want).max() > 0
        assert _of_max(st["params"][k], want) <= 0.1, k
    assert ps.pose.opt.count == ps.optimizer.count == 32
    assert (ps.grid_state.occ_grid.numpy()
            == np.asarray(js.grid_state.occ_grid)).mean() >= 0.998


def _rms_of(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / max((b ** 2).mean(),
                                                     1e-300)))
