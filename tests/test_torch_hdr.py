"""Port parity for the HDR head (`--use_exposure`): the field's
log-radiance and per-channel tonemappers with and without an exposure, its
radiance, the strided form, one train step in each layout with and
without an exposure column (the unit-exposure anchor in the loss), two
blocks of the system, the 4-channel ray store, slim checkpoints both ways
and the eval entry point on an HDR checkpoint, against the JAX package.

The JAX field reaches the TPU encode kernels here (its tail is XLA: the
fused Pallas tail covers the Sigmoid head only), so its `hash_encode_mlp`
runs the Pallas K1/K3 in interpret mode, as the other port tests run it.
Sizes: grid 32, L=4, log2 T=12, 256 rays of 24x24 views."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ngp_pl_tpu.models.ngp as jngp_mod
from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_tpu.training import checkpoint as jckpt
from ngp_pl_tpu.training.system import NeRFSystem as JaxSystem
from ngp_pl_torch import eval as teval
from ngp_pl_torch.config import TrainConfig
from ngp_pl_torch.datasets.synthetic import SyntheticDataset
from ngp_pl_torch.training import train_step as tts
from ngp_pl_torch.training.checkpoint import (
    load_slim_checkpoint,
    save_slim_checkpoint,
)
from ngp_pl_torch.training.system import NeRFSystem
from tests.test_torch_pose import (
    _jax_leaf,
    _rms_of,
    two_blocks,
    _jax_params,
    _named_grads,
    _of_max,
    _port_model,
    check_one_step,
    step_case,
)

torch.set_num_threads(2)


@pytest.fixture
def pallas_encode(monkeypatch):
    """JAX's field through its TPU encode kernels, interpreted."""
    monkeypatch.setattr(jngp_mod, "hash_encode_mlp",
                        lambda x, table, w1, spec, need_x_grad=False:
                        jhe._encode_mlp_pl_cv(spec, jhe._pick_bn(x.shape[0]),
                                              x, table, w1))
    with pltpu.force_tpu_interpret_mode():
        yield


def _hdr_models(F=4):
    jngp, params = _jax_params(seed=3, hdr=True, F=F)
    jngp.need_x_grad = False
    return jngp, params, _port_model(params, hdr=True, F=F,
                                     need_x_grad=False)


@pytest.mark.parametrize("F", [4, 2])
def test_hdr_forward_matches_jax(pallas_encode, F):
    """`forward` of the HDR head under jit, with a per-sample exposure
    (0.25-4), without one (unit exposure) and as radiance, and
    `forward_rays` with a per-ray exposure: sigma, rgb and the radiance
    within 1e-5 of max; the tonemapped rgb in (0, 1), the radiance
    positive; the gradients of a weighted sum of the exposed forward to
    every parameter (the three tonemappers too) within 2e-3 of max, with
    the tail's bf16 weight gradients as in the train step."""
    jngp, params, ngp = _hdr_models(F)
    assert not ngp.use_fused and len(ngp.tonemapper) == 3
    rng = np.random.default_rng(4)
    N, S = 32, 8
    x = rng.uniform(-0.45, 0.45, (N * S, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    dS = np.repeat(d, S, axis=0)
    e_ray = np.exp(rng.uniform(np.log(0.25), np.log(4.0), (N, 1))).astype(
        np.float32)
    eS = np.repeat(e_ray, S, axis=0)
    wr = rng.normal(size=(N * S, 3)).astype(np.float32)
    p = jax.tree_util.tree_map(jnp.asarray, params)

    @jax.jit
    def outs(p):
        return (jngp.forward(p, x, dS, exposure=eS),
                jngp.forward(p, x, dS),
                jngp.forward(p, x, dS, output_radiance=True),
                jngp.forward_rays(p, x.reshape(N, S, 3), d, exposure=e_ray))

    j = outs(p)
    g_j = jax.jit(jax.grad(lambda p: jnp.sum(
        jngp.forward(p, x, dS, exposure=eS)[1] * wr)))(p)
    t = lambda a: torch.from_numpy(a)        # noqa: E731
    ps = [w for _, _, w in ngp._slots()]
    got = (ngp(t(x), t(dS), exposure=t(eS)), ngp(t(x), t(dS)),
           ngp(t(x), t(dS), output_radiance=True),
           ngp.forward_rays(t(x).reshape(N, S, 3), t(d), exposure=t(e_ray)))
    for (s_t, r_t), (s_j, r_j) in zip(got[:3], j[:3]):
        assert _of_max(s_t.detach().numpy(), s_j) <= 1e-5
        assert _of_max(r_t.detach().numpy(), r_j) <= 1e-5
    s_t, r_t = got[3]
    s_j, r_j = j[3]
    assert _of_max(s_t.detach().numpy(), s_j) <= 1e-5
    assert _of_max(r_t.detach().numpy(),
                   np.moveaxis(np.asarray(r_j), 0, -1)) <= 1e-5
    rgb = got[0][1].detach().numpy()
    assert (rgb > 0).all() and (rgb < 1).all()
    assert (got[2][1].detach().numpy() > 0).all()
    assert not np.allclose(rgb, got[1][1].detach().numpy(), atol=1e-3)
    grads = torch.autograd.grad((got[0][1] * t(wr)).sum(), ps)
    for (n, i), g in _named_grads(ngp, grads).items():
        want = np.asarray(_jax_leaf(g_j, n, i))
        assert np.abs(want).max() > 0, (n, i)
        err = _of_max(g.numpy(), want)
        if err > 2e-3:               # bf16 weight gradients of the tail
            step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                       1e-30))) - 7)
            assert (np.abs(g.numpy() - want) / step).max() <= 1, (n, i, err)


@pytest.mark.parametrize("layout,exposure", [
    ("csr", True), ("csr", False), ("strided", True), ("strided", False),
    ("rounds", True), ("rounds", False)])
def test_one_hdr_train_step_matches_jax(pallas_encode, layout, exposure):
    """One --use_exposure step in each layout (rounds with the distortion
    loss), with an explicit exposure column (0.25-4 per ray) and without
    one, against `make_train_step` at Adam count 5: the limits of the
    one-step test (`check_one_step`), the three tonemappers' gradients
    and updates included (the unit-exposure anchor reaches them)."""
    readings = check_one_step(step_case(layout, pose=False, hdr=True,
                                        exposure=exposure))
    print("hdr step readings", layout, exposure, readings)


def test_unit_exposure_anchor_matches_jax():
    """The anchor alone: 0.5 * (tonemapper(0) - unit_exposure_rgb)^2 per
    channel, (1, 3), and its gradient to the tonemappers, against JAX's
    `_mlp_apply` of a zero log-radiance."""
    _, params, ngp = _hdr_models()
    from ngp_pl_tpu.models.ngp import _mlp_apply

    def anchor(tm):
        zero = jnp.zeros((1, 1), jnp.float32)
        return 0.5 * (jnp.concatenate([
            _mlp_apply(tm[i], zero, jnp.bfloat16, out_act=jax.nn.sigmoid)
            for i in range(3)], axis=-1) - 0.3) ** 2

    tm = jax.tree_util.tree_map(jnp.asarray, params["tonemapper"])
    a_j = np.asarray(jax.jit(anchor)(tm))
    g_j = jax.jit(jax.grad(lambda tm: jnp.sum(anchor(tm))))(tm)
    a_t = tts.unit_exposure_loss(ngp, 0.3)
    assert a_t.shape == (1, 3)
    np.testing.assert_allclose(a_t.detach().numpy(), a_j, rtol=1e-5)
    ws = [w for ws in ngp.tonemapper for w in ws]
    for g, want in zip(torch.autograd.grad(a_t.sum(), ws),
                       [w for pair in g_j for w in pair]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-12)


def test_hdr_slim_checkpoints_both_ways(tmp_path):
    """Slim checkpoints carry params['tonemapper'][i][j]: a JAX HDR save
    loads into the port bit for bit, and the port's save into JAX's
    `load_slim_checkpoint` (keys, shapes, values)."""
    jngp, params, ngp = _hdr_models()
    occ = np.random.default_rng(0).random((1, 32, 32, 32)) < 0.3
    occ = occ.astype(np.uint8)
    path = os.path.join(tmp_path, "jax_slim.npz")
    jckpt.save_slim_checkpoint(
        path, params=params, grid_state=type("G", (), {"occ_grid": occ}))
    got, occ_t = load_slim_checkpoint(path)
    ngp2 = _port_model(jax.tree_util.tree_map(np.zeros_like, params),
                       hdr=True, need_x_grad=False)
    ngp2.load_params(got)
    for (n, i, w) in ngp2._slots():
        np.testing.assert_array_equal(w.detach().numpy(),
                                      _jax_leaf(params, n, i))
    np.testing.assert_array_equal(occ_t, occ)
    path2 = os.path.join(tmp_path, "port_slim.npz")
    save_slim_checkpoint(path2, params=ngp.params_numpy(), occ_grid=occ)
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params['tonemapper'][2][1]" in b.files
    back, occ_j = jckpt.load_slim_checkpoint(
        path2, params=jax.tree_util.tree_map(np.zeros_like, params))
    for (n, i, w) in ngp._slots():
        np.testing.assert_array_equal(np.asarray(_jax_leaf(back, n, i)),
                                      w.detach().numpy())
    np.testing.assert_array_equal(np.asarray(occ_j), occ)


def test_two_hdr_blocks_match_jax(pallas_encode):
    """Two blocks of --use_exposure (`two_blocks`): every step's loss within
    2e-3 of JAX's (readings up to 4.0e-4: the encode's plain kernels and
    the interpreted Pallas ones flip bf16 steps, as in the one-step test);
    the MLPs and tonemappers within 1e-2 of their max (1.6e-3), the table
    within 0.1 RMS (0.051: its entries are ~1e-4, so a step at the rounding
    floor moves them far in relative terms); the grid's bits agree."""
    losses, js, ps = two_blocks(use_exposure=True)
    rel = np.abs(losses[:, 0] - losses[:, 1]) / np.abs(losses[:, 1])
    print("two hdr blocks: loss", rel.max())
    assert rel.max() <= 2e-3
    p_t = ps.ngp.params_numpy()
    for n, i, _ in ps.ngp._slots():
        got, want = _jax_leaf(p_t, n, i), _jax_leaf(js.state.params, n, i)
        if n == "hash_table":
            assert _rms_of(got, want) <= 0.1
        else:
            assert _of_max(got, want) <= 1e-2, (n, i)
    assert ps.optimizer.count == 32 and ps.pose is None
    assert (ps.grid_state.occ_grid.numpy()
            == np.asarray(js.grid_state.occ_grid)).mean() >= 0.998


def test_four_channel_store_gives_each_ray_its_exposure(monkeypatch):
    """A 4-channel ray store (rgb + exposure, as the JAX loaders make for
    HDR scenes): the system's step takes the 4th channel as each ray's
    exposure; a 3-channel store gives none (unit exposure)."""
    system = NeRFSystem(
        TrainConfig(batch_size=64, n_levels=4, log2_hashmap_size=12,
                    use_exposure=True, train_layout="csr"), device="cpu",
        train_dataset=SyntheticDataset(split="train", img_size=16, n_train=2,
                                       device="cpu"),
        test_dataset=SyntheticDataset(split="test", img_size=16, n_test=1,
                                      device="cpu"))
    seen = []
    step = tts.train_step

    def spy(*a, **kw):
        seen.append(kw["exposure"])
        return step(*a, **kw)

    import ngp_pl_torch.training.system as tsys
    monkeypatch.setattr(tsys, "train_step", spy)
    system._train_step()
    rays = system.rays
    system.rays = torch.cat([rays, torch.full_like(rays[..., :1], 2.0)],
                            dim=-1)
    system._train_step()
    assert seen[0] is None
    assert seen[1].shape == (64, 1) and bool((seen[1] == 2.0).all())


def test_eval_renders_an_hdr_slim_checkpoint(tmp_path):
    """`python -m ngp_pl_torch.eval --use_exposure --weight_path` on a
    JAX HDR slim checkpoint: the model has the checkpoint's tonemappers
    and renders one 16x16 view tonemapped at unit exposure (finite, in
    [0, 1])."""
    from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
    from ngp_pl_tpu.models.ngp import NGP as JaxNGP

    cfg = JaxNGPConfig(n_levels=4, n_features_per_level=4,
                       log2_hashmap_size=12, rgb_act="None")
    params = jax.tree_util.tree_map(
        np.asarray, JaxNGP(cfg).init(jax.random.PRNGKey(6)))
    occ = (np.random.default_rng(1).random((1, 128, 128, 128)) < 0.05
           ).astype(np.uint8)
    path = os.path.join(tmp_path, "hdr_slim.npz")
    jckpt.save_slim_checkpoint(
        path, params=params, grid_state=type("G", (), {"occ_grid": occ}))
    res = teval.main(["--device", "cpu", "--n_levels", "4",
                      "--log2_hashmap_size", "12", "--downsample", "0.125",
                      "--max_images", "1", "--use_exposure",
                      "--weight_path", path])
    assert res.ngp.cfg.rgb_act == "None"
    np.testing.assert_array_equal(
        res.ngp.tonemapper[2][1].detach().numpy(),
        params["tonemapper"][2][1])
    img = res.images[0]
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
