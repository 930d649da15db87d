"""LPIPS (`ngp_pl_torch/training/lpips.py`, `metrics.LPIPSHook`,
`validate` with `eval_lpips`) against the JAX package's `lpips_jax` on the
CPU, with JAX's seeded random weights carried across in the shared npz
scheme (no pretrained weights can be fetched).

Limit: LPIPS within 1e-4 relative of JAX's.  Both run the same f32
graph; XLA's convolutions and oneDNN's sum the 3x3xC products in other
orders (~1e-7 relative per layer), which 13 layers and the unit
normalisation carry to at most 2.8e-6 of the distance (seeds 0-2, noise
0.01-0.5; the largest where the distance is smallest, ~1.2e-4).

Sizes: 64x64 pairs (the five taps down to 4x4), a 24x24 test view."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.training import lpips_jax
from ngp_pl_torch.training import lpips as tlpips
from ngp_pl_torch.training.metrics import LPIPS_ENV, LPIPSHook
from tests.test_torch_entry_points import _small_system

torch.set_num_threads(2)
LPIPS_RTOL = 1e-4


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's random weights, written to an npz and read by both."""
    params = lpips_jax.init_random_weights(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("lpips") / "w.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return path, params, tlpips.load_weights_npz(path)


def _pair(seed, shape=(64, 64, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + noise * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("noise", [0.01, 0.1, 0.5])
def test_lpips_matches_jax(weights, noise):
    _, jparams, tparams = weights
    a, b = _pair(1, noise=noise)
    want = float(lpips_jax.lpips(jparams, jnp.asarray(a), jnp.asarray(b)))
    got = tlpips.lpips(tparams, torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0 and want > 0
    assert float(got) == pytest.approx(want, rel=LPIPS_RTOL)


def test_lpips_batched_and_odd_sizes_match_jax(weights):
    """A batch of two, and 66x70 images, whose pools floor odd sizes."""
    _, jparams, tparams = weights
    for shape in ((2, 64, 64, 3), (66, 70, 3)):
        a, b = _pair(2, shape)
        want = np.asarray(lpips_jax.lpips(jparams, jnp.asarray(a),
                                          jnp.asarray(b)))
        got = tlpips.lpips(tparams, torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=LPIPS_RTOL)


def test_identity_is_zero_and_grows(weights):
    tparams = weights[2]
    a, _ = _pair(3)
    x = torch.from_numpy(a)
    assert abs(float(tlpips.lpips(tparams, x, x))) < 1e-6
    small, big = (float(tlpips.lpips(
        tparams, x, torch.from_numpy(_pair(3, noise=n)[1])))
        for n in (0.01, 0.3))
    assert 0 < small < big


def test_feature_taps_match_jax(weights):
    """Each tap's shape, NCHW against NHWC, and its values within 1e-4 of
    the tap's largest."""
    _, jparams, tparams = weights
    a, _ = _pair(4)
    jt = lpips_jax._features(jparams, jnp.asarray(a[None]) * 2 - 1)
    tt = tlpips._features(tparams, torch.from_numpy(a[None]).permute(
        0, 3, 1, 2) * 2 - 1)
    assert [t.shape[1] for t in tt] == [64, 128, 256, 512, 512]
    assert [t.shape[2] for t in tt] == [64, 32, 16, 8, 4]
    for j, t in zip(jt, tt):
        j = np.asarray(j).transpose(0, 3, 1, 2)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_random_weights_and_npz_round_trip(tmp_path):
    """The port's own seeded weights: the JAX scheme's names, shapes and
    scales; saved and loaded unchanged; JAX's lpips reads the file."""
    p = tlpips.init_random_weights(0)
    jp = lpips_jax.init_random_weights(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert float(p["conv12_w"].std()) == pytest.approx(
        (2.0 / (512 * 9)) ** 0.5, rel=0.05)
    assert 0.0 <= float(p["lin0_w"].min()) and float(p["lin0_w"].max()) < 0.1
    assert torch.equal(tlpips.init_random_weights(0)["conv3_w"],
                       p["conv3_w"])
    path = str(tmp_path / "mine.npz")
    tlpips.save_weights_npz(path, p)
    back = tlpips.load_weights_npz(path)
    assert all(torch.equal(back[k], p[k]) for k in p)
    a, b = _pair(5)
    want = float(lpips_jax.lpips(lpips_jax.load_weights_npz(path),
                                 jnp.asarray(a), jnp.asarray(b)))
    got = float(tlpips.lpips(back, torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(want, rel=LPIPS_RTOL)


def test_hook_discovery(weights, tmp_path, monkeypatch):
    """The env var's npz first; without it the temporary directory's
    converted file; with neither (and no `lpips` package installed)
    unavailable."""
    path, jparams, _ = weights
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.delenv(LPIPS_ENV, raising=False)
    hook = LPIPSHook()
    assert not hook.available and hook(torch.zeros(8, 8, 3),
                                       torch.zeros(8, 8, 3)) is None
    monkeypatch.setenv(LPIPS_ENV, path)
    hook = LPIPSHook()
    assert hook.available
    a, b = _pair(6)
    want = float(lpips_jax.lpips(jparams, jnp.asarray(a), jnp.asarray(b)))
    assert hook(torch.from_numpy(a), torch.from_numpy(b)) == pytest.approx(
        want, rel=LPIPS_RTOL)
    monkeypatch.delenv(LPIPS_ENV)
    import shutil

    shutil.copy(path, tmp_path / "ngp_pl_torch_lpips_vgg.npz")
    assert LPIPSHook().available


def test_validate_scores_lpips_with_weights(weights, tmp_path, monkeypatch):
    """`eval_lpips` with weights: `lpips` beside psnr and ssim, the mean of
    the hook's score of each rendered view against its ground truth;
    without weights it raises, naming the variable."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.delenv(LPIPS_ENV, raising=False)
    system = _small_system(eval_lpips=True, no_save_test=True)
    with pytest.raises(RuntimeError, match=LPIPS_ENV):
        system.validate()
    monkeypatch.setenv(LPIPS_ENV, weights[0])
    system = _small_system(eval_lpips=True, no_save_test=True)
    scores = system.validate()
    assert set(scores) == {"psnr", "ssim", "lpips"}
    ds = system.test_dataset
    w, h = ds.img_wh
    renderer = system.renderer()
    dirs = torch.from_numpy(ds.directions)
    want = []
    for idx in range(len(ds.poses)):
        item = ds.test_item(idx)
        out = renderer.render_pose(system.grid_state.occ_grid, dirs,
                                   torch.from_numpy(item["pose"]))
        want.append(system.lpips(out["rgb"].reshape(h, w, 3),
                                 item["rgb"].reshape(h, w, 3)))
    assert scores["lpips"] == pytest.approx(float(np.mean(want)), rel=1e-6)
    assert scores["lpips"] > 0
