"""The port's host library (`ngp_pl_torch.native`) against the JAX
package's (`ngp_pl_tpu.native`): the same batches for the same seeds (f32
stores with 3 and 4 channels and u8 stores, both strategies, at batches of
8,192 and 20,000, the latter past `parallel_for`'s threading threshold),
the same u8 ingest and box downsampling; its build (race-free under
concurrent processes, raising when g++ fails); and the numpy branches that
`NGP_PL_TORCH_NO_NATIVE` selects, against the JAX package's."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ngp_pl_tpu import native as jnative
from ngp_pl_tpu.datasets import color_utils as jcolor
from ngp_pl_tpu.datasets.base import BaseDataset as JaxBase
from ngp_pl_torch import native
from ngp_pl_torch.datasets import color_utils
from ngp_pl_torch.datasets.base import sample_rays

REPO = Path(__file__).resolve().parent.parent


def test_both_libraries_build():
    assert jnative.available()
    assert native.get_lib() is not None
    assert native.lib_path().parent == REPO / "build" / "host"


def _store(kind, seed=0, n_img=5, n_pix=3001):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, (n_img, n_pix, 3)).astype(np.uint8)
    ch = 4 if kind == "f32_exposure" else 3
    return rng.random((n_img, n_pix, ch)).astype(np.float32)


@pytest.mark.parametrize("batch", [8192, 20000])
@pytest.mark.parametrize("strategy", ["all_images", "same_image"])
@pytest.mark.parametrize("kind", ["f32", "f32_exposure", "u8"])
def test_sample_batch_matches_jax(kind, strategy, batch):
    rays = _store(kind)
    for seed in (0, 123, 2 ** 62 - 1):
        got = native.sample_batch(rays, batch, strategy, seed)
        want = jnative.sample_batch(rays, batch, strategy, seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ("exposure" in got) == (kind == "f32_exposure")


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 62 - 1), batch=st.integers(1, 40000),
       n_img=st.integers(1, 9), n_pix=st.integers(1, 5000))
def test_sample_batch_matches_jax_at_any_size(seed, batch, n_img, n_pix):
    rays = _store("f32_exposure", seed % 1000, n_img, n_pix)
    got = native.sample_batch(rays, batch, "all_images", seed)
    want = jnative.sample_batch(rays, batch, "all_images", seed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("ch,blend_a,premultiply", [
    (3, True, False), (4, True, False), (4, False, True), (4, False, False),
    (5, True, False)])
def test_u8_to_rays_matches_jax(ch, blend_a, premultiply):
    img = np.random.default_rng(ch).integers(0, 256, (50001, ch)).astype(
        np.uint8)
    got = native.u8_to_rays(img, blend_a, premultiply)
    np.testing.assert_array_equal(
        got, jnative.u8_to_rays(img, blend_a, premultiply))
    # x * (1.0f / 255.0f), not x / 255: up to an ulp apart
    if ch == 3:
        np.testing.assert_array_equal(
            got, img.astype(np.float32) * np.float32(1.0 / 255.0))
        assert (got != img.astype(np.float32) / 255.0).any()


def test_u8_to_rays_reads_the_next_pixel_below_three_channels():
    """The JAX library's defect, reproduced: two channels read the third
    from the next pixel's first byte (the last pixel reads a zero pad here,
    memory past the array there, so it is left out)."""
    img = np.random.default_rng(7).integers(0, 256, (1001, 2)).astype(
        np.uint8)
    got = native.u8_to_rays(img)
    np.testing.assert_array_equal(got[:-1], jnative.u8_to_rays(img)[:-1])
    np.testing.assert_array_equal(
        got[:-1, 2], img[1:, 0].astype(np.float32) * np.float32(1 / 255))
    assert got[-1, 2] == 0.0


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_downsample_box_matches_jax(factor):
    img = np.random.default_rng(factor).random((133, 97, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(native.downsample_box(img, factor),
                                  jnative.downsample_box(img, factor))


def test_png_unfilter_refuses_a_bad_filter_byte():
    raw = np.zeros((3, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        native.png_unfilter(raw.reshape(-1), 3, 6, 3)


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Four processes build into one empty directory at once: each loads
    a whole library, one file remains and no temporary is left."""
    code = ("import sys; from pathlib import Path\n"
            "from ngp_pl_torch import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "import numpy as np\n"
            "r = np.ones((2, 10, 3), np.float32)\n"
            "b = native.sample_batch(r, 64, 'all_images', 1)\n"
            "assert (b['rgb'] == 1).all()\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    assert [p.name for p in tmp_path.iterdir()] == [native.lib_path().name]


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ray_sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="building the host library"):
        native.build()
    assert not any((tmp_path / "out").iterdir())


@pytest.mark.parametrize("strategy", ["all_images", "same_image"])
def test_no_native_takes_the_numpy_branch_as_jax(monkeypatch, strategy):
    """With NGP_PL_TORCH_NO_NATIVE the batch is numpy's draws from the
    Generator, the JAX package's fallback branch (base.py:66-78)."""
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(jnative, "sample_batch", lambda *a, **k: None)
    rays = _store("f32_exposure")
    jds = JaxBase("unused")
    jds.rays, jds.poses = rays, np.zeros((len(rays), 3, 4), np.float32)
    jds.img_wh = (rays.shape[1], 1)
    jds.batch_size, jds.ray_sampling_strategy = 777, strategy
    got = sample_rays(rays, 777, strategy, np.random.default_rng(5))
    want = jds.sample_batch(np.random.default_rng(5))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(RuntimeError, match=native.NO_NATIVE_ENV):
        native.sample_batch(rays, 8, strategy, 1)


def test_no_native_read_image_divides_as_jax(monkeypatch, tmp_path):
    """With NGP_PL_TORCH_NO_NATIVE `read_image` divides by 255 and blends in
    numpy, as the JAX package's fallback branch does."""
    import imageio.v2 as imageio

    path = str(tmp_path / "x.png")
    imageio.imwrite(path, np.random.default_rng(3).integers(
        0, 256, (9, 11, 4)).astype(np.uint8))
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(jnative, "u8_to_rays", lambda *a, **k: None)
    for blend in (True, False):
        np.testing.assert_array_equal(
            color_utils.read_image(path, (11, 9), blend),
            jcolor.read_image(path, (11, 9), blend))
