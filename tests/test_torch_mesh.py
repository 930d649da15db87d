"""Mesh extraction (`ngp_pl_torch/utils/mesh.py`, `eval --mesh_path`)
against the JAX package's `ngp_pl_tpu/utils/mesh.py` on the CPU.

Marching tetrahedra fed the same grid gives JAX's faces exactly and its
vertices within one float32 ulp (they read bit-equal); the lattice is
bit-equal; OBJ and PLY files are byte-equal.  Through a model the density
grids differ (the port's density keeps the TPU kernels' f16 table and bf16
rounding points, JAX's CPU path reads the f32 table), so there the grids
are held to a relative limit and the meshes by counts and vertex distance.

Sizes: lattices of 12-48 points a side, grid 32, L=4, log2 T=12."""
import jax
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.utils import mesh as jmesh
from ngp_pl_torch import eval as teval
from ngp_pl_torch.config import NGPConfig
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.training.checkpoint import save_slim_checkpoint
from ngp_pl_torch.utils import mesh as tmesh

torch.set_num_threads(2)


def _sphere_grid(R=48):
    lin = np.linspace(-0.5, 0.5, R, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    return (200.0 * (0.3 - np.linalg.norm(pts, axis=-1))).reshape(R, R, R)


def _random_grid(R=12, seed=0):
    return np.random.default_rng(seed).normal(size=(R, R, R)).astype(
        np.float32)


def _march_both(values, level):
    vj, fj = jmesh.marching_tetrahedra(values, level)
    vt, ft = tmesh.marching_tetrahedra(torch.from_numpy(values), level)
    return (vj, fj), (vt.numpy(), ft.numpy())


@pytest.mark.parametrize("grid, level", [("sphere", 0.0), ("random", 0.1),
                                         ("random", -0.7)])
def test_marching_tetrahedra_matches_jax(grid, level):
    """Faces identical (numbering and order), vertices within one ulp; the
    random field at R=12 cuts tets with one, two and three corners in."""
    values = _sphere_grid() if grid == "sphere" else _random_grid()
    (vj, fj), (vt, ft) = _march_both(values, level)
    assert len(fj) > 100
    assert vt.dtype == np.float32 and ft.dtype == np.int32
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_max_ulp(vt, vj, maxulp=1)
    if grid == "random":
        # every case of a tet crossing the level occurs
        R = values.shape[0]
        inside = (values > np.float32(level)).reshape(-1)
        c = np.array(jmesh._CORNERS) @ np.array([R * R, R, 1])
        base = np.array([x * R * R + y * R + z for x in range(R - 1)
                         for y in range(R - 1) for z in range(R - 1)])
        n_in = inside[(base[:, None] + c)[:, jmesh._TETS]].sum(-1)
        assert {1, 2, 3} <= set(np.unique(n_in).tolist())


def test_marching_tetrahedra_empty():
    for values in (np.zeros((5, 5, 5), np.float32),
                   np.full((5, 5, 5), 9.0, np.float32)):
        vt, ft = tmesh.marching_tetrahedra(torch.from_numpy(values), 1.0)
        assert vt.shape == (0, 3) and vt.dtype == torch.float32
        assert ft.shape == (0, 3) and ft.dtype == torch.int32


def test_lattice_matches_jax():
    """The points handed to the density, chunk by chunk, bit-equal."""
    got = []
    jmesh.density_grid_query(lambda x: got.append(np.array(x)) or
                             np.zeros(len(x), np.float32), 37, 0.7,
                             chunk=4096)
    pts = tmesh.lattice(37, 0.7)
    assert pts.dtype == torch.float32
    np.testing.assert_array_equal(pts.numpy(), np.concatenate(got))
    seen = []
    tmesh.density_grid_query(lambda x: seen.append(x.shape[0]) or
                             x[:, 0], 37, 0.7, chunk=4096)
    assert seen == [len(g) for g in got]


def test_obj_and_ply_byte_equal(tmp_path):
    values = _sphere_grid(R=20)
    vj, fj = jmesh.marching_tetrahedra(values, 0.0)
    vj = vj / (20 - 1) * 2 * 0.5 - 0.5
    vt, ft = tmesh.marching_tetrahedra(torch.from_numpy(values), 0.0)
    vt = tmesh.to_world(vt, 20, 0.5)
    np.testing.assert_array_equal(vt.numpy(), vj)
    colors = np.random.default_rng(1).random((len(vj), 3)).astype(
        np.float32)
    for ext, jsave, tsave in (("obj", jmesh.save_mesh_obj,
                               tmesh.save_mesh_obj),
                              ("ply", jmesh.save_mesh_ply,
                               tmesh.save_mesh_ply)):
        jsave(str(tmp_path / f"j.{ext}"), vj, fj)
        tsave(str(tmp_path / f"t.{ext}"), vt, ft)
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    jmesh.save_mesh_ply(str(tmp_path / "jc.ply"), vj, fj, colors)
    tmesh.save_mesh_ply(str(tmp_path / "tc.ply"), vt, ft, colors)
    assert (tmp_path / "tc.ply").read_bytes() == \
        (tmp_path / "jc.ply").read_bytes()


KW = dict(scale=0.5, n_levels=4, log2_hashmap_size=12, grid_size=32)
R_MODEL = 24
LEVEL = 5.0


def _models(F):
    kw = {**KW, "n_features_per_level": F}
    jngp = JaxNGP(JaxNGPConfig(**kw), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e3
    # log sigma spans ~[-2, 3.5]: the level cuts a mesh of a few thousand
    params["sigma_mlp"][1] = params["sigma_mlp"][1].at[:, 0].multiply(16.0)
    tngp = NGP(NGPConfig(**kw), device="cpu")
    tngp.load_params(jax.tree_util.tree_map(np.asarray, params))
    return jngp, params, tngp


def _nearest(a, b):
    """For each point of a, its distance to the nearest point of b."""
    b = torch.from_numpy(b).double()
    return np.concatenate([
        torch.cdist(torch.from_numpy(a[i:i + 512]).double(), b).amin(
            1).numpy() for i in range(0, len(a), 512)])


@pytest.mark.parametrize("F", [4, 2])
def test_extract_mesh_matches_jax_density(F):
    """`extract_mesh` through carried-across weights against JAX's with its
    unjitted `ngp.density`, as JAX's eval calls it.  Density grids within
    3e-2 relative: the sigma head's column x16 carries the f16 table's and
    bf16 roundings' ~1e-3 (the refresh test's limit 1e-2 at x1) into
    log sigma.  Meshes: counts within 5%; every JAX vertex within half a
    lattice cell of a port vertex, 99% of the port's within 0.1 cell of a
    JAX vertex (the rest, 0.4-0.8% at this size, lie on islands a few
    cells wide where the density grazes the level and moved across it);
    the port's march of JAX's own grid gives JAX's mesh exactly."""
    jngp, params, tngp = _models(F)
    jfn = lambda x: jngp.density(params, x)          # noqa: E731
    gj = jmesh.density_grid_query(jfn, R_MODEL, 0.5)
    gt = tmesh.density_grid_query(tngp.density, R_MODEL, 0.5).numpy()
    np.testing.assert_allclose(gt, gj, rtol=3e-2, atol=0)
    vj, fj = jmesh.extract_mesh(jfn, R_MODEL, 0.5, LEVEL)
    vt, ft = tmesh.extract_mesh(tngp.density, R_MODEL, 0.5, LEVEL)
    vt, ft = vt.numpy(), ft.numpy()
    assert len(fj) > 500
    assert len(vt) == pytest.approx(len(vj), rel=5e-2)
    assert len(ft) == pytest.approx(len(fj), rel=5e-2)
    cell = 1.0 / (R_MODEL - 1)
    assert _nearest(vj, vt).max() <= 0.5 * cell
    assert (_nearest(vt, vj) <= 0.1 * cell).mean() >= 0.99
    vj2, fj2 = jmesh.marching_tetrahedra(gj, LEVEL)
    vt2, ft2 = tmesh.marching_tetrahedra(torch.from_numpy(gj), LEVEL)
    np.testing.assert_array_equal(ft2.numpy(), fj2)
    np.testing.assert_array_equal(vt2.numpy(), vj2)


def test_eval_mesh_path(tmp_path, capsys):
    """`python -m ngp_pl_torch.eval --weight_path ... --mesh_path` writes
    the slim checkpoint's mesh: the file equals `write_mesh`'s verts and
    faces in PLY, and OBJ for a .obj path."""
    _, _, tngp = _models(4)
    occ = torch.ones((1, 128, 128, 128), dtype=torch.uint8)
    slim = str(tmp_path / "slim.npz")
    save_slim_checkpoint(slim, params=tngp.params_numpy(), occ_grid=occ)
    argv = ["--device", "cpu", "--n_levels", "4", "--log2_hashmap_size",
            "12", "--downsample", "0.125", "--max_images", "1",
            "--weight_path", slim, "--mesh_resolution", str(R_MODEL),
            "--mesh_threshold", str(LEVEL)]
    for ext in ("ply", "obj"):
        path = str(tmp_path / f"m.{ext}")
        res = teval.main(argv + ["--mesh_path", path])
        m = res.mesh
        assert m["values"].shape == (R_MODEL,) * 3 and len(m["faces"]) > 500
        assert m["query_s"] >= 0 and m["march_s"] >= 0
        vt, ft = tmesh.extract_mesh(tngp.density, R_MODEL, 0.5, LEVEL)
        torch.testing.assert_close(m["verts"], vt, rtol=0, atol=0)
        assert torch.equal(m["faces"], ft)
        text = open(path).read().splitlines()
        if ext == "ply":
            assert f"element vertex {len(vt)}" in text
            assert f"element face {len(ft)}" in text
        else:
            assert sum(ln.startswith("f ") for ln in text) == len(ft)
        assert f"mesh: {len(vt)} verts {len(ft)} faces" in \
            capsys.readouterr().out
