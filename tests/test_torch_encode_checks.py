"""The JAX repository's encode and field-tail checks in the port
(`ngp_pl_torch.benchmarking.check_pallas_encode`, `check_field_tail`,
`check_bwd_parts`, `micro_encode_fwd`, `micro_encode_geom`), on the CPU at
small sizes (L=4, a few thousand samples): each runs with its plain
versions, under the JAX scripts' labels (read from those files), and is
held against the JAX package on the same inputs:
- check_field_tail's inputs are the JAX script's numpy draws, and the
  port's plain tail (what the CPU runs for K7) against the JAX script's
  `xla_tail` under jit: rgb within chip_smoke.py's K7 limit (4e-3
  absolute; one bf16 flip of a hidden unit moves rgb ~1e-3) and sigma
  within 1e-5 relative (no rounding after its sum);
- the slot math of check_bwd_parts and micro_encode_fwd against JAX's
  `_slots_local_frac_lm` on the scripts' points, bit-equal, and
  check_bwd_parts' run-repeated points hold each brick row for 1176 / R
  samples, as the JAX script's slots do;
- micro_encode_fwd's and micro_encode_geom's grids equal JAX's
  `make_grid_spec` of the same arguments."""
import importlib.util
import io
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.ops import hash_encoding as jhe
from ngp_pl_torch.benchmarking import (
    check_bwd_parts,
    check_field_tail,
    check_pallas_encode,
    micro_encode_fwd,
    micro_encode_geom,
)
from ngp_pl_torch.ops import field_tail as ft
from ngp_pl_torch.ops import hash_encoding as he

torch.set_num_threads(2)

JAX_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarking"
SMALL = dict(runs=1, warmup=0, log=io.StringIO())


def _labels(name):
    """The labels a JAX script passes to its `timeit`."""
    src = (JAX_DIR / f"{name}.py").read_text()
    return re.findall(r'timeit\(\s*f?"([^"]+)"', src)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", JAX_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("L, F", [(4, 2), (4, 4)])
def test_check_pallas_encode_runs_under_the_jax_labels(L, F, capsys):
    rec = check_pallas_encode.run(L, F, "cpu", n_check=512, n_time=512,
                                  runs=1, warmup=0)
    assert tuple(rec["times"]) == tuple(_labels("check_pallas_encode"))
    assert rec["ok"] and rec["rel_err"] == {"fwd": 0.0, "d_table": 0.0,
                                            "d_w1": 0.0}
    assert all(r["wall_ms"] > 0 and r["device_ms"] is None
               for r in rec["times"].values())
    err = capsys.readouterr().err
    assert f"geometry L={L} F={F} W={32 * F}" in err
    assert "fwd rel err: " in err and "bwd rel err: d_table " in err


def test_check_field_tail_inputs_and_tail_match_jax(capsys):
    """The inputs equal the JAX script's; the plain tail against its
    `xla_tail`; the port's check prints the JAX lines and OK."""
    jax_mod = _jax_script("check_field_tail")
    h1, sh, w2, wr1, wr2, wr3, g = check_field_tail.inputs()
    rng = np.random.default_rng(0)
    want = [rng.normal(0, 1, (8192, 64)), rng.normal(0, 0.3, (8192, 16))]
    want += [rng.normal(0, 0.2, s) for s in ((64, 16), (32, 64), (64, 64),
                                             (64, 3))]
    want.append(rng.normal(0, 1, (8192, 4)))
    for a, b in zip((h1, sh, w2, wr1, wr2, wr3, g), want):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    sig_j, rgb_j = jax.jit(jax_mod.xla_tail)(
        *(jnp.asarray(a) for a in (h1, sh, w2, wr1, wr2, wr3)))
    sig_t, rgb_t = ft.field_tail_plain(
        *(torch.from_numpy(a) for a in (h1, sh, w2, wr1, wr2, wr3)))
    assert np.abs(rgb_t.numpy() - np.asarray(rgb_j)).max() <= 4e-3
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5)
    rec = check_field_tail.run("cpu", n=1024)
    out = capsys.readouterr().out
    assert rec["ok"] and out.splitlines()[-1] == "OK"
    assert set(rec["bwd_rel_err"]) == set(check_field_tail.GRAD_NAMES)
    src = (JAX_DIR / "check_field_tail.py").read_text()
    assert 'names = ("d_h1", "d_w2", "d_wr1", "d_wr2")' in src
    for line in ("fwd: sigma rel err ", "bwd d_h1: rel err ",
                 "bwd d_wr2: rel err "):
        assert line in out
    assert rec["limits"]["K7_TOL"] == 4e-3


@pytest.mark.parametrize("F", [4, 2])
def test_check_bwd_parts_runs_and_slots_match_jax(F):
    rec = check_bwd_parts.run(F, "cpu", n=2048, **SMALL)
    parts = rec["parts"]
    assert set(_labels("check_bwd_parts")) <= set(parts)
    for label in check_bwd_parts.LABELS[3:]:
        assert parts[label]["wall_ms"] is None and parts[label]["null"]
    for label in check_bwd_parts.LABELS[:3] + check_bwd_parts.RUN_LABELS:
        assert parts[label]["wall_ms"] > 0, label
    spec = check_bwd_parts.geometry(F)
    jspec = (jhe.make_grid_spec() if F == 2 else
             JaxNGP(JaxTrainConfig().ngp_config(), need_x_grad=False).spec)
    x, *_ = check_bwd_parts.inputs(spec, 2048, "cpu")
    xr = check_bwd_parts.run_repeated_x(2048, "cpu")
    for pts in (x, xr):
        s_j = np.asarray(jhe._slots_local_frac_lm(
            jnp.clip(jnp.asarray(pts.numpy()), 0, 1), jspec)[0])
        s_t = he.slots_local_frac_lm(pts.clamp(0, 1), spec)[0]
        np.testing.assert_array_equal(s_t.numpy(), s_j)
    # a brick row of level l holds 1176 / R_l consecutive samples of a line
    slot = he.slots_local_frac_lm(xr.clamp(0, 1), spec)[0].numpy()
    for level, R in enumerate(spec.resolutions):
        line = slot[level, :check_bwd_parts.RUN_LINE]
        runs = np.diff(np.flatnonzero(np.diff(line)))
        assert abs(np.median(runs) - 1176 / R) <= 1.0, (level, R)


def test_micro_encode_fwd_runs_under_the_jax_labels():
    rec = micro_encode_fwd.run("cpu", n=2048, **SMALL)
    assert tuple(rec) == tuple(_labels("micro_encode_fwd"))
    for label, r in rec.items():
        assert (r["wall_ms"] is None) == (label in micro_encode_fwd.NULL)
    spec = micro_encode_fwd.geometry()
    jspec = jhe.make_grid_spec(n_levels=8, n_features=4,
                               per_level_scale=1.3819 ** 2)
    for f in ("resolutions", "offsets", "sizes", "log2_bricks"):
        assert getattr(spec, f) == getattr(jspec, f), f
    x, *_ = micro_encode_fwd.inputs(spec, 2048, "cpu")
    np.testing.assert_array_equal(
        he.slots_local_frac_lm(x, spec)[0].numpy(),
        np.asarray(jhe._slots_local_frac_lm(jnp.asarray(x.numpy()),
                                            jspec)[0]))


def test_micro_encode_geom_runs_under_the_jax_labels():
    src = (JAX_DIR / "micro_encode_geom.py").read_text()
    tags = re.findall(r'bench_spec\("([^"]+)"', src)
    assert tags == [t for t, _ in micro_encode_geom.geometries()]
    assert 'timeit(f"{tag} fwd"' in src and 'timeit(f"{tag} fwd+bwd"' in src
    b8 = float(np.exp(np.log(2048 * 0.5 / 16) / 7))
    jspecs = (jhe.make_grid_spec(n_levels=16, n_features=2,
                                 log2_hashmap_size=19,
                                 per_level_scale=1.3819),
              jhe.make_grid_spec(n_levels=8, n_features=4,
                                 log2_hashmap_size=19, per_level_scale=b8))
    for (tag, spec), jspec in zip(micro_encode_geom.geometries(), jspecs):
        for f in ("resolutions", "offsets", "sizes", "row_width"):
            assert getattr(spec, f) == getattr(jspec, f), (tag, f)
    tag, spec = micro_encode_geom.geometries()[1]
    rec = micro_encode_geom.bench_spec(tag, spec, "cpu", n=1024, **SMALL)
    assert rec[f"{tag} fwd"]["wall_ms"] > 0
    assert rec[f"{tag} fwd+bwd"]["device_ms"] is None
