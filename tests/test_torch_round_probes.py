"""The JAX repository's rounds-step, field-stack and geometry probes in the
port (`ngp_pl_torch.benchmarking.profile_rounds`, `micro_field`,
`ablate_geom`): their labels are the JAX scripts', read from those files;
each runs on the CPU at a tiny size; and micro_field's stack is JAX's
`_mlp_apply` stack (ngp_pl_tpu/models/ngp.py) on the same parameters
within the limits tests/test_torch_hdr.py holds `mlp_apply` to against
jitted JAX."""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_tpu.config import NGPConfig as JaxNGPConfig
from ngp_pl_tpu.models.ngp import NGP as JaxNGP
from ngp_pl_tpu.models.ngp import _mlp_apply
from ngp_pl_tpu.ops.sh import sh_encode as jax_sh_encode
from ngp_pl_tpu.ops.trunc_exp import trunc_exp as jax_trunc_exp
from ngp_pl_torch.benchmarking import ablate_geom, micro_field, profile_rounds
from ngp_pl_torch.benchmarking.profile_step import profile_system

torch.set_num_threads(2)

JAX_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmarking"
TINY = dict(n_levels=4, log2_hashmap_size=12)


def _labels(name):
    """The labels a JAX script passes to its `timeit`, f-strings as
    templates."""
    src = (JAX_DIR / f"{name}.py").read_text()
    return re.findall(r'timeit\(\s*f?"([^"]+)"', src)


@pytest.fixture(scope="module")
def rounds_run():
    """profile_rounds on bench.py's system at L=4, T=2^12, batch 256, no
    warm-up: one block in each layout, then every part once."""
    system = profile_system("cpu", 256, "rounds", **TINY)
    rec = profile_rounds.run(system, warm_steps=0, runs=1, block_runs=1,
                             grid_runs=1, warmup=0, log=None)
    return system, rec


def test_profile_rounds_labels_are_jax(rounds_run):
    """Every JAX label, its f-string fields filled with the run's values,
    is one of the port's; the port adds only the f16 table copy."""
    system, rec = rounds_run
    S, nb = rec["setup"]["S"], system.tcfg.grid_update_interval
    B = system.tcfg.batch_size
    want = []
    for label in _labels("profile_rounds"):
        if "{layout}" in label:
            want += [label.format(layout=lo, nb=nb)
                     for lo in profile_rounds.LAYOUTS]
        elif "{slots}" in label:
            want += [label.format(slots=max(256, B >> r), S=S)
                     for r in range(profile_rounds.ROUNDS)]
        else:
            want.append(label.format(chain_tr=system.chain_length))
    # at batch 256 the four rounds share one slot count, and so a label
    got = set(rec["parts"])
    assert got == set(want + [profile_rounds.F16_COPY])
    assert set(profile_rounds.FUSED) <= set(want)


def test_profile_rounds_runs(rounds_run):
    system, rec = rounds_run
    assert rec["setup"]["layout"] == "rounds" and system.freeze_buckets
    assert rec["setup"]["card"] == "cpu"
    for label, r in rec["parts"].items():
        assert r["wall_ms"] > 0 and r["device_ms"] is None, label
        assert ("port" in r) == (label in profile_rounds.FUSED), label


def test_profile_rounds_enc_only_parts(rounds_run):
    system, _ = rounds_run
    parts = profile_rounds.part_fns(system, enc_only=True)
    assert not any("rounds" in k or "(slots " in k for k in parts)
    assert "pallas encode fwd (decode+wrow+mxu)" in parts
    assert torch.isfinite(parts["field tail fwd+bwd(dh1)"]())


def test_micro_field_labels_are_jax():
    assert tuple(_labels("micro_field")) == (micro_field.MAIN
                                             + micro_field.BISECT)


def test_micro_field_stack_matches_jax():
    """The port's stack (`mlp_apply`) and its gradients to the parameters
    and h1 against the JAX script's `stack` under jit on the same
    parameters and inputs: within rtol 1e-5."""
    kw = dict(scale=0.5, n_features_per_level=4, **TINY)
    jngp = JaxNGP(JaxNGPConfig(**kw), need_x_grad=False)
    params = jngp.init(jax.random.PRNGKey(0))
    ngp = micro_field.model("cpu", **TINY)
    ngp.load_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(0)
    h1 = rng.normal(size=(4096, 64)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cfg = jngp.cfg

    def stack(p, h):
        hh = _mlp_apply(p["sigma_mlp"][1:], jax.nn.relu(h), jngp.dtype)
        sigma = jax_trunc_exp(hh[:, 0])
        sh = jax_sh_encode((jnp.asarray(d) + 1.0) * 0.5, cfg.sh_degree)
        rgb = _mlp_apply(p["rgb_mlp"], jnp.concatenate([sh, hh], axis=-1),
                         jngp.dtype, out_act=jax.nn.sigmoid)
        return sigma, rgb

    def loss(p, h):
        s, r = stack(p, h)
        return s.sum() + r.sum()

    s_j, r_j = jax.jit(stack)(params, jnp.asarray(h1))
    gp, gh = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(h1))
    h = torch.from_numpy(h1).requires_grad_(True)
    s_t, r_t = micro_field.stack(ngp, h, torch.from_numpy(d))
    np.testing.assert_allclose(s_t.detach().numpy(), s_j, rtol=1e-5)
    np.testing.assert_allclose(r_t.detach().numpy(), r_j, rtol=1e-5)
    ws = list(ngp.sigma_mlp[1:]) + list(ngp.rgb_mlp)
    grads = torch.autograd.grad(s_t.sum() + r_t.sum(), ws + [h])
    want = list(gp["sigma_mlp"][1:]) + list(gp["rgb_mlp"]) + [gh]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-12)


def test_micro_field_runs():
    assert micro_field.model("cpu").cfg.n_features_per_level == 4
    rec = micro_field.run("cpu", n=2048, runs=1, warmup=0, log=None, **TINY)
    assert tuple(rec) == micro_field.MAIN + micro_field.BISECT
    assert all(r["wall_ms"] > 0 and r["device_ms"] is None
               for r in rec.values())


def test_ablate_geom_prints_both_lines():
    """Both geometries at T=2^12 and batch 256 on 16x16 views, after 8
    steps and 8 timed ones (one grid refresh each, a quarter of the cells:
    no warmup), in the JAX script's line."""
    src = (JAX_DIR / "ablate_geom.py").read_text()
    assert 'print(f"{tag}: rays/s {rps:.0f}  psnr' in src
    lines, recs = [], []
    for tag, n_levels, n_features in ablate_geom.GEOMETRIES:
        system = ablate_geom.system_for(n_levels, n_features, 8, "cpu",
                                        batch=256, tag=tag, img_size=16,
                                        log2_hashmap_size=12,
                                        grid_warmup_steps=0)
        recs.append(ablate_geom.run(tag, system, 8, timed_steps=8, log=None,
                                    emit=lines.append))
    line = (r"^{}: rays/s \d+  psnr [0-9.]+  ssim [0-9.]+  layout "
            r"(csr|strided|rounds) x\d+$")
    for tag, ln in zip(("L16F2", "L8F4"), lines, strict=True):
        assert re.match(line.format(tag), ln), ln
    assert all(np.isfinite(r["psnr"]) and r["rays_per_s"] > 0 for r in recs)


@pytest.mark.parametrize("only, tags", [("L16F2", ["L16F2"]),
                                        ("L8F4", ["L8F4"]),
                                        ("", ["L16F2", "L8F4"])])
def test_ablate_geom_only(monkeypatch, only, tags):
    """`--only` as the JAX script reads it: a geometry's tag runs it
    alone, anything else runs both."""
    monkeypatch.setattr(ablate_geom, "system_for",
                        lambda n_levels, n_features, *a, **k: n_levels)
    monkeypatch.setattr(ablate_geom, "run",
                        lambda tag, system, steps, **k: tag)
    assert ablate_geom.main(["--device", "cpu", "--only", only]) == tags
