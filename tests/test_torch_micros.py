"""The JAX repository's six primitive micros and its quick-train script in
the port (`ngp_pl_torch.benchmarking.micro`, `micro_r2`, `micro_r2b`,
`micro_r2c`, `micro_r4`, `micro_scatter`, `train_quick`): each script's
labels are the JAX script's, rendered from its source at its own shapes;
each primitive, at small shapes and on the port's numpy inputs, gives what
the JAX script's `jnp` expression gives (gathers, top-k, argsort and the
compaction exactly, sums within 1e-5 of their largest magnitude); each
`port: ` call agrees with its primitive; micro_r4's per-ray counts are
the JAX package's `march_rays_train_strided` counts on the same window
rows and rays; every script runs end to end on the CPU; train_quick's
configuration is _train_tpu.py's, field for field, and a tiny run of it
validates."""
import ast
import dataclasses
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_pl_torch.benchmarking import (
    micro,
    micro_prims,
    micro_r2,
    micro_r2b,
    micro_r2c,
    micro_r4,
    micro_scatter,
    train_quick,
)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_DIR = REPO / "benchmarking"
SUM_TOL = 1e-5                  # sums: of the largest magnitude
MODULES = {"micro": micro, "micro_r2": micro_r2, "micro_r2b": micro_r2b,
           "micro_r2c": micro_r2c, "micro_r4": micro_r4,
           "micro_scatter": micro_scatter}
SMALL = {"micro": dict(N=512, log2_hashmap_size=12, rays=32, chain=64,
                       pool=1024),
         "micro_r2": dict(N=512, rows_total=1000, rays=64),
         "micro_r2b": dict(N=256, rows_total=500),
         "micro_r2c": dict(N=512, S=256, rays=64, chain=96),
         "micro_scatter": dict(N=1024, R=256, rays=64)}
R4_SMALL = dict(steps=16, batch=256, N=512, n_levels=8, log2_hashmap_size=12)


def _timeit_labels(name, env):
    """The labels the JAX script's `main` passes to `timeit`, in order:
    its statements walked with `env`, each assignment that evaluates
    there kept, each loop over what evaluates unrolled, the bodies of
    its jitted functions skipped."""
    tree = ast.parse((JAX_DIR / f"{name}.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    labels = []

    def ev(node):
        return eval(compile(ast.Expression(node), name, "eval"), env)

    def bind(target, value):
        if isinstance(target, ast.Name):
            env[target.id] = value
        elif isinstance(target, ast.Tuple):
            for t, v in zip(target.elts, value):
                bind(t, v)

    def walk(body):
        for st in body:
            if isinstance(st, ast.For):
                try:
                    items = list(ev(st.iter))
                except Exception:
                    continue
                for item in items:
                    bind(st.target, item)
                    walk(st.body)
            elif isinstance(st, ast.Assign):
                if (isinstance(st.value, ast.Call)
                        and getattr(st.value.func, "id", "") == "timeit"):
                    labels.append(ev(st.value.args[0]))
                    continue
                try:
                    value = ev(st.value)
                except Exception:
                    continue
                for t in st.targets:
                    bind(t, value)
            elif (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)
                  and getattr(st.value.func, "id", "") == "timeit"):
                labels.append(ev(st.value.args[0]))

    walk(main.body)
    return tuple(labels)


def _jax_env(name):
    from ngp_pl_tpu.config import TrainConfig
    from ngp_pl_tpu.models.ngp import grid_spec_for
    from ngp_pl_tpu.ops.hash_encoding import make_grid_spec

    fake = types.SimpleNamespace(float32=type("float32", (), {}),
                                 bfloat16=type("bfloat16", (), {}))
    env = {"jnp": fake, "int": int, "range": range}
    if name == "micro":
        env["make_grid_spec"] = make_grid_spec
    if name == "micro_r4":
        env["ngp"] = types.SimpleNamespace(
            spec=grid_spec_for(TrainConfig().ngp_config()))
    return env


@pytest.mark.parametrize("name", list(MODULES))
def test_labels_are_jax(name):
    mod = MODULES[name]
    assert _timeit_labels(name, _jax_env(name)) == mod.LABELS
    keys = getattr(mod, "KEYS", mod.LABELS + mod.PORT_LABELS)
    assert len(set(keys)) == len(keys) == len(mod.LABELS) + len(
        mod.PORT_LABELS)
    assert all(p.startswith("port: ") for p in mod.PORT_LABELS)
    assert set(mod.NOTES) - set(keys) <= {"*", "port: K6"}


def _np(t):
    if isinstance(t, (list, tuple)):
        return [_np(v) for v in t]
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _dups(*idx) -> int:
    """The most rows any one index takes, over the index arrays."""
    return max(int(np.unique(_np(i), return_counts=True)[1].max())
               for i in idx)


def _close(got, want, exact):
    """Equal (`exact` True); within SUM_TOL of max (False); or, for sums
    into bf16 zeros (`exact` an int: the most adds into one row), within
    one bf16 rounding step of max an add, since each add rounds to bf16
    and the two scatters add in their own orders."""
    tol = SUM_TOL if exact is False else 2.0 ** -8 * exact
    got, want = _np(got), [np.asarray(w) for w in (
        want if isinstance(want, (list, tuple)) else [want])]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    if exact is True:
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w.astype(g.dtype))
        return
    g = np.concatenate([np.ravel(a).astype(np.float64) for a in got])
    w = np.concatenate([np.ravel(a).astype(np.float64) for a in want])
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= tol * np.abs(w).max()


def _j(t, dtype=None):
    a = jnp.asarray(_np(t))
    return a.astype(dtype) if dtype is not None else a


def _u32(t):
    return jnp.asarray(_np(t).view(np.uint32))


def _scatter(n, idx, rows, dtype=None, mode=None):
    dtype = dtype or rows.dtype
    z = jnp.zeros((n,) + rows.shape[1:], dtype)
    return z.at[idx].add(rows, mode=mode) if mode else z.at[idx].add(rows)


def _micro_jax(inp):
    """benchmarking/micro.py's expressions, by label (exact or not)."""
    from ngp_pl_tpu.ops.hash_encoding import (
        _slots_local_frac_lm,
        _wrow_lm,
        expand_w1,
    )
    from ngp_pl_tpu.ops.hash_encoding import make_grid_spec
    from ngp_pl_tpu.ops.ray_march import _compact_to_pool

    spec = make_grid_spec(log2_hashmap_size=inp["spec"].log2_bricks + 5)
    assert spec.sizes == inp["spec"].sizes
    N, L, W = inp["N"], spec.n_levels, spec.row_width
    table, d_rows = _j(inp["table"]), _j(inp["d_rows"])
    slot, coh = _j(inp["slot"]), _j(inp["slot_coh"])

    def per_level(s):
        return [_scatter(spec.sizes[l], s[l * N:(l + 1) * N] - spec.offsets[l],
                         d_rows[l * N:(l + 1) * N]) for l in range(L)]

    def dedup(slot):
        parts = []
        for l in range(L):
            s = slot[l * N:(l + 1) * N]
            d = d_rows[l * N:(l + 1) * N]
            new = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
            seg_id = jnp.cumsum(new.astype(jnp.int32)) - 1
            run_sum = jnp.zeros((N, W), jnp.float32).at[seg_id].add(d)
            parts.append(jnp.zeros((spec.sizes[l], W), jnp.float32).at[
                jnp.where(new, s - spec.offsets[l], spec.sizes[l])].add(
                jnp.where(new[:, None], run_sum, 0.0), mode="drop"))
        return parts

    keys_a = _j(inp["keys_a"])
    occ = _j(inp["occ"])
    B, K = occ.shape
    kk = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (B, K))
    x, w1 = _j(inp["x"]), _j(inp["w1"])
    sl, local, frac = _slots_local_frac_lm(x, spec)
    rows = table[sl.reshape(-1)].reshape(L, N, W)
    wr = (rows.astype(jnp.float32) * _wrow_lm(local, frac, spec)).astype(
        jnp.bfloat16)
    h1 = jax.lax.dot_general(
        wr, expand_w1(w1, spec).astype(jnp.bfloat16),
        dimension_numbers=(((0, 2), (0, 1)), ((), ())),
        preferred_element_type=jnp.float32)
    return dict(zip(micro.LABELS, (
        (table[slot], True), (table[coh], True),
        (jnp.zeros((spec.total_rows, W)).at[slot].add(d_rows), False),
        (per_level(slot), False), (per_level(coh), False),
        (dedup(coh), False),
        (_u32(inp["occ_rows"])[_j(inp["line_idx"])], True),
        (jax.lax.top_k(keys_a, micro.TOPK_K), True),
        (jnp.argsort(keys_a, axis=1), True),
        (_compact_to_pool(occ, kk, _j(inp["t0"]), B, K, 1024, inp["pool"],
                          0.0, 0.001, 0.01), True),
        ((sl, local, frac), True), (rows, True), (wr, True), (h1, False))))


def _micro_r2_jax(inp):
    out = [(tb[s].astype(jnp.float32), True) for tb, s in (
        (_j(tb, jnp.bfloat16 if tb.dtype == torch.bfloat16 else None), _j(s))
        for tb, s in inp["gathers"])]
    for tgt, d, s in inp["scatters"]:
        bf = d.dtype == torch.bfloat16
        dj = _j(d, jnp.bfloat16 if bf else None)
        out.append((_scatter(tgt, _j(s), dj).astype(jnp.float32),
                    _dups(s) if bf else False))
    d8, s8 = _j(inp["d_rows8"]), _j(inp["slots8"])
    out.append(([_scatter(n, s8[l], d8[l])
                 for l, n in enumerate(micro_r2.BWD_SIZES)], False))
    for S, s, d in inp["one_hot"]:
        oh = jax.nn.one_hot(_j(s), S, dtype=jnp.bfloat16)
        out.append((jax.lax.dot_general(
            oh, _j(d, jnp.bfloat16), (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32), False))
    out += [(jax.ops.segment_sum(_j(inp["payload"]), _j(inp["seg"]),
                                 num_segments=inp["rays"] + 1), False),
            (jnp.cumsum(_j(inp["x"])), False),
            (_u32(inp["win"])[_j(inp["idx"])], True),
            (_u32(inp["win2"])[_j(inp["idx2"])], True)]
    return dict(zip(micro_r2.KEYS, out))


def _micro_r2b_jax(inp):
    slot = _j(inp["slot"])
    bf = lambda t: _j(t, jnp.bfloat16 if t.dtype == torch.bfloat16  # noqa
                      else None)
    out = [(bf(tb)[slot].astype(jnp.float32), True) for tb in inp["tables"]]
    out += [(_scatter(micro_r2b.SCATTER_ROWS, _j(s), bf(d)).astype(
        jnp.float32), _dups(s) if d.dtype == torch.bfloat16 else False)
        for d, s in inp["scatters"]]
    s4 = _j(inp["s4"])
    for d, dt, ex in ((bf(inp["d4"]), jnp.bfloat16, _dups(*inp["s4"])),
                      (_j(inp["d4f"]), jnp.float32, False)):
        out.append(([_scatter(n, s4[p], d[p], dt).astype(jnp.float32)
                     for p, n in enumerate(micro_r2b.PAIR_SIZES)], ex))
    out += [(_j(inp["pay"])[_j(inp["perm"])], True),
            (jnp.cumsum(_j(inp["x"]), axis=1), False)]
    return dict(zip(micro_r2b.KEYS, out))


def _micro_r2c_jax(inp):
    L, W = micro_r2c.L, micro_r2c.W
    N, S = inp["N"], inp["S"]
    table, s, s_lvl = _j(inp["table"]), _j(inp["slots"]), _j(inp["slots_lvl"])
    rows = _j(inp["rows"])
    rows_bf = _j(inp["rows_bf"], jnp.bfloat16)
    oh = (s_lvl[0][:, None] & 511) == jnp.arange(512)[None, :]
    v, i = jax.lax.top_k(_j(inp["keys"]), micro_r2c.TOP_K)
    h = _j(inp["x"], jnp.bfloat16)
    for _ in range(4):
        h = jnp.maximum(h @ _j(inp["w"], jnp.bfloat16), 0)
    return dict(zip(micro_r2c.LABELS, (
        (table[s.reshape(-1)].reshape(L, N, W), True),
        (_j(inp["table_bf"], jnp.bfloat16)[s.reshape(-1)].reshape(L, N, W),
         True),
        (table[s[0]], True), (_j(inp["vec"])[s.reshape(-1)], True),
        (jnp.stack([_scatter(S, s_lvl[l], rows[l]) for l in range(L)]),
         False),
        (_scatter(512, s_lvl[0] & 511, rows[0]), False),
        (jnp.stack([_scatter(S, s_lvl[l], rows_bf[l].astype(jnp.float32))
                    for l in range(L)]), False),
        (jax.lax.dot_general(oh.astype(jnp.bfloat16),
                             rows[0].astype(jnp.bfloat16),
                             (((0,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32), False),
        (_j(inp["big"]) * 1.0001 + 0.5, False),
        (jnp.cumsum(_j(inp["flat"])), False),
        (jax.ops.segment_sum(_j(inp["pool8"]), _j(inp["seg"]),
                             num_segments=inp["rays"] + 1), False),
        ((v, i), True), (h, "bf16"))))


def _micro_scatter_jax(inp):
    R, N = inp["R"], inp["N"]
    d128, s8 = _j(inp["d128"]), _j(inp["slots8"])
    d256, d256b = _j(inp["d256"]), _j(inp["d256b"], jnp.bfloat16)
    d1 = d128[0]
    x, xw = _j(inp["x"]), _j(inp["xw"])

    def hier(a):
        x2 = a.reshape(512, N // 512, *a.shape[1:])
        inner = jnp.cumsum(x2, axis=1)
        carry = jnp.concatenate([jnp.zeros((1,) + a.shape[1:], jnp.float32),
                                 jnp.cumsum(inner[:, -1], axis=0)[:-1]])
        return inner + carry[:, None]

    seg, offs = _j(inp["seg"]), _j(inp["offs"])
    cs_full = hier(xw).reshape(N, 8)
    padded = jnp.concatenate([jnp.zeros((1, 8), jnp.float32), cs_full])
    ends = jnp.concatenate([offs[1:], jnp.asarray([N], offs.dtype)])
    out = [([_scatter(R, s8[l], d128[l]) for l in range(8)], False),
           ([_scatter(R, s8[p], d256[p]) for p in range(4)], False),
           ([_scatter(R, s8[p], d256b[p].astype(jnp.float32))
             for p in range(4)], False)]
    out += [(_scatter(R, _j(s), d1, mode="drop"), False)
            for s in inp["oob"]]
    out += [(_scatter(R, _j(s), d1), False) for s in inp["runs"]]
    out += [(_scatter(R, _j(s), d1[:s.shape[0]]), False)
            for s in inp["dedup"]]
    out += [(jnp.cumsum(x), False), (hier(x), False),
            (jnp.cumsum(xw, axis=0), False), (hier(xw), False),
            (jax.ops.segment_sum(xw, seg, num_segments=inp["rays"]), False),
            (padded[ends] - padded[offs], False)]
    return dict(zip(micro_scatter.LABELS, out))


JAX_EXPRESSIONS = {"micro": _micro_jax, "micro_r2": _micro_r2_jax,
                   "micro_r2b": _micro_r2b_jax, "micro_r2c": _micro_r2c_jax,
                   "micro_scatter": _micro_scatter_jax}
PORT_TOL = {"K1": 1e-5, "K3": 1e-5, "K6": 1e-5, "K2+K5": 1e-5, None: 1e-5}


@pytest.mark.parametrize("name", list(JAX_EXPRESSIONS))
def test_primitives_match_jax(name):
    """Every JAX label's result on the port's inputs against the JAX
    script's expression on the same numbers; the port's calls against
    their primitives."""
    mod = MODULES[name]
    inp = mod.inputs("cpu", **SMALL[name])
    fns = mod.functions(inp)
    want = JAX_EXPRESSIONS[name](inp)
    keys = getattr(mod, "KEYS", mod.LABELS + mod.PORT_LABELS)
    assert list(want) == list(keys[:len(mod.LABELS)])
    for key, (expr, exact) in want.items():
        got = fns[key]()
        if exact == "bf16":      # bf16 outputs: one rounding step of max
            g, w = _np(got), np.asarray(expr.astype(jnp.float32))
            assert np.abs(g - w).max() <= 2.0 ** -8 * np.abs(w).max(), key
            continue
        _close(got, expr, exact)
    errs = micro_prims.port_errors(fns, mod.references(inp, fns))
    assert set(errs) == set(mod.PORT_LABELS)
    for label, (kernel, err) in errs.items():
        assert err <= PORT_TOL[kernel], (label, err)


@pytest.fixture(scope="module")
def r4_system():
    return micro_r4.fit_system("cpu", **{k: v for k, v in R4_SMALL.items()
                                         if k != "N"})


def test_micro_r4_counts_match_jax(r4_system):
    """The fitted window rows and the drawn rays through the JAX package's
    march give the port's per-ray counts; the scatter variants and
    gathers match the JAX script's expressions; K2+K5 its plain
    version."""
    from ngp_pl_tpu.models.rendering import scene_hits
    from ngp_pl_tpu.ops.hash_encoding import _slots_local_frac_lm
    from ngp_pl_tpu.ops.ray_march import march_rays_train_strided

    system, fit = r4_system
    assert len(fit["losses"]) == 1 and np.isfinite(fit["losses"][0])
    rng = np.random.default_rng(0)
    rays = micro_r4.count_rays(system, R4_SMALL["batch"], rng)
    got = micro_r4.occupied_counts(system, *rays).numpy()
    cfg, rcfg = system.cfg, system.rcfg
    ro, rd, noise = (jnp.asarray(r.numpy()) for r in rays)
    hits = scene_hits(ro, rd, cfg.scale)
    want = march_rays_train_strided(
        ro, rd, hits, noise, None, cascades=cfg.cascades, scale=cfg.scale,
        exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
        max_samples=rcfg.max_samples, n_samples=8,
        chain_length=system.chain_full,
        win_rows=jnp.asarray(system.grid_state.win_rows.numpy())).rm_counts
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.max() > 8
    lines = micro_r4.count_lines(got)
    assert lines[0].startswith("occupied-count percentiles: {50: ")

    inp = micro_r4.inputs(system, rng, R4_SMALL["N"])
    fns = micro_r4.functions(inp)
    from ngp_pl_tpu.models.ngp import grid_spec_for
    from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig

    spec = grid_spec_for(JaxTrainConfig(
        n_levels=8, log2_hashmap_size=12).ngp_config())
    assert spec.sizes == inp["spec"].sizes
    slot = _slots_local_frac_lm(_j(inp["xs"]), spec)[0]
    np.testing.assert_array_equal(_np(inp["slot"]), np.asarray(slot))
    L, W, N = spec.n_levels, spec.row_width, R4_SMALL["N"]
    d_bf = _j(inp["d_bf"], jnp.bfloat16)
    d_f32 = d_bf.astype(jnp.float32)
    off = jnp.asarray(spec.offsets)[:, None]

    def per(d, dt):
        return [_scatter(spec.sizes[l], slot[l] - off[l], d[l], dt)
                for l in range(L)]

    want = [per(d_f32, jnp.float32), per(d_bf.astype(jnp.float32),
                                         jnp.float32),
            per(d_bf, jnp.bfloat16),
            _scatter(spec.total_rows, slot.reshape(-1),
                     d_bf.reshape(L * N, W).astype(jnp.float32))]
    for l in micro_r4.LEVELS:
        sl = slot[l] - off[l]
        want += [_scatter(spec.sizes[l], s, d_bf[l].astype(jnp.float32))
                 for s in (sl, jnp.sort(sl))]
    packed = jnp.zeros((spec.total_rows, W // 2), jnp.uint32)
    wide = jnp.zeros((spec.total_rows, W), jnp.uint32)
    exact = [packed[slot.reshape(-1)], packed[slot[:4].reshape(-1)],
             wide[slot[:4].reshape(-1)]]
    bf16_tgt = _dups(*(inp["slot"][l] for l in range(L)))
    for key, w in zip(micro_r4.LABELS, want):
        _close(fns[key](), w, bf16_tgt if "bf16 tgt" in key else False)
    for key, w in zip(micro_r4.LABELS[len(want):], exact):
        _close(fns[key](), w, True)
    errs = micro_prims.port_errors(fns, micro_r4.references(inp, fns))
    assert errs[micro_r4.PORT_LABELS[0]][1] <= PORT_TOL["K2+K5"]


@pytest.mark.parametrize("name", list(SMALL))
def test_scripts_run(name, capsys):
    """`main --device cpu` at small shapes: the card line first, the JSON
    line of every label last, each with a wall ms and no device ms."""
    mod = MODULES[name]
    argv = ["--device", "cpu", "--runs", "1", "--warmup", "0"]
    for k, v in SMALL[name].items():
        argv += [f"--{k}", str(v)]
    mod.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[0])["card"] == "cpu"
    rec = json.loads(out[-1])
    keys = getattr(mod, "KEYS", mod.LABELS + mod.PORT_LABELS)
    assert list(rec) == list(keys)
    assert all(r["wall_ms"] > 0 and r["device_ms"] is None
               for r in rec.values())


def test_micro_r4_runs(r4_system, capsys):
    """micro_r4's parts timed on the fitted system; its `main` prints the
    fit and counts, then every label."""
    system, _ = r4_system
    rec = micro_r4.time_parts(
        micro_r4.inputs(system, np.random.default_rng(1), 256), "cpu",
        runs=1, warmup=0, log=None)
    assert list(rec) == list(micro_r4.KEYS)
    assert all(r["wall_ms"] > 0 for r in rec.values())


def _train_tpu_kwargs():
    """The keywords of _train_tpu.py's TrainConfig call."""
    tree = ast.parse((REPO / "_train_tpu.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "TrainConfig")
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords}


def test_train_quick_config_is_jax():
    from ngp_pl_tpu.config import TrainConfig as JaxTrainConfig

    jax_cfg = JaxTrainConfig(**_train_tpu_kwargs())
    port_cfg = train_quick.config()
    ported = {f.name for f in dataclasses.fields(port_cfg)}
    assert set(_train_tpu_kwargs()) <= ported
    shared = {f.name for f in dataclasses.fields(JaxTrainConfig)} & ported
    for n in sorted(shared):
        assert getattr(port_cfg, n) == getattr(jax_cfg, n), n
    src = (REPO / "_train_tpu.py").read_text()
    assert 'SyntheticDataset(split="train", img_size=256, n_train=24)' in src
    assert 'SyntheticDataset(split="test", img_size=256, n_test=2)' in src
    assert "fit(max_steps=2000)" in src and "save_images=True" in src


def test_train_quick_runs(tmp_path, monkeypatch):
    """32 steps at 16x16 on 2 views (L=4, T=2^12, 256 rays a step), then
    both test views scored and dumped."""
    monkeypatch.chdir(tmp_path)
    lines = []
    rec = train_quick.run("cpu", steps=32, img_size=16, n_train=2,
                          emit=lines.append, n_levels=4,
                          log2_hashmap_size=12, batch_size=256)
    assert [ln.split("] ")[1].split(":")[0] for ln in lines] == [
        "data ready", "trained", "val"]
    assert np.isfinite(rec["scores"]["psnr"]) and rec["scores"]["ssim"] > 0
    assert np.isfinite(rec["loss_first"])
    assert rec["launches"] == {k: 0 for k in train_quick.KERNELS}
    dumps = sorted(p.name for p in (tmp_path / "results" / "synthetic"
                                    / "qual").iterdir())
    assert dumps == ["000.png", "000_d.png", "001.png", "001_d.png"]
