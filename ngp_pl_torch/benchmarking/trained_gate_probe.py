"""The trained-state gates of chip_smoke.py, fit by fit, on each fitted
scene, and a wrong encode kernel and a wrong K7 held to them (card only).

    python -m ngp_pl_torch.benchmarking.trained_gate_probe [--fits 5]
        [--disk_fits 3]
        [--scene {flagship,disk,strided,rounds,l16f2,mc} ...]

Each scene is fitted as chip_smoke.py fits it and held to chip_smoke's gate
of that scene (`chip_smoke.trained_gate`, TRAINED_GATES; `--fits` fits a
scene, `--disk_fits` for the disk scene; by default the flagship and the
disk scene):
  flagship  `train_setup.train_config()`, 512 steps (`chip_smoke.
            train_fit`), CSR pinned, seeds 7-10
  disk      chip_smoke's Blender scene on disk, written once, trained
            through `ngp_pl_torch.train.main` as chip_smoke's `train_disk`
            trains it (CSR, 512 steps), then the gate on seeds 7-10
            (chip_smoke holds seed 7)
  strided, rounds  the flagship pinned to the strided layout, and to
            rounds with the distortion loss at 1e-2, 512 steps; seed 7
  l16f2     L=16, F=2 (K3, K4), 512 steps; seeds 7-8
  mc        `bench_mc.bench_mc_system` (scale 4), 512 steps; seeds 7-10
Training on the card is not bit-reproducible (the table gradient's
atomics), so each fit draws its state anew.

The gate: the kernels' step within the scene's limit of the plain
versions' step on the card, or else held as two parts.  The encode kernel
(K1, K3 at L16F2) passes with its h1 and feats within K1_TOL of the plain
ones on every call, and alone within that limit of the plain versions'
step or of the plain step that takes its bf16 roundings of h1
(`h1_rounded_as`).  The
other kernels pass within the limit against the step with the encode
kernel alone, or the backward kernels pass within the limit against the
step with the encode kernel and K7.  K7 is held on every call of that
step by its own error (`k7_by_rounding`): its hidden values and outputs
within K7_ROUNDED_TOL of the plain tail that takes its bf16 roundings.
Per batch a JSON line: the encode kernel alone and K7 alone against the
plain versions' step, the encode kernel's witness `witness_h1_flips`, what
`h1_rounded_as` and `k7_by_rounding` read, the other kernels against the
encode kernel alone and the backward kernels against it and K7, and the
verdicts of the gate, of the scene's gate as it was before (`before`:
the flagship's and the disk scene's without `k7_by_rounding`; the strided
and rounds steps against the plain versions' step alone; L16F2's K3 and
K4 each alone and the whole step; scale 4's witness gate) and of the
witness gate.

Then the same gates with stand-ins, on each scene's last fit: for the
encode kernel, its h1 plus or minus `WRONG_REL` of max |h1| (10 x K1_TOL)
on alternate values (the flagship and every scene but the disk's); for
K7, its rgb plus `WRONG_REL` of max |rgb| (10 x K7_ROUNDED_TOL), and plus
or minus that on alternate values.  The gates must refuse each.  The last
line: every fit's verdicts, and whether each stand-in was refused.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WRONG_REL = 1e-4               # each stand-in's miss, of its output's max
DISK_ROOT = os.path.join(REPO, "build", "trained_gate_probe", "lego")


def chip_smoke():
    """chip_smoke.py of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _alternate(torch, t, rel):
    sign = 1.0 - 2.0 * (torch.arange(t.numel(), device=t.device)
                        .reshape(t.shape) % 2)
    return t + sign * (rel * t.abs().max())


# the encode kernels' entry points in csrc/hash_encode_fwd.cu
ENTRIES = {"K1": "hash_encode_fwd", "K3": "hash_encode_fwd_f2"}


@contextlib.contextmanager
def wrong_k1(torch, rel: float = WRONG_REL, key: str = "K1"):
    """Within the block every launch of the encode kernel `key` (K1 or K3;
    the step's and `h1_rounded_as`'s) returns its h1 plus and minus `rel`
    of max |h1| on alternate values."""
    from ngp_pl_torch.ops import hash_encoding as he

    real = he._launch_fwd

    def launch(wrapper, entry, F, x, table, w1, spec, feats):
        h = real(wrapper, entry, F, x, table, w1, spec, feats)
        return h if entry != ENTRIES[key] else _alternate(torch, h, rel)

    he._launch_fwd = launch
    try:
        yield
    finally:
        he._launch_fwd = real


@contextlib.contextmanager
def wrong_k7(torch, alternate: bool, rel: float = WRONG_REL):
    """Within the block every K7 launch (the step's and `k7_by_rounding`'s)
    returns its rgb plus `rel` of max |rgb|, or with `alternate` plus and
    minus that on alternate values."""
    from ngp_pl_torch.ops import field_tail as ft

    real = ft.launch_k7

    def launch(*args):
        sigma, rgb = real(*args)
        return sigma, (_alternate(torch, rgb, rel) if alternate
                       else rgb + rel * rgb.abs().max())

    ft.launch_k7 = launch
    try:
        yield
    finally:
        ft.launch_k7 = real


def batch_line(cs, b: dict, scene: str = "flagship") -> dict:
    """The readings of one batch of `train_reference`'s record, and the
    verdict of `scene`'s gate as it was before (see the module's
    docstring)."""
    gate = cs.TRAINED_GATES[scene]
    tol = gate["card_tol"]

    def within(e):
        return (e["pool_identical"] and e["loss_rel_err"] <= tol[0]
                and e["grad_rel_err_gate"] <= tol[1]
                and e["tail_grad_rel_err_max"] <= max(tol[1], cs.TAIL_TOL))

    pair = lambda e: [e["loss_rel_err"], e["grad_rel_err_max"]]  # noqa: E731
    alone = b["alone_vs_plain_on_card"]
    enc = next(iter(alone))
    if scene in ("flagship", "disk"):
        before = b["rounding_gate_pass"] and (
            within(b["vs_plain_on_card"])
            or within(b["vs_encode_alone_on_card"]))
    elif scene == "l16f2":
        before = within(b["vs_plain_on_card"]) and all(
            within(alone[k]) for k in gate["alone"])
    elif scene == "mc":
        before = b["witness_gate_pass"] and (
            within(b["vs_plain_on_card"])
            or within(b["vs_encode_alone_on_card"]))
    else:
        before = within(b["vs_plain_on_card"])
    return dict(
        seed=b["seed"], encode=enc, encode_alone=pair(alone[enc]),
        k7_alone=pair(alone["K7"]),
        vs_plain_on_card=pair(b["vs_plain_on_card"]),
        witness=pair(b["witness_h1_flips"]),
        alone_over_witness=b["alone_over_witness"],
        rounded=b["encode_rounded"],
        vs_rounded_plain_on_card=pair(b["vs_rounded_plain_on_card"]),
        rounding_gate_pass=b["rounding_gate_pass"],
        vs_encode_alone_on_card=pair(b["vs_encode_alone_on_card"]),
        tail_rounded=b["tail_rounded"], k7_gate_pass=b["k7_gate_pass"],
        vs_encode_and_k7_on_card=pair(b["vs_encode_and_k7_on_card"]),
        tail_gate_pass=b["tail_gate_pass"],
        card_gate=b.get("card_gate"), cpu_gate=b.get("cpu_gate"),
        gate_pass_before=before,
        witness_gate_pass=b["witness_gate_pass"])


def disk_fit(cs, root):
    """The disk scene under `root` trained as chip_smoke's `train_disk`
    trains it; returns the system."""
    from ngp_pl_torch import train as ttrain

    with cs._build_tmp() as tmp, contextlib.chdir(tmp):
        system, _ = ttrain.main([
            "--dataset_name", "nerf", "--root_dir", root,
            "--train_layout", "csr", "--num_epochs", "1",
            "--iters_per_epoch", str(cs.DISK_STEPS), "--max_images", "2",
            "--exp_name", "disk", "--num_devices", "1"])
    return system


SCENES = ("flagship", "disk", "strided", "rounds", "l16f2", "mc")


def fit_scene(torch, cs, scene):
    """A system of `scene` fitted as chip_smoke fits it."""
    from ngp_pl_torch.benchmarking.bench_mc import bench_mc_system
    from ngp_pl_torch.benchmarking.train_setup import train_config, \
        train_system

    if scene == "disk":
        return disk_fit(cs, DISK_ROOT)
    if scene == "mc":
        system = bench_mc_system("cuda", cs.MC_STEPS)
        cs.train_fit(torch, system, cs.MC_STEPS)
        return system
    system = train_system(train_config(**cs.SCENE_CONFIGS[scene]))
    cs.train_fit(torch, system)
    return system


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--fits", type=int, default=5)
    ap.add_argument("--disk_fits", type=int, default=3)
    ap.add_argument("--scene", nargs="+", choices=SCENES,
                    default=["flagship", "disk"])
    args = ap.parse_args(argv)
    cs = chip_smoke()
    from ngp_pl_torch import _build
    from ngp_pl_torch.benchmarking.disk_scene import write_blender_scene

    card = cs.card_line()
    cs.log({"phase": "build", "seconds_by_kernel": _build.build(),
            "card": card})

    def gate(system, scene):
        # the disk scene on seeds 7-10 (chip_smoke holds seed 7); the
        # witness is read on every scene
        kw = dict(seeds=cs.TRAINED_BATCHES) if scene == "disk" else {}
        return cs.trained_gate(torch, system, scene, check=False,
                               witness_reading=True, **kw)

    def stand_in(name, wrong, system, scene):
        with wrong():
            rec = gate(system, scene)
        for b in rec["batches"]:
            cs.log({"stand_in": name, **batch_line(cs, b, scene)})
        return dict(refused=not rec["passed"],
                    witness_gates=[b["witness_gate_pass"]
                                   for b in rec["batches"]])

    fits, stand_ins = [], {}
    for scene in args.scene:
        n = args.disk_fits if scene == "disk" else args.fits
        if scene == "disk" and n:
            write_blender_scene(DISK_ROOT, cs.DISK_TRAIN_VIEWS,
                                cs.DISK_TEST_VIEWS, cs.DISK_SIDE,
                                device="cuda")
        for fit in range(n):
            system = fit_scene(torch, cs, scene)
            rec = gate(system, scene)
            lines = [batch_line(cs, b, scene) for b in rec["batches"]]
            for ln in lines:
                cs.log({"scene": scene, "fit": fit, **ln})
            fits.append(dict(
                scene=scene, fit=fit, passed=rec["passed"],
                before=[ln["gate_pass_before"] for ln in lines],
                witness_gates=[ln["witness_gate_pass"] for ln in lines]))
            if fit == n - 1:
                wrong = {f"K7 rgb +{WRONG_REL} of max, {scene}":
                         lambda: wrong_k7(torch, False),
                         f"K7 rgb +-{WRONG_REL} of max, {scene}":
                         lambda: wrong_k7(torch, True)}
                if scene != "disk":
                    enc = cs.path_kernels(system.ngp)[0]
                    wrong[f"{enc} h1 +-{WRONG_REL} of max, {scene}"] = (
                        lambda: wrong_k1(torch, key=enc))
                for name, ctx in wrong.items():
                    stand_ins[name] = stand_in(name, ctx, system, scene)
            del system
            torch.cuda.empty_cache()
    summary = dict(card=card, fits=fits, stand_ins=stand_ins,
                   all_passed=all(f["passed"] for f in fits),
                   all_refused=all(v["refused"] for v in stand_ins.values()))
    cs.log(summary)
    return 0 if summary["all_refused"] and summary["all_passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
