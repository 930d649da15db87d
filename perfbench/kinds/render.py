"""A closed loop of frames for one viewer who waits for each (`kind:
"render"`).  Set-up fits the field from the traffic's fixed `fit_seed`, since
the fitted field sets every frame's work, then renders every pose of the
orbit once; the window renders the orbit's poses in order, cycled, from a
starting pose drawn from the seed, each frame timed from its request until
its image is on the host (or, with `--trace 1`, a short traced window).
The seed also draws the frames the reference checks.  `seed_readings` is what
`perfbench/control.py` reads to set the limits."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import harness, loops, program, scene, trace, yardstick


def faults(world: int):
    """The faults `perfbench/control.py` plants in this kind's fit."""
    return ("state_unchanged",)


def fit(run, views, test, fault=None):
    """The system built from the traffic's `fit_seed` and fitted for its
    `fit_steps`, with `fault` planted in the fit."""
    sysm, _ = run.system(views, test, seed=int(run.cell.traffic["fit_seed"]))
    sysm.on_train_start()
    m = None
    with (fault(sysm) if fault else contextlib.nullcontext()):
        for _ in range(run.cell.traffic["fit_steps"]
                       // sysm.tcfg.grid_update_interval):
            m = sysm.step_block()
    program.fence(m)
    return sysm


def measure(run) -> str:
    """The render cell: a fitted field, then frames of the orbit for one
    viewer who waits for each."""
    cell, tr_cfg = run.cell, run.cell.traffic
    views, test = run.views()
    run.stamp("scene")
    sysm = fit(run, views, test)
    run.stamp("fit")
    rend = program.renderer(sysm, test.directions, tr_cfg["t_threshold"])
    if "render" in run.faults:
        rend = run.faults["render"](rend)
    dirs = torch.from_numpy(test.directions).to(run.dev)
    orbit = [torch.from_numpy(p).to(run.dev) for p in test.poses]
    occ = sysm.grid_state.occ_grid
    start = int(np.random.default_rng(run.seed).integers(len(orbit)))

    def pose(i):
        return (start + i) % len(orbit)

    def frame(i):
        out = rend.render_pose(occ, dirs, orbit[pose(i)])
        return out, out["rgb"].cpu()

    for i in range(len(orbit)):                  # every pose's shapes
        frame(i)
    run.stamp("orbit_warm")
    setup_s = run.since_start()
    images: List = []
    breakdown = busy_s = window_s = None
    if run.traced:
        outs: List = []

        def body():
            for i in range(tr_cfg["trace_frames"]):
                outs.append(frame(i)[0])
        tr = loops.traced(run, body)
        if tr["seen"] != tr["counted"]:
            loops.log(f"profile holds {tr['seen']} hand-kernel launches, the"
                      f" wrappers counted {tr['counted']}: profiling "
                      f"{tr_cfg['trace_frames'] // 2} frames")
            outs.clear()
            tr_cfg = dict(tr_cfg, trace_frames=tr_cfg["trace_frames"] // 2)
            tr = loops.traced(run, body)
        n = len(outs)
        tr["rounds"] = sum(o["rounds"] for o in outs)
        tr["pixels"] = n * dirs.shape[0]
        samples = float(sum(o["total_samples"] for o in outs))
        ctx = loops.trace_ctx(run, tr, n, samples, train=False)
        line_metrics = harness.read_per_layer(cell, ctx)
        breakdown = trace.breakdown(tr)
        busy_s, window_s = ctx["busy_s"], ctx["window_s"]
        images = [(pose(i), o["rgb"].cpu()) for i, o in enumerate(outs)]
        attempted = n
    else:
        times = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < run.seconds:
            t = time.perf_counter()
            _, img = frame(i)
            times.append(time.perf_counter() - t)
            images.append((pose(i), img))
            i += 1
        window = time.perf_counter() - t0
        attempted = len(times)
        line_metrics = {
            "render_fps": {"value": yardstick.rate(attempted, window),
                           "unit": "frames/s"},
            "frame_ms_p95": {"value": yardstick.percentile(times, 95) * 1e3,
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        line_metrics = {k: v for k, v in line_metrics.items()
                        if k in {m["name"] for m in cell.end_to_end()}}
    peak = run.peak()
    loops.log(f"setup {run.setup} setup_s {setup_s:.3f} frames {attempted}")
    params = program.params(sysm)
    occ = occ.clone()
    del sysm, rend
    run.release()
    got = readings(images, params, occ, test, cell.config, tr_cfg, run.seed,
                   run.dev)
    checks = harness.compare(got, cell.limits)
    ok = harness.passed(checks) and not harness.banned_loaded()
    harness.print_checks(checks)
    return harness.result_line(ok, attempted, 0, line_metrics,
                               run.device(peak, busy_s, window_s), checks,
                               breakdown)


def sample(n: int, k: int, seed: int) -> List[int]:
    """k of n frames, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def readings(images: List, params: Dict, occ, test, config: Dict,
             tr_cfg: Dict, seed: int, dev, quant=None) -> Dict[str, float]:
    """The numbers the render cell compares, over a sample of the frames
    (pose, image) drawn from the seed: the largest mean absolute
    difference of a frame's colours from the reference's render of its
    pose from the program's fitted weights and grid (`frame_mean_abs`);
    and, for the fit and the grid that render skips, the largest mean
    squared difference of a frame from the scene's own ground truth of
    its pose (`frame_gt_mse`)."""
    from perfbench.reference import render as rr

    dirs = torch.from_numpy(test.directions).to(dev)
    mean_abs = gt_mse = 0.0
    for j in sample(len(images), tr_cfg["reference_frames"], seed):
        pose_i, img = images[j]
        pose = torch.from_numpy(test.poses[pose_i]).to(dev)
        ref = rr.frame(params, occ, dirs, pose, config["model"],
                       tr_cfg["t_threshold"], quant)
        img = img.to(dev)
        mean_abs = max(mean_abs, float((img - ref).abs().mean()))
        gt = scene.views(test.poses[pose_i:pose_i + 1], test.img_wh[0],
                         dev)[0]
        gt_mse = max(gt_mse, float(((img - gt) ** 2).mean()))
    return {"frame_mean_abs": mean_abs, "frame_gt_mse": gt_mse}


def seed_readings(run, views, test, quant, planted: Dict) -> Dict:
    """One seed: the fit (from the traffic's `fit_seed`), then frames of
    orbit poses drawn from the seed, the program's and the control's (the
    reference with `quant` from the program's fitted weights and grid)
    against the reference and the ground truth; and with each fault in
    `planted` (name -> context) planted in the fit, the program's frames
    again."""
    from perfbench.reference import render as rr

    tr = run.cell.traffic
    dirs = torch.from_numpy(test.directions).to(run.dev)
    pick = np.random.default_rng(run.seed).choice(
        len(test.poses), size=tr["reference_frames"], replace=False)

    def frames(fault=None):
        sysm = fit(run, views, test, fault)
        rend = program.renderer(sysm, test.directions, tr["t_threshold"])
        occ = sysm.grid_state.occ_grid
        images = [(int(i), rend.render_pose(
            occ, dirs, torch.from_numpy(test.poses[i]).to(run.dev))["rgb"]
            .cpu()) for i in pick]
        params, occ = program.params(sysm), occ.clone()
        del sysm, rend
        run.release()
        return images, params, occ

    model = run.cell.config["model"]
    images, params, occ = frames()
    out = {"program": readings(images, params, occ, test, run.cell.config,
                               tr, run.seed, run.dev)}
    qimages = [(i, rr.frame(params, occ, dirs,
                            torch.from_numpy(test.poses[i]).to(run.dev),
                            model, tr["t_threshold"], quant).cpu())
               for i, _ in images]
    out["control"] = readings(qimages, params, occ, test, run.cell.config,
                              tr, run.seed, run.dev)
    for name, fault in planted.items():
        out[name] = readings(*frames(fault), test, run.cell.config, tr,
                             run.seed, run.dev)
    return out
