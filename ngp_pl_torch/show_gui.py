"""Interactive orbit-camera viewer (counterpart of show_gui.py; reference
show_gui.py).

Renders a slim checkpoint (`--ckpt_path`) through the round renderer at
the viewer's thresholds: 128 samples per ray at most and early termination
at transmittance 1e-2 (reference show_gui.py:82-88), in chunks of the
next power of two of the frame's pixels up to 131,072, with the JAX
viewer's window rule.  The window needs the `dearpygui` package and a
display; `run_gui` raises without them.  `--screenshot FILE` renders one
frame of the starting camera to a PNG instead.  Each frame's time `dt` is
read after the frame is on the host (a fence), so it is the frame's whole
time on the card, not its launches.

    python -m ngp_pl_torch.show_gui --ckpt_path \\
        ckpts/synthetic/exp/epoch=30_slim.npz --downsample 6.25
    python -m ngp_pl_torch.show_gui --ckpt_path \\
        ckpts/synthetic/exp/epoch=30_slim.npz --downsample 6.25 \\
        --screenshot frame.png
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ngp_pl_torch.config import (
    RenderConfig,
    TrainConfig,
    add_train_args,
    config_from_args,
)
from ngp_pl_torch.datasets import dataset_dict
from ngp_pl_torch.datasets.ray_utils import get_ray_directions
from ngp_pl_torch.device import resolve_device
from ngp_pl_torch.models.ngp import NGP
from ngp_pl_torch.models.rendering import RoundRenderer
from ngp_pl_torch.ops.ray_march import (
    segment_march_dmax_ok,
    window_march_mc_ok,
)
from ngp_pl_torch.training.checkpoint import load_slim_checkpoint
from ngp_pl_torch.utils.images import write_png


class OrbitCamera:
    """Orbit/zoom/pan camera (reference show_gui.py:19-51), float32 numpy
    host state."""

    def __init__(self, K, img_wh, r):
        self.K = K
        self.W, self.H = img_wh
        self.radius = r
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3, dtype=np.float32)

    @property
    def pose(self):
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res[:3]

    def _rotvec_to_R(self, axis, angle):
        axis = axis / (np.linalg.norm(axis) + 1e-12)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]], np.float32)
        return (np.eye(3, dtype=np.float32) + np.sin(angle) * K
                + (1 - np.cos(angle)) * K @ K)

    def orbit(self, dx, dy):
        self.rot = (self._rotvec_to_R(self.rot[:, 1], -0.005 * dx)
                    @ self._rotvec_to_R(self.rot[:, 0], -0.005 * dy)
                    @ self.rot)

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0.0):
        self.center += 1e-4 * self.rot @ np.array([dx, dy, dz], np.float32)


class NGPGUI:
    def __init__(self, tcfg: TrainConfig, K, img_wh, radius=2.5,
                 device="cuda"):
        self.dev = resolve_device(device)
        cfg = tcfg.ngp_config()
        if not tcfg.ckpt_path:
            raise ValueError("--ckpt_path (a slim checkpoint) is required "
                             "for the viewer")
        self.ngp = NGP(cfg, seed=tcfg.seed, device=self.dev)
        params, occ = load_slim_checkpoint(tcfg.ckpt_path)
        self.ngp.load_params(params)
        self.occ_grid = torch.from_numpy(occ).to(self.dev)
        # interactive thresholds (reference show_gui.py:82-88)
        rcfg = RenderConfig(max_samples=128, test_t_threshold=1e-2)
        dirs = get_ray_directions(img_wh[1], img_wh[0], K)
        window_ok = (
            cfg.cascades == 1 and cfg.exp_step_factor == 0.0
            and segment_march_dmax_ok(
                dirs, grid_size=cfg.grid_size,
                max_samples=rcfg.max_samples, scale=cfg.scale)
        ) or window_march_mc_ok(dirs, cfg.exp_step_factor, cfg.cascades)
        chunk = min(131072, 1 << (img_wh[0] * img_wh[1] - 1).bit_length())
        self.renderer = RoundRenderer(self.ngp, rcfg, chunk=chunk,
                                      use_window=window_ok)
        self.cam = OrbitCamera(K, img_wh, r=radius)
        self.W, self.H = img_wh
        self._dirs_key = None

    def render_cam(self, cam: OrbitCamera) -> np.ndarray:
        """One frame of `cam` as (H, W, 3) float32 on the host; sets `dt`
        (seconds, fenced), `mean_samples` (per ray) and `rounds`."""
        t = time.perf_counter()
        key = (cam.H, cam.W, cam.K.tobytes())
        if self._dirs_key != key:
            # intrinsics change only on resize: the directions stay on the
            # card between frames
            self._dirs_key = key
            self._dirs = torch.from_numpy(
                get_ray_directions(cam.H, cam.W, cam.K)).to(self.dev)
        out = self.renderer.render_pose(
            self.occ_grid, self._dirs,
            torch.from_numpy(cam.pose).to(self.dev))
        rgb = out["rgb"].reshape(cam.H, cam.W, 3).cpu().numpy()
        self.dt = time.perf_counter() - t
        self.mean_samples = out["total_samples"] / (cam.H * cam.W)
        self.rounds = out["rounds"]
        return rgb

    def run_gui(self):
        import dearpygui.dearpygui as dpg

        dpg.create_context()
        rgb = np.ones((self.H, self.W, 3), np.float32)

        with dpg.texture_registry(show=False):
            dpg.add_raw_texture(
                self.W, self.H, rgb, format=dpg.mvFormat_Float_rgb,
                tag="_texture")
        with dpg.window(tag="_render_window", width=self.W, height=self.H):
            dpg.add_image("_texture")
        with dpg.window(label="Control", width=200, height=80):
            dpg.add_text("", tag="_log_time")

        def cb_drag(sender, app_data):
            self.cam.orbit(app_data[1], app_data[2])

        def cb_wheel(sender, app_data):
            self.cam.scale(app_data)

        def cb_pan(sender, app_data):
            self.cam.pan(app_data[1], app_data[2])

        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                       callback=cb_drag)
            dpg.add_mouse_wheel_handler(callback=cb_wheel)
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Middle,
                                       callback=cb_pan)

        dpg.create_viewport(title="ngp_pl_torch", width=self.W,
                            height=self.H, resizable=False)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        while dpg.is_dearpygui_running():
            dpg.set_value("_texture", self.render_cam(self.cam))
            dpg.set_value(
                "_log_time",
                f"Render time: {1000 * self.dt:.2f} ms  "
                f"samples/ray: {self.mean_samples:.1f}")
            dpg.render_dearpygui_frame()
        dpg.destroy_context()


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_train_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--screenshot", type=str, default=None,
                        help="render one frame to PNG instead of opening "
                        "a window")
    args = parser.parse_args(argv)
    tcfg = config_from_args(args)
    dataset = dataset_dict[tcfg.dataset_name](
        root_dir=tcfg.root_dir, downsample=tcfg.downsample, read_meta=False,
        device=args.device)
    gui = NGPGUI(tcfg, dataset.K, dataset.img_wh, device=args.device)
    if args.screenshot:
        rgb = gui.render_cam(gui.cam)
        write_png(args.screenshot,
                  (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        print(f"wrote {args.screenshot} ({1000 * gui.dt:.1f} ms, "
              f"{gui.mean_samples:.1f} samples/ray)")
    else:
        gui.run_gui()
    return gui


if __name__ == "__main__":
    main()
