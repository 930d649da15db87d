"""`readers.step_mfu` over the traced training steps."""
from perfbench.readers import step_mfu as read  # noqa: F401

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
