"""`readers.step_mfu` over the traced frames."""
from perfbench.readers import step_mfu as read  # noqa: F401

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_fps"
