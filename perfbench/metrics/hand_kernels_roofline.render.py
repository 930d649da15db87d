"""`readers.hand_kernels_roofline` over the traced frames."""
from perfbench.readers import hand_kernels_roofline as read  # noqa: F401

LAYER = "hand kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_fps"
