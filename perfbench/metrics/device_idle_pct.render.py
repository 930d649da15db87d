"""`readers.device_idle_pct` over the traced frames."""
from perfbench.readers import device_idle_pct as read  # noqa: F401

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_fps"
