"""`readers.device_idle_pct` over the traced training steps."""
from perfbench.readers import device_idle_pct as read  # noqa: F401

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
