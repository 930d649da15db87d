"""`readers.torch_kernels_ms` over the traced frames."""
from perfbench.readers import torch_kernels_ms as read  # noqa: F401

LAYER = "PyTorch glue"
UNIT = "ms/frame"
SOURCE = "device_trace"
MOVES = "render_fps"
