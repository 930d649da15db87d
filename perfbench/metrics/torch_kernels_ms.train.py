"""`readers.torch_kernels_ms` over the traced training steps."""
from perfbench.readers import torch_kernels_ms as read  # noqa: F401

LAYER = "PyTorch glue"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
