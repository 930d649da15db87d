"""Kernel launches the host makes a training step: the runtime's launch calls
in the profile over the window's steps."""
LAYER = "host dispatch"
UNIT = "launches/step"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(ctx):
    return ctx["launches"] / ctx["units"] if ctx["launches"] else None
