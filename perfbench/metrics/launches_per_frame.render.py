"""Kernel launches the host makes a frame: the runtime's launch calls in the
profile over the window's frames."""
LAYER = "host dispatch"
UNIT = "launches/frame"
SOURCE = "device_trace"
MOVES = "render_fps"


def read(ctx):
    return ctx["launches"] / ctx["units"] if ctx["launches"] else None
