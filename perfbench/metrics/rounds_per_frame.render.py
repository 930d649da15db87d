"""March-and-composite rounds a frame (the renderer's rounds over all chunks),
over the traced frames."""
LAYER = "march, grid, renderer"
UNIT = "rounds/frame"
SOURCE = "program_counter"
MOVES = "render_fps"


def read(ctx):
    return ctx["rounds"] / ctx["units"] if ctx["rounds"] else None
