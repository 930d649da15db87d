"""Samples the rounds marched and composited a pixel (the frames'
total_samples over their pixels), over the traced frames."""
LAYER = "march, grid, renderer"
UNIT = "samples/ray"
SOURCE = "program_counter"
MOVES = "render_fps"


def read(ctx):
    return ctx["samples"] / ctx["pixels"] if ctx["samples"] else None
