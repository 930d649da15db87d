"""Samples the march put in the pool a ray (the step metrics' rm_samples over
the batch), over the traced steps."""
LAYER = "march, grid, renderer"
UNIT = "samples/ray"
SOURCE = "program_counter"
MOVES = "train_rays_per_s"


def read(ctx):
    return ctx["samples"] / ctx["rays"] if ctx["samples"] else None
