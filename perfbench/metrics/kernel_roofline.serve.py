"""``kernel_roofline.serve``: see ``readers.kernel_roofline``; read in the serve cells."""

from perfbench import readers


def read(ctx: dict):
    return readers.kernel_roofline(ctx, "serve")
