"""``kernel_roofline.ztrain``: see ``readers.kernel_roofline``; read in the ztrain cells."""

from perfbench import readers


def read(ctx: dict):
    return readers.kernel_roofline(ctx, "ztrain")
