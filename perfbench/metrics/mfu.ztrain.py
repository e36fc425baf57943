"""``mfu.ztrain``: see ``readers.mfu``; read in the ztrain cells."""

from perfbench import readers


def read(ctx: dict):
    return readers.mfu(ctx, "ztrain")
