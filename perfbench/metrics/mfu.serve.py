"""``mfu.serve``: see ``readers.mfu``; read in the serve cells."""

from perfbench import readers


def read(ctx: dict):
    return readers.mfu(ctx, "serve")
