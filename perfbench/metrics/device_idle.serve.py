"""``device_idle.serve``: see ``readers.device_idle``; read in the serve cells."""

from perfbench import readers


def read(ctx: dict):
    return readers.device_idle(ctx, "serve")
