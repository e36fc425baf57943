"""``device_idle.ztrain``: see ``readers.device_idle``; read in the ztrain cells."""

from perfbench import readers


def read(ctx: dict):
    return readers.device_idle(ctx, "ztrain")
