"""``launches.ztrain``: ``phases.launches``; read in the ztrain cells."""

from perfbench import phases


def read(ctx: dict):
    return phases.launches(ctx, "ztrain")
