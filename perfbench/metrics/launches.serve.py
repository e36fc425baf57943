"""``launches.serve``: ``phases.launches``; read in the serve cells."""

from perfbench import phases


def read(ctx: dict):
    return phases.launches(ctx, "serve")
