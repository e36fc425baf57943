"""``rows_ms.ztrain``: ``phases.phase_ms`` of ``rows``; read in the ztrain cells."""

from perfbench import phases


def read(ctx: dict):
    return phases.phase_ms(ctx, "ztrain", "rows")
