"""``host_cpu_ms.ztrain``: ``phases.host_cpu_ms``; read in the ztrain cells."""

from perfbench import phases


def read(ctx: dict):
    return phases.host_cpu_ms(ctx, "ztrain")
