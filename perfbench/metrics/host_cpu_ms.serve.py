"""``host_cpu_ms.serve``: ``phases.host_cpu_ms``; read in the serve cells."""

from perfbench import phases


def read(ctx: dict):
    return phases.host_cpu_ms(ctx, "serve")
