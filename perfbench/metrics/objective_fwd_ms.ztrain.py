"""``objective_fwd_ms.ztrain``: ``phases.phase_ms`` of ``objective.forward``;
read in the ztrain cells."""

from perfbench import phases


def read(ctx: dict):
    return phases.phase_ms(ctx, "ztrain", "objective.forward")
