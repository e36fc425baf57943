"""``contract_ms.serve``: ``phases.phase_ms`` of ``contract``; read in the serve cells."""

from perfbench import phases


def read(ctx: dict):
    return phases.phase_ms(ctx, "serve", "contract")
