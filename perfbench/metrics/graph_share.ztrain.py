"""``graph_share.ztrain``: the share of the run's Z steps whose
value-and-grad replayed a CUDA graph, in %: ``100 · graph_replays / calls``
of the program's ``training.inducing.optimize_step`` over the whole process
(set-up's eager warm-up step counts as a call). ``None`` outside the ztrain
cells, and where the program keeps no such counters."""


def read(ctx: dict):
    if ctx["kind"] != "ztrain":
        return None
    from laplace_inducing_points_tpu_torch.training.inducing import optimize_step
    calls = getattr(optimize_step, "calls", 0)
    replays = getattr(optimize_step, "graph_replays", None)
    if replays is None or not calls:
        return None
    return 100.0 * replays / calls
