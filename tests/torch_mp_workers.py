"""Module-level functions the port's ``RayContext`` workers run in the
tests (a spawned worker unpickles them by name, so they live outside the
test files, whose imports load jax)."""


def context_facts(rank, x):
    """The worker's rank, its context's process count and platform, and
    ``x`` back."""
    from analytics_zoo_tpu_torch.common.context import current_context
    ctx = current_context()
    return rank, ctx.process_count, ctx.platform, x


def gathered_ranks(rank, base):
    """``rank + base`` summed over the workers (``process_allgather``),
    the process count and the backend."""
    from analytics_zoo_tpu_torch.common.context import current_context
    from analytics_zoo_tpu_torch.parallel import distributed
    total = distributed.process_allgather(float(rank + base)).sum()
    ctx = current_context()
    return float(total), ctx.process_count, ctx.backend
