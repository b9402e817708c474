"""nccl_exposed_ms.train (ms): the time of a train step in which the card
ran the exchange between ranks (NCCL's kernels) and no work of its own.
NCCL's kernels spin while they wait for the other ranks, and the profiler
slows every rank's host, so the traced stretch's exchange time is not a
step's: the share of the traced stretch's time without work that the
exchange alone filled is applied to an untraced step's time without work
(`unit_s` less the work's busy time a step). None where the trace holds no
NCCL kernel (one card)."""


def read(ctx):
    if not ctx.batches or not ctx.unit_s or not ctx.trace.exchange:
        return None
    t0, t1 = ctx.span
    without_work = (t1 - t0) - ctx.trace.busy_us(t0, t1)
    if without_work <= 0:
        return None
    untraced = max(ctx.unit_s - ctx.busy_per_unit_s(), 0.0)
    return 1e3 * untraced * ctx.trace.exchange_only_us(t0, t1) / without_work
