"""idle_share.train (%): the share of a train step's wall time in which no
operation ran on the card: 1 - the device's busy time per step in the
traced stretch (the union of its intervals) over the wall time of a step
outside that stretch (`unit_s`, host clock, the same window untraced). On
a mesh the exchange between ranks (NCCL's kernels, which spin while they
wait for the other ranks) is not the card's work: time in which it alone
ran counts as idle (`nccl_exposed_ms.train` reads that part)."""


def read(ctx):
    if not ctx.batches or not ctx.unit_s or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.busy_per_unit_s() / ctx.unit_s)
