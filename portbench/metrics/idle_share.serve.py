"""idle_share.serve (%): the share of a request's wall time (send to
answer on the host) in which no operation ran on the card: 1 - the
device's busy time per request in the traced stretch (the union of its
intervals) over the mean latency of the requests outside it (`unit_s`,
host clock, the same window untraced)."""


def read(ctx):
    if not ctx.batches or not ctx.unit_s or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.busy_per_unit_s() / ctx.unit_s)
