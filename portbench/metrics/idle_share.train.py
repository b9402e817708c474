"""idle_share.train (%): the share of a train step's wall time in which no
operation ran on the card: 1 - the device's busy time per step in the
traced stretch (the union of its intervals) over the wall time of a step
outside that stretch (`unit_s`, host clock, the same window untraced)."""


def read(ctx):
    if not ctx.batches or not ctx.unit_s or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.busy_per_unit_s() / ctx.unit_s)
