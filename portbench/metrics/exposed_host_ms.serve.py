"""exposed_host_ms.serve (ms): a request's wall time (send to answer on
the host; the mean latency of the requests outside the traced stretch,
`unit_s`) minus the card's busy time per request in the traced stretch:
the host's part that the card does not hide (the searcher's host
normalisation and copies, ServingModel's id check and pinned copy,
predict's feed)."""


def read(ctx):
    if not ctx.batches or not ctx.unit_s or not ctx.trace.device:
        return None
    return 1e3 * (ctx.unit_s - ctx.busy_per_unit_s())
