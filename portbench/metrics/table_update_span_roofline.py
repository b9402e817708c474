"""table_update_span_roofline (%): `table_update_roofline`'s work (its
bytes and FLOPs, counted from these batches' distinct touched rows) a
step over the device's busy time a step in the train step's table-update
phase: from each replay's `rf_span_table_update` marker to its
`rf_span_end` marker, over the wholly marked steps (`spans.phases`), so
the sort, the duplicate sum and the zero fill before kernels 2-4 count
with them. None where the program recorded no spans or marked no whole
step, or where this rank updates rows for the other ranks' ids too
(`table_update_roofline`)."""
from portbench.harness import spans
from portbench.harness.roofline import distinct, share
from portbench.reference.layout import ITEMSIZE


def read(ctx):
    if ctx.lookups_for_other_ranks():
        return None
    busy = spans.phases(ctx)
    if not busy or not busy.get("table_update") or not ctx.batches:
        return None
    item = ITEMSIZE[ctx.layout.table_dtype]
    nbytes = flops = 0.0
    for batch in ctx.batches:
        for d, (gids, valid) in ctx.layout.group_ids(batch).items():
            touched = gids[valid]
            rows = distinct(touched)
            stored = distinct(touched // ctx.layout.groups[d].pack)
            nbytes += rows * d * (2 * item + 4) + stored * 2 * 4
            flops += 4.0 * rows * d
    n = len(ctx.batches)
    return share(flops / n, nbytes / n, busy["table_update"] * 1e-6, ctx.peaks)
