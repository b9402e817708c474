"""gather_span_roofline.train (%): `gather_rows_roofline.train`'s bytes
(`roofline.gather_bytes`) a step over the device's busy time a step in
the train step's gather phase: from each replay's `rf_span_gather` marker
to its `rf_span_forward` marker (the fused ids, the physical ids and
kernel 1), over the wholly marked steps (`spans.phases`), rather than
kernel 1's time alone. None where the program recorded no spans or marked
no whole step, or where a table is row-sharded: the embed pass looks such
a table up in the forward phase (`gather_local_rows`: the ids
all-gathered, kernel 1 on this rank's block, the rows all-reduced), so the
gather phase does not hold it."""
from portbench.harness import spans
from portbench.harness.roofline import gather_bytes, share
from portbench.reference.layout import ITEMSIZE


def read(ctx):
    if ctx.row_sharded:
        return None
    busy = spans.phases(ctx)
    if not busy or not busy.get("gather") or not ctx.batches:
        return None
    item = ITEMSIZE[ctx.layout.table_dtype]
    nbytes = sum(gather_bytes(ctx.layout, b, item) for b in ctx.batches)
    return share(0.0, nbytes / len(ctx.batches), busy["gather"] * 1e-6,
                 ctx.peaks)
