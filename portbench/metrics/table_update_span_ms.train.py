"""table_update_span_ms.train (ms): the device's busy time in the train
step's table-update phase (from each step's `rf_span_table_update` marker
to its `rf_span_end` marker: the split tables' grouped duplicate sum and
kernels 2-4, or a row-sharded block's whole-block Adagrad), a step: the
mean over the traced steps whose six markers the trace holds
(`spans.phases`). It counts no bytes, so it reads on a mesh too. None
where the program recorded no spans or marked no whole step."""
from portbench.harness import spans


def read(ctx):
    busy = spans.phases(ctx)
    if not busy or not busy.get("table_update"):
        return None
    return busy["table_update"] * 1e-3
