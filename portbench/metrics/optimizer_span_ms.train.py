"""optimizer_span_ms.train (ms): the device's busy time in the train
step's dense-optimizer phase (Adam: from each replay's `rf_span_optimizer`
marker to its `rf_span_table_update` marker), a step: the mean over the
traced steps whose six markers the trace holds (`spans.phases`). None
where the program recorded no spans or marked no whole step."""
from portbench.harness import spans


def read(ctx):
    busy = spans.phases(ctx)
    if not busy or not busy.get("optimizer"):
        return None
    return busy["optimizer"] * 1e-3
