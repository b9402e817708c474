"""dense_span_mfu (%): the dense network's share of the card's float32
peak inside the train step. FLOPs: `train_mfu`'s, 3x the reference
model's forward (`forward_flops`) per step; time: the device's busy time in
the forward and backward phases (from each replay's `rf_span_forward`
marker to its `rf_span_optimizer` marker) a step, over the wholly marked
steps (`spans.phases`); 67 TFLOP/s on an H100 SXM. None where the
program recorded no spans or marked no whole step."""
from portbench.harness import spans


def read(ctx):
    busy = spans.phases(ctx)
    if not busy or not ctx.batches:
        return None
    seconds = (busy.get("forward", 0.0) + busy.get("backward", 0.0)) * 1e-6
    if seconds <= 0:
        return None
    rows = len(next(iter(ctx.batches[0].values())))
    flops = 3.0 * ctx.reference.forward_flops(ctx.layout, ctx.args, rows, True)
    return 100.0 * flops / seconds / ctx.peaks["f32_flops"]
