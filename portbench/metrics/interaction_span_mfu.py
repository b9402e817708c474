"""interaction_span_mfu (%): the low-rank cross's share of the card's
float32 peak inside the train step. FLOPs: 3x the reference's
`interaction_flops` of this rank's rows a step (the forward, the input
gradient and the weight gradient each cost one forward); time: the
device's busy time from each step's `rf_region_cross_forward` marker to its
`rf_region_cross_forward_end`, and from its `rf_region_cross_backward` to
its `rf_region_cross_backward_end` (`ops/interactions.py:LowRankCrossNet`);
67 TFLOP/s on an H100 SXM. None where the reference has no
`interaction_flops`, or where the markers' four in order do not count the
traced steps (a program without them)."""
import re

MARKER = re.compile(r"rf_region_(cross_(?:forward|backward)(?:_end)?)")
ORDER = ("cross_forward", "cross_forward_end", "cross_backward",
         "cross_backward_end")


def read(ctx):
    flops_of = getattr(ctx.reference, "interaction_flops", None)
    if flops_of is None or not ctx.batches or ctx.span is None:
        return None
    t0, t1 = ctx.span
    marks = sorted((d.start, m.group(1)) for d in ctx.trace.device
                   if (m := MARKER.search(d.name)) and t0 <= d.start < t1)
    busy, steps, i = 0.0, 0, 0
    while i + len(ORDER) <= len(marks):
        step = marks[i:i + len(ORDER)]
        if tuple(name for _, name in step) != ORDER:
            i += 1
            continue
        (a, _), (b, _), (c, _), (e, _) = step
        busy += ctx.trace.busy_us(a, b) + ctx.trace.busy_us(c, e)
        steps += 1
        i += len(ORDER)
    if steps != len(ctx.batches) or busy <= 0:
        return None
    rows = len(next(iter(ctx.batches[0].values())))
    flops = 3.0 * flops_of(ctx.layout, ctx.args, rows) * steps
    return 100.0 * flops / (busy * 1e-6) / ctx.peaks["f32_flops"]
