"""serve_mfu (%): the whole request's share of the card's float32 peak.
FLOPs of a request: the reference model's evaluation forward of its rows
(`forward_flops`) plus, where the traffic searches a catalogue, kernel 5's
2·Q·N·D; over the mean latency of the requests outside the traced
stretch (`unit_s`, host clock, send to answer) and 67 TFLOP/s."""


def read(ctx):
    if not ctx.batches or not ctx.unit_s:
        return None
    rows = int(ctx.traffic["rows"])
    flops = ctx.reference.forward_flops(ctx.layout, ctx.args, rows, False)
    cat = ctx.traffic.get("catalogue")
    if cat:
        flops += 2.0 * rows * int(cat["items"]) * int(cat["dim"])
    return 100.0 * flops / ctx.unit_s / ctx.peaks["f32_flops"]
