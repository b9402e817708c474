"""train_mfu (%): the whole train step's share of the card's float32 peak.
FLOPs of a step: 3x the reference model's forward (the dense layers, the
cross network, the in-batch score matrix: `forward_flops`), as the forward,
the input gradient and the weight gradient each cost one forward; over the
wall time of a step outside the traced stretch (`unit_s`, host clock) and
67 TFLOP/s (float32 outside the tensor cores: the configurations compute
in float32 with TF32 off)."""


def read(ctx):
    if not ctx.batches or not ctx.unit_s:
        return None
    rows = len(next(iter(ctx.batches[0].values())))
    flops = 3.0 * ctx.reference.forward_flops(ctx.layout, ctx.args, rows, True)
    return 100.0 * flops / ctx.unit_s / ctx.peaks["f32_flops"]
