"""score_max_roofline (%): kernel 5 in float32 (`grouped_score_max_kernel`,
the group maxima of a search's scores). Work of one request: 2·Q·N·D FLOPs
over the catalogue's N items; bytes: the items (N·D float32) and the
queries read once and the group maxima (Q·N/16 float32) written once."""
from portbench.harness.roofline import share

KERNELS = ("grouped_score_max_kernel",)
GROUP = 16


def read(ctx):
    cat = ctx.traffic.get("catalogue")
    if not cat or not ctx.batches:
        return None
    seconds = ctx.trace.kernel_us(KERNELS, *ctx.span) * 1e-6
    q, n, d = int(ctx.traffic["rows"]), int(cat["items"]), int(cat["dim"])
    per = len(ctx.batches)
    flops = 2.0 * q * n * d * per
    nbytes = (4.0 * n * d + 4.0 * q * d + 4.0 * q * n / GROUP) * per
    return share(flops, nbytes, seconds, ctx.peaks)
