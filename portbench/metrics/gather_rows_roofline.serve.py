"""gather_rows_roofline.serve (%): kernel 1 (`gather_rows_kernel`) in a
request's evaluation forward. Bytes these requests need
(`roofline.gather_bytes`): per table, each distinct logical row read once,
every not-pad id's row written once, and the ids read. No FLOPs."""
from portbench.harness.roofline import gather_bytes, share
from portbench.reference.layout import ITEMSIZE

KERNELS = ("gather_rows_kernel",)


def read(ctx):
    seconds = ctx.trace.kernel_us(KERNELS, *ctx.span) * 1e-6
    item = ITEMSIZE[ctx.layout.table_dtype]
    nbytes = sum(gather_bytes(ctx.layout, b, item) for b in ctx.batches)
    return share(0.0, nbytes, seconds, ctx.peaks)
