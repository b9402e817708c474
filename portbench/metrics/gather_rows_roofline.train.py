"""gather_rows_roofline.train (%): kernel 1 (`gather_rows_kernel`) in the
train step. Bytes these batches need (`roofline.gather_bytes`): per table,
each distinct logical row read once, every not-pad id's row written once,
and the ids read; logical rows of dim x the table's item size, whatever the
split path packs into a stored row. No FLOPs. None where this rank looks
up rows for the other ranks' ids too (row-sharded tables on several ranks:
its kernel 1 then gathers the global batch's ids from its block, which the
rows it is fed do not count)."""
from portbench.harness.roofline import gather_bytes, share
from portbench.reference.layout import ITEMSIZE

KERNELS = ("gather_rows_kernel",)


def read(ctx):
    if ctx.lookups_for_other_ranks():
        return None
    seconds = ctx.trace.kernel_us(KERNELS, *ctx.span) * 1e-6
    item = ITEMSIZE[ctx.layout.table_dtype]
    nbytes = sum(gather_bytes(ctx.layout, b, item) for b in ctx.batches)
    return share(0.0, nbytes, seconds, ctx.peaks)
