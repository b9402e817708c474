"""table_update_roofline (%): the tables' row-wise Adagrad in the train
step (`split_table_update`: kernel 2 `scatter_add_rows_kernel` and kernel
4 `rowwise_adagrad_kernel` under the "dense" strategy, kernel 3
`sparse_adagrad_kernel` under "sparse_set"). Work these batches need,
whichever strategy the planner picks, per table and step: each distinct
logical row that a not-pad id touches has its parameters (dim x the
table's item size) read and written once and its float32 row gradient read
once; each distinct stored row so touched has its one float32 accumulator
read and written once; 4 FLOPs an element. A whole-table pass, or whole
stored rows where the layout packs several logical rows into one, is work
these inputs do not need. The sort and duplicate sum before the kernels
(one grouped call a step over every split table: the `combine_*` kernels
and CUB's radix sort) are not in `KERNELS`: their time is not in the
denominator (`table_update_span_roofline` counts them). None where this
rank updates rows for the other ranks' ids too (row-sharded tables on
several ranks: it updates its block's rows that the global batch touches,
which the rows it is fed do not count)."""
from portbench.harness.roofline import distinct, share
from portbench.reference.layout import ITEMSIZE

KERNELS = ("scatter_add_rows_kernel", "rowwise_adagrad_kernel",
           "sparse_adagrad_kernel")


def read(ctx):
    if ctx.lookups_for_other_ranks():
        return None
    seconds = ctx.trace.kernel_us(KERNELS, *ctx.span) * 1e-6
    item = ITEMSIZE[ctx.layout.table_dtype]
    nbytes = flops = 0.0
    for batch in ctx.batches:
        for d, (gids, valid) in ctx.layout.group_ids(batch).items():
            touched = gids[valid]
            rows = distinct(touched)
            stored = distinct(touched // ctx.layout.groups[d].pack)
            nbytes += rows * d * (2 * item + 4) + stored * 2 * 4
            flops += 4.0 * rows * d
    return share(flops, nbytes, seconds, ctx.peaks)
