"""lookup_exchange_gb.train (GB): the bytes that the row-sharded lookup
hands NCCL a train step: the `exchange_bytes` of the program's
`shard.lookup` spans (the forward: the ids' all-gather and the looked-up
rows' all-reduce, `parallel/sharded_embedding.py:gather_local_rows`) and
`shard.lookup_grad` spans (the backward: the rows' gradients'
all-reduce), recorded in the traced stretch (spans record only under the
profiler), over its steps. None where the program recorded no such span
(no row-sharded table, a program without them), or the lookups are not a
whole number a traced step, each with its backward."""
from portbench.harness import spans


def read(ctx):
    recorded = spans.program_spans()
    if not recorded or not ctx.batches:
        return None
    fwd = [s for s in recorded if s.name == "shard.lookup"]
    bwd = [s for s in recorded if s.name == "shard.lookup_grad"]
    if not fwd or len(fwd) % len(ctx.batches) or len(bwd) != len(fwd):
        return None
    total = sum(s.counts.get("exchange_bytes", 0) for s in fwd + bwd)
    return total / len(ctx.batches) / 1e9
