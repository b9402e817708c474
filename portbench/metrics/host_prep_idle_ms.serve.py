"""host_prep_idle_ms.serve (ms): the device's idle time while the host
prepares a request, per request: the share of the traced stretch's idle
time during which the innermost span on the launching thread is one of the
prep spans (`serve.check`, the id check; `serve.cast`; `predict.prefetch`,
predict's thread and its first get; `search.normalise`; `search.items`),
of the device's idle time in an untraced request (`unit_s` less the busy
time a request). The traced stretch runs slower on the host, so its own
idle time is not read as it is. None where the program recorded no spans
or they count other than the traced requests (one `search` or
`serve.predict` each)."""
from portbench.harness import spans

TOPS = ("predict", "search", "serve.predict")
UNIT = ("search", "serve.predict")
PREP = ("serve.check", "serve.cast", "predict.prefetch", "search.normalise",
        "search.items")


def read(ctx):
    if not ctx.batches or not ctx.trace.device:
        return None
    v = spans.view(ctx, TOPS, UNIT)
    return None if v is None else spans.untraced_idle_ms(ctx, v, PREP)
