"""idle_unattributed_share.serve (%): as `idle_unattributed_share.train`,
with a request's top-level spans (`predict`, `search`, `serve.predict`):
the share of the traced stretch's device idle time that no program span
below them names and no CUDA runtime or driver call covers (the caller's
own loop between requests among it). None where the program recorded no
spans, they count other than the traced requests, or the device never
idled."""
from portbench.harness import spans

TOPS = ("predict", "search", "serve.predict")
UNIT = ("search", "serve.predict")


def read(ctx):
    v = spans.view(ctx, TOPS, UNIT)
    if v is None or not ctx.trace.device or v.idle_us() <= 0:
        return None
    return 100.0 * v.idle_unattributed(TOPS) / v.idle_us()
