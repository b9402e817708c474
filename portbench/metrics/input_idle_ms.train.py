"""input_idle_ms.train (ms): the device's idle time while fit's thread
waits for its input, per step: the share of the traced stretch's idle time
(the gaps between the union of the device's intervals) during which the
innermost span on the thread that launches the steps is `fit.next` (the
wait on the prefetch queue for the next stack) or `fit.pin` (the stack's
pinned copy), of the device's idle time in an untraced step (`unit_s` less
the busy time a step). The traced stretch runs slower on the host, so its
own idle time is not read as it is. None where the program recorded no
spans or they count other than the traced steps."""
from portbench.harness import spans

TOPS = ("fit.stack", "fit.step")
INPUT = ("fit.next", "fit.pin")


def read(ctx):
    if not ctx.batches or not ctx.trace.device:
        return None
    v = spans.view(ctx, TOPS, ("fit.stack",), "steps")
    return None if v is None else spans.untraced_idle_ms(ctx, v, INPUT)
