"""idle_unattributed_share.train (%): the share of the traced stretch's
device idle time that no program span below `fit.stack` / `fit.step`
names and no CUDA runtime or driver call covers: idle while the innermost
span on the launching thread is a top-level one, or while none is under
way, and no runtime call is. None where the program recorded no spans,
they count other than the traced steps, or the device never idled."""
from portbench.harness import spans

TOPS = ("fit.stack", "fit.step")


def read(ctx):
    v = spans.view(ctx, TOPS, ("fit.stack",), "steps")
    if v is None or not ctx.trace.device or v.idle_us() <= 0:
        return None
    return 100.0 * v.idle_unattributed(TOPS) / v.idle_us()
