"""Safe-promotion gate (the counterpart of `recommendflow_tpu/train/
monitor.py`): block a model's promotion when its metrics regress.

Parity with model_online_monitor (backend/utils/model_utils.py:27-52) +
str2scale interval constraints (utils/str_parser.py:47-63): each metric's
relative change (new - old) / max(|old|, 1e-12) must lie in its declared
interval, else PromotionBlocked is raised, after the `alert` hook (e.g.
utils/alerts.send_alert) has been called with the message.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from recommendflow_tpu_torch.utils.logger import get_logger
from recommendflow_tpu_torch.utils.str_parser import str2scale

log = get_logger("recflow.monitor")


class PromotionBlocked(RuntimeError):
    pass


def model_online_monitor(old_metrics: Dict[str, float],
                         new_metrics: Dict[str, float],
                         constraints: Dict[str, str],
                         alert: Optional[Callable[[str], None]] = None
                         ) -> Dict[str, float]:
    """Check each metric's relative change against its constraint interval.

    constraints e.g. {'hit@50': '[-0.1, inf]', 'auc': '[-0.01, inf)'}: a
    relative change of hit@50 below -0.1 blocks promotion, and so does a
    metric missing from either side. Returns the relative-change dict on
    success."""
    changes: Dict[str, float] = {}
    violations = []
    for metric, interval in constraints.items():
        if metric not in new_metrics or metric not in old_metrics:
            violations.append(f"metric '{metric}' missing from metrics")
            continue
        old, new = float(old_metrics[metric]), float(new_metrics[metric])
        # a floor, not an inf sentinel, for a zero baseline: the change
        # keeps its sign against every interval form
        rel = (new - old) / max(abs(old), 1e-12)
        changes[metric] = rel
        if not str2scale(interval)(rel):
            violations.append(
                f"{metric}: relative change {rel:+.4f} violates {interval} "
                f"(old={old:.6g}, new={new:.6g})")
    if violations:
        msg = "model promotion blocked: " + "; ".join(violations)
        log.error(msg)
        if alert is not None:
            alert(msg)
        raise PromotionBlocked(msg)
    log.info("promotion check passed: %s",
             {k: f"{v:+.4f}" for k, v in changes.items()})
    return changes
