"""Operational alerting hooks (the counterpart of `recommendflow_tpu/utils/
alerts.py`; parity: the reference's oncall push with x3 retry,
utils/util.py:45-80). The transport is pluggable: a webhook URL (POSTed
JSON), a shell command (the JSON on its standard input), or a log-only
fallback. The payload is the JAX package's, byte for byte.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
import urllib.request
from typing import Callable, Optional

from recommendflow_tpu_torch.utils.logger import get_logger

log = get_logger("recflow.alerts")
RETRIES = 3


def send_alert(message: str,
               title: str = "recommendflow_tpu",
               webhook_url: Optional[str] = None,
               command: Optional[str] = None) -> bool:
    """Push an alert; webhook_url / command default to the environment's
    RECFLOW_ALERT_WEBHOOK / RECFLOW_ALERT_CMD. Always logs; a failed push
    is retried (RETRIES attempts, 1, 2, 4 s apart) and never raises.
    Returns whether a push went through."""
    webhook_url = webhook_url or os.environ.get("RECFLOW_ALERT_WEBHOOK")
    command = command or os.environ.get("RECFLOW_ALERT_CMD")
    log.error("[ALERT] %s: %s", title, message)
    payload = json.dumps({"title": title, "text": message}).encode("utf-8")
    for attempt in range(RETRIES):
        try:
            if webhook_url:
                req = urllib.request.Request(
                    webhook_url, data=payload,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10):
                    pass
                return True
            if command:
                subprocess.run(command, shell=True, input=payload,
                               timeout=30, check=True)
                return True
            return False  # log-only
        except Exception as e:  # noqa: BLE001 — alerting must not crash a job
            log.warning("alert push failed (attempt %d/%d): %s",
                        attempt + 1, RETRIES, e)
            time.sleep(2 ** attempt)
    return False


def alerting(fn: Callable, title: str = "recflow-job"):
    """Decorator: push an alert when the wrapped job raises, then re-raise."""
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            send_alert(f"{fn.__name__} failed: {type(e).__name__}: {e}", title)
            raise
    return wrapped
