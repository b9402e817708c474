"""The promotion gate and the alert hooks against the JAX package, on the
CPU. `model_online_monitor` on the same inputs returns the same change dict
(exactly: the same float64 arithmetic) or raises PromotionBlocked with the
same message after calling the alert once with it: closed, open and inf
bounds, a zero baseline, a missing metric (the cases of the JAX
tests/test_trainer.py promotion tests). `send_alert`'s command transport
receives the JAX payload byte for byte; its webhook POSTs it to a localhost
http.server; a failing push is tried 3 times (1, 2, 4 s apart, time.sleep
patched) and returns False without raising; `alerting` pushes and
re-raises.
"""
import http.server
import json
import sys
import threading
import types

import pytest

import _torch_parity as tp  # noqa: F401  (torch on one thread)

OLD = {"hit@50": 0.5, "auc": 0.8}
CASES = {
    "pass": (OLD, {"hit@50": 0.49, "auc": 0.81},
             {"hit@50": "[-0.1, inf)", "auc": "[-0.05, inf)"}),
    "block": (OLD, {"hit@50": 0.3, "auc": 0.8},
              {"hit@50": "[-0.1, inf)", "auc": "[-0.05, inf)"}),
    "closed_bounds": (OLD, {"hit@50": 0.45, "auc": 0.8},
                      {"hit@50": "[-0.1, 0.1]", "auc": "[0, 0]"}),
    "open_lower_at_edge": (OLD, {"hit@50": 0.45, "auc": 0.8},
                           {"hit@50": "(-0.1, inf]"}),
    "upper_bound": (OLD, {"hit@50": 0.9, "auc": 0.8},
                    {"hit@50": "(-inf, 0.5)", "auc": "(-inf, inf)"}),
    "zero_baseline_up": ({"auc": 0.0}, {"auc": 0.5}, {"auc": "[-0.05, inf)"}),
    "zero_baseline_down": ({"auc": 0.0}, {"auc": -0.5},
                           {"auc": "[-0.05, inf)"}),
    "zero_to_zero": ({"auc": 0.0}, {"auc": 0.0}, {"auc": "[0, 0]"}),
    "missing_new": (OLD, {"auc": 0.8}, {"hit@50": "[-0.1, inf)",
                                        "auc": "[-0.05, inf)"}),
    "missing_old": ({"auc": 0.8}, {"auc": 0.8, "val_hit@10": 0.2},
                    {"val_hit@10": "[-1, inf)"}),
}


def _outcome(monitor, old, new, constraints):
    alerts = []
    try:
        return ("ok", monitor.model_online_monitor(old, new, constraints,
                                                   alert=alerts.append)), alerts
    except monitor.PromotionBlocked as e:
        return ("blocked", str(e)), alerts


@pytest.mark.parametrize("case", sorted(CASES))
def test_monitor_matches_jax(case):
    from recommendflow_tpu.train import monitor as jmon
    from recommendflow_tpu_torch.train import monitor as tmon
    old, new, constraints = CASES[case]
    (jkind, jval), jalerts = _outcome(jmon, old, new, constraints)
    (tkind, tval), talerts = _outcome(tmon, old, new, constraints)
    assert (tkind, tval) == (jkind, jval)
    assert talerts == jalerts
    if tkind == "blocked":
        assert talerts == [tval]
    else:
        assert talerts == []
    want = {"pass": "ok", "block": "blocked", "closed_bounds": "ok",
            "open_lower_at_edge": "ok", "upper_bound": "blocked",
            "zero_baseline_up": "ok", "zero_baseline_down": "blocked",
            "zero_to_zero": "ok", "missing_new": "blocked",
            "missing_old": "blocked"}[case]
    assert tkind == want, tval


def test_monitor_change_values():
    from recommendflow_tpu_torch.train.monitor import model_online_monitor
    changes = model_online_monitor(*CASES["pass"])
    assert changes["hit@50"] == pytest.approx(-0.02)
    assert model_online_monitor(*CASES["zero_baseline_up"])["auc"] > 0


def _capture_cmd(path):
    return f"{sys.executable} -c \"import sys; open({str(path)!r}, 'wb')" \
           f".write(sys.stdin.buffer.read())\""


@pytest.mark.parametrize("via_env", [False, True], ids=["arg", "env"])
def test_command_payload_equals_jax(tmp_path, monkeypatch, via_env):
    from recommendflow_tpu.utils import alerts as jal
    from recommendflow_tpu_torch.utils import alerts as tal
    msg = "model promotion blocked: auc: relative change -0.5000 — ünïcode"
    got = {}
    for name, mod in (("jax", jal), ("torch", tal)):
        cmd = _capture_cmd(tmp_path / name)
        if via_env:
            monkeypatch.setenv("RECFLOW_ALERT_CMD", cmd)
            assert mod.send_alert(msg, title="daily-finetune") is True
        else:
            assert mod.send_alert(msg, title="daily-finetune",
                                  command=cmd) is True
        got[name] = (tmp_path / name).read_bytes()
    assert got["torch"] == got["jax"]
    assert json.loads(got["torch"]) == {"title": "daily-finetune",
                                        "text": msg}


class _Hook(http.server.BaseHTTPRequestHandler):
    bodies = []

    def do_POST(self):
        n = int(self.headers["Content-Length"])
        type(self).bodies.append((self.headers["Content-Type"],
                                  self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


def test_webhook_posts_the_payload(monkeypatch):
    from recommendflow_tpu.utils import alerts as jal
    from recommendflow_tpu_torch.utils import alerts as tal
    _Hook.bodies = []
    server = http.server.HTTPServer(("127.0.0.1", 0), _Hook)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/hook"
        assert jal.send_alert("promotion blocked", webhook_url=url)
        monkeypatch.setenv("RECFLOW_ALERT_WEBHOOK", url)
        assert tal.send_alert("promotion blocked")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert len(_Hook.bodies) == 2 and _Hook.bodies[0] == _Hook.bodies[1]
    assert _Hook.bodies[1][0] == "application/json"


def test_failed_push_retries_and_never_raises(monkeypatch):
    from recommendflow_tpu_torch.utils import alerts as tal
    sleeps = []
    # the module's own clock only (subprocess sleeps while it waits)
    monkeypatch.setattr(tal, "time", types.SimpleNamespace(
        sleep=sleeps.append))
    assert tal.send_alert("x", command="exit 3") is False
    assert sleeps == [1, 2, 4]
    sleeps.clear()
    # a refused connection (nothing listens on port 9 of localhost)
    assert tal.send_alert("x", webhook_url="http://127.0.0.1:9/") is False
    assert sleeps == [1, 2, 4]


def test_log_only_without_a_transport(monkeypatch):
    from recommendflow_tpu_torch.utils import alerts as tal
    monkeypatch.delenv("RECFLOW_ALERT_WEBHOOK", raising=False)
    monkeypatch.delenv("RECFLOW_ALERT_CMD", raising=False)
    assert tal.send_alert("nothing to push to") is False


def test_alerting_pushes_and_reraises(monkeypatch):
    from recommendflow_tpu_torch.utils import alerts as tal
    pushed = []
    monkeypatch.setattr(tal, "send_alert",
                        lambda msg, title: pushed.append((msg, title)))

    def daily_job(x):
        if x:
            raise ValueError("bad day")
        return 7
    job = tal.alerting(daily_job, title="daily")
    assert job(0) == 7 and pushed == []
    with pytest.raises(ValueError, match="bad day"):
        job(1)
    assert pushed == [("daily_job failed: ValueError: bad day", "daily")]
