"""Training-progress notifier (reference: core/notifyier.py — posts losses
and reconstruction-image grids to Slack/Telegram webhooks every N steps).

This environment has no network egress, so the transport is pluggable:
``FileNotifier`` (default) appends messages to ``notifications.log`` in the
run dir — same call sites, same payloads; a webhook transport drops in by
registering a callable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np


class Notifier:
    def notify(self, message: str, scalars: Optional[Dict] = None,
               image: Optional[np.ndarray] = None) -> None:
        raise NotImplementedError


class NullNotifier(Notifier):
    def notify(self, message, scalars=None, image=None) -> None:
        pass


class FileNotifier(Notifier):
    def __init__(self, run_dir: str) -> None:
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "notifications.log")
        self.image_dir = os.path.join(run_dir, "notify_images")

    def notify(self, message, scalars=None, image=None) -> None:
        rec = {"time": time.time(), "message": message}
        if scalars:
            rec["scalars"] = {k: float(v) for k, v in scalars.items()}
        if image is not None:
            os.makedirs(self.image_dir, exist_ok=True)
            img_path = os.path.join(
                self.image_dir, f"notify_{int(time.time() * 1000)}.npy")
            np.save(img_path, image)
            rec["image"] = img_path
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class CallableNotifier(Notifier):
    """Wraps an arbitrary transport (e.g. a webhook poster)."""

    def __init__(self, fn: Callable[[dict], None]) -> None:
        self.fn = fn

    def notify(self, message, scalars=None, image=None) -> None:
        self.fn({"message": message, "scalars": scalars, "image": image})


class WebhookNotifier(Notifier):
    """POSTs JSON payloads to a Slack/Telegram-style webhook URL (reference
    parity: core/notifyier.py webhook transports).

    Failures are swallowed after ``max_failures`` consecutive errors the
    transport disables itself — a dead webhook must never kill or stall a
    training run (and this dev environment has no egress at all).
    Images are summarized by shape (webhooks take text; the full grid
    still lands in TensorBoard/notify_images via the file notifier).
    """

    def __init__(self, url: str, timeout: float = 5.0,
                 max_failures: int = 3) -> None:
        self.url = url
        self.timeout = timeout
        self.max_failures = max_failures
        self._failures = 0

    def notify(self, message, scalars=None, image=None) -> None:
        if self._failures >= self.max_failures:
            return
        payload = {"text": message}
        if scalars:
            lines = [f"{k}: {float(v):.4f}" for k, v in scalars.items()]
            payload["text"] = message + "\n" + "\n".join(lines)
        if image is not None:
            payload["text"] += f"\n[image {tuple(np.shape(image))}]"
        try:
            import urllib.request

            req = urllib.request.Request(
                self.url,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=self.timeout).read()
            self._failures = 0
        except Exception:
            self._failures += 1


def build_notifier(kind: str, run_dir: str) -> Notifier:
    """``none`` | ``file`` | ``webhook:<url>``."""
    if kind == "none":
        return NullNotifier()
    if kind == "file":
        return FileNotifier(run_dir)
    if kind.startswith("webhook:"):
        return WebhookNotifier(kind.split(":", 1)[1])
    raise ValueError(f"unknown notifier kind {kind!r}")
