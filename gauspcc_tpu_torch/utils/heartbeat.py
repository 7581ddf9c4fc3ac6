"""Liveness heartbeat for long device jobs: the port's copy of
gauspcc_tpu/utils/heartbeat.py (`Heartbeat` :34; its `NullHeartbeat` :77
is not ported: the trainer always keeps a heartbeat file).

An external stall watchdog kills a run whose log goes quiet for too
long, while a long blocking section (a first step, a validation sweep,
an encode) prints nothing. The training process therefore keeps a
heartbeat FILE the watchdog can stat:

  - ``beat()``: a cheap mtime bump, once per completed step;
  - ``guard()``: a context manager whose background thread keeps touching
    the file while a known-blocking section is in flight.

A guard's thread stops after ``max_s`` seconds even if the section never
exits, so a hung device is still detected within ``max_s`` plus the
watchdog's own stall limit. Outside guard sections the file goes quiet
at once on a hang.
"""

from __future__ import annotations

import contextlib
import os
import threading


class Heartbeat:
    """Touches ``path`` to prove liveness to an external stall watchdog."""

    def __init__(self, path: str, interval: float = 45.0,
                 max_s: float = 1500.0):
        self.path = path
        self.interval = float(interval)
        self.max_s = float(max_s)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.beat()

    def beat(self) -> None:
        with open(self.path, "a"):
            pass
        os.utime(self.path, None)

    @contextlib.contextmanager
    def guard(self, label: str = ""):
        """Keep the heartbeat alive through a blocking section, for at
        most ``max_s`` seconds (bounded so true hangs still surface)."""
        stop = threading.Event()
        budget = self.max_s

        def _run():
            waited = 0.0
            while waited < budget and not stop.wait(self.interval):
                self.beat()
                waited += self.interval

        t = threading.Thread(target=_run, daemon=True,
                             name=f"heartbeat-guard:{label}")
        t.start()
        try:
            yield
        finally:
            stop.set()
            t.join(timeout=5.0)
            self.beat()

