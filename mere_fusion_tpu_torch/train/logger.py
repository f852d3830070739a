"""Structured training scalars + preemption-safe stop flag.

Copy of mere_fusion_tpu/train/logger.py (the port imports nothing of the JAX
package): an append-only JSONL scalar stream (one object per logged step)
and a SIGTERM/SIGINT flag so the train loop checkpoints before dying.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Optional


class ScalarLogger:
    """Append scalars to <workspace>/scalars.jsonl."""

    def __init__(self, workspace: str, filename: str = "scalars.jsonl"):
        os.makedirs(workspace, exist_ok=True)
        self.path = os.path.join(workspace, filename)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


class StopFlag:
    """Turns SIGTERM/SIGINT into a checkpoint-then-exit request.

    Usage: flag = StopFlag.install(); in the loop: `if flag: save+break`.
    The previous handlers are restored on uninstall(); a second signal
    falls through to the default behavior (hard kill still possible).
    """

    def __init__(self):
        self.stop = False
        self._prev: dict = {}

    def __bool__(self) -> bool:
        return self.stop

    def _handler(self, signum, frame):
        if self.stop:  # second signal: restore + re-raise default behavior
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.stop = True

    @classmethod
    def install(cls, signals=(signal.SIGTERM, signal.SIGINT)) -> "StopFlag":
        flag = cls()
        for s in signals:
            try:
                flag._prev[s] = signal.signal(s, flag._handler)
            except (ValueError, OSError):  # non-main thread
                pass
        return flag

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
