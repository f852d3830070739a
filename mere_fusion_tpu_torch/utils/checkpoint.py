"""Checkpoints of the port's own training state, with torch.save.

One file per step, ``<directory>/ckpt-<step>.pt``, holding whatever
state dict the trainer hands over (tensors, numbers, strings, lists and
dicts of them) and the step's metrics. A save writes to a temporary name and
renames it into place, so a crash never leaves a half-written checkpoint
under a real name; the newest ``max_keep`` are kept. Reading the JAX
package's orbax directories is not ported (ROADMAP: 'Checkpoints').
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"ckpt-(\d+)\.pt")


class Checkpointer:
    def __init__(self, directory: str, max_keep: int = 2):
        if max_keep < 1:
            raise ValueError(f"max_keep must be at least 1, got {max_keep}")
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def steps(self) -> list[int]:
        """Steps with a checkpoint on disk, oldest first."""
        found = (_NAME.fullmatch(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    @property
    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, metrics: dict | None = None) -> str:
        """Write ``state`` (a state dict) for ``step``; returns the path."""
        out = self.path(step)
        tmp = f"{out}.{os.getpid()}.tmp"
        torch.save({"step": int(step), "state": state,
                    "metrics": {k: float(v) for k, v in (metrics or {}).items()}}, tmp)
        os.replace(tmp, out)
        for old in self.steps()[:-self.max_keep]:
            os.remove(self.path(old))
        return out

    def restore(self, step: int | None = None, map_location=None) -> dict:
        """The state dict saved for ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)["state"]

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX twin's API."""
