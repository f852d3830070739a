"""Multi-session device placement over the host's CUDA devices.

Sessions pack across the GPUs of one host: each session's weights live on
an assigned device and its launches run there. The least-loaded device is
chosen, with a per-device session cap.
"""
from __future__ import annotations

import threading

import torch


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass the devices to "
                           "place on explicitly, e.g. [torch.device('cpu')]")
    return [torch.device("cuda", i) for i in range(n)]


class DevicePlacer:
    def __init__(self, devices=None, max_sessions_per_device: int = 4):
        self.devices = [torch.device(d) for d in
                        (devices if devices is not None else cuda_devices())]
        self.max_per_device = max_sessions_per_device
        self._counts = {d: 0 for d in self.devices}
        self._assignments: dict[str, torch.device] = {}
        self._lock = threading.Lock()

    def acquire(self, session_id: str) -> torch.device:
        with self._lock:
            device = min(self.devices, key=lambda d: self._counts[d])
            if self._counts[device] >= self.max_per_device:
                raise RuntimeError("all devices at session capacity")
            self._counts[device] += 1
            self._assignments[session_id] = device
            return device

    def release(self, session_id: str) -> None:
        with self._lock:
            device = self._assignments.pop(session_id, None)
            if device is not None:
                self._counts[device] -= 1

    def counts(self) -> dict:
        """Snapshot of sessions per device (observability)."""
        with self._lock:
            return dict(self._counts)
