"""Wall-clock seconds per pipeline stage.

A stage's time ends in ``torch.cuda.synchronize()`` when the device is a
card, since PyTorch returns before the card finishes; on the CPU the host
clock alone is the stage's time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StageTimer:
    """Accumulates seconds per stage name in ``seconds``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
