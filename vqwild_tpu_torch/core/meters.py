"""Wall-clock meters (reference misc_utils/utils.py:14-67)."""

from __future__ import annotations

import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MedianMeter:
    def __init__(self, window: int = 100):
        self.window = window
        self.vals = []

    def update(self, val):
        self.vals.append(val)
        if len(self.vals) > self.window:
            self.vals.pop(0)

    @property
    def median(self) -> float:
        if not self.vals:
            return 0.0
        s = sorted(self.vals)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class Timer:
    def __init__(self):
        self.start = time.time()
        self.end = self.start

    def thetime(self) -> float:
        return time.time()

    def tick(self) -> float:
        now = time.time()
        dt = now - self.end
        self.end = now
        return dt

    def total(self) -> float:
        return time.time() - self.start
