"""Append-and-flush text logger + running average meter.

Copy of ``mgvae_tpu/utils/logger.py`` (pure Python), the reference's
utils/logger.py:12-23 and utils/utils.py:14-30.
"""
from __future__ import annotations

import os
import time


class Logger:
    def __init__(self, path: str):
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        self.path = path
        self.f = open(path, "a")
        self.f.write("\n==================== {} ====================\n".format(time.strftime("%Y-%m-%d %H:%M:%S")))
        self.f.flush()

    def write(self, text: str):
        self.f.write(text)
        self.f.flush()

    def close(self):
        self.f.close()


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        if self.count > 0:
            self.avg = self.sum / self.count
