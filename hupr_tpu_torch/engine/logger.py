"""Progress logging and best-AP tracking (counterpart of
`hupr_tpu/engine/logger.py`; parity: the reference's misc/logger.py).

The same five methods as the JAX package's Logger, with a plain progress
line in place of its tqdm bar: the port runs where tqdm is not installed.
"""

from __future__ import annotations

import time


class Logger:
    def __init__(self):
        self.best_ap = -1.0
        self.total = None
        self.done = 0
        self._t0 = 0.0

    def clear(self, total: int):
        """Start a new progress count over `total` samples."""
        self.total, self.done = total, 0
        self._t0 = time.perf_counter()

    def display(self, loss, loss2, update_size: int, epoch: int):
        """Advance the count by `update_size` samples and print one line:
        epoch, samples done, the losses and the rate so far."""
        if self.total is None:
            return
        self.done += update_size
        elapsed = time.perf_counter() - self._t0
        line = f"EP {epoch} {self.done}/{self.total} Loss {float(loss):.6f}"
        if loss2 is not None:
            line += f" Loss2 {float(loss2):.6f}"
        if elapsed > 0:
            line += f" {self.done / elapsed:.2f} samples/s"
        print(line, flush=True)

    def show_best_ap(self) -> float:
        return self.best_ap

    def update_best_acc(self, acc: float):
        self.best_ap = acc

    def is_best_acc_ap(self, acc: float) -> bool:
        if acc > self.best_ap or self.best_ap == -1.0:
            self.best_ap = acc
            return True
        return False
