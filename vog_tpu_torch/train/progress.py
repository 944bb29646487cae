"""Terminal progress bar for the Learner (counterpart of
vog_tpu/train/progress.py).

A throttled ``\\r``-redrawn line on stderr with bar, percent, rate and
postfix, drawing nothing when stderr is not a TTY (so redirected runs keep
clean txt/jsonl logs).  ``misc.progress``: ``auto`` (TTY only, default) |
``on`` | ``off``.  The first ``update`` always draws: the throttle's clock
starts at -inf, not at 0.0, whose comparison with ``perf_counter`` made
the JAX package's first draw depend on how long the host had been up.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Optional


def progress_enabled(mode: str, file=None) -> bool:
    file = file or sys.stderr
    if mode == "on":
        return True
    if mode == "off":
        return False
    return bool(getattr(file, "isatty", lambda: False)())


class ProgressBar:
    """One epoch-scoped bar.  ``update(n, **postfix)`` is cheap when
    disabled (single branch) and throttled to ``min_interval`` seconds
    when enabled, so a 5 ms train step never pays terminal IO per step."""

    WIDTH = 24

    def __init__(
        self,
        total: int,
        desc: str = "",
        enabled: bool = True,
        file=None,
        min_interval: float = 0.25,
    ):
        self.total = max(int(total), 1)
        self.desc = desc
        self.enabled = enabled
        self.file = file or sys.stderr
        self.min_interval = min_interval
        self.n = 0
        self._t0 = time.perf_counter()
        self._last_draw = -math.inf
        self._postfix = ""

    def update(self, n: int = 1, **postfix) -> None:
        self.n += n
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last_draw < self.min_interval and self.n < self.total:
            return
        self._last_draw = now
        if postfix:
            self._postfix = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in postfix.items()
            )
        self._draw(now)

    def _draw(self, now: float) -> None:
        frac = min(self.n / self.total, 1.0)
        filled = int(frac * self.WIDTH)
        bar = "█" * filled + "·" * (self.WIDTH - filled)
        rate = self.n / max(now - self._t0, 1e-9)
        remain = (self.total - self.n) / max(rate, 1e-9)
        line = (
            f"\r{self.desc} [{bar}] {self.n}/{self.total} "
            f"{frac * 100:3.0f}% {rate:.1f} it/s eta {remain:.0f}s "
            f"{self._postfix}"
        )
        self.file.write(line[:200])
        self.file.flush()

    def close(self, final: Optional[str] = None) -> None:
        if not self.enabled:
            return
        self._draw(time.perf_counter())
        self.file.write("\n" if final is None else f"  {final}\n")
        self.file.flush()
