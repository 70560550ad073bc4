"""The measured window: operations back to back, and its rate.

The window runs from the start of the first operation to the end of the
operation in flight at the deadline, which counts.  The rate is all the
work of the operations that completed over the whole window, failed
operations' time included.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    work: float = 0.0
    attempted: int = 0
    failed: int = 0
    done: list = field(default_factory=list)    # indices that completed
    walls: list = field(default_factory=list)   # seconds of every operation

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def rate(self) -> float:
        return self.work / self.seconds if self.seconds > 0 else 0.0


def run_window(op, seconds: float, clock=time.perf_counter) -> Window:
    """Run `op(i)` for i = 0, 1, ... from now until the first operation
    that ends at or past `seconds`; an operation that raises counts as
    failed, its traceback on standard error."""
    w = Window(start=clock())
    deadline = w.start + seconds
    t = w.start
    while w.attempted == 0 or t < deadline:
        i = w.attempted
        w.attempted += 1
        try:
            work = op(i)
        except Exception:                     # the run goes on; judged below
            traceback.print_exc(file=sys.stderr)
            w.failed += 1
        else:
            w.work += work
            w.done.append(i)
        end = clock()
        w.walls.append(end - t)
        t = end
    w.end = t
    return w
