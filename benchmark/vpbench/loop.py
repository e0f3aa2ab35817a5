"""What every driver's window shares: a step clock that ends the window,
the record of a step kept for the check, the draw of the step to check,
and the relative error the checks compare."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch


class WindowClosed(Exception):
    """Raised from a step's progress callback to end the window."""


class StepClock:
    """Host clock after a device synchronise at the end of every step. The
    window closes at the first step end at or past `seconds`, or after
    `steps` steps."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ends: List[float] = []
        self.t0 = 0.0
        self.done = True

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self, *, seconds: Optional[float] = None, steps: Optional[int] = None):
        if seconds is None and steps is None:
            raise ValueError("a window needs seconds or steps")
        self.sync()
        self.t0 = time.perf_counter()
        self.ends, self.done = [], False
        self.deadline = None if seconds is None else self.t0 + seconds
        self.max_steps = steps

    def tick(self, *_):
        self.sync()
        t = time.perf_counter()
        self.ends.append(t)
        if ((self.deadline is not None and t >= self.deadline)
                or (self.max_steps is not None and len(self.ends) >= self.max_steps)):
            self.done = True
            raise WindowClosed

    def run(self, fn: Callable[[], object]):
        try:
            fn()
        except WindowClosed:
            pass

    @property
    def steps(self) -> int:
        return len(self.ends)

    @property
    def elapsed(self) -> float:
        return self.ends[-1] - self.t0


@dataclass
class Record:
    cycle: int
    i: int                       # the step's index in its schedule
    sample: torch.Tensor         # the step's input latents
    pred: torch.Tensor           # the guided prediction the scheduler got
    old_x0: Optional[torch.Tensor]
    raw: Optional[torch.Tensor] = None           # the DiT's output over the CFG batch
    next_sample: Optional[torch.Tensor] = None   # the step's blended output


def pick_step(log: List[Record], seed: int) -> Record:
    """One recorded step drawn from the seed, among those whose output was
    recorded; second-order DPM steps (index >= 1) when there are any."""
    done = [r for r in log if r.next_sample is not None]
    if not done:
        raise RuntimeError("the window recorded no complete step to check")
    second = [r for r in done if r.i >= 1]
    pool = second or done
    return pool[int(np.random.default_rng(int(seed) % (1 << 63)).integers(len(pool)))]


def rel_err(a: torch.Tensor, b: torch.Tensor, denom: Optional[torch.Tensor] = None) -> float:
    """||a - b|| / ||denom|| (denom defaults to b), in float64."""
    d = b if denom is None else denom
    num = torch.linalg.vector_norm((a.double() - b.double()).flatten())
    den = torch.linalg.vector_norm(d.double().flatten())
    return float(num / den)
