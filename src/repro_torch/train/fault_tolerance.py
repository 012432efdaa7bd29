"""Fault tolerance for long-running jobs (the JAX package's
``repro.train.fault_tolerance``, pure Python, kept as it is).

Three mechanisms, each exercised by tests:

1. **Step watchdog / straggler detection** — every train step runs under a
   deadline derived from a running p95 of past step times; a step that blows
   the deadline marks the fleet "suspect" and triggers the recovery ladder
   (on a real fleet this is where the cluster manager gets paged; here the
   policy object is fully testable).

2. **Retry-with-restore** — transient failures (preemption, ICI glitch,
   numerical NaN-burst) restart from the last atomic checkpoint; the data
   pipeline key is part of the checkpoint so the batch sequence replays
   deterministically.

3. **Elastic re-mesh** — when a pod/slice is lost, the job continues on a
   smaller mesh: ``plan_remesh`` computes the largest valid (pods, data,
   model) grid for the surviving chip count, and restore re-shards the
   checkpoint onto it (see ``checkpoint.restore_checkpoint(device=...)``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class WatchdogPolicy:
    """Running-quantile deadline for straggler detection."""

    warmup_steps: int = 5
    multiplier: float = 3.0
    min_deadline_s: float = 5.0
    _history: List[float] = dataclasses.field(default_factory=list)

    def record(self, step_time_s: float) -> None:
        self._history.append(step_time_s)
        if len(self._history) > 100:
            self._history.pop(0)

    @property
    def deadline_s(self) -> float:
        if len(self._history) < self.warmup_steps:
            return float("inf")
        hist = sorted(self._history)
        p95 = hist[int(0.95 * (len(hist) - 1))]
        return max(self.multiplier * p95, self.min_deadline_s)

    def is_straggler(self, step_time_s: float) -> bool:
        return step_time_s > self.deadline_s


def plan_remesh(surviving_chips: int, *, model_parallel: int = 16
                ) -> Optional[Tuple[int, int]]:
    """Largest (data, model) grid on the survivors, keeping TP intact.

    Model-parallel groups must stay whole (a TP shard loss kills its whole
    group), so the surviving chip count is floored to a multiple of
    ``model_parallel``; returns None if not even one group survives.
    """
    data = surviving_chips // model_parallel
    if data < 1:
        return None
    return data, model_parallel


class StepFailure(Exception):
    pass


def run_with_recovery(step_fn: Callable[[int], dict], *, start_step: int,
                      num_steps: int,
                      save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      checkpoint_every: int = 100,
                      max_retries: int = 3,
                      watchdog: Optional[WatchdogPolicy] = None,
                      on_event: Optional[Callable[[str, dict], None]] = None
                      ) -> int:
    """The training loop: run → checkpoint → (on failure) restore → resume.

    ``step_fn(step)`` raises StepFailure (or any exception) on a failed
    step.  Returns the final completed step.
    """
    watchdog = watchdog or WatchdogPolicy()
    emit = on_event or (lambda kind, info: None)
    step = start_step
    retries = 0
    while step < start_step + num_steps:
        t0 = time.monotonic()
        try:
            metrics = step_fn(step)
            dt = time.monotonic() - t0
            if watchdog.is_straggler(dt):
                emit("straggler", {"step": step, "time_s": dt,
                                   "deadline_s": watchdog.deadline_s})
            watchdog.record(dt)
            retries = 0
            if (step + 1) % checkpoint_every == 0:
                save_fn(step + 1)
                emit("checkpoint", {"step": step + 1})
            step += 1
        except Exception as e:                      # noqa: BLE001
            retries += 1
            emit("failure", {"step": step, "error": repr(e),
                             "retry": retries})
            if retries > max_retries:
                raise
            step = restore_fn()
            emit("restored", {"step": step})
    return step
