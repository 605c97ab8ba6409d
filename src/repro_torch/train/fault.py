"""Fault tolerance: watchdog and preemption-safe training.

Twin of ``repro/train/fault.py``:

* :class:`StepWatchdog`: per-step timing EMA; flags stragglers (steps
  slower than ``factor`` x EMA) and exposes the counters a cluster agent
  would alarm on.
* :func:`run_training`: checkpoint/restart loop: saves every
  ``ckpt_every`` steps, auto-resumes from the latest checkpoint, and
  optionally raises a simulated preemption. A run killed mid-flight and
  restarted ends bit-identical to an uninterrupted run (deterministic
  data pipeline and step).

Elasticity: checkpoints are mesh-agnostic, so a run restarted on another
mesh restores them with ``checkpoint.restore(shardings=...)`` resolved
for the mesh that is alive (``parallel.sharding.param_shardings``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class StepWatchdog:
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    ema: float | None = None
    stragglers: int = 0
    steps: int = 0
    last_duration: float = 0.0

    def record(self, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self.steps += 1
        self.last_duration = duration_s
        is_straggler = (self.ema is not None and
                        duration_s > self.straggler_factor * self.ema)
        if is_straggler:
            self.stragglers += 1
            # do not fold outliers into the EMA: keeps the threshold stable
            return True
        self.ema = (duration_s if self.ema is None else
                    self.ema_decay * self.ema +
                    (1 - self.ema_decay) * duration_s)
        return False


class SimulatedPreemption(RuntimeError):
    pass


def _wait(metrics: dict) -> None:
    """Block until the step's metrics are computed: a synchronise on
    their device (``jax.block_until_ready``'s counterpart)."""
    for t in metrics.values():
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def run_training(state, step_fn: Callable, data_iter_fn: Callable[[int], Any],
                 *, num_steps: int, ckpt_dir: str | None = None,
                 ckpt_every: int = 50, preempt_at: int | None = None,
                 watchdog: StepWatchdog | None = None,
                 on_metrics: Callable | None = None):
    """Checkpoint/restart training loop.

    ``data_iter_fn(step)`` must return the batch for that *global* step:
    the determinism contract that makes restarts exact. A restart
    continues from a new state restored from the latest checkpoint; the
    state passed in is then only its template. ``on_metrics(step, m)``
    gets the metrics as numpy."""
    start = 0
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        state, start = ckpt.restore(ckpt_dir, state)

    metrics = None
    for step in range(start, num_steps):
        if preempt_at is not None and step == preempt_at:
            raise SimulatedPreemption(f"preempted at step {step}")
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data_iter_fn(step))
        _wait(metrics)
        if watchdog is not None:
            watchdog.record(time.perf_counter() - t0)
        if on_metrics is not None:
            on_metrics(step, {k: v.detach().cpu().numpy()
                              for k, v in metrics.items()})
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state)
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, num_steps, state)
    return state, metrics
