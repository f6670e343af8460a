"""Fault-tolerant training runner: checkpoint/restart, failure injection,
straggler accounting (the counterpart of ``repro.train.fault_tolerance``).

  * periodic atomic checkpoints (``train/checkpoint.py``), and one at the
    end;
  * a step that fails → restore the latest checkpoint and go on, up to
    ``max_retries``; the data is a pure function of the step
    (``data/pipeline.py``), so no epoch state needs recovery;
  * a step-time watchdog: steps slower than ``straggler_factor ×`` the
    running median are counted. On a CUDA state a step is timed to its
    end on the device (one synchronise before the clock stops), or the
    clock would time only the launches.

Failure injection (``failure_at``) exists so tests can prove that the
recovery path works.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    state_leaves,
)


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    max_retries: int = 3
    straggler_factor: float = 3.0


class InjectedFailure(RuntimeError):
    pass


class TrainRunner:
    def __init__(
        self,
        step_fn: Callable[[Any, dict], tuple[Any, dict]],
        init_state: Any,
        batch_fn: Callable[[int], dict],
        cfg: RunnerConfig,
        *,
        failure_at: Optional[int] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.failure_at = failure_at
        self._injected = False
        self.state = init_state
        self.step = 0
        self.retries = 0
        self.step_times: list[float] = []
        self.stragglers = 0
        self.recoveries = 0
        self._cuda = any(t.is_cuda for _, t in state_leaves(init_state))

    def _maybe_resume(self):
        if latest_step(self.cfg.checkpoint_dir) is not None:
            self.state, self.step = restore_checkpoint(
                self.cfg.checkpoint_dir, self.state)
            self.recoveries += 1

    def _watchdog(self, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = float(np.median(self.step_times[-64:]))
            if dt > self.cfg.straggler_factor * med:
                self.stragglers += 1

    def run(self) -> dict:
        self._maybe_resume()
        metrics = None
        while self.step < self.cfg.total_steps:
            if (self.failure_at is not None and self.step == self.failure_at
                    and not self._injected):
                self._injected = True
                try:
                    raise InjectedFailure(f"injected at step {self.step}")
                except InjectedFailure:
                    if self.retries >= self.cfg.max_retries:
                        raise
                    self.retries += 1
                    self._maybe_resume()
                    continue
            t0 = time.perf_counter()
            batch = self.batch_fn(self.step)
            self.state, metrics = self.step_fn(self.state, batch)
            if self._cuda:
                torch.cuda.synchronize()
            self._watchdog(time.perf_counter() - t0)
            self.step += 1
            if self.step % self.cfg.checkpoint_every == 0:
                save_checkpoint(self.cfg.checkpoint_dir, self.state, self.step)
        save_checkpoint(self.cfg.checkpoint_dir, self.state, self.step)
        return {
            "final_step": self.step,
            "retries": self.retries,
            "recoveries": self.recoveries,
            "stragglers": self.stragglers,
            "metrics": metrics,
        }
