"""Fault tolerance: checkpoint/restart driver, straggler detection,
elastic re-meshing (twin of ``repro.distributed.fault``).

The design point is 1000+ nodes where *something* is always failing:

  * ``FaultTolerantLoop`` wraps the train step with async checkpointing,
    automatic restore-on-failure (bounded retries), and step-time
    monitoring;
  * ``StragglerDetector`` flags steps slower than ``threshold`` x a robust
    running median — on real pods the hook reports the slow host for
    drain/replace; here it feeds the loop's telemetry and tests;
  * ``ElasticMesh`` re-plans the mesh when devices are lost: it keeps the
    model axis intact (TP degree is fixed by weight shapes) and shrinks
    the data axis to the largest full multiple, so training continues on
    e.g. 15/16 data slices after a host loss, with per-step global batch
    rescaled.  Re-entry of the repaired host happens at the next
    checkpoint boundary.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager

log = logging.getLogger("repro_torch.fault")
Pytree = Any


class StragglerDetector:
    """Robust step-time outlier detection (median-of-window)."""

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 10:
            med = float(np.median(self.times))
            if dt > self.threshold * med:
                self.flagged += 1
                is_straggler = True
                log.warning("straggler step: %.3fs vs median %.3fs",
                            dt, med)
        self.times.append(dt)
        return is_straggler


@dataclasses.dataclass
class ElasticPlan:
    data_size: int
    dropped_hosts: int
    global_batch: int


class ElasticMesh:
    """Re-plan (data, model) after device loss; model axis is inviolable."""

    def __init__(self, data_size: int, model_size: int,
                 global_batch: int):
        self.data_size = data_size
        self.model_size = model_size
        self.global_batch = global_batch

    def replan(self, healthy_devices: int) -> ElasticPlan:
        full_rows = healthy_devices // self.model_size
        if full_rows < 1:
            raise RuntimeError("fewer healthy devices than one model row")
        new_data = full_rows
        per = self.global_batch // self.data_size
        return ElasticPlan(data_size=new_data,
                           dropped_hosts=self.data_size - new_data,
                           global_batch=per * new_data)


def _wait(metric):
    """Block until ``metric`` is computed (a tensor's ``.item()``)."""
    if hasattr(metric, "item"):
        metric.item()


class FaultTolerantLoop:
    """Run ``step_fn(state, batch) -> (state, metrics)`` with restart.

    ``state`` is any port tree (params, opt state, ...); ``metrics`` a
    dict of 0-d tensors (or floats).  A step's time ends when its first
    metric is read on the host (``.item()``: the device has finished the
    step), where the reference blocks on it.  On an exception the
    loop restores the latest checkpoint, rewinds the data iterator, and
    retries (``max_restarts`` total).  Checkpoints every
    ``ckpt_every`` steps, asynchronously.
    """

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 data_iter, ckpt_every: int = 100, max_restarts: int = 3,
                 straggler: Optional[StragglerDetector] = None,
                 fail_injector: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.data = data_iter
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerDetector()
        self.fail_injector = fail_injector
        self.restarts = 0

    def run(self, state: Pytree, n_steps: int, start_step: int = 0):
        step = start_step
        metrics_log = []
        while step < n_steps:
            try:
                batch = next(self.data)
                t0 = time.time()
                if self.fail_injector is not None:
                    self.fail_injector(step)
                state, metrics = self.step_fn(state, batch)
                _wait(next(iter(metrics.values())))
                self.straggler.observe(time.time() - t0)
                metrics_log.append(
                    {k: float(v) for k, v in metrics.items()})
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    self.ckpt.save(step, state,
                                   extra={"data": self.data.state_dict()})
            except (FileNotFoundError, KeyboardInterrupt):
                raise
            except Exception as e:     # node failure / preemption path
                self.restarts += 1
                log.error("step %d failed (%s); restart %d/%d", step,
                          type(e).__name__, self.restarts,
                          self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                last = self.ckpt.latest_step()
                if last is None:
                    raise
                state, meta = self.ckpt.restore(state)
                self.data.load_state_dict(meta["extra"]["data"])
                step = meta["step"]
        self.ckpt.wait()
        return state, metrics_log
