"""Training loop with checkpoint / resume and the step watchdog, the
reference's ``train/trainer.py`` on one device.

  * auto-resume: on start, restores the latest complete checkpoint
    (params + opt state + data-pipeline state) if one exists;
  * atomic periodic checkpoints every ``ckpt_every`` steps (keep-k), and
    one at the end of ``run``;
  * watchdog: each step is timed against a deadline of ``factor`` times
    the running median (straggler detection); on a breach ``"log"``
    records the event and ``"checkpoint"`` also snapshots.

A step's time ends when the device has finished it (``synchronize``, the
counterpart of ``block_until_ready``).  Parameters are drawn on
``device`` from a ``torch.Generator`` seeded with ``TrainerConfig.seed``
(the draws differ from the reference's ``jax.random``; the tests hand the
reference's parameters across instead).  ``exec_cfg``, when given, is
installed around every step, backward included (remat recomputes under
it).

On a ``mesh`` (with ``rules``) the trainer keeps this rank's shards of
the parameters and moments (``train_step.param_specs``); a checkpoint is
written by rank 0 from the gathered full leaves, in the reference's
files, and every rank restores its own shards from them.  Only rank 0
prints.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline, with_frontend_inputs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.sharding import partition
from repro_torch.train.optimizer import AdamWConfig, OptState, init_opt_state
from repro_torch.train.train_step import build_train_step, param_specs


@dataclass
class WatchdogConfig:
    factor: float = 3.0          # deadline = factor × running median
    min_history: int = 5
    action: str = "log"          # log | checkpoint


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    seed: int = 0


class Watchdog:
    """Step-time straggler detector."""

    def __init__(self, cfg: WatchdogConfig):
        self.cfg = cfg
        self.history: List[float] = []
        self.events: List[Dict] = []

    def deadline(self) -> Optional[float]:
        if len(self.history) < self.cfg.min_history:
            return None
        return float(np.median(self.history)) * self.cfg.factor

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if the deadline was breached."""
        dl = self.deadline()
        breached = dl is not None and dt > dl
        if breached:
            self.events.append({"step": step, "dt": dt, "deadline": dl})
        else:
            self.history.append(dt)
            self.history = self.history[-64:]
        return breached


class Trainer:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 opt_cfg: AdamWConfig, tcfg: TrainerConfig, *,
                 mesh=None, rules=None,
                 pipeline: Optional[TokenPipeline] = None, dtype=None,
                 exec_cfg: Optional[ops.ExecConfig] = None,
                 device="cuda"):
        self.cfg, self.shape, self.opt_cfg, self.tcfg = cfg, shape, opt_cfg, tcfg
        self.device = resolve_device(device)
        self.dtype = dtype or torch.float32
        self.exec_cfg = exec_cfg
        self.step_fn = build_train_step(cfg, shape, opt_cfg, mesh, rules,
                                        donate=False)
        self.mesh = mesh if rules is not None else None
        self.specs = (param_specs(cfg, rules) if self.mesh is not None
                      else None)
        self.pipeline = pipeline
        self.watchdog = Watchdog(tcfg.watchdog)
        self.metrics_log: List[Dict] = []
        self.step = 0
        self.params = None
        self.opt_state = None

    # ---- state ----
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.params = self._local(model_lib.init_params(
            self.cfg, gen, dtype=self.dtype, device=self.device))
        self.opt_state = init_opt_state(self.params)
        self.step = 0

    def _local(self, tree):
        """This rank's shards of a full parameter-shaped tree."""
        if self.specs is None:
            return tree
        return partition.shard_tree(tree, self.specs, self.mesh)

    def _full(self, tree):
        if self.specs is None:
            return tree
        return partition.gather_tree(tree, self.specs, self.mesh)

    @property
    def rank0(self) -> bool:
        return self.mesh is None or self.mesh.axis_index(
            self.mesh.axis_names) == 0

    def try_restore(self) -> bool:
        d = self.tcfg.ckpt_dir
        if not d or ckpt_lib.latest_step(d) is None:
            return False
        like = {"params": self.params, "opt": self.opt_state}
        state, extra = ckpt_lib.restore(d, like)
        opt = state["opt"]
        self.params = self._local(state["params"])
        self.opt_state = OptState(step=opt.step, mu=self._local(opt.mu),
                                  nu=self._local(opt.nu))
        self.step = int(extra["step"])
        if self.pipeline is not None and "data" in extra:
            self.pipeline.restore(extra["data"])
        return True

    def checkpoint(self):
        if not self.tcfg.ckpt_dir:
            return
        extra = {"step": self.step}
        if self.pipeline is not None:
            extra["data"] = self.pipeline.snapshot()
        opt = self.opt_state
        state = {"params": self._full(self.params),
                 "opt": OptState(step=opt.step, mu=self._full(opt.mu),
                                 nu=self._full(opt.nu))}
        if self.rank0:
            ckpt_lib.save(self.tcfg.ckpt_dir, self.step, state, extra=extra,
                          keep=self.tcfg.keep)
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier()

    # ---- loop ----
    def _next_batch(self):
        raw = self.pipeline.next_batch()
        raw = with_frontend_inputs(raw, self.cfg,
                                   n_vis=model_lib.n_vis(
                                       self.cfg, self.shape.seq_len))
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in raw.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` under ``exec_cfg``; advances the state
        (not the step count).  Returns the step's metrics (tensors)."""
        ctx = (ops.exec_config(self.exec_cfg) if self.exec_cfg is not None
               else contextlib.nullcontext())
        with ctx:
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
        return metrics

    def run(self) -> List[Dict]:
        if self.params is None:
            self.init_state()
            self.try_restore()
        while self.step < self.tcfg.steps:
            batch = self._next_batch()
            t0 = time.perf_counter()
            metrics = self.train_step(batch)
            self._sync()
            dt = time.perf_counter() - t0
            self.step += 1
            if self.watchdog.observe(self.step, dt):
                if self.tcfg.watchdog.action == "checkpoint":
                    self.checkpoint()
            rec = {"step": self.step, "dt": dt,
                   **{k: float(v) for k, v in metrics.items()}}
            self.metrics_log.append(rec)
            if self.step % self.tcfg.log_every == 0 and self.rank0:
                print(json.dumps({k: (round(v, 5) if isinstance(v, float)
                                      else v) for k, v in rec.items()}))
            if self.step % self.tcfg.ckpt_every == 0:
                self.checkpoint()
        self.checkpoint()
        return self.metrics_log
