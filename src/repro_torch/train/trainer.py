"""Training loop of the port (counterpart of `repro.train.trainer`): data
pipeline + train step + checkpointing + straggler-aware input
scheduling.

The loop composes the substrates: the locality-aware `DataPipeline` feeds
global batches (numpy, on the host); the train step
(`launch.steps.build_train_step`) runs them on the trainer's device; the
`Checkpointer` commits atomically every ``ckpt_every`` steps with the
pipeline's state in the metadata; the pipeline's EWMA estimator learns
its hosts' read rates, so a straggling data host sheds load mid-run (the
paper's robustness property, live in the input path).

The reference's `Trainer` takes a mesh and places its state on the
mesh's shardings; the port runs on one device and takes none.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models import params as params_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 256
    global_batch: int = 8
    steps: int = 50
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    seed: int = 0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 plan: steps_lib.RuntimePlan,
                 pipeline: Optional[DataPipeline] = None, device=None):
        """`device` None means the card (and raises without one)."""
        self.cfg, self.tcfg, self.plan = cfg, tcfg, plan
        self.device = resolve_device(device)
        self.pipeline = pipeline or DataPipeline(PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        (self.step_fn, self._astate,
         self._abatch) = steps_lib.build_train_step(
            cfg, plan, tcfg.global_batch, tcfg.seq_len, device=self.device)
        self.ckpt = (Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None)
        self.state: Optional[steps_lib.TrainState] = None
        self.history: List[Dict] = []

    # -- state ----------------------------------------------------------------
    def init_state(self) -> None:
        """Random parameters from `params.init_params` with a generator on
        the device seeded from ``tcfg.seed``, zero moments, step 0."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = params_lib.init_params(self.cfg, gen, device=self.device)
        self._set_state(params, adamw.init(self.plan.opt, params), 0)

    def from_reference_state(self, state) -> None:
        """Take over a reference `TrainState` handed over as numpy (e.g.
        ``jax.tree.map(np.asarray, state)``): params, ``opt.mu``,
        ``opt.nu``, ``opt.count`` and ``step``, dtypes kept."""
        conv = lambda t: params_lib.from_reference(t, device=self.device)
        opt = adamw.AdamWState(
            count=torch.tensor(int(state.opt.count), dtype=torch.int32,
                               device=self.device),
            mu=conv(state.opt.mu), nu=conv(state.opt.nu))
        self._set_state(conv(state.params), opt, int(state.step))

    def _set_state(self, params, opt: adamw.AdamWState, step: int) -> None:
        for p in params_lib.tree_leaves(params):
            p.requires_grad_(True)
        self.state = steps_lib.TrainState(
            params, opt, torch.tensor(step, dtype=torch.int32,
                                      device=self.device))

    def restore_or_init(self) -> int:
        """The latest checkpoint's train state if there is one (the
        pipeline's state stays in its metadata, as in the reference:
        ``pipeline.load_state_dict(ckpt.manifest()["metadata"]
        ["pipeline"])`` resumes the input), else `init_state`."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            st = self.ckpt.restore(self._astate, device=self.device)
            self._set_state(st.params, st.opt, int(st.step))
            return int(self.state.step)
        self.init_state()
        return 0

    # -- loop -----------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> List[Dict]:
        steps = steps or self.tcfg.steps
        if self.state is None:
            self.restore_or_init()
        start = int(self.state.step)
        for i in range(start, start + steps):
            t0 = time.monotonic()
            batch = next(self.pipeline)
            self.state, metrics = self.step_fn(self.state, batch)
            if (i + 1) % self.tcfg.log_every == 0 or i == start:
                rec = {"step": i + 1,
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]),
                       "wall_s": time.monotonic() - t0,
                       "data_locality": self.pipeline.locality_fractions}
                self.history.append(rec)
            if self.ckpt and (i + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(i + 1, self.state,
                               metadata={"pipeline":
                                         _np_to_list(
                                             self.pipeline.state_dict())})
        return self.history


def _np_to_list(v):
    """JSON-safe view of a pipeline state dict: numpy arrays and scalars
    become lists / plain Python numbers at every nesting level — the
    replication-lifecycle state is a dict of dicts, and json.dumps of the
    checkpoint manifest rejects any numpy type it meets."""
    if isinstance(v, dict):
        return {k: _np_to_list(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_np_to_list(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v
