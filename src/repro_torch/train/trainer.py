"""Fault-tolerant training loop on one device (the port of
``repro.train.trainer``): gradient accumulation over microbatches,
periodic async checkpoints through ``checkpoint/ckpt.py``, resume from the
latest one, and simulated preemption for tests.

Parameters are float32 masters (``init_params(param_dtype=float32)``, as
JAX keeps them); the layers compute in ``cfg.dtype``, casting at use.  The
AdamW update runs in place under ``torch.no_grad()``.  JAX's ``mesh``
argument has no counterpart yet (ROADMAP item 11h).

Every step is a pure function of the state and the step's batch, so a run
resumed from a checkpoint repeats an uninterrupted one bit for bit as long
as the device's operations are deterministic.  On the CPU they are; the
flash attention and ssd_scan kernels use no atomics.  On a card, PyTorch
guarantees it only under ``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts); a resumed run on an
H100 was bit-identical with and without it (PERF.md, section 6).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..checkpoint import ckpt
from ..data.pipeline import DataConfig, batch_for_model, device_put_batch
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from .optimizer import AdamW, AdamWState, cosine_schedule, tree_map


def weight_decay_mask(params: dict) -> dict:
    """The leaves AdamW decays: JAX's rule, ``p.ndim >= 2``, read on JAX's
    layout, where every layer leaf carries a leading period axis.  So
    every layer leaf is decayed, its norm scales, biases and Mamba vectors
    included, and of the rest the matrices (embedding, head), not
    ``final_norm``."""
    return {k: tree_map(lambda p: True if k == "layers" else p.ndim >= 2, v)
            for k, v in params.items()}


class PreemptionError(RuntimeError):
    """Simulated SIGTERM from the cluster manager."""


@dataclass
class TrainerConfig:
    seq_len: int = 256
    global_batch: int = 8
    microbatches: int = 1          # gradient accumulation factor
    steps: int = 50
    ckpt_every: int = 20           # <= 0: no checkpoints (JAX: not allowed)
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    peak_lr: float = 3e-4
    warmup: int = 10
    log_every: int = 10
    preempt_at_step: int = -1      # fault injection (tests)
    data_seed: int = 0


@dataclass
class TrainState:
    params: dict
    opt_state: AdamWState
    step: int = 0
    metrics: dict = field(default_factory=dict)


class Trainer:
    """``Trainer(cfg, tcfg, device=None)``: ``None`` means the card and
    raises without one.  Every architecture trains on either device: the
    flash and ssd_scan kernels carry their gradients through hand-written
    backward kernels on a card."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        if tcfg.global_batch % tcfg.microbatches:
            raise ValueError(f"global_batch {tcfg.global_batch} does not "
                             f"split into {tcfg.microbatches} microbatches")
        self.optimizer = AdamW(schedule=cosine_schedule(
            tcfg.peak_lr, tcfg.warmup, tcfg.steps))
        self.dcfg = DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=tcfg.seq_len,
                               global_batch=tcfg.global_batch,
                               seed=tcfg.data_seed)
        self.checkpointer = ckpt.AsyncCheckpointer(tcfg.ckpt_dir,
                                                   keep=tcfg.ckpt_keep)

    # ------------------------------------------------------------------
    def loss_and_grad(self, params: dict, batch: dict, *,
                      use_kernels: bool = True):
        """(loss, grads) of ``M.loss_fn`` on one batch; a parameter the
        loss does not reach gets ``None``.  ``use_kernels=False`` runs the
        attention kernels' and the chunk scan's plain versions."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, _ = M.loss_fn(leaves, self.cfg, batch,
                                use_kernels=use_kernels)
            flat = []
            tree_map(flat.append, leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), leaves)

    def train_step(self, params: dict, opt_state: AdamWState, batch: dict):
        """One optimizer step on ``batch`` (JAX's ``train_step``): with
        ``microbatches`` > 1 the batch is split along dim 0, the gradients
        summed then divided, and the loss is the mean.  Returns (params,
        opt_state, {"loss", "lr", "grad_norm"}), params updated in
        place."""
        nmicro = self.tcfg.microbatches
        if nmicro == 1:
            loss, grads = self.loss_and_grad(params, batch)
        else:
            gsum = tree_map(torch.zeros_like, params)
            lsum = 0.0
            for i in range(nmicro):
                mb = {k: v.reshape(nmicro, v.shape[0] // nmicro,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss, g = self.loss_and_grad(params, mb)
                gsum = tree_map(lambda s, x: s if x is None else s + x,
                                gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / nmicro, gsum)
            loss = lsum / nmicro
        params, opt_state, om = self.optimizer.update(
            grads, opt_state, params, weight_decay_mask(params))
        return params, opt_state, {"loss": loss, **om}

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        params = M.init_params(self.cfg, seed, self.device,
                               param_dtype=torch.float32)
        return TrainState(params, self.optimizer.init(params), 0)

    def restore_latest(self) -> TrainState | None:
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return None
        abstract = M.init_abstract(self.cfg)
        like = {"params": abstract, "opt": self.optimizer.init(abstract)}
        restored = ckpt.restore(self.tcfg.ckpt_dir, step, like,
                                device=self.device)
        return TrainState(restored["params"], restored["opt"], step)

    # ------------------------------------------------------------------
    def run(self, state: TrainState | None = None,
            log=print) -> TrainState:
        """JAX's loop: preemption raised at ``preempt_at_step`` after the
        pending save lands; checkpoints every ``ckpt_every`` steps and at
        the last; the same log lines.  ``state.metrics`` gets
        ``loss_history`` and ``step_seconds`` (host clock a step, ending
        when the step's loss reaches the host)."""
        t = self.tcfg
        if state is None:
            state = self.restore_latest() or self.init_state()
            if state.step:
                log(f"[trainer] resumed from step {state.step}")
        history, seconds = [], []
        t0 = time.time()
        for step in range(state.step, t.steps):
            if step == t.preempt_at_step:
                self.checkpointer.wait()
                raise PreemptionError(f"simulated preemption at step {step}")
            t_step = time.perf_counter()
            batch = device_put_batch(
                batch_for_model(self.cfg, self.dcfg, step), self.device)
            state.params, state.opt_state, metrics = self.train_step(
                state.params, state.opt_state, batch)
            state.step = step + 1
            loss = float(metrics["loss"])
            seconds.append(time.perf_counter() - t_step)
            if t.ckpt_every > 0 and ((step + 1) % t.ckpt_every == 0
                                     or step + 1 == t.steps):
                self.checkpointer.save(
                    state.step,
                    {"params": state.params, "opt": state.opt_state},
                    extra={"loss": loss})
            if (step + 1) % t.log_every == 0 or step == state.step:
                log(f"[trainer] step {step+1}/{t.steps} "
                    f"loss={loss:.4f} "
                    f"lr={float(metrics['lr']):.2e} "
                    f"({(time.time()-t0)/(step-state.step+1+1e-9):.2f}s/step)")
            history.append(loss)
        self.checkpointer.wait()
        state.metrics = {"loss_history": history, "step_seconds": seconds}
        return state
