"""Learning-rate decay + warm-up schedules as pure host-side functions.

A copy of ``yolo_continuous_tpu/ops/schedules.py`` (which imports nothing of
JAX), kept here so that the port imports nothing of the JAX package.
Parity targets in the reference:
- ``main/learningrate_scheduler.py:9-72``  DecayType + per-type lambda factories
- ``main/learningrate_scheduler.py:76-97`` epoch-stepped LambdaLR (lr = lrI * lf(epoch))
- ``main/warm_up.py:12-21``                per-iteration np.interp warm-up

The reference steps its scheduler once per epoch and, during warm-up epochs,
overrides per-iteration: biases ramp ``warmup_bias_lr -> lrI``, other params
``0 -> lrI``, momentum ``warmup_momentum -> momentum`` (``train.py:76-77``).
These are computed on the host per step (cheap scalars) and fed into the
train step as arguments (``train/train_loop.py::Trainer.train_step``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import Callable


class DecayType(Enum):
    NA = 0
    Linear = 1
    InverseTime = 2
    Exponential = 3
    Natural_Exponential = 4
    Cosine = 5

    @staticmethod
    def from_name(decay: str) -> "DecayType":
        # mirrors main/learningrate_scheduler.py:17-30 (unknown names -> NA)
        try:
            return DecayType[decay]
        except KeyError:
            return DecayType.NA


def decay_factor_fn(decay: DecayType, lr_final: float, epochs: int) -> Callable[[float], float]:
    """Per-epoch multiplicative factor lf(epoch); lr = lrI * lf(epoch).

    Formulas mirror ``main/learningrate_scheduler.py:33-72`` with
    ``y1=1, y2=lr_final`` as wired by ``get_lr_scheduler`` (``:76-97``).
    """
    y1, y2 = 1.0, float(lr_final)
    if decay == DecayType.Linear:
        # max(.,1): a 1-epoch plan divides by zero in the reference (:44)
        return lambda x: y2 - (y2 - y1) * (1.0 - x / max(epochs - 1, 1))
    if decay == DecayType.InverseTime:
        return lambda x: y2 - (y2 - y1) / (1 + 0.1 * x)
    if decay == DecayType.Exponential:
        return lambda x: y2 - (y2 - y1) * math.pow(0.96, x)
    if decay == DecayType.Natural_Exponential:
        return lambda x: y2 - (y2 - y1) * math.exp(-0.04 * x)
    if decay == DecayType.Cosine:
        return lambda x: y2 - (y2 - y1) * (1 + math.cos(x * math.pi / epochs)) / 2
    return lambda x: x  # NA: mirrors the reference's identity lambda (:33-37)


def _interp(x: float, x1: float, y0: float, y1: float) -> float:
    """np.interp over [0, x1] clamped, as used by main/warm_up.py:12-21."""
    if x <= 0:
        return y0
    if x >= x1:
        return y1
    return y0 + (y1 - y0) * (x / x1)


@dataclass(frozen=True)
class StepHyper:
    """Scalar hyper-params for one optimizer step (host-computed)."""
    lr_weights: float   # param groups 0 (BN) and 1 (weights); warm-up ramps 0 -> lrI
    lr_bias: float      # param group 2 (biases); warm-up ramps warmup_bias_lr -> lrI
    momentum: float


class LRSchedule:
    """Combined warm-up + epoch decay, matching train.py:63-102 semantics."""

    def __init__(
        self,
        lr_initial: float,
        lr_final: float,
        epochs: int,
        decay: str = "Linear",
        momentum: float = 0.937,
        warmup: bool = True,
        warmup_epochs: float = 3.0,
        warmup_max_iter: int = 1000,
        warmup_momentum: float = 0.8,
        warmup_bias_lr: float = 0.1,
        steps_per_epoch: int = 1,
    ):
        self.lr_initial = lr_initial
        self.momentum = momentum
        self.warmup = warmup
        self.warmup_epochs = warmup_epochs
        self.warmup_momentum = warmup_momentum
        self.warmup_bias_lr = warmup_bias_lr
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.epochs = max(int(epochs), 1)
        # train.py:59: limit = max(warmup_max_iter, iters_per_epoch * warmup_epochs)
        self.warmup_limit = max(warmup_max_iter, self.steps_per_epoch * warmup_epochs)
        self.lf = decay_factor_fn(DecayType.from_name(decay), lr_final, epochs)

    def epoch_lr(self, epoch: int) -> float:
        # clamp at the schedule's final value: past the last epoch the
        # reference's linear lambda goes NEGATIVE
        # (main/learningrate_scheduler.py:44) — a resumed/over-run step
        # count must never walk the lr off the schedule (deliberate fix).
        return self.lr_initial * self.lf(min(epoch, self.epochs - 1))

    def __call__(self, step: int) -> StepHyper:
        epoch = step // self.steps_per_epoch
        base = self.epoch_lr(epoch)
        # train.py:76-77 warm-up gate: epoch < warmup_epochs AND iter < limit.
        if self.warmup and epoch < self.warmup_epochs and step < self.warmup_limit:
            # main/warm_up.py:15-20 interpolates to the *initial* (undecayed) lr.
            return StepHyper(
                lr_weights=_interp(step, self.warmup_limit, 0.0, self.lr_initial),
                lr_bias=_interp(step, self.warmup_limit, self.warmup_bias_lr, self.lr_initial),
                momentum=_interp(step, self.warmup_limit, self.warmup_momentum, self.momentum),
            )
        return StepHyper(lr_weights=base, lr_bias=base, momentum=self.momentum)
