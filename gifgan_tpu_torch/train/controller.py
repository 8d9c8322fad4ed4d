"""Automated GAN-collapse intervention: the manual lever, closed-loop.

The port's own copy of gifgan_tpu/train/controller.py (pure Python; the
port imports nothing of the JAX package), with the same policy and numbers.
A saturated discriminator (d_loss -> 0) starves G; the manual fix was to
raise the instance noise mid-run. This policy does it from the per-chunk
d_loss the loop already logs, by setting the runtime knobs of
train/vid.py (Knobs: tensor scalars, so a new level takes the same code
path).

Policy (hysteresis state machine, acts at chunk granularity):

  - D is "saturated" when its loss sits below `d_floor` (a cleanly-separating
    D gives G no gradient signal: sigmoid-CE ~ 0). After `patience`
    consecutive saturated chunks, ESCALATE:
      1st rung: raise both instance-noise stds by `noise_step`
         (the measured-effective lever: the reference's own anti-collapse
         knob, z_model_lib.py:84,89, and the one that revived run 1);
      further rungs (noise already at `noise_max`): halve the D lr scale
         down to `d_lr_min` (TTUR direction — slow the winning network).
  - After an action, wait `cooldown` chunks before judging again (the
    effect takes time to reach the loss).
  - D is "healthy" when its loss sits above `recover`. After
    `recover_patience` consecutive healthy chunks, DE-ESCALATE one rung in
    reverse order (restore D lr first, then step noise back down toward the
    configured base) — interventions are scaffolding, not a new operating
    point; training should end as close to the configured recipe as the
    dynamics allow.

Pure host-side Python over scalars already fetched for logging; unit-tested
on synthetic loss traces in tests/test_torch_loops.py, against the JAX
package's controller.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    d_floor: float = 0.05        # d_loss below this = saturated D
    recover: float = 0.40        # d_loss above this = healthy D
    patience: int = 3            # consecutive saturated chunks before acting
    recover_patience: int = 20   # consecutive healthy chunks before easing
    cooldown: int = 10           # chunks to wait after any action
    noise_step: float = 0.1      # additive escalation of both noise stds
    noise_max: float = 0.5       # run-1's proven intervention level
    d_lr_factor: float = 0.5     # multiplicative D-lr de-escalation rung
    d_lr_min: float = 0.125


@dataclasses.dataclass
class CollapseController:
    """observe(d_loss) once per chunk -> current knob values (+ event)."""

    base_image_noise: float
    base_activation_noise: float
    config: ControllerConfig = ControllerConfig()

    # mutable policy state
    image_noise: float = dataclasses.field(init=False)
    activation_noise: float = dataclasses.field(init=False)
    d_lr_scale: float = dataclasses.field(init=False, default=1.0)
    _saturated: int = dataclasses.field(init=False, default=0)
    _healthy: int = dataclasses.field(init=False, default=0)
    _cooldown: int = dataclasses.field(init=False, default=0)

    def __post_init__(self):
        self.image_noise = float(self.base_image_noise)
        self.activation_noise = float(self.base_activation_noise)

    # -- knob accessors -------------------------------------------------
    def knob_values(self) -> dict:
        return {"image_noise_std": self.image_noise,
                "activation_noise_std": self.activation_noise,
                "d_lr_scale": self.d_lr_scale}

    @property
    def intervened(self) -> bool:
        return (self.d_lr_scale != 1.0
                or self.image_noise != self.base_image_noise
                or self.activation_noise != self.base_activation_noise)

    # -- policy ----------------------------------------------------------
    def observe(self, d_loss: float) -> Optional[dict]:
        """Feed one chunk's D loss; returns an event dict when the policy
        changed the knobs this chunk (for the run log), else None."""
        c = self.config
        if self._cooldown > 0:
            self._cooldown -= 1
            return None

        if d_loss < c.d_floor:
            self._saturated += 1
            self._healthy = 0
            if self._saturated >= c.patience:
                return self._escalate(d_loss)
        elif d_loss > c.recover:
            self._healthy += 1
            self._saturated = 0
            if self._healthy >= c.recover_patience and self.intervened:
                return self._deescalate(d_loss)
        else:
            self._saturated = 0
            self._healthy = 0
        return None

    def _acted(self, kind: str, d_loss: float) -> dict:
        self._saturated = 0
        self._healthy = 0
        self._cooldown = self.config.cooldown
        return {"kind": "auto_intervention", "action": kind,
                "d_loss": d_loss, **self.knob_values()}

    def _escalate(self, d_loss: float) -> Optional[dict]:
        c = self.config
        if self.image_noise < c.noise_max or \
                self.activation_noise < c.noise_max:
            # round: keep the knob ladder on clean values (0.1+0.2 drift
            # would make base-restoration comparisons and logs fuzzy)
            self.image_noise = round(
                min(self.image_noise + c.noise_step, c.noise_max), 6)
            self.activation_noise = round(
                min(self.activation_noise + c.noise_step, c.noise_max), 6)
            return self._acted("raise_noise", d_loss)
        if self.d_lr_scale > c.d_lr_min:
            self.d_lr_scale = max(self.d_lr_scale * c.d_lr_factor,
                                  c.d_lr_min)
            return self._acted("lower_d_lr", d_loss)
        # fully escalated: nothing left to do; keep counters reset so the
        # log isn't spammed every chunk
        self._saturated = 0
        return None

    def _deescalate(self, d_loss: float) -> dict:
        c = self.config
        if self.d_lr_scale < 1.0:
            self.d_lr_scale = min(self.d_lr_scale / c.d_lr_factor, 1.0)
            return self._acted("restore_d_lr", d_loss)
        self.image_noise = round(
            max(self.image_noise - c.noise_step, self.base_image_noise), 6)
        self.activation_noise = round(
            max(self.activation_noise - c.noise_step,
                self.base_activation_noise), 6)
        return self._acted("lower_noise", d_loss)
