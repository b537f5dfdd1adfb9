"""Optimizers with optax's arithmetic (counterpart of
everyvoice_tpu/train/optim.py).

The JAX package trains with optax chains: ``adamw`` under a Noam schedule
by default, and ``adamw``, ``adam`` or ``rmsprop`` at a constant rate, each
after ``clip_by_global_norm`` when a clip value is given. ``Optimizer``
computes the same updates, which differ from ``torch.optim``'s:

- the schedule is evaluated at the count *before* the update, and Noam adds
  1 to it, so the first update uses ``noam(0)``;
- AdamW decays every parameter (biases, norms and embeddings too);
- the clip leaves gradients alone while their global norm is under the
  limit and otherwise scales them by ``limit / norm`` (no epsilon);
- RMSprop divides by ``sqrt(nu + eps)``, not ``sqrt(nu) + eps``.

Its state converts to and from the optax state's
``flax.serialization.to_state_dict`` layout, the moments keyed by the flax
parameter paths, so either package resumes from the other's checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

ADAM_KINDS = ("adam", "adamw", "noam")


def noam_schedule(base_lr: float, warmup_steps: int, model_dim: int = 256):
    """Noam learning rate at optax's pre-increment ``count`` (float32, as
    the JAX package computes it): linear warmup to ``base_lr`` at
    ``warmup_steps``, then inverse-square-root decay."""
    scale = np.float32(base_lr * warmup_steps**0.5)
    slope = np.float32(warmup_steps**-1.5)

    def schedule(count: int) -> float:
        step = np.float32(count + 1)  # 1-indexed to avoid 0^-0.5
        return float(scale * min(step ** np.float32(-0.5), step * slope))

    return schedule


def learning_rate_at(optimizer_config: dict, step: int, model_dim: int = 256) -> float:
    """The learning rate to log at ``step`` (host math)."""
    cfg = optimizer_config
    if cfg["name"] == "noam":
        s = step + 1
        scale = cfg["learning_rate"] * (cfg["warmup_steps"] ** 0.5)
        return float(scale * min(s**-0.5, s * cfg["warmup_steps"] ** -1.5))
    return float(cfg.get("learning_rate") or cfg.get("lr", 0.0))


def global_norm_of(names: list, grads: list, global_norm=None) -> torch.Tensor:
    """The global norm of ``grads``: over these tensors, or through
    ``global_norm`` (local norms by name → the norm over the whole
    parameters) where they are shards."""
    norms = torch._foreach_norm(grads)
    if global_norm is None:
        return torch.sqrt(torch.stack(norms).square().sum())
    return global_norm(dict(zip(names, norms)))


def build_optimizer(optimizer_config: dict, model_dim: int = 256,
                    gradient_clip_val: float | None = None) -> "Optimizer":
    """The optimizer an optimizer config section names (noam, adamw, adam or
    rms), after a global-norm clip when ``gradient_clip_val`` > 0."""
    return Optimizer(optimizer_config, model_dim, gradient_clip_val)


class Optimizer:
    """optax's update over a dict of named float32 parameters, in place.

    State: ``count`` (the Adam step count), ``schedule_count`` (Noam's
    count), and ``mu``/``nu`` dicts of moments keyed like the parameters."""

    def __init__(self, config: dict, model_dim: int = 256, gradient_clip_val=None):
        self.kind = config["name"]
        if self.kind not in ADAM_KINDS + ("rms",):
            raise ValueError(f"Unknown optimizer config: {self.kind!r}")
        self.config = config
        self.clip = gradient_clip_val if gradient_clip_val and gradient_clip_val > 0 else None
        self.schedule = (noam_schedule(config["learning_rate"], config["warmup_steps"], model_dim)
                         if self.kind == "noam" else None)

    def init(self, params: dict) -> dict:
        state = {"count": 0, "schedule_count": 0}
        if self.kind in ADAM_KINDS:
            state["mu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        state["nu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    def learning_rate(self, state: dict) -> float:
        if self.schedule is not None:
            return self.schedule(state["schedule_count"])
        return float(np.float32(self.config["learning_rate"]))

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict, global_norm=None) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads`` (a missing
        gradient counts as zeros, as optax sees it); returns the global norm
        of the gradients before the clip. Where the parameters are shards,
        ``global_norm`` maps each leaf's local norm (by name) to the norm
        over the whole parameters (``Placement.global_norm``)."""
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] if grads.get(n) is not None else torch.zeros_like(params[n])
             for n in names]
        norm = global_norm_of(names, g, global_norm)
        if self.clip is not None:
            factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            g = torch._foreach_mul(g, factor)
        cfg = self.config
        nu = [state["nu"][n] for n in names]
        if self.kind in ADAM_KINDS:
            b1, b2 = (float(b) for b in cfg["betas"])
            mu = [state["mu"][n] for n in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            state["count"] += 1
            count = np.float32(state["count"])
            bc1 = float(np.float32(1) - np.float32(b1) ** count)
            bc2 = float(np.float32(1) - np.float32(b2) ** count)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, float(cfg["eps"]))
            updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if self.kind in ("adamw", "noam"):
                torch._foreach_add_(updates, p, alpha=float(cfg["weight_decay"]))
        else:
            decay = float(cfg["alpha"])
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, g, g, value=1 - decay)
            scaling = torch._foreach_add(nu, float(cfg["eps"]))
            torch._foreach_rsqrt_(scaling)
            updates = torch._foreach_mul(g, scaling)
        lr = self.learning_rate(state)
        if self.schedule is not None:
            state["schedule_count"] += 1
        torch._foreach_add_(p, updates, alpha=-lr)
        return norm

    def to_optax(self, state: dict, to_flax) -> dict:
        """The optax state's ``to_state_dict`` layout; ``to_flax`` maps a
        dict of named tensors to a flax tree."""
        if self.kind in ADAM_KINDS:
            adam = {"count": np.asarray(state["count"], np.int32),
                    "mu": to_flax(state["mu"]), "nu": to_flax(state["nu"])}
            tail = {"noam": {"2": {"count": np.asarray(state["schedule_count"], np.int32)}},
                    "adamw": {"2": {}}, "adam": {}}[self.kind]
            base = {"0": adam, "1": {}, **tail}
        else:
            base = {"0": {"nu": to_flax(state["nu"])}, "1": {}, "2": {}}
        return {"0": {}, "1": base} if self.clip is not None else base

    def from_optax(self, tree: dict, from_flax) -> dict:
        """Inverse of ``to_optax``; ``from_flax`` maps a flax tree to a dict
        of named tensors."""
        base = tree["1"] if self.clip is not None else tree
        state = {"count": 0, "schedule_count": 0}
        if self.kind in ADAM_KINDS:
            adam = base["0"]
            state["count"] = int(np.asarray(adam["count"]))
            state["mu"] = from_flax(adam["mu"])
            state["nu"] = from_flax(adam["nu"])
            if self.kind == "noam":
                state["schedule_count"] = int(np.asarray(base["2"]["count"]))
        else:
            state["nu"] = from_flax(base["0"]["nu"])
        return state
