"""The JAX package's optimizer on tensor lists (counterpart of
``sequitr_tpu.pipeline.train.TrainConfig.make_optimizer``).

optax's chain, op for op, in plain PyTorch: ``clip_by_global_norm`` (left
alone below the limit, ``g / norm * max`` at or above it: not
``torch.nn.utils.clip_grad_norm_``'s ``max / (norm + 1e-6)``), ``adam`` or
``adamw`` (b2 = 0.999, eps = 1e-8, bias correction by the update count),
the learning rate as a constant or a ``join_schedules`` of a linear warmup
and a cosine or exponential decay (counted in applied updates from 0), and
``MultiSteps`` for gradient accumulation (a running mean of ``k``
micro-step gradients, the update applied on the k-th; parameters are left
untouched on the others). Parameters are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "OptState",
    "Optimizer",
    "flatten",
    "unflatten",
    "constant_schedule",
    "linear_schedule",
    "cosine_decay_schedule",
    "exponential_decay",
    "join_schedules",
]

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count):
        if count <= 0:
            return init_value
        return init_value * decay_rate ** (count / transition_steps)

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' elements end to end in one f32 vector (each tensor in
    its logical, row-major order)."""
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of ``flat`` shaped as ``like`` (``flatten``'s inverse)."""
    out, start = [], 0
    for t in like:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


@dataclasses.dataclass
class OptState:
    """``count``: updates applied (the Adam and schedule counts of optax's
    chain); ``mu``/``nu``: Adam's moments of every parameter, ``flatten``ed
    into one vector each; ``mini_step``/``acc``: ``MultiSteps``' position in
    the accumulation window and its running mean of gradients (``acc``
    None without accumulation)."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    mini_step: int = 0
    acc: Optional[torch.Tensor] = None

    def state_dict(self) -> dict:
        return {
            "count": self.count, "mu": self.mu, "nu": self.nu,
            "mini_step": self.mini_step, "acc": self.acc,
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        self.mu.copy_(sd["mu"])
        self.nu.copy_(sd["nu"])
        if self.acc is not None:
            self.acc.copy_(sd["acc"])


def _f32(x: float) -> np.float32:
    return np.float32(x)


class Optimizer:
    """``clip_by_global_norm`` -> ``adam``/``adamw`` -> ``MultiSteps``.

    The arithmetic runs on one flat vector of all gradients (a dozen
    launches a step), in optax's order of operations."""

    def __init__(
        self,
        learning_rate: Union[float, Schedule],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        grad_clip: Optional[float] = None,
        grad_accum: int = 1,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.grad_accum = grad_accum

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        zeros = lambda: torch.zeros(n, dtype=torch.float32, device=dev)
        return OptState(0, zeros(), zeros(), 0, zeros() if self.grad_accum > 1 else None)

    def lr(self, count: int) -> float:
        """The learning rate of update ``count`` (from 0)."""
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    @torch.no_grad()
    def update(
        self,
        params: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
        state: OptState,
        grad_norm: Optional[torch.Tensor] = None,
    ) -> bool:
        """One micro-step: accumulate ``grads`` (with ``grad_accum`` > 1) or
        apply them to ``params`` in place. ``grad_norm``: ``global_norm(grads)``
        when the caller has it already. Returns whether an update was
        applied."""
        norm = grad_norm
        g = flatten(grads)
        if state.acc is not None:
            n = state.mini_step
            # Welford running mean, as optax.MultiSteps: acc + (g - acc) / (n + 1)
            new_acc = state.acc + (g - state.acc) / torch.tensor(float(n + 1), device=g.device)
            if n < self.grad_accum - 1:
                state.acc.copy_(new_acc)
                state.mini_step = n + 1
                return False
            g = new_acc
            norm = None  # the clip sees the mean of the window
            state.acc.zero_()
            state.mini_step = 0
        self._apply(list(params), g, norm, state)
        return True

    def _apply(self, params, g: torch.Tensor, norm: torch.Tensor, state: OptState) -> None:
        # a division by a host scalar may run as a multiplication by its
        # reciprocal: every quotient here divides tensor by tensor
        dev = g.device
        if self.grad_clip:
            if norm is None:
                norm = global_norm(unflatten(g, params))
            # selected on the device: no host sync
            g = torch.where(norm < self.grad_clip, g, (g / norm) * self.grad_clip)
        b1, b2 = self.b1, self.b2
        state.mu.mul_(b1).add_((1 - b1) * g)
        state.nu.mul_(b2).add_((1 - b2) * (g * g))
        count = state.count + 1
        bc1 = torch.tensor(_f32(1) - _f32(b1) ** _f32(count), device=dev)
        bc2 = torch.tensor(_f32(1) - _f32(b2) ** _f32(count), device=dev)
        upd = (state.mu / bc1) / (torch.sqrt(state.nu / bc2) + self.eps)
        if self.weight_decay:
            upd = upd + self.weight_decay * flatten(params)
        upd = upd * float(-_f32(self.lr(state.count)))
        torch._foreach_add_(params, unflatten(upd, params))
        state.count = count


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum over tensors of each
    tensor's sum of squares (f32), the reference's order of summation: the
    clip scales every gradient by it, and Adam turns a last-bit change of a
    gradient into a visible one where its moment nearly cancels."""
    return torch.sqrt(sum((t.to(torch.float32) * t.to(torch.float32)).sum() for t in tensors))
