"""Learning-rate schedules: pure functions of the step counter, as in
``repro.optim.schedules``. The step is an int or a 0-d tensor; the rate
comes back as a float32 0-d tensor on the step's device (the CPU for an
int)."""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, torch.Tensor]


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float) -> Callable[[Step], torch.Tensor]:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup_steps: int
                  ) -> Callable[[Step], torch.Tensor]:
    def fn(step: Step) -> torch.Tensor:
        s = _f32(step)
        return lr * torch.clamp_max((s + 1.0) / max(warmup_steps, 1), 1.0)
    return fn


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[Step], torch.Tensor]:
    def fn(step: Step) -> torch.Tensor:
        s = _f32(step)
        warm = torch.clamp_max((s + 1.0) / max(warmup_steps, 1), 1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return fn
