"""Optimizers and learning-rate schedules over parameter trees."""
from .optimizers import (OptState, Optimizer, adam, adamw,
                         clip_by_global_norm)
from .schedules import constant, cosine_warmup, linear_warmup
