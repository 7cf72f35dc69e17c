"""Optimizers and learning-rate schedules over parameter trees."""
from .optimizers import (OptState, Optimizer, adafactor, adam, adamw,
                         clip_by_global_norm, sgd)
from .schedules import constant, cosine_warmup, linear_warmup
