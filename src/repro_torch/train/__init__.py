"""PMGNS training on PyTorch — the port of ``repro.train`` (the accuracy
harness ``train/accuracy.py`` is not ported yet, ROADMAP A13c-3)."""
from .gnn_trainer import TrainConfig, evaluate, predict_batch, train_pmgns
