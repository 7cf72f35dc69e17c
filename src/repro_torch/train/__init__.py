"""PMGNS training on PyTorch — the port of ``repro.train`` (the accuracy
harness ``train/accuracy.py`` comes with the graph sources, ROADMAP A13)."""
from .gnn_trainer import TrainConfig, evaluate, predict_batch, train_pmgns
