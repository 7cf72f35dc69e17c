"""PMGNS training on PyTorch — the port of ``repro.train``: the trainer
and the accuracy harness (the Table 3/4 protocol)."""
from .accuracy import (AccuracyProtocol, evaluate_per_family, run_accuracy,
                       train_to_convergence)
from .gnn_trainer import TrainConfig, evaluate, predict_batch, train_pmgns
