"""DIPPM core on PyTorch: from an op-graph document to a prediction."""
from .ir import OpGraph, OpNode, OP_VOCAB, GraphValidationError
from .frontends import from_json, from_json_file
from .node_features import NODE_FEATURE_DIM, node_feature_matrix
from .static_features import STATIC_FEATURE_DIM, static_features
from .batching import (GraphSample, collate_packed, pack_graphs, pad_sample,
                       packed_rung_ladder, packed_shape, sample_from_graph)
from .gnn import (PMGNS, PMGNSConfig, decode_targets, encode_targets,
                  params_from_numpy, params_to_numpy, pmgns_infer,
                  pmgns_init)
from .mig import predict_mig, predict_pods, predict_tpu_slice
from .predictor import DIPPM, Prediction, make_prediction
from .engine import EngineConfig, EngineStats, PredictionEngine
