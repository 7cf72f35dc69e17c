"""Graph datasets of the port: the traced-zoo builder, the v1 storage
format and synthetic samples."""
from .builder import (DATASET_VERSION, DatasetBuildResult, DatasetRecord,
                      SkipRecord, build_dataset, load_dataset,
                      record_fingerprint, records_to_samples, save_dataset,
                      split_assignment, split_dataset, synthetic_samples)
