"""Graph datasets of the port: the traced-zoo builder, the v1 storage
format, the sharded v2 factory and synthetic samples."""
from .builder import (DATASET_VERSION, DatasetBuildResult, DatasetRecord,
                      SkipRecord, build_dataset, load_dataset,
                      record_fingerprint, records_to_samples, save_dataset,
                      split_assignment, split_dataset, synthetic_samples)
from .factory import (FACTORY_VERSION, FactoryBuildResult, FactoryConfig,
                      FactoryPlan, PlanMismatchError, build, iter_records,
                      load_factory_dataset, make_plan, plan_hash,
                      read_manifest, read_plan)
