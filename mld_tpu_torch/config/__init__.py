from .core import (
    Config,
    DatasetConfig,
    LossConfig,
    ModelConfig,
    SchedulerConfig,
    TrainConfig,
    config_to_dict,
    load_config,
    merge_dicts,
)

__all__ = [
    "Config", "DatasetConfig", "LossConfig", "ModelConfig",
    "SchedulerConfig", "TrainConfig", "config_to_dict", "load_config",
    "merge_dicts",
]
