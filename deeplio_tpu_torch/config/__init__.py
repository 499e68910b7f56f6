from deeplio_tpu_torch.config.loader import load_config, load_config_dict
from deeplio_tpu_torch.config.schema import (
    Config,
    ConfigError,
    DatasetConfig,
    FusionConfig,
    ImuFeatConfig,
    LidarFeatConfig,
    LossConfig,
    ModelConfig,
    OdomFeatConfig,
    OptimConfig,
    ProjectionConfig,
    TrainConfig,
)
