from petr_tpu_torch.configs.config import (
    BackboneConfig,
    DataConfig,
    HeadConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    ExperimentConfig,
    apply_overrides,
    eval_model_config,
    get_config,
    list_configs,
)
