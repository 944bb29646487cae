from vog_tpu_torch.config.defaults import (
    Cfg,
    DsCfg,
    MdlCfg,
    MiscCfg,
    TrainCfg,
    apply_matmul_precision,
    get_default_cfg,
    kernel_precision,
    post_proc_config,
    update_from_dict,
)

__all__ = [
    "Cfg",
    "DsCfg",
    "MdlCfg",
    "MiscCfg",
    "TrainCfg",
    "apply_matmul_precision",
    "get_default_cfg",
    "kernel_precision",
    "post_proc_config",
    "update_from_dict",
]
