from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    MLAConfig,
    ModelConfig,
    RGLRUConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
    shape_applicable,
)

ASSIGNED_ARCHS = (
    "mixtral-8x7b",
    "minicpm3-4b",
    "deepseek-moe-16b",
    "mamba2-2.7b",
    "qwen2-vl-2b",
    "gemma3-12b",
    "recurrentgemma-2b",
    "gemma-2b",
    "whisper-base",
    "gemma3-27b",
)

__all__ = [
    "ASSIGNED_ARCHS", "INPUT_SHAPES", "InputShape", "MLAConfig",
    "ModelConfig", "RGLRUConfig", "SSMConfig", "get_config", "list_archs",
    "register", "shape_applicable",
]
