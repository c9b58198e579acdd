"""Architecture registry: --arch <id> resolves here.  The port's copy of
``repro.configs``: every architecture's name is known, also those whose
model kind the port does not build yet (``models.registry`` raises
``NotImplementedError`` for them)."""
from repro_torch.configs import (chameleon_34b, command_r_35b,
                                 command_r_plus_104b, deepseek_67b,
                                 deepseek_v3_671b, minicpm_2b, mixtral_8x7b,
                                 recurrentgemma_9b, seamless_m4t_large_v2,
                                 xlstm_125m)
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      RecurrentConfig, XLSTMConfig)
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, grid_cells,
                                        shape_applicable)

_MODULES = {
    "command-r-35b": command_r_35b,
    "command-r-plus-104b": command_r_plus_104b,
    "deepseek-67b": deepseek_67b,
    "minicpm-2b": minicpm_2b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mixtral-8x7b": mixtral_8x7b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "xlstm-125m": xlstm_125m,
    "chameleon-34b": chameleon_34b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
}

ARCHS = {name: m.CONFIG for name, m in _MODULES.items()}
SMOKE_ARCHS = {name: m.SMOKE_CONFIG for name, m in _MODULES.items()}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_ARCHS if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(table)}")
    return table[arch]


__all__ = ["ARCHS", "SMOKE_ARCHS", "get_config", "ModelConfig", "MoEConfig",
           "MLAConfig", "RecurrentConfig", "XLSTMConfig", "SHAPES",
           "ShapeSpec", "grid_cells", "shape_applicable"]
