from repro_torch.config.types import (
    ModelConfig,
    TrainConfig,
    ServeConfig,
    JaladConfig,
    DeviceProfile,
    TierPowerModel,
    CLOUD_1080TI,
    EDGE_TX2,
    EDGE_TK1,
    EDGE_SERVER_1060,
)
from repro_torch.config.registry import (
    register,
    get_config,
    list_archs,
    assigned_archs,
)

__all__ = [
    "ModelConfig",
    "TrainConfig",
    "ServeConfig",
    "JaladConfig",
    "DeviceProfile",
    "TierPowerModel",
    "CLOUD_1080TI",
    "EDGE_TX2",
    "EDGE_TK1",
    "EDGE_SERVER_1060",
    "register",
    "get_config",
    "list_archs",
    "assigned_archs",
]
