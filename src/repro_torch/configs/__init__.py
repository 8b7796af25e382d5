"""Architecture configs. Importing this package registers every config."""
from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig, SSMConfig,
                                RecurrentConfig, FrontendConfig,
                                get_config, list_configs, register)

# Assigned architectures (side-effect registration).
from repro_torch.configs import deepseek_v2_lite_16b  # noqa: F401
from repro_torch.configs import mixtral_8x7b          # noqa: F401
from repro_torch.configs import qwen1_5_32b           # noqa: F401
from repro_torch.configs import phi3_medium_14b       # noqa: F401
from repro_torch.configs import qwen3_4b              # noqa: F401
from repro_torch.configs import qwen2_5_32b           # noqa: F401
from repro_torch.configs import whisper_large_v3      # noqa: F401
from repro_torch.configs import recurrentgemma_9b     # noqa: F401
from repro_torch.configs import internvl2_2b          # noqa: F401
from repro_torch.configs import mamba2_370m           # noqa: F401
# The paper's own experimental model.
from repro_torch.configs import llama2_7b             # noqa: F401

ASSIGNED = [
    "deepseek-v2-lite-16b", "mixtral-8x7b", "qwen1.5-32b", "phi3-medium-14b",
    "qwen3-4b", "qwen2.5-32b", "whisper-large-v3", "recurrentgemma-9b",
    "internvl2-2b", "mamba2-370m",
]

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "RecurrentConfig", "FrontendConfig", "get_config", "list_configs",
           "register", "ASSIGNED"]
