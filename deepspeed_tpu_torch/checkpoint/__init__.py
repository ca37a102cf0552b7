"""Checkpoints: the engine's files, the universal format both packages
read, the offline fp32 tools; ``from_jax`` and ``hf`` bring weights in."""

from .engine import CheckpointEngine, TorchCheckpointEngine  # noqa: F401
from .universal import (ds_to_universal,  # noqa: F401
                        load_universal_into_engine)
from .zero_to_fp32 import (  # noqa: F401
    convert_zero_checkpoint_to_fp32_state_dict, flatten_state_dict,
    get_fp32_state_dict_from_zero_checkpoint)
