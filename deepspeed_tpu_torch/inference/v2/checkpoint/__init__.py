from .huggingface_engine import (HuggingFaceCheckpointEngine, build_hf_engine,
                                 convert_hf_state_dict, transformer_config_from_hf)
