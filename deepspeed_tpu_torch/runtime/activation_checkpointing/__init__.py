from . import checkpointing
from .checkpointing import (CheckpointFunction, checkpoint, checkpoint_name, configure,
                            get_cuda_rng_tracker, get_rng_tracker, is_configured,
                            model_parallel_rng_tracker_name, non_reentrant_checkpoint,
                            partition_activations_wrapper, reset, resolve_policy)
