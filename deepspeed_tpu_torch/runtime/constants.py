"""Config key constants (a copy of ``deepspeed_tpu/runtime/constants.py``).

The user-facing JSON key vocabulary of DeepSpeed, so that the same ds_config
JSON reaches both packages. Which keys the PyTorch port accepts is decided in
``runtime/config.py``: a key for something not ported yet raises.
"""

#############################################
# Batch-size triad (reference constants.py)
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
LION_OPTIMIZER = "lion"
ADAGRAD_OPTIMIZER = "adagrad"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
MUADAM_OPTIMIZER = "muadam"
MUADAMW_OPTIMIZER = "muadamw"
MUSGD_OPTIMIZER = "musgd"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, LAMB_OPTIMIZER, SGD_OPTIMIZER, LION_OPTIMIZER,
    ADAGRAD_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER
]

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
FP16_AUTO_CAST = "auto_cast"

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # legacy alias accepted by the reference
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False

PRECISION_DTYPE = "dtype"

#############################################
# Gradient clipping / misc training knobs
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False

GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

# block-sparse attention (reference config.py:289 get_sparse_attention): the
# raw block, turned into a SparsityConfig by ops.sparse_attention
SPARSE_ATTENTION = "sparse_attention"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"

#############################################
# Communication
#############################################
COMMUNICATION_DATA_TYPE = "communication_data_type"
COMMUNICATION_DATA_TYPE_DEFAULT = None
SEQ_PARALLEL_COMMUNICATION_DATA_TYPE = "seq_parallel_communication_data_type"
SEQ_PARALLEL_COMMUNICATION_DATA_TYPE_DEFAULT = "fp32"
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False

#############################################
# Activation checkpointing (remat on TPU)
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"

#############################################
# Monitoring
#############################################
TENSORBOARD = "tensorboard"
WANDB = "wandb"
CSV_MONITOR = "csv_monitor"

#############################################
# Profiling
#############################################
FLOPS_PROFILER = "flops_profiler"
COMMS_LOGGER = "comms_logger"

#############################################
# Data pipeline / efficiency
#############################################
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False

#############################################
# Pipeline / TPU-specific sections
#############################################
PIPELINE = "pipeline"
TPU = "tpu"  # TPU-native section: mesh axes, remat policy, donation

#############################################
# Checkpoint
#############################################
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False
USE_NODE_LOCAL_STORAGE_CHECKPOINT = "use_node_local_storage"
CHECKPOINT_PARALLEL_WRITE = "parallel_write"
CHECKPOINT_PARALLEL_WRITE_PIPELINE_STAGE = "pipeline_stage"

CHECKPOINT_TAG_VALIDATION = "checkpoint_tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]

#############################################
# Hybrid engine (reference runtime/hybrid_engine.py)
#############################################
HYBRID_ENGINE = "hybrid_engine"

#############################################
# Elasticity (reference elasticity/constants.py)
#############################################
ELASTICITY = "elasticity"

#############################################
# Autotuning
#############################################
AUTOTUNING = "autotuning"

#############################################
# Compression
#############################################
COMPRESSION_TRAINING = "compression_training"

#############################################
# Gradient-accumulation-boundary optimization
#############################################
GRAD_ACCUM_DTYPE = "grad_accum_dtype"

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"
