"""1-bit Adam (``deepspeed_tpu/runtime/fp16/onebit/adam.py``, the reference's
``runtime/fp16/onebit/adam.py`` ``OnebitAdam``).

Two phases: ``freeze_step`` warmup steps whose gradients are averaged
exactly, then the compression stage, where the gradient exchange over the
data group is the error-feedback 1-bit collective
(``runtime/comm/compressed.py``) and Adam runs on the compressed means.

As in the JAX package, this class is a policy the engine reads
(``DeepSpeedEngine._configure_onebit``): the engine runs the exchange in
its step and the update is the port's ``Adam``.
"""

from dataclasses import dataclass


@dataclass
class OnebitAdam:
    freeze_step: int = 100
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    cuda_aware: bool = False  # accepted for config parity; collectives go through comm
    comm_backend_name: str = "xla"  # the JAX package's default; the reference's is 'nccl'

    #: the optimizer the engine pairs with the compressed exchange
    base_optimizer = "adam"

    @classmethod
    def from_params(cls, params: dict):
        return cls(freeze_step=params.get("freeze_step", 100),
                   lr=params.get("lr", 1e-3),
                   betas=tuple(params.get("betas", (0.9, 0.999))),
                   eps=params.get("eps", 1e-8),
                   weight_decay=params.get("weight_decay", 0.0),
                   cuda_aware=params.get("cuda_aware", False),
                   comm_backend_name=params.get("comm_backend_name", "xla"))
