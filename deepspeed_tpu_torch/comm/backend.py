"""Communication backend over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/backend.py`` (and of the reference's
``comm/torch.py`` ``TorchBackend``). The JAX package's backend is a host
control plane beside collectives that XLA compiles into the step; here the
backend owns the process group and the collectives themselves run through
it: NCCL when the tensors live on CUDA, gloo on the CPU.
"""

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


class TorchBackend:
    """The default process group of ``torch.distributed``. ``init_method``
    defaults to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``, as
    ``torchrun`` sets them); ``file://<path>`` shares a ``FileStore``. With
    NCCL each process binds ``cuda:(LOCAL_RANK % device count)`` first. An
    initialised default group is taken as it is."""

    def __init__(self, backend, init_method=None, rank=-1, world_size=-1, timeout=None):
        self.name = backend
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        if not dist.is_initialized():
            dist.init_process_group(backend=backend, init_method=init_method or "env://",
                                    rank=rank, world_size=world_size,
                                    timeout=timeout or DEFAULT_TIMEOUT)
        self.world_group = dist.group.WORLD
        self.world_rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.initialized = True

    def is_initialized(self):
        return self.initialized

    def destroy_process_group(self):
        if dist.is_initialized():
            dist.destroy_process_group()
        self.initialized = False
