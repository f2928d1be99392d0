"""CUDA accelerator.

Counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py`` (and of
the reference's ``accelerator/cuda_accelerator.py``): the accelerator
surface over ``torch.cuda``: devices, memory statistics, the 'nccl'
communication backend, NVTX ranges for profiles, and op builders from the
port's registry. Building one without a CUDA card raises.
"""

import importlib.util

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA accelerator needs a CUDA card, and "
                               "torch.cuda.is_available() is False; set DS_ACCELERATOR=cpu to "
                               "run on the CPU")
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    # ---- Device APIs ----
    def is_synchronized_device(self):
        return False

    def device_name(self, device_index=None):
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def device(self, device_index=None):
        return torch.device("cuda", torch.cuda.current_device() if device_index is None
                            else device_index)

    def set_device(self, device_index):
        torch.cuda.set_device(device_index)

    def current_device(self):
        return torch.cuda.current_device()

    def current_device_name(self):
        return f"{self._name}:{torch.cuda.current_device()}"

    def device_count(self):
        return torch.cuda.device_count()

    def global_device_count(self):
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.distributed.get_world_size()
        return torch.cuda.device_count()

    def synchronize(self, device_index=None):
        torch.cuda.synchronize(device_index)

    # ---- RNG APIs ----
    def manual_seed(self, seed):
        torch.cuda.manual_seed(int(seed))

    def initial_seed(self):
        return torch.cuda.initial_seed()

    # ---- Memory management ----
    def empty_cache(self):
        torch.cuda.empty_cache()

    def memory_allocated(self, device_index=None):
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None):
        return torch.cuda.max_memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index=None):
        torch.cuda.reset_peak_memory_stats(device_index)

    def memory_stats(self, device_index=None):
        return torch.cuda.memory_stats(device_index)

    def total_memory(self, device_index=None):
        return torch.cuda.get_device_properties(self.device(device_index)).total_memory

    def available_memory(self, device_index=None):
        return torch.cuda.mem_get_info(self.device(device_index))[0]

    # ---- Data types ----
    def is_bf16_supported(self):
        return torch.cuda.is_bf16_supported()

    def is_fp16_supported(self):
        return True

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.int32]

    def preferred_dtype(self):
        return torch.bfloat16

    # ---- Communication backend ----
    def communication_backend_name(self):
        return self._communication_backend_name

    # ---- Tracing ----
    def range_push(self, msg):
        torch.cuda.nvtx.range_push(msg)

    def range_pop(self):
        torch.cuda.nvtx.range_pop()

    # ---- Capabilities ----
    def is_available(self):
        return torch.cuda.is_available()

    def is_triton_supported(self):
        return importlib.util.find_spec("triton") is not None

    # ---- Convenience ----
    def pin_memory(self, tensor):
        return tensor.pin_memory()
