"""CPU accelerator (tests and host runs, asked for with DS_ACCELERATOR=cpu).

Counterpart of ``deepspeed_tpu/accelerator/cpu_accelerator.py``: the same
surface on the host, with 'gloo' as the communication backend and the
process's memory for the memory statistics. The port's kernel wrappers
take their plain versions on CPU tensors.
"""

import torch

from .abstract_accelerator import DeepSpeedAccelerator

try:
    import psutil

    _PSUTIL = True
except ImportError:  # pragma: no cover
    _PSUTIL = False


class CPU_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"
        self._peak = 0

    # ---- Device APIs ----
    def is_synchronized_device(self):
        return True

    def device_name(self, device_index=None):
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def device(self, device_index=None):
        return torch.device("cpu")

    def set_device(self, device_index):
        pass

    def current_device(self):
        return 0

    def current_device_name(self):
        return "cpu"

    def device_count(self):
        return 1

    def global_device_count(self):
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.distributed.get_world_size()
        return 1

    def synchronize(self, device_index=None):
        pass

    # ---- RNG APIs ----
    def manual_seed(self, seed):
        torch.manual_seed(int(seed))

    def initial_seed(self):
        return torch.initial_seed()

    # ---- Memory management ----
    def empty_cache(self):
        pass

    def memory_allocated(self, device_index=None):
        rss = psutil.Process().memory_info().rss if _PSUTIL else 0
        self._peak = max(self._peak, rss)
        return rss

    def max_memory_allocated(self, device_index=None):
        return max(self._peak, self.memory_allocated(device_index))

    def reset_peak_memory_stats(self, device_index=None):
        self._peak = 0

    def memory_stats(self, device_index=None):
        return {"allocated_bytes.all.current": self.memory_allocated(device_index)}

    def total_memory(self, device_index=None):
        return psutil.virtual_memory().total if _PSUTIL else 0

    def available_memory(self, device_index=None):
        return psutil.virtual_memory().available if _PSUTIL else 0

    # ---- Data types ----
    def is_bf16_supported(self):
        return True

    def is_fp16_supported(self):
        return False

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.int8, torch.int32]

    # ---- Communication backend ----
    def communication_backend_name(self):
        return self._communication_backend_name

    # ---- Tracing ----
    def range_push(self, msg):
        pass

    def range_pop(self):
        pass

    # ---- Capabilities ----
    def is_available(self):
        return True

    # ---- Convenience ----
    def pin_memory(self, tensor):
        return tensor
