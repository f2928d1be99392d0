"""Accelerator abstraction.

Counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py`` (the
reference's ``DeepSpeedAccelerator`` ABC): the capability groups (device
APIs, RNG, synchronization, memory stats, dtype support, communication
backend name, tracing ranges, the op-builder hook) over ``torch``. The JAX
package's PRNG-key methods (``rng_key``, ``split_rng_key``) and
``supports_pallas`` have no counterpart: the port seeds ``torch``
generators and has no Pallas kernels.

Both of the port's accelerators resolve op builders from one registry,
``deepspeed_tpu_torch.ops.op_registry``, so the op-builder hook is written
here once rather than left abstract.
"""

import abc
from abc import ABC


class DeepSpeedAccelerator(ABC):

    def __init__(self):
        self._name = None
        self._communication_backend_name = None

    # ---- Device APIs ----
    @abc.abstractmethod
    def is_synchronized_device(self):
        """True when kernels run synchronously with the host (CPU)."""
        ...

    @abc.abstractmethod
    def device_name(self, device_index=None):
        ...

    @abc.abstractmethod
    def device(self, device_index=None):
        """The ``torch.device`` for ``device_index`` (default: current)."""
        ...

    @abc.abstractmethod
    def set_device(self, device_index):
        ...

    @abc.abstractmethod
    def current_device(self):
        ...

    @abc.abstractmethod
    def current_device_name(self):
        ...

    @abc.abstractmethod
    def device_count(self):
        """Local device count."""
        ...

    @abc.abstractmethod
    def global_device_count(self):
        ...

    @abc.abstractmethod
    def synchronize(self, device_index=None):
        ...

    # ---- RNG APIs ----
    @abc.abstractmethod
    def manual_seed(self, seed):
        ...

    @abc.abstractmethod
    def initial_seed(self):
        ...

    # ---- Memory management ----
    @abc.abstractmethod
    def empty_cache(self):
        ...

    @abc.abstractmethod
    def memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def reset_peak_memory_stats(self, device_index=None):
        ...

    @abc.abstractmethod
    def memory_stats(self, device_index=None):
        ...

    @abc.abstractmethod
    def total_memory(self, device_index=None):
        ...

    @abc.abstractmethod
    def available_memory(self, device_index=None):
        ...

    # ---- Data types ----
    @abc.abstractmethod
    def is_bf16_supported(self):
        ...

    @abc.abstractmethod
    def is_fp16_supported(self):
        ...

    @abc.abstractmethod
    def supported_dtypes(self):
        ...

    # ---- Communication backend ----
    @abc.abstractmethod
    def communication_backend_name(self):
        """The ``torch.distributed`` backend: 'nccl' on CUDA, 'gloo' on
        the CPU."""
        ...

    # ---- Tracing / profiling ----
    @abc.abstractmethod
    def range_push(self, msg):
        ...

    @abc.abstractmethod
    def range_pop(self):
        ...

    # ---- Capability flags ----
    @abc.abstractmethod
    def is_available(self):
        ...

    def is_triton_supported(self):
        return False

    # ---- Op builder hook (reference abstract_accelerator.py:245-258) ----
    def op_builder_dir(self):
        return "deepspeed_tpu_torch.ops"

    def create_op_builder(self, class_name):
        # the registry holds ready builder handles, so "create" returns the
        # handle; a class (e.g. a user-registered builder type) is
        # instantiated
        builder = self.get_op_builder(class_name)
        return builder() if isinstance(builder, type) else builder

    def get_op_builder(self, class_name):
        from ..ops import op_registry

        return op_registry.get(class_name)
