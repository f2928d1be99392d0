"""Accelerator selection.

Counterpart of ``deepspeed_tpu/accelerator/real_accelerator.py`` (the
reference's ``accelerator/real_accelerator.py:51-179``): a
``get_accelerator()`` singleton and ``set_accelerator()`` for injection.
``DS_ACCELERATOR`` (the reference's variable) names ``cuda`` or ``cpu``.
Without it the accelerator is CUDA, and with no card that raises: there is
no auto-detection that falls back to the CPU.
"""

import os

SUPPORTED_ACCELERATOR_LIST = ["cuda", "cpu"]

ds_accelerator = None


def _validate_accelerator(accel_obj):
    from .abstract_accelerator import DeepSpeedAccelerator

    if not isinstance(accel_obj, DeepSpeedAccelerator):
        raise TypeError(f"{accel_obj.__class__.__name__} accelerator is not a subclass of "
                        f"DeepSpeedAccelerator")


def is_current_accelerator_supported():
    return get_accelerator().device_name() in SUPPORTED_ACCELERATOR_LIST


def get_accelerator():
    global ds_accelerator
    if ds_accelerator is not None:
        return ds_accelerator

    accelerator_name = os.environ.get("DS_ACCELERATOR", "cuda")
    if accelerator_name not in SUPPORTED_ACCELERATOR_LIST:
        raise ValueError(f"accelerator_name {accelerator_name} value is not supported. "
                         f"Supported list: {SUPPORTED_ACCELERATOR_LIST}")
    if accelerator_name == "cuda":
        from .cuda_accelerator import CUDA_Accelerator

        accel = CUDA_Accelerator()  # raises without a card
    else:
        from .cpu_accelerator import CPU_Accelerator

        accel = CPU_Accelerator()
    _validate_accelerator(accel)
    ds_accelerator = accel
    return ds_accelerator


def set_accelerator(accel_obj):
    global ds_accelerator
    _validate_accelerator(accel_obj)
    ds_accelerator = accel_obj
