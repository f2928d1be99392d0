"""PyTorch port: the accelerator and op-builder layer.

``get_accelerator()`` reads ``DS_ACCELERATOR`` (``cuda`` or ``cpu``);
without it the accelerator is CUDA, and with no card that raises: the
port has no silent fall to the CPU (the JAX package's auto-detection does
fall back). Every builder name of the port's ``op_registry`` resolves and
loads, as ``tests/test_mesh_groups.py::test_accelerator_create_op_builder``
checks for the JAX package; an unknown name gives None. Each test resets
the accelerator singleton, so no state leaks into other test files.
"""

import pytest
import torch

from deepspeed_tpu.ops import op_registry as jax_registry
from deepspeed_tpu_torch.accelerator import (DeepSpeedAccelerator, get_accelerator,
                                             is_current_accelerator_supported, real_accelerator,
                                             set_accelerator)
from deepspeed_tpu_torch.accelerator.cpu_accelerator import CPU_Accelerator
from deepspeed_tpu_torch.accelerator.cuda_accelerator import CUDA_Accelerator
from deepspeed_tpu_torch.ops import evoformer_attention, op_registry


@pytest.fixture(autouse=True)
def _fresh_singleton(monkeypatch):
    monkeypatch.setattr(real_accelerator, "ds_accelerator", None)
    yield


def test_ds_accelerator_cpu(monkeypatch):
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    acc = get_accelerator()
    assert isinstance(acc, CPU_Accelerator) and acc is get_accelerator()
    assert acc.device_name() == "cpu" and acc.device() == torch.device("cpu")
    assert acc.communication_backend_name() == "gloo"
    assert acc.is_available() and acc.is_synchronized_device() and acc.device_count() == 1
    assert is_current_accelerator_supported()
    assert acc.memory_allocated() >= 0 and acc.max_memory_allocated() >= acc.memory_allocated()
    acc.range_push("x")
    acc.range_pop()
    acc.manual_seed(3)
    assert acc.initial_seed() == 3


def test_unknown_accelerator_name_raises(monkeypatch):
    monkeypatch.setenv("DS_ACCELERATOR", "tpu")
    with pytest.raises(ValueError, match="not supported"):
        get_accelerator()
    assert real_accelerator.ds_accelerator is None


@pytest.mark.parametrize("env", [None, "cuda"])
def test_cuda_without_a_card_raises(monkeypatch, env):
    """No variable (or ``cuda``) and no card: raises, never the CPU."""
    if env is None:
        monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    else:
        monkeypatch.setenv("DS_ACCELERATOR", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="DS_ACCELERATOR=cpu"):
        get_accelerator()
    assert real_accelerator.ds_accelerator is None
    with pytest.raises(RuntimeError):
        CUDA_Accelerator()


def test_set_accelerator_validates():
    with pytest.raises(TypeError, match="not a subclass"):
        set_accelerator(object())
    assert real_accelerator.ds_accelerator is None
    acc = CPU_Accelerator()
    set_accelerator(acc)
    assert get_accelerator() is acc and isinstance(acc, DeepSpeedAccelerator)


def test_create_op_builder_resolves_every_registry_name(monkeypatch):
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    acc = get_accelerator()
    assert acc.op_builder_dir() == "deepspeed_tpu_torch.ops"
    # the port registers only ops it has, under the JAX registry's names
    assert set(op_registry) <= set(jax_registry) and len(op_registry) == 16
    for name in op_registry:
        b = acc.create_op_builder(name)
        assert b is not None and b.is_compatible(), name
        assert b.load() is not None
        assert b.load().__name__.startswith("deepspeed_tpu_torch."), name
        assert acc.get_op_builder(name) is b
    assert acc.create_op_builder("NoSuchBuilder") is None
    # names of the JAX registry the port has not ported yet resolve to None
    for name in set(jax_registry) - set(op_registry):
        assert acc.create_op_builder(name) is None, name


def test_evoformer_builder_loads_the_port_module(monkeypatch):
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    b = get_accelerator().create_op_builder("EvoformerAttnBuilder")
    assert b.NAME == "evoformer_attn"
    assert b.load() is evoformer_attention and hasattr(b.load(), "evo_flash")
