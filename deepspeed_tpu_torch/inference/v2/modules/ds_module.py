"""DSModule base: the unit of the serving plane's extensibility.

Counterpart of ``deepspeed_tpu/inference/v2/modules/ds_module.py``. A module
is a host-side object built once at engine construction; it carries no
parameters of its own (they stay in the engine's parameter tree and flow
through the call), so swapping an implementation changes only the body of
the forward, never its signature.
"""

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Dict, Optional, Type


@dataclass
class DSModuleConfig:
    """Base class for per-interface module configs."""


class DSModuleBase(ABC):
    """Base class for all inference modules: abstract functionality
    interfaces inherit directly; concrete implementations inherit from an
    interface and are looked up by ``name()`` in its registry."""

    @staticmethod
    @abstractmethod
    def name() -> str:
        """Human-readable key used in inference configurations."""

    @staticmethod
    @abstractmethod
    def config_class() -> Type[DSModuleConfig]:
        """The config dataclass this interface consumes."""

    @staticmethod
    @abstractmethod
    def refusal(config: DSModuleConfig) -> Optional[str]:
        """Why this implementation cannot be instantiated for ``config``, or
        None if it can (the registry raises with this text)."""

    @classmethod
    def supports_config(cls, config: DSModuleConfig) -> bool:
        """Whether this implementation can be instantiated for ``config``."""
        return cls.refusal(config) is None

    def __init__(self, config: DSModuleConfig,
                 implementation_config: Optional[Dict[str, Any]] = None) -> None:
        self._config = config
        self._implementation_config = dict(implementation_config or {})

    @property
    def config(self):
        return self._config

    @property
    def implementation_config(self) -> Dict[str, Any]:
        return self._implementation_config
