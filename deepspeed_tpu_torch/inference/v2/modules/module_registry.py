"""Implementation registries (counterpart of
``deepspeed_tpu/inference/v2/modules/module_registry.py``): each interface
owns a registry from implementation name to class, and
``resolve`` (which ``instantiate_config`` calls before construction) asks
the implementation's ``refusal``, so a bad config fails at engine build, naming what it misses."""

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, Type

from .ds_module import DSModuleBase, DSModuleConfig


@dataclass
class ConfigBundle:
    """A named implementation choice plus its configs."""
    name: str
    config: DSModuleConfig
    implementation_config: Dict[str, Any] = field(default_factory=dict)


class DSModuleRegistryBase(ABC):
    """Tracks the implementations of one functionality interface; subclasses
    declare their own ``registry: dict = {}``."""

    registry: Dict[str, Type[DSModuleBase]]

    @classmethod
    def resolve(cls, config_bundle: ConfigBundle) -> Type[DSModuleBase]:
        """The implementation class the bundle names, once it has taken the
        bundle's config; raises naming what it refuses."""
        if config_bundle.name not in cls.registry:
            raise KeyError(f"Unknown DSModule: {config_bundle.name!r}; "
                           f"known: {sorted(cls.registry)}")
        target = cls.registry[config_bundle.name]
        reason = target.refusal(config_bundle.config)
        if reason is not None:
            raise ValueError(f"Config {config_bundle.config} is not supported by "
                             f"{target.__name__}: {reason}")
        return target

    @classmethod
    def instantiate_config(cls, config_bundle: ConfigBundle) -> DSModuleBase:
        return cls.resolve(config_bundle)(config_bundle.config,
                                          config_bundle.implementation_config)

    @staticmethod
    @abstractmethod
    def associated_class() -> Type[DSModuleBase]:
        """The interface class whose implementations this registry tracks."""

    @classmethod
    def register_module(cls, child_class):
        if not issubclass(child_class, cls.associated_class()):
            raise TypeError(f"Can only register subclasses of "
                            f"{cls.associated_class().__name__}; got {child_class.__name__}")
        cls.registry[child_class.name()] = child_class
        return child_class
