"""Config block utilities, without pydantic.

Counterpart of ``deepspeed_tpu/runtime/config_utils.py``. A config block is
a dataclass; :func:`from_dict` builds one from its JSON dict. As in the JAX
package, a value of ``"auto"`` means "the default". Unlike it, a key the
port does not know raises and names the key: an unported feature is never
accepted and then silently ignored.
"""

import dataclasses
from typing import Any, Dict


class DeepSpeedConfigError(Exception):
    pass


def from_dict(cls, data: Dict[str, Any], where: str, aliases: Dict[str, str] = None):
    """``cls(**data)`` for a dataclass ``cls``, with ``"auto"`` values
    dropped, ``aliases`` renamed (JSON name -> field), and unknown keys
    refused by name (``where`` is the block's JSON path)."""
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise DeepSpeedConfigError(f"'{where}' must be a JSON object, got {type(data).__name__}")
    aliases = aliases or {}
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for key, value in data.items():
        name = aliases.get(key, key)
        if name not in fields:
            raise DeepSpeedConfigError(f"'{where}.{key}' is not supported by the PyTorch port "
                                       f"(known keys: {sorted(fields)})")
        if value != "auto":
            kw[name] = value
    return cls(**kw)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys when parsing JSON (the reference's behaviour)."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d
