"""JSON-config helpers.

Behavioral parity with the reference's config helpers
(`unet3d/utils/utils.py:14-21,159-168` and `unet3d/scripts/script_utils.py:31-38`):
every config section is ``{"name": ClassName, ...kwargs}``; ``get_kwargs`` strips the
``name`` key (plus any caller-specified keys) and returns the rest.
"""
from __future__ import annotations

import json
import logging
from typing import Any, Iterable, Mapping


def load_json(filename: str) -> Any:
    with open(filename, "r") as f:
        return json.load(f)


def dump_json(obj: Any, filename: str) -> None:
    with open(filename, "w") as f:
        json.dump(obj, f, indent=4)


def get_class_name(section: Mapping[str, Any]) -> str:
    """Return the ``name`` entry of a config section."""
    return section["name"]


def get_kwargs(section: Mapping[str, Any], skip_keys: Iterable[str] = ("name",)) -> dict:
    """Everything in a config section except ``name`` (and ``skip_keys``) is kwargs."""
    skip = set(skip_keys)
    skip.add("name")
    return {k: v for k, v in section.items() if k not in skip}


def in_config(key: str, dictionary: Mapping[str, Any], if_not_in_config_return=None):
    """Lookup with logged default, mirroring reference `script_utils.in_config`."""
    if key in dictionary:
        value = dictionary[key]
        logging.debug("Found value '%s' for key '%s'", value, key)
    else:
        value = if_not_in_config_return
        logging.debug("Could not find value for key '%s'; default to %s", key, value)
    return value
