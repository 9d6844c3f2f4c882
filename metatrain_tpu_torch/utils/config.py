"""Options loading, expansion and validation, in plain Python.

Counterpart of ``metatrain_tpu/utils/config.py`` without pydantic (the
machine with the card has neither pydantic nor PyYAML): the same
defaults, the same expansion of shorthands (a bare string dataset section
becomes ``{systems: {read_from: ...}}``, a target section gets
quantity/key/unit defaults, ``forces: on`` becomes ``{key: "forces"}``)
and a :class:`MetatrainConfigError` for the same mistakes. JSON is YAML
too: ``load_options`` reads a ``.json`` file, and a ``-r key=value``
override whose value is JSON, with the standard library; other files and
values need PyYAML, imported only then. The expanded options are saved as
JSON.
"""

from __future__ import annotations

import copy
import difflib
import json
import re
from pathlib import Path
from typing import Any, Dict, Optional, Union

BASE_OPTIONS: Dict[str, Any] = {
    "device": "auto",
    "base_precision": 32,
    "seed": 0,
    "wandb": None,
}

_TOP_LEVEL = ("architecture", "training_set", "validation_set", "test_set",
              "device", "base_precision", "seed", "wandb")
_ARCHITECTURE_KEYS = ("name", "model", "training")


class MetatrainConfigError(ValueError):
    """User-facing configuration error."""


def _needs_yaml(what: str) -> MetatrainConfigError:
    return MetatrainConfigError(
        f"{what} is not JSON and reading it needs PyYAML, which is not installed; "
        "write it as JSON (a .json options file, a JSON override value such as '\"cpu\"')"
    )


def read_mapping_file(path: Union[str, Path]) -> Any:
    """A ``.json`` file through ``json``; any other through PyYAML, or
    through ``json`` where PyYAML is missing and the text is JSON."""
    text = Path(path).read_text()
    if str(path).endswith(".json"):
        return json.loads(text)
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except ValueError:
            raise _needs_yaml(f"options file {path}") from None
    return yaml.safe_load(text)


def parse_override_value(value: str) -> Any:
    """The value of a ``-r key=value`` override: JSON through ``json``,
    anything else through PyYAML."""
    try:
        return json.loads(value)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError:
        raise _needs_yaml(f"override value {value!r}") from None
    return yaml.safe_load(value)


def load_options(path: Union[str, Path]) -> Dict[str, Any]:
    """Read an options file (JSON or YAML) and resolve its interpolations."""
    options = read_mapping_file(path)
    if not isinstance(options, dict):
        raise MetatrainConfigError(f"options file {path} is not a mapping")
    return resolve_interpolations(options)


#: function-style ``${name:}`` resolvers
_RESOLVERS = {
    "default_device": lambda: "auto",
    "default_precision": lambda: 32,
    "default_random_seed": lambda: 0,
}

_INTERP_RE = re.compile(r"^\$\{([A-Za-z0-9_.:]+)\}$")
_INTERP_INLINE_RE = re.compile(r"\$\{([A-Za-z0-9_.:]+)\}")


def resolve_interpolations(options: Dict[str, Any]) -> Dict[str, Any]:
    """OmegaConf-style ``${...}`` interpolation over the options tree:
    ``${dotted.path}`` references another key of the same file (absolute
    from the root), and ``${resolver:}`` invokes a registered resolver.
    Whole-string interpolations keep the referenced value's type; embedded
    ones stringify. Cycles are reported as errors."""

    def lookup(path: str, stack):
        if ":" in path:
            name = path.split(":", 1)[0]
            if name not in _RESOLVERS:
                raise MetatrainConfigError(
                    f"unknown config resolver '${{{path}}}' (available: {sorted(_RESOLVERS)})"
                )
            return _RESOLVERS[name]()
        if path in stack:
            raise MetatrainConfigError(f"circular config interpolation through '${{{path}}}'")
        node: Any = options
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise MetatrainConfigError(f"config interpolation '${{{path}}}' not found")
            node = node[part]
        return resolve(node, stack + (path,))

    def resolve(node, stack=()):
        if isinstance(node, dict):
            return {k: resolve(v, stack) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, stack) for v in node]
        if isinstance(node, str):
            whole = _INTERP_RE.match(node)
            if whole:
                return lookup(whole.group(1), stack)
            return _INTERP_INLINE_RE.sub(lambda m: str(lookup(m.group(1), stack)), node)
        return node

    return resolve(options)


def _expand_gradient(value: Any, default_key: str) -> Optional[Dict[str, Any]]:
    if value in (False, None, "off"):
        return None
    if value in (True, "on"):
        return {"key": default_key}
    if isinstance(value, dict):
        out = dict(value)
        out.setdefault("key", default_key)
        return out
    raise MetatrainConfigError(
        f"cannot interpret gradient spec {value!r} (use on/off or a mapping)"
    )


def expand_target_config(name: str, config: Any) -> Dict[str, Any]:
    """Expand one target section to canonical form."""
    if config is None:
        config = {}
    if isinstance(config, str):
        config = {"read_from": config}
    if not isinstance(config, dict):
        raise MetatrainConfigError(f"target '{name}' section must be a mapping")
    out = dict(config)
    is_energy = name == "energy" or out.get("quantity") == "energy"
    out.setdefault("quantity", "energy" if is_energy else "")
    out.setdefault("key", name)
    out.setdefault("unit", "eV" if is_energy else "")
    out.setdefault("read_from", None)
    out.setdefault("per_atom", False)
    out.setdefault("num_subtargets", 1)
    out.setdefault("type", "scalar")
    if is_energy:
        out["forces"] = _expand_gradient(out.get("forces", False), "forces")
        out["stress"] = _expand_gradient(out.get("stress", False), "stress")
        out["virial"] = _expand_gradient(out.get("virial", False), "virial")
        if out["stress"] and out["virial"]:
            raise MetatrainConfigError(f"target '{name}': cannot use stress and virial together")
    return out


def expand_dataset_config(config: Any) -> Dict[str, Any]:
    """Expand a train/val/test dataset section to canonical form."""
    if isinstance(config, str):
        config = {"systems": {"read_from": config}, "targets": {"energy": {}}}
    if not isinstance(config, dict):
        raise MetatrainConfigError("dataset section must be a string or mapping")
    out = dict(config)
    systems = out.get("systems")
    if isinstance(systems, str):
        systems = {"read_from": systems}
    if not isinstance(systems, dict) or "read_from" not in systems:
        raise MetatrainConfigError("dataset section needs systems.read_from")
    systems = dict(systems)
    systems.setdefault("length_unit", "")
    out["systems"] = systems
    out["targets"] = {
        name: expand_target_config(name, target_config)
        for name, target_config in (out.get("targets") or {}).items()
    }
    if out.get("extra_data"):
        out["extra_data"] = {name: expand_target_config(name, c)
                             for name, c in out["extra_data"].items()}
    return out


def _invalid(location: str, message: str) -> MetatrainConfigError:
    return MetatrainConfigError(f"invalid options file:\n  - {location}: {message}")


def _check_base(options: Dict[str, Any]) -> None:
    """The checks of the JAX package's pydantic schema: known keys only,
    a required architecture name and training set, typed scalars."""
    for key in options:
        if key not in _TOP_LEVEL:
            raise _invalid(key, "Extra inputs are not permitted")
    if "architecture" not in options:
        raise _invalid("architecture", "Field required")
    if "training_set" not in options:
        raise _invalid("training_set", "Field required")
    arch = options["architecture"]
    if not isinstance(arch, dict):
        raise _invalid("architecture", "Input should be a valid dictionary")
    for key in arch:
        if key not in _ARCHITECTURE_KEYS:
            raise _invalid(f"architecture.{key}", "Extra inputs are not permitted")
    if not isinstance(arch.get("name"), str):
        raise _invalid("architecture.name", "Field required")
    for key in ("model", "training"):
        if not isinstance(arch.get(key, {}), dict):
            raise _invalid(f"architecture.{key}", "Input should be a valid dictionary")
    if not isinstance(options["device"], str):
        raise _invalid("device", "Input should be a valid string")
    for key in ("base_precision", "seed"):
        if isinstance(options[key], bool) or not isinstance(options[key], int):
            raise _invalid(key, "Input should be a valid integer")
    if options["base_precision"] not in (16, 32, 64):
        raise _invalid("base_precision", "Value error, base_precision must be 16, 32 or 64")


def validate_base_options(options: Dict[str, Any]) -> Dict[str, Any]:
    """Validate and normalize the full options dict."""
    merged = copy.deepcopy({**BASE_OPTIONS, "validation_set": 0.1, "test_set": 0.0, **options})
    _check_base(merged)
    from .architectures import check_architecture_name

    try:
        check_architecture_name(merged["architecture"]["name"])
    except ValueError as err:
        raise MetatrainConfigError(str(err)) from err
    merged["architecture"] = {"model": {}, "training": {}, **merged["architecture"]}

    if isinstance(merged["training_set"], list):
        merged["training_set"] = [expand_dataset_config(s) for s in merged["training_set"]]
    else:
        merged["training_set"] = expand_dataset_config(merged["training_set"])
    for key in ("validation_set", "test_set"):
        value = merged[key]
        if isinstance(value, list):
            merged[key] = [expand_dataset_config(section) for section in value]
        elif not isinstance(value, (int, float)):
            merged[key] = expand_dataset_config(value)
        elif not (0.0 <= float(value) < 1.0):
            raise MetatrainConfigError(f"{key} fraction must be in [0, 1), got {value}")
    return {key: merged[key] for key in _TOP_LEVEL}


def save_expanded_options(options: Dict[str, Any], path: Union[str, Path]) -> None:
    """Write the expanded options (``options_restart.yaml``) as JSON."""
    Path(path).write_text(json.dumps(options, indent=2, default=str) + "\n")


def _suggest(key: str, candidates) -> str:
    close = difflib.get_close_matches(key, list(candidates), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def merge_architecture_hypers(name: str, user: Dict[str, Any]) -> Dict[str, Any]:
    """Defaults <- user overrides, recursively, REJECTING unknown keys.

    A typo'd hyperparameter raises instead of silently training the
    default model. Dicts whose default is empty (per-target weight maps,
    finetune configs) are open: user keys there are accepted verbatim.
    """
    from .architectures import get_default_hypers

    defaults = get_default_hypers(name)

    def deep_update(base, update, path):
        for key, value in update.items():
            if key not in base and base:
                location = ".".join(path + [str(key)])
                raise MetatrainConfigError(
                    f"unknown hyperparameter '{location}' for architecture "
                    f"'{name}'{_suggest(str(key), base)}"
                )
            if isinstance(value, dict) and isinstance(base.get(key), dict):
                deep_update(base[key], value, path + [str(key)])
            else:
                base[key] = value

    deep_update(defaults, user or {}, [])
    return defaults
