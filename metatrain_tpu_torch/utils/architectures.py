"""Architecture registry of the port.

Counterpart of ``metatrain_tpu/utils/architectures.py``: a name maps to a
module exposing ``__model__``, ``__trainer__`` and ``DEFAULT_HYPERS``.
The port has PET.
"""

from __future__ import annotations

import copy
import difflib
import importlib
from typing import Any, Dict

ARCHITECTURES = {"pet": "metatrain_tpu_torch.models.pet"}


def check_architecture_name(name: str) -> None:
    if name in ARCHITECTURES:
        return
    close = difflib.get_close_matches(name, ARCHITECTURES.keys(), cutoff=0.4)
    hint = f" Did you mean '{close[0]}'?" if close else ""
    raise ValueError(
        f"architecture {name!r} is not known to the port; available: "
        f"{sorted(ARCHITECTURES)}.{hint}"
    )


def import_architecture(name: str):
    check_architecture_name(name)
    return importlib.import_module(ARCHITECTURES[name])


def get_default_hypers(name: str) -> Dict[str, Any]:
    return copy.deepcopy(import_architecture(name).DEFAULT_HYPERS)
