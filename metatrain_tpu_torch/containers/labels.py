"""Labeled integer metadata axes (metatensor's ``Labels``, minimal).

Counterpart of ``metatrain_tpu/containers/labels.py``: a tuple of axis
names plus an integer value array, a numpy array for static metadata
(keys, components, properties) or a torch tensor for per-batch samples.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


class Labels:
    """Named integer label axes.

    :param names: one name per column of ``values``.
    :param values: integer array of shape ``(n_entries, len(names))``.
    """

    __slots__ = ("names", "values")

    def __init__(self, names: Sequence[str], values: Array):
        names = tuple(str(n) for n in names)
        if isinstance(values, np.ndarray):
            values = np.ascontiguousarray(values, dtype=np.int32)
        if values.ndim != 2:
            raise ValueError(
                f"Labels values must be 2D, got shape {tuple(values.shape)}"
            )
        if values.shape[1] != len(names):
            raise ValueError(
                f"Labels values have {values.shape[1]} columns "
                f"but {len(names)} names were given"
            )
        self.names = names
        self.values = values

    @staticmethod
    def range(name: str, n: int) -> "Labels":
        return Labels([name], np.arange(n, dtype=np.int32).reshape(-1, 1))

    @staticmethod
    def single() -> "Labels":
        return Labels(["_"], np.zeros((1, 1), dtype=np.int32))

    @staticmethod
    def empty(names: Sequence[str]) -> "Labels":
        return Labels(names, np.zeros((0, len(tuple(names))), dtype=np.int32))

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def __repr__(self) -> str:
        return f"Labels(names={self.names}, n={self.values.shape[0]})"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Labels):
            return NotImplemented
        if self.names != other.names:
            return False
        return tuple(self.values.shape) == tuple(other.values.shape) and bool(
            np.array_equal(_host(self.values), _host(other.values))
        )

    def __hash__(self) -> int:
        return hash((self.names, _host(self.values).tobytes()))

    def column(self, name: str) -> Array:
        return self.values[:, self.names.index(name)]

    def position(self, entry: Sequence[int]) -> int:
        """Index of ``entry`` in these labels, or -1."""
        values = _host(self.values)
        matches = np.nonzero(
            (values == np.asarray(entry, dtype=values.dtype)).all(1)
        )[0]
        return int(matches[0]) if matches.size else -1

    def as_tuples(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(tuple(int(x) for x in row) for row in _host(self.values))


def _host(values: Array) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)
