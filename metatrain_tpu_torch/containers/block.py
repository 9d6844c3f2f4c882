"""Block-sparse labeled tensors (metatensor's ``TensorMap``, minimal).

Counterpart of ``metatrain_tpu/containers/block.py``: blocks of dense
tensors with sample/component/property labels (components such as
``xyz``, ``xyz_1``/``xyz_2`` or ``o3_mu``), an optional boolean ``mask``
over padded sample rows, gradient blocks keyed by parameter, and maps of
blocks keyed by labels such as ``o3_lambda``/``o3_sigma`` or
``atom_type``, with lookup of a block by its key. Metatensor interop and
joins are not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .labels import Labels


class TensorBlock:
    """One dense block: ``values`` of shape ``(n_samples, *components,
    n_properties)`` with its labels and an optional sample ``mask``."""

    __slots__ = ("values", "samples", "components", "properties", "mask", "_gradients")

    def __init__(
        self,
        values: torch.Tensor,
        samples: Labels,
        components: Sequence[Labels],
        properties: Labels,
        mask: Optional[torch.Tensor] = None,
    ):
        self.values = values
        self.samples = samples
        self.components = tuple(components)
        self.properties = properties
        self.mask = mask
        self._gradients: Dict[str, TensorBlock] = {}

    def add_gradient(self, parameter: str, gradient: "TensorBlock") -> None:
        self._gradients[parameter] = gradient

    def gradient(self, parameter: str) -> "TensorBlock":
        return self._gradients[parameter]

    def has_gradient(self, parameter: str) -> bool:
        return parameter in self._gradients

    def gradients(self) -> Iterator[Tuple[str, "TensorBlock"]]:
        return iter(sorted(self._gradients.items()))

    def gradients_list(self) -> List[str]:
        return sorted(self._gradients)

    def map_values(self, fn) -> "TensorBlock":
        """New block with ``fn`` applied to values (and gradient values)."""
        new = TensorBlock(fn(self.values), self.samples, self.components, self.properties,
                          self.mask)
        for name, grad in self._gradients.items():
            new.add_gradient(name, grad.map_values(fn))
        return new

    def __repr__(self) -> str:
        return (
            f"TensorBlock(shape={tuple(self.values.shape)}, "
            f"samples={self.samples.names}, gradients={self.gradients_list()})"
        )


class TensorMap:
    """A set of blocks keyed by labels (one key entry per block)."""

    __slots__ = ("keys", "_blocks")

    def __init__(self, keys: Labels, blocks: Sequence[TensorBlock]):
        if len(keys) != len(blocks):
            raise ValueError(
                f"TensorMap got {len(keys)} keys but {len(blocks)} blocks"
            )
        self.keys = keys
        self._blocks = list(blocks)

    def __len__(self) -> int:
        return len(self._blocks)

    def items(self) -> Iterator[Tuple[Tuple[int, ...], TensorBlock]]:
        return iter(zip(self.keys.as_tuples(), self._blocks))

    def __iter__(self) -> Iterator[TensorBlock]:
        return iter(self._blocks)

    def blocks(self) -> List[TensorBlock]:
        return list(self._blocks)

    def block(self, key: Union[int, Sequence[int], None] = None, **selection: int) -> TensorBlock:
        """The block of ``key``: with no key the only block; an int with
        one-column keys the block whose key is that value, with several
        columns the block at that position; a sequence the block whose key
        it is; keywords the one block whose key columns match them."""
        if key is None and not selection:
            if len(self._blocks) != 1:
                raise ValueError("TensorMap has multiple blocks, pass a key")
            return self._blocks[0]
        if selection:
            idx = self._key_position_by_names(selection)
        elif isinstance(key, int) and len(self.keys.names) != 1:
            idx = key
        else:
            idx = self.keys.position([key] if isinstance(key, int) else list(key))
        if idx < 0 or idx >= len(self._blocks):
            raise KeyError(f"no block for key {key}{selection or ''}")
        return self._blocks[idx]

    def _key_position_by_names(self, selection: Dict[str, int]) -> int:
        values = np.asarray(self.keys.values)
        match = np.ones(len(values), dtype=bool)
        for name, value in selection.items():
            match &= values[:, self.keys.names.index(name)] == value
        positions = np.nonzero(match)[0]
        if len(positions) != 1:
            raise KeyError(f"selection {selection} matched {len(positions)} blocks")
        return int(positions[0])

    def has_key(self, key: Sequence[int]) -> bool:
        return self.keys.position(list(key)) >= 0

    def map_blocks(self, fn) -> "TensorMap":
        return TensorMap(self.keys, [fn(b) for b in self._blocks])

    def __repr__(self) -> str:
        return f"TensorMap(keys={self.keys.names}, n_blocks={len(self._blocks)})"
