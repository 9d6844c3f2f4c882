"""Block-sparse labeled tensors (metatensor's ``TensorMap``, minimal).

Counterpart of ``metatrain_tpu/containers/block.py``, reduced to what an
energy target with ``positions``/``strain`` gradients needs: blocks of
dense tensors with sample/component/property labels, an optional boolean
``mask`` over padded sample rows, and gradient blocks keyed by parameter.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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

    def gradients(self) -> Iterator[Tuple[str, "TensorBlock"]]:
        return iter(sorted(self._gradients.items()))

    def gradients_list(self) -> List[str]:
        return sorted(self._gradients)

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

    def blocks(self) -> List[TensorBlock]:
        return list(self._blocks)

    def block(self, index: int = 0) -> TensorBlock:
        return self._blocks[index]

    def __repr__(self) -> str:
        return f"TensorMap(keys={self.keys.names}, n_blocks={len(self._blocks)})"
