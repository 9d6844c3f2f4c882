"""Loss system: pointwise masked TensorMap losses and the aggregator.

Counterpart of ``metatrain_tpu/engine/loss.py`` on torch tensors.
Pointwise losses are flattened over all blocks of a TensorMap with
NaN-target masking and the padding masks of the batches. Every term
returns ``(sum, count)`` pairs internally.

Config shape as the JAX package's: per target a ``{"type", "weight",
"reduction", "gradients": {name: {...}}}`` dict, with string shorthands
expanded and ``forces``/``stress``/``virial`` as aliases of the
``positions``/``strain`` gradients. The ensemble and classification kinds
(``shift_agnostic_mse``, ``gaussian_nll``, ``crps``, ``cross_entropy``)
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from ..containers import TensorBlock, TensorMap
from ..data.target_info import TargetInfo

_NOT_PORTED = ("shift_agnostic_mse", "gaussian_nll", "crps", "cross_entropy")


def _pointwise(kind: str, diff, **kw):
    if kind == "mse":
        return diff * diff
    if kind == "mae":
        return torch.abs(diff)
    if kind == "huber":
        delta = float(kw.get("delta", 1.0))
        abs_diff = torch.abs(diff)
        return torch.where(abs_diff <= delta, 0.5 * diff * diff, delta * (abs_diff - 0.5 * delta))
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"loss type {kind!r} is not ported yet")
    raise ValueError(f"unknown loss type {kind!r}")


def block_loss_terms(
    kind: str,
    prediction: TensorBlock,
    target: TensorBlock,
    extra_mask: Optional[TensorBlock] = None,
    **kw,
):
    """``(sum, count)`` of the pointwise loss over one block.

    Elements are dropped when (a) the block's padding mask is False on
    their sample row, (b) the target value is NaN, or (c) an explicit
    extra mask (from ``extra_data["{target}_mask"]``) is False.
    """
    pred = prediction.values
    tgt = target.values
    valid = ~torch.isnan(tgt)
    if target.mask is not None:
        valid = valid & target.mask.reshape(target.mask.shape + (1,) * (tgt.ndim - 1))
    if extra_mask is not None:
        valid = valid & extra_mask.values.bool()
    diff = torch.where(valid, pred - torch.nan_to_num(tgt), 0.0)
    loss = _pointwise(kind, diff, **kw)
    return torch.sum(loss), torch.sum(valid.to(loss.dtype))


@dataclasses.dataclass
class LossTerm:
    """One scheduled loss term: a target or one of its gradients."""

    target: str
    gradient: Optional[str]
    kind: str
    weight: float
    reduction: str = "mean"
    extra_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def sum_and_count(self, predictions, targets, extra_data=None):
        """Raw ``(sum, count)`` over the blocks of the term."""
        pred_map = predictions[self.target]
        tgt_map = targets[self.target]
        mask_map = (extra_data or {}).get(f"{self.target}_mask")
        total = count = 0.0
        for idx in range(len(tgt_map)):
            pred_block = pred_map.blocks()[idx]
            tgt_block = tgt_map.blocks()[idx]
            mask_block = mask_map.blocks()[idx] if mask_map is not None else None
            if self.gradient is not None:
                if not tgt_block.has_gradient(self.gradient):
                    continue
                pred_block = pred_block.gradient(self.gradient)
                tgt_block = tgt_block.gradient(self.gradient)
                # a gradient term's mask is the mask's matching gradient block
                mask_block = (
                    mask_block.gradient(self.gradient)
                    if mask_block is not None and mask_block.has_gradient(self.gradient)
                    else None
                )
            s, c = block_loss_terms(self.kind, pred_block, tgt_block, mask_block,
                                    **self.extra_kwargs)
            total, count = total + s, count + c
        return total, count

    def compute(
        self,
        predictions: Dict[str, TensorMap],
        targets: Dict[str, TensorMap],
        extra_data: Optional[Dict[str, TensorMap]] = None,
    ):
        total, count = self.sum_and_count(predictions, targets, extra_data)
        if self.reduction == "mean":
            return total / torch.clamp(torch.as_tensor(count), min=1.0)
        return total


_RESERVED = (
    "type", "weight", "reduction", "gradients", "sliding_factor",
    "forces", "stress", "virial",
)

# user-facing gradient names in loss configs -> internal gradient names
_GRADIENT_ALIASES = {
    "forces": "positions",
    "stress": "strain",
    "virial": "strain",
}


def _expand_spec(spec: Union[str, Dict[str, Any], None]) -> Dict[str, Any]:
    if spec is None:
        spec = {}
    if isinstance(spec, str):
        spec = {"type": spec}
    gradients = dict(spec.get("gradients", {}))
    for alias, internal in _GRADIENT_ALIASES.items():
        if alias in spec:
            gradients[internal] = spec[alias]
    out = {
        "type": spec.get("type", "mse"),
        "weight": float(spec.get("weight", 1.0)),
        "reduction": spec.get("reduction", "mean"),
        "gradients": gradients,
    }
    out["extra"] = {k: v for k, v in spec.items() if k not in _RESERVED}
    return out


class LossAggregator:
    """Weighted sum of per-target and per-gradient loss terms.

    :param targets: target name -> TargetInfo.
    :param config: either one spec (str/dict) applied to every target, or a
        per-target dict ``{name: spec}``; specs may nest a ``gradients``
        section with per-gradient specs.
    """

    def __init__(
        self,
        targets: Dict[str, TargetInfo],
        config: Union[str, Dict[str, Any], None] = None,
    ):
        if isinstance(config, str) or config is None or any(key in _RESERVED for key in config):
            per_target_config = {name: config for name in targets}
        else:
            # per-target mapping: unknown names are a config error
            unknown = set(config) - set(targets)
            if unknown:
                raise ValueError(
                    f"loss config names unknown target(s) "
                    f"{sorted(unknown)}; dataset targets: {sorted(targets)}"
                )
            per_target_config = {name: config.get(name) for name in targets}

        self.terms: Dict[str, LossTerm] = {}
        self.metadata: Dict[str, Any] = {}
        for name, info in targets.items():
            spec = _expand_spec(per_target_config.get(name))
            self.terms[name] = LossTerm(
                target=name, gradient=None, kind=spec["type"], weight=spec["weight"],
                reduction=spec["reduction"], extra_kwargs=spec["extra"],
            )
            self.metadata[name] = {"type": spec["type"], "weight": spec["weight"], "gradients": {}}
            for grad_name in info.gradients:
                grad_spec = _expand_spec(spec["gradients"].get(grad_name))
                self.terms[f"{name}_grad_{grad_name}"] = LossTerm(
                    target=name, gradient=grad_name, kind=grad_spec["type"],
                    weight=grad_spec["weight"], reduction=grad_spec["reduction"],
                    extra_kwargs=grad_spec["extra"],
                )
                self.metadata[name]["gradients"][grad_name] = {
                    "type": grad_spec["type"], "weight": grad_spec["weight"],
                }

    def compute(
        self,
        predictions: Dict[str, TensorMap],
        targets: Dict[str, TensorMap],
        extra_data: Optional[Dict[str, TensorMap]] = None,
    ):
        total = 0.0
        for term in self.terms.values():
            if term.target not in predictions:
                continue
            total = total + term.weight * term.compute(predictions, targets, extra_data)
        return total

    def __call__(self, predictions, targets, extra_data=None):
        return self.compute(predictions, targets, extra_data)
