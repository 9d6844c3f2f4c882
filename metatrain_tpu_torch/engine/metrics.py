"""RMSE/MAE accumulators.

Counterpart of ``metatrain_tpu/engine/metrics.py``: per-target and
per-gradient ``(sum_sq, sum_abs, count)`` triples, NaN- and
padding-masked, summed on the device per batch (``batch_errors``) and on
the host over an epoch (``ErrorAccumulator``). Key names are the JAX
package's: ``{target}`` and ``{target}_{gradient}_gradients`` accumulate;
finalize emits ``"{key} RMSE (per atom)"`` unless the key matches
``not_per_atom``, with the gradient keys shown as ``forces``/``virial``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..containers import TensorBlock, TensorMap


def _masked_error_sums(prediction: TensorBlock, target: TensorBlock,
                       extra_mask: Optional[TensorBlock]):
    tgt = target.values
    valid = ~torch.isnan(tgt)
    if target.mask is not None:
        valid = valid & target.mask.reshape(target.mask.shape + (1,) * (tgt.ndim - 1))
    if extra_mask is not None:
        valid = valid & extra_mask.values.bool()
    diff = torch.where(valid, prediction.values - torch.nan_to_num(tgt), 0.0)
    return torch.sum(diff * diff), torch.sum(torch.abs(diff)), torch.sum(valid.to(torch.float32))


def batch_errors(
    predictions: Dict[str, TensorMap],
    targets: Dict[str, TensorMap],
    extra_data: Optional[Dict[str, TensorMap]] = None,
    separate_blocks: bool = False,
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per-key ``(sum_sq, sum_abs, count)`` for one batch."""
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def accumulate(key, pred_block, tgt_block, extra_mask):
        sums = _masked_error_sums(pred_block, tgt_block, extra_mask)
        out[key] = tuple(a + b for a, b in zip(out[key], sums)) if key in out else sums

    for name, target in targets.items():
        if name not in predictions:
            continue
        prediction = predictions[name]
        mask_map = (extra_data or {}).get(f"{name}_mask")
        for idx, (key_tuple, tgt_block) in enumerate(target.items()):
            pred_block = prediction.blocks()[idx]
            key = name
            if separate_blocks:
                key += " (" + ",".join(
                    f"{n}={v}" for n, v in zip(target.keys.names, key_tuple)
                ) + ")"
            extra_mask = mask_map.blocks()[idx] if mask_map is not None else None
            accumulate(key, pred_block, tgt_block, extra_mask)
            for grad_name, tgt_grad in tgt_block.gradients():
                if not pred_block.has_gradient(grad_name):
                    continue
                extra_grad_mask = (
                    extra_mask.gradient(grad_name)
                    if extra_mask is not None and extra_mask.has_gradient(grad_name)
                    else None
                )
                accumulate(f"{key}_{grad_name}_gradients", pred_block.gradient(grad_name),
                           tgt_grad, extra_grad_mask)
    return out


def _external_metric_name(key: str) -> str:
    """Gradient metrics display under their common names
    (energy_positions_gradients -> forces, energy_strain_gradients ->
    virial; other energy-like targets get forces[target] / virial[target])."""
    for suffix, common in (("_positions_gradients", "forces"), ("_strain_gradients", "virial")):
        if key.endswith(suffix):
            base = key[: -len(suffix)]
            return common if base == "energy" else f"{common}[{base}]"
    return key


class ErrorAccumulator:
    """Host-side accumulator over batches; computes both RMSE and MAE."""

    def __init__(self, separate_blocks: bool = False):
        self.separate_blocks = separate_blocks
        self.information: Dict[str, Tuple[float, float, float]] = {}

    def update_from_errors(self, errors) -> None:
        """Fold in the output of :func:`batch_errors`."""
        for key, (sq, ab, ct) in errors.items():
            prev = self.information.get(key, (0.0, 0.0, 0.0))
            self.information[key] = (prev[0] + float(sq), prev[1] + float(ab), prev[2] + float(ct))

    def update(self, predictions, targets, extra_data=None) -> None:
        self.update_from_errors(
            batch_errors(predictions, targets, extra_data, self.separate_blocks))

    def finalize(
        self,
        not_per_atom: List[str] = (),
        metrics: Tuple[str, ...] = ("RMSE", "MAE"),
    ) -> Dict[str, float]:
        finalized: Dict[str, float] = {}
        for key, (sq, ab, ct) in self.information.items():
            # exact key or trailing-component match only
            is_total = any(key == s or key.endswith("_" + s) for s in not_per_atom)
            suffix = "" if is_total else " (per atom)"
            shown = _external_metric_name(key)
            ct = max(ct, 1.0)
            if "RMSE" in metrics:
                finalized[f"{shown} RMSE{suffix}"] = float(np.sqrt(sq / ct))
            if "MAE" in metrics:
                finalized[f"{shown} MAE{suffix}"] = ab / ct
        return finalized


def get_selected_metric(metric_dict: Dict[str, float], selected_metric: str) -> float:
    """Best-model selection metric: ``loss``, ``rmse_prod`` or ``mae_prod``."""
    if selected_metric == "loss":
        return metric_dict["loss"]
    if selected_metric in ("rmse_prod", "mae_prod"):
        tag = "RMSE" if selected_metric == "rmse_prod" else "MAE"
        values = [v for k, v in metric_dict.items() if tag in k]
        if not values:
            # no matching metrics (e.g. log_mae off): fall back to the loss
            return metric_dict["loss"]
        prod = 1.0
        for value in values:
            prod *= value
        return prod
    raise ValueError(
        f"selected metric {selected_metric!r} not recognized; "
        "use 'loss', 'rmse_prod', or 'mae_prod'"
    )
