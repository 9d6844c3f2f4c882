"""``eval``: batched evaluation of an exported model or a checkpoint.

Counterpart of ``metatrain_tpu/cli/eval.py``: per-batch
``evaluate_model`` with RMSE/MAE accumulation (per-atom averaging first,
as in training), warm-up batches before the timed pass, a per-atom timing
report and the prediction writers. Inference runs with the parameters
frozen, so the served kernels take the call; the batches are built on the
model's device.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.collate import CollateFn
from ..data.dataset import dataset_target_names, get_dataset
from ..data.samplers import BatchSampler, DataLoader
from ..data.target_info import DatasetInfo
from ..engine.evaluate import evaluate_model
from ..engine.metrics import ErrorAccumulator, batch_errors
from ..ops.inference import no_param_grads
from ..ops.segment import average_by_num_atoms
from ..utils.config import expand_dataset_config
from ..utils.io import load_model
from ..utils.logging import ROOT_LOGGER

logger = logging.getLogger(ROOT_LOGGER + ".eval")

NOT_PER_ATOM = ["positions_gradients", "strain_gradients"]


def _loader(model, dataset, target_infos, batch_size: int) -> DataLoader:
    """Batches on the model's device, float64 for a float64 network and
    float32 otherwise."""
    param = next(model.parameters())
    dtype = torch.float64 if param.dtype == torch.float64 else torch.float32
    collate = CollateFn(model.requested_neighbor_cutoff(), target_infos, dtype=dtype,
                        device=param.device,
                        extra_system_keys=model.requested_extra_system_keys())
    return DataLoader(dataset, BatchSampler(len(dataset), batch_size, shuffle=False), collate)


def _eval_step(model, batch, target_infos):
    """Predictions (scaler and baselines applied) and their error sums
    against the batch's targets, both averaged by the atom count."""
    predictions = evaluate_model(model.forward_eval, batch.systems, target_infos)
    with torch.no_grad():
        errors = batch_errors(average_by_num_atoms(predictions, batch.systems),
                              average_by_num_atoms(batch.targets, batch.systems))
    return predictions, errors


def evaluate_datasets(model, dataset, dataset_info: DatasetInfo, batch_size: int = 16,
                      check_consistency: bool = False) -> Dict[str, float]:
    """RMSE/MAE of ``model`` over ``dataset``."""
    names = set(dataset_target_names(dataset))
    target_infos = {n: i for n, i in dataset_info.targets.items() if n in names}
    accumulator = ErrorAccumulator()
    with no_param_grads(model):
        for batch in _loader(model, dataset, target_infos, batch_size):
            if check_consistency:
                from ..utils.consistency import check_batch_consistency

                check_batch_consistency(batch.systems, model.requested_neighbor_cutoff())
            accumulator.update_from_errors(_eval_step(model, batch, target_infos)[1])
    return accumulator.finalize(not_per_atom=NOT_PER_ATOM)


def eval_model(model_path: str, options: Dict[str, Any], output_path: Optional[str] = None,
               batch_size: int = 16, check_consistency: bool = False, warm_up: int = 1,
               device="auto", **model_options) -> Dict[str, float]:
    """The eval command: load the model on ``device`` (the card unless
    the caller asks otherwise; ``model_options`` go to ``load_model``), read
    the dataset, evaluate, log the metrics and the time, write the
    predictions to ``output_path``."""
    model = load_model(model_path, context="export", device=device, **model_options)
    dataset, target_infos = get_dataset(expand_dataset_config(options))
    names = set(dataset_target_names(dataset))
    target_infos = {n: i for n, i in model.supported_outputs().items() if n in names} \
        or target_infos
    batch_list = list(_loader(model, dataset, target_infos, batch_size))
    if check_consistency:
        from ..utils.consistency import check_batch_consistency

        for batch in batch_list:
            check_batch_consistency(batch.systems, model.requested_neighbor_cutoff())
    on_card = next(model.parameters()).is_cuda

    def sync():
        if on_card:
            torch.cuda.synchronize()

    accumulator = ErrorAccumulator()
    all_predictions = []
    per_atom_ms = []
    with no_param_grads(model):
        for batch in batch_list[:warm_up]:  # untimed warm-up
            _eval_step(model, batch, target_infos)
        sync()
        start_total = time.perf_counter()
        for batch in batch_list:
            t0 = time.perf_counter()
            predictions, errors = _eval_step(model, batch, target_infos)
            sync()
            elapsed = time.perf_counter() - t0
            n_atoms = int(batch.systems.atom_mask.sum())
            per_atom_ms.append(elapsed / max(n_atoms, 1) * 1e3)
            accumulator.update_from_errors(errors)
            all_predictions.append((batch, predictions))
        total = time.perf_counter() - start_total

    metrics = accumulator.finalize(not_per_atom=NOT_PER_ATOM)
    for key, value in metrics.items():
        logger.info("%s: %.6g", key, value)
    if per_atom_ms:
        logger.info("Evaluation time: %.2f s [%.4f ± %.4f ms per atom]", total,
                    float(np.mean(per_atom_ms)), float(np.std(per_atom_ms)))
    if output_path is not None:
        from ..data.writers import write_predictions

        write_predictions(output_path, all_predictions, target_infos)
        logger.info("Wrote predictions to %s", output_path)
    return metrics
