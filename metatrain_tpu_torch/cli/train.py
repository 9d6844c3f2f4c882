"""``train``: training orchestration on one device.

Counterpart of ``metatrain_tpu/cli/train.py`` up to the final checkpoint:
validate options -> import the architecture -> merge hypers -> seed ->
build datasets (fraction split or explicit files) -> DatasetInfo ->
instantiate the model -> train -> save ``model.ckpt`` (the model part in
the JAX package's layout). Not ported yet: restarting, finetuning from a
checkpoint, the export after training and the final evaluation.

Precision: ``base_precision`` sets the dtype of the batches as in the JAX
package; the network computes in float32, or in float64 for
``base_precision: 64`` (the JAX package keeps a float32 network there).
"""

from __future__ import annotations

import logging
import random
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.dataset import get_dataset, get_dataset_info, get_stats, train_val_test_split
from ..utils.architectures import import_architecture
from ..utils.config import merge_architecture_hypers, save_expanded_options, validate_base_options
from ..utils.logging import ROOT_LOGGER

logger = logging.getLogger(ROOT_LOGGER + ".train")

_PRECISION_DTYPES = {16: torch.bfloat16, 32: torch.float32, 64: torch.float64}


def _device(name: str) -> torch.device:
    """``"auto"`` is the first CUDA device; without one it raises rather than
    train on the CPU unasked."""
    if name == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                'device "auto" trains on the first CUDA device and none was found; '
                'pass device: "cpu" to train on the CPU'
            )
        return torch.device("cuda", 0)
    return torch.device(name)


def train_model(
    options: Dict[str, Any],
    output_dir: str = ".",
    checkpoint_dir: str = ".",
    restart_from: Optional[str] = None,
):
    """Train from an options dict; returns ``(model, trainer)``. The final
    checkpoint is ``checkpoint_dir/model.ckpt``."""
    if restart_from is not None:
        raise NotImplementedError("restarting a training run is not ported yet")
    options = validate_base_options(options)
    arch_name = options["architecture"]["name"]
    architecture = import_architecture(arch_name)
    hypers = merge_architecture_hypers(arch_name, {
        "model": options["architecture"]["model"],
        "training": options["architecture"]["training"],
    })
    if (hypers["training"].get("finetune") or {}).get("read_from"):
        raise NotImplementedError("finetuning from a checkpoint is not ported yet")

    seed = int(options["seed"])
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    hypers["training"].setdefault("seed", seed)

    dtype = _PRECISION_DTYPES[options["base_precision"]]
    compute_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    device = _device(options["device"])

    # ---- datasets (one section or a list of sections) -----------------------
    train_confs = options["training_set"]
    if not isinstance(train_confs, list):
        train_confs = [train_confs]
    train_datasets = []
    target_infos: Dict[str, Any] = {}
    for conf in train_confs:
        dataset, infos = get_dataset(conf)
        train_datasets.append(dataset)
        target_infos.update(infos)
    length_unit = train_confs[0]["systems"].get("length_unit", "")

    val_conf = options["validation_set"]
    test_conf = options["test_set"]
    val_datasets: list = []
    if isinstance(val_conf, (int, float)):
        test_fraction = float(test_conf) if isinstance(test_conf, (int, float)) else 0.0
        split_trains = []
        for dataset in train_datasets:
            train_part, val_part, _ = train_val_test_split(
                dataset, val_fraction=float(val_conf), test_fraction=test_fraction, seed=seed,
            )
            split_trains.append(train_part)
            val_datasets.append(val_part)
        train_datasets = split_trains
    else:
        for conf in val_conf if isinstance(val_conf, list) else [val_conf]:
            val_datasets.append(get_dataset(conf)[0])

    dataset_info = get_dataset_info(train_datasets + val_datasets, target_infos, length_unit)
    for i, dataset in enumerate(train_datasets):
        tag = f" #{i}" if len(train_datasets) > 1 else ""
        logger.info("Training dataset%s:\n%s", tag, get_stats(dataset, dataset_info))
    for i, dataset in enumerate(val_datasets):
        if len(dataset):
            tag = f" #{i}" if len(val_datasets) > 1 else ""
            logger.info("Validation dataset%s:\n%s", tag, get_stats(dataset, dataset_info))

    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    save_expanded_options(options, checkpoint_dir / "options_restart.yaml")

    model = architecture.__model__(hypers["model"], dataset_info, compute_dtype=compute_dtype)
    model.to(device)
    trainer = architecture.__trainer__(hypers["training"])
    real_vals = [ds for ds in val_datasets if len(ds)]
    trainer.train(
        model=model,
        dtype=dtype,
        train_datasets=train_datasets,
        val_datasets=real_vals if real_vals else train_datasets,
        checkpoint_dir=str(checkpoint_dir),
    )

    final_ckpt = checkpoint_dir / "model.ckpt"
    trainer.save_checkpoint(model, final_ckpt)
    logger.info("Saved checkpoint to %s", final_ckpt)
    return model, trainer
