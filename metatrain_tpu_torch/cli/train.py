"""``train``: training orchestration on one device.

Counterpart of ``metatrain_tpu/cli/train.py``: validate options -> import
the architecture -> merge hypers -> seed -> build datasets (fraction split
or explicit files) -> DatasetInfo -> a fresh model, or one restarted from a
checkpoint (``restart_from``: the model and the trainer's state) or
finetuned from one (``finetune.read_from``: the model, a new trainer) ->
train -> save ``model.ckpt`` (the model part in the JAX package's layout)
-> export ``output_name`` (the best weights) -> evaluate the train,
validation and test sets.

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
from ..utils.devices import resolve_device
from ..utils.io import load_checkpoint_file, model_from_checkpoint, trainer_from_checkpoint
from ..utils.logging import ROOT_LOGGER

logger = logging.getLogger(ROOT_LOGGER + ".train")

_PRECISION_DTYPES = {16: torch.bfloat16, 32: torch.float32, 64: torch.float64}


# the train options' ``device``: "auto" is the first card, and raises without one
_device = resolve_device


def train_model(
    options: Dict[str, Any],
    output_dir: str = ".",
    checkpoint_dir: str = ".",
    restart_from: Optional[str] = None,
    output_name: str = "model.mtt",
    fused_gnn: bool = False,
):
    """Train from an options dict; returns ``(model, trainer)``. The final
    checkpoint is ``checkpoint_dir/model.ckpt``, the exported model
    ``output_dir/output_name``. ``fused_gnn`` runs each GNN layer's fused
    layers as one GNN block (``PET(fused_gnn=...)``)."""
    options = validate_base_options(options)
    arch_name = options["architecture"]["name"]
    architecture = import_architecture(arch_name)
    hypers = merge_architecture_hypers(arch_name, {
        "model": options["architecture"]["model"],
        "training": options["architecture"]["training"],
    })

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
    test_datasets: list = []
    if isinstance(val_conf, (int, float)):
        test_fraction = float(test_conf) if isinstance(test_conf, (int, float)) else 0.0
        split_trains = []
        for dataset in train_datasets:
            train_part, val_part, test_part = train_val_test_split(
                dataset, val_fraction=float(val_conf), test_fraction=test_fraction, seed=seed,
            )
            split_trains.append(train_part)
            val_datasets.append(val_part)
            test_datasets.append(test_part)
        train_datasets = split_trains
    else:
        for conf in val_conf if isinstance(val_conf, list) else [val_conf]:
            val_datasets.append(get_dataset(conf)[0])
        if not isinstance(test_conf, (int, float)):
            for conf in test_conf if isinstance(test_conf, list) else [test_conf]:
                test_datasets.append(get_dataset(conf)[0])

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

    # ---- model + trainer (fresh / restart / finetune) --------------------
    finetune_path = (hypers["training"].get("finetune") or {}).get("read_from")
    load = {"device": device, "compute_dtype": compute_dtype, "fused_gnn": fused_gnn}
    if restart_from is not None:
        logger.info("Restarting training from %s", restart_from)
        checkpoint = load_checkpoint_file(restart_from)
        model = model_from_checkpoint(checkpoint, context="restart", **load)
        model = model.restart(dataset_info)
        trainer = trainer_from_checkpoint(checkpoint, hypers["training"], context="restart")
    elif finetune_path:
        logger.info("Finetuning from %s", finetune_path)
        model = model_from_checkpoint(finetune_path, context="finetune", **load)
        model = model.restart(dataset_info)
        trainer = architecture.__trainer__(hypers["training"])
    else:
        model = architecture.__model__(hypers["model"], dataset_info,
                                       compute_dtype=compute_dtype, fused_gnn=fused_gnn)
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

    from .export import export_model_object

    export_path = Path(output_dir) / output_name
    export_model_object(model, trainer, str(export_path))
    logger.info("Exported model to %s", export_path)

    # ---- final evaluation of the train, validation and test sets ------------
    from .eval import evaluate_datasets

    for split_name, datasets in (("train", train_datasets), ("validation", val_datasets),
                                 ("test", test_datasets)):
        for i, dataset in enumerate(datasets):
            if not len(dataset):
                continue
            tag = f" #{i}" if len(datasets) > 1 else ""
            metrics = evaluate_datasets(model, dataset, dataset_info)
            for key, value in metrics.items():
                logger.info("%s%s %s: %.6g", split_name, tag, key, value)
    return model, trainer


def find_latest_checkpoint(outputs_root: str = "outputs") -> Optional[str]:
    """``--restart auto``: the most recently modified ``outputs/*/*/*.ckpt``."""
    candidates = sorted(Path(outputs_root).glob("*/*/*.ckpt"), key=lambda p: p.stat().st_mtime)
    return str(candidates[-1]) if candidates else None
