"""The NN training loop, on one device.

Counterpart of ``metatrain_tpu/engine/trainer.py``: fit the baselines
(composition, then the scaler on the baseline-removed targets) -> the
collate pipeline with O3 augmentation and baseline removal -> training
steps with forces through the loss (second order through the kernels'
``autograd.Function``s) -> epoch metrics -> best-model tracking ->
checkpoints in the JAX package's format.

The optax chain of the JAX package becomes ``torch.optim.Adam`` (or
``AdamW`` when ``weight_decay`` is set) behind optax's global-norm clip,
with the learning rate of ``optax.warmup_cosine_decay_schedule`` set
before every step at the number of updates done so far, as optax
evaluates it. A restarted trainer (``load_checkpoint``) carries on from
its epoch, best model and optimizer state: ``opt_state`` holds the torch
optimizer's ``state_dict`` as numpy, and its step count is the schedule's.
Not ported yet, and refused: data parallelism and the ``heads``/``lora``
finetuning methods.
"""

from __future__ import annotations

import copy
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..containers import TensorMap
from ..data.collate import Batch, CollateFn
from ..data.dataset import dataset_target_names
from ..data.samplers import (
    BatchSampler,
    CombinedDataLoader,
    DataLoader,
    MaxAtomBatchSampler,
    PrefetchingLoader,
)
from ..models.composition import train_or_load_composition_model
from ..models.scaler import train_or_load_scaler
from ..ops.inference import no_param_grads
from ..ops.segment import average_by_num_atoms
from ..utils.io import save_checkpoint_file, to_numpy_tree
from ..utils.logging import ROOT_LOGGER, CSVMetricsWriter, MetricLogger
from .evaluate import evaluate_model
from .loss import LossAggregator
from .metrics import ErrorAccumulator, batch_errors, get_selected_metric

logger = logging.getLogger(ROOT_LOGGER + ".trainer")


DEFAULT_TRAINER_HYPERS: Dict[str, Any] = {
    "batch_size": 16,
    "num_epochs": 100,
    "warmup_fraction": 0.01,
    "learning_rate": 1e-4,
    "weight_decay": None,
    "log_interval": 1,
    "checkpoint_interval": 100,
    "scale_targets": True,
    "atomic_baseline": {},
    "fixed_scaling_weights": {},
    "per_structure_targets": [],
    "log_mae": True,
    "log_separate_blocks": False,
    "best_model_metric": "mae_prod",
    "grad_clip_norm": 1.0,
    "loss": "mse",
    "max_atoms_per_batch": None,
    "min_atoms_per_batch": 0,
    "seed": 0,
    "o3_augmentation": True,
    "data_parallel": "auto",
    "finetune": {
        "read_from": None,
        "method": "full",
        "config": {},
        "inherit_heads": {},
    },
}


def _validate_species_weight_map(spec: Any, what: str) -> None:
    """Per-target weight maps: ``{target: scalar}`` or ``{target:
    {atomic_number: value}}`` with integer species keys and numeric values.
    A string (a checkpoint path to load) passes through."""
    if not spec or isinstance(spec, str):
        return
    if not isinstance(spec, dict):
        raise ValueError(f"'{what}' must be a mapping, got {type(spec).__name__}")
    for target, value in spec.items():
        if isinstance(value, dict):
            for z, weight in value.items():
                if isinstance(z, bool) or not isinstance(z, int):
                    try:
                        int(str(z))
                    except ValueError:
                        raise ValueError(
                            f"'{what}' for target '{target}': species keys "
                            f"must be atomic numbers (integers), got {z!r}"
                        ) from None
                if not isinstance(weight, (int, float)):
                    raise ValueError(
                        f"'{what}' for target '{target}': value for species "
                        f"{z} must be a number, got {type(weight).__name__}"
                    )
        elif not isinstance(value, (int, float)) or isinstance(value, bool):
            raise ValueError(
                f"'{what}' for target '{target}' must be a number or a "
                f"{{atomic_number: value}} mapping, got {type(value).__name__}"
            )


def warmup_cosine_decay(step: int, peak: float, warmup_steps: int, decay_steps: int,
                        dtype=np.float32) -> float:
    """``optax.warmup_cosine_decay_schedule(init_value=0, peak_value=peak,
    warmup_steps, decay_steps)`` at ``step``: linear from 0 over the
    warmup, then cosine decay to 0 at ``decay_steps``.

    Rounded as optax computes it: at the optimizer's int32 update count
    (``dtype=np.float32``) the warmup runs in float32 and the cosine in
    float64, rounded to float32; at a Python int (``np.float64``, the
    logged rate) everything is float64."""
    if step < warmup_steps:
        frac = dtype(1.0) - dtype(max(step, 0)) / dtype(warmup_steps)
        return float(dtype(-peak) * frac + dtype(peak))
    span = decay_steps - warmup_steps
    count = min(step - warmup_steps, span)
    return float(dtype(peak * (0.5 * (1.0 + math.cos(math.pi * count / span)))))


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``: gradients untouched below
    ``max_norm``, else ``g / norm * max_norm`` (no epsilon)."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if norm < max_norm:
        return
    for g in grads:
        g.copy_(g / norm.to(g.dtype) * max_norm)


def train_step(params: List[torch.Tensor], optimizer, loss_and_errors, batch, learning_rate: float,
               max_norm: float):
    """One optimizer step: the loss and its gradients (through the forces),
    optax's global-norm clip, the learning rate of this step, Adam."""
    optimizer.zero_grad(set_to_none=True)
    loss, errors = loss_and_errors(batch, is_training=True)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_(params, max_norm)
    for group in optimizer.param_groups:
        group["lr"] = learning_rate
    optimizer.step()
    return loss.detach(), errors


def make_optimizer(params: List[torch.Tensor], weight_decay: Optional[float]):
    """``optax.adam`` (eps 1e-8, eps_root 0), or ``optax.adamw`` when
    ``weight_decay`` is set; the learning rate is set before every step."""
    if weight_decay:
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def load_optimizer_state(optimizer, opt_state) -> int:
    """Load ``opt_state`` (a torch optimizer's ``state_dict`` as numpy, as
    :meth:`NNTrainer.save_checkpoint` writes it) into ``optimizer`` on its
    parameters' device; returns the updates done so far."""
    if not (isinstance(opt_state, dict) and set(opt_state) == {"state", "param_groups"}):
        raise ValueError(
            "the checkpoint's optimizer state is not a torch optimizer's (a checkpoint of "
            "the JAX package holds optax's): restart from a checkpoint the port wrote, or "
            "start a new run from this one with architecture.training.finetune.read_from"
        )
    state = {
        int(index): {
            key: torch.tensor(float(value), dtype=torch.float32) if key == "step"
            else torch.from_numpy(np.array(value))
            for key, value in entry.items()
        }
        for index, entry in opt_state["state"].items()
    }
    optimizer.load_state_dict({"state": state,
                               "param_groups": copy.deepcopy(opt_state["param_groups"])})
    return max((int(entry["step"]) for entry in state.values()), default=0)


class NNTrainer:
    """Gradient-descent trainer shared by the NN architectures."""

    __checkpoint_version__ = 1
    DEFAULT_HYPERS = DEFAULT_TRAINER_HYPERS

    def __init__(self, hypers: Optional[Dict[str, Any]] = None):
        full = copy.deepcopy(self.DEFAULT_HYPERS)
        full.update(hypers or {})
        self.hypers = full
        _validate_species_weight_map(full["atomic_baseline"], "atomic_baseline")
        _validate_species_weight_map(full.get("fixed_scaling_weights", {}), "fixed_scaling_weights")
        self.epoch: int = 0
        self.opt_state: Any = None
        self.best_metric: float = float("inf")
        self.best_params: Any = None
        self.best_epoch: Optional[int] = None

    def train(self, model, dtype, train_datasets: List, val_datasets: List,
              checkpoint_dir: str = ".") -> None:
        """Train ``model`` (on the device its parameters are on)."""
        hp = self.hypers
        checkpoint_dir = Path(checkpoint_dir)
        target_infos = dict(model.dataset_info.targets)
        device = next(model.parameters()).device

        if hp["data_parallel"] is True:
            raise NotImplementedError(
                "data-parallel training is not ported yet (set data_parallel: false or auto)"
            )
        finetune = hp.get("finetune") or {}
        method = finetune.get("method", "full")
        if method in ("heads", "lora") or finetune.get("inherit_heads"):
            raise NotImplementedError(f"finetuning method {method!r} is not ported yet")
        if method != "full":
            raise ValueError(f"unknown finetuning method {method!r}")

        # ---- baselines: composition fit + target scaling ----------------
        atomic_baseline = hp["atomic_baseline"]
        composition = train_or_load_composition_model(
            atomic_baseline if isinstance(atomic_baseline, str) else None,
            model.dataset_info, train_datasets,
            fixed_weights=None if isinstance(atomic_baseline, str) else (atomic_baseline or None),
        )
        baseline_transforms = [composition.remove_transform]
        if model.zbl is not None:  # the ZBL baseline comes off after composition's
            baseline_transforms.append(model.zbl.remove_transform)
        removed_datasets = [_RemovedView(ds, baseline_transforms) for ds in train_datasets]
        fixed_scaling = hp["fixed_scaling_weights"]
        scaler = train_or_load_scaler(
            fixed_scaling if isinstance(fixed_scaling, str) else None,
            model.dataset_info, removed_datasets,
            fixed_scales=None if isinstance(fixed_scaling, str) else (fixed_scaling or None),
            enabled=hp["scale_targets"],
        )
        model.composition = composition
        model.scaler = scaler

        # ---- data pipeline ----------------------------------------------
        removal_transforms = baseline_transforms + [scaler.remove_transform]
        train_transforms = list(removal_transforms)
        if hp["o3_augmentation"]:
            from .augmentation import O3Augmenter

            # augment before removal: gradient blocks rotate before scaling
            train_transforms = [O3Augmenter(seed=hp["seed"])] + train_transforms
        cutoff = model.requested_neighbor_cutoff() or 5.0
        extra_keys = model.requested_extra_system_keys()
        train_collate = CollateFn(cutoff, target_infos, dtype=dtype, device=device,
                                  extra_system_keys=extra_keys, transforms=train_transforms)
        val_collate = CollateFn(cutoff, target_infos, dtype=dtype, device=device,
                                extra_system_keys=extra_keys, transforms=removal_transforms)
        # host collation in a background thread, ahead of the steps
        train_loader = PrefetchingLoader(
            _build_loader(train_datasets, train_collate, hp, shuffle=True))
        val_loader = PrefetchingLoader(
            _build_loader(val_datasets, val_collate, hp, shuffle=False))

        # ---- parameters & optimizer ----------------------------------------
        if not model.weights_initialized:
            model.init_weights(torch.Generator().manual_seed(int(hp["seed"])))
        params = [p for p in model.parameters() if p.requires_grad]
        steps_per_epoch = max(len(train_loader), 1)
        total_steps = steps_per_epoch * hp["num_epochs"]
        warmup_steps = max(int(hp["warmup_fraction"] * total_steps), 1)
        decay_steps = max(total_steps, 2)

        def schedule(step: int, dtype=np.float32) -> float:
            return warmup_cosine_decay(step, hp["learning_rate"], warmup_steps, decay_steps, dtype)

        optimizer = make_optimizer(params, hp["weight_decay"])
        self.optimizer = optimizer
        steps_done = 0 if self.opt_state is None else load_optimizer_state(optimizer,
                                                                           self.opt_state)

        loss_agg = LossAggregator(target_infos, hp["loss"])
        per_structure = list(hp["per_structure_targets"])
        # metrics in physical units: each block's own scales, (R, P) with a
        # row per atomic type for per-atom targets (each atom's row, where
        # the JAX package takes the first type's for every atom)
        scales = {name: [torch.as_tensor(rows, device=device) for rows in blocks]
                  for name, blocks in scaler.scales.items()}

        def loss_and_errors(batch: Batch, is_training: bool):
            return _compute_loss_and_errors(model, loss_agg, target_infos, per_structure,
                                            scales, batch, is_training)

        metric_logger = MetricLogger(logger, CSVMetricsWriter(checkpoint_dir / "train.csv"))
        not_per_atom = ["positions_gradients", "strain_gradients"] + per_structure
        shown = ("RMSE", "MAE") if hp["log_mae"] else ("RMSE",)

        start_epoch = self.epoch
        for epoch in range(start_epoch, hp["num_epochs"]):
            self.epoch = epoch
            train_loader.set_epoch(epoch)
            epoch_start = time.time()

            # losses and errors stay on the device during the epoch; one
            # host read at its end
            train_errors = ErrorAccumulator(hp["log_separate_blocks"])
            losses, errors_list = [], []
            for batch in train_loader:
                loss, errors = train_step(params, optimizer, loss_and_errors, batch,
                                          schedule(steps_done), hp["grad_clip_norm"])
                steps_done += 1
                losses.append(loss)
                errors_list.append(errors)
            n_batches = len(losses)
            train_loss_sum = float(torch.stack(losses).sum()) if losses else 0.0
            for errors in errors_list:
                train_errors.update_from_errors(errors)

            val_errors = ErrorAccumulator(hp["log_separate_blocks"])
            losses, errors_list = [], []
            with no_param_grads(model):
                for batch in val_loader:
                    loss, errors = loss_and_errors(batch, is_training=False)
                    losses.append(loss.detach())
                    errors_list.append(errors)
            n_val = len(losses)
            val_loss_sum = float(torch.stack(losses).sum()) if losses else 0.0
            for errors in errors_list:
                val_errors.update_from_errors(errors)

            metrics: Dict[str, float] = {"train loss": train_loss_sum / max(n_batches, 1)}
            if n_val:
                metrics["val loss"] = val_loss_sum / max(n_val, 1)
            for key, value in train_errors.finalize(not_per_atom, shown).items():
                metrics[f"train {key}"] = value
            val_finalized = val_errors.finalize(not_per_atom, shown)
            for key, value in val_finalized.items():
                metrics[f"val {key}"] = value
            metrics["epoch time (s)"] = time.time() - epoch_start
            self.last_metrics = metrics

            if epoch == start_epoch or epoch % hp["log_interval"] == 0:
                metric_logger.log(epoch, metrics,
                                  learning_rate=schedule(epoch * steps_per_epoch, np.float64))

            selection_pool = dict(val_finalized)
            selection_pool["loss"] = metrics.get("val loss", metrics["train loss"])
            selected = get_selected_metric(selection_pool, hp["best_model_metric"])
            if selected < self.best_metric:
                from ..interop.jax_params import state_dict_to_flax

                self.best_metric = selected
                self.best_params = state_dict_to_flax(model.module)
                self.best_epoch = epoch

            if hp["checkpoint_interval"] and (epoch + 1) % hp["checkpoint_interval"] == 0:
                # the snapshot records the NEXT epoch to run
                self.epoch = epoch + 1
                self.save_checkpoint(model, checkpoint_dir / f"model_{epoch + 1}.ckpt")
                self.epoch = epoch

        self.epoch = hp["num_epochs"]

    # -- checkpointing ---------------------------------------------------------

    def save_checkpoint(self, model, path) -> None:
        """The model's checkpoint (the JAX package's layout) plus the
        trainer state; ``opt_state`` holds the torch optimizer's state."""
        checkpoint = model.get_checkpoint()
        optimizer = getattr(self, "optimizer", None)
        checkpoint.update({
            "trainer_ckpt_version": self.__checkpoint_version__,
            "train_hypers": copy.deepcopy(self.hypers),
            "epoch": self.epoch,
            "opt_state": (to_numpy_tree(optimizer.state_dict()) if optimizer is not None
                          else self.opt_state),
            "best_metric": self.best_metric,
            "best_params": self.best_params,
            "best_epoch": self.best_epoch,
            "lora_adapters": None,
        })
        save_checkpoint_file(checkpoint, path)

    @classmethod
    def load_checkpoint(cls, checkpoint: Dict[str, Any], hypers: Dict[str, Any]) -> "NNTrainer":
        trainer = cls(hypers)
        trainer.epoch = checkpoint.get("epoch", 0)
        trainer.opt_state = checkpoint.get("opt_state")
        trainer.best_metric = checkpoint.get("best_metric", float("inf"))
        trainer.best_params = checkpoint.get("best_params")
        trainer.best_epoch = checkpoint.get("best_epoch")
        return trainer


# -- helpers --------------------------------------------------------------------


class _RemovedView:
    """Lazy per-sample baseline removal (for the scaler fit)."""

    def __init__(self, dataset, transforms):
        self.base = dataset
        self.transforms = list(transforms)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index: int):
        samples = [self.base[index]]
        for transform in self.transforms:
            samples = transform(samples)
        return samples[0]

    @property
    def atom_counts(self):
        return self.base.atom_counts

    @property
    def target_names(self):
        return dataset_target_names(self.base)


def _build_loader(datasets: List, collate: CollateFn, hp: Dict[str, Any], shuffle: bool):
    loaders = []
    for i, dataset in enumerate(datasets):
        if hp["max_atoms_per_batch"]:
            sampler = MaxAtomBatchSampler(
                dataset.atom_counts, hp["max_atoms_per_batch"],
                min_atoms=hp["min_atoms_per_batch"], shuffle=shuffle, seed=hp["seed"] + i,
            )
        else:
            sampler = BatchSampler(len(dataset), hp["batch_size"], shuffle=shuffle,
                                   seed=hp["seed"] + i)
        loaders.append(DataLoader(dataset, sampler, collate))
    if len(loaders) == 1:
        return loaders[0]
    return CombinedDataLoader(loaders, shuffle=shuffle, seed=hp["seed"])


def _unscale(tmap: TensorMap, block_scales, species_index: torch.Tensor) -> TensorMap:
    """``tmap`` times its blocks' scales: a (P,) or (1, P) scale on the last
    axis, an (R, P) one with R > 1 (a per-atom target's rows by atomic
    type) by the row of each atom's type (``species_index``)."""
    blocks = []
    for block, scale in zip(tmap.blocks(), block_scales):
        if scale.ndim == 2 and scale.shape[0] > 1:
            rows = scale[species_index]  # (A, P)

            def by_row(v, rows=rows):
                return v * rows.reshape(rows.shape[:1] + (1,) * (v.ndim - 2)
                                        + rows.shape[1:]).to(v.dtype)

            blocks.append(block.map_values(by_row))
        else:
            blocks.append(block.map_values(lambda v, s=scale.reshape(-1): v * s.to(v.dtype)))
    return TensorMap(tmap.keys, blocks)


def _compute_loss_and_errors(model, loss_agg, target_infos, per_structure, scales,
                             batch: Batch, is_training: bool):
    """One batch's loss (a graph back to the weights when training) and
    its metric sums in physical units."""
    infos = {n: target_infos[n] for n in batch.targets}
    predictions = evaluate_model(model.forward, batch.systems, infos, is_training=is_training)
    predictions = average_by_num_atoms(predictions, batch.systems, per_structure)
    targets = average_by_num_atoms(batch.targets, batch.systems, per_structure)
    loss = loss_agg(predictions, targets, batch.extra_data)
    with torch.no_grad():
        species = model.species_index(batch.systems)
        errors = batch_errors(
            {n: _unscale(t, scales[n], species) if n in scales else t
             for n, t in predictions.items()},
            {n: _unscale(t, scales[n], species) if n in scales else t
             for n, t in targets.items()},
            batch.extra_data,
        )
    return loss, errors
