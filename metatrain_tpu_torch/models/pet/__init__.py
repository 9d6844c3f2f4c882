"""PET architecture: the model, its trainer and their default hypers."""

import copy

from ...engine.trainer import DEFAULT_TRAINER_HYPERS, NNTrainer
from .model import DEFAULT_MODEL_HYPERS, PET


class PETTrainer(NNTrainer):
    DEFAULT_HYPERS = copy.deepcopy(DEFAULT_TRAINER_HYPERS)


__model__ = PET
__trainer__ = PETTrainer

DEFAULT_HYPERS = {
    "model": copy.deepcopy(DEFAULT_MODEL_HYPERS),
    "training": copy.deepcopy(DEFAULT_TRAINER_HYPERS),
}

__all__ = ["DEFAULT_HYPERS", "DEFAULT_MODEL_HYPERS", "PET", "PETTrainer"]
