from .model import DEFAULT_MODEL_HYPERS, PET

__all__ = ["DEFAULT_MODEL_HYPERS", "PET"]
