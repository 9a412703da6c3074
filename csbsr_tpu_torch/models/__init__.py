from .build import CSBSRModel, model_from_cfg

__all__ = ["CSBSRModel", "model_from_cfg"]
