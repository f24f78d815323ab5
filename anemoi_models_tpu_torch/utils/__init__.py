from anemoi_models_tpu_torch.utils.config import DotDict, instantiate, resolve_target

__all__ = ["DotDict", "instantiate", "resolve_target"]
