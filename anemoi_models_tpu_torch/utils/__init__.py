from anemoi_models_tpu_torch.utils.config import DotDict, as_dotdict, instantiate, register, resolve_target

__all__ = ["DotDict", "as_dotdict", "instantiate", "register", "resolve_target"]
