"""The model zoo (twin of ``repro.models``): ``Model`` over plain
parameter dicts, its ``Runtime`` knobs and ``build_model``."""
from repro_torch.models.model import Model, Runtime, build_model

__all__ = ["Model", "Runtime", "build_model"]
