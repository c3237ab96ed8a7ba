from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
