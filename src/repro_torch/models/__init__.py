"""Model stack of the port, the transformer families (dense, moe, vlm,
audio); counterpart of `repro.models`. Import submodules directly
(`repro_torch.models.model`, `.transformer`, `.attention`, `.moe`,
`.layers`, `.inputs`, `.param`)."""
from .model import Model, build

__all__ = ["Model", "build"]
