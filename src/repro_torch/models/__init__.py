"""Model stack of the port, dense text family so far; counterpart of
`repro.models`. Import submodules directly (`repro_torch.models.model`,
`.transformer`, `.attention`, `.layers`, `.inputs`, `.param`)."""
from .model import Model, build

__all__ = ["Model", "build"]
