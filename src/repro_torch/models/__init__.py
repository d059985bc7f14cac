"""The dense LM stack of the port (layers, transformer, ``Model``)."""
from repro_torch.models.model import Model  # noqa: F401
