"""The port's models: the dense LM stack (layers, transformer, ``Model``)
and the GCN / GAT node classifiers (``models.gnn``)."""
from repro_torch.models.model import Model  # noqa: F401
