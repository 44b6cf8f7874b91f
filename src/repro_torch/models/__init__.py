"""Model substrate: all six architecture families in PyTorch, with the
tensor-parallel forward of a mesh's model axes (``models/dist.py``)."""
from repro_torch.models.model import Model  # noqa: F401
