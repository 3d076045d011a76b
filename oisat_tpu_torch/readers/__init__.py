"""Product readers of the port (twin of :mod:`oisat_tpu.readers`): the
``readers`` facade over the CTM readers and the per-sensor fleet readers."""

from oisat_tpu_torch.readers.facade import readers

__all__ = ["readers"]
