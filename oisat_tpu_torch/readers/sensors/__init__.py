"""Per-sensor readers of the port (twin of :mod:`oisat_tpu.readers.sensors`)."""
