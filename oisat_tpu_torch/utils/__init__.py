"""Host utilities of the port: copies of :mod:`oisat_tpu.utils` modules
(``lru``) and the tracing module (``profiling``: stage sums, spans,
counters and the stage clock)."""
