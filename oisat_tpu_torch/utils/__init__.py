"""Host utilities of the port: copies of :mod:`oisat_tpu.utils` modules
(``lru``) and the stage clock (``stages``)."""
