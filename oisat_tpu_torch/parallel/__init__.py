"""The end-to-end analysis steps (single device; the mesh-sharded makers of
:mod:`oisat_tpu.parallel` are ROADMAP queue 1 item 6 (multi-GPU))."""
