"""Post-processing tools of the port (twins of ``tools/*.py``)."""
