"""Runnable examples of the port (twins of ``examples/*.py``)."""
