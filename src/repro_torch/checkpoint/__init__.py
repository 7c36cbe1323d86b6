"""Checkpoint save and restore: the port of ``repro.checkpoint``
(``checkpoint.py``, the same on-disk layout)."""
