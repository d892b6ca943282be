"""Quantization subsystem of the port. Ported so far: the dedup
``ragged_gather`` the serving top-k gathers user rows with. The int8
serving tables (``quant/table.py``) wait for a later slice."""

from .ragged import ragged_gather

__all__ = ["ragged_gather"]
