"""Batched per-level device operations of the port."""
