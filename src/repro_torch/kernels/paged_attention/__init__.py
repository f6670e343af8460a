"""Paged decode attention over the Wolf-KV block pool."""
