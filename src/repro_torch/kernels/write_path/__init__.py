"""Fused fast-path write (invalidate + append + map repoint)."""
