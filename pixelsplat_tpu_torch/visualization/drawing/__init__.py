"""Antialiased vector drawing on (3, h, w) image tensors."""
