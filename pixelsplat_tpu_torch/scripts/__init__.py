"""Runnable scripts of the port (`python -m pixelsplat_tpu_torch.scripts.<name>`)."""
