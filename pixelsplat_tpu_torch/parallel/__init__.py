"""Port of `pixelsplat_tpu/parallel`: one process per GPU over a
`torch.distributed` process group. Importing it creates no group."""
