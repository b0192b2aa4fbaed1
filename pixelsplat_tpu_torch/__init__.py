"""pixelSplat's evaluation path in PyTorch, with CUDA kernels for Hopper.

The port of `pixelsplat_tpu` (the JAX package, kept beside it as the
reference). It mirrors that package file for file; each module names the
file it ports. Entry points run on the card (`device="cuda"`) unless the
caller asks for the CPU; with no GPU they raise rather than fall back.
Kernels are built with nvcc on first use (`kernel_build.py`), never at
import.
"""
