"""Kernel-backed ops of the port: each module holds a CUDA kernel's
wrapper (with its launch counter) and the plain PyTorch version of the
same function.  Kernels build on first use (`_build.py`), never at
import."""
