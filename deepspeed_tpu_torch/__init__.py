"""PyTorch/CUDA port of the deepspeed_tpu serving path.

The JAX package `deepspeed_tpu` is the reference; this package keeps its
module layout and names (`models/transformer.py`, `ops/paged_attention.py`,
`inference/v2/engine_v2.py`, ...) so each module's counterpart is easy to
find.  It imports `torch` and never `jax`.  The attention kernels are
hand-written CUDA C++ for Hopper (`csrc/*.cu`), built with `nvcc` on first
use (`ops/_build.py`); each wrapper also keeps a plain PyTorch version of
the same function, used for tensors on the CPU and as the kernel's check.

Entry points: `inference.v2.build_engine(arch, size, device="cuda")` and
`InferenceEngineV2.put / step / generate_batch`.
"""
__version__ = "0.1.0"
