"""PyTorch/CUDA port of deepspeed_tpu: the serving and training paths.

The JAX package `deepspeed_tpu` is the reference; this package keeps its
module layout and names (`models/transformer.py`, `ops/flash_attention.py`,
`inference/v2/engine_v2.py`, `runtime/engine.py`, ...) so each module's
counterpart is easy to find.  It imports `torch` and never `jax`.  The
kernels are hand-written CUDA C++ for Hopper (`csrc/*.cu`),
built with `nvcc` on first use (`ops/_build.py`); each wrapper also keeps
a plain PyTorch version of the same function, used for tensors on the CPU
and as the kernel's check.

Entry points:
- serving: `inference.v2.build_engine(arch, size, device="cuda")` and
  `InferenceEngineV2.put / step / generate_batch`, with multi-tenant LoRA
  adapters through `serving.tenancy.AdapterPool` and `set_adapter`, MoE
  models (mixtral, qwen2_moe) with expert paging through
  `enable_expert_paging` (`serving.experts.ExpertPool`), and
  tensor-parallel over several cards (`comm.init_distributed` in every
  rank, then `RaggedInferenceEngineConfig(tensor_parallel_size=N,
  tp_collectives="fused")`);
- training: `initialize(model=models.Transformer(gpt2_config(...)),
  config={...})` and `TrainEngine.train_batch(batch)`.
"""
from .models import Transformer, gpt2_config
from .runtime.engine import TrainEngine, initialize

__all__ = ["initialize", "TrainEngine", "Transformer", "gpt2_config"]

__version__ = "0.3.0"
