"""Fused 8-bit Adam: one pass per leaf over gradient, codes and master.

Counterpart of `deepspeed_tpu/ops/fused_adam8.py` (`fused_adam8_leaf`,
the TPU kernel at its `pallas_call`).  One hand-written CUDA kernel for
sm_90a (`csrc/fused_adam8.cu`), bound with ctypes: it decodes the int8 m
and log-coded uint8 v of a leaf, takes the Adam/AdamW step in f32, writes
the new master and its cast to the compute dtype, takes each row's exact
absmax of the new moments and writes their new codes and scales.  The
f32 m_new / v_new never reach device memory: each row stays in shared
memory between the update and the requantization (or is recomputed when
it does not fit).

`fused_adam8_leaf_reference` is the plain PyTorch version of the same
function (`runtime/optimizers.adam8_leaf` plus the cast); the wrapper runs
it for tensors on the CPU and launches the kernel, or raises, for tensors
on a CUDA device.

The leaf is read as [rows, R] with R its last dim (the quantization row),
any R >= 1; the JAX package's lane and row-count rule for which leaves
the kernel takes is a TPU tiling constraint and has no counterpart here:
every leaf with ndim >= 1 goes to the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_adam8_leaf", "fused_adam8_leaf_reference"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P,) * 13 + (ctypes.c_longlong, _I) + (_F,) * 9 + (_I, _I, _P)
_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_adam8_leaf_reference(g, m_q, m_s, v_q, v_s, p, lr, gscale, c1, c2,
                               *, b1, b2, eps, wd, adam_w,
                               bias_correction=True,
                               out_dtype=torch.bfloat16):
    """Plain PyTorch version: (p_new f32, p_new cast to `out_dtype`, m
    codes, m scales, v codes, v scales).  Without bias correction c1 and
    c2 are taken as 1."""
    from ..runtime.optimizers import adam8_leaf
    if not bias_correction:
        c1 = c2 = 1.0
    p_new, mq, ms, vq, vs = adam8_leaf(
        g, m_q, m_s, v_q, v_s, p, lr, c1, c2, b1=b1, b2=b2, eps=eps, wd=wd,
        adam_w=adam_w, gscale=gscale)
    return p_new, p_new.to(out_dtype), mq, ms, vq, vs


def _check(g, m_q, m_s, v_q, v_s, p, gscale, out):
    shape = p.shape
    rows = p.numel() // shape[-1]
    if p.dtype != torch.float32:
        raise TypeError(f"master dtype {p.dtype} (kernel takes f32)")
    if g.dtype not in _GRAD_DTYPES:
        raise TypeError(f"gradient dtype {g.dtype} (kernel takes f32 or "
                        f"bf16)")
    if m_q.dtype != torch.int8 or v_q.dtype != torch.uint8:
        raise TypeError(f"codes must be int8 (m) and uint8 (v), got "
                        f"{m_q.dtype}, {v_q.dtype}")
    if out[1].dtype not in _OUT_DTYPES:
        raise TypeError(f"cast dtype {out[1].dtype} (kernel writes f32 or "
                        f"bf16)")
    for name, t in (("g", g), ("m_q", m_q), ("v_q", v_q), ("p_out", out[0]),
                    ("cast_out", out[1]), ("m_q_out", out[2]),
                    ("v_q_out", out[4])):
        if t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != master "
                             f"{tuple(shape)}")
    for name, t in (("m_s", m_s), ("v_s", v_s), ("m_s_out", out[3]),
                    ("v_s_out", out[5])):
        if t.numel() != rows or t.dtype != torch.float32:
            raise ValueError(f"{name} must hold {rows} f32 row scales, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if gscale.numel() != 1 or gscale.dtype != torch.float32:
        raise ValueError("gscale must be one f32 value")
    for name, t in (("g", g), ("m_q", m_q), ("m_s", m_s), ("v_q", v_q),
                    ("v_s", v_s), ("p", p), ("gscale", gscale),
                    *zip(("p_out", "cast_out", "m_q_out", "m_s_out",
                          "v_q_out", "v_s_out"), out)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, the master on "
                             f"{p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_adam8_leaf(g, m_q, m_s, v_q, v_s, p, lr, gscale, c1, c2, *,
                     b1: float, b2: float, eps: float, wd: float,
                     adam_w: bool, bias_correction: bool = True,
                     out_dtype=torch.bfloat16, out=None):
    """One leaf's fused 8-bit Adam step (ndim >= 1).

    `gscale` folds the engine's unscale and clip factor into the gradient:
    a 0-d f32 tensor on the leaf's device, read by the kernel from device
    memory (no host sync), or a Python float.  `lr`, `c1` and `c2` are
    host floats.  Returns (p_new f32, p_new cast, m codes, m scales, v
    codes, v scales); with `out` (six tensors in that order, which may be
    the inputs themselves) the results are written there and `out` is
    returned."""
    if p.dim() < 1:
        raise ValueError("fused_adam8_leaf takes leaves with ndim >= 1")
    if p.device.type == "cpu":
        res = fused_adam8_leaf_reference(
            g, m_q, m_s, v_q, v_s, p, lr, gscale, c1, c2, b1=b1, b2=b2,
            eps=eps, wd=wd, adam_w=adam_w, bias_correction=bias_correction,
            out_dtype=out[1].dtype if out is not None else out_dtype)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src.view(dst.shape))
        return out
    if p.device.type != "cuda":
        raise ValueError(f"no fused 8-bit Adam kernel for device {p.device}")
    if not isinstance(gscale, torch.Tensor):
        gscale = torch.tensor(float(gscale), dtype=torch.float32,
                              device=p.device)
    if out is None:
        out = (torch.empty_like(p), torch.empty_like(p, dtype=out_dtype),
               torch.empty_like(m_q), torch.empty_like(m_s),
               torch.empty_like(v_q), torch.empty_like(v_s))
    _check(g, m_q, m_s, v_q, v_s, p, gscale, out)
    R = p.shape[-1]
    rows = p.numel() // R
    if not bias_correction:
        c1 = c2 = 1.0
    fn = _build.function("fused_adam8", "dstt_fused_adam8", _ARGS)
    rc = fn(g.data_ptr(), m_q.data_ptr(), m_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), p.data_ptr(), gscale.data_ptr(),
            *(t.data_ptr() for t in out), rows, R, float(lr), float(c1),
            float(c2), float(b1), 1.0 - float(b1), float(b2),
            1.0 - float(b2), float(eps), float(wd), int(bool(adam_w)),
            _GRAD_DTYPES[g.dtype] | (_OUT_DTYPES[out[1].dtype] << 1),
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "fused 8-bit Adam")
    fused_adam8_leaf.launches += 1
    return out


fused_adam8_leaf.launches = 0
