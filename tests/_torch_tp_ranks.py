"""Rank functions of the port's tensor-parallel tests
(tests/test_torch_port_tp.py on gloo, tests/test_torch_port_cuda.py on
NCCL), and the greedy drive both sides of a comparison run.

Each rank runs in a process of its own, started by
`deepspeed_tpu_torch.comm.spawn_ranks`, so this module imports the PyTorch
port only: never `jax` or the JAX package (a spawned child imports the
module that holds its function).
"""
import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import TransformerConfig
from deepspeed_tpu_torch.ops import tp_matmul as tm


class _LoggedWork:
    """A P2P work whose wait() is written into the ring's event log."""

    def __init__(self, work, log):
        self.work, self.log = work, log

    def wait(self):
        self.log.append("wait")
        return self.work.wait()


def ring_block(rank, world, init, x, w1, w2, device="cpu"):
    """The tanh block of the reference's ring test on this rank's shards:
    fused ring and unfused twins.  Returns (fused rows, twin rows, the
    all-gather matmul's event log, the reduce-scatter matmul's)."""
    dev = comm.init_distributed(init, rank, world, device=device)
    tp = world
    s, f = x.shape[0] // tp, w1.shape[1] // tp

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    xl = on_dev(x[rank * s:(rank + 1) * s])
    w1l = on_dev(w1[:, rank * f:(rank + 1) * f])
    w2l = on_dev(w2[rank * f:(rank + 1) * f])
    log = []
    real = dist.batch_isend_irecv

    def hop(ops):
        log.append("hop")
        return [_LoggedWork(w, log) for w in real(ops)]

    def mm(w, cast):
        def run(c):
            log.append("mm")
            out = tm.tile_matmul(c, w)
            return out.to(c.dtype) if cast else out
        return run

    dist.batch_isend_irecv = hop
    try:
        y = tm.ag_matmul(xl, None, tp, mm(w1l, True))
        log_ag, log[:] = list(log), []
        fused = tm.matmul_rs(torch.tanh(y), None, tp, mm(w2l, False))
        log_rs = list(log)
    finally:
        dist.batch_isend_irecv = real
    y = tm.ag_matmul_xla(xl, None, tp, mm(w1l, True))
    twin = tm.matmul_rs_xla(torch.tanh(y), None, tp, mm(w2l, False))
    return fused.cpu().numpy(), twin.cpu().numpy(), log_ag, log_rs


def _drive(eng, prompts):
    """The greedy drive of the reference's tp parity test: prefill
    logits, a burst of 8, a verify dispatch of the reference's drafts
    (tokens, drafted and accepted counts), a continuation token's logits,
    then generate_batch chains on fresh uids."""
    o = eng.put([0, 1], [p.copy() for p in prompts])
    for u in (0, 1):
        eng.state.seqs[u].generated.append(int(np.argmax(o[u])))
    b = eng.decode_burst_step(n_steps=8, mode="greedy")
    drafts = {0: [int(t) for t in b[0][-3:]], 1: [int(b[1][-1])]}
    d = eng.decode_burst_step(drafts=drafts, draft_span=4, mode="greedy")
    verify = {u: (np.asarray(t).tolist(), int(n_d), int(n_a))
              for u, (t, n_d, n_a) in d.items()}
    n = eng.put([1], [np.asarray([5], np.int32)])
    for u in (0, 1):
        eng.flush(u)
    g = eng.generate_batch(prompts, max_new_tokens=8, first_uid=10)
    eng.audit_blocks()
    return dict(prefill=o, burst=b, verify=verify, cont=n,
                chains=[c.tolist() for c in g])


def engine(params, cfg_kw, engine_kw, device="cpu", **tp_kw):
    cfg = TransformerConfig(**cfg_kw)
    return InferenceEngineV2(cfg, params=params, device=device,
                             config=RaggedInferenceEngineConfig(
                                 **engine_kw, **tp_kw))


def serve_tp(rank, world, init, params, cfg_kw, engine_kw, prompts,
             device="cpu"):
    """A tp=`world` fused engine on this rank: the greedy drive, a
    per_row verify dispatch at temperature 0.9 from a generator seeded
    alike on every rank (the ranks must take the same decisions), then
    the refusals that need a built tensor-parallel engine."""
    comm.init_distributed(init, rank, world, device=device)
    eng = engine(params, cfg_kw, engine_kw, device=device,
                 tensor_parallel_size=world, tp_collectives="fused")
    tm.tile_matmul.launches = 0
    out = _drive(eng, prompts)
    out["tile_launches"] = tm.tile_matmul.launches
    out["arena"] = tuple(eng.arena["k"].shape)
    o = eng.put([20, 21], [p.copy() for p in prompts])
    for u in (20, 21):
        eng.state.seqs[u].generated.append(int(np.argmax(o[u])))
    gen = torch.Generator(device=eng.device).manual_seed(5)
    sampled = []
    for _ in range(3):
        d = eng.decode_burst_step(
            uids=[20, 21], mode="per_row", temperature={20: 0.9, 21: 0.9},
            top_k={20: 0, 21: 8}, rng=gen, draft_span=4,
            drafts={20: [1, 2, 3], 21: [int(eng.state.seqs[21].generated[-1])]})
        sampled.append({u: (np.asarray(t).tolist(), int(a))
                        for u, (t, _, a) in d.items()})
    out["sampled"] = sampled
    refused = {}
    for what, call in (
            ("attach_lora", lambda: eng.attach_lora(None)),
            ("read_kv_block", lambda: eng.read_kv_block(0)),
            ("write_kv_blocks", lambda: eng.write_kv_blocks([0], None, None))):
        try:
            call()
            refused[what] = None
        except NotImplementedError as e:
            refused[what] = str(e)
    out["refused"] = refused
    return out


def multistep_refused_tp(rank, world, init, params, cfg_kw, engine_kw,
                         device="cpu"):
    """A tp=`world` fused engine's answers on multi-step groups and
    seeded bursts: its supports_* flags and each refusal's message."""
    comm.init_distributed(init, rank, world, device=device)
    eng = engine(params, cfg_kw, engine_kw, device=device,
                 tensor_parallel_size=world, tp_collectives="fused")
    out = dict(supports=(eng.supports_multi_step,
                         eng.supports_seeded_sampling))
    for what, call in (
            ("multi_step", lambda: eng.decode_multi_step(k=4)),
            ("seeded", lambda: eng.decode_burst_step(
                mode="sample", seeds={0: 1}, seed_positions={0: 1}))):
        try:
            call()
            out[what] = None
        except RuntimeError as e:
            out[what] = str(e)
    return out
