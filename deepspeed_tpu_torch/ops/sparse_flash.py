"""Block-sparse flash attention, forward and backward, over a gather table.

Counterpart of `deepspeed_tpu/ops/sparse_flash.py`
(`block_sparse_flash_attention`, `block_sparse_flash_backward`,
`reverse_gather`).  Three hand-written CUDA kernels for sm_90a
(`csrc/sparse_flash.cu`), bound with ctypes:

- `block_sparse_flash_attention`: one CTA per (batch, head, q-block)
  walks its row of the gather table `kb_idx [H, nqb, A]` (ascending, -1
  padding last) up to the first -1 with an online softmax; out, and with
  `return_lse` the row logsumexp [B, H, nqb, block] f32;
- `block_sparse_flash_dq`: dq along the same table;
- `block_sparse_flash_dkv`: dk and dv, one CTA per (batch, head,
  key-block) walking the reverse table `rev [H, nkb, R]`
  (`reverse_gather`), summed in f32 and written once, no atomics.
`block_sparse_flash_backward` runs the two backward kernels.

The forward has two bf16 kernels, and `fwd_variant` names the one a call
takes ("wgmma", "mma", or "f32" for float32; the same rule as the
backward's); `block_sparse_flash_attention.launches_by_variant` counts
its launches per kernel:

- "wgmma" (D 64 and 128, block 16, 32, 64): TMA + wgmma over the gathered
  walk of the gather table (`fwd_walk`): a CTA owns 64 query rows (64 /
  block query blocks, the M side) and gathers 64 / block of the key
  blocks their lists hold a step (the N side), each entry's owner mask
  hiding the blocks an owner does not visit;
- "mma": one CTA per q-block through mma.sync (every other D and block).

The backward has two bf16 kernel pairs, and `bwd_variant` names the one a
call takes ("wgmma", "mma", or "f32" for float32); each wrapper counts
its launches per pair in `launches_by_variant`:

- "wgmma" (D 64 and 128, block 16, 32, 64): TMA + wgmma over a gathered
  tile plan (`bwd_plan`, `TileWalk`): a CTA owns 1-4 blocks whose lists
  are alike (the N side of the products) and gathers 64 rows of the
  blocks they visit a step (the M side), so padding stands only at a
  list's tail; both read delta from `block_sparse_flash_bwd_delta`,
  launched once a backward;
- "mma": mma.sync through registers, one CTA per block, delta computed
  inside (every other D and block).

The rule reads the dtype, D and block only: the wgmma pair was faster on
every layout of the on-card sweep (PERF.md), and chip_smoke phase 10's
pair gate holds it so on the card.

A row whose every key is masked gives out 0 and a finite lse (the TPU
kernel's -1e30 sentinel and re-mask), and then dq, dk and dv 0.

Each has a plain PyTorch version of the same function (`*_reference`,
f32 math over gathered copies of the active blocks; the backward from the
forward's residuals) that runs for tensors on the CPU; a tensor on a CUDA
device takes the kernel or an error.  The forward's plain version is also
the plain path of `sparse_attention.block_sparse_attention`, where
PyTorch's autograd differentiates it.  The kernels take bf16 (tensor
cores) or f32 (CUDA cores), blocks that are multiples of 8 up to 128 and
head dims 64, 128, 192 and 256 (the JAX gate's `D % 64 == 0`); other
shapes raise.

Layout is the JAX public one: q, k, v [B, S, H, D].
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = ["block_sparse_flash_attention", "block_sparse_flash_backward",
           "block_sparse_flash_dq", "block_sparse_flash_dkv",
           "block_sparse_flash_bwd_delta", "bwd_variant", "fwd_variant",
           "bwd_plan", "call_plan", "tile_walk", "fwd_walk", "TileWalk",
           "BwdPlan", "reverse_gather",
           "block_sparse_flash_attention_reference",
           "block_sparse_flash_backward_reference",
           "block_sparse_flash_dq_reference",
           "block_sparse_flash_dkv_reference",
           "block_sparse_flash_bwd_delta_reference", "NEG_INF"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 192, 256)
MAX_BLOCK = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = (_P,) * 6 + (_I,) * 7 + (_F, _I, _P)
_DQ_ARGS = (_P,) * 8 + (_I,) * 7 + (_F, _I, _P)
_DKV_ARGS = (_P,) * 9 + (_I,) * 7 + (_F, _I, _P)
_DELTA_ARGS = (_P,) * 3 + (_I,) * 4 + (_P,)
_DQ_WGMMA_ARGS = (_P,) * 9 + (_I,) * 8 + (_F, _P)
_DKV_WGMMA_ARGS = (_P,) * 10 + (_I,) * 8 + (_F, _P)
_FWD_WGMMA_ARGS = (_P,) * 7 + (_I,) * 7 + (_F, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the backward's kernel pairs and the forward's kernels (module docstring)
BWD_VARIANTS = ("wgmma", "mma", "f32")
FWD_VARIANTS = BWD_VARIANTS
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_BLOCKS = (16, 32, 64)
GATHER_ROWS = 64          # rows a gathered step fills (wgmma's M)
# owned blocks a CTA may take by block: N = block * R <= 64
OWNER_GROUPS = {16: (1, 2, 4), 32: (1, 2), 64: (1,)}
# relative time of one gathered step by N = block * R, from the on-card
# sweep (PERF.md): `tile_walk` picks the R of least steps * cost
STEP_COST = {16: 1.0, 32: 1.4, 64: 2.5}
# the backward's walks of a plan: dq over the gather table, dk/dv over
# its reverse; a plan also holds the forward's walk ("fwd")
WALKS = ("dq", "dkv")
ALL_WALKS = WALKS + ("fwd",)
# plans a wrapper keeps for calls given none, per table, block, device
# and walk (`SparseSelfAttention` keeps its own beside its tables)
CALL_PLANS = 16


def reverse_gather(kb_idx) -> np.ndarray:
    """Invert the [H, nqb, A] gather table: rev[h, kb, r] lists, in
    ascending order, the q-blocks whose row visits key block kb (-1
    padded, R = max(1, the most visitors of any key block))."""
    kb_idx = np.asarray(kb_idx)
    H, nqb, _ = kb_idx.shape
    visits = np.zeros((H, nqb, nqb), bool)              # [h, kb, qb]
    h, i, a = np.nonzero(kb_idx >= 0)
    visits[h, kb_idx[h, i, a], i] = True
    counts = visits.sum(-1)
    R = max(1, int(counts.max()))
    hh, kb, qb = np.nonzero(visits)
    row = hh * nqb + kb
    starts = np.concatenate([[0], np.cumsum(counts.ravel())[:-1]])
    rev = np.full((H * nqb, R), -1, np.int32)
    rev[row, np.arange(row.size) - starts[row]] = qb
    return rev.reshape(H, nqb, R)


# ----------------------------------------------------------------------
# the gathered tile plan of the wgmma backward pair
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TileWalk:
    """One backward kernel's walk over a table [H, nb, n] (the gather
    table for dq, its reverse for dk/dv): a CTA owns `owners` blocks of
    one head and walks the ascending union of their lists, `gather`
    blocks (64 rows) a step.

    `sched` int32 [n_ctas, 8]: (h, steps, offset of the CTA's list in
    `ents`, owners, the owned blocks (up to 4)), the CTAs with the most
    steps first (the kernels run them in this order, so a long list
    starts early); `ents` int32: each list padded with -1 to whole steps,
    an entry (block << 4) | mask where bit o of the mask is set when
    owner o visits the block.  `grouping` says which blocks share a CTA:
    "adjacent" runs of `owners` blocks, or "sorted" runs of the head's
    blocks ordered by list length, then lexicographically (alike lists
    together).  `visits` counts the visited (owner, block) pairs;
    `padding` is the tile work (steps x gather x owners block pairs) over
    them.  A ragged walk's last group of a head may hold fewer than
    `owners` blocks: its gaps are owned block -1, which visits nothing."""
    owners: int
    gather: int
    grouping: str
    sched: np.ndarray
    ents: np.ndarray
    visits: int

    @property
    def steps(self) -> int:
        return int(self.sched[:, 1].sum())

    @property
    def padding(self) -> float:
        return self.steps * self.gather * self.owners / max(self.visits, 1)

    def pairs(self) -> np.ndarray:
        """[n, 3] (h, owned block, visited block) of every pair the walk
        computes unmasked, one row per visit of the walk."""
        rows = []
        for h, steps, off, _, *owned in self.sched.tolist():
            for e in self.ents[off:off + steps * self.gather].tolist():
                for o in range(self.owners):
                    if e >= 0 and (e & 15) >> o & 1:
                        rows.append((h, owned[o], e >> 4))
        return np.asarray(rows, np.int64).reshape(-1, 3)


WALK_GROUPINGS = ("adjacent", "sorted")


def tile_walk(table, block: int, owners: int = 1,
              grouping: str = "adjacent", ragged: bool = False) -> TileWalk:
    """The walk of `owners` blocks a CTA over `table` [H, nb, n]
    (ascending block lists, -1 padded) at `block`: pure numpy.  With
    `ragged`, nb need not be a multiple of `owners` (the forward's walk)."""
    table = np.asarray(table)
    H, nb, _ = table.shape
    if (owners not in OWNER_GROUPS.get(block, ())
            or (nb % owners and not ragged)
            or grouping not in WALK_GROUPINGS):
        raise ValueError(f"no {grouping!r} gathered walk of {owners} owners "
                         f"at block {block} over {nb} blocks")
    gather = GATHER_ROWS // block
    ng = -(-nb // owners)                               # groups a head
    # [h, owner, block]; owner nb is a ragged group's gap
    visits = np.zeros((H, nb + 1, nb), bool)
    h, i, a = np.nonzero(table >= 0)
    visits[h, i, table[h, i, a]] = True
    if grouping == "sorted":   # by list length, then lexicographically
        lengths = (table >= 0).sum(-1)
        order = np.stack([np.lexsort((*table[hh].T[::-1], -lengths[hh]))
                          for hh in range(H)])
    else:
        order = np.broadcast_to(np.arange(nb), (H, nb))
    order = np.concatenate([order, np.full((H, ng * owners - nb), -1,
                                           order.dtype)], 1)
    groups = order.reshape(H, ng, owners)               # [h, group, o]
    grouped = visits[np.arange(H)[:, None, None],
                     np.where(groups < 0, nb, groups)]
    bits = (grouped.view(np.uint8) << np.arange(owners, dtype=np.uint8)[
        :, None]).sum(2, dtype=np.uint8)               # owner mask, 4 bits
    union = bits > 0                                    # [h, group, block]
    counts = union.sum(-1).ravel()
    steps = -(-counts // gather)
    gh, gg, kb = np.nonzero(union)       # row-major: ascending kb per group
    group = gh * ng + gg
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offsets = np.concatenate([[0], np.cumsum(steps * gather)[:-1]])
    ents = np.full(int((steps * gather).sum()), -1, np.int32)
    ents[offsets[group] + np.arange(group.size) - starts[group]] = (
        kb * 16 + bits[gh, gg, kb].astype(np.int64))
    owned = np.full((H * ng, 4), -1, np.int64)
    owned[:, :owners] = groups.reshape(-1, owners)
    sched = np.concatenate([np.stack([
        np.repeat(np.arange(H), ng), steps, offsets,
        np.full_like(steps, owners)], 1), owned], 1).astype(np.int32)
    sched = sched[np.argsort(-steps, kind="stable")]
    return TileWalk(owners, gather, grouping, np.ascontiguousarray(sched),
                    ents, int(visits.sum()))


def fwd_walk(kb_idx, block: int) -> TileWalk:
    """The forward's walk of gather table `kb_idx` [H, nqb, A] at `block`:
    64 / block query blocks a CTA (64 query rows, wgmma's M), a head's
    last group ragged where nqb is not a multiple of that, grouped
    "adjacent" or "sorted", whichever takes fewer steps ("adjacent" on a
    tie)."""
    owners = GATHER_ROWS // block
    walks = [tile_walk(kb_idx, block, owners, g, ragged=True)
             for g in WALK_GROUPINGS]
    return min(walks, key=lambda w: (w.steps,
                                     WALK_GROUPINGS.index(w.grouping)))


def _cheapest_walk(table, block: int) -> TileWalk:
    """The walk of least steps x STEP_COST[N] over the owner counts the
    block allows and both groupings (the fewest owners, then "adjacent",
    on a tie)."""
    nb = np.asarray(table).shape[1]
    walks = [tile_walk(table, block, r, grp) for r in OWNER_GROUPS[block]
             if nb % r == 0 for grp in (WALK_GROUPINGS if r > 1 else
                                        WALK_GROUPINGS[:1])]
    return min(walks, key=lambda w: (w.steps * STEP_COST[block * w.owners],
                                     w.owners,
                                     WALK_GROUPINGS.index(w.grouping)))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """One layout's plan at one block: at the blocks the wgmma kernels
    take, the dq and dk/dv walks (None where not built) with their
    `sched` and `ents` as int32 tensors on `device` in `device_walks`
    (one (sched, ents) or None per walk of WALKS), and the forward's walk
    `fwd` with its tensors in `fwd_device`.  Built once per layout and
    device (`sparse_attention._device_tables` caches it)."""
    block: int
    heads: int
    blocks: int
    dq: Optional[TileWalk]
    dkv: Optional[TileWalk]
    device_walks: tuple = ()
    fwd: Optional[TileWalk] = None
    fwd_device: Optional[tuple] = None

    def device(self, walk: str):
        """(sched, ents) of `walk` (one of ALL_WALKS) on the plan's device,
        or None."""
        if walk == "fwd":
            return self.fwd_device
        if not self.device_walks:
            return None
        return self.device_walks[WALKS.index(walk)]


def _host_table(kb_idx) -> np.ndarray:
    if isinstance(kb_idx, torch.Tensor):
        kb_idx = kb_idx.cpu().numpy()
    return np.ascontiguousarray(kb_idx, np.int32)


def _plan_walk(kb_idx, block, which, owners, grouping, device):
    if which == "fwd":
        walk = fwd_walk(kb_idx, block)
    else:
        table = kb_idx if which == "dq" else reverse_gather(kb_idx)
        walk = (_cheapest_walk(table, block) if owners is None
                else tile_walk(table, block, owners, grouping))
    return walk, (torch.from_numpy(walk.sched).to(device),
                  torch.from_numpy(walk.ents).to(device))


def bwd_plan(kb_idx, block: int, device="cpu", owners: Optional[int] = None,
             grouping: str = "adjacent") -> BwdPlan:
    """The plan of gather table `kb_idx` [H, nqb, A] (numpy or a tensor)
    at `block`: each backward walk the cheapest, or with `owners` given
    that many owners a CTA grouped by `grouping` (the card's checks hold
    every walk the kernels take), and the forward's walk (`fwd_walk`)."""
    kb_idx = _host_table(kb_idx)
    H, nb, _ = kb_idx.shape
    if block not in WGMMA_BLOCKS:
        return BwdPlan(block, H, nb, None, None)
    built = [_plan_walk(kb_idx, block, w, owners, grouping, device)
             for w in ALL_WALKS]
    return BwdPlan(block, H, nb, *(w for w, _ in built[:2]),
                   tuple(d for _, d in built[:2]), *built[2])


_call_walks: dict = {}


def call_plan(kb_idx, block: int, device, walks=WALKS) -> BwdPlan:
    """The plan of a wrapper call given none: each of `walks` (of
    ALL_WALKS) built once per table, block and device and kept (the
    CALL_PLANS * 2 latest walks), so a direct dq call builds only the dq
    walk, a forward call only the forward's, and a repeated call only
    reads the table back to hash it."""
    kb_idx = _host_table(kb_idx)
    H, nb, _ = kb_idx.shape
    key = (kb_idx.shape, kb_idx.tobytes(), block, str(torch.device(device)))
    built = []
    for w in ALL_WALKS:
        got = None
        if w in walks:
            got = _call_walks.pop((w,) + key, None) or _plan_walk(
                kb_idx, block, w, None, "adjacent", device)
            _call_walks[(w,) + key] = got      # the latest last
            while len(_call_walks) > 2 * CALL_PLANS:
                del _call_walks[next(iter(_call_walks))]
        built.append(got or (None, None))
    return BwdPlan(block, H, nb, *(w for w, _ in built[:2]),
                   tuple(d for _, d in built[:2]), *built[2])


def bwd_variant(dtype, D: int, block: int) -> str:
    """The dq and dk/dv kernel pair a call of `dtype`, head dim `D` and
    `block` takes on the card: "f32" for float32; for bf16 "wgmma" at D
    64 and 128 and block 16, 32 and 64, else "mma".  Raises on what no
    pair takes."""
    return _variant_rule(dtype, D, block)


def fwd_variant(dtype, D: int, block: int) -> str:
    """The forward kernel a call takes on the card, by the backward's
    rule: "f32" for float32; for bf16 "wgmma" at D 64 and 128 and block
    16, 32 and 64 (phase 10's forward gate holds it against the mma.sync
    kernel on the card), else "mma".  Raises on what no kernel takes."""
    return _variant_rule(dtype, D, block)


def _variant_rule(dtype, D, block):
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}: the block-sparse kernels take bf16 "
                        f"or f32")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (kernels take {HEAD_DIMS})")
    if block % 8 or not 8 <= block <= MAX_BLOCK:
        raise ValueError(f"block {block} (kernels take multiples of 8 up to "
                         f"{MAX_BLOCK})")
    if dtype == torch.float32:
        return "f32"
    if D not in WGMMA_HEAD_DIMS or block not in WGMMA_BLOCKS:
        return "mma"
    return "wgmma"


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _blocks(x, block):
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, H, S // block, block, D)


def _unblocks(x):
    B, H, nb, block, D = x.shape
    return x.reshape(B, H, nb * block, D).permute(0, 2, 1, 3)


def _table(kb_idx, device):
    if isinstance(kb_idx, torch.Tensor):
        return kb_idx.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(kb_idx, np.int64)).to(device)


def _scores(q, k, v, kb_idx, block, causal, scale):
    """f32 scores of each q-block against its gathered key blocks, masked
    to NEG_INF, [B, H, nqb, block, A*block], and the gathered k and v
    [B, H, nqb, A, block, D] as f32."""
    B, S, H, D = q.shape
    idx = _table(kb_idx, q.device)
    A = idx.shape[-1]
    safe = idx.clamp_min(0)
    h_ar = torch.arange(H, device=q.device)[:, None, None]
    gk = _blocks(k, block)[:, h_ar, safe].float()
    gv = _blocks(v, block)[:, h_ar, safe].float()
    qs = _blocks(q, block).float() * scale
    s = torch.einsum("bhqid,bhqajd->bhqiaj", qs, gk)
    valid = (idx >= 0)[:, :, None, :, None]
    if causal:
        nqb = S // block
        ar = torch.arange(block, device=q.device)
        qpos = torch.arange(nqb, device=q.device)[:, None] * block + ar
        kpos = idx[..., None] * block + ar                  # [H, nqb, A, j]
        valid = valid & (kpos[:, :, None, :, :]
                         <= qpos[None, :, :, None, None])
    s = torch.where(valid, s, NEG_INF)
    return s.reshape(*s.shape[:4], A * block), gk, gv, qs


def block_sparse_flash_attention_reference(q, k, v, kb_idx, block: int,
                                           causal: bool = True,
                                           scale: Optional[float] = None,
                                           round_p: bool = False):
    """Plain PyTorch version of the forward kernel: f32 math, differentiable
    in q, k and v.  Returns (out [B, S, H, D] in q.dtype, lse [B, H, nqb,
    block] f32).  `round_p` rounds the normalised probabilities to q.dtype
    before the product with V, as the JAX package's jnp path does."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s, _, gv, _ = _scores(q, k, v, kb_idx, block, causal, scale)
    # the softmax does not depend on m: no gradient flows through it
    m = s.amax(-1, keepdim=True).detach()
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    B, H, nqb, bl, _ = s.shape
    gv = gv.reshape(B, H, nqb, -1, gv.shape[-1])
    if round_p:
        out = torch.einsum("bhqik,bhqkd->bhqid",
                           (p / l).to(q.dtype).float(), gv)
    else:
        out = torch.einsum("bhqik,bhqkd->bhqid", p, gv) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return _unblocks(out).to(q.dtype), lse


def _delta(out, do):
    """rowsum(dO * out) in f32, [B, H, S]."""
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1)


def _bwd_reference(q, k, v, kb_idx, out, do, lse, block, causal, scale,
                   delta=None):
    """(dq, dk, dv) in f32 from the forward's residuals and dO; `delta`
    [B, H, S] (rowsum(dO * out)) where the caller has it."""
    B, S, H, D = q.shape
    nb = S // block
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, gk, gv, qs = _scores(q, k, v, kb_idx, block, causal, scale)
    A = gk.shape[3]
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - lse.float()[..., None]),
                    0.0).reshape(B, H, nb, block, A, block)
    dob = _blocks(do, block).float()
    if delta is None:
        delta = _delta(out, do)
    delta = delta.float().reshape(B, H, nb, block)
    dp = torch.einsum("bhqid,bhqajd->bhqiaj", dob, gv)
    ds = p * (dp - delta[..., None, None])
    dq = torch.einsum("bhqiaj,bhqajd->bhqid", ds, gk) * scale
    dk_g = torch.einsum("bhqiaj,bhqid->bhqajd", ds, qs)
    dv_g = torch.einsum("bhqiaj,bhqid->bhqajd", p, dob)
    # scatter the gathered blocks' gradients back onto their key blocks
    idx = _table(kb_idx, q.device).clamp_min(0)
    dest = (torch.arange(H, device=q.device)[:, None, None] * nb
            + idx).reshape(-1)
    dk = torch.zeros(B, H * nb, block, D, device=q.device)
    dv = torch.zeros(B, H * nb, block, D, device=q.device)
    dk.index_add_(1, dest, dk_g.reshape(B, -1, block, D))
    dv.index_add_(1, dest, dv_g.reshape(B, -1, block, D))
    return (_unblocks(dq), _unblocks(dk.view(B, H, nb, block, D)),
            _unblocks(dv.view(B, H, nb, block, D)))


def block_sparse_flash_backward_reference(q, k, v, kb_idx, out, do, lse,
                                          block: int, causal: bool = True,
                                          scale: Optional[float] = None):
    """Plain PyTorch version of `block_sparse_flash_backward`: f32 math.
    Returns (dq, dk, dv) like q."""
    return tuple(t.to(q.dtype) for t in _bwd_reference(
        q, k, v, kb_idx, out, do, lse, block, causal, scale))


def block_sparse_flash_dq_reference(q, k, v, kb_idx, out, do, lse,
                                    block: int, causal: bool = True,
                                    scale: Optional[float] = None,
                                    delta=None):
    """Plain PyTorch version of the dq kernel: f32 math.  Returns dq like
    q."""
    return _bwd_reference(q, k, v, kb_idx, out, do, lse, block, causal,
                          scale, delta)[0].to(q.dtype)


def block_sparse_flash_dkv_reference(q, k, v, kb_idx, out, do, lse,
                                     block: int, causal: bool = True,
                                     scale: Optional[float] = None,
                                     delta=None):
    """Plain PyTorch version of the dk/dv kernel: f32 math.  Returns (dk,
    dv) like k."""
    _, dk, dv = _bwd_reference(q, k, v, kb_idx, out, do, lse, block,
                               causal, scale, delta)
    return dk.to(k.dtype), dv.to(v.dtype)


def block_sparse_flash_bwd_delta_reference(out, do):
    """Plain PyTorch version of the delta kernel: rowsum(dO * out) in
    f32, [B, H, S]."""
    return _delta(out, do)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
def _check(q, k, v, table, block, rest=()):
    """Raise on anything the kernels do not take; `rest` are the
    backward's (out, do, lse)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} (kernels take bf16 or f32)")
    if q.dim() != 4:
        raise ValueError(f"need q/k/v [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} (kernels take {HEAD_DIMS})")
    if block % 8 or not 8 <= block <= MAX_BLOCK:
        raise ValueError(f"block {block} (kernels take multiples of 8 up to "
                         f"{MAX_BLOCK})")
    if S % block:
        raise ValueError(f"seq len {S} is not a multiple of block {block}")
    for name, t in (("k", k), ("v", v)) + tuple(zip(("out", "do"), rest)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and "
                             f"device")
    if rest and (rest[2].shape != (B, H, S // block, block)
                 or rest[2].dtype != torch.float32
                 or rest[2].device != q.device):
        raise ValueError(f"lse must be f32 {(B, H, S // block, block)} on "
                         f"q's device")
    if (table.dtype != torch.int32 or table.dim() != 3
            or table.shape[:2] != (H, S // block)
            or table.device != q.device):
        raise ValueError(f"gather tables must be int32 [H, {S // block}, n] "
                         f"on q's device, got {tuple(table.shape)} "
                         f"{table.dtype} on {table.device}")
    for t in (q, k, v, table) + tuple(rest):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _device_table(t, device):
    if isinstance(t, torch.Tensor):
        return t
    return torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(device)


def _scale(scale, D):
    return float(scale if scale is not None else 1.0 / math.sqrt(D))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _not_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"no block-sparse attention kernel for device "
                         f"{t.device}")


def block_sparse_flash_attention(q, k, v, kb_idx, block: int,
                                 causal: bool = True,
                                 scale: Optional[float] = None,
                                 return_lse: bool = False, *,
                                 plan: Optional[BwdPlan] = None,
                                 variant: Optional[str] = None):
    """Block-sparse attention over the gather table `kb_idx` [H, nqb, A]
    (numpy or an int32 tensor; -1 padding), on the kernel `variant`
    (default: the one `fwd_variant` names; the wgmma kernel reads `plan`'s
    forward walk, `call_plan`'s where not given).  Returns out [B, S, H,
    D] in q.dtype, and with `return_lse` also the lse [B, H, nqb, block]
    f32."""
    if q.device.type == "cpu":
        out, lse = block_sparse_flash_attention_reference(
            q, k, v, kb_idx, block, causal, scale)
        return (out, lse) if return_lse else out
    _not_cuda(q)
    idx = _device_table(kb_idx, q.device)
    _check(q, k, v, idx, block)
    B, S, H, D = q.shape
    plan, variant = _route(q, kb_idx, block, plan, variant, ("fwd",))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S // block, block), dtype=torch.float32,
                      device=q.device)
    if variant == "wgmma":
        sched, ents = plan.fwd_device
        fn = _build.function("sparse_flash", "dstt_sparse_fwd_wgmma",
                             _FWD_WGMMA_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), sched.data_ptr(), ents.data_ptr(),
                sched.shape[0], B, S, H, D, block, int(bool(causal)),
                _scale(scale, D), _stream(q))
    else:
        fn = _build.function("sparse_flash", "dstt_sparse_fwd", _FWD_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), idx.data_ptr(), B, S, H, D, block,
                idx.shape[2], int(bool(causal)), _scale(scale, D),
                _DTYPES[q.dtype], _stream(q))
    _build.check(rc, f"block-sparse attention ({variant})")
    _count(block_sparse_flash_attention, variant)
    return (out, lse) if return_lse else out


def _rows_like(t, q, name):
    B, S, H, _ = q.shape
    if (t.shape != (B, H, S) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous f32 {(B, H, S)} on "
                         f"q's device")


def block_sparse_flash_bwd_delta(out, do):
    """delta = rowsum(dO * out) [B, H, S] f32, read by the wgmma pair:
    one launch a backward."""
    if out.device.type == "cpu":
        return block_sparse_flash_bwd_delta_reference(out, do)
    _not_cuda(out)
    if (out.dtype != torch.bfloat16 or out.dim() != 4
            or out.shape[3] not in WGMMA_HEAD_DIMS):
        raise ValueError(f"the delta kernel takes the wgmma pair's bf16 "
                         f"[B, S, H, D] at D {WGMMA_HEAD_DIMS}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    B, S, H, D = out.shape
    if (do.shape != out.shape or do.dtype != out.dtype
            or do.device != out.device or not out.is_contiguous()
            or not do.is_contiguous()):
        raise ValueError("dO must match out's shape, dtype and device, both "
                         "contiguous")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=out.device)
    fn = _build.function("sparse_flash", "dstt_sparse_bwd_delta",
                         _DELTA_ARGS)
    _build.check(fn(out.data_ptr(), do.data_ptr(), delta.data_ptr(), B, S,
                    H, D, _stream(out)),
                 "block-sparse attention delta")
    block_sparse_flash_bwd_delta.launches += 1
    return delta


def _route(q, kb_idx, block, plan, variant, walks):
    """(plan, variant) of a call on the card running `walks` (the
    forward's or the backward's): the variant the rule (`fwd_variant`,
    `bwd_variant`) names where none is given, and on the wgmma kernels
    the plan given or else `call_plan`'s of `walks`; raises where the
    named variant does not take the call (no other kernel is tried)."""
    B, S, H, D = q.shape
    if variant is None:
        rule = fwd_variant if walks == ("fwd",) else bwd_variant
        variant = rule(q.dtype, D, block)
    if variant not in BWD_VARIANTS:
        raise ValueError(f"variant {variant!r} (one of {BWD_VARIANTS})")
    if (variant == "f32") != (q.dtype == torch.float32):
        raise ValueError(f"the {variant!r} pair does not take {q.dtype}")
    if variant == "wgmma":
        if (q.dtype != torch.bfloat16 or D not in WGMMA_HEAD_DIMS
                or block not in WGMMA_BLOCKS):
            raise ValueError(f"the wgmma kernels take bf16 at D "
                             f"{WGMMA_HEAD_DIMS} and block {WGMMA_BLOCKS}, "
                             f"not {q.dtype} D {D} block {block}")
        if plan is None:
            plan = call_plan(kb_idx, block, q.device, walks)
        if (plan.block, plan.heads, plan.blocks) != (block, H, S // block) \
                or any(getattr(plan, w) is None for w in walks):
            raise ValueError(f"the plan is for block {plan.block}, "
                             f"{plan.heads} heads, {plan.blocks} blocks with "
                             f"walks "
                             f"{[w for w in ALL_WALKS if getattr(plan, w)]}"
                             f", not block {block}, {H} heads, {S // block} "
                             f"blocks with {list(walks)}")
        where = plan.device(walks[0])[0].device
        if where != q.device:
            raise ValueError(f"the plan's tables lie on {where}, not "
                             f"{q.device}")
    return plan, variant


def _count(wrapper, variant):
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1


def _walk_args(plan, which, q, block, causal, scale):
    """The pointers and ints after the outputs of a wgmma entry point."""
    walk = plan.dq if which == 0 else plan.dkv
    sched, ents = plan.device_walks[which]
    B, S, H, D = q.shape
    return (sched.data_ptr(), ents.data_ptr(), sched.shape[0], walk.owners,
            B, S, H, D, block, int(bool(causal)), _scale(scale, D),
            _stream(q))


def block_sparse_flash_dq(q, k, v, kb_idx, out, do, lse, block: int,
                          causal: bool = True,
                          scale: Optional[float] = None, *, delta=None,
                          plan: Optional[BwdPlan] = None,
                          variant: Optional[str] = None):
    """dq of block-sparse attention along the gather table, from the
    forward's residuals and dO, on the pair `variant` (default: the one
    `bwd_variant` names).  The wgmma pair reads `delta` (computed here
    where not given) and `plan` (`call_plan`'s where not given).  Returns dq
    like q."""
    if q.device.type == "cpu":
        return block_sparse_flash_dq_reference(q, k, v, kb_idx, out, do,
                                               lse, block, causal, scale,
                                               delta)
    _not_cuda(q)
    idx = _device_table(kb_idx, q.device)
    _check(q, k, v, idx, block, (out, do, lse))
    B, S, H, D = q.shape
    plan, variant = _route(q, kb_idx, block, plan, variant, ("dq",))
    dq = torch.empty_like(q)
    if variant == "wgmma":
        if delta is None:
            delta = block_sparse_flash_bwd_delta(out, do)
        _rows_like(delta, q, "delta")
        fn = _build.function("sparse_flash", "dstt_sparse_dq_wgmma",
                             _DQ_WGMMA_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                *_walk_args(plan, 0, q, block, causal, scale))
    else:
        fn = _build.function("sparse_flash", "dstt_sparse_dq", _DQ_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), idx.data_ptr(),
                B, S, H, D, block, idx.shape[2], int(bool(causal)),
                _scale(scale, D), _DTYPES[q.dtype], _stream(q))
    _build.check(rc, f"block-sparse attention dq ({variant})")
    _count(block_sparse_flash_dq, variant)
    return dq


def block_sparse_flash_dkv(q, k, v, kb_idx, rev_idx, out, do, lse,
                           block: int, causal: bool = True,
                           scale: Optional[float] = None, *, delta=None,
                           plan: Optional[BwdPlan] = None,
                           variant: Optional[str] = None):
    """dk and dv of block-sparse attention, each key block walking the
    q-blocks of the reverse table `rev_idx` [H, nkb, R] (the mma and f32
    pairs) or the plan's dk/dv walk (the wgmma pair); `delta`, `plan` and
    `variant` as in `block_sparse_flash_dq`.  Returns (dk, dv) like k."""
    if q.device.type == "cpu":
        return block_sparse_flash_dkv_reference(q, k, v, kb_idx, out, do,
                                                lse, block, causal, scale,
                                                delta)
    _not_cuda(q)
    rev = _device_table(rev_idx, q.device)
    _check(q, k, v, rev, block, (out, do, lse))
    B, S, H, D = q.shape
    plan, variant = _route(q, kb_idx, block, plan, variant, ("dkv",))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if variant == "wgmma":
        if delta is None:
            delta = block_sparse_flash_bwd_delta(out, do)
        _rows_like(delta, q, "delta")
        fn = _build.function("sparse_flash", "dstt_sparse_dkv_wgmma",
                             _DKV_WGMMA_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                do.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *_walk_args(plan, 1, q, block, causal, scale))
    else:
        fn = _build.function("sparse_flash", "dstt_sparse_dkv", _DKV_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                rev.data_ptr(), B, S, H, D, block, rev.shape[2],
                int(bool(causal)), _scale(scale, D), _DTYPES[q.dtype],
                _stream(q))
    _build.check(rc, f"block-sparse attention dk/dv ({variant})")
    _count(block_sparse_flash_dkv, variant)
    return dk, dv


def block_sparse_flash_backward(q, k, v, kb_idx, rev_idx, out, do, lse,
                                block: int, causal: bool = True,
                                scale: Optional[float] = None, *,
                                plan: Optional[BwdPlan] = None,
                                variant: Optional[str] = None):
    """(dq, dk, dv) for `block_sparse_flash_attention`: the dq kernel over
    `kb_idx`, the dk/dv kernel over its reverse `rev_idx` (or, on the
    wgmma pair, over `plan`'s walks, after one delta launch)."""
    delta = None
    if q.device.type != "cpu":
        _not_cuda(q)
        plan, variant = _route(q, kb_idx, block, plan, variant, WALKS)
        if variant == "wgmma":
            delta = block_sparse_flash_bwd_delta(out, do)
    kw = dict(delta=delta, plan=plan, variant=variant)
    dq = block_sparse_flash_dq(q, k, v, kb_idx, out, do, lse, block,
                               causal, scale, **kw)
    dk, dv = block_sparse_flash_dkv(q, k, v, kb_idx, rev_idx, out, do, lse,
                                    block, causal, scale, **kw)
    return dq, dk, dv


block_sparse_flash_attention.launches = 0
block_sparse_flash_dq.launches = 0
block_sparse_flash_dkv.launches = 0
block_sparse_flash_bwd_delta.launches = 0
# launches per kernel (pair) (FWD_VARIANTS, BWD_VARIANTS), reset with
# `launches`
block_sparse_flash_attention.launches_by_variant = dict.fromkeys(
    FWD_VARIANTS, 0)
block_sparse_flash_dq.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
block_sparse_flash_dkv.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
