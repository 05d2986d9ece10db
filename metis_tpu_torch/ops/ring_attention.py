"""Ring attention — the port of ``metis_tpu/ops/ring_attention.py``:
context-parallel causal attention over a process group.

Each rank of the context-parallel (cp) group holds a contiguous block of
the sequence: rank r holds positions ``[r s, (r+1) s)`` of its q, k and v
(``[b, h, s, d]``).  K/V blocks rotate around the ring (``RingTransfer``:
to the next rank, from the previous one) while each rank folds its
queries' attention over the visiting block into an online-softmax state.
With the sequence sharded contiguously, the block that started on ring
position ``src`` is entirely in the past of rank r's queries when ``src <
r``, needs the causal mask when ``src == r`` and is entirely in the future
when ``src > r``: rank r computes ``r + 1`` blocks and skips the rest.

Two paths, as in the reference:

- **flash** (``_RingFlash``): each block runs B1 in stats mode
  (``flash_attention_stats``, causal on the self block, non-causal on past
  blocks), merged with ``merge_stats``; the result is the output and the
  global logsumexp.  The backward is a second ring: ``delta = sum(dO out)``
  from the final output, once; each block runs B2 and B3 with the global
  logsumexp and delta, and the dK/dV accumulators (fp32) rotate with
  their K/V, home again after ``cp`` rotations.  Every transfer of the
  next step is posted before the block's kernels run.  On the CPU the
  kernels' plain versions run, so the tests run the algorithm the card
  runs.
- **dense** (``_ring_dense``): per-step dense scores, differentiable
  through ``ring_shift``; every block is computed, masked, so that every
  rank's graph holds every shift.  For tests.

GQA: K/V and their gradients rotate grouped (``[b, kv_heads, s, d]``); the
kernels serve the groups by index, the dense path expands each visiting
block locally.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from metis_tpu_torch.models.parallel import RingTransfer, ring_shift
from metis_tpu_torch.ops.flash_attention import (
    _fold,
    fa_bwd_dkv,
    fa_bwd_dq,
    flash_attention_stats,
    logsumexp_of,
    merge_stats,
)


def _ring_position(group) -> tuple[int, int]:
    return dist.get_rank(group), group.size()


def _ring_dense(q, k, v, group):
    """Dense per-step ring attention, differentiable through the shifts."""
    pos, ring = _ring_position(group)
    rep = q.shape[1] // k.shape[1]
    s = q.shape[2]
    q32 = q.float()
    m = torch.full(q.shape[:3], -math.inf, device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    o = torch.zeros(q32.shape, device=q.device)
    tril = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    k_cur, v_cur = k, v
    for step in range(ring):
        src = (pos - step) % ring
        mask = (torch.ones_like(tril) if src < pos else tril if src == pos
                else torch.zeros_like(tril))
        k_use = k_cur.repeat_interleave(rep, dim=1) if rep > 1 else k_cur
        v_use = v_cur.repeat_interleave(rep, dim=1) if rep > 1 else v_cur
        scores = torch.matmul(q32, k_use.float().transpose(-1, -2))
        scores = (scores / math.sqrt(q.shape[-1])).masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, scores.amax(-1))
        # fully masked rows: exp(-inf - -inf) would be nan
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp(torch.where(torch.isneginf(m), -math.inf, m - m_safe))
        p = torch.exp(scores - m_safe[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.matmul(p, v_use.float())
        m = m_new
        if step < ring - 1:
            k_cur, v_cur = ring_shift([k_cur, v_cur], group)
    return (o / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring (module doc); launches B1 per computed block in the
    forward, B2 and B3 per computed block in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        pos, ring = _ring_position(group)
        state = None
        k_cur, v_cur = k, v
        for step in range(ring):
            src = (pos - step) % ring
            nxt = (RingTransfer([k_cur, v_cur], group) if step < ring - 1
                   else None)
            if src <= pos:  # the self block comes first; future blocks skip
                blk = flash_attention_stats(q, k_cur, v_cur, causal=src == pos)
                state = blk if state is None else merge_stats(state, blk)
            if nxt is not None:
                k_cur, v_cur = nxt.wait()
        acc, m, l = state
        out = (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, logsumexp_of(m, l))
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        pos, ring = _ring_position(group)
        b, h, s, d = q.shape
        kvh = k.shape[1]
        qf, do = _fold(q), _fold(grad.to(q.dtype))
        lse_f = lse.reshape(b * h, s)
        delta = (do.float() * _fold(out).float()).sum(-1)
        heads = dict(q_heads=h, kv_heads=kvh)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for step in range(ring):
            src = (pos - step) % ring
            nxt = (RingTransfer([k_cur, v_cur], group) if step < ring - 1
                   else None)
            if src <= pos:
                causal = src == pos
                kf, vf = _fold(k_cur), _fold(v_cur)
                dq_b = fa_bwd_dq(qf, kf, vf, do, lse_f, delta, causal=causal,
                                 **heads)
                dk_b, dv_b = fa_bwd_dkv(qf, kf, vf, do, lse_f, delta,
                                        causal=causal, **heads)
                dq += dq_b.view(q.shape).float()
                dk += dk_b.view(k.shape).float()
                dv += dv_b.view(k.shape).float()
            # the accumulators travel with their block: cp rotations home
            dk, dv = RingTransfer([dk, dv], group, tag=2).wait()
            if nxt is not None:
                k_cur, v_cur = nxt.wait()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention_local(q, k, v, group, impl: str = "flash"):
    """Causal attention of this rank's sequence block with K/V rotating over
    ``group`` (module doc).  q: ``[b, h, s, d]``; k, v: ``[b, kv_heads, s,
    d]``.  ``impl``: ``"flash"`` (the kernels; their plain versions on the
    CPU) or ``"dense"``."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} are not a multiple of kv "
                         f"heads {k.shape[1]}")
    if impl == "dense":
        return _ring_dense(q, k, v, group)
    if impl != "flash":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    return _RingFlash.apply(q, k, v, group)


def make_ring_attention(group, impl: str = "flash"):
    """An ``AttnFn`` (q, k, v -> context, ``[b, h, s, d]``) running ring
    attention over the context-parallel ``group``.  The flash path on both
    devices (the reference picks the dense one off the TPU); GQA callers
    may pass grouped K/V (``supports_gqa``)."""
    def attn(q, k, v):
        return ring_attention_local(q, k, v, group, impl)

    attn.supports_gqa = True
    return attn
