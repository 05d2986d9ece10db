"""The collectives of Megatron tensor and expert parallelism — what GSPMD inserts
implicitly in the reference (``metis_tpu/execution/train.py`` lets XLA place
them from the parameter shardings of ``execution/mesh.py``).

Every function takes the tensor-parallel process group; with ``group=None``
(tp = 1) each one is the plain single-device computation, so the unsharded
model runs exactly as before.

- ``column_parallel``: the product of a replicated input with this rank's
  columns of a weight; Megatron's conjugate operator f (identity forward,
  all-reduce of the input gradient backward) fused with the product, so
  each rank's share of the input gradient is kept in fp32 and summed in
  fp32 before it is rounded once;
- ``row_parallel``: the product of this rank's block of an input with its
  rows of a weight; the operator g (all-reduce forward, identity backward)
  fused with the product, so the partial sums keep their fp32 accumulators
  across the all-reduce (the reference's products take
  ``preferred_element_type=jnp.float32``);
- ``reduce_from_tp``: the operator g alone;
- ``vocab_parallel_embedding``: each rank owns a contiguous block of the
  vocabulary's rows; tokens outside it look up zeros, and the all-reduce
  sums the one owner's rows into every rank;
- ``vocab_parallel_cross_entropy``: the mean next-token loss from logits
  split over the vocabulary, with all-reduces of the row max, the sum of
  exponentials and the target logit — the ``[b, s, v]`` logits are never
  gathered.
- ``column_parallel_f32``: ``column_parallel`` with the fp32 accumulator
  as the result (LLaMA's SwiGLU gate and up, its head), also without a group;
- ``copy_to_tp``: the operator f alone (the experts' replicated inputs, a
  replicated K/V projection whose heads the ranks share out);
- ``all_to_all``: the even all-to-all over an expert-parallel group, whose
  backward is the inverse all-to-all (the MoE expert slots).

On CUDA the fp32 partial products are ``torch.mm(..., out_dtype=float32)``
(bf16 operands, fp32 accumulator and output); on the CPU the operands are
widened to fp32, which gives the same products.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D operands with the fp32 accumulator as the result."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward; identity backward."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def _column_product(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # the unsharded model's own expressions, so tp = 1 keeps its numbers
    if w.dim() == 2:
        return torch.matmul(y, w)
    return torch.einsum("bsh,chk->cbsk", y, w)


class _ColumnParallel(torch.autograd.Function):
    """y [b, s, h] times w [h, n] -> [b, s, n], or the stacked weights
    w [c, h, n] -> [c, b, s, n]."""

    @staticmethod
    def forward(ctx, y, w, group):
        ctx.save_for_backward(y, w)
        ctx.group = group
        return _column_product(y, w)

    @staticmethod
    def backward(ctx, grad):
        y, w = ctx.saved_tensors
        w3, g3 = (w, grad) if w.dim() == 3 else (w[None], grad[None])
        c, h, n = w3.shape
        g = g3.permute(1, 2, 0, 3).reshape(-1, c * n)  # [tokens, c*n]
        grad_y = _mm_f32(g, w3.transpose(1, 2).reshape(c * n, h))
        dist.all_reduce(grad_y, group=ctx.group)
        grad_w = torch.einsum("bsh,cbsk->chk", y, g3)
        if w.dim() == 2:
            grad_w = grad_w[0]
        return grad_y.to(y.dtype).view(y.shape), grad_w, None


class _RowParallel(torch.autograd.Function):
    """x [..., k] times w [k, n] -> fp32 [..., n], summed over the group."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        out = _mm_f32(x.reshape(-1, x.shape[-1]), w)
        dist.all_reduce(out, group=group)
        return out.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        grad_x = torch.matmul(g, w.t())
        grad_w = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1]))
        return grad_x, grad_w, None


def column_parallel(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``y @ w`` ([b, s, h]) for this rank's columns ``w`` of a
    column-parallel weight (``[h, n]``, or ``[c, h, n]`` giving
    ``[c, b, s, n]``), in ``y``'s dtype."""
    if group is None:
        return _column_product(y, w)
    return _ColumnParallel.apply(y, w, group)


def row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` in fp32 for this rank's rows ``w`` of a row-parallel weight,
    summed over ``group``.  Without a group: the product in ``x``'s dtype,
    then widened, as the unsharded model computes it."""
    if group is None:
        return torch.matmul(x, w).float()
    return _RowParallel.apply(x, w, group)


def _tp_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor,
                             group) -> torch.Tensor:
    """Rows of the full embedding table for ``tokens`` from this rank's
    block ``table`` of ``v / tp`` rows (rank r owns rows ``[r*v/tp,
    (r+1)*v/tp)``); every rank gets every token's row."""
    if group is None:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - _tp_rank(group) * rows
    outside = (local < 0) | (local >= rows)
    emb = F.embedding(local.masked_fill(outside, 0), table)
    return reduce_from_tp(emb.masked_fill(outside[..., None], 0.0), group)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 group) -> torch.Tensor:
    """Mean cross-entropy of ``targets`` [N] under ``logits`` [N, v / tp]
    (fp32), this rank's block of the vocabulary."""
    targets = targets.long()
    if group is None:
        return F.cross_entropy(logits, targets)
    rows = logits.shape[-1]
    # the max only steadies the exponentials; it cancels, so no gradient
    m = _all_reduce(logits.detach().amax(-1), group, dist.ReduceOp.MAX)
    shifted = logits - m[:, None]
    sum_exp = reduce_from_tp(shifted.exp().sum(-1), group)
    local = targets - _tp_rank(group) * rows
    outside = (local < 0) | (local >= rows)
    picked = shifted.gather(-1, local.clamp(0, rows - 1)[:, None])[:, 0]
    target_logit = reduce_from_tp(picked.masked_fill(outside, 0.0), group)
    return (sum_exp.log() - target_logit).mean()


class _ColumnParallelF32(torch.autograd.Function):
    """y [..., h] times w [h, n] -> fp32 [..., n]."""

    @staticmethod
    def forward(ctx, y, w, group):
        ctx.save_for_backward(y, w)
        ctx.group = group
        return _mm_f32(y.reshape(-1, y.shape[-1]), w).view(*y.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        y, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1]).to(y.dtype)
        grad_y = _mm_f32(g, w.t())
        if ctx.group is not None:
            dist.all_reduce(grad_y, group=ctx.group)
        grad_w = torch.matmul(y.reshape(-1, y.shape[-1]).t(), g)
        return grad_y.to(y.dtype).view(y.shape), grad_w, None


def column_parallel_f32(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``y @ w`` for this rank's columns ``w`` ([h, n]) of a column-parallel
    weight, returned as the fp32 accumulator (the reference's
    ``preferred_element_type=float32`` product kept in fp32, where
    ``column_parallel`` rounds it to ``y``'s dtype).  Also without a group."""
    return _ColumnParallelF32.apply(y, w, group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.float().contiguous()
        dist.all_reduce(out, group=ctx.group)
        return out.to(grad.dtype), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's operator f alone: identity forward, all-reduce (sum, in
    fp32) of the gradient backward.  For a replicated input of which each
    rank uses its own part (the experts' tokens under tp, a replicated K/V
    projection whose heads the ranks share out), the rank's gradient is a
    partial sum."""
    return x if group is None else _CopyToTP.apply(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The even all-to-all over dim 0: chunk j of ``x`` goes to rank j of
    ``group``, and chunk j of the result came from rank j.  Gloo takes host
    tensors only, so CUDA tensors cross through the host there."""
    staged = x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO
    src = (x.detach().cpu() if staged else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        # the even all-to-all sends every chunk back where it came from
        return _all_to_all(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable even all-to-all over dim 0 (``x.shape[0]`` = the
    group's size); the backward is the inverse all-to-all.  Identity
    without a group."""
    return x if group is None else _AllToAll.apply(x, group)
