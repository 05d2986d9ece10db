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
  backward is the inverse all-to-all (the MoE expert slots);
- ``seq_to_heads`` / ``heads_to_seq``: Ulysses' all-to-alls over a
  context-parallel group, sequence shards traded for head shards and back,
  each the other's adjoint;
- ``ring_shift``: every tensor to the next rank of a context-parallel ring
  and from the previous one (ring attention), backward the other way;
- Megatron sequence parallelism's pair over tp: ``column_parallel`` and
  ``column_parallel_f32`` with ``sp=True`` all-gather their input's
  sequence blocks forward and reduce-scatter its gradient backward (the
  fp32 partial gradients summed before one rounding, only the block
  saved); ``row_parallel`` with ``sp=True`` and ``reduce_scatter_to_sp``
  (the embedding's) reduce-scatter forward and all-gather backward;
- ``gather_shard``: ZeRO-3's all-gather of a dp shard forward,
  reduce-scatter of the gradient backward; ``ShardedGroup`` is a parameter
  group whose leaves it gathers where the model reads them.  MoE routing
  groups that several ranks share gather their tokens with it too;
- ``gather_from_sp`` / ``split_to_sp``: the tp ranks' sequence blocks
  gathered for a computation every tp rank repeats in full (the MoE FFN
  under sp), backward each rank's block of the (whole, equal) gradient; and
  the rank's block of such a result, backward the blocks' gradients
  gathered.

The sequence is dim 1 of every ``[b, s, h]`` activation.  Gloo takes
point-to-point and all-to-all transfers of host tensors only, so CUDA
tensors cross through the host there (``_staged``); its gathers and
scatters go through its all-reduce, which takes CUDA tensors.

On CUDA the fp32 partial products are ``torch.mm(..., out_dtype=float32)``
(bf16 operands, fp32 accumulator and output); on the CPU the operands are
widened to fp32, which gives the same products.
"""
from __future__ import annotations

import weakref
from collections.abc import Mapping

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


class _BmmF32(torch.autograd.Function):
    """Batched ``x @ w`` ([e, n, k] x [e, k, m]) with the fp32 accumulator as
    the result; the backward's products in the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda and x.dtype != torch.float32:
            return torch.bmm(x, w, out_dtype=torch.float32)
        return torch.bmm(x.float(), w.float())

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        return torch.bmm(g, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), g)


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` kept in fp32: a row-parallel expert's partial products,
    summed over tp before they are rounded once (as ``row_parallel``)."""
    return _BmmF32.apply(x, w)


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
    w [c, h, n] -> [c, b, s, n].  With ``sp`` y is this rank's sequence
    block, gathered before the product (and again in the backward, so only
    the block is kept), and the input gradient is reduce-scattered back."""

    @staticmethod
    def forward(ctx, y, w, group, sp):
        ctx.save_for_backward(y, w)
        ctx.group, ctx.sp = group, sp
        return _column_product(all_gather_dim(y, group, 1) if sp else y, w)

    @staticmethod
    def backward(ctx, grad):
        y, w = ctx.saved_tensors
        if ctx.sp:
            y = all_gather_dim(y, ctx.group, 1)
        w3, g3 = (w, grad) if w.dim() == 3 else (w[None], grad[None])
        c, h, n = w3.shape
        g = g3.permute(1, 2, 0, 3).reshape(-1, c * n)  # [tokens, c*n]
        grad_y = _mm_f32(g, w3.transpose(1, 2).reshape(c * n, h)).view(y.shape)
        grad_y = _sum_input_grad(grad_y, ctx.group, ctx.sp)
        grad_w = torch.einsum("bsh,cbsk->chk", y, g3)
        if w.dim() == 2:
            grad_w = grad_w[0]
        return grad_y.to(y.dtype), grad_w, None, None


def _sum_input_grad(grad: torch.Tensor, group, sp: bool) -> torch.Tensor:
    """The fp32 partial input gradients of a column-parallel product summed
    over ``group``: all-reduced, or under ``sp`` reduce-scattered to this
    rank's sequence block."""
    if sp:
        return reduce_scatter_dim(grad, group, 1)
    if group is not None:
        dist.all_reduce(grad, group=group)
    return grad


class _RowParallel(torch.autograd.Function):
    """x [..., k] times w [k, n] -> fp32 [..., n], summed over the group;
    with ``sp`` reduce-scattered over the sequence (dim 1) instead."""

    @staticmethod
    def forward(ctx, x, w, group, sp):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.sp = group, sp
        out = _mm_f32(x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1], w.shape[-1])
        if sp:
            return reduce_scatter_dim(out, group, 1)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        if ctx.sp:
            grad = all_gather_dim(grad, ctx.group, 1)
        g = grad.to(x.dtype)
        grad_x = torch.matmul(g, w.t())
        grad_w = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1]))
        return grad_x, grad_w, None, None


def column_parallel(y: torch.Tensor, w: torch.Tensor, group,
                    sp: bool = False) -> torch.Tensor:
    """``y @ w`` ([b, s, h]) for this rank's columns ``w`` of a
    column-parallel weight (``[h, n]``, or ``[c, h, n]`` giving
    ``[c, b, s, n]``), in ``y``'s dtype.  ``sp``: ``y`` is this rank's
    block of the sequence, and the product covers the whole sequence."""
    if group is None:
        return _column_product(y, w)
    return _ColumnParallel.apply(y, w, group, sp)


def row_parallel(x: torch.Tensor, w: torch.Tensor, group,
                 sp: bool = False) -> torch.Tensor:
    """``x @ w`` in fp32 for this rank's rows ``w`` of a row-parallel weight,
    summed over ``group`` (``sp``: only this rank's block of the sequence,
    a reduce-scatter).  Without a group: the product in ``x``'s dtype, then
    widened, as the unsharded model computes it."""
    if group is None:
        return torch.matmul(x, w).float()
    return _RowParallel.apply(x, w, group, sp)


def _tp_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor,
                             group, sp: bool = False) -> torch.Tensor:
    """Rows of the full embedding table for ``tokens`` from this rank's
    block ``table`` of ``v / tp`` rows (rank r owns rows ``[r*v/tp,
    (r+1)*v/tp)``); every rank gets every token's row, or under ``sp``
    those of its block of the sequence (a reduce-scatter)."""
    if group is None:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - _tp_rank(group) * rows
    outside = (local < 0) | (local >= rows)
    emb = F.embedding(local.masked_fill(outside, 0), table)
    emb = emb.masked_fill(outside[..., None], 0.0)
    return reduce_scatter_to_sp(emb, group) if sp else reduce_from_tp(emb, group)


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
    """y [..., h] times w [h, n] -> fp32 [..., n]; ``sp`` as in
    ``_ColumnParallel``."""

    @staticmethod
    def forward(ctx, y, w, group, sp):
        ctx.save_for_backward(y, w)
        ctx.group, ctx.sp = group, sp
        if sp:
            y = all_gather_dim(y, group, 1)
        return _mm_f32(y.reshape(-1, y.shape[-1]), w).view(*y.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        y, w = ctx.saved_tensors
        if ctx.sp:
            y = all_gather_dim(y, ctx.group, 1)
        g = grad.reshape(-1, grad.shape[-1]).to(y.dtype)
        grad_y = _sum_input_grad(_mm_f32(g, w.t()).view(y.shape), ctx.group,
                                 ctx.sp)
        grad_w = torch.matmul(y.reshape(-1, y.shape[-1]).t(), g)
        return grad_y.to(y.dtype), grad_w, None, None


def column_parallel_f32(y: torch.Tensor, w: torch.Tensor, group,
                        sp: bool = False) -> torch.Tensor:
    """``y @ w`` for this rank's columns ``w`` ([h, n]) of a column-parallel
    weight, returned as the fp32 accumulator (the reference's
    ``preferred_element_type=float32`` product kept in fp32, where
    ``column_parallel`` rounds it to ``y``'s dtype).  Also without a group;
    ``sp`` as in ``column_parallel``."""
    return _ColumnParallelF32.apply(y, w, group, sp and group is not None)


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


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through the host: a CUDA tensor on
    gloo."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The even all-to-all over dim 0: chunk j of ``x`` goes to rank j of
    ``group``, and chunk j of the result came from rank j.  Gloo takes host
    tensors only, so CUDA tensors cross through the host there."""
    staged = _staged(x, group)
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


# --------------------------------------------------------------------------
# gathers and scatters along a dimension (sequence and ZeRO shards)

def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in the
    group's rank order (contiguous).  Gloo sums, as bytes, a zeroed buffer
    holding this rank's block: its all-reduce takes CUDA tensors (its
    gathers take host tensors only) and the byte sum passes every bit
    pattern through unchanged."""
    n = group.size()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    if dist.get_backend(group) == dist.Backend.GLOO:
        block = src.shape[0]
        r = dist.get_rank(group)
        out.zero_()
        out[r * block:(r + 1) * block] = src
        dist.all_reduce(out.view(-1).view(torch.uint8), group=group)
    else:
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``group``
    (contiguous).  Gloo sums with an all-reduce and keeps the block."""
    n, r = group.size(), dist.get_rank(group)
    src = x.movedim(dim, 0).contiguous()
    block = src.shape[0] // n
    if dist.get_backend(group) == dist.Backend.GLOO:
        if src.data_ptr() == x.data_ptr():
            src = src.clone()  # the all-reduce is in place
        dist.all_reduce(src, group=group)
        out = src[r * block:(r + 1) * block]
    else:
        out = src.new_empty((block,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _ReduceScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_dim(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.group, 1), None


def reduce_scatter_to_sp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron sp: partial sums over ``group`` of the whole sequence ->
    this rank's block of their sum (reduce-scatter); backward, the
    all-gather."""
    return _ReduceScatterToSP.apply(x, group)


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _sp_block(grad, ctx.group), None


class _SplitToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sp_block(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.group, 1), None


def _sp_block(x: torch.Tensor, group) -> torch.Tensor:
    n = x.shape[1] // group.size()
    return x.narrow(1, dist.get_rank(group) * n, n).contiguous()


def gather_from_sp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron sp: this rank's sequence block -> the whole sequence, for
    a computation every tp rank then repeats in full; backward, the rank's
    block of the gradient (each rank holds all of it)."""
    return _GatherFromSP.apply(x, group)


def split_to_sp(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of ``gather_from_sp``: this rank's sequence block of a
    result every tp rank holds whole; backward, the blocks' gradients
    gathered, so each rank sees the whole gradient."""
    return _SplitToSP.apply(x, group)


# --------------------------------------------------------------------------
# Ulysses: sequence shards <-> head shards over a context-parallel group

def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """``[b, h, s, d]``, this rank's block of the sequence -> ``[b, h / n,
    n s, d]``, the whole sequence of this rank's ``h / n`` heads (rank j of
    the ``n`` takes heads ``[j h/n, (j+1) h/n)``).  The backward is
    ``heads_to_seq``'s forward."""
    n = group.size()
    b, h, s, d = x.shape
    if h % n:
        raise ValueError(f"{h} heads do not split over the {n} ranks of "
                         "the context-parallel group")
    parts = x.reshape(b, n, h // n, s, d).transpose(0, 1)  # chunk j -> rank j
    got = all_to_all(parts, group)           # [n source sequence blocks, ...]
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of ``seq_to_heads``: ``[b, h / n, n s, d]`` -> ``[b, h,
    s, d]``, this rank's block of the sequence for every head."""
    n = group.size()
    b, hn, S, d = x.shape
    parts = x.reshape(b, hn, n, S // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(parts, group)           # [n source head chunks, ...]
    return got.transpose(0, 1).reshape(b, n * hn, S // n, d)


# --------------------------------------------------------------------------
# the ring of context parallelism

class RingTransfer:
    """One posted ring step: every tensor sent to the next rank of the
    group (the previous with ``reverse``) and one buffer received from the
    other side per tensor.  All sends and receives are posted at once, as
    one ``batch_isend_irecv``, before anything is waited for; ``wait()``
    returns the received tensors on the senders' device.  Transfers
    outstanding at the same time take distinct ``tag`` bases."""

    def __init__(self, tensors, group, reverse: bool = False, tag: int = 0):
        ranks = dist.get_process_group_ranks(group)
        i, n = dist.get_rank(group), len(ranks)
        nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
        to, frm = (prv, nxt) if reverse else (nxt, prv)
        self.device = tensors[0].device
        self.staged = _staged(tensors[0], group)
        ops, self.bufs, self._keep = [], [], []
        for tag, t in enumerate(tensors, start=tag):
            src = t.detach().contiguous()
            src = src.cpu() if self.staged else src
            buf = torch.empty(src.shape, dtype=src.dtype, device=src.device)
            self._keep.append(src)
            self.bufs.append(buf)
            ops.append(dist.P2POp(dist.isend, src, to, group=group, tag=tag))
            ops.append(dist.P2POp(dist.irecv, buf, frm, group=group, tag=tag))
        self._works = dist.batch_isend_irecv(ops)

    def wait(self) -> list[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._keep.clear()
        return [b.to(self.device) if self.staged else b for b in self.bufs]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(RingTransfer(tensors, group).wait())

    @staticmethod
    def backward(ctx, *grads):
        return (None, *RingTransfer(grads, ctx.group, reverse=True).wait())


def ring_shift(tensors, group) -> list[torch.Tensor]:
    """Each of ``tensors`` to the next rank of ``group``'s ring, and the
    previous rank's in its place; the backward sends the gradients the
    other way."""
    return list(_RingShift.apply(group, *tensors))


# --------------------------------------------------------------------------
# ZeRO-3: parameters stored as dp shards

class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim, dtype):
        ctx.group, ctx.dim, ctx.dtype = group, dim, shard.dtype
        return all_gather_dim(shard.to(dtype), group, dim)

    @staticmethod
    def backward(ctx, grad):
        g = reduce_scatter_dim(grad.float(), ctx.group, ctx.dim)
        return g.to(ctx.dtype), None, None, None


def gather_shard(shard: torch.Tensor, group, dim: int,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole leaf from this rank's dp shard (all-gather along ``dim``,
    cast to ``dtype`` first: the same values as casting the gathered leaf,
    in fewer bytes); backward, the gradient summed over ``group`` in fp32,
    this rank's shard of it (reduce-scatter)."""
    return _GatherShard.apply(shard, group, dim, dtype or shard.dtype)


class ShardGather:
    """One step's ZeRO-3 gathers over the dp ``group``, and the saved-tensor
    hooks (``hooks()``) that keep a gathered leaf saved for the backward as
    its shard: ``pack`` matches a saved tensor on the storage of a live
    gathered leaf and keeps its shard and view instead; ``unpack``
    re-gathers.  Every other saved tensor passes through unchanged."""

    def __init__(self, group):
        self.group = group
        self._live: dict = {}

    def __call__(self, shard: torch.Tensor, dim: int,
                 dtype: torch.dtype) -> torch.Tensor:
        full = gather_shard(shard, self.group, dim, dtype)
        self._live[full.untyped_storage().data_ptr()] = (
            weakref.ref(full), shard, dim, dtype)
        return full

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def _pack(self, t: torch.Tensor):
        entry = self._live.get(t.untyped_storage().data_ptr())
        if entry is None or entry[0]() is None or t.dtype != entry[3]:
            return t
        _, shard, dim, dtype = entry
        return (shard.detach(), dim, dtype, t.size(), t.stride(),
                t.storage_offset())

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        shard, dim, dtype, size, stride, offset = packed
        full = all_gather_dim(shard.to(dtype), self.group, dim)
        return full.as_strided(size, stride, offset)


class ShardedGroup(Mapping):
    """A parameter group of ZeRO-3 shards as the model reads it: indexing a
    leaf gathers it whole (``gather``, a ``ShardGather``), and ``layers()``
    gives the per-layer views of stacked block leaves one layer at a time,
    each gathered when the block loop reaches it.  ``dims[name]``: the dim
    a leaf is sharded along (None: held whole); ``dtypes[name]``: the dtype
    it is gathered in."""

    def __init__(self, leaves: dict, dims: dict, dtypes: dict,
                 gather: ShardGather):
        self.leaves, self.dims, self.dtypes = leaves, dims, dtypes
        self.gather = gather

    def __getitem__(self, name):
        leaf, dim = self.leaves[name], self.dims[name]
        return leaf if dim is None else self.gather(leaf, dim, self.dtypes[name])

    def __iter__(self):
        return iter(self.leaves)

    def __len__(self):
        return len(self.leaves)

    def layers(self):
        names = list(self.leaves)
        per_leaf = []
        for name in names:
            dim = self.dims[name]
            # a leaf sharded along the layer axis is gathered whole
            whole = self[name] if dim in (None, 0) else self.leaves[name]
            per_leaf.append(whole.unbind(0))
        for i in range(len(per_leaf[0])):
            layer = {}
            for name, views in zip(names, per_leaf):
                dim = self.dims[name]
                layer[name] = (views[i] if dim in (None, 0) else
                               self.gather(views[i], dim - 1, self.dtypes[name]))
            yield layer
