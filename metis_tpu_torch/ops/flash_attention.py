"""Blockwise (flash) attention on Hopper — the port of
``metis_tpu/ops/flash_attention.py``.

The three Pallas kernels of the reference each have a hand-written CUDA
kernel in ``csrc/flash_attention.cu`` (built at first use by
``ops/build.py``), with a plain PyTorch version of the same function beside
it in this module:

==========  =================================  ==================  ================
kernel      replaces (metis_tpu/ops/...)       wrapper             plain version
==========  =================================  ==================  ================
B1 forward  flash_attention.py:85 _fa_kernel   ``fa_fwd``          ``fa_fwd_plain``
B2 dQ       :137 _fa_bwd_dq_kernel             ``fa_bwd_dq``       ``fa_bwd_dq_plain``
B3 dK/dV    :186 _fa_bwd_dkv_kernel            ``fa_bwd_dkv``      ``fa_bwd_dkv_plain``
==========  =================================  ==================  ================

Each wrapper takes heads folded into the leading dim (q ``[b*hq, s_q, d]``,
k/v ``[b*hkv, s_kv, d]``).  It runs the plain version only for tensors on the
CPU; for a CUDA tensor it launches its kernel or raises — the kernels take
bf16 with head dim 64 or 128 and any sequence length, and there is no dense
fallback on the card.  ``launch_counts`` counts kernel launches, one per
wrapper call that launched.

``flash_attention`` is differentiable through ``torch.autograd.Function``:
B1 in the forward, B2 and B3 in the backward.  ``flash_attention_stats``
returns the unnormalized online-softmax state (acc, m, l) that ring attention
merges with ``merge_stats``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from metis_tpu_torch.ops.build import BuiltLibrary, build

NEG_INF = -1e30  # large-negative mask value; -inf would make exp(m-m) = nan
HEAD_DIMS = (64, 128)  # head dims the kernels are instantiated for

#: kernel launches per wrapper since the last ``reset_launch_counts()``
launch_counts = {"fa_fwd": 0, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}

_library: BuiltLibrary | None = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def kernel_library() -> BuiltLibrary:
    """Build (first call) and load the kernels, declaring the C signatures."""
    global _library
    if _library is None:
        built = build("flash_attention.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        fns = {
            "metis_fa_fwd": [p] * 6 + [i] * 8 + [p],
            "metis_fa_bwd_dq": [p] * 7 + [i] * 7 + [p],
            "metis_fa_bwd_dkv": [p] * 8 + [i] * 7 + [p],
        }
        for name, argtypes in fns.items():
            fn = getattr(built.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = built
    return _library


# --------------------------------------------------------------------------
# shape checks shared by the wrappers and the plain versions

def _kv_row_index(bh_q: int, q_heads: int, kv_heads: int,
                  device: torch.device) -> torch.Tensor:
    """K/V row serving each folded query row: ``(bh // hq) * hkv + (bh % hq) // g``."""
    g = q_heads // kv_heads
    idx = torch.arange(bh_q, device=device)
    return (idx // q_heads) * kv_heads + (idx % q_heads) // g


def _check_heads(q: torch.Tensor, k: torch.Tensor, q_heads: int,
                 kv_heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"folded [b*h, s, d] inputs expected, got {tuple(q.shape)}"
                         f" and {tuple(k.shape)}")
    if q_heads % kv_heads != 0:
        raise ValueError(f"q_heads={q_heads} is not a multiple of kv_heads={kv_heads}")
    if q.shape[0] % q_heads or k.shape[0] != q.shape[0] // q_heads * kv_heads:
        raise ValueError(
            f"leading dims {q.shape[0]} / {k.shape[0]} do not fold "
            f"{q_heads} query heads over {kv_heads} kv heads")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"head dims differ: {q.shape[2]} vs {k.shape[2]}")


def _check_cuda(*tensors: torch.Tensor, dtypes: tuple[torch.dtype, ...]) -> None:
    dev = tensors[0].device
    for t, dtype in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if t.dtype != dtype:
            raise NotImplementedError(
                f"the CUDA kernels take {dtype}, got {t.dtype} "
                "(no dense fallback on the card)")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels need 16-byte aligned tensors")
    if tensors[0].shape[0] > 65535:
        raise NotImplementedError(
            f"{tensors[0].shape[0]} folded heads exceed the 65535 grid rows")
    d = tensors[0].shape[-1]
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {d} has no kernel instantiation (have {HEAD_DIMS}); "
            "no dense fallback on the card")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _causal_mask(s_q: int, s_kv: int, device: torch.device) -> torch.Tensor:
    """Top-left aligned: query row i sees key rows j <= i."""
    return torch.ones(s_q, s_kv, dtype=torch.bool, device=device).tril()


def _scores(q, k, causal):
    """fp32 scaled scores, masked with NEG_INF like the reference kernels."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device), NEG_INF)
    return s


# --------------------------------------------------------------------------
# B1: forward

def fa_fwd_plain(q, k, v, *, q_heads, kv_heads, causal, normalize=True):
    """Plain version of B1: dense attention with the kernel's outputs —
    O (normalized, or the raw accumulator) in q's dtype, and fp32 per-row
    softmax max ``m`` and sum ``l``."""
    _check_heads(q, k, q_heads, kv_heads)
    rows = _kv_row_index(q.shape[0], q_heads, kv_heads, q.device)
    s = _scores(q, k[rows], causal)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.matmul(p, v[rows].float())
    if normalize:
        acc = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return acc.to(q.dtype), m, l


def fa_fwd(q, k, v, *, q_heads, kv_heads, causal, normalize=True):
    """B1 on folded inputs -> ``(o, m, l)``; see ``fa_fwd_plain``."""
    if q.device.type == "cpu":
        return fa_fwd_plain(q, k, v, q_heads=q_heads, kv_heads=kv_heads,
                            causal=causal, normalize=normalize)
    _check_heads(q, k, q_heads, kv_heads)
    _check_cuda(q, k, v, dtypes=(torch.bfloat16,) * 3)
    if k.shape != v.shape:
        raise ValueError(f"k and v differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    bh, s_q, d = q.shape
    o = torch.empty_like(q)
    m = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = kernel_library().lib.metis_fa_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(m), _ptr(l),
        bh // q_heads, q_heads, kv_heads, s_q, k.shape[1], d, int(causal),
        int(normalize), _stream())
    _raise_on(err, "fa_fwd")
    launch_counts["fa_fwd"] += 1
    return o, m, l


# --------------------------------------------------------------------------
# B2: dQ

def _probs_and_dscores(q, k, v, do, lse, delta, causal):
    """Recomputed weights ``p = exp(s - lse)`` and ``ds = p (dO V^T - delta)
    scale`` — the flash backward algebra of the reference's B2/B3."""
    s = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(p.shape[-2], p.shape[-1], p.device), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) / math.sqrt(q.shape[-1])
    return p, ds


def fa_bwd_dq_plain(q, k, v, do, lse, delta, *, q_heads, kv_heads, causal):
    """Plain version of B2: ``dq = ds K`` in q's dtype."""
    _check_heads(q, k, q_heads, kv_heads)
    rows = _kv_row_index(q.shape[0], q_heads, kv_heads, q.device)
    _, ds = _probs_and_dscores(q, k[rows], v[rows], do, lse, delta, causal)
    return torch.matmul(ds, k[rows].float()).to(q.dtype)


def fa_bwd_dq(q, k, v, do, lse, delta, *, q_heads, kv_heads, causal):
    """B2 on folded inputs -> dq; see ``fa_bwd_dq_plain``."""
    if q.device.type == "cpu":
        return fa_bwd_dq_plain(q, k, v, do, lse, delta, q_heads=q_heads,
                               kv_heads=kv_heads, causal=causal)
    _check_heads(q, k, q_heads, kv_heads)
    _check_cuda(q, k, v, do, lse, delta,
                dtypes=(torch.bfloat16,) * 4 + (torch.float32,) * 2)
    bh, s_q, d = q.shape
    if do.shape != q.shape or lse.shape != (bh, s_q) or delta.shape != (bh, s_q):
        raise ValueError("dO must match q and lse/delta must be [b*hq, s_q]")
    dq = torch.empty_like(q)
    err = kernel_library().lib.metis_fa_bwd_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
        bh // q_heads, q_heads, kv_heads, s_q, k.shape[1], d, int(causal),
        _stream())
    _raise_on(err, "fa_bwd_dq")
    launch_counts["fa_bwd_dq"] += 1
    return dq


# --------------------------------------------------------------------------
# B3: dK/dV

def fa_bwd_dkv_plain(q, k, v, do, lse, delta, *, q_heads, kv_heads, causal):
    """Plain version of B3: ``dv = p^T dO``, ``dk = ds^T Q``, summed over the
    query heads of each GQA group, in k's and v's dtypes."""
    _check_heads(q, k, q_heads, kv_heads)
    rows = _kv_row_index(q.shape[0], q_heads, kv_heads, q.device)
    p, ds = _probs_and_dscores(q, k[rows], v[rows], do, lse, delta, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    # folded query rows are ordered (batch, kv head, group member)
    g = q_heads // kv_heads
    fold = (k.shape[0], g) + tuple(dk.shape[1:])
    return (dk.reshape(fold).sum(1).to(k.dtype),
            dv.reshape(fold).sum(1).to(v.dtype))


def fa_bwd_dkv(q, k, v, do, lse, delta, *, q_heads, kv_heads, causal):
    """B3 on folded inputs -> (dk, dv); see ``fa_bwd_dkv_plain``."""
    if q.device.type == "cpu":
        return fa_bwd_dkv_plain(q, k, v, do, lse, delta, q_heads=q_heads,
                                kv_heads=kv_heads, causal=causal)
    _check_heads(q, k, q_heads, kv_heads)
    _check_cuda(q, k, v, do, lse, delta,
                dtypes=(torch.bfloat16,) * 4 + (torch.float32,) * 2)
    bh, s_q, d = q.shape
    if do.shape != q.shape or lse.shape != (bh, s_q) or delta.shape != (bh, s_q):
        raise ValueError("dO must match q and lse/delta must be [b*hq, s_q]")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = kernel_library().lib.metis_fa_bwd_dkv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
        _ptr(dv), bh // q_heads, q_heads, kv_heads, s_q, k.shape[1], d,
        int(causal), _stream())
    _raise_on(err, "fa_bwd_dkv")
    launch_counts["fa_bwd_dkv"] += 1
    return dk, dv


# --------------------------------------------------------------------------
# public API (same names as the reference)

def _fold(t: torch.Tensor) -> torch.Tensor:  # [b, h, s, d] -> [b*h, s, d]
    b, h, s, d = t.shape
    return t.reshape(b * h, s, d).contiguous()


def logsumexp_of(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Per-row logsumexp from the forward's (m, l); fully-masked rows
    (l == 0) get +BIG so the backward's recomputed p = exp(s - lse) is 0."""
    return torch.where(l == 0.0, -NEG_INF,
                       m + torch.log(torch.where(l == 0.0, 1.0, l)))


class _FlashAttention(torch.autograd.Function):
    """B1 in the forward; B2 and B3 in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        b, hq, s_q, d = q.shape
        hkv = k.shape[1]
        qf, kf, vf = _fold(q), _fold(k), _fold(v)
        out, m, l = fa_fwd(qf, kf, vf, q_heads=hq, kv_heads=hkv, causal=causal,
                           normalize=True)
        ctx.save_for_backward(qf, kf, vf, out, logsumexp_of(m, l))
        ctx.causal = causal
        ctx.heads = (hq, hkv)
        ctx.shapes = (q.shape, k.shape, v.shape)
        return out.view(b, hq, s_q, d)

    @staticmethod
    def backward(ctx, grad):
        qf, kf, vf, out, lse = ctx.saved_tensors
        hq, hkv = ctx.heads
        do = _fold(grad)
        delta = (do.float() * out.float()).sum(-1)
        dq = fa_bwd_dq(qf, kf, vf, do, lse, delta, q_heads=hq, kv_heads=hkv,
                       causal=ctx.causal)
        dk, dv = fa_bwd_dkv(qf, kf, vf, do, lse, delta, q_heads=hq,
                            kv_heads=hkv, causal=ctx.causal)
        q_shape, k_shape, v_shape = ctx.shapes
        return dq.view(q_shape), dk.view(k_shape), dv.view(v_shape), None


def flash_attention(q, k, v, *, causal=True):
    """Blockwise attention on [b, h, s, d] inputs; differentiable.

    GQA-native: ``k``/``v`` may carry fewer heads than ``q`` (any
    ``q_heads % kv_heads == 0``); each KV head serves its group of query heads
    from the unexpanded layout, in the forward and the backward."""
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"q heads {q.shape[1]} are not a multiple of kv heads {k.shape[1]}")
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention_stats(q, k, v, *, causal=False):
    """Forward-only blockwise attention returning the raw online-softmax
    state ``(acc, m, l)``: acc [b, h, s, d] fp32 *unnormalized*, m and l
    [b, h, s] fp32.  States from disjoint KV shards merge with
    ``merge_stats``.  Like the reference, acc passes through q's dtype."""
    b, h, s_q, d = q.shape
    acc, m, l = fa_fwd(_fold(q), _fold(k), _fold(v), q_heads=h,
                       kv_heads=k.shape[1], causal=causal, normalize=False)
    return (acc.float().view(b, h, s_q, d), m.view(b, h, s_q),
            l.view(b, h, s_q))


def merge_stats(state_a, state_b):
    """Fold two online-softmax states (acc, m, l) over disjoint KV sets into
    one — the associative combine of blockwise attention."""
    acc_a, m_a, l_a = state_a
    acc_b, m_b, l_b = state_b
    m = torch.maximum(m_a, m_b)
    wa, wb = torch.exp(m_a - m), torch.exp(m_b - m)
    acc = acc_a * wa[..., None] + acc_b * wb[..., None]
    return acc, m, l_a * wa + l_b * wb


def finalize_stats(state):
    """(acc, m, l) -> normalized attention output."""
    acc, _, l = state
    return acc / torch.where(l == 0.0, 1.0, l)[..., None]


def dense_causal_attention(q, k, v):
    """Reference dense causal attention ([b, h, s, d]), masked with NEG_INF."""
    weights = torch.softmax(_scores(q, k, causal=True), dim=-1)
    return torch.matmul(weights.to(q.dtype), v)


def flash_attn_fn():
    """An ``AttnFn`` (q, k, v -> context) for models.gpt, causal."""
    def attn(q, k, v):
        return flash_attention(q, k, v, causal=True)
    # capability marker: GQA callers may pass unexpanded [b, kv_heads, s, d]
    attn.supports_gqa = True
    return attn
