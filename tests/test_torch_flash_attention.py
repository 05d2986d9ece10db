"""The port's flash attention (metis_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

On CPU tensors the port runs the plain PyTorch versions of its three kernels
(dense forward with the kernels' (m, l) statistics, hand-written dQ and
dK/dV formulas), so these tests hold the plain versions — the references the
CUDA kernels are checked against on the card — to the Pallas kernels.  Inputs
come from numpy with a fixed seed and go to both packages.

Tolerance: 2e-5 absolute and relative, in fp32 — both sides accumulate in
fp32, blockwise (JAX) against dense (port), so only summation order differs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metis_tpu_torch.ops import flash_attention as tfa

# the suite runs in several workers at once; one intra-op thread keeps these
# tiny tensors from contending with the other workers' timing tests
torch.set_num_threads(1)

# the package re-exports a function under the module's name
jfa = importlib.import_module("metis_tpu.ops.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    g = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    return q, k, v, g


# (name, b, hq, hkv, s, d, causal, block_q, block_kv) — the blocks set the
# JAX kernel's tiling; the port's plain path has none
CASES = [
    ("causal", 1, 4, 4, 64, 16, True, 16, 16),
    ("noncausal", 1, 4, 4, 64, 16, False, 32, 32),
    ("uneven_blocks", 1, 2, 2, 48, 8, True, 24, 8),
    ("wide_kv_blocks", 1, 2, 2, 64, 8, True, 8, 32),
    ("gqa_causal", 1, 4, 2, 64, 16, True, 16, 16),
    ("gqa_noncausal_mqa", 2, 4, 1, 32, 8, False, 16, 16),
    ("untileable_len", 1, 2, 2, 37, 8, True, 16, 16),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_matches_pallas(case):
    _, b, hq, hkv, s, d, causal, bq, bkv = case
    q, k, v, g = _inputs(0, b, hq, hkv, s, d)

    def jax_fn(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_kv=bkv, interpret=True)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, a, w in zip("qkv", got_grads, want_grads):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,hkv", [(False, 4), (True, 4), (False, 2)],
                         ids=["full", "causal", "gqa"])
def test_stats_and_merge_match_pallas(causal, hkv):
    """Stats mode (normalize=False, return_stats=True): the raw (acc, m, l)
    state, two KV halves merged with ``merge_stats``, and ``finalize_stats``
    — the ring-attention building blocks."""
    q, k, v, _ = _inputs(1, 1, 4, hkv, 64, 16)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)

    want = jfa.flash_attention_stats(jq, jk, jv, causal=causal, block_q=16,
                                     block_kv=16, interpret=True)
    got = tfa.flash_attention_stats(tq, tk, tv, causal=causal)
    for name, a, w in zip(("acc", "m", "l"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)

    if causal:
        return  # a later KV shard is not top-left causal against the queries
    halves = [(slice(None), slice(None), slice(0, 32)),
              (slice(None), slice(None), slice(32, 64))]
    jstates = [jfa.flash_attention_stats(jq, jk[h], jv[h], block_q=16,
                                         block_kv=16, interpret=True)
               for h in halves]
    tstates = [tfa.flash_attention_stats(tq, tk[h], tv[h]) for h in halves]
    want_out = jfa.finalize_stats(jfa.merge_stats(*jstates))
    got_out = tfa.finalize_stats(tfa.merge_stats(*tstates))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    full = tfa.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(got_out.numpy(), full.numpy(), **TOL)


def test_dense_causal_attention_matches_jax():
    q, k, v, _ = _inputs(2, 1, 2, 2, 24, 8)
    want = jfa.dense_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    got = tfa.dense_causal_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_plain_versions_take_folded_heads():
    """The three plain versions at the kernels' folded interface agree with
    autograd through the public API, GQA included (K/V never expanded by the
    caller)."""
    q, k, v, g = _inputs(3, 2, 4, 2, 40, 8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))

    fold = lambda t: t.detach().reshape(-1, *t.shape[2:])  # noqa: E731
    heads = dict(q_heads=4, kv_heads=2, causal=True)
    o, m, l = tfa.fa_fwd(fold(tq), fold(tk), fold(tv), **heads)
    lse = tfa.logsumexp_of(m, l)
    do = fold(torch.from_numpy(g))
    delta = (do * o).sum(-1)
    dq = tfa.fa_bwd_dq(fold(tq), fold(tk), fold(tv), do, lse, delta, **heads)
    dk, dv = tfa.fa_bwd_dkv(fold(tq), fold(tk), fold(tv), do, lse, delta, **heads)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), fold(ref).numpy(), **TOL)
    assert tfa.launch_counts == {"fa_fwd": 0, "fa_bwd_dq": 0, "fa_bwd_dkv": 0}


def test_rejects_heads_that_do_not_group():
    t = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention(t, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
