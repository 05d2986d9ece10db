"""The hand-written CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA card and
``nvcc``; they carry the ``cuda`` marker and skip elsewhere.  This file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: 1e-2 per row, ||got - ref|| / ||ref|| over the last axis — the
kernels round P and dS to bf16 for the tensor cores and store bf16 outputs,
at most 2^-9 per element.  A row whose reference norm is below 1% of the RMS
row norm (dQ of the first causal row cancels to rounding noise) is held to
that floor.
"""
import pytest
import torch

from metis_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
REL_TOL = 1e-2
ROW_FLOOR = 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, want):
    """Worst per-row relative error over the last axis."""
    ref = torch.linalg.vector_norm(want.float(), dim=-1)
    floor = (ROW_FLOOR * ref.square().mean().sqrt()).clamp_min(1e-30)
    err = torch.linalg.vector_norm(got.float() - want.float(), dim=-1)
    return (err / torch.maximum(ref, floor)).max().item()


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (1, 4, 2, 100, 64, True),
    (2, 2, 2, 256, 128, False),
    (1, 8, 1, 65, 128, True),
    # lengths one short of and one past the 128-row tiles of B1 (query) and
    # B3 (key), where the causal diagonal meets the ragged edge
    (1, 4, 4, 127, 128, True),
    (2, 4, 4, 129, 128, True),
    (1, 4, 2, 129, 64, True),
    # g = 8 query heads per KV head: B3's loop over the group members
    (1, 16, 2, 1024, 128, True),
    # B2's 128-row Q tiles: the second warpgroup of the only tile has no
    # valid row; the last tile is half valid; non-causal with g = 4
    (1, 4, 4, 64, 128, True),
    (1, 4, 2, 192, 128, True),
    (1, 8, 2, 320, 64, False),
])
def test_kernels_match_plain_versions(card, b, hq, hkv, s, d, causal):
    gen = torch.Generator(device=card).manual_seed(0)

    def rnd(rows):
        return torch.randn(rows, s, d, generator=gen, device=card).bfloat16()

    q, k, v, do = rnd(b * hq), rnd(b * hkv), rnd(b * hkv), rnd(b * hq)
    heads = dict(q_heads=hq, kv_heads=hkv, causal=causal)
    for normalize in (True, False):
        got = fa.fa_fwd(q, k, v, normalize=normalize, **heads)
        want = fa.fa_fwd_plain(q, k, v, normalize=normalize, **heads)
        for a, w in zip(got, want):
            assert _rel(a, w) <= REL_TOL
    o, m, l = fa.fa_fwd_plain(q, k, v, **heads)
    lse, delta = fa.logsumexp_of(m, l), (do.float() * o.float()).sum(-1)
    assert _rel(fa.fa_bwd_dq(q, k, v, do, lse, delta, **heads),
                fa.fa_bwd_dq_plain(q, k, v, do, lse, delta, **heads)) <= REL_TOL
    for a, w in zip(fa.fa_bwd_dkv(q, k, v, do, lse, delta, **heads),
                    fa.fa_bwd_dkv_plain(q, k, v, do, lse, delta, **heads)):
        assert _rel(a, w) <= REL_TOL


def test_autograd_runs_the_three_kernels(card):
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(2, 4, 128, 64, generator=gen, device=card)
               .bfloat16().requires_grad_() for _ in range(3))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().sum().backward()
    assert fa.launch_counts == {"fa_fwd": 1, "fa_bwd_dq": 1, "fa_bwd_dkv": 1}
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 32)],
                         ids=["fp32", "d32"])
def test_unsupported_inputs_raise_on_the_card(card, dtype, d):
    t = torch.zeros(4, 64, d, device=card, dtype=dtype)
    with pytest.raises(NotImplementedError):
        fa.fa_fwd(t, t, t, q_heads=4, kv_heads=4, causal=True)
