"""The port's GPT (metis_tpu_torch.models.gpt) against metis_tpu.models.gpt on
the same weights: the JAX parameter tree goes through
``metis_tpu_torch.models.convert`` leaf for leaf, and the tokens come from
numpy.  Both run in fp32 on the CPU; with ``attn="flash"`` JAX runs its
Pallas kernels in interpret mode and the port its kernels' plain versions.

Tolerance: 1e-4 relative and 2e-5 absolute in fp32 — the two frameworks sum
the products, layer norms and softmaxes in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metis_tpu.models import gpt as jgpt
from metis_tpu_torch.models import convert
from metis_tpu_torch.models import gpt as tgpt

# the suite runs in several workers at once; one intra-op thread keeps these
# tiny tensors from contending with the other workers' timing tests
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
SHAPE = dict(vocab_size=128, seq_len=32, hidden=64, num_heads=4, num_blocks=2)


def _setup(attn):
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jnp.float32, attn=attn)
    tcfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32, attn=attn)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = convert.from_numpy_tree(np_params, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SHAPE["vocab_size"], (2, SHAPE["seq_len"]),
                          dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    return jcfg, tcfg, jparams, tparams, tokens, targets


def test_conversion_keeps_the_layout():
    _, tcfg, jparams, tparams, _, _ = _setup("dense")
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jleaves) == sum(len(sub) for sub in tparams.values())
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        t = tparams[keys[0]][keys[1]]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tparams["blocks"]["qkv"].shape == (2, 3, 64, 64)
    assert tparams["blocks"]["qkv_bias"].shape == (2, 3, 64)
    # a port-initialised tree has the same structure and shapes
    ours = tgpt.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {k: {kk: tuple(v.shape) for kk, v in sub.items()}
            for k, sub in ours.items()} == \
        {k: {kk: tuple(v.shape) for kk, v in sub.items()}
         for k, sub in tparams.items()}
    assert tgpt.param_count(ours) == sum(
        np.asarray(x).size for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_logits_match(attn):
    jcfg, tcfg, jparams, tparams, tokens, _ = _setup(attn)
    want = jgpt.forward(jparams, jnp.asarray(tokens), jcfg)
    got = tgpt.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_loss_and_grads_match(attn):
    jcfg, tcfg, jparams, tparams, tokens, targets = _setup(attn)
    want_loss, want_grads = jax.value_and_grad(jgpt.next_token_loss)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)

    leaves = {k: {kk: v.requires_grad_() for kk, v in sub.items()}
              for k, sub in tparams.items()}
    loss = tgpt.next_token_loss(leaves, torch.from_numpy(tokens),
                                torch.from_numpy(targets), tcfg)
    flat = [(k, kk, v) for k, sub in leaves.items() for kk, v in sub.items()]
    grads = torch.autograd.grad(loss, [v for _, _, v in flat])

    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for (k, kk, _), g in zip(flat, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[k][kk]),
                                   **TOL, err_msg=f"{k}/{kk}")


def test_remat_gives_the_same_grads():
    _, tcfg, _, tparams, tokens, targets = _setup("flash")
    outs = []
    for remat in (False, True):
        cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32, attn="flash",
                             remat=remat)
        leaves = [v.detach().clone().requires_grad_()
                  for sub in tparams.values() for v in sub.values()]
        it = iter(leaves)
        tree = {k: {kk: next(it) for kk in sub} for k, sub in tparams.items()}
        loss = tgpt.next_token_loss(tree, torch.from_numpy(tokens),
                                    torch.from_numpy(targets), cfg)
        outs.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b)


def test_layer_norm_uses_population_variance_and_tanh_gelu():
    """The two defaults that differ between the frameworks."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    bias = rng.standard_normal(16, dtype=np.float32)
    want = jgpt._layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tgpt._layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), **TOL)
