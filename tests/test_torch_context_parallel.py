"""Context parallelism of the port — ring attention and Ulysses — against
the JAX package.

The same seeded numpy inputs go through the reference's
``ring_attention_local`` / ``make_ulysses_attention`` and train step on its
virtual 8-device CPU mesh, and through the port's on gloo ranks
(``execution.dist.spawn``) that run the kernels' plain versions.  fp32
throughout; tolerance 1e-4 relative / 2e-5 absolute (logits 1e-4 / 1e-4,
``tests/test_torch_dist.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from metis_tpu.models import gpt as jgpt
from metis_tpu.models import llama as jllama
from metis_tpu.ops.ring_attention import make_ring_attention
from metis_tpu.ops.ulysses import make_ulysses_attention
from metis_tpu_torch.core.sharding import slice_leaf
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import mesh as tmesh
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.models import llama as tllama
from metis_tpu_torch.models.parallel import seq_to_heads
from metis_tpu_torch.testing import attention_rank, run_plans_rank
from torch_gspmd_reference import (
    expected,
    port_plan,
    reference_run,
    reference_start,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
B, H, S, D = 2, 4, 32, 8
SPEC = (None, "tp", "sp", None)


def _inputs(h=H, kvh=H, s=S, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, D), (b, kvh, s, D), (b, kvh, s, D), (b, h, s, D))]


def _full_attention(q, k, v, dout):
    """Dense causal attention on the whole tensors, with its gradients."""
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    out = tgpt.causal_attention(q, k.repeat_interleave(rep, 1),
                                v.repeat_interleave(rep, 1))
    out.backward(torch.from_numpy(dout))
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _jax_attention(fn, mesh, spec, q, k, v, dout):
    """``fn`` on arrays placed with ``spec`` on ``mesh``, and its gradients
    for the output gradient ``dout``."""
    placed = [jax.device_put(jnp.asarray(t), NamedSharding(mesh, spec))
              for t in (q, k, v)]
    with mesh:
        out, vjp = jax.vjp(jax.jit(fn), *placed)
        grads = vjp(jnp.asarray(dout))
    return [np.asarray(t) for t in (out, *grads)]


def _check(rank, want, what):
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(rank[name], slice_leaf(w, SPEC, rank["slots"]),
                                   **TOL, err_msg=f"{what} {name} {rank['slots']}")


# -- ring attention --------------------------------------------------------------

@pytest.fixture(scope="module", params=(2, 4), ids=lambda cp: f"cp{cp}")
def ring(request):
    """One launch per ring size: the flash and dense rings at MHA and GQA,
    on the port's ranks and the reference's dense ring."""
    cp = request.param
    mesh = Mesh(np.array(jax.devices()[:cp]), ("sp",))
    cases = {}
    jobs = []
    for kvh in (H, 2):
        q, k, v, dout = _inputs(kvh=kvh)
        ref = _jax_attention(make_ring_attention(mesh, "sp", impl="dense"), mesh,
                             P(None, None, "sp", None), q, k, v, dout)
        cases[kvh] = (ref, _full_attention(q, k, v, dout))
        host = [torch.from_numpy(t) for t in (q, k, v, dout)]
        jobs += [dict(mode=m, shape=(cp, 1), q=host[0], k=host[1], v=host[2],
                      dout=host[3]) for m in ("ring", "ring_dense")]
    ranks = tdist.spawn(attention_rank, cp, "gloo", ["cpu"] * cp, jobs)
    return cp, cases, ranks


@pytest.mark.parametrize("kvh", (H, 2), ids=("mha", "gqa"))
@pytest.mark.parametrize("impl", ("flash", "dense"))
def test_ring_attention_matches_jax_and_full_attention(ring, kvh, impl):
    """Output and dq, dk, dv of each rank's block against the reference's
    dense ring and against full causal attention; GQA's K/V and dK/dV
    rotate grouped."""
    _, cases, ranks = ring
    job = [H, 2].index(kvh) * 2 + (impl == "dense")
    ref, full = cases[kvh]
    for r in ranks:
        _check(r[job], ref, f"{impl} vs the reference's ring")
        _check(r[job], full, f"{impl} vs full attention")


def test_ring_rank_r_runs_r_plus_one_blocks(ring):
    """Rank r of the flash ring computes its self block and its r past
    blocks and skips the future ones: r + 1 calls of B1 (stats mode), B2
    and B3 each."""
    cp, _, ranks = ring
    for r in ranks:
        pos = r[0]["slots"]["sp"][0]
        assert r[0]["calls"] == {"flash_attention_stats": pos + 1,
                                 "fa_bwd_dq": pos + 1, "fa_bwd_dkv": pos + 1}
    assert sorted(r[0]["slots"]["sp"][0] for r in ranks) == list(range(cp))


def test_flash_ring_matches_the_reference_pallas_ring():
    """The reference's own flash ring (its Pallas kernels in interpret mode)
    at its tests' tiny shape (seq 32, 2 heads, head dim 8) against the
    port's flash ring on the kernels' plain versions."""
    q, k, v, dout = _inputs(h=2, kvh=2, b=1, seed=3)
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    ref = _jax_attention(make_ring_attention(mesh, "sp", impl="pallas"), mesh,
                         P(None, None, "sp", None), q, k, v, dout)
    host = [torch.from_numpy(t) for t in (q, k, v, dout)]
    ranks = tdist.spawn(attention_rank, 2, "gloo", ["cpu"] * 2, [dict(
        mode="ring", shape=(2, 1), q=host[0], k=host[1], v=host[2],
        dout=host[3])])
    for r in ranks:
        _check(r[0], ref, "flash vs the reference's pallas ring")


# -- Ulysses ---------------------------------------------------------------------

ULYSSES = [(2, 1), (2, 2)]


@pytest.mark.parametrize("shape", ULYSSES, ids=("cp2", "cp2_tp2"))
def test_ulysses_matches_jax_and_full_attention(shape):
    """cp 2, alone and with the heads already split over tp 2: the
    reference's ``make_ulysses_attention`` (heads over ``(tp, sp)`` at
    attention time) and full causal attention."""
    cp, tp = shape
    q, k, v, dout = _inputs(h=8, kvh=8, seed=1)
    mesh = Mesh(np.array(jax.devices()[:cp * tp]).reshape(cp, tp), ("sp", "tp"))
    ref = _jax_attention(make_ulysses_attention(mesh, "sp", head_axes=("tp",)),
                         mesh, P(None, "tp", "sp", None), q, k, v, dout)
    full = _full_attention(q, k, v, dout)
    host = [torch.from_numpy(t) for t in (q, k, v, dout)]
    ranks = tdist.spawn(attention_rank, cp * tp, "gloo", ["cpu"] * (cp * tp), [
        dict(mode="a2a", shape=shape, q=host[0], k=host[1], v=host[2],
             dout=host[3])])
    for r in ranks:
        _check(r[0], ref, "ulysses vs the reference's")
        _check(r[0], full, "ulysses vs full attention")


class _Group:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def test_ulysses_heads_that_do_not_divide_raise():
    """A rank's heads must split over cp (the search dooms a2a plans whose
    heads stop dividing); the trade raises before any collective."""
    with pytest.raises(ValueError, match="3 heads do not split over the 2"):
        seq_to_heads(torch.zeros(1, 3, 4, 8), _Group(2))


# -- train steps -----------------------------------------------------------------

SHAPE = dict(vocab_size=128, seq_len=32, hidden=64, num_heads=4, num_blocks=2,
             ffn_multiplier=2)
GBS, STEPS = 4, 3
PLANS = {"cp2_ring": dict(cp=2), "cp2_a2a": dict(cp=2, cp_mode="a2a"),
         "cp2_tp2_sp": dict(cp=2, tp=2, sp=True)}
FAMILIES = {"gpt": (jgpt.GPTConfig, tgpt.GPTConfig, {}),
            "llama": (jllama.LlamaConfig, tllama.LlamaConfig,
                      {"num_kv_heads": 2})}


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, SHAPE["vocab_size"], (GBS, SHAPE["seq_len"] + 1),
                         dtype=np.int32) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def trained(batches):
    """Every plan of ``PLANS`` for both families: the reference's runs, and
    the port's ranks, one launch per world size."""
    refs, jobs = {}, {}
    host = [(torch.from_numpy(b[:, :-1]), torch.from_numpy(b[:, 1:]))
            for b in batches]
    for fam, (jcls, tcls, extra) in FAMILIES.items():
        jcfg = jcls(**SHAPE, **extra, dtype=jnp.float32)
        tcfg = tcls(**SHAPE, **extra, dtype=torch.float32)
        start = reference_start(jcfg, batches[0])
        for name, plan in PLANS.items():
            refs[fam, name] = (tcfg, {**start, **reference_run(jcfg, batches, **plan)})
            world = plan.get("cp", 1) * plan.get("tp", 1)
            jobs.setdefault(world, []).append(((fam, name), dict(
                artifact_json=port_plan(gbs=GBS, **plan), cfg=tcfg,
                init=start["params"], batches=host, forward_tokens=host[0][0],
                return_params=True, first_grads="arrays")))
    out = {}
    for world, items in jobs.items():
        ranks = tdist.spawn(run_plans_rank, world, "gloo", ["cpu"] * world,
                            [job for _, job in items])
        for i, (key, _) in enumerate(items):
            out[key] = [r[i] for r in ranks]
    return refs, out


CASES = [(fam, name) for fam in FAMILIES for name in PLANS]


def _specs(tcfg, plan):
    return (tmesh.llama_param_specs(tcfg, tp_size=plan.get("tp", 1))
            if isinstance(tcfg, tllama.LlamaConfig) else tmesh.gpt_param_specs(tcfg))


@pytest.mark.parametrize("fam,name", CASES)
def test_cp_logits_and_losses_match_jax(trained, fam, name):
    """Each rank's logits (its cp block of the sequence, its tp block of the
    vocabulary) before training and the three losses, on the gspmd route."""
    refs, out = trained
    _, ref = refs[fam, name]
    for r in out[fam, name]:
        assert r["kind"] == "gspmd"
        np.testing.assert_allclose(
            r["logits"], slice_leaf(ref["logits"], ("dp", "sp", "tp"), r["slots"]),
            **LOGITS_TOL, err_msg=f"{fam} {name} {r['slots']}")
        np.testing.assert_allclose(r["losses"], ref["losses"], **TOL)


@pytest.mark.parametrize("fam,name", CASES)
def test_cp_first_gradients_and_leaves_match_jax(trained, fam, name):
    """The first step's gradient of every leaf (positions and norms summed
    over the sequence blocks, and under sp over tp) and every leaf after
    three steps."""
    refs, out = trained
    tcfg, ref = refs[fam, name]
    specs = _specs(tcfg, PLANS[name])
    for r in out[fam, name]:
        for tree, want, grad in ((r["grads"], ref["grads"], True),
                                 (r["params"], ref["final"], False)):
            for group, sub in tree.items():
                for leaf, got in sub.items():
                    w = expected(want[group][leaf], specs[group][leaf], r,
                                 (group, leaf), 0, grad)
                    np.testing.assert_allclose(
                        got, w, **TOL,
                        err_msg=f"{fam} {name} {group}.{leaf} grad={grad} {r['slots']}")
