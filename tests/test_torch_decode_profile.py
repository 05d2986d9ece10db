"""The port's decode-mode profiling and remat fraction
(``metis_tpu_torch.profiles.profiler``) against the JAX package's.

The decode closures (embedding at the last position, one block attending
over a resident KV cache, the head) run on the same weights — the
reference's parameter tree converted leaf for leaf — and the same numpy
inputs as ``metis_tpu.profiles.profiler.LayerProfiler._make_decode_fns``:
within 1e-5 in fp32 and 2e-2 (norm of the difference over the norm of the
reference) in bf16.  A cache filled with a prefix's own K and V gives the
block's output at the next position (1e-5 in fp32); tp 2 on two gloo ranks
gives tp 1's outputs (1e-5).  Profiling with ``decode=True`` writes decode
tables that both packages' stores read and write byte for byte, and the
remat fraction stays in its clamp.
"""
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metis_tpu.core.config import ModelSpec as JModelSpec
from metis_tpu.core.errors import MetisError as JMetisError
from metis_tpu.models import gpt as jgpt
from metis_tpu.profiles import profiler as jprof
from metis_tpu.profiles import store as jstore
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.core.events import EventLog
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.models import convert
from metis_tpu_torch.models import gpt as tgpt
from metis_tpu_torch.profiles import profiler as tprof
from metis_tpu_torch.profiles import store as tstore
from metis_tpu_torch.testing import decode_rank, prefix_kv

# the suite runs in several workers at once; one intra-op thread keeps these
# tiny tensors from contending with the other workers' timing tests
torch.set_num_threads(1)

SHAPE = dict(vocab_size=128, seq_len=32, hidden=64, num_heads=4, num_blocks=2)
SPEC = dict(name="tiny", num_layers=4, hidden_size=64, sequence_length=32,
            vocab_size=128, num_heads=4, attn="flash")
FAST = tprof.ProfilerConfig(warmup=1, iters=1)
BS, CTX = 2, 16
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _params(jdt):
    jcfg = jgpt.GPTConfig(**SHAPE, dtype=jdt)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    hd = SHAPE["hidden"] // SHAPE["num_heads"]
    return (rng.integers(0, SHAPE["vocab_size"], (BS, 1)).astype(np.int32),
            rng.standard_normal((BS, 1, SHAPE["hidden"])).astype(np.float32),
            rng.standard_normal((BS, SHAPE["num_heads"], CTX, hd)).astype(np.float32),
            rng.standard_normal((BS, SHAPE["num_heads"], CTX, hd)).astype(np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("step", ["embed", "block", "head"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_steps_match_the_reference(dtype, step):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, jparams, np_params = _params(jdt)
    tcfg = tgpt.GPTConfig(**SHAPE, dtype=tdt)
    tparams = convert.from_numpy_tree(np_params, device="cpu")
    jfns = jprof.LayerProfiler(JModelSpec(**SPEC), devices=jax.devices("cpu")
                               )._make_decode_fns(jcfg)
    tfns = tprof.decode_fns(tcfg)
    tokens, x, kc, vc = _inputs()
    jx, jk, jv = (jnp.asarray(a, jdt) for a in (x, kc, vc))
    tx, tk, tv = (torch.from_numpy(a).to(tdt) for a in (x, kc, vc))
    with torch.no_grad():
        if step == "embed":
            want = jfns[0](jparams["embed"], jnp.asarray(tokens))
            got = tfns[0](tparams["embed"], torch.from_numpy(tokens))
        elif step == "block":
            j0 = jax.tree.map(lambda a: a[0], jparams["blocks"])
            want = jfns[1](j0, jx, jk, jv)
            got = tfns[1](tprof.cast_once("blocks", {
                n: leaf[0] for n, leaf in tparams["blocks"].items()}, tdt),
                tx, tk, tv)
        else:
            want = jfns[2](jparams["head"], jx)
            got = tfns[2](tprof.cast_once("head", tparams["head"], tdt), tx)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    assert got.dtype == (torch.float32 if step == "head" else tdt)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    else:
        assert _rel(got.float().numpy(), want) <= tol


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_real_prefix_gives_the_next_position(attn):
    """The cache of a prefix's own K and V: the decode step of token s is
    the block's output at position s over the s + 1 tokens."""
    cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32, attn=attn)
    params = tgpt.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    layer = {n: leaf[0] for n, leaf in params["blocks"].items()}
    x = torch.randn((BS, CTX + 1, cfg.hidden), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = tgpt.block_forward(x, layer, cfg, tgpt.default_attention(cfg))[:, -1:]
        k, v = prefix_kv(layer, x[:, :-1], cfg)
        got = tprof.decode_fns(cfg)[1](layer, x[:, -1:], k, v)
    assert k.shape == (BS, cfg.num_heads, CTX, cfg.head_dim)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_tp2_on_two_ranks_equals_tp1():
    _, _, np_params = _params(jnp.float32)
    cfg = tgpt.GPTConfig(**SHAPE, dtype=torch.float32)
    inputs = _inputs(1)
    ranks = tdist.spawn(decode_rank, 2, "gloo", ["cpu", "cpu"], cfg, np_params,
                        *inputs)
    tparams = convert.from_numpy_tree(np_params, device="cpu")
    tokens, x, kc, vc = (torch.from_numpy(a) for a in inputs)
    embed_step, block_step, head_step = tprof.decode_fns(cfg)
    with torch.no_grad():
        want = {"embed": embed_step(tparams["embed"], tokens),
                "block": block_step({n: leaf[0] for n, leaf
                                     in tparams["blocks"].items()}, x, kc, vc),
                "head": head_step(tparams["head"], x)}
    for r in ranks:
        for name in ("embed", "block"):
            np.testing.assert_allclose(r[name], want[name].numpy(),
                                       rtol=1e-5, atol=1e-5)
    # the head's logits are split over the vocabulary
    np.testing.assert_allclose(np.concatenate([r["head"] for r in ranks], -1),
                               want["head"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_other_families_refuse_as_the_reference(family):
    extra = (dict(family="llama", num_kv_heads=2) if family == "llama"
             else dict(num_experts=2))
    spec = dict(SPEC, attn="dense", **extra)
    with pytest.raises(JMetisError) as theirs:
        jprof.profile_model(JModelSpec(**spec), decode=True,
                            config=jprof.ProfilerConfig(warmup=1, iters=1))
    with pytest.raises(MetisError) as ours:
        tprof.profile_model(ModelSpec(**spec), device="cpu", config=FAST,
                            decode=True)
    assert str(ours.value) == str(theirs.value) \
        == "decode profiling currently supports the GPT family only"


@pytest.fixture(scope="module")
def decode_run():
    stream = io.StringIO()
    store = tprof.profile_model(ModelSpec(**SPEC), tps=(1,), bss=(1, 2),
                                device="cpu", config=FAST, decode=True,
                                decode_context=16, events=EventLog(stream=stream))
    events = [json.loads(line) for line in stream.getvalue().splitlines()]
    return store, events


def test_decode_mode_measures_and_roundtrips(decode_run, tmp_path):
    store, _ = decode_run
    assert store.has_decode()
    for bs in (1, 2):
        p = store.get("CPU", 1, bs)
        assert p.has_decode and p.decode_context_len == 16
        assert len(p.decode_layer_times_ms) == SPEC["num_layers"]
        assert all(t > 0 for t in p.decode_layer_times_ms)
        # the blocks share one measurement, as the training rows do
        assert p.decode_layer_times_ms[1] == p.decode_layer_times_ms[2]
    store.dump_to_dir(tmp_path, {"model_name": SPEC["name"]})
    back = tstore.ProfileStore.from_dir(tmp_path)
    assert back.get("CPU", 1, 2).decode_layer_times_ms \
        == store.get("CPU", 1, 2).decode_layer_times_ms
    assert back.get("CPU", 1, 2).decode_context_len == 16


def test_decode_tables_round_trip_through_the_reference_store(decode_run, tmp_path):
    store, _ = decode_run
    extras = {"model_name": SPEC["name"], "attn": SPEC["attn"]}
    store.dump_to_dir(tmp_path / "port", extras)
    loaded = jstore.ProfileStore.from_dir(tmp_path / "port")
    assert loaded.has_decode()
    loaded.dump_to_dir(tmp_path / "jax", extras)
    for name in ("DeviceType.CPU_tp1_bs1.json", "DeviceType.CPU_tp1_bs2.json"):
        assert (tmp_path / "jax" / name).read_bytes() \
            == (tmp_path / "port" / name).read_bytes()
        assert "decode" in json.loads((tmp_path / "port" / name).read_text())


def test_decode_events_pass_the_schema(decode_run):
    from tools.check_events_schema import validate_events

    store, events = decode_run
    decode = [e for e in events if e["event"] == "decode_profile"]
    assert [(e["tp"], e["bs"], e["context_len"]) for e in decode] \
        == [(1, 1, 16), (1, 2, 16)]
    for e in decode:
        assert e["step_ms"] == round(sum(
            store.get("CPU", 1, e["bs"]).decode_layer_times_ms), 4)
        assert e["wall_s"] >= 0
    kinds = [e["event"] for e in events]
    # each decode_profile precedes its (tp, bs)'s profile_measured
    assert kinds.index("decode_profile") < kinds.index("profile_measured")
    assert validate_events(events) == []


def test_decode_defaults_off_and_context_defaults_to_seq_len():
    plain = tprof.profile_model(ModelSpec(**SPEC), device="cpu", config=FAST)
    assert not plain.has_decode()
    dec = tprof.profile_model(ModelSpec(**SPEC), device="cpu", config=FAST,
                              decode=True)
    assert dec.get("CPU", 1, 1).decode_context_len == SPEC["sequence_length"]


def test_tp2_decode_tables_on_two_ranks():
    store = tprof.profile_model(
        ModelSpec(**SPEC), tps=(1, 2), bss=(2,), device="cpu",
        devices=["cpu", "cpu"], config=FAST, decode=True, decode_context=8)
    assert store.decode_configs() == [("CPU", 1, 2), ("CPU", 2, 2)]
    tp2 = store.get("CPU", 2, 2)
    assert tp2.decode_context_len == 8
    assert all(t > 0 for t in tp2.decode_layer_times_ms)


def test_measure_remat_fraction_on_cpu():
    frac = tprof.measure_remat_fraction(ModelSpec(**SPEC), "cpu", iters=3,
                                        warmup=1)
    assert 0.15 <= frac <= 0.6


def test_cast_once_casts_only_the_product_matrices():
    cfg = tgpt.GPTConfig(**SHAPE)
    params = tgpt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    layer = tprof.cast_once("blocks", {n: leaf[0] for n, leaf
                                       in params["blocks"].items()}, torch.bfloat16)
    assert {n for n, leaf in layer.items() if leaf.dtype == torch.bfloat16} \
        == set(tgpt.COMPUTE_DTYPE_LEAVES["blocks"])
    assert all(not leaf.requires_grad for leaf in layer.values())
    # the fused qkv matrix: the same values, its input dimension outermost
    h = SHAPE["hidden"]
    assert torch.equal(layer["qkv"], params["blocks"]["qkv"][0].to(torch.bfloat16))
    assert layer["qkv"].stride() == (h, 3 * h, 1)
    embed = tprof.cast_once("embed", params["embed"], torch.bfloat16)
    assert all(leaf.dtype == torch.float32 for leaf in embed.values())
