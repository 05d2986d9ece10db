"""The port's profiler, profile store, input pipeline and validation against
the JAX package's: a profile directory the port writes on the CPU loads
through ``metis_tpu.profiles.ProfileStore.from_dir`` with the same layer
count, keys and parameter bytes as the JAX profiler's on the same
``ModelSpec``, and both stores write the same JSON byte for byte.
"""
import io
import json

import numpy as np
import pytest
import torch

from metis_tpu.core.config import ModelSpec as JModelSpec
from metis_tpu.core.types import UniformPlan as JUniformPlan
from metis_tpu.data import pipeline as jpipe
from metis_tpu.profiles import profiler as jprof
from metis_tpu.profiles import store as jstore
from metis_tpu.validation import ValidationReport as JValidationReport
from metis_tpu_torch import cli
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.core.events import EventLog
from metis_tpu_torch.core.timing import forced_scalar, two_point_queue_ms
from metis_tpu_torch.core.types import UniformPlan
from metis_tpu_torch.data import pipeline as tpipe
from metis_tpu_torch.profiles import profiler as tprof
from metis_tpu_torch.profiles import store as tstore
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.validation import ValidationReport, validate_uniform_plan

# the suite runs in several workers at once; one intra-op thread keeps these
# tiny tensors from contending with the other workers' timing tests
torch.set_num_threads(1)

SPEC = dict(name="tiny", num_layers=4, hidden_size=64, sequence_length=32,
            vocab_size=128, num_heads=4, attn="flash")
FAST = dict(warmup=1, iters=1)


@pytest.fixture(scope="module")
def jax_store():
    return jprof.profile_model(JModelSpec(**SPEC), tps=(1,), bss=(1, 2),
                               config=jprof.ProfilerConfig(**FAST))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_profile")
    stream = io.StringIO()
    store = tprof.profile_model(ModelSpec(**SPEC), tps=(1, 2, 3), bss=(1, 2),
                                device="cpu", config=tprof.ProfilerConfig(**FAST),
                                events=EventLog(stream=stream))
    store.dump_to_dir(out, {"model_name": SPEC["name"], "attn": SPEC["attn"]})
    events = [json.loads(line) for line in stream.getvalue().splitlines()]
    return out, store, events


def test_jax_planner_loads_the_port_profile(jax_store, port_run):
    out, _, _ = port_run
    loaded = jstore.ProfileStore.from_dir(out)
    assert loaded.attn == "flash"
    assert loaded.model.num_layers == jax_store.model.num_layers == 4
    assert sorted(loaded.configs()) == sorted(jax_store.configs())
    assert (loaded.model.params_per_layer_bytes
            == jax_store.model.params_per_layer_bytes)
    for key in loaded.configs():
        prof = loaded.get(*key)
        assert len(prof.layer_times_ms) == len(prof.layer_memory_mb) == 4
        assert all(t > 0 for t in prof.layer_times_ms)
        assert abs(prof.fb_sync_ms) < 1e-9  # layer times sum to the total
    meta = loaded.type_meta["CPU"]
    assert meta.optimizer_time_ms > 0 and meta.batch_generator_ms > 0


def test_tps_beyond_one_device_are_skipped_with_events(port_run):
    _, store, events = port_run
    assert store.configs() == [("CPU", 1, 1), ("CPU", 1, 2)]
    skipped = {e["tp"]: e["reason"] for e in events
               if e["event"] == "profile_skipped"}
    assert set(skipped) == {2, 3}
    assert "does not divide" in skipped[3]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "profile_started" and kinds[-1] == "profile_finished"
    assert kinds.count("profile_measured") == 2


@pytest.mark.parametrize("decode", [False, True], ids=["train", "decode"])
def test_store_json_is_byte_identical(tmp_path, decode):
    times, mems = (1.5, 2.25, 2.25, 0.75), (10.0, 20.5, 20.5, 5.0)
    extra = dict(decode_layer_times_ms=(0.1, 0.2, 0.2, 0.05),
                 decode_context_len=32) if decode else {}
    dirs = []
    for mod, name in ((jstore, "jax"), (tstore, "port")):
        prof = mod.LayerProfile(layer_times_ms=times, layer_memory_mb=mems,
                                fb_sync_ms=0.5, **extra)
        meta = mod.ModelProfileMeta(4, 3.5, 0.25, (100, 200, 200, 50))
        store = mod.ProfileStore({("H100", 1, 4): prof}, meta,
                                 {"H100": mod.DeviceTypeMeta(3.5, 0.25)})
        d = tmp_path / name
        store.dump_to_dir(d, {"model_name": "m", "attn": "flash"})
        dirs.append(d)
    (a,), (b,) = (sorted(d.iterdir()) for d in dirs)
    assert a.name == b.name == "DeviceType.H100_tp1_bs4.json"
    assert a.read_bytes() == b.read_bytes()
    back = tstore.ProfileStore.from_dir(dirs[0])
    assert back.get("H100", 1, 4).layer_times_ms == times
    assert back.attn == "flash"


def test_infer_device_type_on_the_host():
    assert tprof.infer_device_type("cpu") == "CPU"


def test_cli_profile_writes_what_the_planner_reads(tmp_path):
    args = ["profile", "--num-layers", "3", "--hidden-size", "32", "--seq-len",
            "16", "--vocab-size", "64", "--num-heads", "2", "--attn", "flash",
            "--bss", "1", "--warmup", "1", "--iters", "1", "--device", "cpu",
            "--output-dir", str(tmp_path)]
    assert cli.main(args) == 0
    loaded = jstore.ProfileStore.from_dir(tmp_path)
    assert loaded.configs() == [("CPU", 1, 1)] and loaded.attn == "flash"
    for decode_flags in (["--decode"], ["--decode-context", "16"]):
        with pytest.raises(NotImplementedError):
            cli.main(args + decode_flags)
    assert cli.MODEL_SIZE_PRESETS["1.5B"] == dict(
        num_layers=10, hidden_size=4096, seq_len=1024, vocab_size=51200,
        num_heads=32)


def test_host_batches_match_the_jax_pipeline():
    ds_j = jpipe.TokenDataset.synthetic(100, 32 * 9 + 1, 32, seed=3)
    ds_t = tpipe.TokenDataset.synthetic(100, 32 * 9 + 1, 32, seed=3)
    np.testing.assert_array_equal(ds_j.tokens, ds_t.tokens)
    gj = jpipe.batch_source(ds_j, 2, shuffle_seed=5)
    gt = tpipe.batch_source(ds_t, 2, shuffle_seed=5)
    for _ in range(6):  # crosses an epoch boundary (4 batches per epoch)
        (tj, yj), (tt, yt) = gj(), gt()
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(yt, yj)
    on_host = tpipe.batch_source(ds_t, 2, device="cpu")()
    assert isinstance(on_host, torch.Tensor) and on_host.shape == (2, 32)


def test_two_point_timing_and_fence():
    calls = []
    ms = two_point_queue_ms(lambda n: calls.extend([1] * n) or torch.ones(2), 3)
    assert ms > 0 and len(calls) == 3 * (1 + 2 + 2 + 4)
    assert forced_scalar({"a": [torch.full((3,), 2.0)]}) == 2.0


def _cpu_cluster(cluster_mod, devices: int):
    spec = cluster_mod.DeviceSpec("CPU", 8, intra_bw_gbps=50, inter_bw_gbps=10)
    return cluster_mod.ClusterSpec.homogeneous("CPU", 1, devices, spec=spec)


def test_validation_on_the_host(port_run):
    """The prediction is the estimator's, and equals the JAX package's
    ``UniformCostEstimator`` on the same profile directory."""
    from metis_tpu.cluster import spec as jcluster
    from metis_tpu.core.config import SearchConfig as JSearchConfig
    from metis_tpu.cost.estimator import EstimatorOptions as JOptions
    from metis_tpu.cost.estimator import UniformCostEstimator as JEstimator
    from metis_tpu.cost.volume import TransformerVolume as JVolume
    from metis_tpu.planner.api import plan_uniform as jplan_uniform
    from metis_tpu_torch.cluster import spec as tcluster
    from metis_tpu_torch.core.config import SearchConfig
    from metis_tpu_torch.cost.estimator import EstimatorOptions, UniformCostEstimator
    from metis_tpu_torch.cost.volume import TransformerVolume
    from metis_tpu_torch.planner.api import plan_uniform

    out, store, _ = port_run
    jstore_ = jstore.ProfileStore.from_dir(out)
    model, jmodel = ModelSpec(**SPEC), JModelSpec(**SPEC)
    plan = UniformPlan(dp=1, pp=1, tp=1, mbs=2, gbs=4)
    config, jconfig = SearchConfig(gbs=4), JSearchConfig(gbs=4)
    est = UniformCostEstimator(
        _cpu_cluster(tcluster, 1), store,
        TransformerVolume(model, store.model.params_per_layer_bytes),
        EstimatorOptions.from_config(config))
    jest = JEstimator(
        _cpu_cluster(jcluster, 1), jstore_,
        JVolume(jmodel, jstore_.model.params_per_layer_bytes),
        JOptions.from_config(jconfig))
    predicted = est.get_cost(plan, "CPU").total_ms
    assert predicted == jest.get_cost(JUniformPlan(1, 1, 1, 2, 4), "CPU").total_ms
    report = validate_uniform_plan(plan, predicted, model,
                                   device="cpu", steps=2, warmup=1)
    assert report.measured_ms > 0 and np.isfinite(report.error_pct)
    # several devices: the plans come from plan_uniform, priced as the JAX
    # package prices them, and this slice's executor refuses to run them
    res = plan_uniform(_cpu_cluster(tcluster, 2), store, model, config,
                       include_oom=True)
    jres = jplan_uniform(_cpu_cluster(jcluster, 2), jstore_, jmodel, jconfig,
                         include_oom=True)
    assert [(r.plan.dp, r.plan.mbs, r.cost.total_ms) for r in res.plans] == [
        (r.plan.dp, r.plan.mbs, r.cost.total_ms) for r in jres.plans]
    two = next(r for r in res.plans if r.plan.dp == 2)
    with pytest.raises(MetisError, match="needs 2 devices"):
        validate_uniform_plan(two.plan, two.cost.total_ms, model,
                              device="cpu", steps=1, warmup=0)


def test_validation_report_matches_jax():
    t = ValidationReport(UniformPlan(1, 1, 1, 4, 4), 110.0, 100.0, 5)
    j = JValidationReport(JUniformPlan(1, 1, 1, 4, 4), 110.0, 100.0, 5)
    assert t.to_json_dict() == j.to_json_dict()
    assert t.within(10.0) and not t.within(9.9)


FAMILY_SPECS = {
    "llama": dict(SPEC, name="tiny-llama", family="llama", num_kv_heads=2),
    "moe": dict(SPEC, name="tiny-moe", num_experts=4, expert_top_k=2),
}


@pytest.mark.parametrize("family", list(FAMILY_SPECS))
def test_family_profile_matches_the_jax_profilers(tmp_path, family):
    """The LLaMA and MoE families profile through the family's closures
    (LLaMA: no positions, an RMSNorm head; MoE: the aux loss in the block's
    graph): the same layer rows, parameter bytes and JSON keys as the JAX
    profiler's on the same ``ModelSpec``, read back by both stores."""
    spec = FAMILY_SPECS[family]
    jax_store = jprof.profile_model(JModelSpec(**spec), tps=(1,), bss=(1,),
                                    config=jprof.ProfilerConfig(**FAST))
    store = tprof.profile_model(ModelSpec(**spec), tps=(1,), bss=(1,),
                                device="cpu", config=tprof.ProfilerConfig(**FAST))
    assert store.model.num_layers == jax_store.model.num_layers == 4
    assert store.model.params_per_layer_bytes == jax_store.model.params_per_layer_bytes
    prof = store.get("CPU", 1, 1)
    assert len(prof.layer_times_ms) == len(prof.layer_memory_mb) == 4
    assert all(t > 0 for t in prof.layer_times_ms)
    for name, st in (("port", store), ("jax", jax_store)):
        st.dump_to_dir(tmp_path / name, {"model_name": spec["name"], "attn": "flash"})
    (port_file,), (jax_file,) = (sorted((tmp_path / n).iterdir()) for n in ("port", "jax"))
    assert port_file.name == jax_file.name

    def keys(d):
        return {k: keys(v) for k, v in d.items()} if isinstance(d, dict) else None

    assert keys(json.loads(port_file.read_text())) == keys(json.loads(jax_file.read_text()))
    loaded = jstore.ProfileStore.from_dir(tmp_path / "port")
    assert loaded.get("CPU", 1, 1).layer_times_ms == prof.layer_times_ms
