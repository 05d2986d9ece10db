"""Parity fixtures of the port — the writers of ``metis_tpu/testing.py``.

One definition of the parity workload — the golden-run-shaped topology
(8xA100 + 8xT4, 4 per node, GPT-10L, gbs=128; ``results/hetero_cost_model``
inputs) with synthetic two-type profiles — plus its decode and spot
variants, the symmetric scale workload, and an in-process runner for the
upstream reference planner.  Built on the port's ``ClusterSpec``,
``SearchConfig`` and synthetic profiles, so a machine without JAX writes
the same files byte for byte.  Nothing here imports torch, so a host
process writes them without one; ``metis_tpu_torch.testing`` re-exports
every name.

The upstream checkout is imported read-only at call time, never vendored;
its path is the caller's.
"""
from __future__ import annotations

import contextlib
import io
import json
import sys
import time
from pathlib import Path

PARITY_GBS = 128
PARITY_MAX_TP = 4
PARITY_MAX_BS = 16
# the serving counterpart of the parity workload: feasible on the fixture
# topology (A100 prefill pool, T4 decode pool) with headroom on both SLOs,
# so golden/regression runs exercise the full ranking rather than the
# everything-violates degenerate case
PARITY_INFERENCE = dict(arrival_rate_rps=4.0, prompt_len=512, output_len=128,
                        slo_ttft_p99_ms=2000.0, slo_tpot_p99_ms=100.0)
#: Serving parity workload with paged prefix sharing on — the decode+prefix
#: golden's workload (tools/search_inference_decode_golden.json).
PARITY_INFERENCE_PREFIX = dict(PARITY_INFERENCE, prefix_share_frac=0.6,
                               prefix_len=256, page_tokens=16)
#: Resident KV tokens of the parity decode tables (= PARITY_INFERENCE's
#: worst-case context: prompt 512 + output 128).
PARITY_DECODE_CONTEXT = 640
#: Spot-tier hazard used by the availability-aware parity variant.
PARITY_SPOT_RATE = 0.05
#: Device count of the frozen scale workload (symmetric_scale_workload).
SCALE_DEVICES = 1024
SCALE_GBS = 4096


def symmetric_scale_workload(total_devices: int = SCALE_DEVICES,
                             per_node: int = 8, gbs: int | None = None):
    """(cluster, profiles, model, config) for the scale workload: four
    device types forming two cost-equivalence pairs — AX/AY are A100
    clones (same ChipPerf, same DeviceSpec fields) and BX/BY are T4
    clones — split evenly across ``total_devices`` in nodes of
    ``per_node``.  24 node-type sequences collapse to 6 under type
    symmetry, so this is the golden workload for the symmetry-collapsed
    search and the 1024/4096-device bench sections."""
    from metis_tpu_torch.cluster.spec import ClusterSpec, DeviceSpec
    from metis_tpu_torch.core.config import SearchConfig
    from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model
    from metis_tpu_torch.profiles.synthetic import CHIP_PERF

    types = ("AX", "AY", "BX", "BY")
    nodes_per_type, rem = divmod(total_devices, per_node * len(types))
    if rem or nodes_per_type < 1:
        raise ValueError(
            f"total_devices={total_devices} must be a positive multiple "
            f"of {per_node * len(types)}")
    model = tiny_test_model()
    # the SAME ChipPerf instance per pair: synthesized layer times are
    # bit-equal, which is what makes the pair cost-equivalent
    perf = {"AX": CHIP_PERF["A100"], "AY": CHIP_PERF["A100"],
            "BX": CHIP_PERF["T4"], "BY": CHIP_PERF["T4"]}
    profiles = synthesize_profiles(model, list(types), tps=[1, 2, 4],
                                   bss=[1, 2, 4, 8, 16], chip_perf=perf)

    def spec(name: str, mem: float, intra: float) -> DeviceSpec:
        return DeviceSpec(name, memory_gb=mem, intra_bw_gbps=intra,
                          inter_bw_gbps=10)

    overrides = {"AX": spec("AX", 80, 46), "AY": spec("AY", 80, 46),
                 "BX": spec("BX", 15, 50), "BY": spec("BY", 15, 50)}
    cluster = ClusterSpec.of(
        *[(t, nodes_per_type, per_node) for t in types],
        overrides=overrides)
    config = SearchConfig(gbs=gbs if gbs is not None else SCALE_GBS,
                          strict_compat=True)
    return cluster, profiles, model, config


def write_parity_fixture(target_dir: Path) -> None:
    """Materialize the parity workload: reference-schema profile JSONs plus
    hostfile/clusterfile for 2 T4 nodes + 2 A100 nodes, 4 devices each."""
    from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model

    profiles = synthesize_profiles(
        tiny_test_model(), ["A100", "T4"], tps=[1, 2, 4], bss=[1, 2, 4, 8, 16])
    profiles.dump_to_dir(target_dir / "profiles")
    (target_dir / "hostfile").write_text(
        "0.0.0.3 slots=4\n0.0.0.5 slots=4\n0.0.0.4 slots=4\n0.0.0.6 slots=4\n")
    (target_dir / "clusterfile.json").write_text(json.dumps({
        ip: {"instance_type": t, "inter_bandwidth": 10,
             "intra_bandwidth": bw, "memory": mem}
        for ip, t, bw, mem in [
            ("0.0.0.3", "T4", 50, 15), ("0.0.0.5", "T4", 50, 15),
            ("0.0.0.4", "A100", 46, 80), ("0.0.0.6", "A100", 46, 80)]}))


def write_decode_parity_fixture(target_dir: Path) -> None:
    """The parity workload with synthetic DECODE tables on every profile
    entry (``PARITY_DECODE_CONTEXT`` resident tokens): the golden fixture
    for measured-decode TPOT pricing (``decode_source="measured"``).
    Training slices are byte-identical to ``write_parity_fixture``; only the
    ``decode`` profile section is added."""
    from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model

    write_parity_fixture(target_dir)
    profiles = synthesize_profiles(
        tiny_test_model(), ["A100", "T4"], tps=[1, 2, 4],
        bss=[1, 2, 4, 8, 16], decode_context=PARITY_DECODE_CONTEXT)
    profiles.dump_to_dir(target_dir / "profiles")


def write_spot_parity_fixture(target_dir: Path) -> None:
    """The parity workload with the T4 pool marked spot-tier
    (``PARITY_SPOT_RATE`` evictions/hr per device): the golden workload for
    the availability-aware ``expected_recovery`` pricing.  Identical to
    ``write_parity_fixture`` in every other byte, so spot-off searches on
    this fixture must reproduce the reserved golden exactly."""
    write_parity_fixture(target_dir)
    cf = target_dir / "clusterfile.json"
    data = json.loads(cf.read_text())
    for entry in data.values():
        if entry["instance_type"] == "T4":
            entry["tier"] = "spot"
            entry["preemption_rate_per_hr"] = PARITY_SPOT_RATE
    cf.write_text(json.dumps(data))


def run_reference_planner(
    fixture_dir: Path,
    reference_root: Path,
    compute_direct: bool = False,
) -> dict:
    """Run the upstream hetero planner in-process on the parity fixture;
    ``reference_root`` is the upstream Metis checkout.

    Returns a dict with ``costs`` (the reference's recorded candidate tuples),
    ``elapsed_s`` (wall time of the search loop alone), and — when
    ``compute_direct`` — ``direct_costs``: each candidate re-evaluated with a
    *consistent* plan object, sidestepping the upstream num_stage recording
    corruption (``_find_next_node_sequence`` discards the stage count,
    ``plan.py:144-148``), plus handles to the reference objects for further
    differential checks.
    """
    import argparse

    sys.path.insert(0, str(reference_root))
    argv_backup = sys.argv
    # the reference re-parses argv deep inside the cost loop
    # (cost_estimator.py:154) — feed it the knobs it expects
    sys.argv = ["prog", "--max_profiled_batch_size", str(PARITY_MAX_BS),
                "--max_profiled_tp_degree", str(PARITY_MAX_TP)]
    try:
        import cost_het_cluster as ref_main
        from data_loader import ProfileDataLoader
        from gpu_cluster import GPUCluster
        from model.cost_estimator import HeteroCostEstimator as RefHetero
        from model.activation_parameter import GPTActivationAndParam
        from model.load_balancer import LayerLoadBalancer
        from model.device_group import StagePerformance
        from search_space.plan import InterStagePlan as RefISP
        from utils import ModelConfig as RefModelConfig

        from metis_tpu_torch.profiles import tiny_test_model

        gpu_cluster = GPUCluster(
            hostfile_path=str(fixture_dir / "hostfile"),
            clusterfile_path=str(fixture_dir / "clusterfile.json"))
        profile_data, _ = ProfileDataLoader(
            str(fixture_dir / "profiles")).load_profile_data_all()
        m = tiny_test_model()
        model_config = RefModelConfig(
            model_name=m.name, num_layers=m.num_layers,
            sequence_length=m.sequence_length, vocab_size=m.vocab_size,
            hidden_size=m.hidden_size, attention_head_size=m.num_heads)
        model_volume = GPTActivationAndParam(
            model_config, profile_data["model"]["parameters"])
        estimator = RefHetero(profile_data, model_config, model_volume, gpu_cluster)
        balancer = LayerLoadBalancer(gpu_cluster, profile_data, model_config, PARITY_GBS)
        args = argparse.Namespace(
            gbs=PARITY_GBS, num_layers=m.num_layers,
            max_profiled_tp_degree=PARITY_MAX_TP,
            max_profiled_batch_size=PARITY_MAX_BS,
            min_group_scale_variance=1, max_permute_len=6)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            costs = ref_main.cost_het_cluster(
                args, gpu_cluster, profile_data, model_config, estimator, balancer)
        elapsed = time.perf_counter() - t0

        out = {"costs": costs, "elapsed_s": elapsed}
        if compute_direct:
            direct_costs = []
            for (node_seq, device_groups, strategies, batches, partition,
                 _nrep, _recorded) in costs:
                ref_plan = RefISP(
                    ns_idx=0, node_sequence=list(node_seq), dg_idx=0,
                    device_groups=list(device_groups),
                    num_stage=len(device_groups), batches=batches, gbs=PARITY_GBS)
                sp = StagePerformance(
                    model_config, profile_data, gpu_cluster, ref_plan)
                with contextlib.redirect_stdout(io.StringIO()):
                    direct_costs.append(estimator.get_cost(
                        ref_plan, [tuple(s) for s in strategies],
                        list(partition), sp.get_device_placement()))
            out.update(
                direct_costs=direct_costs,
                profile_data=profile_data,
                model_volume=model_volume,
                model_config=model_config,
                gpu_cluster=gpu_cluster,
                estimator=estimator,
            )
        return out
    finally:
        sys.argv = argv_backup
        sys.path.remove(str(reference_root))
