"""The port's TPU multi-slice planner against the JAX package's, on the same
inputs: ``cluster/tpu.py`` (generations, slice names, torus alignment),
``cost/ici.py`` (the ring formulas, the sub-torus bandwidth and
``IciDcnBandwidth`` with and without a calibration), ``plan_tpu`` and the
``tpu`` command.  Both are host Python, so every result must be equal.

The reference asks JAX's default backend whether a calibration measured on
the CPU applies (it does under ``JAX_PLATFORMS=cpu``); the port asks its
``device`` argument, so the port is given ``device="cpu"`` there.
"""
import contextlib
import dataclasses
import io
import itertools
import json

import jax
import pytest

import metis_tpu.cluster.tpu as jtpu
import metis_tpu.core.config as jconfig
import metis_tpu.core.types as jtypes
import metis_tpu.cost.calibration as jcal
import metis_tpu.cost.ici as jici
import metis_tpu.planner.api as japi
import metis_tpu.planner.cli as jcli
import metis_tpu.profiles.store as jstore
from metis_tpu.profiles import synthesize_profiles, tiny_test_model
import metis_tpu_torch.cluster as tcluster_pkg
import metis_tpu_torch.cluster.tpu as ttpu
import metis_tpu_torch.core.config as tconfig
import metis_tpu_torch.core.events as tevents
import metis_tpu_torch.core.types as ttypes
import metis_tpu_torch.cost.calibration as tcal
import metis_tpu_torch.cost.ici as tici
import metis_tpu_torch.planner.api as tapi
import metis_tpu_torch.profiles.store as tstore
from metis_tpu_torch import cli as tcli
from metis_tpu_torch.core.errors import ClusterSpecError as TClusterSpecError
from metis_tpu.core.errors import ClusterSpecError as JClusterSpecError

NAMES = ["v4-8", "v4-32", "v4-64", "v5e-1", "v5e-4", "v5e-16", "v5e-256",
         "v5p-128", "v6e-8", "v6e-64", "tpu_v4-16", "v5e-12", "v4-24"]
NORTH_STAR = ("v4-32", "v5e-16")
H100 = "NVIDIA H100 80GB HBM3"


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _slices(mod, names=NORTH_STAR):
    return mod.TpuClusterSpec(tuple(mod.slice_from_name(n) for n in names))


# -- cluster/tpu.py -------------------------------------------------------------

def test_generations_and_exports():
    assert list(ttpu.TPU_GENERATIONS) == list(jtpu.TPU_GENERATIONS)
    for name, gen in jtpu.TPU_GENERATIONS.items():
        assert _asdict(ttpu.TPU_GENERATIONS[name]) == _asdict(gen)
    for name in ("TpuGeneration", "TpuSliceSpec", "TpuClusterSpec",
                 "TPU_GENERATIONS", "slice_from_name"):
        assert getattr(tcluster_pkg, name) is getattr(ttpu, name)


@pytest.mark.parametrize("name", NAMES)
def test_slice_from_name(name):
    j, t = jtpu.slice_from_name(name), ttpu.slice_from_name(name)
    assert _asdict(t) == _asdict(j)
    assert t.num_chips == j.num_chips
    assert t.bisection_bw_gbps() == j.bisection_bw_gbps()
    assert [t.axis_ring_bw_gbps(a) for a in range(len(t.topology))] == [
        j.axis_ring_bw_gbps(a) for a in range(len(j.topology))]
    assert _asdict(t.as_device_spec()) == _asdict(j.as_device_spec())
    if j.num_chips % 4 == 0:
        assert [_asdict(n) for n in t.as_nodes(4)] == [_asdict(n) for n in j.as_nodes(4)]


@pytest.mark.parametrize("bad", ["v9-8", "v4-0", "tpu_v4", "v5e-16x"])
def test_bad_slice_names_raise_alike(bad):
    with pytest.raises((JClusterSpecError, ValueError)) as want:
        jtpu.slice_from_name(bad)
    with pytest.raises((TClusterSpecError, ValueError)) as got:
        ttpu.slice_from_name(bad)
    assert str(got.value) == str(want.value)


def test_default_topology_and_slice_checks():
    for chips, dims in itertools.product(range(1, 130), (2, 3)):
        assert ttpu._default_topology(chips, dims) == jtpu._default_topology(chips, dims)
    with pytest.raises(TClusterSpecError, match="3D torus"):
        ttpu.TpuSliceSpec("tpu_v4", (4, 4))
    with pytest.raises(TClusterSpecError, match="unknown TPU generation"):
        ttpu.TpuSliceSpec("tpu_v9", (4, 4))
    # two same-generation slices of different shapes have no one scalar view
    with pytest.raises(TClusterSpecError, match="differing"):
        _slices(ttpu, ("v5e-16", "v5e-4")).as_cluster_spec()


@pytest.mark.parametrize("names", [NORTH_STAR, ("v5e-16", "v4-32", "v6e-8"),
                                   ("v5e-16", "v5e-16")])
def test_cluster_lowering_and_placement(names):
    j, t = _slices(jtpu, names), _slices(ttpu, names)
    assert t.total_chips == j.total_chips
    assert [t.slice_of_rank(r) for r in range(t.total_chips)] == [
        j.slice_of_rank(r) for r in range(j.total_chips)]
    jc, tc = j.as_cluster_spec(4), t.as_cluster_spec(4)
    assert [_asdict(n) for n in tc.nodes] == [_asdict(n) for n in jc.nodes]
    assert {k: _asdict(v) for k, v in tc.devices.items()} == {
        k: _asdict(v) for k, v in jc.devices.items()}
    gens = list(dict.fromkeys(s.generation for s in t.slices))
    for seq in itertools.permutations(gens):
        assert ttpu.rank_slice_placement(t, seq) == jtpu.rank_slice_placement(j, seq)


# the reference's cases (tests/test_calibration.py TestTorusAlignment), then
# every split of the 48 chips into up to three power-of-two-ish groups
ALIGN_CASES = [(32, 16), (48,), (8, 8, 16, 16), (16, 16, 8, 8), (16, 32),
               (2, 4, 26, 16)]


def test_stage_groups_torus_aligned():
    j, t = _slices(jtpu), _slices(ttpu)
    sizes = [1, 2, 4, 6, 8, 12, 16, 24, 32, 40, 48]
    cases = ALIGN_CASES + [g for n in (1, 2, 3)
                           for g in itertools.product(sizes, repeat=n)
                           if sum(g) == 48]
    got = {}
    for seq in (("tpu_v4", "tpu_v5e"), ("tpu_v5e", "tpu_v4")):
        for groups in cases:
            want = jtpu.stage_groups_torus_aligned(j, seq, groups)
            assert ttpu.stage_groups_torus_aligned(t, seq, groups) == want, (seq, groups)
            got[seq, groups] = want
    seq = ("tpu_v4", "tpu_v5e")
    assert [got[seq, g] for g in ALIGN_CASES] == [True, True, True, True, False, False]


# -- cost/ici.py ------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["ring_all_reduce_ms", "all_gather_ms",
                                "reduce_scatter_ms", "all_to_all_ms"])
def test_ring_formulas(fn):
    for nbytes, n, bw, lat in itertools.product(
            (0.0, 1024.0, 3.3e7, 7.1e9), (1, 2, 3, 8, 64), (25.0, 45.0, 450.0),
            (0.0, 0.013)):
        assert getattr(tici, fn)(nbytes, n, bw, lat) == getattr(jici, fn)(nbytes, n, bw, lat)
    assert tici.p2p_ms(4e6, 45.0, 3, 0.002) == jici.p2p_ms(4e6, 45.0, 3, 0.002)
    assert tici.all_to_all_ms(4e6, 8, 45.0, 0.0, False) == jici.all_to_all_ms(
        4e6, 8, 45.0, 0.0, False)


def test_sub_torus_bandwidth():
    for name in ("v4-32", "v5e-16", "v5p-128"):
        js, ts = jtpu.slice_from_name(name), ttpu.slice_from_name(name)
        n = js.num_chips
        groups = [list(range(0, n, stride))[:size]
                  for stride in (1, 2, 4, 8) for size in (1, 2, 4, 8, 16)]
        groups += [[0, 1, 3, 7], list(range(n)), [5, 6, 7, 8]]
        for offsets, link in itertools.product(groups, (None, 17.5)):
            assert tici.sub_torus_eff_bw_gbps(ts, offsets, link) == (
                jici.sub_torus_eff_bw_gbps(js, offsets, link))


@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v4", "TPU v5p", "TPU v6 lite",
                                  "TPU v5e", "Quantum QPU", "cpu", H100,
                                  "NVIDIA A100-SXM4-80GB", "Tesla V100-SXM2-16GB"])
def test_generation_of_device_kind(kind):
    assert tici.generation_of_device_kind(kind) == jici.generation_of_device_kind(kind)


def _calibration(mod, platform: str, kind: str, bw_gbps: float = 10.0):
    """The reference test's calibration (tests/test_calibration.py
    ``_cal``): all_reduce and ppermute fitted at 8 ranks, with a latency."""
    fits = {name: mod.LinearFit(0.004, 1 / (bw_gbps * 1e6), 1.0, 3)
            for name in ("all_reduce", "ppermute", "all_gather")}
    return mod.CollectiveCalibration(platform, kind, 8, fits)


CALIBRATIONS = {"none": None, "cpu": ("cpu", "cpu"), "tpu_v4": ("tpu", "TPU v4"),
                "tpu_v5e": ("tpu", "TPU v5 lite"), "h100": ("cuda", H100)}
PLANS = [(("tpu_v4", "tpu_v5e"), (32, 16)), (("tpu_v5e", "tpu_v4"), (16, 32)),
         (("tpu_v4", "tpu_v5e"), (16, 16, 16)), (("tpu_v4", "tpu_v5e"), (8, 8, 16, 16)),
         (("tpu_v4", "tpu_v5e"), (48,))]
STRATEGIES = [(1, 1), (2, 1), (4, 2), (8, 4), (2, 8), (16, 1), (4, 4), (1, 8)]


def _bandwidths(mod, types, tpu_cluster, plan_key, cal, **kw):
    seq, groups = plan_key
    bw = mod.IciDcnBandwidth(tpu_cluster, types.InterStagePlan(seq, groups, 8, 128),
                             calibration=cal, **kw)
    out = {"lat": [bw.collective_latency_ms(c, n)
                   for c in ("all_reduce", "all_gather", "ppermute") for n in (1, 2, 8, 32)]}
    for s, size in enumerate(groups):
        if s + 1 < len(groups):
            out[f"pp{s}"] = bw.pp_bandwidth(s)
        for dp, tp in STRATEGIES:
            if dp * tp <= size and size % (dp * tp) == 0:
                st = types.Strategy(dp, tp)
                out[f"dp{s}/{dp}x{tp}"] = bw.dp_bandwidth(s, st)
            for cp in (2, 4):
                if dp * tp * cp == size:
                    st = types.Strategy(dp, tp, cp=cp)
                    out[f"cp{s}/{dp}x{cp}x{tp}"] = bw.cp_bandwidth(s, st)
    return out


@pytest.mark.parametrize("cal", sorted(CALIBRATIONS))
def test_ici_dcn_bandwidth(cal):
    """Over v4-32 + v5e-16 (the reference's tests/test_cost.py:121 case and
    more placements), bare and with each calibration; under
    ``JAX_PLATFORMS=cpu`` the reference applies the CPU one, as the port
    does given ``device="cpu"`` (and not on its default device)."""
    assert jax.default_backend() == "cpu"
    spec = CALIBRATIONS[cal]
    jc = _calibration(jcal, *spec) if spec else None
    tc = _calibration(tcal, *spec) if spec else None
    j, t = _slices(jtpu), _slices(ttpu)
    for plan in PLANS:
        want = _bandwidths(jici, jtypes, j, plan, jc)
        device = "cpu" if cal == "cpu" else "cuda"
        assert _bandwidths(tici, ttypes, t, plan, tc, device=device) == want, plan
        bare = _bandwidths(jici, jtypes, j, plan, None)
        if cal in ("cpu", "h100"):
            # off the CPU a CPU calibration, and anywhere the card's, match
            # no slice: the published constants stand
            other = "cuda" if cal == "cpu" else "cpu"
            assert _bandwidths(tici, ttypes, t, plan, tc, device=other) == bare
    # the reference's pinned values (tests/test_cost.py TestIciBandwidth)
    bw = tici.IciDcnBandwidth(t, ttypes.InterStagePlan(("tpu_v4", "tpu_v5e"), (32, 16),
                                                       8, 128))
    assert bw.pp_bandwidth(0) == 25
    assert bw.dp_bandwidth(0, ttypes.Strategy(8, 4)) == pytest.approx(28.64, abs=0.01)
    assert bw.dp_bandwidth(1, ttypes.Strategy(4, 4)) == 90


# -- plan_tpu and the tpu command ---------------------------------------------------

@pytest.fixture(scope="module")
def profile_dirs(tmp_path_factory):
    """The reference's tpu workloads (tests/test_planner.py:107: v5e profiles
    of the tiny model; :65: v4 and v5e), through the profile JSON."""
    root = tmp_path_factory.mktemp("tpu_planner")
    synthesize_profiles(tiny_test_model(), ["tpu_v5e"], tps=[1, 2, 4],
                        bss=[1, 2, 4, 8]).dump_to_dir(root / "v5e")
    synthesize_profiles(tiny_test_model(), ["tpu_v4", "tpu_v5e"], tps=[1, 2, 4],
                        bss=[1, 2, 4, 8, 16]).dump_to_dir(root / "v4_v5e")
    return root


TPU_CASES = {
    "v5e16": ("v5e", ("v5e-16",), dict(gbs=16)),
    "north_star": ("v4_v5e", NORTH_STAR, dict(gbs=64, min_group_scale_variance=1.0)),
    "north_star_strict": ("v4_v5e", NORTH_STAR, dict(gbs=32, strict_compat=True)),
    "loose_groups": ("v4_v5e", NORTH_STAR, dict(gbs=8, max_profiled_tp=2, max_profiled_bs=4,
                                                min_group_scale_variance=0.25)),
}


def _plan_tpu(api, config, store, tpu_mod, profile_dir, case, **kw):
    profiles_dir, names, search = TPU_CASES[case]
    model = config.ModelSpec(**dataclasses.asdict(tiny_test_model()))
    profiles = store.ProfileStore.from_dir(profile_dir / profiles_dir)
    return api.plan_tpu(_slices(tpu_mod, names), profiles, model,
                        config.SearchConfig(**search), **kw)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", sorted(TPU_CASES))
def test_plan_tpu_dump_is_byte_identical(profile_dirs, case, aligned):
    want = _plan_tpu(japi, jconfig, jstore, jtpu, profile_dirs, case,
                     aligned_groups=aligned, top_k=20)
    got = _plan_tpu(tapi, tconfig, tstore, ttpu, profile_dirs, case,
                    aligned_groups=aligned, top_k=20)
    assert got.plans, "the search costed no plan"
    assert ttypes.dump_ranked_plans(got.plans) == jtypes.dump_ranked_plans(want.plans)
    assert (got.num_costed, got.num_pruned, got.num_bound_pruned) == (
        want.num_costed, want.num_pruned, want.num_bound_pruned)


def test_plan_tpu_with_workers_falls_back_to_serial(profile_dirs, tmp_path):
    """The bandwidth factory is a closure: sharded workers cannot take it,
    so ``workers > 1`` runs the serial loop, with a ``parallel_fallback``
    event, and ranks the same."""
    serial = _plan_tpu(tapi, tconfig, tstore, ttpu, profile_dirs, "v5e16")
    with tevents.EventLog(tmp_path / "ev.jsonl") as log:
        profiles_dir, names, search = TPU_CASES["v5e16"]
        model = tconfig.ModelSpec(**dataclasses.asdict(tiny_test_model()))
        sharded = tapi.plan_tpu(
            _slices(ttpu, names), tstore.ProfileStore.from_dir(profile_dirs / "v5e"),
            model, tconfig.SearchConfig(**search, workers=2), events=log)
    events = [json.loads(line)["event"]
              for line in (tmp_path / "ev.jsonl").read_text().splitlines()]
    assert "parallel_fallback" in events
    assert ttypes.dump_ranked_plans(sharded.plans) == ttypes.dump_ranked_plans(serial.plans)


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


# a CPU calibration applies in the reference's CLI under JAX_PLATFORMS=cpu,
# never in the port's (it plans for the card): held above through
# ``IciDcnBandwidth(device=...)``
@pytest.mark.parametrize("cal", ["none", "tpu_v4", "h100"])
def test_tpu_cli_stdout_is_byte_identical(profile_dirs, tmp_path, cal):
    argv = ["tpu", "--slices", ",".join(NORTH_STAR), "--profile-dir",
            str(profile_dirs / "v4_v5e"), "--gbs", "32", "--num-layers", "10",
            "--hidden-size", "4096", "--seq-len", "1024", "--vocab-size", "51200",
            "--num-heads", "32", "--max-tp", "4", "--max-bs", "8", "--top-k", "5"]
    spec = CALIBRATIONS[cal]
    if spec:
        path = tmp_path / "cal.json"
        _calibration(jcal, *spec).dump(path)
        # the port reads the reference's file and writes the same bytes
        assert json.loads(path.read_text()) == tcal.CollectiveCalibration.load(
            path).to_json_dict()
        argv += ["--calibration", str(path)]
    want = _stdout(jcli.main, argv)
    assert _stdout(tcli.main, argv) == want
    assert json.loads(want)[0]["rank"] == 1
