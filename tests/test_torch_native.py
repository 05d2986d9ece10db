"""The port's native min-max layer DP (``metis_tpu_torch/native``) against
its numpy twin (``metis_tpu_torch.balance.layers.minmax_partition``) and the
reference's C++ DP (``metis_tpu/native``): the reference's cases of
``tests/test_native.py`` run on the port, the balancer calls it in both of
its passes, and the planner ranks the same plans with and without it.  The
build is the port's own: at first use into the gitignored
``metis_tpu_torch/native/_build/``, named by a hash of the source, safe
against concurrent builds, and never the reference's library."""
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import metis_tpu.native as jnative
import metis_tpu_torch.balance.layers as layers_mod
import metis_tpu_torch.native as tnative
from metis_tpu_torch.balance.layers import minmax_partition
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.native import minmax_partition_native

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def native():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    assert tnative.native_available()


def _prefix(w):
    return np.concatenate(([0.0], np.cumsum(np.asarray(w, np.float64))))


def _reference_native(*args, **kw):
    """The reference's C++ DP where it is built (None otherwise)."""
    return jnative.minmax_partition_native(*args, **kw) if jnative.native_available() else None


def test_unconstrained_matches_numpy_and_reference_randomized():
    rng = np.random.default_rng(0)
    for trial in range(200):
        L = int(rng.integers(2, 14))
        S = int(rng.integers(1, min(L, 8) + 1))
        w = rng.uniform(0.1, 5.0, L)
        perf = rng.uniform(0.2, 4.0, S)
        want = minmax_partition(tuple(w), tuple(perf))
        got = minmax_partition_native(_prefix(w), perf)
        assert got == want, f"trial {trial}: {got} != {want}"
        ref = _reference_native(_prefix(w), perf)
        assert ref is None or ref == got, f"trial {trial}: {got} != {ref}"


def test_constrained_matches_numpy_and_reference_randomized():
    rng = np.random.default_rng(1)
    for trial in range(200):
        L = int(rng.integers(2, 12))
        S = int(rng.integers(1, min(L, 6) + 1))
        w = rng.uniform(0.1, 5.0, L)
        perf = rng.uniform(0.2, 4.0, S)
        mem = rng.uniform(0.5, 3.0, (S, L))
        cap = rng.uniform(1.0, 2.5, S) * L / S
        coef = 5.0
        mem_prefix = np.concatenate(
            [np.zeros((S, 1)), np.cumsum(mem, axis=1)], axis=1)
        demand_mat = 0.001 + coef * (
            mem_prefix[:, None, :] - mem_prefix[:, :, None])
        feasible = demand_mat <= cap[:, None, None]
        want = minmax_partition(tuple(w), tuple(perf), feasible)
        got = minmax_partition_native(_prefix(w), perf, mem_prefix, cap,
                                      coef=coef)
        assert got == want, f"trial {trial}: {got} != {want}"
        ref = _reference_native(_prefix(w), perf, mem_prefix, cap, coef=coef)
        assert ref is None or ref == got, f"trial {trial}: {got} != {ref}"


def test_zero_performance_stage():
    w = [1.0, 1.0, 1.0, 1.0]
    assert minmax_partition_native(_prefix(w), [1.0, 0.0]) == \
        minmax_partition(w, [1.0, 0.0])


def test_more_stages_than_layers():
    assert minmax_partition_native(_prefix([1.0]), [1.0, 1.0]) is None
    assert minmax_partition([1.0], [1.0, 1.0]) is None


def test_mismatched_memory_prefix_is_refused():
    with pytest.raises(ValueError, match="do not match"):
        minmax_partition_native(_prefix([1.0, 2.0]), [1.0], np.zeros((2, 3)),
                                np.ones(1))


def test_library_is_the_ports_own():
    """The process's library is the port's build under its own
    ``_build/``, never the reference's ``_libminmax.so``."""
    path = tnative.library_path()
    assert path.parent == ROOT / "metis_tpu_torch" / "native" / "_build"
    assert path.exists() and path.name.startswith("libminmax_")
    assert Path(tnative._library()._name) == path


def test_edited_source_gets_a_new_library(tmp_path):
    src = tmp_path / "minmax.cpp"
    shutil.copy(tnative.SOURCE, src)
    first = tnative.library_path(src, tmp_path / "_build")
    assert first.name == tnative.library_path().name  # same bytes, same name
    assert tnative.build(src, tmp_path / "_build") == first
    src.write_text(src.read_text() + "\n// edited\n")
    second = tnative.library_path(src, tmp_path / "_build")
    assert second != first
    assert tnative.build(src, tmp_path / "_build") == second
    lib = tnative.load(second)
    assert minmax_partition_native(_prefix([1.0, 2.0, 3.0]), [1.0, 1.0],
                                   lib=lib) == (0, 2, 3)


_BUILD_AND_RUN = textwrap.dedent("""
    import sys
    from pathlib import Path
    sys.path.insert(0, {root!r})
    import numpy as np
    from metis_tpu_torch import native
    src, out = Path(sys.argv[1]), Path(sys.argv[2])
    path = native.build(src, out)
    lib = native.load(path)
    w = np.concatenate(([0.0], np.cumsum(np.ones(6))))
    print(path, native.minmax_partition_native(w, [1.0, 2.0], lib=lib))
""")


def test_two_processes_building_at_once_load_one_library(tmp_path):
    src = tmp_path / "minmax.cpp"
    shutil.copy(tnative.SOURCE, src)
    code = _BUILD_AND_RUN.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src),
                               str(tmp_path / "_build")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    want = f"{tnative.library_path(src, tmp_path / '_build')} (0, 2, 6)"
    assert lines == {want}
    # one library, no half-written temporary left behind
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [
        tnative.library_path(src, tmp_path / "_build").name]


def test_no_compiler_means_no_library(tmp_path, monkeypatch):
    """Without ``g++`` on PATH there is nothing to build: the balancer runs
    the numpy twin."""
    src = tmp_path / "minmax.cpp"
    shutil.copy(tnative.SOURCE, src)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert tnative.build(src, tmp_path / "_build") is None
    assert not (tmp_path / "_build").exists()


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "minmax.cpp"
    src.write_text("int broken( {\n")
    with pytest.raises(MetisError, match="g\\+\\+ failed on minmax.cpp") as err:
        tnative.build(src, tmp_path / "_build")
    assert "error" in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []


def test_balancer_calls_the_native_dp_in_both_passes(monkeypatch):
    """A partition whose compute-optimal split is memory-infeasible takes
    both passes through the native DP, with the memory prefix in the
    second, and returns what the numpy passes return."""
    from metis_tpu_torch.cluster import ClusterSpec
    from metis_tpu_torch.core.config import SearchConfig
    from metis_tpu_torch.planner import plan_hetero
    from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model

    calls = []
    real = layers_mod.minmax_partition_native

    def counting(wprefix, perf, mem_prefix=None, capacity=None, **kw):
        calls.append(mem_prefix is not None)
        return real(wprefix, perf, mem_prefix, capacity, **kw)

    monkeypatch.setattr(layers_mod, "minmax_partition_native", counting)
    model = tiny_test_model()
    store = synthesize_profiles(model, ["A100", "T4"], tps=[1, 2, 4],
                                bss=[1, 2, 4, 8])
    cluster = ClusterSpec.of(("A100", 1, 4), ("T4", 2, 4))
    cfg = SearchConfig(gbs=64, max_profiled_tp=4, max_profiled_bs=8)
    with_native = plan_hetero(cluster, store, model, cfg, top_k=5)
    assert False in calls and True in calls
    monkeypatch.setattr(layers_mod, "native_available", lambda: False)
    n = len(calls)
    without = plan_hetero(cluster, store, model, cfg, top_k=5)
    assert len(calls) == n
    _same_ranking(with_native, without)


def _same_ranking(a, b):
    assert a.num_costed == b.num_costed
    assert len(a.plans) == len(b.plans) > 0
    for x, y in zip(a.plans, b.plans):
        assert x.inter == y.inter
        assert x.intra.strategies == y.intra.strategies
        assert x.intra.layer_partition == y.intra.layer_partition
        assert x.cost.total_ms == y.cost.total_ms


def test_planner_end_to_end_native_vs_numpy_and_reference(monkeypatch):
    """The full hetero search gives the same ranking with the native DP
    and without it, and the reference's."""
    from metis_tpu.cluster import ClusterSpec as JClusterSpec
    from metis_tpu.core.config import SearchConfig as JSearchConfig
    from metis_tpu.planner import plan_hetero as jplan_hetero
    from metis_tpu.profiles import synthesize_profiles as jsynth
    from metis_tpu.profiles import tiny_test_model as jtiny
    from metis_tpu_torch.cluster import ClusterSpec
    from metis_tpu_torch.core.config import SearchConfig
    from metis_tpu_torch.planner import plan_hetero
    from metis_tpu_torch.profiles import synthesize_profiles, tiny_test_model

    model = tiny_test_model()
    store = synthesize_profiles(model, ["A100", "T4"], tps=[1, 2],
                                bss=[1, 2, 4, 8])
    cluster = ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4))
    cfg = SearchConfig(gbs=32)

    with_native = plan_hetero(cluster, store, model, cfg)
    ref = jplan_hetero(JClusterSpec.of(("A100", 1, 4), ("T4", 1, 4)),
                       jsynth(jtiny(), ["A100", "T4"], tps=[1, 2], bss=[1, 2, 4, 8]),
                       jtiny(), JSearchConfig(gbs=32))
    monkeypatch.setattr(layers_mod, "native_available", lambda: False)
    without = plan_hetero(cluster, store, model, cfg)

    _same_ranking(with_native, without)
    assert with_native.num_costed == ref.num_costed
    for x, y in zip(with_native.plans, ref.plans):
        assert x.intra.layer_partition == y.intra.layer_partition
        assert x.cost.total_ms == y.cost.total_ms
