"""The port's batched cost tensor (``cost_backend="torch"``) against the JAX
package's jit cost backend and its numpy ranking, on the CPU.

1. ``ops.cost_tensor``'s plain version against the reference's kernel
   (``metis_tpu/cost/jax_backend.py`` ``_kernel``), jit-compiled with its
   static arguments under ``jax.enable_x64(True)``, on the same random f64
   inputs: bit-equal.  The reference module's guarded import of
   ``jax.experimental.enable_x64`` fails on this jax, which leaves its
   ``jnp`` None, so the tests set its module globals (no file changes).
2. ``plan_hetero(cost_backend="torch", cost_device="cpu")`` against the
   reference's numpy ranking on its parity fixtures: byte-equal dumps and
   equal ``num_costed``.
3. The ``memo.torch_kernel`` counters against the reference's
   ``memo.jax_kernel`` ones, and the ``cost_backend`` event.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against it on the card by ``chip_smoke.py``'s ``cost_tensor`` phase.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

import jax
import metis_tpu.cluster.spec as jcluster
import metis_tpu.cluster.tpu as jtpu
import metis_tpu.core.config as jconfig
import metis_tpu.core.events as jevents
import metis_tpu.core.types as jtypes
import metis_tpu.cost.jax_backend as jb
import metis_tpu.planner.api as japi
import metis_tpu.profiles.store as jstore
from metis_tpu.profiles import synthesize_profiles, tiny_test_model
from metis_tpu.testing import (
    PARITY_GBS,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_parity_fixture,
    write_spot_parity_fixture,
)
import metis_tpu_torch.cluster.spec as tcluster
import metis_tpu_torch.cluster.tpu as ttpu
import metis_tpu_torch.core.config as tconfig
import metis_tpu_torch.core.events as tevents
import metis_tpu_torch.core.types as ttypes
import metis_tpu_torch.planner.api as tapi
import metis_tpu_torch.profiles.store as tstore
from metis_tpu_torch.core.errors import MetisError
from metis_tpu_torch.ops import cost_tensor as ct

torch.set_num_threads(1)

FLAGS = ("ov", "has_lat", "has_spot", "has_mig")
FLAG_CASES = [dict(zip(FLAGS, bits))
              for bits in itertools.product((False, True), repeat=4)]


@pytest.fixture
def jax_kernel(monkeypatch):
    """The reference's kernel, jit-compiled as its backend compiles it."""
    monkeypatch.setattr(jb, "jax", jax)
    monkeypatch.setattr(jb, "jnp", jax.numpy)
    monkeypatch.setattr(jb, "lax", jax.lax)
    monkeypatch.setattr(jb, "enable_x64", lambda: jax.enable_x64(True))
    return jax.jit(jb._kernel, static_argnames=jb._STATIC_ARGS)


def _inputs(S: int, B: int, seed: int) -> dict:
    """Random f64 kernel inputs spanning the planner's magnitudes; both
    signs of ``t_pp - t`` and ``dpv - opt``, and ties within a row."""
    rng = np.random.default_rng(seed)

    def pos(*shape, lo=-2.0, hi=3.0):
        return 10.0 ** rng.uniform(lo, hi, size=shape)

    stage = pos(B, S)
    stage[::5, -1] = stage[::5, 0]  # ties in the maxima
    return dict(
        stage_ms=stage, act=pos(B, S - 1, lo=6, hi=9), q=pos(B, S, lo=-10, hi=-7),
        params=pos(B, S, lo=7, hi=10), lat=pos(B, S, lo=-3, hi=0),
        o=pos(B, S, lo=-1, hi=2), span=rng.integers(1, 9, size=(B, S)).astype(float),
        pp_den=pos(S - 1, lo=6, hi=8), fb_sync=pos(B), batch_gen=pos(B),
        migration=pos(B, lo=-3, hi=1), extra_once=pos(B, lo=-2, hi=1),
        extra_pb=pos(B, lo=-2, hi=0), batches=float(rng.integers(1, 17)),
        spot_scale=float(rng.uniform(0.001, 0.2)), layers=float(rng.integers(S, 40)),
        share=float(rng.uniform(0.1, 1.0)))


def _pack(a: dict, S: int) -> np.ndarray:
    """``a``'s arrays in the cost kernel's ``[7 S + 4, B]`` layout, through
    the backend's own packer."""
    rows = [tuple(list(a[f][b]) for f in ct.FIELDS) + tuple(a[t][b] for t in ct.TAIL)
            for b in range(a["stage_ms"].shape[0])]
    return ct.pack_rows(rows, S)


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_plain_kernel_is_bit_equal_to_the_reference(jax_kernel, S):
    for i, flags in enumerate(FLAG_CASES):
        a = _inputs(S, 37, seed=100 * S + i)
        with jax.enable_x64(True):
            want = jax_kernel(
                a["stage_ms"], a["act"], a["q"], a["params"], a["lat"], a["o"],
                a["span"], a["pp_den"], a["fb_sync"], a["batch_gen"],
                a["migration"], a["extra_once"], a["extra_pb"],
                np.float64(a["batches"]), np.float64(a["spot_scale"]),
                np.float64(a["layers"]), np.float64(a["share"]), S=S, **flags)
            want = np.stack([np.broadcast_to(np.asarray(w, dtype=np.float64), (37,))
                             for w in want])
        got = ct.cost_tensor(
            torch.from_numpy(_pack(a, S)), torch.from_numpy(a["pp_den"]),
            a["batches"], a["spot_scale"], a["layers"], a["share"], S=S,
            **flags).numpy()
        assert got.dtype == np.float64 and got.shape == (6, 37)
        assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), (
            flags, np.argwhere(got != want)[:5])


def test_wrapper_checks_its_inputs():
    a = _inputs(3, 4, seed=0)
    x = torch.from_numpy(_pack(a, 3))
    pp = torch.from_numpy(a["pp_den"])
    flags = dict(ov=True, has_lat=True, has_spot=False, has_mig=False)
    with pytest.raises(ValueError, match="7 S"):
        ct.cost_tensor(x[:-1], pp, 2.0, 0.0, 10.0, 1.0, S=3, **flags)
    with pytest.raises(ValueError, match="pp_den"):
        ct.cost_tensor(x, pp[:1], 2.0, 0.0, 10.0, 1.0, S=3, **flags)
    with pytest.raises(ValueError, match="float64"):
        ct.cost_tensor(x.float(), pp, 2.0, 0.0, 10.0, 1.0, S=3, **flags)
    assert ct.launch_counts["cost_tensor"] == 0  # the CPU launches no kernel


# -- the searches ---------------------------------------------------------------

@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("cost_backend")
    write_parity_fixture(root / "parity")
    write_spot_parity_fixture(root / "spot")
    tpu = root / "tpu"
    synthesize_profiles(tiny_test_model(), ["tpu_v4", "tpu_v5e"], tps=[1, 2, 4],
                        bss=[1, 2, 4, 8]).dump_to_dir(tpu / "profiles")
    return root


def _search(pkg: dict, root, case: str, events=None, **config):
    """One case's search in one package: ``parity_strict``,
    ``parity_native`` and ``spot`` on the reference's fixtures, ``tpu`` over
    v4-32 + v5e-16 (``plan_tpu``: the latency floor of its bandwidth
    model)."""
    fixture = "tpu" if case == "tpu" else case.split("_")[0]
    d = root / fixture
    model = pkg["config"].ModelSpec(**dataclasses.asdict(tiny_test_model()))
    profiles = pkg["store"].ProfileStore.from_dir(d / "profiles")
    cfg = pkg["config"].SearchConfig(
        gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP, max_profiled_bs=PARITY_MAX_BS,
        strict_compat=case == "parity_strict", **config)
    kw = dict(pkg.get("kw", {}), top_k=None,
              events=events if events is not None else pkg["events"].NULL_LOG)
    if case == "tpu":
        slices = pkg["tpu"].TpuClusterSpec((pkg["tpu"].slice_from_name("v4-32"),
                                            pkg["tpu"].slice_from_name("v5e-16")))
        return pkg["api"].plan_tpu(slices, profiles, model, cfg, **kw)
    cluster = pkg["cluster"].ClusterSpec.from_files(d / "hostfile",
                                                    d / "clusterfile.json")
    return pkg["api"].plan_hetero(cluster, profiles, model, cfg, **kw)


JAX = dict(api=japi, config=jconfig, cluster=jcluster, store=jstore, tpu=jtpu,
           events=jevents)
PORT = dict(api=tapi, config=tconfig, cluster=tcluster, store=tstore, tpu=ttpu,
            events=tevents, kw=dict(cost_device="cpu"))


@pytest.mark.parametrize("case", ["parity_strict", "parity_native", "tpu"])
def test_torch_backend_ranking_is_byte_identical(fixtures, case):
    want = _search(JAX, fixtures, case)
    got = _search(PORT, fixtures, case, cost_backend="torch")
    assert got.plans, "the search costed no plan"
    assert ttypes.dump_ranked_plans(got.plans) == jtypes.dump_ranked_plans(want.plans)
    assert (got.num_costed, got.num_pruned) == (want.num_costed, want.num_pruned)
    # the plain version priced them: the CPU launches no kernel
    assert ct.launch_counts["cost_tensor"] == 0


def _counters_and_backend(path):
    evs = [json.loads(line) for line in path.read_text().splitlines()]
    counters = [e for e in evs if e["event"] == "counters"][-1]["counters"]
    backend = [e for e in evs if e["event"] == "cost_backend"]
    return counters, backend


@pytest.mark.parametrize("case", ["spot", "tpu"])
def test_kernel_counters_and_event_match_the_reference(fixtures, tmp_path,
                                                       jax_kernel, case):
    with jevents.EventLog(tmp_path / "jax.jsonl") as log:
        want = _search(JAX, fixtures, case, events=log, cost_backend="jax")
    with tevents.EventLog(tmp_path / "torch.jsonl") as log:
        got = _search(PORT, fixtures, case, events=log, cost_backend="torch")
    # the reference's jit backend ranks as its numpy loop does
    assert ttypes.dump_ranked_plans(got.plans) == jtypes.dump_ranked_plans(want.plans)
    assert got.num_costed == want.num_costed
    jc, jev = _counters_and_backend(tmp_path / "jax.jsonl")
    tc, tev = _counters_and_backend(tmp_path / "torch.jsonl")
    for kind in ("hit", "miss"):
        assert tc[f"memo.torch_kernel.{kind}"] == jc[f"memo.jax_kernel.{kind}"] > 0
    assert [e["backend"] for e in tev] == ["torch"]
    assert tev[0]["batch_fast"] is jev[0]["batch_fast"] is True


def test_backend_names():
    assert tconfig.SearchConfig(gbs=8, cost_backend="torch").cost_backend == "torch"
    with pytest.raises(MetisError, match="numpy"):
        tconfig.SearchConfig(gbs=8, cost_backend="jax")
    with pytest.raises(ValueError):
        tconfig.SearchConfig(gbs=8, cost_backend="cupy")


def test_no_card_raises_and_never_falls_back(fixtures, monkeypatch):
    """On the card by default: without one the search raises before it
    prices anything; a kernel that does not build raises too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(MetisError, match="CUDA is not available"):
        _search(dict(PORT, kw={}), fixtures, "parity_strict", cost_backend="torch")
    from metis_tpu_torch.cost import torch_backend

    monkeypatch.setattr(torch_backend, "resolve_device",
                        lambda device: torch.device("cuda"))

    def no_build():
        raise MetisError("nvcc failed on cost_tensor.cu")

    monkeypatch.setattr(ct, "kernel_library", no_build)
    with pytest.raises(MetisError, match="nvcc failed"):
        _search(dict(PORT, kw={}), fixtures, "parity_strict", cost_backend="torch")


def test_sharded_workers_take_the_cost_device(fixtures, tmp_path):
    """``workers > 1``: each spawned worker builds its backend on the
    caller's ``cost_device`` (on its default, the card, it would fail here
    and the search would fall back to the serial loop)."""
    serial = _search(PORT, fixtures, "parity_strict", cost_backend="torch")
    with tevents.EventLog(tmp_path / "ev.jsonl") as log:
        sharded = _search(PORT, fixtures, "parity_strict", events=log,
                          cost_backend="torch", workers=2)
    events = [json.loads(line)["event"]
              for line in (tmp_path / "ev.jsonl").read_text().splitlines()]
    assert "parallel_fallback" not in events
    assert ttypes.dump_ranked_plans(sharded.plans) == ttypes.dump_ranked_plans(serial.plans)
