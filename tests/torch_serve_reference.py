"""Inputs of the port's serve, sched, metrics and replay tests, built from
the JAX package's fixture generators and handed over as the port's own
objects: the reference's ``synthesize_profiles`` / ``tiny_test_model``
(``metis_tpu.profiles``) go through the profile JSON contract
(``dump_to_dir`` then the port's ``ProfileStore.from_dir``), so the port's
tests read exactly what a user of the card machine would read.

``both_stores(dir)`` loads one profile directory in both packages, the
input of every cross-package case.
"""
from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import metis_tpu.core.config as jconfig
import metis_tpu.profiles as jprofiles
import metis_tpu.profiles.store as jstore
import metis_tpu_torch.core.config as tconfig
import metis_tpu_torch.profiles.store as tstore


def tiny_test_model(num_layers: int = 10) -> tconfig.ModelSpec:
    """The reference's unit-test GPT (``metis_tpu.profiles.tiny_test_model``)
    as the port's ``ModelSpec``."""
    return port_model(jprofiles.tiny_test_model(num_layers=num_layers))


def port_model(model) -> tconfig.ModelSpec:
    return tconfig.ModelSpec(**dataclasses.asdict(model))


def ref_model(model) -> jconfig.ModelSpec:
    return jconfig.ModelSpec(**dataclasses.asdict(model))


def ref_config(config) -> jconfig.SearchConfig:
    return jconfig.SearchConfig(**dataclasses.asdict(config))


def synthesize_profiles(model, device_types, **kw) -> tstore.ProfileStore:
    """The reference's synthetic profiles of ``model`` read back by the
    port's store."""
    store = jprofiles.synthesize_profiles(ref_model(model), device_types, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        store.dump_to_dir(tmp)
        return tstore.ProfileStore.from_dir(tmp)


def dump_synthetic(model, device_types, out_dir: Path, **kw) -> Path:
    """Write the reference's synthetic profiles of ``model`` to
    ``out_dir`` (for ``both_stores``)."""
    jprofiles.synthesize_profiles(ref_model(model), device_types,
                                  **kw).dump_to_dir(out_dir)
    return out_dir


def both_stores(profile_dir: Path):
    """(reference store, port store) of one profile directory."""
    return (jstore.ProfileStore.from_dir(profile_dir),
            tstore.ProfileStore.from_dir(profile_dir))


def parity_inputs(tmpdir: Path):
    """(cluster, profiles, model, config) of the reference's parity
    workload (``metis_tpu.testing.write_parity_fixture``, written into
    ``tmpdir`` once), the port's objects."""
    import metis_tpu_torch.cluster.spec as tcluster
    from metis_tpu.testing import (
        PARITY_GBS,
        PARITY_MAX_BS,
        PARITY_MAX_TP,
        write_parity_fixture,
    )

    tmpdir = Path(tmpdir)
    if not (tmpdir / "hostfile").exists():
        write_parity_fixture(tmpdir)
    cluster = tcluster.ClusterSpec.from_files(tmpdir / "hostfile",
                                              tmpdir / "clusterfile.json")
    profiles = tstore.ProfileStore.from_dir(tmpdir / "profiles")
    config = tconfig.SearchConfig(gbs=PARITY_GBS,
                                  max_profiled_tp=PARITY_MAX_TP,
                                  max_profiled_bs=PARITY_MAX_BS)
    return cluster, profiles, tiny_test_model(), config
