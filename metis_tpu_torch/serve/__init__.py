"""Planner-as-a-service: persistent daemon, plan cache, thin client — the
port of ``metis_tpu/serve``, host Python with no device in it.

The offline CLI pays full price — process start, profile load, estimator
and memo-table construction — on every invocation.  This package keeps a
planner resident: :mod:`serve.daemon` answers plan queries over local HTTP
(TCP or unix socket, stdlib only) from an LRU cache keyed by
``obs.ledger.query_fingerprint``, reuses warm search state
(``planner.api.make_search_state``) for cold queries, and replans in the
background when posted accuracy samples drift out of band.
"""
import importlib

# the reference's exports, resolved on first use: a client
# (``serve.client``) imports no planner, so ``plan --remote``, ``top`` and
# ``replay --remote`` start without importing torch
_EXPORTS = {
    "PlanCache": "metis_tpu_torch.serve.cache",
    "PlanServiceClient": "metis_tpu_torch.serve.client",
    "PlanService": "metis_tpu_torch.serve.daemon",
    "serve_in_thread": "metis_tpu_torch.serve.daemon",
}


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)


__all__ = [
    "PlanCache",
    "PlanService",
    "PlanServiceClient",
    "serve_in_thread",
]
