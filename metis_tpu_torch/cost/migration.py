"""Migration pricing: the parameter bytes a switch between two plan
layouts moves, and its one-time transfer time — the pure arithmetic of
``metis_tpu/execution/reshard.py``'s ``layout_moved_bytes`` and
``price_migration_ms``.  ``execution/reshard.py`` exports both under the
reference's names; they live here, with no torch import, so that a
process that only plans (the plan daemon pricing a replan's migration)
does not import torch for them.
"""
from __future__ import annotations


def layout_moved_bytes(old_layout: tuple, new_layout: tuple,
                       volume) -> float:
    """Parameter bytes a switch from ``old_layout`` to ``new_layout`` must
    move: every layer the new layout does NOT already hold at the same tp
    under some old stage transfers its (new-tp-sharded) parameter bytes.
    The identical rule ``cost/estimator._migration_ms`` amortizes — kept
    in lockstep so the priced term and the live transfer agree."""
    old_tp: dict[int, int] = {}
    for tp, start, end in old_layout:
        for layer in range(start, end):
            old_tp[layer] = tp
    moved = 0.0
    for tp, start, end in new_layout:
        per = volume.parameter_bytes_per_layer(tp)
        for layer in range(start, end):
            if old_tp.get(layer) != tp:
                moved += per[layer]
    return moved


def price_migration_ms(old_layout: tuple, new_layout: tuple, volume,
                       bw_gbps: float = 100.0) -> float:
    """One-time live-transfer cost of the switch, in ms (decimal GB/s —
    the native bandwidth convention).  This is the UN-amortized figure the
    supervisor compares against the measured checkpoint-restore time; the
    cost model divides the same bytes by ``migration_amortize_steps`` to
    make it a per-step term."""
    return layout_moved_bytes(old_layout, new_layout, volume) / (bw_gbps * 1e6)
