"""Megatron-style sequence parallelism (sp) planning model.

The port's copy of ``metis_tpu/cost/sequence_parallel.py``.

Absent from the reference (SURVEY.md §2.2 "SP — Absent").  SP rides the tp
axis: the non-matmul regions of a block (layernorms, residual stream,
dropout) shard their activations along the *sequence* dimension over the tp
group, and the two TP all-reduces per block become reduce-scatter +
all-gather pairs.  Consequences the model captures:

- **Time**: unchanged.  A ring reduce-scatter plus all-gather moves the same
  wire bytes as the ring all-reduce it replaces, and FLOPs don't move; the
  profiled tp times remain valid for sp variants.
- **Pipeline boundary**: the activation crossing a stage boundary is
  sequence-sharded, so each rank's p2p volume divides by tp.
- **Memory**: only the *replicated* share of activation memory divides by
  tp — the matmul-region activations inside attention/MLP are already
  tp-sharded in the measured profiles.  The split is recovered from data, not
  assumed: the per-layer activation slope (from the bs sweep) as a function
  of tp fits ``slope(tp) = A + B/tp`` — A is the replicated share SP can
  shard, B the already-sharded share.  With fewer than two tp points the
  split is unidentifiable and sp gets **no** memory relief (conservative,
  like the cp/ep fallbacks).
"""
from __future__ import annotations

from metis_tpu_torch.cost.context_parallel import ActivationSplitModel


class SequenceParallelModel:
    """Per-layer replicated-activation share fit over the profile store's tp
    sweep, cached per device type."""

    def __init__(self, split_model: ActivationSplitModel):
        self.split_model = split_model
        self._cache: dict[str, tuple[tuple[float, ...], tuple[float, ...]] | None] = {}

    def _fit(self, device_type: str):
        """Least squares of slope(tp) = A + B * (1/tp) per layer, from the
        activation slopes the bs-sweep fit produced at each profiled tp."""
        profiles = self.split_model.profiles
        tps = sorted({t for (d, t, _) in profiles.configs(device_type)})
        points = []  # (1/tp, slopes_per_layer)
        for tp in tps:
            fitted = self.split_model.split(device_type, tp)
            if fitted is not None:
                points.append((1.0 / tp, fitted[1]))
        if len(points) < 2:
            return None
        xs = [x for x, _ in points]
        n = len(xs)
        mean_x = sum(xs) / n
        var_x = sum((x - mean_x) ** 2 for x in xs)
        if var_x == 0:
            return None
        num_layers = len(points[0][1])
        rep: list[float] = []   # A: replicated share (MB per bs unit)
        shd: list[float] = []   # B: tp-sharded share
        for layer in range(num_layers):
            ys = [slopes[layer] for _, slopes in points]
            mean_y = sum(ys) / n
            b = sum((x - mean_x) * (y - mean_y)
                    for x, y in zip(xs, ys)) / var_x
            a = mean_y - b * mean_x
            rep.append(max(a, 0.0))
            shd.append(max(b, 0.0))
        return tuple(rep), tuple(shd)

    def replicated_share(self, device_type: str):
        if device_type not in self._cache:
            self._cache[device_type] = self._fit(device_type)
        return self._cache[device_type]

    def act_scale(self, device_type: str, tp: int) -> tuple[float, ...] | None:
        """Per-layer multiplier on the activation component under sp: the
        replicated share divides by tp, the rest is already sharded.  None
        (no relief) when tp <= 1 or the split is unidentifiable."""
        if tp <= 1:
            return None
        fitted = self.replicated_share(device_type)
        if fitted is None:
            return None
        rep, shd = fitted
        out = []
        for a, b in zip(rep, shd):
            total = a + b / tp          # measured slope at this tp (by fit)
            with_sp = a / tp + b / tp
            out.append(with_sp / total if total > 0 else 1.0)
        return tuple(out)
