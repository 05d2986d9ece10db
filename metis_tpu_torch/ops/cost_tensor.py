"""The batched cost tensor on Hopper — the port of the reference's jit cost
kernel (``metis_tpu/cost/jax_backend.py:76 _kernel``).

The planner prices a batch of candidate plans of one placement by the same
per-stage assembly (``cost/batch.py`` ``BatchCostEstimator._fast``): chained
sums and maxima over the S stages, then the left-associated component sum.
``cost_tensor`` launches the hand-written CUDA kernel in
``csrc/cost_tensor.cu`` (built at first use by ``ops/build.py``), one thread
per candidate; ``cost_tensor_plain`` is the same function in eager PyTorch on
f64 tensors, the stages unrolled in the same order.  Both are bit-identical
to the numpy loop: see the kernel source for how.

Inputs, shared by both: ``x`` f64 ``[7 S + 4, B]`` (``pack_rows`` lays the
host's gathered rows out; its row blocks are named in ``FIELDS``), ``pp_den``
f64 ``[S - 1]``, and the runtime scalars ``batches``, ``spot_scale``,
``layers``, ``share``.  The output is f64 ``[6, B]``: ``OUTPUTS`` in order.

The wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.  ``launch_counts`` counts kernel
launches, one per wrapper call that launched.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from metis_tpu_torch.ops.build import BuiltLibrary, build

#: the per-stage row blocks of ``x`` (``act`` has S - 1 rows, the others S),
#: then one row each of the per-candidate scalars in ``TAIL``
FIELDS = ("stage_ms", "act", "q", "params", "lat", "o", "span")
TAIL = ("fb_sync", "batch_gen", "migration", "extra_once", "extra_pb")
OUTPUTS = ("total", "execution", "max_opt", "dp_charge", "pp_charge", "recovery")

#: kernel launches since the last ``reset_launch_counts()``
launch_counts = {"cost_tensor": 0}

_library: BuiltLibrary | None = None


def reset_launch_counts() -> None:
    launch_counts["cost_tensor"] = 0


def kernel_library() -> BuiltLibrary:
    """Build (first call) and load the kernel, declaring its C signature."""
    global _library
    if _library is None:
        built = build("cost_tensor.cu")
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn = built.lib.metis_cost_tensor
        fn.argtypes = [p, p, p, i, i, d, d, d, d, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _library = built
    return _library


def width(S: int) -> int:
    """Rows of ``x`` for ``S`` stages."""
    return 7 * S + 4


def pack_rows(rows, S: int) -> np.ndarray:
    """The host gather's per-candidate tuples (``cost/torch_backend.py``
    ``_gather``: seven per-stage lists, then the five scalars) as one f64
    ``[7 S + 4, B]`` array, feature-major."""
    B = len(rows)
    x = np.empty((width(S), B), dtype=np.float64)
    r = 0
    for j, name in enumerate(FIELDS):
        w = S - 1 if name == "act" else S
        if w:
            x[r:r + w] = np.array([g[j] for g in rows], dtype=np.float64).T
        r += w
    for j in range(len(TAIL)):
        x[r + j] = [g[len(FIELDS) + j] for g in rows]
    return x


def _check(x: torch.Tensor, pp_den: torch.Tensor, S: int) -> None:
    if x.dim() != 2 or x.shape[0] != width(S) or x.shape[1] < 1:
        raise ValueError(f"x must be [7 S + 4 = {width(S)}, B >= 1], got "
                         f"{tuple(x.shape)}")
    if tuple(pp_den.shape) != (S - 1,):
        raise ValueError(f"pp_den must be [S - 1 = {S - 1}], got "
                         f"{tuple(pp_den.shape)}")
    for t in (x, pp_den):
        if t.dtype != torch.float64:
            raise ValueError(f"the cost tensor takes float64, got {t.dtype}")


def cost_tensor_plain(x, pp_den, batches, spot_scale, layers, share, *, S,
                      ov, has_lat, has_spot, has_mig) -> torch.Tensor:
    """Plain version: the kernel's function in eager PyTorch, stage by
    stage, each elementwise op rounded on its own (eager ops never fuse a
    multiply into an add).  Returns f64 ``[6, B]``."""
    _check(x, pp_den, S)
    stage, act, q, params, lat, o, span, tail = _split(x, S)
    # scalar operands as f64 tensors on x's device: PyTorch's CUDA division
    # by a Python scalar multiplies by its reciprocal, which is inexact
    batches_t, layers_t = (torch.tensor(float(v), dtype=torch.float64, device=x.device)
                           for v in (batches, layers))
    zero = torch.zeros((), dtype=torch.float64, device=x.device)

    def later_max(m, v):  # Python's max: a later value wins when larger
        return v if m is None else torch.where(v > m, v, m)

    def clamp0(v):  # max(0.0, v)
        return torch.where(v > 0.0, v, zero)

    sum_l = max_l = pp_cost = pp_exposed = None
    max_dp = max_opt = max_dpe = None
    for s in range(S):
        t = stage[s]
        sum_l = t if sum_l is None else sum_l + t
        max_l = later_max(max_l, t)
        if s < S - 1:
            t_pp = act[s] / pp_den[s]
            pp_cost = t_pp if pp_cost is None else pp_cost + t_pp
            if ov:
                e = clamp0(t_pp - t)
                pp_exposed = e if pp_exposed is None else pp_exposed + e
        dpv = (q[s] * params[s]) * share
        if has_lat:
            dpv = dpv + lat[s]
        max_dp = later_max(max_dp, dpv)
        opt = (o[s] * span[s]) / layers_t
        max_opt = later_max(max_opt, opt)
        if ov:
            max_dpe = later_max(max_dpe, clamp0(dpv - opt))
    fb_sync, batch_gen, migration, extra_once, extra_pb = tail
    execution = (batches_t - 1.0) * max_l + sum_l
    execution = (execution + extra_once) + extra_pb * batches_t
    dp_charge = max_dpe if ov else max_dp
    pp_charge = pp_exposed if ov else pp_cost
    if pp_charge is None:  # one stage: no pp boundary
        pp_charge = torch.zeros_like(execution)
    total = (((((execution + fb_sync) + max_opt) + dp_charge) + pp_charge)
             + batch_gen)
    if has_spot:
        recovery = total * spot_scale
        total = total + recovery
    else:
        recovery = torch.zeros_like(execution)
    if has_mig:
        total = total + migration
    return torch.stack((total, execution, max_opt, dp_charge, pp_charge,
                        recovery))


def _split(x: torch.Tensor, S: int):
    """The row blocks of ``x``: seven per-stage views, then the tail rows."""
    out, r = [], 0
    for name in FIELDS:
        w = S - 1 if name == "act" else S
        out.append(x[r:r + w])
        r += w
    out.append(tuple(x[r + j] for j in range(len(TAIL))))
    return out


def cost_tensor(x, pp_den, batches, spot_scale, layers, share, *, S, ov,
                has_lat, has_spot, has_mig) -> torch.Tensor:
    """The cost kernel on ``x``'s device -> f64 ``[6, B]``; see
    ``cost_tensor_plain``."""
    flags = dict(S=S, ov=ov, has_lat=has_lat, has_spot=has_spot,
                 has_mig=has_mig)
    if x.device.type == "cpu":
        return cost_tensor_plain(x, pp_den, batches, spot_scale, layers,
                                 share, **flags)
    _check(x, pp_den, S)
    if pp_den.device != x.device:
        raise ValueError(f"tensors on different devices: {pp_den.device} vs "
                         f"{x.device}")
    if not (x.is_contiguous() and pp_den.is_contiguous()):
        raise ValueError("the cost kernel takes contiguous tensors")
    B = x.shape[1]
    out = torch.empty(len(OUTPUTS), B, dtype=torch.float64, device=x.device)
    err = kernel_library().lib.metis_cost_tensor(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(pp_den.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), B, S, float(batches),
        float(spot_scale), float(layers), float(share), int(bool(ov)),
        int(bool(has_lat)), int(bool(has_spot)), int(bool(has_mig)),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"cost_tensor launch failed: CUDA error {err}")
    launch_counts["cost_tensor"] += 1
    return out
