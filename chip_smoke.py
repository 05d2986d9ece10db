"""Drive the PyTorch port on one NVIDIA card and hold every kernel against
its plain version.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``) and the CUDA version;
2. build the hand-written kernels from ``metis_tpu_torch/ops/csrc``;
3. kernels: each of B1 (forward), B2 (dQ) and B3 (dK/dV) against its plain
   PyTorch version at the main-path shape and at GQA, ragged-length (across
   the 128-row tile edges too), non-causal and stats-mode shapes, in bf16;
   times of each kernel, its plain version and PyTorch's SDPA as a yardstick
   (CUDA events around a run of back-to-back calls, see ``cuda_ms``; SDPA
   as a CUDA graph's replay, see ``sdpa_ms``; the kernels three times and
   SDPA's backward seven, with their spread), beside the bound computed
   from the inputs, and the backward pair B2 + B3 (back to back, and as a
   graph) against SDPA's whole backward; every grid the main paths give
   the kernels (``PATH_CASES``) is held;
4. slice: the flash GPT at the ``--model-size 1.5B`` preset (``GPT_15B``,
   full width and depth, random weights from a seed): agreement of flash
   and dense attention on a small GPT, ``profile_model`` to a profile directory and back
   through ``ProfileStore.from_dir``, 5 train steps through
   ``build_executable`` with the kernel launch counts read around every step,
   the same 5 steps with dense attention as the reference trajectory, and
   ``validate_uniform_plan`` against the step time the ported estimator
   (``planner.api.plan_uniform``) predicts from that profile;
5. planner: on the slice's profile directory and a one-card hostfile and
   clusterfile, the ``uniform`` and ``hetero`` searches of the port's CLI
   (their rankings printed), ``validate`` of the top three uniform plans on
   the card, 3 train steps of the best hetero plan through
   ``PlanArtifact.from_ranked_plan`` with the kernel launch counts read
   around every step, and ``plan_hetero`` on 2 nodes x 8 H100 from the same
   profile (host search time, candidate counts, top three);
6. dist: dp x tp plans through ``execution.dist`` (a rank pool) and
   ``build_executable``'s ``gspmd`` route, each rank reading its own kernel
   launch counts around every step: (a) NCCL at world size 1 at
   ``SHALLOW_BLOCKS`` (1) block of full width, 3 steps, equal to one
   device's trajectory at that depth within 1e-6; (c) dp 2 x tp 2
   on four gloo ranks sharing the card at that depth, 3 steps, within
   0.05 of the same one-device run
   (tp 2 and dp 2 alone, once its legs (b) and (c), run in the zero_sp
   phase at the same depth, held there to one device); (d) ``profile
   --tps 1,2`` on the one card
   skips tp 2 with a ``profile_skipped`` event and writes no tp 2 profile.
   The ranks of (c) share one card, so their step times are no dp/tp
   speed;
7. pipeline: multi-stage plans through ``execution.dist`` (a rank pool), each rank
   reading its own kernel launch counts around every step: (a) the
   one-stage hetero executor at 4 microbatches of 1 row, in this process,
   within 0.05 of the slice's full-batch trajectory; the time per step of
   the one-device step and of that executor at M 1 and M 4, one after
   another (``executor_step_ms``); then on two gloo ranks
   sharing the card, in one job, full width and depth, 3 steps each
   within ``PIPE_TOL`` of it: gpipe 4 + 4 blocks and 1f1b 3 + 5 on the
   ``pipeline`` route, the 3 + 5 split tagged gpipe on the ``hetero``
   route, interleaved 2 x 2 chunks; launches per rank per step as
   ``flash_launches`` counts them; each rank's peak memory against the
   hetero planner's stage estimate; (b) a hetero plan on four gloo ranks at
   2 blocks of full width, stage 0 at dp 2 over rows (3, 1) and stage 1 at
   tp 2, within 0.05 of the 2-block one-stage run; (c)
   ``validate_hetero_choice`` of the top three one-card hetero plans (each
   run with its own microbatch count), measured and predicted ms recorded,
   with each plan also priced from the raw bs = gbs / M profile once per
   microbatch, gated only on finite, positive measurements.  Ranks sharing one card
   give no pp speed.

8. llama: the LLaMA configuration (``LLAMA_15B``: the 1.5B preset's widths,
   32 query heads over 8 KV heads, SwiGLU, RoPE, RMSNorm): a small
   flash-vs-dense check on three seeds, with dense attention whose backward
   rounds dS to bf16 as a witness; phase 4's profile, searches, 5 flash and
   5 dense steps on fresh batches and validation (gated at
   ``PLAN_ERROR_PCT``); tp 2 on two gloo ranks at ``SHALLOW_BLOCKS`` (within
   ``TRAJ_TOL`` of one device at that depth); and a two-stage hetero plan
   of 1 + 1 blocks (``LLAMA_STAGE_BLOCKS``) at 2 microbatches on the same
   fresh batches against the one-stage executor at that depth (losses
   within ``PIPE_TOL``, first-step gradient norms within
   ``GRAD_NORM_TOL``);
9. moe: the MoE configuration (``MOE_15B``: 2 blocks of 8 GELU experts,
   top 2, capacity factor 1.25): phase 4's profile, 5 + 5 steps on fresh
   batches and validation (``error_pct`` recorded, not gated), with the
   first-block routing decisions that differ between flash and dense; the
   flash and dense trajectories from two more seeds; the searches with
   ``--enable-ep``; and ep 2 on two gloo ranks at gbs 8 (one 4096-token
   routing group per rank) against one device (losses within
   ``PIPE_TOL``, first-step gradient norms within ``GRAD_NORM_TOL``), with
   the count of first-block routing decisions that differ and each rank's
   peak;
10. context: the LLaMA at LLaMA-3-8B's 8192-token context (``LLAMA_LONG``,
   gbs 1): one device at full depth (3 steps: step time, peak, launches);
   at ``CONTEXT_BLOCKS`` blocks on two gloo ranks sharing the card, in one
   launch, against one device at that depth: cp 2 ring (rank 0 launches 2
   and rank 1 4 of each kernel per step: future blocks are skipped), cp 2
   Ulysses, and the best-ranked cp 2 plan of the ``hetero --enable-cp
   --max-cp 2 --enable-zero --enable-sp`` search on a 1 x 2 H100 cluster
   from a profile at that depth (losses within ``CP_TOL``, first-step
   gradient norms within ``GRAD_NORM_TOL``, each rank's peak);
11. zero_sp: the GPT at ``SHALLOW_BLOCKS`` (1) block of ``QUARTER_WIDTH``
   (hidden 1024, 8 heads), gbs 4, on two gloo ranks in one job: tp 2 and
   dp 2 against one device at that depth and width (within 0.05, 1 launch
   of each kernel per rank per step), tp 2 with Megatron sp against tp 2,
   dp 2 at ZeRO 1, 2 and 3 against dp 2 at ZeRO 0 (losses within
   ``ZERO_SP_TOL``, gradient
   norms within ``GRAD_NORM_TOL``), each rank's peak beside the planner's
   ZeRO relief (``cost/zero.py``);
12. stage_axes: multi-stage plans whose stages carry ZeRO, context or
   expert parallelism on the hetero route, at full width on gloo ranks
   sharing the card (one job per rank count, several plans each), 3 steps
   each against the one-stage executor at the same depth, run first in
   this process and freed: (a) the GPT at ``GPT_STAGE_BLOCKS`` (1) block,
   two stages of dp 2 (stage 0 the embedding and the block, stage 1 the
   head), gbs 4 in one microbatch, at ZeRO 0-3 on both; (b) the 8192-token
   LLaMA at ``STAGE_BLOCKS`` (2) blocks, a cp 2 ring stage feeding a cp 2
   Ulysses stage, then a cp 1 stage; (c) the MoE at ``MOE_STAGE_BLOCKS``
   (1) in ``MOE_STAGE_GROUP``
   routing groups, stage 0 the embedding and the block at dp 2 x ep 2 over
   rows (3, 1) (padded, masked), stage 1 the head at dp 1, with the
   first-block routing decisions of that layout that differ from the
   one-stage run's, in those groups and in the preset's; (d) the best-ranked plan of two stages or more with
   zero or cp of the ``hetero --enable-cp --max-cp 2 --enable-zero`` search
   on 1 x 4 H100 from the context phase's profile, built from the ranking
   (``PlanArtifact.from_ranked_plan``) and measured by
   ``validate_hetero_choice`` (not gated: the ranks share the card).
   Losses within ``PIPE_TOL``, first-step gradient norms within
   ``GRAD_NORM_TOL``, each rank's launches per step as its stage's blocks
   imply (``stage_launches``), each rank's peak beside the planner's stage
   demand.  Its grids are among ``PATH_CASES`` ((a) runs ``MBS2``, a
   replica of (c)'s stage 0 3 rows, ``ROWS3``).
13. train (``train_phase``): (a) ``python -m metis_tpu_torch train
   --device cuda`` on a one-card hostfile, the 1.5B preset's widths at
   ``TRAIN_BLOCKS`` (1) block planned from its own profile: 3 steps with
   ``--checkpoint-every 2``, 2 resumed, 5 straight; the resumed run's
   losses and every leaf's digest bit-equal to the straight run's, save
   and restore ms, ``mean_step_ms`` beside ``plan_cost_ms``, 1 launch of
   each kernel per step; (b) the MoE at 1 block of ``QUARTER_WIDTH`` in
   the preset's 4096-token routing groups, each shared by two gloo ranks:
   tp 2 + sp, dp 2, cp 2 ring and cp 2 Ulysses against one device at that
   depth and width (losses within ``PIPE_TOL``,
   first-step gradient norms within ``GRAD_NORM_TOL``), the first-block
   routing decisions that differ and the router's ties; (c) ``train``'s
   rank body on pinned plans on two gloo ranks at ``TRAIN_C_WIDTH``: dp 2
   at ZeRO 1 and a two-stage hetero plan, 2 + 2 resumed steps bit-equal
   to 4 straight.
14. reshard (``reshard_phase``): at ``TRAIN_C_WIDTH`` on two gloo ranks,
   ``execute_reshard`` dp 2 + ZeRO 1 -> tp 2 -> one device (rank 1 only
   sends), each verified and its next step bit-equal to the step after a
   checkpoint restore onto the same plan, ``stall_ms`` beside
   ``price_migration_ms`` at 100 GB/s;
15. chaos (``chaos_phase``): the fault-tolerant supervisor through the
   port's CLI, each run in a process of its own, the train phase's GPT at
   its depth and ``TRAIN_C_WIDTH``.  First (a) ``chaos --fault-script
   checkpoint_write@2x2,device_loss@4`` on two gloo ranks sharing the card,
   a cluster of two one-card nodes, the dp 2 + ZeRO 1 plan pinned: two
   retried checkpoint writes, the device loss absorbed by a live reshard
   onto the searched one-card plan at step 4, with ``recover_s``,
   ``stall_ms`` beside ``price_migration_ms`` and the save ms.  Then,
   beside one another: the restore onto another plan of (a)'s step-4
   checkpoint (``replan_leg``): ``train --replan-on-resume --device cuda``
   on the one-card cluster, resharded onto one device at step 4, its
   one-device digests equal to the checkpoint's, its 2 steps within
   ``TRAJ_TOL`` of the dp 2 plan continued from the same checkpoint and
   bit-equal to (a)'s steps 5-6, the cross-mesh restore's ms and the GB
   it reads; (b) ``device_loss@4,
   reshard_verify@4,loss_nan@5``: the migration falls back to the restore,
   the NaN rolls back to step 4, the final loss equal to the run without
   ``loss_nan``; and (c) ``train --resilient`` on one device sent a real
   SIGTERM after its second step: drained with a checkpoint of its step,
   then resumed to the end bit-equal to an uninterrupted run.  Every
   supervised step launches each kernel once (``kernel_launches`` of the
   ``train_step`` events).
16. calibration (``calibration_phase``): ``python -m metis_tpu_torch
   calibrate --output X --chip-roofline`` on the one card (exit 1, no
   ``X``, the card's matmul TFLOP/s and streaming GB/s, each at most 1.05 x
   the data sheet's peak and printed with its share of it);
   ``microbenchmark_collectives`` on two and four gloo ranks (all five
   collectives fitted, one sample per payload), ``measure_dp_overlap`` on
   two and ``measure_pipeline_overlap`` (pp 2 x dp 2, the lockstep and
   overlapped losses equal) on four; ``fit_recovery_seconds`` over the
   chaos phase's recoveries, ``fit_ledger_correction`` over the planner
   phase's ``validate`` pairs; and the planner phase's 2 x 8 search with
   the measured dp overlap and the fitted recovery time.  These paths run
   dense attention and plain products, as the reference's do: no kernel.

Ranks run in pools (``execution.dist.RankPool``, ``on_ranks``): one per
world size and backend, all started at the dist phase (their ranks boot
while its first legs run) and each stopped after the last phase that uses
it; the ``timing`` line counts the launches and each phase's seconds.

The kernel phase also holds and times the pipeline's microbatch shape (b 1,
``MICRO``), the LLaMA grid (``LLAMA``; SDPA with ``enable_gqa``) and the
context phase's grids (``CONTEXT_CASES``: the ring's self and past blocks,
whose stats mode has no SDPA yardstick, s 8192, and a Ulysses rank's 16
heads).  The last lines are the ``kernels`` JSON and each phase's, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  TF32 is off in every comparison: fp32
products run in full fp32 on both sides.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import shutil
import signal
import statistics
import subprocess
import sys
import pathlib
import tempfile
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its operations over the bf16 tensor-core rate and its
# bytes over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# bf16 kernels against fp32 plain versions, held per row (see ``row_err``):
# storing a bf16 output rounds each element by at most 2^-9 (2e-3), and the
# products round P and dS to bf16 too, so a right kernel reads a few 1e-3.
KERNEL_TOL = 1e-2
# a row whose reference norm is below this share of the RMS row norm (dQ of
# the first causal row cancels to rounding noise) is held to that floor
ROW_FLOOR = 1e-2
# gradients of a small bf16 GPT, flash against dense attention, normwise per leaf
GRAD_TOL = 1e-2
# the same for the small LLaMA (4 query heads over 2 KV heads), whose wq
# gradient reads about 1.05e-2 on an H100: the kernels' backward rounds dS
# to bf16 where the dense path keeps it in fp32, and wq's gradient sums dS
# over 512 tokens whose contributions cancel.  ``agreement_phase``'s
# witnesses read, on three seeds, that rounding's share of each leaf and
# how far flash and dense each are from the fp32 model.  The 1.5B
# trajectory is held to TRAJ_TOL as the GPT's
LLAMA_GRAD_TOL = 2e-2
# the 1.5B loss through 8 bf16 blocks, flash against dense attention, at
# step 0 and along the 5-step trajectory
LOSS_TOL = 2e-2
TRAJ_TOL = 5e-2

# the planner's clusterfile: GB per card (the planner reads memory * 1024 MB)
CLUSTER_MEMORY_GB = 80
# the mbs = gbs = 4 plan's predicted step against its measured step
PLAN_ERROR_PCT = 5.0
# the gspmd route at NCCL world size 1 against the one-device step
WORLD1_TOL = 1e-6
# the pipeline phase's two-stage plans against the one-stage hetero
# reference at M = 4, per step (the one-stage reference itself is held to
# the full-batch step within TRAJ_TOL)
PIPE_TOL = 1e-2
# a sharded leg's first-step gradient norms, per leaf, against the one
# device's or the one stage's: a gradient scaled by ep, or missing a peer's
# or a stage's part, reads 0.4 or more
GRAD_NORM_TOL = 1e-2
SHARED_CARD = "ranks share one card; not a dp/tp speed"
# the depth of the dist phase's legs (a) and (c), of the zero_sp phase's
# and of the llama phase's tp 2 leg: 1 block of full width, which keeps the
# whole script near 1000 s with the train and reshard phases (2 blocks, and
# full depth for (a) and the LLaMA's tp 2, before them)
SHALLOW_BLOCKS = 1
# a quarter of the preset's hidden width (8 heads of 128, its vocabulary and
# sequence): the zero_sp phase's legs, the train phase's MoE legs (b) and
# its legs (c), the reshard and chaos phases, whose gates (bit-equality,
# agreement with one device, MoE routing in shared 4096-token groups,
# recoveries) hold at any width, while the dp, cp and ZeRO legs' gloo
# traffic through the host grows with the parameters' bytes
QUARTER_WIDTH = dict(hidden_size=1024, num_heads=8)
# the llama phase's two-stage hetero plan, 1 + 1 blocks (4 + 4 before the
# reshard phase came)
LLAMA_STAGE_BLOCKS = 2

# the --model-size 1.5B preset (planner/cli.py MODEL_SIZE_PRESETS) and its
# LLaMA and MoE configurations: GQA at LLaMA-3-8B's ratio, and 8 experts,
# top 2, at 2 blocks (8 blocks of experts are 9.55 B parameters, 153 GB of
# fp32 state with AdamW: more than one card holds)
GPT_15B = dict(name="gpt-1.5B", num_layers=10, hidden_size=4096,
               sequence_length=1024, vocab_size=51200, num_heads=32, attn="flash")
LLAMA_15B = dict(GPT_15B, name="llama-1.5B", family="llama", num_kv_heads=8)
MOE_15B = dict(GPT_15B, name="moe-1.5B", num_layers=4, num_experts=8,
               expert_top_k=2)
CLI_MODEL = {
    "gpt-1.5B": ["--model-size", "1.5B", "--attn", "flash"],
    "llama-1.5B": ["--model-size", "1.5B", "--attn", "flash", "--family", "llama",
                   "--num-kv-heads", "8"],
    "moe-1.5B": ["--model-size", "1.5B", "--attn", "flash", "--num-layers", "4",
                 "--num-experts", "8", "--expert-top-k", "2"],
}

SEED = 0
# the weights' seeds of the MoE's and the small LLaMA's further flash-vs-dense
# runs (the batches' are one more)
OTHER_SEEDS = (10, 20)
MAIN = dict(name="main", b=4, hq=32, hkv=32, s=1024, d=128, causal=True)
# one rank's share of the main path at tp 2: half the heads
TP2 = dict(name="tp2", b=4, hq=16, hkv=16, s=1024, d=128, causal=True)
# one microbatch of the pipeline phase: gbs 4 over 4 microbatches
MICRO = dict(name="micro", b=1, hq=32, hkv=32, s=1024, d=128, causal=True)
# the other grids the pipeline phase gives the kernels: (b) stage 0's
# replica of 3 rows (its other replica runs MICRO, stage 1's tp 2 ranks
# TP2); (c) the plan of 2 microbatches of 2 rows (its others run MAIN and
# MICRO)
ROWS3 = dict(name="rows3", b=3, hq=32, hkv=32, s=1024, d=128, causal=True)
MBS2 = dict(name="mbs2", b=2, hq=32, hkv=32, s=1024, d=128, causal=True)
# the LLaMA path: 32 query heads over 8 KV heads (B3 sums 4 members into
# each KV head); one rank's half at tp 2; a microbatch of 2 rows of the
# two-stage hetero plan.  The MoE path runs MAIN (also per rank at ep 2).
LLAMA = dict(name="llama", b=4, hq=32, hkv=8, s=1024, d=128, causal=True)
LLAMA_TP2 = dict(name="llama_tp2", b=4, hq=16, hkv=4, s=1024, d=128, causal=True)
LLAMA_MB2 = dict(name="llama_mb2", b=2, hq=32, hkv=8, s=1024, d=128, causal=True)
# the context phase's grids (its LLaMA at 8192 tokens, gbs 1): a cp 2 ring
# rank's self block (B1 in stats mode, causal) and past block (non-causal),
# B2 and B3 of each on the logsumexp merged over both blocks, as the ring's
# backward runs them; one device's whole sequence; a Ulysses rank's half of
# the heads over the whole sequence, K/V expanded to the query heads
RING_SELF = dict(name="ring_self", b=1, hq=32, hkv=8, s=4096, d=128, causal=True,
                 stats=True, ring=True)
RING_PAST = dict(RING_SELF, name="ring_past", causal=False)
LONG = dict(name="long", b=1, hq=32, hkv=8, s=8192, d=128, causal=True)
ULYSSES = dict(name="ulysses", b=1, hq=16, hkv=16, s=8192, d=128, causal=True)
CONTEXT_CASES = (RING_SELF, RING_PAST, LONG, ULYSSES)
# the grids of the narrow GPT and MoE (``QUARTER_WIDTH``: 8 heads of 128):
# the train phase's MoE's cp 2 ring ranks (b 4, each rank a 512-token block:
# its self block and its past one, stats mode), 2 rows per dp rank or
# microbatch (train (b) and (c), zero_sp's dp 2)
TRAIN_RING_SELF = dict(name="train_ring_self", b=4, hq=8, hkv=8, s=512, d=128,
                       causal=True, stats=True, ring=True)
TRAIN_RING_PAST = dict(TRAIN_RING_SELF, name="train_ring_past", causal=False)
NARROW = dict(name="narrow", b=2, hq=8, hkv=8, s=1024, d=128, causal=True)
# on one device (b 4, 8 heads; the reshard phase's leg (b), chaos (b) and
# (c)) and at tp 2 or under Ulysses' cp 2 (4 heads per rank; zero_sp's tp 2,
# train (b)'s tp 2 and cp 2 a2a); the reshard phase's leg (a) runs MBS2 and
# MAIN
NARROW_ONE = dict(NARROW, name="narrow_one", b=4)
NARROW_TP2 = dict(NARROW, name="narrow_tp2", b=4, hq=4, hkv=4)
PATH_CASES = (MAIN, TP2, MICRO, ROWS3, MBS2, LLAMA, LLAMA_TP2, LLAMA_MB2,
              *CONTEXT_CASES, TRAIN_RING_SELF, TRAIN_RING_PAST, NARROW,
              NARROW_ONE, NARROW_TP2)
TIMED_CASES = (MAIN, MICRO, LLAMA, *CONTEXT_CASES)
KERNEL_CASES = [
    *PATH_CASES,
    dict(name="gqa", b=2, hq=8, hkv=2, s=1024, d=128, causal=True),
    dict(name="ragged", b=2, hq=8, hkv=8, s=1000, d=128, causal=True),
    # one short of and one past the 128-row tiles of B1 (query) and B3 (key)
    dict(name="edge127", b=2, hq=8, hkv=8, s=127, d=128, causal=True),
    dict(name="edge129", b=2, hq=8, hkv=4, s=129, d=128, causal=True),
    # g = 8 query heads per KV head: B3's loop over the group members
    dict(name="gqa8", b=2, hq=16, hkv=2, s=1024, d=128, causal=True),
    # B2's one Q tile of 128 rows with 64 valid: its second warpgroup has no row
    dict(name="edge64", b=2, hq=8, hkv=8, s=64, d=128, causal=True),
    dict(name="noncausal_d64", b=2, hq=8, hkv=8, s=512, d=64, causal=False),
    dict(name="stats", b=2, hq=8, hkv=2, s=1000, d=128, causal=False,
         stats=True),
]
SOURCE = "metis_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {
    "fa_fwd": "metis_tpu/ops/flash_attention.py:85",
    "fa_bwd_dq": "metis_tpu/ops/flash_attention.py:137",
    "fa_bwd_dkv": "metis_tpu/ops/flash_attention.py:186",
}


#: the script's rank pools (``on_ranks``), one per (world, backend), all
#: started at the dist phase and each closed after the last phase that
#: runs one
POOLS: dict = {}
POOL_LAST_PHASE = {(1, "nccl"): "dist", (3, "gloo"): "stage_axes",
                   (4, "gloo"): "calibration", (2, "gloo"): "calibration"}


def start_pools() -> None:
    """Start every pool of ``POOL_LAST_PHASE`` (``execution.dist.RankPool``:
    its ranks boot in the background, the first job waits for them)."""
    from metis_tpu_torch.execution import dist as mdist

    for world, backend in POOL_LAST_PHASE:
        if (world, backend) not in POOLS:
            POOLS[world, backend] = mdist.RankPool(world, backend, ["cuda:0"] * world)
    log(f"  rank pools started: {sorted(POOLS)}")


def on_ranks(fn, world: int, backend: str, *args) -> list:
    """``fn(rank, device, *args)`` on ``world`` ranks sharing ``cuda:0``
    (``execution.dist.RankPool``: what ``dist.spawn`` gives, without a
    launch per job); the results in rank order."""
    return POOLS[world, backend].run(fn, *args)


def close_pools(phase: str | None = None) -> None:
    """Stop the pools whose last phase is ``phase`` (None: every pool)."""
    for key, pool in POOLS.items():
        if phase is None or POOL_LAST_PHASE.get(key) == phase:
            pool.close()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: after ``warmup`` calls, one pair of
    CUDA events around ``iters`` back-to-back calls, over ``iters``.  The
    host queues the calls ahead of the card, so its gaps between calls are
    not counted (an event pair around each single call counts them whenever
    the host's overhead of a call is close to its device time)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_of(fn, stream: torch.cuda.Stream):
    """``fn`` captured in a CUDA graph on ``stream`` after three warm-up
    calls there; returns the graph's replay.  Timing the replay counts the
    device work of ``fn`` without the host's overhead per call."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph.replay


def timed_runs(fn, reps: int = 3) -> dict:
    """``cuda_ms`` repeated ``reps`` times: the median and every run."""
    runs = [cuda_ms(fn) for _ in range(reps)]
    return {"ms": statistics.median(runs), "runs": runs}


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: registers and spills."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*?(fa_\w+?_kernel)ILi(\d+)E", line)
        if entry:
            name = f"{entry.group(1)}<{entry.group(2)}>"
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            spill = f"{spills.group(1)} B spill stores, {spills.group(2)} B spill loads"
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            lines.append(f"{name}: {regs.group(1)} registers, {spill}")
            name = None
    return lines


def row_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, worst per-row relative error).

    A row is the last axis.  Each row's error norm is taken over its own
    reference norm, floored at ``ROW_FLOOR`` of the reference's RMS row norm,
    so a late causal row with small values is held to its own scale and not
    to that of the largest rows."""
    diff = got.float() - want.float()
    max_abs = diff.abs().max().item()
    if not math.isfinite(max_abs):
        return max_abs, max_abs
    ref = torch.linalg.vector_norm(want.float(), dim=-1)
    floor = max(ROW_FLOOR * ref.square().mean().sqrt().item(), 1e-30)
    rel = torch.linalg.vector_norm(diff, dim=-1) / ref.clamp_min(floor)
    return max_abs, rel.max().item()


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Normwise relative error ||got - want|| / ||want||."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def visible_pairs(s_q: int, s_kv: int, causal: bool) -> int:
    """(query, key) pairs the inputs need: top-left causal or full."""
    if not causal:
        return s_q * s_kv
    return sum(min(i + 1, s_kv) for i in range(s_q))


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_case(case: dict, gen: torch.Generator, timed: bool) -> dict:
    """Hold B1, B2 and B3 against their plain versions at one shape.  A
    ``ring`` case runs B1 in stats mode, then B2 and B3 on the logsumexp and
    delta of this block's state merged with another block's (the self block
    with a past one, a past block with the self one), as ring attention's
    backward does; it has no SDPA yardstick (no one call computes it)."""
    from metis_tpu_torch.ops import flash_attention as fa

    b, hq, hkv, s, d = case["b"], case["hq"], case["hkv"], case["s"], case["d"]
    causal, stats = case["causal"], case.get("stats", False)
    ring = case.get("ring", False)
    heads = dict(q_heads=hq, kv_heads=hkv, causal=causal)
    dev = torch.device("cuda")

    def rnd(rows):
        return torch.randn(rows, s, d, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = rnd(b * hq), rnd(b * hkv), rnd(b * hkv), rnd(b * hq)
    out = {"case": case["name"]}

    o, m, l = fa.fa_fwd(q, k, v, normalize=not stats, **heads)
    o_ref, m_ref, l_ref = fa.fa_fwd_plain(q, k, v, normalize=not stats, **heads)
    torch.cuda.synchronize()
    errs = {"o": row_err(o, o_ref), "m": row_err(m, m_ref), "l": row_err(l, l_ref)}
    out["fa_fwd"] = errs
    if not stats or ring:
        # the backward's inputs come from the plain forward, shared by both sides
        lse = fa.logsumexp_of(m_ref, l_ref)
        if ring:
            other = fa.fa_fwd_plain(q, rnd(b * hkv), rnd(b * hkv), normalize=False,
                                    q_heads=hq, kv_heads=hkv, causal=not causal)
            acc, m_all, l_all = fa.merge_stats(
                (o_ref.float(), m_ref, l_ref), (other[0].float(), *other[1:]))
            o_ref = fa.finalize_stats((acc, m_all, l_all)).to(q.dtype)
            lse = fa.logsumexp_of(m_all, l_all)
            del other, acc
        delta = (do.float() * o_ref.float()).sum(-1)
        dq = fa.fa_bwd_dq(q, k, v, do, lse, delta, **heads)
        dq_ref = fa.fa_bwd_dq_plain(q, k, v, do, lse, delta, **heads)
        dk, dv = fa.fa_bwd_dkv(q, k, v, do, lse, delta, **heads)
        dk_ref, dv_ref = fa.fa_bwd_dkv_plain(q, k, v, do, lse, delta, **heads)
        torch.cuda.synchronize()
        out["fa_bwd_dq"] = {"dq": row_err(dq, dq_ref)}
        out["fa_bwd_dkv"] = {"dk": row_err(dk, dk_ref), "dv": row_err(dv, dv_ref)}
        if timed:
            # the measure's own check: a dQ with delta 10% low past row 300
            # is within 1% of the reference's largest magnitude, but must
            # fail per row
            wrong = delta.clone()
            wrong[:, 300:] *= 0.9
            broken = fa.fa_bwd_dq_plain(q, k, v, do, lse, wrong, **heads)
            out["control"] = row_err(broken, dq_ref)
            del broken
        del dq_ref, dk_ref, dv_ref
    del o_ref

    if timed:
        def pair():
            return (fa.fa_bwd_dq(q, k, v, do, lse, delta, **heads),
                    fa.fa_bwd_dkv(q, k, v, do, lse, delta, **heads))

        pairs = b * hq * visible_pairs(s, s, causal)
        io = nbytes(m, l)
        mode = dict(normalize=not stats)
        out["timing"] = {
            "fa_fwd": dict(
                **timed_runs(lambda: fa.fa_fwd(q, k, v, **mode, **heads)),
                plain_ms=cuda_ms(lambda: fa.fa_fwd_plain(q, k, v, **mode, **heads),
                                 5, 1),
                bound=bound(4 * pairs * d, nbytes(q, k, v, o) + io)),
            "fa_bwd_dq": dict(
                **timed_runs(lambda: fa.fa_bwd_dq(q, k, v, do, lse, delta, **heads)),
                plain_ms=cuda_ms(lambda: fa.fa_bwd_dq_plain(
                    q, k, v, do, lse, delta, **heads), 5, 1),
                bound=bound(6 * pairs * d, nbytes(q, k, v, do, dq) + io)),
            "fa_bwd_dkv": dict(
                **timed_runs(lambda: fa.fa_bwd_dkv(q, k, v, do, lse, delta, **heads)),
                plain_ms=cuda_ms(lambda: fa.fa_bwd_dkv_plain(
                    q, k, v, do, lse, delta, **heads), 5, 1),
                bound=bound(8 * pairs * d, nbytes(q, k, v, do, dk, dv) + io)),
            # the port's whole backward, as SDPA's backward computes it in one call
            "bwd_pair": timed_runs(pair),
            "bwd_pair_graphed": timed_runs(graph_of(pair, torch.cuda.Stream()), reps=7),
        }
        if not ring:
            out["timing"].update(sdpa_ms(q, k, v, do, b, hq, hkv, s, d, causal))
    return out


def sdpa_ms(q, k, v, do, b, h, hkv, s, d, causal) -> dict:
    """PyTorch's fused attention on the same inputs — a yardstick only; the
    port never calls it.  K and V keep their ``hkv`` heads (``enable_gqa``
    where they are fewer than the query heads).  The backward computes dq,
    dk and dv in one call.
    Both are timed as the replay of a CUDA graph (``graph_of``), so the
    host's overhead per call (autograd's, which is larger than the device
    time of a b = 1 backward) is not counted; the backward also eagerly,
    for the record.  The forward the graphed backward consumes runs on the
    capture stream, since autograd runs a backward op on its forward's
    stream."""
    import torch.nn.functional as F

    do4 = do.view(b, h, s, d)

    def leaves():
        return [t.view(b, n, s, d).detach().requires_grad_()
                for t, n in ((q, h), (k, hkv), (v, hkv))]

    gqa = {"enable_gqa": True} if hkv != h else {}

    def fwd(qkv):
        return F.scaled_dot_product_attention(*qkv, is_causal=causal, **gqa)

    def bwd(o4, qkv):
        return lambda: torch.autograd.grad(o4, qkv, do4, retain_graph=True)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the graphed calls' own leaves and forward
        on_side = leaves()
        o_side = fwd(on_side)
    eager = leaves()
    # seven repetitions of the backward: it varies more between repetitions
    # than the kernels do
    return {
        "sdpa_fwd": timed_runs(graph_of(lambda: fwd(on_side), side)),
        "sdpa_bwd": timed_runs(graph_of(bwd(o_side, on_side), side), reps=7),
        "sdpa_bwd_eager": timed_runs(bwd(fwd(eager), eager), reps=5),
    }


def kernel_phase() -> tuple[dict, list]:
    """Every case held; returns every case's result by name (the
    ``TIMED_CASES`` with their timing) and the cases of every grid the main
    paths run (``PATH_CASES``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failures, held = [], {}
    for case in KERNEL_CASES:
        res = kernel_case(case, gen, timed=case in TIMED_CASES)
        held[case["name"]] = res
        for kname in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
            for tensor, (abs_err, rel) in res.get(kname, {}).items():
                ok = rel <= KERNEL_TOL
                log(f"  {case['name']:>14} {kname:>10} {tensor:>2}: max_abs_err "
                    f"{abs_err:.3e}  row rel err {rel:.3e}  (tol {KERNEL_TOL:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{case['name']}/{kname}/{tensor}")
        if "control" in res:
            abs_err, rel = res["control"]
            caught = rel > KERNEL_TOL
            log(f"  {case['name']:>14} control: plain dq with delta 10% low past "
                f"row 300: max_abs_err {abs_err:.3e}  row rel err {rel:.3e}  "
                f"{'rejected' if caught else 'NOT REJECTED'}")
            if not caught:
                failures.append(f"{case['name']}/control")
        if "timing" in res:
            t = res["timing"]
            sdpa = "sdpa_fwd" in t
            for kname, lib in (("fa_fwd", "sdpa_fwd"), ("fa_bwd_dq", "sdpa_bwd"),
                               ("fa_bwd_dkv", "sdpa_bwd")):
                bound_ms, bound_by = t[kname]["bound"]
                lib_ms = f"{t[lib]['ms']:.4f} ms" if sdpa else "none"
                log(f"  {kname:>10} at {case['name']}: {t[kname]['ms']:.4f} ms, plain "
                    f"{t[kname]['plain_ms']:.4f} ms, {lib} {lib_ms}, bound "
                    f"{bound_ms:.4f} ms ({bound_by})")
            if sdpa:
                log(f"  backward pair B2+B3: {t['bwd_pair']['ms']:.4f} ms, as a graph "
                    f"{t['bwd_pair_graphed']['ms']:.4f} ms, against sdpa_bwd (a graph) "
                    f"{t['sdpa_bwd']['ms']:.4f} ms, eagerly "
                    f"{t['sdpa_bwd_eager']['ms']:.4f} ms")
            for name in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv", "bwd_pair",
                         "bwd_pair_graphed", "sdpa_fwd", "sdpa_bwd", "sdpa_bwd_eager"):
                if name not in t:
                    continue
                runs = t[name]["runs"]
                log(f"  {name:>10} runs {[round(r, 4) for r in runs]} ms, spread "
                    f"{(max(runs) - min(runs)) / t[name]['ms']:.2%} of the median")
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    return held, [held[c["name"]] for c in PATH_CASES]


def _timing_fields(case: dict, name: str) -> dict:
    """A kernel's times at a timed case; ``library_ms`` None where no one
    PyTorch call computes the same function (the ring's stats mode)."""
    t = case["timing"]
    sdpa = "sdpa_fwd" in t
    library = ({"fa_fwd": t["sdpa_fwd"]["ms"], "fa_bwd_dq": t["sdpa_bwd"]["ms"],
                "fa_bwd_dkv": t["sdpa_bwd"]["ms"]} if sdpa else {})
    bound_ms, bound_by = t[name]["bound"]
    return {"ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(name),
            **({} if name == "fa_fwd" else {
                "bwd_pair_graphed_ms": t["bwd_pair_graphed"]["ms"],
                "library_eager_ms": t["sdpa_bwd_eager"]["ms"] if sdpa else None})}


def kernel_records(held: dict, path: list[dict], launches: dict) -> list[dict]:
    """One record per kernel: errors over every grid of the main paths
    (``PATH_CASES``), times at the main shape and, under ``micro`` and
    ``gqa``, at the microbatch shape and the LLaMA grid (the library's time
    is a CUDA graph's replay, see ``sdpa_ms``); ``launches`` is the
    one-device GPT run's, and ``launches_<path>`` each other path's, from
    ``launches`` ({path: {kernel: count}}, the GPT run under ``main``)."""
    records = []
    for name in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
        errs = [e for case in path for e in case[name].values()]
        sub = {}
        for key, case in (("micro", MICRO), ("gqa", LLAMA),
                          *((c["name"], c) for c in CONTEXT_CASES)):
            errs_at = list(held[case["name"]][name].values())
            sub[key] = {"shape": {k: case[k] for k in ("b", "hq", "hkv", "s", "d")},
                        "max_abs_err": max(e[0] for e in errs_at),
                        **_timing_fields(held[case["name"]], name)}
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches["main"][name],
            **{f"launches_{path_name}": counts[name]
               for path_name, counts in launches.items() if path_name != "main"},
            "held_at": [c["name"] for c in PATH_CASES],
            "max_abs_err": max(e[0] for e in errs),
            "max_row_rel_err": max(e[1] for e in errs),
            **_timing_fields(held[MAIN["name"]], name),
            **sub,
        })
    return records


class _RoundGradBf16(torch.autograd.Function):
    """Identity forward; the gradient through it is rounded to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).float()


def dense_rounded_ds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``causal_attention`` whose backward rounds dS (the scores' gradient)
    to bf16 before the dQ and dK products, as the kernels' backward does;
    the plain dense path keeps it in fp32.  A witness only: it shows how far
    that one rounding moves each gradient leaf."""
    seq = q.shape[2]
    scores = _RoundGradBf16.apply(torch.matmul(q.float(), k.float().transpose(-1, -2)))
    scores = scores / math.sqrt(q.shape[-1])
    mask = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    weights = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.matmul(weights.to(q.dtype), v)


def agreement_phase(base, grad_tol: float = GRAD_TOL, seeds=(SEED,),
                    witness: bool = False) -> dict:
    """Flash and dense attention give the same small model of ``base``'s
    family on the card, for each of ``seeds`` (weights and tokens): the
    loss within ``LOSS_TOL``, every gradient leaf within ``grad_tol``
    normwise.  With ``witness`` it also reads each leaf of the dense path
    whose backward rounds dS to bf16 (``dense_rounded_ds``) against the
    dense path, the share of the flash-vs-dense gap that this one rounding
    accounts for, and of both flash and dense against the model run in
    fp32 with dense attention: how far each bf16 path is from the exact
    gradient."""
    from metis_tpu_torch.execution.train import param_leaves
    from metis_tpu_torch.models import family_ops

    family = family_ops(base)
    what = type(base).__name__
    out = {}
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = family.init_params(gen, base, device="cuda")
        tokens = torch.randint(0, base.vocab_size, (2, base.seq_len), generator=gen,
                               device="cuda")
        runs = {"flash": (dataclasses.replace(base, attn="flash"), None),
                "dense": (dataclasses.replace(base, attn="dense"), None)}
        if witness:
            runs["dense_rounded_ds"] = (runs["dense"][0], dense_rounded_ds)
            runs["dense_fp32"] = (dataclasses.replace(base, attn="dense",
                                                      dtype=torch.float32), None)
        results = {}
        for name, (cfg, attn) in runs.items():
            leaves = [p.detach().requires_grad_() for p in param_leaves(params)]
            loss = family.loss(_rebuild(params, leaves), tokens, tokens.roll(-1, 1),
                               cfg, attn)
            results[name] = (loss.item(), torch.autograd.grad(loss, leaves))
        names = [f"{g}.{n}" for g, sub in params.items() for n in sub]
        (lf, gf), (ld, gd) = results["flash"], results["dense"]
        errs = {n: norm_err(a, b) for a, b, n in zip(gf, gd, names)}
        worst = max(errs.values())
        log(f"  small {what}, seed {seed}, flash vs dense: loss {lf:.5f} vs {ld:.5f} "
            f"(tol {LOSS_TOL:g}), worst normwise grad rel err {worst:.3e} (tol "
            f"{grad_tol:g}); per leaf {werrs_fmt(errs)}")
        out[seed] = {"loss_gap": abs(lf - ld), "worst": worst,
                     "worst_leaf": max(errs, key=errs.get)}
        if witness:
            leaf = out[seed]["worst_leaf"]
            g32 = results["dense_fp32"][1]
            for what_vs, got, want in (
                    ("dense with dS rounded to bf16 vs dense",
                     results["dense_rounded_ds"][1], gd),
                    ("flash vs fp32 dense", gf, g32),
                    ("dense vs fp32 dense", gd, g32)):
                werrs = {n: norm_err(a, b) for a, b, n in zip(got, want, names)}
                log(f"    {what_vs}: per leaf {werrs_fmt(werrs)}")
                out[seed][what_vs] = {"worst": max(werrs.values()),
                                      f"at {leaf}": werrs[leaf]}
        if not (abs(lf - ld) <= LOSS_TOL and worst <= grad_tol):
            raise SystemExit(f"flash {what} disagrees with the dense one (seed {seed})")
    return out


def werrs_fmt(errs: dict) -> dict:
    return {n: f"{e:.2e}" for n, e in errs.items()}


def _rebuild(tree: dict, leaves: list[torch.Tensor]) -> dict:
    it = iter(leaves)
    return {k: {kk: next(it) for kk in sub} for k, sub in tree.items()}


def write_cluster_files(work: pathlib.Path, device_type: str,
                        nodes: int, per_node: int) -> tuple[str, str]:
    """A hostfile and a clusterfile of ``nodes`` x ``per_node`` cards: 80 GB
    each, NVLink 4 within a node (450 GB/s per direction), 400 Gb/s NDR
    InfiniBand between nodes (50 GB/s)."""
    ips = [f"127.0.0.{i + 1}" for i in range(nodes)]
    hostfile = work / f"hostfile_{nodes}x{per_node}"
    clusterfile = work / f"clusterfile_{nodes}x{per_node}.json"
    hostfile.write_text("".join(f"{ip} slots={per_node}\n" for ip in ips))
    clusterfile.write_text(json.dumps({ip: {
        "instance_type": device_type, "memory": CLUSTER_MEMORY_GB,
        "intra_bandwidth": 450, "inter_bandwidth": 50} for ip in ips}))
    return str(hostfile), str(clusterfile)


def fresh_batches(cfg, gbs: int, n: int, seed: int) -> list:
    """``n`` batches of ``(tokens, targets)`` on the card, drawn from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        t = torch.randint(0, cfg.vocab_size, (gbs, cfg.seq_len), generator=gen,
                          device="cuda")
        out.append((t, t.roll(-1, 1)))
    return out


def train_run(cfg, artifact, batches, seed: int, blocks: int | None = None,
              routing_tokens=None) -> dict:
    """Train ``cfg`` from the weights of ``seed``, one step per batch,
    through ``build_executable`` in this process: the losses; with
    ``blocks`` each kernel held to ``blocks`` launches per step, and the
    launches summed; with ``routing_tokens`` (MoE) the first block's routing
    decisions of them before training and after the first step."""
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import ONE_DEVICE
    from metis_tpu_torch.ops import flash_attention as fa
    from metis_tpu_torch.testing import moe_routing

    exe = build_executable(cfg, artifact, device="cuda")
    state = exe.init(seed)
    out = {"losses": [], "launches": {name: 0 for name in fa.launch_counts},
           "routing": []}

    def route():
        out["routing"].append(moe_routing(state.params, routing_tokens, cfg,
                                          ONE_DEVICE, torch.device("cuda")))

    if routing_tokens is not None:
        route()
    for i, (tok, tgt) in enumerate(batches):
        fa.reset_launch_counts()
        state, loss = exe.step(state, tok, tgt)
        out["losses"].append(loss.item())
        if blocks is not None:
            step_counts = dict(fa.launch_counts)
            log(f"  step {i}: loss {out['losses'][-1]:.5f}  launches {step_counts}")
            for name, n in step_counts.items():
                if n != blocks:
                    raise SystemExit(f"step {i}: {name} launched {n} times, "
                                     f"expected {blocks}")
                out["launches"][name] += n
        if i == 0 and routing_tokens is not None:
            route()
    del state, exe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_trajectories(label: str, losses: list, dense_losses: list,
                       vocab_size: int) -> float:
    """Hold a flash trajectory to the dense one (``LOSS_TOL`` at step 0,
    ``TRAJ_TOL`` along it) and its start to ln(vocab) within 1; returns
    the largest gap."""
    gaps = [abs(a - b) for a, b in zip(losses, dense_losses)]
    log(f"  {label} losses flash {[round(x, 5) for x in losses]}")
    log(f"  {label} losses dense {[round(x, 5) for x in dense_losses]}")
    log(f"  {label} flash vs dense: step 0 gap {gaps[0]:.3e} (tol {LOSS_TOL:g}), "
        f"largest gap {max(gaps):.3e} (tol {TRAJ_TOL:g})")
    if not all(math.isfinite(x) for x in losses + dense_losses):
        raise SystemExit(f"{label}: non-finite losses {losses} / {dense_losses}")
    if gaps[0] > LOSS_TOL or max(gaps) > TRAJ_TOL:
        raise SystemExit(f"{label}: the flash trajectory disagrees with dense attention")
    if abs(losses[0] - math.log(vocab_size)) > 1.0:
        raise SystemExit(f"{label}: losses {losses}: expected to start near ln(vocab)")
    return max(gaps)


def routing_differences(got: dict, want: dict) -> dict:
    """How many of two runs' routing decisions (``moe_routing``) differ:
    expert choices, buffer positions and drops, of ``decisions``."""
    out = {k: int((got[k] != want[k]).sum())
           for k in ("expert_idx", "position", "keep")}
    out["decisions"] = int(want["expert_idx"].size)
    return out


def slice_phase(work: pathlib.Path, spec: dict = None, fresh: bool = False) -> dict:
    """Profile, train (flash and dense) and validate ``spec``'s model (the
    GPT preset by default) on the card, at mbs = gbs = 4: 5 steps on one
    batch, or with ``fresh`` on 5 batches drawn from the seed.  On one
    repeated batch the first AdamW step moves the LLaMA and MoE models so
    far that the LLaMA's loss falls to about 1e-3, which leaves the later
    steps nothing to compare, and the MoE's flash and dense trajectories
    part by about 0.5 on an H100."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ModelSpec, SearchConfig
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec, family_ops
    from metis_tpu_torch.planner.api import plan_uniform
    from metis_tpu_torch.profiles.profiler import profile_model
    from metis_tpu_torch.profiles.store import ProfileStore
    from metis_tpu_torch.validation import validate_uniform_plan

    model = ModelSpec(**(spec or GPT_15B))
    plan = UniformPlan(dp=1, pp=1, tp=1, mbs=4, gbs=4)

    t0 = time.perf_counter()
    store = profile_model(model, tps=(1,), bss=(1, 2, 4), device="cuda")
    # kept for the planner phase
    profile_dir = work / f"profiles_{model.name}"
    store.dump_to_dir(profile_dir, {"model_name": model.name, "attn": model.attn})
    store = ProfileStore.from_dir(profile_dir)
    device_type = store.device_types[0]
    prof = store.get(device_type, 1, plan.mbs)
    log(f"  profile {device_type}: {len(prof.layer_times_ms)} layers, "
        f"fwd+bwd {sum(prof.layer_times_ms):.3f} ms at bs={plan.mbs}, optimizer "
        f"{store.model.optimizer_time_ms:.3f} ms, batch "
        f"{store.model.batch_generator_ms:.3f} ms ({time.perf_counter() - t0:.1f} s)")
    for bs in (1, 2, 4):
        p = store.get(device_type, 1, bs)
        log(f"    bs={bs}: layer_times_ms {[round(t, 3) for t in p.layer_times_ms]}"
            f"  layer_memory_mb {[round(m, 1) for m in p.layer_memory_mb]}")
    if store.attn != "flash" or len(prof.layer_times_ms) != model.num_layers:
        raise SystemExit("profile did not round-trip")
    torch.cuda.empty_cache()

    cfg = config_for_model_spec(model)
    artifact = PlanArtifact.from_uniform_plan(plan)
    batches = (fresh_batches(cfg, plan.gbs, 5, SEED + 1) if fresh
               else fresh_batches(cfg, plan.gbs, 1, SEED + 1) * 5)
    tokens = batches[0][0]
    # MoE: the first block's routing of the second batch, before and after
    # the first step, through flash and through dense attention
    routing_tokens = batches[1][0] if family_ops(cfg).moe else None
    flash = train_run(cfg, artifact, batches, SEED, cfg.num_blocks, routing_tokens)
    losses, launches = flash["losses"], flash["launches"]
    # the same weights and tokens trained through dense attention: the
    # reference trajectory (no kernel runs on this side)
    dense = train_run(dataclasses.replace(cfg, attn="dense"), artifact, batches,
                      SEED, routing_tokens=routing_tokens)
    dense_losses = dense["losses"]
    routing_differ = None
    if routing_tokens is not None:
        routing_differ = {
            when: routing_differences(f, d) for when, f, d in zip(
                ("before_training", "after_step_0"), flash["routing"],
                dense["routing"])}
        log(f"  first-block routing decisions differing between flash and dense: "
            f"{routing_differ}")

    check_trajectories(model.name, losses, dense_losses, cfg.vocab_size)
    if losses[-1] >= losses[0]:
        raise SystemExit(f"losses {losses}: expected falling")

    # the prediction is the ported estimator's, on one card of this type
    hostfile, clusterfile = write_cluster_files(work, device_type, 1, 1)
    t0 = time.perf_counter()
    ranked = plan_uniform(ClusterSpec.from_files(hostfile, clusterfile), store,
                          model, SearchConfig(gbs=plan.gbs, max_profiled_tp=1,
                                              max_profiled_bs=plan.mbs),
                          include_oom=True)
    predicted = next(r for r in ranked.plans if r.plan == plan).cost.total_ms
    torch.cuda.reset_peak_memory_stats()
    report = validate_uniform_plan(plan, predicted, model, device="cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  validate: measured {report.measured_ms:.3f} ms/step, predicted "
        f"{report.predicted_ms:.3f} ms, error_pct {report.error_pct:.2f}, "
        f"peak memory {peak_gb:.2f} GB ({time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "losses": losses, "dense_losses": dense_losses,
            "flash_dense_routing_differ": routing_differ,
            "measured_ms": report.measured_ms, "predicted_ms": report.predicted_ms,
            "error_pct": report.error_pct, "peak_memory_gb": peak_gb,
            "profile_ms_bs4": sum(prof.layer_times_ms),
            "device_type": device_type, "profile_dir": str(profile_dir),
            "hostfile": hostfile, "clusterfile": clusterfile,
            "tokens": tokens.cpu(),
            "batches": [(t.cpu(), g.cpu()) for t, g in batches]}


def print_ranking(kind: str, rows: list[dict]) -> None:
    for i, row in enumerate(rows, 1):
        if kind == "uniform":
            plan = row["plan"]
            what = (f"dp {plan['dp']} pp {plan['pp']} tp {plan['tp']} mbs "
                    f"{plan['mbs']} gbs {plan['gbs']}")
        else:
            what = (f"{row['node_sequence']} groups {row['device_groups']} "
                    f"batches {row['batches']} strategies "
                    f"{[(s['dp'], s['tp']) for s in row['strategies']]} layers "
                    f"{row['layer_partition']}")
        breakdown = {k: round(v, 3) for k, v in row["cost_breakdown"].items()
                     if isinstance(v, float) and v}
        log(f"    {kind} #{i}: {what}: "
            f"cost_ms {row['cost_ms']:.3f}, oom {row['cost_breakdown']['oom']}, "
            f"breakdown {breakdown}")


def planner_phase(work: pathlib.Path, sliced: dict) -> dict:
    """Plan on the slice's profile with the port's CLI, validate the top
    uniform plans on the card, train the best hetero plan, and plan a
    16-card cluster from the same profile."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ModelSpec, SearchConfig
    from metis_tpu_torch.core.types import dump_ranked_plans
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.ops import flash_attention as fa
    from metis_tpu_torch.planner.api import plan_hetero
    from metis_tpu_torch.profiles.store import ProfileStore

    gbs = 4
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  card memory {total / 2**30:.2f} GiB ({total / 1e9:.2f} GB); the "
        f"clusterfile gives {CLUSTER_MEMORY_GB} GB, {CLUSTER_MEMORY_GB * 1024} MB "
        "to the planner")
    args = ["--hostfile", sliced["hostfile"], "--clusterfile", sliced["clusterfile"],
            "--profile-dir", sliced["profile_dir"], "--model-name", "gpt-1.5B",
            "--model-size", "1.5B", "--attn", "flash", "--gbs", str(gbs),
            "--max-tp", "1", "--max-bs", "4"]
    # the layer balancer charges a stage mem_coef x the sum of its layers'
    # profiled peaks; the reference's 5.0 puts the 1.5B model at several
    # times the measured step peak, so the hetero search also runs with the
    # coefficient that makes the demand of the executed plan (mbs 4) equal
    # to that peak (rounded up)
    store = ProfileStore.from_dir(sliced["profile_dir"])
    rows_mb = sum(store.get(sliced["device_type"], 1, gbs).layer_memory_mb)
    peak_mb = sliced["peak_memory_gb"] * 1e9 / 2**20
    mem_coef = math.ceil(peak_mb / rows_mb * 100) / 100
    log(f"  memory: layer rows at bs {gbs} sum to {rows_mb:.0f} MB, the step's "
        f"peak {peak_mb:.0f} MB: mem_coef {mem_coef} (reference 5.0 charges "
        f"{5.0 * rows_mb:.0f} MB)")
    out = {}
    for kind, extra in (("uniform", ["--include-oom"]), ("hetero-reference", []),
                        ("hetero", ["--mem-coef", str(mem_coef)])):
        path = work / f"{kind}.json"
        t0 = time.perf_counter()
        if cli.main([kind.split("-")[0], *args, *extra, "--output", str(path)]) != 0:
            raise SystemExit(f"{kind} search failed")
        rows = json.loads(path.read_text())
        log(f"  {' '.join([kind, *extra])}: {len(rows)} plans ranked in "
            f"{time.perf_counter() - t0:.2f} s (host)")
        print_ranking(kind, rows)
        out[kind] = rows
        if kind == "hetero-reference":
            continue  # recorded: at 5.0 no plan fits one card
        if not rows:
            raise SystemExit(f"the {kind} search costed no plan")
        if not all(math.isfinite(r["cost_ms"]) for r in rows):
            raise SystemExit(f"a {kind} plan has a non-finite cost")
    full = [r for r in out["uniform"] if r["plan"]["mbs"] == gbs]
    if not full or full[0]["cost_breakdown"]["oom"]:
        raise SystemExit(f"the mbs = {gbs} uniform plan is missing or flagged OOM "
                         f"(the step's peak is {sliced['peak_memory_gb']:.2f} GB)")

    path, ledger = work / "validate.json", work / "validate_ledger.jsonl"
    if cli.main(["validate", *args, "--validate-top-k", "3", "--ledger", str(ledger),
                 "--output", str(path)]) != 0:
        raise SystemExit("validate failed")
    validated = json.loads(path.read_text())
    reports = validated["plans"]
    for r in reports:
        log(f"  validate mbs {r['plan']['mbs']} gbs {r['plan']['gbs']}: measured "
            f"{r['measured_ms']:.3f} ms, predicted {r['predicted_ms']:.3f} ms, "
            f"error_pct {r['error_pct']:.2f}")
    log(f"  validate calibration {validated.get('calibration')}, calibrated mean "
        f"abs error {validated.get('calibrated_mean_abs_error_pct')}%")
    gated = [r for r in reports if r["plan"]["mbs"] == gbs]
    if len(reports) != 3 or len(gated) != 1:
        raise SystemExit(f"validate gave {len(reports)} reports, expected 3 with "
                         f"one at mbs = {gbs}")
    if not abs(gated[0]["error_pct"]) <= PLAN_ERROR_PCT:
        raise SystemExit(f"the mbs = gbs = {gbs} plan's error_pct "
                         f"{gated[0]['error_pct']:.2f} exceeds {PLAN_ERROR_PCT}")
    gc.collect()
    torch.cuda.empty_cache()

    # the best hetero plan, trained through its plan artifact
    model = ModelSpec(**GPT_15B)
    one_card = ClusterSpec.from_files(sliced["hostfile"], sliced["clusterfile"])
    config = SearchConfig(gbs=gbs, max_profiled_tp=1, max_profiled_bs=4,
                          mem_coef=mem_coef)
    result = plan_hetero(one_card, store, model, config, top_k=20)
    if dump_ranked_plans(result.plans) != json.dumps(out["hetero"], indent=2):
        raise SystemExit("plan_hetero disagrees with the hetero subcommand")
    artifact = PlanArtifact.from_ranked_plan(result.best)
    log(f"  hetero best as artifact: mesh {dict(zip(artifact.mesh_axes, artifact.mesh_shape))}, "
        f"microbatches {artifact.microbatches}, layers {artifact.layer_partition}")
    cfg = config_for_model_spec(model)
    exe = build_executable(cfg, artifact, device="cuda")
    state = exe.init(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (artifact.gbs, cfg.seq_len),
                           generator=gen, device="cuda")
    losses = []
    for i in range(3):
        fa.reset_launch_counts()
        state, loss = exe.step(state, tokens, tokens.roll(-1, 1))
        losses.append(loss.item())
        counts = dict(fa.launch_counts)
        log(f"  hetero step {i}: loss {losses[-1]:.5f}  launches {counts}")
        if any(n != cfg.num_blocks for n in counts.values()):
            raise SystemExit(f"hetero step {i}: launches {counts}, expected "
                             f"{cfg.num_blocks} of each")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite hetero losses {losses}")
    del state, exe
    gc.collect()
    torch.cuda.empty_cache()

    # a 2 x 8 cluster of these cards, planned from the one card's profile
    # (the reference's memory coefficient): at max tp 1 as the searches
    # above, and at max tp 4, where the tp 2 and 4 candidates prune for
    # want of a profile (the profile-miss contract)
    big_files = write_cluster_files(work, sliced["device_type"], 2, 8)
    big = ClusterSpec.from_files(*big_files)
    scale = {}
    for max_tp in (1, 4):
        res = plan_hetero(big, store, model, SearchConfig(
            gbs=64, max_profiled_tp=max_tp, max_profiled_bs=4), top_k=3)
        log(f"  2 x 8 {sliced['device_type']} at gbs 64, max tp {max_tp}: num_costed "
            f"{res.num_costed}, num_pruned {res.num_pruned} (profile misses), "
            f"search_seconds {res.search_seconds:.3f} (host)")
        rows = json.loads(dump_ranked_plans(res.plans))
        print_ranking("hetero", rows)
        if not rows or not all(math.isfinite(r["cost_ms"]) for r in rows):
            raise SystemExit("the 16-card search costed no finite plan")
        if max_tp > 1 and res.num_pruned == 0:
            raise SystemExit("tp > 1 candidates without a tp > 1 profile did "
                             "not prune")
        scale[f"max_tp_{max_tp}"] = {
            "num_costed": res.num_costed, "num_pruned": res.num_pruned,
            "search_seconds_host": res.search_seconds,
            "top_ms": [r["cost_ms"] for r in rows]}
        if max_tp == 1:
            big_rows = rows
    return {
        "ledger": str(ledger), "big_cluster": big_files, "big_rows": big_rows,
        "mem_coef": mem_coef,
        "hetero_reference_plans": len(out["hetero-reference"]),
        "uniform_top": [(r["plan"]["mbs"], r["cost_ms"], r["cost_breakdown"]["oom"])
                        for r in out["uniform"]],
        "hetero_top_ms": out["hetero"][0]["cost_ms"],
        "validate": [(r["plan"]["mbs"], r["measured_ms"], r["predicted_ms"],
                      r["error_pct"]) for r in reports],
        "hetero_losses": losses,
        "scale": scale,
    }


def dist_legs_check(label: str, ranks: list[dict], want: list[float], tol: float,
                    blocks) -> dict:
    """Hold every rank's trajectory to ``want`` within ``tol`` per step and
    its launches to ``blocks`` of each kernel per step (a callable: to
    ``blocks(rank's result)``, the counts of each of its steps); print and
    return the readings."""
    gaps = [abs(a - b) for r in ranks for a, b in zip(r["losses"], want)]
    worst = max(gaps)
    log(f"  {label}: kinds {sorted({r['kind'] for r in ranks})}, losses "
        f"{[round(x, 5) for x in ranks[0]['losses']]} against "
        f"{[round(x, 5) for x in want]}, largest gap {worst:.3e} (tol {tol:g})")
    for rank, r in enumerate(ranks):
        peak = r.get("peak_memory_bytes", 0) / 1e9
        log(f"    rank {rank} {r['slots']}: launches per step {r['launches']}, "
            f"peak memory {peak:.2f} GB, step ms {[round(x, 1) for x in r['step_ms']]} "
            f"({SHARED_CARD if len(ranks) > 1 else 'one rank'})")
    if any(r["kind"] != "gspmd" for r in ranks):
        raise SystemExit(f"{label}: not on the gspmd route")
    if not all(math.isfinite(x) for r in ranks for x in r["losses"]):
        raise SystemExit(f"{label}: non-finite losses")
    if len(gaps) != len(ranks) * len(want) or worst > tol:
        raise SystemExit(f"{label}: trajectory off by {worst:.3e} (tol {tol:g})")
    for r in ranks:
        expect = blocks(r) if callable(blocks) else dict.fromkeys(
            r["launches"][0], blocks)
        for counts in r["launches"]:
            if counts != expect:
                raise SystemExit(f"{label}: rank {r['slots']} launched {counts}, "
                                 f"expected {expect}")
    return {"largest_gap": worst, "losses": [r["losses"] for r in ranks],
            "launches_per_step": ([r["launches"][0] for r in ranks] if callable(blocks)
                                  else ranks[0]["launches"][0]),
            "peak_memory_gb": [r.get("peak_memory_bytes", 0) / 1e9 for r in ranks],
            "step_ms_shared_card": [r["step_ms"] for r in ranks]}


def dist_phase(work: pathlib.Path, sliced: dict) -> dict:
    """The gspmd route over torch.distributed on the one card (module doc,
    phase 6)."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.testing import run_plan_rank

    gc.collect()
    torch.cuda.empty_cache()
    model = ModelSpec(**GPT_15B)
    cfg = config_for_model_spec(model)
    tokens = sliced["tokens"]
    batch = (tokens, tokens.roll(-1, 1))
    gbs = tokens.shape[0]

    def artifact(dp, tp):
        return PlanArtifact.from_uniform_plan(UniformPlan(dp, 1, tp, gbs // dp, gbs)).to_json()

    out = {}
    # the reference of (a) and (c): one device at SHALLOW_BLOCKS.  tp 2 and
    # dp 2 alone run in the zero_sp phase (its tp2 and dp2_zero0 legs, the
    # same route and depth, held there to one device); here dp 2 x tp 2 on
    # four ranks
    shallow = dataclasses.replace(cfg, num_blocks=SHALLOW_BLOCKS)
    exe = build_executable(shallow, PlanArtifact.from_json(artifact(1, 1)), device="cuda")
    state, ref = exe.init(SEED), []
    for _ in range(3):
        state, loss = exe.step(state, batch[0].cuda(), batch[1].cuda())
        ref.append(loss.item())
    del state, exe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  reference, {SHALLOW_BLOCKS} block(s) on one device: losses "
        f"{[round(x, 5) for x in ref]}")
    t0 = time.perf_counter()
    ranks = on_ranks(run_plan_rank, 1, "nccl", artifact(1, 1), shallow, SEED,
                        [batch] * 3)
    out["a_nccl_world1"] = dist_legs_check(
        f"(a) NCCL world 1, {SHALLOW_BLOCKS} block(s)", ranks, ref, WORLD1_TOL,
        shallow.num_blocks)
    log(f"  (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ranks = on_ranks(run_plan_rank, 4, "gloo", artifact(2, 2), shallow,
                        SEED, [batch] * 3)
    out["c_dp2_tp2"] = dist_legs_check(
        f"(c) dp 2 x tp 2 on gloo ranks, {SHALLOW_BLOCKS} block(s)", ranks, ref,
        TRAJ_TOL, shallow.num_blocks)
    rank_launches = {name: [sum(step[name] for step in r["launches"]) for r in ranks]
                     for name in ranks[0]["launches"][0]}
    log(f"  (c) dp 2 x tp 2: {time.perf_counter() - t0:.1f} s")
    out["c_reference_losses"] = ref

    events, prof_dir = work / "profile_events.jsonl", work / "profiles_tp"
    if cli.main(["profile", "--model-name", "gpt-1.5B", "--model-size", "1.5B",
                 "--attn", "flash", "--tps", "1,2", "--bss", "1", "--warmup", "1",
                 "--iters", "2", "--events", str(events),
                 "--output-dir", str(prof_dir)]) != 0:
        raise SystemExit("profile --tps 1,2 failed")
    skipped = [e for e in map(json.loads, events.read_text().splitlines())
               if e["event"] == "profile_skipped"]
    files = sorted(f.name for f in prof_dir.iterdir())
    log(f"  (d) profile --tps 1,2: profile_skipped {skipped}; wrote {files}")
    if ([e["tp"] for e in skipped] != [2] or "exceeds 1 device" not in skipped[0]["reason"]
            or any("_tp2_" in f for f in files)):
        raise SystemExit("profile --tps 1,2 did not skip tp 2 on one card")
    out["d_profile_skipped"] = skipped
    torch.cuda.empty_cache()
    return out, rank_launches


def flash_launches(remat_blocks: int, kept_blocks: int, M: int) -> dict:
    """Launches of each kernel per step on one stage rank: a block
    recomputed under stage remat runs B1 twice per microbatch (its forward,
    then its recomputation inside the backward), a block whose graph is
    kept (gpipe, or the unit that ends in the loss, which runs forward and
    backward back to back) once; B2 and B3 run once per block per
    microbatch either way."""
    blocks = remat_blocks + kept_blocks
    return {"fa_fwd": M * (2 * remat_blocks + kept_blocks),
            "fa_bwd_dq": M * blocks, "fa_bwd_dkv": M * blocks}


def stage_artifact(partition, schedule: str, microbatches: int, gbs: int,
                   vs: int = 1) -> str:
    from metis_tpu_torch.execution.mesh import PlanArtifact

    return PlanArtifact(
        mesh_axes=("pp", "dp", "tp"), mesh_shape=(2, 1, 1),
        layer_partition=partition, strategies=({"dp": 1, "tp": 1},), gbs=gbs,
        microbatches=microbatches, schedule=schedule,
        virtual_stages=vs).to_json()


def pipeline_legs_check(label: str, ranks: list[dict], kind: str,
                        want: list[float], tol: float,
                        launches: list[dict]) -> dict:
    """Hold every rank's loss trajectory to ``want`` within ``tol``, its
    route to ``kind`` and its launches per step to ``launches[rank]``."""
    gaps = [abs(a - b) for r in ranks for a, b in zip(r["losses"], want)]
    worst = max(gaps)
    log(f"  {label}: kinds {sorted({r['kind'] for r in ranks})}, losses "
        f"{[round(x, 5) for x in ranks[0]['losses']]} against "
        f"{[round(x, 5) for x in want]}, largest gap {worst:.3e} (tol {tol:g})")
    for rank, r in enumerate(ranks):
        log(f"    rank {rank} {r['slots']} blocks {list(r['block_ids'])}: launches "
            f"per step {r['launches']} (expected {launches[rank]}), peak memory "
            f"{r['peak_memory_bytes'] / 1e9:.2f} GB, step ms "
            f"{[round(x, 1) for x in r['step_ms']]} ({SHARED_CARD})")
    if any(r["kind"] != kind for r in ranks):
        raise SystemExit(f"{label}: not on the {kind} route")
    if not all(math.isfinite(x) for r in ranks for x in r["losses"]):
        raise SystemExit(f"{label}: non-finite losses")
    if len(gaps) != len(ranks) * len(want) or worst > tol:
        raise SystemExit(f"{label}: trajectory off by {worst:.3e} (tol {tol:g})")
    for rank, r in enumerate(ranks):
        for counts in r["launches"]:
            if counts != launches[rank]:
                raise SystemExit(f"{label}: rank {rank} launches {counts}, "
                                 f"expected {launches[rank]}")
    return {"largest_gap": worst, "losses": ranks[0]["losses"],
            "launches_per_step": [r["launches"][0] for r in ranks],
            "block_ids": [list(r["block_ids"]) for r in ranks],
            "peak_memory_gb": [r["peak_memory_bytes"] / 1e9 for r in ranks],
            "step_ms_shared_card": [r["step_ms"] for r in ranks]}


def grad_norm_check(label: str, ranks: list[dict], want: dict, split) -> dict:
    """Hold each leaf's first-step gradient norm on the ranks (their
    ``grads``, ``run_plan_rank(first_grads="norms")``) to ``want``, the
    reference's, within ``GRAD_NORM_TOL`` relative: a leaf that ``split(group,
    name)`` says the ranks hold in disjoint pieces as the root of the sum of
    their squared norms, any other leaf on each rank that holds it.  AdamW's
    update hides a gradient's scale; these norms do not."""
    gaps = {}
    for group, sub in want.items():
        for name, ref in sub.items():
            held = [r["grads"][group][name] for r in ranks
                    if name in r["grads"].get(group, {})]
            if not held:
                raise SystemExit(f"{label}: no rank holds {group}.{name}")
            got = [math.sqrt(sum(n * n for n in held))] if split(group, name) else held
            gaps[f"{group}.{name}"] = max(abs(g / ref - 1) for g in got)
    worst = max(gaps, key=gaps.get)
    log(f"  {label}: first-step gradient norms against the reference, largest "
        f"relative gap {gaps[worst]:.3e} at {worst} (tol {GRAD_NORM_TOL:g}); per leaf "
        f"{ {k: f'{v:.1e}' for k, v in gaps.items()} }")
    if gaps[worst] > GRAD_NORM_TOL:
        raise SystemExit(f"{label}: gradient norm of {worst} off by {gaps[worst]:.3e}")
    return {"grad_norm_gap": gaps[worst], "grad_norm_gap_leaf": worst}


def stage_memory_estimates(sliced: dict, mem_coef: float, partition,
                           microbatches: int, gbs: int) -> dict:
    """The hetero planner's per-stage memory demand (``planner_stage_mb``)
    of a two-stage plan of one card per stage, at the fitted and the
    reference coefficient, in MB; and the profiled layer rows each stage
    sums (the coefficient that would equal a measured peak is peak /
    rows)."""
    from metis_tpu_torch.core.types import Strategy
    from metis_tpu_torch.profiles.store import ProfileStore

    work = pathlib.Path(sliced["profile_dir"]).parent
    spans = list(zip(partition[:-1], partition[1:]))
    out = {f"mem_coef_{coef}": planner_stage_mb(
        work, sliced["profile_dir"], GPT_15B, [Strategy(dp=1, tp=1)] * len(spans),
        spans, gbs, microbatches, coef) for coef in (mem_coef, 5.0)}
    store = ProfileStore.from_dir(sliced["profile_dir"])
    rows = store.get(sliced["device_type"], 1, gbs // microbatches).layer_memory_mb
    out["layer_rows_mb"] = [sum(rows[a:b]) for a, b in spans]
    return out


def executor_step_ms(cfg, batch, steps: int = 5) -> dict:
    """Time per step (CUDA events around ``steps`` queued steps after two
    of warm-up, host gaps included) of the one-device step over the whole
    batch (the gspmd route on one device) and of the one-stage hetero
    executor at M = 1 and M = 4, one after another on this card: what the
    stage executor costs over the one-device step at the same plan, and
    per extra microbatch."""
    from metis_tpu_torch.execution.hetero import StageSpec, make_hetero_train_step
    from metis_tpu_torch.execution.pipeline import microbatch_split
    from metis_tpu_torch.execution.train import build_train_state, make_train_step

    def timed(init, step, tok, tgt):
        state = init()
        for _ in range(2):
            state, _ = step(state, tok, tgt)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            state, loss = step(state, tok, tgt)
        end.record()
        torch.cuda.synchronize()
        if not math.isfinite(loss.item()):
            raise SystemExit("non-finite loss in the executor timing")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return start.elapsed_time(end) / steps

    tok, tgt = (t.cuda() for t in batch)
    out = {"one_device_full_batch": timed(
        lambda: build_train_state(SEED, cfg, "cuda"), make_train_step(cfg), tok, tgt)}
    for M in (1, 4):
        init_fn, step = make_hetero_train_step(
            cfg, [StageSpec((0, cfg.num_blocks), True, True, dp=1, tp=1)],
            device="cuda")
        out[f"hetero_M{M}"] = timed(lambda: init_fn(SEED), step,
                                    microbatch_split(tok, M), microbatch_split(tgt, M))
    return out


def one_stage(cfg, batches, microbatches: int, grad_norms: bool = False,
              probe=None):
    """The hetero executor with a single stage, in this process, one step
    per batch: losses, launches per step, the peak memory, and with
    ``grad_norms`` the norms of the gradients its first step applies
    (``testing.capture_first_grads``), else None, and ``probe(state)``
    before the first step (None without a ``probe``)."""
    from metis_tpu_torch.execution.hetero import StageSpec, make_hetero_train_step
    from metis_tpu_torch.execution.pipeline import microbatch_split
    from metis_tpu_torch.ops import flash_attention as fa
    from metis_tpu_torch.testing import capture_first_grads

    init_fn, step = make_hetero_train_step(
        cfg, [StageSpec((0, cfg.num_blocks), True, True, dp=1, tp=1)],
        device="cuda")
    state, losses, counts = init_fn(SEED), [], []
    probed = probe(state) if probe is not None else None
    norms = capture_first_grads(state, "norms") if grad_norms else None
    for batch in batches:
        tok, tgt = (microbatch_split(t.cuda(), microbatches) for t in batch)
        fa.reset_launch_counts()
        state, loss = step(state, tok, tgt)
        losses.append(loss.item())
        counts.append(dict(fa.launch_counts))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, init_fn, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, counts, peak, norms, probed


def pipeline_phase(work: pathlib.Path, sliced: dict, planned: dict) -> tuple[dict, dict]:
    """Multi-stage plans on the one card (module doc, phase 7)."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ModelSpec, SearchConfig
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.cost.estimator import EstimatorOptions, UniformCostEstimator
    from metis_tpu_torch.cost.volume import TransformerVolume
    from metis_tpu_torch.execution.hetero import StageSpec, make_hetero_train_step
    from metis_tpu_torch.execution.pipeline import microbatch_split
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.ops import flash_attention as fa
    from metis_tpu_torch.planner.api import plan_hetero
    from metis_tpu_torch.profiles.store import ProfileStore
    from metis_tpu_torch.testing import run_plans_rank
    from metis_tpu_torch.validation import validate_hetero_choice

    gc.collect()
    torch.cuda.empty_cache()
    model = ModelSpec(**GPT_15B)
    cfg = config_for_model_spec(model)
    tokens = sliced["tokens"]
    batch = (tokens, tokens.roll(-1, 1))
    gbs, M, L = tokens.shape[0], 4, cfg.num_blocks
    out = {}

    # (a) the one-stage reference, then the four schedules on two ranks
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ref, counts, peak, _, _ = one_stage(cfg, [batch] * 3, M)
    gap = max(abs(a - b) for a, b in zip(ref, sliced["losses"]))
    want = flash_launches(0, L, M)
    log(f"  (a) one stage, M {M}: losses {[round(x, 5) for x in ref]} against the "
        f"full-batch step's {[round(x, 5) for x in sliced['losses'][:3]]}, largest "
        f"gap {gap:.3e} (tol {TRAJ_TOL:g}); launches {counts[0]} (expected {want}); "
        f"peak {peak:.2f} GB ({time.perf_counter() - t0:.1f} s)")
    if not all(math.isfinite(x) for x in ref) or gap > TRAJ_TOL:
        raise SystemExit("the one-stage reference disagrees with the full-batch step")
    if any(c != want for c in counts):
        raise SystemExit(f"one-stage launches {counts}, expected {want}")
    out["a_one_stage"] = {"losses": ref, "gap_to_full_batch": gap,
                          "launches_per_step": counts[0], "peak_memory_gb": peak}
    t0 = time.perf_counter()
    out["a_step_ms"] = executor_step_ms(cfg, batch)
    log(f"  (a) ms per step, one after another: "
        f"{ {k: round(v, 3) for k, v in out['a_step_ms'].items()} } "
        f"({time.perf_counter() - t0:.1f} s)")

    legs = [  # label, artifact, route, launches of rank 0 and rank 1
        ("gpipe 4 + 4", stage_artifact((0, 5, 10), "gpipe", M, gbs), "pipeline",
         [flash_launches(0, 4, M), flash_launches(0, 4, M)]),
        ("1f1b 3 + 5", stage_artifact((0, 4, 10), "1f1b", M, gbs), "pipeline",
         [flash_launches(3, 0, M), flash_launches(0, 5, M)]),
        ("gpipe 3 + 5 (hetero route)", stage_artifact((0, 4, 10), "gpipe", M, gbs),
         "hetero", [flash_launches(3, 0, M), flash_launches(0, 5, M)]),
        # chunks 0, 2 on rank 0 and 1, 3 on rank 1, 2 blocks each; chunk 3
        # ends in the loss
        ("interleaved 2 x 2", stage_artifact((), "interleaved", M, gbs, vs=2),
         "pipeline", [flash_launches(4, 0, M), flash_launches(2, 2, M)]),
    ]
    t0 = time.perf_counter()
    jobs = [dict(artifact_json=art, cfg=cfg, init=SEED, batches=[batch] * 3)
            for _, art, _, _ in legs]
    ranks = on_ranks(run_plans_rank, 2, "gloo", jobs)
    log(f"  (a) two gloo ranks, four plans: {time.perf_counter() - t0:.1f} s")
    pipe_launches = {name: {} for name in want}
    for i, (label, _, kind, launches) in enumerate(legs):
        leg = [r[i] for r in ranks]
        out[f"a_{label}"] = pipeline_legs_check(
            f"(a) {label}", leg, kind, ref, PIPE_TOL, launches)
        for name in pipe_launches:
            pipe_launches[name][label] = [r["launches"][0][name] for r in leg]
    mem = stage_memory_estimates(sliced, planned["mem_coef"], (0, 5, 10), M, gbs)
    peaks_mb = [p * 1e9 / 2**20 for p in out["a_gpipe 4 + 4"]["peak_memory_gb"]]
    needed = [round(p / r, 3) for p, r in zip(peaks_mb, mem["layer_rows_mb"])]
    fitted = mem[f"mem_coef_{planned['mem_coef']}"]
    log(f"  (a) gpipe 4 + 4 per-stage peaks {[round(p) for p in peaks_mb]} MB against "
        f"the planner's stage estimates {[round(x) for x in fitted]} "
        f"MB at mem_coef {planned['mem_coef']} and "
        f"{[round(x) for x in mem['mem_coef_5.0']]} MB at 5.0; profiled layer rows "
        f"{[round(x) for x in mem['layer_rows_mb']]} MB, so the measured peaks "
        f"need mem_coef {needed}")
    out["a_memory"] = {**mem, "peak_mb": peaks_mb, "mem_coef_needed": needed}

    # (b) a hetero plan on four ranks: stage 0 dp 2 over rows (3, 1) of the
    # 4-row microbatch, stage 1 tp 2; 2 blocks at full width
    t0 = time.perf_counter()
    shallow = dataclasses.replace(cfg, num_blocks=2)
    ref2, *_ = one_stage(shallow, [batch] * 3, 1)
    stages = (StageSpec((0, 1), True, False, dp=2, tp=1, replica_rows=(3, 1)),
              StageSpec((1, 2), False, True, dp=1, tp=2))
    ranks = on_ranks(run_plans_rank, 4, "gloo", [dict(
        artifact_json=None, stages=stages, microbatches=1, cfg=shallow, init=SEED,
        batches=[batch] * 3)])
    out["b_hetero_rows_tp"] = pipeline_legs_check(
        "(b) dp 2 rows (3, 1) | tp 2, 2 blocks", [r[0] for r in ranks], "hetero",
        ref2, TRAJ_TOL, [flash_launches(1, 0, 1)] * 2 + [flash_launches(0, 1, 1)] * 2)
    out["b_reference_losses"] = ref2
    log(f"  (b) {time.perf_counter() - t0:.1f} s")

    # (c) validate_hetero_choice on the one-card cluster
    t0 = time.perf_counter()
    store = ProfileStore.from_dir(sliced["profile_dir"])
    one_card = ClusterSpec.from_files(sliced["hostfile"], sliced["clusterfile"])
    result = plan_hetero(one_card, store, model, SearchConfig(
        gbs=gbs, max_profiled_tp=1, max_profiled_bs=4,
        mem_coef=planned["mem_coef"]), top_k=20)
    reports = validate_hetero_choice(result.plans, model, device="cuda",
                                     cluster=one_card, profiles=store, top_k=3,
                                     steps=5)
    # the same one-card plans priced from the raw profile at bs = gbs / M,
    # charged once per microbatch (the estimator with its affine smoothing
    # of the bs axis off)
    raw = UniformCostEstimator(
        one_card, store, TransformerVolume(model, store.model.params_per_layer_bytes),
        EstimatorOptions(mb_affine=False))
    rows = []
    for r in reports:
        M_r = r.plan_dict["batches"]
        raw_ms = raw.get_cost(UniformPlan(dp=1, pp=1, tp=1, mbs=gbs // M_r, gbs=gbs),
                              sliced["device_type"]).total_ms
        raw_err = (raw_ms - r.measured_ms) / r.measured_ms * 100
        rows.append({"batches": M_r, "num_stages": r.plan_dict["num_stages"],
                     "measured_ms": r.measured_ms, "predicted_ms": r.predicted_ms,
                     "error_pct": r.error_pct, "predicted_raw_profile_ms": raw_ms,
                     "error_pct_raw_profile": raw_err})
        log(f"  (c) hetero plan, {r.plan_dict['num_stages']} stage(s), "
            f"{M_r} microbatch(es): measured {r.measured_ms:.3f} ms, "
            f"predicted {r.predicted_ms:.3f} ms, error_pct {r.error_pct:.2f}; "
            f"from the raw bs {gbs // M_r} profile {raw_ms:.3f} ms, error_pct "
            f"{raw_err:.2f}")
    if len(rows) != min(3, len(result.plans)) or not rows:
        raise SystemExit(f"validate_hetero_choice gave {len(rows)} reports")
    if not all(math.isfinite(r["measured_ms"]) and r["measured_ms"] > 0
               for r in rows):
        raise SystemExit(f"non-finite or non-positive measurements {rows}")
    out["c_validate_hetero"] = rows
    log(f"  (c) {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out, pipe_launches


def one_card_plans(work: pathlib.Path, sliced: dict, spec: dict,
                   extra: tuple = ()) -> dict:
    """The ``uniform`` and ``hetero`` searches of the port's CLI on the
    slice's one-card profile, the hetero one at the memory coefficient that
    makes the mbs = 4 plan's demand the measured step peak (as the planner
    phase fits it); rankings printed."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.profiles.store import ProfileStore

    store = ProfileStore.from_dir(sliced["profile_dir"])
    rows_mb = sum(store.get(sliced["device_type"], 1, 4).layer_memory_mb)
    mem_coef = math.ceil(sliced["peak_memory_gb"] * 1e9 / 2**20 / rows_mb * 100) / 100
    args = ["--hostfile", sliced["hostfile"], "--clusterfile", sliced["clusterfile"],
            "--profile-dir", sliced["profile_dir"], "--model-name", spec["name"],
            *CLI_MODEL[spec["name"]], "--gbs", "4", "--max-tp", "1", "--max-bs", "4",
            *extra]
    out = {"mem_coef": mem_coef}
    for kind, more in (("uniform", ["--include-oom"]), ("hetero", ["--mem-coef", str(mem_coef)])):
        path = work / f"{spec['name']}_{kind}.json"
        t0 = time.perf_counter()
        if cli.main([kind, *args, *more, "--output", str(path)]) != 0:
            raise SystemExit(f"{spec['name']}: {kind} search failed")
        rows = json.loads(path.read_text())
        log(f"  {kind} {' '.join(extra + tuple(more))}: {len(rows)} plans ranked in "
            f"{time.perf_counter() - t0:.2f} s (host)")
        print_ranking(kind, rows[:3])
        if not rows or not all(math.isfinite(r["cost_ms"]) for r in rows):
            raise SystemExit(f"{spec['name']}: the {kind} search costed no finite plan")
        out[f"{kind}_top_ms"] = rows[0]["cost_ms"]
        out[f"{kind}_plans"] = len(rows)
    return out


def launch_sums(ranks: list[dict]) -> dict:
    """Each kernel's launches over a job's steps, per rank."""
    return {name: [sum(step[name] for step in r["launches"]) for r in ranks]
            for name in ranks[0]["launches"][0]}


def llama_phase(work: pathlib.Path) -> tuple[dict, dict]:
    """The LLaMA configuration (``LLAMA_15B``, 32 query heads over 8 KV
    heads): a small flash-vs-dense check, the slice's profile, train and
    validate (gated at ``PLAN_ERROR_PCT``), the one-card searches, tp 2 on
    two gloo ranks at ``SHALLOW_BLOCKS`` against one device at that depth,
    and a two-stage hetero plan of ``LLAMA_STAGE_BLOCKS`` blocks (1 + 1, 2
    microbatches) against the one-stage executor at that depth."""
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.hetero import StageSpec
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.models.llama import LlamaConfig
    from metis_tpu_torch.testing import run_plan_rank, run_plans_rank

    small = agreement_phase(
        LlamaConfig(vocab_size=512, seq_len=256, hidden=512, num_heads=4,
                    num_blocks=2, num_kv_heads=2),
        LLAMA_GRAD_TOL, seeds=(SEED, *OTHER_SEEDS), witness=True)
    sliced = slice_phase(work, LLAMA_15B, fresh=True)
    if not abs(sliced["error_pct"]) <= PLAN_ERROR_PCT:
        raise SystemExit(f"LLaMA: the mbs = gbs = 4 plan's error_pct "
                         f"{sliced['error_pct']:.2f} exceeds {PLAN_ERROR_PCT}")
    out = {k: v for k, v in sliced.items() if k not in HIDDEN}
    out["small_flash_vs_dense"] = small
    out["plans"] = one_card_plans(work, sliced, LLAMA_15B)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = config_for_model_spec(ModelSpec(**LLAMA_15B))
    tokens = sliced["tokens"]
    batch = (tokens, tokens.roll(-1, 1))
    launches = {"llama": sliced["launches"]}

    t0 = time.perf_counter()
    # tp 2 at SHALLOW_BLOCKS, held to one device at that depth (tp 2 of the
    # GPT ran at full depth across cards, PERF.md §6)
    shallow = config_for_model_spec(ModelSpec(**dict(
        LLAMA_15B, num_layers=SHALLOW_BLOCKS + 2)))
    want = train_run(shallow, PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, 4, 4)),
                     [(t.cuda(), g.cuda()) for t, g in sliced["batches"][:3]],
                     SEED)["losses"]
    art = PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 2, 4, 4)).to_json()
    ranks = on_ranks(run_plan_rank, 2, "gloo", art, shallow, SEED,
                        sliced["batches"][:3])
    out["tp2"] = dist_legs_check(
        f"LLaMA tp 2 on two gloo ranks, {SHALLOW_BLOCKS} block(s)", ranks, want,
        TRAJ_TOL, shallow.num_blocks)
    out["tp2"]["gap_to_one_device"] = out["tp2"].pop("largest_gap")
    out["tp2"]["one_device_losses"] = want
    launches["llama_tp2_per_rank"] = launch_sums(ranks)
    log(f"  tp 2: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    M = 2
    # the slice's fresh batches, as the tp 2 leg: on one repeated batch the
    # first step takes the loss to about 1e-3 and leaves nothing to compare
    batches = sliced["batches"][:3]
    half = LLAMA_STAGE_BLOCKS // 2
    staged = config_for_model_spec(ModelSpec(**dict(
        LLAMA_15B, num_layers=LLAMA_STAGE_BLOCKS + 2)))
    ref, counts, _, want_norms, _ = one_stage(staged, batches, M, grad_norms=True)
    if any(c != flash_launches(0, staged.num_blocks, M) for c in counts):
        raise SystemExit(f"LLaMA one-stage launches {counts}")
    stages = (StageSpec((0, half), True, False, dp=1, tp=1),
              StageSpec((half, 2 * half), False, True, dp=1, tp=1))
    ranks = [r[0] for r in on_ranks(run_plans_rank, 2, "gloo", [dict(
        artifact_json=None, stages=stages, microbatches=M, cfg=staged, init=SEED,
        batches=batches, first_grads="norms")])]
    label = f"LLaMA hetero {half} + {half}"
    out["hetero"] = pipeline_legs_check(
        f"{label}, M 2, against one stage", ranks,
        "hetero", ref, PIPE_TOL, [flash_launches(half, 0, M), flash_launches(0, half, M)])
    out["hetero"]["one_stage_losses"] = ref
    # the stages hold disjoint blocks, embed on the first, head on the last
    out["hetero"].update(grad_norm_check(
        label, ranks, want_norms, lambda group, name: group == "blocks"))
    launches["llama_hetero_per_rank"] = launch_sums(ranks)
    log(f"  {label}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def moe_phase(work: pathlib.Path) -> tuple[dict, dict]:
    """The MoE configuration (``MOE_15B``: 2 blocks of 8 experts, top 2):
    the slice's profile, train and validate (error_pct recorded, not gated),
    the one-card searches with ``--enable-ep``, and ep 2 on two gloo ranks
    at gbs 8 (each rank one whole 4096-token routing group) against the
    one-device step, with the count of first-block routing decisions that
    differ between the two."""
    import numpy as np

    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import ONE_DEVICE, PlanArtifact, expert_leaves
    from metis_tpu_torch.execution.train import param_specs_for
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.testing import capture_first_grads, moe_routing, run_plans_rank

    sliced = slice_phase(work, MOE_15B, fresh=True)
    out = {k: v for k, v in sliced.items() if k not in HIDDEN}
    out["plans"] = one_card_plans(work, sliced, MOE_15B, ("--enable-ep",))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = config_for_model_spec(ModelSpec(**MOE_15B))
    launches = {"moe": sliced["launches"]}

    # the flash and dense trajectories from two more seeds (weights and
    # batches), with the routing decisions that differ after the first step
    t0 = time.perf_counter()
    one_card = PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, 4, 4))
    out["other_seeds"] = {}
    for seed in OTHER_SEEDS:
        batches = fresh_batches(cfg, 4, 5, seed + 1)
        runs = [train_run(c, one_card, batches, seed, routing_tokens=batches[1][0])
                for c in (cfg, dataclasses.replace(cfg, attn="dense"))]
        gap = check_trajectories(f"seed {seed}", runs[0]["losses"], runs[1]["losses"],
                                 cfg.vocab_size)
        differ = routing_differences(runs[0]["routing"][1], runs[1]["routing"][1])
        log(f"  seed {seed}: first-block routing decisions differing between "
            f"flash and dense after step 0: {differ}")
        out["other_seeds"][seed] = {
            "largest_gap": gap, "losses": runs[0]["losses"],
            "dense_losses": runs[1]["losses"], "routing_differ_after_step_0": differ}
    log(f"  other seeds: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gbs = 8
    # three batches, as the slice's fresh ones (slice_phase)
    batches = [(t.cpu(), g.cpu()) for t, g in fresh_batches(cfg, gbs, 3, SEED + 3)]
    one = build_executable(cfg, PlanArtifact.from_uniform_plan(
        UniformPlan(1, 1, 1, gbs, gbs)), device="cuda")
    state = one.init(SEED)
    want_routing = moe_routing(state.params, batches[0][0], cfg, ONE_DEVICE,
                               torch.device("cuda"))
    want_norms = capture_first_grads(state, "norms")
    torch.cuda.reset_peak_memory_stats()
    ref = []
    for tok, tgt in batches:
        state, loss = one.step(state, tok.cuda(), tgt.cuda())
        ref.append(loss.item())
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    del state, one
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  one device at gbs {gbs}: losses {[round(x, 5) for x in ref]}, peak "
        f"{one_peak:.2f} GB")
    art = PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, 1, 2, 1, 1),
        layer_partition=(0, cfg.num_profile_layers),
        strategies=({"dp": 2, "tp": 1, "cp": 1, "ep": 2, "zero": 0, "sp": False},),
        gbs=gbs, microbatches=1).to_json()
    ranks = [r[0] for r in on_ranks(
        run_plans_rank, 2, "gloo", [dict(
            artifact_json=art, cfg=cfg, init=SEED, batches=batches,
            routing_tokens=batches[0][0], first_grads="norms")])]
    out["ep2"] = dist_legs_check(
        f"MoE ep 2 on two gloo ranks, gbs {gbs}", ranks, ref, PIPE_TOL, cfg.num_blocks)
    out["ep2"]["gap_to_one_device"] = out["ep2"].pop("largest_gap")
    out["ep2"]["one_device_losses"] = ref
    out["ep2"]["one_device_peak_gb"] = one_peak
    # the ranks hold disjoint halves of the experts, and every dense leaf
    experts = expert_leaves(param_specs_for(cfg))
    out["ep2"].update(grad_norm_check(
        "MoE ep 2", ranks, want_norms, lambda group, name: (group, name) in experts))
    got = {k: np.concatenate([r["routing"][k] for r in ranks]) for k in want_routing}
    differ = routing_differences(got, want_routing)
    log(f"  ep 2 first-block routing decisions differing from one device: {differ}")
    out["ep2"]["routing_differ"] = differ
    launches["moe_ep2_per_rank"] = launch_sums(ranks)
    log(f"  ep 2: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


# the context phase's LLaMA: the 1.5B preset's LLaMA at LLaMA-3-8B's
# 8192-token context, gbs 1; the legs whose two ranks share the card run 2
# of its 8 blocks (two ranks at full depth would hold 2 x 37.9 GB of state)
LLAMA_LONG = dict(LLAMA_15B, name="llama-1.5B-8k", sequence_length=8192)
CONTEXT_BLOCKS = 2
CONTEXT_CLI = [*CLI_MODEL["llama-1.5B"], "--seq-len", "8192", "--num-layers",
               str(CONTEXT_BLOCKS + 2)]
# a cp 2 leg's losses against one device at the same depth, per step (bf16
# through 2 blocks; the ring and Ulysses change only the order of sums)
CP_TOL = 1e-2
# the zero_sp phase's legs against their references (dp 2 at zero 0, tp 2
# without sp), per step: ZeRO changes no arithmetic, sp only where the
# partial sums are reduced
ZERO_SP_TOL = 1e-2


def ring_launches(position: int, blocks: int) -> dict:
    """Launches of each kernel per step on ring position ``position`` of
    ``blocks`` blocks: its self block and its ``position`` past blocks,
    none of the future ones."""
    n = (position + 1) * blocks
    return {"fa_fwd": n, "fa_bwd_dq": n, "fa_bwd_dkv": n}


def combined_norms(ranks: list[dict], split) -> dict:
    """The first-step gradient norms of a leg's leaves: the root of the sum
    of the ranks' squares for a leaf ``split(group, name)`` says they hold in
    disjoint pieces, else rank 0's."""
    return {g: {n: math.sqrt(sum(r["grads"][g][n] ** 2 for r in ranks))
                if split(g, n) else ranks[0]["grads"][g][n] for n in sub}
            for g, sub in ranks[0]["grads"].items()}


def context_phase(work: pathlib.Path) -> tuple[dict, dict]:
    """The long-context LLaMA (``LLAMA_LONG``, 8192 tokens, gbs 1): (a) one
    device at full depth, 3 steps; at ``CONTEXT_BLOCKS`` blocks on two gloo
    ranks sharing the card, in one job, each against one device at that
    depth on the same fresh batches: (b) cp 2 ring, (c) cp 2 Ulysses, (d)
    the best-ranked cp 2 plan of the hetero search on a 1 x 2 H100 cluster
    (``--enable-cp --max-cp 2 --enable-zero --enable-sp``) from a profile at
    that depth, through ``PlanArtifact.from_ranked_plan``.  Loss gaps,
    first-step gradient norms, launches per rank per step (rank r of the
    ring runs r + 1 blocks of each kernel per block) and each rank's peak."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ModelSpec, SearchConfig
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.planner.api import plan_hetero
    from metis_tpu_torch.profiles.store import ProfileStore
    from metis_tpu_torch.testing import run_plan_rank, run_plans_rank

    model = ModelSpec(**LLAMA_LONG)
    cfg = config_for_model_spec(model)
    one = PlanArtifact.from_uniform_plan(UniformPlan(1, 1, 1, 1, 1)).to_json()
    batches = [(t.cpu(), g.cpu()) for t, g in fresh_batches(cfg, 1, 3, SEED + 5)]
    out, launches = {}, {}

    t0 = time.perf_counter()
    full = run_plan_rank(0, torch.device("cuda"), one, cfg, SEED, batches)
    log(f"  (a) one device, {cfg.num_blocks} blocks, 8192 tokens: losses "
        f"{[round(x, 5) for x in full['losses']]}, step ms "
        f"{[round(x, 1) for x in full['step_ms']]}, launches per step "
        f"{full['launches']}, peak {full['peak_memory_bytes'] / 1e9:.2f} GB")
    if (not all(math.isfinite(x) for x in full["losses"])
            or abs(full["losses"][0] - math.log(cfg.vocab_size)) > 1.0):
        raise SystemExit(f"(a) losses {full['losses']}: expected finite, starting "
                         "near ln(vocab)")
    if any(c != ring_launches(0, cfg.num_blocks) for c in full["launches"]):
        raise SystemExit(f"(a) launches {full['launches']}: expected "
                         f"{cfg.num_blocks} of each per step")
    out["a_one_device"] = {k: full[k] for k in ("losses", "step_ms", "launches")}
    out["a_one_device"]["peak_memory_gb"] = full["peak_memory_bytes"] / 1e9
    launches["context_one_device"] = full["launches"][0]
    log(f"  (a) {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    shallow = dataclasses.replace(cfg, num_blocks=CONTEXT_BLOCKS)
    ref = run_plan_rank(0, torch.device("cuda"), one, shallow, SEED, batches,
                        first_grads="norms")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  one device at {CONTEXT_BLOCKS} blocks: losses "
        f"{[round(x, 5) for x in ref['losses']]}, peak "
        f"{ref['peak_memory_bytes'] / 1e9:.2f} GB")

    # (d) the planner on a profile at that depth
    prof_dir = work / "profiles_llama_8k"
    if cli.main(["profile", "--model-name", model.name, *CONTEXT_CLI,
                 "--bss", "1,2", "--warmup", "1", "--iters", "2",
                 "--output-dir", str(prof_dir)]) != 0:
        raise SystemExit("profile of the long-context LLaMA failed")
    store = ProfileStore.from_dir(prof_dir)
    device_type = store.device_types[0]
    rows_mb = sum(store.get(device_type, 1, 1).layer_memory_mb)
    mem_coef = math.ceil(ref["peak_memory_bytes"] / 2**20 / rows_mb * 100) / 100
    hostfile, clusterfile = write_cluster_files(work, device_type, 1, 2)
    path = work / "context_hetero.json"
    axes = ["--enable-cp", "--max-cp", "2", "--enable-zero", "--enable-sp"]
    if cli.main(["hetero", "--hostfile", hostfile, "--clusterfile", clusterfile,
                 "--profile-dir", str(prof_dir), "--model-name", model.name,
                 *CONTEXT_CLI, "--gbs", "1", "--max-tp", "1", "--max-bs", "2",
                 "--mem-coef", str(mem_coef), *axes, "--output", str(path)]) != 0:
        raise SystemExit("the context hetero search failed")
    rows = json.loads(path.read_text())
    log(f"  (d) hetero {' '.join(axes)} at mem_coef {mem_coef}: {len(rows)} plans "
        "printed")
    print_ranking("hetero", rows[:5])
    # every ranked plan, not only the printed ones
    result = plan_hetero(
        ClusterSpec.from_files(hostfile, clusterfile), store,
        ModelSpec(**dict(LLAMA_LONG, num_layers=CONTEXT_BLOCKS + 2)),
        SearchConfig(gbs=1, max_profiled_tp=1, max_profiled_bs=2, mem_coef=mem_coef,
                     enable_cp=True, max_cp_degree=2, enable_zero=True,
                     enable_sp=True))
    if not rows or result.best.cost.total_ms != rows[0]["cost_ms"]:
        raise SystemExit("plan_hetero disagrees with the hetero subcommand")
    rank, chosen = next(((i, p) for i, p in enumerate(result.plans, 1)
                         if any(s.cp == 2 for s in p.intra.strategies)), (0, None))
    if chosen is None:
        raise SystemExit("no ranked plan has cp 2")
    planned = PlanArtifact.from_ranked_plan(chosen)
    strategy = planned.strategies[0]
    log(f"  (d) best cp 2 plan: #{rank} of {len(result.plans)}, strategies "
        f"{list(planned.strategies)}, cost {chosen.cost.total_ms:.3f} ms, "
        f"mesh {dict(zip(planned.mesh_axes, planned.mesh_shape))}")
    out["d_planned"] = {"rank": rank, "plans": len(result.plans),
                        "strategies": list(planned.strategies),
                        "cost_ms": chosen.cost.total_ms, "mem_coef": mem_coef}
    gc.collect()
    torch.cuda.empty_cache()

    def cp_plan(mode):
        return PlanArtifact(
            mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, 1, 1, 2, 1),
            layer_partition=(0, CONTEXT_BLOCKS + 2),
            strategies=({"dp": 1, "tp": 1, "cp": 2, "ep": 1, "zero": 0,
                         "sp": False, "cp_mode": mode},),
            gbs=1, microbatches=1).to_json()

    legs = (("b_ring", cp_plan("ring")), ("c_a2a", cp_plan("a2a")),
            ("d_planned", planned.to_json()))
    ranks = on_ranks(run_plans_rank, 2, "gloo", [dict(
        artifact_json=art, cfg=shallow, init=SEED, batches=batches,
        first_grads="norms") for _, art in legs])
    for i, (name, _) in enumerate(legs):
        legs_ranks = [r[i] for r in ranks]
        mode = (strategy.get("cp_mode", "ring") if name == "d_planned"
                else name.split("_")[1])
        expect = ((lambda r: ring_launches(r["slots"]["sp"][0], CONTEXT_BLOCKS))
                  if mode == "ring" else CONTEXT_BLOCKS)
        res = dist_legs_check(f"({name[0]}) {name[2:]}, cp 2 {mode} on two gloo "
                              f"ranks, {CONTEXT_BLOCKS} blocks", legs_ranks,
                              ref["losses"], CP_TOL, expect)
        res.update(grad_norm_check(f"({name[0]})", legs_ranks, ref["grads"],
                                   lambda group, n: False))
        out.setdefault(name, {}).update(res)
        launches[f"context_{name}_per_rank"] = launch_sums(legs_ranks)
    out["reference_losses"] = ref["losses"]
    out["reference_peak_gb"] = ref["peak_memory_bytes"] / 1e9
    log(f"  (b)-(d) {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def layer_param_bytes(cfg) -> list[int]:
    """Parameter bytes of each profiled layer of ``cfg``: the embedding, each
    block, the head (from its leaves' shapes, on the meta device)."""
    from metis_tpu_torch.models import family_ops

    full = family_ops(cfg).init_params(None, cfg, device="meta")
    nbytes = {g: sum(t.numel() * t.element_size() for t in sub.values())
              for g, sub in full.items()}
    return ([nbytes["embed"]] + [nbytes["blocks"] // cfg.num_blocks] * cfg.num_blocks
            + [nbytes["head"]])


def zero_sp_phase(work: pathlib.Path) -> tuple[dict, dict]:
    """The GPT at ``SHALLOW_BLOCKS`` (1) block of ``QUARTER_WIDTH``, gbs 4,
    3 fresh batches, on two gloo ranks sharing the card, in one job: tp 2
    and dp 2 against one device at that depth and width on the same
    batches, tp 2 with sp against tp 2 without it, and dp 2 at ZeRO 1, 2
    and 3 against dp 2 at ZeRO 0.  Loss gaps, first-step gradient norms
    (each leg's against its reference), each rank's peak memory, and the
    planner's memory relief for the leg (``cost/zero.py`` on the model's
    layer bytes; ``cost/sequence_parallel.py`` prices sp only from a tp
    sweep, which one card cannot profile) beside the measured one."""
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.cost.zero import zero_static_reduction_mb
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.execution.train import param_specs_for
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.testing import run_plans_rank

    spec = dict(GPT_15B, num_layers=SHALLOW_BLOCKS + 2, **QUARTER_WIDTH)
    cfg = config_for_model_spec(ModelSpec(**spec))
    batches = [(t.cpu(), g.cpu()) for t, g in fresh_batches(cfg, 4, 3, SEED + 7)]

    def plan(dp, tp, zero=0, sp=False):
        return PlanArtifact(
            mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp, 1, 1, tp),
            layer_partition=(0, cfg.num_profile_layers),
            strategies=({"dp": dp, "tp": tp, "cp": 1, "ep": 1, "zero": zero,
                         "sp": sp},), gbs=4, microbatches=1).to_json()

    legs = {"tp2": plan(1, 2), "tp2_sp": plan(1, 2, sp=True),
            **{f"dp2_zero{z}": plan(2, 1, zero=z) for z in range(4)}}
    t0 = time.perf_counter()
    exe = build_executable(cfg, PlanArtifact.from_json(plan(1, 1)), device="cuda")
    state, one = exe.init(SEED), []
    for tok, tgt in batches:
        state, loss = exe.step(state, tok.cuda(), tgt.cuda())
        one.append(loss.item())
    del state, exe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  one device, {SHALLOW_BLOCKS} block(s) of hidden {cfg.hidden}: losses "
        f"{[round(x, 5) for x in one]}")
    ranks = on_ranks(run_plans_rank, 2, "gloo", [dict(
        artifact_json=art, cfg=cfg, init=SEED, batches=batches,
        first_grads="norms") for art in legs.values()])
    runs = {name: [r[i] for r in ranks] for i, name in enumerate(legs)}
    specs = param_specs_for(cfg, 2)

    def tp_split(group, name):
        return "tp" in specs[group][name]

    def zero_split(group, name):
        return runs["dp2_zero1"][0]["zero_dims"][(group, name)] is not None

    # the planner's static relief per rank at dp 2, from the model's layer
    # bytes (what a profile of it records)
    per_layer = layer_param_bytes(cfg)
    dtype_bytes = ModelSpec(**spec).dtype_bytes
    peak = {name: max(r["peak_memory_bytes"] for r in rs) / 1e9
            for name, rs in runs.items()}
    out, launches = {"one_device_losses": one}, {}
    for name in ("tp2", "dp2_zero0"):
        out[name] = dist_legs_check(
            f"{name} on two gloo ranks against one device, {SHALLOW_BLOCKS} block(s)",
            runs[name], one, TRAJ_TOL, cfg.num_blocks)
        launches[f"{name}_per_rank"] = launch_sums(runs[name])
    for name, reference in (("tp2_sp", "tp2"), *((f"dp2_zero{z}", "dp2_zero0")
                                                  for z in (1, 2, 3))):
        res = dist_legs_check(f"{name} on two gloo ranks, {SHALLOW_BLOCKS} block(s)",
                              runs[name],
                              runs[reference][0]["losses"], ZERO_SP_TOL,
                              cfg.num_blocks)
        tp = reference == "tp2"
        res.update(grad_norm_check(
            name, runs[name],
            combined_norms(runs[reference], tp_split if tp else lambda g, n: False),
            tp_split if tp else zero_split))
        measured = peak[reference] - peak[name]
        planned = None
        if not tp:
            relief = zero_static_reduction_mb(per_layer, int(name[-1]), 2, tp=1,
                                              dtype_bytes=dtype_bytes)
            planned = sum(relief) * 2**20 / 1e9
        log(f"  {name}: peak per rank {peak[name]:.2f} GB against {reference} "
            f"{peak[reference]:.2f} GB: relief measured {measured:.2f} GB, planner "
            + ("not priced (sp relief needs a tp sweep; one card profiles tp 1)"
               if planned is None else f"{planned:.2f} GB"))
        res.update({"peak_gb": peak[name], "reference": reference,
                    "reference_peak_gb": peak[reference],
                    "relief_measured_gb": measured, "relief_planned_gb": planned})
        out[name] = res
    launches["zero_sp_per_rank"] = launch_sums(runs["dp2_zero3"])
    log(f"  zero_sp legs {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


# the stage_axes phase: multi-stage plans whose stages carry ZeRO, cp or ep,
# each model at 2 blocks of full width (several gloo ranks share the card),
# the MoE at 1: with 2 its stage 1 rank holds a whole block of 8 experts
# (37 GiB in use at its peak on an H100, beside 19.3 on each ep rank of
# stage 0), past the card's 79.2 GiB with the others
STAGE_BLOCKS = 2
MOE_STAGE_BLOCKS = 1
# leg (a)'s GPT: 1 block, stage 0 the embedding and the block, stage 1 the
# head (as the MoE's leg (c)): every stage still carries ZeRO 0-3 over dp 2,
# and the dp all-reduces and gathers move a quarter fewer bytes than at 2
GPT_STAGE_BLOCKS = 1
# the MoE leg's routing groups: one row.  In the preset's groups (the
# largest divisor of the tokens <= 4096) the (3, 1) stage pads to 3 + 3 rows
# and routes in groups of 3072 tokens where the one-stage run routes one of
# 4096, so other tokens pass capacity: a first-step gradient norm read
# 3.1e-2 off on an H100, as the reference's ``moe_ffn`` documents.  Its
# count of differing decisions is still reported
MOE_STAGE_GROUP = 1024


def card_memory_used() -> str:
    """The card's memory in use, as ``nvidia-smi`` reads it (every process)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def stage_launches(blocks: int, head: bool, M: int, ring: int | None = None) -> dict:
    """Launches of each kernel per step on a hetero stage rank of ``blocks``
    blocks and M microbatches: B1 twice per block under stage remat, once
    on the stage that ends in the loss; a cp ring rank at position ``ring``
    runs its self block and ``ring`` past ones of each kernel per block."""
    n = M * blocks * (1 if ring is None else ring + 1)
    return {"fa_fwd": n * (1 if head else 2), "fa_bwd_dq": n, "fa_bwd_dkv": n}


def stage_norm_check(label: str, ranks: list[dict], want: dict, specs: dict) -> dict:
    """Hold a multi-stage leg's first-step gradient norms to ``want`` (the
    one-stage executor's) within ``GRAD_NORM_TOL``: each leaf's norm is the
    root of the sum of squares over the distinct pieces the ranks hold (a
    stage's blocks, a ZeRO chunk or shard, an ep or tp block), replicas and
    cp ranks holding copies."""
    pieces: dict = {}
    for r in ranks:
        slots = r["slots"]
        for group, sub in r["grads"].items():
            for name, norm in sub.items():
                spec = specs[group][name]
                key = (slots["pp"][0],
                       slots["dp"][0] if r.get("zero_dims", {}).get((group, name))
                       is not None else None,
                       slots.get("ep", (0, 1))[0] if "ep" in spec else None,
                       slots["tp"][0] if "tp" in spec else None)
                pieces.setdefault(group, {}).setdefault(name, {})[key] = norm
    got = {g: {n: math.sqrt(sum(x * x for x in held.values()))
               for n, held in sub.items()} for g, sub in pieces.items()}
    return grad_norm_check(label, [{"grads": got}], want, lambda g, n: False)


def planner_stage_mb(work: pathlib.Path, profile_dir, spec: dict, strategies,
                     spans, gbs: int, M: int, mem_coef: float) -> list[float]:
    """The hetero planner's memory demand of each stage (``LayerBalancer.
    stage_memory_demand``: ``mem_coef`` x the stage's profiled layer rows
    at its per-replica microbatch, less the ZeRO, cp and ep relief of its
    strategy), MB; ``spans``: each stage's profiled layers ``[start,
    end)``."""
    from metis_tpu_torch.balance.layers import LayerBalancer
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ModelSpec, SearchConfig
    from metis_tpu_torch.core.types import InterStagePlan
    from metis_tpu_torch.profiles.store import ProfileStore

    store = ProfileStore.from_dir(profile_dir)
    t = store.device_types[0]
    groups = tuple(s.dp * s.cp * s.tp for s in strategies)
    cluster = ClusterSpec.from_files(*write_cluster_files(work, t, 1, sum(groups)))
    plan = InterStagePlan(node_sequence=(t,), device_groups=groups, batches=M,
                          gbs=gbs)
    bal = LayerBalancer(cluster, store, SearchConfig(
        gbs=gbs, max_profiled_tp=1, max_profiled_bs=4, mem_coef=mem_coef),
        ModelSpec(**spec))
    types = [t] * sum(groups)
    return [bal.stage_memory_demand(plan, st, types[:n], types, a, b)
            for st, n, (a, b) in zip(strategies, groups, spans)]


def fitted_mem_coef(profile_dir, layers, bs: int, peak_bytes: int) -> float:
    """The memory coefficient at which the profiled rows of ``layers`` at
    ``bs`` equal a measured one-device peak (as the planner phase fits it)."""
    from metis_tpu_torch.profiles.store import ProfileStore

    store = ProfileStore.from_dir(profile_dir)
    rows = store.get(store.device_types[0], 1, bs).layer_memory_mb
    return math.ceil(peak_bytes / 2**20 / sum(rows[i] for i in layers) * 100) / 100


def stage_axes_phase(work: pathlib.Path, results: dict) -> tuple[dict, dict]:
    """Multi-stage plans whose stages carry ZeRO, context or expert
    parallelism on the hetero route, at full width on gloo ranks sharing
    the card, 3 steps each against the one-stage executor at the same
    depth (run first in this process and freed): (a) the GPT at 1 block,
    stage 0 (the embedding and the block) and stage 1 (the head) at dp 2,
    gbs 4 in one microbatch, at ZeRO 0, 1, 2 and 3 on both; (b) the
    8192-token LLaMA at 2 blocks, stage 0 cp 2 ring against stage 1 cp 2
    Ulysses, then against stage 1 cp 1; (c) the MoE at 1 block, stage 0
    (the embedding and the block) at dp 2 x ep 2 over rows (3, 1), stage 1
    (the head) at dp 1, with the first-block routing decisions that differ
    from the one-stage layout; (d) the best-ranked plan of two stages or
    more with zero or cp of ``hetero --enable-cp --max-cp 2 --enable-zero``
    on 1 x 4 H100 from the context phase's profile, through
    ``PlanArtifact.from_ranked_plan`` and ``build_executable``, and
    ``validate_hetero_choice`` of it (measured and predicted ms, not gated:
    the ranks share one card).  Losses within ``PIPE_TOL``, first-step
    gradient norms within ``GRAD_NORM_TOL``, every rank's launches per step
    as its stage's blocks imply, each rank's peak beside the planner's
    stage demand."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.core.config import ModelSpec, SearchConfig
    from metis_tpu_torch.core.types import Strategy
    from metis_tpu_torch.execution.hetero import StageSpec, stage_specs_from_plan
    from metis_tpu_torch.execution.mesh import ONE_DEVICE, PlanArtifact
    from metis_tpu_torch.execution.train import param_specs_for
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.planner.api import plan_hetero
    from metis_tpu_torch.profiles.store import ProfileStore
    from metis_tpu_torch.testing import moe_routing, run_plans_rank, stage_moe_routing

    L = STAGE_BLOCKS
    gpt = dataclasses.replace(config_for_model_spec(ModelSpec(**GPT_15B)),
                              num_blocks=GPT_STAGE_BLOCKS)
    llama_spec = dict(LLAMA_LONG, num_layers=L + 2)
    llama = config_for_model_spec(ModelSpec(**llama_spec))
    preset = dataclasses.replace(config_for_model_spec(ModelSpec(**MOE_15B)),
                                 num_blocks=MOE_STAGE_BLOCKS)
    # one row per routing group, so that the padded stage layout routes in
    # the one-stage run's groups (module doc, ``MOE_STAGE_GROUP``)
    moe = dataclasses.replace(preset, route_group_size=MOE_STAGE_GROUP)
    host = lambda bs: [(t.cpu(), g.cpu()) for t, g in bs]  # noqa: E731
    data = {"gpt": host(fresh_batches(gpt, 4, 3, SEED + 9)),
            "llama": host(fresh_batches(llama, 1, 3, SEED + 11)),
            "moe": host(fresh_batches(moe, 4, 3, SEED + 13))}
    out, launches = {}, {}

    # the references, one after another in this process
    t0 = time.perf_counter()
    refs = {}
    for name, cfg, M in (("gpt", gpt, 1), ("llama", llama, 1), ("moe", moe, 1)):
        blocks = cfg.num_blocks
        probe = None
        if name == "moe":
            def probe(state):
                """Routing decisions of the (3, 1) stage layout that differ
                from the one-stage run's, in the leg's groups and in the
                preset's."""
                tok, dev = data["moe"][0][0], torch.device("cuda")
                out = {}
                for key, c in (("routing_differ", moe),
                               ("routing_differ_preset_groups", preset)):
                    one = moe_routing(state.params, tok, c, ONE_DEVICE, dev)
                    out[key] = routing_differences(
                        stage_moe_routing(state.params, tok, c, (3, 1), dev),
                        {k: v.reshape(-1, c.top_k) for k, v in one.items()})
                return out
        torch.cuda.reset_peak_memory_stats()
        losses, counts, peak, norms, probed = one_stage(
            cfg, data[name], M, grad_norms=True, probe=probe)
        refs[name] = {"losses": losses, "norms": norms, "peak": peak, "M": M,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
        if probed is not None:
            refs[name].update(probed)
        want = stage_launches(blocks, True, M)
        log(f"  one stage, {name}, {blocks} blocks, M {M}: losses "
            f"{[round(x, 5) for x in losses]}, launches {counts[0]} (expected "
            f"{want}), peak {peak:.2f} GB")
        if (not all(math.isfinite(x) for x in losses)
                or any(c != want for c in counts)):
            raise SystemExit(f"one-stage {name} reference: losses {losses}, "
                             f"launches {counts}")
    log(f"  references {time.perf_counter() - t0:.1f} s")

    # (d) the planner's plan, on the context phase's profile at this depth
    t0 = time.perf_counter()
    prof_dir = work / "profiles_llama_8k"
    store = ProfileStore.from_dir(prof_dir)
    device_type = store.device_types[0]
    mem_coef = fitted_mem_coef(prof_dir, range(L + 2), 1, refs["llama"]["peak_bytes"])
    hostfile, clusterfile = write_cluster_files(work, device_type, 1, 4)
    cluster = ClusterSpec.from_files(hostfile, clusterfile)
    path = work / "stage_axes_hetero.json"
    axes = ["--enable-cp", "--max-cp", "2", "--enable-zero"]
    if cli.main(["hetero", "--hostfile", hostfile, "--clusterfile", clusterfile,
                 "--profile-dir", str(prof_dir), "--model-name", llama_spec["name"],
                 *CONTEXT_CLI, "--gbs", "1", "--max-tp", "1", "--max-bs", "2",
                 "--mem-coef", str(mem_coef), *axes, "--output", str(path)]) != 0:
        raise SystemExit("the stage_axes hetero search failed")
    rows = json.loads(path.read_text())
    log(f"  (d) hetero {' '.join(axes)} on 1 x 4 {device_type} at mem_coef "
        f"{mem_coef}: {len(rows)} plans")
    print_ranking("hetero", rows[:5])
    result = plan_hetero(cluster, store, ModelSpec(**llama_spec), SearchConfig(
        gbs=1, max_profiled_tp=1, max_profiled_bs=2, mem_coef=mem_coef,
        enable_cp=True, max_cp_degree=2, enable_zero=True))
    if not rows or result.best.cost.total_ms != rows[0]["cost_ms"]:
        raise SystemExit("plan_hetero disagrees with the hetero subcommand")
    rank, chosen = next(((i, p) for i, p in enumerate(result.plans, 1)
                         if len(p.intra.strategies) >= 2
                         and any(s.zero or s.cp > 1 for s in p.intra.strategies)),
                        (0, None))
    if chosen is None:
        raise SystemExit("no ranked plan has two stages and zero or cp")
    planned = PlanArtifact.from_ranked_plan(chosen)
    world_d = planned.num_devices
    d_stages = stage_specs_from_plan(planned.layer_partition, planned.strategies, llama)
    log(f"  (d) best plan of two stages or more with zero or cp: #{rank} of "
        f"{len(result.plans)}, {world_d} devices, strategies "
        f"{list(planned.strategies)}, layers {list(planned.layer_partition)}, cost "
        f"{chosen.cost.total_ms:.3f} ms ({time.perf_counter() - t0:.1f} s)")
    out["d_planned"] = {"rank": rank, "plans": len(result.plans),
                        "strategies": list(planned.strategies),
                        "layer_partition": list(planned.layer_partition),
                        "cost_ms": chosen.cost.total_ms, "mem_coef": mem_coef,
                        "cluster": "1 x 4", "search": axes}

    def d_launches(r):
        st = d_stages[r["slots"]["pp"][0]]
        ring = (r["slots"]["sp"][0] if st.cp > 1 and st.cp_mode == "ring"
                else None)
        return stage_launches(st.num_blocks, st.has_head, planned.microbatches, ring)

    # the legs: (label, world, job, reference, launches of a rank's result)
    def stages(*specs):
        return dict(artifact_json=None, stages=specs)

    def gpt_zero(z):
        return stages(StageSpec((0, 1), True, False, dp=2, tp=1, zero=z),
                      StageSpec((1, 1), False, True, dp=2, tp=1, zero=z))

    def head_stage(r):
        """Stage 0 runs the one block, stage 1 (the head) none."""
        return stage_launches(1 - r["slots"]["pp"][0], False, 1)

    def ring_then(second):
        return stages(StageSpec((0, 1), True, False, dp=1, tp=1, cp=2), second)

    def by_stage(*per_stage):
        def expect(r):
            head, M, ring = per_stage[r["slots"]["pp"][0]]
            return stage_launches(1, head, M, r["slots"]["sp"][0] if ring else None)
        return expect

    # (label, ranks, job, family, launches of a rank's result), one job
    # per rank count in this order, the MoE's first (in fresh processes)
    legs = [
        ("c_moe_ep2_rows31", 3, dict(stages(
            StageSpec((0, 1), True, False, dp=2, tp=1, ep=2, replica_rows=(3, 1)),
            StageSpec((1, 1), False, True, dp=1, tp=1)), microbatches=1),
         "moe", head_stage),
        ("b_ring_cp1", 3, dict(ring_then(StageSpec((1, 2), False, True, dp=1, tp=1)),
                               microbatches=1),
         "llama", by_stage((False, 1, True), (True, 1, False))),
        *((f"a_zero{z}", 4, dict(gpt_zero(z), microbatches=1), "gpt", head_stage)
          for z in range(4)),
        ("b_ring_a2a", 4, dict(ring_then(StageSpec(
            (1, 2), False, True, dp=1, tp=1, cp=2, cp_mode="a2a")), microbatches=1),
         "llama", by_stage((False, 1, True), (True, 1, False))),
        ("d_planned", world_d, dict(artifact_json=planned.to_json()), "llama",
         d_launches),
    ]
    cfgs = {"gpt": gpt, "llama": llama, "moe": moe}
    runs = {}
    for world in dict.fromkeys(w for _, w, *_ in legs):
        mine = [leg for leg in legs if leg[1] == world]
        t0 = time.perf_counter()
        log(f"  {world} gloo ranks, {[leg[0] for leg in mine]}; card memory in use "
            f"{card_memory_used()}, this process reserving "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")
        ranks = on_ranks(run_plans_rank, world, "gloo", [
            dict(job, cfg=cfgs[fam], init=SEED, batches=data[fam],
                 first_grads="norms") for _, _, job, fam, _ in mine])
        log(f"  {world} gloo ranks, {len(mine)} plans: {time.perf_counter() - t0:.1f} s")
        for i, leg in enumerate(mine):
            runs[leg[0]] = [r[i] for r in ranks]

    # each rank's peak beside the planner's stage demand
    gpt_dir = results["slice"]["profile_dir"]
    # the 10-layer profile's rows of this 1-block model: embed, block, head
    gpt_spans = [(0, 2), (GPT_15B["num_layers"] - 1, GPT_15B["num_layers"])]
    gpt_coef = fitted_mem_coef(gpt_dir, [0, 1, *range(*gpt_spans[1])], 4,
                               refs["gpt"]["peak_bytes"])
    moe_dir = work / f"profiles_{MOE_15B['name']}"
    # the 2-block profile's rows of this 1-block model: embed, block, head
    moe_coef = fitted_mem_coef(moe_dir, (0, 1, 3), 4, refs["moe"]["peak_bytes"])
    halves = [(0, 2), (2, 4)]
    demands = {
        **{f"a_zero{z}": planner_stage_mb(
            work, gpt_dir, GPT_15B, [Strategy(dp=2, tp=1, zero=z)] * 2, gpt_spans,
            4, 1, gpt_coef) for z in range(4)},
        "b_ring_a2a": planner_stage_mb(
            work, prof_dir, llama_spec, [Strategy(dp=1, tp=1, cp=2),
                                         Strategy(dp=1, tp=1, cp=2, cp_mode="a2a")],
            halves, 1, 1, mem_coef),
        "b_ring_cp1": planner_stage_mb(
            work, prof_dir, llama_spec, [Strategy(dp=1, tp=1, cp=2),
                                         Strategy(dp=1, tp=1)], halves, 1, 1, mem_coef),
        "c_moe_ep2_rows31": planner_stage_mb(
            work, moe_dir, MOE_15B, [Strategy(dp=2, tp=1, ep=2), Strategy(dp=1, tp=1)],
            [(0, 2), (3, 4)], 4, 1, moe_coef),
    }
    coefs = {"a": gpt_coef, "b": mem_coef, "c": moe_coef}

    for label, _, _, fam, expect in legs:
        ranks = runs[label]
        ref = refs[fam]
        res = pipeline_legs_check(f"({label[0]}) {label[2:]}", ranks, "hetero",
                                  ref["losses"], PIPE_TOL,
                                  [expect(r) for r in ranks])
        res.update(stage_norm_check(f"({label[0]}) {label[2:]}", ranks, ref["norms"],
                                    param_specs_for(cfgs[fam], 1)))
        if label in demands:
            res["planner_stage_mb"] = demands[label]
            res["mem_coef"] = coefs[label[0]]
            log(f"    peaks {[round(p, 2) for p in res['peak_memory_gb']]} GB "
                f"beside the planner's stage demand "
                f"{[round(x * 2**20 / 1e9, 2) for x in demands[label]]} GB at "
                f"mem_coef {coefs[label[0]]}")
        res["reference_losses"] = ref["losses"]
        out[label] = {**out.get(label, {}), **res}
        launches[f"stage_axes_{label}_per_rank"] = launch_sums(ranks)
    zero0 = runs["a_zero0"][0]["losses"]
    out["a_bitwise_equal_to_zero0"] = {
        f"zero{z}": runs[f"a_zero{z}"][0]["losses"] == zero0 for z in (1, 2, 3)}
    for key in ("routing_differ", "routing_differ_preset_groups"):
        out["c_moe_ep2_rows31"][key] = refs["moe"][key]
    log(f"  (a) losses equal to ZeRO 0's bit for bit: {out['a_bitwise_equal_to_zero0']}")
    log(f"  (c) first-block routing decisions of the (3, 1) stage layout differing "
        f"from the one-stage run's, in groups of {MOE_STAGE_GROUP} tokens: "
        f"{refs['moe']['routing_differ']}; in the preset's groups of "
        f"{preset.route_group_size}: {refs['moe']['routing_differ_preset_groups']}")

    # (d) measured through validate_hetero_choice, the ranks sharing the card
    from metis_tpu_torch.validation import validate_hetero_choice

    t0 = time.perf_counter()
    (report,) = validate_hetero_choice(
        [chosen], ModelSpec(**llama_spec), device="cuda",
        devices=["cuda:0"] * world_d, cluster=cluster, profiles=store, top_k=1,
        steps=1, warmup=0, backend="gloo", pool=POOLS.get((world_d, "gloo")))
    out["d_planned"].update(
        measured_ms=report.measured_ms, predicted_ms=report.predicted_ms,
        error_pct=report.error_pct, stage_memory_mb=report.stage_memory_mb,
        peak_memory_mb=report.peak_memory_mb, note=SHARED_CARD)
    log(f"  (d) validate_hetero_choice: measured {report.measured_ms:.3f} ms, "
        f"predicted {report.predicted_ms:.3f} ms, error_pct {report.error_pct:.2f} "
        f"({SHARED_CARD}); peaks {[round(p) for p in report.peak_memory_mb]} MB "
        f"beside the planner's stage demand "
        f"{[round(x) for x in report.stage_memory_mb]} MB "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (math.isfinite(report.measured_ms) and report.measured_ms > 0):
        raise SystemExit(f"(d) measured {report.measured_ms} ms")
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


# the train phase: leg (a)'s GPT depth (the 1.5B preset's widths), the
# multi-rank legs' (c) and the MoE legs' (b).  (a)'s four checkpoints of
# 7.50 GB write 30 GB; to keep the phase's writes near 40 GB, (c)'s six
# run a quarter of the preset's hidden width (``TRAIN_C_WIDTH``: 8 heads of
# 128, its vocabulary and sequence), and each leg deletes its checkpoints
# once they are compared
TRAIN_BLOCKS = 1
TRAIN_GBS = 4
TRAIN_C_WIDTH = ["--hidden-size", str(QUARTER_WIDTH["hidden_size"]),
                 "--num-heads", str(QUARTER_WIDTH["num_heads"])]


def train_cli(args: list[str], label: str, work: pathlib.Path,
              own_process: bool) -> tuple[dict, list]:
    """``python -m metis_tpu_torch train`` in a process of its own, or its
    ``main`` in this one: its summary JSON and its events."""
    from metis_tpu_torch import cli

    events, summary = work / f"{label}.events.jsonl", work / f"{label}.json"
    args = ["train", *args, "--events", str(events), "--output", str(summary)]
    t0 = time.perf_counter()
    if own_process:
        proc = subprocess.run([sys.executable, "-m", "metis_tpu_torch", *args],
                              capture_output=True, text=True,
                              cwd=pathlib.Path(__file__).resolve().parent)
        for line in proc.stderr.strip().splitlines()[-6:]:
            log(f"    {label}: {line}")
        rc = proc.returncode
    else:
        rc = cli.main(args)
        gc.collect()
        torch.cuda.empty_cache()
    if rc != 0:
        raise SystemExit(f"train {label} failed (rc {rc})")
    log(f"    {label}: {time.perf_counter() - t0:.1f} s")
    return (json.loads(summary.read_text()),
            [json.loads(line) for line in events.read_text().splitlines()])


def step_losses(events: list) -> dict:
    return {e["step"]: e["loss"] for e in events if e["event"] == "train_step"}


def dir_gb(path: pathlib.Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e9


def resume_check(label: str, resumed: pathlib.Path, straight: pathlib.Path,
                 losses: dict, straight_losses: dict) -> dict:
    """Gate: the resumed run's losses and every leaf's digest bit-equal to
    the straight run's at the last step."""
    from metis_tpu_torch.execution.checkpoint import load_meta

    got, want = load_meta(resumed), load_meta(straight)
    equal_losses = all(losses[k] == straight_losses[k] for k in losses)
    differ = sorted(k for k in want.digests if got.digests.get(k) != want.digests[k])
    log(f"  {label}: step {got.step} vs {want.step}; losses {losses} against "
        f"{ {k: straight_losses[k] for k in losses} }: "
        f"{'bit-equal' if equal_losses else 'DIFFER'}; digests of "
        f"{len(want.digests)} leaves, {len(differ)} differ")
    if got.step != want.step or not equal_losses or differ or not want.digests:
        raise SystemExit(f"{label}: the resumed run is not bit-equal to the "
                         f"straight run ({differ[:3]})")
    return {"step": got.step, "losses_bit_equal": True,
            "leaves_bit_equal": len(want.digests)}


def train_phase(work: pathlib.Path, results: dict) -> tuple[dict, dict]:
    """``train``: (a) the 1.5B GPT's widths at ``TRAIN_BLOCKS`` blocks through
    ``python -m metis_tpu_torch train --device cuda`` on a one-card
    hostfile (planned from a profile at that depth): 3 steps with
    ``--checkpoint-every 2``, 2 more resumed, 5 straight; the resumed run's
    losses and every leaf's digest bit-equal to the straight run's at step
    5, save / restore ms, ``mean_step_ms`` beside ``plan_cost_ms``, the
    launches of each step.  (b) The MoE (``MOE_15B`` at 1 block of
    ``QUARTER_WIDTH``, the preset's 4096-token routing groups: gbs 4 x
    1024 tokens is one group) on two gloo ranks sharing the card, each
    rank holding part of the group: tp 2 + sp, dp 2, cp 2 ring and cp 2
    Ulysses, 3 steps each against one device at that depth and width
    (losses within ``PIPE_TOL``, first-step gradient norms within
    ``GRAD_NORM_TOL``), with the first-block routing decisions that differ
    from the one device's and the router ties.
    (c) ``train``'s rank body on plans pinned in the checkpoint
    directories, two gloo ranks sharing the card (one job for the six
    runs, ``train_leg_c``, beside (b)'s), 1 block at ``TRAIN_C_WIDTH``: dp
    2 at ZeRO 1 (gspmd) and a two-stage hetero plan, 2 steps with a
    checkpoint, 2 resumed, 4 straight, gated as (a)."""
    from concurrent.futures import ThreadPoolExecutor

    out, launches = {}, {}
    base = train_files(work, results["planner"]["mem_coef"])
    out["base"] = base  # the chaos phase plans on the same files
    out["a_gpt"], launches["train_a"] = train_leg_a(work, base)
    # (c)'s launch runs beside (b)'s: both are gloo ranks sharing the card,
    # whose times are no speed (and the host's gloo, not the card, bounds
    # them); (a)'s times are measured alone
    with ThreadPoolExecutor(1) as pool:
        leg_c = pool.submit(train_leg_c, work, base)
        legs = [train_leg_b(), leg_c.result()]
    for more_out, more_launches in legs:
        out.update(more_out)
        launches.update(more_launches)
    return out, launches


def train_files(work: pathlib.Path, mem_coef: float) -> list[str]:
    """The train legs' profile of the GPT at ``TRAIN_BLOCKS`` blocks (bs
    ``TRAIN_GBS``), a one-card hostfile and clusterfile, and the
    ``train`` arguments that plan on them."""
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.profiles.profiler import profile_model

    spec = dict(GPT_15B, num_layers=TRAIN_BLOCKS + 2)
    prof_dir = work / "profiles_train"
    store = profile_model(ModelSpec(**spec), bss=(TRAIN_GBS,), device="cuda")
    store.dump_to_dir(prof_dir, {"model_name": spec["name"], "attn": "flash"})
    hostfile, clusterfile = write_cluster_files(work, store.device_types[0], 1, 1)
    gc.collect()
    torch.cuda.empty_cache()
    return ["--device", "cuda", "--hostfile", hostfile, "--clusterfile", clusterfile,
            "--profile-dir", str(prof_dir), "--model-name", spec["name"],
            *CLI_MODEL["gpt-1.5B"], "--num-layers", str(TRAIN_BLOCKS + 2),
            "--gbs", str(TRAIN_GBS), "--max-tp", "1", "--max-bs", str(TRAIN_GBS),
            "--mem-coef", str(mem_coef)]


def train_leg_a(work: pathlib.Path, base: list[str]) -> tuple[dict, dict]:
    """Leg (a) of the train phase (``train_phase``); its readings and its
    launches."""
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.models import config_for_model_spec

    t0 = time.perf_counter()
    spec = dict(GPT_15B, num_layers=TRAIN_BLOCKS + 2)
    cfg = config_for_model_spec(ModelSpec(**spec))
    h, f, v = cfg.hidden, cfg.ffn_dim, cfg.vocab_size
    params = (2 * v * h + cfg.seq_len * h + 2 * h
              + TRAIN_BLOCKS * (4 * h * h + 2 * h * f + 9 * h + f))
    log(f"  (a) {TRAIN_BLOCKS} block(s) of the 1.5B widths: {params / 1e9:.3f} B "
        f"parameters, {params * 12 / 1e9:.2f} GB of fp32 parameters and AdamW "
        "moments per checkpoint")
    ckpt, straight = work / "ckpt_a", work / "ckpt_a_straight"
    # the first run as a user starts it; the others through the same main
    # in this process (a process start costs ~10 s of the phase)
    first, ev1 = train_cli([*base, "--steps", "3", "--checkpoint-every", "2",
                            "--checkpoint-dir", str(ckpt)], "a_first3", work, True)
    gb_first = dir_gb(ckpt)
    second, ev2 = train_cli([*base, "--steps", "2", "--checkpoint-dir", str(ckpt)],
                            "a_resume2", work, False)
    third, ev3 = train_cli([*base, "--steps", "5", "--checkpoint-dir", str(straight)],
                           "a_straight5", work, False)
    straight_losses = step_losses(ev3)
    res = resume_check("(a)", ckpt, straight, {**step_losses(ev1), **step_losses(ev2)},
                       straight_losses)
    shutil.rmtree(ckpt)
    shutil.rmtree(straight)
    saves = [e for ev in (ev1, ev2, ev3) for e in ev if e["event"] == "checkpoint_save"]
    restore = [e["ms"] for e in ev2 if e["event"] == "checkpoint_restore"]
    flush = [e["ms"] for e in ev1 if e["event"] == "checkpoint_flush"]
    per_step = [e.get("kernel_launches", {}) for ev in (ev1, ev2, ev3) for e in ev
                if e["event"] == "train_step"]
    expect = dict.fromkeys(("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"), TRAIN_BLOCKS)
    if any(step != expect for step in per_step):
        raise SystemExit(f"(a) launches per step {per_step}, expected {expect}")
    launches = {k: sum(step[k] for step in per_step) for k in expect}
    res.update({
        "blocks": TRAIN_BLOCKS, "params": params,
        "checkpoint_gb_on_disk": gb_first,
        "gb_written": gb_first * len(saves),
        "saves": [{k: e[k] for k in ("step", "mode", "ms")} for e in saves],
        "async_flush_ms": flush, "restore_ms": restore,
        "plan_cost_ms": first["plan_cost_ms"],
        "mean_step_ms": [first["mean_step_ms"], second["mean_step_ms"],
                         third["mean_step_ms"]],
        # the straight run's steps after its first: no save between them
        "warm_step_ms": statistics.median(
            e["step_ms"] for e in ev3 if e["event"] == "train_step" and e["step"] > 1),
        "launches_per_step": expect, "losses": straight_losses})
    log(f"  (a) {gb_first:.2f} GB per checkpoint on disk, {len(saves)} saves: "
        f"{[(e['step'], e['mode'], round(e['ms'], 1)) for e in saves]} ms, async "
        f"flush {[round(x, 1) for x in flush]} ms, restore "
        f"{[round(x, 1) for x in restore]} ms; mean_step_ms "
        f"{res['mean_step_ms']} (warm step {res['warm_step_ms']:.3f}) beside "
        f"plan_cost_ms {first['plan_cost_ms']:.3f}; "
        f"launches per step {expect} ({time.perf_counter() - t0:.1f} s)")
    return res, launches


def train_leg_b() -> tuple[dict, dict]:
    """Leg (b) of the train phase (``train_phase``): the MoE in shared
    routing groups; its readings and its launches per rank."""
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.core.types import UniformPlan
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.execution.train import param_specs_for
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.testing import (
        capture_first_grads,
        forward_routing,
        run_plans_rank,
    )

    out, launches = {}, {}
    t0 = time.perf_counter()
    mcfg = config_for_model_spec(ModelSpec(**dict(MOE_15B, num_layers=3, **QUARTER_WIDTH)))
    batches = [(t.cpu(), g.cpu()) for t, g in fresh_batches(mcfg, TRAIN_GBS, 3, SEED + 5)]
    one = build_executable(mcfg, PlanArtifact.from_uniform_plan(
        UniformPlan(1, 1, 1, TRAIN_GBS, TRAIN_GBS)), device="cuda")
    state = one.init(SEED)
    want_routing = forward_routing(one, state, batches[0][0].cuda())
    want_norms = capture_first_grads(state, "norms")
    ref = []
    for tok, tgt in batches:
        state, loss = one.step(state, tok.cuda(), tgt.cuda())
        ref.append(loss.item())
    del state, one
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (b) one device, 1 MoE block of hidden {mcfg.hidden}, gbs {TRAIN_GBS}: losses "
        f"{[round(x, 5) for x in ref]}; router ties {want_routing['ties']} of "
        f"{want_routing['expert_idx'].shape[1]} tokens")

    def moe_plan(dp=1, tp=1, cp=1, sp=False, mode="ring"):
        return PlanArtifact(
            mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp, 1, cp, tp),
            layer_partition=(0, 3),
            strategies=({"dp": dp, "tp": tp, "cp": cp, "ep": 1, "zero": 0,
                         "sp": sp, "cp_mode": mode},),
            gbs=TRAIN_GBS, microbatches=1).to_json()

    legs = (("tp2_sp", moe_plan(tp=2, sp=True)), ("dp2", moe_plan(dp=2)),
            ("cp2_ring", moe_plan(cp=2)), ("cp2_a2a", moe_plan(cp=2, mode="a2a")))
    ranks = on_ranks(run_plans_rank, 2, "gloo", [dict(
        artifact_json=art, cfg=mcfg, init=SEED, batches=batches,
        routing_tokens=batches[0][0], first_grads="norms") for _, art in legs])
    specs = param_specs_for(mcfg, 2)
    for i, (name, _) in enumerate(legs):
        leg = [r[i] for r in ranks]
        expect = ((lambda r: ring_launches(r["slots"]["sp"][0], 1))
                  if name == "cp2_ring" else 1)
        res = dist_legs_check(f"(b) MoE {name} on two gloo ranks, 1 block, the "
                              "4096-token group shared", leg, ref, PIPE_TOL, expect)
        res.update(grad_norm_check(
            f"(b) {name}", leg, want_norms,
            lambda g, n: name == "tp2_sp" and "tp" in specs[g][n]))
        res["routing"] = [routing_differences(r["routing"], want_routing) for r in leg]
        res["routing_shared"] = [r["routing"]["shared"] for r in leg]
        res["router_ties"] = want_routing["ties"]
        log(f"    routing decisions differing from one device, per rank: "
            f"{res['routing']} (shared groups {res['routing_shared']})")
        out[f"b_moe_{name}"] = res
        launches[f"train_b_{name}_per_rank"] = launch_sums(leg)
    log(f"  (b) {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def train_leg_c(work: pathlib.Path, base: list[str]) -> tuple[dict, dict]:
    """Leg (c) of the train phase (``train_phase``): multi-rank resume on
    plans pinned in the checkpoint directories.  Five of the six runs are
    the ``train`` subcommand's jobs (``cli.train_job``) run by its rank body
    in one job of the two-rank pool (``testing.train_ranks``).  The dp 2 plan's resumed run is ``python -m
    metis_tpu_torch train --devices cuda:0,cuda:0 --dist-backend gloo``, the
    launcher a user calls, after that launch.  Its readings, and rank 0's
    launches (its events)."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.execution.mesh import PlanArtifact
    from metis_tpu_torch.testing import train_ranks

    t0 = time.perf_counter()
    pinned = {
        "c_dp2_zero1": PlanArtifact(
            mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, 2, 1, 1, 1),
            layer_partition=(0, TRAIN_BLOCKS + 2),
            strategies=({"dp": 2, "tp": 1, "cp": 1, "ep": 1, "zero": 1,
                         "sp": False},), gbs=TRAIN_GBS, microbatches=1),
        "c_hetero_two_stage": PlanArtifact(
            mesh_axes=(), mesh_shape=(), layer_partition=(0, 2, TRAIN_BLOCKS + 2),
            strategies=({"dp": 1, "tp": 1}, {"dp": 1, "tp": 1}), gbs=TRAIN_GBS,
            microbatches=2),
    }
    runs = (("first2", "resumed", 2), ("resume2", "resumed", 2),
            ("straight4", "straight", 4))
    launcher = ("c_dp2_zero1", "resume2")
    keys, jobs = [], []
    for name, art in pinned.items():
        for run in ("resumed", "straight"):
            path = work / f"{name}_{run}"
            path.mkdir()
            (path / "plan.json").write_text(art.to_json())
        for label, run, steps in runs:
            if (name, label) == launcher:
                continue
            keys.append((name, label))
            jobs.append(cli.train_job([
                *base, *TRAIN_C_WIDTH, "--steps", str(steps),
                "--checkpoint-dir", str(work / f"{name}_{run}"),
                "--events", str(work / f"{name}_{label}.events.jsonl")]))
    results = [r for r in on_ranks(train_ranks, 2, "gloo", jobs)]
    if any(run["rc"] != 0 for rank in results for run in rank):
        raise SystemExit(f"(c) a train run failed: {[r['rc'] for r in results[0]]}")
    summaries = {key: run["summary"] for key, run in zip(keys, results[0])}
    summaries[launcher], _ = train_cli(
        [*base, *TRAIN_C_WIDTH, "--steps", "2", "--checkpoint-dir",
         str(work / f"{launcher[0]}_resumed"), "--devices", "cuda:0,cuda:0",
         "--dist-backend", "gloo"], "_".join(launcher), work, True)
    out, launches = {}, {}
    for name in pinned:
        ev = {label: [json.loads(x) for x in (work / f"{name}_{label}.events.jsonl")
                      .read_text().splitlines()] for label, _, _ in runs}
        dirs = {run: work / f"{name}_{run}" for run in ("resumed", "straight")}
        res = resume_check(f"({name})", dirs["resumed"], dirs["straight"],
                           {**step_losses(ev["first2"]), **step_losses(ev["resume2"])},
                           step_losses(ev["straight4"]))
        res["checkpoint_gb_on_disk"] = dir_gb(dirs["straight"])
        for path in dirs.values():
            shutil.rmtree(path)
        res["executable"] = summaries[name, "first2"]["executable"]
        res["resumed_by"] = ("python -m metis_tpu_torch train --devices cuda:0,cuda:0 "
                             "--dist-backend gloo" if name == launcher[0]
                             else "cli.train_job in testing.train_ranks")
        res["saves"] = [{k: e[k] for k in ("step", "mode", "ms")} for events in ev.values()
                        for e in events if e["event"] == "checkpoint_save"]
        res["restore_ms"] = [e["ms"] for e in ev["resume2"]
                             if e["event"] == "checkpoint_restore"]
        steps = [e.get("kernel_launches", {}) for events in ev.values()
                 for e in events if e["event"] == "train_step"]
        res["rank0_launches_per_step"] = steps[0]
        launches[name + "_rank0"] = {k: sum(step.get(k, 0) for step in steps)
                                     for k in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv")}
        if any(step != steps[0] or not all(step.values()) for step in steps):
            raise SystemExit(f"({name}) rank 0's launches per step {steps}")
        log(f"  ({name}) {res['executable']}: {res['checkpoint_gb_on_disk']:.2f} GB per "
            f"checkpoint, saves {res['saves']}, restore {res['restore_ms']} ms "
            f"({SHARED_CARD})")
        out[name] = res
    log(f"  (c) {time.perf_counter() - t0:.1f} s")
    return out, launches


# the reshard phase: (a)'s pinned plan, and (b)'s plans at TRAIN_C_WIDTH:
# dp 2 at ZeRO 1, then tp 2, then one device
def pinned_plan(dp: int = 1, tp: int = 1, zero: int = 0):
    from metis_tpu_torch.execution.mesh import PlanArtifact

    return PlanArtifact(
        mesh_axes=("pp", "dp", "ep", "sp", "tp"), mesh_shape=(1, dp, 1, 1, tp),
        layer_partition=(0, TRAIN_BLOCKS + 2),
        strategies=({"dp": dp, "tp": tp, "cp": 1, "ep": 1, "zero": zero,
                     "sp": False},), gbs=TRAIN_GBS, microbatches=1)


def hardlink_copy(src: pathlib.Path, dst: pathlib.Path) -> None:
    """A copy of a checkpoint directory that shares its files (a save
    writes new files and renames directories, so neither copy changes the
    other's files)."""
    shutil.copytree(src, dst, copy_function=lambda a, b: pathlib.Path(b).hardlink_to(a))


def reshard_phase(work: pathlib.Path, results: dict) -> tuple[dict, dict]:
    """``reshard``: at ``TRAIN_C_WIDTH``, one job of two gloo ranks
    (``testing.live_reshard_rank``): dp 2 + ZeRO 1, 2 steps, resharded
    live onto tp 2 and a step taken, then tp 2 onto one device (rank 1
    only sends) and a step: each verified, each step bit-equal (loss and
    one-device digests) to the same step after a checkpoint restore onto
    the same plan; the ``ReshardReport`` beside ``price_migration_ms`` at
    100 GB/s and the save + restore ms.  The restore onto another plan
    runs in the chaos phase, on chaos (a)'s step-4 checkpoint
    (``replan_leg``)."""
    # the train phase deletes its checkpoints once compared; anything left
    # of them would crowd the machine's disk
    for path in work.glob("*ckpt*"):
        shutil.rmtree(path, ignore_errors=True)
    return reshard_leg_b(work)


def replan_leg(work: pathlib.Path, base: list[str],
               chaos_a: dict) -> tuple[dict, dict]:
    """The restore onto another plan of chaos (a)'s step-4 dp 2 + ZeRO 1
    checkpoint (``chaos_leg_a`` leaves it in three hard-linked copies, with
    that run's losses and saves): ``train --replan-on-resume`` on the
    one-card cluster for 2 steps, resharded onto one device at step 4
    (the data stream from batch 4, steps 5 and 6); its state's one-device
    digests equal to the checkpoint's assembled ones (the same restore in
    this process); its losses within ``TRAJ_TOL`` of the dp 2 plan
    continued from the same checkpoint on the same batches (on two gloo
    ranks, beside that restore) and bit-equal to chaos (a)'s steps 5-6;
    the cross-mesh restore's ms and the GB it reads.  Its readings and
    its launches."""
    from concurrent.futures import ThreadPoolExecutor

    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.data.pipeline import make_input_pipeline, synthetic_run_dataset
    from metis_tpu_torch.execution import checkpoint as ckpt
    from metis_tpu_torch.execution import reshard
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.testing import elastic_rank

    out, launches = {}, {}
    t0 = time.perf_counter()
    cont, at4 = chaos_a["cont"], chaos_a["at4"]
    spec = dict(GPT_15B, num_layers=TRAIN_BLOCKS + 2, **QUARTER_WIDTH)
    cfg = config_for_model_spec(ModelSpec(**spec))
    stream = make_input_pipeline(synthetic_run_dataset(
        cfg.vocab_size, TRAIN_GBS, cfg.seq_len), TRAIN_GBS, device="cpu",
        skip_batches=4)
    batches = [next(stream) for _ in range(2)]
    stream.close()
    # beside one another, none timed: dp 2's own continuation from the
    # same checkpoint (restored onto its plan and trained on the data
    # stream's batches 4 and 5, ``testing.elastic_rank``), the replanned
    # run, and after it the same restore in this process, whose state's
    # one-device digests are held to the checkpoint's assembled ones
    with ThreadPoolExecutor(1) as pool:
        cont_run = pool.submit(on_ranks, elastic_rank, 2, "gloo", [
            dict(cfg=cfg, artifact=pinned_plan(dp=2, zero=1).to_json(),
                 init=SEED + 1, restore=str(cont), batches=batches, digests=False)])
        summary, ev2 = train_cli([*base, *TRAIN_C_WIDTH, "--steps", "2",
                                  "--checkpoint-dir", str(chaos_a["replan"]),
                                  "--replan-on-resume"], "replan2", work, True)
        shutil.rmtree(chaos_a["replan"])
        chaos_steps = {k: chaos_a["losses"][k] for k in (5, 6)}
        if any(chaos_steps[k] != step_losses(ev2).get(k) for k in chaos_steps):
            raise SystemExit(f"chaos (a): steps 5-6 {chaos_steps} against the "
                             f"replanned restore's {step_losses(ev2)}")
        restore = [e for e in ev2 if e["event"] == "checkpoint_restore"]
        steps = sorted(step_losses(ev2))
        if (summary["executable"] != "single_device" or len(restore) != 1
                or restore[0]["step"] != 4 or not restore[0]["resharded"]
                or steps != [5, 6]):
            raise SystemExit(f"the replanned run: {summary['executable']}, restore "
                             f"{restore}, steps {steps}")
        one = build_executable(cfg, pinned_plan(), "cuda")
        state = ckpt.restore_checkpoint(at4, one.init(SEED + 1))
        got = reshard.logical_digests(state)
        del state, one
        gc.collect()
        torch.cuda.empty_cache()
        want = ckpt.logical_digests(at4)
        cont_res = cont_run.result()[0][0]
    differ = sorted(k for k in want if got.get(k) != want[k])
    if differ or set(got) != set(want) or len(want) < 3:
        raise SystemExit(f"the restored one-device digests differ: {differ[:3]}")
    if cont_res["step"] != 4:
        raise SystemExit(f"dp 2's continuation restored step {cont_res['step']}")
    replan_losses, dp2_losses = step_losses(ev2), dict(zip((5, 6), cont_res["losses"]))
    gap = max(abs(replan_losses[k] - dp2_losses[k]) for k in (5, 6))
    if gap > TRAJ_TOL or not all(math.isfinite(x) for x in replan_losses.values()):
        raise SystemExit(f"resumed on one device {replan_losses} against dp 2 "
                         f"{dp2_losses}: gap {gap:.3e} (tol {TRAJ_TOL:g})")
    launches["replan"] = chaos_launches("replanned", ev2)
    out["replan"] = {
        "checkpoint_gb_on_disk": chaos_a["gb"], "save_ms": chaos_a["save_ms"],
        "restore_ms": restore[0]["ms"], "restore_gb_read": restore[0]["bytes_read"] / 1e9,
        "leaves_digest_equal": len(want),
        "step": restore[0]["step"], "steps": steps, "losses_one_device": replan_losses,
        "losses_dp2": dp2_losses, "largest_gap": gap,
        "plan_cost_ms": summary["plan_cost_ms"],
        "chaos_a_steps_5_6_bit_equal": True,
        "launches_per_step": dict.fromkeys(FLASH_KERNELS, TRAIN_BLOCKS)}
    log(f"  replan: dp 2 + ZeRO 1 -> one device at step 4 (chaos (a)'s checkpoint): "
        f"{chaos_a['gb']:.2f} GB on disk, saves {chaos_a['save_ms']} ms, "
        f"cross-mesh restore {restore[0]['ms']:.1f} ms "
        f"reading {restore[0]['bytes_read'] / 1e9:.2f} GB; {len(want)} one-device "
        f"digests equal; steps {steps} losses {replan_losses} against dp 2's "
        f"{dp2_losses}: gap {gap:.3e} (tol {TRAJ_TOL:g}); chaos (a)'s steps 5-6 "
        f"bit-equal to them ({time.perf_counter() - t0:.1f} s)")
    for path in (cont, at4):
        shutil.rmtree(path)
    return out, launches


def reshard_leg_b(work: pathlib.Path) -> tuple[dict, dict]:
    """Leg (b) of the reshard phase (``reshard_phase``), live at a quarter
    of the width; its readings and its launches per rank."""
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.cost.volume import TransformerVolume
    from metis_tpu_torch.execution import reshard
    from metis_tpu_torch.models import config_for_model_spec
    from metis_tpu_torch.testing import live_reshard_rank

    out, launches = {}, {}
    t0 = time.perf_counter()
    qspec = dict(GPT_15B, num_layers=TRAIN_BLOCKS + 2, **QUARTER_WIDTH)
    qcfg = config_for_model_spec(ModelSpec(**qspec))
    batches = [(t.cpu(), g.cpu()) for t, g in fresh_batches(qcfg, TRAIN_GBS, 3, SEED + 7)]
    plans = [pinned_plan(dp=2, zero=1), pinned_plan(tp=2), pinned_plan()]
    (work / "reshard_b").mkdir()
    ranks = on_ranks(live_reshard_rank, 2, "gloo", qcfg, batches,
                        [p.to_json() for p in plans], str(work / "reshard_b"))
    shutil.rmtree(work / "reshard_b")
    volume = TransformerVolume(ModelSpec(**qspec), tuple(layer_param_bytes(qcfg)))
    names = ("dp2_zero1_to_tp2", "tp2_to_one")
    for i, name in enumerate(names):
        legs = [r["legs"][i] for r in ranks]
        rep = legs[0]["report"]
        losses = legs[0]["losses"]
        old, new = (reshard.stage_layout(plans[i], qcfg.num_profile_layers),
                    reshard.stage_layout(plans[i + 1], qcfg.num_profile_layers))
        price = reshard.price_migration_ms(old, new, volume, 100.0)
        equal = (losses[0] == losses[1]
                 and all(l["digests"][0] == l["digests"][1] for l in legs))
        log(f"  (b) {name}: {rep}; priced {price:.3f} ms at 100 GB/s against "
            f"stall {rep.stall_ms:.1f} ms; checkpoint save "
            f"{max(l['save_ms'] for l in legs):.1f} + restore "
            f"{max(l['restore_ms'] for l in legs):.1f} ms; the step after it "
            f"{losses[0]!r}, after the restore {losses[1]!r}: "
            f"{'bit-equal' if equal else 'DIFFER'} ({SHARED_CARD})")
        if not rep.verified or not equal or len(legs[0]["digests"][0]) < 3:
            raise SystemExit(f"(b) {name}: the live reshard's step is not the "
                             "restored one's")
        launches[f"reshard_b_{name}_per_rank"] = launch_sums(
            [{"launches": [l["launches"]]} for l in legs])
        out[f"b_{name}"] = {
            "leaves": rep.leaves, "moved": rep.moved, "moved_bytes": rep.moved_bytes,
            "stall_ms": rep.stall_ms, "phases_ms": rep.phases_ms,
            "verified": rep.verified, "price_migration_ms_100gbps": price,
            "save_ms": [l["save_ms"] for l in legs],
            "restore_ms": [l["restore_ms"] for l in legs],
            "losses_bit_equal": True, "launches_rank0": legs[0]["launches"]}
    log(f"  (b) {time.perf_counter() - t0:.1f} s")
    return out, launches


# the chaos phase: the supervisor's CLI at the train phase's depth and
# ``TRAIN_C_WIDTH``; (a) on a cluster of two one-card nodes (losing the last
# node leaves one card).  At the 1.5B preset's widths (a) and its replanned
# restore moved 5.00 GB through the host in the live reshard and 7.50 GB
# per restore, none of which their gates need
CHAOS_STEPS = 6
CHAOS_A_SCRIPT = "checkpoint_write@2x2,device_loss@4"
CHAOS_B_SCRIPT = "device_loss@4,reshard_verify@4"
FLASH_KERNELS = ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv")


def resilient_cli(args: list[str], label: str, work: pathlib.Path,
                  sigterm_after: int | None = None) -> tuple[int, dict, list, dict]:
    """``python -m metis_tpu_torch <args>`` (``chaos`` or ``train
    --resilient``) in a process of its own, sent a real SIGTERM once
    ``sigterm_after`` ``train_step`` events are written: its exit code,
    report, events and rank 0's checkpoint save / restore ms."""
    events = work / f"{label}.events.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "metis_tpu_torch", *args, "--events", str(events)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=pathlib.Path(__file__).resolve().parent)
    if sigterm_after is not None:
        while proc.poll() is None:
            lines = events.read_text().splitlines() if events.exists() else []
            if sum('"train_step"' in line for line in lines) >= sigterm_after:
                proc.send_signal(signal.SIGTERM)
                break
            time.sleep(0.01)
    out, err = proc.communicate()
    for line in err.strip().splitlines()[-4:]:
        log(f"    {label}: {line}")
    if proc.returncode not in (0, 1):
        raise SystemExit(f"{label} failed (rc {proc.returncode}):\n{err[-4000:]}")
    ms = next((json.loads(line.split(": ", 1)[1]) for line in err.splitlines()
               if line.startswith("rank 0 checkpoint ms: ")), {})
    log(f"    {label}: {time.perf_counter() - t0:.1f} s")
    return (proc.returncode, json.loads(out) if out.strip() else {},
            [json.loads(line) for line in events.read_text().splitlines()], ms)


def chaos_launches(label: str, events: list) -> dict:
    """Gate: every supervised step launched each kernel once per block; the
    launches summed over the run's steps (``kernel_launches`` of its
    ``train_step`` events)."""
    per_step = [e.get("kernel_launches", {}) for e in events
                if e["event"] == "train_step"]
    expect = dict.fromkeys(FLASH_KERNELS, TRAIN_BLOCKS)
    if not per_step or any(step != expect for step in per_step):
        raise SystemExit(f"{label}: launches per step {per_step}, expected {expect}")
    return {k: sum(step[k] for step in per_step) for k in FLASH_KERNELS}


def in_order(names: list, *wanted: str) -> bool:
    at = [names.index(w) if w in names else -1 for w in wanted]
    return min(at) >= 0 and at == sorted(at)


def pinned_dir(path: pathlib.Path, art) -> pathlib.Path:
    path.mkdir()
    (path / "plan.json").write_text(art.to_json())
    return path


def chaos_phase(work: pathlib.Path, results: dict) -> tuple[dict, dict]:
    """``chaos``: the supervisor through the port's CLI (module doc, phase
    15), each run in its own process: (a) first, alone; then the restore
    onto another plan of its step-4 checkpoint (``replan_leg``), (b) and
    (c) beside one another (each in its own directories; their times are
    no speed: the ranks share the card and the host)."""
    from concurrent.futures import ThreadPoolExecutor

    base = results["train"]["base"]
    out, launches, step4 = chaos_leg_a(work, base)
    with ThreadPoolExecutor(3) as pool:
        legs = [pool.submit(replan_leg, work, base, step4),
                pool.submit(chaos_leg_b, work, base),
                pool.submit(chaos_leg_c, work, base)]
        for leg in legs:
            more_out, more_launches = leg.result()
            out.update(more_out)
            launches.update(more_launches)
    return out, launches


def chaos_leg_a(work: pathlib.Path, base: list[str]) -> tuple[dict, dict, dict]:
    """(a) The train phase's GPT at ``TRAIN_BLOCKS`` block and
    ``TRAIN_C_WIDTH`` on two gloo ranks sharing the card, a cluster of two
    one-card nodes, the dp 2 + ZeRO 1 plan pinned: ``chaos`` with ``CHAOS_A_SCRIPT``.  Gates:
    completed, 6 of 6 steps, at least 2 retries; one ``device_loss``
    recovery, migrated live onto the searched one-card plan, resumed at
    step 4; ``reshard_plan`` -> ``reshard_step`` -> ``migration_complete``
    -> ``recovery_complete``; steps 5-6 bit-equal to ``train
    --replan-on-resume`` from the same step-4 checkpoint (kept at
    ``.prev``) on one device, a run ``replan_leg`` makes and holds to its
    own gates too.  Its readings, its launches, and what ``replan_leg``
    reads: three copies of that checkpoint (the replanned run saves over
    one, dp 2's continuation restores one, this process the other), this
    run's losses, the dp 2 saves."""
    from metis_tpu_torch.core.config import ModelSpec
    from metis_tpu_torch.cost.volume import TransformerVolume
    from metis_tpu_torch.execution import reshard
    from metis_tpu_torch.execution.checkpoint import load_meta, load_plan
    from metis_tpu_torch.profiles.store import ProfileStore

    t0 = time.perf_counter()
    ckpt = pinned_dir(work / "chaos_a", pinned_plan(dp=2, zero=1))
    prof = base[base.index("--profile-dir") + 1]
    hostfile, clusterfile = write_cluster_files(
        work, ProfileStore.from_dir(prof).device_types[0], 2, 1)
    args = [*base, *TRAIN_C_WIDTH, "--hostfile", hostfile, "--clusterfile", clusterfile]
    rc, rep, ev, ms = resilient_cli(
        ["chaos", *args, "--steps", str(CHAOS_STEPS), "--checkpoint-every", "2",
         "--fault-script", CHAOS_A_SCRIPT, "--checkpoint-dir", str(ckpt),
         "--devices", "cuda:0,cuda:0", "--dist-backend", "gloo"], "chaos_a", work)
    names = [e["event"] for e in ev]
    recs = rep.get("recoveries", [])
    if (rc != 0 or rep["outcome"] != "completed" or rep["steps_done"] != CHAOS_STEPS
            or rep["retries"] < 2 or len(recs) != 1 or recs[0]["kind"] != "device_loss"
            or not recs[0]["migrated"] or recs[0]["resumed_step"] != 4
            or not in_order(names, "reshard_plan", "reshard_step",
                            "migration_complete", "recovery_complete")):
        raise SystemExit(f"(a) chaos: rc {rc}, report {rep}")
    launches = {"chaos_a": chaos_launches("(a)", ev)}
    # the step-4 generation, parked at .prev by the final save, kept for
    # ``replan_leg``
    prev = ckpt.with_name(ckpt.name + ".prev")
    if load_meta(prev).step != 4:
        raise SystemExit(f"(a) .prev holds step {load_meta(prev).step}, not 4")
    copies = {key: work / f"chaos_a_step4_{key}" for key in ("replan", "cont", "at4")}
    for path in copies.values():
        hardlink_copy(prev, path)
    got = step_losses(ev)
    # the price the supervisor's migration decision compared
    spec = ModelSpec(**dict(GPT_15B, num_layers=TRAIN_BLOCKS + 2, **QUARTER_WIDTH))
    volume = TransformerVolume(spec, ProfileStore.from_dir(prof).model.params_per_layer_bytes)
    old, new = pinned_plan(dp=2, zero=1), load_plan(ckpt)
    price = reshard.price_migration_ms(
        reshard.stage_layout(old, spec.num_layers), reshard.stage_layout(new, spec.num_layers),
        volume, 100.0)
    done = next(e for e in ev if e["event"] == "migration_complete")
    out = {"a_chaos": {
        "outcome": rep["outcome"], "steps_done": rep["steps_done"],
        "retries": rep["retries"], "checkpoints": rep["checkpoints"],
        "recover_s": recs[0]["recover_s"], "stall_ms": done["stall_ms"],
        "records": [{k: r[k] for k in ("kind", "recover_s")} for r in recs],
        "moved_bytes": done["moved_bytes"], "price_migration_ms_100gbps": price,
        "save_ms": ms.get("save_ms"), "restore_ms": ms.get("restore_ms"),
        "losses": got}}
    log(f"  (a) chaos {CHAOS_A_SCRIPT}: {rep['outcome']} {rep['steps_done']}/"
        f"{CHAOS_STEPS}, {rep['retries']} retries; device loss at 4 migrated live: "
        f"recover_s {recs[0]['recover_s']}, stall_ms {done['stall_ms']} "
        f"({done['moved_bytes'] / 1e9:.2f} GB) against price_migration_ms "
        f"{price:.3f} at 100 GB/s; saves {ms.get('save_ms')} ms; the step-4 "
        f"checkpoint kept for the replanned restore "
        f"({time.perf_counter() - t0:.1f} s, {SHARED_CARD})")
    step4 = dict(copies, gb=dir_gb(prev), losses=got, save_ms=ms.get("save_ms"))
    for path in (ckpt, prev):
        shutil.rmtree(path, ignore_errors=True)
    return out, launches, step4


def chaos_leg_b(work: pathlib.Path, base: list[str]) -> tuple[dict, dict]:
    """(b) At ``TRAIN_C_WIDTH``, the same cluster and pinned plan:
    ``chaos`` with ``CHAOS_B_SCRIPT`` plus ``loss_nan@5``, and without it.
    Gates: ``migration_fallback`` then the restore (not migrated, resumed
    at 4); a NaN rollback to step 4; completed; the final loss equal to
    that of the run without ``loss_nan``.  The two runs go beside each
    other."""
    from concurrent.futures import ThreadPoolExecutor

    from metis_tpu_torch.profiles.store import ProfileStore

    t0 = time.perf_counter()
    prof = base[base.index("--profile-dir") + 1]
    hostfile, clusterfile = write_cluster_files(
        work, ProfileStore.from_dir(prof).device_types[0], 2, 1)

    def run(label: str, script: str):
        ckpt = pinned_dir(work / f"chaos_b_{label}", pinned_plan(dp=2, zero=1))
        rc, rep, ev, ms = resilient_cli(
            ["chaos", *base, *TRAIN_C_WIDTH, "--hostfile", hostfile,
             "--clusterfile", clusterfile, "--steps", str(CHAOS_STEPS),
             "--checkpoint-every", "2", "--fault-script", script,
             "--checkpoint-dir", str(ckpt), "--devices", "cuda:0,cuda:0",
             "--dist-backend", "gloo"], f"chaos_b_{label}", work)
        for path in (ckpt, ckpt.with_name(ckpt.name + ".prev")):
            shutil.rmtree(path, ignore_errors=True)
        return (rc, rep, [e["event"] for e in ev], ms,
                chaos_launches(f"(b) {label}", ev))

    with ThreadPoolExecutor(2) as pool:
        runs = dict(zip(("nan", "clean"), pool.map(
            run, ("nan", "clean"), (f"{CHAOS_B_SCRIPT},loss_nan@5", CHAOS_B_SCRIPT))))
    launches = {f"chaos_b_{label}": got[4] for label, got in runs.items()}
    rc, rep, names, ms, _ = runs["nan"]
    recs = rep.get("recoveries", [])
    kinds = [(r["kind"], r["step"], r["resumed_step"], r["migrated"]) for r in recs]
    if (rc != 0 or rep["outcome"] != "completed" or rep["steps_done"] != CHAOS_STEPS
            or kinds != [("device_loss", 4, 4, False), ("anomaly_rollback", 5, 4, False)]
            or not in_order(names, "migration_fallback", "recovery_complete",
                            "anomaly_detected")
            or "migration_complete" in names
            or rep["final_loss"] != runs["clean"][1].get("final_loss")):
        raise SystemExit(f"(b) chaos: rc {rc}, report {rep}; clean run "
                         f"{runs['clean'][1]}")
    log(f"  (b) chaos {CHAOS_B_SCRIPT},loss_nan@5: migration_fallback, restore, "
        f"NaN rollback to 4, {rep['outcome']}; final loss {rep['final_loss']!r} equal "
        f"to the run without loss_nan; recover_s {[r['recover_s'] for r in recs]}, "
        f"saves {ms.get('save_ms')} restores {ms.get('restore_ms')} ms "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"b_chaos_fallback_nan": {
        "outcome": rep["outcome"], "recoveries": kinds,
        "recover_s": [r["recover_s"] for r in recs], "final_loss": rep["final_loss"],
        "records": [{k: r[k] for k in ("kind", "recover_s")} for run in runs.values()
                    for r in run[1].get("recoveries", [])],
        "final_loss_equal_without_nan": True, "save_ms": ms.get("save_ms"),
        "restore_ms": ms.get("restore_ms")}}, launches


def chaos_leg_c(work: pathlib.Path, base: list[str]) -> tuple[dict, dict]:
    """(c) At ``TRAIN_C_WIDTH`` on one device: ``train --resilient`` sent a
    real SIGTERM once its second ``train_step`` event is written.  Gates:
    exit 0, outcome ``preempted``, the checkpoint's step equal to
    ``steps_done``; the same command from the same directory then
    completes, its losses bit-equal to an uninterrupted run's (which goes
    beside the two)."""
    from concurrent.futures import ThreadPoolExecutor

    from metis_tpu_torch.execution.checkpoint import load_meta

    t0 = time.perf_counter()
    cmd = ["train", "--resilient", *base, *TRAIN_C_WIDTH, "--steps", str(CHAOS_STEPS),
           "--checkpoint-every", "2"]
    ckpt, straight = work / "chaos_c", work / "chaos_c_straight"
    with ThreadPoolExecutor(1) as pool:
        uninterrupted = pool.submit(
            resilient_cli, [*cmd, "--checkpoint-dir", str(straight)],
            "chaos_c_straight", work)
        rc, rep, ev1, ms = resilient_cli([*cmd, "--checkpoint-dir", str(ckpt)],
                                         "chaos_c_sigterm", work, sigterm_after=2)
        done = rep.get("steps_done")
        if (rc != 0 or rep["outcome"] != "preempted" or rep["detail"] != "sigterm"
                or load_meta(ckpt).step != done or not 2 <= done < CHAOS_STEPS):
            raise SystemExit(f"(c) SIGTERM: rc {rc}, report {rep}")
        rc2, rep2, ev2, _ = resilient_cli([*cmd, "--checkpoint-dir", str(ckpt)],
                                          "chaos_c_resumed", work)
        rc3, rep3, ev3, _ = uninterrupted.result()
    got = {**step_losses(ev1), **step_losses(ev2)}
    want = step_losses(ev3)
    if (rc2 != 0 or rc3 != 0 or rep2["outcome"] != "completed"
            or sorted(want) != list(range(1, CHAOS_STEPS + 1)) or got != want):
        raise SystemExit(f"(c) resumed {rep2} losses {got} against {want}")
    log(f"  (c) train --resilient drained by SIGTERM at step {done} (checkpoint step "
        f"{done}, save {ms.get('save_ms')} ms), resumed to {CHAOS_STEPS}: losses "
        f"bit-equal to the uninterrupted run ({time.perf_counter() - t0:.1f} s)")
    launches = {"chaos_c": chaos_launches("(c)", [*ev1, *ev2])}
    for path in (ckpt, straight):
        for p in (path, path.with_name(path.name + ".prev")):
            shutil.rmtree(p, ignore_errors=True)
    return {"c_sigterm": {"drained_at": done, "outcome": rep["outcome"],
                          "resumed_bit_equal": True, "save_ms": ms.get("save_ms")}}, launches


# the calibration phase: the collectives' local payloads (the calibrate
# subcommand's default) and the planner phase's 2 x 8 search it reruns with
# the measured dp overlap and the fitted recovery time
CALIBRATION_PAYLOAD_KB = (64, 256, 1024, 4096)
CALIBRATION_ITERS = 8


def finite_fields(label: str, got: dict) -> None:
    """Gate: every number of a measurement is finite."""
    bad = {k: v for k, v in got.items() if isinstance(v, (int, float))
           and not isinstance(v, bool) and not math.isfinite(v)}
    if bad:
        raise SystemExit(f"{label}: non-finite fields {bad}")


def calibration_phase(work: pathlib.Path, results: dict) -> tuple[dict, dict]:
    """``calibrate`` and the measured calibration (``cost/calibration.py``):
    (a) ``python -m metis_tpu_torch calibrate --output X --chip-roofline``
    on the one card: exit 1 and no ``X`` (one device has no collective to
    time), and a chip JSON whose ``matmul_tflops`` and ``hbm_stream_gbps``
    are finite, positive and at most 1.05 x the data sheet's peaks; (b)
    ``microbenchmark_collectives`` on the 2- and 4-rank gloo pools (CUDA
    tensors through the host): all five collectives fitted, one sample per
    payload; (c) ``measure_dp_overlap`` on the 2-rank pool and (d)
    ``measure_pipeline_overlap`` on the 4-rank pool (pp 2 x dp 2): every
    field finite, the fractions in [0, 1], (d)'s two modes' losses equal;
    (e) ``fit_recovery_seconds`` over the chaos phase's recoveries and
    ``fit_ledger_correction`` over the planner phase's ``validate`` pairs,
    read back through ``AccuracyLedger``; (f) the planner phase's search
    on 2 x 8 cards rerun through ``hetero --dp-overlap <measured>
    --spot-recover-s <fitted>``, its top three beside the default's.  The
    ranks share the card, so no collective number here is a link's."""
    from metis_tpu_torch import cli
    from metis_tpu_torch.cost.calibration import (
        COLLECTIVES,
        fit_ledger_correction,
        fit_recovery_seconds,
        measure_rank,
    )
    from metis_tpu_torch.obs.ledger import AccuracyLedger

    out = {}
    t0 = time.perf_counter()
    target = work / "calibration.json"
    chip_path = pathlib.Path(f"{target}.chip.json")
    proc = subprocess.run(
        [sys.executable, "-m", "metis_tpu_torch", "calibrate", "--output", str(target),
         "--chip-roofline"], capture_output=True, text=True,
        cwd=pathlib.Path(__file__).resolve().parent)
    for line in proc.stderr.strip().splitlines()[-3:]:
        log(f"    calibrate: {line}")
    if proc.returncode != 1 or target.exists() or not chip_path.exists():
        raise SystemExit(f"(a) calibrate on one card: rc {proc.returncode}, "
                         f"{target.name} written {target.exists()}, chip JSON "
                         f"{chip_path.exists()}:\n{proc.stderr[-4000:]}")
    chip = json.loads(chip_path.read_text())
    peaks = {"matmul_tflops": PEAK_BF16_FLOPS / 1e12,
             "hbm_stream_gbps": PEAK_BYTES_PER_S / 1e9}
    for key, peak in peaks.items():
        got = chip[key]
        log(f"  (a) {key} {got} on {chip['device_kind']}: {got / peak:.1%} of the "
            f"data sheet's {peak:g}")
        if not (math.isfinite(got) and 0 < got <= 1.05 * peak):
            raise SystemExit(f"(a) {key} {got} outside (0, 1.05 x {peak:g}]")
    out["a_chip"] = {**chip, **{f"{k}_share_of_peak": chip[k] / v
                                for k, v in peaks.items()}}
    log(f"  (a) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for world in (2, 4):
        ranks = on_ranks(measure_rank, world, "gloo", "microbenchmark_collectives",
                         dict(payload_kb=CALIBRATION_PAYLOAD_KB, iters=CALIBRATION_ITERS))
        same = all(r["result"] == ranks[0]["result"] for r in ranks)
        cal = ranks[0]["result"].to_json_dict()
        per = {name: sorted(s["nbytes"] for s in cal["samples"] if s["collective"] == name)
               for name in COLLECTIVES}
        if (not same or set(cal["fits"]) != set(COLLECTIVES)
                or any(len(set(v)) != len(CALIBRATION_PAYLOAD_KB) for v in per.values())
                or any(f["n_samples"] != len(CALIBRATION_PAYLOAD_KB)
                       for f in cal["fits"].values())):
            raise SystemExit(f"(b) collectives at {world} ranks: fits "
                             f"{sorted(cal['fits'])}, payloads {per}")
        for s_ in cal["samples"]:
            finite_fields(f"(b) {s_['collective']} at {world} ranks", s_)
        for name, f in cal["fits"].items():
            log(f"  (b) {world} gloo ranks, {name}: latency {f['latency_ms']:.4f} ms, "
                f"{f['effective_bw_gbps']:.3f} GB/s, r2 {f['r2']:.4f} "
                f"(payloads {per[name]} B)")
        out[f"b_collectives_{world}"] = {
            "fits": cal["fits"], "platform": cal["platform"],
            "device_kind": cal["device_kind"], "note": SHARED_CARD}
    log(f"  (b) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dp = on_ranks(measure_rank, 2, "gloo", "measure_dp_overlap", {})[0]["result"]
    finite_fields("(c) dp overlap", dp)
    if not 0.0 <= dp["overlap_fraction"] <= 1.0:
        raise SystemExit(f"(c) dp overlap {dp}")
    log(f"  (c) measure_dp_overlap, 2 gloo ranks: {dp} ({time.perf_counter() - t0:.1f} s)")
    out["c_dp_overlap"] = dp

    t0 = time.perf_counter()
    ranks = on_ranks(measure_rank, 4, "gloo", "measure_pipeline_overlap", {})
    pipe = ranks[0]["result"]
    finite_fields("(d) pipeline overlap", pipe)
    equal = all(r["losses"]["overlapped"] == r["losses"]["lockstep"]
                and all(map(math.isfinite, r["losses"]["lockstep"])) for r in ranks)
    events = [e["event"] for r in ranks for e in r["events"]]
    if (not 0.0 <= pipe["overlap_hidden_frac"] <= 1.0 or not equal
            or events != ["overlap_measured"]):
        raise SystemExit(f"(d) pipeline overlap {pipe}, losses equal {equal}, "
                         f"events {events}")
    log(f"  (d) measure_pipeline_overlap, pp 2 x dp 2 on 4 gloo ranks: {pipe}; "
        f"lockstep and overlapped losses equal {ranks[0]['losses']['lockstep']} "
        f"({time.perf_counter() - t0:.1f} s)")
    out["d_pipeline_overlap"] = dict(pipe, losses=ranks[0]["losses"]["lockstep"])

    # (e) the fits: the recovery time of the chaos phase's recoveries, the
    # prediction level of the validated plans
    chaos = results["chaos"]
    records = [*chaos["a_chaos"]["records"], *chaos["b_chaos_fallback_nan"]["records"]]
    recovery = fit_recovery_seconds(records)
    samples = AccuracyLedger(results["planner"]["ledger"]).samples
    correction = fit_ledger_correction(samples)
    if correction["n"] != len(results["planner"]["validate"]):
        raise SystemExit(f"(e) the ledger gave {correction['n']} pairs, validate "
                         f"measured {len(results['planner']['validate'])}")
    for label, fit in (("recovery", recovery), ("ledger", correction)):
        finite_fields(f"(e) {label}", fit)
    log(f"  (e) fit_recovery_seconds over {records}: {recovery}")
    log(f"  (e) fit_ledger_correction over validate's {len(samples)} pairs: {correction}")
    out["e_recovery"], out["e_ledger_correction"] = recovery, correction

    # (f) the planner phase's 2 x 8 search with the measured inputs
    t0 = time.perf_counter()
    sliced, planner = results["slice"], results["planner"]
    overlap = dp["overlap_fraction"]
    recover_s = recovery["spot_recover_s"]
    hostfile, clusterfile = planner["big_cluster"]
    path = work / "hetero_calibrated.json"
    if cli.main(["hetero", "--hostfile", hostfile, "--clusterfile", clusterfile,
                 "--profile-dir", sliced["profile_dir"], "--model-name", "gpt-1.5B",
                 *CLI_MODEL["gpt-1.5B"], "--gbs", "64", "--max-tp", "1",
                 "--max-bs", "4", "--top-k", "3", "--dp-overlap", str(overlap),
                 "--spot-recover-s", str(recover_s), "--output", str(path)]) != 0:
        raise SystemExit("(f) the calibrated hetero search failed")
    rows = json.loads(path.read_text())
    if not rows or not all(math.isfinite(r["cost_ms"]) for r in rows):
        raise SystemExit("(f) the calibrated search costed no finite plan")
    log(f"  (f) 2 x 8 {sliced['device_type']} at gbs 64, max tp 1, default "
        f"(--dp-overlap 0, --spot-recover-s 30):")
    print_ranking("hetero", planner["big_rows"])
    log(f"  (f) the same with --dp-overlap {overlap} --spot-recover-s {recover_s} "
        f"({time.perf_counter() - t0:.1f} s):")
    print_ranking("hetero", rows)
    out["f_calibrated_search"] = {
        "dp_overlap": overlap, "spot_recover_s": recover_s,
        "top_ms": [r["cost_ms"] for r in rows],
        "default_top_ms": [r["cost_ms"] for r in planner["big_rows"]],
        "same_order": ([r["strategies"] for r in rows]
                       == [r["strategies"] for r in planner["big_rows"]])}
    return out, {}


HIDDEN = ("launches", "profile_dir", "hostfile", "clusterfile", "tokens", "batches",
          "base", "ledger", "big_cluster", "big_rows")
PHASES = ("slice", "planner", "dist", "pipeline", "llama", "moe", "context",
          "zero_sp", "stage_axes", "train", "reshard", "chaos", "calibration")


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from metis_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    built = fa.kernel_library()
    log(f"build: {built.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {built.seconds:.1f} s)")
    for line in ptxas_summary(built.ptxas_log):
        log(f"  ptxas: {line}")

    log("kernels:")
    held, path_cases = kernel_phase()
    results = {}
    launches = {}
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            run_phases(pathlib.Path(tmp), results, launches, seconds)
        finally:
            close_pools()
    pools = {f"{backend}_{world}": pool.jobs for (world, backend), pool in POOLS.items()}
    log(f"rank launches: {len(POOLS)} (one pool per world size and backend: "
        f"{pools} jobs), besides the CLI's subprocesses")

    log(json.dumps({"kernels": kernel_records(held, path_cases, launches)}))
    for phase in PHASES:
        log(json.dumps({phase: {k: v for k, v in results[phase].items()
                                if k not in HIDDEN}}))
    log(json.dumps({"timing": {"phases_s": seconds, "rank_launches": len(POOLS),
                               "rank_jobs": pools,
                               "script_s": round(time.perf_counter() - started, 1)}}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(work: pathlib.Path, results: dict, launches: dict,
               seconds: dict) -> None:
    """Every phase of ``PHASES`` in turn (module doc), each pool closed
    after the last phase that runs one."""
    from metis_tpu_torch.models.gpt import GPTConfig

    for phase in PHASES:
        log(f"{phase}:")
        t0 = time.perf_counter()
        if phase == "slice":
            agreement_phase(GPTConfig(vocab_size=512, seq_len=256, hidden=256,
                                      num_heads=2, num_blocks=2))
            results["slice"] = slice_phase(work)
            launches["main"] = results["slice"]["launches"]
        elif phase == "planner":
            results["planner"] = planner_phase(work, results["slice"])
        elif phase == "dist":
            start_pools()
            results["dist"], launches["dp2_tp2_per_rank"] = dist_phase(
                work, results["slice"])
        elif phase == "pipeline":
            results["pipeline"], launches["pipeline_per_rank"] = pipeline_phase(
                work, results["slice"], results["planner"])
        elif phase == "zero_sp":
            results[phase], more = zero_sp_phase(work)
            launches.update(more)
        elif phase in ("stage_axes", "train", "reshard", "chaos", "calibration"):
            results[phase], more = {"stage_axes": stage_axes_phase,
                                    "train": train_phase,
                                    "reshard": reshard_phase,
                                    "chaos": chaos_phase,
                                    "calibration": calibration_phase}[phase](work, results)
            launches.update(more)
        else:
            results[phase], more = {"llama": llama_phase, "moe": moe_phase,
                                    "context": context_phase}[phase](work)
            launches.update(more)
        close_pools(phase)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        log(f"  {phase} phase {seconds[phase]} s")


if __name__ == "__main__":
    sys.exit(main())
