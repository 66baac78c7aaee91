"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases, each printing one JSON line; any failure propagates and the script
exits non-zero:

1. device  — requires CUDA; prints the card's name and, on a line of its own,
             `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. build   — builds the GRU kernels from `codebase_tpu_torch/csrc/` with nvcc.
3. kernels — holds each kernel against its plain PyTorch version at the
             rollout shape (a) G=2 T=1 B=65536, the update shape (b) G=2 T=26
             B=1024, a ragged shape (c) G=3 T=7 B=1000, the QMIX update
             and rollout shapes (d) G=3 T=26 B=512 and (e) G=3 T=1 B=32768,
             the actor-critic update and rollout shapes (f) G=2 T=25
             B=8192 and (g) G=2 T=1 B=8192, the SMAClite 3m shapes:
             QMIX's rollout (h) G=3 T=1 B=65536 and update (i) G=3 T=61
             B=256, MAPPO's update (j) G=3 T=60 B=8192, rollout (k) G=3
             T=1 B=8192 and target critic (l) G=3 T=61 B=8192, LBF
             MAPPO's target critic (m) G=2 T=26 B=8192, and the evals of
             100 episodes (n) G=3 T=1 B=100 and (o) G=2 T=1 B=100 (H=128),
             and for the wide kernels (H >= 256) the MMM2 shapes at H=512
             G=10: QMIX's rollout (p) T=1 B=2048, update (q) T=121 B=256
             and eval (r) T=1 B=100, MAPPO's rollout (s) T=1 B=256, update
             (t) T=120 B=256 and target critic (u) T=121 B=256, and three
             ragged shapes (v) G=3 T=7 B=1000 H=256, (w) G=3 T=5 B=333
             H=384 and (x) G=2 T=9 B=77 H=896, the largest H, where shared
             memory leaves the wide forward's tiling the least room, and the
             video's policy step of one env (y) G=2 T=1 B=1, and a sweep
             group's 32 units x 2 agents: recurrent IDQN's rollout (z1)
             G=64 T=1 B=32, updates (z2) T=26 B=32 and (z3) T=26 B=64 and
             eval (z4) T=1 B=100, MAPPO's rollout (z5) T=1 B=10, update
             (z6) T=25 B=10 and target critic (z7) T=26 B=10, and a
             rank's share of the two-rank phases: IDQN's rollout (z8)
             G=2 T=1 B=32768 and update (z9) T=26 B=512, MAPPO's rollout
             (z10) T=1 B=4096, update (z11) T=25 B=4096 and target (z12)
             T=26 B=4096, a sweep rank's 16 units (G=32): rollout (z13)
             T=1 B=32, update (z14) T=26 B=32 and eval (z15) T=1 B=100,
             and the recurrent learning gates' (`gate.RNN_GATES`, 10
             envs): the rollouts' policy step (z16) G=2 T=1 B=10,
             idqn_rnn_lbf's update (z17) G=2 T=26 B=32, mappo_rnn_lbf's
             update (z18) G=2 T=25 B=10 and target critic (z19) G=2 T=26
             B=10 (every shape a phase below gives the kernels): the
             forward against `gru_sequence_plain`, the whole backward (recurrence, weight
             gradient, reduction) against `gru_backward_plain`, the weight
             gradient alone against `gru_dw_plain` on the recurrence
             kernel's outputs; checks that two backward calls, and two
             reductions, are bitwise equal; and times each kernel, its plain
             version and a PyTorch yardstick (`torch.nn.GRUCell` at T=1,
             else `torch.nn.GRU` (cuDNN) for the forward, cuDNN forward +
             backward for the backward, `torch.bmm` for the weight gradient,
             `torch.sum` for the reduction) on the device (see `time_ms`; the
             reduction's input fits in the L2, so it is timed on copies that
             do not, see `cold_copies`). At the wide shapes it also
             reports the wide forward's tiling (`wide_forward_tiling`: row
             tile, grid, unit split, ring stages, shared memory) and the
             wide backward's (`wide_backward_tiling`: row tile, grid,
             shared memory, blocks an SM, waves; the blocks an SM checked
             against the CUDA runtime's count), and at every shape the
             weight gradient's (`dw_tiling`: tile, P, stages a block,
             grid, waves, their fill, shared memory).
3b. grouped_dw — the f32 weight gradients' kernels (`ops/grouped_dw.py`)
             at the benchmark cells' three products an update (first
             Linear 15 x 128, GRU input projection 128 x 384, final Linear
             128 x 6; G=2, K = 26 x 4096 and 26 x 8192): against an f64
             x^T dy, two calls bitwise equal, and device ms beside the
             bound, the plain version, `torch.bmm` f32 and P.
Then fourteen train phases through `codebase_tpu_torch.run.main`, each with
the counters (`utils/profiling`'s registry: the GRU kernels' launches, the
f32 weight gradients' calls by route and shape and their kernels' launches)
set to 0 just before and read just after, and logging
every iteration (`log_interval` = E*T, so the host loop's chunk is one
iteration, as before the chunk rule):
4. train       — recurrent IDQN on lbforaging:Foraging-8x8-2p-3f-v3 (T=25,
                 layers [128,128], 65536 envs, batch 1024, 8 updates per
                 collect), 3 iterations and one eval: the GRU kernels at (a),
                 (b) and (o); the update's three f32 weight gradients
                 (K = 26 x 1024) exactly 3 an update on the kernel route and
                 none to cuBLAS, one weight gradient kernel a call and a
                 reduction for each whose split is more than one, counted.
5. train_qmix  — the QMIX preset (CooperativeReward) with reward
                 standardisation, the recurrent critic shared by the 3 agents
                 of lbforaging:Foraging-10x10-3p-3f-v3 (the kernels at G=3),
                 32768 envs, batch 512, 3 iterations and one eval: (e), (d)
                 and (n).
6. train_vdn   — the VDN preset at the JAX package's `vdn_shared_lbf10`
                 sizes (MLP, shared, 32768 envs, batch 512), 2 iterations,
                 no GRU launch.
7. train_lstm  — recurrent IDQN with the LSTM cell and return
                 standardisation on Foraging-8x8-2p-3f-v3 (16384 envs, batch
                 1024), 2 iterations, no GRU launch.
8. train_mappo — the MAPPO preset with a recurrent actor and a recurrent
                 centralised critic on Foraging-8x8-2p-3f-v3, 8192 envs (the
                 JAX package's `ia2c_lbf` lane width), 3 iterations: the GRU
                 kernels at (g) in the rollout, (f) in the update and (m) for
                 the target critic (35 forward and 8 of each backward kernel
                 per iteration); the target critic follows the refresh rule.
8b. train_idqn_rnn_lbf — the idqn_rnn_lbf gate's config (the main path:
                 the IDQN preset with its GRU(128), 10 envs, batch 32, 10
                 updates a collect) with `training_start=0`, 6 iterations
                 and one eval: exactly 25 forwards at (z16) a rollout, 25 at
                 (o) an eval, 2 at (z17) and 1 of each backward kernel an
                 update (updates from iteration 4, once the replay holds 32
                 episodes); the f32 weight gradients (K = 26 x 32) counted
                 and checked as in phase 4.
8c. train_mappo_rnn_lbf — the mappo_rnn_lbf gate's config (10 envs), 3
                 iterations: exactly 35 forwards (25 at z16, 9 at z18, 1 at
                 z19) and 8 of each backward kernel an iteration.
9. train_ia2c  — the `ia2c_lbf` lane as the JAX package defines it (MLP,
                 8192 envs), 2 iterations, no GRU launch.
10. train_ippo_std — IPPO (MLP, 8192 envs) with reward and return
                 standardisation, 2 iterations: the reward streams and the
                 return moments advance on the card.
11. train_qmix_smaclite — the JAX package's `qmix_smaclite_3m` lane
                 (smaclite:3m-v0, T=60, 65536 envs, batch 256, buffer 65536)
                 with the recurrent critic (layers [128,128], no sharing):
                 the GRU kernels at (h), (i) and (n), 76 forwards and 8 of each
                 backward kernel per iteration; at least 3 iterations (the
                 episodes end early, so the env steps of 2 full-length
                 iterations take more) and one eval.
12. train_mappo_smaclite — MAPPO on smaclite:3m-v0, T=60, recurrent actor
                 and centralised recurrent critic, 8192 envs: the GRU at (k)
                 in the rollout, (j) in the update and (l) for the target
                 critic; 70 forwards and 8 of each backward kernel per
                 iteration.
13. train_qmix_rware — the JAX package's `qmix_rware` lane
                 (rware-tiny-2ag-v2, T=500, MLP, 8192 envs, batch 128,
                 buffer 16384, bf16 replay), 2 iterations, no GRU launch.
14. train_qmix_mmm2 — the JAX package's `qmix_smaclite_mmm2_big` lane
                 (smaclite:MMM2-v0, T=120, the 10 allies' shared 2x512 GRU
                 critic in bf16, 2048 envs, batch 256, buffer 2048, early
                 exit on under auto): the wide kernels at (p), (q) and (r).
15. train_mappo_mmm2 — `mappo_smaclite_mmm2_big` (shared 2x512 GRU actor
                 and centralised critic in bf16, 256 envs, no early exit):
                 the wide kernels at (s), (t) and (u).
The SMAClite 3m and MMM2 QMIX phases are followed by rollouts of their
trained policy with the early exit on and off in turns, which must be
identical (and leave the caller's generator alike), timed on the host.
The SMAClite phases count, on the card, the actions their rollouts took
that the step's mask forbade (it must be 0), the valid actions per step,
the mean episode length, the steps the last rollout took and whether the
early exit was on, and check that QMIX's replay stores f32 obs and
the masks. Then checkpoint, resume, eval, video and preemption:
16. resume_idqn  — the train phase's run (65536 envs, a replay of 131072
                 episodes) with a checkpoint after iteration 2 and one at the
                 end, then a second run that resumes from the first
                 checkpoint and trains iteration 3 again (the GRU kernels at
                 (a) and (b)): counters, replay with `pos` and generator
                 state equal exactly, the last row's loss, the eval returns
                 of both final states ((o)) and every other leaf of the state
                 to rtol 1e-6; prints the largest difference, whether the two
                 are bitwise equal, and the bytes, save and load seconds of
                 a full-width checkpoint.
17. resume_mappo — the same on train_mappo's run (8192 envs).
18. eval_cli     — `codebase_tpu_torch.eval.main` on resume_idqn's run: 100
                 episodes, exactly 25 forward launches at (o).
19. video        — the same with `video_frames=50`: 50 more at (y), and a
                 file of 50 frames of 128x128x3 uint8.
20. preemption   — `python -m codebase_tpu_torch.run ... resume=auto` in a
                 subprocess: SIGTERM after the first results.csv row gives
                 rc 0, the log line and a checkpoint; the relaunch resumes
                 from its step and exits 0.
Then the sweeps, through `codebase_tpu_torch.search` in this process
(`run --config <spec> --seeds N vmapped --yes`), each group's launch
counters set to 0 just before it and read just after:
21. sweep_idqn_rnn — recurrent IDQN on Foraging-8x8-2p-3f-v3 at the
                 preset's 32 envs, replay of 10000 episodes and 32 updates
                 a collect, lr [3e-4, 1e-3] x 16 seeds (32 units a group) x
                 batch [32, 64] (two groups), 3-4 iterations with a row
                 each: per unit a config.yaml with its seed and lr and a
                 results.csv with finite losses; a group's launches per
                 iteration are one unit's (25 forwards at z1, 64 at z2 or
                 z3 and 32 of each backward kernel; 25 forwards at z4 an
                 eval); then one unit through `run.main` with the same
                 settings, its launches by the same rule and its env-steps/s
                 beside the group's (summed over units).
22. sweep_unit_parity — units 0 and 31 of the batch-32 group rebuilt as
                 one-unit states from their slices: one update on the same
                 sampled batch both ways; loss and gradients to rtol 2e-4,
                 params after the Adam step too.
23. sweep_mappo_rnn — MAPPO, recurrent actor and centralised critic,
                 gamma [0.99, 0.95] x 16 seeds at 10 envs a unit (z5, z6,
                 z7): one unit's 35 forwards and 8 of each backward kernel
                 an iteration.
24. sweep_qmix   — QMIX (MLP [64, 64]) with return standardisation, tau
                 [100, 200] x 4 seeds: the mixer's unit axis and the
                 per-unit return moments on the card; one update a collect
                 (the fixed target's standardised returns grow
                 geometrically, the reference's semantics); then
                 sweep_qmix_unit_parity on its units 0 and 7.
25. search_cli   — `python -m codebase_tpu_torch.search` subprocesses:
                 `dry_run` on configs/sweeps/sample.yaml, `bayes --budget
                 2` and `locally --workers 2` on tiny specs, sharing the
                 card.
Then data parallelism (`codebase_tpu_torch/parallel/mesh.py`). The two
ranks share GPU 0 over gloo (NCCL refuses two ranks on one GPU); each rank's launch counters are set to 0 before and
read after each run, and each collective and the draws are timed between
device syncs (`mesh.collect_times`):
26. dist_idqn_nccl — `run.main` on the train phase's argv plus
                 `distributed.devices=1`: one NCCL rank; its rows are the
                 train phase's to rtol 1e-6; the all-reduce and draw ms an
                 iteration.
27. dist_idqn_gloo2 — the same lane over two gloo ranks on GPU 0 (32768
                 envs and 512 rows of each batch a rank, a row every
                 iteration, checkpoints) against one rank of the same argv:
                 equal steps and updates, losses to rtol 1e-4 / atol 1e-6,
                 returns to atol 1e-6, params bitwise equal across the
                 ranks, only rank 0 wrote files; each rank's launches and
                 collective ms an iteration (gradient, batch, early-exit
                 flag).
28. dist_mappo_gloo2 — train_mappo's argv over two ranks, the same checks.
29. dist_resume  — the two-rank run's checkpoint after iteration 2
                 resumed at one rank: the rows and final state of the
                 two-rank run.
30. dist_sweep   — sweep_idqn_rnn's batch-32 group sharded over two ranks
                 (16 units each): one unit's launches an iteration a rank;
                 units 0 and 31 wrote the unsharded group's rows.
31. dist_refusal — `distributed.devices` one more than the visible GPUs
                 raises before any rank starts.
Then the tooling (`analyze` runs right after sweep_unit_parity, on its
run tree), each on the train phase's lane (recurrent IDQN, 65536 envs,
batch 1024) unless said:
32. analyze      — `codebase_tpu_torch.analyze summary` and `best` over
                 sweep_idqn_rnn's run tree: 4 groups (lr x batch), the best.
33. debug_idqn_rnn — 2 iterations with `debug=false`, then with
                 `debug=true`: rows equal to rtol 1e-6, each run's seconds an
                 iteration, the ops the dispatch mode scanned on the
                 caller's thread and on others (the autograd engine's).
34. debug_nan    — under debug, a poisoned W_hh entry raises naming
                 gru_fwd_kernel, a NaN dy given to `gru_backward_cuda` at (b)
                 names gru_bwd_kernel, a poisoned first-layer weight names an
                 aten op, and an out-of-range gather raises IndexError before
                 its launch (the card runs on after it).
35. trace_idqn_rnn — 2 iterations with `trace_dir`: the trace parses and
                 holds the four GRU kernels' events and the ranges
                 dqn/rollout, dqn/updates and env/step; its bytes.
36. profile_dist — `codebase_tpu_torch.profile` with
                 `distributed.devices=1` (one NCCL rank) and over two gloo
                 ranks sharing the card: `world`, each rank's kernel ms and
                 busy share, `tflops_per_s`.
37. entry_and_optimizers — one iteration through `algorithm.entry=
                 chip_smoke:custom_entry`, one through `register_algorithm`,
                 then 2 under each of rmsprop, sgd and adamw; each first step
                 equals its CPU twin's on the same gradients (rtol 1e-6).
38. hetero       — agents of unequal sizes (inputs [15, 12], outputs [6,
                 5], GRU(128)) at 65536 envs: the kernels' forward against
                 the plain recurrence, zero gradients on the padding.
39. bench        — every lane of `codebase_tpu_torch/bench_suite.py` at
                 its full width (idqn_lbf at 65536 envs among them) through
                 `run_config` with one window of 2 iterations: a line a lane
                 with env-steps/s, MFU and its peak, operations and bytes a
                 step, HBM use, peak memory and GRU launches an iteration;
                 idqn_rnn_lbf launches the H=128 kernels, the two MMM2
                 lanes the wide ones, every other lane none.
40. gate_smoke   — `codebase_tpu_torch.gate.run` on two seeds of the
                 ippo_lbf gate's overrides (the JAX runner's, 10 envs) cut to
                 `algorithm.total_steps=80000`: seed 0 uncut, then seed 1
                 cut by the budget half way between its second and third
                 rows, resumed by a second `run` call at its third row or
                 one either side; both results.csv files hold rows every
                 20000 up to 100000 only, the JAX package's steps
                 (a chunk of 80 iterations is one row; the loop runs until
                 the step exceeds the budget): no duplicate, no gap.
                 `gate._read_csv` (the comparison's reader) reads them,
                 losses and returns are finite; seconds per 20,000 steps.
                 Then gate_smoke_mappo_rnn: the same on two seeds of the
                 mappo_rnn_lbf gate (the GRU kernels in the subprocesses;
                 the cut seed resumes from a checkpoint of recurrent
                 weights).
41. card_vs_cpu  — `codebase_tpu_torch.card_vs_cpu.run_all("cuda")`:
                 the same inputs through the port on the card and on the CPU
                 in this process. The env steps of rware-tiny-2ag-v2 (2048
                 envs, 500 steps, deliveries planted, the CPU's requests
                 carried to the card after each step), LBF 8x8 (4096, 25)
                 and SMAClite 3m with masks (1024, 60) are equal (SMAClite's
                 float fields within rtol 1e-6, its entries that are not
                 bitwise equal counted); 20 updates of the ia2c_rware gate's
                 IA2C config (10 envs, T=500) from the same params on the
                 same rollouts agree to rtol 1e-5 / atol 1e-6 after the
                 first and 1e-4 after the last; 20 updates of the
                 idqn_rnn_lbf gate's IDQN (batches of 32 episodes, T=25)
                 and of the mappo_rnn_lbf gate's MAPPO (10 envs, T=25), the
                 GRU through the kernels on the card and their plain
                 versions on the CPU, agree to rtol 1e-4 / atol 1e-6 after
                 the first and 1e-3 / 1e-5 after (`RNN_UPDATE_TOL`), with
                 the kernels' launches counted; the card's Gumbel-max
                 sample, `gumbel_argmax` and RWARE's reset pass chi-square
                 tests at p >= 1e-4 (2^22 draws; `exponential_` yields no
                 0); the card's random-policy delivery counts (9 seeds of
                 2048 episodes: the first and the sum) and the eval CLI's
                 score of the vendored ia2c_rware checkpoint (2000 episodes)
                 agree with the JAX package's vendored numbers within 4
                 standard deviations.
Then the kernel summary line and, last, the device line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import io
import itertools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import yaml

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a CUDA GPU")

from codebase_tpu_torch import bench_suite as port_bench_suite  # noqa: E402
from codebase_tpu_torch import card_vs_cpu as port_card_vs_cpu  # noqa: E402
from codebase_tpu_torch import eval as port_eval  # noqa: E402
from codebase_tpu_torch import gate as port_gate  # noqa: E402
from codebase_tpu_torch import run as port_run  # noqa: E402
from codebase_tpu_torch import search as port_search  # noqa: E402
from codebase_tpu_torch import sweep as port_sweep  # noqa: E402
from codebase_tpu_torch.algos import ac as port_ac  # noqa: E402
from codebase_tpu_torch.algos import dqn as port_dqn  # noqa: E402
from codebase_tpu_torch.config import load_config  # noqa: E402
from codebase_tpu_torch.algos.common import unit_values  # noqa: E402
from codebase_tpu_torch.envs import vector as port_vector  # noqa: E402
from codebase_tpu_torch.ops import fused_gru as fg  # noqa: E402
from codebase_tpu_torch.ops import grouped_dw as gd  # noqa: E402
from codebase_tpu_torch.ops import kernel_lib  # noqa: E402
from codebase_tpu_torch.ops.replay import batch_to_reference_layout, replay_sample_many  # noqa: E402
from codebase_tpu_torch.ops.running_stats import RunningMeanStd  # noqa: E402
from codebase_tpu_torch.parallel import mesh  # noqa: E402
from codebase_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from codebase_tpu_torch.utils import debug as port_debug  # noqa: E402
from codebase_tpu_torch.utils import profiling  # noqa: E402
from codebase_tpu_torch.utils.device import resolve_device  # noqa: E402

SHAPES = {
    "a": dict(G=2, T=1, B=65536, role="rollout: policy step, T=1 over all envs"),
    "b": dict(G=2, T=26, B=1024, role="update: online/target nets over T+1=26 steps"),
    "c": dict(G=3, T=7, B=1000, role="ragged: B not a multiple of any tile"),
    "d": dict(G=3, T=26, B=512, role="QMIX update: the critic shared by N=3 agents over T+1=26 steps"),
    "e": dict(G=3, T=1, B=32768, role="QMIX rollout: policy step of the shared critic, T=1 over all envs"),
    "f": dict(G=2, T=25, B=8192, role="actor-critic update: actor and critic over the whole rollout, T=25"),
    "g": dict(G=2, T=1, B=8192, role="actor-critic rollout: the actor's policy step, T=1 over all envs"),
    "h": dict(G=3, T=1, B=65536, role="SMAClite 3m QMIX rollout: the 3 agents' critics, T=1 over all envs"),
    "i": dict(G=3, T=61, B=256, role="SMAClite 3m QMIX update: online/target critics over T+1=61 steps"),
    "j": dict(G=3, T=60, B=8192, role="SMAClite 3m MAPPO update: actor and critic over the whole rollout, T=60"),
    "k": dict(G=3, T=1, B=8192, role="SMAClite 3m MAPPO rollout: the actor's policy step, T=1 over all envs"),
    "l": dict(G=3, T=61, B=8192, role="SMAClite 3m MAPPO target critic: bootstrap values over T+1=61 steps"),
    "m": dict(G=2, T=26, B=8192, role="LBF MAPPO target critic: bootstrap values over T+1=26 steps"),
    "n": dict(G=3, T=1, B=100, role="QMIX eval (LBF and SMAClite): policy step over 100 episodes"),
    "o": dict(G=2, T=1, B=100, role="IDQN eval: policy step over 100 episodes"),
    # the wide kernels (H >= 256): the MMM2 lanes' shared 2x512 GRU gathered
    # for the 10 allies (G=10), and two ragged shapes of other widths
    "p": dict(G=10, T=1, B=2048, H=512, role="MMM2 QMIX rollout: the shared critic, T=1 over all envs"),
    "q": dict(G=10, T=121, B=256, H=512, role="MMM2 QMIX update: online/target critics over T+1=121 steps"),
    "r": dict(G=10, T=1, B=100, H=512, role="MMM2 QMIX eval: policy step over 100 episodes"),
    "s": dict(G=10, T=1, B=256, H=512, role="MMM2 MAPPO rollout: the actor's policy step, T=1 over all envs"),
    "t": dict(G=10, T=120, B=256, H=512, role="MMM2 MAPPO update: actor and critic over the padded rollout, T=120"),
    "u": dict(G=10, T=121, B=256, H=512, role="MMM2 MAPPO target critic: bootstrap values over T+1=121 steps"),
    "v": dict(G=3, T=7, B=1000, H=256, role="ragged at H=256"),
    "w": dict(G=3, T=5, B=333, H=384, role="ragged at H=384"),
    "x": dict(G=2, T=9, B=77, H=896, role="ragged at H=896, the largest H: the least shared memory for the tiling"),
    "y": dict(G=2, T=1, B=1, role="video: the IDQN policy step of the one env a video records"),
    # a sweep group's units folded into the group axis: 32 units x 2 agents
    "z1": dict(G=64, T=1, B=32, role="IDQN sweep rollout: 32 units' policy step over each unit's 32 envs"),
    "z2": dict(G=64, T=26, B=32, role="IDQN sweep update, batch 32: 32 units' online/target nets over T+1=26 steps"),
    "z3": dict(G=64, T=26, B=64, role="IDQN sweep update, batch 64"),
    "z4": dict(G=64, T=1, B=100, role="IDQN sweep eval: policy step over 100 episodes a unit"),
    "z5": dict(G=64, T=1, B=10, role="MAPPO sweep rollout: 32 units' actors over each unit's 10 envs"),
    "z6": dict(G=64, T=25, B=10, role="MAPPO sweep update: actor and critic over the rollout, T=25"),
    "z7": dict(G=64, T=26, B=10, role="MAPPO sweep target critic: bootstrap values over T+1=26 steps"),
    # a rank's share of the data-parallel runs over two ranks: IDQN's 65536
    # envs and batch 1024, MAPPO's 8192 envs, a sweep group's 32 units
    "z8": dict(G=2, T=1, B=32768, role="IDQN over 2 ranks, a rank's rollout: policy step over its 32768 envs"),
    "z9": dict(G=2, T=26, B=512, role="IDQN over 2 ranks, a rank's update: its 512 rows of the batch of 1024"),
    "z10": dict(G=2, T=1, B=4096, role="MAPPO over 2 ranks, a rank's rollout: the actor over its 4096 envs"),
    "z11": dict(G=2, T=25, B=4096, role="MAPPO over 2 ranks, a rank's update: actor and critic over its envs"),
    "z12": dict(G=2, T=26, B=4096, role="MAPPO over 2 ranks, a rank's target critic over T+1=26 steps"),
    "z13": dict(G=32, T=1, B=32, role="IDQN sweep over 2 ranks, a rank's 16 units' rollout"),
    "z14": dict(G=32, T=26, B=32, role="IDQN sweep over 2 ranks, a rank's 16 units' update, batch 32"),
    "z15": dict(G=32, T=1, B=100, role="IDQN sweep over 2 ranks, a rank's 16 units' eval of 100 episodes"),
    # the recurrent learning gates (`gate.RNN_GATES`) at their 10 envs; their
    # evals of 100 episodes are (o)
    "z16": dict(G=2, T=1, B=10, role="recurrent gates' rollout: the policy step over 10 envs"),
    "z17": dict(G=2, T=26, B=32, role="idqn_rnn_lbf update: online/target nets over T+1=26 steps, batch 32"),
    "z18": dict(G=2, T=25, B=10, role="mappo_rnn_lbf update: actor and critic over the rollout, T=25"),
    "z19": dict(G=2, T=26, B=10, role="mappo_rnn_lbf target critic: bootstrap values over T+1=26 steps"),
}
for _shape in SHAPES.values():
    _shape.setdefault("H", 128)
# each train phase's argv (without its run_dir) and results.csv rows, for
# the data-parallel phases to repeat and compare
RUNS = {}
# the value-based phases' replay settings
DQN_ARGV = ["algorithm.updates_per_collect=8", "algorithm.training_start=0", "algorithm.replay_slot_reuse=clear"]
# cycles of the spin kernel that holds the stream while a timed run of calls
# is enqueued (about 2 ms on an H100)
SPIN_CYCLES = 4_000_000
TOL = {
    # forward outputs are O(1) (tanh-bounded); only rounding order differs
    "y": (1e-5, 1e-5),
    "hT": (1e-5, 1e-5),
    # per-row gradients: one matmul reduction order differs per step
    "dgi": (1e-5, 1e-5),
    "dh0": (1e-5, 1e-5),
    # sums over T*B terms in another order: 1e-4 relative to the largest entry
    "dW_hh": (1e-4, "1e-4*max|ref|"),
    "db_hh": (1e-4, "1e-4*max|ref|"),
    "partials_sum": (1e-5, "1e-5*max|ref|"),
}


_LAST_LINE = [time.perf_counter()]


def emit(obj) -> None:
    """Print a phase's JSON line, with `wall_s`: the seconds since the
    previous line (a phase's time, from its first line's)."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = {**obj, "wall_s": now - _LAST_LINE[0]}
    _LAST_LINE[0] = now
    print(json.dumps(obj), flush=True)


def compare(name, got, ref) -> float:
    rtol, atol = TOL[name]
    if isinstance(atol, str):
        atol = float(atol.split("*")[0]) * ref.abs().max().item()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: max_abs_err {err.max().item():.3e} over tolerance rtol={rtol} atol={atol:.3e}"
        )
    return err.max().item()


def _run_ms(fn, n) -> float:
    """ms per call of n back-to-back calls between two CUDA events. A spin
    kernel holds the stream while the host enqueues them, so the device runs
    them back to back: neither the wrapper's host time nor a launch gap is
    counted, unless the host takes longer than the spin."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def cold_copies(t, factor=4) -> list:
    """`t` and copies of it, together at least `factor` times the card's L2.
    A run of calls that takes them in turn reads each from HBM: between two
    reads of one copy the others have gone through the L2. A kernel whose
    input fits in the L2 is timed so, to be held to its HBM bound."""
    l2 = torch.cuda.get_device_properties(t.device).L2_cache_size
    return [t] + [t.clone() for _ in range(max(1, -(-factor * l2 // t.nbytes) - 1))]


def time_ms(fn, reps=25, warmup=3) -> float:
    """Device time of one call (ms): the median over `reps` runs of n calls,
    n (1 to 20) chosen so that a run fills about 1 ms. A call whose host time
    outlasts the spin (the plain versions, which launch hundreds of small
    kernels) is timed with its host gaps."""
    for _ in range(warmup):
        fn()
    n = max(1, min(20, int(1.0 / max(_run_ms(fn, 1), 1e-3))))
    return statistics.median(_run_ms(fn, n) for _ in range(reps))


def bounds(kernel, G, T, B, H, P, peaks):
    """Least time (ms) for the function's work: max(bytes / HBM rate,
    operations / peak rate), each input read once and each output written
    once, no scratch or partials (`fused_gru.kernel_bytes`). The operations
    are the kernels' own counts (`fused_gru.kernel_flops`; both are what
    `utils/profiling.cost_analysis` adds up): the forward's product, the
    recurrence's two (h_prev @ W_hh, dgh @ W_hh^T) and the weight
    gradient's one (h_prev^T dgh) run on tensor cores in 3xTF32 (three TF32
    products each); the reduction's adds on FP32 CUDA cores. `peaks` is the
    card's `bench_suite.PEAKS` entry."""
    tf32 = peaks["tf32_flops"]
    dims = dict(G=G, T=T, B=B, H=H)
    flops = {k: fg.kernel_flops(f"gru_{k}_kernel", dims) for k in ("fwd", "bwd", "dw")}
    if kernel == "gru_fwd":
        nbytes = fg.kernel_bytes("gru_fwd_kernel", dims)
        t_ops = 3 * flops["fwd"] / tf32
    elif kernel == "gru_bwd":  # the whole backward: gi, W, b, h0, y, dy, dhT -> dgi, dW, db, dh0
        nbytes = fg.kernel_bytes("gru_backward", dims)
        t_ops = 3 * (flops["bwd"] + flops["dw"]) / tf32
    elif kernel == "gru_bwd_recurrence":  # gi, W, b, h0, y, dy, dhT -> dgi, dh0, dgh_n
        nbytes = fg.kernel_bytes("gru_bwd_kernel", dims)
        t_ops = 3 * flops["bwd"] / tf32
    elif kernel == "gru_dw":  # h_prev, dgh -> dW, db
        nbytes = fg.kernel_bytes("gru_dw_kernel", dims)
        t_ops = 3 * flops["dw"] / tf32
    else:  # gru_reduce
        reduce_dims = dict(G=G, P=P, E=H * 3 * H + 3 * H)
        nbytes = fg.kernel_bytes("gru_reduce_kernel", reduce_dims)
        t_ops = fg.kernel_flops("gru_reduce_kernel", reduce_dims) / peaks["fp32_flops"]
    t_bytes, t_ops = nbytes / peaks["hbm_bytes_per_s"] * 1e3, t_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_shape(key, G, T, B, H, gen, peaks):
    dev = torch.device("cuda")
    gi = torch.randn((G, T, B, 3 * H), device=dev, generator=gen)
    # scaled so that h @ W_hh has the same spread at every H as at H=128
    w = torch.randn((G, H, 3 * H), device=dev, generator=gen) * (0.1 * (128 / H) ** 0.5)
    b = torch.randn((G, 3 * H), device=dev, generator=gen) * 0.1
    h0 = torch.randn((G, B, H), device=dev, generator=gen)
    ky = torch.randn((G, T, B, H), device=dev, generator=gen)
    kh = torch.randn((G, B, H), device=dev, generator=gen)

    with torch.no_grad():
        y, hT = fg.gru_fwd_cuda(gi, w, b, h0)
        yr, hTr = fg.gru_sequence_plain(gi, w, b, h0)
        errs = {"y": compare("y", y, yr), "hT": compare("hT", hT, hTr)}
        # the whole backward (recurrence, weight gradient, reduction) and
        # its plain version on the same inputs; two calls bitwise equal
        grads = fg.gru_backward_cuda(gi, w, b, h0, y, ky, kh)
        again = fg.gru_backward_cuda(gi, w, b, h0, y, ky, kh)
        rgrads = fg.gru_backward_plain(gi, w, b, h0, y, ky, kh)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(grads, again)):
            raise AssertionError("gru_backward: two calls on the same inputs differ")
        for n, g_, r_ in zip(("dgi", "dW_hh", "db_hh", "dh0"), grads, rgrads):
            errs[n] = compare(n, g_, r_)
        del again, rgrads
        # the weight gradient alone, on the recurrence kernel's dgi and dgh_n
        dgi, _, dgh_n = fg.gru_bwd_cuda(gi, w, b, h0, y, ky, kh)
        partials = fg.gru_dw_cuda(h0, y, dgi, dgh_n)
        sums = fg.reduce_partials_cuda(partials)
        dw_ref, db_ref = fg.gru_dw_plain(h0, y, dgi, dgh_n)
        errs["dw_dW_hh"] = compare("dW_hh", sums[:, : H * 3 * H].reshape(w.shape), dw_ref)
        errs["dw_db_hh"] = compare("db_hh", sums[:, H * 3 * H :], db_ref)
        if not torch.equal(sums, fg.reduce_partials_cuda(partials)):
            raise AssertionError("gru_reduce: two calls on the same partials differ")
        errs["partials_sum"] = compare("partials_sum", sums, fg.reduce_partials_plain(partials))
        P = partials.shape[1]
        # the library's product: f32 (allow_tf32 False) on h_prev and dgh
        # assembled beforehand, so it is timed without the concatenations
        hp_t = torch.cat([h0[:, None], y[:, :-1]], 1).reshape(G, T * B, H).transpose(1, 2)
        dgh = torch.cat([dgi[..., : 2 * H], dgh_n], -1).reshape(G, T * B, 3 * H)
        ring = itertools.cycle(cold_copies(partials))
        t = {
            "gru_fwd": time_ms(lambda: fg.gru_fwd_cuda(gi, w, b, h0)),
            "gru_fwd_plain": time_ms(lambda: fg.gru_sequence_plain(gi, w, b, h0)),
            "gru_bwd": time_ms(lambda: fg.gru_backward_cuda(gi, w, b, h0, y, ky, kh)),
            "gru_bwd_recurrence": time_ms(lambda: fg.gru_bwd_cuda(gi, w, b, h0, y, ky, kh)),
            "gru_bwd_recurrence_plain": time_ms(lambda: fg.gru_bwd_plain(gi, w, b, h0, y, ky, kh)),
            "gru_bwd_plain": time_ms(lambda: fg.gru_backward_plain(gi, w, b, h0, y, ky, kh)),
            "gru_dw": time_ms(lambda: fg.gru_dw_cuda(h0, y, dgi, dgh_n)),
            "gru_dw_plain": time_ms(lambda: fg.gru_dw_plain(h0, y, dgi, dgh_n)),
            "gru_dw_library": time_ms(lambda: torch.bmm(hp_t, dgh)),
            "gru_reduce": time_ms(lambda: fg.reduce_partials_cuda(next(ring))),
            "gru_reduce_plain": time_ms(lambda: fg.reduce_partials_plain(next(ring))),
            "gru_reduce_library": time_ms(lambda: torch.sum(next(ring), 1)),
        }
        del ring, hp_t, dgh
    # yardsticks, one call per group, input projection included (so each is
    # an upper bound on the recurrence alone): at T=1 torch.nn.GRUCell (two
    # f32 GEMMs and a fused gate kernel), else cuDNN's GRU
    cudnn = [torch.nn.GRU(H, H).to(dev) for _ in range(G)]
    x = torch.randn((T, B, H), device=dev, generator=gen)
    h0c = h0[:, None]  # (G, 1, B, H)
    with torch.no_grad():
        if T == 1:
            cells = [torch.nn.GRUCell(H, H).to(dev) for _ in range(G)]
            t["gru_fwd_library"] = time_ms(lambda: [c(x[0], h0[g]) for g, c in enumerate(cells)])
            library = "torch.nn.GRUCell, one call per group, input projection included"
        else:
            t["gru_fwd_library"] = time_ms(lambda: [m(x, h0c[g]) for g, m in enumerate(cudnn)])
            library = "torch.nn.GRU (cuDNN), one call per group, input projection included"
    xg = x.clone().requires_grad_()

    def lib_fwd_bwd():
        outs = [m(xg, h0c[g]) for g, m in enumerate(cudnn)]
        torch.autograd.backward([o[0].sum() for o in outs])

    t["gru_bwd_library"] = time_ms(lib_fwd_bwd)
    del cudnn
    libraries = {
        "gru_fwd": library,
        "gru_bwd": "torch.nn.GRU (cuDNN) forward + backward, one call per group",
        "gru_dw": "torch.bmm(h_prev^T, dgh), f32 (allow_tf32 False), inputs assembled beforehand",
        "gru_reduce": "torch.sum(partials, 1)",
    }
    names = {"gru_fwd": ("y", "hT"), "gru_bwd": ("dgi", "dW_hh", "db_hh", "dh0"),
             "gru_dw": ("dw_dW_hh", "dw_db_hh"), "gru_reduce": ("partials_sum",)}
    out = {}
    for k in ("gru_fwd", "gru_bwd", "gru_dw", "gru_reduce"):
        bound_ms, bound_by = bounds(k, G, T, B, H, P, peaks)
        out[k] = {
            "max_abs_err": max(errs[n] for n in names[k]),
            "errors": {n: errs[n] for n in names[k]},
            "tolerance": {n: list(TOL[n.removeprefix("dw_")]) for n in names[k]},
            "ms": t[k],
            "plain_ms": t[k + "_plain"],
            "library_ms": t[k + "_library"],
            "library": libraries[k],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
    out["gru_bwd"]["recurrence_ms"] = t["gru_bwd_recurrence"]
    out["gru_bwd"]["recurrence_plain_ms"] = t["gru_bwd_recurrence_plain"]
    out["gru_bwd"]["recurrence_bound_ms"], out["gru_bwd"]["recurrence_bound_by"] = bounds(
        "gru_bwd_recurrence", G, T, B, H, P, peaks)
    out["gru_reduce"]["partials_per_group"] = P
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["gru_dw"]["tiling"] = fg.dw_tiling(G, T, B, H, sms)
    if out["gru_dw"]["tiling"]["P"] != P:
        raise AssertionError(f"gru_dw at {key}: {P} partials a group, the tiling counts {out['gru_dw']['tiling']['P']}")
    if H != 128:  # the wide kernels' launches at this shape
        out["gru_fwd"]["tiling"] = fg.wide_forward_tiling(G, T, B, H, sms)
        tile = out["gru_bwd"]["tiling"] = fg.wide_backward_tiling(G, T, B, H, sms)
        on_card = fg._library().gru_bwd_wide_blocks_per_sm(H, tile["rows"])
        if on_card != tile["blocks_per_sm"]:
            raise AssertionError(f"wide backward at {key}: the runtime fits {on_card} blocks an SM, "
                                 f"the tiling counts {tile['blocks_per_sm']}")
    return out


# the f32 weight gradients of recurrent IDQN's update on LBF 8x8-2p-3f
# (`ops/grouped_dw.py`): the first Linear, the GRU input projection and the
# final Linear, M x N, of G=2 agents over K = (T+1) B = 26 B rows, at each
# benchmark cell's batch B
DW_PRODUCTS = {"first_linear": (15, 128), "gru_input_projection": (128, 384), "final_linear": (128, 6)}
DW_CELLS = {"idqn_rnn_lbf.collect": 4096, "idqn_rnn_lbf.replay32": 8192}


def grouped_dw_bounds(G, K, M, N, variant, peaks):
    """`bounds()`' rule for a weight gradient x^T dy: its bytes (x and dy
    read once, dW written once) over the HBM rate, or its operations over
    the rate of the units that run them (3xTF32 on tensor cores in the wgmma
    kernel, FP32 FFMA in the other), the larger."""
    dims = dict(G=G, K=K, M=M, N=N)
    kernel = "grouped_dw_kernel" if variant == "wgmma" else "grouped_dw_ffma_kernel"
    flops = gd.kernel_flops(kernel, dims)
    t_ops = 3 * flops / peaks["tf32_flops"] if variant == "wgmma" else flops / peaks["fp32_flops"]
    t_bytes = gd.kernel_bytes(kernel, dims) / peaks["hbm_bytes_per_s"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def grouped_dw_phase(smi, peaks) -> dict:
    """The weight gradient kernels (and their reduction) at each cell's three
    products: against an f64 x^T dy (1e-4 of the largest entry), two calls
    bitwise equal; device ms beside the bound, the plain version
    (`grouped_dw_plain`) and `torch.bmm` f32, and the split (P). The launches
    are counted in the train phases (`check_linear_dw`)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for cell, B in DW_CELLS.items():
        for product, (M, N) in DW_PRODUCTS.items():
            G, K = 2, 26 * B
            x = torch.randn((G, K, M), device=dev, generator=gen)
            dy = torch.randn((G, K, N), device=dev, generator=gen)
            tiling = gd.grouped_dw_tiling(G, K, M, N, sms)

            def kernel():
                partials = gd.grouped_dw_cuda(x, dy)
                return partials[:, 0] if tiling["P"] == 1 else gd.grouped_dw_reduce_cuda(partials)

            got, again = kernel(), kernel()
            ref = torch.bmm(x.double().transpose(1, 2), dy.double())
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"grouped_dw at {cell} {product}: two calls on the same inputs differ")
            err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
            if err > 1e-4:
                raise AssertionError(f"grouped_dw at {cell} {product}: error {err:.3e} of the largest entry")
            bound_ms, bound_by = grouped_dw_bounds(G, K, M, N, tiling["variant"], peaks)
            ms = time_ms(kernel)
            rows.append({
                "cell": cell, "product": product, "G": G, "K": K, "M": M, "N": N,
                "route": gd.dw_route(G, K, M, N), "variant": tiling["variant"], "tile": tiling["tile"],
                "P": tiling["P"], "stages": tiling["stages"], "err_over_max": err,
                "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "roofline_pct": 100 * bound_ms / ms,
                "plain_ms": time_ms(lambda: gd.grouped_dw_plain(x, dy, tiling), reps=5),
                "library_ms": time_ms(lambda: torch.bmm(x.transpose(1, 2), dy)),
                "library": "torch.bmm(x^T, dy), f32 (allow_tf32 False): cuBLAS",
            })
            del x, dy, ref, got, again
            torch.cuda.empty_cache()
    return {"phase": "grouped_dw", "card": smi, "rows": rows}


def train_phase(phase, smi, argv, E, iters, per_iteration, T=25, dw_per_update=None):
    """Train through `codebase_tpu_torch.run.main` on the card for at least
    `iters` iterations of E envs (exactly `iters` when every episode runs
    the full T), logging every iteration, and (for the value-based family)
    one eval at the end, with every counter of `utils/profiling`'s registry
    set to 0 just before and read just after. Fails unless every logged loss
    and every parameter is finite and each GRU kernel named in
    `per_iteration` launched at least that often per iteration (and the
    others never); with `dw_per_update`, also unless the f32 weight
    gradients are as `check_linear_dw` says. Returns (GRU launch counts,
    final state)."""
    with tempfile.TemporaryDirectory() as run_dir:
        argv = argv + [
            f"env.time_limit={T}",
            f"env.parallel_envs={E}",
            # the loop stops once env steps exceed total_steps: `iters`
            # iterations of (at most) E*T steps each (one iteration: 1, as
            # the epsilon schedule needs a positive total); log_interval =
            # E*T makes the host loop's chunk one iteration
            f"algorithm.total_steps={max(1, (iters - 1) * E * T)}",
            f"algorithm.eval_interval={(iters - 1) * E * T}",
            # (one iteration: a row after it, however many steps ended early)
            f"algorithm.log_interval={E * T if iters > 1 else 1}",
            "seed=0",
            "device=cuda",
            f"run_dir={run_dir}",
        ]
        torch.cuda.reset_peak_memory_stats()
        profiling.reset_counters()
        rows, state = port_run.main(argv)
        counts = fg.launch_counts()
        linear_launches = gd.launch_counts()
        dw_calls = {key[1:]: n for key, n in profiling.counters().items()
                    if isinstance(key, tuple) and key[0] == "linear/dw"}
        torch.cuda.synchronize()
        RUNS[phase] = (argv[:-1], rows)
    ran = len(state.timings)
    if ran < iters:
        raise AssertionError(f"{phase}: expected at least {iters} train iterations, ran {ran}")
    if not rows:
        raise AssertionError(f"{phase}: results.csv was not written")
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase}: losses not finite: {losses}")
    if not all(torch.isfinite(p).all() for p in state.model.param_leaves()):
        raise AssertionError(f"{phase}: parameters not finite after training")
    for k, v in counts.items():
        if v < per_iteration.get(k, 0) * ran or (k not in per_iteration and v):
            raise AssertionError(f"{phase}: launches {counts} over {ran} iterations; expected {per_iteration}")
    if dw_per_update is not None:
        check_linear_dw(phase, dw_calls, linear_launches, int(unit_values(state.updates, 1)[0]), dw_per_update)
    steady = state.timings[1:]
    emit({
        "phase": phase, "card": smi, "argv": argv[:-1],
        "iterations": ran, "env_steps": state.env_steps, "updates": state.updates,
        "launches": counts,
        "launches_per_iteration_with_eval": {k: v / ran for k, v in counts.items()},
        # the f32 weight gradients (`ops/grouped_dw.py`), counted: calls by
        # route and shape (G, K, M, N), and their kernels' launches
        "linear_dw_calls": [{"route": route, "shape": list(shape), "calls": n}
                            for (route, shape), n in sorted(dw_calls.items())],
        "linear_launches": linear_launches,
        "iteration_seconds": [s for _, s in state.timings],
        "env_steps_per_s_each": [n / s for n, s in state.timings],
        "env_steps_per_s_after_first": sum(n for n, _ in steady) / sum(s for _, s in steady) if steady else None,
        "loss": losses,
        "results_columns": list(rows[0].keys()),
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        # how each network's recurrent layers ran (`RNNSpec.route`)
        "gru_route": {n: getattr(m.spec, "route", "mlp") for n, m in state.model.named_children() if hasattr(m, "spec")},
    })
    return counts, state


def check_linear_dw(phase, calls, launches, updates, per_update) -> None:
    """The f32 weight gradients of `updates` updates, as counted: exactly
    `per_update` an update on the kernel route and none to cuBLAS
    (`calls`: {(route, (G, K, M, N)): calls}), and the kernels' launches
    (`launches`, `grouped_dw.launch_counts()`) one a weight gradient, with
    a reduction for each whose split (`grouped_dw_tiling`'s P at the shape
    counted) is more than one."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    kernel = {shape: n for (route, shape), n in calls.items() if route == "kernel"}
    split = sum(n for shape, n in kernel.items() if gd.grouped_dw_tiling(*shape, sms)["P"] > 1)
    if (not updates or sum(kernel.values()) != per_update * updates or len(kernel) != len(calls)
            or launches != {"dw": sum(kernel.values()), "reduce": split}):
        raise AssertionError(f"{phase}: f32 weight gradients {calls} and launches {launches} over {updates} "
                             f"updates; expected {per_update} an update, all on the kernel route")


def gate_train_phase(phase, smi, name, iters):
    """`train_phase` on a recurrent gate's config (`gate.RNN_GATES`: the
    preset, the gate's overrides, its 10 envs), with updates from the first
    iteration on (`training_start=0`). Fails unless the GRU kernels launched
    exactly as the config says: IDQN-RNN 25 forwards (z16) a rollout and
    each eval (o), and 2 forwards (online and target, z17) and 1 of each
    backward kernel an update (10 an iteration once the replay holds a
    batch of 32 episodes); MAPPO-RNN 35 forwards (25 at z16, 9 at z18, 1 at
    z19) and 8 of each backward kernel an iteration. IDQN-RNN's three f32
    weight gradients an update take the kernels (`check_linear_dw`)."""
    g = port_gate.GATES[name]
    argv = [f"+algorithm={g.algo}", *g.overrides] + (["algorithm.training_start=0"] if g.algo == "idqn" else [])
    E = int(port_gate._last(g.overrides, "env.parallel_envs", 10))
    dqn = g.algo == "idqn"
    # the least launches an iteration (IDQN's backward kernels: none before
    # the replay holds a batch); the exact counts are checked below
    least = {"fwd": 25, "bwd": 0, "dw": 0, "reduce": 0} if dqn else {"fwd": 35, "bwd": 8, "dw": 8, "reduce": 8}
    counts, state = train_phase(phase, smi, argv, E=E, iters=iters, per_iteration=least,
                                dw_per_update=3 if dqn else None)
    ran, updates = len(state.timings), int(unit_values(state.updates, 1)[0])
    per_update = {"bwd": 1, "dw": 1, "reduce": 1} if dqn else {"bwd": 8, "dw": 8, "reduce": 8}
    rollout_and_evals = counts["fwd"] - 2 * updates if dqn else counts["fwd"] - 35 * ran
    if (not updates or any(counts[k] != n * updates for k, n in per_update.items())
            or (dqn and (rollout_and_evals < 25 * ran or rollout_and_evals % 25)) or (not dqn and rollout_and_evals)):
        raise AssertionError(f"{phase}: launches {counts} over {ran} iterations and {updates} updates")
    emit({"phase": f"{phase}_launches", "gate": name, "iterations": ran, "updates": updates, "launches": counts,
          "per_update": per_update, "forwards_an_update": 2 if dqn else 10})
    return counts


class MaskAudit:
    """Wraps the episode collector in the train modules: for every rollout,
    counts on the card the actions taken on filled steps that the mask of
    their step forbade, the valid actions per agent and filled step, and
    the mean episode length. `report()` holds the last rollout of `n_envs`
    envs (the training one) and the invalid count over every rollout. The
    audit runs inside the timed train iteration; the QMIX phase times it
    apart (`audit_ms`)."""

    def __init__(self, modules, n_envs):
        self.modules, self.n_envs, self.calls = modules, n_envs, []

    def __enter__(self):
        self.collect = self.modules[0].collect_episodes
        for m in self.modules:
            m.collect_episodes = self
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.collect_episodes = self.collect

    def __call__(self, env, policy, carry, generator, n_envs, *args, **kwargs):
        steps = []

        def counted(*a):
            steps.append(1)
            return policy(*a)

        rollout, carry = self.collect(env, counted, carry, generator, n_envs, *args, **kwargs)
        audit = audit_rollout(rollout.action_mask, rollout.actions, rollout.filled)
        audit["policy_steps"] = len(steps)  # T, or fewer where the early exit stopped
        opt = kwargs.get("early_exit", args[2] if len(args) > 2 else "auto")
        audit["early_exit_on"] = (n_envs >= 512 and env.early_termination_possible) if opt == "auto" else bool(opt)
        self.calls.append((n_envs, audit))
        return rollout, carry

    def report(self) -> dict:
        trained = [a for n, a in self.calls if n == self.n_envs]
        if not trained:  # the train modules no longer reach the collector through the wrapped name
            raise AssertionError(f"MaskAudit saw no rollout of {self.n_envs} envs ({len(self.calls)} in all)")
        last = trained[-1]
        return {**{k: float(v) for k, v in last.items()}, "rollouts": len(self.calls),
                "invalid_all_rollouts": int(sum(a["invalid"] for _, a in self.calls))}


def audit_rollout(mask, actions, filled) -> dict:
    """mask (T+1, E, N, A), actions (T, E, N), filled (T, E), time-major:
    each action against the mask of the observation it was taken from."""
    taken = mask[:-1].gather(-1, actions.unsqueeze(-1)).squeeze(-1)  # (T, E, N)
    cells = (filled > 0)[..., None].expand_as(taken)
    return {"invalid": ((taken == 0) & cells).sum(), "agent_steps": cells.sum(),
            "valid_actions_per_step": (mask[:-1].sum(-1) * cells).sum() / cells.sum(),
            "mean_episode_length": filled.sum(0).mean()}


def smaclite_phase(phase, smi, argv, E, iters, per_iteration, modules, T=60):
    """A train phase on SMAClite under a `MaskAudit`: fails if any action
    of any rollout left its mask. `policy_steps` is the number of steps the
    last training rollout took: T, or fewer under the early exit."""
    with MaskAudit(modules, E) as audit:
        counts, state = train_phase(phase, smi, argv, E=E, iters=iters, per_iteration=per_iteration, T=T)
    report = audit.report()
    if report["invalid"] or report["invalid_all_rollouts"]:
        raise AssertionError(f"{phase}: actions outside the mask: {report}")
    emit({"phase": f"{phase}_masks", **report})
    return counts, state


def early_exit_cost(phase, smi, argv, E, T, state) -> None:
    """Rollouts of the phase's trained QMIX policy (epsilon 0.05) with the
    early exit on and off, in turns (on, off, on, off), each from a caller's
    generator seeded alike: fails unless the rollouts and the caller's next
    draw are identical. Reports each rollout's host-clock seconds (ending
    in a device sync) and steps, and the time a step took with and without
    the per-step `any(running)` sync."""
    env, _ = port_run.build_envs(load_config(argv + [f"env.time_limit={T}", f"env.parallel_envs={E}"]))
    policy = state.model.policy(0.05)
    seconds, runs = {True: [], False: []}, {}
    for early in (True, False, True, False):
        gen = torch.Generator(device="cuda").manual_seed(7)
        steps = []

        def counted(*a):
            steps.append(1)
            return policy(*a)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout, _ = port_vector.collect_episodes(env, counted, state.model.critic.init_hiddens(E), gen, E, T,
                                                  early_exit=early)
        torch.cuda.synchronize()
        seconds[early].append(time.perf_counter() - t0)
        runs[early] = (rollout, torch.rand((4,), generator=gen, device="cuda"), len(steps))
    (on, next_on, steps_on), (off, next_off, steps_off) = runs[True], runs[False]
    same = [f for f in ("obs", "actions", "rewards", "stat_rewards", "dones", "filled", "action_mask")
            if torch.equal(getattr(on, f), getattr(off, f))]
    if len(same) != 7 or not torch.equal(next_on, next_off) or steps_off != T:
        raise AssertionError(f"{phase}: early exit on/off differ: equal fields {same}, next draw equal "
                             f"{torch.equal(next_on, next_off)}, steps {steps_on} / {steps_off}")
    emit({"phase": phase, "card": smi, "envs": E, "time_limit": T, "steps_on": steps_on, "steps_off": steps_off,
          "seconds_on": seconds[True], "seconds_off": seconds[False],
          "ms_per_step_on": [1e3 * t / steps_on for t in seconds[True]],
          "ms_per_step_off": [1e3 * t / steps_off for t in seconds[False]],
          "identical_rollouts_and_next_draw": True})


def mmm2_report(state, nets) -> None:
    """Fails unless every GRU network of an MMM2 phase holds the 10 allies'
    shared weights in bf16 on the wide kernels' route."""
    got = [(n.n_agents, n.n_groups, n.spec.hidden_size, n.spec.compute_dtype, n.spec.route) for n in nets]
    if any(g != (10, 1, 512, "bfloat16", "kernel_wide") for g in got):
        raise AssertionError(f"MMM2 networks (agents, groups, H, dtype, route): {got}")
    emit({"phase": "mmm2_networks", "agents_groups_hidden_dtype_route": got})


def check_target_refresh(state, tau=200) -> None:
    """The MAPPO target critic after the run: it holds the critic's params
    exactly when the last iteration began at an env-step count that is a
    multiple of tau (the reference's rule, tested before the count
    advances); every iteration of 8192 envs x t_max 25 steps begins at a
    multiple of 204,800, so then it is refreshed every iteration."""
    start = state.env_steps - state.timings[-1][0]
    target, critic = state.target_critic.param_leaves(), state.model.critic.param_leaves()
    same = all(torch.equal(t, c) for t, c in zip(target, critic))
    if same != (start % tau == 0) or not all(torch.isfinite(t).all() for t in target):
        raise AssertionError(f"train_mappo: target critic equal to the critic: {same}; last iteration began at "
                             f"{start} env steps (tau {tau})")
    emit({"phase": "train_mappo_target", "last_iteration_start": start, "target_equals_critic": same,
          "steps_per_iteration": [n for n, _ in state.timings]})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _equal(x, y) -> bool:
    if x is None or isinstance(x, str):
        return x == y
    return torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _policy_and_carry(state, acfg, n):
    """The evaluation policy of a train state and its initial carry for n
    envs: epsilon-greedy at eps_evaluation (DQN family), else the actor."""
    if hasattr(state, "buffer"):
        return state.model.policy(float(acfg.eps_evaluation)), state.model.critic.init_hiddens(n)
    return state.model.policy(), state.model.actor.init_hiddens(n)


def eval_returns(env, state, acfg, T, n=100, seed=1):
    """(n, N) returns of n episodes of the state's evaluation policy from a
    generator seeded `seed`: the eval of 100 episodes, the GRU at (o)."""
    policy, carry = _policy_and_carry(state, acfg, n)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rollout, _ = port_vector.collect_episodes(env, policy, carry, gen, n, T)
    return rollout.episode_returns


def resume_phase(phase, smi, argv, E, per_iteration, run_dir, T=25, rtol=1e-6):
    """Run A trains at full width through `run.main` for 3 iterations,
    with a checkpoint after the second (save_interval = 1.5*E*T) and one at
    the end;
    run B (another run dir) resumes from A's first checkpoint and trains on
    to the same end, with the launch counters set to 0 just before and read
    just after. Fails unless the counters, the replay with `pos` and the
    generator state are equal exactly, and the last results.csv row's loss,
    the eval returns of both final states and every other float leaf of the
    state (parameters, target, Adam moments, moments) agree to rtol 1e-6
    (tests/test_infra.py:111); prints the largest difference and whether the
    two states are bitwise equal. Then times a save and a load of B's state
    at full width. Returns (run A's dir, B's launch counts)."""
    common = argv + [
        f"env.time_limit={T}", f"env.parallel_envs={E}", f"algorithm.total_steps={2 * E * T}",
        # a row after every iteration (episodes that end early leave an
        # iteration short of E*T steps)
        f"algorithm.eval_interval={2 * E * T}", f"algorithm.log_interval={E * T // 2}",
        # iterations of at most E*T (filled) env steps: a save once 1.5*E*T
        # steps have passed falls after iteration 2, and iteration 3 alone
        # does not reach the next, so the run ends with its final save
        f"algorithm.save_interval={3 * E * T // 2}", "seed=0", "device=cuda",
    ]
    a_dir, b_dir = run_dir / f"{phase}_a", run_dir / f"{phase}_b"
    rows_a, state_a = port_run.main(common + [f"run_dir={a_dir}"])
    saved = sorted(a_dir.glob("checkpoints/model_s*.msgpack"), key=lambda p: int(p.stem.split("_s")[-1]))
    first = int(saved[0].stem.split("_s")[-1])
    if first != sum(n for n, _ in state_a.timings[:2]) or len(saved) != 2:
        raise AssertionError(f"{phase}: checkpoints {[p.name for p in saved]}; expected one after iteration 2 "
                             f"({sum(n for n, _ in state_a.timings[:2])} steps) and one at the end")
    torch.cuda.synchronize()
    fg.reset_launch_counts()
    rows_b, state_b = port_run.main(common + [f"run_dir={b_dir}", f"resume={saved[0]}"])
    counts = fg.launch_counts()
    torch.cuda.synchronize()
    ran = len(state_b.timings)
    for k, v in counts.items():
        if v < per_iteration.get(k, 0) * ran or (k not in per_iteration and v):
            raise AssertionError(f"{phase}: resumed launches {counts} over {ran} iterations; expected {per_iteration}")

    fa, fb = _flat(state_a.state_dict()), _flat(state_b.state_dict())
    exact = [k for k in fa if k.startswith(("/buffer", "/generator")) or k in (
        "/env_steps", "/updates", "/last_target_update") or (k.startswith("/opt_state") and k.endswith("/count"))]
    unequal = [k for k in exact if not _equal(fa[k], fb[k])]
    diffs, outside, bitwise = {}, [], True
    for k in fa:
        if k in exact or fa[k] is None:
            continue
        x, y = fa[k].double(), fb[k].double()
        diffs[k] = (x - y).abs().max().item() if x.numel() else 0.0
        bitwise &= torch.equal(fa[k], fb[k])
        if not torch.allclose(y, x, rtol=rtol, atol=0.0):
            outside.append(k)
    env, _ = port_run.build_envs(load_config(common))
    acfg = load_config(common).algorithm
    ret_a = eval_returns(env, state_a, acfg, T)
    torch.cuda.synchronize()
    fg.reset_launch_counts()
    ret_b = eval_returns(env, state_b, acfg, T)
    eval_counts = fg.launch_counts()
    if eval_counts["fwd"] != 25 or sum(eval_counts.values()) != 25:
        raise AssertionError(f"{phase}: the eval of 100 episodes launched {eval_counts}; expected 25 forwards at (o)")
    loss_a, loss_b = float(rows_a[-1]["loss"]), float(rows_b[-1]["loss"])
    bitwise &= torch.equal(ret_a, ret_b) and loss_a == loss_b
    if (unequal or outside or not torch.allclose(ret_b, ret_a, rtol=rtol, atol=0.0)
            or abs(loss_b - loss_a) > rtol * abs(loss_a) or rows_a[-1]["environment_steps"] != rows_b[-1]["environment_steps"]):
        raise AssertionError(f"{phase}: resumed run differs: exact fields {unequal}, outside rtol {rtol}: {outside}, "
                             f"loss {loss_a} / {loss_b}, eval returns equal {torch.equal(ret_a, ret_b)}")

    # a save and a load of the resumed state at full width, timed
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in fb.items()}
    path = run_dir / f"{phase}_timed.msgpack"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = save_checkpoint(path, state_b.state_dict())
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state_b.load_state_dict(load_checkpoint(path), path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    after = _flat(state_b.state_dict())
    if not all(_equal(v, after[k]) for k, v in before.items()):
        raise AssertionError(f"{phase}: a save and load of the state changed it")
    path.unlink()
    emit({
        "phase": phase, "card": smi, "argv": common, "resumed_from": saved[0].name, "resumed_at_step": first,
        "final_step": state_b.env_steps, "updates": state_b.updates, "iterations_after_resume": ran,
        "launches_resumed_iterations": counts, "launches_eval": eval_counts,
        "exact_fields_equal": len(exact), "float_leaves_within_rtol": len(diffs), "rtol": rtol,
        "max_abs_diff": max(diffs.values()), "max_abs_diff_leaf": max(diffs, key=diffs.get),
        "bitwise_equal": bitwise, "last_row_loss": [loss_a, loss_b],
        "eval_mean_return": [ret_a.sum(-1).mean().item(), ret_b.sum(-1).mean().item()],
        "checkpoint_bytes": nbytes, "save_seconds": save_s, "load_seconds": load_s,
        "replay_bytes": sum(v.numel() * v.element_size() for k, v in fb.items()
                            if k.startswith("/buffer") and isinstance(v, torch.Tensor)),
    })
    del state_a, state_b
    return a_dir, counts


def eval_phase(phase, smi, run_dir, out_dir, video_frames=0):
    """`codebase_tpu_torch.eval.main` on a run's directory, on the card,
    with the launch counters set to 0 before and read after: 100 episodes
    of T=25 take exactly 25 forward launches at (o), and a video of
    `video_frames` frames one more each at (y). With a video, fails unless
    the file exists and its frames are 128x128x3 uint8 (LBF 8x8, 16-pixel
    cells). Returns the launch counts."""
    argv = [f"path={run_dir}", "device=cuda"]
    if video_frames:
        argv += [f"video_frames={video_frames}", f"video_path={out_dir / 'eval.mp4'}"]
    torch.cuda.synchronize()
    fg.reset_launch_counts()
    t0 = time.perf_counter()
    returns = port_eval.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = fg.launch_counts()
    expected = {"fwd": 25 + video_frames}
    if any(counts[k] != expected.get(k, 0) for k in counts) or returns.shape != (100, 2) \
            or not math.isfinite(float(returns.sum())):
        raise AssertionError(f"{phase}: launches {counts} (expected {expected}), returns {returns.shape}")
    out = {"phase": phase, "card": smi, "argv": argv, "episodes": returns.shape[0], "launches": counts,
           "mean_return": float(returns.sum(-1).mean()), "std_return": float(returns.sum(-1).std()),
           "seconds": seconds}
    if video_frames:
        written = [p for p in (out_dir / f"eval{ext}" for ext in (".mp4", ".gif", ".npz")) if p.exists()]
        if len(written) != 1:
            raise AssertionError(f"{phase}: expected one video file, found {written}")
        if written[0].suffix == ".npz":
            frames = np.load(written[0])["frames"]
            shape, dtype = frames.shape, str(frames.dtype)
        else:  # encoded by imageio: the frames are those of render_frame
            env, _ = port_run.build_envs(load_config(["env.name=lbforaging:Foraging-8x8-2p-3f-v3", "env.time_limit=25"]))
            frame = env.render_frame(env.reset_batch(torch.Generator(device="cuda"), 1)[0], 0)
            shape, dtype = (video_frames,) + frame.shape, str(frame.dtype)
        if shape != (video_frames, 128, 128, 3) or dtype != "uint8":
            raise AssertionError(f"{phase}: frames {shape} {dtype}; expected ({video_frames}, 128, 128, 3) uint8")
        out.update({"file": written[0].name, "encoding": written[0].suffix[1:], "bytes": written[0].stat().st_size,
                    "frames": list(shape), "frame_dtype": dtype, "video_launches_at_y": counts["fwd"] - 25})
    emit(out)
    return counts


def preemption_phase(phase, smi, run_dir):
    """`python -m codebase_tpu_torch.run ... device=cuda resume=auto` in a
    subprocess on a small LBF config (recurrent IDQN, 256 envs): SIGTERM
    after the first results.csv row must give rc 0, the log line and a
    checkpoint; the relaunch must log `Resumed from ... at step {saved}`
    and exit 0. Every process it starts is stopped."""
    run_dir.mkdir(parents=True)
    argv = ["+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "env.time_limit=25",
            "env.parallel_envs=256", "algorithm.model.use_rnn=true", "algorithm.batch_size=64",
            "algorithm.buffer_size=1024", *DQN_ARGV, "algorithm.log_interval=6400", "algorithm.eval_interval=6400",
            "seed=0", "device=cuda", "resume=auto", f"run_dir={run_dir}"]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}

    def launch(total_steps):
        return subprocess.Popen([sys.executable, "-m", "codebase_tpu_torch.run", *argv,
                                 f"algorithm.total_steps={total_steps}"], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, cwd=run_dir)

    t0 = time.perf_counter()
    p = launch(10**9)
    try:
        while not (run_dir / "results.csv").exists():
            if p.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError(f"{phase}: the run wrote no results.csv row: {p.communicate()[0][-3000:]}")
            time.sleep(0.2)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    ckpts = sorted(run_dir.glob("checkpoints/model_s*.msgpack"))
    if p.returncode != 0 or "SIGTERM received: checkpointing at step" not in out or not ckpts:
        raise AssertionError(f"{phase}: rc {p.returncode}, checkpoints {ckpts}: {out[-3000:]}")
    saved = max(int(c.stem.split("_s")[-1]) for c in ckpts)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = launch(saved + 6400)
    try:
        out2, _ = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    line = f"Resumed from {run_dir}/checkpoints/model_s{saved}.msgpack at step {saved}"
    if p.returncode != 0 or line not in out2:
        raise AssertionError(f"{phase}: relaunch rc {p.returncode}, expected {line!r}: {out2[-3000:]}")
    emit({"phase": phase, "card": smi, "argv": argv, "saved_step": saved, "sigterm_rc": 0, "relaunch_rc": 0,
          "resumed": line, "first_run_seconds": first_s, "relaunch_seconds": time.perf_counter() - t0})

class GroupWatch:
    """While the search CLI runs in this process: for each group that
    `sweep.run_vmapped_multiseed` trains, the launch counts (set to 0 just
    before the group and read just after), its config, units and variants,
    its unit dirs, the final train state (from `sweep.build_group`) and its
    seconds."""

    def __enter__(self):
        self.groups, self._run, self._build = [], port_sweep.run_vmapped_multiseed, port_sweep.build_group
        port_sweep.run_vmapped_multiseed, port_sweep.build_group = self.run, self.build
        return self

    def __exit__(self, *exc):
        port_sweep.run_vmapped_multiseed, port_sweep.build_group = self._run, self._build

    def build(self, cfg, seeds, hyper_variants=None, shard=None):
        self.built = self._build(cfg, seeds, hyper_variants, shard)
        return self.built

    def run(self, cfg, seeds, run_dir, hyper_variants=None):
        torch.cuda.synchronize()
        fg.reset_launch_counts()
        t0 = time.perf_counter()
        dirs = self._run(cfg, seeds, run_dir, hyper_variants)
        torch.cuda.synchronize()
        self.groups.append({"cfg": cfg, "seeds": list(seeds), "run_dir": Path(run_dir), "units": self.built[0],
                            "state": self.built[1], "dirs": dirs,
                            "variants": hyper_variants or [{}], "counts": fg.launch_counts(),
                            "seconds": time.perf_counter() - t0})
        return dirs


def check_units(phase, group, key, expected_counts) -> dict:
    """One group of a sweep: a `config.yaml` per unit whose `seed` and
    `algorithm.<key>` are the unit's, a results.csv with a row after every
    chunk and finite losses, finite parameters, and launch counts equal to
    `expected_counts(iterations, rows)` (a one-unit run's at any U).
    Returns the group's report."""
    state, units, variants = group["state"], group["units"], group["variants"]
    U = len(units)
    if len(group["dirs"]) != U:
        raise AssertionError(f"{phase}: {len(group['dirs'])} unit dirs for {U} units")
    rows = []
    for (vi, seed), d in zip(units, group["dirs"]):
        cfg = yaml.safe_load((d / "config.yaml").read_text())
        want = variants[vi].get(port_sweep.VMAPPABLE_KEYS[key])
        got = cfg
        for part in key.split("."):
            got = got[part]
        if cfg["seed"] != seed or (want is not None and float(got) != want):
            raise AssertionError(f"{phase}: {d}/config.yaml has seed {cfg['seed']} and {key} {got}; unit is "
                                 f"seed {seed}, {variants[vi]}")
        with open(d / "results.csv") as f:
            unit_rows = list(csv.DictReader(f))
        losses = [float(r["loss"]) for r in unit_rows if r.get("loss")]
        if not unit_rows or not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: {d}/results.csv rows {len(unit_rows)}, losses {losses}")
        rows.append(len(unit_rows))
    if len(set(rows)) != 1:
        raise AssertionError(f"{phase}: units wrote different row counts {rows}")
    if not all(torch.isfinite(p).all() for p in state.model.param_leaves()):
        raise AssertionError(f"{phase}: parameters not finite after training")
    iters = len(state.timings)
    expected = expected_counts(iters, rows[0])
    if any(group["counts"][k] != expected.get(k, 0) for k in group["counts"]):
        raise AssertionError(f"{phase}: launches {group['counts']} over {iters} iterations and {rows[0]} rows; "
                             f"expected {expected}")
    steady = state.timings[1:]
    return {"units": U, "iterations": iters, "rows_per_unit": rows[0], "launches": group["counts"],
            "env_steps_per_unit": unit_values(state.env_steps, U).tolist()[:4] + ["..."],
            "iteration_seconds": [t for _, t in state.timings],
            "env_steps_per_s_summed_over_units_after_first": sum(n for n, _ in steady) / sum(t for _, t in steady),
            "seconds": group["seconds"]}


def run_search(argv, spec, out_dir) -> list:
    """`search.main` in this process (the `vmapped` mode) on a spec written
    to `out_dir`, under a `GroupWatch`; returns the groups."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "spec.yaml").write_text(yaml.safe_dump(spec, sort_keys=False))
    with GroupWatch() as watch:
        port_search.main(["run", "--config", str(out_dir / "spec.yaml"), *argv, "--output", str(out_dir / "out"),
                          "--yes"])
    return watch.groups


def sweep_idqn_phase(phase, smi, out_dir):
    """The slice's path: `search run --seeds 16 vmapped --yes` on recurrent
    IDQN (the preset's 32 envs, replay of 10000 episodes and 32 updates a
    collect) on Foraging-8x8-2p-3f-v3, lr [3e-4, 1e-3] x 16 seeds (32 units,
    one group) x batch size [32, 64] (two groups), training_start 0, a row
    after every iteration and 3-4 iterations. Each group must launch, per
    train iteration, what one unit's run launches: 25 forwards (rollout, at
    z1), 2 x 32 in the updates (z2 or z3) and 32 of each backward kernel, the
    batch-64 group from its second iteration (the replay holds 32 episodes
    a unit after the first), and 25 forwards (z4) an eval of 100 episodes a
    unit. Then one unit's `run.main` with the same settings (seed 0, lr
    3e-4, batch 32): its launches follow the same rule, and its env-steps/s
    stands beside the group's. Returns (the groups, the first group's launch
    counts)."""
    E, T = 32, 25
    spec = {"+algorithm": "idqn", "env.name": "lbforaging:Foraging-8x8-2p-3f-v3", "env.time_limit": T,
            "algorithm.model.use_rnn": True, "algorithm.training_start": 0,
            "algorithm.total_steps": 1800, "algorithm.eval_interval": 400, "device": "cuda",
            "algorithm.lr": [3.0e-4, 1.0e-3], "algorithm.batch_size": [32, 64]}

    def expected(B):
        def counts(iters, rows):
            trained = sum(1 for i in range(1, iters + 1) if E * i >= B)
            n = 32 * trained
            return {"fwd": T * iters + 2 * n + 25 * rows, "bwd": n, "dw": n, "reduce": n}
        return counts

    groups = run_search(["--seeds", "16", "vmapped"], spec, out_dir)
    if len(groups) != 2:
        raise AssertionError(f"{phase}: {len(groups)} groups; expected 2 (batch 32 and 64)")
    reports = {}
    for g in groups:
        B = int(g["cfg"].algorithm.batch_size)
        reports[f"batch_{B}"] = check_units(phase, g, "algorithm.lr", expected(B))
    # one unit through run.main, the same settings
    with tempfile.TemporaryDirectory() as run_dir:
        argv = ["+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", f"env.time_limit={T}",
                "algorithm.model.use_rnn=true", "algorithm.training_start=0", "algorithm.total_steps=1800",
                "algorithm.eval_interval=400", "algorithm.log_interval=400", "algorithm.lr=3.0e-4",
                "algorithm.batch_size=32", "seed=0", "device=cuda", f"run_dir={run_dir}"]
        torch.cuda.synchronize()
        fg.reset_launch_counts()
        rows, solo = port_run.main(argv)
        solo_counts = fg.launch_counts()
    want = expected(32)(len(solo.timings), len(rows))
    if any(solo_counts[k] != want.get(k, 0) for k in solo_counts):
        raise AssertionError(f"{phase}: the one-unit run launched {solo_counts}; expected {want}")
    steady = solo.timings[1:]
    emit({"phase": phase, "card": smi, "spec": spec, "seeds": 16, "groups": reports,
          "one_unit_run": {"argv": argv[:-1], "iterations": len(solo.timings), "rows": len(rows),
                           "launches": solo_counts,
                           "env_steps_per_s_after_first": sum(n for n, _ in steady) / sum(t for _, t in steady)}})
    total = {k: sum(g["counts"][k] for g in groups) for k in groups[0]["counts"]}
    return groups, total


def unit_parity_phase(phase, smi, group, picks, family=port_dqn):
    """Units `picks` of a sweep group's final state, each rebuilt as a
    one-unit state from its slices (params, target, Adam moments and count,
    counters, return moments): one update on the same sampled batch both
    ways. Fails unless each unit's loss and every gradient agree to rtol
    2e-4 (atol 1e-6 of the leaf's largest entry, at least 1e-6, as the CPU
    parity tests hold gradients), and the
    params after the Adam step to rtol 2e-4 (atol 5e-2 * lr: an entry whose
    gradient cancels keeps only its leading digits, and Adam turns that into
    a step of up to lr). The group's GRU runs at G = U*N, the one unit's at
    G = N, so gradients are summed in another order."""
    cfg, state, units, variants = group["cfg"], group["state"], group["units"], group["variants"]
    U, acfg, T = len(units), cfg.algorithm, int(cfg.env.time_limit)
    env, _ = port_run.build_envs(cfg)
    B = int(acfg.batch_size)
    one = {k: (v[0] if v is not None else None)
           for k, v in replay_sample_many(state.buffer, torch.Generator(device="cuda").manual_seed(5), B, 1).items()}
    params = state.model.param_leaves()
    losses, _ = state.model.unit_losses(state.target, batch_to_reference_layout(one, U), state.ret_rms)
    grads = torch.autograd.grad(losses.sum(), params)
    solos = []
    for u in picks:
        vi, seed = units[u]
        solo = family.build_train_functions(env, env, acfg, T, torch.device("cuda"), hypers=[variants[vi]])[0](seed)
        with torch.no_grad():
            for src_list, dst_list in ((params, solo.model.param_leaves()),
                                       (state.target.param_leaves(), solo.target.param_leaves()),
                                       (state.opt.mu, solo.opt.mu), (state.opt.nu, solo.opt.nu)):
                for src, dst in zip(src_list, dst_list):
                    dst.copy_(src.reshape(U, -1)[u].reshape(dst.shape))
        solo.opt.count = int(unit_values(state.opt.count, U)[u])
        for f in ("env_steps", "updates", "last_target_update"):
            setattr(solo, f, int(unit_values(getattr(state, f), U)[u]))
        rms = state.ret_rms
        solo.ret_rms = RunningMeanStd(rms.mean[u].clone(), rms.var[u].clone(), rms.count[u].clone())
        batch = batch_to_reference_layout({k: (v[u * B:(u + 1) * B] if v is not None else None)
                                           for k, v in one.items()})
        loss, _ = solo.model.unit_losses(solo.target, batch, solo.ret_rms)
        solo_grads = torch.autograd.grad(loss.sum(), solo.model.param_leaves())
        solos.append((u, solo, loss, solo_grads))
    state.opt.step(grads)
    report = {}
    for u, solo, loss, solo_grads in solos:
        solo.opt.step(solo_grads)
        lr = float(unit_values(state.opt.lr, U, np.float64)[u])
        g_diff, g_bad, p_diff, p_bad = 0.0, [], 0.0, []
        for i, (g, sg, p, sp) in enumerate(zip(grads, solo_grads, params, solo.model.param_leaves())):
            gu, pu = g.reshape(U, -1)[u], p.reshape(U, -1)[u]
            g_diff = max(g_diff, (gu - sg.reshape(-1)).abs().max().item())
            p_diff = max(p_diff, (pu - sp.reshape(-1)).abs().max().item())
            if not torch.allclose(gu, sg.reshape(-1), rtol=2e-4, atol=1e-6 * max(1.0, sg.abs().max().item())):
                g_bad.append(i)
            if not torch.allclose(pu, sp.reshape(-1), rtol=2e-4, atol=5e-2 * lr):
                p_bad.append(i)
        l_group, l_solo = losses[u].item(), loss.item()
        if g_bad or p_bad or abs(l_group - l_solo) > 2e-4 * abs(l_solo) or not math.isfinite(l_solo):
            raise AssertionError(f"{phase}: unit {u} differs from its one-unit update: loss {l_group} / {l_solo}, "
                                 f"gradient leaves outside {g_bad}, params after Adam outside {p_bad}")
        report[f"unit_{u}"] = {"seed": units[u][1], "variant": variants[units[u][0]], "loss_group": l_group,
                               "loss_one_unit": l_solo, "loss_rel_diff": abs(l_group - l_solo) / max(abs(l_solo), 1e-30),
                               "max_abs_grad_diff": g_diff, "max_abs_param_diff_after_adam": p_diff}
    emit({"phase": phase, "card": smi, "units": U, "batch_per_unit": B, "rtol": 2e-4, **report})


def sweep_mappo_phase(phase, smi, out_dir):
    """`vmapped` MAPPO with the actor and the critic recurrent on
    Foraging-8x8-2p-3f-v3, gamma [0.99, 0.95] x 16 seeds (32 units, one
    group) at the preset's 10 envs a unit: z5 in the rollout, z6 in the
    update and z7 for the target critic; per iteration one unit's 35
    forwards and 8 of each backward kernel (the rows log the training
    rollout, no eval). Returns the group's launch counts."""
    spec = {"+algorithm": "mappo", "env.name": "lbforaging:Foraging-8x8-2p-3f-v3", "env.time_limit": 25,
            "algorithm.model.actor.use_rnn": True, "algorithm.model.critic.use_rnn": True,
            "algorithm.total_steps": 500, "algorithm.eval_interval": 250, "device": "cuda",
            "algorithm.gamma": [0.99, 0.95]}
    (group,) = run_search(["--seeds", "16", "vmapped"], spec, out_dir)
    report = check_units(phase, group, "algorithm.gamma",
                         lambda iters, rows: {"fwd": 35 * iters, "bwd": 8 * iters, "dw": 8 * iters, "reduce": 8 * iters})
    emit({"phase": phase, "card": smi, "spec": spec, "seeds": 16, **report})
    return group["counts"]


def sweep_qmix_phase(phase, smi, out_dir):
    """`vmapped` QMIX (MLP [64, 64], no GRU launch) with return
    standardisation, tau [100, 200] x 4 seeds (8 units, one group): the
    mixer's unit axis and the per-unit return moments on the card. Returns
    the group."""
    spec = {"+algorithm": "qmix", "env.name": "lbforaging:Foraging-8x8-2p-3f-v3", "env.time_limit": 25,
            "algorithm.model.layers": "[64,64]", "algorithm.standardise_returns": True,
            "algorithm.training_start": 0, "algorithm.updates_per_collect": 1, "algorithm.buffer_size": 1000,
            "algorithm.total_steps": 1800, "algorithm.eval_interval": 400, "device": "cuda",
            "algorithm.target_update_interval_or_tau": [100, 200]}
    (group,) = run_search(["--seeds", "4", "vmapped"], spec, out_dir)
    report = check_units(phase, group, "algorithm.target_update_interval_or_tau", lambda iters, rows: {})
    rms = group["state"].ret_rms
    if tuple(rms.mean.shape) != (8, 1) or not torch.isfinite(rms.var).all():
        raise AssertionError(f"{phase}: return moments {tuple(rms.mean.shape)}, var finite "
                             f"{bool(torch.isfinite(rms.var).all())}")
    emit({"phase": phase, "card": smi, "spec": spec, "seeds": 4, **report,
          "return_moment_counts": rms.count.tolist()})
    return group


def search_cli_phase(phase, smi, out_dir):
    """`python -m codebase_tpu_torch.search` in subprocesses, each with rc 0:
    `dry_run` on configs/sweeps/sample.yaml (32 combinations at 2 seeds),
    `bayes --budget 2` at a tiny width (MLP IDQN on Foraging-5x5, an lr
    axis of 3), which must write bayes_result.json with the JAX package's
    keys, and `locally --workers 2` on two tiny combinations that share the
    card, each writing its results.csv."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    out_dir.mkdir(parents=True, exist_ok=True)
    tiny = {"+algorithm": "idqn", "env.name": "lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit": 10,
            "env.parallel_envs": 16, "algorithm.model.layers": "[32,32]", "algorithm.training_start": 0,
            "algorithm.batch_size": 8, "algorithm.buffer_size": 64, "algorithm.total_steps": 320,
            "algorithm.eval_interval": 160, "algorithm.log_interval": 160, "algorithm.eval_episodes": 10,
            "device": "cuda"}
    timings = {}

    def cli(name, spec_path, *args):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "codebase_tpu_torch.search", "run", "--config", str(spec_path),
                            *args], env=env, cwd=out_dir, capture_output=True, text=True, timeout=600)
        timings[name] = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"{phase}: {name} rc {p.returncode}: {p.stdout[-2000:]} {p.stderr[-3000:]}")
        return p.stdout

    out = cli("dry_run", root / "codebase_tpu_torch/configs/sweeps/sample.yaml", "--seeds", "2", "dry_run")
    first = out.splitlines()[0]
    count = int(first.split()[2])
    if first != "There are 32 configurations as shown below:" or len(out.splitlines()) != 33:
        raise AssertionError(f"{phase}: dry_run printed {first!r} and {len(out.splitlines())} lines")
    (out_dir / "bayes.yaml").write_text(yaml.safe_dump({**tiny, "algorithm.lr": [1.0e-4, 3.0e-4, 1.0e-3]}))
    cli("bayes", out_dir / "bayes.yaml", "--seeds", "2", "bayes", "--budget", "2", "--output",
        str(out_dir / "bayes"), "--yes")
    result = json.loads((out_dir / "bayes" / "bayes_result.json").read_text())
    if set(result) != {"best", "best_value", "evaluations", "candidates", "metric"} or result["evaluations"] != 2:
        raise AssertionError(f"{phase}: bayes_result.json {result}")
    (out_dir / "locally.yaml").write_text(yaml.safe_dump({**tiny, "algorithm.lr": [1.0e-4, 1.0e-3]}))
    out = cli("locally", out_dir / "locally.yaml", "--seeds", "1", "locally", "--workers", "2", "--yes")
    written = sorted(out_dir.glob("outputs/**/results.csv"))
    if "done: 2/2 succeeded" not in out or len(written) != 2:
        raise AssertionError(f"{phase}: locally printed {out[-500:]!r}; results {written}")
    emit({"phase": phase, "card": smi, "dry_run_count": count, "bayes_result": result,
          "locally_results": len(written), "seconds": timings})


# ------------------------------------------------------ data parallelism
# With one GPU a run over two ranks puts both on it, over gloo (NCCL
# refuses two ranks on one GPU); one rank runs over NCCL.


# a recurrent IDQN and a MAPPO iteration's GRU launches, at least (the
# evals add forwards)
IDQN_LAUNCHES = {"fwd": 25, "bwd": 8, "dw": 8, "reduce": 8}
MAPPO_LAUNCHES = {"fwd": 35, "bwd": 8, "dw": 8, "reduce": 8}


def check_launches(phase, counts: dict, iters: int, per_iteration: dict) -> None:
    """Fail unless each kernel in `per_iteration` launched at least that
    often an iteration over `iters` iterations, and the others never."""
    if any(v < per_iteration.get(k, 0) * iters or (k not in per_iteration and v) for k, v in counts.items()):
        raise AssertionError(f"{phase}: launches {counts} over {iters} iterations; expected {per_iteration} each")


def _per_iteration(times: dict, iters: int) -> dict:
    """`parallel.mesh.collect_times` seconds as ms (and calls) an iteration."""
    return {k: {"ms": s / iters * 1e3, "calls": n / iters} for k, (s, n) in sorted(times.items())}


def compare_rows(phase, rows, ref, rtol=1e-4, atol=1e-6) -> float:
    """A data-parallel run's results.csv rows against the one-rank run's:
    the same columns, `environment_steps` and `updates` equal, episode
    returns and lengths to `atol` (the JAX package's invariant), every other
    column (losses, epsilon) to rtol and atol. Returns the largest relative
    difference of those."""
    if len(rows or []) != len(ref) or not ref:
        raise AssertionError(f"{phase}: {len(rows or [])} rows; the one-rank run wrote {len(ref)}")
    worst = 0.0
    for i, (r, q) in enumerate(zip(rows, ref)):
        if r.keys() != q.keys() or r["environment_steps"] != q["environment_steps"] or r["updates"] != q["updates"]:
            raise AssertionError(f"{phase}: row {i} {r} differs from the one-rank run's {q}")
        for k in r:
            if not r[k] or not q[k] or k in ("environment_steps", "updates"):
                continue
            a, b = float(r[k]), float(q[k])
            returns = "episode_returns" in k or "episode_length" in k
            tol = atol if returns else atol + rtol * abs(b)
            if not abs(a - b) <= tol:
                raise AssertionError(f"{phase}: row {i} {k} {a} against the one-rank run's {b}")
            if not returns and b:
                worst = max(worst, abs(a - b) / abs(b))
    return worst


def params_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in state.model.param_leaves():
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dist_nccl_phase(phase, smi) -> dict:
    """`run.main` on the train phase's argv plus `distributed.devices=1`:
    one NCCL rank on the card (a group of one in this process), every
    collective and draw of the run timed between device syncs. Its rows
    must be the train phase's to rtol 1e-6 (every all-reduce is the
    identity at W=1, so bitwise is expected). Returns the launch counts."""
    argv, ref = RUNS["train"]
    shard = mesh.mesh_from_config({"devices": 1}, "cuda")  # the run joins this group
    times = {}
    mesh.collect_times(times)
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            torch.cuda.synchronize()
            fg.reset_launch_counts()
            rows, state = port_run.main(argv + ["distributed.devices=1", f"run_dir={run_dir}"])
            counts = fg.launch_counts()
        backend, world = torch.distributed.get_backend(), state.shard.world
    finally:
        mesh.collect_times(None)
        mesh.release(shard)
    if backend != "nccl" or world != 1:
        raise AssertionError(f"{phase}: ran over {world} rank(s) on {backend}; expected one NCCL rank")
    worst = compare_rows(phase, rows, ref, rtol=1e-6, atol=1e-6)
    iters = len(state.timings)
    check_launches(phase, counts, iters, IDQN_LAUNCHES)
    emit({"phase": phase, "card": smi, "backend": backend, "world": world, "iterations": iters,
          "rows_equal_bitwise": rows == ref, "max_rel_diff_vs_train": worst, "launches": counts,
          "per_iteration_timed": _per_iteration(times, iters),
          "note": "times of each collective and of the draws, each between device syncs (a timed pass)"})
    return counts


def dist_rank(jobs, base) -> dict:
    """One rank of the two-rank phases (both ranks on GPU 0 over gloo): for
    each job, the launch counters set to 0 just before and read just after,
    the collectives and draws timed, then the rank's summary. A `run` job
    trains through `run.main` in `<base>/<name>_rank<r>`; a `sweep` job
    trains a sweep group through `sweep.run_vmapped_multiseed` (this rank's
    units)."""
    from codebase_tpu_torch.config import Config

    rank = torch.distributed.get_rank()
    out = {}
    for name, kind, args in jobs:
        times = {}
        mesh.collect_times(times)
        torch.cuda.synchronize()
        fg.reset_launch_counts()
        t0 = time.perf_counter()
        if kind == "run":
            run_dir = Path(base) / f"{name}_rank{rank}"
            rows, state = port_run.main(args + [f"run_dir={run_dir}"])
            summary = {"rows": rows, "iterations": len(state.timings), "env_steps": state.env_steps,
                       "updates": state.updates, "params_sha256": params_digest(state),
                       "iteration_seconds": [t for _, t in state.timings], "wrote_files": run_dir.exists()}
        else:
            cfg_dict, seeds, run_dir, variants = args
            with GroupWatch() as watch:
                port_sweep.run_vmapped_multiseed(Config(cfg_dict), seeds, run_dir, variants)
            group = watch.groups[0]
            summary = {"units": group["units"], "iterations": len(group["state"].timings),
                       "dirs": [str(d) for d in group["dirs"]], "params_sha256": params_digest(group["state"])}
            state = group["state"]
        torch.cuda.synchronize()
        summary.update(launches=fg.launch_counts(), seconds=time.perf_counter() - t0,
                       per_iteration_timed=_per_iteration(times, len(state.timings)), rank=rank)
        mesh.collect_times(None)
        out[name] = summary
        del state
        torch.cuda.empty_cache()
    return out


def dist_gloo_phases(smi, tmp, sweep_ref) -> dict:
    """Two gloo ranks on the card, against one rank, in one spawn
    (`parallel.mesh.spawn`, GPUs [0, 0]):

    - dist_idqn_gloo2: the train phase's lane (65536 envs, 32768 a rank,
      batch 1024, 512 rows a rank), with a row after every iteration, a
      checkpoint after iteration 2 and one at the end; against a one-rank
      run of the same argv: equal steps and updates, losses to rtol 1e-4 /
      atol 1e-6, returns to atol 1e-6; params bitwise equal across the
      ranks; only rank 0 wrote files.
    - dist_mappo_gloo2: the train_mappo phase's argv (8192 envs, 4096 a
      rank), held against its rows in the same way.
    - dist_resume: rank 0's checkpoint after iteration 2 resumed at W=1 in
      this process: its rows are the W=2 run's, and its final state the W=2
      final checkpoint's (counters, replay and generator exactly, params to
      rtol 1e-4 / atol 1e-5).
    - dist_sweep: sweep_idqn_rnn's batch-32 group (32 units) sharded over
      the ranks, 16 units each: each rank launches per iteration what one
      unit's run does; units 0 and 31 wrote the unsharded group's rows.
    Returns the launch counts by phase."""
    E, T = 65536, 25
    train_argv, _ = RUNS["train"]
    # a row after every iteration (episodes that end early leave an
    # iteration short of E*T steps), a save after iteration 2 and at the end
    idqn_argv = train_argv + [f"algorithm.log_interval={E * T // 2}", f"algorithm.save_interval={3 * E * T // 2}"]
    ref_idqn, _ = port_run.main(idqn_argv + [f"run_dir={tmp / 'idqn_one_rank'}"])
    mappo_argv, ref_mappo = RUNS["train_mappo"]
    cfg_dict = sweep_ref["cfg"].to_dict()
    cfg_dict["distributed"] = {"devices": 2, "initialize": "auto"}
    jobs = [("idqn", "run", idqn_argv + ["distributed.devices=2"]),
            ("mappo", "run", mappo_argv + ["distributed.devices=2"]),
            ("sweep", "sweep", (cfg_dict, sweep_ref["seeds"], str(tmp / "dist_sweep"), sweep_ref["variants"]))]
    t0 = time.perf_counter()
    ranks = mesh.spawn(dist_rank, 2, "cuda", args=(jobs, str(tmp)), backend="gloo", device_ids=[0, 0])
    spawn_s = time.perf_counter() - t0
    counts = {}
    for name, ref, phase, per_iteration in (("idqn", ref_idqn, "dist_idqn_gloo2", IDQN_LAUNCHES),
                                            ("mappo", ref_mappo, "dist_mappo_gloo2", MAPPO_LAUNCHES)):
        r0, r1 = ranks[0][name], ranks[1][name]
        worst = compare_rows(phase, r0["rows"], ref)
        if r1["rows"] is not None or r1["wrote_files"] or not r0["wrote_files"]:
            raise AssertionError(f"{phase}: rank 1 wrote files or logged rows; only rank 0 may")
        if r0["params_sha256"] != r1["params_sha256"]:
            raise AssertionError(f"{phase}: params differ between the ranks after the last update")
        for r in (r0, r1):
            check_launches(f"{phase} rank {r['rank']}", r["launches"], r["iterations"], per_iteration)
        counts[phase] = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
        emit({"phase": phase, "card": smi, "backend": "gloo", "world": 2, "gpus": [0, 0],
              "iterations": r0["iterations"], "env_steps": r0["env_steps"], "updates": r0["updates"],
              "max_rel_diff_vs_one_rank": worst, "params_bitwise_equal_across_ranks": True,
              "launches_per_rank": [r0["launches"], r1["launches"]],
              "iteration_seconds_per_rank": [r0["iteration_seconds"], r1["iteration_seconds"]],
              "per_iteration_timed_per_rank": [r0["per_iteration_timed"], r1["per_iteration_timed"]],
              "seconds_per_rank": [r0["seconds"], r1["seconds"]], "spawn_seconds_all_jobs": spawn_s,
              "note": "both ranks share one H100 over gloo: no multi-GPU speed"})

    # dist_resume: W=2's checkpoint after iteration 2, resumed at W=1
    saved = sorted((tmp / "idqn_rank0" / "checkpoints").glob("model_s*.msgpack"),
                   key=lambda p: int(p.stem.split("_s")[-1]))
    if len(saved) != 2:
        raise AssertionError(f"dist_resume: the W=2 run saved {[p.name for p in saved]}; expected 2")
    torch.cuda.synchronize()
    fg.reset_launch_counts()
    rows, state = port_run.main(idqn_argv + [f"run_dir={tmp / 'resume_w1'}", f"resume={saved[0]}"])
    resume_counts = fg.launch_counts()
    check_launches("dist_resume", resume_counts, len(state.timings), IDQN_LAUNCHES)
    # the resumed run's rows (its cadences count from the resumed step) at
    # the W=2 run's steps: the same updates, losses to rtol 1e-4 / atol 1e-6
    w2_rows = {r["environment_steps"]: r for r in ranks[0]["idqn"]["rows"]}
    worst = 0.0
    for r in rows or []:
        q = w2_rows.get(r["environment_steps"])
        if q is None or r["updates"] != q["updates"] or not abs(float(r["loss"]) - float(q["loss"])) <= (
                1e-6 + 1e-4 * abs(float(q["loss"]))):
            raise AssertionError(f"dist_resume: resumed row {r} against the W=2 run's {q}")
        worst = max(worst, abs(float(r["loss"]) - float(q["loss"])) / abs(float(q["loss"])))
    if not rows:
        raise AssertionError("dist_resume: the resumed run wrote no row")
    final = load_checkpoint(saved[1])
    got = state.state_dict()
    exact = [k for k in ("env_steps", "updates", "last_target_update") if int(got[k]) != int(final[k])]
    exact += [f"buffer/{k}" for k, v in final["buffer"].items()
              if v is not None and not torch.equal(torch.as_tensor(got["buffer"][k]).cpu(), torch.as_tensor(v))]
    if not np.array_equal(np.asarray(got["generator"]), np.asarray(final["generator"])):
        exact.append("generator")
    diffs = []
    flat_final = _flat(final["params"])
    for key, a in _flat(got["params"]).items():
        a, b = a.detach().cpu().double(), torch.as_tensor(flat_final[key]).double()
        diffs.append((a - b).abs().max().item())
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
            exact.append("params")
    if exact:
        raise AssertionError(f"dist_resume: the W=1 resume of the W=2 checkpoint differs in {exact}")
    emit({"phase": "dist_resume", "card": smi, "saved_at_world": 2, "resumed_at_world": 1,
          "resumed_from": saved[0].name, "rows_compared": len(rows), "max_rel_diff": worst,
          "max_abs_param_diff": max(diffs), "launches": resume_counts})
    counts["dist_resume"] = resume_counts
    del state
    torch.cuda.empty_cache()

    # dist_sweep: the batch-32 group's units over two ranks
    s0, s1 = ranks[0]["sweep"], ranks[1]["sweep"]
    B = int(sweep_ref["cfg"].algorithm.batch_size)
    for s in (s0, s1):
        iters, rows = s["iterations"], len(_csv_rows(Path(s["dirs"][0]) / "results.csv"))
        trained = sum(1 for i in range(1, iters + 1) if 32 * i >= B)
        n = 32 * trained
        want = {"fwd": T * iters + 2 * n + 25 * rows, "bwd": n, "dw": n, "reduce": n}
        if any(s["launches"][k] != want.get(k, 0) for k in s["launches"]):
            raise AssertionError(f"dist_sweep: rank {s['rank']} launched {s['launches']}; one unit's rule {want}")
    split = [Path(d) for d in s0["dirs"] + s1["dirs"]]
    if len(s0["units"]) != 16 or len(split) != len(sweep_ref["dirs"]):
        raise AssertionError(f"dist_sweep: {len(s0['units'])} units on rank 0, {len(split)} unit dirs")
    worst = 0.0
    for u in (0, len(split) - 1):
        if split[u].relative_to(tmp / "dist_sweep") != sweep_ref["dirs"][u].relative_to(sweep_ref["run_dir"]):
            raise AssertionError(f"dist_sweep: unit {u} wrote {split[u]}, the group {sweep_ref['dirs'][u]}")
        worst = max(worst, compare_rows(f"dist_sweep unit {u}", _csv_rows(split[u] / "results.csv"),
                                        _csv_rows(sweep_ref["dirs"][u] / "results.csv")))
    counts["dist_sweep"] = {k: s0["launches"][k] + s1["launches"][k] for k in s0["launches"]}
    emit({"phase": "dist_sweep", "card": smi, "world": 2, "units_per_rank": [len(s0["units"]), len(s1["units"])],
          "iterations": s0["iterations"], "launches_per_rank": [s0["launches"], s1["launches"]],
          "units_compared": [0, len(split) - 1], "max_rel_diff_vs_unsharded": worst,
          "seconds_per_rank": [s0["seconds"], s1["seconds"]],
          "per_iteration_timed_per_rank": [s0["per_iteration_timed"], s1["per_iteration_timed"]]})
    return counts


def _csv_rows(path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def dist_refusal_phase(phase, smi, tmp) -> None:
    """`distributed.devices` one more than the visible GPUs (2 on one GPU)
    raises before any rank starts: no process spawned, no run dir made."""
    n = torch.cuda.device_count()
    spawned = []
    spawn = mesh.spawn
    mesh.spawn = lambda *a, **k: spawned.append(a) or spawn(*a, **k)
    try:
        port_run.main(RUNS["train"][0] + [f"distributed.devices={n + 1}", f"run_dir={tmp / 'refused'}"])
    except ValueError as exc:
        message = str(exc)
    else:
        raise AssertionError(f"{phase}: distributed.devices={n + 1} ran on {n} GPU(s)")
    finally:
        mesh.spawn = spawn
    if spawned or (tmp / "refused").exists() or f"need {n + 1} devices, have {n}" not in message:
        raise AssertionError(f"{phase}: spawned {len(spawned)}, run dir made {(tmp / 'refused').exists()}: {message}")
    emit({"phase": phase, "card": smi, "gpus": torch.cuda.device_count(), "error": message})


# ------------------------------------------------------------------- tooling
# the train phase's lane: recurrent IDQN on LBF 8x8, the [128,128] MLP with
# GRU(128), 65536 envs, batch 1024 (the idqn_rnn_lbf lane)
TRAIN_ARGV = ["+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "algorithm.model.use_rnn=true",
              "algorithm.model.layers=[128,128]", "algorithm.batch_size=1024", "algorithm.buffer_size=131072",
              *DQN_ARGV]


def debug_phase(phase, smi) -> dict:
    """The train lane for 2 iterations with `debug=false`, then with
    `debug=true` (`utils/debug.py`: every aten op scanned for NaN, indices
    and integer divisors checked before the op, anomaly mode, each GRU
    kernel's outputs scanned), each through `run.main` with the launch
    counters set to 0 just before and read just after: the rows must agree
    to rtol 1e-6. Counts the ops the dispatch mode scanned on threads other
    than the caller's (the autograd engine's device thread runs a CUDA
    backward). Prints each run's seconds an iteration. Returns the debug
    run's launch counts."""
    runs = {}
    threads = {}
    checks = port_debug.checks

    @contextlib.contextmanager
    def counting_checks():
        # the debug run's regions, each adding the ops it saw on each thread
        with checks() as mode:
            try:
                yield mode
            finally:
                for tid, n in mode.threads.items():
                    threads[tid] = threads.get(tid, 0) + n

    for on in (False, True):
        port_debug.checks = counting_checks if on else checks
        try:
            counts, state = train_phase(f"{phase}_{'on' if on else 'off'}", smi, TRAIN_ARGV + [f"debug={str(on).lower()}"],
                                        E=65536, iters=2, per_iteration=IDQN_LAUNCHES)
        finally:
            port_debug.checks = checks
        runs[on] = (RUNS[f"{phase}_{'on' if on else 'off'}"][1], [t for _, t in state.timings], counts)
        del state
    worst = compare_rows(phase, runs[True][0], runs[False][0], rtol=1e-6, atol=1e-6)
    main_thread = threading.get_ident()
    off_thread = sum(n for tid, n in threads.items() if tid != main_thread)
    emit({"phase": phase, "card": smi, "rows_equal_bitwise": runs[True][0] == runs[False][0],
          "max_rel_diff_debug_vs_off": worst,
          "iteration_seconds_off": runs[False][1], "iteration_seconds_debug": runs[True][1],
          "debug_cost_per_iteration_s": [a - b for a, b in zip(runs[True][1], runs[False][1])],
          "ops_scanned_on_the_caller_thread": threads.get(main_thread, 0),
          "ops_scanned_on_other_threads": off_thread, "launches_debug": runs[True][2]})
    return runs[True][2]


def _expect_raise(case, exc_type, pattern, fn):
    """Run fn; return the message of the `exc_type` it must raise, whose text
    must hold `pattern`. Any other exception propagates."""
    try:
        fn()
    except exc_type as exc:
        if pattern not in str(exc):
            raise AssertionError(f"debug_nan {case}: {exc_type.__name__} without {pattern!r}: {exc}") from exc
        return str(exc)
    raise AssertionError(f"debug_nan {case}: nothing raised; expected {exc_type.__name__} naming {pattern!r}")


def debug_nan_phase(phase, smi) -> None:
    """Four faults at full width under debug, each of which must raise:
    one W_hh entry poisoned before the first iteration (the rollout's GRU
    forward at (a) writes NaN: the error names gru_fwd_kernel); a NaN `dy`
    handed to `gru_backward_cuda` at the update shape (b) (gru_bwd_kernel);
    a poisoned weight of the first Linear (an aten op); an out-of-range
    gather of Q values of 65536 envs (IndexError before the launch, after
    which the card still runs)."""
    dev = torch.device("cuda")
    cfg = load_config(TRAIN_ARGV + ["env.time_limit=25", "env.parallel_envs=65536", "device=cuda"])
    cfg.algorithm.parallel_envs = 65536
    env, _ = port_run.build_envs(cfg)
    init_state, train_iteration, _ = port_dqn.build_train_functions(env, env, cfg.algorithm, 25, dev, debug=True)
    out = {}
    for case, leaf, index in (("w_hh", "rnn", "w_hh"), ("mlp", "first", "w")):
        state = init_state(0)
        tree = state.model.critic.param_tree()
        with torch.no_grad():
            (tree[leaf][0] if leaf == "rnn" else tree[leaf])[index].view(-1)[0] = math.nan
        fg.reset_launch_counts()
        want = "gru_fwd_kernel wrote NaN" if case == "w_hh" else "of aten."
        out[case] = {"error": _expect_raise(case, FloatingPointError, want, lambda: train_iteration(state)),
                     "launches": fg.launch_counts()}
        del state, tree
    G, T, B, H = (SHAPES["b"][k] for k in "GTBH")
    gen = torch.Generator(device=dev).manual_seed(3)
    gi = torch.randn((G, T, B, 3 * H), generator=gen, device=dev)
    w_hh = torch.randn((G, H, 3 * H), generator=gen, device=dev) / H ** 0.5
    b_hh, h0 = torch.zeros((G, 3 * H), device=dev), torch.zeros((G, B, H), device=dev)
    y, _ = fg.gru_fwd_cuda(gi, w_hh, b_hh, h0)
    dy = torch.randn_like(y)
    dy[0, T - 1, 0, 0] = math.nan
    with port_debug.checks():
        out["dy"] = {"error": _expect_raise("dy", FloatingPointError, "gru_bwd_kernel wrote NaN", lambda: fg.gru_backward_cuda(
            gi, w_hh, b_hh, h0, y, dy, torch.zeros_like(h0)))}
        q = torch.randn((65536, 2, 6), generator=gen, device=dev)
        actions = torch.randint(0, 6, (65536, 2, 1), generator=gen, device=dev)
        actions[4095, 1, 0] = 6
        out["gather"] = {"error": _expect_raise("gather", IndexError, "aten.gather", lambda: torch.gather(q, -1, actions))}
    torch.cuda.synchronize()  # the card was not poisoned: the valid gather runs
    ok = torch.gather(q, -1, actions.clamp(max=5))
    torch.cuda.synchronize()
    emit({"phase": phase, "card": smi, "cases": out, "after_gather_ok": bool(torch.isfinite(ok).all())})


def trace_phase(phase, smi, tmp) -> dict:
    """The train lane for 2 iterations with `trace_dir` (a `torch.profiler`
    trace of the whole run): the trace must parse as JSON and hold the four
    GRU kernels' device events and the ranges dqn/rollout, dqn/updates and
    env/step. Prints the trace's bytes and the traced run's seconds an
    iteration. Returns the launch counts."""
    trace_dir = tmp / "trace"
    counts, state = train_phase(phase, smi, TRAIN_ARGV + [f"trace_dir={trace_dir}"], E=65536, iters=2,
                                per_iteration=IDQN_LAUNCHES)
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{phase}: {len(files)} trace files in {trace_dir}")
    t0 = time.perf_counter()
    events = json.loads(files[0].read_text())["traceEvents"]
    parse_s = time.perf_counter() - t0
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel" and k in e.get("name", ""))
               for k in ("gru_fwd_kernel", "gru_bwd_kernel", "gru_dw_kernel", "gru_reduce_kernel")}
    ranges = {r: sum(1 for e in events if e.get("name") == r) for r in ("dqn/rollout", "dqn/updates", "env/step")}
    if not all(kernels.values()) or not all(ranges.values()):
        raise AssertionError(f"{phase}: trace kernel events {kernels}, ranges {ranges}")
    emit({"phase": f"{phase}_file", "card": smi, "trace_bytes": files[0].stat().st_size, "events": len(events),
          "parse_seconds": parse_s, "kernel_events": kernels, "range_events": ranges,
          "traced_iteration_seconds": [t for _, t in state.timings]})
    return counts


def _profile_rank(argv):
    """One gloo rank of the distributed profile: returns its report."""
    from codebase_tpu_torch import profile as port_profile

    return port_profile.main(argv)


def profile_dist_phase(phase, smi) -> None:
    """`codebase_tpu_torch.profile` on the train lane (65536 envs, 2 traced
    iterations), with `distributed.devices=1` (one NCCL rank in this
    process), then over two gloo ranks sharing the card (each 32768 envs, a
    `mesh.spawn` on GPUs [0, 0]). Prints `world`, each rank's kernel ms and
    busy share, and `tflops_per_s` of each."""
    from codebase_tpu_torch import profile as port_profile

    argv = TRAIN_ARGV + ["env.time_limit=25", "env.parallel_envs=65536", "profile.iters=2", "seed=0", "device=cuda"]
    reports = {"nccl1": port_profile.main(argv + ["distributed.devices=1"])}
    reports["gloo2"] = mesh.spawn(_profile_rank, 2, "cuda", args=(argv + ["distributed.devices=2"],),
                                  backend="gloo", device_ids=[0, 0])[0]
    out = {}
    for name, r in reports.items():
        if r["world"]["ranks"] != (1 if name == "nccl1" else 2) or not r["kernel_ms_per_iter"]:
            raise AssertionError(f"{phase} {name}: world {r['world']}, kernel ms {r['kernel_ms_per_iter']}")
        out[name] = {"world": r["world"], "tflops_per_s": r["tflops_per_s"], "iteration_flops": r["iteration_flops"],
                     "ranks": [{k: x[k] for k in ("rank", "iteration_ms", "kernel_ms_per_iter", "device_busy_share",
                                                  "collective_ms_per_iter")} for x in r["ranks"]],
                     "gru_kernel_ms_per_iter": r["gru_kernel_ms_per_iter"]}
    emit({"phase": phase, "card": smi, **out})


def custom_entry(env, eval_env, logger, time_limit, cfg, device, shard=None):
    """A user's train entry point for `entry_and_optimizers`: the value-based
    family's, tagged so that the caller sees it ran."""
    from codebase_tpu_torch.algos.dqn_train import main as dqn_main

    state = dqn_main(env, eval_env, logger, time_limit, cfg, device, shard)
    state.entry = "custom_entry"
    return state


class FirstStep:
    """While active, records the first optimizer step of a run: the
    parameters before, the gradients and the parameters after (on the
    host), and the optimizer's settings."""

    def __init__(self, cls):
        self.cls, self.record = cls, None

    def __enter__(self):
        self._own = self.cls.__dict__.get("step")  # None: the class inherits its step
        step = self.cls.step
        watch = self

        def recording(opt, grads, active=None):
            if watch.record is not None:
                return step(opt, grads, active)
            before = [p.detach().cpu().clone() for p in opt.params]
            step(opt, grads, active)
            watch.record = (opt, before, [g.detach().cpu().clone() for g in grads],
                            [p.detach().cpu().clone() for p in opt.params])

        self.cls.step = recording
        return self

    def __exit__(self, *exc):
        if self._own is None:
            del self.cls.step
        else:
            self.cls.step = self._own


def entry_and_optimizers_phase(phase, smi) -> dict:
    """One iteration of the train lane through `algorithm.entry=
    chip_smoke:custom_entry` and one through `register_algorithm`, then 2
    iterations under each of rmsprop, sgd and adamw: each optimizer's first
    step on the card must equal its CPU twin's step on the same gradients
    copied to the host (rtol 1e-6, atol 1e-8: an entry whose step cancels
    it to near 0 keeps only its leading digits). Returns the launch counts
    by run."""
    from codebase_tpu_torch.algos import common as port_common
    from codebase_tpu_torch.algos.registry import ALGORITHMS, register_algorithm

    counts = {}
    c, state = train_phase(f"{phase}_entry", smi, TRAIN_ARGV + ["algorithm.entry=chip_smoke:custom_entry"],
                           E=65536, iters=1, per_iteration=IDQN_LAUNCHES)
    counts["entry"] = c
    if getattr(state, "entry", None) != "custom_entry":
        raise AssertionError(f"{phase}: algorithm.entry did not reach chip_smoke:custom_entry")
    del state
    register_algorithm("idqn_registered", custom_entry)
    try:
        c, state = train_phase(f"{phase}_registered", smi, TRAIN_ARGV + ["algorithm.name=idqn_registered"],
                               E=65536, iters=1, per_iteration=IDQN_LAUNCHES)
    finally:
        ALGORITHMS.pop("idqn_registered")
    counts["registered"] = c
    if getattr(state, "entry", None) != "custom_entry":
        raise AssertionError(f"{phase}: register_algorithm did not reach custom_entry")
    del state
    steps = {}
    for name in ("rmsprop", "sgd", "adamw"):
        cls = port_common.OPTIMIZERS[name]
        with FirstStep(cls) as watch:
            c, state = train_phase(f"{phase}_{name}", smi, TRAIN_ARGV + [f"algorithm.optimizer={name}"],
                                   E=65536, iters=2, per_iteration=IDQN_LAUNCHES)
        counts[name] = c
        opt, before, grads, after = watch.record
        if type(state.opt) is not cls:
            raise AssertionError(f"{phase}: the run's optimizer is {type(state.opt).__name__}, not {cls.__name__}")
        twin = cls([p.clone() for p in before], opt.lr, opt.grad_clip, clip_mask=opt.clip_mask, n_units=opt.n_units)
        twin.step(grads)
        worst = 0.0
        for got, ref in zip(after, twin.params):
            err = (got - ref).abs()
            if not bool((err <= 1e-8 + 1e-6 * ref.abs()).all()):
                raise AssertionError(f"{phase} {name}: the card's first step differs from the CPU's by "
                                     f"{float(err.max()):.3e}")
            worst = max(worst, float((err / ref.abs().clamp(min=1e-30)).max()))
        steps[name] = {"max_rel_err_first_step": worst, "moved": max(float((a - b).abs().max())
                                                                     for a, b in zip(after, before)),
                       "iteration_seconds": [t for _, t in state.timings]}
        del state
    emit({"phase": phase, "card": smi, "optimizers": steps, "launches": counts})
    return counts


def hetero_phase(phase, smi) -> dict:
    """A MultiAgentNetwork of agents of unequal sizes on the card: inputs
    [15, 12] (LBF 8x8's obs and 3 fewer), outputs [6, 5], the [128,128] MLP
    with GRU(128), one step of 65536 envs through the kernels (G=2, the
    shape (a)), against the same network with the plain recurrence
    (`fused_rnn=off`) to the kernels' tolerance; under a loss masked with
    `output_mask`, the padded output columns and input rows take zero
    gradients. Returns the launch counts."""
    from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork

    dev = torch.device("cuda")
    sizes = dict(input_sizes=[15, 12], hidden_dims=[128, 128], output_sizes=[6, 5], use_rnn=True)
    net = MultiAgentNetwork(generator=torch.Generator().manual_seed(0), device=dev, **sizes)
    plain = MultiAgentNetwork(fused_rnn="off", device=dev, **sizes)
    plain.load_params(net.param_tree())
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 1, 65536, 15), generator=gen, device=dev)
    x[1, ..., 12:] = 0.0  # agent 1's obs zero-padded beyond its own size
    mask = net.output_mask[:, None, None, :]
    fg.reset_launch_counts()
    y, hT = net(x)
    tree = net.param_tree()
    w_in, w_out = tree["first"]["w"], tree["final"]["w"]
    g_in, g_out = torch.autograd.grad(((y * mask) ** 2).sum(), [w_in, w_out])
    torch.cuda.synchronize()
    counts = fg.launch_counts()
    with torch.no_grad():
        y_ref, h_ref = plain(x)
    err_y, err_h = compare("y", y.detach(), y_ref), compare("hT", hT.detach(), h_ref)
    padded = float(g_out[1, :, 5:].abs().max()) + float(g_in[1, 12:].abs().max())
    if padded != 0.0 or not float(g_in[1, :12].abs().max()) > 0:
        raise AssertionError(f"{phase}: padded gradients {padded}; real ones {float(g_in[1, :12].abs().max())}")
    check_launches(phase, counts, 1, {"fwd": 1, "bwd": 1, "dw": 1, "reduce": 1})
    emit({"phase": phase, "card": smi, "max_abs_err_y": err_y, "max_abs_err_hT": err_h,
          "padded_gradients_max": padded, "output_mask": net.output_mask.tolist(), "launches": counts})
    return counts


def analyze_phase(phase, smi, groups) -> None:
    """`analyze summary` and `best` over sweep_idqn_rnn's run tree (32
    units a group, a `config.yaml` and `results.csv` each): the number of
    groups, the best group's name."""
    from codebase_tpu_torch import analyze as port_analyze

    source = groups[0]["run_dir"].parent
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        if port_analyze.main(["summary", "--source", str(source)]) != 0:
            raise AssertionError(f"{phase}: analyze summary failed")
    winners = port_analyze.best(source, print_config=False, out=io.StringIO())
    from codebase_tpu_torch.utils.postprocessing.load_data import load_and_group_runs

    n_groups = len(load_and_group_runs(source))
    if n_groups != 4 or len(winners) != 1:
        raise AssertionError(f"{phase}: {n_groups} groups, winners {winners}; expected 4 groups (lr x batch) of "
                             "one env")
    emit({"phase": phase, "card": smi, "source_runs": sum(len(g["dirs"]) for g in groups), "groups": n_groups,
          "best": winners, "summary": table.getvalue().splitlines()})


# the GRU kernels each bench lane must launch: the H=128 ones, the wide ones
# (H=512), or none (an MLP, or the per-step cell under fused_rnn=off)
BENCH_ROUTES = {"idqn_rnn_lbf": "resident", "qmix_smaclite_mmm2_big": "wide", "mappo_smaclite_mmm2_big": "wide"}
ROUTE_COUNTERS = {"resident": ("fwd", "bwd", "dw", "reduce"), "wide": ("fwd_wide", "bwd_wide", "dw", "reduce"),
                  None: ()}


def bench_phase(phase, smi) -> None:
    """Every lane of `bench_suite.CONFIGS` at its full width through
    `bench_suite.run_config` (one warmup and one timed window of 2
    iterations, then one counted iteration), called directly so that a
    failure propagates; each lane's state is freed and the CUDA cache
    emptied before the next. Checks finite env-steps/s above 0, 0 < MFU <= 1,
    operations and bytes a step above 0, and each lane's GRU route from its
    launches an iteration (`BENCH_ROUTES`)."""
    t0 = time.perf_counter()
    for key in port_bench_suite.CONFIGS:
        res = port_bench_suite.run_config(key, windows=1, window_iters=2)
        rate, mfu = res["env_steps_per_s"], res["mfu"]
        if not (math.isfinite(rate) and rate > 0):
            raise AssertionError(f"{phase} {key}: env-steps/s {rate}")
        if mfu is None or not 0 < mfu <= 1:
            raise AssertionError(f"{phase} {key}: mfu {mfu} (peak {res['mfu_peak']})")
        if not (res["flops_per_step"] > 0 and res["bytes_per_step"] > 0):
            raise AssertionError(f"{phase} {key}: flops {res['flops_per_step']}, bytes {res['bytes_per_step']} a step")
        launches = res["gru_launches_per_iter"]
        route = BENCH_ROUTES.get(key)
        launched = {k for k, v in launches.items() if v > 0}
        if launched != set(ROUTE_COUNTERS[route]):
            raise AssertionError(f"{phase} {key}: launched {sorted(launched)}, the {route or 'no-GRU'} route "
                                 f"launches {list(ROUTE_COUNTERS[route])} ({launches})")
        emit({"phase": f"{phase}_{key}", "card": smi, "route": route, **{k: res[k] for k in (
            "env_steps_per_s", "mfu", "mfu_peak", "flops_per_step", "analytic_flops_per_step", "bytes_per_step",
            "hbm_bandwidth_util", "peak_device_memory_gib", "gru_launches_per_iter", "windows_s")}})
        del res
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": phase, "card": smi, "lanes": list(port_bench_suite.CONFIGS), "phase_s": time.perf_counter() - t0})


def gate_smoke_phase(phase, smi, out, name="ippo_lbf") -> None:
    """The gate runner on the card: two seeds of gate `name` at 80000 steps
    (rows every 20000 up to 100000: the loop runs until the step exceeds
    the budget, a chunk a row). Seed 0 runs uncut; its time to the first
    row and between rows places seed 1's budget half way between its second
    and third rows, so that seed 1 checkpoints at the end of the chunk in
    flight (60000) and a second `run` resumes it from there (for a recurrent
    gate the checkpoint carries the GRU weights and Adam moments; each
    rollout starts from a zero hidden state). `run`'s budget counts from the
    launch, and seed 1's process may reach its first row some seconds sooner
    or later than seed 0's did (torch's import time varies on the card's
    machine; rows come about 10 s apart): a resume one row either side of
    60000 is accepted, and the rows after it leave the cut run undone. Every
    process is stopped by `run` itself."""
    extra = ["algorithm.total_steps=80000"]
    expected = [20000 * i for i in range(1, 6)]
    uncut = port_gate.run([name], out, budget_s=600, seeds=[0], extra=extra)[0]
    timing = uncut["by_call"][0]
    if uncut["state"] != "done" or timing["s_per_20000_steps"] is None:
        raise AssertionError(f"{phase}: seed 0 did not finish with two rows: {uncut}")
    budget = timing["first_row_s"] + 1.5 * timing["s_per_20000_steps"]
    cut = port_gate.run([name], out, budget_s=budget, procs=2, seeds=[0, 1], extra=extra)
    states = {st["seed"]: st["state"] for st in cut}
    if states != {0: "skipped", 1: "cut"}:
        raise AssertionError(f"{phase}: expected seed 0 skipped and seed 1 cut at {budget:.1f} s: {cut}")
    resumed = port_gate.run([name], out, budget_s=600, seeds=[0, 1], extra=extra)
    last = {st["seed"]: st for st in resumed}
    if last[0]["state"] != "skipped" or last[1]["state"] != "done" or last[1]["resumed_at"] not in expected[1:4]:
        raise AssertionError(f"{phase}: expected seed 1 resumed at {expected[1:4]} and done: {resumed}")
    curves = {}
    for seed in (0, 1):
        run_dir = out / name / f"{port_gate.GATES[name].algo}_seed{seed}"
        rows = _csv_rows(run_dir / "results.csv")
        steps = [int(r["environment_steps"]) for r in rows]
        curves[seed] = port_gate._read_csv(run_dir / "results.csv")
        values = [float(r[k]) for r in rows for k in ("loss", "actor_loss", "value_loss", "mean_episode_returns")]
        if steps != expected or [s for s, _ in curves[seed]] != expected or not all(map(math.isfinite, values)):
            raise AssertionError(f"{phase}: seed {seed} rows at {steps}, read {curves[seed]}, values {values}")
    emit({"phase": phase, "card": smi, "gate": name, "overrides": port_gate.GATES[name].overrides + extra,
          "rows_at": expected, "seed0_first_row_s": timing["first_row_s"],
          "s_per_20000_steps": timing["s_per_20000_steps"], "cut_budget_s": budget,
          "seed1_by_call": last[1]["by_call"], "final_returns": {seed: c[-1][1] for seed, c in curves.items()}})


def main() -> None:
    # --- 1. device
    dev = resolve_device("cuda")  # also pins f32 matmuls (allow_tf32 = False)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    peaks = port_bench_suite.card_peaks(name)
    if peaks is None:
        raise RuntimeError(f"no published peaks for the card {name!r} in codebase_tpu_torch/bench_suite.py "
                           f"PEAKS ({sorted(port_bench_suite.PEAKS)}): the bounds need them")
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "peaks": peaks,
          "peaks_for": next(k for k in port_bench_suite.PEAKS if k in name)})

    # --- 2. build
    t0 = time.perf_counter()
    lib_path = kernel_lib.build_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name,
          "nvcc_flags": kernel_lib.NVCC_FLAGS})

    # --- 3. kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for key, s in SHAPES.items():
        results[key] = check_shape(key, s["G"], s["T"], s["B"], s["H"], gen, peaks)
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": smi,
          "shapes": SHAPES, "results": results})

    # --- 3b. grouped_dw: the f32 weight gradients of the benchmark cells' updates
    emit(grouped_dw_phase(smi, peaks))

    # --- 4. train: recurrent IDQN
    counts, _ = train_phase("train", smi, [
        "+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "algorithm.model.use_rnn=true",
        "algorithm.model.layers=[128,128]", "algorithm.batch_size=1024", "algorithm.buffer_size=131072",
        *DQN_ARGV,
    ], E=65536, iters=3, per_iteration={"fwd": 25, "bwd": 8, "dw": 8, "reduce": 8}, dw_per_update=3)

    # --- 5. train_qmix: the QMIX preset, shared recurrent critic (G=3),
    # reward standardisation on the card
    qmix_counts, state = train_phase("train_qmix", smi, [
        "+algorithm=qmix", "env.name=lbforaging:Foraging-10x10-3p-3f-v3", "algorithm.model.use_rnn=true",
        "algorithm.model.layers=[128,128]", "algorithm.model.parameter_sharing=true",
        "algorithm.batch_size=512", "algorithm.buffer_size=65536", "env.standardise_rewards=true",
        *DQN_ARGV,
    ], E=32768, iters=3, per_iteration={"fwd": 41, "bwd": 8, "dw": 8, "reduce": 8})
    stream_n = state.reward_stream.n
    if not float(stream_n.min()) > 0 or state.reward_stream.wmean.device.type != "cuda":
        raise AssertionError("train_qmix: the reward stream did not advance on the card")
    emit({"phase": "train_qmix_reward_stream", "n_min": float(stream_n.min()), "n_mean": float(stream_n.mean()),
          "wmean_mean": float(state.reward_stream.wmean.mean())})
    del state

    # --- 6. train_vdn: the vdn_shared_lbf10 lane (MLP): no GRU launch
    train_phase("train_vdn", smi, [
        "+algorithm=vdn", "env.name=lbforaging:Foraging-10x10-3p-3f-v3", "algorithm.model.parameter_sharing=true",
        "algorithm.batch_size=512", "algorithm.buffer_size=65536", *DQN_ARGV,
    ], E=32768, iters=2, per_iteration={})

    # --- 7. train_lstm: the LSTM never reaches the GRU kernels; return
    # standardisation (per agent) on the card
    _, state = train_phase("train_lstm", smi, [
        "+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "algorithm.model.use_rnn=lstm",
        "algorithm.model.layers=[128,128]", "algorithm.batch_size=1024", "algorithm.buffer_size=32768",
        "algorithm.standardise_returns=true", *DQN_ARGV,
    ], E=16384, iters=2, per_iteration={})
    rms = state.ret_rms
    if not (float(rms.count) > 1e-4 and torch.isfinite(rms.mean).all() and torch.isfinite(rms.var).all()):
        raise AssertionError(f"train_lstm: return moments did not advance or are not finite: {rms}")
    emit({"phase": "train_lstm_return_moments", "count": float(rms.count), "mean": rms.mean.tolist(),
          "var": rms.var.tolist()})
    del state

    # --- 8. train_mappo: recurrent actor and centralised recurrent critic,
    # the GRU kernels at (g) in the rollout and (f) in the update
    mappo_counts, state = train_phase("train_mappo", smi, [
        "+algorithm=mappo", "env.name=lbforaging:Foraging-8x8-2p-3f-v3",
        "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true",
    ], E=8192, iters=3, per_iteration={"fwd": 35, "bwd": 8, "dw": 8, "reduce": 8})
    check_target_refresh(state)
    del state

    # --- 8b, 8c. the recurrent learning gates' configs at their 10 envs:
    # the kernels at (z16) in the rollouts, (z17) in IDQN's updates, (z18)
    # and (z19) in MAPPO's, (o) in IDQN's eval
    gate_counts = {f"train_{name}": gate_train_phase(f"train_{name}", smi, name, iters)
                   for name, iters in (("idqn_rnn_lbf", 6), ("mappo_rnn_lbf", 3))}

    # --- 9. train_ia2c: the ia2c_lbf lane (MLP): no GRU launch
    train_phase("train_ia2c", smi, ["+algorithm=ia2c", "env.name=lbforaging:Foraging-8x8-2p-3f-v3"],
                E=8192, iters=2, per_iteration={})

    # --- 10. train_ippo_std: reward and return standardisation on the card
    _, state = train_phase("train_ippo_std", smi, [
        "+algorithm=ippo", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "env.standardise_rewards=true",
        "algorithm.standardise_returns=true",
    ], E=8192, iters=2, per_iteration={})
    stream, rms = state.reward_stream, state.ret_rms
    if not (float(stream.n.min()) > 0 and stream.wmean.device.type == "cuda" and torch.isfinite(stream.wmean).all()):
        raise AssertionError("train_ippo_std: the reward stream did not advance on the card")
    if not (float(rms.count) > 1e-4 and rms.mean.device.type == "cuda"
            and torch.isfinite(rms.mean).all() and torch.isfinite(rms.var).all()):
        raise AssertionError(f"train_ippo_std: return moments did not advance or are not finite: {rms}")
    emit({"phase": "train_ippo_std_moments", "stream_n_min": float(stream.n.min()),
          "stream_wmean_mean": float(stream.wmean.mean()), "returns_count": float(rms.count),
          "returns_mean": rms.mean.tolist(), "returns_var": rms.var.tolist()})
    del state

    # --- 11. train_qmix_smaclite: the qmix_smaclite_3m lane with the
    # recurrent critic, the GRU kernels at (h) and (i), masks everywhere
    # (16 forwards an iteration in the updates, and one a rollout step: the
    # early exit stops at the longest episode)
    smac3m_argv = ["+algorithm=qmix", "env.name=smaclite:3m-v0", "algorithm.model.use_rnn=true",
                   "algorithm.model.layers=[128,128]", "algorithm.batch_size=256", "algorithm.buffer_size=65536",
                   *DQN_ARGV]
    smac_qmix_counts, state = smaclite_phase("train_qmix_smaclite", smi, smac3m_argv, E=65536, iters=3,
                                             per_iteration={"fwd": 17, "bwd": 8, "dw": 8, "reduce": 8},
                                             modules=[port_dqn])
    buf = state.buffer
    if buf.obs.dtype != torch.float32 or buf.action_mask is None or buf.obs.device.type != "cuda":
        raise AssertionError(f"train_qmix_smaclite: replay obs {buf.obs.dtype}, masks stored: "
                             f"{buf.action_mask is not None}; expected float32 obs and masks on the card")
    # the buffer holds exactly the last rollout (buffer = envs, slots cleared)
    stored_rollout = (buf.action_mask.transpose(0, 1), buf.actions.transpose(0, 1), buf.filled.transpose(0, 1))
    stored = audit_rollout(*stored_rollout)
    if int(stored["invalid"]):
        raise AssertionError(f"train_qmix_smaclite: replay holds actions outside the mask: {stored}")
    emit({"phase": "train_qmix_smaclite_replay", "obs_dtype": str(buf.obs.dtype), "mask_dtype": str(buf.action_mask.dtype),
          "obs_gb": buf.obs.nbytes / 1e9, "mask_gb": buf.action_mask.nbytes / 1e9,
          **{k: float(v) for k, v in stored.items()},
          # device time of one audit of a 65536-env rollout, which each
          # timed iteration of the SMAClite phases includes
          "audit_ms": time_ms(lambda: audit_rollout(*stored_rollout))})
    del buf, stored_rollout
    early_exit_cost("early_exit_smaclite_3m", smi, smac3m_argv, 65536, 60, state)
    del state

    # --- 12. train_mappo_smaclite: recurrent actor and centralised
    # recurrent critic on 3m, the GRU kernels at (k), (j) and (l)
    smac_mappo_counts, state = smaclite_phase("train_mappo_smaclite", smi, [
        "+algorithm=mappo", "env.name=smaclite:3m-v0",
        "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true",
    ], E=8192, iters=2, per_iteration={"fwd": 11, "bwd": 8, "dw": 8, "reduce": 8}, modules=[port_ac])
    del state

    # --- 13. train_qmix_rware: the qmix_rware lane (MLP, bf16 replay)
    rware_counts, state = train_phase("train_qmix_rware", smi, [
        "+algorithm=qmix", "env.name=rware-tiny-2ag-v2", "algorithm.batch_size=128", "algorithm.buffer_size=16384",
        *DQN_ARGV,
    ], E=8192, iters=2, per_iteration={}, T=500)
    if state.buffer.obs.dtype != torch.bfloat16 or state.buffer.action_mask is not None:
        raise AssertionError("train_qmix_rware: expected bf16 replay obs and no masks")
    del state

    # --- 14. train_qmix_mmm2: the qmix_smaclite_mmm2_big lane (10 allies,
    # the shared 2x512 GRU critic in bf16): the wide kernels at (p), (q)
    # and (r); 2048 envs, so the early exit is on under auto
    mmm2_qmix_argv = [
        "+algorithm=qmix", "env.name=smaclite:MMM2-v0", "algorithm.model.use_rnn=true",
        "algorithm.model.layers=[512,512]", "algorithm.model.parameter_sharing=true",
        "algorithm.model.dtype=bfloat16", "algorithm.batch_size=256", "algorithm.buffer_size=2048", *DQN_ARGV,
    ]
    mmm2_qmix_counts, state = smaclite_phase("train_qmix_mmm2", smi, mmm2_qmix_argv, E=2048, iters=2,
                                             per_iteration={"fwd_wide": 17, "bwd_wide": 8, "dw": 8, "reduce": 8},
                                             modules=[port_dqn], T=120)
    mmm2_report(state, [state.model.critic])
    early_exit_cost("early_exit_mmm2", smi, mmm2_qmix_argv, 2048, 120, state)
    del state

    # --- 15. train_mappo_mmm2: the mappo_smaclite_mmm2_big lane (shared
    # 2x512 GRU actor and centralised critic in bf16, 256 envs: no early
    # exit): the wide kernels at (s), (t) and (u), 120 rollout steps and 10
    # forwards in the update an iteration
    mmm2_mappo_counts, state = smaclite_phase("train_mappo_mmm2", smi, [
        "+algorithm=mappo", "env.name=smaclite:MMM2-v0",
        *[f"algorithm.model.{part}.{k}" for part in ("actor", "critic") for k in (
            "use_rnn=true", "layers=[512,512]", "parameter_sharing=true", "dtype=bfloat16")],
    ], E=256, iters=2, per_iteration={"fwd_wide": 130, "bwd_wide": 8, "dw": 8, "reduce": 8},
        modules=[port_ac], T=120)
    mmm2_report(state, [state.model.actor, state.model.critic])
    del state

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # --- 16. resume_idqn: the train phase's run at full width, saved
        # after iteration 2 and resumed from there in another run dir
        idqn_dir, resume_idqn_counts = resume_phase("resume_idqn", smi, [
            "+algorithm=idqn", "env.name=lbforaging:Foraging-8x8-2p-3f-v3", "algorithm.model.use_rnn=true",
            "algorithm.model.layers=[128,128]", "algorithm.batch_size=1024", "algorithm.buffer_size=131072",
            *DQN_ARGV,
        ], E=65536, per_iteration={"fwd": 25, "bwd": 8, "dw": 8, "reduce": 8}, run_dir=tmp)
        torch.cuda.empty_cache()
        # --- 17. resume_mappo: the same on train_mappo's run (no replay; a
        # target critic, a recurrent actor and critic)
        _, resume_mappo_counts = resume_phase("resume_mappo", smi, [
            "+algorithm=mappo", "env.name=lbforaging:Foraging-8x8-2p-3f-v3",
            "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true",
        ], E=8192, per_iteration={"fwd": 35, "bwd": 8, "dw": 8, "reduce": 8}, run_dir=tmp)
        torch.cuda.empty_cache()
        # --- 18. eval_cli and 19. video: the eval CLI on resume_idqn's run,
        # the GRU at (o), and with a video at (y)
        eval_counts = eval_phase("eval_cli", smi, idqn_dir, tmp)
        video_counts = eval_phase("video", smi, idqn_dir, tmp, video_frames=50)
        video_counts = {k: v - eval_counts[k] for k, v in video_counts.items()}  # the video's own
        # --- 20. preemption: SIGTERM, then resume=auto, in subprocesses
        preemption_phase("preemption", smi, tmp / "preemption")

    # --- 21-25. sweeps: the search CLI, the units of a group in one train
    # state, each GRU launch serving all units of a group
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.cuda.empty_cache()
        idqn_groups, sweep_counts = sweep_idqn_phase("sweep_idqn_rnn", smi, tmp / "idqn")
        unit_parity_phase("sweep_unit_parity", smi, idqn_groups[0], (0, 31))
        # --- 32. analyze (slice 15): summary and best over this run tree
        analyze_phase("analyze", smi, idqn_groups)
        sweep_ref = {k: idqn_groups[0][k] for k in ("cfg", "seeds", "run_dir", "units", "dirs", "variants")}
        del idqn_groups
        torch.cuda.empty_cache()
        sweep_mappo_counts = sweep_mappo_phase("sweep_mappo_rnn", smi, tmp / "mappo")
        qmix_group = sweep_qmix_phase("sweep_qmix", smi, tmp / "qmix")
        unit_parity_phase("sweep_qmix_unit_parity", smi, qmix_group, (0, 7))
        del qmix_group
        search_cli_phase("search_cli", smi, tmp / "cli")

        # --- 26-31. data parallelism: one NCCL rank, two gloo ranks sharing
        # the card against one rank, a checkpoint across world sizes, a
        # sharded sweep group, and the refusal of two ranks on one GPU
        torch.cuda.empty_cache()
        dist_counts = {"dist_idqn_nccl": dist_nccl_phase("dist_idqn_nccl", smi)}
        dist_counts.update(dist_gloo_phases(smi, tmp / "dist", sweep_ref))
        dist_refusal_phase("dist_refusal", smi, tmp)

        # --- 33-38. tooling: debug mode, a located NaN from each kernel, a
        # trace of the run, the distributed profiler, a user's entry point
        # and the optimizers, agents of unequal sizes
        torch.cuda.empty_cache()
        tooling_counts = {"debug_idqn_rnn": debug_phase("debug_idqn_rnn", smi)}
        debug_nan_phase("debug_nan", smi)
        tooling_counts["trace_idqn_rnn"] = trace_phase("trace_idqn_rnn", smi, tmp)
        profile_dist_phase("profile_dist", smi)
        for run_name, c in entry_and_optimizers_phase("entry_and_optimizers", smi).items():
            tooling_counts[f"entry_and_optimizers_{run_name}"] = c
        tooling_counts["hetero"] = hetero_phase("hetero", smi)

    # --- 39. bench: the ten lanes of bench_suite.CONFIGS at full width
    gc.collect()
    torch.cuda.empty_cache()
    bench_phase("bench", smi)

    # --- 40. gate_smoke: the learning gate's runner, cut and resumed
    with tempfile.TemporaryDirectory() as tmp:
        gate_smoke_phase("gate_smoke", smi, Path(tmp))
        # the recurrent gate: the GRU kernels in subprocesses, a cut and a
        # resume through a checkpoint of recurrent weights
        gate_smoke_phase("gate_smoke_mappo_rnn", smi, Path(tmp), "mappo_rnn_lbf")

    # --- 41. card_vs_cpu: the env steps, the gates' IA2C, IDQN-RNN and
    # MAPPO-RNN updates and the card's draws against the CPU's, the
    # delivery rates against the JAX package's vendored numbers
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "card_vs_cpu", "card": smi, **port_card_vs_cpu.run_all("cuda")})

    sources = {
        "gru_fwd": "codebase_tpu/ops/fused_gru.py:80 (_fwd_kernel, pallas_call at :238)",
        "gru_bwd": "codebase_tpu/ops/fused_gru.py:105 (_bwd_kernel, pallas_call at :299)",
        "gru_dw": "codebase_tpu/ops/fused_gru.py:160 (_bwd_kernel's dW_hh/db_hh products, :160-165)",
        "gru_reduce": "codebase_tpu/ops/fused_gru.py:166 (_bwd_kernel's in-order dW_hh/db_hh sum, :166-167)",
    }
    roles = {"a": "rollout", "b": "update", "c": "ragged", "d": "qmix_update", "e": "qmix_rollout",
             "f": "ac_update", "g": "ac_rollout", "h": "smaclite_qmix_rollout", "i": "smaclite_qmix_update",
             "j": "smaclite_mappo_update", "k": "smaclite_mappo_rollout", "l": "smaclite_mappo_target",
             "m": "ac_target", "n": "qmix_eval", "o": "idqn_eval", "p": "mmm2_qmix_rollout",
             "q": "mmm2_qmix_update", "r": "mmm2_qmix_eval", "s": "mmm2_mappo_rollout", "t": "mmm2_mappo_update",
             "u": "mmm2_mappo_target", "v": "ragged_h256", "w": "ragged_h384", "x": "ragged_h896", "y": "video",
             "z1": "sweep_idqn_rollout", "z2": "sweep_idqn_update_b32", "z3": "sweep_idqn_update_b64",
             "z4": "sweep_idqn_eval", "z5": "sweep_mappo_rollout", "z6": "sweep_mappo_update",
             "z7": "sweep_mappo_target", "z8": "dist_idqn_rollout", "z9": "dist_idqn_update",
             "z10": "dist_mappo_rollout", "z11": "dist_mappo_update", "z12": "dist_mappo_target",
             "z13": "dist_sweep_rollout", "z14": "dist_sweep_update", "z15": "dist_sweep_eval",
             "z16": "gate_rnn_rollout", "z17": "gate_idqn_rnn_update", "z18": "gate_mappo_rnn_update",
             "z19": "gate_mappo_rnn_target"}
    resident = [k for k in SHAPES if SHAPES[k]["H"] == 128]
    wide = [k for k in SHAPES if SHAPES[k]["H"] != 128]
    phases = {"train": counts, "train_qmix": qmix_counts, "train_mappo": mappo_counts,
              "train_qmix_smaclite": smac_qmix_counts, "train_mappo_smaclite": smac_mappo_counts,
              "train_qmix_rware": rware_counts, "train_qmix_mmm2": mmm2_qmix_counts,
              "train_mappo_mmm2": mmm2_mappo_counts, "resume_idqn": resume_idqn_counts,
              "resume_mappo": resume_mappo_counts, "eval_cli": eval_counts, "video": video_counts,
              "sweep_idqn_rnn": sweep_counts, "sweep_mappo_rnn": sweep_mappo_counts, **gate_counts, **dist_counts,
              **tooling_counts}
    summary = []
    # (name, counter, the kernel's key in the per-shape results, the shapes
    # it takes, the shape it is timed at and the phase its launches are from)
    for kernel, counter, k, keys, at, main_phase in (
            ("gru_fwd", "fwd", "gru_fwd", resident, "b", "train"),
            ("gru_bwd", "bwd", "gru_bwd", resident, "b", "train"),
            ("gru_fwd_wide", "fwd_wide", "gru_fwd", wide, "q", "train_qmix_mmm2"),
            ("gru_bwd_wide", "bwd_wide", "gru_bwd", wide, "q", "train_qmix_mmm2"),
            ("gru_dw", "dw", "gru_dw", list(SHAPES), "b", "train"),
            ("gru_reduce", "reduce", "gru_reduce", list(SHAPES), "b", "train")):
        r = results[at][k]
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": "codebase_tpu_torch/csrc/fused_gru.cu",
            "replaces": sources[k],
            "launches": phases[main_phase][counter],
            "launches_from": main_phase,
            **{f"launches_{ph}": c[counter] for ph, c in phases.items()},
            "max_abs_err": max(results[s][k]["max_abs_err"] for s in keys),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": r["library"],
            "timed_at": f"shape {at} (G={SHAPES[at]['G']} T={SHAPES[at]['T']} B={SHAPES[at]['B']} H={SHAPES[at]['H']})",
            **{f"{roles[key]}_shape_{key}": {f: results[key][k][f] for f in (
                "ms", "plain_ms", "library_ms", "library", "bound_ms", "bound_by")} for key in keys if key != at},
        }
        if kernel in ("gru_fwd_wide", "gru_bwd_wide", "gru_dw"):
            entry["tiling"] = {key: results[key][k]["tiling"] for key in keys}
        if k == "gru_bwd":
            entry["ms_is"] = "the whole backward: the recurrence kernel, gru_dw_kernel, gru_reduce_kernel"
            for f in ("recurrence_ms", "recurrence_plain_ms", "recurrence_bound_ms", "recurrence_bound_by"):
                entry[f] = r[f]
            entry["recurrence_library"] = (
                "none: no single PyTorch call computes the recurrence without the weight "
                "gradient (cuDNN's GRU backward forms dW too)")
        summary.append(entry)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
