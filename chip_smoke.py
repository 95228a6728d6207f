"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --walls DIR

From the root of a checkout, with one CUDA card visible.  With
``--walls DIR`` it only times the main paths' `run_trials` walls of this
tree and of the checkout at DIR, alternately (`compare_walls`);
``--host-path`` runs the host path's phase alone, ``--train-path``
the training phase alone, ``--contract`` the contract checker's
phase alone, ``--moe`` the Mixture-of-Experts phase alone, ``--ssm``
the state-space and recurrent phase alone, ``--encdec`` the
encoder-decoder phase alone (with the global-memory domain leg),
``--qwen2`` the qwen2 phase alone and ``--sharded-train`` the sharded
train phase alone;
``--sweep-rank RANK
WORLD DIR`` is one rank of the sharded phase's gloo worlds, which the
script starts itself (`sweep_rank_main`).  With no arguments it

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the CUDA kernels with nvcc (one nvcc per source, started
   together: the stream kernels, the SIMT flash kernel and the wgmma
   flash kernel) and prints every stream kernel instantiation's
   registers, stack, spills, SASS instruction count and FFMA count
   (``-Xptxas -v``, ``cuobjdump -sass`` read by
   `repro_torch.contractcheck.cudacheck`) and the other kernels'
   ``-Xptxas -v`` lines; then runs the port's contract checker
   (`repro_torch.contractcheck.run_check`) over this tree with all three
   layers: the AST layer over the scoped Python files, the CUDA layer
   over ``sched_stream.cu`` and nvcc's flags, and the SASS of every
   ``sched_stream_kernel`` instantiation and ``client_merge_kernel``
   (float atomics and reductions, clock reads), printing each layer's
   findings, the functions read and their FFMA counts; any live finding,
   or a missing nvcc or cuobjdump, fails the run;
3. holds each kernel against its plain PyTorch version on the card: the
   stream kernel in its 1-D form for all eight policies at M in
   {37, 130, 300, 1000}, with a padded final window, T not a multiple of
   the warps per block and T = 140 above the SM count, the window and
   M_pad at 1024, a table of -0.0/+0.0 loads with tied
   scores, one whose est row is not ewma's function and one where a
   padding lane wins ect's argmin; its 2-D (trials x clients) form and
   the cross-client merge for all eight policies at M in {37, 130},
   with C not a multiple of the client tile, whole phantom clients, a
   padded last window, N = 16/17 and 32/33 (each form's p99 edge), the
   window and M_pad at 1024, and the merge as mean and as raw
   sum; the merge alone on operands made directly (`torch_parity.
   MERGE_CASES`: C·N past its shared-memory staging, a p99 that 48
   halvings leave below the k-th valid latency, ct not dividing C and
   above 32, an all-phantom trial); the legacy single-window
   `sched_select` wrapper; the stream kernel's ablate levels 1-3 for all
   eight policies at two shapes (the final tables and window loads bit for
   bit, the choices and latencies at level 1, zeros past the dropped
   phase), level 0 against the unablated launch, and the 2-D form's
   refusal of a level; the domain past the old 1024 caps (`check_domain`):
   both forms and the merge at M_pad 2048 with window 2048 and M_pad 4096
   with window 1024 for the six engine policies, each shape's shared
   memory against the card's opt-in budget, the 1-D kernel's time there,
   `sched_select` at N = 2048; then the global-memory instance
   (`check_global_domain`): every policy's 1-D (levels 0-3) and 2-D
   kernel bit for bit against the shared instance at a shape both take,
   both forms and the merge against their plain versions at M_pad 8192
   with window 1024 and M_pad 16384 with window 512 (past every block's
   shared memory) for the six engine policies, counts zeroed before and
   read after, the workspace bytes and the 1-D kernel's time at T = 4,
   and the shared instance's §4 ect queued time; and flash
   attention at the JAX tests' six cases, non-causal, tile sweeps,
   ``is_global``, gemma-2b's serving shape and danube-like shapes (head
   dim 120, GQA 4, sliding window, ragged S), each f32 case also in
   bf16, and gemma-2b's heads at S = 2048 and 8192: every case through
   the kernel `ops` routes it to (bf16 with a head dim that is a
   multiple of 8: the wgmma kernel; the rest: the SIMT kernel), and
   every bf16 case through the SIMT kernel too, by its wrapper;
4. drives the main paths, each with the launch counts set to 0 just
   before and read just after: the paper's §4 Monte-Carlo sweep
   (`repro_torch.core.simulate.run_trials`, 100 servers, 2,000 requests,
   100 trials, window 100, mixed workload, transient stragglers) with one
   shared log, and the same sweep per_client (200 clients, window 10
   after the clamp), each for the six engine policies, every
   `TrialResult` field held against the same prep scheduled by the plain
   versions on the card (the trials of seed 0, drawn from threefry keys
   as the JAX package draws them, so they are its trials); then the
   sharded sweep (`repro_torch.parallel.sweep`): (a) both sweeps with
   ``mesh_shape=(1,)`` and ``(1, 1)`` in an NCCL world of one, counts
   zeroed before and read after, every field equal to the unsharded
   run's; (b) gloo worlds of 2 and 4 ranks sharing the card, each rank a
   process of this script launching the kernels on its shard: (2,) and
   (4,) on the shared-log sweep, (2, 2) on per_client 200 and on a padded
   per_client case (T = 5, C = 7), every rank's fields equal to the
   unsharded run's (a client-sharded sweep's window loads to the
   two-level client mean, `policy_core.sharded_client_mean`), the walls
   printed (not a speed figure: the ranks share one card); then the
   paper evaluation: (a) the threefry kernel against its plain version,
   bit for bit, from 1 to 10^6 counters a key and over batched keys; (b)
   the §4 prep (shared log with stragglers, per_client 200) drawn on the
   card under torch's sync debug mode against the same prep drawn on
   this machine's CPU: workloads, masks, traces, keys, seeds and the
   initial loads bit-identical (the CPU tests hold the CPU's draws
   against JAX); (c)
   `run_paper_eval(seed=0)` and `run_scenario_eval(seed=0)` at the §4
   defaults on the kernel backend, counts zeroed before and read after
   (31 stream kernel launches and the threefry draws), each label's mean
   p99 and makespan and both walls; (d) the eager engine under
   ``rng="jax"`` (trh, nltr, two_choice) at T = 4 and §4 widths on the
   card against the CPU, the draws and every `TrialResult` field
   bit-identical; (e) the prep's wall and its kernels by torch.profiler;
   then the same two sweeps on the eager engine
   (``SimConfig(backend="jax")``, ``PolicyConfig(rng="lcg")`` for trh,
   nltr and two_choice) with the counts zeroed before and read after (no
   launch of any of the port's kernels but the threefry draws), every
   `TrialResult` field held bit for bit against the kernel path's on the
   same seed and
   `core.analysis`'s load balance, straggler summary, both p99s and
   makespan printed for both; the sequential kernel path
   (`engine.run_stream(backend="kernel")`, one stream kernel launch per
   call) on three single trials per policy against those trials' rows of
   `run_stream_batch`; the eager and kernel `run_trials` walls for ect
   (medians of 3) and the device's busy share of one eager run
   (torch.profiler); then the profiling and tuning path
   (`repro_torch.tune`): `kernel_phase_profile` for ect at the same size
   (its launches counted: level 0 and the ablate levels, nothing else),
   `run_trials` with the stream kernel's warps per block at 1, 2, 4 and 8
   against the default launch for the six policies, shared log and
   per_client, and the autotuner's CLI on one preset into a temporary
   table; then the LM serving path
   (`repro_torch.launch.serve.serve`): gemma-2b at full width and depth
   (random weights from seed 0), batch 4, prompt 512, 16 generated
   tokens, whose prefill must launch the wgmma flash kernel once per
   layer and the SIMT kernel never; its prefill logits are computed
   again with `attention_ref` in place of the kernel, in bf16 and in f32
   compute, and held to a tolerance; then the host path (the paper's
   client-side I/O path, `repro_torch.io` / `checkpoint` / `data`): (a)
   `benchmarks/paper_figs.py`'s completion-time experiment through the
   port's `IOClient` for six policies, each phase time equal to the JAX
   package's, with the host's µs per `HostScheduler.schedule` and per
   `write_file`; (b) the ect client's live log snapshotted into a
   `SchedState` on the card and one window scheduled from it by the
   stream kernel (one launch, counted), against the same call on the
   CPU; (c) the host half of `fig_temporal` at 100 servers, replaying
   the transient trace `make_trace` draws on the card (and the CPU's,
   which must replay alike); (d) gemma-2b's served parameters (10.0 GB)
   saved from the card through `Checkpointer` on a `LocalFSStore` in a
   temporary directory, with a straggler and a failed server, restored
   onto the card `torch.equal` to the served ones, then the failed
   server healed and `MaintainerThread` draining the redirect tables
   (free disk and host RAM printed first; too little of either fails
   the phase, naming what it needs); (e) `ObjectStoreTokens` at
   gemma-2b's vocabulary and the serve shape onto the card, each batch
   equal to `SyntheticTokens`'; `--host-path` runs this phase alone;
   then the training path (`repro_torch.train`, `launch/train`), with
   the port's kernel counts zeroed before and read after (training
   launches none of them): (a) gemma-2b at full width and depth (f32
   weights, bf16 compute, remat "block"), 6 steps on one repeated batch
   4 x 512, the loss finite and falling: step time (median of steps 2-6),
   tokens/s, the share of the bf16 dense peak, peak memory, kernels a
   step and the device's busy share (torch.profiler), the optimizer's
   share; (b) the reduced gemma-2b in f32, 3 steps on the card against
   the CPU, to the CPU tests' tolerances; (c) gemma-2b at full width cut
   to 2 layers (p, m and v 8.9 GB): 4 steps, a save through
   `Checkpointer` with a straggler and a failed server, 4 more; a fresh
   state restored onto the card takes the same 4, held to the
   uninterrupted run within rtol 1e-5 / atol 1e-6 (free disk and RAM
   checked first; save and restore GB/s); then
   ``python -m repro_torch.launch.train`` on the reduced gemma-2b in a
   subprocess, 20 steps with checkpoints every 10 under a straggler, and
   resumed to 30; `--train-path` runs this phase alone; then the
   Mixture-of-Experts phase (`models/moe.py`; `--moe` alone): (a) the
   wgmma flash kernel at llama4-scout's heads (S = 16,384, H = 40, KV =
   8, hd = 128, chunk 8,192, local and ``is_global``) and mixtral's (S =
   8,192, H = 48, KV = 8, window 4,096) against the plain version one kv
   head at a time, timed queued beside the plain version and SDPA with a
   boolean mask, with the bound over the pairs the mask keeps; (b)
   llama4-scout-17b-a16e at full width cut to 4 layers (one group: three
   chunked-local layers and the global NoPE one) and (c) mixtral-8x22b
   cut to 2 layers, each served through `serve.generate` (random weights
   from seed 0, batch 4, prompt 512, 16 tokens) with the counts zeroed
   before and read after (one wgmma launch per layer, nothing else):
   prefill and decode s, tok/s, peak memory, a decode step's kernels by
   torch.profiler, the MoE half's ms at the prefill and at a decode step;
   (d) each serve's prefill logits again through the kernel and with
   `attention_ref` in its place, every MoE layer's experts recorded: in
   f32 compute the experts equal and the logits within SERVE_F32_TOL; in
   bf16 the differing choices counted, the logits held when none differ;
   the prefill's dropped share; (e) the reduced mixtral and llama4 in
   f32, 3 train steps on the card against the CPU, and mixtral-8x22b at
   full width cut to 1 layer, 6 steps on one batch 4 x 512 (loss
   falling, step time, tokens/s, the bf16 peak share by active
   parameters, peak memory, the MoE terms), counts zeroed before and read
   after (training launches none); then the state-space and recurrent
   phase (`models/ssm.py`; `--ssm` alone): (a) xlstm-1.3b at full width
   and depth (48 layers: 6 sLSTM, 42 mLSTM) and (b) jamba-v0.1-52b at
   full width cut to 8 layers (one whole group: 7 mamba layers, the
   attention layer at 4, MoE on the odd layers; the card's free memory
   checked first), each served through `serve.generate` (random weights
   from seed 0, batch 4, prompt 512, 16 tokens) with the counts zeroed
   before and read after (xlstm: no launch; jamba: one wgmma flash launch
   a prefill, nothing else): prefill and decode s, tok/s, peak memory,
   the decode state's bytes; the prefill's forward again with each flash
   call held to its plain version, its argmax against the first served
   token, its share of the prefill and, for jamba, its dropped share; a
   decode step by torch.profiler; (c) the reduced jamba and xlstm (also
   with ``ssm.chunk`` 8, so `forward_train` takes the chunkwise mLSTM) in
   float32 on the card against the CPU: `forward_train`, every prefill
   cache field and 4 decode steps' logits within 1e-4 of the largest
   value, and 3 train steps (jamba at seq 64; xlstm 1 at seq 512);
   (d) the chunkwise mLSTM against the sequential one at xlstm's full
   widths (B 1, S 512, H 4, hd 1024, chunk 128) on the card; jamba's
   three train steps again from parameters moved by 1e-7 relative (the
   grad norm's move beside the card/CPU gap); then the encoder-decoder
   phase (`models/encdec.py`; `--encdec` alone): (a) whisper-tiny at
   full size (random f32 weights from seed 0, bf16 compute) served
   through `serve.generate`, batch 16 x 1,500 stub frames, prompt 224,
   32 tokens, counts zeroed before and read after (one wgmma launch per
   decoder layer, nothing else), the prefill's encoder, forward (each
   flash call held to its plain version) and replay timed alone, its
   logits against the `attention_ref` route in f32 and bf16, a decode
   step by torch.profiler; (b) the wgmma kernel at whisper's heads
   (B 16, H 6/6, hd 64, causal; S 224 and 448) against the plain
   version, queued beside causal SDPA, with its bound and blocks per SM;
   (c) 6 train steps at 16 x 224 with the frames (loss falling, step
   time, tokens/s, peak memory, the optimizer's share; no kernel
   launched, counted) and the reduced twin's 3 steps card against CPU;
   then the qwen2 phase (M-RoPE, the patch frontend; `--qwen2` alone):
   (a) qwen2-72b at full width cut to 8 of 80 layers (9.51B parameters,
   38.0 GB of f32; the card's free memory checked first) and (b)
   qwen2-vl-72b cut to 4, each served through `serve.generate` (random
   weights from seed 0, batch 4, prompt 512, 16 tokens; the VLM with
   patch embeddings (4, 256, 8192) and (3, 4, 512) positions, the patch
   slots on a 16 x 16 grid, shaped by `configs.shapes.input_specs`) with
   the counts zeroed before and read after (one wgmma launch a layer,
   nothing else): prefill (forward and replay) and decode s, tok/s, peak
   memory, each flash call held to its plain version, the logits against
   the `attention_ref` route in f32 and bf16, a decode step by
   torch.profiler; then `apply_mrope` at the serve's q on the card
   against the CPU, and the reduced qwen2-vl with patches and positions
   in f32 card against CPU (forward, prefill caches, 4 decode steps); (c)
   qwen2-vl-72b at full width cut to 1 layer, 6 train steps with its
   patches and positions (batch 4 x 512; no kernel launched, counted) and the reduced twin's 3 steps card against
   CPU; (d) the wgmma kernel at qwen2's heads (B 4, S 512, H 64/8, hd
   128) and jamba's (H 32/8) against the plain version, queued beside
   causal SDPA, with its bound; then the sharded train phase
   (`parallel/sharding.py`, `launch/shardutil.py`,
   `train/steps.make_sharded_train_step`, `train/compression.py`;
   ``--sharded-train`` alone): (a) a (1, 1) mesh in an NCCL world of one,
   gemma-2b at full width cut to 2 layers with its p, m and v DTensors
   on the card, 3 steps at 4 x 512 beside the unsharded step, the loss,
   grad norm, parameters, m and v compared (bit-equal expected), the step
   times and peak memory, no kernel launched (counted); (b) gloo worlds of
   2 and 4 ranks sharing the card, each rank a process of
   tests/torch_sharding_worker.py (torch and the port alone): meshes 2
   and 1x2, and 2x2, the reduced gemma-2b and mixtral-8x22b (local MoE
   pools) in f32, 3 steps, every rank against the unsharded step on the
   card; (c) `compressed_psum`
   over (a)'s and (b)'s worlds against the exact mean; then the dry-run
   phase (`launch/dryrun.py`, `train/steps.make_sharded_prefill_step` /
   `make_sharded_decode_step`, `interop`'s checkpoint name map;
   ``--dryrun`` alone): (a) production cells of the dry run, each mesh's
   in a process of its own with its fake world of 512 ranks, all on the
   ``meta`` device (gemma-2b ``train_4k`` and ``decode_32k`` on 16 x 16,
   mixtral-8x22b ``decode_32k`` on 2 x 16 x 16): memory, FLOPs, the
   dominant term, the wall; (b) the dry run's predicted peak for
   gemma-2b cut to 2 layers at 4 x 512 on a (1, 1) mesh (a fake world of
   one, in a process of its own) against ``max_memory_allocated`` of the
   real sharded step on the card, within `DRYRUN_PEAK_RTOL`, and the
   traced FLOPs over the step's time; (c) gemma-2b in the serve's
   configuration on a (1, 1) mesh in an NCCL world of one: the sharded
   prefill (through the wgmma kernel, counted) and two sharded decode
   steps bit-equal to the unsharded steps; (d) a JAX-layout checkpoint of
   the reduced gemma-2b written on the host, restored onto the card
   through the name map, its prefill logits equal to
   `interop.params_from_numpy` of the same arrays;
5. times the stream kernel (CUDA events, queued and back to back) for each
   of the six engine policies at its main-path operands, with ns per
   request per stream per wave; the merge (queued and back to back), the
   plain versions and `run_trials` (wall and stages, medians of five) for
   ``ect``: shared log, and per_client at 200 and at 64 clients; the
   threefry kernel at the prep's widest call; both
   flash kernels, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   at the serving shape and at S = 2048 and 8192 (each also with the
   host held off the device's clock, see `queued_ms`); and
   `sched_select` at N = 1024, M = 100; and the stream kernel's phase split
   for the six engine policies at the shared-log operands: levels 0-3
   queued, back to back and the kernel alone (torch.profiler), and their
   differences (metrics, steps, plan, dispatch) in ms and as shares of
   level 0;
6. prints the ``kernels`` JSON line, then, last, the device JSON line.

Any failure ends the run with a non-zero exit and no result line.  It
never runs on the CPU: without a card it exits before printing results.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the tests' shared helpers (torch and numpy only): the table variants and
# the merge cases
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import io as tio  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.contractcheck import cudacheck, layer_of  # noqa: E402
from repro_torch.contractcheck import run_check  # noqa: E402
from repro_torch.core import analysis, engine, policy_core  # noqa: E402
from repro_torch.core import simulate  # noqa: E402
from repro_torch.core.engine import KERNEL_POLICIES  # noqa: E402
from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.sched_select import kernel as skernel  # noqa: E402
from repro_torch.kernels.sched_select import ops as sops  # noqa: E402
from repro_torch.kernels.sched_select import ref as sref  # noqa: E402
from repro_torch.kernels.threefry import kernel as tfkernel  # noqa: E402
from repro_torch.kernels.threefry import ops as tfops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.tune import __main__ as tune_cli  # noqa: E402
from repro_torch.tune import profile as tune_profile  # noqa: E402
from torch_parity import MERGE_CASES, merge_case, table_variant  # noqa: E402
import torch_sharding_worker as shard_worker  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_FLOPS = 989e12
# 32-bit integer operations: the data sheet's 67 TFLOP/s of float32 are
# 128 lanes x 2 (a multiply-add) x 132 SMs x 1.98 GHz; an SM has half as
# many INT32 lanes (Hopper white paper), one operation each a cycle
INT32_OPS_PER_S = F32_OPS_PER_S / 4
# integer operations of one threefry2x32 hash of a counter pair: 20
# rounds of an add, a rotate (one funnel shift) and an xor, five key
# injections of three adds, two adds of the key and two xors of its
# schedule, and the xor of the two words where the bits are taken
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2 + 1

BODY_POLICIES = tuple(skernel.POLICY_CODES)
# (T, M, W, window, table): a few streams; T above the 132 SMs at one warp
# per block; the window and M_pad at 1024; initial tables (`initial_tables`) of -0.0 and +0.0
# loads with exactly tied scores, with an est row ewma does not give, and
# where a padding lane wins ect's argmin
CHECK_SHAPES = ((5, 37, 4, 32, "init"), (7, 130, 3, 50, "init"),
                (6, 300, 3, 40, "init"), (140, 37, 2, 16, "init"),
                (2, 1000, 1, 1024, "init"), (4, 37, 3, 16, "signed_zeros"),
                (4, 37, 3, 16, "warm"), (3, 37, 2, 16, "pad_wins"))
# (T, C, M, W, window, client_tile, phantom clients): C not a multiple of
# the client tile, whole phantom clients; N = 16 and 17 on either side of
# the 2-D form's p99 held in registers (N <= its 16 lanes per stream);
# N = 32 and 33, the 1-D form's edge; the window and M_pad at 1024, two
# streams to a warp
GRID_SHAPES = ((3, 7, 37, 3, 16, 2, 2), (5, 40, 130, 2, 10, 32, 3),
               (2, 9, 37, 1, 16, 4, 1), (2, 9, 37, 1, 17, 4, 1),
               (2, 9, 37, 2, 16, 4, 1), (2, 9, 37, 3, 11, 4, 1),
               (2, 3, 1000, 1, 1024, 2, 1))
# the ablate levels' checks: a few streams, and T above the SMs
ABLATE_SHAPES = (CHECK_SHAPES[0], CHECK_SHAPES[3])
LEVELS = skernel.ABLATE_LEVELS
KW = dict(threshold=2.0, lam=50.0, window_dt=0.02, observe=True,
          renorm=True)
REPS = 20
MAX_QUEUED = 500  # kernel launches queued at once: below the launch queue
HELD = []  # per queued reading: did the device wait for the host?
PER_CLIENT_NOTE = "per_client window clamp"

# flash attention against its plain version: (B, S, H, KV, hd, window,
# chunk, dtype, extra keywords) — the JAX tests' six cases, non-causal
# (window ignored), tile sweeps, is_global, gemma-2b's serving shape,
# danube-like shapes (head dim 120, GQA 4, window, ragged S); then the
# bf16 twin of each f32 case and gemma-2b's heads at S = 2048 and 8192
_FLASH_BASE = (
    (2, 64, 4, 2, 32, None, None, "float32", {}),
    (1, 128, 4, 1, 64, None, None, "float32", {}),
    (2, 96, 4, 4, 16, 32, None, "float32", {}),
    (1, 128, 8, 2, 32, None, 32, "float32", {}),
    (1, 64, 2, 2, 128, None, None, "bfloat16", {}),
    (1, 80, 4, 2, 24, 24, None, "float32", {}),
    (2, 64, 4, 4, 32, 8, None, "float32", dict(causal=False)),
    (1, 128, 4, 2, 32, None, None, "float32", dict(block_q=16, block_k=16)),
    (1, 128, 4, 2, 32, None, None, "float32", dict(block_q=32, block_k=64)),
    (1, 130, 4, 2, 32, None, 32, "float32", dict(block_q=48, block_k=24)),
    (1, 64, 4, 2, 32, 8, 16, "float32", dict(is_global=True)),
    (4, 512, 8, 1, 256, None, None, "bfloat16", {}),
    (1, 1000, 8, 2, 120, 64, None, "float32", {}),
    (2, 1000, 32, 8, 120, 256, None, "bfloat16", {}),
)
FLASH_CHECKS = _FLASH_BASE + tuple(
    (*c[:7], "bfloat16", c[8]) for c in _FLASH_BASE if c[7] == "float32") + (
    (1, 2048, 8, 1, 256, None, None, "bfloat16", {}),
    (1, 8192, 8, 1, 256, None, None, "bfloat16", {}),
)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the serving path: gemma-2b at full width and depth
SERVE_ARGS = ["--arch", "gemma-2b", "--batch", "4", "--prompt-len", "512",
              "--gen", "16", "--seed", "0"]
# prefill logits, kernel against attention_ref in its place.  In f32
# compute the two routes differ only in the order of float32 sums: 1e-3
# absolute.  In bf16 compute each route rounds every product to bf16 (a
# step of 2**-8 relative) and a one-step difference moves on through the
# 18 layers: 0.02 of the largest |logit| of the f32 route, five bf16 steps
# at that logit (gemma-2b's random-weight logits reach about 14).
SERVE_F32_TOL = 1e-3
SERVE_BF16_REL_TOL = 0.02
# (B, S) timed at gemma-2b's heads (H=8, KV=1, hd=256, bf16, causal)
FLASH_TIMED = ((4, 512), (1, 2048), (1, 8192))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs(got, want) -> float:
    return max((a.double() - b.double()).abs().max().item()
               for a, b in zip(got, want) if a.numel())


def stream_fields_ok(got, want):
    """(contract fields bit-exact, probs err, ewma/est relative err) of
    the five per-stream outputs, any leading shape."""
    ch, lat, tab, wl, met = got
    rch, rlat, rtab, rwl, rmet = want
    exact = (torch.equal(ch, rch) and torch.equal(lat, rlat)
             and torch.equal(tab[..., 0, :], rtab[..., 0, :])
             and torch.equal(wl, rwl) and torch.equal(met, rmet))
    d_probs = (tab[..., 1, :] - rtab[..., 1, :]).abs().max().item()
    rel = ((tab[..., 2:, :] - rtab[..., 2:, :]).abs()
           / rtab[..., 2:, :].abs().clamp_min(1.0)).max().item()
    return exact, d_probs, rel


def timed_ms(fn, reps=REPS) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launches_per_call(fn) -> int:
    """The kernels one call of ``fn`` launches, by torch.profiler: a
    wrapper's small tensor operations each take a slot of the card's
    launch queue beside its kernel."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return max(1, sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA))


def kernel_alone_ms(fn, name, calls=REPS):
    """Mean device ms of the kernels whose name holds ``name`` over
    ``calls`` calls of ``fn``, by torch.profiler: the kernel alone, without
    the wrapper's other kernels or the host's gaps.  None if the trace
    holds no such kernel for every call (not measured)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key
              and e.self_device_time_total > 0]
    if sum(e.count for e in events) != calls:
        return None
    return sum(device_ms(e) for e in events) / calls


def queued_ms(fn, reps=REPS, per_call=1) -> float:
    """Mean ms per call of ``fn`` by CUDA events, with the device held
    busy (``torch.cuda._sleep``) while the host queues the calls, so the
    events time the device alone and not the host's launch rate.  At
    most `MAX_QUEUED` launches, ``per_call`` a call, below the depth of
    the card's launch queue (a full queue blocks the host until the device
    drains it).  A reading
    whose start event had already run when the last call was queued (the
    host fell behind the device, or a wrapper synchronises) is marked in
    `HELD`: it includes the device's waits for the host.  The sleep lasts
    at least 25 ms and twice the host's time to queue the calls, from its
    rate over the three warm-up calls."""
    reps = max(1, min(reps, MAX_QUEUED // per_call))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # about 2e6 cycles a ms at the H100's 1.98 GHz; longer at lower clocks
    torch.cuda._sleep(int(max(50_000_000, 2 * reps * host_ms * 2e6)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    HELD.append(start.query())
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def steady_ms(timer, fn, span_ms=25.0, runs=5):
    """(median, least, largest, held) of ``runs`` timings of ``fn`` by
    ``timer`` (`timed_ms` or `queued_ms`), each over enough calls to span
    about ``span_ms`` of device time (`queued_ms` fewer where the calls'
    launches would fill the launch queue): a short kernel's single
    reading moves with the card's clocks from one moment to the next.
    ``held``: some queued reading included the device's waits for the
    host."""
    kw = {}
    if timer is queued_ms:
        kw["per_call"] = launches_per_call(fn)
    first = len(HELD)
    reps = max(REPS, int(span_ms / max(timer(fn, **kw), 1e-3)))
    times = sorted(timer(fn, reps=reps, **kw) for _ in range(runs))
    return times[len(times) // 2], times[0], times[-1], any(HELD[first:])


def held_note(reading) -> str:
    """A mark for a `steady_ms` reading by `queued_ms` that includes the
    device's waits for the host."""
    return " (host-held)" if reading[3] else ""


def once_ms(fn) -> float:
    """ms of one call of ``fn`` by CUDA events (the slow plain versions)."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bound(bytes_moved: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


# -- kernels against their plain versions ------------------------------------


# a stream kernel instantiation's mangled name: <policy, lanes, level,
# instance (0 shared memory, 1 global memory)>
INSTANCE = re.compile(r"sched_stream_kernelILi(\d)ELi(\d+)ELi(\d)ELi(\d)E")
# the stream kernel's instantiations of one policy: (lanes, level) in
# each instance
LANE_LEVELS = [(16, 0)] + [(32, lv) for lv in LEVELS]


def stream_kernel_table() -> dict:
    """Print every stream kernel instantiation's registers, stack frame
    and spill bytes (ptxas) and SASS instruction and FFMA counts, by
    policy and instance (shared, then global memory): level 0 with 16 and
    32 lanes a stream, the ablate levels 1-3 with 32.  Returns
    ``sched_stream.cu``'s SASS functions by mangled name
    (`cudacheck.read_sass`)."""
    props, cur = {}, None
    for line in _build.build_log(skernel.SOURCE).splitlines():
        m = INSTANCE.search(line)
        if m and "Compiling entry" in line:
            cur = tuple(map(int, m.groups()))
            props[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if cur and m:
            props[cur].update(stack=int(m[1]), spill=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            props[cur]["regs"] = int(m[1])
            cur = None
    funcs = cudacheck.read_sass(_build.build(skernel.SOURCE))
    sass = {tuple(map(int, m.groups())): fn for fn in funcs.values()
            if (m := INSTANCE.search(fn.mangled))}
    if set(sass) != set(props):
        fail(f"cuobjdump listed {len(sass)} stream kernel instantiations, "
             f"ptxas compiled {len(props)}")
    print(f"  sched_stream.cu: {len(props)} stream kernel instantiations; "
          "registers / stack bytes / spill bytes / SASS instructions / "
          "FFMA")
    for name, code in skernel.POLICY_CODES.items():
        for gmem, label in ((0, "shared"), (1, "global")):
            cells = []
            for lanes, level in LANE_LEVELS:
                pr = props.get((code, lanes, level, gmem), {})
                fn = sass[(code, lanes, level, gmem)]
                cells.append(f"{lanes}L/L{level} {pr.get('regs')}/"
                             f"{pr.get('stack')}/{pr.get('spill')}/"
                             f"{fn.instructions}/{fn.ffma}")
            print(f"    {name:>10s} {label}: " + ", ".join(cells))
    return funcs


def check_contract(funcs: dict) -> None:
    """The port's contract checker over this tree, all three layers
    (`run_check` with ``sass=True``: it builds ``sched_stream.cu`` and
    reads its SASS); fails on any live finding, warnings too.  ``funcs``:
    `stream_kernel_table`'s SASS functions, for the counts printed."""
    t0 = time.perf_counter()
    findings = run_check(Path(__file__).resolve().parent, sass=True)
    for layer in ("ast", "cuda", "sass"):
        mine = [f for f in findings if layer_of(f) == layer]
        live = [f for f in mine if not f.suppressed]
        print(f"  contract {layer} layer: {len(live)} live finding(s), "
              f"{len(mine) - len(live)} suppressed")
        for f in live:
            print(f"    {f.format()}")
    stream = [fn for fn in funcs.values() if INSTANCE.search(fn.mangled)]
    merge = [fn for fn in funcs.values() if fn.name == "client_merge_kernel"]
    if len(stream) != 2 * 8 * len(LANE_LEVELS) or len(merge) != 1:
        fail(f"the SASS layer read {len(stream)} stream kernel "
             f"instantiations and {len(merge)} merge kernels")
    ffma = sorted(fn.ffma for fn in stream)
    print(f"  contract sass layer read {len(funcs)} functions of "
          f"sched_stream.cu: {len(stream)} sched_stream_kernel "
          f"instantiations (FFMA {ffma[0]}-{ffma[-1]}, each in the table "
          f"above) and client_merge_kernel (FFMA {merge[0].ffma}, "
          f"{merge[0].instructions} SASS instructions)")
    live = [f for f in findings if not f.suppressed]
    if live:
        fail(f"the contract checker has {len(live)} live finding(s): "
             + "; ".join(f.format() for f in live[:5]))
    print(f"contract phase: {time.perf_counter() - t0:.1f} s")


def initial_tables(kind, t, m, dev):
    """(T, 4, M) initial tables: "init" is `policy_core.init_table`; the
    other kinds are the tests' `table_variant` of it."""
    tables = policy_core.init_table(m, batch=t, device="cpu").numpy()
    if kind != "init":
        tables = table_variant(tables, kind, m)
    return torch.from_numpy(tables).to(dev)


def stream_operands(t, m, n_win, win, table, seed, dev):
    """The 1-D operands of one case on ``dev``: about a fifth of the
    requests invalid and the last third of the final window padding."""
    rng = np.random.default_rng(seed)
    n = n_win * win
    valid = rng.random((t, n)) > 0.2
    valid[:, n - win // 3:] = False                # padded final window
    tables = initial_tables(table, t, m, dev)
    return (torch.from_numpy(rng.integers(0, 8 * m, (t, n)).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.uniform(1.0, 20.0, (t, n)).astype(
                np.float32)).to(dev),
            torch.from_numpy(valid).to(dev), tables,
            torch.from_numpy(rng.integers(0, 2 ** 32, (t,))).to(dev),
            torch.from_numpy(rng.uniform(50.0, 300.0, (t, n_win, m)).astype(
                np.float32)).to(dev))


def same_bits(a, b) -> bool:
    """Equal shapes and bit patterns (float32 / int32 tensors)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_case(t, m, n_win, win, table, policy, seed, dev):
    """1-D kernel against plain version on the card for one case; returns
    the largest absolute difference over all outputs."""
    args = stream_operands(t, m, n_win, win, table, seed, dev)
    kw = dict(KW, n_servers=m, window_size=win, policy=policy)
    got = sops.sched_stream_batch(*args, **kw)
    torch.cuda.synchronize()
    want = sops.sched_stream_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    exact, d_probs, rel = stream_fields_ok(got, want)
    ok = exact and d_probs <= 1e-6 and rel <= 1e-6
    print(f"check {policy:>10s} T={t} M={m} W={n_win} win={win} {table}: "
          f"contract fields {'bit-exact' if exact else 'DIFFER'}, "
          f"probs err {d_probs:.3g}, ewma/est rel err {rel:.3g} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel disagrees with its plain version ({policy}, M={m})")
    return max_abs(got, want)


def check_ablate(dev):
    """The ablated 1-D kernel against the ablated plain version for all
    eight policies at `ABLATE_SHAPES` and levels 1-3: the final tables and
    window loads bit for bit at every level, the choices and latencies at
    level 1, zeros past the dropped phase (the metric row from level 1 on,
    the choices and latencies from level 2 on), one ablated launch each
    and no other.  Level 0 must be the unablated launch; the 2-D form
    refuses a level in its wrapper and in the C entry.  Returns the largest
    absolute difference."""
    worst = 0.0
    for i, (t, m, n_win, win, table) in enumerate(ABLATE_SHAPES):
        for j, policy in enumerate(BODY_POLICIES):
            args = stream_operands(t, m, n_win, win, table,
                                   5000 + 100 * i + j, dev)
            kw = dict(KW, n_servers=m, window_size=win, policy=policy)
            full = sops.sched_stream_batch(*args, **kw)
            level0 = sops.sched_stream_batch(*args, ablate=0, **kw)
            verdicts = ["L0 " + ("= full" if all(
                same_bits(a, b) for a, b in zip(full, level0)) else "DIFFER")]
            for level in LEVELS[1:]:
                before = all_counts()
                got = sops.sched_stream_batch(*args, ablate=level, **kw)
                torch.cuda.synchronize()
                step = {k: all_counts()[k] - before[k] for k in before}
                want = sops.sched_stream_batch_plain(*args, ablate=level,
                                                     **kw)
                ch, lat, tab, wl, met = got
                ok = (same_bits(tab, want[2]) and same_bits(wl, want[3])
                      and same_bits(met, want[4]) and not met.any()
                      and same_bits(ch, want[0]) and same_bits(lat, want[1])
                      and (level == 1 or not (ch.any() or lat.any()))
                      and step == {k: int(k == "sched_stream_ablate")
                                   for k in step})
                verdicts.append(f"L{level} {'ok' if ok else 'FAIL'}")
                worst = max(worst, max_abs(got, want))
            print(f"ablate {policy:>10s} T={t} M={m} W={n_win} win={win}: "
                  + ", ".join(verdicts))
            if any("DIFFER" in v or "FAIL" in v for v in verdicts):
                fail(f"the ablated kernel disagrees with its plain version "
                     f"({policy}, T={t})")
    t, c, m, n_win, win = 2, 3, 37, 2, 16
    gargs = [x.reshape(t, c, *x.shape[1:]) for x in stream_operands(
        t * c, m, n_win, win, "init", 6000, dev)[:5]]
    gargs.append(stream_operands(t, m, n_win, win, "init", 6001, dev)[5])
    kw = dict(KW, n_servers=m, window_size=win, policy="ect")
    refused = []
    try:
        sops.sched_stream_grid(*gargs, ablate=1, **kw)
    except ValueError:
        refused.append("wrapper")
    try:
        skernel._launch_streams(*sops.pad_operands(*gargs),
                                form="sched_stream_grid", lead=(t, c),
                                ablate=1, alpha=0.25, **kw)
    except RuntimeError:
        refused.append("C entry")
    print(f"ablate on the 2-D form refused by: {', '.join(refused)}")
    if refused != ["wrapper", "C entry"]:
        fail("the 2-D form accepted an ablate level")
    return worst


def check_grid_case(shape, policy, merge_mean, seed, dev):
    """2-D kernels against the plain version on the card for one case;
    returns the largest absolute differences (per-stream, merged)."""
    t, c, m, n_win, win, ct, n_phantom = shape
    rng = np.random.default_rng(seed)
    n = n_win * win
    valid = rng.random((t, c, n)) > 0.2
    valid[..., n - win // 3:] = False              # padded last window
    valid[:, c - n_phantom:] = False               # whole phantom clients
    tables = policy_core.init_table(m, batch=t * c, device=dev).reshape(
        t, c, 4, m)
    tables[:, :, 0] = torch.from_numpy(
        rng.uniform(0.0, 60.0, (t, c, m)).astype(np.float32)).to(dev)
    args = (torch.from_numpy(rng.integers(0, 8 * m, (t, c, n)).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.uniform(1.0, 20.0, (t, c, n)).astype(
                np.float32)).to(dev),
            torch.from_numpy(valid).to(dev), tables,
            torch.from_numpy(rng.integers(0, 2 ** 32, (t, c))).to(dev),
            torch.from_numpy(rng.uniform(50.0, 300.0, (t, n_win, m)).astype(
                np.float32)).to(dev))
    kw = dict(KW, n_servers=m, window_size=win, policy=policy,
              client_tile=ct, merge_mean=merge_mean)
    got = sops.sched_stream_grid(*args, **kw)
    torch.cuda.synchronize()
    want = sops.sched_stream_grid_plain(*args, **kw)
    torch.cuda.synchronize()
    exact, d_probs, rel = stream_fields_ok(got[:5], want[:5])
    merged_exact = all(torch.equal(a, b) for a, b in zip(got[5:], want[5:]))
    real = int(got[6][0, policy_core.MET_N_CLIENTS].item())
    ok = (exact and merged_exact and d_probs <= 1e-6 and rel <= 1e-6
          and real == c - n_phantom)
    print(f"grid  {policy:>10s} T={t} C={c} M={m} W={n_win} win={win} "
          f"ct={ct} mean={merge_mean}: per-stream "
          f"{'bit-exact' if exact else 'DIFFER'}, merge "
          f"{'bit-exact' if merged_exact else 'DIFFER'} ({real} real "
          f"clients), probs err {d_probs:.3g}, ewma/est rel err {rel:.3g} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"2-D kernels disagree with their plain version ({policy}, "
             f"M={m}, merge_mean={merge_mean})")
    return max_abs(got[:5], want[:5]), max_abs(got[5:], want[5:])


def check_merge_cases(dev):
    """The cross-client merge kernel against its plain version on the card
    on operands made directly (`torch_parity.MERGE_CASES`: the main path's
    shapes, C·N past the shared-memory staging, a p99 that 48 halvings
    leave below the k-th valid latency, ct not dividing C and above 32, an
    all-phantom trial), each as mean and as raw sum; every output
    bit-exact.  Returns the largest absolute difference."""
    worst = 0.0
    for i, (t, c, n, n_win, m_pad, ct, kind) in enumerate(MERGE_CASES):
        args = [torch.from_numpy(a).to(dev)
                for a in merge_case(t, c, n, n_win, m_pad, kind, seed=i)]
        for merge_mean in (True, False):
            before = skernel.LAUNCHES["client_merge"]
            got = skernel.client_merge_call(*args, client_tile=ct,
                                            merge_mean=merge_mean)
            torch.cuda.synchronize()
            want = sref.client_merge_ref(*args, client_tile=ct,
                                         merge_mean=merge_mean)
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            note = ""
            if kind == "far_max" and merge_mean:
                # the p99 lies below v_k, the k-th smallest valid latency
                lat, val = args[2][0].flatten(), args[3][0].flatten() != 0
                nval = np.float32(val.sum().item())
                k = int(np.ceil(np.float32(0.99) * nval))
                v_k = lat[val].sort().values[k - 1].item()
                p99 = got[1][0, policy_core.MET_P99].item()
                exact = exact and p99 < v_k
                note = f", p99 {p99:.6g} below v_k {v_k:.6g}"
            ok = exact and skernel.LAUNCHES["client_merge"] == before + 1
            print(f"merge T={t} C={c} N={n} W={n_win} M_pad={m_pad} ct={ct} "
                  f"{kind} mean={merge_mean}: "
                  f"{'bit-exact' if exact else 'DIFFER'}{note} -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"client_merge disagrees with its plain version ({i}, "
                     f"merge_mean={merge_mean})")
            worst = max(worst, max_abs(got, want))
    return worst


def check_select(dev):
    """The legacy single-window wrapper against its plain version."""
    rng = np.random.default_rng(9)
    c, n, m = 8, 500, 37
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8 * m, (c, n)).astype(np.int32),
        rng.uniform(1.0, 20.0, (c, n)).astype(np.float32),
        rng.uniform(0.0, 60.0, (c, m)).astype(np.float32),
        rng.integers(0, 2 ** 32, (c,)))]
    for policy in sops.STATIC_POLICIES:
        kw = dict(n_servers=m, threshold=2.0, lam=50.0, policy=policy)
        got = sops.sched_select(*args, **kw)
        torch.cuda.synchronize()
        want = sops.sched_select_plain(*args, **kw)
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"select {policy:>10s} C={c} N={n} M={m}: "
              f"{'bit-exact' if ok else 'DIFFER'}")
        if not ok:
            fail(f"sched_select disagrees with its plain version ({policy})")


# -- the main paths -----------------------------------------------------------


def run_main_path(name, cfg, log, pols, dev, expect):
    """Drive `run_trials` for every policy with the launch counts zeroed
    just before and read just after; each run must launch exactly the
    kernels of ``expect`` once.  Returns (results, launch counts)."""
    results = {}
    zero_counts()
    for p, pol in pols.items():
        before = all_counts()
        results[p] = simulate.run_trials(0, cfg, pol, log)
        step = {k: all_counts()[k] - before[k] for k in before}
        if but_threefry(step) != {k: int(k in expect)
                                  for k in but_threefry(before)} \
                or step["threefry"] < 1:
            fail(f"{name} run_trials({p}) launched {step}, expected one "
                 f"launch of each of {expect} and the threefry draws")
    torch.cuda.synchronize()
    counts = all_counts()
    if but_threefry(counts) != {k: len(pols) * int(k in expect)
                                for k in but_threefry(counts)}:
        fail(f"{name} main path launched {counts}")
    print(f"{name} main path: launches {counts}")

    t, r, m = cfg.n_trials, cfg.n_requests, cfg.n_servers
    _, per, _, win = simulate._client_split_shape(cfg)
    n_win = -(-per // win) if cfg.client_model == "per_client" \
        else cfg.n_windows
    for p, res in results.items():
        if res.chosen.shape != (t, r) or res.window_loads.shape != (
                t, n_win, m):
            fail(f"{name} {p}: unexpected result shapes")
        if not (torch.isfinite(res.latencies).all()
                and torch.isfinite(res.server_loads).all()
                and torch.isfinite(res.phase_time).all()
                and torch.isfinite(res.window_loads).all()):
            fail(f"{name} {p}: non-finite values in the result")
        if not bool((res.n_assigned.sum(dim=-1) == r).all()):
            fail(f"{name} {p}: n_assigned does not count every request")
    return results, counts


def prep(cfg, log, dev):
    """The §4 prep of `run_trials(0, ...)`: the trials of seed 0."""
    return simulate._prep_trials(simulate.trial_keys(0, cfg, dev), cfg, log)


def recording(fn, store):
    """``fn`` that also keeps its positional/keyword arguments and outputs."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        store.update(args=args, kw=kw, out=out)
        return out
    return wrapped


def check_shared_log(results, cfg, log, pols, dev):
    for p, res in results.items():
        init, mask, works, states, traces, seeds = prep(cfg, log, dev)
        sched = simulate._sched_trials(
            cfg, pols[p], log, works, states, seeds, traces,
            stream_batch=sops.sched_stream_batch_plain)
        plain = simulate._post_trials(cfg, init, mask, works, traces, *sched)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(res, plain)):
            bad = [f for f, a, b in zip(res._fields, res, plain)
                   if not torch.equal(a, b)]
            fail(f"{p}: kernel run differs from the plain version in {bad}")
        p99 = policy_core.nearest_rank_p99(
            res.latencies, torch.ones_like(res.latencies, dtype=torch.bool))
        print(f"shared_log {p:>10s}: mean p99 latency "
              f"{p99.mean().item():.4f} s, mean makespan "
              f"{res.phase_time.mean().item():.4f} s, bit-exact with the "
              "plain version on the card")


def check_per_client(results, cfg, log, pols, dev):
    """Every TrialResult field against the plain versions on the same
    prep, and the 2-D kernels' nine outputs against the plain version's at
    the main path's shapes.  Returns the largest absolute differences
    (per-stream, merged)."""
    err_streams = err_merge = 0.0
    for p, res in results.items():
        init, mask, works, states, traces, seeds = prep(cfg, log, dev)
        kern, plain_rec = {}, {}
        simulate._sched_trials(
            cfg, pols[p], log, works, states, seeds, traces,
            stream_grid=recording(sops.sched_stream_grid, kern))
        sched = simulate._sched_trials(
            cfg, pols[p], log, works, states, seeds, traces,
            stream_grid=recording(sops.sched_stream_grid_plain, plain_rec))
        plain = simulate._post_trials(cfg, init, mask, works, traces, *sched)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(res, plain)):
            bad = [f for f, a, b in zip(res._fields, res, plain)
                   if not torch.equal(a, b)]
            fail(f"per_client {p}: kernel run differs from the plain "
                 f"version in {bad}")
        got, want = kern["out"], plain_rec["out"]
        exact, d_probs, rel = stream_fields_ok(got[:5], want[:5])
        merged_exact = all(torch.equal(a, b)
                           for a, b in zip(got[5:], want[5:]))
        if not (exact and merged_exact and d_probs <= 1e-6 and rel <= 1e-6):
            fail(f"per_client {p}: 2-D kernels differ from the plain "
                 f"version at the main path's shapes")
        err_streams = max(err_streams, max_abs(got[:5], want[:5]))
        err_merge = max(err_merge, max_abs(got[5:], want[5:]))
        cm = got[6]
        print(f"per_client {p:>10s}: mean merged p99 latency "
              f"{cm[:, policy_core.MET_P99].mean().item():.4f} s, mean "
              f"makespan {res.phase_time.mean().item():.4f} s, "
              f"{cm[:, policy_core.MET_N_CLIENTS].min().item():.0f} real "
              "clients per trial, bit-exact with the plain version on the "
              "card")
    return err_streams, err_merge


# -- the sharded sweep (repro_torch.parallel.sweep) ---------------------------

# phase (b)'s gloo worlds: world size -> (case, mesh shape) in run order
SWEEP_WORLDS = {2: (("shared_log", (2,)),),
                4: (("shared_log", (4,)), ("per_client", (2, 2)),
                    ("padded", (2, 2)))}
SWEEP_TIMEOUT_S = 300  # a world's ranks, from spawn to exit
GLOO_NOTE = ("gloo ranks sharing one card, collectives through host "
             "memory: not a speed figure for any deployment")


def engine_pols():
    """The six engine policies with the main paths' thresholds."""
    return {p: PolicyConfig(name=p, threshold=0.05 if p == "ect" else 5.0)
            for p in KERNEL_POLICIES}


def paper_cfgs():
    """(config, log config) by case: the §4 sweep with transient
    stragglers on one shared log and per_client (200 clients), and the
    sharded phase's padded per_client case (T = 5, C = 7: neither divides
    a (2, 2) mesh)."""
    cfg = simulate.SimConfig(scenario=simulate.ScenarioConfig("transient"))
    pc_cfg = dataclasses.replace(cfg, client_model="per_client")
    padded = dataclasses.replace(pc_cfg, n_trials=5, n_clients=7)
    return {name: (c, simulate.default_log_cfg(c)) for name, c in
            (("shared_log", cfg), ("per_client", pc_cfg),
             ("padded", padded))}


def timed_run(cfg, pol, log):
    """`run_trials` of seed 0 and its wall in ms, to the device's end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate.run_trials(0, cfg, pol, log)
    torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


def client_sharded_loads(cfg, log, pol, c_dev, dev):
    """The window loads a sweep whose clients are split over ``c_dev``
    ranks gives: `policy_core.sharded_client_mean` (the rank axis as one
    more association level) over the unsharded per-client window loads
    of the kernel path, at the resolved client tile."""
    _, _, works, states, traces, k_sched = prep(cfg, log, dev)
    c, per, pad, win = simulate._client_split_shape(cfg)
    t = works.object_ids.shape[0]
    run_works = simulate._split_clients(works, c, per, pad)
    run_states = type(states)(*(x[:, None].expand((t, c) + x.shape[1:])
                                for x in states))
    res, _, _ = engine.run_stream_batch(
        run_states, run_works, random.split(k_sched, c), policy=pol,
        log_cfg=log, window_size=win, traces=traces,
        window_dt=simulate._window_dt(cfg), observe=simulate._observe(cfg))
    cvalid = run_works.valid.any(dim=-1)
    ct = policy_core.resolve_client_tile(c, cfg.client_tile)
    return torch.stack([policy_core.sharded_client_mean(
        res.window_loads[i], cvalid[i], ct, c_dev) for i in range(t)])


def check_sharded(label, got, want, loads=None):
    """Every `TrialResult` field of ``got`` (a field dict) equal to
    ``want``'s, bit for bit; with ``loads`` the window loads equal to it
    (a client-sharded sweep's two-level mean) instead."""
    want = dict(want._asdict(), **({} if loads is None
                                   else {"window_loads": loads}))
    bad = [f for f, v in want.items()
           if not (same_bits(got[f].to(v.device), v) if v.is_floating_point()
                   else torch.equal(got[f].to(v.device), v))]
    if bad:
        fail(f"{label}: differs from the unsharded run in {bad}")


def run_sharded_world_of_one(cfgs, pols, unsharded, card):
    """(a) `run_trials` with ``mesh_shape=(1,)`` (shared log) and
    ``(1, 1)`` (per_client 200) in the NCCL world of one that
    `make_sweep_mesh` starts without a process group, counts zeroed just
    before each sweep and read just after: every field equal to the
    unsharded run's, one launch of each kernel of the path a run.
    Returns the counts by case."""
    import torch.distributed as dist
    counts = {}
    for name, shape, expect in (
            ("shared_log", (1,), ("sched_stream",)),
            ("per_client", (1, 1), ("sched_stream_grid", "client_merge"))):
        cfg, log = cfgs[name]
        mcfg = dataclasses.replace(cfg, mesh_shape=shape)
        zero_counts()
        walls = []
        for p, pol in pols.items():
            res, wall = timed_run(mcfg, pol, log)
            walls.append(wall)
            check_sharded(f"(a) {name} mesh {shape} {p}", res._asdict(),
                          unsharded[name][p])
        counts[name] = all_counts()
        if but_threefry(counts[name]) != {
                k: len(pols) * int(k in expect)
                for k in but_threefry(counts[name])}:
            fail(f"(a) {name} mesh {shape} launched {counts[name]}")
        print(f"sharded (a) {name} mesh {shape}, world of one on "
              f"{dist.get_backend()}: six policies bit-identical to the "
              f"unsharded run, launches {counts[name]}; run_trials walls "
              f"{', '.join(f'{w:.1f}' for w in walls)} ms (the first "
              f"builds the mesh) on {card}")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail("(a) the world of one is not NCCL's")
    dist.destroy_process_group()
    return counts


def sweep_rank_main(rank: int, world: int, tmp: str) -> None:
    """`python3 chip_smoke.py --sweep-rank RANK WORLD DIR`: one rank of a
    gloo world on the card (the kernels already built), joined through a
    `FileStore` in DIR.  Runs its world's `SWEEP_WORLDS` cases for the six
    policies, counts zeroed before each run and read after, and saves the
    results, counts and walls to ``DIR/w<WORLD>-rank<RANK>.pt``."""
    import datetime
    import torch.distributed as dist
    warnings.filterwarnings("ignore", message=PER_CLIENT_NOTE)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / f"store{world}"),
                                     world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SWEEP_TIMEOUT_S))
    cfgs, out = paper_cfgs(), {}
    for case, shape in SWEEP_WORLDS[world]:
        cfg, log = cfgs[case]
        mcfg = dataclasses.replace(cfg, mesh_shape=shape)
        for p, pol in engine_pols().items():
            zero_counts()
            res, wall = timed_run(mcfg, pol, log)
            out[case, p] = dict(result={f: v.cpu() for f, v in
                                        res._asdict().items()},
                                counts=all_counts(), wall_ms=wall)
    torch.save(out, Path(tmp) / f"w{world}-rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def run_gloo_worlds(cfgs, pols, unsharded, dev, card):
    """(b) gloo worlds of 2 and 4 ranks sharing the card, each rank a
    process of this script (`sweep_rank_main`) launching the CUDA kernels
    on its shard: (2,) and (4,) on the shared-log sweep, (2, 2) on
    per_client 200 and on the padded case.  Every rank's fields equal the
    unsharded run's (the client-sharded window loads equal
    `client_sharded_loads`), and every rank's run launched each kernel of
    its path once.  A rank that fails or times out fails the phase.
    Returns the walls by (world, case)."""
    pad_cfg, pad_log = cfgs["padded"]
    unsharded = dict(unsharded, padded={
        p: simulate.run_trials(0, pad_cfg, pol, pad_log)
        for p, pol in pols.items()})
    loads = {case: {p: client_sharded_loads(*cfgs[case], pol, 2, dev)
                    for p, pol in pols.items()}
             for case in ("per_client", "padded")}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    walls = {}
    try:
        for world, cases in SWEEP_WORLDS.items():
            t0 = time.perf_counter()
            logs = [open(tmp / f"w{world}-rank{r}.log", "w")
                    for r in range(world)]
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--sweep-rank", str(r), str(world), str(tmp)],
                stdout=logs[r], stderr=subprocess.STDOUT)
                for r in range(world)]
            failed = []
            for r, proc in enumerate(procs):
                left = SWEEP_TIMEOUT_S - (time.perf_counter() - t0)
                try:
                    code = proc.wait(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    code = "a timeout"
                if code != 0:
                    failed.append(r)
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in logs:
                f.close()
            if failed:
                tails = "\n".join(
                    f"rank {r}: "
                    + (tmp / f"w{world}-rank{r}.log").read_text()[-2000:]
                    for r in failed)
                fail(f"(b) world of {world}: ranks {failed} failed\n{tails}")
            ranks = [torch.load(tmp / f"w{world}-rank{r}.pt")
                     for r in range(world)]
            for case, shape in cases:
                expect = ("sched_stream",) if case == "shared_log" else (
                    "sched_stream_grid", "client_merge")
                for p in pols:
                    for r, got in enumerate(ranks):
                        one = got[case, p]
                        check_sharded(
                            f"(b) world {world} {case} mesh {shape} {p} "
                            f"rank {r}", one["result"],
                            unsharded[case][p],
                            loads[case][p] if len(shape) == 2 else None)
                        step = but_threefry(one["counts"])
                        if step != {k: int(k in expect) for k in step} \
                                or one["counts"]["threefry"] < 1:
                            fail(f"(b) world {world} {case} {p} rank {r} "
                                 f"launched {one['counts']}")
                walls[world, case] = [ranks[0][case, p]["wall_ms"]
                                      for p in pols]
                cfg = cfgs[case][0]
                print(f"sharded (b) {case} (T={cfg.n_trials}"
                      + (f", C={cfg.n_clients}"
                         if cfg.client_model == "per_client" else "")
                      + f") mesh {shape} on a gloo world of {world}: every "
                      "rank bit-identical to the unsharded run"
                      + (" (window loads to the two-level client mean)"
                         if len(shape) == 2 else "")
                      + ", one launch of each kernel of the path per rank "
                      "and run; rank 0's run_trials walls "
                      + ", ".join(f"{w:.1f}" for w in walls[world, case])
                      + f" ms on {card} ({GLOO_NOTE})")
            print(f"  (world of {world}: {time.perf_counter() - t0:.1f} s "
                  "with the ranks' start)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return walls


# -- the lifted domain: past the old 1024 caps --------------------------------

# (M, window): M_pad 2048 with window 2048, M_pad 4096 with window 1024
DOMAIN_SHAPES = ((2000, 2048), (4000, 1024))
# streams past every policy's shared-memory budget on the H100, which the
# global-memory instance runs: M_pad 8192 with window 1024, M_pad 16384
# with window 512
OVER_BUDGET = (8142, 1024)
GLOBAL_SHAPES = (OVER_BUDGET, (16334, 512))
# the shared instance's §4 ect queued time before the global instance
# was added (PERF.md's kernel table, NVIDIA H100 80GB HBM3 at 700 W)
SHARED_ECT_MS = (1.3309, 1.3461)


def stream_bound(t_, n_, m_, n_win):
    """The least time of ect's function over T streams of N requests, M
    real servers and W windows: bytes in and out once over HBM — int32/
    f32/int32 request blocks, (T, 4, M) tables, (T, W, M) rates, seeds;
    choices, latencies, tables, window loads, metrics — and its float32
    operations (per request: score add+div, argmin compare, probs add, est
    max+select on every lane; per window: renorm and drain; per stream: 48
    bisection passes over N latencies).  This counts the function's work,
    not the kernel's: the kernel skips the per-request est rewrite (it
    keeps the max incrementally and derives est where a score reads it),
    but the function defines est on every lane after every request, so
    the count stays.  Returns (ms, bound by, bytes, ops)."""
    bytes_moved = 4 * (3 * t_ * n_ + t_ * 4 * m_ + t_ * n_win * m_ + t_
                       + 2 * t_ * n_ + t_ * 4 * m_ + t_ * n_win * m_
                       + t_ * policy_core.N_METRICS)
    ops = t_ * (n_ * 6 * m_ + n_win * 5 * m_ + 48 * n_ * 2)
    return (*bound(bytes_moved, ops), bytes_moved, ops)


def ablate_bound(t_, n_, m_, n_win, level):
    """`stream_bound` of ect's function at ``ablate`` level ``level``:
    level 1 drops the fused metrics (the 48 bisection passes; the metric
    row is still written, as zeros), level 2 also the per-request steps
    (the request blocks are no longer read; choices and latencies are
    still written, as zeros), leaving each window's renormalisation and
    drain over the tables and rates; level 3 also the window-start plan,
    which ect does not have, so it is level 2's.  Returns (ms, bound by,
    bytes, ops)."""
    if level == 0:
        return stream_bound(t_, n_, m_, n_win)
    requests = 0 if level >= 2 else 3 * t_ * n_
    bytes_moved = 4 * (requests + t_ * 4 * m_ + t_ * n_win * m_ + t_
                       + 2 * t_ * n_ + t_ * 4 * m_ + t_ * n_win * m_
                       + t_ * policy_core.N_METRICS)
    steps = 0 if level >= 2 else n_ * 6 * m_
    ops = t_ * (steps + n_win * 5 * m_)
    return (*bound(bytes_moved, ops), bytes_moved, ops)


def check_global_domain(dev, card):
    """(d) The global-memory instance: first every policy's 1-D kernel
    (levels 0-3) and 2-D kernel bit for bit against the shared instance at
    a shape that fits shared memory (`skernel._launch_streams` with
    ``instance="global"``); then at
    `GLOBAL_SHAPES`, which no block's shared memory holds, both forms and
    the merge against their plain versions for the six engine policies
    (the 1-D form at T = 2; the 2-D form at T = 1, C = 3 with a phantom
    client, the merge as mean and as sum in turn) through the user's
    entry points, the launch counts zeroed just before and read just
    after (the launches of the first comparison, through the private
    `skernel._launch_streams`, are not counted); the instance each shape
    takes, its workspace bytes and the 1-D
    kernel's time at T = 4; last, the shared instance's queued time for
    ect at the §4 operands.  Returns (the largest differences (1-D, 2-D,
    merge), the times by shape and policy, the global instances' entries
    of the ``kernels`` line)."""
    t0 = time.perf_counter()
    t, m, n_win, win = 5, 300, 3, 40
    args = sops.pad_operands(*stream_operands(t, m, n_win, win, "init",
                                              7400, dev))
    gargs = [x.reshape(2, 3, *x.shape[1:]) for x in sops.pad_operands(
        *stream_operands(6, m, n_win, win, "init", 7401, dev))[:5]]
    gargs.append(sops.pad_operands(*stream_operands(
        2, m, n_win, win, "init", 7402, dev))[5])
    def both(ops, **kw):
        """The shared and the global instance's outputs on ``ops``."""
        runs = [skernel._launch_streams(*ops, instance=inst, **kw)
                for inst in (None, "global")]
        if [r[0] for r in runs] != ["shared", "global"]:
            fail(f"the instances ran as {[r[0] for r in runs]}")
        return [r[1] for r in runs]

    for policy in BODY_POLICIES:
        kw = dict(KW, alpha=0.25, n_servers=m, window_size=win,
                  policy=policy)
        for level in LEVELS:
            a, b = both(args, form="sched_stream", lead=(t,), ablate=level,
                        **kw)
            if not all(same_bits(x, y) for x, y in zip(a, b)):
                fail(f"the global instance differs from the shared one "
                     f"({policy}, level {level})")
        a, b = both(gargs, form="sched_stream_grid", lead=(2, 3), **kw)
        if not all(same_bits(x, y) for x, y in zip(a, b)):
            fail(f"the global 2-D instance differs from the shared one "
                 f"({policy})")
    print(f"global domain: the global instance equals the shared one bit "
          f"for bit at T={t} M={m} W={n_win} win={win}, all eight "
          "policies, 1-D levels 0-3 and the 2-D form")

    errs, times = [0.0, 0.0, 0.0], {}
    zero_counts()
    for i, (m, win) in enumerate(GLOBAL_SHAPES):
        m_pad = sops._pad_servers(m)
        for j, policy in enumerate(KERNEL_POLICIES):
            errs[0] = max(errs[0], check_case(2, m, 1, win, "init", policy,
                                              7500 + 10 * i + j, dev))
            e_s, e_m = check_grid_case((1, 3, m, 1, win, 2, 1), policy,
                                       j % 2 == 0, 7600 + 10 * i + j, dev)
            errs[1], errs[2] = max(errs[1], e_s), max(errs[2], e_m)
    counts = all_counts()
    n_cases = len(GLOBAL_SHAPES) * len(KERNEL_POLICIES)
    want = {k: n_cases * int(k in ("sched_stream_global",
                                   "sched_stream_grid_global",
                                   "client_merge"))
            for k in but_threefry(counts)}
    if but_threefry(counts) != want:
        fail(f"the global domain's checks launched {counts}, expected "
             f"{want}")
    print(f"global domain: launches {but_threefry(counts)}")

    entries = {}
    for i, (m, win) in enumerate(GLOBAL_SHAPES):
        m_pad = sops._pad_servers(m)
        for j, policy in enumerate(KERNEL_POLICIES):
            need, budget = skernel.stream_budget(policy, m_pad, win)
            inst, ws = skernel.check_stream_domain(policy, m_pad, win, 4)
            occ = {form: skernel.stream_occupancy(form, policy, m, m_pad,
                                                  win)
                   for form in ("sched_stream", "sched_stream_grid")}
            if inst != "global" or {o[3] for o in occ.values()} != \
                    {"global"}:
                fail(f"M_pad={m_pad} window {win} {policy} took the "
                     f"{inst} instance")
            args = stream_operands(4, m, 1, win, "init", 7700 + j, dev)
            kw = dict(KW, n_servers=m, window_size=win, policy=policy)
            ms = timed_ms(lambda: sops.sched_stream_batch(*args, **kw),
                          reps=5)
            times[f"M_pad={m_pad},window={win},{policy}"] = ms
            print(f"global domain M={m} (M_pad {m_pad}) window {win} "
                  f"{policy:>10s}: {inst} instance, {need} bytes a stream "
                  f"past the {budget} of shared memory a block, workspace "
                  f"{ws} bytes at T=4; 1-D kernel {ms:.4f} ms a launch at "
                  f"T=4 on {card}; blocks per SM 1-D "
                  f"{occ['sched_stream'][0]}, 2-D "
                  f"{occ['sched_stream_grid'][0]} of "
                  f"{occ['sched_stream_grid'][1]} streams")
            if policy != "ect" or i:
                continue
            # the kernels line's entries: ect at OVER_BUDGET, the 1-D form
            # at T = 4 and the 2-D form at T = 1, C = 3
            pargs = sops.pad_operands(*args)
            pkw = dict(kw, alpha=0.25)
            plain_ms = once_ms(lambda: sref.sched_stream_batch_ref(
                *pargs, **pkw))
            b_ms, b_by, _, _ = stream_bound(4, win, m, 1)
            entries["sched_stream_global"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                queued_ms=steady_ms(queued_ms, lambda: skernel
                                    .sched_stream_call(*pargs, **pkw))[0])
            g = stream_operands(3, m, 1, win, "init", 7800, dev)
            gk = [x.reshape(1, 3, *x.shape[1:]) for x in
                  sops.pad_operands(*g)[:5]]
            gk.append(sops.pad_operands(*g)[5][:1])
            g_ms = timed_ms(lambda: skernel.sched_stream_grid_streams(
                *gk, **pkw), reps=5)
            g_plain = once_ms(lambda: sref.sched_stream_grid_streams_ref(
                *gk, **pkw))
            gb_ms, gb_by, _, _ = stream_bound(3, win, m, 1)
            entries["sched_stream_grid_global"] = dict(
                ms=g_ms, plain_ms=g_plain, bound_ms=gb_ms, bound_by=gb_by)
            print(f"global domain ect at M_pad {m_pad} window {win} on "
                  f"{card}: 1-D T=4 {ms:.4f} ms back to back, "
                  f"{entries['sched_stream_global']['queued_ms']:.4f} ms "
                  f"queued, plain {plain_ms:.2f} ms, bound {b_ms:.5f} ms "
                  f"({b_by}); 2-D T=1 C=3 {g_ms:.4f} ms (plain "
                  f"{g_plain:.2f} ms), bound {gb_ms:.5f} ms ({gb_by})")

    cfg, log = paper_cfgs()["shared_log"]
    kargs, kkw = main_path_operands(cfg, log, engine_pols()["ect"], dev,
                                    "stream_batch")
    q = steady_ms(queued_ms, lambda: skernel.sched_stream_call(*kargs,
                                                               **kkw))
    print(f"global domain: the shared instance's §4 ect 1-D kernel on "
          f"{card}: {q[0]:.4f} [{q[1]:.4f}-{q[2]:.4f}] ms queued{held_note(q)}"
          f", against {SHARED_ECT_MS[0]}-{SHARED_ECT_MS[1]} ms before the "
          "global instance (PERF.md)")
    print(f"global domain phase: {time.perf_counter() - t0:.1f} s")
    return errs, times, entries, counts


def check_domain(dev, card):
    """(c) The stream kernel at `DOMAIN_SHAPES`, past the caps that held
    before the shared-memory budget did: both forms and the merge against
    their plain versions for the six engine policies (the 1-D form at
    T = 2; the 2-D form at T = 1, C = 3 with a phantom client, the merge
    as mean and as sum in turn), each shape's budget and launch shape, and
    the 1-D kernel timed at T = 4; `sched_select` at N = 2048.  Returns
    the largest differences (1-D, 2-D, merge) and the times by shape and
    policy.  Inputs past the budget: `check_global_domain`."""
    errs, times = [0.0, 0.0, 0.0], {}
    for i, (m, win) in enumerate(DOMAIN_SHAPES):
        m_pad = sops._pad_servers(m)
        for j, policy in enumerate(KERNEL_POLICIES):
            errs[0] = max(errs[0], check_case(2, m, 1, win, "init", policy,
                                              7000 + 10 * i + j, dev))
            e_s, e_m = check_grid_case((1, 3, m, 1, win, 2, 1), policy,
                                       j % 2 == 0, 7100 + 10 * i + j, dev)
            errs[1], errs[2] = max(errs[1], e_s), max(errs[2], e_m)
            need, budget = skernel.stream_budget(policy, m_pad, win)
            occ = {form: skernel.stream_occupancy(form, policy, m, m_pad,
                                                  win)
                   for form in ("sched_stream", "sched_stream_grid")}
            args = stream_operands(4, m, 1, win, "init", 7200 + j, dev)
            kw = dict(KW, n_servers=m, window_size=win, policy=policy)
            ms = timed_ms(lambda: sops.sched_stream_batch(*args, **kw),
                          reps=5)
            times[f"M_pad={m_pad},window={win},{policy}"] = ms
            if {o[3] for o in occ.values()} != {"shared"}:
                fail(f"M_pad={m_pad} window {win} {policy} left the shared "
                     "instance")
            print(f"domain M={m} (M_pad {m_pad}) window {win} {policy:>10s}:"
                  f" {need} of {budget} bytes of shared memory a stream; "
                  f"1-D kernel {ms:.4f} ms a launch at T=4 on {card}; "
                  f"blocks per SM 1-D {occ['sched_stream'][0]}, 2-D "
                  f"{occ['sched_stream_grid'][0]} of "
                  f"{occ['sched_stream_grid'][1]} streams (two share a "
                  "warp where both fit)")
    rng = np.random.default_rng(13)
    c, n, m = 4, 2048, 100
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8 * m, (c, n)).astype(np.int32),
        rng.uniform(1.0, 20.0, (c, n)).astype(np.float32),
        rng.uniform(0.0, 60.0, (c, m)).astype(np.float32),
        rng.integers(0, 2 ** 32, (c,)))]
    for policy in sops.STATIC_POLICIES:
        kw = dict(n_servers=m, threshold=2.0, lam=50.0, policy=policy)
        got = sops.sched_select(*args, **kw)
        want = sops.sched_select_plain(*args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"sched_select at N={n} disagrees with its plain version")
    print(f"domain sched_select C={c} N={n} M={m}: bit-exact, both "
          "policies")
    return errs, times


# -- the profiling and tuning path --------------------------------------------


def run_tune_path(card):
    """`kernel_phase_profile` for ect at its defaults (the §4 size: T=100,
    N=2,000, M=100, window 100), the launch counts zeroed just before and
    read just after: each of the four levels runs once untimed and three
    times timed, so level 0 launches 4 times and the ablate levels 12,
    and nothing else launches.  Returns the counts."""
    zero_counts()
    split = tune_profile.kernel_phase_profile(policy="ect")
    torch.cuda.synchronize()
    counts = but_threefry(all_counts())
    want = dict({k: 0 for k in counts}, sched_stream=4,
                sched_stream_ablate=12)
    if counts != want:
        fail(f"kernel_phase_profile launched {counts}, expected {want}")
    if not all(np.isfinite(v) and v >= 0.0 for v in split.values()):
        fail(f"kernel_phase_profile returned {split}")
    total = split["total_s"]
    print(f"tune path: kernel_phase_profile(policy='ect') on {card}, "
          f"launches {counts}; wall ms (median of 3, host clock around a "
          f"synchronize; the engine's prep and bookkeeping included): total "
          f"{total * 1e3:.4f}, "
          + ", ".join(f"{k[:-2]} {split[k] * 1e3:.4f} "
                      f"({split[k] / total:.3f})"
                      for k in ("metrics_s", "steps_s", "plan_s",
                                "dispatch_s")))
    return counts


def check_launch_shapes(runs, pols):
    """`run_trials` with the stream kernel's warps per block
    (``trial_tile``) at 1, 2, 4 and 8, field for field against the default
    launch, for every policy of ``pols`` in every (name, cfg, log) of
    ``runs``."""
    for name, cfg, log in runs:
        for p, pol in pols.items():
            base = simulate.run_trials(0, cfg, pol, log)
            for tt in (1, 2, 4, 8):
                res = simulate.run_trials(
                    0, dataclasses.replace(cfg, trial_tile=tt), pol, log)
                bad = [f for f, a, b in zip(res._fields, res, base)
                       if not torch.equal(a, b)]
                if bad:
                    fail(f"{name} {p}: trial_tile={tt} moved {bad}")
        print(f"launch shapes, {name}: run_trials with trial_tile 1, 2, 4, "
              f"8 bit-identical to the default for {', '.join(pols)}")


def run_tune_cli(card):
    """`python -m repro_torch.tune --tune batch_ect` (in this process)
    into a temporary table; its entry must name the card."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "TUNE_sched_torch.json"
        if tune_cli.main(["--tune", "batch_ect", "--path", str(path)]) != 0:
            fail("python -m repro_torch.tune --tune batch_ect failed")
        (key, entry), = json.loads(path.read_text())["entries"].items()
    if entry.get("card") != torch.cuda.get_device_name(0) or not entry.get(
            "power_limit"):
        fail(f"the tuned entry does not name the card: {entry}")
    print(f"tune CLI on {card}: {key} -> {json.dumps(entry, sort_keys=True)}")


# -- the eager engine ----------------------------------------------------------


def eager_pols(pols):
    """The engine policies with the LCG as the eager engine's randomness
    (the parity setting; the kernel path ignores ``rng``)."""
    return {p: dataclasses.replace(pol, rng="lcg") for p, pol in pols.items()}


def differing(got, want):
    return [f for f, a, b in zip(got._fields, got, want)
            if not (a.shape == b.shape and a.dtype == b.dtype
                    and torch.equal(a, b))]


def run_eager_path(name, cfg, log, pols, kernel_results):
    """`run_trials(backend="jax")` for every policy on the seed of the
    kernel path's runs, the launch counts zeroed just before and read just
    after: the eager engine launches none of the port's kernels, and every
    `TrialResult` field must equal the kernel path's bit for bit.
    Returns (results, launch counts)."""
    ecfg = dataclasses.replace(cfg, backend="jax")
    results = {}
    zero_counts()
    for p, pol in eager_pols(pols).items():
        results[p] = simulate.run_trials(0, ecfg, pol, log)
    torch.cuda.synchronize()
    counts = all_counts()
    if any(but_threefry(counts).values()):
        fail(f"{name} eager engine launched {counts}, expected no kernel "
             "but the threefry hash of its draws")
    for p, res in results.items():
        bad = differing(res, kernel_results[p])
        if bad:
            fail(f"{name} {p}: backend='jax' differs from backend='kernel' "
                 f"in {bad}")
    print(f"eager engine, {name}: run_trials(backend='jax') for "
          f"{', '.join(results)} (rng='lcg'): launches {counts} (threefry: "
          "the prep's draws and the LCG seeds); every TrialResult field "
          "bit-identical to backend='kernel'")
    return results, counts


def print_analysis(name, eager, kernel, card):
    """`core.analysis` of both backends' results: load balance, straggler
    summary, both p99s and the makespan, which must be equal."""
    for p in eager:
        figs = {}
        for backend, res in (("jax", eager[p]), ("kernel", kernel[p])):
            figs[backend] = (analysis.load_balance_stats(res.server_loads),
                             analysis.straggler_summary(res),
                             analysis.latency_stats(res.latencies),
                             analysis.makespan(res))
        if figs["jax"] != figs["kernel"]:
            fail(f"{name} {p}: the backends' analysis figures differ")
        lb, ss, ls, mk = figs["jax"]
        print(f"  analysis {name} {p:>10s} on {card} (both backends): cv "
              f"{lb['cv']:.6f}, jain {lb['jain']:.6f}, straggler hit "
              f"fraction {ss['hit_fraction']:.6f}, p99 {ls['p99']:.6f} s, "
              f"p99_nearest {ls['p99_nearest']:.6f} s, makespan {mk:.6f} s")


def check_sequential_kernel(cfg, log, pols, dev, trials=(0, 1, 99)):
    """`engine.run_stream(backend="kernel")` on single trials of the §4
    shared-log prep: one launch of the stream kernel per call, and every
    field of its `ScheduleResult` equal to that trial's row of
    `run_stream_batch` on the same prep.  Returns the calls' launches."""
    _, _, works, states, traces, seeds = prep(cfg, log, dev)
    kw = dict(log_cfg=log, window_size=cfg.window_size,
              window_dt=simulate.resolve_window_dt(cfg, cfg.scenario),
              observe=simulate._observe(cfg))
    launches = 0
    for p, pol in pols.items():
        batch, _, _ = engine.run_stream_batch(states, works, seeds,
                                              traces=traces, policy=pol,
                                              **kw)
        for i in trials:
            row = lambda x: x[i]  # noqa: E731
            before = skernel.LAUNCHES["sched_stream"]
            one = engine.run_stream(
                type(states)(*map(row, states)), type(works)(*map(row, works)),
                seeds[i], trace=type(traces)(*map(row, traces)),
                backend="kernel", policy=pol, **kw)
            step = skernel.LAUNCHES["sched_stream"] - before
            if step != 1:
                fail(f"run_stream(backend='kernel') {p} launched {step}")
            launches += step
            bad = differing(one.state, type(states)(*map(row, batch.state)))
            bad += [f for f in one._fields[1:6] if not torch.equal(
                getattr(one, f), getattr(batch, f)[i])]
            if bad:
                fail(f"run_stream(backend='kernel') {p} trial {i} differs "
                     f"from the batched row in {bad}")
    torch.cuda.synchronize()
    print(f"sequential kernel path: run_stream(backend='kernel') on trials "
          f"{trials} for {', '.join(pols)}: {launches} calls, one stream "
          "kernel launch each, every field equal to the batched rows")
    return launches


def eager_walls(cfg, log, pol, runs=3):
    """{backend: median run_trials wall ms} of ``runs`` runs each, host
    clock around a synchronize (both backends ran these shapes before:
    no warm-up run)."""
    walls = {}
    for backend in ("kernel", "jax"):
        c = dataclasses.replace(cfg, backend=backend)
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            simulate.run_trials(0, c, pol, log)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        walls[backend] = sorted(times)[len(times) // 2]
    return walls


def eager_busy(cfg, log, pol):
    """One eager `run_trials` under torch.profiler, tracing the device
    alone and reading the raw trace (parsing some 10^5 kernels into
    profiler events takes half a minute): (device busy ms, kernels run,
    profiled wall ms).  Busy ms 0 if the trace holds no device time (not
    measured)."""
    c = dataclasses.replace(cfg, backend="jax")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate.run_trials(0, c, pol, log)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.duration_ns() for e in kernels) / 1e6
    return busy_ms, len(kernels), wall_ms


def time_eager(runs, pols, card):
    """ect's `run_trials` walls on both backends (median of 3) for each
    (name, cfg, log) of ``runs``, and the device's busy share of one eager
    run of each."""
    pol = eager_pols(pols)["ect"]
    for name, cfg, log in runs:
        t0 = time.perf_counter()
        walls = eager_walls(cfg, log, pol)
        t1 = time.perf_counter()
        busy_ms, kernels, prof_ms = eager_busy(cfg, log, pol)
        t2 = time.perf_counter()
        reqs = cfg.n_trials * cfg.n_requests
        print(f"eager engine wall, {name}, ect, on {card}: backend='jax' "
              f"{walls['jax']:.2f} ms ({reqs / walls['jax'] * 1e3:.0f} "
              f"requests/s), backend='kernel' {walls['kernel']:.2f} ms "
              f"({reqs / walls['kernel'] * 1e3:.0f} requests/s); ratio "
              f"{walls['jax'] / walls['kernel']:.1f} (medians of 3)")
        if busy_ms == 0.0:
            print(f"  profiler, one eager run on {card}: no device time in "
                  "the trace (busy share not measured)")
        else:
            print(f"  profiler, one eager run on {card}: {kernels} kernels, "
                  f"device busy {busy_ms:.2f} ms; busy share "
                  f"{busy_ms / walls['jax']:.3f} of the unprofiled wall, "
                  f"{busy_ms / prof_ms:.3f} of the profiled wall "
                  f"({prof_ms:.2f} ms)")
        print(f"  (walls {t1 - t0:.1f} s, profiled run and its trace "
              f"{t2 - t1:.1f} s)")


# -- the paper evaluation: threefry keys on the card ---------------------------

# (leading key shape, counters a key): 1 to 10^6 counters, up to 4,000 keys
THREEFRY_CASES = (((1,), 1), ((1,), 7), ((100,), 2), ((100,), 2000),
                  ((100, 3), 100), ((200, 20), 100), ((1,), 10 ** 6),
                  ((4,), 10 ** 6))
# the main path's widest hash: the object ids' randint of the §4 prep,
# 100 trial keys split in two, 2,000 counters each, the words' xor
THREEFRY_MAIN = ((100, 2), 2000)


def check_threefry(dev):
    """(a) The hash kernel against its plain version on the card, bit for
    bit, for every case of `THREEFRY_CASES` in both output forms and with
    a counter offset (fold_in's).  Returns the largest absolute
    difference."""
    gen = np.random.default_rng(19)
    worst, cases = 0, 0
    for lead, n in THREEFRY_CASES:
        keys = torch.from_numpy(gen.integers(0, 2 ** 32, lead + (2,),
                                             dtype=np.int64)).to(dev)
        for count_lo, xor in ((0, False), (0, True), (0x7e3, False)):
            before = tfkernel.LAUNCHES["threefry"]
            got = tfops.threefry_counters(keys, n, count_lo, xor)
            want = tfops.threefry_counters_plain(keys, n, count_lo, xor)
            torch.cuda.synchronize()
            if tfkernel.LAUNCHES["threefry"] != before + 1:
                fail("threefry_counters on the card did not launch the "
                     "kernel once")
            if not torch.equal(got, want):
                fail(f"threefry kernel differs from the plain version at "
                     f"keys {lead}, n={n}, offset {count_lo}, xor={xor}")
            worst = max(worst, int((got - want).abs().max().item()))
            cases += 1
    print(f"threefry kernel: {cases} cases (1 to 10^6 counters a key, up "
          "to 4,000 keys, both output forms, a counter offset) "
          "bit-identical to its plain version on the card")
    return float(worst)


def stream_seeds(cfg, k_sched):
    """The kernels' LCG seeds of a prep's scheduler keys: per trial, or per
    client of ``split(k_sched, C)`` under per_client."""
    if cfg.client_model == "per_client":
        k_sched = random.split(k_sched, cfg.n_clients)
    return random.bits(k_sched)


def check_prep_on_card(runs, dev):
    """(b) The §4 prep on the card, under torch's sync debug mode (a read
    back to the host raises), against the same prep drawn on this
    machine's CPU: workloads, masks, traces, scheduler keys, LCG seeds,
    the initial loads and the whole log bit-identical."""
    for name, cfg, log in runs:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card = simulate._prep_trials(simulate.trial_keys(0, cfg, dev),
                                         cfg, log)
            seeds = stream_seeds(cfg, card[5])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        cpu = simulate._prep_trials(simulate.trial_keys(0, cfg, "cpu"), cfg,
                                    log)
        rest = lambda p, sd: [p[1], *p[2], *p[3], *(p[4] or ()),  # noqa
                              p[5], sd]
        names = ["straggler_mask", "object_ids", "lengths", "valid", "log",
                 "n_assigned", "rates", "vclock", "free_at",
                 "trace times", "trace rates", "k_sched", "seeds"]
        for f, a, b in zip(names, rest(card, seeds),
                           rest(cpu, stream_seeds(cfg, cpu[5]))):
            if a.shape != b.shape or not torch.equal(a.cpu(), b):
                fail(f"{name} prep: {f} differs between the card and the "
                     "CPU")
        init, cinit = card[0].cpu().numpy(), cpu[0].numpy()
        ulp = np.abs(init.view(np.int32).astype(np.int64)
                     - cinit.view(np.int32).astype(np.int64))
        if ulp.max() > 0:
            fail(f"{name} prep: {int((ulp > 0).sum())} of {ulp.size} "
                 f"initial loads differ between the card and the CPU (up to "
                 f"{ulp.max()} ulp)")
        print(f"paper eval (b), {name} prep (T={cfg.n_trials}, "
              f"R={cfg.n_requests}, M={cfg.n_servers}, straggler_frac "
              f"{cfg.straggler_frac}): no host sync on the card; workloads, "
              "masks, traces, keys, seeds, the log and the initial loads "
              f"({ulp.size}) bit-identical to this machine's CPU")


def label_line(label, res):
    p99 = policy_core.nearest_rank_p99(
        res.latencies, torch.ones_like(res.latencies, dtype=torch.bool))
    return (f"{label} p99 {p99.mean().item():.4f} s, makespan "
            f"{res.phase_time.mean().item():.4f} s")


def run_evals(card):
    """(c) `run_paper_eval(seed=0)` and `run_scenario_eval(seed=0)` at the
    §4 defaults on the kernel backend, the launch counts zeroed just
    before and read just after: one stream kernel launch per `run_trials`
    (6 and 25), no other kernel but the threefry draws; then each once
    more for its wall.  Prints each label's mean p99 and makespan.
    Returns the counts."""
    zero_counts()
    paper = simulate.run_paper_eval(seed=0)
    scen = simulate.run_scenario_eval(seed=0)
    torch.cuda.synchronize()
    counts = all_counts()
    want = dict({k: 0 for k in but_threefry(counts)}, sched_stream=31)
    if but_threefry(counts) != want or counts["threefry"] < 31:
        fail(f"the evaluations launched {counts}, expected {want} and the "
             "threefry draws")
    results = [(label, res) for label, res in paper.items()] + [
        (f"{scn}/{p}", res) for scn, row in scen.items()
        for p, res in row.items()]
    for label, res in results:
        if res.chosen.shape != (100, 2000) or not (
                torch.isfinite(res.latencies).all()
                and torch.isfinite(res.phase_time).all()):
            fail(f"evaluation {label}: unexpected shapes or values")
    walls = {}
    for name, fn in (("run_paper_eval", simulate.run_paper_eval),
                     ("run_scenario_eval", simulate.run_scenario_eval)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(seed=0)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
    print(f"paper eval (c) on {card}: run_paper_eval(seed=0) "
          f"{walls['run_paper_eval']:.1f} ms (6 run_trials), "
          f"run_scenario_eval(seed=0) {walls['run_scenario_eval']:.1f} ms "
          f"(25 run_trials), second calls, host clock; launches {counts}")
    print("  run_paper_eval:    " + "; ".join(
        label_line(k, v) for k, v in paper.items()))
    for scn, row in scen.items():
        print(f"  {scn:<16s}   " + "; ".join(
            label_line(k, v) for k, v in row.items()))
    return counts


def check_eager_threefry(dev, card, pols=("trh", "nltr", "two_choice")):
    """(d) The eager engine under ``rng="jax"`` at T = 4 and §4 widths on
    the card against the same run on this machine's CPU: the drawn
    candidates of every request bit-identical, and every `TrialResult`
    field."""
    cfg = simulate.SimConfig(n_trials=4, backend="jax",
                             scenario=simulate.ScenarioConfig("transient"))
    log = simulate.default_log_cfg(cfg)
    for p in pols:
        pol = PolicyConfig(name=p, threshold=5.0)
        drawn = []
        for d in (dev, torch.device("cpu")):
            k_sched = prep(cfg, log, d)[5]
            drawn.append(engine._jax_draws(
                pol, random.split(k_sched, cfg.n_windows), cfg.window_size,
                cfg.n_servers))
        if not torch.equal(drawn[0].cpu(), drawn[1]):
            fail(f"eager {p}: the rng='jax' draws differ between the card "
                 "and the CPU")
        t0 = time.perf_counter()
        on_card = simulate.run_trials(0, cfg, pol, log)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        on_cpu = simulate.run_trials(0, cfg, pol, log, device="cpu")
        t2 = time.perf_counter()
        bad = [f for f, a, b in zip(on_card._fields, on_card, on_cpu)
               if a.shape != b.shape or not torch.equal(a.cpu(), b)]
        if bad:
            fail(f"eager {p} rng='jax': the card differs from the CPU in "
                 f"{bad}")
        print(f"paper eval (d), eager {p} rng='jax' T=4 on {card}: "
              f"{tuple(drawn[0].shape)} draws and every TrialResult field "
              f"bit-identical to the CPU (card {(t1 - t0) * 1e3:.0f} ms, "
              f"CPU {(t2 - t1) * 1e3:.0f} ms)")


def profile_prep(runs, dev, card, reps=5):
    """(e) The §4 prep's wall on the card (median of ``reps``, host clock
    around a synchronize) and, by torch.profiler from the raw trace, the
    kernels one prep launches and their device time; the threefry
    launches by the wrapper's count."""
    out = {}
    for name, cfg, log in runs:
        run = lambda: simulate._prep_trials(  # noqa: E731
            simulate.trial_keys(0, cfg, dev), cfg, log)
        run()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        before = tfkernel.LAUNCHES["threefry"]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        hashes = tfkernel.LAUNCHES["threefry"] - before
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        busy = sum(e.duration_ns() for e in kernels) / 1e6
        wall = sorted(walls)[reps // 2]
        out[name] = dict(wall_ms=wall, kernels=len(kernels),
                         threefry=hashes, busy_ms=busy)
        print(f"paper eval (e), {name} prep on {card}: wall {wall:.3f} ms "
              f"[{min(walls):.3f}-{max(walls):.3f}], median of {reps}; "
              f"{len(kernels)} device kernels by torch.profiler, "
              f"{hashes} of them threefry, device busy {busy:.3f} ms"
              + ("" if busy else " (no device time in the trace: not "
                 "measured)"))
    return out


def time_threefry(dev, card):
    """The hash kernel at the main path's widest call (`THREEFRY_MAIN`),
    queued and back to back (median of 5), its plain version once, and
    its bound: the keys read and the words written once at the memory
    rate, against `THREEFRY_OPS` integer operations a counter at
    `INT32_OPS_PER_S`.  PyTorch has no call computing this hash."""
    lead, n = THREEFRY_MAIN
    keys = random.split(random.split(random.key(0, dev), lead[0]), lead[1])
    call = lambda: tfops.threefry_counters(keys, n, xor=True)  # noqa: E731
    q = steady_ms(queued_ms, call)
    b = steady_ms(timed_ms, call)
    plain_ms = once_ms(lambda: tfops.threefry_counters_plain(keys, n,
                                                             xor=True))
    counters = lead[0] * lead[1] * n
    bytes_moved = keys.numel() * 8 + counters * 8
    bound_ms, bound_by = bound(bytes_moved, counters * THREEFRY_OPS,
                               INT32_OPS_PER_S)
    print(f"threefry kernel on {card}, {lead[0] * lead[1]} keys x {n} "
          f"counters (xor): {q[0]:.4f} [{q[1]:.4f}-{q[2]:.4f}]{held_note(q)} "
          f"ms queued ({b[0]:.4f} back to back), median of 5; plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
          f"{bytes_moved} bytes, {counters * THREEFRY_OPS} int32 ops)")
    return dict(ms=q[0], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# -- timing -------------------------------------------------------------------


def stage_split(cfg, log, pol, runs=5):
    """(run_trials wall ms, [prep, sched, post] ms), each the median of
    ``runs`` host-clock readings of a run ended by a synchronize: first
    ``runs`` walls one after another, the stage hooks inert (the method of
    `WALLS_SCRIPT`), then ``runs`` runs under `tune.profile.collect`,
    which synchronizes at both ends of each outermost stage."""
    walls, stages = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate.run_trials(0, cfg, pol, log)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(runs):
        with tune_profile.collect() as got:
            simulate.run_trials(0, cfg, pol, log)
        stages.append([got[k] * 1e3 for k in ("prep", "sched", "post")])
    mid = runs // 2
    return (sorted(walls)[mid],
            [sorted(col)[mid] for col in zip(*stages)])


# `python3 chip_smoke.py --walls DIR`: the run_trials walls of the main
# paths (ect; shared log, per_client at 200 and at 64 clients), five
# synchronized runs one after another after a warm-up, as `stage_split`
# takes them, in a process of its own per tree.  It uses only what every
# slice of the port has, so it times an older checkout at DIR too.
WALLS_SCRIPT = r"""
import json, time, warnings
import torch
from repro_torch.core import simulate
from repro_torch.core.policies import PolicyConfig
warnings.filterwarnings("ignore", message="per_client window clamp")
pol = PolicyConfig(name="ect", threshold=0.05)
tr = simulate.ScenarioConfig("transient")
cfgs = {"shared_log": simulate.SimConfig(scenario=tr),
        "per_client_200": simulate.SimConfig(client_model="per_client",
                                             scenario=tr),
        "per_client_64": simulate.SimConfig(client_model="per_client",
                                            n_clients=64, scenario=tr)}
out = {}
for name, cfg in cfgs.items():
    log = simulate.default_log_cfg(cfg)
    simulate.run_trials(0, cfg, pol, log)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate.run_trials(0, cfg, pol, log)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out[name] = sorted(walls)
print(json.dumps(out))
"""


def compare_walls(other: Path, rounds: int = 5) -> None:
    """The main paths' walls of this tree and of the checkout at
    ``other``, alternately (other, this, this, other, other, this, ...),
    each run in a fresh process by `WALLS_SCRIPT`: per round the median
    of five [range], then per path the two trees' medians of the round
    medians."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    print(card_line())
    trees = {"other": other.resolve(), "this": Path(__file__).resolve().parent}
    order = []
    for i in range(rounds):
        order += ["other", "this"] if i % 2 == 0 else ["this", "other"]
    got = {"other": [], "this": []}
    for tag in order:
        root = trees[tag]
        run = subprocess.run(
            [sys.executable, "-c", WALLS_SCRIPT], cwd=root,
            env=dict(os.environ, PYTHONPATH=str(root / "src")),
            capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            fail(f"walls of {root} failed:\n{run.stderr[-4000:]}")
        walls = json.loads(run.stdout.strip().splitlines()[-1])
        got[tag].append(walls)
        print(f"{tag} ({root}): " + "; ".join(
            f"{k} {v[2]:.2f} [{v[0]:.2f}-{v[-1]:.2f}]"
            for k, v in walls.items()) + " ms")
    for k in got["this"][0]:
        med = {t: sorted(w[k][2] for w in got[t]) for t in got}
        print(f"{k}: median of {rounds} round medians, other "
              f"{med['other'][rounds // 2]:.2f} ms, this "
              f"{med['this'][rounds // 2]:.2f} ms; round medians other "
              f"{med['other']}, this {med['this']}")


def main_path_operands(cfg, log, pol, dev, hook):
    """The stream kernel's operands and keywords in one main-path run of
    ``pol``, padded as the kernel takes them: the calls of `_sched_trials`
    to its ``hook`` (``stream_batch`` or ``stream_grid``) are recorded."""
    captured = {}
    fn = {"stream_batch": sops.sched_stream_batch,
          "stream_grid": sops.sched_stream_grid}[hook]
    init, mask, works, states, traces, seeds = prep(cfg, log, dev)
    simulate._sched_trials(cfg, pol, log, works, states, seeds, traces,
                           **{hook: recording(fn, captured)})
    return sops.pad_operands(*captured["args"]), dict(captured["kw"])


def time_stream_policies(form, launch, operands, card):
    """The stream kernel in ``form`` (a `skernel.LAUNCHES` key) for every
    engine policy at its main-path operands, by CUDA events: ms per
    launch queued (the device alone, `queued_ms`) and back to back (the
    method of the earlier stream kernel timings), each the median of
    `steady_ms`, and ns per request per stream per wave from the queued
    time (the streams of one wave run side by side, each its own chain of
    N requests).  Returns {policy: (queued ms, back-to-back ms)}."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    print(f"  stream kernel by policy on {card}, ms per launch queued "
          "(back to back), median of 5 [range]:")
    for p, (kargs, kkw) in operands.items():
        n = kargs[0].shape[-1]
        n_streams = kargs[0].numel() // n
        blocks_sm, spb, smem, _ = skernel.stream_occupancy(
            form, p, kkw["n_servers"], kargs[3].shape[-1],
            kkw["window_size"])
        waves = -(-(-(-n_streams // spb)) // (blocks_sm * n_sm))
        q = steady_ms(queued_ms, lambda: launch(*kargs, **kkw))
        b = steady_ms(timed_ms, lambda: launch(*kargs, **kkw))
        times[p] = (q[0], b[0])
        print(f"    {p:>10s} {q[0]:.4f} [{q[1]:.4f}-{q[2]:.4f}]{held_note(q)} "
              f"({b[0]:.4f} [{b[1]:.4f}-{b[2]:.4f}]) ms, "
              f"{q[0] * 1e6 / waves / n:.1f} ns per request per "
              f"stream per wave ({waves} wave(s); {blocks_sm} blocks of "
              f"{spb} streams per SM, {smem} bytes of shared memory a block)")
    return times


def time_shared_log(cfg, log, pols, dev, card):
    operands = {p: main_path_operands(cfg, log, pol, dev, "stream_batch")
                for p, pol in pols.items()}
    kargs, kkw = operands["ect"]
    plain_ms = once_ms(lambda: sref.sched_stream_batch_ref(*kargs, **kkw))
    wall_ms, stage_ms = stage_split(cfg, log, pols["ect"])

    # least time for the same work, over the n_servers real lanes (the
    # padding to 128 lanes is the kernel's choice, not the function's)
    t_, n_ = kargs[0].shape
    m_, n_win = cfg.n_servers, kargs[5].shape[1]
    bound_ms, bound_by, bytes_moved, ops = stream_bound(t_, n_, m_, n_win)
    reqs = cfg.n_trials * cfg.n_requests
    print(f"timing shared_log, T={t_} N={n_} M={m_} on {card}:")
    times = time_stream_policies("sched_stream", skernel.sched_stream_call,
                                 operands, card)
    kernel_ms = times["ect"][0]
    print(f"  ect kernel  {kernel_ms:.4f} ms/launch queued "
          f"({reqs / kernel_ms * 1e3:.0f} requests/s)")
    print(f"  ect plain   {plain_ms:.2f} ms")
    print(f"  run_trials wall {wall_ms:.2f} ms, median of 5 "
          f"({reqs / wall_ms * 1e3:.0f} requests/s)")
    print(f"  stages  prep {stage_ms[0]:.2f} ms, sched {stage_ms[1]:.2f} ms"
          f" (stream kernel {kernel_ms:.4f} ms of it), post "
          f"{stage_ms[2]:.2f} ms; share of the run_trials wall outside the "
          f"stream kernel {1 - kernel_ms / wall_ms:.3f}")
    print(f"  bound   {bound_ms:.5f} ms ({bound_by}: {bytes_moved} bytes, "
          f"{ops} f32 ops)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def time_per_client(cfg, log, pols, dev, card):
    """The 2-D stream kernel for every engine policy and the merge by
    CUDA events at the main path's operands, their plain versions (ect),
    one whole run_trials and the stage split."""
    operands, tiles = {}, {}
    for p, pol in pols.items():
        kargs, kkw = main_path_operands(cfg, log, pol, dev, "stream_grid")
        tiles[p] = kkw.pop("client_tile")
        kkw.pop("merge_mean")
        operands[p] = kargs, kkw
    kargs, kkw = operands["ect"]
    merge_kw = dict(client_tile=policy_core.resolve_client_tile(
        kargs[0].shape[1], tiles["ect"]), merge_mean=True)
    streams = skernel.sched_stream_grid_streams(*kargs, **kkw)
    _, lats, _, wloads, metrics = streams
    valid = kargs[2]
    merge = lambda: skernel.client_merge_call(  # noqa: E731
        metrics, wloads, lats, valid, **merge_kw)
    merge_q = steady_ms(queued_ms, merge)
    merge_b = steady_ms(timed_ms, merge)
    merge_ms = merge_q[0]
    streams_plain_ms = once_ms(
        lambda: sref.sched_stream_grid_streams_ref(*kargs, **kkw))
    merge_plain_ms = once_ms(lambda: sref.client_merge_ref(
        metrics, wloads, lats, valid, **merge_kw))
    wall_ms, stage_ms = stage_split(cfg, log, pols["ect"])

    # least time for the same work, over the real servers and the real
    # clients (those with a valid step; padding lanes and phantom clients
    # are not the function's work).  Stream kernel: per real stream, its
    # request blocks, table in and out, seeds, choices, latencies, window
    # loads and metric row, plus each trial's rate rows once; ect's f32
    # operations as in the shared-log bound (the function's work, not
    # the kernel's).  Merge: per real client, its
    # window loads, metric row, latencies and validity read and the
    # masked latency block written, plus per trial the merged loads and
    # row; operations: one add per window-load element, and the 48
    # bisection passes (compare + count) over the merged block.
    t_, c_, n_ = kargs[0].shape
    m_, n_win = cfg.n_servers, kargs[5].shape[1]
    real = int((metrics[..., policy_core.MET_N_VALID] > 0).sum().item())
    s_bytes = 4 * (real * (3 * n_ + 4 * m_ + 1 + 2 * n_ + 4 * m_
                           + n_win * m_ + policy_core.N_METRICS)
                   + t_ * n_win * m_)
    s_ops = real * (n_ * 6 * m_ + n_win * 5 * m_ + 48 * n_ * 2)
    m_bytes = 4 * (real * (n_win * m_ + policy_core.N_METRICS + 2 * n_
                           + 2 * n_)
                   + t_ * (n_win * m_ + policy_core.N_CMETRICS))
    m_ops = real * (n_win * m_ + 48 * n_ * 2)
    s_bound, s_by = bound(s_bytes, s_ops)
    m_bound, m_by = bound(m_bytes, m_ops)
    print(f"timing per_client, T={t_} C={c_} ({real // t_} real per "
          f"trial) N={n_} M={m_} on {card}:")
    times = time_stream_policies("sched_stream_grid",
                                 skernel.sched_stream_grid_streams,
                                 operands, card)
    streams_ms = times["ect"][0]
    kernels_ms = streams_ms + merge_ms
    print(f"  ect stream kernel (2-D)  {streams_ms:.4f} ms/launch queued, "
          f"plain {streams_plain_ms:.2f} ms, bound {s_bound:.5f} ms ({s_by}: "
          f"{s_bytes} bytes, {s_ops} f32 ops)")
    print(f"  ect client_merge         {merge_ms:.4f} [{merge_q[1]:.4f}-"
          f"{merge_q[2]:.4f}]{held_note(merge_q)} ms/launch queued "
          f"({merge_b[0]:.4f} "
          f"[{merge_b[1]:.4f}-{merge_b[2]:.4f}] back to back), median of 5, "
          f"plain {merge_plain_ms:.2f} ms, bound {m_bound:.5f} ms ({m_by}: "
          f"{m_bytes} bytes, {m_ops} f32 ops)")
    reqs = cfg.n_trials * cfg.n_requests
    print(f"  run_trials wall {wall_ms:.2f} ms, median of 5 "
          f"({reqs / wall_ms * 1e3:.0f} requests/s)")
    print(f"  stages  prep {stage_ms[0]:.2f} ms, sched {stage_ms[1]:.2f} ms"
          f" (the two kernels {kernels_ms:.4f} ms of it), post "
          f"{stage_ms[2]:.2f} ms; share of the run_trials wall outside the "
          f"two kernels {1 - kernels_ms / wall_ms:.3f}")
    return (dict(ms=streams_ms, plain_ms=streams_plain_ms, bound_ms=s_bound,
                 bound_by=s_by),
            dict(ms=merge_ms, plain_ms=merge_plain_ms, bound_ms=m_bound,
                 bound_by=m_by))


# -- the host path: the paper's client-side I/O path --------------------------


# benchmarks/paper_figs.py:173-194 (completion_time): 24 servers at
# 200 MB/s (rate seed 3), server 1 a x8 straggler with 800 MB of foreign
# queue, server 5 with 400 MB queued, 120 files x 16 MB, threshold 4.0
COMPLETION_SERVERS, COMPLETION_FILES, COMPLETION_FILE_MB = 24, 120, 16.0
HOST_POLICIES = ("rr", "mlml", "trh", "nltr", "ect", "two_choice")
# the JAX package's phase seconds on those settings (repro.io.IOClient on
# repro.io.SimulatedCluster); tests/test_torch_io.py holds the port to
# them placement for placement on the CPU
COMPLETION_REF_S = {"rr": 35.039999999999935, "mlml": 32.31999999999999,
                    "trh": 2.02, "nltr": 0.48000000000000015,
                    "ect": 32.16, "two_choice": 32.16}
# the host half of paper_figs.fig_temporal at the §4 width: 100 servers,
# the transient trace of trial 0 of seed 0; 500 files x 16 MB (the §4
# stream's 2,000 requests, as 4 MB objects), one every horizon / 500 s
TEMPORAL_POLICIES = (("rr", 0.0), ("trh", 4.0), ("ect", 0.05))
TEMPORAL_FILES, TEMPORAL_FILE_MB = 500, 16.0
# (d): gemma-2b through the Checkpointer's defaults (16 servers, 8 MB
# shards, 4 MB stripes, trh at 4.0), server 3 a straggler, server 7
# failed before the save
CKPT_STRAGGLER, CKPT_DELAY_S_PER_MB, CKPT_FAILED = 3, 0.005, 7
CKPT_MAINTAIN_S = 20.0
# (e): the serve shape's token batches through 8 servers, one straggler
DATA_SERVERS, DATA_STRAGGLER, DATA_DELAY_S_PER_MB, DATA_STEPS = 8, 2, 0.01, 8


def completion_cluster(io, name):
    """paper_figs.completion_time's cluster and client for one policy."""
    sim = io.SimulatedCluster(COMPLETION_SERVERS, base_rate_mb_s=200.0,
                              seed=3)
    sim.make_straggler(1, 8.0)
    sim.add_external_load(1, 800.0)
    sim.add_external_load(5, 400.0)
    cli = io.IOClient(sim, io.IOClientConfig(
        policy=PolicyConfig(name=name, threshold=4.0)))
    for s in range(COMPLETION_SERVERS):
        cli.log.loads[s] = sim.queued_mb(s)
    return sim, cli


def run_completion_time(card):
    """(a): the paper's completion-time experiment through the port's
    `IOClient`, six policies; the host's µs per `HostScheduler.schedule`
    and per `write_file`.  Returns the ect client."""
    clients = {}
    for name in HOST_POLICIES:
        sim, cli = completion_cluster(tio, name)
        spent = [0.0, 0]
        schedule = cli.sched.schedule

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = schedule(*a, **k)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out

        cli.sched.schedule = timed
        t0 = time.perf_counter()
        for f in range(COMPLETION_FILES):
            cli.write_file(f, size_mb=COMPLETION_FILE_MB)
        write_s = time.perf_counter() - t0
        phase = cli.flush()
        if phase != COMPLETION_REF_S[name]:
            fail(f"completion time {name}: phase {phase!r} s, the JAX "
                 f"package's is {COMPLETION_REF_S[name]!r} s")
        print(f"  {name:>10s} phase {phase:.4f} s  straggler_hits "
              f"{sim.servers[1].n_requests:3d}  probes {cli.probe_messages:4d}"
              f"  host {1e6 * spent[0] / spent[1]:.1f} µs/schedule, "
              f"{1e6 * write_s / COMPLETION_FILES:.1f} µs/write_file "
              f"({spent[1]} schedules)")
        clients[name] = cli
    print(f"host path (a) completion time on {card}'s host: phases equal "
          "the JAX package's for all six policies")
    return clients["ect"]


def run_log_snapshot(cli, card):
    """(b): the ect client's live log snapshotted into a `SchedState` on
    the card; one window of the next files' requests scheduled from it by
    `engine.run_stream(backend="kernel")` (one stream kernel launch),
    against the same call on the CPU (the plain version)."""
    sim = cli.store
    m = cli.n_servers
    reqs = [r for f in range(COMPLETION_FILES, COMPLETION_FILES + 40)
            for r in tio.stripe_file(cli.striping, f,
                                     int(COMPLETION_FILE_MB * tio.MB))]
    # int32 ids with the same default home (object_id mod M)
    span = m * ((2 ** 31 - 1) // m)
    ids = [r.object_id % span for r in reqs]
    lens = [r.length / tio.MB for r in reqs]
    rates = [s.rate_mb_s for s in sim.servers]
    out = {}
    for dev in ("cuda", "cpu"):
        state = cli.log.snapshot(device=dev)
        work = engine.Workload(
            torch.tensor(ids, dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.float32, device=dev),
            torch.ones(len(ids), dtype=torch.bool, device=dev))
        trace = engine.ClusterTrace(
            times=torch.zeros(1, device=dev),
            rates=torch.tensor([rates], dtype=torch.float32, device=dev))
        zero_counts()
        res = engine.run_stream(
            state, work, random.key(0, dev),
            policy=PolicyConfig(name="ect", threshold=0.05),
            log_cfg=cli.log.cfg, window_size=len(ids), trace=trace,
            window_dt=0.1, backend="kernel")
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = but_threefry(all_counts())
            if counts != dict({k: 0 for k in counts}, sched_stream=1):
                fail(f"log snapshot window launched {counts}, expected one "
                     "sched_stream launch")
            launches = counts["sched_stream"]
        out[dev] = res
    got, want = out["cuda"], out["cpu"]
    if got.state.log.device.type != "cuda":
        fail("the snapshot's window did not run on the card")
    exact = {f: torch.equal(getattr(got, f).cpu(), getattr(want, f))
             for f in ("chosen", "probe_msgs", "redirected", "latencies",
                       "window_loads")}
    exact.update({f: torch.equal(getattr(got.state, f).cpu(),
                                 getattr(want.state, f))
                  for f in ("n_assigned", "rates", "vclock", "free_at")})
    exact["loads"] = torch.equal(got.state.loads.cpu(), want.state.loads)
    if not all(exact.values()):
        fail(f"log snapshot window: card and CPU differ in "
             f"{[f for f, ok in exact.items() if not ok]}")
    d_probs = (got.state.probs.cpu() - want.state.probs).abs().max().item()
    rel = ((got.state.log[2:].cpu() - want.state.log[2:]).abs()
           / want.state.log[2:].abs().clamp_min(1.0)).max().item()
    if d_probs > 1e-6 or rel > 1e-6:
        fail(f"log snapshot window: probs differ by {d_probs:.3g}, "
             f"ewma/est by {rel:.3g} relative")
    table_bits = torch.equal(got.state.log.cpu(), want.state.log)
    redirected = int(got.redirected.sum())
    print(f"host path (b) on {card}: the ect client's log ({m} servers, "
          f"{len(cli.log.request_log)} requests booked) -> SchedState on "
          f"the card -> one window of {len(ids)} requests, 1 sched_stream "
          f"launch; choices, latencies, loads, window loads, counts and "
          f"clock bit-identical to the CPU's plain version (whole table "
          f"{'bit-identical' if table_bits else 'not'}; probs {d_probs:.3g},"
          f" ewma/est {rel:.3g} relative); {redirected} redirected")
    return launches


def run_temporal_host(card):
    """(c): the host half of fig_temporal at the §4 width: the port's
    `make_trace` draws trial 0's transient trace (seed 0) on the card,
    and `SimulatedCluster(trace=...)` replays it for rr, trh and ect;
    the same trace drawn on the CPU replays to the same results."""
    cfg = simulate.SimConfig(scenario=simulate.ScenarioConfig("transient"))
    traces = {}
    for dev in ("cuda", "cpu"):
        keys = simulate.trial_keys(0, cfg, dev)[:1]
        tr = simulate.make_trace(keys, cfg, cfg.scenario)
        traces[dev] = engine.ClusterTrace(times=tr.times[0],
                                          rates=tr.rates[0])
    if traces["cuda"].times.device.type != "cuda":
        fail("make_trace did not draw on the card")
    horizon = cfg.n_windows * simulate.resolve_window_dt(cfg, cfg.scenario)
    dt = horizon / TEMPORAL_FILES
    m = cfg.n_servers
    results = {}
    for dev, trace in traces.items():
        for pol, thr in TEMPORAL_POLICIES:
            sim = tio.SimulatedCluster(m, base_rate_mb_s=200.0, seed=3,
                                       trace=trace)
            cli = tio.IOClient(sim, tio.IOClientConfig(
                policy=PolicyConfig(name=pol, threshold=thr)))
            t0 = time.perf_counter()
            for f in range(TEMPORAL_FILES):
                cli.write_file(f, size_mb=TEMPORAL_FILE_MB)
                sim.advance_time(dt)
                for s in range(m):
                    cli.log.loads[s] = sim.queued_mb(s)
            cli.flush()
            st = cli.stats()
            results[dev, pol] = (st["p99_write_s"], sim.clock,
                                 [r.server for r in cli.records],
                                 time.perf_counter() - t0)
    slow = (traces["cpu"].rates < 200.0).any(dim=0).nonzero().flatten()
    print(f"host path (c) on {card}'s host: transient trace of trial 0 "
          f"(seed 0) drawn on the card, events at "
          f"{[round(t, 4) for t in traces['cpu'].times.tolist()]} s, "
          f"{len(slow)} slow servers {slow.tolist()}; {TEMPORAL_FILES} "
          f"files x {TEMPORAL_FILE_MB:g} MB, one every {dt:.5f} s")
    for pol, _ in TEMPORAL_POLICIES:
        p99, clock, chosen, wall = results["cuda", pol]
        if results["cpu", pol][:3] != (p99, clock, chosen):
            fail(f"temporal host path {pol}: the card's trace replays "
                 "differently from the CPU's")
        hits = sum(c in set(slow.tolist()) for c in chosen)
        print(f"  {pol:>4s} p99 write {p99:.6f} s  done at {clock:.6f} s"
              f"  {hits} of {len(chosen)} objects on slow servers  "
              f"(wall {wall:.2f} s)")


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.endswith(".bin"))


def host_ram_bytes():
    """(available, total) host RAM from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            info[k] = int(v.split()[0]) * 1024
    return info["MemAvailable"], info["MemTotal"]


def check_room(label, nbytes, root) -> None:
    """Print the free disk at ``root`` and the host RAM; fail unless a
    checkpoint of ``nbytes`` fits (1.1x on disk, 3x in RAM: the host
    snapshot, the restore's buffers and their copies)."""
    free = shutil.disk_usage(root).free
    ram_avail, ram_total = host_ram_bytes()
    print(f"{label}, {nbytes / 1e9:.3f} GB; free disk {free / 1e9:.1f} GB "
          f"at {root}, host RAM {ram_avail / 1e9:.1f} GB available of "
          f"{ram_total / 1e9:.1f} GB")
    if free < 1.1 * nbytes or ram_avail < 3 * nbytes:
        fail(f"{label}: a checkpoint of {nbytes / 1e9:.1f} GB needs "
             f"{1.1 * nbytes / 1e9:.1f} GB of disk and {3 * nbytes / 1e9:.1f}"
             f" GB of host RAM; have {free / 1e9:.1f} GB and "
             f"{ram_avail / 1e9:.1f} GB")


def run_checkpoint(serve_args, card):
    """(d): gemma-2b's served parameters saved from the card through
    `Checkpointer` onto a `LocalFSStore` (a straggler, a failed server),
    restored onto the card `torch.equal` to the served ones; then the
    failed server healed and `MaintainerThread` draining the redirect
    tables."""
    _, params, _ = serve.setup(serve_args)
    want = params.state_dict()
    nbytes = sum(t.numel() * t.element_size() for t in want.values())
    n_params = sum(t.numel() for t in want.values())
    root = tempfile.mkdtemp(prefix="ckpt_")
    try:
        check_room(f"host path (d): gemma-2b state_dict {len(want)} "
                   f"tensors, {n_params} parameters", nbytes, root)
        ck = tckpt.Checkpointer(root)
        ck.store.set_write_delay(CKPT_STRAGGLER, CKPT_DELAY_S_PER_MB)
        ck.store.fail_server(CKPT_FAILED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, params)
        save_s = time.perf_counter() - t0
        st = ck.client.stats()
        objdir = os.path.join(root, "objects")
        per_server = [dir_bytes(os.path.join(objdir, f"server_{s:04d}"))
                      for s in range(ck.store.n_servers)]
        redirects = ck.store.redirect_count()
        t0 = time.perf_counter()
        back = ck.restore(target=params)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if list(back) != list(want):
            fail("restored gemma-2b state_dict has other keys")
        for k, v in want.items():
            got = back[k]
            if got.device != v.device or not torch.equal(got, v):
                fail(f"restored gemma-2b tensor {k} differs from the served "
                     f"one (on {got.device})")
        del back
        mean_b = sum(per_server) / len(per_server)
        print(f"  save {save_s:.2f} s ({nbytes / save_s / 1e9:.3f} GB/s), "
              f"restore onto the card {restore_s:.2f} s "
              f"({nbytes / restore_s / 1e9:.3f} GB/s), every tensor "
              f"torch.equal to the served one")
        print(f"  {int(st['writes'])} objects, redirect rate "
              f"{st['redirect_rate']:.4f}, retries {int(st['retries'])}, "
              f"failed writes {int(st['failed_writes'])}; straggler "
              f"(server {CKPT_STRAGGLER}, {CKPT_DELAY_S_PER_MB} s/MB) holds "
              f"{per_server[CKPT_STRAGGLER] / 1e6:.1f} MB against a mean of "
              f"{mean_b / 1e6:.1f} MB; failed server {CKPT_FAILED} holds "
              f"{per_server[CKPT_FAILED]} B; {redirects} redirect entries")
        if st["failed_writes"] < 1 or per_server[CKPT_FAILED]:
            fail("the failed server was never tried, or holds objects")
        ck.store.heal_server(CKPT_FAILED)
        maint = tio.MaintainerThread(ck.store, interval_s=0.0,
                                     max_objects=64)
        t0 = time.perf_counter()
        maint.start()
        deadline = t0 + CKPT_MAINTAIN_S
        while ck.store.redirect_count() and time.perf_counter() < deadline:
            time.sleep(0.05)
        maint.stop()
        left = ck.store.redirect_count()
        print(f"  maintainer: {maint.total_moved} objects moved home in "
              f"{time.perf_counter() - t0:.2f} s, {left} redirect entries "
              f"left (of {redirects})")
        leaves = ck.manifest(1).leaves
        for leaf in leaves[:3] + leaves[-3:]:
            if not torch.equal(ck.read_leaf(leaf).to("cuda"),
                               want[leaf.path]):
                fail(f"after the maintainer, {leaf.path} reads back "
                     "differently")
        ck.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del params, want
    torch.cuda.empty_cache()


def run_token_batches(card):
    """(e): `ObjectStoreTokens` at gemma-2b's vocabulary, the serve
    shape (seq 512, global batch 4), 8 steps through a `LocalFSStore` of
    8 servers with one straggler; every batch on the card and equal to
    `SyntheticTokens`'."""
    cfg = tdata.DataConfig(vocab_size=get_config("gemma-2b").vocab_size,
                           seq_len=512, global_batch=4)
    root = tempfile.mkdtemp(prefix="tokens_")
    try:
        store = tio.LocalFSStore(root, DATA_SERVERS)
        store.set_write_delay(DATA_STRAGGLER, DATA_DELAY_S_PER_MB)
        ost = tdata.ObjectStoreTokens(cfg, tio.IOClient(store),
                                      rows_per_shard=cfg.global_batch)
        t0 = time.perf_counter()
        shards = ost.prepare(DATA_STEPS)
        prep_s = time.perf_counter() - t0
        synth = tdata.SyntheticTokens(cfg)
        ms = []
        for step in range(DATA_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ost.batch_at(step)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            want = synth.batch_at(step)
            for k in ("tokens", "targets"):
                if got[k].device.type != "cuda" or got[k].dtype != \
                        torch.int32 or not torch.equal(got[k], want[k]):
                    fail(f"token batch {step} {k} is not SyntheticTokens' "
                         "on the card")
        redirects = store.redirect_count()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"host path (e) on {card}: {DATA_STEPS} batches of "
          f"{tuple(got['tokens'].shape)} int32 tokens (vocab "
          f"{cfg.vocab_size}) from {shards} shards on {DATA_SERVERS} "
          f"servers (straggler {DATA_STRAGGLER}, {redirects} redirects; "
          f"prepare {prep_s:.3f} s), each on the card equal to "
          f"SyntheticTokens': {sum(ms) / len(ms):.3f} ms per batch "
          f"(first {ms[0]:.3f}, median {sorted(ms)[len(ms) // 2]:.3f})")


def run_host_path(serve_args, card) -> int:
    """Phases (a)-(e) of the host path, in order; returns (b)'s stream
    kernel launches."""
    t0 = time.perf_counter()
    launches = run_log_snapshot(run_completion_time(card), card)
    run_temporal_host(card)
    run_checkpoint(serve_args, card)
    run_token_batches(card)
    print(f"host path phase: {time.perf_counter() - t0:.1f} s")
    return launches


# -- the training path (launch/train, train/steps, optimizer) ------------------

TRAIN_ARCH = "gemma-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
TRAIN_OPT = topt.OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
TRAIN_PARITY_STEPS, TRAIN_LOSS_RTOL = 3, 1e-5   # tests/test_torch_train.py
RESUME_LAYERS, RESUME_STEPS = 2, 4
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
TRAIN_CLI = ["--arch", "gemma-2b", "--reduced", "--ckpt-every", "10",
             "--inject-straggler", "2"]
TRAIN_CLI_TIMEOUT_S = 300
MOE_TERMS = ("lb_loss", "z_loss", "moe_dropped")


def train_batch(cfg, step=0, device="cuda", seq=TRAIN_SEQ):
    return tdata.SyntheticTokens(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq,
        global_batch=TRAIN_BATCH)).batch_at(step, device)


def synced_s(fn):
    """(fn's result, its host seconds between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_flops(cfg, tokens, recompute=False) -> float:
    """6·N·tokens, N the parameters a token touches
    (`active_param_count`: an MoE layer's top-k experts, not all E), plus
    attention's S² products (the port scores every query against every
    key, masked: 4·B·S²·H·hd a layer forward), both three times over for
    the backward pass; with ``recompute``, also the layers' forward again
    (remat="block": the embedding, an untied head and the final norm lie
    outside the layers)."""
    n = cfg.active_param_count()
    attn = 4 * TRAIN_BATCH * TRAIN_SEQ ** 2 * cfg.n_heads * cfg.hd \
        * cfg.n_layers
    flops = 6 * n * tokens + 3 * attn
    if recompute:
        tables = 1 if cfg.tie_embeddings else 2
        blocks = n - tables * cfg.vocab_size * cfg.d_model - cfg.d_model
        flops += 2 * blocks * tokens + attn
    return flops


def run_train_full(card, cfg=None, label="train (a)", batch=None) -> dict:
    """(a): gemma-2b at full width and depth (f32 weights, bf16 compute,
    remat="block"), or ``cfg``, 6 steps on one repeated batch: step time
    (median of steps 2-6, each between two synchronizes), tokens/s, the
    share of the bf16 dense peak, peak memory, kernels a step
    (torch.profiler), the optimizer's share of a step (`optimizer.update`
    alone, CUDA events, median of 3 on one set of gradients) and, for an
    MoE configuration, the MoE terms of each step.  ``batch``: the
    repeated batch (default `train_batch`'s of step 0)."""
    cfg = cfg or get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    state, init_s = synced_s(lambda: tsteps.init_state(
        torch.Generator(device="cuda").manual_seed(0), cfg))
    batch = train_batch(cfg) if batch is None else batch
    step = tsteps.make_train_step(cfg, TRAIN_OPT)
    losses, gnorms, secs, moe_terms = [], [], [], []
    for _ in range(TRAIN_STEPS):
        (state, m), sec = synced_s(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        moe_terms.append(tuple(float(m[k]) for k in MOE_TERMS))
        secs.append(sec)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses + gnorms)) or losses[-1] >= losses[0]:
        fail(f"{cfg.name} training: losses {losses}, grad norms {gnorms}: "
             "not finite, or not lower at the last step")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = float(np.median(secs[1:]))
    mfu = train_flops(cfg, tokens) / step_s / BF16_TENSOR_FLOPS
    hfu = train_flops(cfg, tokens, recompute=True) / step_s \
        / BF16_TENSOR_FLOPS
    state_gb = sum(t.numel() * t.element_size()
                   for _, t in tckpt.flatten_with_paths(state)) / 1e9
    print(f"{label} {cfg.name} ({cfg.n_layers} layers) on {card}: "
          f"{cfg.param_count()} parameters ({cfg.active_param_count()} "
          f"active a token), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, remat "
          f"{cfg.remat}, {cfg.compute_dtype} compute; train state "
          f"{state_gb:.4f} GB; init {init_s:.3f} s")
    print(f"  losses {losses}")
    print(f"  grad norms {gnorms}")
    if cfg.moe is not None:
        print(f"  {' / '.join(MOE_TERMS)} per step {moe_terms}")
    print(f"  step s {secs} (median of steps 2-{TRAIN_STEPS} {step_s:.6f} "
          f"s, {tokens / step_s:.1f} tokens/s); bf16 peak share "
          f"{mfu:.4f} of {BF16_TENSOR_FLOPS:.3g} FLOP/s by 6*N_active*tokens"
          f" + attention ({train_flops(cfg, tokens):.6g} FLOP), {hfu:.4f} "
          f"with the remat forward ({train_flops(cfg, tokens, True):.6g})")
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.3f} GB)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        (state, _), prof_s = synced_s(lambda: step(state, batch))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in events)
    busy_ms = sum(device_ms(e) for e in events)
    print(f"  profiler, one step: {n_kernels} kernels, device busy "
          f"{busy_ms:.3f} ms of {prof_s * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (prof_s * 1e3):.4f}; {busy_ms / (step_s * 1e3):.4f} "
          f"of the median unprofiled step)")
    for e in sorted(events, key=device_ms, reverse=True)[:6]:
        print(f"    {device_ms(e):9.3f} ms  {e.count:5d} x  {e.key[:90]}")

    names, leaves = zip(*state.params.named_parameters())
    loss, _ = T.lm_loss(state.params, batch, cfg)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    del loss
    opt_ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        _, opt, _ = topt.update(TRAIN_OPT, grads, state.opt, state.params)
        end.record()
        torch.cuda.synchronize()
        state = state._replace(opt=opt)
        opt_ms.append(start.elapsed_time(end))
    opt_med = float(np.median(opt_ms))
    print(f"  optimizer.update alone {opt_ms} ms (median {opt_med:.4f} ms, "
          f"{opt_med / (step_s * 1e3):.4f} of the median step)")
    del state, grads, batch
    torch.cuda.empty_cache()
    return dict(step_s=step_s, tokens_per_s=tokens / step_s, mfu=mfu,
                peak_bytes=peak, kernels=n_kernels, opt_ms=opt_med)


def fresh_on(cfg, dev, seed=0):
    """A train state drawn on the CPU from ``seed``, moved to ``dev``."""
    state = tsteps.init_state(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
    params = state.params.to(dev)
    return tsteps.TrainState(params=params, opt=topt.init(params),
                             step=state.step.to(dev))


def run_train_parity(card, arch=TRAIN_ARCH, label="train (b)", cfg=None,
                     steps=TRAIN_PARITY_STEPS, gnorm_rtol=TRAIN_LOSS_RTOL,
                     seq=TRAIN_SEQ, batch_fn=train_batch):
    """(b): the reduced gemma-2b (or ``arch``, or ``cfg``) in float32
    compute, 3 (or ``steps``) train steps at batch 4 x 512 (or ``seq``) on
    the card against the same steps on the CPU, held to the CPU tests'
    tolerances (loss 1e-5 and grad norm ``gnorm_rtol`` relative,
    parameters 2·sum(lr)); an MoE configuration's terms are printed
    beside.  ``batch_fn(cfg, step, device, seq)`` makes each step's
    batch."""
    cfg = cfg or dataclasses.replace(get_config(arch, reduced=True),
                                     compute_dtype="float32")
    step = tsteps.make_train_step(cfg, TRAIN_OPT)
    card_state, cpu_state = fresh_on(cfg, "cuda"), fresh_on(cfg, "cpu")
    worst, lr_sum = [0.0, 0.0], 0.0
    terms = []
    for i in range(steps):
        card_state, mc = step(card_state, batch_fn(cfg, i, "cuda", seq))
        cpu_state, mh = step(cpu_state, batch_fn(cfg, i, "cpu", seq))
        worst = [max(w, abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k])))
                 for w, k in zip(worst, ("loss", "grad_norm"))]
        terms.append([(float(mc[k]), float(mh[k])) for k in MOE_TERMS
                      if k in mh])
        lr_sum += float(mh["lr"])
    got, want = card_state.params.state_dict(), cpu_state.params.state_dict()
    p_err = max((got[k].cpu() - want[k]).abs().max().item() for k in want)
    ok = worst[0] <= TRAIN_LOSS_RTOL and worst[1] <= gnorm_rtol and \
        p_err <= 2 * lr_sum
    if cfg.moe is not None:
        print(f"{label} {' / '.join(MOE_TERMS)} per step, (card, CPU): "
              f"{terms}")
    print(f"{label} {cfg.name}, f32, {steps} steps at seq {seq} on {card} "
          "against the "
          f"CPU: loss / grad norm max rel diff {worst[0]:.3g} / "
          f"{worst[1]:.3g} (tolerance {TRAIN_LOSS_RTOL:g} / {gnorm_rtol:g});"
          f" parameters max abs diff {p_err:.3g} (tolerance 2*sum(lr) = "
          f"{2 * lr_sum:.3g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the reduced {cfg.name} train steps on the card disagree "
             "with the CPU")


def state_diff(a, b):
    """(largest |a - b| over params, m and v; all bit-equal; all within
    RESUME_RTOL / RESUME_ATOL)."""
    worst, equal, close = 0.0, True, True
    for x, y in ((a.params.state_dict(), b.params.state_dict()),
                 (a.opt.m, b.opt.m), (a.opt.v, b.opt.v)):
        for k in x:
            worst = max(worst, (x[k] - y[k]).abs().max().item())
            equal = equal and torch.equal(x[k], y[k])
            close = close and torch.allclose(x[k], y[k], rtol=RESUME_RTOL,
                                             atol=RESUME_ATOL)
    return worst, equal, close


def run_train_resume(card):
    """(c): gemma-2b at full width cut to 2 layers (its p, m and v 8.9 GB)
    trains 4 steps, saves through `Checkpointer` with a straggler and a
    failed server, trains 4 more; a fresh state restored from the
    checkpoint onto the card trains the same 4, held to the uninterrupted
    8 within rtol 1e-5 / atol 1e-6 (CUDA's embedding backward may
    accumulate in another order)."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=RESUME_LAYERS)
    step = tsteps.make_train_step(cfg, TRAIN_OPT)
    gen = lambda: torch.Generator(device="cuda").manual_seed(1)
    state = tsteps.init_state(gen(), cfg)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in tckpt.flatten_with_paths(state))
    root = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        check_room(f"train (c) gemma-2b cut to {RESUME_LAYERS} layers, "
                   f"{cfg.param_count()} parameters, p + m + v", nbytes,
                   root)
        for i in range(RESUME_STEPS):
            state, _ = step(state, train_batch(cfg, i))
        ck = tckpt.Checkpointer(root)
        ck.store.set_write_delay(CKPT_STRAGGLER, CKPT_DELAY_S_PER_MB)
        ck.store.fail_server(CKPT_FAILED)
        _, save_s = synced_s(lambda: ck.save(RESUME_STEPS, state))
        st = ck.client.stats()
        for i in range(RESUME_STEPS, 2 * RESUME_STEPS):
            state, m = step(state, train_batch(cfg, i))
        template = tsteps.init_state(gen(), cfg)
        back, restore_s = synced_s(lambda: tsteps.load_state(
            template, ck.restore(target=template)))
        del template
        if int(back.step) != RESUME_STEPS or back.opt.m[
                "embed.table"].device.type != "cuda":
            fail(f"train (c): restored step {int(back.step)} is not "
                 f"{RESUME_STEPS}, or its leaves are not on the card")
        for i in range(RESUME_STEPS, 2 * RESUME_STEPS):
            back, mb = step(back, train_batch(cfg, i))
        ck.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    worst, equal, close = state_diff(back, state)
    print(f"  save at step {RESUME_STEPS}: {save_s:.3f} s "
          f"({nbytes / save_s / 1e9:.4f} GB/s), {int(st['writes'])} objects"
          f", failed writes {int(st['failed_writes'])}, redirect rate "
          f"{st['redirect_rate']:.4f}; restore onto the card {restore_s:.3f}"
          f" s ({nbytes / restore_s / 1e9:.4f} GB/s)")
    print(f"  resumed {RESUME_STEPS} + {RESUME_STEPS} steps against "
          f"{2 * RESUME_STEPS} uninterrupted: loss {float(mb['loss'])!r} / "
          f"{float(m['loss'])!r}, params/m/v max abs diff {worst:.3g}, "
          f"bit-equal {equal}, within rtol {RESUME_RTOL:g} / atol "
          f"{RESUME_ATOL:g} {close}")
    if not close or st["failed_writes"] < 1:
        fail("train (c): the resumed state differs from the uninterrupted "
             "run, or the failed server was never tried")
    del state, back
    torch.cuda.empty_cache()


def run_train_cli(card):
    """`python -m repro_torch.launch.train` on the card in a subprocess:
    the reduced gemma-2b, 20 steps with checkpoints every 10 under a
    straggler, then the same job resumed to 30 steps."""
    root = tempfile.mkdtemp(prefix="train_cli_")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    try:
        for steps, expect in ((20, "[train] step    20"),
                              (30, "[train] resumed from step 20")):
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   *TRAIN_CLI, "--steps", str(steps), "--ckpt-dir", root]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=TRAIN_CLI_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if out.returncode or expect not in out.stdout:
                fail(f"{' '.join(cmd[1:])} exited {out.returncode} without "
                     f"{expect!r}:\n{out.stdout[-2000:]}\n"
                     f"{out.stderr[-2000:]}")
            lines = [x for x in out.stdout.splitlines()
                     if x.startswith("[train]")]
            print(f"train CLI on {card} ({wall:.1f} s): "
                  f"{' '.join(cmd[3:-2])}")
            for line in lines:
                print(f"  {line}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_train_path(card) -> None:
    """The training phase, (a)-(c) and the CLI, with the port's kernel
    counts zeroed before and read after: training launches none of them
    (the JAX package trains with XLA attention, not its Pallas kernel)."""
    t0 = time.perf_counter()
    zero_counts()
    run_train_full(card)
    run_train_parity(card)
    run_train_resume(card)
    counts = all_counts()
    if any(counts.values()):
        fail(f"the training path launched {counts}")
    print(f"training path: launches {counts}")
    run_train_cli(card)
    print(f"training phase: {time.perf_counter() - t0:.1f} s")


# -- the sharded train step (parallel/sharding.py, train/steps.py) ------------

SHARD_LAYERS, SHARD_STEPS = 2, 3
SHARD_OPT = topt.OptConfig(**shard_worker.STEP_OPT)
SHARD_TIMEOUT_S = 240   # a world's ranks, from spawn to exit
OPT_RTOL = 1e-6         # tests/test_torch_train.py
# (b)'s well-conditioned parameters after 3 steps, as a share of the
# steps' summed learning rates, the size of the update a step misses
# (on the card: 0.011, an element of a norm scale that starts at zero)
SHARD_P_LR = 0.05
PSUM_REL, PSUM_ABS = 0.02, 1e-3   # the JAX package's compressed_psum bound


def psum_bound_err(mean, exact) -> tuple:
    """(largest |mean - exact| over the leaves, its bound 0.02 * the
    largest |exact| + 1e-3)."""
    err = max(float((mean[k].cpu() - exact[k]).abs().max()) for k in exact)
    scale = max(float(exact[k].abs().max()) for k in exact)
    return err, PSUM_REL * scale + PSUM_ABS


def run_sharded_one(card):
    """(a) A (1, 1) ``DeviceMesh`` in an NCCL world of one, the rules of
    `make_rules` over it: gemma-2b at full width cut to 2 layers (f32
    state, bf16 compute), its p, m and v DTensors on the card, 3 sharded
    steps on batch 4 x 512 beside the unsharded step on the same batch;
    each step's loss, grad norm, parameters, m and v compared (bit-equal
    expected: the collectives are identities over one rank), the step
    times and the peak memory printed; no kernel of the port launched.
    Then (c) `compressed_psum` over the world of one against the exact
    mean."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.shardutil import state_shardings
    from repro_torch.parallel import sharding as PS
    from repro_torch.train import compression as C
    rules = PS.make_rules(tmesh.make_mesh((1, 1), "cuda"))
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail("sharded train (a): the world of one is not NCCL's")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=SHARD_LAYERS)
    nbytes = 3 * sum(t.numel() * t.element_size() for t in
                     tsteps.abstract_state(cfg).params.state_dict().values())
    check_card_room(f"sharded train (a) {cfg.name} cut to {SHARD_LAYERS} "
                    "layers, p + m + v twice", 2 * nbytes)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    plain = tsteps.init_state(gen(), cfg)
    sharded = tsteps.shard_state(tsteps.init_state(gen(), cfg),
                                 state_shardings(tsteps.abstract_state(cfg),
                                                 rules))
    kind = {type(t).__name__ for t in sharded.params.state_dict().values()}
    step = tsteps.make_train_step(cfg, SHARD_OPT)
    sstep = tsteps.make_sharded_train_step(cfg, SHARD_OPT, rules)
    zero_counts()
    rows, worst, lr_sum, p_check = [], {}, 0.0, None
    for i in range(SHARD_STEPS):
        batch = train_batch(cfg, i)
        (plain, mp), t_plain = synced_s(lambda: step(plain, batch))
        torch.cuda.reset_peak_memory_stats()
        (sharded, ms), t_shard = synced_s(lambda: sstep(sharded, batch))
        peak = torch.cuda.max_memory_allocated()
        lr_sum += float(mp["lr"])
        pairs = {"loss/grad_norm": [(ms[k], mp[k])
                                    for k in ("loss", "grad_norm")]}
        shards = sharded.params.state_dict()
        pairs["params"] = [(shards[k].to_local(), p)
                           for k, p in plain.params.state_dict().items()]
        for part in ("m", "v"):
            pairs[part] = [(getattr(sharded.opt, part)[k].to_local(), t)
                           for k, t in getattr(plain.opt, part).items()]
        for name, group in pairs.items():
            equal = all(torch.equal(a, b) for a, b in group)
            rel = max(float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30) for a, b in group)
            absd = max(float((a - b).abs().max()) for a, b in group)
            w = worst.setdefault(name, [True, 0.0, 0.0])
            worst[name] = [w[0] and equal, max(w[1], rel), max(w[2], absd)]
        if not worst["params"][0]:
            p_check = shard_worker.param_errors(
                {k: t.to_local() for k, t in shards.items()},
                plain.params.state_dict(), plain.opt.v, i + 1)
        rows.append((float(ms["loss"]), float(mp["loss"]), t_shard, t_plain,
                     peak))
    counts = all_counts()
    for i, (ls, lp, ts, tp, peak) in enumerate(rows):
        print(f"sharded train (a) step {i + 1}: loss {ls!r} (unsharded "
              f"{lp!r}); step {ts:.4f} s sharded, {tp:.4f} s unsharded; "
              f"peak {peak / 1e9:.3f} GB during the sharded step")
    print(f"sharded train (a) {cfg.name} cut to {SHARD_LAYERS} layers "
          f"({cfg.param_count()} parameters; p, m and v {nbytes / 1e9:.3f} "
          f"GB f32, held as {sorted(kind)}) on a (1, 1) mesh, NCCL world of "
          f"one, bf16 compute, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{SHARD_STEPS} steps on {card}: " + "; ".join(
              f"{k} bit-equal {e}, max rel {r:.3g}, max abs {a:.3g}"
              for k, (e, r, a) in worst.items()) + f"; launches {counts}")
    bad = [k for k, (e, r, a) in worst.items()
           if not e and k != "params" and r > OPT_RTOL]
    if p_check is not None:
        print(f"sharded train (a) parameters after the last step: "
              f"well-conditioned max rel {p_check['rel']:.3g}; "
              f"{p_check['n_ill']} of {p_check['n']} elements "
              f"ill-conditioned, max abs {p_check['ill_abs']:.3g}")
        if p_check["rel"] > OPT_RTOL or p_check["ill_abs"] > 2 * lr_sum:
            bad.append("params")
    if bad or any(counts.values()):
        fail(f"sharded train (a) differs from the unsharded step in {bad} "
             f"(loss, grad norm, m and v to {OPT_RTOL:g} relative; "
             f"parameters to {OPT_RTOL:g} of their leaf's largest where "
             "well-conditioned, else 2*sum(lr) = "
             f"{2 * lr_sum:.3g}), or launched {counts}")
    del plain, sharded
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = {k: torch.randn(shape, generator=gen, device="cuda")
             for k, shape in (("a", (2048, 2048)), ("b", (8, 64)))}
    mean, _ = C.compressed_psum(grads, C.init_ef(grads), None)
    err, tol = psum_bound_err(mean, {k: g.cpu() for k, g in grads.items()})
    print(f"sharded train (c) compressed_psum over the NCCL world of one: "
          f"max error {err:.4g} against the exact mean (bound {tol:.4g})")
    if err > tol:
        fail("sharded train (c): compressed_psum past its bound")
    dist.destroy_process_group()


def shard_inputs():
    """The gloo worlds' inputs (tests/torch_sharding_worker.py's): each
    case arch's state from seed 0 on the CPU and the batch."""
    inputs = {"batch": tdata.SyntheticTokens(tdata.DataConfig(
        vocab_size=512, seq_len=shard_worker.S,
        global_batch=shard_worker.B, seed=1)).batch_at(0, "cpu")}
    for arch in shard_worker.ARCHS:
        cfg = shard_worker.case_fields(get_config(arch, reduced=True))
        state = tsteps.init_state(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
        inputs[arch] = dict(params=dict(state.params.state_dict()),
                            m=state.opt.m, v=state.opt.v,
                            count=state.opt.count, step=state.step)
    return inputs


def shard_unsharded(arch, spec, inputs):
    """The unsharded steps of a case on the card under the rules of its
    mesh's shape (the same MoE pools): each step's metrics and the final
    state."""
    from repro_torch.parallel import sharding as PS
    cfg = shard_worker.case_fields(get_config(arch, reduced=True))
    saved = inputs[arch]
    state = tsteps.load_state(
        tsteps.init_state(torch.Generator(device="cuda"), cfg),
        tsteps.TrainState(
            saved["params"], topt.OptState(
                {k: t.cuda() for k, t in saved["m"].items()},
                {k: t.cuda() for k, t in saved["v"].items()},
                saved["count"].cuda()), saved["step"].cuda()))
    dims = shard_worker.mesh_dims(spec)
    rules = PS.make_rules(PS.MeshShape(("data", "model")[:len(dims)], dims))
    step = tsteps.make_train_step(cfg, SHARD_OPT)
    batch = {k: v.cuda() for k, v in inputs["batch"].items()}
    by_step = []
    with PS.use_mesh_rules(rules):
        for _ in range(SHARD_STEPS):
            state, metrics = step(state, batch)
            by_step.append({k: float(v) for k, v in metrics.items()})
    return by_step, state


def run_sharded_gloo(card):
    """(b) gloo worlds of 2 and 4 ranks sharing the card, each rank a
    process of tests/torch_sharding_worker.py on the card: meshes 2 and
    1x2 (world of 2) and 2x2 (world of 4), the reduced gemma-2b and
    mixtral-8x22b (local MoE pools) in f32, 3 steps; every rank's loss
    and grad norm at every step within F32_LOSS_RTOL of the unsharded
    step's on the card, its gathered m and sqrt(v) within the bounds
    GRAD_ATOL puts on Adam's weighted mean and root mean square of the
    gradients (`torch_sharding_worker.moment_errors`), its parameters
    within SHARD_P_LR * sum(lr), except the ill-conditioned elements (the
    unsharded run's RMS gradient below 1000 eps,
    `torch_sharding_worker.param_errors`), counted and held to
    2 * sum(lr) (the largest errors printed); (c)
    `compressed_psum` over each world, every rank alike and within the
    bound of the exact mean.  Both worlds run at once.  A rank that fails
    or times out fails the phase."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    worker = Path(__file__).resolve().parent / "tests" / \
        "torch_sharding_worker.py"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    staged = "staged through host memory (gloo takes CUDA tensors there)"
    try:
        inputs = shard_inputs()
        torch.save(inputs, tmp / "inputs.pt")
        # both worlds at once: six processes on the card's host
        t0 = time.perf_counter()
        names = [(w, r) for w in shard_worker.WORLD_MESHES for r in range(w)]
        logs = {n: open(tmp / f"w{n[0]}-rank{n[1]}.log", "w") for n in names}
        procs = {(w, r): subprocess.Popen(
            [sys.executable, str(worker), str(r), str(w),
             str(tmp / f"store{w}"), str(tmp), "cuda", str(SHARD_STEPS)],
            env=env, stdout=logs[w, r], stderr=subprocess.STDOUT)
            for w, r in names}
        failed = []
        for n, proc in procs.items():
            left = SHARD_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                code = proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                code = "a timeout"
            if code != 0:
                failed.append(n)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
        if failed:
            tails = "\n".join(
                f"world {w} rank {r}: "
                + (tmp / f"w{w}-rank{r}.log").read_text()[-2000:]
                for w, r in failed)
            fail(f"sharded train (b): ranks (world, rank) {failed} "
                 f"failed\n{tails}")
        print(f"sharded train (b) gloo worlds of 2 and 4 on the card, run "
              f"together: {time.perf_counter() - t0:.1f} s with the ranks' "
              f"start; collectives {staged}")
        for world, specs in shard_worker.WORLD_MESHES.items():
            ranks = [torch.load(tmp / f"w{world}-rank{r}.pt",
                                weights_only=False) for r in range(world)]
            for spec in specs:
                for arch in shard_worker.ARCHS:
                    check_sharded_case(world, spec, arch, ranks, inputs,
                                       card)
            check_gloo_psum(world, ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_sharded_case(world, spec, arch, ranks, inputs, card):
    want_steps, want = shard_unsharded(arch, spec, inputs)
    lr_sum = sum(m["lr"] for m in want_steps)
    loss_err = dm = dv = 0.0
    errs = []
    for got in ranks:
        got = got[spec, arch]
        for g, w in zip(got["by_step"], want_steps):
            for k in ("loss", "grad_norm"):
                loss_err = max(loss_err, abs(float(g[k]) - w[k])
                               / abs(w[k]))
        m_err, v_err, m_tol, v_tol = shard_worker.moment_errors(
            got["m"], got["v"], want.opt.m, want.opt.v, SHARD_STEPS)
        dm, dv = max(dm, m_err), max(dv, v_err)
        errs.append(shard_worker.param_errors(
            got["params"], want.params.state_dict(), want.opt.v,
            SHARD_STEPS))
    worst = dict(max(errs, key=lambda e: e["abs"]),
                 ill_abs=max(e["ill_abs"] for e in errs))
    ok = loss_err <= TRAIN_LOSS_RTOL and dm <= m_tol and dv <= v_tol and \
        worst["abs"] <= SHARD_P_LR * lr_sum and \
        worst["ill_abs"] <= 2 * lr_sum
    walls = ranks[0][spec, arch]["walls"]
    print(f"sharded train (b) {arch} reduced, f32, mesh {spec} on a gloo "
          f"world of {world}, {SHARD_STEPS} steps on {card}: every rank's "
          f"loss / grad norm max rel diff {loss_err:.3g} (tolerance "
          f"{TRAIN_LOSS_RTOL:g}), m / sqrt(v) max abs diff {dm:.3g} / "
          f"{dv:.3g} (tolerance {m_tol:.3g} / {v_tol:.3g}), parameters "
          f"where well-conditioned max abs diff {worst['abs']:.3g} = "
          f"{worst['abs'] / lr_sum:.3g} sum(lr) (tolerance {SHARD_P_LR:g} "
          f"sum(lr)), max rel {worst['rel']:.3g} of their leaf's largest "
          f"({worst['rel_leaf']}), {worst['n_ill']} of {worst['n']} "
          "elements ill-conditioned (RMS gradient below "
          f"{shard_worker.ILL_RMS} eps), max abs diff {worst['ill_abs']:.3g} "
          f"(tolerance 2*sum(lr) = {2 * lr_sum:.3g}); local "
          f"MoE pool calls {ranks[0][spec, arch]['local_calls']}; rank 0's "
          f"step walls {', '.join(f'{w:.4f}' for w in walls)} s "
          f"({GLOO_NOTE}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"sharded train (b) {arch} mesh {spec} disagrees with the "
             "unsharded step")


def check_gloo_psum(world, ranks):
    """(c) on a gloo world: both rounds alike on every rank, the first
    within the bound of the exact mean."""
    exact = {k: torch.from_numpy(np.mean(
        [shard_worker.psum_inputs(r, 0)[k] for r in range(world)], axis=0))
        for k in shard_worker.psum_inputs(0, 0)}
    for round_ in (0, 1):
        first = ranks[0]["psum"]["world", round_]["mean"]
        if not all(torch.equal(r["psum"]["world", round_]["mean"][k],
                               first[k]) for r in ranks for k in first):
            fail(f"sharded train (c): compressed_psum differs between the "
                 f"ranks of the gloo world of {world}")
    err, tol = psum_bound_err(ranks[0]["psum"]["world", 0]["mean"], exact)
    print(f"sharded train (c) compressed_psum over the gloo world of "
          f"{world} on the card: every rank alike, max error {err:.4g} "
          f"against the exact mean (bound {tol:.4g})")
    if err > tol:
        fail("sharded train (c): compressed_psum past its bound")


def run_sharded_train_path(card) -> None:
    """The sharded train phase: (a) and (c) on an NCCL world of one, then
    (b) and (c) on gloo worlds of 2 and 4 sharing the card."""
    t0 = time.perf_counter()
    run_sharded_one(card)
    t1 = time.perf_counter()
    run_sharded_gloo(card)
    print(f"sharded train phase on {card}: {time.perf_counter() - t0:.1f} s"
          f" ((a) and (c) {t1 - t0:.1f} s)")

# -- the dry run ---------------------------------------------------------------

# (arch, shapes, mesh): the production cells the phase traces, one
# process a mesh
DRYRUN_CELLS = (("gemma-2b", "train_4k,decode_32k", "16x16"),
                ("mixtral-8x22b", "decode_32k", "2x16x16"))
# the dry run's peak against the card's max_memory_allocated, relative
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_TIMEOUT = 240   # seconds, for each process of the phase
DRYRUN_DECODE_STEPS = 2


def dryrun_env() -> dict:
    root = Path(__file__).resolve().parent
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root / "tests")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def start_dryrun_procs(tmp: str) -> dict:
    """(a)'s CLI processes, one a mesh, and (b)'s prediction process,
    started at once: they run on the host while the card checks run."""
    procs = {}
    for arch, shapes_, mesh in DRYRUN_CELLS:
        out = os.path.join(tmp, f"cells-{mesh}.json")
        procs[f"cells {mesh}"] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shapes_, "--mesh", mesh, "--out", out],
            env=dryrun_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    out = os.path.join(tmp, "predict.json")
    procs["predict"] = (subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dryrun-predict",
         out], env=dryrun_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), out)
    return procs


def finish_dryrun_procs(procs: dict) -> dict:
    """Wait for the phase's processes (`run_dryrun_path` kills any left
    running); any failure fails the run.  Their outputs (JSON) by
    name."""
    got, failed = {}, []
    for name, (proc, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"{name} timed out:\n{log[-2000:]}")
            continue
        if proc.returncode != 0:
            failed.append(f"{name} exited {proc.returncode}:\n"
                          f"{log[-2000:]}")
            continue
        with open(out) as f:
            got[name] = json.load(f)
    if failed:
        fail("dry run: " + "\n\n".join(failed))
    return got


def dryrun_check_cfg():
    """(b)'s cell: gemma-2b at full width cut to `SHARD_LAYERS` layers,
    the sharded train phase's."""
    return dataclasses.replace(get_config(TRAIN_ARCH), n_layers=SHARD_LAYERS)


def dryrun_predict_main(out: str) -> None:
    """``--dryrun-predict OUT``: (b)'s cell through the dry run's trace in
    a fake world of one on a (1, 1) mesh, on ``meta``; its peak, FLOPs and
    arguments to OUT.  No card is touched."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as tmesh
    from repro_torch.parallel import sharding as PS
    D.start_world(1)
    rules = PS.make_rules(tmesh.make_mesh((1, 1), "cpu"))
    t0 = time.perf_counter()
    tr = D.trace_step(dryrun_check_cfg(), shapes.ShapeSpec(
        "train_4k", "train", TRAIN_SEQ, TRAIN_BATCH), rules)
    with open(out, "w") as f:
        json.dump(dict(peak=tr["peak"], flops=tr["flops"],
                       bytes=tr["bytes"], args=tr["arg_parts"],
                       wall=time.perf_counter() - t0), f)


def print_dryrun_cells(got: dict) -> None:
    """(a): each production record's memory, FLOPs, dominant term and
    wall; any status but ok fails."""
    for _, _, mesh in DRYRUN_CELLS:
        for rec in got[f"cells {mesh}"]:
            if rec["status"] != "ok":
                fail(f"dry run (a) {rec['arch']} {rec['shape']} {mesh}: "
                     f"{rec['status']} {rec.get('error', '')}")
            mem, roof = rec["memory"], rec["roofline"]
            print(f"dry run (a) {rec['arch']} {rec['shape']} on {mesh} "
                  f"({rec['n_devices']} ranks, fake world, meta): peak "
                  f"{mem['peak_per_device_bytes'] / 1e9:.3f} GB a rank "
                  f"(arguments {mem['argument_bytes'] / 1e9:.3f} GB, "
                  f"fits 80 GB {mem['fits_80gb']}), "
                  f"{rec['cost']['flops_per_dev']:.4g} FLOPs and "
                  f"{rec['cost']['bytes_per_dev']:.4g} bytes a rank, "
                  f"{rec['collectives']['n_ops']} collectives, dominant "
                  f"{roof['dominant']} (compute {roof['compute_s']:.4g} s, "
                  f"memory {roof['memory_s']:.4g} s, collective "
                  f"{roof['collective_s']:.4g} s, spec-sheet rates), "
                  f"useful {roof['useful_flops_ratio']:.4f}; wall "
                  f"{rec['wall_s']} s on this host")


def check_dryrun_peak(predicted: dict, card) -> None:
    """(b) One real sharded step of `dryrun_check_cfg` at 4 x 512 on a
    (1, 1) mesh in an NCCL world of one, after a first step (the card's
    libraries' workspaces allocated): ``max_memory_allocated`` over the
    step, measured after ``reset_peak_memory_stats`` with the state in
    place, less what the process holds besides the step's arguments,
    against the dry run's peak."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.shardutil import state_shardings
    from repro_torch.parallel import sharding as PS
    rules = PS.make_rules(tmesh.make_mesh((1, 1), "cuda"))
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail("dry run (b): the world of one is not NCCL's")
    cfg = dryrun_check_cfg()
    state = tsteps.shard_state(
        tsteps.init_state(torch.Generator(device="cuda").manual_seed(0),
                          cfg),
        state_shardings(tsteps.abstract_state(cfg), rules))
    step = tsteps.make_sharded_train_step(cfg, SHARD_OPT, rules)
    batch = train_batch(cfg, 0)
    state, _ = step(state, batch)
    held = [t.to_local() for t in state.params.state_dict().values()] + [
        t.to_local() for t in (*state.opt.m.values(), *state.opt.v.values())
    ] + [state.opt.count, state.step, *batch.values()]
    args = sum(t.numel() * t.element_size() for t in held)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - args
    torch.cuda.reset_peak_memory_stats()
    (state, metrics), t_step = synced_s(lambda: step(state, batch))
    peak = torch.cuda.max_memory_allocated() - other
    rel = abs(predicted["peak"] - peak) / peak
    print(f"dry run (b) {cfg.name} cut to {SHARD_LAYERS} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, (1, 1) mesh on {card}: predicted "
          f"peak {predicted['peak'] / 1e9:.4f} GB (MemTracker on meta, "
          f"{predicted['wall']:.1f} s to trace), measured "
          f"{peak / 1e9:.4f} GB (max_memory_allocated "
          f"{(peak + other) / 1e9:.4f} GB less {other / 1e9:.4f} GB held "
          f"besides the step's {args / 1e9:.4f} GB of arguments; predicted "
          f"arguments {sum(predicted['args'].values()) / 1e9:.4f} GB): "
          f"{predicted['peak']:.0f} B against {peak} B, {rel:.3g} apart "
          f"(at most {DRYRUN_PEAK_RTOL}); step "
          f"{t_step:.4f} s, traced {predicted['flops']:.4g} FLOPs: "
          f"{predicted['flops'] / t_step / 1e12:.2f} TFLOP/s; loss "
          f"{float(metrics['loss']):.4f}")
    if not np.isfinite(float(metrics["loss"])):
        fail("dry run (b): the step's loss is not finite")
    if rel > DRYRUN_PEAK_RTOL:
        fail(f"dry run (b): predicted peak {predicted['peak']} B against "
             f"{peak} B measured, {rel:.4f} apart")
    del state, batch, held
    torch.cuda.empty_cache()
    return rules


def check_dryrun_serve(rules, card) -> int:
    """(c) gemma-2b as the serve sets it up (full width and depth, the
    prefill on the flash route) on the (1, 1) mesh: the sharded prefill
    and `DRYRUN_DECODE_STEPS` sharded decode steps bit-equal to the
    unsharded ones; the sharded prefill's launches counted (one wgmma a
    layer, nothing else).  Returns the wgmma launches."""
    from repro_torch.launch.shardutil import param_shardings
    cfg, params, prompts = serve.setup(serve.parse_args(SERVE_ARGS))
    pcfg = dataclasses.replace(cfg, use_pallas_attn=True)
    batch = {"tokens": prompts}
    b, s = prompts.shape
    want = tsteps.make_prefill_step(pcfg)(params, batch)
    caches = T.init_caches(cfg, b, s, "cuda")
    decode = tsteps.make_decode_step(cfg)
    want_dec = []
    for t in range(DRYRUN_DECODE_STEPS):
        want_dec.append(decode(params, caches, prompts[:, t:t + 1], t)[0])
    params = tsteps.shard_params(params, param_shardings(params, rules))
    zero_counts()
    got = tsteps.make_sharded_prefill_step(pcfg, rules)(params, batch)
    torch.cuda.synchronize()
    counts = all_counts()
    rows = tsteps.local_rows(rules, b, cfg)
    caches = T.init_caches(cfg, rows, s, "cuda")
    sdecode = tsteps.make_sharded_decode_step(cfg, rules)
    got_dec = [sdecode(params, caches, prompts[:, t:t + 1], t)[0]
               for t in range(DRYRUN_DECODE_STEPS)]
    equal = torch.equal(got, want) and all(
        torch.equal(a, w) for a, w in zip(got_dec, want_dec))
    print(f"dry run (c) {cfg.name} serve configuration, batch {b} x {s}, "
          f"(1, 1) mesh, NCCL world of one on {card}: sharded prefill and "
          f"{DRYRUN_DECODE_STEPS} decode steps bit-equal to the unsharded "
          f"{equal} (prefill max abs "
          f"{float((got.float() - want.float()).abs().max()):.3g}); "
          f"sharded prefill launches {counts}")
    if not equal:
        fail("dry run (c): the sharded serve steps differ from the "
             "unsharded ones")
    if counts != dict({k: 0 for k in counts},
                      flash_attention_wgmma=cfg.n_layers):
        fail(f"dry run (c): the sharded prefill launched {counts}, "
             f"expected {cfg.n_layers} flash_attention_wgmma launches")
    del params, caches, got, want
    torch.cuda.empty_cache()
    return counts["flash_attention_wgmma"]


def check_dryrun_name_map(card) -> None:
    """(d) The reduced gemma-2b's train state written on the host in the
    JAX package's layout (`interop.save_jax_train_state`: stacked group
    positions, JAX leaf paths), restored onto the card through the name
    map (`interop.restore_jax_train_state`); its prefill logits against
    `interop.params_from_numpy` of the same arrays on the card."""
    from repro_torch import interop
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True),
                              compute_dtype="float32")
    host = tsteps.init_state(torch.Generator().manual_seed(3), cfg, "cpu")
    leaves = interop.jax_leaves_from_train_state(host, cfg)
    arrays = interop._nest({k: v.numpy() for k, v in leaves.items()})
    tmp = tempfile.mkdtemp()
    try:
        ckpt = tckpt.Checkpointer(tmp, n_servers=4)
        interop.save_jax_train_state(ckpt, 1, host, cfg)
        state = interop.restore_jax_train_state(ckpt, cfg, device="cuda")
        ckpt.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_params = interop.params_from_numpy(arrays["params"], cfg, "cuda")
    prompts = torch.randint(1, cfg.vocab_size, (2, 16), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(9))
    fwd = tsteps.make_prefill_step(cfg)
    got, want = (fwd(p, {"tokens": prompts})
                 for p in (state.params, want_params))
    same_state = all(torch.equal(a, b) for a, b in zip(
        state.params.state_dict().values(),
        want_params.state_dict().values()))
    print(f"dry run (d) {cfg.name} train state through the JAX layout "
          f"({len(leaves)} leaves) restored on {card}: prefill logits "
          f"equal {torch.equal(got, want)}, parameters equal {same_state}, "
          f"step {int(state.step)}")
    if not (torch.equal(got, want) and same_state):
        fail("dry run (d): the restored state's logits differ")


def run_dryrun_path(card) -> int:
    """The dry-run phase, (a)-(d) (the module docstring); the host's
    processes run while the card checks run.  Returns (c)'s wgmma
    launches."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    procs = start_dryrun_procs(tmp)
    try:
        predicted = finish_dryrun_procs({"predict": procs["predict"]})
        rules = check_dryrun_peak(predicted["predict"], card)
        launches = check_dryrun_serve(rules, card)
        dist.destroy_process_group()
        check_dryrun_name_map(card)
        print_dryrun_cells(finish_dryrun_procs(
            {k: v for k, v in procs.items() if k != "predict"}))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"dry run phase on {card}: {time.perf_counter() - t0:.1f} s")
    return launches


# -- flash attention and the serving path --------------------------------------


def flash_operands(b, s, h, kv, hd, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev,
                        dtype=getattr(torch, dtype))
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


def check_flash(dev):
    """The flash kernels against the plain version on the card for every
    case of FLASH_CHECKS: each case through the kernel `ops` routes it to,
    and a case routed to the wgmma kernel through the SIMT kernel too;
    each kernel's launch count must move by one.  Returns the largest
    absolute difference per route."""
    worst = {"wgmma": 0.0, "simt": 0.0}
    for i, (b, s, h, kv, hd, win, ck, dtype, extra) in enumerate(
            FLASH_CHECKS):
        q, k, v = flash_operands(b, s, h, kv, hd, dtype, dev, seed=i)
        kw = dict(window=win, chunk=ck, **extra)
        want = fops.flash_attention_plain(q, k, v, **kw)
        route = fops._route(q.dtype, hd, q.device.type)
        runs = [(route, lambda: fops.flash_attention(q, k, v, **kw))]
        if route == "wgmma":
            runs.append(("simt", lambda: fops._run(fops._simt, q, k, v,
                                                   **kw)))
        for name, run in runs:
            key = f"flash_attention_{name}"
            before = fkernel.LAUNCHES[key]
            got = run()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = got.dtype == q.dtype and bool(torch.isfinite(got).all()) \
                and err <= FLASH_TOL[dtype] \
                and fkernel.LAUNCHES[key] == before + 1
            print(f"flash {name:>5s} B={b} S={s} H={h}/{kv} hd={hd} "
                  f"window={win} chunk={ck} {dtype} {extra or ''}: max abs "
                  f"err {err:.3g} (tolerance {FLASH_TOL[dtype]:g}) -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{key} disagrees with the plain version ({i})")
            worst[name] = max(worst[name], err)
        del q, k, v, want
    return worst


def zero_counts():
    for counts in (skernel.LAUNCHES, fkernel.LAUNCHES, tfkernel.LAUNCHES):
        for k in counts:
            counts[k] = 0


def all_counts():
    return {**skernel.LAUNCHES, **fkernel.LAUNCHES, **tfkernel.LAUNCHES}


def but_threefry(counts):
    """The counts of every kernel but the threefry hash, which every
    simulation entry launches for its draws."""
    return {k: v for k, v in counts.items() if k != "threefry"}


def run_serve_path(card):
    """`serve` of gemma-2b at full width, counts zeroed just before and
    read just after: one wgmma flash launch per layer, no other kernel."""
    args = serve.parse_args(SERVE_ARGS)
    zero_counts()
    out = serve.serve(args)
    torch.cuda.synchronize()
    counts = all_counts()
    n_layers = get_config(args.arch, args.reduced).n_layers
    if counts != dict({k: 0 for k in counts},
                      flash_attention_wgmma=n_layers):
        fail(f"serve main path launched {counts}, expected "
             f"{n_layers} flash_attention_wgmma launches and no other")
    print(f"serve main path: launches {counts}")
    tokens = out["tokens"]
    vocab = get_config(args.arch, args.reduced).padded_vocab
    if tokens.shape != (args.batch, args.gen) or not (
            (tokens >= 0) & (tokens < vocab)).all():
        fail(f"serve returned tokens of shape {tokens.shape} outside "
             f"[0, {vocab})")
    reqs = args.batch * args.gen
    print(f"serve gemma-2b on {card}: batch {args.batch}, prompt "
          f"{args.prompt_len}, gen {args.gen}: prefill {out['prefill_s']:.4f}"
          f" s, decode {out['decode_s']:.4f} s ({out['tok_per_s']:.2f} "
          f"tok/s over {args.batch * (args.gen - 1)} decoded tokens; "
          f"{reqs} tokens in all)")
    print(f"serve tokens: {tokens.tolist()}")
    return args, out, counts


def check_serve_logits(args, tokens):
    """The serving run's prefill logits again, with the kernel and with
    `attention_ref` in its place, in f32 and in the run's bf16 compute;
    the first served token is the bf16 kernel logits' argmax."""
    cfg, params, prompts = serve.setup(args)
    batch = {"tokens": prompts}
    logits = {}
    for compute in ("float32", "bfloat16"):
        run_cfg = dataclasses.replace(cfg, compute_dtype=compute,
                                      use_pallas_attn=True)
        with torch.no_grad():   # the flash route is forward only
            kern = T.forward_train(params, batch, run_cfg)
            with mock.patch.object(fops, "flash_attention",
                                   fops.flash_attention_plain):
                ref = T.forward_train(params, batch, run_cfg)
        torch.cuda.synchronize()
        for x in (kern, ref):
            if x.shape != (*prompts.shape, cfg.padded_vocab) or not bool(
                    torch.isfinite(x).all()):
                fail(f"prefill logits ({compute}) have shape "
                     f"{tuple(x.shape)} or non-finite values")
        logits[compute] = (kern.float(), ref.float())
        del kern, ref
    del params
    k32, r32 = logits["float32"]
    k16, r16 = logits["bfloat16"]
    scale = r32.abs().max().item()
    err32 = (k32 - r32).abs().max().item()
    err16 = (k16 - r16).abs().max().item()
    tol16 = SERVE_BF16_REL_TOL * scale
    print(f"serve prefill logits, float32 compute: kernel vs attention_ref "
          f"max abs err {err32:.4g} (tolerance {SERVE_F32_TOL:g}; max "
          f"|logit| {scale:.4g}) -> "
          f"{'ok' if err32 <= SERVE_F32_TOL else 'FAIL'}")
    print(f"serve prefill logits, bfloat16 compute: kernel vs attention_ref "
          f"max abs err {err16:.4g} (tolerance {tol16:.4g}); each against "
          f"the f32 route: kernel {(k16 - r32).abs().max().item():.4g}, "
          f"attention_ref {(r16 - r32).abs().max().item():.4g} -> "
          f"{'ok' if err16 <= tol16 else 'FAIL'}")
    if err32 > SERVE_F32_TOL or err16 > tol16:
        fail("prefill logits through the kernel disagree with the "
             "attention_ref route")
    first = torch.argmax(k16[:, -1], dim=-1).cpu().numpy()
    if not (first == tokens[:, 0]).all():
        fail("the first served token is not the prefill logits' argmax")
    del logits, k32, r32, k16, r16
    torch.cuda.empty_cache()


def device_ms(event) -> float:
    """An averaged profiler event's own device time, in ms."""
    return event.self_device_time_total / 1e3


def profile_serve(args, prefill_s, card):
    """Where the serving time goes: the prefill's forward pass alone (the
    rest of the prefill is the prompt's replay through the decode path),
    one decode step, and a torch.profiler trace of three decode steps:
    the device's busy share and the kernels that take most of it."""
    cfg, params, prompts = serve.setup(args)
    b, s = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        T.forward_train(params, {"tokens": prompts},
                        dataclasses.replace(cfg, use_pallas_attn=True))
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    caches = T.init_caches(cfg, b, s + args.gen, prompts.device)
    tok = prompts[:, :1]
    T.decode_step(params, caches, tok, 0, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T.decode_step(params, caches, tok, 1, cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            T.decode_step(params, caches, tok, 2 + i, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels' own entries: an operator's entry repeats the device
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(device_ms(e) for e in events)
    top = sorted(events, key=device_ms, reverse=True)[:6]
    print(f"serve breakdown on {card}: prefill {prefill_s:.4f} s = forward "
          f"{fwd_s:.4f} s + replay of {s} prompt tokens "
          f"{prefill_s - fwd_s:.4f} s ({(prefill_s - fwd_s) / s * 1e3:.2f} "
          f"ms/token); one decode step {step_s * 1e3:.2f} ms")
    if busy_ms == 0.0:
        print("  profiler: no device time in the trace (busy share not "
              "measured)")
    else:
        print(f"  profiler, 3 decode steps: wall {wall_ms:.2f} ms, device "
              f"busy {busy_ms:.2f} ms (busy share {busy_ms / wall_ms:.3f})")
        for e in top:
            print(f"    {device_ms(e):9.3f} ms  {e.count:5d} x  {e.key[:90]}")
    del params, caches
    torch.cuda.empty_cache()


def mask_pairs(s, window=None, chunk=None) -> int:
    """The (row, col) pairs a causal mask keeps over S rows, within
    ``window`` keys of the row and inside its ``chunk``."""
    rows = np.arange(s, dtype=np.int64)
    first = np.zeros(s, dtype=np.int64)
    if window is not None:
        first = np.maximum(first, rows - window + 1)
    if chunk is not None:
        first = np.maximum(first, rows // chunk * chunk)
    return int((rows - first + 1).sum())


def flash_bound(b, s, h, kv, hd, elem_bytes=2, window=None, chunk=None):
    """Least time of one causal call: q and o, k and v once each over
    HBM; the two products over the (row, col) pairs the mask keeps
    (`mask_pairs`), 2 FLOPs per multiply-add, at the bf16 tensor-core
    peak."""
    bytes_moved = elem_bytes * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    pairs = mask_pairs(s, window, chunk)
    flops = 2 * 2 * b * h * pairs * hd
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", bytes_moved,
            flops)


def time_flash(dev, card):
    """Both flash kernels (the SIMT one through its own wrapper), the plain
    version and SDPA by CUDA events at the FLASH_TIMED shapes, in turns
    and in one run; each timed back to back (`timed_ms`, the method of the
    earlier flash timings) and with the host held off the clock
    (`queued_ms`).  Returns the serving shape's numbers per kernel,
    queued."""
    h, kv, hd = 8, 1, 256
    first = None
    for b, s in FLASH_TIMED:
        q, k, v = flash_operands(b, s, h, kv, hd, "bfloat16", dev, seed=s)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls = {
            "wgmma": lambda: fops.flash_attention(q, k, v),
            "simt": lambda: fops._run(fops._simt, q, k, v),
            "plain": lambda: fops.flash_attention_plain(q, k, v),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)}
        back = {n: timed_ms(fn) for n, fn in calls.items()}
        queued, held = {}, []
        for n, fn in calls.items():
            queued[n] = queued_ms(fn)
            if HELD[-1]:
                held.append(n)
        lib_err = (calls["sdpa"]().transpose(1, 2).float()
                   - calls["wgmma"]().float()).abs().max().item()
        bound_ms, bound_by, nbytes, flops = flash_bound(b, s, h, kv, hd)
        print(f"timing flash_attention B={b} S={s} H={h}/{kv} hd={hd} bf16 "
              f"causal on {card}, ms per call queued (back to back):")
        print("  " + "; ".join(f"{n} {queued[n]:.4f} ({back[n]:.4f})"
                               for n in calls)
              + f"; sdpa vs wgmma max abs {lib_err:.3g}; bound "
              f"{bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, {flops} FLOP)"
              f"; wgmma {queued['simt'] / queued['wgmma']:.1f}x faster than "
              f"simt, {queued['wgmma'] / queued['sdpa']:.2f}x sdpa's time, "
              f"{flops / queued['wgmma'] / 1e9:.1f} TFLOP/s"
              + (f"; host-held: {', '.join(held)}" if held else ""))
        if first is None:
            first = {n: dict(ms=queued[n], plain_ms=queued["plain"],
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=queued["sdpa"])
                     for n in ("wgmma", "simt")}
        del q, k, v, qt, kt, vt, calls
    return first


# -- the MoE slice: flash at the MoE heads, full-width serves, training ------

# (label, B, S, H, KV, hd, window, chunk, is_global): llama4-scout's heads
# (GQA 40/8, chunk 8,192, every 4th layer global) and mixtral's (GQA 48/8,
# window 4,096), bf16, at sequences past the chunk and the window
MOE_FLASH = (
    ("llama4 chunked", 1, 16384, 40, 8, 128, None, 8192, False),
    ("llama4 global", 1, 16384, 40, 8, 128, None, 8192, True),
    ("mixtral window", 1, 8192, 48, 8, 128, 4096, None, False),
)
# the same heads at the shapes the MoE serves' prefills give the kernel
# (B 4, S 512; the chunk and the window reach past S there), checked only
MOE_SERVE_FLASH = (
    ("llama4 serve chunked", 4, 512, 40, 8, 128, None, 8192, False),
    ("llama4 serve global", 4, 512, 40, 8, 128, None, 8192, True),
    ("mixtral serve window", 4, 512, 48, 8, 128, 4096, None, False),
)
# (arch, layers kept): full width, the depth cut; llama4's 4 layers are
# one whole group (layers 0-2 chunked-local with RoPE, layer 3 global NoPE)
MOE_SERVES = (("llama4-scout-17b-a16e", 4), ("mixtral-8x22b", 2))
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 512, 16
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "mixtral-8x22b", 1


def sdpa_yardstick(q, k, v, window, chunk, is_global):
    """(label, call, to_bshd) of one PyTorch call that computes the same
    function, which the port never calls: causal SDPA with ``enable_gqa``
    on a causal case, and on a chunked one over the (B * S / chunk, chunk)
    view, where each chunk is causal on its own.  SDPA has no form for a
    window: there it is the memory-efficient backend with an explicit
    (S, S) boolean mask and k, v repeated to every query head, which
    skips no tile.  ``to_bshd`` puts the call's output in (B, S, H, hd)
    outside the timed call."""
    b, s, h, hd = q.shape
    if window is not None and not is_global:
        g = h // k.shape[2]
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        mask = (cols <= rows) & (rows - cols < window)
        if chunk is not None:
            mask &= rows // chunk == cols // chunk
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2)
                  for x in (k, v))

        def masked():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

        return ("sdpa efficient, boolean mask", masked,
                lambda o: o.transpose(1, 2))
    n = 1 if is_global or chunk is None else s // chunk
    if s % n:
        raise ValueError(f"S={s} is no whole number of chunks of {chunk}")
    qt, kt, vt = (x.reshape(b * n, s // n, x.shape[2], hd).transpose(1, 2)
                  .contiguous() for x in (q, k, v))

    def causal():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    return ("sdpa causal gqa" + (f" over {n} chunks" if n > 1 else ""),
            causal, lambda o: o.transpose(1, 2).reshape(b, s, h, hd))


def plain_by_kv_head(q, k, v, **kw):
    """The plain version one kv head at a time (its (B, KV, G, S, S)
    float32 scores would not fit the card at S = 16,384): heads are
    independent, so the concatenation is the plain version's output."""
    g = q.shape[2] // k.shape[2]
    return torch.cat([fops.flash_attention_plain(
        q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1],
        **kw) for j in range(k.shape[2])], dim=2)


def check_wgmma_case(case, dev, seed, plain):
    """One MOE_FLASH / MOE_SERVE_FLASH case through `fops.flash_attention`
    against ``plain`` on the same inputs: the route must be wgmma with one
    launch, the output finite and within FLASH_TOL.  Returns (q, k, v, the
    kernel's output, its max abs error)."""
    label, b, s, h, kv, hd, win, ck, glob = case
    q, k, v = flash_operands(b, s, h, kv, hd, "bfloat16", dev, seed=seed)
    kw = dict(window=win, chunk=ck, is_global=glob)
    route = fops._route(q.dtype, hd, q.device.type)
    before = fkernel.LAUNCHES["flash_attention_wgmma"]
    got = fops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    launched = fkernel.LAUNCHES["flash_attention_wgmma"] - before
    err = (got.float() - plain(q, k, v, **kw).float()).abs().max().item()
    ok = route == "wgmma" and launched == 1 and got.dtype == q.dtype \
        and bool(torch.isfinite(got).all()) and err <= FLASH_TOL["bfloat16"]
    print(f"flash wgmma {label} B={b} S={s} H={h}/{kv} hd={hd} "
          f"window={win} chunk={ck} is_global={glob} bf16: route {route}, "
          f"{launched} launch, max abs err {err:.3g} against the plain "
          f"version (tolerance {FLASH_TOL['bfloat16']:g}) -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the wgmma flash kernel at {label}'s heads disagrees with "
             "the plain version")
    return q, k, v, got, err


def check_moe_flash(dev, card):
    """(a): the wgmma kernel at the MoE configurations' heads against the
    plain version on the card: at the serves' prefill shapes
    (MOE_SERVE_FLASH), then at sequences past the chunk and the window
    (MOE_FLASH, the plain version by `plain_by_kv_head`), those timed
    queued beside the plain version and the `sdpa_yardstick` call.
    Returns (largest error, one row per case for the kernels line)."""
    worst, rows = 0.0, []
    for i, case in enumerate(MOE_SERVE_FLASH):
        worst = max(worst, check_wgmma_case(case, dev, 510 + i,
                                            fops.flash_attention_plain)[4])
        torch.cuda.empty_cache()
    for i, case in enumerate(MOE_FLASH):
        label, b, s, h, kv, hd, win, ck, glob = case
        q, k, v, got, err = check_wgmma_case(case, dev, 500 + i,
                                             plain_by_kv_head)
        worst = max(worst, err)
        kw = dict(window=win, chunk=ck, is_global=glob)
        torch.cuda.empty_cache()
        lib_label, lib, to_bshd = sdpa_yardstick(q, k, v, win, ck, glob)
        lib_err = (to_bshd(lib()).float() - got.float()).abs().max().item()
        first = len(HELD)
        ms = queued_ms(lambda: fops.flash_attention(q, k, v, **kw))
        lib_ms = queued_ms(lib)
        plain_ms = once_ms(lambda: plain_by_kv_head(q, k, v, **kw))
        held = any(HELD[first:])
        b_win, b_ck = (None, None) if glob else (win, ck)
        bound_ms, bound_by, nbytes, flops = flash_bound(
            b, s, h, kv, hd, window=b_win, chunk=b_ck)
        print(f"  timing on {card}, queued: wgmma {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms (one call, by kv head), {lib_label} "
              f"{lib_ms:.4f} ms (vs wgmma max abs {lib_err:.3g}); bound "
              f"{bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, {flops} FLOP "
              f"over {mask_pairs(s, b_win, b_ck)} kept pairs); wgmma "
              f"{ms / lib_ms:.2f}x {lib_label}'s time, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of its "
              "bound" + ("; host-held" if held else ""))
        rows.append(dict(case=label, s=s, heads=f"{h}/{kv}", hd=hd,
                         window=win, chunk=ck, is_global=glob,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library=lib_label, library_ms=lib_ms))
        del q, k, v, got, lib, to_bshd
        torch.cuda.empty_cache()
    return worst, rows


def moe_serve_setup(arch, n_layers):
    """(cfg, params, prompts) of a full-width serve cut to ``n_layers``:
    random weights from seed 0 drawn on the card, prompts from the serve
    module's own stream, as `serve.setup` makes them."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    prompts = torch.randint(
        1, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(
            serve.PROMPT_SEED))
    return cfg, params, prompts


def moe_half_ms(cfg, params, prompts):
    """ms of the MoE half of layer 0 (norm, router, dispatch, experts,
    combine, residual) by CUDA events, on bf16 activations of the
    prefill's B * S tokens and of a decode step's B tokens."""
    block = params.blocks[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, s in (("prefill", prompts.shape[1]), ("decode", 1)):
        x = torch.randn((prompts.shape[0], s, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.cdtype)
        with torch.no_grad():
            out[name] = timed_ms(lambda: T._apply_mlp_or_moe(block, x, cfg),
                                 reps=10)
    return out


def run_moe_serve(arch, n_layers, card):
    """(b)/(c): `serve.generate` of ``arch`` at full width cut to
    ``n_layers``, batch 4, prompt 512, 16 tokens, with the launch counts
    zeroed just before and read just after: one wgmma flash launch per
    layer in the prefill and no other kernel of the port.  Then a decode
    step's kernels and busy share by torch.profiler, and the MoE half's
    ms at the prefill and at a decode step."""
    torch.cuda.reset_peak_memory_stats()
    (cfg, params, prompts), init_s = synced_s(
        lambda: moe_serve_setup(arch, n_layers))
    zero_counts()
    tokens, prefill_s, decode_s = serve.generate(params, prompts, cfg,
                                                 MOE_GEN)
    torch.cuda.synchronize()
    counts = all_counts()
    if counts != dict({k: 0 for k in counts},
                      flash_attention_wgmma=n_layers):
        fail(f"{arch} serve launched {counts}, expected {n_layers} "
             "flash_attention_wgmma launches and no other")
    peak = torch.cuda.max_memory_allocated()
    gen = tokens.cpu().numpy()
    if gen.shape != (MOE_BATCH, MOE_GEN) or not (
            (gen >= 0) & (gen < cfg.padded_vocab)).all():
        fail(f"{arch} serve returned tokens of shape {gen.shape} outside "
             f"[0, {cfg.padded_vocab})")
    tok_s = MOE_BATCH * (MOE_GEN - 1) / decode_s
    c_prefill = MOE.capacity(cfg.moe, MOE_BATCH * MOE_PROMPT)
    print(f"serve {arch} cut to {n_layers} layers on {card}: "
          f"{cfg.param_count()} parameters ({cfg.active_param_count()} "
          f"active a token; {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k}), f32 weights drawn in {init_s:.3f} s; batch "
          f"{MOE_BATCH}, prompt {MOE_PROMPT}, gen {MOE_GEN}: prefill "
          f"{prefill_s:.4f} s, decode {decode_s:.4f} s ({tok_s:.2f} tok/s "
          f"over {MOE_BATCH * (MOE_GEN - 1)} decoded tokens); peak memory "
          f"{peak} bytes ({peak / 1e9:.3f} GB); launches {counts}")
    print(f"  tokens: {gen.tolist()}")

    caches = T.init_caches(cfg, MOE_BATCH, MOE_PROMPT + MOE_GEN)
    tok = prompts[:, :1]
    T.decode_step(params, caches, tok, 0, cfg)
    (_, _), step_s = synced_s(lambda: T.decode_step(params, caches, tok, 1,
                                                    cfg))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_s = synced_s(lambda: T.decode_step(params, caches, tok, 2,
                                                   cfg))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in events)
    busy_ms = sum(device_ms(e) for e in events)
    half = moe_half_ms(cfg, params, prompts)
    share = n_layers * half["decode"] / (step_s * 1e3)
    print(f"  one decode step {step_s * 1e3:.3f} ms; profiled step: "
          f"{n_kernels} kernels, device busy {busy_ms:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (wall_s * 1e3):.4f})")
    for e in sorted(events, key=device_ms, reverse=True)[:5]:
        print(f"    {device_ms(e):9.3f} ms  {e.count:5d} x  {e.key[:90]}")
    print(f"  MoE half of a layer: {half['prefill']:.4f} ms at the prefill "
          f"({MOE_BATCH * MOE_PROMPT} tokens, capacity {c_prefill}), "
          f"{half['decode']:.4f} ms at a decode step ({MOE_BATCH} tokens, "
          f"capacity {MOE.capacity(cfg.moe, MOE_BATCH)}); {n_layers} layers"
          f" of it are {share:.4f} of the decode step")
    del caches
    return cfg, params, prompts, gen, counts


def held_flash(checked):
    """`fops.flash_attention`, each call also through the plain version on
    the same q, k, v and held to FLASH_TOL, its (route, error) appended to
    ``checked``: the serve's own activations through the kernel, the
    wgmma one in bf16 compute and the SIMT one in float32."""
    kernel = fops.flash_attention

    def call(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        dtype = str(q.dtype).removeprefix("torch.")
        err = (out.float() - fops.flash_attention_plain(q, k, v, **kw)
               .float()).abs().max().item()
        checked.append((fops._route(q.dtype, q.shape[-1], q.device.type),
                        err))
        if not err <= FLASH_TOL[dtype]:
            fail(f"flash attention in the prefill ({dtype}, "
                 f"{tuple(q.shape)}, {kw}) is {err:.3g} from its plain "
                 "version")
        return out

    return call


def forward_with_experts(params, batch, cfg, plain):
    """(logits as float32, aux, every MoE layer's expert indices, the
    flash calls' (route, error)) of the prefill's forward, with the flash
    route's kernel, each call held to its plain version (`held_flash`),
    or, ``plain``, the plain version in its place."""
    chosen, checked = [], []
    route = MOE.route

    def recording(p, xt, c):
        r = route(p, xt, c)
        chosen.append(r.gate_idx)
        return r

    flash = fops.flash_attention_plain if plain else held_flash(checked)
    with torch.no_grad(), mock.patch.object(MOE, "route", recording), \
            mock.patch.object(fops, "flash_attention", flash):
        logits, aux = T.forward_train_aux(params, batch, cfg)
    torch.cuda.synchronize()
    if logits.shape != (*batch["tokens"].shape, cfg.padded_vocab) or not \
            bool(torch.isfinite(logits).all()):
        fail(f"{cfg.name} prefill logits ({cfg.compute_dtype}) have shape "
             f"{tuple(logits.shape)} or non-finite values")
    return logits.float(), aux, chosen, checked


def check_moe_logits(cfg, params, prompts, tokens):
    """(d): the serve's prefill logits again through the kernel and with
    `attention_ref` in its place.  float32 compute: every MoE layer's
    experts equal on both routes and the logits within SERVE_F32_TOL.
    bfloat16 compute (the serve's): the expert choices that differ are
    counted; with none, the logits are held to SERVE_BF16_REL_TOL of the
    largest float32 logit, else the difference is printed.  The first
    served token is the bf16 kernel logits' argmax; then the bf16
    prefill's dropped share."""
    batch = {"tokens": prompts}
    runs = {}
    for compute in ("float32", "bfloat16"):
        run_cfg = dataclasses.replace(cfg, compute_dtype=compute,
                                      use_pallas_attn=True)
        runs[compute] = [forward_with_experts(params, batch, run_cfg, plain)
                         for plain in (False, True)]
    (k32, _, ki32, c32), (r32, _, ri32, _) = runs["float32"]
    (k16, aux16, ki16, c16), (r16, _, ri16, _) = runs["bfloat16"]
    for compute, checked, want in (("float32", c32, "simt"),
                                   ("bfloat16", c16, "wgmma")):
        routes = sorted({r for r, _ in checked})
        print(f"  prefill flash calls, {compute} compute: {len(checked)} "
              f"through {routes}, each against the plain version on its "
              f"inputs, max abs err {max(e for _, e in checked):.3g} "
              f"(tolerance {FLASH_TOL[compute]:g})")
        if routes != [want] or len(checked) != cfg.n_layers:
            fail(f"{cfg.name}'s {compute} prefill ran flash attention "
                 f"{len(checked)} times through {routes}, expected "
                 f"{cfg.n_layers} through {want}")
    flips = lambda xs, ys: [int((a != b).sum()) for a, b in zip(xs, ys)]
    flips32 = sum(flips(ki32, ri32))
    by_layer16 = flips(ki16, ri16)
    flips16 = sum(by_layer16)
    n_choices = sum(a.numel() for a in ki16)
    scale = r32.abs().max().item()
    err32 = (k32 - r32).abs().max().item()
    err16 = (k16 - r16).abs().max().item()
    tol16 = SERVE_BF16_REL_TOL * scale
    ok32 = flips32 == 0 and err32 <= SERVE_F32_TOL and len(ki32) == \
        len(ri32) == cfg.n_layers
    print(f"  prefill logits, float32 compute: kernel vs attention_ref max "
          f"abs err {err32:.4g} (tolerance {SERVE_F32_TOL:g}; max |logit| "
          f"{scale:.4g}); expert choices differing {flips32} of "
          f"{sum(a.numel() for a in ki32)} over {len(ki32)} MoE layers -> "
          f"{'ok' if ok32 else 'FAIL'}")
    note = (f"-> {'ok' if err16 <= tol16 else 'FAIL'}" if flips16 == 0 else
            "-> not held: a flipped expert moves a token's output by O(1)")
    print(f"  prefill logits, bfloat16 compute: expert choices differing "
          f"{flips16} of {n_choices} (by layer {by_layer16}; against the f32"
          f" kernel route's: kernel {sum(flips(ki16, ki32))}, attention_ref "
          f"{sum(flips(ri16, ki32))}); kernel vs attention_ref max abs err "
          f"{err16:.4g} (tolerance {tol16:.4g} when none differ); each "
          f"against the f32 route: kernel {(k16 - r32).abs().max().item():.4g}"
          f", attention_ref {(r16 - r32).abs().max().item():.4g} {note}")
    if not ok32 or (flips16 == 0 and err16 > tol16):
        fail(f"{cfg.name} prefill logits through the kernel disagree with "
             "the attention_ref route")
    first = torch.argmax(k16[:, -1], dim=-1).cpu().numpy()
    if not (first == tokens[:, 0]).all():
        fail(f"{cfg.name}: the first served token is not the prefill "
             "logits' argmax")
    dropped = float(aux16.dropped) / cfg.n_layers
    c = MOE.capacity(cfg.moe, prompts.numel())
    print(f"  prefill dropped share (bf16, the serve's): {dropped:.6f} of "
          f"the {prompts.numel()} tokens x top-{cfg.moe.top_k} pairs, "
          f"capacity {c} a layer, mean over {cfg.n_layers} layers")


def run_moe_train(card):
    """(e): the reduced mixtral and llama4 in float32, 3 steps on the card
    against the CPU; mixtral-8x22b at full width cut to 1 layer, 6 steps
    on one repeated batch 4 x 512 (`run_train_full`)."""
    for arch in (MOE_TRAIN_ARCH, MOE_SERVES[0][0]):
        run_train_parity(card, arch, label="moe (e)")
    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    run_train_full(card, cfg, label="moe (e)")


def run_moe_path(dev, card):
    """The MoE phase, (a)-(e).  Returns (the flash rows' largest error,
    their rows, each serve's wgmma launches)."""
    t0 = time.perf_counter()
    err, rows = check_moe_flash(dev, card)
    launches = {}
    for arch, n_layers in MOE_SERVES:
        cfg, params, prompts, tokens, counts = run_moe_serve(
            arch, n_layers, card)
        check_moe_logits(cfg, params, prompts, tokens)
        launches[arch] = counts["flash_attention_wgmma"]
        del params, prompts
        torch.cuda.empty_cache()
    zero_counts()
    run_moe_train(card)
    counts = all_counts()
    if any(counts.values()):
        fail(f"the MoE training launched {counts}")
    print(f"MoE training: launches {counts}")
    print(f"MoE phase: {time.perf_counter() - t0:.1f} s")
    return err, rows, launches


# -- the state-space and recurrent blocks (models/ssm.py) ----------------------

# (arch, layers kept: None is full depth); jamba's 8 layers are one whole
# group: mamba at 0-3 and 5-7, attention at 4, MoE on the odd layers
SSM_SERVES = (("xlstm-1.3b", None), ("jamba-v0.1-52b", 8))
SSM_BATCH, SSM_PROMPT, SSM_GEN = MOE_BATCH, MOE_PROMPT, MOE_GEN
# (arch, ssm.chunk replaced by, or None): the reduced configs card vs CPU;
# chunk 8 sends xlstm's forward_train through the chunkwise mLSTM at S 24
SSM_PARITY = (("jamba-v0.1-52b", None), ("xlstm-1.3b", None),
              ("xlstm-1.3b", 8))
SSM_PARITY_B, SSM_PARITY_S, SSM_DECODE_STEPS = 2, 24, 4
SSM_TOL = 1e-4           # of the largest value, as tests/test_torch_ssm.py
# (arch, seq, steps) of the reduced train steps card against CPU, the
# grad norm held to SSM_GNORM_RTOL: jamba at seq 64 (its mamba scans loop
# over time: 512 steps took 36.7 s of the card's host); xlstm at seq 512,
# where its reduced chunk (128) sends the mLSTM through the chunkwise
# route as the full size trains, one step: its later steps drift apart
# between any two summation orders (see
# tests/test_torch_ssm.py::test_train_step_matches_jax)
SSM_TRAIN = (("jamba-v0.1-52b", 64, TRAIN_PARITY_STEPS),
             ("xlstm-1.3b", TRAIN_SEQ, 1))
# Adam's normalized update turns rounding-level differences in gradients
# that nearly cancel into parameter differences of a fraction of lr:
# jamba's third step at seq 64 gave grad norms 1.44e-5 apart on the card
# and the CPU (its first two 1.9e-7, 7.3e-7), xlstm's first 3.51e-5.  The
# card's own jamba run moves its third grad norm by 1.58e-5 when the
# parameters move by 1e-7 relative (first two 4.8e-7, 5.5e-7;
# `ssm_gnorm_move`, NVIDIA H100 80GB HBM3 at 700 W): the card/CPU gap lies
# inside what a rounding-level change of the inputs does
SSM_GNORM_RTOL = 1e-4
MLSTM_FULL = dict(b=1, s=512, h=4, hd=1024, chunk=128)


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_card_room(label, nbytes) -> None:
    """Print the card's free and total memory; fail unless ``nbytes`` of
    weights and 15% beside them fit."""
    free, total = torch.cuda.mem_get_info()
    print(f"{label}: {nbytes} bytes ({nbytes / 1e9:.3f} GB) of f32 weights;"
          f" the card has {free / 1e9:.3f} GB free of {total / 1e9:.3f} GB")
    if free < 1.15 * nbytes:
        fail(f"{label} needs {1.15 * nbytes / 1e9:.1f} GB of the card, "
             f"{free / 1e9:.1f} GB free")


def run_ssm_serve(arch, n_layers, card):
    """(a)/(b): `serve.generate` of ``arch`` at full width (cut to
    ``n_layers`` where given), batch 4, prompt 512, 16 tokens, counts
    zeroed just before and read just after: one wgmma flash launch per
    attention layer in the prefill, no other kernel of the port.  Then
    the prefill's forward again with each flash call held to its plain
    version (`held_flash`), its last logits' argmax equal to the first
    served token and, with MoE layers, its dropped share; the forward's
    share of the prefill; one decode step by torch.profiler.  Returns
    (the wgmma launches, the held flash calls' largest error)."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_attn = sum(cfg.block_kind(li % cfg.group_size) == "attn"
                 for li in range(cfg.n_layers))
    meta = T.build_lm(None, cfg, torch.device("meta"))
    n_tensor = sum(p.numel() for p in meta.parameters())
    label = f"ssm serve {arch}" + (f" cut to {n_layers} layers"
                                   if n_layers else "")
    check_card_room(label, tensor_bytes(meta.parameters()))
    del meta
    torch.cuda.reset_peak_memory_stats()
    (cfg, params, prompts), init_s = synced_s(
        lambda: moe_serve_setup(arch, cfg.n_layers))
    zero_counts()
    tokens, prefill_s, decode_s = serve.generate(params, prompts, cfg,
                                                 SSM_GEN)
    torch.cuda.synchronize()
    counts = all_counts()
    if counts != dict({k: 0 for k in counts},
                      flash_attention_wgmma=n_attn):
        fail(f"{arch} serve launched {counts}, expected {n_attn} "
             "flash_attention_wgmma launches and no other")
    peak = torch.cuda.max_memory_allocated()
    gen = tokens.cpu().numpy()
    if gen.shape != (SSM_BATCH, SSM_GEN) or not (
            (gen >= 0) & (gen < cfg.padded_vocab)).all():
        fail(f"{arch} serve returned tokens of shape {gen.shape} outside "
             f"[0, {cfg.padded_vocab})")
    tok_s = SSM_BATCH * (SSM_GEN - 1) / decode_s
    caches = T.init_caches(cfg, SSM_BATCH, SSM_PROMPT + SSM_GEN)
    state_bytes = tensor_bytes(t for c in caches for t in c.values())
    print(f"{label} on {card}: {cfg.param_count()} parameters by "
          f"param_count, {n_tensor} in its tensors ({n_tensor * 4} bytes of"
          f" f32), {n_attn} attention layers, drawn in {init_s:.3f} s; batch"
          f" {SSM_BATCH}, prompt {SSM_PROMPT}, gen {SSM_GEN}: prefill "
          f"{prefill_s:.4f} s, decode {decode_s:.4f} s ({tok_s:.2f} tok/s "
          f"over {SSM_BATCH * (SSM_GEN - 1)} decoded tokens); peak memory "
          f"{peak} bytes ({peak / 1e9:.3f} GB); decode state {state_bytes} "
          f"bytes ({state_bytes / 1e9:.3f} GB); launches {counts}")
    print(f"  tokens: {gen.tolist()}")

    checked = []
    run_cfg = dataclasses.replace(cfg, use_pallas_attn=True)
    with torch.no_grad(), mock.patch.object(fops, "flash_attention",
                                            held_flash(checked)):
        (logits, aux), fwd_s = synced_s(lambda: T.forward_train_aux(
            params, {"tokens": prompts}, run_cfg))
    routes = sorted({r for r, _ in checked})
    err = max((e for _, e in checked), default=0.0)
    if len(checked) != n_attn or routes not in ([], ["wgmma"]):
        fail(f"{arch}'s prefill ran flash attention {len(checked)} times "
             f"through {routes}, expected {n_attn} through wgmma")
    if not bool(torch.isfinite(logits).all()) or not (torch.argmax(
            logits[:, -1], dim=-1).cpu().numpy() == gen[:, 0]).all():
        fail(f"{arch}: prefill logits not finite, or the first served "
             "token is not their argmax")
    line = (f"  prefill forward {fwd_s:.4f} s of the prefill's "
            f"{prefill_s:.4f} s (the rest is the decode replay); flash calls"
            f" {len(checked)} through {routes}, each against the plain "
            f"version on its inputs, max abs err {err:.3g} (tolerance "
            f"{FLASH_TOL['bfloat16']:g})")
    if cfg.moe is not None:
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        line += (f"; prefill dropped share {float(aux.dropped) / n_moe:.6f}"
                 f" (capacity {MOE.capacity(cfg.moe, prompts.numel())}, "
                 f"mean over {n_moe} MoE layers)")
    print(line)
    del logits, aux

    tok = prompts[:, :1]
    T.decode_step(params, caches, tok, 0, cfg)
    (_, _), step_s = synced_s(lambda: T.decode_step(params, caches, tok, 1,
                                                    cfg))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_s = synced_s(lambda: T.decode_step(params, caches, tok, 2,
                                                   cfg))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(device_ms(e) for e in events)
    print(f"  one decode step {step_s * 1e3:.3f} ms; profiled step: "
          f"{sum(e.count for e in events)} kernels, device busy "
          f"{busy_ms:.3f} ms of {wall_s * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (wall_s * 1e3):.4f})")
    for e in sorted(events, key=device_ms, reverse=True)[:5]:
        print(f"    {device_ms(e):9.3f} ms  {e.count:5d} x  {e.key[:90]}")
    del params, prompts, caches
    torch.cuda.empty_cache()
    return counts["flash_attention_wgmma"], err


def ssm_parity_cfg(arch, chunk):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    if chunk is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    return cfg


def within(got, want) -> tuple:
    """(max abs diff, the tolerance: SSM_TOL of the largest value, at
    least 1), ``want`` on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float()
    tol = SSM_TOL * max(1.0, want.abs().max().item())
    return (got - want).abs().max().item(), tol


def check_ssm_parity(card):
    """(c): each SSM_PARITY config in float32, random weights drawn on the
    CPU from seed 0 and copied to the card: `forward_train`, every
    `forward_prefill` cache field and the logits of 4 decode steps on the
    card against the CPU, within SSM_TOL of the largest value; then the
    SSM_TRAIN steps card against CPU (`run_train_parity`)."""
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, 512, (SSM_PARITY_B, SSM_PARITY_S)))
    for arch, chunk in SSM_PARITY:
        cfg = ssm_parity_cfg(arch, chunk)
        run, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            params = T.init_lm(torch.Generator().manual_seed(0), cfg,
                               device="cpu").to(dev)
            toks = prompts.to(dev)
            with torch.no_grad():
                train = T.forward_train(params, {"tokens": toks}, cfg)
            logits, caches = T.forward_prefill(
                params, {"tokens": toks},
                dataclasses.replace(cfg, use_pallas_attn=True),
                cache_len=SSM_PARITY_S + SSM_DECODE_STEPS)
            steps, tok = [], torch.argmax(logits[:, -1:], dim=-1)
            for i in range(SSM_DECODE_STEPS):
                lg, caches = T.decode_step(params, caches, tok,
                                           SSM_PARITY_S + i, cfg)
                steps.append(lg)
                tok = torch.argmax(lg, dim=-1)
            run[dev] = (train, logits, caches, torch.cat(steps, dim=1))
            secs[dev] = time.perf_counter() - t0
        (tc, lc, cc, dc), (th, lh, ch, dh) = run["cuda"], run["cpu"]
        checks = [("forward_train", *within(tc, th)),
                  ("prefill logits", *within(lc, lh)),
                  ("decode logits", *within(dc, dh))]
        for li, (a, b) in enumerate(zip(cc, ch)):
            for name in b:
                checks.append((f"layer {li} {name}", *within(a[name],
                                                             b[name])))
        bad = [c for c in checks if not c[1] <= c[2]]
        worst = max(checks, key=lambda c: c[1] / c[2])
        print(f"ssm (c) {cfg.name} (ssm.chunk {cfg.ssm.chunk}) f32 on {card}"
              f" against the CPU: {len(checks)} comparisons (forward_train, "
              f"prefill logits, {SSM_DECODE_STEPS} decode steps' logits, "
              f"{len(cc)} layers' cache fields); worst {worst[0]}: max abs "
              f"diff {worst[1]:.3g} (tolerance {worst[2]:.3g}); card "
              f"{secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s -> "
              f"{'ok' if not bad else 'FAIL'}")
        if bad:
            fail(f"{cfg.name} on the card disagrees with the CPU: {bad[:5]}")
    for arch, seq, steps in SSM_TRAIN:
        _, sec = synced_s(lambda: run_train_parity(
            card, arch, label="ssm (c)", cfg=ssm_parity_cfg(arch, None),
            steps=steps, gnorm_rtol=SSM_GNORM_RTOL, seq=seq))
        print(f"  ({arch} train steps, card and CPU: {sec:.2f} s)")


def ssm_gnorm_move(card, arch="jamba-v0.1-52b", seq=64,
                   steps=TRAIN_PARITY_STEPS):
    """The reduced jamba's SSM_TRAIN steps (f32, seq 64) three times:
    on the card, on the card from its parameters perturbed by 1e-7
    relative (tests/test_torch_ssm.py's seeded perturbation, applied on
    the CPU before the copy) and on the CPU.  Prints each step's grad
    norm, the perturbation's relative move of it on the card and the
    card/CPU gap, beside SSM_GNORM_RTOL.  Returns (moves, gaps)."""
    cfg = ssm_parity_cfg(arch, None)
    step = tsteps.make_train_step(cfg, TRAIN_OPT)
    runs = {}
    for name, dev, moved in (("card", "cuda", False),
                             ("card moved", "cuda", True),
                             ("cpu", "cpu", False)):
        state = tsteps.init_state(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
        if moved:
            with torch.no_grad():
                gen = torch.Generator().manual_seed(0)
                for p in state.params.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
        params = state.params.to(dev)
        state = tsteps.TrainState(params=params, opt=topt.init(params),
                                  step=state.step.to(dev))
        norms = []
        for i in range(steps):
            state, m = step(state, train_batch(cfg, i, dev, seq))
            norms.append(float(m["grad_norm"]))
        runs[name] = norms
    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]
    moves = rel(runs["card moved"], runs["card"])
    gaps = rel(runs["card"], runs["cpu"])
    print(f"ssm (c) {cfg.name} grad norms at seq {seq} on {card}: card "
          f"{runs['card']}, card from the parameters moved by 1e-7 relative "
          f"{runs['card moved']}, CPU {runs['cpu']}")
    print(f"  per step, the perturbation moves the card's grad norm by "
          f"{[f'{x:.3g}' for x in moves]} relative; card against CPU "
          f"{[f'{x:.3g}' for x in gaps]} (SSM_GNORM_RTOL {SSM_GNORM_RTOL:g});"
          f" the step-{steps} gap is "
          f"{'inside' if gaps[-1] <= moves[-1] else 'OUTSIDE'} the move")
    return moves, gaps


def check_mlstm_full(dev, card):
    """(d): `mlstm_chunkwise` against `mlstm_sequential` at xlstm's full
    widths (MLSTM_FULL) in float32 on the card, from the zero state, the
    outputs and the final state within SSM_TOL of their largest values;
    each form's time by CUDA events (one call after a warm-up)."""
    b, s, h, hd, ck = (MLSTM_FULL[k] for k in ("b", "s", "h", "hd",
                                               "chunk"))
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((b, s, h, hd), generator=gen, device=dev)
               for _ in "qkv")
    li = torch.randn((b, s, h), generator=gen, device=dev)
    lf = F.logsigmoid(torch.randn((b, s, h), generator=gen, device=dev) + 3)
    state = SSM.MLSTMState(
        c=torch.zeros((b, h, hd, hd), device=dev),
        n=torch.zeros((b, h, hd), device=dev),
        m=torch.full((b, h), -1e30, device=dev))
    with torch.no_grad():
        (yc, sc), chunk_s = synced_s(lambda: SSM.mlstm_chunkwise(
            q, k, v, li, lf, state, ck))
        (ys, ss), seq_s = synced_s(lambda: SSM.mlstm_sequential(
            q, k, v, li, lf, state))
    rel = [((a - w).abs().max() / w.abs().max()).item()
           for a, w in zip((yc, *sc), (ys, *ss))]
    ok = all(r <= SSM_TOL for r in rel) and bool(torch.isfinite(yc).all())
    print(f"ssm (d) mLSTM at xlstm's full widths (B {b}, S {s}, H {h}, hd "
          f"{hd}, chunk {ck}, f32) on {card}: chunkwise against sequential,"
          f" max abs diff over the largest value: y {rel[0]:.3g}, c "
          f"{rel[1]:.3g}, n {rel[2]:.3g}, m {rel[3]:.3g} (tolerance "
          f"{SSM_TOL:g}); chunkwise {chunk_s * 1e3:.2f} ms, sequential "
          f"{seq_s * 1e3:.2f} ms (one call each, host clock around "
          f"synchronizes) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the chunkwise mLSTM disagrees with the sequential one at "
             "xlstm's full widths")


def run_ssm_path(dev, card):
    """The SSM phase, (a)-(d).  Returns (each serve's wgmma launches, the
    held flash calls' largest error)."""
    t0 = time.perf_counter()
    launches, err, part_s = {}, 0.0, []
    for arch, n_layers in SSM_SERVES:
        (launches[arch], e), sec = synced_s(
            lambda: run_ssm_serve(arch, n_layers, card))
        err = max(err, e)
        part_s.append(sec)
    zero_counts()
    part_s.append(synced_s(lambda: check_ssm_parity(card))[1])
    ssm_gnorm_move(card)
    part_s.append(synced_s(lambda: check_mlstm_full(dev, card))[1])
    print(f"SSM phase: {time.perf_counter() - t0:.1f} s (a) {part_s[0]:.1f}"
          f" s, (b) {part_s[1]:.1f} s, (c) {part_s[2]:.1f} s, (d) "
          f"{part_s[3]:.1f} s")
    return launches, err

# -- the encoder-decoder phase (models/encdec.py): whisper-tiny ---------------

ENCDEC_ARCH = "whisper-tiny"
# whisper's longest prompt (half its 448-token context), then 32 tokens
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_GEN = 16, 224, 32
ENCDEC_ARGS = ["--arch", ENCDEC_ARCH, "--batch", str(ENCDEC_BATCH),
               "--prompt-len", str(ENCDEC_PROMPT), "--gen", str(ENCDEC_GEN),
               "--seed", "0"]
# (B, S, H, KV, hd) of the decoder's causal self attention, bf16: the
# serve's prefill (a ragged last tile at S = 224) and whisper's context
ENCDEC_FLASH = ((ENCDEC_BATCH, ENCDEC_PROMPT, 6, 6, 64),
                (ENCDEC_BATCH, 448, 6, 6, 64))
# the reduced twin's card-against-CPU steps: batch 4 x 224
ENCDEC_PARITY_BATCH = 4


def encdec_batch(cfg, step, device, seq=ENCDEC_PROMPT,
                 batch=ENCDEC_PARITY_BATCH):
    """An encoder-decoder's train batch {frames, tokens, targets}: the
    tokens of `SyntheticTokens` and standard normal frames drawn on the
    CPU from ``100 + step`` (so the card and the CPU see the same)."""
    out = tdata.SyntheticTokens(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq,
        global_batch=batch)).batch_at(step, device)
    gen = torch.Generator().manual_seed(100 + step)
    out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                generator=gen).to(device)
    return out


def encdec_replay(params, enc_out, prompts, cfg, cache_len):
    """The prefill's ring caches: `encdec.init_caches`, then the prompt
    replayed one token at a time, as `encdec.forward_prefill` fills them."""
    caches = E.init_caches(params, enc_out, cfg, prompts.shape[0], cache_len)
    for t in range(prompts.shape[1]):
        E._decode_layers(params, caches, prompts[:, t:t + 1], t, cfg)
    return caches


def check_route_logits(label, cfg, forward, shape, tokens):
    """A serve's prefill logits again, ``forward(run_cfg)``, through the
    kernel and with `attention_ref` in its place
    (`fops.flash_attention_plain`), in f32 compute (the SIMT kernel) and
    in the serve's bf16 (wgmma), held to SERVE_F32_TOL and
    SERVE_BF16_REL_TOL of the largest f32 logit; the first served token
    is the bf16 kernel logits' argmax.  ``shape``: the prompts'."""
    logits = {}
    for compute in ("float32", "bfloat16"):
        run_cfg = dataclasses.replace(cfg, compute_dtype=compute,
                                      use_pallas_attn=True)
        with torch.no_grad():
            kern = forward(run_cfg)
            with mock.patch.object(fops, "flash_attention",
                                   fops.flash_attention_plain):
                ref = forward(run_cfg)
        for x in (kern, ref):
            if x.shape != (*shape, cfg.padded_vocab) or not bool(
                    torch.isfinite(x).all()):
                fail(f"{label} prefill logits ({compute}) have shape "
                     f"{tuple(x.shape)} or non-finite values")
        logits[compute] = (kern.float(), ref.float())
        del kern, ref
    (k32, r32), (k16, r16) = logits["float32"], logits["bfloat16"]
    scale = r32.abs().max().item()
    err32 = (k32 - r32).abs().max().item()
    err16 = (k16 - r16).abs().max().item()
    tol16 = SERVE_BF16_REL_TOL * scale
    ok = err32 <= SERVE_F32_TOL and err16 <= tol16
    print(f"  prefill logits, kernel against attention_ref: f32 compute max "
          f"abs err {err32:.4g} (tolerance {SERVE_F32_TOL:g}), bf16 "
          f"{err16:.4g} (tolerance {tol16:.4g} = {SERVE_BF16_REL_TOL:g} of "
          f"the largest f32 logit {scale:.4g}); each bf16 route against the "
          f"f32 one: kernel {(k16 - r32).abs().max().item():.4g}, "
          f"attention_ref {(r16 - r32).abs().max().item():.4g} -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}'s prefill logits through the kernel disagree with "
             "the attention_ref route")
    if not (torch.argmax(k16[:, -1], dim=-1).cpu().numpy()
            == tokens[:, 0]).all():
        fail(f"{label}'s first served token is not the prefill logits' "
             "argmax")
    del logits, k32, r32, k16, r16
    torch.cuda.empty_cache()


def run_encdec_serve(card):
    """(a): `serve.serve`'s run of whisper-tiny at full width and depth
    (random f32 weights from seed 0, bf16 compute, the stub frames of
    `serve.stub_frames`), batch 16 x 1,500 frames, prompt 224, 32 tokens,
    through `serve.generate` with the counts zeroed just before and read
    just after: one wgmma launch per decoder layer, no other kernel of the
    port.  Then the prefill's parts on their own (the encoder, the
    decoder's forward with each flash call held to its plain version, the
    replay), the logits against the attention_ref route
    (`check_encdec_logits`) and one decode step by torch.profiler.
    Returns (the launch counts, the held flash calls' largest error)."""
    args = serve.parse_args(ENCDEC_ARGS)
    torch.cuda.reset_peak_memory_stats()
    (cfg, params, prompts), init_s = synced_s(lambda: serve.setup(args))
    frames = serve.stub_frames(cfg, ENCDEC_BATCH, "cuda")
    n_tensor = sum(p.numel() for p in params.parameters())
    zero_counts()
    tokens, prefill_s, decode_s = serve.generate(params, prompts, cfg,
                                                 ENCDEC_GEN, frames)
    torch.cuda.synchronize()
    counts = all_counts()
    if counts != dict({k: 0 for k in counts},
                      flash_attention_wgmma=cfg.n_layers):
        fail(f"whisper serve launched {counts}, expected {cfg.n_layers} "
             "flash_attention_wgmma launches and no other")
    peak = torch.cuda.max_memory_allocated()
    gen = tokens.cpu().numpy()
    if gen.shape != (ENCDEC_BATCH, ENCDEC_GEN) or not (
            (gen >= 0) & (gen < cfg.padded_vocab)).all():
        fail(f"whisper serve returned tokens of shape {gen.shape} outside "
             f"[0, {cfg.padded_vocab})")
    tok_s = ENCDEC_BATCH * (ENCDEC_GEN - 1) / decode_s
    print(f"encdec (a) {cfg.name} serve on {card}: {n_tensor} parameters in "
          f"its tensors ({n_tensor * 4} bytes of f32), drawn in {init_s:.3f} "
          f"s; batch {ENCDEC_BATCH} x {cfg.enc_seq} frames, prompt "
          f"{ENCDEC_PROMPT}, gen {ENCDEC_GEN}: prefill {prefill_s:.4f} s, "
          f"decode {decode_s:.4f} s ({tok_s:.2f} tok/s over "
          f"{ENCDEC_BATCH * (ENCDEC_GEN - 1)} decoded tokens); peak memory "
          f"{peak} bytes ({peak / 1e9:.3f} GB); launches {counts}")
    print(f"  tokens row 0: {gen[0].tolist()}")

    checked = []
    run_cfg = dataclasses.replace(cfg, use_pallas_attn=True)
    with torch.no_grad():
        enc_out, enc_s = synced_s(lambda: E.encode(params, frames, cfg))
        with mock.patch.object(fops, "flash_attention", held_flash(checked)):
            logits, fwd_s = synced_s(lambda: E.decode_forward(
                params, prompts, enc_out, run_cfg))
        caches, replay_s = synced_s(lambda: encdec_replay(
            params, enc_out, prompts, cfg, ENCDEC_PROMPT + ENCDEC_GEN))
    routes = sorted({r for r, _ in checked})
    err = max((e for _, e in checked), default=0.0)
    if len(checked) != cfg.n_layers or routes != ["wgmma"]:
        fail(f"whisper's prefill ran flash attention {len(checked)} times "
             f"through {routes}, expected {cfg.n_layers} through wgmma")
    if not (torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            == gen[:, 0]).all():
        fail("whisper's first served token is not the prefill's argmax")
    print(f"  prefill parts on their own: encoder {enc_s:.4f} s, decoder "
          f"forward {fwd_s:.4f} s, replay {replay_s:.4f} s (of the serve's "
          f"{prefill_s:.4f} s); flash calls {len(checked)} through {routes},"
          f" each against the plain version on its inputs, max abs err "
          f"{err:.3g} (tolerance {FLASH_TOL['bfloat16']:g})")
    del logits
    check_route_logits("whisper", cfg, lambda c: E.decode_forward(
        params, prompts, E.encode(params, frames, c), c), prompts.shape, gen)

    tok = prompts[:, :1]
    pos = ENCDEC_PROMPT
    E.decode_step(params, caches, tok, pos, cfg)
    _, step_s = synced_s(lambda: E.decode_step(params, caches, tok, pos + 1,
                                               cfg))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_s = synced_s(lambda: E.decode_step(params, caches, tok,
                                                   pos + 2, cfg))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(device_ms(e) for e in events)
    print(f"  one decode step {step_s * 1e3:.3f} ms on {card}; profiled "
          f"step: {sum(e.count for e in events)} kernels, device busy "
          f"{busy_ms:.3f} ms of {wall_s * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (wall_s * 1e3):.4f})")
    for e in sorted(events, key=device_ms, reverse=True)[:5]:
        print(f"    {device_ms(e):9.3f} ms  {e.count:5d} x  {e.key[:90]}")
    del params, prompts, frames, caches, enc_out
    torch.cuda.empty_cache()
    return counts, err


def time_encdec_flash(dev, card):
    """(b): the wgmma kernel at whisper's heads (MHA 6/6, hd 64, causal,
    bf16) at ENCDEC_FLASH, each against the plain version
    (`check_wgmma_case`), timed queued (median of `steady_ms`) beside
    the plain version and causal SDPA (`sdpa_yardstick`), with the bound
    (`flash_bound`) and the instance's blocks per SM.  Returns (largest
    error, one row per shape for the kernels line)."""
    smem, blocks = fkernel.wgmma_occupancy(64)
    worst, rows = 0.0, []
    for i, (b, s, h, kv, hd) in enumerate(ENCDEC_FLASH):
        case = (f"whisper S={s}", b, s, h, kv, hd, None, None, False)
        q, k, v, got, err = check_wgmma_case(case, dev, 530 + i,
                                             fops.flash_attention_plain)
        worst = max(worst, err)
        lib_label, lib, to_bshd = sdpa_yardstick(q, k, v, None, None, False)
        lib_err = (to_bshd(lib()).float() - got.float()).abs().max().item()
        q_ms = steady_ms(queued_ms, lambda: fops.flash_attention(q, k, v))
        l_ms = steady_ms(queued_ms, lib)
        plain_ms = timed_ms(lambda: fops.flash_attention_plain(q, k, v),
                            reps=5)
        bound_ms, bound_by, nbytes, flops = flash_bound(b, s, h, kv, hd)
        print(f"  timing on {card}, queued, median of 5 [range]: wgmma "
              f"{q_ms[0]:.5f} [{q_ms[1]:.5f}-{q_ms[2]:.5f}] ms"
              f"{held_note(q_ms)}, {lib_label} {l_ms[0]:.5f} "
              f"[{l_ms[1]:.5f}-{l_ms[2]:.5f}] ms{held_note(l_ms)} (vs wgmma "
              f"max abs {lib_err:.3g}), plain {plain_ms:.4f} ms (back to "
              f"back); bound {bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, "
              f"{flops} FLOP); wgmma {q_ms[0] / l_ms[0]:.2f}x SDPA's time, "
              f"{bound_ms / q_ms[0]:.3f} of its bound; {smem} bytes of shared"
              f" memory a block, {blocks} blocks per SM at hd 64")
        rows.append(dict(case=case[0], b=b, s=s, heads=f"{h}/{kv}", hd=hd,
                         max_abs_err=err, ms=q_ms[0], plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library=lib_label, library_ms=l_ms[0],
                         blocks_per_sm=blocks))
        del q, k, v, got, lib, to_bshd
        torch.cuda.empty_cache()
    return worst, rows


def run_encdec_train(card):
    """(c): `make_train_step` on whisper-tiny at full size (f32 weights,
    bf16 compute, remat "block"), 6 steps on one batch of 16 x 224 tokens
    with its 16 x 1,500 frames, counts zeroed just before and read just
    after (training launches none: the flash route has no backward):
    step time (median of steps 2-6), tokens/s, peak memory, the
    optimizer's share, the loss falling; then the reduced twin in f32, 3
    steps on the card against the CPU (`run_train_parity`)."""
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.reset_peak_memory_stats()
    state = tsteps.init_state(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
    batch = encdec_batch(cfg, 0, "cuda", batch=ENCDEC_BATCH)
    step = tsteps.make_train_step(cfg, TRAIN_OPT)
    losses, secs = [], []
    zero_counts()
    for _ in range(TRAIN_STEPS):
        (state, m), sec = synced_s(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        secs.append(sec)
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"whisper's train steps launched {counts}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        fail(f"whisper training: losses {losses} not finite or not lower "
             "at the last step")
    step_s = float(np.median(secs[1:]))
    tokens = ENCDEC_BATCH * ENCDEC_PROMPT
    names, leaves = zip(*state.params.named_parameters())
    loss, _ = E.lm_loss(state.params, batch, cfg)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    opt_ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        _, opt, _ = topt.update(TRAIN_OPT, grads, state.opt, state.params)
        end.record()
        torch.cuda.synchronize()
        state = state._replace(opt=opt)
        opt_ms.append(start.elapsed_time(end))
    opt_med = float(np.median(opt_ms))
    print(f"encdec (c) {cfg.name} train on {card}: batch {ENCDEC_BATCH} x "
          f"{ENCDEC_PROMPT} tokens with {ENCDEC_BATCH} x {cfg.enc_seq} "
          f"frames, remat {cfg.remat}, {cfg.compute_dtype} compute; losses "
          f"{losses}; step s {secs} (median of steps 2-{TRAIN_STEPS} "
          f"{step_s:.6f} s, {tokens / step_s:.1f} decoder tokens/s); peak "
          f"memory {peak} bytes ({peak / 1e9:.3f} GB); optimizer.update "
          f"alone {opt_med:.4f} ms ({opt_med / (step_s * 1e3):.4f} of the "
          f"median step); launches {counts}")
    del state, grads, batch, loss
    torch.cuda.empty_cache()
    run_train_parity(card, ENCDEC_ARCH, label="encdec (c)",
                     seq=ENCDEC_PROMPT, batch_fn=encdec_batch)


def run_encdec_path(dev, card, with_domain):
    """The encoder-decoder phase: (a) the serve, (b) the wgmma kernel at
    whisper's heads, (c) training, and with ``with_domain`` (d) the
    stream kernel's global-memory instance (`check_global_domain`; the
    whole script runs it beside the other domain checks).  Returns (the
    serve's launch counts, the largest flash error, the (b) rows)."""
    t0 = time.perf_counter()
    (counts, err), a_s = synced_s(lambda: run_encdec_serve(card))
    (err_b, rows), b_s = synced_s(lambda: time_encdec_flash(dev, card))
    _, c_s = synced_s(lambda: run_encdec_train(card))
    d_s = 0.0
    if with_domain:
        _, d_s = synced_s(lambda: check_global_domain(dev, card))
    print(f"encdec phase on {card}: {time.perf_counter() - t0:.1f} s (a) "
          f"{a_s:.1f} s, (b) {b_s:.1f} s, (c) {c_s:.1f} s, (d) {d_s:.1f} s")
    return counts, max(err, err_b), rows


# -- the qwen2 family: qwen2-72b, and qwen2-vl-72b with M-RoPE and patches ----

# (arch, layers kept) of the full-width serves: a qwen2 layer holds
# 877,684,736 parameters (3.51 GB of f32), the embedding and the untied
# head 1,245,708,288 each (4.98 GB); 8 layers are 9.51B (38.0 GB)
QWEN2_SERVES = (("qwen2-72b", 8), ("qwen2-vl-72b", 4))
QWEN2_VL = QWEN2_SERVES[1][0]
QWEN2_BATCH, QWEN2_PROMPT, QWEN2_GEN = MOE_BATCH, MOE_PROMPT, MOE_GEN
# trained cut to 1 layer at batch 4 x 512: 3.37B parameters, p, g, m and
# v 53.9 GB, 64.0 GB at peak on an H100
QWEN2_TRAIN_LAYERS = 1
# the reduced twin card against CPU: batch 2 x 64 (32 patch slots)
QWEN2_PARITY_B, QWEN2_PARITY_S, QWEN2_DECODE_STEPS = 2, 64, 4
# (label, B, S, H, KV, hd) of the wgmma kernel, causal, bf16: qwen2's
# prefill heads (GQA 8) and jamba's (GQA 4, its serve's one attention
# layer)
QWEN2_FLASH = (("qwen2", QWEN2_BATCH, QWEN2_PROMPT, 64, 8, 128),
               ("jamba", QWEN2_BATCH, QWEN2_PROMPT, 32, 8, 128))
# M-RoPE on the card against the CPU, float32: one product a slot for
# the angle in both, then CUDA's sin/cos against the CPU's at angles up
# to ~270 rad (the libraries' range reductions differ by a few ulps of
# the result)
MROPE_CARD_TOL = 1e-5


def vl_inputs(cfg, b, s, device, seed=4):
    """A VLM batch's inputs beside its tokens, shaped and typed as
    `configs.shapes.input_specs` gives them for a (b, s) prefill: the
    patch embeddings (b, min(1024, s // 2), d_model) float32, standard
    normal from ``seed`` on the CPU, and the (3, b, s) int32 M-RoPE
    positions: the patch slots on an h x w grid (temporal 0, height the
    row, width the column), the text after them at one position on all
    three streams past the grid's largest.  The package builds no rope
    index; this is Qwen2-VL's layout of one image, then text."""
    (spec,), _ = shapes.input_specs(
        cfg, shapes.ShapeSpec("serve", "prefill", s, b))
    n_patch = spec["patch_embeds"].shape[1]
    h = next(d for d in range(int(n_patch ** 0.5), 0, -1) if n_patch % d == 0)
    w = n_patch // h
    pos = torch.zeros(spec["positions"].shape, dtype=spec["positions"].dtype)
    pos[1, :, :n_patch] = torch.arange(h).repeat_interleave(w)
    pos[2, :, :n_patch] = torch.arange(w).repeat(h)
    pos[:, :, n_patch:] = torch.arange(s - n_patch) + max(h, w)
    patches = torch.randn(spec["patch_embeds"].shape,
                          dtype=spec["patch_embeds"].dtype,
                          generator=torch.Generator().manual_seed(seed))
    return {"positions": pos.to(device), "patch_embeds": patches.to(device)}


def run_qwen2_serve(arch, n_layers, card):
    """(a)/(b): `serve.generate` of ``arch`` at full width cut to
    ``n_layers`` (random f32 weights from seed 0, bf16 compute; the
    card's free memory checked first), batch 4 x 512 x 16, the VLM with
    `vl_inputs`, counts zeroed just before and read just after: one
    wgmma launch a layer in the prefill, no other kernel of the port.
    Then the prefill's forward again with each flash call held to its
    plain version (`held_flash`), the forward's and the replay's seconds,
    the logits against the attention_ref route (`check_route_logits`) and one
    decode step by torch.profiler.  Returns (the wgmma launches, the held
    calls' largest error, the run's numbers)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    label = f"qwen2 serve {arch} cut to {n_layers} layers"
    meta = T.build_lm(None, cfg, torch.device("meta"))
    n_tensor = sum(p.numel() for p in meta.parameters())
    check_card_room(label, tensor_bytes(meta.parameters()))
    del meta
    torch.cuda.reset_peak_memory_stats()
    (cfg, params, prompts), init_s = synced_s(
        lambda: moe_serve_setup(arch, n_layers))
    extra = vl_inputs(cfg, QWEN2_BATCH, QWEN2_PROMPT, "cuda") \
        if cfg.mrope else {}
    zero_counts()
    tokens, prefill_s, decode_s = serve.generate(params, prompts, cfg,
                                                 QWEN2_GEN, **extra)
    torch.cuda.synchronize()
    counts = all_counts()
    if counts != dict({k: 0 for k in counts},
                      flash_attention_wgmma=n_layers):
        fail(f"{arch} serve launched {counts}, expected {n_layers} "
             "flash_attention_wgmma launches and no other")
    peak = torch.cuda.max_memory_allocated()
    gen = tokens.cpu().numpy()
    if gen.shape != (QWEN2_BATCH, QWEN2_GEN) or not (
            (gen >= 0) & (gen < cfg.padded_vocab)).all():
        fail(f"{arch} serve returned tokens of shape {gen.shape} outside "
             f"[0, {cfg.padded_vocab})")
    tok_s = QWEN2_BATCH * (QWEN2_GEN - 1) / decode_s
    inputs = ", ".join(f"{k} {tuple(v.shape)} {v.dtype}"
                       for k, v in extra.items()) or "tokens alone"
    print(f"{label} on {card}: {n_tensor} parameters in its tensors "
          f"({n_tensor * 4} bytes of f32), drawn in {init_s:.3f} s; batch "
          f"{QWEN2_BATCH}, prompt {QWEN2_PROMPT} ({inputs}), gen "
          f"{QWEN2_GEN}: prefill {prefill_s:.4f} s, decode {decode_s:.4f} s "
          f"({tok_s:.2f} tok/s over {QWEN2_BATCH * (QWEN2_GEN - 1)} decoded "
          f"tokens); peak memory {peak} bytes ({peak / 1e9:.3f} GB); "
          f"launches {counts}")
    print(f"  tokens: {gen.tolist()}")

    batch = dict(tokens=prompts, **extra)
    checked = []
    run_cfg = dataclasses.replace(cfg, use_pallas_attn=True)
    with torch.no_grad(), mock.patch.object(fops, "flash_attention",
                                            held_flash(checked)):
        logits, fwd_s = synced_s(lambda: T.forward_train(params, batch,
                                                         run_cfg))
    routes = sorted({r for r, _ in checked})
    err = max((e for _, e in checked), default=0.0)
    if len(checked) != n_layers or routes != ["wgmma"]:
        fail(f"{arch}'s prefill ran flash attention {len(checked)} times "
             f"through {routes}, expected {n_layers} through wgmma")
    if not (torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            == gen[:, 0]).all():
        fail(f"{arch}: the first served token is not the prefill's argmax")
    print(f"  prefill forward {fwd_s:.4f} s, replay {prefill_s - fwd_s:.4f} s"
          f" ({(prefill_s - fwd_s) / QWEN2_PROMPT * 1e3:.2f} ms a token) of "
          f"the prefill's {prefill_s:.4f} s; flash calls {len(checked)} "
          f"through {routes}, each against the plain version on its inputs,"
          f" max abs err {err:.3g} (tolerance {FLASH_TOL['bfloat16']:g})")
    del logits
    check_route_logits(arch, cfg, lambda c: T.forward_train(params, batch, c),
                       prompts.shape, gen)

    caches = T.init_caches(cfg, QWEN2_BATCH, QWEN2_PROMPT + QWEN2_GEN)
    tok = prompts[:, :1]
    T.decode_step(params, caches, tok, 0, cfg)
    (_, _), step_s = synced_s(lambda: T.decode_step(params, caches, tok, 1,
                                                    cfg))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall_s = synced_s(lambda: T.decode_step(params, caches, tok, 2,
                                                   cfg))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in events)
    busy_ms = sum(device_ms(e) for e in events)
    print(f"  one decode step {step_s * 1e3:.3f} ms; profiled step: "
          f"{n_kernels} kernels, device busy {busy_ms:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (wall_s * 1e3):.4f})")
    for e in sorted(events, key=device_ms, reverse=True)[:5]:
        print(f"    {device_ms(e):9.3f} ms  {e.count:5d} x  {e.key[:90]}")
    del params, prompts, caches, batch, extra
    torch.cuda.empty_cache()
    return counts["flash_attention_wgmma"], err


def check_mrope_card(card):
    """(b): `apply_mrope` at qwen2-vl-72b's full heads (q of the serve's
    prefill: (4, 512, 64, 128), sections (16, 24, 24), theta 1e6) with
    the serve's positions, float32 on the card against the CPU, within
    MROPE_CARD_TOL; bf16 in and out within one bf16 step of the largest
    |q|."""
    cfg = get_config(QWEN2_VL)
    pos = vl_inputs(cfg, QWEN2_BATCH, QWEN2_PROMPT, "cpu")["positions"]
    q = torch.randn((QWEN2_BATCH, QWEN2_PROMPT, cfg.n_heads, cfg.hd),
                    generator=torch.Generator().manual_seed(6))

    def rope(x, p):
        return L.apply_mrope(x, p, cfg.rope_theta, cfg.mrope_sections)

    want = rope(q, pos)
    got = rope(q.cuda(), pos.cuda()).cpu()
    err = (got - want).abs().max().item()
    got16 = rope(q.cuda().bfloat16(), pos.cuda()).float().cpu()
    err16 = (got16 - rope(q.bfloat16(), pos).float()).abs().max().item()
    tol16 = 2 ** -7 * q.abs().max().item()
    ok = err <= MROPE_CARD_TOL and err16 <= tol16
    widths = L.mrope_widths(cfg.hd, cfg.mrope_sections)
    print(f"qwen2 (b) apply_mrope at {tuple(q.shape)}, sections "
          f"{cfg.mrope_sections} (widths {widths}), positions up to "
          f"{int(pos.max())} on {card} against the CPU: f32 max abs diff "
          f"{err:.3g} (tolerance {MROPE_CARD_TOL:g}), bf16 {err16:.3g} "
          f"(tolerance {tol16:.3g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("M-RoPE on the card disagrees with the CPU")


def check_qwen2_parity(card):
    """(b): the reduced qwen2-vl-72b in float32, random weights drawn on
    the CPU from seed 0 and copied to the card, batch 2 x 64 with its
    patches and positions (`vl_inputs`): `forward_train`, the
    `forward_prefill` logits and every cache field, and the logits of 4
    decode steps on the card against the CPU (the plain flash version
    there, the SIMT kernel here), within 1e-4 of the largest value
    (`within`)."""
    cfg = dataclasses.replace(get_config(QWEN2_VL, reduced=True),
                              compute_dtype="float32")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (QWEN2_PARITY_B, QWEN2_PARITY_S)))
    run, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        params = T.init_lm(torch.Generator().manual_seed(0), cfg,
                           device="cpu").to(dev)
        batch = dict(tokens=prompts.to(dev), **vl_inputs(
            cfg, QWEN2_PARITY_B, QWEN2_PARITY_S, dev))
        with torch.no_grad():
            train = T.forward_train(params, batch, cfg)
        logits, caches = T.forward_prefill(
            params, batch, dataclasses.replace(cfg, use_pallas_attn=True),
            cache_len=QWEN2_PARITY_S + QWEN2_DECODE_STEPS)
        steps, tok = [], torch.argmax(logits[:, -1:], dim=-1)
        for i in range(QWEN2_DECODE_STEPS):
            lg, caches = T.decode_step(params, caches, tok,
                                       QWEN2_PARITY_S + i, cfg)
            steps.append(lg)
            tok = torch.argmax(lg, dim=-1)
        run[dev] = (train, logits, caches, torch.cat(steps, dim=1))
        secs[dev] = time.perf_counter() - t0
    (tc, lc, cc, dc), (th, lh, ch, dh) = run["cuda"], run["cpu"]
    checks = [("forward_train", *within(tc, th)),
              ("prefill logits", *within(lc, lh)),
              ("decode logits", *within(dc, dh))]
    for li, (a, b) in enumerate(zip(cc, ch)):
        for name in b:
            checks.append((f"layer {li} {name}", *within(a[name], b[name])))
    bad = [c for c in checks if not c[1] <= c[2]]
    worst = max(checks, key=lambda c: c[1] / c[2])
    print(f"qwen2 (b) {cfg.name} f32 with patches and positions on {card} "
          f"against the CPU: {len(checks)} comparisons (forward_train, "
          f"prefill logits, {QWEN2_DECODE_STEPS} decode steps' logits, "
          f"{len(cc)} layers' cache fields); worst {worst[0]}: max abs diff "
          f"{worst[1]:.3g} (tolerance {worst[2]:.3g}); card "
          f"{secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s -> "
          f"{'ok' if not bad else 'FAIL'}")
    if bad:
        fail(f"{cfg.name} on the card disagrees with the CPU: {bad[:5]}")


def qwen2_batch(cfg, step, device, seq=TRAIN_SEQ, batch=TRAIN_BATCH):
    """A VLM train batch: `SyntheticTokens`' tokens and targets, and
    `vl_inputs` (patches from ``100 + step``), the same on the card and
    the CPU."""
    out = tdata.SyntheticTokens(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq,
        global_batch=batch)).batch_at(step, device)
    out.update(vl_inputs(cfg, batch, seq, device, seed=100 + step))
    return out


def run_qwen2_train(card):
    """(c): qwen2-vl-72b at full width cut to 1 layer, 6 steps on one
    batch 4 x 512 with its patches and positions (`run_train_full`; no
    kernel launched, counted), then the reduced twin's 3 steps in f32 on
    the card against the CPU (`run_train_parity`)."""
    cfg = dataclasses.replace(get_config(QWEN2_VL),
                              n_layers=QWEN2_TRAIN_LAYERS)
    zero_counts()
    run_train_full(card, cfg, label="qwen2 (c)",
                   batch=qwen2_batch(cfg, 0, "cuda"))
    counts = all_counts()
    if any(counts.values()):
        fail(f"{cfg.name}'s train steps launched {counts}")
    print(f"qwen2 (c) training: launches {counts}")
    run_train_parity(card, QWEN2_VL, label="qwen2 (c)", batch_fn=qwen2_batch)


def time_qwen2_flash(dev, card):
    """(d): the wgmma kernel at QWEN2_FLASH's heads (causal, bf16), each
    against the plain version (`check_wgmma_case`), timed queued (median
    of 5 `steady_ms` readings) beside causal SDPA with ``enable_gqa``
    (`sdpa_yardstick`), the plain version back to back, and the bound
    (`flash_bound`).  Returns (largest error, one row per shape)."""
    smem, blocks = fkernel.wgmma_occupancy(128)
    worst, rows = 0.0, []
    for i, (label, b, s, h, kv, hd) in enumerate(QWEN2_FLASH):
        case = (f"{label} heads", b, s, h, kv, hd, None, None, False)
        q, k, v, got, err = check_wgmma_case(case, dev, 540 + i,
                                             fops.flash_attention_plain)
        worst = max(worst, err)
        lib_label, lib, to_bshd = sdpa_yardstick(q, k, v, None, None, False)
        lib_err = (to_bshd(lib()).float() - got.float()).abs().max().item()
        q_ms = steady_ms(queued_ms, lambda: fops.flash_attention(q, k, v))
        l_ms = steady_ms(queued_ms, lib)
        plain_ms = timed_ms(lambda: fops.flash_attention_plain(q, k, v),
                            reps=5)
        bound_ms, bound_by, nbytes, flops = flash_bound(b, s, h, kv, hd)
        print(f"  timing on {card}, queued, median of 5 [range]: wgmma "
              f"{q_ms[0]:.5f} [{q_ms[1]:.5f}-{q_ms[2]:.5f}] ms"
              f"{held_note(q_ms)}, {lib_label} {l_ms[0]:.5f} "
              f"[{l_ms[1]:.5f}-{l_ms[2]:.5f}] ms{held_note(l_ms)} (vs wgmma "
              f"max abs {lib_err:.3g}), plain {plain_ms:.4f} ms (back to "
              f"back); bound {bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, "
              f"{flops} FLOP); wgmma {q_ms[0] / l_ms[0]:.2f}x SDPA's time, "
              f"{bound_ms / q_ms[0]:.3f} of its bound, "
              f"{flops / q_ms[0] / 1e9:.1f} TFLOP/s; {smem} bytes of shared "
              f"memory a block, {blocks} blocks per SM at hd 128")
        rows.append(dict(case=case[0], b=b, s=s, heads=f"{h}/{kv}", hd=hd,
                         max_abs_err=err, ms=q_ms[0], plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library=lib_label, library_ms=l_ms[0]))
        del q, k, v, got, lib, to_bshd
        torch.cuda.empty_cache()
    return worst, rows


def run_qwen2_path(dev, card):
    """The qwen2 phase: (a) qwen2-72b served at full width (8 layers),
    (b) qwen2-vl-72b served (4 layers) with patches and M-RoPE positions,
    M-RoPE and the reduced twin on the card against the CPU, (c)
    qwen2-vl-72b trained (1 layer), (d) the wgmma kernel at qwen2's and
    jamba's heads beside SDPA.  Returns (each serve's wgmma launches, the
    largest flash error, the (d) rows)."""
    t0 = time.perf_counter()
    launches, err, part_s = {}, 0.0, []
    for arch, n_layers in QWEN2_SERVES:
        (launches[arch], e), sec = synced_s(
            lambda: run_qwen2_serve(arch, n_layers, card))
        err = max(err, e)
        part_s.append(sec)
    part_s[-1] += synced_s(lambda: (check_mrope_card(card),
                                    check_qwen2_parity(card)))[1]
    zero_counts()
    part_s.append(synced_s(lambda: run_qwen2_train(card))[1])
    (err_d, rows), d_s = synced_s(lambda: time_qwen2_flash(dev, card))
    print(f"qwen2 phase on {card}: {time.perf_counter() - t0:.1f} s (a) "
          f"{part_s[0]:.1f} s, (b) {part_s[1]:.1f} s, (c) {part_s[2]:.1f} s,"
          f" (d) {d_s:.1f} s")
    return launches, max(err, err_d), rows


def time_ablate_split(cfg, log, pols, dev, card):
    """The 1-D stream kernel's phase split for every engine policy at its
    shared-log main-path operands: levels 0-3 by CUDA events, queued and
    back to back (median of `steady_ms`; both include the wrapper's small
    kernels), and the kernel alone by torch.profiler (`kernel_alone_ms`);
    then the differences metrics = L0 - L1, steps = L1 - L2, plan = L2 -
    L3, dispatch = L3, in ms and as shares of L0; for ect also the plain
    version at each level, once.  Returns {policy: {"queued" |
    "back_to_back" | "kernel_alone" (| "plain" for ect): [L0..L3]}}."""
    out = {}
    t_, n_ = cfg.n_trials, cfg.n_requests
    n_win = n_ // cfg.window_size
    print("stream kernel phase split, ect's function bound at each level "
          f"(T={t_}, N={n_}, M={cfg.n_servers}): " + "; ".join(
              f"L{lv} {b[0]:.5f} ms by {b[1]} ({b[2]:,} bytes, {b[3]:.4g} "
              "ops)" for lv, b in ((lv, ablate_bound(
                  t_, n_, cfg.n_servers, n_win, lv)) for lv in LEVELS)))
    print(f"stream kernel phase split, shared_log on {card}: ms per launch "
          "by level, queued (back to back) [kernel alone], median of 5 "
          "[range]; metrics = L0 - L1, steps = L1 - L2, plan = L2 - L3, "
          "dispatch = L3 (share of L0):")
    for p, pol in pols.items():
        kargs, kkw = main_path_operands(cfg, log, pol, dev, "stream_batch")
        q, b, k = [], [], []
        for level in LEVELS:
            kw = dict(kkw, ablate=level)

            def call():
                return skernel.sched_stream_call(*kargs, **kw)

            q.append(steady_ms(queued_ms, call))
            b.append(steady_ms(timed_ms, call))
            k.append(kernel_alone_ms(call, "sched_stream_kernel"))
        cells = [f"L{lv} {q[lv][0]:.4f} [{q[lv][1]:.4f}-{q[lv][2]:.4f}]"
                 f"{held_note(q[lv])} ({b[lv][0]:.4f}) "
                 + (f"[{k[lv]:.4f}]" if k[lv] is not None
                    else "[not measured]") for lv in LEVELS]
        print(f"  {p:>10s} ({launches_per_call(call)} kernels a call) "
              + "; ".join(cells))
        readings = {"queued": [x[0] for x in q],
                    "back_to_back": [x[0] for x in b]}
        if all(x is not None for x in k):
            readings["kernel_alone"] = k
        if p == "ect":
            # the plain version at each level, once (the kernel table's row)
            readings["plain"] = [once_ms(lambda: sref.sched_stream_batch_ref(
                *kargs, **dict(kkw, ablate=lv))) for lv in LEVELS]
            print(f"  {'':>10s} plain version: " + ", ".join(
                f"L{lv} {v:.2f} ms" for lv, v in zip(LEVELS,
                                                     readings["plain"])))
        for tag, r in readings.items():
            parts = (("metrics", r[0] - r[1]), ("steps", r[1] - r[2]),
                     ("plan", r[2] - r[3]), ("dispatch", r[3]))
            print(f"  {'':>10s} {tag}: " + ", ".join(
                f"{n} {v:.4f} ({v / r[0]:.3f})" for n, v in parts))
        out[p] = readings
    return out


def time_select(dev, card):
    """`sched_select` (minload) at C=16 streams of N=1024, M=100."""
    rng = np.random.default_rng(11)
    c, n, m = 16, 1024, 100
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8 * m, (c, n)).astype(np.int32),
        rng.uniform(1.0, 20.0, (c, n)).astype(np.float32),
        rng.uniform(0.0, 60.0, (c, m)).astype(np.float32),
        rng.integers(0, 2 ** 32, (c,)))]
    kw = dict(n_servers=m, threshold=2.0, lam=50.0, policy="minload")
    kernel_ms = timed_ms(lambda: sops.sched_select(*args, **kw))
    plain_ms = once_ms(lambda: sops.sched_select_plain(*args, **kw))
    # bytes: objects, lengths, loads and seeds in, choices and loads out;
    # f32 operations per request: the argmin's compare and the probability
    # row's update on every server lane
    nbytes = 4 * (2 * c * n + c * m + c + c * n + c * m)
    ops = c * n * 2 * m
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"timing sched_select minload C={c} N={n} M={m} on {card}: "
          f"kernel {kernel_ms:.4f} ms/launch, plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, {ops} f32 ops)")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    warnings.filterwarnings("ignore", message=PER_CLIENT_NOTE)

    sources = (skernel.SOURCE, fkernel.SOURCE, fkernel.WGMMA_SOURCE,
               tfkernel.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    print(f"built {', '.join(src.name for src in sources)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    sass_funcs = stream_kernel_table()
    for src in sources:
        lines = _build.build_log(src).splitlines()
        if src == skernel.SOURCE:
            # the stream kernel's instantiations are in the table above;
            # the merge kernel's lines follow its "Compiling entry" line
            k = next(i for i, line in enumerate(lines)
                     if "Compiling entry" in line and "client_merge" in line)
            lines = lines[k:k + 4]
        for line in lines:
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                print(f"  ptxas {src.name}: {line.strip()}")
    for hd in (64, 128, 192, 256):
        smem, blocks = fkernel.wgmma_occupancy(hd)
        print(f"  flash_attn_wgmma.cu at head dim {hd}: {smem} bytes of "
              f"dynamic shared memory, {blocks} blocks per SM")
    check_contract(sass_funcs)

    # -- kernels against their plain versions ------------------------------
    err_1d = 0.0
    for i, shape in enumerate(CHECK_SHAPES):
        for j, policy in enumerate(BODY_POLICIES):
            err_1d = max(err_1d, check_case(*shape, policy, 100 * i + j,
                                            dev))
    err_grid = err_merge = 0.0
    for i, shape in enumerate(GRID_SHAPES):
        for j, policy in enumerate(BODY_POLICIES):
            for merge_mean in (True, False):
                e_s, e_m = check_grid_case(shape, policy, merge_mean,
                                           1000 + 100 * i + j, dev)
                err_grid, err_merge = max(err_grid, e_s), max(err_merge, e_m)
    err_merge = max(err_merge, check_merge_cases(dev))
    check_select(dev)
    err_1d = max(err_1d, check_ablate(dev))
    t0 = time.perf_counter()
    (e_1d, e_s, e_m), domain_ms = check_domain(dev, card)
    err_1d, err_grid, err_merge = (max(err_1d, e_1d), max(err_grid, e_s),
                                   max(err_merge, e_m))
    print(f"domain phase: {time.perf_counter() - t0:.1f} s")
    g_errs, global_ms, global_rows, global_counts = check_global_domain(
        dev, card)
    err_merge = max(err_merge, g_errs[2])

    # -- the main paths at the paper's §4 size -----------------------------
    pols = engine_pols()
    cfgs = paper_cfgs()
    cfg, log = cfgs["shared_log"]
    shared_results, shared_counts = run_main_path(
        "shared_log", cfg, log, pols, dev, ("sched_stream",))
    check_shared_log(shared_results, cfg, log, pols, dev)

    pc_cfg, pc_log = cfgs["per_client"]
    c, per, _, win = simulate._client_split_shape(pc_cfg)
    print(f"per_client: {c} clients of {per} requests, window "
          f"{pc_cfg.window_size} clamped to {win}")
    pc_results, pc_counts = run_main_path(
        "per_client", pc_cfg, pc_log, pols, dev,
        ("sched_stream_grid", "client_merge"))
    e_s, e_m = check_per_client(pc_results, pc_cfg, pc_log, pols, dev)
    err_grid, err_merge = max(err_grid, e_s), max(err_merge, e_m)

    # -- the sharded sweep: a world of one, gloo worlds on the card ---------
    t0 = time.perf_counter()
    unsharded = {"shared_log": shared_results, "per_client": pc_results}
    sharded_counts = run_sharded_world_of_one(cfgs, pols, unsharded, card)
    run_gloo_worlds(cfgs, pols, unsharded, dev, card)
    print(f"sharded sweep phase: {time.perf_counter() - t0:.1f} s")

    # -- the paper evaluation on threefry keys -----------------------------
    t_paper = time.perf_counter()
    err_threefry = check_threefry(dev)
    strag_cfg = dataclasses.replace(cfg, straggler_frac=0.1)
    check_prep_on_card(
        (("shared_log", strag_cfg, simulate.default_log_cfg(strag_cfg)),
         ("per_client", pc_cfg, pc_log)), dev)
    eval_counts = run_evals(card)
    check_eager_threefry(dev, card)
    prep_profile = profile_prep((("shared_log", cfg, log),
                                 ("per_client", pc_cfg, pc_log)), dev, card)
    print(f"paper eval phase: {time.perf_counter() - t_paper:.1f} s")

    # -- the eager engine (backend="jax") against the kernel path -----------
    t_eager = time.perf_counter()
    eager_counts = {}
    for name, c_, log_, kern in (("shared_log", cfg, log, shared_results),
                                 ("per_client", pc_cfg, pc_log, pc_results)):
        t0 = time.perf_counter()
        eager, eager_counts[name] = run_eager_path(name, c_, log_, pols,
                                                   kern)
        t1 = time.perf_counter()
        print_analysis(name, eager, kern, card)
        print(f"  ({name}: eager sweeps {t1 - t0:.1f} s, analysis "
              f"{time.perf_counter() - t1:.1f} s)")
    del eager, shared_results, pc_results
    t0 = time.perf_counter()
    seq_launches = check_sequential_kernel(cfg, log, pols, dev)
    print(f"  (sequential kernel path {time.perf_counter() - t0:.1f} s)")
    time_eager((("shared_log", cfg, log), ("per_client", pc_cfg, pc_log)),
               pols, card)
    print(f"eager engine phase: {time.perf_counter() - t_eager:.1f} s")

    # -- the profiling and tuning path -------------------------------------
    tune_counts = run_tune_path(card)
    check_launch_shapes((("shared_log", cfg, log),
                         ("per_client", pc_cfg, pc_log)), pols)
    run_tune_cli(card)

    # -- timing: the stream kernel per policy, the rest for ect -----------
    t_1d = time_shared_log(cfg, log, pols, dev, card)
    t_threefry = time_threefry(dev, card)
    t_grid, t_merge = time_per_client(pc_cfg, pc_log, pols, dev, card)
    # the JAX benchmark's own short-stream instance: 64 clients of 32
    # requests (benchmarks/sched_perf.py, per_client_phase_breakdown)
    c64 = simulate.SimConfig(client_model="per_client", n_clients=64,
                             scenario=simulate.ScenarioConfig("transient"))
    time_per_client(c64, simulate.default_log_cfg(c64), pols, dev, card)

    # -- flash attention, then the serving path at full width --------------
    err_flash = check_flash(dev)
    serve_args, serve_out, serve_counts = run_serve_path(card)
    check_serve_logits(serve_args, serve_out["tokens"])
    profile_serve(serve_args, serve_out["prefill_s"], card)

    # -- the host path: the client-side I/O path, checkpoints, tokens ------
    host_launches = run_host_path(serve_args, card)
    run_train_path(card)
    err_moe, moe_rows, moe_launches = run_moe_path(dev, card)
    ssm_launches, err_ssm = run_ssm_path(dev, card)
    encdec_counts, err_encdec, encdec_rows = run_encdec_path(
        dev, card, with_domain=False)
    qwen2_launches, err_qwen2, qwen2_rows = run_qwen2_path(dev, card)
    run_sharded_train_path(card)
    dryrun_launches = run_dryrun_path(card)
    t_flash = time_flash(dev, card)
    time_select(dev, card)
    split = time_ablate_split(cfg, log, pols, dev, card)

    src = "src/repro_torch/kernels/sched_select/csrc/sched_stream.cu"
    ref = "src/repro/kernels/sched_select/kernel.py"
    print(json.dumps({"kernels": [
        dict(name="sched_stream", route="cuda", source=src,
             replaces=f"{ref}:130", launches=shared_counts["sched_stream"],
             max_abs_err=err_1d, library_ms=None, **t_1d,
             ablate_launches=tune_counts["sched_stream_ablate"],
             sequential_launches=seq_launches,
             host_path_launches=host_launches,
             eager_launches=eager_counts["shared_log"]["sched_stream"],
             sharded_launches=sharded_counts["shared_log"]["sched_stream"],
             domain_ms=domain_ms, levels_ms=split),
        dict(name="sched_stream_grid", route="cuda", source=src,
             replaces=f"{ref}:177",
             launches=pc_counts["sched_stream_grid"], max_abs_err=err_grid,
             eager_launches=eager_counts["per_client"]["sched_stream_grid"],
             sharded_launches=sharded_counts["per_client"][
                 "sched_stream_grid"],
             library_ms=None, **t_grid),
        dict(name="sched_stream_global", route="cuda", source=src,
             replaces=f"{ref}:130",
             launches=global_counts["sched_stream_global"],
             max_abs_err=g_errs[0], library_ms=None, domain_ms=global_ms,
             **global_rows["sched_stream_global"]),
        dict(name="sched_stream_grid_global", route="cuda", source=src,
             replaces=f"{ref}:177",
             launches=global_counts["sched_stream_grid_global"],
             max_abs_err=g_errs[1], library_ms=None,
             **global_rows["sched_stream_grid_global"]),
        dict(name="client_merge", route="cuda", source=src,
             replaces=f"{ref}:558", launches=pc_counts["client_merge"],
             max_abs_err=err_merge,
             eager_launches=eager_counts["per_client"]["client_merge"],
             sharded_launches=sharded_counts["per_client"]["client_merge"],
             library_ms=None, **t_merge),
        *(dict(name=f"flash_attention_{r}", route="cuda",
               source=f"src/repro_torch/kernels/flash_attention/csrc/{f}",
               replaces="src/repro/kernels/flash_attention/kernel.py:33",
               launches=serve_counts[f"flash_attention_{r}"],
               max_abs_err=err_flash[r], **t_flash[r])
          for r, f in (("simt", "flash_attn.cu"),)),
        dict(name="flash_attention_wgmma", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attn_wgmma.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:33",
             launches=serve_counts["flash_attention_wgmma"],
             max_abs_err=err_flash["wgmma"],
             moe_serve_launches=moe_launches, moe_max_abs_err=err_moe,
             moe_shapes=moe_rows, ssm_serve_launches=ssm_launches,
             ssm_max_abs_err=err_ssm,
             encdec_serve_launches=encdec_counts["flash_attention_wgmma"],
             encdec_max_abs_err=err_encdec, encdec_shapes=encdec_rows,
             qwen2_serve_launches=qwen2_launches,
             qwen2_max_abs_err=err_qwen2, qwen2_shapes=qwen2_rows,
             dryrun_serve_launches=dryrun_launches,
             **t_flash["wgmma"]),
        dict(name="threefry2x32", route="cuda",
             source="src/repro_torch/kernels/threefry/csrc/threefry.cu",
             replaces="src/repro/core/simulate.py:784 (jax.random's "
                      "threefry2x32, which XLA runs: no pl.pallas_call)",
             launches=eval_counts["threefry"], max_abs_err=err_threefry,
             library_ms=None, prep=prep_profile, **t_threefry)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_phase(flag: str) -> None:
    """`python3 chip_smoke.py --host-path`, `--train-path`,
    `--contract`, `--moe`, `--ssm`, `--encdec`, `--qwen2`,
    `--sharded-train` or `--dryrun`: that phase alone."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    card = card_line()
    print(card)
    if flag == "--host-path":
        run_host_path(serve.parse_args(SERVE_ARGS), card)
    elif flag == "--contract":
        check_contract(stream_kernel_table())
    elif flag == "--moe":
        run_moe_path(torch.device("cuda"), card)
    elif flag == "--ssm":
        run_ssm_path(torch.device("cuda"), card)
    elif flag == "--encdec":
        sources = (skernel.SOURCE, fkernel.SOURCE, fkernel.WGMMA_SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.build, sources))
        run_encdec_path(torch.device("cuda"), card, with_domain=True)
    elif flag == "--sharded-train":
        run_sharded_train_path(card)
    elif flag == "--dryrun":
        sources = (fkernel.SOURCE, fkernel.WGMMA_SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.build, sources))
        run_dryrun_path(card)
    elif flag == "--qwen2":
        sources = (fkernel.SOURCE, fkernel.WGMMA_SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.build, sources))
        run_qwen2_path(torch.device("cuda"), card)
    else:
        run_train_path(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--walls"] and len(sys.argv) == 3:
        compare_walls(Path(sys.argv[2]))
    elif sys.argv[1:2] == ["--sweep-rank"] and len(sys.argv) == 5:
        sweep_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--dryrun-predict"] and len(sys.argv) == 3:
        dryrun_predict_main(sys.argv[2])
    elif sys.argv[1:] in (["--host-path"], ["--train-path"], ["--contract"],
                          ["--moe"], ["--ssm"], ["--encdec"],
                          ["--qwen2"], ["--sharded-train"], ["--dryrun"]):
        main_phase(sys.argv[1])
    else:
        main()
