#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

On one CUDA card it:
  1. reports the card, its power limit and the software, and builds the
     hand-written kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
  2. holds each kernel against its plain PyTorch version on the card: the
     hash kernels exactly (integer work) and against hashlib (SHA-256 on
     every row at W = 1..20, N off its block, raw, bswap and both, N = 0,
     unaligned views; the Merkle reduction at 2**22 and 2**16 leaves, odd
     widths, a forest of 4 trees, every level kept, one launch a
     reduction, and a proof against core.ledger's), both flash
     attention kernels (the tensor-core one for bf16 at head dims 64-256,
     80 and the cross-attention's shapes included,
     the CUDA-core one for the rest and, on the same bf16 inputs, for
     comparison) within 2e-4 (float32) and 2e-2 (bfloat16) over head dims
     32-256, GQA and MQA groups, causal or not, local windows and ragged
     lengths (and at recurrentgemma's served prefill shape), the decay
     scan within 1e-5 (at its tiles' chunk and channel edges too) and bit
     for bit to its one-thread-a-chain kernel and to a second launch, and
     WKV-6 within 1e-4 (relative plus absolute, over
     head sizes that cut through its 16 x 4 register tiles and sequence
     lengths at the edges of its 16-step chunks), and the flash backward
     (dQ, dK, dV) within 1e-5 of its plain twin (scaled by each
     tensor's largest entry, at least 1) over 108 cases (head dims 16, 32,
     64 and 128, GQA and MQA, causal or not, windows, rows that see no key,
     S and T at its tiles' edges, and the training calls of pnpcoin-demo and, in float32,
     qwen3-0.6b's shape), each bit-equal to a second launch,
     with the forward's training instance (which saves the row
     log-sum-exp) bit-equal to its serving instance; and the bf16
     tensor-core backward within 2e-2 of its twin (scaled the same way)
     over 25 cases (hd 64 and 128, GQA ratios 1, 2 and 8, causal and
     windowed, ragged, and the train CLI's call) and at hd 256 (the
     ``mma.sync`` backward: 10 heads over 1, windows shorter than S,
     ragged, and recurrentgemma-2b's training call), bit-equal twice, with
     the tensor-core forward's training instance bit-equal to its serving
     instance and its log-sum-exp within 1e-4 of the plain one's; the
     decay scan's backward (S 0, 1 and at its 16-step edges, odd C, h0
     and a final-state gradient, recurrentgemma's RG-LRU call) and WKV-6's
     (float32 and bf16, S at its 8-step chunks' edges, K != V, s0 and a
     final-state gradient, rwkv6-7b's call) within 1e-5 of their twins
     (bf16 outputs 2e-2), bit-equal twice, and autograd through
     ``ops.decay_scan`` and ``ops.wkv6`` on the card equal to them;
     then times kernels, plain versions and, for attention, PyTorch's SDPA
     as a yardstick, at the main paths' shapes (the two flash kernels and
     SDPA in turns; the CUDA-core kernel also in float32, its own path, at
     qwen3-0.6b's prefill shape and at pnpcoin-demo's, in turns with SDPA
     on the same float32 inputs; WKV-6 at a decode step and SHA-256 at the
     mining path's three shapes, with events around 10 launches and
     replayed from a CUDA graph; the decay scan's tiled and one-thread-a-
     chain kernels in turns; a Merkle reduction of 2**20 leaves by events
     and from a CUDA graph; the flash backward at pnpcoin-demo's two
     training calls (B 4 x S 32 and the PoUW step's B 16 x S 128) and
     qwen3-0.6b's shapes and at qwen3-0.6b's heads with S = T = 4096 (past
     the cap on dS, in chunks of key tiles; held against the twin on
     batch row 0 and bit-equal twice) by events and from a graph, in
     turns with SDPA's memory-efficient backward (at pnpcoin-demo's also
     from a graph), with each call's peak device memory, and the
     forward's training instance in turns with its serving instance and
     SDPA's efficient forward; the bf16 training forward and backward at
     the train CLI's call, qwen3-0.6b's prefill shape and train_4k's row
     length (S = T = 4096), by events and from a graph, in turns with
     SDPA's bf16 forward and backward, the backward's peak memory no more
     than SDPA's; the two recurrences' backwards at the training calls by
     events and from a graph; the hd-256 training forward and backward at
     recurrentgemma-2b's training call and at S = T = 4096 with its window,
     in turns with SDPA's masked bf16 forward and backward);
  3. drives the mining path through ``Node`` at full size: a collatz jash
     over 2**20 args mined as a full block, then as an optimal block, then
     a Classic double-SHA-256 block over 2**20 nonces, each self-verified,
     then the node's own audit of its chain; then the host clock of the
     full block's Merkle commit (split into its steps) and of its batched
     root re-check;
  4. runs a 2-node ``Network`` to convergence;
  5. drives the workload families and the journal through ``Node``, each
     part with its launch counts checked: SAT at the size of SATLIB's
     uf20-91 (20 variables, 91 clauses, 2**20 assignments a block; 4
     blocks, certificates and refutations, each block's table against
     numpy, each certificate the lowest satisfying assignment, each
     refutation's root against hashlib), docking at 1,024 x 1,024 pairs
     (two blocks, the second verified through the batched verify's
     dedup; 4,096 pairs against a Python loop, the root against
     hashlib), and a journal on disk of a collatz full, a SAT, a docking
     and a Classic block over 2**20 args, recovered whole and, torn by
     100 bytes, recovered to height 3 and resynced from the first node;
     then ``examples/torch_quickstart.py`` on the card and on the CPU,
     which must print the same blocks and tip; then proof-of-useful-work
     training of pnpcoin-demo (2 layers, d_model 256, batch 4 of 32
     tokens, 2 microsteps a block) as ``examples/chain_train_model.py``
     runs it: a 2-node network mines 4 blocks (each verified by the other
     node's replay), recovers node 0 from its journal and reorgs a losing
     private block, the flash forward and backward launches counted
     against the layers and microsteps; the training step split by CUDA
     events into forward, backward and optimiser; the same 4 blocks on
     the CPU port (losses within 1e-3); and
     ``examples/torch_chain_train_model.py`` in a process of its own,
     which must print the same heights, losses and digests; then
     ``PoUWTrainer`` behind ``TrainingWorkload`` at pnpcoin-demo's width,
     each a 2-node network of 4 blocks verified by the peer on receive:
     full mode at ``examples/train_pnp.py``'s defaults (batch 16 of 128
     tokens, 8 miners), audited, recovered and reorged (``"part":
     "pouw_full"``), and optimal (ES) mode at ``examples/es_search.py``'s
     settings (32 candidates, sigma 0.02, a fixed batch), its accepted
     loss never rising, then the example's 20 ``es_update`` steps
     (``"pouw_es"``); each with the first block on the CPU port, the
     launches of the forward's serving and training instances and the
     backward, and the peak device memory; then
     ``examples/torch_np_problems.py``'s network (3 SAT blocks, 4
     GAN-inversion rounds over 2**10 latents, error below 1.0, equal
     digests and books; ``"gan"``). Before those parts, first in the
     phase: ``python -m repro_torch.launch.train --arch qwen3-0.6b`` at
     its defaults (batch 32 x 256, full mode, 8 miners, bf16) for 4
     blocks with a checkpoint after the 4th, as a process of its own: its
     ledger verifies, each checkpoint's SHA-256 is its file's; then 2
     ``--mode optimal`` blocks through the CLI, a second process (its
     ledger verifies, every block optimal), while this process builds the
     audit replay's trainer; the replay gives the CLI's digests and
     hashes with 56
     training-instance forward (``remat``, the config's: each layer runs
     again in the backward) and 28 bf16 backward launches a step, the
     step split by CUDA events, block 0's batch scores lower after the
     blocks than before, the last checkpoint loads to the replay's state
     digest; the threefry init drawn again on the card is the trainer's
     bit for bit; an ES candidate at full width; and a 2-layer cut of
     qwen3-0.6b at full width on the card
     against the CPU port's step from the same state: each leaf's
     gradient, the norm of each leaf's change in the first block and the
     losses (``"train_cli"``, readings and faults in a
     ``"train_cli_cut"`` line); then ``--arch recurrentgemma-2b`` at full
     width and depth (26 layers, bf16, ``remat``) as a process of its own
     at batch 16, 2 blocks and one checkpoint, replayed in this process
     (digests and hashes equal, per step 36 decay-scan forward and 18
     backward launches, 16 hd-256 training-instance forward and 8 hd-256
     backward launches and no other kernel, the checkpoint loaded to the
     replay's digest, the build split into init and review, the block into
     step and host digest, the step split by CUDA events with its peak
     memory), and a 3-layer cut against the CPU port leaf by leaf
     (``"train_hybrid"``, ``"train_hybrid_cut"``); rwkv6-7b at full width
     cut to 8 of its 32 layers through ``PoUWTrainer`` at batch 32 x 256,
     2 blocks and an audit replay (16 WKV-6 forward and 8 backward
     launches a step), and a 2-layer cut against the CPU port
     (``"train_ssm"``, ``"train_ssm_cut"``); then
     pnpcoin-micro (hd 16) through ``ModelTrainingWorkload(**
     MICRO_KWARGS)``, 4 blocks on the card and the CPU port (losses
     within 1e-5; ``"micro_train"``). In this phase a trainer whose step
     an earlier build in this process reviewed skips the review; each
     step's first review is timed (``"step_reviews"``);
  6. serves nine models at full width and depth through
     ``repro_torch.launch.serve`` (batch 8, 32 new tokens, bf16, random
     weights from a fixed seed): qwen3-0.6b (prompt 2048; flash attention),
     rwkv6-7b (prompt 2048; WKV-6 in prefill and decode),
     recurrentgemma-2b (prompt 4096; decay scan and windowed flash
     attention), qwen3-8b, stablelm-1.6b, stablelm-3b (hd 80) and
     olmoe-1b-7b (MoE; prompt 2048 each), llama-3.2-vision-11b (prompt
     2048; cross-attention to 1,601 image tokens in prefill and at every
     decode step) and whisper-medium (prompt 416; an encoder over 1,500
     frames, cross-attention in prefill and at every decode step), bf16
     attention on the tensor-core kernel. Each path's launch counts must
     equal its layer counts, its first and last launch of each kernel at
     each call site must equal the plain version on the same inputs, and
     a reduced float32 model served on the card (its attention on the
     CUDA-core kernel, launches counted) and on the CPU must agree, MoE
     expert choices included; arctic-480b (960 GB of bf16 weights) by its
     reduced model only;
  7. counts with torch.profiler the CUDA kernels a SHA-256 call runs (one)
     and those of 3 pnpcoin-demo training steps (the flash forward's
     training instance and the backward's three kernels once a layer and
     step, no attention kernel of PyTorch's; last, since a traced process
     launches more slowly afterwards), checks
     each kernel's launch count from its own path (21 SHA-256 and 2
     Merkle launches, one a reduction, a mining path) and that the
     verifier's hashlib fallback never fired, and prints the kernel table.
Each phase prints one JSON line. The last line is the result. Any failure
raises and exits non-zero; without a card the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# 32-bit instructions one SHA-256 compression needs, counted as sm_90 runs
# them: a rotate or shift is one funnel shift (SHF), a three-input xor, Ch
# or Maj is one LOP3, and up to three summands are one IADD3. A round is 6
# rotates, 4 LOP3 and 4 adds (h + S1 + Ch, then + K + W, take two; the new
# e and a one each); a schedule step is 6 shifts (three for each small
# sigma), 2 LOP3 and 2 adds; then come the 8 final adds. The Merkle
# parent's second compression reads K + W from a table and has no
# schedule. A byte swap on load is one PRMT per word.
# By pipe: SHF, LOP3 and PRMT issue only to the integer pipe; an add may be
# an IADD3 there or an IMAD on the FMA pipe, so the least time leaves the
# integer pipe the shifts and logic alone.
INT_ROUND, ADD_ROUND = 10, 4
INT_SCHEDULE, ADD_SCHEDULE = 8, 2


def compression_ops(schedule: bool = True) -> dict:
    """Instructions of one compression by where they can issue: "int"
    (integer pipe only) and "add" (integer or FMA pipe)."""
    steps = 48 if schedule else 0
    return {"int": 64 * INT_ROUND + steps * INT_SCHEDULE,
            "add": 64 * ADD_ROUND + steps * ADD_SCHEDULE + 8}


OPS_COMPRESSION = sum(compression_ops().values())              # 1,384
OPS_PAD_COMPRESSION = sum(compression_ops(False).values())     # 904
# a 32-bit word as the port's tensors hold it, int64: SHA-256's bound counts
# the bytes of its int64 inputs and outputs, the interface's cost (the
# Merkle reduction takes and gives uint32 words)
WORD_BYTES = 8
# H100 SXM: 3.35 TB/s of HBM3. Issue: 132 SMs x 4 schedulers x one warp
# instruction (32 lanes) a cycle x 1.98 GHz, the rate behind the data
# sheet's 67 TFLOP/s in float32 (an FMA counts as two flops). The integer
# pipe takes half a warp instruction a scheduler and cycle (16 lanes),
# as chip_probes.py's int_issue probe measures for LOP3, SHF and IADD3
# alone and in pairs on the H100; IMAD goes to the FMA pipe beside it.
HBM_BYTES_S = 3.35e12
ISSUE_OPS_S = 132 * 128 * 1.98e9
INT_PIPE_OPS_S = 132 * 64 * 1.98e9
# dense bf16 tensor-core peak (data sheet): the peak rate for attention's
# bf16 inputs, whichever units a kernel uses
BF16_FLOPS_S = 989e12
# float32 outside the tensor cores (data sheet): the recurrences' rate
F32_FLOPS_S = 67e12
# instantiations in the library: SHA-256 3 (raw/bswap) x 3 (W = 2, 8 or
# any), Merkle 1, flash 5 head dims x 2 dtypes, tensor-core flash 4 head
# dims (bf16) and its training instance 2, WKV-6 2 dtypes, decay scan 2
# (tiled, one thread a chain), flash's training instance (float32, with
# the row log-sum-exp) 4 head dims, the flash backward 3 kernels (D, dK
# and dV, dQ) x 4 head dims, the bf16 backward 2 kernels (D; dK, dV and
# dQ) x 2 head dims; then the tensor-core forward's training instance at
# hd 256, the decay scan's backward, WKV-6's backward (2 dtypes) and its
# sum of du, and the hd-256 bf16 backward's 3 kernels (D; dK and dV; dQ)
N_KERNEL_INSTANCES = 9 + 1 + 10 + 4 + 2 + 2 + 2 + 4 + 12 + 4 + 1 + 1 + 3 + 3

# serve shape: qwen3-0.6b, batch 8, prompt 2048, 32 new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
# rwkv6-7b serves the same batch and prompt; recurrentgemma-2b a prompt of
# 4096, twice its local window, so the window mask and the ring-cache roll
# both run at full width
RWKV_PROMPT, RG_PROMPT = 2048, 4096
# whisper-medium's prompt: its decoder's context is 448 tokens, so 416 plus
# the 32 new ones fill it
WHISPER_PROMPT = 416
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the kernels' tiles, constants in their sources, which the edge cases
# follow: the decay scan's STEPS x 32 DECAY_WARPS, SHA-256's THREADS rows
DECAY_STEPS, DECAY_CHANNELS, SHA_BLOCK_ROWS = 128, 64, 64
# relative plus absolute, float32 state and sums in both versions
DECAY_TOL, WKV_TOL = 1e-5, 1e-4

# the flash backward against its twin, float32: max |kernel - twin| <=
# BWD_TOL max(1, max |twin|) for each of dQ, dK and dV. Both sum in
# float32 in different orders; at qwen3-0.6b's S = 2048 the sums run over
# 2048 keys or queries and the two differ by up to 2.5e-5 on entries near
# zero (measured on the H100), so the bound scales with the tensor, and
# that case also reports each one's error against a float64 twin
BWD_TOL = 1e-5
# the attention calls of training: pnpcoin-demo's (B, S, H, Kv, hd) as the
# chain trains it, and qwen3-0.6b's prefill shape in float32
DEMO_ATTN = (4, 32, 8, 4, 32)
QWEN_F32_ATTN = (SERVE_BATCH, SERVE_PROMPT, 16, 8, 128)
# qwen3-0.6b's heads at S = T = 4096: 4.3 GB of dS, past the backward's
# 2 GiB cap, so its key tiles go in chunks
CHUNKED_ATTN = (SERVE_BATCH, 4096, 16, 8, 128)
# pnpcoin-demo's chain: as examples/chain_train_model.py runs it
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_BLOCKS = 32, 4, 2, 4
# proof-of-useful-work training through PoUWTrainer at pnpcoin-demo's
# width: full mode at examples/train_pnp.py's defaults (batch 16 of 128
# tokens, 8 miners, lr 1e-3, warmup max(blocks // 20, 5), total_steps the
# blocks), and optimal (ES) mode at examples/es_search.py's settings
# (batch 8 of 32 tokens, 32 candidates, sigma 0.02, a fixed batch, 8
# miners); each a 2-node network of POUW_BLOCKS blocks
POUW_SEQ, POUW_BATCH, POUW_MINERS, POUW_BLOCKS = 128, 16, 8, 4
ES_SEQ, ES_BATCH, ES_POP, ES_SIGMA, ES_DEMO_STEPS = 32, 8, 32, 0.02, 20
# the attention calls of a full-mode PoUW step and of an ES candidate's
# score: (B, S, H, Kv, hd)
POUW_ATTN = (POUW_BATCH, POUW_SEQ, 8, 4, 32)
ES_ATTN = (ES_BATCH, ES_SEQ, 8, 4, 32)
# pnpcoin-micro's attention call in a MICRO_KWARGS step (hd 16)
MICRO_ATTN = (2, 16, 2, 1, 16)
# torch_np_problems.py's network: SAT at 12 variables, 48 clauses (3
# blocks), GAN inversion over 2**10 latents (4 rounds)
NP_VARS, NP_CLAUSES, NP_SAT_BLOCKS, GAN_GRID_BITS, GAN_ROUNDS = \
    12, 48, 3, 10, 4
# training steps profiled in the last phase
TRAIN_PROFILED = 3
# |card loss - CPU loss| <= TRAIN_LOSS_TOL |CPU loss|, block by block
TRAIN_LOSS_TOL = 1e-3
# full-mode PoUW blocks replayed on the CPU port against the card's
POUW_CPU_BLOCKS = 4
# |card - CPU| <= ES_LOSS_TOL |CPU| for each ES candidate's loss: the
# candidates' noise differs only where the two devices' log1p round apart
ES_LOSS_TOL = 1e-5

# the bf16 tensor-core backward's cases: (B, S, T, H, Kv, causal, window)
# at head dims 64 and 128: GQA ratios 1, 2 and 8, causal and windowed, S
# and T off its 64-row tiles and 128-row items, S != T both ways, rows
# that see no key (S 100 over T 40 with a window of 20), more items (480)
# than its persistent grid has blocks, then the training step's call at
# the train CLI's defaults (CLI_ATTN)
TC_BWD_CASES = [(2, 33, 33, 4, 4, True, 0), (1, 100, 100, 8, 4, True, 0),
                (2, 70, 150, 8, 1, False, 0), (1, 150, 70, 4, 2, True, 0),
                (2, 90, 90, 4, 4, True, 17), (1, 200, 200, 8, 1, True, 64),
                (1, 129, 129, 2, 1, True, 0), (1, 257, 257, 16, 8, True, 0),
                (3, 1, 1, 2, 1, True, 0), (1, 100, 40, 2, 1, True, 20),
                (1, 65, 129, 16, 2, False, 33), (2, 64, 64, 4, 2, True, 0),
                (2, 192, 320, 16, 2, False, 0), (1, 130, 250, 4, 1, True, 45),
                (16, 300, 300, 8, 2, True, 0)]
# qwen3-0.6b's attention call in a training step at the train CLI's
# defaults (batch 32 of 256 tokens), and its prefill shape, in bf16
CLI_ATTN = (32, 256, 16, 8, 128)
QWEN_BF16_ATTN = (SERVE_BATCH, SERVE_PROMPT, 16, 8, 128)
# and at train_4k's row length (repro/configs/base.py: 4,096 tokens), 4 rows
TRAIN_4K_ATTN = (4, 4096, 16, 8, 128)
# the bf16 backward against its twin (float32 math on the same bf16
# inputs, cast to bf16): max |kernel - twin| <= TC_BWD_TOL max(1, max
# |twin|) for each of dQ, dK, dV. The kernel rounds P and dS to bf16 for
# its products (a relative 2^-9 each) and its results to bf16; the
# training instance's log-sum-exp within TC_LSE_TOL of the plain one's
# (absolute and relative: its sum runs on ex2.approx in another order)
TC_BWD_TOL = 2e-2
TC_LSE_TOL = 1e-4

# the train CLI at its defaults (qwen3-0.6b at full width and depth,
# batch 32 x 256, full mode, 8 miners, 1 microstep, lr 3e-4, warmup
# max(blocks // 20, 5)) for CLI_BLOCKS blocks, a checkpoint every
# CLI_CKPT_EVERY, then CLI_ES_BLOCKS blocks in optimal mode (ES). 4 blocks
# and one checkpoint (8 and two before the recurrent families' training
# parts joined phase 5): the script's time
CLI_BLOCKS, CLI_CKPT_EVERY, CLI_ES_BLOCKS = 4, 4, 2
# qwen3-0.6b cut to CUT_LAYERS layers at full width, batch CUT_BATCH x
# CUT_SEQ, CUT_BLOCKS full-mode blocks on the card and on the CPU port,
# from the same initial state: |card - CPU| <= CUT_LOSS_TOL |CPU| block by
# block; each leaf's gradient at the initial state within CUT_GRAD_TOL of
# the CPU port's (||card - CPU|| / ||CPU|| over the leaf), and the norm of
# each leaf's change in block 0 within CUT_UPDATE_TOL of the CPU port's
# (|a - b| / max(a, b)). Both devices round bf16
# weights and activations at other places; the limits lie between the
# sound readings and the faults the part measures beside them (block 1's
# gradient, no change at all; PERF.md). The gradient's limit is the
# part's: rwkv6-7b's bf16 gradients round far more than attention
# models' (qwen3-0.6b's and recurrentgemma-2b's cuts read under 0.02).
# On the H100 its cut read 0.094 against faults of 2.14-2.36, and
# ``chip_probes.py ssm_cut_rounding`` reads the same cut's bf16 gradients
# 0.36 from float32 ones on either device, where card and CPU agree
# within 5e-5 in float32: the 0.094 is rounding
CUT_LAYERS, CUT_BATCH, CUT_SEQ, CUT_BLOCKS = 2, 2, 64, 2
CUT_LOSS_TOL, CUT_UPDATE_TOL = 1e-3, 1e-2
CUT_GRAD_TOL = {"train_cli": 5e-2, "train_hybrid": 5e-2, "train_ssm": 0.25}
# pnpcoin-micro (hd 16) through ModelTrainingWorkload(**MICRO_KWARGS):
# MICRO_BLOCKS blocks on the card and on the CPU port, |card - CPU| <=
# MICRO_LOSS_TOL |CPU| block by block
MICRO_BLOCKS, MICRO_LOSS_TOL = 4, 1e-5

# the recurrent families' training calls: recurrentgemma-2b's RG-LRU (B, S,
# lru) and local attention (B, S, H, Kv, hd) at HYBRID_BATCH x 256, its
# attention also at S = T = 4096 (twice its window); rwkv6-7b's WKV-6 (B,
# S, H, K, V) at SSM_BATCH x 256
HYBRID_BATCH, HYBRID_BLOCKS = 16, 2
SSM_BATCH, SSM_BLOCKS, SSM_LAYERS, SSM_CUT_LAYERS = 32, 2, 8, 2
RG_WINDOW = 2048
RG_TRAIN_LRU = (HYBRID_BATCH, 256, 2560)
RG_TRAIN_ATTN = (HYBRID_BATCH, 256, 10, 1, 256)
RG_4K_ATTN = (2, 4096, 10, 1, 256)
RWKV_TRAIN_WKV = (SSM_BATCH, 256, 64, 64, 64)
# the decay scan's backward against its twin, which runs its operations in
# its order: max |kernel - twin| <= DECAY_BWD_TOL max |twin| (readings 0)
DECAY_BWD_TOL = 1e-5
# WKV-6's backward against its twin: float32 sums in other orders (the
# kernel's shuffle trees, the twin's einsums); bf16 r, k, v give bf16 dr,
# dk, dv, held after the twin's are rounded to bf16 as the kernel's are
WKV_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
WKV_BWD_CHUNK = 8   # steps between the backward's checkpoints (its source)
# the bf16 backward at head dim 256 (csrc/flash_attention_mma_bwd.cu):
# (B, S, T, H, Kv, causal, window): recurrentgemma's 10 heads over 1 with
# windows shorter than S, ragged lengths, S at and off its 64-row tiles,
# S != T, one query, GQA 2, not causal; then RG_TRAIN_ATTN
TC256_BWD_CASES = [(2, 200, 200, 10, 1, True, 64), (1, 300, 300, 10, 1, True,
                                                     100),
                   (1, 130, 130, 2, 2, True, 0), (1, 77, 77, 4, 1, False, 0),
                   (2, 64, 64, 10, 1, True, 0), (1, 100, 170, 4, 2, False, 0),
                   (3, 1, 1, 10, 1, True, 0), (1, 129, 129, 10, 1, True, 33)]

MAIN_BITS = 20
# seconds of quiet at each end of a profiled window
PROFILER_QUIET_S = 0.02


# the script's start: each phase's line carries the seconds since
_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def hash_bound_ms(nbytes: float, compressions: float,
                  pad_compressions: float = 0, swaps: float = 0):
    """The hash kernels' bound: bytes at the HBM rate against each pipe's
    instructions at its rate (the integer pipe's shifts, logic and byte
    swaps; every instruction at the issue rate), the busiest of the three.
    Returns (ms, "bytes" or "operations", the arithmetic)."""
    full, pad = compression_ops(), compression_ops(False)
    int_ops = compressions * full["int"] + pad_compressions * pad["int"] \
        + swaps
    all_ops = int_ops + compressions * full["add"] \
        + pad_compressions * pad["add"]
    t_bytes = nbytes / HBM_BYTES_S
    t_int, t_issue = int_ops / INT_PIPE_OPS_S, all_ops / ISSUE_OPS_S
    t = max(t_bytes, t_int, t_issue)
    return t * 1e3, "bytes" if t == t_bytes else "operations", (
        f"max({nbytes:.4g} B / 3.35e12, {int_ops:.4g} integer-pipe "
        f"instructions / {INT_PIPE_OPS_S:.4g}, {all_ops:.4g} instructions "
        f"/ {ISSUE_OPS_S:.4g}) = max({t_bytes * 1e3:.4g}, "
        f"{t_int * 1e3:.4g}, {t_issue * 1e3:.4g}) ms")


def kernel_name(mangled: str) -> str:
    """A readable name for a kernel's mangled symbol: the function and its
    template arguments."""
    import re
    mma = re.search(r"flash_attention_mma_bwd_cu\w*?(tc_dot_kernel|"
                    r"tc_dkv_kernel|tc_dq_kernel)", mangled)
    if mma:
        return f"flash_mma_bwd_{mma[1][3:]}<bf16,hd=256>"
    found = re.search(r"(sha256_rows_kernel|merkle_reduce_kernel|"
                      r"flash_fwd_kernel|flash_tc_kernel|wkv6_kernel|"
                      r"wkv6_bwd_kernel|wkv6_du_kernel|"
                      r"decay_scan_bwd_kernel|"
                      r"tc_bwd_kernel|tc_dot_kernel|"
                      r"dq_kernel|dkv_kernel|dot_kernel|"
                      r"decay_scan_per_chain_kernel|decay_scan_kernel)",
                      mangled)
    check(found is not None, f"known kernel name in {mangled}")
    name = found[1]
    flags = re.search(r"ILb(\d)ELb(\d)ELi(\d+)E", mangled)
    if flags:
        w = flags[3] if flags[3] != "0" else "any"
        name += f"<raw={flags[1]},bswap={flags[2]},w={w}>"
    targs = re.search(r"I(f|13__nv_bfloat16)(?:Li(\d+))?E", mangled)
    hd = re.search(r"ILi(\d+)E", mangled)
    if name == "flash_tc_kernel":
        name += f"<bf16,hd={hd[1]}" + (",lse>" if "Lb1E" in mangled else ">")
    elif name.startswith("tc_"):
        part = "kernel" if name == "tc_bwd_kernel" else name[3:]
        name = f"flash_tc_bwd_{part}<bf16,hd={hd[1]}>"
    elif name in ("dq_kernel", "dkv_kernel", "dot_kernel"):
        name = f"flash_bwd_{name}<f32,hd={hd[1]}>"
    elif name == "flash_fwd_kernel" and "Lb1E" in mangled:
        name += f"<f32,hd={targs[2]},lse>"
    elif targs:
        dtype = "f32" if targs[1] == "f" else "bf16"
        name += f"<{dtype},hd={targs[2]}>" if targs[2] else f"<{dtype}>"
    return name


def ptxas_usage(log: str) -> dict:
    """Registers, barriers and spills of each kernel, from ``-Xptxas -v``,
    and ptxas's notes of lost performance (serialised wgmma and the
    like), by source file."""
    import re
    usage, name, notes, source = {}, None, {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if line.startswith("== "):
            source = line[3:].strip()
        elif entry:
            name = kernel_name(entry[1])
        elif re.search(r"\(C7\d\d\d\)", line):
            notes.setdefault(source, []).append(line.strip()[:200])
        elif name and ("registers" in line or "spill" in line):
            usage.setdefault(name, []).append(
                line.split(":", 1)[-1].strip())
    return {"kernels": usage, "performance_notes": notes}


def flash_tc_resources() -> dict:
    """Registers, dynamic shared memory and local memory (spills) of each
    instantiation of the tensor-core flash kernel, as the runtime reports
    them for the built library."""
    import ctypes
    from repro_torch.kernels import native
    lib, out = native.library(), {}
    for hd, lse in ((64, 0), (80, 0), (128, 0), (256, 0), (64, 1),
                    (128, 1), (256, 1)):
        regs, smem, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.pnp_flash_attention_tc_info(hd, lse, ctypes.byref(regs),
                                             ctypes.byref(smem),
                                             ctypes.byref(local))
        name = f"flash_tc_kernel<bf16,hd={hd}" + (",lse>" if lse else ">")
        check(rc == 0, f"{name} attributes ({rc})")
        out[name] = {"registers": regs.value,
                     "dynamic_shared_bytes": smem.value,
                     "local_bytes": local.value}
        check(local.value == 0, f"{name} spills nothing")
    return out


def flash_bwd_resources(ptxas: dict) -> dict:
    """The flash backward's instances: ptxas's registers and spills, and
    each head dim's tiles with the registers and local (spilled) bytes the
    runtime reports; fails on a spill."""
    from repro_torch.kernels import flash_attention_bwd
    out = {"ptxas": {name: lines for name, lines in ptxas["kernels"].items()
                     if name.startswith("flash_bwd_")}}
    for hd in flash_attention_bwd.HEAD_DIMS:
        tile = flash_attention_bwd.tile(hd)
        for key, res in tile.items():
            if key.endswith("_resources"):
                check(res["local_bytes"] == 0,
                      f"flash backward {key} at hd {hd} spills nothing")
        out[f"hd={hd}"] = tile
    check(len(out["ptxas"]) == 12, f"12 backward instances: {out['ptxas']}")
    return out


def flash_tc_bwd_resources(ptxas: dict) -> dict:
    """The bf16 backward's instances: ptxas's registers and spills, and
    each head dim's tiles with the registers and local (spilled) bytes the
    runtime reports; fails on a spill."""
    from repro_torch.kernels import flash_attention_tc_bwd
    out = {"ptxas": {name: lines for name, lines in ptxas["kernels"].items()
                     if name.startswith("flash_tc_bwd_")}}
    for hd in flash_attention_tc_bwd.HEAD_DIMS:
        tile = flash_attention_tc_bwd.tile(hd)
        for key, res in tile.items():
            if key.endswith("_resources"):
                check(res["local_bytes"] == 0,
                      f"bf16 backward {key} at hd {hd} spills nothing")
        out[f"hd={hd}"] = tile
    check(len(out["ptxas"]) == 4, f"4 bf16 backward instances: "
                                  f"{out['ptxas']}")
    return out


def flash_mma_bwd_resources(ptxas: dict) -> dict:
    """The hd-256 bf16 backward's kernels: ptxas's registers and spills, and
    its tiles with the registers and local (spilled) bytes the runtime
    reports."""
    from repro_torch.kernels import flash_attention_mma_bwd
    out = {"ptxas": {name: lines for name, lines in ptxas["kernels"].items()
                     if name.startswith("flash_mma_bwd_")},
           "hd=256": flash_attention_mma_bwd.tile()}
    check(len(out["ptxas"]) == 3, f"3 hd-256 backward kernels: "
                                  f"{out['ptxas']}")
    return out


def sass_counts(lib: Path) -> dict:
    """Instructions of each kernel in the built library, read from its SASS
    with cuobjdump (the SASS is kept beside the library): the total, without
    NOPs, and each opcode that occurs at least 8 times."""
    import os
    import re
    import shutil
    tool = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") \
        / "bin" / "cuobjdump"
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    check(exe is not None, "cuobjdump found")
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    lib.with_suffix(".sass").write_text(text)
    ops, name = {}, None
    for line in text.splitlines():
        func = re.match(r"\s*Function : (\S+)", line)
        if func:
            name = kernel_name(func[1])
            ops[name] = {}
            continue
        insn = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
            line)
        if insn and name and insn[1] != "NOP":
            ops[name][insn[1]] = ops[name].get(insn[1], 0) + 1
    check(len(ops) == N_KERNEL_INSTANCES,
          f"{N_KERNEL_INSTANCES} kernels in the library, found {list(ops)}")
    return {name: {"instructions": sum(c.values()),
                   "opcodes": {k: v for k, v in sorted(
                       c.items(), key=lambda kv: -kv[1]) if v >= 8}}
            for name, c in ops.items()}


def in_turns(fns: dict, rounds: int = 2) -> dict:
    """Each function of ``fns`` timed by ``cuda_ms`` in turns (a b c, then
    c b a, ...); the median of its rounds."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_ms(fns[name]))
    return {name: statistics.median(t) for name, t in times.items()}


def cuda_ms(fn, reps=10, rounds=3):
    """A launch's device time: CUDA events around ``reps`` calls in a row
    (so the host's time to issue one call hides behind the last one's
    run), over ``reps``; the median of ``rounds`` such runs, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps=10):
    """A launch's device time without the host's: ``reps`` calls captured
    in a CUDA graph, the graph's replay timed by ``cuda_ms``, over
    ``reps``."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=1) / reps


def _flash_both(q, k, v, want, label, worst, **kw) -> None:
    """The flash call the path makes (``flash_attention_cuda``, which picks
    the kernel by dtype and head dim) against the plain version, its
    launch counted on the kernel it must take; and for bf16 inputs the
    tensor-core kernel takes, the CUDA-core kernel on the same inputs too
    where it takes the head dim (not 80). Records each kernel's largest
    error in ``worst``."""
    import torch
    from repro_torch.kernels import flash_attention, flash_attention_tc
    dtype = str(q.dtype).split(".")[1]
    tol = FLASH_TOL[dtype]
    tc = flash_attention.kernel_for(q.dtype, q.shape[-1]) == "tensor_core"
    used = flash_attention_tc if tc else flash_attention
    runs = {"tensor_core" if tc else "cuda_core":
            flash_attention.flash_attention_cuda}
    if tc and q.shape[-1] in flash_attention.HEAD_DIMS:
        runs["cuda_core"] = flash_attention.flash_attention_cuda_core
    for kernel, fn in runs.items():
        before = used.launches
        got = fn(q, k, v, **kw).float()
        if fn is flash_attention.flash_attention_cuda:
            check(used.launches == before + 1,
                  f"flash {label}: launched the {kernel} kernel")
        check(torch.equal(got, fn(q, k, v, **kw).float()),
              f"flash {kernel} {label}: two launches equal")
        err = float((got - want).abs().max())
        key = f"{kernel}/{dtype}"
        worst[key] = max(worst.get(key, 0.0), err)
        check(torch.allclose(got, want, rtol=tol, atol=tol),
              f"flash {kernel} {label} vs plain ({err})")


def flash_vs_plain(dev) -> dict:
    """Both flash kernels against their plain version, and each against a
    second launch: head dims 16, 32, 64, 128; GQA groups 1 and 2; causal and
    not; S = T in {33, 1000, 2048} and S != T; S and T one off the CUDA-core
    kernel's block of query rows and tile of keys; float32 and bfloat16;
    the reduced float32 models' own calls (hd 32, batch 2, prompt 100); the
    large equal-score case; then in bfloat16 only (the tensor-core kernel's
    shapes): head dim 80, causal or not, S != T both ways, S and T one off
    its 128-row items and 128-key tiles, G 1 and 4; the cross-attention's
    shapes (whisper's 16 heads, hd 64: S 1 and 416 over T 1500;
    llama-3.2-vision's 32 over 8, hd 128: S 1 over T 1601); and G = 7
    (arctic's 56 heads over 8, hd 128)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     tile)
    gen = torch.Generator(device=dev).manual_seed(20261)
    cases = [(hd, g, causal, n, n) for hd in (16, 32, 64, 128)
             for g in (1, 2) for causal in (True, False)
             for n in (33, 1000, 2048)]
    cases += [(hd, 2, False, 700, 1500) for hd in (16, 32, 64, 128)]
    for hd in (16, 32, 64, 128):
        bq, bk = tile(hd)["block_rows"], tile(hd)["block_keys"]
        cases += [(hd, 2, True, bq + 1, bq + 1), (hd, 2, True, bq - 1, bq - 1),
                  (hd, 1, False, bq + 1, bk - 1),
                  (hd, 2, False, bk + 1, 2 * bk + 1)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        for hd, g, causal, n_q, n_k in cases:
            q, k, v = randn(2, n_q, 2 * g, hd), randn(2, n_k, 2, hd), \
                randn(2, n_k, 2, hd)
            want = ref.flash_attention_ref(q, k, v, causal=causal).float()
            _flash_both(q, k, v, want, f"{dtype} hd={hd} G={g} causal="
                        f"{causal} S={n_q} T={n_k}", worst, causal=causal)
    # the reduced float32 serve runs: qwen3-0.6b's 8 heads over 8 and
    # recurrentgemma-2b's 8 over 1 within a window of 64, at hd 32
    for kv, window in ((8, 0), (1, 64)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for shape in
                   ((2, 100, 8, 32), (2, 100, kv, 32), (2, 100, kv, 32)))
        want = ref.flash_attention_ref(q, k, v, causal=True,
                                       window=window).float()
        _flash_both(q, k, v, want, f"reduced-model call Kv={kv} window="
                    f"{window}", worst, causal=True, window=window)
    q = torch.full((1, 32, 1, 32), 30.0, device=dev)
    out = flash_attention_cuda(q, q.clone(), torch.ones_like(q), causal=True)
    check(bool(torch.isfinite(out).all()) and torch.allclose(
        out, torch.ones_like(out), rtol=1e-5, atol=0),
        "flash large equal scores give 1")
    # bf16 only: (B, S, T, H, Kv, hd, causal)
    bf16_cases = [(2, n, n, 2 * g, 2, 80, causal) for g in (1, 4)
                  for causal in (True, False) for n in (33, 1000)]
    bf16_cases += [(2, 700, 1500, 4, 2, 80, False),
                   (2, 1500, 700, 4, 2, 80, False),
                   (2, 129, 129, 8, 2, 80, True),
                   (2, 127, 127, 2, 2, 80, True),
                   (2, 129, 127, 2, 2, 80, False),
                   (2, 257, 255, 8, 2, 80, False),
                   (2, 1, 1500, 16, 16, 64, False),
                   (2, 416, 1500, 16, 16, 64, False),
                   (2, 1, 1601, 32, 8, 128, False),
                   (2, 300, 300, 56, 8, 128, True),
                   (2, 300, 700, 56, 8, 128, False)]
    for B, n_q, n_k, H, Kv, hd, causal in bf16_cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen,
                               device=dev).to(torch.bfloat16)
        q, k, v = randn(B, n_q, H, hd), randn(B, n_k, Kv, hd), \
            randn(B, n_k, Kv, hd)
        want = ref.flash_attention_ref(q, k, v, causal=causal).float()
        _flash_both(q, k, v, want, f"bfloat16 hd={hd} H={H} Kv={Kv} causal="
                    f"{causal} S={n_q} T={n_k}", worst, causal=causal)
    return {"cases": 2 * len(cases) + 3 + len(bf16_cases),
            "max_abs_err": worst, "tolerance": FLASH_TOL,
            "stability_equal_scores": True,
            "bf16_only_cases": [dict(zip("B S T H Kv hd causal".split(), c))
                                for c in bf16_cases]}


def _flash_timing(q, k, v, sdpa, pairs, **kw) -> dict:
    """The tensor-core kernel, the CUDA-core kernel on the same bf16 inputs
    (where it takes the head dim: not at 80) and SDPA (the yardstick, never
    on the path), timed in turns in this call; the plain version; the bound
    (4 hd flops a (query, key) pair in the band, an FMA as two, at the bf16
    peak, hd the inputs' own; q, k, v and out once at the HBM rate) and
    each one's TFLOP/s."""
    import torch
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda_core
    from repro_torch.kernels.flash_attention_tc import flash_attention_tc_cuda
    B, S, H, hd = q.shape
    with_core = hd in flash_attention.HEAD_DIMS
    out = flash_attention_tc_cuda(q, k, v, **kw)
    check(torch.equal(out, flash_attention_tc_cuda(q, k, v, **kw)),
          "tensor-core flash kernel equal from run to run")
    check(torch.allclose(sdpa().transpose(1, 2).float(), out.float(),
                         rtol=2e-2, atol=2e-2),
          "SDPA agrees with the tensor-core kernel")
    fns = {"tensor_core": lambda: flash_attention_tc_cuda(q, k, v, **kw)}
    if with_core:
        core = flash_attention_cuda_core(q, k, v, **kw)
        check(torch.equal(core, flash_attention_cuda_core(q, k, v, **kw)),
              "CUDA-core flash kernel equal from run to run")
        check(torch.allclose(core.float(), out.float(), rtol=2e-2,
                             atol=2e-2),
              "the CUDA-core kernel agrees with the tensor-core kernel")
        del core
        fns["cuda_core"] = lambda: flash_attention_cuda_core(q, k, v, **kw)
    del out
    ms = in_turns({**fns, "sdpa": sdpa})
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                       reps=3, rounds=1)
    flops = 4 * hd * pairs * B * H
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / BF16_FLOPS_S, nbytes / HBM_BYTES_S
    bound = max(t_ops, t_bytes) * 1e3
    return {"ms": ms["tensor_core"], "cuda_core_ms": ms.get("cuda_core"),
            "plain_ms": plain_ms, "library_ms": ms["sdpa"],
            "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "pairs_per_bh": pairs,
            "bound_arithmetic": f"max({flops:.4g} flops / 989e12, "
                                f"{nbytes:.4g} B / 3.35e12) = "
                                f"max({t_ops * 1e3:.4g}, "
                                f"{t_bytes * 1e3:.4g}) ms",
            "tflops_per_s": {k: flops / (t * 1e-3) / 1e12
                             for k, t in ms.items()},
            "share_of_bound": {k: bound / t for k, t in ms.items()}}


def flash_times(dev) -> dict:
    """At qwen3-0.6b's served prefill shape: both flash kernels and SDPA in
    turns, the plain version, and the bound."""
    import torch
    B, S, H, Kv, hd = SERVE_BATCH, SERVE_PROMPT, 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(20262)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, Kv, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, Kv, hd, generator=gen, device=dev).bfloat16()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    return {"shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} bf16 causal",
            "library": "torch.nn.functional.scaled_dot_product_attention",
            **_flash_timing(q, k, v, sdpa, S * (S + 1) // 2, causal=True)}


def flash_serving_shape_times(dev) -> dict:
    """The tensor-core kernel at the shapes the new serving paths give it,
    each in turns with SDPA (and the CUDA-core kernel where it takes the
    head dim), the plain version and the bound from the call's own head
    dim: stablelm-3b's prefill (hd 80, B 8, S = T 2048, 32 heads over 32,
    causal), whisper-medium's encoder (B 8, S = T 1500, 16 heads, hd 64,
    not causal) and cross-attention prefill (S 416 over T 1500).
    ``chip_probes.py flash_tc_head_shapes`` times shapes no path runs."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(20264)
    out = {}
    for name, (B, S, T, H, Kv, hd, causal) in (
            ("stablelm-3b prefill", (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT,
                                     32, 32, 80, True)),
            ("whisper-medium encoder", (SERVE_BATCH, 1500, 1500, 16, 16, 64,
                                        False)),
            ("whisper-medium cross prefill", (SERVE_BATCH, WHISPER_PROMPT,
                                              1500, 16, 16, 64, False))):
        q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, T, Kv, hd, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, T, Kv, hd, generator=gen, device=dev).bfloat16()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        pairs = S * (S + 1) // 2 if causal else S * T
        out[name] = {
            "shape": f"B={B} S={S} T={T} H={H} Kv={Kv} hd={hd} bf16 "
                     + ("causal" if causal else "not causal"),
            "library": "torch.nn.functional.scaled_dot_product_attention",
            **_flash_timing(q, k, v, sdpa, pairs, causal=causal)}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def flash_core_f32_times(dev) -> dict:
    """The CUDA-core flash kernel on its own path, float32, at qwen3-0.6b's
    prefill shape and at pnpcoin-demo's (the chain trains it at seq_len
    32): in turns with SDPA on the same float32 inputs (its memory-efficient
    and its math backend, K and V repeated to H heads for both; products in
    full float32, TF32 off), the plain version, and the bound at the
    float32 rate (4 hd flops a causal (query, key) pair over 67e12; q, k,
    v and out once over 3.35e12). At pnpcoin-demo's size a launch is host-
    bound, so each is also timed replayed from a CUDA graph.
    ``library_ms`` is the faster SDPA backend among those within the
    float32 tolerance of the plain version."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda_core
    settings = {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision()}
    check(not settings["cuda.matmul.allow_tf32"]
          and settings["float32_matmul_precision"] == "highest",
          "float32 products in full float32 for the flash yardstick")
    gen = torch.Generator(device=dev).manual_seed(20267)
    tol = FLASH_TOL["float32"]
    out = {"settings": settings}
    for name, (B, S, H, Kv, hd) in {
            "qwen3-0.6b": (SERVE_BATCH, SERVE_PROMPT, 16, 8, 128),
            "pnpcoin-demo": (8, 32, 8, 4, 32)}.items():
        q = torch.randn(B, S, H, hd, generator=gen, device=dev)
        k = torch.randn(B, S, Kv, hd, generator=gen, device=dev)
        v = torch.randn(B, S, Kv, hd, generator=gen, device=dev)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        want = ref.flash_attention_ref(q, k, v, causal=True)
        got = flash_attention_cuda_core(q, k, v, causal=True)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=tol, atol=tol)
              and torch.equal(got, flash_attention_cuda_core(q, k, v,
                                                             causal=True)),
              f"CUDA-core flash float32 at {name} vs plain ({err}), "
              "equal from run to run")
        fns = {"cuda_core": lambda: flash_attention_cuda_core(
            q, k, v, causal=True)}
        sdpa_err = {}
        for backend in ("efficient", "math"):
            kernel = {"efficient": SDPBackend.EFFICIENT_ATTENTION,
                      "math": SDPBackend.MATH}[backend]

            def call(kernel=kernel):
                with sdpa_kernel(kernel):
                    return torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True)
            sdpa_err[backend] = float((call().transpose(1, 2) - want)
                                      .abs().max())
            fns[f"sdpa_{backend}"] = call
        del got
        ms = in_turns(fns)
        # a small launch's events measure the host; its graph, the card
        dev_ms = {key: graph_ms(fn) for key, fn in fns.items()} \
            if S <= 64 else None
        plain_ms = cuda_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True), reps=3, rounds=1)
        pairs = S * (S + 1) // 2
        flops = 4 * hd * pairs * B * H
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        t_ops, t_bytes = flops / F32_FLOPS_S, nbytes / HBM_BYTES_S
        bound = max(t_ops, t_bytes) * 1e3
        within = [b for b, e in sdpa_err.items() if e <= tol]
        check(bool(within), f"an SDPA backend within {tol} of the plain "
                            f"version at {name} ({sdpa_err})")
        library = min(within, key=lambda b: ms[f"sdpa_{b}"])
        out[name] = {
            "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} float32 causal",
            "ms": ms["cuda_core"], "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": ms[f"sdpa_{library}"],
            "library": f"scaled_dot_product_attention, {library} backend",
            "sdpa_ms": {b: ms[f"sdpa_{b}"] for b in sdpa_err},
            "device_ms_from_graph": dev_ms,
            "max_abs_err": err, "sdpa_max_abs_err_vs_plain": sdpa_err,
            "bound_arithmetic": f"max({flops:.4g} flops / 67e12, "
                                f"{nbytes:.4g} B / 3.35e12) = "
                                f"max({t_ops * 1e3:.4g}, "
                                f"{t_bytes * 1e3:.4g}) ms",
            "share_of_bound": {key: bound / t for key, t in ms.items()}}
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    return out


def flash_window_vs_plain(dev) -> dict:
    """Both flash kernels' local window at recurrentgemma's head shape (hd
    256, ten query heads over one KV head): window 0, 64 and 2048, ragged
    S = T in {33, 1000, 2500} at batch 2, float32 and bfloat16; and the
    served prefill's own shape (batch 8, S = T 4096, window 2048) in
    float32 and bfloat16."""
    import torch
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(20263)
    worst, served_out = {}, {}
    cases = [(2, w, n) for w in (0, 64, 2048) for n in (33, 1000, 2500)]
    served = (SERVE_BATCH, 2048, RG_PROMPT)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for batch, window, n in cases + [served]:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            q, k, v = randn(batch, n, 10, 256), randn(batch, n, 1, 256), \
                randn(batch, n, 1, 256)
            want = ref.flash_attention_ref(q, k, v, causal=True,
                                           window=window).float()
            seen = dict(worst)
            worst.clear()
            _flash_both(q, k, v, want, f"{name} hd=256 G=10 B={batch} "
                        f"window={window} S=T={n}", worst, causal=True,
                        window=window)
            if (batch, window, n) == served:
                served_out[name] = {
                    "max_abs_err": dict(worst),
                    "rms_of_plain": float(want.square().mean().sqrt())}
            for key, err in seen.items():
                worst[key] = max(worst.get(key, 0.0), err)
            del q, k, v, want
            torch.cuda.empty_cache()
    return {"cases": 2 * len(cases) + 2, "max_abs_err": worst,
            "tolerance": FLASH_TOL,
            "served_shape": {
                "shape": f"B={served[0]} S=T={served[2]} H=10 Kv=1 hd=256 "
                         f"window={served[1]}", **served_out}}


def decay_vs_plain(dev) -> dict:
    """The decay-scan kernel against its plain version: C in {1, 129,
    2560}, S in {1, 37, 4096}, with and without h0; the tiled kernel's
    chunk and tile edges (S in {0, 1, L - 1, L, L + 1, 2L + 3} for its
    chunk of L steps, C in {1, 31, 33, 129, 2560}, B 1 and 8, with and
    without h0); every case also equal bit for bit to the one-thread-a-chain
    kernel and to a second launch; and a chunked call equal to a whole
    one."""
    import torch
    from repro_torch.kernels import decay_scan, ops, ref
    gen = torch.Generator(device=dev).manual_seed(20264)
    worst, n = 0.0, 0
    L = DECAY_STEPS
    cases = [(2, c, s) for c in (1, 129, 2560) for s in (1, 37, 4096)]
    cases += [(b, c, s) for b in (1, 8) for c in (1, 31, 33, 129, 2560)
              for s in (0, 1, L - 1, L, L + 1, 2 * L + 3)]
    for batch, c, steps in cases:
        a = torch.rand((batch, steps, c), generator=gen, device=dev) * 0.7 \
            + 0.3
        b = torch.randn((batch, steps, c), generator=gen, device=dev)
        for h0 in (torch.randn((batch, c), generator=gen, device=dev), None):
            got, last = decay_scan.decay_scan_cuda(a, b, h0)
            again = decay_scan.decay_scan_cuda(a, b, h0)
            chain = decay_scan.decay_scan_cuda_per_chain(a, b, h0)
            what = f"decay scan B={batch} C={c} S={steps} " \
                   f"h0={h0 is not None}"
            check(torch.equal(got, again[0]) and torch.equal(last, again[1]),
                  what + ": two launches equal")
            check(torch.equal(got, chain[0]) and torch.equal(last, chain[1]),
                  what + ": equal to the one-thread-a-chain kernel")
            want = ref.decay_scan_ref(a, b, h0)
            want_last = want[:, -1] if steps else (
                h0 if h0 is not None else torch.zeros_like(last))
            if steps:
                worst = max(worst, float((got - want).abs().max()))
            check(torch.allclose(got, want, rtol=DECAY_TOL, atol=DECAY_TOL)
                  and torch.allclose(last, want_last, rtol=DECAY_TOL,
                                     atol=DECAY_TOL), what + " vs plain")
            n += 1
    a = torch.rand((3, 300, 2560), generator=gen, device=dev) * 0.7 + 0.3
    b = torch.randn((3, 300, 2560), generator=gen, device=dev)
    h0 = torch.randn((3, 2560), generator=gen, device=dev)
    whole, whole_last = ops.decay_scan(a, b, h0)
    parts, parts_last = ops.decay_scan(a, b, h0, seq_chunk=64)
    check(torch.allclose(parts, whole, rtol=DECAY_TOL, atol=DECAY_TOL)
          and torch.allclose(parts_last, whole_last, rtol=DECAY_TOL,
                             atol=DECAY_TOL), "decay scan chunked = whole")
    return {"cases": n + 1, "max_abs_err": worst, "tolerance": DECAY_TOL,
            "tile": {"steps": L, "channels": DECAY_CHANNELS},
            "equal_bits_to_per_chain_kernel": True,
            "equal_bits_launch_to_launch": True}


def sha_vs_hashlib(dev) -> dict:
    """The SHA-256 kernel against hashlib on every row: W = 1..20 (across
    the 55/56-byte edge where the length needs a second block), N not a
    multiple of the kernel's block of rows, raw, bswap and both, words at
    and above 2**31 in their int64 tensor as given; views that start 8
    bytes past a 16-byte boundary (the 8-byte loads); N = 0 (no launch)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref, sha256
    rng = np.random.RandomState(20268)
    n = SHA_BLOCK_ROWS * 3 + 17
    cases = 0
    for w in range(1, 21):
        host = rng.randint(0, 2**32, (n, w), dtype=np.uint64).astype(np.int64)
        host.flat[0], host.flat[-1] = 2**32 - 1, 2**31
        msg = torch.from_numpy(host).to(dev)
        want = {False: ref.sha256_words_hashlib(host),
                True: ref.sha256_words_hashlib(
                    ref.bswap32(torch.from_numpy(host)).numpy())}
        for raw, bswap in ((True, True), (True, False), (False, True)):
            got = sha256.sha256_rows_cuda(msg, raw=raw, bswap=bswap)
            for out, swap in zip(got, (False, True)):
                if out is not None:
                    check(np.array_equal(out.cpu().numpy(), want[swap]),
                          f"sha256 W={w} N={n} raw={raw} bswap={bswap} "
                          f"{'bswap' if swap else 'raw'} vs hashlib")
            cases += 1
    flat = torch.from_numpy(rng.randint(0, 2**32, 8 * 999 + 1,
                                        dtype=np.uint64).astype(np.int64))
    for w in (2, 4, 8):
        view = flat.to(dev)[1:].view(-1, w)
        check(view.data_ptr() % 16 == 8, "unaligned view")
        check(np.array_equal(
            sha256.sha256_rows_cuda(view)[0].cpu().numpy(),
            ref.sha256_words_hashlib(flat[1:].view(-1, w).numpy())),
            f"sha256 unaligned view at W={w} vs hashlib")
    before = sha256.launches
    empty = sha256.sha256_rows_cuda(
        torch.zeros((0, 3), dtype=torch.int64, device=dev), raw=True,
        bswap=True)
    check(sha256.launches == before
          and all(e.shape == (0, 8) for e in empty), "sha256 N = 0")
    return {"cases": cases + 4, "rows": n, "equal_to_hashlib": True}


def sha_kernels_a_call(dev) -> dict:
    """The CUDA kernels 5 ``sha256_rows_cuda`` calls run, counted by
    ``torch.profiler``. The last phase: once the profiler has traced, the
    host's cost of every later launch grows, which would move the
    host-bound timings and paths."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import sha256
    gen = torch.Generator(device=dev).manual_seed(20269)
    chunk = torch.randint(0, 2**32, (1 << 16, 2), generator=gen, device=dev,
                          dtype=torch.int64)
    sha256.sha256_rows_cuda(chunk, raw=True, bswap=True)
    torch.cuda.synchronize()
    # the profiler drops a kernel whose timestamp lands just outside its
    # window (chip_probes.py profiler_count counts how often): quiet time at
    # both ends keeps the five kernels inside
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_QUIET_S)
        for _ in range(5):
            sha256.sha256_rows_cuda(chunk, raw=True, bswap=True)
        torch.cuda.synchronize()
        time.sleep(PROFILER_QUIET_S)
    kernels = [e.name for e in prof.events()
               if e.device_type.name == "CUDA"]
    check(len(kernels) == 5
          and all("sha256_rows_kernel" in k for k in kernels),
          f"one CUDA kernel a sha256_rows_cuda call: {kernels}")
    return {"phase": "sha256_kernels_a_call", "calls": 5,
            "cuda_kernels": len(kernels), "kernel": kernels[0]}


# names of PyTorch's own attention kernels (SDPA's flash, memory-efficient
# and cuDNN backends): none may run on the training path
LIBRARY_ATTENTION = ("pytorch_flash", "fmha", "efficient_attention",
                     "mem_eff", "cudnn", "flash::")


def train_kernels_a_step(dev) -> dict:
    """The CUDA kernels of ``TRAIN_PROFILED`` pnpcoin-demo training steps
    (the workload's step, on the card), counted by ``torch.profiler`` in a
    window with quiet time at both ends: the flash forward's training
    instance, the backward's D, dK/dV and dQ kernels once a layer and step
    each (one chunk of key tiles), and no attention kernel of PyTorch's.
    Last, as the SHA-256 count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train import steps
    cfg = get_config("pnpcoin-demo")
    step = steps.make_train_step(cfg, steps.TrainHparams(warmup_steps=4,
                                                         total_steps=512))
    state = steps.make_train_state(cfg, random.key(0), dev)
    batch = SyntheticTokenPipeline(cfg, InputShape(
        f"chain{TRAIN_SEQ}x{TRAIN_BATCH}", TRAIN_SEQ, TRAIN_BATCH,
        "train")).microbatch(0, 0)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_QUIET_S)
        for _ in range(TRAIN_PROFILED):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        time.sleep(PROFILER_QUIET_S)
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    count = {"flash_fwd_kernel": 0, "dot_kernel": 0, "dkv_kernel": 0,
             "dq_kernel": 0}
    for name in names:
        for key in count:
            if key in name:
                count[key] += 1
    want = cfg.n_layers * TRAIN_PROFILED
    library = [n for n in names if any(t in n for t in LIBRARY_ATTENTION)]
    check(all(n == want for n in count.values()) and not library,
          f"{TRAIN_PROFILED} training steps: {want} launches of each hand "
          f"kernel and no library attention kernel: {count}, {library}")
    return {"phase": "train_kernels_a_step", "steps": TRAIN_PROFILED,
            "cuda_kernels": len(names), "hand_kernels": count,
            "library_attention_kernels": library}


def _hashlib_root(tree) -> str:
    """Root of one tree of (n, 8) uint32 leaf digests by hashlib alone."""
    level = [row.astype(">u4").tobytes() for row in tree]
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        buf = b"".join(level)
        level = [hashlib.sha256(buf[i:i + 64]).digest()
                 for i in range(0, len(buf), 64)]
    return level[0].hex()


def merkle_vs_plain(dev) -> dict:
    """The Merkle reduction kernel against its plain version (every level
    kept, and the last alone) and, through ``merkle_roots_from_digests``,
    against hashlib: 2**22 and 2**16 leaves, odd widths (65, 127, 2**16 +
    1, 3 x 2**14 + 5), forests of 4 trees of 2**16 and 8 of 2**18; each one
    launch, equal to a second launch, the workspace's counters zero after
    it; and a proof
    from the kernel's levels against ``core.ledger``'s hashlib proof."""
    import numpy as np
    import torch
    from repro_torch.core import ledger
    from repro_torch.kernels import merkle, native
    rng = np.random.RandomState(20270)
    # small reductions before large ones too: each leaves the tickets zero
    # for the next, whatever their sizes
    cases = [(1, 1 << 22), (1, 1 << 16), (1, 65), (1, 127),
             (1, (1 << 16) + 1), (1, 3 * (1 << 14) + 5), (4, 1 << 16),
             (8, 1 << 18)]
    worst, n_cases = 0, 0
    for B, n in cases:
        d = rng.randint(0, 2**32, (B, n, 8), dtype=np.uint64) \
            .astype(np.uint32)
        x = merkle._to_device(d, dev)
        for keep in (False, True):
            what = f"merkle B={B} n={n} keep_levels={keep}"
            before = merkle.launches
            got = merkle.merkle_reduce(x, keep_levels=keep)
            torch.cuda.synchronize()
            check(merkle.launches == before + 1, what + ": one launch")
            want = merkle._reduce_ref(x, keep)
            check(len(got) == len(want) == (len(merkle._widths(n)) if keep
                                             else 1), what + ": levels")
            for g, w in zip(got, want):
                worst = max(worst, int((g.long() - w.long()).abs().max()))
            check(worst == 0, what + " vs plain")
            again = merkle.merkle_reduce(x, keep_levels=keep)
            check(all(torch.equal(a, g) for a, g in zip(again, got)),
                  what + ": two launches equal")
            counters = merkle._workspace[(x.device.index,
                                          native.stream_of(x))][0]
            check(int(counters.count_nonzero()) == 0,
                  what + ": counters zero after the launch")
            n_cases += 1
        if n <= 1 << 17:
            check(merkle.merkle_roots_from_digests(d, device=dev)
                  == [_hashlib_root(t) for t in d], f"merkle B={B} n={n} "
                  "roots vs hashlib")
        del x, got, want, again
    # a proof from the kernel's kept levels against core.ledger's hashlib
    n = 3 * (1 << 14) + 5
    leaves = [rng.bytes(36) for _ in range(n)]
    root = ledger.merkle_root(leaves, backend="hashlib")
    check(merkle.merkle_root_device(leaves, device=dev) == root,
          "merkle root of 36-byte leaves vs hashlib")
    for i in (0, 1, n // 2, n - 2, n - 1):
        proof = merkle.merkle_proof_device(leaves, i, device=dev)
        check(proof == ledger.merkle_proof(leaves, i, backend="hashlib")
              and ledger.verify_merkle_proof(leaves[i], proof, root),
              f"merkle proof of leaf {i} of {n} vs hashlib")
    return {"cases": n_cases + 1, "max_abs_err": worst,
            "shapes": [f"B={B} n={n}" for B, n in cases],
            "proof_leaves": n, "equal_to_hashlib": True,
            "one_launch_a_reduction": True,
            "equal_bits_launch_to_launch": True}


def merkle_times(dev) -> dict:
    """A reduction of the mining path's 2**20 leaf digests (one tree, down
    to width 64) by events around 10 launches and replayed from a CUDA
    graph; the plain version; the bound (the leaf digests read and the top
    written once, as uint32; two compressions a parent, the second the
    padding block's)."""
    import numpy as np
    from repro_torch.kernels import merkle
    leaves = 1 << MAIN_BITS
    d = np.random.RandomState(20271).randint(
        0, 2**32, (1, leaves, 8), dtype=np.uint64).astype(np.uint32)
    x = merkle._to_device(d, dev)
    widths = merkle._widths(leaves)
    parents = sum(widths)

    def call():
        merkle.merkle_reduce(x)
    ms, dev_ms = cuda_ms(call), graph_ms(call)
    plain_ms = cuda_ms(lambda: merkle._reduce_ref(x, False), reps=3,
                       rounds=1)
    bound, by, arith = hash_bound_ms(4 * 8 * (leaves + widths[-1]), parents,
                                     pad_compressions=parents)
    return {"shape": f"(1, {leaves}, 8) -> width {widths[-1]}, "
                     f"{len(widths)} levels; ms per reduction",
            "levels": len(widths), "ms": ms, "device_ms_from_graph": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "bound_arithmetic": arith,
            "share_of_bound_from_graph": bound / dev_ms,
            "nodes_per_s_from_graph": parents / (dev_ms * 1e-3)}


def merkle_host_times(full) -> dict:
    """Host clock, synchronised, of ``FullResult.commit_root()`` over the
    mining path's 2**20 leaf digests, alone and split into its steps (the
    numpy view, the copy to the card, the reduction, the copy back, the
    hashlib top); and of ``recompute_roots_batched`` on the mining path's
    segment (the full block), with its hashlib spot-check apart. Medians
    of 5 (3 for the verify)."""
    import numpy as np
    import torch
    from repro_torch.core.ledger import merkle_root
    from repro_torch.core.verify import recompute_roots_batched
    from repro_torch.kernels import merkle
    dev = full.device
    steps = ("prepare_s", "copy_to_card_s", "reduce_s", "copy_back_s",
             "hashlib_top_s")

    def split():
        t = [time.perf_counter()]
        host = torch.from_numpy(np.ascontiguousarray(
            full.leaf_digests[None], dtype=np.uint32).view(np.int32))
        t.append(time.perf_counter())
        x = host.to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        top = merkle.merkle_reduce(x)[-1]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        top = merkle._to_host(top)[0]
        t.append(time.perf_counter())
        root = merkle._host_levels(merkle._words_to_digest_list(top))[-1][0]
        t.append(time.perf_counter())
        return root.hex(), [b - a for a, b in zip(t, t[1:])]

    def clock(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return out, statistics.median(times)

    root, total = clock(full.commit_root, 5)
    parts = [split() for _ in range(5)]
    check(all(r == root for r, _ in parts), "commit_root's steps give its root")
    roots, verify_s = clock(lambda: recompute_roots_batched([full],
                                                            device=dev), 3)
    check(roots == [root], "recompute_roots_batched gives the committed root")
    leaves = list(full.merkle_leaves)
    _, spot_s = clock(lambda: merkle_root(leaves, backend="hashlib"), 3)
    return {"leaves": int(full.leaf_digests.shape[0]),
            "commit_root_s": total,
            "commit_root_split_s": {
                k: statistics.median(p[i] for _, p in parts)
                for i, k in enumerate(steps)},
            "recompute_roots_batched_s": verify_s,
            "of_it_hashlib_spot_check_s": spot_s}


def _wkv_inputs(shape, dtype, gen, dev):
    import torch
    B, S, H, K, V = shape

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)
    r, k, v = randn(B, S, H, K), randn(B, S, H, K), randn(B, S, H, V)
    w = torch.sigmoid(randn(B, S, H, K)) * 0.5 + 0.5
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, randn(H, K),
            randn(B, H, K, V))


def wkv_vs_plain(dev) -> dict:
    """The WKV-6 kernel against its plain version: tests/test_kernels.py's
    TestWkv6 shapes, the serve head (B 8, H 64, K = V = 64) at S 64, head
    sizes that cut through the kernel's 16 x 4 register tiles (K != V, not
    multiples of 4 or 8: rows staged with plain loads), S at the edges of
    its 16-step chunks and a single head (B H = 1); float32 and bfloat16
    r, k, v, with and without s0; S = 1 launches in a row equal one launch
    over S."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6_cuda
    gen = torch.Generator(device=dev).manual_seed(20265)
    shapes = [(1, 5, 1, 4, 4), (2, 19, 3, 8, 8), (1, 33, 2, 16, 16),
              (8, 64, 64, 64, 64), (1, 17, 2, 5, 7), (2, 33, 3, 33, 17),
              (1, 40, 2, 63, 64), (1, 40, 2, 64, 1), (1, 15, 2, 64, 64),
              (1, 16, 2, 64, 64), (1, 17, 2, 64, 64), (1, 50, 1, 64, 64)]
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            r, k, v, w, u, s0 = _wkv_inputs(shape, dtype, gen, dev)
            for start in (s0, None):
                out, s_final = wkv6_cuda(r, k, v, w, u, start)
                want_o, want_s = ref.wkv6_ref(r, k, v, w, u, start)
                worst = max(worst, float((out - want_o).abs().max()),
                            float((s_final - want_s).abs().max()))
                check(torch.allclose(out, want_o, rtol=WKV_TOL, atol=WKV_TOL)
                      and torch.allclose(s_final, want_s, rtol=WKV_TOL,
                                         atol=WKV_TOL),
                      f"wkv6 {dtype} {shape} s0={start is not None} "
                      "vs plain")
                n += 1
    r, k, v, w, u, s0 = _wkv_inputs((8, 64, 64, 64, 64), torch.bfloat16,
                                    gen, dev)
    whole, whole_s = wkv6_cuda(r, k, v, w, u, s0)
    state, outs = s0, []
    for t in range(r.shape[1]):
        o, state = wkv6_cuda(*(x[:, t:t + 1].contiguous()
                               for x in (r, k, v, w)), u, state)
        outs.append(o)
    check(torch.allclose(torch.cat(outs, 1), whole, rtol=WKV_TOL,
                         atol=WKV_TOL)
          and torch.allclose(state, whole_s, rtol=WKV_TOL, atol=WKV_TOL),
          "wkv6: 64 launches of S = 1 equal one of S = 64")
    return {"cases": n + 1, "max_abs_err": worst, "tolerance": WKV_TOL}


def recurrent_times(dev) -> dict:
    """The decay scan, WKV-6 and windowed flash kernels (both flash kernels,
    in turns with SDPA), their plain versions, at the shapes the serving
    paths give them, with each bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_scan import (decay_scan_cuda,
                                                decay_scan_cuda_per_chain)
    from repro_torch.kernels.wkv6 import wkv6_cuda
    gen = torch.Generator(device=dev).manual_seed(20266)
    out = {}

    # decay scan: recurrentgemma's prefill, (8, 4096, 2560) from h0; the
    # tiled kernel and the one-thread-a-chain one in turns
    B, S, C = SERVE_BATCH, RG_PROMPT, 2560
    a = torch.rand((B, S, C), generator=gen, device=dev) * 0.7 + 0.3
    b = torch.randn((B, S, C), generator=gen, device=dev)
    h0 = torch.randn((B, C), generator=gen, device=dev)
    both = in_turns({
        "tiled": lambda: decay_scan_cuda(a, b, h0),
        "per_chain": lambda: decay_scan_cuda_per_chain(a, b, h0)})
    ms = both["tiled"]
    plain_ms = cuda_ms(lambda: ref.decay_scan_ref(a, b, h0), reps=3,
                       rounds=1)
    # a, b read and h written once (float32), h0 read and h_last written;
    # one FMA (2 flops) per element
    nbytes = 4 * (3 * a.numel() + 2 * h0.numel())
    flops = 2 * a.numel()
    bnd, by = max(nbytes / HBM_BYTES_S, flops / F32_FLOPS_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_S > flops / F32_FLOPS_S else \
        "operations"
    out["decay_scan"] = {
        "shape": f"B={B} S={S} C={C} float32, h0", "ms": ms,
        "per_chain_kernel_ms": both["per_chain"],
        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None,
        "bound_arithmetic": f"max({nbytes:.4g} B / 3.35e12, {flops:.4g} "
                            "flops / 67e12)",
        "share_of_bound": bnd / ms,
        "gb_per_s": nbytes / (ms * 1e-3) / 1e9}
    del a, b, h0

    # WKV-6: rwkv6-7b's prefill, r, k, v in bf16 and w in float32 as the
    # time mix makes them, from a state
    B, S, H, K, V = SERVE_BATCH, RWKV_PROMPT, 64, 64, 64
    r, k, v, w, u, s0 = _wkv_inputs((B, S, H, K, V), torch.bfloat16, gen,
                                    dev)
    ms = cuda_ms(lambda: wkv6_cuda(r, k, v, w, u, s0))
    plain_ms = cuda_ms(lambda: ref.wkv6_ref(r, k, v, w, u, s0), reps=3,
                       rounds=1)
    # bytes: r, k, v (bf16), w (f32) read and o (f32) written once, u, s0
    # read and s_final written. flops the function needs, per step: per
    # (k, v) k v, the FMA w S + k v and the FMA r S (5); per k u k and the
    # FMA of r . (u k) (3); per v the FMA that adds (r . (u k)) v (2). The
    # kernel as written does the same 5 per (k, v) and 3 per k (a_t); per
    # v the 3 adds that join its four partial sums and the FMA of a_t v
    # (5); per step the 8 adds of a_t's four-lane shuffle sum.
    nbytes = 2 * (r.numel() + k.numel() + v.numel()) + 4 * w.numel() \
        + 4 * B * S * H * V + 4 * (u.numel() + 2 * s0.numel())
    flops = B * H * S * (5 * K * V + 3 * K + 2 * V)
    flops_as_written = B * H * S * (5 * K * V + 3 * K + 5 * V + 8)
    t_b, t_o = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    dec_r, dec_k, dec_v, dec_w = (x[:, :1].contiguous() for x in (r, k, v, w))

    def decode_step():
        return wkv6_cuda(dec_r, dec_k, dec_v, dec_w, u, s0)
    decode_ms = cuda_ms(decode_step)
    decode_device_ms = graph_ms(decode_step)
    out["wkv6"] = {
        "shape": f"B={B} S={S} H={H} K=V={K}, r/k/v bf16, w float32, s0",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_b, t_o) * 1e3,
        "bound_by": "bytes" if t_b > t_o else "operations",
        "library_ms": None,
        "bound_arithmetic": f"max({nbytes:.4g} B / 3.35e12, {flops:.4g} "
                            f"flops / 67e12) = max({t_b * 1e3:.4g}, "
                            f"{t_o * 1e3:.4g}) ms",
        "tflops_per_s": flops / (ms * 1e-3) / 1e12,
        "kernel_flops_as_written": flops_as_written,
        "decode_step_ms": decode_ms,
        "decode_step_device_ms_from_graph": decode_device_ms}
    del r, k, v, w, u, s0

    # flash: recurrentgemma's prefill, window 2048, MQA, hd 256, bf16
    B, S, H, Kv, hd, window = SERVE_BATCH, RG_PROMPT, 10, 1, 256, 2048
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, Kv, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, Kv, hd, generator=gen, device=dev).bfloat16()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] > pos[:, None] - window)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    out["flash_attention_rg"] = {
        "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} bf16 causal "
                 f"window={window}",
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "(boolean band mask, enable_gqa)",
        **_flash_timing(q, k, v, sdpa, int(band.sum()), causal=True,
                        window=window)}
    return out


# The kernels a serving path may launch: the name of their entry in
# ``kernels.ops`` and, where the model overwrites one of its arguments in
# place after the call (a recurrent state in the cache), that argument's
# index, so a recorded launch keeps the value it was given.
SERVE_KERNELS = {"flash_attention": None, "wkv6": 5, "decay_scan": 2}
# each kernel's launch counter and the ``kernels.ops`` entry that reaches it
# (``ops.flash_attention`` reaches both flash kernels, by dtype and head dim)
def _counts() -> dict:
    """The hash kernels' launch counts and the verifier's hashlib
    fallbacks since the last ``_zero_counts``."""
    from repro_torch.core import verify
    from repro_torch.kernels import (decay_scan, flash_attention,
                                     flash_attention_tc, wkv6)
    counts = {name: mod.launches for name, mod in _launch_counters().items()}
    # the recurrences' backward kernels, counted in their modules
    counts["decay_scan_bwd"] = decay_scan.bwd_launches
    counts["wkv6_bwd"] = wkv6.bwd_launches
    # of each flash kernel's launches, its training instance's
    counts["flash_attention_training"] = flash_attention.lse_launches
    counts["flash_attention_tc_training"] = flash_attention_tc.lse_launches
    counts["hashlib_fallbacks"] = verify.hashlib_fallbacks
    return counts


def _zero_counts() -> None:
    from repro_torch.core import verify
    from repro_torch.kernels import (decay_scan, flash_attention,
                                     flash_attention_tc, wkv6)
    for mod in _launch_counters().values():
        mod.launches = 0
    decay_scan.bwd_launches = wkv6.bwd_launches = 0
    flash_attention.lse_launches = 0
    flash_attention_tc.lse_launches = 0
    verify.hashlib_fallbacks = 0


def _check_counts(counts: dict, sha: int, merkle: int, what: str) -> None:
    check(counts["sha256"] == sha and counts["merkle"] == merkle,
          f"{what}: {sha} SHA-256 and {merkle} Merkle launches, got {counts}")
    check(counts["hashlib_fallbacks"] == 0,
          f"{what}: hashlib fallback never fired")
    check(all(counts[k] == 0 for k in ENTRY_OF),
          f"{what}: no serving kernel launched")


def _timed_steps(wl, into: list) -> None:
    """Wrap a workload's mine/verify/reward so each call appends its host
    seconds (the card synchronised) to ``into`` as (step, seconds)."""
    import torch
    for step in ("mine", "verify", "reward"):
        def timed(*args, _orig=getattr(wl, step), _step=step):
            t = time.perf_counter()
            out = _orig(*args)
            torch.cuda.synchronize()
            into.append((_step, time.perf_counter() - t))
            return out
        setattr(wl, step, timed)


def _unsat_table(cnf, n: int):
    """Unsatisfied clauses for every assignment in [0, n), by numpy on the
    host in slices of 2**16."""
    import numpy as np
    out = np.empty(n, np.int64)
    shifts = np.arange(cnf.n_vars)
    for s in range(0, n, 1 << 16):
        a = np.arange(s, min(n, s + (1 << 16)), dtype=np.int64)
        bits = ((a[:, None] >> shifts) & 1).astype(np.bool_)
        lits = bits[:, cnf.cl_vars] ^ cnf.cl_neg
        out[s:s + len(a)] = (~lits.any(axis=2)).sum(axis=1)
    return out


# the per-chunk SHA-256 launches of a full-mode block over 2**20 args
CHUNKS = (1 << MAIN_BITS) // (1 << 16)
# SATLIB's uniform random 3-SAT set uf20-91: 20 variables, 91 clauses
SAT_VARS, SAT_CLAUSES, SAT_BLOCKS = 20, 91, 4
# the paper's §4 docking walkthrough at 2**20 pairs
DOCK_R, DOCK_P, DOCK_STEPS = 1024, 1024, 64


def sat_path(dev) -> dict:
    """SAT at uf20-91's size through ``Node``: ``SAT_BLOCKS`` blocks of 2**20
    assignments each, every block's table against numpy, each certificate
    the lowest satisfying assignment, each refutation's root against
    hashlib, then the node's batched audit. Launches: 16 SHA-256 and one
    Merkle reduction a block's mining (its self-verify runs none: a
    certificate is checked on the host, a refutation by hashlib and the
    quorum); the audit's batched verify one SHA-256 launch and one forest
    reduction for all refutations (one shape group), none for
    certificates."""
    import numpy as np
    import torch
    from repro_torch.chain import Node
    from repro_torch.chain.workloads import SatWorkload
    from repro_torch.core.ledger import merkle_root
    wl = SatWorkload(n_vars=SAT_VARS, n_clauses=SAT_CLAUSES, seed=0,
                     device=dev)
    steps = []
    _timed_steps(wl, steps)
    node = Node(device=dev, workloads={"sat": wl})
    _zero_counts()
    receipts = [node.mine_block("sat") for _ in range(SAT_BLOCKS)]
    torch.cuda.synchronize()
    mined = _counts()
    t = time.perf_counter()
    check(node.audit_chain(), "sat: the node audits its chain")
    audit_s = time.perf_counter() - t
    audited = _counts()
    kinds = ["certificate" if r.payload.certificate is not None
             else "refutation" for r in receipts]
    check("certificate" in kinds and "refutation" in kinds,
          f"sat: both a certificate and a refutation block in "
          f"{SAT_BLOCKS} blocks: {kinds}")
    n = 1 << SAT_VARS
    for k, r in enumerate(receipts):
        p, cnf = r.payload, wl.instance(k)[0]
        table = _unsat_table(cnf, n)
        check(np.array_equal(p.full.results[:, 0], table),
              f"sat block {k}: table vs numpy")
        if p.certificate is not None:
            witness = int(np.frombuffer(p.certificate, "<u4")[0])
            check(cnf.unsat_count(witness) == 0
                  and witness == int(np.argmax(table == 0)),
                  f"sat block {k}: certificate is the lowest satisfying "
                  "assignment")
        else:
            check(not (table == 0).any() and p.merkle_root == merkle_root(
                list(p.full.merkle_leaves), backend="hashlib"),
                f"sat block {k}: refutation root vs hashlib")
    n_refute = kinds.count("refutation")
    _check_counts(mined, CHUNKS * SAT_BLOCKS, SAT_BLOCKS, "sat mining")
    batched = int(n_refute > 0)
    _check_counts(audited, CHUNKS * SAT_BLOCKS + batched,
                  SAT_BLOCKS + batched, "sat mining and audit")
    return {"phase": "workloads", "part": "sat",
            "config": f"uf20-91 size: {SAT_VARS} variables, {SAT_CLAUSES} "
                      f"clauses, 2**{SAT_VARS} assignments a block",
            "blocks": kinds, "roots": [r.record.merkle_root for r in
                                       receipts],
            "mine_s": [s for k, s in steps if k == "mine"],
            "verify_s": [s for k, s in steps if k == "verify"],
            "reward_s": [s for k, s in steps if k == "reward"],
            "block_time_s": [r.block_time_s for r in receipts],
            "audit_chain_s": audit_s,
            "counts_mining": mined, "counts_with_audit": audited,
            "launches": {"sha256": audited["sha256"],
                         "merkle": audited["merkle"]}}


def _dock_matcher(r: int, p: int) -> int:
    """The docking matcher for one pair, in Python."""
    e = ((r ^ p) * 2654435761 & 0xFFFFFFFF) >> 16
    t, done = 0, False
    for _ in range(DOCK_STEPS):
        if not done and e > 100:
            e, t = e - (e >> 3) - 1, t + 1
        done = done or e <= 100
    return 0b10 if not done else (0b01 if t < 24 else 0b00)


def docking_path(dev) -> dict:
    """Docking at 1,024 receptors x 1,024 peptides through ``Node``: two
    blocks of 2**20 pairs, 4,096 sampled pairs against a Python loop of
    the matcher and the root against hashlib; the node's batched audit
    verifies the second block through ``verify_batch``'s dedup. Launches:
    16 SHA-256 and one Merkle reduction a block's mining; the audit one
    SHA-256 launch and one reduction for both (one representative)."""
    import numpy as np
    import torch
    from repro_torch.chain import Node
    from repro_torch.chain.workloads import DockingWorkload
    from repro_torch.core.ledger import merkle_root
    wl = DockingWorkload(n_r=DOCK_R, n_p=DOCK_P, seed=0,
                         max_steps=DOCK_STEPS, device=dev)
    steps = []
    _timed_steps(wl, steps)
    node = Node(device=dev, workloads={"docking": wl})
    _zero_counts()
    receipts = [node.mine_block("docking") for _ in range(2)]
    torch.cuda.synchronize()
    mined = _counts()
    t = time.perf_counter()
    check(node.audit_chain(), "docking: the node audits its chain")
    audit_s = time.perf_counter() - t
    audited = _counts()
    first, second = (r.payload for r in receipts)
    check(first.n_results == DOCK_R * DOCK_P and second.merkle_root
          == first.merkle_root and np.array_equal(
              first.full.packed_words(), second.full.packed_words()),
          "docking: two screenings of one bundle are byte-identical")
    _check_counts(mined, 2 * CHUNKS, 2, "docking mining")
    _check_counts(audited, 2 * CHUNKS + 1, 3,
                  "docking mining and audit (the second block deduped)")
    idx = np.random.RandomState(20272).choice(DOCK_R * DOCK_P, 4096,
                                              replace=False)
    rec, pep = wl.bundle.receptors, wl.bundle.peptides
    check(all(int(first.full.results[b, 0]) == _dock_matcher(
        int(rec[b % DOCK_R]), int(pep[b // DOCK_R])) for b in idx),
        "docking: 4,096 sampled pairs vs a Python loop of the matcher")
    check(first.merkle_root == merkle_root(list(first.full.merkle_leaves),
                                           backend="hashlib"),
          "docking: root vs hashlib")
    codes = {c: int((first.full.results[:, 0] == c).sum()) for c in (1, 0, 2)}
    return {"phase": "workloads", "part": "docking",
            "config": f"{DOCK_R} receptors x {DOCK_P} peptides, max_steps "
                      f"{DOCK_STEPS}",
            "binds": codes[1], "no_bind": codes[0], "not_terminated":
            codes[2], "root": first.merkle_root,
            "mine_s": [s for k, s in steps if k == "mine"],
            "verify_s": [s for k, s in steps if k == "verify"],
            "reward_s": [s for k, s in steps if k == "reward"],
            "audit_chain_s": audit_s,
            "counts_mining": mined, "counts_with_audit": audited,
            "launches": {"sha256": audited["sha256"],
                         "merkle": audited["merkle"]}}


def journal_path(dev, job) -> dict:
    """The journal at full size: a ``Node(store=ChainStore(file))`` mines
    a collatz full block over 2**20 args, a SAT block, a docking block and
    a Classic block over 2**20 nonces; ``Node.recover`` from the journal's
    bytes must reach the same tip and balances, and a copy with its last
    100 bytes torn off must adopt height 3 and resync from the first
    node. Launches, from the code: mining 3 x (16 SHA-256 + one
    reduction) and Classic's 2 + 2 (mine and replay); a recovery's replay
    one SHA-256 launch and one reduction for each full-mode family
    verified in a batch (collatz, docking and a SAT refutation; none for a
    certificate) and Classic's 2. The torn copy replays the first three
    blocks and checkpoints at height 3, so its resync re-verifies only the
    Classic block: the same counts as a whole recovery."""
    import torch
    from repro_torch.chain import ChainStore, Node
    from repro_torch.chain.workloads import DockingWorkload, SatWorkload

    def workloads():
        return {"sat": SatWorkload(n_vars=SAT_VARS, n_clauses=SAT_CLAUSES,
                                   seed=0, device=dev),
                "docking": DockingWorkload(n_r=DOCK_R, n_p=DOCK_P, seed=0,
                                           max_steps=DOCK_STEPS, device=dev)}

    path = ROOT / "build" / "chip_smoke.journal"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    store = ChainStore(path)
    append_s = []
    orig = store.append_commit

    def timed_append(*args):
        t = time.perf_counter()
        orig(*args)
        append_s.append(time.perf_counter() - t)
    store.append_commit = timed_append
    kw = {"device": dev, "classic_arg_bits": MAIN_BITS}
    node = Node(store=store, workloads=workloads(), **kw)
    node.submit(job)
    _zero_counts()
    for family in ("full", "sat", "docking", None):
        node.mine_block(family)
    torch.cuda.synchronize()
    mined = _counts()
    check([b.mode for b in node.ledger.blocks]
          == ["full", "sat", "docking", "classic"], "journal: block modes")
    sat_refutes = node.chain_payloads()[1].certificate is None
    _check_counts(mined, 3 * CHUNKS + 4, 3, "journal mining")
    data = store.to_bytes()
    fns = {job.name: job.fn}
    # (SHA-256, Merkle) launches to verify all four blocks in one batch
    replay = (4 + sat_refutes, 2 + sat_refutes)

    _zero_counts()
    t = time.perf_counter()
    back = Node.recover(ChainStore.from_bytes(data), jash_fns=fns,
                        workloads=workloads(), **kw)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t
    recovered = _counts()
    rep = back.last_recovery
    check((rep.replayed, rep.adopted_height, rep.truncated_records,
           rep.resynced_height) == (4, 4, 0, 4), f"journal: recovery {rep}")
    check(back.ledger.tip_hash == node.ledger.tip_hash
          and back.book.balances == node.book.balances,
          "journal: recovered tip and balances")
    _check_counts(recovered, *replay, "journal recovery")

    _zero_counts()
    t = time.perf_counter()
    torn = Node.recover(ChainStore.from_bytes(data[:-100]), peers=[node],
                        jash_fns=fns, workloads=workloads(), **kw)
    torch.cuda.synchronize()
    torn_s = time.perf_counter() - t
    torn_counts = _counts()
    rep2 = torn.last_recovery
    check((rep2.replayed, rep2.adopted_height, rep2.truncated_records,
           rep2.resynced_height) == (3, 3, 1, 4),
          f"journal: torn-tail recovery {rep2}")
    check(torn.ledger.tip_hash == node.ledger.tip_hash
          and torn.book.balances == node.book.balances,
          "journal: torn copy resynced to the same tip and balances")
    _check_counts(torn_counts, *replay, "journal torn recovery")
    size = path.stat().st_size
    path.unlink()
    return {"phase": "workloads", "part": "journal",
            "blocks": ["full", "sat", "docking", "classic"],
            "sat_block": "refutation" if sat_refutes else "certificate",
            "journal_mb": size / 1e6, "append_ms": [s * 1e3 for s in
                                                    append_s],
            "recover_s": recover_s, "torn_recover_and_resync_s": torn_s,
            "report": dataclasses.asdict(rep), "torn_report":
            dataclasses.asdict(rep2), "tip": node.ledger.tip_hash,
            "counts_mining": mined, "counts_recover": recovered,
            "counts_torn_recover": torn_counts,
            "launches": {k: mined[k] + recovered[k] + torn_counts[k]
                         for k in ("sha256", "merkle")}}


# the three roots and the tip (16 hex digits each) that the JAX package's
# examples/quickstart.py prints; tests/test_torch_store.py holds these to
# that script's output on the CPU
QUICKSTART_ROOTS = ("cde2262ddccba7dd", "fb3e4c62f8da6235",
                    "fb3e4c62f8da6235")
QUICKSTART_TIP = "5fa79f3f7d88bd2e"


def _printed_chain(out: str) -> dict:
    """The blocks (workload, result count, root) and the tip a quickstart
    printed; its RA timing and block times left out."""
    blocks = [ln.split(" mined+verified")[0] for ln in out.splitlines()
              if ln.startswith("block ")]
    tips = [ln.split("tip=")[1] for ln in out.splitlines() if "tip=" in ln]
    return {"blocks": blocks, "tip": tips}


def quickstart_path() -> dict:
    """``examples/torch_quickstart.py`` as a user runs it: on the card (no
    ``--device``), then with ``--device cpu``; the two print the same
    blocks and tip (the CPU tests hold the CPU run to the reference
    script's, whose roots and tip are ``QUICKSTART_ROOTS`` and
    ``QUICKSTART_TIP``). Launches on the card, from the code: the full block over
    2**10 args one SHA-256 chunk and one reduction; each Classic block 2
    SHA-256 launches to mine, the first 2 more to verify (the second's
    replay is memoised)."""
    import contextlib
    import io
    import runpy
    import torch
    script = ROOT / "examples" / "torch_quickstart.py"
    printed, counts, seconds = {}, None, {}
    for device in (None, "cpu"):
        argv = [str(script)] + (["--device", device] if device else [])
        buf, saved = io.StringIO(), sys.argv
        sys.argv = argv
        try:
            _zero_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(script), run_name="__main__")
            torch.cuda.synchronize()
            seconds[device or "cuda"] = time.perf_counter() - t
        finally:
            sys.argv = saved
        if device is None:
            counts = _counts()
        printed[device or "cuda"] = _printed_chain(buf.getvalue())
        check("ledger verified: True" in buf.getvalue(),
              f"quickstart on {device or 'the card'}: ledger verified")
    card = printed["cuda"]
    check(len(card["blocks"]) == 3 and len(card["tip"]) == 1
          and [b.split()[2] for b in card["blocks"]]
          == ["FULL", "CLASSIC", "CLASSIC"], f"quickstart blocks {card}")
    check(card == printed["cpu"], f"quickstart: the card's blocks and tip "
          f"equal the CPU's: {printed}")
    check(tuple(b.split("root=")[1].rstrip("…") for b in card["blocks"])
          == QUICKSTART_ROOTS and card["tip"][0].rstrip("…")
          == QUICKSTART_TIP, "quickstart: the reference script's roots and "
          "tip")
    _check_counts(counts, 1 + 2 + 2 + 2, 1, "quickstart on the card")
    return {"phase": "workloads", "part": "quickstart", **card,
            "seconds_by_device": seconds, "counts": counts,
            "launches": {"sha256": counts["sha256"],
                         "merkle": counts["merkle"]}}


ENTRY_OF = {"flash_attention": "flash_attention",
            "flash_attention_tc": "flash_attention",
            "flash_attention_bwd": "flash_attention",
            "flash_attention_tc_bwd": "flash_attention",
            "flash_attention_mma_bwd": "flash_attention", "wkv6": "wkv6",
            "wkv6_bwd": "wkv6", "decay_scan": "decay_scan",
            "decay_scan_bwd": "decay_scan"}


def _launch_counters():
    from repro_torch.kernels import (decay_scan, flash_attention,
                                     flash_attention_bwd,
                                     flash_attention_mma_bwd,
                                     flash_attention_tc,
                                     flash_attention_tc_bwd, merkle, sha256,
                                     wkv6)
    return {"sha256": sha256, "merkle": merkle,
            "flash_attention": flash_attention,
            "flash_attention_tc": flash_attention_tc,
            "flash_attention_bwd": flash_attention_bwd,
            "flash_attention_tc_bwd": flash_attention_tc_bwd,
            "flash_attention_mma_bwd": flash_attention_mma_bwd,
            "wkv6": wkv6, "decay_scan": decay_scan}


def _by_entry(per_kernel: dict) -> dict:
    """Launch counts by kernel -> by the ``kernels.ops`` entry."""
    out = {}
    for name, n in per_kernel.items():
        if name in ENTRY_OF:
            out[ENTRY_OF[name]] = out.get(ENTRY_OF[name], 0) + n
    return out


def _against_plain(name, args, kw, out) -> float:
    """A launch recorded on a serving path against the plain version on the
    same inputs; returns the max abs error, raises past the tolerance."""
    import torch
    from repro_torch.kernels import ref
    if name == "flash_attention":
        q = args[0]
        tol = FLASH_TOL[str(q.dtype).split(".")[1]]
        pairs = [(out, ref.flash_attention_ref(*args, **kw))]
    elif name == "wkv6":
        tol, (want_o, want_s) = WKV_TOL, ref.wkv6_ref(*args)
        pairs = [(out[0], want_o), (out[1], want_s)]
    else:
        tol, want = DECAY_TOL, ref.decay_scan_ref(*args)
        pairs = [(out[0], want), (out[1], want[:, -1])]
    err = 0.0
    for got, want in pairs:
        got, want = got.float(), want.float()
        err = max(err, float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=tol, atol=tol),
              f"served {name} launch vs plain ({err})")
    return err


def _call_site(name: str, args, kw) -> str:
    """Where on a serving path a kernel was called: flash attention by its
    mask and shape (a causal self-attention; not causal with S = T, an
    encoder's; with S != T, a cross-attention's prefill; with S = 1, a
    cross-attention's decode step), the other kernels by name."""
    if name != "flash_attention":
        return name
    S, T = args[0].shape[1], args[1].shape[1]
    if kw.get("causal"):
        return "causal"
    return ("not causal, S = 1" if S == 1 else
            "not causal, S = T" if S == T else "not causal, S != T")


def serve_path(dev, arch: str, prompt: int, per_prefill: dict,
               per_decode: dict, small_counts: dict,
               small_layers: int = 0, flash_sites: int = 1) -> dict:
    """One serving path at full width and depth through
    ``repro_torch.launch.serve.main``, with every kernel's launch count
    read around it and checked against ``per_prefill`` + ``per_decode`` x
    the decode steps (0 for a kernel not named); the first and last launch
    of each kernel at each of its call sites (``_call_site``;
    ``flash_sites`` of flash attention's) held against its plain version;
    then a warm run timed, with the kernels of its prefill (and of a
    decode step, where one launches any) timed by CUDA events; then
    ``reduced_vs_cpu``."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_config(arch)
    counters = _launch_counters()
    real = {name: getattr(ops, name) for name in SERVE_KERNELS}
    # (kernel, call site) -> its first and latest launch, and its launches
    seen, by_site = {}, {}

    def recording(name):
        state_at = SERVE_KERNELS[name]

        def call(*args, **kw):
            out = real[name](*args, **kw)
            if state_at is not None and args[state_at] is not None:
                args = list(args)
                args[state_at] = args[state_at].clone()
            kw.pop("seq_chunk", None)
            site = (name, _call_site(name, args, kw))
            calls = seen.setdefault(site, [])
            calls[1 if calls else 0:] = [(tuple(args), kw, out)]
            by_site[site] = by_site.get(site, 0) + 1
            return out
        return call

    def patched(make):
        for name in SERVE_KERNELS:
            setattr(ops, name, make(name))

    def restore():
        for name, fn in real.items():
            setattr(ops, name, fn)

    argv = ["--arch", arch, "--reduced", "0", "--batch", str(SERVE_BATCH),
            "--prompt-len", str(prompt), "--new-tokens", str(SERVE_NEW)]
    for mod in counters.values():
        mod.launches = 0
    patched(recording)
    try:
        res = serve.main(argv)
        torch.cuda.synchronize()
    finally:
        restore()
    counts = {name: mod.launches for name, mod in counters.items()}
    want = {name: per_prefill.get(name, 0)
            + (SERVE_NEW - 1) * per_decode.get(name, 0) for name in counters}
    check(counts == want, f"{arch}: launch counts {counts}, expected {want}")
    check(res.tokens.shape == (SERVE_BATCH, SERVE_NEW), "generated shape")
    check(int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size, "token ids in vocab")
    check(bool(torch.isfinite(res.last_logits).all()), "logits finite")
    check(res.last_logits.shape == (SERVE_BATCH, 1, cfg.padded_vocab),
          "logits shape")
    launch_err, entry_counts = {}, _by_entry(counts)
    for name in SERVE_KERNELS:
        n = entry_counts.get(name, 0)
        sites = [site for site in seen if site[0] == name]
        want_sites = flash_sites if name == "flash_attention" else 1
        check(len(sites) == (want_sites if n else 0)
              and sum(by_site[site] for site in sites) == n,
              f"{arch}: {name} launched at {want_sites} call sites, "
              f"{n} times: {by_site}")
    for site, calls in seen.items():
        check(len(calls) == min(by_site[site], 2),
              f"{arch}: first and last {site} launch recorded")
        launch_err[" / ".join(site)] = [_against_plain(site[0], *c)
                                        for c in calls]
        torch.cuda.empty_cache()
    seen.clear()
    first = {"prefill_ms": res.prefill_s * 1e3,
             "decode_ms_per_token": res.decode_s_per_token * 1e3,
             "tokens_row0": res.tokens[0].tolist()}
    del res
    torch.cuda.empty_cache()

    # warm run: the same serve call, the kernels of its prefill timed
    entry_prefill, entry_want = _by_entry(per_prefill), _by_entry(want)
    events = {name: [] for name in entry_prefill}

    def timing(name):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kw)
            end.record()
            if name in events:
                events[name].append((start, end))
            return out
        return call

    torch.cuda.reset_peak_memory_stats()
    patched(timing)
    try:
        warm = serve.serve(cfg, batch=SERVE_BATCH, prompt_len=prompt,
                           new_tokens=SERVE_NEW, device=dev)
        torch.cuda.synchronize()
    finally:
        restore()
    check(warm.tokens[0].tolist() == first["tokens_row0"],
          f"{arch}: warm run generates the same tokens")
    # prefill launches come first, then one set per decode step
    kernel_ms = {name: sum(a.elapsed_time(b)
                           for a, b in events[name][:entry_prefill[name]])
                 for name in entry_prefill}
    check(all(len(events[name]) == entry_want[name]
              for name in entry_prefill), f"{arch}: warm run launch counts")
    timing_out = {
        "warm_prefill_ms": warm.prefill_s * 1e3,
        "warm_kernel_ms_in_prefill": kernel_ms,
        "kernel_share_of_warm_prefill":
            sum(kernel_ms.values()) / (warm.prefill_s * 1e3),
        "warm_decode_ms_per_token": warm.decode_s_per_token * 1e3,
        "warm_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    for name in _by_entry(per_decode):
        decode_events = events[name][entry_prefill[name]:]
        timing_out[f"warm_{name}_ms_per_decode_step"] = sum(
            a.elapsed_time(b) for a, b in decode_events) / (SERVE_NEW - 1)
    del warm, events
    torch.cuda.empty_cache()
    return {"phase": "serve", "arch": arch, "batch": SERVE_BATCH,
            "prompt": prompt, "new_tokens": SERVE_NEW, "dtype": cfg.dtype,
            "counts": counts,
            "launches_by_call_site": {" / ".join(k): n
                                      for k, n in by_site.items()},
            **first, **timing_out,
            "launch_vs_plain_max_abs_err": {
                k: v for k, v in launch_err.items() if v},
            **reduced_vs_cpu(dev, arch, small_counts, small_layers)}


def reduced_vs_cpu(dev, arch: str, small_counts: dict,
                   small_layers: int = 0) -> dict:
    """The reduced float32 ``arch`` (``small_layers`` layers if given)
    served on the card, its launch counts read around it and checked
    against ``small_counts``, and on the CPU from the same weights: tokens
    equal, logits within 1e-4, and every MoE layer's expert choices equal
    (where one differs, the failure names the gap between the two
    experts' router probabilities on the CPU)."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    counters = _launch_counters()
    small = reduced(get_config(arch))
    if small_layers:
        small = dataclasses.replace(small, n_layers=small_layers)
    params = build_model(small).init(torch.Generator().manual_seed(1))
    cross = params.get("groups", {}).get("cross")
    if cross is not None:
        # the init's cross-layer gates are 0, where the image path adds
        # nothing; a draw in [0.5, 1) lets the comparison hold that path
        cross["gate"] = 0.5 + 0.5 * torch.rand(
            cross["gate"].shape, generator=torch.Generator().manual_seed(2))

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}
    real_route = moe.route
    routes = {"card": [], "cpu": []}

    def serve_on(where, device, weights):
        def route(router, xt, top_k):
            out = real_route(router, xt, top_k)
            routes[where].append((out[0].cpu(), out[2].cpu()))
            return out
        moe.route = route
        try:
            return serve.serve(small, device=device, params=weights,
                               batch=2, prompt_len=100, new_tokens=8, seed=1)
        finally:
            moe.route = real_route
    for mod in counters.values():
        mod.launches = 0
    on_card = serve_on("card", dev, to(params, dev))
    torch.cuda.synchronize()
    small_launches = {name: mod.launches for name, mod in counters.items()
                      if mod.launches or name in small_counts}
    check(small_launches == small_counts,
          f"reduced {arch}: launch counts {small_launches}, expected "
          f"{small_counts}")
    on_cpu = serve_on("cpu", "cpu", params)
    check(len(routes["card"]) == len(routes["cpu"])
          == (small.n_layers * 8 if small.family == "moe" else 0),
          f"reduced {arch}: the router ran once a layer and step")
    for call, ((_, i_card), (probs, i_cpu)) in enumerate(
            zip(routes["card"], routes["cpu"])):
        if not torch.equal(i_card, i_cpu):
            t, j = (i_card != i_cpu).nonzero()[0].tolist()
            gap = float(probs[t, i_card[t, j]] - probs[t, i_cpu[t, j]])
            check(False, f"reduced {arch}: router call {call}, token {t}: "
                         f"expert {int(i_card[t, j])} on the card, "
                         f"{int(i_cpu[t, j])} on the CPU, probability gap "
                         f"{gap} on the CPU")
    small_err = float((on_card.last_logits.cpu() - on_cpu.last_logits)
                      .abs().max())
    check(torch.equal(on_card.tokens.cpu(), on_cpu.tokens),
          f"reduced {arch}: card and CPU tokens equal")
    check(small_err <= 1e-4, f"reduced {arch}: logits within 1e-4 "
                             f"({small_err})")
    out = {"reduced_model": f"{small.name}, {small.n_layers} layers",
           "reduced_counts": small_launches,
           "reduced_card_vs_cpu_max_abs_err": small_err}
    if cross is not None:
        # the image reaches the logits: without its projection they move
        blind = serve.serve(small, device="cpu",
                            params={**params,
                                    "img_proj": torch.zeros_like(
                                        params["img_proj"])},
                            batch=2, prompt_len=100, new_tokens=8, seed=1)
        moved = float((blind.last_logits - on_cpu.last_logits).abs().max())
        check(moved > 1e-2, f"reduced {arch}: the image moves the logits "
                            f"({moved})")
        out["reduced_logits_moved_by_the_image"] = moved
    if routes["card"]:
        out["reduced_router_calls_with_equal_choices"] = len(routes["card"])
    return out


# the flash backward's cases: (B, S, T, H, Kv, causal, window), at each head
# dim it takes; S and T off its tiles (both passes 64 queries x 64 keys at
# hd 64 and 128, 32 x 16 at hd 32): 1, a tile +- 1 and 2 BK + 1; GQA and
# MQA (G = 1, 2, 4, 16), causal or not, windows across a tile's edge, S !=
# T both ways, rows that see no key (S 100 over T 40 with a window of 20).
# On those rows the forward's log-sum-exp is the plain version's sentinel,
# -1e30; the log-sum-exp and the gradients are compared on every row
BWD_CASES = [(2, 33, 33, 4, 2, True, 0), (1, 100, 100, 8, 1, True, 0),
             (2, 70, 150, 4, 2, False, 0), (1, 150, 70, 4, 4, True, 0),
             (2, 90, 90, 4, 4, True, 17), (4, 32, 32, 8, 4, True, 0),
             (1, 64, 64, 2, 1, True, 32), (2, 31, 31, 2, 1, True, 0),
             (1, 32, 65, 4, 2, False, 0), (2, 97, 97, 4, 1, False, 20),
             (1, 129, 129, 2, 2, True, 0), (1, 200, 200, 2, 1, True, 64),
             (3, 1, 1, 2, 1, True, 0), (1, 257, 257, 8, 2, True, 0),
             (2, 1, 129, 4, 2, False, 0), (1, 15, 15, 2, 2, True, 0),
             (1, 65, 65, 4, 1, True, 0), (1, 127, 127, 4, 2, True, 0),
             (2, 129, 65, 4, 2, False, 0), (1, 63, 129, 4, 2, False, 0),
             (1, 33, 17, 2, 1, False, 0), (1, 257, 2, 2, 1, False, 0),
             (1, 200, 200, 2, 1, True, 70), (1, 100, 40, 2, 1, True, 20),
             (1, 129, 129, 16, 1, True, 0), (1, 65, 129, 16, 1, False, 33)]


def flash_bwd_vs_plain(dev) -> dict:
    """The flash backward against its plain twin (``ref.
    flash_attention_bwd_ref``) on the same q, k, v, output, row
    log-sum-exp and output gradient, within ``BWD_TOL`` times each
    tensor's largest entry (at least 1), and bit-equal to a second
    launch: ``BWD_CASES`` at head dims 16, 32, 64 and 128, then
    pnpcoin-demo's training calls (the model_train chain's, a full-mode
    PoUW step's and an ES candidate's) and qwen3-0.6b's prefill shape in
    float32 (causal),
    where the kernel and the twin are also held against the twin's math
    in float64 (output and log-sum-exp recomputed in float64). The
    forward's training instance gives the output and log-sum-exp, its
    output bit-equal to the serving instance's (and, at the paths' calls,
    within ``FLASH_TOL`` of the plain one's), and its log-sum-exp within
    1e-5 of the plain one's on every row (-1e30 on a row that sees no
    key)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(20268)
    cases = [(B, S, T, H, Kv, hd, causal, window)
             for hd in (16, 32, 64, 128)
             for B, S, T, H, Kv, causal, window in BWD_CASES]
    path_calls = (DEMO_ATTN, POUW_ATTN, ES_ATTN, QWEN_F32_ATTN)
    for B, S, H, Kv, hd in path_calls:
        cases.append((B, S, S, H, Kv, hd, True, 0))
    worst = {"abs": 0.0, "rel": 0.0, "lse": 0.0, "out": 0.0}
    float64 = {}
    for B, S, T, H, Kv, hd, causal, window in cases:
        label = f"B={B} S={S} T={T} H={H} Kv={Kv} hd={hd} causal={causal} " \
                f"window={window}"
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for shape in
                   ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))
        o, lse = fa.flash_attention_lse_cuda(q, k, v, causal=causal,
                                             window=window)
        check(torch.equal(o, fa.flash_attention_cuda_core(
            q, k, v, causal=causal, window=window)),
            f"flash training instance's output = serving instance's, {label}")
        if (B, S, H, Kv, hd) in path_calls and S == T:
            want_o = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
            out_err = float((o - want_o).abs().max())
            worst["out"] = max(worst["out"], out_err)
            check(torch.allclose(o, want_o, rtol=FLASH_TOL["float32"],
                                 atol=FLASH_TOL["float32"]),
                  f"flash training instance's output vs plain ({out_err}), "
                  f"{label}")
            del want_o
        want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                               window=window)
        lse_err = float((lse - want_lse).abs().max())
        check(torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5),
              f"flash log-sum-exp vs plain ({lse_err}), {label}")
        do = torch.randn(o.shape, generator=gen, device=dev)
        got = fb.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                          window=window)
        again = fb.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            causal=causal, window=window)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash backward: two launches equal, {label}")
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window)
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            scale = max(1.0, float(w.abs().max()))
            worst["abs"] = max(worst["abs"], err)
            worst["rel"] = max(worst["rel"], err / scale)
            check(err <= BWD_TOL * scale,
                  f"flash backward vs plain ({err}, scale {scale}), {label}")
        worst["lse"] = max(worst["lse"], lse_err)
        if (B, S, H, Kv, hd) == QWEN_F32_ATTN:
            q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
            scores = _scores_f64(q64, k64)
            o64 = torch.einsum("bhst,bthd->bshd", scores.softmax(-1),
                               v64.repeat_interleave(H // Kv, 2))
            lse64 = scores.logsumexp(-1)
            del scores
            exact = _bwd_f64(q64, k64, v64, o64, lse64, do64)
            float64 = {
                "kernel_vs_float64": [float((g.double() - e).abs().max())
                                      for g, e in zip(got, exact)],
                "twin_vs_float64": [float((w.double() - e).abs().max())
                                    for w, e in zip(want, exact)]}
            del q64, k64, v64, do64, o64, lse64, exact
        del q, k, v, o, lse, do, got, again, want
    torch.cuda.empty_cache()
    return {"cases": len(cases),
            "tolerance": f"max |kernel - twin| <= {BWD_TOL} max(1, max "
                         "|twin|), each of dQ, dK, dV",
            "max_abs_err": worst["abs"],
            "max_err_over_scale": worst["rel"],
            "lse_max_abs_err": worst["lse"],
            "forward_output_max_abs_err": worst["out"],
            "qwen3_shape_dq_dk_dv_max_abs_err_vs_float64": float64}


def _scores_f64(q, k):
    """Causal scaled scores (B, H, S, T) in float64, K repeated over each
    KV head's query heads, masked with -inf."""
    import torch
    g = q.shape[2] // k.shape[2]
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(g, 2)) \
        / q.shape[-1] ** 0.5
    return s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                    device=q.device).triu(1), float("-inf"))


def _bwd_f64(q, k, v, o, lse, do):
    """``ref.flash_attention_bwd_ref``'s steps in float64, causal."""
    import torch
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    g = H // Kv
    kf, vf = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bshd,bthd->bhst", q, kf) / hd ** 0.5
    keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                      device=q.device).tril()
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    d = (do * o).sum(-1).transpose(1, 2)
    dv = torch.einsum("bhst,bshd->bthd", p, do)
    ds = p * (torch.einsum("bshd,bthd->bhst", do, vf) - d[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) / hd ** 0.5
    dk = torch.einsum("bhst,bshd->bthd", ds, q) / hd ** 0.5
    return (dq, dk.reshape(B, S, Kv, g, hd).sum(3),
            dv.reshape(B, S, Kv, g, hd).sum(3))


def peak_extra_bytes(fn) -> int:
    """The most device memory ``fn()`` allocates over what was allocated
    before it (its outputs and workspaces), by the caching allocator's
    peak."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def flash_bwd_times(dev) -> dict:
    """The flash backward at pnpcoin-demo's training calls (the
    model_train workload's, and a full-mode PoUW step's at batch 16 of 128
    tokens), pnpcoin-micro's (hd 16, also from a graph), qwen3-0.6b's
    prefill shape in float32 and the same heads at
    S = T = 4096 (past the
    cap on dS, so in chunks of key tiles), causal: by events (10 calls in
    a row) and replayed from a CUDA graph, in turns with SDPA's
    memory-efficient backward on the same float32 inputs (K and V repeated
    to H heads, leaf tensors, so only the attention's backward runs), the
    plain twin, and the bound: 5 products of hd FMAs (2 flops each) per
    (query, key) pair of the causal half at 67 TFLOP/s, against q, k, v,
    o, dO, the log-sum-exp read and dQ, dK, dV written once at 3.35 TB/s.
    Each call's peak device memory over its inputs, the kernel's and
    SDPA's. At S = 4096 the kernel is held against the twin on batch row 0
    (the twin's float32 scores of all 8 rows would take ~9 GB a tensor)
    and two launches must be bit-equal; the twin is not timed there. Also
    the forward's training instance (with the log-sum-exp) in turns with
    its serving instance and SDPA's efficient forward, and the forward's
    bound (2 products of the causal half; q, k, v read, o and the
    log-sum-exp written once)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(20269)
    out = {}
    for name, (B, S, H, Kv, hd) in (("pnpcoin-demo", DEMO_ATTN),
                                    ("pnpcoin-micro", MICRO_ATTN),
                                    ("pnpcoin-demo PoUW", POUW_ATTN),
                                    ("qwen3-0.6b", QWEN_F32_ATTN),
                                    ("qwen3-0.6b S=T=4096", CHUNKED_ATTN)):
        chunked = (B, S, H, Kv, hd) == CHUNKED_ATTN
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for shape in
                   ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
        o, lse = fa.flash_attention_lse_cuda(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=gen, device=dev)
        pairs = S * (S + 1) // 2
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for x in (k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sd_out = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()

        def kernel():
            return fb.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                               causal=True)

        def sdpa():
            return torch.autograd.grad(sd_out, (qt, kt, vt), dot,
                                       retain_graph=True)
        peak = {"kernel": peak_extra_bytes(kernel),
                "sdpa_efficient": peak_extra_bytes(sdpa)}
        dq_sdpa = sdpa()[0].transpose(1, 2)
        dq = kernel()[0]
        sdpa_err = float((dq_sdpa - dq).abs().max())
        check(torch.allclose(dq_sdpa, dq, rtol=1e-4, atol=1e-4),
              f"SDPA's backward agrees with the kernel's dQ at {name} "
              f"({sdpa_err})")
        del dq_sdpa
        twin_err = None
        if chunked:
            got, again = kernel(), kernel()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash backward: two launches equal at {name}")
            del again
            want = ref.flash_attention_bwd_ref(
                q[:1], k[:1], v[:1], o[:1], lse[:1], do[:1], causal=True)
            twin_err = []
            for g, w in zip(got, want):
                err = float((g[:1] - w).abs().max())
                scale = max(1.0, float(w.abs().max()))
                twin_err.append(err)
                check(err <= BWD_TOL * scale,
                      f"flash backward vs plain on batch row 0 ({err}, "
                      f"scale {scale}) at {name}")
            del got, want
            torch.cuda.empty_cache()
        ms = in_turns({"kernel": kernel, "sdpa_efficient": sdpa})
        dev_ms = graph_ms(kernel)
        sdpa_dev_ms = sdpa_backward_graph_ms(qt, kt, vt, dot) \
            if name.startswith(("pnpcoin-demo", "pnpcoin-micro")) else None
        plain_ms = None if chunked else cuda_ms(
            lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                causal=True),
            reps=1, rounds=1)
        def sdpa_forward():
            with torch.no_grad(), sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
        fwd = in_turns({
            "training_instance": lambda: fa.flash_attention_lse_cuda(
                q, k, v, causal=True),
            "serving_instance": lambda: fa.flash_attention_cuda_core(
                q, k, v, causal=True),
            "sdpa_efficient": sdpa_forward})
        # the forward's bound: 2 products of the causal half, against q,
        # k, v read and o, lse written once
        f_ops = 2 * 2 * hd * pairs * B * H / F32_FLOPS_S
        f_bytes = 4 * (2 * q.numel() + 2 * k.numel() + lse.numel()) \
            / HBM_BYTES_S
        flops = 5 * 2 * hd * pairs * B * H
        nbytes = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel())
        t_ops, t_bytes = flops / F32_FLOPS_S, nbytes / HBM_BYTES_S
        bound = max(t_ops, t_bytes) * 1e3
        out[name] = {
            "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} float32 causal",
            "ms": ms["kernel"], "device_ms_from_graph": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": ms["sdpa_efficient"],
            "library_ms_from_graph": sdpa_dev_ms,
            "library": "scaled_dot_product_attention backward, efficient "
                       "backend",
            "sdpa_dq_max_abs_err": sdpa_err,
            "bound_arithmetic": f"max({flops:.4g} flops / 67e12, "
                                f"{nbytes:.4g} B / 3.35e12) = "
                                f"max({t_ops * 1e3:.4g}, "
                                f"{t_bytes * 1e3:.4g}) ms",
            "share_of_bound": bound / ms["kernel"],
            "peak_bytes_over_inputs": peak,
            "ds_cap_bytes": fb.DS_CAP_BYTES,
            "forward_training_instance_ms": fwd["training_instance"],
            "forward_serving_instance_ms": fwd["serving_instance"],
            "forward_library_ms": fwd["sdpa_efficient"],
            "forward_bound_ms": max(f_ops, f_bytes) * 1e3,
            "forward_bound_by": "operations" if f_ops > f_bytes
                                else "bytes"}
        if chunked:
            out[name]["batch_row_0_vs_plain_max_abs_err"] = twin_err
        del q, k, v, o, lse, do, qt, kt, vt, sd_out, dot, dq
        torch.cuda.empty_cache()
    return out


def sdpa_backward_graph_ms(qt, kt, vt, dot, reps=10,
                           backend="efficient") -> float:
    """SDPA's efficient backward (``backend=None``: its default backend)
    on leaf tensors qt, kt, vt (B, H, S, hd) with output gradient dot,
    causal, replayed from a CUDA graph of ``reps`` backward calls (its
    forward runs once, outside the graph, on the capturing stream, so
    autograd launches the backward there)."""
    import contextlib
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # leaves and gradient made on the capturing stream too, so no node
        # of the backward waits on the default stream
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (qt, kt, vt)]
        grad = dot.clone()
        with (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if backend
              else contextlib.nullcontext()):
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=True)
        for _ in range(3):
            torch.autograd.grad(out, leaves, grad, retain_graph=True)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            torch.autograd.grad(out, leaves, grad, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    return cuda_ms(graph.replay, reps=1) / reps


def flash_tc_bwd_vs_plain(dev) -> dict:
    """The bf16 tensor-core backward against its plain twin (``ref.
    flash_attention_bwd_ref`` on the same bf16 q, k, v, output, row
    log-sum-exp and output gradient, in float32, cast to bf16) within
    ``TC_BWD_TOL`` times each tensor's largest entry (at least 1), and
    bit-equal to a second launch: ``TC_BWD_CASES`` at head dims 64 and 128
    and the training step's call ``CLI_ATTN``; at head dim 256 (the
    ``mma.sync`` backward, ``csrc/flash_attention_mma_bwd.cu``)
    ``TC256_BWD_CASES`` and recurrentgemma-2b's training call
    ``RG_TRAIN_ATTN`` with its window. The forward's training
    instance gives the output and log-sum-exp: its output bit-equal to the
    serving instance's, its log-sum-exp within ``TC_LSE_TOL`` of the plain
    one's on every row (-1e30 on a row that sees no key)."""
    import torch
    from repro_torch.kernels import flash_attention_mma_bwd as fmb
    from repro_torch.kernels import flash_attention_tc as ft
    from repro_torch.kernels import flash_attention_tc_bwd as ftb
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(20270)
    cases = [(B, S, T, H, Kv, hd, causal, window) for hd in ftb.HEAD_DIMS
             for B, S, T, H, Kv, causal, window in TC_BWD_CASES]
    B, S, H, Kv, hd = CLI_ATTN
    cases.append((B, S, S, H, Kv, hd, True, 0))
    cases += [(B, S, T, H, Kv, 256, causal, window)
              for B, S, T, H, Kv, causal, window in TC256_BWD_CASES]
    B, S, H, Kv, hd = RG_TRAIN_ATTN
    cases.append((B, S, S, H, Kv, hd, True, RG_WINDOW))
    worst = {"abs": 0.0, "rel": 0.0, "lse": 0.0}
    by_hd = {}
    for B, S, T, H, Kv, hd, causal, window in cases:
        label = f"B={B} S={S} T={T} H={H} Kv={Kv} hd={hd} causal={causal} " \
                f"window={window}"
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for shape in
                   ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd)))
        o, lse = ft.flash_attention_tc_lse_cuda(q, k, v, causal=causal,
                                                window=window)
        check(torch.equal(o, ft.flash_attention_tc_cuda(
            q, k, v, causal=causal, window=window)),
            f"tensor-core training instance's output = serving "
            f"instance's, {label}")
        want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                               window=window)
        lse_err = float((lse - want_lse).abs().max())
        worst["lse"] = max(worst["lse"], lse_err)
        mine = by_hd.setdefault(hd, {"abs": 0.0, "lse": 0.0, "cases": 0})
        mine["lse"] = max(mine["lse"], lse_err)
        mine["cases"] += 1
        check(torch.allclose(lse, want_lse, rtol=TC_LSE_TOL, atol=TC_LSE_TOL),
              f"tensor-core log-sum-exp vs plain ({lse_err}), {label}")
        do = torch.randn(o.shape, generator=gen, device=dev).to(torch.bfloat16)
        bwd = fmb.flash_attention_mma_bwd_cuda if hd == 256 else \
            ftb.flash_attention_tc_bwd_cuda
        got = bwd(q, k, v, o, lse, do, causal=causal, window=window)
        again = bwd(q, k, v, o, lse, do, causal=causal, window=window)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"bf16 backward: two launches equal, {label}")
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window)
        for g, w in zip(got, want):
            check(g.dtype == torch.bfloat16, f"bf16 gradients, {label}")
            err = float((g.float() - w.to(torch.bfloat16).float()).abs().max())
            scale = max(1.0, float(w.abs().max()))
            worst["abs"] = max(worst["abs"], err)
            worst["rel"] = max(worst["rel"], err / scale)
            mine["abs"] = max(mine["abs"], err)
            check(err <= TC_BWD_TOL * scale,
                  f"bf16 backward vs plain ({err}, scale {scale}), {label}")
        del q, k, v, o, lse, do, got, again, want, want_lse
    torch.cuda.empty_cache()
    return {"cases": len(cases),
            "tolerance": f"max |kernel - twin as bf16| <= {TC_BWD_TOL} "
                         "max(1, max |twin|), each of dQ, dK, dV; "
                         f"log-sum-exp within {TC_LSE_TOL}",
            "max_abs_err": worst["abs"], "max_err_over_scale": worst["rel"],
            "lse_max_abs_err": worst["lse"], "by_head_dim": by_hd}


def flash_tc_bwd_times(dev) -> dict:
    """The bf16 training forward (the tensor-core kernel's instance that
    saves the log-sum-exp) and the bf16 backward at the training step's
    call (``CLI_ATTN``), at qwen3-0.6b's prefill shape and at train_4k's
    row length (``TRAIN_4K_ATTN``), causal: by
    events (10 calls in a row) in turns with SDPA on the same bf16 inputs
    (its default backend, K and V repeated to H heads, leaf tensors, so
    only the attention runs), and replayed from a CUDA graph (SDPA's
    backward too); the plain twin; the bounds (backward: 5 products of 2
    hd flops per (query, key) pair of the causal half at 989 TFLOP/s,
    against q, k, v, o, dO and the log-sum-exp read and dQ, dK, dV written
    once at 3.35 TB/s; forward: 2 products, q, k, v read, o and the
    log-sum-exp written); each call's peak device memory over its
    inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_tc as ft
    from repro_torch.kernels import flash_attention_tc_bwd as ftb
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(20271)
    out = {}
    for name, (B, S, H, Kv, hd) in (("qwen3-0.6b train_cli", CLI_ATTN),
                                    ("qwen3-0.6b prefill", QWEN_BF16_ATTN),
                                    ("qwen3-0.6b train_4k", TRAIN_4K_ATTN)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for shape in
                   ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
        o, lse = ft.flash_attention_tc_lse_cuda(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=gen, device=dev).to(torch.bfloat16)
        pairs = S * (S + 1) // 2
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for x in (k, v))
        sd_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()

        def kernel():
            return ftb.flash_attention_tc_bwd_cuda(q, k, v, o, lse, do,
                                                   causal=True)

        def sdpa():
            return torch.autograd.grad(sd_out, (qt, kt, vt), dot,
                                       retain_graph=True)

        def sdpa_forward():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
        kernel()   # the item list, made once a shape, is not a call's
        peak = {"kernel": peak_extra_bytes(kernel),
                "sdpa": peak_extra_bytes(sdpa)}
        check(peak["kernel"] <= peak["sdpa"],
              f"the bf16 backward takes no more memory than SDPA's at {name}"
              f" ({peak})")
        dq_sdpa = sdpa()[0].transpose(1, 2).float()
        dq = kernel()[0].float()
        sdpa_err = float((dq_sdpa - dq).abs().max())
        check(sdpa_err <= TC_BWD_TOL * max(1.0, float(dq_sdpa.abs().max())),
              f"SDPA's bf16 backward agrees with the kernel's dQ at {name} "
              f"({sdpa_err})")
        del dq_sdpa, dq
        ms = in_turns({"kernel": kernel, "sdpa": sdpa})
        fwd = in_turns({
            "training_instance": lambda: ft.flash_attention_tc_lse_cuda(
                q, k, v, causal=True),
            "serving_instance": lambda: ft.flash_attention_tc_cuda(
                q, k, v, causal=True),
            "sdpa": sdpa_forward})
        dev_ms = graph_ms(kernel)
        fwd_dev_ms = graph_ms(lambda: ft.flash_attention_tc_lse_cuda(
            q, k, v, causal=True))
        sdpa_dev_ms = sdpa_backward_graph_ms(qt, kt, vt, dot, backend=None)
        plain_ms = cuda_ms(
            lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                causal=True),
            reps=1, rounds=1)
        flops = 5 * 2 * hd * pairs * B * H
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        t_ops, t_bytes = flops / BF16_FLOPS_S, nbytes / HBM_BYTES_S
        f_ops = 2 * 2 * hd * pairs * B * H / BF16_FLOPS_S
        f_bytes = (2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()) \
            / HBM_BYTES_S
        bound = max(t_ops, t_bytes) * 1e3
        out[name] = {
            "shape": f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} bf16 causal",
            "ms": ms["kernel"], "device_ms_from_graph": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": ms["sdpa"], "library_ms_from_graph": sdpa_dev_ms,
            "library": "scaled_dot_product_attention backward, default "
                       "backend, K and V repeated",
            "sdpa_dq_max_abs_err": sdpa_err,
            "bound_arithmetic": f"max({flops:.4g} flops / 989e12, "
                                f"{nbytes:.4g} B / 3.35e12) = "
                                f"max({t_ops * 1e3:.4g}, "
                                f"{t_bytes * 1e3:.4g}) ms",
            "share_of_bound": bound / ms["kernel"],
            "peak_bytes_over_inputs": peak,
            "forward_training_instance_ms": fwd["training_instance"],
            "forward_training_instance_ms_from_graph": fwd_dev_ms,
            "forward_serving_instance_ms": fwd["serving_instance"],
            "forward_library_ms": fwd["sdpa"],
            "forward_bound_ms": max(f_ops, f_bytes) * 1e3,
            "forward_bound_by": "operations" if f_ops > f_bytes
                                else "bytes"}
        del q, k, v, o, lse, do, qt, kt, vt, sd_out, dot
        torch.cuda.empty_cache()
    return out


def decay_bwd_vs_plain(dev) -> dict:
    """The decay-scan backward kernel (``csrc/decay_scan_bwd.cu``) against
    its plain twin ``ref.decay_scan_bwd_ref`` on the forward kernel's h:
    within ``DECAY_BWD_TOL`` of each tensor's largest entry (the twin runs
    the kernel's operations in its order, so the readings are 0) and
    bit-equal to a second launch; S in {0, 1} and at the edges of its 16
    steps of loads, odd C, with and without h0 and a final-state gradient,
    and recurrentgemma-2b's training call ``RG_TRAIN_LRU``; then autograd
    through ``ops.decay_scan`` (the ``DecayScan`` Function) against the
    twin."""
    import torch
    from repro_torch.kernels import decay_scan, ops, ref
    gen = torch.Generator(device=dev).manual_seed(20272)
    cases = [(2, s, c, h0, last) for s in (0, 1, 15, 16, 17, 37)
             for c in (1, 33, 130) for h0 in (False, True)
             for last in (False, True)]
    cases.append((*RG_TRAIN_LRU, False, False))
    cases.append((*RG_TRAIN_LRU, True, True))
    worst = 0.0
    for B, S, C, with_h0, with_last in cases:
        what = f"decay scan backward B={B} S={S} C={C} h0={with_h0} " \
               f"dh_last={with_last}"
        a = torch.rand((B, S, C), generator=gen, device=dev) * 0.7 + 0.3
        b = torch.randn((B, S, C), generator=gen, device=dev)
        h0 = torch.randn((B, C), generator=gen, device=dev) if with_h0 \
            else None
        h, _ = decay_scan.decay_scan_cuda(a, b, h0)
        dh = torch.randn((B, S, C), generator=gen, device=dev)
        dl = torch.randn((B, C), generator=gen, device=dev) if with_last \
            else None
        got = decay_scan.decay_scan_bwd_cuda(a, h, dh, dl, h0)
        again = decay_scan.decay_scan_bwd_cuda(a, h, dh, dl, h0)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              what + ": two launches equal")
        want = ref.decay_scan_bwd_ref(a, h, dh, dl, h0)[:2]
        for g, w in zip(got, want):
            if S:
                err = float((g - w).abs().max() / w.abs().max().clamp(
                    min=1e-30))
                worst = max(worst, err)
                check(err <= DECAY_BWD_TOL, f"{what} vs plain ({err})")
        del a, b, h, dh, got, again, want
    a = (torch.rand((3, 40, 24), generator=gen, device=dev) * 0.7
         + 0.3).requires_grad_(True)
    b = torch.randn((3, 40, 24), generator=gen, device=dev,
                    requires_grad=True)
    before = decay_scan.bwd_launches
    h, h_last = ops.decay_scan(a, b)
    dh = torch.randn_like(h)
    da, db = torch.autograd.grad((h * dh).sum() + h_last.sum(), (a, b))
    want = ref.decay_scan_bwd_ref(a.detach(), h.detach(), dh,
                                  torch.ones_like(h_last))
    check(decay_scan.bwd_launches == before + 1
          and torch.equal(da, want[0]) and torch.equal(db, want[1]),
          "autograd through ops.decay_scan on the card: one backward "
          "launch, the twin's bits")
    return {"cases": len(cases) + 1, "max_err_over_scale": worst,
            "tolerance": f"max |kernel - twin| <= {DECAY_BWD_TOL} max "
                         "|twin|, each of da, db",
            "max_abs_err": worst, "equal_bits_launch_to_launch": True}


def wkv_bwd_vs_plain(dev) -> dict:
    """The WKV-6 backward (``csrc/wkv6_bwd.cu``) against its plain twin
    ``ref.wkv6_bwd_ref``: each of dr, dk, dv, dw, du within
    ``WKV_BWD_TOL[dtype]`` of the tensor's largest entry (bf16 r, k, v:
    the twin's dr, dk, dv rounded to bf16 as the kernel's are), bit-equal
    to a second launch; S in {1} and at the edges of its 8-step chunks,
    head sizes below 64, K != V and odd, float32 and bf16, with and
    without s0 and a final-state gradient, and rwkv6-7b's training call
    ``RWKV_TRAIN_WKV`` (bf16); then autograd through ``ops.wkv6`` (the
    ``WKV6`` Function) against the twin."""
    import torch
    from repro_torch.kernels import ops, ref, wkv6
    gen = torch.Generator(device=dev).manual_seed(20273)
    L = WKV_BWD_CHUNK
    shapes = [(2, 1, 2, 64, 64), (1, L - 1, 3, 64, 64), (2, L, 2, 32, 32),
              (1, L + 1, 2, 64, 48), (2, 2 * L + 3, 3, 5, 7),
              (1, 40, 2, 63, 64), (1, 33, 1, 64, 1), (4, 64, 8, 64, 64)]
    cases = [(shape, dtype, start, last)
             for shape in shapes for dtype in (torch.float32, torch.bfloat16)
             for start, last in ((False, False), (True, True))]
    cases.append((RWKV_TRAIN_WKV, torch.bfloat16, False, False))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for shape, dtype, with_s0, with_last in cases:
        name = str(dtype).split(".")[1]
        what = f"wkv6 backward {shape} {name} s0={with_s0} " \
               f"ds_final={with_last}"
        r, k, v, w, u, s0 = _wkv_inputs(shape, dtype, gen, dev)
        s0 = s0 if with_s0 else None
        B, S, H, K, V = shape
        do = torch.randn((B, S, H, V), generator=gen, device=dev)
        dsf = torch.randn((B, H, K, V), generator=gen, device=dev) \
            if with_last else None
        got = wkv6.wkv6_bwd_cuda(r, k, v, w, u, do, dsf, s0)
        again = wkv6.wkv6_bwd_cuda(r, k, v, w, u, do, dsf, s0)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              what + ": two launches equal")
        want = ref.wkv6_bwd_ref(r, k, v, w, u, do, dsf, s0)
        for part, g, wnt in zip("r k v w u".split(), got, want):
            check(g.dtype == (dtype if part in "rkv" else torch.float32),
                  f"{what}: d{part} dtype")
            wnt = wnt.to(g.dtype).float()
            err = float((g.float() - wnt).abs().max()
                        / wnt.abs().max().clamp(min=1e-30))
            worst[name] = max(worst[name], err)
            check(err <= WKV_BWD_TOL[name], f"{what}: d{part} vs plain "
                                            f"({err})")
        del r, k, v, w, u, do, got, again, want
        torch.cuda.empty_cache()
    leaves = [x.requires_grad_(True) for x in _wkv_inputs(
        (2, 20, 2, 16, 16), torch.float32, gen, dev)[:5]]
    before = wkv6.bwd_launches
    out, s_final = ops.wkv6(*leaves)
    do = torch.randn_like(out)
    got = torch.autograd.grad((out * do).sum() + s_final.sum(), leaves)
    want = wkv6.wkv6_bwd_cuda(*(x.detach() for x in leaves), do,
                              torch.ones_like(s_final))
    check(wkv6.bwd_launches == before + 2
          and all(torch.equal(g, w) for g, w in zip(got, want)),
          "autograd through ops.wkv6 on the card: the backward's bits")
    return {"cases": len(cases) + 1, "max_err_over_scale": worst,
            "max_abs_err": max(worst.values()),
            "tolerance": f"max |kernel - twin in the kernel's dtype| <= "
                         f"{WKV_BWD_TOL} max |twin|, each of dr, dk, dv, "
                         "dw, du",
            "resources": wkv6.bwd_resources(),
            "equal_bits_launch_to_launch": True}


def recurrent_bwd_times(dev) -> dict:
    """The two recurrences' backward kernels at the training paths' calls
    (the decay scan's at ``RG_TRAIN_LRU``, WKV-6's at ``RWKV_TRAIN_WKV``
    with bf16 r, k, v), by events (10 calls in a row) and from a CUDA
    graph, their plain twins, and each bound: A moves a, h, dh in and da,
    db out (float32) at 3.35 TB/s against 3 flops an element; B needs 12
    float32 flops per (k, v) and step (the state recomputed, dr, dk, dv,
    dw and dS's update, two each) at 67 TFLOP/s against r, k, v, w, do in
    and dr, dk, dv, dw out once."""
    import torch
    from repro_torch.kernels import decay_scan, ref, wkv6
    gen = torch.Generator(device=dev).manual_seed(20274)
    out = {}
    B, S, C = RG_TRAIN_LRU
    a = torch.rand((B, S, C), generator=gen, device=dev) * 0.7 + 0.3
    b = torch.randn((B, S, C), generator=gen, device=dev)
    h, _ = decay_scan.decay_scan_cuda(a, b)
    dh = torch.randn_like(h)

    def decay_bwd():
        return decay_scan.decay_scan_bwd_cuda(a, h, dh)
    ms, dev_ms = cuda_ms(decay_bwd), graph_ms(decay_bwd)
    plain_ms = cuda_ms(lambda: ref.decay_scan_bwd_ref(a, h, dh), reps=3,
                       rounds=1)
    nbytes, flops = 4 * 5 * a.numel(), 3 * a.numel()
    t_b, t_o = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    out["decay_scan_bwd"] = {
        "shape": f"B={B} S={S} C={C} float32 (recurrentgemma-2b's RG-LRU "
                 "in a training step at batch 16)",
        "ms": ms, "device_ms_from_graph": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o) * 1e3,
        "bound_by": "bytes" if t_b > t_o else "operations",
        "library_ms": None,
        "bound_arithmetic": f"max({nbytes:.4g} B / 3.35e12, {flops:.4g} "
                            f"flops / 67e12) = max({t_b * 1e3:.4g}, "
                            f"{t_o * 1e3:.4g}) ms",
        "share_of_bound_from_graph": max(t_b, t_o) * 1e3 / dev_ms}
    del a, b, h, dh

    B, S, H, K, V = RWKV_TRAIN_WKV
    r, k, v, w, u, _ = _wkv_inputs(RWKV_TRAIN_WKV, torch.bfloat16, gen, dev)
    do = torch.randn((B, S, H, V), generator=gen, device=dev)

    def wkv_bwd():
        return wkv6.wkv6_bwd_cuda(r, k, v, w, u, do)
    ms = cuda_ms(wkv_bwd, reps=3)
    dev_ms = graph_ms(wkv_bwd, reps=3)
    fwd_ms = cuda_ms(lambda: wkv6.wkv6_cuda(r, k, v, w, u), reps=3)
    plain_ms = cuda_ms(lambda: ref.wkv6_bwd_ref(r, k, v, w, u, do), reps=1,
                       rounds=1)
    nbytes = 2 * 2 * (r.numel() + k.numel() + v.numel()) \
        + 4 * (2 * w.numel() + do.numel()) + 4 * 2 * u.numel()
    flops = 12 * B * S * H * K * V
    t_b, t_o = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    out["wkv6_bwd"] = {
        "shape": f"B={B} S={S} H={H} K=V={K}, r/k/v bf16, w and do float32 "
                 "(rwkv6-7b's time mix in a training step at batch 32)",
        "ms": ms, "device_ms_from_graph": dev_ms, "plain_ms": plain_ms,
        "forward_kernel_ms": fwd_ms,
        "bound_ms": max(t_b, t_o) * 1e3,
        "bound_by": "bytes" if t_b > t_o else "operations",
        "library_ms": None,
        "bound_arithmetic": f"max({nbytes:.4g} B / 3.35e12, {flops:.4g} "
                            f"flops / 67e12) = max({t_b * 1e3:.4g}, "
                            f"{t_o * 1e3:.4g}) ms",
        "share_of_bound_from_graph": max(t_b, t_o) * 1e3 / dev_ms,
        "resources": wkv6.bwd_resources()}
    return out


def flash_hd256_train_times(dev) -> dict:
    """The tensor-core forward's training instance (C) and the hd-256
    backward (D, ``csrc/flash_attention_mma_bwd.cu``) at recurrentgemma-2b's
    training call ``RG_TRAIN_ATTN`` and at S = T = 4096
    (``RG_4K_ATTN``), causal with its window of 2048: by events in turns
    with SDPA's bf16 forward and backward on the same inputs (the band as
    a boolean mask, K and V repeated to the 10 heads, leaf tensors so only
    the attention runs), and from a CUDA graph; the plain twins; the
    bounds (the products over the band's pairs: 2 for the forward and 5
    for the backward, 2 hd flops a pair at 989 TFLOP/s, against each input
    read and output written once); each backward's peak device memory over
    its inputs beside SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_mma_bwd as fmb
    from repro_torch.kernels import flash_attention_tc as ft
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(20275)
    out = {}
    window = RG_WINDOW
    for name, (B, S, H, Kv, hd) in (
            ("recurrentgemma-2b train", RG_TRAIN_ATTN),
            ("recurrentgemma-2b S=T=4096", RG_4K_ATTN)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for shape in
                   ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
        o, lse = ft.flash_attention_tc_lse_cuda(q, k, v, causal=True,
                                                window=window)
        do = torch.randn(o.shape, generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        pairs = int(band.sum())
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (x.repeat_interleave(H // Kv, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for x in (k, v))
        sd_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
        dot = do.transpose(1, 2).contiguous()

        def forward():
            return ft.flash_attention_tc_lse_cuda(q, k, v, causal=True,
                                                  window=window)

        def backward():
            return fmb.flash_attention_mma_bwd_cuda(q, k, v, o, lse, do,
                                                    causal=True,
                                                    window=window)

        def sdpa_forward():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=band)

        def sdpa_backward():
            return torch.autograd.grad(sd_out, (qt, kt, vt), dot,
                                       retain_graph=True)
        peak = {"kernel": peak_extra_bytes(backward),
                "sdpa": peak_extra_bytes(sdpa_backward)}
        dq_sdpa = sdpa_backward()[0].transpose(1, 2).float()
        sdpa_err = float((dq_sdpa - backward()[0].float()).abs().max())
        check(sdpa_err <= TC_BWD_TOL * max(1.0, float(dq_sdpa.abs().max())),
              f"SDPA's bf16 backward agrees with the hd-256 kernel's dQ at "
              f"{name} ({sdpa_err})")
        del dq_sdpa
        fwd = in_turns({"kernel": forward, "sdpa": sdpa_forward,
                        "serving_instance": lambda: ft.flash_attention_tc_cuda(
                            q, k, v, causal=True, window=window)})
        bwd = in_turns({"kernel": backward, "sdpa": sdpa_backward})
        fwd_dev, bwd_dev = graph_ms(forward), graph_ms(backward)
        plain_bwd = cuda_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=True, window=window), reps=1,
            rounds=1)
        plain_fwd = cuda_ms(lambda: ref.flash_attention_lse_ref(
            q, k, v, causal=True, window=window), reps=1, rounds=1)
        b_ops = 5 * 2 * hd * pairs * B * H / BF16_FLOPS_S
        b_bytes = (2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()) \
            / HBM_BYTES_S
        f_ops = 2 * 2 * hd * pairs * B * H / BF16_FLOPS_S
        f_bytes = (2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()) \
            / HBM_BYTES_S
        shape = f"B={B} S=T={S} H={H} Kv={Kv} hd={hd} bf16 causal " \
                f"window={window}"
        out[name] = {
            "forward": {
                "shape": shape, "ms": fwd["kernel"],
                "device_ms_from_graph": fwd_dev, "plain_ms": plain_fwd,
                "serving_instance_ms": fwd["serving_instance"],
                "bound_ms": max(f_ops, f_bytes) * 1e3,
                "bound_by": "operations" if f_ops > f_bytes else "bytes",
                "library_ms": fwd["sdpa"],
                "library": "scaled_dot_product_attention, boolean band "
                           "mask, K and V repeated"},
            "backward": {
                "shape": shape, "ms": bwd["kernel"],
                "device_ms_from_graph": bwd_dev, "plain_ms": plain_bwd,
                "bound_ms": max(b_ops, b_bytes) * 1e3,
                "bound_by": "operations" if b_ops > b_bytes else "bytes",
                "library_ms": bwd["sdpa"],
                "library": "scaled_dot_product_attention backward, boolean "
                           "band mask, K and V repeated",
                "bound_arithmetic": f"max(5 x 2 x {hd} x {pairs} pairs x "
                                    f"{B * H} / 989e12, {b_bytes * 3.35e12:.4g}"
                                    f" B / 3.35e12) ms",
                "sdpa_dq_max_abs_err": sdpa_err,
                "peak_bytes_over_inputs": peak}}
        del q, k, v, o, lse, do, qt, kt, vt, sd_out, dot, band
        torch.cuda.empty_cache()
    return out


def train_step_split(dev) -> dict:
    """One pnpcoin-demo training step (the workload's: batch 4 of 32
    tokens, float32) split by CUDA events into the forward (loss), the
    backward (autograd, through the flash backward) and the optimiser
    (the schedule and AdamW), with the peak device memory of a step; the
    median of 5 steps after one warm-up."""
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train import steps
    cfg = get_config("pnpcoin-demo")
    state = steps.make_train_state(cfg, random.key(0), dev)
    batch = SyntheticTokenPipeline(cfg, InputShape(
        f"chain{TRAIN_SEQ}x{TRAIN_BATCH}", TRAIN_SEQ, TRAIN_BATCH,
        "train")).microbatch(0, 0)
    return step_split(cfg, state, batch, steps.TrainHparams(
        warmup_steps=4, total_steps=512))


def step_split(cfg, state, batch, hp, reps: int = 5) -> dict:
    """Training steps of ``cfg`` from ``state`` on ``batch`` split by CUDA
    events into the forward (loss), the backward (autograd, through the
    flash backward) and the optimiser (the schedule and AdamW, ``hp``),
    with the peak device memory of a step; the median of ``reps`` steps
    after one warm-up. ``state`` may be a one-element list holding it,
    which the split empties, so that no caller keeps the first state
    alive beside the steps' (at full width two states do not fit the
    card)."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_update, tree_leaves, tree_map
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train import steps
    if isinstance(state, list):
        state = state.pop()
    model = build_model(cfg)
    split = {"forward": [], "backward": [], "optimiser": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state.params)
        ev[0].record()
        loss, _ = model.loss(params, batch)
        ev[1].record()
        grads = steps._unflatten(params, iter(torch.autograd.grad(
            loss, tree_leaves(params))))
        ev[2].record()
        with torch.no_grad():
            lr = cosine_schedule(state.opt.step + 1, peak_lr=hp.peak_lr,
                                 warmup_steps=hp.warmup_steps,
                                 total_steps=hp.total_steps)
            new, opt = adamw_update(tree_map(torch.Tensor.detach, params),
                                    grads, state.opt, lr,
                                    weight_decay=hp.weight_decay,
                                    grad_clip=hp.grad_clip)
        ev[3].record()
        ev[3].synchronize()
        state = steps.TrainState(new, opt)
        # nothing of this step outlives it (at full width the gradients
        # held into the next step's backward would not fit)
        del params, loss, grads, new, opt
        if rep:
            for i, key in enumerate(split):
                split[key].append(ev[i].elapsed_time(ev[i + 1]))
    return {"ms": {k: statistics.median(v) for k, v in split.items()},
            "peak_device_mb": torch.cuda.max_memory_allocated() / 1e6,
            "params": sum(t.numel() for t in tree_leaves(state.params))}


def _train_line(p, height) -> str:
    """A mined block as examples/torch_chain_train_model.py prints it."""
    return (f"height {height} [model_train] miner=node{p.origin} "
            f"step={p.train_height} loss={p.loss:.4f} "
            f"digest={p.state_digest[:16]}…")


def model_train_path(dev) -> dict:
    """Proof-of-useful-work training of pnpcoin-demo through ``Node``, as
    ``examples/chain_train_model.py`` runs it: a 2-node ``Network`` mines
    ``TRAIN_BLOCKS`` model_train blocks, miners alternating, each replayed
    by the other node; node 0 is recovered from its journal; the recovered
    node mines a private block that loses to a longer public chain (a
    model_train and a Classic block) and reorgs onto it. Launches, from
    the code: every block runs its 2 microsteps through the 2 layers, one
    flash forward (training instance) and one backward a layer and
    microstep, on the miner and again on each node that replays it: 8 of
    each a network block, 4 a replayed block; Classic's SHA-256 launches
    only in the reorg. Then the same blocks on the CPU port, and the
    port's example as a process of its own."""
    import os

    import numpy as np
    import torch
    from repro_torch.chain import ChainStore, Network, Node
    from repro_torch.chain.workloads import ModelTrainingWorkload
    from repro_torch.configs import get_config
    cfg = get_config("pnpcoin-demo")
    per_block = cfg.n_layers * TRAIN_MICRO          # on one node
    timed = {}

    def make_node(i, device, tag=None, **kw):
        wl = ModelTrainingWorkload(cfg=cfg, seq_len=TRAIN_SEQ,
                                   batch=TRAIN_BATCH,
                                   block_microsteps=TRAIN_MICRO, n_miners=2,
                                   device=device)
        if device == dev:
            timed[tag or f"node{i}"] = []
            _timed_steps(wl, timed[tag or f"node{i}"])
        return Node(node_id=i, classic_arg_bits=6, device=device,
                    workloads={"model_train": wl}, **kw)

    def chain(device):
        store = ChainStore()
        net = Network.create(2, node_factory=lambda i: make_node(
            i, device, **({"store": store} if i == 0 else {})))
        lines, block_s = [], []
        for b in range(TRAIN_BLOCKS):
            res = net.mine(b % 2, "model_train")
            check(not res.rejected_by, f"model_train on {device}: peers "
                  f"rejected block {b}: {res.rejected_by}")
            lines.append(_train_line(res.receipt.payload,
                                     res.receipt.record.height))
            block_s.append(res.receipt.block_time_s)
        return net, store, lines, block_s

    split = train_step_split(dev)
    _zero_counts()
    t = time.perf_counter()
    net, store, lines, block_s = chain(dev)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t
    mined = _counts()
    a, b = net.nodes
    check(net.converged() and len({n.workloads["model_train"].state_digest()
                                   for n in net.nodes}) == 1
          and len({tuple(sorted(n.book.balances.items()))
                   for n in net.nodes}) == 1,
          "model_train: the nodes converged on the weights and the books")
    want = 2 * per_block * TRAIN_BLOCKS
    check(mined["flash_attention"] == want
          and mined["flash_attention_bwd"] == want
          and mined["flash_attention_tc"] == 0 and mined["sha256"] == 0
          and mined["merkle"] == 0,
          f"model_train chain: {want} flash forward and backward launches "
          f"and no other, got {mined}")

    _zero_counts()
    t = time.perf_counter()
    rec = Node.recover(store, node=make_node(0, dev, tag="recovered"))
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t
    recovered = _counts()
    check(rec.last_recovery.adopted_height == a.ledger.height
          and [blk.block_hash for blk in rec.ledger.blocks]
          == [blk.block_hash for blk in a.ledger.blocks]
          and rec.workloads["model_train"].state_digest()
          == a.workloads["model_train"].state_digest()
          and rec.book.balances == a.book.balances,
          "model_train: recovered chain, weights and books equal node 0's")
    want = per_block * TRAIN_BLOCKS
    check(recovered["flash_attention"] == want
          and recovered["flash_attention_bwd"] == want,
          f"model_train recovery: {want} launches of each, got {recovered}")

    _zero_counts()
    t = time.perf_counter()
    rec.mine_block("model_train")
    r5 = b.mine_block("model_train")
    b.mine_block("classic")
    check(rec.consider_chain(list(b.ledger.blocks), b.chain_payloads()),
          "model_train: the recovered node adopts the longer chain")
    torch.cuda.synchronize()
    reorg_s = time.perf_counter() - t
    reorged = _counts()
    final = b.workloads["model_train"].state_digest()
    check(rec.workloads["model_train"].round == r5.payload.train_height + 1
          and rec.workloads["model_train"].state_digest() == final
          and np.isfinite(r5.payload.loss),
          "model_train: the reorg rolled the private step back, weights "
          "equal the winning chain's")

    # the same blocks on the CPU port: float training agrees within
    # TRAIN_LOSS_TOL (the card and the CPU round differently)
    t = time.perf_counter()
    cpu_net = chain("cpu")
    cpu_s = time.perf_counter() - t
    card_losses = [p.loss for p in a.chain_payloads()]
    cpu_losses = [p.loss for p in cpu_net[0].nodes[0].chain_payloads()]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(card_losses,
                                                       cpu_losses))
    check(loss_err <= TRAIN_LOSS_TOL, f"model_train: card losses "
          f"{card_losses} within {TRAIN_LOSS_TOL} of the CPU's {cpu_losses}")

    # the example as a user runs it, in a process of its own, on the card
    t = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "torch_chain_train_model.py")],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    example_s = time.perf_counter() - t
    printed = proc.stdout.splitlines()
    check(proc.returncode == 0 and printed and printed[-1] == "ok",
          f"torch_chain_train_model.py: exit {proc.returncode}, "
          f"{proc.stderr[-2000:]}")
    check([ln for ln in printed if ln.startswith("height ")] == lines
          and any(final[:16] in ln for ln in printed
                  if ln.startswith("reorged")),
          f"torch_chain_train_model.py printed the in-process chain's "
          f"heights, losses and digests: {printed} vs {lines}")

    steps_of = {tag: {step: [s for k, s in steps if k == step]
                      for step in ("mine", "verify", "reward")}
                for tag, steps in timed.items()}
    return {"phase": "workloads", "part": "model_train",
            "config": f"pnpcoin-demo ({cfg.n_layers} layers, d_model "
                      f"{cfg.d_model}, {cfg.n_heads} heads over "
                      f"{cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, "
                      f"vocab {cfg.vocab_size}, float32), batch "
                      f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_MICRO} "
                      "microsteps a block",
            "printed": lines, "final_digest": final,
            "block_time_s": block_s, "chain_s": chain_s,
            "steps_s_by_node": steps_of, "recover_s": recover_s,
            "reorg_s": reorg_s, "cpu_chain_s": cpu_s,
            "example_process_s": example_s,
            "card_losses": card_losses, "cpu_losses": cpu_losses,
            "card_vs_cpu_loss_rel_err": loss_err,
            "train_step": split, "counts_chain": mined,
            "counts_recover": recovered, "counts_reorg": reorged,
            "flash_launches_a_block": {"mined": per_block,
                                       "replayed": per_block},
            "launches": {k: mined[k] + recovered[k] + reorged[k]
                         for k in ("sha256", "merkle", "flash_attention",
                                   "flash_attention_bwd")}}

def _part_counts(counts: dict) -> dict:
    """A part's hand-kernel launches, the flash forward split into its
    serving and training instances."""
    return {"sha256": counts["sha256"], "merkle": counts["merkle"],
            "flash_attention": counts["flash_attention"],
            "flash_attention_serving": counts["flash_attention"]
            - counts["flash_attention_training"],
            "flash_attention_training": counts["flash_attention_training"],
            "flash_attention_bwd": counts["flash_attention_bwd"],
            "flash_attention_tc": counts["flash_attention_tc"]}


def _steps_s(timed: dict) -> dict:
    return {tag: {step: [s for k, s in steps if k == step]
                  for step in ("mine", "verify", "reward")}
            for tag, steps in timed.items()}


def _pouw_chain(dev, make_trainer, what: str) -> dict:
    """A 2-node network of ``TrainingWorkload`` nodes over
    ``make_trainer(device)``, node 0 journalled, mining ``POUW_BLOCKS``
    training blocks alternately, each verified by the peer on receive;
    then both nodes audit their chains. Each node's mine, verify and reward
    steps are timed, launches are counted over the chain and over the
    audits apart, and the device's peak memory is reset at the start."""
    import torch
    from repro_torch.chain import ChainStore, Network, Node, TrainingWorkload
    from repro_torch.train.steps import params_digest
    timed = {}

    def make_node(i, device, tag=None, **kw):
        wl = TrainingWorkload(lambda: make_trainer(device))
        timed[tag or f"node{i}"] = []
        _timed_steps(wl, timed[tag or f"node{i}"])
        return Node(node_id=i, classic_arg_bits=6, device=device,
                    workloads={"training": wl}, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    journal = ChainStore()
    _zero_counts()
    t = time.perf_counter()
    net = Network.create(2, node_factory=lambda i: make_node(
        i, dev, **({"store": journal} if i == 0 else {})))
    block_s = []
    for b in range(POUW_BLOCKS):
        res = net.mine(b % 2, "training")
        check(not res.rejected_by and sorted(res.accepted_by) == [0, 1],
              f"{what}: block {b} accepted by both nodes "
              f"({res.accepted_by}, rejected by {res.rejected_by})")
        block_s.append(res.receipt.block_time_s)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t
    mined = _counts()
    check(net.converged() and len({
        tuple(sorted(n.book.balances.items())) for n in net.nodes}) == 1,
        f"{what}: the nodes converged and their books are equal")
    check(len({params_digest(n.workloads["training"].trainer.state)
               for n in net.nodes}) == 1,
          f"{what}: both nodes hold the same weights")
    _zero_counts()
    t = time.perf_counter()
    check(all(n.audit_chain() for n in net.nodes),
          f"{what}: both nodes audit their chains")
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t
    return {"net": net, "journal": journal, "make_node": make_node,
            "timed": timed, "block_s": block_s, "chain_s": chain_s,
            "audit_s": audit_s, "mined": mined, "audited": _counts()}


def _pouw_line(run: dict) -> dict:
    """The fields a PoUW part's line shares: times and counts of its chain
    and audits."""
    return {"block_time_s": run["block_s"], "chain_s": run["chain_s"],
            "steps_s_by_node": _steps_s(run["timed"]),
            "audit_chain_s": run["audit_s"],
            "counts_chain": _part_counts(run["mined"]),
            "counts_audit": _part_counts(run["audited"])}


def _recover_and_reorg(dev, net, journal, make_node, what: str) -> dict:
    """Node 0 recovered from its journal; then the recovered node mines a
    private training block while node 1 mines a Classic and a training
    block, and the recovered node adopts the longer chain, unwinding its
    private step. Launches of each step counted."""
    import torch
    from repro_torch.chain import Node
    from repro_torch.train.steps import params_digest
    a, b = net.nodes
    _zero_counts()
    t = time.perf_counter()
    rec = Node.recover(journal, node=make_node(0, dev, tag="recovered"))
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t
    recovered = _counts()
    check(rec.last_recovery.adopted_height == a.ledger.height
          and rec.ledger.tip_hash == a.ledger.tip_hash
          and params_digest(rec.workloads["training"].trainer.state)
          == params_digest(a.workloads["training"].trainer.state)
          and rec.book.balances == a.book.balances,
          f"{what}: the recovered chain, weights and books equal node 0's")
    _zero_counts()
    t = time.perf_counter()
    rec.mine_block("training")
    b.mine_block("classic")
    public = b.mine_block("training")
    check(rec.consider_chain(list(b.ledger.blocks), b.chain_payloads()),
          f"{what}: the recovered node adopts the longer chain")
    torch.cuda.synchronize()
    reorg_s = time.perf_counter() - t
    reorged = _counts()
    trainer = rec.workloads["training"].trainer
    check(trainer.ledger.height == public.payload.train_height + 1
          and rec.ledger.tip_hash == b.ledger.tip_hash
          and params_digest(trainer.state)
          == params_digest(b.workloads["training"].trainer.state)
          and rec.book.balances == b.book.balances,
          f"{what}: the reorg unwound the private step; weights and books "
          "equal the winning chain's")
    return {"recover_s": recover_s, "reorg_s": reorg_s,
            "counts_recover": _part_counts(recovered),
            "counts_reorg": _part_counts(reorged)}


def pouw_full_path(dev) -> dict:
    """``PoUWTrainer`` in full mode behind ``TrainingWorkload``, as
    ``examples/train_pnp.py`` runs it, at pnpcoin-demo's width: a 2-node
    network mines ``POUW_BLOCKS`` blocks alternately, each verified by the
    peer's replay; both nodes audit their chains (a replay trainer each);
    node 0 is recovered from its journal and reorged. Launches, from the
    code: a block is one step of 2 layers, one training-instance forward
    and one backward a layer, on the miner and again on the peer (the
    miner's self-check is the fast path), so 4 of each a network block;
    the audits and the recovery 2 a block each; no serving launch. Then
    the first ``POUW_CPU_BLOCKS`` blocks on the CPU port, their losses
    against the card's block by block (from block 1 on, each loss follows
    the blocks' backward and update before it)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.pow_train import PoUWTrainer
    from repro_torch.train.steps import TrainHparams
    cfg = get_config("pnpcoin-demo")
    shape = InputShape("cli", POUW_SEQ, POUW_BATCH, "train")
    hp = TrainHparams(peak_lr=1e-3, warmup_steps=max(POUW_BLOCKS // 20, 5),
                      total_steps=POUW_BLOCKS)

    def trainer(device):
        return PoUWTrainer(cfg, shape, hp=hp, mode="full",
                           n_miners=POUW_MINERS, device=device)

    per_block = cfg.n_layers
    run = _pouw_chain(dev, trainer, "pouw_full")
    mined, audited = run["mined"], run["audited"]
    want = 2 * per_block * POUW_BLOCKS
    check(mined["flash_attention_training"] == mined["flash_attention"]
          == mined["flash_attention_bwd"] == want
          and mined["flash_attention_tc"] == mined["sha256"]
          == mined["merkle"] == 0,
          f"pouw_full chain: {want} training-instance forward and backward "
          f"launches and no other, got {mined}")
    check(audited["flash_attention_training"] == audited["flash_attention"]
          == audited["flash_attention_bwd"] == want,
          f"pouw_full audit: {want} launches of each, got {audited}")
    rest = _recover_and_reorg(dev, run["net"], run["journal"],
                              run["make_node"], "pouw_full")
    check(rest["counts_recover"]["flash_attention_bwd"]
          == per_block * POUW_BLOCKS,
          f"pouw_full recovery: {per_block * POUW_BLOCKS} backward "
          f"launches, got {rest['counts_recover']}")
    peak = torch.cuda.max_memory_allocated()
    card_losses = [p.loss for p in run["net"].nodes[0].chain_payloads()]
    t = time.perf_counter()
    cpu_losses = [r.loss for r in trainer("cpu").run(POUW_CPU_BLOCKS)]
    cpu_s = time.perf_counter() - t
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(card_losses,
                                                       cpu_losses))
    check(loss_err <= TRAIN_LOSS_TOL, f"pouw_full: the first "
          f"{POUW_CPU_BLOCKS} blocks' losses on the card "
          f"{card_losses[:POUW_CPU_BLOCKS]} within {TRAIN_LOSS_TOL} of the "
          f"CPU port's {cpu_losses}")
    launches = {k: mined[k] + audited[k] + rest["counts_recover"][k]
                + rest["counts_reorg"][k]
                for k in ("sha256", "merkle", "flash_attention",
                          "flash_attention_bwd")}
    return {"phase": "workloads", "part": "pouw_full",
            "config": f"pnpcoin-demo ({cfg.n_layers} layers, d_model "
                      f"{cfg.d_model}, {cfg.n_heads} heads over "
                      f"{cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, "
                      f"float32), full mode, batch {POUW_BATCH} x "
                      f"{POUW_SEQ} tokens, {POUW_MINERS} miners, {hp}",
            "attention_call": dict(zip("B S H Kv hd".split(), POUW_ATTN)),
            **_pouw_line(run), **rest, "card_losses": card_losses,
            "card_vs_cpu_losses": {"cpu": cpu_losses, "rel_err": loss_err},
            "cpu_blocks_s": cpu_s, "peak_device_mb": peak / 1e6,
            "launches": launches}


def pouw_es_path(dev) -> dict:
    """``PoUWTrainer`` in optimal (ES) mode behind ``TrainingWorkload``, as
    ``examples/es_search.py`` runs it but at pnpcoin-demo's width: a 2-node
    network mines ``POUW_BLOCKS`` blocks alternately on a fixed batch, each
    verified by the peer's replay, and the accepted loss never rises
    (candidate 0 is the incumbent); both nodes audit. Launches: one
    serving-instance forward a layer and candidate, on the miner and on
    the peer, and again in each node's audit; no training instance and no
    backward. Then the example's ES-gradient demo, ``ES_DEMO_STEPS``
    ``es_update`` steps, and the first block's search on a fresh trainer
    on the card and on the CPU port: every candidate's loss within
    ``ES_LOSS_TOL``, the same winner, and the card's equal to the chain's
    first block."""
    import torch
    from repro_torch import random
    from repro_torch.chain.workload import MINER_LANE
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import es
    from repro_torch.core.pow_train import PoUWTrainer
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.train.steps import make_eval_step, make_train_state
    cfg = get_config("pnpcoin-demo")
    shape = InputShape("es", ES_SEQ, ES_BATCH, "train")
    eval_step = make_eval_step(cfg)

    def trainer(device):
        return PoUWTrainer(cfg, shape, mode="optimal", n_miners=POUW_MINERS,
                           pop_size=ES_POP, sigma=ES_SIGMA, seed=0,
                           fixed_batch=True, device=device)

    run = _pouw_chain(dev, trainer, "pouw_es")
    mined, audited = run["mined"], run["audited"]
    want = 2 * cfg.n_layers * ES_POP * POUW_BLOCKS
    for what, counts in (("chain", mined), ("audit", audited)):
        check(counts["flash_attention"] == want
              and counts["flash_attention_training"] == 0
              and counts["flash_attention_bwd"] == counts["flash_attention_tc"]
              == counts["sha256"] == counts["merkle"] == 0,
              f"pouw_es {what}: {want} serving forward launches and no "
              f"other, got {counts}")
    payloads = run["net"].nodes[0].chain_payloads()
    losses = [p.loss for p in payloads]
    check(all(b <= a for a, b in zip(losses, losses[1:])),
          f"pouw_es: the accepted loss never rises: {losses}")
    check(all(p.winner // MINER_LANE == p.origin for p in payloads),
          "pouw_es: each winner is a lane of its block's miner")
    peak = torch.cuda.max_memory_allocated()

    # the example's ES-gradient demo: all submissions reused
    _zero_counts()
    t = time.perf_counter()
    pipe = SyntheticTokenPipeline(cfg, shape, seed=3)
    params = make_train_state(cfg, random.key(1), dev).params
    key, fixed = random.key(2), pipe.batch(0)
    demo_before = float(eval_step(params, fixed))
    for _ in range(ES_DEMO_STEPS):
        key, sub = random.split(key)
        step_losses, _ = es.es_block(eval_step, params, fixed, sub,
                                     pop_size=ES_POP, sigma=ES_SIGMA)
        params = es.es_update(params, sub, step_losses, sigma=ES_SIGMA,
                              lr=0.05)
    demo_after = float(eval_step(params, fixed))
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t
    demo = _counts()
    check(math.isfinite(demo_after) and demo["flash_attention"]
          == cfg.n_layers * (ES_DEMO_STEPS * ES_POP + 2),
          f"pouw_es demo: finite loss {demo_after}, "
          f"{cfg.n_layers * (ES_DEMO_STEPS * ES_POP + 2)} serving launches, "
          f"got {demo}")

    # the first block's search (run_block's split of the trainer's key)
    # on the card and on the CPU port
    def first_search(device):
        tr = trainer(device)
        _, sub = random.split(tr.key)
        got, best = es.es_block(eval_step, tr.state.params,
                                tr.pipeline.batch(0), sub, pop_size=ES_POP,
                                sigma=ES_SIGMA)
        return got.cpu(), int(best)
    card, card_best = first_search(dev)
    t = time.perf_counter()
    cpu, cpu_best = first_search("cpu")
    cpu_s = time.perf_counter() - t
    loss_err = float(((card - cpu).abs() / cpu.abs()).max())
    check(loss_err <= ES_LOSS_TOL and card_best == cpu_best,
          f"pouw_es: the first block's {ES_POP} candidate losses on the card "
          f"within {ES_LOSS_TOL} of the CPU port's ({loss_err}), winner "
          f"{card_best} against {cpu_best}")
    check(float(card[card_best]) == losses[0]
          and payloads[0].winner % MINER_LANE == card_best % POUW_MINERS,
          f"pouw_es: the chain's first block ({losses[0]}, winner "
          f"{payloads[0].winner}) is the card's search's "
          f"({float(card[card_best])}, candidate {card_best})")
    launches = {k: mined[k] + audited[k] + demo[k]
                for k in ("sha256", "merkle", "flash_attention",
                          "flash_attention_bwd")}
    return {"phase": "workloads", "part": "pouw_es",
            "config": f"pnpcoin-demo, optimal (ES) mode, batch {ES_BATCH} x "
                      f"{ES_SEQ} tokens (fixed), {ES_POP} candidates, sigma "
                      f"{ES_SIGMA}, {POUW_MINERS} miners",
            "attention_call": dict(zip("B S H Kv hd".split(), ES_ATTN)),
            **_pouw_line(run),
            "losses": losses, "winners": [p.winner for p in payloads],
            "first_block_search": {"card": card.tolist(),
                                   "cpu": cpu.tolist(),
                                   "max_rel_err": loss_err,
                                   "winner": card_best},
            "cpu_search_s": cpu_s, "peak_device_mb": peak / 1e6,
            "es_update_demo": {"steps": ES_DEMO_STEPS, "before": demo_before,
                               "after": demo_after, "seconds": demo_s},
            "counts_demo": _part_counts(demo), "launches": launches}


def gan_path(dev) -> dict:
    """``examples/torch_np_problems.py``'s network on the card: 2 nodes,
    ``NP_SAT_BLOCKS`` SAT blocks (12 variables, 48 clauses) and
    ``GAN_ROUNDS`` GAN-inversion rounds over 2**10 latents, miners
    alternating, each block verified by the peer; the example's
    assertions (error below 1.0, equal digests and books, both audits),
    and round 0's winner against the CPU port's; then one round over
    2**``MAIN_BITS`` latents, timed twice. Launches: SAT mines
    through SHA-256 and Merkle; a GAN round runs no hand kernel (its
    generator is two small products), so its counts are read on their own."""
    import torch
    from repro_torch.chain import Network, Node
    from repro_torch.chain.workloads import GanInversionWorkload, SatWorkload
    from repro_torch.core.executor import run_optimal
    timed = {}

    def make_node(i):
        wls = {"sat": SatWorkload(n_vars=NP_VARS, n_clauses=NP_CLAUSES,
                                  seed=1, device=dev),
               "gan": GanInversionWorkload(seed=0, grid_bits=GAN_GRID_BITS,
                                           device=dev)}
        for name, wl in wls.items():
            timed[f"node{i} {name}"] = []
            _timed_steps(wl, timed[f"node{i} {name}"])
        return Node(node_id=i, classic_arg_bits=6, device=dev,
                    workloads=wls)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    net = Network.create(2, node_factory=make_node)
    _zero_counts()
    sat_s = []
    for b in range(NP_SAT_BLOCKS):
        res = net.mine(b % 2, "sat")
        check(not res.rejected_by, f"gan part: SAT block {b} accepted")
        sat_s.append(res.receipt.block_time_s)
    torch.cuda.synchronize()
    sat_counts = _counts()
    _zero_counts()
    rounds = []
    for b in range(GAN_ROUNDS):
        res = net.mine(b % 2, "gan")
        check(not res.rejected_by, f"gan part: round {b} accepted")
        p = res.receipt.payload
        rounds.append({"round": p.train_height, "best_arg": p.best_arg,
                       "err": net.nodes[0].workloads["gan"]
                       .inversion_error(),
                       "block_time_s": res.receipt.block_time_s})
    torch.cuda.synchronize()
    gan_counts = _counts()
    a, b = (n.workloads["gan"] for n in net.nodes)
    err = a.inversion_error()
    check(err < 1.0, f"gan part: inverted, error {err} below 1.0")
    check(a.state_digest() == b.state_digest(),
          "gan part: both nodes hold the same grid state")
    check(net.converged() and all(n.audit_chain() for n in net.nodes)
          and len({tuple(sorted(n.book.balances.items()))
                   for n in net.nodes}) == 1,
          "gan part: converged, audited, books equal")
    check(all(gan_counts[k] == 0 for k in ("flash_attention", "sha256",
                                            "merkle")),
          f"gan part: a GAN round launches no hand kernel, got {gan_counts}")
    cpu = GanInversionWorkload(seed=0, grid_bits=GAN_GRID_BITS, device="cpu")
    cpu_arg = run_optimal(cpu._round_jash(), device="cpu").best_arg
    check(cpu_arg == rounds[0]["best_arg"],
          f"gan part: round 0's winner on the card {rounds[0]['best_arg']} "
          f"is the CPU port's {cpu_arg}")
    # a round over 2**MAIN_BITS latents, the mining paths' width: the
    # grid's draws and the generator on the card, twice
    wide = GanInversionWorkload(seed=0, grid_bits=MAIN_BITS, device=dev)
    wide_s, wide_args = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        wide_args.append(run_optimal(wide._round_jash(),
                                     device=dev).best_arg)
        torch.cuda.synchronize()
        wide_s.append(time.perf_counter() - t)
    check(wide_args[0] == wide_args[1],
          f"gan part: a round over 2**{MAIN_BITS} latents finds one winner "
          f"twice, got {wide_args}")
    return {"phase": "workloads", "part": "gan",
            "config": f"SAT {NP_VARS} variables x {NP_CLAUSES} clauses, "
                      f"{NP_SAT_BLOCKS} blocks; GAN inversion d_z 8, d_x "
                      f"32, 2**{GAN_GRID_BITS} latents, {GAN_ROUNDS} rounds",
            "sat_block_time_s": sat_s, "rounds": rounds,
            "inversion_error": err, "round_0_best_arg_cpu": cpu_arg,
            f"round_over_2**{MAIN_BITS}_latents_s": wide_s,
            "steps_s_by_node": _steps_s(timed),
            "peak_device_mb": torch.cuda.max_memory_allocated() / 1e6,
            "counts_sat": _part_counts(sat_counts),
            "counts_gan": _part_counts(gan_counts),
            "launches": {k: sat_counts[k] + gan_counts[k]
                         for k in ("sha256", "merkle", "flash_attention",
                                   "flash_attention_bwd")}}


def _train_cli(args, out_dir, meanwhile=None) -> dict:
    """``python -m repro_torch.launch.train`` with ``args`` as a process of
    its own on the card, its files under ``out_dir``: exit code, seconds,
    the printed blocks and the last line. ``meanwhile()``, if given, runs
    in this process while the CLI's runs (work that needs no card: the
    CLI's process holds it); its result comes back under
    ``"meanwhile"``."""
    import os
    import re
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t = time.perf_counter()
    # its output into files, not pipes, which nobody reads while
    # ``meanwhile`` runs
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *args,
             "--out", str(out_dir)], stdout=out, stderr=err, text=True,
            cwd=ROOT, env=env)
        try:
            done = meanwhile() if meanwhile is not None else None
            proc.wait(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    seconds = time.perf_counter() - t
    check(proc.returncode == 0, f"train CLI {args}: exit {proc.returncode}, "
          f"{stderr[-3000:]}")
    lines = stdout.splitlines()
    blocks = {int(h): float(loss) for h, loss in re.findall(
        r"block +(\d+) mode=\w+ loss=([-0-9.naif]+)", stdout)}
    check(lines and lines[-1].startswith("done:")
          and lines[-1].endswith("chain verified."),
          f"train CLI {args}: {lines[-3:]}")
    return {"args": args, "seconds": seconds, "printed": lines,
            "losses_printed": blocks, "meanwhile": done}


def train_cli_path(dev, during_cli=()) -> dict:
    """``python -m repro_torch.launch.train --arch qwen3-0.6b`` at the
    reference driver's defaults (batch 32 x 256, full mode, 8 miners) on
    the card, ``CLI_BLOCKS`` blocks with a checkpoint every
    ``CLI_CKPT_EVERY``, as its own process: the chain verifies
    (``ledger.json``), each checkpoint's SHA-256 equals its file's. Then
    ``CLI_ES_BLOCKS`` optimal-mode blocks through the CLI (``--mode
    optimal``), a second process: its ledger verifies, every block
    optimal. While it runs, this process builds a fresh trainer of the
    first run (the build timed, the step's review timed within it), which
    then audits that chain by replay, as a verifier does: every block's
    state digest and hash,
    the last block's included, equal the CLI's (across processes, so the
    card's products repeat bit for bit), block 0's batch scores lower
    after the blocks than before them, at the config's ``remat``: 56 training-instance forward (each
    layer's again in the backward) and 28 backward launches a step on the
    tensor cores and no other kernel, and the last checkpoint
    loads to the replay's ``state_digest``; a step split by CUDA events,
    with its peak device memory (``chip_probes.py remat_step`` times it
    without remat too); peak device memory; the threefry init drawn again
    on the card (timed alone) is the trainer's bit for bit; an ES
    candidate's time at full width. And qwen3-0.6b cut to ``CUT_LAYERS``
    layers at full width: a card trainer's blocks against the CPU port's
    training step from the same initial state (``cut_on_card``; its card
    half runs first, its CPU half while the CLI's process runs, and with
    it ``during_cli``, other parts' work that fits beside the CLI's 32 GB
    on the card: the CLI's seconds are taken on a shared card)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import ledger_from_json
    from repro_torch.core import es as es_mod
    from repro_torch.core.pow_train import PoUWTrainer
    from repro_torch.train import checkpoint
    from repro_torch.train.steps import (TrainHparams, make_train_state,
                                         params_digest)
    cfg = get_config("qwen3-0.6b")
    B, S = 32, 256
    out_dir = ROOT / "build" / "train_cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    # the cut's card half first; its CPU half runs while the CLI's process
    # holds the card
    t = time.perf_counter()
    cut_cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    cut_ctx = cut_on_card(cut_cfg, lambda config: _cut_trainer(config, dev))
    torch.cuda.empty_cache()
    try:
        cli = _train_cli(["--arch", "qwen3-0.6b", "--blocks",
                          str(CLI_BLOCKS), "--ckpt-every",
                          str(CLI_CKPT_EVERY)], out_dir / "full",
                         meanwhile=lambda: [
                             cut_on_cpu(cut_cfg, cut_ctx, "train_cli"),
                             *(job() for job in during_cli)])
        cut = cli.pop("meanwhile")[0]
        cut["seconds"] = time.perf_counter() - t
        del cut_ctx
        ledger = ledger_from_json((out_dir / "full" /
                                   "ledger.json").read_text())
        check(ledger.verify_chain() and ledger.height == CLI_BLOCKS,
              "train CLI: its ledger.json verifies")
        ckpts = {}
        for b in range(CLI_CKPT_EVERY, CLI_BLOCKS + 1, CLI_CKPT_EVERY):
            path = out_dir / "full" / f"ckpt_{b}.npz"
            meta = json.loads(Path(str(path) + ".meta.json").read_text())
            t = time.perf_counter()
            digest = checkpoint.file_digest(str(path))
            ckpts[b] = {"bytes": path.stat().st_size, "sha256": digest,
                        "hash_s": time.perf_counter() - t}
            check(meta["sha256"] == digest and meta["block"] == b
                  and meta["ledger_tip"] == ledger.blocks[b - 1].block_hash
                  and any(f"sha256={digest[:16]}" in ln
                          for ln in cli["printed"]),
                  f"train CLI: checkpoint {b}'s SHA-256 is its file's")

        # the same run in this process: the replay, its trainer built while
        # the CLI mines CLI_ES_BLOCKS blocks in optimal mode
        hp = TrainHparams(peak_lr=3e-4, warmup_steps=max(CLI_BLOCKS // 20, 5),
                          total_steps=CLI_BLOCKS)

        def build():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            review, _, restore = _timed_review_and_digest()
            try:
                t = time.perf_counter()
                tr = PoUWTrainer(cfg, InputShape("cli", S, B, "train"),
                                 hp=hp, mode="full", n_miners=8, pop_size=8,
                                 sigma=0.02, device=dev)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t
            finally:
                restore()
            return tr, build_s, sum(review), params_digest(tr.state)
        es = _train_cli(["--arch", "qwen3-0.6b", "--blocks",
                         str(CLI_ES_BLOCKS), "--mode", "optimal",
                         "--ckpt-every", "0"], out_dir / "optimal",
                        meanwhile=build)
        tr, build_s, review_s, init_digest = es.pop("meanwhile")
        es_ledger = ledger_from_json((out_dir / "optimal" /
                                      "ledger.json").read_text())
        check(es_ledger.verify_chain() and es_ledger.height == CLI_ES_BLOCKS
              and all(b.mode == "optimal" for b in es_ledger.blocks)
              and len(es["losses_printed"]) == CLI_ES_BLOCKS
              and all(np.isfinite(list(es["losses_printed"].values()))),
              "train CLI --mode optimal: its ledger verifies, every block "
              "optimal")
        _zero_counts()
        block_s = []
        for _ in range(CLI_BLOCKS):
            t = time.perf_counter()
            tr.run_block()
            torch.cuda.synchronize()
            block_s.append(time.perf_counter() - t)
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        # remat (the config's): each layer's forward runs again in the
        # backward, so the training instance launches twice a layer
        layers = cfg.n_layers * CLI_BLOCKS
        check(cfg.remat and counts["flash_attention_tc"] == counts[
                  "flash_attention_tc_training"] == 2 * layers
              and counts["flash_attention_tc_bwd"] == layers
              and all(counts[k] == 0 for k in (
                  "flash_attention", "flash_attention_bwd", "sha256",
                  "merkle", "wkv6", "decay_scan")),
              f"train_cli: with remat, 2 x {cfg.n_layers} training-instance "
              f"forward and {cfg.n_layers} backward launches a step and no "
              f"other kernel, got {counts}")
        check([r.state_digest for r in tr.history]
              == [blk.state_digest for blk in ledger.blocks]
              and [r.block_hash for r in tr.history]
              == [blk.block_hash for blk in ledger.blocks],
              f"train_cli: the audit replay in this process gives the CLI's "
              f"digests and block hashes, block {CLI_BLOCKS - 1}'s included")
        losses = [r.loss for r in tr.history]
        # the training moves the loss: block 0's batch scores lower after
        # the blocks than before them (each block's loss is on its own
        # batch, and 4 blocks of warm-up steps move it less than the
        # batches differ)
        loss_after = float(tr._eval_step(tr.state.params,
                                         tr.pipeline.batch(0)))
        check(all(np.isfinite(losses)) and loss_after < losses[0]
              and abs(cli["losses_printed"][0] - losses[0]) < 1e-4,
              f"train_cli: block 0's batch scores {loss_after} after "
              f"{CLI_BLOCKS} blocks, below its {losses[0]} before: {losses}")
        t = time.perf_counter()
        loaded, digest = checkpoint.load_checkpoint(
            str(out_dir / "full" / f"ckpt_{CLI_BLOCKS}.npz"), tr.state)
        load_s = time.perf_counter() - t
        check(digest == ckpts[CLI_BLOCKS]["sha256"]
              and checkpoint.state_digest(loaded)
              == checkpoint.state_digest(tr.state)
              and params_digest(loaded) == ledger.blocks[-1].state_digest,
              "train_cli: the last checkpoint loads to the trainer's state")
        del loaded
        split = step_split(cfg, tr.state, tr.pipeline.batch(0), hp, reps=3)
        # the build's first half: the threefry init of 596M weights on the
        # card (the rest is the step's review)
        torch.cuda.synchronize()
        t = time.perf_counter()
        init = make_train_state(cfg, random.key(0), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        check(params_digest(init) == init_digest, "train_cli: the init drawn "
              "again on the card is the trainer's bit for bit")
        del init
        # an ES candidate at full width: its noise and its scored loss
        batch = tr.pipeline.batch(0)
        key = random.key(7)
        _zero_counts()
        t = time.perf_counter()
        cand = es_mod.candidate_params(tr.state.params, key, 1, 0.02)
        loss = tr._eval_step(cand, batch)
        torch.cuda.synchronize()
        candidate_s = time.perf_counter() - t
        es_counts = _counts()
        check(bool(torch.isfinite(loss)) and es_counts["flash_attention_tc"]
              == cfg.n_layers and es_counts["flash_attention_tc_training"]
              == 0, f"train_cli: an ES candidate scores through the serving "
                    f"instance, {es_counts}")
        del tr, cand, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"phase": "workloads", "part": "train_cli",
            "config": f"qwen3-0.6b ({cfg.n_layers} layers, d_model "
                      f"{cfg.d_model}, {cfg.n_heads} heads over "
                      f"{cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, vocab "
                      f"{cfg.vocab_size}, {cfg.dtype} weights, "
                      f"{cfg.opt_dtype} AdamW moments), full mode, batch {B}"
                      f" x {S} tokens, 8 miners, {hp}",
            "attention_call": dict(zip("B S H Kv hd".split(), CLI_ATTN)),
            "cli_seconds": cli["seconds"], "cli_printed": cli["printed"],
            "checkpoints": ckpts, "checkpoint_load_s": load_s,
            "trainer_build_s": build_s, "review_s": review_s,
            "init_and_rest_s": build_s - review_s, "init_on_card_s": init_s,
            "block_s": block_s,
            "losses": losses, "block_0_batch_loss_after": loss_after,
            "step_split": split,
            "peak_device_mb": peak / 1e6, "counts": counts,
            "es_candidate_s": candidate_s,
            "es_cli_seconds": es["seconds"], "es_printed": es["printed"],
            "cut": cut,
            "launches": {
                "flash_attention_tc": counts["flash_attention_tc"]
                + es_counts["flash_attention_tc"],
                "flash_attention_tc_bwd": counts["flash_attention_tc_bwd"],
                "flash_attention": 0, "flash_attention_bwd": 0,
                "sha256": 0, "merkle": 0}}


def _leaf_errs(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| of each leaf (float32 on the host), by
    path; a leaf whose ``want`` is all zero gives ||got||."""
    import torch
    out = {}
    for path, w in want.items():
        w = w.float().cpu()
        diff = float(torch.linalg.vector_norm(got[path].float().cpu() - w))
        norm = float(torch.linalg.vector_norm(w))
        out[path] = diff / norm if norm else diff
    return out


def _grads_by_path(cfg, params, batch) -> dict:
    """The gradient of ``cfg``'s training loss at ``params`` on ``batch``,
    leaf by leaf as the train step takes it, on the host."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.steps import _flatten_with_path
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _ = build_model(cfg).loss(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return {path: g.cpu() for (path, _), g in
            zip(_flatten_with_path(live), grads)}


def cut_on_card(cut, make_trainer) -> dict:
    """A model cut to a few layers at full width (qwen3-0.6b for
    ``train_cli``, recurrentgemma-2b and rwkv6-7b for ``train_hybrid`` and
    ``train_ssm``): a card trainer from
    ``make_trainer(cut)`` against the CPU port's training step from the
    same initial state (copied from the card: a host draw of a cut's
    weights takes minutes) on the same batches. Held leaf by leaf, not
    only by the loss, which one step at this init moves by ~1e-3 of
    itself: each leaf's gradient at the initial state on block 0's batch
    (``CUT_GRAD_TOL[part]``), the norm of each leaf's change in block 0
    (``CUT_UPDATE_TOL``; a bf16 weight whose update sits at a rounding
    edge moves by an ulp on one device and not on the other, so the change
    is held by its norm) and each block's loss (``CUT_LOSS_TOL``). Beside the readings, what
    the same measure gives for two faults: the gradient of block 1's batch
    in place of block 0's, and a block that changes nothing. This is the card's
    half, which frees the card when done; the CPU's half
    (``cut_on_cpu``) needs only the host, so a part may run it while a
    process of its own holds the card."""
    import torch
    from repro_torch.optim.adamw import AdamWState, tree_map
    from repro_torch.train.steps import TrainState, _flatten_with_path

    def host(tree):
        return tree_map(lambda t: t.detach().cpu().clone(), tree)

    t = time.perf_counter()
    tr = make_trainer(cut)
    build_s = time.perf_counter() - t
    batches = [tr.pipeline.batch(b) for b in range(CUT_BLOCKS)]
    start = TrainState(params=host(tr.state.params),
                       opt=AdamWState(*(host(x) for x in tr.state.opt)))
    p0 = dict(_flatten_with_path(start.params))
    t = time.perf_counter()
    card_grads = _grads_by_path(cut, tr.state.params, batches[0])
    # the fault: block 1's batch in place of block 0's (on the card: a
    # host backward at full width costs the script seconds)
    wrong = _grads_by_path(cut, tr.state.params, batches[1])
    card = [tr.run_block().loss]
    p1 = dict(_flatten_with_path(host(tr.state.params)))
    card += [r.loss for r in tr.run(CUT_BLOCKS - 1)]
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t
    hp = tr.hp
    del tr
    torch.cuda.empty_cache()
    return {"start": start, "batches": batches, "hp": hp, "p0": p0,
            "p1": p1, "card": card, "card_grads": card_grads,
            "wrong": wrong, "build_s": build_s, "cuda_s": cuda_s}


def cut_on_cpu(cut, ctx: dict, part: str) -> dict:
    """The CPU half of a cut's comparison, from ``cut_on_card``'s record: the CPU
    port's gradient and steps from the same state, the comparison, its
    line and its checks."""
    import torch
    from repro_torch.train.steps import _flatten_with_path, make_train_step
    start, batches, p0 = ctx["start"], ctx["batches"], ctx["p0"]
    card, card_grads, wrong = ctx["card"], ctx["card_grads"], ctx["wrong"]
    step = make_train_step(cut, ctx["hp"])
    t = time.perf_counter()
    host_grads = _grads_by_path(cut, start.params, batches[0])
    cpu, state = [], start
    for b in range(CUT_BLOCKS):
        state, metrics = step(state, batches[b])
        cpu.append(float(metrics["loss"]))
        if b == 0:
            q1 = dict(_flatten_with_path(state.params))
    cpu_s = time.perf_counter() - t

    def change_norms(p):
        return {k: float(torch.linalg.vector_norm(p[k].float()
                                                  - p0[k].float()))
                for k in p0}

    def norm_errs(got, want):
        # |a - b| / max(a, b): a leaf that moves on one device only gives 1
        return {k: abs(got[k] - want[k]) / max(got[k], want[k])
                if max(got[k], want[k]) else 0.0 for k in want}

    grad_errs = _leaf_errs(card_grads, host_grads)
    card_change, cpu_change = change_norms(ctx["p1"]), change_norms(q1)
    update_errs = norm_errs(card_change, cpu_change)
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(card, cpu))
    # each fault measured as the check measures the card: its worst leaf
    controls = {
        "grad_of_block_1s_batch": max(_leaf_errs(wrong, host_grads).values()),
        "update_left_out": max(norm_errs(dict.fromkeys(p0, 0.0),
                                         cpu_change).values())}
    rec = {"layers": cut.n_layers, "batch": CUT_BATCH, "seq": CUT_SEQ,
           "card_losses": card, "cpu_losses": cpu, "loss_rel_err": loss_err,
           "grad_rel_err_by_leaf": grad_errs,
           "change_norm_by_leaf": {"card": card_change, "cpu": cpu_change},
           "change_norm_rel_err_by_leaf": update_errs,
           "worst_leaf": {"grad": max(grad_errs.values()),
                          "change_norm": max(update_errs.values())},
           "faults_worst_leaf": controls,
           "build_s": ctx["build_s"], "cuda_s": ctx["cuda_s"], "cpu_s": cpu_s}
    emit({"phase": "workloads", "part": f"{part}_cut", **rec})
    grad_tol = CUT_GRAD_TOL[part]
    check(rec["worst_leaf"]["grad"] <= grad_tol,
          f"{part}: the cut's gradients on the card within {grad_tol} "
          f"of the CPU port's, leaf by leaf: {grad_errs}")
    check(rec["worst_leaf"]["change_norm"] <= CUT_UPDATE_TOL,
          f"{part}: the cut's block-0 change on the card within "
          f"{CUT_UPDATE_TOL} of the CPU port's, leaf by leaf: {update_errs}")
    check(loss_err <= CUT_LOSS_TOL, f"{part}: the cut's card losses "
          f"{card} within {CUT_LOSS_TOL} of the CPU port's {cpu}")
    check(controls["grad_of_block_1s_batch"] > grad_tol
          and controls["update_left_out"] > CUT_UPDATE_TOL,
          f"{part}: the faults measured beside the cut exceed the "
          f"limits: {controls}")
    return {k: rec[k] for k in ("layers", "batch", "seq", "card_losses",
                                "cpu_losses", "loss_rel_err", "worst_leaf",
                                "faults_worst_leaf", "build_s", "cuda_s",
                                "cpu_s")}


def _timed_review_and_digest():
    """Wrap the step's review (``TrainStepJash.validate``) and the block's
    host state digest so each call appends its seconds; returns the two
    lists and a function that restores both."""
    from repro_torch.core import pow_train
    review, digest = [], []
    validate, light = pow_train.TrainStepJash.validate, \
        pow_train._light_state_digest

    def timed_validate(self, *a, **kw):
        t = time.perf_counter()
        out = validate(self, *a, **kw)
        review.append(time.perf_counter() - t)
        return out

    def timed_digest(state):
        t = time.perf_counter()
        out = light(state)
        digest.append(time.perf_counter() - t)
        return out
    pow_train.TrainStepJash.validate = timed_validate
    pow_train._light_state_digest = timed_digest

    def restore():
        pow_train.TrainStepJash.validate = validate
        pow_train._light_state_digest = light
    return review, digest, restore


def _review_each_step_once():
    """Phase 5 builds many trainers of one step: a node's, an audit's, a
    recovery's, a verifier's replay. Each build reviews the step
    (``TrainStepJash.validate``: two exports on fake CPU tensors, 2-50 s
    a build on the card's host), and every review of one step exports
    the same two programs. For the script's time, a build in this process
    whose step (its id, config and hparams, the state's and the batch's
    shapes and dtypes) a build before it reviewed skips the review; the
    first review of each step runs and is timed. Returns the record
    (each step's first review in seconds, the reviews skipped) and a
    function that restores the trainer."""
    from repro_torch.core import pow_train
    init = pow_train.PoUWTrainer.__init__
    validate = pow_train.TrainStepJash.validate
    record = {"first_reviews": [], "skipped": 0}
    reviewed = set()
    building = []

    def signature(tree):
        if isinstance(tree, dict):
            return tuple((k, signature(v)) for k, v in sorted(tree.items()))
        if isinstance(tree, tuple):
            return tuple(signature(v) for v in tree)
        return tuple(tree.shape), str(tree.dtype)

    def trainer_init(self, *args, **kwargs):
        building.append(self)
        try:
            init(self, *args, **kwargs)
        finally:
            building.pop()

    def once(self, state, batch, **kwargs):
        if not building:
            return validate(self, state, batch, **kwargs)
        tr = building[-1]
        key = (self.source_id(), repr(tr.cfg), repr(tr.hp),
               signature(state), signature(batch))
        if key in reviewed:
            record["skipped"] += 1
            return None
        t = time.perf_counter()
        out = validate(self, state, batch, **kwargs)
        reviewed.add(key)
        record["first_reviews"].append({
            "config": f"{tr.cfg.name}, {tr.cfg.n_layers} layers, "
                      f"{tr.cfg.dtype}", "shape": repr(tr.shape),
            "seconds": time.perf_counter() - t})
        return out
    pow_train.PoUWTrainer.__init__ = trainer_init
    pow_train.TrainStepJash.validate = once

    def restore():
        pow_train.PoUWTrainer.__init__ = init
        pow_train.TrainStepJash.validate = validate
    return record, restore


def _host_like(tree):
    """A tree like ``tree`` (dicts and named tuples) of empty host tensors
    of its leaves' dtypes: a template that loads a checkpoint to the
    host."""
    import torch
    if isinstance(tree, tuple):
        return type(tree)(*(_host_like(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _host_like(v) for k, v in tree.items()}
    return torch.empty(0, dtype=tree.dtype)


def _recurrent_counts_check(counts, want, what) -> None:
    """Every kernel's launches in ``counts`` are ``want``'s (0 where it does
    not name one)."""
    names = [k for k in counts if k not in ("hashlib_fallbacks",)]
    got = {k: counts[k] for k in names}
    full = {k: want.get(k, 0) for k in names}
    check(got == full, f"{what}: launches {got}, expected {full}")


def _train_recurrent(dev, cfg, batch, blocks, what, want_counts) -> dict:
    """A ``PoUWTrainer`` of ``cfg`` (full mode, 8 miners, batch x 256, the
    train CLI's hparams for ``blocks`` blocks) built on the card and run
    ``blocks`` blocks, with its build split into the threefry init and the
    step's review, each block's seconds with the host state digest's share,
    the launch counts (checked against ``want_counts`` a block) and the
    peak device memory. Returns the record and the trainer."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core.pow_train import PoUWTrainer
    from repro_torch.train.steps import TrainHparams
    hp = TrainHparams(peak_lr=3e-4, warmup_steps=max(blocks // 20, 5),
                      total_steps=blocks)
    review, digest, restore = _timed_review_and_digest()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        tr = PoUWTrainer(cfg, InputShape("cli", 256, batch, "train"), hp=hp,
                         mode="full", n_miners=8, pop_size=8, sigma=0.02,
                         device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        _zero_counts()
        block_s = []
        for _ in range(blocks):
            t = time.perf_counter()
            tr.run_block()
            torch.cuda.synchronize()
            block_s.append(time.perf_counter() - t)
        counts = _counts()
    finally:
        restore()
    _recurrent_counts_check(counts, {k: n * blocks for k, n in
                                     want_counts.items()}, what)
    losses = [r.loss for r in tr.history]
    check(all(math.isfinite(x) for x in losses), f"{what}: finite losses "
                                                  f"{losses}")
    rec = {"trainer_build_s": build_s, "review_s": sum(review),
           "init_and_rest_s": build_s - sum(review), "block_s": block_s,
           "host_digest_s": digest[-blocks:],
           "host_digest_share": sum(digest[-blocks:]) / sum(block_s),
           "losses": losses, "peak_device_mb":
               torch.cuda.max_memory_allocated() / 1e6, "counts": counts,
           "hparams": str(hp)}
    return rec, tr


def train_hybrid_path(dev, cut_ctx: dict, host_work=()) -> dict:
    """``python -m repro_torch.launch.train --arch recurrentgemma-2b`` at
    full width and depth (26 layers: 18 RG-LRU and 8 local-attention, d
    2560, vocab 256,000, bf16 weights, float32 AdamW moments, ``remat`` as
    configured) as a process of its own, at the driver's defaults but
    ``--batch HYBRID_BATCH``, ``--blocks HYBRID_BLOCKS`` and one checkpoint
    (``--ckpt-every HYBRID_BLOCKS``), cut for the card's memory and the
    script's time: its ledger verifies and the checkpoint's SHA-256 is its
    file's. Then in this process the same run again, a verifier's audit
    replay: its build split into the threefry init and the step's review,
    each block's state digest and hash equal the CLI's, each step's
    launches (the decay scan's forward twice a RG-LRU layer with remat and
    its backward once; the tensor-core forward's hd-256 training instance
    twice an attention layer and the hd-256 backward once; no other
    kernel), the block time with the host digest's share, the peak device
    memory; the checkpoint loads (to the host) to the replay's state
    digest (its params; the CLI printed the file's SHA-256 as its meta
    holds it); a step split by CUDA events. Then recurrentgemma-2b cut to 3
    layers (rec, rec, attn) at full width against the CPU port's step from
    the same state, leaf by leaf (``cut_on_card``, ``cut_on_cpu``: its card
    half, ``cut_ctx``, ran before, beside the qwen3 CLI; its CPU half runs
    while this part's CLI process runs, and with it ``host_work``,
    functions of other parts that need only the host)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import ledger_from_json
    from repro_torch.train import checkpoint
    from repro_torch.train.steps import params_digest
    cfg = get_config("recurrentgemma-2b")
    n_rec = sum(1 for i in range(cfg.n_layers)
                if cfg.pattern[i % len(cfg.pattern)] == "rec")
    n_attn = cfg.n_layers - n_rec
    B, blocks = HYBRID_BATCH, HYBRID_BLOCKS
    out_dir = ROOT / "build" / "train_hybrid"
    shutil.rmtree(out_dir, ignore_errors=True)
    # the cut's card half ran earlier (``cut_ctx``); its CPU half, and the
    # CPU halves other parts left (``host_work``), run while the CLI's
    # process holds the card
    t = time.perf_counter()

    def meanwhile():
        out = cut_on_cpu(hybrid_cut(cfg), cut_ctx, "train_hybrid")
        out["seconds"] = time.perf_counter() - t
        return [out] + [job() for job in host_work]
    try:
        cli = _train_cli(["--arch", "recurrentgemma-2b", "--batch", str(B),
                          "--blocks", str(blocks), "--ckpt-every",
                          str(blocks)], out_dir, meanwhile=meanwhile)
        cut, *others = cli.pop("meanwhile")
        ledger = ledger_from_json((out_dir / "ledger.json").read_text())
        check(ledger.verify_chain() and ledger.height == blocks,
              "train_hybrid: the CLI's ledger.json verifies")
        path = out_dir / f"ckpt_{blocks}.npz"
        meta = json.loads(Path(str(path) + ".meta.json").read_text())
        check(meta["block"] == blocks
              and meta["ledger_tip"] == ledger.blocks[-1].block_hash
              and any(f"sha256={meta['sha256'][:16]}" in ln
                      for ln in cli["printed"]),
              "train_hybrid: the checkpoint's meta names its block and tip")

        want = {"decay_scan": 2 * n_rec if cfg.remat else n_rec,
                "decay_scan_bwd": n_rec,
                "flash_attention_tc": 2 * n_attn if cfg.remat else n_attn,
                "flash_attention_tc_training":
                    2 * n_attn if cfg.remat else n_attn,
                "flash_attention_mma_bwd": n_attn}
        run, tr = _train_recurrent(dev, cfg, B, blocks, "train_hybrid", want)
        check([r.state_digest for r in tr.history]
              == [blk.state_digest for blk in ledger.blocks]
              and [r.block_hash for r in tr.history]
              == [blk.block_hash for blk in ledger.blocks]
              and abs(cli["losses_printed"][0] - run["losses"][0]) < 1e-4,
              "train_hybrid: the audit replay in this process gives the "
              "CLI's digests and block hashes")
        # the checkpoint's params, loaded to the host (a second state on
        # the card would not fit beside the trainer's; its float32 moments,
        # 23 GB, and a second hash of the file would cost the script ~70 s)
        t = time.perf_counter()
        with np.load(str(path)) as npz:
            loaded = checkpoint._unflatten(_host_like(tr.state.params), npz,
                                           ".params")
            step = int(npz[".opt/.step"])
        load_s = time.perf_counter() - t
        ckpt = {"bytes": path.stat().st_size, "sha256": meta["sha256"]}
        check(params_digest(loaded) == tr.history[-1].state_digest
              and step == int(tr.state.opt.step),
              "train_hybrid: the checkpoint's params load to the replay's "
              "state_digest")
        del loaded
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    batch = tr.pipeline.batch(0)
    hp = tr.hp
    box = [tr.state]
    del tr
    torch.cuda.empty_cache()
    # one step after the warm-up: at batch 16 a step holds two states
    # (70 GB), and the allocator's free pieces of the last step's state
    # may not hold the next one's largest tensors
    split = step_split(cfg, box, batch, hp, reps=1)
    del box, batch
    torch.cuda.empty_cache()
    per_step = {k: n for k, n in want.items()}
    return {"phase": "workloads", "part": "train_hybrid",
            "config": f"recurrentgemma-2b ({cfg.n_layers} layers: {n_rec} "
                      f"RG-LRU (lru {cfg.lru_width}) and {n_attn} local "
                      f"attention ({cfg.n_heads} heads over "
                      f"{cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, window "
                      f"{cfg.window}), d_model {cfg.d_model}, d_ff "
                      f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype} "
                      f"weights, {cfg.opt_dtype} AdamW moments, remat "
                      f"{cfg.remat}), full mode, batch {B} x 256 tokens, 8 "
                      "miners",
            "cuts": {"--batch": f"{B} (the driver's default 32 needs more "
                                "than the card's 80 GB)",
                     "--blocks": f"{blocks} (the default 200: time)",
                     "--ckpt-every": f"{blocks} (one checkpoint: time)"},
            "cli_seconds": cli["seconds"], "cli_printed": cli["printed"],
            "checkpoint": ckpt, "checkpoint_params_load_to_host_s": load_s,
            **run, "step_split": split, "launches_a_step": per_step,
            "cut": cut, "host_work_during_the_cli": others,
            "launches": {k: run["counts"][k] for k in (
                "decay_scan", "decay_scan_bwd", "flash_attention_tc",
                "flash_attention_mma_bwd", "sha256", "merkle")}}


def hybrid_cut(cfg):
    """recurrentgemma-2b cut to one group of its pattern (rec, rec, attn)
    at full width."""
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern))


def ssm_cut(cfg):
    """rwkv6-7b cut to ``SSM_CUT_LAYERS`` layers at full width."""
    return dataclasses.replace(cfg, n_layers=SSM_CUT_LAYERS)


def recurrent_cuts_on_card(dev) -> dict:
    """The card halves of the recurrent parts' cuts (``cut_on_card``):
    recurrentgemma-2b's 3 layers and rwkv6-7b's 2, at full width; about 20
    GB of the card each at their peaks, so they fit beside the qwen3
    CLI's process."""
    from repro_torch.configs import get_config
    return {part: cut_on_card(cut(get_config(arch)),
                              lambda config: _cut_trainer(config, dev))
            for part, arch, cut in (
                ("train_hybrid", "recurrentgemma-2b", hybrid_cut),
                ("train_ssm", "rwkv6-7b", ssm_cut))}


def _cut_trainer(config, dev):
    """A card trainer for ``cut_on_card``: the train CLI's run at
    ``CUT_BATCH`` x ``CUT_SEQ`` for ``CUT_BLOCKS`` blocks."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.pow_train import PoUWTrainer
    from repro_torch.train.steps import TrainHparams
    return PoUWTrainer(config, InputShape("cli", CUT_SEQ, CUT_BATCH, "train"),
                       hp=TrainHparams(peak_lr=3e-4, warmup_steps=5,
                                       total_steps=CUT_BLOCKS),
                       mode="full", n_miners=8, pop_size=8, sigma=0.02,
                       device=dev)


def train_ssm_path(dev, cut_ctx: dict, host_work: list) -> dict:
    """rwkv6-7b at full width (d 4096, 64 WKV heads of 64, d_ff 14,336,
    vocab 65,536, bf16 weights, float32 AdamW moments, ``remat``), cut to
    ``SSM_LAYERS`` of its 32 layers (all 32 need ~97 GB of weights,
    gradients and moments), through the trainer the train CLI builds
    (``PoUWTrainer``, full mode, 8 miners) in this process at the CLI's
    batch 32 x 256: ``SSM_BLOCKS`` blocks, each step's launches (WKV-6's
    forward twice a layer with remat, its backward once; no other kernel),
    the build split into init and review, the block time with the host
    digest's share, the peak device memory; then an audit replay (a second
    trainer of the same run, after the first is freed; its review, the
    first's, is skipped) whose digests and block hashes equal the first's;
    a step split by CUDA events; then a 2-layer cut at full width against
    the CPU port's step from the same state, leaf by leaf
    (``cut_on_card``): its card half, ``cut_ctx``, ran
    beside the qwen3 CLI; its CPU half is appended to ``host_work``, which
    train_hybrid runs while its CLI's process holds the card."""
    import torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=SSM_LAYERS)
    want = {"wkv6": 2 * cfg.n_layers if cfg.remat else cfg.n_layers,
            "wkv6_bwd": cfg.n_layers}
    run, tr = _train_recurrent(dev, cfg, SSM_BATCH, SSM_BLOCKS, "train_ssm",
                               want)
    miner = [(r.state_digest, r.block_hash) for r in tr.history]
    batch, hp = tr.pipeline.batch(0), tr.hp
    del tr
    torch.cuda.empty_cache()
    replay, tr = _train_recurrent(dev, cfg, SSM_BATCH, SSM_BLOCKS,
                                  "train_ssm replay", want)
    check([(r.state_digest, r.block_hash) for r in tr.history] == miner,
          "train_ssm: the audit replay gives the miner's digests and block "
          "hashes")
    box = [tr.state]
    del tr
    torch.cuda.empty_cache()
    split = step_split(cfg, box, batch, hp, reps=2)
    del box, batch
    torch.cuda.empty_cache()
    host_work.append(lambda: cut_on_cpu(ssm_cut(cfg), cut_ctx, "train_ssm"))
    return {"phase": "workloads", "part": "train_ssm",
            "config": f"rwkv6-7b at full width ({cfg.n_layers} of 32 layers, "
                      f"d_model {cfg.d_model}, {cfg.d_model // cfg.wkv_head_dim}"
                      f" WKV heads of {cfg.wkv_head_dim}, d_ff {cfg.d_ff}, "
                      f"vocab {cfg.vocab_size}, {cfg.dtype} weights, "
                      f"{cfg.opt_dtype} AdamW moments, remat {cfg.remat}), "
                      f"full mode, batch {SSM_BATCH} x 256 tokens, 8 miners",
            "cuts": {"layers": f"{SSM_LAYERS} of 32 (all 32: ~97 GB of "
                               "state)",
                     "blocks": f"{SSM_BLOCKS} (time)"},
            **run, "replay": {k: replay[k] for k in (
                "trainer_build_s", "review_s", "block_s", "losses")},
            "step_split": split, "launches_a_step": want,
            "cut": "its CPU half runs during train_hybrid's CLI process: "
                   "the train_ssm_cut line",
            "launches": {k: run["counts"][k] + replay["counts"][k]
                         for k in ("wkv6", "wkv6_bwd", "sha256", "merkle")}}


def micro_train_path(dev) -> dict:
    """``ModelTrainingWorkload(**MICRO_KWARGS)`` (pnpcoin-micro: 1 layer,
    hd 16, float32) mining ``MICRO_BLOCKS`` blocks on one node on the card,
    through the CUDA-core kernels' hd 16 training instance and backward (one
    launch of each a microstep), and on the CPU port: losses within
    ``MICRO_LOSS_TOL``."""
    import torch
    from repro_torch.chain import Node
    from repro_torch.chain.workloads import ModelTrainingWorkload
    from repro_torch.chain.workloads.model_train import MICRO_KWARGS

    def chain(device):
        wl = ModelTrainingWorkload(device=device, **MICRO_KWARGS)
        node = Node(node_id=0, classic_arg_bits=5, device=device,
                    workloads={"model_train": wl})
        t = time.perf_counter()
        losses = [node.mine_block("model_train").payload.loss
                  for _ in range(MICRO_BLOCKS)]
        return losses, time.perf_counter() - t
    _zero_counts()
    card, card_s = chain(dev)
    torch.cuda.synchronize()
    counts = _counts()
    want = MICRO_BLOCKS * MICRO_KWARGS["block_microsteps"]
    check(counts["flash_attention"] == counts["flash_attention_training"]
          == counts["flash_attention_bwd"] == want
          and counts["flash_attention_tc"] == 0,
          f"micro_train: {want} hd 16 training-instance forward and backward "
          f"launches, got {counts}")
    host, host_s = chain("cpu")
    err = max(abs(x - y) / abs(y) for x, y in zip(card, host))
    check(err <= MICRO_LOSS_TOL, f"micro_train: card losses {card} within "
          f"{MICRO_LOSS_TOL} of the CPU port's {host}")
    return {"phase": "workloads", "part": "micro_train",
            "config": "pnpcoin-micro (1 layer, d_model 32, 2 heads over 1, "
                      "hd 16, float32), MICRO_KWARGS",
            "card_losses": card, "cpu_losses": host, "rel_err": err,
            "card_s": card_s, "cpu_s": host_s, "counts": counts,
            "launches": {k: counts[k] for k in (
                "flash_attention", "flash_attention_bwd", "sha256",
                "merkle")}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.chain import Network, Node
    from repro_torch.core.jash import Jash, JashMeta, collatz_jash
    from repro_torch.core.ledger import merkle_root
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     flash_attention_mma_bwd,
                                     flash_attention_tc_bwd, native, ref,
                                     sha256)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20260)

    def words(*shape):
        return torch.randint(0, 2**32, shape, generator=gen, device=dev,
                             dtype=torch.int64)

    # -- 1. environment and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib, log = native.build()
    native.library()
    build_s = time.perf_counter() - t0
    # every wrapper launches on native.stream_of's raw handle, read through
    # a private accessor of torch's: it must name the current stream
    probe = torch.zeros(1, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        check(native.stream_of(probe) == side.cuda_stream,
              "native.stream_of names a side stream")
    check(native.stream_of(probe) == torch.cuda.current_stream().cuda_stream,
          "native.stream_of names the current stream")
    ptxas = ptxas_usage(log)
    for name, lines in ptxas["kernels"].items():
        if name.startswith(("flash_fwd_kernel<f32", "flash_bwd_",
                            "flash_tc_bwd_")):
            check(all(" 0 bytes spill stores" in ln for ln in lines
                      if "spill" in ln), f"{name}: ptxas reports no spills")
    emit({"phase": "environment", "gpu": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "ptxas": ptxas, "sass": sass_counts(lib),
          "flash_tc_resources": flash_tc_resources(),
          "flash_bwd_resources": flash_bwd_resources(ptxas),
          "flash_tc_bwd_resources": flash_tc_bwd_resources(ptxas),
          "flash_mma_bwd_resources": flash_mma_bwd_resources(ptxas),
          "wkv6_bwd_resources": {
              "ptxas": {name: lines for name, lines in
                        ptxas["kernels"].items()
                        if name.startswith(("wkv6_bwd", "wkv6_du",
                                            "decay_scan_bwd"))}},
          "counted_ops": {"compression": OPS_COMPRESSION,
                          "merkle_parent": OPS_COMPRESSION
                          + OPS_PAD_COMPRESSION}})

    # -- 2. kernels vs plain versions ----------------------------------------
    sha_rows, max_err = [], {"sha256": 0, "merkle": 0}
    # (N, W, raw, bswap): both digests at 2**22 rows, then each kernel
    # instantiation with one output at the shapes the main path gives it
    # (Classic: raw at W = 2 and W = 8; the audit's leaf digests: bswap).
    sha_cases = [(1 << 22, w, True, True) for w in (1, 2, 9, 13, 16, 20)]
    sha_cases += [(1 << 20, 2, True, False), (1 << 20, 8, True, False),
                  (1 << 20, 2, False, True)]
    for n, w, want_r, want_b in sha_cases:
        msg = words(n, w)
        got = sha256.sha256_rows_cuda(msg, raw=want_r, bswap=want_b)
        check((got[0] is not None) == want_r and (got[1] is not None)
              == want_b, f"sha256 outputs asked for at W={w}")
        for out, swap in zip(got, (False, True)):
            if out is None:
                continue
            what = f"sha256 raw={want_r} bswap={want_b} W={w}, " + \
                ("bswap" if swap else "raw") + " digest"
            src = ref.bswap32(msg) if swap else msg
            err = int((out - ref.sha256_words_ref(src)).abs().max())
            max_err["sha256"] = max(max_err["sha256"], err)
            check(err == 0, what + " vs plain")
            check(np.array_equal(
                out[:1000].cpu().numpy(),
                ref.sha256_words_hashlib(src[:1000].cpu().numpy())),
                what + " vs hashlib")
        sha_rows.append({"n": n, "w": w, "raw": want_r, "bswap": want_b,
                         "equal": True})
        del msg, got, out, src
    sha_edge = sha_vs_hashlib(dev)
    emit({"phase": "sha256_vs_hashlib", **sha_edge})

    merkle_cases = merkle_vs_plain(dev)
    emit({"phase": "merkle_vs_plain", **merkle_cases})
    flash = flash_vs_plain(dev)
    emit({"phase": "flash_vs_plain", **flash})
    flash_win = flash_window_vs_plain(dev)
    emit({"phase": "flash_window_vs_plain", **flash_win})
    decay = decay_vs_plain(dev)
    emit({"phase": "decay_scan_vs_plain", **decay})
    wkv = wkv_vs_plain(dev)
    emit({"phase": "wkv6_vs_plain", **wkv})
    bwd = flash_bwd_vs_plain(dev)
    emit({"phase": "flash_bwd_vs_plain", **bwd})
    tc_bwd = flash_tc_bwd_vs_plain(dev)
    emit({"phase": "flash_tc_bwd_vs_plain", **tc_bwd})
    decay_bwd = decay_bwd_vs_plain(dev)
    emit({"phase": "decay_scan_bwd_vs_plain", **decay_bwd})
    wkv_bwd = wkv_bwd_vs_plain(dev)
    emit({"phase": "wkv6_bwd_vs_plain", **wkv_bwd})
    flash_err = {**flash["max_abs_err"]}
    for key, err in flash_win["max_abs_err"].items():
        flash_err[key] = max(flash_err.get(key, 0.0), err)
    max_err["flash_attention"] = max(
        err for key, err in flash_err.items() if key.startswith("cuda_core"))
    max_err["flash_attention_tc"] = max(
        err for key, err in flash_err.items() if key.startswith("tensor_core"))
    max_err["merkle"] = merkle_cases["max_abs_err"]
    max_err["decay_scan"] = decay["max_abs_err"]
    max_err["wkv6"] = wkv["max_abs_err"]
    max_err["flash_attention_bwd"] = bwd["max_abs_err"]
    max_err["flash_attention_tc_bwd"] = tc_bwd["max_abs_err"]
    max_err["flash_attention_tc_train_hd256"] = \
        tc_bwd["by_head_dim"][256]["lse"]
    max_err["flash_attention_mma_bwd"] = tc_bwd["by_head_dim"][256]["abs"]
    max_err["decay_scan_bwd"] = decay_bwd["max_abs_err"]
    max_err["wkv6_bwd"] = wkv_bwd["max_abs_err"]
    emit({"phase": "kernels_vs_plain", "sha256": sha_rows,
          "merkle": {"cases": merkle_cases["cases"], "equal": True},
          "flash_attention": {"cases": flash["cases"] + flash_win["cases"],
                              "within_tolerance": True,
                              "tolerance": FLASH_TOL,
                              "max_abs_err_by_kernel": flash_err},
          "decay_scan": {"cases": decay["cases"], "within_tolerance": True,
                         "tolerance": DECAY_TOL},
          "wkv6": {"cases": wkv["cases"], "within_tolerance": True,
                   "tolerance": WKV_TOL},
          "flash_attention_bwd": {"cases": bwd["cases"],
                                  "within_tolerance": True,
                                  "tolerance": bwd["tolerance"]},
          "flash_attention_tc_bwd": {"cases": tc_bwd["cases"],
                                     "within_tolerance": True,
                                     "tolerance": tc_bwd["tolerance"]},
          "decay_scan_bwd": {"cases": decay_bwd["cases"],
                             "within_tolerance": True,
                             "tolerance": decay_bwd["tolerance"]},
          "wkv6_bwd": {"cases": wkv_bwd["cases"], "within_tolerance": True,
                       "tolerance": wkv_bwd["tolerance"]},
          "max_abs_err": max_err})

    # timing at the main path's shapes
    def sha_case(n, w, raw, bswap):
        msg = words(n, w)
        nb = (w * 32 + 1 + 64 + 511) // 512
        outs = int(raw) + int(bswap)

        def call():
            sha256.sha256_rows_cuda(msg, raw=raw, bswap=bswap)
        ms, dev_ms = cuda_ms(call), graph_ms(call)

        def plain():
            if raw:
                ref.sha256_words_ref(msg)
            if bswap:
                ref.sha256_words_ref(ref.bswap32(msg))
        plain_ms = cuda_ms(plain, reps=3, rounds=1)
        # int64 words in, int64 digest words out, as the kernel takes them
        b, by, arith = hash_bound_ms(WORD_BYTES * n * (w + 8 * outs),
                                     n * nb * outs, swaps=bswap * n * w)
        return {"shape": f"N={n} W={w} raw={raw} bswap={bswap}", "ms": ms,
                "device_ms_from_graph": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b, "bound_by": by, "bound_arithmetic": arith,
                "share_of_bound_from_graph": b / dev_ms,
                "msgs_per_s": n / (dev_ms * 1e-3)}

    sha_times = [sha_case(1 << 16, 2, True, True),     # full-mode chunk
                 sha_case(1 << 20, 2, True, False),    # classic, hash 1
                 sha_case(1 << 20, 8, True, False)]    # classic, hash 2
    merkle_time = merkle_times(dev)
    flash_time = flash_times(dev)
    emit({"phase": "flash_times", "gpu": smi, **flash_time})
    flash_new = flash_serving_shape_times(dev)
    emit({"phase": "flash_times_serving_shapes", "gpu": smi, **flash_new})
    core_f32 = flash_core_f32_times(dev)
    emit({"phase": "flash_cuda_core_float32_times", "gpu": smi, **core_f32})
    rec_times = recurrent_times(dev)
    emit({"phase": "recurrent_times", "gpu": smi, **rec_times})
    bwd_time = flash_bwd_times(dev)
    emit({"phase": "flash_bwd_times", "gpu": smi, **bwd_time})
    tc_bwd_time = flash_tc_bwd_times(dev)
    emit({"phase": "flash_tc_bwd_times", "gpu": smi, **tc_bwd_time})
    rec_bwd_time = recurrent_bwd_times(dev)
    emit({"phase": "recurrent_bwd_times", "gpu": smi, **rec_bwd_time})
    hd256_time = flash_hd256_train_times(dev)
    emit({"phase": "flash_hd256_train_times", "gpu": smi, **hd256_time})
    emit({"phase": "kernel_times", "gpu": smi, "sha256": sha_times,
          "merkle": merkle_time, "flash_attention": flash_time,
          "flash_attention_serving_shapes": flash_new,
          "flash_cuda_core_float32": core_f32,
          "flash_attention_bwd": bwd_time,
          "flash_attention_tc_bwd": tc_bwd_time,
          "flash_attention_hd256_training": hd256_time, **rec_times,
          **rec_bwd_time})
    torch.cuda.empty_cache()

    # -- 3. the main path at full size -------------------------------------
    _zero_counts()
    node = Node(device="cuda", classic_arg_bits=MAIN_BITS)
    # host-clock split of each block into the workload's three steps
    split = {name: [] for name in node.workloads}
    for name, wl in node.workloads.items():
        _timed_steps(wl, split[name])
    base = collatz_jash(max_steps=512)
    job = Jash(base.name, base.fn,
               JashMeta(arg_bits=MAIN_BITS, res_bits=32, importance=0.8,
                        description="Collatz stopping times"),
               example_args=base.example_args)
    t = time.perf_counter()
    review = node.submit(job)
    review_s = time.perf_counter() - t
    emit({"phase": "review", "jash_id": review.jash_id, "review_s": review_s,
          "runtime_mean_s": review.runtime_mean_s,
          "flops_estimate": review.flops_estimate})
    receipts = [node.mine_block()]
    node.submit(job)
    receipts.append(node.mine_block("optimal"))
    receipts.append(node.mine_block())
    for r in receipts:
        rec = r.record
        emit({"phase": "block", "workload": rec.workload,
              "height": rec.height, "n_results": rec.n_results,
              "root": rec.merkle_root, "winner": rec.winner,
              "block_time_s": r.block_time_s,
              **{f"{step}_s": sec for step, sec in split[rec.workload]}})
    t = time.perf_counter()
    audited = node.audit_chain()
    audit_s = time.perf_counter() - t
    torch.cuda.synchronize()
    counts = _counts()

    full, opt, classic = (r.payload for r in receipts)
    check([r.record.workload for r in receipts]
          == ["full", "optimal", "classic"], "block workloads")
    check(full.n_results == opt.n_results == classic.n_results == 1 << 20,
          "blocks cover 2**20 args")
    check(audited and node.state().chain_valid, "node audits its chain")
    f = full.full
    check(f.results.shape == (1 << 20, 1) and f.results.dtype == np.uint32,
          "full results shape")

    def collatz_u32(a, steps=512):
        b, n = max(a, 1), 0
        while b != 1 and n < steps:
            b = b // 2 if b % 2 == 0 else (3 * b + 1) & 0xFFFFFFFF
            n += 1
        return n if b == 1 else steps

    probe = list(range(1024)) + [159487, 212649, 239231, 270271, 288615]
    check(all(int(f.results[a, 0]) == collatz_u32(a) for a in probe),
          "collatz results vs Python, including args that wrap past 2**32")
    idx = np.random.RandomState(0).choice(1 << 20, 1000, replace=False)
    leaves_b = [f.merkle_leaves[i] for i in idx]
    check(all(f.leaf_digests[i].astype(">u4").tobytes()
              == hashlib.sha256(lf).digest() for i, lf in zip(idx, leaves_b)),
          "leaf digests vs hashlib")
    check(all(f.hashes[i].astype(">u4").tobytes()
              == hashlib.sha256(f.packed_words()[i].astype(">u4").tobytes())
              .digest() for i in idx), "submission hashes vs hashlib")
    check(full.merkle_root == merkle_root(list(f.merkle_leaves),
                                          backend="hashlib"),
          "full-block root vs hashlib")
    first = int(np.argmin(f.results[:, 0]))
    check(opt.best_arg == first
          and opt.best_res == f.results[first].tobytes().hex(),
          "optimal block = argmin of results")
    nonce_msg = int(classic.best_arg).to_bytes(4, "big") + b"PNPC"
    double = hashlib.sha256(hashlib.sha256(nonce_msg).digest()).digest()
    check(bytes.fromhex(classic.best_res) == np.frombuffer(
        double, ">u4").astype("<u4").tobytes(), "classic best_res vs hashlib")
    emit({"phase": "main_path", "audit_chain_s": audit_s,
          "counts": counts, "checks": "passed"})
    emit({"phase": "merkle_host", "gpu": smi, **merkle_host_times(f)})

    # -- 4. network ----------------------------------------------------------
    net = Network.create(2, classic_arg_bits=16, device="cuda")
    small = Jash(base.name, base.fn,
                 JashMeta(arg_bits=16, res_bits=32, importance=0.8),
                 example_args=base.example_args)
    t = time.perf_counter()
    for i, wl in enumerate(["full", "optimal", None, None]):
        if wl is not None:
            net.nodes[i % 2].submit(small)
        res = net.mine(origin=i % 2, workload=wl)
        check(not res.rejected_by, f"peers rejected block {i}")
    books = {tuple(sorted(n.book.balances.items())) for n in net.nodes}
    check(net.converged() and len(books) == 1, "network converged")
    emit({"phase": "network", "nodes": 2, "blocks": 4,
          "height": net.heights, "tip": net.tips[0],
          "seconds": time.perf_counter() - t})

    # -- 5. workload families, the journal, the quickstart and training -----
    # each part zeroes the counts just before it and reads them just after
    paths = {}
    # the recurrent parts' cuts: card halves beside the qwen3 CLI, CPU
    # halves beside the recurrentgemma CLI
    cuts, host_work = {}, []
    reviews, restore_reviews = _review_each_step_once()
    for name, run in (("train_cli", lambda: train_cli_path(
                          dev, [lambda: cuts.update(
                              recurrent_cuts_on_card(dev))])),
                      ("train_ssm", lambda: train_ssm_path(
                          dev, cuts["train_ssm"], host_work)),
                      ("train_hybrid", lambda: train_hybrid_path(
                          dev, cuts["train_hybrid"], host_work)),
                      ("micro_train", lambda: micro_train_path(dev)),
                      ("sat", lambda: sat_path(dev)),
                      ("docking", lambda: docking_path(dev)),
                      ("journal", lambda: journal_path(dev, job)),
                      ("quickstart", quickstart_path),
                      ("model_train", lambda: model_train_path(dev)),
                      ("pouw_full", lambda: pouw_full_path(dev)),
                      ("pouw_es", lambda: pouw_es_path(dev)),
                      ("gan", lambda: gan_path(dev))):
        t = time.perf_counter()
        try:
            paths[name] = run()
        except BaseException:
            restore_reviews()
            raise
        emit({**paths[name], "seconds": time.perf_counter() - t, "gpu": smi})
    restore_reviews()
    emit({"phase": "workloads", "part": "step_reviews", **reviews})

    # -- 6. serving at full width: qwen3-0.6b, rwkv6-7b, recurrentgemma-2b --
    # bf16 attention at hd 128 and 256 takes the tensor-core kernel; the
    # reduced float32 models (2 layers, 5 for recurrentgemma, hd 32, prompt
    # 100, 8 new tokens) take the CUDA-core one
    served = {
        "qwen3-0.6b": serve_path(dev, "qwen3-0.6b", SERVE_PROMPT,
                                 {"flash_attention_tc": 28}, {},
                                 {"flash_attention": 2}),
        # WKV-6 in every layer, in prefill and at every decode step
        "rwkv6-7b": serve_path(dev, "rwkv6-7b", RWKV_PROMPT, {"wkv6": 32},
                               {"wkv6": 32}, {"wkv6": 2 + 7 * 2}),
        # 18 RG-LRU layers scan in prefill (decode steps them plainly) and
        # 8 local-attention layers; 5 reduced layers keep the rest layers
        "recurrentgemma-2b": serve_path(
            dev, "recurrentgemma-2b", RG_PROMPT,
            {"decay_scan": 18, "flash_attention_tc": 8}, {},
            {"decay_scan": 4, "flash_attention": 1}, small_layers=5),
    }
    for res in served.values():
        emit(res)
    # the dense configs (hd 128, 64 and 80), then a layer of attention
    # and one of MoE each (olmoe), whisper's encoder, decoder and
    # cross-attention (24 each in prefill; the cross-attention at every
    # decode step too), llama-vision's 32 self- and 8 cross-attention layers
    # (the cross ones at every decode step); the reduced whisper has 2
    # encoder and 2 decoder layers, the reduced llama-vision 2 groups of
    # 4 + 1
    for arch, prompt, per_prefill, per_decode, small, sites in (
            ("qwen3-8b", SERVE_PROMPT, 36, 0, 2, 1),
            ("stablelm-1.6b", SERVE_PROMPT, 24, 0, 2, 1),
            ("stablelm-3b", SERVE_PROMPT, 32, 0, 2, 1),
            ("olmoe-1b-7b", SERVE_PROMPT, 16, 0, 2, 1),
            ("llama-3.2-vision-11b", SERVE_PROMPT, 40, 8, 10 + 7 * 2, 3),
            ("whisper-medium", WHISPER_PROMPT, 72, 24, 6 + 7 * 2, 4)):
        served[arch] = serve_path(
            dev, arch, prompt, {"flash_attention_tc": per_prefill},
            {"flash_attention_tc": per_decode} if per_decode else {},
            {"flash_attention": small}, flash_sites=sites)
        emit(served[arch])
    # arctic-480b: ~960 GB of bf16 weights; its reduced model only
    arctic = {"phase": "serve", "arch": "arctic-480b", "full_width": False,
              **reduced_vs_cpu(dev, "arctic-480b", {"flash_attention": 2})}
    emit(arctic)
    emit(sha_kernels_a_call(dev))
    emit(train_kernels_a_step(dev))

    # -- 7. launch counts and the kernel table -------------------------------
    # the path's launches do not depend on the kernels' speed: 21 SHA-256
    # calls, and two Merkle reductions (the commit and the verify), one
    # launch each
    _check_counts(counts, 21, 2, "the mining path")
    chunk = sha_times[0]
    qwen, rg = served["qwen3-0.6b"]["counts"], \
        served["recurrentgemma-2b"]["counts"]
    tc_by_path = {arch: res["counts"]["flash_attention_tc"]
                  for arch, res in served.items()
                  if res["counts"]["flash_attention_tc"]}
    small_flash = {arch: res["reduced_counts"].get("flash_attention", 0)
                   for arch, res in {**served, "arctic-480b": arctic}.items()}
    check(len(tc_by_path) == 8
          and all(small_flash[a] > 0 for a in ("qwen3-0.6b",
                                                "recurrentgemma-2b")),
          "each flash kernel launched on its serving paths")
    flash_rg = rec_times["flash_attention_rg"]

    def at(times, kernel):
        """One flash kernel's readings in a bf16 timing of both."""
        ms_key = "ms" if kernel == "tensor_core" else "cuda_core_ms"
        return {"shape": times["shape"], "ms": times[ms_key],
                **{k: times[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
                "tflops_per_s": times["tflops_per_s"][kernel]}

    def row(name, err, source, replaces, launches, times, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": launches, "max_abs_err": max_err[err],
                **{k: times[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                "shape": times["shape"], "matched": True, **extra}
    train = paths["model_train"]
    training_paths = ("model_train", "pouw_full", "pouw_es", "micro_train")
    for name in training_paths:
        check(paths[name]["launches"]["flash_attention"] > 0,
              f"the flash forward launched on the {name} path")
    for name in ("model_train", "pouw_full", "micro_train"):
        check(paths[name]["launches"]["flash_attention_bwd"] > 0,
              f"the flash backward launched on the {name} path")
    bwd_by_path = {name: paths[name]["launches"]["flash_attention_bwd"]
                   for name in training_paths}
    fwd_by_path = {name: paths[name]["launches"]["flash_attention"]
                   for name in training_paths}
    bwd_row = row("flash_attention_bwd", "flash_attention_bwd",
                  "flash_attention_bwd.cu", "", sum(bwd_by_path.values()),
                  bwd_time["qwen3-0.6b"],
                  pnpcoin_demo_shape=bwd_time["pnpcoin-demo"],
                  pouw_shape=bwd_time["pnpcoin-demo PoUW"],
                  micro_shape=bwd_time["pnpcoin-micro"],
                  launches_by_path=bwd_by_path,
                  device_ms_from_graph=bwd_time["qwen3-0.6b"][
                      "device_ms_from_graph"],
                  tile={f"hd={hd}": flash_attention_bwd.tile(hd)
                        for hd in flash_attention_bwd.HEAD_DIMS},
                  path="training pnpcoin-demo (model_train, and "
                       "PoUWTrainer's full mode) and pnpcoin-micro at hd 16 "
                       "(micro_train); one launch a layer and microstep, "
                       "three kernels each; times at qwen3-0.6b's shape in "
                       "float32",
                  replaces_note="no TPU kernel: the reference "
                                "differentiates chunked_attention "
                                "(jax.grad)")
    bwd_row["replaces"] = "src/repro/models/attention.py:79"
    cli = paths["train_cli"]
    check(cli["launches"]["flash_attention_tc"] > 0
          and cli["launches"]["flash_attention_tc_bwd"] > 0,
          "the tensor-core training instance and the bf16 backward launched "
          "on the train_cli path")
    tc_train = tc_bwd_time["qwen3-0.6b train_cli"]
    tc_bwd_row = row(
        "flash_attention_tc_bwd", "flash_attention_tc_bwd",
        "flash_attention_tc_bwd.cu", "", cli["launches"][
            "flash_attention_tc_bwd"], tc_train,
        prefill_shape=tc_bwd_time["qwen3-0.6b prefill"],
        train_4k_shape=tc_bwd_time["qwen3-0.6b train_4k"],
        device_ms_from_graph=tc_train["device_ms_from_graph"],
        tile={f"hd={hd}": flash_attention_tc_bwd.tile(hd)
              for hd in flash_attention_tc_bwd.HEAD_DIMS},
        launches_by_path={"train_cli": cli["launches"][
            "flash_attention_tc_bwd"]},
        path="training qwen3-0.6b in bf16 through the train CLI (one "
             "launch a layer and step, two kernels each; the audit "
             "replay of the CLI's run); times at the CLI's call",
        replaces_note="no TPU kernel: the reference differentiates "
                      "chunked_attention (jax.grad)")
    tc_bwd_row["replaces"] = "src/repro/models/attention.py:79"
    hybrid, ssm = paths["train_hybrid"], paths["train_ssm"]
    for name, kernels in (("train_hybrid", ("decay_scan", "decay_scan_bwd",
                                            "flash_attention_tc",
                                            "flash_attention_mma_bwd")),
                          ("train_ssm", ("wkv6", "wkv6_bwd"))):
        check(all(paths[name]["launches"][k] > 0 for k in kernels),
              f"{kernels} launched on the {name} path")
    rg_train = hd256_time["recurrentgemma-2b train"]
    c_row = row("flash_attention_tc_train_hd256",
                "flash_attention_tc_train_hd256", "flash_attention_tc.cu",
                "flash_attention.py:28",
                hybrid["counts"]["flash_attention_tc_training"],
                rg_train["forward"],
                device_ms_from_graph=rg_train["forward"][
                    "device_ms_from_graph"],
                s4096_shape=hd256_time["recurrentgemma-2b S=T=4096"][
                    "forward"],
                launches_by_path={"train_hybrid": hybrid["counts"][
                    "flash_attention_tc_training"]},
                path="training recurrentgemma-2b (train_hybrid): the "
                     "tensor-core forward's training instance at hd 256 "
                     "(saves the row log-sum-exp; output bit-equal to the "
                     "serving instance), twice an attention layer and step "
                     "with remat; max_abs_err is its log-sum-exp's")
    d_row = row("flash_attention_mma_bwd", "flash_attention_mma_bwd",
                "flash_attention_mma_bwd.cu", "", hybrid["launches"][
                    "flash_attention_mma_bwd"], rg_train["backward"],
                device_ms_from_graph=rg_train["backward"][
                    "device_ms_from_graph"],
                s4096_shape=hd256_time["recurrentgemma-2b S=T=4096"][
                    "backward"],
                tile=flash_attention_mma_bwd.tile(),
                launches_by_path={"train_hybrid": hybrid["launches"][
                    "flash_attention_mma_bwd"]},
                path="training recurrentgemma-2b (train_hybrid): one call a "
                     "local-attention layer and step, three kernels each",
                replaces_note="no TPU kernel: the reference differentiates "
                              "chunked_attention (jax.grad)")
    d_row["replaces"] = "src/repro/models/attention.py:79"
    a_row = row("decay_scan_bwd", "decay_scan_bwd", "decay_scan_bwd.cu", "",
                hybrid["launches"]["decay_scan_bwd"],
                rec_bwd_time["decay_scan_bwd"],
                device_ms_from_graph=rec_bwd_time["decay_scan_bwd"][
                    "device_ms_from_graph"],
                launches_by_path={"train_hybrid": hybrid["launches"][
                    "decay_scan_bwd"]},
                path="training recurrentgemma-2b (train_hybrid): one launch "
                     "a RG-LRU layer and step",
                replaces_note="no TPU kernel: the reference differentiates "
                              "the associative_scan of rg_lru_scan "
                              "(jax.grad), the function of "
                              "src/repro/kernels/decay_scan.py:21")
    a_row["replaces"] = "src/repro/models/rglru.py:77"
    b_row = row("wkv6_bwd", "wkv6_bwd", "wkv6_bwd.cu", "",
                ssm["launches"]["wkv6_bwd"], rec_bwd_time["wkv6_bwd"],
                device_ms_from_graph=rec_bwd_time["wkv6_bwd"][
                    "device_ms_from_graph"],
                launches_by_path={"train_ssm": ssm["launches"]["wkv6_bwd"]},
                path="training rwkv6-7b (train_ssm): one call a layer and "
                     "step, two kernels each (the backward, du's sum over "
                     "the batch)",
                replaces_note="no TPU kernel: the reference differentiates "
                              "the lax.scan of wkv_ref (jax.grad), the "
                              "function of src/repro/kernels/wkv6.py:22")
    b_row["replaces"] = "src/repro/models/rwkv6.py:59"
    emit({"kernels": [
        row("sha256_rows", "sha256", "sha256.cu", "sha256.py:34",
            counts["sha256"], {**chunk, "library_ms": None}, path="mining",
            device_ms_from_graph=chunk["device_ms_from_graph"],
            classic_shapes=sha_times[1:],
            launches_by_path={"mining": counts["sha256"], **{
                name: res["launches"]["sha256"]
                for name, res in paths.items()}}),
        row("merkle_reduce", "merkle", "merkle.cu", "merkle.py:132",
            counts["merkle"], {**merkle_time, "library_ms": None},
            path="mining", unit="ms per reduction; launches are reductions "
                                "(two a mining path, 14 levels each)",
            device_ms_from_graph=merkle_time["device_ms_from_graph"],
            launches_by_path={"mining": counts["merkle"], **{
                name: res["launches"]["merkle"]
                for name, res in paths.items()}}),
        row("flash_attention_tc", "flash_attention_tc",
            "flash_attention_tc.cu", "flash_attention.py:28",
            sum(tc_by_path.values()) + cli["launches"]["flash_attention_tc"]
            + hybrid["launches"]["flash_attention_tc"],
            at(flash_time, "tensor_core"),
            recurrentgemma_shape=at(flash_rg, "tensor_core"),
            hd80_shape=at(flash_new["stablelm-3b prefill"], "tensor_core"),
            whisper_encoder_shape=at(flash_new["whisper-medium encoder"],
                                     "tensor_core"),
            whisper_cross_shape=at(flash_new["whisper-medium cross prefill"],
                                   "tensor_core"),
            training_instance={
                key: {"ms": t["forward_training_instance_ms"],
                      "ms_from_graph":
                          t["forward_training_instance_ms_from_graph"],
                      "serving_instance_ms": t["forward_serving_instance_ms"],
                      "library_ms": t["forward_library_ms"],
                      "bound_ms": t["forward_bound_ms"],
                      "bound_by": t["forward_bound_by"]}
                for key, t in tc_bwd_time.items()},
            path="serving the bf16 models at full width: qwen3-0.6b (28), "
                 "recurrentgemma-2b (8), qwen3-8b (36), stablelm-1.6b (24), "
                 "stablelm-3b (32, hd 80), olmoe-1b-7b (16), "
                 "llama-3.2-vision-11b (40, then 8 a decode step) and "
                 "whisper-medium (72, then 24 a decode step) in prefill; "
                 "training qwen3-0.6b through the train CLI (its training "
                 "instance, 56 a step with remat; ES candidates the serving "
                 "one)",
            launches_by_path={
                **tc_by_path,
                "train_cli": cli["launches"]["flash_attention_tc"],
                "train_hybrid": hybrid["launches"]["flash_attention_tc"]}),
        row("flash_attention_fwd", "flash_attention", "flash_attention.cu",
            "flash_attention.py:28", sum(small_flash.values())
            + sum(fwd_by_path.values()),
            core_f32["qwen3-0.6b"],
            training_instance={
                key: {"ms": t["forward_training_instance_ms"],
                      "serving_instance_ms": t["forward_serving_instance_ms"],
                      "library_ms": t["forward_library_ms"],
                      "bound_ms": t["forward_bound_ms"],
                      "bound_by": t["forward_bound_by"]}
                for key, t in bwd_time.items()},
            pnpcoin_demo_shape=core_f32["pnpcoin-demo"],
            tile={f"hd={hd}": flash_attention.tile(hd)
                  for hd in flash_attention.HEAD_DIMS},
            bf16_inputs_not_on_path={
                "qwen3-0.6b": at(flash_time, "cuda_core"),
                "recurrentgemma-2b": at(flash_rg, "cuda_core")},
            path="float32 (and hd 32): the reduced float32 models served "
                 "(qwen3-0.6b, recurrentgemma-2b and the 8 others), "
                 "pnpcoin-demo trained "
                 "(its training instance, which saves the row "
                 "log-sum-exp: model_train, pouw_full) and its ES "
                 "candidates scored (the serving instance: pouw_es); "
                 "times in float32 against SDPA in float32",
            launches_by_path={**small_flash, **fwd_by_path},
            training_instance_launches_by_path={
                name: paths[name]["counts_chain"]["flash_attention_training"]
                for name in ("pouw_full", "pouw_es")}),
        bwd_row,
        tc_bwd_row,
        row("decay_scan", "decay_scan", "decay_scan.cu", "decay_scan.py:21",
            rg["decay_scan"] + hybrid["launches"]["decay_scan"],
            rec_times["decay_scan"],
            path="serving recurrentgemma-2b; training it (train_hybrid: "
                 "twice a RG-LRU layer and step with remat)",
            launches_by_path={"serve recurrentgemma-2b": rg["decay_scan"],
                              "train_hybrid": hybrid["launches"][
                                  "decay_scan"]}),
        row("wkv6", "wkv6", "wkv6.cu", "wkv6.py:22",
            served["rwkv6-7b"]["counts"]["wkv6"] + ssm["launches"]["wkv6"],
            rec_times["wkv6"],
            path="serving rwkv6-7b; training it (train_ssm: twice a layer "
                 "and step with remat)",
            launches_by_path={"serve rwkv6-7b": served["rwkv6-7b"]["counts"][
                "wkv6"], "train_ssm": ssm["launches"]["wkv6"]}),
        c_row, d_row, a_row, b_row,
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
