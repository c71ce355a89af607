#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc`` (``nvcc``, ``sm_90a``), then prints one JSON line per phase:

1. ``env``     — the card (``nvidia-smi`` name and power limit), torch,
   CUDA, nvcc and triton versions, the kernels' build time, ``ptxas``'s
   registers and spills, and (where the toolkit has ``cuobjdump``) the
   ``HMMA``/``HGMMA`` instructions in each kernel's SASS: every
   tensor-core body must hold some; ``split_bodies`` lists each
   instantiation of the split-context decode body (registers, spills,
   SASS instructions, ``HMMA`` of its tensor-core form), and
   ``rmsnorm_ssm_ptxas`` the registers and spills of each RMSNorm (warps a
   row) and selective-scan (lanes a channel) instantiation;
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card, in bf16 and f32, at the main path's shapes (stablelm-1.6b:
   H = K = 32, hd = 64, page 16) and at internlm2-20b's GQA widths
   (H = 48, K = 8, hd = 128), with unreferenced pages and the tails past
   each length poisoned with finite values; the attention kernels also
   with those regions set to NaN, which must not change their output.
   The slot path's kernels (flash attention, slot decode attention) are
   held the same way at stablelm-1.6b's, internlm2-20b's and
   Jamba-1.5-Large's widths (H = 64, K = 8, hd = 128) and, for flash,
   MLA's head dims (192 / 128), causal and not; RMSNorm at d = 2048 and
   at Jamba's d = 8192.  The int8
   forms of both paged kernels are held against their plain versions at
   those widths with f32 and bf16 queries, with +-99 payloads in every
   unreferenced slot, whose scales set to NaN, Inf or 1e30 must leave the
   output unchanged to the bit.  Both decode kernels (int8 pages too) also
   at lengths 0, 1, ps, ps + 1 and the capacity in one batch: zeros at
   length 0 with NaN past every length (int8: NaN, Inf or 1e30 scales),
   every call through the split-context body (``split_launches``); then
   paged decode (fp and int8 pages, f32 and bf16) again with the pools'
   rows moved off 16 bytes, every call through the one-block-a-row body,
   and MLA's 192 / 128 through the other slot body.
   Times (CUDA events, median) of the kernel, its plain version and one
   PyTorch library call for the same function (a yardstick the port
   never calls), beside the least time the card could take, and the
   device time of one call of the kernel and of the library call
   (``device_ms``, ``library_device_ms``: ``torch.profiler`` over 20
   calls).  The decode kernels' rows add ``cold_device_ms`` and
   ``library_cold_device_ms``: the same calls rotating over enough copies
   of their inputs that each finds its K/V out of the L2 cache, as a decode
   step does; no cold reading may beat the bytes bound; and
   ``other_body_host_ms``, the wrapper's host time when the one-block-a-row
   body serves the same call (K/V rows moved off 16 bytes).  Flash and paged
   prefill (fp and int8 pages) are also timed at Jamba-1.5-Large's and
   internlm2-20b's widths (``timing_bf16_wide``), and every bf16 call of
   theirs timed must take the tensor-core body; so are paged decode (fp and
   int8 pages) at internlm2-20b's and slot decode at Jamba-1.5-Large's, and
   every decode call timed must take the split-context body;
3. ``held``    — stablelm-1.6b at full width cut to 2 layers, float32:
   the same weights and requests through the paged engine on the card
   and on the CPU must give the same greedy tokens, with fp pages and
   with int8 pages;
4. ``held_slot`` — the same check through the slot engine ``LLMEngine``,
   with a float and with an int8 slot cache;
5. ``engine``  — the full stablelm-1.6b in bf16 through
   ``PagedLLMEngine.admit``/``step``: 8 requests of 96-768 prompt
   tokens and 32 new tokens each, once with the default pool and once
   with the prefix cache on a pool small enough to force eviction,
   re-admission and copy-on-write, and then those requests again with
   int8 pages at the same pool bytes; every kernel launch is counted and
   must match the steps run exactly;
6. ``testbed`` — the paper's testbed: the full stablelm-1.6b in bf16
   behind the port's ``build_engines``, ``ServingCluster``, a fitted
   ``ProfileStore`` and ``build_scheduler``.  One seeded planning workload
   of 12 jobs, each LLM task prefilling a ~386-token prompt, runs under
   LLMSched and then FCFS on one slot replica (flash and slot decode
   kernels, exact launch accounting; every bf16 flash and paged prefill
   call of every serving run must take the tensor-core body, counted in
   ``tc_launches``, and every decode call the split-context body, counted
   in ``split_launches``), then under LLMSched on two paged
   replicas with a small and a large page pool, live migration and the
   prefix cache, once with bf16 pages and once with int8 pages at the
   same pool bytes;
7. ``held_hybrid`` — Jamba-1.5-Large at its published widths in float32,
   cut to its first 2 layers (mamba+moe, mamba+mlp) and 4 of its 16
   experts (~20 GB, so the host holds it too): the same weights and
   requests through ``LLMEngine`` on the card and on the CPU must give the
   same greedy tokens;
8. ``hybrid``  — Jamba-1.5-Large in bf16 at its published widths (d_model
   8192, 64/8 heads of 128, d_ff 24576, 16 experts top-2 of width 24576
   every other layer, Mamba d_state 16, d_conv 4, expand 2, dt_rank 512,
   vocab 65536), cut in depth only, to its first 5 layers (mamba+moe,
   mamba+mlp, mamba+moe, mamba+mlp, attn+moe: every layer kind of the
   period, 66.2 GB of weights; a whole 8-layer period needs ~90 GB), run
   after the earlier phases' models are freed.  Four requests of 128-512
   prompt tokens and 16 new tokens through ``LLMEngine.admit``/``step``
   with every launch counted and matched (the ``ssm_scan`` kernel once a
   Mamba layer per admission and decode step), a profiled decode window,
   then LLMSched over one hybrid slot replica (6 planning jobs);
9. ``held_mla`` — DeepSeek-V2-Lite at its published widths in float32,
   cut to its first 2 layers (``prefix_0``: MLA + the leading dense MLP of
   width 10944; ``blocks/0``: MLA + 64 experts top-6 and 2 shared; ~4.3 GB,
   so the host holds it too): the same weights and 3 requests through
   ``LLMEngine`` on the card and on the CPU must give the same greedy
   tokens; then ``layers.mla_decode`` (the slot decode kernel at 192 /
   128) against the engine's absorbed MLA decode on the card, to the
   float32 model tolerance.  This phase and ``held_hybrid`` print the
   smallest gap between a token's k-th and (k+1)-th router probability
   they saw (``min_router_gap``), by device;
10. ``mla``    — the whole DeepSeek-V2-Lite-16B (27 layers, bf16, 31.4 GB
   of weights drawn on the card from a seed) through
   ``LLMEngine.admit``/``step``: 4 requests of 128-512 prompt tokens and 32
   new tokens each, every launch matched (flash once a layer per
   admission, through its CUDA-core body at 192 / 128; RMSNorm twice a
   layer plus once per admission and step; no decode-attention launch: MLA
   decodes in the latent space), a profiled window of 4 decode steps with
   the host's launches, syncs and routed-MoE calls a step, then LLMSched
   over one DeepSeek slot replica (2 planning jobs, token scale 16);
11. ``dense``  — Llama-3-405B (2 of 126 layers), Qwen1.5-110B (2 of 80,
   QKV bias) and Kimi-K2 (1 of 61: 384 experts top-8 and the shared
   expert) at their published widths in bf16, one at a time, each through
   ``PagedLLMEngine`` with 4 requests of 96-384 prompt tokens and 16 new
   tokens, launches matched, every paged prefill call through the
   tensor-core body and every decode call through the split body;
12. ``held_xlstm`` — xLSTM-350M at its published widths in float32, cut
   to its first 8 layers (one superblock: 7 mLSTM and 1 sLSTM cells, the
   sLSTM's recurrence ``r_izfo`` seeded non-zero): the same weights and 3
   requests through ``LLMEngine`` on the card and on the CPU must give the
   same greedy tokens, with a freed slot re-used mid-stream;
13. ``xlstm``  — the whole xLSTM-350M (24 layers, bf16, 1.2 GB) through
   ``LLMEngine``: 4 requests of 64-256 prompt tokens and 32 new tokens,
   launches matched (RMSNorm once a layer plus the final norm per
   admission and step, no attention kernel), a profiled decode window,
   then LLMSched over one xLSTM slot replica (3 planning jobs at the
   testbed's token scale 4);
14. ``held_encdec`` — Whisper-tiny whole (4 encoder and 4 decoder layers,
   1500 frames) and Llama-3.2-Vision-90B at its published widths cut to
   its first 5 layers (one superblock, the cross layer last; ~26 GB,
   which the host holds too), float32, seeded random ``enc_input``:
   prefill and 8 greedy tokens for 2 prompts through ``prefill`` /
   ``decode_step`` on the card and on the CPU must give the same tokens;
15. ``encdec`` — Whisper-tiny whole (4 prompts of 16-64 tokens, 32 new
   tokens) and Vision cut to its first 10 layers (2 superblocks, cross
   layers at 4 and 9, 21.3 GB; 4 prompts of 128-512 tokens, 16 new
   tokens) in bf16 through ``prefill`` (one prompt at a time) and batched
   ``decode_step``s, the JAX package's entry points for these families
   (its engines take no encoder input): launches matched, every flash call
   on the tensor-core body, every decode call on the split body; the
   encoder's and the cross K/V's times and a profiled decode window.
   The ``kernels`` phase holds and times (``timing_bf16_encdec``) flash
   bidirectional at Whisper's encoder (Sq = Sk = 1500, H = K = 6, hd 64),
   at Sq = 1 over Sk = 1500 (Whisper) and 1601 (Vision: H = 64, K = 8, hd
   128) and at Vision's cross prefill (Sq = 256), NaN past Sk; slot
   decode at Whisper's widths; RMSNorm at 4 x 1024 and 4 x 384.

16. ``held_train`` — stablelm's smoke widths in float32 (TF32 off), the
   same weights on the card and on the CPU: the loss, the gradient norm and
   every gradient leaf of one ``loss_and_grads`` (the card's through the
   flash and RMSNorm kernels forward and backward, every call counted), and
   three ``build_train_step`` steps' losses; then each of the ten smoke
   configs (``families``) the same way at batch 2 x 32: one
   ``loss_and_grads`` and one ``build_train_step`` step, loss and grad
   norm within ``HELD_TRAIN_TOL``, every leaf within ``BWD_TOL``, every
   forward kernel call with its backward (Jamba's scan through
   ``ssm_scan_bwd`` once a Mamba layer, DeepSeek's MLA through the flash
   backward at 24 / 16 once a layer);
17. ``train``  — stablelm-1.6b whole (24 layers, published widths, bf16,
   random weights from a seed) through ``repro_torch.launch.train.main``:
   20 steps at batch 4 x 1024 tokens, once with float32 and once with int8
   optimizer state; the loss must fall and every flash and RMSNorm call of
   every step run its kernel forward and backward.  Each run reports step
   ms (p50), train tok/s, MFU (6 N tokens/s against 989 TFLOP/s, N every
   parameter), peak GiB, launches a step and the device idle share of 3
   more steps traced by the profiler.  Then the restart check at 2 layers
   (published widths, int8 state): a run that checkpoints at step 5 (a
   temporary directory) and a run that resumes from it give the
   uninterrupted run's losses for steps 6-10.
   Every bf16 flash call of every step, forward and backward, must take
   the tensor-core body (``tc_launches``), every float32 one in
   ``held_train`` the CUDA-core body.
   The ``kernels`` phase holds both backward kernels against their plain
   backward versions in f32 and bf16 (flash at stablelm's training shape,
   internlm2-20b's g = 6 / hd 128, a ragged 386 with NaN K/V past Sk that
   must move no gradient, bidirectional with Sq != Sk; RMSNorm at 4096 and
   386 x 2048; each deterministic to the bit; every bf16 flash case through
   the backward's tensor-core body, every f32 one through its CUDA-core
   body, and the ragged case once more in bf16 with its inputs off 16
   bytes, through the bf16 CUDA-core body), the flash forward's LSE output
   against the plain LSE, and times both at stablelm's training shape
   beside autograd's backward of SDPA and of ``F.rms_norm``
   (``timing_bf16``), flash at internlm2-20b's and Jamba's widths and
   RMSNorm at 512 x 8192 (``timing_bf16_backward_wide``; the RMSNorm rows
   give the CTAs a SM and rows a CTA the kernel took); ``bwd_witness``
   gives the bf16 flash backward's and SDPA's backward's errors against
   the plain backward on each case's inputs (max and norm-relative);
   ``backward_ptxas`` lists each backward kernel's registers, spills and
   SASS ``HMMA`` count (the tensor-core dK/dV and dQ kernels must hold
   ``HMMA`` and spill nothing).
18. ``train_families`` — the other families' training at published
   widths, bf16, seeded weights (a ``train_family`` line each):
   DeepSeek-V2-Lite-16B cut to its first 6 of 27 layers (MLA + the dense
   MLP, then MLA + 64 experts top-6 + 2 shared) through the launcher with
   ``get_config`` given the cut, float32 state, 10 steps at 4 x 1024, lr
   1e-5 (the flash backward at 192 / 128 in every step); Jamba-1.5-Large's
   first 2 of 72 layers (Mamba + MoE, Mamba + MLP), gradients only (its
   AdamW state does not fit one card): 3 ``loss_and_grads`` passes at
   1 x 1024 through the scan's backward kernel; Whisper-tiny (4 x 256) and
   xLSTM-350M (2 x 32) whole through the launcher, float32 state, 5 steps
   at lr 1e-3.  Each reports step ms (p50), train tok/s, MFU (6 N_active
   tokens/s against 989 TFLOP/s; N_active counts top_k / n_experts of the
   routed experts and leaves out the input embedding, a lookup, unless it
   is tied to the head), peak GiB, launches a step and, from one traced step,
   the device idle share and the backward kernels' share of busy time;
   every loss must fall where steps are taken, Jamba's loss and gradient
   norm be finite.
19. ``sharded`` — the sharded paths at world size 1: a one-rank NCCL group
   and a (data 1, model 1) mesh on the card (``launch/mesh.py``), each
   path against the unsharded one on the card: ``moe_ep`` at
   DeepSeek-V2-Lite-16B's MoE layer (published widths, float32, 4 x 512
   tokens) against ``moe_block`` with the model-dtype and the int8
   dispatch (the int8 one against routing on the tokens and the experts on
   their int8 round trip), within 1e-4 max abs, the expert-parallel body
   counted (``EP_CALLS``) and both timed (CUDA events, a report only);
   ``mlp_ws_decode`` at stablelm-1.6b's widths against ``mlp``; a greedy
   decode of stablelm-1.6b whole in float32 (prompts 4 x 64, 8 steps) with
   its weights ``device_put_tree``'d onto ``tree_shardings`` of the spec
   tree, with the config's decode MLP and with ``decode_mlp="ws"``: tokens
   equal to the unsharded run's, the flash, decode and RMSNorm kernels
   launched under the mesh, and the weight-stationary body run at every
   decode step of every layer (``WS_CALLS``); ``compressed_psum`` bit-equal
   to ``compress_decompress``; a checkpoint of sharded weights restored
   with ``shardings=``, leaves bit-equal; the scan's forward and backward
   on DTensors at Jamba-1.5-Large's layer widths (1 x 1024, d_inner 16384,
   N 16, float32) against the plain-tensor call (y, h_T, every gradient,
   ``ssm_scan_bwd`` launched as often); one ``build_train_step`` step of
   stablelm-1.6b whole in float32 (2 x 256) with its weights on the mesh
   against the unsharded step: the loss, every gradient leaf, the updated
   params, and the flash and RMSNorm kernels and their backward kernels
   launched as many times.
20. ``dryrun`` — the port's dry run (``repro_torch.launch.dryrun``) in a
   process of its own (its fake process group must not meet the
   ``sharded`` phase's NCCL group), on the CPU only, for stablelm-1.6b at
   train_4k, prefill_32k and decode_32k, DeepSeek-V2-Lite-16B at
   decode_32k (an MoE cell), Jamba-1.5-Large at prefill_32k (the Mamba
   mixer's ``ff``-sharded products) and xLSTM-350M at long_500k on a
   16 x 16 fake mesh: rc 0, every key of each cell's record, one more layer of
   stablelm's train and prefill adding an all-reduce, a ``dryrun_cell``
   line each; then the card against the roofline, from the earlier phases' own
   times (nothing is re-run): the analytic compute and memory terms at
   world size 1 with the H100's rates for the ``train`` phase's
   stablelm-1.6b steps (4 x 1024, float32 and int8 state; the port does
   not rematerialize, so the terms are taken with ``remat="none"``) and
   for the ``engine`` phase's decode steps (its measured l(b) at each
   batch size b, the context the requests' mean prompt plus half their
   new tokens), each ratio measured / max(compute, memory), which must be
   at least 1; and ``roofline_profile``'s l(b) at stablelm-1.6b's bf16
   weights and KV bytes beside the ``testbed`` phase's measured l(b)
   (LLMSched's slot replica), with the step overhead the smallest
   measured residual over the bytes term.
   The ``kernels`` phase holds the scan's backward kernel
   (``ssm_scan_bwd``) against ``ssm_scan_bwd_ref`` in f32 and bf16 (Jamba's
   training shape, N 8 and 16, ragged T and D, with and without h0 and
   dh_T, B and C strided, each checkpoint of the forward equal to the bit
   to h_T of the forward cut there, reruns bit-equal) and the flash
   backward at MLA's 24 / 16 and 192 / 128 on its CUDA-core body; it times
   the scan's backward at Jamba's training shape (``timing_bf16``, row 6b:
   its bound the exps, f32 operations or bytes; ``form``, the registers,
   spilled bytes, shared bytes, CTAs a SM and waves of the form launched;
   the forward with its checkpoints at that shape) and the flash backward at
   DeepSeek-V2-Lite's (B = 4, S = 1024, H = K = 16, causal, the shape
   ``train_families`` gives it; held first against the plain backward in
   bf16, a rerun bit-equal; ``timing_bf16_backward_mla``, beside autograd's
   SDPA backward).

The ``testbed`` phase also runs the ``ladder3`` cascade fleet: the
stablelm-1.6b, internlm2-20b and Kimi-K2 smoke configs on three paged
replicas behind a ``DeterministicGate`` (strictness 0.8), built by
``build_engines`` as the launcher builds it; every job must finish.  The
``kernels`` phase also holds and times (``timing_bf16_mla_dense``) flash at
DeepSeek-V2-Lite's MLA prefill (B = 1, Sq = Sk = 512, H = K = 16, hd 192 /
hd_v 128, causal), paged decode over fp pages at Llama-3-405B's H = 128 /
K = 8 and Kimi-K2's and Qwen1.5-110B's H = 64 / K = 8, paged prefill at
Llama-3-405B's widths and RMSNorm at 4 x 16384 and 4 x 7168.

The ``kernels`` phase also holds the Mamba selective-scan kernel against
its plain version at the hybrid path's shapes (D = 16384, N = 16; T = 1 at
B = 4, T = 17 and 512 at B = 1) and the smoke config's, with B and C read
as strided slices, and times it beside its bound (bytes against the exps
on the special-function units at the card's maximum clock).  RMSNorm is
held at d = 100 (odd rows off 16 bytes), with x and gamma off 16 bytes, at
386 rows and at none, and timed (``timing_rmsnorm``, beside
``F.rms_norm``) at the main path's other shapes: 8 x 2048, 386 x 2048,
4 x 8192 and 512 x 8192; ``rmsnorm_sweep`` times it with the warps a row
``_build.rmsnorm_warps`` picks and with twice as many.

``--phases timing`` runs only those RMSNorm and scan timings,
``--phases scan_bwd`` only the scan backward's checks, row 6b and the
forward's row 6p, and ``--src DIR`` imports ``repro_torch`` from another
tree (``DIR`` is its ``src``): with either, one call times a parent commit
and this one in turns (unpack the parent with ``git archive`` into a
git-ignored directory).
Every profiled decode window (``profile`` lines) carries RMSNorm's and the
scan's device time and share of the busy time (``kernel_shares``).

Then a ``kernels`` summary line, the ``nvidia-smi`` name/power-limit line,
and a last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no last line; it also
fails when no CUDA device is present or the port is not beside it.
``--phases`` runs a subset (``env`` always runs).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
import json
import signal
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np

import torch

ROOT = Path(__file__).resolve().parent
STARTED = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense, no sparsity): the float32 peak; the HBM rate
# and the bf16 peak are the port's one copy (``card_rates``)
F32_PEAK_FLOPS = 67e12
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# the selective scan against its plain version: f32 state math in both, in
# another summation order over N and with expf's last bit, compounding over
# T (the JAX package's 2e-4); bf16 adds one rounding of y
SSM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# the special-function units' exp rate: 16 a clock per SM (Hopper)
SFU_EXP_PER_CLOCK_PER_SM = 16
# host seconds between a traced window's edges and the work it measures
TRACE_PAD_S = 0.01
# the H100 SXM's highest SM clock: a device spin of s seconds is given
# s * this many cycles (a lower clock only lengthens it)
SPIN_CLOCK_HZ = 1.98e9
# the longest device spin ``device_ms`` puts ahead of a window's calls
SPIN_MAX_S = 0.2
PHASES = ("kernels", "held", "held_slot", "engine", "testbed", "held_hybrid", "hybrid",
          "held_mla", "mla", "dense", "held_xlstm", "xlstm", "held_encdec", "encdec",
          "held_train", "train", "train_families", "sharded", "dryrun")
# run only when named: the RMSNorm and scan timings alone, and the scan's
# backward alone (its checks, row 6b and the forward's row 6p; ``kernels``
# has them all)
EXTRA_PHASES = ("timing", "scan_bwd")
KERNEL_META = {
    "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                               "src/repro/kernels/paged_attention.py:119"),
    "paged_prefill_attention": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                                "src/repro/kernels/paged_attention.py:257"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:27"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:89"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:113"),
    # the quantized=True forms: the dequantizing lines of the TPU kernels
    "paged_decode_attention_int8": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                                    "src/repro/kernels/paged_attention.py:86"),
    "paged_prefill_attention_int8": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                                     "src/repro/kernels/paged_attention.py:220"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:70"),
    # the gradients of kernels 5 and 3, which the JAX package has no
    # reverse mode for (jax.grad through a Pallas kernel fails)
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:113"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm.py:27"),
    # the gradient of kernel 6
    "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                     "src/repro/kernels/ssm_scan.py:70"),
}
# the kernels of the paged engine's path (by page dtype) and of the
# testbed's slot path
PAGED_KERNELS = {
    "fp32": ("paged_decode_attention", "paged_prefill_attention", "rmsnorm"),
    "int8": ("paged_decode_attention_int8", "paged_prefill_attention_int8", "rmsnorm"),
}
SLOT_KERNELS = ("flash_attention", "decode_attention", "rmsnorm")
# a backward kernel against its plain backward on the same inputs, scaled by
# max(1, the gradient's largest magnitude): f32 (TF32 off) summation order
# over up to Sq * g rows (dk, dv) or Sk keys (dq), and over the rows (dgamma);
# bf16 adds one rounding of each output
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# what an unwritten or recycled slot's scale may hold
GARBAGE_SCALES = (float("nan"), float("inf"), 1e30)
# Card against CPU through int8 caches: a K/V value that straddles a
# rounding boundary quantizes one step apart, and the step grows through
# later layers.  Tokens must still agree; if they do not, the card's int8
# logits must lie closer to the CPU's than int8 quantization itself moves
# the CPU's logits (int8 against fp caches, same weights and input).


def _free_card() -> None:
    """Return what earlier phases left in PyTorch's cache to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def emit(phase: str, **fields) -> None:
    """One JSON line a phase; ``at_s`` is the script's age when it was printed."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - STARTED}),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, groups: int = 15, per_group: int = 10) -> float:
    """Median over groups of the mean time of one call (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / per_group for s, e in spans)


def device_ms(fn, calls: int = 20, windows: int = 3) -> dict:
    """Device time of one call from ``torch.profiler``: every kernel that
    ``calls`` back-to-back calls launch (after a warm-up), summed by kernel
    name and divided by ``calls``.  ``device_ms`` is their sum,
    ``device_windows`` the traced windows it took.  The calls
    sit ``TRACE_PAD_S`` inside the traced window on each side: the tracer
    drops a kernel whose device timestamp, mapped onto the host clock, falls
    outside the window, and that mapping drifts over a long process.  It
    also drops a kernel whose mapped start precedes its launch's host
    timestamp, which the drift brings about for a kernel that an idle device
    starts at once (the flash backward's first ``delta_kernel`` a window).
    A window whose trace lost events all the same (a kernel seen other than
    a whole number of times a call) is measured again, up to ``windows``
    times in all, and each such window first puts a device spin on the
    stream, longer than the host takes to launch the calls, so that every
    measured kernel waits in the queue behind it, and ends with as long a
    pad; the spin, where the trace kept it, is left out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    spin_s = min(SPIN_MAX_S, max(TRACE_PAD_S, 2 * calls * (time.perf_counter() - t0) / 3))
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            if window:
                torch.cuda._sleep(int(spin_s * SPIN_CLOCK_HZ))
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(max(TRACE_PAD_S, spin_s) if window else TRACE_PAD_S)
        by_kernel = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in evt.name:
                name = evt.name if len(evt.name) < 90 else evt.name[:87] + "..."
                t, n = by_kernel.get(name, (0.0, 0))
                by_kernel[name] = (t + evt.time_range.elapsed_us() / 1e3, n + 1)
        if by_kernel and all(n >= calls and n % calls == 0 for _, n in by_kernel.values()):
            break
    check(bool(by_kernel) and all(n >= calls and n % calls == 0 for _, n in by_kernel.values()),
          f"the profiler lost kernel events in {windows} windows: {by_kernel}")
    per_call = {k: t / calls for k, (t, _) in by_kernel.items()}
    return {"device_ms": sum(per_call.values()), "device_kernels": per_call,
            "device_windows": window + 1}


def host_ms(fn, calls: int = 200) -> float:
    """The host's time for one call: ``calls`` back-to-back calls on the
    host clock, without a synchronize between them (each kernel here takes
    the device less time than its call takes the host)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def _times(kernel, plain, library=None) -> dict:
    """A kernel's and its yardsticks' times: ``ms``/``plain_ms``/
    ``library_ms`` by CUDA events over back-to-back calls, the device time
    of one call of the kernel and of the library call (profiler), and the
    host's time for one call of the kernel's wrapper."""
    out = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
           "library_ms": time_ms(library) if library else None,
           "host_ms": host_ms(kernel)}
    out.update(device_ms(kernel))
    lib = device_ms(library) if library else {}
    out["library_device_ms"] = lib.get("device_ms")
    out["library_device_kernels"] = lib.get("device_kernels")
    return out


def _cold_device_ms(fn, tensors, touched: int, dev) -> dict:
    """Device time of one call of ``fn(*tensors)`` whose inputs come cold
    from HBM, as in a decode step, where the other layers' KV has evicted
    this layer's from the L2 cache: the calls rotate over ``copies`` clones
    of ``tensors``, so that between two calls on one copy the calls touch
    more than twice the L2's bytes (``touched`` bytes a call)."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 * 2**20)
    copies = min(32, max(3, -(-2 * l2 // touched) + 1))
    sets = itertools.cycle([tuple(t.clone() for t in tensors) for _ in range(copies)])
    return {"cold_device_ms": device_ms(lambda: fn(*next(sets)))["device_ms"],
            "cold_copies": copies}


def _decode_row(kernel, kernel_in, plain, library, library_in, nbytes, flops, dev,
                shape) -> dict:
    """A decode kernel's timing row, bf16: ``_times`` (warm: the same inputs
    call after call, out of the L2 cache), the bound, and the device time of
    the kernel and of the library call with cold inputs; no cold reading may
    beat the bytes bound (a warm one may: it reads the L2).
    ``other_body_host_ms`` is ``host_ms`` of the same wrapper with its K/V
    rows moved off 16 bytes, which the one-block-a-row body serves: in one
    process, the host cost of the route decode calls took before the split
    body (predicate, split rule and cluster launch) against the new one."""
    from repro_torch.kernels import ops

    nb, fl = bound(nbytes, flops, torch.bfloat16)
    row = dict(**_times(lambda: kernel(*kernel_in), plain, lambda: library(*library_in)),
               bound_ms=nb, bound_by=fl, shape=shape)
    other = (_misaligned(kernel_in[0]), _misaligned(kernel_in[1])) + tuple(kernel_in[2:])
    calls0, split0 = sum(ops.launch_counts().values()), ops.split_launch_counts()
    row["other_body_host_ms"] = host_ms(lambda: kernel(*other))
    check(ops.split_launch_counts() == split0, "a misaligned decode call took the split body")
    row["other_body_calls"] = sum(ops.launch_counts().values()) - calls0
    del other
    cold = _cold_device_ms(kernel, kernel_in, nbytes, dev)
    lib = _cold_device_ms(library, library_in,
                          sum(t.numel() * t.element_size() for t in library_in), dev)
    row.update(cold, library_cold_device_ms=lib["cold_device_ms"],
               library_cold_copies=lib["cold_copies"])
    check(row["cold_device_ms"] >= nb and row["library_cold_device_ms"] >= nb,
          f"a cold reading beats its bytes bound {nb} ms: {row}")
    return row


def card_rates():
    """``(HBM bytes/s, {dtype: peak FLOP/s})`` of one NVIDIA H100 80GB HBM3
    (SXM, 700 W), data sheet, dense: the HBM rate and the bf16 peak are
    ``repro_torch.launch.dryrun``'s ``HBM_BW`` and ``PEAK_FLOPS`` (imported
    from the tree ``main`` put on the path), the float32 peak this
    script's."""
    from repro_torch.launch import dryrun

    return dryrun.HBM_BW, {torch.bfloat16: dryrun.PEAK_FLOPS, torch.float32: F32_PEAK_FLOPS}


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    hbm, peaks = card_rates()
    t_bytes = nbytes / hbm * 1e3
    t_ops = flops / peaks[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase: env
# ---------------------------------------------------------------------------
def phase_env(build_mod) -> dict:
    nvcc = subprocess.run([build_mod.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), nvcc)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    t0 = time.perf_counter()
    info = build_mod.build()
    build_mod.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln
             or "error" in ln]
    sass = _sass_mma(build_mod, info["path"])
    env = {
        "sass_mma": sass,
        "split_bodies": _split_bodies(info["log"], sass),
        "rmsnorm_ssm_ptxas": _ptxas_of(info["log"], _norm_scan_key),
        "backward_ptxas": _backward_ptxas(info["log"], sass),
        "nvidia_smi": smi_line(),
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": release,
        "triton": triton_version,
        "build_s": time.perf_counter() - t0,
        "built_now": info["built"],
        "ptxas": ptxas,
    }
    emit("env", **env)
    return env


def _sass_mma(build_mod, lib_path: str):
    """Tensor-core instructions in each kernel's SASS (``cuobjdump -sass``),
    where the toolkit has ``cuobjdump``: ``{kernel: {"HMMA": n, "HGMMA":
    m, "instructions": all}}``.  Every tensor-core body must hold ``HMMA``
    or ``HGMMA``."""
    bin_dir = Path(build_mod.nvcc_path()).parent
    if not (bin_dir / "cuobjdump").exists():
        return None
    sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0, "instructions": 0}
        elif name is not None and line.strip().startswith("/*") and ";" in line:
            counts[name]["instructions"] += 1
            op = "HGMMA" if "HGMMA" in line else "HMMA" if "HMMA" in line else None
            if op:
                counts[name][op] += 1
    filt = bin_dir / "cu++filt"
    if filt.exists() and counts:
        names = subprocess.run([str(filt)], input="\n".join(counts), capture_output=True,
                               text=True, check=True, timeout=60).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    tc = {k: v for k, v in counts.items() if "attention_tc_kernel" in k}
    check(len(tc) == 9 and all(v["HMMA"] + v["HGMMA"] > 0 for v in tc.values()),
          f"a tensor-core body without tensor-core instructions: {tc}")
    return counts


def _norm_scan_key(name: str):
    """``rmsnorm<dtype, W warps>``, ``ssm_scan<dtype, L lanes>``,
    ``ssm_scan_bwd<dtype, L lanes, vector|strided>`` or
    ``ssm_scan_bwd_sum<dtype>`` of one instantiation of the RMSNorm or
    selective-scan kernel or of the scan's backward (its recurrence, in the
    form that stages 16-byte vectors or the one that reads through strides,
    and its sum of the partials), from its mangled name (an instantiation
    without the count, as an older tree's, keeps only the dtype; an older
    backward has no form); None for another kernel."""
    import re

    m = re.search(r"(rmsnorm|ssm_scan|ssm_scan_bwd|ssm_scan_bwd_sum)_kernelI(f|13__nv_bfloat16)"
                  r"(?:Li(\d+)E)?(?:Lb([01])E)?", name)
    if not m:
        return None
    dtype = "f32" if m.group(2) == "f" else "bf16"
    if m.group(3) is None:
        return f"{m.group(1)}<{dtype}>"
    form = "" if m.group(4) is None else (", vector" if m.group(4) == "1" else ", strided")
    count = "warps" if m.group(1) == "rmsnorm" else "lanes"
    return f"{m.group(1)}<{dtype}, {m.group(3)} {count}{form}>"


def _backward_key(name: str):
    """``<kernel><dtype[, HD[, HDV] or slots[, form]]>`` of one instantiation
    of a backward kernel (flash: ``delta_kernel``, ``dkdv_kernel``,
    ``dq_kernel`` and the tensor-core body's ``delta_tc_kernel``,
    ``dkdv_tc_kernel``, ``dq_tc_kernel``, bf16 only; RMSNorm:
    ``rmsnorm_bwd_kernel`` by the slots a thread holds and its aligned or
    checked form, ``dgamma_kernel``), from its mangled or demangled name;
    None for another kernel."""
    import re

    kinds = r"(delta|dkdv|dq|rmsnorm_bwd|dgamma)(_tc)?_kernel"
    m = (re.search(kinds + r"I(f|13__nv_bfloat16)?(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Lb([01])E)?",
                   name)
         or re.search(kinds + r"<(float|__nv_bfloat16)?(?:, )?(?:\(int\))?(\d+)?"
                              r"(?:, (?:\(int\))?(\d+))?"
                              r"(?:, (?:\(bool\))?(true|false|1|0))?>", name))
    if not m:
        return None
    dtype = "f32" if m.group(3) in ("f", "float") else "bf16"
    extra = m.group(4)
    if extra and m.group(1) == "rmsnorm_bwd":
        extra += " slots"
    if m.group(5) is not None:     # the flash CUDA-core body's HDV
        extra += f", {m.group(5)}"
    if m.group(6) is not None:
        extra += ", aligned" if m.group(6) in ("1", "true") else ", checked"
    return f"{m.group(1)}{m.group(2) or ''}<{dtype}" + (f", {extra}>" if extra else ">")


def _backward_ptxas(log: str, sass) -> dict:
    """Registers and spill bytes (``ptxas``) of every backward kernel
    instantiation, with its SASS ``HMMA`` count where the toolkit has
    ``cuobjdump``: the flash backward's tensor-core dK/dV and dQ kernels
    must hold ``HMMA`` and spill nothing; the scan's backward
    (``ssm_scan_bwd<dtype, L lanes, form>`` and its sum, by
    ``_norm_scan_key``) spills nothing in either 4-lane form, which N = 16
    launches."""
    out = _ptxas_of(log, _backward_key)
    scan = _ptxas_of(log, lambda n: k if (k := _norm_scan_key(n)) and "_bwd" in k else None)
    out.update(scan)
    four = {k: v for k, v in scan.items() if ", 4 lanes" in k}
    check(all(v.get("spill_stores", 0) == v.get("spill_loads", 0) == 0 for v in four.values()),
          f"the scan backward's 4-lane form spills: {four}")
    for name, counts in (sass or {}).items():
        key = _backward_key(name)
        if key in out:
            out[key]["HMMA"] = counts["HMMA"]
    from repro_torch.kernels import _build

    tc = {k: v for k, v in out.items() if k.startswith(("dkdv_tc", "dq_tc"))}
    check(len(tc) == 2 * len(_build.TC_HEAD_DIMS), f"backward tensor-core kernels: {sorted(tc)}")
    check(all(v.get("spill_stores", 0) == v.get("spill_loads", 0) == 0 for v in tc.values()),
          f"a backward tensor-core kernel spills: {tc}")
    check(sass is None or all(v.get("HMMA", 0) > 0 for v in tc.values()),
          f"a backward tensor-core kernel without HMMA: {tc}")
    return out


def _ptxas_of(log: str, key_of) -> dict:
    """``ptxas``'s registers and spill bytes of every kernel instantiation
    that ``key_of`` names (from its mangled name)."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            key = key_of(line.split("'")[1])
            if key is not None:
                out[key] = {}
        elif key is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            out[key]["spill_stores"] = int(words[words.index("spill") - 2])
            out[key]["spill_loads"] = int(words[-4])
        elif key is not None and "Used" in line and "registers" in line:
            words = line.split()
            out[key]["registers"] = int(words[words.index("registers,") - 1])
    return out


def _split_key(name: str):
    """``decode_split<HD, G, q dtype, page dtype, slot|paged>`` (CUDA-core
    form) or ``decode_split_tc<HD, bf16|int8, slot|paged>`` (tensor-core
    form) of one instantiation of the split-context decode body, from its
    mangled or demangled name; None for another kernel."""
    import re

    flag = r"(?:\(bool\))?(true|false|1|0)"
    num = r"(?:\(int\))?(\d+)"
    m = re.search(r"decode_split_tc_kernelILi(\d+)ELb([01])ELb([01])E", name) or \
        re.search(rf"decode_split_tc_kernel<{num}, {flag}, {flag}>", name)
    if m:
        pages = "int8" if m.group(2) in ("true", "1") else "bf16"
        where = "paged" if m.group(3) in ("true", "1") else "slot"
        return f"decode_split_tc<{m.group(1)}, {pages}, {where}>"
    m = re.search(r"decode_split_kernelILi(\d+)ELi(\d+)E(.*?)Lb([01])E", name)
    if m:
        t = "bf16" if m.group(3).startswith("13__nv_bfloat16") else "f32"
        tp = "int8" if m.group(3).endswith("a") else t
        hd, g, paged = m.group(1), m.group(2), m.group(4) == "1"
    else:
        # c++filt: <128, 4, float, signed char, true>; cu++filt: <(int)128, ..., (bool)1>
        m = re.search(rf"decode_split_kernel<{num}, {num}, ([^,]+), ([^,]+), {flag}>", name)
        if not m:
            return None
        names = {"__nv_bfloat16": "bf16", "float": "f32", "signed char": "int8"}
        hd, g, t, tp, paged = (m.group(1), m.group(2), names[m.group(3)], names[m.group(4)],
                               m.group(5) in ("true", "1"))
    return f"decode_split<{hd}, {g}, {t}, {tp}, {'paged' if paged else 'slot'}>"


#: instantiations of the split body: the CUDA-core form at G = 1, 2 for bf16
#: q and 1, 2, 4 for f32 q, the tensor-core form for bf16 q; each at hd 16,
#: 64 and 128 over slot caches, paged pools and int8 pools
SPLIT_BODIES = 3 * (3 * 2 + 3 * 3) + 3 * 3


def _split_bodies(log: str, sass) -> dict:
    """Each instantiation of the split-context decode body: ``ptxas``'s
    registers and spill bytes, and its SASS instruction count (and, for the
    tensor-core form, its ``HMMA`` count, which must not be 0) where the
    toolkit has ``cuobjdump``."""
    out = _ptxas_of(log, _split_key)
    for name, counts in (sass or {}).items():
        key = _split_key(name)
        if key in out:
            out[key]["sass_instructions"] = counts["instructions"]
            if key.startswith("decode_split_tc"):
                out[key]["HMMA"] = counts["HMMA"]
    check(len(out) == SPLIT_BODIES,
          f"expected {SPLIT_BODIES} split-body instantiations, found {len(out)}")
    check(all(v.get("HMMA", 1) > 0 for v in out.values()),
          f"a tensor-core decode body without HMMA: {out}")
    return out


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------
def _on(dev, dtype, *arrays):
    return [torch.from_numpy(a).to(dev, dtype) for a in arrays]


def _poisoned(kp, vp, garbage, value):
    """Copies of the pools with every garbage slot set to +-value."""
    k, v = kp.clone(), vp.clone()
    k[garbage], v[garbage] = value, -value
    return k, v


def _decode_case(rng, B, H, K, hd, ps, npp, lens, dtype, dev):
    """q, clean pools, tables, lengths and the (P, ps) mask of garbage
    slots: pages no row references and the tail past each length."""
    P = B * npp + 3
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[: B * npp].reshape(B, npp).astype(np.int32)
    garbage = np.ones((P, ps), bool)
    for b in range(B):
        for t in range(int(lens[b])):
            garbage[bt[b, t // ps], t % ps] = False
    q, kp, vp = _on(dev, dtype, q, kp, vp)
    lens_t = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    return (q, kp, vp, torch.from_numpy(bt).to(dev), lens_t,
            torch.from_numpy(garbage).to(dev))


def _prefill_case(rng, C, H, K, hd, ps, past, dtype, dev):
    """q, clean pools, table and the garbage mask (every slot at or past
    ctx = past + C, and every page outside the context's table entries)."""
    ctx = past + C
    npp = -(-ctx // ps) + 2
    P = npp + 6
    q = rng.normal(size=(C, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(P, ps, K, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, P))[:npp].astype(np.int32)
    garbage = np.ones((P, ps), bool)
    for t in range(ctx):
        garbage[bt[t // ps], t % ps] = False
    q, kp, vp = _on(dev, dtype, q, kp, vp)
    return q, kp, vp, torch.from_numpy(bt).to(dev), torch.from_numpy(garbage).to(dev)


def _err(got: torch.Tensor, want: torch.Tensor, dtype, tol=TOL) -> float:
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    g, w = got.float(), want.float()
    excess = (g - w).abs() - (tol[dtype] + tol[dtype] * w.abs())
    check(float(excess.max()) <= 0, f"kernel outside tolerance {tol[dtype]}: "
          f"max |err| {float((g - w).abs().max())}")
    return float((g - w).abs().max())


def _check_rmsnorm(rng, dev, errs, cases, d, row_counts) -> None:
    """RMSNorm against its plain version at width ``d``, f32 and bf16:
    stablelm's 2048 at 1, 8 and 64 rows, Jamba's 8192 at its decode
    (4) and prefill (up to 512) rows."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rmsnorm import rmsnorm

    for dtype in (torch.bfloat16, torch.float32):
        for rows in row_counts:
            x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32) * 3)
            g = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
            x, g = x.to(dev, dtype), g.to(dev, dtype)
            errs["rmsnorm"] = max(errs["rmsnorm"],
                                  _err(rmsnorm(x, g), R.rmsnorm_ref(x, g), dtype))
            cases.append(("rmsnorm", d, str(dtype), rows))


def _misaligned_rows(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data pointer is one element off the
    buffer's start (storage offset 1): off 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _check_rmsnorm_edges(dev, errs, cases) -> None:
    """RMSNorm where its vectors do not fit: d = 100 (not a multiple of
    8 bf16 or 4 f32 values, so odd rows start off 16 bytes), x and gamma
    off 16 bytes (storage offset 1), 386 rows (a slot admission), and no
    rows; f32 and bf16, each against its plain version, one launch a call
    (none without rows)."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rmsnorm import rmsnorm

    rng = np.random.default_rng(17)
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in ((0, 2048), (1, 100), (8, 100), (386, 2048), (386, 100)):
            x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32) * 3).to(dev, dtype)
            g = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(dev, dtype)
            for label, (xi, gi) in (("aligned", (x, g)),
                                    ("off 16 bytes", (_misaligned_rows(x), _misaligned_rows(g)))):
                before = rmsnorm.launches
                got = rmsnorm(xi, gi)
                check(rmsnorm.launches == before + (1 if rows else 0),
                      f"rmsnorm launches at rows={rows}: {rmsnorm.launches - before}")
                check(got.shape == x.shape, f"rmsnorm output shape {tuple(got.shape)}")
                if rows:
                    errs["rmsnorm"] = max(errs["rmsnorm"],
                                          _err(got, R.rmsnorm_ref(xi, gi), dtype))
                cases.append(("rmsnorm edge", str(dtype), rows, d, label))


def _check_slot_kernels(rng, dev, errs, cases) -> None:
    """The slot path's kernels against their plain versions: slot decode at
    B = 4, S_max = 1024 with lengths 1, 17, 511, 1024 and the tails past them
    poisoned (+-99 against the plain version, NaN against the kernel on
    clean caches); flash at B = 1, Sq = Sk = 1, 97, 512, causal and not."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    def randn(*shape):
        return rng.normal(size=shape).astype(np.float32)

    widths = {"stablelm-1.6b": (32, 32, 64, 64), "internlm2-20b GQA": (48, 8, 128, 128),
              "jamba-1.5-large": (64, 8, 128, 128)}
    B, S = 4, 1024
    lens = np.array([1, 17, 511, 1024], np.int32)
    tail = torch.from_numpy(np.arange(S)[None, :] >= lens[:, None]).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    for label, (H, K, hd, hd_v) in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc = _on(dev, dtype, randn(B, H, hd), randn(B, S, K, hd),
                            randn(B, S, K, hd_v))
            k99, v99 = kc.clone(), vc.clone()
            k99[tail], v99[tail] = 99.0, -99.0
            got = decode_attention(q, k99, v99, ln)
            errs["decode_attention"] = max(errs["decode_attention"], _err(
                got, R.decode_attention_ref(q, k99, v99, ln), dtype))
            knan, vnan = kc.clone(), vc.clone()
            knan[tail], vnan[tail] = float("nan"), float("nan")
            check(torch.equal(decode_attention(q, knan, vnan, ln),
                              decode_attention(q, kc, vc, ln)),
                  f"slot decode output changed under NaN tails ({label}, {dtype})")
            cases.append(("slot decode", label, str(dtype), B))
    widths["MLA 192/128"] = (16, 16, 192, 128)
    for label, (H, K, hd, hd_v) in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            for Sq in (1, 97, 512):
                q, k, v = _on(dev, dtype, randn(1, Sq, H, hd), randn(1, Sq, K, hd),
                              randn(1, Sq, K, hd_v))
                for causal in (True, False):
                    got = flash_attention(q, k, v, causal=causal)
                    errs["flash_attention"] = max(errs["flash_attention"], _err(
                        got, R.attention_ref(q, k, v, causal=causal), dtype))
                    cases.append(("flash", label, str(dtype), Sq, causal))


def _int8_pools(kp, vp, garbage=None):
    """int8 pools and f32 scale pools quantized from ``kp``/``vp``; every
    slot of the ``(P, ps)`` mask ``garbage`` holds a +-99 payload with a
    clean scale of 1."""
    from repro_torch.kernels import ops

    kq, ks = ops.quantize_kv(kp)
    vq, vs = ops.quantize_kv(vp)
    if garbage is not None:
        kq[garbage], vq[garbage] = 99, -99
        ks[garbage], vs[garbage] = 1.0, 1.0
    return kq, vq, ks, vs


def _check_int8_kernels(dev, errs, cases) -> None:
    """Both int8 kernels against their plain versions, f32 and bf16 q, at
    stablelm-1.6b's and internlm2-20b's widths: decode at B = 8 (lengths
    1..1024 of 64 pages of 16), prefill C = 64 at past 0, 448 and 960.
    NaN, Inf and 1e30 scales on every garbage slot must not change the
    output by a bit."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_int8, paged_prefill_attention_int8,
    )

    rng = np.random.default_rng(8)
    widths = {"stablelm-1.6b": (32, 32, 64), "internlm2-20b GQA": (48, 8, 128)}
    ps, npp = 16, 64
    for label, (H, K, hd) in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            lens = np.concatenate([[1024, 1, ps, ps + 1], rng.integers(1, 1025, size=4)])
            q, kp, vp, bt, ln, garbage = _decode_case(
                rng, 8, H, K, hd, ps, npp, lens, torch.float32, dev)
            kq, vq, ks, vs = _int8_pools(kp, vp, garbage)
            q = q.to(dtype)
            got = paged_decode_attention_int8(q, kq, vq, bt, ln, ks, vs)
            want = R.paged_decode_attention_ref(q, kq, vq, bt, ln, k_scales=ks, v_scales=vs)
            errs["paged_decode_attention_int8"] = max(
                errs["paged_decode_attention_int8"], _err(got, want, dtype))
            for bad in GARBAGE_SCALES:
                k2, v2 = _poisoned(ks, vs, garbage, bad)
                check(torch.equal(paged_decode_attention_int8(q, kq, vq, bt, ln, k2, v2),
                                  got),
                      f"int8 decode output changed under {bad} scales ({label}, {dtype})")
            cases.append(("int8 decode", label, str(dtype), 8))
            for past in (0, 448, 960):
                C = 64
                q, kp, vp, bt, garbage = _prefill_case(
                    rng, C, H, K, hd, ps, past, torch.float32, dev)
                kq, vq, ks, vs = _int8_pools(kp, vp, garbage)
                q = q.to(dtype)
                got = paged_prefill_attention_int8(q, kq, vq, bt, past, ks, vs)
                want = R.paged_prefill_attention_ref(q, kq, vq, bt, past, k_scales=ks,
                                                     v_scales=vs)
                errs["paged_prefill_attention_int8"] = max(
                    errs["paged_prefill_attention_int8"], _err(got, want, dtype))
                for bad in GARBAGE_SCALES:
                    k2, v2 = _poisoned(ks, vs, garbage, bad)
                    check(torch.equal(
                        paged_prefill_attention_int8(q, kq, vq, bt, past, k2, v2), got),
                        f"int8 prefill output changed under {bad} scales "
                        f"({label}, {dtype})")
                cases.append(("int8 prefill", label, str(dtype), past))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view whose rows start one element into rows one
    element wider: off 16 bytes, so the split-context body refuses it."""
    wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, dtype=t.dtype, device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


def _check_decode_edges(dev, errs, cases) -> None:
    """Both decode kernels (int8 pages too), f32 and bf16, at stablelm-1.6b's
    widths over lengths 0, 1, ps, ps + 1, the capacity and mixed: zeros at
    length 0 with NaN everywhere past the lengths (int8: NaN, Inf and 1e30
    scales there, which must not change the output by a bit), the plain
    version's output at the other lengths.  Once with 16-byte pool and
    cache rows, where the split body must take every call, and once with
    the paged pools' rows moved off 16 bytes, where the one-block-a-row
    body must take every paged call; MLA decode's 192 / 128 slot cache
    must take the other body too."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_int8,
    )

    rng = np.random.default_rng(15)
    H, K, hd, ps, npp = 32, 32, 64, 16, 64
    cap = ps * npp
    lens = np.array([0, 1, ps, ps + 1, cap, 33, 515, cap - 7], np.int32)
    B = len(lens)
    for body in ("split", "other"):
        place = _misaligned if body == "other" else (lambda t: t)
        before = (ops.launch_counts(), ops.split_launch_counts())
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, bt, ln, garbage = _decode_case(rng, B, H, K, hd, ps, npp, lens, dtype,
                                                      dev)
            kq, vq, ks, vs = _int8_pools(kp.float(), vp.float(), garbage)
            runs = {"paged_decode_attention": (
                lambda k, v: paged_decode_attention(q, k, v, bt, ln),
                lambda k, v: R.paged_decode_attention_ref(q, k, v, bt, ln), kp, vp, garbage)}
            if body == "split":
                kc = R.gather_pages(kp, bt)                  # (B, cap, K, hd) slot caches
                vc = R.gather_pages(vp, bt)
                tail = torch.from_numpy(np.arange(cap)[None, :] >= lens[:, None]).to(dev)
                runs["decode_attention"] = (
                    lambda k, v: decode_attention(q, k, v, ln),
                    lambda k, v: R.decode_attention_ref(q, k, v, ln), kc, vc, tail)
            for name, (kern, plain, k, v, dead) in runs.items():
                k99, v99 = k.clone(), v.clone()
                k99[dead], v99[dead] = 99.0, -99.0
                k99, v99 = place(k99), place(v99)
                got = kern(k99, v99)
                errs[name] = max(errs[name], _err(got[1:], plain(k99, v99)[1:], dtype))
                knan, vnan = k.clone(), v.clone()
                knan[dead], vnan[dead] = float("nan"), float("nan")
                got = kern(place(knan), place(vnan))
                check(torch.equal(got[0], torch.zeros_like(got[0])),
                      f"{name}: length 0 did not give zeros ({body} body, {dtype})")
                check(torch.equal(got, kern(place(k), place(v))),
                      f"{name}: NaN past the lengths leaked ({body} body, {dtype})")
            kq, vq = place(kq), place(vq)
            got = paged_decode_attention_int8(q, kq, vq, bt, ln, ks, vs)
            errs["paged_decode_attention_int8"] = max(
                errs["paged_decode_attention_int8"],
                _err(got[1:], R.paged_decode_attention_ref(q, kq, vq, bt, ln, k_scales=ks,
                                                           v_scales=vs)[1:], dtype))
            check(torch.equal(got[0], torch.zeros_like(got[0])),
                  f"int8 decode: length 0 did not give zeros ({body} body, {dtype})")
            for bad in GARBAGE_SCALES:
                k2, v2 = _poisoned(ks, vs, garbage, bad)
                check(torch.equal(paged_decode_attention_int8(q, kq, vq, bt, ln, k2, v2), got),
                      f"int8 decode output changed under {bad} scales ({body} body, {dtype})")
            cases.append(("decode edges", body, str(dtype)))
        counts, splits = ops.launch_counts(), ops.split_launch_counts()
        served = {k: (counts[k] - before[0][k], splits[k] - before[1][k])
                  for k in ops.SPLIT_KERNELS}
        if body == "split":
            check(all(n == m > 0 for n, m in served.values()),
                  f"a decode call missed the split body: {served}")
        else:
            check(all(n > 0 and m == 0 for k, (n, m) in served.items()
                      if k != "decode_attention"),
                  f"a misaligned paged decode call took the split body: {served}")
    # MLA decode (hd 192, hd_v 128) takes the one-block-a-row body
    q = _on(dev, torch.bfloat16, rng.normal(size=(2, 16, 192)).astype(np.float32))[0]
    kc, vc = _on(dev, torch.bfloat16, rng.normal(size=(2, 64, 16, 192)).astype(np.float32),
                 rng.normal(size=(2, 64, 16, 128)).astype(np.float32))
    ln = torch.tensor([5, 64], dtype=torch.int32, device=dev)
    split0 = ops.split_launch_counts()["decode_attention"]
    errs["decode_attention"] = max(errs["decode_attention"], _err(
        decode_attention(q, kc, vc, ln), R.decode_attention_ref(q, kc, vc, ln), torch.bfloat16))
    check(ops.split_launch_counts()["decode_attention"] == split0,
          "MLA decode (192 / 128) took the split body")
    cases.append(("decode MLA 192/128",))


def _scan_inputs(rng, B, T, D, N, dtype, dev, r=512):
    """Selective-scan inputs in the Mamba layer's layout: x, dt (B, T, D),
    A (D, N) f32, B and C as strided column slices of one (B, T, r + 2N)
    projection, D (D,), h0 (B, D, N) f32; the JAX package's test ranges."""
    def on(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    proj = on(rng.normal(size=(B, T, r + 2 * N)) * 0.3)
    return (on(rng.normal(size=(B, T, D)) * 0.5),
            on(np.abs(rng.normal(size=(B, T, D))) * 0.1),
            on(-(np.abs(rng.normal(size=(D, N))) + 0.1), torch.float32),
            proj[..., r:r + N], proj[..., r + N:], on(rng.normal(size=(D,))),
            on(rng.normal(size=(B, D, N)) * 0.2, torch.float32))


def _check_ssm_scan(dev, errs, cases) -> None:
    """ssm_scan against its plain version, f32 and bf16, with B and C read
    as strided column slices: the main path's shapes (D = 16384, N = 16;
    T = 1 at B = 4, T = 17 and 512 at B = 1), the smoke config's (D = 128,
    N = 8), ragged T and D and state sizes 1, 4 and 13, each with h0 given
    and none; then two halves with the state carried must equal the whole,
    bit for bit."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.ssm_scan import ssm_scan

    rng = np.random.default_rng(9)
    shapes = [(4, 1, 16384, 16), (1, 17, 16384, 16), (1, 512, 16384, 16),
              (2, 13, 128, 8), (3, 37, 100, 16), (2, 13, 128, 1), (2, 13, 128, 4),
              (3, 37, 100, 13)]
    for dtype in (torch.bfloat16, torch.float32):
        for B, T, D, N in shapes:
            x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(rng, B, T, D, N, dtype, dev)
            check(not Bm.is_contiguous(), "the scan's B should be a strided view")
            for h in (h0, None):
                y, hT = ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h)
                yr, hr = R.ssm_scan_ref(x, dt, A, Bm, Cm, Dk, h0=h)
                errs["ssm_scan"] = max(errs["ssm_scan"], _err(y, yr, dtype, SSM_TOL),
                                       _err(hT, hr, torch.float32, SSM_TOL))
                cases.append(("ssm_scan", str(dtype), B, T, D, N, h is not None))
        x, dt, A, Bm, Cm, Dk, _ = _scan_inputs(rng, 1, 512, 16384, 16, dtype, dev)
        y, hT = ssm_scan(x, dt, A, Bm, Cm, Dk)
        ya, ha = ssm_scan(x[:, :200], dt[:, :200], A, Bm[:, :200], Cm[:, :200], Dk)
        yb, hb = ssm_scan(x[:, 200:], dt[:, 200:], A, Bm[:, 200:], Cm[:, 200:], Dk, h0=ha)
        check(torch.equal(torch.cat([ya, yb], dim=1), y) and torch.equal(hb, hT),
              f"ssm_scan: two halves with the state carried differ from the whole ({dtype})")
        cases.append(("ssm_scan carry", str(dtype)))


def _sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), for the exp bound."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _ssm_timing(dev, rng, B, T, D, N, with_h0: bool) -> dict:
    """Kernel and plain times of one scan (bf16, CUDA events) and its bound:
    bytes (x, dt, y; B, C; A, D; h0 and h_T, each once) over the HBM rate
    against the exps (one a (t, d, n)) over the SFUs' rate at the card's
    maximum clock, or the f32 operations (7 a (t, d, n)) over the f32 peak."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.ssm_scan import ssm_scan

    dt_ = torch.bfloat16
    x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(rng, B, T, D, N, dt_, dev)
    h0 = h0 if with_h0 else None
    es = 2
    nbytes = (3 * B * T * D * es + 2 * B * T * N * es + D * N * 4 + D * es
              + B * D * N * 4 * (2 if with_h0 else 1))
    clock = _sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t_bytes = nbytes / card_rates()[0] * 1e3
    t_exp = B * T * D * N / (SFU_EXP_PER_CLOCK_PER_SM * sms * clock) * 1e3
    t_flops = 7 * B * T * D * N / F32_PEAK_FLOPS * 1e3
    bound_ms = max(t_bytes, t_exp, t_flops)
    return dict(
        ms=time_ms(lambda: ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)),
        plain_ms=time_ms(lambda: R.ssm_scan_ref(x, dt, A, Bm, Cm, Dk, h0=h0),
                         groups=5 if T > 64 else 15),
        host_ms=host_ms(lambda: ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)),
        **device_ms(lambda: ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)),
        library_ms=None, library_device_ms=None,
        library="no single PyTorch call computes a selective scan",
        bound_ms=bound_ms, bound_by="bytes" if t_bytes >= max(t_exp, t_flops) else "operations",
        bound_parts_ms={"bytes": t_bytes, "sfu_exp": t_exp, "f32_ops": t_flops},
        sm_clock_mhz=clock / 1e6, sms=sms, bytes=nbytes,
        shape=f"B={B} T={T} D={D} N={N} h0={'given' if with_h0 else 'none'}, B/C strided")


def _paged_decode_rows(q, kp, vp, bt, ln, lens, errs, dev, shape, int8: bool = True):
    """Timing rows of paged decode over bf16 pages and (with ``int8``) over
    the same K/V quantized to int8 pages, bf16 q; each also held against its
    plain version.  SDPA runs on the gathered (and for int8 dequantized) K/V
    with a length mask (gather and dequantize untimed)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_int8,
    )

    dt, es = torch.bfloat16, 2
    B, H, hd = q.shape
    _, ps, K, _ = kp.shape
    errs["paged_decode_attention"] = max(errs["paged_decode_attention"], _err(
        paged_decode_attention(q, kp, vp, bt, ln), R.paged_decode_attention_ref(
            q, kp, vp, bt, ln), dt))
    mask = (torch.arange(bt.shape[1] * ps, device=dev)[None, :] < ln[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None]

    def dense(pool):
        return R.gather_pages(pool, bt).transpose(1, 2).contiguous()   # (B, K, S, hd)

    tokens = int(lens.sum())
    table = 4 * int(sum(-(-int(n) // ps) for n in lens)) + 4 * B
    g = H // K
    fp = _decode_row(
        lambda k, v: paged_decode_attention(q, k, v, bt, ln), (kp, vp),
        lambda: R.paged_decode_attention_ref(q, kp, vp, bt, ln),
        lambda k, v: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                    enable_gqa=g > 1),
        (dense(kp), dense(vp)), 2 * B * H * hd * es + 2 * tokens * K * hd * es + table,
        4 * H * hd * tokens, dev, shape)
    if not int8:
        return fp, None
    kq, vq, ks, vs = _int8_pools(kp, vp)
    errs["paged_decode_attention_int8"] = max(
        errs["paged_decode_attention_int8"],
        _err(paged_decode_attention_int8(q, kq, vq, bt, ln, ks, vs),
             R.paged_decode_attention_ref(q, kq, vq, bt, ln, k_scales=ks, v_scales=vs), dt))
    q8 = _decode_row(
        lambda k, v, a, b: paged_decode_attention_int8(q, k, v, bt, ln, a, b),
        (kq, vq, ks, vs),
        lambda: R.paged_decode_attention_ref(q, kq, vq, bt, ln, k_scales=ks, v_scales=vs),
        lambda k, v: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                    enable_gqa=g > 1),
        (dense(R.dequantize_pages_ref(kq, ks).to(dt)),
         dense(R.dequantize_pages_ref(vq, vs).to(dt))),
        2 * B * H * hd * es + 2 * tokens * K * hd + 2 * tokens * K * 4 + table,
        4 * H * hd * tokens + 2 * tokens * K * hd, dev, shape + ", int8 pages, bf16 q")
    return fp, q8


def _slot_decode_row(q, kc, vc, ln, lens, dev, shape) -> dict:
    """Timing row of slot decode, bf16; SDPA with a length mask over the
    (B, K, S_max, hd) transposed cache (transposed untimed)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention

    es = 2
    B, H, hd = q.shape
    _, S, K, _ = kc.shape
    smask = (torch.arange(S, device=dev)[None, :] < ln[:, None].long())[:, None, None, :]
    tokens = int(lens.sum())
    return _decode_row(
        lambda k, v: decode_attention(q, k, v, ln), (kc, vc),
        lambda: R.decode_attention_ref(q, kc, vc, ln),
        lambda k, v: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=smask,
                                                    enable_gqa=H > K),
        (kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()),
        2 * B * H * hd * es + 2 * tokens * K * hd * es + 4 * B, 4 * H * hd * tokens, dev,
        shape)


def _wide_timing(dev, errs) -> dict:
    """The tensor-core bodies timed at the main path's other widths, bf16,
    with inputs from a generator of their own (the first slices' timed
    inputs stay as they were): flash at Jamba-1.5-Large's (B = 1, Sq = Sk
    = 512, causal, H = 64, K = 8, hd = 128) and paged prefill over fp and
    int8 pages at internlm2-20b's (C = 64 at past = 448, H = 48, K = 8, hd
    = 128, page 16); each also held against its plain version.  SDPA runs
    with ``enable_gqa`` over the same K/V heads (gathered, and for int8
    dequantized, untimed)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import (
        paged_prefill_attention, paged_prefill_attention_int8,
    )

    rng = np.random.default_rng(13)
    dt, es = torch.bfloat16, 2
    wide = {}
    Sq, H, K, hd = 512, 64, 8, 128
    q, k, v = _on(dev, dt, *(rng.normal(size=sh).astype(np.float32)
                             for sh in ((1, Sq, H, hd), (1, Sq, K, hd), (1, Sq, K, hd))))
    errs["flash_attention"] = max(errs["flash_attention"], _err(
        flash_attention(q, k, v), R.attention_ref(q, k, v), dt))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = Sq * (Sq + 1) // 2
    nb, fl = bound(2 * Sq * H * hd * es + 2 * Sq * K * hd * es, 4 * H * hd * pairs, dt)
    wide["flash_attention"] = dict(
        **_times(lambda: flash_attention(q, k, v, causal=True),
                 lambda: R.attention_ref(q, k, v, causal=True),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                        enable_gqa=True)),
        bound_ms=nb, bound_by=fl,
        shape=f"jamba-1.5-large: B=1 Sq=Sk={Sq} causal H={H} K={K} hd={hd}")
    past, C, H, K, hd, ps = 448, 64, 48, 8, 128, 16
    q, kp, vp, bt, _ = _prefill_case(rng, C, H, K, hd, ps, past, dt, dev)
    ctx = past + C
    n_ctx = -(-ctx // ps)
    pairs = sum(past + c + 1 for c in range(C))
    qc = q.transpose(0, 1)[None].contiguous()
    cmask = (torch.arange(ctx, device=dev)[None, :]
             <= past + torch.arange(C, device=dev)[:, None])

    def dense(pool):
        return R.gather_pages(pool, bt[None, :n_ctx])[:, :ctx].transpose(1, 2).contiguous()

    kc, vc = dense(kp), dense(vp)
    errs["paged_prefill_attention"] = max(errs["paged_prefill_attention"], _err(
        paged_prefill_attention(q, kp, vp, bt, past),
        R.paged_prefill_attention_ref(q, kp, vp, bt, past), dt))
    nb, fl = bound(2 * C * H * hd * es + 2 * ctx * K * hd * es + 4 * n_ctx,
                   4 * H * hd * pairs, dt)
    wide["paged_prefill_attention"] = dict(
        **_times(lambda: paged_prefill_attention(q, kp, vp, bt, past),
                 lambda: R.paged_prefill_attention_ref(q, kp, vp, bt, past),
                 lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=cmask,
                                                        enable_gqa=True)),
        bound_ms=nb, bound_by=fl,
        shape=f"internlm2-20b: C={C} past={past} H={H} K={K} hd={hd} ps={ps}")
    kq, vq, ks, vs = _int8_pools(kp, vp)
    k8 = dense(R.dequantize_pages_ref(kq, ks).to(dt))
    v8 = dense(R.dequantize_pages_ref(vq, vs).to(dt))
    errs["paged_prefill_attention_int8"] = max(errs["paged_prefill_attention_int8"], _err(
        paged_prefill_attention_int8(q, kq, vq, bt, past, ks, vs),
        R.paged_prefill_attention_ref(q, kq, vq, bt, past, k_scales=ks, v_scales=vs), dt))
    nb, fl = bound(2 * C * H * hd * es + 2 * ctx * K * hd + 2 * ctx * K * 4 + 4 * n_ctx,
                   4 * H * hd * pairs + 2 * ctx * K * hd, dt)
    wide["paged_prefill_attention_int8"] = dict(
        **_times(lambda: paged_prefill_attention_int8(q, kq, vq, bt, past, ks, vs),
                 lambda: R.paged_prefill_attention_ref(q, kq, vq, bt, past, k_scales=ks,
                                                       v_scales=vs),
                 lambda: F.scaled_dot_product_attention(qc, k8, v8, attn_mask=cmask,
                                                        enable_gqa=True)),
        bound_ms=nb, bound_by=fl,
        shape=f"internlm2-20b: C={C} past={past} H={H} K={K} hd={hd} ps={ps}, int8 pages")
    # the decode kernels: paged at internlm2-20b's widths (B = 8 over
    # 96..800 tokens, pages of 16), slot at Jamba-1.5-Large's (the hybrid
    # phase's attention layer: 4 slots of S_max = 1024)
    lens = rng.integers(96, 801, size=8)
    q, kp, vp, bt, ln, _ = _decode_case(rng, 8, H, K, hd, ps, 64, lens, dt, dev)
    wide["paged_decode_attention"], wide["paged_decode_attention_int8"] = _paged_decode_rows(
        q, kp, vp, bt, ln, lens, errs, dev,
        f"internlm2-20b: B=8 H={H} K={K} hd={hd} ps={ps} tokens={int(lens.sum())}")
    del kp, vp
    B, S, H, K, hd = 4, 1024, 64, 8, 128
    lens = np.array([386, 400, 430, 460], np.int32)
    q, kc, vc = _on(dev, dt, *(rng.normal(size=sh).astype(np.float32)
                               for sh in ((B, H, hd), (B, S, K, hd), (B, S, K, hd))))
    ln = torch.from_numpy(lens).to(dev)
    errs["decode_attention"] = max(errs["decode_attention"], _err(
        decode_attention(q, kc, vc, ln), R.decode_attention_ref(q, kc, vc, ln), dt))
    wide["decode_attention"] = _slot_decode_row(
        q, kc, vc, ln, lens, dev,
        f"jamba-1.5-large: B={B} S_max={S} H={H} K={K} hd={hd} tokens={int(lens.sum())}")
    return wide


#: the MLA / dense models' new widths: (H, K, hd) of paged attention
MLA_DENSE_PAGED = {"llama3-405b": (128, 8, 128), "kimi-k2 / qwen1.5-110b": (64, 8, 128)}
MLA_DENSE_RMSNORM = ((4, 16384), (4, 7168))


def _mla_dense_rows(dev, errs, cases) -> dict:
    """The kernels at the MLA / dense models' widths, each held against
    its plain version in bf16 and f32 and timed in bf16 beside one library
    call and its bound, with inputs from a generator of their own:

    - flash at DeepSeek-V2-Lite's MLA prefill (B = 1, Sq = Sk = 512, H = K =
      16, hd 192 / hd_v 128, causal: the CUDA-core body) beside SDPA;
    - paged decode over fp pages at Llama-3-405B's H = 128 / K = 8 / hd 128
      (g = 16) and Kimi-K2's and Qwen1.5-110B's H = 64 / K = 8 (g = 8), B = 8
      over 96..800 tokens, held with +-99 and NaN in every unreferenced slot;
    - paged prefill at Llama-3-405B's widths (C = 64 at past = 0 and 448),
      poisoned the same way;
    - RMSNorm at 4 x 16384 (Llama-3-405B decode) and 4 x 7168 (Kimi-K2),
      beside ``F.rms_norm``.

    Every bf16 paged prefill call timed here takes the tensor-core body and
    every decode call the split body (but the misaligned ``other_body``
    calls); flash at 192 / 128 takes neither tensor-core body."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_prefill_attention,
    )

    rng = np.random.default_rng(18)
    rows = {}
    launches0, tc0 = ops.launch_counts(), ops.tc_launch_counts()
    split0 = ops.split_launch_counts()
    # flash at MLA's head dims
    Sq, H, hd, hd_v = 512, 16, 192, 128
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _on(dev, dtype, *(rng.normal(size=sh).astype(np.float32) for sh in
                                    ((1, Sq, H, hd), (1, Sq, H, hd), (1, Sq, H, hd_v))))
        errs["flash_attention"] = max(errs["flash_attention"], _err(
            flash_attention(q, k, v, causal=True), R.attention_ref(q, k, v, causal=True),
            dtype))
        cases.append(("flash", "deepseek-v2-lite MLA", str(dtype), Sq, True))
    es, dt = 2, torch.bfloat16
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = Sq * (Sq + 1) // 2
    nb, fl = bound(es * (2 * Sq * H * hd + Sq * H * hd_v + Sq * H * hd_v),
                   2 * H * (hd + hd_v) * pairs, dt)
    rows["flash_attention mla"] = dict(
        **_times(lambda: flash_attention(q, k, v, causal=True),
                 lambda: R.attention_ref(q, k, v, causal=True),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                        scale=hd ** -0.5)),
        bound_ms=nb, bound_by=fl,
        shape=f"deepseek-v2-lite MLA: B=1 Sq=Sk={Sq} causal H=K={H} hd={hd} hd_v={hd_v}")
    flash_tc = ops.tc_launch_counts()["flash_attention"] - tc0["flash_attention"]
    check(flash_tc == 0, f"flash at 192 / 128 took the tensor-core body {flash_tc} times")
    ps, npp = 16, 64
    other = 0
    for label, (H, K, hd) in MLA_DENSE_PAGED.items():
        for dtype in (torch.bfloat16, torch.float32):
            lens = np.concatenate([[1024, 1, ps, ps + 1], rng.integers(1, 1025, size=4)])
            q, kp, vp, bt, ln, garbage = _decode_case(rng, 8, H, K, hd, ps, npp, lens,
                                                      dtype, dev)
            k99, v99 = _poisoned(kp, vp, garbage, 99.0)
            errs["paged_decode_attention"] = max(errs["paged_decode_attention"], _err(
                paged_decode_attention(q, k99, v99, bt, ln),
                R.paged_decode_attention_ref(q, k99, v99, bt, ln), dtype))
            knan, vnan = _poisoned(kp, vp, garbage, float("nan"))
            check(torch.equal(paged_decode_attention(q, kp, vp, bt, ln),
                              paged_decode_attention(q, knan, vnan, bt, ln)),
                  f"decode output changed under NaN garbage ({label}, {dtype})")
            cases.append(("decode", label, str(dtype), 8))
        lens = rng.integers(96, 801, size=8)
        q, kp, vp, bt, ln, _ = _decode_case(rng, 8, H, K, hd, ps, npp, lens, dt, dev)
        row, _ = _paged_decode_rows(
            q, kp, vp, bt, ln, lens, errs, dev,
            f"{label}: B=8 H={H} K={K} hd={hd} ps={ps} tokens={int(lens.sum())}", int8=False)
        other += row["other_body_calls"]
        rows[f"paged_decode_attention {label}"] = row
        del kp, vp
    H, K, hd = MLA_DENSE_PAGED["llama3-405b"]
    f32_pre = ops.launch_counts()["paged_prefill_attention"]
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            f32_pre = ops.launch_counts()["paged_prefill_attention"] - f32_pre
        for past in (0, 448):
            q, kp, vp, bt, garbage = _prefill_case(rng, 64, H, K, hd, ps, past, dtype, dev)
            k77, v77 = _poisoned(kp, vp, garbage, 77.0)
            errs["paged_prefill_attention"] = max(errs["paged_prefill_attention"], _err(
                paged_prefill_attention(q, k77, v77, bt, past),
                R.paged_prefill_attention_ref(q, k77, v77, bt, past), dtype))
            knan, vnan = _poisoned(kp, vp, garbage, float("nan"))
            check(torch.equal(paged_prefill_attention(q, kp, vp, bt, past),
                              paged_prefill_attention(q, knan, vnan, bt, past)),
                  f"prefill output changed under NaN garbage (llama3-405b, {dtype})")
            cases.append(("prefill", "llama3-405b", str(dtype), past))
    past, C = 448, 64
    q, kp, vp, bt, _ = _prefill_case(rng, C, H, K, hd, ps, past, dt, dev)
    ctx = past + C
    n_ctx = -(-ctx // ps)
    pairs = sum(past + c + 1 for c in range(C))
    qc = q.transpose(0, 1)[None].contiguous()
    cmask = (torch.arange(ctx, device=dev)[None, :]
             <= past + torch.arange(C, device=dev)[:, None])
    kc, vc = (R.gather_pages(pool, bt[None, :n_ctx])[:, :ctx].transpose(1, 2).contiguous()
              for pool in (kp, vp))
    nb, fl = bound(2 * C * H * hd * es + 2 * ctx * K * hd * es + 4 * n_ctx,
                   4 * H * hd * pairs, dt)
    rows["paged_prefill_attention llama3-405b"] = dict(
        **_times(lambda: paged_prefill_attention(q, kp, vp, bt, past),
                 lambda: R.paged_prefill_attention_ref(q, kp, vp, bt, past),
                 lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=cmask,
                                                        enable_gqa=True)),
        bound_ms=nb, bound_by=fl,
        shape=f"llama3-405b: C={C} past={past} H={H} K={K} hd={hd} ps={ps}")
    for r, d in MLA_DENSE_RMSNORM:
        _check_rmsnorm(rng, dev, errs, cases, d, (1, r, 64))
        rows[f"rmsnorm {r}x{d}"] = _rmsnorm_row(dev, r, d)
    # the bf16 paged prefill calls took the tensor-core body; every paged
    # decode call the split body, but those sent off 16 bytes on purpose
    launches, tcs = ops.launch_counts(), ops.tc_launch_counts()
    splits = ops.split_launch_counts()
    n_pre = launches["paged_prefill_attention"] - launches0["paged_prefill_attention"]
    tc_pre = tcs["paged_prefill_attention"] - tc0["paged_prefill_attention"]
    n_dec = launches["paged_decode_attention"] - launches0["paged_decode_attention"]
    split_dec = splits["paged_decode_attention"] - split0["paged_decode_attention"]
    check(tc_pre == n_pre - f32_pre > 0,
          f"a bf16 paged prefill call missed the tensor-core body: {tc_pre} of {n_pre}")
    check(split_dec == n_dec - other > 0,
          f"a paged decode call missed the split body: {split_dec} of {n_dec} ({other} sent "
          f"to the other body)")
    rows["launched"] = {"paged_prefill_attention": n_pre, "tc": tc_pre,
                        "paged_decode_attention": n_dec, "split": split_dec,
                        "other_body": other, "flash_tc": flash_tc}
    return rows


# (label, B, Sq, Sk, H, K, hd): flash, bidirectional, at the encoder
# families' shapes (1500 = 23 * 64 + 28 and 1601 = 25 * 64 + 1 frames /
# patches: ragged tails)
ENCDEC_FLASH = (("whisper-tiny encoder", 1, 1500, 1500, 6, 6, 64),
                ("whisper-tiny cross decode", 4, 1, 1500, 6, 6, 64),
                ("vision-90b cross decode", 4, 1, 1601, 64, 8, 128),
                ("vision-90b cross prefill", 1, 256, 1601, 64, 8, 128))
ENCDEC_RMSNORM = ((4, 1024), (4, 384))


def _encdec_rows(dev, errs, cases) -> dict:
    """The kernels at the xLSTM, VLM and Whisper paths' shapes, each held
    against its plain version in bf16 and f32 and timed in bf16 beside one
    library call and its bound, inputs from a generator of their own:

    - flash, bidirectional (:data:`ENCDEC_FLASH`), k and v the first Sk
      rows of buffers whose rows past Sk hold NaN once the plain check is
      done (the output must not move by a bit), beside SDPA;
    - slot decode at Whisper's widths (H = K = 6, hd 64, g = 1), B = 4,
      S_max = 256, tails NaN, beside SDPA with a length mask;
    - RMSNorm at 4 x 1024 (xLSTM decode) and 4 x 384 (Whisper), beside
      ``F.rms_norm``.

    Every bf16 flash call here takes the tensor-core body and every decode
    call the split body (but the misaligned ``other_body`` calls)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(23)
    rows = {}
    launches0, tc0 = ops.launch_counts(), ops.tc_launch_counts()
    split0 = ops.split_launch_counts()
    es, dt = 2, torch.bfloat16
    f32_flash = 0

    def flash_row(label, q, k, v, B, Sq, Sk, H, K, hd):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        nb, fl = bound(es * (2 * B * Sq * H * hd + 2 * B * Sk * K * hd),
                       4 * B * H * hd * Sq * Sk, dt)
        return dict(**_times(lambda: flash_attention(q, k, v, causal=False),
                             lambda: R.attention_ref(q, k, v, causal=False),
                             lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                    enable_gqa=H > K)),
                    bound_ms=nb, bound_by=fl,
                    shape=f"{label}: B={B} Sq={Sq} Sk={Sk} bidirectional H={H} K={K} "
                          f"hd={hd}")

    for label, B, Sq, Sk, H, K, hd in ENCDEC_FLASH:
        for dtype in (torch.float32, torch.bfloat16):
            q, kb, vb = _on(dev, dtype, *(rng.normal(size=sh).astype(np.float32) for sh in
                                          ((B, Sq, H, hd), (B, Sk + 29, K, hd),
                                           (B, Sk + 29, K, hd))))
            k, v = kb[:, :Sk], vb[:, :Sk]
            got = flash_attention(q, k, v, causal=False)
            errs["flash_attention"] = max(errs["flash_attention"], _err(
                got, R.attention_ref(q, k, v, causal=False), dtype))
            kb[:, Sk:], vb[:, Sk:] = float("nan"), float("nan")
            check(torch.equal(flash_attention(q, k, v, causal=False), got),
                  f"flash output changed under NaN past Sk ({label}, {dtype})")
            cases.append(("flash", label, str(dtype), Sq, Sk))
            f32_flash += 2 * (dtype == torch.float32)
        rows[f"flash_attention {label}"] = flash_row(label, q, k, v, B, Sq, Sk, H, K, hd)
    # slot decode at Whisper's widths
    B, S, H, hd = 4, 256, 6, 64
    lens = np.array([1, 17, 100, 256], np.int32)
    tail = torch.from_numpy(np.arange(S)[None, :] >= lens[:, None]).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        q, kc, vc = _on(dev, dtype, *(rng.normal(size=sh).astype(np.float32)
                                      for sh in ((B, H, hd), (B, S, H, hd), (B, S, H, hd))))
        got = decode_attention(q, kc, vc, ln)
        errs["decode_attention"] = max(errs["decode_attention"], _err(
            got, R.decode_attention_ref(q, kc, vc, ln), dtype))
        kc[tail], vc[tail] = float("nan"), float("nan")
        check(torch.equal(decode_attention(q, kc, vc, ln), got),
              f"slot decode output changed under NaN tails (whisper-tiny, {dtype})")
        cases.append(("slot decode", "whisper-tiny", str(dtype), B))
    lens = np.array([50, 70, 90, 96], np.int32)
    q, kc, vc = _on(dev, dt, *(rng.normal(size=sh).astype(np.float32)
                               for sh in ((B, H, hd), (B, S, H, hd), (B, S, H, hd))))
    ln = torch.from_numpy(lens).to(dev)
    row = _slot_decode_row(q, kc, vc, ln, lens, dev, f"whisper-tiny: B={B} S_max={S} "
                           f"H=K={H} hd={hd} tokens={int(lens.sum())}")
    rows["decode_attention whisper-tiny"] = row
    for r, d in ENCDEC_RMSNORM:
        _check_rmsnorm(rng, dev, errs, cases, d, (1, r, 64))
        rows[f"rmsnorm {r}x{d}"] = _rmsnorm_row(dev, r, d)
    launches, tcs = ops.launch_counts(), ops.tc_launch_counts()
    splits = ops.split_launch_counts()
    n_fa = launches["flash_attention"] - launches0["flash_attention"]
    tc_fa = tcs["flash_attention"] - tc0["flash_attention"]
    n_dec = launches["decode_attention"] - launches0["decode_attention"]
    split_dec = splits["decode_attention"] - split0["decode_attention"]
    check(tc_fa == n_fa - f32_flash > 0,
          f"a bf16 flash call missed the tensor-core body: {tc_fa} of {n_fa}")
    check(split_dec == n_dec - row["other_body_calls"] > 0,
          f"a slot decode call missed the split body: {split_dec} of {n_dec}")
    rows["launched"] = {"flash_attention": n_fa, "tc": tc_fa, "decode_attention": n_dec,
                        "split": split_dec, "other_body": row["other_body_calls"]}
    return rows


def _tc_scaling(dev) -> dict:
    """What sets the tensor-core bodies' times, bf16, device time by the
    profiler: flash over one kv head (H = K = 1, hd = 64, causal), where
    the longest row block's lone CTA walks Sq / 64 key tiles, so the slope
    over Sq is the time of one key tile; and paged prefill at the timed
    chunk (C = 64 at past = 448) with 1, 2, 4 and 8 context splits against
    the splits ``prefill_splits`` picks, at stablelm-1.6b's and
    internlm2-20b's widths."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(14)
    dt = torch.bfloat16
    lone = {}
    for Sq in (64, 128, 256, 512, 1024):
        q, k, v = _on(dev, dt, *(rng.normal(size=(1, Sq, 1, 64)).astype(np.float32)
                                 for _ in range(3)))
        lone[Sq] = device_ms(lambda: flash_attention(q, k, v, causal=True))["device_ms"]
    splits = {}
    pick = PA.prefill_splits
    for label, (H, K, hd) in {"stablelm-1.6b": (32, 32, 64),
                              "internlm2-20b": (48, 8, 128)}.items():
        q, kp, vp, bt, _ = _prefill_case(rng, 64, H, K, hd, 16, 448, dt, dev)
        row = {"picked": pick(K, 64 * (H // K), 8, torch.cuda.get_device_properties(
            dev).multi_processor_count)}
        try:
            for n in (1, 2, 4, 8):
                PA.prefill_splits = lambda *a, n=n: n
                row[n] = device_ms(lambda: PA.paged_prefill_attention(q, kp, vp, bt, 448))[
                    "device_ms"]
        finally:
            PA.prefill_splits = pick
        splits[label] = row
    return {"flash_lone_cta_device_ms": lone,
            "flash_ms_per_key_tile": (lone[1024] - lone[64]) / 15,
            "paged_prefill_splits_device_ms": splits}


def _decode_split_sweep(dev) -> dict:
    """Device time (profiler) of the split decode body at 1, 2, 4 and 8
    context splits against the count ``decode_splits`` picks, bf16, at the
    timed shapes: slot decode at stablelm-1.6b's and Jamba-1.5-Large's
    widths (B = 4, lengths 386..460), paged decode over bf16 and int8 pages
    at stablelm-1.6b's and over bf16 pages at internlm2-20b's (B = 8 over
    96..800 tokens); each also at length 0, the launch's fixed cost."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_attention as PA

    rng = np.random.default_rng(16)
    dt = torch.bfloat16
    cases = {}
    for label, (H, K, hd) in {"slot stablelm-1.6b": (32, 32, 64),
                              "slot jamba-1.5-large": (64, 8, 128)}.items():
        q, kc, vc = _on(dev, dt, *(rng.normal(size=sh).astype(np.float32)
                                   for sh in ((4, H, hd), (4, 1024, K, hd), (4, 1024, K, hd))))
        ln = torch.tensor([386, 400, 430, 460], dtype=torch.int32, device=dev)
        cases[label] = (lambda l, q=q, kc=kc, vc=vc: DA.decode_attention(q, kc, vc, l), ln,
                        _build.decode_launch(4, H, K, 1024, dt, q.device.index)[1])
    for label, (H, K, hd, q8) in {"paged stablelm-1.6b": (32, 32, 64, False),
                                  "paged stablelm-1.6b int8": (32, 32, 64, True),
                                  "paged internlm2-20b": (48, 8, 128, False)}.items():
        lens = rng.integers(96, 801, size=8)
        q, kp, vp, bt, ln, _ = _decode_case(rng, 8, H, K, hd, 16, 64, lens, dt, dev)
        if q8:
            kq, vq, ks, vs = _int8_pools(kp, vp)
            fn = (lambda l, q=q, kq=kq, vq=vq, bt=bt, ks=ks, vs=vs:
                  PA.paged_decode_attention_int8(q, kq, vq, bt, l, ks, vs))
        else:
            fn = lambda l, q=q, kp=kp, vp=vp, bt=bt: PA.paged_decode_attention(q, kp, vp, bt, l)
        cases[label] = (fn, ln, _build.decode_launch(8, H, K, 1024, dt, q.device.index)[1])
    pick = _build.decode_splits
    out = {}
    try:
        for label, (fn, ln, picked) in cases.items():
            row = {"picked": picked}
            for n in (1, 2, 4, 8):
                _build.decode_splits = lambda *a, n=n: n
                row[n] = device_ms(lambda: fn(ln))["device_ms"]
                if n == picked:
                    zero = torch.zeros_like(ln)
                    row["length 0"] = device_ms(lambda: fn(zero))["device_ms"]
            out[label] = row
    finally:
        _build.decode_splits = pick
    return out


#: the main path's other RMSNorm shapes (rows, d): a paged decode step at
#: b = 8, a slot admission's 386-token prompt, Jamba's decode at b = 4 and a
#: 512-token Jamba prefill (the summary's row is a 64-token prefill chunk)
RMSNORM_SHAPES = ((8, 2048), (386, 2048), (4, 8192), (512, 8192))


def _rmsnorm_row(dev, rows: int, d: int) -> dict:
    """RMSNorm's timing row at ``rows`` x ``d`` bf16 (gamma of ones, x drawn
    from a seeded device generator): ``_times`` with ``F.rms_norm`` as the
    library call, the bytes bound (x read and out written once, gamma once)
    and the warps a row the wrapper takes (where the tree has the rule)."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rmsnorm import rmsnorm

    dt, es = torch.bfloat16, 2
    x = torch.randn(rows, d, device=dev, dtype=dt,
                    generator=torch.Generator(device=dev).manual_seed(3))
    g = torch.ones(d, device=dev, dtype=dt)
    nb, fl = bound(2 * rows * d * es + d * es, 4 * rows * d, dt)
    rule = getattr(_build, "rmsnorm_warps", None)
    return dict(**_times(lambda: rmsnorm(x, g), lambda: R.rmsnorm_ref(x, g),
                         lambda: F.rms_norm(x, (d,), g, 1e-5)),
                bound_ms=nb, bound_by=fl, shape=f"rows={rows} d={d}",
                warps=rule(d, dt) if rule else None)


def phase_timing(dev, emit_line: bool = True) -> dict:
    """The two kernels this tree's RMSNorm and selective scan are timed at,
    through their wrappers alone (so a tree from before their launch rules
    runs it too, for a same-call A/B): RMSNorm at ``RMSNORM_SHAPES``, the
    Jamba-1.5-Large scan at a 512-token prefill (the summary's row), a
    17-token one and a decode step at B = 4 over carried states."""
    srng = np.random.default_rng(10)
    out = {"timing_rmsnorm": {f"{r}x{d}": _rmsnorm_row(dev, r, d) for r, d in RMSNORM_SHAPES},
           "ssm_scan": _ssm_timing(dev, srng, 1, 512, 16384, 16, with_h0=False),
           "timing_ssm_scan": {
               "prefill T=17": _ssm_timing(dev, srng, 1, 17, 16384, 16, with_h0=False),
               "decode B=4": _ssm_timing(dev, srng, 4, 1, 16384, 16, with_h0=True)}}
    if emit_line:
        emit("timing", rmsnorm_64x2048=_rmsnorm_row(dev, 64, 2048), **out)
    return out


def phase_scan_bwd(dev) -> dict:
    """The scan's backward alone, through the wrappers (so that a tree from
    before its redesign runs it too, for a same-call A/B): its checks
    (``SCAN_BWD_CASES``), row 6b at Jamba's training shape, and the
    forward's row 6p (T = 512), whose checkpoints the backward reads."""
    errs, cases = {"ssm_scan_bwd": 0.0}, []
    _check_scan_backward(dev, errs, cases)
    out = {"max_abs_err": errs["ssm_scan_bwd"], "cases": len(cases),
           "ssm_scan_bwd": _scan_bwd_row(dev),
           "ssm_scan": _ssm_timing(dev, np.random.default_rng(10), 1, 512, 16384, 16,
                                   with_h0=False)}
    emit("scan_bwd", **out)
    return out


def _rmsnorm_sweep(dev) -> dict:
    """Device time (profiler) of RMSNorm, bf16, at each timed shape and at
    8192 x 2048 (past any prefill of the main path) with the warps a row
    ``_build.rmsnorm_warps`` picks and with twice as many."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm

    pick = _build.rmsnorm_warps
    out = {}
    try:
        for rows, d in ((64, 2048),) + RMSNORM_SHAPES + ((8192, 2048),):
            x = torch.randn(rows, d, device=dev, dtype=torch.bfloat16,
                            generator=torch.Generator(device=dev).manual_seed(3))
            g = torch.ones(d, device=dev, dtype=torch.bfloat16)
            w0 = pick(d, torch.bfloat16)
            row = {"picked": w0}
            for w in (w0, 2 * w0):
                _build.rmsnorm_warps = lambda *a, w=w: w
                row[f"warps={w}"] = device_ms(lambda: rmsnorm(x, g))["device_ms"]
            out[f"{rows}x{d}"] = row
    finally:
        _build.rmsnorm_warps = pick
    return out


def phase_kernels(dev, backward_ptxas=None) -> dict:
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_prefill_attention,
    )
    from repro_torch.kernels.paged_attention import paged_prefill_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(0)
    widths = {"stablelm-1.6b": (32, 32, 64), "internlm2-20b GQA": (48, 8, 128)}
    errs = {k: 0.0 for k in KERNEL_META}
    cases = []
    ps, npp = 16, 64
    for label, (H, K, hd) in widths.items():
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 8):
                lens = np.concatenate([[1024, 1, ps, ps + 1],
                                       rng.integers(1, 1025, size=4)])[:B]
                q, kp, vp, bt, ln, garbage = _decode_case(
                    rng, B, H, K, hd, ps, npp, lens, dtype, dev)
                # finite garbage (as tests/test_paged_kernels.py) vs the plain version
                k99, v99 = _poisoned(kp, vp, garbage, 99.0)
                got = paged_decode_attention(q, k99, v99, bt, ln)
                want = R.paged_decode_attention_ref(q, k99, v99, bt, ln)
                errs["paged_decode_attention"] = max(
                    errs["paged_decode_attention"], _err(got, want, dtype))
                # NaN garbage: the kernel's output equals its output on clean pages
                knan, vnan = _poisoned(kp, vp, garbage, float("nan"))
                check(torch.equal(paged_decode_attention(q, kp, vp, bt, ln),
                                  paged_decode_attention(q, knan, vnan, bt, ln)),
                      f"decode output changed under NaN garbage ({label}, {dtype})")
                cases.append(("decode", label, str(dtype), B))
            for past in (0, 64, 448, 960):
                C = 64
                q, kp, vp, bt, garbage = _prefill_case(
                    rng, C, H, K, hd, ps, past, dtype, dev)
                k77, v77 = _poisoned(kp, vp, garbage, 77.0)
                got = paged_prefill_attention(q, k77, v77, bt, past)
                want = R.paged_prefill_attention_ref(q, k77, v77, bt, past)
                errs["paged_prefill_attention"] = max(
                    errs["paged_prefill_attention"], _err(got, want, dtype))
                knan, vnan = _poisoned(kp, vp, garbage, float("nan"))
                check(torch.equal(paged_prefill_attention(q, kp, vp, bt, past),
                                  paged_prefill_attention(q, knan, vnan, bt, past)),
                      f"prefill output changed under NaN garbage ({label}, {dtype})")
                cases.append(("prefill", label, str(dtype), past))
    _check_rmsnorm(rng, dev, errs, cases, 2048, (1, 8, 64))
    # the timing inputs draw from the generator as it stands here, so the
    # timed shapes stay those of the first slice (3160 decode tokens)
    timing_rng = copy.deepcopy(rng)
    _check_rmsnorm(rng, dev, errs, cases, 8192, (1, 4, 512))
    _check_rmsnorm_edges(dev, errs, cases)
    _check_slot_kernels(rng, dev, errs, cases)
    _check_int8_kernels(dev, errs, cases)
    _check_decode_edges(dev, errs, cases)
    _check_ssm_scan(dev, errs, cases)
    bwd = _check_backward_kernels(dev, errs, cases)
    _check_mla_backward(dev, errs, cases)
    _check_scan_backward(dev, errs, cases)
    torch.cuda.synchronize()
    rng = timing_rng

    # times at the main path's shapes, bf16: decode B = 8 over 96..800
    # tokens, a prefill chunk C = 64 at past = 448, RMSNorm of a chunk
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    dt = torch.bfloat16
    es = 2
    H, K, hd = widths["stablelm-1.6b"]
    timing = {}
    launches0, tc0 = ops.launch_counts(), ops.tc_launch_counts()
    split0 = ops.split_launch_counts()
    lens = rng.integers(96, 801, size=8)
    q, kp, vp, bt, ln, _ = _decode_case(rng, 8, H, K, hd, ps, npp, lens, dt, dev)
    timing["paged_decode_attention"], timing["paged_decode_attention_int8"] = \
        _paged_decode_rows(q, kp, vp, bt, ln, lens, errs, dev,
                           f"B=8 H=K={H} hd={hd} ps={ps} tokens={int(lens.sum())}")
    past, C = 448, 64
    q, kp, vp, bt, _ = _prefill_case(rng, C, H, K, hd, ps, past, dt, dev)
    ctx = past + C
    n_ctx = -(-ctx // ps)
    kc = R.gather_pages(kp, bt[None, :n_ctx])[:, :ctx].transpose(1, 2).contiguous()
    vc = R.gather_pages(vp, bt[None, :n_ctx])[:, :ctx].transpose(1, 2).contiguous()
    cmask = (torch.arange(ctx, device=dev)[None, :]
             <= past + torch.arange(C, device=dev)[:, None])
    qc = q.transpose(0, 1)[None].contiguous()
    pairs = sum(past + c + 1 for c in range(C))
    nb, fl = bound(2 * C * H * hd * es + 2 * ctx * K * hd * es + 4 * n_ctx,
                   4 * H * hd * pairs, dt)
    timing["paged_prefill_attention"] = dict(
        **_times(lambda: paged_prefill_attention(q, kp, vp, bt, past),
                 lambda: R.paged_prefill_attention_ref(q, kp, vp, bt, past),
                 lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=cmask)),
        bound_ms=nb, bound_by=fl, shape=f"C={C} past={past} H=K={H} hd={hd} ps={ps}")
    kq, vq, ks, vs = _int8_pools(kp, vp)
    errs["paged_prefill_attention_int8"] = max(
        errs["paged_prefill_attention_int8"],
        _err(paged_prefill_attention_int8(q, kq, vq, bt, past, ks, vs),
             R.paged_prefill_attention_ref(q, kq, vq, bt, past, k_scales=ks, v_scales=vs),
             dt))
    k8 = R.gather_pages(R.dequantize_pages_ref(kq, ks).to(dt), bt[None, :n_ctx])
    v8 = R.gather_pages(R.dequantize_pages_ref(vq, vs).to(dt), bt[None, :n_ctx])
    k8 = k8[:, :ctx].transpose(1, 2).contiguous()
    v8 = v8[:, :ctx].transpose(1, 2).contiguous()
    nb, fl = bound(2 * C * H * hd * es + 2 * ctx * K * hd + 2 * ctx * K * 4 + 4 * n_ctx,
                   4 * H * hd * pairs + 2 * ctx * K * hd, dt)
    timing["paged_prefill_attention_int8"] = dict(
        **_times(lambda: paged_prefill_attention_int8(q, kq, vq, bt, past, ks, vs),
                 lambda: R.paged_prefill_attention_ref(
            q, kq, vq, bt, past, k_scales=ks, v_scales=vs),
                 lambda: F.scaled_dot_product_attention(
            qc, k8, v8, attn_mask=cmask)),
        bound_ms=nb, bound_by=fl,
        shape=f"C={C} past={past} H=K={H} hd={hd} ps={ps}, int8 pages, bf16 q")
    del kq, vq, ks, vs, k8, v8
    timing["rmsnorm"] = _rmsnorm_row(dev, 64, 2048)
    # the testbed's slot decode: b = 4 slots of S_max = 1024 holding a
    # ~386-token prompt plus what they decoded
    B, S = 4, 1024
    lens = np.array([386, 400, 430, 460], np.int32)
    q, kc, vc = _on(dev, dt, *(rng.normal(size=sh).astype(np.float32)
                               for sh in ((B, H, hd), (B, S, K, hd), (B, S, K, hd))))
    ln = torch.from_numpy(lens).to(dev)
    timing["decode_attention"] = _slot_decode_row(
        q, kc, vc, ln, lens, dev, f"B={B} S_max={S} H=K={H} hd={hd} tokens={int(lens.sum())}")
    # one admission's prefill: a 386-token prompt, causal
    Sq = 386
    q, k, v = _on(dev, dt, *(rng.normal(size=sh).astype(np.float32)
                             for sh in ((1, Sq, H, hd), (1, Sq, K, hd), (1, Sq, K, hd))))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = Sq * (Sq + 1) // 2
    nb, fl = bound(2 * Sq * H * hd * es + 2 * Sq * K * hd * es, 4 * H * hd * pairs, dt)
    timing["flash_attention"] = dict(
        **_times(lambda: flash_attention(q, k, v, causal=True),
                 lambda: R.attention_ref(q, k, v, causal=True),
                 lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound_ms=nb, bound_by=fl, shape=f"B=1 Sq=Sk={Sq} causal H=K={H} hd={hd}")
    wide = _wide_timing(dev, errs)
    scaling = _tc_scaling(dev)
    split_sweep = _decode_split_sweep(dev)
    timing.update(_backward_rows(dev))
    backward_wide = _backward_wide(dev)
    # every bf16 call timed above took the tensor-core body (the flash
    # backward's too)
    launches, tcs = ops.launch_counts(), ops.tc_launch_counts()
    timed_tc = {k: {"launches": launches[k] - launches0[k], "tc_launches": tcs[k] - tc0[k]}
                for k in ops.TC_KERNELS}
    check(all(v["launches"] == v["tc_launches"] > 0 for v in timed_tc.values()),
          f"a timed bf16 call missed the tensor-core body: {timed_tc}")
    # ... and every decode call timed above the split-context body, but the
    # ones ``other_body_host_ms`` sent to the other body
    splits = ops.split_launch_counts()
    timed_split = {k: {"launches": launches[k] - launches0[k],
                       "split_launches": splits[k] - split0[k],
                       "other_body": timing[k]["other_body_calls"] + wide[k]["other_body_calls"]}
                   for k in ops.SPLIT_KERNELS}
    check(all(v["launches"] - v["other_body"] == v["split_launches"] > 0
              for v in timed_split.values()),
          f"a timed decode call missed the split body: {timed_split}")
    mla_dense = _mla_dense_rows(dev, errs, cases)
    encdec = _encdec_rows(dev, errs, cases)
    # the new training kernels' rows (6b; 5b at MLA's head dims, CUDA-core
    # body, after the tensor-core check above)
    timing["ssm_scan_bwd"] = _scan_bwd_row(dev)
    backward_mla = {"flash_attention_bwd deepseek-v2-lite": _mla_backward_row(dev, errs, cases)}
    norm_scan = phase_timing(dev, emit_line=False)
    timing["ssm_scan"] = norm_scan.pop("ssm_scan")
    sweeps = {"rmsnorm_sweep": _rmsnorm_sweep(dev)}
    out = {"max_abs_err": errs, "tol": {str(k): v for k, v in TOL.items()},
           "ssm_tol": {str(k): v for k, v in SSM_TOL.items()}, **norm_scan, **sweeps,
           **bwd, "cases": len(cases), "nan_invariant": True, "timing_bf16": timing,
           "backward_ptxas": backward_ptxas, **backward_wide,
           "timing_bf16_backward_mla": backward_mla,
           "timing_bf16_wide": wide, "timing_bf16_mla_dense": mla_dense,
           "timing_bf16_encdec": encdec,
           "timed_tc": timed_tc, "timed_split": timed_split,
           "tc_scaling": scaling, "decode_split_sweep": split_sweep,
           "peaks": "H100 SXM data sheet: 3.35 TB/s HBM, 989 TFLOP/s bf16 dense"}
    emit("kernels", **out)
    return out


# ---------------------------------------------------------------------------
# phase: held (card vs CPU, float32)
# ---------------------------------------------------------------------------
def _int8_gap(caches) -> dict:
    """Card against CPU int8 caches: how many int8 entries differ, by how
    many steps at most, and the largest relative scale difference."""
    a, b = caches["cuda"], caches["cpu"]
    diff, n, rel = 0, 0, 0.0
    for j, blk in a.items():
        for name, t in blk.items():
            u = b[j][name]
            if t.dtype == torch.int8:
                d = (t.int() - u.int()).abs()
                n += int((d > 0).sum())
                diff = max(diff, int(d.max()))
            else:
                rel = max(rel, float(((t - u).abs() / u.abs().clamp(min=1e-30)).max()))
    return {"int8_entries_differing": n, "int8_max_step_diff": diff,
            "scale_max_rel_diff": rel}


def _held_verdict(name, res, outs, n_reqs, q8) -> None:
    """Equal tokens; through int8 caches, if the tokens part, the card-CPU
    logit gap must stay under the CPU's int8-against-fp gap (both printed
    either way, the check never dropped)."""
    check(len(outs["cuda"]) == len(outs["cpu"]) == n_reqs, f"{name}: requests missing")
    if outs["cuda"] == outs["cpu"]:
        return
    check(q8, f"{name}: card and CPU engines disagree")
    check(res["max_logit_gap"] < res["int8_vs_fp_gap_cpu"],
          f"{name}: tokens differ and the card-CPU logit gap {res['max_logit_gap']} is "
          f"not under int8's own {res['int8_vs_fp_gap_cpu']}")


def phase_held(dev, cfg) -> dict:
    """The paged engine on the card and on the CPU, with fp and int8 pages:
    equal greedy tokens."""
    from repro_torch.bridge import params_to
    from repro_torch.models import init_params
    from repro_torch.models.paged import init_paged_pools, paged_prefill_chunk
    from repro_torch.serving import PagedLLMEngine, Request

    cpu_params = init_params(cfg, seed=1, device="cpu")
    gpu_params = params_to(cpu_params, dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (40, 97, 150, 200)]
    out_all, cpu_logits = {}, {}
    for kv_dtype in ("fp32", "int8"):
        # first prefill chunk of the first prompt, straight through the model
        logits, pools = {}, {}
        for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
            pools[name] = init_paged_pools(cfg, 8, 16, kv_dtype=kv_dtype, device=d)
            toks = torch.tensor([prompts[0][:40]], dtype=torch.int32, device=d)
            bt = torch.arange(1, 5, dtype=torch.int32, device=d)
            lg, _ = paged_prefill_chunk(params, cfg, pools[name], toks, bt, 0)
            logits[name] = lg.float().cpu()
        gap = float((logits["cuda"] - logits["cpu"]).abs().max())
        cpu_logits[kv_dtype] = logits["cpu"]

        outs, secs = {}, {}
        for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
            eng = PagedLLMEngine(cfg, max_seqs=4, max_len=256, params=params,
                                 kv_dtype=kv_dtype, device=d)
            out = {}
            for i, p in enumerate(prompts):
                check(eng.admit(Request(
                    rid=i, prompt=p, max_new_tokens=16,
                    on_finish=lambda r, out=out: out.__setitem__(r.rid, list(r.out_tokens)))),
                    "held: admission refused")
            t0 = time.perf_counter()
            while eng.batch_size or eng.waiting:
                eng.step()
            secs[name] = time.perf_counter() - t0
            outs[name] = out
        torch.cuda.synchronize()
        res = {"model": "stablelm-1.6b width, 2 layers, float32, TF32 off",
               "kv_dtype": kv_dtype, "tokens_equal": outs["cuda"] == outs["cpu"],
               "n_tokens": sum(len(v) for v in outs["cuda"].values()),
               "max_logit_gap": gap, "logits": "first 40-token chunk", "seconds": secs}
        if kv_dtype == "int8":
            res["int8_vs_fp_gap_cpu"] = float(
                (cpu_logits["int8"] - cpu_logits["fp32"]).abs().max())
            res.update(_int8_gap({n: {j: {k: t.cpu() for k, t in blk.items()}
                                      for j, blk in p["blocks"].items()}
                                  for n, p in pools.items()}))
        emit("held", **res)
        _held_verdict("held", res, outs, len(prompts), kv_dtype == "int8")
        out_all[kv_dtype] = res
    return out_all


def phase_held_slot(dev, cfg) -> dict:
    """The slot engine on the card and on the CPU, with a float and an int8
    slot cache: equal greedy tokens."""
    from repro_torch.bridge import params_to
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import LLMEngine, Request

    cpu_params = init_params(cfg, seed=1, device="cpu")
    gpu_params = params_to(cpu_params, dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (40, 97, 150, 200, 64)]
    out_all, cpu_logits = {}, {}
    for cache_dtype in (cfg.kv_cache_dtype, "int8"):
        ccfg = cfg.with_(kv_cache_dtype=cache_dtype)
        # prefill of the second prompt, then one decode step over its cache
        # (the step an int8 cache first changes)
        logits, caches = {}, {}
        for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
            toks = torch.tensor([prompts[1]], dtype=torch.int32, device=d)
            lg, cache = prefill(params, ccfg, toks, max_len=256)
            lg2, cache = decode_step(params, ccfg, cache,
                                     torch.tensor([prompts[1][0]], device=d))
            logits[name] = torch.cat([lg.float().cpu(), lg2.float().cpu()])
            caches[name] = {j: {k: t.cpu() for k, t in blk.items()}
                            for j, blk in cache["blocks"].items()}
        gap = float((logits["cuda"] - logits["cpu"]).abs().max())
        cpu_logits[cache_dtype] = logits["cpu"]

        outs, secs = {}, {}
        for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
            eng = LLMEngine(ccfg, max_batch=4, max_len=256, params=params, device=d)
            out, pending = {}, list(enumerate(prompts))
            t0 = time.perf_counter()
            while pending or eng.batch_size:
                while pending and eng.can_admit():   # the fifth reuses a freed slot
                    i, p = pending.pop(0)
                    check(eng.admit(Request(
                        rid=i, prompt=p, max_new_tokens=12 + 2 * i,
                        on_finish=lambda r, out=out: out.__setitem__(
                            r.rid, list(r.out_tokens)))),
                        "held_slot: admission refused")
                eng.step()
            secs[name] = time.perf_counter() - t0
            outs[name] = out
        torch.cuda.synchronize()
        res = {"model": "stablelm-1.6b width, 2 layers, float32, TF32 off, slot engine",
               "kv_cache_dtype": cache_dtype, "tokens_equal": outs["cuda"] == outs["cpu"],
               "n_tokens": sum(len(v) for v in outs["cuda"].values()),
               "max_logit_gap": gap, "logits": "97-token prefill and one decode step",
               "seconds": secs}
        if cache_dtype == "int8":
            res["int8_vs_fp_gap_cpu"] = float(
                (cpu_logits["int8"] - cpu_logits[cfg.kv_cache_dtype]).abs().max())
            res.update(_int8_gap(caches))
        emit("held_slot", **res)
        _held_verdict("held_slot", res, outs, len(prompts), cache_dtype == "int8")
        out_all[cache_dtype] = res
    return out_all


# ---------------------------------------------------------------------------
# phase: engine (the main path at full width)
# ---------------------------------------------------------------------------
def _serve(eng, reqs) -> dict:
    """Drive admit/step until every request finished; per-step timing.

    Each step ends in ``torch.cuda.synchronize()``.  ``prefill_tok_s`` is
    the prompt tokens run over the time of the steps that ran a prefill
    chunk (they may also decode); ``decode_tok_s`` the tokens decoded
    over the time of the steps that only decoded."""
    from repro_torch.kernels import ops

    pending = deque(reqs)
    finished = []
    step_ms, pre_tok, pre_s, dec_tok, dec_s = [], 0, 0.0, 0, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    while pending or eng.batch_size or eng.waiting:
        while pending and eng.can_admit() and eng.admit(pending[0]):
            pending.popleft()
        chunks0, prefill0 = eng.prefill_chunks, sum(r.prefill_tokens for r in reqs)
        steps0 = eng.decode_steps
        t0 = time.perf_counter()
        done = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        finished.extend(done)
        decoded = len(eng.active) + len(done)   # rows the decode ran on
        step_ms.append(dt * 1e3)
        if eng.prefill_chunks > chunks0:
            pre_tok += sum(r.prefill_tokens for r in reqs) - prefill0
            pre_s += dt
        elif eng.decode_steps > steps0:
            dec_tok += decoded
            dec_s += dt
    wall = time.perf_counter() - t_start
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    splits = ops.split_launch_counts()
    torch.cuda.synchronize()
    prof = eng.latency_profile()
    res = {
        "requests": len(reqs), "finished": len(finished),
        "new_tokens": sum(len(r.out_tokens) for r in finished),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "decode_steps": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
        "launches": counts, "tc_launches": tcs, "split_launches": splits, "wall_s": wall,
        "prefill_tok_s": pre_tok / pre_s if pre_s else None,
        "decode_tok_s": dec_tok / dec_s if dec_s else None,
        "p50_step_ms": statistics.median(step_ms),
        "l_b_ms": ({int(b): float(v) * 1e3 for b, v in
                    zip(prof.batch_sizes, prof.latency)} if prof else {}),
        "preemptions": eng.preemptions, "cow_copies": eng.cow_copies,
        "prefix_hits": eng.prefix_index.hits if eng.prefix_index else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    check(len(finished) == len(reqs), "not every request finished")
    check(all(len(r.out_tokens) == r.max_new_tokens for r in finished),
          "a request finished with the wrong token count")
    res["kv_dtype"] = eng.kv_dtype
    _check_paged_launches(counts, tcs, splits, [eng])
    eng.allocator.check_no_leaks()
    return res


def _check_tc(counts, tcs, cfg, what: str) -> None:
    """Every flash and paged prefill call of a bf16 model took the
    tensor-core body; of a float32 model, none did, nor flash at MLA's
    head dims (192 / 128: the CUDA-core body)."""
    want = {k: counts[k] if cfg.dtype == "bfloat16"
            and not (k == "flash_attention" and cfg.mla is not None) else 0 for k in tcs}
    check(tcs == want, f"{what}: tensor-core launches {tcs}, expected {want}")


def _check_split(counts, splits, what: str) -> None:
    """Every decode call of a serving run took the split-context body."""
    want = {k: counts[k] for k in splits}
    check(splits == want, f"{what}: split-body launches {splits}, expected {want}")


def _check_paged_launches(counts, tcs, splits, engines) -> None:
    """Exact launch accounting of paged engines of one page dtype: each
    attention kernel once a layer per decode step or prefill chunk, RMSNorm
    twice a layer plus once; the other page dtype's kernels never; the
    prefill through the tensor-core body in bf16; every decode call through
    the split-context body."""
    kv_dtype = engines[0].kv_dtype
    decode, prefill, _ = PAGED_KERNELS[kv_dtype]
    steps = sum(e.cfg.n_layers * e.decode_steps for e in engines)
    chunks = sum(e.cfg.n_layers * e.prefill_chunks for e in engines)
    norms = sum((2 * e.cfg.n_layers + 1) * (e.decode_steps + e.prefill_chunks)
                for e in engines)
    check(counts[decode] == steps, f"{decode} launches {counts} vs {steps} layer steps")
    check(counts[prefill] == chunks, f"{prefill} launches {counts} vs {chunks} layer chunks")
    check(counts["rmsnorm"] == norms, f"rmsnorm launches {counts} vs {norms} expected")
    check(all(counts[k] > 0 for k in PAGED_KERNELS[kv_dtype]),
          f"a kernel never ran: {counts}")
    other = PAGED_KERNELS["int8" if kv_dtype == "fp32" else "fp32"]
    check(all(counts[k] == 0 for k in other[:2]),
          f"{kv_dtype} pages launched the other page dtype's kernels: {counts}")
    _check_tc(counts, tcs, engines[0].cfg, f"{kv_dtype} pages")
    _check_split(counts, splits, f"{kv_dtype} pages")


def phase_engine(dev, cfg) -> dict:
    from repro_torch.models import init_params
    from repro_torch.serving import PagedLLMEngine, Request

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    lens = rng.integers(96, 769, size=8)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n).tolist(),
                    max_new_tokens=32) for i, n in enumerate(lens)]
    eng = PagedLLMEngine(cfg, max_seqs=8, max_len=1024, params=params, device=dev)
    run1 = _serve(eng, reqs)
    run1["pool_pages"] = eng.num_pages
    emit("engine", run="default pool", init_s=init_s, **run1)
    main_counts = run1["launches"]
    del eng

    shared = rng.integers(0, cfg.vocab, size=256).tolist()
    # prompt + 1 ends on a page boundary, so decode growth meets a pool that
    # admissions have filled: this mix evicts (and re-admits) twice
    tails = [479, 687, 415, 223, 303, 255]
    prompts = [shared + rng.integers(0, cfg.vocab, size=n).tolist() for n in tails]
    prompts += [list(shared), list(shared)]       # page-aligned duplicates: CoW
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
    pages_per_seq = 1024 // 16
    eng = PagedLLMEngine(cfg, max_seqs=8, max_len=1024, params=params, device=dev,
                         num_pages=1 + 3 * pages_per_seq, prefix_cache=True)
    run2 = _serve(eng, reqs)
    run2["pool_pages"] = eng.num_pages
    emit("engine", run="prefix cache, small pool", **run2)
    check(run2["preemptions"] > 0 and run2["cow_copies"] > 0
          and run2["prefix_hits"] > 0,
          "the small-pool run did not exercise eviction, prefix hits and CoW")
    budget = eng.num_pages * eng.page_bytes
    del eng
    # run 3: run 2's requests through int8 pages at run 2's pool bytes
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
    eng = PagedLLMEngine(cfg, max_seqs=8, max_len=1024, params=params, device=dev,
                         num_pages=PagedLLMEngine.pages_for_byte_budget(
                             cfg, 16, budget, "int8"),
                         prefix_cache=True, kv_dtype="int8")
    check(eng.num_pages * eng.page_bytes <= budget, "int8 pool over run 2's bytes")
    run3 = _serve(eng, reqs)
    run3.update(pool_pages=eng.num_pages, pool_bytes=eng.num_pages * eng.page_bytes,
                budget_bytes=budget)
    # (1.88x the pages admit all eight at once, before any prefill has
    # registered the shared prefix: no hits are expected here)
    emit("engine", run="prefix cache, int8 pages at run 2's pool bytes", **run3)
    del eng
    for kv_dtype in ("fp32", "int8"):
        emit("profile", kv_dtype=kv_dtype, **_profile_decode(
            PagedLLMEngine(cfg, max_seqs=8, max_len=1024, params=params, device=dev,
                           kv_dtype=kv_dtype),
            [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=512).tolist(),
                     max_new_tokens=64) for i in range(8)]))
    return {"launches": main_counts, "launches_int8": run3["launches"],
            "tc_launches": run1["tc_launches"], "tc_launches_int8": run3["tc_launches"],
            "split_launches": run1["split_launches"],
            "split_launches_int8": run3["split_launches"],
            "runs": [run1, run2, run3]}


def _host_events(prof) -> dict:
    """Host-side CUDA runtime calls of a traced window, by kind."""
    launches = syncs = copies = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            continue
        if "LaunchKernel" in evt.name:
            launches += 1
        elif evt.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += 1
        elif evt.name.startswith("cudaMemcpy"):
            copies += 1
    return {"launches": launches, "syncs": syncs, "memcpys": copies}


def _profile_decode(eng, reqs, n_steps: int = 8) -> dict:
    """Trace ``n_steps`` steady decode steps of an engine at batch
    ``len(reqs)`` (:func:`_profile_window`).  Works for the paged and the
    slot engine."""
    for r in reqs:
        check(eng.admit(r), "profile: admission refused")
    while getattr(eng, "prefilling", None):   # the slot engine prefills in admit()
        eng.step()
    for _ in range(2):
        eng.step()
    return _profile_window(eng.step, n_steps,
                           f"{n_steps} decode steps, batch {len(reqs)}, "
                           f"{len(reqs[0].prompt)}-token prompts, {type(eng).__name__}")


SHARE_KERNELS = ("rmsnorm_kernel", "ssm_scan_kernel", "attention_tc_kernel", "decode_split")


def _profile_window(step, n_steps: int, window: str, share_kernels=SHARE_KERNELS) -> dict:
    """Trace ``n_steps`` calls of ``step`` with torch.profiler: device time
    by kernel, the share of the window the device idled, the device time
    and share of the busy time of each of ``share_kernels`` (by default
    RMSNorm, the scan, the attention tensor-core body and the split decode
    body; ``kernel_shares``), and the host's kernel launches, syncs and
    memcpys a step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_PAD_S)   # (see device_ms)
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name if len(evt.name) < 90 else evt.name[:87] + "..."
        tot, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (tot + evt.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    shares = {}
    for kernel in share_kernels:
        hits = [(t, n) for name, (t, n) in by_kernel.items() if kernel in name]
        ms = sum(t for t, _ in hits)
        shares[kernel] = {"ms": ms, "count": sum(n for _, n in hits),
                          "share_of_busy": ms / busy_ms if busy_ms else None}
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    calls = _host_events(prof)
    return {
        **{f"host_{k}_per_step": n / n_steps for k, n in calls.items()},
        "top_host_ops_ms": [{"name": e.key, "self_ms": e.self_cpu_time_total / 1e3,
                             "count": e.count} for e in host],
        "window": window,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "device_events": sum(n for _, n in by_kernel.values()),
        "top_kernels_ms": [{"name": k, "ms": t, "count": n} for k, (t, n) in top],
        "kernel_shares": shares,
    }


# ---------------------------------------------------------------------------
# phase: testbed (the paper's testbed: scheduler + cluster + engines)
# ---------------------------------------------------------------------------
TESTBED_JOBS = 12
TESTBED_SHARED_PROMPT = 384      # + 2 suffix tokens: ~386-token prompts
TESTBED_TOKEN_SCALE = 4.0        # tasks decode ~8-160 tokens, ~30 on average
TESTBED_TIME_SCALE = 4.0
TESTBED_LIMIT_S = 300            # a run that has not finished by then stalled


TESTBED_COMMON = dict(max_batch=4, n_regular=4, shared_prompt_tokens=TESTBED_SHARED_PROMPT,
                      token_scale=TESTBED_TOKEN_SCALE, time_scale=TESTBED_TIME_SCALE, seed=0)


def _profile_store():
    """Bayesian-network profiles fitted from 300 seeded planning traces."""
    from repro_torch.core import ProfileStore
    from repro_torch.sim import generate_traces, get_generators

    gens = get_generators()
    return ProfileStore().fit([g.template for g in gens.values()],
                              generate_traces("planning", 300, seed=7))


class Stalled(RuntimeError):
    """A testbed run did not finish within TESTBED_LIMIT_S."""


def _stalled(signum, frame):
    raise Stalled(f"testbed run did not finish within {TESTBED_LIMIT_S} s")


def _norms_per_pass(cfg) -> int:
    """RMSNorm launches of one prefill or decode pass over a config: each
    layer's ``norm1``, its ``norm2`` where it has an FFN (not xLSTM's
    cells), a Whisper decoder layer's ``norm_x``, and the final norm."""
    from repro_torch.models import layer_kind

    if cfg.family == "audio":
        return 3 * cfg.n_layers + 1
    return 1 + sum(2 if layer_kind(cfg, i).split("+")[1] != "none" else 1
                   for i in range(cfg.n_layers))


def _check_slot_launches(counts, tcs, splits, cfg, adm: int, steps: int, what: str) -> None:
    """Exact launch accounting of slot engines: per admission, flash
    attention once an attention or MLA layer and the scan once a Mamba
    layer; per decode step, slot decode attention once an attention layer
    (MLA decodes in the latent space, with no kernel) and the scan once a
    Mamba layer; RMSNorm once a layer, once more a layer with an FFN, and
    once for the final norm, in both (xLSTM's cells run no other kernel);
    the paged kernels never; flash through the tensor-core body in bf16
    (MLA's 192 / 128 through the CUDA-core body); every decode call
    through the split-context body."""
    from repro_torch.models import layer_kind

    mixers = [layer_kind(cfg, i).split("+")[0] for i in range(cfg.n_layers)]
    n_attn, n_mamba = mixers.count("attn"), mixers.count("mamba")
    n_mla = mixers.count("mla")
    check(counts["flash_attention"] == (n_attn + n_mla) * adm,
          f"{what}: flash launches {counts} vs {adm} admissions")
    check(counts["decode_attention"] == n_attn * steps,
          f"{what}: slot decode launches {counts} vs {steps} decode steps")
    check(counts["ssm_scan"] == n_mamba * (adm + steps),
          f"{what}: ssm_scan launches {counts} vs {adm + steps} admissions and steps")
    check(counts["rmsnorm"] == _norms_per_pass(cfg) * (adm + steps),
          f"{what}: rmsnorm launches {counts} vs {adm + steps} admissions and steps")
    used = (("rmsnorm",) + (("flash_attention",) if n_attn + n_mla else ())
            + (("decode_attention",) if n_attn else ()) + (("ssm_scan",) if n_mamba else ()))
    check(all(counts[k] > 0 for k in used), f"{what}: a kernel never ran: {counts}")
    check(all(v == 0 for k, v in counts.items() if k not in used),
          f"{what}: a kernel off the slot path ran: {counts}")
    _check_tc(counts, tcs, cfg, what)
    _check_split(counts, splits, what)


def _testbed_run(name, store, engines, serve_cfg, seed: int = 0,
                 jobs: int = TESTBED_JOBS, gate=None) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_scheduler
    from repro_torch.serving import ServingCluster
    from repro_torch.sim import generate_workload

    wl = generate_workload("planning", jobs, arrival_rate=0.9, seed=seed)
    sched = build_scheduler(name, store, epsilon=0.2, seed=seed,
                            plan_ahead_s=serve_cfg.plan_ahead_s)
    cluster = ServingCluster(sched, engines, serve_cfg, gate=gate)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    signal.alarm(TESTBED_LIMIT_S)
    try:
        res = cluster.run(wl)
        torch.cuda.synchronize()
    finally:
        signal.alarm(0)
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    splits = ops.split_launch_counts()
    profiles = [e.latency_profile() for e in engines]
    out = {
        "model": ",".join(dict.fromkeys(e.cfg.name for e in engines)),
        "layers": engines[0].cfg.n_layers,
        "scheduler": name, "engine": serve_cfg.engine, "replicas": len(engines),
        "jobs": jobs, "finished": len(res.jct_by_job),
        "avg_jct_s": res.avg_jct, "makespan_s": res.makespan,
        "tokens": res.tokens_generated, "sched_overhead_ms": res.avg_overhead_ms,
        "preemptions": res.preemptions, "migrations": res.migrations,
        "prefill_tokens": res.prefill_tokens, "prefill_saved": res.prefill_saved_tokens,
        "l_b_ms": [({int(b): float(v) * 1e3 for b, v in zip(p.batch_sizes, p.latency)}
                    if p else {}) for p in profiles],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "tc_launches": tcs, "split_launches": splits,
        "escalations": res.escalations,
    }
    check(out["finished"] == jobs, f"{name}: {out['finished']} of {jobs} jobs finished")
    if serve_cfg.engine == "slot":
        adm = sum(e.admissions for e in engines)
        steps = sum(e.decode_steps for e in engines)
        out.update(admissions=adm, decode_steps=steps)
        _check_slot_launches(counts, tcs, splits, engines[0].cfg, adm, steps,
                             f"testbed {name}")
    else:
        out.update(decode_steps=sum(e.decode_steps for e in engines),
                   prefill_chunks=sum(e.prefill_chunks for e in engines),
                   pool_pages=[e.num_pages for e in engines],
                   pool_bytes=[e.num_pages * e.page_bytes for e in engines],
                   kv_dtype=serve_cfg.kv_dtype)
        _check_paged_launches(counts, tcs, splits, engines)
        for e in engines:
            e.allocator.check_no_leaks(allow_indexed=True)
    return out


def phase_testbed(dev, cfg) -> dict:
    from repro_torch.core import DeterministicGate
    from repro_torch.models import init_params
    from repro_torch.serving import PagedLLMEngine, Request, ServeConfig, build_engines
    from repro_torch.sim.workloads import TIER_POOLS

    store = _profile_store()
    params = init_params(cfg, seed=0, device=dev)
    slot_cfg = ServeConfig(engine="slot", replicas=1, max_len=1024, **TESTBED_COMMON)
    runs = {}
    for name in ("llmsched", "fcfs"):
        engines = build_engines(cfg, slot_cfg, params=params, device=dev)
        runs[name] = _testbed_run(name, store, engines, slot_cfg)
        emit("testbed", **runs[name])
        del engines
    # two paged replicas: a pool that holds one request and a large one
    fleet_cfg = ServeConfig(engine="paged", replicas=2, max_len=512, kv_pages=(33, 129),
                            migrate=True, prefix_cache=True, **TESTBED_COMMON)
    engines = build_engines(cfg, fleet_cfg, params=params, device=dev)
    runs["fleet"] = _testbed_run("llmsched", store, engines, fleet_cfg)
    emit("testbed", **runs["fleet"])
    budgets = [e.num_pages * e.page_bytes for e in engines]
    del engines
    # the same fleet with int8 pages at the same pool bytes per replica
    q8_pages = tuple(PagedLLMEngine.pages_for_byte_budget(cfg, fleet_cfg.page_size, b, "int8")
                     for b in budgets)
    q8_cfg = ServeConfig(engine="paged", replicas=2, max_len=512, kv_pages=q8_pages,
                         kv_dtype="int8", migrate=True, prefix_cache=True, **TESTBED_COMMON)
    engines = build_engines(cfg, q8_cfg, params=params, device=dev)
    runs["fleet_int8"] = _testbed_run("llmsched", store, engines, q8_cfg)
    runs["fleet_int8"]["budget_bytes"] = budgets
    emit("testbed", **runs["fleet_int8"])
    del engines
    # the cascade ladder: three smoke-config tiers on paged replicas, a
    # deterministic quality gate escalating rejected stages one tier up
    ladder_cfg = ServeConfig(engine="paged", replicas=3, models=TIER_POOLS["ladder3"],
                             cascade=True, max_len=512, max_batch=4, n_regular=4,
                             token_scale=TESTBED_TOKEN_SCALE, time_scale=TESTBED_TIME_SCALE,
                             seed=0)
    engines = build_engines(None, ladder_cfg, device=dev)
    runs["ladder3"] = _testbed_run("llmsched", store, engines, ladder_cfg,
                                   gate=DeterministicGate(strictness=0.8, seed=0))
    emit("testbed", **runs["ladder3"])
    del engines
    # where a slot decode step's time goes: batch 4, testbed-sized prompts
    rng = np.random.default_rng(6)
    emit("profile", **_profile_decode(
        build_engines(cfg, slot_cfg, params=params, device=dev)[0],
        [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=386).tolist(),
                 max_new_tokens=64) for i in range(4)]))
    return runs


# ---------------------------------------------------------------------------
# phases: held_hybrid and hybrid (Jamba-1.5-Large through the slot engine)
# ---------------------------------------------------------------------------
HYBRID_ARCH = "jamba_1_5_large_398b"
HYBRID_LAYERS = 5          # every layer kind of the period; 66.2 GB of bf16
HYBRID_JOBS = 6


def _hybrid_cfg():
    """Jamba-1.5-Large at its published widths, cut to the first 5 layers:
    mamba+moe, mamba+mlp, mamba+moe, mamba+mlp, attn+moe (the prefix
    layout, as 5 does not tile the 8-layer period)."""
    from repro_torch.configs import get_config

    return get_config(HYBRID_ARCH).with_(n_layers=HYBRID_LAYERS)


class _RouterGaps:
    """Within the block, every MoE routing also records the smallest gap
    between a token's k-th and (k+1)-th router probability, by device
    (``gaps``): a top-k that flips at a near-tie between card and CPU is a
    summation order, not a fault, and the gap tells the two apart."""

    def __init__(self) -> None:
        self.gaps = {}

    def __enter__(self):
        from repro_torch.models import moe as M

        self._routing = route = M._routing

        def routing(p, cfg, x2d):
            probs = torch.softmax((x2d @ p["router"]).float(), dim=-1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            gap = float((top[:, -2] - top[:, -1]).min())
            key = x2d.device.type
            self.gaps[key] = min(self.gaps.get(key, 1.0), gap)
            return route(p, cfg, x2d)

        M._routing = routing
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe as M

        M._routing = self._routing


def _held_slot_runs(cfg, gpu_params, cpu_params, dev, prompts, new_tokens, what):
    """The same requests through ``LLMEngine`` (2 slots, so a later request
    re-uses a freed slot) on the card and on the CPU: outputs, seconds and
    the smallest router gaps seen (:class:`_RouterGaps`)."""
    from repro_torch.serving import LLMEngine, Request

    outs, secs = {}, {}
    with _RouterGaps() as gaps:
        for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
            eng = LLMEngine(cfg, max_batch=2, max_len=128, params=params, device=d)
            out, pending = {}, list(enumerate(prompts))
            t1 = time.perf_counter()
            while pending or eng.batch_size:
                while pending and eng.can_admit():
                    i, p = pending.pop(0)
                    check(eng.admit(Request(
                        rid=i, prompt=p, max_new_tokens=new_tokens[i],
                        on_finish=lambda r, out=out: out.__setitem__(r.rid,
                                                                     list(r.out_tokens)))),
                        f"{what}: admission refused")
                eng.step()
            secs[name] = time.perf_counter() - t1
            outs[name] = out
    torch.cuda.synchronize()
    return outs, secs, gaps.gaps


def phase_held_hybrid(dev) -> dict:
    """Jamba-1.5-Large at full width in float32, cut to its first 2 layers
    (mamba+moe, mamba+mlp) and 4 experts (~20 GB, which the host holds
    too): the same weights and requests through ``LLMEngine`` on the card
    and on the CPU must give the same greedy tokens, with a freed slot
    re-used mid-stream."""
    import dataclasses

    from repro_torch.bridge import params_to
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    full = get_config(HYBRID_ARCH)
    cfg = full.with_(n_layers=2, dtype="float32",
                     moe=dataclasses.replace(full.moe, n_experts=4))
    t0 = time.perf_counter()
    gpu_params = init_params(cfg, seed=1, device=dev)
    cpu_params = params_to(gpu_params, "cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (24, 41, 57)]
    logits, states = {}, {}
    for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
        toks = torch.tensor([prompts[1]], dtype=torch.int32, device=d)
        lg, cache = prefill(params, cfg, toks, max_len=128)
        lg2, cache = decode_step(params, cfg, cache, torch.tensor([prompts[1][0]], device=d))
        logits[name] = torch.cat([lg.float().cpu(), lg2.float().cpu()])
        states[name] = cache["prefix_0"]["ssm"].cpu()
    outs, secs, gaps = _held_slot_runs(cfg, gpu_params, cpu_params, dev, prompts, (8, 5, 8),
                                       "held_hybrid")
    res = {"model": "jamba-1.5-large-398b widths, 2 layers (mamba+moe, mamba+mlp), "
                    "4 of 16 experts, float32, TF32 off, slot engine",
           "tokens_equal": outs["cuda"] == outs["cpu"],
           "n_tokens": sum(len(v) for v in outs["cuda"].values()),
           "max_logit_gap": float((logits["cuda"] - logits["cpu"]).abs().max()),
           "max_ssm_state_gap": float((states["cuda"] - states["cpu"]).abs().max()),
           "logits": "41-token prefill and one decode step", "init_s": init_s,
           "seconds": secs, "min_router_gap": gaps}
    emit("held_hybrid", **res)
    check(len(outs["cuda"]) == len(prompts), "held_hybrid: requests missing")
    check(res["tokens_equal"], "held_hybrid: card and CPU engines disagree")
    return res


def _serve_slot(eng, reqs, what: str) -> dict:
    """Admit every request (prefill) and step until all finished, each
    admission and step ending in ``torch.cuda.synchronize()``; the launch
    counts are set to 0 just before and read just after."""
    from repro_torch.kernels import ops

    check(len(reqs) <= eng.max_batch, "more requests than slots")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    pre_s, step_ms, dec_tok, finished = 0.0, [], 0, []
    for r in reqs:
        t0 = time.perf_counter()
        check(eng.admit(r), "admission refused")
        torch.cuda.synchronize()
        pre_s += time.perf_counter() - t0
    while eng.batch_size:
        rows = eng.batch_size
        t0 = time.perf_counter()
        finished.extend(eng.step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        dec_tok += rows
    wall = time.perf_counter() - t_start
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    splits = ops.split_launch_counts()
    prof = eng.latency_profile()
    check(len(finished) == len(reqs), "not every request finished")
    check(all(len(r.out_tokens) == r.max_new_tokens for r in finished),
          "a request finished with the wrong token count")
    _check_slot_launches(counts, tcs, splits, eng.cfg, eng.admissions, eng.decode_steps,
                         what)
    return {
        "requests": len(reqs), "finished": len(finished),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "new_tokens": sum(len(r.out_tokens) for r in finished),
        "admissions": eng.admissions, "decode_steps": eng.decode_steps,
        "launches": counts, "tc_launches": tcs, "split_launches": splits, "wall_s": wall,
        "prefill_tok_s": sum(len(r.prompt) for r in reqs) / pre_s,
        "decode_tok_s": dec_tok / (sum(step_ms) / 1e3),
        "p50_step_ms": statistics.median(step_ms),
        "l_b_ms": ({int(b): float(v) * 1e3 for b, v in
                    zip(prof.batch_sizes, prof.latency)} if prof else {}),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def phase_hybrid(dev) -> dict:
    """The 5-layer full-width Jamba-1.5-Large in bf16 (66.2 GB) through
    ``LLMEngine.admit``/``step``, a profiled decode window, then LLMSched
    over one hybrid slot replica."""
    from repro_torch.models import decode_step, init_params, layer_kind, prefill
    from repro_torch.serving import LLMEngine, Request, ServeConfig, build_engines

    cfg = _hybrid_cfg()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    rng = np.random.default_rng(12)
    lens = rng.integers(128, 513, size=4)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]
    # the logits are finite and of the vocabulary's width
    toks = torch.tensor([prompts[0]], dtype=torch.int32, device=dev)
    lg, cache = prefill(params, cfg, toks, max_len=1024)
    lg2, _ = decode_step(params, cfg, cache, lg.argmax(-1))
    check(lg.shape == lg2.shape == (1, cfg.vocab) and bool(torch.isfinite(lg).all())
          and bool(torch.isfinite(lg2).all()), "hybrid: logits not finite")
    del cache
    eng = LLMEngine(cfg, max_batch=4, max_len=1024, params=params, device=dev)
    run = _serve_slot(eng, [Request(rid=i, prompt=p, max_new_tokens=16)
                            for i, p in enumerate(prompts)], "hybrid")
    run.update(model=f"{cfg.name}, published widths, first {cfg.n_layers} layers, bf16",
               layer_kinds=[layer_kind(cfg, i) for i in range(cfg.n_layers)],
               weights_gb=weights_gb, init_s=init_s)
    emit("hybrid", **run)
    del eng
    prof = _profile_decode(
        LLMEngine(cfg, max_batch=4, max_len=1024, params=params, device=dev),
        [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=386).tolist(),
                 max_new_tokens=64) for i in range(4)])
    emit("profile", model=cfg.name, **prof)
    slot_cfg = ServeConfig(engine="slot", replicas=1, max_len=1024, **TESTBED_COMMON)
    engines = build_engines(cfg, slot_cfg, params=params, device=dev)
    tb = _testbed_run("llmsched", _profile_store(), engines, slot_cfg, jobs=HYBRID_JOBS)
    emit("testbed", **tb)
    return {"launches": run["launches"], "run": run, "profile": prof, "testbed": tb}


# ---------------------------------------------------------------------------
# phases: held_mla, mla and dense (DeepSeek-V2-Lite, Llama-3-405B,
# Qwen1.5-110B, Kimi-K2)
# ---------------------------------------------------------------------------
MLA_ARCH = "deepseek_v2_lite_16b"
# 2 jobs and 4 profiled decode steps: its testbed (~140 s at 6 jobs, ~45 s
# at 4) and its trace of ~13,500 launches a step (~80 s at 8 steps) are
# among the script's longest phases, and it must end well inside its time
# limit
MLA_JOBS = 2
MLA_PROFILE_STEPS = 4
# DeepSeek's testbed tasks decode ~2-40 tokens (~8 on average), a quarter
# of the other testbeds': its host-bound ~0.2 s decode steps would take
# the run past the script's time budget otherwise
MLA_TOKEN_SCALE = 16.0
# the absorbed MLA decode against the expanded one through the slot decode
# kernel, float32: the CPU tests' model tolerance (summation order only)
MODEL_TOL = 1e-4
# (arch, layers kept): each at its published widths, bf16
DENSE_MODELS = (("llama3_405b", 2), ("qwen1_5_110b", 2), ("kimi_k2_1t_a32b", 1))


def _weights_gb(params) -> float:
    return sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9


def phase_held_mla(dev) -> dict:
    """DeepSeek-V2-Lite at its published widths in float32, cut to its first
    2 layers (``prefix_0``: mla+dense_mlp with d_ff_dense 10944;
    ``blocks/0``: mla+moe, 64 experts top-6 and 2 shared; ~4.3 GB, which the
    host holds too): the same weights and 3 requests through ``LLMEngine``
    on the card and on the CPU must give the same greedy tokens.  Then, on
    the card prefill's ``prefix_0`` cache, ``layers.mla_decode`` (the slot
    decode kernel at 192 / 128) against the engine's absorbed decode."""
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, layer_kind, prefill
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _mla_decode_absorbed

    cfg = get_config(MLA_ARCH).with_(n_layers=2, dtype="float32")
    t0 = time.perf_counter()
    gpu_params = init_params(cfg, seed=1, device=dev)
    cpu_params = params_to(gpu_params, "cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (29, 50, 44)]
    logits, caches = {}, {}
    for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
        toks = torch.tensor([prompts[1]], dtype=torch.int32, device=d)
        lg, cache = prefill(params, cfg, toks, max_len=128)
        lg2, cache = decode_step(params, cfg, cache, torch.tensor([prompts[1][0]], device=d))
        logits[name] = torch.cat([lg.float().cpu(), lg2.float().cpu()])
        caches[name] = cache
    outs, secs, gaps = _held_slot_runs(cfg, gpu_params, cpu_params, dev, prompts, (9, 6, 8),
                                       "held_mla")
    # mla_decode (expanded K/V, the slot decode kernel at 192 / 128, its
    # one-block-a-row body) against the absorbed form, on the card
    c = caches["cuda"]["prefix_0"]
    lengths = caches["cuda"]["lengths"]
    p = gpu_params["prefix_0"]["attn"]
    x = torch.randn(1, 1, cfg.d_model, device=dev, generator=torch.Generator(
        device=dev).manual_seed(20))
    ops.reset_launch_counts()
    got, _, _ = L.mla_decode(p, cfg, x, c["c_kv"].clone(), c["k_rope"].clone(), lengths)
    counts, splits = ops.launch_counts(), ops.split_launch_counts()
    want = _mla_decode_absorbed(p, cfg, x, {k: t.clone() for k, t in c.items()}, lengths)
    torch.cuda.synchronize()
    check(counts["decode_attention"] == 1 and splits["decode_attention"] == 0,
          f"held_mla: mla_decode launches {counts}, split {splits}")
    gap = float((got - want).abs().max())
    res = {"model": "deepseek-v2-lite-16b widths, 2 layers "
                    f"({', '.join(layer_kind(cfg, i) for i in range(2))}), 64 experts top-6 "
                    "+ 2 shared, float32, TF32 off, slot engine",
           "tokens_equal": outs["cuda"] == outs["cpu"],
           "n_tokens": sum(len(v) for v in outs["cuda"].values()),
           "max_logit_gap": float((logits["cuda"] - logits["cpu"]).abs().max()),
           "max_c_kv_gap": float((caches["cuda"]["blocks"]["0"]["c_kv"].cpu()
                                  - caches["cpu"]["blocks"]["0"]["c_kv"]).abs().max()),
           "logits": "50-token prefill and one decode step", "init_s": init_s,
           "seconds": secs, "min_router_gap": gaps,
           "mla_decode_vs_absorbed": {"max_abs_err": gap, "tol": MODEL_TOL,
                                      "decode_attention_launches": counts["decode_attention"],
                                      "length": int(lengths[0])}}
    emit("held_mla", **res)
    check(len(outs["cuda"]) == len(prompts), "held_mla: requests missing")
    check(res["tokens_equal"], "held_mla: card and CPU engines disagree")
    check(bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= MODEL_TOL + MODEL_TOL * want.abs()).all()),
        f"held_mla: mla_decode and the absorbed decode differ by {gap}")
    return res


def phase_mla(dev) -> dict:
    """The whole DeepSeek-V2-Lite-16B (27 layers, bf16, 31.4 GB of weights
    drawn on the card) through ``LLMEngine.admit``/``step``: 4 requests of
    128-512 prompt tokens and 32 new tokens each, every launch counted and
    matched (flash once a layer per admission, through its CUDA-core body;
    RMSNorm twice a layer plus once per admission and step; no decode
    attention: the absorbed decode has no kernel); then a profiled decode
    window and LLMSched over one DeepSeek slot replica."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, layer_kind, prefill
    from repro_torch.models import moe as M
    from repro_torch.serving import LLMEngine, Request, ServeConfig, build_engines

    cfg = get_config(MLA_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    lens = rng.integers(128, 513, size=4)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]
    toks = torch.tensor([prompts[0]], dtype=torch.int32, device=dev)
    lg, cache = prefill(params, cfg, toks, max_len=1024)
    lg2, _ = decode_step(params, cfg, cache, lg.argmax(-1))
    check(lg.shape == lg2.shape == (1, cfg.vocab) and bool(torch.isfinite(lg).all())
          and bool(torch.isfinite(lg2).all()), "mla: logits not finite")
    del cache
    eng = LLMEngine(cfg, max_batch=4, max_len=1024, params=params, device=dev)
    run = _serve_slot(eng, [Request(rid=i, prompt=p, max_new_tokens=32)
                            for i, p in enumerate(prompts)], "mla")
    n = cfg.n_layers
    check(run["launches"]["flash_attention"] == n * run["admissions"]
          and run["tc_launches"]["flash_attention"] == 0
          and run["launches"]["decode_attention"] == 0
          and run["launches"]["rmsnorm"] == (2 * n + 1) * (run["admissions"]
                                                           + run["decode_steps"]),
          f"mla: launches {run['launches']}, tc {run['tc_launches']}")
    run.update(model=f"{cfg.name}, published widths, all {n} layers, bf16",
               layer_kinds={k: sum(1 for i in range(n) if layer_kind(cfg, i) == k)
                            for k in dict.fromkeys(layer_kind(cfg, i) for i in range(n))},
               weights_gb=_weights_gb(params), init_s=init_s)
    emit("mla", **run)
    del eng
    # where a DeepSeek decode step's time goes; each routed MoE layer reads
    # its experts' token counts on the host (one sync a MoE layer)
    calls = {"moe_block": 0}
    block = M.moe_block

    def counted(*a, **k):
        calls["moe_block"] += 1
        return block(*a, **k)

    prof_eng = LLMEngine(cfg, max_batch=4, max_len=1024, params=params, device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=386).tolist(),
                    max_new_tokens=64) for i in range(4)]
    prof = _profile_decode(prof_eng, reqs, n_steps=MLA_PROFILE_STEPS)
    M.moe_block = counted       # one more step, counting the routed MoE calls
    try:
        prof_eng.step()
    finally:
        M.moe_block = block
    prof["moe_blocks_per_step"] = calls["moe_block"]
    emit("profile", model=cfg.name, **prof)
    del prof_eng
    slot_cfg = ServeConfig(engine="slot", replicas=1, max_len=1024, **dict(
        TESTBED_COMMON, token_scale=MLA_TOKEN_SCALE, time_scale=MLA_TOKEN_SCALE))
    engines = build_engines(cfg, slot_cfg, params=params, device=dev)
    tb = _testbed_run("llmsched", _profile_store(), engines, slot_cfg, jobs=MLA_JOBS)
    tb["token_scale"] = MLA_TOKEN_SCALE
    emit("testbed", **tb)
    return {"launches": run["launches"], "run": run, "profile": prof, "testbed": tb}


def phase_dense(dev) -> dict:
    """Llama-3-405B (2 of 126 layers), Qwen1.5-110B (2 of 80, QKV bias) and
    Kimi-K2 (1 of 61: all 384 experts top-8 and the shared expert) at their
    published widths in bf16, one at a time, through ``PagedLLMEngine``:
    4 requests of 96-384 prompt tokens and 16 new tokens each, launches
    matched, every bf16 paged prefill call through the tensor-core body and
    every decode call through the split body."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serving import PagedLLMEngine, Request

    out = {}
    for arch, layers in DENSE_MODELS:
        _free_card()
        full = get_config(arch)
        cfg = full.with_(n_layers=layers)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(22)
        lens = rng.integers(96, 385, size=4)
        prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]
        lg, _ = prefill(params, cfg, torch.tensor([prompts[0][:64]], dtype=torch.int32,
                                                  device=dev), max_len=128)
        check(lg.shape == (1, cfg.vocab) and bool(torch.isfinite(lg).all()),
              f"dense {arch}: logits not finite")
        eng = PagedLLMEngine(cfg, max_seqs=4, max_len=512, params=params, device=dev)
        run = _serve(eng, [Request(rid=i, prompt=p, max_new_tokens=16)
                           for i, p in enumerate(prompts)])
        run.update(model=f"{full.name}, published widths, {layers} of {full.n_layers} "
                         "layers, bf16",
                   group_size=cfg.n_heads // cfg.n_kv_heads,
                   weights_gb=_weights_gb(params), init_s=init_s, pool_pages=eng.num_pages)
        emit("dense", **run)
        out[arch] = run
        del eng, params, lg
    _free_card()
    return out


# ---------------------------------------------------------------------------
# phases: held_xlstm and xlstm (xLSTM-350M through the slot engine)
# ---------------------------------------------------------------------------
XLSTM_ARCH = "xlstm_350m"
# 3 jobs: its testbed took ~100 s at 6, host-bound (~20 launches a token
# a layer), and the script must end well inside its time limit
XLSTM_JOBS = 3


def _set_recurrence(params, dev, seed: int) -> None:
    """Every sLSTM cell's diagonal recurrence ``r_izfo`` (drawn as zeros, as
    in JAX) set to seeded normal values of spread 0.5, in place, so that the
    held checks run the recurrence."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for blk in params["blocks"].values():
        r = blk.get("cell", {}).get("r_izfo")
        if r is not None:
            r.copy_(torch.randn(r.shape, generator=gen, device=dev) * 0.5)


def phase_held_xlstm(dev) -> dict:
    """xLSTM-350M at full width in float32, cut to its first 8 layers (one
    superblock: 7 mLSTM + 1 sLSTM cells, ~1.1 GB), the sLSTM recurrence
    seeded non-zero: the same weights and 3 requests through ``LLMEngine``
    on the card and on the CPU must give the same greedy tokens, with a
    freed slot re-used mid-stream."""
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config(XLSTM_ARCH).with_(n_layers=8, dtype="float32")
    t0 = time.perf_counter()
    gpu_params = init_params(cfg, seed=1, device=dev)
    _set_recurrence(gpu_params, dev, seed=2)
    cpu_params = params_to(gpu_params, "cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (24, 41, 57)]
    logits, states = {}, {}
    for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
        toks = torch.tensor([prompts[1]], dtype=torch.int32, device=d)
        lg, cache = prefill(params, cfg, toks, max_len=128)
        lg2, cache = decode_step(params, cfg, cache, torch.tensor([prompts[1][0]], device=d))
        logits[name] = torch.cat([lg.float().cpu(), lg2.float().cpu()])
        slstm = str(cfg.xlstm.slstm_every - 1)
        states[name] = {n: cache["blocks"][j][n].cpu() for j, n in (("0", "C"), (slstm, "h"))}
    outs, secs, _ = _held_slot_runs(cfg, gpu_params, cpu_params, dev, prompts, (8, 5, 8),
                                    "held_xlstm")
    res = {"model": "xlstm-350m widths, 8 layers (7 mlstm + 1 slstm, one superblock), "
                    "r_izfo seeded non-zero, float32, TF32 off, slot engine",
           "tokens_equal": outs["cuda"] == outs["cpu"],
           "n_tokens": sum(len(v) for v in outs["cuda"].values()),
           "max_logit_gap": float((logits["cuda"] - logits["cpu"]).abs().max()),
           "max_state_gap": {n: float((states["cuda"][n] - states["cpu"][n]).abs().max())
                             for n in ("C", "h")},
           "logits": "41-token prefill and one decode step", "init_s": init_s,
           "seconds": secs}
    emit("held_xlstm", **res)
    check(len(outs["cuda"]) == len(prompts), "held_xlstm: requests missing")
    check(res["tokens_equal"], "held_xlstm: card and CPU engines disagree")
    return res


def phase_xlstm(dev) -> dict:
    """The whole xLSTM-350M (24 layers: 21 mLSTM + 3 sLSTM cells, bf16,
    1.2 GB) through ``LLMEngine.admit``/``step``: 4 requests of 64-256
    prompt tokens and 32 new tokens each, every launch counted and matched
    (RMSNorm once a layer plus the final norm per admission and step, no
    attention kernel: the cells are plain PyTorch, as JAX's ``lax.scan``);
    then a profiled decode window and LLMSched over one xLSTM slot replica
    (3 planning jobs at the testbed's token scale)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, layer_kind, prefill
    from repro_torch.serving import LLMEngine, Request, ServeConfig, build_engines

    cfg = get_config(XLSTM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(25)
    lens = rng.integers(64, 257, size=4)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]
    toks = torch.tensor([prompts[0]], dtype=torch.int32, device=dev)
    lg, cache = prefill(params, cfg, toks, max_len=512)
    lg2, _ = decode_step(params, cfg, cache, lg.argmax(-1))
    check(lg.shape == lg2.shape == (1, cfg.vocab) and bool(torch.isfinite(lg).all())
          and bool(torch.isfinite(lg2).all()), "xlstm: logits not finite")
    state_mb = sum(t[:, 0].numel() * t.element_size() for blk in cache["blocks"].values()
                   for t in blk.values()) / 1e6
    del cache
    eng = LLMEngine(cfg, max_batch=4, max_len=512, params=params, device=dev)
    run = _serve_slot(eng, [Request(rid=i, prompt=p, max_new_tokens=32)
                            for i, p in enumerate(prompts)], "xlstm")
    n = cfg.n_layers
    run.update(model=f"{cfg.name}, published widths, all {n} layers, bf16",
               layer_kinds={k: sum(1 for i in range(n) if layer_kind(cfg, i) == k)
                            for k in dict.fromkeys(layer_kind(cfg, i) for i in range(n))},
               weights_gb=_weights_gb(params), state_mb_per_slot=state_mb, init_s=init_s)
    emit("xlstm", **run)
    del eng
    prof = _profile_decode(
        LLMEngine(cfg, max_batch=4, max_len=512, params=params, device=dev),
        [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=128).tolist(),
                 max_new_tokens=64) for i in range(4)])
    emit("profile", model=cfg.name, **prof)
    slot_cfg = ServeConfig(engine="slot", replicas=1, max_len=1024, **TESTBED_COMMON)
    engines = build_engines(cfg, slot_cfg, params=params, device=dev)
    tb = _testbed_run("llmsched", _profile_store(), engines, slot_cfg, jobs=XLSTM_JOBS)
    tb["token_scale"] = slot_cfg.token_scale
    emit("testbed", **tb)
    return {"launches": run["launches"], "run": run, "profile": prof, "testbed": tb}


# ---------------------------------------------------------------------------
# phases: held_encdec and encdec (Whisper-tiny and Llama-3.2-Vision-90B
# through prefill / decode_step with enc_input)
# ---------------------------------------------------------------------------
WHISPER_ARCH = "whisper_tiny"
VISION_ARCH = "llama3_2_vision_90b"


def _enc_input(cfg, B: int, dev, dtype, seed: int) -> torch.Tensor:
    """Seeded normal frames / patch embeddings ``(B, n_ctx, d)`` on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, cfg.encoder.n_ctx, cfg.d_model, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def _greedy(params, cfg, toks, enc, n_new: int, max_len: int):
    """Prefill ``toks`` with ``enc``, then ``n_new - 1`` greedy decode steps:
    the tokens ``(B, n_new)`` and every step's logits (float32, host)."""
    from repro_torch.models import decode_step, prefill

    from repro_torch.distributed.sharding import is_dtensor

    def whole(lg):  # a sharded run's logits, gathered
        return lg.full_tensor() if is_dtensor(lg) else lg

    lg, cache = prefill(params, cfg, toks, max_len=max_len, enc_input=enc)
    lg = whole(lg)
    seq, lgs = [lg.argmax(-1)], [lg.float().cpu()]
    for _ in range(n_new - 1):
        lg, cache = decode_step(params, cfg, cache, seq[-1])
        lg = whole(lg)
        seq.append(lg.argmax(-1))
        lgs.append(lg.float().cpu())
    return torch.stack(seq, 1).cpu(), torch.stack(lgs, 1)


def phase_held_encdec(dev) -> dict:
    """Whisper-tiny whole (4 encoder and 4 decoder layers over 1500 frames)
    and Llama-3.2-Vision-90B at its published widths cut to its first 5
    layers (4 attn+mlp and the cross+mlp layer over 1601 patches; ~26 GB,
    which the host holds too), each in float32 with seeded random
    ``enc_input``: prefill and 8 greedy tokens for 2 prompts through
    ``prefill`` / ``decode_step`` on the card and on the CPU must give the
    same tokens."""
    from repro_torch.bridge import params_to
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    out = {}
    for arch, layers, n_tok in ((WHISPER_ARCH, None, 37), (VISION_ARCH, 5, 29)):
        _free_card()
        full = get_config(arch)
        cfg = full.with_(dtype="float32", **({"n_layers": layers} if layers else {}))
        t0 = time.perf_counter()
        gpu_params = init_params(cfg, seed=1, device=dev)
        cpu_params = params_to(gpu_params, "cpu")
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(26)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, n_tok)).astype(np.int32))
        enc = _enc_input(cfg, 2, dev, torch.float32, seed=27)
        seqs, logits, secs = {}, {}, {}
        for name, params, d in (("cuda", gpu_params, dev), ("cpu", cpu_params, "cpu")):
            t1 = time.perf_counter()
            seqs[name], logits[name] = _greedy(params, cfg, toks.to(d), enc.to(d), 8, 64)
            secs[name] = time.perf_counter() - t1
        equal = torch.equal(seqs["cuda"], seqs["cpu"])
        res = {"model": f"{full.name}, published widths, "
                        f"{cfg.n_layers} of {full.n_layers} layers"
                        + (f", encoder {cfg.encoder.n_layers} layers" if arch == WHISPER_ARCH
                           else "") + ", float32, TF32 off, prefill / decode_step",
               "enc_input": list(enc.shape), "tokens_equal": equal,
               "n_tokens": seqs["cuda"].numel(),
               "max_logit_gap": float((logits["cuda"] - logits["cpu"]).abs().max()),
               "logits": f"{n_tok}-token prefill and 7 decode steps, batch 2",
               "weights_gb": _weights_gb(gpu_params), "init_s": init_s, "seconds": secs}
        emit("held_encdec", **res)
        check(equal, f"held_encdec {arch}: card and CPU tokens disagree")
        out[arch] = res
        del gpu_params, cpu_params
    _free_card()
    return out


def _batch_caches(caches):
    """One request's prefill caches concatenated along the batch axis (axis 1
    under ``blocks`` and ``__cross``, axis 0 for ``lengths``), as a slot
    engine would hold them: rows of different prompt lengths."""
    def cat(items, axis):
        if isinstance(items[0], dict):
            return {k: cat([c[k] for c in items], axis) for k in items[0]}
        if isinstance(items[0], tuple):
            return tuple(cat([c[i] for c in items], axis) for i in range(len(items[0])))
        return torch.cat(items, dim=axis)

    return {key: cat([c[key] for c in caches], 0 if key == "lengths" else 1)
            for key in caches[0]}


def _check_encdec_launches(counts, tcs, splits, cfg, prefills: int, steps: int,
                           what: str) -> None:
    """Exact launches of a VLM or Whisper run: a prefill runs flash once a
    self-attention layer and once a cross layer (and once a Whisper encoder
    layer), a decode step flash once a cross layer (Sq = 1) and slot decode
    once a self-attention layer; RMSNorm once a norm; every bf16 flash call
    on the tensor-core body, every decode call on the split body."""
    from repro_torch.models import layer_kind

    n = cfg.n_layers
    if cfg.family == "audio":
        n_self = n_cross = n
        e = cfg.encoder.n_layers
        enc_flash, enc_norms = e, 2 * e + 1
    else:
        n_cross = sum(1 for i in range(n) if layer_kind(cfg, i).startswith("cross"))
        n_self, enc_flash, enc_norms = n - n_cross, 0, 0
    want = {k: 0 for k in counts}
    want["flash_attention"] = prefills * (enc_flash + n_self + n_cross) + steps * n_cross
    want["decode_attention"] = steps * n_self
    want["rmsnorm"] = prefills * (enc_norms + _norms_per_pass(cfg)) + steps * _norms_per_pass(cfg)
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    _check_tc(counts, tcs, cfg, what)
    _check_split(counts, splits, what)


def _serve_encdec(params, cfg, prompts, enc, new_tokens: int, max_len: int, what: str):
    """Each prompt prefilled alone with its row of ``enc`` (``prefill``), the
    caches batched, then greedy ``decode_step``s for the batch; every call
    ends in ``torch.cuda.synchronize()``.  Launches counted from 0 and
    matched exactly.  Returns (the run's numbers, the batched cache, the
    next tokens)."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, prefill

    dev = enc.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    pre_s, caches, first = 0.0, [], []
    for i, p in enumerate(prompts):
        toks = torch.tensor([p], dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        lg, c = prefill(params, cfg, toks, max_len=max_len, enc_input=enc[i:i + 1])
        torch.cuda.synchronize()
        pre_s += time.perf_counter() - t0
        check(lg.shape == (1, cfg.vocab) and bool(torch.isfinite(lg).all()),
              f"{what}: prefill logits not finite")
        caches.append(c)
        first.append(lg.argmax(-1))
    cache = _batch_caches(caches)
    del caches
    nxt, step_ms = torch.cat(first), []
    for _ in range(new_tokens - 1):
        t0 = time.perf_counter()
        lg, cache = decode_step(params, cfg, cache, nxt)
        nxt = lg.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(lg).all()), f"{what}: decode logits not finite")
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    splits = ops.split_launch_counts()
    _check_encdec_launches(counts, tcs, splits, cfg, len(prompts), len(step_ms), what)
    B = len(prompts)
    return {"requests": B, "prompt_tokens": sum(map(len, prompts)),
            "new_tokens": B * new_tokens, "prefills": B, "decode_steps": len(step_ms),
            "launches": counts, "tc_launches": tcs, "split_launches": splits,
            "prefill_tok_s": sum(map(len, prompts)) / pre_s,
            "decode_tok_s": B * len(step_ms) / (sum(step_ms) / 1e3),
            "p50_step_ms": statistics.median(step_ms),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "lengths": cache["lengths"].tolist()}, cache, nxt


def _host_clock_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn()`` ended by ``torch.cuda.synchronize()``."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(spans)


def phase_encdec(dev) -> dict:
    """Whisper-tiny whole and Llama-3.2-Vision-90B at published widths cut to
    its first 10 layers (2 superblocks, cross layers at 4 and 9; 21.3 GB) in
    bf16 through ``prefill`` and ``decode_step`` with seeded ``enc_input``:
    Whisper 4 prompts of 16-64 tokens and 32 new tokens, Vision 4 prompts of
    128-512 tokens and 16 new tokens; launches exact, every flash call on
    the tensor-core body and every decode call on the split body; the
    encoder's and the cross K/V's times (host clock, synchronized); a
    profiled window of 8 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, encode, init_params, layer_kind
    from repro_torch.models.transformer import _cross_kvs

    out = {}
    plan = ((WHISPER_ARCH, None, (16, 65), 32, 256), (VISION_ARCH, 10, (128, 513), 16, 1024))
    for arch, layers, span, new_tokens, max_len in plan:
        _free_card()
        full = get_config(arch)
        cfg = full.with_(**({"n_layers": layers} if layers else {}))
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(28)
        prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
                   for n in rng.integers(*span, size=4)]
        enc = _enc_input(cfg, 4, dev, cfg.tdtype, seed=29)
        run, cache, nxt = _serve_encdec(params, cfg, prompts, enc, new_tokens, max_len, arch)
        enc_out = enc[:1]
        if cfg.family == "audio":
            run["encoder_ms"] = _host_clock_ms(lambda: encode(params, cfg, enc[:1]))
            enc_out = encode(params, cfg, enc[:1])
        run["cross_kv_ms"] = _host_clock_ms(lambda: _cross_kvs(params, cfg, enc_out))
        state = {"cache": cache, "nxt": nxt}

        def step():
            lg, state["cache"] = decode_step(params, cfg, state["cache"], state["nxt"])
            state["nxt"] = lg.argmax(-1)

        prof = _profile_window(step, 8, f"8 decode steps, batch 4, {cfg.name} "
                                        "prefill / decode_step")
        run.update(model=f"{full.name}, published widths, {cfg.n_layers} of {full.n_layers} "
                         "layers" + (f", encoder {cfg.encoder.n_layers} layers"
                                     if cfg.family == "audio" else "") + ", bf16",
                   enc_input=list(enc.shape),
                   layer_kinds=[layer_kind(cfg, i) for i in range(cfg.n_layers)],
                   weights_gb=_weights_gb(params), init_s=init_s)
        emit("encdec", **run)
        emit("profile", model=cfg.name, **prof)
        out[arch] = {"run": run, "profile": prof}
        del params, cache, state, enc, enc_out
    _free_card()
    return out


# ---------------------------------------------------------------------------
# the trainer's kernels: flash attention and RMSNorm backward
# ---------------------------------------------------------------------------
#: (label, B, S_q, S_k, H, K, hd, causal) of the flash backward checks:
#: stablelm-1.6b's training shape, internlm2-20b's widths (g = 6, hd 128),
#: a ragged 386, bidirectional with S_q != S_k
FLASH_BWD_CASES = (("stablelm-1.6b train", 4, 1024, 1024, 32, 32, 64, True),
                   ("internlm2-20b GQA", 1, 1024, 1024, 48, 8, 128, True),
                   ("ragged", 1, 386, 386, 32, 32, 64, True),
                   ("bidirectional", 2, 200, 333, 6, 2, 64, False))
#: rows x d of the RMSNorm backward checks: a train step's (B = 4, S =
#: 1024) and a 386-token sequence's, stablelm's d
RMSNORM_BWD_CASES = ((4096, 2048), (386, 2048))


def _bwd_err(got: torch.Tensor, want: torch.Tensor, dtype, what: str, tols=BWD_TOL) -> float:
    """Max |got - want|, checked against ``tols`` (``BWD_TOL``; the scan's
    backward ``SSM_TOL``) scaled by max(1, the largest |want|) plus the same
    of each |want|."""
    check(bool(torch.isfinite(got).all()), f"{what}: gradient is not finite")
    g, w = got.float(), want.float()
    tol = tols[dtype]
    scale = max(1.0, float(w.abs().max()))
    excess = (g - w).abs() - (tol * scale + tol * w.abs())
    check(float(excess.max()) <= 0, f"{what}: outside tolerance {tol} x {scale}: "
          f"max |err| {float((g - w).abs().max())}")
    return float((g - w).abs().max())


def _flash_bwd_inputs(dev, dtype, B, Sq, Sk, H, K, hd, causal, seed: int, hd_v=None):
    """q, k, v, do from a seeded device generator, and the plain forward's
    output and LSE (the backward kernel and its plain version read the
    same); ``hd_v``, v's head dim, defaults to hd."""
    from repro_torch.kernels import ref as R

    hd_v = hd_v or hd
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(dtype)
                   for sh in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd_v),
                              (B, Sq, H, hd_v)))
    return q, k, v, R.attention_ref(q, k, v, causal=causal), \
        R.attention_lse_ref(q, k, causal=causal), do


def _errs_of(got, want) -> dict:
    """Per gradient (dq, dk, dv): max |got - want| and the norm-relative
    error ||got - want|| / ||want||."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        diff = a.float() - b.float()
        out[name] = {"max_abs": float(diff.abs().max()),
                     "rel": float(diff.norm() / b.float().norm())}
    return out


def _sdpa_bwd(q, k, v, do, causal: bool):
    """Autograd's backward of SDPA on q, k, v of (B, S, heads, hd), GQA by
    ``enable_gqa``: the library's bf16 backward, a witness of what bf16
    rounding costs against the plain backward (never used by the port)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                        enable_gqa=q.shape[2] != k.shape[2])
    grads = torch.autograd.grad(ot, (qt, kt, vt), do.transpose(1, 2).contiguous())
    return tuple(t.transpose(1, 2) for t in grads)


def _off_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view whose base is one element past a 16-byte
    boundary, so no row of it is 16-byte aligned."""
    buf = torch.zeros(t.numel() + 1, device=t.device, dtype=t.dtype)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


def _check_backward_kernels(dev, errs, cases) -> dict:
    """Both backward kernels against their plain backward versions, f32 and
    bf16: flash at ``FLASH_BWD_CASES`` (and the forward's LSE output against
    the plain LSE), RMSNorm at ``RMSNORM_BWD_CASES``.  In the ragged case K/V
    past Sk are NaN (a view into a longer buffer) and no gradient may move.
    Each kernel's second call must give the first's bits (deterministic).
    Every bf16 flash case takes the backward's tensor-core body, every f32
    case its CUDA-core body (``tc_launches``); the ragged case in bf16 is
    also held with its five inputs off 16 bytes, which takes the bf16
    CUDA-core body.  ``bwd_witness`` gives, for every bf16 flash case, the
    kernel's and SDPA's backward's errors against the plain backward on the
    same inputs (max and norm-relative)."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    lse_err = 0.0
    witness = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, Sq, Sk, H, K, hd, causal in FLASH_BWD_CASES:
            q, k, v, o, lse, do = _flash_bwd_inputs(dev, dtype, B, Sq, Sk, H, K, hd, causal, 51)
            tc0 = flash_attention_bwd.tc_launches
            got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            check(flash_attention_bwd.tc_launches - tc0 == (dtype == torch.bfloat16),
                  f"flash_attention_bwd ({label}, {dtype}) took the wrong body")
            want = R.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], _bwd_err(
                    a, b, dtype, f"flash_attention_bwd {name} ({label}, {dtype})"))
            if dtype == torch.bfloat16:
                witness[label] = {"kernel": _errs_of(got, want),
                                  "sdpa": _errs_of(_sdpa_bwd(q, k, v, do, causal), want)}
            if dtype == torch.bfloat16 and label == "ragged":
                # the bf16 CUDA-core body: every input off 16 bytes
                args = [_off_16_bytes(t) for t in (q, k, v, o)] + [lse, _off_16_bytes(do)]
                n0, tc0 = flash_attention_bwd.launches, flash_attention_bwd.tc_launches
                off = flash_attention_bwd(*args, causal=causal)
                check(flash_attention_bwd.launches == n0 + 1
                      and flash_attention_bwd.tc_launches == tc0,
                      "flash_attention_bwd off 16 bytes did not take the CUDA-core body")
                for name, a, b in zip(("dq", "dk", "dv"), off, want):
                    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], _bwd_err(
                        a, b, dtype, f"flash_attention_bwd {name} ({label}, off 16 bytes)"))
                check(all(torch.equal(a, b) for a, b in
                          zip(off, flash_attention_bwd(*args, causal=causal))),
                      "flash_attention_bwd off 16 bytes is not deterministic")
                cases.append(("flash_attention_bwd", f"{label}, off 16 bytes", str(dtype)))
                del args, off
            del want
            again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd is not deterministic ({label}, {dtype})")
            _, klse = flash_attention(q, k, v, causal=causal, return_lse=True)
            lse_err = max(lse_err, float((klse - lse).abs().max()))
            check(lse_err <= 1e-4, f"flash LSE output off the plain LSE: {lse_err}")
            if label == "ragged":
                pad = 62
                kb, vb = (torch.full((B, Sk + pad, K, hd), float("nan"), device=dev,
                                     dtype=dtype) for _ in range(2))
                kb[:, :Sk], vb[:, :Sk] = k, v
                nan = flash_attention_bwd(q, kb[:, :Sk], vb[:, :Sk], o, lse, do, causal=causal)
                check(all(torch.equal(a, b) for a, b in zip(got, nan)),
                      f"NaN past Sk moved a gradient ({dtype})")
                del kb, vb, nan
            cases.append(("flash_attention_bwd", label, str(dtype)))
            del q, k, v, o, lse, do, got, again
        for rows, d in RMSNORM_BWD_CASES:
            g = torch.Generator(device=dev).manual_seed(52)
            x = (3 * torch.randn(rows, d, generator=g, device=dev)).to(dtype)
            gamma = (1 + 0.2 * torch.randn(d, generator=g, device=dev)).to(dtype)
            dy = torch.randn(rows, d, generator=g, device=dev).to(dtype)
            got = rmsnorm_bwd(x, gamma, dy)
            want = R.rmsnorm_bwd_ref(x, gamma, dy)
            for name, a, b in zip(("dx", "dgamma"), got, want):
                errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], _bwd_err(
                    a, b, dtype, f"rmsnorm_bwd {name} ({rows} x {d}, {dtype})"))
            check(all(torch.equal(a, b) for a, b in zip(got, rmsnorm_bwd(x, gamma, dy))),
                  f"rmsnorm_bwd is not deterministic ({rows} x {d}, {dtype})")
            cases.append(("rmsnorm_bwd", rows, d, str(dtype)))
    torch.cuda.synchronize()
    return {"lse_max_abs_err": lse_err, "bwd_tol": {str(k): v for k, v in BWD_TOL.items()},
            "bwd_witness": witness}


def _backward_rows(dev, B=4, S=1024, H=32, hd=64, n=4096, d=2048) -> dict:
    """The backward kernels timed at stablelm-1.6b's training shape, bf16:
    flash (B = 4, S = 1024, causal, H = K = 32, hd 64) and RMSNorm (4096 x
    2048).  The library calls (timed, never used by the port) are autograd's
    backward of SDPA and of ``F.rms_norm`` on the same values."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    dt, es = torch.bfloat16, 2
    rows = {}
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, dt, B, S, S, H, H, hd, True, 53)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    pairs = S * (S + 1) // 2
    nb, fl = bound((8 * B * S * H * hd) * es + 4 * B * H * S, 10 * B * H * hd * pairs, dt)
    rows["flash_attention_bwd"] = dict(
        **_times(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                 lambda: R.attention_bwd_ref(q, k, v, o, lse, do, causal=True),
                 lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)),
        bound_ms=nb, bound_by=fl, shape=f"B={B} Sq=Sk={S} causal H=K={H} hd={hd}")
    del q, k, v, o, lse, do, qt, kt, vt, ot, dot
    g = torch.Generator(device=dev).manual_seed(54)
    x = torch.randn(n, d, generator=g, device=dev).to(dt)
    gamma = torch.ones(d, device=dev, dtype=dt)
    dy = torch.randn(n, d, generator=g, device=dev).to(dt)
    xl, gl = x.clone().requires_grad_(), gamma.clone().requires_grad_()
    yl = F.rms_norm(xl, (d,), gl, 1e-5)
    nb, fl = bound(3 * n * d * es + 2 * d * es, 8 * n * d, dt)
    rows["rmsnorm_bwd"] = dict(
        **_times(lambda: rmsnorm_bwd(x, gamma, dy), lambda: R.rmsnorm_bwd_ref(x, gamma, dy),
                 lambda: torch.autograd.grad(yl, (xl, gl), dy, retain_graph=True)),
        bound_ms=nb, bound_by=fl, shape=f"rows={n} d={d}", **_rmsnorm_bwd_split(x))
    return rows


def _rmsnorm_bwd_split(x: torch.Tensor) -> dict:
    """The slots, CTAs a SM and rows a CTA the RMSNorm backward takes on
    ``x`` (contiguous, so its form is the aligned one where d allows it)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_aligned

    n, d = x.shape
    slots = _build.rmsnorm_bwd_slots(d, x.dtype)
    aligned = rmsnorm_bwd_aligned(d, x.element_size(), x.data_ptr())
    per_sm = _build.rmsnorm_bwd_ctas_per_sm(x.dtype, d, slots, aligned, x.device.index)
    return {"slots": slots, "aligned": aligned, "ctas_per_sm": per_sm,
            "rows_per_cta": _build.rmsnorm_bwd_rows(n, _build.sm_count(x.device.index), per_sm)}


def _backward_wide(dev) -> dict:
    """The backward kernels at the other training widths, bf16: flash at
    internlm2-20b's (B = 1, S = 1024, H = 48, K = 8, hd 128) and
    Jamba-1.5-Large's (B = 1, S = 512, H = 64, K = 8, hd 128), causal (the
    library call: autograd's SDPA backward with K/V expanded to the H
    heads), RMSNorm at Jamba's 512 x 8192."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    dt, es = torch.bfloat16, 2
    rows = {}
    for label, (B, S, H, K, hd) in (("internlm2-20b", (1, 1024, 48, 8, 128)),
                                    ("jamba-1.5-large", (1, 512, 64, 8, 128))):
        q, k, v, o, lse, do = _flash_bwd_inputs(dev, dt, B, S, S, H, K, hd, True, 55)
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for t in (k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        pairs = S * (S + 1) // 2
        nb, fl = bound((4 * B * S * H * hd + 4 * B * S * K * hd) * es + 4 * B * H * S,
                       10 * B * H * hd * pairs, dt)
        rows[f"flash_attention_bwd {label}"] = dict(
            **_times(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                     lambda: R.attention_bwd_ref(q, k, v, o, lse, do, causal=True),
                     lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)),
            bound_ms=nb, bound_by=fl, shape=f"B={B} Sq=Sk={S} causal H={H} K={K} hd={hd}")
        del q, k, v, o, lse, do, qt, kt, vt, ot, dot
    n, d = 512, 8192
    g = torch.Generator(device=dev).manual_seed(56)
    x = torch.randn(n, d, generator=g, device=dev).to(dt)
    gamma = (1 + 0.2 * torch.randn(d, generator=g, device=dev)).to(dt)
    dy = torch.randn(n, d, generator=g, device=dev).to(dt)
    xl, gl = x.clone().requires_grad_(), gamma.clone().requires_grad_()
    yl = F.rms_norm(xl, (d,), gl, 1e-5)
    nb, fl = bound(3 * n * d * es + 2 * d * es, 8 * n * d, dt)
    rows[f"rmsnorm_bwd {n}x{d}"] = dict(
        **_times(lambda: rmsnorm_bwd(x, gamma, dy), lambda: R.rmsnorm_bwd_ref(x, gamma, dy),
                 lambda: torch.autograd.grad(yl, (xl, gl), dy, retain_graph=True)),
        bound_ms=nb, bound_by=fl, shape=f"rows={n} d={d}", **_rmsnorm_bwd_split(x))
    return {"timing_bf16_backward_wide": rows}


#: (label, B, S_q = S_k, H = K, hd, hd_v) of the flash backward checks at
#: MLA's head dims, causal: DeepSeek's smoke widths, DeepSeek-V2-Lite's
#: (one sequence of 386 tokens, and a ragged 100 at B = 2)
MLA_BWD_CASES = (("deepseek smoke", 2, 37, 4, 24, 16), ("deepseek-v2-lite", 1, 386, 16, 192, 128),
                 ("deepseek-v2-lite ragged", 2, 100, 16, 192, 128))
#: (label, B, T, D, N, h0, dh_T) of the scan backward checks: Jamba-1.5-Large's
#: training shape, the smoke config's N = 8 with h0 and dh_T, ragged T and D,
#: a T of one step, one past a checkpoint and one at it, 33 chunks with a
#: one-step tail at a D no multiple of 64, and N = 4's one-lane form
SCAN_BWD_CASES = (("jamba train", 1, 1024, 16384, 16, False, False),
                  ("smoke", 2, 13, 128, 8, True, True),
                  ("ragged", 3, 37, 100, 16, True, False),
                  ("ragged N 8", 2, 70, 100, 8, False, True),
                  ("one step", 4, 1, 16384, 16, True, True),
                  ("past a checkpoint", 1, 65, 16384, 16, False, True),
                  ("at a checkpoint", 2, 64, 100, 16, True, False),
                  ("many chunks, ragged tail", 1, 1025, 200, 16, True, True),
                  ("N 4 past a checkpoint", 3, 33, 70, 4, False, False))
SCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def _check_mla_backward(dev, errs, cases) -> None:
    """The flash backward at MLA's head dims (``MLA_BWD_CASES``) against the
    plain backward, f32 and bf16, causal: every call through the CUDA-core
    body (no tensor-core launch), each rerun bit-equal."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    for dtype in (torch.float32, torch.bfloat16):
        for label, B, S, H, hd, hd_v in MLA_BWD_CASES:
            q, k, v, o, lse, do = _flash_bwd_inputs(dev, dtype, B, S, S, H, H, hd, True, 58,
                                                    hd_v=hd_v)
            tc0 = flash_attention_bwd.tc_launches
            got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
            check(flash_attention_bwd.tc_launches == tc0,
                  f"flash_attention_bwd at {hd} / {hd_v} took the tensor-core body")
            want = R.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                check(a.shape == b.shape and a.dtype == dtype, f"flash_attention_bwd {name} "
                      f"({label}): {a.dtype} {tuple(a.shape)}")
                errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], _bwd_err(
                    a, b, dtype, f"flash_attention_bwd {name} ({label}, {dtype})"))
            check(all(torch.equal(a, b) for a, b in
                      zip(got, flash_attention_bwd(q, k, v, o, lse, do, causal=True))),
                  f"flash_attention_bwd is not deterministic ({label}, {dtype})")
            cases.append(("flash_attention_bwd", label, hd, hd_v, str(dtype)))
            del q, k, v, o, lse, do, got, want


def _check_scan_backward(dev, errs, cases) -> None:
    """The scan's checkpoints and its backward kernel (``SCAN_BWD_CASES``),
    f32 and bf16, B and C read as strided column slices: each checkpoint
    equals, to the bit, h_T of the forward cut there (the first: h0, or
    zeros); every gradient against ``ssm_scan_bwd_ref`` within ``SSM_TOL``
    scaled as ``_bwd_err`` scales; a rerun gives the same bits."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

    rng = np.random.default_rng(12)
    step = _build.SSM_CKPT_STEPS
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, T, D, N, with_h0, with_dhT in SCAN_BWD_CASES:
            x, dt, A, Bm, Cm, Dk, h0 = _scan_inputs(rng, B, T, D, N, dtype, dev)
            check(not Bm.is_contiguous(), "the scan's B should be a strided view")
            h0 = h0 if with_h0 else None
            g = torch.Generator(device=dev).manual_seed(59)
            dy = torch.randn(B, T, D, generator=g, device=dev).to(dtype)
            dhT = 0.5 * torch.randn(B, D, N, generator=g, device=dev) if with_dhT else None
            y, hT, states = ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0, return_states=True)
            check(torch.equal(y, ssm_scan(x, dt, A, Bm, Cm, Dk, h0=h0)[0]),
                  f"ssm_scan with its checkpoints gave another y ({label}, {dtype})")
            first = torch.zeros_like(hT) if h0 is None else h0
            cut = [first] + [ssm_scan(x[:, :t], dt[:, :t], A, Bm[:, :t], Cm[:, :t], Dk,
                                      h0=h0)[1] for t in range(step, T, step)]
            check(states.shape == (B, _build.ssm_checkpoints(T), D, N)
                  and all(torch.equal(states[:, i], c) for i, c in enumerate(cut)),
                  f"ssm_scan checkpoints differ from the cut scans' h_T ({label}, {dtype})")
            got = ssm_scan_bwd(x, dt, A, Bm, Cm, Dk, states, dy, h0=h0, dhT=dhT)
            want = R.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, Dk, dy, h0=h0, dhT=dhT)
            for name, a, b in zip(SCAN_GRADS, got, want):
                if b is None:
                    check(a is None, f"ssm_scan_bwd gave {name} without h0")
                    continue
                check(a.shape == b.shape and a.dtype == b.dtype, f"ssm_scan_bwd {name} "
                      f"({label}): {a.dtype} {tuple(a.shape)} against {b.dtype} "
                      f"{tuple(b.shape)}")
                errs["ssm_scan_bwd"] = max(errs["ssm_scan_bwd"], _bwd_err(
                    a, b, dtype, f"ssm_scan_bwd {name} ({label}, {dtype})", SSM_TOL))
            again = ssm_scan_bwd(x, dt, A, Bm, Cm, Dk, states, dy, h0=h0, dhT=dhT)
            check(all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
                  f"ssm_scan_bwd is not deterministic ({label}, {dtype})")
            cases.append(("ssm_scan_bwd", label, str(dtype)))
            del x, dt, A, Bm, Cm, Dk, states, got, want, again
    torch.cuda.synchronize()


def _scan_bwd_row(dev, B=1, T=1024, D=16384, N=16) -> dict:
    """Row 6b: the scan's backward at Jamba-1.5-Large's training shape, bf16
    (B and C strided slices, no h0 or dh_T): ``ms`` and device ms of the
    kernel (both launches), its plain version's time (three calls: it
    keeps every state), and the bound: the reverse pass's B T D N exps on
    the special-function units at the card's maximum clock, its f32
    operations (15 a (t, d, n)) at the f32 peak, or its bytes once (x, dt,
    dy, B, C, A, D and the checkpoints in; dx, ddt, dB, dC, dA, dD out).
    ``form``: what the form launched (4 lanes, the vector form: x and dt
    are contiguous) takes (registers, spilled bytes, shared bytes a CTA,
    CTAs a SM, from the launcher) and the waves its ``ceil(D / 64) B`` CTAs
    make on the card's SMs (a tree without the launcher's query gives
    None); ``forward_states_device_ms``: the forward that writes the
    checkpoints the backward reads, at the same shape.  No single PyTorch
    call computes it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

    dt_, es = torch.bfloat16, 2
    x, dt, A, Bm, Cm, Dk, _ = _scan_inputs(np.random.default_rng(13), B, T, D, N, dt_, dev)
    dy = torch.randn(B, T, D, generator=torch.Generator(device=dev).manual_seed(60),
                     device=dev).to(dt_)
    _, _, states = ssm_scan(x, dt, A, Bm, Cm, Dk, return_states=True)
    nc = _build.ssm_checkpoints(T)
    nbytes = (5 * B * T * D * es + 4 * B * T * N * es + 2 * D * N * 4 + 2 * D * es
              + B * nc * D * N * 4)
    clock = _sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t_bytes = nbytes / card_rates()[0] * 1e3
    t_exp = B * T * D * N / (SFU_EXP_PER_CLOCK_PER_SM * sms * clock) * 1e3
    t_flops = 15 * B * T * D * N / F32_PEAK_FLOPS * 1e3

    def kernel():
        return ssm_scan_bwd(x, dt, A, Bm, Cm, Dk, states, dy)

    form = None
    if hasattr(_build, "ssm_scan_bwd_form"):
        form = dict(_build.ssm_scan_bwd_form(dt_, N, dev.index or 0),
                    lanes=_build.ssm_scan_lanes(N), sms=sms)
        ctas = -(-D // _build.SSM_CHANNELS_PER_CTA) * B
        form["waves"] = -(-ctas // (form["ctas_per_sm"] * sms))
        check(form["spill_bytes"] == 0, f"ssm_scan_bwd's form spills: {form}")
    fwd = device_ms(lambda: ssm_scan(x, dt, A, Bm, Cm, Dk, return_states=True))["device_ms"]
    return dict(
        ms=time_ms(kernel), form=form, forward_states_device_ms=fwd,
        plain_ms=time_ms(lambda: R.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, Dk, dy), groups=3,
                         per_group=1),
        host_ms=host_ms(kernel, calls=50), **device_ms(kernel),
        library_ms=None, library_device_ms=None,
        library="no single PyTorch call computes a selective scan's gradients",
        bound_ms=max(t_bytes, t_exp, t_flops),
        bound_by="bytes" if t_bytes >= max(t_exp, t_flops) else "operations",
        bound_parts_ms={"bytes": t_bytes, "sfu_exp": t_exp, "f32_ops": t_flops},
        sm_clock_mhz=clock / 1e6, bytes=nbytes, checkpoints=nc,
        shape=f"B={B} T={T} D={D} N={N}, h0 and dh_T none, B/C strided")


def _mla_backward_row(dev, errs, cases, B=4, S=1024, H=16, hd=192, hd_v=128) -> dict:
    """Row 5b-MLA: the flash backward at DeepSeek-V2-Lite's training shape
    (B = 4, S = 1024, causal, H = K = 16, hd 192 / hd_v 128), bf16, on the
    CUDA-core body, the shape ``train_families`` gives it: dq, dk and dv
    held against the plain backward on the same inputs (``BWD_TOL``), a
    rerun bit-equal, then the times; the library call (timed, never used by
    the port) is autograd's backward of SDPA at the same shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    dt, es = torch.bfloat16, 2
    label = "deepseek-v2-lite train"
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, dt, B, S, S, H, H, hd, True, 61, hd_v=hd_v)
    tc0 = flash_attention_bwd.tc_launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = R.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    err = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.shape == b.shape and a.dtype == dt, f"flash_attention_bwd {name} ({label}): "
              f"{a.dtype} {tuple(a.shape)}")
        err[name] = _bwd_err(a, b, dt, f"flash_attention_bwd {name} ({label}, {dt})")
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err[name])
    check(all(torch.equal(a, b) for a, b in
              zip(got, flash_attention_bwd(q, k, v, o, lse, do, causal=True))),
          f"flash_attention_bwd is not deterministic ({label}, {dt})")
    cases.append(("flash_attention_bwd", label, hd, hd_v, str(dt)))
    del got, want
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=hd ** -0.5)
    dot = do.transpose(1, 2).contiguous()
    pairs = S * (S + 1) // 2
    nb, fl = bound((2 * B * S * H * hd + 2 * B * S * H * hd + 4 * B * S * H * hd_v) * es
                   + 4 * B * H * S, 2 * B * H * pairs * (3 * hd + 2 * hd_v), dt)
    row = dict(
        **_times(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                 lambda: R.attention_bwd_ref(q, k, v, o, lse, do, causal=True),
                 lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)),
        bound_ms=nb, bound_by=fl, body="CUDA cores", max_abs_err=err,
        tol=BWD_TOL[dt], shape=f"B={B} Sq=Sk={S} causal H=K={H} hd={hd} hd_v={hd_v}")
    check(flash_attention_bwd.tc_launches == tc0, "the MLA backward took the tensor-core body")
    return row


# ---------------------------------------------------------------------------
# phases: held_train (card vs CPU, float32) and train (stablelm-1.6b whole)
# ---------------------------------------------------------------------------
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 20
#: the learning rate of the train phase's runs, both state types: the JAX
#: package's int8 AdamW state is unstable (a row-wise int8 v rounds its
#: small entries to 0, and m / (sqrt(v) + eps) blows up): on the H100 the
#: whole stablelm-1.6b with int8 state went 12.26 -> 148.4 in 20 steps at
#: lr 1e-4 and 12.26 -> 19.2 at 3e-5, and fell (12.26 -> 7.67) at 1e-5
#: (PERF.md); JAX's own launcher diverges at its default 1e-3 on the
#: llama3 smoke config on the CPU
TRAIN_LR = "1e-5"
TRAIN_TRACE_STEPS = 3
#: the kernels whose device time a traced train step reports: the flash
#: backward's three launches (its tensor-core body's, which bf16 training
#: takes, and its CUDA-core body's), RMSNorm's backward's two, and the
#: forwards
TRAIN_SHARE_KERNELS = ("dkdv_tc_kernel", "dq_tc_kernel", "delta_tc_kernel", "dkdv_kernel",
                       "dq_kernel", "delta_kernel", "rmsnorm_bwd_kernel", "dgamma_kernel",
                       "attention_tc_kernel", "rmsnorm_kernel")
RESTART_LAYERS, RESTART_STEPS, RESTART_AT = 2, 10, 5
# held_train: card (kernels) against CPU (plain versions), float32 with TF32
# off: the loss and the gradient norm to summation order, each gradient leaf
# to BWD_TOL's float32 1e-4 of max(1, its largest magnitude) (summation
# order through two layers, the kernels' and cuBLAS's against the CPU's)
HELD_TRAIN_TOL = 1e-5
# the restart check: the same weights, state, batches and deterministic
# kernels; the embedding gradient's scatter-add (PyTorch's, atomics) may sum
# in another order run to run, which moves a bf16 loss by far less than a
# wrong restore (other batches or state) does; held to this relative gap
RESTART_TOL = 1e-5


#: the kernels a train step may launch: the forward kernels of the three
#: autograd routes and their backward kernels
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "ssm_scan",
                 "ssm_scan_bwd")
#: batch x seq of each smoke config's held step (the whole phase: seconds)
HELD_TRAIN_BATCH = (2, 32)


def _family_launches(counts, tcs, cfg, passes: int, what: str) -> None:
    """Launch accounting of ``passes`` forward-and-backward passes of any
    family: every forward kernel call (flash, RMSNorm, the scan) ran its
    backward kernel once; the scan once a Mamba layer a pass; where the
    model has no encoder, flash once an attention or MLA layer a pass and
    RMSNorm as a prefill pass takes it (Whisper and the VLM: both at least
    once); no serving kernel; in bf16 at a head dim of ``TC_HEAD_DIMS``
    every flash call, forward and backward, took the tensor-core body
    (``tcs``: ``ops.tc_launch_counts()``), in float32 or at MLA's head dims
    none."""
    from repro_torch.kernels import _build
    from repro_torch.models import layer_kind

    mixers = [layer_kind(cfg, i).split("+")[0] for i in range(cfg.n_layers)]
    n_attn, n_mla, n_mamba = (mixers.count(k) for k in ("attn", "mla", "mamba"))
    for fwd in ("flash_attention", "rmsnorm", "ssm_scan"):
        check(counts[fwd] == counts[f"{fwd}_bwd"],
              f"{what}: {fwd} ran {counts[fwd]} times, its backward {counts[fwd + '_bwd']}")
    check(counts["ssm_scan_bwd"] == n_mamba * passes,
          f"{what}: ssm_scan_bwd {counts['ssm_scan_bwd']}, want {n_mamba} x {passes}")
    if cfg.family in ("vlm", "audio"):
        check(counts["flash_attention_bwd"] > 0 and counts["rmsnorm_bwd"] > 0,
              f"{what}: a backward kernel never ran: {counts}")
    else:
        want = {"flash_attention_bwd": (n_attn + n_mla) * passes,
                "rmsnorm_bwd": _norms_per_pass(cfg) * passes}
        check({k: counts[k] for k in want} == want, f"{what}: launches {counts}, want {want}")
    others = {k: v for k, v in counts.items() if v and k not in TRAIN_KERNELS}
    check(not others, f"{what}: a kernel off the training path ran: {others}")
    tc = (counts["flash_attention"] if cfg.dtype == "bfloat16" and not n_mla
          and cfg.hd in _build.TC_HEAD_DIMS else 0)
    got = {k: tcs[k] for k in ("flash_attention", "flash_attention_bwd")}
    check(got == {"flash_attention": tc, "flash_attention_bwd": tc}
          and not any(v for k, v in tcs.items() if k not in got),
          f"{what}: tensor-core launches {tcs}, want {tc} of each flash kernel")


def _held_train_family(dev, arch: str) -> dict:
    """One smoke config in float32, the same weights and batch on the card
    and on the CPU: one ``loss_and_grads`` (loss, every gradient leaf, the
    norm) and one ``build_train_step`` step (its loss and grad norm), the
    card's through the kernels forward and backward, launches counted."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.optimizer import OptConfig, init_opt_state, tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.models.zoo import build_train_step, loss_and_grads

    cfg = get_smoke_config(arch).with_(dtype="float32")
    weights = params_to_numpy(init_params(cfg, 0, device="cpu"))
    batch = synthetic_batch(np.random.default_rng(1), cfg, *HELD_TRAIN_BATCH)
    opt = OptConfig(lr=1e-3, warmup_steps=5)
    out = {}
    for where, d in (("cpu", "cpu"), ("card", dev)):
        p = params_from_numpy(weights, d)
        b = {k: t.to(d) for k, t in batch.items()}
        ops.reset_launch_counts()
        loss, grads = loss_and_grads(p, cfg, b)
        _, _, m = build_train_step(cfg, opt)(p, init_opt_state(p, opt), b)
        out[where] = {"loss": float(loss), "step_loss": float(m["loss"]),
                       "step_grad_norm": float(m["grad_norm"]),
                       "grads": [g.cpu() for g in tree_leaves(grads)],
                       "counts": ops.launch_counts(), "tcs": ops.tc_launch_counts()}
    c, g = out["cpu"], out["card"]
    _family_launches(g["counts"], g["tcs"], cfg, 2, f"held_train {arch}")
    leaf_err = max(_bwd_err(a, b, torch.float32, f"held_train {arch} gradient")
                   for a, b in zip(g["grads"], c["grads"]))
    gnorm = {k: float(torch.sqrt(sum(x.double().square().sum() for x in v["grads"])))
             for k, v in (("cpu", c), ("card", g))}
    gaps = {"loss": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
            "grad_norm": abs(gnorm["card"] - gnorm["cpu"]) / gnorm["cpu"],
            "step_loss": abs(g["step_loss"] - c["step_loss"]) / abs(c["step_loss"]),
            "step_grad_norm": (abs(g["step_grad_norm"] - c["step_grad_norm"])
                               / c["step_grad_norm"])}
    check(all(v <= HELD_TRAIN_TOL for v in gaps.values()), f"held_train {arch}: gaps {gaps}")
    res = {"config": cfg.name, "loss": {"cpu": c["loss"], "card": g["loss"]},
           "grad_norm": gnorm, "rel_gaps": gaps, "grad_leaves": len(g["grads"]),
           "grad_leaf_max_abs_err": leaf_err,
           "launches": {k: v for k, v in g["counts"].items() if v}}
    if cfg.mla is not None:
        res["mla_head_dims"] = [cfg.mla.nope_head_dim + cfg.mla.rope_head_dim,
                                cfg.mla.v_head_dim]
    return res


def phase_held_train(dev) -> dict:
    """stablelm's smoke widths in float32, the same weights on the card and
    on the CPU: ``loss_and_grads`` (loss, every gradient leaf, the norm) and
    three ``build_train_step`` steps' losses, the card's through the
    kernels forward and backward (launches counted); then each of the ten
    smoke configs the same way (:func:`_held_train_family`: Jamba's
    through the scan's backward kernel, DeepSeek's through the flash
    backward at MLA's 24 / 16)."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.optimizer import OptConfig, init_opt_state, tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.models.zoo import build_train_step, loss_and_grads

    cfg = get_smoke_config("stablelm_1_6b").with_(dtype="float32")
    weights = params_to_numpy(init_params(cfg, 0, device="cpu"))
    opt = OptConfig(lr=1e-3, warmup_steps=5)
    out = {}
    for d in ("cpu", dev):
        rng = np.random.default_rng(0)
        batches = [{k: t.to(d) for k, t in synthetic_batch(rng, cfg, 8, 64).items()}
                   for _ in range(3)]
        p = params_from_numpy(weights, d)
        ops.reset_launch_counts()
        loss, grads = loss_and_grads(p, cfg, batches[0])
        counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
        step = build_train_step(cfg, opt)
        state = init_opt_state(p, opt)
        losses = []
        for b in batches:
            p, state, m = step(p, state, b)
            losses.append(float(m["loss"]))
        out[str(d)] = {"loss": float(loss), "grads": [g.cpu() for g in tree_leaves(grads)],
                       "losses": losses, "counts": counts, "tcs": tcs}
    torch.cuda.synchronize()
    c, g = out["cpu"], out[str(dev)]
    _family_launches(g["counts"], g["tcs"], cfg, 1, "held_train")
    gnorm = {k: float(torch.sqrt(sum(x.double().square().sum() for x in v["grads"])))
             for k, v in (("cpu", c), ("card", g))}
    leaf_err = max(_bwd_err(a, b, torch.float32, "held_train gradient")
                   for a, b in zip(g["grads"], c["grads"]))
    loss_gap = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    norm_gap = abs(gnorm["card"] - gnorm["cpu"]) / gnorm["cpu"]
    step_gap = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], c["losses"]))
    check(loss_gap <= HELD_TRAIN_TOL and norm_gap <= HELD_TRAIN_TOL,
          f"held_train: loss gap {loss_gap}, grad-norm gap {norm_gap}")
    check(step_gap <= 1e-4, f"held_train: three steps' losses part by {step_gap}")
    from repro_torch.configs import ARCH_IDS

    t0 = time.perf_counter()
    families = {arch: _held_train_family(dev, arch) for arch in ARCH_IDS}
    res = {"config": cfg.name, "dtype": "float32", "tf32": False, "batch": [8, 64],
           "loss": {"cpu": c["loss"], "card": g["loss"]}, "loss_rel_gap": loss_gap,
           "grad_norm": gnorm, "grad_norm_rel_gap": norm_gap, "grad_leaves": len(g["grads"]),
           "grad_leaf_max_abs_err": leaf_err, "step_losses": {"cpu": c["losses"],
                                                              "card": g["losses"]},
           "step_loss_max_rel_gap": step_gap, "launches": g["counts"],
           "families": families, "families_batch": list(HELD_TRAIN_BATCH),
           "families_s": time.perf_counter() - t0,
           "tol": {"loss_and_norm": HELD_TRAIN_TOL, "leaf": BWD_TOL[torch.float32],
                   "three_steps": 1e-4}}
    emit("held_train", **res)
    return res


def _param_counts(params) -> dict:
    emb = sum(params[k].numel() for k in ("embedding", "lm_head") if k in params)
    total = sum(t.numel() for t in _leaves(params))
    return {"total": total, "embedding": emb, "non_embedding": total - emb}


def _train_run(dev, state_dtype: str) -> dict:
    """stablelm-1.6b whole through ``repro_torch.launch.train.main``, bf16,
    ``TRAIN_STEPS`` steps at batch x seq ``TRAIN_BATCH`` x ``TRAIN_SEQ``;
    then ``TRAIN_TRACE_STEPS`` more steps traced by the profiler."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    _free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    report = {}
    t0 = time.perf_counter()
    rc = train_mod.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                         "--opt-state", state_dtype, "--lr", TRAIN_LR, "--seed", "0"],
                        report=report)
    wall = time.perf_counter() - t0
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cfg, losses = report["cfg"], report["losses"]
    check(rc == 0 and losses[-1] < losses[0],
          f"train ({state_dtype}): rc {rc}, loss {losses[0]} -> {losses[-1]}")
    _family_launches(counts, tcs, cfg, TRAIN_STEPS, f"train ({state_dtype})")
    n = _param_counts(report["params"])
    step_s = report["step_s"]
    p50 = statistics.median(step_s)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / p50
    rng = np.random.default_rng(1)
    state = {"params": report["params"], "opt": report["opt_state"]}

    def step():
        batch = train_mod.synthetic_batch(rng, cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
        state["params"], state["opt"], m = report["step_fn"](state["params"], state["opt"],
                                                             batch)
        float(m["loss"])

    prof = _profile_window(step, TRAIN_TRACE_STEPS, f"{TRAIN_TRACE_STEPS} train steps",
                           share_kernels=TRAIN_SHARE_KERNELS)
    del report, state
    res = {"state_dtype": state_dtype, "config": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": float(TRAIN_LR),
           "steps": TRAIN_STEPS, "wall_s": wall, "losses": losses,
           "first_loss": losses[0], "last_loss": losses[-1],
           "step_ms": [t * 1e3 for t in step_s], "step_ms_p50": p50 * 1e3,
           "train_tok_s": tok_s, "params": n,
           "mfu": 6 * n["total"] * tok_s / card_rates()[1][torch.bfloat16],
           "mfu_note": "6 N tokens/s / 989e12, N = embedding + non-embedding parameters",
           "peak_gib": peak, "launches": counts, "tc_launches": tcs,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items() if v},
           "backward_launches_per_step": (counts["flash_attention_bwd"]
                                          + counts["rmsnorm_bwd"]) / TRAIN_STEPS,
           "profile": prof}
    emit("train_run", **{k: v for k, v in res.items() if k != "profile"},
         device_idle_share=prof["device_idle_share"], profile_wall_ms=prof["wall_ms"],
         profile_busy_ms=prof["device_busy_ms"], top_kernels_ms=prof["top_kernels_ms"],
         kernel_shares=prof["kernel_shares"],
         host_launches_per_step=prof.get("host_launches_per_step"))
    return res


def _restart_check(dev) -> dict:
    """stablelm-1.6b at published widths cut to ``RESTART_LAYERS`` layers,
    int8 state, through the launcher: an uninterrupted run of
    ``RESTART_STEPS`` steps, and a run that checkpoints at ``RESTART_AT``
    (into a temporary directory, removed after) and a second that resumes
    from it; the resumed losses must equal the uninterrupted ones."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod

    cut = get_config(TRAIN_ARCH).with_(n_layers=RESTART_LAYERS)
    base = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--opt-state", "int8", "--lr", TRAIN_LR, "--seed", "0"]
    real = train_mod.get_config
    train_mod.get_config = lambda name: cut
    try:
        full, first, resumed = {}, {}, {}
        train_mod.main(base + ["--steps", str(RESTART_STEPS)], report=full)
        full = full["losses"]
        _free_card()
        with tempfile.TemporaryDirectory() as d:
            ck = ["--ckpt-dir", d, "--ckpt-every", str(RESTART_AT)]
            train_mod.main(base + ["--steps", str(RESTART_AT)] + ck, report=first)
            first = first["losses"]
            _free_card()
            t0 = time.perf_counter()
            train_mod.main(base + ["--steps", str(RESTART_STEPS)] + ck, report=resumed)
            resume_s = time.perf_counter() - t0
            ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
            start, resumed = resumed["start"], resumed["losses"]
    finally:
        train_mod.get_config = real
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[RESTART_AT:]))
    rerun_gap = max(abs(a - b) / abs(b) for a, b in zip(first, full))
    check(start == RESTART_AT and len(resumed) == RESTART_STEPS - RESTART_AT
          and gap <= RESTART_TOL and rerun_gap <= RESTART_TOL,
          f"restart: resumed at {start}, losses {resumed} against {full[RESTART_AT:]}; "
          f"first {RESTART_AT} steps {first} against {full[:RESTART_AT]}")
    return {"layers": RESTART_LAYERS, "state_dtype": "int8", "uninterrupted": full,
            "checkpointed_run": first, "rerun_max_rel_gap": rerun_gap,
            "resumed_at": start, "resumed": resumed, "max_rel_gap": gap,
            "tol": RESTART_TOL, "checkpoint_gb": ckpt_bytes / 1e9,
            "resume_run_s": resume_s}


def phase_train(dev) -> dict:
    """``train``: stablelm-1.6b whole, bf16, with float32 and with int8
    optimizer state, then the 2-layer restart check."""
    runs = {sd: _train_run(dev, sd) for sd in ("float32", "int8")}
    _free_card()
    restart = _restart_check(dev)
    res = {"runs": {k: {x: v[x] for x in ("step_ms_p50", "train_tok_s", "mfu", "peak_gib",
                                          "first_loss", "last_loss",
                                          "backward_launches_per_step")}
                    | {"device_idle_share": v["profile"]["device_idle_share"]}
                    for k, v in runs.items()},
           "launches": runs["float32"]["launches"],
           "tc_launches": runs["float32"]["tc_launches"], "restart": restart}
    emit("train", **res)
    return res


# ---------------------------------------------------------------------------
# phase: train_families (the other families' training at published widths)
# ---------------------------------------------------------------------------
#: DeepSeek-V2-Lite-16B cut to its first layers (layer 0: MLA + the dense
#: MLP; then MLA + 64 experts top-6 + 2 shared), float32 AdamW state: 4
#: layers peaked at 43.8 GiB on the H100 (~20.9 bytes a parameter), so 6
#: (3.42 B parameters, ~67 GiB) still leave room
DEEPSEEK_TRAIN_LAYERS = 6
DEEPSEEK_TRAIN = dict(batch=4, seq=1024, steps=10, lr="1e-5")
#: Jamba-1.5-Large cut to its first 2 layers (Mamba + MoE, Mamba + MLP):
#: gradients only, its AdamW state does not fit one card
JAMBA_TRAIN_LAYERS, JAMBA_PASSES, JAMBA_BATCH = 2, 3, (1, 1024)
#: Whisper-tiny and xLSTM-350M whole through the launcher, float32 state;
#: xLSTM's cells make ~2,200 launches a token a step (forward and
#: backward): at 2 x 64 a step took 3.7 s and its traced step ~100 s of
#: profiler processing on the H100, so its batch is short
SMALL_TRAIN = {"whisper_tiny": dict(batch=4, seq=256, steps=5, lr="1e-3"),
               "xlstm_350m": dict(batch=2, seq=32, steps=5, lr="1e-3")}
#: the backward kernels whose share of a traced step's busy time a run
#: reports (the flash backward's CUDA-core and tensor-core kernels,
#: RMSNorm's backward's two, the scan's backward's two), and the forwards
FAMILY_BWD_KERNELS = ("dkdv_kernel", "dq_kernel", "delta_kernel", "dkdv_tc_kernel",
                      "dq_tc_kernel", "delta_tc_kernel", "rmsnorm_bwd_kernel", "dgamma_kernel",
                      "ssm_scan_bwd_kernel", "ssm_scan_bwd_sum_kernel")
FAMILY_SHARE_KERNELS = FAMILY_BWD_KERNELS + ("flash_attention_kernel", "attention_tc_kernel",
                                             "rmsnorm_kernel", "ssm_scan_kernel")


def _active_params(params, cfg) -> dict:
    """Parameters whose matmuls a token runs: all, less the routed experts'
    but ``top_k / n_experts`` of them (the shared experts count whole), less
    the input embedding (a row lookup, no matmul) unless it is tied to the
    head; the routed experts are the ``w_gate``/``w_up``/``w_down`` beside a
    ``router``."""
    routed = 0

    def walk(tree):
        nonlocal routed
        if "router" in tree:
            routed += sum(tree[k].numel() for k in ("w_gate", "w_up", "w_down"))
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)

    walk(params)
    total = sum(t.numel() for t in _leaves(params))
    frac = cfg.moe.top_k / cfg.moe.n_experts if cfg.moe is not None else 1.0
    embedding = 0 if cfg.tie_embeddings else params["embedding"].numel()
    return {"total": total, "routed": routed, "embedding": embedding,
            "active": total - embedding - routed + frac * routed}


def _family_profile(step, what: str) -> dict:
    """One traced step (:func:`_profile_window`) with the backward kernels'
    device ms and share of the busy time."""
    prof = _profile_window(step, 1, what, share_kernels=FAMILY_SHARE_KERNELS)
    bwd = sum(prof["kernel_shares"][k]["ms"] for k in FAMILY_BWD_KERNELS)
    return {"wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "backward_kernels_ms": bwd,
            "backward_kernels_share": bwd / prof["device_busy_ms"] if prof["device_busy_ms"]
            else None,
            "kernel_shares": {k: v for k, v in prof["kernel_shares"].items() if v["count"]},
            "top_kernels_ms": prof["top_kernels_ms"],
            "host_launches_per_step": prof.get("host_launches_per_step")}


def _launcher_run(dev, arch: str, cfg, batch: int, seq: int, steps: int, lr: str) -> dict:
    """``arch`` through ``repro_torch.launch.train.main`` (``cfg``, a depth
    cut where it is not the published config, in place of ``get_config``),
    float32 state: the loss must fall and every kernel call run its
    backward; then one step traced."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    _free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    report = {}
    real = train_mod.get_config
    train_mod.get_config = lambda name: cfg
    t0 = time.perf_counter()
    try:
        rc = train_mod.main(["--arch", arch, "--steps", str(steps), "--batch", str(batch),
                             "--seq", str(seq), "--opt-state", "float32", "--lr", lr,
                             "--seed", "0"], report=report)
    finally:
        train_mod.get_config = real
    wall = time.perf_counter() - t0
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    losses = report["losses"]
    check(rc == 0 and losses[-1] < losses[0] and all(np.isfinite(losses)),
          f"train_families {arch}: rc {rc}, loss {losses[0]} -> {losses[-1]}")
    _family_launches(counts, tcs, cfg, steps, f"train_families {arch}")
    step_s = report["step_s"]
    p50 = statistics.median(step_s)
    tok_s = batch * seq / p50
    n = _active_params(report["params"], cfg)
    rng = np.random.default_rng(1)
    state = {"params": report["params"], "opt": report["opt_state"]}

    def step():
        b = train_mod.synthetic_batch(rng, cfg, batch, seq, dev)
        state["params"], state["opt"], m = report["step_fn"](state["params"], state["opt"], b)
        float(m["loss"])

    prof = _family_profile(step, f"one {arch} train step")
    del report, state
    return {"config": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "state_dtype": "float32", "batch": batch, "seq": seq, "lr": float(lr),
            "steps": steps, "wall_s": wall, "losses": losses,
            "step_ms": [t * 1e3 for t in step_s],
            "step_ms_p50": p50 * 1e3, "train_tok_s": tok_s, "params": n,
            "mfu": 6 * n["active"] * tok_s / card_rates()[1][torch.bfloat16],
            "peak_gib": peak, "launches_per_step": {k: v / steps for k, v in counts.items() if v},
            "tc_launches_per_step": {k: v / steps for k, v in tcs.items() if v},
            "profile": prof}


def _jamba_grads(dev) -> dict:
    """Jamba-1.5-Large's first ``JAMBA_TRAIN_LAYERS`` layers at published
    widths, bf16, seeded weights: ``JAMBA_PASSES`` passes of
    ``loss_and_grads`` at batch ``JAMBA_BATCH`` (gradients only): loss and
    grad norm finite, the scan and its backward kernel twice a pass; then
    one pass traced."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params, layer_kind
    from repro_torch.models.zoo import loss_and_grads

    _free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(HYBRID_ARCH).with_(n_layers=JAMBA_TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    B, S = JAMBA_BATCH
    ops.reset_launch_counts()
    losses, norms, pass_s = [], [], []
    for _ in range(JAMBA_PASSES):
        batch = synthetic_batch(rng, cfg, B, S, dev)
        t1 = time.perf_counter()
        loss, grads = loss_and_grads(params, cfg, batch)
        norm = float(torch.sqrt(sum(g.float().square().sum() for g in _leaves(grads))))
        losses.append(float(loss))
        pass_s.append(time.perf_counter() - t1)
        norms.append(norm)
        del grads
    counts, tcs = ops.launch_counts(), ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)) and min(norms) > 0,
          f"train_families jamba: losses {losses}, grad norms {norms}")
    # the scan and its backward once a Mamba layer a pass (both layers)
    _family_launches(counts, tcs, cfg, JAMBA_PASSES, "train_families jamba")
    p50 = statistics.median(pass_s)
    n = _active_params(params, cfg)
    batch = synthetic_batch(rng, cfg, B, S, dev)

    def step():
        loss, grads = loss_and_grads(params, cfg, batch)
        float(loss)
        del grads

    prof = _family_profile(step, "one Jamba gradient pass")
    del params
    return {"config": cfg.name, "layers": cfg.n_layers,
            "kinds": [layer_kind(cfg, i) for i in range(cfg.n_layers)], "dtype": cfg.dtype,
            "batch": B, "seq": S, "passes": JAMBA_PASSES, "init_s": init_s, "losses": losses,
            "grad_norms": norms, "pass_ms": [t * 1e3 for t in pass_s],
            "step_ms_p50": p50 * 1e3, "train_tok_s": B * S / p50, "params": n,
            "mfu": 6 * n["active"] * B * S / p50 / card_rates()[1][torch.bfloat16],
            "peak_gib": peak,
            "launches_per_step": {k: v / JAMBA_PASSES for k, v in counts.items() if v},
            "tc_launches_per_step": {k: v / JAMBA_PASSES for k, v in tcs.items() if v},
            "profile": prof}


def phase_train_families(dev) -> dict:
    """``train_families``: the other families' training at published widths,
    bf16, seeded weights (each run's numbers in a ``train_family`` line):
    DeepSeek-V2-Lite-16B's first ``DEEPSEEK_TRAIN_LAYERS`` layers through the
    launcher (float32 state; the flash backward at MLA's 192 / 128 in every
    step: this slice's main path), Jamba-1.5-Large's first 2 layers
    (gradients only, through the scan's backward kernel), Whisper-tiny and
    xLSTM-350M whole through the launcher."""
    from repro_torch.configs import get_config

    runs = {}

    def run(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        runs[name] = fn(*args, **kwargs)
        emit("train_family", run=name, run_s=time.perf_counter() - t0, **runs[name])

    cut = get_config(MLA_ARCH).with_(n_layers=DEEPSEEK_TRAIN_LAYERS)
    run("deepseek", _launcher_run, dev, MLA_ARCH, cut, **DEEPSEEK_TRAIN)
    run("jamba", _jamba_grads, dev)
    for arch, shape in SMALL_TRAIN.items():
        run(arch.split("_")[0], _launcher_run, dev, arch, get_config(arch), **shape)
    res = {"runs": {k: {x: v[x] for x in ("layers", "step_ms_p50", "train_tok_s", "mfu",
                                          "peak_gib", "launches_per_step")}
                    | {"first_loss": v["losses"][0], "last_loss": v["losses"][-1],
                       "device_idle_share": v["profile"]["device_idle_share"],
                       "backward_kernels_share": v["profile"]["backward_kernels_share"]}
                    for k, v in runs.items()},
           "launches": {"ssm_scan_bwd": round(runs["jamba"]["launches_per_step"]
                                              ["ssm_scan_bwd"] * JAMBA_PASSES),
                        "flash_attention_bwd": round(runs["deepseek"]["launches_per_step"]
                                                     ["flash_attention_bwd"]
                                                     * DEEPSEEK_TRAIN["steps"])}}
    emit("train_families", **res)
    return res


SHARDED_DECODE_ARCH = "stablelm_1_6b"
SHARDED_DECODE = dict(batch=4, prompt=64, steps=8, max_len=128)
SHARDED_MOE_TOKENS = (4, 512)
SHARDED_WS_BATCH = 4
# the checkpoint of the restore check: stablelm-1.6b cut to this depth, bf16
SHARDED_CKPT_LAYERS = 1


def _placed(params, mesh, specs):
    from repro_torch.distributed import sharding as shd

    return shd.device_put_tree(params, shd.tree_shardings(specs, params, mesh))


def _moe_int8_plain(p, cfg, x):
    """What the int8 dispatch computes without a mesh: routing on ``x``,
    the experts on each token row quantized (rowwise int8, ``_q8_rows``)
    and dequantized, the shared experts on ``x``; nothing dropped."""
    from repro_torch.models import moe as M
    from repro_torch.models.layers import mlp

    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    w, ids = M._routing(p, cfg, x2d)
    q8, scl = M._q8_rows(x2d)
    xh = (q8.float() * scl[:, None]).to(x.dtype)
    y = M._routed_sum(xh, w, ids, p["w_gate"], p["w_up"], p["w_down"]).to(x.dtype)
    if cfg.moe.n_shared > 0:
        y = y + mlp(p["shared"], x2d)
    return y.reshape(B, S, d)


def _sharded_moe(dev, mesh) -> dict:
    """``moe_ep`` at DeepSeek-V2-Lite-16B's MoE layer (published widths,
    float32) on the card mesh against the one-device ``moe_block``, with
    the bf16 (here: the model dtype) and the int8 dispatch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    base = get_config(MLA_ARCH).with_(dtype="float32")
    p = M.init_moe(L.Init(7, torch.float32, dev), base)
    ps = _placed(p, mesh, M.init_moe(L.SpecInit(), base))
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(SHARDED_MOE_TOKENS + (base.d_model,), generator=g, device=dev)
    out = {"widths": {"d": base.d_model, "experts": base.moe.n_experts,
                      "d_ff_expert": base.moe.d_ff_expert, "top_k": base.moe.top_k,
                      "n_shared": base.moe.n_shared, "tokens": list(SHARDED_MOE_TOKENS)}}
    for disp in ("bfloat16", "int8"):
        cfg = base.with_(moe=dataclasses.replace(base.moe, impl="ep", dispatch_dtype=disp))
        with shd.use_mesh(None):
            want = (M.moe_block(p, cfg, x) if disp == "bfloat16"
                    else _moe_int8_plain(p, cfg, x))
            plain_ms = time_ms(lambda: M.moe_block(p, cfg, x), groups=5, per_group=2)
        M.reset_ep_calls()
        got = M.moe_block(ps, cfg, x).full_tensor()
        calls = dict(M.EP_CALLS)
        err = float((got - want).abs().max())
        ep_ms = time_ms(lambda: M.moe_block(ps, cfg, x), groups=5, per_group=2)
        out[disp] = {"max_abs_err": err, "max_abs_out": float(want.abs().max()),
                     "tol": MODEL_TOL, "ep_calls": calls, "ep_ms": ep_ms,
                     "moe_block_ms": plain_ms}
        check(calls["ep_body"] == 1 and calls["fallback"] == 0,
              f"sharded moe ({disp}): the expert-parallel body did not run: {calls}")
        check(err <= MODEL_TOL, f"sharded moe ({disp}): {err} against the one-device block")
    return out


def _sharded_ws(dev, mesh) -> dict:
    """``mlp_ws_decode`` at stablelm-1.6b's widths (float32) on the card
    mesh against ``mlp``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L

    cfg = get_config(SHARDED_DECODE_ARCH).with_(dtype="float32")
    p = L.init_mlp(L.Init(9, torch.float32, dev), cfg.d_model, cfg.d_ff)
    ps = _placed(p, mesh, L.init_mlp(L.SpecInit(), cfg.d_model, cfg.d_ff))
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(SHARDED_WS_BATCH, 1, cfg.d_model, generator=g, device=dev)
    want = L.mlp(p, x)
    got = L.mlp_ws_decode(ps, cfg, x)
    err = float((got.full_tensor() - want).abs().max())
    check(err < MODEL_TOL, f"sharded mlp_ws_decode: {err} against mlp")
    check(shd.is_dtensor(got), "mlp_ws_decode under the mesh returned no DTensor")
    return {"max_abs_err": err, "d": cfg.d_model, "d_ff": cfg.d_ff}


def _sharded_decode(dev, mesh) -> dict:
    """stablelm-1.6b whole, float32, TF32 off: prefill and greedy decode
    with its weights ``device_put_tree``'d onto ``tree_shardings`` of the
    port's spec tree, against the unsharded run; the slot kernels must
    launch under the mesh.  Run twice: with the config's decode MLP, and
    with ``decode_mlp="ws"``, whose weight-stationary body must run at every
    decode step of every layer (without a mesh it is ``mlp``, so the same
    unsharded run is the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.models.zoo import param_specs

    cfg = get_config(SHARDED_DECODE_ARCH).with_(dtype="float32")
    s = SHARDED_DECODE
    params = init_params(cfg, 11, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (s["batch"], s["prompt"]), generator=g, device=dev)
    with shd.use_mesh(None):
        want, want_lg = _greedy(params, cfg, toks, None, s["steps"] + 1, s["max_len"])
    ps = _placed(params, mesh, param_specs(cfg))
    out = {"arch": cfg.name, "layers": cfg.n_layers, **s}
    for route in (cfg.decode_mlp, "ws"):
        c = cfg.with_(decode_mlp=route)
        ops.reset_launch_counts()
        L.reset_ws_calls()
        t0 = time.perf_counter()
        got, got_lg = _greedy(ps, c, toks, None, s["steps"] + 1, s["max_len"])
        run_s = time.perf_counter() - t0
        counts, ws = ops.launch_counts(), dict(L.WS_CALLS)
        tag = f"sharded stablelm decode (decode_mlp {route})"
        check(torch.equal(got, want), f"{tag}: greedy tokens differ from the unsharded run's")
        for name in SLOT_KERNELS:
            check(counts[name] > 0, f"{tag}: {name} never launched")
        ws_steps = s["steps"] * cfg.n_layers if route == "ws" else 0
        check(ws == {"ws_body": ws_steps, "fallback": 0},
              f"{tag}: weight-stationary MLP calls {ws}, expected {ws_steps} and no fallback")
        out[route] = {"tokens_equal": True,
                      "max_abs_logit_err": float((got_lg - want_lg).abs().max()),
                      "launches": {k: counts[k] for k in SLOT_KERNELS}, "ws_calls": ws,
                      "run_s": run_s}
    return out


def _sharded_compression(dev, mesh) -> dict:
    """``compressed_psum`` over the card mesh's ``data`` group (one rank):
    bit-equal to ``compress_decompress``'s ``x_hat``."""
    from repro_torch.distributed import compression as comp

    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(2048, 5632, generator=g, device=dev) * 1e-3
    got = comp.compressed_psum(x, mesh.get_group("data"))
    want, _ = comp.compress_decompress(x)
    check(torch.equal(got, want), "compressed_psum at world size 1 is not compress_decompress")
    return {"shape": list(x.shape), "bit_equal": True}


def _sharded_restore(dev, mesh) -> dict:
    """A checkpoint of sharded stablelm-1.6b weights (bf16, cut in depth)
    restored with ``shardings=`` onto the card mesh, leaves bit-equal."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import init_params
    from repro_torch.models.zoo import param_specs

    cfg = get_config(SHARDED_DECODE_ARCH).with_(n_layers=SHARDED_CKPT_LAYERS)
    params = init_params(cfg, 14, dev)
    sh = shd.tree_shardings(param_specs(cfg), params, mesh)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 3, shd.device_put_tree(params, sh))
        restored, step = ckpt.restore_checkpoint(d, like=params, shardings=sh)
    flat_r, flat_p = list(_leaves(restored)), list(_leaves(params))
    check(step == 3 and all(shd.is_dtensor(r) for r in flat_r),
          "sharded restore: not DTensors")
    check(all(torch.equal(r.to_local(), p) for r, p in zip(flat_r, flat_p)),
          "sharded restore: leaves differ")
    return {"leaves": len(flat_r), "layers": cfg.n_layers, "bit_equal": True,
            "gb": sum(p.numel() * p.element_size() for p in flat_p) / 1e9}


#: the mesh train step: stablelm-1.6b whole, float32, this batch (rows x
#: tokens); one copy of params, grads and AdamW state is ~26 GB
SHARDED_TRAIN_BATCH = (2, 256)
#: the scan on DTensors: Jamba-1.5-Large's layer widths (B, T, d_inner, N)
SHARDED_SCAN = (1, 1024, 16384, 16)
#: the kernels of the train step whose launches must match unsharded
SHARDED_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")


def _sharded_train(dev, mesh) -> dict:
    """stablelm-1.6b whole, float32, TF32 off: ``loss_and_grads`` and one
    ``build_train_step`` step with its weights on the card mesh (the
    port's spec tree), against both without a mesh: the loss, every
    gradient leaf (``_bwd_err``'s form), ``grad_norm`` and the updated
    params (``tests/test_torch_train.py``'s rule); the forward and backward
    kernels launched as many times under the mesh as without it."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.optimizer import OptConfig, init_opt_state
    from repro_torch.kernels import ops
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import init_params, zoo
    from repro_torch.models.zoo import param_specs

    t0 = time.perf_counter()
    cfg = get_config(SHARDED_DECODE_ARCH).with_(dtype="float32")
    B, S = SHARDED_TRAIN_BATCH
    opt = OptConfig(lr=1e-5, warmup_steps=1)
    batch = synthetic_batch(np.random.default_rng(0), cfg, B, S, device=dev)
    params = init_params(cfg, 15, dev)
    runs = {}
    for key in ("plain", "sharded"):
        # the plain run steps a copy; the sharded run, the placed weights
        p = _clone_tree(params) if key == "plain" else _placed(params, mesh, param_specs(cfg))
        with shd.use_mesh(None if key == "plain" else mesh):
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            loss, grads = zoo.loss_and_grads(p, cfg, batch)
            torch.cuda.synchronize()
            grad_s = time.perf_counter() - t1
            counts = {k: ops.launch_counts()[k] for k in SHARDED_TRAIN_KERNELS}
            t1 = time.perf_counter()
            _, _, m = zoo.build_train_step(cfg, opt)(p, init_opt_state(p, opt), batch)
            torch.cuda.synchronize()
            runs[key] = {"loss": float(loss), "step_loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                         "launches": counts, "grads": grads, "params": p,
                         "grad_s": grad_s, "step_s": time.perf_counter() - t1}
        del p, grads, m
        _free_card()
    del params
    plain, sh = runs["plain"], runs["sharded"]
    check(all(shd.is_dtensor(g) for g in _leaves(sh["grads"])),
          "sharded train: the gradients are not DTensors")
    grad_err = max(_bwd_err(g.full_tensor(), w, torch.float32, "sharded train grad")
                   for g, w in zip(_leaves(sh["grads"]), _leaves(plain["grads"])))
    del sh["grads"], plain["grads"]
    lr1, d_max, frac = plain["lr"], 0.0, 0.0
    for got, want in zip(_leaves(sh["params"]), _leaves(plain["params"])):
        d = (got.full_tensor() - want).abs()
        d_max, frac = max(d_max, float(d.max())), max(frac, float((d > 1e-5).float().mean()))
    del sh["params"], plain["params"]
    for k in ("loss", "step_loss", "grad_norm"):
        check(abs(sh[k] - plain[k]) <= 1e-5 * abs(plain[k]),
              f"sharded train: {k} {sh[k]} against {plain[k]}")
    check(d_max <= 2 * lr1 + 1e-5 and frac < 0.01,
          f"sharded train: params moved {d_max} apart ({frac} of a leaf past 1e-5)")
    check(sh["launches"] == plain["launches"] and all(sh["launches"].values()),
          f"sharded train: launches {sh['launches']} against {plain['launches']}")
    return {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "batch": [B, S], "dtype": "float32",
            "loss": sh["loss"], "loss_plain": plain["loss"],
            "grad_norm": sh["grad_norm"], "grad_norm_plain": plain["grad_norm"],
            "max_abs_grad_err": grad_err, "max_abs_param_err": d_max,
            "param_frac_past_1e-5": frac, "launches": sh["launches"],
            "launches_plain": plain["launches"], "grad_s": sh["grad_s"],
            "grad_s_plain": plain["grad_s"], "step_s": sh["step_s"],
            "step_s_plain": plain["step_s"], "run_s": time.perf_counter() - t0}


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _sharded_scan(dev, mesh) -> dict:
    """The scan's forward and backward on DTensors at Jamba-1.5-Large's
    layer widths (float32, h0 given) against the plain-tensor call on the
    card: y, h_T and the gradient of every input, ``ssm_scan`` and
    ``ssm_scan_bwd`` launched as often under the mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    B, T, D, N = SHARDED_SCAN
    args = _scan_inputs(np.random.default_rng(16), B, T, D, N, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(17)
    dy = torch.randn(B, T, D, generator=g, device=dev)
    dhT = 0.5 * torch.randn(B, D, N, generator=g, device=dev)
    rows = [Shard(0), Replicate()]
    runs = {}
    for key in ("plain", "sharded"):
        xs = [a.detach().clone().requires_grad_(True) for a in args]
        if key == "sharded":
            xs = [distribute_tensor(a.detach(), mesh, rows if a.dim() == 3 else
                                    [Replicate(), Replicate()]).requires_grad_(True)
                  for a in xs]
        ops.reset_launch_counts()
        y, hT = ops.ssm_scan(*xs[:6], h0=xs[6])
        if key == "sharded":
            check(shd.is_dtensor(y) and shd.is_dtensor(hT), "sharded scan: no DTensor out")
            y, hT = y.full_tensor(), hT.full_tensor()
        grads = torch.autograd.grad((y * dy).sum() + (hT * dhT).sum(), xs)
        grads = [gr.full_tensor() if shd.is_dtensor(gr) else gr for gr in grads]
        counts = {k: ops.launch_counts()[k] for k in ("ssm_scan", "ssm_scan_bwd")}
        runs[key] = (y.detach(), hT.detach(), grads, counts)
    (y0, h0_, g0, c0), (y1, h1, g1, c1) = runs["plain"], runs["sharded"]
    errs = {"y": _bwd_err(y1, y0, torch.float32, "sharded scan y", SSM_TOL),
            "h_T": _bwd_err(h1, h0_, torch.float32, "sharded scan h_T", SSM_TOL)}
    for name, a, b in zip(SCAN_GRADS, g1, g0):
        errs[name] = _bwd_err(a, b, torch.float32, f"sharded scan {name}", SSM_TOL)
    check(c1 == c0 and c1["ssm_scan_bwd"] > 0,
          f"sharded scan: launches {c1} against {c0}")
    return {"shape": {"B": B, "T": T, "D": D, "N": N}, "max_abs_err": errs,
            "launches": c1, "launches_plain": c0, "run_s": time.perf_counter() - t0}


def phase_sharded(dev) -> dict:
    """``sharded``: the port's sharded paths at world size 1 over NCCL, on
    a (data 1, model 1) mesh on the card, each against the unsharded path
    on the card: ``moe_ep`` at DeepSeek-V2-Lite-16B's MoE layer,
    ``mlp_ws_decode`` and a greedy decode of stablelm-1.6b whole, the
    compressed all-reduce, a resharding restore, the scan's forward and
    backward on DTensors at Jamba's widths, and a float32 train step of
    stablelm-1.6b whole (``_sharded_scan``, ``_sharded_train``)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        with shd.use_mesh(mesh):
            res = {"mesh": dict(shd.mesh_shape(mesh)), "backend": dist.get_backend(),
                   "moe": _sharded_moe(dev, mesh)}
            _free_card()
            res["mlp_ws_decode"] = _sharded_ws(dev, mesh)
            res["decode"] = _sharded_decode(dev, mesh)
            _free_card()
            res["compression"] = _sharded_compression(dev, mesh)
            res["restore"] = _sharded_restore(dev, mesh)
            _free_card()
            res["scan"] = _sharded_scan(dev, mesh)
            _free_card()
            res["train"] = _sharded_train(dev, mesh)
    finally:
        dist.destroy_process_group()
        import shutil

        shutil.rmtree(store, ignore_errors=True)
    res["run_s"] = time.perf_counter() - t0
    emit("sharded", **res)
    return res


# ---------------------------------------------------------------------------
# phase: dryrun (the dry run on shapes alone; the card against the roofline)
# ---------------------------------------------------------------------------
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k"), ("stablelm-1.6b", "prefill_32k"),
                ("stablelm-1.6b", "decode_32k"), ("deepseek-v2-lite-16b", "decode_32k"),
                ("jamba-1.5-large-398b", "prefill_32k"), ("xlstm-350m", "long_500k"))
DRYRUN_KEYS = ("arch", "shape", "variant", "mesh", "n_chips", "kind", "device", "lower_s",
               "extrapolated", "probes", "memory", "analytic_flops", "analytic_bytes",
               "traced_flops", "collectives", "collectives_per_superblock", "collective_bytes",
               "model_flops", "roofline", "useful_flops_ratio")
#: sharded cells whose every layer must move bytes: the row-parallel
#: products' partial sums are all-reduced over ``model``
DRYRUN_LAYER_MOVES = (("stablelm-1.6b", "train_4k"), ("stablelm-1.6b", "prefill_32k"))
DRYRUN_LIMIT_S = 240


def _dryrun_cells(src: Path) -> dict:
    """The dry run's cells, one process, no card (``CUDA_VISIBLE_DEVICES``
    empty): each record's keys checked, one line a cell."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--workers", "1",
               "--out", out, "--cells", ",".join(f"{a}:{s}" for a, s in DRYRUN_CELLS)]
        env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=DRYRUN_LIMIT_S)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"dryrun: rc {proc.returncode}: {proc.stdout[-2000:]} "
                                    f"{proc.stderr[-2000:]}")
        cells = {}
        for arch, shape in DRYRUN_CELLS:
            tag = f"{arch.replace('.', '_').replace('-', '_')}__{shape}__16x16"
            rec = json.loads((Path(out) / f"dryrun_{tag}.json").read_text())
            missing = [k for k in DRYRUN_KEYS if k not in rec]
            check(not missing and rec["device"] == "fake" and rec["n_chips"] == 256,
                  f"dryrun {arch} {shape}: keys missing {missing}")
            per = rec["collectives_per_superblock"]
            check((arch, shape) not in DRYRUN_LAYER_MOVES
                  or (per["count"] > 0 and per["all-reduce"] > 0),
                  f"dryrun {arch} {shape}: a layer adds no all-reduce: {per}")
            line = {k: rec[k] for k in ("arch", "shape", "mesh", "lower_s", "extrapolated",
                                        "collective_bytes", "traced_flops", "roofline")}
            line["arg_bytes_per_dev"] = rec["memory"]["analytic_arg_bytes_per_dev"]
            line["collectives"] = rec["collectives"]
            line["collectives_per_superblock"] = per
            emit("dryrun_cell", **line)
            cells[f"{arch} {shape}"] = line
    return {"wall_s": wall, "cells": cells}


def _roofline_s(cfg, kind: str, batch: int, seq: int, **kw) -> float:
    """max(compute, memory) of the analytic terms on one card, seconds."""
    from repro_torch.launch import roofline_model as RM
    from repro_torch.models.config import ShapeConfig

    shape = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
    hbm, peaks = card_rates()
    return max(RM.analytic_flops(cfg, shape) / peaks[torch.bfloat16],
               RM.analytic_bytes(cfg, shape, **kw) / hbm)


def phase_dryrun(trn, eng, tb) -> dict:
    """``dryrun``: the dry run's cells (``_dryrun_cells``), then the
    ``train``, ``engine`` and ``testbed`` phases' own times against the
    roofline of one card (a phase not run is left out)."""
    from repro_torch.configs import get_config
    from repro_torch.core import roofline_profile
    from repro_torch.kernels import _build

    res = _dryrun_cells(Path(_build.__file__).resolve().parents[2])
    cfg = get_config(TRAIN_ARCH)
    ratios = {}
    if trn is not None:
        # the port's trainer keeps its activations: no rematerializing pass
        plain = cfg.with_(remat="none")
        for sd, opt_bytes in (("float32", 8.0), ("int8", 2.0)):
            roof = _roofline_s(plain, "train", TRAIN_BATCH, TRAIN_SEQ,
                               opt_state_bytes_per_param=opt_bytes)
            ms = trn["runs"][sd]["step_ms_p50"]
            ratios[f"train {sd} state"] = {"measured_ms": ms, "roofline_ms": roof * 1e3,
                                           "ratio": ms / (roof * 1e3)}
    if eng is not None:
        run1 = eng["runs"][0]
        ctx = round(run1["prompt_tokens"] / run1["requests"] + 32 / 2)
        for b, ms in sorted(run1["l_b_ms"].items()):
            roof = _roofline_s(cfg, "decode", int(b), ctx)
            ratios[f"engine decode b={b}"] = {"measured_ms": ms, "roofline_ms": roof * 1e3,
                                              "ratio": ms / (roof * 1e3), "context": ctx}
    for name, r in ratios.items():
        check(r["ratio"] >= 1.0, f"dryrun: {name} measured below its roofline term: {r}")
    res["measured_over_roofline"] = ratios
    if tb is not None:
        l_b = {int(b): ms for b, ms in tb["llmsched"]["l_b_ms"][0].items()}
        ctx = TESTBED_SHARED_PROMPT + 2 + 15
        w_bytes = 2.0 * cfg.param_count()[0]
        kv = cfg.kv_bytes_per_token() * ctx
        hbm = card_rates()[0]
        overhead = min(ms / 1e3 - (w_bytes + b * kv) / hbm for b, ms in l_b.items())
        check(overhead >= 0, f"dryrun: a testbed step beat its bytes term: {l_b}")
        bare = roofline_profile(w_bytes, kv, step_overhead_s=0.0)
        fitted = roofline_profile(w_bytes, kv, step_overhead_s=overhead)
        res["testbed_l_b"] = {
            "context": ctx, "weight_bytes": w_bytes, "kv_bytes_per_request": kv,
            "step_overhead_s": overhead,
            "l_b_ms": {b: {"measured": ms, "roofline": bare.l(b) * 1e3,
                           "roofline_with_overhead": fitted.l(b) * 1e3}
                       for b, ms in sorted(l_b.items())}}
    emit("dryrun", **res)
    return res


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory instead of the "
                         "checkout's src/ (another tree, for a same-call A/B)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    check(set(phases) <= set(PHASES + EXTRA_PHASES), f"unknown phase in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build

    emit("src", path=str(Path(_build.__file__).resolve().parents[2]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    signal.signal(signal.SIGALRM, _stalled)
    dev = torch.device("cuda", 0)
    env = phase_env(_build)
    kern = phase_kernels(dev, env["backward_ptxas"]) if "kernels" in phases else None
    if "timing" in phases:
        phase_timing(dev)
    if "scan_bwd" in phases:
        phase_scan_bwd(dev)
    from repro_torch.configs import get_config

    held_cfg = get_config("stablelm_1_6b").with_(n_layers=2, dtype="float32")
    if "held" in phases:
        phase_held(dev, held_cfg)
    if "held_slot" in phases:
        phase_held_slot(dev, held_cfg)
    eng = tb = None
    if "engine" in phases:
        eng = phase_engine(dev, get_config("stablelm_1_6b"))
    if "testbed" in phases:
        tb = phase_testbed(dev, get_config("stablelm_1_6b"))
    if "held_hybrid" in phases:
        _free_card()
        phase_held_hybrid(dev)
    hyb = None
    if "hybrid" in phases:
        _free_card()     # the 66 GB model must not stack on earlier phases'
        hyb = phase_hybrid(dev)
    if "held_mla" in phases:
        _free_card()
        phase_held_mla(dev)
    if "mla" in phases:
        _free_card()
        phase_mla(dev)
    if "dense" in phases:
        phase_dense(dev)
    if "held_xlstm" in phases:
        _free_card()
        phase_held_xlstm(dev)
    if "xlstm" in phases:
        _free_card()
        phase_xlstm(dev)
    if "held_encdec" in phases:
        phase_held_encdec(dev)
    if "encdec" in phases:
        phase_encdec(dev)
    if "held_train" in phases:
        _free_card()
        phase_held_train(dev)
    trn = None
    if "train" in phases:
        _free_card()
        trn = phase_train(dev)
    fam = None
    if "train_families" in phases:
        _free_card()
        fam = phase_train_families(dev)
    if "sharded" in phases:
        _free_card()
        phase_sharded(dev)
    if "dryrun" in phases:
        phase_dryrun(trn, eng, tb)
    if all(x is not None for x in (kern, eng, tb, hyb, trn, fam)):
        # launches: the paged kernels' and RMSNorm's from the engine phase's
        # first run, the int8 paged kernels' from its third, the slot
        # kernels' from the testbed's LLMSched slot run, the scan's from the
        # hybrid phase's LLMEngine run, the backward kernels' from the train
        # phase's float32-state run
        launches = dict(eng["launches"])
        launches.update({k: tb["llmsched"]["launches"][k]
                         for k in ("flash_attention", "decode_attention")})
        launches.update({k: eng["launches_int8"][k] for k in PAGED_KERNELS["int8"][:2]})
        launches["ssm_scan"] = hyb["launches"]["ssm_scan"]
        # the trainer's kernels: the train phase's float32-state run; the
        # scan's backward: train_families' Jamba passes
        launches.update({k: trn["launches"][k] for k in ("flash_attention_bwd", "rmsnorm_bwd")})
        launches["ssm_scan_bwd"] = fam["launches"]["ssm_scan_bwd"]
        tc_launches = {"flash_attention": tb["llmsched"]["tc_launches"]["flash_attention"],
                       "paged_prefill_attention": eng["tc_launches"]["paged_prefill_attention"],
                       "paged_prefill_attention_int8":
                           eng["tc_launches_int8"]["paged_prefill_attention_int8"],
                       "flash_attention_bwd": trn["tc_launches"]["flash_attention_bwd"]}
        split_launches = {
            "decode_attention": tb["llmsched"]["split_launches"]["decode_attention"],
            "paged_decode_attention": eng["split_launches"]["paged_decode_attention"],
            "paged_decode_attention_int8":
                eng["split_launches_int8"]["paged_decode_attention_int8"]}
        summary = [
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name],
             **({"tc_launches": tc_launches[name]} if name in tc_launches else {}),
             **({"split_launches": split_launches[name]} if name in split_launches else {}),
             "max_abs_err": kern["max_abs_err"][name],
             **{k: kern["timing_bf16"][name][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                          "device_ms", "library_device_ms", "host_ms",
                          "other_body_host_ms", "cold_device_ms", "library_cold_device_ms",
                          "form")
                if k in kern["timing_bf16"][name]}}
            for name, (src, rep) in KERNEL_META.items()
        ]
        print(json.dumps({"kernels": summary}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
