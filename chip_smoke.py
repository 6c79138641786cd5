#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100: the MOSGU gossip round,
the model serving path (prefill forward + cached decode), the DFL training
step (4 stacked nodes, forward, the flash-attention and selective-scan
backwards, the optimizer and a gossip round), for every family: dense,
ssm, moe, hybrid, audio (whisper-tiny) and vlm (paligemma-3b), and the
launcher's sweep path (the codec x protocol grid on 10 nodes).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build   — nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a; prints
             the build time, ptxas's registers and spills for the
             tensor-core flash kernel at every head dim, the two passes of
             the flash backward (the tensor-core ones at hd 64, 112, 160 and
             256, the SIMT ones in f32 at hd 64), the scan and its backward
             (every x / dy type it is built for; a spill in the backward is a
             failure), the count of
             HGMMA (wgmma) instructions in the SASS of the forward's and the
             backward's objects (cuobjdump; none in either is a failure), and
             the card's name and power limit. hd 256 is gemma2's and
             paligemma-3b's head dim.
2. kernels — each Hopper kernel at the main path's shapes against its plain
             PyTorch version on the same inputs. Quantize / dequantize (int8,
             int4) and top-k (k = 13) at every (rows, size) that phase 3
             launches them with, found by a dry run of its scenarios at the
             proxy size on the card (rows = a step's senders; size = the
             scenario's payload: EfficientNet-B0's 5.3 M f32, MobileNetV2's
             3.5 M, smollm-360m's 180.9 M for mesh_smoke int8), and at every
             shape phase 5's whisper-tiny int8 dissemination launches them
             with (one round of its 4 nodes' seeded f32 masters on the card:
             a quantize a leaf, a dequantize a group of leaves a hop; the
             round must equal the same round leaf by leaf bit for bit, with
             groups x steps dequantize launches); dequantize at each group
             as one launch, beside the same leaves in single launches, the
             bound of the group's bytes and, where one call computes the
             same values (int8, leaves of whole chunks or one row of one
             leaf), torch.mul(codes, scales[:, None]) as the library time,
             and through its single-leaf entry point at each quantize shape;
             the FedAvg mix at (10, 10,
             5.3 M) and at whisper's leaf shapes. Quantize, dequantize and
             top-k must be bit-identical; the mix within rtol 1e-6 of
             max|x|. Prints each
             kernel's median time (CUDA events, L2 flushed before every
             launch by a write; for the codec kernels also from an L2 flushed
             by a read, with no dirty lines), its bound and the plain
             version's time; torch.topk on the |x| blocks beside top-k as a
             diagnostic. Flash attention
             at smollm-360m's prefill (4, 2048, 15 / 5 heads, 64) causal and
             gemma2-2b's (1, 8192, 8 / 4, 256) with window 4096 and softcap 50,
             in bf16 (the tensor-core kernel) within 2e-2 of the plain
             version and within BF16_UNITS_TOL rounding units of the f32
             attention (``attention.ref.rounding_units``: each element held
             to the scale its bf16 roundings can reach), a bf16 case on views
             into a fused qkv projection, gemma2's case with scores near the
             cap (q scaled by 25, rounding units only), and an f32 case (the
             SIMT kernel) within 2e-5 (the tolerances of tests/test_kernels.py;
             the sum order differs); SDPA's time beside the causal case; and
             at the moe configs' prefill shapes, qwen3-moe-30b-a3b's (2, 2048,
             32 / 4, 128) and arctic-480b's (1, 2048, 56 / 8, 128), causal bf16,
             timed beside SDPA; at stablelm-12b's prefill (2, 2048, 32 / 8,
             160) and zamba2-7b's (2, 2048, 32 / 32, 112) and at their
             training batch of 1, the head dims the kernels pad to whole
             slabs inside, causal bf16 timed beside SDPA, a bf16 case on fused-qkv views at hd 160 and f32 cases at
             hd 160 and 112; whisper-tiny's attentions, non-causal over its
             1500 frames (the last key tile ragged) in the encoder (8, 1500,
             6 / 6, 64) and from its 448 text positions in the
             cross-attention, and causal in the decoder (8, 448), with an f32
             case of the cross-attention, and the same three at phase 6's
             batch of 2 a node (each keyed by its launch shape, so phase 6
             fails on a flash shape that was not held and timed here); paligemma-3b's two calls of the
             prefix split (MQA 8 / 1 at hd 256) at its prefill (2, 2304) and
             training (1, 2304) batches, causal over every row and
             non-causal over the 256 patches; each timed beside SDPA. The
             selective scan at falcon-mamba-7b's
             (1, 2048, 8192, 16) and at its prefill batch (2, 2048, 8192, 16),
             x bf16, y f32, within 1e-4 of max|y| of the plain version.
             The flash forward with and without its LSE output at smollm's
             prefill shape and at its training batch of 2 (bit-identical
             outputs, both timed, and aten's flash attention, which also
             returns the LSE, timed beside them), and the flash
             backward against ``attention_bwd_ref`` at smollm-360m's
             training shape (2, 2048, 15 / 5, 64) causal in bf16 and f32,
             gemma2-2b's (1, 8192, 8 / 4, 256) with window 4096 and softcap
             50 in bf16, an hd-128 case (2, 2048, 16 / 8, 128) causal in
             bf16, qwen3-moe's training shape (1, 2048, 32 / 4, 128) and
             stablelm-12b's (1, 2048, 32 / 8, 160) and zamba2-7b's (1, 2048,
             32 / 32, 112) causal in bf16, whisper-tiny's training shapes
             (encoder (8, 1500) and cross-attention 448 x 1500 non-causal,
             decoder (8, 448) causal; and the same three at phase 6's batch
             of 2 a node, as the forward's are) and paligemma-3b's (1, 2304, 8 / 1,
             256) causal and (1, 256, 8 / 1, 256) non-causal (GQA 8:1 sums 8
             query heads into one dK / dV block): each of dQ, dK and dV within
             BWD_F32_TOL (f32) or
             BWD_BF16_TOL (bf16) of its max |g|, two runs bit-identical;
             its time, its bound and the backward of SDPA (autograd,
             causal, GQA) beside it. The scan's backward against
             ``selective_scan_bwd_ref`` at falcon-mamba-7b's training shape
             (1, 2048, 8192, 16) and at b = 2 (x bf16, dy f32; timed, L2
             flushed, with its bound, the plain version's time and, as a
             diagnostic, autograd through the plain forward: no single
             PyTorch call computes it), at a ragged length (2000) with a
             non-zero gradient of the last state and at n = 32 (x f32):
             every gradient within SCAN_BWD_TOL of its max |g| (a bf16 dx
             within SCAN_BWD_BF16_TOL), two runs bit-identical; the forward
             timed with and without its chunk states, y bit-identical; and at
             the training shape from Mamba's initialization (dt log-uniform
             in [1e-3, 1e-1], A = -(1 .. n)), where states live long enough
             that an error in the carries between segments and chunks shows.
3. path    — the scenarios at full width through ``run_scenario``, with the
             launch counts set to 0 just before and read just after:
             paper_table3 (fp32), quantized_table3 (int8) and an int4
             variant, topk_sweep (3 rounds), mesh_smoke (tree all-reduce with
             churn, 180.9 M f32 a node) and an int8 variant. Every round must
             report numerics_ok (None for top-k, which has no deterministic
             bound), finite outputs and the exact bytes on the wire; every
             gossip kernel must have launched, and every shape a codec
             kernel launched with must have been timed in phase 2. Prints
             each gossip kernel's launches by shape and each codec kernel's
             loss, the sum over shapes of launches x (time - bound).
4. serve   — smollm-360m (32 layers, d 960), falcon-mamba-7b (64 layers,
             d 4096), qwen3-moe-30b-a3b (48 layers, d 2048, 128 experts,
             60.4 GB), stablelm-12b (40 layers, d 5120, 23.3 GB) and
             zamba2-7b (81 layers: 13 super-blocks of 5 Mamba2 blocks and the
             shared attention block, then 3 Mamba2 blocks; d 3584, 11.2 GB)
             at full width and depth, and arctic-480b at full width
             and 1 of its 35 layers (26.8 GB of experts), in bf16, params
             from Model.init on the card (seed 0; stacked leaves filled in
             place), with the launch counts set to 0 just before and read
             just after: three prefill forwards over (4, 2048), (2, 2048),
             (2, 2048) and (1, 2048) tokens (the first a warm-up), then the
             serve loop at the reference CLI's defaults (batch 4, prompt 32,
             gen 16, cache 128) or, for arctic, 8 decode steps. Every logit
             finite; flash_attention launched once a dense or moe layer or a
             use of the hybrid's shared block and selective_scan once a
             Mamba1 layer per forward, the other model kernel never; zamba2's
             Mamba2 blocks' share of its prefill (one block timed alone at
             the prefill shape, times the blocks). Prints prefill ms
             and tok/s, decode ms/step and tok/s and peak memory, and the
             device time of one decode step replayed as a CUDA graph (not
             arctic). Then, in f32 at full width, 4 layers (2 for qwen3-moe,
             capacity factor 100 as tests/test_models.py decodes moe archs;
             13 for zamba2: two super-blocks and a tail block, so the shared
             block's decode cache is used twice),
             forward logits against teacher-forced decode logits over a
             256-token prompt, within 5e-2 (the bound of tests/test_models.py).
             whisper-tiny (4 encoder and 4 decoder layers, d 384, 39 M
             params) and paligemma-3b (18 layers, d 2048, MQA 8 / 1 at hd
             256, 2.5 B params) at full width and depth the same way, from
             frames (8, 1500, 384) and tokens (8, 448), and patches (2, 256,
             2048) and tokens (2, 2048): 12 flash forwards a whisper forward
             (4 encoder, 4 self, 4 cross), 36 a paligemma one (the prefix
             split's two a layer); whisper's decode step launches the flash
             kernel for each layer's cross-attention, eagerly and in the
             CUDA graph it captures (the serve loop's cross cache is zero, as
             the reference CLI leaves it: ROADMAP R10). The f32 check runs
             whisper at full depth with the cross cache filled from the
             encoder output (as tests/test_models.py's _fill_whisper_cross),
             and paligemma at 4 layers with no patches.
5. train   — smollm-360m at full width and depth (32 layers, d 960, 15 / 5
             heads, vocab 49152, bf16 params, AdamW with fp32 masters), N = 4
             nodes stacked on the card, DataConfig(seq_len=2048,
             batch_per_node=2, n_nodes=4, seed=0), lr 1e-3, warmup 0, no
             remat; the launch counts set to 0 just before each run and read
             just after: dissemination with the int8 codec for 2 steps,
             dissemination with top-k and error feedback for 2 steps
             (codec_ef must change), then tree_allreduce for 4 steps on one
             fixed batch (the first a warm-up; the third loss below the
             first; after every step each node's masters within the
             runner's mean tolerance of the nodes' FedAvg; the fourth, the
             last of the run, under torch.profiler, its device time
             printed by group — flash forward, flash backward, GEMMs,
             elementwise / other, optimizer, gossip — with the device's
             idle share of the step). Every loss and grad norm finite; every
             step launches flash_attention and flash_attention_bwd 32 x N
             times; every gossip kernel launches in the codec runs. Prints
             each step's time by host clock, synchronized, split into the
             nodes' forward + backward, the optimizer and the gossip, with
             tokens/s, the losses and the peak memory. Then, in f32 at 4
             layers and full width, every leaf's training gradient through
             the kernels within 1e-3 of its max |g| of the gradient through
             the plain versions on the card. The same for qwen3-moe-30b-a3b
             at full width and 1 of its 48 layers, batch_per_node=1, AdamW
             with fp32 masters and bf16 moments: int8 dissemination for 2
             steps, then tree_allreduce for 4 (the fourth profiled); a step
             launches the flash forward twice a layer a node (the routing
             pass of the global-batch aux loss, then the differentiated
             pass) and the backward once, and both passes must route alike;
             the f32 gradient check at 1 layer over (1, 2048) tokens. The same
             at lr 3e-4 (1e-3 overshoots at d >= 2048) for stablelm-12b at
             full width and 1 of its 40 layers and zamba2-7b at full width
             and 7 layers (one super-block and a tail block), 4 nodes x (1,
             2048), AdamW with fp32 masters and bf16 moments: tree_allreduce
             for 4 steps (the fourth profiled), one flash forward and one
             backward a node a step (the one attention layer, the one use of
             the shared block), no selective_scan; the f32 gradient check at
             1 layer (stablelm) and 13 (zamba2: the shared block's gradient
             sums over two uses). Then whisper-tiny at full width and depth,
             4 nodes x (8, 448) tokens with seeded frames (8, 1500, 384) a
             node, lr 3e-4: int8 dissemination for 2 steps (its codec and mix
             shapes timed in phase 2; their launches join phase 3's; every
             int8 run's steps print their dequantize launches, which must be
             the round's leaf groups x its steps; smollm-360m's and
             qwen3-moe's int8 runs first hold each of their dequantize
             groups to the plain version bit for bit and time it, as phase 2
             does, and their dequantize launches join row 2's), then
             tree_allreduce for 4 (the fourth profiled), 12 flash forwards
             and backwards a node a step; and paligemma-3b at full width and
             1 of its 18 layers (0.64 B params a node, f32 moments, its
             config's), 4 nodes x (1, 2048) tokens with patches (1, 256,
             2048), lr 3e-4: tree_allreduce for 4 steps (the fourth
             profiled), 2 flash forwards and backwards a node a step (no
             dissemination: the (N, N, P) f32 buffer of its 527 M embedding
             alone would be 34 GB). The
             f32 gradient checks: whisper at full depth, paligemma at 1 layer
             with its patches. Then falcon-mamba-7b at full width (d 4096,
             di 8192, n 16, vocab 65024) and 2 of its 64 layers, 4 nodes x
             (1, 2048), AdamW with fp32 masters and its config's bf16
             moments, lr 3e-4: tree_allreduce for 4 steps (the fourth
             profiled, the scan's kernels a group of their own), every step
             launching selective_scan and selective_scan_bwd once a layer a
             node and no flash kernel (the backward's launches, at the
             training shape phase 2 timed, give its loss: launches x (time -
             bound)) (tree rounds only; the (N, N, P) f32
             dissemination buffer of its 0.48 B params a node, 30.5 GB, is
             printed); the
             f32 gradient check at 1 layer over (1, 2048) tokens, the plain
             scan differentiated by autograd as the reference.
6. sweep   — the launcher's sweep path (``repro_torch.launch.train``):
             ``--sweep codec_x_protocol`` prints its dry table, which must
             equal the reference launcher's lines; then each of its 10 cells
             (fp32, bf16, int8, int4, top-k x dissemination, segmented) and
             ``async_vs_sync`` cell 6 (flooding, 8 rounds) trains through
             ``main([... --sweep NAME --cell K])`` at whisper-tiny's full
             width and depth on 10 stacked nodes x (2, 448) tokens (zero
             frames, as the launcher makes them), the session planning over
             the cell's ER(10) overlay, the default lr and warm-up, remat as
             the config has it, the launch counts set to 0 just before each
             cell and read just after. Every loss and grad norm finite; the
             flash forward 2 x 12 x 10 times a round (each layer's forward
             runs again in the backward under remat) and the backward 12 x
             10; the cell's codec kernels and the mix launched and no other
             gossip kernel (fp32 and bf16: the mix alone). Every shape at
             which a cell launches a gossip kernel was found in phase 2 by a
             dry round of each cell's trainer and held there against the
             plain version (bit for bit; the mix within 1e-6 of max|x|) and
             timed; its launches join rows 1-4's and their loss. Every
             shape at which a cell launches the flash forward or backward
             must be one phase 2 held and timed at whisper's batch of 2; the
             launches join those rows and give their loss. Prints each
             cell's launches by kernel and shape, losses, round times (host
             clock, synchronized) and peak memory. Then one round of each
             cell from seeded unequal nodes (``scenario.runner.fedavg_check``):
             every live node's masters within the scenario runner's
             tolerance for the codec of the FedAvg of the masters the same
             round leaves with its gossip off (top-k: finite only); and, as
             the negative control, the same check with the trainer's gossip
             stubbed out must fail for every cell with a bound (fp32, bf16,
             int8, int4). Prints the worst |masters - FedAvg| of both.

Then the card's name and power limit, one JSON line with every kernel's
numbers (the codec kernels' and the scan backward's also by shape, with
their loss; the scan's
forward with and without its chunk states; the scan backward's autograd
diagnostic), and the result line. Exits non-zero without a CUDA device, and when
run from a directory that holds nothing of the repository but this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate, the f32 rate outside the tensor cores and
# the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
GOSSIP_KERNELS = ("quantize", "dequantize", "topk_select", "gossip_mix")
# the kernels whose phase-6 launches are held to the shapes phase 2 timed
SHAPED_KERNELS = (*GOSSIP_KERNELS, "flash_attention", "flash_attention_bwd")
CODEC_KERNELS = ("quantize", "dequantize", "topk_select")
MODEL_KERNELS = ("flash_attention", "selective_scan")

# phase 6: the codec x protocol grid and one flooding cell, each trained by
# the launcher at whisper-tiny's full width and depth on 10 stacked nodes
# (the cell's own ER(10) overlay), Whisper's 448-token text context, the
# default lr and warm-up
SWEEP_NODES = 10
SWEEP_BPN = 2
SWEEP_ARGS = ["--arch", "whisper-tiny", "--nodes", str(SWEEP_NODES), "--seq-len", "448",
              "--batch-per-node", str(SWEEP_BPN)]
# whisper-tiny's attentions at that batch, as each node's forward and
# backward call them: (b, s, s_kv, h, kv, hd, causal) for the encoder over
# its 1500 frames, the cross-attention and the decoder's self-attention
SWEEP_FLASH = ((SWEEP_BPN, 1500, 1500, 6, 6, 64, False), (SWEEP_BPN, 448, 1500, 6, 6, 64, False),
               (SWEEP_BPN, 448, 448, 6, 6, 64, True))
SWEEP_RUNS = [SWEEP_ARGS + ["--sweep", "codec_x_protocol", "--cell", str(k)]
              for k in range(10)] + [SWEEP_ARGS + ["--sweep", "async_vs_sync", "--cell", "6"]]
# the reference launcher's dry table of the grid (tests/test_torch_sweep.py
# holds the port's lines to the reference's on the CPU)
SWEEP_TABLE = [
    "sweep 'codec_x_protocol': 10 cells (pass --cell K to train one)",
    "  [  0] codec=fp32,protocol=dissemination        tx=    90 wire=    1908.0MB",
    "  [  1] codec=fp32,protocol=segmented            tx=   360 wire=    1908.0MB",
    "  [  2] codec=bf16,protocol=dissemination        tx=    90 wire=     954.0MB",
    "  [  3] codec=bf16,protocol=segmented            tx=   360 wire=     954.0MB",
    "  [  4] codec=int8,protocol=dissemination        tx=    90 wire=     478.9MB",
    "  [  5] codec=int8,protocol=segmented            tx=   360 wire=     478.9MB",
    "  [  6] codec=int4,protocol=dissemination        tx=    90 wire=     240.4MB",
    "  [  7] codec=int4,protocol=segmented            tx=   360 wire=     240.4MB",
    "  [  8] codec=topk,protocol=dissemination        tx=    90 wire=     193.8MB",
    "  [  9] codec=topk,protocol=segmented            tx=   360 wire=     193.8MB",
]
# the gossip kernels a cell's codec must launch, and must not
CELL_KERNELS = {"fp32": ("gossip_mix",), "bf16": ("gossip_mix",),
                "int8": ("quantize", "dequantize", "gossip_mix"),
                "int4": ("quantize", "dequantize", "gossip_mix"),
                "topk": ("topk_select", "gossip_mix")}


def attention_layers(cfg) -> int:
    """The flash calls a forward makes: one a dense or moe layer, a use of
    the hybrid's shared block or a whisper encoder layer, two a whisper
    decoder layer (self and cross) or a paligemma layer with patches (the
    prefix split), none in an attention-free stack."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    if cfg.family == "vlm":
        return 2 * cfg.n_layers
    return cfg.n_layers


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def print_kernel_resources(build_dir: Path) -> None:
    """ptxas's registers and spills for the redesigned kernels (from the
    build log), and the HGMMA instructions in the two flash objects' SASS."""
    log = (build_dir / "nvcc.log").read_text().splitlines()
    kernels = ("flash_tc_kernel", "scan_kernel", "scan_bwd_kernel", "bwd_tc_kernel",
               "bwd_d_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel")
    for i, line in enumerate(log):
        if "Compiling entry function" in line and any(k in line for k in kernels):
            name = line.split("'")[1]
            kernel = next(k for k in kernels if k in name)
            args = name.split(kernel, 1)[1].split("EEv")[0]
            # the backward as phase 2 runs it: the tensor-core passes at hd 64,
            # 112, 160 and 256, the SIMT ones in f32 at hd 64
            if kernel.startswith("bwd_") and args not in ("ILi64E", "ILi112E", "ILi160E",
                                                          "ILi256E", "ILi64Ef"):
                continue
            info = " | ".join(x.split(":", 1)[-1].strip() for x in log[i + 2:i + 4])
            who = " (gemma2's and paligemma-3b's hd 256)" if "ILi256E" in args else ""
            print(f"[build] ptxas {kernel} {args}{who}: {info}")
            if kernel == "scan_bwd_kernel" and "0 bytes spill stores, 0 bytes spill loads" \
                    not in info:
                fail(f"ptxas: scan_bwd_kernel {args} spills: {info}")
    objdump = Path("/usr/local/cuda/bin/cuobjdump")
    if not objdump.is_file():
        print("[build] SASS check: cuobjdump not in the toolkit, not run")
        return
    for obj in ("flash_attention.o", "flash_attention_bwd.o"):
        sass = subprocess.run([str(objdump), "--dump-sass", str(build_dir / obj)],
                              capture_output=True, text=True, timeout=120).stdout
        n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
        print(f"[build] SASS check: {n_hgmma} HGMMA instructions in {obj} (cuobjdump)")
        if n_hgmma == 0:
            fail(f"the bf16 kernels of {obj} issue no HGMMA")


# device-time groups of a profiled training step, by kernel name
STEP_GROUPS = ("flash forward", "flash backward", "scan forward", "scan backward", "GEMMs",
               "elementwise/other", "optimizer", "gossip")


def kernel_group(name: str) -> str:
    n = name.lower()
    if "scan_bwd" in n:  # the backward and its finishing launch
        return "scan backward"
    if "scan_kernel" in n:
        return "scan forward"
    if "bwd_tc_kernel" in n or "bwd_d_kernel" in n:
        return "flash backward"
    if "flash" in n:
        return "flash forward"
    if re.search(r"gemm|xmma|nvjet|cutlass|cublas", n):
        return "GEMMs"
    return "elementwise/other"


def profile_step(trainer, state, batch):
    """One train step under torch.profiler, its three phases labelled; the
    trainer (timed) synchronizes between them, so each phase's device work
    lies inside its span. Returns the step's state and metrics, the device
    ms by group (the optimizer's and the gossip's kernels by the phase that
    ran them, the rest by name), kernel counts by group, the device's busy
    ms (the union of its kernels' spans) and the step's span in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def labelled(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run

    opt = trainer.opt
    trainer.grads = labelled("phase:fwd_bwd", trainer.grads)
    trainer.gossip = labelled("phase:gossip", trainer.gossip)
    trainer.opt = dataclasses.replace(opt, update=labelled("phase:optimizer", opt.update))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, m = trainer.train_step(state, batch)
            torch.cuda.synchronize()
    finally:
        del trainer.grads, trainer.gossip
        trainer.opt = opt
    events = prof.events()
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("phase:") and e.device_type == DeviceType.CPU}
    if len(spans) != 3:
        fail(f"profiled step: phases found {sorted(spans)}")
    # the device's kernels, memcpys and memsets; the record_function ranges
    # also appear on the device's timeline (user annotations) and are not work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and not e.name.startswith("phase:")]
    ms, count = Counter(), Counter()
    # the trainer synchronizes after each phase, so a phase's device work
    # ends before the next phase's host span begins: a kernel belongs to the
    # phase whose host span began last before it started
    opt_start, gossip_start = spans["phase:optimizer"][0], spans["phase:gossip"][0]
    lo = spans["phase:fwd_bwd"][0]
    hi = max([spans["phase:gossip"][1]] + [e.time_range.end for e in device])
    intervals = []
    for e in device:
        start, end = e.time_range.start, e.time_range.end
        group = ("gossip" if start >= gossip_start else "optimizer" if start >= opt_start
                 else kernel_group(e.name))
        ms[group] += (end - start) / 1e3
        count[group] += 1
        intervals.append((max(start, lo), min(end, hi)))
    busy, edge = 0.0, lo
    for start, end in sorted(intervals):
        if end > edge:
            busy += end - max(start, edge)
            edge = end
    return state, m, ms, count, busy / 1e3, (hi - lo) / 1e3


def frontend_inputs(cfg, rows, gen):
    """The stubbed frontends' inputs, seeded normal f32 on the generator's
    device: whisper's encoder frames, paligemma's patches, none otherwise."""
    import torch

    if cfg.family == "audio":
        return {"encoder_frames": torch.randn((rows, cfg.n_frames, cfg.d_model), generator=gen,
                                              device=gen.device)}
    if cfg.family == "vlm":
        return {"patch_embeddings": torch.randn((rows, cfg.n_patches, cfg.d_model),
                                                generator=gen, device=gen.device)}
    return {}


def fill_whisper_cross(model, params, frames, cache):
    """tests/test_models.py's ``_fill_whisper_cross``: the encoder over
    ``frames`` (its own loop over the encoder layers, bidirectional
    self-attention with rope), its final norm, then each decoder layer's
    cross K and V, as a prefill would leave them in the decode cache."""
    import torch

    from repro_torch.models import attention as attn_model
    from repro_torch.models import mamba as mamba_model
    from repro_torch.models.layers import mlp, rms_norm
    from repro_torch.models.model import _layer

    cfg = model.cfg
    x = frames.to(model.dtype)
    b, f, _ = x.shape
    fpos = torch.arange(f, device=x.device).expand(b, f)
    for i in range(cfg.n_encoder_layers):
        block = _layer(params["enc_blocks"], i)
        x = x + attn_model.attention(block["attn"], rms_norm(x, block["ln1"]), fpos,
                                     causal=False, rope_theta=cfg.rope_theta)
        x = x + mlp(block["mlp"], rms_norm(x, block["ln2"]))
    enc = rms_norm(x, params["enc_final_norm"])
    cross = params["blocks"]["cross"]
    kc = torch.stack([attn_model.project_heads(enc, w) for w in cross["wk"]])
    vc = torch.stack([attn_model.project_heads(enc, w) for w in cross["wv"]])
    return dict(cache, cross_k=kc.to(cache["cross_k"].dtype),
                cross_v=vc.to(cache["cross_v"].dtype))


def count_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_elements(v) for v in tree.values())
    return tree.numel()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from repro_torch.compress import make_codec, per_send_wire_mb
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (KERNEL_NAMES, _build, launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.kernels.attention.flash import flash_attention, flash_attention_bwd
    from repro_torch.kernels.attention.ops import flash_attention_op
    from repro_torch.kernels.attention.ref import (BF16_UNITS_TOL, BWD_BF16_TOL, BWD_F32_TOL,
                                                   attention_bwd_ref, attention_lse_ref,
                                                   attention_ref, rounding_units)
    from repro_torch.kernels.codec import ref as codec_ref
    from repro_torch.kernels.codec.group import group_layout
    from repro_torch.kernels.codec.ops import (dequantize_group_op, dequantize_op, quantize_op,
                                               topk_select_op)
    from repro_torch.kernels.mixing.ops import gossip_mix_op
    from repro_torch.kernels.mixing.ref import gossip_mix_ref
    from repro_torch.kernels.scan.mamba_scan import mamba_selective_scan, selective_scan_bwd
    from repro_torch.kernels.scan.ops import selective_scan_op
    from repro_torch.kernels.scan.ref import (SCAN_BWD_BF16_TOL, SCAN_BWD_TOL,
                                              selective_scan_bwd_ref, selective_scan_ref)
    from repro_torch.data import DataConfig, FederatedData
    from repro_torch.dfl.collectives import (GossipPlan, gossip_exchange, hop_groups,
                                             tree_flatten, tree_map)
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer
    from repro_torch.launch import train as launcher
    from repro_torch.launch.serve import serve
    from repro_torch.models import Batch, build_model
    from repro_torch.models import attention as attn_model
    from repro_torch.models import mamba as mamba_model
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.mamba import mamba2_forward
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.scenario import SCENARIOS, run_scenario
    from repro_torch.scenario.runner import fedavg_check

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = smi_line()

    # -- 1. build ---------------------------------------------------------------
    build_s = _build.build()
    _build.lib()
    print(f"[build] nvcc {build_s:.1f} s for {len(_build.sources())} sources "
          f"(sm_90a) -> {_build.build_dir().relative_to(ROOT)}")
    print_kernel_resources(_build.build_dir())
    print(f"[card] {smi}")

    # -- 2. kernels against their plain versions ------------------------------------
    # > 50 MB L2; freed after phase 2, made again to time phase 5's groups
    flush = [torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)]

    def median_ms(fn, iters, cold=True, clean=False):
        """cold: the L2 flushed before each launch, by writing (dirty lines
        stay, as a gossip step leaves them) or, with clean, by reading."""
        fn()
        torch.cuda.synchronize()
        spans = []
        for _ in range(iters):
            if clean:
                flush[0].sum()
            elif cold:
                flush[0].zero_()
            torch.cuda._sleep(2_000_000)  # the card stays busy while the host enqueues
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in spans)

    gen = torch.Generator(device=dev).manual_seed(0)
    b0 = int(round(21.2e6 / 4))   # EfficientNet-B0 payload, f32 elements
    results = {}
    shape_rows = {}  # kernel -> launch shape -> its row in results

    def record(name, route_src, replaces, err, tol, ms, plain_ms, n_bytes, n_ops,
               library_ms=None, shape="", ops_per_s=F32_OPS_PER_S, key=None, clean_ms=None):
        b_ms, b_by = bound_ms(n_bytes, n_ops, ops_per_s)
        if tol is not None and not err <= tol:  # None: the caller held it
            fail(f"{name}: max |kernel - plain| = {err} > {tol}")
        entry = results.setdefault(name, dict(
            name=name, route="cuda", source=route_src, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms))
        if key is not None:  # one of the main path's launch shapes
            row = dict(shape=list(key), launches=0, ms=ms, bound_ms=b_ms, plain_ms=plain_ms,
                       library_ms=library_ms, clean_l2_ms=clean_ms)
            entry.setdefault("shapes", []).append(row)
            shape_rows.setdefault(name, {})[key] = row
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        clean = "" if clean_ms is None else f" ({clean_ms:.4f} ms from a clean L2)"
        tol_s = "" if tol is None else f" (tol {tol})"
        print(f"[kernel] {name}{shape}: {ms:.4f} ms{clean} (bound {b_ms:.4f} ms by {b_by}), "
              f"plain {plain_ms:.4f} ms{lib}; max_abs_err {err}{tol_s} on {card}")

    # the codec kernels at every shape the main path (phase 3) gives them: a
    # dry run of its scenarios at the proxy size on the card yields each
    # launch's rows (the plan's senders in a step, whatever the payload), and
    # the scenario's payload its size
    base = SCENARIOS
    runs = [base["paper_table3"], base["quantized_table3"],
            base["quantized_table3"].replace(name="quantized_table3_int4", codec="int4"),
            base["topk_sweep"], base["mesh_smoke"],
            base["mesh_smoke"].replace(name="mesh_smoke_int8", codec="int8")]
    path_shapes = {name: Counter() for name in CODEC_KERNELS}
    for spec in runs:
        reset_launches()
        run_scenario(spec, device="cuda", seed=1, proxy_elems=4)
        elems = int(round(spec.payload_mb() * 1e6 / 4))
        for name in CODEC_KERNELS:
            for key, n in launch_shapes()[name].items():
                # a round's one leaf: dequantize's key holds the group's sizes
                size = (elems,) if name == "dequantize" else elems
                path_shapes[name][(key[0], size, *key[2:])] += n
    for name in CODEC_KERNELS:
        print(f"[kernel] {name}: the main path's launch shapes "
              f"{sorted(path_shapes[name].items())} (dry run at the proxy size)")
    # phase 5's whisper-tiny int8 dissemination: one payload a leaf of the 4
    # nodes' f32 masters, the leaves hopped in groups (one dequantize a group
    # a hop); a round at the real leaf sizes, on seeded masters, must equal
    # the same round leaf by leaf (the per-leaf hop), bit for bit
    whisper_masters = tree_map(
        lambda t: t.float().expand(4, *t.shape) + 0.01 * torch.randn(
            (4, *t.shape), generator=gen, device=dev),
        build_model(get_arch("whisper-tiny"), device="cuda").init(
            torch.Generator(device=dev).manual_seed(0)))
    whisper_plan, int8 = GossipPlan.build(4), make_codec("int8")
    reset_launches()
    grouped = gossip_exchange("dissemination", whisper_plan, whisper_masters, codec=int8)
    whisper_shapes = launch_shapes()
    leaves = tree_flatten(whisper_masters)[0]
    groups = hop_groups("dissemination", whisper_plan, leaves, int8)
    if sum(whisper_shapes["dequantize"].values()) != len(groups) * len(whisper_plan.diss_steps):
        fail(f"whisper-tiny int8 round: {whisper_shapes['dequantize']} dequantize launches, "
             f"expected {len(groups)} groups x {len(whisper_plan.diss_steps)} steps")
    for got, leaf in zip(tree_flatten(grouped)[0], leaves):
        alone = gossip_exchange("dissemination", whisper_plan, {"x": leaf}, codec=int8)["x"]
        if not torch.equal(got, alone):
            fail("whisper-tiny int8 round: the grouped hop differs from the leaf-by-leaf hop")
    print(f"[kernel] whisper-tiny int8 dissemination round (4 nodes' f32 masters, {len(leaves)} "
          f"leaves in {len(groups)} groups {[len(g) for g in groups]}, "
          f"{len(whisper_plan.diss_steps)} steps): equal to the leaf-by-leaf round bit for bit; "
          f"{sum(whisper_shapes['dequantize'].values())} dequantize launches (a launch a leaf a hop: "
          f"{len(leaves) * len(whisper_plan.diss_steps)}); quantize "
          f"{sorted(whisper_shapes['quantize'].items())}, gossip_mix "
          f"{sorted(whisper_shapes['gossip_mix'].items())}")
    del whisper_masters, grouped, leaves, got, alone
    for name in ("quantize", "dequantize"):
        path_shapes[name].update(whisper_shapes[name])
    # phase 6's cells: one dry gossip round of each cell's trainer as the
    # launcher builds it (the session's plan over the cell's ER(10) overlay,
    # the masters the step gossips, top-k's error feedback) yields every
    # shape at which its training round launches a gossip kernel
    sweep_shapes = {name: Counter() for name in GOSSIP_KERNELS}
    for argv in SWEEP_RUNS:
        args = launcher.parse_args(argv)
        with contextlib.redirect_stdout(io.StringIO()):
            _, spec = launcher.resolve_scenario(args)
        run = launcher.build_run(args, spec)
        run.session._ensure_plan()
        reset_launches()
        run.trainer.gossip(run.state.params, run.state.opt_state)
        for name in GOSSIP_KERNELS:
            sweep_shapes[name].update(launch_shapes()[name])
        del run
        torch.cuda.empty_cache()
    for name in GOSSIP_KERNELS:
        print(f"[kernel] {name}: phase 6's launch shapes ({len(sweep_shapes[name])}, from dry "
              f"rounds of its {len(SWEEP_RUNS)} cells at whisper-tiny's width on "
              f"{SWEEP_NODES} nodes)")
    for name in CODEC_KERNELS:
        path_shapes[name].update(sweep_shapes[name])
    later = {k for name in ("quantize", "dequantize") for k in whisper_shapes[name]}
    later |= {k for name in CODEC_KERNELS for k in sweep_shapes[name]}

    def by_size(key):  # phase 3's shapes first (the first sets the kernel's
        # headline numbers), the single-row shapes first, int8 before int4
        size = sum(key[1]) if isinstance(key[1], tuple) else key[1]
        return key in later, key[0], size, -key[2]

    for rows, size, bits in sorted(path_shapes["quantize"], key=by_size):
        x = torch.randn((rows, size), generator=gen, device=dev) * 3
        iters = 50 if x.numel() < 5e7 else 10
        codes, scales = quantize_op(x, bits=bits)
        pc, ps = codec_ref.quantize_rows(x, bits, 1024)
        if not (torch.equal(codes, pc) and torch.equal(scales, ps)):
            fail(f"quantize int{bits} ({rows}, {size}): codes/scales differ from the plain "
                 "version")
        c = scales.shape[1]
        q_bytes = 4 * x.numel() + codes.numel() + 4 * scales.numel()
        shape = f" int{bits} ({rows}, {c}x1024)"
        record("quantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:19", 0.0, 0.0,
               median_ms(lambda: quantize_op(x, bits=bits), iters),
               median_ms(lambda: codec_ref.quantize_rows(x, bits, 1024), iters // 5),
               q_bytes, 5 * x.numel(), shape=shape, key=(rows, size, bits),
               clean_ms=median_ms(lambda: quantize_op(x, bits=bits), iters, clean=True))
        del pc, ps
        # the single-leaf entry point (rt_dequantize: a group of one)
        out = dequantize_op(codes, scales, size=size, bits=bits)
        if not torch.equal(out, codec_ref.dequantize_rows(codes, scales, size, bits, 1024)):
            fail(f"dequantize int{bits} ({rows}, {size}): output differs from the plain version")
        print(f"[kernel] dequantize{shape}, single-leaf entry point: "
              f"{median_ms(lambda: dequantize_op(codes, scales, size=size, bits=bits), iters):.4f}"
              f" ms, bit-identical to the plain version, on {card}")
        del x, codes, scales, out

    def time_dequantize(rows, sizes, bits, singles=True):
        """A dequantize group as the path launches it, on seeded codes: each
        leaf bit for bit against the plain version, then one launch timed
        (with ``singles``, beside the same leaves in single launches), and
        beside torch.mul(codes, scales[:, None]) where that one call computes
        the same values (int8, with every leaf a whole number of chunks, or
        one leaf at one row, whose padded tail it writes too)."""
        layout = group_layout(rows, sizes, bits, 1024)
        codes, scales = layout.arenas(dev)
        seeded = torch.Generator(device=dev).manual_seed(rows + len(sizes))
        for l, size in enumerate(sizes):
            x = torch.randn((rows, size), generator=seeded, device=dev) * (l + 1)
            quantize_op(x, bits=bits, out=(layout.codes(codes, l), layout.scales(scales, l)))
            del x
        n = rows * sum(sizes)
        iters = 50 if n < 5e7 else 10
        outs = dequantize_group_op(codes, scales, layout)
        plain = codec_ref.dequantize_group(codes, scales, layout)
        if not all(torch.equal(o, w) for o, w in zip(outs, plain)):
            fail(f"dequantize int{bits} ({rows}, {sizes}): a leaf differs from the plain "
                 "version")
        del plain
        lib_ms = None
        if bits == 8 and (all(size % 1024 == 0 for size in sizes)
                          or (rows == 1 and len(sizes) == 1)):
            lib = torch.mul(codes, scales.unsqueeze(-1)).view(-1)
            got = torch.cat([o.reshape(-1) for o in outs])
            if torch.equal(lib[:got.numel()] if len(sizes) == 1 else lib, got):
                lib_ms = median_ms(lambda: torch.mul(codes, scales.unsqueeze(-1)), iters)
            else:
                print(f"[kernel] dequantize int8 ({rows}, {sizes}): torch.mul differs from "
                      "the kernel, so no library time")
            del lib, got
        del outs

        shape = (f" int{bits} ({rows}, {layout.total_chunks // rows}x1024)" if len(sizes) == 1
                 else f" int{bits} ({rows}, {len(sizes)} leaves, {sum(sizes)} elements)")
        n_bytes = codes.numel() + 4 * scales.numel() + 4 * n
        group_ms = median_ms(lambda: dequantize_group_op(codes, scales, layout), iters)
        record("dequantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:28", 0.0, 0.0, group_ms,
               median_ms(lambda: codec_ref.dequantize_group(codes, scales, layout),
                         max(iters // 5, 2)),
               n_bytes, n, library_ms=lib_ms, shape=shape, key=(rows, sizes, bits),
               clean_ms=median_ms(lambda: dequantize_group_op(codes, scales, layout), iters,
                                  clean=True))
        if singles and len(sizes) > 1:
            def one_a_leaf():
                for l, size in enumerate(sizes):
                    dequantize_op(layout.codes(codes, l), layout.scales(scales, l), size=size,
                                  bits=bits)

            print(f"[kernel] dequantize{shape}: one launch {group_ms:.4f} ms; the same leaves "
                  f"in {len(sizes)} single launches {median_ms(one_a_leaf, iters):.4f} ms "
                  f"(bound of the group's bytes {1e3 * n_bytes / HBM_BYTES_PER_S:.4f} ms), "
                  f"sizes {sizes}, on {card}")
        del codes, scales

    # dequantize at every group the path decodes at once (phase 3's rounds:
    # one leaf; whisper's: its groups), each as one launch, beside the same
    # leaves in single launches; the training runs' other groups before their
    # runs (train_path)
    for rows, sizes, bits in sorted(path_shapes["dequantize"], key=by_size):
        time_dequantize(rows, sizes, bits,
                        singles=(rows, sizes, bits) not in sweep_shapes["dequantize"])

    for rows, size, block, k in sorted(path_shapes["topk_select"], key=lambda k: (k in later, k)):
        xt = torch.randn((rows, size), generator=gen, device=dev)
        vals, idx = topk_select_op(xt, k=k, block=block)
        pv, pi = codec_ref.topk_select_rows(xt, k, block)
        if not (torch.equal(vals, pv) and torch.equal(idx, pi)):
            fail(f"topk_select ({rows}, {size}): values/indices differ from the plain version")
        c = vals.shape[1]
        shape = f" ({rows}, {c}x{block}, k={k})"
        # torch.topk on the |x| blocks computes part of the function (no
        # signed values, no index order): printed, never the library column
        blocks = codec_ref.chunked(xt, block)
        part_ms = median_ms(lambda: torch.topk(blocks.abs(), k, dim=1), 20)
        print(f"[kernel] topk_select{shape}: torch.topk on the |x| blocks {part_ms:.4f} ms "
              f"(values only, unordered; a diagnostic) on {card}")
        record("topk_select", "src/repro_torch/csrc/topk_pack.cu",
               "src/repro/kernels/codec/topk_pack.py:28", 0.0, 0.0,
               median_ms(lambda: topk_select_op(xt, k=k, block=block), 50),
               median_ms(lambda: codec_ref.topk_select_rows(xt, k, block), 10),
               4 * xt.numel() + 8 * vals.numel(), k * c * rows * block,
               shape=shape, key=(rows, size, block, k),
               clean_ms=median_ms(lambda: topk_select_op(xt, k=k, block=block), 50, clean=True))
        del xt, vals, idx, pv, pi, blocks

    buf = torch.randn((10, 10, b0), generator=gen, device=dev)
    w = torch.full((10,), 0.1, device=dev)
    mixed = gossip_mix_op(buf, w)
    plain = gossip_mix_ref(buf, w)
    err = float((mixed - plain).abs().max())
    record("gossip_mix", "src/repro_torch/csrc/gossip_mix.cu",
           "src/repro/kernels/mixing/gossip_mix.py:22", err,
           1e-6 * float(buf.abs().max()),
           median_ms(lambda: gossip_mix_op(buf, w), 10, cold=False),
           median_ms(lambda: gossip_mix_ref(buf, w), 5, cold=False),
           4 * buf.numel() + 4 * mixed.numel(), 2 * buf.numel(),
           library_ms=median_ms(lambda: torch.mean(buf, dim=1), 10, cold=False),
           shape=" (10, 10, 5.3 M)")
    del buf, mixed, plain
    # the mix at whisper-tiny's leaf shapes (the FedAvg of its dissemination
    # on 4 nodes, and of phase 6's protocols on 10): from a cold L2, as one
    # leaf's mix follows the others' rounds
    for batch, n, p in sorted(set(whisper_shapes["gossip_mix"]) | set(sweep_shapes["gossip_mix"])):
        buf = torch.randn((batch, n, p), generator=gen, device=dev)
        w = torch.full((n,), 1.0 / n, device=dev)
        mixed, plain = gossip_mix_op(buf, w), gossip_mix_ref(buf, w)
        iters = 50 if buf.numel() < 5e7 else 10
        record("gossip_mix", "src/repro_torch/csrc/gossip_mix.cu",
               "src/repro/kernels/mixing/gossip_mix.py:22", float((mixed - plain).abs().max()),
               1e-6 * float(buf.abs().max()), median_ms(lambda: gossip_mix_op(buf, w), iters),
               median_ms(lambda: gossip_mix_ref(buf, w), iters // 5),
               4 * buf.numel() + 4 * mixed.numel(), 2 * buf.numel(),
               library_ms=median_ms(lambda: torch.mean(buf, dim=1), iters),
               shape=f" ({batch}, {n}, {p}) whisper-tiny", key=(batch, n, p))
        del buf, mixed, plain

    # flash attention: smollm-360m's causal prefill, gemma2-2b's local layer,
    # the other configs' prefill and training shapes, and f32 cases
    def visible_pairs(s_q, s_kv, causal, window):
        """The (query, key) pairs the masks leave visible: keys k < s_kv with
        k <= q when causal and k > q - window when windowed."""
        total = 0
        for q in range(s_q):
            hi = min(q + 1, s_kv) if causal else s_kv
            lo = max(0, q - window + 1) if window else 0
            total += max(0, hi - lo)
        return total

    def sweep_key(b, s, s_kv, h, kv, hd, causal, window, cap, dtype):
        """The launch shape of a phase-6 flash case (a row phase 6 adds its
        launches to), else None."""
        sweep = (b, s, s_kv, h, kv, hd, causal) in SWEEP_FLASH
        plain = window == 0 and cap == 0.0 and dtype == torch.bfloat16
        return (b, s, s_kv, h, kv, hd) if sweep and plain else None

    flash_cases = [  # b, s, s_kv, h, kv, hd, causal, window, softcap, dtype, tol, how
        (4, 2048, 2048, 15, 5, 64, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (1, 8192, 8192, 8, 4, 256, True, 4096, 50.0, torch.bfloat16, 2e-2, "timed"),
        (2, 2048, 2048, 32, 4, 128, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),  # qwen3-moe
        (1, 2048, 2048, 32, 4, 128, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),  # its training
        (1, 2048, 2048, 56, 8, 128, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),  # arctic's
        (2, 2048, 2048, 32, 8, 160, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),  # stablelm-12b
        (2, 2048, 2048, 32, 32, 112, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),  # zamba2-7b
        (1, 2048, 2048, 32, 8, 160, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),  # their training
        (1, 2048, 2048, 32, 32, 112, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        # whisper-tiny: the encoder over 1500 frames (the last key tile ragged),
        # the decoder's cross-attention and its causal self-attention
        (8, 1500, 1500, 6, 6, 64, False, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (8, 448, 1500, 6, 6, 64, False, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (8, 448, 448, 6, 6, 64, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        # and at phase 6's batch of 2 a node
        *[(b, s, s_kv, h, kv, hd, causal, 0, 0.0, torch.bfloat16, 2e-2, "timed")
          for b, s, s_kv, h, kv, hd, causal in SWEEP_FLASH],
        # paligemma-3b's prefix split at its prefill and training batches:
        # causal over every row, non-causal over the 256 patches (MQA, hd 256)
        (2, 2304, 2304, 8, 1, 256, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (2, 256, 256, 8, 1, 256, False, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (1, 2304, 2304, 8, 1, 256, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (1, 256, 256, 8, 1, 256, False, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (2, 1024, 1024, 6, 2, 64, True, 0, 0.0, torch.float32, 2e-5, "checked"),
        (1, 1024, 1024, 8, 2, 160, True, 0, 0.0, torch.float32, 2e-5, "checked"),
        (1, 1024, 1024, 8, 8, 112, True, 0, 0.0, torch.float32, 2e-5, "checked"),
        (8, 448, 1500, 6, 6, 64, False, 0, 0.0, torch.float32, 2e-5, "checked"),  # whisper's cross
        (1, 2048, 2048, 32, 8, 160, True, 0, 0.0, torch.bfloat16, 2e-2, "fused views"),
        (2, 2048, 2048, 15, 5, 64, True, 0, 0.0, torch.bfloat16, 2e-2, "fused views"),
        (1, 8192, 8192, 8, 4, 256, True, 4096, 50.0, torch.bfloat16, None, "near the cap"),
    ]
    for b, s, s_kv, h, kv, hd, causal, window, cap, dtype, tol, how in flash_cases:
        if how == "fused views":  # into one (b, s, H + 2 KV, hd) projection
            qkv = torch.randn((b, s, h + 2 * kv, hd), generator=gen, device=dev).to(dtype)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
        else:
            # near the cap, q x 25 makes the scores' std half the cap of 50
            q_scale = 25.0 if how == "near the cap" else 1.0
            q = (q_scale * torch.randn((b, s, h, hd), generator=gen, device=dev)).to(dtype)
            k = torch.randn((b, s_kv, kv, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s_kv, kv, hd), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, sliding_window=window, softcap=cap)
        out = flash_attention_op(q, k, v, **kw)
        plain = attention_ref(q, k, v, **kw)
        err = float((out.float() - plain.float()).abs().max())
        keys = f" x {s_kv} keys" if s_kv != s else ""
        shape = (f" ({b}, {s}{keys}, {h}/{kv}, {hd}) {str(dtype)[6:]} "
                 f"{'causal' if causal else 'non-causal'} window {window} softcap {cap}")
        if how != "timed":
            shape += f" {how}" if how != "checked" else ""
        units = ""
        if dtype == torch.bfloat16:
            n_units = rounding_units(out, q, k, v, **kw)
            if not n_units <= BF16_UNITS_TOL:
                fail(f"flash_attention{shape}: {n_units} rounding units of the f32 attention "
                     f"> {BF16_UNITS_TOL}")
            units = f", {n_units:.3f} rounding units (tol {BF16_UNITS_TOL})"
        if how != "timed":
            if tol is not None and not err <= tol:
                fail(f"flash_attention{shape}: max |kernel - plain| = {err} > {tol}")
            abs_tol = "" if tol is None else f" (tol {tol})"
            print(f"[kernel] flash_attention{shape}: max_abs_err {err}{abs_tol}{units} on {card}")
            continue
        lib_ms = None
        if window == 0 and cap == 0.0:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
        n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
        record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/attention/flash.py:25", err, tol,
               median_ms(lambda: flash_attention_op(q, k, v, **kw), 5),
               median_ms(lambda: attention_ref(q, k, v, **kw), 3),
               n_bytes, 4 * hd * b * h * visible_pairs(s, s_kv, causal, window),
               library_ms=lib_ms, shape=shape + units, ops_per_s=BF16_OPS_PER_S,
               key=sweep_key(b, s, s_kv, h, kv, hd, causal, window, cap, dtype))
    del q, k, v, out, plain

    # the forward's LSE output: bit-identical outputs with and without it, at
    # smollm-360m's prefill batch and at its training batch of 2
    for b in (4, 2):
        q = torch.randn((b, 2048, 15, 64), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, 2048, 5, 64), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, 2048, 5, 64), generator=gen, device=dev).bfloat16()
        out = flash_attention(q, k, v, causal=True)
        out_lse, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        if not torch.equal(out, out_lse):
            fail("flash_attention: the output with an LSE differs from the output without one")
        _, want_lse = attention_lse_ref(q, k, v, causal=True)
        lse_err = float((lse - want_lse).abs().max())
        if not lse_err <= 1e-4 * float(want_lse.abs().max()):
            fail(f"flash_attention: LSE off the plain version's by {lse_err}")
        no_lse_ms = median_ms(lambda: flash_attention(q, k, v, causal=True), 10)
        lse_ms = median_ms(lambda: flash_attention(q, k, v, causal=True, return_lse=True), 10)
        b_ms, _ = bound_ms(0, 4 * 64 * b * 15 * visible_pairs(2048, 2048, True, 0),
                          BF16_OPS_PER_S)
        # the library calls that compute the same pair (output and LSE), kv
        # heads repeated to 15 (they take no GQA), and SDPA's own dispatch,
        # which returns no LSE
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(3, dim=2),
                                                  v.repeat_interleave(3, dim=2)))
        aten = torch.ops.aten
        lse_calls = {
            "flash": lambda: aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True),
            "efficient": lambda: aten._scaled_dot_product_efficient_attention(
                qt, kt, vt, None, True, 0.0, True),
            "cudnn": lambda: aten._scaled_dot_product_cudnn_attention(
                qt, kt, vt, None, True, 0.0, True),
        }
        libs = []
        for lib_name, call in lse_calls.items():
            try:
                lib_out, lib_lse = call()[:2]
            except (AttributeError, NotImplementedError, RuntimeError, TypeError) as e:
                print(f"[kernel] flash_attention ({b}, 2048, 15/5, 64): aten "
                      f"_scaled_dot_product_{lib_name}_attention not run here: "
                      f"{str(e).splitlines()[0][:160]}")
                continue
            lib_lse = lib_lse.reshape(b, 15, -1)[:, :, :2048]
            lib_err = max(float((lib_out.transpose(1, 2).float() - out_lse.float()).abs().max()),
                          float((lib_lse.float() - lse).abs().max()))
            libs.append((median_ms(call, 10), lib_name, lib_err))
            del lib_out, lib_lse
        sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True), 10)
        if not libs:
            fail("flash_attention: no aten attention call with an LSE ran")
        lib_s = ", ".join(f"{n} {ms:.4f} ms (max abs diff to the kernel's {e:.3e})"
                          for ms, n, e in libs)
        fastest = min(libs)
        print(f"[kernel] flash_attention ({b}, 2048, 15/5, 64) bf16 causal: {no_lse_ms:.4f} ms "
              f"without the LSE, {lse_ms:.4f} ms with it (bound {b_ms:.4f} ms; outputs "
              f"bit-identical; LSE max abs err {lse_err:.3e}); aten "
              f"_scaled_dot_product_*_attention with its LSE: {lib_s}; fastest {fastest[1]} "
              f"{fastest[0]:.4f} ms; SDPA (no LSE) {sdpa_ms:.4f} ms on {card}")
        del q, k, v, out, out_lse, lse, want_lse, qt, kt, vt

    # the flash backward at smollm-360m's training shape (bf16, f32), at
    # gemma2-2b's local layer, at hd 128 and at the other configs' training
    # shapes, against attention_bwd_ref
    bwd_cases = [  # b, s, s_kv, h, kv, hd, causal, window, softcap, dtype
        (2, 2048, 2048, 15, 5, 64, True, 0, 0.0, torch.bfloat16),
        (2, 2048, 2048, 15, 5, 64, True, 0, 0.0, torch.float32),
        (1, 8192, 8192, 8, 4, 256, True, 4096, 50.0, torch.bfloat16),
        (2, 2048, 2048, 16, 8, 128, True, 0, 0.0, torch.bfloat16),  # hd 128, GQA 2:1
        (1, 2048, 2048, 32, 4, 128, True, 0, 0.0, torch.bfloat16),  # qwen3-moe's training
        (1, 2048, 2048, 32, 8, 160, True, 0, 0.0, torch.bfloat16),  # stablelm-12b's training
        (1, 2048, 2048, 32, 32, 112, True, 0, 0.0, torch.bfloat16),  # zamba2-7b's training
        # whisper-tiny's encoder, cross-attention and decoder, 8 rows a node
        (8, 1500, 1500, 6, 6, 64, False, 0, 0.0, torch.bfloat16),
        (8, 448, 1500, 6, 6, 64, False, 0, 0.0, torch.bfloat16),
        (8, 448, 448, 6, 6, 64, True, 0, 0.0, torch.bfloat16),
        # and at phase 6's batch of 2 a node
        *[(b, s, s_kv, h, kv, hd, causal, 0, 0.0, torch.bfloat16)
          for b, s, s_kv, h, kv, hd, causal in SWEEP_FLASH],
        # paligemma-3b's prefix split, one row a node: 8 query heads a kv head
        (1, 2304, 2304, 8, 1, 256, True, 0, 0.0, torch.bfloat16),
        (1, 256, 256, 8, 1, 256, False, 0, 0.0, torch.bfloat16),
    ]
    for b, s, s_kv, h, kv, hd, causal, window, cap, dtype in bwd_cases:
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s_kv, kv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s_kv, kv, hd), generator=gen, device=dev).to(dtype)
        do = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, sliding_window=window, softcap=cap)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
        tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
        keys = f" x {s_kv} keys" if s_kv != s else ""
        shape = (f" ({b}, {s}{keys}, {h}/{kv}, {hd}) {str(dtype)[6:]} "
                 f"{'causal' if causal else 'non-causal'} window {window} softcap {cap}")
        errs = []
        for name, g1, g2, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(g1, g2):
                fail(f"flash_attention_bwd{shape}: two runs give different {name}")
            err, scale = float((g1.float() - w.float()).abs().max()), float(w.float().abs().max())
            if not err <= tol * scale:
                fail(f"flash_attention_bwd{shape}: {name} max |kernel - plain| = {err} > "
                     f"{tol} x max|{name}| = {tol * scale}")
            errs.append(f"{name} {err:.3e} ({err / scale:.2e} of max|g|)")
        print(f"[kernel] flash_attention_bwd{shape}: {', '.join(errs)} (tol {tol} of max|g|), "
              f"two runs bit-identical on {card}")
        lib_ms = None
        if window == 0 and cap == 0.0:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib_ms = median_ms(lambda: torch.autograd.grad(sd, (qt, kt, vt), dot,
                                                           retain_graph=True), 5)
            del qt, kt, vt, sd, dot
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, lse, do, *got))
        record("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
               # no TPU kernel: XLA differentiates the JAX package's einsum attention
               "src/repro/models/attention.py:48",
               max(float((g1.float() - w.float()).abs().max()) for g1, w in zip(got, want)),
               None,
               median_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw), 5),
               median_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do, **kw), 3),
               n_bytes, 10 * hd * b * h * visible_pairs(s, s_kv, causal, window),
               library_ms=lib_ms,
               shape=shape, ops_per_s=BF16_OPS_PER_S if dtype == torch.bfloat16
               else F32_OPS_PER_S,
               key=sweep_key(b, s, s_kv, h, kv, hd, causal, window, cap, dtype))
        del q, k, v, do, out, lse, got, again, want
    torch.cuda.empty_cache()

    # the selective scan at falcon-mamba-7b's width, as the Mamba1 block calls
    # it: one sequence and the prefill's batch of two
    for b in (1, 2):
        s, di, n = 2048, 8192, 16
        dt = F.softplus(torch.randn((b, s, di), generator=gen, device=dev))
        Bm = torch.randn((b, s, n), generator=gen, device=dev)
        Cm = torch.randn((b, s, n), generator=gen, device=dev)
        xs = torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16)
        A_log = torch.log(torch.randn((di, n), generator=gen, device=dev).abs() + 0.5)
        Dp = torch.randn((di,), generator=gen, device=dev)
        scan_args = (dt, Bm, Cm, xs, A_log, Dp)
        y, h = selective_scan_op(*scan_args, out_dtype=torch.float32)
        py, ph = selective_scan_ref(*scan_args, out_dtype=torch.float32)
        err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
        n_bytes = (4 + 2 + 4) * b * s * di + 2 * 4 * b * s * n + 4 * (di * n + di + b * di * n)
        record("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/scan/mamba_scan.py:24", err,
               1e-4 * max(1.0, float(py.abs().max())),
               median_ms(lambda: selective_scan_op(*scan_args, out_dtype=torch.float32), 10),
               median_ms(lambda: selective_scan_ref(*scan_args, out_dtype=torch.float32), 2),
               n_bytes, 8 * b * s * di * n + 2 * b * s * di,
               shape=f" ({b}, {s}, {di}, {n}) x bf16, y f32")
        del dt, Bm, Cm, xs, A_log, Dp, y, h, py, ph, scan_args

    # the scan's backward against selective_scan_bwd_ref: falcon-mamba-7b's
    # training shape (b 1) and b 2, timed; a ragged length with a non-zero
    # gradient of the last state, and n = 32; x bf16 (f32 in the n = 32
    # case), dy f32; and the training shape at Mamba's initialization (dt
    # log-uniform in [1e-3, 1e-1], A = -(1 .. n)), where a state lives for
    # hundreds of steps, so the carries between segments and chunks matter
    # (with dt softplus(N(0, 1)) a state falls below f32 rounding within
    # ~40 steps)
    scan_bwd_cases = [  # b, s, di, n, x dtype, dh_last, how
        (1, 2048, 8192, 16, torch.bfloat16, False, "timed"),
        (2, 2048, 8192, 16, torch.bfloat16, False, "timed"),
        (1, 2000, 8192, 16, torch.bfloat16, True, "ragged s, dh_last"),
        (2, 1000, 1024, 32, torch.float32, True, "n 32, dh_last"),
        (1, 2048, 8192, 16, torch.bfloat16, True, "Mamba init, dh_last"),
    ]
    for b, s, di, n, x_dtype, with_dh, how in scan_bwd_cases:
        if how.startswith("Mamba init"):
            dt = torch.exp(torch.empty((b, s, di), device=dev).uniform_(
                math.log(1e-3), math.log(1e-1), generator=gen))
            A_log = torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32)
                              ).expand(di, n).contiguous()
        else:
            dt = F.softplus(torch.randn((b, s, di), generator=gen, device=dev))
            A_log = torch.log(torch.randn((di, n), generator=gen, device=dev).abs() + 0.5)
        Bm = torch.randn((b, s, n), generator=gen, device=dev)
        Cm = torch.randn((b, s, n), generator=gen, device=dev)
        xs = torch.randn((b, s, di), generator=gen, device=dev).to(x_dtype)
        Dp = torch.randn((di,), generator=gen, device=dev)
        dy = torch.randn((b, s, di), generator=gen, device=dev)
        dh = torch.randn((b, di, n), generator=gen, device=dev) if with_dh else None
        scan_args = (dt, Bm, Cm, xs, A_log, Dp)
        y, _, hc = mamba_selective_scan(*scan_args, torch.float32, return_chunk_states=True)
        y_plain, _ = mamba_selective_scan(*scan_args, torch.float32)
        if not torch.equal(y, y_plain):
            fail(f"selective_scan ({b}, {s}, {di}, {n}): y with the chunk states differs from "
                 "y without them")
        got = selective_scan_bwd(*scan_args, hc, dy, dh)
        again = selective_scan_bwd(*scan_args, hc, dy, dh)
        want = selective_scan_bwd_ref(*scan_args, dy, dh)
        shape = (f" ({b}, {s}, {di}, {n}) x {str(x_dtype)[6:]}, dy f32"
                 f"{', dh_last' if with_dh else ''}"
                 f"{', at Mamba init' if how.startswith('Mamba') else ''}")
        errs, worst = [], 0.0
        for name, g1, g2, w in zip(("ddt", "dB", "dC", "dx", "dA_log", "dD"), got, again, want):
            if not torch.equal(g1, g2):
                fail(f"selective_scan_bwd{shape}: two runs give different {name}")
            tol = SCAN_BWD_BF16_TOL if g1.dtype == torch.bfloat16 else SCAN_BWD_TOL
            err = float((g1.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            if not err <= tol * scale:
                fail(f"selective_scan_bwd{shape}: {name} max |kernel - plain| = {err} > {tol} x "
                     f"max|{name}| = {tol * scale}")
            worst = max(worst, err)
            errs.append(f"{name} {err / scale:.2e}")
        print(f"[kernel] selective_scan_bwd{shape}: max |kernel - plain| over max|g|: "
              f"{', '.join(errs)} (tol {SCAN_BWD_TOL}, a bf16 dx {SCAN_BWD_BF16_TOL}), two runs "
              f"bit-identical on {card}")
        if how == "timed":
            # the forward with and without its chunk states (the training call
            # and the serving one), bit-identical y above
            fwd_ms = median_ms(lambda: mamba_selective_scan(*scan_args, torch.float32), 10)
            fwd_hc_ms = median_ms(lambda: mamba_selective_scan(
                *scan_args, torch.float32, return_chunk_states=True), 10)
            print(f"[kernel] selective_scan ({b}, {s}, {di}, {n}) x bf16, y f32: {fwd_ms:.4f} ms "
                  f"without the chunk states, {fwd_hc_ms:.4f} ms writing them "
                  f"({hc.numel() * 4 / 1e6:.1f} MB); y bit-identical on {card}")
            results["selective_scan"].setdefault("chunk_states", []).append(dict(
                shape=[b, s, di, n], ms=fwd_ms, with_chunk_states_ms=fwd_hc_ms))
            # autograd through the plain forward: a diagnostic, no library
            # call computes this function
            leaves = [t.detach().requires_grad_() for t in scan_args]

            def autograd_plain():
                yp, _ = selective_scan_ref(*leaves, out_dtype=torch.float32)
                return torch.autograd.grad(yp, leaves, dy)

            auto_ms = median_ms(autograd_plain, 2)
            print(f"[kernel] selective_scan_bwd{shape}: autograd through the plain forward "
                  f"{auto_ms:.4f} ms (a diagnostic) on {card}")
            n_bytes = ((4 + x_dtype.itemsize + 4 + 4 + x_dtype.itemsize) * b * s * di
                       + 4 * hc.numel() + 4 * 4 * b * s * n + 4 * 2 * (di * n + di))
            record("selective_scan_bwd", "src/repro_torch/csrc/selective_scan_bwd.cu",
                   # no TPU kernel: XLA differentiates the JAX package's jnp scan
                   "src/repro/models/mamba.py:42", worst, None,
                   median_ms(lambda: selective_scan_bwd(*scan_args, hc, dy, dh), 10),
                   median_ms(lambda: selective_scan_bwd_ref(*scan_args, dy, dh), 2),
                   n_bytes, 18 * b * s * di * n, shape=shape,
                   # falcon-mamba's training step launches it at b = 1 (phase 5)
                   key=(b, s, di, n) if b == 1 else None)
            results["selective_scan_bwd"].setdefault("autograd_plain_ms", []).append(
                dict(shape=[b, s, di, n], ms=auto_ms))
        del dt, Bm, Cm, xs, A_log, Dp, dy, dh, y, y_plain, hc, got, again, want, scan_args
    torch.cuda.empty_cache()
    flush.clear()

    # -- 3. the main path: scenario rounds at full width ------------------------
    reset_launches()
    for spec in runs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = run_scenario(spec, device="cuda", seed=1)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        c = spec.codec_obj()
        for r in run.rounds:
            want_wire = r.transmissions * per_send_wire_mb(c, spec.payload_mb())
            if r.bytes_on_wire_mb != want_wire:
                fail(f"{spec.name} round {r.round}: bytes_on_wire_mb "
                     f"{r.bytes_on_wire_mb} != {want_wire}")
            want_ok = None if spec.codec == "topk" else True
            if r.numerics_ok is not want_ok or not r.finite:
                fail(f"{spec.name} round {r.round}: numerics_ok={r.numerics_ok} "
                     f"finite={r.finite}")
            print(f"[path] {spec.name} round {r.round}: {run.elems_per_node} f32/node x "
                  f"{len(r.members)} live of {spec.n}, {r.n_slots} slots, "
                  f"{r.transmissions} tx, bytes_on_wire_mb {r.bytes_on_wire_mb}, "
                  f"numerics_ok {r.numerics_ok}, round {r.device_ms:.3f} ms on {card}")
        print(f"[path] {spec.name}: {wall:.2f} s wall for {len(run.rounds)} round(s), "
              f"peak {peak_gb:.2f} GB")
        if spec.name == "quantized_table3" and run.rounds[0].bytes_on_wire_mb != 478.86336:
            fail("quantized_table3 bytes_on_wire_mb != 478.86336")
    counts, shapes = launch_counts(), launch_shapes()
    print(f"[path] launches: {json.dumps(counts)}")
    missing = [k for k in GOSSIP_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    for name in GOSSIP_KERNELS:
        results[name]["launches"] = counts[name]
        hist = ", ".join(f"{key} x {n}" for key, n in
                         sorted(shapes[name].items(), key=lambda kv: -kv[1]))
        print(f"[path] {name} launches by shape: {hist}")
    def add_shape_launches(name, shapes_run, where):
        """A run's launches of a kernel, by shape, into the rows timed in
        phase 2 (every shape must have been), and the kernel's loss:
        launches x (time - bound), summed over its shapes."""
        timed = shape_rows.get(name, {})
        untimed = sorted(set(shapes_run) - set(timed))
        if untimed:
            fail(f"{name}: shapes launched on {where} but not timed: {untimed}")
        for key, row in timed.items():
            row["launches"] = row.get("launches", 0) + shapes_run.get(key, 0)
            row["loss_ms"] = row["launches"] * (row["ms"] - row["bound_ms"])
            print(f"[{where}] {name} {key}: {row['launches']} launches x ({row['ms']:.4f} - "
                  f"{row['bound_ms']:.4f} ms) = {row['loss_ms']:.4f} ms")
        loss = sum(r["loss_ms"] for r in timed.values())
        results[name]["loss_ms"] = loss
        print(f"[{where}] {name}: loss sum over shapes of launches x (ms - bound_ms) = "
              f"{loss:.4f} ms on {card}")

    for name in CODEC_KERNELS:
        add_shape_launches(name, shapes[name], "path")
    torch.cuda.empty_cache()

    # -- 4. the serving path at full width ----------------------------------------
    # (arch, layers (0: all), prefill batch, kernel, decode): the CLI's serve
    # loop and a CUDA-graph step, or that many decode steps. arctic-480b runs
    # 1 of its 35 layers: one layer's experts are 26.8 GB in bf16
    serve_runs = [("smollm-360m", 0, 4, "flash_attention", "cli"),
                  ("falcon-mamba-7b", 0, 2, "selective_scan", "cli"),
                  ("qwen3-moe-30b-a3b", 0, 2, "flash_attention", "cli"),
                  ("arctic-480b", 1, 1, "flash_attention", 8),
                  ("stablelm-12b", 0, 2, "flash_attention", "cli"),
                  ("zamba2-7b", 0, 2, "flash_attention", "cli"),
                  ("whisper-tiny", 0, 8, "flash_attention", "cli"),
                  ("paligemma-3b", 0, 2, "flash_attention", "cli")]
    n_prefill = 3
    reset_launches()
    serve_launches = Counter()
    for arch, layers, batch, kernel, decode in serve_runs:
        # whisper's 448 text positions, Whisper's text context (arXiv:2212.04356)
        seq = 448 if arch == "whisper-tiny" else 2048
        full = get_arch(arch)
        cfg = full.replace(n_layers=layers) if layers else full
        depth = (f"{cfg.n_layers} layers" if cfg.n_layers == full.n_layers
                 else f"{cfg.n_layers} of {full.n_layers} layers")
        model = build_model(cfg, device="cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(g)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = count_elements(params)
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev)
        frontend = frontend_inputs(cfg, batch, g)
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        spans = []
        with torch.inference_mode():
            for _ in range(n_prefill):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = model.forward(params, Batch(tokens=tokens, **frontend))
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t0)
                if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
                    fail(f"{arch}: non-finite prefill logits")
                del logits
        after = launch_counts()
        n = after[kernel] - before[kernel]
        per_fwd = attention_layers(cfg) if kernel == "flash_attention" else cfg.n_layers
        if n != per_fwd * n_prefill:
            fail(f"{arch}: {kernel} launched {n} times in {n_prefill} forwards, expected "
                 f"{per_fwd} a forward")
        other = next(k for k in MODEL_KERNELS if k != kernel)
        if after[other] != before[other]:
            fail(f"{arch}: {other} launched {after[other] - before[other]} times in its "
                 "prefill forwards, expected none")
        serve_launches[kernel] += n
        prefill_peak = torch.cuda.max_memory_allocated() / 1e9
        prefill_ms = statistics.median(spans[1:]) * 1e3
        inputs = "".join(f" + {k} {tuple(t.shape)}" for k, t in frontend.items())
        print(f"[serve] {arch}: {depth}, d {cfg.d_model}, {n_params / 1e9:.3f} B params bf16 "
              f"(init {init_s:.1f} s, peak {init_peak:.2f} GB); prefill ({batch}, {seq}){inputs}: "
              f"{prefill_ms:.3f} ms median of {n_prefill - 1} after a warm-up "
              f"[{', '.join(f'{1e3 * t:.3f}' for t in spans)}], "
              f"{batch * seq / prefill_ms * 1e3:.0f} tok/s, {per_fwd} {kernel} launches a "
              f"forward, no {other}, peak {prefill_peak:.2f} GB on {card}")
        if cfg.family == "hybrid":  # the Mamba2 blocks' share of the prefill
            block = tree_map(lambda t: t[0], params["tail_blocks"])
            x = torch.randn((batch, seq, cfg.d_model), generator=g, device=dev).to(model.dtype)
            with torch.inference_mode():
                block_ms = median_ms(lambda: x + mamba2_forward(
                    block["body"], rms_norm(x, block["ln"]), cfg.ssm_state), 5, cold=False)
            n_mamba = cfg.n_layers - attention_layers(cfg)
            print(f"[serve] {arch}: one Mamba2 block (rms norm, SSD scan in plain PyTorch, "
                  f"residual) at ({batch}, {seq}, {cfg.d_model}): {block_ms:.3f} ms; "
                  f"{n_mamba} blocks {n_mamba * block_ms:.1f} ms, "
                  f"{100 * n_mamba * block_ms / prefill_ms:.1f}% of the prefill's "
                  f"{prefill_ms:.3f} ms on {card}")
            del block, x
        torch.cuda.reset_peak_memory_stats()
        # the reference CLI's defaults (batch 4, prompt 32, gen 16, cache 128),
        # or a 4-token prompt and as many generated tokens as make `decode` steps;
        # a whisper decode step launches the flash kernel for each layer's
        # cross-attention, whose cache the CLI leaves zero (ROADMAP R10)
        per_step = cfg.n_layers if cfg.family == "audio" else 0
        b_dec, prompt_len, gen = (4, 32, 16) if decode == "cli" else (batch, 4, decode - 3)
        prompts = torch.randint(0, cfg.vocab, (b_dec, prompt_len), generator=g, device=dev)
        before = launch_counts()[kernel]
        res = serve(model, params, prompts, gen=gen, cache_len=128)
        n = launch_counts()[kernel] - before
        if n != per_step * res.steps:
            fail(f"{arch}: {kernel} launched {n} times in {res.steps} decode steps, expected "
                 f"{per_step} a step")
        serve_launches[kernel] += n
        if not bool(torch.isfinite(res.logits[..., :cfg.vocab]).all()):
            fail(f"{arch}: non-finite decode logits")
        if not bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
            fail(f"{arch}: generated ids outside the vocab")
        step_ms = 1e3 * res.seconds / res.steps
        print(f"[serve] {arch}: serve loop batch {b_dec}, prompt {prompt_len}, gen {gen}, "
              f"cache 128: {res.steps} decode steps in {res.seconds:.3f} s, {step_ms:.3f} "
              f"ms/step, {b_dec * res.steps / res.seconds:.1f} tok/s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
        if decode == "cli":
            # the device's own time for a decode step: the same step captured
            # in a CUDA graph replays without the host's launch gaps
            cache = model.init_cache(4, 128)
            tok, pos = prompts[:, :1].clone(), torch.zeros(4, dtype=torch.long, device=dev)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            before = launch_counts()[kernel]
            with torch.inference_mode(), torch.cuda.stream(side):
                for _ in range(2):
                    model.decode_step(params, tok, pos, cache)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.inference_mode(), torch.cuda.graph(graph):
                model.decode_step(params, tok, pos, cache)
            n = launch_counts()[kernel] - before
            if n != 3 * per_step:  # two warm-up steps and the captured one
                fail(f"{arch}: {kernel} launched {n} times in 3 decode steps, expected "
                     f"{per_step} a step")
            serve_launches[kernel] += n
            graph_ms = median_ms(graph.replay, 20, cold=False)
            captured = f", {per_step} flash launches captured" if per_step else ""
            print(f"[serve] {arch}: one decode step replayed as a CUDA graph{captured}: "
                  f"{graph_ms:.3f} ms on the device against {step_ms:.3f} ms eager (device idle ~"
                  f"{100 * (1 - graph_ms / step_ms):.1f}% of an eager step) on {card}")
            del graph, cache
        del params, res, model
        torch.cuda.empty_cache()
    counts = launch_counts()
    print(f"[serve] launches: {json.dumps(counts)}")
    for kernel, want in serve_launches.items():
        if counts[kernel] != want:
            fail(f"{kernel}: {counts[kernel]} launches on the serving path, expected {want}")
        results[kernel]["launches"] = counts[kernel]

    # forward (kernels) against teacher-forced decode (cache path) in f32;
    # qwen3-moe with capacity 100 tokens an expert, as tests/test_models.py
    # decodes moe archs: no drops, so both paths route every token alike
    f32_checks = [("smollm-360m", dict(n_layers=4)), ("falcon-mamba-7b", dict(n_layers=4)),
                  ("qwen3-moe-30b-a3b", dict(n_layers=2, moe_capacity_factor=100.0)),
                  ("stablelm-12b", dict(n_layers=4)),
                  # two super-blocks and a tail block: the shared block's cache used twice
                  ("zamba2-7b", dict(n_layers=13)),
                  # whisper at full depth, its cross cache filled from the encoder
                  # output; paligemma with no patches: pure gemma decoding
                  ("whisper-tiny", {}), ("paligemma-3b", dict(n_layers=4))]
    for arch, cut in f32_checks:
        cfg = get_arch(arch).replace(dtype="float32", **cut)
        model = build_model(cfg, device="cuda")
        g = torch.Generator(device=dev).manual_seed(1)
        params = model.init(g)
        tokens = torch.randint(0, cfg.vocab, (2, 256), generator=g, device=dev)
        frontend = frontend_inputs(cfg, 2, g) if cfg.family == "audio" else {}
        with torch.inference_mode():
            full, _ = model.forward(params, Batch(tokens=tokens, **frontend))
            cache = model.init_cache(2, 256)
            if cfg.family == "audio":
                cache = fill_whisper_cross(model, params, frontend["encoder_frames"], cache)
            err = 0.0
            for t in range(256):
                pos = torch.full((2,), t, dtype=torch.long, device=dev)
                step, cache = model.decode_step(params, tokens[:, t:t + 1], pos, cache)
                err = max(err, float((step[:, 0, :cfg.vocab] - full[:, t, :cfg.vocab])
                                     .abs().max()))
        if not err < 5e-2:
            fail(f"{arch}: f32 forward vs teacher-forced decode max |err| {err} >= 5e-2")
        print(f"[serve] {arch} f32, {cfg.n_layers} layers, full width: forward vs "
              f"teacher-forced decode over 256 tokens, max abs logit err {err:.3e} (bound "
              f"5e-2) on {card}")
        del params, full, cache, model
        torch.cuda.empty_cache()

    # -- 5. the training path: 4 stacked nodes -------------------------------------
    def train_path(cfg, bpn, train_runs, lr=1e-3, seq=2048, timed=()):
        """The train runs of one config, 4 nodes x (bpn, seq), the launch
        counts set to 0 just before each run and read just after (a codec
        run's launches of the gossip kernels named in ``timed`` join their
        shapes' rows, each of which must have been timed: in phase 2, or,
        for dequantize's groups, just before the run); returns the data
        whose batches the gradient check reads and the frontend's inputs."""
        n_nodes = 4
        model = build_model(cfg, device="cuda")
        data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=seq, batch_per_node=bpn,
                                        n_nodes=n_nodes, seed=0))
        tok, lab = data.global_batch()
        frontend = frontend_inputs(cfg, n_nodes * bpn, torch.Generator(device=dev).manual_seed(3))
        batch = Batch(tokens=torch.from_numpy(tok).long().to(dev),
                      labels=torch.from_numpy(lab).long().to(dev), **frontend)
        params0 = model.init(torch.Generator(device=dev).manual_seed(0))
        n_params = count_elements(params0)
        print(f"[train] {cfg.name}: {cfg.n_layers} of {get_arch(cfg.name).n_layers} layers, "
              f"{n_params / 1e9:.3f} B params a node; a dissemination round's (N, N, P) f32 "
              f"buffer would be {n_nodes * n_nodes * n_params * 4 / 1e9:.1f} GB")
        per_step = attention_layers(cfg) * n_nodes
        # a Mamba1 layer's scan forward and backward, once a layer a node
        scan_per_step = cfg.n_layers * n_nodes if cfg.family == "ssm" else 0
        # a moe step routes every node's rows once without a graph first
        # (DFLTrainer.aux_coefs): one more forward launch a layer a node
        fwd_per_step = per_step * (2 if cfg.family == "moe" else 1)
        train_launches = Counter()
        for mode, codec, steps in train_runs:
            trainer = DFLTrainer(model, n_nodes, DFLConfig(gossip_mode=mode, codec=codec,
                                                           lr=lr, warmup=0),
                                 device="cuda", timed=True)
            state = trainer.state_from_params(params0)
            # one dequantize a group of leaves a hop (the gossip runs on the masters)
            theta = tree_flatten(state.opt_state.get("master", state.params))[0]
            groups = hop_groups(mode, trainer.plan, theta, trainer.codec)
            n_groups = len(groups)
            if codec == "int8" and "dequantize" in timed:
                # every group at each step's senders (and all nodes for an
                # error-feedback pre-encode), held and timed as phase 2 does
                senders = {len(step.perm) for step in trainer.plan.diss_steps if step.perm}
                if trainer.error_feedback:
                    senders.add(n_nodes)
                keys = {(rows, tuple(theta[i][0].numel() for i in g), 8)
                        for g in groups for rows in senders}
                new = sorted(keys - set(shape_rows.get("dequantize", {})))
                flush.append(torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev))
                for key in new:
                    time_dequantize(*key, singles=False)
                flush.clear()
                print(f"[train] {cfg.name} {mode}+int8: {n_groups} dequantize groups, "
                      f"{len(keys)} launch shapes, {len(new)} timed here against the plain "
                      f"version (the rest in phase 2)")
                torch.cuda.empty_cache()
            del theta, groups
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run = f"{cfg.name} {mode}{'+' + codec if codec else ''}"
            losses, walls = [], []
            reset_launches()
            for i in range(steps):
                before = launch_counts()
                profiled = mode == "tree_allreduce" and i == 3
                t0 = time.perf_counter()
                if profiled:
                    state, m, dev_ms, n_kernels, busy_ms, span_ms = profile_step(trainer, state,
                                                                                 batch)
                else:
                    state, m = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                after = launch_counts()
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                losses.append(loss)
                walls.append(wall)
                if not (math.isfinite(loss) and math.isfinite(gnorm)):
                    fail(f"train {run} step {i}: loss {loss}, grad_norm {gnorm}")
                for kernel, want in (("flash_attention", fwd_per_step),
                                     ("flash_attention_bwd", per_step),
                                     ("selective_scan", scan_per_step),
                                     ("selective_scan_bwd", scan_per_step)):
                    n = after[kernel] - before[kernel]
                    if n != want:
                        layers = (f"{cfg.n_layers} Mamba1 layers" if kernel.startswith("sel")
                                  else f"{attention_layers(cfg)} attention layers")
                        fail(f"train {run} step {i}: {kernel} launched {n} times, expected "
                             f"{want} ({layers} x {n_nodes} nodes"
                             f"{' x 2 passes' if want != per_step else ''})")
                routed = ""
                if cfg.family == "moe":  # the routing pass and the differentiated one
                    mismatch = float(m["route_mismatch"])
                    if mismatch != 0.0:
                        fail(f"train {run} step {i}: the routing pass's f counts differ from "
                             f"the differentiated pass's by {mismatch}")
                    routed = ", both passes routed alike"
                if mode == "tree_allreduce":  # every node holds the FedAvg of the masters
                    worst = 0.0
                    for leaf in tree_leaves(state.opt_state["master"]):
                        # in f64 a chunk at a time: qwen3-moe's embedding is 311 M a node
                        for chunk in leaf.reshape(n_nodes, -1).split(1 << 24, dim=1):
                            chunk = chunk.double()
                            mean = chunk.mean(dim=0)
                            ok = all(torch.allclose(chunk[j], mean, rtol=1e-5, atol=1e-5)
                                     for j in range(n_nodes))
                            worst = max(worst, float((chunk - mean).abs().max()))
                            if not ok:
                                fail(f"train {run} step {i}: a node's masters are off the "
                                     "FedAvg")
                    fedavg = f", masters within {worst:.2e} of the FedAvg"
                else:
                    fedavg = ""
                if profiled:  # where a steady step's device time goes
                    if (n_kernels["flash backward"] != 2 * per_step
                            or n_kernels["flash forward"] != fwd_per_step
                            or n_kernels["scan backward"] != 2 * scan_per_step
                            or n_kernels["scan forward"] != scan_per_step
                            or n_kernels["GEMMs"] == 0):
                        fail(f"profiled step: {dict(n_kernels)} kernels by group; expected "
                             f"{2 * per_step} of the flash backward (D and the fused passes a "
                             f"launch), {fwd_per_step} of the forward, {scan_per_step} of the "
                             f"scan forward, {2 * scan_per_step} of its backward (the kernel "
                             "and its finishing pass a launch) and GEMMs")
                    split = ", ".join(f"{g} {dev_ms[g]:.3f} ms ({n_kernels[g]} kernels)"
                                      for g in STEP_GROUPS)
                    # the profiler slows the host's issue, so the idle share is
                    # also read against the unprofiled step before
                    steady_ms = 1e3 * walls[-2]
                    print(f"[train] {run} step {i} under torch.profiler, device time by group: "
                          f"{split}; device busy {busy_ms:.3f} ms of the profiled step's "
                          f"{span_ms:.3f} ms (idle {100 * (1 - busy_ms / span_ms):.1f}%) and of "
                          f"step {i - 1}'s {steady_ms:.1f} ms unprofiled (idle "
                          f"{100 * (1 - busy_ms / steady_ms):.1f}%) on {card}")
                decoded = ""
                if codec == "int8":  # a round a step
                    n = after["dequantize"] - before["dequantize"]
                    want = n_groups * len(trainer.plan.diss_steps)
                    if n != want:
                        fail(f"train {run} step {i}: dequantize launched {n} times, expected "
                             f"{n_groups} groups x {len(trainer.plan.diss_steps)} steps")
                    decoded = (f", dequantize {n} launches a round ({n_groups} groups x "
                               f"{len(trainer.plan.diss_steps)} steps)")
                t = m["times"]
                print(f"[train] {run} step {i}: loss {loss:.4f}, grad_norm {gnorm:.4f}, "
                      f"{wall * 1e3:.1f} ms (nodes' fwd+bwd {t['fwd_bwd'] * 1e3:.1f}, optimizer "
                      f"{t['optimizer'] * 1e3:.1f}, gossip {t['gossip'] * 1e3:.1f}), "
                      f"{n_nodes * bpn * seq / wall:.0f} tok/s{fedavg}{routed}{decoded} on {card}")
            counts = launch_counts()
            train_launches.update(counts)
            if cfg.family != "ssm" and counts["selective_scan"]:
                fail(f"train {run}: selective_scan launched {counts['selective_scan']} times")
            print(f"[train] {run}: lr {lr}, losses {[round(x, 4) for x in losses]}, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
                  f"{json.dumps(counts)}")
            want = {"": (), "int8": ("quantize", "dequantize", "gossip_mix"),
                    "topk": ("topk_select", "gossip_mix")}[codec]
            missing = [k for k in want if counts[k] <= 0]
            if missing:
                fail(f"train {run}: gossip kernels never launched: {missing}")
            if mode == "tree_allreduce" and not losses[2] < losses[0]:
                fail(f"train {run}: the third loss {losses[2]} is not below the first "
                     f"{losses[0]}")
            if codec == "topk" and not any(float(x.abs().max()) > 0
                                           for x in tree_leaves(state.opt_state["codec_ef"])):
                fail(f"train {run}: codec_ef never changed")
            if codec and timed:
                run_shapes = launch_shapes()
                for name in (k for k in want if k in timed):
                    results[name]["launches"] += counts[name]
                    add_shape_launches(name, run_shapes[name], f"train {run}")
            if counts["selective_scan_bwd"]:  # its loss, at the shape phase 2 timed
                add_shape_launches("selective_scan_bwd", launch_shapes()["selective_scan_bwd"],
                                   f"train {run}")
            del trainer, state, m
            torch.cuda.empty_cache()
        for kernel in ("flash_attention", "flash_attention_bwd", "selective_scan",
                       "selective_scan_bwd"):
            results[kernel]["launches"] += train_launches[kernel]
        if cfg.family == "moe":  # what the global-batch aux loss costs a step
            trainer = DFLTrainer(model, n_nodes, device="cuda")
            stacked = tree_map(lambda t: t.expand(n_nodes, *t.shape), params0)
            spans = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.aux_coefs(stacked, batch.tokens)
                torch.cuda.synchronize()
                spans.append(1e3 * (time.perf_counter() - t0))
            print(f"[train] {cfg.name}: the routing pass alone (DFLTrainer.aux_coefs: "
                  f"{n_nodes} nodes' layers without logits or a graph) "
                  f"{statistics.median(spans[1:]):.3f} ms median of 3 after a warm-up "
                  f"[{', '.join(f'{t:.3f}' for t in spans)}] on {card}")
            del trainer, stacked
        del params0, model, batch
        torch.cuda.empty_cache()
        return data, frontend

    def grad_check(cfg, data, rows, frontend=None):
        """Every leaf's f32 training gradient through the kernels against the
        gradient through the plain versions on the card, within 1e-3 of its
        max |g|."""
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device=dev).manual_seed(2))
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        tok, lab = data.global_batch()
        b2 = Batch(tokens=torch.from_numpy(tok[:rows]).long().to(dev),
                   labels=torch.from_numpy(lab[:rows]).long().to(dev),
                   **{k: t[:rows] for k, t in (frontend or {}).items()})
        got = torch.autograd.grad(model.train_loss(params, b2), leaves)
        # the plain routes, differentiated by autograd itself
        attn_model.flash_attention_op = attention_ref
        mamba_model.selective_scan_op = selective_scan_ref
        try:
            want = torch.autograd.grad(model.train_loss(params, b2), leaves)
        finally:
            attn_model.flash_attention_op = flash_attention_op
            mamba_model.selective_scan_op = selective_scan_op
        worst = 0.0
        for g1, g2 in zip(got, want):
            rel = float((g1 - g2).abs().max()) / max(float(g2.abs().max()), 1e-30)
            worst = max(worst, rel)
            if not rel <= 1e-3:
                fail(f"train gradients ({cfg.name}): a leaf through the kernels is {rel:.2e} "
                     "of its max|g| off the plain versions' (bound 1e-3)")
        print(f"[train] {cfg.name} f32, {cfg.n_layers} layers, full width, "
              f"{tuple(b2.tokens.shape)} tokens: every leaf's gradient through the kernels within {worst:.3e} of its "
              f"max|g| of the plain versions' (bound 1e-3) on {card}")
        del params, leaves, got, want, model
        torch.cuda.empty_cache()

    # smollm-360m at full width and depth, (2, 2048) a node; the tree run's
    # fourth step runs under torch.profiler, and the tree run comes last, so
    # no other step follows a profiled one
    cfg = get_arch("smollm-360m").replace(remat=False)
    data, _ = train_path(cfg, 2, [("dissemination", "int8", 2), ("dissemination", "topk", 2),
                                  ("tree_allreduce", "", 4)], timed=("dequantize",))
    grad_check(cfg.replace(n_layers=4, dtype="float32"), data, 2)
    # qwen3-moe-30b-a3b at full width and 1 of its 48 layers, (1, 2048) a node:
    # 0.934 B params a node, fp32 masters and bf16 moments (its config); no
    # top-k run, whose f32 residual would add 15 GB
    cfg = get_arch("qwen3-moe-30b-a3b").replace(n_layers=1, remat=False)
    data, _ = train_path(cfg, 1, [("dissemination", "int8", 2), ("tree_allreduce", "", 4)],
                         timed=("dequantize",))
    grad_check(cfg.replace(dtype="float32"), data, 1)
    # stablelm-12b at full width and 1 of its 40 layers, and zamba2-7b at full
    # width and 7 of its 81 layers (one super-block: 5 Mamba2 blocks and the
    # shared attention block, then one tail block), (1, 2048) a node, fp32
    # masters and bf16 moments (their configs), lr 3e-4: 1e-3 overshoots at
    # d >= 2048 (PERF.md section 5). No dissemination run: its f32 (N, N, P)
    # buffer of stablelm's 514 M-parameter embedding alone would be 33 GB
    cfg = get_arch("stablelm-12b").replace(n_layers=1, remat=False)
    data, _ = train_path(cfg, 1, [("tree_allreduce", "", 4)], lr=3e-4)
    grad_check(cfg.replace(dtype="float32"), data, 1)
    cfg = get_arch("zamba2-7b").replace(n_layers=7, remat=False)
    data, _ = train_path(cfg, 1, [("tree_allreduce", "", 4)], lr=3e-4)
    # 13 layers: two super-blocks, so the shared block's gradient sums two uses
    grad_check(cfg.replace(n_layers=13, dtype="float32"), data, 1)
    # whisper-tiny at full width and depth, (8, 448) tokens and (8, 1500, 384)
    # frames a node: int8 dissemination (its shapes timed in phase 2), then tree
    cfg = get_arch("whisper-tiny").replace(remat=False)
    data, frontend = train_path(cfg, 8, [("dissemination", "int8", 2), ("tree_allreduce", "", 4)],
                                lr=3e-4, seq=448, timed=GOSSIP_KERNELS)
    grad_check(cfg.replace(dtype="float32"), data, 2, frontend)
    # paligemma-3b at full width and 1 of its 18 layers, (1, 2048) tokens and
    # (1, 256, 2048) patches a node, f32 moments (its config's). No
    # dissemination: its (N, N, P) f32 buffer of the 527 M embedding is 34 GB
    cfg = get_arch("paligemma-3b").replace(n_layers=1, remat=False)
    data, frontend = train_path(cfg, 1, [("tree_allreduce", "", 4)], lr=3e-4)
    grad_check(cfg.replace(dtype="float32"), data, 1, frontend)
    # falcon-mamba-7b at full width and 2 of its 64 layers, (1, 2048) a node,
    # fp32 masters and bf16 moments (its config's), lr 3e-4: every layer's
    # scan through the forward kernel (with its chunk states) and the
    # backward kernel. Tree rounds only, as the other cut-depth runs: 0.48 B
    # params a node (the embedding tied to the head), whose (N, N, P) f32
    # dissemination buffer would be 30.5 GB (printed above the run)
    cfg = get_arch("falcon-mamba-7b").replace(n_layers=2, remat=False)
    data, _ = train_path(cfg, 1, [("tree_allreduce", "", 4)], lr=3e-4)
    grad_check(cfg.replace(n_layers=1, dtype="float32"), data, 1)

    # -- 6. the sweep path: the codec x protocol grid through the launcher -------
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--sweep", "codec_x_protocol"])
    table = out.getvalue().splitlines()
    for line in table:
        print(f"[sweep] {line}")
    if table != SWEEP_TABLE:
        fail("the launcher's dry table of codec_x_protocol differs from the reference's")
    cfg = get_arch("whisper-tiny")
    per_step = attention_layers(cfg) * SWEEP_NODES
    # the launcher keeps the config's remat, as the reference's does: each
    # layer's forward runs again inside the backward
    fwd_per_step = per_step * (2 if cfg.remat else 1)
    sweep_launches, sweep_loss = Counter(), Counter()
    for argv in SWEEP_RUNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            run = launcher.main(argv)
        counts, run_shapes = launch_counts(), launch_shapes()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        spec, rounds = run.scenario, run.scenario.rounds
        label = spec.name
        if not (all(math.isfinite(x) for x in run.losses + run.grad_norms)
                and len(run.losses) == rounds):
            fail(f"sweep {label}: losses {run.losses}, grad norms {run.grad_norms}")
        for kernel, want in (("flash_attention", fwd_per_step * rounds),
                             ("flash_attention_bwd", per_step * rounds)):
            if counts[kernel] != want:
                fail(f"sweep {label}: {kernel} launched {counts[kernel]} times, expected {want} "
                     f"({attention_layers(cfg)} attention calls x {SWEEP_NODES} nodes x "
                     f"{rounds} rounds{' x 2 (remat)' if want != per_step * rounds else ''})")
        want = CELL_KERNELS[spec.codec]
        wrong = [k for k in GOSSIP_KERNELS if (counts[k] > 0) != (k in want)]
        if wrong or counts["selective_scan"]:
            fail(f"sweep {label}: gossip kernels {wrong} launched against the codec's "
                 f"{want}: {json.dumps(counts)}")
        sweep_launches.update(counts)
        for name in SHAPED_KERNELS:
            timed = shape_rows.get(name, {})
            untimed = sorted(set(run_shapes[name]) - set(timed))
            if untimed:
                fail(f"{name}: shapes launched in sweep {label} but not timed: {untimed}")
            for key, n in run_shapes[name].items():
                row = timed[key]
                row["launches"] = row.get("launches", 0) + n
                row["loss_ms"] = row["launches"] * (row["ms"] - row["bound_ms"])
                sweep_loss[name] += n * (row["ms"] - row["bound_ms"])
            if run_shapes[name] and name in GOSSIP_KERNELS:
                hist = ", ".join(f"{key} x {n}" for key, n in sorted(run_shapes[name].items()))
                print(f"[sweep] {label}: {name} {counts[name]} launches at {len(run_shapes[name])}"
                      f" shapes: {hist}")
        print(f"[sweep] {label}: {rounds} round(s) of {SWEEP_NODES} nodes x (2, 448), "
              f"losses {[round(x, 4) for x in run.losses]}, grad norms "
              f"{[round(x, 4) for x in run.grad_norms]}, round ms "
              f"{[round(1e3 * t, 1) for t in run.step_s]} (host clock, synchronized), "
              f"peak {peak_gb:.2f} GB, mst_slots {run.trainer.plan.dissemination.n_slots}, "
              f"flash {counts['flash_attention']} / bwd {counts['flash_attention_bwd']}, "
              f"launches {json.dumps({k: counts[k] for k in GOSSIP_KERNELS})} on {card}")
        del run, log
        torch.cuda.empty_cache()
        # one round from seeded unequal nodes, held to the FedAvg of the same
        # round with its gossip off (top-k: finite outputs only); then the
        # negative control: with the trainer's gossip stubbed out the check
        # must fail wherever it has a bound
        args = launcher.parse_args(argv)
        with contextlib.redirect_stdout(io.StringIO()):
            _, spec = launcher.resolve_scenario(args)
        run = launcher.build_run(args, spec)
        batch = run.make_batch()
        ok, finite, worst, t = fedavg_check(run.trainer, run.state, batch, session=run.session)
        want_ok = None if spec.codec == "topk" else True
        if ok is not want_ok or not finite:
            fail(f"sweep {label}: from unequal nodes numerics_ok={ok}, finite={finite}, "
                 f"max |masters - FedAvg| {worst}")
        run.trainer.gossip = lambda params, opt_state: (params, opt_state)
        stub_ok, stub_finite, stub_worst, _ = fedavg_check(run.trainer, run.state, batch,
                                                           session=run.session)
        if stub_ok is not (None if want_ok is None else False) or not stub_finite:
            fail(f"sweep {label}: with its gossip stubbed out the FedAvg check gives "
                 f"numerics_ok={stub_ok} (finite {stub_finite}, max |masters - FedAvg| "
                 f"{stub_worst}); it must fail")
        print(f"[sweep] {label}: from unequal nodes every live node's masters within "
              f"{worst:.3e} of the FedAvg of the gossip-off round (numerics_ok {ok}); with "
              f"the gossip stubbed out {stub_worst:.3e} (numerics_ok {stub_ok}); the gossip "
              f"step {1e3 * sum(t.values()):.1f} ms: nodes' fwd+bwd {1e3 * t['fwd_bwd']:.1f}, "
              f"optimizer {1e3 * t['optimizer']:.1f}, gossip {1e3 * t['gossip']:.1f} (host "
              f"clock, synchronized) on {card}")
        del run, batch
        torch.cuda.empty_cache()
    for name in (*GOSSIP_KERNELS, "flash_attention", "flash_attention_bwd"):
        results[name]["launches"] += sweep_launches[name]
    for name in GOSSIP_KERNELS:
        rows = shape_rows.get(name, {}).values()
        results[name]["loss_ms"] = sum(r.get("loss_ms", 0.0) for r in rows)
        print(f"[sweep] {name}: {sweep_launches[name]} launches in phase 6 at "
              f"{len(sweep_shapes[name])} shapes, their loss {sweep_loss[name]:.4f} ms; loss over "
              f"every phase's shapes {results[name]['loss_ms']:.4f} ms on {card}")
    for name in ("flash_attention", "flash_attention_bwd"):
        # phases 4 and 5 launch it at shapes without a row: the loss here is
        # phase 6's alone
        for key, row in shape_rows[name].items():
            print(f"[sweep] {name} {key}: {row.get('launches', 0)} launches x ({row['ms']:.4f} "
                  f"- {row['bound_ms']:.4f} ms) = {row.get('loss_ms', 0.0):.4f} ms")
        print(f"[sweep] {name}: {sweep_launches[name]} launches in phase 6 at whisper's "
              f"{len(shape_rows[name])} shapes, their loss {sweep_loss[name]:.4f} ms on {card}")

    print(smi)
    print(json.dumps({"kernels": [results[k] for k in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
