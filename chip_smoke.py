#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100: the MOSGU gossip round,
the paper's FIFO queue round with encoded payloads, the model serving path
(prefill forward + cached decode), the DFL training step (4 stacked nodes,
forward, the flash-attention and selective-scan backwards, the optimizer
and a gossip round), for every family: dense, ssm, moe, hybrid, audio
(whisper-tiny) and vlm (paligemma-3b), and the launcher's sweep path (the
codec x protocol grid on 10 nodes).

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
             3.5 M, smollm-360m's 180.9 M for mesh_smoke int8), at every
             shape the sweeps part launches them with (a dry run of its two
             sweeps at full width on the card: the segmented cells' segments
             of 1.325 M, top-k's B0 rows), and at every
             shape phase 5's int8 dissemination runs of whisper-tiny (full
             depth) and granite-3-2b (4 layers) launch them with (one round
             of each one's 4 nodes' seeded f32 masters on the card: a
             quantize a leaf, a dequantize a group of leaves a hop; the round
             must equal the same round leaf by leaf bit for bit, with groups
             x steps dequantize launches); dequantize at each group
             as one launch, beside the same leaves in single launches, the
             bound of the group's bytes and, where one call computes the
             same values (int8, leaves of whole chunks or one row of one
             leaf), torch.mul(codes, scales[:, None]) as the library time,
             and through its single-leaf entry point at each quantize shape;
             the FedAvg mix at (10, 10,
             5.3 M), at the sweeps' shapes (each Table II payload's (10, 10,
             P) up to EfficientNet-B3's 12.0 M, the segmented cells') and at
             whisper's and granite's leaf shapes; the codec kernels and the
             mix also at the engine phase's shapes (one row of 2.9 M or of
             1.325 M; the mix at (1, 10, each)). Quantize, dequantize and
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
             hd 160 and 112; granite-3-2b's prefill (4, 2048, 32 / 8, 64)
             and training (2, 2048) shapes (GQA 4:1), causal bf16 timed
             beside SDPA; gemma2-2b's global layer at its prefill (1, 8192,
             8 / 4, 256) and its training shape (1, 2048), causal with
             softcap 50 and no window (no library call has a softcap: no
             library time); whisper-tiny's attentions, non-causal over its
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
             bf16, granite-3-2b's (2, 2048, 32 / 8, 64) causal and gemma2-2b's
             (1, 2048, 8 / 4, 256) with softcap 50 in bf16, qwen3-moe's training shape (1, 2048, 32 / 4, 128) and
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
3. path    — the scenarios at full width through ``run_scenario`` on the
             registered card executor (``DeviceExecutor(seed=1)``, the
             reference's ``jax``), with the launch counts set to 0 just
             before and read just after:
             paper_table3 (fp32), quantized_table3 (int8) and an int4
             variant, topk_sweep (3 rounds), mesh_smoke (tree all-reduce with
             churn, 180.9 M f32 a node) and an int8 variant, and
             paper_flooding_baseline (flooding on the complete overlay, which
             the card runs as an all-gather), each with ``verify="strict"``
             on a plan cache of its own: every epoch's plan is proven by the
             static verifier (``repro_torch.verify``) before the first
             device round, and ``verify_result`` rechecks every round the
             card reported against the static wire model; a
             ``VerificationError`` fails. Each run is traced: its
             RunReport's ``device.round_ms`` counter must equal the sum of
             its rounds' ``device_ms``. Prints a ``[verify]`` line a
             scenario (epochs, invariants proven, skipped classes with
             reasons, rounds rechecked, host seconds). quantized_table3's
             first round with 1 MB more on the wire must be rejected as
             ``conservation/bytes-on-wire`` (a planted fault). Every round must
             report numerics_ok (None for top-k, which has no deterministic
             bound), finite outputs and the exact bytes on the wire; every
             gossip kernel must have launched, and every shape a codec
             kernel launched with must have been timed in phase 2. Prints
             each gossip kernel's launches by shape and each codec kernel's
             loss, the sum over shapes of launches x (time - bound).
   sweeps  — after phase 3, two of the reference's sweeps through
             ``run_sweep(sweep, executor=DeviceExecutor(seed=1))`` at full
             width, the launch counts set to 0 just before and read just
             after: codec_x_protocol (ER(10) seed 3, EfficientNet-B0's 5.3 M
             f32 a node, {fp32, bf16, int8, int4, top-k} x {dissemination,
             segmented}: 10 cells) and payload_latency_curve (the same
             overlay, MOSGU dissemination of the 7 Table II payloads from
             MobileNetV3-Small to EfficientNet-B3's 12.0 M f32: 7 cells). A
             cell fails unless numerics_ok is True (None for top-k), every
             output is finite and its members, slots, transmissions and
             bytes equal ``run_sweep(..., executor="plan")``'s on the same
             cache; what the card holds after a sweep beyond what it held
             before must be less than any cell's parameters (each freed when
             its cell ends). Every gossip kernel
             must launch, each at shapes phase 2 held and timed (a dry run
             of both sweeps at full width there). Prints one line a cell
             (coordinates, slots, transmissions, bytes_on_wire_mb,
             numerics_ok, device_ms, peak GB) and the launches by shape.
   engine  — the runtime queue engine (``core/gossip.py``) on the card,
             after phase 3, with the launch counts set to 0 just before and
             read just after: lossy_links (ER(10), 10% drops, 2 rounds,
             dissemination) with fp32, int8 and top-k, and paper_table3's
             overlay as segmented gossip in 4 segments with fp32 and int8,
             each through the ``engine`` executor's own epoch policy and
             drop draws, each node's payload a CUDA f32 tensor at the full
             width (MobileNetV3-Small's 2.9 M; B0's 5.3 M in 4 parts) from a
             seeded generator: encoded at the round's start (quantize,
             top-k), moved with drops and retransmissions, decoded at every
             node (dequantize) and averaged by ``fedavg`` (gossip_mix).
             Fails unless the round reports and round_wire_bytes equal the
             same executor's on the CPU at the same width, both lossy rounds
             drop a send, the nodes' aggregates are bit-identical and within
             1e-6 of max |x| of the plain versions' FedAvg of the decoded
             payloads, top-k's round 1 encodes carry round 0's residual, and
             every gossip kernel launched, at shapes phase 2 timed. Prints
             each round's host wall time (the engine's host-paced loop, not
             comparable with phase 3's device_ms), peak memory and each
             kernel's launches by shape.
   tables  — a host phase after phase 3: the paper's three metrics for
             paper_table3 (MOSGU) against paper_flooding_baseline on the
             ``netsim`` executor (the fluid simulator) and the ``plan``
             executor (the analytic model): mean bandwidth (Table III), mean
             transfer time (Table IV) and round time (Table V), and the
             MOSGU / flooding ratios. These are modeled times of the paper's
             3-subnet testbed, computed on the host; beside them, the card's
             ``device_ms`` of the same two scenarios' rounds from phase 3.
             MOSGU's round must be the shorter on both executors. Then
             lossy_links on the ``event`` executor (drops retransmitted at
             virtual timestamps) and async_stragglers' steady rounds/s on
             ``event`` against ``estimate_throughput`` on the same plan,
             which must agree within the reference's +-15% (modeled testbed
             seconds). Prints the phase's wall time.
   plans   — after the tables phase: the sparse planner, the plan cache and
             the overlay search. (a) Host: scale_100k (a 100k-node k-NN
             overlay, three leaves in round 1 repaired by the incremental
             replanner) and scale_1m (a million-node ring) on the plan
             executor through one PlanCache; every round's slots,
             transfers and members must equal the JAX package's
             (PLAN_SCALE) and replan_incremental must be >= 1. (b) Host:
             optimized_vs_mst (ER(12) B0, underlay wan / edge x no
             optimizer / annealing 400 steps) on the plan and netsim
             executors through one cache; the round times must equal the
             JAX package's (PLAN_TABLE, modeled testbed seconds) and the
             annealed overlay be >= 1.15x faster analytically and faster in
             the fluid simulator; prints each search's accepted edits and
             fingerprint. (c) Card: the four cells through run_scenario at
             B0's full width (12 nodes x 5.3 M f32, a (12, 12, 5.3 M) round
             buffer), fp32 and int8, the launch counts set to 0 just
             before, each with ``verify="strict"`` on the shared cache (a
             ``[verify]`` line each; every certificate built once, then a
             cache hit: the verified stage's counters are printed); every
             round numerics_ok, each device plan the one over
             the cache's effective overlay (the annealed one for an
             optimizer cell) through the registered card executor; prints
             device_ms and the peak. (d) Card: the
             reference test's scale_100k shape at n = 300 (k-NN k = 8,
             mosgu_exchange over Borůvka + Jones-Plassmann, nodes 7 and 42
             leaving in round 1, so round 1's policy comes from
             SparsePlanner.replan) through the engine executor with each
             node's 5.3 M f32 payload on the card, fp32 and int8: the
             rounds must equal the CPU executor's (PLAN_N300), and every
             node's aggregate (its tree neighbourhood's mean: one exchange
             a round) be finite, the same twice, and within 1e-6 of max |x|
             of the plain versions' FedAvg of the payloads it received.
             The launch counts are read after (d); quantize, dequantize and
             the mix must have launched. Prints launches by shape and the
             phase's wall time.
4. serve   — smollm-360m (32 layers, d 960), falcon-mamba-7b (64 layers,
             d 4096), qwen3-moe-30b-a3b (48 layers, d 2048, 128 experts,
             60.4 GB), stablelm-12b (40 layers, d 5120, 23.3 GB) and
             zamba2-7b (81 layers: 13 super-blocks of 5 Mamba2 blocks and the
             shared attention block, then 3 Mamba2 blocks; d 3584, 11.2 GB),
             gemma2-2b (26 layers alternating local, window 4096, and global;
             d 2304, 8 / 4 heads of 256, softcaps 50 and 30, vocab 256,000,
             5.2 GB) and granite-3-2b (40 layers, d 2048, 32 / 8 heads of 64,
             vocab 49,155, 5.1 GB)
             at full width and depth, and arctic-480b at full width
             and 1 of its 35 layers (26.8 GB of experts), in bf16, params
             from Model.init on the card (seed 0; stacked leaves filled in
             place), with the launch counts set to 0 just before and read
             just after: three prefill forwards over (4, 2048), (2, 2048),
             (2, 2048) and (1, 2048) tokens, gemma2's over (1, 8192), where
             the window masks keys, granite's over (4, 2048) (the first a
             warm-up), then the
             serve loop at the reference CLI's defaults (batch 4, prompt 32,
             gen 16, cache 128) or, for arctic, 8 decode steps. Every logit
             finite (gemma2's every |logit| within its final softcap of 30 +
             1e-3; granite's padded vocab columns -1e9 and no argmax among
             them); flash_attention launched once a dense or moe layer or a
             use of the hybrid's shared block and selective_scan once a
             Mamba1 layer per forward, the other model kernel never; zamba2's
             Mamba2 blocks' share of its prefill (one block timed alone at
             the prefill shape, times the blocks). Prints each model
             kernel's launches by shape, prefill ms
             and tok/s, decode ms/step and tok/s and peak memory, and the
             device time of one decode step replayed as a CUDA graph (not
             arctic); gemma2's local and global layers' flash device time
             over its prefill apart (CUDA events around each call), beside
             their share of (q, k) pairs. Then gemma2-2b and granite-3-2b
             at full depth, bf16, batch 1, one ``long_500k`` decode step as
             the dry run traces it (``build_model(cfg, "long_500k")``,
             ``init_cache(1, 524288)``, position 524287: granite's cache a
             ring of 4096 in all 40 layers, gemma2's a ring of 4096 and a
             global cache of 524,288 in 13 layers each, 27.9 GB): finite
             logits, no kernel launched (decode keeps the masked einsum),
             its device time and peak, and counted for phase 7. Then, in
             f32 at full width, 4 layers (2 for qwen3-moe,
             capacity factor 100 as tests/test_models.py decodes moe archs;
             13 for zamba2: two super-blocks and a tail block, so the shared
             block's decode cache is used twice),
             forward logits against teacher-forced decode logits over a
             256-token prompt, within 5e-2 (the bound of tests/test_models.py);
             granite-3-2b at 4 layers the same way; gemma2-2b at 2 layers
             (a local / global pair) and granite-3-2b's ``long_500k`` variant
             at 2 layers (every layer windowed) over (1, 4352) tokens, the
             window plus 256, so their rings of 4096 wrap: the decode within
             5e-2 there too, and the windowed forward differs from full
             attention on the same params by more than 10x the decode's
             error past the ring. Each check's decode step replays as a CUDA
             graph (its last step bit-identical to the eager step), the
             error's maximum stays on the device and is read once a check,
             and its wall time is printed.
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
             and paligemma at 4 layers with no patches. Each arch's prefill
             runs once more under the op counter (``launch/op_analysis.py``)
             for phase 7.
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
             each run's model kernels' launches by shape and each step's
             time by host clock, synchronized, split into the
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
             scan differentiated by autograd as the reference. Then
             granite-3-2b at full width and 4 of its 40 layers (0.344 B
             params a node), 4 nodes x (2, 2048), lr 3e-4: int8
             dissemination for 2 steps (its codec and mix shapes timed in
             phase 2, their launches joining those rows), tree_allreduce for
             4 (the fourth profiled), the f32 gradient check at 4 layers;
             and gemma2-2b at full width and 2 of its 26 layers (a local /
             global pair, 0.746 B params a node), 4 nodes x (1, 2048), lr
             3e-4: tree_allreduce for 4 steps (the fourth profiled; its 47.7
             GB dissemination buffer printed), the f32 gradient check over
             (1, 4352) tokens, where the local layer's window masks keys in
             the flash backward. Each launches the flash forward and
             backward once a layer a node a step.
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
7. dryrun  — the one-card dry run (``repro_torch.launch.dryrun``) against
             the card. Each phase-5 run ends with one more steady step, and
             each phase-4 arch with one more prefill, and gemma2-2b's and
             granite-3-2b's ``long_500k`` decode steps, under the op counter,
             its peak from ``reset_peak_memory_stats`` on; the dry run of the
             same config (the ArchConfig, DFLConfig, node count, cut depth,
             batch and f32 frontends) must give the same FLOPs exactly, the
             same kernel launches exactly as the op counter and
             ``launch_counts()``, the same bytes of live tensors at the start,
             and a peak that, with the card memory the process holds beside
             those tensors (measured at the start: the tensors Python holds,
             cuBLAS's workspaces and the rest, each printed), is within
             PEAK_TOL of ``max_memory_allocated`` (printed beside: the bytes
             requested and the allocator's rounding). Prints each run's
             roofline terms at H100 constants, its bound, phase 5's
             unprofiled steady step time (phase 4's prefill median), its
             roofline share and MFU with the card's name and power limit;
             the card memory outside the allocator; then the dry run of every
             arch x INPUT_SHAPES entry (the ``--all`` table: 4 nodes, full
             depth but arctic-480b's train_4k at 4 of 35 layers, each pair
             ok or skipped, fits_hbm against the card's
             memory; a counted decode step is held to its ``long_500k`` pair,
             traced once); the scan backward's workspace against the source's
             count; and its own seconds. The dry runs trace in a pool of
             spawned processes, one a CPU up to 8, begun after phase 6, so no
             timed phase shares the host with them; the pool's size, the
             host's CPU count and its wall time are printed.
8. mesh    — the mesh (``launch/mesh.py``, ``dfl/sharding.py``). (a)
             smollm-360m and falcon-mamba-7b on a one-rank NCCL mesh: phase
             4's params (its seed) and tokens as DTensors split by
             ``param_spec_tree`` (every placement replicated at size 1), the
             three prefills and the serve loop at the reference CLI's
             defaults with the cache ``init_cache`` makes on the mesh; the
             logits bit-identical to phase 4's (or within 1e-5 of max
             |logit|), the same flash / scan launches a forward and a step.
             (b) rank 0 of the 16x16 layout under a fake process group of
             256 ranks with real tensors on the card: falcon-mamba-7b (the
             scan on its 512 local channels) and qwen3-moe-30b-a3b (flash on
             2 local heads, experts over "data") at full depth, prefill_32k
             (decode_32k when the meshed dry run says the prefill does not
             fit), rank 0's shards made directly; a warm-up, a timed and a
             counted step, held to the meshed dry run: FLOPs, launches and
             collectives by kind exactly, the peak within PEAK_TOL as phase 7
             holds it; prints the step's time, roofline terms and share.
             (c) the meshed --all table (every arch x INPUT_SHAPES at 16x16
             and 2x16x16, full depth; training for (d)'s two archs), traced in
             phase 7's processes behind its own dry runs. (d) rank 0 of 16x16
             train_4k under the fake group with real tensors, the meshed
             trainer at the whole 256-row batch (``phase_mesh``). Every kernel
             of the path must launch in (a), (b) and (d).

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
import functools
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOSSIP_KERNELS = ("quantize", "dequantize", "topk_select", "gossip_mix")
# the kernels whose phase-6 launches are held to the shapes phase 2 timed
SHAPED_KERNELS = (*GOSSIP_KERNELS, "flash_attention", "flash_attention_bwd")
CODEC_KERNELS = ("quantize", "dequantize", "topk_select")
MODEL_KERNELS = ("flash_attention", "selective_scan")
# phase 8 (a): the phase-4 archs served again on a one-rank NCCL mesh
MESH_SERVE = ("smollm-360m", "falcon-mamba-7b")
# phase 8 (b): rank 0 of the 16x16 layout, at prefill_32k (decode_32k when
# the meshed dry run says the prefill does not fit the card)
MESH_RANK0 = ("falcon-mamba-7b", "qwen3-moe-30b-a3b")
MESH_LAYOUTS = ("16x16", "2x16x16")
# phase 8 (d): rank 0 of 16x16 train_4k, (arch, gossip mode, codec): the
# meshed trainer at full width on 16 nodes, at train_4k's whole global batch
# of 256 rows (16 a node), which fits the card because the logits stay split
# by vocabulary (ROADMAP P9); the sequence split over "model" between
# sublayers (P10) makes the step reduce-scatter
MESH_TRAIN = (("smollm-360m", "dissemination", "int8"),
              ("falcon-mamba-7b", "tree_allreduce", "topk"))
MESH_TRAIN_BATCH = 256
# the host phase after phase 3: the paper's MOSGU cell and its flooding
# baseline, each on the two timing executors
TABLE_SCENARIOS = ("paper_table3", "paper_flooding_baseline")
# the engine phase: the queue engine over each scenario's own epoch policy
# with full-width payloads on the card, each run with these codecs; the
# paper's cell runs as segmented gossip in ENGINE_SEGMENTS segments
ENGINE_RUNS = (("lossy_links", ("fp32", "int8", "topk")), ("paper_table3", ("fp32", "int8")))
ENGINE_SEGMENTS = 4
# the plans phase (after the tables phase): the sparse planner at scale on the
# plan executor, each round's (slots, transfers, members) as the JAX
# package's plan executor gives them
PLAN_SCALE = {"scale_100k": ((4, 199_998, 100_000), (4, 199_992, 99_997)),
              "scale_1m": ((4, 1_999_998, 1_000_000),)}
# optimized_vs_mst's dry table, the JAX package's round times (modeled testbed
# seconds, 4 decimals): underlay -> (plan MST, plan annealed, netsim MST,
# netsim annealed); 132 transfers in every cell
PLAN_TABLE = {"wan": (209.5, 149.5333, 194.8, 149.8167),
              "edge": (284.9983, 219.4191, 280.165, 217.4191)}
PLAN_TABLE_TX = 132
# the reference test's scale_100k shape at n = 300 through the queue engine:
# (slots, transfers, members) a round
PLAN_N300 = ((3, 598, 300), (3, 594, 298))
# f32 a node of the CPU executor's run beside it (the routing it is held to
# does not depend on the width)
PLAN_N300_HOST_ELEMS = 4096
# (sweep, repeats) whose plan-executor run_cells is timed batched and serial
PLAN_RUN_CELLS = (("table3_full", 5), ("codec_x_protocol", 5), ("optimized_vs_mst", 1))
PLAN_CODECS = ("fp32", "int8")
# phase 5's int8 dissemination runs, (arch, cut depth or 0 for all layers):
# phase 2 finds and times their codec and mix shapes from one round of each
PHASE5_INT8 = (("whisper-tiny", 0), ("granite-3-2b", 4))
# phase 4: the prefill's tokens a row where not 2048 (whisper's 448 text
# positions, Whisper's text context, arXiv:2212.04356; gemma2-2b's 8192,
# twice its local layers' window of 4096, so the window masks keys)
SERVE_SEQ = {"whisper-tiny": 448, "gemma2-2b": 8192}
# phase 4: the archs whose long_500k decode step runs at full depth
LONG_DECODE = ("gemma2-2b", "granite-3-2b")
# phase 7's --all pairs traced at a cut depth: arctic-480b's training step
# at full depth (35 layers x 8 microbatches x 128 experts) traced for 289-391 s
# on an H100's host, alone the length of the dry-run pool, and at any depth
# it needs terabytes (16,050 GB at 35 layers)
ALL_CUT = {("arctic-480b", "train_4k"): 4}
# the sweeps part: the reference's sweeps run on the card executor, with their cell counts
CARD_SWEEPS = {"codec_x_protocol": 10, "payload_latency_curve": 7}
# P8: qwen3-moe's 16x16 prefill at 2 layers, traced on the card (its peak is
# the CPU trace's reference in tests/test_torch_dryrun.py)
P8_PAIR = ("16x16", "qwen3-moe-30b-a3b", "prefill_32k", 2)

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


# phase 7's bound on |measured - predicted| peak over the measured peak, where
# the prediction adds to the dry run's peak the card memory the process holds
# beside the step's live tensors at its start (tensors of earlier phases,
# cuBLAS's workspaces, the allocator's rounding of both), measured there. On
# an H100 80GB HBM3 the largest gap was 0.674% (whisper-tiny's training step:
# 41.7 MB of the allocator's rounding of the step's own blocks). The bytes
# requested at the peak, less those tensors and workspaces, must equal the
# dry run's peak exactly
PEAK_TOL = 0.01


def dry_worker(kwargs):
    """One dry run (``launch/dryrun.py``) in a pool process, with the card
    memory the process allocated (the trace should need none)."""
    import torch

    from repro_torch.launch.dryrun import dryrun_pair

    torch.set_num_threads(1)
    res = dryrun_pair(**kwargs, verbose=False)
    res["card_bytes"] = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
    return res


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


def strict_run(spec, cache, tag: str):
    """``run_scenario(spec, executor=DeviceExecutor(seed=1),
    verify="strict")`` on ``cache``, traced: every epoch's plan is proven
    before the first device round. A ``VerificationError`` fails. The run's
    RunReport must count its rounds' device time (``device.round_ms``, the
    sum of their ``device_ms``). Then ``verify_result`` must recheck every
    round the card reported against the static wire model, and a second
    ``verify_scenario_plans`` on the cache returns the run's certificates
    (cache hits). Prints one ``[verify]`` line: epochs, the invariants
    proven, the skipped classes with their reasons, the rounds rechecked
    and the host seconds (the ``verify`` spans of the run's recorder, and
    the recheck). Returns ``(the executor's card view of the run, wall
    seconds of the run, host seconds of verification)``."""
    from repro_torch import obs
    from repro_torch.scenario import DeviceExecutor, run_scenario
    from repro_torch.verify import (INVARIANT_CLASSES, VerificationError, verify_result,
                                    verify_scenario_plans)

    ex = DeviceExecutor(seed=1)
    t0 = time.perf_counter()
    try:
        with obs.recording(obs.Recorder()) as rec:
            result = run_scenario(spec, executor=ex, verify="strict", plan_cache=cache)
    except VerificationError as exc:
        fail(f"{tag}{spec.name}: static verification rejected the plan: {exc}")
    wall = time.perf_counter() - t0
    run = ex.run
    traced_ms = result.report["counters"].get("device.round_ms")
    if traced_ms is None or not math.isclose(traced_ms, sum(r.device_ms for r in run.rounds),
                                             rel_tol=1e-9):
        fail(f"{tag}{spec.name}: the RunReport's device.round_ms {traced_ms} is not the sum "
             f"of the rounds' device_ms {[r.device_ms for r in run.rounds]}")
    plan_s = sum(sp.duration_s for sp in rec.spans if sp.cat == "verify")
    t0 = time.perf_counter()
    try:
        rounds = verify_result(spec, run, plan_cache=cache)
    except VerificationError as exc:
        fail(f"{tag}{spec.name}: the card's round reports fail conservation: {exc}")
    recheck_s = time.perf_counter() - t0
    hits = cache.counters["verified_hits"]
    out = verify_scenario_plans(spec, plan_cache=cache, mode="strict")
    certs = out["certificates"]
    if rounds != len(run.rounds):
        fail(f"{tag}{spec.name}: verify_result rechecked {rounds} of {len(run.rounds)} rounds")
    if rec.counters.get("verify.plans") != out["epochs"] or \
            cache.counters["verified_hits"] - hits != out["epochs"]:
        fail(f"{tag}{spec.name}: {rec.counters.get('verify.plans')} plans verified in the run, "
             f"{out['epochs']} epochs")
    proven = sorted({i for c in certs for i in c.invariants}, key=INVARIANT_CLASSES.index)
    skipped = {k: v for c in certs for k, v in c.skipped.items()}
    print(f"[verify] {tag}{spec.name} (codec {spec.codec or 'none'}): {out['epochs']} epoch(s) "
          "verified before the first round, "
          f"invariants proven a plan {[len(c.invariants) for c in certs]} of "
          f"{len(INVARIANT_CLASSES)}; skipped {json.dumps(skipped) if skipped else 'none'}; "
          f"{rounds} round(s) rechecked by verify_result; host {plan_s:.4f} s verifying "
          f"+ {recheck_s:.4f} s rechecking")
    if len(proven) + len(skipped) < len(INVARIANT_CLASSES):
        fail(f"{tag}{spec.name}: invariant classes neither proven nor skipped")
    return run, wall, plan_s + recheck_s


def bound_ms(cost, ops_per_s: float):
    """The least time the card could take for a kernel's ``Cost`` (its cost
    function's), in ms, and what bounds it, at the H100 data sheet's rates
    (``launch/roofline.py``)."""
    from repro_torch.launch.roofline import HBM_BW

    t_bytes, t_ops = cost.bytes / HBM_BW, cost.flops / ops_per_s
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


def check_logits(arch, cfg, logits):
    """A final softcap bounds every logit (|logit| <= cap + 1e-3, as
    tests/test_models.py holds gemma2's); a padded vocabulary's columns read
    -1e9 and no row's argmax falls among them. Reductions only: no copy of
    the logits is made."""
    vocab = cfg.vocab
    if cfg.final_logit_softcap:
        top = max(float(logits[..., :vocab].amax()), -float(logits[..., :vocab].amin()))
        if not top <= cfg.final_logit_softcap + 1e-3:
            fail(f"{arch}: max |logit| {top} above the final softcap {cfg.final_logit_softcap}")
    if logits.shape[-1] != vocab:
        if not bool((logits[..., vocab:] == -1e9).all()):
            fail(f"{arch}: a padded vocab column of the logits is not -1e9")
        if not bool((logits.argmax(dim=-1) < vocab).all()):
            fail(f"{arch}: a row's argmax falls in the padded vocab columns")


def flash_ms_by_window(model, params, batch):
    """One prefill forward with CUDA events around each flash call: the
    device ms of the calls by their sliding window (0: a global layer), as
    {window: [ms, ...]}."""
    import torch

    from repro_torch.models import attention as attn_model

    inner, spans = attn_model.flash_attention_op, []

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kw)
        end.record()
        spans.append((kw["sliding_window"], start, end))
        return out

    attn_model.flash_attention_op = timed
    try:
        with torch.inference_mode():
            model.forward(params, batch)
    finally:
        attn_model.flash_attention_op = inner
    torch.cuda.synchronize()
    by_window = {}
    for window, start, end in spans:
        by_window.setdefault(window, []).append(start.elapsed_time(end))
    return by_window


def decode_against_forward(model, params, tokens, frontend=None, wrap=False):
    """Teacher-forced decode of ``tokens`` (b, s) from ``init_cache(b, s)``
    (whisper's cross cache filled from its encoder), each step's logits
    against the forward's at that position: the max |difference| over every
    step and, with ``wrap``, over the steps at or past the first windowed
    cache's ring length, kept on the device and read once. The step is
    replayed as a CUDA graph (the token, position and cache copied into its
    inputs); its last step must give the eager step's logits bit for bit.
    Returns (max err, max err past the ring, ring length)."""
    import torch

    from repro_torch.models import Batch
    from repro_torch.optim.optimizers import tree_leaves

    cfg, vocab, dev = model.cfg, model.cfg.vocab, tokens.device
    b, s = tokens.shape
    frontend = frontend or {}
    with torch.inference_mode():
        full, _ = model.forward(params, Batch(tokens=tokens, **frontend))
        cache = model.init_cache(b, s)
        if cfg.family == "audio":
            cache = fill_whisper_cross(model, params, frontend["encoder_frames"], cache)
        ring = min((c["k"].shape[2] for c in cache.values() if isinstance(c, dict) and "k" in c),
                   default=s)
        tok, pos = tokens[:, :1].clone(), torch.zeros(b, dtype=torch.long, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_step(params, tok, pos, cache)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step, new = model.decode_step(params, tok, pos, cache)
        leaves, new_leaves = tree_leaves(cache), tree_leaves(new)
        worst = torch.zeros((), device=dev)
        late = torch.zeros((), device=dev)
        for t in range(s):
            tok.copy_(tokens[:, t:t + 1])
            pos.fill_(t)
            if t == s - 1:  # the last step's inputs, for the eager step
                last = [x.clone() for x in leaves]
            graph.replay()
            err = (step[:, 0, :vocab] - full[:, t, :vocab]).abs().amax()
            worst = torch.maximum(worst, err)
            if wrap and t >= ring:
                late = torch.maximum(late, err)
            for x, y in zip(leaves, new_leaves):
                if x is not y:
                    x.copy_(y)
        for x, y in zip(leaves, last):
            x.copy_(y)
        eager, _ = model.decode_step(params, tok, pos, cache)
        if not torch.equal(eager, step):
            fail(f"{cfg.name}: the decode step replayed as a CUDA graph differs from the eager "
                 "step")
        del graph
    return float(worst), float(late), ring


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


def fake_group_fill():
    """A dispatch mode for training under the fake group: there a
    collective moves no data and leaves its output unwritten (whatever the
    allocator's block held), and through 64 layers of a backward such values
    reach inf. Entered below the op counter, it writes each all-gather's
    output with copies of this rank's input, a reduce-scatter's with the
    rank's own chunk and an all-to-all's with its input's elements, so the
    step computes on finite data of the layout's magnitudes. The writes
    come after the counter has seen the collective and allocate nothing:
    every count is the step's own. Values stay those of one rank's data,
    not of 256 ranks'."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Fill(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if func.namespace == "_c10d_functional" and name == "all_gather_into_tensor":
                n = args[1]
                out.view(n, -1).copy_(args[0].reshape(1, -1).expand(n, -1))
            elif func.namespace == "_c10d_functional" and name == "reduce_scatter_tensor":
                out.view(-1).copy_(args[0].reshape(args[2], -1)[0])
            elif name in ("all_to_all_single", "shard_dim_alltoall"):
                out.view(-1).copy_(args[0].reshape(-1))
            return out

    return Fill()


def engine_spec(name, codec):
    """The engine phase's spec: the registry scenario with the run's codec,
    the paper's cell as segmented gossip."""
    from repro_torch.scenario import scenarios

    spec = scenarios.get(name).replace(codec=codec)
    if name == "paper_table3":
        spec = spec.replace(protocol="segmented", n_segments=ENGINE_SEGMENTS)
    return spec


def engine_widths():
    """(elements a node, parts a node) of each engine run's payload: one
    part at the scenario's full f32 width, or ENGINE_SEGMENTS of its
    segments."""
    out = {}
    for name, _ in ENGINE_RUNS:
        spec = engine_spec(name, None)
        elems = int(round(spec.payload_mb() * 1e6 / 4))
        parts = spec.n_segments if spec.protocol == "segmented" else 1
        if elems % parts:
            raise ValueError(f"{name}: {elems} elements do not split into {parts} segments")
        out[name] = (elems // parts, parts, spec.n)
    return out


def engine_launch_shapes():
    """Each gossip kernel's launch shapes on the engine phase's path: a
    payload part is one row, a FedAvg stacks the n parts of a segment."""
    shapes = {"quantize": set(), "dequantize": set(), "topk_select": set(), "gossip_mix": set()}
    for name, codecs in ENGINE_RUNS:
        size, _, n = engine_widths()[name]
        if "int8" in codecs:
            shapes["quantize"].add((1, size, 8))
            shapes["dequantize"].add((1, (size,), 8))
        if "topk" in codecs:
            shapes["topk_select"].add((1, size, 256, 13))
        shapes["gossip_mix"].add((1, n, size))
    return shapes


def plain_decode(codec, payload):
    """An encoded payload part decoded by the plain versions."""
    from repro_torch.kernels.codec import ref as codec_ref
    from repro_torch.kernels.codec.ops import topk_scatter

    leaf = payload.data
    if codec.name == "fp32":
        return leaf
    if codec.name == "topk":
        return topk_scatter(leaf["values"], leaf["indices"], size=leaf["size"],
                            block=codec.block).reshape(leaf["shape"])
    return codec_ref.dequantize_rows(leaf["codes"], leaf["scales"], leaf["size"],
                                     codec.bits, codec.chunk).reshape(leaf["shape"])


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are a check's, not the path's: the launch
    counts and shapes are put back as they were on exit."""
    from repro_torch.kernels import LAUNCHES, SHAPES

    counts, shapes = dict(LAUNCHES), {k: Counter(v) for k, v in SHAPES.items()}
    try:
        yield
    finally:
        LAUNCHES.update(counts)
        for k, v in shapes.items():
            SHAPES[k].clear()
            SHAPES[k].update(v)


@functools.lru_cache(maxsize=None)
def sized_engine():
    """The engine executor with each node's payload ``size`` f32 a part from
    a seeded generator on its device (fp32 through the identity codec, so its
    wire bytes are tallied too). Every round keeps its report, its
    round_wire_bytes, its host wall time and each node's received set. With
    ``check`` each node's aggregate is held to the plain versions' FedAvg of
    the payloads that node received: finite, the same when aggregated twice,
    within 1e-6 of max |x|, and bit-identical across nodes that received the
    same payloads; with ``complete`` every node must have received every
    payload (dissemination's promise). Built on first call, so that the port
    is imported only once the script runs."""
    import torch

    from repro_torch.compress import make_codec
    from repro_torch.core.gossip import fedavg
    from repro_torch.kernels.codec import ref as codec_ref
    from repro_torch.kernels.mixing.ref import gossip_mix_ref
    from repro_torch.scenario.executors import EngineExecutor

    class SizedEngine(EngineExecutor):
        def __init__(self, device, size, check, complete=False, tag="[engine]"):
            super().__init__(device=device)
            self.size, self.check, self.complete, self.tag = size, check, complete, tag
            self.rounds = []

        def begin_epoch(self, mod, members):
            super().begin_epoch(mod, members)
            self._engine.codec = self.codec or make_codec("fp32")
            self.parts = self.spec.n_segments if self.spec.protocol == "segmented" else 1
            self._proxies = []
            for u in members:
                gen = torch.Generator(device=self._device).manual_seed(1000 + u)
                xs = [torch.randn(self.size, generator=gen, device=self._device)
                      for _ in range(self.parts)]
                self._proxies.append(xs if self.parts > 1 else xs[0])

        def run_round(self, rctx):
            engine = self._engine
            residual = {pid: st[""].clone() for pid, st in engine._ef_states.items()
                        if isinstance(st, dict)}  # top-k's, before this round's encode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = super().run_round(rctx)
            aggs = engine.aggregate(fedavg) if self.check else None
            torch.cuda.synchronize()
            row = dict(report=rep, wire=engine.round_wire_bytes,
                       wall_ms=1e3 * (time.perf_counter() - t0),
                       received=[sorted(r) for r in engine.received_snapshot()])
            if self.check:
                with uncounted():  # the second aggregation only checks the first
                    again = engine.aggregate(fedavg)
                row.update(self.held(engine, aggs, again, residual))
            self.rounds.append(row)
            return rep

        def held(self, engine, aggs, again, residual):
            codec, store, parts = engine.codec, engine._store, self.parts
            what = f"{self.tag} {self.spec.name} {codec.name}"
            if self.complete and any(set(nd.received) != set(store) for nd in engine.nodes):
                fail(f"{what}: a node did not receive every payload")
            firsts, worst = {}, 0.0
            for nd, agg, agg2 in zip(engine.nodes, aggs, again):
                for j in range(parts):
                    got, got2 = (agg[j], agg2[j]) if parts > 1 else (agg, agg2)
                    if not (torch.equal(got, got2) and bool(torch.isfinite(got).all())):
                        fail(f"{what} node {nd.node_id}: the aggregate is not finite or "
                             "differs between two runs")
                    pids = tuple(pid for pid in sorted(nd.received) if pid % parts == j)
                    if pids in firsts:
                        if not torch.equal(firsts[pids], got):
                            fail(f"{what} segment {j}: two nodes that received the same "
                                 "payloads aggregate them differently")
                        continue
                    firsts[pids] = got
                    xs = [plain_decode(codec, store[pid]) for pid in pids]
                    scale = max(float(x.abs().max()) for x in xs)
                    want = gossip_mix_ref(torch.stack(xs).unsqueeze(0), torch.full(
                        (len(xs),), 1.0 / len(xs), device=xs[0].device))[0]
                    worst = max(worst, float((got - want).abs().max()) / scale)
                    del xs, want
            if not worst <= 1e-6:
                fail(f"{what}: an aggregate {worst:.3e} of max |x| from the plain FedAvg of "
                     "its node's payloads")
            if codec.name == "topk" and residual:
                # the round's encode of node 0 carries the last round's residual
                x = self._proxies[0] + residual[0]
                vals, idx = codec_ref.topk_select_rows(x.reshape(1, -1), codec.k, codec.block)
                leaf = store[0].data
                if not (torch.equal(vals, leaf["values"]) and torch.equal(idx, leaf["indices"])):
                    fail(f"{what}: node 0's encode does not carry the previous round's "
                         "residual")
            return dict(err=worst, degrees=sorted({len(nd.received) for nd in engine.nodes}),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    return SizedEngine


def phase_engine(card, add_shape_launches, results) -> None:
    """The queue engine on the card: ENGINE_RUNS through the engine
    executor's epochs, policies and drop draws, with each node's payload a
    CUDA f32 tensor at the scenario's full width from a seeded generator,
    encoded at each round's start (the quantize and top-k kernels), moved
    through the FIFO queues with drops and retransmissions, decoded at every
    node (dequantize) and averaged by ``fedavg`` (gossip_mix); top-k's
    residual carried from round 0 into round 1. Each run's counts and wire
    bytes equal the same executor's on the CPU at the same width; the
    nodes' aggregates are bit-identical to one another and within 1e-6 of
    max |x| of the plain versions' FedAvg of the decoded payloads."""
    import torch

    from repro_torch.compress import make_codec
    from repro_torch.kernels import launch_counts, launch_shapes, reset_launches

    SizedEngine = sized_engine()

    t_phase = time.perf_counter()
    reset_launches()  # the counts of the engine phase's path
    widths = engine_widths()
    for name, codecs in ENGINE_RUNS:
        size, parts, n = widths[name]
        for codec_name in codecs:
            spec = engine_spec(name, codec_name)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            card_run = SizedEngine("cuda", size, check=True, complete=True)
            res = card_run.execute(spec)
            with_counts = launch_counts()
            host = SizedEngine("cpu", size, check=False)
            cpu = host.execute(spec)
            if launch_counts() != with_counts:
                fail("[engine] the CPU executor's run launched a kernel")
            if [r.to_dict() for r in res.rounds] != [r.to_dict() for r in cpu.rounds]:
                fail(f"[engine] {name} {codec_name}: the card's round reports differ from the "
                     "CPU executor's")
            for r, (got, want) in enumerate(zip(card_run.rounds, host.rounds)):
                rep = got["report"]
                wire = make_codec(codec_name).wire_bytes(size)
                if got["received"] != want["received"]:
                    fail(f"[engine] {name} {codec_name} round {r}: the nodes' received sets "
                         "differ from the CPU executor's")
                if got["wire"] != want["wire"] or got["wire"] != rep.transmissions * wire:
                    fail(f"[engine] {name} {codec_name} round {r}: round_wire_bytes "
                         f"{got['wire']} (CPU {want['wire']}, {rep.transmissions} x {wire})")
                if spec.drop_rate > 0 and rep.drops < 1:
                    fail(f"[engine] {name} round {r}: no send dropped")
                print(f"[engine] {name} ({spec.protocol}, {n} nodes x {parts} x {size} f32, "
                      f"{codec_name}) round {r}: {rep.n_slots} slots, {rep.transmissions} "
                      f"attempted transfers, {rep.drops} dropped, round_wire_bytes "
                      f"{got['wire']} (= the CPU executor's), bytes_on_wire_mb "
                      f"{rep.bytes_on_wire_mb}; aggregates bit-identical across nodes, "
                      f"{got['err']:.3e} of max |x| from the plain FedAvg; host wall "
                      f"{got['wall_ms']:.3f} ms (the queue engine's host-paced loop: encode, "
                      f"slots, decodes and FedAvg, synchronized; not comparable with phase "
                      f"3's device_ms), peak {got['peak_gb']:.3f} GB on {card}")
            del card_run, host, res, cpu
    counts, shapes = launch_counts(), launch_shapes()
    print(f"[engine] launches: {json.dumps(counts)}")
    missing = [k for k in GOSSIP_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"[engine] kernels never launched on the engine's path: {missing}")
    for kernel in GOSSIP_KERNELS:
        results[kernel]["engine_launches"] = counts[kernel]
        hist = ", ".join(f"{key} x {k}" for key, k in sorted(shapes[kernel].items()))
        print(f"[engine] {kernel} launches by shape: {hist}")
        add_shape_launches(kernel, shapes[kernel], "engine")
    torch.cuda.empty_cache()
    print(f"[engine] phase wall time {time.perf_counter() - t_phase:.2f} s on {card}")


def phase_sweeps(card, add_shape_launches, results) -> None:
    """The sweeps part: each of CARD_SWEEPS through ``run_sweep(sweep,
    executor=DeviceExecutor(seed=1))`` at full width, one PlanCache a sweep,
    the launch counts set to 0 before the first and read after the last.
    Each cell must hold the FedAvg (numerics_ok True; None for top-k), give
    finite outputs, and count the members, slots, transmissions and bytes
    of ``run_sweep(..., executor="plan")`` on the same cache; what the card
    holds after a sweep beyond what it held before must be less than any
    cell's parameters (each freed when its cell ends). Every gossip kernel
    must launch, each at shapes phase 2 timed."""
    import torch

    from repro_torch.kernels import launch_counts, launch_shapes, reset_launches
    from repro_torch.scenario import DeviceExecutor, run_sweep, scenarios
    from repro_torch.scenario.cache import PlanCache

    t_phase = time.perf_counter()
    driven = []
    reset_launches()
    for name, n_cells in CARD_SWEEPS.items():
        sweep, cache, ex = scenarios.get_sweep(name), PlanCache(), DeviceExecutor(seed=1)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = run_sweep(sweep, executor=ex, plan_cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # what stays on the card is the runs' plans (index tensors), less than
        # any one cell's parameters
        left = torch.cuda.memory_allocated() - held
        smallest = min(4 * cell.spec.n * run.elems_per_node
                       for cell, run in zip(res.cells, ex.runs))
        if len(res.cells) != n_cells or left >= smallest:
            fail(f"[sweeps] {name}: {len(res.cells)} cells (want {n_cells}), {left} bytes "
                 f"still held on the card after the sweep (a cell's parameters: >= {smallest})")
        driven.append((name, sweep, cache, res, ex.runs, wall))
    counts, shapes = launch_counts(), launch_shapes()
    for name, sweep, cache, res, runs, wall in driven:
        counted = run_sweep(sweep, executor="plan", plan_cache=cache)
        for cell, plan_cell, run in zip(res.cells, counted.cells, runs):
            spec = cell.spec
            coords = ", ".join(f"{k}={v}" for k, v in cell.coords.items())
            for r, c, dr in zip(cell.result.rounds, plan_cell.result.rounds, run.rounds):
                got = (r.members, r.n_slots, r.transmissions, r.bytes_mb, r.bytes_on_wire_mb)
                want = (c.members, c.n_slots, c.transmissions, c.bytes_mb, c.bytes_on_wire_mb)
                if got != want:
                    fail(f"[sweeps] {name} cell {cell.index} ({coords}) round {r.round}: "
                         f"{got[1:]} differ from the plan executor's {want[1:]}")
                want_ok = None if spec.codec == "topk" else True
                if r.numerics_ok is not want_ok or not dr.finite:
                    fail(f"[sweeps] {name} cell {cell.index} ({coords}) round {r.round}: "
                         f"numerics_ok={r.numerics_ok} finite={dr.finite}")
                print(f"[sweeps] {name} cell {cell.index} ({coords}): {run.elems_per_node} "
                      f"f32/node x {len(r.members)}, {r.n_slots} slots, {r.transmissions} tx, "
                      f"bytes_on_wire_mb {r.bytes_on_wire_mb} (= the plan executor's), "
                      f"numerics_ok {r.numerics_ok}, finite {dr.finite}, round "
                      f"{dr.device_ms:.3f} ms, peak {run.peak_bytes / 1e9:.3f} GB on {card}")
        peak = max(runs, key=lambda run: run.peak_bytes)
        print(f"[sweeps] {name}: {len(res.cells)} cells in {wall:.2f} s wall, peak "
              f"{peak.peak_bytes / 1e9:.3f} GB ({peak.scenario}, {peak.elems_per_node} f32 "
              f"a node), cache {json.dumps(cache.stats())} on {card}")
    print(f"[sweeps] launches: {json.dumps(counts)}")
    missing = [k for k in GOSSIP_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"[sweeps] kernels never launched on the sweeps' path: {missing}")
    for name in GOSSIP_KERNELS:
        results[name]["sweeps_launches"] = counts[name]
        add_shape_launches(name, shapes[name], "sweeps")
    print(f"[sweeps] phase wall time {time.perf_counter() - t_phase:.2f} s on {card}")


def phase_tables(device_ms, card) -> None:
    """The paper's Tables III-V metrics of TABLE_SCENARIOS on the netsim
    and plan executors (modeled testbed times, host only), the MOSGU /
    flooding ratios, the card's round ``device_ms`` of phase 3, then
    lossy_links and async_stragglers on the event executor, the latter's
    steady rate held to ``estimate_throughput`` within the reference's
    +-15%."""
    import warnings

    from repro_torch.core.network import estimate_throughput
    from repro_torch.scenario import executors, scenarios

    t0 = time.perf_counter()
    mosgu, flood = TABLE_SCENARIOS
    for ex in ("netsim", "plan"):
        rows = {}
        for name in TABLE_SCENARIOS:
            spec = scenarios.get(name)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = executors.get(ex).execute(spec)
            r = res.rounds[0]
            rows[name] = r
            note = f"; contract warning: {caught[0].message}" if caught else ""
            print(f"[tables] {ex} {name} ({spec.protocol}, {spec.overlay.kind}({spec.n}), "
                  f"{spec.payload} {spec.payload_mb()} MB): Table III bandwidth "
                  f"{r.mean_bandwidth_mbps:.4f} MB/s, Table IV mean transfer "
                  f"{r.mean_transfer_s:.4f} s, Table V round {r.total_time_s:.4f} s, "
                  f"{r.transmissions} transfers, max concurrency {r.max_concurrency} (modeled "
                  f"times of the paper's 3-subnet testbed, computed on the host, not the "
                  f"card's){note}")
        a, b = rows[mosgu], rows[flood]
        if not a.total_time_s < b.total_time_s:
            fail(f"[tables] {ex}: MOSGU's round {a.total_time_s} s is not shorter than "
                 f"flooding's {b.total_time_s} s")
        print(f"[tables] {ex} MOSGU / flooding (modeled): bandwidth "
              f"{a.mean_bandwidth_mbps / b.mean_bandwidth_mbps:.3f}x, transfer time "
              f"{b.mean_transfer_s / a.mean_transfer_s:.3f}x shorter, round time "
              f"{b.total_time_s / a.total_time_s:.3f}x shorter")
    print(f"[tables] on the card (phase 3, the same scenarios at full width): {mosgu} round "
          f"{device_ms[mosgu]:.3f} ms, {flood} round (all-gather) {device_ms[flood]:.3f} ms on "
          f"{card}")
    # the event executor: lossy links retransmitted at virtual timestamps, and
    # the asynchronous stragglers' steady rate against estimate_throughput
    lossy = executors.get("event").execute(scenarios.get("lossy_links"))
    for r in lossy.rounds:
        if r.drops < 1:
            fail(f"[tables] event lossy_links round {r.round}: no transfer dropped")
        print(f"[tables] event lossy_links round {r.round}: Table III bandwidth "
              f"{r.mean_bandwidth_mbps:.4f} MB/s, Table IV mean transfer {r.mean_transfer_s:.4f} "
              f"s, round {r.total_time_s:.4f} s (admitted {r.admitted_at_s:.4f} s, completed "
              f"{r.completed_at_s:.4f} s), {r.transmissions} attempted transfers, {r.drops} "
              f"dropped and retransmitted (modeled testbed seconds on the event engine's "
              f"virtual clock, computed on the host)")
    spec = scenarios.get("async_stragglers")
    ex = executors.get("event")
    comp = [r.completed_at_s for r in ex.execute(spec).rounds]
    warm = spec.max_staleness + 2
    measured = (comp[-1] - comp[warm - 1]) / (len(comp) - warm)
    est = estimate_throughput(ex.policy, ex._net, ex.wire_send_mb * 1e6,
                              max_staleness=spec.max_staleness,
                              compute_time_s=spec.compute_time_s,
                              compute_jitter_s=spec.compute_jitter_s)
    ratio = est.steady_period_s / measured
    print(f"[tables] event async_stragglers ({spec.rounds} rounds, staleness "
          f"{spec.max_staleness}, compute {spec.compute_time_s} + U[0, {spec.compute_jitter_s}) "
          f"s): steady {1.0 / measured:.6f} rounds/s (rounds {warm}-{len(comp) - 1}), "
          f"estimate_throughput {est.rounds_per_s:.6f} rounds/s (fill {est.fill_latency_s:.4f} "
          f"s, busiest link {est.bottleneck_busy_s:.4f} s, node span {est.node_span_s:.4f} s), "
          f"period ratio {ratio:.4f} (modeled testbed seconds)")
    if not 0.85 <= ratio <= 1.15:
        fail(f"[tables] async_stragglers: estimate_throughput's period is {ratio:.4f}x the "
             "event engine's, outside the reference's +-15%")
    print(f"[tables] phase wall time {time.perf_counter() - t0:.2f} s")


def plans_n300(codec):
    """The reference test's scale_100k shape at n = 300
    (``tests/test_sparse.py``): k-NN k = 8, 3 subnets, seed 1, one MOSGU
    exchange a round over the sparse planner's Borůvka tree and
    Jones-Plassmann colors, nodes 7 and 42 leaving in round 1 (a replan)."""
    from repro_torch.core.graph import TopologySpec
    from repro_torch.scenario import ChurnEvent, ScenarioSpec

    return ScenarioSpec(
        name="scale_smoke", overlay=TopologySpec(kind="knn", n=300, seed=1, k=8, n_subnets=3),
        protocol="mosgu_exchange", mst_algorithm="boruvka",
        coloring_algorithm="jones_plassmann", payload=21.2, rounds=2, codec=codec,
        churn=(ChurnEvent(1, "leave", 7), ChurnEvent(1, "leave", 42)), executors=("plan",))


def phase_plans(card, results, device_ms) -> None:
    """The sparse planner, the plan cache and the overlay search (host), then
    the paths they open on the card: (a) scale_100k and scale_1m on the plan
    executor through one PlanCache, every round's counts held to the JAX
    package's (PLAN_SCALE) and the incremental replan run; (b)
    optimized_vs_mst on the plan and netsim executors through one cache, the
    round times held to the JAX package's (PLAN_TABLE; modeled testbed
    seconds), the annealed overlay at least 1.15x faster analytically and
    faster in the fluid simulator; (c) the four cells through
    ``run_scenario(verify="strict")`` on the card at EfficientNet-B0's full
    width, fp32 and int8, each optimizer cell's device plan the one over the cache's
    annealed overlay; (d) the n = 300 sparse shape through the queue engine
    with each node's full-width payload on the card, fp32 and int8, the
    round-1 policy from ``SparsePlanner.replan``. Launch counts are set to 0
    before (c) and read after (d)."""
    import numpy as np
    import torch

    from repro_torch.compress import make_codec
    from repro_torch.dfl.session import plan_for_members
    from repro_torch.kernels import launch_counts, launch_shapes, reset_launches
    from repro_torch.opt import optimize_for_scenario
    from repro_torch.scenario import executors, run_sweep, scenarios
    from repro_torch.scenario.cache import PlanCache
    from repro_torch.scenario.executors import Executor

    t_phase = time.perf_counter()
    # (a) the sparse planner at scale (host)
    cache = PlanCache()
    for name, want in PLAN_SCALE.items():
        t0 = time.perf_counter()
        res = executors.get("plan").execute(scenarios.get(name), plan_cache=cache)
        wall = time.perf_counter() - t0
        got = tuple((r.n_slots, r.transmissions, len(r.members)) for r in res.rounds)
        for r in res.rounds:
            print(f"[plans] (a) {name} round {r.round}: {len(r.members)} members, {r.n_slots} "
                  f"slots, {r.transmissions} transfers, bytes_mb {r.bytes_mb}, "
                  f"bytes_on_wire_mb {r.bytes_on_wire_mb} (host, plan executor)")
        replans = {k: cache.counters[k] for k in ("replan_full", "replan_incremental",
                                                  "replan_hits", "replan_misses")}
        print(f"[plans] (a) {name}: {wall:.3f} s host wall, cache {json.dumps(replans)}")
        if got != want:
            fail(f"[plans] (a) {name}: rounds {got}, the JAX package's plan executor gives {want}")
    if cache.counters["replan_incremental"] < 1:
        fail("[plans] (a) scale_100k's churn epoch was not replanned incrementally")

    # (b) optimized_vs_mst's dry table (host; modeled testbed seconds)
    t0 = time.perf_counter()
    sweep = scenarios.get_sweep("optimized_vs_mst")
    cache = PlanCache()
    table = {ex: run_sweep(sweep, executor=ex, plan_cache=cache) for ex in ("plan", "netsim")}
    cells = [c.spec for c in sweep.cells()]
    for i, spec in enumerate(cells):
        if spec.optimizer is None:
            continue
        opt = optimize_for_scenario(spec)
        if not np.array_equal(opt.overlay.adj, cache.overlay(spec).adj):
            fail(f"[plans] (b) {spec.name}: the search's overlay is not the cache's")
        print(f"[plans] (b) {spec.name}: annealed {opt.steps} steps, {opt.accepted} accepted, "
              f"score {opt.base_score:.4f} -> {opt.best_score:.4f} s, fingerprint "
              f"{opt.fingerprint()}, {np.count_nonzero(opt.overlay.adj) // 2} of "
              f"{np.count_nonzero(spec.overlay_graph().adj) // 2} edges kept")
    for k, underlay in enumerate(PLAN_TABLE):
        mst, ann = 2 * k, 2 * k + 1
        times = [round(table[ex][i].result.rounds[0].total_time_s, 4)
                 for ex in ("plan", "netsim") for i in (mst, ann)]
        txs = {table[ex][i].result.rounds[0].transmissions
               for ex in ("plan", "netsim") for i in (mst, ann)}
        print(f"[plans] (b) optimized_vs_mst {underlay}: plan round {times[0]} (MST) / "
              f"{times[1]} (annealed) s, ratio {times[0] / times[1]:.4f}; netsim {times[2]} / "
              f"{times[3]} s, ratio {times[2] / times[3]:.4f}; {sorted(txs)} transfers "
              f"(modeled testbed seconds, computed on the host, not the card's)")
        if tuple(times) != PLAN_TABLE[underlay] or txs != {PLAN_TABLE_TX}:
            fail(f"[plans] (b) {underlay}: {times}, {txs}; the JAX package gives "
                 f"{PLAN_TABLE[underlay]}, {PLAN_TABLE_TX}")
        if not times[0] / times[1] >= 1.15 or not times[3] < times[2]:
            fail(f"[plans] (b) {underlay}: the annealed overlay is not >= 1.15x faster "
                 "analytically and faster in the fluid simulator")
    print(f"[plans] (b) cache {json.dumps(cache.stats())}; {time.perf_counter() - t0:.3f} s "
          "host wall")
    # the plan executor's batched run_cells against the serial Executor.run_cells,
    # each from a cold cache, in the order serial, batched, batched, serial
    for name, repeats in PLAN_RUN_CELLS:
        sweep_cells = scenarios.get_sweep(name).cells()
        walls, rows = {"serial": [], "batched": []}, {}
        for _ in range(repeats):
            for mode in ("serial", "batched", "batched", "serial"):
                ex, cold = executors.get("plan"), PlanCache()
                t0 = time.perf_counter()
                out = (ex.run_cells(sweep_cells, plan_cache=cold) if mode == "batched"
                       else Executor.run_cells(ex, sweep_cells, plan_cache=cold))
                walls[mode].append(time.perf_counter() - t0)
                rows[mode] = [r.to_dict() for r in out]
        if rows["batched"] != rows["serial"]:
            fail(f"[plans] (b) {name}: the batched run_cells differs from the serial one")
        print(f"[plans] (b) run_cells {name} ({len(sweep_cells)} cells, cold PlanCache each): "
              f"batched median {statistics.median(walls['batched']):.6f} s, serial median "
              f"{statistics.median(walls['serial']):.6f} s over {2 * repeats} runs each "
              "(host wall on the card's host CPU; rows equal)")

    # (c) the four cells' gossip rounds on the card at full width, each plan
    # proven first on the shared cache
    reset_launches()  # the counts of the plans phase's card path: (c) and (d)
    verify_s, verified0 = 0.0, cache.counters["verified_misses"]
    for spec0 in cells:
        for codec in PLAN_CODECS:
            spec = spec0.replace(codec=codec)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run, wall, spent = strict_run(spec, cache, "[plans] (c) ")
            verify_s += spent
            r = run.rounds[0]
            want = plan_for_members(spec.n, range(spec.n), n_segments=spec.n_segments,
                                    full_graph=cache.overlay(spec))
            (plan,) = run.plans
            same = (np.array_equal(plan.mst.adj, want.mst.adj)
                    and [s.perm for s in plan.diss_steps] == [s.perm for s in want.diss_steps]
                    and all(np.array_equal(a.send_payload, b.send_payload)
                            for a, b in zip(plan.diss_steps, want.diss_steps)))
            if not same:
                fail(f"[plans] (c) {spec.name} {codec}: the device plan is not the one over "
                     "the cache's overlay")
            if r.numerics_ok is not True or not r.finite:
                fail(f"[plans] (c) {spec.name} {codec}: numerics_ok={r.numerics_ok} "
                     f"finite={r.finite}")
            overlay = "annealed" if spec.optimizer is not None else "declared"
            print(f"[plans] (c) {spec.name} {codec}: {run.elems_per_node} f32/node x {spec.n}, "
                  f"the {overlay} overlay's MST ({len(plan.diss_steps)} permutation steps), "
                  f"{r.n_slots} slots, {r.transmissions} tx, bytes_on_wire_mb "
                  f"{r.bytes_on_wire_mb}, numerics_ok {r.numerics_ok}, round {r.device_ms:.3f} "
                  f"ms on {card} (phase 3's paper_table3 ER(10) B0: "
                  f"{device_ms['paper_table3']:.3f} ms), {wall:.2f} s wall, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
            del run
    counts_c = launch_counts()
    verified = {k: cache.counters[k] for k in ("verified_hits", "verified_misses")}
    print(f"[plans] (c) cache {json.dumps(verified)}: {verified['verified_misses'] - verified0} "
          f"plans verified, {verify_s:.4f} s of host time verifying and rechecking, on {card}")
    if verified["verified_hits"] <= 0 or \
            verified["verified_misses"] - verified0 != len(cells) * len(PLAN_CODECS):
        fail(f"[plans] (c) the verified stage: {verified}, {len(cells) * len(PLAN_CODECS)} "
             "certificates expected, each built once")

    # (d) the sparse planner's policy through the queue engine on the card
    SizedEngine = sized_engine()
    size = int(round(plans_n300("fp32").payload_mb() * 1e6 / 4))
    for codec in PLAN_CODECS:
        spec = plans_n300(codec)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = PlanCache()
        card_run = SizedEngine("cuda", size, check=True, tag="[plans] (d)")
        res = card_run.execute(spec, plan_cache=cache)
        with_counts = launch_counts()
        # the routing does not depend on the payload's width: the CPU run's is narrow
        host = SizedEngine("cpu", PLAN_N300_HOST_ELEMS, check=False)
        cpu = host.execute(spec)
        if launch_counts() != with_counts:
            fail("[plans] (d) the CPU executor's run launched a kernel")
        if [r.to_dict() for r in res.rounds] != [r.to_dict() for r in cpu.rounds]:
            fail(f"[plans] (d) {codec}: the card's round reports differ from the CPU executor's")
        for got_row, want_row in zip(card_run.rounds, host.rounds):
            if got_row["received"] != want_row["received"]:
                fail(f"[plans] (d) {codec} round {got_row['report'].round}: the nodes' "
                     "received sets differ from the CPU executor's")
        got = tuple((r.n_slots, r.transmissions, len(r.members)) for r in res.rounds)
        if got != PLAN_N300 or cache.counters["replan_incremental"] != 1:
            fail(f"[plans] (d) {codec}: rounds {got} (want {PLAN_N300}), replan_incremental "
                 f"{cache.counters['replan_incremental']} (want 1)")
        wire = make_codec(codec).wire_bytes(size)
        for row in card_run.rounds:
            rep = row["report"]
            if row["wire"] != rep.transmissions * wire:
                fail(f"[plans] (d) {codec} round {rep.round}: round_wire_bytes {row['wire']} != "
                     f"{rep.transmissions} x {wire}")
            print(f"[plans] (d) scale_smoke n=300 ({spec.protocol}, Borůvka + Jones-Plassmann, "
                  f"{size} f32 a node, {codec}) round {rep.round}: {len(rep.members)} members, "
                  f"{rep.n_slots} slots, {rep.transmissions} transfers (= the CPU executor's), "
                  f"round_wire_bytes {row['wire']}, bytes_on_wire_mb {rep.bytes_on_wire_mb}; "
                  f"payloads a node received {row['degrees']}, each node's received set the "
                  f"CPU executor's; each node's aggregate "
                  f"{row['err']:.3e} of max |x| from the plain FedAvg of its payloads, the same "
                  f"twice; host wall {row['wall_ms']:.3f} ms (encode, slots, every node's "
                  f"decodes and FedAvg, synchronized), peak {row['peak_gb']:.3f} GB on {card}")
        print(f"[plans] (d) {codec}: cache replan_full {cache.counters['replan_full']}, "
              f"replan_incremental {cache.counters['replan_incremental']}")
        del card_run, host, res, cpu
        torch.cuda.empty_cache()
    counts, shapes = launch_counts(), launch_shapes()
    print(f"[plans] launches (c): {json.dumps(counts_c)}; (c) + (d): {json.dumps(counts)}")
    path = ("quantize", "dequantize", "gossip_mix")
    missing = [k for k in path if counts[k] <= 0 or counts_c[k] <= 0]
    if missing:
        fail(f"[plans] kernels never launched on the plans phase's path: {missing}")
    for kernel in path:
        results[kernel]["plans_launches"] = counts[kernel]
        hist = ", ".join(f"{key} x {k}" for key, k in sorted(shapes[kernel].items()))
        print(f"[plans] {kernel} launches by shape: {hist}")
    print(f"[plans] phase wall time {time.perf_counter() - t_phase:.2f} s on {card}")


def phase_mesh(phase4, mesh_dry, n_prefill, smi, held_tensors, train_dry) -> None:
    """Phase 8: the mesh (``launch/mesh.py``, ``dfl/sharding.py``).

    (a) smollm-360m and falcon-mamba-7b served again on a one-rank NCCL mesh:
        phase 4's params (drawn again from its seed) and tokens as DTensors
        (every placement ``Replicate``), the three prefills and the serve loop
        at the reference CLI's defaults, the cache made by ``init_cache`` on
        the mesh; the logits bit-identical to phase 4's, the flash / scan
        launches a forward and a decode step as phase 4's;
    (b) rank 0 of the 16x16 layout under a fake process group of 256 ranks
        with real tensors on the card: falcon-mamba-7b (the scan on its
        local channels) and qwen3-moe-30b-a3b (flash on its local heads,
        experts over "data") at full depth, prefill_32k (decode_32k where the
        meshed dry run says the prefill does not fit): its shards made
        directly, a warm-up, a timed and a counted step; the meshed dry run's
        FLOPs, kernel launches and collectives exactly, its peak within
        PEAK_TOL of ``max_memory_allocated`` (with the card memory held
        beside the step's live tensors, as phase 7 measures it);
    (c) the meshed ``--all`` table: every arch x INPUT_SHAPES at both
        layouts, full depth (traced in phase 7's processes), the training
        shape for (d)'s two archs only (arctic-480b's training step alone
        traces minutes);
    (d) rank 0 of the 16x16 layout's ``train_4k`` under the fake group with
        real tensors: the meshed trainer (``MeshDFLTrainer``) for each of
        MESH_TRAIN at full width and depth and the global batch
        MESH_TRAIN_BATCH (the meshed dry run must say the step fits the
        card); a warm-up, a timed and a counted step; the
        meshed dry run's FLOPs, launches, collectives by kind (the gossip's
        point-to-point sends, ``collective-permute``, among them) and bytes
        exactly, its peak within
        PEAK_TOL; a reduce-scatter among the collectives (the sequence
        split, ROADMAP P10), printed by kind; loss and grad norm finite,
        each collective's output written with this rank's own data
        (:func:`fake_group_fill`).
    The fake group moves no data: (b) and (d) check shapes, memory, FLOPs
    and launches, never values."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs
    from repro_torch.dfl.sharding import (batch_axes, batch_spec, distribute_tree,
                                          local_param_tree, param_shapes, param_spec_tree,
                                          placements)
    from repro_torch.kernels import KERNEL_NAMES, launch_counts, reset_launches
    from repro_torch.configs import InputShape
    from repro_torch.dfl.collectives import P2P_KIND
    from repro_torch.dfl.trainer import DFLConfig, MeshDFLTrainer
    from repro_torch.launch.dryrun import (_inputs, fake_group, meshed_inputs,
                                           meshed_train_state, meshed_train_step,
                                           run_meshed_step)
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.serve import serve
    from repro_torch.models import Batch, build_model

    t8 = time.perf_counter()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    reset_launches()  # the counts of phase 8's path
    # -- (a) one NCCL rank -------------------------------------------------------------
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_local_mesh((1, 1))
    for arch in MESH_SERVE:
        ref = phase4[arch]
        cfg = get_arch(arch)
        kernel, batch = ref["kernel"], ref["batch"]
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device=dev).manual_seed(0))  # phase 4's draws
        model.set_mesh_context(mesh, batch_axes(mesh, batch))
        specs = param_spec_tree(cfg, params, mesh)
        dparams = distribute_tree(mesh, params, specs)
        del params
        tokens = distribute_tensor(ref["tokens"].to(dev), mesh,
                                   placements(mesh, batch_spec(mesh, batch, 2)))
        before, spans = launch_counts(), []
        with torch.no_grad():
            for i in range(n_prefill):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = model.forward(dparams, Batch(tokens=tokens))
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t0)
                if i == 0:
                    got = logits.to_local().cpu()
                del logits
        n = launch_counts()[kernel] - before[kernel]
        if n != ref["per_fwd"] * n_prefill:
            fail(f"mesh {arch}: {kernel} launched {n} times in {n_prefill} meshed forwards, "
                 f"phase 4 {ref['per_fwd']} a forward")
        same = torch.equal(got, ref["logits"])
        err = float((got - ref["logits"]).abs().max() / ref["logits"].abs().max())
        if not (same or err <= 1e-5):
            fail(f"mesh {arch}: meshed prefill logits {err:.3e} of max |logit| from phase 4's")
        ms = statistics.median(spans[1:]) * 1e3
        print(f"[mesh] (a) {arch} on a 1-rank NCCL mesh (1, 1), {cfg.n_layers} layers: prefill "
              f"({batch}, {ref['seq']}) {ms:.3f} ms median of {n_prefill - 1} after a warm-up "
              f"(phase 4 unsharded {ref['prefill_ms']:.3f} ms), {ref['per_fwd']} {kernel} "
              f"launches a forward; logits {'bit-identical to' if same else 'within'} phase 4's"
              f"{'' if same else f' ({err:.3e} of max |logit|)'} on {card}")
        prompts = distribute_tensor(ref["prompts"].to(dev), mesh,
                                    placements(mesh, batch_spec(mesh, ref["prompts"].shape[0], 2)))
        before = launch_counts()[kernel]
        res = serve(model, dparams, prompts, gen=ref["gen"], cache_len=128)
        n = launch_counts()[kernel] - before
        if n != ref["per_step"] * res.steps:
            fail(f"mesh {arch}: {kernel} launched {n} times in {res.steps} meshed decode steps")
        toks, last = res.tokens.to_local().cpu(), res.logits.to_local().cpu()
        if not torch.equal(toks, ref["serve_tokens"]):
            fail(f"mesh {arch}: the meshed serve loop generated other tokens than phase 4's")
        same = torch.equal(last, ref["serve_logits"])
        err = float((last - ref["serve_logits"]).abs().max() / ref["serve_logits"].abs().max())
        if not (same or err <= 1e-5):
            fail(f"mesh {arch}: meshed decode logits {err:.3e} of max |logit| from phase 4's")
        step_ms = 1e3 * res.seconds / res.steps
        print(f"[mesh] (a) {arch}: serve loop batch {prompts.shape[0]}, prompt "
              f"{prompts.shape[1]}, gen {ref['gen']}, cache 128 (DTensor cache, "
              f"cache_spec_tree): {res.steps} steps, {step_ms:.3f} ms/step (phase 4 "
              f"{ref['step_ms']:.3f}), tokens equal to phase 4's, last logits "
              f"{'bit-identical' if same else f'within {err:.3e}'} on {card}")
        model.set_mesh_context(None)
        del dparams, res, model, tokens, prompts
        torch.cuda.empty_cache()
    dist.destroy_process_group()

    # -- (b) rank 0 of 16x16 under a fake group, real tensors on the card ----------------
    fake_group(256)
    mesh = make_production_mesh()
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    print(f"[mesh] (b) card memory outside the allocator: "
          f"{(total - free - torch.cuda.memory_reserved()) / 1e9:.3f} GB on {card}")
    for arch in MESH_RANK0:
        shape_name = "prefill_32k"
        dry = mesh_dry[("16x16", arch, shape_name)]
        if dry["status"] != "ok":
            fail(f"meshed dry run of {arch} x {shape_name}: {dry.get('error')}")
        if not dry["fits_hbm"]:
            print(f"[mesh] (b) {arch}: the meshed dry run's prefill_32k rank peak "
                  f"{dry['peak_memory_gb']:.2f} GiB does not fit {total / 1e9:.1f} GB; "
                  "decode_32k instead")
            shape_name = "decode_32k"
            dry = mesh_dry[("16x16", arch, shape_name)]
            if dry["status"] != "ok":
                fail(f"meshed dry run of {arch} x {shape_name}: {dry.get('error')}")
        cfg, shape = get_arch(arch), INPUT_SHAPES[shape_name]
        model = build_model(cfg, shape_name, device="cuda")
        model.set_mesh_context(mesh, batch_axes(mesh, shape.global_batch))
        shapes = param_shapes(model)
        params = local_param_tree(cfg, mesh, shapes, param_spec_tree(cfg, shapes, mesh),
                                  device=dev)
        inputs = meshed_inputs(model, shape, mesh, dev)
        spans = []
        with torch.no_grad():
            for _ in range(2):  # a warm-up, then the timed step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(inputs) == 1:
                    model.forward(params, inputs[0])
                else:
                    model.decode_step(params, *inputs)
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t0)
        live = (params, inputs)
        torch.cuda.synchronize()
        held = held_tensors(live)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = launch_counts()
        counter = run_meshed_step(model, params, inputs)
        torch.cuda.synchronize()
        after = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        now = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        workspaces = now - torch.cuda.memory_allocated()
        st = counter.stats
        launches = {k: after[k] - before[k] for k in KERNEL_NAMES if after[k] != before[k]}
        label = f"{arch} x {shape_name} at 16x16 rank 0"
        if dry["flops_per_device"] != st.flops:
            fail(f"{label}: the meshed dry run's FLOPs {dry['flops_per_device']} != the card "
                 f"step's {st.flops}")
        if (not dry["kernel_launches"] == dict(st.launches) == launches
                or shape.kind == "prefill" and not launches):
            fail(f"{label}: kernel launches, dry run {dry['kernel_launches']}, op counter "
                 f"{dict(st.launches)}, launch_counts {launches}")
        if dry["collective_counts"] != dict(st.collectives):
            fail(f"{label}: collectives, dry run {dry['collective_counts']}, card step "
                 f"{dict(st.collectives)}")
        if dry["start_memory_bytes"] != st.start_bytes:
            fail(f"{label}: live tensors at the start, dry run {dry['start_memory_bytes']} B, "
                 f"card {st.start_bytes} B")
        if dry["bytes_per_device"] != st.bytes:
            fail(f"{label}: bytes, dry run {dry['bytes_per_device']}, card step {st.bytes}")
        other = base - st.start_bytes
        held_b = sum(n for n, _ in held.values())
        predicted = dry["peak_memory_bytes"] + other
        gap = (peak - predicted) / peak
        if not abs(gap) <= PEAK_TOL:
            fail(f"{label}: predicted peak {predicted / 1e9:.3f} GB (the dry run's "
                 f"{dry['peak_memory_bytes'] / 1e9:.3f} GB and {other / 1e9:.3f} GB held beside), "
                 f"measured {peak / 1e9:.3f} GB: {100 * gap:.2f}% apart")
        step_s = spans[-1]
        bound = max(dry["compute_s"], dry["memory_s"])
        counted = max(st.flops / PEAK_FLOPS, st.bytes / HBM_BW)
        print(f"[mesh] (b) {label} ({shape.global_batch} x {shape.seq_len} global, batch axes "
              f"{dry['batch_axes']}, {cfg.n_layers} layers): FLOPs {st.flops:.6e} (dry run = "
              f"card), launches {json.dumps(launches)} (dry run = op counter = launch_counts), "
              f"collectives {json.dumps(dict(st.collectives))} (= dry run) with "
              f"{json.dumps({k: int(v) for k, v in st.collective_bytes.items()})} B; peak: dry "
              f"run {dry['peak_memory_bytes']} B + {other} B held beside ({held_b} B of tensors "
              f"Python holds, {workspaces} B of cuBLAS workspaces) = {predicted / 1e9:.3f} GB, "
              f"measured {peak / 1e9:.3f} GB ({100 * gap:+.3f}%, tol {100 * PEAK_TOL:.0f}%); "
              f"step {1e3 * step_s:.1f} ms (warm-up {1e3 * spans[0]:.1f} ms, no data moved "
              f"between ranks); compute {1e3 * dry['compute_s']:.3f} ms, memory "
              f"{1e3 * dry['memory_s']:.3f} ms, collective {1e3 * dry['collective_s']:.3f} ms "
              f"({dry['bottleneck']}); the card's own bound {1e3 * bound:.3f} ms, share "
              f"{100 * bound / step_s:.2f}% (from the counted step's bytes: "
              f"{1e3 * counted:.3f} ms, {100 * counted / step_s:.2f}%); bytes {st.bytes:.6e} (= dry "
              f"run), the most by "
              f"{json.dumps({k: f'{v:.3e}' for k, v in st.bytes_by_op.most_common(6)})} (dry "
              f"run {json.dumps({k: f'{v:.3e}' for k, v in dry['top_bytes'].items()})}) on {smi}")
        model.set_mesh_context(None)
        del params, inputs, counter, model, live
        torch.cuda.empty_cache()

    # -- (d) rank 0 of 16x16 train_4k: the meshed trainer on real tensors ----------------
    for arch, mode, codec in MESH_TRAIN:
        label = f"{arch} x train_4k at 16x16 rank 0 ({mode}, {codec})"
        dry = mesh_dry[train_dry[arch]]
        if dry["status"] != "ok":
            fail(f"meshed dry run of {label}: {dry.get('error')}\n{dry.get('traceback')}")
        if not dry["fits_hbm"]:
            fail(f"{label}: the meshed dry run's rank peak, {dry['peak_memory_bytes'] / 1e9:.2f} "
                 f"GB, does not fit {total / 1e9:.1f} GB")
        cfg = get_arch(arch).replace(n_layers=dry["n_layers"])
        base = INPUT_SHAPES["train_4k"]
        shape = InputShape(base.name, base.seq_len, MESH_TRAIN_BATCH, base.kind)
        model = build_model(cfg, "train_4k", device="cuda")
        shapes = param_shapes(model)
        trainer = MeshDFLTrainer(model, mesh, DFLConfig(gossip_mode=mode, codec=codec))
        batch = Batch(**_inputs(cfg, shape, dev))
        state = meshed_train_state(trainer, local_param_tree(
            cfg, mesh, shapes, param_spec_tree(cfg, shapes, mesh), device=dev))
        spans, metrics = [], []
        fill = fake_group_fill()
        with fill:
            for _ in range(2):  # a warm-up, then the timed step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t0)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        live = (state, batch)
        torch.cuda.synchronize()
        held = held_tensors(live)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = launch_counts()
        del live
        with fill:
            counter, gossip, m = meshed_train_step(trainer, state, batch)
        del state
        torch.cuda.synchronize()
        after = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        now = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        workspaces = now - torch.cuda.memory_allocated()
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        st = counter.stats
        launches = {k: after[k] - before[k] for k in KERNEL_NAMES if after[k] != before[k]}
        if not all(math.isfinite(x) for pair in metrics for x in pair):
            fail(f"{label}: loss / grad norm not finite: {metrics}")
        if dry["flops_per_device"] != st.flops:
            fail(f"{label}: the meshed dry run's FLOPs {dry['flops_per_device']} != the card "
                 f"step's {st.flops}")
        if not dry["kernel_launches"] == dict(st.launches) == launches:
            fail(f"{label}: kernel launches, dry run {dry['kernel_launches']}, op counter "
                 f"{dict(st.launches)}, launch_counts {launches}")
        if (dry["collective_counts"] != dict(st.collectives)
                or dry["collective_bytes_by_kind"] != dict(st.collective_bytes)):
            fail(f"{label}: collectives, dry run {dry['collective_counts']} "
                 f"{dry['collective_bytes_by_kind']}, card step {dict(st.collectives)} "
                 f"{dict(st.collective_bytes)}")
        p2p = st.collective_bytes.get(P2P_KIND, 0.0)
        if p2p != gossip["rank_p2p_bytes"] or not p2p:
            fail(f"{label}: point-to-point bytes {p2p} != the rank's share "
                 f"{gossip['rank_p2p_bytes']}")
        if dry["bytes_per_device"] != st.bytes:
            fail(f"{label}: bytes, dry run {dry['bytes_per_device']}, card step {st.bytes}")
        if dry["start_memory_bytes"] != st.start_bytes:
            fail(f"{label}: live tensors at the start, dry run {dry['start_memory_bytes']} B, "
                 f"card {st.start_bytes} B")
        other = base - st.start_bytes
        held_b = sum(n for n, _ in held.values())
        predicted = dry["peak_memory_bytes"] + other
        gap = (peak - predicted) / peak
        if not abs(gap) <= PEAK_TOL:
            fail(f"{label}: predicted peak {predicted / 1e9:.3f} GB (the dry run's "
                 f"{dry['peak_memory_bytes'] / 1e9:.3f} GB and {other / 1e9:.3f} GB held beside), "
                 f"measured {peak / 1e9:.3f} GB: {100 * gap:.2f}% apart")
        step_s = spans[-1]
        bound = max(dry["compute_s"], dry["memory_s"])
        if not st.collectives.get("reduce-scatter"):
            fail(f"{label}: no reduce-scatter in the step (the sequence split, ROADMAP P10)")
        print(f"[mesh] (d) {label}: the step's collectives by kind: " + ", ".join(
            f"{k} {st.collectives[k]} ({int(st.collective_bytes[k])} B)"
            for k in sorted(st.collectives)))
        print(f"[mesh] (d) {label}, {cfg.n_layers} layers, {shape.global_batch} x "
              f"{shape.seq_len} global ({gossip['n_nodes']} nodes): loss / grad norm "
              f"{json.dumps(metrics)} (warm-up, timed, counted); FLOPs {st.flops:.6e}, bytes "
              f"{st.bytes:.6e} (= dry run), launches {json.dumps(launches)} (dry run = op counter "
              f"= launch_counts), collectives {json.dumps(dict(st.collectives))} with "
              f"{json.dumps({k: int(v) for k, v in st.collective_bytes.items()})} B (= dry run; "
              f"the gossip's {P2P_KIND} = the rank's share {int(gossip['rank_p2p_bytes'])} B); "
              f"peak: dry run "
              f"{dry['peak_memory_bytes']} B + {other} B held beside ({held_b} B of tensors "
              f"Python holds, {workspaces} B of cuBLAS workspaces) = {predicted / 1e9:.3f} GB, "
              f"measured {peak / 1e9:.3f} GB ({100 * gap:+.3f}%, tol {100 * PEAK_TOL:.0f}%); "
              f"step {1e3 * step_s:.1f} ms (warm-up {1e3 * spans[0]:.1f} ms, no data moved "
              f"between ranks); compute {1e3 * dry['compute_s']:.3f} ms, memory "
              f"{1e3 * dry['memory_s']:.3f} ms, collective {1e3 * dry['collective_s']:.3f} ms "
              f"({dry['bottleneck']}); the card's own bound {1e3 * bound:.3f} ms, share "
              f"{100 * bound / step_s:.2f}% on {smi}")
        del trainer, model, counter, batch
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    counts = launch_counts()
    print(f"[mesh] launches on phase 8's path: {json.dumps(counts)}")
    for kernel in KERNEL_NAMES:
        if not counts[kernel]:
            fail(f"{kernel}: never launched on phase 8's path")

    # -- (c) the meshed --all table ------------------------------------------------------
    train_archs = [a for a, _, _ in MESH_TRAIN]
    for m in MESH_LAYOUTS:
        fits = []
        for arch in list_archs():
            for shape_name in INPUT_SHAPES:
                if (m, arch, shape_name) not in mesh_dry:
                    print(f"[mesh --all] {m} {arch} x {shape_name}: not traced here (training is "
                          f"traced for {', '.join(train_archs)} only; see PERF.md)")
                    continue
                dry = mesh_dry[(m, arch, shape_name)]
                if dry["status"] == "error":
                    fail(f"meshed dry run of {arch} x {shape_name} x {m}: {dry.get('error')}\n"
                         f"{dry.get('traceback')}")
                if dry["status"] != "ok":
                    print(f"[mesh --all] {m} {arch} x {shape_name}: {dry['status']} "
                          f"({dry['reason']})")
                    continue
                fits.append(f"{arch}/{shape_name}={dry['fits_hbm']}")
                if "gossip" in dry:
                    print(f"[mesh --all] {m} {arch} x {shape_name} gossip: "
                          f"{json.dumps(dry['gossip'])}")
                print(f"[mesh --all] {m} {arch} x {shape_name} ({dry['traced_on']}, "
                      f"{dry['global_batch']} x {dry['seq_len']}, {dry['n_layers']} layers, batch "
                      f"axes {dry['batch_axes']}): rank peak {dry['peak_memory_bytes'] / 1e9:.2f} "
                      f"GB, fits_hbm {dry['fits_hbm']} ({total / 1e9:.1f} GB); FLOPs "
                      f"{dry['flops_per_device']:.4e}, bytes {dry['bytes_per_device']:.4e}, "
                      f"collective bytes {dry['collective_bytes_per_device']:.4e} "
                      f"{json.dumps(dry['collective_counts'])}; compute "
                      f"{1e3 * dry['compute_s']:.2f} ms, memory {1e3 * dry['memory_s']:.2f} ms, "
                      f"collective {1e3 * dry['collective_s']:.2f} ms ({dry['bottleneck']}); "
                      f"launches {json.dumps(dry['kernel_launches'])}; traced in "
                      f"{dry['trace_s']} s")
        print(f"[mesh --all] {m} fits_hbm: {', '.join(fits)}")
    p8 = mesh_dry[P8_PAIR]
    if p8["status"] != "ok":
        fail(f"meshed dry run of {P8_PAIR}: {p8.get('error')}")
    print(f"[mesh] P8: {P8_PAIR[1]} x {P8_PAIR[2]} at {P8_PAIR[0]}, {P8_PAIR[3]} layers, traced "
          f"on the card ({p8['traced_on']}): rank peak {int(p8['peak_memory_bytes'])} B, "
          f"collectives {json.dumps(p8['collective_counts'])} "
          f"{json.dumps({k: int(v) for k, v in p8['collective_bytes_by_kind'].items()})} B")
    print(f"[mesh] phase 8 (a), (b) and (d): {time.perf_counter() - t8:.1f} s on {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from repro_torch.compress import make_codec, per_send_wire_mb
    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.kernels import (KERNEL_NAMES, _build, launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.kernels.attention.flash import (flash_attention, flash_attention_bwd,
                                                     flash_bwd_cost, flash_cost)
    from repro_torch.kernels.attention.ops import flash_attention_op
    from repro_torch.kernels.attention.ref import (BF16_UNITS_TOL, BWD_BF16_TOL, BWD_F32_TOL,
                                                   attention_bwd_ref, attention_lse_ref,
                                                   attention_ref, rounding_units)
    from repro_torch.kernels.codec import ref as codec_ref
    from repro_torch.kernels.codec.group import group_layout
    from repro_torch.kernels.codec.quant_pack import dequantize_cost, quantize_cost
    from repro_torch.kernels.codec.topk_pack import topk_cost
    from repro_torch.kernels.codec.ops import (dequantize_group_op, dequantize_op, quantize_op,
                                               topk_select_op)
    from repro_torch.kernels.mixing.gossip_mix import mix_cost
    from repro_torch.kernels.mixing.ops import gossip_mix_op
    from repro_torch.kernels.mixing.ref import gossip_mix_ref
    from repro_torch.kernels.scan.mamba_scan import (mamba_selective_scan, scan_bwd_cost,
                                                     scan_cost, selective_scan_bwd)
    from repro_torch.kernels.scan.ops import selective_scan_op
    from repro_torch.kernels.scan.ref import (SCAN_BWD_BF16_TOL, SCAN_BWD_TOL,
                                              selective_scan_bwd_ref, selective_scan_ref)
    from repro_torch.data import DataConfig, FederatedData
    from repro_torch.dfl.collectives import (GossipPlan, gossip_exchange, hop_groups,
                                             tree_flatten, tree_map)
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer
    from repro_torch.launch import train as launcher
    from repro_torch.launch.op_analysis import OpCounter, tensors as op_tensors
    from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS
    from repro_torch.launch.serve import serve
    from repro_torch.models import Batch, build_model
    from repro_torch.models import attention as attn_model
    from repro_torch.models import mamba as mamba_model
    from repro_torch.models.layers import padded_vocab, rms_norm
    from repro_torch.models.mamba import mamba2_forward
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.scenario import (SCENARIOS, DeviceExecutor, run_scenario, run_sweep,
                                      scenarios)
    from repro_torch.scenario.cache import PlanCache
    from repro_torch.scenario.runner import fedavg_check
    from repro_torch.verify import VerificationError, verify_result

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

    def infer(fn, *args):
        with torch.inference_mode():
            fn(*args)

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

    def record(name, route_src, replaces, err, tol, ms, plain_ms, cost,
               library_ms=None, shape="", ops_per_s=F32_FLOPS, key=None, clean_ms=None):
        """One timed case of a kernel; ``cost`` is its cost function's (the
        bound's bytes and operations)."""
        b_ms, b_by = bound_ms(cost, ops_per_s)
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
            base["mesh_smoke"].replace(name="mesh_smoke_int8", codec="int8"),
            base["paper_flooding_baseline"]]
    path_shapes = {name: Counter() for name in CODEC_KERNELS}
    for spec in runs:
        reset_launches()
        run_scenario(spec, executor=DeviceExecutor(seed=1, proxy_elems=4))
        elems = int(round(spec.payload_mb() * 1e6 / 4))
        for name in CODEC_KERNELS:
            for key, n in launch_shapes()[name].items():
                # a round's one leaf: dequantize's key holds the group's sizes
                size = (elems,) if name == "dequantize" else elems
                path_shapes[name][(key[0], size, *key[2:])] += n
    for name in CODEC_KERNELS:
        print(f"[kernel] {name}: the main path's launch shapes "
              f"{sorted(path_shapes[name].items())} (dry run at the proxy size)")
    # the sweeps part's shapes: a dry run of its sweeps at full width on the
    # card (a segmented cell's codec kernels run on its segments, which a
    # proxy-size run does not show)
    reset_launches()
    for name in CARD_SWEEPS:
        run_sweep(scenarios.get_sweep(name), executor=DeviceExecutor(seed=1))
    card_sweep_shapes = {name: Counter(launch_shapes()[name]) for name in GOSSIP_KERNELS}
    torch.cuda.empty_cache()
    sweeps_later = {k for name in CODEC_KERNELS for k in card_sweep_shapes[name]
                    if k not in path_shapes[name]}
    for name in CODEC_KERNELS:
        path_shapes[name].update(card_sweep_shapes[name])
    for name in GOSSIP_KERNELS:
        print(f"[kernel] {name}: the sweeps part's launch shapes "
              f"{sorted(card_sweep_shapes[name].items())} (dry run at full width)")
    # phase 5's int8 dissemination runs at their own widths (whisper-tiny
    # at full depth, granite-3-2b at 4 layers): one payload a leaf of the 4
    # nodes' f32 masters, the leaves hopped in groups (one dequantize a group
    # a hop); a round at the real leaf sizes, on seeded masters, must equal
    # the same round leaf by leaf (the per-leaf hop), bit for bit
    diss_plan, int8 = GossipPlan.build(4), make_codec("int8")
    train_shapes = {}  # arch -> kernel -> the launch shapes of its round
    for arch, layers in PHASE5_INT8:
        cfg = get_arch(arch)
        masters = tree_map(
            lambda t: t.float().expand(4, *t.shape) + 0.01 * torch.randn(
                (4, *t.shape), generator=gen, device=dev),
            build_model(cfg.replace(n_layers=layers or cfg.n_layers), device="cuda").init(
                torch.Generator(device=dev).manual_seed(0)))
        reset_launches()
        grouped = gossip_exchange("dissemination", diss_plan, masters, codec=int8)
        shapes = train_shapes[arch] = launch_shapes()
        leaves = tree_flatten(masters)[0]
        groups = hop_groups("dissemination", diss_plan, leaves, int8)
        if sum(shapes["dequantize"].values()) != len(groups) * len(diss_plan.diss_steps):
            fail(f"{arch} int8 round: {shapes['dequantize']} dequantize launches, expected "
                 f"{len(groups)} groups x {len(diss_plan.diss_steps)} steps")
        for got, leaf in zip(tree_flatten(grouped)[0], leaves):
            alone = gossip_exchange("dissemination", diss_plan, {"x": leaf}, codec=int8)["x"]
            if not torch.equal(got, alone):
                fail(f"{arch} int8 round: the grouped hop differs from the leaf-by-leaf hop")
            del alone
        print(f"[kernel] {arch} int8 dissemination round (4 nodes' f32 masters, {len(leaves)} "
              f"leaves in {len(groups)} groups {[len(g) for g in groups]}, "
              f"{len(diss_plan.diss_steps)} steps): equal to the leaf-by-leaf round bit for "
              f"bit; {sum(shapes['dequantize'].values())} dequantize launches (a launch a leaf "
              f"a hop: {len(leaves) * len(diss_plan.diss_steps)}); quantize "
              f"{sorted(shapes['quantize'].items())}, gossip_mix "
              f"{sorted(shapes['gossip_mix'].items())}")
        del masters, grouped, leaves, got, leaf
        for name in ("quantize", "dequantize"):
            path_shapes[name].update(shapes[name])
        torch.cuda.empty_cache()
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
    later = {k for shapes in train_shapes.values() for name in ("quantize", "dequantize")
             for k in shapes[name]}
    later |= {k for name in CODEC_KERNELS for k in sweep_shapes[name]} | sweeps_later
    # the engine phase's shapes: one payload part a row (v3s's whole payload,
    # B0's segments) and the FedAvg of the n nodes' parts
    engine_shapes = engine_launch_shapes()
    for name in CODEC_KERNELS:
        for key in engine_shapes[name]:
            path_shapes[name][key] += 0
            later.add(key)
    print(f"[kernel] the engine phase's launch shapes: "
          f"{ {k: sorted(v) for k, v in engine_shapes.items()} }")

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
        shape = f" int{bits} ({rows}, {c}x1024)"
        record("quantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:19", 0.0, 0.0,
               median_ms(lambda: quantize_op(x, bits=bits), iters),
               median_ms(lambda: codec_ref.quantize_rows(x, bits, 1024), iters // 5),
               quantize_cost(rows, size, bits, 1024), shape=shape, key=(rows, size, bits),
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
        cost = dequantize_cost(layout)
        group_ms = median_ms(lambda: dequantize_group_op(codes, scales, layout), iters)
        record("dequantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:28", 0.0, 0.0, group_ms,
               median_ms(lambda: codec_ref.dequantize_group(codes, scales, layout),
                         max(iters // 5, 2)),
               cost, library_ms=lib_ms, shape=shape, key=(rows, sizes, bits),
               clean_ms=median_ms(lambda: dequantize_group_op(codes, scales, layout), iters,
                                  clean=True))
        if singles and len(sizes) > 1:
            def one_a_leaf():
                for l, size in enumerate(sizes):
                    dequantize_op(layout.codes(codes, l), layout.scales(scales, l), size=size,
                                  bits=bits)

            print(f"[kernel] dequantize{shape}: one launch {group_ms:.4f} ms; the same leaves "
                  f"in {len(sizes)} single launches {median_ms(one_a_leaf, iters):.4f} ms "
                  f"(bound of the group's bytes {1e3 * cost.bytes / HBM_BW:.4f} ms), "
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
               topk_cost(rows, size, block, k), shape=shape, key=(rows, size, block, k),
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
           mix_cost(buf), library_ms=median_ms(lambda: torch.mean(buf, dim=1), 10, cold=False),
           shape=" (10, 10, 5.3 M)")
    del buf, mixed, plain
    # the mix at the leaf shapes of phase 5's int8 runs (the FedAvg of their
    # dissemination on 4 nodes) and of phase 6's protocols on 10, at the
    # engine phase's FedAvg of 10 payload parts and at the sweeps part's: from
    # a cold L2, as one leaf's mix follows the others' rounds
    mix_where = {key: arch for arch, shapes in train_shapes.items()
                 for key in shapes["gossip_mix"]}
    mix_where.update({key: "whisper-tiny" for key in sweep_shapes["gossip_mix"]})
    mix_where.update({key: "engine" for key in engine_shapes["gossip_mix"]})
    for batch, n, p in sorted(set(mix_where) | set(card_sweep_shapes["gossip_mix"])):
        buf = torch.randn((batch, n, p), generator=gen, device=dev)
        w = torch.full((n,), 1.0 / n, device=dev)
        mixed, plain = gossip_mix_op(buf, w), gossip_mix_ref(buf, w)
        iters = 50 if buf.numel() < 5e7 else 10
        record("gossip_mix", "src/repro_torch/csrc/gossip_mix.cu",
               "src/repro/kernels/mixing/gossip_mix.py:22", float((mixed - plain).abs().max()),
               1e-6 * float(buf.abs().max()), median_ms(lambda: gossip_mix_op(buf, w), iters),
               median_ms(lambda: gossip_mix_ref(buf, w), iters // 5),
               mix_cost(buf), library_ms=median_ms(lambda: torch.mean(buf, dim=1), iters),
               shape=f" ({batch}, {n}, {p}) {mix_where.get((batch, n, p), 'sweeps')}",
               key=(batch, n, p))
        del buf, mixed, plain

    # flash attention: smollm-360m's causal prefill, gemma2-2b's local layer,
    # the other configs' prefill and training shapes, and f32 cases
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
        # granite-3-2b's prefill and training (GQA 4:1 at hd 64), gemma2-2b's
        # global layer at its prefill (softcap, no window) and its training
        # shape (s under the window: every layer computes alike)
        (4, 2048, 2048, 32, 8, 64, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (2, 2048, 2048, 32, 8, 64, True, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (1, 8192, 8192, 8, 4, 256, True, 0, 50.0, torch.bfloat16, 2e-2, "timed"),
        (1, 2048, 2048, 8, 4, 256, True, 0, 50.0, torch.bfloat16, 2e-2, "timed"),
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
        record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/attention/flash.py:25", err, tol,
               median_ms(lambda: flash_attention_op(q, k, v, **kw), 5),
               median_ms(lambda: attention_ref(q, k, v, **kw), 3),
               flash_cost(q, k, causal, window, False), library_ms=lib_ms,
               shape=shape + units, ops_per_s=PEAK_FLOPS,
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
        b_ms, _ = bound_ms(flash_cost(q, k, True, 0, True), PEAK_FLOPS)
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
        (2, 2048, 2048, 32, 8, 64, True, 0, 0.0, torch.bfloat16),  # granite-3-2b's training
        (1, 2048, 2048, 8, 4, 256, True, 0, 50.0, torch.bfloat16),  # gemma2-2b's training
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
        record("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
               # no TPU kernel: XLA differentiates the JAX package's einsum attention
               "src/repro/models/attention.py:48",
               max(float((g1.float() - w.float()).abs().max()) for g1, w in zip(got, want)),
               None,
               median_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw), 5),
               median_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do, **kw), 3),
               flash_bwd_cost(q, k, causal, window), library_ms=lib_ms,
               shape=shape, ops_per_s=PEAK_FLOPS if dtype == torch.bfloat16 else F32_FLOPS,
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
        record("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/scan/mamba_scan.py:24", err,
               1e-4 * max(1.0, float(py.abs().max())),
               median_ms(lambda: selective_scan_op(*scan_args, out_dtype=torch.float32), 10),
               median_ms(lambda: selective_scan_ref(*scan_args, out_dtype=torch.float32), 2),
               scan_cost(dt, Bm, xs, torch.float32, False),
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
            record("selective_scan_bwd", "src/repro_torch/csrc/selective_scan_bwd.cu",
                   # no TPU kernel: XLA differentiates the JAX package's jnp scan
                   "src/repro/models/mamba.py:42", worst, None,
                   median_ms(lambda: selective_scan_bwd(*scan_args, hc, dy, dh), 10),
                   median_ms(lambda: selective_scan_bwd_ref(*scan_args, dy, dh), 2),
                   scan_bwd_cost(dt, Bm, xs, dy, dh), shape=shape,
                   # falcon-mamba's training step launches it at b = 1 (phase 5)
                   key=(b, s, di, n) if b == 1 else None)
            results["selective_scan_bwd"].setdefault("autograd_plain_ms", []).append(
                dict(shape=[b, s, di, n], ms=auto_ms))
        del dt, Bm, Cm, xs, A_log, Dp, dy, dh, y, y_plain, hc, got, again, want, scan_args
    torch.cuda.empty_cache()
    flush.clear()

    # -- 3. the main path: scenario rounds at full width ------------------------
    reset_launches()
    path_ms = {}  # each scenario's first round on the card, for the tables phase
    verify_s = 0.0  # host seconds of static verification and of the rechecks
    for spec in runs:
        torch.cuda.reset_peak_memory_stats()
        cache = PlanCache()
        run, wall, spent = strict_run(spec, cache, "")
        verify_s += spent
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
        path_ms[spec.name] = run.rounds[0].device_ms
        if spec.name == "quantized_table3" and run.rounds[0].bytes_on_wire_mb != 478.86336:
            fail("quantized_table3 bytes_on_wire_mb != 478.86336")
        if spec.name == "quantized_table3":  # a planted fault on the card's own report
            first = run.rounds[0]
            bad = dataclasses.replace(run, rounds=[dataclasses.replace(
                first, bytes_on_wire_mb=first.bytes_on_wire_mb + 1.0)])
            try:
                verify_result(spec, bad, plan_cache=cache)
            except VerificationError as exc:
                if exc.invariant != "conservation/bytes-on-wire":
                    fail(f"the planted byte fault raised {exc.invariant}")
                print(f"[verify] planted fault (quantized_table3 round 0, bytes_on_wire_mb "
                      f"{first.bytes_on_wire_mb} + 1 MB) rejected: {exc}")
            else:
                fail("verify_result accepted a round with 1 MB more on the wire")
    counts, shapes = launch_counts(), launch_shapes()
    print(f"[verify] phase 3: {verify_s:.4f} s of host time verifying {len(runs)} scenarios "
          f"(strict, before each run's first round) and rechecking their rounds, on {smi}")
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
            if shapes_run.get(key, 0) > 0:  # the shapes this run launched
                print(f"[{where}] {name} {key}: {row['launches']} launches x ({row['ms']:.4f} - "
                      f"{row['bound_ms']:.4f} ms) = {row['loss_ms']:.4f} ms")
        loss = sum(r["loss_ms"] for r in timed.values())
        results[name]["loss_ms"] = loss
        print(f"[{where}] {name}: loss sum over shapes of launches x (ms - bound_ms) = "
              f"{loss:.4f} ms on {card}")

    for name in CODEC_KERNELS:
        add_shape_launches(name, shapes[name], "path")
    torch.cuda.empty_cache()

    # -- the sweeps: the reference's sweeps through the card executor ------------------
    phase_sweeps(card, add_shape_launches, results)
    # -- the queue engine: lossy links and segmented gossip at full width -----------
    phase_engine(card, add_shape_launches, results)
    phase_tables(path_ms, card)
    phase_plans(card, results, path_ms)

    # phase 7's real side: one call of a phase-4 or phase-5 run counted on the
    # card, held in phase 7 against the dry run of the same config
    counted_runs = []

    def held_tensors(live):
        """The card's storages that Python holds outside ``live``, as
        {address: (bytes, shape and dtype of a tensor on it)}; a DTensor
        by its local tensor."""
        from torch.distributed.tensor import DTensor

        mine = {t.untyped_storage().data_ptr() for t in op_tensors(live)}
        held = {}
        for obj in gc.get_objects():
            if (isinstance(obj, torch.Tensor) and not isinstance(obj, DTensor) and obj.is_cuda
                    and obj.layout == torch.strided):
                st = obj.untyped_storage()
                if st.data_ptr() not in mine:
                    held.setdefault(st.data_ptr(),
                                    (st.nbytes(), f"{tuple(obj.shape)} {str(obj.dtype)[6:]}"))
        return held

    def count_call(label, fn, live, step_ms, cfg, **dry):
        """``fn()`` once under the op counter; the peak from just before it
        (``reset_peak_memory_stats``) and the launches and launch shapes
        read around it. ``dry``: the dry run's arguments beside the config's
        (its fields that differ from the registry's pass as overrides).
        What the process holds beside the step's live tensors at its start
        is split into the tensors Python holds, cuBLAS's workspaces (freed
        after the step and measured by the drop; the next matmul makes them
        again) and the allocator's rounding at the start; the peak into the
        bytes requested and the allocator's rounding. Returns fn's result,
        the launches and the shapes it launched at."""
        full = get_arch(cfg.name)
        overrides = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                     if getattr(cfg, f.name) != getattr(full, f.name)}
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        held = held_tensors(live)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before, shapes_before = launch_counts(), launch_shapes()
        # qwen3-moe's int8 round asks for one 18.55 GiB buffer, which 36–39 GiB
        # of free blocks split among segments still in use has refused: the
        # counted step maps its new segments expandably (allocations, and so
        # the peak, are the same)
        torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
        try:
            with OpCounter(live=live, device="cuda") as counter:
                out = fn()
        finally:
            torch._C._accelerator_setAllocatorSettings("expandable_segments:False")
        torch.cuda.synchronize()
        after, shapes_after = launch_counts(), launch_shapes()
        peak, stats = torch.cuda.max_memory_allocated(), torch.cuda.memory_stats()
        now = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        launches = {k: after[k] - before[k] for k in KERNEL_NAMES if after[k] != before[k]}
        shapes = {k: dict(Counter(shapes_after[k]) - Counter(shapes_before[k]))
                  for k in KERNEL_NAMES}
        counted_runs.append(dict(
            label=label, stats=counter.stats, peak=peak,
            requested_peak=stats["requested_bytes.all.peak"], base=base,
            workspaces=now - torch.cuda.memory_allocated(),
            held=sum(n for n, _ in held.values()),
            largest_held=sorted(held.values(), reverse=True)[:3], launches=launches,
            step_ms=step_ms, dry=dict(arch=cfg.name, arch_overrides=overrides, **dry)))
        return out, launches, shapes

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
                  ("paligemma-3b", 0, 2, "flash_attention", "cli"),
                  ("gemma2-2b", 0, 1, "flash_attention", "cli"),
                  ("granite-3-2b", 0, 4, "flash_attention", "cli")]
    n_prefill = 3
    reset_launches()
    serve_launches = Counter()
    phase4 = {}  # phase 8's references: the MESH_SERVE archs' logits and inputs
    for arch, layers, batch, kernel, decode in serve_runs:
        seq = SERVE_SEQ.get(arch, 2048)
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
                check_logits(arch, cfg, logits)
                if arch in MESH_SERVE and arch not in phase4:
                    phase4[arch] = dict(logits=logits.cpu(), tokens=tokens.cpu(), batch=batch,
                                        seq=seq, kernel=kernel)
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
        logit_note = (f", every |logit| <= {cfg.final_logit_softcap} + 1e-3 (the final softcap)"
                      if cfg.final_logit_softcap else "")
        if cfg.vocab != padded_vocab(cfg.vocab):
            logit_note += (f", the {padded_vocab(cfg.vocab) - cfg.vocab} padded vocab columns "
                           "-1e9 and no row's argmax among them")
        print(f"[serve] {arch}: {depth}, d {cfg.d_model}, {n_params / 1e9:.3f} B params bf16 "
              f"(init {init_s:.1f} s, peak {init_peak:.2f} GB); prefill ({batch}, {seq}){inputs}: "
              f"{prefill_ms:.3f} ms median of {n_prefill - 1} after a warm-up "
              f"[{', '.join(f'{1e3 * t:.3f}' for t in spans)}], "
              f"{batch * seq / prefill_ms * 1e3:.0f} tok/s, {per_fwd} {kernel} launches a "
              f"forward, no {other}{logit_note}, peak {prefill_peak:.2f} GB on {card}")
        if cfg.alt_local_global:  # the local layers' flash against the global layers'
            by_window = flash_ms_by_window(model, params, Batch(tokens=tokens, **frontend))
            serve_launches[kernel] += sum(len(v) for v in by_window.values())
            local, glob = by_window[cfg.sliding_window], by_window[0]
            w = cfg.sliding_window
            pairs_local = w * (w + 1) // 2 + (seq - w) * w if seq > w else seq * (seq + 1) // 2
            pairs_global = seq * (seq + 1) // 2
            print(f"[serve] {arch}: flash device time over the prefill, {len(local)} local "
                  f"layers (window {w}) {sum(local):.3f} ms (median "
                  f"{statistics.median(local):.4f} ms a layer), {len(glob)} global layers "
                  f"{sum(glob):.3f} ms (median {statistics.median(glob):.4f} ms a layer): local / "
                  f"global {sum(local) / sum(glob):.3f} against {pairs_local / pairs_global:.3f} "
                  f"of the (q, k) pairs ({pairs_local / 1e6:.1f} M / {pairs_global / 1e6:.1f} M) "
                  f"on {card}")
        # one more prefill counted for phase 7 (FLOPs, launches, peak)
        _, counted, _ = count_call(
            f"prefill {arch} ({batch}, {seq})",
            lambda: infer(model.forward, params, Batch(tokens=tokens, **frontend)),
            (params, tokens, frontend), prefill_ms, cfg, shape_name="prefill_32k",
            layers=cfg.n_layers, batch=batch, seq=seq)
        serve_launches[kernel] += counted.get(kernel, 0)
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
        if arch in MESH_SERVE:
            phase4[arch].update(prompts=prompts.cpu(), gen=gen, serve_tokens=res.tokens.cpu(),
                                serve_logits=res.logits.cpu(), prefill_ms=prefill_ms,
                                step_ms=step_ms, per_fwd=per_fwd, per_step=per_step)
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
        if arch in LONG_DECODE:
            # one long_500k decode step at full depth, built as the dry run
            # traces it: init_cache(1, 524288), the token at its last position
            long_model = build_model(cfg, "long_500k", device="cuda")
            n_ctx = INPUT_SHAPES["long_500k"].seq_len
            torch.cuda.empty_cache()
            cache = long_model.init_cache(1, n_ctx)
            cache_gb = sum(t.numel() * t.element_size() for t in tree_flatten(cache)[0]) / 1e9
            rings = ", ".join(f"{name} {tuple(c['k'].shape)}" for name, c in cache.items())
            tok = torch.randint(0, cfg.vocab, (1, 1), generator=g, device=dev)
            pos = torch.full((1,), n_ctx - 1, dtype=torch.long, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.inference_mode():
                start.record()
                out, new = long_model.decode_step(params, tok, pos, cache)
                end.record()
            torch.cuda.synchronize()
            long_ms, long_peak = start.elapsed_time(end), torch.cuda.max_memory_allocated() / 1e9
            if not bool(torch.isfinite(out[..., :cfg.vocab]).all()):
                fail(f"{arch}: non-finite long_500k decode logits")
            del out, new
            print(f"[serve] {arch} long_500k: one decode step at position {n_ctx - 1}, batch 1, "
                  f"{cfg.n_layers} layers, cache {cache_gb:.2f} GB ({rings}): {long_ms:.3f} ms "
                  f"on the device (CUDA events), logits finite, peak {long_peak:.2f} GB on {card}")
            # counted for phase 7 against the dry run's long_500k pair
            _, counted, _ = count_call(
                f"decode {arch} long_500k", lambda: infer(long_model.decode_step, params, tok,
                                                          pos, cache),
                (params, cache, tok, pos), long_ms, cfg, shape_name="long_500k")
            if counted:
                fail(f"{arch} long_500k: the decode step launched {counted}; decode keeps the "
                     "masked einsum")
            del long_model, cache, tok, pos
        del params, res, model
        torch.cuda.empty_cache()
    counts = launch_counts()
    print(f"[serve] launches: {json.dumps(counts)}")
    for kernel, by_shape in launch_shapes().items():
        if by_shape:
            print(f"[serve] {kernel} launches by shape (b, s, s_kv, h, kv, hd or the scan's): "
                  + ", ".join(f"{key} x {n}" for key, n in sorted(by_shape.items())))
    for kernel, want in serve_launches.items():
        if counts[kernel] != want:
            fail(f"{kernel}: {counts[kernel]} launches on the serving path, expected {want}")
        results[kernel]["launches"] = counts[kernel]

    # forward (kernels) against teacher-forced decode (cache path) in f32;
    # qwen3-moe with capacity 100 tokens an expert, as tests/test_models.py
    # decodes moe archs: no drops, so both paths route every token alike.
    # (arch, cut, shape name, rows, tokens): gemma2-2b's local / global pair
    # and granite-3-2b's long_500k variant over the window plus 256, so their
    # rings of 4096 wrap and the windowed flash differs from full attention
    f32_checks = [("smollm-360m", dict(n_layers=4), "", 2, 256),
                  ("falcon-mamba-7b", dict(n_layers=4), "", 2, 256),
                  ("qwen3-moe-30b-a3b", dict(n_layers=2, moe_capacity_factor=100.0), "", 2, 256),
                  ("stablelm-12b", dict(n_layers=4), "", 2, 256),
                  # two super-blocks and a tail block: the shared block's cache used twice
                  ("zamba2-7b", dict(n_layers=13), "", 2, 256),
                  # whisper at full depth, its cross cache filled from the encoder
                  # output; paligemma with no patches: pure gemma decoding
                  ("whisper-tiny", {}, "", 2, 256), ("paligemma-3b", dict(n_layers=4), "", 2, 256),
                  ("gemma2-2b", dict(n_layers=2), "", 1, 4352),
                  ("granite-3-2b", dict(n_layers=4), "", 2, 256),
                  ("granite-3-2b", dict(n_layers=2), "long_500k", 1, 4352)]
    for arch, cut, shape_name, rows, seq in f32_checks:
        cfg = get_arch(arch).replace(dtype="float32", **cut)
        model = build_model(cfg, shape_name, device="cuda")
        g = torch.Generator(device=dev).manual_seed(1)
        params = model.init(g)
        tokens = torch.randint(0, cfg.vocab, (rows, seq), generator=g, device=dev)
        frontend = frontend_inputs(cfg, rows, g) if cfg.family == "audio" else {}
        wrap = seq > cfg.sliding_window > 0 and (cfg.alt_local_global or model.long_context)
        t0 = time.perf_counter()
        err, late, ring = decode_against_forward(model, params, tokens, frontend, wrap)
        wall = time.perf_counter() - t0
        if not err < 5e-2:
            fail(f"{arch}{' ' + shape_name if shape_name else ''}: f32 forward vs teacher-forced "
                 f"decode max |err| {err} >= 5e-2")
        note = ""
        if wrap:  # the same params with no window: full attention past the ring
            plain = build_model(cfg.replace(sliding_window=0), device="cuda")
            with torch.inference_mode():
                windowed, _ = model.forward(params, Batch(tokens=tokens))
                dense, _ = plain.forward(params, Batch(tokens=tokens))
            gap = float((windowed[:, ring:] - dense[:, ring:]).abs().max())
            if not gap > 10 * late:  # the decode follows the window, not full attention
                fail(f"{arch}{' ' + shape_name if shape_name else ''}: past the ring of {ring} "
                     f"the windowed forward is within {gap} of full attention, the decode "
                     f"within {late} of the windowed forward")
            note = (f"; the ring of {ring} wraps for the last {seq - ring} steps, max abs err "
                    f"there {late:.3e}, where full attention differs by {gap:.3e}")
            del plain, windowed, dense
        print(f"[serve] {arch}{' ' + shape_name if shape_name else ''} f32, {cfg.n_layers} "
              f"layers, full width: forward vs teacher-forced decode over ({rows}, {seq}) "
              f"tokens, max abs logit err {err:.3e} (bound 5e-2){note}; {wall:.1f} s of wall "
              f"on {card}")
        del params, model
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
        # each run draws the same params anew (seed 0), so no other copy is
        # live beside a run's state
        def init_params():
            return model.init(torch.Generator(device=dev).manual_seed(0))

        n_params = count_elements(init_params())
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
            # the run's state and steps in expandable segments (count_call
            # turns them off after its step): what a step frees then goes back
            # to the card on empty_cache, where holes among a run's live blocks
            # (38.06 GiB of them after qwen3-moe's int8 steps) refused its
            # counted step's 18.55 GiB round buffer
            torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
            trainer = DFLTrainer(model, n_nodes, DFLConfig(gossip_mode=mode, codec=codec,
                                                           lr=lr, warmup=0),
                                 device="cuda", timed=True)
            state = trainer.state_from_params(init_params())
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
            reprofile = False  # the profiler's record of the fourth step fell short
            for i in range(steps + 1):
                if i == steps and not reprofile:
                    break
                before = launch_counts()
                profiled = mode == "tree_allreduce" and i >= 3
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
                complete = not profiled or (
                    n_kernels["flash backward"] == 2 * per_step
                    and n_kernels["flash forward"] == fwd_per_step
                    and n_kernels["scan backward"] == 2 * scan_per_step
                    and n_kernels["scan forward"] == scan_per_step and n_kernels["GEMMs"] > 0)
                if not complete and i < steps:
                    # a record that lacks kernels the launch counters saw
                    # (seen once on an H100, its cause not found: PERF.md
                    # section 7): the measurement, not the step, failed; the
                    # next step is profiled, once
                    print(f"[train] {run} step {i} under torch.profiler: its record holds "
                          f"{dict(n_kernels)} kernels by group, not those launched; "
                          f"profiling step {i + 1}")
                    reprofile = True
                elif profiled:  # where a steady step's device time goes
                    if not complete:
                        fail(f"profiled step: {dict(n_kernels)} kernels by group; expected "
                             f"{2 * per_step} of the flash backward (D and the fused passes a "
                             f"launch), {fwd_per_step} of the forward, {scan_per_step} of the "
                             f"scan forward, {2 * scan_per_step} of its backward (the kernel "
                             "and its finishing pass a launch) and GEMMs")
                    split = ", ".join(f"{g} {dev_ms[g]:.3f} ms ({n_kernels[g]} kernels)"
                                      for g in STEP_GROUPS)
                    # the profiler slows the host's issue, so the idle share is
                    # also read against the unprofiled step before
                    steady_ms = 1e3 * walls[2]
                    print(f"[train] {run} step {i} under torch.profiler, device time by group: "
                          f"{split}; device busy {busy_ms:.3f} ms of the profiled step's "
                          f"{span_ms:.3f} ms (idle {100 * (1 - busy_ms / span_ms):.1f}%) and of "
                          f"step 2's {steady_ms:.1f} ms unprofiled (idle "
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
                  f"{json.dumps(counts)}; model kernels by shape: " + "; ".join(
                      f"{k} {sorted(v.items())}" for k, v in launch_shapes().items()
                      if v and k not in GOSSIP_KERNELS))
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
            # one more steady step counted for phase 7 (FLOPs, launches, peak),
            # beside the unprofiled steady step's time (step 2 of a tree run)
            steady_ms = 1e3 * walls[2 if mode == "tree_allreduce" else -1]
            (state, m), counted, counted_shapes = count_call(
                f"train {run}", lambda: trainer.train_step(state, batch), (state, batch),
                steady_ms, cfg, shape_name="train_4k", nodes=n_nodes, layers=cfg.n_layers,
                batch=n_nodes * bpn, seq=seq, gossip_mode=mode,
                dfl_overrides=dict(codec=codec, lr=lr, warmup=0))
            train_launches.update(counted)
            if codec and timed:
                for name in (k for k in want if k in timed):
                    results[name]["launches"] += counted.get(name, 0)
                    add_shape_launches(name, counted_shapes[name], f"train {run} counted step")
            if counted.get("selective_scan_bwd"):
                add_shape_launches("selective_scan_bwd", counted_shapes["selective_scan_bwd"],
                                   f"train {run} counted step")
            del trainer, state, m
            torch.cuda.empty_cache()
        for kernel in ("flash_attention", "flash_attention_bwd", "selective_scan",
                       "selective_scan_bwd"):
            results[kernel]["launches"] += train_launches[kernel]
        if cfg.family == "moe":  # what the global-batch aux loss costs a step
            trainer = DFLTrainer(model, n_nodes, device="cuda")
            stacked = tree_map(lambda t: t.expand(n_nodes, *t.shape), init_params())
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
        torch._C._accelerator_setAllocatorSettings("expandable_segments:False")
        del model, batch
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
    # granite-3-2b at full width and 4 of its 40 layers, (2, 2048) a node,
    # lr 3e-4: 0.344 B params a node, int8 dissemination (its codec and mix
    # shapes timed in phase 2), then tree rounds
    cfg = get_arch("granite-3-2b").replace(n_layers=4, remat=False)
    data, _ = train_path(cfg, 2, [("dissemination", "int8", 2), ("tree_allreduce", "", 4)],
                         lr=3e-4, timed=GOSSIP_KERNELS)
    grad_check(cfg.replace(dtype="float32"), data, 2)
    # gemma2-2b at full width and 2 of its 26 layers (one local / global
    # pair), (1, 2048) a node, lr 3e-4: tree rounds only (0.746 B params a
    # node, whose (N, N, P) f32 dissemination buffer is printed above the
    # run). The gradient check runs over (1, 4352) tokens, the window plus
    # 256, so the local layer's windowed, softcapped flash backward masks keys
    cfg = get_arch("gemma2-2b").replace(n_layers=2, remat=False)
    train_path(cfg, 1, [("tree_allreduce", "", 4)], lr=3e-4)
    grad_check(cfg.replace(dtype="float32"), FederatedData(DataConfig(
        vocab=cfg.vocab, seq_len=cfg.sliding_window + 256, batch_per_node=1, n_nodes=1,
        seed=0)), 1)

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

    # -- 7. the dry run against the card ---------------------------------------------
    # after every timed phase: the dry runs trace in spawned processes, the
    # --all training steps of the deepest stacks first (arctic-480b's 8
    # microbatches x 35 layers take minutes), then the counted runs' configs
    import multiprocessing

    from repro_torch.configs import list_archs
    from repro_torch.kernels.scan.mamba_scan import scan_bwd_workspace
    from repro_torch.launch.roofline import Roofline

    t7 = time.perf_counter()
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    print(f"[dryrun] card memory outside the allocator (the CUDA context, its libraries' "
          f"modules and tables): {outside / 1e9:.3f} GB of {total / 1e9:.1f} GB, before the dry "
          f"runs' processes start on {card}")

    def trace_weight(pair):  # a traced training step's ops grow with these
        cfg = get_arch(pair[0])
        return (INPUT_SHAPES[pair[1]].kind == "train", cfg.n_layers * max(cfg.microbatches, 1))

    all_pairs = sorted(((a, sh) for a in list_archs() for sh in INPUT_SHAPES),
                       key=trace_weight, reverse=True)

    def all_job(pair):  # an --all pair's dry run, at full depth but ALL_CUT's
        return dict(arch=pair[0], shape_name=pair[1], layers=ALL_CUT.get(pair))

    def all_pair(dry):  # a counted run that is an --all pair: its traced result
        return (dry["arch"], dry["shape_name"]) if dry.keys() <= {"arch", "shape_name",
                                                                  "arch_overrides"} \
            and not dry.get("arch_overrides") else None

    # the main process only waits from here on: a worker a CPU, up to 8
    n_cpus = os.cpu_count() or 1
    n_workers = max(1, min(8, n_cpus))
    t_pool = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(n_workers) as pool:  # terminated on exit
        # the deepest stacks start first
        all_futs = {p: pool.apply_async(dry_worker, (all_job(p),)) for p in all_pairs[:n_workers]}
        dry_futs = [None if all_pair(run["dry"]) else pool.apply_async(dry_worker, (run["dry"],))
                    for run in counted_runs]
        all_futs.update({p: pool.apply_async(dry_worker, (all_job(p),))
                         for p in all_pairs[n_workers:]})
        # a counted long_500k decode step is held to its --all pair, traced once
        dry_futs = [fut or all_futs[all_pair(run["dry"])]
                    for run, fut in zip(counted_runs, dry_futs)]
        # phase 8's meshed dry runs, queued behind phase 7's (rank 0 of each
        # production layout, full depth; (b)'s pairs first)
        train_archs = {a for a, _, _ in MESH_TRAIN}
        mesh_pairs = [(m, a, sh) for m in MESH_LAYOUTS for a in list_archs()
                      for sh in INPUT_SHAPES if sh != "train_4k" or a in train_archs]
        mesh_pairs.sort(key=lambda p: (p[0] != "16x16" or p[1] not in MESH_RANK0
                                       or p[2] not in ("prefill_32k", "decode_32k")))
        # (d)'s steps: full depth at MESH_TRAIN_BATCH rows; P8's pair
        train_dry = {}
        jobs = {}
        for arch, mode, codec in MESH_TRAIN:
            key = train_dry[arch] = ("16x16", arch, "train_4k", "d", get_arch(arch).n_layers)
            jobs[key] = dict(arch=arch, shape_name="train_4k", mesh="16x16",
                             batch=MESH_TRAIN_BATCH, layers=key[-1], gossip_mode=mode,
                             dfl_overrides={"codec": codec})
        jobs[P8_PAIR] = dict(arch=P8_PAIR[1], shape_name=P8_PAIR[2], mesh=P8_PAIR[0],
                             layers=P8_PAIR[3])
        mesh_futs = {k: pool.apply_async(dry_worker, (kw,)) for k, kw in jobs.items()}
        mesh_futs.update({p: pool.apply_async(dry_worker, (dict(arch=p[1], shape_name=p[2],
                                                                mesh=p[0]),))
                          for p in mesh_pairs})
        # the scan backward's workspace as the fake route allocates it,
        # against the source's own count
        for shape in ((1, 2048, 8192, 16), (2, 2048, 8192, 16), (2, 1000, 1024, 32)):
            if scan_bwd_workspace(*shape) != _build.lib().rt_selective_scan_bwd_workspace(*shape):
                fail(f"scan_bwd_workspace{shape} differs from rt_selective_scan_bwd_workspace")
        card_bytes = 0
        for run, fut in zip(counted_runs, dry_futs):
            dry, st, label = fut.get(), run["stats"], run["label"]
            card_bytes = max(card_bytes, dry.get("card_bytes", 0))
            if dry["status"] != "ok":
                fail(f"dry run of {label}: {dry.get('error')}\n{dry.get('traceback')}")
            if dry["flops_per_device"] != st.flops:
                fail(f"{label}: the dry run's FLOPs {dry['flops_per_device']} != the counted "
                     f"step's {st.flops} on the card")
            if not dry["kernel_launches"] == dict(st.launches) == run["launches"]:
                fail(f"{label}: kernel launches, dry run {dry['kernel_launches']}, op counter "
                     f"{dict(st.launches)}, launch_counts {run['launches']}")
            if dry["start_memory_bytes"] != st.start_bytes:
                fail(f"{label}: the dry run's live tensors at the start, "
                     f"{dry['start_memory_bytes']} B, differ from the card's {st.start_bytes} B")
            if dry["bytes_per_device"] != st.bytes:
                diff = {k: (dry["bytes_by_op"].get(k, 0), v) for k, v in st.bytes_by_op.items()
                        if dry["bytes_by_op"].get(k, 0) != v}
                fail(f"{label}: the dry run's bytes {dry['bytes_per_device']} != the counted "
                     f"step's {st.bytes} (by op, dry run and card: {diff})")
            # the card's bytes requested at the step's peak, less the tensors
            # Python held beside it and cuBLAS's workspaces
            requested = run["requested_peak"] - run["held"] - run["workspaces"]
            if requested != dry["peak_memory_bytes"]:
                fail(f"{label}: the dry run's peak {dry['peak_memory_bytes']} B differs from "
                     f"the {requested} B the step requested at its peak on the card "
                     f"({run['requested_peak']} B less {run['held']} B of tensors held beside "
                     f"and {run['workspaces']} B of cuBLAS workspaces)")
            # what the process holds on the card beside the step's live tensors
            other = run["base"] - st.start_bytes
            rest = other - run["held"] - run["workspaces"]
            measured, predicted = run["peak"], dry["peak_memory_bytes"] + other
            gap = (measured - predicted) / measured
            if not abs(gap) <= PEAK_TOL:
                fail(f"{label}: predicted peak {predicted / 1e9:.3f} GB (the dry run's "
                     f"{dry['peak_memory_bytes'] / 1e9:.3f} GB and {other / 1e9:.3f} GB held "
                     f"beside), measured {measured / 1e9:.3f} GB: {100 * gap:.2f}% apart, more "
                     f"than {100 * PEAK_TOL:.0f}%")
            largest = ", ".join(f"{d} {n / 1e6:.1f} MB" for n, d in run["largest_held"])
            roof = Roofline(dry["arch"], dry["shape"], dry["mesh"], 1, dry["flops_per_device"],
                            dry["bytes_per_device"], dry["collective_bytes_per_device"],
                            predicted, dry["model_flops"])
            step_s = run["step_ms"] / 1e3
            print(f"[dryrun] {label}: FLOPs {st.flops:.6e} (dry run = counted), launches "
                  f"{json.dumps(run['launches'])} (dry run = op counter = launch_counts); peak: "
                  f"dry run {dry['peak_memory_bytes']} B + {other} B held beside the step's "
                  f"{st.start_bytes} B of live tensors ({run['held']} B of tensors Python "
                  f"holds [{largest}], {run['workspaces']} B of cuBLAS workspaces, {rest} B "
                  f"of the allocator's rounding at the start) = {predicted / 1e9:.3f} GB, "
                  f"measured {measured / 1e9:.3f} GB "
                  f"({100 * gap:+.3f}%, tol {100 * PEAK_TOL:.0f}%; the dry run alone "
                  f"{100 * (measured - dry['peak_memory_bytes']) / measured:+.2f}%): "
                  f"{run['requested_peak']} B requested (less what is held beside: the dry run's "
                  f"peak exactly), {measured - run['requested_peak']} B the allocator's "
                  f"rounding; bytes "
                  f"{dry['bytes_per_device']:.6e} (= counted); compute {1e3 * roof.compute_s:.3f} ms, "
                  f"memory {1e3 * roof.memory_s:.3f} ms, collective "
                  f"{1e3 * roof.collective_s:.3f} ms; bound {1e3 * roof.bound_s:.3f} ms "
                  f"({roof.bottleneck}); step {run['step_ms']:.1f} ms (unprofiled, steady); "
                  f"roofline share {100 * roof.roofline_share(step_s):.2f}%, MFU "
                  f"{100 * roof.mfu(step_s):.2f}% (model FLOPs {roof.model_flops:.6e}) on {smi}")
        for (arch, shape), fut in sorted(all_futs.items()):
            dry = fut.get()
            card_bytes = max(card_bytes, dry.get("card_bytes", 0))
            if dry["status"] == "skipped":
                print(f"[dryrun --all] {arch} x {shape}: skipped ({dry['reason']})")
                continue
            if dry["status"] != "ok":
                fail(f"dry run of {arch} x {shape}: {dry.get('error')}\n{dry.get('traceback')}")
            print(f"[dryrun --all] {arch} x {shape} ({dry['traced_on']}, "
                  f"{dry['global_batch']} x {dry['seq_len']}, "
                  f"{dry['n_layers']} layers, 4 nodes for training): peak "
                  f"{dry['peak_memory_bytes'] / 1e9:.2f} GB, fits_hbm {dry['fits_hbm']} "
                  f"({total / 1e9:.1f} GB); FLOPs {dry['flops_per_device']:.4e}, bytes "
                  f"{dry['bytes_per_device']:.4e}; compute {1e3 * dry['compute_s']:.2f} ms, "
                  f"memory {1e3 * dry['memory_s']:.2f} ms ({dry['bottleneck']}), collective "
                  f"{1e3 * dry['collective_s']:.2f} ms; useful FLOPs "
                  f"{dry['useful_flops_ratio']:.3f}; launches "
                  f"{json.dumps(dry['kernel_launches'])}; traced in {dry['trace_s']} s")
        print(f"[dryrun] phase 7: {time.perf_counter() - t7:.1f} s after phase 6")
        mesh_dry = {p: fut.get() for p, fut in mesh_futs.items()}
    n_reused = sum(1 for run in counted_runs if all_pair(run["dry"]))
    print(f"[dryrun] the dry runs ({len(dry_futs)} counted configs, {n_reused} of them --all "
          f"pairs traced once; {len(all_futs)} --all pairs, {len(mesh_dry)} meshed pairs for "
          f"phase 8) in a pool of {n_workers} processes on os.cpu_count() = {n_cpus}: "
          f"{time.perf_counter() - t_pool:.1f} s of wall; card memory they allocated: "
          f"{max([card_bytes] + [d.get('card_bytes', 0) for d in mesh_dry.values()])} B")
    print(f"[dryrun] phases 7 and 8 (c)'s dry runs: {time.perf_counter() - t7:.1f} s after phase 6")

    # -- 8. the mesh ------------------------------------------------------------------------
    phase_mesh(phase4, mesh_dry, n_prefill, smi, held_tensors, train_dry)

    print(smi)
    print(json.dumps({"kernels": [results[k] for k in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
