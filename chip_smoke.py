#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package.  Builds the Hopper kernels
from the sources in this checkout, nine libraries (the five forward
kernels and the backward kernels of flash_attention, moe_gmm, mamba_scan
and rglru_scan; each kernel's registers and spills from ptxas; the HGMMA
instructions of the flash library, the flash backward's and the moe_gmm
backward's, counted in their SASS, each of which must be above 0, and no
spill in their bf16 (wgmma) kernels or in either scan kernel, forward or
backward; the flash backward's 10 wgmma, 10 CUDA-core and 2 D
instantiations and its sum of the hd-256 dK/dV parts; the moe_gmm
backward's four wgmma kernels and its
probe), then runs, each phase printing one JSON line and any failure
raising:

0. Training, first, so that a failure shows early.
   flash_attention_bwd: the backward kernel's dq, dk, dv (through
   `flash_attention`'s autograd function) against autograd through the
   plain version, at f32 2e-5 and bf16 2e-2 of each gradient's largest
   value plus the same of its own value, bit for bit against a second
   run, and the forward's lse against torch.logsumexp of the plain
   scores: the flash sweep and a causal row with Sq > Sk in both types,
   then smollm-360m's training shape (B 8, Hq 15, Hkv 5, hd 64, S 4096,
   causal, bf16), its layout in f32 at S 512, hd 128 group 8 (yi), hd 160
   padded to 256 (stablelm), a window of 256 (f32), a non-causal row
   with Sq 455, Sk 1,600 and recurrentgemma-2b's training shape (B 1,
   Hq 10, Hkv 1, hd 256, S 4096, window 2048, bf16); each timed (events,
   and the profiler's device ms in all and by pass: D, dK/dV, the sum of
   the hd-256 parts, dQ) beside its bound (five products of 2 Sq Sk hd a
   head over the live entries, at 989 TFLOP/s bf16 or 67 f32), the plain
   version's backward (autograd, one batch element at a time), SDPA's
   (forward + backward less forward, K/V repeated to the query heads)
   and, for bf16 at hd 256, the f32 CUDA-core kernels' on the same
   values.
   moe_gmm_bwd, rglru_scan_bwd, mamba_scan_bwd: the three backward
   kernels the same way (through each op's autograd function against
   autograd through its plain version, or at falcon-mamba's full shape
   against the explicit `mamba_scan_bwd_ref`; f32 2e-5 and bf16 2e-2 of
   each gradient's largest value; bit for bit against a second run): the
   kernel sweeps in both types (mamba with and without h_S's gradient,
   moe_gmm with a quarter of its capacity rows empty, whose dh must be
   zero), then the training shapes (qwen3-moe E 128, C 320, D 2048, F 768
   and deepseek-moe E 64, C 480, F 1408, bf16; recurrentgemma B 1, S 4096,
   D 2560, f32; falcon-mamba B 1, S 4096, D 8192, N 16, x bf16), a small
   f32 row and a ragged row each, rglru's also bit for bit against its
   kernel's order of operations in plain torch
   (`rglru_scan_bwd_chunked_ref`); timed (events and profiler; rglru's
   one kernel and the memset of its status words, mamba's four passes
   apart) beside the bound, the plain
   version's backward, mamba's SFU floor for its design's two
   exponentials a state and step, its bytes and its passes' resident
   blocks an SM, and for moe_gmm autograd through three `torch.bmm`
   (`bmm_trio_bwd_ms`), a yardstick never on the path.  moe_gmm_bwd runs
   its wgmma probe first (its tile products in the three operand
   orientations, from 16-byte copies and from element loads, against
   torch.matmul within 1e-5 of the products' magnitudes), and each of its
   rows names its kernels from the profiler (bf16 on wgmma alone, f32 on
   the CUDA cores alone) with each kernel's device ms.
   train_golden, train_golden_qwen3, train_golden_mamba,
   train_golden_rgemma: reduced smollm-360m (f32, in its head layout),
   qwen3-moe-30b-a3b, falcon-mamba-7b and recurrentgemma-2b (f32, their
   reduced layouts) with the JAX package's weights
   (src/repro_torch/data/<arch>_reduced_train_golden.npz), 5 steps of
   `make_train_step`: losses, grad norms and lr within rtol 1e-5 of the
   JAX run, the parameters after steps 3 and 5 within atol/rtol 1e-5,
   each kernel's forward 2 launches and its backward 1 a layer of its
   kind a step; a checkpoint after step 3 restored into a fresh state
   repeats steps 3-4 bit for bit.
   train_full: smollm-360m at full width and depth, float32 masters made
   on the card from seed 0, bf16 compute, full remat, S 4096, B 8 (printed
   as `reduced`: train_4k's batch of 256 needs ~206 GB of f32 logits), 12
   steps through `launch.train.main` with a checkpoint under build/:
   every loss finite, the last 3 below the first 3 on average, 64 flash
   and 32 backward launches a step; the checkpoint restored and 2 steps
   profiled: step ms (host) and device ms, the idle share, tokens/s, the
   backward kernel's share of a step, peak memory, init seconds.
   collectives: the rotor collectives (`core.collectives`, every function
   of the JAX package's) on CUDA tensors in worlds of 3 ranks on `data`,
   4 on `data` and 4 as `pod` 2 x `data` 2, started with
   `core.comm.spawn_world` (spawn, a file:// store in a temporary
   directory) after the build, all on the one card: gloo, staged through
   host memory, since NCCL refuses two ranks on one card.  Each held to a
   float64 reference that every rank computes from every rank's seeded
   input (atol/rtol 1e-5; the compressed one within a relative 0.05);
   each rank's wire bytes per input byte beside `schedule_stats`'s, and
   the host ms of a call over loopback, not NVLink.
   The 4-rank phases that follow, opera_dp_golden to serve_mesh_full,
   run on four rank processes started once (`_RankPool`), a task a
   phase; a phase run alone (scripts/chip_ab.py) opens a pool for it.
   opera_dp_golden: the explicit data-parallel trainer
   (`train.opera_dp`) on 4 ranks as `pod` 2 x `data` 2: reduced
   smollm-360m (2 layers, vocab 64, hd 64 with 3 query heads a KV head,
   f32) from the JAX package's weights, 3 steps held to the JAX package's
   `make_opera_dp_train_step` on 4 fake CPU devices
   (src/repro_torch/data/smollm_360m_reduced_opera_dp_golden.npz: losses,
   grad norms and lr rtol 1e-5, the parameters after each step atol/rtol
   1e-5), the replicas the same bits, each rank's flash launches counted,
   and the losses within 1e-3 of the card's single-process
   `make_train_step` on the whole batch.
   opera_dp_full: smollm-360m at full width as train_full (f32 masters
   from seed 0, bf16 compute, S 4096, global B 8) through
   `launch.train.main` on 4 ranks as `data` 4 on the one card, 4 steps
   plain, then 4 with ``--compress-grads``: every loss finite and
   falling, the four replicas the same bits after every step (two
   position-weighted sums of every leaf's words after each step, the
   SHA-256 of all parameters after the last), the flash kernels' launches
   on every rank; step ms and the wire's ms within it, wire and peak
   bytes per rank, and each step's loss beside train_full's.
   fsdp_golden: the dense weights' FSDP / TP layout (`models.sharding`,
   fsdp_tp: each rank holds its blocks of every leaf and of both AdamW
   moments, gathers them on use, gets its gradients reduce-scattered)
   in `make_train_step` on 4 ranks as `data` 2 x `model` 2: reduced
   smollm-360m in f32 from the stored weights, 3 steps held to the JAX
   package's GSPMD `make_train_step` on 4 fake CPU devices
   (src/repro_torch/data/smollm_360m_reduced_fsdp_golden.npz: losses,
   grad norms and lr rtol 1e-5, each rank's blocks of the parameters and
   both moments atol/rtol 1e-5), every leaf the rules shard held as a
   block, the ranks of one block the same bits, the launches counted.
   fsdp_full: smollm-360m at full width and depth as train_full through
   `launch.train.main` at ``--trainer gspmd --tp 2`` on 4 ranks as
   `data` 2 x `model` 2, 4 steps: every loss finite and falling, the
   ranks of one block the same bits, the launches counted; step ms and
   the wire's ms within it, bytes sent, each rank's bytes of parameters
   and moments and its peak GB, each step's loss beside train_full's.
   ep_golden: experts over the model axis (`models.moe`'s all-to-all
   branch, `train.trainer.make_train_step` on a mesh) on 4 ranks as
   `data` 2 x `model` 2: reduced qwen3-moe-30b-a3b (f32, 4 experts a
   rank) from the JAX package's weights, 3 steps with each dispatch
   (rotor, rotor_vlb, xla) held to the JAX package's GSPMD
   `make_train_step` on 4 fake CPU devices
   (src/repro_torch/data/qwen3_moe_30b_a3b_reduced_ep_golden.npz: losses,
   grad norms and lr rtol 1e-5, each rank's block of the parameters
   atol/rtol 1e-5; the dense leaves cut by the FSDP / TP rules too), the
   dispatches the same bits and the ranks of one block the same bits,
   the kernels' launches counted on every rank.
   ep_full: qwen3-moe-30b-a3b at full width on 4 ranks as `model` 4 (32
   experts a rank, rotor dispatch; the embedding and head cut over the
   ranks and gathered on use), 1 of 48 layers at S 2048, B 1
   (printed as `reduced`: 2 layers, or 1 at S 4096, run out of the
   card's 80 GB with 4 ranks on it), 6 steps of `make_train_step`:
   every loss finite, the first batch's loss lower after the run, the
   replicated leaves the same bits on every rank, the launches counted;
   step ms and the wire's ms within it, wire bytes and peak GB a rank.
   tp_golden: the tensor-parallel compute over `model` (attention split
   by heads, the FFN by width, the embedding and the head by vocab with
   the logsumexp combined over `model`) as fsdp_golden, on reduced
   qwen1.5-110b (QKV bias, untied head) against
   src/repro_torch/data/qwen15_110b_reduced_tp_golden.npz.
   tp_full: yi-9b at full width on 4 ranks as `model` 4 (8 / 1 heads, a
   quarter of the FFN's width and of the vocabulary a rank), 12 of 48
   layers at S 4096, B 1, 6 steps of `make_train_step`, then the same
   run on one rank on whole weights: every loss finite and falling and
   within bf16's 2e-2 of the one rank's, the first gradient norms too;
   the replicated leaves the same bits on every rank; the leaves
   gathered over `model` exactly those the rules cut over it that do not
   compute tensor-parallel (`final_norm`'s scale); each rank's state its
   blocks; the launches counted; step ms and the wire's ms and bytes
   within it, the collectives a step by kind and axis, the flash calls
   by heads, peak GB a rank.
   serve_mesh_golden, serve_mesh_full: serving over `model`
   (`ServeEngine` with a mesh context, the cache placed by
   `models.sharding.cache_spec`), 4 ranks as `model` 4 in one task
   of the rank pool (`phase_serve_mesh`).  Reduced qwen3-moe-30b-a3b (f32,
   8 / 4 heads, 1,024 positions a slot: the cache cut by positions)
   against the stored JAX `ServeEngine` run on 4 fake CPU devices
   (src/repro_torch/data/qwen3_moe_30b_a3b_reduced_serve_mesh_golden.npz:
   tokens equal, every prefill's and tick's logits within 1e-4; prompts
   whose lengths divide 4 take the MoE's all-to-all prefill); then
   qwen3-moe at full width in bf16 (12 of 48 layers, printed as
   `reduced`; 8 / 1 heads, 32 experts and 37,984 words a rank), 4 slots
   of 1,024, 8 requests of odd lengths, 8 new tokens each, held to the
   same requests on one rank on whole weights with the mesh's router
   decisions replayed (prefill logits within bf16's 2e-2 of its largest
   magnitude), and to the free one-rank run within a limit that parts a
   one-rank run with the attention in f32 from one with the KV heads
   rolled, both run and checked, with no first-layer router decision
   apart at a logit gap above 2e-2 (ROADMAP Queue 3, B7); every rank's
   tokens the same, every tick's logits finite, moe_gmm on 32 experts in every
   MoE layer of every prefill and tick and flash on 8 / 1 heads in every
   layer of every prefill, counted; tick and prefill ms with the wire's
   within them, the collectives a tick by kind and axis, bytes a rank
   sends, peak GB a rank.
   tp_ssm_golden: the mamba and RG-LRU mixers split by channels over
   `model` (`models.sharding.computes_tp`; mamba's in_proj held as the
   rank's x and z columns, `held_columns`) on 4 ranks as `model` 4:
   reduced falcon-mamba-7b (32 of 128 channels a rank) and
   recurrentgemma-2b (16 of 64) in f32 against the stored JAX GSPMD runs
   on 4 fake CPU devices (src/repro_torch/data/
   <arch>_reduced_tp_golden.npz): 3 steps of `make_train_step` under
   fsdp_tp (losses, grad norms and lr rtol 1e-5, each rank's blocks of
   the parameters and both moments after the last atol/rtol 1e-5, the
   ranks of one block the same bits) and `ServeEngine` (4 slots, 6
   prompts of 9 and 12 tokens, 4 new each: tokens equal, every prefill's
   and tick's logits within 1e-4, the conv / SSM / LRU states a quarter
   of the channels a rank); no mixer leaf gathered over `model`, the
   scans launched on the rank's channels alone (`_Census.scans`), every
   launch counted.
   tp_ssm_full: falcon-mamba-7b at full width on `model` 4 (2,048 of
   8,192 channels a rank), 8 of 64 layers (printed as `reduced`), f32
   masters from seed 0, bf16 compute, B 1, S 4096, 4 steps at lr 3e-4,
   then `ServeEngine` (4 slots, 4 prompts of 135-455 tokens, 8 new each)
   on the seed-0 bf16 weights; both again on one rank on whole weights
   (`_tp_ssm_whole`): losses within 2e-2 and the first grad norm within
   1e-3 of the one rank's, prefill logits within 2e-2 of its largest
   magnitude, every rank's tokens the same, every tick's logits finite,
   no mixer leaf gathered over `model`, `mamba_scan` and
   `mamba_scan_bwd` on 2,048 channels in every layer of every step, the
   states held at (4, 3, 2,048) / (4, 2,048, 16) a rank; step, prefill
   and tick ms with the wire's ms within each, collectives by kind,
   bytes sent, peak GB a rank, a rank's mixer weights and states beside
   the whole ones, beside the card's name and power limit.
   train_full_qwen3, train_full_falcon_mamba, train_full_rgemma: the
   MoE, SSM and hybrid archs at full width, the same way at B 1, S 4096
   (printed as `reduced`), 10 steps without a checkpoint: qwen3-moe at 4
   of its 48 layers and falcon-mamba at 30 of its 64 (80 GB force both
   cuts, printed with the reason) through `make_train_step`,
   recurrentgemma-2b at all 26 through `launch.train.main`; every loss
   finite and falling, the parameter count `count_params`'s, every
   kernel's launches exact; 2 profiled steps: step ms, device ms, the idle
   share, tokens/s, peak memory, each backward kernel's device ms a step
   and share, the top kernels.

1. kernel: the `rotor_slice` CUDA kernel against its plain PyTorch
   version on the card, vlb on and off, at k8-n16-g1, k12-n108-g1,
   k12-n108-g2 and k64-n1024-g4 (B = 16, and B = 1 at k12-n108-g1 as
   Fig. 8 runs it; random non-negative state with a zero diagonal), and
   at k64-n1024-g4 again in the worst case for pass B's gather (own
   below 1, relay zero: every partner has room); state atol 1e-5,
   totals rtol 1e-5, the same bits from a second launch.  Times the
   kernel and the plain version with CUDA events beside the byte bound,
   and the kernel's own device time from the profiler's trace, both
   passes and each (`rotor_rows`, `rotor_cols`), beside pass B's strip
   width and the design's bytes (20 B N^2 with vlb, 16 without).
2. fig08: Fig. 8 (OPERA_648, 100 KB all-to-all shuffle, no VLB, 40
   cycles) through `simulate_rotor_bulk_torch` with the dense and the
   sparse engine, on the JAX package's seed-0 topology stored in
   src/repro_torch/data/, held to the JAX package's stored stats at
   rtol 1e-4.
3. sweep: `sweep.run_design` at k64-n1024-g4, the largest Appendix-B
   point (lifted topology, sparse engine), over 4 workloads x 2 loads x
   2 seeds = 16 scenarios.  Every row must drain and conserve bytes, and
   the kernel must have launched once per slice.  Times the slice loop
   alone (host clock) beside the kernel's device time in it, and the
   peak device memory of `run_design`.
4. crossover: per-slice time of the dense and the sparse engine across
   the Appendix-B grid at B = 16.
5. fig11: Fig. 11's fluid and flow columns (benchmarks/fig11_faults.py,
   full mode) on the JAX package's seed-1, switch_fault_tolerance=2
   k12-n108 topology stored in src/repro_torch/data/: the ten failure
   rows (load 0.4 paced over 12 cycles, detection lag 3, 14 cycles) in
   one batched `simulate_rotor_bulk_batch` call with the dense engine and
   again with the sparse one, retention held to the JAX package's stored
   rows at rtol 1e-4 and the blackholed and residual fractions at atol
   1e-6, with the paper's checks (links 0.04 and switches 2/6 retain >=
   0.90, 3/6 falls more than 0.05 below 2/6); `FailureSchedule.empty()`
   unpaced on the sparse engine gives the same bits as no faults and
   launches `rotor_slice` once a slice; the four flow scenarios (28,072
   Websearch flows each, faults projected by `apply_flow_faults`) through
   the faulted dense flow engine, every result held to the stored one at
   tests/test_flows_jax.py's tolerances, the histograms to equal class
   totals and each class's p50 and p99 within one bin.  Times each slice
   loop and the flow loop (host clock), their kernel launches and device
   time a step (profiler), and each call's peak device memory.
6. flows_tiled: the tiled flow engine.  `fig09_h648`: Fig. 9's grid
   (benchmarks/fig09_websearch.py:13-22: opera, expander, clos; loads
   0.01-0.25; seeds 2 and 3) at the paper's 648 hosts, 30 scenarios of
   up to 126,327 flows and 4,498 steps, through `sweep.run_flow_sweep`
   with engine="auto", which must resolve to tiled, held to the JAX
   package's run in src/repro_torch/data/ at tests/test_flows_tiled.py's
   tolerances (every histogram bin equal, admitted and finished_frac
   equal, backlog_frac within 1e-5, each p99 within one bin), then the
   same grid on the dense engine on the card, the two engines held to
   each other the same way, and Fig. 9's three checks answered as the
   JAX package's stored run answers them.  `fig07_tiled`:
   Fig. 7's grid as the benchmark runs it (216 hosts, 32 Datamining
   scenarios) on the tiled engine, held to the stored run alike.
   `fig11_tiled`: Fig. 11's four flow scenarios on the tiled engine, held
   to the stored rows as the dense ones are, and Fig. 11's static
   cross-check (benchmarks/fig11_faults.py:134-158) through the port's
   `to_failure_set`, `connectivity_loss` and `path_stretch`, full mode
   held to the JAX package's stored cross-check, fast mode also to
   results/benchmarks/fig11_faults.json.  `crossover_rows`: both engines
   on one expander Websearch scenario at load 0.2, 648 hosts, horizons
   0.2, 0.8 and 2.4 s (33,687 to 404,248 flows).  Each run gives its
   seconds, ms a step (host clock), launches and device ms a step
   (profiler) and peak device memory, beside `tiled_state_bytes` and
   `dense_state_bytes`.
7. faulted_sparse_k64: the faulted sparse engine (plain torch) at
   k64-n1024-g4, the sweep's 16 scenarios, VLB, links 0.04 and 2
   switches failing at slice 0, paced over 2 of 3 cycles: every row
   conserves bytes at rtol 1e-5; its ms a slice and peak memory beside
   the unfaulted kernel's ms a slice in the sweep.
8. flash_attention: the bf16 kernel's wgmma tile products alone (S =
   Q K^T, O = P V at every head dim) against torch.matmul in f32 within
   1e-5 of the products' magnitudes; the CUDA kernel (bf16 on the tensor
   cores, f32 on the CUDA cores) against its plain version, f32 and
   bf16, at the sweep of tests/test_kernels.py:21-33, at the qwen3-moe
   prefill shapes (B 1, Hq 32, Hkv 4, hd 128, causal, S 128 / 512 /
   2048) and at recurrentgemma-2b's local attention (Hq 10, Hkv 1, hd
   256, window 2048, S 1900 / 3300), in bf16 at the layouts of
   smollm-360m (Hq 15, Hkv 5, hd 64), deepseek-moe-16b (Hq 16, Hkv 16, hd
   128) and stablelm-12b (Hq 32, Hkv 8, hd 160, zero-padded to 256 by the
   wrapper) at S 512, non-causal at seamless-m4t's encoder (Hq = Hkv =
   16, hd 64, S 455) and llama-3.2-vision's cross layers (Hq 64, Hkv 8,
   hd 128, Sq 455, Sk 1,600), and at head dims 320, 512, 768 and 1024
   (Hq 8, Hkv 2, S 512; the f32 kernel's hd-512 and hd-1024
   instantiations, bf16 widened to f32 around the call), at f32 2e-5 and
   bf16 2e-2; times the kernel (events and profiler), the plain version
   and, as a yardstick never on the path,
   `F.scaled_dot_product_attention` (causal, non-causal, or with the
   window as a boolean mask; `vs_library` is the kernel's time over it).
9. moe_gmm: the same at tests/test_kernels.py:89-92 and at E 128, D 2048,
   F 768 with C 4 (a 4-slot decode step), C 12 and C 40 (prefills of
   ~150 and 512 tokens), and in bf16 at deepseek-moe-16b's E 64, D 2048,
   F 1408 with C 4 (a decode step) and C 56 (a 455-token prefill);
   device ms of both passes together and of each,
   the share of the byte bound and GB/s.  No single PyTorch call
   computes the fused gated FFN, so no library time; as a yardstick
   never on the path, `bmm_trio_ms` times three `torch.bmm` calls plus
   silu in the row's type (it rounds g and u to that type).  Then the
   gate's gelu (tanh form) and relu instantiations of both kernels
   (ROADMAP Queue 3, F7): the sweep in f32 and bf16, forward against
   `moe_gmm_ref` (f32 2e-5, bf16 2e-2) and backward against
   `moe_gmm_bwd_ref` (f32 1e-4, bf16 2e-2 of each gradient's largest
   value) with the same activation, and qwen3-moe's shapes (forward C 4
   and C 40, backward C 320 in bf16; forward C 40 and backward on 16
   experts at C 40 in f32), each timed beside silu's instantiation on
   the same inputs (`act_rows`; the kernels line's `instantiations`).
10. mamba_scan: the same at tests/test_kernels.py:47-53 (f32 1e-4, bf16
   2e-2) and at falcon-mamba-7b's prefill (B 1, D 8192, N 16; S 512 with
   x bf16 or f32 beside f32 dt, B, C, and S 134 with x bf16) and training
   shape (S 4096, x bf16), y and the final state h_S at 1e-4, the same
   bits from a second call and from a call that also keeps the chunk
   states (held at 1e-4, timed apart: `states_ms`); each model row with
   the floor of its exponentials on the SFU (`sfu_floor_ms`: 16 a clock
   an SM at the SM clock nvidia-smi reads while the kernel runs), the
   design's bytes and `bound_share` (bound / device ms).
11. rglru_scan: the same at tests/test_kernels.py:73-75 and at
   recurrentgemma-2b's longest and shortest prefills (B 1, S 3300 and
   900, D 2560) and at a 32,768-token prompt, where the carries' cost
   shows, device ms of the three passes together and of each
   (`rglru_chunk_ends`, `rglru_chunk_carry`, `rglru_chunk_scan`), the
   design's 20 B an element and `bound_share`.
12. serve_golden, serve_golden_mamba, serve_golden_rgemma,
   serve_golden_deepseek, serve_golden_smollm, serve_golden_yi,
   serve_golden_stablelm, serve_golden_qwen15, serve_golden_seamless,
   serve_golden_llama_vision: each reduced arch in f32 (the seven
   transformer archs in their own head layouts, recorded in their files:
   deepseek MHA at hd 128, smollm hd 64 with 3 query heads a KV head, yi,
   qwen1.5 and llama-vision hd 128 with 8, stablelm hd 160 with 4,
   seamless MHA at hd 64) with the JAX package's weights
   (src/repro_torch/data/): prefill logits at atol/rtol 1e-4 (the two
   cross archs on seeded encoder frames or image embeddings, then three
   decode steps' logits too) and the greedy tokens of a 4-request,
   2-slot `ServeEngine` run equal to the JAX run's (the JAX engine's; for
   the cross archs each request's alone, since the JAX engine attends
   the zero padding of seamless's cross caches, ROADMAP Queue 3, R4),
   each kernel launched once per layer of its kinds per prefill (twice
   per decoder layer; moe_gmm per decode tick too).
13. serve_full, serve_full_falcon_mamba, serve_full_rgemma,
   serve_full_deepseek, serve_full_smollm, serve_full_yi,
   serve_full_stablelm, serve_full_qwen15, serve_full_seamless,
   serve_full_llama_vision: each model at full width in bf16, seed-0
   random weights on the card, at full depth but for qwen1.5-110b (20 of
   its 80 layers: 80 need ~225 GB) and llama-3.2-vision-90b (35 of 100,
   28 self + 7 cross: 100 need ~175 GB); the phase prints the cut:
   qwen3-moe-30b-a3b (48 layers), falcon-mamba-7b (64) and the seven
   transformer archs serve 8 requests of 128-512 tokens at 4 slots (the
   cross archs on the engine's zero encoder frames or image embeddings),
   recurrentgemma-2b (26 layers) 4 requests of 3,300 / 2,600 / 1,900 /
   900 tokens at 2 slots (past its 2,048 window), 16 new tokens each;
   the parameter count is held to `count_params` (and, for the seven,
   to the JAX package's full-width count), every kernel launch is
   counted, then a profiled window of decode ticks shows where a tick's
   time goes.  Each phase frees the last one's weights first.

Then each phase's seconds and the script's total, the kernel table line
(flash_attention's and moe_gmm's launches add the training runs',
the multi-rank phases' over their ranks; the four backward kernels at
their training shapes, their launches summed over the training runs), the card's name and power limit, and the device line.  Exits
non-zero, printing no result, without a CUDA card or outside a checkout
of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
ARCH = "qwen3-moe-30b-a3b"
SWEEP_CYCLES = 3   # every row drains within 2 cycles (512 slices)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# ---------------- four ranks shared by the multi-rank phases -------------------

# the open `_RankPool` (`main`'s, or a phase's own when it runs alone)
_POOL = None


def _pool_rank(rank: int, size: int, store: str, device: str, tasks,
               results) -> None:
    """A `_RankPool` rank: joins the world once, then runs each task
    ``(fn, args)`` as ``fn(world, *args)`` with the kernels' launch counts
    cleared and the peak memory reset, as a fresh process starts, and
    frees the card's cached memory after it, until None."""
    import gc
    import traceback

    import torch
    import torch.distributed as dist

    from repro_torch.core.comm import init_world
    from repro_torch.kernels import launch_counts

    try:
        world = init_world(device, store=store, rank=rank, size=size)
        card = world.device.type == "cuda"
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            launch_counts.clear()
            if card:
                torch.cuda.reset_peak_memory_stats()
            out = fn(world, *args)
            del task, args
            gc.collect()
            if card:
                torch.cuda.empty_cache()
            results.put((rank, True, out))
    except BaseException:   # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _RankPool:
    """Four rank processes on the card, joined once, that run the 4-rank
    phases' rank functions one after another (`run`), where each phase
    would start four processes of its own (`core.comm.spawn_world`): the
    imports, the CUDA start-up and the world's join, ~15 s a phase on the
    card's host, come once.  Entered by `main` around those phases
    (`_ranks` then runs on it); a phase run alone (scripts/chip_ab.py)
    opens one for its call.  A rank that fails or outlives a task's time
    fails the run, and every rank is stopped."""

    def __init__(self, size: int = 4, device: str = "cuda"):
        self.size, self.device = size, device

    def __enter__(self):
        import multiprocessing as mp
        import os
        import tempfile

        global _POOL
        # what the large phases ask of the allocator, set before the
        # ranks start it
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory()
        store = os.path.join(self._tmp.name, "store")
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(self.size)]
        self.procs = [ctx.Process(target=_pool_rank, daemon=True, args=(
            r, self.size, store, self.device, self.tasks[r], self.results))
            for r in range(self.size)]
        for p in self.procs:
            p.start()
        _POOL = self
        return self

    def run(self, fn, *args, timeout_s: float) -> list:
        """``fn(world, *args)`` on every rank: each rank's result in rank
        order, as `spawn_world` returns them."""
        import queue

        for q in self.tasks:
            q.put((fn, args))
        got, failure = {}, None
        deadline = time.monotonic() + timeout_s
        while len(got) < self.size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"ranks {sorted(set(range(self.size)) - set(got))}"
                           f" still running after {timeout_s:.0f} s")
                break
            try:
                rank, ok, out = self.results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    failure = (f"rank {dead[0]} exited with "
                               f"{self.procs[dead[0]].exitcode}")
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
        if failure is not None:
            self._stop(kill=True)
            raise RuntimeError(f"rank pool, {getattr(fn, '__name__', fn)}: "
                               f"{failure}")
        return [got[r] for r in range(self.size)]

    def _stop(self, kill: bool) -> None:
        global _POOL
        _POOL = None
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive() and not kill:
                q.put(None)
        for p in self.procs:
            p.join(timeout=0 if kill else 60)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()

    def __exit__(self, *exc):
        if _POOL is self:
            self._stop(kill=exc[0] is not None)
        return False


def _ranks(fn, *args, timeout_s: float) -> list:
    """``fn(world, *args)`` on 4 ranks sharing the card, on `main`'s
    `_RankPool`, or on a pool of its own opened for this call when none
    is open (a phase run alone): one way to start ranks either way."""
    if _POOL is not None:
        return _POOL.run(fn, *args, timeout_s=timeout_s)
    with _RankPool() as pool:
        return pool.run(fn, *args, timeout_s=timeout_s)


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _traced(fn, names, reps: int) -> list:
    """The profiler's CUDA events, over `reps` calls of `fn`, of the
    kernels whose names contain one of `names`.  A trace with no such
    kernel, or whose count of them is not a whole multiple of `reps`, has
    lost events, and is taken again (up to 3 times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if any(n in e.key for n in names)]
        count = sum(e.count for e in hits)
        if count and count % reps == 0:
            break
    return hits


def _device_ms(fn, names, reps: int = 10):
    """Device time per call of the kernels whose names contain one of
    `names`, from the profiler's CUDA trace (`_traced`): the card's own
    time, without the host's launch overhead; None when the trace holds
    none."""
    us = sum(getattr(e, "device_time_total", 0.0)
             for e in _traced(fn, names, reps))
    return us / reps / 1e3 if us > 0 else None


def _bound_ms(bsz: int, n: int, u: int) -> tuple:
    """Least time for one slice step: own and relay read once and written
    once, plus dst and the totals, over the memory rate; against the
    float32 operations at most u slots per element can need (the time of
    the operations stays below that of the bytes)."""
    nbytes = 16 * bsz * n * n + 4 * n * u + 8 * bsz
    ops = bsz * n * n * (6 + 2 * u)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _topology(dp):
    from repro_torch.core.topology import (
        build_lifted_opera_topology,
        build_opera_topology,
    )
    from repro_torch.netsim.sweep import LIFTED_TOPO_RACKS

    cfg = dp.to_config()
    build = (build_lifted_opera_topology if cfg.num_racks > LIFTED_TOPO_RACKS
             else build_opera_topology)
    return build(cfg.num_racks, cfg.u, seed=dp.topo_seed, groups=cfg.groups)


def _ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in nvcc's ``-Xptxas -v``
    report, by name (``flash_fwd_wgmma<128>`` for a template)."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out[name] = dict(spill_bytes=int(m.group(1)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
    return out


def _kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled function, with its template
    arguments: ``_ZN..._15flash_fwd_wgmmaILi128EEEv...`` is
    ``flash_fwd_wgmma<128>``, ``..._15moe_gmm_gate_upI13__nv_bfloat16Li4ELb1EEEv...``
    ``moe_gmm_gate_up<__nv_bfloat16, 4, 1>``."""
    import re

    # subs: the names a substitution (S_, S0_, S1_, ...) may stand for,
    # in their order: the name's components, then its type arguments
    pos, name, subs = 3 if mangled.startswith("_ZN") else 2, mangled, []
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group(0)
        name = mangled[pos + len(n):pos + len(n) + int(n)]
        subs.append(name)
        pos += len(n) + int(n)
    if not mangled.startswith("I", pos):
        return name
    args, pos = [], pos + 1
    while pos < len(mangled) and mangled[pos] != "E":
        lit = re.match(r"L[a-z](n?\d+)E", mangled[pos:])
        src = re.match(r"(\d+)", mangled[pos:])
        sub = re.match(r"S([0-9A-Z]*)_", mangled[pos:])
        if lit:
            args.append(lit.group(1).replace("n", "-"))
            pos += lit.end()
        elif src:
            n = int(src.group(1))
            args.append(mangled[pos + src.end():pos + src.end() + n])
            subs.append(args[-1])
            pos += src.end() + n
        elif sub:
            i = int(sub.group(1), 36) + 1 if sub.group(1) else 0
            args.append(subs[i] if i < len(subs) else sub.group(0))
            pos += sub.end()
        else:
            args.append({"f": "float", "i": "int"}.get(mangled[pos],
                                                       mangled[pos]))
            pos += 1
    return f"{name}<{', '.join(args)}>"


def _hgmma(lib: Path) -> int:
    """Tensor-core (HGMMA) instructions in a library's SASS."""
    from repro_torch.kernels import cuda_tool

    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sum("HGMMA" in ln for ln in sass.splitlines())


# the moe_gmm backward's bf16 kernels (csrc/moe_gmm_bwd.cu) by ptxas name:
# the activation pass in silu's, gelu's and relu's instantiations
GMM_BWD_WGMMA_KERNELS = ("moe_bwd_act_wgmma<0>", "moe_bwd_act_wgmma<1>",
                         "moe_bwd_act_wgmma<2>", "moe_bwd_wgrad_wgmma<1>",
                         "moe_bwd_wgrad_wgmma<2>", "moe_bwd_dh_wgmma",
                         "wgmma_probe_products")


def phase_build() -> dict:
    """One nvcc per kernel source, all started together; each kernel's
    registers and spills; the tensor-core (HGMMA) instructions of the
    flash library, the flash backward's and the moe_gmm backward's,
    counted in their SASS, and no spill in their bf16 (wgmma) kernels."""
    from repro_torch.kernels import build_libraries, library_path
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.mamba_scan import kernel as mamba
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.rglru_scan import kernel as rglru
    from repro_torch.kernels.rotor_slice import kernel as rotor

    mods = (rotor, flash, gmm, mamba, rglru)
    bwd_mods = (flash, gmm, mamba, rglru)
    specs = [("rotor_slice", [rotor.SOURCE])] + [
        (m.NAME, [m.SOURCE]) for m in mods[1:]] + [
        (m.BWD_NAME, [m.BWD_SOURCE]) for m in bwd_mods]
    t0 = time.perf_counter()
    build_libraries(specs)
    for mod in mods:
        mod.library()
    for mod in bwd_mods:
        mod.bwd_library()
    out = dict(phase="build", seconds=time.perf_counter() - t0)
    for name, sources in specs:
        log = library_path(name, sources).with_suffix(".log")
        out[f"ptxas_{name}"] = (_ptxas_report(log.read_text())
                                if log.exists() else {})
    wgmma = {k: v for k, v in out["ptxas_flash_attention"].items()
             if k.startswith("flash_fwd_wgmma")}
    _check(len(wgmma) == len(flash.WGMMA_HEAD_DIMS),
           f"flash bf16 instantiations {sorted(wgmma)}")
    _check(all(v["spill_bytes"] == 0 for v in wgmma.values()),
           f"flash bf16 kernel spills: {wgmma}")
    f32 = [k for k in out["ptxas_flash_attention"]
           if k.startswith("flash_fwd_f32")]
    _check(len(f32) == len(flash.HEAD_DIMS),
           f"flash f32 instantiations {sorted(f32)}")
    # the backward: bf16 on wgmma (dK/dV and dQ each, hd 16-256), f32 at
    # every hd on the CUDA cores, D in both types, and the sum of the
    # hd-256 dK/dV pass's parts
    bwd = out[f"ptxas_{flash.BWD_NAME}"]
    bwd_wgmma = {k: v for k, v in bwd.items()
                 if k.startswith(("flash_bwd_dkdv_wgmma<",
                                  "flash_bwd_dq_wgmma<"))}
    _check(len(bwd_wgmma) == 2 * len(flash.BWD_WGMMA_HEAD_DIMS),
           f"flash backward wgmma instantiations {sorted(bwd_wgmma)}")
    _check(all(v["spill_bytes"] == 0 for v in bwd_wgmma.values()),
           f"flash backward wgmma kernels spill: {bwd_wgmma}")
    cores = [k for k in bwd if k.startswith(("flash_bwd_dkdv<",
                                             "flash_bwd_dq<"))]
    _check(len(cores) == 2 * len(flash.BWD_HEAD_DIMS),
           f"flash backward CUDA-core instantiations {sorted(cores)}")
    _check(len([k for k in bwd if k.startswith("flash_bwd_dsum<")]) == 2,
           f"flash backward D instantiations {sorted(bwd)}")
    _check("flash_bwd_kv_reduce" in bwd,
           f"flash backward sum of parts missing: {sorted(bwd)}")
    # the moe_gmm backward: bf16 on wgmma (four kernels, the activation
    # pass in three instantiations, and the probe)
    gmm_wgmma = {k: v for k, v in out[f"ptxas_{gmm.BWD_NAME}"].items()
                 if "wgmma" in k}
    _check(sorted(gmm_wgmma) == sorted(GMM_BWD_WGMMA_KERNELS),
           f"moe_gmm backward wgmma kernels {sorted(gmm_wgmma)}")
    _check(all(v["spill_bytes"] == 0 for v in gmm_wgmma.values()),
           f"moe_gmm backward wgmma kernels spill: {gmm_wgmma}")
    for name, src in ((flash.NAME, flash.SOURCE),
                      (flash.BWD_NAME, flash.BWD_SOURCE),
                      (gmm.BWD_NAME, gmm.BWD_SOURCE)):
        out[f"{name}_hgmma"] = hgmma = _hgmma(library_path(name, [src]))
        print(f"{name} HGMMA instructions: {hgmma}", flush=True)
        _check(hgmma > 0, f"the {name} library holds no HGMMA")
    scans = {k: v for name in (mamba.NAME, rglru.NAME, mamba.BWD_NAME,
                               rglru.BWD_NAME)
             for k, v in out[f"ptxas_{name}"].items()}
    _check(len(scans) > 0
           and all(v["spill_bytes"] == 0 for v in scans.values()),
           f"scan kernels spill: {scans}")
    return out


def phase_kernel(cases) -> dict:
    """Each case (design, topology, B, state): "random" draws own in
    [0, 2) and relay in [0, 1); "worst_case" halves that own (below 1)
    and zeroes relay, so every partner keeps room and every live slot
    adds to pass B's gather."""
    import numpy as np
    import torch

    from repro_torch.kernels.rotor_slice.kernel import (
        rotor_slice_fwd,
        strip_width,
    )
    from repro_torch.kernels.rotor_slice.ref import rotor_slice_ref

    rows = []
    for name, topo, bsz, state in cases:
        n, u = topo.num_racks, topo.num_switches
        dst = torch.as_tensor(topo.matching_index_tensor()[1], device="cuda")
        rng = np.random.default_rng(n)
        own = rng.uniform(0.0, 2.0, (bsz, n, n)).astype(np.float32)
        relay = rng.uniform(0.0, 1.0, (bsz, n, n)).astype(np.float32)
        for a in (own, relay):
            a[:, np.arange(n), np.arange(n)] = 0.0
        own = torch.from_numpy(own).cuda()
        relay = torch.from_numpy(relay).cuda()
        if state == "worst_case":
            own, relay = own * 0.5, torch.zeros_like(relay)
        for vlb in (False, True):
            got = rotor_slice_fwd(own, relay, dst, vlb)
            ref = rotor_slice_ref(own, relay, dst, vlb)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2]))
            tot = max(float(((g - r).abs() / r.abs().clamp(min=1e-30)).max())
                      for g, r in zip(got[2:], ref[2:]) if float(r.abs().max()) > 0)
            _check(err <= 1e-5, f"{name} {state} vlb={vlb} state err {err}")
            _check(tot <= 1e-5, f"{name} {state} vlb={vlb} totals rel err {tot}")
            again = rotor_slice_fwd(own, relay, dst, vlb)
            _check(all(torch.equal(a, b) for a, b in zip(got, again)),
                   f"{name} {state} vlb={vlb} not deterministic")
            big = n >= 512
            fn = lambda: rotor_slice_fwd(own, relay, dst, vlb)  # noqa: E731
            ms = _cuda_ms(fn, reps=20 if big else 200)
            plain_ms = _cuda_ms(lambda: rotor_slice_ref(own, relay, dst, vlb),
                                reps=3 if big else 20, warmup=1)
            device_ms, rows_ms, cols_ms = (
                _device_ms(fn, names) for names in (
                    ("rotor_rows", "rotor_cols"), ("rotor_rows",),
                    ("rotor_cols",)))
            bound_ms, bound_by = _bound_ms(bsz, n, u)
            # the design's bytes: with vlb pass B reads own's strips again
            design_bytes = (20 if vlb else 16) * bsz * n * n
            rows.append(dict(design=name, state=state, B=bsz, N=n, u=u,
                             vlb=vlb, strip=strip_width(n),
                             max_abs_err=err, totals_rel_err=tot, ms=ms,
                             device_ms=device_ms, rows_device_ms=rows_ms,
                             cols_device_ms=cols_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_share=(bound_ms / device_ms
                                          if device_ms else None),
                             design_bytes=design_bytes,
                             design_ms=design_bytes / HBM_BYTES_PER_S * 1e3))
        del own, relay
        torch.cuda.empty_cache()
    return dict(phase="kernel", rows=rows)


def phase_fig08(root: Path) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.opera_paper import OPERA_648
    from repro_torch.core.topology import topology_from_arrays
    from repro_torch.kernels import launch_counts
    from repro_torch.netsim.fluid_torch import simulate_rotor_bulk_torch
    from repro_torch.netsim.workloads import demand_all_to_all

    data = root / "src" / "repro_torch" / "data"
    topo = topology_from_arrays(
        108, 6, np.load(data / "fig08_k12_n108_g1_seed0.npy"), groups=1)
    want = json.loads((data / "fig08_expected.json").read_text())
    demand = demand_all_to_all(108, 6, 100e3)
    cycles = want["max_cycles"]
    out = dict(phase="fig08", expected={k: want[k] for k in (
        "fct_99_ms", "fct_mean_ms", "throughput_gbps", "bandwidth_tax")})
    for engine in ("dense", "sparse"):
        simulate_rotor_bulk_torch(OPERA_648, demand, vlb=False, max_cycles=1,
                                  topo=topo, engine=engine)
        torch.cuda.synchronize()
        launch_counts.clear()
        t0 = time.perf_counter()
        res = simulate_rotor_bulk_torch(
            OPERA_648, demand, vlb=False, max_cycles=cycles, topo=topo,
            engine=engine)
        wall = time.perf_counter() - t0
        launches = launch_counts["rotor_slice"]
        steps = cycles * topo.num_slices
        _check(res.slices_run == want["slices_run"],
               f"fig08 {engine} slices_run {res.slices_run}")
        for k in out["expected"]:
            got = getattr(res, k)
            _check(bool(np.isclose(got, want[k], rtol=1e-4,
                                   atol=1e-4 if k == "bandwidth_tax" else 0.0)),
                   f"fig08 {engine} {k} {got} != {want[k]}")
        _check(launches == (steps if engine == "sparse" else 0),
               f"fig08 {engine} launches {launches}")
        out[engine] = dict(fct_99_ms=res.fct_99_ms, fct_mean_ms=res.fct_mean_ms,
                           throughput_gbps=res.throughput_gbps,
                           bandwidth_tax=res.bandwidth_tax,
                           slices_run=res.slices_run, wall_s=wall,
                           ms_per_slice=wall / steps * 1e3,
                           rotor_slice_launches=launches)
    return out


def phase_sweep(topo) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.schedule import slice_capacity_bytes
    from repro_torch.kernels import launch_counts
    from repro_torch.netsim import sweep
    from repro_torch.netsim.fluid_torch import _run_batch_sparse

    dp = sweep.DesignPoint(k=64, num_racks=1024, groups=4)
    spec = sweep.SweepSpec(designs=(dp,), workloads=sweep.WORKLOADS,
                           loads=(0.1, 0.3), seeds=(0, 1),
                           max_cycles=SWEEP_CYCLES, engine="sparse")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    t0 = time.perf_counter()
    rows, res = sweep.run_design(spec, dp)
    wall = time.perf_counter() - t0
    launches = launch_counts["rotor_slice"]
    peak = torch.cuda.max_memory_allocated()
    steps = SWEEP_CYCLES * topo.num_slices
    _check(res.batch_size == 16, f"batch {res.batch_size}")
    _check(launches == steps, f"launches {launches} != {steps}")
    fin = res.finished_frac[:, -1]
    _check(bool((fin >= 0.99999).all()), f"rows not drained: {fin.tolist()}")
    end = fin * res.total_bytes
    _check(bool(np.allclose(end + res.residual_bytes, res.total_bytes,
                            rtol=1e-5)), "bytes not conserved")
    _check(bool(np.isfinite(res.fct_99_ms).all()), "non-finite fct99")

    # the slice loop alone, on the same inputs already on the card
    cfg = dp.to_config()
    demands = _sweep_demands(spec, cfg)
    own0 = torch.as_tensor(demands / slice_capacity_bytes(cfg),
                           dtype=torch.float32, device="cuda")
    dst = torch.as_tensor(topo.matching_index_tensor(), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run_batch_sparse(dst, own0, spec.vlb, SWEEP_CYCLES)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    # the kernel's own device time in the loop, on this run's states
    rotor_ms = _device_ms(
        lambda: _run_batch_sparse(dst, own0, spec.vlb, SWEEP_CYCLES),
        ("rotor_rows", "rotor_cols"), reps=1)
    return dict(
        phase="sweep", design=dp.name, scenarios=res.batch_size,
        max_cycles=SWEEP_CYCLES, slices=steps, run_design_wall_s=wall,
        slice_loop_s=engine_s, ms_per_slice=engine_s / steps * 1e3,
        rotor_device_ms_per_slice=rotor_ms / steps if rotor_ms else None,
        rotor_slice_launches=launches, peak_bytes=peak,
        slices_run_max=int(res.slices_run.max()),
        finished_frac_min=float(fin.min()),
        fct_99_ms=[r["fct_99_ms"] for r in rows],
        bandwidth_tax=[r["bandwidth_tax"] for r in rows],
        workloads=[f'{r["workload"]}@{r["load"]}/s{r["seed"]}' for r in rows])


def phase_crossover(topos: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.netsim.fluid_torch import _run_batch, _run_batch_sparse

    bsz, steps = 16, 32
    rows = []
    for name, topo in topos.items():
        n = topo.num_racks
        rng = np.random.default_rng(0)
        own0 = torch.as_tensor(rng.uniform(0, 2, (bsz, n, n)),
                               dtype=torch.float32, device="cuda")
        dst = torch.as_tensor(topo.matching_index_tensor()[:steps], device="cuda")
        adj = torch.as_tensor(
            np.stack([topo.adjacency(t) for t in range(steps)]),
            dtype=torch.float32, device="cuda")
        row = dict(design=name, N=n, B=bsz)
        for engine, run, tensor in (("dense", _run_batch, adj),
                                    ("sparse", _run_batch_sparse, dst)):
            ms = _cuda_ms(lambda: run(tensor, own0, True, 1), reps=3, warmup=1)
            row[f"{engine}_ms_per_slice"] = ms / tensor.shape[0]
        rows.append(row)
        del own0, dst, adj
        torch.cuda.empty_cache()
    return dict(phase="crossover", vlb=True, rows=rows)



# ---------------- Fig. 11: fault injection and the flow engine ------------

FIG11_LOAD, FIG11_PACED, FIG11_LAG = 0.4, 12, 3   # fig11_faults.py:34-36
FIG11_FLOWS = dict(num_hosts=216, horizon_s=0.4, dt_s=2e-4, tail_s=0.2,
                   seed=0)
FLOW_P99S = ("fct_p99_ms_small", "fct_p99_ms_mid", "fct_p99_ms_large")


def _fig11_schedules(topo):
    """benchmarks/fig11_faults.py:42-63 in full mode: the baseline, then
    links, ToRs (recovering inside the paced window) and switches."""
    from repro_torch.netsim.faults import FailureSchedule

    S = topo.num_slices
    kw = dict(onset_step=2 * S, detect_lag=FIG11_LAG)
    rows = [("baseline", FailureSchedule.empty(topo))]
    rows += [(f"links {f:.2f}", FailureSchedule.draw(
        topo, seed=11, link_frac=f, **kw)) for f in (0.02, 0.04, 0.08)]
    rows += [(f"tors {f:.2f}", FailureSchedule.draw(
        topo, seed=13, tor_frac=f, recover_step=(FIG11_PACED - 2) * S, **kw))
        for f in (0.05, 0.07, 0.12)]
    rows += [(f"switches {k}/6", FailureSchedule.draw(
        topo, seed=17, switch_count=k, **kw)) for k in (1, 2, 3)]
    return rows


def _fig11_flow_scenarios(topo):
    """benchmarks/fig11_faults.py:96-117: one Websearch scenario and its
    three fault projections."""
    from repro_torch.netsim.faults import FailureSchedule, apply_flow_faults
    from repro_torch.netsim.flows import build_scenario

    scn = build_scenario("opera", "websearch", 0.25, **FIG11_FLOWS)
    lag = dict(onset_step=300, detect_lag=3)
    draws = [("clean", None),
             ("links 0.04", FailureSchedule.draw(
                 topo, seed=11, link_frac=0.04, **lag)),
             ("tors 0.07", FailureSchedule.draw(
                 topo, seed=13, tor_frac=0.07, recover_step=1500, **lag)),
             ("switches 2/6", FailureSchedule.draw(
                 topo, seed=17, switch_count=2, **lag))]
    return [(label, scn if s is None else apply_flow_faults(scn, s))
            for label, s in draws]


def _launch_profile(fn, steps: int) -> tuple:
    """Kernels (and copies) that `fn`, a run of `steps` steps, launches a
    step, and their device ms a step, from the profiler's CUDA trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in dev)
    us = sum(e.self_device_time_total for e in dev)
    return launches / steps, us / steps / 1e3


def _timed(fn):
    """(result, host seconds ending in synchronize, peak device bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _within_one_bin(a: float, b: float) -> bool:
    import numpy as np

    from repro_torch.netsim.flows import FCT_BIN_LOG2_WIDTH

    if not (np.isfinite(a) and np.isfinite(b)):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return abs(float(np.log2(a / b))) <= FCT_BIN_LOG2_WIDTH * (1 + 1e-9)


def _fig11_fluid(topo, want, engine: str) -> dict:
    """One batched call over the ten rows, held to the stored rows, then
    the slice loop alone on the same operands."""
    import numpy as np
    import torch

    from repro_torch.core.schedule import cycle_timing, slice_capacity_bytes
    from repro_torch.kernels import launch_counts
    from repro_torch.netsim import fluid_torch
    from repro_torch.netsim.sweep import DesignPoint

    cfg = DesignPoint(k=12, num_racks=108).to_config()
    cap = slice_capacity_bytes(cfg, cycle_timing(cfg))
    rows = _fig11_schedules(topo)
    labels = [label for label, _ in rows]
    scheds = [s for _, s in rows]
    S, cycles = topo.num_slices, FIG11_PACED + 2
    d = np.full((108, 108), FIG11_LOAD * (cfg.u - 1) * cap * FIG11_PACED)
    np.fill_diagonal(d, 0.0)
    demand = np.broadcast_to(d, (len(rows), 108, 108))
    run = lambda c: fluid_torch.simulate_rotor_bulk_batch(  # noqa: E731
        cfg, demand, topo=topo, max_cycles=c, faults=scheds,
        paced_cycles=FIG11_PACED, engine=engine)
    run(1)
    launch_counts.clear()
    res, wall, peak = _timed(lambda: run(cycles))
    _check(launch_counts["rotor_slice"] == 0,
           f"fig11 {engine}: the faulted step launched rotor_slice")
    T = (FIG11_PACED + 1) * S - 1
    base = float(res.finished_frac[0, T])
    got, err = {}, dict(retention=0.0, blackholed_frac=0.0, residual_frac=0.0)
    for i, label in enumerate(labels):
        g = dict(retention=float(res.finished_frac[i, T]) / base,
                 blackholed_frac=float(res.blackholed_bytes[i]
                                       / res.total_bytes[i]),
                 residual_frac=float(res.residual_bytes[i]
                                     / res.total_bytes[i]))
        w = want[label]
        _check(bool(np.isclose(g["retention"], w["retention"], rtol=1e-4)),
               f"fig11 {engine} {label} retention {g['retention']} "
               f"!= {w['retention']}")
        for k in ("blackholed_frac", "residual_frac"):
            _check(abs(g[k] - w[k]) <= 1e-6,
                   f"fig11 {engine} {label} {k} {g[k]} != {w[k]}")
        err["retention"] = max(err["retention"],
                               abs(g["retention"] / w["retention"] - 1))
        for k in ("blackholed_frac", "residual_frac"):
            err[k] = max(err[k], abs(g[k] - w[k]))
        got[label] = g
    sw2 = got["switches 2/6"]["retention"]
    _check(got["links 0.04"]["retention"] >= 0.90 and sw2 >= 0.90,
           "fig11: more than 10 % throughput lost at 4 % links or 2/6 "
           "switches")
    _check(got["switches 3/6"]["retention"] < sw2 - 0.05,
           "fig11: 3/6 switches does not degrade visibly")

    # the slice loop alone, on the same operands already on the card
    dev = torch.device("cuda")
    masks, tl, pair_sw = fluid_torch.fault_operands(topo, scheds, len(rows),
                                                    dev)
    own0 = torch.as_tensor(demand / cap, dtype=torch.float32, device=dev)
    if engine == "dense":
        adj = torch.as_tensor(topo.matching_tensor(), device=dev)
        sw = torch.as_tensor(masks.switch_id, device=dev).long()
        loop = lambda c: fluid_torch._run_batch_faulted(  # noqa: E731
            adj, sw, pair_sw, own0, tl, True, c, FIG11_PACED)
    else:
        dst = torch.as_tensor(topo.matching_index_tensor(), device=dev)
        loop = lambda c: fluid_torch._run_batch_sparse_faulted(  # noqa: E731
            dst, pair_sw, own0, tl, True, c, FIG11_PACED)
    _, loop_s, loop_peak = _timed(lambda: loop(cycles))
    launches, dev_ms = _launch_profile(lambda: loop(1), S)
    return dict(rows=got, max_err=err, wall_s=wall, peak_bytes=peak,
                slice_loop_s=loop_s,
                ms_per_slice=loop_s / (cycles * S) * 1e3,
                launches_per_slice=launches, device_ms_per_slice=dev_ms,
                loop_peak_bytes=loop_peak)


def _hold_fig11_flow_rows(scns, batch, want, tag: str,
                          streamed: bool = False) -> dict:
    """Each flow row against the stored one at tests/test_flows_jax.py's
    tolerances, histogram class totals equal and each class's p50 and
    p99 within one bin.  A `streamed` (tiled) run's p99s are histogram
    quantiles, held within one bin of the stored exact ones
    (tests/test_flows_tiled.py), its empty-class sentinels exactly."""
    import numpy as np

    from repro_torch.netsim.flows import hist_percentile

    out = {}
    for (label, scn), r, h in zip(scns, batch.results, batch.hists):
        w = want[label]
        _check(bool(r.admitted) == w["admitted"], f"{tag} {label} admitted")
        _check(abs(r.finished_frac - w["finished_frac"]) <= 1e-6,
               f"{tag} {label} finished_frac {r.finished_frac}")
        _check(abs(r.backlog_frac - w["backlog_frac"]) <= 1e-4,
               f"{tag} {label} backlog_frac {r.backlog_frac}")
        for f in FLOW_P99S + ("fct_mean_ms",):
            a, b = getattr(r, f), w[f]
            if streamed and f in FLOW_P99S:
                ok = a == b if 0.0 in (a, b) else _within_one_bin(a, b)
            else:
                ok = a == b or bool(np.isclose(a, b, rtol=1e-3, atol=1e-3))
            _check(ok, f"{tag} {label} {f} {a} != {b}")
        wh = np.asarray(w["hist"])
        _check(bool((h.sum(1) == wh.sum(1)).all()),
               f"{tag} {label} class totals {h.sum(1)} != {wh.sum(1)}")
        for c in range(h.shape[0]):
            for q in (50.0, 99.0):
                a, b = hist_percentile(h[c], q), hist_percentile(wh[c], q)
                _check(_within_one_bin(a, b),
                       f"{tag} {label} class {c} p{q:g} {a} vs {b}")
        out[label] = dict(flows=scn.num_flows, admitted=bool(r.admitted),
                          finished_frac=r.finished_frac,
                          backlog_frac=r.backlog_frac,
                          fct_p99_ms_small=r.fct_p99_ms_small,
                          fct_mean_ms=r.fct_mean_ms,
                          hist_bins_differing=int((h != wh).sum()))
    return out


def _fig11_flows(topo, want) -> dict:
    import torch

    from repro_torch.netsim import flows_torch

    scns = _fig11_flow_scenarios(topo)
    batch, wall, peak = _timed(lambda: flows_torch.simulate_flows_batch(
        [s for _, s in scns]))
    out = _hold_fig11_flow_rows(scns, batch, want, "fig11 flows")
    steps = scns[0][1].steps
    dev = torch.device("cuda")
    remaining0, ops, _ = flows_torch._stage(
        [s for _, s in scns], steps, max(s.num_flows for _, s in scns),
        torch.float32, dev)
    _, loop_s, loop_peak = _timed(
        lambda: flows_torch._run_batch(remaining0, ops, steps, False))
    launches, dev_ms = _launch_profile(
        lambda: flows_torch._run_batch(remaining0, ops, 100, False), 100)
    return dict(rows=out, steps=steps, wall_s=wall, peak_bytes=peak,
                flow_loop_s=loop_s, ms_per_step=loop_s / steps * 1e3,
                launches_per_step=launches, device_ms_per_step=dev_ms,
                loop_peak_bytes=loop_peak)


def phase_fig11(root: Path) -> dict:
    import numpy as np

    from repro_torch.core.topology import topology_from_arrays
    from repro_torch.kernels import launch_counts
    from repro_torch.netsim.faults import FailureSchedule
    from repro_torch.netsim.fluid_torch import simulate_rotor_bulk_batch
    from repro_torch.netsim.sweep import DesignPoint

    data = root / "src" / "repro_torch" / "data"
    topo = topology_from_arrays(
        108, 6, np.load(data / "fig11_k12_n108_seed1_sft2.npy"), groups=1)
    want = json.loads((data / "fig11_expected.json").read_text())
    out = dict(phase="fig11", design="k12-n108-g1 (seed 1, sft 2)", B=10,
               slices=(FIG11_PACED + 2) * topo.num_slices)
    for engine in ("dense", "sparse"):
        out[engine] = _fig11_fluid(topo, want["fluid"], engine)

    # an event-less schedule without pacing: the unfaulted kernel path
    cfg = DesignPoint(k=12, num_racks=108).to_config()
    demand = np.full((108, 108), 1e6)
    np.fill_diagonal(demand, 0.0)
    runs, cycles = [], 4
    for faults in (None, FailureSchedule.empty(topo)):
        launch_counts.clear()
        runs.append(simulate_rotor_bulk_batch(
            cfg, demand, topo=topo, max_cycles=cycles, faults=faults,
            engine="sparse"))
        _check(launch_counts["rotor_slice"] == cycles * topo.num_slices,
               f"empty schedule: {launch_counts['rotor_slice']} launches")
    for f in ("finished_frac", "wire_bytes", "goodput_bytes",
              "residual_bytes"):
        _check(bool(np.array_equal(getattr(runs[0], f), getattr(runs[1], f))),
               f"empty schedule changes {f}")
    out["empty_schedule_same_bits"] = True
    out["flows"] = _fig11_flows(topo, want["flows"])
    return out


# ---------------- the tiled flow engine: Figs. 9, 7, 11 and the crossover --

CROSSOVER_HORIZONS = (0.2, 0.8, 2.4)   # expander Websearch 0.2, 648 hosts


class _Batches:
    """Keep every `FlowBatchResult` that `flows_torch.simulate_flows_batch`
    returns while in use, so a run through `sweep.run_flow_sweep` shows
    its engine (the tiled one reports its window) and its histograms."""

    def __enter__(self):
        from repro_torch.netsim import flows_torch

        self.seen, self._orig = [], flows_torch.simulate_flows_batch

        def keep(*args, **kw):
            out = self._orig(*args, **kw)
            self.seen.append(out)
            return out

        flows_torch.simulate_flows_batch = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.netsim import flows_torch

        flows_torch.simulate_flows_batch = self._orig


def _flow_run(fn, steps: int, profiled: bool = True) -> dict:
    """`fn` (one engine call) timed on the host clock with its peak
    device memory, then, if `profiled`, run again under the profiler for
    its launches and device ms a step (kernels and copies), summed from
    the trace's raw device events (a run holds up to ~1.2 M of them:
    `key_averages` would take minutes)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out, wall, peak = _timed(fn)
    run = dict(result=out, wall_s=wall, ms_per_step=wall / steps * 1e3,
               peak_bytes=peak)
    if profiled:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        run.update(launches_per_step=len(dev) / steps,
                   device_ms_per_step=sum(e.duration_ns() for e in dev)
                   / steps / 1e6,
                   profile_s=time.perf_counter() - t0)
    return run


def _hold_flow_rows(got, hists, want, tag: str) -> dict:
    """tests/test_flows_tiled.py:71-91's tolerances: every histogram bin
    equal, admitted and finished_frac equal, backlog_frac within 1e-5,
    each p99 within one bin (sentinels equal)."""
    import numpy as np

    exact = dict(backlog=0, mean=0)
    for g, h, w in zip(got, hists, want):
        where = f"{tag} {g['network']} {g['load']} seed {g['seed']}"
        _check(bool(np.array_equal(h, np.asarray(w["hist"]))),
               f"{where}: histograms differ in {int((h != w['hist']).sum())} "
               "bins")
        _check(g["admitted"] == w["admitted"], f"{where}: admitted")
        _check(g["finished_frac"] == w["finished_frac"],
               f"{where}: finished_frac {g['finished_frac']} "
               f"!= {w['finished_frac']}")
        _check(abs(g["backlog_frac"] - w["backlog_frac"]) < 1e-5,
               f"{where}: backlog_frac {g['backlog_frac']} "
               f"!= {w['backlog_frac']}")
        for f in FLOW_P99S:
            a, b = g[f], w[f]
            _check(a == b if 0.0 in (a, b) else _within_one_bin(a, b),
                   f"{where}: {f} {a} vs {b}")
        exact["backlog"] += bool(g["backlog_frac"] == w["backlog_frac"])
        exact["mean"] += bool(g["fct_mean_ms"] == w["fct_mean_ms"])
    return dict(rows=len(got), backlog_frac_equal=exact["backlog"],
                fct_mean_equal=exact["mean"],
                backlog_frac_max_diff=max(abs(g["backlog_frac"]
                                              - w["backlog_frac"])
                                          for g, w in zip(got, want)))


def _fig09_checks(rows) -> dict:
    """benchmarks/fig09_websearch.py:45-51 on rows of the grid."""
    from repro_torch.netsim.sweep import summarize

    mean = summarize(rows, by=("network", "load"),
                     stats=("fct_p99_ms_small", "admitted"))
    net = {n: [r for r in mean if r["network"] == n]
           for n in ("opera", "expander")}
    return dict(
        opera10=net["opera"][2]["admitted"] > 0.5
        and net["opera"][3]["admitted"] < 0.5,
        statics25=net["expander"][3]["admitted"] > 0.5,
        low_load_equal=abs(net["opera"][0]["fct_p99_ms_small"]
                           - net["expander"][0]["fct_p99_ms_small"]) < 5.0)


def _grid_sweep(name: str, engine: str, want, profiled: bool):
    """One stored grid through `run_flow_sweep` (its seconds: scenarios
    built, run and finalized), held to the stored rows; then the engine
    alone on the grid's scenarios, which must give the same bits."""
    import numpy as np

    from repro_torch.netsim import flows_torch
    from repro_torch.netsim.flows import build_scenario
    from repro_torch.netsim.sweep import FlowSweepSpec, run_flow_sweep

    # the grid as the stored run ran it (tests/test_torch_flows_tiled.py
    # holds the stored spec to benchmarks/fig09_websearch.py's and
    # benchmarks/fig07_datamining.py's)
    spec = FlowSweepSpec(*(tuple(want[k]) for k in (
        "networks", "workloads", "loads", "seeds")), engine=engine)
    sim_kw, steps = want["sim_kw"], want["steps"]
    with _Batches() as seen:
        rows, grid_s, _ = _timed(lambda: run_flow_sweep(spec, **sim_kw))
    batch = seen.seen[0]
    _check(len(rows) == len(want["rows"]), f"{name}: {len(rows)} rows")
    for r, w in zip(rows, want["rows"]):
        _check((r["network"], r["load"], r["seed"])
               == (w["network"], w["load"], w["seed"]), f"{name}: grid order")
    n_max = max(w["flows"] for w in want["rows"])
    resolved = ("tiled" if batch.peak_window_tiles is not None else "dense")
    _check(resolved == flows_torch.resolve_flow_engine(engine, n_max),
           f"{name}: {engine} ran the {resolved} engine")
    held = _hold_flow_rows(rows, batch.hists, want["rows"], name)
    scns = [build_scenario(r["network"], r["workload"], r["load"],
                           seed=r["seed"], **sim_kw) for r in rows]
    _check([s.num_flows for s in scns] == [w["flows"] for w in want["rows"]],
           f"{name}: flow counts")
    run = _flow_run(lambda: flows_torch.simulate_flows_batch(
        scns, engine=resolved), steps, profiled)
    again = run.pop("result")
    _check(all(np.array_equal(a, b) for a, b in zip(again.hists, batch.hists))
           and again.results == batch.results,
           f"{name}: the engine alone differs from the sweep")
    return dict(engine=resolved, scenarios=len(rows), steps=steps,
                max_flows=n_max, peak_window_tiles=batch.peak_window_tiles,
                stored_peak_window_tiles=want["peak_window_tiles"],
                held=held, grid_s=grid_s, **run), rows, batch, scns


def _fig11_static(topo, data: Path, root: Path) -> dict:
    """benchmarks/fig11_faults.py:134-158 through the port's
    `to_failure_set`, `connectivity_loss` and `path_stretch`: full mode
    held to the JAX package's stored cross-check, fast mode also to
    results/benchmarks/fig11_faults.json's static block."""
    import numpy as np

    from repro_torch.core.routing import connectivity_loss, path_stretch
    from repro_torch.netsim.faults import FailureSchedule

    want = json.loads((data / "fig11_static_expected.json").read_text())
    fast_rows = ("links 0.04", "switches 2/6")
    out = {}
    for mode, stride in (("full", 4), ("fast", 8)):
        rows = [(label, s) for label, s in _fig11_schedules(topo)
                if not s.is_empty and (mode == "full" or label in fast_rows)]
        slices = range(0, topo.num_slices, stride)
        got = {label: connectivity_loss(topo, s.to_failure_set(), slices)
               for label, s in rows}
        base = path_stretch(topo, FailureSchedule.empty(topo).to_failure_set(),
                            list(slices)[:4])
        st = path_stretch(topo, rows[0][1].to_failure_set(), list(slices)[:4])
        got["stretch"] = dict(baseline_mean_path=base["mean_path"],
                              failed_mean_path=st["mean_path"])
        targets = [want[mode]]
        if mode == "fast":
            targets.append(json.loads((root / "results" / "benchmarks"
                                       / "fig11_faults.json").read_text())
                           ["static"])
        for target in targets:
            for label, row in got.items():
                for k, v in row.items():
                    _check(bool(np.isclose(v, target[label][k], rtol=1e-12,
                                           atol=1e-12)),
                           f"fig11 static {mode} {label} {k} {v} "
                           f"!= {target[label][k]}")
        out[mode] = got
    return out


def _flows_fig09(stored) -> dict:
    """Fig. 9 at 648 hosts, the slice's main path: auto -> tiled, then
    the dense engine on the same grid."""
    import numpy as np

    from repro_torch.kernels import launch_counts
    from repro_torch.netsim import flows_torch

    t0 = time.perf_counter()
    launch_counts.clear()
    tiled, rows, batch, scns = _grid_sweep("fig09_h648", "auto",
                                           stored["fig09_h648"], True)
    tiled["kernel_launches"] = dict(launch_counts)
    _check(tiled["engine"] == "tiled", "fig09_h648: auto did not run tiled")
    dense = _flow_run(lambda: flows_torch.simulate_flows_batch(
        scns, engine="dense"), tiled["steps"])
    dbatch = dense.pop("result")
    want_dense = [dict(network=s.network, load=s.load, seed=s.seed, hist=h,
                       **{f: getattr(r, f) for f in (
                           FLOW_P99S + ("admitted", "finished_frac",
                                        "backlog_frac", "fct_mean_ms"))})
                  for s, r, h in zip(scns, dbatch.results, dbatch.hists)]
    tiled["vs_dense"] = _hold_flow_rows(rows, batch.hists, want_dense,
                                        "fig09_h648 tiled vs dense")
    tiled["vs_dense"]["remaining_bytes_equal"] = sum(
        bool(np.array_equal(a, b)) for a, b in zip(batch.remaining_bytes,
                                                   dbatch.remaining_bytes))
    B = len(scns)
    tiled["tiled_state_bytes"] = flows_torch.tiled_state_bytes(
        tiled["peak_window_tiles"], flows_torch.DEFAULT_TILE, B)
    dense["dense_state_bytes"] = flows_torch.dense_state_bytes(
        tiled["max_flows"], B)
    tiled["dense"] = dense
    # Fig. 9's checks at 648 hosts: a check the JAX package's stored run
    # fails too is the reference's finding; the port must answer alike
    tiled["fig09_checks"] = _fig09_checks(rows)
    tiled["fig09_checks_stored"] = _fig09_checks(stored["fig09_h648"]["rows"])
    _check(tiled["fig09_checks"] == tiled["fig09_checks_stored"],
           f"fig09_h648 checks {tiled['fig09_checks']} != the stored run's")
    tiled["seconds"] = time.perf_counter() - t0
    return tiled


def _flows_fig11(data: Path, root: Path) -> dict:
    """Fig. 11's four faulted flow scenarios on the tiled engine, and its
    static cross-check."""
    import numpy as np

    from repro_torch.core.topology import topology_from_arrays
    from repro_torch.netsim import flows_torch

    t0 = time.perf_counter()
    topo = topology_from_arrays(
        108, 6, np.load(data / "fig11_k12_n108_seed1_sft2.npy"), groups=1)
    want = json.loads((data / "fig11_expected.json").read_text())["flows"]
    scns = _fig11_flow_scenarios(topo)
    run = _flow_run(lambda: flows_torch.simulate_flows_batch(
        [s for _, s in scns], engine="tiled"), scns[0][1].steps)
    batch = run.pop("result")
    return dict(rows=_hold_fig11_flow_rows(scns, batch, want, "fig11 tiled",
                                           streamed=True),
                peak_window_tiles=batch.peak_window_tiles, **run,
                static=_fig11_static(topo, data, root),
                seconds=time.perf_counter() - t0)


def _flows_crossover() -> dict:
    """Where the two engines cross on the card, one scenario a run."""
    import numpy as np

    from repro_torch.netsim import flows_torch
    from repro_torch.netsim.flows import build_scenario

    rows, t0 = [], time.perf_counter()
    for horizon in CROSSOVER_HORIZONS:
        scn = build_scenario("expander", "websearch", 0.2, num_hosts=648,
                             horizon_s=horizon, tail_s=0.3, seed=0)
        row, hists = dict(horizon_s=horizon, flows=scn.num_flows,
                          steps=scn.steps), []
        for engine in ("dense", "tiled"):
            r = _flow_run(lambda: flows_torch.simulate_flows_batch(
                [scn], engine=engine), scn.steps)
            res = r.pop("result")
            hists.append(res.hists[0])
            row[engine] = dict(r, peak_window_tiles=res.peak_window_tiles)
        _check(bool(np.array_equal(*hists)),
               f"crossover {horizon}: the engines' histograms differ")
        row["tiled_over_dense"] = (row["tiled"]["ms_per_step"]
                                   / row["dense"]["ms_per_step"])
        rows.append(row)
    return dict(rows=rows, seconds=time.perf_counter() - t0)


def phase_flows_tiled(root: Path) -> dict:
    data = root / "src" / "repro_torch" / "data"
    stored = json.loads((data / "flow_grids_expected.json").read_text())
    out = dict(phase="flows_tiled", fig09_h648=_flows_fig09(stored))
    t0 = time.perf_counter()
    out["fig07_tiled"] = dict(
        _grid_sweep("fig07", "tiled", stored["fig07"], False)[0],
        seconds=time.perf_counter() - t0)
    out["fig11_tiled"] = _flows_fig11(data, root)
    out["crossover_rows"] = _flows_crossover()
    return out


def _sweep_demands(spec, cfg):
    """The sweep's scenarios, workload-major, as `run_design` orders them."""
    import numpy as np

    from repro_torch.netsim import sweep

    return np.stack([sweep.scenario_demand(w, cfg, load, seed)
                     for w in spec.workloads for load in spec.loads
                     for seed in spec.seeds])


def phase_faulted_sparse_k64(topo, sweep_row: dict) -> dict:
    """The faulted sparse step (plain torch, no kernel) at the sweep's
    point and batch, beside the unfaulted kernel's ms a slice there."""
    import numpy as np
    import torch

    from repro_torch.core.schedule import slice_capacity_bytes
    from repro_torch.kernels import launch_counts
    from repro_torch.netsim import fluid_torch, sweep
    from repro_torch.netsim.faults import FailureSchedule

    dp = sweep.DesignPoint(k=64, num_racks=1024, groups=4)
    cfg = dp.to_config()
    spec = sweep.SweepSpec(designs=(dp,), workloads=sweep.WORKLOADS,
                           loads=(0.1, 0.3), seeds=(0, 1))
    demands = _sweep_demands(spec, cfg)
    sched = FailureSchedule.draw(topo, seed=0, link_frac=0.04,
                                 switch_count=2, onset_step=0)
    cycles, paced = SWEEP_CYCLES, 2
    launch_counts.clear()
    res, wall, peak = _timed(lambda: fluid_torch.simulate_rotor_bulk_batch(
        cfg, demands, topo=topo, max_cycles=cycles, faults=sched,
        paced_cycles=paced, engine="sparse"))
    _check(launch_counts["rotor_slice"] == 0,
           "faulted_sparse_k64: the faulted step launched rotor_slice")
    end = res.finished_frac[:, -1] * res.total_bytes
    _check(bool(np.allclose(end + res.residual_bytes, res.total_bytes,
                            rtol=1e-5, atol=0.0)),
           "faulted_sparse_k64: bytes not conserved")
    bh = res.blackholed_bytes
    _check(bool(np.isfinite(bh).all() and (bh >= 0).all() and bh.max() > 0),
           f"faulted_sparse_k64: blackholed {bh.tolist()}")

    dev = torch.device("cuda")
    _, tl, pair_sw = fluid_torch.fault_operands(topo, sched, len(demands), dev)
    own0 = torch.as_tensor(demands / slice_capacity_bytes(cfg),
                           dtype=torch.float32, device=dev)
    dst = torch.as_tensor(topo.matching_index_tensor(), device=dev)
    steps = cycles * topo.num_slices
    _, loop_s, loop_peak = _timed(
        lambda: fluid_torch._run_batch_sparse_faulted(
            dst, pair_sw, own0, tl, True, cycles, paced))
    launches, dev_ms = _launch_profile(
        lambda: fluid_torch._run_batch_sparse_faulted(
            dst[:16], pair_sw, own0, tl, True, 1, 1), 16)
    ms = loop_s / steps * 1e3
    return dict(
        phase="faulted_sparse_k64", design=dp.name, B=len(demands), vlb=True,
        events=[(e.kind, len(e.ids)) for e in sched.events],
        max_cycles=cycles, paced_cycles=paced, slices=steps, wall_s=wall,
        peak_bytes=peak, slice_loop_s=loop_s, ms_per_slice=ms,
        loop_peak_bytes=loop_peak, launches_per_slice=launches,
        device_ms_per_slice=dev_ms,
        unfaulted_kernel_ms_per_slice=sweep_row["ms_per_slice"],
        vs_unfaulted=ms / sweep_row["ms_per_slice"],
        blackholed_frac_max=float((bh / res.total_bytes).max()),
        finished_frac_min=float(res.finished_frac[:, -1].min()))

# ---------------- model kernels and serving (qwen3-moe-30b-a3b) -----------

FLASH_SWEEP = [  # B, Hq, Hkv, Sq, Sk, hd, causal, window (test_kernels.py)
    (1, 2, 2, 64, 64, 32, True, 0), (2, 4, 2, 64, 64, 64, True, 0),
    (1, 8, 1, 32, 32, 32, True, 0), (1, 2, 2, 64, 64, 32, False, 0),
    (1, 2, 1, 64, 64, 32, True, 24), (1, 2, 2, 32, 96, 32, True, 0),
    (1, 3, 1, 48, 48, 16, True, 0),
]
GMM_SWEEP = [(2, 16, 16, 32), (4, 8, 32, 64), (3, 12, 8, 24)]  # E, C, D, F


def _tol(dtype) -> float:
    """tests/test_kernels.py:15-18: atol = rtol."""
    import torch

    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _held(got, want, dtype, what: str, tol=None) -> float:
    """Max abs difference; fails beyond atol + rtol * |want|, both `tol`
    (by default `_tol(dtype)`)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = _tol(dtype) if tol is None else tol
    worst = float((err - tol * w.abs()).max())
    _check(worst <= tol, f"{what}: |diff| {float(err.max())} beyond "
                         f"{tol} + {tol} |want|")
    return float(err.max())


def _randn(shape, gen, dtype, scale=1.0):
    import torch

    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


def _ops_rate(dtype) -> float:
    import torch

    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def _bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / _ops_rate(dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _wgmma_probe(gen) -> dict:
    """The bf16 flash kernel's two tile products alone, at every head dim:
    S = Q K^T (m64n64k16, both operands from shared memory) and O = P V
    (P from registers), against torch.matmul in f32; exact up to the f32
    summation order, so held within 1e-5 of the sum of the products'
    magnitudes."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        WGMMA_HEAD_DIMS,
        wgmma_probe,
    )

    worst = 0.0
    for hd in WGMMA_HEAD_DIMS:
        q, k, v = (_randn((64, hd), gen, torch.bfloat16) for _ in range(3))
        p = _randn((64, 64), gen, torch.bfloat16).abs()
        s, o = wgmma_probe(q, k, v, p)
        for what, got, a, b in (("S = Q K^T", s, q, k.T),
                                ("O = P V", o, p, v)):
            a, b = a.float(), b.float()
            rel = float(((got - a @ b).abs() / (a.abs() @ b.abs())).max())
            _check(rel <= 1e-5, f"wgmma probe hd {hd} {what}: {rel}")
            worst = max(worst, rel)
    return dict(head_dims=list(WGMMA_HEAD_DIMS), max_rel_err=worst)


def _flash_row(gen, dtype, B, Hq, Hkv, Sq, Sk, hd, causal, window) -> dict:
    """One flash row: the kernel through `ops.flash_attention` held to its
    plain version (and to itself: the same bits twice), then timed (events
    and profiler) beside the plain version, SDPA (causal, non-causal, or
    with the window as a boolean mask) and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask,
        flash_attention_ref,
    )

    q = _randn((B, Hq, Sq, hd), gen, dtype)
    k = _randn((B, Hkv, Sk, hd), gen, dtype)
    v = _randn((B, Hkv, Sk, hd), gen, dtype)
    qf = q.reshape(-1, Sq, hd)
    kf, vf = (t.reshape(-1, Sk, hd) for t in (k, v))
    what = f"flash Sq={Sq} Sk={Sk} hd={hd} causal={causal} window={window}"
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal, window)
    err = _held(got, want, dtype, f"{what} {dtype}")
    again = flash_attention(q, k, v, causal=causal, window=window)
    _check(torch.equal(got, again), f"{what} not deterministic")
    del got, want, again
    reps = 20 if max(Sq, Sk) <= 512 else 5
    kernel = lambda: flash_attention_fwd(qf, kf, vf, Hq // Hkv,  # noqa: E731
                                         causal, window)
    ms = _cuda_ms(kernel, reps=reps)
    device_ms = _device_ms(kernel, ("flash_fwd",), reps=reps)
    plain_ms = _cuda_ms(lambda: flash_attention_ref(q, k, v, causal, window),
                        reps=3, warmup=1)
    mask = attention_mask(Sq, Sk, causal, window, device="cuda")
    if window or (causal and Sq != Sk):
        sdpa = dict(attn_mask=mask)
    else:
        sdpa = dict(is_causal=causal)
    library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **sdpa), reps=reps)
    live = int(mask.sum())
    es = q.element_size()
    nbytes = es * (2 * B * Hq * Sq * hd + 2 * B * Hkv * Sk * hd)
    ops = 4 * B * Hq * hd * live
    bound_ms, bound_by = _bound(nbytes, ops, dtype)
    del q, k, v, qf, kf, vf, mask
    torch.cuda.empty_cache()
    return dict(dtype=_dname(dtype), B=B, Hq=Hq, Hkv=Hkv, S=Sq, Sk=Sk, hd=hd,
                causal=causal, window=window, max_abs_err=err, ms=ms,
                device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, vs_library=ms / library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                tflops=ops / (ms * 1e-3) / 1e12,
                device_tflops=ops / (device_ms * 1e-3) / 1e12
                if device_ms else None)


def phase_flash_attention() -> dict:
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    probe = _wgmma_probe(gen)
    sweep_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, Sq, Sk, hd, causal, window in FLASH_SWEEP:
            q = _randn((B, Hq, Sq, hd), gen, dtype)
            k = _randn((B, Hkv, Sk, hd), gen, dtype)
            v = _randn((B, Hkv, Sk, hd), gen, dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_ref(q, k, v, causal, window)
            sweep_err = max(sweep_err, _held(
                got, want, dtype, f"flash sweep {(B, Hq, Hkv, Sq, Sk, hd)}"))
    rows = []
    # B, Hq, Hkv, Sq, Sk, hd, causal, window: qwen3-moe's prefills
    # (causal), then recurrentgemma-2b's local attention (hd 256, MQA,
    # window 2048) below and past the window
    cases = [(1, 32, 4, S, S, 128, True, 0) for S in (128, 512, 2048)] + [
        (1, 10, 1, S, S, 256, True, 2048) for S in (1900, 3300)]
    # cross-attention and the encoder, non-causal at a 455-token prompt:
    # seamless-m4t's encoder (MHA, hd 64) and llama-3.2-vision's cross
    # layers (hd 128, group 8) over 1,600 image tokens
    cross = [(1, 16, 16, 455, 455, 64, False, 0),
             (1, 64, 8, 455, 1600, 128, False, 0)]
    # head dims above 256 (F1, F2): the f32 kernel's hd-512 and hd-1024
    # instantiations, 320 and 768 zero-padded to them; bf16 widened to f32
    # around the call
    wide = [(1, 8, 2, 512, 512, hd, True, 0) for hd in (320, 512, 768, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        # smollm-360m's (hd 64, group 3) and deepseek-moe-16b's (hd 128,
        # MHA) layouts, and stablelm-12b's head dim, between the
        # instantiations (hd 160, group 4)
        archs = [(1, 15, 5, 512, 512, 64, True, 0),
                 (1, 16, 16, 512, 512, 128, True, 0),
                 (1, 32, 8, 512, 512, 160, True, 0)
                 ] if dtype == torch.bfloat16 else []
        for case in cases + archs + cross + wide:
            rows.append(_flash_row(gen, dtype, *case))
    return dict(phase="flash_attention", wgmma_probe=probe,
                sweep_cases=2 * len(FLASH_SWEEP),
                sweep_max_abs_err=sweep_err, rows=rows)


# B, Hq, Hkv, Sq, Sk, hd, causal, window: the flash sweep and a causal row
# with Sq > Sk (rows at negative positions: the mean of V, no dQ)
FLASH_BWD_SWEEP = FLASH_SWEEP + [
    (1, 2, 1, 96, 32, 32, True, 0),
    # hd 256 (bf16: two warpgroups, the group cut into parts): group 10
    # over one KV head with a window on ragged tiles; three heads in two
    # parts (136 key-tile blocks), a remainder
    (1, 10, 1, 200, 200, 256, True, 70), (2, 6, 2, 300, 2150, 256, True, 0)]


def _grad_held(got, want, dtype, what: str) -> tuple:
    """A gradient within tol * max|want| + tol * |want| (tol `_tol`):
    the kernels' tolerance, relative to the gradient's scale.  Returns
    the largest difference and that over max|want|."""
    g, w = got.float(), want.float()
    tol, scale = _tol(dtype), float(w.abs().max())
    err = (g - w).abs()
    worst = float((err - tol * w.abs()).max())
    _check(worst <= tol * scale,
           f"{what}: |diff| {float(err.max())} beyond {tol} max|want| "
           f"({scale}) + {tol} |want|")
    return float(err.max()), float(err.max()) / max(scale, 1e-30)


def _plain_grads(q, k, v, do, causal, window):
    """dq, dk, dv and o by autograd through `flash_attention_ref`, one
    batch element at a time (the full score matrix of B 8 at S 4096 is
    8 GB a tensor)."""
    import torch

    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    outs = [[], [], [], []]
    for b in range(q.shape[0]):
        qb, kb, vb = (t[b:b + 1].detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = flash_attention_ref(qb, kb, vb, causal, window)
            grads = torch.autograd.grad(o, (qb, kb, vb), do[b:b + 1])
        for acc, t in zip(outs, (*grads, o.detach())):
            acc.append(t)
    return [torch.cat(ts) for ts in outs]


def _plain_lse(q, k, causal, window):
    """logsumexp of the plain version's scaled, masked scores, (B, Hq,
    Sq), one batch element at a time."""
    import torch

    from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    mask = attention_mask(Sq, Sk, causal, window, device=q.device)
    out = []
    for b in range(B):
        qg = q[b].reshape(Hkv, Hq // Hkv, Sq, hd).float()
        s = torch.einsum("hgqd,hkd->hgqk", qg, k[b].float()) * hd**-0.5
        out.append(torch.logsumexp(torch.where(mask, s, NEG_INF), -1)
                   .reshape(Hq, Sq))
    return torch.stack(out)


def _flash_bwd_row(gen, dtype, B, Hq, Hkv, Sq, Sk, hd, causal, window,
                   timed: bool = True) -> dict:
    """One backward row: dq, dk, dv through `ops.flash_attention` (its
    autograd function, the backward kernel) against autograd through the
    plain version, the same bits from a second run, lse against
    torch.logsumexp of the plain scores; then the backward kernel timed
    (events and profiler) beside its bound, the plain version's backward
    and SDPA's (forward + backward less forward)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        bwd_head_dim,
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask,
        flash_attention_ref,
    )

    what = (f"flash bwd B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} hd={hd} "
            f"causal={causal} window={window} {_dname(dtype)}")
    q = _randn((B, Hq, Sq, hd), gen, dtype)
    k = _randn((B, Hkv, Sk, hd), gen, dtype)
    v = _randn((B, Hkv, Sk, hd), gen, dtype)
    do = _randn((B, Hq, Sq, hd), gen, dtype)

    def kernel_grads():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = flash_attention(qq, kk, vv, causal=causal, window=window)
        return torch.autograd.grad(o, (qq, kk, vv), do)

    got = kernel_grads()
    again = kernel_grads()
    _check(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"{what} not deterministic")
    *want, _ = _plain_grads(q, k, v, do, causal, window)
    held = [_grad_held(g, w, dtype, f"{what} {name}")
            for g, w, name in zip(got, want, ("dq", "dk", "dv"))]
    errs = [rel for _, rel in held]
    del again, want
    qf = q.reshape(-1, Sq, hd)
    kf, vf = (t.reshape(-1, Sk, hd) for t in (k, v))
    dof = do.reshape(-1, Sq, hd)
    group = Hq // Hkv
    o, lse = flash_attention_fwd(qf, kf, vf, group, causal, window,
                                 return_lse=True)
    lse_want = _plain_lse(q, k, causal, window).reshape(-1, Sq)
    lse_err = _held(lse, lse_want, torch.float32 if dtype == torch.float32
                    else dtype, f"{what} lse")
    row = dict(dtype=_dname(dtype), B=B, Hq=Hq, Hkv=Hkv, S=Sq, Sk=Sk, hd=hd,
               causal=causal, window=window,
               max_abs_err=max(a for a, _ in held), max_rel_err=max(errs),
               dq_rel_err=errs[0], dk_rel_err=errs[1], dv_rel_err=errs[2],
               lse_max_abs_err=lse_err, deterministic=True)
    if not timed:
        return row
    kernel = lambda: flash_attention_bwd(qf, kf, vf, o, dof, lse,  # noqa: E731
                                         group, causal, window)
    reps = 3 if Sq * Sk * B * Hq > 2**28 else 10
    ms = _cuda_ms(kernel, reps=reps, warmup=1)
    passes = {e.key: getattr(e, "device_time_total", 0.0) / reps / 1e3
              for e in _traced(kernel, ("flash_bwd",), reps)}
    device_ms = sum(passes.values()) or None
    row["device_ms_by_pass"] = {
        part: sum(t for name, t in passes.items() if key in name)
        for part, key in (("D", "flash_bwd_dsum"), ("dKdV", "flash_bwd_dkdv"),
                          ("sum", "flash_bwd_kv_reduce"),
                          ("dQ", "flash_bwd_dq"))}
    if dtype == torch.bfloat16 and bwd_head_dim(hd) == 256:
        # the CUDA-core kernels at the same hd: the f32 instantiation on
        # the same values (bf16 at hd 256 ran on it, converted on load,
        # before the tensor-core kernels)
        q32, k32, v32, do32 = (t.float() for t in (qf, kf, vf, dof))
        o32, lse32 = flash_attention_fwd(q32, k32, v32, group, causal, window,
                                         return_lse=True)
        row["cuda_core_ms"] = _cuda_ms(
            lambda: flash_attention_bwd(q32, k32, v32, o32, do32, lse32,
                                        group, causal, window),
            reps=min(reps, 3), warmup=1)
        del q32, k32, v32, do32, o32, lse32

    def plain_fwd():
        with torch.enable_grad():
            for b in range(B):
                flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    causal, window)

    plain_ms = (_cuda_ms(lambda: _plain_grads(q, k, v, do, causal, window),
                         reps=1, warmup=1)
                - _cuda_ms(plain_fwd, reps=1, warmup=1))
    # SDPA on K/V repeated to the query heads (its flash and efficient
    # backends take no group), windowed by a boolean mask
    mask = attention_mask(Sq, Sk, causal, window, device="cuda")
    sdpa = (dict(attn_mask=mask) if window or (causal and Sq != Sk)
            else dict(is_causal=causal))
    qs_, ks_, vs_ = (t.detach().requires_grad_() for t in (
        q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)))

    def sdpa_fwd():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(qs_, ks_, vs_, **sdpa)

    library_ms = (
        _cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qs_, ks_, vs_), do),
                 reps=reps)
        - _cuda_ms(sdpa_fwd, reps=reps))
    live = int(mask.sum())
    es = q.element_size()
    # q, k, v, o, dO and lse read once; dq, dk, dv written once
    nbytes = es * (4 * B * Hq * Sq * hd + 4 * B * Hkv * Sk * hd) \
        + 4 * B * Hq * Sq
    ops = 5 * 2 * B * Hq * hd * live
    bound_ms, bound_by = _bound(nbytes, ops, dtype)
    del qs_, ks_, vs_, mask, got, o, lse
    torch.cuda.empty_cache()
    row.update(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
               library_ms=library_ms, vs_library=ms / library_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               fp32_core_bound_ms=ops / FP32_OPS_PER_S * 1e3,
               tflops=ops / (ms * 1e-3) / 1e12)
    return row


def phase_flash_attention_bwd() -> dict:
    """The backward kernel: the sweep in f32 and bf16, then smollm-360m's
    training shape (B 8, Hq 15, Hkv 5, hd 64, S 4096, causal, bf16), its
    layout in f32 at S 512, yi's hd 128 group 8, stablelm's hd 160 (padded
    to 256), a window, a non-causal row with Sq != Sk, and
    recurrentgemma-2b's training shape (B 1, Hq 10, Hkv 1, hd 256, S
    4096, window 2048, bf16)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    sweep = [_flash_bwd_row(gen, dtype, *case, timed=False)
             for dtype in (torch.float32, torch.bfloat16)
             for case in FLASH_BWD_SWEEP]
    rows = [_flash_bwd_row(gen, dtype, *case) for dtype, case in (
        (torch.bfloat16, (8, 15, 5, 4096, 4096, 64, True, 0)),
        (torch.float32, (2, 15, 5, 512, 512, 64, True, 0)),
        (torch.bfloat16, (1, 32, 4, 512, 512, 128, True, 0)),
        (torch.bfloat16, (1, 32, 8, 512, 512, 160, True, 0)),
        (torch.float32, (1, 8, 2, 1024, 1024, 64, True, 256)),
        (torch.bfloat16, (1, 16, 8, 455, 1600, 128, False, 0)),
        (torch.bfloat16, (1, 10, 1, 4096, 4096, 256, True, 2048)))]
    return dict(phase="flash_attention_bwd", sweep_cases=len(sweep),
                sweep_max_rel_err=max(r["max_rel_err"] for r in sweep),
                sweep_lse_max_abs_err=max(r["lse_max_abs_err"]
                                          for r in sweep),
                rows=rows)


def _autograd_ms(fn, leaves, grads, reps: int) -> float:
    """Events ms of autograd through `fn` (forward and backward) less the
    forward alone: the backward's time."""
    import torch

    def both():
        with torch.enable_grad():
            out = fn(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            used = [(o, g) for o, g in zip(outs, grads) if g is not None]
            torch.autograd.grad([o for o, _ in used], leaves,
                                [g for _, g in used])

    def fwd():
        with torch.enable_grad():
            fn(*leaves)

    return _cuda_ms(both, reps=reps, warmup=1) - _cuda_ms(fwd, reps=reps,
                                                          warmup=1)


def _bwd_row(what, dtype, fn, leaves, grads, kernel, names, plain=None,
             timed=True, reps=10) -> dict:
    """One backward-kernel row: the gradients through `fn` (the op, whose
    autograd function launches the forward and backward kernels) against
    autograd through `plain[0]` (the plain version) or, where `plain[1]` is
    given, the explicit backward `plain[1]()`; the same bits from a second
    run; then `kernel` (the backward kernel alone) timed with events and
    the profiler (kernels named with one of `names`) beside autograd
    through the plain version's backward."""
    import torch

    def grads_of(f):
        ls = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            out = f(*ls)
            outs = out if isinstance(out, tuple) else (out,)
            used = [(o, g) for o, g in zip(outs, grads) if g is not None]
            return torch.autograd.grad([o for o, _ in used], ls,
                                       [g for _, g in used])

    got = grads_of(fn)
    _check(all(torch.equal(a, b) for a, b in zip(got, grads_of(fn))),
           f"{what} not deterministic")
    plain_fn, explicit = plain
    want = explicit() if explicit is not None else grads_of(plain_fn)
    held = [_grad_held(g, w, dtype, f"{what} d{i}")
            for i, (g, w) in enumerate(zip(got, want))]
    row = dict(max_abs_err=max(a for a, _ in held),
               max_rel_err=max(r for _, r in held),
               held_against=("the explicit backward" if explicit is not None
                             else "autograd through ref.py"),
               deterministic=True)
    del got, want
    if not timed:
        return row
    row["ms"] = _cuda_ms(kernel, reps=reps, warmup=1)
    row["device_ms"] = _device_ms(kernel, names, reps=reps)
    if explicit is not None:
        row["plain_ms"] = _cuda_ms(explicit, reps=1, warmup=1)
        row["plain_is"] = "the explicit backward (*_bwd_ref)"
    else:
        row["plain_ms"] = _autograd_ms(
            plain_fn, [t.detach().requires_grad_() for t in leaves], grads,
            reps=1)
        row["plain_is"] = "autograd through ref.py, less its forward"
    torch.cuda.empty_cache()
    return row


GMM_BWD_SWEEP = GMM_SWEEP + [(2, 67, 130, 70), (1, 5, 33, 17),
                             # the bf16 kernels' block tiles: a multiple,
                             # ragged, D and F not multiples of 8
                             (4, 128, 256, 256), (3, 100, 200, 150),
                             (2, 70, 75, 45)]


def _kernels_of(fn, part: str, reps: int = 3) -> dict:
    """Device ms a call of each kernel whose name holds `part`, from the
    profiler's trace (`_traced`), by its name (template arguments kept)."""
    import re

    out = {}
    for e in _traced(fn, (part,), reps):
        name = re.search(r"(\w+(?:<[^>]*>)?)\(", e.key).group(1)
        out[name] = out.get(name, 0.0) + getattr(
            e, "device_time_total", 0.0) / reps / 1e3
    return out


def _moe_wgmma_probe(gen) -> dict:
    """The bf16 moe_gmm backward's tile products alone, in the three
    operand orientations its passes use (x y, x y^T, x^T y), its atoms
    filled by 16-byte copies and by element loads, against torch.matmul
    in f32; held within 1e-5 of the sum of the products' magnitudes."""
    import torch

    from repro_torch.kernels.moe_gmm.kernel import moe_wgmma_probe

    x, y = (_randn((64, 64), gen, torch.bfloat16) for _ in range(2))
    worst = 0.0
    for vec in (True, False):
        out = moe_wgmma_probe(x, y, vec=vec)
        for what, got, a, b in (("x y", out[0], x, y),
                                ("x y^T", out[1], x, y.T),
                                ("x^T y", out[2], x.T, y)):
            a, b = a.float(), b.float()
            rel = float(((got - a @ b).abs() / (a.abs() @ b.abs())).max())
            _check(rel <= 1e-5, f"moe wgmma probe {what} vec={vec}: {rel}")
            worst = max(worst, rel)
    return dict(orientations=["x y", "x y^T", "x^T y"],
                loads=["16-byte copies", "element loads"], max_rel_err=worst)


def phase_moe_gmm_bwd() -> dict:
    """The expert FFN's backward kernel: first the wgmma probe, then the
    sweep (and ragged shapes, some against the bf16 kernels' block tiles)
    in f32 and bf16, then qwen3-moe's training shape (E 128, C 320: 4,096
    tokens, top 8, capacity factor 1.25; D 2048, F 768, bf16),
    deepseek-moe-16b's (E 64, C 480, F 1408), a small f32 row and a
    ragged bf16 row; each held to autograd through `moe_gmm_ref`, a
    quarter of the capacity rows empty (their dh must be zero), bit for
    bit against a second run, its kernels' names read from the profiler
    (bf16 on wgmma alone, f32 on the CUDA cores alone); timed beside its
    bound (16 E C D F operations at the inputs' type's rate), each
    kernel's device ms and, as a yardstick never on the path, autograd
    through three `torch.bmm` (`_bmm_trio`)."""
    import torch

    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    gen = torch.Generator(device="cuda").manual_seed(5)

    def row(dtype, E, C, D, Fd, timed=True):
        h = _randn((E, C, D), gen, dtype)
        h[:, C - C // 4:] = 0
        w = [_randn((E, D, Fd), gen, dtype, D**-0.5),
             _randn((E, D, Fd), gen, dtype, D**-0.5),
             _randn((E, Fd, D), gen, dtype, Fd**-0.5)]
        dout = _randn((E, C, D), gen, dtype)
        what = f"moe_gmm_bwd E={E} C={C} D={D} F={Fd} {_dname(dtype)}"
        dh = gmm.moe_gmm_bwd(h, *w, dout)[0]
        _check(not dh[:, C - C // 4:].any(), f"{what}: empty rows' dh")
        kernels = _kernels_of(lambda: gmm.moe_gmm_bwd(h, *w, dout), "moe_bwd",
                              reps=3 if timed else 1)
        wgmma = dtype == torch.bfloat16
        _check(len(kernels) > 0 and all(("wgmma" in k) == wgmma
                                        for k in kernels),
               f"{what}: kernels {sorted(kernels)}")
        out = dict(dtype=_dname(dtype), E=E, C=C, D=D, F=Fd,
                   empty_rows=C // 4, kernels=kernels, **_bwd_row(
                       what, dtype, moe_gmm, [h, *w], [dout],
                       lambda: gmm.moe_gmm_bwd(h, *w, dout), ("moe_bwd",),
                       plain=(moe_gmm_ref, None), timed=timed, reps=3))
        if timed:
            ops = 16 * E * C * D * Fd
            nbytes = h.element_size() * (3 * E * C * D + 6 * E * D * Fd)
            bound_ms, bound_by = _bound(nbytes, ops, dtype)
            out.update(
                bound_ms=bound_ms, bound_by=bound_by,
                fp32_core_bound_ms=ops / FP32_OPS_PER_S * 1e3,
                tflops=ops / (out["ms"] * 1e-3) / 1e12, library_ms=None,
                bmm_trio_bwd_ms=_autograd_ms(
                    _bmm_trio, [t.detach().requires_grad_()
                                for t in (h, *w)], [dout], reps=3))
        del h, w, dout, dh
        torch.cuda.empty_cache()
        return out

    probe = _moe_wgmma_probe(gen)
    sweep = [row(dtype, *case, timed=False)
             for dtype in (torch.float32, torch.bfloat16)
             for case in GMM_BWD_SWEEP]
    rows = [dict(arch="qwen3-moe-30b-a3b", **row(torch.bfloat16, 128, 320,
                                                 2048, 768)),
            dict(arch="deepseek-moe-16b", **row(torch.bfloat16, 64, 480,
                                                2048, 1408)),
            # ep_full's: a rank's experts of 4 model ranks, 4 ranks' rows
            dict(arch="qwen3-moe-30b-a3b tp4", **row(torch.bfloat16,
                                                     *_ep_full_rows(),
                                                     2048, 768)),
            dict(arch="small f32", **row(torch.float32, 16, 40, 2048, 768)),
            dict(arch="ragged", **row(torch.bfloat16, 8, 67, 200, 130))]
    return dict(phase="moe_gmm_bwd", wgmma_probe=probe,
                sweep_cases=len(sweep),
                sweep_max_rel_err=max(r["max_rel_err"] for r in sweep),
                sweep_kernels=sorted({k for r in sweep for k in r["kernels"]}),
                rows=rows)


def phase_rglru_scan_bwd() -> dict:
    """The RG-LRU scan's backward kernel: the sweep in f32 and bf16 (with
    h0's gradient), then recurrentgemma-2b's training shape (B 1, S 4096,
    D 2560, f32 gates as the model's), a small f32 row and a ragged bf16
    row, each held to autograd through `rglru_scan_ref`, bit for bit
    against a second run and against the kernel's order of operations in
    plain torch (`rglru_scan_bwd_chunked_ref`, `torch.equal`); timed (the
    kernel, `rglru_bwd`, and the memset of its status words apart) beside
    its byte bound, the bytes its design moves and, as a yardstick, the
    rate `torch.add` of two f32 tensors of the row's shape streams at."""
    import torch

    from repro_torch.kernels.rglru_scan import kernel as rg
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import (
        rglru_scan_bwd_chunked_ref,
        rglru_scan_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)

    def row(dtype, B, S, D, timed=True):
        a = _uniform((B, S, D), gen, 0.7, 0.999, dtype)
        bx = _randn((B, S, D), gen, dtype)
        h0 = _randn((B, D), gen, torch.float32)
        dhs = _randn((B, S, D), gen, torch.float32)
        hs = rg.rglru_scan_fwd(a, bx, h0)
        what = f"rglru_scan_bwd B={B} S={S} D={D} {_dname(dtype)}"
        fn = lambda: rg.rglru_scan_bwd(a, hs, h0, dhs)  # noqa: E731
        got = fn()
        want = rglru_scan_bwd_chunked_ref(a, hs, h0, dhs, rg.BWD_CHUNK)
        _check(all(torch.equal(g, w) for g, w in zip(got, want)),
               f"{what}: not the bits of rglru_scan_bwd_chunked_ref")
        del got, want
        out = dict(dtype=_dname(dtype), B=B, S=S, D=D,
                   equals_chunked_ref=True, **_bwd_row(
                       what, dtype, rglru_scan, [a, bx, h0], [dhs], fn,
                       ("rglru_bwd",), plain=(rglru_scan_ref, None),
                       timed=timed, reps=20))
        if timed:
            out["memset_device_ms"] = _device_ms(fn, ("Memset",), reps=20)
            es = a.element_size()
            # a, hs, dhs read once, da and dbx written once; h0, dh0
            nbytes = B * S * D * (3 * es + 8) + 8 * B * D
            bound_ms, bound_by = _bound(nbytes, 4 * B * S * D,
                                        torch.float32)
            # and a chunk's P, e and Q written, Q read by the chunk before
            nc = -(-S // rg.BWD_CHUNK)
            design = nbytes + 16 * B * nc * D
            # the rate PyTorch's own elementwise kernel streams at on this
            # card, a yardstick: hs + dhs into a third f32 tensor
            z = torch.empty_like(hs)
            add_ms = _cuda_ms(lambda: torch.add(hs, dhs, out=z), reps=20)
            dev = out["device_ms"]
            out.update(bound_ms=bound_ms, bound_by=bound_by,
                       bound_share=bound_ms / dev if dev else None,
                       library_ms=None, design_bytes=design,
                       design_ms=design / HBM_BYTES_PER_S * 1e3,
                       tb_s=nbytes / dev / 1e9 if dev else None,
                       torch_add_tb_s=12 * B * S * D / add_ms / 1e9)
            del z
        del a, bx, h0, dhs, hs
        torch.cuda.empty_cache()
        return out

    sweep = [row(dtype, *case, timed=False)
             for dtype in (torch.float32, torch.bfloat16)
             for case in RGLRU_SWEEP + [(1, 65, 130), (2, 129, 130),
                                        (1, 200, 8)]]
    rows = [dict(arch="recurrentgemma-2b", **row(torch.float32, 1, 4096,
                                                 2560)),
            # a rank's 640 channels at `model` 4
            dict(arch="recurrentgemma-2b tp4", **row(torch.float32, 1, 4096,
                                                     640)),
            dict(arch="small f32", **row(torch.float32, 1, 512, 2560)),
            dict(arch="ragged", **row(torch.bfloat16, 2, 1000, 2500))]
    return dict(phase="rglru_scan_bwd", tiling=rg.bwd_tiling(),
                sweep_cases=len(sweep),
                sweep_max_rel_err=max(r["max_rel_err"] for r in sweep),
                rows=rows)


def phase_mamba_scan_bwd() -> dict:
    """The selective scan's backward kernel: the sweep in f32 and bf16,
    with and without h_S's gradient, then falcon-mamba-7b's training shape
    (B 1, S 4096, D 8192, N 16; x bf16, dt, B, C f32 as the model's), held
    to the explicit backward `mamba_scan_bwd_ref` (autograd through the
    plain version's 4,096 steps would keep ~10 GB), a small f32 row (S
    512) and a ragged row (S 300, D 1000), held to autograd through
    `mamba_scan_ref`; bit for bit against a second run.  The backward
    reads the forward's chunk states (`mamba_scan_fwd(..., states=True)`,
    made once a row).  Timed (the four passes together and each) beside
    its bound (~22 f32 operations a state and step), the floor of the
    design's exponentials on the SFU at the sampled SM clock (two a state
    and step: the local pass's and the rebuild's; the function needs
    one), the bytes the design moves and each pass's resident blocks an
    SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    import math

    import torch

    from repro_torch.kernels.mamba_scan import kernel as mk
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.mamba_scan.ref import (
        mamba_scan_bwd_ref,
        mamba_scan_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(7)

    def row(x_dtype, p_dtype, B, S, D, N, with_hs, timed=True,
            explicit=False):
        args = [_randn((B, S, D), gen, x_dtype),
                torch.exp(_uniform((B, S, D), gen, math.log(1e-3),
                                   math.log(1e-1), torch.float32)).to(p_dtype),
                _randn((B, S, N), gen, p_dtype),
                _randn((B, S, N), gen, p_dtype),
                -torch.arange(1, N + 1, device="cuda",
                              dtype=torch.float32).repeat(D, 1),
                torch.ones(D, device="cuda")]
        dy = _randn((B, S, D), gen, torch.float32)
        dhs = _randn((B, D, N), gen, torch.float32) if with_hs else None
        what = (f"mamba_scan_bwd B={B} S={S} D={D} N={N} x {_dname(x_dtype)}"
                f" p {_dname(p_dtype)} dhS={with_hs}")
        states = mk.mamba_scan_fwd(*args, states=True)[2]
        fn = lambda: mk.mamba_scan_bwd(*args, dy, dhs, states)  # noqa: E731
        tol_dtype = torch.bfloat16 if torch.bfloat16 in (x_dtype, p_dtype) \
            else torch.float32
        out = dict(x_dtype=_dname(x_dtype), p_dtype=_dname(p_dtype), B=B,
                   S=S, D=D, N=N, dhS=with_hs, **_bwd_row(
                       what, tol_dtype, mamba_scan, args, [dy, dhs], fn,
                       ("mamba_scan_bwd",),
                       plain=(mamba_scan_ref,
                              (lambda: mamba_scan_bwd_ref(*args, dy, dhs))
                              if explicit else None),
                       timed=timed, reps=5))
        if timed:
            xs, ps = args[0].element_size(), args[1].element_size()
            # x, dt, dy read, dx, ddt written; B, C read, dB, dC written;
            # A, D read, dA, dD written; h_S's gradient read
            nbytes = (B * S * D * (2 * xs + 2 * ps + 4) + 4 * B * S * N * ps
                      + 8 * D * N + 8 * D + (4 * B * D * N if with_hs else 0))
            ops = 22 * B * S * D * N
            bound_ms, bound_by = _bound(nbytes, ops, torch.float32)
            for p_ in mk.BWD_PASSES:
                out[f"{p_}_device_ms"] = _device_ms(fn, (p_,), reps=5)
            mhz = _sm_clock_mhz(fn, calls=200)
            # the design's: the local pass's and the rebuild's
            exps = 2 * B * S * D * N
            # the design's bytes besides the function's: the chunk states
            # read; dt, dy read again by the local pass; its ends and
            # decays a chunk written, read by the carry pass, which writes
            # the carries over the ends, read by the main pass; dA's
            # partials a span of chunks, dB's and dC's a channel block,
            # each written and read once (the library's own tiling)
            step, chunk, span, channels = mk.bwd_tiling(N)
            nc, ns = -(-S // chunk), -(-S // step)
            nsp, nblk = -(-nc // span), -(-D // channels)
            design = (nbytes + 4 * B * ns * D * N + B * S * D * (ps + 4)
                      + 4 * B * D * N * (6 * nc + 2 * nsp)
                      + 16 * B * nblk * S * N)
            out.update(bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                       exps_per_state_step=2, exps=exps, sm_clock_mhz=mhz,
                       sfu_floor_ms=exps / (SFU_PER_CLOCK * SMS * mhz * 1e6)
                       * 1e3,
                       design_bytes=design,
                       design_ms=design / HBM_BYTES_PER_S * 1e3,
                       resident_blocks_per_sm=mk.bwd_occupancy(
                           x_dtype, p_dtype, N))
        del args, dy, dhs, states
        torch.cuda.empty_cache()
        return out

    sweep = [row(dtype, dtype, B, S, D, N, with_hs, timed=False)
             for dtype in (torch.float32, torch.bfloat16)
             for B, S, D, N in MAMBA_SWEEP + [(1, 37, 33, 5)]
             for with_hs in (False, True)]
    rows = [dict(arch="falcon-mamba-7b", **row(
                torch.bfloat16, torch.float32, 1, 4096, 8192, 16, False,
                explicit=True)),
            # a rank's 2,048 channels at `model` 4 (tp_ssm_full)
            dict(arch="falcon-mamba-7b tp4", **row(
                torch.bfloat16, torch.float32, 1, 4096, 2048, 16, False,
                explicit=True)),
            dict(arch="small f32", **row(torch.float32, torch.float32, 1,
                                         512, 8192, 16, True)),
            dict(arch="ragged", **row(torch.bfloat16, torch.float32, 2, 300,
                                      1000, 16, True))]
    return dict(phase="mamba_scan_bwd", sweep_cases=len(sweep),
                sweep_max_rel_err=max(r["max_rel_err"] for r in sweep),
                rows=rows)


TRAIN_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_trainer_serve.py:70-73
# Each stored training run: (phase, arch, the kernels a layer of each kind
# launches in training: forward twice a step (remat), backward once)
TRAIN_RUNS = [
    ("train_golden", "smollm-360m", {"flash_attention": "self_attn"}),
    ("train_golden_qwen3", "qwen3-moe-30b-a3b",
     {"flash_attention": "moe", "moe_gmm": "moe"}),
    ("train_golden_mamba", "falcon-mamba-7b", {"mamba_scan": "ssm"}),
    ("train_golden_rgemma", "recurrentgemma-2b",
     {"rglru_scan": "rglru", "flash_attention": "local_attn"}),
]


def _train_golden_file(arch: str) -> str:
    return f"{arch.replace('-', '_')}_reduced_train_golden.npz"


def _train_launches(cfg, kernels: dict, steps: int) -> dict:
    """Launches a training run of `steps` steps must count: each kernel's
    forward twice a layer of its kind a step (remat), its backward once."""
    from repro_torch.models.transformer import stack_plan

    kinds = stack_plan(cfg).kinds
    out = {}
    for name, kind in kernels.items():
        n = kinds.count(kind) * steps
        out[name] = 2 * n
        out[f"{name}_bwd"] = n
    return out


def _train_state_from(stored: dict, prefix: str, cfg, device):
    """A training state from the stored JAX parameters under `prefix`."""
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.train.trainer import init_train_state

    params = params_from_numpy(cfg, tree_from_flat(
        {k[len(prefix):]: v for k, v in stored.items()
         if k.startswith(prefix)}), device=device, masters=True)
    return init_train_state(cfg, params)


def _state_tensors(state) -> dict:
    out = {f"params/{k}": v.detach()
           for k, v in state["params"].named_parameters()}
    for part in ("m", "v"):
        out.update({f"{part}/{k}": v for k, v in state["opt"][part].items()})
    out["step"] = state["opt"]["step"]
    return out


def phase_train_golden(root: Path, phase: str, arch: str,
                       kernels: dict) -> dict:
    """Reduced `arch` in f32 (smollm-360m in its own head layout, hd 64,
    3 query heads a KV head; qwen3-moe, falcon-mamba and recurrentgemma in
    their reduced one), the JAX package's weights from the stored file:
    5 steps of `make_train_step` on SyntheticLM batches held to the JAX
    package's run (losses, grad norms and lr rtol 1e-5; the parameters
    after steps 3 and 5 atol/rtol 1e-5), each kernel's forward launched 2
    times a layer of its kind a step (remat recomputes the forward) and
    its backward once; then a checkpoint saved after step 3, restored into
    a fresh state, and steps 3-4 again give the straight run's bits."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.train.trainer import make_train_step

    stored = dict(np.load(root / "src" / "repro_torch" / "data"
                          / _train_golden_file(arch)))
    layout = json.loads(str(stored["config"]))
    cfg = reduced_config(get_config(arch)).replace(
        compute_dtype="float32", **layout)
    data = json.loads(str(stored["data"]))
    steps = len(stored["loss"])
    step_fn = make_train_step(cfg, single_device_ctx(), AdamWConfig(
        **json.loads(str(stored["opt"]))))
    src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                      seed=data["seed"])
    ckpt_dir = root / "build" / f"{phase}_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = Checkpointer(str(ckpt_dir))

    state = _train_state_from(stored, "param/", cfg, "cuda")
    rows, worst = [], 0.0
    launch_counts.clear()
    for i, batch in zip(range(steps), device_batches(src, 0, "cuda")):
        state, m = step_fn(state, batch)
        rows.append({k: float(v) for k, v in m.items()})
        if i + 1 == 3:
            ckpt.save(3, state)
        if f"after{i + 1}/embed" in stored:
            want = _train_state_from(stored, f"after{i + 1}/", cfg, "cuda")
            got = dict(state["params"].named_parameters())
            for name, w in want["params"].named_parameters():
                g, w = got[name].detach(), w.detach()
                err = (g - w).abs()
                _check(bool((err <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"]
                             * w.abs()).all()),
                       f"{phase} {name} after {i + 1} steps: "
                       f"{float(err.max())}")
                worst = max(worst, float(err.max()))
    launches = dict(launch_counts)
    for k in ("loss", "grad_norm", "lr"):
        got = np.array([r[k] for r in rows])
        rel = float(np.max(np.abs(got - stored[k]) / np.abs(stored[k])))
        _check(rel <= 1e-5, f"{phase} {k}: {got} != {stored[k]}")
    layers = cfg.num_layers
    want_launches = _train_launches(cfg, kernels, steps)
    _check(launches == want_launches,
           f"{phase} launches {launches} != {want_launches}")
    ckpt.wait()
    fresh = _train_state_from(stored, "param/", cfg, "cuda")
    fresh, start = ckpt.restore(fresh)
    again = []
    for _, batch in zip(range(start, steps), device_batches(src, start,
                                                            "cuda")):
        fresh, m = step_fn(fresh, batch)
        again.append({k: float(v) for k, v in m.items()})
    _check(again == rows[start:], f"{phase} restart metrics {again} "
                                  f"!= {rows[start:]}")
    want, got = _state_tensors(state), _state_tensors(fresh)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    _check(not differ, f"{phase} restart is not bit-exact: {differ[:8]}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(phase=phase, arch=cfg.name, layout=layout,
                layers=layers, steps=steps, batch=data["batch"],
                seq=data["seq"], losses=[r["loss"] for r in rows],
                jax_losses=stored["loss"].tolist(),
                grad_norms=[r["grad_norm"] for r in rows],
                params_max_abs_err=worst, restart_from=start,
                restart_bit_exact=True,
                **{f"{k}_launches": v for k, v in launches.items()})


# train_4k's global batch of 256 at 4,096 tokens: the f32 logits alone
# (256 x 4096 x 49,152 x 4 B) are ~206 GB
TRAIN_REDUCED = {"global_batch": [256, 8]}
TRAIN_REDUCED_WHY = ("train_4k's global batch of 256 at 4,096 tokens needs "
                     "~206 GB for the f32 logits alone; the card has 80 GB")


def _train_op_floor(cfg, B: int, S: int) -> dict:
    """The least time a step's products could take on the card: the
    layers' projections (forward, remat recompute, backward: 4 x 2 flops
    a weight a token) and the attention (forward twice, backward five
    products of 2 Sq Sk hd a head over the causal half) at the bf16
    tensor-core rate, the f32 logits (forward and both backward products)
    at the f32 rate."""
    D, hd, T = cfg.d_model, cfg.head_dim_, B * S
    proj = (D * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
            + 3 * D * cfg.d_ff)
    live = S * (S + 1) // 2
    attn = (2 * 4 + 5 * 2) * B * cfg.num_heads * hd * live
    bf16 = cfg.num_layers * (4 * 2 * proj * T + attn)
    f32 = 3 * 2 * T * D * cfg.vocab_size
    return dict(step_bf16_tflop=bf16 / 1e12, step_f32_tflop=f32 / 1e12,
                step_op_floor_ms=(bf16 / BF16_OPS_PER_S
                                  + f32 / FP32_OPS_PER_S) * 1e3)


def phase_train_full(root: Path) -> dict:
    """smollm-360m at full width and depth (32 layers, d_model 960, 15
    query heads over 5 KV heads at hd 64, vocab 49,152, tied), float32
    masters made on the card from seed 0, bf16 compute, full remat, S
    4096, B 8 (`TRAIN_REDUCED`): 12 steps of `launch.train.main` with a
    checkpoint under build/.  Every loss finite, the last 3 below the
    first 3 on average, 64 flash launches and 32 backward launches a
    step.  Then the checkpoint restored into a fresh state and 2 steps
    profiled: device ms a step, the backward kernel's share, the idle
    share against the unprofiled steps' host ms."""
    import shutil

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import count_params, init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.train.trainer import init_train_state, make_train_step

    _free_card()
    cfg = get_config("smollm-360m")
    steps, B, S = 12, 8, 4096
    print(f"reduced: {json.dumps(TRAIN_REDUCED)} ({TRAIN_REDUCED_WHY})",
          flush=True)
    ckpt_dir = root / "build" / "train_full_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_main(["--arch", cfg.name, "--no-reduced", "--steps",
                      str(steps), "--batch", str(B), "--seq", str(S),
                      "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "1000",
                      "--log-every", "1", "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(launch_counts)
    losses = run["losses"]
    _check(run["params"] == count_params(cfg) == FULL_PARAMS[cfg.name],
           f"train_full params {run['params']}")
    _check(len(losses) == steps and all(np.isfinite(losses)),
           f"train_full losses {losses}")
    _check(np.mean(losses[-3:]) < np.mean(losses[:3]),
           f"train_full loss did not fall: {losses}")
    L = cfg.num_layers
    _check(launches.get("flash_attention") == 2 * L * steps
           and launches.get("flash_attention_bwd") == L * steps,
           f"train_full launches {launches}")
    # the first step builds cuBLAS's plans and warms the allocator
    step_ms = float(np.median(run["step_s"][1:])) * 1e3

    _free_card()
    state = init_train_state(cfg, init_params(cfg, 1, device="cuda",
                                              masters=True))
    state, at = Checkpointer(str(ckpt_dir)).restore(state)
    _check(at == steps and int(state["opt"]["step"]) == steps,
           f"train_full restored step {at}")
    step_fn = make_train_step(cfg, single_device_ctx(), AdamWConfig(
        lr=1e-3, total_steps=steps, warmup_steps=5))
    batches = device_batches(SyntheticLM(cfg.vocab_size, S, B, seed=0),
                             steps, "cuda")
    state, m = step_fn(state, next(batches))   # warm
    float(m["loss"])
    prof_steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_steps):
            state, m = step_fn(state, next(batches))
            float(m["loss"])
    kern = [(e.key, getattr(e, "device_time_total", 0.0), e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_ms = sum(us for _, us, _ in kern) / prof_steps / 1e3
    bwd_ms = sum(us for k, us, _ in kern if "flash_bwd" in k) \
        / prof_steps / 1e3
    fwd_ms = sum(us for k, us, _ in kern if "flash_fwd" in k) \
        / prof_steps / 1e3
    kern.sort(key=lambda r: -r[1])
    del state, m
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    floor = _train_op_floor(cfg, B, S)
    return dict(
        **floor, floor_share=floor["step_op_floor_ms"] / step_ms,
        phase="train_full", arch=cfg.name, layers=L, d_model=cfg.d_model,
        params=run["params"], reduced=TRAIN_REDUCED,
        reduced_why=TRAIN_REDUCED_WHY, batch=B, seq=S, steps=steps,
        remat=cfg.remat, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, init_s=run["init_s"], wall_s=wall,
        losses=losses, grad_norms=run["grad_norms"], lrs=run["lrs"],
        floor=run["floor"], step_s=run["step_s"], step_ms=step_ms,
        tokens_per_s=B * S / (step_ms / 1e3), peak_bytes=peak,
        peak_gb=peak / 1e9, device_ms_per_step=device_ms,
        idle_share=1.0 - device_ms / step_ms,
        flash_bwd_device_ms_per_step=bwd_ms,
        flash_bwd_share_of_step=bwd_ms / step_ms,
        flash_fwd_device_ms_per_step=fwd_ms,
        launches_per_step=sum(c for _, _, c in kern) / prof_steps,
        top=[dict(kernel=k[:90], ms_per_step=us / prof_steps / 1e3,
                  launches_per_step=c / prof_steps)
             for k, us, c in kern[:12]],
        **{f"{k}_launches": v for k, v in launches.items()})


# ---------------- the rotor collectives and opera-dp (several ranks) ---------

COLL_SEED = 7
COLL_BULK = (1024, 1025)   # 4.2 MB of f32: padded at 3 ranks
COLL_SMALL = (2, 3)        # a control-plane tensor (the expander's class)
# (world, layouts): a world's layouts share its ranks; ranks row-major
COLL_WORLDS = [(3, [((3,), ("data",))]),
               (4, [((4,), ("data",)), ((2, 2), ("pod", "data"))])]
COLL_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/distributed/check_collectives.py


def _coll_cases(shape, axes) -> list:
    """(case, function, axis or (data, pod), keywords, per-rank shape)."""
    sizes = dict(zip(axes, shape))
    out = []
    for ax in axes:
        n = sizes[ax]
        out += [(f"rotor_reduce_scatter@{ax}", "rotor_reduce_scatter", ax,
                 {}, COLL_BULK),
                (f"rotor_all_gather@{ax}", "rotor_all_gather", ax, {},
                 COLL_BULK),
                (f"rotor_all_reduce@{ax}", "rotor_all_reduce", ax, {},
                 COLL_BULK),
                (f"rotor_all_reduce_direct@{ax}", "rotor_all_reduce", ax,
                 {"mode": "direct"}, COLL_BULK),
                (f"rotor_all_to_all@{ax}", "rotor_all_to_all", ax, {},
                 (n, COLL_BULK[0] // n, COLL_BULK[1])),
                (f"rotor_all_to_all_vlb@{ax}", "rotor_all_to_all", ax,
                 {"vlb": True}, (n, COLL_BULK[0] // n, COLL_BULK[1])),
                (f"expander_all_gather@{ax}", "expander_all_gather", ax, {},
                 COLL_SMALL),
                (f"expander_psum_latency@{ax}", "expander_psum_latency", ax,
                 {}, COLL_SMALL)]
    pod = "pod" if "pod" in axes else None
    return out + [
        ("hierarchical_rotor_all_reduce", "hierarchical_rotor_all_reduce",
         ("data", pod), {}, COLL_BULK),
        ("rotor_psum_tree", "rotor_psum_tree", ("data", pod), {}, COLL_BULK),
        ("compressed_rotor_all_reduce", "compressed_rotor_all_reduce",
         "data", {}, COLL_BULK)]


def _coll_line(shape, axes, rank: int, axis: str) -> list:
    import numpy as np

    grid = np.arange(int(np.prod(shape))).reshape(shape)
    idx = list(np.unravel_index(rank, shape))
    idx[axes.index(axis)] = slice(None)
    return grid[tuple(idx)].tolist()


def _coll_exact(x, fn, shape, axes, rank: int, axis):
    """The float64 reference of `fn` at `rank`, from every rank's input."""
    import numpy as np

    x = x.astype(np.float64)
    if fn in ("hierarchical_rotor_all_reduce", "rotor_psum_tree"):
        return x.sum(0)   # data, or pod x data: the whole world
    ranks = _coll_line(shape, axes, rank, axis)
    i, n, mine = ranks.index(rank), len(ranks), x[ranks]
    if fn == "rotor_reduce_scatter":
        flat = mine.reshape(n, -1).sum(0)
        return np.concatenate([flat, np.zeros(-flat.size % n)]).reshape(
            n, -1)[i]
    if fn in ("rotor_all_gather", "expander_all_gather"):
        return mine
    if fn == "rotor_all_to_all":
        return mine[:, i]
    return mine.sum(0)


def _collective_rank(world, layouts) -> dict:
    """Every collective of each layout on this rank's CUDA tensors, held
    to its float64 reference: one row a case (error, bytes sent, host
    ms of a second call), and the world's backend and why."""
    import numpy as np
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core.comm import Mesh

    rows = []
    for j, (shape, axes) in enumerate(layouts):
        mesh = Mesh(shape, axes)
        for k, (case, fn, axis, kw, xshape) in enumerate(
                _coll_cases(shape, axes)):
            rng = np.random.default_rng([COLL_SEED, j, k])
            x = rng.normal(size=(world.size,) + xshape).astype(np.float32)
            mine = torch.from_numpy(x[world.rank]).to(world.device)
            args = axis if isinstance(axis, tuple) else (axis,)
            if fn == "rotor_psum_tree":
                def call():
                    return C.rotor_psum_tree({"g": mine}, mesh, *args)["g"]
            elif fn == "compressed_rotor_all_reduce":
                def call():
                    return C.compressed_rotor_all_reduce(mine, mesh,
                                                         *args)[0]
            else:
                def call(fn=fn):
                    return getattr(C, fn)(mine, mesh, *args, **kw)
            got = call()
            torch.cuda.synchronize()
            sent = mesh.sent_bytes
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            sent = mesh.sent_bytes - sent
            want = _coll_exact(x, fn, shape, axes, world.rank, axis)
            g = got.double().cpu().numpy()
            err = float(np.abs(g - want).max())
            if fn == "compressed_rotor_all_reduce":
                ok = err / float(np.abs(want).max()) < 0.05
            else:
                ok = bool(np.allclose(g, want, **COLL_TOL))
            if not ok:
                raise AssertionError(f"{case} on {shape}: {err}")
            rows.append(dict(mesh=dict(zip(axes, shape)), case=case,
                             max_abs_err=err, sent_bytes=sent,
                             in_bytes=mine.numel() * 4, host_ms=host_ms))
    return dict(rows=rows, backend=world.backend, why=world.why)


def phase_collectives() -> dict:
    """The rotor collectives (`core.collectives`) on CUDA tensors in
    worlds of 3 ranks on `data`, 4 on `data` and 4 as `pod` 2 x `data` 2
    (on one card gloo, staged through host memory: NCCL refuses two ranks
    on one card): each held to a float64 reference computed on every rank
    from every rank's seeded input (atol/rtol 1e-5; the compressed one
    within a relative 0.05), with each rank's wire bytes per input byte
    beside `schedule_stats`'s, the host ms of a call (the slowest
    rank's) and each world's backend and why."""
    from repro_torch.core.collectives import schedule_stats
    from repro_torch.core.comm import spawn_world

    # schedule_stats's bytes per input byte (the expander's per gathered
    # byte); it has none for the halves of rs_ag and the hierarchical sum
    per_byte = {"rotor_all_reduce": "rotor_ar_bytes",
                "compressed_rotor_all_reduce": "rotor_ar_bytes",
                "rotor_all_reduce_direct": "rotor_ar_direct_bytes",
                "rotor_all_to_all": "rotor_a2a_bytes",
                "rotor_all_to_all_vlb": "rotor_a2a_vlb_bytes",
                "expander_all_gather": "expander_allgather_bytes",
                "expander_psum_latency": "expander_allgather_bytes"}
    out, worlds = [], {}
    for size, layouts in COLL_WORLDS:
        ranks = spawn_world(_collective_rank, size, layouts, device="cuda",
                            timeout_s=300)
        worlds[size] = {k: ranks[0][k] for k in ("backend", "why")}
        for case_rows in zip(*(r["rows"] for r in ranks)):
            row = dict(case_rows[0])
            row["world"] = size
            row["max_abs_err"] = max(r["max_abs_err"] for r in case_rows)
            row["host_ms"] = max(r["host_ms"] for r in case_rows)
            row["sent_bytes_per_rank"] = [r["sent_bytes"] for r in case_rows]
            del row["sent_bytes"]
            name, _, axis = row["case"].partition("@")
            n = row["mesh"].get(axis or "data")
            key = per_byte.get(name)
            gathered = row["in_bytes"] * (n if name.startswith("expander")
                                          else 1)
            row["wire_per_input_byte"] = max(row["sent_bytes_per_rank"]) \
                / gathered
            row["schedule_stats"] = (schedule_stats(n)[key] if key
                                     else None)
            out.append(row)
    return dict(phase="collectives", worlds=worlds, cases=len(out), rows=out,
                max_abs_err=max(r["max_abs_err"] for r in out
                                if not r["case"].startswith("compressed")))


OPERA_DP_GOLDEN = "smollm_360m_reduced_opera_dp_golden.npz"


def _dp_fingerprint(params, keep=None) -> list:
    """Two wrapping int64 sums of every leaf's 32-bit words (of the leaves
    `keep(name, leaf)` keeps), plain and weighted by position: equal on
    two ranks only if their bits are, short of a collision."""
    import torch

    out = []
    for name, p in params.named_parameters():
        if keep is not None and not keep(name, p):
            continue
        w = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        idx = torch.arange(1, w.numel() + 1, device=w.device)
        out.append(torch.stack([w.sum(), (w * idx).sum()]))
    return torch.stack(out).cpu().tolist()


def _dp_sha256(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for name, p in params.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_golden_rank(world, path: str) -> dict:
    """The stored opera-dp run's steps on this rank: metrics, the largest
    distance from the stored parameters after each step, a digest, the
    kernels' launches."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.opera_dp import (init_opera_dp_state,
                                            make_opera_dp_train_step)

    stored = dict(np.load(path))
    cfg = reduced_config(get_config("smollm-360m")).replace(
        **json.loads(str(stored["config"])))
    mesh_spec = json.loads(str(stored["mesh"]))
    mesh = Mesh(mesh_spec["shape"], mesh_spec["axes"])
    data = json.loads(str(stored["data"]))

    def tree(prefix):
        return params_from_numpy(cfg, tree_from_flat(
            {k[len(prefix):]: v for k, v in stored.items()
             if k.startswith(prefix)}), device=world.device, masters=True)

    state = init_opera_dp_state(tree("param/"))
    step = make_opera_dp_train_step(
        cfg, pctx_for_mesh(mesh), AdamWConfig(**json.loads(str(
            stored["opt"]))))
    src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                      seed=data["seed"])
    rows = []
    launch_counts.clear()
    for i, batch in zip(range(len(stored["loss"])),
                        device_batches(src, 0, world.device)):
        state, m = step(state, batch)
        got = dict(state["params"].named_parameters())
        worst, bad = 0.0, []
        for name, w in tree(f"after{i + 1}/").named_parameters():
            err = (got[name].detach() - w.detach()).abs()
            worst = max(worst, float(err.max()))
            if not bool((err <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"]
                         * w.detach().abs()).all()):
                bad.append(name)
        rows.append(dict(metrics={k: float(v) for k, v in m.items()},
                         params_max_abs_err=worst, outside_tol=bad,
                         digest=_dp_sha256(state["params"])))
    return dict(rows=rows, launches=dict(launch_counts),
                peak_bytes=torch.cuda.max_memory_allocated(),
                backend=world.backend, why=world.why)


def phase_opera_dp_golden(root: Path) -> dict:
    """The explicit data-parallel trainer (`train.opera_dp`) on 4 ranks
    as `pod` 2 x `data` 2 on the one card: reduced smollm-360m (2 layers,
    vocab 64, hd 64 with 3 query heads a KV head, f32) from the JAX
    package's weights, 3 steps held to the JAX package's
    `make_opera_dp_train_step` on 4 fake CPU devices
    (src/repro_torch/data/smollm_360m_reduced_opera_dp_golden.npz):
    losses, grad norms and lr within rtol 1e-5, the parameters after each
    step at atol/rtol 1e-5, the four replicas the same bits; each rank's
    flash kernel 2 launches a layer a step and its backward 1; and to
    the card's own single-process `make_train_step` on the whole batch,
    the loss within 1e-3 (tests/distributed/check_sharded_train.py:84)."""
    import numpy as np

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.train.trainer import make_train_step

    path = root / "src" / "repro_torch" / "data" / OPERA_DP_GOLDEN
    stored = dict(np.load(path))
    steps = len(stored["loss"])
    t0 = time.perf_counter()
    ranks = _ranks(_dp_golden_rank, str(path), timeout_s=300)
    ranks_s = time.perf_counter() - t0
    rows = [r["rows"] for r in ranks]
    for i in range(steps):
        _check(len({r[i]["digest"] for r in rows}) == 1,
               f"opera_dp_golden: replicas differ after step {i + 1}")
        for rank, r in enumerate(rows):
            _check(not r[i]["outside_tol"],
                   f"opera_dp_golden rank {rank} step {i + 1}: "
                   f"{r[i]['outside_tol'][:8]}")
    for k in ("loss", "grad_norm", "lr"):
        got = np.array([r["metrics"][k] for r in rows[0]])
        rel = float(np.max(np.abs(got - stored[k]) / np.abs(stored[k])))
        _check(rel <= 1e-5, f"opera_dp_golden {k}: {got} != {stored[k]}")
    cfg = reduced_config(get_config("smollm-360m")).replace(
        **json.loads(str(stored["config"])))
    L = cfg.num_layers
    for r in ranks:
        _check(r["launches"] == {"flash_attention": 2 * L * steps,
                                 "flash_attention_bwd": L * steps},
               f"opera_dp_golden launches {r['launches']}")
    # the card's single-process step on the whole batch
    data = json.loads(str(stored["data"]))
    state = _train_state_from(stored, "param/", cfg, "cuda")
    one = make_train_step(cfg, single_device_ctx(), AdamWConfig(
        **json.loads(str(stored["opt"]))))
    src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                      seed=data["seed"])
    whole = []
    for _, batch in zip(range(steps), device_batches(src, 0, "cuda")):
        state, m = one(state, batch)
        whole.append(float(m["loss"]))
    dp = [r["metrics"]["loss"] for r in rows[0]]
    _check(all(abs(a - b) < 1e-3 for a, b in zip(dp, whole)),
           f"opera_dp_golden losses {dp} against one process {whole}")
    mesh = json.loads(str(stored["mesh"]))
    return dict(
        phase="opera_dp_golden", arch=cfg.name, layers=L,
        mesh=dict(zip(mesh["axes"], mesh["shape"])),
        backend=ranks[0]["backend"], why=ranks[0]["why"],
        steps=steps, batch=data["batch"], seq=data["seq"], losses=dp,
        jax_losses=stored["loss"].tolist(), one_process_losses=whole,
        grad_norms=[r["metrics"]["grad_norm"] for r in rows[0]],
        params_max_abs_err=max(s["params_max_abs_err"] for r in rows
                               for s in r),
        replicas_bit_equal=True, ranks_s=ranks_s,
        peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
        flash_attention_launches=sum(r["launches"]["flash_attention"]
                                     for r in ranks),
        flash_attention_bwd_launches=sum(
            r["launches"]["flash_attention_bwd"] for r in ranks))


# 4 steps, so that the script keeps within its 1,200 s
DP_FULL_STEPS, DP_FULL_B, DP_FULL_S = 4, 8, 4096


def _dp_full_rank(world, seq: int) -> list:
    """smollm-360m at full width through `launch.train.main` on this rank,
    plain and then with ``--compress-grads``: the run, a fingerprint of
    the parameters after every step, their SHA-256 after the last, peak
    bytes and the kernels' launches."""
    import gc

    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import main as train_main

    out = []
    for compress in (False, True):
        prints = []

        def on_step(step, state, metrics, prints=prints):
            prints.append(_dp_fingerprint(state["params"]))
            if step == DP_FULL_STEPS - 1:
                prints.append(_dp_sha256(state["params"]))

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        run = train_main(
            ["--arch", "smollm-360m", "--no-reduced", "--steps",
             str(DP_FULL_STEPS), "--batch", str(DP_FULL_B), "--seq",
             str(seq), "--log-every", "1", "--device", "cuda"]
            + (["--compress-grads"] if compress else []), on_step=on_step)
        out.append(dict(run=run, prints=prints, compress=compress,
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        launches=dict(launch_counts), why=world.why))
    return out


def phase_opera_dp_full(train_full: dict) -> dict:
    """smollm-360m at full width (32 layers, d_model 960, vocab 49,152),
    f32 masters from seed 0, bf16 compute, S 4096, global batch 8 as
    train_full, through `launch.train.main` on 4 ranks as `data` 4 on the
    one card (gloo, staged through host memory), `DP_FULL_STEPS` steps
    plain, then as many with ``--compress-grads``: every loss finite and
    falling (the last half below the first on average), the four replicas
    the same bits after
    every step, 2 flash launches a layer a step and 1 backward on every
    rank.  Prints step ms and the wire's ms within it, wire bytes and peak
    bytes per rank, and each step's loss beside train_full's (same seed
    and batches; printed, not gated)."""
    import os

    import numpy as np

    from repro_torch.configs.base import get_config

    _free_card()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t0 = time.perf_counter()
    ranks = _ranks(_dp_full_rank, DP_FULL_S, timeout_s=900)
    wall = time.perf_counter() - t0
    L = get_config("smollm-360m").num_layers
    runs = {}
    for j, tag in enumerate(("plain", "int8")):
        per_rank = [r[j] for r in ranks]
        run0 = per_rank[0]["run"]
        losses = run0["losses"]
        _check(all(r["run"]["losses"] == losses for r in per_rank),
               f"opera_dp_full {tag}: ranks report other losses")
        _check(len(losses) == DP_FULL_STEPS and all(np.isfinite(losses)),
               f"opera_dp_full {tag} losses {losses}")
        half = DP_FULL_STEPS // 2
        _check(np.mean(losses[-half:]) < np.mean(losses[:half]),
               f"opera_dp_full {tag}: loss did not fall: {losses}")
        for k in range(DP_FULL_STEPS + 1):
            _check(len({str(r["prints"][k]) for r in per_rank}) == 1,
                   f"opera_dp_full {tag}: replicas differ at print {k}")
        for r in per_rank:
            _check(r["launches"] == {
                "flash_attention": 2 * L * DP_FULL_STEPS,
                "flash_attention_bwd": L * DP_FULL_STEPS},
                f"opera_dp_full {tag} launches {r['launches']}")
        step_ms = [float(np.median(r["run"]["step_s"][1:])) * 1e3
                   for r in per_rank]
        wire_ms = [float(np.median(r["run"]["wire_s"][1:])) * 1e3
                   for r in per_rank]
        runs[tag] = dict(
            losses=losses, train_full_losses=train_full["losses"][
                :DP_FULL_STEPS],
            grad_norms=run0["grad_norms"], lrs=run0["lrs"],
            step_ms_per_rank=step_ms, wire_ms_per_rank=wire_ms,
            wire_share=float(np.median(wire_ms) / np.median(step_ms)),
            sent_bytes_per_step_per_rank=[r["run"]["sent_bytes"][-1]
                                          for r in per_rank],
            peak_bytes_per_rank=[r["peak_bytes"] for r in per_rank],
            init_s=[r["run"]["init_s"] for r in per_rank],
            tokens_per_s=DP_FULL_B * DP_FULL_S
            / (float(np.median(step_ms)) / 1e3),
            flash_attention_launches=sum(r["launches"]["flash_attention"]
                                         for r in per_rank),
            flash_attention_bwd_launches=sum(
                r["launches"]["flash_attention_bwd"] for r in per_rank))
        print(f"opera_dp_full {tag} losses {losses} train_full "
              f"{runs[tag]['train_full_losses']}", flush=True)
    return dict(
        phase="opera_dp_full", arch="smollm-360m", layers=L, ranks=4,
        mesh={"data": 4, "model": 1}, batch=DP_FULL_B, seq=DP_FULL_S,
        steps=DP_FULL_STEPS, backend=ranks[0][0]["run"]["backend"],
        why=ranks[0][0]["why"], wall_s=wall, replicas_bit_equal=True, runs=runs,
        flash_attention_launches=sum(r["flash_attention_launches"]
                                     for r in runs.values()),
        flash_attention_bwd_launches=sum(r["flash_attention_bwd_launches"]
                                         for r in runs.values()))


class _Census:
    """While entered on a rank of a mesh of `shape` ({axis: size}, the
    ranks row-major), counts its collectives by kind and axis (`calls`,
    `payload` bytes: ``("all_reduce", "model", "SUM")``; a group is named
    by the axes its ranks' coordinates differ on, "data+model" for the
    world's), the (leaf, axis) pairs a gather on use sends over
    (`gathered`), the flash kernel's calls by their (query, KV) heads
    (`heads`), the moe_gmm kernel's by their experts (`experts`) and the
    scan kernels' launches by (kernel, channels) (`scans`:
    ``("mamba_scan_bwd", 2048)``), by wrapping `torch.distributed`'s
    collectives, `core.comm._gather_axis`, `models.sharding.use_leaf`
    (where `models.model` and `on_use` reach it),
    `models.attention.flash_attention`, `models.moe.moe_gmm` and the
    kernel wrappers the scans' ops call.  It reads names every tree of
    the port has had since its FSDP layout, so that `scripts/chip_ab.py`
    can run it on a parent's tree."""

    def __init__(self, shape: dict):
        import collections

        self.shape = dict(shape)
        self.names = {}
        self.calls = collections.Counter()
        self.payload = collections.Counter()
        self.gathered = collections.Counter()
        self.heads = collections.Counter()
        self.experts = collections.Counter()
        self.scans = collections.Counter()
        self._leaf = None
        self._saved = []

    def _wrap(self, owner, attr, make) -> None:
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def _name(self, group) -> str:
        import numpy as np
        import torch.distributed as dist

        if id(group) not in self.names:
            coords = np.array(np.unravel_index(
                dist.get_process_group_ranks(group),
                list(self.shape.values())))
            self.names[id(group)] = "+".join(
                a for a, c in zip(self.shape, coords) if len(set(c)) > 1)
        return self.names[id(group)]

    def _count(self, kind, group, op, t) -> None:
        key = (kind, self._name(group), op)
        self.calls[key] += 1
        self.payload[key] += t.numel() * t.element_size()

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.core import comm
        from repro_torch.kernels.mamba_scan import ops as mamba_ops
        from repro_torch.kernels.rglru_scan import ops as rglru_ops
        from repro_torch.models import attention, model, moe, sharding

        world = dist.group.WORLD

        def collective(kind, arg):
            def make(orig):
                def fn(*args, **kw):
                    op = kw.get("op", dist.ReduceOp.SUM)
                    self._count(kind, kw.get("group", world),
                                str(op).split(".")[-1] if kind == "all_reduce"
                                else "", args[arg])
                    return orig(*args, **kw)
                return fn
            return make

        for kind, arg in (("all_reduce", 0), ("all_gather", 1),
                          ("reduce_scatter", 0), ("all_to_all_single", 1)):
            self._wrap(dist, kind, collective(kind, arg))

        def p2p(orig):
            def fn(ops):
                for op in ops:
                    if op.op is dist.isend:
                        self._count("send", op.group, "", op.tensor)
                return orig(ops)
            return fn

        def use_leaf(orig):
            def fn(name, *args, **kw):
                self._leaf = name
                try:
                    return orig(name, *args, **kw)
                finally:
                    self._leaf = None
            return fn

        def gather_axis(orig):
            def fn(x, mesh, axis, dim):
                if self._leaf is not None:
                    self.gathered[(self._leaf, axis)] += 1
                return orig(x, mesh, axis, dim)
            return fn

        def flash(orig):
            def fn(q, k, v, *args, **kw):
                self.heads[(int(q.shape[1]), int(k.shape[1]))] += 1
                return orig(q, k, v, *args, **kw)
            return fn

        def gmm(orig):
            def fn(h, *args, **kw):
                self.experts[int(h.shape[0])] += 1
                return orig(h, *args, **kw)
            return fn

        def scan(name):
            def make(orig):
                def fn(x, *args, **kw):
                    self.scans[(name, int(x.shape[-1]))] += 1
                    return orig(x, *args, **kw)
                return fn
            return make

        for mod, fwd, bwd in ((mamba_ops, "mamba_scan_fwd", "mamba_scan_bwd"),
                              (rglru_ops, "rglru_scan_fwd",
                               "rglru_scan_bwd")):
            self._wrap(mod, fwd, scan(fwd[:-4]))
            self._wrap(mod, bwd, scan(bwd))
        self._wrap(dist, "batch_isend_irecv", p2p)
        self._wrap(moe, "moe_gmm", gmm)
        self._wrap(sharding, "use_leaf", use_leaf)
        self._wrap(model, "use_leaf", use_leaf)
        self._wrap(comm, "_gather_axis", gather_axis)
        self._wrap(attention, "flash_attention", flash)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()
        return False


FSDP_GOLDEN = "smollm_360m_reduced_fsdp_golden.npz"
TP_GOLDEN = "qwen15_110b_reduced_tp_golden.npz"


def _fsdp_blocks_err(got: dict, want: dict) -> tuple:
    """(largest distance, leaves outside TRAIN_TOL) of this rank's blocks
    `got` from `want`, both by leaf name."""
    worst, bad = 0.0, []
    for name, w in want.items():
        err = (got[name].detach() - w.detach()).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"]
                     * w.detach().abs()).all()):
            bad.append(name)
    return worst, bad


def _mesh_golden_rank(world, path: str, arch: str) -> dict:
    """The stored FSDP run of reduced `arch` on this rank
    (`make_train_step` under fsdp_tp at the stored mesh): per step the
    metrics, the largest distance of this rank's blocks of the parameters
    and both moments from the stored whole arrays' blocks (cut by
    `models.sharding.local_slice`), `_block_digests`, and whether every
    leaf the rules shard is held as a block; the kernels' launches."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import param_spec
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    stored = dict(np.load(path))
    cfg = reduced_config(get_config(arch)).replace(compute_dtype="float32")
    spec = json.loads(str(stored["mesh"]))
    mesh = Mesh(spec["shape"], spec["axes"])
    pctx = pctx_for_mesh(mesh)
    data = json.loads(str(stored["data"]))

    def blocks(prefix):
        return dict(params_from_numpy(cfg, tree_from_flat(
            {k[len(prefix):]: v for k, v in stored.items()
             if k.startswith(prefix)}), device=world.device, masters=True,
            pctx=pctx).named_parameters())

    state = init_train_state(cfg, params_from_numpy(
        cfg, tree_from_flat({k[len("param/"):]: v for k, v in stored.items()
                             if k.startswith("param/")}),
        device=world.device, masters=True, pctx=pctx))
    step = make_train_step(cfg, pctx, AdamWConfig(**json.loads(str(
        stored["opt"]))))
    src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                      seed=data["seed"])
    whole = param_shapes(cfg)
    rows = []
    launch_counts.clear()
    for i, batch in zip(range(len(stored["loss"])),
                        device_batches(src, 0, world.device)):
        state, m = step(state, batch)
        got = {"param": dict(state["params"].named_parameters()),
               "m": state["opt"]["m"], "v": state["opt"]["v"]}
        errs = {k: _fsdp_blocks_err(got[k], blocks(f"after{i + 1}/{k}/"))
                for k in got}
        cut = all(p.numel() < math.prod(whole[n])
                  for n, p in got["param"].items()
                  if any(param_spec(n, p.shape, cfg, pctx)))
        rows.append(dict(metrics={k: float(v) for k, v in m.items()},
                         max_abs_err={k: e[0] for k, e in errs.items()},
                         outside_tol=[f"{k}:{n}" for k, e in errs.items()
                                      for n in e[1]],
                         held=_block_digests(got["param"], cfg, pctx),
                         held_m=_block_digests(got["m"], cfg, pctx),
                         blocks_only=cut))
    n_cut = sum(1 for n, p in got["param"].items()
                if any(param_spec(n, p.shape, cfg, pctx)))
    return dict(rows=rows, launches=dict(launch_counts), leaves=len(whole),
                leaves_cut=n_cut, backend=world.backend, why=world.why,
                peak_bytes=torch.cuda.max_memory_allocated())


def phase_fsdp_golden(root: Path) -> dict:
    """The dense weights' FSDP / TP layout (`models.sharding`, fsdp_tp)
    in `train.trainer.make_train_step` on 4 ranks as `data` 2 x `model`
    2 on the one card: reduced smollm-360m in f32 from the stored
    weights, 3 steps held to the JAX package's GSPMD `make_train_step` on
    4 fake CPU devices with its parameters and moments placed as its
    launcher places them (src/repro_torch/data/
    smollm_360m_reduced_fsdp_golden.npz; `_mesh_golden`).  Attention (4 /
    2 heads), the FFN and the tied embedding compute tensor-parallel over
    `model`."""
    return _mesh_golden(root, "fsdp_golden", FSDP_GOLDEN, "smollm-360m")


def phase_tp_golden(root: Path) -> dict:
    """The tensor-parallel compute over `model` (`models.sharding.
    computes_tp`) in `make_train_step` under fsdp_tp on 4 ranks as `data`
    2 x `model` 2 on the one card: reduced qwen1.5-110b (QKV bias, untied
    head) in f32 from the stored weights, attention split by heads (2 / 1
    a rank), the FFN by width, the embedding and the head by vocab with
    the logsumexp combined over `model`; 3 steps held to the JAX
    package's GSPMD `make_train_step` on 4 fake CPU devices
    (src/repro_torch/data/qwen15_110b_reduced_tp_golden.npz;
    `_mesh_golden`)."""
    return _mesh_golden(root, "tp_golden", TP_GOLDEN, "qwen1.5-110b")


def _mesh_golden(root: Path, phase: str, fname: str, arch: str) -> dict:
    """A stored GSPMD run of reduced `arch` under fsdp_tp on 4 ranks as
    its stored mesh on the one card: losses, grad norms and lr within
    rtol 1e-5; each rank's blocks of the parameters and both moments
    after each step at atol/rtol 1e-5 of the stored whole arrays' blocks;
    every leaf the rules shard held as a block; the ranks that hold one
    block the same bits (the replicated norm scales on every rank); each
    rank's flash kernel 2 launches a layer a step and its backward 1."""
    import numpy as np

    from repro_torch.configs.base import get_config, reduced_config

    path = root / "src" / "repro_torch" / "data" / fname
    stored = dict(np.load(path))
    steps = len(stored["loss"])
    t0 = time.perf_counter()
    ranks = _ranks(_mesh_golden_rank, str(path), arch, timeout_s=300)
    ranks_s = time.perf_counter() - t0
    for i in range(steps):
        rows = [r["rows"][i] for r in ranks]
        _check_blocks([r["held"] for r in rows], f"{phase} step {i + 1}")
        _check_blocks([r["held_m"] for r in rows], f"{phase} m, step {i + 1}")
        for rank, r in enumerate(rows):
            _check(not r["outside_tol"] and r["blocks_only"],
                   f"{phase} rank {rank} step {i + 1}: "
                   f"{r['outside_tol'][:8]} blocks {r['blocks_only']}")
        _check(all(r["metrics"] == rows[0]["metrics"] for r in rows),
               f"{phase}: ranks report other metrics, step {i + 1}")
    for k in ("loss", "grad_norm", "lr"):
        got = np.array([r["metrics"][k] for r in ranks[0]["rows"]])
        rel = float(np.max(np.abs(got - stored[k]) / np.abs(stored[k])))
        _check(rel <= 1e-5, f"{phase} {k}: {got} != {stored[k]}")
    cfg = reduced_config(get_config(arch))
    want = _train_launches(cfg, {"flash_attention": "self_attn"}, steps)
    for r in ranks:
        _check(r["launches"] == want, f"{phase} launches {r['launches']}")
    mesh = json.loads(str(stored["mesh"]))
    return dict(
        phase=phase, arch=cfg.name, layers=cfg.num_layers,
        layout="fsdp_tp", mesh=dict(zip(mesh["axes"], mesh["shape"])),
        leaves=ranks[0]["leaves"], leaves_cut=ranks[0]["leaves_cut"],
        backend=ranks[0]["backend"], why=ranks[0]["why"], steps=steps,
        losses=[r["metrics"]["loss"] for r in ranks[0]["rows"]],
        jax_losses=stored["loss"].tolist(),
        grad_norms=[r["metrics"]["grad_norm"] for r in ranks[0]["rows"]],
        max_abs_err={k: max(s["max_abs_err"][k] for r in ranks
                            for s in r["rows"]) for k in ("param", "m", "v")},
        blocks_held_bit_equal=True, ranks_s=ranks_s,
        peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
        **{f"{k}_launches": sum(r["launches"][k] for r in ranks)
           for k in want})


# smollm-360m at full width and depth under fsdp_tp on (data 2, model 2):
# train_full's data and seed; global batch 8 (4 rows a data rank, each
# model rank of a row computing them), S 4096
# 4 steps, so that the script keeps within its 1,200 s
FSDP_FULL_STEPS, FSDP_FULL_B, FSDP_FULL_S = 4, 8, 4096
OPERA_DP_FULL_PEAK_GB = 13.06   # a rank's replica at data 4 (PERF.md 5)


def _fsdp_full_rank(world, batch: int) -> dict:
    """smollm-360m at full width through `launch.train.main` at
    ``--trainer gspmd --tp 2`` on this rank: the run, `_block_digests` of the
    parameters after every step (two int64 sums a block), this rank's
    bytes of the parameters and both moments, peak bytes and the
    kernels' launches."""
    import gc
    import types

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.parallel import ParallelContext

    shape, axes = (2, 2), ("data", "model")
    coords = dict(zip(axes, map(int, np.unravel_index(world.rank, shape))))
    pctx = ParallelContext(mesh=types.SimpleNamespace(
        shape=dict(zip(axes, shape)), coords=coords))
    cfg = get_config("smollm-360m")
    prints, held = [], {}

    def fingerprint(p):
        w = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        idx = torch.arange(1, w.numel() + 1, device=w.device)
        return torch.stack([w.sum(), (w * idx).sum()]).cpu().tolist()

    def on_step(step, state, metrics):
        prints.append(_block_digests(dict(state["params"].named_parameters()),
                                     cfg, pctx, fingerprint))
        held["state"] = {k: sum(t.numel() * t.element_size()
                                for t in (dict(state["params"]
                                               .named_parameters())
                                          if k == "params" else
                                          state["opt"][k]).values())
                         for k in ("params", "m", "v")}

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    with _Census(dict(zip(axes, shape))) as census:
        run = train_main(
            ["--arch", "smollm-360m", "--no-reduced", "--trainer", "gspmd",
             "--tp", "2", "--steps", str(FSDP_FULL_STEPS), "--batch",
             str(batch), "--seq", str(FSDP_FULL_S), "--log-every", "1",
             "--device", "cuda"], on_step=on_step)
    return dict(run=run, prints=prints, state_bytes=held["state"],
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches=dict(launch_counts), why=world.why,
                calls={"/".join(k): v for k, v in census.calls.items()})


def phase_fsdp_full(train_full: dict) -> dict:
    """smollm-360m at full width and depth (32 layers, d_model 960, vocab
    49,152), f32 masters from seed 0, bf16 compute, S 4096, global batch
    `FSDP_FULL_B`, train_full's data, through `launch.train.main` at
    ``--trainer gspmd --tp 2`` on 4 ranks as `data` 2 x `model` 2 on the
    one card (gloo, staged through host memory): every leaf and both
    moments held as the rank's block under fsdp_tp, gathered on use and
    reduce-scattered, `FSDP_FULL_STEPS` steps: every loss finite and
    falling (the last half below the first on average), the ranks of one
    block the same bits
    after every step, 2 flash launches a layer a step and 1 backward on
    every rank.  Prints step ms and the wire's ms within it, bytes sent,
    each rank's bytes of parameters and moments and its peak GB beside
    opera_dp_full's replica, and each step's loss beside train_full's
    (same seed and batches; printed, not gated)."""
    import os

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import param_shapes

    _free_card()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if FSDP_FULL_B != 8:
        print(f"reduced: {json.dumps({'global_batch': [8, FSDP_FULL_B]})} "
              "(4 ranks share the card's 80 GB)", flush=True)
    t0 = time.perf_counter()
    ranks = _ranks(_fsdp_full_rank, FSDP_FULL_B, timeout_s=600)
    wall = time.perf_counter() - t0
    cfg = get_config("smollm-360m")
    L = cfg.num_layers
    losses = ranks[0]["run"]["losses"]
    _check(all(r["run"]["losses"] == losses for r in ranks),
           "fsdp_full: ranks report other losses")
    _check(len(losses) == FSDP_FULL_STEPS and all(np.isfinite(losses)),
           f"fsdp_full losses {losses}")
    half = FSDP_FULL_STEPS // 2
    _check(np.mean(losses[-half:]) < np.mean(losses[:half]),
           f"fsdp_full: loss did not fall: {losses}")
    for k in range(FSDP_FULL_STEPS):
        _check_blocks([r["prints"][k] for r in ranks],
                    f"fsdp_full step {k + 1}")
    want = {"flash_attention": 2 * L * FSDP_FULL_STEPS,
            "flash_attention_bwd": L * FSDP_FULL_STEPS}
    for r in ranks:
        _check(r["launches"] == want, f"fsdp_full launches {r['launches']}")
    whole = 4 * sum(math.prod(s) for s in param_shapes(cfg).values())
    step_ms = [float(np.median(r["run"]["step_s"][1:])) * 1e3 for r in ranks]
    wire_ms = [float(np.median(r["run"]["wire_s"][1:])) * 1e3 for r in ranks]
    out = dict(
        phase="fsdp_full", arch=cfg.name, layers=L, layout="fsdp_tp",
        ranks=4, mesh={"data": 2, "model": 2}, batch=FSDP_FULL_B,
        seq=FSDP_FULL_S, steps=FSDP_FULL_STEPS,
        backend=ranks[0]["run"]["backend"], why=ranks[0]["why"], wall_s=wall,
        losses=losses, train_full_losses=train_full["losses"][
            :FSDP_FULL_STEPS],
        grad_norms=ranks[0]["run"]["grad_norms"], blocks_held_bit_equal=True,
        step_ms_per_rank=step_ms, wire_ms_per_rank=wire_ms,
        wire_share=float(np.median(wire_ms) / np.median(step_ms)),
        sent_bytes_per_step_per_rank=[r["run"]["sent_bytes"][-1]
                                      for r in ranks],
        state_bytes_per_rank=[r["state_bytes"] for r in ranks],
        whole_params_bytes=whole,
        peak_gb_per_rank=[r["peak_bytes"] / 1e9 for r in ranks],
        opera_dp_full_peak_gb=OPERA_DP_FULL_PEAK_GB,
        init_s=[r["run"]["init_s"] for r in ranks],
        collectives_per_step={k: v / FSDP_FULL_STEPS
                              for k, v in ranks[0]["calls"].items()},
        tokens_per_s=FSDP_FULL_B * FSDP_FULL_S / (np.median(step_ms) / 1e3),
        **{f"{k}_launches": sum(r["launches"][k] for r in ranks)
           for k in want})
    print(f"fsdp_full losses {losses} train_full {out['train_full_losses']} "
          f"step ms {step_ms} wire ms {wire_ms} peak GB "
          f"{out['peak_gb_per_rank']}", flush=True)
    return out


EP_GOLDEN = "qwen3_moe_30b_a3b_reduced_ep_golden.npz"
EP_DISPATCHES = ("rotor", "rotor_vlb", "xla")


def _block_digests(leaves: dict, cfg, pctx, digest=None) -> dict:
    """{leaf: (this rank's coordinates on the axes the leaf is cut over,
    `digest` of its block (SHA-256 of its bytes by default))} of `leaves`
    by name: two ranks of one key must hold the same bits."""
    import hashlib

    from repro_torch.models.sharding import sharded_axes

    def sha(p):
        return hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()

    digest = digest or sha
    return {n: (tuple(pctx.mesh.coords[a]
                      for a in sharded_axes(n, p.shape, cfg, pctx)),
                digest(p))
            for n, p in leaves.items()}


def _check_blocks(helds: list, tag: str) -> None:
    """Each rank's `_block_digests`: the ranks of one block of a leaf hold
    the same bits of it."""
    for name in helds[0]:
        blocks = {}
        for h in helds:
            coords, digest = h[name]
            blocks.setdefault(coords, set()).add(str(digest))
        _check(all(len(d) == 1 for d in blocks.values()),
               f"{tag}: the ranks of one block of {name} differ")


def _ep_golden_rank(world, path: str) -> dict:
    """The stored expert-parallel run on this rank, with each dispatch:
    per step the metrics, the largest distance of this rank's block of
    every leaf from the stored one (cut as the rank holds it),
    `_block_digests`; the kernels' launches a dispatch."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    stored = dict(np.load(path))
    cfg = reduced_config(get_config("qwen3-moe-30b-a3b")).replace(
        compute_dtype="float32")
    spec = json.loads(str(stored["mesh"]))
    mesh = Mesh(spec["shape"], spec["axes"])
    data = json.loads(str(stored["data"]))
    out = {}
    for dispatch in EP_DISPATCHES:
        pctx = pctx_for_mesh(mesh, moe_dispatch=dispatch)

        def tree(prefix, pctx=pctx):
            return params_from_numpy(cfg, tree_from_flat(
                {k[len(prefix):]: v for k, v in stored.items()
                 if k.startswith(prefix)}), device=world.device,
                masters=True, pctx=pctx)

        state = init_train_state(cfg, tree("param/"))
        step = make_train_step(cfg, pctx, AdamWConfig(**json.loads(str(
            stored["opt"]))))
        src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                          seed=data["seed"])
        rows = []
        launch_counts.clear()
        for i, batch in zip(range(len(stored["loss"])),
                            device_batches(src, 0, world.device)):
            state, m = step(state, batch)
            got = dict(state["params"].named_parameters())
            worst, bad = 0.0, []
            for name, w in tree(f"after{i + 1}/").named_parameters():
                err = (got[name].detach() - w.detach()).abs()
                worst = max(worst, float(err.max()))
                if not bool((err <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"]
                             * w.detach().abs()).all()):
                    bad.append(name)
            rows.append(dict(metrics={k: float(v) for k, v in m.items()},
                             params_max_abs_err=worst, outside_tol=bad,
                             held=_block_digests(dict(state["params"]
                                                      .named_parameters()),
                                                 cfg, pctx)))
        out[dispatch] = dict(rows=rows, launches=dict(launch_counts))
    return dict(runs=out, coords=mesh.coords, backend=world.backend,
                why=world.why, peak_bytes=torch.cuda.max_memory_allocated())


def phase_ep_golden(root: Path) -> dict:
    """Expert-parallel MoE training (`train.trainer.make_train_step` on a
    mesh, `models.moe`'s all-to-all branch) on 4 ranks as `data` 2 x
    `model` 2 on the one card: reduced qwen3-moe-30b-a3b (f32, 8 experts,
    4 a rank) from the JAX package's weights, 3 steps with each dispatch
    (rotor, rotor_vlb, xla) held to the JAX package's GSPMD
    `make_train_step` on 4 fake CPU devices
    (src/repro_torch/data/qwen3_moe_30b_a3b_reduced_ep_golden.npz: losses,
    grad norms and lr within rtol 1e-5, each rank's block of the
    parameters after each step at atol/rtol 1e-5; every leaf placed by
    the FSDP / TP rules, the dense ones cut too); the three dispatches the
    same bits; the ranks that hold one block of a leaf the same bits of
    it; each rank's moe_gmm (4 experts, 24 rows) and flash launches 2 a
    layer a step and their backward kernels 1."""
    import numpy as np

    from repro_torch.configs.base import get_config, reduced_config

    path = root / "src" / "repro_torch" / "data" / EP_GOLDEN
    stored = dict(np.load(path))
    steps = len(stored["loss"])
    t0 = time.perf_counter()
    ranks = _ranks(_ep_golden_rank, str(path), timeout_s=300)
    ranks_s = time.perf_counter() - t0
    cfg = reduced_config(get_config("qwen3-moe-30b-a3b"))
    want = _train_launches(cfg, {"flash_attention": "moe",
                                 "moe_gmm": "moe"}, steps)
    for d in EP_DISPATCHES:
        for i in range(steps):
            rows = [r["runs"][d]["rows"][i] for r in ranks]
            _check_blocks([r["held"] for r in rows],
                        f"ep_golden {d} step {i + 1}")
            for rank, r in enumerate(rows):
                _check(not r["outside_tol"],
                       f"ep_golden {d} rank {rank} step {i + 1}: "
                       f"{r['outside_tol'][:8]}")
                _check(r["held"] == ranks[rank]["runs"][
                    EP_DISPATCHES[0]]["rows"][i]["held"],
                       f"ep_golden {d} rank {rank}: not rotor's bits")
            _check(all(r["metrics"] == rows[0]["metrics"] for r in rows),
                   f"ep_golden {d}: ranks report other metrics")
        for k in ("loss", "grad_norm", "lr"):
            got = np.array([r["metrics"][k] for r in ranks[0]["runs"][d][
                "rows"]])
            rel = float(np.max(np.abs(got - stored[k]) / np.abs(stored[k])))
            _check(rel <= 1e-5, f"ep_golden {d} {k}: {got} != {stored[k]}")
        for r in ranks:
            _check(r["runs"][d]["launches"] == want,
                   f"ep_golden {d} launches {r['runs'][d]['launches']}")
    mesh = json.loads(str(stored["mesh"]))
    rows0 = ranks[0]["runs"]["rotor"]["rows"]
    return dict(
        phase="ep_golden", arch=cfg.name, layers=cfg.num_layers,
        mesh=dict(zip(mesh["axes"], mesh["shape"])),
        experts_per_rank=cfg.moe.num_experts // 2,
        dispatches=list(EP_DISPATCHES), backend=ranks[0]["backend"],
        why=ranks[0]["why"], steps=steps,
        losses=[r["metrics"]["loss"] for r in rows0],
        jax_losses=stored["loss"].tolist(),
        grad_norms=[r["metrics"]["grad_norm"] for r in rows0],
        params_max_abs_err=max(s["params_max_abs_err"] for r in ranks
                               for d in EP_DISPATCHES
                               for s in r["runs"][d]["rows"]),
        dispatches_bit_equal=True, replicas_bit_equal=True, ranks_s=ranks_s,
        peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
        **{f"{k}_launches": sum(r["runs"][d]["launches"][k] for r in ranks
                                for d in EP_DISPATCHES) for k in want})


# qwen3-moe-30b-a3b at full width on (data 1, model 4): 32 experts a
# rank; the untied embedding and head (2 x 311 M parameters) cut over the
# 4 ranks on their vocab dim and gathered on use
EP_FULL_LAYERS, EP_FULL_STEPS, EP_FULL_B, EP_FULL_S = 1, 6, 1, 2048
EP_FULL_WHY = ("4 ranks share the card's 80 GB; each needs ~2.7 GB a layer "
               "(experts at tp 4 and attention) and ~2.5 GB a copy of the "
               "f32 logits at S 4096, of which the loss's backward holds "
               "several: with the embedding and head replicated (~10 GB a "
               "rank of f32 masters, gradients and two moments) 2 layers at "
               "S 4096 and 1 layer at S 4096 ran out of it (18.3 GiB a rank)")


def _ep_full_rows() -> tuple:
    """(experts, rows) of a rank's moe_gmm in ep_full: E / 4 experts,
    the 4 ranks' capacity buffers of B S / 4 tokens each."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.moe import _capacity

    m = get_config("qwen3-moe-30b-a3b").moe
    c = _capacity(EP_FULL_B * EP_FULL_S // 4, m.top_k, m.num_experts,
                  m.capacity_factor)
    return m.num_experts // 4, 4 * c


def _ep_full_rank(world, layers: int) -> dict:
    """qwen3-moe at full width cut to `layers`, its experts over 4 model
    ranks, rotor dispatch: `make_train_step` from seed 0 on this rank.
    Per step the loss, host seconds, bytes sent and host seconds on the
    wire; a fingerprint of the replicated leaves after every step; the
    first batch's loss after the last step; peak bytes and the kernels'
    launches."""
    import gc

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params, loss_fn, param_shapes
    from repro_torch.models.sharding import param_spec
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import (init_train_state, make_train_step,
                                           shard_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-moe-30b-a3b").replace(num_layers=layers)
    mesh = Mesh((1, 4), ("data", "model"))
    pctx = pctx_for_mesh(mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=world.device, masters=True,
                         pctx=pctx)
    state = init_train_state(cfg, params)
    gc.collect()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, pctx, AdamWConfig(
        lr=1e-3, total_steps=EP_FULL_STEPS, warmup_steps=5))
    batches = list(zip(range(EP_FULL_STEPS), device_batches(SyntheticLM(
        cfg.vocab_size, EP_FULL_S, EP_FULL_B, seed=0), 0, world.device)))
    launch_counts.clear()
    run = dict(losses=[], step_s=[], sent_bytes=[], wire_s=[], prints=[])
    census = _Census(mesh.shape)
    for _, batch in batches:
        t0 = time.perf_counter()
        sent, wire = mesh.sent_bytes, mesh.wire_s
        with census:
            state, m = step(state, batch)
        run["losses"].append(float(m["loss"]))   # waits for the step
        run["step_s"].append(time.perf_counter() - t0)
        run["sent_bytes"].append(mesh.sent_bytes - sent)
        run["wire_s"].append(mesh.wire_s - wire)
        run["prints"].append(_dp_fingerprint(
            state["params"],
            lambda n, p: not any(param_spec(n, p.shape, cfg, pctx))))
        if world.rank == 0:
            print(f"[ep_full] step {len(run['losses'])} loss "
                  f"{run['losses'][-1]:.4f} {run['step_s'][-1]:.2f} s, "
                  f"{run['wire_s'][-1]:.2f} s on the wire", flush=True)
    launches = dict(launch_counts)
    with torch.no_grad():   # the first batch again, after the last step
        first = loss_fn(state["params"], shard_batch(batches[0][1], pctx),
                        cfg, pctx)[1]["loss"]
    n_params = sum(math.prod(s) for s in param_shapes(cfg).values())
    return dict(run, first_batch_after=float(first), launches=launches,
                calls={"/".join(k): v for k, v in census.calls.items()},
                init_s=init_s, params=n_params,
                peak_bytes=torch.cuda.max_memory_allocated(),
                why=world.why, backend=world.backend)


def phase_ep_full() -> dict:
    """qwen3-moe-30b-a3b at full width (d 2048, 128 experts, top 8, F 768,
    vocab 151,936) cut to `EP_FULL_LAYERS` layers and S `EP_FULL_S`
    (printed as `reduced` with the reason), f32 masters from seed 0, bf16
    compute, full remat, B 1, on 4 ranks as `data` 1 x `model` 4 on the
    one card (32 experts a rank, rotor dispatch; gloo staged through host
    memory), `EP_FULL_STEPS` steps of `make_train_step`: every loss
    finite, the first batch's loss lower after the run than at its
    step, the four ranks the
    same bits of the replicated leaves after every step and the same
    losses, the parameter count `count_params`'s, each rank's moe_gmm
    (`_ep_full_rows`) and flash launches 2 a layer a step and their
    backward kernels 1.  Prints step ms, the wire's ms and bytes a rank,
    and peak GB a rank."""
    import os

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import count_params

    _free_card()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    full = get_config("qwen3-moe-30b-a3b")
    cfg = full.replace(num_layers=EP_FULL_LAYERS)
    reduced = {"num_layers": [full.num_layers, EP_FULL_LAYERS],
               "seq": [4096, EP_FULL_S], "global_batch": [256, EP_FULL_B]}
    print(f"reduced: {json.dumps(reduced)} ({EP_FULL_WHY})", flush=True)
    t0 = time.perf_counter()
    ranks = _ranks(_ep_full_rank, EP_FULL_LAYERS, timeout_s=600)
    wall = time.perf_counter() - t0
    losses = ranks[0]["losses"]
    _check(all(r["losses"] == losses for r in ranks),
           "ep_full: ranks report other losses")
    _check(len(losses) == EP_FULL_STEPS and all(np.isfinite(losses)),
           f"ep_full losses {losses}")
    # B S = 2,048 tokens a step move a 151,936-word loss slowly: the
    # first batch is held to its own loss after the run
    after = ranks[0]["first_batch_after"]
    _check(all(r["first_batch_after"] == after for r in ranks)
           and after < losses[0],
           f"ep_full: the first batch's loss {losses[0]} -> {after}")
    for k in range(EP_FULL_STEPS):
        _check(len({str(r["prints"][k]) for r in ranks}) == 1,
               f"ep_full: replicas differ after step {k + 1}")
    _check(ranks[0]["params"] == count_params(cfg),
           f"ep_full params {ranks[0]['params']}")
    want = _train_launches(cfg, {"flash_attention": "moe",
                                 "moe_gmm": "moe"}, EP_FULL_STEPS)
    for r in ranks:
        _check(r["launches"] == want, f"ep_full launches {r['launches']}")
    step_ms = [float(np.median(r["step_s"][1:])) * 1e3 for r in ranks]
    wire_ms = [float(np.median(r["wire_s"][1:])) * 1e3 for r in ranks]
    out = dict(
        phase="ep_full", arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, experts=cfg.moe.num_experts,
        experts_per_rank=cfg.moe.num_experts // 4, top_k=cfg.moe.top_k,
        vocab=cfg.vocab_size, params=ranks[0]["params"], reduced=reduced,
        reduced_why=EP_FULL_WHY, mesh={"data": 1, "model": 4},
        dispatch="rotor", batch=EP_FULL_B, seq=EP_FULL_S,
        steps=EP_FULL_STEPS, backend=ranks[0]["backend"],
        why=ranks[0]["why"], wall_s=wall, losses=losses,
        first_batch_after=after, replicas_bit_equal=True,
        step_ms_per_rank=step_ms,
        wire_ms_per_rank=wire_ms,
        wire_share=float(np.median(wire_ms) / np.median(step_ms)),
        sent_bytes_per_step_per_rank=[r["sent_bytes"][-1] for r in ranks],
        peak_gb_per_rank=[r["peak_bytes"] / 1e9 for r in ranks],
        init_s=[r["init_s"] for r in ranks],
        collectives_per_step={k: v / EP_FULL_STEPS
                              for k, v in ranks[0]["calls"].items()},
        tokens_per_s=EP_FULL_B * EP_FULL_S / (np.median(step_ms) / 1e3),
        **{f"{k}_launches": sum(r["launches"][k] for r in ranks)
           for k in want})
    print(f"ep_full losses {losses} step ms {step_ms} wire ms {wire_ms} "
          f"peak GB {out['peak_gb_per_rank']}", flush=True)
    return out


# yi-9b at full width on (data 1, model 4): 32 / 4 heads split 8 / 1 a
# rank, the FFN's 11,008 and the vocabulary's 64,000 by 4; the depth the
# card's 80 GB hold for four ranks
TP_FULL_LAYERS, TP_FULL_STEPS, TP_FULL_B, TP_FULL_S = 12, 6, 1, 4096
TP_FULL_WHY = ("4 ranks share the card's 80 GB; at 16 B a parameter "
               "(f32 masters, gradients and two moments) a layer needs "
               "~2.8 GB and the embedding and head ~8.4 GB, beside each "
               "rank's activations, and after them the one-rank run on "
               "whole weights (~47 GB at 12 layers); 16 layers fit too "
               "(PERF.md), but not the script's 1,200 s")
# the launcher's 1e-3 makes the loss rise from step 5 at this depth and
# batch, on 4 model ranks and on one rank alike (ROADMAP Queue 3, U2)
TP_FULL_LR = 3e-4


def _tp_full_rank(world, layers: int, lr: float) -> dict:
    """yi-9b at full width cut to `layers` on 4 model ranks under
    fsdp_tp: `make_train_step` from seed 0 on this rank, the launcher's
    AdamW.  Per step the loss, host seconds, bytes sent and host seconds
    on the wire, a fingerprint of the replicated leaves; the collectives
    a step (`_Census`), the leaves gathered over each axis, the flash
    calls by heads; which leaves compute tensor-parallel and which the
    rules cut over `model` (in this tree); this rank's bytes of the
    parameters and both moments, peak bytes, the kernels' launches."""
    import gc

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models import sharding
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.models.sharding import param_spec
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("yi-9b").replace(num_layers=layers)
    mesh = Mesh((1, 4), ("data", "model"))
    pctx = pctx_for_mesh(mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, init_params(cfg, 0, device=world.device,
                                              masters=True, pctx=pctx))
    gc.collect()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, pctx, AdamWConfig(
        lr=lr, total_steps=TP_FULL_STEPS, warmup_steps=5))
    batches = device_batches(SyntheticLM(cfg.vocab_size, TP_FULL_S,
                                         TP_FULL_B, seed=0), 0, world.device)
    # a tree from before the tensor-parallel compute has no predicate:
    # every leaf is computed whole there
    tp = getattr(sharding, "computes_tp", lambda *a: False)
    whole = param_shapes(cfg)
    launch_counts.clear()
    run = dict(losses=[], grad_norms=[], step_s=[], sent_bytes=[],
               wire_s=[], prints=[])
    with _Census(mesh.shape) as census:
        for _, batch in zip(range(TP_FULL_STEPS), batches):
            t0 = time.perf_counter()
            sent, wire = mesh.sent_bytes, mesh.wire_s
            state, m = step(state, batch)
            run["losses"].append(float(m["loss"]))   # waits for the step
            run["step_s"].append(time.perf_counter() - t0)
            run["grad_norms"].append(float(m["grad_norm"]))
            run["sent_bytes"].append(mesh.sent_bytes - sent)
            run["wire_s"].append(mesh.wire_s - wire)
            run["prints"].append(_dp_fingerprint(
                state["params"],
                lambda n, p: not any(param_spec(n, p.shape, cfg, pctx))))
            if world.rank == 0:
                print(f"[tp_full] step {len(run['losses'])} loss "
                      f"{run['losses'][-1]:.4f} {run['step_s'][-1]:.2f} s, "
                      f"{run['wire_s'][-1]:.2f} s on the wire", flush=True)
    held = {k: sum(t.numel() * t.element_size() for t in (
        dict(state["params"].named_parameters()) if k == "params"
        else state["opt"][k]).values()) for k in ("params", "m", "v")}
    return dict(
        run, init_s=init_s, launches=dict(launch_counts),
        calls={"/".join(k): v for k, v in census.calls.items()},
        payload={"/".join(k): v for k, v in census.payload.items()},
        gathered=sorted(census.gathered),
        heads={f"{q}/{kv}": n for (q, kv), n in census.heads.items()},
        tp=sorted(n for n in whole if tp(n, cfg, pctx)),
        model_cut=sorted(n for n, s in whole.items()
                         if "model" in param_spec(n, s, cfg, pctx)),
        state_bytes=held, peak_bytes=torch.cuda.max_memory_allocated(),
        why=world.why, backend=world.backend)


def _tp_full_whole(layers: int, lr: float) -> dict:
    """The tp_full run in this process on whole weights (`make_train_step`
    without a mesh, one rank): the same seed-0 draws, batches and AdamW;
    per step the loss and the gradient norm, and the host seconds."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.models.model import init_params
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    _free_card()
    cfg = get_config("yi-9b").replace(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, init_params(cfg, 0, device="cuda",
                                              masters=True))
    step = make_train_step(cfg, single_device_ctx(), AdamWConfig(
        lr=lr, total_steps=TP_FULL_STEPS, warmup_steps=5))
    run = dict(losses=[], grad_norms=[], step_s=[])
    for _, batch in zip(range(TP_FULL_STEPS), device_batches(SyntheticLM(
            cfg.vocab_size, TP_FULL_S, TP_FULL_B, seed=0), 0, "cuda")):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        run["losses"].append(float(m["loss"]))   # waits for the step
        run["step_s"].append(time.perf_counter() - t0)
        run["grad_norms"].append(float(m["grad_norm"]))
    run["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, step
    _free_card()
    return run


def phase_tp_full() -> dict:
    """yi-9b at full width (d 4,096, 32 / 4 heads of 128, FFN 11,008,
    vocab 64,000, untied head) cut to `TP_FULL_LAYERS` of 48 layers
    (printed as `reduced` with the reason), f32 masters from seed 0, bf16
    compute, full remat, B 1, S 4096, on 4 ranks as `data` 1 x `model` 4
    on the one card (gloo staged through host memory), `TP_FULL_STEPS`
    steps of `make_train_step` under fsdp_tp: attention split by heads (8
    / 1 a rank), the FFN by width, the embedding and the head by vocab
    (`models.sharding.computes_tp`).  Then the same run in this process
    on whole weights, one rank (`_tp_full_whole`).  Every loss finite and
    falling (the last 3 below the first 3 on average), the same on every
    rank and within bf16's 2e-2 of the one rank's, the first step's
    gradient norm too; the
    replicated leaves the same bits on every rank after every step; the
    leaves gathered over `model` exactly the leaves the rules cut over it
    that do not compute tensor-parallel (`final_norm`'s scale alone);
    each rank's state its blocks, about a quarter of the whole; flash 2
    launches a layer a step and its backward 1.  Prints step ms and the
    wire's ms and bytes within it, the collectives a step by kind and
    axis, the flash calls by heads, state bytes and peak GB a rank."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import param_shapes

    _free_card()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    full = get_config("yi-9b")
    cfg = full.replace(num_layers=TP_FULL_LAYERS)
    reduced = {"num_layers": [full.num_layers, TP_FULL_LAYERS],
               "global_batch": [256, TP_FULL_B]}
    print(f"reduced: {json.dumps(reduced)} ({TP_FULL_WHY})", flush=True)
    t0 = time.perf_counter()
    ranks = _ranks(_tp_full_rank, TP_FULL_LAYERS, TP_FULL_LR, timeout_s=900)
    wall = time.perf_counter() - t0
    whole_run = _tp_full_whole(TP_FULL_LAYERS, TP_FULL_LR)
    losses = ranks[0]["losses"]
    step_ms = [float(np.median(r["step_s"][1:])) * 1e3 for r in ranks]
    wire_ms = [float(np.median(r["wire_s"][1:])) * 1e3 for r in ranks]
    print(f"tp_full losses {losses} grad norms {ranks[0]['grad_norms']}; "
          f"whole weights on one rank {whole_run['losses']} grad norms "
          f"{whole_run['grad_norms']}; step ms {step_ms} wire ms {wire_ms} "
          f"peak GB {[r['peak_bytes'] / 1e9 for r in ranks]}", flush=True)
    _check(all(r["losses"] == losses for r in ranks),
           "tp_full: ranks report other losses")
    _check(len(losses) == TP_FULL_STEPS and all(np.isfinite(losses)),
           f"tp_full losses {losses}")
    # the one rank's compute on whole weights, in bf16's tolerance: every
    # loss, and the first step's gradient norm (the same parameters and
    # batch)
    tol = _tol(torch.bfloat16)
    _check(np.allclose(losses, whole_run["losses"], rtol=tol, atol=0),
           f"tp_full losses {losses} against one rank's "
           f"{whole_run['losses']}")
    _check(np.isclose(ranks[0]["grad_norms"][0], whole_run["grad_norms"][0],
                      rtol=tol, atol=0),
           f"tp_full first grad norm {ranks[0]['grad_norms'][0]} against "
           f"one rank's {whole_run['grad_norms'][0]}")
    _check(np.mean(losses[-3:]) < np.mean(losses[:3]),
           f"tp_full: loss did not fall: {losses}")
    for k in range(TP_FULL_STEPS):
        _check(len({str(r["prints"][k]) for r in ranks}) == 1,
               f"tp_full: replicated leaves differ after step {k + 1}")
    for r in ranks:
        over_model = {leaf for leaf, axis in r["gathered"] if axis == "model"}
        want = set(r["model_cut"]) - set(r["tp"])
        _check(over_model == want, f"tp_full: gathered over model "
               f"{sorted(over_model ^ want)[:8]} against the plan")
    shapes = param_shapes(cfg)
    whole = 4 * sum(math.prod(s) for s in shapes.values())
    for r in ranks:
        _check(r["state_bytes"]["params"] < whole / 4 * 1.01,
               f"tp_full: a rank holds {r['state_bytes']} of {whole} B")
    want = _train_launches(cfg, {"flash_attention": "self_attn"},
                           TP_FULL_STEPS)
    for r in ranks:
        _check(r["launches"] == want, f"tp_full launches {r['launches']}")
    out = dict(
        phase="tp_full", arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, reduced=reduced,
        reduced_why=TP_FULL_WHY, layout="fsdp_tp",
        mesh={"data": 1, "model": 4}, batch=TP_FULL_B, seq=TP_FULL_S,
        steps=TP_FULL_STEPS, backend=ranks[0]["backend"],
        why=ranks[0]["why"], wall_s=wall, lr=TP_FULL_LR, losses=losses,
        grad_norms=ranks[0]["grad_norms"], whole_losses=whole_run["losses"],
        whole_grad_norms=whole_run["grad_norms"],
        whole_step_ms=float(np.median(whole_run["step_s"][1:])) * 1e3,
        whole_peak_gb=whole_run["peak_bytes"] / 1e9,
        replicated_bit_equal=True, tp_leaves=len(ranks[0]["tp"]),
        leaves=len(shapes),
        gathered_over_model=sorted({leaf for leaf, axis in ranks[0][
            "gathered"] if axis == "model"}),
        step_ms_per_rank=step_ms, wire_ms_per_rank=wire_ms,
        wire_share=float(np.median(wire_ms) / np.median(step_ms)),
        sent_bytes_per_step_per_rank=[r["sent_bytes"][-1] for r in ranks],
        collectives_per_step={k: v / TP_FULL_STEPS
                              for k, v in ranks[0]["calls"].items()},
        payload_bytes_per_step={k: v / TP_FULL_STEPS
                                for k, v in ranks[0]["payload"].items()},
        flash_calls_by_heads=ranks[0]["heads"],
        state_bytes_per_rank=[r["state_bytes"] for r in ranks],
        whole_params_bytes=whole,
        peak_gb_per_rank=[r["peak_bytes"] / 1e9 for r in ranks],
        init_s=[r["init_s"] for r in ranks],
        tokens_per_s=TP_FULL_B * TP_FULL_S / (np.median(step_ms) / 1e3),
        **{f"{k}_launches": sum(r["launches"][k] for r in ranks)
           for k in want})
    return out


# ---------------- serving over a mesh ----------------------------------------

SERVE_MESH_GOLDEN = "qwen3_moe_30b_a3b_reduced_serve_mesh_golden.npz"
# qwen3-moe-30b-a3b at full width on (data 1, model 4): 32 / 4 heads of
# 128 (8 / 1 a rank), 128 experts (32 a rank), 151,936 words (37,984 a
# rank); 4 slots of 1,024 positions (cut by positions: 256 a rank);
# prompts of odd lengths, so that every prefill takes the MoE's local
# branch, whose capacity is the one-rank run's
SERVE_MESH_LAYERS = 12
SERVE_MESH_SLOTS, SERVE_MESH_SEQ, SERVE_MESH_NEW = 4, 1024, 8
SERVE_MESH_LENS = (455, 373, 325, 231, 247, 143, 157, 135)
# the limit of the free one-rank run's distance (each prefill's largest
# logit distance over its largest magnitude), between a one-rank run that
# rounds otherwise and one with a wrong kernel (`_serve_mesh_whole`)
SERVE_MESH_FREE_LIMIT = 0.1
SERVE_MESH_WHY = ("the script's 1,200 s, not the card's 80 GB: a rank "
                  "holds ~4 GB of bf16 weights at 12 layers, ~15 GB at 48")


class _Logits:
    """While entered, keeps the logits every `forward_prefill` and
    `forward_decode` of `serve.engine` returns (each a copy on the
    host), and of a `_Census` the collectives the decode ticks issue
    (`tick_calls`)."""

    def __init__(self, census=None):
        import collections

        self.census = census
        self.tick_calls = collections.Counter()

    def __enter__(self):
        from repro_torch.serve import engine

        self.prefill, self.tick = [], []
        self._saved = (engine.forward_prefill, engine.forward_decode)
        pf, dc = self._saved

        def prefill(*args, **kw):
            out = pf(*args, **kw)
            self.prefill.append(out[0].float().cpu())
            return out

        def decode(*args, **kw):
            before = dict(self.census.calls) if self.census else {}
            out = dc(*args, **kw)
            self.tick.append(out[0].float().cpu())
            if self.census:
                self.tick_calls.update({k: v - before.get(k, 0) for k, v in
                                        self.census.calls.items()})
            return out

        engine.forward_prefill, engine.forward_decode = prefill, decode
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import engine

        engine.forward_prefill, engine.forward_decode = self._saved
        return False


class _Routes:
    """While entered, keeps the experts each `models.moe._topk_route` call
    picks, in call order, each token's margin between its k-th and
    (k+1)-th router probabilities, and the gap between its k-th and
    (k+1)-th router logits over its largest logit magnitude; given
    `replay`, a run's kept picks, each call takes the picks of the same
    call there instead, its gates renormalised over them as the router
    renormalises its own."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.picks, self.margins, self.gaps = [], [], []
        self._orig = route = moe._topk_route

        def topk_route(logits, k):
            gates, idx, probs = route(logits, k)
            if self.replay is not None:
                idx = self.replay[len(self.picks)].to(idx.device)
                vals = torch.gather(probs, -1, idx)
                gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
            top = torch.topk(probs, k + 1, dim=-1).values
            lt = torch.topk(logits.float(), k + 1, dim=-1).values
            self.picks.append(idx.cpu())
            self.margins.append((top[:, k - 1] - top[:, k]).cpu())
            self.gaps.append(((lt[:, k - 1] - lt[:, k])
                              / logits.float().abs().amax(-1)).cpu())
            return gates, idx, probs

        moe._topk_route = topk_route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._topk_route = self._orig
        return False


def _serve_mesh_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in SERVE_MESH_LENS]


def _serve(cfg, params, pctx, slots, max_seq, prompts, new, device,
           census=None):
    """A `ServeEngine` on `prompts` to completion: (the engine, each
    request's tokens, the recorded logits (`_Logits` of `census`), the
    kernels' launches)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, pctx, slots=slots, max_seq=max_seq,
                      device=device)
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    launch_counts.clear()
    with _Logits(census) as logits:
        done = eng.run_to_completion(max_ticks=400)
    _check(len(done) == len(prompts),
           f"served {len(done)} of {len(prompts)} requests")
    return (eng, {r.rid: r.out_tokens for r in done}, logits,
            dict(launch_counts))


def _serve_mesh_golden_rank(world, path: str, mesh) -> dict:
    """The stored JAX mesh run (`serve_mesh_golden`) on this rank: the
    tokens, the largest distance of every prefill's and tick's logits
    from the stored ones and whether each is within 1e-4, the launches,
    the flash calls by heads and the moe_gmm calls by experts."""
    import numpy as np

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat

    stored = dict(np.load(path))
    cfg = reduced_config(get_config(ARCH)).replace(
        compute_dtype="float32", **json.loads(str(stored["config"])))
    pctx = pctx_for_mesh(mesh)
    params = params_from_numpy(cfg, tree_from_flat(
        {k[len("param/"):]: v for k, v in stored.items()
         if k.startswith("param/")}), device=world.device, pctx=pctx)
    prompts = [stored[f"prompt/{i}"] for i in range(sum(
        1 for k in stored if k.startswith("prompt/")))]
    t0 = time.perf_counter()
    with _Census(mesh.shape) as census:
        eng, tokens, logits, launches = _serve(
            cfg, params, pctx, int(stored["slots"]), int(stored["max_seq"]),
            prompts, int(stored["max_new"]), world.device)
    seconds = time.perf_counter() - t0
    return dict(tokens=tokens, errs=_logits_errs(logits, stored, ""),
                launches=launches, heads=dict(census.heads),
                experts=dict(census.experts),
                prefills=eng.prefills, ticks=eng.ticks, seconds=seconds,
                layers=cfg.num_layers, backend=world.backend, why=world.why)


def _serve_mesh_full_rank(world, mesh, layers: int) -> dict:
    """qwen3-moe-30b-a3b at full width cut to `layers` on this rank of
    (data 1, model 4), seed-0 bf16 weights, `SERVE_MESH_SLOTS` slots of
    `SERVE_MESH_SEQ`: the tokens, the prefills' logits (rank 0) and the
    count of ticks with non-finite logits, prefill and tick host seconds
    with the wire's within them and the bytes sent, the collectives by
    kind and axis, the flash calls by heads and the moe_gmm calls by
    experts, the launches and the peak bytes."""
    import gc

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params

    cfg = get_config(ARCH).replace(num_layers=layers)
    pctx = pctx_for_mesh(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=world.device, pctx=pctx)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _serve_mesh_prompts(cfg.vocab_size)
    with torch.no_grad(), _Census(mesh.shape) as census, _Routes() as routes:
        eng, tokens, logits, launches = _serve(
            cfg, params, pctx, SERVE_MESH_SLOTS, SERVE_MESH_SEQ, prompts,
            SERVE_MESH_NEW, world.device, census)
    out = dict(
        tokens=tokens, init_s=init_s, prefills=eng.prefills, ticks=eng.ticks,
        nonfinite_ticks=sum(1 for t in logits.tick
                            if not bool(torch.isfinite(t).all())),
        prefill_s=eng.prefill_s, prefill_wire_s=eng.prefill_wire_s,
        prefill_sent=eng.prefill_sent, decode_s=eng.decode_s,
        decode_wire_s=eng.decode_wire_s, decode_sent=eng.decode_sent,
        prefill_tokens=eng.prefill_tokens,
        calls={"/".join(k): v for k, v in census.calls.items()},
        tick_calls={"/".join(k): v for k, v in logits.tick_calls.items()},
        payload={"/".join(k): v for k, v in census.payload.items()},
        heads={f"{q}/{kv}": n for (q, kv), n in census.heads.items()},
        experts=dict(census.experts), launches=launches,
        param_bytes=sum(p.numel() * p.element_size()
                        for p in params.parameters()),
        cache_bytes=sum(t.numel() * t.element_size()
                        for c in eng.cache for t in c.values()),
        cuts=sorted({how for c in eng.cache.cuts for how in c.values()}),
        peak_bytes=torch.cuda.max_memory_allocated())
    if world.rank == 0:   # numpy: a tensor crosses as a handle to this
        # process's memory, which ends with it
        out.update(prefill_logits=torch.cat(logits.prefill).numpy(),
                   picks=[p.numpy() for p in routes.picks])
    del params, eng
    return out


def _serve_mesh_rank(world, golden_path: str, layers: int) -> dict:
    """Both serving-over-a-mesh phases on this rank, in one world."""
    import torch

    from repro_torch.core.comm import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh((1, 4), ("data", "model"))
    golden = _serve_mesh_golden_rank(world, golden_path, mesh)
    return dict(golden=golden,
                full=_serve_mesh_full_rank(world, mesh, layers))


class _Flash:
    """While entered, `models.attention`'s flash calls take q, k and v
    in f32 and round the output back (``"f32"``: the f32 kernel, a run
    that rounds otherwise than bf16's), or read the KV heads rolled by
    one (``"rolled"``: each query group attends another group's keys and
    values, as a kernel or a cut that mixes up heads would)."""

    def __init__(self, how: str):
        self.how = how

    def __enter__(self):
        from repro_torch.models import attention

        self._orig = flash = attention.flash_attention

        def f32(q, k, v, **kw):
            return flash(q.float(), k.float(), v.float(), **kw).to(q.dtype)

        def rolled(q, k, v, **kw):
            return flash(q, k.roll(1, 1), v.roll(1, 1), **kw)

        attention.flash_attention = {"f32": f32, "rolled": rolled}[self.how]
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention

        attention.flash_attention = self._orig
        return False


# the one-rank runs of serve_mesh_full's requests on whole weights: (name,
# the mesh's routes replayed, the flash variant)
SERVE_MESH_WHOLE_RUNS = (("free", False, None), ("held", True, None),
                         ("witness", False, "f32"), ("wrong", False, "rolled"))


def _serve_mesh_whole(layers: int, picks: list) -> dict:
    """serve_mesh_full's requests in this process on whole weights, one
    rank, four times (`SERVE_MESH_WHOLE_RUNS`): as they come (``free``:
    its tokens, each prefill's logits, the routes with their margins and
    gaps, host seconds, peak bytes); with the mesh's `picks` of every
    router call replayed (``held``); with the attention in f32 (the
    rounding ``witness``); and with the KV heads rolled (a ``wrong``
    kernel)."""
    import contextlib

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.parallel import single_device_ctx

    _free_card()
    cfg = get_config(ARCH).replace(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device="cuda")
    out = {}
    for name, replay, flash in SERVE_MESH_WHOLE_RUNS:
        with (torch.no_grad(), _Routes(picks if replay else None) as routes,
              _Flash(flash) if flash else contextlib.nullcontext()):
            eng, tokens, logits, _ = _serve(
                cfg, params, single_device_ctx(), SERVE_MESH_SLOTS,
                SERVE_MESH_SEQ, _serve_mesh_prompts(cfg.vocab_size),
                SERVE_MESH_NEW, "cuda")
        out[name] = dict(tokens=tokens,
                         prefill_logits=torch.cat(logits.prefill),
                         picks=routes.picks, margins=routes.margins,
                         gaps=routes.gaps, prefill_s=eng.prefill_s,
                         decode_s=eng.decode_s, ticks=eng.ticks,
                         prefills=eng.prefills)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, eng
    _free_card()
    return out


def _route_flips(mesh_picks: list, run: dict, slots: int,
                 layers: int = 0) -> dict:
    """The prefills' router decisions (a token's set of experts in a
    layer) that the mesh and one rank take apart, and the one rank's
    margins (its k-th less its (k+1)-th probability) and gaps (the same
    of its router logits, over their largest magnitude) at them and at
    all; given `layers`, the first layer's alone (a prefill routes once a
    layer, and every layer of qwen3-moe is an MoE).  A prefill's call
    routes more tokens than the slots, and both runs prefill the same
    prompts in the same order."""
    import torch

    def prefills(calls):
        got = [i for i, a in enumerate(calls) if a.shape[0] > slots]
        return got[::layers] if layers else got

    flips, total, at_flips, gaps, every = 0, 0, [], [], []
    for i, j in zip(prefills(mesh_picks), prefills(run["picks"])):
        a, b = mesh_picks[i], run["picks"][j]
        apart = (a.sort(-1).values != b.sort(-1).values).any(-1)
        flips += int(apart.sum())
        total += a.shape[0]
        at_flips.append(run["margins"][j][apart])
        gaps.append(run["gaps"][j][apart])
        every.append(run["margins"][j])
    at_flips, gaps = torch.cat(at_flips), torch.cat(gaps)
    every = torch.cat(every)
    return dict(prefill_decisions=total, flipped=flips,
                max_margin_at_flips=float(at_flips.max()) if flips else 0.0,
                max_gap_at_flips=float(gaps.max()) if flips else 0.0,
                median_margin=float(every.median()))


def phase_serve_mesh(root: Path) -> dict:
    """Serving over a mesh (`ServeEngine` with a mesh context,
    `models.sharding.cache_spec`), 4 ranks as `data` 1 x `model` 4 on the
    one card (gloo staged through host memory), both phases in one task
    of the rank pool (`_ranks`); `main` prints them as two lines:

    serve_mesh_golden: reduced qwen3-moe-30b-a3b in f32 with 8 / 4 heads
    (2 / 1 a rank), 4 slots of 1,024 positions (the cache cut by
    positions), prompts whose lengths divide 4 (the MoE's all-to-all
    prefill through `rotor_all_to_all`) and do not, from the stored JAX
    `ServeEngine` run on 4 fake CPU devices at the same mesh
    (src/repro_torch/data/qwen3_moe_30b_a3b_reduced_serve_mesh_golden.npz):
    every rank's greedy tokens equal to it, every prefill's and tick's
    logits within 1e-4; flash on 2 / 1 heads once a layer a prefill,
    moe_gmm on 2 experts a rank once a layer a prefill and a tick.

    serve_mesh_full: qwen3-moe-30b-a3b at full width in bf16, seed-0
    weights, each rank its blocks, cut to `SERVE_MESH_LAYERS` of 48
    layers (printed as `reduced`), 4 slots of 1,024 positions (256 a
    rank), 8 requests of odd lengths (the MoE's local branch at every
    prefill and tick), 8 new tokens each; then the same requests in this
    process on whole weights, one rank (`_serve_mesh_whole`).  Every
    rank's tokens the same; each prefill's logits within bf16's 2e-2 of
    the one rank's largest magnitude where that run takes the mesh's
    router decisions, and within `SERVE_MESH_FREE_LIMIT` where it takes
    its own, a limit that a one-rank run with its attention in f32 meets
    and one with its KV heads rolled does not (both checked); no
    decision of the first MoE layer taken apart at a router-logit gap
    above 2e-2 of the largest; every tick's logits finite; moe_gmm on 32 experts a rank
    in every MoE layer of every prefill and tick, flash on 8 / 1 heads in
    every layer of every prefill, both counted.  Prints tick and prefill
    ms with the wire's ms within each, the collectives a tick by kind and
    axis, the bytes a rank sends a tick, peak GB a rank, and the share of
    greedy tokens equal to the one rank's."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config

    _free_card()
    path = root / "src" / "repro_torch" / "data" / SERVE_MESH_GOLDEN
    stored = dict(np.load(path))
    full = get_config(ARCH)
    reduced = {"num_layers": [full.num_layers, SERVE_MESH_LAYERS]}
    print(f"reduced: {json.dumps(reduced)} ({SERVE_MESH_WHY})", flush=True)
    t0 = time.perf_counter()
    ranks = _ranks(_serve_mesh_rank, str(path), SERVE_MESH_LAYERS,
                   timeout_s=600)
    wall = time.perf_counter() - t0
    # the stored JAX mesh run
    g = [r["golden"] for r in ranks]
    n = sum(1 for k in stored if k.startswith("prompt/"))
    for rank, r in enumerate(g):
        for rid in range(n):
            want = stored[f"tokens/{rid}"].tolist()
            _check(r["tokens"].get(rid) == want,
                   f"serve_mesh_golden rank {rank} tokens {rid}: "
                   f"{r['tokens'].get(rid)} != {want}")
        for kind, (err, ok) in r["errs"].items():
            _check(ok, f"serve_mesh_golden rank {rank} {kind} logits: {err}")
        per = g[0]["layers"]
        want = {"flash_attention": per * r["prefills"],
                "moe_gmm": per * (r["prefills"] + r["ticks"])}
        _check(r["launches"] == want,
               f"serve_mesh_golden launches {r['launches']} != {want}")
        _check(r["heads"] == {(2, 1): per * r["prefills"]}
               and r["experts"] == {2: per * (r["prefills"] + r["ticks"])},
               f"serve_mesh_golden heads {r['heads']} experts "
               f"{r['experts']}")
    lens = [len(stored[f"prompt/{i}"]) for i in range(n)]
    golden = dict(
        phase="serve_mesh_golden", arch=ARCH, layers=g[0]["layers"],
        config=json.loads(str(stored["config"])), mesh={"data": 1, "model": 4},
        backend=g[0]["backend"], why=g[0]["why"], prompt_lens=lens,
        all_to_all_prefills=sum(1 for L in lens if L % 4 == 0),
        slots=int(stored["slots"]), max_seq=int(stored["max_seq"]),
        prefills=g[0]["prefills"], ticks=g[0]["ticks"], tokens_equal=True,
        logits_max_abs_err={k: max(r["errs"][k][0] for r in g)
                            for k in ("prefill", "tick")},
        seconds_per_rank=[r["seconds"] for r in g],
        **{f"{k}_launches": sum(r["launches"].get(k, 0) for r in g)
           for k in ("flash_attention", "moe_gmm")})
    # qwen3-moe at full width against one rank on whole weights
    f = [r["full"] for r in ranks]
    picks = [torch.as_tensor(p) for p in f[0]["picks"]]
    whole = _serve_mesh_whole(SERVE_MESH_LAYERS, picks)
    cfg = full.replace(num_layers=SERVE_MESH_LAYERS)
    tp = 4
    for rank, r in enumerate(f):
        _check(r["tokens"] == f[0]["tokens"],
               f"serve_mesh_full: rank {rank}'s tokens differ from rank 0's")
        _check(r["nonfinite_ticks"] == 0,
               f"serve_mesh_full rank {rank}: {r['nonfinite_ticks']} ticks "
               "with non-finite logits")
        per = cfg.num_layers
        _check(r["experts"] == {cfg.moe.num_experts // tp:
                                per * (r["prefills"] + r["ticks"])},
               f"serve_mesh_full moe_gmm calls by experts {r['experts']}")
        _check(r["heads"] == {f"{cfg.num_heads // tp}/"
                              f"{cfg.num_kv_heads // tp}":
                              per * r["prefills"]},
               f"serve_mesh_full flash calls by heads {r['heads']}")
        want = {"flash_attention": per * r["prefills"],
                "moe_gmm": per * (r["prefills"] + r["ticks"])}
        _check(r["launches"] == want,
               f"serve_mesh_full launches {r['launches']} != {want}")
        _check(r["cuts"] == ["positions"],
               f"serve_mesh_full caches cut by {r['cuts']}")
    got = torch.as_tensor(f[0]["prefill_logits"])
    one = whole["free"]["prefill_logits"]
    _check(got.shape == one.shape and bool(torch.isfinite(got).all()),
           f"serve_mesh_full prefill logits {tuple(got.shape)}")

    def apart(a, b):
        """Each prefill's largest distance of `a`'s logits from `b`'s,
        over `b`'s largest magnitude."""
        return ((a - b).abs() / b.abs().amax(-1, keepdim=True)).amax(-1)

    # the routers' near ties: one rank and the mesh round apart, and a
    # token whose k-th and (k+1)-th experts tie takes another expert,
    # which moves its logits by more than bf16's 2e-2 where the rounding
    # alone does not (ROADMAP Queue 3, B7).  So the one rank's run with
    # the mesh's routes is held to 2e-2; the free run to a limit that a
    # one-rank run rounding otherwise (the witness) meets and a wrong
    # kernel (the KV heads rolled) does not, both read here; and no
    # decision of the first MoE layer, before which no flip can move the
    # router's input, falls apart at a gap above bf16's 2e-2
    tol = _tol(torch.bfloat16)
    rel = apart(got, whole["held"]["prefill_logits"])
    rel_free = apart(got, one)
    rel_witness = apart(whole["witness"]["prefill_logits"], one)
    rel_wrong = apart(whole["wrong"]["prefill_logits"], one)
    _check(bool((rel <= tol).all()),
           f"serve_mesh_full prefill logits against one rank's with the "
           f"mesh's routes: {rel}")
    _check(float(rel_witness.max()) <= SERVE_MESH_FREE_LIMIT
           < float(rel_wrong.min()),
           f"serve_mesh_full: the limit {SERVE_MESH_FREE_LIMIT} does not "
           f"part the rounding witness {rel_witness} from the wrong "
           f"kernel {rel_wrong}")
    _check(bool((rel_free <= SERVE_MESH_FREE_LIMIT).all()),
           f"serve_mesh_full prefill logits against one rank's: {rel_free}"
           f" above {SERVE_MESH_FREE_LIMIT}")
    flips = _route_flips(picks, whole["free"], SERVE_MESH_SLOTS)
    first = _route_flips(picks, whole["free"], SERVE_MESH_SLOTS,
                         layers=cfg.num_layers)
    _check(first["max_gap_at_flips"] <= tol,
           f"serve_mesh_full: a first-layer router decision falls apart at "
           f"a gap of {first['max_gap_at_flips']} > {tol}")
    free = whole["free"]
    same = sum(a == b for rid in free["tokens"] for a, b in zip(
        f[0]["tokens"][rid], free["tokens"][rid]))
    total = sum(len(t) for t in free["tokens"].values())
    ticks = f[0]["ticks"]

    def per_tick(key):
        return [r[key] / ticks * 1e3 for r in f]

    full_out = dict(
        phase="serve_mesh_full", arch=cfg.name, layers=cfg.num_layers,
        reduced=reduced, reduced_why=SERVE_MESH_WHY, d_model=cfg.d_model,
        heads=[cfg.num_heads, cfg.num_kv_heads],
        experts=cfg.moe.num_experts, vocab=cfg.vocab_size,
        mesh={"data": 1, "model": tp}, backend=g[0]["backend"],
        slots=SERVE_MESH_SLOTS,
        max_seq=SERVE_MESH_SEQ, prompt_lens=list(SERVE_MESH_LENS),
        new_tokens=SERVE_MESH_NEW, wall_s=wall,
        init_s=[r["init_s"] for r in f],
        prefills=f[0]["prefills"], ticks=ticks,
        tick_ms_per_rank=per_tick("decode_s"),
        tick_wire_ms_per_rank=per_tick("decode_wire_s"),
        prefill_ms_per_rank=[r["prefill_s"] / r["prefills"] * 1e3
                             for r in f],
        prefill_wire_ms_per_rank=[r["prefill_wire_s"] / r["prefills"] * 1e3
                                  for r in f],
        prefill_tokens_per_s=[r["prefill_tokens"] / r["prefill_s"]
                              for r in f],
        sent_bytes_per_tick_per_rank=[r["decode_sent"] / ticks for r in f],
        sent_bytes_per_prefill_per_rank=[r["prefill_sent"] / r["prefills"]
                                         for r in f],
        collectives_per_tick={k: v / ticks
                              for k, v in f[0]["tick_calls"].items()},
        collectives=f[0]["calls"], collective_bytes=f[0]["payload"],
        flash_calls_by_heads=f[0]["heads"],
        moe_gmm_calls_by_experts=f[0]["experts"],
        param_bytes_per_rank=[r["param_bytes"] for r in f],
        cache_bytes_per_rank=[r["cache_bytes"] for r in f],
        peak_gb_per_rank=[r["peak_bytes"] / 1e9 for r in f],
        prefill_logits_rel_err_routes_held=rel.tolist(),
        prefill_logits_rel_err_free=rel_free.tolist(),
        prefill_logits_rel_err_witness=rel_witness.tolist(),
        prefill_logits_rel_err_wrong=rel_wrong.tolist(),
        free_limit=SERVE_MESH_FREE_LIMIT, route_flips=flips,
        first_layer_route_flips=first,
        tokens_equal_to_one_rank=same / total,
        whole_tick_ms=free["decode_s"] / free["ticks"] * 1e3,
        whole_prefill_ms=free["prefill_s"] / free["prefills"] * 1e3,
        whole_peak_gb=whole["peak_bytes"] / 1e9,
        **{f"{k}_launches": sum(r["launches"].get(k, 0) for r in f)
           for k in ("flash_attention", "moe_gmm")})
    return dict(phase="serve_mesh", wall_s=wall,
                golden_s=max(r["seconds"] for r in g), golden=golden,
                full=full_out)


# The MoE, SSM and hybrid archs' full-width training runs: (phase, arch,
# layers kept (0: all), why, the kernels a layer of each kind launches,
# whether the run goes through `launch.train.main`, and the backward
# kernels' names in the profiler's trace)
ARCH_TRAIN_RUNS = [
    ("train_full_qwen3", "qwen3-moe-30b-a3b", 4,
     "48 layers of f32 masters, gradients and two moments need ~16 B a "
     "parameter, ~10 GB a layer (~489 GB), and the untied embedding and "
     "head ~10 GB; 4 layers fit the card's 80 GB beside the f32 logits",
     {"flash_attention": "moe", "moe_gmm": "moe"}, False,
     ("moe_bwd", "flash_bwd")),
    ("train_full_falcon_mamba", "falcon-mamba-7b", 30,
     "64 layers at ~16 B a parameter need ~116 GB (1.7 GB a layer, 8.5 GB "
     "for the untied embedding and head); 30 fit the card's 80 GB",
     {"mamba_scan": "ssm"}, False, ("mamba_scan_bwd",)),
    ("train_full_rgemma", "recurrentgemma-2b", 0, "",
     {"rglru_scan": "rglru", "flash_attention": "local_attn"}, True,
     ("rglru_bwd", "flash_bwd")),
]
ARCH_TRAIN_STEPS, ARCH_TRAIN_BATCH, ARCH_TRAIN_SEQ = 10, 1, 4096
# AdamW's peak lr: the launcher's 1e-3, but 3e-4 for falcon-mamba, whose
# 30-layer cut's loss rose after the warmup at 1e-3; the JAX package's
# loss rises the same way there (tests/torch_u1_lr_check.py; ROADMAP
# Queue 3, U1, by design)
ARCH_TRAIN_LR = {"falcon-mamba-7b": 3e-4}


def phase_train_arch_full(phase: str, arch: str, layers: int, why: str,
                          kernels: dict, via_main: bool,
                          bwd_names: tuple) -> dict:
    """`arch` at full width (its depth cut to `layers` where 80 GB force
    it, printed as `reduced` with the reason), float32 masters made on the
    card from seed 0, bf16 compute, full remat, S 4096, B 1 (train_4k's
    global batch of 256 is cut as the card forces: printed too): 10 steps
    of `make_train_step` (or of `launch.train.main` where `via_main`) at
    `ARCH_TRAIN_LR`.
    Every loss finite, the last 3 below the first 3 on average, the
    parameter count `count_params`'s, every kernel's launches exact (its
    forward 2 a layer of its kind a step, its backward 1).  Then 2 steps
    profiled (after a warm one): step ms (host), device ms, the idle share,
    tokens/s, peak memory and each backward kernel's device ms a step and
    share of the step."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import count_params, init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.train.trainer import init_train_state, make_train_step

    _free_card()
    cfg = get_config(arch)
    steps, B, S = ARCH_TRAIN_STEPS, ARCH_TRAIN_BATCH, ARCH_TRAIN_SEQ
    reduced = {"global_batch": [256, B]}
    whys = [f"train_4k's global batch of 256 at 4,096 tokens needs its f32 "
            f"logits alone ({256 * S * cfg.vocab_size * 4 / 1e9:.0f} GB); "
            f"B {B} fits beside the weights and optimizer state"]
    if layers:
        reduced["num_layers"] = [cfg.num_layers, layers]
        whys.append(why)
        cfg = cfg.replace(num_layers=layers)
    print(f"reduced: {json.dumps(reduced)} ({'; '.join(whys)})", flush=True)
    lr = ARCH_TRAIN_LR.get(arch, 1e-3)
    opt = AdamWConfig(lr=lr, total_steps=steps,
                      warmup_steps=max(steps // 20, 5))
    launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if via_main:
        run = train_main(["--arch", arch, "--no-reduced", "--steps",
                          str(steps), "--batch", str(B), "--seq", str(S),
                          "--lr", str(lr), "--log-every", "1", "--device",
                          "cuda"])
        state = None
    else:
        t1 = time.perf_counter()
        params = init_params(cfg, 0, device="cuda", masters=True)
        state = init_train_state(cfg, params)
        torch.cuda.synchronize()
        run = dict(losses=[], grad_norms=[], lrs=[], step_s=[],
                   init_s=time.perf_counter() - t1,
                   params=sum(p.numel() for p in params.parameters()))
        step_fn = make_train_step(cfg, single_device_ctx(), opt)
        batches = device_batches(SyntheticLM(cfg.vocab_size, S, B, seed=0),
                                 0, "cuda")
        for step in range(steps):
            t1 = time.perf_counter()
            state, m = step_fn(state, next(batches))
            run["losses"].append(float(m["loss"]))   # waits for the step
            run["step_s"].append(time.perf_counter() - t1)
            run["grad_norms"].append(float(m["grad_norm"]))
            run["lrs"].append(float(m["lr"]))
            print(f"[{phase}] step {step} loss {run['losses'][-1]:.4f} "
                  f"gnorm {run['grad_norms'][-1]:.3f}", flush=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(launch_counts)
    losses = run["losses"]
    _check(run["params"] == count_params(cfg), f"{phase} params "
                                               f"{run['params']}")
    _check(len(losses) == steps and all(np.isfinite(losses)),
           f"{phase} losses {losses}")
    _check(np.mean(losses[-3:]) < np.mean(losses[:3]),
           f"{phase} loss did not fall: {losses}")
    want = _train_launches(cfg, kernels, steps)
    _check(launches == want, f"{phase} launches {launches} != {want}")
    # the first step builds cuBLAS's plans and warms the allocator
    step_ms = float(np.median(run["step_s"][1:])) * 1e3

    if state is None:   # launch.train.main keeps no state: a fresh one
        _free_card()
        state = init_train_state(cfg, init_params(cfg, 1, device="cuda",
                                                  masters=True))
        step_fn = make_train_step(cfg, single_device_ctx(), opt)
        batches = device_batches(SyntheticLM(cfg.vocab_size, S, B, seed=0),
                                 steps, "cuda")
        state, m = step_fn(state, next(batches))   # warm
        float(m["loss"])
    prof_steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_steps):
            state, m = step_fn(state, next(batches))
            float(m["loss"])
    kern = [(e.key, getattr(e, "device_time_total", 0.0), e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_ms = sum(us for _, us, _ in kern) / prof_steps / 1e3
    bwd = {name: sum(us for k, us, _ in kern if name in k) / prof_steps / 1e3
           for name in bwd_names}
    kern.sort(key=lambda r: -r[1])
    del state, m
    _free_card()
    return dict(
        phase=phase, arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, params=run["params"], reduced=reduced,
        reduced_why=whys, batch=B, seq=S, steps=steps, lr=lr,
        via="launch.train.main" if via_main else "make_train_step",
        remat=cfg.remat, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, init_s=run["init_s"], wall_s=wall,
        losses=losses, grad_norms=run["grad_norms"], lrs=run["lrs"],
        step_s=run["step_s"], step_ms=step_ms,
        tokens_per_s=B * S / (step_ms / 1e3), peak_bytes=peak,
        peak_gb=peak / 1e9, device_ms_per_step=device_ms,
        idle_share=1.0 - device_ms / step_ms,
        **{f"{k}_device_ms_per_step": v for k, v in bwd.items()},
        **{f"{k}_share_of_step": v / step_ms for k, v in bwd.items()},
        launches_per_step=sum(c for _, _, c in kern) / prof_steps,
        top=[dict(kernel=k[:90], ms_per_step=us / prof_steps / 1e3,
                  launches_per_step=c / prof_steps)
             for k, us, c in kern[:12]],
        **{f"{k}_launches": v for k, v in launches.items()})


# ---------------- the mamba and RG-LRU mixers split over `model` ------------

# the stored JAX runs of reduced falcon-mamba-7b and recurrentgemma-2b at
# (data 1, model 4) (tests/test_torch_tp_recurrent.py writes them), and
# the kernels each arch's layers launch by layer kind: a forward twice a
# layer a step under remat and a backward once in training, a forward
# once a layer a prefill and none at a decode tick in serving
TP_SSM_GOLDEN = {"falcon-mamba-7b": "falcon_mamba_7b_reduced_tp_golden.npz",
                 "recurrentgemma-2b":
                 "recurrentgemma_2b_reduced_tp_golden.npz"}
TP_SSM_KERNELS = {"falcon-mamba-7b": {"mamba_scan": "ssm"},
                  "recurrentgemma-2b": {"rglru_scan": "rglru",
                                        "flash_attention": "local_attn"}}
# falcon-mamba-7b at full width on (data 1, model 4): d_inner 8,192, 2,048
# channels a rank; the depth, the steps and the requests the script's
# 1,200 s hold beside the one-rank reference
TP_SSM_FULL_ARCH = "falcon-mamba-7b"
TP_SSM_FULL_LAYERS, TP_SSM_FULL_STEPS = 8, 4
TP_SSM_FULL_B, TP_SSM_FULL_S = 1, 4096
TP_SSM_FULL_LR = ARCH_TRAIN_LR[TP_SSM_FULL_ARCH]   # U1
TP_SSM_FULL_SLOTS, TP_SSM_FULL_SEQ, TP_SSM_FULL_NEW = 4, 1024, 8
TP_SSM_FULL_LENS = (455, 373, 247, 135)
TP_SSM_FULL_WHY = ("the script's 1,200 s, and 4 ranks and the one-rank "
                   "reference on whole weights sharing the card's 80 GB: at "
                   "16 B a parameter a layer needs ~1.7 GB, the untied "
                   "embedding and head ~8.5 GB, ~22 GB at 8 layers for the "
                   "reference alone")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _mixer_leaf(name: str) -> bool:
    return ".mixer." in name or ".rec." in name


def _logits_errs(logits, stored: dict, prefix: str) -> dict:
    """{"prefill" | "tick": (the largest distance of the recorded logits
    from the stored ones, whether each is within 1e-4)}."""
    import torch

    errs = {}
    for kind, got in (("prefill", logits.prefill), ("tick", logits.tick)):
        want = torch.as_tensor(stored[f"{prefix}{kind}_logits"])
        got = torch.cat(got) if kind == "prefill" else torch.stack(got)
        if got.shape != want.shape:
            errs[kind] = (float("inf"), False)
            continue
        err = (got - want).abs()
        errs[kind] = (float(err.max()),
                      bool((err <= 1e-4 + 1e-4 * want.abs()).all()))
    return errs


def _cache_shapes(cache) -> list:
    return sorted({(n, tuple(t.shape)) for c in cache for n, t in c.items()})


def _tp_ssm_golden_rank(world, root: str) -> dict:
    """Both stored runs on this rank, by arch: the stored steps through
    `make_train_step` under fsdp_tp (per step the metrics; after the last
    the largest distance of this rank's blocks of the parameters and both
    moments from the stored whole arrays' blocks, `_block_digests`), and
    the stored requests through `ServeEngine` (the tokens, the logits'
    distances, the slots' state shapes); in each, the kernels' launches,
    the scans' launches by channels and the mixer leaves gathered over
    `model` (`_Census`)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, fname in TP_SSM_GOLDEN.items():
        stored = dict(np.load(Path(root) / "src" / "repro_torch" / "data"
                              / fname))
        cfg = reduced_config(get_config(arch)).replace(
            compute_dtype="float32")
        spec = json.loads(str(stored["mesh"]))
        mesh = Mesh(spec["shape"], spec["axes"])
        pctx = pctx_for_mesh(mesh)
        data = json.loads(str(stored["data"]))

        def blocks(prefix, masters=True):
            return params_from_numpy(cfg, tree_from_flat(
                {k[len(prefix):]: v for k, v in stored.items()
                 if k.startswith(prefix)}), device=world.device,
                masters=masters, pctx=pctx)

        state = init_train_state(cfg, blocks("param/"))
        step = make_train_step(cfg, pctx, AdamWConfig(**json.loads(str(
            stored["opt"]))))
        src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                          seed=data["seed"])
        steps = len(stored["loss"])
        metrics = []
        launch_counts.clear()
        with _Census(mesh.shape) as census:
            for _, batch in zip(range(steps),
                                device_batches(src, 0, world.device)):
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        got = {"param": dict(state["params"].named_parameters()),
               "m": state["opt"]["m"], "v": state["opt"]["v"]}
        errs = {k: _fsdp_blocks_err(got[k], dict(blocks(
            f"after{steps}/{k}/").named_parameters())) for k in got}
        train = dict(
            metrics=metrics, launches=dict(launch_counts),
            max_abs_err={k: e[0] for k, e in errs.items()},
            outside_tol=[f"{k}:{n}" for k, e in errs.items() for n in e[1]],
            held=_block_digests(got["param"], cfg, pctx),
            held_m=_block_digests(got["m"], cfg, pctx),
            scans=dict(census.scans),
            mixer_over_model=sorted(leaf for leaf, axis in census.gathered
                                    if axis == "model" and _mixer_leaf(leaf)))
        del state, got
        n = sum(1 for k in stored if k.startswith("serve/prompt/"))
        with torch.no_grad(), _Census(mesh.shape) as census:
            eng, tokens, logits, launches = _serve(
                cfg, blocks("param/", masters=False), pctx,
                int(stored["serve/slots"]), int(stored["serve/max_seq"]),
                [stored[f"serve/prompt/{i}"] for i in range(n)],
                int(stored["serve/max_new"]), world.device)
        serve = dict(
            tokens=tokens, errs=_logits_errs(logits, stored, "serve/"),
            launches=launches, prefills=eng.prefills, ticks=eng.ticks,
            cache_shapes=_cache_shapes(eng.cache), scans=dict(census.scans),
            mixer_over_model=sorted(leaf for leaf, axis in census.gathered
                                    if axis == "model" and _mixer_leaf(leaf)))
        out[arch] = dict(train=train, serve=serve, layers=cfg.num_layers,
                         backend=world.backend, why=world.why)
    return out


def phase_tp_ssm_golden(root: Path) -> dict:
    """The mamba and RG-LRU mixers split by channels over `model`
    (`models.sharding.computes_tp`) on 4 ranks as `data` 1 x `model` 4 on
    the one card: reduced falcon-mamba-7b (d_inner 128, 32 channels a
    rank) and recurrentgemma-2b (lru_width 64, 16 a rank) in f32 from the
    stored weights (src/repro_torch/data/*_reduced_tp_golden.npz, the JAX
    package's GSPMD runs on 4 fake CPU devices).  Training: 3 steps of
    `make_train_step` under fsdp_tp, the losses, gradient norms and lr
    within rtol 1e-5, each rank's blocks of the parameters and both
    moments after the last within atol/rtol 1e-5 of the stored whole
    arrays' blocks (mamba's in_proj through `held_columns`), the ranks of
    one block the same bits.  Serving: `ServeEngine` with 4 slots, 6
    prompts of 9 and 12 tokens, 4 new tokens each: the greedy tokens
    equal, every prefill's and tick's logits within 1e-4, each slot's
    conv, SSM and LRU states a quarter of the channels.  In both no mixer
    leaf gathered over `model`, every kernel's launches exact, the scans
    on the rank's channels alone (`_Census.scans`)."""
    import numpy as np

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models.transformer import stack_plan

    t0 = time.perf_counter()
    ranks = _ranks(_tp_ssm_golden_rank, str(root), timeout_s=300)
    wall = time.perf_counter() - t0
    tp = 4
    out = dict(phase="tp_ssm_golden", card=_card(),
               mesh={"data": 1, "model": tp},
               layout="fsdp_tp", backend=ranks[0][TP_SSM_FULL_ARCH]["backend"],
               why=ranks[0][TP_SSM_FULL_ARCH]["why"], ranks_s=wall, archs={})
    for arch, fname in TP_SSM_GOLDEN.items():
        stored = dict(np.load(root / "src" / "repro_torch" / "data" / fname))
        cfg = reduced_config(get_config(arch))
        width = cfg.d_inner_ if cfg.ssm is not None else cfg.lru_width_
        steps = len(stored["loss"])
        kernels = TP_SSM_KERNELS[arch]
        scan = next(k for k in kernels if k.endswith("_scan"))
        kind = kernels[scan]
        tag = f"tp_ssm_golden {arch}"
        train = [r[arch]["train"] for r in ranks]
        serve = [r[arch]["serve"] for r in ranks]
        _check_blocks([r["held"] for r in train], f"{tag} params")
        _check_blocks([r["held_m"] for r in train], f"{tag} m")
        layers = stack_plan(cfg).kinds.count(kind)
        for rank, (t, s) in enumerate(zip(train, serve)):
            _check(t["metrics"] == train[0]["metrics"],
                   f"{tag}: rank {rank} reports other metrics")
            _check(not t["outside_tol"], f"{tag} rank {rank}: "
                   f"{t['outside_tol'][:8]} beyond atol/rtol 1e-5")
            want = _train_launches(cfg, kernels, steps)
            _check(t["launches"] == want,
                   f"{tag} training launches {t['launches']} != {want}")
            _check(t["scans"] == {(scan, width // tp): 2 * layers * steps,
                                  (f"{scan}_bwd", width // tp):
                                  layers * steps},
                   f"{tag} training scans {t['scans']}")
            _check(not t["mixer_over_model"] and not s["mixer_over_model"],
                   f"{tag}: mixer leaves gathered over model "
                   f"{t['mixer_over_model'] + s['mixer_over_model']}")
            for rid, toks in s["tokens"].items():
                want = stored[f"serve/tokens/{rid}"].tolist()
                _check(toks == want, f"{tag} rank {rank} tokens {rid}: "
                       f"{toks} != {want}")
            _check(len(s["tokens"]) == sum(
                1 for k in stored if k.startswith("serve/tokens/")),
                f"{tag}: {len(s['tokens'])} requests served")
            for what, (err, ok) in s["errs"].items():
                _check(ok, f"{tag} rank {rank} {what} logits: {err}")
            want = _expected_launches(
                cfg, {k: ((v,), 1, 0) for k, v in kernels.items()},
                s["prefills"], s["ticks"])
            _check(s["launches"] == want,
                   f"{tag} serving launches {s['launches']} != {want}")
            _check(s["scans"] == {(scan, width // tp): layers * s["prefills"]},
                   f"{tag} serving scans {s['scans']}")
            for name, shape in s["cache_shapes"]:
                if name in ("conv", "ssm", "lru"):
                    c = 1 if name == "ssm" else len(shape) - 1
                    _check(shape[c] * tp == width,
                           f"{tag} {name} state held as {shape}")
        for k in ("loss", "grad_norm", "lr"):
            got = np.array([m[k] for m in train[0]["metrics"]])
            rel = float(np.max(np.abs(got - stored[k]) / np.abs(stored[k])))
            _check(rel <= 1e-5, f"{tag} {k}: {got} != {stored[k]}")
        out["archs"][arch] = dict(
            layers=cfg.num_layers, channels_per_rank=width // tp,
            width=width, steps=steps,
            losses=[m["loss"] for m in train[0]["metrics"]],
            jax_losses=stored["loss"].tolist(),
            max_abs_err={k: max(t["max_abs_err"][k] for t in train)
                         for k in ("param", "m", "v")},
            prefills=serve[0]["prefills"], ticks=serve[0]["ticks"],
            tokens_equal=True,
            logits_max_abs_err={k: max(s["errs"][k][0] for s in serve)
                                for k in ("prefill", "tick")},
            state_shapes_per_rank=[list(x) for x in serve[0]["cache_shapes"]
                                   if x[0] in ("conv", "ssm", "lru")])
        for k in set(kernels) | {f"{k}_bwd" for k in kernels}:
            out[f"{k}_launches"] = out.get(f"{k}_launches", 0) + sum(
                t["launches"].get(k, 0) + s["launches"].get(k, 0)
                for t, s in zip(train, serve))
    return out


def _tp_ssm_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in TP_SSM_FULL_LENS]


def _tp_ssm_full_rank(world, layers: int) -> dict:
    """falcon-mamba-7b at full width cut to `layers` on this rank of
    (data 1, model 4): `make_train_step` under fsdp_tp from seed 0 (per
    step the loss, gradient norm, host seconds, the wire's seconds and
    bytes sent; the collectives, the scans by channels and the mixer
    leaves gathered over `model` (`_Census`); the launches; this rank's
    bytes of the mixer leaves and of the state; peak bytes), then, its
    state freed, `ServeEngine` on the seed-0 bf16 weights (the tokens,
    the prefills' logits on rank 0, the ticks with non-finite logits,
    prefill and tick host seconds with the wire's within them and the
    bytes sent, the collectives of the ticks and of all, the scans, the
    slots' state shapes and bytes, this rank's bytes of the mixer
    weights, peak bytes)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params, param_shapes
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TP_SSM_FULL_ARCH).replace(num_layers=layers)
    mesh = Mesh((1, 4), ("data", "model"))
    pctx = pctx_for_mesh(mesh)
    shapes = param_shapes(cfg)

    def nbytes(ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    def mixer_bytes(tree) -> tuple:
        """(this rank's bytes of the mixer leaves of `tree`, the whole
        leaves' in the same dtypes)."""
        held = [(n, p) for n, p in tree.named_parameters()
                if _mixer_leaf(n)]
        return (nbytes(p for _, p in held),
                sum(math.prod(shapes[n]) * p.element_size()
                    for n, p in held))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, init_params(cfg, 0, device=world.device,
                                              masters=True, pctx=pctx))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, pctx, AdamWConfig(
        lr=TP_SSM_FULL_LR, total_steps=TP_SSM_FULL_STEPS, warmup_steps=5))
    batches = device_batches(SyntheticLM(cfg.vocab_size, TP_SSM_FULL_S,
                                         TP_SSM_FULL_B, seed=0), 0,
                             world.device)
    launch_counts.clear()
    train = dict(losses=[], grad_norms=[], step_s=[], sent_bytes=[],
                 wire_s=[])
    with _Census(mesh.shape) as census:
        for _, batch in zip(range(TP_SSM_FULL_STEPS), batches):
            t0 = time.perf_counter()
            sent, wire = mesh.sent_bytes, mesh.wire_s
            state, m = step(state, batch)
            train["losses"].append(float(m["loss"]))   # waits for the step
            train["step_s"].append(time.perf_counter() - t0)
            train["grad_norms"].append(float(m["grad_norm"]))
            train["sent_bytes"].append(mesh.sent_bytes - sent)
            train["wire_s"].append(mesh.wire_s - wire)
            if world.rank == 0:
                print(f"[tp_ssm_full] step {len(train['losses'])} loss "
                      f"{train['losses'][-1]:.4f} "
                      f"{train['step_s'][-1]:.2f} s, "
                      f"{train['wire_s'][-1]:.2f} s on the wire", flush=True)
    params = dict(state["params"].named_parameters())
    train.update(
        init_s=init_s, launches=dict(launch_counts),
        calls={"/".join(k): v for k, v in census.calls.items()},
        payload={"/".join(k): v for k, v in census.payload.items()},
        scans=dict(census.scans),
        mixer_over_model=sorted(leaf for leaf, axis in census.gathered
                                if axis == "model" and _mixer_leaf(leaf)),
        mixer_bytes=mixer_bytes(state["params"]),
        state_bytes={k: nbytes(params.values() if k == "params"
                               else state["opt"][k].values())
                     for k in ("params", "m", "v")},
        peak_bytes=torch.cuda.max_memory_allocated())
    del state, params, step, m
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights = init_params(cfg, 0, device=world.device, pctx=pctx)
    with torch.no_grad(), _Census(mesh.shape) as census:
        eng, tokens, logits, launches = _serve(
            cfg, weights, pctx, TP_SSM_FULL_SLOTS, TP_SSM_FULL_SEQ,
            _tp_ssm_prompts(cfg.vocab_size), TP_SSM_FULL_NEW, world.device,
            census)
    serve = dict(
        tokens=tokens, prefills=eng.prefills, ticks=eng.ticks,
        nonfinite_ticks=sum(1 for t in logits.tick
                            if not bool(torch.isfinite(t).all())),
        prefill_s=eng.prefill_s, prefill_wire_s=eng.prefill_wire_s,
        prefill_sent=eng.prefill_sent, decode_s=eng.decode_s,
        decode_wire_s=eng.decode_wire_s, decode_sent=eng.decode_sent,
        prefill_tokens=eng.prefill_tokens, launches=launches,
        calls={"/".join(k): v for k, v in census.calls.items()},
        tick_calls={"/".join(k): v for k, v in logits.tick_calls.items()},
        scans=dict(census.scans),
        mixer_over_model=sorted(leaf for leaf, axis in census.gathered
                                if axis == "model" and _mixer_leaf(leaf)),
        cache_shapes=_cache_shapes(eng.cache),
        state_bytes=nbytes(t for c in eng.cache for n, t in c.items()
                           if n in ("conv", "ssm")),
        mixer_bytes=mixer_bytes(weights),
        peak_bytes=torch.cuda.max_memory_allocated())
    if world.rank == 0:   # numpy: a tensor crosses as a handle
        serve["prefill_logits"] = np.stack(
            [t[0].numpy() for t in logits.prefill])
    del weights, eng
    return dict(train=train, serve=serve, backend=world.backend,
                why=world.why)


def _tp_ssm_whole(layers: int) -> dict:
    """tp_ssm_full's steps and requests in this process on whole weights,
    one rank: the losses, gradient norms, host seconds and peak bytes of
    the steps; the tokens, the prefills' logits, host seconds and peak
    bytes of the requests."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.models.model import init_params
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    _free_card()
    cfg = get_config(TP_SSM_FULL_ARCH).replace(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, init_params(cfg, 0, device="cuda",
                                              masters=True))
    step = make_train_step(cfg, single_device_ctx(), AdamWConfig(
        lr=TP_SSM_FULL_LR, total_steps=TP_SSM_FULL_STEPS, warmup_steps=5))
    train = dict(losses=[], grad_norms=[], step_s=[])
    for _, batch in zip(range(TP_SSM_FULL_STEPS), device_batches(SyntheticLM(
            cfg.vocab_size, TP_SSM_FULL_S, TP_SSM_FULL_B, seed=0), 0,
            "cuda")):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        train["losses"].append(float(m["loss"]))   # waits for the step
        train["step_s"].append(time.perf_counter() - t0)
        train["grad_norms"].append(float(m["grad_norm"]))
    train["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, step, m
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    weights = init_params(cfg, 0, device="cuda")
    with torch.no_grad():
        eng, tokens, logits, _ = _serve(
            cfg, weights, single_device_ctx(), TP_SSM_FULL_SLOTS,
            TP_SSM_FULL_SEQ, _tp_ssm_prompts(cfg.vocab_size),
            TP_SSM_FULL_NEW, "cuda")
    serve = dict(tokens=tokens,
                 prefill_logits=np.stack([t[0].numpy()
                                          for t in logits.prefill]),
                 prefill_s=eng.prefill_s, decode_s=eng.decode_s,
                 prefills=eng.prefills, ticks=eng.ticks,
                 peak_bytes=torch.cuda.max_memory_allocated())
    del weights, eng
    _free_card()
    return dict(train=train, serve=serve)


def phase_tp_ssm_full() -> dict:
    """falcon-mamba-7b at full width (d 4,096, d_inner 8,192, N 16, dt_rank
    256, vocab 65,024, untied head) cut to `TP_SSM_FULL_LAYERS` of 64
    layers (printed as `reduced` with the reason), f32 masters from seed
    0, bf16 compute, full remat, on 4 ranks as `data` 1 x `model` 4 on the
    one card (gloo staged through host memory): the mixer split by
    channels, 2,048 a rank (`models.sharding.computes_tp`).  Training:
    `TP_SSM_FULL_STEPS` steps of `make_train_step` under fsdp_tp at B 1, S
    4096, lr 3e-4 (U1); serving: `ServeEngine` with 4 slots, 4 prompts of
    odd lengths from 135 to 455, 8 new tokens each, on the seed-0 bf16
    weights.  Then both in this process on whole weights, one rank
    (`_tp_ssm_whole`).  Every loss finite, the same on every rank and
    within bf16's 2e-2 of the one rank's; the first gradient norm within
    1e-3 of it; every rank's tokens the same; every prefill's last-token
    logits within 2e-2 of the one rank's largest magnitude; every tick's
    logits finite; no mixer leaf gathered over `model`; `mamba_scan`
    twice and `mamba_scan_bwd` once on 2,048 channels in every layer of
    every step, and `mamba_scan` once a layer a prefill; the conv and SSM
    states held at (slots, 3, 2,048) and (slots, 2,048, 16) a rank.
    Prints, beside the card's name and power limit, step, prefill and
    tick ms with the wire's ms within each, the collectives a step and a
    tick by kind, the bytes a rank sends, peak GB a rank, and a rank's
    bytes of the mixer weights and of the serving states beside the
    whole ones."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config

    _free_card()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    full = get_config(TP_SSM_FULL_ARCH)
    cfg = full.replace(num_layers=TP_SSM_FULL_LAYERS)
    reduced = {"num_layers": [full.num_layers, TP_SSM_FULL_LAYERS],
               "global_batch": [256, TP_SSM_FULL_B]}
    print(f"reduced: {json.dumps(reduced)} ({TP_SSM_FULL_WHY})", flush=True)
    t0 = time.perf_counter()
    ranks = _ranks(_tp_ssm_full_rank, TP_SSM_FULL_LAYERS, timeout_s=700)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = _tp_ssm_whole(TP_SSM_FULL_LAYERS)
    whole_s = time.perf_counter() - t0
    tp, L, steps = 4, cfg.num_layers, TP_SSM_FULL_STEPS
    ch = cfg.d_inner_ // tp
    train = [r["train"] for r in ranks]
    serve = [r["serve"] for r in ranks]
    losses = train[0]["losses"]
    tol = _tol(torch.bfloat16)
    print(f"tp_ssm_full losses {losses} grad norms {train[0]['grad_norms']};"
          f" whole weights on one rank {whole['train']['losses']} grad norms"
          f" {whole['train']['grad_norms']}", flush=True)
    _check(all(t["losses"] == losses for t in train),
           "tp_ssm_full: ranks report other losses")
    _check(len(losses) == steps and all(np.isfinite(losses)),
           f"tp_ssm_full losses {losses}")
    _check(np.allclose(losses, whole["train"]["losses"], rtol=tol, atol=0),
           f"tp_ssm_full losses {losses} against one rank's "
           f"{whole['train']['losses']}")
    g0, w0 = train[0]["grad_norms"][0], whole["train"]["grad_norms"][0]
    _check(abs(g0 - w0) <= 1e-3 * abs(w0),
           f"tp_ssm_full first grad norm {g0} against one rank's {w0}")
    train_scans = {("mamba_scan", ch): 2 * L * steps,
                   ("mamba_scan_bwd", ch): L * steps}
    want = _train_launches(cfg, {"mamba_scan": "ssm"}, steps)
    for rank, (t, s) in enumerate(zip(train, serve)):
        _check(not t["mixer_over_model"] and not s["mixer_over_model"],
               f"tp_ssm_full rank {rank}: mixer leaves gathered over model "
               f"{t['mixer_over_model'] + s['mixer_over_model']}")
        _check(t["scans"] == train_scans,
               f"tp_ssm_full rank {rank} training scans {t['scans']}")
        _check(t["launches"] == want,
               f"tp_ssm_full rank {rank} launches {t['launches']}")
        _check(s["tokens"] == serve[0]["tokens"],
               f"tp_ssm_full: rank {rank}'s tokens differ from rank 0's")
        _check(len(s["tokens"]) == len(TP_SSM_FULL_LENS),
               f"tp_ssm_full: {len(s['tokens'])} requests served")
        _check(s["nonfinite_ticks"] == 0, f"tp_ssm_full rank {rank}: "
               f"{s['nonfinite_ticks']} ticks with non-finite logits")
        _check(s["scans"] == {("mamba_scan", ch): L * s["prefills"]},
               f"tp_ssm_full rank {rank} serving scans {s['scans']}")
        _check(s["launches"] == {"mamba_scan": L * s["prefills"]},
               f"tp_ssm_full rank {rank} serving launches {s['launches']}")
        shapes = dict(s["cache_shapes"])
        _check(shapes == {"conv": (TP_SSM_FULL_SLOTS, 3, ch),
                          "ssm": (TP_SSM_FULL_SLOTS, ch,
                                  cfg.ssm.state_dim)},
               f"tp_ssm_full rank {rank} states held as {shapes}")
    got = np.asarray(serve[0]["prefill_logits"])
    one = np.asarray(whole["serve"]["prefill_logits"])
    _check(got.shape == one.shape and bool(np.isfinite(got).all()),
           f"tp_ssm_full prefill logits {got.shape} against {one.shape}")
    rel = np.abs(got - one).max(-1) / np.abs(one).max(-1)
    _check(bool((rel <= tol).all()),
           f"tp_ssm_full prefill logits against one rank's: {rel}")
    state_whole = TP_SSM_FULL_SLOTS * L * cfg.d_inner_ * (
        (cfg.ssm.conv_kernel - 1) * 2 + cfg.ssm.state_dim * 4)
    same = sum(a == b for rid in whole["serve"]["tokens"] for a, b in zip(
        serve[0]["tokens"][rid], whole["serve"]["tokens"][rid]))
    total = sum(len(t) for t in whole["serve"]["tokens"].values())
    ticks, prefills = serve[0]["ticks"], serve[0]["prefills"]

    def med_ms(key):
        return [float(np.median(t[key][1:])) * 1e3 for t in train]

    step_ms, wire_ms = med_ms("step_s"), med_ms("wire_s")
    out = dict(
        phase="tp_ssm_full", card=_card(), arch=cfg.name, layers=L,
        d_model=cfg.d_model, d_inner=cfg.d_inner_, channels_per_rank=ch,
        state_dim=cfg.ssm.state_dim, dt_rank=cfg.dt_rank_,
        vocab=cfg.vocab_size, reduced=reduced, reduced_why=TP_SSM_FULL_WHY,
        layout="fsdp_tp", mesh={"data": 1, "model": tp},
        backend=ranks[0]["backend"], why=ranks[0]["why"], wall_s=wall,
        whole_s=whole_s, batch=TP_SSM_FULL_B, seq=TP_SSM_FULL_S,
        steps=steps, lr=TP_SSM_FULL_LR, losses=losses,
        grad_norms=train[0]["grad_norms"],
        whole_losses=whole["train"]["losses"],
        whole_grad_norms=whole["train"]["grad_norms"],
        first_grad_norm_rel=abs(g0 - w0) / abs(w0),
        step_ms_per_rank=step_ms, step_wire_ms_per_rank=wire_ms,
        whole_step_ms=float(np.median(whole["train"]["step_s"][1:])) * 1e3,
        sent_bytes_per_step_per_rank=[t["sent_bytes"][-1] for t in train],
        collectives_per_step={k: v / steps
                              for k, v in train[0]["calls"].items()},
        payload_bytes_per_step={k: v / steps
                                for k, v in train[0]["payload"].items()},
        train_peak_gb_per_rank=[t["peak_bytes"] / 1e9 for t in train],
        whole_train_peak_gb=whole["train"]["peak_bytes"] / 1e9,
        init_s=[t["init_s"] for t in train],
        mixer_master_bytes_per_rank=[t["mixer_bytes"][0] for t in train],
        whole_mixer_master_bytes=train[0]["mixer_bytes"][1],
        state_bytes_per_rank=[t["state_bytes"] for t in train],
        scans_per_step={f"{k}/{c}": n / steps
                        for (k, c), n in train[0]["scans"].items()},
        slots=TP_SSM_FULL_SLOTS, max_seq=TP_SSM_FULL_SEQ,
        prompt_lens=list(TP_SSM_FULL_LENS), new_tokens=TP_SSM_FULL_NEW,
        prefills=prefills, ticks=ticks,
        tick_ms_per_rank=[s["decode_s"] / ticks * 1e3 for s in serve],
        tick_wire_ms_per_rank=[s["decode_wire_s"] / ticks * 1e3
                               for s in serve],
        prefill_ms_per_rank=[s["prefill_s"] / prefills * 1e3 for s in serve],
        prefill_wire_ms_per_rank=[s["prefill_wire_s"] / prefills * 1e3
                                  for s in serve],
        whole_tick_ms=whole["serve"]["decode_s"] / whole["serve"]["ticks"]
        * 1e3,
        whole_prefill_ms=whole["serve"]["prefill_s"]
        / whole["serve"]["prefills"] * 1e3,
        sent_bytes_per_tick_per_rank=[s["decode_sent"] / ticks
                                      for s in serve],
        sent_bytes_per_prefill_per_rank=[s["prefill_sent"] / prefills
                                         for s in serve],
        collectives_per_tick={k: v / ticks
                              for k, v in serve[0]["tick_calls"].items()},
        serve_collectives=serve[0]["calls"],
        serve_peak_gb_per_rank=[s["peak_bytes"] / 1e9 for s in serve],
        whole_serve_peak_gb=whole["serve"]["peak_bytes"] / 1e9,
        mixer_weight_bytes_per_rank=[s["mixer_bytes"][0] for s in serve],
        whole_mixer_weight_bytes=serve[0]["mixer_bytes"][1],
        state_shapes_per_rank=[list(x) for x in serve[0]["cache_shapes"]],
        serve_state_bytes_per_rank=[s["state_bytes"] for s in serve],
        whole_serve_state_bytes=state_whole,
        prefill_logits_rel_err=rel.tolist(),
        tokens_equal_to_one_rank=same / total,
        mamba_scan_launches=sum(t["launches"].get("mamba_scan", 0)
                                + s["launches"].get("mamba_scan", 0)
                                for t, s in zip(train, serve)),
        mamba_scan_bwd_launches=sum(t["launches"].get("mamba_scan_bwd", 0)
                                    for t in train))
    return out


def _bmm_trio(h, wg, wu, wd):
    """The expert FFN as three batched products and silu in h's type: a
    yardstick only (it rounds g and u to that type)."""
    import torch
    import torch.nn.functional as F

    return torch.bmm(F.silu(torch.bmm(h, wg)) * torch.bmm(h, wu), wd)


def phase_moe_gmm() -> dict:
    import torch

    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd, plan
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    sweep_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for E, C, D, Fd in GMM_SWEEP:
            h = _randn((E, C, D), gen, dtype)
            w = [_randn(s, gen, dtype, 0.1)
                 for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
            sweep_err = max(sweep_err, _held(
                moe_gmm(h, *w), moe_gmm_ref(h, *w), dtype,
                f"moe_gmm sweep {(E, C, D, Fd)}"))
    rows = []
    # qwen3-moe (E 128, F 768) in both types at a 4-slot decode tick and
    # prefills of ~150 and 512 tokens; deepseek-moe-16b (E 64, F 1408) in
    # bf16 at a decode tick and a 455-token prefill (C 56); qwen3-moe's
    # experts over 4 model ranks in training (ep_full's shape)
    e_loc, ep_rows = _ep_full_rows()
    shapes = [("qwen3-moe-30b-a3b", dtype, 128, 768, (4, 12, 40))
              for dtype in (torch.float32, torch.bfloat16)] + [
        ("deepseek-moe-16b", torch.bfloat16, 64, 1408, (4, 56)),
        ("qwen3-moe-30b-a3b tp4", torch.bfloat16, e_loc, 768, (ep_rows,))]
    D = 2048
    for arch, dtype, E, Fd, caps in shapes:
        # fan-in scaled weights, as the model draws them (dense_init)
        w = [_randn((E, D, Fd), gen, dtype, D**-0.5),
             _randn((E, D, Fd), gen, dtype, D**-0.5),
             _randn((E, Fd, D), gen, dtype, Fd**-0.5)]
        for C in caps:
            h = _randn((E, C, D), gen, dtype)
            got = moe_gmm(h, *w)
            err = _held(got, moe_gmm_ref(h, *w), dtype,
                        f"moe_gmm {arch} C={C} {dtype}")
            _check(torch.equal(got, moe_gmm(h, *w)),
                   f"moe_gmm C={C} not deterministic")
            ms = _cuda_ms(lambda: moe_gmm_fwd(h, *w), reps=10)
            device_ms, gate_up_ms, down_ms = (
                _device_ms(lambda: moe_gmm_fwd(h, *w), names, reps=10)
                for names in (("moe_gmm",), ("moe_gmm_gate_up",),
                              ("moe_gmm_down",)))
            plain_ms = _cuda_ms(lambda: moe_gmm_ref(h, *w), reps=3, warmup=1)
            bmm_trio_ms = _cuda_ms(lambda: _bmm_trio(h, *w), reps=10)
            es = h.element_size()
            nbytes = es * (2 * E * C * D + 3 * E * D * Fd)
            ops = 6 * E * C * D * Fd
            bound_ms, bound_by = _bound(nbytes, ops, dtype)
            rows.append(dict(arch=arch, dtype=_dname(dtype), E=E, C=C, D=D,
                             F=Fd, rows_per_block=plan(E, C, D, Fd, dtype).rows,
                             max_abs_err=err, ms=ms, device_ms=device_ms,
                             gate_up_device_ms=gate_up_ms,
                             down_device_ms=down_ms,
                             plain_ms=plain_ms, library_ms=None,
                             bmm_trio_ms=bmm_trio_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_share=(bound_ms / device_ms
                                          if device_ms else None),
                             gbytes_per_s=nbytes / (ms * 1e-3) / 1e9,
                             device_gbytes_per_s=(
                                 nbytes / (device_ms * 1e-3) / 1e9
                                 if device_ms else None)))
        del w, h, got
        torch.cuda.empty_cache()
    acts = _moe_gmm_acts(gen)
    return dict(phase="moe_gmm", sweep_cases=2 * len(GMM_SWEEP),
                sweep_max_abs_err=sweep_err, rows=rows, **acts)


# the gate's activations beside silu (ROADMAP Queue 3, F7), and the f32
# backward's tolerance for them: of each gradient's largest value
GMM_ACTS = ("gelu", "relu")
GMM_ACT_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


# relu's derivative steps at G = 0: where the plain version's G lies within
# this share of sum |h| |Wg| of zero, two f32 summation orders may take
# either side of the step
RELU_STEP_SHARE = 2.0**-16


def _relu_steps(h, wg, wu, wd, dout) -> tuple:
    """relu's step in the backward: (the elements (e, c, f) whose G = h Wg
    lies within `RELU_STEP_SHARE` of sum |h| |Wg| of zero, each gradient's
    most the kernel may move by taking the other side of the step there:
    dh by sum_f |dA U| |Wg|, dWg by sum_c |h| |dA U| over those elements,
    dWu and dWd not at all)."""
    import torch

    h32, g32, u32, d32, o32 = (t.float() for t in (h, wg, wu, wd, dout))
    g = torch.einsum("ecd,edf->ecf", h32, g32)
    near = g.abs() <= RELU_STEP_SHARE * torch.einsum(
        "ecd,edf->ecf", h32.abs(), g32.abs())
    step = (torch.einsum("ecd,efd->ecf", o32, d32)
            * torch.einsum("ecd,edf->ecf", h32, u32)).abs() * near
    zero = torch.zeros((), device=h.device)
    return int(near.sum()), [
        torch.einsum("ecf,edf->ecd", step, g32.abs()),
        torch.einsum("ecd,ecf->edf", h32.abs(), step), zero, zero]


def _act_grads_held(got, want, dtype, what: str, steps=None) -> float:
    """Each gradient within tol max|want| + tol |want| (`GMM_ACT_BWD_TOL`),
    plus what `steps` (`_relu_steps`) allows it; the largest difference
    over max|want|."""
    tol, worst = GMM_ACT_BWD_TOL[_dname(dtype)], 0.0
    allow = steps[1] if steps is not None else [0.0] * len(got)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        err = (g - w).abs()
        _check(float((err - tol * w.abs() - allow[i]).max()) <= tol * scale,
               f"{what} d{i}: |diff| {float(err.max())} beyond {tol} of "
               f"{scale}")
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
    return worst


def _moe_gmm_acts(gen) -> dict:
    """The gelu (tanh form) and relu instantiations of both moe_gmm
    kernels: the sweep in f32 and bf16, forward against `moe_gmm_ref`
    (f32 2e-5, bf16 2e-2) and backward (`kernel.moe_gmm_bwd`) against
    `moe_gmm_bwd_ref` with the same activation (f32 1e-4, bf16 2e-2 of
    each gradient's largest value), then qwen3-moe's shapes (E 128, D
    2048, F 768: forward at C 4 and C 40, backward at its training C
    320, bf16; forward at C 40 and backward at C 40 on 16 experts in
    f32), held the same way and timed (events, and the profiler's device
    ms) beside silu's instantiation on the same inputs.  relu's backward
    is held beside its step (`_relu_steps`: the elements whose G lies
    within rounding of zero, counted, may take either side), as long as
    under 1e-3 of the elements lie there."""
    import torch

    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref, moe_gmm_ref

    def inputs(E, C, D, Fd, dtype, scale=None):
        h = _randn((E, C, D), gen, dtype)
        w = [_randn(s, gen, dtype, scale or s[1] ** -0.5)
             for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
        return h, w, _randn((E, C, D), gen, dtype)

    fwd_err, bwd_rel, n = 0.0, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in GMM_SWEEP:
            h, w, dout = inputs(*case, dtype, scale=0.1)
            for act in GMM_ACTS:
                what = f"moe_gmm {act} sweep {case} {_dname(dtype)}"
                fwd_err = max(fwd_err, _held(moe_gmm(h, *w, act),
                                             moe_gmm_ref(h, *w, act), dtype,
                                             what))
                bwd_rel = max(bwd_rel, _act_grads_held(
                    gmm.moe_gmm_bwd(h, *w, dout, act),
                    moe_gmm_bwd_ref(h, *w, dout, act), dtype, what,
                    _relu_steps(h, *w, dout) if act == "relu" else None))
                n += 1
    rows = []
    for dtype, pass_, E, C in ((torch.bfloat16, "forward", 128, 4),
                               (torch.bfloat16, "forward", 128, 40),
                               (torch.bfloat16, "backward", 128, 320),
                               (torch.float32, "forward", 128, 40),
                               (torch.float32, "backward", 16, 40)):
        h, w, dout = inputs(E, C, 2048, 768, dtype)
        row = {"pass": pass_, "dtype": _dname(dtype), "E": E, "C": C,
               "D": 2048, "F": 768}
        for act in ("silu",) + GMM_ACTS:
            what = f"moe_gmm {act} {pass_} E={E} C={C} {_dname(dtype)}"
            if pass_ == "forward":
                def call(act=act):
                    return gmm.moe_gmm_fwd(h, *w, act)
                if act != "silu":
                    row[f"{act}_max_abs_err"] = _held(
                        call(), moe_gmm_ref(h, *w, act), dtype, what)
                names = ("moe_gmm",)
            else:
                def call(act=act):
                    return gmm.moe_gmm_bwd(h, *w, dout, act)
                steps = None
                if act == "relu":
                    steps = _relu_steps(h, *w, dout)
                    row["relu_step_elements"] = steps[0]
                    _check(steps[0] <= 1e-3 * E * C * 768,
                           f"{what}: {steps[0]} elements at relu's step")
                if act != "silu":
                    row[f"{act}_max_rel_err"] = _act_grads_held(
                        call(), moe_gmm_bwd_ref(h, *w, dout, act), dtype,
                        what, steps)
                names = ("moe_bwd",)
            row[f"{act}_ms"] = _cuda_ms(call, reps=5)
            row[f"{act}_device_ms"] = _device_ms(call, names, reps=5)
        rows.append(row)
        del h, w, dout
        torch.cuda.empty_cache()
    return dict(act_sweep_cases=n, act_sweep_max_abs_err=fwd_err,
                act_sweep_bwd_max_rel_err=bwd_rel, act_rows=rows)


MAMBA_SWEEP = [(1, 16, 8, 4), (2, 32, 16, 4), (1, 24, 12, 2), (2, 16, 8, 8)]
RGLRU_SWEEP = [(1, 32, 16), (2, 64, 8), (1, 48, 24)]   # B, S, D


def _scan_tol(dtype) -> float:
    """tests/test_kernels.py:66-69: f32 1e-4, bf16 2e-2, atol = rtol."""
    import torch

    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def _uniform(shape, gen, lo, hi, dtype):
    import torch

    x = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (lo + (hi - lo) * x).to(dtype)


SFU_PER_CLOCK = 16   # exponentials a clock an SM (CUDA guide, sm_90)
SMS = 132           # H100 SXM


def _sm_clock_mhz(fn, calls: int) -> float:
    """The SM clock (MHz) while `fn` runs: nvidia-smi samples clocks.sm
    every 20 ms beside `calls` back-to-back calls; the highest sample, as
    the idle samples before and after are lower."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.5)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    return max(float(v) for v in out.split() if v.strip())


def phase_mamba_scan() -> dict:
    """The selective scan at the sweep of tests/test_kernels.py:47-53 and
    at falcon-mamba-7b's prefill (B 1, D 8192, N 16) at S 512 and 134 (its
    longest and shortest prompts): the model's types (x bf16; dt, B, C
    f32) and, at S 512, all f32; and at its training shape, S 4096.  y
    and the final state h_S against the plain version; times; the
    function's bound beside the floor of its exponentials on the SFU; no
    library call computes a selective scan.  Each model row also runs
    with the chunk states the training path keeps (`states=True`): y and
    h_S the same bits, the states within 1e-4 of the plain version's,
    timed apart (`states_ms`, `states_device_ms`)."""
    import math

    import torch

    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_fwd
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    sweep_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, D, N in MAMBA_SWEEP:
            args = (_randn((B, S, D), gen, dtype),
                    _uniform((B, S, D), gen, 0.01, 0.2, dtype),
                    _randn((B, S, N), gen, dtype),
                    _randn((B, S, N), gen, dtype),
                    -torch.exp(_randn((D, N), gen, torch.float32)),
                    _randn((D,), gen, torch.float32))
            y, h = mamba_scan(*args)
            ry, rh = mamba_scan_ref(*args)
            what = f"mamba_scan sweep {(B, S, D, N)} {dtype}"
            sweep_err = max(sweep_err,
                            _held(y, ry, dtype, what, _scan_tol(dtype)),
                            _held(h, rh, dtype, what + " h_S", _scan_tol(dtype)))
            y2, h2 = mamba_scan(*args)
            _check(torch.equal(y, y2) and torch.equal(h, h2),
                   f"{what} not deterministic")
    rows = []
    B, N = 1, 16
    # falcon-mamba's 8,192 channels, and a rank's 2,048 of them at
    # `model` 4 (tp_ssm_full's training and prefill shapes)
    for S, x_dtype, D in ((512, torch.bfloat16, 8192),
                          (512, torch.float32, 8192),
                          (134, torch.bfloat16, 8192),
                          (4096, torch.bfloat16, 8192),
                          (4096, torch.bfloat16, 2048),
                          (512, torch.bfloat16, 2048)):
        # the model's draws: A = -(1..N) (S4D-real), D = 1, dt = softplus
        # of the projection plus a bias set for steps in [1e-3, 1e-1]
        x = _randn((B, S, D), gen, x_dtype)
        step = torch.exp(_uniform((B, S, D), gen, math.log(1e-3),
                                  math.log(1e-1), torch.float32))
        args = (x, step, _randn((B, S, N), gen, torch.float32),
                _randn((B, S, N), gen, torch.float32),
                -torch.arange(1, N + 1, device="cuda",
                              dtype=torch.float32).repeat(D, 1),
                torch.ones(D, device="cuda"))
        y, h = mamba_scan(*args)
        ry, rh = mamba_scan_ref(*args)
        what = f"mamba_scan falcon-mamba S {S} D {D} x {x_dtype}"
        err = max(_held(y, ry, x_dtype, what, 1e-4),
                  _held(h, rh, x_dtype, what + " h_S", 1e-4))
        y2, h2 = mamba_scan(*args)
        _check(torch.equal(y, y2) and torch.equal(h, h2),
               f"{what} not deterministic")
        ky, kh, states = mamba_scan_fwd(*args, states=True)
        _check(torch.equal(y, ky) and torch.equal(h, kh),
               f"{what}: y, h_S moved with the chunk states")
        err = max(err, _held(states, mamba_scan_ref(*args, states=True)[2],
                             x_dtype, what + " states", 1e-4))
        del ky, kh, states
        fn = lambda: mamba_scan_fwd(*args)  # noqa: E731
        fn_states = lambda: mamba_scan_fwd(*args, states=True)  # noqa: E731
        ms = _cuda_ms(fn, reps=20)
        device_ms = _device_ms(fn, ("mamba_scan_fwd",), reps=20)
        states_ms = _cuda_ms(fn_states, reps=20)
        states_device_ms = _device_ms(fn_states, ("mamba_scan_fwd",),
                                      reps=20)
        plain_ms = _cuda_ms(lambda: mamba_scan_ref(*args), reps=3, warmup=1)
        mhz = _sm_clock_mhz(fn, calls=4000)
        # x, dt read once, y written once; B, C per step; A, D, h_S
        nbytes = (B * S * D * (x.element_size() + 4 + 4) + 2 * B * S * N * 4
                  + 4 * D * N + 4 * D + 4 * B * D * N)
        ops = B * S * D * (7 * N + 3)   # f32, on the CUDA cores
        bound_ms, bound_by = _bound(nbytes, ops, torch.float32)
        # the design reads B and C again in every block of 32 channels
        # (from L2 after the first)
        design_bytes = nbytes + (-(-D // 32) - 1) * 2 * B * S * N * 4
        exps = B * S * D * N
        rows.append(dict(x_dtype=_dname(x_dtype), p_dtype="float32", B=B,
                         S=S, D=D, N=N, max_abs_err=err, ms=ms,
                         device_ms=device_ms, states_ms=states_ms,
                         states_device_ms=states_device_ms,
                         states_bytes=4 * B * -(-S // 16) * D * N,
                         plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound_ms,
                         bound_by=bound_by,
                         bound_share=(bound_ms / device_ms
                                      if device_ms else None),
                         exps=exps, sm_clock_mhz=mhz,
                         sfu_floor_ms=exps / (SFU_PER_CLOCK * SMS * mhz * 1e6)
                         * 1e3,
                         design_bytes=design_bytes,
                         design_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
                         gbytes_per_s=nbytes / (ms * 1e-3) / 1e9))
        del args, x, step, y, h, ry, rh, y2, h2
        torch.cuda.empty_cache()
    return dict(phase="mamba_scan", sweep_cases=2 * len(MAMBA_SWEEP),
                sweep_max_abs_err=sweep_err, rows=rows)


def phase_rglru_scan() -> dict:
    """The RG-LRU recurrence at the sweep of tests/test_kernels.py:73-75
    and at recurrentgemma-2b's longest and shortest prefills (B 1, S 3300
    and 900, D 2560; a and bx f32 as the model's gates are, and bf16) and
    at S 32768, where 512 chunks show whether the carries stay linear:
    device ms of the three passes together and of each, the function's
    bound and the design's 20 B an element (a and bx read twice); no
    library call computes a gated linear recurrence."""
    import torch

    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    sweep_err = 0.0
    # recurrentgemma's 2,560 channels, and a rank's 640 of them at
    # `model` 4
    shapes = RGLRU_SWEEP + [(1, 3300, 2560), (1, 900, 2560),
                            (1, 32768, 2560), (1, 3300, 640),
                            (1, 4096, 640)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, D in shapes:
            a = _uniform((B, S, D), gen, 0.7, 0.999, dtype)
            bx = _randn((B, S, D), gen, dtype)
            h0 = _randn((B, D), gen, torch.float32)
            got = rglru_scan(a, bx, h0)
            err = _held(got, rglru_scan_ref(a, bx, h0), dtype,
                        f"rglru_scan {(B, S, D)} {dtype}", _scan_tol(dtype))
            _check(torch.equal(got, rglru_scan(a, bx, h0)),
                   f"rglru_scan {(B, S, D)} {dtype} not deterministic")
            if (B, S, D) in RGLRU_SWEEP:
                sweep_err = max(sweep_err, err)
                continue
            fn = lambda: rglru_scan_fwd(a, bx, h0)  # noqa: E731
            ms = _cuda_ms(fn, reps=20)
            passes = ("rglru_chunk_ends", "rglru_chunk_carry",
                      "rglru_chunk_scan")
            device_ms, ends_ms, carry_ms, scan_ms = (
                _device_ms(fn, names, reps=20)
                for names in (passes,) + tuple((p,) for p in passes))
            plain_ms = _cuda_ms(lambda: rglru_scan_ref(a, bx, h0), reps=3,
                                warmup=1)
            es = a.element_size()
            nbytes = B * S * D * (2 * es + 4) + 4 * B * D
            bound_ms, bound_by = _bound(nbytes, 2 * B * S * D, torch.float32)
            design_bytes = B * S * D * (4 * es + 4) + 4 * B * D
            rows.append(dict(dtype=_dname(dtype), B=B, S=S, D=D,
                             max_abs_err=err, ms=ms, device_ms=device_ms,
                             ends_device_ms=ends_ms,
                             carry_device_ms=carry_ms, scan_device_ms=scan_ms,
                             plain_ms=plain_ms, library_ms=None,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_share=(bound_ms / device_ms
                                          if device_ms else None),
                             design_bytes=design_bytes,
                             design_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
                             gbytes_per_s=nbytes / (ms * 1e-3) / 1e9))
            del a, bx, h0, got
            torch.cuda.empty_cache()
    return dict(phase="rglru_scan", sweep_cases=2 * len(RGLRU_SWEEP),
                sweep_max_abs_err=sweep_err, rows=rows)


# Each golden run: (phase, arch, stored file, kernel launches per layer
# of each of its kinds per prefill and per decode tick; a kind named
# twice launches twice, as a decoder layer's self- and cross-attention).
DENSE_KERNELS = {"flash_attention": (("self_attn",), 1, 0)}
GOLDEN_RUNS = [
    ("serve_golden", ARCH, "qwen3_moe_reduced_golden.npz",
     {"flash_attention": (("moe",), 1, 0), "moe_gmm": (("moe",), 1, 1)}),
    ("serve_golden_mamba", "falcon-mamba-7b", "falcon_mamba_reduced_golden.npz",
     {"mamba_scan": (("ssm",), 1, 0)}),
    ("serve_golden_rgemma", "recurrentgemma-2b",
     "recurrentgemma_reduced_golden.npz",
     {"rglru_scan": (("rglru",), 1, 0),
      "flash_attention": (("local_attn",), 1, 0)}),
    ("serve_golden_deepseek", "deepseek-moe-16b",
     "deepseek_moe_16b_reduced_golden.npz",
     {"flash_attention": (("dense", "moe"), 1, 0),
      "moe_gmm": (("moe",), 1, 1)}),
    ("serve_golden_smollm", "smollm-360m", "smollm_360m_reduced_golden.npz",
     DENSE_KERNELS),
    ("serve_golden_yi", "yi-9b", "yi_9b_reduced_golden.npz", DENSE_KERNELS),
    ("serve_golden_stablelm", "stablelm-12b",
     "stablelm_12b_reduced_golden.npz", DENSE_KERNELS),
    ("serve_golden_qwen15", "qwen1.5-110b", "qwen15_110b_reduced_golden.npz",
     DENSE_KERNELS),
    ("serve_golden_seamless", "seamless-m4t-large-v2",
     "seamless_m4t_large_v2_reduced_golden.npz",
     {"flash_attention": (("encoder", "decoder", "decoder"), 1, 0)}),
    ("serve_golden_llama_vision", "llama-3.2-vision-90b",
     "llama32_vision_90b_reduced_golden.npz",
     {"flash_attention": (("self_attn", "cross_attn"), 1, 0)}),
]
# JAX's `param_count()` of each transformer arch at full width and depth
FULL_PARAMS = {"deepseek-moe-16b": 16_375_728_128,
               "smollm-360m": 361_821_120, "yi-9b": 8_829_407_232,
               "stablelm-12b": 12_143_339_520,
               "qwen1.5-110b": 111_209_914_368,
               "seamless-m4t-large-v2": 1_632_698_368,
               "llama-3.2-vision-90b": 87_666_794_496}


def _expected_launches(cfg, kernels: dict, prefills: int, ticks: int) -> dict:
    """Launches each kernel must count: per layer of its kinds (the
    decoder's and the encoder's), per prefill and per decode tick."""
    from repro_torch.models.transformer import encoder_plan, stack_plan

    kinds = stack_plan(cfg).kinds + encoder_plan(cfg).kinds
    return {name: sum(on.count(k) for k in kinds)
            * (per_prefill * prefills + per_tick * ticks)
            for name, (on, per_prefill, per_tick) in kernels.items()}


def _seeded_run(params, cfg, stored: dict, i: int, what: str) -> float:
    """A golden run's prompt on its stored seeded source (encoder frames
    or image embeddings): the prefill logits, then the decode steps'
    logits on the stored greedy tokens, each within 1e-4 of the JAX
    package's.  Returns the largest difference."""
    import numpy as np
    import torch

    from repro_torch.models.model import (
        CROSS_INPUT,
        forward_decode,
        forward_prefill,
    )

    prompt = stored[f"prompt/{i}"]
    batch = {"tokens": torch.as_tensor(prompt[None].astype(np.int64),
                                       device="cuda")}
    want = [stored[f"logits/{i}"]]
    if f"embeds/{i}" in stored:
        batch[CROSS_INPUT[cfg.family]] = torch.as_tensor(
            stored[f"embeds/{i}"][None], device="cuda")
        want += list(stored[f"seeded_logits/{i}"])
    logits, caches = forward_prefill(params, batch, cfg, cache_len=64)
    worst = 0.0
    for step, w in enumerate(want):
        if step:
            tok = int(stored[f"seeded_tokens/{i}"][step - 1])
            logits, caches = forward_decode(
                params, torch.tensor([[tok]], device="cuda"),
                torch.tensor([len(prompt) + step - 1], device="cuda"),
                caches, cfg)
        w = torch.as_tensor(w, device="cuda")
        err = (logits[0] - w).abs()
        _check(bool((err <= 1e-4 + 1e-4 * w.abs()).all()),
               f"{what} logits {i} step {step}: {float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def phase_serve_golden(root: Path, phase: str, arch: str, fname: str,
                       kernels: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.serve.engine import Request, ServeEngine

    stored = dict(np.load(root / "src" / "repro_torch" / "data" / fname))
    # the head layout the golden run was made in, where it records one
    layout = json.loads(str(stored["config"])) if "config" in stored else {}
    cfg = reduced_config(get_config(arch)).replace(compute_dtype="float32",
                                                   **layout)
    params = params_from_numpy(cfg, tree_from_flat(
        {k[len("param/"):]: v for k, v in stored.items()
         if k.startswith("param/")}), device="cuda")
    n = sum(1 for k in stored if k.startswith("prompt/"))
    prompts = [stored[f"prompt/{i}"] for i in range(n)]
    with torch.no_grad():
        logit_err = max(_seeded_run(params, cfg, stored, i, phase)
                        for i in range(n))
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cuda")
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=8))
    launch_counts.clear()
    done = eng.run_to_completion(max_ticks=200)
    launches = dict(launch_counts)
    _check(len(done) == n, f"{phase} finished {len(done)} of {n}")
    for r in done:
        want = stored[f"tokens/{r.rid}"].tolist()
        _check(r.out_tokens == want,
               f"{phase} tokens {r.rid}: {r.out_tokens} != {want}")
    expected = _expected_launches(cfg, kernels, eng.prefills, eng.ticks)
    _check(launches == expected, f"{phase} launches {launches} != {expected}")
    seeded = {}
    if "embeds/0" in stored:
        seeded = dict(source_lens=[len(stored[f"embeds/{i}"])
                                   for i in range(n)],
                      seeded_decode_steps=len(stored["seeded_logits/0"]))
        # the JAX engine's tokens, where they differ: its padded cross
        # caches (ROADMAP Queue 3, R4)
        seeded["jax_engine_differs"] = [
            i for i in range(n) if stored[f"jax_engine_tokens/{i}"].tolist()
            != stored[f"tokens/{i}"].tolist()]
    return dict(phase=phase, arch=arch, layout=layout, requests=n,
                prompt_lens=[len(p) for p in prompts], prefills=eng.prefills,
                ticks=eng.ticks, tokens_equal=True,
                prefill_logits_max_abs_err=logit_err, **seeded,
                **{f"{k}_launches": v for k, v in launches.items()})


def _decode_breakdown(eng, ticks: int) -> dict:
    """Device time by kernel over `ticks` decode ticks (all slots live)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    kern, host = [], []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "device_time_total", 0.0)
            if us > 0:
                kern.append((e.key, us / ticks / 1e3, e.count // ticks))
        else:
            host.append((e.key, e.self_cpu_time_total / ticks / 1e3,
                         e.count / ticks))
    kern.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kern)
    waits = {k: c for k, _, c in host
             if "Synchronize" in k or "Memcpy" in k or k == "aten::item"}
    # the profiler slows the host, so wall_ms is no tick time
    return dict(ticks=ticks, profiled_wall_ms_per_tick=wall_ms,
                device_ms_per_tick=device_ms,
                host_ops_per_tick=sum(c for k, _, c in host
                                      if k.startswith("aten::")),
                waits_per_tick=waits,
                top=[dict(kernel=k[:90], ms_per_tick=ms, launches_per_tick=c)
                     for k, ms, c in kern[:14]],
                top_host=[dict(op=k[:60], self_ms_per_tick=ms, calls_per_tick=c)
                          for k, ms, c in host[:12]])


def _free_card() -> None:
    """Let the last phase's weights go before the next phase's arrive."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_full(phase: str, arch: str, slots: int, max_seq: int,
                     max_new: int, lens, kernels: dict,
                     probe_len: int = 256, layers: int = 0,
                     why: str = "") -> dict:
    """`arch` at full width and depth in bf16, seed-0 random weights on
    the card: a `ServeEngine` serves one request per prompt length
    (token ids numpy seed 0; `lens` None draws qwen3-moe's traffic from
    that generator first: 8 prompts of 455, 373, 324, 231, 246, 143, 156
    and 134 tokens), `max_new` tokens each; every kernel launch
    is counted against `kernels` (as GOLDEN_RUNS); then `slots` fresh
    requests of `probe_len` tokens and a profiled window of decode ticks
    show where a tick's time goes.  `layers` > 0 cuts the depth (never
    the width) to that many layers, for the reason `why`, and the phase
    prints the cut."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import (
        CROSS_INPUT,
        count_params,
        forward_prefill,
        init_params,
    )
    from repro_torch.serve.engine import Request, ServeEngine

    _free_card()
    cfg = get_config(arch)            # full width, full depth, bf16 compute
    if arch in FULL_PARAMS:
        _check(count_params(cfg) == FULL_PARAMS[arch],
               f"{phase} full-width count {count_params(cfg)}")
    reduced = {}
    if layers:
        reduced = {"num_layers": [cfg.num_layers, layers]}
        print(f"reduced: {json.dumps(reduced)} ({why})", flush=True)
        cfg = cfg.replace(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    _check(n_params == count_params(cfg), f"{phase} params {n_params}")
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, device="cuda")
    rng = np.random.default_rng(0)
    if lens is None:
        lens = rng.integers(128, 513, 8)
    lens = [int(L) for L in lens]
    for rid, L in enumerate(lens):
        eng.submit(Request(rid=rid, max_new_tokens=max_new, prompt=rng.integers(
            0, cfg.vocab_size, L).astype(np.int32)))
    launch_counts.clear()
    t0 = time.perf_counter()
    done = eng.run_to_completion(max_ticks=400)
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_req = len(lens)
    _check(len(done) == n_req, f"{phase} finished {len(done)} of {n_req}")
    _check(all(len(r.out_tokens) == max_new for r in done),
           f"{phase} short outputs")
    _check(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
           f"{phase} token out of range")
    _check(eng.prefills == n_req, f"{phase} prefills {eng.prefills}")
    expected = _expected_launches(cfg, kernels, eng.prefills, eng.ticks)
    _check(launches == expected, f"{phase} launches {launches} != {expected}")
    with torch.no_grad():   # logits of the last request's prefill
        tokens = torch.as_tensor(done[-1].prompt[None].astype(np.int64),
                                 device="cuda")
        batch = {"tokens": tokens}
        if cfg.family in CROSS_INPUT:   # on a seeded source, not zeros
            n = (tokens.shape[1] if cfg.family == "encdec"
                 else cfg.num_image_tokens)
            gen = torch.Generator(device="cuda").manual_seed(0)
            batch[CROSS_INPUT[cfg.family]] = _randn(
                (1, n, cfg.d_model), gen, torch.bfloat16)
        logits, _ = forward_prefill(params, batch, cfg)
    _check(bool(torch.isfinite(logits).all()), f"{phase} non-finite logits")
    # a decode tick reads every weight (all experts hold capacity rows at
    # C = 4 for qwen3-moe) but the encoder's, which runs at prefill only,
    # the embedding only as its `slots` rows unless it is also the (tied)
    # head, and the whole decode state (self and cross)
    embed = params["embed"]
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in eng.cache for t in c.values())
    tick_bytes = param_bytes + cache_bytes - sum(
        p.numel() * p.element_size() for name in ("encoder", "enc_norm")
        if name in params for p in params[name].parameters())
    if not cfg.tie_embeddings:
        tick_bytes -= (embed.shape[0] - slots) * embed.shape[1] * embed.element_size()
    out = dict(
        phase=phase, arch=cfg.name, layers=cfg.num_layers, reduced=reduced,
        reduced_why=why,
        d_model=cfg.d_model, params=n_params, param_bytes=param_bytes,
        init_s=init_s, requests=n_req, prompt_lens=lens, new_tokens=max_new,
        slots=slots, max_seq=max_seq, wall_s=wall, prefills=eng.prefills,
        prefill_tokens=eng.prefill_tokens, prefill_s=eng.prefill_s,
        prefill_tokens_per_s=eng.prefill_tokens / eng.prefill_s,
        ticks=eng.ticks, decode_ms_per_tick=eng.decode_s / eng.ticks * 1e3,
        decode_bound_ms=tick_bytes / HBM_BYTES_PER_S * 1e3,
        decode_tick_bytes=tick_bytes, peak_bytes=peak,
        **{f"{k}_launches": v for k, v in launches.items()})
    # where a tick goes: fresh requests in every slot, then a profiled window
    for rid in range(slots):
        eng.submit(Request(rid=100 + rid, max_new_tokens=64, prompt=rng.integers(
            0, cfg.vocab_size, probe_len).astype(np.int32)))
    eng.step()
    out["decode_breakdown"] = bd = _decode_breakdown(eng, ticks=4)
    # the unprofiled ticks above against the profiled device time
    out["idle_share"] = 1.0 - bd["device_ms_per_tick"] / out["decode_ms_per_tick"]
    del params, eng, done, logits
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.netsim.sweep import appendix_b_grid

    # plain versions and f32 paths in full f32, as the JAX package's dots
    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    seconds = {}

    def run(fn, *args, **kw) -> dict:
        """Run one phase, print its line and keep its seconds."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[out["phase"]] = time.perf_counter() - t0
        _emit(out)
        return out

    run(phase_build)
    # training first, so that a failure shows early
    flash_bwd = run(phase_flash_attention_bwd)
    bwd_phases = {p["phase"]: p for p in (
        run(phase_moe_gmm_bwd), run(phase_rglru_scan_bwd),
        run(phase_mamba_scan_bwd))}
    train_runs = [run(phase_train_golden, root, *spec)
                  for spec in TRAIN_RUNS]
    train_full = run(phase_train_full, root)
    train_runs.append(train_full)
    # several ranks on the one card: the rotor collectives, opera-dp
    run(phase_collectives)
    # the 4-rank phases, on four rank processes started once
    with _RankPool():
        train_runs.append(run(phase_opera_dp_golden, root))
        train_runs.append(run(phase_opera_dp_full, train_full))
        # every leaf under the FSDP / TP layout
        train_runs.append(run(phase_fsdp_golden, root))
        train_runs.append(run(phase_fsdp_full, train_full))
        # experts sharded over the model axis
        train_runs.append(run(phase_ep_golden, root))
        train_runs.append(run(phase_ep_full))
        # attention, FFNs and the vocabulary split over `model`
        train_runs.append(run(phase_tp_golden, root))
        train_runs.append(run(phase_tp_full))
        # serving over `model`: two phases of one task
        t0 = time.perf_counter()
        serve_mesh = phase_serve_mesh(root)
        seconds["serve_mesh_golden"] = serve_mesh["golden_s"]
        seconds["serve_mesh_full"] = (time.perf_counter() - t0
                                      - serve_mesh["golden_s"])
        mesh_runs = [serve_mesh["golden"], serve_mesh["full"]]
        for out in mesh_runs:
            _emit(out)
        # the mamba and RG-LRU mixers split by channels over `model`
        train_runs.append(run(phase_tp_ssm_golden, root))
        train_runs.append(run(phase_tp_ssm_full))
    train_runs += [run(phase_train_arch_full, *spec)
                   for spec in ARCH_TRAIN_RUNS]
    _free_card()
    t0 = time.perf_counter()
    topos = {dp.name: _topology(dp) for dp in appendix_b_grid()}
    seconds["topologies"] = time.perf_counter() - t0
    _emit(dict(phase="topologies", seconds=seconds["topologies"]))

    # (design, batch): Fig. 8 runs k12-n108-g1 at B = 1, the sweep k64 at 16
    kern = run(phase_kernel, [(k, topos[k], b, state) for k, b, state in (
        ("k8-n16-g1", 16, "random"), ("k12-n108-g1", 1, "random"),
        ("k12-n108-g1", 16, "random"), ("k12-n108-g2", 16, "random"),
        ("k64-n1024-g4", 16, "random"), ("k64-n1024-g4", 16, "worst_case"))])
    run(phase_fig08, root)
    sweep = run(phase_sweep, topos["k64-n1024-g4"])
    run(phase_crossover, topos)
    run(phase_fig11, root)
    run(phase_flows_tiled, root)
    run(phase_faulted_sparse_k64, topos["k64-n1024-g4"], sweep)
    del topos
    flash = run(phase_flash_attention)
    gmm = run(phase_moe_gmm)
    mamba = run(phase_mamba_scan)
    rglru = run(phase_rglru_scan)
    for phase, arch, fname, kernels in GOLDEN_RUNS:
        run(phase_serve_golden, root, phase, arch, fname, kernels)
    golden_kernels = {phase: k for phase, _, _, k in GOLDEN_RUNS}
    runs = [run(phase_serve_full, "serve_full", ARCH, 4, 1024, 16, None,
                golden_kernels["serve_golden"])]
    runs.append(run(phase_serve_full, "serve_full_falcon_mamba",
                    "falcon-mamba-7b", 4, 1024, 16, None,
                    golden_kernels["serve_golden_mamba"]))
    runs.append(run(phase_serve_full, "serve_full_rgemma",
                    "recurrentgemma-2b", 2, 4096, 16,
                    [3300, 2600, 1900, 900],
                    golden_kernels["serve_golden_rgemma"]))
    # the transformer archs of the JAX package at full width, qwen3-moe's
    # traffic; qwen1.5-110b's 80 layers (~225 GB of bf16 weights) and
    # llama-3.2-vision-90b's 100 (~175 GB) do not fit the card's 80 GB, so
    # they keep 20 and 35 (28 self + 7 cross) of them
    for phase, arch, layers, why in (
            ("serve_full_deepseek", "deepseek-moe-16b", 0, ""),
            ("serve_full_smollm", "smollm-360m", 0, ""),
            ("serve_full_yi", "yi-9b", 0, ""),
            ("serve_full_stablelm", "stablelm-12b", 0, ""),
            ("serve_full_qwen15", "qwen1.5-110b", 20,
             "80 layers of bf16 weights need ~225 GB; 20 fit the card's "
             "80 GB"),
            ("serve_full_seamless", "seamless-m4t-large-v2", 0, ""),
            ("serve_full_llama_vision", "llama-3.2-vision-90b", 35,
             "100 layers of bf16 weights need ~175 GB; 35 (28 self + 7 "
             "cross) fit the card's 80 GB")):
        runs.append(run(
            phase_serve_full, phase, arch, 4, 1024, 16, None,
            golden_kernels[phase.replace("serve_full", "serve_golden")],
            layers=layers, why=why))

    main_row = next(r for r in kern["rows"] if r["design"] == "k64-n1024-g4"
                    and r["state"] == "random" and r["vlb"])
    # the serving path's shapes: bf16, qwen3-moe's 512-token prefill and
    # decode tick
    flash_row = next(r for r in flash["rows"] if r["dtype"] == "bfloat16"
                     and r["S"] == 512 and r["hd"] == 128 and r["Hq"] == 32)
    gmm_row = next(r for r in gmm["rows"] if r["dtype"] == "bfloat16"
                   and r["C"] == 4 and r["E"] == 128)
    kernels = [dict(
        name="rotor_slice", route="cuda",
        source="src/repro_torch/kernels/rotor_slice/csrc/rotor_slice.cu",
        replaces="src/repro/kernels/rotor_slice/kernel.py:41",
        launches=sweep["rotor_slice_launches"],
        max_abs_err=max(r["max_abs_err"] for r in kern["rows"]),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None)]
    # the main paths' shapes: falcon-mamba's 512-token prefill (x bf16),
    # recurrentgemma's 3,300-token prefill (f32 gates)
    mamba_row = next(r for r in mamba["rows"]
                     if r["x_dtype"] == "bfloat16" and r["S"] == 512
                     and r["D"] == 8192)
    rglru_row = next(r for r in rglru["rows"]
                     if r["dtype"] == "float32" and r["S"] == 3300
                     and r["D"] == 2560)
    # launches: every full serving run the kernel is on, summed, and for
    # flash the training runs too
    runs += train_runs + mesh_runs
    for name, row, phase, replaces in (
            ("flash_attention", flash_row, flash,
             "src/repro/kernels/flash_attention/kernel.py:22"),
            ("moe_gmm", gmm_row, gmm, "src/repro/kernels/moe_gmm/kernel.py:19"),
            ("mamba_scan", mamba_row, mamba,
             "src/repro/kernels/mamba_scan/kernel.py:21"),
            ("rglru_scan", rglru_row, rglru,
             "src/repro/kernels/rglru_scan/kernel.py:19")):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            replaces=replaces,
            launches=sum(r.get(f"{name}_launches", 0) for r in runs),
            max_abs_err=max([phase["sweep_max_abs_err"]]
                            + [r["max_abs_err"] for r in phase["rows"]]),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    # the training path's shape: smollm-360m, B 8, S 4096, bf16, causal
    bwd_row = next(r for r in flash_bwd["rows"] if r["S"] == 4096)
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_bwd.cu",
        replaces="jax.grad of src/repro/models/attention.py:85 (the JAX "
                 "package has no backward kernel)",
        launches=sum(r.get("flash_attention_bwd_launches", 0)
                     for r in train_runs),
        max_abs_err=max(r["max_abs_err"] for r in flash_bwd["rows"]),
        ms=bwd_row["ms"], plain_ms=bwd_row["plain_ms"],
        bound_ms=bwd_row["bound_ms"], bound_by=bwd_row["bound_by"],
        library_ms=bwd_row["library_ms"]))
    # the training paths' shapes: qwen3-moe's experts at 4,096 tokens (C
    # 320, bf16), recurrentgemma's scan (f32), falcon-mamba's (x bf16)
    for name, arch, model_site in (
            ("moe_gmm_bwd", "qwen3-moe-30b-a3b",
             "src/repro/models/moe.py:129-131 (the einsum trio)"),
            ("rglru_scan_bwd", "recurrentgemma-2b",
             "src/repro/models/rglru.py:55 (an associative scan)"),
            ("mamba_scan_bwd", "falcon-mamba-7b",
             "src/repro/models/ssm.py:58-118 (an associative scan)")):
        rows = bwd_phases[name]["rows"]
        row = next(r for r in rows if r["arch"] == arch)
        kname = name.replace("_bwd", "")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/{kname}/csrc/{name}.cu",
            replaces=f"jax.grad of {model_site}; the JAX package trains "
                     "through plain jnp and has no backward kernel",
            launches=sum(r.get(f"{name}_launches", 0) for r in train_runs),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
    # the gate's gelu and relu instantiations of both moe_gmm kernels
    # (ROADMAP Queue 3, F7; no config of the repo has a non-silu MoE, so
    # no path launches them): their largest errors against ref.py and
    # their times beside silu's, at qwen3-moe's decode tick (C 4) and its
    # training experts (C 320), bf16
    act_rows = {(r["pass"], r["dtype"], r["C"]): r for r in gmm["act_rows"]}
    for name, key, err in (("moe_gmm", ("forward", "bfloat16", 4),
                            "max_abs_err"),
                           ("moe_gmm_bwd", ("backward", "bfloat16", 320),
                            "max_rel_err")):
        row = act_rows[key]
        entry = next(k for k in kernels if k["name"] == name)
        entry["instantiations"] = [dict(
            act=act, **{err: max(r.get(f"{act}_{err}", 0.0)
                                 for r in gmm["act_rows"])},
            ms=row[f"{act}_ms"], device_ms=row[f"{act}_device_ms"],
            silu_ms=row["silu_ms"], silu_device_ms=row["silu_device_ms"],
            E=row["E"], C=row["C"]) for act in GMM_ACTS]
    _emit({"phase_seconds": seconds,
           "total_seconds": time.perf_counter() - start})
    _emit({"kernels": kernels})
    print(_card(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
