"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

Phases (any failed check raises, and the script exits nonzero):

1. The card's name and power limit (nvidia-smi), then the build of every
   kernel from ``src/repro_torch/kernels/csrc`` (timed).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at edge shapes: exact equality (float sums on
   integer-valued data). segment_reduce also around its 4096-row tiles
   (runs that end at a tile edge, one row before, one after), over one
   run of every row, over rows all out of range, with NaN in min/max, and
   at phase 7's shape on standard-normal data (``SEG_F32_TOL``).
   bucket_histogram at P 1 to 20000 (both sides of the register path's 8
   buckets), n from 1 around its unrolled step and its grid, views at
   offsets 1-3, all ids out of range, three calls in a row. segment_scan
   also with runs ending at its tile edges, views at offsets 1-3, two
   calls in a row on different n, and standard-normal sums at phase 7's
   shape and over one run through 4098 tiles: the same bits on 5 runs,
   within ``SCAN_F32_TOL`` of the plain version in float64.
   hash32_partition with one and three key columns (int32, uint32, float32
   with +-0, NaN, +-inf) at the path's shape, P 1, 7, 8 and 4096,
   row_count 0, one, partial and full, views at offsets 1-3 and ragged n.
   bitonic_sort_tiles at every tile size also on int64 keys over the whole
   range, equal keys, descending keys, int64-max keys and repeated
   payloads; bitonic_sort_permutation at C 1, 255, 256, 300, 1000, 2047
   and 2048 with the u32 max key among the rows, int32/uint32/float32 keys,
   row_count 0 to full, a view at offset 1. Also torch.sort's float order
   on the card and the shuffle's counts carrier in a float32 column.
3. The main path at a size users run: tables of the paper's relation
   (int32 key + 3 float32, 16 B a row), 8 virtual shards x 2**22 rows each
   (512 MiB a table), through ``DistContext``: the sort join, the hash join,
   groupby two_phase (bucket 256, so the combine sorts 2048 rows through
   bitonic_sort_permutation) and groupby shuffle (segment counts of 8 M) on
   ``key_range=1000``, the global sort, and the window functions (every
   one of them) over a fourth table of 16 B rows with 12 groups, so most
   groups span shards (range bucket 2**21, 2**24 slots a shard). Launch
   counts are zeroed just before and read just after, and each must equal
   ``MAIN_PATH_LAUNCHES``: hash32_partition 48, the column hash32 16,
   bucket_histogram 64, bitonic_sort_permutation 8, the tile entry 0,
   segment_scan_tiles 48 and segment_reduce_tiles 120.
4. The same calls under ``oracle_scope()`` (every plain version, on the
   card, no launches): the same rows, per-shard row counts and shuffle
   stats, bit for bit (the window's rows in order); groupby's float sums
   and what derives from them (sum, mean, var) within the tolerance stated
   in ``compare_groupby``.
5. Each operator's median wall time through the kernels and through the
   plain versions, run in turns; then through ``submit`` (the eager
   route) and straight into ``execute_plan`` (no plan cache, future or
   ladder), in turns in one process, with the same rows and the host
   syncs of one call of each.
6. One ``torch.profiler`` trace of each operator through the kernels (GPU
   busy share, the device time of the port's own kernels, the torch ops
   the host dispatched, the kernels that took the most device time).
7. Each kernel's median time at the path's shape beside its plain
   version's, one PyTorch library call's where one computes the same
   function (none computes a segmented scan: ``torch.cumsum`` of the same
   column is printed beside it instead), and the least time the card
   could take (``bound_ms``); beside them what the Timer reads for a
   one-element kernel and for a copy of the histogram's column, and for
   hash32_partition and bitonic_sort_permutation the torch chain each
   replaced (``replaced_chain_ms``). The bitonic bounds take the largest of
   bytes, one SM's operations and the network's dependent chain, timed by
   a one-warp probe in this run (``bitonic_bound``). Before them, each
   instance of the kernels redesigned in the last rounds (flash_fwd_bf16
   and the backward's flash_bwd_prep, flash_bwd_dkdv_bf16, flash_bwd_sum,
   flash_bwd_dq_bf16, flash_bwd_key_sums and flash_bwd_key_centres at
   every head dim, seg_fill, seg_pass1, seg_pass2, scan_lookback, hist_regs,
   hash32_partition_kernel, bitonic_tile, bitonic_perm) as the build's
   ``-Xptxas -v`` reported it: registers, stack frame, spill bytes, static
   shared memory (flash's dynamic shared memory from the library), and
   each source's nvcc seconds. The flash entries also at their other head
   dims (``flash_dims_timing``, named ``<entry>@hd160`` and ``@hd16``):
   hd 160 at phase 17's prefill layer (B 4, S 1024, H 32, KV 8) and
   training microbatch (B 1), hd 16 at B 4, S 1024, H 32, KV 8.

11. Statistics and the lazy plan, on the same tables (run after phase 6,
   before they are freed): ``ctx.analyze`` of the four tables (every
   TableStats field equal to the ``oracle_scope()`` run; hash32_partition
   launched exactly ``ANALYZE_LAUNCHES`` times, once a key column over all
   p x C slots; timed in turns with the plain run), the frame
   ``frame(a).select(d0 > 0).join(frame(b), on="k").groupby("k", ...)``
   on the analyzed tables (its ``explain()`` printed; rows equal to the
   ``oracle_scope()`` run and to the eager chain on the plain tables; timed
   in turns with that chain), groupby ``"auto"`` on ``b`` (``shuffle`` with
   stats, ``two_phase`` without; both timed), the shuffles elided off a
   sort's range tag and a ``partition_by``'s hash tag (``plan_report``
   against the executed records), one safe-capacity re-run at 8 x 2**16
   rows (stats that understate the rows overflow a cost-sized bucket), and
   one ``torch.profiler`` trace of each timed call.

13a. (after phase 11, on its tables) The plan verifier at full width:
   ``explain(verify=True)`` of phase 11's frames ends ``verification:
   clean``, and ``audit_collectives`` of its frame pipeline (one run,
   ``VirtualMesh.counts`` zeroed first) counts what ``expected_collectives``
   derives from the run's shuffle records.

12. The serving open loop (benchmarks/bench_serving.py's workload at the
   main path's scale): ``orders`` of 8 shards x 2**22 rows (``k`` int32 over
   64 keys, ``d0`` integer-valued float32, ``d1`` int32; 12 B a row) and a
   64-row ``dims``, registered with ``analyze=True`` in a
   ``ServingSession``; the shapes ``gb``, ``topn`` (sort + limit 32), ``sel``
   (an inline keyless lambda, cached by its content key) and ``join``; 8
   clients x 6 queries, at most 8 in flight, in three phases: cold
   sequential, warm sequential, warm async. Every query's rows equal across
   the phases and to the frame collected under ``oracle_scope()``; the warm
   phases prepare and re-prepare nothing; no query fails, degrades or is
   quarantined; hash32_partition, bucket_histogram, segment_reduce_tiles and
   bitonic_sort_permutation launch in every phase (the same counts in both
   warm phases); each shape's ``explain(verify=True)`` is clean. It prints
   each phase's q/s, p50/p99 ms, overflow re-runs and peak GiB, and the
   host synchronisations ``submit`` makes for one warm query of each shape
   (``torch.cuda.set_sync_debug_mode``). No ordering of the modes' speeds
   is asserted.
13b. Faults at 8 x 2**16 rows: each case of the port's
   ``repro_torch.testing.chaos_cases`` (shuffle garble and raise on staged
   and ring exchanges, kernel raise, NaN and persistent, a derated
   ``stats.estimate``, ``cache.admission`` miss and evict, ``compile`` on
   the warm hit, a serving loop that survives a kernel fault and a raising
   query): rows equal to the fault-free run bit for bit, on the same
   shards in the same order, the recovery counters tests/test_chaos.py asserts, each shuffle fault fired once and
   the derated estimate fired (``chaos_cases.checks``). A RuntimeError
   raised at the segment_reduce seam, and NaN written there while
   validation is on, propagate through ``result()`` with no rung taken.
14. The relational token pipeline (``repro_torch.data.pipeline``) at
   llama3-8b's width, vocab 128256, seq_len 4096, global_batch 1024 (4M
   tokens a batch, Llama 3's initial batch), ``collect_stats=True``, at 1
   shard (the default context) and at 8 virtual shards: shapes, dtypes and
   token range; every row of a batch is a survivor of the quality filter
   and the label join of its refill round, with its label's weight, against
   host oracles built from the same seeded tables (``pipeline_oracle``);
   the stats' counts exactly and their means and variances within
   ``stats_bounds`` of a float64 oracle; ``global_batch(0)`` twice equal and
   ``global_batch(1)`` different; the batch under ``oracle_scope()`` equal
   bit for bit (the stats within the same bound); no plan prepared after
   step 0; ``PIPE_KERNELS`` launched. It prints the median ms of 8 batches,
   tokens/s assembled, refill rounds, host syncs, bytes uploaded and read
   back, launches and peak GiB of one batch, ``Prefetcher(depth=2)`` over 8
   steps (its batches equal the direct ones) and one profiled batch.
15. The harnesses: ``repro_torch.testing.plan_fuzz.run_fuzz`` over 100
   plans at 8 shards with the reference CI leg's seed 20260807 (every plan
   verifier-clean and its fused result equal to the eager oracle), and each
   of the 21 cases of ``repro_torch.testing.dist_cases`` (16 relational,
   ``moe_ep``, ``moe_decode_psum``, ``flash_decode_shard``,
   ``compress_pod`` and ``elastic_restore``) once, held to what
   tests/test_dist.py asserts (``dist_cases.checks``).

Then, with the relational tables freed, the serving path (the LM slice):

8. llama3-8b at full width and depth (random bf16 weights from a
   ``torch.Generator`` seeded 0) serves 4 prompts of 1024 token ids (a
   seeded numpy rng, as the launcher makes them) and 32 greedy tokens each
   through ``launch.serve.generate``. The counts are zeroed just before
   and read just after: flash_attention launched once a layer (32), by the
   prefill; a decode step launches it never. Every logit finite.
9. The same prompts under ``oracle_scope()`` (the plain attention on the
   card), the kernel run's tokens teacher-forced: prefill's and every
   decode step's logits within ``LM_TOL`` of the kernel run's, and the
   greedy token (the first and every step's) equal wherever the kernel
   run's top-2 margin exceeds it. Then the serving invariant of
   ``tests/test_serve.py``: prefill + decode logits against one causal
   forward over prompt + generated tokens (1055 rows, through the
   kernel), within ``LM_TOL``.
10. Serving times: prefill median ms, decode ms a token, tokens/s, peak
   device memory, and one ``torch.profiler`` trace of a prefill and of
   decode steps (busy share, flash's device ms, the largest kernels, the
   torch ops the host dispatched).
Then, with the serving model freed, the training path:

16. granite-3-2b (40 layers, d 2048, 32/8 heads of 64, tied embeddings of
   49280 x 2048; 2.53 B parameters) at full width and depth, random bf16
   weights from a ``torch.Generator`` seeded 0 on the card, trained by
   ``train.steps.make_train_step`` on batches of the relational token
   pipeline (seq 1024, global batch 8, vocab 49155): the reference's 4
   interleaved microbatches (``train_microbatches``), ``remat="full"``,
   AdamW on fp32 masters (lr 3e-4, warmup 1, 8 total). One warm-up step,
   then 4 steps, the counts zeroed just before and read just after: each
   step launches the LSE forward 2 x 40 x 4 = 320 times (forward and
   recompute) and the backward 40 x 4 = 160 times, the serving entry and
   the relational kernels never. It prints each step's ms, tokens/s and
   their share of the dense bf16 peak (6N plus the attention's products a
   token), loss and grad norm, peak GiB, the launches, one profiled step
   (busy share, top kernels) and the pipeline's ms a batch. Checks: finite
   losses; at 2 layers of the same width, every gradient leaf and one
   step's loss and grad norm against ``oracle_scope()`` (plain attention
   on the card) within ``TRAIN_GRAD_TOL`` / ``TRAIN_LOSS_TOL`` /
   ``TRAIN_GNORM_TOL``; at the narrow config (granite-3-2b's TINY, head
   dim 16) a run that crashes at step 4 with checkpoints every 2 steps,
   resumed, bitwise equal to 6 uninterrupted steps (deterministic
   algorithms on for it), and 60 steps on one batch lowering the loss by
   more than 1.0.
17. stablelm-12b (40 layers, d 5120, 32/8 heads of 160, d_ff 13824,
   untied vocab 100352; 12.14 B parameters), with phase 8's model freed:
   served at full width and depth as phases 8-10 serve llama3-8b (flash
   once a layer in the prefill, 40, none a decode step; logits within
   ``LM_TOL`` of the plain run and of one causal forward; times, peak,
   one traced prefill and 4 decode steps); then trained at
   ``BIG_TRAIN_LAYERS`` (4) of its 40 layers, full width (2.14 B
   parameters; 40 layers need ~240 GB of training state), 8 x 1024 tokens
   a step in the reference's 8 microbatches: 2 layers against
   ``oracle_scope()`` with phase 16's tolerances, a warm-up step and 2
   steps of 64 LSE forwards and 32 backwards each, finite losses, one
   profiled step.
18. The reference's ``--tiny`` commands on the card, in process through
   the launchers' ``main``: ``launch.serve --arch {llama3-8b,
   stablelm-12b, qwen2-moe-a2.7b, dbrx-132b, minicpm3-4b, zamba2-1.2b,
   internvl2-76b, xlstm-1.3b, whisper-base} --tiny`` and ``launch.train
   --arch {granite-3-2b, stablelm-12b, qwen2-moe-a2.7b, dbrx-132b,
   minicpm3-4b, zamba2-1.2b, xlstm-1.3b} --tiny --steps 3`` (head dim 16;
   minicpm3-4b's MLA widths 24/16; the VLM's 8 random front embeddings and
   whisper's 32 audio frames drawn as the launcher draws them; whisper's
   train launcher raises, phase 24 trains it), each
   against the same command with
   ``--device cpu`` (the MoE archs' CPU runs on the card runs' routes,
   ``RouteTap``): flash and the histogram launched (counted), the
   prefill's logits within ``LM_TOL``, every step's loss within
   ``TINY_LOSS_TOL``.
19. Mixture-of-Experts, with every earlier model freed: qwen2-moe-a2.7b at
   full width and depth (24 layers, d 2048, 16/16 heads of 128, 60
   experts top-4 of d_ff 1408 plus a shared SwiGLU of 5632, untied vocab
   151936; 14.32 B random bf16 parameters, fp32 routers, from a
   ``torch.Generator`` seeded 0) serves ``LM_BATCH`` x ``LM_PROMPT``
   prompts and ``LM_GEN`` greedy tokens through ``generate``: flash once a
   layer in the prefill (group size 1), bucket_histogram once a layer a
   forward (the experts' dispatch: 24 in the prefill, 24 each decode
   step); every logit finite; no host sync in a forward
   (``set_sync_debug_mode``); the prefill's ``moe_dropped``; the plain run
   teacher-forced on the kernel run's routes (``RouteTap``: the share of
   (layer, token) routes its own top-k would change under
   ``MOE_FLIP_SHARE``), every step's logits within ``LM_TOL``; the serving
   invariant at capacity factor ``MOE_INVARIANT_CF`` (one causal forward
   on prefill + decode's routes, within ``LM_TOL``, nothing dropped);
   times, peak, one traced prefill and 4 decode steps (flash's and the
   histogram's device ms). Then trained at full width and
   ``MOE_TRAIN_LAYERS`` (4) of 24 layers (2.91 B parameters), 8 x 1024
   tokens a step in its 4 microbatches: 2 layers against ``oracle_scope()``
   with phase 16's tolerances, on the kernel runs' routes; a warm-up step
   and 2 steps, each 32 LSE forwards, 16 backwards and 32 histograms;
   finite losses and aux; one profiled step. Then dbrx-132b at full width
   and ``MOE_BIG_LAYERS`` (4) of 40 layers (48/8 heads of 128: flash at
   group size 6; 16 experts of d_ff 10752; 14.27 B parameters) served as
   qwen2-moe-a2.7b is, untraced.
20. Multi-head latent attention, with every earlier model freed:
   minicpm3-4b at full width and depth (62 layers, d 2560, 40/40 heads,
   q·k width 96 = nope 64 + rope 32, p·v width 64, latent cache 256 + 32
   a token; 4.26 B parameters) served as phase 17 serves stablelm-12b:
   flash at widths 96/64 once a layer in the prefill (62), none in an
   absorbed decode step; logits within ``LM_TOL`` of the plain run, and
   prefill + absorbed decode within ``MLA_DECODE_TOL`` of one causal
   forward; a bidirectional mask must move the prefill logits by more
   than 3 times that; times, peak, one traced prefill and 4 decode steps.
   Then trained at full width and ``MLA_TRAIN_LAYERS`` (8) of 62 layers
   (0.88 B) in its 8 microbatches: 2 layers against ``oracle_scope()``
   with phase 16's tolerances, a warm-up step and 2 steps of 128 LSE
   forwards and 64 backwards each, finite losses, one profiled step.
21. The Mamba2 hybrid, with every earlier model freed: zamba2-1.2b uncut
   (38 Mamba2 blocks, d 2048, d_inner 4096, 64 SSM heads of 64, state 64,
   chunk 256; the shared 32/32-head block of hd 64 after every 6th; 1.17 B
   parameters) served as phase 17 serves stablelm-12b: flash once a
   shared-block invocation in the prefill (6), none in a decode step;
   logits within ``HYBRID_PLAIN_TOL`` of the plain run and of the plain
   run with the kernel's P rounding (``ref.attention_rounding_p``; the
   three distances printed), each prefill call's kernel output equal to
   that emulation on all but ``KERNEL_EMULATION_SHARE`` of its outputs, a
   bidirectional mask or the Mamba states zeroed after the prefill moving
   them by more than 3 times that; the serving invariant on the same
   weights in fp32
   (prefill + decode within ``HYBRID_F32_TOL`` of one causal forward) and
   in bf16 against the bf16 forward's own rounding
   (``HYBRID_NOISE_RATIO``); times, peak, one traced prefill and 8 decode
   steps.
   Then trained uncut, 8 x 1024 tokens a step in its 4 microbatches,
   ``remat="full"`` a period: 2 periods (12 blocks) against
   ``oracle_scope()`` and against the P-rounded plain attention with phase
   16's tolerances, a warm-up step and 2 steps of 48 LSE forwards and 24
   backwards each, finite losses, one profiled step.
22. The VLM front: internvl2-76b at full width and ``VLM_LAYERS`` (8) of
   its 80 layers (64/8 heads of 128: flash at group size 8; 9.0 B
   parameters, ``front_proj`` (8192, 8192) among them) serves
   ``LM_BATCH`` x (256 random front embeddings + ``LM_PROMPT`` prompt ids)
   and ``LM_GEN`` greedy tokens as phase 17 serves stablelm-12b, its cache
   ``256 + LM_PROMPT + LM_GEN`` rows and decode at ``256 + LM_PROMPT + i``:
   flash once a layer in the prefill (8, at S 1280), none in decode;
   logits within ``LM_TOL`` of the plain run and of one causal forward.
   Then the loss over embeds at its TINY widths (the front rows' logits
   dropped), every gradient leaf (``front_proj``'s included) and one train
   step through the kernels against ``oracle_scope()``, phase 16's
   tolerances, in its 16 microbatches.
23. xLSTM, with every earlier model freed: xlstm-1.3b uncut (48 blocks, 6
   periods of 7 mLSTM + 1 sLSTM, d 2048, mLSTM 4 heads of 1024 with the
   normalizer as a 1025th value column, chunk 256; 1.82 B parameters)
   serves ``LM_BATCH`` x ``LM_PROMPT`` prompts and ``LM_GEN`` greedy
   tokens (no kernel launched: xLSTM has no attention); its serving
   invariant as the hybrid's (fp32 within ``XLSTM_F32_TOL``, the bf16
   path within ``HYBRID_NOISE_RATIO`` of its forward's own rounding), the
   states zeroed after the prefill moving the logits by more than 3
   ``LM_TOL``; times, peak, one traced prefill and 4 decode steps. Then
   trained uncut, 8 x 1024 tokens a step in its 4 microbatches
   (``remat="full"`` a period), a warm-up step and 2 steps, its first loss
   near ln 50304 (no profiled step: PERF.md keeps an earlier trace).
24. The encoder-decoder: whisper-base uncut (6 + 6 blocks, d 512, 8/8
   heads of 64, tied vocab 51865, LayerNorm, GELU) serves ``LM_BATCH`` x
   (``LM_PROMPT`` random audio frames + ``LM_PROMPT`` prompt ids) and
   ``LM_GEN`` greedy tokens as phase 17 serves stablelm-12b: flash 18
   times a prefill (6 non-causal in the encoder, 6 causal in the decoder,
   6 non-causal cross, as many queries as frames), none in decode; logits
   within ``LM_TOL`` of the plain run and of one causal forward, a
   bidirectional mask and, apart, a causal mask in the encoder each moving
   them by more than 3 ``LM_TOL``; then one prefill at Whisper's own
   shape, 1500 frames and a 448-token prompt (the encoder's flash over a
   partial tail tile, the cross-attention plain), against the plain run.
   Trained uncut, 8 x 1024 tokens with 8 x 1024 frames in its 1
   microbatch: 2 + 2 blocks against ``oracle_scope()`` with phase 16's
   tolerances; at 6 + 6 blocks the gradients through the kernels, the
   plain attention, the plain attention with the kernel's P rounding and
   the same weights in fp32, the kernel run at most ``GRAD_NOISE_RATIO``
   times as far from the fp32 run as the plain run is; a warm-up step and
   2 steps of 36 LSE forwards and 18 backwards each, one profiled step.
25. The reference's mesh as virtual axes on the one card
   (``launch/mesh.make_local_mesh``). (a) Right after phase 10, on its
   llama3-8b: ``generate`` with the model on an 8 x model mesh, so each
   decode step splits the cache 8 ways on T (the grouped einsums a shard,
   the log-sum-exp merge: 2 psum + 1 pmax a layer a step, counted), the
   kernel run's tokens teacher-forced, against the one-device decode on the
   same weights: the prefill's logits bit for bit, every step's within
   ``LM_TOL``, flash launched by the prefill alone; decode ms a token of
   both, and 4 traced decode steps of each (busy share, host ops a step);
   at ``LM_PROMPT`` and once at a 4 x ``LONG_PROMPT`` prompt (a cache of
   8224 rows, 4.3 GB of K/V). After phase 24: (b) minicpm3-4b at full size
   with ``mla_seq_shard`` the same way against the absorbed one-device
   decode; (d) granite-3-2b at full width and ``POD_LAYERS`` (16) of its
   40 layers over (pod 2, data 2, model 2), one step's gradients in its 4
   microbatches under ``remat="dots"`` and twice under ``"full"``
   (deterministic algorithms on): the loss equal, each leaf bit for bit
   where the two full runs agree, the flash launches equal, fewer products
   run under "dots" (``mm_calls``), gradient ms and peak of each; (c) on
   the same model ``POD_STEPS`` exact steps and as many ``compress_pod``
   steps from one state: the launches a step (4 microbatches a pod), losses
   within ``POD_LOSS_TOL``, parameters within ``POD_PARAM_TOL``, residuals
   finite and nonzero, step ms and peak; (e) the launchers' mesh flags
   (``MESH_SERVE_FLAGS`` for llama3-8b and qwen2-moe-a2.7b, the MoE's
   expert-parallel prefill and psum decode with the histogram once a shard
   a layer a forward; ``MESH_TRAIN_FLAGS`` for granite-3-2b) on the card
   against ``--device cpu`` with phase 18's tolerances, each decode step
   compared while the two runs' tokens agree. (f) The three new dist cases
   run in phase 15.
26. The dry run's roofs and cells on the card (``launch/dryrun.py``),
   after phase 25: (a) the card's roofs, a bf16 8192^3 ``torch.matmul`` and
   a 4 GiB device copy timed with CUDA events, printed beside the
   datasheet's 989 TFLOP/s and 3.35 TB/s and the card's name and power
   limit (measuring instruments, not ports); (b) ``measure_cell`` on
   ``CELL_RUNS`` at depths 1 and 2: one data shard's step (the cell's
   global batch over data 16, the model axis as 16 virtual shards) of
   llama3-8b train_4k (16 x 4096 in 8 microbatches), minicpm3-4b
   decode_32k (8 x 32768 latents), qwen2-moe-a2.7b train_4k (expert
   parallel over 16 shards: ``bucket_histogram``; 8 microbatches, not the
   reference's 4, to fit one card) and llama3-8b
   prefill_32k (2 x 32768: flash at S 32768); each cell's wall and device
   ms, peak memory, their extrapolation to full depth (not run there), and
   its bound (the meta count over (a)'s roofs, and over the datasheet's);
   each measured step's loss or logits finite; the counts zeroed before
   each cell and read after it must equal the meta count's kernel calls
   times the steps run, exactly; flash at llama3-8b's S 32768 layer held
   against the plain attention on its last ``LONG_ROWS`` query rows over
   all keys (``LONG_LAST_ATOL``, ``LONG_LAST_RTOL``; planted zeros and a
   skip of the keys past S/2 must fail) and on its first ``LONG_ROWS``
   rows within ``LM_TOL``, timed beside SDPA; (c) minicpm3-4b's
   decode at full depth (62 layers, 9.4 GB of latents): its wall ms
   within ``FULL_DEPTH_WALL_TOL`` of the line through depths 1 and 2, the
   three timed in turns (the host's pace drifts), and its peak within
   ``FULL_DEPTH_PEAK_TOL`` of (b)'s extrapolation.
Phase 2 also holds flash_attention against its plain version (S 1 to
4096, around the 64-row fp32 and 128-row bf16 tiles, causal or not, group
size 1, 4 and 6, every (q·k, p·v) width pair of ``KERNEL_HEAD_DIMS``
(16, 64, 128, 160 for both; MLA's 96/64 and 24/16), fp32 and bf16, the
MoE and MLA prefill layers' shapes, scores up to +-1e4; every entry
raises ``TypeError`` at (96, 96) and (128, 64)), bucket_histogram at the MoE dispatch's shapes
(``MOE_HIST_SHAPES``: P 60 and 16, n 16 to 16384), and the training
entries (``check_flash_train``): flash_attention_lse's out equal to the
serving entry's and its lse against a float64 logsumexp;
flash_attention_bwd against autograd through ``attention_ref`` at the
training path's shape, llama3-8b's (hd 128), a stablelm-12b microbatch's
(hd 160), hd 16's, a qwen2-moe-a2.7b microbatch's (group size 1) and a
minicpm3-4b one's (96/64), at S
1, 63, 64, 65, 127, 128, 129, 1000, 1025 (every tile edge of the backward)
for every width pair, causal or not, bf16 and fp32 (and bf16 at group size
6, dbrx-132b's), group sizes 1, 2, 4 and 8 (every split of the bf16 dK/dV
launch),
each of dq, dk, dv in every 64-row
tile within ``FLASH_BWD_TOL`` of the tile's plain norm (a planted fault,
the lse off by ln 2 past the first four tiles, must fail at q·k widths
64, 160, 16 and 96, and at phase 26's train cells' shapes, B 2, S 4096,
32/8 and 16/16 heads of 128), the same bits on two runs. Phase 7 times
flash_attention at the serving path's shape beside
``F.scaled_dot_product_attention`` (``library_ms``), and the training
entries at one microbatch of the training path (B 2, S 1024, H 32, KV 8,
hd 64) beside their plain versions and the calls SDPA's flash backend
makes (``aten._scaled_dot_product_flash_attention``, which also returns
the log-sum-exp, and its ``_backward`` on that call's out and lse); and
phase 19's shapes: bucket_histogram over qwen2-moe-a2.7b's prefill
dispatch (P 60, n 16384) beside ``torch.bincount`` (``bucket_histogram@moe``),
flash at its prefill layer (group size 1, ``flash_attention@g1``) and at
dbrx-132b's (group size 6, ``flash_attention@g6``) beside SDPA; and
phase 20's: flash at minicpm3-4b's prefill layer (``flash_attention@mla``)
and its training entries at one microbatch (``flash_attention_lse@mla``,
``flash_attention_bwd@mla``) beside SDPA (which leaves its flash backend
at unequal widths: the backend it took is printed; the training
yardstick is SDPA on inputs that require grad and its autograd backward);
and phase 21's and 22's: flash at zamba2-1.2b's shared block (B 4, S
1024, 32/32 heads of 64, ``flash_attention@zamba``) and its training
entries at one microbatch (B 2; ``flash_attention_lse@zamba``,
``flash_attention_bwd@zamba``), and at internvl2-76b's prefill layer (B 4,
S 1280 = 256 front + 1024 text, 64/8 heads of 128, ``flash_attention@g8``)
beside SDPA; and phase 24's, non-causal (every (query, key) pair): flash at
whisper-base's encoder layer (B 4, S 1024, 8/8 heads of 64,
``flash_attention@whisper``) and its training entries at its microbatch
(B 8; ``flash_attention_lse@whisper``, ``flash_attention_bwd@whisper``)
beside SDPA.
Phase 7's ptxas report fails a flash bf16 instance that spills or whose
``wgmma`` products ptxas serialized (C7520).

It prints one JSON line with the serving path's numbers, one with the main
path's, one with phase 11's (``{"plan": ...}``), one with phases 12-13's
(``{"serving": ...}``), one with phases 14-15's (``{"pipeline": ...}``),
one with phase 16's (``{"train": ...}``), one with phase 17's
(``{"stablelm": ...}``), one with phase 18's (``{"tiny": ...}``), one
with phase 19's (``{"moe": ...}``), one with phase 20's (``{"mla":
...}``), one with phases 21-22's (``{"hybrid": ..., "vlm": ...}``), one
with phases 23-24's (``{"xlstm": ..., "whisper": ...}``), one with phase
25's (``{"mesh": ...}``), one with phase 26's (``{"cells": ...}``), one
with every
kernel's (the flash entries' other head dims as
``<entry>@hd160`` and ``@hd16``, phase 19's shapes as
``bucket_histogram@moe``, ``flash_attention@g1`` and ``@g6``, phase 20's
as ``<entry>@mla``, phase 21's as ``<entry>@zamba``, phase 22's as
``flash_attention@g8``, phase 24's as ``<entry>@whisper``),
then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Without a card it exits
2 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config, get_tiny, train_microbatches  # noqa: E402
from repro_torch.core import ops_local as L  # noqa: E402
from repro_torch.core import plan as PL  # noqa: E402
from repro_torch.core import stats as S  # noqa: E402
from repro_torch.core.context import DistContext, DistTable  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.core.repartition import repartition  # noqa: E402
from repro_torch.core.table import Table  # noqa: E402
from repro_torch.data.synthetic import random_table  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.bitonic import (bitonic_sort_permutation,  # noqa: E402
                                         bitonic_sort_tiles, latency_probe)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNEL_HEAD_DIMS, flash_attention, flash_attention_bwd, flash_attention_lse)
from repro_torch.kernels.hash64 import hash32, hash32_partition  # noqa: E402
from repro_torch.kernels.histogram import bucket_histogram  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce_tiles  # noqa: E402
from repro_torch.kernels.segment_scan import segment_scan_tiles  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.serve import generate, prompt_inputs  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from repro_torch.train.loop import LoopConfig, run  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

P = 8
ROWS = 1 << 22  # rows per shard: 8 x 4 Mi rows, 512 MiB a table
WINDOW_GROUPS = 12
WINDOW_FUNCS = ["rank", "dense_rank", "row_number", ("lag", "d0"),
                ("lead", "d0"), ("lag", "d1", 3), ("lead", "d1", 2),
                ("cumsum", "d0"), ("cummax", "d0"), ("cummax", "d1"),
                ("running_mean", "d0")]
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the float32 rate
# outside the tensor cores (32-bit scalar integer/float ops), and the dense
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
TENSOR_BF16_OPS_PER_S = 989e12
# the serving path: llama3-8b, 4 prompts of 1024 tokens, 32 greedy tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3-8b", 4, 1024, 32
# the training path (phase 16): granite-3-2b at full width and depth, 8 x
# 1024-token batches from the relational token pipeline, the reference's
# microbatch count for it (4), a warm-up step, then 4 steps
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = "granite-3-2b", 1024, 8, 4
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=8)
# phase 16's kernel-against-plain check runs the same width at 2 layers
TRAIN_PLAIN_LAYERS = 2
# Kernel run against plain attention on the card at 2 layers, the same
# weights and batch: each gradient leaf within 5e-2 of its largest plain
# value (the bf16 attention rounds its probabilities and dS to bf16 and
# its gradients are bf16, ~2^-8 relative each, carried through two layers'
# bf16 backward; a wrong dq, dk or dv moves its leaves by their own size;
# this per-leaf check is the one that holds the backward), the loss within
# 1e-4 of the plain one and the grad norm within 1e-3 (relative; readings
# 2.8e-6 and 1.1e-5 on an H100, PERF.md).
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL, TRAIN_GNORM_TOL = 5e-2, 1e-4, 1e-3
# the narrow config of phase 16's crash-resume and overfit checks: the
# reference's TINY config of the training arch (head dim 16)
NARROW_SEQ, NARROW_BATCH = 128, 8
# phase 17: stablelm-12b (32/8 heads of 160: the kernels' hd-160 instances)
# served at full width and depth as phase 8 serves llama3-8b (LM_BATCH x
# LM_PROMPT prompts, LM_GEN greedy tokens, checked as phases 8-9 check it:
# its logits have std ~sqrt(d_model / padded_vocab) = 0.23 against llama's
# 0.18, so LM_TOL's argument holds), then trained at full width and
# BIG_TRAIN_LAYERS of its 40 layers (~20 B a parameter of training state:
# 40 layers need ~240 GB, 4 take ~45 GB of the card's 80), TRAIN_SEQ x
# TRAIN_BATCH tokens a step in the reference's 8 microbatches, a warm-up
# step and BIG_TRAIN_STEPS steps; its kernel-against-plain check runs at
# TRAIN_PLAIN_LAYERS with phase 16's tolerances
BIG_ARCH, BIG_TRAIN_LAYERS, BIG_TRAIN_STEPS = "stablelm-12b", 4, 2
# phase 18: the reference's --tiny launcher commands, in process on the card
# and with --device cpu (one model from one seed on both: the launchers draw
# on the host), at their default sizes: serving (batch 4, prompt 32, 16
# tokens) and 3 training steps (batch 16, seq 256); the MoE archs' CPU runs
# follow the card runs' routes (``RouteTap``)
TINY_SERVE_ARCHS = ("llama3-8b", "stablelm-12b", "qwen2-moe-a2.7b",
                    "dbrx-132b", "minicpm3-4b", "zamba2-1.2b", "internvl2-76b",
                    "xlstm-1.3b", "whisper-base")
# whisper-base's train launcher raises (its encoder needs audio frames, the
# token pipeline makes none): phase 24 trains it through make_train_step
TINY_TRAIN_ARCHS = ("granite-3-2b", "stablelm-12b", "qwen2-moe-a2.7b",
                    "dbrx-132b", "minicpm3-4b", "zamba2-1.2b", "xlstm-1.3b")
TINY_TRAIN_STEPS = 3
# Each step's loss of the card's tiny run against the CPU's, absolute. The
# card rounds P to bf16 in the kernel (the CPU's plain attention keeps fp32)
# and sums its bf16 GEMMs in another order. On the CPU, the kernel's
# rounding moves the three losses (~6.25-6.30, near ln 512) by at most
# 9.4e-5, and a wrong mask (bidirectional) by 3.5e-3 (granite), 6.4e-3
# (stablelm) and 4.8e-3 (minicpm3-4b, whose kernel rounding moves them
# 6.3e-5): 1e-3 is ten times the one, a third to a sixth of the other
# (tests/test_torch_stablelm.py holds both sides of it).
TINY_LOSS_TOL = 1e-3
# Logits of two runs of the serving path that differ only in how prefill
# attention rounds (the kernel rounds its probabilities to bf16 for the
# tensor-core p v, the plain version keeps fp32, the decode einsums round
# scores and probabilities to bf16) are held within 0.05 absolute: the
# logits have std ~0.18 and reach ~1, where a bf16 ulp is 2^-8 = 0.0039,
# and 32 layers carry the rounding of each attention output forward. A
# wrong mask or a wrong head moves logits by their own scale (~0.2), four
# times this.
LM_TOL = 0.05
# phase 19: qwen2-moe-a2.7b served at full width and depth (14.32 B
# parameters: 60 experts on one card, fp32 routers) as phase 8 serves
# llama3-8b, its serving invariant at capacity factor MOE_INVARIANT_CF (the
# capacity depends on the routed token set, so prefill + decode equal one
# causal forward only where nothing is dropped, as tests/test_serve.py
# raises it); trained at full width and MOE_TRAIN_LAYERS of its 24 layers
# (2.91 B parameters, ~55 GiB of training state), TRAIN_SEQ x TRAIN_BATCH
# tokens a step in its 4 microbatches, a warm-up step and MOE_TRAIN_STEPS
# steps; dbrx-132b served at full width and MOE_BIG_LAYERS of its 40 layers
# (14.27 B parameters; 40 layers are ~264 GB)
MOE_ARCH, MOE_BIG_ARCH = "qwen2-moe-a2.7b", "dbrx-132b"
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_BIG_LAYERS = 4, 2, 4
MOE_INVARIANT_CF = 16.0
# Routes are discrete: a token's top-k changes where two of its router
# probabilities are closer than the rounding that separates two runs. The
# kernel and plain runs differ in how attention rounds (bf16 P in the
# kernel, ~2^-8 relative on each attention output), which moves the router's
# inputs by ~0.4% of their RMS and its logits (~N(0, 1) at random weights)
# by ~0.004; the gap between the k-th and the next of 60 such logits is
# below that for a few percent of tokens, a share that grows with depth as
# the runs drift apart. A wrong mask or head moves the router's inputs by
# their own size and changes most tokens' routes: on a narrow qwen2-moe on
# the CPU, 2^-8 noise on every attention output flips 2.1% of the routes, a
# bidirectional mask 97.5% and a wrong head 100%
# (tests/test_torch_moe.py holds both sides; the card's readings are in
# PERF.md). So the share of (layer, token) routes that differ is held under
# MOE_FLIP_SHARE, and the plain run then follows the kernel run's routes
# (``RouteTap``), so that every row's routes agree and every row is held to
# LM_TOL or phase 16's tolerances.
MOE_FLIP_SHARE = 0.15
# phase 20: minicpm3-4b (multi-head latent attention: flash at q k width 96,
# p v width 64, 40/40 heads) served at full width and depth (4.26 B
# parameters) as phase 17 serves stablelm-12b, then trained at full width
# and MLA_TRAIN_LAYERS of its 62 layers (~20 B a parameter of training
# state: 62 layers need ~85 GB, 8 hold 0.88 B parameters and ~18 GB) in
# its 8 microbatches, a warm-up step and BIG_TRAIN_STEPS steps
MLA_ARCH, MLA_TRAIN_LAYERS = "minicpm3-4b", 8
# Prefill + decode against one causal forward over the same tokens, for
# MLA: decode takes the absorbed path (W_uk folded into q, scores over the
# latent cache, each of its two score einsums rounded to bf16 and added in
# bf16, the context in latent space, then W_uv), another order of
# operations and rounding than the causal forward's materialised K and V
# through the flash kernel. The reference's own serving test allows 8e-2
# for this arch (tests/test_serve.py); a wrong mask moves the logits by
# their own scale (std ~sqrt(2560 / 73472) = 0.19 at random weights), and
# tests/test_torch_mla.py holds both sides of it at TINY on the CPU.
MLA_DECODE_TOL = 8e-2
# phase 21: zamba2-1.2b (the Mamba2 hybrid: 38 blocks, the shared 32/32-head
# block of hd 64 after every 6th) served and trained uncut (1.17 B
# parameters; ~23 GB of training state)
HYBRID_ARCH = "zamba2-1.2b"
# The hybrid's logits through the kernel against its plain-attention run,
# and against the plain run with the kernel's rounding of P emulated
# (ref.attention_rounding_p), teacher-forced. Per prefill call the kernel
# equals its emulation on all but 0.053-0.072% of the outputs (one or two
# bf16 ulps), where the emulation differs from the plain version on
# 16-22%; yet end to end the three runs stand 0.0488-0.0581 apart (an
# H100, PERF.md, PR 26): 38 Mamba2 blocks carry any rounding change in the
# prefill to ~0.05 in the decode logits, however few outputs it touches,
# so no two bf16 runs of it hold to LM_TOL. A bidirectional prefill mask
# or the Mamba states zeroed after the prefill move them by 1.4-1.6 (0.95
# and 1.43 at TINY on the CPU, tests/test_torch_hybrid.py), more than 3
# times this bound; the per-call share below tells a wrong mask, head or
# cache slot (nearly every output) from the rounding.
HYBRID_PLAIN_TOL = 0.1
KERNEL_EMULATION_SHARE = 0.01
# Prefill + decode against one causal forward, for the hybrid. In bf16 the
# causal forward runs the chunked GLA (bf16 intra-chunk products) over all
# S + gen - 1 tokens, the serving path over the prompt's chunks and then
# one fp32 state step a token: they round apart, and 38 blocks carry it
# (0.198 at full size on an H100; 0.071 at TINY on the CPU, where the
# reference's own prefill + decode drifts from its causal forward by up to
# 0.075). So the invariant is held where rounding is small: the same
# weights in fp32, prefill + decode within HYBRID_F32_TOL of the fp32
# causal forward (the port at TINY on the CPU: 2.0e-6, a lost carry 1.42),
# a lost state carry moving them by more than 3 times that. The
# bf16 serving path is held to the bf16 forward's own rounding: its
# logits' distance from the fp32 causal forward at most HYBRID_NOISE_RATIO
# times the bf16 causal forward's.
HYBRID_F32_TOL = 1e-3
HYBRID_NOISE_RATIO = 3.0
# phase 24's gradient account at whisper-base's full depth (6 + 6 blocks,
# where the 2-layer check's tolerance is not argued): the kernel run's
# gradients at most GRAD_NOISE_RATIO times as far from the gradients of
# the same weights in fp32 (plain attention) as the bf16 plain run's are,
# leaf for leaf at its worst, as HYBRID_NOISE_RATIO holds the hybrid's
# serving logits; a wrong dq, dk or dv moves its leaves by their own size
GRAD_NOISE_RATIO = 3.0
# phase 22: internvl2-76b at full width and VLM_LAYERS of its 80 layers
# (~0.86 B parameters a layer; the untied head and the embedding 1.05 B
# each, front_proj 67 M: 8 layers are 9.0 B, all 80 ~76 B); its loss over
# embeds and their gradients on the card at its TINY widths (2 layers at
# full width need ~78 GB of training state)
VLM_ARCH, VLM_LAYERS = "internvl2-76b", 8
# the VLM's TINY training check: 16 rows (its 16 microbatches of 1) of
# VLM_TINY_SEQ tokens after its 8 front rows
VLM_TINY_BATCH, VLM_TINY_SEQ = 16, 64
# phase 23: xlstm-1.3b uncut (48 blocks: 6 periods of 7 mLSTM blocks and 1
# sLSTM block; d 2048, mLSTM 4 heads of 1024; 1.82 B parameters), served
# at the serving path's shape and trained at the training path's in its 4
# microbatches, a warm-up step and XLSTM_TRAIN_STEPS steps
XLSTM_ARCH, XLSTM_TRAIN_STEPS = "xlstm-1.3b", 2
# Its prefill + decode against one causal forward on the same weights in
# fp32, as the hybrid's (HYBRID_F32_TOL's note): the chunked GLA's fp32
# inter-chunk products at head dim 1024 and the decode step's fp32 state
# sum in another order (1.4e-4 at full size on an H100, 5.5e-7 at TINY on
# the CPU; the states zeroed after the prefill move it by 1.3 and 1.8)
XLSTM_F32_TOL = 1e-3
# phase 24: whisper-base uncut (6 encoder + 6 decoder blocks, d 512, 8/8
# heads of 64, tied vocab 51865; 72.6 M parameters and the 32768-row
# learned position table), served with LM_PROMPT audio frames beside the
# LM_PROMPT-token prompts, then one prefill at Whisper's own shape: 30 s of
# audio, 1500 encoder frames (arXiv:2212.04356 section 2.2), and a 448-token
# prompt (its decoder's context); trained at the training path's shape
# with as many random frames, in its 1 microbatch
WHISPER_ARCH, WHISPER_FRAMES, WHISPER_TEXT = "whisper-base", 1500, 448
# phase 25: the reference's mesh on the card as virtual axes. (a)-(b) the
# seq-sharded decodes over SHARD_DEVICES x model (the cache split 8 ways on
# T) against the one-device decode on the same weights, at LM_PROMPT and
# (GQA) once at a LONG_PROMPT prompt; (c) compress_pod on granite-3-2b at
# full width and POD_LAYERS of its 40 layers (~20 B of state a parameter,
# 8 B of residuals at 2 pods and 4 B of one pod's gradient: ~34 GB at
# 1.07 B parameters, where the uncut 2.53 B would need ~81 GB) over
# (pod 2, data 2, model 2), POD_STEPS compressed steps against as many
# exact ones from one state, the parameters within POD_PARAM_TOL (the
# reference's bound, tests/test_dist.py) and the losses within POD_LOSS_TOL;
# (d) remat="dots" against "full" on the same model
SHARD_DEVICES, LONG_PROMPT = 8, 8192
POD_LAYERS, POD_STEPS, POD_PARAM_TOL, POD_LOSS_TOL = 16, 3, 5e-2, 0.2
# the launchers' mesh flags (the reference's examples), on the card against
# --device cpu with phase 18's tolerances
MESH_SERVE_ARCHS = ("llama3-8b", "qwen2-moe-a2.7b")
MESH_SERVE_FLAGS = ("--devices", "8", "--model-axis", "8")
MESH_TRAIN_FLAGS = ("--devices", "8", "--model-axis", "2", "--pod-axis", "2",
                    "--compress-pod")

# segment_reduce's pass-1 tile (csrc/segment_reduce.cu), whose edges phase 2
# probes
# phase 26: the card's roofs (a bf16 ROOF_N^3 product, a ROOF_COPY-byte
# device copy) and the dry run's cells measured at depths 1 and 2
ROOF_N = 8192
ROOF_COPY = 4 << 30
# (arch, shape, microbatches: None for the reference's rule, timed steps
# after the warm-up: more where a step takes milliseconds). qwen2-moe's
# data shard (16 x 4096 tokens) takes 8 microbatches of 2 rows, not the
# reference's 4 of 4: on one card a microbatch's fp32 logits over its vocab
# of 151936 are 10 GB a tensor, and the dry run's own count puts the step at
# depth 2 at ~78 GB with 4 (it ran out of the card's memory there), ~54
# with 8
CELL_RUNS = (("llama3-8b", "train_4k", None, 2),
             ("minicpm3-4b", "decode_32k", None, 30),
             ("qwen2-moe-a2.7b", "train_4k", 8, 1),
             ("llama3-8b", "prefill_32k", None, 2))
# each cell's kernels on its path: the LSE forward and the backward in
# training (qwen2's expert dispatch counts through the histogram), the
# serving forward in prefill, none in MLA's absorbed decode
CELL_KERNELS = {
    "llama3-8b/train_4k": {"flash_attention_lse", "flash_attention_bwd"},
    "minicpm3-4b/decode_32k": set(),
    "qwen2-moe-a2.7b/train_4k": {"flash_attention_lse", "flash_attention_bwd",
                                 "bucket_histogram"},
    "llama3-8b/prefill_32k": {"flash_attention"}}
# flash at S 32768 (llama3-8b's prefill_32k layer) against the plain
# attention on its last and first LONG_ROWS query rows. The first rows
# average a few keys each (outputs ~1) and take LM_TOL; the last average
# ~32k keys each, so their outputs are ~0.01 and LM_TOL would pass zeros
# there: they take LONG_LAST_ATOL (about six times the largest |diff| read
# on an H100, 1.6e-4) and LONG_LAST_RTOL on ||diff|| / ||plain||, and a
# planted fault (zeros, or the keys past S/2 skipped) must fail them
LONG_ROWS = 256
LONG_LAST_ATOL = 1e-3
LONG_LAST_RTOL = 0.02
# (c) minicpm3-4b's decode at full depth against the line through depths 1
# and 2: its wall time is host-bound, ~124 host ops a layer a step
# (PERF.md), so linear in depth; its memory is the weights and the latent cache, both
# a layer's worth a layer; set before the first reading
FULL_DEPTH_WALL_TOL = 0.25
FULL_DEPTH_PEAK_TOL = 0.10
FULL_DEPTH_ROUNDS = 60
SEG_TILE = 4096
# A float32 segment sum of ~33,500 standard-normal rows (phase 7's shape)
# through the plain version's index_add_ drifts by up to ~0.0025 from the
# exact sum (its atomics add one row at a time; the earlier bound of
# 0.00244 against it was that drift), while the kernel's binary-tree sums
# stay much closer. So at that shape the kernel is held against the plain
# version run in float64, ten times tighter than 0.00244.
SEG_F32_TOL = 2.44e-4
# A float32 running sum of L standard-normal rows wanders to ~4 sqrt(L)
# (~22,000 over phase 2's one run of 4,098 tiles, 31.5 M rows), below
# 2**15, where a float32 ulp is at most 2**-9. segment_scan's sum for a row
# adds the tile aggregates before it to the carry one after another (up to
# 4,097 additions), then about 17 more inside its tile (the warps, chunks
# and lanes before it, then its group's rows); each addition rounds by up
# to half an ulp, and independent roundings drift by ~ulp / sqrt(12) x
# sqrt(4,114) = 0.036 (one standard deviation; the aggregates' own sums
# stay near 250, where the ulp is 2**-16). 0.5 is ~14 of those. A lost or
# doubled tile aggregate moves the sums after it by ~88 (sqrt(7680)), a
# lost row by 0.8 on average, so a wrong fold still shows.
SCAN_F32_TOL = 0.5
# groupby's final aggregation (groupby.q5): a worker's received slots hold
# ~4% rows, then the -1 tail; row 4d times the float64 instance there
SEG_FINAL_FILL = 0.04
# A float64 sum of k standard-normal rows (~8 a group there, a few dozen at
# most), folded in a binary tree by the kernel and one row at a time by the
# plain version's atomics, is within (k - 1) x 2**-53 of the sum of |values|
# of the exact sum either way (~1e-14 at k = 50); 1e-12 still catches a lost
# or doubled row, a share of ~1/8 of that sum
SEG_F64_REL_TOL = 1e-12
# groupby two_phase and shuffle's segment_reduce launches over the main path
# (every aggregate's partial on every shard)
SEG_REDUCE_LAUNCHES = 120

KERNELS = {
    "hash32": (hash32, "src/repro_torch/kernels/csrc/hash32.cu",
               "src/repro/kernels/hash64.py:41"),
    "hash32_partition": (hash32_partition,
                         "src/repro_torch/kernels/csrc/hash32.cu",
                         "src/repro/kernels/hash64.py:41"),
    "bucket_histogram": (bucket_histogram,
                         "src/repro_torch/kernels/csrc/histogram.cu",
                         "src/repro/kernels/histogram.py:42"),
    "bitonic_sort_tiles": (bitonic_sort_tiles,
                           "src/repro_torch/kernels/csrc/bitonic.cu",
                           "src/repro/kernels/bitonic.py:71"),
    "bitonic_sort_permutation": (bitonic_sort_permutation,
                                 "src/repro_torch/kernels/csrc/bitonic.cu",
                                 "src/repro/kernels/bitonic.py:71"),
    "segment_reduce_tiles": (segment_reduce_tiles,
                             "src/repro_torch/kernels/csrc/segment_reduce.cu",
                             "src/repro/kernels/segment_reduce.py:79"),
    "segment_scan_tiles": (segment_scan_tiles,
                           "src/repro_torch/kernels/csrc/segment_scan.cu",
                           "src/repro/kernels/segment_scan.py:101"),
    "flash_attention": (flash_attention,
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    # the training entries: the forward's LSE-writing instance, and the
    # gradient of the TPU kernel's function (which has none; the reference
    # differentiates its einsum attention, src/repro/models/layers.py:223)
    "flash_attention_lse": (flash_attention_lse,
                            "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:78"),
    "flash_attention_bwd": (flash_attention_bwd,
                            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:78"),
}
# the LM kernels, whose launches phases 8 and 16 count
LM_KERNELS = ("flash_attention", "flash_attention_lse", "flash_attention_bwd")
# each relational kernel's launches over phase 3's main path, exactly:
# hash32_partition once a shard for each hash shuffle (the sort join's and
# the hash join's two sides, groupby two_phase's and shuffle's: 6 a shard);
# the column hash32 by the hash join's local key hash (two sides a shard);
# bucket_histogram once a shard for every shuffle (those six, the sort's and
# the window's); bitonic_sort_permutation by groupby two_phase's combine (a
# 2048-row sort a shard); the tile entry by nothing on the path (its one
# caller was that combine's sort); the scans by the window's six scans a
# shard; segment_reduce by every aggregate's partial on every shard
MAIN_PATH_LAUNCHES = {
    "hash32": 2 * P, "hash32_partition": 6 * P, "bucket_histogram": 8 * P,
    "bitonic_sort_tiles": 0, "bitonic_sort_permutation": P,
    "segment_reduce_tiles": SEG_REDUCE_LAUNCHES, "segment_scan_tiles": 6 * P}
# the relational main path's kernels; the LM_KERNELS are the LM paths'
RELATIONAL = tuple(MAIN_PATH_LAUNCHES)
ZERO_LAUNCHES = {name: 0 for name in KERNELS}
# phase 11: analyze sketches each 1-D key-typed column of the four tables
# (k and three float32 columns each) in one hash32_partition launch over all
# p * C slots, and launches nothing else
ANALYZE_LAUNCHES = {"hash32_partition": 16}
# the kernels phase 11's frame pipeline must launch: the join's two hash
# shuffles (partition entry and histogram) and the groupby's reductions
PIPELINE_KERNELS = ("hash32_partition", "bucket_histogram",
                    "segment_reduce_tiles")
# aggregations exact in any order (so the plain run and the eager chain agree
# bit for bit): count, min, max and the first row of each group
PLAN_AGGS = {"d0": ["count", "min", "max", "first"], "d1": ["min", "max"]}
# rows a shard in phase 11's safe-capacity re-run: at 2**22 the safe join
# bucket is a whole shard, 8 x 8 x 2**22 slots of 16 B a side
SAFE_RERUN_ROWS = 1 << 16


# the __global__ functions of src/repro_torch/kernels/csrc/*.cu, as the
# profiler names them
PORTED_KERNELS = ("hash32_kernel", "hash32_partition_kernel", "hist_regs",
                  "hist_global", "hist_shared", "bitonic_tile", "bitonic_perm",
                  "seg_fill", "seg_pass1", "seg_pass2",
                  "scan_lookback", "flash_fwd_bf16", "flash_fwd_f32",
                  "flash_bwd_prep", "flash_bwd_dot", "flash_bwd_dkdv",
                  "flash_bwd_sum", "flash_bwd_dq", "flash_bwd_key")


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def say(*a) -> None:
    print(*a, flush=True)


def set_launches(value: int = 0) -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = value


def launches() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


class RouteTap:
    """The MoE layers' routes (each token's top-k expert ids), tapped at
    ``models/moe._route``. ``record()`` keeps every call's ids in call
    order; ``follow(calls)`` makes a second run of the same calls take those
    ids instead of its own (the combine weights and the aux taken from its
    own probabilities at them, ``moe.routed``) and counts ``flips``, the
    (layer, token) routes whose own top-k set differs, out of ``routes``.
    The call sequence must match the recorded one, remat recomputes
    included."""

    def __init__(self):
        self.calls: list[torch.Tensor] = []
        self.flips = 0
        self.routes = 0

    @contextlib.contextmanager
    def _patched(self, fn):
        real = MOE._route
        MOE._route = lambda w, xt, cfg: fn(real, w, xt, cfg)
        try:
            yield self
        finally:
            MOE._route = real

    def record(self):
        def tap(real, w, xt, cfg):
            out = real(w, xt, cfg)
            self.calls.append(out[0].detach())
            return out
        return self._patched(tap)

    @contextlib.contextmanager
    def follow(self, calls: list[torch.Tensor]):
        pending = iter(calls)

        def tap(real, w, xt, cfg):
            own = real(w, xt, cfg)[0]
            want = next(pending, None)
            check(want is not None and tuple(want.shape) == tuple(own.shape),
                  f"route tap: call {self.routes} of shape {tuple(own.shape)} "
                  f"does not follow the recorded calls")
            want = want.to(own.device)
            self.flips += int((own.sort(-1).values !=
                               want.sort(-1).values).any(-1).sum())
            self.routes += own.shape[0]
            return MOE.routed(MOE.router_probs(w, xt), want, cfg)

        with self._patched(tap):
            yield self
        check(next(pending, None) is None,
              "route tap: fewer calls than recorded")

    @property
    def share(self) -> float:
        return self.flips / max(self.routes, 1)


def sm_clock() -> str:
    """The SM clock nvidia-smi reads now (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the kernels whose build report phase 7 prints (those redesigned in the
# last rounds, and flash's fp32 instances, which phase 2 checks), and the
# op codes of the segment kernels
REPORTED_KERNELS = ("flash_fwd_bf16", "flash_bwd_prep", "flash_bwd_dkdv_bf16",
                    "flash_bwd_sum", "flash_bwd_dq_bf16", "flash_bwd_key_sums",
                    "flash_bwd_key_centres", "flash_fwd_f32",
                    "flash_bwd_dkdv_f32", "flash_bwd_dq_f32", "seg_fill",
                    "seg_pass1", "seg_pass2",
                    "scan_lookback", "hist_regs", "hash32_partition_kernel",
                    "bitonic_tile", "bitonic_perm")
_OPS = {"0": "sum", "1": "min", "2": "max"}
# flash_bwd_dkdv_f32's PARTS: both gradients, or (past hd 128) one a
# launch; the bf16 instances take the widths alone
_DKDV_PARTS = {"1": "dV", "2": "dK", "3": "dK+dV"}


def _instance_name(m) -> str:
    """A kernel instance's name from its mangled name's match: the kernel
    and its template arguments, Li128ELi128 (flash's q k and p v widths;
    flash_bwd_prep's p v width alone), fLi0 (float, sum), Lb1 (flash's
    LSE-writing training instance), Li160ELi160ELi1 (the widths, the fp32
    dK/dV launch's gradients), Li8 (a bitonic tile's log size)."""
    args = m.group(2) or ""
    t = {"f": "float", "i": "int", "d": "double"}.get(args[:1])
    n = re.findall(r"Li(\d+)", args)
    label = ("" if not n else f"<{n[0]}>" if t is None else
             f"<{t}, {_OPS.get(n[0], n[0])}>")
    if t is None and len(n) > 1:
        label = f"<{n[0]}/{n[1]}" + (
            f", {_DKDV_PARTS[n[2]]}" if len(n) > 2 else "") + ">"
    lse = re.findall(r"Lb(\d)", args)
    if lse:
        label = label[:-1] + (", lse>" if lse[0] == "1" else ", serving>")
    return m.group(1) + label


def ptxas_report() -> list[dict]:
    """Every instance of ``REPORTED_KERNELS`` as the build's ``-Xptxas -v``
    output (``_build.LOGS``) reports it: registers a thread, stack frame
    and spill bytes (stores, loads), static shared memory, and
    ``wgmma_serialized`` where ptxas warns that it serialized the
    instance's ``wgmma`` products (C7520: a product on a path it treats as
    divergent, or too few registers)."""
    found = []
    pat = re.compile(r"\d+(%s)(?:I(\w*?)EE)?" % "|".join(REPORTED_KERNELS))
    serialized = set()
    for _, log in _build.LOGS.values():
        cur = None
        for line in log.splitlines():
            if "C7520" in line or "instructions are serialized" in line:
                m = pat.search(line)
                if m:
                    serialized.add(_instance_name(m))
            elif "Compiling entry function" in line:
                m = pat.search(line)
                cur = None
                if m:
                    cur = {"kernel": _instance_name(m)}
                    found.append(cur)
            elif cur is not None and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
                cur["spill_store_bytes"], cur["spill_load_bytes"] = int(st), int(ld)
                frame = re.search(r"(\d+) bytes stack frame", line)
                cur["stack_frame_bytes"] = int(frame.group(1)) if frame else 0
            elif cur is not None and "Used" in line and "registers" in line:
                cur["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    for r in found:
        r["wgmma_serialized"] = r["kernel"] in serialized
    return found


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median per-call device time with CUDA events, each call after an L2
    flush (a 256 MiB write, outside the timed window)."""

    def __init__(self, device):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def __call__(self, fn, reps: int = 15, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def attn_layers(cfg, cross: bool = True) -> int:
    """The flash launches of a forward: the hybrid's shared block once a
    period, xLSTM none, the encoder-decoder's encoder and decoder blocks
    once each and its cross-attention once a decoder block where it takes
    the kernel (``cross``: the decoder's rows as many as the encoder's, as
    on the serving and training paths), every other arch's blocks once
    each."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.encoder_layers + cfg.num_layers * (2 if cross else 1)
    return cfg.num_layers


def plain_layers(cfg) -> int:
    """The depth of the kernel-against-plain training check: 2 layers, or
    a hybrid's 2 periods."""
    if cfg.family == "hybrid":
        return TRAIN_PLAIN_LAYERS * cfg.attn_every
    return TRAIN_PLAIN_LAYERS


def attn_widths(cfg) -> tuple[int, int]:
    """The flash kernel's (q k, p v) widths for ``cfg``: MLA's (nope + rope,
    v), else (hd, hd)."""
    if cfg.attn_kind == "mla":
        return cfg.mla_nope_dim + cfg.mla_rope_dim, cfg.mla_v_dim
    return cfg.hd, cfg.hd


def bitonic_bound(nbytes: float, tile: int, probe: dict,
                  sms: int) -> tuple[float, str]:
    """The least time of one bitonic tile: the largest of its bytes over
    HBM's rate, its operations at one SM's share of the scalar rate (a tile
    is one block's work), and its dependent chain. The network has
    log2(T)(log2(T)+1)/2 passes, each depending on the one before; a pass
    is at least one 64-bit compare-exchange in registers (setp.lt.u64 and
    two selp.b64, packed keys: the fewest instructions either entry's step
    can take), whose latency ``latency_probe`` measures on this card in this
    run (ns a step, at the SM clock of the run). Operations: a
    compare-exchange is a 64-bit compare and two 64-bit selects, 6 32-bit
    operations, for each of the T/2 pairs of every pass."""
    log_t = tile.bit_length() - 1
    passes = log_t * (log_t + 1) // 2
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": passes * (tile // 2) * 6
             / (SCALAR_OPS_PER_S / sms) * 1e3,
             "latency": passes * probe["register_ns_per_step"] * 1e-6}
    by = max(terms, key=terms.get)
    return terms[by], by


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def phase_kernels(dev) -> None:
    rng = np.random.default_rng(1)
    n = 1 << 22

    # hash32: 2**22 int32 / uint32 / float32 (with +-0 and NaN), two seeds
    f = rng.standard_normal(n).astype(np.float32)
    f[:6] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    cols = [rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), f]
    for c in cols:
        x = torch.from_numpy(c).to(dev)
        for seed in (7, 8):
            got, want = hash32(x, seed), ref.hash32_ref(x, seed)
            check(torch.equal(got, want), f"hash32 {c.dtype} seed {seed}")
        # an unaligned view takes the scalar path
        check(torch.equal(hash32(x[1:], 7), ref.hash32_ref(x[1:], 7)),
              f"hash32 unaligned {c.dtype}")
    check_hash_partition(dev, [torch.from_numpy(c).to(dev) for c in cols])

    # histogram: P = 8 with -1 padding, and large P
    ids = torch.from_numpy(rng.integers(-1, 8, n).astype(np.int32)).to(dev)
    for p in (8, 1, 1000, 20000):
        check(torch.equal(bucket_histogram(ids, p), ref.histogram_ref(ids, p)),
              f"histogram P={p}")
    odd = torch.from_numpy(rng.integers(-5, 40, 1001).astype(np.int32)).to(dev)
    check(torch.equal(bucket_histogram(odd, 37), ref.histogram_ref(odd, 37)),
          "histogram odd")
    check_histogram_edges(dev, rng)
    check_histogram_moe(dev, rng)

    # bitonic: every tile size, u32 keys in int64 (wide and with many
    # duplicates), the u32 max key, repeated payloads
    for tile in (256, 512, 1024, 2048, 4096):
        m = 3 * tile
        for hi in (2**32, 9):
            keys = rng.integers(0, hi, m, dtype=np.uint64).astype(np.int64)
            keys[::89] = 0xFFFFFFFF
            k = torch.from_numpy(keys).to(dev)
            v = torch.from_numpy(rng.integers(0, m // 2, m).astype(np.int32)).to(dev)
            ko, vo = bitonic_sort_tiles(k, v, tile=tile)
            rk, rv = ref.sort_tiles_ref(k, v, tile)
            check(torch.equal(ko, rk) and torch.equal(vo, rv),
                  f"bitonic tile={tile} keys < {hi}")
    check_bitonic_edges(dev, rng)
    check_bitonic_permutation(dev, rng)
    # through sort_pairs, n not a power of two, with the u32 max key
    for m in (1, 300, 1000, 2047):
        keys = rng.integers(0, 20, m).astype(np.int64)
        keys[m // 2] = 0xFFFFFFFF
        k = torch.from_numpy(keys).to(dev)
        v = torch.arange(m, dtype=torch.int32, device=dev)
        ko, vo = kops.sort_pairs(k, v)
        rk, rv = ref.sort_pairs_ref(k, v)
        check(torch.equal(ko, rk) and torch.equal(vo, rv), f"sort_pairs n={m}")

    # segment_reduce: sum/min/max x f32/i32/f64 x G, sorted and unsorted ids,
    # ids out of range; integer-valued floats, so sums are exact. Sorted
    # ids (out-of-range ones at both ends) also go in as contiguous runs,
    # as groupby passes them.
    for g in (1, 1024, 1025, 1 << 22):
        for sort_ids in (True, False):
            s = rng.integers(-2, g + 2, n)
            if sort_ids:
                s = np.sort(s)
            seg = torch.from_numpy(s.astype(np.int32)).to(dev)
            for dt in (np.float32, np.int32, np.float64):
                vals = torch.from_numpy(rng.integers(-99, 99, n).astype(dt)).to(dev)
                for op in ("sum", "min", "max"):
                    want = ref.segment_reduce_ref(vals, seg, g, op)
                    for runs in (False, True) if sort_ids else (False,):
                        got = segment_reduce_tiles(vals, seg, g, op,
                                                   contiguous_runs=runs)
                        check(torch.equal(got, want),
                              f"segment_reduce G={g} sorted={sort_ids} "
                              f"contiguous_runs={runs} {dt} {op}")
    # one long run crossing many blocks, and empty input
    vals = torch.ones(3 << 20, dtype=torch.float32, device=dev)
    seg = torch.zeros(3 << 20, dtype=torch.int32, device=dev)
    check(segment_reduce_tiles(vals, seg, 2, "sum").tolist() == [3 << 20, 0.0],
          "segment_reduce long run")
    empty = torch.zeros(0, dtype=torch.float32, device=dev)
    check(torch.equal(segment_reduce_tiles(empty, seg[:0], 3, "min"),
                      ref.segment_reduce_ref(empty, seg[:0], 3, "min")),
          "segment_reduce empty")
    seg_err = check_segment_reduce_edges(dev, rng)
    say(f"[2] segment_reduce at phase 7's shape, standard-normal f32 sums: "
        f"within {seg_err['f64']:.3g} of the plain version in float64 "
        f"(tolerance {SEG_F32_TOL:g}), {seg_err['f32']:.3g} of it in float32; "
        f"the same bits on a second run; f64 sums on groupby's final layout "
        f"within {seg_err['f64_sum_rel']:.3g} of the plain version relative to "
        f"the sum of |values| (tolerance {SEG_F64_REL_TOL:g}), the same bits "
        f"twice")
    check_segment_scan(dev, rng)
    scan_err = check_segment_scan_edges(dev, rng)
    say(f"[2] segment_scan standard-normal f32 sums: at phase 7's shape within "
        f"{scan_err['phase7']:.3g}, over one run of {scan_err['tiles']} tiles "
        f"within {scan_err['one_run']:.3g} of the plain version in float64 "
        f"(tolerance {SCAN_F32_TOL:g}); the same bits on 5 runs of each")
    check_flash(dev, rng)
    worst = check_flash_train(dev, rng)
    bf, f32 = worst["bf16"], worst["f32"]
    zero_rms = max(bf["zero_rms"], f32["zero_rms"])
    say(f"[2] flash training entries: the LSE instance's out equal to the "
        f"serving one's, lse within {FLASH_LSE_TOL:g} of float64; the "
        f"backward's worst {FLASH_BWD_TILE}-row tile of dq, dk or dv within "
        f"{bf['rel']:.3g} (bf16) and {f32['rel']:.3g} (fp32) of its plain "
        f"norm (limits {FLASH_BWD_TOL[torch.bfloat16]:g}, "
        f"{FLASH_BWD_TOL[torch.float32]:g}), RMS {zero_rms:.3g} where the "
        f"plain gradient is 0 (floor {FLASH_BWD_ATOL:g}); at most "
        f"{max(bf['excess'], f32['excess']):.3g} of a limit over "
        f"{len(flash_train_cases())} cases, the same bits on two runs")
    for label, bad in worst["planted"].items():
        say(f"[2] flash backward, {label}: the lse off by ln 2 past the first "
            f"four tiles fails at dq {bad['dq']:.3g}, dk {bad['dk']:.3g}, dv "
            f"{bad['dv']:.3g} times the limit (its largest |diff| "
            f"{bad['max_over_max']:.3g} of the largest |plain|)")
    torch.cuda.synchronize()


def _bits(c: torch.Tensor) -> torch.Tensor:
    return c.view(torch.int32) if c.dtype == torch.float32 else c


def check_hash_partition(dev, cols: list[torch.Tensor]) -> None:
    """hash32_partition against its plain version, bit for bit: one key
    column (each of int32, uint32 and float32 with +-0, NaN and +-inf) and
    all three; phase 7's shape (2**22 rows, P 8, row_count rows - rows/16)
    and P 1, 7, 4096; row_count 0, one, partial and full; views at offsets
    1-3 (the scalar path) and ragged lengths (n 1, 5, 4099)."""
    n = cols[0].shape[0]

    def same(name, cs, rc, p, seed=7):
        r = torch.tensor(rc, dtype=torch.int32, device=dev)
        got = hash32_partition(cs, r, p, seed)
        check(torch.equal(got, ref.hash_partition_ids_ref(cs, r, p, seed)),
              f"hash32_partition {name} row_count={rc} P={p}")

    sets = [[c] for c in cols] + [cols]
    for cs in sets:
        name = "+".join(str(c.dtype).split(".")[1] for c in cs)
        for p in (8, 1, 7, 4096):
            for rc in (n - n // 16, 0, 1, n):
                same(name, cs, rc, p)
        for off in (1, 2, 3):
            for m in (n - 3, 4099, 5, 1):
                view = [c[off:off + m] for c in cs]
                for p in (8, 4096):
                    same(f"{name} view at offset {off}, n={m}", view, m - m // 3, p)
    # columns at different offsets (some aligned, some not), a second seed
    same("mixed offsets", [cols[0][:n - 3], cols[1][1:n - 2], cols[2][3:]],
         n // 2, 8, seed=8)


def check_bitonic_edges(dev, rng) -> None:
    """The tile entry where its layouts have edges, at every tile size:
    keys above the u32 range (int64 over the whole range, negatives
    included), all keys equal, keys descending, repeated payloads (so the
    payload tie-break decides), every key the int64 max."""
    for tile in (256, 512, 1024, 2048, 4096):
        m = 4 * tile
        cases = {
            "int64 keys": rng.integers(-2**63, 2**63 - 1, m, dtype=np.int64),
            "keys equal": np.full(m, 2**40 + 3, np.int64),
            "keys descending": np.arange(m, 0, -1, dtype=np.int64) * 2**33,
            "int64 max keys": np.full(m, 2**63 - 1, np.int64),
        }
        for name, keys in cases.items():
            k = torch.from_numpy(keys).to(dev)
            for pay in (rng.integers(0, 7, m), rng.permutation(m)):
                v = torch.from_numpy(pay.astype(np.int32)).to(dev)
                ko, vo = bitonic_sort_tiles(k, v, tile=tile)
                rk, rv = ref.sort_tiles_ref(k, v, tile)
                check(torch.equal(ko, rk) and torch.equal(vo, rv),
                      f"bitonic tile={tile} {name}")


def check_bitonic_permutation(dev, rng) -> None:
    """bitonic_sort_permutation against its plain version, bit for bit: C
    1, 255, 256, 300, 1000, 2047 and 2048 (each padding of the packed
    network) with the u32 max key (int32 max, uint32 max, an all-ones NaN)
    among the rows; int32, uint32 and float32 keys (+-0, NaN, +-inf, many
    duplicates); row_count 0, one, partial and full; a view at offset 1."""
    for c in (2048, 1, 255, 256, 300, 1000, 2047):
        f = rng.integers(-20, 20, c + 1).astype(np.float32)
        f[:4] = np.array([0.0, -0.0, np.nan, np.inf], np.float32)[:min(4, c + 1)]
        fb = f.view(np.uint32)
        fb[c // 2] = 0xFFFFFFFF  # a NaN whose ordered_u32 is the u32 max
        i = rng.integers(-20, 20, c + 1).astype(np.int32)
        i[c // 3] = np.iinfo(np.int32).max
        u = rng.integers(0, 2**32, c + 1, dtype=np.uint64).astype(np.uint32)
        u[c - 1] = 0xFFFFFFFF
        for x in (i, u, f):
            xt = torch.from_numpy(x).to(dev)
            for keys in (xt[:c], xt[1:]):
                for rc in sorted({0, 1, c // 2, c}):
                    r = torch.tensor(rc, dtype=torch.int32, device=dev)
                    got = bitonic_sort_permutation(keys, r)
                    check(torch.equal(got, ref.sort_permutation_ref(keys, r)),
                          f"bitonic_sort_permutation C={c} {x.dtype} "
                          f"row_count={rc} offset={keys.storage_offset()}")


def check_histogram_edges(dev, rng) -> None:
    """bucket_histogram where its designs have edges: P on both sides of the
    register path's 8 buckets and up to the global path (ids over [-1, P],
    so some fall above the range); n of 1, 3, 4, 5 and around one block's
    unrolled step and the whole grid's (``repro_histogram_rows_per_step``
    x ``repro_histogram_max_blocks``), also over two steps; views at
    offsets 1-3 (an unaligned head, and a ragged tail); every id out of
    range (-1 and P);
    the same counts on three calls in a row. Calls of different n and P
    follow one another, so the last-block ticket must be back at 0 after
    every call."""
    def same(name, x, p):
        want = ref.histogram_ref(x, p)
        for i in range(3):
            check(torch.equal(bucket_histogram(x, p), want),
                  f"histogram {name} P={p} (call {i + 1} of 3)")

    n = 1 << 22
    for p in (1, 7, 8, 9, 16, 17, 64, 1000, 20000):
        x = torch.from_numpy(rng.integers(-1, p + 1, n).astype(np.int32)).to(dev)
        same(f"n={n}", x, p)
    lib = _build.library()
    step = lib.repro_histogram_rows_per_step()
    grid = step * lib.repro_histogram_max_blocks()
    for m in (1, 3, 4, 5, step - 1, step, step + 1, grid - 1, grid, grid + 1,
              2 * grid + 5):
        for p in (3, 8, 17):
            x = torch.from_numpy(rng.integers(-1, p + 1, m).astype(np.int32)).to(dev)
            same(f"n={m}", x, p)
    base = torch.from_numpy(rng.integers(-1, 9, n + 8).astype(np.int32)).to(dev)
    for off in (1, 2, 3):
        for m in (n, n - 5, 2, 7):
            for p in (8, 17):
                same(f"view at offset {off}, n={m}", base[off:off + m], p)
    for p in (8, 17):
        same("all ids -1", torch.full((n,), -1, dtype=torch.int32, device=dev), p)
        same("all ids P", torch.full((n,), p, dtype=torch.int32, device=dev), p)


# bucket_histogram's shapes on the MoE path: (P experts, n = tokens x top-k)
# for qwen2-moe-a2.7b's prefill (4 x 1024 tokens x 4), decode step (4 x 4)
# and training microbatch (2 x 1024 x 4), dbrx-132b's prefill and decode
MOE_HIST_SHAPES = ((60, 16384), (60, 16), (60, 8192), (16, 16384), (16, 16))


def check_histogram_moe(dev, rng) -> None:
    """bucket_histogram at ``MOE_HIST_SHAPES``: expert ids over [0, P) (the
    local path routes every token), skewed to a few experts, and with -1
    for the ids another shard owns (the decode psum path); the same counts
    on three calls in a row."""
    for p, n in MOE_HIST_SHAPES:
        ids = [rng.integers(0, p, n), np.minimum(rng.geometric(0.3, n) - 1,
                                                 p - 1),
               np.where(rng.random(n) < 0.75, -1, rng.integers(0, p, n))]
        for i, a in enumerate(ids):
            x = torch.from_numpy(a.astype(np.int32)).to(dev)
            want = ref.histogram_ref(x, p)
            for call in range(3):
                check(torch.equal(bucket_histogram(x, p), want),
                      f"histogram at the MoE shape P={p} n={n} ids {i} "
                      f"(call {call + 1} of 3)")


def check_segment_reduce_edges(dev, rng) -> dict[str, float]:
    """segment_reduce where its design has edges, as groupby passes ids
    (``contiguous_runs=True``): runs that end exactly at the 4096-row tile
    edges, one row before and one after (5 tiles + 3 rows); one run over
    2**22 + 3 rows; every row out of range (-1, and G); sum/min/max x
    f32/i32/f64 on integer values, bit for bit, and the same bits on a
    second run. NaN in f32 and f64 min/max: the segments that hold a NaN
    come out NaN, the others equal the plain version (whose atomics on the
    card need not keep NaN). Then phase 7's shape on standard-normal data
    (f32 sum, 2**23 rows, 125 sorted groups over the first half, a -1
    tail): within ``SEG_F32_TOL`` of the plain version in float64, the same
    bits twice; and the f64 sum on groupby's final layout (row 4d's)
    within ``SEG_F64_REL_TOL`` of it relative to the sum of |values|, the
    same bits twice. Returns the largest differences there (the f32 sum's
    from the float64 and float32 plain versions, the f64 sum's relative)."""
    def exact(name, vals, ids, g):
        v = torch.from_numpy(vals).to(dev)
        seg = torch.from_numpy(ids.astype(np.int32)).to(dev)
        for op in ("sum", "min", "max"):
            got = segment_reduce_tiles(v, seg, g, op, contiguous_runs=True)
            check(torch.equal(got, ref.segment_reduce_ref(v, seg, g, op)),
                  f"segment_reduce {name} {vals.dtype} {op}")
            again = segment_reduce_tiles(v, seg, g, op, contiguous_runs=True)
            check(torch.equal(_bits(got), _bits(again)),
                  f"segment_reduce {name} {vals.dtype} {op}: bits differ "
                  f"between two runs")

    n = 5 * SEG_TILE + 3
    for shift in (-1, 0, 1):
        ids = np.clip((np.arange(n) - shift) // SEG_TILE, 0, None)
        for dt in (np.float32, np.int32, np.float64):
            exact(f"runs ending at tile edges {shift:+d}",
                  rng.integers(-99, 99, n).astype(dt), ids, 10)
    n = (1 << 22) + 3
    for dt in (np.float32, np.int32, np.float64):
        vals = rng.integers(-99, 99, n).astype(dt)
        exact("one run over all rows", vals, np.zeros(n), 3)
        exact("all rows out of range (-1)", vals, np.full(n, -1), 3)
        exact("all rows out of range (G)", vals, np.full(n, 3), 3)

    n = 3 * SEG_TILE + 11
    seg = torch.from_numpy(np.sort(rng.integers(0, 40, n)).astype(np.int32)).to(dev)
    for dt in (np.float32, np.float64):
        vals = rng.integers(-99, 99, n).astype(dt)
        vals[[5, SEG_TILE + 4, 2 * SEG_TILE + 900]] = np.nan
        v = torch.from_numpy(vals).to(dev)
        nan_seg = ref.segment_reduce_ref(torch.isnan(v).to(torch.int32), seg,
                                         40, "sum") > 0
        for op in ("min", "max"):
            got = segment_reduce_tiles(v, seg, 40, op, contiguous_runs=True)
            want = ref.segment_reduce_ref(v, seg, 40, op)
            check(torch.equal(torch.isnan(got), nan_seg) and
                  torch.equal(got[~nan_seg], want[~nan_seg]),
                  f"segment_reduce NaN {dt.__name__} {op}")

    n = 2 * ROWS
    ids = np.full(n, -1, np.int32)
    ids[:n // 2] = np.sort(rng.integers(0, 125, n // 2))
    seg = torch.from_numpy(ids).to(dev)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    got = segment_reduce_tiles(v, seg, n, "sum", contiguous_runs=True)
    check(torch.equal(_bits(got), _bits(segment_reduce_tiles(
        v, seg, n, "sum", contiguous_runs=True))),
        "segment_reduce standard-normal sums: bits differ between two runs")
    err64 = float((got.double() - ref.segment_reduce_ref(
        v.double(), seg, n, "sum")).abs().max())
    err32 = float((got - ref.segment_reduce_ref(v, seg, n, "sum")).abs().max())
    check(err64 <= SEG_F32_TOL,
          f"segment_reduce standard-normal sums differ from the float64 plain "
          f"version by {err64}")

    seg, v = seg_final_layout(dev, rng, n)
    got = segment_reduce_tiles(v, seg, n, "sum", contiguous_runs=True)
    check(torch.equal(got.view(torch.int64), segment_reduce_tiles(
        v, seg, n, "sum", contiguous_runs=True).view(torch.int64)),
        "segment_reduce float64 sums: bits differ between two runs")
    scale = ref.segment_reduce_ref(v.abs(), seg, n, "sum").clamp(min=1e-300)
    rel = float(((got - ref.segment_reduce_ref(v, seg, n, "sum")).abs()
                 / scale).max())
    check(rel <= SEG_F64_REL_TOL,
          f"segment_reduce float64 sums differ from the plain version by {rel} "
          f"of the sum of |values|")
    return {"f64": err64, "f32": err32, "f64_sum_rel": rel}


def seg_final_layout(dev, rng, n: int):
    """groupby's final layout at n slots (a worker's received buffers in
    groupby.q5): ``SEG_FINAL_FILL`` of them rows, sorted into groups of
    ~8 rows (one partial from each of 8 workers), then a -1 tail; float64
    standard-normal values. Returns (int32 ids, float64 values) on dev."""
    valid = int(n * SEG_FINAL_FILL)
    ids = np.full(n, -1, np.int32)
    ids[:valid] = np.sort(rng.integers(0, max(1, valid // 8), valid))
    vals = rng.standard_normal(n)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev))


def check_segment_scan(dev, rng) -> None:
    """segment_scan: sum/min/max x f32/i32 x inclusive/exclusive over block
    edges (4096 rows a block), 2**22 + 3 and 2**24 + 5 rows (a carry chain
    through 4097 blocks); one run through every block, every row its own
    segment, random runs with a -1 tail that starts mid-block; NaN in f32
    min/max; int32 sums that wrap. Bit for bit (NaN keeps the first NaN's
    bits on both sides), and the same bits on a second run."""
    def scan_ids(n):
        ids = np.sort(rng.integers(0, max(1, n // 37), n)).astype(np.int32)
        ids[n - n // 3 - 5:] = -1
        return ids

    for n in (1, 33, 4095, 4096, 4097, 3 * 4096 + 1, (1 << 22) + 3,
              (1 << 24) + 5):
        for layout, ids in (("one run", np.zeros(n, np.int32)),
                            ("singletons", np.arange(n, dtype=np.int32)),
                            ("random runs", scan_ids(n))):
            seg = torch.from_numpy(ids).to(dev)
            for dt in (np.float32, np.int32):
                for op in ("sum", "min", "max"):
                    vals = rng.integers(-99, 99, n).astype(dt)
                    if dt == np.float32 and op != "sum":
                        vals[rng.integers(0, n, 3)] = np.nan
                    v = torch.from_numpy(vals).to(dev)
                    for inclusive in (True, False):
                        got = segment_scan_tiles(v, seg, op, inclusive=inclusive)
                        want = ref.segment_scan_ref(v, seg, op, inclusive)
                        check(torch.equal(_bits(got), _bits(want)),
                              f"segment_scan n={n} {layout} {dt} {op} "
                              f"inclusive={inclusive}")
                    once, again = (segment_scan_tiles(v, seg, op)
                                   for _ in range(2))
                    check(torch.equal(_bits(once), _bits(again)),
                          f"segment_scan n={n} {layout} {dt} {op}: bits "
                          f"differ between two runs")
    # int32 sums that wrap: 2**30 a row in one run
    n = 3 * 4096 + 7
    v = torch.full((n,), 1 << 30, dtype=torch.int32, device=dev)
    seg = torch.zeros(n, dtype=torch.int32, device=dev)
    for inclusive in (True, False):
        check(torch.equal(segment_scan_tiles(v, seg, "sum", inclusive=inclusive),
                          ref.segment_scan_ref(v, seg, "sum", inclusive)),
              f"segment_scan int32 wrap inclusive={inclusive}")


def check_segment_scan_edges(dev, rng) -> dict[str, float]:
    """segment_scan where the single-pass design has edges: runs that end
    at the tile edges, one row before and one after; views at offsets 1, 2
    and 3 of both ids and values (tiles start at the inputs' 16-byte
    boundary) and at different offsets (4-byte loads); two calls in a row on
    different n, each equal to the plain version; sum/min/max x f32/i32 x
    inclusive/exclusive on integer values, bit for bit. Then standard-normal
    f32 sums at phase 7's shape (2**24 slots, 2 groups over the first 2**22,
    a -1 tail) and over one run through more than 4096 tiles: the same bits
    on 5 runs, within ``SCAN_F32_TOL`` of the plain version in float64.
    Returns the largest differences there and the run's tile count."""
    tile = _build.library().repro_segment_scan_rows_per_block()

    def exact(name, v, seg):
        for op in ("sum", "min", "max"):
            for inclusive in (True, False):
                got = segment_scan_tiles(v, seg, op, inclusive=inclusive)
                want = ref.segment_scan_ref(v, seg, op, inclusive)
                check(torch.equal(_bits(got), _bits(want)),
                      f"segment_scan {name} {v.dtype} {op} inclusive={inclusive}")

    def column(n, dt):
        return torch.from_numpy(rng.integers(-99, 99, n).astype(dt)).to(dev)

    n = 5 * tile + 3
    for shift in (-1, 0, 1):
        seg = torch.from_numpy(np.clip((np.arange(n) - shift) // tile, 0, None)
                               .astype(np.int32)).to(dev)
        for dt in (np.float32, np.int32):
            exact(f"runs ending at tile edges {shift:+d}", column(n, dt), seg)
    n = 3 * tile + 50
    ids = np.sort(rng.integers(0, 60, n + 8)).astype(np.int32)
    ids[n - n // 3:] = -1
    ids_t = torch.from_numpy(ids).to(dev)
    for dt in (np.float32, np.int32):
        vals = column(n + 8, dt)
        for oi, ov in ((1, 1), (2, 2), (3, 3), (1, 2), (0, 3)):
            for m in (n, 1, 6):
                exact(f"views at offsets ids {oi} values {ov} n={m}",
                      vals[ov:ov + m], ids_t[oi:oi + m])
        # two calls in a row on different n
        big, small = (vals[:n], ids_t[:n]), (vals[:tile + 1], ids_t[:tile + 1])
        for v, seg in (big, small, big):
            exact(f"calls in a row n={v.numel()}", v, seg)

    errs = {}
    shapes = {"phase7": P * (4 * ROWS // P), "one_run": (4096 + 1) * tile + 5}
    for name, n in shapes.items():
        if name == "phase7":
            ids = np.full(n, -1, np.int32)
            ids[:ROWS] = np.sort(rng.integers(0, 2, ROWS))
        else:
            ids = np.zeros(n, np.int32)
            errs["tiles"] = -(-n // tile)
        seg = torch.from_numpy(ids).to(dev)
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        runs = [_bits(segment_scan_tiles(v, seg, "sum")) for _ in range(5)]
        check(all(torch.equal(runs[0], r) for r in runs[1:]),
              f"segment_scan standard-normal sums ({name}): bits differ "
              f"between runs")
        got = runs[0].view(torch.float32).double()
        errs[name] = float((got - ref.segment_scan_ref(v.double(), seg, "sum"))
                           .abs().max())
        check(errs[name] <= SCAN_F32_TOL,
              f"segment_scan standard-normal sums ({name}) differ from the "
              f"float64 plain version by {errs[name]}")
        del runs, got
    return errs


def check_flash(dev, rng) -> None:
    """flash_attention against attention_ref on the card: S at and around
    the fp32 kernel's 64-row tiles and the bf16 kernel's 128-row tiles, and
    long (1, 63, 64, 65, 127, 128, 129, 255, 1023, 1024, and 4096 at hd 64
    and 128, 1025 at the other widths), causal or not, group size 1, 4 and
    6 (dbrx-132b's), every (q k, p v) width pair of ``KERNEL_HEAD_DIMS``
    (MLA's (96, 64) and (24, 16) among them), B up to 4, and the MoE and
    MLA prefill layers' shapes (``(4, 1024, 16, 16, 128)``, ``(4, 1024, 48,
    8, 128)``, ``(4, 1024, 40, 40, 96/64)``), fp32 within 2e-5 and
    bf16 within 2e-2 (``tests/test_kernels.py``'s tolerances: the softmax
    sums run in another order, and bf16 outputs of ~[2, 4) round one ulp,
    2^-6, apart); one case with scores scaled to +-1e4 (the online
    softmax's rescaling); the same bits on a second run. Every entry raises
    ``TypeError`` at a width pair without an instance ((96, 96), (128,
    64))."""
    def qkv(b, s, h, kv, hd, dtype, scale=1.0, dv=None):
        def x(*shape, sc=1.0):
            a = rng.standard_normal(shape).astype(np.float32) * sc
            return torch.from_numpy(a).to(dev, dtype)
        return (x(b, s, h, hd, sc=scale), x(b, s, kv, hd),
                x(b, s, kv, hd if dv is None else dv))

    cases = [(b, s, h, kv, hd, causal, 1.0, dv)
             for hd, dv in KERNEL_HEAD_DIMS for causal in (True, False)
             for s, b in ((1, 4), (63, 3), (64, 2), (65, 4), (127, 3),
                          (128, 2), (129, 4), (255, 2), (1023, 2), (1024, 2),
                          (4096, 1) if hd in (64, 128) else (1025, 1))
             for h, kv in ((8, 8), (8, 2), (12, 2))]
    # the MoE serving paths' prefill layers: qwen2-moe-a2.7b's group size 1
    # (16/16 heads) and dbrx-132b's 6 (48/8); minicpm3-4b's (40/40 heads,
    # q k over 96, p v over 64)
    cases += [(4, 1024, 16, 16, 128, True, 1.0, 128),
              (4, 1024, 48, 8, 128, True, 1.0, 128),
              (4, 1024, 40, 40, 96, True, 1.0, 64)]
    # q ~ N(0, 1e8), k ~ N(0, 1): scores q.k / sqrt(hd) ~ N(0, 1e8)
    cases.append((1, 130, 8, 2, 128, True, 1e4, 128))
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, s, h, kv, hd, causal, scale, dv in cases:
            q, k, v = qkv(b, s, h, kv, hd, dtype, scale, dv)
            got = flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            name = (f"flash {dtype} B={b} S={s} H={h} KV={kv} hd={hd}/{dv} "
                    f"causal={causal} q scale {scale:g}")
            check(got.shape == want.shape == (b, s, h, dv), f"{name}: shape")
            check(torch.allclose(got, want, atol=tol, rtol=tol),
                  f"{name}: differs by {float((got - want).abs().max())}")
            check(torch.equal(got, flash_attention(q, k, v, causal=causal)),
                  f"{name}: bits differ between two runs")
    # the scores of the last case reach past +-1e4
    top = torch.einsum("bsd,btd->bst", q[:, :, 0].float(), k[:, :, 0].float())
    check(float(top.abs().max()) / math.sqrt(128) > 1e4, "flash: scores < 1e4")
    for hd, dv in ((96, 96), (128, 64)):
        q, k, v = qkv(1, 4, 2, 2, hd, torch.bfloat16, dv=dv)
        o = q.new_zeros((1, 4, 2, dv))
        for name, call in (
                ("flash_attention", lambda: flash_attention(q, k, v)),
                ("flash_attention_lse", lambda: flash_attention_lse(q, k, v)),
                ("flash_attention_bwd", lambda: flash_attention_bwd(
                    q, k, v, o, torch.zeros(1, 2, 4, device=dev), o))):
            try:
                call()
                check(False, f"{name} ran at widths ({hd}, {dv}), which have "
                      f"no instance")
            except TypeError as e:
                check("head dims" in str(e), f"{name} at ({hd}, {dv}): {e}")


# The flash backward against autograd through attention_ref (fp32 inside)
# on the same bf16 or fp32 inputs: each of dq, dk and dv on its own, in
# every 64-row tile of the sequence (query rows for dq, key rows for dk and
# dv; the tile's batches and heads together), as
#     ||got - plain||_F <= tol * ||plain||_F + FLASH_BWD_ATOL * sqrt(n)
# over the tile's n elements. A causal gradient shrinks along the sequence
# (about 10 in the first rows, 0.1 by row 500), so a scale taken from the
# largest value would let through a fault in every later tile; each tile's
# own norm does not (``check_flash_train`` plants one: the lse off by ln 2
# past the first four tiles must fail). bf16: the kernel rounds P and dS to bf16
# for the tensor-core products, takes D from the forward's bf16 output and
# writes bf16 gradients (2^-9 relative each, independent from element to
# element, so a tile's norm of them stays near 2^-9). fp32: FMA sums in
# another order than the plain version's. The floor is for S 1, where the
# exact dq and dk are 0 (dP and D cancel) and the kernel's rounding of the
# two remains. Each limit is 3-5 times the largest reading on an H100 over
# phase 2's cases (bf16 3.7e-3, fp32 1.8e-6, RMS where plain is 0 4.9e-7;
# PERF.md).
FLASH_BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
FLASH_BWD_ATOL, FLASH_BWD_TILE = 2e-6, 64
# the training forward's lse against a float64 logsumexp of the same inputs:
# fp32 sums of up to S exp2 terms (ex2.approx, 2^-22 relative)
FLASH_LSE_TOL = 1e-4
# phase 7's library calls for the training entries must compute the same
# function: their output and lse within this of the plain version's
# (absolute; bf16 outputs of size ~3 round by 2^-8 of that), their
# gradients' worst tile within it of the plain norm. A wrong head map or
# mask moves either by its own size.
LIBRARY_SAME_FN = 5e-2


# the q k widths whose first case in flash_train_cases plants the lse
# fault (96: MLA's, at its training shape)
FLASH_PLANTED_DIMS = (64, 160, 16, 96)


# sequence lengths that straddle every tile edge of the backward: the 64-row
# key and query tiles of dK/dV and dQ's ring, dQ's 128-row query items and
# the 128-row padding of the lse and D rows
FLASH_TRAIN_SEQS = (1, 63, 64, 65, 127, 128, 129, 1000, 1025)
# group sizes H / KV of the training checks: the bf16 dK/dV launch splits a
# KV head's G query heads into up to G items where items are few, so 1, 2,
# 4 and 8 give every split it takes at these shapes (on a 132-SM card: 1
# at G 1 and on the path's shapes but hd 160's, 2 there, up to G below)
FLASH_TRAIN_GROUPS = ((4, 4), (4, 2), (8, 2), (16, 2))
# dbrx-132b's group size, 6 (48/8 heads): not a power of two, so the dK/dV
# launch's dealing and splitting of a KV head's heads meet it at every S
FLASH_TRAIN_G6 = (12, 2)
# phase 26's train_4k cells, a microbatch's flash shape each (B 2 of a data
# shard's 16 rows in 8 microbatches, S 4096): llama3-8b's 32/8 heads and
# qwen2-moe-a2.7b's 16/16, of 128; each also takes the planted lse fault
FLASH_TRAIN_CELLS = ((2, 4096, 32, 8, 128, True, torch.bfloat16, 128),
                     (2, 4096, 16, 16, 128, True, torch.bfloat16, 128))


def flash_train_cases():
    """(B, S, H, KV, hd, causal, dtype, dv) of phase 2's training checks
    (hd the q k width, dv the p v width): the path's shape (granite-3-2b's
    heads, B 2, S 1024, bf16, causal), llama3-8b's (hd 128), one microbatch
    of phase 17's stablelm-12b (hd 160, B 1), hd 16 at B 2, one microbatch
    of phase 19's qwen2-moe-a2.7b (hd 128, group size 1, B 2) and of phase
    20's minicpm3-4b (40/40 heads, 96/64, B 1); every ``FLASH_TRAIN_SEQS``
    at group size 4 for every width pair, causal or not, bf16 and fp32, and
    in bf16 at group size 6 (``FLASH_TRAIN_G6``); and in bf16 every other
    group of ``FLASH_TRAIN_GROUPS`` at S 129 and 1025, causal or not; and
    phase 26's train cells' shapes (``FLASH_TRAIN_CELLS``)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(2, 1024, 32, 8, 64, True, bf, 64),
             (2, 1024, 32, 8, 128, True, bf, 128),
             (1, 1024, 32, 8, 160, True, bf, 160),
             (2, 1024, 32, 8, 16, True, bf, 16),
             (2, 1024, 16, 16, 128, True, bf, 128),
             (1, 1024, 40, 40, 96, True, bf, 64)]
    cases += [(2 if s < 1025 else 1, s, 8, 2, hd, causal, dt, dv)
              for dt in (bf, f32) for hd, dv in KERNEL_HEAD_DIMS
              for causal in (True, False) for s in FLASH_TRAIN_SEQS]
    cases += [(2 if s < 1025 else 1, s, *FLASH_TRAIN_G6, hd, causal, bf, dv)
              for hd, dv in KERNEL_HEAD_DIMS for causal in (True, False)
              for s in FLASH_TRAIN_SEQS]
    cases += [(2 if s < 1025 else 1, s, h, kv, hd, causal, bf, dv)
              for hd, dv in KERNEL_HEAD_DIMS for h, kv in FLASH_TRAIN_GROUPS
              if (h, kv) != (8, 2) for causal in (True, False)
              for s in (129, 1025)]
    return cases + list(FLASH_TRAIN_CELLS)


def _tile_squares(x: torch.Tensor) -> torch.Tensor:
    """Sums of squares of x (B, S, heads, hd) over each ``FLASH_BWD_TILE``
    rows of S, in float64."""
    r = x.double().square().sum(dim=(0, 2, 3))
    return F.pad(r, (0, -r.numel() % FLASH_BWD_TILE)).view(
        -1, FLASH_BWD_TILE).sum(1)


def bwd_errors(got, want, dtype) -> dict[str, dict[str, float]]:
    """For each of dq, dk, dv: ``excess``, the worst tile's ||got - plain||
    over its limit (``FLASH_BWD_TOL``, ``FLASH_BWD_ATOL``; at most 1 to
    pass), ``rel``, the worst ||got - plain|| / ||plain|| of a tile whose
    plain norm is not 0, and ``zero_rms``, the worst RMS error of a tile
    whose plain gradient is 0."""
    res = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = _tile_squares(a.double() - w.double()).sqrt()
        norm = _tile_squares(w).sqrt()
        n = _tile_squares(torch.ones_like(w[..., :1])) * w.shape[-1]
        limit = FLASH_BWD_TOL[dtype] * norm + FLASH_BWD_ATOL * n.sqrt()
        nz = norm > 0
        res[name] = {
            "excess": float((err / limit).max()),
            "rel": float((err[nz] / norm[nz]).max()) if nz.any() else 0.0,
            "zero_rms": float((err[~nz] / n[~nz].sqrt()).max())
            if (~nz).any() else 0.0}
    return res


def check_flash_train(dev, rng) -> dict:
    """The training entries against their plain versions on the card:
    flash_attention_lse's out bit-equal to the serving entry's and its lse
    within ``FLASH_LSE_TOL`` of a float64 logsumexp; flash_attention_bwd
    against autograd through ``attention_ref`` per gradient and tile
    (``bwd_errors``), the same bits on a second run. At the path's shape
    and at the first case of each other ``FLASH_PLANTED_DIMS`` a planted
    fault, the lse off by ln 2 past the first four tiles, must fail each of
    dq, dk, dv, and at each of ``FLASH_TRAIN_CELLS``. Returns the worst
    readings by dtype and, by head dim (and shape for a cell), the planted
    fault's excess, beside its largest |diff| over the largest |plain|
    (``max_over_max``, the measure this check replaced)."""
    worst = {key: {"rel": 0.0, "zero_rms": 0.0, "excess": 0.0}
             for key in ("bf16", "f32")}
    planted = {}
    for b, s, h, kv, hd, causal, dtype, dv in flash_train_cases():
        def x(*shape):
            a = rng.standard_normal(shape).astype(np.float32)
            return torch.from_numpy(a).to(dev, dtype)
        q, k, v, dout = x(b, s, h, hd), x(b, s, kv, hd), x(b, s, kv, dv), \
            x(b, s, h, dv)
        name = (f"flash train {dtype} B={b} S={s} H={h} KV={kv} hd={hd}/{dv} "
                f"causal={causal}")
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        check(torch.equal(out, flash_attention(q, k, v, causal=causal)),
              f"{name}: the LSE instance's out differs from the serving one")
        _, want_lse = ref.attention_lse_ref(q.double(), k.double(), v.double(),
                                            causal=causal)
        err = float((lse.double() - want_lse).abs().max())
        check(err <= FLASH_LSE_TOL * max(1.0, float(want_lse.abs().max())),
              f"{name}: lse differs from float64 by {err}")
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        want = ref.attention_bwd_ref(q, k, v, dout, causal=causal)
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        for gname, e in bwd_errors(got, want, dtype).items():
            check(e["excess"] <= 1.0,
                  f"{name}: {gname} at {e['excess']:.3g} times its limit "
                  f"(worst tile ||diff|| / ||plain|| {e['rel']:.3g}, RMS "
                  f"where plain is 0 {e['zero_rms']:.3g})")
            for m in worst[key]:
                worst[key][m] = max(worst[key][m], e[m])
        again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"{name}: bits differ between two runs")
        case = (b, s, h, kv, hd, causal, dtype, dv)
        label = (f"hd {hd}, B {b} S {s} {h}/{kv} heads"
                 if case in FLASH_TRAIN_CELLS else f"hd {hd}")
        if (hd in FLASH_PLANTED_DIMS or case in FLASH_TRAIN_CELLS) and \
                label not in planted:
            shifted = lse.clone()
            shifted[:, :, 4 * FLASH_BWD_TILE:] += math.log(2)
            bad = flash_attention_bwd(q, k, v, out, shifted, dout,
                                      causal=causal)
            fault = {g: e["excess"]
                     for g, e in bwd_errors(bad, want, dtype).items()}
            check(all(x > 1.0 for x in fault.values()),
                  f"{name}: the lse off by ln 2 past the first four tiles "
                  f"passes the backward's check ({fault} times the limit)")
            fault["max_over_max"] = max(
                float((a.float() - w.float()).abs().max()) for a, w in
                zip(bad, want)) / max(float(w.float().abs().max())
                                      for w in want)
            planted[label] = fault
    check(len(planted) == len(FLASH_PLANTED_DIMS) + len(FLASH_TRAIN_CELLS),
          f"the lse fault was planted at {sorted(planted)}")
    return {**worst, "planted": planted}


def phase_semantics(dev) -> None:
    """torch.sort's float order on the card, and the counts carrier."""
    x = torch.tensor([1.0, -0.0, 0.0, float("nan"), -1.0, 0.0, -0.0,
                      float("-inf"), float("nan"), 2.0] * 300)
    cpu = torch.sort(x, stable=True)
    gpu = torch.sort(x.to(dev), stable=True)
    check(torch.equal(gpu.indices.cpu(), cpu.indices),
          "torch.sort float order differs between CPU and CUDA")
    zeros = (x == 0).nonzero().flatten()
    check(torch.equal(gpu.indices.cpu()[(gpu.values.cpu() == 0)], zeros),
          "torch.sort: +-0 not tied")
    check(torch.isnan(gpu.values[-600:]).all().item(), "torch.sort: NaN not last")

    # counts carrier: the only 4-byte column is float32, so the int32 send
    # counts travel as (denormal) float32 bit patterns
    rng = np.random.default_rng(5)
    mesh = VirtualMesh(P)
    cap, cb = 4096, 1500
    tables, pids, want = [], [], np.zeros(P, np.int64)
    for i in range(P):
        rows = 3000 + 100 * i
        col = torch.from_numpy(rng.standard_normal(cap).astype(np.float32)).to(dev)
        tables.append(Table({"x": col}, torch.tensor(rows, dtype=torch.int32,
                                                    device=dev)))
        pid = rng.integers(0, P, cap).astype(np.int32)
        pids.append(torch.from_numpy(pid).to(dev))
        np.add.at(want, pid[:rows], 1)
    for kw in ({"stages": 1}, {"stages": 3}, {"shuffle_mode": "ring"}):
        outs, st = repartition(tables, pids, mesh=mesh, bucket_capacity=cb, **kw)
        check(st.received.cpu().tolist() == want.tolist(),
              f"counts carrier {kw}: received {st.received.tolist()} "
              f"want {want.tolist()}")
        check(int(st.overflow.sum()) == 0, "counts carrier overflow")
        check([int(t.row_count) for t in outs] == want.tolist(),
              "counts carrier row counts")


# ---------------------------------------------------------------------------
# phases 3-4: the main path, through the kernels and through plain versions
# ---------------------------------------------------------------------------


def main_path_calls(ctx: DistContext, a: DistTable, b: DistTable,
                    g: DistTable, w: DistTable):
    aggs = {"d0": ["sum", "count", "mean", "var", "min", "max"]}
    return [
        ("join_sort", lambda: ctx.join(a, b, "k", algorithm="sort")),
        ("join_hash", lambda: ctx.join(a, b, "k", algorithm="hash")),
        ("groupby_two_phase", lambda: ctx.groupby(
            g, "k", aggs, strategy="two_phase", bucket_capacity=256)),
        ("groupby_shuffle", lambda: ctx.groupby(g, "k", aggs, strategy="shuffle")),
        ("sort", lambda: ctx.sort(a, "k")),
        ("window", lambda: ctx.window(w, "k", WINDOW_FUNCS, order_by="o")),
    ]


def summarize(out: DistTable, stats) -> dict:
    """What phase 4 compares: valid rows (trimmed, on the device),
    per-shard row counts and every shuffle's stats."""
    return {"rows": out.to_table().columns,
            "row_counts": out.row_counts.cpu().tolist(),
            "overflow": [s.overflow.cpu().tolist() for s in stats],
            "received": [s.received.cpu().tolist() for s in stats]}


def canonical(cols: dict[str, torch.Tensor], keys) -> dict[str, torch.Tensor]:
    """Rows sorted lexicographically by ``keys`` (bit patterns for floats)."""
    perm = L.lex_sort_perm([_bits(cols[n]) for n in keys])
    return {n: v[perm] for n, v in cols.items()}


def compare_rows(name: str, got: dict, want: dict) -> None:
    """Bitwise equality of the row multisets."""
    names = sorted(want)
    check(sorted(got) == names, f"{name}: columns {sorted(got)} vs {names}")
    a, b = canonical(got, names), canonical(want, names)
    for n in names:
        check(torch.equal(_bits(a[n]), _bits(b[n])), f"{name}: column {n} differs")


def compare_groupby(name: str, got: dict, want: dict) -> float:
    """One row per key: keys, counts, min, max exact; float sums and what
    derives from them (sum, mean, var) within rtol 1e-4 + atol 5e-2 (sum)
    or 1e-4 (mean, var): the plain scatter adds in another order (atomics
    on the card), and a group sums ~4000-33000 standard-normal values.
    Returns the largest difference seen."""
    a, b = canonical(got, ["k"]), canonical(want, ["k"])
    worst = 0.0
    for n in sorted(want):
        x, y = a[n], b[n]
        if n.endswith(("_sum", "_mean", "_var")):
            atol = 5e-2 if n.endswith("_sum") else 1e-4
            check(torch.allclose(x, y, rtol=1e-4, atol=atol),
                  f"{name}: {n} differs by {float((x - y).abs().max())}")
            worst = max(worst, float((x - y).abs().max()) if x.numel() else 0.0)
        else:
            check(torch.equal(x, y), f"{name}: column {n} differs")
    return worst


def window_table(ctx: DistContext, rows: int, device, seed: int = 4):
    """The window input, 16 B a row, 8 shards of ``rows``: ``k`` int32 over
    12 groups (most groups span shards), ``o`` int32 a permutation of the
    global row ids (a unique order), ``d0`` float32 integer-valued over
    [-50, 50], ``d1`` int32 over [-9, 9]. Zero-mean integer data keeps
    every running sum far below 2**24, so float sums are exact."""
    rng = np.random.default_rng(seed)
    n = P * rows
    cols = {"k": rng.integers(0, WINDOW_GROUPS, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "d0": rng.integers(-50, 50, n, endpoint=True).astype(np.float32),
            "d1": rng.integers(-9, 9, n, endpoint=True).astype(np.int32)}
    return ctx.from_local_parts([
        Table.from_numpy({k: v[i * rows:(i + 1) * rows] for k, v in cols.items()},
                         device=device) for i in range(P)])


def make_tables(ctx: DistContext, rows: int, device):
    """Four tables, 8 shards each: two join sides of the paper's relation
    (keys uniform over [0, 8 * rows)), a groupby input (1000 keys) and the
    window input (:func:`window_table`)."""
    def dist(seed, key_range):
        return ctx.from_local_parts([
            random_table(rows, key_range=key_range, seed=seed, shard=i,
                         device=device) for i in range(P)])
    return (dist(1, P * rows), dist(2, P * rows), dist(3, 1000),
            window_table(ctx, rows, device))


def compare_results(name: str, got: dict, want: dict) -> float:
    """One operator's ``summarize`` through the kernels against the plain
    run's; returns the largest float-sum difference (0 outside groupby)."""
    for key in ("row_counts", "overflow", "received"):
        check(got[key] == want[key], f"{name}: {key} {got[key]} vs plain {want[key]}")
    if name.startswith("groupby"):
        return compare_groupby(name, got["rows"], want["rows"])
    if name == "window":  # sorted output: every row, in order
        check(sorted(got["rows"]) == sorted(want["rows"]),
              f"window: columns {sorted(got['rows'])}")
        for n, col in want["rows"].items():
            check(torch.equal(_bits(got["rows"][n]), _bits(col)),
                  f"window: column {n} differs")
        return 0.0
    compare_rows(name, got["rows"], want["rows"])
    return 0.0


def phase_main_path(ctx, tabs):
    """Each call once through the kernels, the launch counts zeroed just
    before the first and read just after the last. Returns the results,
    wall ms and peak device memory per call, and the counts."""
    results, walls, peaks = {}, {}, {}
    torch.cuda.synchronize()
    set_launches(0)
    for name, call in main_path_calls(ctx, *tabs):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, stats = call()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        peaks[name] = torch.cuda.max_memory_allocated()
        results[name] = summarize(out, stats)
        del out, stats
    counts = launches()
    for k, want in MAIN_PATH_LAUNCHES.items():
        check(counts[k] == want,
              f"{k} launched {counts[k]} times on the main path, want {want}")
    return results, walls, counts, peaks


def phase_plain_path(ctx, tabs, kernel_results) -> dict:
    walls, worst = {}, 0.0
    set_launches(0)
    with kops.oracle_scope():
        for name, call in main_path_calls(ctx, *tabs):
            t0 = time.perf_counter()
            out, stats = call()
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3
            got = kernel_results[name]
            worst = max(worst, compare_results(name, got, summarize(out, stats)))
            del out, stats
            say(f"  {name}: rows {int(sum(got['row_counts']))}, row_counts, "
                f"overflow {got['overflow']}, received equal to the plain run")
    check(all(v == 0 for v in launches().values()),
          f"plain run launched kernels: {launches()}")
    return {"walls": walls, "worst_float_diff": worst}


def phase_operator_times(ctx, tabs, rounds: int = 2) -> dict[str, dict]:
    """Wall ms per operator through the kernels and through the plain
    versions, in turns (plain, kernels, kernels, plain) x ``rounds``;
    medians of the host clock around each synchronised call."""
    out = {}
    for name, call in main_path_calls(ctx, *tabs):
        samples = {"kernels": [], "plain": []}
        for _ in range(rounds):
            for mode in ("plain", "kernels", "kernels", "plain"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "plain":
                    with kops.oracle_scope():
                        res = call()
                else:
                    res = call()
                torch.cuda.synchronize()
                samples[mode].append((time.perf_counter() - t0) * 1e3)
                del res
        out[name] = {m: statistics.median(v) for m, v in samples.items()}
        out[name]["samples"] = len(samples["kernels"])
    return out


def direct_route(ctx: DistContext, call):
    """``call``'s operator on the route eager operators took before
    ``submit``: its one-node plan through the cost pass and straight into
    ``execute_plan``, with no plan cache, future, event or recovery ladder
    (for inputs without statistics, as on the main path)."""
    seen = []
    real = ctx._run_plan
    ctx._run_plan = lambda plan, tabs, **kw: (
        seen.append((plan, tabs)) or real(plan, tabs, **kw))
    try:
        call()
    finally:
        del ctx._run_plan
    (plan, tabs), = seen
    check(all(t.stats is None for t in tabs), "direct_route: analyzed input")
    schemas, p = [t.schema for t in tabs], ctx.num_shards
    part = PL.output_partitioning(plan, schemas, p)
    plan = PL.apply_cost_model(plan, schemas, p, [None] * len(tabs))

    def run():
        out, stats = PL.execute_plan(plan, [t.shards() for t in tabs],
                                     mesh=ctx.mesh)
        return DistTable.from_shards(out, part), stats

    return run


def phase_submit_route(ctx, tabs, rounds: int = 3) -> dict[str, dict]:
    """Each main-path operator through ``submit`` (the eager route) and
    through :func:`direct_route`, in one process: the same rows from both,
    the host syncs of one call of each (submit counted before and after
    the direct call, so an allocator's sync on whichever call comes first
    shows), and median wall ms of each in turns (direct, submit, submit,
    direct) x ``rounds``."""
    out = {}
    for name, call in main_path_calls(ctx, *tabs):
        direct = direct_route(ctx, call)
        got, syncs = count_syncs(call)
        got = summarize(*got)
        want, direct_syncs = count_syncs(direct)
        compare_results(name, got, summarize(*want))
        del got, want
        _, syncs_after = count_syncs(call)
        direct_ms, submit_ms = in_turns(direct, call, rounds)
        out[name] = {"submit_ms": submit_ms, "direct_ms": direct_ms,
                     "submit_syncs": [syncs, syncs_after],
                     "direct_syncs": direct_syncs, "samples": 2 * rounds}
    return out


def phase_profile(ctx, tabs, top: int = 8) -> dict[str, dict]:
    """One :func:`profiled` run of each operator through the kernels."""
    return {name: profiled(name, call, top)
            for name, call in main_path_calls(ctx, *tabs)}


def profiled(name: str, call, top: int = 8) -> dict:
    """One ``torch.profiler`` run of ``call``: wall ms (with the profiler's
    overhead), the summed device time of its GPU kernels, their ratio (the
    device's busy share; the port uses one stream), the device time of the
    port's own CUDA kernels (``PORTED_KERNELS``) and the kernels that took
    the most device time; ``ported`` splits the port's by source file
    (``flash``, ``hist``, ...). A trace that records no device event at
    all (CUPTI dropped it: seen once at phase 7's zamba backward) is
    taken once more, ``traces`` 2, before the check fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for traces in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        del res
        by_name: dict[str, float] = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                    ev.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        if busy > 0:
            break
    check(busy > 0, f"profile of {name}: no device time recorded in "
          f"{traces} traces")
    ported = sum(ms for kname, ms in by_name.items()
                 if any(k in kname for k in PORTED_KERNELS))
    # by kernel source: flash, hist, hash32, bitonic, seg, scan
    by_source: dict[str, float] = {}
    for kname, ms in by_name.items():
        hit = next((k for k in PORTED_KERNELS if k in kname), None)
        if hit is not None:
            src = hit.split("_")[0]
            by_source[src] = by_source.get(src, 0.0) + ms
    # torch ops the host dispatched (top-level: not those inside another op)
    host_ops = sum(1 for ev in prof.events() if ev.device_type ==
                   DeviceType.CPU and ev.cpu_parent is None and
                   ev.name.startswith("aten::"))
    return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
            "ported_kernels_ms": ported, "ported": by_source,
            "host_ops": host_ops, "traces": traces,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


# ---------------------------------------------------------------------------
# phase 11: statistics and the lazy plan, on the main path's tables
# ---------------------------------------------------------------------------


def in_turns(first, second, rounds: int = 2) -> tuple[float, float]:
    """Median wall ms of two calls run in turns (first, second, second,
    first) x ``rounds``, the host clock around each synchronised call."""
    samples = ([], [])
    for _ in range(rounds):
        for which in (0, 1, 1, 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = (first, second)[which]()
            torch.cuda.synchronize()
            samples[which].append((time.perf_counter() - t0) * 1e3)
            del res
    return statistics.median(samples[0]), statistics.median(samples[1])


def counted(call):
    """(result, launch counts, peak device bytes) of one call, the counts
    zeroed just before it and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    res = call()
    torch.cuda.synchronize()
    return res, launches(), torch.cuda.max_memory_allocated()


def understated() -> S.TableStats:
    """TableStats claiming 16 rows over 2 keys: every bucket the cost model
    sizes from them is ~7 slots, far below the rows a shard sends."""
    return S.TableStats(rows=16.0, columns=(("k", S.ColumnStats(2.0)),),
                        max_shard_rows=2.0)


def pipeline_frame(ctx: DistContext, a: DistTable, b: DistTable):
    """Phase 11's frame: ``frame(a).select(d0 > 0).join(frame(b), on="k")
    .groupby("k", PLAN_AGGS)``."""
    return ctx.frame(a).select(lambda c: c["d0"] > 0, key="d0>0").join(
        ctx.frame(b), on="k").groupby("k", PLAN_AGGS)


def eager_chain(ctx: DistContext, a: DistTable, b: DistTable, report=None):
    """The same three operators as eager calls (one-node plans)."""
    s = ctx.select(a, lambda c: c["d0"] > 0, report=report)
    j, _ = ctx.join(s, b, "k", report=report)
    del s
    return ctx.groupby(j, "k", PLAN_AGGS, report=report)


def plan_calls(ctx: DistContext, tabs, analyzed) -> dict:
    """Phase 11's calls that are timed and profiled, by name."""
    a, b = tabs[:2]
    a2, b2 = analyzed[:2]
    return {
        "analyze": lambda: [ctx.analyze(t) for t in tabs],
        "pipeline": lambda: pipeline_frame(ctx, a2, b2).collect_with_stats(),
        "eager_chain": lambda: eager_chain(ctx, a, b),
        "groupby_with_stats": lambda: ctx.frame(b2).groupby(
            "k", PLAN_AGGS).collect_with_stats(),
        "groupby_without_stats": lambda: ctx.frame(b).groupby(
            "k", PLAN_AGGS).collect_with_stats(),
    }


def phase_plan(ctx: DistContext, tabs, dev, small_rows: int) -> dict:
    """Statistics and the lazy plan at the main path's size (phase 11).

    1. ``ctx.analyze`` of the four tables: every TableStats field equal, by
       repr, to the same call under ``oracle_scope()``; hash32_partition
       launched once a table and key column (``ANALYZE_LAUNCHES``); timed
       in turns with the plain run.
    2. :func:`pipeline_frame` on the analyzed tables (the groupby elided on
       the join's tag): rows bit for bit against the same frame under
       ``oracle_scope()`` and against :func:`eager_chain` on the plain
       tables (``compare_rows``: count/min/max/first are exact in any
       order); every kernel of ``PIPELINE_KERNELS`` launched; timed in
       turns with the eager chain.
    3. groupby "auto" on ``b`` (keys uniform over [0, 8 * rows)): shuffle
       with stats, two_phase without; both timed.
    4. Elision: a groupby over ``ctx.sort(a)``'s output and a join over
       ``ctx.partition_by(b)``'s output; the elided records of
       ``plan_report`` equal the executed ones, their stats are zero, the
       wire bytes agree.
    5. The safe-capacity re-run at ``small_rows`` a shard: two tables whose
       stats understate their rows; one re-run, rows as without stats.

    Returns the numbers, and the analyzed tables under ``"analyzed"``.
    """
    a, b, g, w = tabs
    out: dict = {}
    # 1. analyze
    analyzed, n, peak = counted(lambda: [ctx.analyze(t) for t in tabs])
    check(n == {**ZERO_LAUNCHES, **ANALYZE_LAUNCHES},
          f"analyze launched {n}, want {ANALYZE_LAUNCHES}")
    with kops.oracle_scope():
        plain = [ctx.analyze(t) for t in tabs]
    check(launches() == n, "analyze under oracle_scope launched kernels")
    for t, got, want in zip("abgw", analyzed, plain):
        check(repr(got.stats) == repr(want.stats),
              f"analyze({t}) differs from the plain run:\n{got.stats}\n"
              f"{want.stats}")
    calls = plan_calls(ctx, tabs, analyzed)
    kern, plain_ms = in_turns(calls["analyze"],
                              lambda: _plain(calls["analyze"]))
    out["analyzed"] = analyzed
    out["analyze"] = {"ms": kern, "plain_ms": plain_ms, "launches": n,
                      "peak_bytes": peak,
                      "stats": {t: repr(s.stats) for t, s in zip("abgw",
                                                                 analyzed)}}
    a2, b2, _, _ = analyzed

    # 2. the frame pipeline against the oracle run and the eager chain
    frame = pipeline_frame(ctx, a2, b2)
    out["explain"] = frame.explain()
    (res, stats), n, peak = counted(frame.collect_with_stats)
    check(all(n[k] > 0 for k in PIPELINE_KERNELS),
          f"pipeline launched {n}: a kernel of {PIPELINE_KERNELS} never ran")
    got = summarize(res, stats)
    with kops.oracle_scope():
        want = summarize(*frame.collect_with_stats())
    check(got["row_counts"] == want["row_counts"]
          and got["received"] == want["received"],
          "pipeline: counts differ from the plain run")
    compare_rows("pipeline vs plain", got["rows"], want["rows"])
    chain_report = []
    chain = summarize(*eager_chain(ctx, a, b, chain_report))
    check(sum(chain["row_counts"]) == sum(got["row_counts"]),
          "pipeline: rows differ from the eager chain")
    compare_rows("pipeline vs eager chain", got["rows"], chain["rows"])
    check(all(sum(o) == 0 for o in got["overflow"]), "pipeline overflowed")
    fr_ms, ch_ms = in_turns(calls["pipeline"], calls["eager_chain"])
    out["pipeline"] = {"ms": fr_ms, "eager_chain_ms": ch_ms, "launches": n,
                       "peak_bytes": peak, "rows": sum(got["row_counts"]),
                       "report": frame.plan_report(),
                       "eager_chain_report": chain_report}
    del res, stats, got, want, chain

    # 3. the strategy choice on the join table
    with_stats = ctx.frame(b2).groupby("k", PLAN_AGGS)
    without = ctx.frame(b).groupby("k", PLAN_AGGS)
    strategies, rows = {}, {}
    for name, f in (("with_stats", with_stats), ("without_stats", without)):
        strategies[name] = f.optimized().strategy
        (res, stats), n, peak = counted(f.collect_with_stats)
        rows[name] = summarize(res, stats)["rows"]
        out[f"groupby_{name}"] = {"strategy": strategies[name],
                                  "report": f.plan_report(), "launches": n,
                                  "peak_bytes": peak,
                                  "rows": int(res.row_counts.sum())}
        del res, stats
    check(strategies == {"with_stats": "shuffle", "without_stats": "two_phase"},
          f"groupby auto picked {strategies}")
    compare_rows("groupby with stats vs without", rows["with_stats"],
                 rows["without_stats"])
    del rows
    ms_with, ms_without = in_turns(calls["groupby_with_stats"],
                                   calls["groupby_without_stats"])
    out["groupby_with_stats"]["ms"] = ms_with
    out["groupby_without_stats"]["ms"] = ms_without

    # 4. elision off placement tags
    sorted_a, _ = ctx.sort(a2, "k")
    part_b, _ = ctx.partition_by(b2, "k")
    elided = {}
    for name, f, want_elided in (
            ("sorted_groupby", ctx.frame(sorted_a).groupby("k", PLAN_AGGS),
             [True]),
            ("partitioned_join", ctx.frame(part_b).join(ctx.frame(a2), on="k"),
             [True, False])):
        static = f.plan_report()
        executed = []
        res, stats = f.collect_with_stats(report=executed)
        check([r["elided"] for r in static] == want_elided,
              f"{name}: plan_report elided {[r['elided'] for r in static]}")
        check(static == executed, f"{name}: plan_report differs from the run")
        for r, s in zip(executed, stats):
            if r["elided"]:
                check(int(s.received.sum()) == 0 and int(s.overflow.sum()) == 0,
                      f"{name}: an elided shuffle moved rows")
        elided[name] = {"elided": sum(r["elided"] for r in static),
                        "wire_bytes": sum(r["wire_bytes"] for r in static),
                        "executed_wire_bytes": sum(r["wire_bytes"]
                                                   for r in executed)}
        del res, stats
    out["elided"] = elided
    del sorted_a, part_b

    # 5. the safe-capacity re-run on small tables with understated stats
    x, y = (ctx.from_local_parts([
        random_table(small_rows, key_range=P * small_rows, seed=seed, shard=i,
                     device=dev) for i in range(P)]) for seed in (5, 6))
    bad = [dataclasses.replace(t, stats=understated()) for t in (x, y)]
    before = ctx.overflow_retries
    res, stats = ctx.frame(bad[0]).join(ctx.frame(bad[1]), on="k") \
        .collect_with_stats()
    check(ctx.overflow_retries - before == 1,
          f"{ctx.overflow_retries - before} safe re-runs, want 1")
    check(res.stats is None, "a failed estimate's stats were propagated")
    got = summarize(res, stats)
    want = summarize(*ctx.frame(x).join(ctx.frame(y), on="k")
                     .collect_with_stats())
    check(got["row_counts"] == want["row_counts"],
          "safe re-run: row counts differ from the run without stats")
    compare_rows("safe re-run", got["rows"], want["rows"])
    out["safe_rerun"] = {"rows_per_shard": small_rows, "overflow_retries": 1,
                         "rows": sum(got["row_counts"])}
    return out


def say_plan(plan: dict, card: str, secs: float) -> None:
    an, pl = plan["analyze"], plan["pipeline"]
    say(f"[11] analyze of 4 tables: {an['ms']:.2f} ms (plain {an['plain_ms']:.2f})"
        f", stats equal to the plain run; launches {an['launches']} on {card}")
    for t, st in an["stats"].items():
        say(f"[11]   {t}: {st}")
    say("[11] pipeline explain():")
    for line in plan["explain"].splitlines():
        say(f"      {line}")
    say(f"[11] pipeline: {pl['ms']:.1f} ms (eager chain {pl['eager_chain_ms']:.1f})"
        f", {pl['rows']} rows equal to the plain run and to the eager chain; "
        f"peak {pl['peak_bytes'] / 2**30:.2f} GiB; launches {pl['launches']}")
    for name in ("with_stats", "without_stats"):
        gb = plan[f"groupby_{name}"]
        say(f"[11] groupby auto {name}: {gb['strategy']}, {gb['ms']:.1f} ms, "
            f"bucket {gb['report'][0]['bucket']}, wire "
            f"{gb['report'][0]['wire_bytes']} B, peak "
            f"{gb['peak_bytes'] / 2**30:.2f} GiB")
    for name, e in plan["elided"].items():
        say(f"[11] {name}: {e['elided']} shuffle(s) elided, wire bytes "
            f"{e['wire_bytes']} planned = {e['executed_wire_bytes']} run")
    say(f"[11] safe-capacity re-run at {plan['safe_rerun']['rows_per_shard']} "
        f"rows a shard: 1 re-run, rows equal to the run without stats "
        f"({secs:.1f} s for phase 11)")


def plan_summary(plan: dict, rows: int) -> dict:
    """Phase 11's numbers for the JSON line."""
    pl = plan["pipeline"]

    def buckets(report):
        return [{k: r[k] for k in ("op", "elided", "bucket", "wire_bytes",
                                   "stages")} for r in report]

    return {
        "rows_per_shard": rows,
        "analyze_ms": plan["analyze"]["ms"],
        "analyze_plain_ms": plan["analyze"]["plain_ms"],
        "analyze_launches": plan["analyze"]["launches"],
        "pipeline_ms": pl["ms"], "eager_chain_ms": pl["eager_chain_ms"],
        "pipeline_launches": pl["launches"],
        "groupby_auto_ms": {k: plan[f"groupby_{k}"]["ms"]
                            for k in ("with_stats", "without_stats")},
        "groupby_strategy": {k: plan[f"groupby_{k}"]["strategy"]
                             for k in ("with_stats", "without_stats")},
        "groupby_launches": {k: plan[f"groupby_{k}"]["launches"]
                             for k in ("with_stats", "without_stats")},
        "buckets": {
            "pipeline_cost_sized": buckets(pl["report"]),
            "eager_chain_no_stats": buckets(pl["eager_chain_report"]),
            "groupby_cost_sized": buckets(plan["groupby_with_stats"]["report"]),
            "groupby_no_stats": buckets(plan["groupby_without_stats"]["report"]),
        },
        "elided": plan["elided"],
        "peak_bytes": {"analyze": plan["analyze"]["peak_bytes"],
                       "pipeline": pl["peak_bytes"],
                       **{f"groupby_{k}": plan[f"groupby_{k}"]["peak_bytes"]
                          for k in ("with_stats", "without_stats")}},
        "safe_rerun": plan["safe_rerun"],
    }


# ---------------------------------------------------------------------------
# phase 12: the serving open loop; phase 13: faults and the verifier
# ---------------------------------------------------------------------------

# benchmarks/bench_serving.py's workload at the main path's scale: 8 clients
# x 6 queries a client over 4 shapes, at most 8 in flight
SERVE_KEYS = 64
SERVE_CLIENTS = 8
SERVE_QUERIES_PER_CLIENT = 6
SERVE_IN_FLIGHT = 8
SERVE_MODES = (("cold_sequential", "sequential"),
               ("warm_sequential", "sequential"), ("warm_async", "async"))
# the kernels every serving phase must launch: the hash shuffles' partition
# entry and histogram, groupby's reductions and its two-phase combine's sort
SERVING_KERNELS = ("hash32_partition", "bucket_histogram",
                   "segment_reduce_tiles", "bitonic_sort_permutation")
# rows a shard in phase 13's fault cases: faults are control flow
FAULT_ROWS = 1 << 16


def serving_tables(ctx: DistContext, rows: int, device, seed: int = 42):
    """``orders`` (8 shards of ``rows``: ``k`` int32 over [0, 64), ``d0``
    integer-valued float32 over [-50, 50), ``d1`` int32 over [0, 1000); 12 B
    a row) and ``dims`` (64 rows: ``k`` 0..63, ``w`` integer-valued float32
    over [0, 9)), as benchmarks/bench_serving.py draws them."""
    rng = np.random.default_rng(seed)
    parts = [Table.from_numpy({
        "k": rng.integers(0, SERVE_KEYS, rows).astype(np.int32),
        "d0": rng.integers(-50, 50, rows).astype(np.float32),
        "d1": rng.integers(0, 1000, rows).astype(np.int32)}, device=device)
        for _ in range(P)]
    dims = Table.from_numpy({
        "k": np.arange(SERVE_KEYS, dtype=np.int32),
        "w": rng.integers(0, 9, SERVE_KEYS).astype(np.float32)}, device=device)
    return ctx.from_local_parts(parts), dims


def serving_workload():
    """The four query shapes; ``sel``'s lambda is re-created on every call
    and must hit the plan cache through its content key."""
    return [
        ("gb", lambda s: s.frame("orders")
            .groupby("k", (("d0", "sum"), ("d0", "count")))),
        ("topn", lambda s: s.frame("orders").sort("k").limit(32)),
        ("sel", lambda s: s.frame("orders")
            .select(lambda c: c["d0"] > 0.0)
            .groupby("k", (("d0", "mean"),))),
        ("join", lambda s: s.frame("orders").join(s.frame("dims"), "k")
            .groupby("k", (("w", "sum"),))),
    ]


def same_rows(name: str, got, want) -> None:
    """Bitwise equality of two results' valid rows, in shard order (each a
    DistTable or a collapsed Table)."""
    a, b = (t.to_table().columns if isinstance(t, DistTable) else t.columns
            for t in (got, want))
    check(sorted(a) == sorted(b), f"{name}: columns {sorted(a)} vs {sorted(b)}")
    for n in b:
        check(torch.equal(_bits(a[n]), _bits(b[n])), f"{name}: column {n} differs")


def count_syncs(call) -> tuple[object, int]:
    """(result, host synchronisations the call made), counted by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings (not the notice
    the first call of the mode in a process gives, that the mode is a
    prototype)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return res, sum("synchroniz" in str(w.message) and
                    "prototype" not in str(w.message) for w in seen)


def phase_serving(ctx: DistContext, dev, rows: int, profile=None) -> dict:
    """The serving open loop (phase 12): ``ServingSession.run_open_loop``
    over :func:`serving_workload` on ``orders`` and ``dims`` (both
    registered with ``analyze=True``), three phases: cold sequential, warm
    sequential, warm async. Checks: every query's rows equal across the
    phases and to the same frame collected under ``oracle_scope()``; the
    cold phase prepares each shape once (4 misses, plus one ``plan-safe``
    entry for each shape whose estimates overflowed), the warm phases none
    and recompile nothing; no query failed, degraded or was quarantined;
    each of ``SERVING_KERNELS`` launched in every phase, the same counts in
    both warm phases. Then the host synchronisations ``submit`` makes for
    one warm query of each shape, and, given ``profile`` (:func:`profiled`),
    one trace of a warm query of each shape."""
    from repro_torch.core.serving import ServingSession

    orders, dims = serving_tables(ctx, rows, dev)
    sess = ServingSession(ctx, max_in_flight=SERVE_IN_FLIGHT)
    sess.register("orders", orders, analyze=True)
    sess.register("dims", dims, analyze=True)
    del orders
    workload = serving_workload()
    out: dict = {"rows_per_shard": rows, "clients": SERVE_CLIENTS,
                 "queries_per_client": SERVE_QUERIES_PER_CLIENT,
                 "max_in_flight": SERVE_IN_FLIGHT}
    results = {}
    for name, mode in SERVE_MODES:
        (rep, res), n, peak = counted(lambda: sess.run_open_loop(
            workload, num_clients=SERVE_CLIENTS,
            queries_per_client=SERVE_QUERIES_PER_CLIENT, mode=mode))
        check(rep.failed == 0 and rep.degraded == 0 and rep.quarantines == 0,
              f"{name}: {rep.failed} failed, {rep.degraded} degraded, "
              f"{rep.quarantines} quarantined: {rep.errors}")
        check(all(n[k] > 0 for k in SERVING_KERNELS),
              f"{name}: launched {n}; a kernel of {SERVING_KERNELS} never ran")
        results[name] = [r.to_table() for r in res]
        out[name] = {**{k: v for k, v in rep.to_dict().items()
                        if k not in ("errors", "cache")},
                     "overflow_retries": rep._delta("overflow_retries"),
                     "peak_bytes": peak, "launches": n,
                     "shapes": rep.shapes}
        del res
    cold = out["cold_sequential"]
    check(cold["compiles"] == len(workload) + cold["overflow_retries"],
          f"cold phase prepared {cold['compiles']} plans, want "
          f"{len(workload)} + {cold['overflow_retries']} safe")
    for name in ("warm_sequential", "warm_async"):
        check(out[name]["compiles"] == 0 and out[name]["recompiles"] == 0,
              f"{name}: {out[name]['compiles']} prepared, "
              f"{out[name]['recompiles']} re-prepared on a warm cache")
        check(out[name]["overflow_retries"] == 0, f"{name}: overflow re-runs")
    check(out["warm_sequential"]["launches"] == out["warm_async"]["launches"],
          "warm phases launched different kernel counts: "
          f"{out['warm_sequential']['launches']} vs "
          f"{out['warm_async']['launches']}")
    if cold["overflow_retries"] == 0:
        check(cold["launches"] == out["warm_sequential"]["launches"],
              "the cold phase launched other kernel counts than the warm")
    shapes = cold["shapes"]
    oracle = {}
    for label, make in workload:
        with kops.oracle_scope():
            oracle[label] = make(sess).collect().to_table()
    for i, label in enumerate(shapes):
        for name, _ in SERVE_MODES:
            same_rows(f"{name} query {i} ({label}) vs oracle_scope()",
                      results[name][i], oracle[label])
    out["explain"] = {}
    for label, make in workload:
        text = make(sess).explain(verify=True)
        check(text.endswith("\nverification: clean"),
              f"serving shape {label}: verifier findings:\n{text}")
        out["explain"][label] = text
    syncs = {}
    for label, make in workload:
        fut, syncs[label] = count_syncs(lambda: sess.submit(make))
        fut.result()
    out["submit_host_syncs"] = syncs
    if profile is not None:
        out["profile"] = {label: profile(label, lambda m=make:
                                         sess.submit(m).result())
                          for label, make in workload}
    out["per_query_launches"] = {
        name: {k: out[name]["launches"][k] / len(shapes)
               for k in SERVING_KERNELS} for name, _ in SERVE_MODES}
    del results, oracle, sess
    return out


def say_serving(out: dict, card: str, secs: float) -> None:
    say(f"[12] serving open loop: {P} x {out['rows_per_shard']} rows of "
        f"orders, {out['clients']} clients x {out['queries_per_client']} "
        f"queries, at most {out['max_in_flight']} in flight; rows equal "
        f"across phases and to oracle_scope() ({secs:.1f} s)")
    for name, _ in SERVE_MODES:
        r = out[name]
        say(f"[12] {name}: {r['qps']:.2f} q/s, p50 {r['p50_ms']:.1f} ms, p99 "
            f"{r['p99_ms']:.1f} ms, {r['compiles']} prepared "
            f"({r['recompiles']} re-prepared), {r['overflow_retries']} overflow "
            f"re-runs, peak {r['peak_bytes'] / 2**30:.2f} GiB, launches "
            f"{r['launches']} on {card}")
    say(f"[12] host syncs at submit of one warm query: "
        f"{out['submit_host_syncs']}")
    for label, text in out["explain"].items():
        say(f"[12] {label} explain(verify=True):")
        for line in text.splitlines():
            say(f"      {line}")


def phase_faults(dev, rows: int) -> dict:
    """Each case of ``repro_torch.testing.chaos_cases`` at ``rows`` a shard
    (phase 13): the recovered rows equal the fault-free run's bit for bit,
    on the same shards in the same order, and the counters
    tests/test_chaos.py asserts hold, each shuffle fault fired once and the
    derated estimate fired (``chaos_cases.checks``).
    Then a real fault at a kernel seam (a RuntimeError, not a FaultError;
    or NaN the kernel writes while validation is on) propagates through
    ``result()`` and rides no rung."""
    from repro_torch.core import faults as FLT
    from repro_torch.testing import chaos_cases

    out = {name: case(rows=rows, device=dev)
           for name, case in chaos_cases.CASES.items()}
    for name, ok in chaos_cases.checks(out).items():
        check(ok, f"chaos case {name}: {out[name.split(':')[0]]}")

    # a real kernel fault is no FaultError: an error the kernel raises, or
    # NaN it writes while validation is on (armed faults that never fire
    # turn it on), fails the query and rides no rung
    from repro_torch.kernels import segment_reduce as seg

    real = seg.segment_reduce_tiles

    def broken(*a, **kw):
        raise RuntimeError("segment_reduce_tiles: launch failed")

    def nan_writer(values, seg_ids, num_segments, op="sum", **kw):
        if values.is_floating_point():
            return torch.full((num_segments,), float("nan"),
                              dtype=values.dtype, device=values.device)
        return ref.segment_reduce_ref(values, seg_ids, num_segments, op)

    for label, fake, want in (
            ("real_kernel_error", broken, "launch failed"),
            ("real_kernel_nan", nan_writer, "failed validation: NaN")):
        c = DistContext(num_shards=P, device=dev,
                        faults=[FLT.FaultPlan("kernel.dispatch", nth=99)])
        dt = c.scatter(chaos_cases._orders(rows, device=dev))
        seg.segment_reduce_tiles = fake
        try:
            fut = c.submit(PL.GroupBy(PL.Scan(0), ("k",), (("d0", "sum"),)),
                           [dt])
            try:
                fut.result()
                raised = None
            except RuntimeError as e:
                raised = str(e)
        finally:
            seg.segment_reduce_tiles = real
        cs = c.cache_stats()
        check(raised is not None and want in raised
              and cs["degraded_kernel"] == 0 and cs["quarantines"] == 0
              and cs["failed_queries"] == 1 and cs["fault_fires"] == 0,
              f"{label}: raised {raised!r}, {cs}")
        out[label] = {"raised": raised, "degraded_kernel": 0,
                      "quarantines": 0}
    return out


def phase_verify(ctx: DistContext, tabs, analyzed) -> dict:
    """The plan verifier at full width (phase 13): ``explain(verify=True)``
    of phase 11's frames shows no findings (phase 12 checks the serving
    shapes'), and ``audit_collectives`` of phase 11's frame pipeline (run
    once) counts the collectives its static accounting expects."""
    from repro_torch.core import verify as V

    b = tabs[1]
    a2, b2 = analyzed[:2]
    frames = {"pipeline": pipeline_frame(ctx, a2, b2),
              "groupby_with_stats": ctx.frame(b2).groupby("k", PLAN_AGGS),
              "groupby_without_stats": ctx.frame(b).groupby("k", PLAN_AGGS)}
    clean = {}
    for name, f in frames.items():
        text = f.explain(verify=True)
        check(text.endswith("\nverification: clean"),
              f"{name}: verifier findings:\n{text}")
        clean[name] = True
    audit = V.audit_collectives(frames["pipeline"])
    check(audit["matched"], f"audit_collectives: counted {audit['actual']}, "
          f"expected {audit['expected']}")
    return {"clean": clean, "audit": {"expected": audit["expected"],
                                      "actual": audit["actual"]}}


# ---------------------------------------------------------------------------
# phase 14: the relational token pipeline at llama3-8b's width
# ---------------------------------------------------------------------------

# llama3-8b's vocabulary and context and Llama 3's initial pre-training batch
# of 4M tokens (arXiv:2407.21783 section 3.4.1: 1024 sequences of 4096)
PIPE_SEQ, PIPE_BATCH = 4096, 1024
PIPE_STEPS = 8
# the kernels the pipeline must launch: the local hash join's key hash and
# the stats stage's reductions; at 8 shards also the join's two shuffles
PIPE_KERNELS = {1: ("hash32", "segment_reduce_tiles"),
                P: ("hash32", "segment_reduce_tiles", "hash32_partition",
                    "bucket_histogram")}


def pipeline_config(seq_len: int, batch: int):
    from repro_torch.data.pipeline import PipelineConfig

    return PipelineConfig(seq_len=seq_len, global_batch=batch,
                          vocab_size=get_config(LM_ARCH).vocab_size,
                          collect_stats=True)


def pipeline_oracle(cfg, raw_rows: int, step: int) -> dict:
    """What batch ``step`` must hold, from the host's own tables: every
    round's surviving rows (quality above the threshold and a label),
    their token bytes -> weight bits, how many rows each round gives the
    batch, and the consumed rounds' sources and qualities."""
    from repro_torch.data import synthetic as TS

    rounds, src, qual, got = [], [], [], 0
    for refill in range(cfg.max_refills):
        s = TS.lm_samples_table(raw_rows, cfg.seq_len, cfg.vocab_size,
                                seed=cfg.seed, step=step, shard=refill,
                                device="cpu").to_numpy()
        lab = TS.lm_labels_table(s["sample_id"], seed=cfg.seed, step=step,
                                 shard=refill, device="cpu").to_numpy()
        keep = (s["quality"] > cfg.quality_threshold) & \
            np.isin(s["sample_id"], lab["sample_id"])
        weight = dict(zip(lab["sample_id"].tolist(),
                          lab["weight"].view(np.int32).tolist()))
        rows = {t.tobytes(): weight[i] for t, i in
                zip(s["tokens"][keep], s["sample_id"][keep].tolist())}
        take = min(len(rows), cfg.global_batch, cfg.global_batch - got)
        rounds.append((rows, take))
        src.append(s["source"])
        qual.append(s["quality"])
        got += take
        if got >= cfg.global_batch:
            break
    return {"rounds": rounds, "source": np.concatenate(src),
            "quality": np.concatenate(qual), "rows": got}


def check_pipeline_batch(name: str, batch: dict, cfg, oracle: dict) -> None:
    """Shapes, dtypes and token range; each round's rows in the batch are
    that round's survivors with their label's weight, no survivor twice;
    the wrap-pad repeats the rows before it."""
    b, s = cfg.global_batch, cfg.seq_len
    check(batch["tokens"].shape == (b, s) and batch["tokens"].dtype == np.int32
          and batch["weight"].shape == (b,)
          and batch["weight"].dtype == np.float32,
          f"{name}: shapes {batch['tokens'].shape} {batch['tokens'].dtype}, "
          f"{batch['weight'].shape} {batch['weight'].dtype}")
    check(int(batch["tokens"].min()) >= 1
          and int(batch["tokens"].max()) < cfg.vocab_size,
          f"{name}: tokens outside [1, {cfg.vocab_size})")
    w = batch["weight"].view(np.int32)
    at = 0
    for rows, take in oracle["rounds"]:
        for i in range(at, at + take):
            check(rows.get(batch["tokens"][i].tobytes()) == w[i],
                  f"{name}: row {i} is no survivor of its round, or its "
                  "weight is not its label's")
        at += take
    check(len({t.tobytes() for t in batch["tokens"][:at]}) == at,
          f"{name}: a survivor appears twice before the wrap-pad")
    if at < b:
        reps = -(-b // max(at, 1))
        check(np.array_equal(batch["tokens"][at:],
                             np.tile(batch["tokens"][:at], (reps, 1))[:b - at]),
              f"{name}: the wrap-pad does not repeat the rows before it")


# a mean or variance of the stats stage against another summation order (a
# float64 oracle, the plain run): tests/test_torch_pipeline.py's bound
def stats_bounds(stats: dict) -> dict[str, np.ndarray]:
    n = stats["quality_count"].astype(np.float64)
    mean = stats["quality_mean"].astype(np.float64)
    var = stats["quality_var"].astype(np.float64)
    u = 2.0 ** -24
    return {"quality_mean": u * (2 * n + 2) * mean,
            "quality_var": u * (6 * n + 4) * (mean ** 2 + var)}


def check_pipeline_stats(name: str, got: dict, want: dict) -> float:
    """Sources, counts, minima and maxima bit for bit; means and variances
    within :func:`stats_bounds`. Returns the largest mean/var difference."""
    for k in ("source", "quality_count", "quality_min", "quality_max"):
        check(np.array_equal(got[k], want[k]), f"{name}: stats {k} differ")
    worst = 0.0
    for k, bound in stats_bounds(want).items():
        diff = np.abs(got[k].astype(np.float64) - want[k])
        check(bool((diff <= bound).all()),
              f"{name}: stats {k} off by {diff.max():.3g} (bound "
              f"{bound.max():.3g})")
        worst = max(worst, float(diff.max()))
    return worst


def stats_oracle(oracle: dict) -> dict:
    """The stats stage over the consumed rounds, in float64 on the host."""
    src, q = oracle["source"], oracle["quality"].astype(np.float64)
    keys = np.unique(src)
    return {"source": keys.astype(np.int32),
            "quality_count": np.array([(src == k).sum() for k in keys],
                                      np.int32),
            "quality_mean": np.array([q[src == k].mean() for k in keys]),
            "quality_var": np.array([q[src == k].var() for k in keys]),
            "quality_min": np.array([q[src == k].min() for k in keys],
                                    np.float32),
            "quality_max": np.array([q[src == k].max() for k in keys],
                                    np.float32)}


def phase_pipeline(dev, shards: int, seq_len: int = PIPE_SEQ,
                   batch: int = PIPE_BATCH, steps: int = PIPE_STEPS,
                   profile=None) -> dict:
    """The relational token pipeline (phase 14) at ``shards`` shards: its
    batches and stats against the host oracles (:func:`pipeline_oracle`),
    ``global_batch(0)`` twice equal and ``global_batch(1)`` different, the
    plain run (``oracle_scope()``) equal, no plan prepared after step 0,
    then ``steps`` batches timed, the host syncs, bytes and launches of one
    batch, ``Prefetcher(depth=2)`` over the same steps and, given
    ``profile`` (:func:`profiled`), one trace of a batch."""
    from repro_torch.data.pipeline import Prefetcher, RelationalTokenPipeline

    cfg = pipeline_config(seq_len, batch)
    ctx = None if shards == 1 else DistContext(num_shards=shards, device=dev)
    pipe = RelationalTokenPipeline(cfg, ctx, device=dev)
    name = f"pipeline at {shards} shard{'s' * (shards > 1)}"
    rounds, round_ms = [], []
    real_round = pipe._round

    def counted_round(step, refill):
        # the bytes each round uploads, and the host's time to draw them
        # and copy them from pageable memory (which returns when done)
        t0 = time.perf_counter()
        tabs = real_round(step, refill)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        rounds.append(sum(v.nbytes for t in tabs for v in t.columns.values()))
        return tabs

    pipe._round = counted_round
    b0, first, first_peak = counted(lambda: pipe.global_batch(0))
    stats0 = pipe.last_stats
    prepared = pipe._ctx.cache_stats()["misses"]
    oracle = pipeline_oracle(cfg, pipe._raw_rows, 0)
    check_pipeline_batch(name, b0, cfg, oracle)
    stats_err = check_pipeline_stats(f"{name} vs the float64 oracle", stats0,
                                     stats_oracle(oracle))
    again = pipe.global_batch(0)
    check(all(np.array_equal(again[k], b0[k]) for k in b0),
          f"{name}: global_batch(0) twice differs")
    b1 = pipe.global_batch(1)
    check(not np.array_equal(b1["tokens"], b0["tokens"]),
          f"{name}: global_batch(1) equals global_batch(0)")
    check_pipeline_batch(f"{name} step 1", b1, cfg,
                         pipeline_oracle(cfg, pipe._raw_rows, 1))
    with kops.oracle_scope():
        plain = pipe.global_batch(0)
    plain_stats = pipe.last_stats
    check(all(np.array_equal(plain[k].view(np.int32), b0[k].view(np.int32))
              for k in b0), f"{name}: the plain run's batch differs")
    plain_err = check_pipeline_stats(f"{name} vs the plain run", stats0,
                                     plain_stats)
    del again, b1, plain
    walls, direct = [], [b0]
    round_ms.clear()
    for step in range(1, steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct.append(pipe.global_batch(step))
        walls.append((time.perf_counter() - t0) * 1e3)
    check(pipe._ctx.cache_stats()["misses"] == prepared,
          f"{name}: {pipe._ctx.cache_stats()['misses'] - prepared} plans "
          "prepared after step 0")
    draw_ms = statistics.median(round_ms)
    rounds.clear()
    read_back = []
    real_to_numpy = Table.to_numpy

    def counted_to_numpy(self):
        # the bytes a batch reads back: each round's rows and the stats
        cols = real_to_numpy(self)
        read_back.append(sum(v.nbytes for v in cols.values()))
        return cols

    Table.to_numpy = counted_to_numpy
    try:
        _, n, peak = counted(lambda: pipe.global_batch(steps + 1))
    finally:
        Table.to_numpy = real_to_numpy
    n_rounds, uploaded, read_back = len(rounds), sum(rounds), sum(read_back)
    for k in PIPE_KERNELS[shards]:
        check(n[k] > 0, f"{name}: {k} never launched ({n})")
    _, syncs = count_syncs(lambda: pipe.global_batch(steps + 1))
    t0 = time.perf_counter()
    # a finite source: the thread ends with the last batch, so no batch of
    # it runs on under the profile or the next shard count's measurements
    pf = list(Prefetcher(itertools.islice(pipe, steps), depth=2))
    prefetch_s = time.perf_counter() - t0
    for step, got in enumerate(pf):
        check(all(np.array_equal(got[k], direct[step][k]) for k in got),
              f"{name}: the Prefetcher's batch {step} differs")
    del pf, direct
    med = statistics.median(walls)
    out = {"shards": shards, "seq_len": seq_len, "global_batch": batch,
           "vocab_size": cfg.vocab_size, "raw_rows": pipe._raw_rows,
           "median_ms": med, "batch_ms": walls, "round_draw_ms": draw_ms,
           "tokens_per_s": batch * seq_len / (med / 1e3),
           "rounds_per_batch": n_rounds, "host_syncs": syncs,
           "uploaded_bytes": uploaded, "read_back_bytes": read_back,
           "launches": n, "first_batch_launches": first,
           "plans_prepared": prepared,
           "plans_prepared_after_step_0": pipe._ctx.cache_stats()["misses"]
           - prepared, "peak_bytes": peak, "first_peak_bytes": first_peak,
           "prefetch_s": prefetch_s, "stats_err_vs_float64": stats_err,
           "stats_err_vs_plain": plain_err}
    if profile is not None:
        pr = profile(name, lambda: pipe.global_batch(steps + 2))
        out["profile"] = pr
    return out


def say_pipeline(r: dict, card: str) -> None:
    say(f"[14] pipeline at {r['shards']} shard(s), seq {r['seq_len']}, batch "
        f"{r['global_batch']}, vocab {r['vocab_size']} ({r['raw_rows']} sample "
        f"rows a round): median {r['median_ms']:.1f} ms a batch over "
        f"{len(r['batch_ms'])} steps, {r['tokens_per_s'] / 1e6:.2f} M tokens/s "
        f"assembled (a round's tables drawn and uploaded in "
        f"{r['round_draw_ms']:.1f} ms); {r['rounds_per_batch']} round(s) a batch, "
        f"{r['host_syncs']} host syncs, {r['uploaded_bytes'] / 2**20:.2f} MiB "
        f"uploaded, {r['read_back_bytes'] / 2**20:.2f} MiB read back; "
        f"launches {r['launches']}; {r['plans_prepared']} plan(s) prepared by "
        f"step 0, {r['plans_prepared_after_step_0']} after; peak "
        f"{r['peak_bytes'] / 2**30:.2f} GiB; Prefetcher(depth=2) "
        f"{len(r['batch_ms'])} batches in {r['prefetch_s']:.2f} s; stats within "
        f"{r['stats_err_vs_float64']:.3g} of float64, {r['stats_err_vs_plain']:.3g}"
        f" of the plain run; on {card}")
    pr = r.get("profile")
    if pr:
        say(f"[14] profiled batch: wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.2f} ms, busy share {pr['busy_share']:.2f}, "
            f"ported kernels {pr['ported_kernels_ms']:.3f} ms, "
            f"{pr['host_ops']} torch ops dispatched by the host")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.3f} ms  {kname[:110]}")


# ---------------------------------------------------------------------------
# phase 15: the test harnesses on the card
# ---------------------------------------------------------------------------

FUZZ_PLANS, FUZZ_SEED = 100, 20260807  # the reference CI leg's seed


def phase_harnesses(dev, plans: int = FUZZ_PLANS) -> dict:
    """The port's test harnesses on the card (phase 15): ``run_fuzz`` over
    ``plans`` seeded plans at 8 shards (verifier-clean, fused equal to the
    eager oracle, with ``REPRO_VERIFY_PLANS`` on), and each relational case
    of ``repro_torch.testing.dist_cases`` once, held to its own oracle
    checks (``dist_cases.checks``, what tests/test_dist.py asserts)."""
    from repro_torch.core import verify as V
    from repro_torch.testing import dist_cases, plan_fuzz

    # the verifier's counters are the process's: count the fuzz's own runs
    before = V.counter_snapshot()
    t0 = time.perf_counter()
    fuzz = plan_fuzz.run_fuzz(plans, FUZZ_SEED, num_shards=P, device=dev)
    fuzz["seconds"] = time.perf_counter() - t0
    fuzz["verify"] = {k: n - before[k] for k, n in fuzz["verify"].items()}
    check(fuzz["plans"] == plans and fuzz["verify"]["verify_findings"] == 0,
          f"plan fuzz: {fuzz}")
    cases, secs = {}, {}
    for name, case in dist_cases.CASES.items():
        t0 = time.perf_counter()
        cases[name] = case(device=dev)
        secs[name] = time.perf_counter() - t0
    for name, ok in dist_cases.checks(cases).items():
        check(ok, f"dist case {name}: {cases[name.split(':')[0]]}")
    return {"fuzz": fuzz, "dist_cases_seconds": secs,
            "dist_cases": {k: cases[k] for k in (
                "plan_fused", "cost_groupby", "flash_decode_shard",
                "compress_pod", "elastic_restore")}}


def _plain(call):
    with kops.oracle_scope():
        return call()


# ---------------------------------------------------------------------------
# phase 7: per-kernel times at the path's shapes
# ---------------------------------------------------------------------------


def phase_timing(dev, rows: int) -> dict[str, dict]:
    timer = Timer(dev)
    rng = np.random.default_rng(11)
    out = {}

    # hash32: one shard's int32 key column (hash_partition)
    x = torch.from_numpy(rng.integers(0, P * rows, rows).astype(np.int32)).to(dev)
    ms = timer(lambda: hash32(x, 7))
    plain = timer(lambda: ref.hash32_ref(x, 7))
    # the function's bytes: a 4-byte value in and a u32 hash out a row (the
    # port's int64 holder writes 4 B more; that is the port's cost, not the
    # bound's)
    bms, by = bound_ms(rows * (4 + 4), rows * 10)
    out["hash32"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=None, max_abs_err=float(
                             (hash32(x, 7) - ref.hash32_ref(x, 7)).abs().max()))

    # hash32_partition: the same shard's destinations, P = 8, the last 1/16
    # of the rows past row_count (no PyTorch call computes a hash)
    rc = torch.tensor(rows - rows // 16, dtype=torch.int32, device=dev)
    valid = torch.arange(rows, device=dev) < rc
    ms = timer(lambda: hash32_partition([x], rc, P, 7))
    plain = timer(lambda: ref.hash_partition_ids_ref([x], rc, P, 7))

    def chain():  # the parent's hash_partition up to the histogram
        h = kops.hash_columns([x], seed=7)
        pid = (h % P).to(torch.int32)
        return torch.where(torch.arange(rows, device=dev) < rc, pid, -1)

    chain_ms = timer(chain)
    # a 4-byte key in and a 4-byte pid out a row (and the count); fmix32,
    # the row test and the modulus are ~15 integer operations a row
    bms, by = bound_ms(rows * (4 + 4) + 4, rows * 15)
    got = hash32_partition([x], rc, P, 7)
    check(torch.equal(got, chain()) and bool((got[~valid] == -1).all()),
          "hash32_partition differs from the chain it replaces")
    out["hash32_partition"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=float((got - ref.hash_partition_ids_ref([x], rc, P, 7))
                          .abs().max()),
        replaced_chain_ms=chain_ms)

    # bucket_histogram: one shard's destinations, P = 8, -1 on invalid rows
    ids = torch.from_numpy(rng.integers(0, P, rows).astype(np.int32)).to(dev)
    ids[rows - rows // 16:] = -1
    shifted = ids + 1
    ms = timer(lambda: bucket_histogram(ids, P))
    plain = timer(lambda: ref.histogram_ref(ids, P))
    lib = timer(lambda: torch.bincount(shifted, minlength=P + 1))
    bms, by = bound_ms(rows * 4 + P * 4, rows * 3)
    # what the Timer reads for a one-element kernel (its floor), and for a
    # copy of the same 16 MiB column
    one = torch.zeros(1, device=dev)
    floor_ms = timer(lambda: one.add_(1))
    copy_ms = timer(lambda: ids.clone())
    out["bucket_histogram"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float((bucket_histogram(ids, P)
                           - ref.histogram_ref(ids, P)).abs().max()),
        floor_ms=floor_ms, copy_ms=copy_ms)

    # bitonic: the two-phase combine's one 2048-pair tile of u32 keys
    tile = 2048
    probe = latency_probe(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = torch.from_numpy(rng.integers(0, 1000, tile).astype(np.int64)).to(dev)
    pay = torch.arange(tile, dtype=torch.int32, device=dev)
    ms = timer(lambda: bitonic_sort_tiles(keys, pay, tile=tile))
    plain = timer(lambda: ref.sort_tiles_ref(keys, pay, tile))
    lib = timer(lambda: torch.sort(keys.view(1, tile), dim=1, stable=True))
    # u32 key + int32 payload a pair, read once and written once (the
    # port's int64 key holder moves 4 B more a pair each way)
    bms, by = bitonic_bound(2 * tile * (4 + 4), tile, probe, sms)
    ko, vo = bitonic_sort_tiles(keys, pay, tile=tile)
    rk, rv = ref.sort_tiles_ref(keys, pay, tile)
    out["bitonic_sort_tiles"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float(max((ko - rk).abs().max(), (vo - rv).abs().max())),
        probe=probe, sms=sms)

    # bitonic_sort_permutation: the combine's sort, one shard's 2048 partial
    # rows (8 senders x bucket 256) of int32 keys over [0, 1000), ~1000 valid
    kc = torch.from_numpy(rng.integers(0, 1000, tile).astype(np.int32)).to(dev)
    rc = torch.tensor(1000, dtype=torch.int32, device=dev)
    ms = timer(lambda: bitonic_sort_permutation(kc, rc))
    plain = timer(lambda: ref.sort_permutation_ref(kc, rc))

    def chain():  # the parent's bitonic branch of sort_permutation
        ku = L.ordered_u32(kc)
        ku = torch.where(~(torch.arange(tile, device=dev) < rc), L.U32_MAX, ku)
        iota = torch.arange(tile, dtype=torch.int32, device=dev)
        return kops.sort_pairs(ku, iota)[1].to(torch.int64)

    chain_ms = timer(chain)
    lib = timer(lambda: torch.sort(kc, stable=True))
    # a 4-byte key in, an 8-byte index out a row, and the count
    bms, by = bitonic_bound(tile * (4 + 8) + 4, tile, probe, sms)
    got = bitonic_sort_permutation(kc, rc)
    check(torch.equal(got, chain()),
          "bitonic_sort_permutation differs from the chain it replaces")
    out["bitonic_sort_permutation"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float((got - ref.sort_permutation_ref(kc, rc)).abs().max()),
        replaced_chain_ms=chain_ms)

    # segment_reduce: groupby shuffle's f32 sum, G = n = 8 shards * 2 * rows
    # / 8 (one shard's received capacity), ~125 sorted groups, -1 tail
    n = 2 * rows
    groups = 125
    valid = n // 2
    seg = np.full(n, -1, np.int32)
    seg[:valid] = np.sort(rng.integers(0, groups, valid)).astype(np.int32)
    seg_t = torch.from_numpy(seg).to(dev)
    vals = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    idx = torch.where(seg_t >= 0, seg_t, n).to(torch.int64)
    base = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    ms = timer(lambda: segment_reduce_tiles(vals, seg_t, n, "sum",
                                            contiguous_runs=True))
    plain = timer(lambda: ref.segment_reduce_ref(vals, seg_t, n, "sum"))
    lib = timer(lambda: torch.scatter_reduce(base, 0, idx, vals, "sum"))
    bms, by = bound_ms(n * 8 + n * 4, n)
    err = (segment_reduce_tiles(vals, seg_t, n, "sum", contiguous_runs=True)
           - ref.segment_reduce_ref(vals, seg_t, n, "sum")).abs().max()
    out["segment_reduce_tiles"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float(err))

    # segment_reduce@f64: groupby.q5's final, the float64 sum over a worker's
    # received slots, 4% rows in groups of ~8, a -1 tail; G = n. The bound
    # reads every id, the in-range rows' values and writes every segment
    # once (the benchmark's segment_reduce_roofline counts the same bytes)
    seg_t, vals = seg_final_layout(dev, rng, n)
    idx = torch.where(seg_t >= 0, seg_t, n).to(torch.int64)
    base = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    ms = timer(lambda: segment_reduce_tiles(vals, seg_t, n, "sum",
                                            contiguous_runs=True))
    plain = timer(lambda: ref.segment_reduce_ref(vals, seg_t, n, "sum"))
    lib = timer(lambda: torch.scatter_reduce(base, 0, idx, vals, "sum"))
    in_range = int((seg_t >= 0).sum())
    bms, by = bound_ms(n * 4 + in_range * 8 + n * 8, in_range)
    err = (segment_reduce_tiles(vals, seg_t, n, "sum", contiguous_runs=True)
           - ref.segment_reduce_ref(vals, seg_t, n, "sum")).abs().max()
    out["segment_reduce_tiles@f64"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float(err))

    # segment_scan: one shard's window input, P x the range bucket (2**21)
    # = 2**24 slots, int32 values (dense_rank's run starts), ids sorted over
    # ~2 groups on the first 2**22 rows, then the -1 tail
    n = P * (4 * rows // P)
    valid = rows
    seg = np.full(n, -1, np.int32)
    seg[:valid] = np.sort(rng.integers(0, 2, valid)).astype(np.int32)
    seg_t = torch.from_numpy(seg).to(dev)
    vals = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
    ms = timer(lambda: segment_scan_tiles(vals, seg_t, "sum"))
    plain = timer(lambda: ref.segment_scan_ref(vals, seg_t, "sum"))
    # no single PyTorch call computes a segmented scan; torch.cumsum of the
    # same column is an unsegmented scan over the same bytes
    cumsum_ms = timer(lambda: torch.cumsum(vals, 0, dtype=torch.int32))
    bms, by = bound_ms(n * (4 + 4 + 4), n)
    err = (segment_scan_tiles(vals, seg_t, "sum")
           - ref.segment_scan_ref(vals, seg_t, "sum")).abs().max()
    out["segment_scan_tiles"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=float(err), cumsum_ms=cumsum_ms, n=n)

    # flash_attention: one layer of the serving path's prefill, llama3-8b's
    # heads over 4 x 1024 tokens, bf16, causal; the training entries at one
    # microbatch of phase 16's path
    cfg = get_config(LM_ARCH)
    out["flash_attention"] = flash_fwd_timing(
        dev, timer, LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    cfg = get_config(TRAIN_ARCH)
    out.update(flash_train_timing(
        dev, timer, TRAIN_BATCH // train_microbatches(TRAIN_ARCH), TRAIN_SEQ,
        cfg.num_heads, cfg.num_kv_heads, cfg.hd))
    out.update(flash_dims_timing(dev, timer))
    out.update(moe_timing(dev, timer, rng))
    out.update(mla_timing(dev, timer))
    out.update(hybrid_vlm_timing(dev, timer))
    out.update(whisper_timing(dev, timer))
    return out


def whisper_timing(dev, timer) -> dict[str, dict]:
    """The flash entries non-causal, at phase 24's shapes: whisper-base's
    encoder (or cross) layer at a prefill (B 4, S 1024, 8/8 heads of 64;
    ``flash_attention@whisper``) and its training entries at its one
    microbatch of the training path (B 8; ``flash_attention_lse@whisper``,
    ``flash_attention_bwd@whisper``), every (query, key) pair computed.
    Beside SDPA, as every flash row."""
    cfg = get_config(WHISPER_ARCH)
    out = {"flash_attention@whisper": flash_fwd_timing(
        dev, timer, LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads,
        cfg.hd, causal=False)}
    train = flash_train_timing(
        dev, timer, TRAIN_BATCH // train_microbatches(WHISPER_ARCH), TRAIN_SEQ,
        cfg.num_heads, cfg.num_kv_heads, cfg.hd, causal=False)
    out.update({f"{k}@whisper": v for k, v in train.items()})
    return out


def hybrid_vlm_timing(dev, timer) -> dict[str, dict]:
    """The flash entries at phases 21-22's shapes: zamba2-1.2b's shared
    block at a prefill (B 4, S 1024, 32/32 heads of 64, group size 1;
    ``flash_attention@zamba``) and its training entries at one microbatch
    of its training path (B 2; ``flash_attention_lse@zamba``,
    ``flash_attention_bwd@zamba``); internvl2-76b's prefill layer (B 4, S
    256 front + 1024 text, 64/8 heads of 128, group size 8;
    ``flash_attention@g8``). Beside SDPA, as every flash row."""
    cfg = get_config(HYBRID_ARCH)
    out = {"flash_attention@zamba": flash_fwd_timing(
        dev, timer, LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads,
        cfg.hd)}
    train = flash_train_timing(
        dev, timer, TRAIN_BATCH // train_microbatches(HYBRID_ARCH), TRAIN_SEQ,
        cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    out.update({f"{k}@zamba": v for k, v in train.items()})
    vlm = get_config(VLM_ARCH)
    out["flash_attention@g8"] = flash_fwd_timing(
        dev, timer, LM_BATCH, vlm.num_frontend_tokens + LM_PROMPT,
        vlm.num_heads, vlm.num_kv_heads, vlm.hd)
    return out


def mla_timing(dev, timer) -> dict[str, dict]:
    """The MLA instances (q k width 96, p v width 64) at phase 20's shapes:
    the serving entry at a minicpm3-4b prefill layer (B 4, S 1024, 40/40
    heads; ``flash_attention@mla``), the training entries at one
    microbatch of its training path (B 1; ``flash_attention_lse@mla``,
    ``flash_attention_bwd@mla``). The library is SDPA on the same inputs,
    through whichever backend takes unequal widths (named)."""
    cfg = get_config(MLA_ARCH)
    dqk, dv = attn_widths(cfg)
    out = {"flash_attention@mla": flash_fwd_timing(
        dev, timer, LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads, dqk,
        dv)}
    train = flash_train_timing(
        dev, timer, TRAIN_BATCH // train_microbatches(MLA_ARCH), TRAIN_SEQ,
        cfg.num_heads, cfg.num_kv_heads, dqk, dv)
    out.update({f"{k}@mla": v for k, v in train.items()})
    return out


def moe_timing(dev, timer, rng) -> dict[str, dict]:
    """The kernels at phase 19's shapes: bucket_histogram over qwen2-moe-
    a2.7b's prefill dispatch (4 x 1024 tokens x top-4 expert ids over P 60;
    ``bucket_histogram@moe``) beside ``torch.bincount``, and flash at its
    prefill layer (B 4, S 1024, 16/16 heads of 128, group size 1;
    ``flash_attention@g1``) and at dbrx-132b's (48/8 heads, group size 6;
    ``flash_attention@g6``) beside SDPA."""
    cfg = get_config(MOE_ARCH)
    p, n = cfg.moe_num_experts, LM_BATCH * LM_PROMPT * cfg.moe_top_k
    ids = torch.from_numpy(rng.integers(0, p, n).astype(np.int32)).to(dev)
    ms = timer(lambda: bucket_histogram(ids, p))
    plain = timer(lambda: ref.histogram_ref(ids, p))
    lib = timer(lambda: torch.bincount(ids, minlength=p))
    bms, by = bound_ms(n * 4 + p * 4, n * 3)
    out = {"bucket_histogram@moe": dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=float((bucket_histogram(ids, p)
                           - ref.histogram_ref(ids, p)).abs().max()),
        shape=dict(P=p, n=n))}
    out["flash_attention@g1"] = flash_fwd_timing(
        dev, timer, LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    big = get_config(MOE_BIG_ARCH)
    out["flash_attention@g6"] = flash_fwd_timing(
        dev, timer, LM_BATCH, LM_PROMPT, big.num_heads, big.num_kv_heads, big.hd)
    return out


def flash_dims_timing(dev, timer) -> dict[str, dict]:
    """The other head dims' instances, named ``<entry>@hd<dim>``: hd 160
    at a prefill layer of phase 17's stablelm-12b (B 4, S 1024, H 32, KV 8)
    and its training entries at one microbatch of its training path (B 1);
    hd 16 (the TINY configs', phase 18) at B 4, S 1024, H 32, KV 8, every
    entry. Bounds and library calls as for hd 64 and 128."""
    out = {}
    cfg = get_config(BIG_ARCH)
    out["flash_attention@hd160"] = flash_fwd_timing(
        dev, timer, LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    train = flash_train_timing(
        dev, timer, TRAIN_BATCH // train_microbatches(BIG_ARCH), TRAIN_SEQ,
        cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    out.update({f"{k}@hd160": v for k, v in train.items()})
    b, s, h, kv, hd = LM_BATCH, LM_PROMPT, 32, 8, 16
    out["flash_attention@hd16"] = flash_fwd_timing(dev, timer, b, s, h, kv, hd)
    train = flash_train_timing(dev, timer, b, s, h, kv, hd)
    out.update({f"{k}@hd16": v for k, v in train.items()})
    return out


def library_call(fn):
    """(fn's result, None), or (None, the library's error) where it refuses
    the inputs (a head dim its kernels lack)."""
    try:
        return fn(), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


# SDPA's backends, by the aten op each dispatches to
SDPA_BACKENDS = (("flash", "_scaled_dot_product_flash_attention"),
                 ("cudnn", "_scaled_dot_product_cudnn_attention"),
                 ("efficient", "_scaled_dot_product_efficient_attention"),
                 ("math", "_scaled_dot_product_attention_math"))


def sdpa_backend(call) -> str:
    """The backend an SDPA call picked: the aten op a CPU-side trace of one
    call shows."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    names = [e.key for e in prof.key_averages()]
    return next((label for label, op in SDPA_BACKENDS
                 if any(op in n for n in names)), "unknown")


def attn_pairs(s: int, causal: bool) -> float:
    """The (query, key) pairs a head of self-attention over s rows
    computes: s (s + 1) / 2 unmasked ones where causal, s^2 where not."""
    return s * (s + 1) / 2 if causal else float(s * s)


def flash_fwd_timing(dev, timer, b, s, h, kv, hd, dv=None,
                     causal: bool = True) -> dict:
    """The serving entry at (B, S, H, KV, hd) (v ``dv`` wide, hd unless
    given), bf16, causal or not, beside its plain version and
    ``F.scaled_dot_product_attention`` (``library_ms``, the backend it
    picked; ``None`` and ``library_error`` where it refuses the widths)."""
    dv = hd if dv is None else dv
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, dv)))
    ms = timer(lambda: flash_attention(q, k, v, causal=causal))
    plain = timer(lambda: ref.attention_ref(q, k, v, causal=causal))
    # the port never calls SDPA: it is timed here as the yardstick
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    # q, k, v read once and out written once; the products of the unmasked
    # (query, key) pairs: 2 hd for q k and 2 dv for p v each, on the bf16
    # tensor cores
    bms, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + b * s * h * dv),
                       2 * b * h * (hd + dv) * attn_pairs(s, causal),
                       TENSOR_BF16_OPS_PER_S)
    want = ref.attention_ref(q, k, v, causal=causal)
    lib_out, lib_error = library_call(lib_fwd)
    res = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None if lib_out is None else timer(lib_fwd),
        library_backend=None if lib_out is None else sdpa_backend(lib_fwd),
        max_abs_err=float((flash_attention(q, k, v, causal=causal)
                           - want).float().abs().max()),
        library_max_abs_err=None if lib_out is None else float(
            (lib_out.transpose(1, 2) - want).float().abs().max()),
        shape=dict(B=b, S=s, H=h, KV=kv, hd=hd, dv=dv, causal=causal))
    if lib_error is not None:
        res["library_error"] = lib_error
    return res


def flash_train_timing(dev, timer, b, s, h, kv, hd, dv=None,
                       causal: bool = True) -> dict[str, dict]:
    """The training entries at (B, S, H, KV, hd) (v ``dv`` wide, hd unless
    given), bf16, causal or not (for hd 64: one layer of one microbatch of
    granite-3-2b, B 2), each beside its plain version and beside the
    library. At equal widths that is the call SDPA's flash backend makes
    for the same function on the same (transposed, GQA) inputs:
    ``aten._scaled_dot_product_flash_attention``, which returns the output
    and the log-sum-exp, and ``_backward`` on that call's output and
    log-sum-exp, each one call timed directly (``None`` and
    ``library_error`` where the library refuses the head dim). The flash
    backend takes equal widths only, so at MLA's it is
    ``F.scaled_dot_product_attention`` on inputs that require grad (the
    forward that saves for its backward) and its autograd backward, through
    the backend SDPA picks (``library_backend``). The library's results
    must agree with the plain versions (``LIBRARY_SAME_FN``). Bounds: each
    input read and output written once; the forward's s(s+1)/2 products
    (s^2 where not causal; 2 hd + 2 dv FLOPs a pair) and the backward's
    five (q k^T again, dO v^T, P^T dO, dS^T q, dS k: 2 (3 hd + 2 dv) a
    pair, 2.5 times the forward's at equal widths), at 989 TFLOP/s."""
    dv = hd if dv is None else dv
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, dv),
                                 (b, s, h, dv)))
    shape = dict(B=b, S=s, H=h, KV=kv, hd=hd, dv=dv, causal=causal)
    pairs = b * h * attn_pairs(s, causal)
    fwd_ops = 2 * (hd + dv) * pairs
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel())  # q, k, v in, out
    lse_bytes = 4 * b * h * s
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    for _ in range(100):  # load the card before the first reading
        flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    ms = timer(lambda: flash_attention_lse(q, k, v, causal=causal))
    serving = timer(lambda: flash_attention(q, k, v, causal=causal))
    plain = timer(lambda: ref.attention_lse_ref(q, k, v, causal=causal))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    aten = torch.ops.aten
    sdpa = hd != dv  # the flash backend refuses unequal widths
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

    def lib_fwd():
        if sdpa:
            with torch.enable_grad():
                return (F.scaled_dot_product_attention(
                    *leaves, is_causal=causal, enable_gqa=True),)
        return aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0,
                                                        causal)

    bms, by = bound_ms(io + lse_bytes, fwd_ops, TENSOR_BF16_OPS_PER_S)
    want_out, want_lse = ref.attention_lse_ref(q, k, v, causal=causal)
    fwd, lib_error = library_call(lib_fwd)
    lib = lib_err = backend = None
    if fwd is not None:
        lib = timer(lib_fwd)
        backend = sdpa_backend(lib_fwd) if sdpa else "flash"
        lib_err = float((fwd[0].transpose(1, 2) - want_out).float().abs().max())
        if not sdpa:
            lib_err = max(lib_err, float((fwd[1][..., :s] - want_lse).abs().max()))
        check(lib_err <= LIBRARY_SAME_FN,
              f"the library's forward differs from the plain version "
              f"by {lib_err} at {shape}")
    res = {"flash_attention_lse": dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        library_backend=backend,
        max_abs_err=max(float((out - want_out).float().abs().max()),
                        float((lse - want_lse).abs().max())),
        serving_entry_ms=serving, library_max_abs_err=lib_err, shape=shape)}
    if lib_error is not None:
        res["flash_attention_lse"]["library_error"] = lib_error

    def lib_bwd():
        if sdpa:
            return torch.autograd.grad(fwd[0], leaves, dot, retain_graph=True)
        return aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, fwd[0], fwd[1], *fwd[2:6], 0.0, causal,
            *fwd[6:8])

    bwd = timer(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                            causal=causal))
    plain = timer(lambda: ref.attention_bwd_ref(q, k, v, do, causal=causal))
    # dq, dk, dv written; q, k, v, o, dO read (and lse, a row each)
    bwd_ops = 2 * (3 * hd + 2 * dv) * pairs
    bms, by = bound_ms(2 * (2 * q.numel() + 2 * do.numel() + 2 * k.numel()
                            + 2 * v.numel()) + lse_bytes, bwd_ops,
                       TENSOR_BF16_OPS_PER_S)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    want = ref.attention_bwd_ref(q, k, v, do, causal=causal)
    lib = lib_rel = None
    if fwd is not None:
        grads, lib_error = library_call(lib_bwd)
    if fwd is not None and grads is not None:
        lib = timer(lib_bwd)
        lib_rel = max(e["rel"] for e in bwd_errors(
            [x.transpose(1, 2) for x in grads], want, q.dtype).values())
        check(lib_rel <= LIBRARY_SAME_FN,
              f"the library's backward differs from the plain version "
              f"by {lib_rel} of a tile's norm at {shape}")
    # the launches' own device times, a call's mean over 10 (the Timer's
    # reading also holds the host's work between them)
    prof = profiled("flash_attention_bwd", lambda: [
        flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        for _ in range(10)])
    launch_ms = {}
    for kname, ms in prof["top"]:
        m = re.search(r"flash_bwd\w*(<[^>]*>)?", kname)
        if m:
            launch_ms[m.group(0)] = ms / 10
    res["flash_attention_bwd"] = dict(
        ms=bwd, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        library_backend=backend,
        launch_ms=launch_ms, device_ms=sum(launch_ms.values()),
        max_abs_err=max(float((a.float() - w.float()).abs().max())
                        for a, w in zip(got, want)),
        tile_rel_err=max(e["rel"] for e in bwd_errors(got, want,
                                                      q.dtype).values()),
        library_tile_rel_err=lib_rel,
        tflops=bwd_ops / (bwd * 1e-3) / 1e12, shape=shape,
        dkdv_splits=_build.library().repro_flash_attention_bwd_splits(
            b, s, h, kv, int(causal)))
    if lib_error is not None:
        res["flash_attention_bwd"]["library_error"] = lib_error
    return res


# ---------------------------------------------------------------------------
# phases 8-10: the serving path (llama3-8b), through the kernel and plain
# ---------------------------------------------------------------------------


def logit_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


@contextlib.contextmanager
def attention_as(fn):
    """Every model's self-attention seam (``kops.attention``) replaced by
    ``fn(q, k, v, causal=...)`` inside (the kernel's recompute under remat
    included)."""
    real = kops.attention
    kops.attention = fn
    try:
        yield real
    finally:
        kops.attention = real


def rounded_p_scope():
    """Attention as the plain version with the kernel's one extra rounding,
    P to bf16 before p v (``ref.attention_rounding_p``), on the card."""
    return attention_as(ref.attention_rounding_p)


def front_rows(cfg, embeds) -> int:
    """A VLM's front rows, which its cache and decode positions count (the
    encoder-decoder's embeds are audio frames: none)."""
    return 0 if embeds is None or cfg.family == "audio" else embeds.shape[1]


def enc_rows(cfg, embeds) -> int:
    """The encoder-decoder's cross-cache rows: its audio frames."""
    return embeds.shape[1] if cfg.family == "audio" else 0


def serve_inputs(cfg, dev):
    """The serving phases' prompts, seed 0, as the launcher draws them:
    (tokens, a VLM's front embeddings or None)."""
    return prompt_inputs(cfg, LM_BATCH, LM_PROMPT, 0, dev)


def phase_serve(dev, arch: str = LM_ARCH, layers: int | None = None):
    """Phase 8 (and 17, 20-22 for their archs): the model at full width
    and depth (or ``layers`` of it), and one ``generate`` through the
    kernel, the counts zeroed just before and read just after; then one
    more decode step, which must launch nothing. A VLM's prompts carry the
    launcher's random front embeddings (``serve_inputs``), whose rows the
    cache and the decode positions count. Returns (model, tokens, the
    generation, counts, peak bytes, init seconds, parameters)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tokens, embeds = serve_inputs(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    gen = generate(model, tokens, LM_GEN, embeds=embeds, keep_logits=True)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] == attn_layers(cfg),
          f"flash_attention launched {counts['flash_attention']} times in "
          f"generate, want {attn_layers(cfg)} (once a layer, in the prefill; "
          f"the hybrid's shared block once a period)")
    check(all(counts[k] == 0 for k in RELATIONAL + LM_KERNELS[1:]),
          f"serving launched {counts}")
    check(tuple(gen.tokens.shape) == (LM_BATCH, LM_GEN), "generated shape")
    check(bool(((gen.tokens >= 0) & (gen.tokens < cfg.padded_vocab)).all()),
          "generated token ids out of range")
    check(tuple(gen.logits[0].shape) == (LM_BATCH, cfg.padded_vocab) and
          all(tuple(x.shape) == (LM_BATCH, cfg.vocab_size)
              for x in gen.logits[1:]), "logits shapes")
    check(all(bool(torch.isfinite(x).all()) for x in gen.logits),
          "non-finite logits on the serving path")
    set_launches(0)
    with torch.no_grad():
        last, _ = make_decode_step(model)(
            gen.cache, gen.tokens[:, -1:],
            front_rows(cfg, embeds) + LM_PROMPT + LM_GEN - 1)
    check(launches()["flash_attention"] == 0, "a decode step launched flash")
    check(bool(torch.isfinite(last).all()), "non-finite decode logits")
    gen.cache = None
    return model, tokens, gen, counts, peak, init_s, n_params


def phase_serve_plain(model, tokens, gen, causal_tol: float | None = LM_TOL,
                      embeds=None, plain_tol: float = LM_TOL,
                      keep_plain: bool = False) -> dict:
    """Phase 9: the plain run teacher-forced with the kernel run's tokens
    (within ``plain_tol``; the hybrid's Mamba2 blocks carry the attention's
    rounding further, ``HYBRID_PLAIN_TOL``), and the serving invariant
    against one causal forward (within ``causal_tol``: MLA's decode takes
    another path, ``MLA_DECODE_TOL``; ``None`` only reports it, for the
    hybrid, which ``hybrid_invariant`` holds); a VLM's front rows first in
    both. With ``keep_plain`` the plain run's logits come back under
    ``plain_logits`` (``hybrid_rounding`` reads them)."""
    cfg = model.cfg
    nf = front_rows(cfg, embeds)
    set_launches(0)
    with kops.oracle_scope():
        plain = generate(model, tokens, LM_GEN, embeds=embeds,
                         forced=gen.tokens, keep_logits=True)
    check(all(v == 0 for v in launches().values()),
          f"plain serving run launched kernels: {launches()}")
    plain_errs = [logit_err(a, b) for a, b in zip(gen.logits, plain.logits)]
    check(max(plain_errs) <= plain_tol,
          f"serving logits differ from the plain run by {max(plain_errs)} "
          f"(tolerance {plain_tol})")
    # greedy tokens: with random weights the top-2 margins sit near bf16's
    # resolution, so a token is held equal only where the kernel run's
    # margin exceeds the tolerance; teacher forcing makes every step's
    # token comparable, not only the first
    margins = torch.stack([(lambda t: t[:, 0] - t[:, 1])(
        torch.topk(x.float(), 2, dim=-1).values) for x in gen.logits], 1)
    sure = margins > plain_tol
    check(torch.equal(gen.tokens[sure], plain.tokens[sure]),
          f"a greedy token differs from the plain run where the margin "
          f"exceeds {plain_tol}")
    same_plain = int((gen.tokens == plain.tokens).sum())
    kept = {"plain_logits": plain.logits} if keep_plain else {}
    del plain

    seq = torch.cat([tokens, gen.tokens[:, :LM_GEN - 1]], 1)
    set_launches(0)
    with torch.no_grad():
        full, _, _ = model.forward(tokens=seq, embeds=embeds)
    cross = embeds is None or seq.shape[1] == embeds.shape[1]
    check(launches()["flash_attention"] == attn_layers(cfg, cross),
          "the causal forward did not run flash once an attention layer")
    rows = full[:, nf + LM_PROMPT - 1:, :cfg.vocab_size]
    del full
    inv_errs = [logit_err(g[:, :cfg.vocab_size], rows[:, i])
                for i, g in enumerate(gen.logits)]
    check(causal_tol is None or max(inv_errs) <= causal_tol,
          f"prefill + decode differ from the causal forward by {max(inv_errs)}"
          f" (tolerance {causal_tol})")
    same = int((rows.argmax(-1).to(torch.int32) == gen.tokens).sum())
    return {"plain_max_abs_err": max(plain_errs),
            "plain_err_by_step": plain_errs, "plain_tolerance": plain_tol,
            "first_token_margins": margins[:, 0].tolist(),
            "tokens_checked": int(sure.sum()),
            "plain_same_greedy_tokens": same_plain,
            "causal_max_abs_err": max(inv_errs),
            "causal_err_by_step": inv_errs,
            "causal_same_greedy_tokens": same, **kept}


def phase_serve_times(model, tokens, reps: int = 5, embeds=None) -> dict:
    """Phase 10: prefill median ms (host clock around a synchronised call),
    decode ms a token and tokens/s (medians of two ``generate`` runs)."""
    cfg = model.cfg
    prefill = make_prefill_step(model, front_rows(cfg, embeds) + LM_PROMPT
                                + LM_GEN, enc_rows(cfg, embeds))
    batch = {"tokens": tokens} if embeds is None else \
        {"tokens": tokens, "embeds": embeds}
    walls = []
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = prefill(batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del res
    decode_ms, decode_tok_s, e2e_tok_s = [], [], []
    for _ in range(2):
        g = generate(model, tokens, LM_GEN, embeds=embeds)
        decode_ms.append(g.decode_s / (LM_GEN - 1) * 1e3)
        decode_tok_s.append(LM_BATCH * (LM_GEN - 1) / g.decode_s)
        e2e_tok_s.append(LM_BATCH * LM_GEN / (g.prefill_s + g.decode_s))
        del g
    return {"prefill_ms": statistics.median(walls), "prefill_runs": reps,
            "decode_ms_per_token": statistics.median(decode_ms),
            "decode_tokens_per_s": statistics.median(decode_tok_s),
            "end_to_end_tokens_per_s": statistics.median(e2e_tok_s)}


def phase_serve_profile(model, tokens, steps: int = 4, embeds=None) -> dict:
    """Phase 10's traces: one prefill, then ``steps`` decode steps."""
    nf = front_rows(model.cfg, embeds)
    prefill = make_prefill_step(model, nf + LM_PROMPT + LM_GEN,
                                enc_rows(model.cfg, embeds))
    decode = make_decode_step(model)
    batch = {"tokens": tokens} if embeds is None else \
        {"tokens": tokens, "embeds": embeds}
    held = {}

    def run_prefill():
        with torch.no_grad():
            held["logits"], held["cache"] = prefill(batch)

    def run_decode():
        tok = torch.argmax(held["logits"], -1)[:, None].to(torch.int32)
        with torch.no_grad():
            for i in range(steps):
                logits, _ = decode(held["cache"], tok, nf + LM_PROMPT + i)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)

    # the serving path launches no ported kernel but flash (phase 8's
    # counts), so ``ported_kernels_ms`` is flash's device time
    return {"prefill": profiled("prefill", run_prefill),
            f"decode x{steps}": profiled("decode", run_decode)}


# ---------------------------------------------------------------------------
# phase 16: training, granite-3-2b at full width and depth
# ---------------------------------------------------------------------------


def train_launches(cfg, microbatches: int) -> dict[str, int]:
    """Each kernel's launches in one train step: with ``remat="full"`` (or
    ``"dots"``, which keeps matmul outputs and recomputes the rest) every
    attention layer (a hybrid's shared-block invocation, recomputed with
    its period) runs the LSE forward once in the forward and once more
    when its block is recomputed in the backward, and the backward once,
    for each microbatch; an MoE layer's dispatch counts its experts' tokens
    with bucket_histogram in both forwards; the serving entry and the
    other relational kernels never."""
    fwd = 1 if cfg.remat == "none" else 2
    moe = fwd * cfg.num_layers * microbatches if cfg.moe_num_experts else 0
    return {**ZERO_LAUNCHES,
            "flash_attention_lse": fwd * attn_layers(cfg) * microbatches,
            "flash_attention_bwd": attn_layers(cfg) * microbatches,
            "bucket_histogram": moe}


def train_batches(dev, cfg, n: int) -> tuple[list[dict], list[float]]:
    """``n`` batches of the relational token pipeline at the training path's
    shape on the card, and the ms each took (host clock, synchronised)."""
    from repro_torch.data.pipeline import PipelineConfig, RelationalTokenPipeline

    pipe = RelationalTokenPipeline(PipelineConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, vocab_size=cfg.vocab_size,
        seed=0), device=dev)
    batches, walls = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             pipe.global_batch(i).items()}
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(tuple(b["tokens"].shape) == (TRAIN_BATCH, TRAIN_SEQ) and
              b["tokens"].dtype == torch.int32 and
              int(b["tokens"].max()) < cfg.vocab_size and
              tuple(b["weight"].shape) == (TRAIN_BATCH,),
              f"pipeline batch {i}: {b['tokens'].shape} {b['tokens'].dtype}")
        batches.append(b)
    return batches, walls


def grad_scales(plain: dict[str, torch.Tensor]) -> dict[str, float]:
    """Each leaf's scale in the kernel-against-plain gradient check: its
    own largest value, but a Mamba2 block's leaves share their block's
    largest. Its ``D``, ``dt_bias`` and ``A_log`` gradients are sums over
    every token and channel of a head with much cancellation: the
    attention's bf16 rounding moves them by up to 4.5% of their own largest
    value at 2 periods of zamba2-1.2b on an H100, as the fp32 sums' order
    moves them by 2.1e-5 where every other leaf moves under 1.1e-5 (the CPU
    against the reference, tests/test_torch_hybrid.py)."""
    own = {n: float(t.abs().max()) for n, t in plain.items()}
    block: dict[str, float] = {}
    for n, m in own.items():
        if n.startswith("mamba."):
            key = n.rsplit(".", 1)[0]
            block[key] = max(block.get(key, 0.0), m)
    return {n: block[n.rsplit(".", 1)[0]] if n.startswith("mamba.") else m
            for n, m in own.items()}


def phase_train_plain(dev, batch, arch: str = TRAIN_ARCH, cfg=None) -> dict:
    """Phase 16's (and 17's, 19-22's) check against plain attention at
    full width and ``plain_layers`` (2 layers, a hybrid's 2 periods), or at
    ``cfg``: the gradients of every leaf through the kernels and under
    ``oracle_scope()`` (plain attention on the card), then one train step
    of each from the same weights: loss and grad norm. The kernel run's
    launches must be ``train_launches``' (the plain run's none). Each leaf
    is held to ``grad_scales``' scale (a hybrid's Mamba2 leaves to their
    block's). An MoE model's plain runs follow the kernel runs' routes
    (``RouteTap``), the share of routes they would have changed under
    ``MOE_FLIP_SHARE``."""
    if cfg is None:
        cfg = get_config(arch)
        cfg = cfg.replace(num_layers=plain_layers(cfg))
    k = train_microbatches(arch)
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    state = TS.bind_state(model)
    set_launches(0)
    tap = RouteTap()
    with tap.record():
        grads, _ = TS._accumulate_grads(model, state.params, batch, k)
    check(launches() == train_launches(cfg, k),
          f"{cfg.num_layers}-layer gradients launched {launches()}, want "
          f"{train_launches(cfg, k)}")
    with kops.oracle_scope(), tap.follow(tap.calls):
        plain, _ = TS._accumulate_grads(model, state.params, batch, k)
    check(tap.share <= MOE_FLIP_SHARE,
          f"{tap.flips} of {tap.routes} routes differ between the kernel and "
          f"plain gradient runs (bound {MOE_FLIP_SHARE})")
    errs = {}
    scales = grad_scales(plain)
    for name, g in grads.items():
        errs[name] = float((g - plain[name]).abs().max()) / max(scales[name],
                                                                1e-30)
        check(errs[name] <= TRAIN_GRAD_TOL,
              f"{cfg.num_layers}-layer gradient {name}: kernel run "
              f"differs from plain attention by {errs[name]:.4g} of its max")
    rounded = {}
    if cfg.family == "hybrid":
        # the hybrid's account: the same gradients through the plain
        # attention with the kernel's P rounding, each leaf held to the
        # kernel run's within the same tolerance
        set_launches(0)
        with rounded_p_scope():
            rgrads, _ = TS._accumulate_grads(model, state.params, batch, k)
        check(all(v == 0 for v in launches().values()),
              f"the rounded-P gradient run launched {launches()}")
        for name, g in grads.items():
            rounded[name] = float((g - rgrads[name]).abs().max()) / max(
                scales[name], 1e-30)
            check(rounded[name] <= TRAIN_GRAD_TOL,
                  f"{cfg.num_layers}-layer gradient {name}: kernel run differs "
                  f"from the rounded-P plain run by {rounded[name]:.4g} of its "
                  f"max")
        del rgrads
    del grads, plain
    step = TS.make_train_step(model, OptConfig(**TRAIN_OPT), microbatches=k)
    set_launches(0)
    step_tap = RouteTap()
    with step_tap.record():
        _, mk = step(state, batch)
    mk = {n: float(v) for n, v in mk.items()}
    del state  # its masters and moments, before the plain run draws its own
    set_launches(0)
    with kops.oracle_scope(), step_tap.follow(step_tap.calls):
        _, mp = step(TS.init_train_state(model, 0), batch)
    check(all(v == 0 for v in launches().values()),
          f"the plain train step launched {launches()}")
    mp = {n: float(v) for n, v in mp.items()}
    dl = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    dg = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    check(dl <= TRAIN_LOSS_TOL and dg <= TRAIN_GNORM_TOL,
          f"{cfg.num_layers}-layer step: loss {mk['loss']} vs plain "
          f"{mp['loss']}, grad norm {mk['grad_norm']} vs {mp['grad_norm']}")
    worst = max(errs, key=errs.get)
    extra = {}
    if rounded:
        rworst = max(rounded, key=rounded.get)
        extra = {"rounded_worst_grad_leaf": rworst,
                 "rounded_worst_grad_rel_err": rounded[rworst],
                 "dt_bias_grad_rel_err": max(v for n, v in errs.items()
                                             if n.endswith("dt_bias")),
                 "dt_bias_rounded_grad_rel_err": max(
                     v for n, v in rounded.items() if n.endswith("dt_bias"))}
    return {**extra, "layers": cfg.num_layers, "loss": mk["loss"],
            "plain_loss": mp["loss"], "grad_norm": mk["grad_norm"],
            "plain_grad_norm": mp["grad_norm"], "loss_rel_err": dl,
            "grad_norm_rel_err": dg, "worst_grad_leaf": worst,
            "worst_grad_rel_err": errs[worst], "route_flips": tap.flips,
            "routes": tap.routes, "step_route_flips": step_tap.flips}


def grad_rounding_account(dev, batch, arch: str) -> dict:
    """Phase 24's account of the kernel-vs-plain gradient distance at the
    arch's full depth: every gradient leaf of one batch through the
    kernels, through the plain attention (``oracle_scope``), through the
    plain attention with the kernel's P rounding (``rounded_p_scope``) and
    through the plain attention on the same weights cast to fp32; each
    pair's distance per leaf over the fp32 run's ``grad_scales``, the worst
    leaf of each pair named. The kernel run's worst distance from the fp32
    run must be at most ``GRAD_NOISE_RATIO`` times the bf16 plain run's."""
    cfg = get_config(arch)
    k = train_microbatches(arch)
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    params = TS.bind_state(model).params
    runs = {}
    set_launches(0)
    runs["kernel"], _ = TS._accumulate_grads(model, params, batch, k)
    check(launches() == train_launches(cfg, k),
          f"{arch}'s gradients launched {launches()}, want "
          f"{train_launches(cfg, k)}")
    for name, scope in (("plain", kops.oracle_scope),
                        ("rounded", rounded_p_scope)):
        set_launches(0)
        with scope():
            runs[name], _ = TS._accumulate_grads(model, params, batch, k)
        check(all(v == 0 for v in launches().values()),
              f"the {name} gradient run launched {launches()}")
    m32 = build_model(cfg.replace(dtype=torch.float32,
                                  param_dtype=torch.float32), dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    m32.lm.load_state_dict({n: t.float()
                            for n, t in model.lm.state_dict().items()})
    del model, params
    with kops.oracle_scope():
        runs["f32"], _ = TS._accumulate_grads(
            m32, TS.bind_state(m32).params, batch, k)
    del m32
    scales = grad_scales(runs["f32"])
    out = {"layers": [cfg.encoder_layers, cfg.num_layers],
           "noise_ratio": GRAD_NOISE_RATIO}
    for a, b in (("kernel", "plain"), ("kernel", "rounded"),
                 ("rounded", "plain"), ("kernel", "f32"), ("plain", "f32")):
        errs = {n: float((g.float() - runs[b][n].float()).abs().max())
                / max(scales[n], 1e-30) for n, g in runs[a].items()}
        worst = max(errs, key=errs.get)
        out[f"{a}_vs_{b}"] = {"worst_leaf": worst, "rel_err": errs[worst]}
    del runs
    torch.cuda.empty_cache()
    kf, pf = out["kernel_vs_f32"]["rel_err"], out["plain_vs_f32"]["rel_err"]
    check(kf <= GRAD_NOISE_RATIO * pf,
          f"{arch}'s kernel gradients are {kf:.4g} from the fp32 run's, over "
          f"{GRAD_NOISE_RATIO} x the plain run's {pf:.4g}")
    return out


def phase_train(dev, batches, profile=None, arch: str = TRAIN_ARCH,
                layers: int | None = None, steps: int = TRAIN_STEPS) -> dict:
    """Phase 16: granite-3-2b at full width and depth (phase 17: ``arch`` at
    ``layers`` layers), random bf16 weights from a ``torch.Generator``
    seeded 0 on the card, trained by ``make_train_step`` (the reference's
    interleaved microbatches of the arch, here 4 of 2 x 1024; AdamW on fp32
    masters) on the pipeline's batches: one warm-up step, then ``steps``
    steps with the counts zeroed just before and read just after (each
    step's launches must be ``train_launches``'), then one profiled step.
    Every loss and grad norm finite."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    k = train_microbatches(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    state = TS.bind_state(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = TS.make_train_step(model, OptConfig(**TRAIN_OPT), microbatches=k)
    want = train_launches(cfg, k)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    metrics = [{n: float(v) for n, v in m.items()}]
    warm_ms = (time.perf_counter() - t0) * 1e3
    walls, per_step = [], []
    set_launches(0)
    for i in range(1, steps + 1):
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        metrics.append({n: float(v) for n, v in m.items()})  # synchronises
        walls.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: c - before[n] for n, c in launches().items()})
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    for i, n in enumerate(per_step):
        check(n == want, f"train step {i + 1} launched {n}, want {want}")
    check(all(math.isfinite(v) for x in metrics for v in x.values()),
          f"non-finite training metrics: {metrics}")
    check(int(state.step) == steps + 1, "the state's step count")
    prof = None
    if profile is not None:
        held = {}

        def one_step():
            held["state"], _ = step(held.pop("state"), batches[steps + 1])
        held["state"] = state
        prof = profile("train step", one_step)
        state = held["state"]
    # model FLOPs a token: 6N over the matrices (a tied embedding counted
    # once, as the unembedding's product; an untied input embedding, a
    # gather, not at all; of an MoE layer's experts the top-k a token runs)
    # plus the causal attention's products, forward and backward: 3 x (2 dqk
    # for q k + 2 dv for p v) FLOPs over (S + 1) / 2 keys a head a layer
    # (dqk = dv = hd but for MLA's); a hybrid's shared block once an
    # invocation, and its Mamba blocks' chunked GLA: per head a token, q k
    # over (Q + 1) / 2 keys of a chunk (2 N each) and w v (2 P each), its
    # state contribution and its inter-chunk product (2 N P each), times 3;
    # xLSTM's mLSTM blocks the same GLA at N = hd, P = hd + 1 (the
    # normalizer's column); the encoder-decoder's learned positions a
    # gather (not counted), its encoder and cross attention over all S keys;
    # the remat recompute and the capacity's vacant slots are not counted
    n_matmul = n_params - (0 if cfg.tie_embeddings else model.lm.embed.numel())
    if cfg.moe_num_experts:
        e_pad = model.lm.layers[0].moe["wi"].shape[0]
        n_matmul -= cfg.num_layers * (e_pad - cfg.moe_top_k) * 3 * \
            cfg.d_model * cfg.moe_d_ff
    gla = 0.0
    if cfg.family == "hybrid":
        n_matmul += (attn_layers(cfg) - 1) * sum(
            p.numel() for p in model.lm.shared.parameters())
        h, n = cfg.n_ssm_heads, cfg.ssm_state
        pd, q = cfg.d_inner // h, min(cfg.ssm_chunk, TRAIN_SEQ)
        gla = 3 * cfg.num_layers * 2 * h * ((q + 1) / 2 * (n + pd) + 2 * n * pd)
    if cfg.family == "ssm":
        h, hd = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
        q = min(cfg.ssm_chunk, TRAIN_SEQ)
        gla = 3 * len(model.lm.mlstm) * 2 * h * (
            (q + 1) / 2 * (2 * hd + 1) + 2 * hd * (hd + 1))
    dqk, dv = attn_widths(cfg)
    keys = attn_layers(cfg) * (TRAIN_SEQ + 1)
    if cfg.family == "audio":
        n_matmul -= model.lm.dec_pos.numel()
        keys = cfg.num_layers * (TRAIN_SEQ + 1) + \
            (cfg.encoder_layers + cfg.num_layers) * 2 * TRAIN_SEQ
    del state, step, model
    med = statistics.median(walls)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops_tok = 6 * n_matmul + 3 * cfg.num_heads * (dqk + dv) * keys + gla
    tok_s = tokens / (med / 1e3)
    return {"arch": arch, "layers": cfg.num_layers, "parameters": n_params,
            "microbatches": k,
            "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
            "init_s": init_s, "warmup_step_ms": warm_ms, "step_ms": walls,
            "median_step_ms": med, "tokens_per_s": tok_s,
            "flops_per_token": flops_tok,
            "bf16_peak_share": tok_s * flops_tok / TENSOR_BF16_OPS_PER_S,
            **{n: [x[n] for x in metrics] for n in (
                "loss", "grad_norm", "lr", "moe_aux", "moe_dropped")},
            "peak_bytes": peak,
            "launches": counts, "launches_per_step": want, "profile": prof}


def phase_train_narrow(dev) -> dict:
    """Phase 16 at the narrow config (granite-3-2b's TINY, head dim 16): a
    run with ``ckpt_every=2`` that fails at step 4, resumed, ends bitwise
    equal to an uninterrupted 6-step run (the
    parameters, masters and moments; in a temporary directory, removed
    after), with ``torch.use_deterministic_algorithms`` on for it (the
    embedding lookup's backward, ``index_put_`` with accumulate, adds with
    atomics otherwise); then 60 steps on one repeated batch lower the loss
    by more than 1.0 (``tests/test_train.py``'s overfit check)."""
    from repro_torch.data.pipeline import PipelineConfig, RelationalTokenPipeline

    cfg = get_tiny(TRAIN_ARCH)
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    def pipe(seq, seed):
        return RelationalTokenPipeline(PipelineConfig(
            seq_len=seq, global_batch=NARROW_BATCH, vocab_size=cfg.vocab_size,
            seed=seed), device=dev)

    def leaves(state):
        return {f"{part}.{n}": t.clone() for part, tree in (
            ("params", state.params), ("master", state.opt.master),
            ("m", state.opt.m), ("v", state.opt.v)) for n, t in tree.items()}

    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    quiet = lambda s: None  # noqa: E731
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref_state, _ = run(model, pipe(NARROW_SEQ, 5), ocfg,
                           LoopConfig(total_steps=6, log_every=100), log=quiet)
        want = leaves(ref_state)
        with tempfile.TemporaryDirectory() as d:
            lcfg = LoopConfig(total_steps=6, ckpt_dir=d, ckpt_every=2,
                              log_every=100)
            try:
                run(model, pipe(NARROW_SEQ, 5), ocfg, lcfg, fail_at_step=4,
                    log=quiet)
                check(False, "the injected failure at step 4 did not raise")
            except RuntimeError as e:
                check("injected failure at step 4" in str(e), str(e))
            logs = []
            resumed, _ = run(model, pipe(NARROW_SEQ, 5), ocfg, lcfg,
                             log=logs.append)
            check(logs[:1] == ["[resume] from step 4"], f"resume log {logs}")
            got = leaves(resumed)
        differ = [n for n in want if not torch.equal(want[n], got[n])]
        check(not differ and int(resumed.step) == 6,
              f"crash-resume differs from the uninterrupted run in {differ}")
    finally:
        torch.use_deterministic_algorithms(False)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe(32, 7).global_batch(0).items()}
    step = TS.make_train_step(model, OptConfig(
        lr=3e-3, warmup_steps=10, total_steps=200, weight_decay=0.0))
    state = TS.init_train_state(model, 0)
    losses = []
    for _ in range(60):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    check(losses[-1] < losses[0] - 1.0,
          f"60 steps on one batch: loss {losses[0]} -> {losses[-1]}")
    return {"config": f"{TRAIN_ARCH} TINY (head_dim {cfg.hd})", "resumed_bitwise":
            len(want), "overfit_first_loss": losses[0],
            "overfit_last_loss": losses[-1]}


# ---------------------------------------------------------------------------
# phase 17: stablelm-12b (head dim 160) served at full width and depth, and
# trained at BIG_TRAIN_LAYERS of its layers
# ---------------------------------------------------------------------------


def phase_big_serve(dev, profile: bool = False, arch: str | None = None,
                    causal_tol: float = LM_TOL, layers: int | None = None
                    ) -> dict:
    """Phase 17's serving half (and phases 20-22's, for their archs;
    ``layers`` of the arch's depth, or all): ``arch``
    through phases 8-10's checks, times and (with ``profile``) traces
    (``phase_serve``, ``phase_serve_plain``, ``phase_serve_times``,
    ``phase_serve_profile``): one flash launch an attention layer in the
    prefill and none in a decode step, finite logits, the prefill's and
    every decode step's logits within ``LM_TOL`` of the plain-attention run
    and within ``causal_tol`` of one causal forward; the hybrid's within
    ``causal_tol`` (``HYBRID_PLAIN_TOL``) of the plain run, and its
    invariant by ``hybrid_invariant``. The tolerances'
    premise, that a wrong attention moves the logits by more, is checked
    on the prefill's: their std at least 3 ``LM_TOL``, and a prefill
    through plain attention with a bidirectional mask moves them (every
    row's, against a causal prefill through the kernel) by over 3
    ``causal_tol``; for the hybrid also decode with the Mamba states
    zeroed after the prefill (``lost_carry_err``). ``arch`` defaults to
    ``BIG_ARCH``."""
    arch = BIG_ARCH if arch is None else arch
    model, tokens, gen, counts, peak, init_s, n_params = phase_serve(
        dev, arch, layers)
    cfg = model.cfg
    embeds = serve_inputs(cfg, dev)[1]
    std = float(gen.logits[0][:, :cfg.vocab_size].float().std())
    check(std >= 3 * LM_TOL, f"{arch} prefill logits have std {std}, too "
          f"small for the tolerance {LM_TOL} to tell a wrong attention")
    first = {"prefill_ms": gen.prefill_s * 1e3,
             "decode_ms_per_token": gen.decode_s / (LM_GEN - 1) * 1e3}
    real_attention = kops.attention
    with attention_as(lambda q, k, v, causal=True: real_attention(
            q, k, v, causal=False)), torch.no_grad(), kops.oracle_scope():
        wrong, _, _ = model.forward(tokens=tokens, embeds=embeds)
    with torch.no_grad():
        causal, _, _ = model.forward(tokens=tokens, embeds=embeds)
    wrong_err = logit_err(wrong, causal)
    del wrong, causal
    check(wrong_err > 3 * causal_tol, f"{arch}: a bidirectional mask moves the "
          f"prefill logits by only {wrong_err}, too little for the tolerance "
          f"{causal_tol} to tell a wrong attention")
    lost = enc_causal = None
    if cfg.family == "hybrid":
        lost = lost_carry_err(model, tokens, gen.tokens)
        check(lost > 3 * causal_tol, f"{arch}: the Mamba states zeroed after "
              f"the prefill move the decode logits by only {lost}, too little "
              f"for the tolerance {causal_tol} to tell a lost state carry")
    if cfg.family == "audio":
        enc_causal = causal_encoder_err(model, tokens, embeds)
        check(enc_causal > 3 * LM_TOL, f"{arch}: a causal mask in the encoder "
              f"moves the prefill logits by only {enc_causal}, too little for "
              f"the tolerance {LM_TOL} to tell it")
    hybrid = cfg.family == "hybrid"
    agree = phase_serve_plain(model, tokens, gen, None if hybrid else causal_tol,
                              embeds, causal_tol if hybrid else LM_TOL,
                              keep_plain=hybrid)
    if hybrid:
        agree.update(hybrid_rounding(model, tokens, gen,
                                     agree.pop("plain_logits")))
        agree.update(hybrid_invariant(model, tokens, gen))
    del gen
    times = phase_serve_times(model, tokens, embeds=embeds)
    prof = phase_serve_profile(model, tokens, embeds=embeds) if profile \
        else None
    del model, tokens, embeds
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.num_layers,
            "widths": list(attn_widths(cfg)), "parameters": n_params,
            "init_s": init_s, "batch": LM_BATCH, "prompt_len": LM_PROMPT,
            "front_rows": cfg.num_frontend_tokens if cfg.family == "vlm" else 0,
            "gen": LM_GEN, "peak_bytes": peak, "launches": counts,
            "prefill_logit_std": std, "wrong_mask_max_abs_err": wrong_err,
            "lost_carry_max_abs_err": lost,
            "causal_encoder_max_abs_err": enc_causal,
            "causal_tolerance": None if hybrid else causal_tol,
            "first_run": first, **times, **agree, "profile": prof}


def attention_calls(model, tokens) -> list[tuple]:
    """The (q, k, v, causal) of each attention call of one prefill of
    ``tokens`` through the kernel."""
    calls = []
    real = kops.attention

    def record(q, k, v, causal=True):
        calls.append((q.clone(), k.clone(), v.clone(), causal))
        return real(q, k, v, causal=causal)
    with attention_as(record), torch.no_grad():
        make_prefill_step(model, tokens.shape[1])({"tokens": tokens})
    return calls


def hybrid_rounding(model, tokens, gen, plain_logits) -> dict:
    """Phase 21's account of the hybrid's kernel-vs-plain distance. The
    served model teacher-forced with the kernel run's tokens through the
    plain attention with the kernel's P rounding (``rounded_p_scope``), no
    kernel launched; the largest |logit| difference over every step of
    each pair of three runs: the kernel run ``gen``, the plain run
    (``phase_serve_plain``'s ``plain_logits``) and the P-rounded run. Per
    attention call of the prefill, on the same inputs: the kernel against
    the P-rounded plain version and that against the plain version (the
    largest difference and the share of outputs that differ). The kernel
    run and the plain run must each be within ``HYBRID_PLAIN_TOL`` of the
    P-rounded run, and each call's kernel output may differ from its
    emulation on at most ``KERNEL_EMULATION_SHARE`` of its outputs (a wrong
    mask, head or cache slot moves nearly all of them)."""
    runs = {"plain": plain_logits}
    set_launches(0)
    with rounded_p_scope():
        runs["rounded"] = generate(model, tokens, LM_GEN, forced=gen.tokens,
                                   keep_logits=True).logits
    check(all(v == 0 for v in launches().values()),
          f"the rounded serving run launched {launches()}")

    def dist(a, b):
        return max(logit_err(x, y) for x, y in zip(a, b))
    out = {"kernel_vs_plain": dist(gen.logits, runs["plain"]),
           "rounded_vs_plain": dist(runs["rounded"], runs["plain"]),
           "kernel_vs_rounded": dist(gen.logits, runs["rounded"]),
           "rounded_tolerance": HYBRID_PLAIN_TOL,
           "emulation_share_bound": KERNEL_EMULATION_SHARE}
    del runs
    per_call = []
    with torch.no_grad():
        for q, k, v, causal in attention_calls(model, tokens):
            got = flash_attention(q, k, v, causal=causal).float()
            emu = ref.attention_rounding_p(q, k, v, causal=causal).float()
            plain = ref.attention_ref(q, k, v, causal=causal).float()
            per_call.append({
                "kernel_vs_rounded": float((got - emu).abs().max()),
                "kernel_vs_rounded_share": float((got != emu).float().mean()),
                "rounded_vs_plain": float((emu - plain).abs().max()),
                "rounded_vs_plain_share": float((emu != plain).float().mean())})
    out["per_call"] = per_call
    say(f"[21] teacher-forced distances: kernel vs plain "
        f"{out['kernel_vs_plain']:.4g}, P-rounded plain vs plain "
        f"{out['rounded_vs_plain']:.4g}, kernel vs P-rounded plain "
        f"{out['kernel_vs_rounded']:.4g}; per prefill call, kernel vs P-rounded "
        f"plain {[round(c['kernel_vs_rounded'], 5) for c in per_call]} "
        f"({[round(c['kernel_vs_rounded_share'], 5) for c in per_call]} of "
        f"outputs), P-rounded plain vs plain "
        f"{[round(c['rounded_vs_plain'], 5) for c in per_call]} "
        f"({[round(c['rounded_vs_plain_share'], 5) for c in per_call]})")
    for name in ("kernel_vs_rounded", "rounded_vs_plain"):
        check(out[name] <= HYBRID_PLAIN_TOL,
              f"the hybrid's {name.replace('_', ' ')} distance is "
              f"{out[name]} (tolerance {HYBRID_PLAIN_TOL})")
    check(all(c["kernel_vs_rounded_share"] <= KERNEL_EMULATION_SHARE
              for c in per_call),
          f"a prefill attention call's kernel output differs from its "
          f"P-rounded emulation on more than {KERNEL_EMULATION_SHARE} of its "
          f"outputs: {per_call}")
    return out


def causal_encoder_err(model, tokens, embeds) -> float:
    """The encoder-decoder's prefill logits with a causal mask in its
    encoder against the right (bidirectional) encoder, both through the
    kernel: the largest |logit| difference."""
    lm = model.lm
    real = kops.attention
    with torch.no_grad():
        with attention_as(lambda q, k, v, causal=True: real(q, k, v,
                                                            causal=True)):
            wrong_enc = lm.encode(embeds)
        enc = lm.encode(embeds)
        wrong = lm.decode(tokens, lm.build_cross_kv(wrong_enc), mode="causal")
        right = lm.decode(tokens, lm.build_cross_kv(enc), mode="causal")
    return logit_err(wrong, right)


def hybrid_invariant(model, tokens, gen, f32_tol: float = HYBRID_F32_TOL
                     ) -> dict:
    """Phase 21's (and 23's) serving invariant: the served bf16 model's
    weights cast to fp32 (a second model), one causal forward of each over
    the prompt and the fed tokens, and the fp32 model's ``generate``
    teacher-forced with the bf16 run's tokens. The fp32 prefill + decode
    must be within ``f32_tol`` of the fp32 causal forward, and the
    recurrent states zeroed after its prefill must move it by more than 3
    times that; the bf16 serving logits' distance from the fp32 causal
    forward must be at most ``HYBRID_NOISE_RATIO`` times the bf16 causal
    forward's."""
    cfg, dev, v = model.cfg, tokens.device, model.cfg.vocab_size
    m32 = build_model(cfg.replace(dtype=torch.float32, param_dtype=torch.float32),
                      dev, generator=torch.Generator(device=dev).manual_seed(0))
    m32.lm.load_state_dict({k: t.float() for k, t in model.lm.state_dict().items()})
    seq = torch.cat([tokens, gen.tokens[:, :LM_GEN - 1]], 1)
    with torch.no_grad():
        full32 = m32.forward(tokens=seq)[0][:, LM_PROMPT - 1:, :v]
        full16 = model.forward(tokens=seq)[0][:, LM_PROMPT - 1:, :v]
    causal_noise = logit_err(full16, full32)
    serve_vs_causal = max(logit_err(g[:, :v], full16[:, i])
                          for i, g in enumerate(gen.logits))
    del full16
    serve_noise = max(logit_err(g[:, :v], full32[:, i])
                      for i, g in enumerate(gen.logits))
    check(serve_noise <= HYBRID_NOISE_RATIO * causal_noise,
          f"the bf16 serving logits are {serve_noise} from the fp32 causal "
          f"forward, over {HYBRID_NOISE_RATIO} x the bf16 causal forward's "
          f"{causal_noise}")
    g32 = generate(m32, tokens, LM_GEN, forced=gen.tokens, keep_logits=True)
    errs32 = [logit_err(g[:, :v], full32[:, i]) for i, g in enumerate(g32.logits)]
    del g32, full32
    check(max(errs32) <= f32_tol,
          f"fp32 prefill + decode differ from the fp32 causal forward by "
          f"{max(errs32)} (tolerance {f32_tol})")
    lost32 = lost_carry_err(m32, tokens, gen.tokens)
    check(lost32 > 3 * f32_tol, f"the recurrent states zeroed after an fp32 "
          f"prefill move its decode logits by only {lost32}")
    del m32
    torch.cuda.empty_cache()
    return {"f32_causal_max_abs_err": max(errs32), "f32_causal_err_by_step": errs32,
            "f32_tolerance": f32_tol, "f32_lost_carry_max_abs_err": lost32,
            "bf16_causal_vs_f32": causal_noise, "bf16_serving_vs_f32": serve_noise,
            "bf16_serving_vs_bf16_causal": serve_vs_causal,
            "noise_ratio": HYBRID_NOISE_RATIO}


def zero_states(cache) -> None:
    """A recurrent model's states zeroed in its cache: the hybrid's Mamba2
    SSM states, or xLSTM's mLSTM states and sLSTM (c, n)."""
    if "mamba" in cache:
        cache["mamba"]["ssm"].zero_()
        return
    cache["mlstm"]["state"].zero_()
    cache["slstm"]["c"].zero_()
    cache["slstm"]["n"].zero_()


def lost_carry_err(model, tokens, forced, steps: int = 4) -> float:
    """A recurrent model's prefill (the hybrid's or xLSTM's), its states
    then zeroed (the carry lost, ``zero_states``), and ``steps`` decode
    steps fed ``forced``'s tokens: the largest |logit| difference from one
    causal forward over the same tokens."""
    cfg = model.cfg
    seq = torch.cat([tokens, forced[:, :steps]], 1)
    with torch.no_grad():
        full, _, _ = model.forward(tokens=seq)
        rows = full[:, LM_PROMPT:, :cfg.vocab_size]
        del full
        _, cache = make_prefill_step(model, LM_PROMPT + steps)(
            {"tokens": tokens})
        zero_states(cache)
        decode = make_decode_step(model)
        errs = []
        for i in range(steps):
            logits, cache = decode(cache, forced[:, i:i + 1], LM_PROMPT + i)
            errs.append(logit_err(logits, rows[:, i]))
    return max(errs)


def phase_big_train(dev, profile=None, arch: str | None = None,
                    layers: int | None = None) -> dict:
    """Phase 17's training half (and phase 20's, for ``MLA_ARCH`` at
    ``MLA_TRAIN_LAYERS``, and 21's for ``HYBRID_ARCH`` uncut): ``arch`` at
    full width, kernels against plain attention at ``plain_layers`` (2
    layers, a hybrid's 2 periods; phase 16's tolerances), then
    ``layers`` layers trained on the pipeline's batches (``phase_train``: a
    warm-up step, ``BIG_TRAIN_STEPS`` steps of ``train_launches``' launches
    each, finite losses, one profiled step). ``arch`` and ``layers`` default
    to ``BIG_ARCH`` and ``BIG_TRAIN_LAYERS``."""
    arch = BIG_ARCH if arch is None else arch
    layers = BIG_TRAIN_LAYERS if layers is None else layers
    cfg = get_config(arch)
    batches, pipe_ms = train_batches(dev, cfg, BIG_TRAIN_STEPS + 2)
    plain = phase_train_plain(dev, batches[0], arch)
    torch.cuda.empty_cache()
    train = phase_train(dev, batches, profile, arch, layers, BIG_TRAIN_STEPS)
    del batches
    torch.cuda.empty_cache()
    return {**train, "pipeline_ms": pipe_ms, "plain": plain}


# ---------------------------------------------------------------------------
# phase 18: the reference's --tiny launcher commands on the card
# ---------------------------------------------------------------------------


def phase_tiny(dev) -> dict:
    """The launchers' ``main`` in process, as ``python -m
    repro_torch.launch.serve --arch <a> --tiny`` and ``python -m
    repro_torch.launch.train --arch <a> --tiny --steps 3`` run them: on the
    card (their default device), the counts zeroed just before and read
    just after, then the same command with ``--device cpu`` (the launchers
    draw the weights on the host, so both runs hold one model). Serving:
    flash once an attention layer (the hybrid's shared block once a
    period), no other LM kernel (an MoE arch: bucket_histogram
    once a layer a forward), finite logits, the prefill's logits within
    ``LM_TOL`` of the CPU run's. Training: every step logged (``--log-every
    1``), ``train_launches``' launches a step, each step's loss finite and
    within ``TINY_LOSS_TOL`` of the CPU run's. An MoE arch's CPU run follows
    the card run's routes (``RouteTap``; the share it would have changed
    under ``MOE_FLIP_SHARE``)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    out = {"serve": {}, "train": {}}
    for arch in TINY_SERVE_ARCHS:
        cfg = get_tiny(arch)
        argv = ["--arch", arch, "--tiny"]
        set_launches(0)
        tap = RouteTap()
        with tap.record():
            card = serve_cli.main(argv)
        counts = launches()
        gen = card.tokens.shape[1]
        hist = cfg.num_layers * gen if cfg.moe_num_experts else 0
        check(counts["flash_attention"] == attn_layers(cfg) and
              all(counts[k] == 0 for k in LM_KERNELS[1:]) and
              counts["bucket_histogram"] == hist,
              f"serve --tiny {arch} on the card launched {counts}, want flash "
              f"once an attention layer ({attn_layers(cfg)}) and "
              f"bucket_histogram {hist}")
        check(card.logits[0].device.type == dev.type and
              all(bool(torch.isfinite(x).all()) for x in card.logits),
              f"serve --tiny {arch}: non-finite logits, or not on {dev}")
        with tap.follow(tap.calls):
            cpu = serve_cli.main(argv + ["--device", "cpu"])
        check(tap.share <= MOE_FLIP_SHARE, f"serve --tiny {arch}: {tap.flips} "
              f"of {tap.routes} routes differ from the card's")
        err = logit_err(card.logits[0].cpu(), cpu.logits[0])
        check(err <= LM_TOL, f"serve --tiny {arch}: prefill logits differ from "
              f"the --device cpu run's by {err}")
        out["serve"][arch] = {
            "hd": cfg.hd, "widths": list(attn_widths(cfg)), "launches": counts,
            "prefill_max_abs_err": err,
            "prefill_logit_std": float(cpu.logits[0].float().std()),
            "same_tokens": int((card.tokens.cpu() == cpu.tokens).sum()),
            "tokens": card.tokens.numel(), "route_flips": tap.flips,
            "routes": tap.routes}
    for arch in TINY_TRAIN_ARCHS:
        cfg = get_tiny(arch)
        argv = ["--arch", arch, "--tiny", "--steps", str(TINY_TRAIN_STEPS),
                "--log-every", "1"]
        want = train_launches(cfg, 1)
        set_launches(0)
        tap = RouteTap()
        with tap.record():
            card = train_cli.main(argv)
        counts = launches()
        check(all(counts[k] == TINY_TRAIN_STEPS * want[k]
                  for k in LM_KERNELS + ("bucket_histogram",)),
              f"train --tiny {arch} on the card launched {counts}, want "
              f"{TINY_TRAIN_STEPS} x {want} of the LM kernels")
        with tap.follow(tap.calls):
            cpu = train_cli.main(argv + ["--device", "cpu"])
        check(tap.share <= MOE_FLIP_SHARE, f"train --tiny {arch}: {tap.flips} "
              f"of {tap.routes} routes differ from the card's")
        diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(card, cpu)]
        check(len(card) == len(cpu) == TINY_TRAIN_STEPS and
              all(math.isfinite(x["loss"]) for x in card) and
              max(diffs) <= TINY_LOSS_TOL,
              f"train --tiny {arch}: losses {[x['loss'] for x in card]} on the "
              f"card, {[x['loss'] for x in cpu]} on the CPU (tolerance "
              f"{TINY_LOSS_TOL})")
        out["train"][arch] = {
            "hd": cfg.hd, "widths": list(attn_widths(cfg)), "launches": counts,
            "loss": [x["loss"] for x in card],
            "cpu_loss": [x["loss"] for x in cpu], "max_loss_diff": max(diffs),
            "route_flips": tap.flips, "routes": tap.routes}
    return out


# ---------------------------------------------------------------------------
# phase 19: Mixture-of-Experts (qwen2-moe-a2.7b served and trained, dbrx-132b
# served), after every earlier model is freed
# ---------------------------------------------------------------------------


def with_capacity(model, cf: float):
    """Set the model's (and its blocks') capacity factor; returns the old
    config."""
    old = model.cfg
    cfg = old.replace(moe_capacity_factor=cf)
    model.cfg = model.lm.cfg = cfg
    for block in model.lm.layers:
        block.cfg = cfg
    return old


def causal_routes(calls: list[torch.Tensor], layers: int, batch: int,
                  prompt: int) -> list[torch.Tensor]:
    """A ``generate``'s routes (the prefill's L calls of B x S tokens, then
    each decode step's L calls of B) as the L calls of one causal forward
    over the prompt and the fed tokens, in its token order."""
    k = calls[0].shape[-1]
    out = []
    for i in range(layers):
        parts = [calls[i].view(batch, prompt, k)] + [
            calls[j].view(batch, 1, k)
            for j in range(layers + i, len(calls), layers)]
        out.append(torch.cat(parts, 1).reshape(-1, k))
    return out


def phase_moe_serve(dev, arch: str, layers: int | None = None,
                    profile: bool = False) -> dict:
    """Phase 19's serving: ``arch`` at full width (``layers`` of its depth,
    or all), random bf16 weights and fp32 routers from a ``torch.Generator``
    seeded 0 on the card, ``LM_BATCH`` x ``LM_PROMPT`` prompts and
    ``LM_GEN`` greedy tokens through ``generate``, the counts zeroed just
    before and read just after: flash once a layer (the prefill), the
    histogram once a layer a forward (the prefill and each decode step);
    one more decode step launches the histogram once a layer and flash
    never. Every logit finite; the host syncs of one forward (must be 0)
    and its ``moe_dropped``. Then the plain run, teacher-forced, following
    the kernel run's routes: every step's logits within ``LM_TOL``, the
    flips under ``MOE_FLIP_SHARE``; a bidirectional mask must move the
    prefill's logits by over 3 ``LM_TOL``; the serving invariant at
    ``MOE_INVARIANT_CF`` (prefill + decode against one causal forward that
    follows their routes, within ``LM_TOL``); the serving times, and with
    ``profile`` one traced prefill and 4 decode steps."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(model.lm.layers[0].moe["router"].dtype == torch.float32,
          "the router is not fp32")
    tokens = serve_inputs(cfg, dev)[0]
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    tap = RouteTap()
    with tap.record():
        gen = generate(model, tokens, LM_GEN, keep_logits=True)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    want = {**ZERO_LAUNCHES, "flash_attention": L,
            "bucket_histogram": L * LM_GEN}
    check(counts == want, f"{arch} generate launched {counts}, want {want}")
    check(tuple(gen.tokens.shape) == (LM_BATCH, LM_GEN) and
          all(bool(torch.isfinite(x).all()) for x in gen.logits),
          f"{arch}: generated shape {tuple(gen.tokens.shape)}, or non-finite "
          f"logits")
    set_launches(0)
    with torch.no_grad():
        last, _ = make_decode_step(model)(gen.cache, gen.tokens[:, -1:],
                                          LM_PROMPT + LM_GEN - 1)
    step = launches()
    check(step["flash_attention"] == 0 and step["bucket_histogram"] == L and
          bool(torch.isfinite(last).all()),
          f"{arch}: a decode step launched {step}, want the histogram {L} "
          f"times and no flash")
    gen.cache = None
    with torch.no_grad():
        (causal, _, aux), syncs = count_syncs(
            lambda: model.forward(tokens=tokens))
    check(syncs == 0, f"{arch}: one forward made {syncs} host syncs")
    dropped = float(aux["moe_dropped"])
    std = float(gen.logits[0][:, :cfg.vocab_size].float().std())
    # LM_TOL's premise, that a wrong attention moves the logits by more
    # than it, checked directly (qwen2-moe's logits have std ~0.12, under
    # phase 17's 3 LM_TOL proxy): the prefill once more through plain
    # attention with a bidirectional mask, on the kernel run's routes, must
    # move them (every row's: the last row sees every key either way) by
    # over 3 LM_TOL
    real_attention = kops.attention
    kops.attention = lambda q, k, v, causal=True: real_attention(
        q, k, v, causal=False)
    try:
        with torch.no_grad(), kops.oracle_scope(), \
                RouteTap().follow(tap.calls[:L]):
            wrong, _, _ = model.forward(tokens=tokens)
    finally:
        kops.attention = real_attention
    wrong_err = logit_err(wrong, causal)
    del wrong, causal
    check(wrong_err > 3 * LM_TOL, f"{arch}: a bidirectional mask moves the "
          f"prefill logits by only {wrong_err}, too little for LM_TOL {LM_TOL} "
          f"to tell a wrong attention")

    set_launches(0)
    with kops.oracle_scope(), tap.follow(tap.calls):
        plain = generate(model, tokens, LM_GEN, forced=gen.tokens,
                         keep_logits=True)
    check(all(v == 0 for v in launches().values()),
          f"{arch}: the plain run launched {launches()}")
    check(tap.share <= MOE_FLIP_SHARE, f"{arch}: {tap.flips} of {tap.routes} "
          f"routes differ between the kernel and plain runs (bound "
          f"{MOE_FLIP_SHARE})")
    plain_errs = [logit_err(a, b) for a, b in zip(gen.logits, plain.logits)]
    check(max(plain_errs) <= LM_TOL,
          f"{arch}: logits differ from the plain run by {max(plain_errs)}")
    del plain

    old = with_capacity(model, MOE_INVARIANT_CF)
    try:
        inv_tap = RouteTap()
        with inv_tap.record():
            res = generate(model, tokens, LM_GEN, forced=gen.tokens,
                           keep_logits=True)
        res.cache = None
        seq = torch.cat([tokens, gen.tokens[:, :LM_GEN - 1]], 1)
        follow = RouteTap()
        set_launches(0)
        with torch.no_grad(), follow.follow(causal_routes(
                inv_tap.calls, L, LM_BATCH, LM_PROMPT)):
            full, _, full_aux = model.forward(tokens=seq)
        check(launches()["flash_attention"] == L and
              launches()["bucket_histogram"] == L,
              f"{arch}: the causal forward launched {launches()}")
        check(follow.share <= MOE_FLIP_SHARE,
              f"{arch}: {follow.flips} of {follow.routes} routes of the causal "
              f"forward differ from prefill + decode's")
        rows = full[:, LM_PROMPT - 1:, :cfg.vocab_size]
        inv_errs = [logit_err(g[:, :cfg.vocab_size], rows[:, i])
                    for i, g in enumerate(res.logits)]
        check(max(inv_errs) <= LM_TOL and float(full_aux["moe_dropped"]) == 0,
              f"{arch}: prefill + decode differ from the causal forward by "
              f"{max(inv_errs)} (dropped {float(full_aux['moe_dropped'])})")
        del full, rows, res
    finally:
        with_capacity(model, old.moe_capacity_factor)
    times = phase_serve_times(model, tokens)
    prof = phase_serve_profile(model, tokens) if profile else None
    del model, tokens, gen
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": L, "parameters": n_params,
            "init_s": init_s, "batch": LM_BATCH, "prompt_len": LM_PROMPT,
            "gen": LM_GEN, "peak_bytes": peak, "launches": counts,
            "decode_step_launches": step, "forward_host_syncs": syncs,
            "prefill_moe_dropped": dropped, "prefill_logit_std": std,
            "wrong_mask_max_abs_err": wrong_err,
            "plain_max_abs_err": max(plain_errs),
            "plain_route_flips": tap.flips, "routes": tap.routes,
            "causal_max_abs_err": max(inv_errs),
            "causal_route_flips": follow.flips,
            "invariant_capacity_factor": MOE_INVARIANT_CF, **times,
            "profile": prof}


def phase_moe_train(dev, profile=None) -> dict:
    """Phase 19's training: ``MOE_ARCH`` at full width, kernels against
    plain attention at ``TRAIN_PLAIN_LAYERS`` layers (phase 16's
    tolerances, the plain runs following the kernel runs' routes), then
    ``MOE_TRAIN_LAYERS`` layers trained on the pipeline's batches
    (``phase_train``: a warm-up step, ``MOE_TRAIN_STEPS`` steps of
    ``train_launches``' launches each, finite losses and aux, one profiled
    step)."""
    cfg = get_config(MOE_ARCH)
    batches, pipe_ms = train_batches(dev, cfg, MOE_TRAIN_STEPS + 2)
    plain = phase_train_plain(dev, batches[0], MOE_ARCH)
    torch.cuda.empty_cache()
    train = phase_train(dev, batches, profile, MOE_ARCH, MOE_TRAIN_LAYERS,
                        MOE_TRAIN_STEPS)
    del batches
    torch.cuda.empty_cache()
    return {**train, "pipeline_ms": pipe_ms, "plain": plain}


def say_moe_serve(r: dict, card: str) -> None:
    say(f"[19] {r['arch']} at {r['layers']} layers: {r['parameters']} "
        f"parameters drawn in {r['init_s']:.1f} s; {LM_BATCH} x {LM_PROMPT}"
        f"-token prompts, {LM_GEN} greedy tokens; launches {r['launches']}; a "
        f"decode step {r['decode_step_launches']['bucket_histogram']} "
        f"histograms, no flash; host syncs of one forward "
        f"{r['forward_host_syncs']}; prefill moe_dropped "
        f"{r['prefill_moe_dropped']:g}; peak {r['peak_bytes'] / 2**30:.2f} GiB")
    say(f"[19] plain run, teacher-forced, on the kernel run's routes: logits "
        f"within {r['plain_max_abs_err']:.4g} (tolerance {LM_TOL}, prefill "
        f"logits' std {r['prefill_logit_std']:.4f}, moved "
        f"{r['wrong_mask_max_abs_err']:.4g} by a bidirectional mask); its "
        f"own routes would "
        f"differ at {r['plain_route_flips']} of {r['routes']} (layer, token) "
        f"routes; one causal forward at capacity factor "
        f"{r['invariant_capacity_factor']:g} within {r['causal_max_abs_err']:.4g}"
        f" ({r['causal_route_flips']} routes would differ)")
    say(f"[19] prefill median {r['prefill_ms']:.2f} ms, decode "
        f"{r['decode_ms_per_token']:.3f} ms a token, "
        f"{r['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{r['end_to_end_tokens_per_s']:.1f} tokens/s end to end on {card}")
    for name, pr in (r["profile"] or {}).items():
        say(f"[19] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.2f} ms, busy share {pr['busy_share']:.2f}, "
            f"flash {pr['ported'].get('flash', 0.0):.3f} ms, bucket_histogram "
            f"{pr['ported'].get('hist', 0.0):.3f} ms, {pr['host_ops']} torch "
            f"ops dispatched by the host, on {card}")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.3f} ms  {kname[:110]}")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 20: minicpm3-4b (MLA) served at full width and depth, and trained at
# MLA_TRAIN_LAYERS of its layers
# ---------------------------------------------------------------------------


def say_big_serve(tag: int, r: dict, card: str, secs: float,
                  what: str = "") -> None:
    """Phase ``tag``'s serving lines (``phase_big_serve``); its profile
    reduced to the printed numbers."""
    front = (f"{r['front_rows']} front embeddings + "
             if r.get("front_rows") else "")
    lost = ("" if r.get("lost_carry_max_abs_err") is None else
            f", moved {r['lost_carry_max_abs_err']:.4g} by the Mamba states "
            f"zeroed after the prefill")
    say(f"[{tag}] {r['arch']} ({what}flash widths {r['widths'][0]}/"
        f"{r['widths'][1]}) at {r['layers']} layers: {r['parameters']} "
        f"parameters drawn in {r['init_s']:.1f} s; {LM_BATCH} x ({front}"
        f"{LM_PROMPT}-token prompts), {LM_GEN} greedy tokens; launches "
        f"{r['launches']}; a decode step launches none; peak "
        f"{r['peak_bytes'] / 2**30:.2f} GiB")
    say(f"[{tag}] plain run, teacher-forced: logits within "
        f"{r['plain_max_abs_err']:.4g} (tolerance {r['plain_tolerance']:g}; "
        f"prefill logits' std {r['prefill_logit_std']:.4f}, moved "
        f"{r['wrong_mask_max_abs_err']:.4g} by a bidirectional mask{lost}); "
        f"greedy tokens equal on all {r['tokens_checked']} with a top-2 "
        f"margin > {r['plain_tolerance']:g}, on {r['plain_same_greedy_tokens']} of "
        f"{LM_BATCH * LM_GEN} in all; prefill + decode vs one causal forward "
        f"within {r['causal_max_abs_err']:.4g} (tolerance "
        f"{r['causal_tolerance']}; by step "
        f"{[round(x, 4) for x in r['causal_err_by_step']]})")
    if r.get("causal_encoder_max_abs_err") is not None:
        say(f"[{tag}] a causal mask in the encoder moves the prefill logits "
            f"by {r['causal_encoder_max_abs_err']:.4g}")
    if "f32_causal_max_abs_err" in r:
        say(f"[{tag}] the same weights in fp32: prefill + decode vs one causal "
            f"forward within {r['f32_causal_max_abs_err']:.4g} (tolerance "
            f"{r['f32_tolerance']:g}), moved {r['f32_lost_carry_max_abs_err']:.4g}"
            f" by the Mamba states zeroed after the prefill; bf16 serving "
            f"logits {r['bf16_serving_vs_f32']:.4g} from the fp32 causal "
            f"forward, the bf16 causal forward {r['bf16_causal_vs_f32']:.4g} "
            f"(ratio bound {r['noise_ratio']:g})")
    say(f"[{tag}] prefill median {r['prefill_ms']:.2f} ms, decode "
        f"{r['decode_ms_per_token']:.3f} ms a token, "
        f"{r['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{r['end_to_end_tokens_per_s']:.1f} tokens/s end to end on {card} "
        f"({secs:.1f} s)")
    for name, pr in (r["profile"] or {}).items():
        say(f"[{tag}] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU "
            f"kernels {pr['device_ms']:.2f} ms, busy share "
            f"{pr['busy_share']:.2f}, flash {pr['ported_kernels_ms']:.3f} ms, "
            f"{pr['host_ops']} torch ops dispatched by the host, on {card}")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.3f} ms  {kname[:110]}")
        r["profile"][name] = {k: pr[k] for k in (
            "wall_ms", "device_ms", "busy_share", "ported_kernels_ms",
            "host_ops", "top")}


def say_big_train(tag: int, r: dict, card: str, secs: float) -> None:
    """Phase ``tag``'s training lines (``phase_big_train``)."""
    p = r["plain"]
    arch = r["arch"]
    say(f"[{tag}] {p['layers']} layers of {arch}'s width, kernels vs plain "
        f"attention: every gradient leaf within "
        f"{p['worst_grad_rel_err']:.4g} of its largest (worst "
        f"{p['worst_grad_leaf']}, tolerance {TRAIN_GRAD_TOL:g}); one step's "
        f"loss {p['loss']:.6f} vs {p['plain_loss']:.6f}, grad norm "
        f"{p['grad_norm']:.5f} vs {p['plain_grad_norm']:.5f}")
    if "rounded_worst_grad_leaf" in p:
        say(f"[{tag}] kernels vs the plain attention with the kernel's P "
            f"rounding: every gradient leaf within "
            f"{p['rounded_worst_grad_rel_err']:.4g} of its largest (worst "
            f"{p['rounded_worst_grad_leaf']}); dt_bias "
            f"{p['dt_bias_rounded_grad_rel_err']:.4g} (against plain "
            f"{p['dt_bias_grad_rel_err']:.4g})")
    say(f"[{tag}] {arch} at {r['layers']} of "
        f"{get_config(arch).num_layers} layers: {r['parameters']} "
        f"parameters; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
        f"{r['microbatches']} microbatches; warm-up "
        f"{r['warmup_step_ms']:.1f} ms, then "
        f"{[round(x, 1) for x in r['step_ms']]} ms, {r['tokens_per_s']:.0f} "
        f"tokens/s, {100 * r['bf16_peak_share']:.1f}% of the dense bf16 peak "
        f"({r['flops_per_token'] / 1e9:.2f} GFLOP a token), peak "
        f"{r['peak_bytes'] / 2**30:.2f} GiB on {card}")
    say(f"[{tag}] loss {[round(x, 4) for x in r['loss']]}, grad norm "
        f"{[round(x, 4) for x in r['grad_norm']]}; launches a step "
        f"{r['launches_per_step']['flash_attention_lse']} LSE forwards + "
        f"{r['launches_per_step']['flash_attention_bwd']} backwards, in all "
        f"{r['launches']}")
    pr = r["profile"]
    say(f"[{tag}] one profiled step: wall {pr['wall_ms']:.1f} ms, GPU kernels "
        f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}, flash "
        f"{pr['ported_kernels_ms']:.2f} ms, {pr['host_ops']} torch ops, on "
        f"{card}")
    for kname, ms in pr["top"]:
        say(f"      {ms:8.2f} ms  {kname[:110]}")
    r["profile"] = {k: pr[k] for k in (
        "wall_ms", "device_ms", "busy_share", "ported_kernels_ms", "host_ops",
        "top")}
    say(f"[{tag}] training {secs:.1f} s")


# ---------------------------------------------------------------------------
# phase 23: xLSTM (xlstm-1.3b) uncut; phase 24: the encoder-decoder
# (whisper-base) uncut
# ---------------------------------------------------------------------------


def phase_xlstm(dev, profile) -> dict:
    """Phase 23: xlstm-1.3b at full width and depth serves ``LM_BATCH`` x
    ``LM_PROMPT`` prompts and ``LM_GEN`` greedy tokens through ``generate``
    (``phase_serve``: no kernel launched, finite logits), its serving
    invariant held as the hybrid's (``hybrid_invariant`` at
    ``XLSTM_F32_TOL``), the recurrent states zeroed after the prefill
    moving the bf16 logits by more than 3 ``LM_TOL``; times, peak, one
    traced prefill and 4 traced decode steps. Then trained uncut on the
    pipeline's batches (``phase_train``: a warm-up step and
    ``XLSTM_TRAIN_STEPS`` steps of 8 x 1024 tokens in its 4 microbatches,
    no launch), its first loss within 0.5 of ln(padded vocab)."""
    walls, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        walls[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    model, tokens, gen, counts, peak, init_s, n_params = phase_serve(
        dev, XLSTM_ARCH)
    cfg = model.cfg
    std = float(gen.logits[0][:, :cfg.vocab_size].float().std())
    lost = lost_carry_err(model, tokens, gen.tokens)
    check(lost > 3 * LM_TOL, f"{XLSTM_ARCH}: the states zeroed after the "
          f"prefill move the decode logits by only {lost}")
    lap("serve")
    inv = hybrid_invariant(model, tokens, gen, XLSTM_F32_TOL)
    lap("invariant")
    first = {"prefill_ms": gen.prefill_s * 1e3,
             "decode_ms_per_token": gen.decode_s / (LM_GEN - 1) * 1e3}
    del gen
    times = phase_serve_times(model, tokens)
    lap("times")
    prof = phase_serve_profile(model, tokens)
    del model, tokens
    torch.cuda.empty_cache()
    lap("profile")
    serve = {"arch": XLSTM_ARCH, "layers": cfg.num_layers,
             "parameters": n_params, "init_s": init_s, "batch": LM_BATCH,
             "prompt_len": LM_PROMPT, "gen": LM_GEN, "peak_bytes": peak,
             "launches": counts, "prefill_logit_std": std,
             "lost_carry_max_abs_err": lost, "first_run": first, **inv,
             **times, "profile": prof}
    batches, pipe_ms = train_batches(dev, cfg, XLSTM_TRAIN_STEPS + 2)
    # no profiled step: reading its ~50,000 host ops' trace took most of
    # the phase (PERF.md keeps an earlier trace)
    train = phase_train(dev, batches, None, XLSTM_ARCH, None,
                        XLSTM_TRAIN_STEPS)
    del batches
    torch.cuda.empty_cache()
    lap("train")
    serve["phase_s"] = walls
    want = math.log(cfg.padded_vocab)
    check(abs(train["loss"][0] - want) < 0.5,
          f"{XLSTM_ARCH}'s first loss {train['loss'][0]}, want near {want}")
    return {"serve": serve, "train": {**train, "pipeline_ms": pipe_ms}}


def say_xlstm(r: dict, card: str, secs: float) -> None:
    s, t = r["serve"], r["train"]
    say(f"[23] {XLSTM_ARCH} uncut ({s['layers']} blocks): {s['parameters']} "
        f"parameters drawn in {s['init_s']:.1f} s; {LM_BATCH} x {LM_PROMPT}-"
        f"token prompts, {LM_GEN} greedy tokens; launches {s['launches']}; "
        f"peak {s['peak_bytes'] / 2**30:.2f} GiB; prefill logits' std "
        f"{s['prefill_logit_std']:.4f}, moved {s['lost_carry_max_abs_err']:.4g} "
        f"by the states zeroed after the prefill")
    say(f"[23] bf16 prefill + decode vs one bf16 causal forward "
        f"{s['bf16_serving_vs_bf16_causal']:.4g}; the same weights in fp32: "
        f"prefill + decode vs one causal forward within "
        f"{s['f32_causal_max_abs_err']:.4g} (tolerance {s['f32_tolerance']:g}),"
        f" moved {s['f32_lost_carry_max_abs_err']:.4g} by the states zeroed; "
        f"bf16 serving logits {s['bf16_serving_vs_f32']:.4g} from the fp32 "
        f"causal forward, the bf16 causal forward {s['bf16_causal_vs_f32']:.4g}"
        f" (ratio bound {s['noise_ratio']:g})")
    say(f"[23] first run: prefill {s['first_run']['prefill_ms']:.1f} ms, decode "
        f"{s['first_run']['decode_ms_per_token']:.2f} ms a token; then prefill "
        f"median {s['prefill_ms']:.2f} ms, decode {s['decode_ms_per_token']:.3f}"
        f" ms a token, {s['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{s['end_to_end_tokens_per_s']:.1f} tokens/s end to end on {card}")
    for name, pr in s["profile"].items():
        say(f"[23] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.2f} ms, busy share {pr['busy_share']:.2f}, "
            f"{pr['host_ops']} torch ops dispatched by the host, on {card}")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.3f} ms  {kname[:110]}")
        s["profile"][name] = {k: pr[k] for k in (
            "wall_ms", "device_ms", "busy_share", "host_ops", "top")}
    say(f"[23] trained uncut: {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
        f"{t['microbatches']} microbatches; warm-up {t['warmup_step_ms']:.1f} "
        f"ms, then {[round(x, 1) for x in t['step_ms']]} ms, "
        f"{t['tokens_per_s']:.0f} tokens/s, {100 * t['bf16_peak_share']:.1f}% "
        f"of the dense bf16 peak ({t['flops_per_token'] / 1e9:.2f} GFLOP a "
        f"token), peak {t['peak_bytes'] / 2**30:.2f} GiB on {card}; loss "
        f"{[round(x, 4) for x in t['loss']]}, grad norm "
        f"{[round(x, 4) for x in t['grad_norm']]}; launches {t['launches']}")
    say(f"[23] phase 23 {secs:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in s["phase_s"].items()) + ")")


def whisper_long_prefill(dev) -> dict:
    """Phase 24's prefill at Whisper's own shape: ``LM_BATCH`` x
    ``WHISPER_FRAMES`` random frames and ``WHISPER_TEXT``-token prompts.
    Flash runs the encoder at S 1500 (a partial tail tile) and the
    decoder's self-attention (6 + 6 launches); the cross-attention (448
    queries over 1500 keys) takes the plain einsums. Every logit against
    the plain run (``oracle_scope()``) within ``LM_TOL``; the prefill's
    median ms."""
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens, _ = prompt_inputs(cfg, LM_BATCH, WHISPER_TEXT, 1, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((LM_BATCH, WHISPER_FRAMES, cfg.d_model),
                         generator=g, device=dev)

    def prefill():
        cache = model.init_cache(LM_BATCH, WHISPER_TEXT + LM_GEN,
                                 WHISPER_FRAMES)
        with torch.no_grad():
            return model.forward(tokens=tokens, embeds=frames, cache=cache)[0]

    set_launches(0)
    got = prefill()
    counts = launches()
    want_n = cfg.encoder_layers + cfg.num_layers
    check(counts["flash_attention"] == want_n,
          f"whisper's 1500-frame prefill launched {counts}, want flash "
          f"{want_n} (encoder and decoder self-attention; cross plain)")
    with kops.oracle_scope():
        plain = prefill()
    err = logit_err(got, plain)
    check(bool(torch.isfinite(got).all()) and err <= LM_TOL,
          f"whisper's 1500-frame prefill differs from the plain run by {err}")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        del got
        got = prefill()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    del model, got, plain
    torch.cuda.empty_cache()
    return {"frames": WHISPER_FRAMES, "prompt_len": WHISPER_TEXT,
            "launches": counts, "plain_max_abs_err": err,
            "prefill_ms": statistics.median(walls)}


def phase_whisper(dev, profile) -> dict:
    """Phase 24: whisper-base uncut served as phase 17 serves stablelm-12b
    (``phase_big_serve``: ``LM_BATCH`` x (``LM_PROMPT`` audio frames +
    ``LM_PROMPT``-token prompts), ``LM_GEN`` greedy tokens; flash a prefill
    6 times non-causal in the encoder, 6 causal in the decoder and 6
    non-causal in the cross-attention (as many queries as frames), none in
    a decode step; logits within ``LM_TOL`` of the plain run and of one
    causal forward; a bidirectional mask and, apart, a causal mask in the
    encoder each moving the prefill logits by more than 3 ``LM_TOL``);
    the prefill at Whisper's own shape (``whisper_long_prefill``); then
    trained uncut, 8 x 1024 tokens with 8 x 1024 random frames a step in
    its 1 microbatch: kernels against ``oracle_scope()`` at 2 encoder and 2
    decoder blocks with phase 16's tolerances (argued for 2 layers, as
    every arch's), the gradients' rounding account at 6 + 6 blocks
    (``grad_rounding_account``), a warm-up step and 2 steps of 36 LSE forwards
    and 18 backwards each (the flash launches a step are a gate), finite
    losses, one profiled step."""
    t0 = time.perf_counter()
    serve = phase_big_serve(dev, profile=True, arch=WHISPER_ARCH)
    serve_s = time.perf_counter() - t0
    long = whisper_long_prefill(dev)
    t0 = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    batches, pipe_ms = train_batches(dev, cfg, BIG_TRAIN_STEPS + 2)
    g = torch.Generator(device=dev).manual_seed(2)
    for b in batches:
        b["embeds"] = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                                  generator=g, device=dev)
    plain = phase_train_plain(dev, batches[0], WHISPER_ARCH, cfg.replace(
        num_layers=TRAIN_PLAIN_LAYERS, encoder_layers=TRAIN_PLAIN_LAYERS))
    torch.cuda.empty_cache()
    account = grad_rounding_account(dev, batches[0], WHISPER_ARCH)
    train = phase_train(dev, batches, profile, WHISPER_ARCH, None,
                        BIG_TRAIN_STEPS)
    del batches
    torch.cuda.empty_cache()
    return {"serve": serve, "long_prefill": long, "serve_s": serve_s,
            "train_s": time.perf_counter() - t0,
            "train": {**train, "pipeline_ms": pipe_ms, "plain": plain},
            "grad_account": account}


# ---------------------------------------------------------------------------
# phases 21-22: the Mamba2 hybrid (zamba2-1.2b) and the VLM front
# (internvl2-76b)
# ---------------------------------------------------------------------------


def phase_vlm_tiny_train(dev) -> dict:
    """Phase 22's loss over embeds, at internvl2-76b's TINY widths: a batch
    of ``VLM_TINY_BATCH`` rows of 8 random front embeddings and
    ``VLM_TINY_SEQ`` tokens with per-row weights (numpy, seeded), its loss
    over the text tokens only (the front rows' logits dropped) and every
    gradient leaf through the kernels against ``oracle_scope()``, then one
    train step of each, in its 16 microbatches (``phase_train_plain``,
    phase 16's tolerances, ``train_launches``' launches). The embeds must
    reach the loss: ``front_proj``'s gradient is not zero and the loss
    without them differs."""
    cfg = get_tiny(VLM_ARCH)
    rng = np.random.default_rng(22)
    b, s, nf = VLM_TINY_BATCH, VLM_TINY_SEQ, cfg.num_frontend_tokens
    batch = {
        "tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s))
                                   .astype(np.int32)).to(dev),
        "weight": torch.from_numpy(rng.uniform(0.5, 2.0, b)
                                   .astype(np.float32)).to(dev),
        "embeds": torch.from_numpy(rng.standard_normal((b, nf, cfg.d_model))
                                   .astype(np.float32)).to(dev)}
    plain = phase_train_plain(dev, batch, VLM_ARCH, cfg)
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    state = TS.bind_state(model)
    grads, m = TS._accumulate_grads(model, state.params, batch, 1)
    front = float(grads["front_proj"].abs().max())
    with torch.no_grad():
        text_only = float(model.loss_fn({k: v for k, v in batch.items()
                                         if k != "embeds"})[0])
    check(front > 0 and abs(text_only - float(m["loss"])) > 1e-4,
          f"the embeds do not reach the loss: front_proj's gradient "
          f"{front}, loss {float(m['loss'])} with them, {text_only} without")
    return {**plain, "arch": VLM_ARCH, "batch": b, "seq": s, "front_rows": nf,
            "front_proj_grad_max": front, "loss_with_embeds": float(m["loss"]),
            "loss_text_only": text_only,
            "launches_per_step": train_launches(cfg, train_microbatches(VLM_ARCH))}


# ---------------------------------------------------------------------------
# phase 25: the reference's mesh as virtual axes on the card (seq-sharded
# decodes, pod compression, remat="dots", the launchers' mesh flags)
# ---------------------------------------------------------------------------


def decode_profile(model, tokens, steps: int = 8) -> dict:
    """One prefill (unprofiled), then ``steps`` decode steps profiled: the
    device's busy share and the host's torch ops a step."""
    prefill = make_prefill_step(model, tokens.shape[1] + LM_GEN)
    decode = make_decode_step(model)
    with torch.no_grad():
        logits, cache = prefill({"tokens": tokens})
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    del logits

    def run_decode():
        t = tok
        with torch.no_grad():
            for i in range(steps):
                out, _ = decode(cache, t, tokens.shape[1] + i)
                t = torch.argmax(out, -1)[:, None].to(torch.int32)

    pr = profiled("decode", run_decode)
    del cache
    return {"wall_ms_per_step": pr["wall_ms"] / steps,
            "device_ms_per_step": pr["device_ms"] / steps,
            "busy_share": pr["busy_share"],
            "host_ops_per_step": pr["host_ops"] / steps,
            "top": pr["top"][:4]}


def sharded_decode(model, tokens, mesh, tol: float = LM_TOL,
                   profile: bool = True) -> dict:
    """Phase 25 (a)/(b): ``generate`` with the model on ``mesh`` (the decode
    cache split on T over its shards) against the one-device decode on the
    same weights, teacher-forced with its tokens. The counts zeroed just
    before and read just after the sharded run: flash once an attention
    layer (the prefill, which the mesh leaves whole), no other kernel; the
    merges 2 psum + 1 pmax a layer a decode step. Prefill logits equal bit
    for bit; every decode step's within ``tol``. Decode ms a token of the
    two runs, and with ``profile`` 4 traced decode steps of each (busy
    share, host ops a step)."""
    cfg = model.cfg
    s, layers = tokens.shape[1], cfg.num_layers
    model.mesh = None
    base = generate(model, tokens, LM_GEN, keep_logits=True)
    model.mesh = mesh
    mesh.reset_counts()
    set_launches(0)
    shard = generate(model, tokens, LM_GEN, keep_logits=True,
                     forced=base.tokens)
    counts, merges = launches(), dict(mesh.counts)
    want_merges = {"psum": 2 * layers * (LM_GEN - 1),
                   "pmax": layers * (LM_GEN - 1)}
    check(counts == {**ZERO_LAUNCHES, "flash_attention": attn_layers(cfg)},
          f"sharded generate launched {counts}")
    check(merges == want_merges, f"sharded decode merged {merges}, want "
          f"{want_merges}")
    check(all(bool(torch.isfinite(x).all()) for x in shard.logits),
          "non-finite sharded decode logits")
    errs = [logit_err(a, b) for a, b in zip(base.logits, shard.logits)]
    check(errs[0] == 0.0, f"the prefill moved by {errs[0]} on the mesh")
    check(max(errs) <= tol, f"sharded decode logits differ from the "
          f"one-device decode's by {max(errs)} (tolerance {tol})")
    same = int((base.tokens == shard.tokens).sum())
    ms = {name: g.decode_s / (LM_GEN - 1) * 1e3
          for name, g in (("one_device", base), ("sharded", shard))}
    del base, shard
    prof = {}
    if profile:
        for name, m in (("one_device", None), ("sharded", mesh)):
            model.mesh = m
            prof[name] = decode_profile(model, tokens, steps=4)
    model.mesh = None
    return {"prompt_len": s, "cache_rows": s + LM_GEN,
            "shards": mesh.view(("model",)).axis_size,
            "launches": counts, "merges_per_step": {
                k: v // (LM_GEN - 1) for k, v in merges.items()},
            "max_abs_err": max(errs), "err_by_step": errs, "tolerance": tol,
            "same_greedy_tokens": same, "tokens": LM_BATCH * LM_GEN,
            "decode_ms_per_token": ms, "profile": prof}


def phase_seq_shard_gqa(model, tokens, long_prompt: int = LONG_PROMPT,
                        profile: bool = True) -> dict:
    """Phase 25 (a): phase 8's llama3-8b over ``make_local_mesh(8,
    model=8)``: the batch divides the data axis (1), so the cache splits 8
    ways on T over the model axis; at LM_PROMPT, then once at a
    ``long_prompt`` prompt (4 x 8192: a cache of 8224 rows, 4.3 GB of K/V)."""
    mesh = make_local_mesh(SHARD_DEVICES, model=SHARD_DEVICES)
    out = {"mesh": mesh.shape,
           "prompt": sharded_decode(model, tokens, mesh, profile=profile)}
    torch.cuda.empty_cache()
    long_tokens, _ = prompt_inputs(model.cfg, LM_BATCH, long_prompt, 1,
                                   tokens.device)
    torch.cuda.reset_peak_memory_stats()
    out["long_prompt"] = sharded_decode(model, long_tokens, mesh,
                                        profile=profile)
    out["long_prompt"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return out


def phase_seq_shard_mla(dev, arch: str = MLA_ARCH, profile: bool = True
                        ) -> dict:
    """Phase 25 (b): minicpm3-4b at full size with ``mla_seq_shard`` over
    ``make_local_mesh(8, model=8)``: the latent caches split 8 ways on T,
    each shard's latent context merged, W_uv after the merge; against the
    absorbed one-device decode on the same weights."""
    cfg = get_config(arch).replace(mla_seq_shard=True)
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    tokens, _ = serve_inputs(cfg, dev)
    mesh = make_local_mesh(SHARD_DEVICES, model=SHARD_DEVICES)
    out = sharded_decode(model, tokens, mesh, profile=profile)
    del model
    torch.cuda.empty_cache()
    return out


def mm_calls(call) -> int:
    """The ``aten.mm``/``aten.addmm`` products ``call`` runs, counted by a
    dispatch mode outside the remat policy's (a kept product the backward
    takes back from the policy is not run, so not counted; autograd carries
    the mode to its device thread)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in saved
            return func(*args, **(kwargs or {}))

    with Count():
        call()
    return Count.n


def set_remat(model, remat: str) -> None:
    model.cfg = model.lm.cfg = model.cfg.replace(remat=remat)


def remat_dots_check(model, batch, k: int) -> dict:
    """Phase 25 (d): one step's gradients (the train step's
    ``_accumulate_grads``, in its k microbatches) from one state under
    ``remat="full"`` twice and under ``"dots"``, with deterministic
    algorithms on (phase 16's crash-resume setting). The loss equal; each
    leaf bit for bit where the two "full" runs agree bit for bit, else
    within twice their distance (printed); the flash launches equal (the
    attention recomputed under both); the products run a step (``mm_calls``:
    fewer under "dots", whose kept x·W outputs the backward does not run
    again); gradient ms (forward and backward; "dots" run twice, the same
    bits) and the peak each run adds over what is held (the parameters and
    the earlier runs' gradients)."""
    params = dict(model.lm.named_parameters())
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for tag, remat in (("full", "full"), ("full_again", "full"),
                           ("dots", "dots"), ("dots_again", "dots")):
            set_remat(model, remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            set_launches(0)
            t0 = time.perf_counter()
            grads, met = TS._accumulate_grads(model, params, batch, k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            runs[tag] = {"grads": grads, "loss": float(met["loss"]), "ms": ms,
                         "launches": launches(), "peak_over_held_bytes":
                         torch.cuda.max_memory_allocated() - held}
            if tag == "dots_again":
                check(all(torch.equal(g, runs["dots"]["grads"][n])
                          for n, g in grads.items()),
                      "remat dots: two runs differ")
                del runs[tag]["grads"], grads
            elif tag != "full_again":
                runs[tag]["mm_calls"] = mm_calls(
                    lambda: TS._accumulate_grads(model, params, batch, k))
    finally:
        torch.use_deterministic_algorithms(False)
        set_remat(model, "full")
    full, again, dots = (runs[t].pop("grads") for t in
                         ("full", "full_again", "dots"))
    check(runs["dots"]["loss"] == runs["full"]["loss"],
          f"remat dots loss {runs['dots']['loss']} != full "
          f"{runs['full']['loss']}")
    noisy, worst = {}, 0.0
    for n, g in full.items():
        if torch.equal(g, again[n]):
            check(torch.equal(dots[n], g), f"remat dots: gradient {n} differs "
                  f"from full, whose two runs agree bit for bit")
        else:
            dist = float((g - again[n]).abs().max())
            got = float((dots[n] - g).abs().max())
            noisy[n] = {"full_vs_full": dist, "dots_vs_full": got}
            check(got <= 2 * dist, f"remat dots: gradient {n} {got} from "
                  f"full, two full runs {dist} apart")
            worst = max(worst, got)
    check(runs["dots"]["launches"] == runs["full"]["launches"],
          f"remat dots launched {runs['dots']['launches']}, full "
          f"{runs['full']['launches']}")
    check(runs["dots"]["mm_calls"] < runs["full"]["mm_calls"],
          f"remat dots ran {runs['dots']['mm_calls']} products, full "
          f"{runs['full']['mm_calls']}")
    del full, again, dots
    return {"leaves": len(params), "bitwise_leaves": len(params) - len(noisy),
            "nondeterministic_leaves": noisy, **runs}


def pod_train_check(model, batches, k: int, steps: int = POD_STEPS) -> dict:
    """Phase 25 (c): ``steps`` exact train steps and ``steps`` compressed
    ones (``compress_pod=True``: each of the mesh's 2 pods takes its half of
    the batch in k microbatches, int8 gradients with error feedback) from
    one state (``init_train_state(model, 0)`` both times), on the same
    batches. The launches a step (``train_launches`` of the microbatches
    run: k for the exact step, k a pod for the compressed one), losses
    finite and within ``POD_LOSS_TOL`` step by step, the largest parameter
    difference after them under ``POD_PARAM_TOL``, the residuals finite
    and nonzero; step ms and peak GiB of each."""
    cfg = model.cfg
    pods = model.mesh.axis_size("pod")
    ocfg = OptConfig(**TRAIN_OPT)
    out = {}
    for tag, compress in (("exact", False), ("compressed", True)):
        state = TS.init_train_state(model, 0, compress_pod=compress,
                                    n_pods=pods)
        step = TS.make_train_step(model, ocfg, microbatches=k,
                                  compress_pod=compress)
        want = train_launches(cfg, k * (pods if compress else 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for i in range(steps):
            set_launches(0)
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))  # synchronises
            walls.append((time.perf_counter() - t0) * 1e3)
            got = launches()
            check(got == want, f"{tag} step {i} launched {got}, want {want}")
        out[tag] = {"loss": losses, "step_ms": walls,
                    "launches_per_step": want,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
        if compress:
            check(all(bool(torch.isfinite(e).all()) for e in state.ef.values()),
                  "non-finite pod residuals")
            out[tag]["ef_max_abs"] = max(float(e.abs().max())
                                         for e in state.ef.values())
            check(out[tag]["ef_max_abs"] > 0, "the pod residuals stayed zero")
            diff = max(float((p.float() - exact[n].float()).abs().max())
                       for n, p in state.params.items())
        else:
            exact = {n: p.detach().clone() for n, p in state.params.items()}
        del state, step
        torch.cuda.empty_cache()
    losses = list(zip(out["exact"]["loss"], out["compressed"]["loss"]))
    check(all(math.isfinite(a) and math.isfinite(b) and abs(a - b)
              <= POD_LOSS_TOL for a, b in losses),
          f"compressed losses {out['compressed']['loss']} against exact "
          f"{out['exact']['loss']} (tolerance {POD_LOSS_TOL})")
    check(diff < POD_PARAM_TOL, f"compressed parameters {diff} from the "
          f"exact run's (tolerance {POD_PARAM_TOL})")
    return {**out, "max_param_diff": diff, "pods": pods}


def phase_pod_and_dots(dev, arch: str = TRAIN_ARCH,
                       layers: int = POD_LAYERS, batches=None) -> dict:
    """Phase 25 (c) and (d) on one model: ``arch`` at full width and
    ``layers`` layers over ``make_local_mesh(8, model=2, pod=2)`` (the
    mesh leaves the dense arithmetic as it is; only compress_pod reads its
    pod axis), the reference's microbatches, phase 16's batches."""
    cfg = get_config(arch).replace(num_layers=layers)
    k = train_microbatches(arch)
    mesh = make_local_mesh(SHARD_DEVICES, model=2, pod=2)
    model = build_model(cfg, dev, mesh=mesh,
                        generator=torch.Generator(device=dev).manual_seed(0))
    if batches is None:
        batches, _ = train_batches(dev, cfg, POD_STEPS)
    n_params = sum(p.numel() for p in model.parameters())
    dots = remat_dots_check(model, batches[0], k)
    torch.cuda.empty_cache()
    pod = pod_train_check(model, batches, k)
    del model
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": layers, "parameters": n_params,
            "microbatches": k, "mesh": mesh.shape, "remat_dots": dots,
            "compress_pod": pod}


def phase_mesh_launchers(dev) -> dict:
    """Phase 25 (e): the launchers' mesh flags, in process on the card and
    with ``--device cpu``: ``serve --tiny`` of ``MESH_SERVE_ARCHS`` with
    ``MESH_SERVE_FLAGS`` (the decode cache split 8 ways; the MoE arch's
    prefill through the expert-parallel path and its decode through the
    psum path over the model axis, each shard's dispatch counted by
    bucket_histogram) and ``train --tiny --steps 3`` of granite-3-2b with
    ``MESH_TRAIN_FLAGS`` (pod compression). Serving: the prefill's logits
    within ``LM_TOL`` of the CPU run's, and each decode step's wherever the
    two runs' earlier tokens agree; training: each step's loss within
    ``TINY_LOSS_TOL``. The MoE arch's CPU run follows the card run's routes
    (``RouteTap``)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    out = {"serve": {}, "train": {}}
    shards = int(MESH_SERVE_FLAGS[-1])
    for arch in MESH_SERVE_ARCHS:
        cfg = get_tiny(arch)
        argv = ["--arch", arch, "--tiny", *MESH_SERVE_FLAGS]
        set_launches(0)
        tap = RouteTap()
        with tap.record():
            card = serve_cli.main(argv)
        counts = launches()
        gen = card.tokens.shape[1]
        hist = cfg.num_layers * shards * gen if cfg.moe_num_experts else 0
        check(counts == {**ZERO_LAUNCHES, "flash_attention": attn_layers(cfg),
                         "bucket_histogram": hist},
              f"serve {' '.join(argv)} launched {counts}, want flash "
              f"{attn_layers(cfg)} and bucket_histogram {hist}")
        with tap.follow(tap.calls):
            cpu = serve_cli.main(argv + ["--device", "cpu"])
        check(tap.share <= MOE_FLIP_SHARE, f"serve {arch} on the mesh: "
              f"{tap.flips} of {tap.routes} routes differ from the card's")
        agree = torch.cumprod((card.tokens.cpu() == cpu.tokens).int(), 1)
        errs = [logit_err(card.logits[0].cpu(), cpu.logits[0])]
        for i, (a, b) in enumerate(zip(card.logits[1:], cpu.logits[1:])):
            rows = agree[:, i].bool()  # tokens 0..i equal: step i comparable
            if bool(rows.any()):
                errs.append(logit_err(a.cpu()[rows], b[rows]))
        check(max(errs) <= LM_TOL, f"serve {arch} on the mesh: logits differ "
              f"from the --device cpu run's by {max(errs)}")
        out["serve"][arch] = {"launches": counts, "max_abs_err": max(errs),
                              "steps_compared": len(errs),
                              "same_tokens": int((card.tokens.cpu()
                                                  == cpu.tokens).sum()),
                              "tokens": card.tokens.numel(),
                              "route_flips": tap.flips, "routes": tap.routes}
    arch = TRAIN_ARCH
    cfg = get_tiny(arch)
    argv = ["--arch", arch, "--tiny", "--steps", str(TINY_TRAIN_STEPS),
            "--log-every", "1", *MESH_TRAIN_FLAGS]
    pods = int(MESH_TRAIN_FLAGS[MESH_TRAIN_FLAGS.index("--pod-axis") + 1])
    want = train_launches(cfg, pods)
    set_launches(0)
    card = train_cli.main(argv)
    counts = launches()
    check(all(counts[n] == TINY_TRAIN_STEPS * want[n]
              for n in LM_KERNELS + ("bucket_histogram",)),
          f"train {' '.join(argv)} launched {counts}, want {TINY_TRAIN_STEPS}"
          f" x {want} of the LM kernels")
    cpu = train_cli.main(argv + ["--device", "cpu"])
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(card, cpu)]
    check(len(card) == len(cpu) == TINY_TRAIN_STEPS and
          all(math.isfinite(x["loss"]) for x in card) and
          max(diffs) <= TINY_LOSS_TOL,
          f"train {' '.join(argv)}: losses {[x['loss'] for x in card]} on "
          f"the card, {[x['loss'] for x in cpu]} on the CPU")
    out["train"][arch] = {"launches": counts,
                          "loss": [x["loss"] for x in card],
                          "cpu_loss": [x["loss"] for x in cpu],
                          "max_loss_diff": max(diffs)}
    return out


def say_seq_shard(tag: str, arch: str, r: dict, card: str) -> None:
    ms = r["decode_ms_per_token"]
    say(f"[25{tag}] {arch}, {LM_BATCH} x {r['prompt_len']}-token prompts, "
        f"{LM_GEN} tokens, cache {r['cache_rows']} rows split {r['shards']} "
        f"ways: logits within {r['max_abs_err']:.4g} of the one-device "
        f"decode (tolerance {r['tolerance']}), greedy tokens equal on "
        f"{r['same_greedy_tokens']} of {r['tokens']}; merges a step "
        f"{r['merges_per_step']}; launches {r['launches']}")
    say(f"[25{tag}] decode ms a token: one device {ms['one_device']:.3f}, "
        f"sharded {ms['sharded']:.3f} on {card}")
    for name, pr in r["profile"].items():
        say(f"[25{tag}] {name} decode, 4 traced steps: "
            f"{pr['wall_ms_per_step']:.2f} ms a step (profiled), GPU kernels "
            f"{pr['device_ms_per_step']:.2f} ms, busy share "
            f"{pr['busy_share']:.2f}, {pr['host_ops_per_step']:.0f} host ops "
            f"a step; top {[(k[:60], round(v, 3)) for k, v in pr['top']]}")


def say_pod_and_dots(r: dict, card: str) -> None:
    d, p = r["remat_dots"], r["compress_pod"]
    say(f"[25d] {r['arch']} at {r['layers']} layers ({r['parameters']} "
        f"parameters), {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{r['microbatches']} microbatches: remat dots loss "
        f"{d['dots']['loss']:.6f} = full {d['full']['loss']:.6f}; "
        f"{d['bitwise_leaves']} of {d['leaves']} gradient leaves bit for bit "
        f"(nondeterministic in two full runs: {d['nondeterministic_leaves']})"
        f"; flash launches {d['dots']['launches']['flash_attention_lse']} LSE "
        f"+ {d['dots']['launches']['flash_attention_bwd']} backwards under "
        f"both; products (mm) run a step: full {d['full']['mm_calls']}, dots "
        f"{d['dots']['mm_calls']}")
    say(f"[25d] gradient ms (forward + backward): full {d['full']['ms']:.1f} "
        f"/ {d['full_again']['ms']:.1f}, dots {d['dots']['ms']:.1f} / "
        f"{d['dots_again']['ms']:.1f}; peak GiB over what is held: full "
        f"{d['full']['peak_over_held_bytes'] / 2**30:.2f}, dots "
        f"{d['dots']['peak_over_held_bytes'] / 2**30:.2f} on {card}")
    e, c = p["exact"], p["compressed"]
    say(f"[25c] compress_pod on {r['mesh']}: losses "
        f"{[round(x, 5) for x in c['loss']]} vs exact "
        f"{[round(x, 5) for x in e['loss']]}; largest parameter difference "
        f"{p['max_param_diff']:.4g} (tolerance {POD_PARAM_TOL}); residuals up "
        f"to {c['ef_max_abs']:.4g}; flash a step "
        f"{c['launches_per_step']['flash_attention_lse']} LSE + "
        f"{c['launches_per_step']['flash_attention_bwd']} backwards "
        f"(exact {e['launches_per_step']['flash_attention_lse']} + "
        f"{e['launches_per_step']['flash_attention_bwd']}: "
        f"{r['microbatches']} microbatches a pod)")
    say(f"[25c] step ms compressed {[round(x, 1) for x in c['step_ms']]}, "
        f"exact {[round(x, 1) for x in e['step_ms']]}; peak GiB compressed "
        f"{c['peak_bytes'] / 2**30:.2f}, exact {e['peak_bytes'] / 2**30:.2f} "
        f"on {card}")


def phase_roofs(dev) -> dict:
    """(a) The card's roofs: a bf16 ``ROOF_N``^3 ``torch.matmul`` (FLOP/s)
    and a ``ROOF_COPY``-byte device copy (bytes read and written per s),
    each the median of CUDA-event timings after a warm-up."""
    timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(26)
    a, b = (torch.randn((ROOF_N, ROOF_N), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mm_ms = timer(lambda: torch.matmul(a, b), reps=10)
    del a, b
    src = torch.empty(ROOF_COPY, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = timer(lambda: dst.copy_(src), reps=10)
    del src, dst
    torch.cuda.empty_cache()
    return {"matmul_ms": mm_ms, "copy_ms": copy_ms,
            "flops_per_s": 2.0 * ROOF_N ** 3 / (mm_ms / 1e3),
            "bytes_per_s": 2.0 * ROOF_COPY / (copy_ms / 1e3),
            "datasheet_flops_per_s": TENSOR_BF16_OPS_PER_S,
            "datasheet_bytes_per_s": HBM_BYTES_PER_S}


def phase_cells(dev, roofs: dict) -> dict:
    """(b) ``measure_cell`` on each of ``CELL_RUNS`` at its first depth
    pair, the launch counts zeroed just before and read just after: each
    kernel launched its meta count's calls times the steps run, and the
    cell's kernels (``CELL_KERNELS``) at least once; each depth's last
    timed step's loss (train) or logits finite."""
    out = {}
    for arch, shape, mb, reps in CELL_RUNS:
        cfg = get_config(arch)
        depths = DRY._depth_pairs(cfg)[0][1]
        t0 = time.perf_counter()
        set_launches(0)
        r = DRY.measure_cell(cfg, shape, "cuda", depths, reps=reps,
                             roofs=(roofs["flops_per_s"],
                                    roofs["bytes_per_s"]), microbatches=mb)
        got = launches()
        want = dict(ZERO_LAUNCHES)
        for d in r["per_depth"]:
            for name, n in d["kernel_calls"].items():
                want[name] += n * d["runs"]
        key = f"{arch}/{shape}"
        check(got == want, f"{key}: launches {got}, the meta count says {want}")
        check({n for n, v in got.items() if v} == CELL_KERNELS[key],
              f"{key} launched {got}")
        for d in r["per_depth"]:
            what = "logits" if d["loss"] is None else f"loss {d['loss']}"
            check(d["finite"], f"{key} at depth {d['depth']}: the measured "
                  f"step's {what} not finite")
        r["launches"] = {n: v for n, v in got.items() if v}
        r["seconds"] = time.perf_counter() - t0
        out[key] = r
        torch.cuda.empty_cache()
    return out


def long_rows_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The largest |got - want| and ||got - want|| / ||want|| over rows."""
    diff = got.float() - want
    return {"max_abs": float(diff.abs().max()),
            "rel": float(diff.norm() / want.norm())}


def long_rows_ok(e: dict) -> bool:
    return e["max_abs"] <= LONG_LAST_ATOL and e["rel"] <= LONG_LAST_RTOL


def flash_long_check(dev, timer) -> dict:
    """Flash at llama3-8b's prefill_32k layer (B 2, S 32768, 32/8 heads of
    128, causal): its last ``LONG_ROWS`` query rows against the plain
    attention over all 32768 keys in fp32 (``LONG_LAST_ATOL``,
    ``LONG_LAST_RTOL``; two planted faults must fail them: zeros, and the
    plain attention over the first S/2 keys alone), its first against
    ``attention_ref`` over the first rows (``LM_TOL``); its time and bound,
    and ``F.scaled_dot_product_attention``'s time on the same inputs
    (``library_ms``; math's backend, which would hold ~137 GB of scores,
    left out). Comparison launches, outside any counted window."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    cfg = get_config("llama3-8b")
    b, s = 2, SHAPES["prefill_32k"].seq_len
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(32)
    q, k, v = (torch.randn((b, s, n, hd), generator=g, device=dev,
                           dtype=torch.bfloat16) for n in (h, kv, kv))
    out = flash_attention(q, k, v, causal=True)
    qs = q[:, s - LONG_ROWS:].float()
    kr = k.repeat_interleave(h // kv, dim=2).float()
    scores = torch.einsum("bshd,bthd->bhst", qs, kr) / math.sqrt(hd)
    del kr
    rows = torch.arange(s - LONG_ROWS, s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None]
    p = torch.softmax(scores.masked_fill(cols > rows, float("-inf")), dim=-1)
    p_half = torch.softmax(scores.masked_fill(cols >= s // 2, float("-inf")),
                           dim=-1)
    del scores
    vr = v.repeat_interleave(h // kv, dim=2).float()
    want = torch.einsum("bhst,bthd->bshd", p, vr)
    half = torch.einsum("bhst,bthd->bshd", p_half, vr)
    del p, p_half, vr
    last = long_rows_errors(out[:, s - LONG_ROWS:], want)
    first = float((out[:, :LONG_ROWS].float() - ref.attention_ref(
        q[:, :LONG_ROWS], k[:, :LONG_ROWS], v[:, :LONG_ROWS]).float()
                   ).abs().max())
    check(long_rows_ok(last) and first <= LM_TOL,
          f"flash at S {s}: last rows {last} from the plain attention "
          f"(limits {LONG_LAST_ATOL}, {LONG_LAST_RTOL}), first rows {first} "
          f"(tolerance {LM_TOL})")
    planted = {"zeros": long_rows_errors(torch.zeros_like(want), want),
               "first_half_keys": long_rows_errors(half.bfloat16(), want)}
    check(not any(long_rows_ok(e) for e in planted.values()),
          f"flash at S {s}: a planted fault passes the last rows' check "
          f"({planted})")
    ms = timer(lambda: flash_attention(q, k, v, causal=True), reps=5)
    bms, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel()),
                       2 * b * h * 2 * hd * attn_pairs(s, True),
                       TENSOR_BF16_OPS_PER_S)
    # the port never calls SDPA: it is timed here as the yardstick
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def lib_fwd():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

    lib_out, lib_error = library_call(lib_fwd)
    res = {"shape": dict(B=b, S=s, H=h, KV=kv, hd=hd),
           "last_rows": last, "first_rows_err": first, "planted": planted,
           "ms": ms, "bound_ms": bms, "bound_by": by,
           "library_ms": None if lib_out is None else timer(lib_fwd, reps=5),
           "library_backend": None if lib_out is None else sdpa_backend(
               lib_fwd),
           "library_last_rows": None if lib_out is None else long_rows_errors(
               lib_out.transpose(1, 2)[:, s - LONG_ROWS:], want)}
    if lib_error is not None:
        res["library_error"] = lib_error
    del q, k, v, qt, kt, vt, out, want, half, lib_out
    torch.cuda.empty_cache()
    return res


def full_depth_check(dev, cells: dict, roofs: dict) -> dict:
    """(c) minicpm3-4b's decode_32k at full depth: its step's wall against
    the line through depths 1 and 2, the three steps timed in turns (a step
    of each a round, ``FULL_DEPTH_ROUNDS`` rounds, medians), and its peak
    against (b)'s extrapolation. The wall time is the host's, whose pace
    drifts within a run: depths timed a second or a minute apart, as (b)'s
    are, have read 8% to 49% off the line."""
    cfg = get_config("minicpm3-4b")
    ext = cells["minicpm3-4b/decode_32k"]
    reps = next(r for a, sh, _, r in CELL_RUNS
                if (a, sh) == ("minicpm3-4b", "decode_32k"))
    mesh = DRY.shard_mesh()
    set_launches(0)
    full = DRY.time_cell(cfg, "decode_32k", mesh, "cuda", rows=ext["rows"],
                         reps=reps, roofs=(roofs["flops_per_s"],
                                           roofs["bytes_per_s"]))
    torch.cuda.empty_cache()
    depths = (*DRY._depth_pairs(cfg)[0][1], cfg.num_layers)
    runs = {d: DRY.make_cell(DRY.at_depth(cfg, d), "decode_32k", mesh, dev,
                             rows=ext["rows"])[1:3] for d in depths}
    walls = {d: [] for d in depths}
    for step, args in runs.values():
        step(*args)
    torch.cuda.synchronize()
    for _ in range(FULL_DEPTH_ROUNDS):
        for d, (step, args) in runs.items():
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            walls[d].append((time.perf_counter() - t0) * 1e3)
    check(launches() == ZERO_LAUNCHES, f"the absorbed decode launched "
          f"{launches()}")
    del runs
    torch.cuda.empty_cache()
    med = {d: statistics.median(w) for d, w in walls.items()}
    d1, d2, dl = depths
    line = med[d1] + (med[d2] - med[d1]) * (dl - d1) / (d2 - d1)
    at = {**ext["at_full_depth"], "wall_ms": line}
    full = {**full, "wall_ms": med[dl]}
    wall_err = abs(full["wall_ms"] - at["wall_ms"]) / at["wall_ms"]
    peak_err = abs(full["peak_bytes"] - at["peak_bytes"]) / at["peak_bytes"]
    check(wall_err <= FULL_DEPTH_WALL_TOL and peak_err <= FULL_DEPTH_PEAK_TOL,
          f"minicpm3-4b decode at {cfg.num_layers} layers: wall "
          f"{full['wall_ms']:.1f} ms vs {at['wall_ms']:.1f} extrapolated "
          f"({wall_err:.3f}), peak {full['peak_bytes'] / 2**30:.2f} GiB vs "
          f"{at['peak_bytes'] / 2**30:.2f} ({peak_err:.3f})")
    torch.cuda.empty_cache()
    return {"measured": full, "extrapolated": at, "wall_rel_err": wall_err,
            "peak_rel_err": peak_err, "in_turns_ms": med}


def say_cells(r: dict, card: str) -> None:
    ro = r["roofs"]
    say(f"[26a] roofs on {card}: bf16 {ROOF_N}^3 matmul {ro['matmul_ms']:.3f} "
        f"ms = {ro['flops_per_s'] / 1e12:.1f} TFLOP/s (datasheet "
        f"{ro['datasheet_flops_per_s'] / 1e12:.0f}); {ROOF_COPY >> 30} GiB "
        f"copy {ro['copy_ms']:.3f} ms = {ro['bytes_per_s'] / 1e12:.3f} TB/s "
        f"read + written (datasheet {ro['datasheet_bytes_per_s'] / 1e12:.2f})")
    for key, c in r["cells"].items():
        f = c["at_full_depth"]
        depth = ", ".join(
            f"depth {d['depth']}: wall {d['wall_ms']:.1f} ms, device "
            f"{d['device_ms']:.1f} ms, peak {d['peak_bytes'] / 2**30:.2f} GiB, "
            f"bound {d['bound_ms']:.2f} ms (datasheet "
            f"{d['datasheet_bound_ms']:.2f}), "
            + ("logits finite" if d["loss"] is None else
               f"loss {d['loss']:.4f}") for d in c["per_depth"])
        say(f"[26b] {key}, {c['rows']} rows (one data shard of 16) in "
            f"{c['microbatches']} microbatches, model axis 16: {depth}; "
            f"extrapolated to {c['full_depth']} layers, not run: wall "
            f"{f['wall_ms']:.1f} ms, device {f['device_ms']:.1f} ms, peak "
            f"{f['peak_bytes'] / 2**30:.2f} GiB, bound {f['bound_ms']:.2f} ms "
            f"= {100 * f['bound_ms'] / f['wall_ms']:.1f}% of wall (measured "
            f"roofs), {f['datasheet_bound_ms']:.2f} ms = "
            f"{100 * f['datasheet_bound_ms'] / f['wall_ms']:.1f}% (datasheet "
            f"roofs; bytes as eager PyTorch moves them); launches "
            f"{c['launches']} ({c['seconds']:.1f} s) on {card}")
    fl = r["flash_32k"]
    lib = ("SDPA refused it: " + fl["library_error"]
           if fl["library_ms"] is None else
           f"SDPA ({fl['library_backend']}) {fl['library_ms']:.3f} ms, its "
           f"last rows within {fl['library_last_rows']['max_abs']:.4g} "
           f"(||diff|| / ||plain|| {fl['library_last_rows']['rel']:.3g})")
    pl = fl["planted"]
    say(f"[26b] flash at S {fl['shape']['S']} (B {fl['shape']['B']}, "
        f"{fl['shape']['H']}/{fl['shape']['KV']} heads of {fl['shape']['hd']}"
        f"): last {LONG_ROWS} rows within {fl['last_rows']['max_abs']:.4g} "
        f"(limit {LONG_LAST_ATOL:g}), ||diff|| / ||plain|| "
        f"{fl['last_rows']['rel']:.3g} (limit {LONG_LAST_RTOL:g}); planted "
        f"zeros {pl['zeros']['max_abs']:.4g} / {pl['zeros']['rel']:.3g}, "
        f"keys past S/2 skipped {pl['first_half_keys']['max_abs']:.4g} / "
        f"{pl['first_half_keys']['rel']:.3g}, both failing; first rows "
        f"within {fl['first_rows_err']:.4g} (tolerance {LM_TOL}); "
        f"{fl['ms']:.3f} ms, bound {fl['bound_ms']:.3f} ms by "
        f"{fl['bound_by']}; {lib}; no plain time (its scores would be "
        f"~275 GB) on {card}")
    fd = r["full_depth"]
    m, e = fd["measured"], fd["extrapolated"]
    say(f"[26c] minicpm3-4b decode_32k at 62 layers: wall {m['wall_ms']:.1f} "
        f"ms (extrapolated {e['wall_ms']:.1f} from depths 1 and 2 timed in "
        f"turns with it: medians "
        f"{', '.join(f'{v:.2f}' for v in fd['in_turns_ms'].values())} ms; "
        f"{fd['wall_rel_err']:.3f} apart, "
        f"tolerance {FULL_DEPTH_WALL_TOL}), device {m['device_ms']:.1f} ms "
        f"(extrapolated {e['device_ms']:.1f}), peak "
        f"{m['peak_bytes'] / 2**30:.2f} GiB (extrapolated "
        f"{e['peak_bytes'] / 2**30:.2f}, {fd['peak_rel_err']:.3f} apart, "
        f"tolerance {FULL_DEPTH_PEAK_TOL}), bound {m['bound_ms']:.2f} ms on "
        f"{card}")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is "
              "False", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    card = nvidia_smi()
    say(f"[1] card: {card}")
    say(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    say(f"[1] built {len(_build.sources())} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.library_path()}")

    t0 = time.perf_counter()
    phase_kernels(dev)
    say(f"[2] kernels equal their plain versions ({time.perf_counter() - t0:.1f} s)")
    phase_semantics(dev)
    say("[2] torch.sort float order on CUDA == CPU; counts carrier survives a "
        "float32 column")

    rows = ROWS
    ctx = DistContext(num_shards=P)
    t0 = time.perf_counter()
    tabs = make_tables(ctx, rows, dev)
    torch.cuda.synchronize()
    say(f"[3] tables: {len(tabs)} x {P} shards x {rows} rows made in "
        f"{time.perf_counter() - t0:.1f} s")
    res, walls, counts, peaks = phase_main_path(ctx, tabs)
    peak = max(peaks.values())
    for name, ms in walls.items():
        r = res[name]
        say(f"[3] {name}: {ms:.1f} ms wall, rows {sum(r['row_counts'])}, "
            f"overflow {r['overflow']}, peak {peaks[name] / 2**30:.2f} GiB")
    say(f"[3] peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    check(all(sum(o) == 0 for r in res.values() for o in r["overflow"]),
          "overflow on the main path")

    plain = phase_plain_path(ctx, tabs, res)
    say(f"[4] plain run equal; largest float-sum difference "
        f"{plain['worst_float_diff']:.3g}")
    for name, ms in plain["walls"].items():
        say(f"[4] {name}: plain {ms:.1f} ms wall (kernels {walls[name]:.1f} ms)")
    op_ms = phase_operator_times(ctx, tabs)
    for name, t in op_ms.items():
        say(f"[5] {name}: median {t['kernels']:.1f} ms through the kernels, "
            f"{t['plain']:.1f} ms plain ({t['samples']} runs each, in turns) "
            f"on {card}")
    route = phase_submit_route(ctx, tabs)
    for name, r in route.items():
        say(f"[5] {name}: median {r['submit_ms']:.2f} ms through submit, "
            f"{r['direct_ms']:.2f} ms straight into execute_plan "
            f"({r['samples']} runs each, in turns); host syncs "
            f"{r['submit_syncs'][0]} / {r['direct_syncs']} / "
            f"{r['submit_syncs'][1]} (submit, direct, submit)")
    prof = phase_profile(ctx, tabs)
    for name, pr in prof.items():
        say(f"[6] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}, "
            f"ported kernels {pr['ported_kernels_ms']:.2f} ms, "
            f"{pr['host_ops']} torch ops dispatched by the host")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.2f} ms  {kname[:110]}")
    del res
    t0 = time.perf_counter()
    plan = phase_plan(ctx, tabs, dev, SAFE_RERUN_ROWS)
    say_plan(plan, card, time.perf_counter() - t0)
    analyzed = plan.pop("analyzed")
    plan_prof = {name: profiled(name, call) for name, call in
                 plan_calls(ctx, tabs, analyzed).items()}
    for name, pr in plan_prof.items():
        say(f"[11] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}, "
            f"ported kernels {pr['ported_kernels_ms']:.2f} ms, "
            f"{pr['host_ops']} torch ops dispatched by the host")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.2f} ms  {kname[:110]}")
    verified = phase_verify(ctx, tabs, analyzed)
    say(f"[13] explain(verify=True) clean for {sorted(verified['clean'])}; "
        f"audit_collectives of the pipeline: counted "
        f"{verified['audit']['actual']} = expected")
    del tabs, analyzed
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    serving = phase_serving(DistContext(num_shards=P), dev, rows, profiled)
    say_serving(serving, card, time.perf_counter() - t0)
    for name, pr in serving.pop("profile").items():
        say(f"[12] warm {name} query: profiled wall {pr['wall_ms']:.1f} ms, "
            f"GPU kernels {pr['device_ms']:.1f} ms, busy share "
            f"{pr['busy_share']:.2f}, ported kernels "
            f"{pr['ported_kernels_ms']:.2f} ms, {pr['host_ops']} torch ops "
            f"dispatched by the host")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.2f} ms  {kname[:110]}")
        serving.setdefault("profile", {})[name] = {
            k: pr[k] for k in ("wall_ms", "device_ms", "busy_share",
                               "ported_kernels_ms", "host_ops")}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    faults = phase_faults(dev, FAULT_ROWS)
    say(f"[13] fault cases at {P} x {FAULT_ROWS} rows recovered bit for bit "
        f"through their rungs ({time.perf_counter() - t0:.1f} s):")
    for name, cs in faults.items():
        say(f"[13]   {name}: {cs}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pipelines = {}
    for shards in (1, P):
        pipelines[shards] = phase_pipeline(dev, shards, profile=profiled)
        say_pipeline(pipelines[shards], card)
        torch.cuda.empty_cache()
    say(f"[14] pipeline batches equal the host oracles and the plain run at 1 "
        f"and {P} shards ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    harnesses = phase_harnesses(dev)
    fz = harnesses["fuzz"]
    say(f"[15] plan fuzz: {fz['plans']} plans at {P} shards, seed {FUZZ_SEED}: "
        f"{fz['cost_sized']} cost-sized, {fz['cacheable']} cacheable, "
        f"{fz['rows']} result rows, verifier {fz['verify']}, "
        f"{fz['seconds']:.1f} s")
    say(f"[15] {len(harnesses['dist_cases_seconds'])} dist cases passed their "
        f"oracle checks: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in harnesses["dist_cases_seconds"].items()))
    say(f"[15] harnesses on {card} ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    for src, (secs, _) in sorted(_build.LOGS.items()):
        say(f"[7] nvcc {src}: {secs:.1f} s (all sources compiled together)")
    lib = _build.library()
    for r in ptxas_report():
        # flash's bf16 kernels' dynamic shared memory, from the library
        hd = (re.search(r"<(\d+)/(\d+)", r["kernel"])
              if r["kernel"].startswith("flash") and "bf16" in r["kernel"]
              else None)
        if hd and "bwd" in r["kernel"]:
            dyn = lib.repro_flash_attention_bwd_smem(
                int(hd.group(1)), int(hd.group(2)), int("_dq_" in r["kernel"]))
        elif hd:
            dyn = lib.repro_flash_attention_smem(int(hd.group(1)),
                                                 int(hd.group(2)))
        dyn = f", {dyn} B dynamic" if hd else ""
        # flash's bf16 instances hold their tiles in registers by design,
        # and keep their wgmma products in flight
        check(not hd or (r.get("spill_store_bytes"), r.get("spill_load_bytes"))
              == (0, 0), f"ptxas: {r['kernel']} spills registers")
        check(not hd or not r["wgmma_serialized"],
              f"ptxas: {r['kernel']}'s wgmma products are serialized (C7520)")
        say(f"[7] ptxas {r['kernel']}: {r.get('registers')} registers, stack "
            f"frame {r.get('stack_frame_bytes')} B, spills "
            f"{r.get('spill_store_bytes')} B stored / {r.get('spill_load_bytes')}"
            f" B loaded, {r.get('static_smem_bytes')} B static shared memory"
            f"{dyn}")
    times = phase_timing(dev, rows)
    t = times["segment_scan_tiles"]
    say(f"[7] torch.cumsum (unsegmented) of segment_scan's column, "
        f"{t['n']} int32: {t['cumsum_ms']:.4f} ms on {card}")
    t = times["bucket_histogram"]
    say(f"[7] Timer floor (a one-element add): {t['floor_ms']:.4f} ms; a copy "
        f"of bucket_histogram's {4 * rows >> 20} MiB column: {t['copy_ms']:.4f} "
        f"ms on {card}")
    for key in ("flash_attention", "flash_attention@hd160", "flash_attention@hd16",
                "flash_attention@g1", "flash_attention@g6", "flash_attention@mla",
                "flash_attention@zamba", "flash_attention@g8",
                "flash_attention@whisper"):
        t = times[key]
        say(f"[7] {key} at {t['shape']}: " + (
            f"SDPA ({t['library_backend']} backend) differs from the plain "
            f"version's output by {t['library_max_abs_err']:.4g}"
            if "library_error" not in t else
            f"SDPA refused: {t['library_error']}"))
    t = times["bitonic_sort_tiles"]
    pr = t["probe"]
    say(f"[7] bitonic latency probe ({pr['steps']} dependent steps, one warp): "
        f"a 64-bit register compare-exchange {pr['register_cycles_per_step']:.2f} "
        f"cycles = {pr['register_ns_per_step']:.4f} ns a step, a "
        f"shuffle-compare-select {pr['shuffle_cycles_per_step']:.2f} cycles = "
        f"{pr['shuffle_ns_per_step']:.4f} ns; SM clock {pr['sm_ghz']:.3f} GHz "
        f"over the probe, nvidia-smi clocks.sm {sm_clock()}; {t['sms']} SMs")
    for name in ("hash32_partition", "bitonic_sort_permutation"):
        say(f"[7] {name}: the chain it replaces "
            f"{times[name]['replaced_chain_ms']:.4f} ms on {card}")
    torch.cuda.empty_cache()

    model, tokens, gen, lm_counts, lm_peak, init_s, n_params = phase_serve(dev)
    say(f"[8] {LM_ARCH}: {n_params} parameters drawn in {init_s:.1f} s; "
        f"{LM_BATCH} x {LM_PROMPT}-token prompts, {LM_GEN} greedy tokens: "
        f"prefill {gen.prefill_s * 1e3:.1f} ms, decode "
        f"{gen.decode_s / (LM_GEN - 1) * 1e3:.2f} ms a token (first run); "
        f"peak {lm_peak / 2**30:.2f} GiB; launches {lm_counts}; a decode step "
        f"launches none")
    say(f"[8] generated (first row): {gen.tokens[0].tolist()}")
    agree = phase_serve_plain(model, tokens, gen)
    say(f"[9] plain run, teacher-forced: logits within "
        f"{agree['plain_max_abs_err']:.4g} (tolerance {LM_TOL}); greedy "
        f"tokens equal on all {agree['tokens_checked']} of "
        f"{LM_BATCH * LM_GEN} with a top-2 margin > {LM_TOL}, and on "
        f"{agree['plain_same_greedy_tokens']} in all; first tokens' margins "
        f"{[round(m, 4) for m in agree['first_token_margins']]}")
    say(f"[9] prefill + decode vs one causal forward over "
        f"{LM_PROMPT + LM_GEN - 1} tokens: within "
        f"{agree['causal_max_abs_err']:.4g} (tolerance {LM_TOL}); its greedy "
        f"tokens equal on {agree['causal_same_greedy_tokens']} of "
        f"{LM_BATCH * LM_GEN}")
    del gen
    serve_times = phase_serve_times(model, tokens)
    say(f"[10] prefill median {serve_times['prefill_ms']:.2f} ms, decode "
        f"{serve_times['decode_ms_per_token']:.3f} ms a token, "
        f"{serve_times['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{serve_times['end_to_end_tokens_per_s']:.1f} tokens/s end to end, "
        f"peak {lm_peak / 2**30:.2f} GiB on {card}")
    serve_prof = phase_serve_profile(model, tokens)
    for name, pr in serve_prof.items():
        say(f"[10] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.2f} ms, busy share {pr['busy_share']:.2f}, "
            f"flash {pr['ported_kernels_ms']:.3f} ms, {pr['host_ops']} torch "
            f"ops dispatched by the host, on {card}")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.3f} ms  {kname[:110]}")
    t0 = time.perf_counter()
    gqa_shard = phase_seq_shard_gqa(model, tokens)
    say_seq_shard("a", LM_ARCH, gqa_shard["prompt"], card)
    say_seq_shard("a", LM_ARCH, gqa_shard["long_prompt"], card)
    say(f"[25a] peak at the {LONG_PROMPT}-token prompt "
        f"{gqa_shard['long_prompt']['peak_bytes'] / 2**30:.2f} GiB; phase 25a "
        f"{time.perf_counter() - t0:.1f} s")
    del model, tokens
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_cfg = get_config(TRAIN_ARCH)
    batches, pipe_ms = train_batches(dev, train_cfg, TRAIN_STEPS + 2)
    train_plain = phase_train_plain(dev, batches[0])
    torch.cuda.empty_cache()
    say(f"[16] {TRAIN_PLAIN_LAYERS} layers of {TRAIN_ARCH}'s width, kernels vs "
        f"plain attention on the card: every gradient leaf within "
        f"{train_plain['worst_grad_rel_err']:.4g} of its largest (worst "
        f"{train_plain['worst_grad_leaf']}, tolerance {TRAIN_GRAD_TOL:g}); one "
        f"step's loss {train_plain['loss']:.6f} vs {train_plain['plain_loss']:.6f}"
        f", grad norm {train_plain['grad_norm']:.5f} vs "
        f"{train_plain['plain_grad_norm']:.5f}")
    narrow = phase_train_narrow(dev)
    torch.cuda.empty_cache()
    say(f"[16] {narrow['config']}: crash at step 4 and resume from the step-4 "
        f"checkpoint = the uninterrupted 6 steps, all {narrow['resumed_bitwise']}"
        f" parameter, master and moment tensors bit for bit; 60 steps on one "
        f"batch: loss {narrow['overfit_first_loss']:.4f} -> "
        f"{narrow['overfit_last_loss']:.4f}")
    train = phase_train(dev, batches, profiled)
    del batches
    torch.cuda.empty_cache()
    say(f"[16] {TRAIN_ARCH} at full width and depth: {train['parameters']} "
        f"parameters drawn in {train['init_s']:.1f} s; {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step in {train['microbatches']} microbatches; "
        f"warm-up step {train['warmup_step_ms']:.1f} ms, then "
        f"{[round(x, 1) for x in train['step_ms']]} ms: median "
        f"{train['median_step_ms']:.1f} ms, {train['tokens_per_s']:.0f} tokens/s, "
        f"{100 * train['bf16_peak_share']:.1f}% of the dense bf16 peak "
        f"({train['flops_per_token'] / 1e9:.2f} GFLOP a token), peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB on {card}")
    say(f"[16] loss {[round(x, 4) for x in train['loss']]}, grad norm "
        f"{[round(x, 4) for x in train['grad_norm']]}; the first loss "
        f"{train['loss'][0]:.4f} beside ln({train_cfg.padded_vocab}) = "
        f"{math.log(train_cfg.padded_vocab):.4f} and the {TRAIN_PLAIN_LAYERS}-"
        f"layer plain run's {train_plain['plain_loss']:.4f}")
    say(f"[16] launches a step {train['launches_per_step']['flash_attention_lse']}"
        f" LSE forwards + {train['launches_per_step']['flash_attention_bwd']} "
        f"backwards (expected: 2 x {train_cfg.num_layers} layers x "
        f"{train['microbatches']} microbatches with remat, {train_cfg.num_layers}"
        f" x {train['microbatches']}), in all {train['launches']}")
    say(f"[16] pipeline ms a batch {[round(x, 1) for x in pipe_ms]} (median "
        f"{statistics.median(pipe_ms):.1f}) against a step's "
        f"{train['median_step_ms']:.1f} ms")
    pr = train["profile"]
    say(f"[16] one profiled step: wall {pr['wall_ms']:.1f} ms, GPU kernels "
        f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}, flash "
        f"{pr['ported_kernels_ms']:.2f} ms, {pr['host_ops']} torch ops "
        f"dispatched by the host, on {card}")
    for kname, ms in pr["top"]:
        say(f"      {ms:8.2f} ms  {kname[:110]}")
    say(f"[16] training phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    big_cfg = get_config(BIG_ARCH)
    big = phase_big_serve(dev, profile=True)
    say(f"[17] {BIG_ARCH} (hd {big_cfg.hd}): {big['parameters']} parameters "
        f"drawn in {big['init_s']:.1f} s; {LM_BATCH} x {LM_PROMPT}-token "
        f"prompts, {LM_GEN} greedy tokens; launches {big['launches']}; a decode "
        f"step launches none; peak {big['peak_bytes'] / 2**30:.2f} GiB")
    say(f"[17] plain run, teacher-forced: logits within "
        f"{big['plain_max_abs_err']:.4g} (tolerance {LM_TOL}; prefill logits' "
        f"std {big['prefill_logit_std']:.4f}); greedy tokens equal on all "
        f"{big['tokens_checked']} with a top-2 margin > {LM_TOL}, on "
        f"{big['plain_same_greedy_tokens']} of {LM_BATCH * LM_GEN} in all; one "
        f"causal forward within {big['causal_max_abs_err']:.4g}")
    say(f"[17] prefill median {big['prefill_ms']:.2f} ms, decode "
        f"{big['decode_ms_per_token']:.3f} ms a token, "
        f"{big['decode_tokens_per_s']:.1f} tokens/s decoding, "
        f"{big['end_to_end_tokens_per_s']:.1f} tokens/s end to end on {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    for name, pr in big["profile"].items():
        say(f"[17] {name}: profiled wall {pr['wall_ms']:.1f} ms, GPU kernels "
            f"{pr['device_ms']:.2f} ms, busy share {pr['busy_share']:.2f}, "
            f"flash {pr['ported_kernels_ms']:.3f} ms, {pr['host_ops']} torch "
            f"ops dispatched by the host, on {card}")
        for kname, ms in pr["top"]:
            say(f"      {ms:8.3f} ms  {kname[:110]}")
    t1 = time.perf_counter()
    big_train = phase_big_train(dev, profiled)
    bp = big_train["plain"]
    say(f"[17] {TRAIN_PLAIN_LAYERS} layers of {BIG_ARCH}'s width, kernels vs "
        f"plain attention: every gradient leaf within "
        f"{bp['worst_grad_rel_err']:.4g} of its largest (worst "
        f"{bp['worst_grad_leaf']}, tolerance {TRAIN_GRAD_TOL:g}); one step's "
        f"loss {bp['loss']:.6f} vs {bp['plain_loss']:.6f}, grad norm "
        f"{bp['grad_norm']:.5f} vs {bp['plain_grad_norm']:.5f}")
    say(f"[17] {BIG_ARCH} at {big_train['layers']} of {big_cfg.num_layers} "
        f"layers: {big_train['parameters']} parameters; {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step in {big_train['microbatches']} "
        f"microbatches; warm-up {big_train['warmup_step_ms']:.1f} ms, then "
        f"{[round(x, 1) for x in big_train['step_ms']]} ms, "
        f"{big_train['tokens_per_s']:.0f} tokens/s, "
        f"{100 * big_train['bf16_peak_share']:.1f}% of the dense bf16 peak, "
        f"peak {big_train['peak_bytes'] / 2**30:.2f} GiB on {card}")
    say(f"[17] loss {[round(x, 4) for x in big_train['loss']]}, grad norm "
        f"{[round(x, 4) for x in big_train['grad_norm']]}; launches a step "
        f"{big_train['launches_per_step']['flash_attention_lse']} LSE forwards "
        f"+ {big_train['launches_per_step']['flash_attention_bwd']} backwards, "
        f"in all {big_train['launches']}")
    pr = big_train["profile"]
    say(f"[17] one profiled step: wall {pr['wall_ms']:.1f} ms, GPU kernels "
        f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}, flash "
        f"{pr['ported_kernels_ms']:.2f} ms, {pr['host_ops']} torch ops")
    for kname, ms in pr["top"]:
        say(f"      {ms:8.2f} ms  {kname[:110]}")
    big_train["profile"] = {k: pr[k] for k in (
        "wall_ms", "device_ms", "busy_share", "ported_kernels_ms", "host_ops",
        "top")}
    say(f"[17] training {time.perf_counter() - t1:.1f} s; phase 17 "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tiny = phase_tiny(dev)
    for arch, r in tiny["serve"].items():
        say(f"[18] serve --tiny --arch {arch} (widths {r['widths'][0]}/"
            f"{r['widths'][1]}) on the card: flash "
            f"{r['launches']['flash_attention']} launches; prefill logits within "
            f"{r['prefill_max_abs_err']:.4g} of --device cpu (tolerance "
            f"{LM_TOL}, std {r['prefill_logit_std']:.3f}); {r['same_tokens']} of "
            f"{r['tokens']} greedy tokens equal")
    for arch, r in tiny["train"].items():
        say(f"[18] train --tiny --arch {arch} --steps {TINY_TRAIN_STEPS} (widths "
            f"{r['widths'][0]}/{r['widths'][1]}) on the card: "
            f"{r['launches']['flash_attention_lse']} LSE "
            f"forwards, {r['launches']['flash_attention_bwd']} backwards; losses "
            f"{[round(x, 5) for x in r['loss']]} vs --device cpu "
            f"{[round(x, 5) for x in r['cpu_loss']]} (largest difference "
            f"{r['max_loss_diff']:.3g}, tolerance {TINY_LOSS_TOL:g})")
    say(f"[18] the --tiny commands {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    moe_serve = phase_moe_serve(dev, MOE_ARCH, profile=True)
    say_moe_serve(moe_serve, card)
    for name, pr in moe_serve["profile"].items():
        moe_serve["profile"][name] = {k: pr[k] for k in (
            "wall_ms", "device_ms", "busy_share", "ported", "host_ops", "top")}
    t1 = time.perf_counter()
    moe_train = phase_moe_train(dev, profiled)
    mp = moe_train["plain"]
    say(f"[19] {TRAIN_PLAIN_LAYERS} layers of {MOE_ARCH}'s width, kernels vs "
        f"plain attention (on the kernel run's routes; {mp['route_flips']} of "
        f"{mp['routes']} would differ): every gradient leaf within "
        f"{mp['worst_grad_rel_err']:.4g} of its largest (worst "
        f"{mp['worst_grad_leaf']}, tolerance {TRAIN_GRAD_TOL:g}); one step's "
        f"loss {mp['loss']:.6f} vs {mp['plain_loss']:.6f}, grad norm "
        f"{mp['grad_norm']:.5f} vs {mp['plain_grad_norm']:.5f}")
    say(f"[19] {MOE_ARCH} at {moe_train['layers']} of "
        f"{get_config(MOE_ARCH).num_layers} layers: {moe_train['parameters']} "
        f"parameters; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
        f"{moe_train['microbatches']} microbatches; warm-up "
        f"{moe_train['warmup_step_ms']:.1f} ms, then "
        f"{[round(x, 1) for x in moe_train['step_ms']]} ms, "
        f"{moe_train['tokens_per_s']:.0f} tokens/s, "
        f"{100 * moe_train['bf16_peak_share']:.1f}% of the dense bf16 peak "
        f"({moe_train['flops_per_token'] / 1e9:.2f} GFLOP a token), peak "
        f"{moe_train['peak_bytes'] / 2**30:.2f} GiB on {card}")
    say(f"[19] loss {[round(x, 4) for x in moe_train['loss']]}, moe_aux "
        f"{[round(x, 4) for x in moe_train['moe_aux']]}, moe_dropped "
        f"{moe_train['moe_dropped']}, grad norm "
        f"{[round(x, 4) for x in moe_train['grad_norm']]}; launches a step "
        f"{moe_train['launches_per_step']['flash_attention_lse']} LSE "
        f"forwards + {moe_train['launches_per_step']['flash_attention_bwd']} "
        f"backwards + {moe_train['launches_per_step']['bucket_histogram']} "
        f"histograms, in all {moe_train['launches']}")
    pr = moe_train["profile"]
    say(f"[19] one profiled step: wall {pr['wall_ms']:.1f} ms, GPU kernels "
        f"{pr['device_ms']:.1f} ms, busy share {pr['busy_share']:.2f}, flash "
        f"{pr['ported'].get('flash', 0.0):.2f} ms, bucket_histogram "
        f"{pr['ported'].get('hist', 0.0):.3f} ms, {pr['host_ops']} torch ops")
    for kname, ms in pr["top"]:
        say(f"      {ms:8.2f} ms  {kname[:110]}")
    moe_train["profile"] = {k: pr[k] for k in (
        "wall_ms", "device_ms", "busy_share", "ported", "host_ops", "top")}
    say(f"[19] training {time.perf_counter() - t1:.1f} s")
    moe_big = phase_moe_serve(dev, MOE_BIG_ARCH, MOE_BIG_LAYERS)
    say_moe_serve(moe_big, card)
    say(f"[19] phase 19 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mla_serve = phase_big_serve(dev, profile=True, arch=MLA_ARCH,
                                causal_tol=MLA_DECODE_TOL)
    say_big_serve(20, mla_serve, card, time.perf_counter() - t0, "MLA, ")
    t1 = time.perf_counter()
    mla_train = phase_big_train(dev, profiled, MLA_ARCH, MLA_TRAIN_LAYERS)
    say_big_train(20, mla_train, card, time.perf_counter() - t1)
    say(f"[20] phase 20 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hyb_serve = phase_big_serve(dev, profile=True, arch=HYBRID_ARCH,
                                causal_tol=HYBRID_PLAIN_TOL)
    say_big_serve(21, hyb_serve, card, time.perf_counter() - t0,
                  "Mamba2 hybrid, shared-block ")
    t1 = time.perf_counter()
    hyb_train = phase_big_train(dev, profiled, HYBRID_ARCH,
                                get_config(HYBRID_ARCH).num_layers)
    say_big_train(21, hyb_train, card, time.perf_counter() - t1)
    say(f"[21] phase 21 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    vlm_serve = phase_big_serve(dev, profile=True, arch=VLM_ARCH,
                                layers=VLM_LAYERS)
    say_big_serve(22, vlm_serve, card, time.perf_counter() - t0, "VLM, ")
    vlm_train = phase_vlm_tiny_train(dev)
    say(f"[22] {VLM_ARCH} TINY ({vlm_train['layers']} layers, hd "
        f"{get_tiny(VLM_ARCH).hd}), {vlm_train['batch']} x "
        f"({vlm_train['front_rows']} front embeddings + {vlm_train['seq']} "
        f"tokens) in {train_microbatches(VLM_ARCH)} microbatches, kernels vs "
        f"plain attention: every gradient leaf within "
        f"{vlm_train['worst_grad_rel_err']:.4g} of its largest (worst "
        f"{vlm_train['worst_grad_leaf']}, tolerance {TRAIN_GRAD_TOL:g}); loss "
        f"over the text tokens {vlm_train['loss']:.6f} vs "
        f"{vlm_train['plain_loss']:.6f} ({vlm_train['loss_text_only']:.6f} "
        f"without the embeds), grad norm {vlm_train['grad_norm']:.5f} vs "
        f"{vlm_train['plain_grad_norm']:.5f}; front_proj's largest gradient "
        f"{vlm_train['front_proj_grad_max']:.4g}; launches a step "
        f"{vlm_train['launches_per_step']['flash_attention_lse']} LSE forwards "
        f"+ {vlm_train['launches_per_step']['flash_attention_bwd']} backwards")
    say(f"[22] phase 22 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    xl = phase_xlstm(dev, profiled)
    say_xlstm(xl, card, time.perf_counter() - t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    wh = phase_whisper(dev, profiled)
    say_big_serve(24, wh["serve"], card, wh["serve_s"],
                  f"encoder-decoder, {LM_PROMPT} audio frames a prompt; ")
    lp = wh["long_prefill"]
    say(f"[24] prefill at Whisper's shape, {LM_BATCH} x ({lp['frames']} frames "
        f"+ {lp['prompt_len']} tokens): launches {lp['launches']}; logits "
        f"within {lp['plain_max_abs_err']:.4g} of the plain run (tolerance "
        f"{LM_TOL}); median {lp['prefill_ms']:.2f} ms on {card}")
    say_big_train(24, wh["train"], card, wh["train_s"])
    ga = wh["grad_account"]
    say(f"[24] gradients at {ga['layers'][0]} + {ga['layers'][1]} blocks, the "
        f"worst leaf's distance over its fp32 scale: " + ", ".join(
            f"{pair.replace('_', ' ')} {v['rel_err']:.4g} ({v['worst_leaf']})"
            for pair, v in ga.items() if isinstance(v, dict))
        + f"; kernel vs fp32 at most {ga['noise_ratio']} x plain vs fp32")
    say(f"[24] phase 24 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mla_shard = phase_seq_shard_mla(dev)
    say_seq_shard("b", MLA_ARCH, mla_shard, card)
    t1 = time.perf_counter()
    pod_dots = phase_pod_and_dots(dev)
    say_pod_and_dots(pod_dots, card)
    t2 = time.perf_counter()
    mesh_cli = phase_mesh_launchers(dev)
    for arch, r in mesh_cli["serve"].items():
        say(f"[25e] serve --tiny --arch {arch} {' '.join(MESH_SERVE_FLAGS)} on "
            f"the card: launches {r['launches']}; logits within "
            f"{r['max_abs_err']:.4g} of --device cpu over "
            f"{r['steps_compared']} steps (tolerance {LM_TOL}); "
            f"{r['same_tokens']} of {r['tokens']} greedy tokens equal")
    for arch, r in mesh_cli["train"].items():
        say(f"[25e] train --tiny --arch {arch} {' '.join(MESH_TRAIN_FLAGS)}: "
            f"losses {[round(x, 5) for x in r['loss']]} vs --device cpu "
            f"{[round(x, 5) for x in r['cpu_loss']]} (largest difference "
            f"{r['max_loss_diff']:.3g}, tolerance {TINY_LOSS_TOL:g}); "
            f"launches {r['launches']}")
    cases = harnesses["dist_cases"]
    say(f"[25f] the dist cases on the card (phase 15): flash_decode_err "
        f"{cases['flash_decode_shard']['flash_decode_err']:.3g}, "
        f"pod_compress_max_param_diff "
        f"{cases['compress_pod']['pod_compress_max_param_diff']:.4g}, "
        f"elastic losses {cases['elastic_restore']['elastic_losses']}")
    say(f"[25] phase 25: (b) {t1 - t0:.1f} s, (c)-(d) {t2 - t1:.1f} s, (e) "
        f"{time.perf_counter() - t2:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    roofs = phase_roofs(dev)
    cells = {"roofs": roofs, "card": card}
    cells["cells"] = phase_cells(dev, roofs)
    cells["flash_32k"] = flash_long_check(dev, Timer(dev))
    cells["full_depth"] = full_depth_check(dev, cells["cells"], roofs)
    say_cells(cells, card)
    say(f"[26] phase 26 {time.perf_counter() - t0:.1f} s")

    for name in ("flash_attention_lse", "flash_attention_bwd"):
        for suffix in ("", "@hd160", "@hd16", "@mla", "@zamba", "@whisper"):
            t = times[name + suffix]
            sh = t["shape"]
            if "library_error" in t:
                lib_txt = f"library error: {t['library_error']}"
            elif name == "flash_attention_lse":
                lib_txt = (f"library ({t['library_backend']}) within "
                           f"{t['library_max_abs_err']:.3g} of the plain version")
            else:
                lib_txt = (f"library ({t['library_backend']}) "
                           f"{t['library_tile_rel_err']:.3g}")
            extra = (f"serving entry {t['serving_entry_ms']:.4f} ms, {lib_txt}"
                     if name == "flash_attention_lse" else
                     f"{t['tflops']:.1f} TFLOP/s, worst tile within "
                     f"{t['tile_rel_err']:.3g} of its plain norm ({lib_txt}); "
                     f"dK/dV split {t['dkdv_splits']}; launches' device time "
                     f"{t['device_ms']:.4f} ms (" + ", ".join(
                         f"{k} {v:.4f}" for k, v in t["launch_ms"].items()) + ")")
            say(f"[7] {name}{suffix} at B {sh['B']}, S {sh['S']}, H {sh['H']}, "
                f"KV {sh['KV']}, hd {sh['hd']}/{sh['dv']}: {extra}, on {card}")

    # the LM kernels' launches on their paths: hd 128 serving (phase 8), hd
    # 64 training (16), hd 160 serving and training (17), hd 16 (18: the GQA
    # archs'; minicpm3-4b's TINY runs its own (24, 16) instance), MLA's 96/64
    # serving and training (20)
    hd16 = [a for a, r in tiny["serve"].items() if r["widths"] == [16, 16]]
    hd16_train = [a for a, r in tiny["train"].items() if r["widths"] == [16, 16]]
    lm_launches = {
        "flash_attention": lm_counts["flash_attention"],
        "flash_attention_lse": train["launches"]["flash_attention_lse"],
        "flash_attention_bwd": train["launches"]["flash_attention_bwd"],
        "flash_attention@hd160": big["launches"]["flash_attention"],
        **{f"{n}@hd160": big_train["launches"][n] for n in LM_KERNELS[1:]},
        "flash_attention@hd16": sum(tiny["serve"][a]["launches"]["flash_attention"]
                                    for a in hd16),
        **{f"{n}@hd16": sum(tiny["train"][a]["launches"][n] for a in hd16_train)
           for n in LM_KERNELS[1:]},
        "flash_attention@mla": mla_serve["launches"]["flash_attention"],
        **{f"{n}@mla": mla_train["launches"][n] for n in LM_KERNELS[1:]},
        # phase 19: qwen2-moe-a2.7b's generate (flash at group size 1, the
        # histogram over 60 experts) and dbrx-132b's (group size 6)
        "bucket_histogram@moe": moe_serve["launches"]["bucket_histogram"],
        "flash_attention@g1": moe_serve["launches"]["flash_attention"],
        "flash_attention@g6": moe_big["launches"]["flash_attention"],
        # phase 21: zamba2-1.2b's generate (the shared block, hd 64, group
        # size 1) and training steps; phase 22: internvl2-76b's generate
        # (group size 8 over 256 front + 1024 text rows)
        "flash_attention@zamba": hyb_serve["launches"]["flash_attention"],
        **{f"{n}@zamba": hyb_train["launches"][n] for n in LM_KERNELS[1:]},
        "flash_attention@g8": vlm_serve["launches"]["flash_attention"],
        # phase 24: whisper-base's generate (the encoder, the decoder and
        # the cross-attention at hd 64, non-causal but the decoder's) and
        # its training steps; xlstm-1.3b (phase 23) launches no kernel
        "flash_attention@whisper": wh["serve"]["launches"]["flash_attention"],
        **{f"{n}@whisper": wh["train"]["launches"][n] for n in LM_KERNELS[1:]}}
    kernels = []
    entries = [(name, name) for name in KERNELS] + [
        (f"{name}{suffix}", name) for suffix in ("@hd160", "@hd16", "@mla",
                                                 "@zamba", "@whisper")
        for name in LM_KERNELS] + [
        ("bucket_histogram@moe", "bucket_histogram"),
        ("segment_reduce_tiles@f64", "segment_reduce_tiles"),
        ("flash_attention@g1", "flash_attention"),
        ("flash_attention@g6", "flash_attention"),
        ("flash_attention@g8", "flash_attention")]
    for key, name in entries:
        _, source, replaces = KERNELS[name]
        t = times[key]
        lib = t["library_ms"]
        say(f"[7] {key}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
            f"{lib if lib is None else round(lib, 4)}, bound "
            f"{t['bound_ms']:.5f} by {t['bound_by']}) on {card}")
        n = lm_launches[key] if key in lm_launches else counts[name]
        kernels.append({"name": key, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": t["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": lib})
        if "replaced_chain_ms" in t:
            kernels[-1]["replaced_chain_ms"] = t["replaced_chain_ms"]
    say(json.dumps({"serve": {
        "arch": LM_ARCH, "batch": LM_BATCH, "prompt_len": LM_PROMPT,
        "gen": LM_GEN, "parameters": n_params, "peak_bytes": lm_peak,
        "launches": lm_counts, **serve_times, **agree,
        "profile": {k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"],
                        "busy_share": v["busy_share"],
                        "flash_ms": v["ported_kernels_ms"],
                        "host_ops": v["host_ops"]}
                    for k, v in serve_prof.items()},
    }}))
    say(json.dumps({"main_path": {
        "rows_per_shard": rows, "peak_bytes": peak, "peak_bytes_by_call": peaks,
        "first_run_wall_ms": walls, "first_plain_run_wall_ms": plain["walls"],
        "operator_median_ms": op_ms, "submit_route": route,
        "profile": {k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"],
                        "busy_share": v["busy_share"],
                        "ported_kernels_ms": v["ported_kernels_ms"],
                        "host_ops": v["host_ops"]}
                    for k, v in prof.items()},
    }}))
    say(json.dumps({"plan": {**plan_summary(plan, rows), "profile": {
        k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"],
            "busy_share": v["busy_share"],
            "ported_kernels_ms": v["ported_kernels_ms"],
            "host_ops": v["host_ops"]} for k, v in plan_prof.items()}}}))
    say(json.dumps({"serving": {**serving, "faults": faults,
                                "verify": verified, "card": card}}))
    for r in pipelines.values():
        if "profile" in r:
            r["profile"] = {k: r["profile"][k] for k in (
                "wall_ms", "device_ms", "busy_share", "ported_kernels_ms",
                "host_ops", "top")}
    say(json.dumps({"pipeline": {str(k): v for k, v in pipelines.items()},
                    "harnesses": harnesses, "card": card}))
    train["profile"] = {k: train["profile"][k] for k in (
        "wall_ms", "device_ms", "busy_share", "ported_kernels_ms", "host_ops",
        "top")}
    say(json.dumps({"train": {**train, "pipeline_ms": pipe_ms,
                              "plain": train_plain, "narrow": narrow,
                              "card": card}}))
    say(json.dumps({"stablelm": {"serve": big, "train": big_train,
                                 "card": card}}))
    say(json.dumps({"tiny": {**tiny, "card": card}}))
    say(json.dumps({"moe": {"serve": moe_serve, "train": moe_train,
                            "dbrx_serve": moe_big, "card": card}}))
    say(json.dumps({"mla": {"serve": mla_serve, "train": mla_train,
                            "card": card}}))
    say(json.dumps({"hybrid": {"serve": hyb_serve, "train": hyb_train},
                    "vlm": {"serve": vlm_serve, "train": vlm_train},
                    "card": card}))
    say(json.dumps({"xlstm": xl, "whisper": wh, "card": card}))
    say(json.dumps({"mesh": {"seq_shard_gqa": gqa_shard,
                             "seq_shard_mla": mla_shard,
                             "pod_and_dots": pod_dots, "launchers": mesh_cli,
                             "card": card}}))
    say(json.dumps({"cells": cells}))
    say(json.dumps({"kernels": kernels}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
