#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, then runs its phases, each printing JSON lines:

  0. card: name and power limit (``nvidia-smi``), kernel build time, and
     the count of HGMMA (wgmma), UTMALDG (TMA load), SYNCS (mbarrier),
     LDGSTS (cp.async) and LDG.E.128 (16-byte load) instructions in each
     kernel of the built library (``cuobjdump -sass``), and each kernel's
     registers, spill bytes and whether ptxas serialized its wgmma
     instructions (the build's ``-Xptxas=-v`` output); the bf16 flash
     kernel must have HGMMA and UTMALDG, every paged split kernel LDGSTS,
     every flash_decode tensor-core kernel HMMA (mma.sync) and LDGSTS, no
     flash_decode kernel may spill, and every overlay page kernel whose
     canon load is 16 bytes LDG.E.128;
  1. every kernel against its plain PyTorch version on the card, over the
     JAX test-suite sweep shapes and the main path's llama2-7b shapes
     (float32 within 2e-5; bfloat16 within 2e-2 at the sweep shapes; at
     the main path's shapes paged attention within one rounding step per
     element, and flash within twice the max and mean error that
     ``scaled_dot_product_attention`` makes on the same bf16 inputs, both
     against the float32 plain version; the re-page, gather, scatter and
     repack bit for bit, the re-page also at hd 128 on its 16-byte and
     tile paths and against ``index_copy_`` at its timing shape, the last
     three also at the prefix cache's copy-on-write shape and the
     full-width Fig. 3 shape), then each kernel's time (paged also at one
     2048-token sequence, at phase 3's lengths and in the nhbd and nhdb
     layouts; the re-page also in nhbd and nhdb, as whole pages and from
     float32 rows; gather, scatter and repack also at the Fig. 3 shape;
     flash and paged also on phase 6's window paths: a 500-token chunk at
     q_offset 7500 under a 4096-token window, and decode over phase 6's
     eight sequences with NaN in every stale row below each floor, whose
     output must be finite, equal to that over finite pools, and moved by
     the window at least 10 times the kernel's error; and every kernel of
     phase 7 at its MLA shapes: flash with q and k 192 wide and v 128 —
     small shapes with dv < dk, then the last 500-token chunk of an
     8192-token prompt, bf16 against the yardstick and float32 within
     2e-5 —, the gather of phase 7's decode table and the overlay of a
     500-row chunk into both latent pools (512 and 64 wide), bit-identical
     to the plain versions and to ``index_select`` / ``index_copy_``, and
     the prefix cache's copy of a latent page),
     its plain version's time, a library
     call's time where one computes the same function, and the least time
     the card could take (bytes over 3.35 TB/s or operations over the
     dense peak of the dtype, whichever is larger). ``ms`` times
     back-to-back calls with CUDA events (the host's enqueue included
     where it is the longer);
     ``device_ms`` times a CUDA-graph replay of the same calls (device
     time only), for the kernels and the library calls alike;
     ``host_us`` is the wrapper's host cost per call;
  2. path parity: llama2-7b at full width with 2 layers in float32 (TF32
     off), one 300-token request through prefill, chunked prefill and 8
     paged decode steps on the card through the kernels and on the CPU
     through the plain versions — logits within 1e-3, the 9 greedy tokens
     identical;
  3. the main path: llama2-7b, 32 layers, bfloat16, random weights from a
     seed, one P engine (block 16, nhbd, TP 2) and one D engine (block 32,
     nbhd, TP 1) on the card behind GlobalScheduler with 500-token
     streamed prefill chunks over a raw bf16 wire; 8 requests with
     prompts of 256-2048 tokens and 32 greedy output tokens each. The
     flash, paged and overlay kernels must have launched during this
     phase, and each request's last token must agree with a monolithic
     prefill of its prompt and output; each request's first token must be,
     within LOGIT_SLACK, the top choice of a float32 prefill of its prompt
     (params upcast, the float32 flash kernel), a yardstick that does not
     depend on bf16 summation order; a digest of all output tokens is
     printed;
  4. the prefix-cache path: the same model and vendors with the cache on
     both engines; a 1000-token system prompt shared by 8 requests with
     unique 64-512-token tails, request 0 served alone, then the other 7
     together. Each cached request skips the 1000 tokens on the wire, P
     replays them from its host store, and D copies the divergence page
     with the repack kernel (gather then scatter). Checks as in phase 3,
     plus the hit counts and >= 14 launches each of gather_pages,
     scatter_pages and repack; then the same schedule cold, for the
     comparison it prints;
  5. the cross-process runtime: phase 3's eight requests served through
     ``TwoProcessRuntime`` — P and D engines in two spawned worker
     processes, each with its own CUDA context and its own weights (the
     same seed), KV over shared-memory segments. Every request must
     finish with no stream failure and no crash, the workers must have
     launched exactly phase 3's kernels, the last-token and first-token
     checks of phase 3 must hold, and no segment the run created may
     survive its shutdown. It prints TTFT, TPOT and tok/s beside the
     spawn-to-hello time, the merged wire counters and the worker pids;
  6. sliding window and MoE: Mixtral-8x7B at full width (d 4096, 32 heads,
     8 KV heads, 8 experts top 2, window 4096), its depth cut to 24 of 32
     layers to fit the card, bf16, random weights from the seed, served
     as in phase 3 (same vendors, chunk and wire) to 8 requests of 8192,
     7000, 6100, 5000, 4600, 4097, 3000 and 2048 tokens. Exactly flash,
     paged and the overlay must launch; each request must ship exactly
     min(len, 4096) prompt positions, the wire bytes and progress markers
     must be what the window floors predict; the last-token check of
     phase 3 holds, and the float32 first-token check on the bf16
     prefill's expert choices (``moe_first_token_yardstick``: top-k
     routing is discrete, so float32 on its own routing is printed beside
     it, with where the choices differ). It prints the window's effect on
     the last logits of the 8192-token prompt, an observation;
  7. MLA and MoE: DeepSeek-V2-Lite at full width and all 27 layers (16
     heads, latent 512, q/k 192 and v 128 wide, 64 experts top 6 with 2
     shared, a dense first layer), bf16, random weights from the seed,
     served as in phase 3 to phase 6's eight prompts. Exactly flash (every
     prefill chunk, the latent expanded to dk 192 / dv 128), the overlay
     (the latent wire into the D engine's two latent pools) and gather
     (each decode step's latent pages) must launch; the wire must carry
     exactly the latent's bytes (31,104 a token) plus the headers the
     codec adds; the last-token check of phase 3 and the float32
     first-token check on the bf16 prefill's expert choices hold. It
     prints the latent's bytes per token beside expanded K and V's;
  8. the hybrid RG-LRU family: first phase 2's path parity at
     RecurrentGemma-9B's full width cut to its first 3 layers (rglru,
     rglru, attn: the recurrent states carried through prefill, chunked
     prefill and paged decode), then RecurrentGemma-9B at full width and
     all 38 layers (26 RG-LRU + 12 local-attention layers of 16 query
     heads on one KV head of 256, window 2048), bf16, random weights from
     the seed, served to phase 6's eight prompts by phase 3's vendors with
     P at TP 1 (one KV head does not split). Exactly flash, paged and the
     overlay must launch; each request ships min(len, 2048) positions; the
     wire bytes must equal what the window floors predict plus one tail a
     request of the recurrent states (1,064,960 bytes); the progress
     markers what the floors predict; the last-token check and phase 3's
     float32 first-token check hold. Phase 1 adds flash, paged and the
     overlay at this model's shapes (``phase1_rg``);
  9. the Mamba-2 SSD family: Mamba2-370M at full width and all 48 layers
     (32 SSD heads x 64, d_state 128, chunk 256; no attention, no KV),
     bf16, random weights from the seed, served to phase 6's eight
     prompts by phase 3's vendors with P at TP 1. No kernel may launch:
     the SSD chunk scan and recurrence are tensor code, as in the
     reference. Each request's stream is progress markers (counted, never
     sent) and one package of no entries that declares its whole length;
     the wire carries no KV byte, one header a request, and one tail a
     request of exactly 50,995,200 bytes of states; D has no pools. The
     last-token and float32 first-token checks of phase 3 hold;
 10. the vision frontend: InternVL2-2B at full width and all 24 layers
     (16 heads on 8 KV heads x 128), bf16, random weights from the seed,
     served by phase 3's vendors (P at TP 2) to phase 3's eight prompts,
     each after 256 patch embeddings from the seed (merged sequences of
     512-2304 positions), with a prefix cache on both engines. Exactly
     flash, paged and the overlay must launch; the wire must carry every
     merged position's KV (98,304 bytes a position) plus the codec's
     headers, to the byte; every request must bypass both prefix caches
     (counted, no hit: the vlm family's capability row has no prefix
     cache); the last-token and float32 first-token checks, on the
     patches and the prompt, hold. Phase 1 adds flash, paged and the
     overlay at this model's shapes (``phase1_vlm``);
 11. the encoder-decoder family: first phase 2's path parity at
     Whisper-large-v3's full width cut to 2 encoder + 2 decoder layers
     (float32, 1500 frames: the encoder, the memory rows in the chunks'
     caches and in the paged caches' slot), then Whisper-large-v3 at full
     width and all 32 + 32 layers (20 heads x 64, d_ff 5120, 1500 memory
     rows), bf16, random weights from the seed, served by phase 3's
     vendors (P at TP 2) in 64-token chunks to 8 requests of 1500 unit
     normal frames and 16-224 prompt tokens, with a prefix cache on both
     engines. P runs each encoder once (flash non-causal), each chunk's
     self-attention (flash) and cross-attention (flash non-causal over the
     memory rows); D places each request's memory rows and decodes
     (paged, and the per-slot cross-attention in plain ops). Exactly
     flash, paged and the overlay must launch, each as many times as the
     path predicts; the wire must carry every prompt position's KV
     (163,840 bytes a position) with the codec's headers and one tail a
     request of 245,760,000 bytes of memory rows and 128 of lengths, to
     the byte; every request must bypass both prefix caches (counted, no
     hit); the last-token and float32 first-token checks, beside the
     frames, hold. Phase 1 adds flash, paged, the overlay and the layout
     module's ``convert`` at this model's shapes (``phase1_encdec``);
 12. the planner, the open-loop load harness and the live autoscaler:
     the port's ``plan_deployment`` for llama2-7b under 1 request/s of
     256 + 32 tokens (TTFT SLO 2 s, TPOT 0.1 s) on the nominal
     ``h100-sxm`` spec for both stages, made executable by
     ``DeploymentPlan.to_cluster_spec`` with phase 3's vendors (P block
     16 nhbd TP 2, D block 32 nbhd TP 1; D's pool for 8 x 1088 rows) and
     launched by ``ClusterRuntime`` over shm: llama2-7b at full width and
     all 32 layers, bf16, random weights from the seed, each worker in
     its own process and CUDA context, a raw bf16 wire, 500-token chunks,
     admission at 8 queued requests or a TTFT EMA over 2 s. After 3
     untimed warmup requests, ``run_open_loop`` replays a bursty schedule
     (1 request/s on average over 30 s, 4 request/s in bursts) of
     ShareGPT-like lengths (prompts 32-1024, outputs 8-64) while a
     ``PDAutoscaler`` over ``ClusterLoadSource``, its baseline the plan's
     counts, ticks every 0.25 s and may grow one P and one D worker that
     join the pool when their hello lands. On one card a grown worker
     adds a CUDA context, not SMs: this shows the mechanism, not scaling.
     Offered must equal admitted + shed; every admitted request must
     finish; no failure, requeue, crash or stream failure; a shed request
     holds no token and streamed no chunk; at least one grow, at least
     one grown worker served, and a grown worker that reached its hello
     served, unless no request that the router's order ranked it first
     for went to its role while it was routable (from its hello to its
     drain, or to the end if it was kept); exactly flash, paged and the
     overlay launched in the open-loop run, summed over every worker
     (grown ones too; the counts are zeroed in every worker after the
     warmup); no segment left; then
     the parent builds the weights (none are held while workers live)
     and runs the last-token and float32 first-token checks on every
     finished request. It prints the plan, the schedule's digest, the
     counts, each action with its time, each grown worker's
     action-to-hello seconds, TTFT and TPOT p50/p95/p99, goodput,
     output tok/s, the plan beside the measurement and the tokens'
     digest. Phase 1 adds flash, paged and the overlay at this phase's
     shapes (``phase1_load``);
 13. training, on the path the reference trains on (plain attention in
     float32, no kernel; every kernel wrapper refuses a CUDA input that
     requires grad): Qwen3-4B, the reference's own training target, at
     full width. 13a: cut to 2 layers in float32 (TF32 off), parameters
     drawn once on the CPU and copied to the card, one 2 x 128 batch of
     ``SyntheticTokens``: the loss and every leaf's gradient on the card
     against the CPU's (loss within 1e-5 relative, each leaf's
     ||dg|| / ||g|| within 1e-4), then bf16 on the card against the
     float32 CPU gradients (within 5e-2 a leaf); every gradient finite
     and nonzero. 13b: all 36 layers in bf16, the train state drawn on
     the card (weights, float32 AdamW moments), ``make_train_step`` with
     remat and 2 micro-batches into a bf16 accumulator, 2 x 2048 tokens
     a step, one warmup step then 6 timed: a finite loss every step and
     the last at least 1 nat below the first, a positive grad norm, after
     the first step every leaf's first moment nonzero and every leaf
     changed but the norm weights (1.0 at init, where lr x 1.1 is below
     half a bf16 step); it prints the step seconds, tokens/s,
     ``max_memory_allocated`` and the draw's seconds. 13c: a tiny bf16
     train state saved from the card by the async checkpoint writer and
     restored onto it bit for bit, the next step's loss equal within
     1e-6. No kernel may launch in phase 13.
 14. the launch layer (``repro_torch.launch``: the cell grid, deploy
     configs, the step builders on the one-card mesh, the roofline).
     14a: Qwen3-4B's prefill_32k -> handoff -> decode_32k at full width
     and all 36 layers, both cells cut to batch 2: the prefill of 2 x
     32,768 random tokens from the seed, the handoff into D's 32,896-slot
     caches, 4 greedy decode steps. Exactly 36 flash launches (the
     prefill) and 4 x 36 flash_decode launches (each step's one-row
     attention over the full-capacity caches);
     D's caches bf16 and equal to P's bit for bit in slots 0..32,767,
     pos -1 in the pad slots; every logit finite; the one-shot prefill's
     last logits within PHASE14_LOGIT_STEPS bf16 steps (at the logits'
     largest magnitude) of a prefill in 512-token chunks (``decode_step``
     over a full-capacity cache, the q_offset flash route; the same flash
     kernel on both sides, so this holds the launch path, not the
     kernel), the argmax equal or the top-2 gap within the bound; layer
     0's 32k flash call on its last 512 query rows, and flash on the
     decode step's first one-row call (row 1d: the route before the
     one-row rule, kept as the reference for row 1q), against the float32
     plain version by the yardstick
     (FLASH_VS_SDPA); the roofline (``analyze_step`` on ``meta`` at full
     depth as the card runs it, the nominal H100 SXM constants) beside
     the measured seconds. 14b:
     DeepSeek-V2-Lite's prefill_32k at full width and all 27 layers,
     batch 1: exactly 27 flash launches (dk 192 / dv 128 at 32,768
     keys), finite logits, the capacity MoE (factor 1.25) under
     ``moe_shard_map`` with each layer's dropped share printed, and 2
     layers at 4,096 tokens under capacity factor 8 (no pair dropped)
     within PHASE14_LOGIT_STEPS bf16 steps of the exact ``moe_experts``;
     the MLA flash call by the yardstick. 14c:
     Qwen3-4B's train_4k through ``make_train_artifacts`` cut to 2 x
     4,096 tokens in 2 micro-batches: finite loss and grad norm, no
     kernel, no ``chunked_sdpa``; the MFU (6·N·D over the step seconds
     and the nominal 989.4 TFLOP/s). Each sub-phase prints
     ``mem_get_info`` before it, its peak memory and the predictions
     written before the phase first ran on the card
     (``PHASE14_PREDICTED``).
 15. the launch grid's last five cells, whose D caches the flash route
     cannot read, through the flash_decode kernel
     (``ops.cache_attention``). 15a: Qwen1.5-32B at full width cut to 4
     of 64 layers, batch 2: prefill_32k in bf16, the handoff into D's
     32,896-slot float8 e4m3 caches (the precision alignment), 4 greedy
     decode_32k steps; D's bytes equal to the CPU's e4m3 cast of P's
     caches (a table of the CPU's cast of every bf16 value, looked up on
     the card), the tags equal, -1 and zeros in the pad slots. 15b:
     Mixtral-8x7B cut to 12 of 32 layers and 15c: RecurrentGemma-9B at
     all 38 layers, batch 2: prefill_32k, the handoff into D's rings of
     the window (4096 / 2048 slots), 4 greedy decode_32k steps. Each
     part launches exactly one flash a layer that attends in the prefill
     and one flash_decode a layer that attends a step, nothing else.
     Every flash_decode call of every step (184 in all, 15d's included)
     is held, on its exact inputs, to the float32 plain version by the SDPA
     yardstick (max and mean error at most FLASH_VS_SDPA x those of
     ``scaled_dot_product_attention`` in bf16 on the same values). From
     copies of D's caches taken before the steps and fed the same tokens:
     the plain route (``sdpa`` under the reference's mask) in bf16, and
     the same steps in float32 (the config's compute dtype float32 on the
     same weights, plain route); the kernel route's max and mean logit
     error against the float32 steps at most FLASH_VS_SDPA x the plain
     bf16 route's (the bf16 model's own rounding puts both about three
     bf16 steps off: the gap between the two bf16 routes is printed
     beside a bound of PHASE15_LOGIT_STEPS bf16 steps at the logits'
     largest magnitude, and not held to it). For 15b and 15c also the
     same prefill handed into a full-capacity cache decoded through
     flash: the gaps and argmax against the ring route printed, not held
     (MoE routing near a tie flips under bf16's noise) — through
     flash_decode too, which takes every one-row step. 15c also times its
     decode step on the plain and the kernel route in turns (plain,
     kernel, kernel, plain), each from a fresh copy of the caches taken
     before the main path's steps. 15d: long_500k
     for both windowed models at batch 1: one serve step at q_offset
     524,288 over a slice of D's rings from the handoff with every tag
     shifted by 491,520 (each entry keeps its slot, every row sees the
     window's slots), exactly one flash_decode a layer that attends, each
     call held by the SDPA yardstick and the logits by the float32 one,
     then 4 steps on each route in turns as 15c.
     Phase 1 holds flash_decode against its plain version over small
     rings, full-capacity caches, windows, groups 1 / 4 / 16 at head
     dims 64 / 128 / 256 in float32, bf16 and float8 K/V, then times rows
     1r (Mixtral's and RecurrentGemma's rings, starting mid-buffer), 1f
     (Qwen1.5-32B's e4m3 cache) and 1q (Qwen3-4B's full-capacity bf16
     cache: phase 14a's one-row decode, row 1d's shape) by the SDPA
     yardstick (``phase1_decode``).
 16. the MLA and hybrid families across worker processes: phases 7 and
     8's serving again (phase 6's eight prompts, phase 3's vendors with P
     at TP 2 / TP 1, 500-token chunks, MAX_NEW tokens) through
     ``TwoProcessRuntime`` over shm, P and D each in a spawned worker that
     builds the weights on the card from the seed: 16a DeepSeek-V2-Lite
     at all 27 layers (the latent wire; two copies of the weights, one a
     worker), 16b RecurrentGemma-9B at all 38 (window-floored KV and the
     RG-LRU states' tail, staged from device memory into a pickled shm
     segment). Held to the in-process phase's record from earlier in the
     same run: the bytes under every wire key to the byte (a chunk's
     segment; a tail's arrays, its segment's pickle framing printed
     beside), the prefill tokens computed, each kernel's launches summed
     over the workers' counts (flash and the overlay equal; paged and
     gather, which launch a fixed number a decode step, equal per D step:
     D's step count follows the arrivals), every request finished with
     no stream failure, crash or requeue, no segment left after
     shutdown, and the tokens identical or, at the first difference, the
     token within the phase's own first-token yardstick or no further
     from its float32 best than the in-process token there (a decoded
     token of the record can itself sit past the yardstick: a decode step
     is not the prefill); the weights are built in the parent only after
     the workers are gone; which of these happened is printed;
 17. the examples and the launcher's ``--demo`` on the card, each in a
     subprocess of its own session (every process of it killed when it
     ends; all started at once, 17c running meanwhile) that must exit 0,
     its last lines printed: 17a ``python -m
     repro_torch.launch.serve --demo`` single-process (D0 fails at tick
     6, D2 joins at tick 14: at least one requeue) and at 2P2D over shm;
     17b ``examples/torch_serve_disagg.py`` (8 requests of 8 new tokens)
     with the modeled-RDMA connector, with ``--parity`` at 2P2D over shm
     (token-exact) and sized by the planner with the prefix cache; 17c
     its ``run_single(faults=True)`` in this process at llama2-7b's full
     width and depth in bf16 (the module's ``CFG`` / ``VENDOR_*`` set to
     llama2-7b and phase 3's vendors, phase 3's weights): at least one
     requeue, every request finished, D2 serving after its join, the main
     path's kernels launched, each requeued request's tokens equal to a
     fault-free run's or, at the first difference, within phase 3's
     first-token yardstick or no further from it than the fault-free
     run's token; 17d ``examples/torch_quickstart.py``,
     ``torch_plan_deployment.py`` and ``torch_train_tiny.py`` (100 of
     its 300 steps: its loss must fall by more than 0.5, the restored
     step's loss be finite). Phase 1 holds the float32 kernels at these
     examples' shapes (``phase1_demo``): flash at dk 64 (10 heads on 5 KV
     heads) over every 16-token chunk and at dk 16 (the quickstart),
     paged at head dim 64 in D's block-8 nbhd pools and at 16 in block 4,
     within 2e-5; the D-side re-page of every chunk from P's TP 5 card ==
     CPU and the overlay bit-identical, also to ``index_copy_``.
 18. a (data, model) = (1, 2) mesh of ranks: a world of two processes
     on the one card (``launch.ranks``; gloo, as NCCL refuses two ranks
     of one communicator on a device; its bfloat16 sum probed first),
     each holding the shards the launch layer's specs give it: 18a
     Qwen3-4B cut to 4 of its 36 layers, prefill_32k at batch 2 → the
     handoff's
     head_dim → capacity reshard (a block exchange) → 4 greedy steps
     whose flash_decode calls stop at each rank's partials and are
     combined over the ranks (``serve.programs_on_rank``, what ``launch.
     serve --mesh 1x2`` runs); 18b DeepSeek-V2-Lite's 27 layers,
     prefill_32k at batch 1 (MLA heads and the expert-TP MoE split, the
     router replicated). Held to one-card runs in the same call (18a: a
     run of the same cut in phase 18; 18b: phase 14b's): each
     prefill's gathered logits within PHASE18_LOGIT_STEPS bf16 steps and
     by the argmax rule, a control (the last layer's psums each missing
     the other rank's term) failing that bound; 18a's tokens; the
     attention and MLP / MoE sub-blocks of the first and last layers (and
     18b's first MoE layer) on their own inputs against float32 witnesses,
     within 3 x the one-card sub-block's error, each control failing it,
     the MoE's routes and drops there equal to one card's; 18b's dropped
     pairs equal on both ranks; D's shards of
     layers 0 and 11 bit for bit the realignment of P's, gathered; every
     rank's bytes of parameters and caches equal to ``per_chip_bytes`` at
     {"data": 1, "model": 2}; per rank exactly 12 flash, 48
     ``flash_decode_partial`` and 48 ``decode_combine`` (18a) and 27
     flash (18b). Phase 1's row 1h holds the partial + combine over two
     slot halves of row 1q's cache against the whole-cache call (one
     bf16 step) and the SDPA yardstick, and times both entries
     (``phase1_decode_halves``).
 19. the same world for the other attention-cache families, each part
     through ``serve.programs_on_rank`` and held as 18a: 19a Qwen1.5-32B
     (4 of 64 layers, batch 2: P's bf16 caches cast to e4m3 in the
     handoff), 19b Mixtral-8x7B (12 of 32, batch 2: rings of 4096 in slot
     halves with their tags, the expert-TP MoE), 19c RecurrentGemma-9B
     (38 layers, batch 2: the RG-LRU on the width's halves, its conv
     output gathered, beside rings of 2048 on one KV head), 19d
     DeepSeek-V2-Lite (27 layers, batch 1: MLA decode over capacity-
     sharded latents, each rank's half expanded through every head's
     ``w_ukv`` into flash_decode's partials at K 192 / V 128). 19a-19c
     are held to phase 15's one-card runs (kept on the host), 19d to a
     one-card run of its own (``phase19_one_card_mla``); the RG-LRU
     block's control zeroes the other rank's gathered ``xb``. 19b and
     19c also take one long_500k serve step at q_offset 524,288 over a
     batch-1 copy of D's ring halves with the tags shifted as 15d's
     (``long_traced``), held to 15d's logits. Phase 1's rows 1h-a..d
     time the partial + combine at those four decode shapes
     (``phase1_mesh_halves``).
 20. the same world for the SSD, vision and encoder-decoder families at
     full width and depth, each held as 19 holds its parts to a one-card
     run made at the mesh's deployed config (``one_card_run``,
     ``deployed_vocab``): 20a Mamba2-370M (48 layers, batch 2: the SSD
     computed whole on each rank, its conv tail in channel halves
     gathered before each conv; its control the embedding's psum missing
     the other rank's term, ``embed_controlled``; one long_500k step over
     a batch-1 copy of D's states, held to a one-card step over the same
     states), 20b InternVL2-2B (24 layers, batch 1: 256 patches before
     32,512 tokens, the vocab padded to 92,554), 20c Whisper-large-v3
     (32 + 32 layers, batch 1: the encoder's heads split over 1,500
     frames, the cross rows head_dim-sharded in P and D, gathered before
     each cross-attention). Rows 1h-e and 1h-f time the partial +
     combine at Whisper's and InternVL2's decode shapes.
 21. the data and pod axes: training through ``launch.train``'s rank
     program, each part held to a one-card step over the whole batch made
     first in this process (its final parameters and moments kept in
     pinned host memory while the ranks train, then mapped by them): 21a Qwen3-4B (12 of 36 layers, 2 x 4,096 tokens, the
     second sequence's last 1,000 labels -1) on (data 2, model 1): the
     gradients summed over the data axis, ZeRO-1 moments; 21b the same on
     (1, 2) with 2 micro-batches: the tensor-parallel backward, the bf16
     accumulator; 21c Phi3-medium-14B (4 of 40 layers, zero3) on (pod 2,
     data 1, model 2), four ranks: ZeRO-3 weights broadcast a layer at a
     time. Each holds the losses and gradient norms of a warm-up and two
     steps, every parameter and moment slice after the last in bf16 steps,
     a control (the data reduction skipped; the column entries' backward
     psum skipped; the pod's) past the norm's bound, bytes equal to
     ``per_chip_bytes``, the collectives' calls and bytes as predicted
     (``train_expected``), no launch. 21d serves 18a's cut on (data 2,
     model 1), one sequence a rank: flash and flash_decode (whole calls)
     on each rank, held to 18a's one-card run (tokens, logits in bf16
     steps, launches a rank).
 22. training every other family on 21c's world of four at (data 2,
     model 2), as 21's parts (2 x 4,096 tokens, one step at PHASE21_OPT),
     each witness one card stepping each data rank's rows on their own
     (the MoE's capacity is its shard's): 22a Mixtral-8x7B (2 of 32
     layers, ZeRO-3), 22b DeepSeek-V2-Lite (3 of 27, ZeRO-3: the dense
     first layer gathered inside it), 22c RecurrentGemma-9B (6 of 38,
     ZeRO-3, the 2,048 window biting), 22d Mamba2-370M (24 of 48), 22e
     InternVL2-2B (12 of 24, 256 patches a sequence), 22f
     Whisper-large-v3 (32 encoder layers over 1,500 frames, 8 of 32
     decoder layers). Each control leaves out a collective this slice's
     adjoints place (the router's model-axis sum, MLA's latent's, the
     RG-LRU's xb gather's split backward, the SSD weights' data sum, the
     whole data sum, the cross K/V gather's split backward; 22c also every
     column entry's), is run as a step and is judged on the leaves it
     touches; the MoE parts count the tokens whose experts flip against
     the witness's; the ranks drop the shared card's buffers after each
     part; no launch.

Each phase requires launches of exactly the kernels its path runs (counts
reset just before its serving loop; phase 5 sums the counts its worker
processes report at shutdown, phase 12 those of every worker it
started, zeroed after its warmup; phase 16 the sums of its workers'
counts; phase 17 its in-process run, 17c's faulted one). The kernels
line gives each kernel's
launches on every serving phase (phases 3-12, none on phase 9; 0 on
phase 13, training; phase 14: 14a's and 14b's main paths; phase 15: its
parts' main paths, 15d's included; phases 16 and 17; phase 21: 21d's on
both ranks, its training parts none; phase 22 none), and its timing at
phase 7's MLA
shape (``"mla"``), phase 8's RecurrentGemma shape (``"rg"``), phase
10's InternVL2 shape (``"vlm"``), phase 11's Whisper shape
(``"encdec"``), phase 12's (``"load"``) and phase 14's 32k shapes
(``"launch_p"``, ``"launch_d"``, ``"launch_k"``) where those phases run
it; flash_decode's row is phase 15's Mixtral ring, with RecurrentGemma's
ring as ``"rg"``, Qwen1.5-32B's e4m3 cache as ``"fp8"`` and Qwen3-4B's
full-capacity bf16 cache (row 1q) as ``"dense"``; flash, paged and the
overlay in float32 at the serving example's shapes as ``"demo"`` and
flash and paged at the quickstart's as ``"quickstart"``;
``flash_decode_partial`` (one half of row 1q's cache) and
``decode_combine`` (both halves' splits) are rows of their own, each
with the two-halves composition as ``"halves"`` (the partial's row also
carries phase 19's four shapes as ``"mesh_fp8"``, ``"mesh_ring"``,
``"mesh_rg"`` and ``"mesh_mla"`` and phase 20's two as
``"mesh_encdec"`` and ``"mesh_vlm"``), and their launches are phase
18's, summed over both ranks, with phase 19's and 20's in
``launches_by_phase``.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero. Without a CUDA device, or without
the repository's ``src/repro_torch`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3
SEED = 0
# kernels against their plain versions: tests/test_kernels.py's tolerances
# at the sweep shapes. At the main path's shapes bfloat16 is held tighter.
# Paged attention: both sides compute in float32 and round once, so an
# element may differ by one bfloat16 step (BF16_STEP of its size, above a
# floor for values near 0) where the two float32 results straddle a
# rounding boundary, and on average by far less than BF16_MEAN of the
# output's size. A product summed in bfloat16 or a store that truncates
# breaks one or the other. Flash rounds P to bfloat16 before P·V, as
# every tensor-core flash attention does, so it is held to a yardstick:
# its max and mean error against the float32 plain version at most
# FLASH_VS_SDPA times those of scaled_dot_product_attention on the same
# bfloat16 inputs.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_FLOOR, BF16_STEP, BF16_MEAN = 1e-4, 2.0 ** -7, 2.0 ** -12
FLASH_VS_SDPA = 2.0

MODEL = "llama2-7b"
# phase 2: path parity at full width, cut to 2 layers, float32
PARITY_LAYERS, PARITY_PROMPT, PARITY_STEPS, PARITY_CHUNK = 2, 300, 8, 128
PARITY_ATOL = 1e-3
# phase 3: the main path
N_REQUESTS, PROMPT_RANGE, MAX_NEW, PREFILL_CHUNK = 8, (256, 2048), 32, 500
P_VENDOR = dict(name="vendorP", block_size=16, layout="nhbd",
                kv_dtype="bfloat16", tp=2)
D_VENDOR = dict(name="vendorD", block_size=32, layout="nbhd",
                kv_dtype="bfloat16", tp=1)
LOGIT_SLACK = 0.25    # bf16 noise between the decoded and prefilled logits
# phase 4: the prefix-cache path. 1000 = 2 chunks, so cached and cold runs
# cut the same chunks; 1000 = 31*32 + 8 on D and 62*16 + 8 on P, so every
# hit ends in a copy-on-write of an 8-row page
PREFIX_LEN, TAIL_RANGE = 1000, (64, 512)
HOST_STORE_BYTES = 4 << 30   # P's host prefix store (host memory)
# phase 6: sliding window + MoE at full width, depth cut to 24 of 32 layers
# (a layer is 2.90 GB in bf16: 32 layers with embed and head come to ~93 GB,
# more than the card's 80; at 24 the serving peak, 70.0 GiB, leaves 9 of
# the card's 79.2). Six prompts exceed the window,
# five of them with a floor inside one of D's 32-row pages; two lie
# inside it.
MODEL6, LAYERS6 = "mixtral-8x7b", 24
PHASE6_PROMPTS = (8192, 7000, 6100, 5000, 4600, 4097, 3000, 2048)
# phase 7: MLA + MoE, DeepSeek-V2-Lite at full width and all 27 layers
# (16.2 B parameters, 30.2 GiB in bf16: it fits the card with no cut),
# phase 6's prompts. The latent ships 27 x (512 + 64) x 2 = 31,104 bytes a
# token; expanded per-head K and V would be 27 x 2 x 16 x 128 x 2 = 221,184
MODEL7 = "deepseek-v2-lite-16b"
PHASE7_KERNELS = ("flash_attention", "gather_pages", "scatter_pages_overlay")
# phase 8: the hybrid RG-LRU family, RecurrentGemma-9B at full width and all
# 38 layers (26 RG-LRU + 12 local MQA: 16 query heads on one KV head of
# 256, window 2048), phase 6's prompts. One KV head cannot split over TP 2,
# so P runs at TP 1. Each request's tail carries 26 x (4096 x 4 + 3 x 4096
# x 2) = 1,064,960 bytes of recurrent state. Path parity at full width,
# cut to its first 3 layers (rglru, rglru, attn), in float32
MODEL8, PARITY8_LAYERS = "recurrentgemma-9b", 3
P_VENDOR8 = dict(P_VENDOR, tp=1)
# phase 9: the Mamba-2 SSD family, Mamba2-370M at full width and all 48
# layers (d 1024, 32 SSD heads x 64, d_state 128, one group, chunk 256; no
# attention, no KV), phase 6's prompts, P at TP 1. Each request's tail
# carries 48 x (32 x 64 x 128 x 4 + 3 x 2304 x 2) = 50,995,200 bytes of
# states (h float32, the conv tail bf16)
MODEL9, PHASE9_TAIL_BYTES = "mamba2-370m", 50_995_200
# phase 10: the vision frontend, InternVL2-2B at full width and all 24
# layers (16 heads on 8 KV heads x 128), phase 3's prompts after 256 patch
# embeddings each (merged sequences of 512-2304 positions), P at TP 2
MODEL10, PHASE10_PATCHES = "internvl2-2b", 256
# phase 11: the encoder-decoder family, Whisper-large-v3 at full width and
# all 32 + 32 layers (20 heads x 64, 1500 memory rows), 8 requests of 1500
# frames and decoder prompts of 16-224 tokens (224: half of Whisper's 448
# decoder positions), P at TP 2, 64-token chunks so that prompts span 1-4
# chunks. Each request's tail carries 32 x 1500 x 20 x 64 x 2 x 2 =
# 245,760,000 bytes of memory rows (and 32 int32 lengths). Path parity at
# full width cut to 2 encoder + 2 decoder layers, in float32
MODEL11, PARITY11_LAYERS = "whisper-large-v3", 2
PHASE11_PROMPTS, PHASE11_CHUNK = (16, 224), 64
PHASE11_CROSS_BYTES = 245_760_000
# phase 12: the planner, the open-loop load harness and the live P/D
# autoscaler. llama2-7b at full width and depth from the port's plan for
# this workload on the nominal h100-sxm spec (1P1D), launched through
# ClusterRuntime with phase 3's vendors, D's pool sized for 8 x 1088 rows
# (prompts <= 1024, outputs <= 64). Traffic: a two-state bursty process
# averaging 1 request/s over 30 s (4 req/s in bursts a quarter of each
# ~2 s period), ShareGPT-like lengths (prompt median ~245, output ~30)
PHASE12_PLAN = dict(qps=1.0, input_len=256, output_len=32, slo_ttft_s=2.0,
                    slo_tpot_s=0.1)
PHASE12_RATE, PHASE12_DURATION_S, PHASE12_SEED = 1.0, 30.0, 7
PHASE12_BURSTS = dict(burst_factor=4, duty=0.25, period_s=2.0)
PHASE12_WORKLOAD = dict(vocab_size=32000, prompt_mu=5.5, prompt_sigma=0.6,
                        prompt_min=32, prompt_max=1024, output_mu=3.4,
                        output_sigma=0.4, output_min=8, output_max=64)
PHASE12_WARMUP = dict(n=3, seed=8, max_new_tokens=2)
PHASE12_MAX_BATCH, PHASE12_MAX_SEQ = 8, 1088
PHASE12_ADMISSION = dict(max_queue_depth=8, slo_ttft_s=2.0, headroom=1.0)
PHASE12_AUTOSCALER = dict(slo_ttft_s=2.0, slo_tpot_s=0.1, cooldown_ticks=8,
                          max_p=2, max_d=2)
PHASE12_TICK_S = 0.25
# phase 13: training. Qwen3-4B, the reference's own training target
# (launch/train.py's default arch, launch/cells.py's qwen3-4b@train_4k), at
# full width: d 2560, 32 heads on 8 KV heads x 128 with qk-norm, d_ff 9728,
# vocab 151,936, untied head; 4,411,424,256 parameters. 13a: float32
# parity card vs CPU at full width cut to 2 layers (batch 2 x 128), and
# bf16 on the card against the float32 CPU gradients. 13b: all 36 layers in
# bf16 with remat and 2 micro-batches of 1 x 2048 (8.22 GiB of weights,
# 32.87 GiB of float32 moments, an 8.22 GiB bf16 accumulator). 13c: a tiny
# bf16 state checkpointed from the card and restored onto it
MODEL13 = "qwen3-4b"
PHASE13_PARITY = dict(layers=2, batch=2, seq=128)
PHASE13_F32_REL = 1e-4       # per leaf, ||g_card - g_cpu|| / ||g_cpu||
PHASE13_LOSS_RTOL = 1e-5
PHASE13_BF16_REL = 5e-2      # per leaf, bf16 on the card vs float32 CPU
PHASE13_TRAIN = dict(batch=2, seq=2048, n_micro=2, warmup=1, timed=6)
PHASE13_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100,
                   weight_decay=0.1, grad_clip=1.0)
PHASE13_MIN_DROP = 1.0       # nats from the first step's loss to the last
PHASE13_CKPT_MODEL = dict(name="ckpt-tiny", family="dense", num_layers=2,
                          d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          qk_norm=True)


# phase 14: the launch layer (cells, deploy configs, step builders, the
# roofline) on one card. 14a: Qwen3-4B's prefill_32k -> handoff ->
# decode_32k at full width and all 36 layers, both cells cut to batch 2
# (from 32 and 128); 14b: DeepSeek-V2-Lite's prefill_32k at full width and
# all 27 layers, batch 1 (from 32), the capacity MoE under moe_shard_map;
# 14c: Qwen3-4B's train_4k cut to 2 x 4096 tokens in 2 micro-batches (from
# 256 x 4096 in 16). The predictions were written down before the phase first
# ran on the card and are printed beside what is measured; 14a's launches
# and decode step are the one-row route's (flash_decode for each step's
# attention), predicted before that route first ran.
MODEL14, MODEL14B = "qwen3-4b", "deepseek-v2-lite-16b"
PHASE14_BATCH = {"14a": 2, "14b": 1, "14c": 2}
PHASE14_DECODE_STEPS = 4
PHASE14_CHECK_CHUNK = 512     # the chunked cross-check's decode_step chunk
PHASE14_FLASH_ROWS = 512      # query rows of the 32k slice held to plain
# 14a's one-shot vs chunked last logits and 14b's capacity MoE vs the
# exact moe_experts: at most this many bf16 steps at the logits' largest
# magnitude (both read 0.0 on the card: NVIDIA H100 80GB HBM3, 700.00 W)
PHASE14_LOGIT_STEPS = 1
PHASE14B_PARITY = dict(layers=2, seq=4096, capacity_factor=8.0)
PHASE14C_TRAIN = dict(warmup=1, timed=2)
PHASE14_PREDICTED = {
    "14a": {"flash_launches": 36, "flash_decode_launches": 4 * 36,
            "prefill_s": [2.5, 4.0], "decode_ms_per_step": [33.0, 42.0],
            "max_abs_logit_gap": [0.01, 0.15], "peak_gib": [26, 40],
            "flash_slice_max_abs_err": [0.0, 2e-2]},
    "14b": {"flash_launches": 27, "prefill_s": [1.5, 6.0],
            "peak_gib": [33, 45], "parity_max_abs": [0.005, 0.05],
            "dropped_share": [0.0, 0.05]},
    "14c": {"step_s": [4.2, 4.7], "peak_gib": [66, 70],
            "mfu": [0.046, 0.052]},
}

# phase 15: the launch grid's last five cells on one card, through the
# flash_decode kernel (D's caches: rings of the window, or float8). 15a:
# Qwen1.5-32B's prefill_32k (bf16) -> handoff (the e4m3 cast) -> 4
# decode_32k steps, at full width cut to 4 of 64 layers (a layer is 1.05
# GB of bf16 weights and 671 MB of bf16 KV a 32k sequence; the embedding
# and head 3.1 GB), batch 2 (from 32 and 128). 15b: Mixtral-8x7B cut to 12
# of 32 layers (2.9 GB a layer; at 8, 15d's one-token step meets a near-tie
# of the router that the kernel route breaks the other way), 15c:
# RecurrentGemma-9B at all 38 layers (15a had 16 layers until phase 19,
# which runs these cells again on a mesh of ranks, made the script need
# the time), both prefill_32k -> handoff into D's
# rings -> 4
# decode_32k steps at batch 2, against the same prefill in a
# full-capacity D cache (through flash_decode too, which takes every
# one-row step) and against the plain route. 15d:
# long_500k for both at batch 1: one serve step at q_offset 524,288 over
# D's rings from the handoff with every tag shifted by PHASE15_SHIFT =
# 120 x 4096 = 240 x 2048 (each row keeps its slot, the window is full;
# the rows' RoPE phases are the old positions': this holds the route, not
# the model's meaning), against the plain route. Each flash_decode call of
# the last step is held on its own inputs to the float32 plain version by
# the SDPA yardstick, and each route's logits to float32 steps of the same
# weights; the gaps to the plain bf16 route are printed beside one bf16
# step. The predictions were
# written down before the phase first ran on the card, at 16 / 12 / 38
# layers. 15a is cut to 4 layers (8 until phase 20 joined the script: its
# mesh part 19a, held to it, took 92 s of phase 19 at 8 on an NVIDIA
# H100 80GB HBM3 at 700.00 W).
PHASE15_MODELS = {"15a": ("qwen1.5-32b", 4), "15b": ("mixtral-8x7b", 12),
                  "15c": ("recurrentgemma-9b", 38)}
PHASE15_BATCH, PHASE15_DECODE_STEPS = 2, 4
PHASE15_SHIFT = 491_520
PHASE15_TURNS = ("15c",)      # parts whose decode step is timed in turns
# the printed gaps' bound, bf16 steps at the logits' largest magnitude (not
# held: the plain bf16 route is itself about 3 steps from float32 at 16+
# layers; NVIDIA H100 80GB HBM3, 700.00 W)
PHASE15_LOGIT_STEPS = 1
PHASE15_PREDICTED = {
    "15a": {"flash_decode_launches": 16 * 4, "prefill_s": [2.5, 6.0],
            "decode_ms_per_step": [12.0, 60.0], "peak_gib": [45, 66],
            "max_abs_logit_gap_plain": [0.0, 0.0625]},
    "15b": {"flash_decode_launches": 12 * 4, "prefill_s": [1.5, 8.0],
            "decode_ms_per_step": [15.0, 120.0], "peak_gib": [38, 50],
            "max_abs_logit_gap_full": [0.0, 0.0625]},
    "15c": {"flash_decode_launches": 12 * 4, "prefill_s": [2.0, 12.0],
            "decode_ms_per_step": [15.0, 120.0], "peak_gib": [24, 40],
            "max_abs_logit_gap_full": [0.0, 0.0625]},
    "15d": {"flash_decode_launches": 12 + 12,
            "max_abs_logit_gap_plain": [0.0, 0.0625]},
    "phase_s": [50, 120],
}

# phase 16: phases 7 and 8's serving again through TwoProcessRuntime (P and
# D each in a spawned worker process with its own weights from SEED, the
# wire over shm): DeepSeek-V2-Lite at all 27 layers (two copies of its
# 29.3 GiB of bf16 weights, one a worker: no cut) and RecurrentGemma-9B at
# all 38, with phases 7 and 8's vendors, prompts, chunk and MAX_NEW
PHASE16_PARTS = {"16a": (7, MODEL7, P_VENDOR), "16b": (8, MODEL8, P_VENDOR8)}
# the kernels a D decode step launches (a fixed number each step); the
# rest launch a fixed number each prefill chunk
STEP_KERNELS = ("paged_attention", "gather_pages")
# phase 17: the examples and the launcher's --demo. The serving example
# runs at the demo's size (8 requests of 8 new tokens) in every run, 17c
# in this process at llama2-7b's full width and depth with phase 3's
# vendors; train_tiny is cut to 100 of its default 300 steps (its loss
# falls from 10.0 to 4.9 by step 50 on the card: NVIDIA H100 80GB HBM3,
# 700.00 W)
PHASE17_REQUESTS, PHASE17_MAX_NEW = 8, 8
PHASE17_TRAIN_STEPS = 100
PHASE17_RUN_TIMEOUT_S = 300
# phase 18: the launch programs on a (data, model) = (1, 2) mesh of ranks
PHASE18_MESH = (1, 2)
# 18a's depth: 4 of Qwen3-4B's 36 layers (all 36 until the script grew
# phase 19, 12 until phase 20), held to a one-card run of the same cut in
# this phase
PHASE18A_LAYERS = 4
PHASE18_CHECK_LAYERS = (0, 3)      # 18a's layers whose reshard is held
PHASE18_TIMEOUT_S = 900            # the world's limit on one call
# the layers whose attention and MLP / MoE sub-blocks are held on their
# own inputs (``SubBlocks``): the first and last, and 18b's first MoE layer
PHASE18_PROBE_LAYERS = {"18a": (0, 3), "18b": (1, 26)}
# a mesh sub-block's max and mean error against its float32 witness, at
# most this many times the one-card sub-block's on the same input; each
# control (the other rank's psum term left out) must fail it
PHASE18_WITNESS_FACTOR = 3.0
# the gathered prefill logits against the one-card run's: at most this many
# bf16 steps at the one-card logits' largest magnitude; the control (the
# last layer's two psums each missing the other rank's term) must fail it
PHASE18_LOGIT_STEPS = 16
PHASE18_PREDICTED = {
    "backend": "gloo (two ranks share the one card)",
    "gloo_sums_bfloat16": True,
    "18a": "prefill 15-60 s (several times 14a's 2.7 s: per layer two "
           "psums of the float32 partials (2, 32768, 2560) = 671 MB and the "
           "K/V head_dim gathers cross the host), handoff 1-5 s, decode "
           "steps 0.1-0.5 s; each rank ~4.0 GB of weights and 4.83 / 4.85 "
           "GB of P / D caches, peak 15-22 GiB; launches a rank: flash 36, "
           "flash_decode_partial 144, decode_combine 144; logits within "
           "1 bf16 step of 14a's, tokens 14a's",
    "18b": "prefill 10-40 s; each rank ~15 GB of weights; flash 27 a rank;"
           " logits within 1 bf16 step of 14b's; drops equal between the "
           "ranks, and within a few pairs a layer of 14b's (TP's partial "
           "sums move the router's input by rounding: near-ties flip)",
    "phase_s": "60-200",
    # written before the partials were summed in bf16 and the sub-blocks
    # held against float32 witnesses
    "bf16_psums": "18a prefill 35-60 s (the float32 partials' psums took "
                  "66.6 of 74.35 s; bf16 halves their bytes), logits 2-8 "
                  "bf16 steps from 14a's (float32 partials: 2.02), 18b 3-10 "
                  "(4.38), each control > 30 steps; sub-blocks on the same "
                  "input: mesh error against float32 1.0-2.0 x the one "
                  "card's at the max, 1.0-1.5 x at the mean, every control "
                  "> 20 x; MoE routes and drops on the same input equal",
}

# phase 19: the remaining attention-cache families on the same (1, 2) mesh
# of ranks, each held to its one-card run in this call: 19a-19c to phase
# 15's (same seed, prompts, depth — 4, 12 and 38 layers — and batch), 19d
# to a one-card run of
# DeepSeek-V2-Lite's prefill -> handoff -> 4 steps that phase 19 makes
# itself (no other phase decodes that cell on one card). (arch, layers —
# None: all —, batch, MoE routes traced)
PHASE19_PARTS = {"19a": ("qwen1.5-32b", 4, 2, False),
                 "19b": ("mixtral-8x7b", 12, 2, True),
                 "19c": ("recurrentgemma-9b", None, 2, False),
                 "19d": (MODEL14B, None, 1, True)}
PHASE19_HELD = {"19a": "15a", "19b": "15b", "19c": "15c"}
# layers (model order) whose D shards are held to the reshard of P's: the
# first and last, and 19c's first attention (a ring) and last RG-LRU
# state beside them
PHASE19_CHECK_LAYERS = {"19a": (0, 3), "19b": (0, 11),
                        "19c": (0, 2, 35, 37), "19d": (0, 26)}
# the sub-blocks held on their own inputs against float32 witnesses: the
# first and last attention layers' attention, the last layer's blocks
# (whose psums the end-to-end control leaves out: 19c's last layer is an
# RG-LRU block and an MLP), Mixtral's first MoE layer, 19c's first RG-LRU
# block, 19d's first and last layers whole and its last MLA decode of the
# first step
# the logit bound of a part held tighter than PHASE18_LOGIT_STEPS: at
# RecurrentGemma's 38 layers the last layer's MLP psum, left out, moves
# the logits 8.0 bf16 steps (on the card: NVIDIA H100 80GB HBM3, 700.00
# W), as the embedding's sqrt(d) scale dwarfs a layer's output, so 16
# steps could not see a missing psum there; the run itself reads 5.25
PHASE19_LOGIT_STEPS = {"19c": 8}
PHASE19_PROBES = {
    "19a": {"blocks": ((0, "attn"), (3, "attn"), (3, "mlp"))},
    "19b": {"blocks": ((0, "attn"), (0, "moe"), (11, "attn"))},
    "19c": {"blocks": ((0, "rglru"), (2, "attn"), (35, "attn"),
                       (37, "rglru"), (37, "mlp"))},
    "19d": {"layers": (0, 26), "mla_decode": 26}}
PHASE19_PREDICTED = {
    "19a": "each rank ~10 GB of weights, 10.7 GB of P caches and 5.4 GB of "
           "e4m3 D caches; ~21.5 GB of bf16 psums a rank, prefill ~30 s; "
           "launches a rank: flash 16, partial and combine 64 each",
    "19b": "~17.7 GB of weights a rank, rings of 2 x 2048 slots; ~13 GB "
           "of psums, prefill ~18 s; flash 12, partial and combine 48",
    "19c": "~10.4 GB of weights a rank; ~41 GB of psums plus the xb "
           "gathers of 26 RG-LRU layers, prefill 60-75 s; flash 12, "
           "partial and combine 48",
    "19d": "18b's prefill (~11 s), the latent halves handed off with no "
           "bytes crossing, 4 steps each expanding ~170 MB of latent a "
           "rank and layer; flash 27, partial and combine 108",
    "phase_s": "under 240",
    # written at 16 / 12 / 38 layers (19a-19c) and before these cuts
    "cut": "at 8 / 8 / 12 layers: prefills ~26 / ~16 / ~25 s, parts "
           "~65 / ~30 / ~40 / ~21 s, phase 19 140-170 s; 19c's end-to-end "
           "control (its last layer now an attention layer) past 16 steps "
           "(19b then went back to 12 layers: see PHASE15_MODELS)",
}

# phase 20: the SSD, vision and encoder-decoder families on the same (1, 2)
# mesh of ranks, at full width and depth, each held to a one-card run made
# in this phase at the mesh's deployed config (``deployed_vocab``:
# InternVL2's 92,553 rows padded to 92,554). (arch, batch)
PHASE20_PARTS = {"20a": ("mamba2-370m", 2), "20b": ("internvl2-2b", 1),
                 "20c": ("whisper-large-v3", 1)}
PHASE20_CHECK_LAYERS = {"20a": (0, 47), "20b": (0, 23), "20c": (0, 31)}
# 20a: the first and last SSD blocks of the prefill and the last layer's
# SSD step of the first decode step (its control zeroes the other rank's
# conv-tail channels); 20b: the first and last layers' attention and MLP;
# 20c: the encoder's first attention, the decoder's first and last
# self-attention, its last cross-attention and MLP (the end-to-end
# control leaves out the last layer's three psums)
PHASE20_PROBES = {
    "20a": {"blocks": ((0, "ssd"), (47, "ssd")), "ssd_decode": 47},
    "20b": {"layers": (0, 23)},
    "20c": {"blocks": ((0, "enc_attn"), (0, "attn"), (31, "attn"),
                       (31, "cross"), (31, "mlp"))}}
# the logit bound of a part held tighter than PHASE18_LOGIT_STEPS: with
# the last decoder layer's cross-attention and MLP psums left out,
# Whisper's logits moved 12.5 bf16 steps (on an NVIDIA H100 80GB HBM3
# at 700.00 W), inside 16, against the run's own 2.5; so
# the control now also leaves out that layer's self-attention psum and
# the bound is 8 steps, as 19c's (a check tightened, not loosened)
PHASE20_LOGIT_STEPS = {"20c": 8}
# the parts that also take one long_500k serve step over a batch-1 copy of
# D's shards (``long_traced``): 19b's and 19c's rings, held to 15d's
# logits; 20a's states, held to a one-card step over the same states
PHASE20_LONG = ("19b", "19c", "20a")
PHASE20_PREDICTED = {
    "20a": "no kernel and no psum but the embedding's; the SSD computed "
           "whole on each rank (prefill of 2 x 32,768 tokens 5-25 s, two "
           "ranks sharing the card), ~0.1 GB of collectives a rank (the "
           "conv tails' gathers, the embedding's psums); logits within 1 "
           "bf16 step of the one-card run's (no reduction differs but the "
           "head's column split), the embedding control far past 16 steps",
    "20b": "~2.2 GB of weights a rank, P caches 1.6 GB a rank; ~9.7 GB of "
           "collectives a rank (two bf16 psums of 134 MB and the K/V "
           "head_dim gathers a layer), prefill 15-30 s; logits 2-8 bf16 "
           "steps from one card's; flash 24, partial and combine 96 a rank",
    "20c": "~1.6 GB of weights a rank; ~13.7 GB of collectives a rank "
           "(three bf16 psums of 84 MB and the self K/V gathers a decoder "
           "layer, the encoder's 32 layers at 1,500 frames), prefill 20-40 "
           "s; flash 96 + 32 a step (cross) = 224, partial and combine 128",
    "long_500k": "19b / 19c within their logit bounds of 15d's (the mesh's "
                 "prefill drifts 2-8 bf16 steps from one card's, and the "
                 "long step inherits it), 20a within 1 step of its one-card "
                 "step over the same states; each control past the bound",
    "phase_s": "70-130 (19: +5-10 s for its two long steps)",
}

# phase 21: the data and pod axes of a mesh of ranks. Training parts:
# (arch, layers, mesh shape, n_micro) — 21a Qwen3-4B's train_4k on (data 2,
# model 1): data-parallel gradients and ZeRO-1 moments; 21b the same on
# (1, 2): the tensor-parallel backward and the bf16 accumulator; 21c
# Phi3-medium-14B's (its cell has zero3) on (pod 2, data 1, model 2): the
# pod axis, ZeRO-3 weights on the layer axis. Each is held to a one-card
# step over the whole batch at the same cut, made in this phase first.
PHASE21_TRAIN = {"21a": ("qwen3-4b", 12, (2, 1), 1),
                 "21b": ("qwen3-4b", 12, (1, 2), 2),
                 "21c": ("phi3-medium-14b", 4, (2, 1, 2), 1)}
PHASE21_BATCH = 2                  # sequences of 4,096 tokens
PHASE21_STEPS = 2                  # held steps after one warm-up
# label -1 on the last positions of the second sequence only, so that the
# data shards hold different counts of labels >= 0 (the global mean)
PHASE21_UNLABELED = 1000
# each training part's control: the reduction left out of its gradients
# (21c: the pod axis is its data plane)
PHASE21_CONTROL = {"21a": "data_grads", "21b": "column_entry",
                   "21c": "data_grads"}
# after the main path's steps (the default AdamW: its warm-up's rate,
# 3e-6 to 9e-6, moves almost no bfloat16 weight), one update step at
# AdamW's peak rate (a weight of 0.02 moves ~2.5 bf16 steps), whose
# update is held; its batch is the next seed's
PHASE21_OPT = {"lr": 3e-4, "warmup_steps": 1}
# the bounds, against the one-card steps at the same cut (written before
# the run): the loss of each step within this relative gap; the gradient
# norm of each step within this relative gap, the control's first-step
# norm past it; every parameter after the main path within this many
# bf16 steps of its one-card leaf's largest magnitude; each parameter
# leaf's update in the update step within this relative L2 gap of the
# one-card update of the rank's slice — an element whose gradient is
# near zero takes the sign of bf16 noise, a step of 2 lr apart — and the
# same update with the other data ranks' ZeRO-1 slices left as they were
# (a step without the gather-back) past it; each moment's slice after
# the update step within this many bf16 steps of its one-card leaf's
# largest magnitude
PHASE21_LOSS_RTOL = 1e-3
PHASE21_GNORM_RTOL = 2e-2
PHASE21_PARAM_STEPS = 1
PHASE21_UPDATE_RTOL = 0.4
PHASE21_MOMENT_STEPS = 16
# 21d: Qwen3-4B prefill_32k -> handoff -> PHASE14_DECODE_STEPS greedy steps
# on a (data 2, model 1) world, one sequence a rank, held to phase 18's
# one-card run of the same cut (PHASE18A_LAYERS, batch 2): the tokens, and
# the gathered prefill logits within this many bf16 steps (the control:
# the rows swapped)
PHASE21_SERVE_MESH = (2, 1)
PHASE21_LOGIT_STEPS = 4
PHASE21_PREDICTED = {
    "21a": "loss and grad norm within 1e-4 / 5e-3 of one card's, params "
           "within 1 bf16 step (mostly equal: the warm-up's learning rate "
           "moves few bf16 weights), the update step's worst leaf 0.08-0.25 "
           "relative L2 from one card's, its gather-back control 0.65-0.75, "
           "moments 3.5-10 steps; the gradient control's norm 30-60 % off; "
           "~3.2 GB of weights and 6.4 GB of moments a rank, peak 24-32 GiB "
           "a rank; steps 2-4 s",
    "21b": "loss within 1e-4, grad norm within 5e-3 (the backward psums "
           "in bf16), the update step's worst leaf 0.1-0.3 relative L2, "
           "moments 3.5-10 steps; the control's norm far off; ~1.6 GB of "
           "weights and 6.4 GB of moments a rank; steps 2-4 s",
    "21c": "loss within 1e-4, grad norm within 5e-3, the update step's "
           "worst leaf 0.08-0.25 relative L2, moments 3.5-10 steps; the "
           "control's norm 30-60 % off; every leaf split four ways (no "
           "ZeRO-1 leaf): ~0.85 GB of weights and 3.4 GB of moments a rank, "
           "peak 6-16 GiB a rank; steps 1.5-4 s",
    "21d": "each rank the one-card program on its row: logits 0-2 bf16 "
           "steps from the one-card run's, tokens equal; launches a rank "
           "flash 4, flash_decode 16 (whole calls: model axis 1); 5 logit "
           "gathers of 303,872 B a rank; prefill 2-5 s",
    "phase_s": "100-140",
}

# phase 22: training every other family on a mesh of ranks — one world of
# four at (data 2, model 2) for every part: (arch, layers) of each part's
# train_4k cell at PHASE21_BATCH sequences of 4,096 tokens (one a data
# rank; the second's last PHASE21_UNLABELED labels -1), n_micro 1 (a cut
# from the cells' 8-16), ZeRO-3 as the cells set it (Mixtral, DeepSeek,
# RecurrentGemma). Cuts: 22a Mixtral-8x7B to 2 of 32 layers (its 4,096
# window never bites at 4,096 tokens), 22b DeepSeek-V2-Lite to 3 of 27
# (the dense first layer, a group of count 1 under ZeRO-3, then 2 MoE
# layers), 22c RecurrentGemma-9B to 6 of 38 (two rounds of its (RG-LRU,
# RG-LRU, attention) pattern; its 2,048 window bites), 22d Mamba2-370M
# to 24 of 48, 22e InternVL2-2B to 12 of 24 (256 patches a sequence),
# 22f Whisper-large-v3's decoder to 8 of 32 (its encoder whole, over
# 1,500 frames): the whole script within its time (at full depth these
# three took 21.6, 27.1 and 42.7 s on the card, PERF.md).
PHASE22_MESH = (2, 2)
PHASE22_TRAIN = {"22a": ("mixtral-8x7b", 2),
                 "22b": ("deepseek-v2-lite-16b", 3),
                 "22c": ("recurrentgemma-9b", 6),
                 "22d": ("mamba2-370m", 24),
                 "22e": ("internvl2-2b", 12),
                 "22f": ("whisper-large-v3", 8)}
# the main path is one step at PHASE21_OPT from the seed's weights (phase
# 21's update step, with no default-rate steps before it: at the
# warm-up's rate the zero-initialised leaves — conv and gate biases —
# move by +-lr, where a near-zero gradient's sign is bf16 noise)
PHASE22_STEPS = 0
# each part's controls: the collective it leaves out
# (``collectives.skipping``) and the leaves it is judged on (path keys).
# Each control is run as a whole step at PHASE21_OPT from the part's
# first state, then the state is put back. Its gradients over those
# leaves, a relative L2 gap from the one-card witness's (each leaf's
# squares summed over the plane of the axes that split it), must miss the
# bound that the main path's meet; so must the update over its leaves
# (the rank's slices) of at least one control of the part — the update
# bound's control. 22c's xb control moves w_x's gradients by a few per
# cent (the gate products' share of xb's gradient), which flips too few
# signs of its first AdamW step to miss the update bound; its
# column-entry control (phase 21b's, every column entry's sum over the
# model axis left out) is the update bound's control there
PHASE22_CONTROLS = {
    "22a": [("moe.router", ("['router']",))],
    "22b": [("moe.router", ("['router']",)),
            ("mla.latent", ("['w_dkv']", "['kv_norm']"))],
    "22c": [("rglru.xb", ("['w_x']",)), ("column_entry", ("['w_x']",))],
    "22d": [("data_grads:ssd", ("['ssd']",))],
    "22e": [("data_grads", ("['embed']",))],
    "22f": [("cross.kv", ("['cross']['wk']", "['cross']['wv']"))],
}
# the bounds of a phase 22 part (its bf16 step against one card's): the
# touched leaves' gradients within PHASE22_GRAD_RTOL; every parameter
# leaf's update within PHASE21_UPDATE_RTOL; every moment leaf (mu and nu,
# the rank's slice) within PHASE22_MOMENT_RTOL relative L2. The moments'
# control: the rank's moments before its step (a leaf never written,
# zero: 1.0 off), held leaf by leaf, the least-missed leaf past the
# bound. The first step's moments are functions of its gradients (mu of
# g, nu of g squared, both scaled by the clip): the control steps'
# moments over their leaves are recorded beside them. Each gradient
# bound lies between the main path's gap and its controls' as measured
# on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 32): the rank's
# bf16 partials are rounded before their psum, one card's products once,
# through 24-64 layers of backward — 2.2-3.6 % off in 22c-22e (the
# prediction of 0.1-1.5 % was wrong), their controls 63-94 % (22c's xb
# 4.5 %)
PHASE22_GRAD_RTOL = 0.1
PHASE22_MOMENT_RTOL = 0.35
# the parts' own bounds, each with its reason. The MoE parts: a token
# whose top-k scores nearly tie may take another expert on the mesh than
# on one card, and its whole contribution moves — the router's
# gate-weight gradient, the gradients flowing back into the latent, the
# router's first update. The part counts those tokens (``flips``: the
# tokens of each MoE layer whose top-k set differs from the witness's in
# the first forward; the router's gap on a data rank is its layer's,
# ZeRO-3 splitting the layer axis): measured 12-16 % off against
# controls of 71-76 %, updates 0.36-0.45 against controls of 1.0-1.05.
# 22c: its xb control moves w_x's gradients little (the gate products'
# share of xb's gradient): measured 2.2-2.5 % off, the control 4.5 %.
PHASE22_BOUNDS = {
    "22a": {"grad": 0.25, "update": 0.6},
    "22b": {"grad": 0.25, "update": 0.6},
    "22c": {"grad": 0.035},
}
# written before the run of each part on the card (22a and 22b: before
# their first run; their bounds above after it, with their reason)
PHASE22_PREDICTED = {
    "22a": "Mixtral x2 ZeRO-3: ~1.58 GB of weights and 6.3 GB of moments "
           "a rank; loss within 1e-4 and norm within 5e-3 of the "
           "per-shard witness; the router's gradients 1-10 % off (near-tie "
           "expert flips from the bf16 partials of wo summed over the "
           "model axis: possibly past 1e-2), its control 50-75 %; update "
           "0.1-0.4; witness peak 45-55 GiB; part 25-45 s. Then (before "
           "the run of the controls as steps): the control's update "
           "0.9-1.3 and moments 0.4-1.0 relative L2; the main path's "
           "moments 0.02-0.3 at the worst leaf; tens to hundreds of "
           "flipped tokens a layer, the router's gap larger on the layer "
           "with more",
    "22b": "DeepSeek x3 ZeRO-3 (the dense first layer gathered inside it): "
           "~0.45 GB of weights a rank; the latent's gradients 0.3-2 % "
           "off, its control 40-75 %; the router as 22a's; part 15-30 s",
    "22c": "RecurrentGemma x6 ZeRO-3 (the 2,048 window bites): w_x's "
           "gradients 0.3-1.5 % off, the control (xb's split backward "
           "left out) 30-75 %, its update 0.9-1.3 and moments 0.3-1.0; "
           "update 0.1-0.4 and moments 0.02-0.3 at the worst leaf; "
           "witness peak 35-45 GiB; rank peak 8-14 GiB beside the 256,000 "
           "vocab's logits; part 15-30 s",
    "22d": "Mamba2 x48 (no ZeRO-3; SSD weights whole on each rank, summed "
           "over the data axis alone): the SSD gradients 0.1-1.5 % off, "
           "the control (their data sum left out) 40-80 %, its update "
           "0.9-1.3 and moments 0.4-1.0; update 0.1-0.4, moments 0.02-0.3; "
           "part 15-30 s",
    "22e": "InternVL2 x24 (256 patches a sequence, labels -1 there): the "
           "embedding's gradients 0.1-1.5 % off, the control (the whole "
           "data sum left out) 40-80 %, its update 0.9-1.3, moments "
           "0.4-1.0; update 0.1-0.4, moments 0.02-0.3; part 10-25 s",
    "22f": "Whisper x32+32 (1,500 frames; the encoder under remat): the "
           "cross K/V weights' gradients 0.3-2 % off, the control (their "
           "gather's split backward left out) 30-75 %, its update 0.9-1.3, "
           "moments 0.3-1.0; update 0.1-0.4, moments 0.02-0.3; part 15-35 s. "
           "At the cut depths of 22d-22f (after their full-depth run): "
           "parts 10-16, 12-18 and 20-28 s",
    "phase_s": "70-150 (after the full-depth run: 130-150)",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, reps: int = 3):
    """Device time of one call of ``fn``: CUDA events around replays of a
    CUDA graph that holds ``iters`` calls, so the host's enqueue is out of
    the time. Returns (ms, method). Where a capture fails, the kernels'
    own time from ``torch.profiler`` instead, and the method says so."""
    import torch
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages())
        return us / 1e3 / iters, "profiler"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters), "cuda_graph"


def host_us(fn, iters: int = 20) -> float:
    """Host time of one call of ``fn`` (its enqueue: Python wrapper and
    launch), on the host clock, with the device idle at the start."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def time_all(fn, plain=None, library=None, iters: int = 20,
             plain_iters: int = 5):
    """Every time the kernel table reports for one kernel: ``ms`` (events
    around back-to-back calls), ``device_ms`` (graph replay), ``host_us``,
    and the plain version's and the library call's times."""
    out = {"ms": time_ms(fn, iters)}
    out["device_ms"], out["device_method"] = device_ms(fn, iters)
    out["host_us"] = host_us(fn)
    out["plain_ms"] = (time_ms(plain, plain_iters) if plain is not None
                       else None)
    out["library_ms"] = out["library_device_ms"] = None
    if library is not None:
        out["library_ms"] = time_ms(library, iters)
        out["library_device_ms"], _ = device_ms(library, iters)
    return out


# --------------------------------------------------------------------------- #
# phase 0: card and build
# --------------------------------------------------------------------------- #
def phase0():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    emit({"phase": 0, "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "library": lib.name,
          "build_s": round(time.perf_counter() - t0, 3),
          "built_here": _build.build_seconds is not None})
    cuda_bin = Path(_build._nvcc()).parent
    sass = sass_counts(lib, cuda_bin)
    emit({"phase": 0, "sass": sass})
    log = _build.build_dir() / "build.log"
    ptxas = ptxas_report(log.read_text(), cuda_bin) if log.exists() else {}
    if ptxas:
        emit({"phase": 0, "ptxas": ptxas})
    decode = {name: {**sass[name], **ptxas.get(name, {})}
              for name in sass if name.startswith(DECODE_KERNELS)}
    emit({"phase": 0, "flash_decode_kernels": decode})
    mma = {n: c for n, c in decode.items()
           if n.startswith("decode_mma_kernel")}
    if not mma or not all(c["HMMA"] and c["LDGSTS"] for c in mma.values()):
        raise AssertionError(f"phase 0: a flash_decode tensor-core kernel "
                             f"has no HMMA (mma.sync) or LDGSTS: {mma}")
    spilled = {n: c.get("spill_bytes") for n, c in decode.items()
               if c.get("spill_bytes", 0) != 0}
    if log.exists() and spilled:
        raise AssertionError(f"phase 0: flash_decode kernels spill: "
                             f"{spilled}")
    flash = [c for name, c in sass.items()
             if name.startswith("flash_fwd_kernel_wgmma")]
    if not flash or not all(c["HGMMA"] and c["UTMALDG"] for c in flash):
        raise AssertionError(f"phase 0: the bf16 flash kernel has no "
                             f"HGMMA/UTMALDG instructions: {flash}")
    wide = {name: {op: c[op] for op in ("LDGSTS", "LDG.E.128")}
            for name, c in sass.items()
            if name.startswith(("paged_split_kernel", "page_gather_kernel",
                                "page_overlay_kernel", "decode_split_kernel",
                                "decode_mma_kernel"))}
    emit({"phase": 0, "wide_loads": wide})
    split = {name: c for name, c in wide.items()
             if name.startswith(("paged_split_kernel", "decode_split_kernel",
                                 "decode_mma_kernel"))}
    if not any(n.startswith("decode_split_kernel") for n in split) or \
            not all(c["LDGSTS"] for c in split.values()):
        raise AssertionError(f"phase 0: a paged or decode split kernel has "
                             f"no cp.async (LDGSTS) instructions: {wide}")
    overlay16 = {name: c["LDG.E.128"] for name, c in wide.items()
                 if name.startswith("page_overlay_kernel")
                 and canon_load_bytes(name) == 16}
    if not overlay16 or not all(overlay16.values()):
        raise AssertionError(f"phase 0: an overlay kernel whose canon load "
                             f"is 16 bytes has no LDG.E.128: {overlay16}")
    return smi


DECODE_KERNELS = ("decode_mma_kernel", "decode_split_kernel",
                  "decode_combine_kernel")


def canon_load_bytes(name: str) -> int:
    """Bytes of one canon load of ``page_overlay_kernel<Tp, Tc, VEC>``:
    VEC elements of Tc (``(int)8`` as cu++filt writes the width)."""
    _, tc, vec = name[name.index("<") + 1:-1].split(", ")
    return (2 if "bfloat16" in tc else 4) * int(vec.removeprefix("(int)"))


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "SYNCS", "LDGSTS", "LDG.E.128")


def sass_counts(lib: Path, cuda_bin: Path):
    """Instructions of each of SASS_OPS in each kernel of the library
    (``cuobjdump -sass``), by kernel name without its namespace and
    parameters (template arguments kept)."""
    text = subprocess.run([str(cuda_bin / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, mangled, fn = {}, [], None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            mangled.append(fn)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if op in line:
                    counts[fn][op] += 1
    return {name: counts[m]
            for m, name in zip(mangled, kernel_names(mangled, cuda_bin))}


def ptxas_report(log: str, cuda_bin: Path):
    """Per kernel of the build's ``-Xptxas=-v`` output: registers, spill
    bytes (stores), and whether ptxas serialized its wgmma instructions
    (C7512)."""
    out, fn, serialized = {}, None, set()
    for line in log.splitlines():
        if "C7512" in line:
            serialized.add(line.rsplit("'", 2)[-2])
        elif "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = {"registers": None, "spill_bytes": 0}
        elif fn and "spill stores" in line:
            out[fn]["spill_bytes"] = int(line.split("bytes spill stores")[0]
                                         .rsplit(",", 1)[-1])
        elif fn and "Used" in line and "registers" in line:
            out[fn]["registers"] = int(line.split("Used")[1].split()[0])
    for fn in out:
        out[fn]["wgmma_serialized"] = fn in serialized
    return {name: out[m] for m, name in zip(out, kernel_names(out, cuda_bin))}


def kernel_names(mangled, cuda_bin: Path):
    """Short names of mangled kernel symbols (``cu++filt``, where the
    toolkit has it): ``void ns::f<A, (int)8>(A*, int)`` -> ``f<A, (int)8>``,
    the name with its template arguments, without return type, namespace
    or parameters."""
    mangled = list(mangled)
    filt = cuda_bin / "cu++filt"
    if not filt.exists():
        return mangled
    names = subprocess.run([str(filt)], input="\n".join(mangled),
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    return [_short_name(n) for n in names]


def _short_name(demangled: str) -> str:
    name = demangled.removeprefix("void ")
    for anon in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(anon, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.split("<", 1)[0].split("::")[-1] + (
        "<" + name.split("<", 1)[1] if "<" in name else "")


# --------------------------------------------------------------------------- #
# phase 1: kernels against their plain versions, then timings
# --------------------------------------------------------------------------- #
def _rand(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _check(what, got, want, dtype, main):
    """Max abs error of ``got`` against ``want``; raises past the
    tolerance (see ATOL and BF16_* above)."""
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    size = want.float().abs()
    if main and dtype == "bfloat16":
        step = float((err / (BF16_FLOOR + BF16_STEP * size)).max())
        mean = float(err.mean() / size.mean())
        ok = step <= 1.0 and mean <= BF16_MEAN
        limit = f"{step} steps, mean {mean} (limits 1, {BF16_MEAN})"
    else:
        ok = float(err.max()) <= ATOL[dtype]
        limit = f"atol {ATOL[dtype]}"
    if not ok:
        raise AssertionError(f"{what}: max error {float(err.max())}, {limit}")
    return float(err.max())


def _flash_case(gen, dev, dtype, b, h, kv, sq, skv, d, window, q_offset,
                main=False, dv=None, causal=True, kv_len=None,
                seq_major=False):
    """flash against its plain version; at a main-path shape in bfloat16,
    against the yardstick (see FLASH_VS_SDPA; k and v repeated to the
    query heads for SDPA where ``kv < h``; non-causal, SDPA over the first
    ``kv_len`` keys with no mask). ``dv``: v's head dim where it differs
    from q's and k's ``d`` (MLA). ``seq_major``: q, k and v drawn as
    (b, seq, heads, d) and passed transposed, as the models pass their
    caches. Returns (max abs error, inputs, the yardstick's numbers or
    None)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dt = getattr(torch, dtype)
    dv = d if dv is None else dv

    def draw(heads, n, dim):
        if seq_major:
            return _rand(gen, (b, n, heads, dim), dt, dev).transpose(1, 2)
        return _rand(gen, (b, heads, n, dim), dt, dev)

    q, k, v = draw(h, sq, d), draw(kv, skv, d), draw(kv, skv, dv)
    what = (f"flash {dtype} {(b, h, kv, sq, skv, d, dv)} window={window} "
            f"q_offset={q_offset} causal={causal} kv_len={kv_len}")
    args = dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len)
    got = ops.flash_attention(q, k, v, **args)
    if not (main and dtype == "bfloat16"):
        want = ref.flash_attention_ref(q, k, v, **args)
        return _check(what, got, want, dtype, False), (q, k, v), None
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **args)
    k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
    if causal:
        lib = F.scaled_dot_product_attention(
            q, k_rep, v_rep,
            attn_mask=flash_mask(sq, skv, q_offset, window, dev))
    else:
        n = skv if kv_len is None else kv_len
        lib = F.scaled_dot_product_attention(q, k_rep[:, :, :n],
                                             v_rep[:, :, :n])
    yard = _yardstick(what, got, want, lib)
    return yard["max_abs_err"], (q, k, v), yard


def _yard_errors(got, want, lib):
    """The max and mean error of ``got`` and of the library call's output
    ``lib`` against the float32 plain version ``want``."""
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    lib_err = (lib.float() - want).abs()
    return {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "sdpa_max_abs_err": float(lib_err.max()),
            "sdpa_mean_abs_err": float(lib_err.mean())}


def _within_yard(yard) -> bool:
    return (yard["max_abs_err"] <= FLASH_VS_SDPA * yard["sdpa_max_abs_err"]
            and yard["mean_abs_err"]
            <= FLASH_VS_SDPA * yard["sdpa_mean_abs_err"])


def _yardstick(what, got, want, lib):
    """The bf16 flash kernel's max and mean error against the float32 plain
    version ``want``, each at most FLASH_VS_SDPA times those of the
    library call's output ``lib`` on the same bf16 inputs."""
    yard = _yard_errors(got, want, lib)
    if not _within_yard(yard):
        raise AssertionError(f"{what}: errors against the float32 plain "
                             f"version exceed {FLASH_VS_SDPA}x "
                             f"scaled_dot_product_attention's: {yard}")
    return yard


def flash_mask(sq, skv, q_offset, window, dev):
    """The causal (and window) mask of query rows at q_offset + i over
    keys 0..skv-1, True where a key is visible."""
    import torch
    qi = torch.arange(q_offset, q_offset + sq, device=dev)[:, None]
    kj = torch.arange(skv, device=dev)[None, :]
    ok = kj <= qi
    return ok & (qi - kj < window) if window > 0 else ok


def _paged_inputs(gen, dev, dtype, layout, b, h, kv, d, bs, lens,
                  width=None):
    """q, pools, a block table ``width`` pages wide (default: the longest
    sequence's pages) and seq_lens."""
    import torch
    from repro_torch.serving.paged_cache import KVPageSpec, pages_from_canonical
    dt = getattr(torch, dtype)
    pages = width or max(-(-int(n) // bs) for n in lens)
    n = b * pages + 1
    spec = KVPageSpec(bs, layout, dtype, kv, d)
    q = _rand(gen, (b, h, d), dt, dev)
    kp, vp = (pages_from_canonical(spec, _rand(gen, (n, bs, kv, d), dt, dev))
              .contiguous() for _ in range(2))
    perm = torch.randperm(n - 1, generator=gen, device=dev)[:b * pages] + 1
    table = perm.reshape(b, pages).to(torch.int32)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, table, seq_lens


def _paged_case(gen, dev, dtype, layout, b, h, kv, d, bs, lens, window,
                main=False, width=None):
    from repro_torch.kernels import ops, ref
    args = _paged_inputs(gen, dev, dtype, layout, b, h, kv, d, bs, lens,
                         width)
    got = ops.paged_attention(*args, layout=layout, window=window)
    want = ref.paged_attention_ref(*args, layout=layout, window=window)
    err = _check(f"paged {dtype} {layout} {(b, h, kv, d, bs)} "
                 f"window={window}", got, want, dtype, main)
    return err, args


def _overlay_case(gen, dev, layout, pool_dt, canon_dt, layers, bs, kv, hd,
                  front, seq_len, stream_rows, offset=0, n_blocks=None):
    """``stream_rows``: canon is the rows alone (the streamed re-page),
    else zero-padded whole pages (the monolithic one). ``offset``: canon
    starts that many elements into each row of a wider buffer.
    ``n_blocks``: the pool's blocks (default: twice the pages written,
    and 3)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    spec = KVPageSpec(bs, layout, pool_dt, kv, hd)
    nb = -(-(front + seq_len) // bs)
    n_blocks = n_blocks or 2 * nb + 3
    pool = _rand(gen, (layers,) + spec.pool_shape(n_blocks),
                 getattr(torch, pool_dt), dev)
    shape = (seq_len,) if stream_rows else (nb, bs)
    pad = 8 if offset else 0
    canon = _rand(gen, (layers,) + shape + (kv, hd + pad),
                  getattr(torch, canon_dt), dev)[..., offset:offset + hd]
    ids = (torch.randperm(n_blocks - 1, generator=gen, device=dev)[:nb]
           + 1).to(torch.int32)
    want = ref.scatter_pages_overlay_ref(spec, pool.clone(), ids, canon,
                                         front=front, seq_len=seq_len)
    got = ops.scatter_pages_overlay(spec, pool, ids, canon, front=front,
                                    seq_len=seq_len)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"overlay {layout} {pool_dt}<-{canon_dt} "
                             f"front={front} seq_len={seq_len} "
                             f"stream_rows={stream_rows}: pools differ")
    return 0.0, (spec, pool, ids, canon)


def overlay_vs_index_copy(gen, spec, pool, pids, canon, front, n):
    """The overlay of ``n`` streamed rows ``canon`` (layers, n, kv, hd)
    at ``front`` of the pages ``pids`` into a fresh random nbhd pool
    shaped as ``pool``, against ``index_copy_`` of the same rows into the
    same pool, bit for bit. Returns ``pool`` viewed (layers, rows, kv*hd),
    the row indices and the rows: the library call's arguments."""
    import torch
    from repro_torch.kernels import ops
    layers, bs = pool.shape[0], spec.block_size
    width = spec.kv_heads * spec.head_dim
    r = torch.arange(front, front + n, device=pool.device)
    rows = pids.long()[r // bs] * bs + r % bs
    src = canon.reshape(layers, n, width)
    fresh = _rand(gen, tuple(pool.shape), pool.dtype, pool.device)
    got = ops.scatter_pages_overlay(spec, fresh.clone(), pids, canon,
                                    front=front, seq_len=n)
    lib = fresh.view(layers, -1, width).index_copy_(1, rows, src)
    torch.cuda.synchronize()
    if not torch.equal(got.view(layers, -1, width), lib):
        raise AssertionError(f"overlay of {n} rows at front {front} into "
                             f"{layers} layers of {width} differs from "
                             "index_copy_")
    return pool.view(layers, -1, width), rows, src


def _pages_case(gen, dev, kind, layout, pool_dt, other_dt, layers, bs, kv,
                hd, n_blocks, ids):
    """gather_pages (``other_dt`` is the output dtype) or scatter_pages
    (``other_dt`` is the canonical input's) against its plain version,
    bit for bit. Returns the inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    spec = KVPageSpec(bs, layout, pool_dt, kv, hd)
    pool = _rand(gen, (layers,) + spec.pool_shape(n_blocks),
                 getattr(torch, pool_dt), dev)
    ids = torch.tensor(ids, dtype=torch.int32, device=dev)
    if kind == "gather":
        dt = getattr(torch, other_dt)
        got = ops.gather_pages(spec, pool, ids, out_dtype=dt)
        want = ref.gather_pages_ref(spec, pool, ids, out_dtype=dt)
        args = (spec, pool, ids, dt)
    else:
        canon = _rand(gen, (layers, len(ids), bs, kv, hd),
                      getattr(torch, other_dt), dev)
        want = ref.scatter_pages_ref(spec, pool.clone(), ids, canon)
        got = ops.scatter_pages(spec, pool, ids, canon)
        args = (spec, pool, ids, canon)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{kind}_pages {layout} pool {pool_dt} "
                             f"other {other_dt} {layers} layers bs {bs}: "
                             "differs from its plain version")
    return args


def _repack_case(gen, dev, src_layout, dst_layout, src_bs, dst_bs, src_dt,
                 dst_dt, layers, kv, hd, seq):
    """repack against its plain version, bit for bit, over unsorted pages
    of a dst pool that starts non-zero. Returns the inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    src = KVPageSpec(src_bs, src_layout, src_dt, kv, hd)
    dst = KVPageSpec(dst_bs, dst_layout, dst_dt, kv, hd)
    nb_s, nb_d = src.blocks_for(seq), dst.blocks_for(seq)
    src_pool = _rand(gen, (layers,) + src.pool_shape(nb_s + 2),
                     src.tdtype, dev)
    dst_pool = _rand(gen, (layers,) + dst.pool_shape(nb_d + 2),
                     dst.tdtype, dev)
    src_ids = (torch.randperm(nb_s + 1, generator=gen, device=dev)[:nb_s]
               + 1).to(torch.int32)
    dst_ids = (torch.randperm(nb_d + 1, generator=gen, device=dev)[:nb_d]
               + 1).to(torch.int32)
    want = ref.repack_ref(src, dst, src_pool, src_ids, dst_pool.clone(),
                          dst_ids, seq)
    got = ops.repack(src, dst, src_pool, src_ids, dst_pool, dst_ids, seq)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"repack {src_layout}/{src_bs}/{src_dt} -> "
                             f"{dst_layout}/{dst_bs}/{dst_dt} {layers} layers "
                             f"seq {seq}: differs from its plain version")
    return src, dst, src_pool, src_ids, dst_pool, dst_ids


DTYPE_PAIRS = (("float32", "float32"), ("bfloat16", "bfloat16"),
               ("bfloat16", "float32"), ("float32", "bfloat16"))
# overlay at hd 128, kv 8 (bs, front, seq_len): front 0; mid-page with a
# span ending mid-page; one row before a chunk edge (chunks of 8 tokens in
# bf16, 4 in f32, 32 in nhdb); bs 16 and 48, partial nhdb token tiles
OVERLAY_WIDE_CASES = ((16, 0, 40), (32, 13, 50), (32, 7, 100), (32, 3, 61),
                      (32, 31, 90), (16, 5, 60), (48, 31, 70))


def phase1_pages(gen, dev, cfg):
    """gather_pages, scatter_pages and repack against their plain
    versions (bit for bit): tests/test_kernels.py's sweep shapes with a
    layer axis and every dtype pair, the prefix cache's copy-on-write
    shape (one page of llama2-7b's pool, 32 layers, block 32, nbhd, bf16)
    and the full-width Fig. 3 shape (2048 tokens, 32 layers, nhbd block 16
    -> nbhd block 32, bf16). Then each kernel's timings at the COW shape
    (the main path's), and repack's at the Fig. 3 shape."""
    import torch
    from repro_torch.kernels import ops, ref
    counts = {"gather_pages": 0, "scatter_pages": 0, "repack": 0}
    for layout in ("nbhd", "nhbd", "nhdb"):
        for pool_dt, other_dt in DTYPE_PAIRS:
            for kind in ("gather", "scatter"):
                _pages_case(gen, dev, kind, layout, pool_dt, other_dt, 2, 8,
                            4, 16, 10, [3, 1, 7])
                counts[f"{kind}_pages"] += 1
    for src_l, dst_l, src_bs, dst_bs in (("nbhd", "nhbd", 8, 4),
                                         ("nhdb", "nbhd", 4, 16),
                                         ("nhbd", "nhdb", 16, 8)):
        for src_dt, dst_dt in DTYPE_PAIRS:
            _repack_case(gen, dev, src_l, dst_l, src_bs, dst_bs, src_dt,
                         dst_dt, 2, 2, 16, 27)
            counts["repack"] += 1
    layers, kv, hd, bs = cfg.num_layers, cfg.num_kv_heads, cfg.hd, 32
    cow = {}
    for kind in ("gather", "scatter"):
        cow[kind] = _pages_case(gen, dev, kind, "nbhd", "bfloat16",
                                "bfloat16", layers, bs, kv, hd, 9, [6])
        counts[f"{kind}_pages"] += 1
    spec, pool, _, _ = cow["scatter"]
    ids = torch.tensor([6, 2], dtype=torch.int32, device=dev)
    want = ref.repack_ref(spec, spec, pool, ids[:1], pool.clone(), ids[1:],
                          bs)
    ops.repack(spec, spec, pool, ids[:1], pool, ids[1:], bs)
    torch.cuda.synchronize()
    if not torch.equal(pool, want):
        raise AssertionError("repack at the COW shape differs from its "
                             "plain version")
    counts["repack"] += 1
    fig3 = _repack_case(gen, dev, "nhbd", "nbhd", 16, 32, "bfloat16",
                        "bfloat16", layers, kv, hd, 2048)
    counts["repack"] += 1

    # timings at the COW shape: one 32-row page of every layer
    page_bytes = 2.0 * layers * bs * kv * hd          # one pool page, bf16
    b_ms, b_by = bound(0.0, 2 * page_bytes, "bfloat16")
    timings = {}
    g_spec, g_pool, g_ids, g_dt = cow["gather"]
    timings["gather_pages"] = dict(
        shape=f"1 page of pool ({layers},9,{bs},{kv},{hd}) nbhd bf16 -> "
              f"canon ({layers},1,{bs},{kv},{hd})",
        max_abs_err=0.0,
        **time_all(lambda: ops.gather_pages(g_spec, g_pool, g_ids, g_dt),
                   plain=lambda: ref.gather_pages_ref(g_spec, g_pool, g_ids,
                                                      g_dt),
                   library=lambda: g_pool.index_select(1, g_ids.long())
                   .contiguous(), plain_iters=20),
        bound_ms=b_ms, bound_by=b_by)
    s_spec, s_pool, s_ids, s_canon = cow["scatter"]
    s_long = s_ids.long()
    timings["scatter_pages"] = dict(
        shape=f"canon ({layers},1,{bs},{kv},{hd}) -> 1 page of pool "
              f"({layers},9,{bs},{kv},{hd}) nbhd bf16",
        max_abs_err=0.0,
        **time_all(lambda: ops.scatter_pages(s_spec, s_pool, s_ids, s_canon),
                   plain=lambda: ref.scatter_pages_ref(s_spec, s_pool, s_ids,
                                                       s_canon),
                   library=lambda: s_pool.index_copy_(1, s_long, s_canon),
                   plain_iters=20),
        bound_ms=b_ms, bound_by=b_by)
    src_l, dst_l = ids[:1].long(), ids[1:].long()
    timings["repack"] = dict(
        shape=f"COW: page 6 -> page 2 of pool ({layers},9,{bs},{kv},{hd}) "
              "nbhd bf16, in place",
        max_abs_err=0.0,
        **time_all(lambda: ops.repack(spec, spec, pool, ids[:1], pool,
                                      ids[1:], bs),
                   plain=lambda: ref.repack_ref(spec, spec, pool, ids[:1],
                                                pool, ids[1:], bs),
                   library=lambda: pool.index_copy_(
                       1, dst_l, pool.index_select(1, src_l)),
                   plain_iters=20),
        bound_ms=b_ms, bound_by=b_by)
    # the paper's Fig. 3 at full width: 512 MiB in and out per pool
    src, dst, src_pool, src_ids, dst_pool, dst_ids = fig3
    nbytes = 2.0 * 2 * layers * 2048 * kv * hd
    f_ms, f_by = bound(0.0, nbytes, "bfloat16")
    perm = (0, 1, 3, 2, 4)          # nhbd page (kv, bs, hd) -> (bs, kv, hd)

    def fig3_library():
        canon = src_pool.index_select(1, src_ids.long()).permute(
            perm).contiguous().view(layers, -1, 32, kv, hd)
        dst_pool.index_copy_(1, dst_ids.long(), canon)

    emit({"phase": 1, "extra": "repack at the Fig. 3 shape",
          "shape": f"2048 tokens, {layers} layers, nhbd bs16 -> nbhd bs32, "
                   "bf16",
          **time_all(lambda: ops.repack(src, dst, src_pool, src_ids,
                                        dst_pool, dst_ids, 2048),
                     plain=lambda: ref.repack_ref(src, dst, src_pool, src_ids,
                                                  dst_pool, dst_ids, 2048),
                     library=fig3_library, iters=5),
          "bound_ms": f_ms, "bound_by": f_by})
    del fig3, src_pool, dst_pool
    # its scatter half: the canonical 2048 tokens into 64 unsorted dst pages
    n_pg = 2048 // bs
    order = torch.randperm(n_pg, generator=torch.Generator().manual_seed(SEED))
    f_spec, f_pool, f_ids, f_canon = _pages_case(
        gen, dev, "scatter", "nbhd", "bfloat16", "bfloat16", layers, bs, kv,
        hd, n_pg + 2, (order + 1).tolist())
    counts["scatter_pages"] += 1
    f_long = f_ids.long()
    emit({"phase": 1, "extra": "scatter_pages at the Fig. 3 shape",
          "shape": f"canon ({layers},{n_pg},{bs},{kv},{hd}) -> {n_pg} pages "
                   f"of pool ({layers},{n_pg + 2},{bs},{kv},{hd}) nbhd bf16",
          "bit_identical": True,
          **time_all(lambda: ops.scatter_pages(f_spec, f_pool, f_ids,
                                               f_canon),
                     plain=lambda: ref.scatter_pages_ref(f_spec, f_pool,
                                                         f_ids, f_canon),
                     library=lambda: f_pool.index_copy_(1, f_long, f_canon),
                     iters=10),
          "bound_ms": f_ms, "bound_by": f_by})
    del f_pool, f_canon
    # the gather half: 128 unsorted nhbd pages of block 16 -> canonical
    n_pg = 2048 // 16
    order = torch.randperm(n_pg,
                           generator=torch.Generator().manual_seed(SEED))
    g_spec, g_pool, g_ids, g_dt = _pages_case(
        gen, dev, "gather", "nhbd", "bfloat16", "bfloat16", layers, 16, kv,
        hd, n_pg + 2, (order + 1).tolist())
    counts["gather_pages"] += 1
    g_long = g_ids.long()
    emit({"phase": 1, "extra": "gather_pages at the Fig. 3 shape",
          "shape": f"{n_pg} pages of pool ({layers},{n_pg + 2},{kv},16,"
                   f"{hd}) nhbd bf16 -> canon ({layers},{n_pg},16,{kv},{hd})",
          "bit_identical": True,
          **time_all(lambda: ops.gather_pages(g_spec, g_pool, g_ids, g_dt),
                     plain=lambda: ref.gather_pages_ref(g_spec, g_pool,
                                                        g_ids, g_dt),
                     library=lambda: g_pool.index_select(1, g_long).permute(
                         perm).contiguous(),
                     iters=10),
          "bound_ms": f_ms, "bound_by": f_by})
    del g_pool
    emit({"phase": 1, "pages_checks": counts, "pages": "bit-identical"})
    return timings


def phase1_overlay(gen, dev):
    """The overlay's timings: one 500-token chunk's rows landing 20 rows
    into a page, 32 layers, as the streamed re-page hands them over (the
    main path's shape), beside ``index_copy_`` of the same rows, which must
    give the same bits; then, as extra lines, the same rows into nhbd and
    nhdb pools, the monolithic form (whole zero-padded pages, front 0) and
    float32 rows (an int8 wire decodes to float32) into the bf16 pool."""
    import torch
    from repro_torch.kernels import ops, ref
    layers, bs, kv, hd, front, s = 32, 32, 32, 128, 20, 500
    nb = -(-(front + s) // bs)

    def rows_bytes(canon_dt, n_rows):
        return ((torch.finfo(getattr(torch, canon_dt)).bits // 8 + 2)
                * layers * n_rows * kv * hd + 4 * nb)

    def library_rows(ids, n_rows, at):
        """index_copy_'s row index: flat row at+i of the block list."""
        r = torch.arange(at, at + n_rows, device=dev)
        return ids.long()[r // bs] * bs + r % bs

    err, (spec, pool, ids, canon) = _overlay_case(
        gen, dev, "nbhd", "bfloat16", "bfloat16", layers, bs, kv, hd, front, s,
        True)
    rows = library_rows(ids, s, front)
    flat = pool.view(layers, -1, kv * hd)
    src = canon.view(layers, s, kv * hd)
    fresh = _rand(gen, tuple(pool.shape), pool.dtype, dev)
    got = ops.scatter_pages_overlay(spec, fresh.clone(), ids, canon,
                                    front=front, seq_len=s)
    lib = fresh.view(layers, -1, kv * hd).index_copy_(1, rows, src)
    torch.cuda.synchronize()
    if not torch.equal(got.view(layers, -1, kv * hd), lib):
        raise AssertionError("overlay at the timing shape differs from "
                             "index_copy_ of the same rows")
    del fresh, got, lib
    b_ms, b_by = bound(0.0, rows_bytes("bfloat16", s), "bfloat16")
    timing = dict(
        shape=f"rows ({layers},{s},{kv},{hd}) into pool ({layers},N,{bs},"
              f"{kv},{hd}) nbhd bf16, {nb} pages, front {front}",
        max_abs_err=err, library_bit_identical=True,
        **time_all(lambda: ops.scatter_pages_overlay(
                       spec, pool, ids, canon, front=front, seq_len=s),
                   plain=lambda: ref.scatter_pages_overlay_ref(
                       spec, pool, ids, canon, front=front, seq_len=s),
                   library=lambda: flat.index_copy_(1, rows, src)),
        bound_ms=b_ms, bound_by=b_by)
    del pool, canon, flat, src
    # (what, layout, canon dtype, stream rows, front, rows covered)
    for what, layout, canon_dt, stream_rows, f0, n in (
            ("nhbd", "nhbd", "bfloat16", True, front, s),
            ("nhdb", "nhdb", "bfloat16", True, front, s),
            ("whole pages, front 0 (monolithic)", "nbhd", "bfloat16", False,
             0, nb * bs),
            ("float32 rows into the bf16 pool (int8 wire)", "nbhd",
             "float32", True, front, s)):
        _, (x_spec, x_pool, x_ids, x_canon) = _overlay_case(
            gen, dev, layout, "bfloat16", canon_dt, layers, bs, kv, hd, f0, n,
            stream_rows)
        library = None
        if layout == "nbhd" and canon_dt == "bfloat16":
            library = functools.partial(
                x_pool.view(layers, -1, kv * hd).index_copy_, 1,
                library_rows(x_ids, n, f0), x_canon.view(layers, n, kv * hd))
        x_ms, x_by = bound(0.0, rows_bytes(canon_dt, n), "bfloat16")
        emit({"phase": 1, "extra": f"scatter_pages_overlay, {what}",
              "shape": f"canon {tuple(x_canon.shape)} {canon_dt} into "
                       f"{layout} bf16 pool, {nb} pages, front {f0}, "
                       f"{n} rows",
              "bit_identical": True,
              **time_all(lambda: ops.scatter_pages_overlay(
                             x_spec, x_pool, x_ids, x_canon, front=f0,
                             seq_len=n),
                         plain=lambda: ref.scatter_pages_overlay_ref(
                             x_spec, x_pool, x_ids, x_canon, front=f0,
                             seq_len=n),
                         library=library),
              "bound_ms": x_ms, "bound_by": x_by})
    return timing


def phase1(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    counts = {"flash": 0, "paged": 0, "overlay": 0}
    main_err = {"paged": 0.0}                   # main-path shapes, bfloat16
    yardstick = []                              # flash at main-path shapes

    # flash: the JAX sweep shapes, a chunk at an offset, llama2-7b prefill
    for dtype in ("float32", "bfloat16"):
        for b, h, kv, sq, skv, d, q_off in [(1, 4, 4, 16, 16, 32, 0),
                                            (2, 8, 2, 24, 48, 64, 0),
                                            (1, 4, 1, 7, 133, 32, 0),
                                            (1, 8, 8, 100, 300, 128, 200),
                                            (1, 32, 32, 2048, 2048, 128, 0)]:
            main = sq == 2048
            for window in (0, 9):
                _, _, yard = _flash_case(gen, dev, dtype, b, h, kv, sq, skv,
                                         d, window, q_off, main)
                counts["flash"] += 1
                if yard is not None:
                    yardstick.append({"shape": (b, h, kv, sq, skv, d),
                                      "window": window, **yard})
    # paged: the JAX sweep shapes in every layout, llama2-7b decode
    decode_lens = [int(x) for x in torch.randint(
        1800, 2081, (8,), generator=torch.Generator().manual_seed(SEED))]
    for dtype in ("float32", "bfloat16"):
        for layout in ("nbhd", "nhbd", "nhdb"):
            for b, h, kv, d, bs, pages in [(2, 4, 4, 32, 8, 4),
                                           (3, 8, 2, 64, 16, 3),
                                           (1, 4, 1, 32, 4, 7)]:
                lens = [int(x) for x in torch.randint(
                    1, bs * pages + 1, (b,),
                    generator=torch.Generator().manual_seed(b))]
                for window in (0, 11):
                    _paged_case(gen, dev, dtype, layout, b, h, kv, d, bs,
                                lens, window)
                    counts["paged"] += 1
            err, _ = _paged_case(gen, dev, dtype, layout, 8, 32, 32, 128, 32,
                                 decode_lens, 0, main=True)
            counts["paged"] += 1
            if dtype == "bfloat16":
                main_err["paged"] = max(main_err["paged"], err)
    # overlay: every layout and dtype pair, the rows alone and whole pages,
    # front at 0 and inside a page, a partial tail, and the main path's
    # 500-token chunk over 32 layers
    for layout in ("nbhd", "nhbd", "nhdb"):
        for pool_dt, canon_dt in (("float32", "float32"),
                                  ("bfloat16", "bfloat16"),
                                  ("bfloat16", "float32"),
                                  ("float32", "bfloat16")):
            for front, seq_len in ((0, 24), (3, 17), (0, 5), (5, 3)):
                for stream_rows in (True, False):
                    _overlay_case(gen, dev, layout, pool_dt, canon_dt, 2, 8,
                                  2, 16, front, seq_len, stream_rows)
                    counts["overlay"] += 1
        _overlay_case(gen, dev, layout, "bfloat16", "bfloat16", 32, 32, 32,
                      128, 20, 500, True)
        counts["overlay"] += 1
        # the 16-byte and tile paths: hd 128, kv 8, chunk edges, partial
        # token tiles, a canon 2 elements off 16 bytes
        for pool_dt, canon_dt in DTYPE_PAIRS:
            for bs, front, seq_len in OVERLAY_WIDE_CASES:
                for stream_rows in (True, False):
                    for offset in (0, 2):
                        _overlay_case(gen, dev, layout, pool_dt, canon_dt, 2,
                                      bs, 8, 128, front, seq_len, stream_rows,
                                      offset)
                        counts["overlay"] += 1
    emit({"phase": 1, "checks": counts, "atol": ATOL,
          "main_bf16": {"floor": BF16_FLOOR, "step": BF16_STEP,
                        "mean": BF16_MEAN, "max_abs_err": main_err},
          "flash_vs_sdpa": {"limit": FLASH_VS_SDPA, "cases": yardstick},
          "overlay": "bit-identical"})

    # timings at the main path's shapes (bfloat16)
    timings = {}
    # flash: a 500-token prefill chunk at offset 1500 against a 2000-slot
    # full-capacity cache (kv_len = capacity, as attention_decode calls it)
    c0, sq, cap, h, d = 1500, 500, 2000, 32, 128
    err, (q, k, v), yard = _flash_case(gen, dev, "bfloat16", 1, h, h, sq,
                                       cap, d, 0, c0, main=True)
    mask = flash_mask(sq, cap, c0, 0, dev)
    pairs = sq * c0 + sq * (sq + 1) // 2
    flops = 4.0 * d * pairs * h
    nbytes = 2.0 * (2 * sq * h * d + 2 * (c0 + sq) * h * d)
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    timings["flash_attention"] = dict(
        shape=f"q(1,{h},{sq},{d}) q_offset={c0} kv(1,{h},{cap},{d}) bf16",
        max_abs_err=err, yardstick=yard,
        **time_all(lambda: ops.flash_attention(q, k, v, q_offset=c0),
                   plain=lambda: ref.flash_attention_ref(q, k, v,
                                                         q_offset=c0),
                   library=lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by)
    # the monolithic 2048-token prefill, for reference
    _, (q2, k2, v2), yard2 = _flash_case(gen, dev, "bfloat16", 1, 32, 32,
                                         2048, 2048, 128, 0, 0, main=True)
    f2 = 4.0 * 128 * 32 * (2048 * 2049 // 2)
    b2, by2 = bound(f2, 2.0 * 4 * 2048 * 32 * 128, "bfloat16")
    emit({"phase": 1, "extra": "flash_attention monolithic prefill",
          "shape": "q,k,v (1,32,2048,128) causal bf16", "yardstick": yard2,
          **time_all(lambda: ops.flash_attention(q2, k2, v2),
                     library=lambda: F.scaled_dot_product_attention(
                         q2, k2, v2, is_causal=True)),
          "bound_ms": b2, "bound_by": by2})
    del q2, k2, v2
    # paged: 8 sequences of ~2k tokens, block 32, nbhd (the D vendor)
    err, args = _paged_case(gen, dev, "bfloat16", "nbhd", 8, 32, 32, 128, 32,
                            decode_lens, 0, main=True)
    tokens = sum(decode_lens)
    flops = 4.0 * 128 * 32 * tokens
    nbytes = 2.0 * 2 * tokens * 32 * 128 + 2.0 * 2 * 8 * 32 * 128
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    timings["paged_attention"] = dict(
        shape=f"q(8,32,128) pools nbhd bs32 bf16, seq_lens {decode_lens}",
        max_abs_err=err,
        **time_all(lambda: ops.paged_attention(*args, layout="nbhd"),
                   plain=lambda: ref.paged_attention_ref(*args,
                                                         layout="nbhd")),
        bound_ms=b_ms, bound_by=b_by)
    # paged beyond the timing shape: one 2048-token sequence (the grid of
    # one sequence), phase 3's mixed lengths at its last decode step in its
    # 65-page table, and the main shape in the two other layouts
    prompts = np.random.default_rng(SEED).integers(
        PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    width = -(-(PROMPT_RANGE[1] + MAX_NEW) // 32)
    for what, lay, lens, wd in (
            ("one sequence", "nbhd", [2048], None),
            ("phase 3's lengths", "nbhd",
             [int(n) + MAX_NEW for n in prompts], width),
            ("timing shape", "nhbd", decode_lens, None),
            ("timing shape", "nhdb", decode_lens, None)):
        err, a = _paged_case(gen, dev, "bfloat16", lay, len(lens), 32, 32,
                             128, 32, lens, 0, main=True, width=wd)
        tok = sum(lens)
        p_ms, p_by = bound(4.0 * 128 * 32 * tok, 2.0 * 2 * tok * 32 * 128
                           + 2.0 * 2 * len(lens) * 32 * 128, "bfloat16")
        emit({"phase": 1, "extra": f"paged_attention, {what}, {lay}",
              "shape": f"q({len(lens)},32,128) pools {lay} bs32 bf16, "
                       f"table {a[3].shape[1]} pages, seq_lens {lens}",
              "max_abs_err": err,
              **time_all(lambda: ops.paged_attention(*a, layout=lay),
                         plain=lambda: ref.paged_attention_ref(*a,
                                                               layout=lay)),
              "bound_ms": p_ms, "bound_by": p_by})
        del a
    phase1_windowed(gen, dev)
    mla = phase1_mla(gen, dev)
    rg = phase1_rg(gen, dev)
    vlm = phase1_vlm(gen, dev)
    encdec = phase1_encdec(gen, dev)
    load = phase1_load(gen, dev)
    demo = phase1_demo(gen, dev)
    timings["flash_decode"] = phase1_decode(gen, dev)
    timings.update(phase1_decode_halves(gen, dev))
    timings["flash_decode_partial"].update(phase1_mesh_halves(gen, dev))
    timings["scatter_pages_overlay"] = phase1_overlay(gen, dev)
    from repro_torch.configs import get_config
    timings.update(phase1_pages(gen, dev, get_config(MODEL)))
    for name, t in timings.items():
        emit({"phase": 1, "timing": name, **t})
    for name, t in mla.items():
        timings[name]["mla"] = t
    for name, t in rg.items():
        timings[name]["rg"] = t
    for name, t in vlm.items():
        timings[name]["vlm"] = t
    for name, t in encdec.items():
        timings[name]["encdec"] = t
    for name, t in load.items():
        timings[name]["load"] = t
    for name, rows in demo.items():
        timings[name].update(rows)
    return timings


def phase1_mla(gen, dev):
    """The kernels at phase 7's MLA shapes (DeepSeek-V2-Lite: 16 heads, q
    and k 192 wide = 128 nope + 64 rope, v 128; latent pools of one KV
    "head" of 512 and of 64; 27 layers), in bf16. flash: the JAX sweep's
    small shapes with dv < dk against the plain version, then the last
    500-token chunk of the 8192-token prompt (q_offset 7692) in bf16,
    against the yardstick, and in float32 within 2e-5; gather: phase 7's
    last decode table (8 sequences, 257 columns) from both pools; overlay:
    a 500-row chunk of 27 layers landing at row 20 of a page, into both
    pools, bit-identical to the plain version and to ``index_copy_``;
    repack: the prefix cache's copy of one page of 27 layers, in place.
    Returns each kernel's timing at these shapes, keyed by kernel name."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    h, dk, dv, layers, bs = 16, 192, 128, 27, 32
    n_small = 0
    for dtype in ("float32", "bfloat16"):
        for b, hh, kv, sq, skv, d, dvv, q_off in [
                (1, 4, 4, 16, 16, 32, 16, 0), (2, 8, 2, 24, 48, 64, 32, 0),
                (1, 4, 1, 7, 133, 192, 128, 0),
                (1, 8, 8, 100, 300, 192, 128, 200)]:
            for window in (0, 9):
                _flash_case(gen, dev, dtype, b, hh, kv, sq, skv, d, window,
                            q_off, dv=dvv)
                n_small += 1
    out = {}
    c0, sq, skv = 7692, 500, 8192
    pairs = sq * c0 + sq * (sq + 1) // 2
    flops = 2.0 * pairs * (dk + dv) * h
    for dtype in ("bfloat16", "float32"):
        err, (q, k, v), yard = _flash_case(gen, dev, dtype, 1, h, h, sq, skv,
                                           dk, 0, c0, main=True, dv=dv)
        size = 2 if dtype == "bfloat16" else 4
        nbytes = size * (sq * h * dk + skv * h * (dk + dv) + sq * h * dv)
        b_ms, b_by = bound(flops, nbytes, dtype)
        mask = flash_mask(sq, skv, c0, 0, dev)
        row = dict(shape=f"q(1,{h},{sq},{dk}) k(1,{h},{skv},{dk}) "
                         f"v(1,{h},{skv},{dv}) q_offset={c0} kv_len={skv} "
                         f"{dtype}",
                   max_abs_err=err, yardstick=yard,
                   **time_all(lambda: ops.flash_attention(q, k, v,
                                                          q_offset=c0),
                              plain=lambda: ref.flash_attention_ref(
                                  q, k, v, q_offset=c0),
                              library=lambda: F.scaled_dot_product_attention(
                                  q, k, v, attn_mask=mask)),
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": 1, "extra": f"flash_attention, MLA chunk, {dtype}",
              **row})
        out.setdefault("flash_attention", row)
        del q, k, v, mask
    # the decode table of phase 7's last step: each sequence's pages, the
    # scratch page past them, 257 columns gathered
    lens = [n + MAX_NEW for n in PHASE6_PROMPTS]
    width = -(-max(lens) // bs)
    n_blocks = sum(-(-n // bs) for n in lens) + 1
    order = torch.randperm(n_blocks - 1, generator=gen,
                           device=dev).to(torch.int32) + 1
    table = torch.zeros((len(lens), width), dtype=torch.int32, device=dev)
    at = 0
    for i, n in enumerate(lens):
        nb = -(-n // bs)
        table[i, :nb] = order[at:at + nb]
        at += nb
    ids = table.reshape(-1).contiguous()
    ids_long = ids.long()
    for hd in (512, 64):
        spec = KVPageSpec(bs, "nbhd", "bfloat16", 1, hd)
        pool = _rand(gen, (1,) + spec.pool_shape(n_blocks), torch.bfloat16,
                     dev)
        got = ops.gather_pages(spec, pool, ids)
        want = ref.gather_pages_ref(spec, pool, ids)
        lib = pool.index_select(1, ids_long)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, lib)):
            raise AssertionError(f"gather of the MLA decode table, hd {hd}: "
                                 "differs from its plain version or "
                                 "index_select")
        b_ms, b_by = bound(0.0, 2.0 * 2 * ids.numel() * bs * hd, "bfloat16")
        row = dict(shape=f"{ids.numel()} pages ({len(lens)} seqs x {width} "
                         f"columns) of pool (1,{n_blocks},{bs},1,{hd}) nbhd "
                         "bf16", max_abs_err=0.0, bit_identical=True,
                   **time_all(lambda: ops.gather_pages(spec, pool, ids),
                              plain=lambda: ref.gather_pages_ref(spec, pool,
                                                                 ids),
                              library=lambda: pool.index_select(1, ids_long)),
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": 1, "extra": f"gather_pages, MLA decode table, hd {hd}",
              **row})
        out.setdefault("gather_pages", row)
        del pool, got, want, lib
    # a 500-row chunk of 27 layers at row 20 of a page, both latent pools
    front, s_rows = 20, 500
    for hd in (512, 64):
        _, (spec, pool, pids, canon) = _overlay_case(
            gen, dev, "nbhd", "bfloat16", "bfloat16", layers, bs, 1, hd,
            front, s_rows, True)
        r = torch.arange(front, front + s_rows, device=dev)
        rows = pids.long()[r // bs] * bs + r % bs
        flat = pool.view(layers, -1, hd)
        src = canon.view(layers, s_rows, hd)
        fresh = _rand(gen, tuple(pool.shape), pool.dtype, dev)
        got = ops.scatter_pages_overlay(spec, fresh.clone(), pids, canon,
                                        front=front, seq_len=s_rows)
        lib = fresh.view(layers, -1, hd).index_copy_(1, rows, src)
        torch.cuda.synchronize()
        if not torch.equal(got.view(layers, -1, hd), lib):
            raise AssertionError(f"overlay into the latent pool hd {hd} "
                                 "differs from index_copy_")
        del fresh, got, lib
        b_ms, b_by = bound(0.0, 2.0 * 2 * layers * s_rows * hd, "bfloat16")
        row = dict(shape=f"rows ({layers},{s_rows},1,{hd}) into pool "
                         f"({layers},N,{bs},1,{hd}) nbhd bf16, front {front}",
                   max_abs_err=0.0, library_bit_identical=True,
                   **time_all(lambda: ops.scatter_pages_overlay(
                                  spec, pool, pids, canon, front=front,
                                  seq_len=s_rows),
                              plain=lambda: ref.scatter_pages_overlay_ref(
                                  spec, pool, pids, canon, front=front,
                                  seq_len=s_rows),
                              library=lambda: flat.index_copy_(1, rows, src)),
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": 1, "extra": f"scatter_pages_overlay, MLA chunk, "
                                   f"hd {hd}", **row})
        out.setdefault("scatter_pages_overlay", row)
        del pool, canon, flat, src
    # the prefix cache's copy-on-write of one page of 27 layers, in place
    for hd in (512, 64):
        spec = KVPageSpec(bs, "nbhd", "bfloat16", 1, hd)
        pool = _rand(gen, (layers,) + spec.pool_shape(9), torch.bfloat16, dev)
        pair = torch.tensor([6, 2], dtype=torch.int32, device=dev)
        want = ref.repack_ref(spec, spec, pool, pair[:1], pool.clone(),
                              pair[1:], bs)
        ops.repack(spec, spec, pool, pair[:1], pool, pair[1:], bs)
        torch.cuda.synchronize()
        if not torch.equal(pool, want):
            raise AssertionError(f"repack of a latent page, hd {hd}: differs "
                                 "from its plain version")
        src_l, dst_l = pair[:1].long(), pair[1:].long()
        b_ms, b_by = bound(0.0, 2.0 * 2 * layers * bs * hd, "bfloat16")
        row = dict(shape=f"COW: page 6 -> page 2 of pool ({layers},9,{bs},1,"
                         f"{hd}) nbhd bf16, in place", max_abs_err=0.0,
                   **time_all(lambda: ops.repack(spec, spec, pool, pair[:1],
                                                 pool, pair[1:], bs),
                              plain=lambda: ref.repack_ref(
                                  spec, spec, pool, pair[:1], pool, pair[1:],
                                  bs),
                              library=lambda: pool.index_copy_(
                                  1, dst_l, pool.index_select(1, src_l)),
                              plain_iters=20),
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": 1, "extra": f"repack, MLA latent page, hd {hd}",
              **row})
        out.setdefault("repack", row)
        del pool
    emit({"phase": 1, "mla_checks": {"flash_small_dv": n_small,
                                     "flash_chunk": 2, "gather": 2,
                                     "overlay": 2, "repack": 2}})
    return out


def stale_nan(args, bs, window, layout="nbhd"):
    """Copies of the pools with NaN in every row of each sequence below
    its window floor (``len - window``): the rows a D allocates but never
    writes, which hold whatever earlier sequences left there."""
    import torch
    q, k, v, table, lens = args
    blks, rows = [], []
    for b, n in enumerate(lens.tolist()):
        t = torch.arange(max(0, n - window), device=k.device)
        blks.append(table[b, t // bs].long())
        rows.append(t % bs)
    blks, rows = torch.cat(blks), torch.cat(rows)
    kn, vn = k.clone(), v.clone()
    for pool in (kn, vn):
        if layout == "nbhd":
            pool[blks, rows] = float("nan")
        elif layout == "nhbd":
            pool[blks, :, rows] = float("nan")
        else:                                       # nhdb
            pool[blks, :, :, rows] = float("nan")
    return q, kn, vn, table, lens


def phase1_rg(gen, dev):
    """The attention kernels at phase 8's shapes (RecurrentGemma-9B: 16
    query heads on one KV head, head dim 256, window 2048). flash: small
    shapes at head dims 256 / 256 and 208 / 160 in both dtypes against
    the plain version; then the last 500-token chunk of the 8192-token
    prompt (q_offset 7692, kv_len 8192) in bf16 against the yardstick
    (SDPA with k/v repeated to 16 heads) and in float32 within 2e-5.
    paged: phase 8's eight sequences at their last decode step in nbhd
    (D's layout), nhbd and nhdb, with NaN in every stale row below each
    floor — finite, bit-identical to the kernel on finite pools, within
    the main-path bf16 limits of the plain version, and moved by the
    window at least 10 times the kernel's error. Bounds count only keys
    inside the window. overlay: every (front, rows) of phase 8's streamed
    chunks into D's pools (12 layers, one KV head of 256), bit-identical
    to the plain version, whole pages and the other layouts at fronts 24
    and 0, and a 500-row chunk at front 24 also to ``index_copy_``.
    Returns flash's, paged's and the overlay's timings at these shapes
    (bf16, nbhd), keyed by kernel name."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RECURRENT
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    cfg = get_config(MODEL8)
    h, kv, d, win = cfg.num_heads, cfg.num_kv_heads, cfg.hd, \
        cfg.sliding_window
    n_small = 0
    for dtype in ("float32", "bfloat16"):
        for b, hh, kvh, sq, skv, dk, dv, q_off in [
                (1, 16, 1, 70, 70, 256, 256, 0),
                (2, 4, 2, 130, 300, 256, 256, 100),
                (1, 4, 4, 65, 200, 208, 160, 0)]:
            for window in (0, 50):
                _flash_case(gen, dev, dtype, b, hh, kvh, sq, skv, dk, window,
                            q_off, dv=dv)
                n_small += 1
    out = {}
    c0, sq, skv = 7692, 500, 8192
    args = dict(window=win, q_offset=c0, kv_len=skv)
    keys = sq + win - 1                          # keys some row sees
    flops = 4.0 * d * h * sq * win               # every row sees 2048 keys
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = _rand(gen, (1, h, sq, d), dt, dev)
        k = _rand(gen, (1, kv, skv, d), dt, dev)
        v = _rand(gen, (1, kv, skv, d), dt, dev)
        got = ops.flash_attention(q, k, v, **args)
        k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
        mask = flash_mask(sq, skv, c0, win, dev)
        size = 2 if dtype == "bfloat16" else 4
        b_ms, b_by = bound(flops, size * (2 * sq * h * d + 2 * keys * kv * d),
                           dtype)
        what = f"flash {dtype} RecurrentGemma chunk"
        yard = None
        if dtype == "float32":
            err = _check(what, got, ref.flash_attention_ref(q, k, v, **args),
                         dtype, False)
        else:
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **args)
            lib = F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                 attn_mask=mask)
            torch.cuda.synchronize()
            e, le = (got.float() - want).abs(), (lib.float() - want).abs()
            yard = {"max_abs_err": float(e.max()),
                    "mean_abs_err": float(e.mean()),
                    "sdpa_max_abs_err": float(le.max()),
                    "sdpa_mean_abs_err": float(le.mean())}
            if not (yard["max_abs_err"]
                    <= FLASH_VS_SDPA * yard["sdpa_max_abs_err"]
                    and yard["mean_abs_err"]
                    <= FLASH_VS_SDPA * yard["sdpa_mean_abs_err"]):
                raise AssertionError(f"{what}: errors exceed {FLASH_VS_SDPA}"
                                     f"x scaled_dot_product_attention's: "
                                     f"{yard}")
            err = yard["max_abs_err"]
            del want, lib
        row = dict(shape=f"q(1,{h},{sq},{d}) kv(1,{kv},{skv},{d}) "
                         f"q_offset={c0} window={win} {dtype}",
                   max_abs_err=err, yardstick=yard,
                   **time_all(lambda: ops.flash_attention(q, k, v, **args),
                              plain=lambda: ref.flash_attention_ref(
                                  q, k, v, **args),
                              library=lambda: F.scaled_dot_product_attention(
                                  q, k_rep, v_rep, attn_mask=mask)),
                   library="scaled_dot_product_attention, k/v repeated to "
                           f"{h} heads, boolean mask",
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": 1, "extra": f"flash_attention, RecurrentGemma chunk, "
                                   f"{dtype}", **row})
        out.setdefault("flash_attention", row)
        del q, k, v, k_rep, v_rep, mask, got
    bs = D_VENDOR["block_size"]
    lens = [n + MAX_NEW for n in PHASE6_PROMPTS]
    tokens = sum(min(n, win) for n in lens)
    p_ms, p_by = bound(4.0 * d * h * tokens, 2.0 * 2 * tokens * kv * d
                       + 2.0 * 2 * len(lens) * h * d, "bfloat16")
    for layout in ("nbhd", "nhbd", "nhdb"):
        pargs = _paged_inputs(gen, dev, "bfloat16", layout, len(lens), h, kv,
                              d, bs, lens)
        stale = stale_nan(pargs, bs, win, layout)
        got = ops.paged_attention(*stale, layout=layout, window=win)
        fin = ops.paged_attention(*pargs, layout=layout, window=win)
        want = ref.paged_attention_ref(*pargs, layout=layout, window=win)
        full = ref.paged_attention_ref(*pargs, layout=layout)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"paged {layout} at 16 x 256: non-finite "
                                 "output with NaN below the floors")
        if not torch.equal(got, fin):
            raise AssertionError(f"paged {layout} at 16 x 256: NaN below the "
                                 "floors changed the output")
        err = _check(f"paged bf16 {layout} {(len(lens), h, kv, d, bs)} "
                     f"window={win}", fin, want, "bfloat16", True)
        effect = float((want.float() - full.float()).abs().max())
        if not effect >= 10 * err:
            raise AssertionError(f"paged {layout} at 16 x 256: window effect "
                                 f"{effect} < 10x the kernel's error {err}")
        row = dict(shape=f"q({len(lens)},{h},{d}) pools {layout} bs{bs} bf16,"
                         f" {kv} KV head, seq_lens {lens}, window={win}",
                   max_abs_err=err, window_effect=effect,
                   finite_with_nan=True, equal_to_finite_pools=True,
                   **time_all(lambda: ops.paged_attention(
                                  *stale, layout=layout, window=win),
                              plain=lambda: ref.paged_attention_ref(
                                  *pargs, layout=layout, window=win)),
                   bound_ms=p_ms, bound_by=p_by)
        emit({"phase": 1, "extra": f"paged_attention, RecurrentGemma decode, "
                                   f"{layout}", **row})
        out.setdefault("paged_attention", row)
        del pargs, stale, got, fin, want, full
    # the overlay: every (front, rows) a streamed chunk of phase 8 has in
    # D's pools (12 attention layers, one KV head of 256, block 32; the
    # 7000-token prompt's floor 4952 lies 24 rows into a page), bit for
    # bit; front 24 and 0 as whole pages and in the two other layouts
    n_attn = sum(g.count * sum(k != RECURRENT for k in g.kinds)
                 for g in M.block_groups(cfg))
    starts = sorted({(c0 % bs, n) for pl in wire_plan(
        PHASE6_PROMPTS, win, PREFILL_CHUNK) for c0, n in pl["chunks"]})
    cases = [("nbhd", f, n, True) for f, n in starts] + [
        (lay, f, PREFILL_CHUNK, rows) for lay in ("nbhd", "nhbd", "nhdb")
        for f in (24, 0) for rows in (True, False)
        if (lay, rows) != ("nbhd", True)]
    for lay, f, n, rows in cases:
        _overlay_case(gen, dev, lay, "bfloat16", "bfloat16", n_attn, bs, kv,
                      d, f, n, rows)
    front, s_rows = 24, PREFILL_CHUNK
    _, (spec, pool, pids, canon) = _overlay_case(
        gen, dev, "nbhd", "bfloat16", "bfloat16", n_attn, bs, kv, d, front,
        s_rows, True)
    flat, rows, src = overlay_vs_index_copy(gen, spec, pool, pids, canon,
                                            front, s_rows)
    b_ms, b_by = bound(0.0, 2.0 * 2 * n_attn * s_rows * kv * d, "bfloat16")
    row = dict(shape=f"rows ({n_attn},{s_rows},{kv},{d}) into pool "
                     f"({n_attn},N,{bs},{kv},{d}) nbhd bf16, front {front}",
               max_abs_err=0.0, library_bit_identical=True,
               **time_all(lambda: ops.scatter_pages_overlay(
                              spec, pool, pids, canon, front=front,
                              seq_len=s_rows),
                          plain=lambda: ref.scatter_pages_overlay_ref(
                              spec, pool, pids, canon, front=front,
                              seq_len=s_rows),
                          library=lambda: flat.index_copy_(1, rows, src)),
               bound_ms=b_ms, bound_by=b_by)
    emit({"phase": 1, "extra": "scatter_pages_overlay, RecurrentGemma chunk",
          **row})
    out["scatter_pages_overlay"] = row
    del pool, canon, flat, src
    emit({"phase": 1, "rg_checks": {"flash_small": n_small, "flash_chunk": 2,
                                    "paged_layouts": 3,
                                    "overlay": len(cases) + 1}})
    return out


def decode_rows(gen, dev, model, seqs, h, kv, d):
    """Paged attention over sequences ``seqs`` at their last decode step
    (each + MAX_NEW) in a table as wide as D's (block 32): float32 nbhd
    within 2e-5, and bf16 in nbhd (D's layout), nhbd and nhdb within the
    main-path limits, each timed. Returns the bf16 nbhd row."""
    from repro_torch.kernels import ops, ref
    bs = D_VENDOR["block_size"]
    lens = [n + MAX_NEW for n in seqs]
    width = -(-(max(seqs) + MAX_NEW) // bs)
    tokens = sum(lens)
    p_ms, p_by = bound(4.0 * d * h * tokens, 2.0 * 2 * tokens * kv * d
                       + 2.0 * 2 * len(lens) * h * d, "bfloat16")
    _paged_case(gen, dev, "float32", "nbhd", len(lens), h, kv, d, bs, lens,
                0, main=True, width=width)
    rows = {}
    for layout in ("nbhd", "nhbd", "nhdb"):
        err, a = _paged_case(gen, dev, "bfloat16", layout, len(lens), h, kv,
                             d, bs, lens, 0, main=True, width=width)
        rows[layout] = dict(
            shape=f"q({len(lens)},{h},{d}) pools {layout} bs{bs} bf16, {kv} "
                  f"KV heads, table {width} pages, seq_lens {lens}",
            max_abs_err=err,
            **time_all(lambda: ops.paged_attention(*a, layout=layout),
                       plain=lambda: ref.paged_attention_ref(
                           *a, layout=layout)),
            bound_ms=p_ms, bound_by=p_by)
        emit({"phase": 1, "extra": f"paged_attention, {model} decode, "
                                   f"{layout}", **rows[layout]})
        del a
    return rows["nbhd"]


def repage_rows(gen, dev, model, seqs, chunk, layers, kv, d, n_blocks=None,
                timed=None):
    """The overlay at every (front, rows) that the streamed ``chunk``-token
    chunks of sequences ``seqs`` have in D's nbhd pools (``layers``
    layers, block 32, bf16; ``n_blocks`` blocks, default a few more than
    the pages written), bit for bit against the plain version and
    ``index_copy_``; the (front, rows) case ``timed`` (default: the full
    chunk at front ``chunk % 32``) timed. Returns (its row, the cases)."""
    from repro_torch.kernels import ops, ref
    bs = D_VENDOR["block_size"]
    timed = timed or (chunk % bs, chunk)
    cases = sorted({(c0 % bs, min(chunk, n - c0)) for n in seqs
                    for c0 in range(0, n, chunk)})
    row = None
    for front, rows_n in cases:
        _, (spec, pool, pids, canon) = _overlay_case(
            gen, dev, "nbhd", "bfloat16", "bfloat16", layers, bs, kv, d,
            front, rows_n, True, n_blocks=n_blocks)
        flat, rows, src = overlay_vs_index_copy(gen, spec, pool, pids, canon,
                                                front, rows_n)
        if (front, rows_n) == timed:
            b_ms, b_by = bound(0.0, 2.0 * 2 * layers * rows_n * kv * d,
                               "bfloat16")
            row = dict(
                shape=f"rows ({layers},{rows_n},{kv},{d}) into pool "
                      f"({layers},{pool.shape[1]},{bs},{kv},{d}) nbhd bf16, "
                      f"front {front}",
                max_abs_err=0.0, library_bit_identical=True,
                **time_all(lambda: ops.scatter_pages_overlay(
                               spec, pool, pids, canon, front=front,
                               seq_len=rows_n),
                           plain=lambda: ref.scatter_pages_overlay_ref(
                               spec, pool, pids, canon, front=front,
                               seq_len=rows_n),
                           library=lambda: flat.index_copy_(1, rows, src)),
                bound_ms=b_ms, bound_by=b_by)
            emit({"phase": 1, "extra": f"scatter_pages_overlay, {model} "
                                       "chunk", **row})
        del pool, canon, flat, src
    if row is None:
        raise AssertionError(f"{model}: no {timed[1]}-row chunk at front "
                             f"{timed[0]} among {cases}")
    return row, cases


def phase1_vlm(gen, dev):
    """The attention kernels and the overlay at phase 10's shapes
    (InternVL2-2B: 16 query heads on 8 KV heads of 128, full causal; 256
    patches before phase 3's prompts, merged sequences of 541-2037
    positions). flash: P's chunks of the longest sequence in its stream's
    cache (capacity rounded up to a chunk multiple): the first (patches
    and text), the one at q_offset 1500 and the last, in bf16 against the
    float32 plain version and the yardstick (SDPA with k/v repeated to 16
    heads), and in float32 within 2e-5; then the monolithic prefill of
    that sequence and its output, as the last-token and first-token
    checks run it, in both dtypes. paged: phase 10's eight
    sequences at their last decode step in a table as wide as D's, in
    nbhd (D's layout), nhbd and nhdb within the main-path bf16 limits,
    and in float32 nbhd within 2e-5. overlay: every (front, rows) of
    phase 10's streamed chunks into D's pools (24 layers, 8 KV heads of
    128, block 32), bit-identical to the plain version and to
    ``index_copy_``. Returns flash's (the chunk at 1500), paged's (nbhd)
    and the overlay's (500 rows at front 20) timings, keyed by kernel
    name."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    cfg = get_config(MODEL10)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    seqs = [int(n) + PHASE10_PATCHES for n in np.random.default_rng(
        SEED).integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)]
    out = {}
    n = max(seqs)
    cap = -(-n // PREFILL_CHUNK) * PREFILL_CHUNK
    last = (n - 1) // PREFILL_CHUNK * PREFILL_CHUNK
    for c0 in sorted({0, 1500, last}):
        sq = min(PREFILL_CHUNK, n - c0)
        _flash_case(gen, dev, "float32", 1, h, kv, sq, cap, d, 0, c0,
                    main=True)
        err, (q, k, v), yard = _flash_case(gen, dev, "bfloat16", 1, h, kv,
                                           sq, cap, d, 0, c0, main=True)
        k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
        mask = flash_mask(sq, cap, c0, 0, dev)
        pairs = sq * c0 + sq * (sq + 1) // 2
        b_ms, b_by = bound(4.0 * d * h * pairs,
                           2.0 * (2 * sq * h * d + 2 * (c0 + sq) * kv * d),
                           "bfloat16")
        row = dict(shape=f"q(1,{h},{sq},{d}) kv(1,{kv},{cap},{d}) "
                         f"q_offset={c0} bf16",
                   max_abs_err=err, yardstick=yard,
                   **time_all(lambda: ops.flash_attention(q, k, v,
                                                          q_offset=c0),
                              plain=lambda: ref.flash_attention_ref(
                                  q, k, v, q_offset=c0),
                              library=lambda: F.scaled_dot_product_attention(
                                  q, k_rep, v_rep, attn_mask=mask)),
                   library="scaled_dot_product_attention, k/v repeated to "
                           f"{h} heads, boolean mask",
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": 1, "extra": f"flash_attention, InternVL2 chunk at "
                                   f"{c0}", **row})
        if c0 == 1500:
            out["flash_attention"] = row
        del q, k, v, k_rep, v_rep, mask
    # the checks' monolithic prefills: the longest sequence and its output
    for dtype in ("float32", "bfloat16"):
        _flash_case(gen, dev, dtype, 1, h, kv, n + MAX_NEW, n + MAX_NEW, d, 0,
                    0, main=True)
    out["paged_attention"] = decode_rows(gen, dev, "InternVL2", seqs, h,
                                         kv, d)
    out["scatter_pages_overlay"], cases = repage_rows(
        gen, dev, "InternVL2", seqs, PREFILL_CHUNK, cfg.num_layers, kv, d)
    emit({"phase": 1, "vlm_checks": {"flash": 8, "paged": 4,
                                     "overlay": len(cases),
                                     "overlay_cases": cases}})
    return out


def phase1_encdec(gen, dev):
    """The attention kernels, the overlay and the layout module at phase
    11's shapes (Whisper-large-v3: 20 heads on 20 KV heads of 64, 1500
    memory rows; phase 11's eight prompts of 16-224 tokens in 64-token
    chunks). flash, with q, k and v laid out as the model passes them
    (sequence-major, transposed): the encoder's non-causal
    self-attention over 1500 frames; every chunk phase 11 streams, causal
    at its q_offset in the stream's cache (capacity rounded up to a chunk
    multiple); P's cross-attention of every chunk length over the 1500
    memory rows (kv_len 1500); and the checks' monolithic prefill of the
    longest prompt and its output, self and cross. Each in bf16 against
    the float32 plain version and the yardstick (SDPA over the same keys,
    the causal mask or none) and in float32 within 2e-5; the encoder,
    the deepest full causal chunk and the full cross chunk timed. paged:
    phase 11's eight sequences at their last decode step in a table as
    wide as D's, in nbhd (D's layout), nhbd and nhdb within the main-path
    bf16 limits, and in float32 nbhd within 2e-5. overlay: every (front,
    rows) of phase 11's streamed chunks into D's pools (32 layers, 20 KV
    heads of 64, block 32), bit-identical to the plain version and to
    ``index_copy_``.
    layout: ``convert`` of the longest prompt's pages from P's vendor
    (nhbd, block 16) to D's (nbhd, block 32) in bf16 — the gather and
    scatter kernels — bit-identical to the same call on the CPU. Returns
    flash's (the encoder), paged's (nbhd) and the overlay's (64 rows at
    front 0) timings, keyed by kernel name."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.compat import layout
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    cfg = get_config(MODEL11)
    h, kv, d, mem = cfg.num_heads, cfg.num_kv_heads, cfg.hd, \
        cfg.max_source_len
    seqs = [r.prompt_len for r in phase11_requests(cfg)]
    out = {}
    # the encoder: q and k of 1500 frames, every key visible
    nc = dict(main=True, causal=False, seq_major=True)
    _flash_case(gen, dev, "float32", 1, h, kv, mem, mem, d, 0, 0, **nc)
    err, (q, k, v), yard = _flash_case(gen, dev, "bfloat16", 1, h, kv, mem,
                                       mem, d, 0, 0, **nc)
    b_ms, b_by = bound(4.0 * d * h * mem * mem, 2.0 * 4 * mem * h * d,
                       "bfloat16")
    out["flash_attention"] = row = dict(
        shape=f"q(1,{h},{mem},{d}) kv(1,{kv},{mem},{d}) non-causal bf16 "
              "(the encoder)",
        max_abs_err=err, yardstick=yard,
        **time_all(lambda: ops.flash_attention(q, k, v, causal=False),
                   plain=lambda: ref.flash_attention_ref(q, k, v,
                                                         causal=False),
                   library=lambda: F.scaled_dot_product_attention(q, k, v)),
        library="scaled_dot_product_attention, no mask",
        bound_ms=b_ms, bound_by=b_by)
    emit({"phase": 1, "extra": "flash_attention, Whisper encoder", **row})
    del q, k, v
    # P's chunks: each chunk's causal self-attention at its q_offset in the
    # stream's cache (capacity rounded up to a chunk multiple), and its
    # cross-attention over the memory rows (kv_len 1500); one full chunk
    # at the deepest offset of each kind timed
    chunks = sorted({(c0, min(PHASE11_CHUNK, n - c0),
                      -(-n // PHASE11_CHUNK) * PHASE11_CHUNK)
                     for n in seqs for c0 in range(0, n, PHASE11_CHUNK)})
    deepest = max(c for c in chunks if c[1] == PHASE11_CHUNK)
    for c0, sq, cap in chunks:
        for dtype in ("float32", "bfloat16"):
            err, (q, k, v), yard = _flash_case(gen, dev, dtype, 1, h, kv, sq,
                                               cap, d, 0, c0, main=True,
                                               seq_major=True)
        if (c0, sq, cap) == deepest:
            pairs = sq * c0 + sq * (sq + 1) // 2
            b_ms, b_by = bound(4.0 * d * h * pairs,
                               2.0 * (2 * sq * h * d + 2 * (c0 + sq) * kv * d),
                               "bfloat16")
            mask = flash_mask(sq, cap, c0, 0, dev)
            emit({"phase": 1, "extra": "flash_attention, Whisper decoder "
                                       f"chunk at {c0}",
                  "shape": f"q(1,{h},{sq},{d}) kv(1,{kv},{cap},{d}) "
                           f"q_offset={c0} bf16",
                  "max_abs_err": err, "yardstick": yard,
                  **time_all(lambda: ops.flash_attention(q, k, v,
                                                         q_offset=c0),
                             plain=lambda: ref.flash_attention_ref(
                                 q, k, v, q_offset=c0),
                             library=lambda: F.scaled_dot_product_attention(
                                 q, k, v, attn_mask=mask)),
                  "library": "scaled_dot_product_attention, boolean mask",
                  "bound_ms": b_ms, "bound_by": b_by})
            del mask
        del q, k, v
    chunk_lens = sorted({sq for _, sq, _ in chunks})
    for sq in chunk_lens:
        for dtype in ("float32", "bfloat16"):
            err, (q, k, v), yard = _flash_case(gen, dev, dtype, 1, h, kv, sq,
                                               mem, d, 0, 0, kv_len=mem, **nc)
        if sq == PHASE11_CHUNK:
            b_ms, b_by = bound(4.0 * d * h * sq * mem,
                               2.0 * (2 * sq * h * d + 2 * mem * kv * d),
                               "bfloat16")
            emit({"phase": 1, "extra": "flash_attention, Whisper cross "
                                       "chunk",
                  "shape": f"q(1,{h},{sq},{d}) kv(1,{kv},{mem},{d}) "
                           f"non-causal kv_len {mem} bf16",
                  "max_abs_err": err, "yardstick": yard,
                  **time_all(lambda: ops.flash_attention(
                                 q, k, v, causal=False, kv_len=mem),
                             plain=lambda: ref.flash_attention_ref(
                                 q, k, v, causal=False, kv_len=mem),
                             library=lambda: F.scaled_dot_product_attention(
                                 q, k, v)),
                  "library": "scaled_dot_product_attention, no mask",
                  "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v
    # the checks' monolithic prefill of the longest prompt and its output:
    # causal self-attention over itself, cross-attention over the memory
    n = max(seqs) + MAX_NEW
    for dtype in ("float32", "bfloat16"):
        _flash_case(gen, dev, dtype, 1, h, kv, n, n, d, 0, 0, main=True,
                    seq_major=True)
        _flash_case(gen, dev, dtype, 1, h, kv, n, mem, d, 0, 0, kv_len=mem,
                    **nc)
    out["paged_attention"] = decode_rows(gen, dev, "Whisper", seqs, h, kv,
                                         d)
    out["scatter_pages_overlay"], cases = repage_rows(
        gen, dev, "Whisper", seqs, PHASE11_CHUNK, cfg.num_layers, kv, d)
    # the layout module: P's pages to D's, on the card and on the CPU
    src = KVPageSpec(P_VENDOR["block_size"], P_VENDOR["layout"], "bfloat16",
                     kv, d)
    dst = KVPageSpec(D_VENDOR["block_size"], D_VENDOR["layout"], "bfloat16",
                     kv, d)
    n = max(seqs)
    pages = _rand(gen, src.pool_shape(src.blocks_for(n)), torch.bfloat16, dev)
    got = layout.convert(src, dst, pages, n)
    want = layout.convert(src, dst, pages.cpu(), n)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("layout.convert nhbd/16 -> nbhd/32 bf16 on the "
                             "card differs from the CPU")
    emit({"phase": 1, "encdec_checks": {
        "flash": 2 * (1 + len(chunks) + len(chunk_lens) + 2),
        "flash_chunks": chunks, "flash_cross_chunk_lens": chunk_lens,
        "paged": 4, "overlay": len(cases), "overlay_cases": cases,
        "layout_convert": f"{n} rows, {src.layout}/{src.block_size} -> "
                          f"{dst.layout}/{dst.block_size} bf16"}})
    return out


def phase1_load(gen, dev):
    """The attention kernels and the overlay at phase 12's shapes
    (llama2-7b: 32 heads of 128 on 32 KV heads; its warmup and open-loop
    requests, prompts of 32-1024 tokens, streamed in 500-token chunks).
    flash, with q, k and v sequence-major as the model passes them: every
    (q_offset, rows, capacity) of those chunks in the stream's cache
    (capacity rounded up to a chunk multiple), and the checks' monolithic
    prefills of the longest request (its prompt, for the first token;
    its prompt and output, for the last), each in bf16 against the
    float32 plain version and the yardstick (SDPA under the causal mask)
    and in float32 within 2e-5; the deepest full chunk timed. paged: D's
    batch of 8 slots and 34-page table (1088 rows of block 32), nbhd,
    with 1-8 slots active at their last decode step (an idle slot attends
    to 1 row, as the engine passes it): the requests in arrival order,
    eight at a time, and the k longest for k < 8; bf16 within the
    main-path limits and float32 within 2e-5, the fullest batch timed.
    overlay: every (front, rows) of those chunks into D's 273-block pools
    (32 layers), bit-identical to the plain version and to
    ``index_copy_``, the first full chunk timed. Returns flash's, paged's
    and the overlay's timings, keyed by kernel name."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import loadgen
    cfg = get_config(MODEL)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    reqs = [it.request for it in phase12_warmup(loadgen)
            + phase12_workload(loadgen)]
    seqs = [r.prompt_len for r in reqs]
    out = {}
    chunks = sorted({(c0, min(PREFILL_CHUNK, n - c0),
                      -(-n // PREFILL_CHUNK) * PREFILL_CHUNK)
                     for n in seqs for c0 in range(0, n, PREFILL_CHUNK)})
    deepest = max(c for c in chunks if c[1] == PREFILL_CHUNK)
    for c0, sq, cap in chunks:
        for dtype in ("float32", "bfloat16"):
            err, (q, k, v), yard = _flash_case(gen, dev, dtype, 1, h, kv, sq,
                                               cap, d, 0, c0, main=True,
                                               seq_major=True)
        if (c0, sq, cap) == deepest:
            pairs = sq * c0 + sq * (sq + 1) // 2
            b_ms, b_by = bound(4.0 * d * h * pairs,
                               2.0 * (2 * sq * h * d + 2 * (c0 + sq) * kv * d),
                               "bfloat16")
            mask = flash_mask(sq, cap, c0, 0, dev)
            out["flash_attention"] = row = dict(
                shape=f"q(1,{h},{sq},{d}) kv(1,{kv},{cap},{d}) "
                      f"q_offset={c0} bf16",
                max_abs_err=err, yardstick=yard,
                **time_all(lambda: ops.flash_attention(q, k, v, q_offset=c0),
                           plain=lambda: ref.flash_attention_ref(
                               q, k, v, q_offset=c0),
                           library=lambda: F.scaled_dot_product_attention(
                               q, k, v, attn_mask=mask)),
                library="scaled_dot_product_attention, boolean mask",
                bound_ms=b_ms, bound_by=b_by)
            emit({"phase": 1, "extra": f"flash_attention, phase 12 chunk at "
                                       f"{c0}", **row})
            del mask
        del q, k, v
    # the checks' monolithic prefills of the longest request
    r = max(reqs, key=lambda r: r.prompt_len)
    monolithic = (r.prompt_len, r.prompt_len + r.max_new_tokens - 1)
    for n in monolithic:
        for dtype in ("float32", "bfloat16"):
            _flash_case(gen, dev, dtype, 1, h, kv, n, n, d, 0, 0, main=True,
                        seq_major=True)
    # D's decode batches at their last step, in its 34-page table
    bs, slots = D_VENDOR["block_size"], PHASE12_MAX_BATCH
    width = -(-PHASE12_MAX_SEQ // bs)
    last = [r.prompt_len + r.max_new_tokens - 1 for r in reqs]
    active = [last[i:i + slots] for i in range(0, len(last), slots)]
    active += [sorted(last)[-k:] for k in range(1, slots)]
    batches = [a + [1] * (slots - len(a)) for a in active]
    fullest = max((b for b, a in zip(batches, active) if len(a) == slots),
                  key=sum)
    for lens in batches:
        _paged_case(gen, dev, "float32", "nbhd", slots, h, kv, d, bs, lens,
                    0, main=True, width=width)
        err, a = _paged_case(gen, dev, "bfloat16", "nbhd", slots, h, kv, d,
                             bs, lens, 0, main=True, width=width)
        if lens is fullest:
            tokens = sum(lens)
            p_ms, p_by = bound(4.0 * d * h * tokens, 2.0 * 2 * tokens * kv * d
                               + 2.0 * 2 * slots * h * d, "bfloat16")
            out["paged_attention"] = row = dict(
                shape=f"q({slots},{h},{d}) pools nbhd bs{bs} bf16, table "
                      f"{width} pages, seq_lens {lens}",
                max_abs_err=err,
                **time_all(lambda: ops.paged_attention(*a, layout="nbhd"),
                           plain=lambda: ref.paged_attention_ref(
                               *a, layout="nbhd")),
                bound_ms=p_ms, bound_by=p_by)
            emit({"phase": 1, "extra": "paged_attention, phase 12 decode",
                  **row})
        del a
    d_blocks = slots * width + 1
    out["scatter_pages_overlay"], cases = repage_rows(
        gen, dev, "phase 12", seqs, PREFILL_CHUNK, cfg.num_layers, kv, d,
        n_blocks=d_blocks, timed=(0, PREFILL_CHUNK))
    emit({"phase": 1, "load_checks": {
        "flash": 2 * (len(chunks) + len(monolithic)), "flash_chunks": chunks,
        "flash_monolithic": monolithic, "paged": 2 * len(batches),
        "paged_active": [len(a) for a in active], "paged_table": width,
        "overlay": len(cases), "overlay_cases": cases,
        "overlay_pool_blocks": d_blocks}})
    return out


def phase1_demo(gen, dev):
    """The float32 kernels at the shapes phase 17's examples give them.
    The serving example (demo-100m: 10 query heads on 5 KV heads of 64,
    float32; its 8 requests of 16-63 prompt tokens and 8 new tokens, from
    its own draws): flash at every (q_offset, rows, capacity) of P's
    16-token chunks, q, k and v sequence-major as the model passes them,
    the deepest full chunk timed; paged in D's block-8 nbhd pools over
    its 8-slot, 32-page table at each of its 7 decode steps, the last
    timed; the D-side re-page of every chunk from P's TP 5 (decode, TP 5
    -> 1 realignment of the uneven shards and the overlay into D's
    512-block pools of 16 layers: ``disagg._repage_kv_entry``) on the
    card against the same on the CPU, bit for bit, and the overlay of a
    realigned 16-row chunk against its plain version and
    ``index_copy_``, timed. The quickstart (4 query heads on 2 KV heads
    of 16): flash over its 8-token prompt and paged in D's block-4 nbhd
    pool over its 16-page table at each of its 7 decode steps, both
    timed. flash and paged within 2e-5 of their plain versions
    (``ATOL``). Returns each kernel's demo row (``"demo"``) and
    quickstart row (``"quickstart"``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.disagg import _repage_kv_entry
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.paged_cache import KVPageSpec
    ex = example_module("torch_serve_disagg")
    cfg, vp, vd = ex.CFG, ex.VENDOR_P, ex.VENDOR_D
    h, kv, d, layers = (cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                        cfg.num_layers)
    reqs = ex.build_requests(PHASE17_REQUESTS, PHASE17_MAX_NEW)
    seqs = [r.prompt_len for r in reqs]
    chunk = ex.parse_args([]).prefill_chunk
    f32 = torch.float32
    out = {"flash_attention": {}, "paged_attention": {},
           "scatter_pages_overlay": {}}

    def sdpa_lib(q, k, v, mask):
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            attn_mask=mask)

    def flash_row(what, q, k, v, c0, cap, err, heads, kvh, hd):
        sq = q.shape[2]
        pairs = sq * c0 + sq * (sq + 1) // 2
        b_ms, b_by = bound(4.0 * hd * heads * pairs,
                           4.0 * (2 * sq * heads * hd + 2 * (c0 + sq) * kvh
                                  * hd), "float32")
        mask = flash_mask(sq, cap, c0, 0, dev)
        args = dict(q_offset=c0, kv_len=cap)
        row = dict(shape=f"q(1,{heads},{sq},{hd}) kv(1,{kvh},{cap},{hd}) "
                         f"q_offset={c0} f32, sequence-major",
                   max_abs_err=err,
                   **time_all(lambda: ops.flash_attention(q, k, v, **args),
                              plain=lambda: ref.flash_attention_ref(
                                  q, k, v, **args),
                              library=lambda: sdpa_lib(q, k, v, mask)),
                   library="scaled_dot_product_attention, k/v repeated, "
                           "boolean mask",
                   bound_ms=b_ms, bound_by=b_by)
        emit({"phase": 1, "extra": f"flash_attention, {what}", **row})
        return row

    # flash: P's chunks of the serving example
    chunks = sorted({(c0, min(chunk, n - c0), -(-n // chunk) * chunk)
                     for n in seqs for c0 in range(0, n, chunk)
                     if min(chunk, n - c0) > 1})    # one row: flash_decode
    deepest = max(c for c in chunks if c[1] == chunk)
    for c0, sq, cap in chunks:
        err, (q, k, v), _ = _flash_case(gen, dev, "float32", 1, h, kv, sq,
                                        cap, d, 0, c0, kv_len=cap,
                                        seq_major=True)
        if (c0, sq, cap) == deepest:
            out["flash_attention"]["demo"] = flash_row(
                "demo-100m chunk", q, k, v, c0, cap, err, h, kv, d)
    # paged: D's decode batch at every step (the example's engines hold
    # 256 positions a slot)
    bs, width = vd.block_size, -(-256 // vd.block_size)
    for step in range(1, PHASE17_MAX_NEW):          # the decode steps
        lens = [n + step for n in seqs]
        err, a = _paged_case(gen, dev, "float32", vd.layout, len(lens), h,
                             kv, d, bs, lens, 0, width=width)
    tokens = sum(lens)
    p_ms, p_by = bound(4.0 * d * h * tokens, 4.0 * 2 * tokens * kv * d
                       + 4.0 * 2 * len(lens) * h * d, "float32")
    out["paged_attention"]["demo"] = row = dict(
        shape=f"q({len(lens)},{h},{d}) pools {vd.layout} bs{bs} f32, {kv} "
              f"KV heads, table {width} pages, seq_lens {lens}",
        max_abs_err=err,
        **time_all(lambda: ops.paged_attention(*a, layout=vd.layout),
                   plain=lambda: ref.paged_attention_ref(*a,
                                                         layout=vd.layout)),
        bound_ms=p_ms, bound_by=p_by)
    emit({"phase": 1, "extra": "paged_attention, demo-100m decode", **row})
    del a
    # the re-page from P's TP 5: card against CPU, every chunk
    spec = KVPageSpec(bs, vd.layout, vd.kv_dtype, kv, d)
    n_blocks = 512
    pools = [_rand(gen, (layers,) + spec.pool_shape(n_blocks), f32, dev)
             for _ in range(2)]
    pools_cpu = [p.cpu() for p in pools]
    kvs = kv // vp.tp
    cases = sorted({(c0, min(chunk, n - c0)) for n in seqs
                    for c0 in range(0, n, chunk)})
    for c0, rows in cases:
        ids = (torch.randperm(n_blocks - 1, generator=gen, device=dev)
               [:-(-(c0 + rows) // bs)] + 1).to(torch.int32)
        pay = _rand(gen, (2 * vp.tp, layers, rows, kvs, d), f32, dev)
        args = dict(wire=WireFormat("raw", "float32"), tp_p=vp.tp,
                    tp_d=vd.tp, count=layers, front=c0 % bs, rmw=True)
        _repage_kv_entry(spec, *pools, ids, pay, None, c0 // bs, **args)
        _repage_kv_entry(spec, *pools_cpu, ids.cpu(), pay.cpu(), None,
                         c0 // bs, **args)
        if not all(torch.equal(p.cpu(), c) for p, c in zip(pools,
                                                           pools_cpu)):
            raise AssertionError(f"re-page of rows {rows} at {c0} from TP "
                                 f"{vp.tp}: card and CPU pools differ")
    del pools_cpu
    # the overlay of a realigned full chunk, timed
    canon = _rand(gen, (layers, chunk, kv, d), f32, dev)
    pids = (torch.randperm(n_blocks - 1, generator=gen, device=dev)
            [:chunk // bs] + 1).to(torch.int32)
    pool = pools[0]
    want = ref.scatter_pages_overlay_ref(spec, pool.clone(), pids, canon,
                                         front=0, seq_len=chunk)
    got = ops.scatter_pages_overlay(spec, pool, pids, canon, front=0,
                                    seq_len=chunk)
    if not torch.equal(got, want):
        raise AssertionError("overlay f32 demo chunk: differs from its "
                             "plain version")
    flat, rws, src = overlay_vs_index_copy(gen, spec, pool, pids, canon, 0,
                                           chunk)
    b_ms, b_by = bound(0.0, 4.0 * 2 * layers * chunk * kv * d, "float32")
    out["scatter_pages_overlay"]["demo"] = row = dict(
        shape=f"rows ({layers},{chunk},{kv},{d}) into pool ({layers},"
              f"{n_blocks},{bs},{kv},{d}) {vd.layout} f32, front 0, "
              f"realigned from TP {vp.tp}",
        max_abs_err=0.0, library_bit_identical=True,
        **time_all(lambda: ops.scatter_pages_overlay(
                       spec, pool, pids, canon, front=0, seq_len=chunk),
                   plain=lambda: ref.scatter_pages_overlay_ref(
                       spec, pool, pids, canon, front=0, seq_len=chunk),
                   library=lambda: flat.index_copy_(1, rws, src)),
        bound_ms=b_ms, bound_by=b_by)
    emit({"phase": 1, "extra": "scatter_pages_overlay, demo-100m chunk",
          **row})
    del pools, pool, flat, src, canon
    # the quickstart: its monolithic prefill and its decode steps
    qs = example_module("torch_quickstart").CFG
    qh, qkv, qd, plen, qnew = qs.num_heads, qs.num_kv_heads, qs.hd, 8, 8
    err, (q, k, v), _ = _flash_case(gen, dev, "float32", 1, qh, qkv, plen,
                                    plen, qd, 0, 0, seq_major=True)
    out["flash_attention"]["quickstart"] = flash_row(
        "quickstart prefill", q, k, v, 0, plen, err, qh, qkv, qd)
    qbs, qwidth = 4, 64 // 4          # its D: block 4, 64 positions a slot
    for step in range(1, qnew):
        err, a = _paged_case(gen, dev, "float32", "nbhd", 1, qh, qkv, qd,
                             qbs, [plen + step], 0, width=qwidth)
    tok = plen + qnew - 1
    p_ms, p_by = bound(4.0 * qd * qh * tok, 4.0 * 2 * tok * qkv * qd
                       + 4.0 * 2 * qh * qd, "float32")
    out["paged_attention"]["quickstart"] = row = dict(
        shape=f"q(1,{qh},{qd}) pools nbhd bs{qbs} f32, {qkv} KV heads, "
              f"table {qwidth} pages, seq_lens [{tok}]",
        max_abs_err=err,
        **time_all(lambda: ops.paged_attention(*a, layout="nbhd"),
                   plain=lambda: ref.paged_attention_ref(*a, layout="nbhd")),
        bound_ms=p_ms, bound_by=p_by)
    emit({"phase": 1, "extra": "paged_attention, quickstart decode", **row})
    emit({"phase": 1, "demo_checks": {
        "flash_chunks": chunks, "paged_steps": PHASE17_MAX_NEW - 1,
        "repage_cases": cases, "repage_tp": [vp.tp, vd.tp],
        "quickstart_paged_steps": qnew - 1}})
    return out


def phase1_windowed(gen, dev):
    """The window paths at phase 6's shapes (Mixtral: 32 query heads over
    8 KV heads, head dim 128, window 4096), in bf16. Bounds count only the
    keys inside the window. flash: a 500-token chunk at q_offset 7500 over
    the 8500-slot cache of an 8192-token prompt, held to the SDPA
    yardstick. paged: phase 6's eight sequences at their last decode step,
    with NaN in every stale row below each floor: its output must be
    finite and bit-identical to the kernel's on finite pools, and the
    window must move the plain version's output by at least 10 times the
    kernel's error."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    cfg = get_config(MODEL6)
    h, kv, d, win = cfg.num_heads, cfg.num_kv_heads, cfg.hd, \
        cfg.sliding_window
    c0, sq, cap = 7500, 500, 8500
    q = _rand(gen, (1, sq, h, d), torch.bfloat16, dev).transpose(1, 2)
    k = _rand(gen, (1, cap, kv, d), torch.bfloat16, dev).transpose(1, 2)
    v = _rand(gen, (1, cap, kv, d), torch.bfloat16, dev).transpose(1, 2)
    args = dict(window=win, q_offset=c0, kv_len=cap)
    got = ops.flash_attention(q, k, v, **args)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **args)
    grp = h // kv
    k_rep, v_rep = (t.repeat_interleave(grp, dim=1) for t in (k, v))
    mask = flash_mask(sq, cap, c0, win, dev)
    lib = F.scaled_dot_product_attention(q, k_rep, v_rep, attn_mask=mask)
    torch.cuda.synchronize()
    err, lib_err = (got.float() - want).abs(), (lib.float() - want).abs()
    yard = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "sdpa_max_abs_err": float(lib_err.max()),
            "sdpa_mean_abs_err": float(lib_err.mean())}
    if not (yard["max_abs_err"] <= FLASH_VS_SDPA * yard["sdpa_max_abs_err"]
            and yard["mean_abs_err"]
            <= FLASH_VS_SDPA * yard["sdpa_mean_abs_err"]):
        raise AssertionError(f"windowed flash: errors exceed {FLASH_VS_SDPA}x"
                             f" scaled_dot_product_attention's: {yard}")
    keys = c0 + sq - (c0 - win + 1)              # keys some row sees
    flops = 4.0 * d * h * sq * win               # every row sees 4096 keys
    nbytes = 2.0 * (2 * sq * h * d + 2 * keys * kv * d)
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    emit({"phase": 1, "extra": "flash_attention, window 4096",
          "shape": f"q(1,{h},{sq},{d}) q_offset={c0} kv(1,{kv},{cap},{d}) "
                   f"window={win} bf16",
          "max_abs_err": yard["max_abs_err"], "yardstick": yard,
          **time_all(lambda: ops.flash_attention(q, k, v, **args),
                     plain=lambda: ref.flash_attention_ref(q, k, v, **args),
                     library=lambda: F.scaled_dot_product_attention(
                         q, k_rep, v_rep, attn_mask=mask)),
          "library": "scaled_dot_product_attention, k/v repeated to 32 "
                     "heads, boolean mask",
          "bound_ms": b_ms, "bound_by": b_by})
    del q, k, v, k_rep, v_rep, mask, got, want, lib
    # paged: the eight sequences at their last decode step, D's vendor
    bs = D_VENDOR["block_size"]
    lens = [n + MAX_NEW for n in PHASE6_PROMPTS]
    args = _paged_inputs(gen, dev, "bfloat16", "nbhd", len(lens), h, kv, d,
                         bs, lens)
    stale = stale_nan(args, bs, win)
    got = ops.paged_attention(*stale, layout="nbhd", window=win)
    fin = ops.paged_attention(*args, layout="nbhd", window=win)
    want = ref.paged_attention_ref(*args, layout="nbhd", window=win)
    full = ref.paged_attention_ref(*args, layout="nbhd")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("windowed paged: non-finite output with NaN "
                             "below the floors")
    if not torch.equal(got, fin):
        raise AssertionError("windowed paged: NaN below the floors changed "
                             "the output")
    err = _check(f"paged bf16 nbhd {(len(lens), h, kv, d, bs)} window={win}",
                 fin, want, "bfloat16", True)
    effect = float((want.float() - full.float()).abs().max())
    if not effect >= 10 * err:
        raise AssertionError(f"windowed paged: window effect {effect} < 10x "
                             f"the kernel's error {err}")
    tokens = sum(min(n, win) for n in lens)
    p_ms, p_by = bound(4.0 * d * h * tokens, 2.0 * 2 * tokens * kv * d
                       + 2.0 * 2 * len(lens) * h * d, "bfloat16")
    emit({"phase": 1, "extra": "paged_attention, window 4096, NaN below "
                               "the floors",
          "shape": f"q({len(lens)},{h},{d}) pools nbhd bs{bs} bf16, "
                   f"{kv} KV heads, seq_lens {lens}, window={win}",
          "max_abs_err": err, "window_effect": effect,
          "nan_rows": int(torch.isnan(stale[1]).any(-1).any(-1).sum()),
          "finite_with_nan": True, "equal_to_finite_pools": True,
          **time_all(lambda: ops.paged_attention(*stale, layout="nbhd",
                                                 window=win),
                     plain=lambda: ref.paged_attention_ref(
                         *args, layout="nbhd", window=win)),
          "bound_ms": p_ms, "bound_by": p_by})


def decode_cache(gen, dev, b, cap, n, kvh, hd, kv_dtype, dv=None):
    """K (b, cap, kvh, hd) and V (b, cap, kvh, dv or hd) of unit normals
    cast to ``kv_dtype`` and pos tags of positions 0..n-1 at slot position
    % cap (-1 where none): a ring of the last ``cap`` positions starting
    at slot n % cap, or a full-capacity cache with room left. A V
    narrower than K is the second half of a (.., 2 dv) buffer, as MLA's
    value part of its expanded latent."""
    import torch
    k = _rand(gen, (b, cap, kvh, hd), torch.float32, dev).to(kv_dtype)
    if dv is None or dv == hd:
        v = _rand(gen, (b, cap, kvh, hd), torch.float32, dev).to(kv_dtype)
    else:
        v = _rand(gen, (b, cap, kvh, 2 * dv), torch.float32,
                  dev).to(kv_dtype)[..., dv:]
    pos = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    held = torch.arange(max(0, n - cap), n, dtype=torch.int32, device=dev)
    pos[held.long() % cap] = held
    return k, v, pos[None].expand(b, cap).contiguous()


def decode_library(q, k, v, pos, q_offset: int, window: int, scale=None):
    """flash_decode's library counterpart on the same values: a callable of
    ``scaled_dot_product_attention`` in bf16 with k/v repeated to the query
    heads and a boolean mask from the tags, float8 K/V dequantized to bf16
    here (outside the callable's time), returning (B, Sq, H, dv)."""
    import torch
    import torch.nn.functional as F
    grp = q.shape[2] // k.shape[2]
    kb, vb = (t.to(torch.bfloat16).transpose(1, 2) for t in (k, v))
    kr = (kb.repeat_interleave(grp, 1) if grp > 1 else kb).contiguous()
    vr = (vb.repeat_interleave(grp, 1) if grp > 1 else vb).contiguous()
    qp = torch.arange(q_offset, q_offset + q.shape[1],
                      device=q.device)[None, :, None]
    tags = pos.long()[:, None, :]
    ok = (tags >= 0) & (tags <= qp)                       # (b, sq, cap)
    if window > 0:
        ok &= (qp - tags) < window
    mask = ok[:, None]                                    # (b, 1, sq, cap)
    qt = q.to(torch.bfloat16).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask,
                                              scale=scale).transpose(1, 2)

    return library, ok


def decode_row(gen, dev, what, b, cap, n, kvh, h, hd, window, kv_dtype):
    """flash_decode at one main-path shape (one query row a sequence at
    position n - 1): held to the SDPA yardstick against the float32 plain
    version (max and mean error at most FLASH_VS_SDPA x those of
    ``scaled_dot_product_attention`` on the same values in bf16 — k/v
    repeated to the query heads, a boolean mask from the tags, float8 K/V
    dequantized to bf16 first, that copy outside SDPA's time), then timed;
    the bound: q, o, the tags and the visible slots' K/V once, or the
    products over 989 TFLOP/s (the kernel's arithmetic: bf16 mma.sync
    on the tensor cores)."""
    import torch
    from repro_torch.kernels import ops, ref
    k, v, pos = decode_cache(gen, dev, b, cap, n, kvh, hd, kv_dtype)
    q = _rand(gen, (b, 1, h, hd), torch.bfloat16, dev)
    args = dict(q_offset=n - 1, window=window)

    def kernel():
        return ops.cache_attention(q, k, v, pos, **args)

    def plain():
        return ref.cache_attention_ref(q, k, v, pos, **args)

    qp = n - 1
    library, ok = decode_library(q, k, v, pos, qp, window)
    got = kernel()
    want = ref.cache_attention_ref(q.float(), k.float(), v.float(), pos,
                                   **args)
    yard = _yardstick(f"1 flash_decode {what}", got, want, library())
    del got, want
    t = time_all(kernel, plain, library)
    seen = ops.cache_visible_slots(1, cap, window=window, q_offset=qp)
    if seen != int(ok[0, 0].sum()):
        raise AssertionError(f"flash_decode {what}: {seen} visible slots "
                             f"counted, the tags give {int(ok[0, 0].sum())}")
    flops = 2.0 * b * h * seen * 2 * hd
    nbytes = 2.0 * 2 * b * h * hd + 4.0 * b * cap \
        + b * kvh * seen * 2 * hd * k.element_size()
    t["bound_ms"], t["bound_by"] = bound(flops, nbytes, "bfloat16")
    held = (f"a ring starting at slot {n % cap}" if n > cap
            else f"{cap - n} slots empty")
    t.update(shape=f"q({b},1,{h},{hd}) bf16, K/V ({b},{cap},{kvh},{hd}) "
                   f"{str(kv_dtype).replace('torch.', '')}, positions "
                   f"{max(0, n - cap)}..{n - 1} ({held}), q_offset {qp}, "
                   f"window {window}", visible_slots=seen, **yard)
    t["library"] = ("scaled_dot_product_attention, k/v repeated to the "
                    "query heads, boolean mask from the tags"
                    + ("; K/V dequantized to bf16 outside its time"
                       if kv_dtype == torch.float8_e4m3fn else ""))
    return t


def phase1_decode(gen, dev):
    """flash_decode (``ops.cache_attention``): first against its plain
    version over small rings (filled to an unaligned length, partly
    filled), full-capacity caches, windows 0 and 6, groups 1 / 4 / 16 at
    head dims 64 / 128 / 256, one and three rows, in float32 (2e-5),
    bf16 and float8 K/V under a bf16 q (2e-2); then rows 1r (Mixtral's
    4096-slot ring and RecurrentGemma's 2048-slot ring at batch 2, each
    ring starting mid-buffer, 34,000 positions written) and 1f
    (Qwen1.5-32B's e4m3 cache of 32,896 slots holding 32,769 positions)
    by the yardstick, and 1q (phase 14a's one-row decode: Qwen3-4B's
    full-capacity bf16 cache of 32,896 slots holding 32,769 positions,
    row 1d's shape). Returns the kernels line's row: 1r Mixtral, with
    RecurrentGemma's as ``"rg"``, 1f as ``"fp8"`` and 1q as
    ``"dense"``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    n_checks = 0
    for kv_dt, q_dt in ((torch.float32, torch.float32),
                        (torch.bfloat16, torch.bfloat16),
                        (torch.float8_e4m3fn, torch.bfloat16)):
        dtype = "float32" if q_dt == torch.float32 else "bfloat16"
        for cap, n in ((16, 37), (16, 10), (48, 37)):
            for kvh, h, hd in ((2, 2, 64), (2, 8, 128), (1, 16, 256)):
                for window in (0, 6):
                    for sq in (1, 3):
                        k, v, pos = decode_cache(gen, dev, 2, cap, n, kvh,
                                                 hd, kv_dt)
                        q = _rand(gen, (2, sq, h, hd), q_dt, dev)
                        args = dict(q_offset=n - sq, window=window)
                        _check(f"flash_decode {dtype}/{kv_dt} cap {cap} n {n}"
                               f" {(kvh, h, hd)} window {window} sq {sq}",
                               ops.cache_attention(q, k, v, pos, **args),
                               ref.cache_attention_ref(q, k, v, pos, **args),
                               dtype, False)
                        n_checks += 1
    emit({"phase": 1, "extra": "flash_decode sweep", "checks": n_checks,
          "atol": ATOL})
    mix, rg, qw, q3 = (get_config(m) for m in (MODEL6, MODEL8, "qwen1.5-32b",
                                                MODEL14))
    cap_q = -(-(32_768 + 128) // 16) * 16
    row = decode_row(gen, dev, "1r mixtral ring", 2, mix.sliding_window,
                     34_000, mix.num_kv_heads, mix.num_heads, mix.hd,
                     mix.sliding_window, torch.bfloat16)
    row["rg"] = decode_row(gen, dev, "1r recurrentgemma ring", 2,
                           rg.sliding_window, 34_000, rg.num_kv_heads,
                           rg.num_heads, rg.hd, rg.sliding_window,
                           torch.bfloat16)
    row["fp8"] = decode_row(gen, dev, "1f qwen1.5-32b e4m3", 2, cap_q,
                            32_769, qw.num_kv_heads, qw.num_heads, qw.hd, 0,
                            torch.float8_e4m3fn)
    row["dense"] = decode_row(gen, dev, "1q qwen3-4b dense", 2, cap_q,
                              32_769, q3.num_kv_heads, q3.num_heads, q3.hd,
                              0, torch.bfloat16)
    return row


def decode_halves(gen, dev, what, b, cap, n, kvh, h, d, window, kv_dtype,
                  dv=None, scale=None):
    """flash_decode over a cache whose slots are cut in two, as each rank
    of a (1, 2) mesh holds its half of D's capacity-sharded cache:
    ``ops.cache_attention_partial`` on each half (the split kernel,
    stopped at its partials) and ``ops.cache_attention_combine`` over the
    two halves' splits (the combine kernel); q (b,1,h,d) bf16 over K
    (b,cap,kvh,d) and V (b,cap,kvh,dv) of ``kv_dtype`` holding positions
    0..n-1 (a ring of the last cap where n > cap) under ``window``. The
    composition is held to the whole-cache kernel call (one bf16 step, as
    the two round once from float32 sums in another order) and, by the
    SDPA yardstick, to the float32 plain version, then timed with its
    bound and SDPA's time. Returns (the composition, the second half's
    partial, the combine), each timed; the partial and the combine have
    no library call."""
    import torch
    from repro_torch.kernels import ops, ref
    dv = dv or d
    half = cap // 2
    k, v, pos = decode_cache(gen, dev, b, cap, n, kvh, d, kv_dtype, dv)
    q = _rand(gen, (b, 1, h, d), torch.bfloat16, dev)
    qo = n - 1
    args = dict(q_offset=qo, window=window, scale=scale)
    cuts = [(k[:, s:s + half], v[:, s:s + half], pos[:, s:s + half])
            for s in (0, half)]

    def partial(i=1):
        kh, vh, ph = cuts[i]
        return ops.cache_attention_partial(q, kh, vh, ph, **args)

    parts = [partial(0), partial(1)]
    acc = torch.cat([a for a, _ in parts], 2)
    ml = torch.cat([m for _, m in parts], 2)

    def combine():
        return ops.cache_attention_combine(acc, ml, torch.bfloat16)

    def halves():
        ps = [partial(0), partial(1)]
        return ops.cache_attention_combine(torch.cat([a for a, _ in ps], 2),
                                           torch.cat([m for _, m in ps], 2),
                                           torch.bfloat16)

    def plain_halves():
        ps = [ref.cache_attention_partial_ref(q, *c, **args) for c in cuts]
        return ref.decode_combine_ref(torch.cat([a for a, _ in ps], 2),
                                      torch.cat([m for _, m in ps], 2),
                                      torch.bfloat16)

    got = halves()
    whole = ops.cache_attention(q, k, v, pos, **args)
    # two bf16 roundings of float32 sums in another order: within one bf16
    # step of each element (the mean test of _check is for a float32 want)
    torch.cuda.synchronize()
    err = (got.float() - whole.float()).abs()
    vs_whole = float(err.max())
    steps = float((err / (BF16_FLOOR + BF16_STEP * whole.float().abs()))
                  .max())
    if not steps <= 1.0:
        raise AssertionError(f"{what} flash_decode halves vs the whole-cache"
                             f" call: {steps} bf16 steps (max error "
                             f"{vs_whole})")
    want = ref.cache_attention_ref(q.float(), k.float(), v.float(), pos,
                                   **args)
    library, ok = decode_library(q, k, v, pos, qo, window, scale)
    yard = _yardstick(f"{what} flash_decode halves", got, want, library())
    # the plain partial + combine against the plain whole (float32)
    plain_err = float((plain_halves().float() - ref.cache_attention_ref(
        q, k, v, pos, **args).float()).abs().max())
    del got, want, whole
    comp = time_all(halves, plain_halves, library)
    es = k.element_size()
    seen = int(ok[0, 0].sum())
    kv_bytes = b * kvh * seen * (d + dv) * es
    comp_bytes = 2.0 * b * h * (d + dv) + 4.0 * b * cap + kv_bytes
    comp["bound_ms"], comp["bound_by"] = bound(
        2.0 * b * h * seen * (d + dv), comp_bytes, "bfloat16")
    dt = str(kv_dtype).replace("torch.", "")
    comp.update(shape=f"q({b},1,{h},{d}) bf16 over two halves of {half} "
                      f"slots of a {cap}-slot {dt} cache ({kvh} KV heads, K "
                      f"{d}, V {dv}), positions {max(0, n - cap)}..{qo}, "
                      f"window {window}", visible_slots=seen,
                vs_whole_call_max_abs_err=vs_whole,
                vs_whole_call_bf16_steps=steps,
                plain_halves_vs_plain_whole=plain_err, **yard)
    splits = acc.shape[2]
    seen_hi = int(ok[0, 0, half:].sum())
    part_out = 4.0 * b * (splits // 2) * h * (dv + 2)
    t_part = time_all(partial, lambda: ref.cache_attention_partial_ref(
        q, *cuts[1], **args))
    t_part["bound_ms"], t_part["bound_by"] = bound(
        2.0 * b * h * seen_hi * (d + dv),
        2.0 * b * h * d + 4.0 * b * half + b * kvh * seen_hi * (d + dv) * es
        + part_out, "bfloat16")
    t_part.update(max_abs_err=yard["max_abs_err"], shape=(
        f"q({b},1,{h},{d}) bf16 over slots {half}..{cap - 1} ({seen_hi} "
        f"visible), {splits // 2} splits of partials out"))
    t_comb = time_all(combine, lambda: ref.decode_combine_ref(
        acc, ml, torch.bfloat16))
    t_comb["bound_ms"], t_comb["bound_by"] = bound(
        3.0 * b * splits * h * dv, 4.0 * b * splits * h * (dv + 2)
        + 2.0 * b * h * dv, "float32")
    t_comb.update(max_abs_err=yard["max_abs_err"], shape=(
        f"partials of {splits} splits (two halves) x {h} heads x {dv} "
        f"float32 -> o ({b},1,{h},{dv}) bf16"))
    emit({"phase": 1, "extra": f"{what} flash_decode over two slot halves "
          f"+ combine", **comp, "partial": t_part, "combine": t_comb})
    return comp, t_part, t_comb


def phase1_decode_halves(gen, dev):
    """Row 1h: ``decode_halves`` at row 1q's shape (Qwen3-4B: q
    (2,1,32,128) bf16 over 32,896 slots of 8 KV heads x 128, 32,769
    positions), as each rank of phase 18's (1, 2) mesh holds its half.
    Returns the kernels line's rows ``flash_decode_partial`` (one half's
    call: the rank's work) and ``decode_combine`` (the merge of both
    halves' splits), each carrying the composition as ``"halves"``."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(MODEL14)
    cap = -(-(32_768 + 128) // 16) * 16
    comp, t_part, t_comb = decode_halves(
        gen, dev, "1h", 2, cap, 32_769, cfg.num_kv_heads, cfg.num_heads,
        cfg.hd, 0, torch.bfloat16)
    t_part["halves"] = t_comb["halves"] = comp
    return {"flash_decode_partial": t_part, "decode_combine": t_comb}


def phase1_mesh_halves(gen, dev):
    """Rows 1h-a..1h-f: ``decode_halves`` at the shapes of phase 19's and
    20's decode caches, each rank one half: Qwen1.5-32B's e4m3 cache (40
    heads on 40 KV heads, 2 x 16,448 slots), Mixtral's ring (32 heads on 8
    KV heads, 2 x 2,048 slots of a 4096 window), RecurrentGemma's ring (16
    heads on one KV head at 256, 2 x 1,024 slots of a 2048 window) at batch
    2, and DeepSeek-V2-Lite's latent expanded to every head (16 on 16, K
    192, V 128 — V narrower than K — over 2 x 16,448 slots), Whisper's
    decoder cache (20 heads on 20 KV heads x 64: a group of one) and
    InternVL2's (16 heads on 8 KV heads x 128), each over 2 x 16,448
    slots, at batch 1. Returns {key: the composition, with the second
    half's partial and the combine beside it}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cap = -(-(32_768 + 128) // 16) * 16
    qw, mix, rg, ds, wh, iv = (get_config(m) for m in (
        "qwen1.5-32b", MODEL6, MODEL8, MODEL14B, MODEL11, MODEL10))
    m = ds.mla
    rows = {}
    for key, args in (
            ("mesh_fp8", (2, cap, 32_769, qw.num_kv_heads, qw.num_heads,
                          qw.hd, 0, torch.float8_e4m3fn)),
            ("mesh_ring", (2, mix.sliding_window, 34_000, mix.num_kv_heads,
                           mix.num_heads, mix.hd, mix.sliding_window,
                           torch.bfloat16)),
            ("mesh_rg", (2, rg.sliding_window, 34_000, rg.num_kv_heads,
                         rg.num_heads, rg.hd, rg.sliding_window,
                         torch.bfloat16)),
            ("mesh_mla", (1, cap, 32_769, ds.num_heads, ds.num_heads,
                          m.qk_nope_head_dim + m.qk_rope_head_dim, 0,
                          torch.bfloat16)),
            ("mesh_encdec", (1, cap, 32_769, wh.num_kv_heads, wh.num_heads,
                             wh.hd, 0, torch.bfloat16)),
            ("mesh_vlm", (1, cap, 32_769, iv.num_kv_heads, iv.num_heads,
                          iv.hd, 0, torch.bfloat16))):
        kw = dict(dv=m.v_head_dim, scale=L._mla_scale(ds)) \
            if key == "mesh_mla" else {}
        comp, t_part, t_comb = decode_halves(gen, dev, key, *args, **kw)
        comp["partial"], comp["combine"] = (
            {k: t[k] for k in ("shape", "ms", "device_ms", "host_us",
                               "bound_ms", "bound_by")}
            for t in (t_part, t_comb))
        rows[key] = comp
    return rows


# --------------------------------------------------------------------------- #
# phase 2: path parity, card (kernels) against CPU (plain versions)
# --------------------------------------------------------------------------- #
def run_path(cfg, params, dev, prompt, frames=None):
    """Prefill, chunked prefill and PARITY_STEPS greedy paged decode steps
    of one request: the decode starts from the prefill's KV re-paged into
    pools and its recurrent states (a hybrid's) or memory rows (an
    enc-dec model's, after ``frames`` through the encoder; the chunks'
    caches are seeded from a second encoder run) copied into the paged
    caches' one slot. Returns (list of logits rows as float32 CPU
    tensors, greedy tokens)."""
    import torch
    from repro_torch.core.disagg import _repage_pool
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving.paged_cache import KVPageSpec
    s = len(prompt)
    toks = torch.tensor(prompt, dtype=torch.int32, device=dev)[None]
    inputs, mem = {"tokens": toks}, 0
    if frames is not None:
        inputs["frames"] = torch.as_tensor(frames, device=dev)[None]
        mem = len(frames)
    last, caches = M.prefill(params, cfg, inputs,
                             M.init_caches(cfg, 1, s, device=dev,
                                           mem_len=mem))
    rows = [last[0].float().cpu()]
    steps, chunk = PARITY_STEPS, PARITY_CHUNK
    cap = -(-s // chunk) * chunk
    dense = M.init_caches(cfg, 1, cap, full_capacity=True, device=dev,
                          mem_len=mem)
    if frames is not None:
        memory = M.encode(params, cfg, inputs["frames"])
        M.seed_cross(dense, M.encoder_cross_kv(params, cfg, memory), mem)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        logits, dense = M.decode_step(
            params, cfg, toks[:, c0:c1],
            torch.arange(c0, c1, device=dev)[None], dense, q_offset=c0,
            mem_len=mem or None)
    rows.append(logits[0, -1].float().cpu())
    bs = 32
    spec = KVPageSpec(bs, "nbhd", cfg.compute_dtype, cfg.num_kv_heads, cfg.hd)
    nb = -(-(s + steps) // bs)
    pools = M.init_paged_caches(cfg, {"kv": spec}, nb + 2, batch=1,
                                device=dev, mem_len=mem)
    blocks = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
    for cg, pg in zip(caches, pools):
        for c, dst in zip(cg, pg):
            if not isinstance(dst, dict):          # a recurrent state
                L.state_put(dst, c)
                continue
            for name, src in (("k_pool", c.k), ("v_pool", c.v)):
                _repage_pool(spec, dst[name], blocks, src[:, 0, :s], 0,
                             front=0, rmw=False)
            for name in ("cross_k", "cross_v", "mem_len") if mem else ():
                dst[name][:, 0] = getattr(c, name)[:, 0]
    tok = int(torch.argmax(rows[0]))
    out = [tok]
    for step in range(steps):
        pos = s + step
        lens = torch.tensor([pos], dtype=torch.int32, device=dev)
        logits, pools = M.decode_step_paged(
            params, cfg, torch.tensor([[tok]], dtype=torch.int32, device=dev),
            lens, blocks[None], blocks[pos // bs:pos // bs + 1],
            torch.tensor([pos % bs], dtype=torch.int32, device=dev), pools,
            {"kv": spec})
        rows.append(logits[0, 0].float().cpu())
        tok = int(torch.argmax(rows[-1]))
        out.append(tok)
    return rows, out


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree.to(dev)


def param_billions(tree) -> float:
    """Parameters in the tensors of a weight tree, in billions."""
    if isinstance(tree, dict):
        return sum(param_billions(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(param_billions(v) for v in tree)
    return tree.numel() / 1e9


def phase2(dev, model=MODEL, layers=PARITY_LAYERS, phase=2):
    """Path parity of ``model`` at full width cut to ``layers`` layers (an
    enc-dec model: ``layers`` encoder and ``layers`` decoder layers, and
    the request has its full memory of frames, unit normal, from SEED's
    generator after the prompt) in float32 with TF32 off: one
    PARITY_PROMPT-token request through ``run_path`` on the card (the
    kernels) and on the CPU (the plain versions); logits within
    PARITY_ATOL, the greedy tokens identical."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False      # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(model).with_(num_layers=layers, param_dtype="float32",
                                  compute_dtype="float32")
    if cfg.is_enc_dec:
        cfg = cfg.with_(encoder_layers=layers)
    params = M.init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, PARITY_PROMPT).astype(
        np.int32).tolist()
    frames = rng.normal(size=(cfg.max_source_len, cfg.d_model)).astype(
        np.float32) if cfg.is_enc_dec else None
    t0 = time.perf_counter()
    rows_dev, toks_dev = run_path(cfg, params, dev, prompt, frames)
    t_dev = time.perf_counter() - t0
    cpu_params = tree_to(params, "cpu")
    del params
    t0 = time.perf_counter()
    rows_cpu, toks_cpu = run_path(cfg, cpu_params, torch.device("cpu"),
                                  prompt, frames)
    t_cpu = time.perf_counter() - t0
    err = max((a - b).abs().max().item() for a, b in zip(rows_dev, rows_cpu))
    finite = all(bool(torch.isfinite(r).all()) for r in rows_dev)
    result = {"phase": phase, "parity": True,
              "model": f"{cfg.name} x{cfg.num_layers} layers "
              f"{cfg.compute_dtype}", "encoder_layers": cfg.encoder_layers,
              "frames": 0 if frames is None else len(frames),
              "prompt": PARITY_PROMPT,
              "logits_max_abs_err": err, "atol": PARITY_ATOL, "tf32": False,
              "tokens_device": toks_dev, "tokens_cpu": toks_cpu,
              "device_s": round(t_dev, 3), "cpu_s": round(t_cpu, 3)}
    emit(result)
    if not finite or not err <= PARITY_ATOL:
        raise AssertionError(f"path parity: logits differ by {err} > "
                             f"{PARITY_ATOL}")
    if toks_dev != toks_cpu or len(toks_dev) != PARITY_STEPS + 1:
        raise AssertionError(f"path parity: tokens {toks_dev} != {toks_cpu}")
    return result


# --------------------------------------------------------------------------- #
# phase 3: the main path at full width
# --------------------------------------------------------------------------- #
PHASE3_KERNELS = {"flash_attention", "paged_attention",
                  "scatter_pages_overlay"}
PHASE4_KERNELS = PHASE3_KERNELS | {"gather_pages", "scatter_pages", "repack"}


def one_row_chunks(lens, chunk: int) -> int:
    """Prefill chunks of exactly one row among streams of ``lens``
    positions in ``chunk``-position chunks from position 0 (a stream no
    longer than one chunk computes in one pass): ``attention_decode``
    sends each one's self-attention to flash_decode."""
    return sum(1 for n in lens if n > chunk and n % chunk == 1)


def check_launched(phase: int, launches, expected) -> None:
    """The path launched exactly the kernels it runs, each at least once."""
    launched = {k for k, n in launches.items() if n > 0}
    if launched != set(expected):
        raise AssertionError(f"phase {phase}: kernels launched {launched}, "
                             f"the path runs {set(expected)}")


def prefill_last(params, cfg, dev, tokens, patches=None, frames=None):
    """The last position's logits (V,) of a monolithic prefill of
    ``tokens``, after ``patches`` (P, d) when given (a vision request),
    beside ``frames`` (F, d) when given (an enc-dec request)."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    inputs = {"tokens": torch.as_tensor(np.asarray(tokens, np.int32),
                                        device=dev)[None]}
    n = len(tokens)
    if patches is not None:
        inputs["patches"] = torch.as_tensor(patches, device=dev)[None]
        n += len(patches)
    if frames is not None:
        inputs["frames"] = torch.as_tensor(frames, device=dev)[None]
    last, _ = M.prefill(params, cfg, inputs, M.init_caches(
        cfg, 1, n, device=dev,
        mem_len=0 if frames is None else len(frames)))
    return last[0]


def last_token_gap(cfg, params, dev, reqs) -> float:
    """Each request's last token against a monolithic prefill of its
    patches (if any), prompt and output[:-1] (beside its frames, if any):
    the decoded token must be
    (within bf16 noise) the prefill's top choice, and the logits finite.
    Returns the worst gap."""
    import numpy as np
    import torch
    worst = 0.0
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.output_tokens[:-1],
                                                   np.int32)])
        last = prefill_last(params, cfg, dev, seq, r.patches, r.frames)
        last = last.float()
        if not bool(torch.isfinite(last).all()):
            raise AssertionError(f"{r.req_id}: non-finite logits")
        gap = float(last.max() - last[r.output_tokens[-1]])
        worst = max(worst, gap)
        if gap > LOGIT_SLACK:
            raise AssertionError(f"{r.req_id}: decoded token {r.output_tokens[-1]}"
                                 f" is {gap} below the prefill's best logit")
    return worst


def first_token_yardstick(cfg, params, dev, prompts, reqs,
                          gate: bool = True):
    """Each request's served first token against a float32 prefill of its
    patches (if any) and prompt (beside its frames, if any; params upcast
    with ``.float()``, which takes the float32 flash kernel): its float32
    logit must be within LOGIT_SLACK of the float32 maximum, whatever
    order bf16 summed in (``gate=False``: the gaps only measured).
    Returns the worst gap and the largest |bf16 - f32| of the
    last-position logits of ``M.prefill`` in bf16. The float32 copy of
    the weights (27 GB at llama2-7b) is freed before the return."""
    import torch
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    params32 = tree_to(params, torch.float32)
    gap_max = err_max = 0.0
    for prompt, r in zip(prompts, reqs):
        l16 = prefill_last(params, cfg, dev, prompt, r.patches,
                           r.frames).float()
        l32 = prefill_last(params32, cfg32, dev, prompt, r.patches,
                           r.frames).float()
        if not bool(torch.isfinite(l32).all()):
            raise AssertionError(f"{r.req_id}: non-finite float32 logits")
        gap = float(l32.max() - l32[r.output_tokens[0]])
        gap_max = max(gap_max, gap)
        err_max = max(err_max, float((l16 - l32).abs().max()))
        if gate and gap > LOGIT_SLACK:
            raise AssertionError(f"{r.req_id}: first token {r.output_tokens[0]}"
                                 f" is {gap} below the float32 prefill's "
                                 "best logit")
    del params32
    torch.cuda.empty_cache()
    return gap_max, err_max


def moe_first_token_yardstick(cfg, params, dev, prompts, reqs,
                              gate: bool = True):
    """The first-token yardstick of an MoE model. Top-k routing is
    discrete: where a token's k-th and (k+1)-th router logits lie closer
    than bf16's rounding moves them, bf16 and float32 pick different
    experts and the token's MLP output changes wholesale, so a float32
    prefill on its own routing can sit far from any bf16 run, however
    exact. So three prefills of each prompt run layer by layer in
    lockstep: bf16; float32 on the bf16 prefill's expert choices (their
    weights renormalised from the float32 router's probabilities); and
    float32 on its own routing. The served first token must be within
    LOGIT_SLACK of the best logit of the second (the gate); the third's
    gap, the layers at which the last token's choices differ, the share
    of all (token, layer) choices where the float32 router disagrees with
    the bf16 one, and the widest float32 router margin among those
    disagreements are printed beside it. The weights stay bf16: each
    product casts its weight to float32 at the call, one weight at a time
    (a float32 copy of 24 Mixtral layers would be 139 GB). Attention is the
    model's own (``M.attention_full``: windowed GQA, or MLA through flash
    at dk 192, the float32 kernel for the float32 prefills)."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    cfgs = (cfg, cfg32, cfg32)
    rows = []
    for prompt, r in zip(prompts, reqs):
        toks = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
        pos = torch.arange(toks.shape[1], device=dev)[None]
        xs = [M.embed_tokens(params, c, toks) for c in cfgs]
        last_flips, flipped, decisions, margin = [], 0, 0, 0.0
        for layer, (_, _, _, _, g, p) in enumerate(M._layers(params, cfg)):
            hs = []
            for j, c in enumerate(cfgs):
                h = L.rms_norm(p["norm1"], xs[j], c.norm_eps)
                out, _ = M.attention_full(p["attn"], c, h, pos)
                xs[j] = xs[j] + out
                hs.append(L.rms_norm(p["norm2"], xs[j], c.norm_eps)[0])
            if not g.moe:
                xs = [x + L.swiglu_mlp(p["mlp"], h)[None]
                      for x, h in zip(xs, hs)]
                continue
            w16, i16 = L.moe_route(p["mlp"], cfg, hs[0])
            logits32 = hs[1].float() @ p["mlp"]["router"].float()
            w_on16 = torch.softmax(logits32, -1).gather(-1, i16)
            w_on16 = w_on16 / w_on16.sum(-1, keepdim=True)
            i32 = torch.topk(logits32, cfg.moe.top_k, -1).indices
            differ = (i16.sort(-1).values != i32.sort(-1).values).any(-1)
            flipped += int(differ.sum())
            decisions += differ.numel()
            if bool(differ.any()):
                kth = logits32.gather(-1, i32).min(-1).values
                low = logits32.gather(-1, i16).min(-1).values
                margin = max(margin, float((kth - low)[differ].max()))
            if bool(differ[-1]):
                last_flips.append(layer)
            w_own, i_own = L.moe_route(p["mlp"], cfg32, hs[2])
            xs[0] = xs[0] + L.moe_experts(p["mlp"], cfg, hs[0], w16, i16)[None]
            xs[1] = xs[1] + L.moe_experts(p["mlp"], cfg32, hs[1], w_on16,
                                          i16)[None]
            xs[2] = xs[2] + L.moe_experts(p["mlp"], cfg32, hs[2], w_own,
                                          i_own)[None]
        l16, l32, own = (M.lm_logits(params, c, x[:, -1])[0].float()
                         for c, x in zip(cfgs, xs))
        if not bool(torch.isfinite(l32).all()):
            raise AssertionError(f"{r.req_id}: non-finite float32 logits")
        tok = r.output_tokens[0]
        rows.append({"req": r.req_id, "gap": float(l32.max() - l32[tok]),
                     "gap_own_routing": float(own.max() - own[tok]),
                     "gap_bf16": float(l16.max() - l16[tok]),
                     "served_is_bf16_argmax": int(l16.argmax()) == tok,
                     "bf16_vs_f32_max_abs": float((l16 - l32).abs().max()),
                     "last_token_choice_differs_at_layers": last_flips,
                     "choices_differing": flipped / decisions,
                     "widest_f32_margin_of_a_difference": margin})
        del xs, hs
    worst = max(rows, key=lambda row: row["gap"])
    if gate and worst["gap"] > LOGIT_SLACK:
        raise AssertionError(f"{worst['req']}: first token is {worst['gap']} "
                             "below the best logit of the float32 prefill on "
                             "the bf16 routing")
    torch.cuda.empty_cache()
    return rows


def tokens_digest(reqs) -> str:
    """sha256 of every request's output tokens, in request order: two runs
    gave the same tokens where their digests agree."""
    h = hashlib.sha256()
    for r in reqs:
        h.update(repr([int(t) for t in r.output_tokens]).encode())
    return h.hexdigest()[:16]


def check_outputs(cfg, reqs) -> None:
    for r in reqs:
        if len(r.output_tokens) != MAX_NEW or r.state.value != "finished":
            raise AssertionError(f"{r.req_id}: {len(r.output_tokens)} tokens, "
                                 f"state {r.state}")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"{r.req_id}: token out of range")


def phase3(dev, around_serve=contextlib.nullcontext, params=None):
    """``around_serve``: a context manager entered around the serving loop
    only (a profiler, say), not around set-up or the checks. ``params``:
    llama2-7b's weights, made from SEED when not given."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.core.kv_transfer import TransferEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, VendorProfile
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import GlobalScheduler
    from repro_torch.serving.server import Server

    cfg = get_config(MODEL)
    p_vendor, d_vendor = VendorProfile(**P_VENDOR), VendorProfile(**D_VENDOR)
    t0 = time.perf_counter()
    if params is None:
        params = M.init_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    max_seq = PROMPT_RANGE[1] + MAX_NEW
    d_blocks = N_REQUESTS * -(-max_seq // d_vendor.block_size) + 1
    p_eng = Engine("P0", cfg, params, p_vendor, num_blocks=2, max_batch=1,
                   max_seq_len=max_seq, role="prefill", device=dev)
    d_eng = Engine("D0", cfg, params, d_vendor, num_blocks=d_blocks,
                   max_batch=N_REQUESTS, max_seq_len=max_seq, role="decode",
                   device=dev)
    pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "bfloat16"))
    sched = GlobalScheduler(pipe, prefill_chunk=PREFILL_CHUNK, device=dev)
    sched.add_instance(p_eng)
    sched.add_instance(d_eng)
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), MAX_NEW) for i, n in enumerate(lens)]
    prompts = [r.prompt for r in reqs]
    setup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                      # count the main path only
    with around_serve():
        result = Server(sched).serve(reqs, max_ticks=100_000)
    launches = ops.launch_counts()

    check_outputs(cfg, reqs)
    if dev.type == "cuda":
        check_launched(3, launches, PHASE3_KERNELS)
    worst = last_token_gap(cfg, params, dev, reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else None
    gap32, err16 = first_token_yardstick(cfg, params, dev, prompts, reqs)
    ttft = result.ttft()
    tpot = result.tpot()
    out = {"phase": 3, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "requests": N_REQUESTS,
           "prompt_lens": [int(x) for x in lens], "max_new_tokens": MAX_NEW,
           "prefill_chunk": PREFILL_CHUNK,
           "p_vendor": dataclasses.asdict(p_vendor),
           "d_vendor": dataclasses.asdict(d_vendor),
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": result.throughput_tok_s(),
           "wall_s": result.wall_seconds, "setup_s": setup_s,
           "launches": launches,
           "prefill_tokens": p_eng.stats.prefill_tokens,
           "prefill_s": p_eng.stats.prefill_seconds,
           "decode_steps": d_eng.stats.decode_steps,
           "decode_s": d_eng.stats.decode_seconds,
           "wire_handoff_s": pipe.transfer.stats.wall_handoff_seconds,
           "chunks_streamed": sched.stats.chunks_streamed,
           "wire_bytes": pipe.transfer.stats.bytes_moved,
           "tokens_sha256": tokens_digest(reqs),
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err16}
    if peak is not None:
        out["peak_mem_gib"] = peak
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 4: the prefix-cache path at full width
# --------------------------------------------------------------------------- #
def serve_prefix_schedule(cfg, params, dev, prompts, prefix_cache: bool):
    """Serve request 0 alone, then the rest together, on fresh P and D
    engines (phase 3's vendors), with or without the prefix cache. Each
    batch gets its own GlobalScheduler over the same engines and pipeline
    (``Server.serve`` waits on its scheduler's running total of finished
    requests). Returns the requests, metrics and the launches counted
    over both batches."""
    import numpy as np
    import torch
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.core.kv_transfer import TransferEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, VendorProfile
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import GlobalScheduler
    from repro_torch.serving.server import ServeResult, Server

    max_seq = max(len(p) for p in prompts) + MAX_NEW
    d_vendor = VendorProfile(**D_VENDOR)
    d_blocks = len(prompts) * -(-max_seq // d_vendor.block_size) + 1
    p_eng = Engine("P0", cfg, params, VendorProfile(**P_VENDOR), num_blocks=2,
                   max_batch=1, max_seq_len=max_seq, role="prefill",
                   prefix_cache=prefix_cache, device=dev)
    d_eng = Engine("D0", cfg, params, d_vendor, num_blocks=d_blocks,
                   max_batch=len(prompts), max_seq_len=max_seq,
                   role="decode", prefix_cache=prefix_cache, device=dev)
    copies = {"host_insert_s": 0.0, "cow_copies": 0, "cow_s": 0.0}
    host = p_eng.host_prefix_store
    if host is not None:
        # the default 256 MiB holds 32 P blocks (512 tokens) at llama2-7b
        # width: LRU would evict the prompt's own head blocks
        host.capacity_bytes = HOST_STORE_BYTES
        insert = host.insert_prompt

        def timed_insert(*args):                  # device -> host copies
            torch.cuda.synchronize()              # not the queued prefill
            t = time.perf_counter()
            n = insert(*args)
            copies["host_insert_s"] += time.perf_counter() - t
            return n

        host.insert_prompt = timed_insert
        copy_block = d_eng._copy_block

        def timed_copy(src, dst):                 # the COW repack pair
            torch.cuda.synchronize()
            t = time.perf_counter()
            copy_block(src, dst)
            torch.cuda.synchronize()
            copies["cow_s"] += time.perf_counter() - t
            copies["cow_copies"] += 1

        d_eng._copy_block = timed_copy
    pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "bfloat16"))
    reqs = [Request(f"req{i}", p, MAX_NEW) for i, p in enumerate(prompts)]
    walls = []
    ops.reset_launch_counts()
    for batch in (reqs[:1], reqs[1:]):
        sched = GlobalScheduler(pipe, prefill_chunk=PREFILL_CHUNK, device=dev)
        sched.add_instance(p_eng)
        sched.add_instance(d_eng)
        walls.append(Server(sched).serve(batch, max_ticks=100_000)
                     .wall_seconds)
    launches = ops.launch_counts()
    result = ServeResult(reqs, sum(walls))
    ttft, tpot = result.ttft(), result.tpot()
    tr = pipe.transfer.stats
    out = {"ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": result.throughput_tok_s(),
           "wall_s": result.wall_seconds, "wire_bytes": tr.bytes_moved,
           "prefill_tokens": p_eng.stats.prefill_tokens,
           "prefill_s": p_eng.stats.prefill_seconds,
           "decode_s": d_eng.stats.decode_seconds,
           "prefix_hit_tokens": tr.prefix_hit_tokens,
           "bytes_saved": tr.bytes_saved,
           "prefix_cached_tokens": p_eng.stats.prefix_cached_tokens,
           "host_store_bytes": host.nbytes if host is not None else 0,
           "d_store_hit_tokens": (d_eng.prefix_store.hit_tokens
                                  if d_eng.prefix_store is not None else 0),
           **copies}
    if host is not None and copies["host_insert_s"] > 0:
        out["host_insert_gb_s"] = host.nbytes / copies["host_insert_s"] / 1e9
    return reqs, out, launches


def phase4(dev, params):
    """llama2-7b at full width with the prefix cache on both engines: one
    PREFIX_LEN-token system prompt shared by N_REQUESTS requests with
    unique tails, cached against cold."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(MODEL)
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).astype(np.int32)
    tails = rng.integers(TAIL_RANGE[0], TAIL_RANGE[1] + 1, N_REQUESTS)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, int(n))
                               .astype(np.int32)]) for n in tails]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs, cached, launches = serve_prefix_schedule(cfg, params, dev, prompts,
                                                   True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_outputs(cfg, reqs)
    check_launched(4, launches, PHASE4_KERNELS)
    hits = N_REQUESTS - 1
    want = {"prefix_hit_tokens": hits * PREFIX_LEN,
            "d_store_hit_tokens": hits * PREFIX_LEN,
            "prefix_cached_tokens": hits * (PREFIX_LEN // P_VENDOR[
                "block_size"] * P_VENDOR["block_size"])}
    for key, least in want.items():
        if cached[key] < least:
            raise AssertionError(f"phase 4: {key} {cached[key]} < {least}")
    for name in ("gather_pages", "scatter_pages", "repack"):
        if launches[name] < 2 * hits:          # one COW per pool per request
            raise AssertionError(f"phase 4: {name} launched "
                                 f"{launches[name]} < {2 * hits} times")
    worst = last_token_gap(cfg, params, dev, reqs)
    torch.cuda.empty_cache()
    cold_reqs, cold, _ = serve_prefix_schedule(cfg, params, dev, prompts,
                                               False)
    check_outputs(cfg, cold_reqs)
    same = sum(a.output_tokens == b.output_tokens
               for a, b in zip(reqs, cold_reqs))
    out = {"phase": 4, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "prefix_len": PREFIX_LEN,
           "tail_lens": [int(x) for x in tails], "max_new_tokens": MAX_NEW,
           "prefill_chunk": PREFILL_CHUNK, "cached": cached, "cold": cold,
           "launches": launches, "tokens_identical_to_cold": same,
           "tokens_sha256": {"cached": tokens_digest(reqs),
                             "cold": tokens_digest(cold_reqs)},
           "last_token_logit_gap_max": worst, "peak_mem_gib": peak}
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 5: the cross-process runtime at full width
# --------------------------------------------------------------------------- #
def segments_left(names) -> list:
    """The shared-memory segments of ``names`` that are still linked."""
    return sorted(n for n in names if Path("/dev/shm", n).exists())


def phase5(dev, params):
    """Phase 3's requests through ``TwoProcessRuntime``: P and D engines
    in spawned worker processes on the card, each building its own
    weights from SEED, the KV over shm segments. ``params``: the parent's
    copy of the same weights, for the checks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.serving.engine import VendorProfile
    from repro_torch.serving.multiproc import EngineSpec, TwoProcessRuntime
    from repro_torch.serving.request import Request
    from repro_torch.serving.server import ServeResult

    cfg = get_config(MODEL)
    p_vendor, d_vendor = VendorProfile(**P_VENDOR), VendorProfile(**D_VENDOR)
    rng = np.random.default_rng(SEED)                 # phase 3's draws
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    max_seq = PROMPT_RANGE[1] + MAX_NEW
    d_blocks = N_REQUESTS * -(-max_seq // d_vendor.block_size) + 1
    on = None if dev.type == "cuda" else "cpu"   # None: the card
    p_spec = EngineSpec("P0", cfg, p_vendor, params_seed=SEED, num_blocks=2,
                        max_batch=1, max_seq_len=max_seq, role="prefill",
                        device=on)
    d_spec = EngineSpec("D0", cfg, d_vendor, params_seed=SEED,
                        num_blocks=d_blocks, max_batch=N_REQUESTS,
                        max_seq_len=max_seq, role="decode", device=on)
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), MAX_NEW) for i, n in enumerate(lens)]
    prompts = [r.prompt.copy() for r in reqs]
    rt = TwoProcessRuntime(p_spec, d_spec, wire=WireFormat("raw", "bfloat16"),
                           prefill_chunk=PREFILL_CHUNK)
    try:
        t0 = time.perf_counter()
        rt.start(spawn_timeout_s=300.0)
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.serve(reqs, max_wall_s=600.0)
        wall = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = segments_left(rt.segments_seen)
    launches = {}
    for counts in rt.worker_launches.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    check_outputs(cfg, reqs)
    # a P-side failure (PrefillFailed) is requeued and may be retried to a
    # good end: requeues and failures count as faults here too
    if (rt.stream_failures or sum(rt.crashes.values())
            or rt.stats.requeues or rt.stats.failed):
        raise AssertionError(f"phase 5: stream failures {rt.stream_failures},"
                             f" crashes {rt.crashes}, requeues "
                             f"{rt.stats.requeues}, failed {rt.stats.failed}")
    if set(rt.worker_launches) != {"P0", "D0"}:
        raise AssertionError(f"phase 5: launch counts from "
                             f"{sorted(rt.worker_launches)}, not P0 and D0")
    if dev.type == "cuda":
        check_launched(5, launches, PHASE3_KERNELS)
    if not rt.segments_seen or left:
        raise AssertionError(f"phase 5: {len(rt.segments_seen)} segments "
                             f"seen, {left} left after shutdown")
    worst = last_token_gap(cfg, params, dev, reqs)
    gap32, err16 = first_token_yardstick(cfg, params, dev, prompts, reqs)
    result = ServeResult(reqs, wall)
    ttft, tpot = result.ttft(), result.tpot()
    tr = rt.transfer_stats
    out = {"phase": 5, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "runtime": "TwoProcessRuntime",
           "connector": "shm", "requests": N_REQUESTS,
           "prompt_lens": [int(x) for x in lens], "max_new_tokens": MAX_NEW,
           "prefill_chunk": PREFILL_CHUNK,
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": result.throughput_tok_s(),
           "wall_s": wall, "spawn_to_hello_s": spawn_s,
           "worker_pids": rt.worker_pids, "parent_pid": os.getpid(),
           "launches": launches, "worker_launches": rt.worker_launches,
           "wire_bytes": tr.bytes_moved, "wire_transfers": tr.transfers,
           "chunks_streamed": rt.stats.chunks_streamed,
           "requeues": rt.stats.requeues, "failed": rt.stats.failed,
           "wall_handoff_s": tr.wall_handoff_seconds,
           "wall_overlap_s": tr.wall_overlap_seconds,
           "segments_seen": len(rt.segments_seen),
           "segments_left": len(left),
           "prefill_s": rt.worker_stats["P0"]["prefill_seconds"],
           "decode_steps": rt.worker_stats["D0"]["decode_steps"],
           "decode_s": rt.worker_stats["D0"]["decode_seconds"],
           "tokens_sha256": tokens_digest(reqs),
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err16}
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 6: sliding window + MoE (Mixtral-8x7B) at full width
# --------------------------------------------------------------------------- #
def wire_plan(lens, window, chunk):
    """What the floors predict for incremental streams of ``lens``: per
    request the positions shipped, the shipped chunks' (start, length) and
    the compute chunks wholly below the floor (progress markers)."""
    out = []
    for n in lens:
        floor, sent, ships, markers = max(0, n - window), 0, [], 0
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            w0 = max(sent, floor)
            if c1 <= w0:
                markers += 1
                continue
            ships.append((w0, c1 - w0))
            sent = c1
        out.append({"positions": sum(ln for _, ln in ships),
                    "chunks": ships, "markers": markers})
    return out


def serve_long_prompts(phase, cfg, p_vendor, dev, around_serve, kernels,
                       make_reqs=None, prefix_cache=False,
                       chunk=PREFILL_CHUNK):
    """The serving run phases 6-11 share: ``cfg`` in bf16 with random
    weights from SEED, phase 6's eight prompts (MAX_NEW greedy tokens
    each; or the requests ``make_reqs(cfg)`` returns) served by one P
    (``p_vendor``) and phase 3's D over a raw bf16 wire in ``chunk``-token
    chunks, both engines with a prefix cache when ``prefix_cache``. The
    launch counts are set to 0 just before the serving loop and read just
    after; every request must finish and
    exactly ``kernels`` must launch. Returns the run: weights, requests,
    engines, pipe, scheduler, the positions each request shipped, the
    bytes staged under each wire key, the server's result, launches and
    the loop's peak memory."""
    import collections
    import types
    import numpy as np
    import torch
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.disagg import DisaggPipeline
    from repro_torch.core.kv_transfer import TransferEngine
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, VendorProfile
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import GlobalScheduler
    from repro_torch.serving.server import Server

    d_vendor = VendorProfile(**D_VENDOR)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    params_gib = torch.cuda.memory_allocated() / 2 ** 30
    if make_reqs is None:
        rng = np.random.default_rng(SEED)
        reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), MAX_NEW)
                for i, n in enumerate(PHASE6_PROMPTS)]
    else:
        reqs = make_reqs(cfg)
    prompts = [r.prompt.copy() for r in reqs]
    seqs = [r.prompt_len + r.num_patches for r in reqs]
    max_seq = max(seqs) + MAX_NEW
    bs = d_vendor.block_size
    d_blocks = sum(-(-(n + MAX_NEW) // bs) for n in seqs) + 1
    p_eng = Engine("P0", cfg, params, p_vendor, num_blocks=2, max_batch=1,
                   max_seq_len=max_seq, role="prefill",
                   prefix_cache=prefix_cache, device=dev)
    d_eng = Engine("D0", cfg, params, d_vendor, num_blocks=d_blocks,
                   max_batch=len(reqs), max_seq_len=max_seq, role="decode",
                   prefix_cache=prefix_cache, device=dev)
    wire = WireFormat("raw", "bfloat16")
    pipe = DisaggPipeline(TransferEngine(), wire)
    staged = {}
    stage = pipe.transfer.stage

    def counted_stage(key, payload, meta=None):   # bytes under each key
        staged[key] = stage(key, payload, meta)
        return staged[key]
    pipe.transfer.stage = counted_stage
    shipped = collections.Counter()
    begin = pipe.begin_handoff

    def counted_begin(req, *a, **kw):        # positions each request ships
        h = begin(req, *a, **kw)
        send = h.send_chunk

        def send_chunk(chunk):
            shipped[req.req_id] += chunk["length"]
            return send(chunk)
        h.send_chunk = send_chunk
        return h
    pipe.begin_handoff = counted_begin
    sched = GlobalScheduler(pipe, prefill_chunk=chunk, device=dev)
    sched.add_instance(p_eng)
    sched.add_instance(d_eng)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                      # count this path only
    with around_serve():
        result = Server(sched).serve(reqs, max_ticks=100_000)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    check_outputs(cfg, reqs)
    check_launched(phase, launches, kernels)
    return types.SimpleNamespace(
        params=params, params_gib=params_gib, setup_s=setup_s, reqs=reqs,
        prompts=prompts, p_vendor=p_vendor, d_vendor=d_vendor, wire=wire,
        p_eng=p_eng, d_eng=d_eng, pipe=pipe, sched=sched, shipped=shipped,
        staged=staged, result=result, launches=launches, peak=peak,
        chunk=chunk)


def serving_report(run) -> dict:
    """The keys of the phase line that phases 6-11 share: the traffic, the
    vendors, TTFT/TPOT/tok/s, memory, launches, P's and D's times and the
    wire's."""
    import numpy as np
    ttft, tpot = run.result.ttft(), run.result.tpot()
    p, d = run.p_eng.stats, run.d_eng.stats
    st = run.pipe.transfer.stats
    return {"requests": len(run.reqs),
            "prompt_lens": [r.prompt_len for r in run.reqs],
            "patches": [r.num_patches for r in run.reqs],
            "max_new_tokens": MAX_NEW, "prefill_chunk": run.chunk,
            "p_vendor": dataclasses.asdict(run.p_vendor),
            "d_vendor": dataclasses.asdict(run.d_vendor),
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_max_s": float(ttft.max()),
            "tpot_p50_s": float(np.percentile(tpot, 50)),
            "output_tok_s": run.result.throughput_tok_s(),
            "wall_s": run.result.wall_seconds, "setup_s": run.setup_s,
            "params_gib": run.params_gib, "peak_mem_gib": run.peak,
            "launches": run.launches,
            "prefill_tokens": p.prefill_tokens,
            "prefill_chunks": p.prefill_chunks,
            "prefill_s": p.prefill_seconds,
            "p_ms_per_chunk": 1e3 * p.prefill_seconds
                / max(p.prefill_chunks, 1),
            "decode_steps": d.decode_steps, "decode_s": d.decode_seconds,
            "d_ms_per_step": 1e3 * d.decode_seconds / max(d.decode_steps, 1),
            "chunks_streamed": run.sched.stats.chunks_streamed,
            "positions_shipped": [run.shipped[r.req_id] for r in run.reqs],
            "wire_bytes": st.bytes_moved,
            "wire_payload_bytes": st.payload_bytes,
            "wire_header_bytes": st.bytes_moved - st.payload_bytes,
            "wire_handoff_s": st.wall_handoff_seconds,
            "tokens_sha256": tokens_digest(run.reqs)}


def in_process_record(run) -> dict:
    """What phase 16 holds its cross-process run to (not printed): the
    bytes staged under each wire key and each request's tokens."""
    return {"staged": dict(run.staged),
            "tokens": {r.req_id: list(r.output_tokens) for r in run.reqs}}


def check_window_wire(phase, run, win):
    """Each request shipped min(len, window) positions, and P's chunks
    wholly below the floor were progress markers, as ``wire_plan``
    predicts. Returns the plan and the markers counted."""
    plan = wire_plan(PHASE6_PROMPTS, win, PREFILL_CHUNK)
    for r, n, pl in zip(run.reqs, PHASE6_PROMPTS, plan):
        if not run.shipped[r.req_id] == pl["positions"] == min(n, win):
            raise AssertionError(f"phase {phase}: {r.req_id} ({n} tokens) "
                                 f"shipped {run.shipped[r.req_id]} "
                                 f"positions, the floor says {min(n, win)}")
    markers = run.p_eng.stats.prefill_chunks - run.sched.stats.chunks_streamed
    want = sum(pl["markers"] for pl in plan)
    if markers != want:
        raise AssertionError(f"phase {phase}: {markers} progress markers, "
                             f"the floors predict {want}")
    return plan, markers


def kv_chunk_bytes(cfg, wire, tp, start, length):
    """A streamed chunk's bytes on ``wire``: one "kv" entry for each
    attention position of each layer group (a recurrent position ships
    no KV)."""
    import torch
    from repro_torch.configs.base import RECURRENT
    from repro_torch.core.transport.wirefmt import WireChunk
    from repro_torch.models import model as M
    ents = [("kv", gi, pi, {"k": meta, "v": meta, "start": start})
            for gi, g in enumerate(M.block_groups(cfg))
            for pi, kind in enumerate(g.kinds) if kind != RECURRENT
            for meta in [torch.empty((g.count, length, cfg.num_kv_heads,
                                      cfg.hd), dtype=torch.bfloat16,
                                     device="meta")]]
    return WireChunk.from_entries(ents, wire, tp, seq_len=length).nbytes


def phase6(dev, around_serve=contextlib.nullcontext):
    """Mixtral-8x7B at full width (24 of its 32 layers), bf16, random
    weights from SEED, served as phase 3 serves llama2-7b: the sliding
    window through flash (key tiles skipped), paged (splits from the
    floor's page) and the overlay (streams from a floor inside a page),
    and the MoE MLP's per-expert products. ``around_serve`` as in
    ``phase3``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import VendorProfile

    cfg = get_config(MODEL6).with_(num_layers=LAYERS6)
    win = cfg.sliding_window
    run = serve_long_prompts(6, cfg, VendorProfile(**P_VENDOR), dev,
                             around_serve, PHASE3_KERNELS)
    params, prompts = run.params, run.prompts
    # the wire: min(len, window) positions per request, the bytes and the
    # progress markers the floors predict
    plan, markers = check_window_wire(6, run, win)
    want_bytes = sum(kv_chunk_bytes(cfg, run.wire, run.p_vendor.tp, *c)
                     for pl in plan for c in pl["chunks"])
    got_bytes = run.pipe.transfer.stats.bytes_moved
    if got_bytes != want_bytes:
        raise AssertionError(f"phase 6: wire bytes {got_bytes}, the floors "
                             f"predict {want_bytes}")
    worst = last_token_gap(cfg, params, dev, run.reqs)
    yard = moe_first_token_yardstick(cfg, params, dev, prompts, run.reqs)
    # the window's effect on the last logits of the 8192-token prompt: an
    # observation, not a gate (the gate that the mask is applied is
    # phase 1's windowed paged row)
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    with_w, _ = M.prefill(params, cfg, {"tokens": toks},
                          M.init_caches(cfg, 1, len(prompts[0]), device=dev))
    full = cfg.with_(attention_kind="full")
    no_w, _ = M.prefill(params, full, {"tokens": toks},
                        M.init_caches(full, 1, len(prompts[0]), device=dev))
    effect = float((with_w.float() - no_w.float()).abs().max())
    out = {"phase": 6, "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": get_config(MODEL6).num_layers,
           "dtype": cfg.compute_dtype, "window": win,
           "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
           **serving_report(run),
           "peak_mem_gib_with_checks":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "progress_markers_skipped": markers,
           "wire_bytes_predicted": want_bytes,
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": max(y["gap"] for y in yard),
           "first_token_gap_f32_own_routing_max":
               max(y["gap_own_routing"] for y in yard),
           "last_logits_bf16_vs_f32_max_abs":
               max(y["bf16_vs_f32_max_abs"] for y in yard),
           "first_token_yardstick": yard,
           "window_effect_8192": effect}
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 7: MLA + MoE (DeepSeek-V2-Lite) at full width and depth
# --------------------------------------------------------------------------- #
def phase7(dev, around_serve=contextlib.nullcontext):
    """DeepSeek-V2-Lite at full width and all 27 layers, bf16, random
    weights from SEED, served as phase 3 serves llama2-7b to phase 6's
    prompts: prefill and every chunk through flash at dk 192 / dv 128, the
    latent wire (``"mla"`` entries) re-paged by the overlay into the D
    engine's two latent pools, and each decode step's latent pages
    gathered by the gather kernel. ``around_serve`` as in ``phase3``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transport.wirefmt import WireChunk
    from repro_torch.models import model as M
    from repro_torch.serving.engine import VendorProfile

    cfg = get_config(MODEL7)
    m = cfg.mla
    run = serve_long_prompts(7, cfg, VendorProfile(**P_VENDOR), dev,
                             around_serve, PHASE7_KERNELS)
    # the wire: every position of every prompt as latent rows, 500-token
    # chunks, two "mla" entries a chunk (the dense first layer, the 26 MoE
    # layers), each of two parts; the headers are what the codec adds
    groups = M.block_groups(cfg)
    per_token = cfg.num_layers * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    expanded = cfg.num_layers * 2 * cfg.num_heads * m.v_head_dim * 2

    def chunk_nbytes(start, length):
        ents = [("mla", gi, 0, {
            "ckv": torch.empty((g.count, length, m.kv_lora_rank),
                               dtype=torch.bfloat16, device="meta"),
            "kpe": torch.empty((g.count, length, m.qk_rope_head_dim),
                               dtype=torch.bfloat16, device="meta"),
            "start": start}) for gi, g in enumerate(groups)]
        return WireChunk.from_entries(ents, run.wire, run.p_vendor.tp,
                                      seq_len=length).nbytes

    chunks = [(c0, min(PREFILL_CHUNK, n - c0)) for n in PHASE6_PROMPTS
              for c0 in range(0, n, PREFILL_CHUNK)]
    want_payload = sum(PHASE6_PROMPTS) * per_token
    want_bytes = sum(chunk_nbytes(*c) for c in chunks)
    st = run.pipe.transfer.stats
    if st.payload_bytes != want_payload or st.bytes_moved != want_bytes:
        raise AssertionError(f"phase 7: wire payload {st.payload_bytes} / "
                             f"bytes {st.bytes_moved}, the latent says "
                             f"{want_payload} / {want_bytes}")
    if run.sched.stats.chunks_streamed != len(chunks):
        raise AssertionError(f"phase 7: {run.sched.stats.chunks_streamed} "
                             f"chunks streamed, {len(chunks)} expected")
    worst = last_token_gap(cfg, run.params, dev, run.reqs)
    yard = moe_first_token_yardstick(cfg, run.params, dev, run.prompts,
                                     run.reqs)
    out = {"phase": 7, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "heads": cfg.num_heads,
           "kv_lora_rank": m.kv_lora_rank,
           "qk_head_dim": m.qk_nope_head_dim + m.qk_rope_head_dim,
           "v_head_dim": m.v_head_dim, "experts": cfg.moe.num_experts,
           "top_k": cfg.moe.top_k, "shared": cfg.moe.num_shared_experts,
           "params_b": cfg.param_count() / 1e9,
           **serving_report(run),
           "peak_mem_gib_with_checks":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "latent_bytes_per_token": per_token,
           "expanded_kv_bytes_per_token": expanded,
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": max(y["gap"] for y in yard),
           "first_token_gap_f32_own_routing_max":
               max(y["gap_own_routing"] for y in yard),
           "last_logits_bf16_vs_f32_max_abs":
               max(y["bf16_vs_f32_max_abs"] for y in yard),
           "first_token_yardstick": yard}
    emit(out)
    return {**out, **in_process_record(run)}


# --------------------------------------------------------------------------- #
# phase 8: the hybrid RG-LRU family (RecurrentGemma-9B) at full width/depth
# --------------------------------------------------------------------------- #
def phase8(dev, around_serve=contextlib.nullcontext):
    """RecurrentGemma-9B at full width and all 38 layers, bf16, random
    weights from SEED, served to phase 6's prompts by a P at TP 1 and
    phase 3's D: every chunk's 12 local-attention layers through flash at
    dk = dv = 256 (16 heads on one KV head, window 2048) and the 26 RG-LRU
    layers carrying their states from chunk to chunk; the window floor on
    the wire and the overlay into D's pools; the states' tail placed into
    D's slot at finalize; paged decode at 16 heads x 256 (two blocks a
    group). ``around_serve`` as in ``phase3``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RECURRENT
    from repro_torch.models import model as M
    from repro_torch.serving.engine import VendorProfile

    t_phase = time.perf_counter()
    cfg = get_config(MODEL8)
    r = cfg.recurrent
    win = cfg.sliding_window
    run = serve_long_prompts(8, cfg, VendorProfile(**P_VENDOR8), dev,
                             around_serve, PHASE3_KERNELS)

    plan, markers = check_window_wire(8, run, win)
    # the wire: each chunk one "kv" entry (the 12 attention layers of the
    # first group; the second group has none), plus per request the tail
    # of every recurrent layer's h (float32) and conv tail (bf16)
    groups = M.block_groups(cfg)
    w = r.lru_width or cfg.d_model
    n_rec = sum(g.count * g.kinds.count(RECURRENT) for g in groups)
    tail_bytes = n_rec * (w * 4 + (r.d_conv - 1) * w * 2)
    kv_bytes = sum(kv_chunk_bytes(cfg, run.wire, run.p_vendor.tp, *c)
                   for pl in plan for c in pl["chunks"])
    want_bytes = kv_bytes + len(run.reqs) * tail_bytes
    got_bytes = run.pipe.transfer.stats.bytes_moved
    if got_bytes != want_bytes:
        raise AssertionError(f"phase 8: wire bytes {got_bytes}, the floors "
                             f"and the state tails predict {want_bytes}")
    report = serving_report(run)
    del run.sched, run.p_eng, run.d_eng, run.pipe  # D's pools, for the checks
    gc.collect()
    torch.cuda.empty_cache()
    worst = last_token_gap(cfg, run.params, dev, run.reqs)
    gap32, err32 = first_token_yardstick(cfg, run.params, dev, run.prompts,
                                         run.reqs)
    out = {"phase": 8, "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": cfg.num_layers, "recurrent_layers": n_rec,
           "dtype": cfg.compute_dtype, "window": win, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.hd, "lru_width": w,
           "params_b": param_billions(run.params),
           "param_count_b": cfg.param_count() / 1e9,
           **report,
           "peak_mem_gib_with_checks":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "progress_markers_skipped": markers,
           "wire_bytes_predicted": want_bytes,
           "wire_kv_bytes": kv_bytes, "tail_bytes_per_request": tail_bytes,
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err32,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return {**out, **in_process_record(run)}


# --------------------------------------------------------------------------- #
# phase 16: phases 7 and 8's traffic across worker processes
# --------------------------------------------------------------------------- #
def divergence_yardstick(cfg, params, dev, prompts, got, want, moe: bool):
    """Where two runs' tokens of a request differ: both tokens at the first
    difference measured by the first-token yardstick of the request's
    phase (``first_token_yardstick``; for an MoE model
    ``moe_first_token_yardstick``, float32 on the bf16 prefill's expert
    choices) on the prompt and the tokens before the difference. ``want``
    is the record: its token there can itself sit more than LOGIT_SLACK
    below the prefill's best, since a token decoded past the prompt took
    its decode step's path (and, in an MoE model, routing), not the
    prefill's, and a first difference falls where the two runs'
    computations part. So ``got``'s token must be within LOGIT_SLACK of
    the best, or no further from it than ``want``'s. ``got`` and ``want``:
    tokens by request id, ``got`` in the order of ``prompts``. Returns,
    for each request that differs, where, the tokens and their gaps."""
    import types
    import numpy as np
    rows = []
    for (rid, g), prompt in zip(got.items(), prompts):
        w = want[rid]
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            continue
        seq = np.concatenate([prompt, np.asarray(g[:i], np.int32)])
        reqs = [types.SimpleNamespace(req_id=f"{rid}@{i}", patches=None,
                                      frames=None, output_tokens=[tok])
                for tok in (g[i], w[i])]
        row = {"req": rid, "at": i, "tokens": [g[i], w[i]]}
        if moe:
            yard = moe_first_token_yardstick(cfg, params, dev, [seq, seq],
                                             reqs, gate=False)
            row.update({k: [y[k] for y in yard] for k in (
                "gap", "gap_own_routing", "gap_bf16",
                "last_token_choice_differs_at_layers")})
        else:
            row["gap"] = [first_token_yardstick(cfg, params, dev, [seq], [r],
                                                gate=False)[0] for r in reqs]
        if row["gap"][0] > max(LOGIT_SLACK, row["gap"][1]):
            raise AssertionError(f"{rid}: its token at the first difference "
                                 f"is more than {LOGIT_SLACK} below the "
                                 "float32 best and further than the record's"
                                 f" token: {row}")
        rows.append(row)
    return rows


def phase16_part(dev, part: str, rec: dict, model: str, p_vendor: dict):
    """Phase 6's eight prompts served to ``model`` by ``TwoProcessRuntime``
    as its in-process phase served them (``rec``: that phase's record):
    P (``p_vendor``) and phase 3's D in two spawned worker processes, each
    building the weights on the card from SEED, the wire over shm
    segments, 500-token chunks. Held to the record: the bytes under every
    wire key (a chunk's segment; a tail's arrays, whose pickled segment
    adds its framing), the prefill tokens computed, each kernel's
    launches summed over the workers (a chunk's kernels equal, a decode
    step's equal per D step: D runs as many steps as its batches need
    while P's chunks land, not the single-process scheduler's count), and
    the tokens (identical, or the first difference within the phase's
    own first-token yardstick); and every request finished, no fault, no
    segment left after shutdown."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.models import model as M
    from repro_torch.serving.engine import VendorProfile
    from repro_torch.serving.multiproc import EngineSpec, TwoProcessRuntime
    from repro_torch.serving.request import Request
    from repro_torch.serving.server import ServeResult

    t_part = time.perf_counter()
    cfg = get_config(model)
    d_vendor = VendorProfile(**D_VENDOR)
    rng = np.random.default_rng(SEED)                 # phase 6's draws
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), MAX_NEW)
            for i, n in enumerate(PHASE6_PROMPTS)]
    prompts = [r.prompt.copy() for r in reqs]
    bs = d_vendor.block_size
    d_blocks = sum(-(-(n + MAX_NEW) // bs) for n in PHASE6_PROMPTS) + 1
    common = dict(cfg=cfg, params_seed=SEED, device=None
                  if dev.type == "cuda" else "cpu",
                  max_seq_len=max(PHASE6_PROMPTS) + MAX_NEW)
    p_spec = EngineSpec("P0", vendor=VendorProfile(**p_vendor),
                        num_blocks=2, max_batch=1, role="prefill", **common)
    d_spec = EngineSpec("D0", vendor=d_vendor, num_blocks=d_blocks,
                        max_batch=len(reqs), role="decode", **common)
    free_before = torch.cuda.mem_get_info() if dev.type == "cuda" else None
    rt = TwoProcessRuntime(p_spec, d_spec, wire=WireFormat("raw", "bfloat16"),
                           prefill_chunk=PREFILL_CHUNK)
    try:
        t0 = time.perf_counter()
        rt.start(spawn_timeout_s=300.0)
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.serve(reqs, max_wall_s=600.0)
        wall = time.perf_counter() - t0
    finally:
        rt.shutdown()
    left = segments_left(rt.segments_seen)
    launches = collections.Counter()
    for counts in rt.worker_launches.values():
        launches.update(counts)
    launches = {k: launches.get(k, 0) for k in rec["launches"]}
    check_outputs(cfg, reqs)

    problems = []
    if (rt.stream_failures or sum(rt.crashes.values())
            or rt.stats.requeues or rt.stats.failed):
        problems.append(f"stream failures {rt.stream_failures}, crashes "
                        f"{rt.crashes}, requeues {rt.stats.requeues}, "
                        f"failed {rt.stats.failed}")
    if not rt.segments_seen or left:
        problems.append(f"{len(rt.segments_seen)} segments seen, {left} "
                        "left after shutdown")
    # the bytes under every key: a chunk's segment, a tail's arrays
    staged = {k: rt.tail_payload_bytes.get(k, n)
              for k, n in rt.staged_bytes.items()}
    differ = sorted(k for k in set(staged) | set(rec["staged"])
                    if staged.get(k) != rec["staged"].get(k))
    if differ:
        problems.append(f"wire bytes differ from phase {rec['phase']}'s "
                        f"under {len(differ)} keys: " + ", ".join(
                            f"{k} {staged.get(k)} vs {rec['staged'].get(k)}"
                            for k in differ[:4]))
    prefill_tokens = rt.worker_stats["P0"]["prefill_tokens"]
    if prefill_tokens != rec["prefill_tokens"]:
        problems.append(f"{prefill_tokens} prefill tokens computed, phase "
                        f"{rec['phase']} computed {rec['prefill_tokens']}")
    # a chunk's kernels launch once a chunk; a decode step's once a step,
    # and D's steps follow the arrivals (its decode batches fill as P's
    # chunks land), so those are held per step
    steps = rt.worker_stats["D0"]["decode_steps"]
    want = {k: (n * steps // rec["decode_steps"] if k in STEP_KERNELS
                else n) for k, n in rec["launches"].items()}
    if launches != want or any(rec["launches"][k] % rec["decode_steps"]
                               for k in STEP_KERNELS):
        problems.append(f"launches {launches} in {steps} decode steps, "
                        f"phase {rec['phase']}'s {rec['launches']} in "
                        f"{rec['decode_steps']}")
    tokens = {r.req_id: list(r.output_tokens) for r in reqs}
    tails = sorted(rt.tail_payload_bytes)
    tr = rt.transfer_stats
    result = ServeResult(reqs, wall)
    ttft, tpot = result.ttft(), result.tpot()
    out = {"phase": 16, "part": part, "of_phase": rec["phase"],
           "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "runtime": "TwoProcessRuntime",
           "connector": "shm", "requests": len(reqs),
           "prompt_lens": list(PHASE6_PROMPTS), "max_new_tokens": MAX_NEW,
           "prefill_chunk": PREFILL_CHUNK,
           "p_vendor": dataclasses.asdict(p_spec.vendor),
           "d_vendor": dataclasses.asdict(d_vendor),
           "ttft_p50_s": float(np.percentile(ttft, 50)),
           "ttft_max_s": float(ttft.max()),
           "tpot_p50_s": float(np.percentile(tpot, 50)),
           "output_tok_s": result.throughput_tok_s(),
           "in_process_tok_s": rec["output_tok_s"],
           "wall_s": wall, "spawn_to_hello_s": spawn_s,
           "worker_pids": rt.worker_pids, "parent_pid": os.getpid(),
           "launches": launches, "worker_launches": rt.worker_launches,
           "in_process_launches": rec["launches"], "decode_steps": steps,
           "in_process_decode_steps": rec["decode_steps"],
           "keys_compared": len(staged), "keys_differing": len(differ),
           "tail_keys": len(tails),
           "tail_payload_bytes": sum(rt.tail_payload_bytes.values()),
           "tail_segment_bytes": sum(rt.staged_bytes[k] for k in tails),
           "wire_bytes": tr.bytes_moved,
           "in_process_wire_bytes": rec["wire_bytes"],
           "prefill_tokens": prefill_tokens,
           "wall_handoff_s": tr.wall_handoff_seconds,
           "wall_overlap_s": tr.wall_overlap_seconds,
           "segments_seen": len(rt.segments_seen), "segments_left": len(left),
           "worker_peak_mem_gib": {k: v / 2 ** 30 for k, v in
                                   rt.worker_peak_mem_bytes.items()},
           "free_gib_before": None if free_before is None
               else free_before[0] / 2 ** 30,
           "tokens_sha256": tokens_digest(reqs),
           "in_process_tokens_sha256": rec["tokens_sha256"],
           "problems": problems}
    if problems:
        emit(out)
        raise AssertionError(f"phase 16 ({part}, {cfg.name}): {problems}")
    # the tokens: identical, or the first difference within the yardstick
    # (the weights are built here only now, with no worker alive)
    out["tokens"] = "identical"
    if tokens != rec["tokens"]:
        params = M.init_params(cfg, seed=SEED, device=dev)
        out["divergences"] = divergence_yardstick(
            cfg, params, dev, prompts, tokens, rec["tokens"], cfg.is_moe)
        out["tokens"] = ("differ, each first difference within the "
                         "yardstick or no further than the record's token")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out["part_s"] = time.perf_counter() - t_part
    emit(out)
    return {"launches": launches}


def phase16(dev, paths):
    """Phases 7 and 8's serving again, across worker processes: 16a
    DeepSeek-V2-Lite (MLA's latent wire, gather in D's decode), 16b
    RecurrentGemma-9B (window-floored KV and the RG-LRU states' tail from
    device memory into a shm segment), each held to its in-process
    phase's record (``paths[7]``, ``paths[8]``)."""
    import torch
    t0 = time.perf_counter()
    launches = collections.Counter()
    for part, (phase, model, vendor) in PHASE16_PARTS.items():
        gc.collect()
        torch.cuda.empty_cache()
        rec = dict(paths[phase], phase=phase)
        launches.update(phase16_part(dev, part, rec, model,
                                     vendor)["launches"])
    emit({"phase": 16, "phase_s": time.perf_counter() - t0,
          "launches": dict(launches)})
    return {"launches": dict(launches)}


# --------------------------------------------------------------------------- #
# phase 9: the Mamba-2 SSD family (Mamba2-370M) at full width and depth
# --------------------------------------------------------------------------- #
def phase9(dev, around_serve=contextlib.nullcontext):
    """Mamba2-370M at full width and all 48 layers, bf16, random weights
    from SEED, served to phase 6's prompts by a P at TP 1 and phase 3's
    D: every chunk through the 48 SSD layers' chunk scan with the states
    carried from chunk to chunk, each request's stream a run of progress
    markers and then one package of no entries that declares its whole
    length, the states' tail placed into D's slot at finalize, and
    decode through the single-step recurrence. No attention kernel runs:
    the family has no attention and no KV. ``around_serve`` as in
    ``phase3``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transport.wirefmt import WireChunk
    from repro_torch.serving.engine import VendorProfile

    t_phase = time.perf_counter()
    cfg = get_config(MODEL9)
    s = cfg.ssm
    run = serve_long_prompts(9, cfg, VendorProfile(**P_VENDOR8), dev,
                             around_serve, ())
    # the wire: per request one empty chunk (a header that declares the
    # whole length) and one tail of every layer's h (float32) and conv
    # tail (bf16); no KV byte
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    tail_bytes = cfg.num_layers * (
        s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
        + (s.d_conv - 1) * conv_dim * 2)
    tails = {k: n for k, n in run.staged.items() if k.endswith("tail")}
    if sorted(tails.values()) != [tail_bytes] * len(run.reqs) or \
            tail_bytes != PHASE9_TAIL_BYTES:
        raise AssertionError(f"phase 9: tails {tails}, the states say "
                             f"{tail_bytes} a request")
    header = WireChunk.from_entries([], run.wire, run.p_vendor.tp,
                                    seq_len=1).nbytes
    st = run.pipe.transfer.stats
    want_bytes = len(run.reqs) * (header + tail_bytes)
    if st.payload_bytes != len(run.reqs) * tail_bytes or \
            st.bytes_moved != want_bytes:
        raise AssertionError(f"phase 9: wire payload {st.payload_bytes} / "
                             f"bytes {st.bytes_moved}, the tails say "
                             f"{len(run.reqs) * tail_bytes} / {want_bytes}")
    if [run.shipped[r.req_id] for r in run.reqs] != list(PHASE6_PROMPTS) \
            or run.sched.stats.chunks_streamed != len(run.reqs):
        raise AssertionError(f"phase 9: {run.sched.stats.chunks_streamed} "
                             f"chunks, positions declared {dict(run.shipped)}")
    markers = run.p_eng.stats.prefill_chunks - run.sched.stats.chunks_streamed
    want_markers = sum(-(-n // PREFILL_CHUNK) - 1 for n in PHASE6_PROMPTS)
    if markers != want_markers or run.d_eng.paged_pools():
        raise AssertionError(f"phase 9: {markers} progress markers, "
                             f"{want_markers} expected; D pools "
                             f"{len(run.d_eng.paged_pools())}")
    report = serving_report(run)
    del run.sched, run.p_eng, run.d_eng, run.pipe
    gc.collect()
    torch.cuda.empty_cache()
    worst = last_token_gap(cfg, run.params, dev, run.reqs)
    gap32, err32 = first_token_yardstick(cfg, run.params, dev, run.prompts,
                                         run.reqs)
    out = {"phase": 9, "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": cfg.num_layers, "dtype": cfg.compute_dtype,
           "d_model": cfg.d_model, "ssd_heads": s.n_heads(cfg.d_model),
           "ssd_head_dim": s.head_dim, "d_state": s.d_state,
           "chunk_size": s.chunk_size,
           "params_b": param_billions(run.params),
           **report,
           "peak_mem_gib_with_checks":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "progress_markers_skipped": markers,
           "wire_bytes_predicted": want_bytes,
           "tail_bytes_per_request": tail_bytes,
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err32,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 10: the vision frontend (InternVL2-2B) at full width and depth
# --------------------------------------------------------------------------- #
def phase10_requests(cfg):
    """Phase 3's eight prompts (lengths and tokens from the same draws),
    each after PHASE10_PATCHES patch embeddings (d_model wide, float32,
    unit normal, from the same generator after the prompts): the stub
    frontend, as the JAX package's tests feed it."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS)
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), MAX_NEW) for i, n in enumerate(lens)]
    for r in reqs:
        r.patches = rng.normal(size=(PHASE10_PATCHES, cfg.d_model)).astype(
            np.float32)
    return reqs


def phase10(dev, around_serve=contextlib.nullcontext):
    """InternVL2-2B at full width and all 24 layers, bf16, random weights
    from SEED, served by phase 3's vendors (P at TP 2) to phase 3's
    prompts, each after 256 patch embeddings: P's chunks slice the merged
    patch + token sequence (the first spans the boundary) through flash,
    the wire carries every position's KV, the overlay re-pages it into
    D's pools and paged attention decodes. Both engines have a prefix
    cache, which every request must bypass and count: the vlm family's
    capability row has no prefix cache (its KV is not prefix-cacheable),
    so the check reads that row.
    ``around_serve`` as in ``phase3``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import VendorProfile

    t_phase = time.perf_counter()
    cfg = get_config(MODEL10)
    run = serve_long_prompts(10, cfg, VendorProfile(**P_VENDOR), dev,
                             around_serve, PHASE3_KERNELS,
                             make_reqs=phase10_requests, prefix_cache=True)
    seqs = [r.prompt_len + r.num_patches for r in run.reqs]
    # the wire: every position of patches + prompt, K and V of 24 layers x
    # 8 heads x 128 in bf16 (98,304 bytes), in PREFILL_CHUNK chunks
    per_pos = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.hd * 2
    chunks = [(c0, min(PREFILL_CHUNK, n - c0)) for n in seqs
              for c0 in range(0, n, PREFILL_CHUNK)]
    want_bytes = sum(kv_chunk_bytes(cfg, run.wire, run.p_vendor.tp, *c)
                     for c in chunks)
    st = run.pipe.transfer.stats
    if [run.shipped[r.req_id] for r in run.reqs] != seqs or \
            st.payload_bytes != sum(seqs) * per_pos or \
            st.bytes_moved != want_bytes or \
            run.sched.stats.chunks_streamed != len(chunks):
        raise AssertionError(
            f"phase 10: positions {dict(run.shipped)}, payload "
            f"{st.payload_bytes} / bytes {st.bytes_moved} / chunks "
            f"{run.sched.stats.chunks_streamed}; patches + prompt say "
            f"{sum(seqs) * per_pos} / {want_bytes} / {len(chunks)}")
    # the prefix caches: never consulted, every request counted
    p, d = run.p_eng.stats, run.d_eng.stats
    bypassed = (p.resume_unsupported, d.resume_unsupported)
    if bypassed != (len(run.reqs), len(run.reqs)) or st.prefix_hit_tokens \
            or p.prefix_cached_tokens or len(run.d_eng.prefix_store):
        raise AssertionError(f"phase 10: prefix cache bypassed {bypassed}, "
                             f"hits {st.prefix_hit_tokens} / "
                             f"{p.prefix_cached_tokens}")
    report = serving_report(run)
    del run.sched, run.p_eng, run.d_eng, run.pipe
    gc.collect()
    torch.cuda.empty_cache()
    worst = last_token_gap(cfg, run.params, dev, run.reqs)
    gap32, err32 = first_token_yardstick(cfg, run.params, dev, run.prompts,
                                         run.reqs)
    out = {"phase": 10, "model": cfg.name, "layers": cfg.num_layers,
           "layers_published": cfg.num_layers, "dtype": cfg.compute_dtype,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.hd,
           "params_b": param_billions(run.params),
           **report,
           "peak_mem_gib_with_checks":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "sequence_lens": seqs, "kv_bytes_per_position": per_pos,
           "wire_bytes_predicted": want_bytes,
           "prefix_cache_bypassed": list(bypassed),
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err32,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 11: the encoder-decoder family (Whisper-large-v3) at full width and
# depth
# --------------------------------------------------------------------------- #
def phase11_requests(cfg):
    """Eight requests of MAX_NEW greedy tokens: decoder prompts of
    PHASE11_PROMPTS tokens (lengths, then tokens, from SEED's generator),
    each with ``max_source_len`` frame embeddings (d_model wide, float32,
    unit normal, from the same generator after the prompts): the stub
    frontend, as the JAX package's tests feed it."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PHASE11_PROMPTS[0], PHASE11_PROMPTS[1] + 1,
                        N_REQUESTS)
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), MAX_NEW) for i, n in enumerate(lens)]
    for r in reqs:
        r.frames = rng.normal(size=(cfg.max_source_len, cfg.d_model)).astype(
            np.float32)
    return reqs


def phase11(dev, around_serve=contextlib.nullcontext):
    """Whisper-large-v3 at full width and all 32 + 32 layers, bf16, random
    weights from SEED, served by phase 3's vendors (P at TP 2) to eight
    requests of 1500 frames and 16-224 prompt tokens in 64-token chunks:
    P runs each request's encoder once (flash non-causal over 1500
    frames, 32 layers) and seeds every decoder layer's memory rows, then
    each chunk's self-attention (flash, causal; flash_decode for the
    one-row chunk that ends the 193-token prompt) and cross-attention
    (flash, non-causal at kv_len 1500); the wire carries the prompt's
    self KV in chunks and one tail of memory rows a request; the overlay
    re-pages the KV into D's pools, D places the rows into the slot and
    decodes (paged for self-attention, plain ops for the per-slot
    cross-attention). Both engines have a prefix cache, which every
    request must bypass and count (the family's capability row has
    none). ``around_serve`` as in ``phase3``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import VendorProfile

    t_phase = time.perf_counter()
    cfg = get_config(MODEL11)
    lens = [r.prompt_len for r in phase11_requests(cfg)]
    one_row = one_row_chunks(lens, PHASE11_CHUNK)
    run = serve_long_prompts(11, cfg, VendorProfile(**P_VENDOR), dev,
                             around_serve, PHASE3_KERNELS
                             | ({"flash_decode"} if one_row else set()),
                             make_reqs=phase11_requests, prefix_cache=True,
                             chunk=PHASE11_CHUNK)
    if [r.prompt_len for r in run.reqs] != lens:
        raise AssertionError("phase 11: the requests changed between calls")
    n_dec, n_enc = cfg.num_layers, cfg.encoder_layers
    chunks = [(c0, min(PHASE11_CHUNK, n - c0)) for n in lens
              for c0 in range(0, n, PHASE11_CHUNK)]
    # launches: each request's encoder once; each chunk's self- and
    # cross-attention in every decoder layer (a one-row chunk's
    # self-attention through flash_decode); the overlay for k and v of
    # each chunk (all 32 layers a launch); paged a layer a decode step
    want_launches = {
        "flash_attention": len(run.reqs) * n_enc
        + n_dec * (2 * len(chunks) - one_row),
        "flash_decode": n_dec * one_row,
        "scatter_pages_overlay": 2 * len(chunks),
        "paged_attention": n_dec * run.d_eng.stats.decode_steps}
    got_launches = {k: run.launches[k] for k in want_launches}
    if got_launches != want_launches:
        raise AssertionError(f"phase 11: launches {got_launches}, the path "
                             f"predicts {want_launches}")
    # the wire: every prompt position's self KV (32 layers x 20 heads x 64
    # x k, v in bf16: 163,840 bytes) in 64-token chunks with their
    # headers, and one tail a request of the memory rows and lengths
    per_pos = n_dec * 2 * cfg.num_kv_heads * cfg.hd * 2
    cross = n_dec * 2 * cfg.max_source_len * cfg.num_kv_heads * cfg.hd * 2
    tail = cross + n_dec * 4
    tails = {k: n for k, n in run.staged.items() if k.endswith("tail")}
    if sorted(tails.values()) != [tail] * len(run.reqs) or \
            cross != PHASE11_CROSS_BYTES:
        raise AssertionError(f"phase 11: tails {tails}, the memory rows say "
                             f"{tail} a request")
    want_bytes = sum(kv_chunk_bytes(cfg, run.wire, run.p_vendor.tp, *c)
                     for c in chunks) + len(run.reqs) * tail
    st = run.pipe.transfer.stats
    if [run.shipped[r.req_id] for r in run.reqs] != lens or \
            st.payload_bytes != sum(lens) * per_pos + len(run.reqs) * tail \
            or st.bytes_moved != want_bytes or \
            run.sched.stats.chunks_streamed != len(chunks):
        raise AssertionError(
            f"phase 11: positions {dict(run.shipped)}, payload "
            f"{st.payload_bytes} / bytes {st.bytes_moved} / chunks "
            f"{run.sched.stats.chunks_streamed}; prompts and tails say "
            f"{sum(lens) * per_pos + len(run.reqs) * tail} / {want_bytes} / "
            f"{len(chunks)}")
    # the prefix caches: never consulted, every request counted
    p, d = run.p_eng.stats, run.d_eng.stats
    bypassed = (p.resume_unsupported, d.resume_unsupported)
    if bypassed != (len(run.reqs), len(run.reqs)) or st.prefix_hit_tokens \
            or p.prefix_cached_tokens or len(run.d_eng.prefix_store):
        raise AssertionError(f"phase 11: prefix cache bypassed {bypassed}, "
                             f"hits {st.prefix_hit_tokens} / "
                             f"{p.prefix_cached_tokens}")
    mem_len = run.d_eng.mem_len
    report = serving_report(run)
    del run.sched, run.p_eng, run.d_eng, run.pipe
    gc.collect()
    torch.cuda.empty_cache()
    worst = last_token_gap(cfg, run.params, dev, run.reqs)
    gap32, err32 = first_token_yardstick(cfg, run.params, dev, run.prompts,
                                         run.reqs)
    out = {"phase": 11, "model": cfg.name, "layers": n_dec,
           "encoder_layers": n_enc,
           "layers_published": [cfg.encoder_layers, cfg.num_layers],
           "dtype": cfg.compute_dtype, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.hd,
           "mem_len": mem_len, "frames": [len(r.frames) for r in run.reqs],
           "params_b": param_billions(run.params),
           **report,
           "peak_mem_gib_with_checks":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "chunks": len(chunks), "launches_predicted": want_launches,
           "kv_bytes_per_position": per_pos,
           "cross_bytes_per_request": cross,
           "tail_bytes_per_request": tail,
           "wire_bytes_predicted": want_bytes,
           "prefix_cache_bypassed": list(bypassed),
           "last_token_logit_gap_max": worst,
           "first_token_gap_f32_max": gap32,
           "last_logits_bf16_vs_f32_max_abs": err32,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 12: the planner, the open-loop load harness and the live autoscaler
# --------------------------------------------------------------------------- #
def phase12_workload(loadgen):
    """Phase 12's traffic from a ``loadgen`` package (the port's; the CPU
    tests also pass the JAX package's, which must give the same)."""
    offsets = loadgen.bursty_arrivals(PHASE12_RATE, PHASE12_DURATION_S,
                                      PHASE12_SEED, **PHASE12_BURSTS)
    return loadgen.build_workload(
        offsets, loadgen.WorkloadConfig(**PHASE12_WORKLOAD),
        seed=PHASE12_SEED)


def phase12_warmup(loadgen):
    """Phase 12's untimed warmup requests: the same mixture from another
    seed, each cut to a few tokens, all due at once."""
    warm = loadgen.build_workload([0.0] * PHASE12_WARMUP["n"],
                                  loadgen.WorkloadConfig(**PHASE12_WORKLOAD),
                                  seed=PHASE12_WARMUP["seed"],
                                  id_prefix="warm")
    for it in warm:
        it.request.max_new_tokens = PHASE12_WARMUP["max_new_tokens"]
    return warm


def schedule_digest(workload) -> str:
    """sha256 of a schedule: each item's offset, prompt bytes and
    ``max_new_tokens``, in order."""
    import numpy as np
    h = hashlib.sha256()
    for it in workload:
        h.update(np.float64(it.offset_s).tobytes())
        h.update(np.asarray(it.request.prompt, np.int32).tobytes())
        h.update(np.int64(it.request.max_new_tokens).tobytes())
    return h.hexdigest()[:16]


class _Timeline:
    """What phase 12 observes of a live run, between ``run_open_loop`` and
    the runtime and autoscaler it drives: each autoscale action (with
    the instance id it spawned), when each grown worker's hello landed,
    when each drain came, and for each grown worker how many requests the
    router gave another member of its role while the grown one was
    routable, idle, and so ranked first by the router's own order. Stands in for
    both: ``try_submit`` and ``step`` for the runtime, ``tick`` for the
    autoscaler."""

    def __init__(self, rt, autoscaler):
        self.rt, self.autoscaler = rt, autoscaler
        self.actions = []          # (action, monotonic time, iid or None)
        self.hello_at = {}         # grown iid -> monotonic time of its hello
        self.drained = set()       # iids the autoscaler drained
        self.passed_over = collections.Counter()   # grown iid -> requests

    def _load(self, inst) -> int:
        """The router's load key for a member: a P's queued prefill tokens
        and requests, a D's occupied slots (its reserved blocks move with
        them)."""
        return inst.queue_tokens + inst.queue_reqs if inst.role == "P" \
            else inst.active

    def try_submit(self, req) -> bool:
        return self.rt.try_submit(req)

    def step(self, timeout: float) -> None:
        rt = self.rt
        before = set(rt._active)
        load = {iid: self._load(i) for iid, i in rt._instances.items()}
        rt.step(timeout=timeout)
        # the requests this step routed, in routing order (a step routes
        # before it handles one event, so no load fell in between). The
        # router ranks an idle grown member first over a busy member, and
        # over an idle one of a larger id (pick_p, pick_d: equal specs,
        # equal free pools)
        routable = [g for g in self.hello_at if g not in self.drained]
        got = collections.Counter()
        for req_id, rec in rt._active.items():
            if req_id in before:
                continue
            for role, member in (("P", rec.p_id), ("D", rec.d_id)):
                busy = load.get(member, 0) > 0 or got[member] > 0
                for g in routable:
                    idle = load.get(g, 0) == 0 and got[g] == 0
                    if g[0] == role and g != member and idle \
                            and (busy or g < member):
                        self.passed_over[g] += 1
                got[member] += 1
        for _, _, iid in self.actions:
            if iid is not None and iid not in self.hello_at \
                    and iid in rt.worker_pids:
                self.hello_at[iid] = time.monotonic()

    def tick(self):
        before = set(self.rt._instances)
        now = time.monotonic()
        action = self.autoscaler.tick()
        if action:
            spawned = sorted(set(self.rt._instances) - before)
            self.actions.append((action, now, spawned[0] if spawned
                                 else None))
            if action.startswith("drain:"):
                self.drained.add(action.split(":", 1)[1])
        return action


def phase12(dev):
    """llama2-7b served from the port's plan: ``plan_deployment`` →
    ``DeploymentPlan.to_cluster_spec`` → ``ClusterRuntime`` (over shm)
    under ``run_open_loop``, with admission and a ``PDAutoscaler`` over
    ``ClusterLoadSource`` whose baseline is the plan. The parent holds no
    weights while the workers live; it builds them after shutdown for the
    token checks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.autoscale import (AutoscalerConfig,
                                            ClusterLoadSource, PDAutoscaler)
    from repro_torch.core.compat.precision import WireFormat
    from repro_torch.core.planner.hardware import get as get_hw
    from repro_torch.core.planner.optimizer import plan_deployment
    from repro_torch.core.planner.workload import Workload
    from repro_torch.models import model as M
    from repro_torch.serving import loadgen
    from repro_torch.serving.engine import VendorProfile
    from repro_torch.serving.multiproc import ClusterRuntime
    from repro_torch.serving.multiproc.report import (plan_section,
                                                      plan_vs_measured,
                                                      slo_section)
    from repro_torch.serving.request import State
    from repro_torch.serving.router import AdmissionConfig

    t_phase = time.perf_counter()
    cfg = get_config(MODEL)
    h100 = get_hw("h100-sxm")
    plan = plan_deployment(cfg, Workload(**PHASE12_PLAN), h100, h100)
    # the card holds the baseline and one grown worker of each role
    auto_cfg = AutoscalerConfig(**PHASE12_AUTOSCALER)
    clamped = plan.n_prefill >= auto_cfg.max_p \
        or plan.n_decode >= auto_cfg.max_d
    n_p, n_d = (1, 1) if clamped else (plan.n_prefill, plan.n_decode)
    p_vendor, d_vendor = VendorProfile(**P_VENDOR), VendorProfile(**D_VENDOR)
    d_blocks = PHASE12_MAX_BATCH * -(-PHASE12_MAX_SEQ
                                     // d_vendor.block_size) + 1
    spec = plan.to_cluster_spec(
        cfg, p_vendor=p_vendor, d_vendor=d_vendor, params_seed=SEED,
        num_blocks=d_blocks, max_batch=PHASE12_MAX_BATCH,
        max_seq_len=PHASE12_MAX_SEQ, num_p=n_p, num_d=n_d,
        device=None if dev.type == "cuda" else "cpu")
    # P streams its prefills through dense caches and never fills its
    # pool: phase 5's 2 blocks, not D's 273, leave 2.1 GiB a P for the
    # moments when a drained member still boots beside a new one
    spec = dataclasses.replace(spec, p=tuple(
        dataclasses.replace(e, num_blocks=2) for e in spec.p))
    workload = phase12_workload(loadgen)
    reqs = [it.request for it in workload]
    prompts = [r.prompt.copy() for r in reqs]
    warm = phase12_warmup(loadgen)
    rt = ClusterRuntime(spec, wire=WireFormat("raw", "bfloat16"),
                        prefill_chunk=PREFILL_CHUNK,
                        admission=AdmissionConfig(**PHASE12_ADMISSION))
    try:
        t0 = time.perf_counter()
        rt.start(spawn_timeout_s=300.0)
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.serve([it.request for it in warm], max_wall_s=600.0)
        warmup_s = time.perf_counter() - t0
        rt.reset_latency_measurements()   # warmup TTFTs are not the system
        rt.reset_launch_counts()          # nor are its launches
        auto = PDAutoscaler(
            ClusterLoadSource(rt),
            p_factory=lambda name: dataclasses.replace(spec.p[0], name=name),
            d_factory=lambda name: dataclasses.replace(spec.d[0], name=name),
            baseline_p=n_p, baseline_d=n_d, config=auto_cfg)
        line = _Timeline(rt, auto)
        res = loadgen.run_open_loop(line, workload, autoscaler=line,
                                    autoscale_every_s=PHASE12_TICK_S,
                                    max_wall_s=PHASE12_DURATION_S + 600.0)
        hello_by_end = set(rt.worker_pids)
        dispatches = {**rt.stats.p_dispatches, **rt.stats.d_dispatches}
    finally:
        rt.shutdown()
    left = segments_left(rt.segments_seen)
    launches = {name: 0 for name, *_ in KERNELS}
    for counts in rt.worker_launches.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    # --- checks: each failure is listed, the line printed, then raised --- #
    t_epoch = reqs[0].arrival_time - workload[0].offset_s  # run_open_loop's t0
    admitted = [r for r in reqs if r.state != State.SHED]
    problems = []
    if res.offered != res.admitted + res.shed or res.admitted != len(admitted):
        problems.append(f"offered {res.offered}, admitted {res.admitted}, "
                        f"shed {res.shed}")
    for r in reqs:
        if r.state == State.SHED:
            if r.output_tokens or r.first_token_time is not None \
                    or r.chunks_streamed:
                problems.append(f"shed {r.req_id} was served")
        elif r.state != State.FINISHED \
                or len(r.output_tokens) != r.max_new_tokens \
                or not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            problems.append(f"{r.req_id} {r.state}, {len(r.output_tokens)} "
                            f"of {r.max_new_tokens} tokens")
    if (rt.stream_failures or sum(rt.crashes.values())
            or rt.stats.requeues or rt.stats.failed or res.failed):
        problems.append(f"stream failures {rt.stream_failures}, crashes "
                        f"{rt.crashes}, requeues {rt.stats.requeues}, "
                        f"failed {rt.stats.failed} / {res.failed}")
    drained_at = {a.split(":", 1)[1]: t for a, t, _ in line.actions
                  if a.startswith("drain:")}
    grown = []
    for action, t_act, iid in line.actions:
        if not action.startswith("grow-"):
            continue
        hello = line.hello_at.get(iid)
        grown.append({"action": action, "iid": iid, "t_s": t_act - t_epoch,
                      "action_to_hello_s": None if hello is None
                      else hello - t_act,
                      "drained_t_s": drained_at[iid] - t_epoch
                      if iid in drained_at else None,
                      "served": dispatches.get(iid, 0),
                      "passed_over": line.passed_over[iid]})
        # a grown worker that reached its hello and served nothing fails
        # if, while it was routable, the router gave its role a request
        # that the router's own order owed to it
        if hello is not None and not dispatches.get(iid, 0) \
                and line.passed_over[iid]:
            problems.append(f"grown {iid} joined and served nothing while "
                            f"{line.passed_over[iid]} requests it ranked "
                            "first for went to its role")
    if not grown:
        problems.append(f"no grow action ({res.autoscale_actions})")
    elif not any(g["served"] for g in grown):
        problems.append("no grown worker served")
    if not hello_by_end <= set(rt.worker_launches):
        problems.append(f"launch counts from {sorted(rt.worker_launches)}, "
                        f"workers {sorted(hello_by_end)}")
    launched = {k for k, n in launches.items() if n > 0}
    if dev.type == "cuda" and launched != PHASE3_KERNELS:
        problems.append(f"kernels launched {launched}, the path runs "
                        f"{PHASE3_KERNELS}")
    if not rt.segments_seen or left:
        problems.append(f"{len(rt.segments_seen)} segments seen, {left} "
                        "left after shutdown")

    lat = slo_section(reqs, res.wall_s,
                      slo_ttft_s=PHASE12_AUTOSCALER["slo_ttft_s"],
                      slo_tpot_s=PHASE12_AUTOSCALER["slo_tpot_s"])
    report = plan_vs_measured(rt, reqs, plan=plan, wall_s=res.wall_s)
    report["measured"].pop("worker_stats")        # printed below, in short
    out = {"phase": 12, "model": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.compute_dtype, "runtime": "ClusterRuntime",
           "connector": "shm", "plan": plan_section(plan),
           "plan_strategies": {"prefill": dataclasses.asdict(
               plan.prefill.strategy), "decode": dataclasses.asdict(
               plan.decode.strategy), "decode_batch": plan.decode.batch},
           "launched": spec.ratio(), "clamped": clamped,
           "schedule_sha256": schedule_digest(workload),
           "arrivals": {"rate_rps": PHASE12_RATE,
                        "duration_s": PHASE12_DURATION_S,
                        "seed": PHASE12_SEED, **PHASE12_BURSTS},
           "prompt_len_p50": float(np.median([r.prompt_len for r in reqs])),
           "max_new_p50": float(np.median([r.max_new_tokens
                                           for r in reqs])),
           "offered": res.offered, "admitted": res.admitted,
           "shed": res.shed, "finished": res.finished,
           "autoscale_actions": [{"action": a, "t_s": t - t_epoch}
                                 for a, t, _ in line.actions],
           "grown": grown, **lat,
           "output_tok_s": sum(len(r.output_tokens) for r in admitted)
           / res.wall_s,
           "spawn_to_hello_s": spawn_s, "warmup_s": warmup_s,
           "worker_pids": rt.worker_pids,
           "worker_peak_mem_gib": {k: v / 2 ** 30 for k, v in
                                   rt.worker_peak_mem_bytes.items()},
           "worker_prefill_s": {k: v["prefill_seconds"] for k, v in
                                rt.worker_stats.items()},
           "worker_decode_steps": {k: v["decode_steps"] for k, v in
                                   rt.worker_stats.items()},
           "launches": launches, "worker_launches": rt.worker_launches,
           "segments_seen": len(rt.segments_seen),
           "segments_left": len(left),
           "plan_vs_measured": report,
           "tokens_sha256": tokens_digest(admitted)}
    if problems:
        emit(dict(out, problems=problems))
        raise AssertionError(f"phase 12: {problems}")
    # the parent's weights only now: no worker holds any
    params = M.init_params(cfg, seed=SEED, device=dev)
    out["last_token_logit_gap_max"] = last_token_gap(cfg, params, dev,
                                                     admitted)
    out["first_token_gap_f32_max"], out["last_logits_bf16_vs_f32_max_abs"] = \
        first_token_yardstick(cfg, params, dev,
                              [p for p, r in zip(prompts, reqs)
                               if r.state != State.SHED], admitted)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# --------------------------------------------------------------------------- #
# phase 13: training
# --------------------------------------------------------------------------- #
def rel_err(got, want) -> float:
    """||got - want|| / ||want||, on ``got``'s device."""
    want = want.to(got.device).float()
    return float((got.float() - want).norm() / want.norm())


def phase13a(dev):
    """Parity at Qwen3-4B's full width cut to PHASE13_PARITY's layers:
    parameters drawn once on the CPU in float32 and copied to the card, one
    batch from SyntheticTokens(SEED); the loss and every leaf's gradient on
    the card against the CPU's (float32, TF32 off), then bf16 on the card
    (the same draw rounded) against the float32 CPU gradients. Every card
    gradient must be finite and nonzero, and no kernel may launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.train_step import device_batch, loss_and_grads
    from repro_torch.training.tree import leaves, leaves_with_paths, unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    pp = PHASE13_PARITY
    cfg = get_config(MODEL13).with_(num_layers=pp["layers"],
                                    param_dtype="float32",
                                    compute_dtype="float32")
    cpu_params = M.init_params(cfg, seed=SEED, device="cpu")
    paths = [p for p, _ in leaves_with_paths(cpu_params)]
    host = next(iter(SyntheticTokens(cfg, DataConfig(
        batch_size=pp["batch"], seq_len=pp["seq"], seed=SEED))))
    params = tree_to(cpu_params, dev)
    counts0 = ops.launch_counts()
    t0 = time.perf_counter()
    loss_d, g_d = loss_and_grads(cfg, params, device_batch(host, dev),
                                 remat=False)
    g_d = leaves(g_d)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, g_c = loss_and_grads(cfg, cpu_params, device_batch(host, "cpu"),
                                 remat=False)
    g_c = leaves(g_c)
    t_cpu = time.perf_counter() - t0
    rel32 = {p: rel_err(g, w) for p, g, w in zip(paths, g_d, g_c)}
    bad = [p for p, g in zip(paths, g_d)
           if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    c16 = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    p16 = unflatten(params, [p.to(torch.bfloat16) for p in leaves(params)])
    del params, g_d
    loss_h, g_h = loss_and_grads(c16, p16, device_batch(host, dev),
                                 remat=False)
    g_h = leaves(g_h)
    rel16 = {p: rel_err(g, w) for p, g, w in zip(paths, g_h, g_c)}
    bad += [p + " (bf16)" for p, g in zip(paths, g_h)
            if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    launched = ops.launch_counts() != counts0
    loss_d, loss_c, loss_h = float(loss_d), float(loss_c), float(loss_h)
    out = {"phase": 13, "part": "13a", "model": f"{cfg.name} x{cfg.num_layers}"
           " layers, float32 and bf16", "batch": [pp["batch"], pp["seq"]],
           "loss_card_f32": loss_d, "loss_cpu_f32": loss_c,
           "loss_card_bf16": loss_h,
           "loss_rel_err": abs(loss_d - loss_c) / abs(loss_c),
           "grad_rel_err_f32_max": max(rel32.values()),
           "grad_rel_err_f32": rel32, "f32_limit": PHASE13_F32_REL,
           "grad_rel_err_bf16_max": max(rel16.values()),
           "grad_rel_err_bf16": rel16, "bf16_limit": PHASE13_BF16_REL,
           "leaves_zero_or_nonfinite": bad, "launched": launched,
           "card_s": round(t_dev, 3), "cpu_s": round(t_cpu, 3)}
    del p16, g_h, cpu_params, g_c
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    emit(out)
    if bad:
        raise AssertionError(f"phase 13a: zero or non-finite gradients {bad}")
    if launched:
        raise AssertionError("phase 13a: training launched a kernel")
    if not out["loss_rel_err"] <= PHASE13_LOSS_RTOL:
        raise AssertionError(f"phase 13a: loss {loss_d} vs {loss_c}")
    if not out["grad_rel_err_f32_max"] <= PHASE13_F32_REL:
        raise AssertionError(f"phase 13a: float32 gradients {rel32}")
    if not out["grad_rel_err_bf16_max"] <= PHASE13_BF16_REL:
        raise AssertionError(f"phase 13a: bf16 gradients {rel16}")
    return out


def phase13_breakdown(cfg, state, opt, host, dev) -> dict:
    """Where a train step's time goes, on the trained state (which it
    changes): CUDA events around one micro-batch's forward and backward
    (remat), one AdamW update of the whole state (bf16 gradients, as the
    accumulator hands them over), and one layer's attention core (``sdpa``
    under the causal mask, bf16 in, float32 math) forward and backward at
    a micro-batch's shape, beside ``scaled_dot_product_attention`` on the
    same bf16 inputs (a yardstick, timed only). AdamW's bound: the bytes
    it must move (weights read and written in bf16, gradients read in
    bf16, both moments read and written in float32) over PEAK_BYTES."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.training import optim as O
    from repro_torch.training.train_step import device_batch, loss_and_grads
    from repro_torch.training.tree import leaves, tree_map
    micro = {k: v[:1] for k, v in device_batch(host, dev).items()}
    fwd_bwd = time_ms(lambda: loss_and_grads(cfg, state.params, micro),
                      iters=2, warmup=1)
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.bfloat16),
                     state.params)
    adamw = time_ms(lambda: O.adamw_update(opt, state.params, grads,
                                           state.opt), iters=2, warmup=1)
    n = sum(p.numel() for p in leaves(state.params))
    del grads
    s_len, h, kvh, hd = host["tokens"].shape[1], cfg.num_heads, \
        cfg.num_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(heads):
        return torch.randn((1, s_len, heads, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
    q, k, v = rnd(h), rnd(kvh), rnd(kvh)
    mask = L.causal_mask(s_len, s_len, device=dev)
    dout = torch.randn((1, s_len, h, hd), generator=gen, device=dev,
                       dtype=torch.bfloat16)

    def core_fwd():
        return L.sdpa(q, k, v, mask)

    def core_fwd_bwd():
        torch.autograd.grad(core_fwd(), (q, k, v), dout)

    def lib_fwd():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (q, k, v), dout.transpose(1, 2))
    attn_fwd = time_ms(core_fwd, iters=5, warmup=1)
    attn_fwd_bwd = time_ms(core_fwd_bwd, iters=5, warmup=1)
    lib = time_ms(lib_fwd, iters=5, warmup=1)
    lib_bwd = time_ms(lib_fwd_bwd, iters=5, warmup=1)
    layers, n_micro = cfg.num_layers, PHASE13_TRAIN["n_micro"]
    return {"micro_fwd_bwd_ms": fwd_bwd, "adamw_ms": adamw,
            "adamw_bound_ms": n * (2 + 2 + 2 + 8 + 8) / PEAK_BYTES * 1e3,
            "attn_core_fwd_ms": attn_fwd,
            "attn_core_fwd_bwd_ms": attn_fwd_bwd,
            # remat: each layer's forward runs twice, its backward once
            "attn_core_step_ms": n_micro * layers * (attn_fwd
                                                     + attn_fwd_bwd),
            "sdpa_library_fwd_ms": lib,
            "sdpa_library_fwd_bwd_ms": lib_bwd,
            "sdpa_library_step_ms": n_micro * layers * (lib + lib_bwd),
            "attn_shape": [1, s_len, h, kvh, hd]}


def first_update_prediction(opt, lr, paths, before, state, dev,
                            chunk=2 ** 26):
    """AdamW's first step recomputed in plain float32 from the weights
    before it (``before``, on the host) and the moments after it: with
    step 1, delta = (mu / (1-b1)) / (sqrt(nu / (1-b2)) + eps), plus weight
    decay on a leaf of ndim >= 2, and the new weight is bf16(p - lr x
    delta). Returns, per leaf, the share of elements whose predicted new
    weight differs from the old one (0: the leaf is predicted unchanged,
    every move below half a bf16 step at its value) and the share whose
    predicted new weight equals the card's. In chunks of ``chunk``
    elements, so the float32 temporaries stay small."""
    import torch
    from repro_torch.training.tree import leaves
    b1c, b2c = 1 - opt.b1, 1 - opt.b2
    moved, agree = {}, {}
    for path, b, p, mu, nu in zip(paths, before, leaves(state.params),
                                  leaves(state.opt["mu"]),
                                  leaves(state.opt["nu"])):
        n_moved = n_equal = 0
        for b_c, p_c, mu_c, nu_c in zip(b.reshape(-1).split(chunk),
                                        p.reshape(-1).split(chunk),
                                        mu.reshape(-1).split(chunk),
                                        nu.reshape(-1).split(chunk)):
            p0 = b_c.to(dev).float()
            delta = (mu_c / b1c) / (torch.sqrt(nu_c / b2c) + opt.eps)
            if b.dim() >= 2:
                delta = delta + opt.weight_decay * p0
            new = (p0 - lr * delta).to(b.dtype)
            n_moved += int((new != b_c.to(dev)).sum())
            n_equal += int((new == p_c).sum())
            del p0, delta, new
        moved[path] = n_moved / b.numel()
        agree[path] = n_equal / b.numel()
    return moved, agree


def phase13b(dev):
    """Qwen3-4B at full width and all 36 layers in bf16: the train state
    drawn on the card, ``make_train_step`` with remat and PHASE13_TRAIN's
    micro-batches, batches from SyntheticTokens(SEED), one warmup step then
    the timed ones. Checks: a finite loss every step and the last below the
    first by PHASE13_MIN_DROP; a finite, positive grad_norm; after the
    first step every leaf's first moment is nonzero (its gradient reached
    AdamW), and the leaves the step left unchanged are exactly those that
    ``first_update_prediction`` predicts from the data; no kernel
    launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import optim as O
    from repro_torch.training import train_step as T
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import leaves, leaves_with_paths
    t_phase = time.perf_counter()
    tr = PHASE13_TRAIN
    cfg = get_config(MODEL13)
    free, total = torch.cuda.mem_get_info()
    emit({"phase": 13, "part": "13b", "mem_get_info_gib":
          [free / 2 ** 30, total / 2 ** 30]})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = T.train_state_init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    paths = [p for p, _ in leaves_with_paths(state.params)]
    n_params = sum(p.numel() for p in leaves(state.params))
    opt = O.AdamWConfig(**PHASE13_OPT)
    step = T.make_train_step(cfg, opt, remat=True, n_micro=tr["n_micro"])
    data = iter(SyntheticTokens(cfg, DataConfig(
        batch_size=tr["batch"], seq_len=tr["seq"], seed=SEED)))
    before = [p.to("cpu", copy=True) for p in leaves(state.params)]
    counts0 = ops.launch_counts()
    losses, gnorms, lrs, secs = [], [], [], []
    changed = moment = None
    for i in range(tr["warmup"] + tr["timed"]):
        batch = T.device_batch(next(data), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if i == 0:
            changed = {p: float((a != b.to(dev)).sum()) / a.numel()
                       for p, a, b in zip(paths, leaves(state.params),
                                          before)}
            moment = {p: float(mu.abs().max()) for p, mu in
                      zip(paths, leaves(state.opt["mu"]))}
            predicted, agree = first_update_prediction(
                opt, lrs[0], paths, before, state, dev)
            del before
    counts1 = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = phase13_breakdown(cfg, state, opt, next(data), dev)
    timed = secs[tr["warmup"]:]
    step_s = float(np.median(timed))
    tokens = tr["batch"] * tr["seq"]
    still = sorted(p for p, f in changed.items() if f == 0)
    predicted_still = sorted(p for p, f in predicted.items() if f == 0)
    out = {"phase": 13, "part": "13b", "model": f"{cfg.name} x"
           f"{cfg.num_layers} layers {cfg.compute_dtype}",
           "params": n_params, "params_draw_s": round(t_draw, 3),
           "batch": [tr["batch"], tr["seq"]], "n_micro": tr["n_micro"],
           "remat": True, "opt": PHASE13_OPT, "losses": losses,
           "grad_norms": gnorms, "lrs": lrs, "step_s": secs,
           "step_s_median": step_s, "tokens_per_s": tokens / step_s,
           "max_memory_allocated_gib": peak,
           "first_step_changed_share": changed,
           "first_step_unchanged": still,
           "first_step_predicted_changed_share": predicted,
           "first_step_predicted_equal_share": agree,
           "first_moment_absmax": moment,
           "launches_before": counts0, "launches_after": counts1,
           "breakdown": breakdown}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    emit(out)
    if not all(np.isfinite(losses)) or \
            not losses[-1] <= losses[0] - PHASE13_MIN_DROP:
        raise AssertionError(f"phase 13b: losses {losses}")
    if not all(np.isfinite(gnorms)) or min(gnorms) <= 0:
        raise AssertionError(f"phase 13b: grad norms {gnorms}")
    if [p for p, v in moment.items() if not v > 0]:
        raise AssertionError(f"phase 13b: zero first moments {moment}")
    if still != predicted_still:
        raise AssertionError(f"phase 13b: leaves left unchanged by the "
                             f"first step {still}, predicted "
                             f"{predicted_still}")
    if counts1 != counts0:
        raise AssertionError(f"phase 13b: training launched kernels: "
                             f"{counts0} -> {counts1}")
    return out


def phase13c(dev):
    """A tiny bf16 train state on the card after one step, saved with the
    async writer, restored onto the card: every leaf bit-identical; the
    next step's loss from the restored state equals the continued one's
    within 1e-6."""
    import tempfile
    import torch
    from repro_torch.configs.base import config_from_dict
    from repro_torch.kernels import ops
    from repro_torch.training import optim as O
    from repro_torch.training import train_step as T
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import DataConfig, SyntheticTokens
    from repro_torch.training.tree import leaves
    t_phase = time.perf_counter()
    cfg = config_from_dict(PHASE13_CKPT_MODEL)
    state = T.train_state_init(cfg, seed=SEED, device=dev)
    step = T.make_train_step(cfg, O.AdamWConfig(lr=1e-3, warmup_steps=0))
    data = iter(SyntheticTokens(cfg, DataConfig(batch_size=4, seq_len=32,
                                                seed=SEED)))
    counts0 = ops.launch_counts()
    state, _ = step(state, T.device_batch(next(data), dev))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        mgr = CheckpointManager(d, keep=2)
        mgr.save(1, state, meta={"phase": 13})
        mgr.wait()
        restored = mgr.restore(1, like=T.abstract_train_state(cfg),
                               device=dev)
        dtypes = sorted({str(e.dtype) for e in leaves(restored)})
        mgr.writer.close()
    same = all(a.dtype == b.dtype and a.device == b.device
               and torch.equal(a, b)
               for a, b in zip(leaves(state), leaves(restored)))
    batch = T.device_batch(next(data), dev)
    _, m_cont = step(state, batch)
    _, m_rest = step(restored, batch)
    gap = abs(float(m_cont["loss"]) - float(m_rest["loss"]))
    launched = ops.launch_counts() != counts0
    out = {"phase": 13, "part": "13c", "model": cfg.name,
           "leaves": len(leaves(state)), "dtypes": dtypes,
           "bit_identical": same, "next_loss_gap": gap,
           "launched": launched,
           "phase_s": round(time.perf_counter() - t_phase, 3)}
    emit(out)
    if not same or not gap <= 1e-6 or "torch.bfloat16" not in dtypes:
        raise AssertionError(f"phase 13c: checkpoint round trip {out}")
    if launched:
        raise AssertionError("phase 13c: training launched a kernel")
    return out


def phase13(dev):
    """Training: 13a, 13b and 13c, each checking that it launched no
    kernel. Returns the phase's launches (all 0) and the parts' lines."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    parts = {"13a": phase13a(dev), "13b": phase13b(dev),
             "13c": phase13c(dev)}
    emit({"phase": 13, "phase_s": round(time.perf_counter() - t_phase, 3),
          "parts_s": {k: v.get("phase_s") for k, v in parts.items()}})
    return {"launches": ops.launch_counts(), **parts}


# --------------------------------------------------------------------------- #
# phase 14: the launch layer
# --------------------------------------------------------------------------- #
def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mem_line(dev, part: str, phase: int = 14) -> None:
    """``torch.cuda.mem_get_info()`` before a sub-phase, after freeing the
    last one's tensors."""
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.init()          # a phase alone: nothing ran before it
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        emit({"phase": phase, "part": part,
              "mem_get_info_gib": [free / 2 ** 30, total / 2 ** 30]})


def _peak_gib(dev):
    import torch
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)


@contextlib.contextmanager
def capture_calls(module, name: str, keep: float = 1, outputs: bool = False):
    """Records the arguments of the first ``keep`` calls of
    ``module.name`` (forwarded unchanged) in the yielded list, each with
    its output when ``outputs``."""
    real = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        if len(seen) < keep:
            seen.append((args, kwargs, out) if outputs else (args, kwargs))
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def expect_flash(part: str, launches, n: int, decode: int = 0) -> None:
    """The part launched flash exactly ``n`` times, flash_decode exactly
    ``decode`` times and no other kernel."""
    check_launched(14, launches, ("flash_attention", "flash_decode")
                   if decode else ("flash_attention",))
    if launches["flash_attention"] != n or \
            launches["flash_decode"] != decode:
        raise AssertionError(f"phase {part}: {launches['flash_attention']} "
                             f"flash and {launches['flash_decode']} "
                             f"flash_decode launches, the path makes {n} "
                             f"and {decode}")


def flash_call_of(call):
    """The flash call that a one-row ``ops.cache_attention`` call over a
    full-capacity cache (``call``: its captured (args, kwargs)) replaced:
    q, K and V transposed to (B, heads, rows, d), causal at its q_offset
    over all the cache's slots — the route before the one-row rule, timed
    as row 1d's reference."""
    (q, k, v, _), kw = call
    return ((q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            {"causal": True, "window": kw.get("window", 0),
             "q_offset": kw["q_offset"], "kv_len": k.shape[1]})


@contextlib.contextmanager
def one_row_flash_route():
    """The route before the one-row rule, to time beside it: within, every
    ``ops.cache_attention`` call goes to flash as ``flash_call_of`` lays
    it out (phase 14a's caches are all full-capacity bf16, where
    ``attention_decode`` sent one row to flash)."""
    from repro_torch.kernels import ops
    real = ops.cache_attention

    def route(q, k, v, pos, **kw):
        args, fkw = flash_call_of(((q, k, v, pos), kw))
        return ops.flash_attention(*args, **fkw).transpose(1, 2)

    ops.cache_attention = route
    try:
        yield
    finally:
        ops.cache_attention = real


def step_device_ms(srv, params, caches, fed, q_offset: int) -> float:
    """The device time of one serve step (the sum of its kernels' times
    under ``torch.profiler``), fed ``fed[0]`` at ``q_offset``; None when
    the profiler sees no device time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        io = {"tokens": fed[0],
              "positions": torch.full_like(fed[0], q_offset)}
        srv.fn(params, caches, io, q_offset=q_offset)
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages())
    return us / 1e3 if us > 0 else None


def phase14_turns(srv, params, caches, fed, q_offset: int, dev):
    """14a's decode steps fed ``fed`` on the route before the one-row rule
    (flash) and on the rule's (flash_decode) in turns over the same
    caches (``route_turns``; a copy of D's would take 9.7 GB), and one
    profiled step's device ms on each route."""
    routes = {"flash": one_row_flash_route,
              "flash_decode": contextlib.nullcontext}
    out = route_turns(srv, params, caches, fed, q_offset, dev, routes,
                      fresh=False)
    for name, ctx in routes.items():
        with ctx():
            out[f"{name}_device_ms"] = step_device_ms(srv, params, caches,
                                                      fed, q_offset)
    return out


def top2_gap_and_bound(logits):
    """Per row of (B, V) logits: (the top-2 gap, PHASE14_LOGIT_STEPS bf16
    steps at the row's largest magnitude) — a token that another route
    may pick differently where the gap is within the bound."""
    top2 = logits.float().topk(2, dim=-1).values
    return [(float(t[0] - t[1]), PHASE14_LOGIT_STEPS * bf16_step(row))
            for t, row in zip(top2, logits)]


def bf16_step(x) -> float:
    """One bfloat16 step (the spacing of bf16 values) at the largest
    magnitude in ``x``."""
    import math
    top = float(x.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def phase14_flash_row(dev, shape: str, call, rows: int = 0):
    """Flash at a shape the launch path gives it (``call``: the captured
    (args, kwargs) of one launch, q/k/v as the model passes them): its
    output's last ``rows`` query rows (all when 0) against the float32
    plain version by the yardstick (FLASH_VS_SDPA: max and mean error at
    most twice SDPA's on the same rows; SDPA with no backend for these
    dims fails the phase); then the kernel's times (events, graph replay,
    host), the plain version's on those rows, SDPA's at the full shape
    (k/v repeated to the query heads; ``is_causal`` from position 0, else
    a boolean mask) and the bound (the visible keys' products in bf16, or
    q, the visible K/V rows and o once each)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (q, k, v), kw = call
    b, h, sq, dk = q.shape
    kvh, dv = k.shape[1], v.shape[3]
    q_offset, kv_len = kw.get("q_offset", 0), kw.get("kv_len") or k.shape[2]
    scale = kw.get("scale")

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    rows = rows or sq
    qs = q[:, :, sq - rows:]
    ks, vs = k[:, :, :kv_len], v[:, :, :kv_len]

    def plain():
        return ref.flash_attention_ref(qs.float(), ks.float(), vs.float(),
                                       causal=True, scale=scale,
                                       q_offset=q_offset + sq - rows)

    grp = h // kvh
    kr = ks.repeat_interleave(grp, 1) if grp > 1 else ks
    vr = vs.repeat_interleave(grp, 1) if grp > 1 else vs
    mask = None if q_offset == 0 and sq == kv_len else \
        flash_mask(sq, kv_len, q_offset, 0, dev)

    def library():
        return F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask, is_causal=mask is None, scale=scale)

    ops.reset_launch_counts()
    got = kernel()[:, :, sq - rows:]
    want = plain()
    yard = _yardstick(f"14 flash {shape}", got, want,
                      library()[:, :, sq - rows:])
    del got, want
    t = time_all(kernel, plain, library, iters=3, plain_iters=2)
    visible = ops.flash_visible_keys(sq, kv_len, q_offset=q_offset)
    flops = 2.0 * b * h * visible * (dk + dv)
    nbytes = (q.numel() + b * h * sq * dv) * q.element_size() \
        + b * kvh * (visible // sq if sq == 1 else kv_len) * (dk + dv) \
        * k.element_size()
    t["bound_ms"], t["bound_by"] = bound(flops, nbytes, "bfloat16")
    t.update(shape=shape, q=list(q.shape), k=list(k.shape),
             v=list(v.shape), q_offset=q_offset, kv_len=kv_len,
             rows_checked=rows, **yard)
    return t


def phase14_roofline(mesh, arts, measured_s: float, tokens: int, mode: str):
    """``analyze_step`` of ``arts`` (the builder and the cell) on the meta
    mesh, once at full depth as the card runs it (flash's products are the
    visible keys'; caches updated in place counted once), on the nominal
    H100 SXM constants; beside the measured seconds."""
    from repro_torch.launch.mesh import shape_only
    from repro_torch.roofline import analysis as RA
    make, cell = arts
    a = make(cell, shape_only(mesh))
    terms = RA.analyze_step(a.fn, *a.abstract_args)
    secs = terms.seconds(RA.H100_SXM)
    return {"flops": terms.flops, "flash_flops": terms.flash_flops,
            "hbm_bytes": terms.hbm_bytes,
            "compute_s": secs["compute"], "memory_s": secs["memory"],
            "dominant": terms.dominant(RA.H100_SXM),
            "roofline_s": terms.step_time(RA.H100_SXM),
            "measured_s": measured_s,
            "measured_over_roofline": measured_s
            / terms.step_time(RA.H100_SXM),
            "useful_ratio": RA.useful_ratio(cell.arch, mode, tokens,
                                            terms.flops),
            "hw": f"{RA.H100_SXM.name} nominal "
                  f"({RA.H100_SXM.peak_flops:.4g} FLOP/s, "
                  f"{RA.H100_SXM.hbm_bw:.4g} B/s)"}


def phase14a(dev):
    """Qwen3-4B: the launch prefill (2 x 32,768) → handoff → 4 greedy
    decode steps through the step builders on the one-card mesh. Checks:
    exactly 36 flash launches (the prefill) and 4 x 36 flash_decode
    launches (each step's one-row attention); D's caches bf16, equal to P's bit
    for bit in slots 0..32,767 and pos -1 in the 128 pad slots; every
    logit finite; the one-shot prefill's last logits within
    PHASE14_LOGIT_STEPS bf16 steps of a chunked prefill (``decode_step``
    in 512-token chunks over a full-capacity cache: 64 chunks through the
    q_offset flash route; the same kernel as the one-shot, so this holds
    the launch path and not the kernel), the argmax equal or the one-shot
    top-2 gap within the bound; layer 0's 32k flash call's last 512 rows
    against the plain version by the yardstick (``phase14_flash_row``;
    also flash on the decode step's first one-row call, row 1d: the
    route before the one-row rule, beside phase 1's row 1q); the decode
    steps on that route and on the one-row rule's in turns
    (``phase14_turns``)."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    t_part = time.perf_counter()
    _mem_line(dev, "14a")
    if dev.type == "cuda":         # built in phase 0; alone, build first
        from repro_torch.kernels import _build
        _build.load()
    b = PHASE14_BATCH["14a"]
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    cell_p = dc.replace(get_cell(MODEL14, "prefill_32k"), batch=b)
    cell_d = dc.replace(get_cell(MODEL14, "decode_32k"), batch=b)
    pre = S.make_prefill_artifacts(cell_p, mesh)
    srv = S.make_serve_artifacts(cell_d, mesh)
    ho = S.make_handoff_artifacts(MODEL14, mesh, batch=b)
    cfg = pre.cfg
    s = cell_p.seq_len
    params = M.init_params(cfg, seed=SEED, device=dev)
    inputs = S.random_inputs(pre.abstract_args[1], cfg.vocab_size, SEED, dev)
    ops.reset_launch_counts()
    with torch.no_grad(), capture_calls(ops, "flash_attention") as pf:
        _sync(dev)
        t0 = time.perf_counter()
        last, caches_p = pre.fn(params, inputs)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        caches_d = ho.fn(caches_p)
        _sync(dev)
        handoff_s = time.perf_counter() - t0
    bad = []
    for cp, cd in zip((c for g in caches_p for c in g),
                      (c for g in caches_d for c in g)):
        if not (cd.k.dtype == cd.v.dtype == torch.bfloat16
                and cd.full_capacity
                and cd.k.shape[2] == cell_d.decode_capacity()
                and torch.equal(cd.k[:, :, :s], cp.k)
                and torch.equal(cd.v[:, :, :s], cp.v)
                and torch.equal(cd.pos[:, :, :s], cp.pos)
                and bool((cd.pos[:, :, s:] == -1).all())):
            bad.append(tuple(cd.k.shape))
    del caches_p
    gc.collect()
    tok = last.argmax(-1).to(torch.int32)[:, None]
    steps_ms, tokens = [], [tok]
    gaps = [top2_gap_and_bound(last)]       # phase 18a's token rule
    with torch.no_grad(), capture_calls(ops, "cache_attention") as df:
        for i in range(PHASE14_DECODE_STEPS):
            io = {"tokens": tok, "positions": torch.full_like(tok, s + i)}
            _sync(dev)
            t0 = time.perf_counter()
            logits, caches_d = srv.fn(params, caches_d, io, q_offset=s + i)
            _sync(dev)
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            tokens.append(tok)
            gaps.append(top2_gap_and_bound(logits[:, -1]))
            if not bool(torch.isfinite(logits).all()):
                bad.append(f"decode step {i}: non-finite logits")
    launches = ops.launch_counts()
    peak_main = _peak_gib(dev)
    flash_d = phase14_flash_row(dev, "decode_32k", flash_call_of(df[0]))
    del df                         # df[0] holds views of D's caches
    turns = phase14_turns(srv, params, caches_d, tokens[:-1], s, dev)
    del caches_d
    gc.collect()
    # the chunked cross-check: the same parameters and tokens
    c = PHASE14_CHECK_CHUNK
    with torch.no_grad():
        caches_c = M.init_caches(cfg, b, s, full_capacity=True, device=dev)
        for i in range(0, s, c):
            pos = torch.arange(i, i + c, dtype=torch.int32,
                               device=dev)[None].expand(b, c)
            lc, caches_c = M.decode_step(params, cfg,
                                         inputs["tokens"][:, i:i + c], pos,
                                         caches_c, q_offset=i)
        chunked = lc[:, -1].float()
        del caches_c, lc
    one = last.float()
    gap = float((one - chunked).abs().max())
    logit_bound = PHASE14_LOGIT_STEPS * bf16_step(one)
    top2 = one.topk(2, dim=-1).values
    same = (one.argmax(-1) == chunked.argmax(-1)).tolist()
    top2_gap = (top2[:, 0] - top2[:, 1]).tolist()
    finite = bool(torch.isfinite(one).all())
    peak_check = _peak_gib(dev)
    flash_p = phase14_flash_row(dev, "prefill_32k", pf[0],
                                PHASE14_FLASH_ROWS)
    del pf
    roof_p = phase14_roofline(mesh, (S.make_prefill_artifacts, cell_p),
                              prefill_s, b * s, "prefill")
    roof_d = phase14_roofline(mesh, (S.make_serve_artifacts, cell_d),
                              float(np.median(steps_ms)) / 1e3, b, "decode")
    out = {"phase": 14, "part": "14a",
           "model": f"{cfg.name} x{cfg.num_layers} layers "
                    f"{cfg.compute_dtype}", "batch": b, "seq_len": s,
           "decode_capacity": cell_d.decode_capacity(),
           "prefill_s": prefill_s, "prefill_tokens_per_s": b * s / prefill_s,
           "handoff_s": handoff_s, "decode_ms": steps_ms,
           "decode_ms_per_step": float(np.median(steps_ms)),
           "decode_turns_ms_per_step": turns,
           "tokens": torch.cat(tokens, 1).tolist(),
           "flash_launches": launches.get("flash_attention", 0),
           "flash_decode_launches": launches.get("flash_decode", 0),
           "launches": launches, "peak_gib": peak_main,
           "peak_gib_with_check": peak_check,
           "max_abs_logit_gap": gap, "logit_bound": logit_bound,
           "argmax_equal": same,
           "one_shot_top2_gap": top2_gap, "logits_finite": finite,
           "flash_prefill_32k": flash_p, "flash_decode_32k": flash_d,
           "roofline_prefill": roof_p, "roofline_decode": roof_d,
           "problems": bad, "predicted": PHASE14_PREDICTED["14a"]}
    kept = {"last_logits": last.float().cpu(), "token_gaps": gaps}
    del params, inputs, last
    out["part_s"] = round(time.perf_counter() - t_part, 3)
    emit(out)
    if bad:
        raise AssertionError(f"phase 14a: {bad}")
    expect_flash("14a", launches, cfg.num_layers,
                 cfg.num_layers * PHASE14_DECODE_STEPS)
    if not finite:
        raise AssertionError("phase 14a: non-finite prefill logits")
    for ok, g in zip(same, top2_gap):
        if not ok and not g <= logit_bound:
            raise AssertionError(f"phase 14a: argmax differs with a top-2 "
                                 f"gap of {g} > {logit_bound}")
    if not gap <= logit_bound:
        raise AssertionError(f"phase 14a: one-shot vs chunked last logits "
                             f"differ by {gap} > {logit_bound}")
    return {"launches": launches, "timing": {"launch_p": flash_p,
                                             "launch_d": flash_d},
            **out, **kept}


def phase14b(dev):
    """DeepSeek-V2-Lite's launch prefill at 1 x 32,768: expanded-MLA flash
    (dk 192 / dv 128) and the capacity MoE under ``moe_shard_map``.
    Checks: 27 flash launches and no other kernel; finite logits; then
    2 layers (one dense, one MoE) at the same widths and 4,096 tokens under
    a one-card ``DistContext`` at capacity factor 8.0 (no pair dropped)
    against the serving path's exact ``moe_experts`` on the same
    parameters, within PHASE14_LOGIT_STEPS bf16 steps of the logits'
    largest magnitude; the MLA flash call's last 512 rows against the
    plain version by the yardstick. Prints the share of routed
    pairs each MoE layer's windows drop, from the group sizes read after
    the run."""
    import dataclasses as dc
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import dist
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    t_part = time.perf_counter()
    _mem_line(dev, "14b")
    b = PHASE14_BATCH["14b"]
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    cell = dc.replace(get_cell(MODEL14B, "prefill_32k"), batch=b)
    pre = S.make_prefill_artifacts(cell, mesh)
    cfg = pre.cfg
    s = cell.seq_len
    params = M.init_params(cfg, seed=SEED, device=dev)
    inputs = S.random_inputs(pre.abstract_args[1], cfg.vocab_size, SEED, dev)
    sizes = []
    real_capacity = L._moe_mlp_capacity

    routes = []

    def traced(p, cfg_, x, capacity_factor=1.25, **kw):
        _, idx = L.moe_route(p, cfg_, x.reshape(-1, x.shape[-1]))
        flat = idx.reshape(-1)
        sizes.append((torch.zeros(cfg_.moe.num_experts, dtype=torch.int64,
                                  device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat)), x.reshape(-1, x.shape[-1])
            .shape[0], capacity_factor))
        routes.append(idx.to(torch.int8).cpu())
        return real_capacity(p, cfg_, x, capacity_factor=capacity_factor,
                             **kw)

    ops.reset_launch_counts()
    L._moe_mlp_capacity = traced
    try:
        with torch.no_grad(), capture_calls(ops, "flash_attention") as kf:
            _sync(dev)
            t0 = time.perf_counter()
            last, caches = pre.fn(params, inputs)
            _sync(dev)
            prefill_s = time.perf_counter() - t0
    finally:
        L._moe_mlp_capacity = real_capacity
    launches = ops.launch_counts()
    peak = _peak_gib(dev)
    finite = bool(torch.isfinite(last).all())
    dropped, drops = [], []
    for g, t, cf in sizes:
        cap = L.moe_capacity(cfg, t, cf)
        drops.append(L.moe_capacity_drops(g.tolist(), cap))
        dropped.append(drops[-1] / (t * cfg.moe.top_k))
    kept = {"last_logits": last.float().cpu(), "drops": drops,
            "routes": list(routes)}
    routes.clear()
    del caches, last
    flash_k = phase14_flash_row(dev, "mla_prefill_32k", kf[0],
                                PHASE14_FLASH_ROWS)
    del kf, params, inputs
    gc.collect()
    # the reduced-depth parity of the capacity MoE
    pr = PHASE14B_PARITY
    cfg2 = cfg.with_(num_layers=pr["layers"])
    p2 = M.init_params(cfg2, seed=SEED, device=dev)
    toks = S.random_inputs({"tokens": torch.empty(
        (1, pr["seq"]), dtype=torch.int32, device="meta")},
        cfg.vocab_size, SEED + 1, dev)["tokens"]
    sizes.clear()
    ctx = dist.DistContext(mesh=mesh, dp_axes=("data",), model_axis="model",
                           moe_shard_map=True,
                           moe_capacity_factor=pr["capacity_factor"])
    L._moe_mlp_capacity = traced
    try:
        with torch.no_grad(), dist.use(ctx):
            cap_last, _ = M.prefill(p2, cfg2, {"tokens": toks}, M.init_caches(
                cfg2, 1, pr["seq"], device=dev))
    finally:
        L._moe_mlp_capacity = real_capacity
    with torch.no_grad():
        exact_last, _ = M.prefill(p2, cfg2, {"tokens": toks}, M.init_caches(
            cfg2, 1, pr["seq"], device=dev))
    parity_drops = [L.moe_capacity_drops(g.tolist(),
                                         L.moe_capacity(cfg2, t, cf))
                    for g, t, cf in sizes]
    parity = float((cap_last.float() - exact_last.float()).abs().max())
    parity_bound = PHASE14_LOGIT_STEPS * bf16_step(exact_last)
    parity_argmax = bool((cap_last.argmax(-1) == exact_last.argmax(-1))
                         .all())
    del p2, cap_last, exact_last
    out = {"phase": 14, "part": "14b",
           "model": f"{cfg.name} x{cfg.num_layers} layers "
                    f"{cfg.compute_dtype}", "batch": b, "seq_len": s,
           "prefill_s": prefill_s, "prefill_tokens_per_s": b * s / prefill_s,
           "flash_launches": launches.get("flash_attention", 0),
           "launches": launches, "peak_gib": peak, "logits_finite": finite,
           "moe_capacity": L.moe_capacity(cfg, b * s),
           "dropped_share_by_layer": dropped,
           "parity": {"layers": pr["layers"], "seq": pr["seq"],
                      "capacity_factor": pr["capacity_factor"],
                      "max_abs_logit_gap": parity, "bound": parity_bound,
                      "argmax_equal": parity_argmax,
                      "dropped_pairs": parity_drops},
           "flash_mla_prefill_32k": flash_k,
           "predicted": PHASE14_PREDICTED["14b"]}
    out["part_s"] = round(time.perf_counter() - t_part, 3)
    emit(out)
    expect_flash("14b", launches, cfg.num_layers)
    if not finite:
        raise AssertionError("phase 14b: non-finite logits")
    if len(dropped) != cfg.num_layers - cfg.moe.first_dense_layers:
        raise AssertionError(f"phase 14b: {len(dropped)} capacity MoE calls")
    if any(parity_drops) or len(parity_drops) != 1:
        raise AssertionError(f"phase 14b: the parity run dropped pairs "
                             f"{parity_drops}")
    if not parity <= parity_bound:
        raise AssertionError(f"phase 14b: capacity MoE vs exact: {parity} > "
                             f"{parity_bound}")
    return {"launches": launches, "timing": {"launch_k": flash_k}, **out,
            **kept}


def phase14c(dev):
    """Qwen3-4B's train_4k through ``make_train_artifacts`` at 2 x 4,096
    tokens in 2 micro-batches: one warmup and PHASE14C_TRAIN's timed
    steps. Checks: finite loss and grad_norm, grad_norm > 0, no kernel
    launched, ``chunked_sdpa`` not called (chunk_kv 8192 > 4096). Prints
    the MFU: ``model_flops`` (6·N·D) over the step seconds and the nominal
    989.4 TFLOP/s."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.roofline import analysis as RA
    from repro_torch.training.train_step import train_state_init
    t_part = time.perf_counter()
    _mem_line(dev, "14c")
    b = PHASE14_BATCH["14c"]
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    cell = dc.replace(get_cell(MODEL14, "train_4k"), batch=b, n_micro=2)
    art = S.make_train_artifacts(cell, mesh)
    state = train_state_init(art.cfg, seed=SEED, device=dev)
    tokens = b * cell.seq_len
    flops = RA.model_flops(MODEL14, "train", tokens)
    ops.reset_launch_counts()
    secs, losses, gnorms = [], [], []
    with capture_calls(L, "chunked_sdpa") as chunked:
        for i in range(PHASE14C_TRAIN["warmup"] + PHASE14C_TRAIN["timed"]):
            batch = S.random_inputs(art.abstract_args[1], art.cfg.vocab_size,
                                    SEED + i, dev)
            _sync(dev)
            t0 = time.perf_counter()
            state, m = art.fn(state, batch)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    launches = ops.launch_counts()
    peak = _peak_gib(dev)
    timed = secs[PHASE14C_TRAIN["warmup"]:]
    step_s = float(np.median(timed))
    del state
    out = {"phase": 14, "part": "14c", "model": f"{art.cfg.name} x"
           f"{art.cfg.num_layers} layers {art.cfg.compute_dtype}",
           "batch": [b, cell.seq_len], "n_micro": cell.n_micro,
           "step_s": secs, "step_s_median": step_s,
           "tokens_per_s": tokens / step_s, "losses": losses,
           "grad_norms": gnorms, "peak_gib": peak,
           "model_flops": flops, "mfu": flops / step_s / RA.H100_SXM.peak_flops,
           "mfu_peak": f"{RA.H100_SXM.name} nominal "
                       f"{RA.H100_SXM.peak_flops:.4g} FLOP/s",
           "chunked_sdpa_calls": len(chunked), "launches": launches,
           "predicted": PHASE14_PREDICTED["14c"]}
    out["part_s"] = round(time.perf_counter() - t_part, 3)
    emit(out)
    if not (all(np.isfinite(losses)) and all(np.isfinite(gnorms))
            and min(gnorms) > 0):
        raise AssertionError(f"phase 14c: losses {losses}, grad norms "
                             f"{gnorms}")
    if any(launches.values()):
        raise AssertionError(f"phase 14c: training launched {launches}")
    if chunked:
        raise AssertionError("phase 14c: chunked_sdpa ran at 4,096 tokens")
    return {"launches": launches, **out}


def phase14(dev):
    """The launch layer: 14a, 14b and 14c. Returns the summed launches of
    14a's and 14b's main paths and the flash rows' timings."""
    t_phase = time.perf_counter()
    parts = {"14a": phase14a(dev), "14b": phase14b(dev)}
    parts["14c"] = phase14c(dev)
    launches = collections.Counter()
    timing = {}
    for part in parts.values():
        launches.update(part["launches"])
        timing.update(part.get("timing", {}))
    emit({"phase": 14, "phase_s": round(time.perf_counter() - t_phase, 3),
          "parts_s": {k: v["part_s"] for k, v in parts.items()}})
    # what phase 18 holds 18b to (18a has a one-card run of its own cut)
    held = {k: {f: parts[k][f] for f in parts[k] if f in (
        "last_logits", "drops", "routes")} for k in ("14b",)}
    return {"launches": dict(launches), "timing": timing, "held": held}


# --------------------------------------------------------------------------- #
# phase 15: ring-buffer and float8 decode caches (the flash_decode kernel)
# --------------------------------------------------------------------------- #
def map_caches(caches, fn):
    """The cache tree with ``fn`` applied to every tensor leaf (flags such
    as ``full_capacity`` kept)."""
    import torch
    from repro_torch.training.tree import leaves_with_paths, unflatten
    return unflatten(caches, [fn(x) if isinstance(x, torch.Tensor) else x
                              for _, x in leaves_with_paths(caches)])


def full_capacity_copy(caches, capacity: int):
    """D's caches with every ring re-laid as a full-capacity cache of
    ``capacity`` slots (each entry at slot == its position, pos -1
    elsewhere), the other leaves (recurrent states) copied: the same
    prefill handed into caches whose chunks the flash route reads (a
    one-row step takes flash_decode on them too)."""
    from repro_torch.models import layers as L
    out = []
    for group in caches:
        row = []
        for c in group:
            if isinstance(c, L.KVCache) and not c.full_capacity:
                count, b, _, kvh, hd = c.k.shape
                f = L.kv_cache_init(b, capacity, kvh, hd, c.k.dtype,
                                    c.k.device, count=count,
                                    full_capacity=True)
                for i in range(count):    # a ring after 32k: every tag >= 0
                    L._kv_cache_put(f.layer(i), c.k[i], c.v[i], c.pos[i])
                row.append(f)
            else:
                row.append(map_caches(c, lambda x: x.clone()))
        out.append(tuple(row))
    return tuple(out)


@contextlib.contextmanager
def plain_route():
    """Attention on the plain route (``sdpa`` under the reference's masks)
    on CUDA tensors too: the phase's yardstick route."""
    from repro_torch.models import layers as L
    real = L.kernel_route
    L.kernel_route = lambda x: False
    try:
        yield
    finally:
        L.kernel_route = real


def decode_steps(srv, params, caches, tokens, q_offset, dev, feed=None,
                 hold=None):
    """len(feed) or PHASE15_DECODE_STEPS serve steps from ``tokens`` (B, 1)
    at ``q_offset``..: greedy, or fed ``feed`` (a list of (B, 1) tokens,
    the first of which is ``tokens``). With ``hold``, each step's
    ``ops.cache_attention`` calls (arguments and output) go to
    ``hold(calls)`` right after the step, outside its time, while nothing
    has written the caches since: each call's exact inputs. Returns
    (float32 logits of each step, the tokens fed, ms a step)."""
    import torch
    from repro_torch.kernels import ops
    logits_all, fed, ms = [], [], []
    tok = tokens
    n = len(feed) if feed is not None else PHASE15_DECODE_STEPS
    with torch.no_grad():
        for i in range(n):
            if feed is not None:
                tok = feed[i]
            fed.append(tok)
            io = {"tokens": tok, "positions": torch.full_like(tok,
                                                              q_offset + i)}
            spy = (capture_calls(ops, "cache_attention", math.inf, True)
                   if hold is not None else contextlib.nullcontext([]))
            with spy as seen:
                _sync(dev)
                t0 = time.perf_counter()
                logits, caches = srv.fn(params, caches, io,
                                        q_offset=q_offset + i)
                _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if hold is not None:
                hold(seen)
                del seen
            logits_all.append(logits[:, -1].float())
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    return logits_all, fed, ms


def logit_gaps(got, want):
    """Per step: the max abs gap, its bound (PHASE15_LOGIT_STEPS bf16 steps
    at ``got``'s largest magnitude) and whether every argmax agrees."""
    out = []
    for g, w in zip(got, want):
        out.append({"gap": float((g - w).abs().max()),
                    "bound": PHASE15_LOGIT_STEPS * bf16_step(g),
                    "argmax_equal": bool((g.argmax(-1)
                                          == w.argmax(-1)).all())})
    return out


def f32_steps(cell, mesh, over, params, caches, fed, q_offset, dev):
    """The same steps in float32: the serve step of the config with a
    float32 compute dtype on the same bf16 weights (each cast at its use),
    on the plain route (float32 scores over the cache widened), from
    ``caches`` (a copy of D's, the same bytes), fed ``fed``."""
    from repro_torch.launch import steps as S
    srv32 = S.make_serve_artifacts(
        cell, mesh, layer_override={**over, "compute_dtype": "float32"})
    with plain_route():
        truth, _, _ = decode_steps(srv32, params, caches, None, q_offset, dev,
                                   feed=fed)
    return truth


def yardstick(got, plain, truth):
    """Per step: the route's max and mean error against the float32 steps,
    beside the plain bf16 route's (the yardstick: FLASH_VS_SDPA x those)."""
    out = []
    for g, p, t in zip(got, plain, truth):
        e, ep = (g - t).abs(), (p - t).abs()
        out.append({"max_abs_err": float(e.max()),
                    "mean_abs_err": float(e.mean()),
                    "plain_max_abs_err": float(ep.max()),
                    "plain_mean_abs_err": float(ep.mean())})
    return out


def check_yardstick(part: str, what: str, ys) -> None:
    for i, y in enumerate(ys):
        if not (y["max_abs_err"] <= FLASH_VS_SDPA * y["plain_max_abs_err"]
                and y["mean_abs_err"]
                <= FLASH_VS_SDPA * y["plain_mean_abs_err"]):
            raise AssertionError(f"phase {part}: {what} at step {i}: errors "
                                 f"against the float32 steps exceed "
                                 f"{FLASH_VS_SDPA}x the plain route's: {y}")


def hold_layer_calls(calls) -> dict:
    """Each recorded ``ops.cache_attention`` call of a step (one a layer
    that attends) held on its exact inputs to the float32 plain
    version by the yardstick: its max and mean error at most
    FLASH_VS_SDPA x those of ``decode_library`` (SDPA in bf16) on the same
    values. Returns the worst ratios over the layers and the calls that
    failed (checked by ``check_layers``)."""
    from repro_torch.kernels import ref
    ratios, failed = [], []
    for i, ((q, k, v, pos), kw, out) in enumerate(calls):
        want = ref.cache_attention_ref(q.float(), k.float(), v.float(), pos,
                                       **kw)
        library, _ = decode_library(q, k, v, pos, kw["q_offset"],
                                    kw.get("window", 0))
        yard = _yard_errors(out, want, library())
        del want, library
        ratios.append(tuple(
            yard[e] / yard["sdpa_" + e] if yard["sdpa_" + e] > 0
            else 0.0 if yard[e] == 0 else math.inf
            for e in ("max_abs_err", "mean_abs_err")))
        if not _within_yard(yard):
            failed.append({"layer": i, **yard})
    return {"calls": len(calls), "limit": FLASH_VS_SDPA,
            "worst_max_ratio": max(r[0] for r in ratios),
            "worst_mean_ratio": max(r[1] for r in ratios),
            "failed": failed}


def holder():
    """A ``hold`` for ``decode_steps`` that holds each step's calls
    (``hold_layer_calls``), and the summary of all of them so far: calls,
    the worst ratios, and the failed calls by step."""
    out = {"calls": 0, "steps": [], "limit": FLASH_VS_SDPA,
           "worst_max_ratio": 0.0, "worst_mean_ratio": 0.0, "failed": []}

    def hold(calls):
        h = hold_layer_calls(calls)
        out["failed"] += [{"step": len(out["steps"]), **f}
                          for f in h["failed"]]
        out["steps"].append(h["calls"])
        out["calls"] += h["calls"]
        for k in ("worst_max_ratio", "worst_mean_ratio"):
            out[k] = max(out[k], h[k])

    return hold, out


def check_layers(part: str, held: dict, want: int) -> None:
    if held["calls"] != want or held["failed"]:
        raise AssertionError(f"phase {part}: flash_decode on the main path "
                             f"against the float32 plain version "
                             f"({held['calls']} calls held, the path makes "
                             f"{want}): {held['failed']}")


def route_turns(srv, params, caches, fed, q_offset: int, dev,
                routes=None, fresh: bool = True):
    """The decode steps fed ``fed`` on two routes in turns (a, b, b, a):
    ``routes`` maps each name to the context that selects it (default
    the plain route, then the kernel route). Each run starts from a fresh
    copy of ``caches`` when ``fresh``, else from ``caches`` themselves
    (each run rewrites the same slots). Returns each run's median ms a
    step, by route."""
    import numpy as np
    routes = routes or {"plain": plain_route,
                        "kernel": contextlib.nullcontext}
    (a, ctx_a), (b, ctx_b) = routes.items()
    out = {a: [], b: []}
    for name, ctx in ((a, ctx_a), (b, ctx_b), (b, ctx_b), (a, ctx_a)):
        run = map_caches(caches, lambda x: x.clone()) if fresh else caches
        with ctx():
            _, _, ms = decode_steps(srv, params, run, None, q_offset, dev,
                                    feed=fed)
        out[name].append(float(np.median(ms)))
        del run
    return out


def expect_decode(part: str, launches, flash: int, decode: int) -> None:
    """The part's main path launched exactly ``flash`` flash and
    ``decode`` flash_decode kernels and no other."""
    check_launched(15, launches, ("flash_attention", "flash_decode")
                   if flash else ("flash_decode",))
    if launches["flash_attention"] != flash or \
            launches["flash_decode"] != decode:
        raise AssertionError(f"phase {part}: launches {launches}, the path "
                             f"makes {flash} flash and {decode} flash_decode")


def attending_layers(cfg) -> int:
    from repro_torch.models import model as M
    return sum(g.count * sum(k == M.ATTN for k in g.kinds)
               for g in M.block_groups(cfg))


def f8_cast_table(dev):
    """The CPU's e4m3 cast of every bf16 bit pattern, as a 65,536-entry
    byte table on ``dev`` (saturating past +-448, as torch casts)."""
    import torch
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    return x.to(torch.float8_e4m3fn).view(torch.uint8).to(dev)


def d_equals_cpu_cast(caches_p, caches_d, s: int, table) -> list:
    """D's float8 caches against the CPU's cast of P's bf16 caches, byte
    for byte in slots 0..s-1 (each element looked up in ``table``), the
    tags equal and -1 in the pad slots, K/V zero there. Returns the
    problems found."""
    import torch
    bad = []
    for cp, cd in zip((c for g in caches_p for c in g),
                      (c for g in caches_d for c in g)):
        if cd.k.dtype != torch.float8_e4m3fn or not cd.full_capacity:
            bad.append(f"D cache {cd.k.dtype} full={cd.full_capacity}")
            continue
        for name in ("k", "v"):
            src, dst = getattr(cp, name), getattr(cd, name)
            for i in range(src.shape[0]):
                for b in range(src.shape[1]):
                    idx = src[i, b].view(torch.int16).to(torch.int32) & 0xffff
                    if not torch.equal(table[idx],
                                       dst[i, b, :s].view(torch.uint8)):
                        bad.append(f"{name} layer {i} seq {b}: bytes differ")
                    del idx
            if bool(dst[:, :, s:].view(torch.uint8).any()):
                bad.append(f"{name}: nonzero pad slots")
        if not (torch.equal(cd.pos[:, :, :s], cp.pos)
                and bool((cd.pos[:, :, s:] == -1).all())):
            bad.append("pos differ")
    return bad


def phase15_part(dev, part: str):
    """One of 15a-15c: ``PHASE15_MODELS[part]`` at full width through the
    step builders on the one-card mesh at batch 2: prefill_32k → handoff
    → PHASE15_DECODE_STEPS greedy decode_32k steps (the main path: flash
    per attending layer in the prefill, flash_decode per attending layer
    a step, nothing else). Every step's flash_decode calls are held, right
    after the step, on their exact inputs to the float32 plain version by
    the SDPA yardstick (``holder``, ``hold_layer_calls``). Then the same
    steps from copies of D's caches taken before them, fed the main
    path's tokens: on the plain route in bf16 and in float32 (the logits'
    yardstick, ``check_yardstick``) and, for a ring (15b, 15c), from a
    full-capacity copy (through flash_decode as well: the same kernel
    over the other slot order; its gaps and argmax printed). 15c then
    times the steps on both routes in turns (``route_turns``). 15a
    also holds D's bytes to the CPU's e4m3 cast of P's caches. The
    launches are counted from the prefill to the last decode step (the
    checks and copies in between launch none). 15b and 15c return a
    batch-1 slice of D's caches for 15d. Returns the launches, the part's
    seconds and, on the host, what phase 19 holds its mesh run to: the
    prefill's last logits, the tokens and each token's top-2 gap, and for
    15b and 15c 15d's logits and the token it was fed."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    t_part = time.perf_counter()
    _mem_line(dev, part, 15)
    if dev.type == "cuda":         # built in phase 0; alone, build first
        from repro_torch.kernels import _build
        _build.load()
    arch, layers = PHASE15_MODELS[part]
    b = PHASE15_BATCH
    over = {"num_layers": layers}
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    cell_p = dc.replace(get_cell(arch, "prefill_32k"), batch=b)
    cell_d = dc.replace(get_cell(arch, "decode_32k"), batch=b)
    pre = S.make_prefill_artifacts(cell_p, mesh, layer_override=over)
    srv = S.make_serve_artifacts(cell_d, mesh, layer_override=over)
    ho = S.make_handoff_artifacts(arch, mesh, layer_override=over, batch=b)
    cfg = pre.cfg
    s = cell_p.seq_len
    attn = attending_layers(cfg)
    params = M.init_params(cfg, seed=SEED, device=dev)
    inputs = S.random_inputs(pre.abstract_args[1], cfg.vocab_size, SEED, dev)
    bad = []
    ops.reset_launch_counts()
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        last, caches_p = pre.fn(params, inputs)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        caches_d = ho.fn(caches_p)
        _sync(dev)
        handoff_s = time.perf_counter() - t0
    kv = [c for g in caches_d for c in g if hasattr(c, "full_capacity")]
    ring = any(not c.full_capacity for c in kv)
    cast_ok = None
    if cell_d.cache_dtype == "float8_e4m3fn":
        with torch.no_grad():
            cast_bad = d_equals_cpu_cast(caches_p, caches_d, s,
                                         f8_cast_table(dev))
        bad += cast_bad
        cast_ok = not cast_bad
    del caches_p
    gc.collect()
    # the copies the yardsticks decode from, taken before D's caches move
    plain_caches = map_caches(caches_d, lambda x: x.clone())
    f32_caches = map_caches(caches_d, lambda x: x.clone())
    full_caches = (full_capacity_copy(caches_d, cell_d.decode_capacity())
                   if ring else None)
    turn_caches = (map_caches(caches_d, lambda x: x.clone())
                   if part in PHASE15_TURNS else None)
    long_caches = (map_caches(caches_d, lambda x: x[:, :1].clone())
                   if ring else None)
    tok = last.argmax(-1).to(torch.int32)[:, None]
    hold, held = holder()
    got, fed, steps_ms = decode_steps(srv, params, caches_d, tok, s, dev,
                                      hold=hold)
    kept = {"last_logits": last.float().cpu(),
            "token_gaps": [top2_gap_and_bound(x) for x in [last] + got]}
    launches = ops.launch_counts()
    peak_main = _peak_gib(dev)
    for i, g in enumerate(got):
        if not bool(torch.isfinite(g).all()):
            bad.append(f"decode step {i}: non-finite logits")
    del caches_d
    out = {"phase": 15, "part": part,
           "model": f"{cfg.name} x{cfg.num_layers} layers "
                    f"{cfg.compute_dtype}",
           "batch": b, "seq_len": s, "attending_layers": attn,
           "d_cache": {"dtype": cell_d.cache_dtype, "ring": ring,
                       "slots": kv[0].capacity},
           "prefill_s": prefill_s, "handoff_s": handoff_s,
           "decode_ms": steps_ms,
           "decode_ms_per_step": float(np.median(steps_ms)),
           "tokens": torch.cat(fed + [got[-1].argmax(-1).to(torch.int32)
                                       [:, None]], 1).tolist(),
           "launches": launches, "peak_gib": peak_main,
           "d_bytes_equal_cpu_cast": cast_ok,
           "layers_vs_float32_plain": held}
    with plain_route():
        plain, _, plain_ms = decode_steps(srv, params, plain_caches, None, s,
                                          dev, feed=fed)
    del plain_caches
    truth = f32_steps(cell_d, mesh, over, params, f32_caches, fed, s, dev)
    del f32_caches
    out["plain_ms_per_step"] = float(np.median(plain_ms))
    out["gaps_plain"] = logit_gaps(got, plain)
    out["vs_float32"] = yardstick(got, plain, truth)
    if ring:
        ops.reset_launch_counts()
        full, _, full_ms = decode_steps(srv, params, full_caches, None, s,
                                        dev, feed=fed)
        full_launches = ops.launch_counts()
        del full_caches
        out["full_ms_per_step"] = float(np.median(full_ms))
        out["full_cache_launches"] = full_launches
        out["gaps_full"] = logit_gaps(got, full)
        out["full_vs_float32"] = yardstick(full, plain, truth)
        if full_launches["flash_decode"] != attn * len(fed) or \
                full_launches["flash_attention"]:
            bad.append(f"full-capacity copy launched {full_launches}")
    if turn_caches is not None:
        out["turns_ms_per_step"] = route_turns(srv, params, turn_caches, fed,
                                               s, dev)
        del turn_caches
    out["peak_gib_with_checks"] = _peak_gib(dev)
    out["predicted"] = PHASE15_PREDICTED[part]
    kept["tokens"] = out["tokens"]
    out["problems"] = bad
    out["part_s"] = round(time.perf_counter() - t_part, 3)
    emit(out)
    if bad:
        raise AssertionError(f"phase {part}: {bad}")
    expect_decode(part, launches, attn, attn * PHASE15_DECODE_STEPS)
    check_layers(part, held, attn * PHASE15_DECODE_STEPS)
    check_yardstick(part, "the flash_decode route", out["vs_float32"])
    if ring:
        long = phase15_long(dev, arch, over, mesh, params, long_caches,
                            fed[0][:1], attn)
        launches = dict(collections.Counter(launches) + collections.Counter(
            long["launches"]))
        kept["long_logits"] = long["logits"]
        kept["long_token"] = int(fed[0][0, 0])
    return {"launches": launches, "part_s": out["part_s"], "held": kept}


def phase15_long(dev, arch: str, over, mesh, params, caches, tok, attn):
    """15d: the long_500k serve step (batch 1) at q_offset 524,288 over
    ``caches`` — a batch-1 slice of D's rings straight from the handoff —
    with every tag shifted by PHASE15_SHIFT, so that each entry keeps its
    slot (the shift is a multiple of the ring) and the window is full:
    exactly one flash_decode launch a layer that attends, each row seeing
    the window's slots; its logits against the float32 steps on a copy of
    the same caches by the yardstick (``check_yardstick``), the gap to the
    plain bf16 route printed; then PHASE15_DECODE_STEPS steps of the same
    token on both routes in turns (``route_turns``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import get_cell
    from repro_torch.models import layers as L
    t0 = time.perf_counter()
    cell = get_cell(arch, "long_500k")
    srv = S.make_serve_artifacts(cell, mesh, layer_override=over)
    q = cell.seq_len
    bad = []
    for c in (c for g in caches for c in g if isinstance(c, L.KVCache)):
        c.pos.copy_(torch.where(c.pos >= 0, c.pos + PHASE15_SHIFT, c.pos))
        cap = c.capacity
        slot = torch.arange(cap, device=c.pos.device)
        if not (cap == srv.cfg.sliding_window
                and bool((c.pos % cap == slot).all())
                and int(c.pos.max()) == q - 1):
            bad.append(f"ring of {cap}: tags off their slots after the shift")
    seen = ops.cache_visible_slots(1, cap, window=srv.cfg.sliding_window,
                                   q_offset=q)
    plain_caches = map_caches(caches, lambda x: x.clone())
    f32_caches = map_caches(caches, lambda x: x.clone())
    turn_caches = map_caches(caches, lambda x: x.clone())
    ops.reset_launch_counts()
    hold, held = holder()
    got, _, ms = decode_steps(srv, params, caches, tok, q, dev, feed=[tok],
                              hold=hold)
    launches = ops.launch_counts()
    with plain_route():
        plain, _, plain_ms = decode_steps(srv, params, plain_caches, None, q,
                                          dev, feed=[tok])
    truth = f32_steps(cell, mesh, over, params, f32_caches, [tok], q, dev)
    del plain_caches, f32_caches
    ys = yardstick(got, plain, truth)
    turns = route_turns(srv, params, turn_caches,
                        [tok] * PHASE15_DECODE_STEPS, q, dev)
    del turn_caches
    if not bool(torch.isfinite(got[0]).all()):
        bad.append("non-finite logits")
    emit({"phase": 15, "part": "15d", "arch": arch, "batch": cell.batch,
          "q_offset": q, "shift": PHASE15_SHIFT, "ring_slots": cap,
          "slots_a_row": seen, "decode_ms": float(np.median(ms)),
          "plain_ms": float(np.median(plain_ms)), "launches": launches,
          "turns_ms_per_step": turns,
          "layers_vs_float32_plain": held,
          "gaps_plain": logit_gaps(got, plain), "vs_float32": ys,
          "problems": bad, "predicted": PHASE15_PREDICTED["15d"],
          "part_s": round(time.perf_counter() - t0, 3)})
    if bad:
        raise AssertionError(f"phase 15d ({arch}): {bad}")
    if seen != srv.cfg.sliding_window:
        raise AssertionError(f"phase 15d ({arch}): {seen} slots a row")
    expect_decode("15d", launches, 0, attn)
    check_layers(f"15d ({arch})", held, attn)
    check_yardstick("15d", f"{arch} flash_decode route", ys)
    return {"launches": launches, "logits": got[0].cpu()}


def phase15(dev):
    """15a, 15b (with its 15d) and 15c (with its 15d), each model freed
    before the next. Returns the launches summed over their main paths
    and each part's ``held`` (host tensors and lists: phase 19's
    one-card results, 15d's long_500k logits among them)."""
    import torch
    t_phase = time.perf_counter()
    launches, parts_s, held = collections.Counter(), {}, {}
    for part in ("15a", "15b", "15c"):
        r = phase15_part(dev, part)
        launches.update(r["launches"])
        parts_s[part] = r["part_s"]
        held[part] = r["held"]
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    phase_s = round(time.perf_counter() - t_phase, 3)
    emit({"phase": 15, "phase_s": phase_s, "parts_s": parts_s,
          "launches": dict(launches),
          "predicted_s": PHASE15_PREDICTED["phase_s"]})
    return {"launches": dict(launches), "held": held}


# --------------------------------------------------------------------------- #
# phase 17: the examples and the launcher's --demo on the card
# --------------------------------------------------------------------------- #
def example_module(name: str):
    """``examples/<name>.py`` imported as a module (examples/ is not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_example(name: str, args, dev, env=None) -> dict:
    """Start ``python <args>`` from the repository's root in a session of
    its own, on the card (``--device cpu`` added off it). Returns the
    run's handle for ``finish_example``."""
    cmd = [sys.executable, *args] + (["--device", "cpu"]
                                     if dev.type != "cuda" else [])
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    return {"name": name, "args": args, "proc": proc,
            "t0": time.perf_counter()}


def kill_session(run) -> None:
    """Kill every process of a run's session: the spawned workers too."""
    import signal
    try:
        os.killpg(run["proc"].pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def finish_example(run) -> str:
    """Wait for a run until PHASE17_RUN_TIMEOUT_S after its start, then
    kill its session. Prints its exit code, seconds and last lines; a
    non-zero exit raises. Returns its standard output."""
    proc, args = run["proc"], run["args"]
    left = PHASE17_RUN_TIMEOUT_S - (time.perf_counter() - run["t0"])
    try:
        out, err = proc.communicate(timeout=max(left, 1.0))
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        kill_session(run)
        out, err = proc.communicate()
        rc = "timeout"
    finally:
        kill_session(run)
    line = {"phase": 17, "run": run["name"],
            "args": args[1:] if args[0] == "-m" else args, "rc": rc,
            "seconds": time.perf_counter() - run["t0"],
            "tail": out.splitlines()[-14:]}
    if rc != 0:
        line["stderr_tail"] = err.splitlines()[-30:]
    emit(line)
    if rc != 0:
        raise AssertionError(f"phase 17: {run['name']} exited with {rc}")
    return out


def printed(out: str, prefix: str) -> str:
    """The rest of the last printed line that starts with ``prefix``."""
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    if not lines:
        raise AssertionError(f"phase 17: no line starts with {prefix!r}")
    return lines[-1][len(prefix):].strip()


def phase17_demo_reports(out: str) -> dict:
    """The single-process demo's requeues and D dispatches, as printed."""
    import ast
    return {"requeues": int(printed(out, "requeues after failure:")),
            "d_dispatches": ast.literal_eval(printed(out, "D dispatches:"))}


def phase17c(dev):
    """``run_single(faults=True)`` of the serving example in this process
    at llama2-7b's full width and depth in bf16 (the example's ``CFG``,
    ``VENDOR_P`` and ``VENDOR_D`` set to llama2-7b and phase 3's vendors,
    phase 3's weights from SEED), then the same requests fault-free. D0
    fails at tick 6 and D2 joins at tick 14: at least one requeue, every
    request finished, D2 serving after its join, each requeued request's
    tokens equal to the fault-free run's or, at the first difference,
    within phase 3's first-token yardstick or no further from it than the
    fault-free run's token (``divergence_yardstick``); the main path's
    kernels launched in the faulted run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import VendorProfile

    ex = example_module("torch_serve_disagg")
    cfg = get_config(MODEL)
    ex.CFG = cfg
    ex.VENDOR_P, ex.VENDOR_D = (VendorProfile(**P_VENDOR),
                                VendorProfile(**D_VENDOR))
    params = M.init_params(cfg, seed=SEED, device=dev)   # phase 3's weights
    args = ex.parse_args(["--requests", str(PHASE17_REQUESTS),
                          "--max-new", str(PHASE17_MAX_NEW)]
                         + ([] if dev.type == "cuda" else ["--device", "cpu"]))
    ops.reset_launch_counts()
    faulted = ex.run_single(args, faults=True, params=params)
    launches = ops.launch_counts()
    gc.collect()                               # the faulted run's pools
    torch.cuda.empty_cache()
    clean = ex.run_single(args, faults=False, params=params)
    gc.collect()
    torch.cuda.empty_cache()
    prompts = {r.req_id: r.prompt for r in ex.build_requests(
        args.requests, args.max_new)}
    requeued = [r.req_id for r in faulted.requests if r.retries > 0]
    problems = []
    if faulted.stats.requeues < 1 or not requeued:
        problems.append(f"requeues {faulted.stats.requeues}, requeued "
                        f"{requeued}")
    if not all(r.done for r in faulted.requests + clean.requests):
        problems.append("a request did not finish")
    d2 = faulted.stats.d_dispatches.get("D2", 0)
    if d2 < 1:
        problems.append(f"D2 served {d2} requests after its join")
    launched = {k for k, n in launches.items() if n}
    one_row = one_row_chunks([len(p) for p in prompts.values()],
                             args.prefill_chunk)
    if dev.type == "cuda" and not (
            PHASE3_KERNELS <= launched <= PHASE3_KERNELS | {"flash_decode"}
            and (not one_row or "flash_decode" in launched)):
        problems.append(f"kernels launched {launched}")
    ev = faulted.events
    out = {"phase": 17, "part": "17c", "model": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.compute_dtype,
           "requests": args.requests, "max_new_tokens": args.max_new,
           "prefill_chunk": args.prefill_chunk,
           "p_vendor": dataclasses.asdict(ex.VENDOR_P),
           "d_vendor": dataclasses.asdict(ex.VENDOR_D),
           "requeues": faulted.stats.requeues, "requeued": requeued,
           "p_dispatches": dict(faulted.stats.p_dispatches),
           "d_dispatches": dict(faulted.stats.d_dispatches),
           "d2_decode_steps": faulted.engines["D2"]["decode_steps"],
           "fail_at_s": ev["fail"] - ev["start"],
           "join_at_s": ev["join"] - ev["start"],
           "requeued_ttft_s": [faulted.requests[i].ttft()
                               for i, r in enumerate(faulted.requests)
                               if r.req_id in requeued],
           "requeued_done_after_fail_s": max(
               (r.finish_time - ev["fail"] for r in faulted.requests
                if r.req_id in requeued), default=None),
           "last_done_s": max(r.finish_time for r in faulted.requests)
               - ev["start"],
           "launches": launches, "one_row_chunks": one_row,
           "tokens_equal_fault_free": sum(faulted[k] == clean[k]
                                          for k in faulted),
           "problems": problems}
    if problems:
        emit(out)
        raise AssertionError(f"phase 17c: {problems}")
    out["divergences"] = divergence_yardstick(
        cfg, params, dev, [prompts[k] for k in requeued],
        {k: faulted[k] for k in requeued}, clean, False)
    out["requeued_tokens"] = ("identical" if not out["divergences"] else
                              "differ, each first difference within the "
                              "yardstick or no further than the fault-free "
                              "run's token")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return launches


def phase17(dev):
    """The port's examples and its launcher's ``--demo``, on the card, the
    subprocesses all started at once (their start-up, about 10 s a
    process, overlaps) while 17c runs in this process: 17a ``python -m
    repro_torch.launch.serve --demo``, single-process (the D failure and
    the join: at least one requeue) and 2P2D over shm; 17b the serving
    example with the modeled-RDMA connector, with ``--parity`` at 2P2D
    over shm (token-exact) and sized by the planner with the prefix
    cache; 17c its ``run_single`` with faults at llama2-7b's full width;
    17d the quickstart, the planner walkthrough and ``train_tiny`` (its
    loss must fall by more than 0.5 and the restored step's loss be
    finite). Every subprocess must exit 0."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    serve = ["-m", "repro_torch.launch.serve", "--demo"]
    example = ["examples/torch_serve_disagg.py", "--requests",
               str(PHASE17_REQUESTS), "--max-new", str(PHASE17_MAX_NEW)]
    tmp = tempfile.TemporaryDirectory()              # train_tiny's checkpoints
    runs = (
        ("17a demo", serve, None),
        ("17a demo 2P2D shm", serve + ["--num-p", "2", "--num-d", "2",
                                       "--connector", "shm"], None),
        ("17b rdma", example + ["--connector", "rdma"], None),
        ("17b parity 2P2D shm", example + ["--parity", "--num-p", "2",
                                           "--num-d", "2", "--connector",
                                           "shm"], None),
        ("17b plan shm prefix cache", example + [
            "--plan", "--connector", "shm", "--prefix-cache"], None),
        ("17d quickstart", ["examples/torch_quickstart.py"], None),
        ("17d plan_deployment", ["examples/torch_plan_deployment.py"], None),
        ("17d train_tiny", ["examples/torch_train_tiny.py", "--steps",
                            str(PHASE17_TRAIN_STEPS)], {"TMPDIR": tmp.name}))
    started = []
    try:
        for name, args, env in runs:
            started.append(start_example(name, args, dev, env))
        t_c = time.perf_counter()
        launches = phase17c(dev)
        t_c = time.perf_counter() - t_c
        gc.collect()
        torch.cuda.empty_cache()
        outs = {run["name"]: finish_example(run) for run in started}
    finally:
        for run in started:
            kill_session(run)
        tmp.cleanup()
    demo = phase17_demo_reports(outs["17a demo"])
    if demo["requeues"] < 1:
        raise AssertionError(f"phase 17a: the demo printed {demo}")
    if "PARITY OK" not in outs["17b parity 2P2D shm"]:
        raise AssertionError("phase 17b: --parity printed no PARITY OK")
    train = outs["17d train_tiny"]
    loss = printed(train, "loss ")
    if not loss.endswith("(OK)"):
        raise AssertionError(f"phase 17d: train_tiny's loss {loss}")
    restored = float(printed(train, "restored step_").split(
        "next-step loss ")[1].split()[0])
    if not math.isfinite(restored):
        raise AssertionError(f"phase 17d: restored loss {restored}")
    emit({"phase": 17, "phase_s": time.perf_counter() - t0, "17c_s": t_c,
          "demo": demo, "train_tiny_steps": PHASE17_TRAIN_STEPS,
          "train_tiny_loss": loss, "train_tiny_restored_loss": restored,
          "launches": launches})
    return {"launches": launches}


# (name, source, TPU kernel, the phase whose launches the row reports);
# every row also carries its launches on every serving phase
# --------------------------------------------------------------------------- #
# phase 18: a mesh of ranks (tensor parallelism on the model axis)
# --------------------------------------------------------------------------- #
def moe_traced_rank(rank, arch: str, *args):
    """``serve.programs_on_rank(rank, arch, *args)`` with the capacity
    MoE's routing traced (each MoE call's choices and the pairs its
    windows drop, from the group sizes after the run: the prefill's
    layers, then each decode step's); returns the rank's record with
    ``drops`` and, on rank 0, ``routes`` (int8 expert ids (T, k) a
    call)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    real = L._moe_mlp_capacity
    seen = []

    def traced(p, cfg_, x, capacity_factor=1.25, **kw):
        _, idx = L.moe_route(p, cfg_, x.reshape(-1, x.shape[-1]))
        flat = idx.reshape(-1)
        sizes = torch.zeros(cfg_.moe.num_experts, dtype=torch.int64,
                            device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        seen.append((sizes, flat.numel() // cfg_.moe.top_k,
                     capacity_factor, idx.to(torch.int8)))
        return real(p, cfg_, x, capacity_factor=capacity_factor, **kw)

    L._moe_mlp_capacity = traced
    try:
        rec = serve.programs_on_rank(rank, arch, *args)
    finally:
        L._moe_mlp_capacity = real
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    rec["drops"] = [L.moe_capacity_drops(g.tolist(),
                                         L.moe_capacity(cfg, t, cf))
                    for g, t, cf, _ in seen]
    if rank.index == 0:
        rec["routes"] = [r.cpu() for *_, r in seen]
    return rec


def gloo_bf16_probe(rank):
    """``psum`` of a bfloat16 tensor on the rank's device over the world
    (rank 0 holds 1, rank 1 3/256 in every element): the sum each rank
    gets, which must be 1.01171875 rounded to the nearest even bf16,
    1.015625 (truncation would give 1.0078125), and what carried it
    (``collectives.transport``: the shared card's buffers)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import collectives as C
    mesh = make_mesh(PHASE18_MESH, ("data", "model"), rank.device)
    x = torch.full((1024,), 3 / 256 if rank.index else 1.0,
                   dtype=torch.bfloat16, device=rank.device)
    shard = mesh.axis_shard("model")
    y = C.psum(x, shard)
    return {"dtype": str(y.dtype), "device": str(y.device),
            "transport": C.transport(shard, rank.device),
            "values": sorted({float(v) for v in y.cpu().float()})}


def held_to_launch(part: str, got, want, control,
                   steps: int = PHASE18_LOGIT_STEPS) -> dict:
    """A mesh run's gathered prefill logits ``got`` (B, V) against the
    one-card run's ``want``: the largest gap at most ``steps`` (default
    PHASE18_LOGIT_STEPS) bf16 steps of ``want``'s largest magnitude, and
    each row's argmax
    equal or ``want``'s top-2 gap within that bound (a near-tie the other
    reduction order may break the other way). ``control``: the same
    run's logits with its last layer's psums each missing the other
    rank's term (``SubBlocks.hold``; an SSM's: its prefill with the
    embedding's psum missing it, ``embed_controlled``; a long_500k step's:
    the step with every psum missing it, ``long_traced``), which must
    fail the bound. The mesh
    sums its bf16 partials in another order than one card's products, and
    over 27-36 random layers the two drift apart by a few steps (PERF.md
    §6), so phase 14's one step is printed, not held."""
    step = bf16_step(want)
    limit = steps * step
    gap = float((got - want).abs().max())
    c_gap = float((control - want).abs().max())
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    top2 = want.topk(2, dim=-1).values
    t2 = (top2[:, 0] - top2[:, 1]).tolist()
    out = {"max_abs_logit_gap": gap, "bf16_step": step,
           "gap_bf16_steps": gap / step if step else None,
           "logit_bound": limit, "within_one_step": gap <= step,
           "control_gap": c_gap,
           "control_gap_bf16_steps": c_gap / step if step else None,
           "argmax_equal": same, "one_card_top2_gap": t2}
    bad = [f"{part}: logits {gap} from the one-card run's, past "
           f"{steps} bf16 steps ({limit})"] \
        if not gap <= limit else []
    if c_gap <= limit:
        bad.append(f"{part}: the control's logits ({c_gap} away) pass the "
                   f"bound {limit}")
    bad += [f"{part} row {i}: argmax differs, one-card top-2 gap {g} > "
            f"{limit}" for i, (ok, g) in enumerate(zip(same, t2))
            if not ok and not g <= limit]
    out["problems"] = bad
    return out


class SubBlocks:
    """A rank's record of chosen sub-blocks as the main path runs them,
    keyed by (model layer, block): each prefill attention
    (``model.attention_full``), MLP (``layers.swiglu_mlp`` at the layer's
    width; an encoder's MLPs are not counted), MoE (``layers.moe_mlp``),
    RG-LRU block (``layers.rglru_block``, with a copy of the state it
    starts from), SSD block (``layers.ssd_block``, likewise), encoder
    attention (``layers.attention_block`` called non-causal: block
    ``enc_attn``, keyed by encoder layer) and cross-attention
    (``layers.cross_attention``, with the rank's memory rows) of the
    layers in ``layers`` or named in ``blocks``, the first decode step's
    MLA attention (``layers.mla_decode``, with a copy of the rank's
    latent it reads) of layer ``mla_decode`` and SSD step
    (``layers.ssd_decode``, with a copy of its state) of layer
    ``ssd_decode`` — its input, its output (after the psum), a copy of
    the rank's shard of its weights and its distribution context —, and
    the first ``lm_logits`` call's input (the prefill's last position)
    with the head's shards. The inputs, outputs, states and latents wait
    on the host, so that the main path keeps the card's memory. ``hold``
    then measures them on the same inputs."""

    PARAMS = {"attn": "attn", "mlp": "mlp", "moe": "mlp", "rglru": "rglru",
              "mla_decode": "attn", "ssd": "ssd", "ssd_decode": "ssd",
              "enc_attn": "attn", "cross": "cross"}

    def __init__(self, layers=(), blocks=(), mla_decode=None,
                 ssd_decode=None):
        self.layers = set(layers)
        self.blocks = set(map(tuple, blocks))
        self.mla_decode = mla_decode
        self.ssd_decode = ssd_decode
        self.calls = {"attn": 0, "mlp": 0, "moe": 0, "rglru": 0,
                      "mla_decode": 0, "ssd": 0, "ssd_decode": 0,
                      "enc_attn": 0, "cross": 0}
        self.order = None        # kind -> model layers of that kind, in order
        self.got = {}            # (layer, block) -> dict
        self.head = None
        self.in_encoder = False

    def _layer(self, cfg, kind, i):
        """The model layer of the i-th call of a ``kind`` layer (None past
        the model's layers: a decode step's)."""
        if self.order is None:
            from repro_torch.models import model as M
            kinds = [k for g in M.block_groups(cfg) for _ in range(g.count)
                     for k in g.kinds]
            self.order = {k: [j for j, x in enumerate(kinds) if x == k]
                          for k in set(kinds)}
        at = self.order.get(kind, [])
        return at[i] if i < len(at) else None

    def _wanted(self, i, block):
        return i is not None and (i in self.layers
                                  or (i, block) in self.blocks)

    def _keep(self, i, block, p, x, y, cfg, run, **kw):
        from repro_torch.launch import sharding as SH
        from repro_torch.models import dist
        self.got[(i, block)] = dict(
            p=SH.tree_map(lambda t: t.clone(), p), x=x.cpu(), y=y.cpu(),
            cfg=cfg, ctx=dist.ctx(), run=run, prefill=True, extra={}, **kw)

    def _keep_state(self, i, block, state, dims, control_by):
        """Adds the state a recorded block started from (on the host) with
        the dims its shards gather on (None: whole on every rank)."""
        self.got[(i, block)].update(
            extra={n: getattr(state, n).cpu() for n in dims},
            dims=dims, control_by=control_by)

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import dist
        from repro_torch.models import layers as L
        from repro_torch.models import model as M
        real = (M.attention_full, L.swiglu_mlp, L.moe_mlp, M.lm_logits,
                L.rglru_block, L.mla_decode, L.ssd_block, L.ssd_decode,
                L.attention_block, L.cross_attention, M.encode)

        def attn(p, cfg, h, positions):
            i = self._layer(cfg, M.ATTN, self.calls["attn"])
            self.calls["attn"] += 1
            out = real[0](p, cfg, h, positions)
            if self._wanted(i, "attn"):
                self._keep(i, "attn", p, h, out[0], cfg,
                           lambda q, x, e: M.attention_full(
                               q, cfg, x, positions)[0])
            return out

        def swiglu(p, x, d_ff=None):
            y = real[1](p, x, d_ff)
            if d_ff is not None and not self.in_encoder:
                i = self.calls["mlp"]        # a decoder layer's MLP, not a
                # shared expert inside the MoE
                self.calls["mlp"] += 1
                if self._wanted(i, "mlp"):
                    self._keep(i, "mlp", p, x, y, None, lambda q, z, e:
                               L.swiglu_mlp(q, z, d_ff))
            return y

        def moe(p, cfg, x):
            i, k = self.calls["mlp"], self.calls["moe"]
            self.calls["mlp"] += 1
            self.calls["moe"] += 1
            y = real[2](p, cfg, x)
            if self._wanted(i, "moe"):
                self._keep(i, "moe", p, x, y, cfg, lambda q, z, e:
                           L.moe_mlp(q, cfg, z), moe_call=k)
            return y

        def head(params, cfg, x):
            if self.head is None:
                self.head = dict(params={k: params[k] for k in (
                    "final_norm", "embed", "lm_head") if k in params},
                    x=x, cfg=cfg, ctx=dist.ctx())
            return real[3](params, cfg, x)

        def rglru(p, cfg, x, state):
            i = self._layer(cfg, M.RECURRENT, self.calls["rglru"])
            self.calls["rglru"] += 1
            start = {"h": state.h.clone(), "conv": state.conv.clone()}
            out = real[4](p, cfg, x, state)
            if self._wanted(i, "rglru"):
                self._keep(i, "rglru", p, x, out[0], cfg,
                           lambda q, z, e: L.rglru_block(
                               q, cfg, z, L.RGLRUState(
                                   e["h"].clone(), e["conv"].clone()))[0])
                self.got[(i, "rglru")].update(
                    extra={n: t.cpu() for n, t in start.items()},
                    dims={"h": -1, "conv": -1}, control_by="gather")
            return out

        def mla_decode(p, cfg, x, positions, cache, q_offset=None):
            i = self._layer(cfg, M.ATTN, self.calls["mla_decode"])
            self.calls["mla_decode"] += 1
            mine = i is not None and i == self.mla_decode
            start = {n: getattr(cache, n).clone()
                     for n in ("ckv", "kpe", "pos")} if mine else None
            out = real[5](p, cfg, x, positions, cache, q_offset=q_offset)
            if mine:
                self._keep(i, "mla_decode", p, x, out[0], cfg,
                           lambda q, z, e: L.mla_decode(
                               q, cfg, z, positions, L.MLACache(
                                   e["ckv"].clone(), e["kpe"].clone(),
                                   e["pos"].clone(), True),
                               q_offset=q_offset)[0])
                self.got[(i, "mla_decode")].update(
                    extra={n: t.cpu() for n, t in start.items()},
                    prefill=False, dims={"ckv": 1, "kpe": 1, "pos": 1})
            return out

        def ssd(p, cfg, x, state):
            i = self._layer(cfg, M.SSD, self.calls["ssd"])
            self.calls["ssd"] += 1
            start = L.SSMState(state.h.clone(), state.conv.clone())
            out = real[6](p, cfg, x, state)
            if self._wanted(i, "ssd"):
                # a prefill's SSD starts from zero states: its one
                # collective (the conv tail's gather) moves zeros, so it
                # has no control of its own
                self._keep(i, "ssd", p, x, out[0], cfg,
                           lambda q, z, e: L.ssd_block(q, cfg, z, L.SSMState(
                               e["h"].clone(), e["conv"].clone()))[0])
                self._keep_state(i, "ssd", start, {"h": None, "conv": 2},
                                 "none")
            return out

        def ssd_decode(p, cfg, x, state):
            i = self._layer(cfg, M.SSD, self.calls["ssd_decode"])
            self.calls["ssd_decode"] += 1
            mine = i is not None and i == self.ssd_decode
            start = L.SSMState(state.h.clone(), state.conv.clone()) \
                if mine else None
            out = real[7](p, cfg, x, state)
            if mine:
                self._keep(i, "ssd_decode", p, x, out[0], cfg,
                           lambda q, z, e: L.ssd_decode(q, cfg, z, L.SSMState(
                               e["h"].clone(), e["conv"].clone()))[0])
                self._keep_state(i, "ssd_decode", start,
                                 {"h": None, "conv": 2}, "gather")
                self.got[(i, "ssd_decode")]["prefill"] = False
            return out

        def attention_block(p, cfg, x, positions, **kw):
            out = real[8](p, cfg, x, positions, **kw)
            if kw.get("causal", True):       # the decoder's (attention_full)
                return out
            i = self.calls["enc_attn"]
            self.calls["enc_attn"] += 1
            if self._wanted(i, "enc_attn"):
                self._keep(i, "enc_attn", p, x, out[0], cfg,
                           lambda q, z, e: L.attention_block(
                               q, cfg, z, positions, **kw)[0])
            return out

        def cross(p, cfg, x, mem_kv, mem_lengths=None, kv_len=None):
            i = self.calls["cross"]
            self.calls["cross"] += 1
            out = real[9](p, cfg, x, mem_kv, mem_lengths, kv_len)
            if self._wanted(i, "cross") and mem_lengths is None:
                self._keep(i, "cross", p, x, out, cfg,
                           lambda q, z, e: L.cross_attention(
                               q, cfg, z, (e["k"], e["v"]), kv_len=kv_len))
                self.got[(i, "cross")].update(
                    extra={"k": mem_kv[0].cpu(), "v": mem_kv[1].cpu()},
                    dims={"k": 3, "v": 3})
            return out

        def encode(*args, **kw):
            self.in_encoder = True
            try:
                return real[10](*args, **kw)
            finally:
                self.in_encoder = False

        M.attention_full, L.swiglu_mlp, L.moe_mlp, M.lm_logits, \
            L.rglru_block, L.mla_decode, L.ssd_block, L.ssd_decode, \
            L.attention_block, L.cross_attention, M.encode = \
            attn, swiglu, moe, head, rglru, mla_decode, ssd, ssd_decode, \
            attention_block, cross, encode
        try:
            yield self
        finally:
            M.attention_full, L.swiglu_mlp, L.moe_mlp, M.lm_logits, \
                L.rglru_block, L.mla_decode, L.ssd_block, L.ssd_decode, \
                L.attention_block, L.cross_attention, M.encode = real

    def hold(self, rank, routes=None):
        """On every rank: each recorded sub-block again on its own input
        with its control — ``psum`` returning the rank's own partial (the
        other rank's term left out), or for an RG-LRU block the gathered
        ``xb`` (for an SSD step its gathered conv tail) with the other
        rank's channels zeroed; a prefill's SSD block has none —, and its
        weights and its state, latent or memory rows gathered whole. On rank 0: the one-card
        sub-block (the weights whole, the context's mesh 1 x 1) and its
        float32 witness (the weights, the same input and the state in
        float32; a MoE's summed over four slices of d_ff_expert, each a
        float32 expert-TP partial, so that its intermediates fit) on that
        input; each output's max and mean error against the witness; at a
        MoE layer the one-card routes and dropped pairs beside the mesh
        run's (``routes``: rank 0's, one a MoE call). Then on every rank
        the control's logits: the last layer's prefill sub-blocks' control
        deltas added to the prefill's last position, through the head,
        gathered (None where no block of the last layer has a control).
        Returns (rank 0's records, the control logits) as CPU values."""
        import torch
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import collectives as C
        from repro_torch.models import dist
        from repro_torch.models import layers as L
        from repro_torch.models import model as M
        cfg = self.head["cfg"]
        shard = self.head["ctx"].model_shard()
        whole_abs = M.abstract_params(cfg)
        abstract = [lp for *_, lp in M._layers(whole_abs, cfg)]
        enc_abstract = [M.layer_params(whole_abs["enc_groups"][0][0], li)
                        for li in range(cfg.encoder_layers)] \
            if cfg.is_enc_dec else []
        real_psum, real_gather = C.psum, C.all_gather

        def own_half(x, dim, shard_, **kw):
            return torch.cat([x if j == shard_.index else torch.zeros_like(x)
                              for j in range(shard_.size)], dim)

        recs = []
        dev = self.head["x"].device
        for (i, block), r in sorted(self.got.items()):
            for key in ("x", "y"):                  # back from the host
                r[key] = r[key].to(dev)
            r["extra"] = {n: t.to(dev) for n, t in r["extra"].items()}
            with torch.no_grad(), dist.use(r["ctx"]):
                if r.get("control_by") == "none":
                    r["control"] = None
                elif r.get("control_by") == "gather":
                    # the end-to-end control leaves out the other rank's
                    # psum term of every block, this one's too
                    C.psum = lambda x, shard_: x
                    try:
                        r["control_psum"] = r["run"](r["p"], r["x"],
                                                     r["extra"]).cpu()
                    finally:
                        C.psum = real_psum
                    C.all_gather = own_half
                else:
                    C.psum = lambda x, shard_: x
                try:
                    if r.get("control_by") != "none":
                        r["control"] = r["run"](r["p"], r["x"], r["extra"])
                finally:
                    C.psum, C.all_gather = real_psum, real_gather
                want = (enc_abstract if block == "enc_attn" else
                        abstract)[i][self.PARAMS[block]]
                whole = SH.tree_map(
                    lambda t, a: _gathered_whole(t, tuple(a.shape), shard),
                    r["p"], want)
                extra = {n: t if r["dims"][n] is None else
                         C.all_gather(t.contiguous(), r["dims"][n], shard)
                         for n, t in r["extra"].items()}
            if rank.index:
                for key in ("x", "y", "control"):     # the card's memory
                    r[key] = _on_host(r[key])
                del whole, extra
                continue
            one = dataclasses.replace(r["ctx"], mesh=make_mesh(
                (1, 1), r["ctx"].mesh.axis_names, r["x"].device))
            with torch.no_grad(), dist.use(one):
                y1 = r["run"](whole, r["x"], extra)
                e32 = {n: t.float() if t.is_floating_point() else t
                       for n, t in extra.items()}
                if block in ("mlp", "moe"):
                    w32 = sliced_witness(whole, r["cfg"], r["x"])
                else:
                    w32 = r["run"](SH.tree_map(lambda t: t.float(), whole),
                                   r["x"].float(), e32)
                del e32

            def err(y):
                e = (y.float() - w32).abs()
                return [float(e.max()), float(e.mean())]

            rec = {"layer": i, "block": block, "shape": list(r["x"].shape),
                   "mesh": err(r["y"]), "one_card": err(y1),
                   "control": (None if r["control"] is None
                               else err(r["control"])),
                   "control_by": {
                       "gather": "the other rank's channels of the "
                                 "gathered " + ("conv tail" if block ==
                                                "ssd_decode" else "xb") +
                                 " zeroed",
                       "none": None}.get(
                           r.get("control_by"),
                           "psum missing the other rank's term"),
                   "mesh_vs_one_card_max": float(
                       (r["y"].float() - y1.float()).abs().max())}
            if block == "moe":
                x2d = r["x"].reshape(-1, r["x"].shape[-1])
                _, idx = L.moe_route(whole, r["cfg"], x2d)
                mesh_idx = routes[r["moe_call"]].to(idx.device).long()
                cap = L.moe_capacity(r["cfg"], x2d.shape[0],
                                     r["ctx"].moe_capacity_factor)
                rec["routes_equal"] = bool(torch.equal(mesh_idx, idx))
                rec["drops"] = [L.moe_capacity_drops(torch.bincount(
                    j.reshape(-1), minlength=r["cfg"].moe.num_experts
                ).tolist(), cap) for j in (mesh_idx, idx)]
            recs.append(rec)
            del y1, w32, whole, extra
            for key in ("x", "y", "control"):         # the card's memory
                r[key] = _on_host(r[key])
        last = max(i for (i, b), r in self.got.items()
                   if r["prefill"] and b != "enc_attn")
        ends = [r for (i, b), r in self.got.items()
                if i == last and r["prefill"] and b != "enc_attn"
                and r["control"] is not None]
        if not ends:
            return recs, None
        delta = sum((r.get("control_psum", r["control"]).to(dev)
                     - r["y"].to(dev))[:, -1].float() for r in ends)
        x = self.head["x"]
        with torch.no_grad(), dist.use(self.head["ctx"]):
            logits = C.all_gather(M.lm_logits(
                self.head["params"], cfg, (x.float() + delta).to(x.dtype)),
                -1, shard)
        return recs, logits.float().cpu()


def _on_host(t):
    return None if t is None else t.cpu()


def sliced_witness(whole, cfg, x, slices: int = 4):
    """An MLP's (``cfg`` None) or capacity MoE's float32 witness on ``x``
    under the one-card context: the float32 weights cut into ``slices``
    slices of d_ff (d_ff_expert, and the shared experts' width), each
    slice's partial — the row-parallel decomposition, the MoE's routing
    the whole router's for every slice — summed in float32: the whole
    function, with a quarter of its intermediates live at a time."""
    import torch
    from repro_torch.models import layers as L

    def cut(w, dim, c):
        n = w.shape[dim]
        assert n % slices == 0, (tuple(w.shape), dim, slices)
        return w.narrow(dim, c * n // slices, n // slices).float()

    def mlp(p, c, lead=0):
        return {"w_gate": cut(p["w_gate"], lead + 1, c),
                "w_up": cut(p["w_up"], lead + 1, c),
                "w_down": cut(p["w_down"], lead, c)}

    out = None
    for c in range(slices):
        if cfg is None:
            y = L.swiglu_mlp(mlp(whole, c), x.float())
        else:
            part = {"router": whole["router"].float(), **mlp(whole, c, 1)}
            if "shared" in whole:
                part["shared"] = mlp(whole["shared"], c)
            y = L._moe_mlp_capacity(part, cfg, x.float())
        out = y if out is None else out + y
        del y
    return out


def _gathered_whole(t, shape, shard):
    """A rank's slice ``t`` of a leaf whose whole shape is ``shape``
    (sliced on at most one dim over the model axis), gathered whole."""
    from repro_torch.models import collectives as C
    dims = [d for d, (a, b) in enumerate(zip(t.shape, shape)) if a != b]
    if not dims:
        return t
    (d,) = dims
    if t.shape[d] * shard.size != shape[d]:
        raise AssertionError(f"a slice {tuple(t.shape)} of {shape}")
    return C.all_gather(t.contiguous(), d, shard)


def phase18_rank(rank, probes, program, *args):
    """``program(rank, *args)`` — a rank's main path, its record returned
    — with the sub-blocks that ``probes`` names (layers, or a dict of
    ``SubBlocks``' arguments) recorded as it runs them, then held on their
    own inputs (``SubBlocks.hold``): the record gains ``probes`` and
    ``control_logits``."""
    probe = SubBlocks(**probes) if isinstance(probes, dict) \
        else SubBlocks(probes)
    with probe.recording():
        rec = program(rank, *args)
    rec["probes"], control = probe.hold(rank, rec.get("routes"))
    # a program that made its own control (``embed_controlled``) keeps it
    rec["control_logits"] = rec.pop("prefill_control_logits", control)
    return rec


def probe_problems(part: str, probes) -> list:
    """Each probe (rank 0's ``SubBlocks.hold`` records) gains its mesh and
    control error ratios (max, mean) to the one-card sub-block's: the mesh
    must be within PHASE18_WITNESS_FACTOR on both, the control past it on
    at least one; at a MoE layer the routes and dropped pairs equal to
    the one card's on the same input. Returns the problems."""
    bad = []
    for p in probes:
        for key in ("mesh", "control"):
            p[f"{key}_ratio"] = None if p[key] is None else [
                x / y if y else math.inf
                for x, y in zip(p[key], p["one_card"])]
        where = f"{part} layer {p['layer']} {p['block']}"
        if not max(p["mesh_ratio"]) <= PHASE18_WITNESS_FACTOR:
            bad.append(f"{where}: error {p['mesh']} against float32, "
                       f"{p['mesh_ratio']} x one card's {p['one_card']}")
        if p["control"] is None:
            if p["block"] != "ssd":          # the only block without one
                bad.append(f"{where}: no control")
        elif max(p["control_ratio"]) <= PHASE18_WITNESS_FACTOR:
            bad.append(f"{where}: the control passes ({p['control_ratio']}"
                       f" x one card's error)")
        if p["block"] == "moe" and not (p["routes_equal"]
                                        and p["drops"][0] == p["drops"][1]):
            bad.append(f"{where}: routes equal {p['routes_equal']}, drops "
                       f"{p['drops']} (mesh, one card)")
    return bad


def tokens_held(got, want, gaps) -> list:
    """Each sequence's greedy tokens equal the one-card run's or, at the
    first difference, the one-card step's top-2 gap there is within its
    bound (``top2_gap_and_bound``: a near-tie another route may break the
    other way); after it, nothing is compared. Returns the problems."""
    bad = []
    for b, (g, w) in enumerate(zip(got, want)):
        for i, (x, y) in enumerate(zip(g, w)):
            if x != y:
                gap, limit = gaps[i][b]
                if not gap <= limit:
                    bad.append(f"sequence {b} token {i}: {x} != {y} with "
                               f"a one-card top-2 gap {gap} > {limit}")
                break
    return bad


def rank_problems(part: str, recs, expect: dict) -> list:
    """Per rank: every byte count equal to ``per_chip_bytes`` and exactly
    ``expect``'s launches (every other kernel none)."""
    bad = []
    for r in recs:
        for what, (have, predicted) in r["bytes"].items():
            if have != predicted:
                bad.append(f"{part} rank {r['rank']} {what}: {have} "
                           f"bytes, per_chip_bytes {predicted}")
        for name, n in r["launches"].items():
            if n != expect.get(name, 0):
                bad.append(f"{part} rank {r['rank']}: {n} {name} launches, "
                           f"the path makes {expect.get(name, 0)}")
    return bad


def phase18(dev, held):
    """The launch layer on a (data, model) = (1, 2) mesh of ranks: a
    world of two processes on the one card (``launch.ranks``; the backend
    it chose is printed — gloo, as NCCL refuses two ranks of one
    communicator on a device), each holding the shards the launch layer's
    specs give it and computing with the collectives they force. Two
    ranks on one card run the two-card program — the same shards,
    collectives and bytes a rank — and its time is that of the layout,
    not of tensor parallelism.

    18a: Qwen3-4B at full width cut to PHASE18A_LAYERS of its 36 layers
    through the launcher's rank program (``serve.programs_on_rank``,
    what ``python -m repro_torch.launch.serve --mesh 1x2`` runs): each
    rank draws 14a's weights from the seed one layer at a time and keeps
    its slices; prefill_32k at batch 2 → the handoff (head_dim- to
    capacity-sharded, a block exchange) → PHASE14_DECODE_STEPS greedy
    steps, each rank's flash_decode stopping at its partials and the
    ranks' partials combined. Its one-card run is this phase's own
    (``one_card_run`` at the same cut, before the world starts). Held:
    the gathered prefill logits to the one-card run's within
    PHASE18_LOGIT_STEPS bf16 steps, argmax equal or within the top-2 gap
    (``held_to_launch``), a control with the last layer's psums each
    missing a term failing that bound; the sub-blocks of the first and
    last layers on their own inputs against their float32 witness, within
    PHASE18_WITNESS_FACTOR of the one-card sub-block's error, each
    control failing it (``SubBlocks``, ``probe_problems``); the tokens to
    the one-card run's (``tokens_held``); D's shards of layers
    PHASE18_CHECK_LAYERS, gathered, bit for bit the realignment of P's
    gathered (``serve.handoff_held``, on both ranks); every rank's bytes
    of parameters and P's and D's caches equal to ``per_chip_bytes`` at
    {"data": 1, "model": 2}; per rank exactly one flash a layer, and 4 a
    layer of flash_decode_partial and of decode_combine.

    18b: DeepSeek-V2-Lite's prefill_32k at batch 1, all 27 layers: the
    MLA heads and the expert-TP MoE split over the ranks (a psum after
    each), the router replicated. Held: the logits to 14b's by the same
    bound and control; the sub-blocks of layers 1 (the first MoE layer)
    and 26 likewise, the MoE's routes and dropped pairs on the same input
    equal to the one card's; each MoE layer's dropped pairs equal on both
    ranks (against 14b's they are printed: the mesh's inputs differ from
    14b's by rounding, so near-ties of the router flip); the bytes; 27
    flash launches a rank.

    Returns the summed launches of both ranks' main paths and 18a's
    one-card run (phase 21's witness for serving on a data axis)."""
    import torch
    from repro_torch.launch import ranks, serve
    t_phase = time.perf_counter()
    _mem_line(dev, "18", phase=18)
    one_a = one_card_run(dev, 18, "18a", MODEL14, PHASE14_BATCH["14a"],
                       PHASE18A_LAYERS)
    b14 = held["14b"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with ranks.start(math.prod(PHASE18_MESH), dev,
                     timeout_s=PHASE18_TIMEOUT_S) as world:
        probe = world.run(gloo_bf16_probe)
        emit({"phase": 18, "backend": world.backend, "pids": world.pids,
              "mesh": list(PHASE18_MESH), "bf16_psum": probe})
        if any(p["values"] != [1.015625] for p in probe):
            raise AssertionError(f"phase 18: a bfloat16 psum gave {probe}")
        if world.backend == "gloo" and any(p["transport"] != "card"
                                           for p in probe):
            raise AssertionError(f"phase 18: ranks sharing the card did "
                                 f"not reduce through it: {probe}")
        t0 = time.perf_counter()
        recs_a = world.run(phase18_rank, PHASE18_PROBE_LAYERS["18a"],
                           serve.programs_on_rank, MODEL14, "decode_32k",
                           PHASE14_BATCH["14a"], PHASE14_DECODE_STEPS,
                           PHASE18A_LAYERS, SEED, PHASE18_MESH,
                           PHASE18_CHECK_LAYERS, True)
        a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs_b = world.run(phase18_rank, PHASE18_PROBE_LAYERS["18b"],
                           moe_traced_rank, MODEL14B, "prefill_32k",
                           PHASE14_BATCH["14b"], 0, None, SEED,
                           PHASE18_MESH, (), True)
        b_s = time.perf_counter() - t0
        backend = world.backend
    probes = {"18a": recs_a[0]["probes"], "18b": recs_b[0]["probes"]}
    controls = {"18a": recs_a[0]["control_logits"],
                "18b": recs_b[0]["control_logits"]}
    for r in recs_a + recs_b:
        for key in ("probes", "control_logits", "step_logits"):
            r.pop(key, None)
    rec_a = serve.mesh_record(recs_a, backend)
    n = rec_a["layers"]
    bad = rank_problems("18a", recs_a, {
        "flash_attention": n,
        "flash_decode_partial": n * PHASE14_DECODE_STEPS,
        "decode_combine": n * PHASE14_DECODE_STEPS})
    if not rec_a["handoff_held_all_ranks"]:
        bad.append(f"18a: D's shards are not P's reshard: "
                   f"{[r['handoff_held'] for r in recs_a]}")
    logits_a = held_to_launch("18a", rec_a.pop("prefill_logits"),
                              one_a["last_logits"], controls["18a"])
    bad += logits_a.pop("problems")
    bad += tokens_held(rec_a["tokens"], one_a["tokens"],
                      one_a["token_gaps"])
    bad += probe_problems("18a", probes["18a"])
    emit({"phase": 18, "part": "18a", "model": f"{MODEL14} x{n} layers",
          "batch": PHASE14_BATCH["14a"], "part_s": round(a_s, 3),
          **rec_a, "tokens_one_card": one_a["tokens"], "vs_one_card": logits_a,
          "sub_blocks": probes["18a"],
          "predicted": PHASE18_PREDICTED["18a"]})
    rec_b = serve.mesh_record([{k: v for k, v in r.items()
                                if k not in ("drops", "routes")}
                               for r in recs_b], backend)
    bad += rank_problems("18b", recs_b,
                         {"flash_attention": rec_b["layers"]})
    logits_b = held_to_launch("18b", rec_b.pop("prefill_logits"),
                              b14["last_logits"], controls["18b"])
    bad += logits_b.pop("problems")
    bad += probe_problems("18b", probes["18b"])
    drops = [r["drops"] for r in recs_b]
    if drops[0] != drops[1]:
        bad.append(f"18b: the ranks drop different pairs: {drops}")
    if len(drops[0]) != len(b14["drops"]):
        bad.append(f"18b: {len(drops[0])} MoE layers, 14b "
                   f"{len(b14['drops'])}")
    flipped = [int((r.long() != w.long()).sum())
               for r, w in zip(recs_b[0]["routes"], b14["routes"])]
    emit({"phase": 18, "part": "18b", "model": f"{MODEL14B} x"
          f"{rec_b['layers']} layers", "batch": PHASE14_BATCH["14b"],
          "part_s": round(b_s, 3), **rec_b, "vs_14b": logits_b,
          "sub_blocks": probes["18b"],
          "drops": drops[0], "drops_14b": b14["drops"],
          "drops_equal_14b": drops[0] == b14["drops"],
          "choices_routed_differently": flipped,
          "predicted": PHASE18_PREDICTED["18b"]})
    launches = collections.Counter()
    for r in recs_a + recs_b:
        launches.update(r["launches"])
    emit({"phase": 18, "phase_s": round(time.perf_counter() - t_phase, 3),
          "launches_both_ranks": dict(launches), "problems": bad})
    if bad:
        raise AssertionError(f"phase 18: {bad}")
    return {"launches": dict(launches), "one_card_18a": one_a}


@contextlib.contextmanager
def deployed_vocab(axis: int):
    """The step builders deploy every arch at the vocab that a model axis
    of ``axis`` pads it to (``sharding.pad_vocab``) on any mesh: a one-card
    witness of a mesh run drawn at the mesh's deployed config. The
    weights are drawn from one generator, the embedding first, so a
    model drawn at another vocab differs everywhere."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as S
    real = S.get_config
    S.get_config = lambda arch: SH.pad_vocab(real(arch), axis)
    try:
        yield
    finally:
        S.get_config = real


def one_card_run(dev, phase: int, part: str, arch: str, batch: int,
                 layers=None):
    """A mesh part's one-card witness: ``arch`` (``layers`` of it, or all)
    prefill_32k -> handoff -> PHASE14_DECODE_STEPS greedy decode_32k steps
    at ``batch`` on the one-card mesh (``serve.programs_on_rank`` on a
    lone rank), the same seed and prompts as the ranks', at the vocab the
    ranks' model axis deploys (``deployed_vocab``). Returns, on the host,
    the prefill's last logits, the tokens and each token's top-2 gap, as
    phase 15 keeps them, and the run's launches."""
    from repro_torch.launch import ranks, serve
    with deployed_vocab(PHASE18_MESH[1]):
        rec = serve.programs_on_rank(
            ranks.Rank(0, 1, None, dev), arch, "decode_32k", batch,
            PHASE14_DECODE_STEPS, layers, SEED, (1, 1), (), True)
    emit({"phase": phase, "part": f"{part} one card",
          "seconds": rec["seconds"], "peak_gib": rec["peak_gib"],
          "launches": rec["launches"], "tokens": rec["tokens"]})
    logits = [rec["prefill_logits"]] + rec["step_logits"]
    return {"last_logits": rec["prefill_logits"], "tokens": rec["tokens"],
            "token_gaps": [top2_gap_and_bound(x) for x in logits],
            "launches": rec["launches"]}


@contextlib.contextmanager
def launches_uncounted():
    """Kernel launches inside the block leave the counts as they were (a
    control's, beside the main path)."""
    from repro_torch.kernels import ops
    saved = [(m, dict(m.LAUNCHES)) for m in ops._WRAPPERS]
    try:
        yield
    finally:
        for m, counts in saved:
            m.LAUNCHES.update(counts)


def long_traced(rank, long, program, *args):
    """``program(rank, *args)`` — a rank's main path, ``serve.
    programs_on_rank`` or a wrapper of it — with one long_500k serve step
    of ``long["arch"]`` (batch 1, q_offset the cell's 524,288): at the
    first decode step a batch-1 copy of D's shards straight from the
    handoff is taken, every position tag shifted by ``long["shift"]`` (a
    multiple of the ring, so that each entry keeps its slot; an SSM's
    states carry no position), and after the last decode step the long
    step runs over it fed ``long["token"]`` (its launches count with the
    path's), then from another copy with every psum missing the other
    rank's term (the control; its launches uncounted). The record gains
    ``long``: both gathered logits (float32, host), whether every tag
    sits on its slot of the rank's half, the largest tag, and with
    ``long["states"]`` the copy gathered whole on the host (rank 0's, in
    leaf order) for a one-card step over the same states."""
    import torch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import get_cell
    from repro_torch.models import collectives as C
    from repro_torch.models import layers as L
    real = S.make_serve_artifacts
    out = {}

    def kv_caches(caches):
        return [c for g in caches for c in g if isinstance(c, L.KVCache)]

    def make(cell, mesh, **kw):
        srv = real(cell, mesh, **kw)
        step, calls = srv.fn, [0]
        shard = mesh.axis_shard("model")
        cell_l = get_cell(long["arch"], "long_500k")
        srv_l = real(cell_l, mesh, **kw)
        q = cell_l.seq_len

        def start(caches):
            c = map_caches(caches, lambda x: x[:, :1].clone())
            index, size = (shard.index, shard.size) if shard else (0, 1)
            ok, top = True, -1
            for kv in kv_caches(c):
                kv.pos.copy_(torch.where(kv.pos >= 0, kv.pos + long["shift"],
                                         kv.pos))
                cap = kv.capacity
                slot = torch.arange(index * cap, (index + 1) * cap,
                                    device=kv.pos.device)
                ok &= bool((kv.pos % (cap * size) == slot).all())
                top = max(top, int(kv.pos.max()))
            out.update(copy=c, slots_ok=ok, max_tag=top, q_offset=q)
            if long.get("states"):
                specs = srv_l.in_shardings[1]
                whole = [x if SH.model_dim(specs[p]) is None else
                         C.all_gather(x, SH.model_dim(specs[p]), shard)
                         for p, x in SH.named_leaves(c)]
                if rank.index == 0:          # copies: the step writes c
                    out["states"] = [x.to("cpu", copy=True) for x in whole]
                del whole

        def run(params, caches):
            tok = torch.full((1, 1), long["token"], dtype=torch.int32,
                             device=params["embed"].device)
            io = {"tokens": tok, "positions": torch.full_like(tok, q)}
            logits, _ = srv_l.fn(params, caches, io, q_offset=q)
            return C.all_gather(logits[:, -1], 1, shard).float().cpu()

        def fn(params, caches, io, q_offset=None):
            if calls[0] == 0:
                start(caches)
            calls[0] += 1
            res = step(params, caches, io, q_offset)
            if calls[0] == long["after"]:
                control = map_caches(out["copy"], lambda x: x.clone())
                with torch.no_grad():
                    out["logits"] = run(params, out.pop("copy"))
                    real_psum = C.psum
                    C.psum = lambda x, shard_: x
                    try:
                        with launches_uncounted():
                            out["control_logits"] = run(params, control)
                    finally:
                        C.psum = real_psum
                del control
            return res
        return dataclasses.replace(srv, fn=fn)

    S.make_serve_artifacts = make
    try:
        rec = program(rank, *args)
    finally:
        S.make_serve_artifacts = real
    rec["long"] = out
    return rec


def embed_controlled(rank, program, *args):
    """``program(rank, *args)`` (``serve.programs_on_rank``'s arguments)
    and then its prefill again with every psum missing the other rank's
    term — in an SSM's prefill the embedding's alone: a token whose id
    is the other rank's embeds as zeros —, gathered: the record gains
    ``prefill_control_logits`` (float32, host). Its launches and
    collectives are not the path's (the record has them already)."""
    import torch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (make_prefill_artifacts,
                                          random_inputs)
    from repro_torch.models import collectives as C
    from repro_torch.models import model as M
    rec = program(rank, *args)
    arch, _shape, batch, _steps, layers, seed, mesh_shape = args[:7]
    mesh = make_mesh(mesh_shape, ("data", "model"), rank.device)
    cell = dataclasses.replace(get_cell(arch, "prefill_32k"), batch=batch)
    pre = make_prefill_artifacts(
        cell, mesh, layer_override={"num_layers": layers} if layers
        else None)
    params = M.init_params(pre.cfg, seed=seed, device=rank.device,
                           keep=SH.param_keeper(pre.in_shardings[0], mesh))
    inputs = random_inputs(pre.abstract_args[1], pre.cfg.vocab_size, seed,
                           rank.device)
    real_psum = C.psum
    C.psum = lambda x, shard_: x
    try:
        with torch.no_grad(), launches_uncounted():
            last, caches = pre.fn(params, inputs)
            del caches
            rec["prefill_control_logits"] = C.all_gather(
                last, 1, mesh.axis_shard("model")).float().cpu()
    finally:
        C.psum = real_psum
    return rec


def mesh_world(dev):
    """Phase 18's world of ranks for phases 19 and 20: two ranks of ~30
    GiB each share the card, so their allocators grow segments rather
    than cut new ones (less memory lost to fragments)."""
    from repro_torch.launch import ranks
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        return ranks.start(math.prod(PHASE18_MESH), dev,
                           timeout_s=PHASE18_TIMEOUT_S)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def one_card_long(dev, arch: str, layers, states, token: int):
    """The one-card long_500k serve step (batch 1, q_offset the cell's)
    of ``arch`` (``layers`` of it, or all; drawn from SEED at the mesh's
    deployed vocab) over ``states`` — a mesh part's batch-1 copy of D's
    shards gathered whole (``long_traced``), in leaf order — fed
    ``token``: the float32 logits (1, V) on the host."""
    import torch
    from repro_torch.launch import steps as S
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.training.tree import leaves_with_paths, unflatten
    cell = get_cell(arch, "long_500k")
    with deployed_vocab(PHASE18_MESH[1]):
        srv = S.make_serve_artifacts(
            cell, make_mesh((1, 1), ("data", "model"), dev),
            layer_override={"num_layers": layers} if layers else None)
        params = M.init_params(srv.cfg, seed=SEED, device=dev)
    given = iter(states)          # tensor leaves; the flags are the tree's
    caches = unflatten(srv.abstract_args[1], [
        next(given).to(dev) if isinstance(x, torch.Tensor) else x
        for _, x in leaves_with_paths(srv.abstract_args[1])])
    tok = torch.full((1, 1), token, dtype=torch.int32, device=dev)
    q = cell.seq_len
    with torch.no_grad():
        logits, _ = srv.fn(params, caches, {
            "tokens": tok, "positions": torch.full_like(tok, q)}, q_offset=q)
    return logits[:, -1].float().cpu()


def long_problems(dev, part: str, arch: str, layers, longs, steps: int,
                  token: int, phase15=None) -> tuple:
    """A part's long_500k step (``long_traced``'s records, one a rank)
    against the one-card step over the same states (``one_card_long``)
    by ``held_to_launch`` within ``steps`` bf16 steps, its control past
    them; every tag on its slot and the largest the last position before
    q_offset (none for an SSM). With ``phase15`` (15d's logits of the
    one-card run's own states): its argmax equal, or 15d's top-2 gap
    within ``top2_gap_and_bound``'s (the token rule); the logit gap is
    printed, as it carries the mesh prefill's drift into D's caches.
    Emits the record and returns the problems."""
    t0 = time.perf_counter()
    got = longs[0]
    want = one_card_long(dev, arch, layers, got.pop("states"), token)
    rec = held_to_launch(f"{part} long_500k", got["logits"], want,
                         got["control_logits"], steps)
    bad = rec.pop("problems")
    if not all(r["slots_ok"] for r in longs):
        bad.append(f"{part} long_500k: tags off their slots after the shift")
    tops = [r["max_tag"] for r in longs]
    if max(tops) not in (-1, got["q_offset"] - 1):
        bad.append(f"{part} long_500k: largest tag {max(tops)}")
    out = {"phase": int(part[:2]), "part": f"{part} long_500k",
           "q_offset": got["q_offset"], "token": token,
           "max_tag_by_rank": tops, "vs_one_card_same_states": rec}
    if phase15 is not None:
        (gap, limit), = top2_gap_and_bound(phase15)
        same = bool((got["logits"].argmax(-1) == phase15.argmax(-1)).all())
        out["vs_15d"] = {
            "max_abs_logit_gap": float((got["logits"] - phase15).abs().max()),
            "bf16_step": bf16_step(phase15), "argmax_equal": same,
            "top2_gap_15d": gap}
        if not same and not gap <= limit:
            bad.append(f"{part} long_500k: argmax differs from 15d's, its "
                       f"top-2 gap {gap} > {limit}")
    out.update(one_card_s=round(time.perf_counter() - t0, 3), problems=bad)
    emit(out)
    return bad


def phase19(dev, held):
    """The launch layer's remaining attention-cache families on phase
    18's (1, 2) mesh of ranks (gloo on the one card; the backend printed):
    19a Qwen1.5-32B (4 of 64 layers, batch 2: P's head_dim-sharded bf16
    caches cast to e4m3 in the handoff), 19b Mixtral-8x7B (12 of 32, batch
    2: rings of 4096 slots cut into slot halves, the expert-TP MoE), 19c
    RecurrentGemma-9B (all 38, batch 2: RG-LRU blocks on the width's
    halves, local attention over rings of 2048 on one KV head), 19d
    DeepSeek-V2-Lite (all 27, batch 1: MLA's latent handed off in capacity
    halves, each decode step expanding the rank's half through every
    head). Each part runs ``serve.programs_on_rank`` (what ``python -m
    repro_torch.launch.serve --mesh 1x2`` runs) on both ranks: prefill_32k
    -> handoff -> PHASE14_DECODE_STEPS greedy decode_32k steps, and holds,
    as phase 18: the bytes to ``per_chip_bytes``; D's shards of
    PHASE19_CHECK_LAYERS to the reshard of P's bit for bit (the e4m3 cast,
    the ring slots with their tags, the latent halves, the RG-LRU states);
    the gathered prefill logits to the one-card run's within
    PHASE18_LOGIT_STEPS bf16 steps (19c: PHASE19_LOGIT_STEPS) with the
    control past it; the tokens
    (``tokens_held``); the sub-blocks of PHASE19_PROBES against float32
    witnesses within PHASE18_WITNESS_FACTOR of one card's error, each
    control failing it, the MoE's routes and drops equal to one card's;
    and per rank exactly the path's launches: flash a prefill attention
    layer, flash_decode_partial and decode_combine a decode step and
    attention layer. 19b and 19c also take one long_500k serve step
    (``long_traced``: batch 1, D's rings from the handoff with every tag
    shifted by PHASE15_SHIFT, q_offset 524,288, fed 15d's token), held to
    a one-card step over the same states by the part's logit bound with
    its control (every psum missing the other rank's term) past it, and
    to 15d's logits by the token rule (``long_problems``: the mesh's D
    caches carry its prefill's drift, so 15d's logits are a few bf16
    steps further off); its partial and combine launches count with the
    path's. The one-card runs: phase 15's
    (``held``, on the host) for 19a-19c, ``one_card_run`` for 19d.
    Returns the launches summed over both ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.cells import get_cell
    t_phase = time.perf_counter()
    _mem_line(dev, "19", phase=19)
    t0 = time.perf_counter()
    ones = {part: held[src] for part, src in PHASE19_HELD.items()}
    ones["19d"] = one_card_run(dev, 19, "19d", MODEL14B,
                               PHASE19_PARTS["19d"][2])
    one_s = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _mem_line(dev, "19 world", phase=19)
    bad, launches, parts_s, longs = [], collections.Counter(), {}, {}
    with mesh_world(dev) as world:
        emit({"phase": 19, "backend": world.backend, "pids": world.pids,
              "mesh": list(PHASE18_MESH), "one_card_19d_s": round(one_s, 3)})
        for part, (arch, layers, batch, moe) in PHASE19_PARTS.items():
            t0 = time.perf_counter()
            program = (moe_traced_rank if moe else serve.programs_on_rank,)
            one = ones[part]
            if part in PHASE20_LONG:
                program = (long_traced, {
                    "arch": arch, "shift": PHASE15_SHIFT,
                    "token": one["long_token"], "states": True,
                    "after": PHASE14_DECODE_STEPS}) + program
            recs = world.run(phase18_rank, PHASE19_PROBES[part], *program,
                             arch, "decode_32k", batch, PHASE14_DECODE_STEPS,
                             layers, SEED, PHASE18_MESH,
                             PHASE19_CHECK_LAYERS[part], True)
            parts_s[part] = round(time.perf_counter() - t0, 3)
            probes = recs[0]["probes"]
            control = recs[0]["control_logits"]
            routes_drops = [r.pop("drops", None) for r in recs]
            if part in PHASE20_LONG:
                longs[part] = [r.pop("long") for r in recs]
            for r in recs:
                for key in ("probes", "control_logits", "routes",
                            "step_logits"):
                    r.pop(key, None)
            rec = serve.mesh_record(recs, world.backend)
            cfg = get_config(arch)
            cfg = cfg.with_(num_layers=layers) if layers else cfg
            attn = attending_layers(cfg)
            # the decode steps' and the long_500k step's
            steps = PHASE14_DECODE_STEPS + (part in PHASE20_LONG)
            part_bad = rank_problems(part, recs, {
                "flash_attention": attn,
                "flash_decode_partial": attn * steps,
                "decode_combine": attn * steps})
            if not rec["handoff_held_all_ranks"]:
                part_bad.append(f"{part}: D's shards are not P's reshard: "
                                f"{[r['handoff_held'] for r in recs]}")
            vs = held_to_launch(part, rec.pop("prefill_logits"),
                                one["last_logits"], control,
                                PHASE19_LOGIT_STEPS.get(
                                    part, PHASE18_LOGIT_STEPS))
            part_bad += vs.pop("problems")
            part_bad += [f"{part} {p}" for p in tokens_held(
                rec["tokens"], one["tokens"], one["token_gaps"])]
            part_bad += probe_problems(part, probes)
            if moe and routes_drops[0] != routes_drops[1]:
                part_bad.append(f"{part}: the ranks drop different pairs")
            emit({"phase": 19, "part": part,
                  "model": f"{arch} x{rec['layers']} layers",
                  "batch": batch, "part_s": parts_s[part],
                  "d_cache": get_cell(arch, "decode_32k").cache_dtype,
                  **rec,
                  "tokens_one_card": one["tokens"], "vs_one_card": vs,
                  "sub_blocks": probes, "drops": routes_drops[0],
                  "predicted": PHASE19_PREDICTED[part],
                  "problems": part_bad})
            bad += part_bad
            for r in recs:
                launches.update(r["launches"])
            del recs, probes, control
            gc.collect()
    for part, mine in longs.items():         # the world's memory is free
        arch, layers = PHASE19_PARTS[part][:2]
        bad += long_problems(
            dev, part, arch, layers, mine,
            PHASE19_LOGIT_STEPS.get(part, PHASE18_LOGIT_STEPS),
            ones[part]["long_token"], ones[part]["long_logits"])
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": 19, "phase_s": round(time.perf_counter() - t_phase, 3),
          "parts_s": parts_s, "launches_both_ranks": dict(launches),
          "predicted_s": PHASE19_PREDICTED["phase_s"], "problems": bad})
    if bad:
        raise AssertionError(f"phase 19: {bad}")
    return {"launches": dict(launches)}



def phase20_expected(cfg, steps: int) -> dict:
    """Per rank, the launches of a phase-20 part's main path: flash for
    every attention layer of the prefill (an encoder's too) and for every
    cross-attention of the prefill and of each decode step, and per decode
    step flash_decode_partial and decode_combine for every self-attention
    layer; an SSM none."""
    attn = attending_layers(cfg)
    cross = cfg.num_layers if cfg.is_enc_dec else 0
    enc = cfg.encoder_layers if cfg.is_enc_dec else 0
    return {"flash_attention": attn + enc + cross * (1 + steps),
            "flash_decode_partial": attn * steps,
            "decode_combine": attn * steps}


def phase20(dev):
    """The SSD, vision and encoder-decoder families on phase 18's (1, 2)
    mesh of ranks (gloo on the one card), at full width and depth: 20a
    Mamba2-370M (48 SSD layers, batch 2: the SSD replicated, its conv
    tail sharded on the channels, gathered before each conv), 20b
    InternVL2-2B (24 layers, batch 1, 256 patches + 32,512 tokens, the
    vocab padded to 92,554), 20c Whisper-large-v3 (32 encoder + 32
    decoder layers, batch 1, 1,500 frames; the cross rows head_dim-sharded
    in P and D, gathered before each cross-attention). Each part runs
    ``serve.programs_on_rank`` (what ``python -m repro_torch.launch.serve
    --mesh 1x2`` runs) on both ranks: prefill_32k -> handoff ->
    PHASE14_DECODE_STEPS greedy decode_32k steps, held as phase 19 holds
    its parts: bytes to ``per_chip_bytes``; D's shards of
    PHASE20_CHECK_LAYERS bit for bit the reshard of P's (the SSM states
    and conv-tail halves, the cross rows); the gathered prefill logits
    within PHASE18_LOGIT_STEPS bf16 steps (20c: PHASE20_LOGIT_STEPS) of a
    one-card run's made here at
    the mesh's deployed config (``one_card_run``), the control past them
    (20a's: its prefill with the embedding's psum missing the other
    rank's term, ``embed_controlled``); the tokens (``tokens_held``); the
    sub-blocks of PHASE20_PROBES against float32 witnesses within
    PHASE18_WITNESS_FACTOR of one card's error, each control failing it;
    per rank exactly the one-card run's launches on the same layers
    (``phase20_expected``). 20a also takes one long_500k step
    (``long_traced``) over a batch-1 copy of D's states, held to a
    one-card long_500k step over the same states. Returns the launches
    summed over both ranks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.cells import get_cell
    t_phase = time.perf_counter()
    _mem_line(dev, "20", phase=20)
    steps = PHASE14_DECODE_STEPS
    ones, one_s = {}, {}
    for part, (arch, batch) in PHASE20_PARTS.items():
        t0 = time.perf_counter()
        ones[part] = one_card_run(dev, 20, part, arch, batch)
        one_s[part] = round(time.perf_counter() - t0, 3)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    bad, launches, parts_s, longs = [], collections.Counter(), {}, {}
    with mesh_world(dev) as world:
        emit({"phase": 20, "backend": world.backend, "pids": world.pids,
              "mesh": list(PHASE18_MESH), "one_card_s": one_s})
        for part, (arch, batch) in PHASE20_PARTS.items():
            one = ones[part]
            program = (serve.programs_on_rank,)
            if part == "20a":
                program = (long_traced, {
                    "arch": arch, "shift": 0, "token": one["tokens"][0][0],
                    "after": steps, "states": True}, embed_controlled) \
                    + program
            t0 = time.perf_counter()
            recs = world.run(phase18_rank, PHASE20_PROBES[part], *program,
                             arch, "decode_32k", batch, steps, None, SEED,
                             PHASE18_MESH, PHASE20_CHECK_LAYERS[part], True)
            parts_s[part] = round(time.perf_counter() - t0, 3)
            probes = recs[0]["probes"]
            control = recs[0]["control_logits"]
            for r in recs:
                for key in ("probes", "control_logits", "step_logits"):
                    r.pop(key, None)
                if "long" in r:
                    longs.setdefault(part, []).append(r.pop("long"))
            rec = serve.mesh_record(recs, world.backend)
            cfg = get_config(arch)
            expect = phase20_expected(cfg, steps)
            part_bad = rank_problems(part, recs, expect)
            one_launches = {k: v for k, v in one["launches"].items() if v}
            one_want = {k: v for k, v in {
                "flash_attention": expect["flash_attention"],
                "flash_decode": expect["flash_decode_partial"]}.items() if v}
            if one_launches != one_want:
                part_bad.append(f"{part}: the one-card run launched "
                                f"{one_launches}, its path {one_want}")
            if not rec["handoff_held_all_ranks"]:
                part_bad.append(f"{part}: D's shards are not P's reshard: "
                                f"{[r['handoff_held'] for r in recs]}")
            vs = held_to_launch(part, rec.pop("prefill_logits"),
                                one["last_logits"], control,
                                PHASE20_LOGIT_STEPS.get(
                                    part, PHASE18_LOGIT_STEPS))
            part_bad += vs.pop("problems")
            part_bad += [f"{part} {p}" for p in tokens_held(
                rec["tokens"], one["tokens"], one["token_gaps"])]
            part_bad += probe_problems(part, probes)
            emit({"phase": 20, "part": part,
                  "model": f"{arch} x{rec['layers']} layers",
                  "batch": batch, "part_s": parts_s[part],
                  "d_cache": get_cell(arch, "decode_32k").cache_dtype,
                  **rec, "tokens_one_card": one["tokens"],
                  "launches_expected": expect, "one_card_launches":
                  one["launches"], "vs_one_card": vs, "sub_blocks": probes,
                  "predicted": PHASE20_PREDICTED[part],
                  "problems": part_bad})
            bad += part_bad
            for r in recs:
                launches.update(r["launches"])
            del recs, probes, control
            gc.collect()
    # 20a's long_500k step against one card's over the same states
    bad += long_problems(dev, "20a", PHASE20_PARTS["20a"][0], None,
                         longs.pop("20a"), PHASE18_LOGIT_STEPS,
                         ones["20a"]["tokens"][0][0])
    emit({"phase": 20, "phase_s": round(time.perf_counter() - t_phase, 3),
          "parts_s": parts_s, "launches_both_ranks": dict(launches),
          "predicted_s": PHASE20_PREDICTED["phase_s"], "problems": bad})
    if bad:
        raise AssertionError(f"phase 20: {bad}")
    return {"launches": dict(launches)}


# --------------------------------------------------------------------------- #
# phase 21: the data and pod axes of a mesh of ranks
# --------------------------------------------------------------------------- #
def train_part(part: str) -> dict:
    """A training part of phases 21 and 22: its arch, layer cut, mesh
    shape, micro-batches, main-path steps, controls [(the reduction left
    out, the path keys of the leaves it is judged on; None: every leaf's
    norm)] and whether its witness runs each data rank's rows on their
    own (``phase22_shard_step``)."""
    if part in PHASE21_TRAIN:
        arch, layers, shape, n_micro = PHASE21_TRAIN[part]
        return dict(phase=21, arch=arch, layers=layers, shape=shape,
                    n_micro=n_micro, steps=1 + PHASE21_STEPS,
                    controls=[(PHASE21_CONTROL[part], None)], shards=False,
                    predicted=PHASE21_PREDICTED[part])
    arch, layers = PHASE22_TRAIN[part]
    return dict(phase=22, arch=arch, layers=layers, shape=PHASE22_MESH,
                n_micro=1, steps=PHASE22_STEPS,
                controls=PHASE22_CONTROLS[part], shards=True,
                predicted=PHASE22_PREDICTED[part])


def phase21_batch(art, seed: int, dev):
    """A train step's whole batch (``launch.train.train_batch``: patches
    or frames beside the tokens where the model takes them) with label -1
    on the second sequence's last PHASE21_UNLABELED positions."""
    from repro_torch.launch import train
    batch = train.train_batch(art, seed, dev)
    batch["labels"][1, -PHASE21_UNLABELED:] = -1
    return batch


def phase21_steps(art, state, dev, steps: int, step=None):
    """``steps`` steps of ``step`` (``art.fn`` unless given) from
    ``state`` over ``phase21_batch(seed + i)``: each step's loss, grad
    norm (and the witness's norms over the controls' leaves, where the
    step gives them) and seconds (after a synchronize), and the state."""
    import torch
    step = step or art.fn
    out = []
    for i in range(steps):
        batch = phase21_batch(art, SEED + i, dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        if "touched" in m:
            rec["touched"] = m["touched"]
        _sync(dev)
        rec["s"] = time.perf_counter() - t0
        out.append(rec)
        if not (math.isfinite(rec["loss"]) and math.isfinite(
                rec["grad_norm"])):
            raise FloatingPointError(f"training step {i}: {rec}")
        del batch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, state


def phase22_shard_step(art, opt, controls=(), sink=None,
                       ways: int = PHASE22_MESH[0]):
    """The one-card witness's step of a phase 22 part: each of the ``ways``
    data ranks' rows through the model on their own (the MoE at the
    capacity of that shard's tokens, as each rank routes them), the loss
    the sum of the shards' numerators over the sum of their counts —
    each shard's mean scaled by its share of the labels before its
    backward — and the shards' gradients (the parameter dtype) added, as
    the mesh's data sum adds them (the second backward accumulates into
    the first's gradients in place); then AdamW at ``opt``, in place.
    Metrics: loss, grad norm, lr. With ``sink``, the gradients of the
    leaves ``controls`` judge go there ({path: a copy in the host's pinned
    memory})."""
    import torch
    from repro_torch.launch import steps as TS
    from repro_torch.models import dist
    from repro_torch.models import model as M
    from repro_torch.training.optim import adamw_update
    from repro_torch.training.train_step import TrainState
    from repro_torch.training.tree import leaves_with_paths, unflatten
    dctx = TS._dctx(art.mesh, ("data",), "model", mode="train")

    def step(state, batch):
        n = batch["labels"].shape[0] // ways
        count = int((batch["labels"] >= 0).sum())
        paths, flat = zip(*leaves_with_paths(state.params))
        live = [p.detach().requires_grad_() for p in flat]
        params = unflatten(state.params, live)
        loss = 0.0
        for r in range(ways):
            rows = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
            share = int((rows["labels"] >= 0).sum()) / count
            with dist.use(dctx), torch.enable_grad():
                part = M.loss_fn(params, art.cfg, rows, remat=True) * share
                part.backward()
            loss += float(part.detach())
            del part
        acc = [torch.zeros_like(p) if x.grad is None else x.grad
               for p, x in zip(flat, live)]
        del live, params
        if sink is not None:
            pin = acc[0].is_cuda
            sink.update((p, torch.empty(g.shape, dtype=g.dtype,
                                        pin_memory=pin).copy_(g))
                        for p, g in zip(paths, acc)
                        if any(k in p for _, keys in controls for k in keys))
        params, opt_state, m = adamw_update(
            opt, state.params, unflatten(state.params, acc), state.opt)
        del acc
        return TrainState(params=params, opt=opt_state), {"loss": loss, **m}

    return step


def phase21_witness(dev, part: str) -> dict:
    """A training part's one-card witness: its arch and cut on the one-card
    mesh at PHASE21_BATCH (``launch.train.train_state_on_rank`` at (1, 1),
    the same seed), the same steps over the whole batch (a phase 22 part:
    ``phase22_shard_step``, whose update step — its main path — also
    keeps the gradients of its controls' leaves), then the update step
    (``phase21_update_step``). Its parameters before (phase 21: the
    ranks hold their own draw, the same as the witness's, for phase 22)
    and after the update step and its final moments are kept in the
    host's pinned memory ({path: tensor} trees) with each step's loss and
    norm, and the card is freed for the ranks. A phase 22 part's witness
    also keeps each data shard's top-k experts in the update step's first
    forward (``first_routes``; None without MoE layers)."""
    import torch
    from repro_torch.launch import train
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.tree import leaves_with_paths
    spec = train_part(part)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # a phase 22 part's witness at the vocab the ranks' model axis pads to
    vocab = deployed_vocab(spec["shape"][-1]) if spec["shards"] else \
        contextlib.nullcontext()
    with vocab:
        art, state = train.train_state_on_rank(
            spec["arch"], PHASE21_BATCH, spec["n_micro"], spec["layers"],
            SEED, (1, 1), dev)
        step = phase22_shard_step(art, AdamWConfig()) if spec["shards"] \
            else None
        steps, state = phase21_steps(art, state, dev, spec["steps"], step)
        pin = _host_cache_free() is not None

        def pinned(tree):
            return {p: torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
                    .copy_(x) for p, x in leaves_with_paths(tree)}
        held = {} if spec["shards"] else {"before": pinned(state.params)}
        touched = {}
        with routes_recorded() as seen:
            update, state = phase21_update_step(part, art.mesh, state, dev,
                                                witness=True, sink=touched)
        routes = first_routes(art.cfg, seen, PHASE22_MESH[0]) \
            if spec["shards"] else None
    held.update((kind, pinned(tree)) for kind, tree in (
        ("params", state.params), ("mu", state.opt["mu"]),
        ("nu", state.opt["nu"])))
    del state, art
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = {"phase": spec["phase"], "part": f"{part} one card",
           "steps": steps, "update_step": update,
           "s": round(time.perf_counter() - t0, 3),
           "peak_gib": _peak_gib(dev)}
    emit(rec)
    return {"steps": steps, "update_step": update, "held": held,
            "touched": touched, "routes": routes}


def _host_cache_free():
    """The call that gives the framework's cached pinned host memory back
    (phase 22's witnesses' states, six models one after another, would
    otherwise stay pinned in this process beyond the host's memory;
    phase 21's parts reuse each other's), or None: then the witnesses'
    states are kept in pageable memory."""
    import torch
    if not torch.cuda.is_available():
        return None
    return getattr(torch._C, "_host_emptyCache", None)


def phase21_update_step(part: str, mesh, state, dev, witness: bool = False,
                        sink=None):
    """The update step: the part's train artifacts on ``mesh`` stepping
    AdamW at PHASE21_OPT (the witness of a phase 22 part:
    ``phase22_shard_step`` at it), one step from ``state`` over
    ``phase21_batch(SEED + the part's main-path steps)``; the witness's
    gradients of its controls' leaves go to ``sink``. Returns ({"loss",
    "grad_norm", "lr", "s"}, state)."""
    from repro_torch.training.optim import AdamWConfig
    spec = train_part(part)
    art = update_artifacts(part, mesh)
    step = art.fn
    if witness and spec["shards"]:
        step = phase22_shard_step(art, AdamWConfig(**PHASE21_OPT),
                                  spec["controls"], sink)
    batch = phase21_batch(art, SEED + spec["steps"], dev)
    _sync(dev)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "lr": float(m["lr"])}
    _sync(dev)
    out["s"] = time.perf_counter() - t0
    return out, state


def update_artifacts(part: str, mesh):
    """The part's train artifacts on ``mesh`` stepping AdamW at
    PHASE21_OPT."""
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.steps import make_train_artifacts
    spec = train_part(part)
    cell = dataclasses.replace(get_cell(spec["arch"], "train_4k"),
                               batch=PHASE21_BATCH, n_micro=spec["n_micro"])
    layers = spec["layers"]
    with phase21_opt():
        return make_train_artifacts(
            cell, mesh,
            layer_override={"num_layers": layers} if layers else None)


@contextlib.contextmanager
def routes_recorded():
    """Every ``layers.moe_route`` call's top-k experts inside the block,
    each token's sorted, on the host, in call order (the yielded list)."""
    import torch
    from repro_torch.models import layers as L
    real = L.moe_route
    seen = []

    def spy(p, cfg, x2d):
        weights, idx = real(p, cfg, x2d)
        seen.append(torch.sort(idx, dim=-1).values.cpu())
        return weights, idx

    L.moe_route = spy
    try:
        yield seen
    finally:
        L.moe_route = real


def first_routes(cfg, seen: list, shards: int = 1):
    """Of the routes ``routes_recorded`` saw over ``shards`` forwards, each
    under remat and followed by its backward (each MoE layer routed
    twice: its forward, then its recompute), each shard's first forward:
    [shard][MoE layer] top-k experts; None for a model without MoE
    layers."""
    from repro_torch.models import model as M
    n = sum(g.count for g in M.block_groups(cfg) if g.moe)
    if not n:
        return None
    if len(seen) < 2 * n * shards:
        raise AssertionError(f"{len(seen)} routings seen, {shards} "
                             f"forwards of {n} MoE layers make {2 * n}")
    return [seen[2 * n * r:2 * n * r + n] for r in range(shards)]


def train_expected(part: str) -> dict:
    """The collectives a rank of a training part calls in its main path
    (the part's steps), {name: {"calls", "bytes"}}, from the deployed
    config and the specs alone (on ``meta``). Per micro-batch, on a model
    axis of m: the embedding's psum, the logits' gather and the head's
    entry; per layer, by kind, the forward's collectives, the remat's
    recompute of them — which stops at the last saved tensor, before the
    layer's last psum (its MLP's, MoE's; none for an SSD layer) — and the
    backward's psums, one a ``column_entry`` (the attention's, the MLP's,
    MoE's tokens and gate weights, MLA's x, latent and kpe, the RG-LRU's
    x, the cross-attention's x and memory) and one a split gather (K/V,
    the RG-LRU's ``xb``, the cross K/V); an enc-dec model's encoder layers
    (remat too) over its frames. On data axes the loss's two psums, each
    gradient leaf's psum in slices of ``optim.SLICE_ELEMS`` rows (a leaf
    the data axes do not split), ZeRO-3's gathers (the top-level leaves)
    and broadcasts or gathers (a layer's leaves, split on the layer axis
    or inside the layer) with the recompute's and a psum each in the
    backward; per step one psum a norm plane and one ZeRO-1 gather a leaf
    whose moments alone the data axes split."""
    from repro_torch.configs.base import ATTN, RECURRENT, SSD
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.cells import get_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import mesh_axes
    from repro_torch.launch.steps import make_train_artifacts
    from repro_torch.models import model as M
    from repro_torch.training.optim import SLICE_ELEMS
    spec = train_part(part)
    mesh_shape, n_micro = spec["shape"], spec["n_micro"]
    axes = mesh_axes(mesh_shape)
    sizes = dict(zip(axes, mesh_shape))
    cell = dataclasses.replace(get_cell(spec["arch"], "train_4k"),
                               batch=PHASE21_BATCH, n_micro=n_micro)
    art = make_train_artifacts(
        cell, Mesh(tuple(mesh_shape), axes, _meta_device()),
        layer_override={"num_layers": spec["layers"]}
        if spec["layers"] else None)
    cfg = art.cfg
    m = sizes["model"]
    data = tuple(a for a in axes if a != "model")
    dp = math.prod(sizes[a] for a in data)
    specs = art.in_shardings[0]
    e = 2 if cfg.compute_dtype == "bfloat16" else 4
    pe = 2 if cfg.param_dtype == "bfloat16" else 4
    rows = PHASE21_BATCH // dp // n_micro          # sequences a micro-batch
    toks = rows * art.abstract_args[1]["tokens"].shape[1]
    vision = cfg.frontend.kind == "vision"
    tokens = toks + (rows * cfg.frontend.num_patches if vision else 0)
    micro = {"calls": collections.Counter(), "bytes": collections.Counter()}
    step = {"calls": collections.Counter(), "bytes": collections.Counter()}

    def add(to, name, n, total):
        to["calls"][name] += n
        to["bytes"][name] += total

    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.hd

    def attention(t):                 # K/V gathered on head_dim, wo's psum
        kvb = 2 * t * kv * hd * e
        add(micro, "all_gather", 2, 2 * kvb // m)     # + recompute
        add(micro, "psum", 2, 2 * t * d * e)          # wo, recompute
        add(micro, "psum", 2, t * d * e + kvb)        # x's entry, K/V's grad
        if cfg.qk_norm:
            add(micro, "psum", 2, 2 * hd * pe)        # q_norm, k_norm

    def mla(t):
        ml = cfg.mla
        add(micro, "psum", 2, 2 * t * d * e)          # wo, recompute
        add(micro, "psum", 3, t * (d + ml.kv_lora_rank
                                   + ml.qk_rope_head_dim) * e)  # entries

    def mlp(t, moe):                  # its psum is the layer's last
        add(micro, "psum", 2, 2 * t * d * e)          # forward, entry
        if moe:
            add(micro, "psum", 1, t * cfg.moe.top_k * 4)  # gate weights

    def rglru(t):
        w = cfg.recurrent.lru_width or d
        add(micro, "all_gather", 2, 2 * t * w // m * e)  # xb, recompute
        add(micro, "psum", 2, 2 * t * d * e)          # w_out, recompute
        add(micro, "psum", 2, t * d * e + t * w * e)  # x's entry, xb's grad

    def cross(t, mem):
        kvb = 2 * mem * kv * hd * e
        add(micro, "all_gather", 2, 2 * kvb // m)     # + recompute
        add(micro, "psum", 2, 2 * t * d * e)          # wo, recompute
        add(micro, "psum", 3, t * d * e + mem * d * e + kvb)

    if m > 1:
        add(micro, "psum", 1, toks * d * e)           # the embedding
        add(micro, "psum", 1, tokens * d * e)         # the head's entry
        add(micro, "all_gather", 1, tokens * cfg.vocab_size // m * e)
        mem = rows * cfg.max_source_len
        if cfg.is_enc_dec:
            for g in M.encoder_groups(cfg):
                for _ in range(g.count):
                    attention(mem)
                    mlp(mem, False)
        for g in M.block_groups(cfg):
            for _ in range(g.count):
                for kind in g.kinds:
                    if kind == SSD:
                        continue
                    if kind == RECURRENT:
                        rglru(tokens)
                    elif cfg.attention_kind == "mla":
                        mla(tokens)
                    else:
                        attention(tokens)
                    if g.cross:
                        cross(tokens, mem)
                    mlp(tokens, g.moe and kind == ATTN)
    if dp > 1:
        add(micro, "psum", 2, 4 + 8)                  # numerator, count
    planes = set()
    model_only = Mesh(tuple(mesh_shape), axes, None, (0,) * len(axes))
    for p, x in SH.named_leaves(art.abstract_args[0].params):
        spec_p = specs[".params" + p]
        local = SH.local_shape(tuple(x.shape), tuple(
            "model" if "model" in SH._entry_axes(en) else None
            for en in spec_p), model_only)
        lb = math.prod(local) * x.element_size()
        live = {a for en in spec_p for a in SH._entry_axes(en)
                if sizes[a] > 1}
        if live:
            planes.add(tuple(sorted(live)))
        if dp > 1 and live & set(data):               # ZeRO-3
            if {"groups", "enc_groups"} & set(SH.path_names(p)):
                n, layer = local[0], lb // local[0]
                name, part_b = (("broadcast", layer)
                                if SH.model_dim(spec_p, data[0]) == 0
                                else ("all_gather", layer // dp))
                add(micro, name, 2 * n, 2 * n * part_b)   # + recompute
                add(micro, "psum", n, n * layer)
            else:
                add(micro, "all_gather", 1, lb // dp)
                add(micro, "psum", 1, lb)
        elif dp > 1:                                  # the data psum
            rows_s = max(1, SLICE_ELEMS // max(1, math.prod(local[1:])))
            add(micro, "psum", -(-local[0] // rows_s), lb)
            if SH.model_dim(specs[".opt['mu']" + p], data[0]) is not None:
                add(step, "all_gather", 1, lb // dp)      # ZeRO-1
    add(step, "psum", len(planes), 4 * len(planes))       # the norm
    n = spec["steps"] or 1          # phase 22: the update step
    return {name: {k: n * (n_micro * micro[k][name] + step[k][name])
                   for k in ("calls", "bytes")}
            for name in ("psum", "all_gather", "exchange", "broadcast")}


def _meta_device():
    import torch
    return torch.device("meta")


def _bf16_steps(got, want) -> float:
    """The largest gap of ``got`` from ``want`` in bf16 steps of ``want``'s
    largest magnitude (``bf16_step``)."""
    step = bf16_step(want)
    gap = float((got.float() - want.float()).abs().max())
    return gap / step if step else (0.0 if gap == 0 else math.inf)


_PHASE21_KEPT: dict = {}          # a rank's trained state, between calls


@contextlib.contextmanager
def phase21_opt():
    """The train artifacts built inside the block step AdamW at
    PHASE21_OPT."""
    from repro_torch.launch import steps
    from repro_torch.training.optim import AdamWConfig
    saved = steps.AdamWConfig
    steps.AdamWConfig = functools.partial(AdamWConfig, **PHASE21_OPT)
    try:
        yield
    finally:
        steps.AdamWConfig = saved


def leaves_gap(grads, want, layout, keys, specs, mesh,
               local: bool = False) -> float:
    """The relative L2 gap of the rank's gradients ``grads`` from the
    rank's slices (``specs``) of the witness's whole ones ``want`` (on
    the card) over the leaves whose path holds one of ``keys``: each
    leaf's squares summed over the plane of the axes that split it, as
    ``optim.global_norm`` sums them (``local``: the rank's slices
    alone)."""
    import torch
    from repro_torch.launch import sharding as SH
    from repro_torch.models import collectives as C
    from repro_torch.training.tree import leaves_with_paths
    parts = {}
    for i, (p, x) in enumerate(leaves_with_paths(grads)):
        if any(k in p for k in keys):
            w = SH.rank_slice(want[p], specs[p], mesh).float()
            plane = layout.norm[i]
            sums = torch.stack([torch.sum(torch.square(x.float() - w)),
                                torch.sum(torch.square(w))])
            parts[plane] = parts[plane] + sums if plane in parts else sums
    total = sum(v if local else C.psum(v, plane)
                for plane, v in parts.items())
    return _relative(float(total[0]), float(total[1]))


def phase21_rank(rank, part: str, want=None, routes=None):
    """A training part's rank: the rank's shards of the seed's train state
    (``launch.train.train_state_on_rank``, what ``python -m
    repro_torch.launch.train --mesh DxM [--multi-pod]`` runs), its
    controls first, then the main path — the part's steps, the
    collectives and launches counted — and the update step
    (``phase21_update_step``; phase 22's main path, counted). Phase 21's
    controls: the first step's gradients from the same state with a
    collective left out (``collectives.skipping``), their norm. Phase
    22's (``want``: the witness's gradients of the controls' leaves, on
    the card; ``routes``: its top-k experts, ``first_routes``): each
    control as a whole update step at PHASE21_OPT with its collective
    left out — its gradients' relative L2 gap over the control's leaves,
    and its parameters and moments over them kept on the host for
    ``phase21_hold`` — after which the first state is put back; then the
    main path's gradients' gap over the same leaves, read from its step,
    and the MoE layers' routes in its forward held to the witness's
    (``flips``). The
    final state, a copy of the parameters before the update step and
    where each leaf's ZeRO-1 slice lies wait in the rank for
    ``phase21_hold``. Returns the rank's record (host values)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import mesh_axes
    from repro_torch.models import collectives as C
    from repro_torch.training import train_step as T
    from repro_torch.training.optim import global_norm
    from repro_torch.training.tree import leaves, leaves_with_paths
    spec = train_part(part)
    shape = spec["shape"]
    dev = rank.device
    t0 = time.perf_counter()
    make_mesh(shape, mesh_axes(shape), dev)      # the groups, made once
    mesh_s = time.perf_counter() - t0
    art, state = train.train_state_on_rank(spec["arch"], PHASE21_BATCH,
                                           spec["n_micro"], spec["layers"],
                                           SEED, shape, dev)
    mesh = art.mesh
    init_s = time.perf_counter() - t0
    abs_state = art.abstract_args[0]
    pspecs, ospecs = train.state_specs(art, ".params"), \
        train.state_specs(art, ".opt")
    moments = {"mu": state.opt["mu"], "nu": state.opt["nu"]}
    nbytes = {"params": [SH.local_bytes(state.params), SH.per_chip_bytes(
        abs_state.params, pspecs, mesh.shape)],
        "moments": [SH.local_bytes(moments), SH.per_chip_bytes(
            {"mu": abs_state.opt["mu"], "nu": abs_state.opt["nu"]}, ospecs,
            mesh.shape)]}
    coords = dict(zip(mesh.axis_names, mesh.coords))
    batch = phase21_batch(art, SEED, dev)     # the first step's batch
    rec = {"rank": rank.index, "device": dev.type, "coords": coords}
    kept, first = {}, None
    if want is None:                # phase 21: the controls' norms
        rec["control_norms"] = []
        for skip, _ in spec["controls"]:
            with C.skipping(skip):
                _, grads = art.fn.grads(state, batch)
            rec["control_norms"].append(
                float(global_norm(grads, art.fn.layout)))
            del grads
    else:                           # phase 22
        first = {p: x.to("cpu", copy=True)
                 for p, x in leaves_with_paths(state.params)}
        upd = update_artifacts(part, mesh)
        step0 = state.opt["step"]
        rec["control_gaps"] = []
        for i, (skip, keys) in enumerate(spec["controls"]):
            with C.skipping(skip), capture_calls(T, "adamw_update") as seen:
                state, _ = upd.fn(state, batch)
            grads = seen[0][0][2]            # the step's reduced gradients
            rec["control_gaps"].append(leaves_gap(
                grads, want, upd.fn.layout, keys, pspecs, mesh))
            del grads, seen
            kept[i] = {kind: {p: x.to("cpu", copy=True)
                              for p, x in leaves_with_paths(tree)
                              if any(k in p for k in keys)}
                       for kind, tree in (("params", state.params),
                                          ("mu", state.opt["mu"]),
                                          ("nu", state.opt["nu"]))}
            with torch.no_grad():       # the first state back
                for p, x in leaves_with_paths(state.params):
                    x.copy_(first[p])
                for x in leaves(state.opt["mu"]) + leaves(state.opt["nu"]):
                    x.zero_()
            state.opt["step"] = step0
        del upd
    del batch
    gc.collect()
    C.reset_stats()
    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    steps, state = phase21_steps(art, state, dev, spec["steps"])
    layout = art.fn.layout
    before, zero = {}, {}
    for i, (p, x) in enumerate(leaves_with_paths(state.params)):
        # on the host: the card's memory is the ranks' peak (four ranks
        # share it); phase 22's main path starts from the first state
        before[p] = x.to("cpu", copy=True) if first is None else first[p]
        d = layout.zero[i] if layout is not None else None
        zero[p] = None if d is None else (d,) + layout.dp.part(x.shape[d])
    update = None
    if not spec["steps"]:           # phase 22: the update step is the path
        with routes_recorded() as seen, \
                capture_calls(T, "adamw_update") as calls:
            update, state = phase21_update_step(part, mesh, state, dev)
    rec.update({"mesh_s": mesh_s, "init_s": init_s, "steps": steps,
                "bytes": nbytes, "collectives": C.stats(),
                "launches": ops.launch_counts(),
                "peak_gib": _peak_gib(dev)})
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        rec["card_used_gib"] = (total - free) / 2 ** 30
        rec["reserved_gib"] = torch.cuda.memory_reserved(dev) / 2 ** 30
        rec["buffers_gib"] = C.buffer_bytes() / 2 ** 30
        if rank.index == 0:
            rec["nvidia_smi_used"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
    if update is None:
        update, state = phase21_update_step(part, mesh, state, dev)
    else:                           # phase 22: its gradients, its routes
        grads = calls[0][0][2]
        rec["grad_gaps"] = [leaves_gap(grads, want, layout, keys, pspecs,
                                       mesh) for _, keys in spec["controls"]]
        rec["grad_gaps_local"] = [
            leaves_gap(grads, want, layout, keys, pspecs, mesh, local=True)
            for _, keys in spec["controls"]]
        if routes is not None:
            mine = first_routes(art.cfg, seen)[0]
            theirs = routes[coords.get("data", 0)]
            rec["flips"] = [int((a != b).any(-1).sum())
                            for a, b in zip(mine, theirs)]
        del grads, calls, seen
    rec["update_step"] = update
    _PHASE21_KEPT.update(state=state, mesh=mesh, specs=(pspecs, ospecs),
                         before=before, zero=zero, controls=kept)
    del art, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _update_sums(x, x0, w, w0, zero) -> list:
    """A parameter leaf's [|dx - dw|^2, |dw|^2, |dc - dw|^2] in float32,
    over slices of its first axis: the rank's update dx = x - x0 against
    the witness's dw = w - w0 (its slice), and the control's dc — dx
    inside the rank's ZeRO-1 slice ``zero`` = (dim, lo, hi), none outside
    it (None: no control, 0)."""
    import torch
    rows = max(1, (1 << 26) // max(1, x[0].numel())) if x.dim() > 1 else None
    parts = zip(*(torch.split(t, rows) if rows else (t,)
                  for t in (x, x0, w, w0)))
    sums, start = [0.0, 0.0, 0.0], 0
    for xs, x0s, ws, w0s in parts:
        dw = ws.float() - w0s.float()
        diff = xs.float() - x0s.float() - dw
        sums[0] += float(diff.square().sum())
        sums[1] += float(dw.square().sum())
        if zero is not None:
            dim, lo, hi = zero
            ctrl = -dw
            if dim == 0:
                a, b = max(lo - start, 0), min(hi - start, xs.shape[0])
                if a < b:
                    ctrl[a:b] = diff[a:b]
            else:
                ctrl.narrow(dim, lo, hi - lo).copy_(
                    diff.narrow(dim, lo, hi - lo))
            sums[2] += float(ctrl.square().sum())
        start += xs.shape[0] if xs.dim() else 1
    return sums


def _relative(num: float, den: float) -> float:
    return math.sqrt(num / den) if den else (0.0 if num == 0 else math.inf)


def phase21_hold(rank, part: str, held: dict):
    """The rank's parameters and moments (``phase21_rank``'s, kept in the
    rank) held to the kinds of the one-card witness's state in ``held``
    (on the card, mapped here; a call a few kinds, so that the witness's
    state is never on the card whole beside the ranks'): with "params",
    each parameter leaf's update in the update step against the
    witness's (from "before", or without it — phase 22 — from the rank's
    own draw, the witness's too), as a relative L2 gap, and the same with
    the leaves of a ZeRO-1 slice updated only there (the control), the
    worst leaf of each, and each phase 22 control step's update over its
    leaves; with "before", the parameters before the update step, the
    largest gap in bf16 steps of the witness slice's largest magnitude;
    with "mu" or "nu", the final moments' largest gap likewise and each
    leaf's relative L2 gap (the worst leaf), and each control step's
    over its leaves. The call with "nu" drops the state and the shared
    card's buffers and reads the rank's memory at rest ("idle"). Returns
    {"gaps", "update"?, "control_updates"?, "step", "hold_s"}."""
    import torch
    from repro_torch.models import collectives as C
    t0 = time.perf_counter()
    state, mesh = _PHASE21_KEPT["state"], _PHASE21_KEPT["mesh"]
    pspecs, ospecs = _PHASE21_KEPT["specs"]
    before, zero = _PHASE21_KEPT["before"], _PHASE21_KEPT["zero"]
    controls = _PHASE21_KEPT["controls"]
    out = {"gaps": {}, "step": int(state.opt["step"])}
    if "params" in held:
        out["update"], out["control_updates"] = _hold_update(
            state.params, before, held, pspecs, zero, controls, mesh,
            rank.device)
    kinds = (("params", "before", lambda: before, pspecs, ""),
             ("mu", "mu", lambda: state.opt["mu"], ospecs, "['mu']"),
             ("nu", "nu", lambda: state.opt["nu"], ospecs, "['nu']"))
    for kind, held_kind, tree, specs, prefix in kinds:
        if held_kind in held:
            out["gaps"][kind] = _hold_kind(part, kind, tree(),
                                           held[held_kind], specs, prefix,
                                           controls, mesh, rank.device)
    del held
    if "nu" in out["gaps"]:
        _PHASE21_KEPT.clear()
    del state, before, controls, kinds, tree
    gc.collect()
    if rank.device.type == "cuda":
        torch.cuda.empty_cache()
        if "nu" in out["gaps"]:         # the part's end: the card at rest
            buffers = C.buffer_bytes()
            C.release_buffers()
            free, total = torch.cuda.mem_get_info(rank.device)
            out["idle"] = {
                "allocated_gib": torch.cuda.memory_allocated(rank.device)
                / 2 ** 30,
                "reserved_gib": torch.cuda.memory_reserved(rank.device)
                / 2 ** 30,
                "buffers_released_gib": buffers / 2 ** 30,
                "card_used_gib": (total - free) / 2 ** 30}
    out["hold_s"] = time.perf_counter() - t0
    return out


def _hold_update(params, before: dict, held: dict, pspecs, zero: dict,
                 controls: dict, mesh, dev):
    """``phase21_hold``'s update gaps: each parameter leaf's update in the
    update step against the witness's (from "before", or without it from
    the rank's own draw), as a relative L2 gap, and the same with the
    leaves of a ZeRO-1 slice updated only there, the worst leaf of each;
    and each control step's update over its leaves."""
    from repro_torch.launch import sharding as SH
    from repro_torch.training.tree import leaves_with_paths
    update = {"worst": (-1.0, None), "control": (-1.0, None),
              "whole": [0.0, 0.0], "zero1_leaves": 0}
    for p, x in leaves_with_paths(params):
        x0 = before[p].to(x.device)
        w, w0 = (SH.rank_slice(held[k][p], pspecs[p], mesh).to(x.device)
                 if k in held else x0 for k in ("params", "before"))
        sums = _update_sums(x, x0, w, w0, zero[p])
        gap = _relative(sums[0], sums[1])
        ctrl = _relative(sums[2], sums[1]) if zero[p] else gap
        update["zero1_leaves"] += zero[p] is not None
        update["whole"][0] += sums[0]
        update["whole"][1] += sums[1]
        for key, g in (("worst", gap), ("control", ctrl)):
            if g > update[key][0]:
                update[key] = (g, p)
    controlled = []
    for i in sorted(controls):
        sums = [0.0, 0.0]
        for p, xc in controls[i]["params"].items():
            x0 = before[p].to(dev)
            w = SH.rank_slice(held["params"][p], pspecs[p], mesh).to(dev)
            s_ = _update_sums(xc.to(dev), x0, w, x0, None)
            sums = [sums[0] + s_[0], sums[1] + s_[1]]
        controlled.append(_relative(*sums))
    return {"relative_l2": update["worst"][0], "leaf": update["worst"][1],
            "whole_relative_l2": _relative(*update["whole"]),
            "control_relative_l2": update["control"][0],
            "control_leaf": update["control"][1],
            "zero1_leaves": update["zero1_leaves"]}, controlled


def _hold_kind(part: str, kind: str, tree, whole: dict, specs, prefix: str,
               controls: dict, mesh, dev) -> dict:
    """``phase21_hold``'s gaps of one kind of the rank's state ``tree``
    (the parameters before the update step, {path: tensor}, or a
    moment's tree) from the rank's slices of the witness's ``whole``: the
    largest gap in bf16 steps; for a moment also the worst leaf's
    relative L2, the least gap of a leaf left at zero (the control of
    the moments' bound), and each control step's over its leaves."""
    from repro_torch.launch import sharding as SH
    from repro_torch.training.tree import leaves_with_paths
    if kind != "params":                # ("before" is {path: tensor})
        tree = dict(leaves_with_paths(tree))
    worst, worst_l2, unwritten = (-1.0, None), (-1.0, None), math.inf
    for p, x in tree.items():
        x = x.to(dev)
        want = SH.rank_slice(whole[p], specs[prefix + p], mesh)
        if tuple(want.shape) != tuple(x.shape):
            raise AssertionError(f"{part} {kind}{p}: {tuple(x.shape)} on "
                                 f"the rank, {tuple(want.shape)} the "
                                 "witness's slice")
        want = want.to(x.device)
        gap = _bf16_steps(x, want)
        if gap > worst[0]:
            worst = (gap, p)
        if kind != "params":
            sums = _l2_sums(x, want)
            l2 = _relative(*sums)
            if l2 > worst_l2[0]:
                worst_l2 = (l2, p)
            if sums[1]:             # the leaf as the draw left it: zero
                unwritten = min(unwritten, _relative(sums[1], sums[1]))
    out = {"bf16_steps": worst[0], "leaf": worst[1]}
    if kind == "params":
        return out
    ctrl = []
    for i in sorted(controls):
        sums = [0.0, 0.0]
        for p, x in controls[i][kind].items():
            want = SH.rank_slice(whole[p], specs[prefix + p], mesh)
            s_ = _l2_sums(x.to(dev), want.to(dev))
            sums = [sums[0] + s_[0], sums[1] + s_[1]]
        ctrl.append(_relative(*sums))
    return {**out, "relative_l2": worst_l2[0], "l2_leaf": worst_l2[1],
            "unwritten_relative_l2": unwritten, "controls": ctrl}


def _l2_sums(x, want) -> list:
    """[|x - want|^2, |want|^2] in float32, over slices of the first axis
    (a moment leaf's float32 copy whole would double its bytes)."""
    import torch
    rows = max(1, (1 << 26) // max(1, x[0].numel())) if x.dim() > 1 else None
    sums = [0.0, 0.0]
    for xs, ws in zip(*(torch.split(t, rows) if rows else (t,)
                        for t in (x, want))):
        sums[0] += float((xs.float() - ws.float()).square().sum())
        sums[1] += float(ws.float().square().sum())
    return sums


def train_bounds(part: str) -> dict:
    """A training part's bounds: phase 21's, each leaf's update's relative
    L2 gap and the moments' gap in bf16 steps; phase 22's, the touched
    gradients' relative L2 gap, each leaf's update's and each moment
    leaf's (``PHASE22_BOUNDS`` for the parts that state a wider one)."""
    if part in PHASE21_TRAIN:
        return {"update": PHASE21_UPDATE_RTOL,
                "moment_steps": PHASE21_MOMENT_STEPS}
    return {"grad": PHASE22_GRAD_RTOL, "update": PHASE21_UPDATE_RTOL,
            "moment": PHASE22_MOMENT_RTOL, **PHASE22_BOUNDS.get(part, {})}


# the witness's state goes to the ranks in these groups of kinds (phase 22
# keeps no "before": the ranks' own draws are the witness's)
HOLD_GROUPS = (("before", "params"), ("mu",), ("nu",))


def phase21_train_problems(part: str, recs, witness) -> list:
    """A training part's problems: every rank's losses and norms within
    PHASE21_LOSS_RTOL / PHASE21_GNORM_RTOL of the witness's steps (the
    update step's loss and norm too); parameters after the main path
    within PHASE21_PARAM_STEPS bf16 steps; every parameter leaf's update
    in the update step within its bound (``train_bounds``), the
    gather-back control past it where a leaf has a ZeRO-1 slice; the
    final moments within their bound (phase 21: bf16 steps; phase 22:
    each leaf's relative L2); phase 21's controls' norms past
    PHASE21_GNORM_RTOL of the witness's first step; each phase 22
    control's gradients, update and moments over its leaves past their
    bounds, the main path's gradients over those leaves within theirs;
    bytes equal to ``per_chip_bytes``; no kernel launched; the
    collectives of the main path as ``train_expected`` predicts."""
    spec = train_part(part)
    bounds = train_bounds(part)
    bad = []
    want = witness["steps"] + [witness["update_step"]]
    expect = train_expected(part)
    for r in recs:
        who = f"{part} rank {r['rank']}"
        for i, (got, w) in enumerate(zip(r["steps"] + [r["update_step"]],
                                         want)):
            for key, tol in (("loss", PHASE21_LOSS_RTOL),
                             ("grad_norm", PHASE21_GNORM_RTOL)):
                gap = abs(got[key] - w[key]) / abs(w[key])
                if not gap <= tol:
                    bad.append(f"{who} step {i} {key}: {got[key]} against "
                               f"{w[key]} (relative {gap} > {tol})")
        if "control_norms" in r:     # phase 21: the first step's norm
            w = want[0]["grad_norm"]
            r["control_relative_gaps"] = []
            for (skip, _), norm in zip(spec["controls"],
                                       r["control_norms"]):
                c_gap = abs(norm - w) / w
                r["control_relative_gaps"].append(c_gap)
                if not c_gap > PHASE21_GNORM_RTOL:
                    bad.append(f"{who}: the control {skip}'s norm {norm} "
                               f"passes ({c_gap} of {w})")
        for (skip, keys), got, c_got in zip(spec["controls"],
                                            r.get("grad_gaps", ()),
                                            r.get("control_gaps", ())):
            if not got <= bounds["grad"]:
                bad.append(f"{who}: the gradients of {keys}: relative L2 "
                           f"gap {got} (bound {bounds['grad']})")
            if not c_got > bounds["grad"]:
                bad.append(f"{who}: the control {skip} passes on {keys} "
                           f"({c_got}, bound {bounds['grad']})")
        if r.get("control_updates") and \
                not max(r["control_updates"]) > bounds["update"]:
            bad.append(f"{who}: every control's update passes "
                       f"({r['control_updates']}, bound {bounds['update']})")
        for kind in ("mu", "nu") if "moment" in bounds else ():
            c_got = r["gaps"][kind]["unwritten_relative_l2"]
            if not c_got > bounds["moment"]:
                bad.append(f"{who}: {kind} left at zero passes ({c_got}, "
                           f"bound {bounds['moment']})")
        u = r["update"]
        if not u["relative_l2"] <= bounds["update"]:
            bad.append(f"{who} update: relative L2 gap {u['relative_l2']} "
                       f"at {u['leaf']} (bound {bounds['update']})")
        if u["zero1_leaves"] and \
                not u["control_relative_l2"] > bounds["update"]:
            bad.append(f"{who}: the gather-back control's update passes "
                       f"({u['control_relative_l2']})")
        # (phase 22 holds no parameters before its one step: the ranks'
        # draw is the witness's)
        checks = [("params", "bf16_steps", "leaf", PHASE21_PARAM_STEPS)] \
            if spec["steps"] else []
        checks += [(kind, "bf16_steps", "leaf", bounds["moment_steps"])
                   if "moment_steps" in bounds else
                   (kind, "relative_l2", "l2_leaf", bounds["moment"])
                   for kind in ("mu", "nu")]
        for kind, key, leaf, limit in checks:
            g = r["gaps"][kind]
            if not g[key] <= limit:
                bad.append(f"{who} {kind}: {key} {g[key]} at {g[leaf]} "
                           f"(bound {limit})")
        if r["step"] != 1 + spec["steps"]:
            bad.append(f"{who}: step {r['step']}")
        for what, (have, predicted) in r["bytes"].items():
            if have != predicted:
                bad.append(f"{who} {what}: {have} bytes, per_chip_bytes "
                           f"{predicted}")
        if any(r["launches"].values()):
            bad.append(f"{who}: training launched {r['launches']}")
        for name, w in expect.items():
            got = {k: r["collectives"][name][k] for k in ("calls", "bytes")}
            if got != w:
                bad.append(f"{who} {name}: {got}, predicted {w}")
    return bad


def phase21_world(dev, size: int):
    """A world of ``size`` ranks on the card for phases 21 and 22
    (segments grown rather than cut anew, as ``mesh_world``)."""
    from repro_torch.launch import ranks
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        return ranks.start(size, dev, timeout_s=PHASE18_TIMEOUT_S)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def phase21_train(dev, world, part: str, bad: list, parts_s: dict):
    """A training part: its witness in this process, then every rank of
    ``world``, held a group of kinds at a time (``HOLD_GROUPS``,
    ``phase21_train_problems``); prints its record."""
    import torch
    spec = train_part(part)
    t0 = time.perf_counter()
    witness = phase21_witness(dev, part)
    t1 = time.perf_counter()
    want = {p: x.to(dev) for p, x in witness.pop("touched").items()} \
        if spec["shards"] else None
    recs = world.run(phase21_rank, part, want, witness.pop("routes"))
    del want
    ranks_s = time.perf_counter() - t1
    kept = witness.pop("held")
    for kinds in HOLD_GROUPS:
        held = {kind: {p: x.to(dev, non_blocking=True)
                       for p, x in kept.pop(kind).items()}
                for kind in kinds if kind in kept}
        _sync(dev)
        for r, h in zip(recs, world.run(phase21_hold, part, held)):
            r.setdefault("gaps", {}).update(h.pop("gaps"))
            r["hold_s"] = r.get("hold_s", 0.0) + h.pop("hold_s")
            r.update(h)
        del held
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.ipc_collect()    # the ranks' mappings are closed
            torch.cuda.empty_cache()
    del kept
    gc.collect()
    if spec["phase"] == 22 and _host_cache_free() is not None:
        _host_cache_free()()
    part_bad = phase21_train_problems(part, recs, witness)
    parts_s[part] = round(time.perf_counter() - t0, 3)
    layers = spec["layers"]
    extra = {}
    if "flips" in recs[0]:      # each MoE layer: both shards' tokens
        model0 = [r for r in recs if not r["coords"].get("model", 0)]
        extra["flips_by_layer"] = [sum(r["flips"][i] for r in model0)
                                   for i in range(len(recs[0]["flips"]))]
    emit({"phase": spec["phase"], "part": part,
          "model": f"{spec['arch']} x{layers or 'all'} layers",
          "mesh": list(spec["shape"]), "n_micro": spec["n_micro"],
          "batch": PHASE21_BATCH, "backend": world.backend,
          "part_s": parts_s[part], "ranks_s": round(ranks_s, 3),
          "steps_one_card": witness["steps"], "ranks": recs,
          "collectives_expected": train_expected(part),
          "update_step_adamw": PHASE21_OPT,
          "update_step_one_card": witness["update_step"],
          "bounds": {"loss_rtol": PHASE21_LOSS_RTOL,
                     "grad_norm_rtol": PHASE21_GNORM_RTOL,
                     "param_bf16_steps": PHASE21_PARAM_STEPS,
                     **train_bounds(part)},
          "controls": spec["controls"], **extra,
          "predicted": spec["predicted"],
          "problems": part_bad})
    bad += part_bad


def phase21_serve(world, one: dict, bad: list, parts_s: dict):
    """21d: Qwen3-4B prefill_32k -> handoff -> PHASE14_DECODE_STEPS greedy
    steps through ``serve.programs_on_rank`` (what ``python -m
    repro_torch.launch.serve --mesh 2x1`` runs) on a (data 2, model 1)
    world, one sequence a rank, held to phase 18's one-card run ``one``
    of the same cut: the tokens, the gathered prefill logits within
    PHASE21_LOGIT_STEPS bf16 steps (the rows swapped fail it), D's shards
    of PHASE18_CHECK_LAYERS bit for bit the realignment of P's, bytes,
    launches a rank equal to the one-card run's, 5 logit gathers a rank.
    Returns the launches summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    steps = PHASE14_DECODE_STEPS
    recs = world.run(serve.programs_on_rank, MODEL14, "decode_32k",
                     PHASE14_BATCH["14a"], steps, PHASE18A_LAYERS, SEED,
                     PHASE21_SERVE_MESH, PHASE18_CHECK_LAYERS, True)
    parts_s["21d"] = round(time.perf_counter() - t0, 3)
    for r in recs:
        r.pop("step_logits", None)
    rec = serve.mesh_record(recs, world.backend)
    n = rec["layers"]
    expect = {"flash_attention": n, "flash_decode": n * steps}
    part_bad = rank_problems("21d", recs, expect)
    if {k: v for k, v in one["launches"].items() if v} != expect:
        part_bad.append(f"21d: the one-card run launched {one['launches']}, "
                        f"its path {expect}")
    if not rec["handoff_held_all_ranks"]:
        part_bad.append(f"21d: D's shards are not P's reshard: "
                        f"{[r['handoff_held'] for r in recs]}")
    logits = rec.pop("prefill_logits")
    vs = held_to_launch("21d", logits, one["last_logits"], logits.flip(0),
                        PHASE21_LOGIT_STEPS)
    part_bad += vs.pop("problems")
    part_bad += [f"21d {p}" for p in tokens_held(
        rec["tokens"], one["tokens"], one["token_gaps"])]
    vocab = get_config(MODEL14).vocab_size
    gathers = {"calls": 1 + steps, "bytes": (1 + steps) * vocab * 2}
    for r in rec["ranks"]:
        got = {k: r["collectives"]["all_gather"][k]
               for k in ("calls", "bytes")}
        if got != gathers or r["collectives"]["psum"]["calls"]:
            part_bad.append(f"21d rank {r['rank']}: collectives "
                            f"{r['collectives']}, predicted gathers "
                            f"{gathers} and no psum")
    emit({"phase": 21, "part": "21d", "model": f"{MODEL14} x{n} layers",
          "mesh": list(PHASE21_SERVE_MESH), "batch": PHASE14_BATCH["14a"],
          "part_s": parts_s["21d"], **rec, "tokens_one_card": one["tokens"],
          "vs_one_card": vs, "launches_expected": expect,
          "gathers_expected": gathers,
          "predicted": PHASE21_PREDICTED["21d"], "problems": part_bad})
    bad += part_bad
    launches = collections.Counter()
    for r in recs:
        launches.update(r["launches"])
    return launches


def phase21(dev, one_18a: dict):
    """The data and pod axes of a mesh of ranks on the card. 21a-21c train
    (``PHASE21_TRAIN``): each part's one-card witness runs first in this
    process (``phase21_witness``: its final parameters and moments kept in
    pinned host memory, the card freed), then every rank of a world runs
    the part's launcher program with its control (``phase21_rank``); then
    the witness's state goes back to the card a few kinds at a time and
    the ranks map it to hold theirs (``phase21_hold``;
    ``phase21_train_problems``). 21a and 21b share a world of two ranks
    with 21d (``phase21_serve``: serving on a data axis, held to phase
    18's one-card run ``one_18a``); 21c runs on a world of four, which
    is returned open for phase 22 ("world4": its caller closes it). Also
    returns the launches summed over 21d's ranks (training launches
    none)."""
    import torch
    t_phase = time.perf_counter()
    _mem_line(dev, "21", phase=21)
    bad, parts_s = [], {}
    with phase21_world(dev, 2) as world:
        for part in ("21a", "21b"):
            phase21_train(dev, world, part, bad, parts_s)
        launches = phase21_serve(world, one_18a, bad, parts_s)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    world4 = phase21_world(dev, 4)
    try:
        phase21_train(dev, world4, "21c", bad, parts_s)
        emit({"phase": 21,
              "phase_s": round(time.perf_counter() - t_phase, 3),
              "parts_s": parts_s, "launches_all_ranks": dict(launches),
              "predicted_s": PHASE21_PREDICTED["phase_s"], "problems": bad})
        if bad:
            raise AssertionError(f"phase 21: {bad}")
    except BaseException:
        world4.close()
        raise
    return {"launches": dict(launches), "world4": world4}


def phase22(dev, world4):
    """Training every other family on one world of four ranks at (data 2,
    model 2) (``PHASE22_TRAIN``): each part as phase 21's
    (``phase21_train``), its witness one card stepping each data rank's
    rows on their own (``phase22_shard_step``), each of its controls
    (``PHASE22_CONTROLS``) run as a step and judged on the leaves it
    touches; the ranks drop the shared card's buffers after each part.
    Returns the launches (training launches none)."""
    import torch
    t_phase = time.perf_counter()
    if _host_cache_free() is not None:      # phase 21's pinned states
        _host_cache_free()()
    _mem_line(dev, "22", phase=22)
    bad, parts_s = [], {}
    for part in PHASE22_TRAIN:
        phase21_train(dev, world4, part, bad, parts_s)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": 22, "phase_s": round(time.perf_counter() - t_phase, 3),
          "parts_s": parts_s, "predicted_s": PHASE22_PREDICTED["phase_s"],
          "problems": bad})
    if bad:
        raise AssertionError(f"phase 22: {bad}")
    return {"launches": {}}


KERNELS = [
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
     "src/repro/kernels/flash_attention.py:78", 3),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:81", 3),
    ("scatter_pages_overlay", "src/repro_torch/kernels/csrc/kv_repack.cu",
     "src/repro/kernels/kv_repack.py:115", 3),
    ("gather_pages", "src/repro_torch/kernels/csrc/kv_repack.cu",
     "src/repro/kernels/kv_repack.py:45", 4),
    ("scatter_pages", "src/repro_torch/kernels/csrc/kv_repack.cu",
     "src/repro/kernels/kv_repack.py:75", 4),
    ("repack", "src/repro_torch/kernels/kv_repack.py",
     "src/repro/kernels/kv_repack.py:154", 4),
    ("flash_decode", "src/repro_torch/kernels/csrc/flash_decode.cu",
     "src/repro/kernels/flash_attention.py:78", 15),
    ("flash_decode_partial", "src/repro_torch/kernels/csrc/flash_decode.cu",
     "src/repro/kernels/flash_attention.py:78", 18),
    ("decode_combine", "src/repro_torch/kernels/csrc/flash_decode.cu",
     "src/repro/kernels/flash_attention.py:78", 18),
]
# phases 19 and 20 also launch flash_decode_partial and decode_combine
# (and flash), phase 21 flash and flash_decode: the rows'
# launches_by_phase carry them


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # compiled bytecode kept in the checkout's build directory, for this
    # process and every process it starts: where the installed packages
    # carry no bytecode, each fresh rank or worker would compile the
    # modules that meta tensors import (about 7 s a process on the card's
    # machine) anew
    pycache = ROOT / "build" / "pycache"
    pycache.mkdir(parents=True, exist_ok=True)
    sys.pycache_prefix = str(pycache)
    os.environ["PYTHONPYCACHEPREFIX"] = str(pycache)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    def lap(phase: str) -> None:          # where the run's time goes
        emit({"phase_ended": phase,
              "at_s": round(time.perf_counter() - t_start, 3)})

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    smi = phase0()
    lap("0")
    timings = phase1(dev)
    lap("1")
    phase2(dev)
    lap("2")
    torch.cuda.empty_cache()
    params = M.init_params(get_config(MODEL), seed=SEED, device=dev)
    paths = {3: phase3(dev, params=params)}
    lap("3")
    torch.cuda.empty_cache()
    paths[4] = phase4(dev, params)
    lap("4")
    torch.cuda.empty_cache()             # the workers need the memory back
    paths[5] = phase5(dev, params)
    lap("5")
    del params                           # llama2-7b's weights: Mixtral's turn
    gc.collect()                         # engines and pools of phases 3-4
    torch.cuda.empty_cache()             # sit in reference cycles
    paths[6] = phase6(dev)
    lap("6")
    gc.collect()                         # Mixtral's weights: DeepSeek's turn
    torch.cuda.empty_cache()
    paths[7] = phase7(dev)
    lap("7")
    gc.collect()                         # DeepSeek's weights: RecurrentGemma's
    torch.cuda.empty_cache()
    phase2(dev, MODEL8, PARITY8_LAYERS, phase=8)
    lap("2 (8)")
    gc.collect()
    torch.cuda.empty_cache()
    paths[8] = phase8(dev)
    lap("8")
    gc.collect()                         # RecurrentGemma's weights: the
    torch.cuda.empty_cache()             # workers' copies
    paths[16] = phase16(dev, paths)
    lap("16")
    gc.collect()
    torch.cuda.empty_cache()
    paths[9] = phase9(dev)
    lap("9")
    gc.collect()
    torch.cuda.empty_cache()
    paths[10] = phase10(dev)
    lap("10")
    gc.collect()                         # InternVL2's weights: Whisper's
    torch.cuda.empty_cache()
    phase2(dev, MODEL11, PARITY11_LAYERS, phase=11)
    lap("2 (11)")
    gc.collect()
    torch.cuda.empty_cache()
    paths[11] = phase11(dev)
    lap("11")
    gc.collect()                         # Whisper's weights: the workers'
    torch.cuda.empty_cache()
    paths[12] = phase12(dev)
    lap("12")
    gc.collect()                         # the workers are gone: training's
    torch.cuda.empty_cache()             # ~60 GiB
    paths[13] = phase13(dev)
    lap("13")
    gc.collect()                         # training's state: phase 14's
    torch.cuda.empty_cache()
    paths[14] = phase14(dev)
    lap("14")
    timings["flash_attention"].update(paths[14]["timing"])
    gc.collect()                         # phase 14's models: phase 15's
    torch.cuda.empty_cache()
    paths[15] = phase15(dev)
    lap("15")
    gc.collect()                         # phase 15's models: 17c's
    torch.cuda.empty_cache()
    paths[17] = phase17(dev)
    lap("17")
    gc.collect()                         # 17c's weights: the ranks'
    torch.cuda.empty_cache()
    paths[18] = phase18(dev, paths[14]["held"])
    lap("18")
    gc.collect()
    torch.cuda.empty_cache()
    paths[19] = phase19(dev, paths[15]["held"])
    lap("19")
    gc.collect()
    torch.cuda.empty_cache()
    paths[20] = phase20(dev)
    lap("20")
    gc.collect()
    torch.cuda.empty_cache()
    paths[21] = phase21(dev, paths[18].pop("one_card_18a"))
    lap("21")
    with paths[21].pop("world4") as world4:     # phase 21's world of four
        gc.collect()
        torch.cuda.empty_cache()
        paths[22] = phase22(dev, world4)
    lap("22")

    rows = []
    for name, source, replaces, phase in KERNELS:
        t = timings[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": paths[phase]["launches"].get(name, 0),
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "device_ms": t["device_ms"],
               "library_device_ms": t["library_device_ms"],
               "device_method": t["device_method"], "host_us": t["host_us"],
               "launches_by_phase": {ph: paths[ph]["launches"].get(name, 0)
                                     for ph in sorted(paths)}}
        # at phase 7's, 8's, 10's, 11's, 12's and 14's shapes; flash_decode
        # at phase 15's (the Mixtral ring the row, RecurrentGemma's ring
        # "rg", Qwen1.5-32B's e4m3 cache "fp8") and 14a's ("dense")
        for key in ("mla", "rg", "vlm", "encdec", "load", "launch_p",
                    "launch_d", "launch_k", "fp8", "dense", "demo",
                    "quickstart", "halves", "mesh_fp8", "mesh_ring",
                    "mesh_rg", "mesh_mla", "mesh_encdec", "mesh_vlm"):
            if key in t:
                row[key] = {k: t[key][k] for k in (
                    "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                    "library_ms", "library_device_ms", "bound_ms",
                    "bound_by", "host_us")}
        if name == "repack":
            row["composition"] = "gather_pages + scatter_pages"
        rows.append(row)
    print(smi, flush=True)
    emit({"total_s": round(time.perf_counter() - t_start, 3)})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
