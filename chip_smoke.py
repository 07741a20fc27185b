#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --bcr-ab TREE [TREE ...]
    python3 chip_smoke.py --paper
    python3 chip_smoke.py --families
    python3 chip_smoke.py --encdec
    python3 chip_smoke.py --train
    python3 chip_smoke.py --tune
    python3 chip_smoke.py --tp
    python3 chip_smoke.py --dryrun

The second form times phase 3's ``bcr_spmm*``, ``bcr_spmm_skip`` and flash
cases for each checkout TREE (its own ``src/repro_torch``, built into its
own ``build/``), one process per TREE in the order given, and prints them
side by side — e.g. ``build/parent . . build/parent`` after ``git archive
HEAD~1 | tar -x -C build/parent``. The third runs phases 1, 2 and 13 only;
the fourth phases 1, 2 and 14, with phase 3's checks of phase 14's shapes;
the fifth phases 1, 2 and 15, phase 15d's kernel cases first; the sixth
phases 1, 2 and 16; the seventh phases 1, 2 and 17; the eighth phases 1, 2
and 18; the ninth phases 1, 2 and 19.

Phases, in order (any failed check raises and the script exits non-zero):

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, one process per source, all started together; ptxas
   registers and spills; from the built libraries' SASS, the instruction
   each tensor-core kernel runs (``mma.sync`` = HMMA, ``wgmma`` = HGMMA):
   the BCR kernels by M tile (HMMA up to 64, HGMMA for 128), the bf16
   ``bcr_spmm_skip`` kernels by M tile likewise, the bf16 flash kernels
   HGMMA at head_dim 64 and HMMA at the others; none in any fp32
   (CUDA-core) body. The expert-batched BCR forms are the same bodies with
   the expert on a grid axis: every BCR kernel's SASS must read it
   (``SR_CTAID.Y`` on the tensor cores, ``SR_CTAID.Z`` on the CUDA cores).
3. Kernels against their plain PyTorch versions on the card, bf16 at the
   llama3.2-1b full-width shapes (d_model 2048, 32/8 heads, head_dim 64,
   d_ff 8192, vocab 128256, BCR block 128 at keep 0.25, so R_keep = C_keep =
   64), plus one small fp32 case each: max error against the stated
   tolerance, CUDA-event times (median of 20 after warm-up, L2 flushed
   before each launch), the plain version's time, one library yardstick
   (never used by the port) and the bound. Every form: the fp and int8
   forms of ``bcr_spmm``, ``bcr_spmm_grouped`` (plus the one-launch split
   at decode: MLP wo and gate/up at M = 8, two launches bit-equal, output
   and workspace in freed NaN-filled blocks, split counters back at 0)
   and paged attention (decode over lengths 1..512 and 1024..4096,
   prefill-append of 16 rows over 100 and of 64 rows over 384 (phase 9a's
   append admission); plus its one-launch split over pages at
   decode and prefill-append, fp and int8 pages, checked as the BCR split
   is, with an empty slot giving exact zeros), and the
   fused flash attention (B·H = 8·32, S in {128, 512}, causal, non-causal
   and a ``q_offset`` case; the heaviest-first CTA order bit-equal to the
   B·H-major one), and the block-skipping ``bcr_spmm_skip`` over
   unbalanced-BCR tiles (wq, MLP wo and lm_head with lognormal block
   scales, M = 8 and 2048; a zeroed block row; the output landing in a
   freed NaN-filled block; a fully pruned W; a small fp32 case; the
   one-launch split over a block row's tiles at M = 8 for wq and MLP wo,
   checked as the BCR split is), each with its surviving-tile share and
   empty block rows. Then phase 12's new shapes: the expert-batched
   ``bcr_spmm`` (deepseek-moe-16b's expert ``wo``, 64 x 2048 x 1408) and
   ``bcr_spmm_grouped`` (its ``wgi``, 64 x 2 x 1408 x 2048, SwiGLU), fp and
   int8 tiles, at M = 4 and 240 a expert, each one launch for all 64
   experts against the plain version's loop over them, timed beside one
   ``torch.bmm`` over the dense pruned expert weights; their one-launch
   split at M = 4 over 4 experts (64 fill the card unsplit), checked as
   the BCR split is; paged decode and prefill-append (bf16 and int8
   pages) and flash at 16/16 heads, head_dim 128.
4. bf16 main path at full width: llama3.2-1b, 16 layers, random weights
   from a seeded generator, packed at keep 0.25 / block 128, served through
   the paged engine (8 slots, page 16, capacity 640): 16 greedy requests
   with prompts from {32, 128, 512} and 32 new tokens each. The launch
   counters are zeroed just before and read just after; a profiled window
   of decode steps; then one direct ``prefill_append`` on a live pool, held
   to a cold prefill.
5. Quantized main path, the same weights and traffic: int8 tiles
   (``pack_params(weight_dtype="int8")``), int8 KV pages
   (``EngineConfig(kv_dtype="int8")``) and cold prefill through the fused
   flash kernel (``attn_impl="pallas"``). The int8 and flash counters must
   move and the fp counters stay 0, with 16 flash launches per cold
   prefill; the same profile and live-pool ``prefill_append`` check; and
   the teacher-forced flip rate of the int8 path against the bf16 path on
   the bf16 path's trajectories (printed, not gated: random weights have
   near-ties).
6. Engines against the naive ``generate`` oracle, fp32, full width, 2
   layers, 4 requests: the bf16-config engine, then the quantized one
   (int8 tiles, int8 KV, flash prefill); greedy tokens equal up to
   near-ties.
7. GRIM's pruning path at full width: llama3.2-1b, 16 layers, fp32 params,
   bf16 activations, keep 0.25 / block 128, ``markov`` data (batch 8, seq
   128) through ``launch.train.train_loop``: 2 dense steps, ADMM from step
   2 (one Z/U dual update, at step 5), ``finalize`` and frozen-mask
   retraining from step 6, 8 steps in all. Loss finite and lower at the end;
   every pruned leaf a balanced-BCR member; step times and peak memory.
   Then the retrained weights go through ``pack_params``: packed prefill
   logits against ``forward`` on the dense finalized weights. Then the
   trained lm_head, MLP wo and wq are projected onto the unbalanced BCR set,
   packed by ``pack_skip`` and run by ``bcr_spmm_skip`` (its launch counter
   for the kernels line) against the plain version.
8. Checkpoint resume on the card: 2 layers (vocab cut to 8192), the same
   phases; a run stopped at step 4 (mid-ADMM, ``save_async``) and resumed
   must repeat the uninterrupted run's losses.
9. Prefix cache and lifecycle. (a) Full width and depth, the weights of
   phases 4 and 5, 8 slots, page 16, capacity 640, ``prefix_cache=True``:
   two 384-token system prompts (24 full pages each) served once each so
   their pages park on the LRU, then 16 requests (a system prompt in turn
   plus a unique 16..64-token suffix, 32 greedy tokens each) in two waves
   of 8; exactly 6144 hit tokens over 384 adopted pages, no copy, fewer
   pages allocated than the same traffic unshared, conservation after the
   drain; TTFT p50 hit against cold, one append and one cold admission
   profiled by kernel family, the paged kernel's prefill-append launches.
   Once bf16, once over int8 tiles, int8 KV and the flash cold prefill.
   (b) fp32, full width, 2 layers, phase 6's near-tie rule: shared =
   unshared = naive on shared-prefix traffic, a full-prompt hit (a page
   copied) and staggered sharing, over fp32 and int8 KV; preemption under
   an oversubscribed pool and ``recover()`` mid-run give the naive tokens;
   a seeded fault-injector chaos run over 32 requests fails exactly its
   NaN victims and leaks no page.
10. Speculative decoding, the capacity-dense pool, SLO admission and
   tenancy. (a) Phase 4's weights and traffic at full width and depth, 8
   slots, page 16, capacity 640, ``spec_k`` = 3: the plain engine, an
   ``OracleDraft`` fed the plain run's tokens, and ``build_draft``'s
   drafter (2 layers, d_model 512, packed at keep 0.25); bf16, then int8
   tiles + int8 KV + flash prefill. Gates: both speculative runs' tokens
   equal plain's, except at near-ties: from a first difference on, every
   token within ``BF16_TIE`` (relative) of the top logit of its own
   teacher-forced trajectory; no drafter failure, and the model drafter
   proposes ``spec_k`` tokens a slot and round (one fewer on a catch-up);
   the oracle accepts every draft (when its tokens equal plain's) in
   fewer decode steps than plain; every verify step launches the paged
   kernel's prefill-append
   form once a layer and its decode form never; no page leaks. Logged:
   tokens/s, decode steps, step-wall p50, acceptance, and a profiled
   steady step of each run by kernel family. Then the same at fp32 over 2
   layers and 4 requests against naive ``generate`` under phase 6's 1e-4
   rule. (b) Phase 4's traffic on ``page_size=0`` (bf16): tokens equal
   phase 4's under the near-tie rule, the paged kernel never launched
   (decode attention is plain torch there, as the reference computes it
   outside Pallas); step wall and a profiled step. (c) Phase 9b's
   configuration on a fake clock with a pinned step time, paged and
   ``page_size=0``: a doomed deadline rejected at submit with a computed
   ``retry_after_s``, a victim tenant at goodput 1.0 under an aggressor,
   the concurrent, rate and page quotas rejecting with a computed
   ``retry_after_s``, one terminal status a request, nothing leaked.
11. The serving entry points on the card, over phase 4's weights and
   engine configuration. (a) ``start_in_thread(engine, warmup_lens=[32,
   128, 512])``: ``/readyz`` answers 503 during warmup and 200 after it,
   and warmup has built and loaded the BCR and paged libraries (forgotten
   first); no ``nvcc`` runs after. (b) Phase 4's 16 requests over loopback
   at one moment, half SSE, half buffered: tokens equal phase 4's under
   the near-tie rule; the fp kernels launched; client TTFT p50 (to the
   first SSE token) against phase 4's engine TTFT, tokens/s, the engine
   thread's decode step-wall p50, and one profiled window of steps on that
   thread (device busy share). (c) The lifecycle over HTTP: a mid-stream
   disconnect frees its slot and pages within a host step (``/metrics``);
   one injected ``crash_step`` restarts the loop through ``recover()`` and
   the stream completes under the near-tie rule; a burst of 14 past
   ``max_waiting`` 2 gets 429s with ``Retry-After`` >= 1; drain flushes a
   running stream's 64 tokens, answers 429 "server draining" to a queued
   request and holds conservation; exactly one supervisor restart (the
   injected one), never crashed. (d) ``run_traffic`` open loop on the same
   engine: 32 requests at 8 req/s (prompts from {32, 128, 512}, 32 tokens
   each), then ``examples/trace_heavy_tail.jsonl``: every request
   FINISHED, no page leaked, percentiles logged. (e) ``python -m
   repro_torch.launch.api`` as a subprocess at full width and 2 layers:
   ready, one streamed and one buffered completion (the same tokens),
   SIGTERM, exit 0 with ``drained; conservation ok``.

12. The MoE family on the card: deepseek-moe-16b at full width, the depth
   cut to 4 layers (1 dense, 3 MoE; printed). (a) bf16, packed at keep
   0.25 / block 128, phase 4's engine configuration and traffic at the
   config's capacity_factor 1.25 (exact-length cold prefill, grouped by
   prompt length): tokens/s, TTFT p50, decode step-wall p50, a profiled
   decode window (device time by kernel family, busy share, device
   launches a step), resident weight bytes; exactly one expert-batched
   ``bcr_spmm_grouped`` and one ``bcr_spmm`` launch per MoE layer per
   forward, never 64. (b) fp32, 2 layers (1 dense + 1 MoE),
   capacity_factor 8.0, 4 requests: engine tokens equal naive
   ``generate`` under phase 6's 1e-4 near-tie rule. (c) 12a's weights
   with int8 tiles, int8 KV and the flash cold prefill: the int8
   expert-batched and flash counters move, every fp form stays at 0.

13. The source paper's own workloads. (a) The GRU at the paper's width
   (``models/gru.py``: d_model 1024, 2 layers, vocab 64, 8 classes, seed
   0), masks from ``admm.finalize`` at the ``gru_rnn`` example's spec
   ((8, 8) blocks, keep 0.1, granule 2: 2 x 4 tiles), packed by
   ``pack_params`` under the example's config, fp32 and bf16: packed
   ``gru_apply`` (B 32, S 24; 288 ``bcr_spmm`` launches, counted between
   zeroed counters) against the dense masked forward and against the plain
   version (``bcr_matmul`` routed through ``bcr_spmm``'s plain version on
   the same card tensors), within 1e-4 (fp32) or 2e-2 x the output scale
   (bf16); then one timestep (``gru_step_latency_fn``) at batch 1 and 32,
   dense and packed, fp32 and bf16: p50 wall over 60 warm steps, device
   time and launches a step (``torch.profiler``), ``bcr_spmm`` launches a
   step (12), against the packed kernels' bound (tiles, index planes, x
   and y over 3.35 TB/s) and the dense step (``x @ W.T``, the library);
   and ``bcr_spmm`` alone at the GRU's shapes (M = 1, 32), timed as phase
   3's rows. (b) ``conv_as_gemm`` of the ``cnn_im2col`` example through
   ``bcr_spmm``, fp32 and bf16, against the plain version and the dense
   ``cols @ W.T``: the example's conv2 (M 256, K 144, N 32) and a VGG-16
   conv3 layer (arXiv:1409.1556: 56 x 56, 256 -> 256, 3 x 3; M 3136 an
   image) at batch 1 and 8, (8, 16) blocks at keep 0.25, one launch each;
   the im2col skip's dead columns. (c) Listing 1 on the card:
   ``find_opt_blk`` over the card runner (bf16, keep 0.25), its full
   (block, ms) curve, for the GRU's 1024 x 1024 at M 1 and 32 and
   llama3.2-1b's MLP wo (2048 x 8192) at M 8, over (8, 8) .. (128, 128)
   and ``default_candidates``; every finite candidate's output held to the
   plain version. (d) The port's five examples end to end on the card
   (``main``: the default device; ``train_lm`` at ``--preset tiny``, 60
   steps with ADMM from 20 and retraining from 40), each ending in ``OK``.

14. The vlm, ssm and hybrid families through the port's engine, random
   weights from seed 0 packed bf16 at keep 0.25 / block 128, phase 4's
   engine configuration and traffic. (a) pixtral-12b at full width, the
   depth cut 40 -> 4 (printed), the prefix cache on; then one direct
   ``prefill`` with ``image_embeds`` (B 2, 256 image positions + 256 text)
   held to the same prefill over the plain BCR versions and moved by the
   image. (b) rwkv6-3b at full width and full depth (32 layers): the
   capacity-dense pool, exact-length prefill. (c) jamba-v0.1-52b at full
   width, the depth cut 32 -> 8 (one period: 1 attention, 7 mamba, 4 MoE
   layers of 16 experts), random weights drawn in bf16, a paged pool whose
   mamba state is slot-major, capacity_factor 1.25; one expert-batched
   launch per projection per MoE layer per forward. Each logs tokens/s,
   TTFT p50, decode step-wall p50, a profiled decode window (device ms by
   kernel family, busy share, launches a step), resident weight and
   recurrent-state bytes, and the decode byte floor (weights + state read
   and written over 3.35 TB/s). (d) fp32 on the card, engine tokens equal
   naive ``generate`` under phase 6's 1e-4 near-tie rule: pixtral (prefix
   cache on, a repeated prompt) and rwkv at full width and 2 layers, jamba
   at its SMOKE width with 8 layers (block 16, capacity_factor 8.0), also
   under preemption in a 7-page pool and ``recover()``. Phase 3 holds the
   kernels at phase 14's new shapes: pixtral's wq, K/V, gate/up, wo, MLP
   wo and lm_head (131072 x 5120), rwkv's 2560^2, 2560 <-> 8960 and
   lm_head, jamba's in_proj, x_proj (288 x 8192 on 144 x 128 blocks: 72 x
   64 tiles), dt_proj, out_proj, lm_head and 16 experts of 14336 x 4096
   (M = 4 and 160 a expert), fp32 x at rwkv's 2560^2 and x_proj, and
   paged decode at 32/8 heads, head_dim 128.

15. The encdec family: whisper-large-v3 at full width and depth (32
   encoder + 32 decoder layers, d_model 1280, 20/20 heads of 64, d_ff
   5120, vocab 51866), random weights from seed 0 packed at keep 0.25 /
   block 128, 8 utterances of 1500 seeded frame embeddings (the stub
   frontend's output) and a 4-token prompt, through ``model_fns``: the
   reference's engine and ``generate`` refuse encdec, so ``prefill``
   (encoder, cross K/V, the decoder over the prompt), ``init_cache(8,
   448)`` (whisper's text context) with the cross K/V seated, the prompt
   primed through ``decode_step`` and 32 greedy tokens. (a) bf16 tiles,
   plain attention: prefill wall and device time, decode step-wall p50, a
   profiled window of 5 steps (device ms by kernel family, launches a
   step, busy share), resident weight and cross-K/V bytes, the decode
   byte floor (streamed projections, the whole cross cache and the live
   self K/V over 3.35 TB/s); one decode step between zeroed counters
   launches exactly what the packed tree implies (5 x 32 + 1
   ``bcr_spmm``, 32 ``bcr_spmm_grouped``, no paged or flash kernel). (b)
   The same draw with int8 tiles and ``attn_impl="pallas"``, ``q_chunk``
   = ``kv_chunk`` = 1500: the int8 forms move and the fp forms stay 0;
   flash launches once per encoder layer and once per decoder layer a
   prefill (the decoder's self attention over the prompt runs it too, as
   the reference's prefill runs ``attention_apply`` in both stacks); each
   encoder layer under flash against the same layer under plain attention
   on the same input (2e-2); the whole encoder's gap to plain attention
   and to (a)'s encoder, and the teacher-forced flip rate on (a)'s
   trajectories, printed, not gated. (c) fp32 on the card, full
   width, depth cut to 2 + 2 (printed), 4 utterances: ``prefill`` logits
   = ``decode_train``'s last row; stepwise ``decode_step`` greedy tokens
   = the teacher-forced argmax of ``decode_train`` under phase 6's 1e-4
   near-tie rule; the packed encoder and decoder against the same forward
   inside ``plain_kernels()``. (d), run first: phase 3's cases at
   whisper's shapes (``lm_head`` 51866 x 1280 on (2, 128) blocks, one
   kept row a tile, M = 8 and 32; ``wqkv`` and cross ``wkv`` with their
   biases, MLP ``wi``/``wo``, at M = 8 and 12000; fp and int8 tiles;
   non-causal flash at B·H 160, S 1500), each against its plain version,
   timed beside it, the library call and the bound.

16. Training for every family that serves, on GRIM's pruning path with
   phase 7's schedule (8 steps: 2 dense, ADMM from step 2 with one Z/U
   dual update at step 5, ``finalize`` and frozen-mask retraining from
   step 6), fp32 params, the config's activation dtype and ``grad_accum``,
   BCR keep 0.25 on 128 x 128 blocks (``choose_block_shape`` decides the
   non-divisible leaves): (a) whisper-large-v3 at full width and depth,
   8 x 1500 frames and 1500 tokens a step from ``synth_inputs`` at
   ``ShapeSpec("whisper_train", 1500, 8, "train")``; (b) deepseek-moe-16b
   at full width, 4 layers, through ``train_loop`` (markov data, 8 x 128,
   as phase 7); (c) rwkv6-3b at full width, 4 of 32 layers, through
   ``train_loop``; (d) pixtral-12b at full width, 2 of 40 layers, over
   ``synth_inputs`` at 8 x 512 with 256 ``image_embeds`` in the loss; (e)
   jamba-v0.1-52b at its SMOKE config (8 layers, one period, fp32, 16 x 16
   blocks): at full width one MoE layer alone holds 2.8 B parameters, ~68
   GB of training state, so no full-width period fits one card. (a) and
   (d) train through phase 16's own loop (``make_train_step``,
   ``admm_init``, ``admm_dual_update``, ``finalize`` in ``train_loop``'s
   order), since ``train_loop`` feeds token batches only, as the
   reference's does. Each family: phase 7's gates (the phases, one dual
   update, a finite loss lower at the end, every pruned matrix — each
   expert of a stacked leaf — a balanced-BCR member); the parameter count
   and the state's bytes arithmetic (16 B a parameter, 8 more a pruned
   one during ADMM) beside ``max_memory_allocated``; step wall p50 by
   phase; one profiled retrain step (device ms by kernel family, busy
   share); then the retrained weights through ``pack_params`` and the
   family's packed prefill (``model_fns``; pixtral with its
   ``image_embeds``, whisper over 8 x 1500 frames and a 16-token prompt)
   against the dense finalized weights' last-position logits under phase
   7's gate (5e-2 of their scale) and near-tie rule, with every kernel
   form the packed tree runs launched (``bcr_spmm``, ``bcr_spmm_grouped``,
   and for stacked experts the expert-batched forms). A MoE model's dense
   forward is dispatched as its packed prefill was (``moe_routing``), so
   the gate measures the kernels; the token-layers whose top-k the dense
   forward's own routing tips elsewhere, and the gap under that routing,
   are printed.
17. GRIM's compile step on the card (llama3.2-1b at full width, keep 0.25,
   128 x 128 blocks, bf16, unless stated). (a) The plan tuner per served
   shape at the engine's decode hint M = 8 (``TUNE_SHAPES``: wq/wo, wkv,
   wgi + SwiGLU, MLP wo, lm_head, and whisper-large-v3's lm_head on (2,
   128) blocks and wqkv at G = 3), bf16 and int8 tiles: every legal genome
   of ``plan_search_space`` against the plain version (phase 3's gate) and
   timed (median of 5 x 20 launches under CUDA events, per projection)
   beside the H100 model's prediction; the rule's plan, the ``"analytic"``
   pick and the ``"wallclock"`` pick with their times and predictions; the
   model's rank correlation with the measured times; an analytic pick
   slower than the rule's plan is printed as such. (b) Phase 4's engine
   and traffic over analytic and over wall-clock plans (packed and tuned
   by ``pack_params(plan_fitness=...)``, the engine of the same fitness);
   the wall-clock run's tokens held to the naive ``generate`` on its tree
   (``BF16_TIE``); both step p50s. (c) ``pack_params(auto_block=True)``
   with the card runner (``wallclock_runner``): the block Listing 1 picks
   per leaf shape, the search's time, 8 requests through the engine held
   to the naive ``generate``. (d) ``python -m repro_torch.launch.serve
   --mode static`` in a subprocess (batch 8, prompt 128, 32 tokens), its
   tokens held to the naive ``generate`` on the same seeded weights and
   prompts; prefill and decode ms. (e) One 32768-token sequence (the
   reference's ``prefill_32k`` length, its batch of 32 cut to 1) through
   ``causal_lm.prefill`` under ``attn_impl="flash"``, the chunked
   ``flash_attention``: wall and device time, peak memory; layer 0's
   attention over the last 512 query rows against the plain masked
   softmax over those rows, and the function against ``dense_attention``
   at S = 4096, both under bf16's gate. Every launch of the phase is
   counted (``tune_launches``); each sub-phase's time is printed.
18. Tensor-parallel serving (``serving/tp.py``) with the ranks sharing
   the one card under gloo (one process a rank; gathers through the
   host). (c), run first: the BCR kernels at the tp = 2 shard shapes
   (``wq`` 1024 x 2048, ``wkv`` 2 x 256 x 2048, ``wgi`` + SwiGLU 2 x 4096
   x 2048, MLP ``wo`` 1024 x 8192, ``lm_head`` 64128 x 2048, at M = 8),
   each whole pack tuned for M = 8 as ``pack_params`` tunes it and split
   by ``split_packed`` / ``split_grouped``, and paged decode over one
   rank's 16/4 heads: each against its plain version, timed beside it,
   the library call and the bound, its launch (M tile, configuration,
   split, stages; row tile and split) equal to the whole's, and the
   shards' outputs bit-equal to the whole's. (a) Phase 4's model, engine
   and traffic at mesh 1 and at mesh 2 (``EngineConfig(mesh_model=2,
   mesh_devices=("cuda:0",) * 2)``): greedy tokens and the first decode
   step's logits bit-equal; ``kv_bytes_read_device`` x 2 =
   ``kv_bytes_read``; each rank's KV pool half of mesh 1's; each rank
   launched the bf16 ``bcr_spmm``, grouped and paged kernels (their
   counters read from every rank); per-rank param and streamed-weight
   bytes, decode step-wall p50 and rank 0's device ms a step against mesh
   1. Then 9a's prefix traffic (its seeds and first wave: 8 requests of 16
   tokens) at mesh 1 and 2: the same tokens and hit tokens, and every rank
   launched the paged kernel's prefill-append form. (b) The same at mesh 4 over int8 tiles and int8 KV, 8 requests of
   16 tokens, against the mesh-1 int8 engine; ``lm_head`` (1002 row
   blocks) stays replicated. (d) ``hierarchical_psum`` on (b)'s 4 ranks
   over CUDA tensors as pod 2 x data 2: exact in its order, int8 within
   the reference's 2%. Printed: ``phase 18a bf16`` / ``phase 18b int8``
   JSON lines, the 18c rows and the phase's seconds by sub-phase.
19. The pod-scale dry run and pipeline parallelism. (b) and (c)'s dry runs
   run first, in a process of their own (``--dryrun-worker``: its fake
   process group never becomes this one's), while (a) and (c)'s calls run
   on the card. (a) GPipe (``runtime/pipeline_parallel.py``): llama3.2-1b at
   full width, its 16 layers packed bf16 at keep 0.25 on 128 x 128 blocks,
   each stage its layers through ``causal_lm.layer_apply`` with no cache
   (fresh K/V discarded), so ``bcr_spmm`` and ``bcr_spmm_grouped`` run at
   full width; 4 microbatches of 2 x 128 tokens over 2 and then 4 stages,
   the ranks sharing the card under gloo (one group of 4; the 2-stage run
   on its first two), each rank's counters zeroed just before its
   ``pipeline_apply`` and read just after: every rank's output bit-equal to
   the same stage functions applied in sequence on one rank; the wall, the
   bubble fraction, launches a rank and bytes sent a step. (b) The
   reference's dry-run test: ``launch/dryrun.py``'s llama3.2-1b
   ``decode_32k`` on pod16x16 (a fake 256-rank group) ``ok`` on 256 ranks
   with FLOPs and a peak under the H100's 80 GiB; ``long_500k`` skipped as
   sub-quadratic-only. (c) The dry run held to the card at mesh 1, every
   layer run: phase 7's train step (llama3.2-1b, 16 layers, fp32 params,
   ADMM on, 8 x 128 tokens) and a bf16 prefill of 8 x 512 (dense weights,
   as the dry run's): the predicted peak within 20% of
   ``torch.cuda.max_memory_allocated`` over the same call (its state
   built, then the peak reset), and the predicted max(compute, memory)
   seconds beside the profiler's device time of one more call.

Phase 3 also holds the verify dispatch's shapes: paged prefill-append with
4 rows a slot over lengths 1..512 (ragged real rows, bf16 and int8 pages)
and every ``bcr_spmm*`` case at M = 32 = 8 slots x (``spec_k`` + 1).

Then the card's line, the ``kernels`` JSON line (the paged entries with
their prefill-append launches and time; the ``bcr_spmm*``, paged and flash
entries with their launches over phase 10a's model-drafter run,
``verify_launches``, and the BCR and paged entries with their time at the
verify shape, ``verify_ms``; every entry its launches over phase 11
(a)–(d), ``serving_launches``; the BCR, paged and flash entries their
launches on phase 12, ``moe_launches``; four entries for the
expert-batched forms, launched on phase 12 only; the ``bcr_spmm`` entry
its launches in one packed fp32 GRU step at batch 1, ``gru_launches``, and
that step's device time, ``gru_ms``, from phase 13; every entry its
launches over phase 14's three serving runs, ``family_launches``, and over
phase 15's runs, ``encdec_launches``: the fp forms over 15a's, the int8
forms and flash over 15b's; over phase 16's five packed prefills,
``train_launches``; over phase 17, ``tune_launches``; over phase 18's
sharded runs, every rank's, ``tp_launches``; over phase 19a's pipelines,
every rank's, ``pipe_launches``; and for the ``bcr_spmm``,
``bcr_spmm_grouped`` and paged entries their time and bound at phase 18c's
shard shape, ``tp_ms`` and ``tp_bound_ms``), and the contract line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_TOL, FP32_TOL = 2e-2, 1e-4  # × max(1, max |plain|)

REPO = "src/repro"               # the reference package, for "replaces"
PORT = "src/repro_torch/kernels/csrc"
# phase 12's model: deepseek-moe-16b at full width, the depth cut to 4
# layers (1 dense, 3 MoE). Its expert projections are the expert-batched
# kernel forms' shapes: 64 experts of d_ff 1408 over d_model 2048 at block
# 128 and keep 0.25; M a expert is decode's capacity (8 slots x top-6 x
# 1.25 / 64 experts, at least 4) and a 4-row 512-token prefill's 4 groups x
# 60
MOE_ARCH, MOE_LAYERS = "deepseek-moe-16b", 4
EXPERTS, EXPERT_MS = 64, (4, 240)
# phase 12b's fp32 M a expert: 2 decode slots, and its 300-token
# prompt (one group, capacity_factor 8: 300 x 6 x 8 / 64 -> 228)
EXPERT_FP32_MS = (4, 228)
EXPERT_FORMS = {"bcr_spmm_experts": "experts wo 64x2048x1408 M=4",
                "bcr_spmm_int8_experts": "experts wo 64x2048x1408 M=4",
                "bcr_spmm_grouped_experts": "experts wgi 64x2x1408x2048 M=4",
                "bcr_spmm_grouped_int8_experts":
                    "experts wgi 64x2x1408x2048 M=4"}
# launch-counter key → (CUDA source, the TPU kernel it replaces, the case
# its row in the kernels line reports: its decode- or prefill-step shape)
KERNELS = {
    "bcr_spmm": (f"{PORT}/bcr_spmm.cu", f"{REPO}/kernels/bcr_spmm.py:158",
                 "lm_head 128256x2048 M=8"),
    "bcr_spmm_grouped": (f"{PORT}/bcr_spmm.cu",
                         f"{REPO}/kernels/bcr_spmm.py:311",
                         "wgi 2x8192x2048 M=8"),
    "paged_attention": (f"{PORT}/paged_attention.cu",
                        f"{REPO}/kernels/paged_decode_attention.py:126",
                        "decode B=8 lens 1..512"),
    "bcr_spmm_int8": (f"{PORT}/bcr_spmm.cu",
                      f"{REPO}/kernels/bcr_spmm.py:158",
                      "lm_head 128256x2048 M=8"),
    "bcr_spmm_grouped_int8": (f"{PORT}/bcr_spmm.cu",
                              f"{REPO}/kernels/bcr_spmm.py:311",
                              "wgi 2x8192x2048 M=8"),
    "paged_attention_int8": (f"{PORT}/paged_attention.cu",
                             f"{REPO}/kernels/paged_decode_attention.py:126",
                             "decode B=8 lens 1..512"),
    "flash_attention_fused": (f"{PORT}/flash_attention.cu",
                              f"{REPO}/kernels/flash_attention.py:83",
                              "causal BH=256 S=512"),
    "bcr_spmm_skip": (f"{PORT}/bcr_spmm_skip.cu",
                      f"{REPO}/kernels/bcr_spmm_skip.py:120",
                      "lm_head 128256x2048 M=8"),
    # the expert-batched forms (phase 12's MoE layers): vmap(pallas_call)
    **{k: (f"{PORT}/bcr_spmm.cu",
           f"{REPO}/kernels/bcr_spmm.py:" + ("311" if "grouped" in k
                                             else "158"), shape)
       for k, shape in EXPERT_FORMS.items()},
}
# phase 3's paged case at phase 9a's append admission
APPEND_SHAPE = "prefill-append B=8 S=64 prefix 384"
# phase 10a's verify dispatch: 8 slots x (spec_k + 1) = 4 rows, ragged
# suffixes of 1..4 real rows over lengths 1..512; the projections then run
# at M = 32 rows, beside the decode step's 8 and a cold prefill's 2048
SPEC_K = 3
VERIFY_SHAPE = "verify B=8 S=4 lens 1..512"
VERIFY_MS = (1, 8, 8 * (SPEC_K + 1), 2048)
VERIFY_ROWS = {"bcr_spmm": "lm_head 128256x2048 M=32",
               "bcr_spmm_int8": "lm_head 128256x2048 M=32",
               "bcr_spmm_grouped": "wgi 2x8192x2048 M=32",
               "bcr_spmm_grouped_int8": "wgi 2x8192x2048 M=32",
               "paged_attention": VERIFY_SHAPE,
               "paged_attention_int8": VERIFY_SHAPE}
FP_KERNELS = ("bcr_spmm", "bcr_spmm_grouped", "paged_attention")
INT8_KERNELS = ("bcr_spmm_int8", "bcr_spmm_grouped_int8",
                "paged_attention_int8")


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """CUDA-event timing: median of ``reps`` single launches after warm-up,
    with a 128 MB write before each launch so weights come from device
    memory, not the 50 MB L2, as they do in a decode step. A GPU spin is
    queued before the start event, so the host has enqueued the launch by
    the time the event fires: the interval is device time, not the
    wrapper's host time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def ms(self, fn, reps=20, warmup=3, flush=None) -> float:
        """``flush``: what empties the L2 before each launch (default: the
        128 MB write, which leaves the L2 full of dirty lines)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            (flush or self.flush.zero_)()
            torch.cuda._sleep(1_000_000)       # ~0.5 ms of device time
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def check_close(name, got, want, tol, quiet=False):
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    ok = err <= tol * scale
    if not (quiet and ok):
        log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:g} x "
            f"{scale:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol} x {scale})")
    return err


def _library_dense_matmul(x, w_dense):
    return x @ w_dense.T


def _library_sdpa(torch, q, k, v, mask, is_causal=False):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=is_causal)


def counters():
    """The launch counters of every kernel wrapper, by module."""
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels.bcr_spmm_skip import LAUNCHES as SKIP
    return K.LAUNCHES, PA.LAUNCHES, FA.LAUNCHES, SKIP


def zero_counters():
    for c in counters():
        for key in c:
            c[key] = 0


def read_counters():
    return {k: v for c in counters() for k, v in c.items()}


def recorder(torch, rows):
    """``record(kernel, shape, err, ms, plain_ms, bytes, ops, dtype,
    library_ms)``: appends one timed row, with its bound, to ``rows``."""

    def record(kernel, shape, err, ms, plain_ms, byts, ops, dtype, lib_ms):
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        rows.append(dict(kernel=kernel, shape=shape, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations"))
        log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms")

    return record


def bcr_cases(torch, timer, gen, record):
    """Phase 3's timed ``bcr_spmm`` / ``bcr_spmm_grouped`` cases, fp and int8
    tiles under bf16 x, at the llama3.2-1b projections and M in
    ``VERIFY_MS`` (1, 8, the verify dispatch's 32, 2048): each checked
    against its plain version, then timed beside the plain version and the
    dense library product; rows go through
    ``record``. It uses only the wrappers' public calls, so ``--bcr-ab``
    runs it against an older tree's package too."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack, tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import (pack_group, quantize_grouped,
                                          quantize_packed)

    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def pack(n, k, dtype):
        p = tbcrc_pack(randn(n, k, dtype=torch.float32, scale=k ** -0.5),
                       spec)
        p.vals = p.vals.to(dtype)
        return p

    def tile_bytes(p):
        return (p.vals.numel() * p.vals.element_size()
                + (p.row_idx.numel() + p.col_idx.numel()) * 4)

    def scale_bytes(p):
        return p.plan.block_scales.numel() * 4

    # -- bcr_spmm ----------------------------------------------------------
    log("bcr_spmm (bf16, block 128, keep 0.25)")
    for wname, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192),
                        ("lm_head", 128256, 2048)):
        p = pack(n, k, torch.bfloat16)
        w_dense = tbcrc_unpack(p)
        for m in VERIFY_MS:
            x = randn(m, k)
            got = K.bcr_spmm(x, p)
            want = ref.bcr_spmm_packed_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"{wname} {n}x{k} M={m}", got, want, BF16_TOL)
            nb_r, nb_c, r, c = p.vals.shape
            record("bcr_spmm", f"{wname} {n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm(x, p)),
                   timer.ms(lambda: ref.bcr_spmm_packed_ref(x, p)),
                   tile_bytes(p) + (m * k + m * n) * 2,
                   2 * m * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_dense)))
        del p, w_dense
    # -- bcr_spmm_grouped ----------------------------------------------------
    log("bcr_spmm_grouped (bf16, block 128, keep 0.25)")
    for wname, n, k, epi in (("wkv", 512, 2048, None),
                             ("wgi", 8192, 2048, "swiglu")):
        grouped = pack_group([pack(n, k, torch.bfloat16) for _ in range(2)])
        w_cat = torch.cat([tbcrc_unpack(dataclasses.replace(
            grouped, vals=grouped.vals[g], row_idx=grouped.row_idx[g],
            col_idx=grouped.col_idx[g])) for g in range(2)])
        for m in VERIFY_MS:
            x = randn(m, k)
            got = K.bcr_spmm_grouped(x, grouped, epilogue=epi)
            want = ref.bcr_spmm_grouped_ref(x, grouped, epilogue=epi)
            if epi is None:
                want = want.transpose(0, 1)
            torch.cuda.synchronize()
            err = check_close(f"{wname} 2x{n}x{k} M={m}", got, want,
                              BF16_TOL)
            _, nb_r, nb_c, r, c = grouped.vals.shape
            out_n = n if epi else 2 * n
            record("bcr_spmm_grouped", f"{wname} 2x{n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm_grouped(x, grouped,
                                                       epilogue=epi)),
                   timer.ms(lambda: ref.bcr_spmm_grouped_ref(
                       x, grouped, epilogue=epi)),
                   tile_bytes(grouped) + (m * k + m * out_n) * 2,
                   2 * m * 2 * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_cat)))
        del grouped, w_cat
    log("bcr_spmm int8 tiles (bf16 x, block 128, keep 0.25)")
    for wname, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192),
                        ("lm_head", 128256, 2048)):
        p = quantize_packed(pack(n, k, torch.float32))
        w_dense = tbcrc_unpack(p).to(torch.bfloat16)
        for m in VERIFY_MS:
            x = randn(m, k)
            got = K.bcr_spmm(x, p)
            want = ref.bcr_spmm_packed_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"int8 {wname} {n}x{k} M={m}", got, want,
                              BF16_TOL)
            nb_r, nb_c, r, c = p.vals.shape
            record("bcr_spmm_int8", f"{wname} {n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm(x, p)),
                   timer.ms(lambda: ref.bcr_spmm_packed_ref(x, p)),
                   tile_bytes(p) + scale_bytes(p) + (m * k + m * n) * 2,
                   2 * m * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_dense)))
        del p, w_dense
    log("bcr_spmm_grouped int8 tiles (bf16 x, block 128, keep 0.25)")
    for wname, n, k, epi in (("wkv", 512, 2048, None),
                             ("wgi", 8192, 2048, "swiglu")):
        grouped = quantize_grouped(pack_group(
            [pack(n, k, torch.float32) for _ in range(2)]))
        w_cat = torch.cat([tbcrc_unpack(dataclasses.replace(
            grouped, vals=grouped.vals[g], row_idx=grouped.row_idx[g],
            col_idx=grouped.col_idx[g], plan=dataclasses.replace(
                grouped.plan, block_scales=grouped.plan.block_scales[g])))
            for g in range(2)]).to(torch.bfloat16)
        for m in VERIFY_MS:
            x = randn(m, k)
            got = K.bcr_spmm_grouped(x, grouped, epilogue=epi)
            want = ref.bcr_spmm_grouped_ref(x, grouped, epilogue=epi)
            if epi is None:
                want = want.transpose(0, 1)
            torch.cuda.synchronize()
            err = check_close(f"int8 {wname} 2x{n}x{k} M={m}", got, want,
                              BF16_TOL)
            _, nb_r, nb_c, r, c = grouped.vals.shape
            out_n = n if epi else 2 * n
            record("bcr_spmm_grouped_int8", f"{wname} 2x{n}x{k} M={m}", err,
                   timer.ms(lambda: K.bcr_spmm_grouped(x, grouped,
                                                       epilogue=epi)),
                   timer.ms(lambda: ref.bcr_spmm_grouped_ref(
                       x, grouped, epilogue=epi)),
                   tile_bytes(grouped) + scale_bytes(grouped)
                   + (m * k + m * out_n) * 2,
                   2 * m * 2 * nb_r * nb_c * r * c, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_cat)))
        del grouped, w_cat


def sass_functions(lib_path: Path) -> dict:
    """``cuobjdump -sass`` of a built library: {mangled kernel name: its
    SASS lines}."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    fns, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            fns[name] = []
        elif name is not None:
            fns[name].append(line)
    return fns


def sass_tensor_ops(lib_path: Path) -> dict:
    """Tensor-core instructions per kernel of a built library, from
    ``cuobjdump -sass``: {mangled kernel name: (HMMA count, HGMMA count)}.
    HMMA is the warp-level ``mma.sync``; HGMMA is ``wgmma``."""
    ops = {}
    for name, lines in sass_functions(lib_path).items():
        ops[name] = (sum("HMMA" in ln for ln in lines),
                     sum("HGMMA" in ln for ln in lines))
    return ops


def bcr_instruction_check(lib_path: Path) -> None:
    """Which instruction each BCR form runs, read from the built library:
    every tensor-core kernel (bf16 x) of an M tile up to 64 issues
    ``mma.sync`` (HMMA) and the 128 tile ``wgmma`` (HGMMA); the fp32-x
    kernels issue neither (CUDA cores)."""
    from repro_torch.kernels import bcr_spmm as K

    ops = sass_tensor_ops(lib_path)
    rows = {}
    for name, (hmma, hgmma) in ops.items():
        m = re.search(r"bcr_spmm(_grouped)?_tcILb([01])ELi(\d+)ELi\d+ELi(\d+)E",
                      name)
        if m:
            form = ("bcr_spmm" + ("_grouped" if m.group(1) else "")
                    + ("_int8" if m.group(2) == "1" else ""))
            want = ("wgmma" if int(m.group(4)) == K.WGMMA_WARPS_M
                    else "mma.sync")
            got = ("wgmma" if hgmma and not hmma
                   else "mma.sync" if hmma and not hgmma else None)
            if got != want:
                raise AssertionError(f"{name}: {hmma} HMMA, {hgmma} HGMMA; "
                                     f"want {want}")
            rows.setdefault(form, set()).add(
                f"M tile {m.group(3)}: {want}")
        elif "cuda_core" in name and (hmma or hgmma):
            raise AssertionError(f"{name}: the fp32 body issued tensor-core "
                                 f"instructions")
    for form in sorted(rows):
        log(f"  {form} (bf16 x): "
            + ", ".join(sorted(rows[form], key=lambda t: int(t.split()[2][:-1]))))
    log("  fp32 x (every form): CUDA-core FMAs, no HMMA/HGMMA")
    # the expert-batched forms are these kernels with the expert on a grid
    # axis: every stacked tensor-core instantiation (STACKED = 1) reads
    # blockIdx.y and every CUDA-core body blockIdx.z, so one launch covers E
    # experts; the unstacked tensor-core instantiations read no expert axis
    # at all (no expert arithmetic on the dense family's path)
    axes = {"Y": 0, "Z": 0, "none": 0}
    for name, lines in sass_functions(lib_path).items():
        if "bcr_spmm" not in name:
            continue
        tc = re.search(r"_tcILb[01]ELi\d+ELi\d+ELi\d+ELi\d+ELb([01])E",
                       name)
        axis = "Z" if "cuda_core" in name else "Y"
        reads = any(f"SR_CTAID.{axis}" in ln for ln in lines)
        if tc and tc.group(1) == "0":
            if reads:
                raise AssertionError(f"{name}: the unstacked instantiation "
                                     f"reads SR_CTAID.Y")
            axes["none"] += 1
        elif not reads:
            raise AssertionError(f"{name}: no SR_CTAID.{axis} (the expert "
                                 f"grid axis) in its SASS")
        else:
            axes[axis] += 1
    if not (axes["Y"] and axes["Y"] == axes["none"]):
        raise AssertionError(f"stacked / unstacked tensor-core kernels "
                             f"{axes}: want one of each per configuration")
    log(f"  expert-batched forms: the same bodies, expert index read from "
        f"SR_CTAID.Y in {axes['Y']} stacked tensor-core kernels (HMMA / "
        f"HGMMA as above; their {axes['none']} unstacked twins read no "
        f"expert axis) and SR_CTAID.Z in {axes['Z']} CUDA-core kernels")


def tc_instruction_check(skip_lib: Path, flash_lib: Path,
                         paged_lib: Path) -> None:
    """The same for the bf16 bodies of ``bcr_spmm_skip`` (mma.sync = HMMA
    for M tiles 8..64, wgmma = HGMMA for the 128 tile),
    ``flash_attention_fused`` (HGMMA at head_dim 64, HMMA at the others)
    and paged attention (HMMA over bf16 and over int8 pages, every head_dim
    and row tile); their CUDA-core bodies run neither."""
    kinds = (
        (skip_lib, r"bcr_spmm_skip_tcILi(\d+)ELi(\d+)ELb([01])E",
         lambda m: (f"bcr_spmm_skip M tile {m.group(1)}",
                    m.group(3) == "1")),
        (flash_lib, r"flash_attention_tcILi(\d+)EE",
         lambda m: (f"flash_attention_fused head_dim {m.group(1)}",
                    int(m.group(1)) == 64)),
        (paged_lib, r"paged_attention_tcI(13__nv_bfloat16|a)Li(\d+)ELi(\d+)E",
         lambda m: ("paged_attention "
                    + ("int8" if m.group(1) == "a" else "bf16") + " pages",
                    False)),
    )
    seen = {}
    for lib, pat, kind_of in kinds:
        for name, (hmma, hgmma) in sass_tensor_ops(lib).items():
            m = re.search(pat, name)
            if m:
                kind, wg = kind_of(m)
                want = "wgmma" if wg else "mma.sync"
                got = ("wgmma" if hgmma and not hmma
                       else "mma.sync" if hmma and not hgmma else None)
                if got != want:
                    raise AssertionError(f"{name}: {hmma} HMMA, {hgmma} "
                                         f"HGMMA; want {want}")
                seen.setdefault(kind, set()).add(want)
            elif "cuda_core" in name and (hmma or hgmma):
                raise AssertionError(f"{name}: a CUDA-core body issued "
                                     f"tensor-core instructions")
    for prefix in ("bcr_spmm_skip", "flash", "paged_attention bf16",
                   "paged_attention int8"):
        if not any(k.startswith(prefix) for k in seen):
            raise AssertionError(f"tensor-core kernels missing ({prefix}): "
                                 f"{sorted(seen)}")
    log("  " + "; ".join(f"{k}: {'/'.join(sorted(v))}"
                         for k, v in sorted(seen.items())))
    log("  bcr_spmm_skip, flash and paged CUDA-core bodies (fp32, other "
        "blocks, head dims and page sizes): no HMMA/HGMMA")


def check_split(torch, form, plan, run, want, out_shape) -> None:
    """One split launch form: two launches give bit-equal y (the last split
    sums the partials in split order); the output and the workspace land
    in freed NaN-filled blocks and the result is still right; the split
    counters are back at zero after the calls."""
    from repro_torch.kernels import bcr_spmm as K

    poison = (torch.full((plan.workspace_floats,), float("nan"),
                         device="cuda"),
              torch.full(out_shape, float("nan"), dtype=torch.bfloat16,
                         device="cuda"))
    del poison           # the allocator hands these blocks back next
    first = run()
    second = run()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(first).all()):
        raise AssertionError(f"split {form}: non-finite output over "
                             f"NaN-filled buffers")
    if not torch.equal(first, second):
        raise AssertionError(f"split {form}: two launches differ")
    check_close(f"split {form} (S={plan.splits}, grid {plan.grid}, "
                f"NaN-filled workspace and output)", first, want, BF16_TOL)
    left = int(torch.count_nonzero(
        K.split_counters(first.device, plan.tiles)[:plan.tiles]))
    if left:
        raise AssertionError(f"split {form}: {left} counters not back at "
                             f"zero")
    log(f"  split {form}: two launches bit-equal, counters back at 0")


def bcr_split_checks(torch, gen) -> None:
    """The one-launch split over contraction blocks at decode: MLP wo
    (2048 x 8192) and the gate/up pair (2 x 8192 x 2048, SwiGLU) at M = 8,
    fp and int8 tiles, each held by :func:`check_split`."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import (pack_group, quantize_grouped,
                                          quantize_packed)

    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n, k, g in (("mlp_wo", 2048, 8192, 1), ("wgi", 8192, 2048, 2)):
        for int8 in (False, True):
            packs = []
            for _ in range(g):
                w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
                p = tbcrc_pack(w, spec)
                if not int8:
                    p.vals = p.vals.to(torch.bfloat16)
                packs.append(p)
            if g == 2:
                w = pack_group(packs)
                w = quantize_grouped(w) if int8 else w
            else:
                w = quantize_packed(packs[0]) if int8 else packs[0]
            x = torch.randn((8, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            r, c = w.vals.shape[-2:]
            plan = K.launch_plan(8, n, k, g, (128, 128), (r, c), sms, int8)
            if plan.splits < 2:
                raise AssertionError(f"{name} at M=8 did not split: {plan}")

            def run():
                if g == 2:
                    return K.bcr_spmm_grouped(x, w, epilogue="swiglu")
                return K.bcr_spmm(x, w)

            want = (ref.bcr_spmm_grouped_ref(x, w, epilogue="swiglu")
                    if g == 2 else ref.bcr_spmm_packed_ref(x, w))
            check_split(torch, f"{'int8 ' if int8 else ''}{name} {g}x{n}x{k} "
                        f"M=8", plan, run, want, (8, n))


def phase_kernels(torch, timer):
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack, tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import pack_group

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)
    rows = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def pack(n, k, dtype, block_spec=spec):
        p = tbcrc_pack(randn(n, k, dtype=torch.float32, scale=k ** -0.5),
                       block_spec)
        p.vals = p.vals.to(dtype)
        return p

    record = recorder(torch, rows)

    bcr_cases(torch, timer, gen, record)
    log("bcr_spmm split path (M=8, one launch)")
    bcr_split_checks(torch, gen)
    p = pack(256, 384, torch.float32)
    x = randn(5, 384, dtype=torch.float32)
    err = check_close("fp32 256x384 M=5", K.bcr_spmm(x, p),
                      ref.bcr_spmm_packed_ref(x, p), FP32_TOL)

    grouped = pack_group([pack(256, 384, torch.float32) for _ in range(2)])
    x = randn(5, 384, dtype=torch.float32)
    bias = randn(2, 256, dtype=torch.float32)
    check_close("fp32 2x256x384 M=5 swiglu+bias",
                K.bcr_spmm_grouped(x, grouped, bias=bias, epilogue="swiglu"),
                ref.bcr_spmm_grouped_ref(x, grouped, bias=bias,
                                         epilogue="swiglu"), FP32_TOL)

    # -- int8 tiles ----------------------------------------------------------
    from repro_torch.kernels.plan import quantize_grouped, quantize_packed

    p = quantize_packed(pack(256, 384, torch.float32))
    x = randn(5, 384, dtype=torch.float32)
    check_close("int8 tiles, fp32 x 256x384 M=5", K.bcr_spmm(x, p),
                ref.bcr_spmm_packed_ref(x, p), FP32_TOL)

    grouped = quantize_grouped(pack_group(
        [pack(256, 384, torch.float32) for _ in range(2)]))
    x = randn(5, 384, dtype=torch.float32)
    bias = randn(2, 256, dtype=torch.float32)
    check_close("int8 tiles, fp32 x 2x256x384 M=5 swiglu+bias",
                K.bcr_spmm_grouped(x, grouped, bias=bias, epilogue="swiglu"),
                ref.bcr_spmm_grouped_ref(x, grouped, bias=bias,
                                         epilogue="swiglu"), FP32_TOL)

    paged_cases(torch, timer, gen, record)
    log("paged attention split path (one launch)")
    paged_split_checks(torch, gen)
    flash_cases(torch, timer, gen, record)
    log("flash_attention_fused CTA order (heaviest q tiles first)")
    flash_order_check(torch, gen)
    skip_cases(torch, timer, gen, record)
    log("bcr_spmm_skip split path (M=8, one launch)")
    skip_split_checks(torch, gen)
    expert_cases(torch, timer, gen, record)
    log("expert-batched split path (M=4, one launch)")
    expert_split_checks(torch, gen)
    moe_attention_cases(torch, timer, gen, record)
    family_cases(torch, timer, gen, record)
    return rows


def paged_cases(torch, timer, gen, record):
    """Phase 3's paged attention cases (llama3.2-1b's attention: 32/8 heads,
    head_dim 64, page 16), fp (bf16) and int8 pages under bf16 q: decode
    over 8 slots of lengths 1..512 (one inactive) and 1024..4096,
    prefill-append of 16 rows over a 100-token prefix and of 64 rows over
    a 384-token prefix (phase 9a's append admission) and of 4 ragged rows
    over lengths 1..512 (phase 10a's verify), each checked against its
    plain version and timed beside it and a gathered SDPA; plus small
    fp32 cases. It uses only the wrappers' public calls, so ``--bcr-ab``
    runs it against an older tree's package too."""
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import dequantize_rows, quantize_rows

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    log("paged attention (bf16, 32/8 heads, head_dim 64, page 16)")
    hkv, h, d, ps = 8, 32, 64, 16

    def pages(tlens, dtype):
        per = [-(-int(t) // ps) for t in tlens]
        n_pages = 1 + sum(per) + 8
        kp = randn(n_pages, ps, hkv, d, dtype=dtype)
        vp = randn(n_pages, ps, hkv, d, dtype=dtype)
        kp[0].zero_()
        vp[0].zero_()
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device="cuda").cpu() + 1
        width = max(per)
        bt = torch.zeros((len(tlens), width), dtype=torch.int32)
        nxt = 0
        for i, npg in enumerate(per):
            bt[i, :npg] = perm[nxt:nxt + npg]
            nxt += npg
        return kp, vp, bt.cuda()

    def gathered_sdpa(q, kp, vp, bt, qpos):
        b, s = q.shape[:2]
        l = bt.shape[1] * ps
        kk = kp[bt.long()].reshape(b, l, hkv, d).repeat_interleave(h // hkv,
                                                                   2)
        vv = vp[bt.long()].reshape(b, l, hkv, d).repeat_interleave(h // hkv,
                                                                   2)
        mask = (torch.arange(l, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        args = (q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                mask)
        return timer.ms(lambda: _library_sdpa(torch, *args))

    lens = torch.tensor([1, 37, 128, 200, 333, 511, 512, 0],
                        dtype=torch.int32, device="cuda")
    kp, vp, bt = pages(lens.tolist(), torch.bfloat16)
    q = randn(8, 1, h, d)
    got = PA.paged_decode_attention(q, kp, vp, bt, lens)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    live = lens > 0
    err = check_close("decode B=8 lens 1..512 + inactive", got[live],
                      want[live], BF16_TOL)
    if not (bool(torch.isfinite(got).all())
            and int(torch.count_nonzero(got[~live])) == 0):
        raise AssertionError("inactive slot output is not finite zeros")
    kv_bytes = PA.paged_kv_bytes(lens.cpu().numpy(), ps, hkv, d, 2)
    record("paged_attention", "decode B=8 lens 1..512", err,
           timer.ms(lambda: PA.paged_decode_attention(q, kp, vp, bt, lens)),
           timer.ms(lambda: ref.paged_decode_attention_ref(q, kp, vp, bt,
                                                           lens)),
           kv_bytes + 2 * q.numel() * 2 + bt.numel() * 4,
           4 * int(lens.sum()) * h * d, torch.bfloat16,
           gathered_sdpa(q, kp, vp, bt, (lens - 1)[:, None]))

    long_lens = torch.tensor([1024, 1500, 2000, 2500, 3000, 3500, 4000,
                              4096], dtype=torch.int32, device="cuda")
    kp, vp, bt = pages(long_lens.tolist(), torch.bfloat16)
    q = randn(8, 1, h, d)
    got = PA.paged_decode_attention(q, kp, vp, bt, long_lens)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, long_lens)
    torch.cuda.synchronize()
    err = check_close("decode B=8 lens 1024..4096", got, want, BF16_TOL)
    # what a plain read of the same bytes takes under the same timer, and
    # both again with the L2 flushed by a read (clean lines, as in a decode
    # step) instead of the write that leaves dirty lines to write back
    pool = torch.cat([kp.flatten(), vp.flatten()])

    def read_all():
        return pool.sum(dtype=torch.float32)

    def kernel():
        return PA.paged_decode_attention(q, kp, vp, bt, long_lens)

    clean = timer.flush.sum
    log(f"    streaming yardstick ({pool.numel() * 2 / 1e6:.1f} MB K/V "
        f"pool): torch sum {timer.ms(read_all):.4f} ms; flushed by a read: "
        f"kernel {timer.ms(kernel, flush=clean):.4f} ms, torch sum "
        f"{timer.ms(read_all, flush=clean):.4f} ms")
    del pool
    record("paged_attention", "decode B=8 lens 1024..4096", err,
           timer.ms(lambda: PA.paged_decode_attention(q, kp, vp, bt,
                                                      long_lens)),
           timer.ms(lambda: ref.paged_decode_attention_ref(q, kp, vp, bt,
                                                           long_lens)),
           PA.paged_kv_bytes(long_lens.cpu().numpy(), ps, hkv, d, 2)
           + 2 * q.numel() * 2 + bt.numel() * 4,
           4 * int(long_lens.sum()) * h * d, torch.bfloat16,
           gathered_sdpa(q, kp, vp, bt, (long_lens - 1)[:, None]))
    del kp, vp, got, want

    plen = torch.full((8,), 100, dtype=torch.int32, device="cuda")
    tlen = plen + 16
    kp, vp, bt = pages(tlen.tolist(), torch.bfloat16)
    q = randn(8, 16, h, d)
    got = PA.paged_prefill_append_attention(q, kp, vp, bt, plen, tlen)
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, plen, tlen)
    torch.cuda.synchronize()
    err = check_close("prefill-append B=8 S=16 over 100", got, want, BF16_TOL)
    qpos = plen[:, None] + torch.arange(16, device="cuda")[None]
    record("paged_attention", "prefill-append B=8 S=16 prefix 100", err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kp, vp, bt, plen, tlen)),
           timer.ms(lambda: ref.paged_prefill_append_ref(q, kp, vp, bt, plen,
                                                         tlen)),
           PA.paged_kv_bytes(tlen.cpu().numpy(), ps, hkv, d, 2)
           + 2 * q.numel() * 2, 4 * 8 * 16 * 108 * h * d, torch.bfloat16,
           gathered_sdpa(q, kp, vp, bt, qpos))

    # the prefix cache's append admission at phase 9a's shape: a 64-row
    # suffix bucket over a 384-token cached prefix (24 full pages), 8 rows
    aplen = torch.full((8,), 384, dtype=torch.int32, device="cuda")
    atlen = aplen + 64
    kp, vp, bt = pages(atlen.tolist(), torch.bfloat16)
    q = randn(8, 64, h, d)
    got = PA.paged_prefill_append_attention(q, kp, vp, bt, aplen, atlen)
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, aplen, atlen)
    torch.cuda.synchronize()
    err = check_close("prefill-append B=8 S=64 over 384", got, want,
                      BF16_TOL)
    aqpos = aplen[:, None] + torch.arange(64, device="cuda")[None]
    aops = 4 * 8 * (64 * 384 + 64 * 65 // 2) * h * d
    record("paged_attention", APPEND_SHAPE, err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kp, vp, bt, aplen, atlen)),
           timer.ms(lambda: ref.paged_prefill_append_ref(q, kp, vp, bt,
                                                         aplen, atlen)),
           PA.paged_kv_bytes(atlen.cpu().numpy(), ps, hkv, d, 2)
           + 2 * q.numel() * 2, aops, torch.bfloat16,
           gathered_sdpa(q, kp, vp, bt, aqpos))

    # the speculative verify dispatch: 4 rows a slot over lengths 1..512,
    # ragged real rows (1..4; the last slot idle with none); rows past a
    # slot's suffix are pads the engine discards, so only real rows are
    # compared, and bound and ops count the real rows
    vplen = torch.tensor([0, 36, 125, 197, 330, 508, 509, 0],
                         dtype=torch.int32, device="cuda")
    vslen = torch.tensor([1, 2, 3, 4, 4, 4, 3, 0], dtype=torch.int32,
                         device="cuda")
    vtlen = vplen + vslen
    vreal = (torch.arange(4, device="cuda")[None] < vslen[:, None])
    vqpos = vplen[:, None] + torch.arange(4, device="cuda")[None]
    vops = 4 * int(((vqpos + 1) * vreal).sum()) * h * d
    kp, vp, bt = pages(vtlen.clamp(min=1).tolist(), torch.bfloat16)
    q = randn(8, 4, h, d)
    got = PA.paged_prefill_append_attention(q, kp, vp, bt, vplen, vtlen)
    want = ref.paged_prefill_append_ref(q, kp, vp, bt, vplen, vtlen)
    torch.cuda.synchronize()
    err = check_close("verify B=8 S=4 lens 1..512, real rows", got[vreal],
                      want[vreal], BF16_TOL)
    record("paged_attention", VERIFY_SHAPE, err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kp, vp, bt, vplen, vtlen)),
           timer.ms(lambda: ref.paged_prefill_append_ref(q, kp, vp, bt,
                                                         vplen, vtlen)),
           PA.paged_kv_bytes(vtlen.cpu().numpy(), ps, hkv, d, 2)
           + 2 * int(vslen.sum()) * h * d * 2 + bt.numel() * 4, vops,
           torch.bfloat16, gathered_sdpa(q, kp, vp, bt, vqpos))

    small = torch.tensor([5, 0, 23], dtype=torch.int32, device="cuda")
    kp, vp, bt = pages([5, 1, 23], torch.float32)
    q = randn(3, 1, h, d, dtype=torch.float32)
    got = PA.paged_decode_attention(q, kp, vp, bt, small)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, small)
    check_close("fp32 decode B=3", got[small > 0], want[small > 0], FP32_TOL)
    q = randn(3, 4, h, d, dtype=torch.float32)
    pl = torch.tensor([1, 0, 19], dtype=torch.int32, device="cuda")
    tl = pl + 4
    kp, vp, bt = pages(tl.tolist(), torch.float32)
    check_close("fp32 prefill-append B=3 S=4",
                PA.paged_prefill_append_attention(q, kp, vp, bt, pl, tl),
                ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl),
                FP32_TOL)
    del kp, vp

    # -- int8 pages ----------------------------------------------------------
    log("paged attention int8 pages (bf16 q, 32/8 heads, head_dim 64, "
        "page 16)")

    def int8_pages(tlens):
        kp, vp, bt = pages(tlens, torch.float32)
        kc, ks = quantize_rows(kp)
        vc, vs = quantize_rows(vp)
        deq = (dequantize_rows(kc, ks, torch.bfloat16),
               dequantize_rows(vc, vs, torch.bfloat16))
        return kc, vc, ks, vs, bt, deq

    kc, vc, ks, vs, bt, deq = int8_pages(lens.tolist())
    q = randn(8, 1, h, d)
    got = PA.paged_decode_attention(q, kc, vc, bt, lens, k_scale=ks,
                                    v_scale=vs)
    want = ref.paged_decode_attention_ref(q, kc, vc, bt, lens, k_scale=ks,
                                          v_scale=vs)
    torch.cuda.synchronize()
    err = check_close("int8 decode B=8 lens 1..512 + inactive", got[live],
                      want[live], BF16_TOL)
    if not (bool(torch.isfinite(got).all())
            and int(torch.count_nonzero(got[~live])) == 0):
        raise AssertionError("inactive slot output is not finite zeros")
    record("paged_attention_int8", "decode B=8 lens 1..512", err,
           timer.ms(lambda: PA.paged_decode_attention(
               q, kc, vc, bt, lens, k_scale=ks, v_scale=vs)),
           timer.ms(lambda: ref.paged_decode_attention_ref(
               q, kc, vc, bt, lens, k_scale=ks, v_scale=vs)),
           PA.paged_kv_bytes(lens.cpu().numpy(), ps, hkv, d, 1, 4)
           + 2 * q.numel() * 2 + bt.numel() * 4,
           4 * int(lens.sum()) * h * d, torch.bfloat16,
           gathered_sdpa(q, *deq, bt, (lens - 1)[:, None]))

    kc, vc, ks, vs, bt, deq = int8_pages(tlen.tolist())
    q = randn(8, 16, h, d)
    got = PA.paged_prefill_append_attention(q, kc, vc, bt, plen, tlen,
                                            k_scale=ks, v_scale=vs)
    want = ref.paged_prefill_append_ref(q, kc, vc, bt, plen, tlen,
                                        k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = check_close("int8 prefill-append B=8 S=16 over 100", got, want,
                      BF16_TOL)
    record("paged_attention_int8", "prefill-append B=8 S=16 prefix 100", err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kc, vc, bt, plen, tlen, k_scale=ks, v_scale=vs)),
           timer.ms(lambda: ref.paged_prefill_append_ref(
               q, kc, vc, bt, plen, tlen, k_scale=ks, v_scale=vs)),
           PA.paged_kv_bytes(tlen.cpu().numpy(), ps, hkv, d, 1, 4)
           + 2 * q.numel() * 2, 4 * 8 * 16 * 108 * h * d, torch.bfloat16,
           gathered_sdpa(q, *deq, bt, qpos))

    kc, vc, ks, vs, bt, deq = int8_pages(atlen.tolist())
    q = randn(8, 64, h, d)
    got = PA.paged_prefill_append_attention(q, kc, vc, bt, aplen, atlen,
                                            k_scale=ks, v_scale=vs)
    want = ref.paged_prefill_append_ref(q, kc, vc, bt, aplen, atlen,
                                        k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = check_close("int8 prefill-append B=8 S=64 over 384", got, want,
                      BF16_TOL)
    record("paged_attention_int8", APPEND_SHAPE, err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kc, vc, bt, aplen, atlen, k_scale=ks, v_scale=vs)),
           timer.ms(lambda: ref.paged_prefill_append_ref(
               q, kc, vc, bt, aplen, atlen, k_scale=ks, v_scale=vs)),
           PA.paged_kv_bytes(atlen.cpu().numpy(), ps, hkv, d, 1, 4)
           + 2 * q.numel() * 2, aops, torch.bfloat16,
           gathered_sdpa(q, *deq, bt, aqpos))

    kc, vc, ks, vs, bt, deq = int8_pages(vtlen.clamp(min=1).tolist())
    q = randn(8, 4, h, d)
    got = PA.paged_prefill_append_attention(q, kc, vc, bt, vplen, vtlen,
                                            k_scale=ks, v_scale=vs)
    want = ref.paged_prefill_append_ref(q, kc, vc, bt, vplen, vtlen,
                                        k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    err = check_close("int8 verify B=8 S=4 lens 1..512, real rows",
                      got[vreal], want[vreal], BF16_TOL)
    record("paged_attention_int8", VERIFY_SHAPE, err,
           timer.ms(lambda: PA.paged_prefill_append_attention(
               q, kc, vc, bt, vplen, vtlen, k_scale=ks, v_scale=vs)),
           timer.ms(lambda: ref.paged_prefill_append_ref(
               q, kc, vc, bt, vplen, vtlen, k_scale=ks, v_scale=vs)),
           PA.paged_kv_bytes(vtlen.cpu().numpy(), ps, hkv, d, 1, 4)
           + 2 * int(vslen.sum()) * h * d * 2 + bt.numel() * 4, vops,
           torch.bfloat16, gathered_sdpa(q, *deq, bt, vqpos))

    kc, vc, ks, vs, bt, _ = int8_pages([5, 1, 23])
    q = randn(3, 1, h, d, dtype=torch.float32)
    check_close("int8 pages, fp32 q decode B=3",
                PA.paged_decode_attention(q, kc, vc, bt, small, k_scale=ks,
                                          v_scale=vs)[small > 0],
                ref.paged_decode_attention_ref(q, kc, vc, bt, small,
                                               k_scale=ks,
                                               v_scale=vs)[small > 0],
                FP32_TOL)
    kc, vc, ks, vs, bt, _ = int8_pages(tl.tolist())
    q = randn(3, 4, h, d, dtype=torch.float32)
    check_close("int8 pages, fp32 q prefill-append B=3 S=4",
                PA.paged_prefill_append_attention(q, kc, vc, bt, pl, tl,
                                                  k_scale=ks, v_scale=vs),
                ref.paged_prefill_append_ref(q, kc, vc, bt, pl, tl,
                                             k_scale=ks, v_scale=vs),
                FP32_TOL)
    del kc, vc, ks, vs, deq


def paged_split_checks(torch, gen) -> None:
    """The one-launch split over pages at the serving shapes (8 slots, one
    empty and one at 4096 positions), decode and prefill-append, fp and
    int8 pages: the plan splits; two launches give bit-equal output (the
    last split merges in split order); the output and the workspace land in
    freed NaN-filled blocks and the result is still right, the empty slot
    exact zeros; the split counters are back at zero after the calls."""
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import quantize_rows

    hkv, h, d, ps = 8, 32, 64, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lens = [1, 37, 128, 200, 333, 511, 4096, 0]
    per = [-(-n // ps) for n in lens]
    n_pages = 1 + sum(per)
    bt = torch.zeros((8, max(per)), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda").cpu() + 1
    nxt = 0
    for i, npg in enumerate(per):
        bt[i, :npg] = perm[nxt:nxt + npg]
        nxt += npg
    bt = bt.cuda()
    tl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kf = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda")
    vf = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda")
    for int8 in (False, True):
        if int8:
            (kp, ks), (vp, vs) = quantize_rows(kf), quantize_rows(vf)
            sc = dict(k_scale=ks, v_scale=vs)
        else:
            kp, vp, sc = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
        for s in (1, 16):
            q = torch.randn((8, s, h, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            pl = torch.clamp(tl - s, min=0)
            plan = PA.paged_plan(8, hkv, s * h // hkv, bt.shape[1], ps, sms)
            if plan.splits < 2:
                raise AssertionError(f"paged S={s} did not split: {plan}")

            def run():
                if s == 1:
                    return PA.paged_decode_attention(q, kp, vp, bt, tl, **sc)
                return PA.paged_prefill_append_attention(q, kp, vp, bt, pl,
                                                         tl, **sc)

            want = (ref.paged_decode_attention_ref(q, kp, vp, bt, tl, **sc)
                    if s == 1 else
                    ref.paged_prefill_append_ref(q, kp, vp, bt, pl, tl, **sc))
            poison = (torch.full((plan.workspace_floats(d),), float("nan"),
                                 device="cuda"),
                      torch.full(q.shape, float("nan"), dtype=torch.bfloat16,
                                 device="cuda"))
            del poison           # the allocator hands these blocks back next
            first = run()
            second = run()
            torch.cuda.synchronize()
            form = ("int8 " if int8 else "") + (
                "decode" if s == 1 else "prefill-append S=16")
            if not bool(torch.isfinite(first).all()) \
                    or int(torch.count_nonzero(first[-1])):
                raise AssertionError(f"paged split {form}: non-finite output "
                                     f"or a non-zero empty slot over "
                                     f"NaN-filled buffers")
            if not torch.equal(first, second):
                raise AssertionError(f"paged split {form}: two launches "
                                     f"differ")
            check_close(f"paged split {form} (S={plan.splits}, grid "
                        f"{plan.grid}, NaN-filled workspace and output)",
                        first[:-1], want[:-1], BF16_TOL)
            left = int(torch.count_nonzero(
                K.split_counters(q.device, plan.units)[:plan.units]))
            if left:
                raise AssertionError(f"paged split {form}: {left} counters "
                                     f"not back at zero")
            log(f"  paged split {form}: two launches bit-equal, counters "
                f"back at 0, empty slot zeros")


def flash_cases(torch, timer, gen, record):
    """Phase 3's timed ``flash_attention_fused`` cases (bf16, B·H = 8·32,
    head_dim 64: causal S in {128, 512}, non-causal 512, Sq = 128 over
    Skv = 512 at ``q_offset`` 384) and one small fp32 case. It uses only
    the wrapper's public call, so ``--bcr-ab`` runs it against an older
    tree's package too."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    log("flash_attention_fused (bf16, B*H = 8*32, head_dim 64)")
    h, d = 32, 64
    bh = 8 * h
    for name, sq, skv, causal, q_off in (
            ("causal BH=256 S=128", 128, 128, True, 0),
            ("causal BH=256 S=512", 512, 512, True, 0),
            ("non-causal BH=256 S=512", 512, 512, False, 0),
            ("q_offset 384 BH=256 Sq=128 Skv=512", 128, 512, True, 384)):
        q, k, v = randn(bh, sq, d), randn(bh, skv, d), randn(bh, skv, d)
        kw = dict(causal=causal, q_chunk=512, kv_chunk=1024, q_offset=q_off)
        got = FA.flash_attention_fused(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_off)
        torch.cuda.synchronize()
        err = check_close(f"flash {name}", got, want, BF16_TOL)
        # (q, k) pairs the function needs: under causal, row i sees keys
        # 0 .. q_offset + i
        pairs = (sum(min(skv, q_off + i + 1) for i in range(sq)) if causal
                 else sq * skv)
        q4, k4, v4 = (t.reshape(8, h, t.shape[1], d) for t in (q, k, v))
        if causal and q_off:
            mask = (torch.arange(skv, device="cuda")[None, :]
                    <= q_off + torch.arange(sq, device="cuda")[:, None])
            lib = timer.ms(lambda: _library_sdpa(torch, q4, k4, v4, mask))
        else:
            lib = timer.ms(lambda: _library_sdpa(torch, q4, k4, v4, None,
                                                 is_causal=causal))
        record("flash_attention_fused", name, err,
               timer.ms(lambda: FA.flash_attention_fused(q, k, v, **kw)),
               timer.ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=causal, q_offset=q_off)),
               (2 * bh * sq * d + 2 * bh * skv * d) * 2,
               4 * bh * pairs * d, torch.bfloat16, lib)
        del q, k, v, got, want
    q, k, v = (randn(4, 77, d, dtype=torch.float32) for _ in range(3))
    check_close("flash fp32 BH=4 S=77 causal",
                FA.flash_attention_fused(q, k, v, q_chunk=77, kv_chunk=77),
                ref.flash_attention_ref(q, k, v), FP32_TOL)


def flash_order_check(torch, gen):
    """Under ``causal`` the bf16 kernel launches the heaviest q tiles first
    (q-tile-major, last tile first); that order and the B·H-major one give
    bit-equal outputs at the serving shape."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = (torch.randn((256, 512, 64), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    outs = []
    for bh_major in (False, True):
        out = torch.empty_like(q)
        FA._launch(q, k, v, out, True, 0, bh_major=bh_major)
        outs.append(out)
    torch.cuda.synchronize()
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("the CTA order changed the flash output")
    log("  causal BH=256 S=512: heaviest-first order (q tile 3 of 4 of "
        "every row first) bit-equal to the B*H-major order")


def skip_pack(torch, w, block=128, keep=0.25, dtype=None):
    """``pack_skip`` at unbalanced keep ``keep``; tiles cast to ``dtype``
    (the activation dtype) once, as pack time would."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.kernels.bcr_spmm_skip import pack_skip
    p = pack_skip(w, BCRSpec(block_shape=(block, block), keep_frac=keep,
                             align=8 if block >= 32 else 1, balanced=False))
    if dtype is not None:
        p = dataclasses.replace(p, tiles=p.tiles.to(dtype))
    nb_r = p.shape[0] // p.block_shape[0]
    nb_c = p.shape[1] // p.block_shape[1]
    empty = int((p.row_start[1:] == p.row_start[:-1]).sum())
    return p, p.tiles.shape[0] / (nb_r * nb_c), empty


def skip_bytes_ops(p, m, elt=2):
    """What the function must move and do for these inputs: the surviving
    tiles, x once, y once, 12 bytes of indices per tile; 2·M·num_nz·br·bc
    operations."""
    n, k = p.shape
    br, bc = p.block_shape
    nz = p.tiles.shape[0]
    return (nz * br * bc * elt + (m * k + m * n) * elt + 12 * nz,
            2 * m * nz * br * bc)


def skip_cases(torch, timer, gen, record):
    """Phase 3's ``bcr_spmm_skip`` cases (see the module docstring); timed
    rows go through ``record``."""
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    from repro_torch.kernels import ref

    def weight(n, k, block=128, skew=True):
        w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
        if skew:     # one lognormal (sigma 1) factor per block
            f = torch.exp(torch.randn((n // block, 1, k // block, 1),
                                      generator=gen, device="cuda"))
            w = (w.view(n // block, block, k // block, block) * f).view(n, k)
        return w

    def x_of(m, k, dtype=torch.bfloat16):
        return torch.randn((m, k), generator=gen, device="cuda").to(dtype)

    log("bcr_spmm_skip (bf16, block 128, unbalanced keep 0.25, lognormal "
        "block scales)")
    for wname, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192),
                        ("lm_head", 128256, 2048)):
        p, share, empty = skip_pack(torch, weight(n, k),
                                    dtype=torch.bfloat16)
        log(f"  {wname}: {p.tiles.shape[0]} tiles, surviving-tile share "
            f"{share:.4f}, empty block rows {empty} of {n // 128}")
        w_dense = ref.skip_unpack(p)
        for m in (8, 2048):
            x = x_of(m, k)
            got = SK.bcr_spmm_skip(x, p)
            want = ref.bcr_spmm_skip_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"skip {wname} {n}x{k} M={m}", got, want,
                              BF16_TOL)
            byts, ops = skip_bytes_ops(p, m)
            record("bcr_spmm_skip", f"{wname} {n}x{k} M={m}", err,
                   timer.ms(lambda: SK.bcr_spmm_skip(x, p)),
                   timer.ms(lambda: ref.bcr_spmm_skip_ref(x, p)),
                   byts, ops, torch.bfloat16,
                   timer.ms(lambda: _library_dense_matmul(x, w_dense)))
        del p, w_dense

    # a whole block row zeroed before projection, and the output landing in
    # a freed NaN-filled block: the empty rows must be exact zeros
    w = weight(2048, 2048)
    w[3 * 128:4 * 128] = 0.0
    p, _, empty = skip_pack(torch, w, dtype=torch.bfloat16)
    if int(p.row_start[3]) != int(p.row_start[4]):
        raise AssertionError("the zeroed block row kept a tile")
    x = x_of(8, 2048)
    poison = torch.full((8, 2048), float("nan"), dtype=torch.bfloat16,
                        device="cuda")
    del poison                  # the allocator hands this block back next
    got = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    rows_zero = got[:, 3 * 128:4 * 128]
    if not (bool(torch.isfinite(got).all())
            and int(torch.count_nonzero(rows_zero)) == 0):
        raise AssertionError("empty block row is not exact zeros over a "
                             "NaN-poisoned output buffer")
    check_close("skip zeroed block row over a NaN-poisoned buffer", got,
                ref.bcr_spmm_skip_ref(x, p), BF16_TOL)
    log(f"  empty block rows {empty}: exact zeros (NaN-poisoned buffer)")
    p, _, _ = skip_pack(torch, torch.zeros((2048, 2048), device="cuda"),
                        dtype=torch.bfloat16)
    if p.tiles.shape[0] != 1:
        raise AssertionError("a fully pruned W must pack one zero tile")
    got = SK.bcr_spmm_skip(x, p)
    torch.cuda.synchronize()
    if int(torch.count_nonzero(got)) != 0:
        raise AssertionError("fully pruned W gave a nonzero y")
    log("  fully pruned 2048x2048: one zero tile, y exact zeros")
    p, share, empty = skip_pack(torch, weight(256, 512, 32, skew=False),
                                block=32, keep=0.05)
    x = x_of(8, 512, torch.float32)
    check_close(f"skip fp32 256x512 block 32 keep 0.05 (share {share:.3f}, "
                f"empty block rows {empty})", SK.bcr_spmm_skip(x, p),
                ref.bcr_spmm_skip_ref(x, p), FP32_TOL)


def skip_split_checks(torch, gen) -> None:
    """The one-launch split over a block row's tiles at decode: wq (2048 x
    2048) and MLP wo (2048 x 8192) at M = 8, lognormal block scales, two
    block rows zeroed. The grid reaches the SM count; two launches give
    bit-equal y (the last split sums the partials in split order); the
    output and the workspace land in freed NaN-filled blocks and the empty
    rows are still exact zeros; the split counters are back at zero."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcr_spmm import split_counters
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n, k in (("wq", 2048, 2048), ("mlp_wo", 2048, 8192)):
        w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
        f = torch.exp(torch.randn((n // 128, 1, k // 128, 1), generator=gen,
                                  device="cuda"))
        w = (w.view(n // 128, 128, k // 128, 128) * f).view(n, k)
        w[:256] = 0.0
        p, share, empty = skip_pack(torch, w, dtype=torch.bfloat16)
        x = torch.randn((8, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        plan = SK.skip_plan(tuple(p.row_start.tolist()), 8, (128, 128), sms)
        if plan.grid < sms or not plan.parts:
            raise AssertionError(f"{name} at M=8: grid {plan.grid}, "
                                 f"{plan.parts} partials")
        poison = (torch.full((plan.workspace_floats,), float("nan"),
                             device="cuda"),
                  torch.full((8, n), float("nan"), dtype=torch.bfloat16,
                             device="cuda"))
        del poison               # the allocator hands these blocks back next
        first = SK.bcr_spmm_skip(x, p)
        second = SK.bcr_spmm_skip(x, p)
        torch.cuda.synchronize()
        form = (f"{name} {n}x{k} M=8 (share {share:.4f}, empty block rows "
                f"{empty}, {len(plan.units)} units of rows {plan.rows}, "
                f"grid {plan.grid})")
        if not bool(torch.isfinite(first).all()) or int(
                torch.count_nonzero(first[:, :256])):
            raise AssertionError(f"split {form}: empty rows are not exact "
                                 f"zeros over NaN-filled buffers")
        if not torch.equal(first, second):
            raise AssertionError(f"split {form}: two launches differ")
        check_close(f"skip split {form}, NaN-filled workspace and output",
                    first, ref.bcr_spmm_skip_ref(x, p), BF16_TOL)
        left = int(torch.count_nonzero(
            split_counters(x.device, plan.counters)[:plan.counters]))
        if left:
            raise AssertionError(f"split {form}: {left} counters not back "
                                 f"at zero")
        log(f"  skip split {name}: two launches bit-equal, counters back "
            f"at 0")


def _library_expert_bmm(torch, x, w_t):
    return torch.bmm(x, w_t)


def expert_packs(torch, gen, e, int8, dtype=None):
    """deepseek-moe-16b's expert projections for ``e`` experts, random
    weights from ``gen``, packed at block 128 / keep 0.25 in one batched
    pass: the down projection ``wo`` (E x 2048 x 1408) and the fused
    gate/up ``wgi`` (E x 2 x 1408 x 2048); ``dtype`` tiles (bf16 unless
    given), or int8 tiles with per-tile scales."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack
    from repro_torch.kernels.plan import (pack_group, quantize_grouped,
                                          quantize_packed)

    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)

    def pack(n, k):
        w = torch.randn((e, n, k), generator=gen, device="cuda") * k ** -0.5
        return tbcrc_pack(w, spec)

    wo = pack(2048, 1408)
    wgi = pack_group([pack(1408, 2048) for _ in range(2)])
    if int8:
        return quantize_packed(wo), quantize_grouped(wgi)
    for p in (wo, wgi):
        p.vals = p.vals.to(dtype or torch.bfloat16)
    return wo, wgi


def expert_cases(torch, timer, gen, record):
    """Phase 3's expert-batched ``bcr_spmm`` (``wo``) and
    ``bcr_spmm_grouped`` (``wgi`` with the SwiGLU epilogue) at
    deepseek-moe-16b's 64 experts: bf16 and int8 tiles under bf16 x at M =
    4 and 240 a expert, and fp32 tiles under fp32 x (the CUDA-core body
    that phase 12b serves) at its decode and 300-token prefill M = 4 and
    228. Each is one launch for all 64 (the counters say so), held to the
    plain version's loop over the experts and timed beside it and beside
    one ``torch.bmm`` over the dense pruned expert weights."""
    from repro_torch.core.bcrc import tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref

    def nbytes(p):
        scales = p.plan.block_scales
        return (p.vals.numel() * p.vals.element_size()
                + (p.row_idx.numel() + p.col_idx.numel()) * 4
                + (0 if scales is None else scales.numel() * 4))

    def one_launch(key, fn):
        before = dict(K.LAUNCHES)
        out = fn()
        moved = {k: v - before[k] for k, v in K.LAUNCHES.items()
                 if v != before[k]}
        if moved != {key[:-len("_experts")]: 1, key: 1}:
            raise AssertionError(f"{key}: launches {moved}, want one")
        return out

    e = EXPERTS
    bf16, fp32 = torch.bfloat16, torch.float32
    # (int8 tiles, tile and x dtype, M a expert, tolerance, shape prefix)
    for int8, dt, ms, tol, pre in (
            (False, bf16, EXPERT_MS, BF16_TOL, ""),
            (True, bf16, EXPERT_MS, BF16_TOL, ""),
            (False, fp32, EXPERT_FP32_MS, FP32_TOL, "fp32 ")):
        wo, wgi = expert_packs(torch, gen, e, int8, dt)
        tag = "_int8" if int8 else ""
        log(f"expert-batched bcr_spmm{tag} / bcr_spmm_grouped{tag} "
            f"({'int8' if int8 else str(dt)[6:]} tiles, {str(dt)[6:]} x, "
            f"{e} experts, block 128, keep 0.25)")
        w_wo = tbcrc_unpack(wo).to(dt).transpose(1, 2)
        w_gi = tbcrc_unpack(wgi).to(dt).reshape(
            e, 2 * 1408, 2048).transpose(1, 2)
        for m in ms:
            for key, w, w_t, k, n, shape in (
                    (f"bcr_spmm{tag}_experts", wo, w_wo, 1408, 2048,
                     f"{pre}experts wo 64x2048x1408 M={m}"),
                    (f"bcr_spmm_grouped{tag}_experts", wgi, w_gi, 2048,
                     1408, f"{pre}experts wgi 64x2x1408x2048 M={m}")):
                x = (torch.randn((e, m, k), generator=gen, device="cuda")
                     .to(dt))
                grouped = "grouped" in key
                if grouped:
                    def run():
                        return K.bcr_spmm_grouped(x, w, epilogue="swiglu")

                    def plain():
                        return ref.bcr_spmm_grouped_ref(x, w,
                                                        epilogue="swiglu")
                else:
                    def run():
                        return K.bcr_spmm(x, w)

                    def plain():
                        return ref.bcr_spmm_packed_ref(x, w)
                got = one_launch(key, run)
                want = plain()
                torch.cuda.synchronize()
                err = check_close(f"{key} {shape}", got, want, tol)
                g = 2 if grouped else 1
                nb_r, nb_c, r, c = w.vals.shape[-4:]
                elt = x.element_size()
                record(key, shape, err, timer.ms(run), timer.ms(plain),
                       nbytes(w) + e * m * (k + n) * elt,
                       2 * e * m * g * nb_r * nb_c * r * c, dt,
                       timer.ms(lambda: _library_expert_bmm(torch, x, w_t)))
        del wo, wgi, w_wo, w_gi


def expert_split_checks(torch, gen) -> None:
    """The one-launch split with experts on the grid: 4 experts of
    deepseek's ``wo`` and ``wgi`` (SwiGLU) at M = 4 split their contraction
    (64 experts fill the card unsplit: checked too), fp and int8 tiles,
    each held by :func:`check_split`."""
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for int8 in (False, True):
        wo, wgi = expert_packs(torch, gen, 4, int8)
        for name, w, n, k, g in (("wo", wo, 2048, 1408, 1),
                                 ("wgi", wgi, 1408, 2048, 2)):
            plan = K.launch_plan(4, n, k, g, (128, 128), (64, 64), sms, int8,
                                 experts=4)
            full = K.launch_plan(4, n, k, g, (128, 128), (64, 64), sms, int8,
                                 experts=EXPERTS)
            if plan.splits < 2 or full.splits != 1:
                raise AssertionError(f"experts {name}: splits {plan.splits} "
                                     f"at E=4, {full.splits} at E=64")
            x = (torch.randn((4, 4, k), generator=gen, device="cuda")
                 .to(torch.bfloat16))

            def run():
                if g == 2:
                    return K.bcr_spmm_grouped(x, w, epilogue="swiglu")
                return K.bcr_spmm(x, w)

            want = (ref.bcr_spmm_grouped_ref(x, w, epilogue="swiglu")
                    if g == 2 else ref.bcr_spmm_packed_ref(x, w))
            check_split(torch, f"{'int8 ' if int8 else ''}experts {name} "
                        f"4x{g}x{n}x{k} M=4 (E=64: grid {full.grid}, "
                        f"unsplit)", plan, run, want, (4, 4, n))
        del wo, wgi


def moe_attention_cases(torch, timer, gen, record):
    """deepseek-moe-16b's attention shape, new to the paged and flash
    kernels: 16 query heads over 16 KV heads (G = 1: one query row a KV
    head at decode) and head_dim 128, page 16. Paged decode over 8 slots of
    lengths 1..512 (one inactive) and prefill-append of 16 rows over a
    100-token prefix, bf16 and int8 pages; flash causal B*H = 8*16, S = 512.
    Each against its plain version, timed beside it and SDPA."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import dequantize_rows, quantize_rows

    h = hkv = 16
    d, ps = 128, 16

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def pages(tlens):
        per = [-(-int(t) // ps) for t in tlens]
        n_pages = 1 + sum(per) + 8
        kp, vp = (randn(n_pages, ps, hkv, d, dtype=torch.float32)
                  for _ in range(2))
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device="cuda").cpu() + 1
        bt = torch.zeros((len(tlens), max(per)), dtype=torch.int32)
        nxt = 0
        for i, npg in enumerate(per):
            bt[i, :npg] = perm[nxt:nxt + npg]
            nxt += npg
        return kp, vp, bt.cuda()

    def sdpa(q, kp, vp, bt, qpos):
        b, l = q.shape[0], bt.shape[1] * ps
        kk = kp[bt.long()].reshape(b, l, hkv, d)
        vv = vp[bt.long()].reshape(b, l, hkv, d)
        mask = (torch.arange(l, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        args = (q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                mask)
        return timer.ms(lambda: _library_sdpa(torch, *args))

    log("paged attention at deepseek-moe-16b's head shape (16/16 heads, "
        "head_dim 128, page 16), bf16 and int8 pages")
    lens = torch.tensor([1, 37, 128, 200, 333, 511, 512, 0],
                        dtype=torch.int32, device="cuda")
    live = lens > 0
    plen = torch.full((8,), 100, dtype=torch.int32, device="cuda")
    tlen = plen + 16
    qpos = plen[:, None] + torch.arange(16, device="cuda")[None]
    for int8 in (False, True):
        key = "paged_attention_int8" if int8 else "paged_attention"
        for what, tl in (("decode", lens), ("append", tlen)):
            kp, vp, bt = pages(tl.clamp(min=1).tolist())
            if int8:
                (kc, ks), (vc, vs) = quantize_rows(kp), quantize_rows(vp)
                kw = dict(k_scale=ks, v_scale=vs)
                kp, vp = kc, vc
                deq = (dequantize_rows(kc, ks, torch.bfloat16),
                       dequantize_rows(vc, vs, torch.bfloat16))
                elt, sc = 1, 4
            else:
                kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
                kw, deq, elt, sc = {}, (kp, vp), 2, 0
            if what == "decode":
                q = randn(8, 1, h, d)

                def run():
                    return PA.paged_decode_attention(q, kp, vp, bt, lens,
                                                     **kw)

                def plain():
                    return ref.paged_decode_attention_ref(q, kp, vp, bt,
                                                          lens, **kw)
                shape = "decode B=8 lens 1..512 16/16 heads hd128"
                ops, qp, rows = 4 * int(lens.sum()) * h * d, \
                    (lens - 1)[:, None], live
            else:
                q = randn(8, 16, h, d)

                def run():
                    return PA.paged_prefill_append_attention(
                        q, kp, vp, bt, plen, tlen, **kw)

                def plain():
                    return ref.paged_prefill_append_ref(q, kp, vp, bt, plen,
                                                        tlen, **kw)
                shape = "prefill-append B=8 S=16 prefix 100 16/16 heads hd128"
                ops, qp, rows = 4 * 8 * 16 * 108 * h * d, qpos, \
                    torch.ones(8, dtype=torch.bool, device="cuda")
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = check_close(f"{key} {shape}", got[rows], want[rows],
                              BF16_TOL)
            if what == "decode" and not (
                    bool(torch.isfinite(got).all())
                    and int(torch.count_nonzero(got[~live])) == 0):
                raise AssertionError("inactive slot output is not finite "
                                     "zeros")
            record(key, shape, err, timer.ms(run), timer.ms(plain),
                   PA.paged_kv_bytes(tl.cpu().numpy(), ps, hkv, d, elt, sc)
                   + 2 * q.numel() * 2 + bt.numel() * 4, ops,
                   torch.bfloat16, sdpa(q, *deq, bt, qp))

    log("flash_attention_fused at head_dim 128 (bf16, B*H = 8*16)")
    bh, sq = 8 * h, 512
    q, k, v = (randn(bh, sq, d) for _ in range(3))
    got = FA.flash_attention_fused(q, k, v, q_chunk=512, kv_chunk=1024)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    name = "causal BH=128 S=512 hd128"
    err = check_close(f"flash {name}", got, want, BF16_TOL)
    q4, k4, v4 = (t.reshape(8, h, sq, d) for t in (q, k, v))
    record("flash_attention_fused", name, err,
           timer.ms(lambda: FA.flash_attention_fused(q, k, v, q_chunk=512,
                                                     kv_chunk=1024)),
           timer.ms(lambda: ref.flash_attention_ref(q, k, v)),
           4 * bh * sq * d * 2, 4 * bh * (sq * (sq + 1) // 2) * d,
           torch.bfloat16,
           timer.ms(lambda: _library_sdpa(torch, q4, k4, v4, None,
                                          is_causal=True)))


def build_main_params(torch):
    """The full-width, full-depth llama3.2-1b of phases 4 and 5: one set of
    random weights (seed 0), packed at keep 0.25 / block 128 twice — bf16
    tiles, and int8 tiles quantized from the same fp32 packs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import packed_fraction, pack_params
    from repro_torch.models import causal_lm

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=16,
                              bcr_keep_frac=0.25, bcr_block=(128, 128))
    t0 = time.perf_counter()
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    params = pack_params(cfg, dense)
    params_q = pack_params(cfg, dense, weight_dtype="int8")
    fracs = (packed_fraction(dense, params), packed_fraction(dense, params_q))
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"init + pack (bf16 and int8) {time.perf_counter() - t0:.1f} s; "
        f"packed-weight fraction of the dense fp32 tree: bf16 "
        f"{fracs[0]:.4f}, int8 {fracs[1]:.4f}")
    return cfg, params, params_q, fracs


def main_traffic(np, vocab):
    """Phases 4, 5 and 10's traffic: 16 prompts of 32, 128 or 512 random
    tokens (seed 0); returns the generator too, for what follows."""
    rng = np.random.default_rng(0)
    plens = rng.choice([32, 128, 512], size=16)
    return rng, [rng.integers(0, vocab, size=int(n)) for n in plens]


def serve_main_path(torch, np, cfg, params, ec, label, frac):
    """Serve the phase's 16 requests with the launch counters zeroed just
    before and read just after, then a profiled decode window. Returns the
    stats, the launches, each request's (prompt, tokens) and the engine."""
    from repro_torch.serving import FINISHED, InferenceEngine

    engine = InferenceEngine(cfg, params, ec, device="cuda")
    cfg = engine.cfg                  # kv_dtype from the engine config
    rng, prompts = main_traffic(np, cfg.vocab_size)
    rids = [engine.submit(p, max_new_tokens=32) for p in prompts]

    zero_counters()
    done, decode_ms = [], []
    t0 = time.perf_counter()
    while engine.sched.has_work():
        prefills = engine.stats["prefills"]
        ts = time.perf_counter()
        done.extend(engine.step())       # ends in a device→host copy
        if engine.stats["prefills"] == prefills:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    log(f"{label} launches: {launches}")
    if len(done) != 16 or any(r.status != FINISHED or len(r.generated) != 32
                              for r in done):
        raise AssertionError(f"{label}: not every request FINISHED with 32 "
                             f"tokens")
    if engine.stats["failed"]:
        raise AssertionError(f"{label}: {engine.stats['failed']} requests "
                             f"FAILED on non-finite logits")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    by_rid = {r.rid: r for r in done}
    stats = dict(
        tokens_per_s=engine.stats["tokens_generated"] / wall,
        decode_step_ms_mean=statistics.mean(decode_ms),
        decode_step_ms_p50=statistics.median(decode_ms),
        decode_steps=engine.stats["decode_steps"],
        prefills=engine.stats["prefills"], ttft_ms_p50=statistics.median(ttft),
        wall_s=wall, packed_fraction=frac,
        kv_bytes_read_live=engine.stats["kv_bytes_read_live"],
        kv_row_bytes=engine._kv_row_bytes,
        packed_weight_bytes=_weight_bytes(params),
        step_bound_ms=_weight_bytes(params) / HBM_BYTES_PER_S * 1e3,
        ttft_ms_by_request=[(by_rid[rid].first_token_time
                             - by_rid[rid].submit_time) * 1e3
                            for rid in rids])
    log(f"{label}: " + json.dumps(stats))
    stats["decode_profile"] = profile_decode(torch, engine, rng, cfg)
    trajectories = [(prompts[i], r.generated) for i, r in
                    sorted(((rids.index(r.rid), r) for r in done),
                           key=lambda t: t[0])]
    return stats, launches, trajectories, engine


def append_vs_cold(torch, np, engine, label, stats):
    """One direct ``prefill_append`` on the engine's live pool: a 100-token
    prefix seated by a cold prefill, then a 16-token suffix through the
    pages, held to a cold prefill of all 116 tokens. Dense families only:
    a MoE layer routes the suffix under its own capacity, so its append
    and cold outputs differ by design."""
    from repro_torch.models import causal_lm

    cfg, params, pool = engine.cfg, engine.params, engine.pool
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 116)),
                           dtype=torch.int32, device="cuda")
    pool.reserve(0, 116)
    _, pc = causal_lm.prefill(cfg, params, toks[:, :100])
    pool.insert_rows(pc, np.asarray([0]), np.asarray([100]))
    pool.ensure(0, 116)
    bt = pool.device_tables(pool.max_pages)[:1].contiguous()
    zero_counters()
    got, _ = causal_lm.prefill_append(
        cfg, params, toks[:, 100:], pool.cache,
        torch.tensor([100], dtype=torch.int32, device="cuda"), bt)
    torch.cuda.synchronize()
    append_launches = {k: v for k, v in read_counters().items() if v}
    if not any(k.startswith("paged_attention") for k in append_launches):
        raise AssertionError("prefill_append did not reach paged attention")
    want, _ = causal_lm.prefill(cfg, params, toks)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    same_top = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    log(f"{label} prefill_append over a live pool: launches "
        f"{append_launches}, max |append - cold| {err:.3e} of {scale:.3g}, "
        f"argmax equal {same_top}")
    if not (bool(torch.isfinite(got).all()) and err <= 5e-2 * scale):
        raise AssertionError("prefill_append disagrees with a cold prefill")
    stats["append_vs_cold_max_abs"] = err
    pool.release(0)
    pool.check_consistency()


def phase_main_path(torch, np, cfg, params, frac):
    from repro_torch.serving import EngineConfig

    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0)
    stats, launches, traj, engine = serve_main_path(
        torch, np, cfg, params, ec, "bf16 main path", frac)
    append_vs_cold(torch, np, engine, "bf16 main path", stats)
    if not all(launches[k] > 0 for k in FP_KERNELS):
        raise AssertionError(f"a kernel of the bf16 main path never "
                             f"launched: {launches}")
    return stats, launches, traj


def phase_quantized_path(torch, np, cfg, params_q, frac):
    from repro_torch.serving import EngineConfig

    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0,
                      kv_dtype="int8", weight_dtype="int8")
    stats, launches, traj, engine = serve_main_path(
        torch, np, cfg, params_q, ec, "quantized main path", frac)
    append_vs_cold(torch, np, engine, "quantized main path", stats)
    if not all(launches[k] > 0 for k in INT8_KERNELS):
        raise AssertionError(f"an int8 kernel of the quantized path never "
                             f"launched: {launches}")
    if any(launches[k] for k in FP_KERNELS):
        raise AssertionError(f"the quantized path ran an fp-form kernel: "
                             f"{launches}")
    want = cfg.num_layers * stats["prefills"]
    if launches["flash_attention_fused"] != want:
        raise AssertionError(f"flash launches {launches['flash_attention_fused']}"
                             f" != {cfg.num_layers} per cold prefill x "
                             f"{stats['prefills']} prefills")
    log(f"flash_attention_fused: {launches['flash_attention_fused']} launches"
        f" = {cfg.num_layers} per cold prefill x {stats['prefills']}")
    return stats, launches, traj


def forced_flip_rate(torch, np, cfg, params, params_q, trajectories):
    """Teacher-forced flip rate of the quantized path against the bf16
    path: both replay the bf16 engine's trajectories (prompt + generated
    tokens) through the naive oracle, and at every generated position the
    two greedy picks are compared. Pinning the context to one trajectory
    keeps a single early flip from counting every later token."""
    from repro_torch.launch.serve import generate

    cfg_q = dataclasses.replace(cfg, attn_impl="pallas", kv_dtype="int8")
    flips = total = 0
    by_len = {}
    for prompt, gen in trajectories:
        by_len.setdefault(len(prompt), []).append((prompt, gen))
    for group in by_len.values():
        prompts = torch.as_tensor(np.stack([p for p, _ in group]))
        forced = torch.as_tensor(np.asarray([g for _, g in group],
                                            np.int32))
        picks = [generate(c, p, prompts, gen_tokens=forced.shape[1],
                          forced=forced)["tokens"]
                 for c, p in ((cfg, params), (cfg_q, params_q))]
        flips += int((picks[0] != picks[1]).sum())
        total += picks[0].numel()
    rate = flips / max(total, 1)
    log(f"teacher-forced flip rate, int8 path vs bf16 path (same weights, "
        f"bf16 trajectories): {flips}/{total} = {rate:.4f} (not gated)")
    return rate


# the recurrent mixers' functions (phase 14)
MIXER_FUNCTIONS = ("mamba_apply_step", "rwkv_tm_apply_step",
                   "rwkv_cm_apply_step", "_mamba_step", "_rwkv_step",
                   "mamba_apply_seq", "rwkv_tm_apply_seq")
# the port's functions whose host time the decode profile reports
HOST_FUNCTIONS = ("step", "decode_step", "layer_apply", "attention_apply",
                  "_qkv", "_paged_write", "quantize_rows", "swiglu_apply",
                  "moe_apply", "route",
                  "rmsnorm", "apply_rope", "bcr_spmm", "bcr_spmm_grouped",
                  "_paged_attention", "_sample") + MIXER_FUNCTIONS


def device_events(torch, prof):
    """``(name, count, ms)`` of each device-side kernel and copy event with
    time in a ``torch.profiler`` window: a CPU op's own entry repeats the
    device time of the kernels it launched, so only device events count."""
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            yield ev.key, ev.count, us / 1e3


def profile_window(torch, step, host_functions, steps=5):
    """Device time of ``steps`` calls of a warm ``step()`` under
    ``torch.profiler``: the sum of kernel time per step, by kernel family,
    against the wall time of the same number of unprofiled steps just
    before (the profiler slows the host) — the device's busy share. Then
    the host side under ``cProfile``: the cumulative time per step of the
    port's functions named in ``host_functions``; cProfile slows every
    Python call, so these rank where the host's time goes, they are not the
    unprofiled wall."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    pr.disable()
    host_fn_ms = dict.fromkeys(host_functions, 0.0)
    for (path, _, fn), (_, _, _, cum, _) in pstats.Stats(pr).stats.items():
        if "repro_torch" in path and fn in host_fn_ms:
            host_fn_ms[fn] += cum * 1e3 / steps
    by_name, kernels = {}, 0
    for name, count, ms in device_events(torch, prof):
        by_name[name] = by_name.get(name, 0.0) + ms / steps
        kernels += count
    # host side: the PyTorch ops of the step by self CPU time (the profiler
    # slows each op, so these rank the host's costs, they do not add up to
    # the unprofiled wall)
    host = sorted(((ev.self_cpu_time_total / 1e3 / steps, ev.count // steps,
                    ev.key[:60]) for ev in prof.key_averages()
                   if getattr(ev, "device_type", None)
                   == torch.autograd.DeviceType.CPU),
                  reverse=True)[:8]
    families = {}
    for name, ms in by_name.items():
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    device_ms = sum(families.values())
    return dict(step_wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if wall_ms else None,
                device_launches_per_step=kernels / steps,
                by_family_ms=families,
                top_other=sorted(((ms, n[:80]) for n, ms in by_name.items()
                                  if kernel_family(n) == "other"),
                                 reverse=True)[:5],
                host_fn_ms_cprofile=host_fn_ms,
                host_ops_per_step=sum(ev.count for ev in prof.key_averages()
                                      if getattr(ev, "device_type", None)
                                      == torch.autograd.DeviceType.CPU)
                // steps,
                top_host_ms=host)


def profile_decode(torch, engine, rng, cfg, steps=5):
    """:func:`profile_window` over steady engine steps, 8 live slots."""
    for n in (32, 128, 512, 128, 32, 512, 128, 32):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=3 * steps + 4)
    engine.step()                     # admission + first decode
    engine.step()
    out = profile_window(torch, engine.step, HOST_FUNCTIONS, steps)
    engine.run()
    log("decode profile (per step): " + json.dumps(out))
    return out


def kernel_family(name: str) -> str:
    """A profiler kernel name → its launch-counter key (or "other"); the
    int8 forms are the instantiations on int8 (``signed char``) tiles or
    pages, or the tensor-core BCR kernels' ``<true, ...>``."""
    int8 = ("_int8" if "signed char" in name or "_tc<true" in name
            else "")
    if "flash_attention" in name:
        return "flash_attention_fused"
    if "bcr_spmm_skip" in name:
        return "bcr_spmm_skip"
    if "bcr_spmm_grouped" in name:
        return "bcr_spmm_grouped" + int8
    if "bcr_spmm" in name:
        return "bcr_spmm" + int8
    if "paged_attention" in name:
        return "paged_attention" + int8
    return "other"


def _weight_bytes(params) -> int:
    """Bytes a decode step must stream: every projection and norm (the
    embedding table is read one row per token)."""
    from repro_torch.launch.serve import tree_bytes
    return tree_bytes({k: v for k, v in params.items() if k != "embed"})


def near_tie_check(torch, cfg, params, prompts, got, gen, tie, what):
    """Hold each engine token list in ``got`` to the naive ``generate``
    oracle's greedy tokens for its prompt under
    :func:`tie_check_against`'s near-tie rule. Returns the near-tie
    count."""
    from repro_torch.launch.serve import generate

    want = [generate(cfg, params, torch.as_tensor(p)[None], gen_tokens=gen,
                     page_size=16)["tokens"][0].tolist() for p in prompts]
    return tie_check_against(torch, cfg, params, prompts, got, want, tie,
                             what)[0]


def fp32_cfg(num_layers=2, **over):
    """llama3.2-1b at full width, fp32 activations, BCR keep 0.25 with
    128x128 blocks: the correctness configuration of phases 6 and 9b."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-1b"),
                               num_layers=num_layers, dtype="float32",
                               bcr_keep_frac=0.25, bcr_block=(128, 128),
                               **over)


def phase_engine_vs_naive(torch, np, quantized=False):
    """The engine's greedy tokens against the naive ``generate`` oracle on
    the same params, fp32 activations, full width, 2 layers. Quantized:
    int8 tiles, int8 KV and the flash cold prefill on both sides; a near-tie
    there is 1e-3 relative (one K/V code at a rounding boundary moves a
    logit by about that much), else 1e-4."""
    from repro_torch.launch.serve import build_params
    from repro_torch.serving import EngineConfig, InferenceEngine

    over = (dict(attn_impl="pallas", kv_dtype="int8") if quantized else {})
    cfg = fp32_cfg(**over)
    params = build_params(cfg, seed=1, device="cuda",
                          weight_dtype="int8" if quantized else "")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 77, 128, 300)]
    gen = 16
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=640, page_size=16, seed=0,
        kv_dtype=cfg.kv_dtype), device="cuda")
    got = engine.generate(prompts, max_new_tokens=gen)
    what = "int8 tiles + int8 KV + flash prefill" if quantized else "bf16 cfg"
    near_ties = near_tie_check(torch, cfg, params, prompts, got, gen,
                               1e-3 if quantized else 1e-4, what)
    log(f"engine vs naive generate ({what}, fp32, 2 layers, 4 requests): "
        f"tokens equal, near-ties {near_ties}")
    return near_ties


# -- phase 9: the prefix cache and the request lifecycle ---------------------

SYSTEM_LEN = 384                  # 24 full pages of 16
SUFFIX_LENS = (16, 32, 48, 64)


def prefix_traffic(np, vocab, seed=9):
    """Phase 9a's traffic: two system prompts of ``SYSTEM_LEN`` tokens, a
    seed request for each (the system prompt alone), and 16 requests of a
    system prompt in turn plus a unique suffix of 16..64 tokens."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, vocab, size=SYSTEM_LEN).astype(np.int32)
               for _ in range(2)]
    reqs = [np.concatenate([systems[i % 2], rng.integers(
        0, vocab, size=SUFFIX_LENS[i % 4]).astype(np.int32)])
        for i in range(16)]
    return systems, reqs


def profile_admission(torch, engine, prompts):
    """Device time of the step that admits ``prompts`` (one batched
    admission plus that step's decode) under ``torch.profiler``, by kernel
    family, and the paged kernel's prefill-append launches in it."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        engine.submit(p, max_new_tokens=4)
    torch.cuda.synchronize()
    zero_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    counts = read_counters()
    families = {}
    for name, _, ms in device_events(torch, prof):
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    engine.run()
    return dict(device_ms=sum(families.values()), by_family_ms=families,
                append_launches=counts["paged_attention_append"]
                + counts["paged_attention_int8_append"])


def serve_prefix_traffic(torch, np, cfg, params, ec, systems, reqs):
    """Seed requests first (their pages park on the LRU), then the 16
    requests in two waves of 8, each drained before the next, so a TTFT
    is an admission's latency, not queueing behind the first wave. Counters
    are zeroed after the seeds and read after the waves."""
    from repro_torch.serving import FINISHED, InferenceEngine

    engine = InferenceEngine(cfg, params, ec, device="cuda")
    for p in systems:
        engine.submit(p, max_new_tokens=8)
    engine.run()
    torch.cuda.synchronize()
    engine.reset_stats()
    zero_counters()
    done = []
    t0 = time.perf_counter()
    for wave in (reqs[:8], reqs[8:]):
        for p in wave:
            engine.submit(p, max_new_tokens=32)
        done += engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    if len(done) != 16 or any(r.status != FINISHED or len(r.generated) != 32
                              for r in done):
        raise AssertionError("phase 9a: not every request FINISHED with 32 "
                             "tokens")
    engine.check_conservation()
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    st = engine.stats
    stats = dict(ttft_ms_p50=statistics.median(ttft), wall_s=wall,
                 tokens_per_s=st["tokens_generated"] / wall,
                 prefills=st["prefills"],
                 **{k: st[k] for k in ("prefix_hit_tokens", "pages_shared",
                                       "cow_copies", "evictions",
                                       "pages_allocated")},
                 append_launches=launches["paged_attention_append"]
                 + launches["paged_attention_int8_append"])
    return engine, stats, launches


def phase_prefix_full_width(torch, np, cfg, params, quantized):
    """Phase 9a: the prefix cache at full width and depth. The shared run
    must hit exactly 16 x 384 tokens over 384 adopted pages, copy no page
    (every hit is page-aligned) and allocate fewer pages than the same
    traffic unshared; then one append admission and one cold admission of
    8 requests are profiled."""
    from repro_torch.serving import EngineConfig

    label = "int8 tiles + int8 KV + flash prefill" if quantized else "bf16"
    if quantized:
        cfg = dataclasses.replace(cfg, attn_impl="pallas")
    q = dict(kv_dtype="int8", weight_dtype="int8") if quantized else {}
    systems, reqs = prefix_traffic(np, cfg.vocab_size)
    runs = {}
    for shared in (True, False):
        ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0,
                          prefix_cache=shared, **q)
        runs[shared] = serve_prefix_traffic(torch, np, cfg, params, ec,
                                            systems, reqs)
    (hot, hs, hl), (cold, cs, _) = runs[True], runs[False]
    want = dict(prefix_hit_tokens=16 * SYSTEM_LEN,
                pages_shared=16 * SYSTEM_LEN // 16, cow_copies=0)
    got = {k: hs[k] for k in want}
    if got != want or hs["pages_allocated"] >= cs["pages_allocated"]:
        raise AssertionError(f"phase 9a {label}: {got} (want {want}), pages "
                             f"allocated {hs['pages_allocated']} shared vs "
                             f"{cs['pages_allocated']} unshared")
    key = "paged_attention_int8" if quantized else "paged_attention"
    if not hl[key + "_append"]:
        raise AssertionError(f"phase 9a {label}: the paged kernel's "
                             f"prefill-append form never launched: {hl}")
    rng = np.random.default_rng(11)
    probe = [np.concatenate([systems[i % 2], rng.integers(
        0, cfg.vocab_size, size=SUFFIX_LENS[i % 4]).astype(np.int32)])
        for i in range(8)]
    hs["append_admission"] = profile_admission(torch, hot, probe)
    cs["cold_admission"] = profile_admission(torch, cold, probe)
    hot.check_conservation()
    cold.check_conservation()
    log(f"phase 9a {label} shared: " + json.dumps(hs))
    log(f"phase 9a {label} unshared: " + json.dumps(cs))
    log(f"phase 9a {label}: prefix_hit_tokens {hs['prefix_hit_tokens']}, "
        f"pages_shared {hs['pages_shared']}, cow_copies {hs['cow_copies']}, "
        f"pages_allocated {hs['pages_allocated']} shared vs "
        f"{cs['pages_allocated']} unshared; TTFT p50 "
        f"{hs['ttft_ms_p50']:.2f} ms hit vs {cs['ttft_ms_p50']:.2f} ms cold; "
        f"admission device {hs['append_admission']['device_ms']:.3f} ms "
        f"append vs {cs['cold_admission']['device_ms']:.3f} ms cold; "
        f"prefill-append launches {hl[key + '_append']}")
    return hs, hl[key + "_append"]


def phase_prefix_correctness(torch, np, kv_dtype):
    """Phase 9b's token checks, fp32, full width, 2 layers: shared =
    unshared = naive on the shared-prefix traffic, the full-prompt hit
    (a strict prefix of a cached prompt: L-1 tokens hit through the partial
    tail, so a page is copied) and staggered sharing while the owner
    decodes, all under phase 6's near-tie rule."""
    from repro_torch.launch.serve import build_params
    from repro_torch.serving import EngineConfig, InferenceEngine

    cfg = fp32_cfg(kv_dtype=kv_dtype)
    params = build_params(cfg, seed=1, device="cuda")
    tie = 1e-3 if kv_dtype else 1e-4
    gen = 16
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab_size, size=41).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(
        0, cfg.vocab_size, size=n).astype(np.int32)]) for n in (5, 9, 2, 7)]

    def engine(shared, **kw):
        return InferenceEngine(cfg, params, EngineConfig(
            n_slots=2, capacity=640, page_size=16, seed=0,
            prefix_cache=shared, kv_dtype=kv_dtype, **kw), device="cuda")

    label = f"phase 9b {kv_dtype or 'fp32'} KV"
    cold, hot = engine(False), engine(True)
    got_cold = cold.generate(prompts, max_new_tokens=gen)
    got_hot = hot.generate(prompts, max_new_tokens=gen)
    ties = near_tie_check(torch, cfg, params, prompts, got_cold, gen, tie,
                          label + " unshared")
    ties += near_tie_check(torch, cfg, params, prompts, got_hot, gen, tie,
                           label + " shared")
    if not (hot.stats["prefix_hit_tokens"] > 0
            and hot.stats["pages_allocated"]
            < cold.stats["pages_allocated"]):
        raise AssertionError(f"{label}: no sharing: {hot.stats}")
    hot.check_conservation()

    long = rng.integers(0, cfg.vocab_size, size=48).astype(np.int32)
    short = long[:40]
    eng = engine(True)
    [got_long] = eng.generate([long], max_new_tokens=gen)
    rid = eng.submit(short, max_new_tokens=gen)
    eng.step()
    eng.pool.check_consistency()      # the copied page carries its scales
    got_short = {r.rid: r for r in eng.run()}[rid].generated
    ties += near_tie_check(torch, cfg, params, [long, short],
                           [got_long, got_short], gen, tie,
                           label + " full-prompt hit")
    copies = eng.stats["cow_copies"]
    if eng.stats["prefix_hit_tokens"] != 39 or copies < 1:
        raise AssertionError(f"{label} full-prompt hit: "
                             f"{eng.stats['prefix_hit_tokens']} hit tokens, "
                             f"{copies} copies")
    eng.check_conservation()

    eng = engine(True)
    ra = eng.submit(prompts[0], max_new_tokens=gen)
    eng.step()
    eng.step()
    rb = eng.submit(prompts[1], max_new_tokens=gen)
    done = {r.rid: r for r in eng.run()}
    ties += near_tie_check(torch, cfg, params, prompts[:2],
                           [done[ra].generated, done[rb].generated], gen,
                           tie, label + " staggered")
    if not eng.stats["prefix_hit_tokens"]:
        raise AssertionError(f"{label} staggered: no hit")
    eng.check_conservation()
    log(f"{label}: shared = unshared = naive (traffic, full-prompt hit "
        f"with {copies} page copied, staggered), near-ties {ties}")
    return ties


def phase_lifecycle(torch, np):
    """Phase 9b's lifecycle checks, fp32, full width, 2 layers, prefix cache
    on: preemption under an oversubscribed pool and ``recover()`` mid-run
    give the naive tokens; a seeded chaos run over 32 requests fails
    exactly its NaN victims and leaks nothing."""
    from collections import Counter

    from repro_torch.launch.serve import build_params
    from repro_torch.serving import (FAILED, FINISHED, EngineConfig,
                                     FakeClock, FaultInjector,
                                     InferenceEngine)

    cfg = fp32_cfg()
    params = build_params(cfg, seed=1, device="cuda")
    gen = 16
    rng = np.random.default_rng(7)
    pa, pb, pc = (rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                  for n in (32, 48, 32))

    def engine(**kw):
        return InferenceEngine(cfg, params, EngineConfig(
            n_slots=3, capacity=640, page_size=16, seed=0, prefix_cache=True,
            **kw), device="cuda")

    # A (3 pages) and B (4) fill 7 pages; C (3) stalls and B is evicted
    eng = engine(kv_pages=8, preempt_after_stalls=1)
    a = eng.submit(pa, max_new_tokens=gen)
    b = eng.submit(pb, max_new_tokens=gen)
    for _ in range(3):
        eng.step()
    c = eng.submit(pc, max_new_tokens=gen)
    d = eng.submit(pa.copy(), max_new_tokens=gen)
    done = {r.rid: r for r in eng.run()}
    if eng.stats["preemptions"] < 1 or any(
            done[r].status != FINISHED for r in (a, b, c, d)):
        raise AssertionError(f"phase 9b preemption: {eng.stats}")
    eng.check_conservation()
    ties = near_tie_check(torch, cfg, params, [pa, pb, pc, pa],
                          [done[r].generated for r in (a, b, c, d)], gen,
                          1e-4, "phase 9b preemption")
    preemptions = eng.stats["preemptions"]

    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 17, 64, 23)]
    eng = engine()
    rids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    for _ in range(4):
        eng.step()
    survivors = eng.recover()
    done = {r.rid: r for r in eng.run()}
    eng.check_conservation()
    ties += near_tie_check(torch, cfg, params, prompts,
                           [done[r].generated for r in rids], gen, 1e-4,
                           "phase 9b recover")

    clk = FakeClock()
    faults = FaultInjector(seed=13, sleep=clk.sleep).random_schedule(
        300, {"page_alloc": 0.06, "nan_logits": 0.02, "cancel": 0.03,
              "slow_step": 0.02}, slow_s=0.3)
    eng = InferenceEngine(cfg, params, EngineConfig(
        n_slots=4, capacity=640, page_size=16, seed=0, prefix_cache=True,
        fault_injector=faults, preempt_after_stalls=2, max_waiting=8),
        device="cuda", clock=clk)
    chaos = [np.concatenate([prompts[i % 2], rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(4, 40))).astype(np.int32)])
        for i in range(32)]
    rids, submitted = [], 0
    for step in range(300):
        if step % 3 == 0 and submitted < len(chaos):
            rids.append(eng.submit(chaos[submitted], max_new_tokens=8,
                                   deadline_s=2.0 if submitted % 4 == 0
                                   else 0.0))
            submitted += 1
        if eng.sched.has_work():
            eng.step()
        clk.advance(0.01)
    for _ in range(500):
        if not eng.sched.has_work():
            break
        eng.step()
        clk.advance(0.01)
    finished = eng.sched.finished
    statuses = Counter(r.status for r in finished)
    nan_fired = sum(k == "nan_logits" for _, k, _ in faults.fired)
    if (eng.sched.has_work()
            or Counter(r.rid for r in finished) != Counter(rids)
            or statuses[FAILED] != nan_fired or not nan_fired
            or any(r.error != "non-finite logits at decode"
                   for r in finished if r.status == FAILED)):
        raise AssertionError(f"phase 9b chaos: {dict(statuses)}, NaN "
                             f"injected {nan_fired}, fired {faults.fired}")
    eng.check_conservation()
    log(f"phase 9b lifecycle: preemption ({preemptions} preempted) and "
        f"recover() ({survivors} requeued) give the naive tokens, near-ties "
        f"{ties}; chaos over 32 requests: {dict(statuses)}, NaN injected "
        f"{nan_fired}, {len(faults.fired)} faults fired, 0 leaked pages")

# -- phase 10: speculative decoding, the capacity-dense pool, SLO admission --

# a near-tie between two bf16 logits: within two bf16 steps of the top
# (a step is 2^-8..2^-7 of the value, so two are at most 2^-6 relative):
# the engine's and the oracle's logits are each rounded to bf16 once. On
# the card (NVIDIA H100 80GB HBM3, 700.00 W) phase 10b's largest gap is
# two steps (1.19e-2: logits 2.59375 vs 2.625)
BF16_TIE = 2.0 ** -6


def serve_run(torch, cfg, params, ec, prompts, drafter=None,
              draft_params=None, continuations=None):
    """Serve ``prompts`` (32 greedy tokens each) on a fresh engine with the
    launch counters zeroed just before and read just after. Returns the
    tokens (submission order), the run's numbers and the counters."""
    from repro_torch.serving import FINISHED, InferenceEngine

    engine = InferenceEngine(cfg, params, ec, device="cuda",
                             drafter=drafter, draft_params=draft_params)
    rids = [engine.submit(p, max_new_tokens=32) for p in prompts]
    if continuations is not None:
        drafter.continuations.update(dict(zip(rids, continuations)))
    zero_counters()
    done, step_ms = [], []
    t0 = time.perf_counter()
    while engine.sched.has_work():
        prefills = engine.stats["prefills"]
        ts = time.perf_counter()
        done.extend(engine.step())       # ends in a device→host copy
        if engine.stats["prefills"] == prefills:
            step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    by_rid = {r.rid: r for r in done}
    if sorted(by_rid) != sorted(rids) or any(
            r.status != FINISHED or len(r.generated) != 32 for r in done):
        raise AssertionError("not every request FINISHED with 32 tokens")
    engine.check_conservation()
    st = engine.stats
    stats = dict(tokens_per_s=st["tokens_generated"] / wall, wall_s=wall,
                 decode_steps=st["decode_steps"], prefills=st["prefills"],
                 step_ms_p50=statistics.median(step_ms),
                 spec_steps=st["spec_steps"],
                 draft_proposed=st["draft_proposed"],
                 draft_accepted=st["draft_accepted"],
                 acceptance=(st["draft_accepted"] / st["draft_proposed"]
                             if st["draft_proposed"] else None),
                 accepted_hist=st["accepted_hist"],
                 drafter_failures=st["drafter_failures"],
                 kv_bytes_read=st["kv_bytes_read"])
    return [by_rid[r].generated for r in rids], stats, launches


def profile_steps(torch, cfg, params, ec, prompts, drafter=None,
                  draft_params=None, continuations=None, steps=3):
    """Device time of steady steps by kernel family under
    ``torch.profiler`` (8 live slots, after the admission step and one
    more), beside the wall of as many unprofiled steps just before."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import InferenceEngine

    engine = InferenceEngine(cfg, params, ec, device="cuda",
                             drafter=drafter, draft_params=draft_params)
    rids = [engine.submit(p, max_new_tokens=32) for p in prompts]
    if continuations is not None:
        drafter.continuations.update(dict(zip(rids, continuations)))
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    prefills = engine.stats["prefills"]
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    if engine.stats["prefills"] != prefills:
        raise AssertionError("an admission fell inside the profiled steps")
    families = {}
    for name, _, ms in device_events(torch, prof):
        fam = kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms / steps
    device_ms = sum(families.values())
    return dict(step_wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, by_family_ms=families)


def tie_check_against(torch, cfg, params, prompts, got, want, tie, what):
    """Hold each token list in ``got`` to ``want`` (the oracle's or the
    plain engine's): equal, except at near-ties. From the first
    difference on, each token of ``got`` must lie within ``tie``
    (relative) of the top logit of naive ``generate`` teacher-forced on
    ``got`` itself (up to that difference the same history as ``want``),
    so a tie ends no request's comparison. Returns (near-ties: tokens
    short of the top, largest relative gap, tokens held past a first
    difference)."""
    from repro_torch.launch.serve import generate

    near, held, gaps = 0, 0, []
    for p, g, w in zip(prompts, got, want):
        if g == w:
            continue
        if len(g) != len(w):
            raise AssertionError(f"{what}: {len(g)} tokens, plain {len(w)}")
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        logits = generate(cfg, params, torch.as_tensor(p)[None],
                          gen_tokens=len(g),
                          forced=torch.as_tensor([g]))["logits"][0]
        for j in range(i, len(g)):
            top = float(logits[j].max())
            pick = float(logits[j, g[j]])
            rel = (top - pick) / max(abs(top), 1e-30)
            if rel >= tie:
                raise AssertionError(
                    f"{what}: token {g[j]} at step {j} (plain {w[j]}, first "
                    f"difference at {i}): logit {pick} vs top {top}, "
                    f"relative gap {rel:.3e} >= {tie}")
            near += rel > 0
            gaps.append(rel)
        held += len(g) - i - 1
    return near, max(gaps, default=0.0), held


def check_drafts(st, spec_k, what, model):
    """The drafter really proposed: no contained failure (a failed
    ``propose`` degrades a round to a plain decode step and is only
    counted) and, for a model drafter, ``spec_k`` proposals a slot and
    round, one fewer where it first catches up on a bonus token."""
    rounds = sum(st["accepted_hist"])
    lo = (spec_k - 1) * rounds if model else 1
    if st["drafter_failures"] or not (
            lo <= st["draft_proposed"] <= spec_k * rounds):
        raise AssertionError(
            f"{what}: {st['drafter_failures']} drafter failures, "
            f"{st['draft_proposed']} drafts over {rounds} slot rounds "
            f"(want {lo}..{spec_k * rounds})")


def phase_speculative(torch, np, cfg, params, draft, quantized):
    """Phase 10a at full width and depth: phase 4's traffic through the
    plain engine, through ``spec_k`` = 3 with an ``OracleDraft`` fed the
    plain run's tokens, and with ``build_draft``'s packed 2-layer drafter;
    bf16, or int8 tiles + int8 KV + flash prefill (the drafter keeps bf16
    tiles and a bf16 cache, and inherits the flash prefill)."""
    from repro_torch.serving import EngineConfig, OracleDraft

    label = ("phase 10a int8 tiles + int8 KV + flash prefill" if quantized
             else "phase 10a bf16")
    dcfg, dparams = draft
    q = {}
    if quantized:
        cfg = dataclasses.replace(cfg, attn_impl="pallas")
        dcfg = dataclasses.replace(dcfg, attn_impl="pallas")
        q = dict(kv_dtype="int8", weight_dtype="int8")
    base = dict(n_slots=8, capacity=640, page_size=16, seed=0, **q)
    _, prompts = main_traffic(np, cfg.vocab_size)
    plain_cfg = EngineConfig(**base)
    oracle_cfg = EngineConfig(spec_k=SPEC_K, **base)
    model_cfg = EngineConfig(spec_k=SPEC_K, draft_cfg=dcfg, **base)
    # the plain trajectory's logits for the near-tie rule come from the
    # naive oracle on the engine's own configuration (int8 KV included)
    tcfg = dataclasses.replace(cfg, kv_dtype="int8") if quantized else cfg
    want, plain, _ = serve_run(torch, cfg, params, plain_cfg, prompts)
    got_o, oracle, o_l = serve_run(torch, cfg, params, oracle_cfg, prompts,
                                   drafter=OracleDraft(),
                                   continuations=want)
    got_m, model, m_l = serve_run(torch, cfg, params, model_cfg, prompts,
                                  draft_params=dparams)
    ties_o = tie_check_against(torch, tcfg, params, prompts, got_o, want,
                               BF16_TIE, label + " oracle")
    ties_m = tie_check_against(torch, tcfg, params, prompts, got_m, want,
                               BF16_TIE, label + " model drafter")
    check_drafts(oracle, SPEC_K, label + " oracle", model=False)
    check_drafts(model, SPEC_K, label + " model drafter", model=True)
    # where its tokens equal plain, the oracle's every proposal was the
    # target's own pick (a rejected one would have moved a token)
    if got_o == want and oracle["draft_accepted"] != oracle["draft_proposed"]:
        raise AssertionError(f"{label}: oracle acceptance {oracle}")
    if oracle["decode_steps"] >= plain["decode_steps"]:
        raise AssertionError(f"{label}: the oracle took "
                             f"{oracle['decode_steps']} decode steps, plain "
                             f"{plain['decode_steps']}")
    key = "paged_attention_int8" if quantized else "paged_attention"
    for name, st, l in (("oracle", oracle, o_l), ("model", model, m_l)):
        append = l[key + "_append"]
        if append != cfg.num_layers * st["spec_steps"] or l[key] != append:
            raise AssertionError(
                f"{label} {name}: {append} append-form launches for "
                f"{st['spec_steps']} verify steps x {cfg.num_layers} layers, "
                f"{l[key] - append} decode-form launches")
    path = (INT8_KERNELS + ("flash_attention_fused",) if quantized
            else FP_KERNELS)
    if not all(m_l[k] > 0 for k in path):
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {m_l}")
    profiles = {
        "plain": profile_steps(torch, cfg, params, plain_cfg, prompts),
        "oracle": profile_steps(torch, cfg, params, oracle_cfg, prompts,
                                drafter=OracleDraft(), continuations=want),
        "model": profile_steps(torch, cfg, params, model_cfg, prompts,
                               draft_params=dparams)}
    out = dict(plain=plain, oracle=oracle, model=model,
               near_ties=dict(oracle=ties_o, model=ties_m),
               step_profile=profiles)
    log(f"{label}: " + json.dumps(out))
    for name, st in (("plain", plain), ("oracle", oracle), ("model", model)):
        log(f"{label} {name}: {st['tokens_per_s']:.1f} tokens/s, "
            f"{st['decode_steps']} decode steps, step wall p50 "
            f"{st['step_ms_p50']:.2f} ms, acceptance {st['acceptance']}; "
            f"profiled step: device {profiles[name]['device_ms']:.3f} ms "
            f"of {profiles[name]['step_wall_ms']:.2f} ms wall")
    log(f"{label}: tokens equal plain, near-ties oracle {ties_o[0]}, model "
        f"{ties_m[0]} (tie {BF16_TIE}; tokens held past a first difference "
        f"{ties_o[2]} / {ties_m[2]}); drafter failures 0, model drafts "
        f"{model['draft_proposed']}; append-form launches "
        f"{m_l[key + '_append']} = {cfg.num_layers} x "
        f"{model['spec_steps']} verify steps, decode form 0")
    return out, m_l


def phase_speculative_fp32(torch, np):
    """Phase 10a's exactness check: fp32, full width, 2 layers (phase 6's
    configuration), 4 requests, the packed ``build_draft`` drafter and the
    oracle against the naive ``generate`` oracle under phase 6's 1e-4
    near-tie rule; the oracle's acceptance 1.0 when no tie moved a
    token."""
    from repro_torch.launch.serve import build_draft, build_params
    from repro_torch.serving import EngineConfig, InferenceEngine, OracleDraft

    cfg = fp32_cfg()
    params = build_params(cfg, seed=1, device="cuda")
    dcfg, dparams = build_draft(cfg, bcr_keep=0.25, device="cuda",
                                log=lambda *_: None)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 77, 128, 300)]
    gen = 16
    ec = dict(n_slots=2, capacity=640, page_size=16, seed=0, spec_k=SPEC_K)
    eng = InferenceEngine(cfg, params, EngineConfig(draft_cfg=dcfg, **ec),
                          device="cuda", draft_params=dparams)
    got = eng.generate(prompts, max_new_tokens=gen)
    ties = near_tie_check(torch, cfg, params, prompts, got, gen, 1e-4,
                          "phase 10a fp32 model drafter")
    check_drafts(eng.stats, SPEC_K, "phase 10a fp32 model drafter",
                 model=True)
    eng.check_conservation()
    plain = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=640, page_size=16, seed=0), device="cuda")
    want = plain.generate(prompts, max_new_tokens=gen)
    oracle = OracleDraft()
    eng = InferenceEngine(cfg, params, EngineConfig(**ec), device="cuda",
                          drafter=oracle)
    rids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    oracle.continuations.update(dict(zip(rids, want)))
    done = {r.rid: r for r in eng.run()}
    got_o = [done[r].generated for r in rids]
    ties += near_tie_check(torch, cfg, params, prompts, got_o, gen, 1e-4,
                           "phase 10a fp32 oracle")
    st = eng.stats
    check_drafts(st, SPEC_K, "phase 10a fp32 oracle", model=False)
    if got_o == want and st["draft_accepted"] != st["draft_proposed"]:
        raise AssertionError(f"phase 10a fp32: oracle acceptance {st}")
    eng.check_conservation()
    log(f"phase 10a fp32 (2 layers, 4 requests): model drafter and oracle "
        f"= naive, near-ties {ties}; oracle acceptance "
        f"{st['draft_accepted']}/{st['draft_proposed']}, "
        f"{st['decode_steps']} decode steps vs {plain.stats['decode_steps']}")


def phase_unpaged(torch, np, cfg, params, traj):
    """Phase 10b: phase 4's traffic through the capacity-dense pool
    (``page_size=0``), bf16, full width and depth; tokens equal phase 4's
    paged engine under the near-tie rule. Decode attention is the plain
    ``decode_attention`` (the reference computes it outside Pallas), so
    the paged kernel must not launch."""
    from repro_torch.serving import EngineConfig

    _, prompts = main_traffic(np, cfg.vocab_size)
    ec = EngineConfig(n_slots=8, capacity=640, page_size=0, seed=0)
    got, stats, launches = serve_run(torch, cfg, params, ec, prompts)
    want = [g for _, g in traj]
    ties = tie_check_against(torch, cfg, params, prompts, got, want,
                             BF16_TIE, "phase 10b")
    if launches["paged_attention"] or not (launches["bcr_spmm"]
                                           and launches["bcr_spmm_grouped"]):
        raise AssertionError(f"phase 10b launches {launches}")
    stats["step_profile"] = profile_steps(torch, cfg, params, ec, prompts)
    stats["near_ties"] = ties
    log("phase 10b capacity-dense pool (decode attention: plain torch "
        "decode_attention, as the reference runs it outside Pallas): "
        + json.dumps(stats))
    log(f"phase 10b: tokens equal phase 4's, near-ties {ties[0]}, largest "
        f"relative gap {ties[1]:.4g} (tie {BF16_TIE}), tokens held past a "
        f"first difference {ties[2]}")
    return stats


def admission_scenarios(np, engine, clock, vocab, paged):
    """Phase 10c's replay of the reference's engine scenarios
    (``tests/test_admission.py``). Each returns ``(engine, rids)``."""
    from repro_torch.serving import TenantQuota

    def prompt(n=8, seed=0):
        return np.random.default_rng(seed).integers(0, vocab, size=n)

    def concurrent():
        eng = engine(tenant_quotas={"acme": TenantQuota(max_concurrent=2)},
                     slo_step_time=0.1)
        return eng, [eng.submit(prompt(), max_new_tokens=4, tenant="acme")
                     for _ in range(3)]

    def rate():
        eng = engine(tenant_quotas={"acme": TenantQuota(rate=1.0, burst=1)})
        rids = [eng.submit(prompt(), max_new_tokens=2, tenant="acme")
                for _ in range(2)]
        clock.advance(1.0)
        rids.append(eng.submit(prompt(), max_new_tokens=2, tenant="acme"))
        return eng, rids

    def pages():
        # 24 + 8 tokens = 2 pages of 16 a request: the third exceeds 4
        eng = engine(tenant_quotas={"acme": TenantQuota(max_pages=4)},
                     slo_step_time=0.2)
        return eng, [eng.submit(prompt(24, i), max_new_tokens=8,
                                tenant="acme") for i in range(3)]

    def doomed():
        eng = engine(slo_admission=True, slo_step_time=1.0)
        return eng, [eng.submit(prompt(), max_new_tokens=4, deadline_s=2.0),
                     eng.submit(prompt(seed=1), max_new_tokens=4,
                                deadline_s=30.0)]

    def victim():
        eng = engine(slo_step_time=0.1, tenant_quotas={
            "aggressor": TenantQuota(rate=4.0, burst=2, max_concurrent=2),
            "victim": TenantQuota(max_concurrent=4)})
        rids = []
        for i in range(12):
            rids.append(eng.submit(prompt(seed=i), max_new_tokens=6,
                                   tenant="aggressor"))
            if i % 3 == 0:
                rids.append(eng.submit(prompt(seed=50 + i),
                                       max_new_tokens=6, tenant="victim"))
            eng.step()
            clock.advance(0.1)
        return eng, rids

    return dict(concurrent=concurrent, rate=rate, pages=pages,
                doomed=doomed, victim=victim)


def phase_admission(torch, np):
    """Phase 10c: SLO admission and tenancy at phase 9b's configuration
    (fp32, full width, 2 layers) on an injected clock with a pinned step
    time, on a paged pool and on ``page_size=0``: a doomed deadline is
    rejected at submit with a computed ``retry_after_s``; a victim tenant
    keeps goodput 1.0 under an aggressor; the concurrent, rate and page
    quotas reject with a computed ``retry_after_s`` (the page quota binds
    on the paged pool only, as in the reference); every request reaches
    exactly one terminal status; nothing leaks."""
    from repro_torch.launch.serve import build_params
    from repro_torch.serving import (EngineConfig, FakeClock,
                                     InferenceEngine)

    cfg = fp32_cfg()
    params = build_params(cfg, seed=1, device="cuda")
    summary = {}
    for page_size in (16, 0):
        clock = FakeClock()

        def engine(**kw):
            return InferenceEngine(cfg, params, EngineConfig(
                n_slots=2, capacity=640, page_size=page_size, seed=0, **kw),
                device="cuda", clock=clock)

        for name, scenario in admission_scenarios(
                np, engine, clock, cfg.vocab_size, page_size > 0).items():
            eng, rids = scenario()
            at_submit = {r.rid for r in eng.sched.finished
                         if r.status == "REJECTED"}
            while eng.sched.has_work():
                eng.step()
                clock.advance(0.01)
            eng.check_conservation()
            fin = {}
            for r in eng.sched.finished:
                if r.rid in fin:
                    raise AssertionError(f"phase 10c {name}: rid {r.rid} "
                                         f"reached two terminal states")
                fin[r.rid] = r
            if set(fin) != set(rids):
                raise AssertionError(f"phase 10c {name}: a request never "
                                     f"reached a terminal state")
            statuses = [fin[r].status for r in rids]
            rej = [fin[r] for r in rids if fin[r].status == "REJECTED"]
            if {r.rid for r in rej} != at_submit or any(
                    r.retry_after_s <= 0 for r in rej):
                raise AssertionError(f"phase 10c {name}: rejections "
                                     f"{[(r.error, r.retry_after_s) for r in rej]}")
            tenants = eng.stats["tenants"]
            want = dict(
                concurrent=["FINISHED", "FINISHED", "REJECTED"],
                rate=["FINISHED", "REJECTED", "FINISHED"],
                pages=(["FINISHED", "FINISHED", "REJECTED"] if page_size
                       else ["FINISHED"] * 3),
                doomed=["REJECTED", "FINISHED"]).get(name)
            if want is not None and statuses != want:
                raise AssertionError(f"phase 10c {name}: {statuses}")
            if name == "doomed" and not (
                    "slo" in rej[0].error and eng.stats["slo_rejected"] == 1
                    and eng.stats["wasted_prefill_tokens"] == 0):
                raise AssertionError(f"phase 10c doomed: {rej[0].error}")
            if name == "victim" and not (
                    tenants["victim"]["finished"] == 4
                    and tenants["victim"]["goodput_tokens"] == 24
                    and tenants["aggressor"]["rejected"] > 0):
                raise AssertionError(f"phase 10c victim: {tenants}")
            summary[f"{name} page_size={page_size}"] = dict(
                statuses=dict((s, statuses.count(s)) for s in set(statuses)),
                retry_after_s=[round(r.retry_after_s, 4) for r in rej])
    log("phase 10c SLO admission and tenancy (fp32, 2 layers, fake clock): "
        + json.dumps(summary))
    return summary



# -- phase 11: the serving entry points on the card ----------------------------

WARMUP_LENS = (32, 128, 512)
HOST = "127.0.0.1"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def wait_for(fn, timeout, interval=0.01):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        got = fn()
        if got:
            return got
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout} s waiting for {fn}")


def readyz(port):
    from repro_torch.serving import http_request
    try:
        return http_request(HOST, port, "GET", "/readyz", timeout=2)[0]
    except OSError:
        return None


class StepRecorder:
    """Wraps ``engine.step`` on the engine thread: each step's start, end
    and whether it admitted (a prefill ran); steps ``profile`` (start,
    count) run under ``torch.profiler`` on that thread, for the device time
    of a window of steady steps."""

    def __init__(self, torch, engine, profile):
        self.torch, self.engine, self.inner = torch, engine, engine.step
        self.rows, self.profile, self.prof = [], profile, None
        engine.step = self

    def __call__(self):
        from torch.profiler import ProfilerActivity, profile
        n = len(self.rows)
        if n == self.profile[0]:
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        prefills = self.engine.stats["prefills"]
        t0 = time.perf_counter()
        out = self.inner()
        self.rows.append((t0, time.perf_counter(),
                          self.engine.stats["prefills"] != prefills))
        if n == sum(self.profile) - 1:
            self.torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
        return out

    def detach(self):
        self.engine.step = self.inner

    def busy(self):
        """Device ms a step over the profiled window, against the mean
        start-to-start wall of as many unprofiled steps just before it (the
        profiler slows the host)."""
        start, count = self.profile
        by_family = {}
        for name, _, ms in device_events(self.torch, self.prof):
            fam = kernel_family(name)
            by_family[fam] = by_family.get(fam, 0.0) + ms / count
        starts = [r[0] for r in self.rows[start - count:start + 1]]
        wall = (starts[-1] - starts[0]) * 1e3 / count
        window = self.rows[start - count:start + count]
        device = sum(by_family.values())
        return dict(step_wall_ms=wall, device_ms=device,
                    busy_share=device / wall, by_family_ms=by_family,
                    admissions_in_window=sum(r[2] for r in window))


def http_burst(port, payloads, stream_flags):
    """POST every payload at the same moment (one thread each, released by
    a barrier); SSE for the flagged ones. Returns (results, send time)."""
    import threading

    from repro_torch.serving import http_request, stream_completion

    results = [None] * len(payloads)
    gate = threading.Barrier(len(payloads) + 1)

    def client(i):
        gate.wait()
        try:
            if stream_flags[i]:
                results[i] = stream_completion(HOST, port, payloads[i],
                                               timeout=60)
            else:
                results[i] = http_request(HOST, port, "POST",
                                          "/v1/completions", payloads[i],
                                          timeout=60)
        except Exception as e:  # noqa: BLE001 — raised below
            results[i] = e

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    gate.wait()
    t_send = time.perf_counter()
    for t in threads:
        t.join(90)
    for r in results:
        if isinstance(r, Exception):
            raise AssertionError(f"phase 11: a client failed: {r!r}")
    return results, t_send


def serving_tokens(results, flags):
    out = []
    for r, sse in zip(results, flags):
        if sse:
            if r.status != 200 or r.final["status"] != "FINISHED":
                raise AssertionError(f"phase 11: SSE {r.status} {r.final}")
            out.append(r.tokens)
        else:
            st, _, body = r
            if st != 200 or body["status"] != "FINISHED":
                raise AssertionError(f"phase 11: buffered {st} {body}")
            out.append(body["tokens"])
    return out


def phase_serving(torch, np, cfg, params, traj, direct):
    """Phase 11: the serving entry points on the card, over phase 4's
    weights (see the module docstring). ``traj`` is phase 4's (prompt,
    tokens) per request, ``direct`` phase 4's numbers. Returns the numbers
    and the launch counters over (a)–(d)."""
    import threading

    from repro_torch.kernels import build
    from repro_torch.launch.serve import TrafficConfig, load_trace, run_traffic
    from repro_torch.serving import (EngineConfig, FaultInjector,
                                     InferenceEngine, ServerConfig,
                                     http_request, start_in_thread,
                                     stream_completion)

    out = {}
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=8, capacity=640, page_size=16, seed=0), device="cuda")
    # (a) readiness follows warmup; warmup builds and loads the libraries
    # (forgotten first, so this warmup must load them again)
    build._LOADED.clear()
    port = free_port()
    zero_counters()
    holder = {}
    t0 = time.perf_counter()
    starter = threading.Thread(target=lambda: holder.setdefault(
        "h", start_in_thread(engine, ServerConfig(port=port),
                             warmup_lens=list(WARMUP_LENS))))
    starter.start()
    during = wait_for(lambda: readyz(port), timeout=60)
    starter.join(300)
    if "h" not in holder:
        raise AssertionError("phase 11a: the server did not start")
    h = holder["h"]
    warm_s = time.perf_counter() - t0
    after = readyz(port)
    loaded = sorted(build._LOADED)
    if (during, after) != (503, 200) or loaded != ["bcr_spmm",
                                                   "paged_attention"]:
        raise AssertionError(f"phase 11a: readyz {during} during warmup, "
                             f"{after} after; libraries loaded {loaded}")
    builds = []
    inner_build = build.build_all
    build.build_all = lambda *a, **kw: builds.append(a) or inner_build(*a,
                                                                        **kw)
    out["a"] = dict(warmup_s=warm_s, readyz=[during, after],
                    libraries_loaded=loaded)
    log(f"phase 11a: readyz {during} during warmup, {after} after "
        f"({warm_s:.1f} s from start, warmup lens {list(WARMUP_LENS)}); "
        f"libraries built and loaded by warmup: {loaded}")

    try:
        # (b) phase 4's 16 requests at one moment, half SSE, half buffered
        prompts = [p for p, _ in traj]
        want = [g for _, g in traj]
        flags = [i % 2 == 0 for i in range(16)]
        rec = StepRecorder(torch, engine, profile=(12, 5))
        before = read_counters()
        results, t_send = http_burst(
            port, [{"prompt": [int(t) for t in p], "max_tokens": 32}
                   for p in prompts], flags)
        wall = time.perf_counter() - t_send
        rec.detach()
        b_launches = {k: v - before[k] for k, v in read_counters().items()}
        got = serving_tokens(results, flags)
        ties = tie_check_against(torch, cfg, params, prompts, got, want,
                                 BF16_TIE, "phase 11b")
        if not all(b_launches[k] for k in FP_KERNELS) or builds:
            raise AssertionError(f"phase 11b: launches {b_launches}, nvcc "
                                 f"runs after warmup {builds}")
        # client TTFT of the SSE requests, against phase 4's engine TTFT of
        # the same requests (all 16 submitted at once there too)
        ttft = [(r.t_first - t_send) * 1e3 for r, s in zip(results, flags)
                if s]
        same = [t for t, s in zip(direct["ttft_ms_by_request"], flags) if s]
        decode = [(e - s) * 1e3 for s, e, adm in rec.rows if not adm]
        out["b"] = dict(
            ttft_ms_p50_sse=statistics.median(ttft),
            direct_ttft_ms_p50_same_requests=statistics.median(same),
            direct_ttft_ms_p50=direct["ttft_ms_p50"],
            ttft_ms_sse=sorted(ttft), direct_ttft_ms_same=sorted(same),
            tokens_per_s=sum(len(g) for g in got) / wall,
            direct_tokens_per_s=direct["tokens_per_s"], wall_s=wall,
            step_wall_ms_p50=statistics.median(decode),
            direct_step_wall_ms_p50=direct["decode_step_ms_p50"],
            steps=len(rec.rows), admitting_steps=sum(r[2] for r in rec.rows),
            near_ties=ties[0], largest_gap=ties[1], held=ties[2],
            profile=rec.busy(), launches={k: v for k, v in b_launches.items()
                                          if v})
        log("phase 11b: " + json.dumps(out["b"]))

        # (c) the lifecycle over HTTP
        host = h.server.host
        pages = engine.pool.n_pages - 1
        r = stream_completion(HOST, port, {"prompt": [int(t) for t in
                                                      prompts[1]],
                                           "max_tokens": 200},
                              disconnect_after=3)
        s0 = host._host_step
        wait_for(lambda: http_request(HOST, port, "GET", "/metrics")[2]
                 ["requests_in_flight"] == 0, timeout=30)
        steps = host._host_step - s0
        m = http_request(HOST, port, "GET", "/metrics")[2]
        with engine._elock:
            idle = engine.pool.idle_pages()
        if not r.closed_early or steps > 1 or idle != pages or \
                m["terminal"].get("cancelled") != 1 or m["disconnects"] != 1:
            raise AssertionError(f"phase 11c disconnect: {steps} steps, "
                                 f"idle pages {idle}/{pages}, {m}")
        log(f"phase 11c disconnect after 3 tokens: slot and pages free "
            f"{steps} host step(s) after the close ({idle} idle pages)")

        i = 3
        engine.faults = FaultInjector(seed=0).at(host._host_step + 4,
                                                 "crash_step")
        r = stream_completion(HOST, port, {"prompt": [int(t) for t in
                                                      prompts[i]],
                                           "max_tokens": 32})
        engine.faults = None
        crash_ties = tie_check_against(
            torch, cfg, params, [prompts[i]], [r.tokens], [want[i]],
            BF16_TIE, "phase 11c crash_step")
        if r.final["status"] != "FINISHED" or host.restarts != 1 or \
                engine.stats["recoveries"] != 1:
            raise AssertionError(f"phase 11c crash_step: {r.final}, "
                                 f"restarts {host.restarts}")
        log(f"phase 11c crash_step: restarts 1, recover() folded and "
            f"requeued the stream, 32 tokens, near-ties {crash_ties[0]}")

        engine.ec.max_waiting = 2
        flags = [False] * 14
        results, _ = http_burst(
            port, [{"prompt": [int(t) for t in prompts[j % 16]],
                    "max_tokens": 64} for j in range(14)], flags)
        engine.ec.max_waiting = None
        codes = [st for st, _, _ in results]
        shed = [(hdrs, body) for st, hdrs, body in results if st == 429]
        if not shed or any(c not in (200, 429) for c in codes) or any(
                "shed" not in b["error"] or int(hd["retry-after"]) < 1
                for hd, b in shed):
            raise AssertionError(f"phase 11c burst: {codes} {shed}")
        retry = [int(hd["retry-after"]) for hd, _ in shed]
        log(f"phase 11c burst of 14 past max_waiting 2: {codes.count(200)} "
            f"x 200, {len(shed)} x 429 (Retry-After {retry} s)")

        res = {}
        fill = [threading.Thread(target=lambda j=j: res.setdefault(
            j, http_request(HOST, port, "POST", "/v1/completions",
                            {"prompt": [int(t) for t in prompts[j]],
                             "max_tokens": 64}, timeout=120)))
            for j in range(1, 8)]
        stream = threading.Thread(target=lambda: res.setdefault(
            "a", stream_completion(HOST, port, {"prompt": [
                int(t) for t in prompts[0]], "max_tokens": 64})))
        for t in fill + [stream]:
            t.start()
        wait_for(lambda: http_request(HOST, port, "GET", "/metrics")[2]
                 ["engine"]["active"] == 8, timeout=30)
        queued = threading.Thread(target=lambda: res.setdefault(
            "b", http_request(HOST, port, "POST", "/v1/completions",
                              {"prompt": [int(t) for t in prompts[8]],
                               "max_tokens": 8}, timeout=120)))
        queued.start()
        wait_for(lambda: http_request(HOST, port, "GET", "/metrics")[2]
                 ["engine"]["waiting"] == 1, timeout=30)
        h.request_drain()
        for t in fill + [stream, queued]:
            t.join(120)
        h.wait_closed(60)
        a, b = res["a"], res["b"]
        if a.final["status"] != "FINISHED" or len(a.tokens) != 64 or \
                b[0] != 429 or "draining" not in b[2]["error"] or \
                any(res[j][0] != 200 for j in range(1, 8)) or \
                not h.server.conservation_ok:
            raise AssertionError(f"phase 11c drain: stream {a.final}, "
                                 f"{len(a.tokens)} tokens; queued {b}; "
                                 f"conservation {h.server.conservation_ok}")
        if host.restarts != 1 or host.crashed:
            raise AssertionError(f"phase 11: {host.restarts} restarts (1 "
                                 f"injected), crashed {host.crashed}")
        log("phase 11c drain: the running stream flushed 64 tokens, the "
            "queued request got 429 'server draining', 7 fillers 200, "
            "conservation ok; supervisor restarts 1 (the injected one)")
    finally:
        build.build_all = inner_build
        if not h.server.draining:
            h.request_drain()
            h.wait_closed(60)

    # (d) open loop on the same engine (the host thread has stopped)
    out["d"] = {}
    for name, tc in (
            ("poisson 8 req/s", TrafficConfig(
                n_requests=32, rate=8.0, prompt_lens=(32, 128, 512),
                gen_tokens=32)),
            ("trace_heavy_tail", TrafficConfig(trace=load_trace(str(
                Path(__file__).resolve().parent / "examples"
                / "trace_heavy_tail.jsonl"))))):
        # run_traffic warms the engine up (its prompts' buckets) first
        m = run_traffic(engine, tc, log=lambda *a: None)
        n = m["n_requests"]
        if m["status_counts"]["finished"] != n:
            raise AssertionError(f"phase 11d {name}: {m['status_counts']}")
        engine.check_conservation()
        keep = ("n_requests", "total_tokens", "elapsed_s",
                "throughput_tok_s", "mean_slot_occupancy", "ttft_s",
                "per_token_s", "decode_steps", "status_counts")
        out["d"][name] = {k: m[k] for k in keep}
        log(f"phase 11d {name}: " + json.dumps(out["d"][name]))
    launches = read_counters()
    return out, launches


def phase_api_subprocess(torch, np):
    """Phase 11e: ``python -m repro_torch.launch.api`` on the card at full
    width and 2 layers: ready after warmup, one streamed and one buffered
    completion (the same greedy tokens), then SIGTERM: exit 0 and
    ``drained; conservation ok``."""
    import os
    import signal

    from repro_torch.serving import http_request, stream_completion

    port = free_port()
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "repro_torch.launch.api", "--arch",
           "llama3.2-1b", "--num-layers", "2", "--bcr-keep", "0.25",
           "--bcr-block", "128", "--slots", "8", "--capacity", "640",
           "--page-size", "16", "--port", str(port), "--warmup-lens",
           "32", "128"]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        def up():
            if proc.poll() is not None:
                raise AssertionError(f"phase 11e: the API exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stdout.read()[-3000:]}")
            return readyz(port) == 200

        wait_for(up, timeout=240, interval=0.2)
        ready_s = time.perf_counter() - t0
        rng = np.random.default_rng(11)
        prompt = [int(t) for t in rng.integers(0, 128256, size=32)]
        r = stream_completion(HOST, port, {"prompt": prompt,
                                           "max_tokens": 16})
        st, _, body = http_request(HOST, port, "POST", "/v1/completions",
                                   {"prompt": prompt, "max_tokens": 16})
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if r.status != 200 or r.final["status"] != "FINISHED" or st != 200 or \
            body["tokens"] != r.tokens or len(r.tokens) != 16:
        raise AssertionError(f"phase 11e: SSE {r.status} {r.final}, "
                             f"buffered {st} {body}")
    if proc.returncode != 0 or "drained; conservation ok" not in text:
        raise AssertionError(f"phase 11e: exit {proc.returncode}: "
                             f"{text[-3000:]}")
    log(f"phase 11e: {' '.join(cmd[1:])}: ready {ready_s:.1f} s after "
        f"launch; SSE and buffered gave the same 16 tokens; SIGTERM → exit "
        f"0, '{text.strip().splitlines()[-1]}'")
    return dict(ready_s=ready_s)


# -- phase 12: the MoE family (deepseek-moe-16b) on the card ------------------


def moe_cfg(**over):
    """deepseek-moe-16b at full width (d_model 2048, 16/16 heads, head_dim
    128, 64 experts top-6 of d_ff 1408 plus 2 shared, vocab 102400), the
    depth cut to ``MOE_LAYERS`` unless ``over`` says otherwise, BCR keep
    0.25 with 128x128 blocks."""
    from repro_torch.configs import get_config
    over.setdefault("num_layers", MOE_LAYERS)
    return dataclasses.replace(get_config(MOE_ARCH), bcr_keep_frac=0.25,
                               bcr_block=(128, 128), **over)


def build_moe_params(torch):
    """Phase 12a/c's weights: one random draw (seed 0), packed at keep 0.25
    / block 128 twice, bf16 tiles and int8 tiles from the same packs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pack_params, packed_fraction
    from repro_torch.models import causal_lm

    cfg = moe_cfg()
    plan = [ffn for _, ffn in causal_lm.layer_plan(cfg)]
    log(f"{MOE_ARCH}: depth cut {get_config(MOE_ARCH).num_layers} -> "
        f"{cfg.num_layers} layers (FFN {plan}); full width: d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, {cfg.num_experts} experts top-{cfg.top_k} of d_ff "
        f"{cfg.moe_d_ff} + {cfg.num_shared_experts} shared, vocab "
        f"{cfg.vocab_size}, capacity_factor {cfg.capacity_factor}")
    t0 = time.perf_counter()
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    params = pack_params(cfg, dense)
    params_q = pack_params(cfg, dense, weight_dtype="int8")
    fracs = (packed_fraction(dense, params), packed_fraction(dense, params_q))
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    wgi = params["layers"][1]["ffn"]["experts"]["wgi"]["w_group"]
    log(f"init + pack (bf16 and int8) {time.perf_counter() - t0:.1f} s; "
        f"experts' wgi vals {tuple(wgi.vals.shape)}; packed-weight fraction "
        f"of the dense fp32 tree: bf16 {fracs[0]:.4f}, int8 {fracs[1]:.4f}")
    return cfg, params, params_q, fracs


def _expert_checks(cfg, stats, launches, label, int8):
    """Exactly one gate/up and one down launch per MoE layer per forward
    (each prefill dispatch and decode step) for all 64 experts, never E."""
    from repro_torch.models.causal_lm import layer_plan

    n_moe = sum(ffn == "moe" for _, ffn in layer_plan(cfg))
    forwards = stats["prefills"] + stats["decode_steps"]
    tag = "_int8" if int8 else ""
    got = {k: launches[f"bcr_spmm{g}{tag}_experts"]
           for k, g in (("wgi", "_grouped"), ("wo", ""))}
    if got != {"wgi": n_moe * forwards, "wo": n_moe * forwards}:
        raise AssertionError(f"{label}: expert launches {got}, want "
                             f"{n_moe} x {forwards} forwards each")
    log(f"{label}: expert-batched launches {got} = {n_moe} MoE layers x "
        f"{forwards} forwards ({stats['prefills']} prefills + "
        f"{stats['decode_steps']} decode steps): one per projection per "
        f"layer, not {EXPERTS}")


def phase_moe_serving(torch, np, cfg, params, frac, quantized):
    """Phase 12a (bf16) / 12c (int8 tiles, int8 KV, flash cold prefill):
    phase 4's traffic through the paged engine at the config's
    capacity_factor."""
    from repro_torch.launch.serve import tree_bytes
    from repro_torch.serving import EngineConfig

    kw = dict(kv_dtype="int8", weight_dtype="int8") if quantized else {}
    if quantized:
        cfg = dataclasses.replace(cfg, attn_impl="pallas")
    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0, **kw)
    label = ("phase 12c int8 tiles + int8 KV + flash prefill" if quantized
             else "phase 12a bf16")
    # no append_vs_cold here: capacity routing makes a MoE suffix's
    # append differ from its cold prefill by design
    stats, launches, traj, _ = serve_main_path(torch, np, cfg, params, ec,
                                               label, frac)
    _expert_checks(cfg, stats, launches, label, quantized)
    if quantized:
        if not all(launches[k] > 0 for k in INT8_KERNELS):
            raise AssertionError(f"{label}: an int8 kernel never launched: "
                                 f"{launches}")
        fp = {k: v for k, v in launches.items() if v and "int8" not in k
              and k.startswith(("bcr_spmm", "paged"))}
        if fp:
            raise AssertionError(f"{label}: fp-form kernels launched: {fp}")
        want = cfg.num_layers * stats["prefills"]
        if launches["flash_attention_fused"] != want:
            raise AssertionError(f"{label}: flash launches "
                                 f"{launches['flash_attention_fused']} != "
                                 f"{want}")
    elif not all(launches[k] > 0 for k in FP_KERNELS):
        raise AssertionError(f"{label}: a kernel never launched: {launches}")
    prof = stats["decode_profile"]
    summary = dict(
        tokens_per_s=stats["tokens_per_s"], ttft_ms_p50=stats["ttft_ms_p50"],
        decode_step_ms_p50=stats["decode_step_ms_p50"],
        decode_steps=stats["decode_steps"], prefills=stats["prefills"],
        device_ms_per_step=prof["device_ms"], busy_share=prof["busy_share"],
        by_family_ms=prof["by_family_ms"],
        device_launches_per_step=prof["device_launches_per_step"],
        host_ops_per_step=prof["host_ops_per_step"],
        moe_host_ms_cprofile={k: prof["host_fn_ms_cprofile"][k]
                              for k in ("moe_apply", "route", "step")},
        resident_weight_bytes=tree_bytes(params),
        streamed_weight_bytes=stats["packed_weight_bytes"],
        step_bound_ms=stats["step_bound_ms"],
        launches={k: v for k, v in launches.items() if v})
    log(f"{label} summary: " + json.dumps(summary))
    return summary, launches, traj


def phase_moe_engine_vs_naive(torch, np):
    """Phase 12b: fp32, full width, 2 layers (1 dense + 1 MoE),
    capacity_factor 8.0 (no token dropped, so batch composition cannot move
    a token), 4 requests: the engine's greedy tokens against the naive
    ``generate`` under phase 6's 1e-4 near-tie rule; the fp32 expert forms
    (CUDA-core body, expert on blockIdx.z) launched."""
    from repro_torch.launch.serve import build_params
    from repro_torch.serving import EngineConfig, InferenceEngine

    cfg = moe_cfg(num_layers=2, dtype="float32", capacity_factor=8.0)
    params = build_params(cfg, seed=1, device="cuda", log=log)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 77, 128, 300)]
    gen = 16
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=2, capacity=640, page_size=16, seed=0), device="cuda")
    zero_counters()
    got = engine.generate(prompts, max_new_tokens=gen)
    launches = read_counters()
    _expert_checks(cfg, engine.stats, launches, "phase 12b", False)
    near_ties = near_tie_check(torch, cfg, params, prompts, got, gen, 1e-4,
                               "phase 12b")
    log(f"phase 12b engine vs naive generate ({MOE_ARCH}, fp32, 2 layers, "
        f"capacity_factor 8.0, 4 requests): tokens equal, near-ties "
        f"{near_ties}; {engine.stats['prefills']} exact-length prefills")
    return near_ties


def train_cfg(torch, num_layers=16, **over):
    """llama3.2-1b at full width: fp32 params, bf16 activations, BCR keep
    0.25 with 128x128 blocks."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-1b"),
                               num_layers=num_layers, bcr_keep_frac=0.25,
                               bcr_block=(128, 128), **over)


def trainer_config(**over):
    from repro_torch.launch.train import TrainerConfig
    kw = dict(steps=8, batch=8, seq=128, admm_start=2, retrain_start=6,
              data_kind="markov", log_every=1, seed=0, device="cuda")
    kw.update(over)
    return TrainerConfig(**kw)


def phase_trainer(torch, np, smi, num_layers=16):
    """GRIM's pruning path at full width through ``train_loop`` (see the
    module docstring, phase 7). Returns the trainer's stats and the
    ``bcr_spmm_skip`` launches of the trained-weight runs."""
    from repro_torch.data.pipeline import DataConfig, TokenSource
    SK = importlib.import_module("repro_torch.kernels.bcr_spmm_skip")
    from repro_torch.kernels import ref
    from repro_torch.launch.train import train_loop
    from repro_torch.tree import flatten, tree_map

    cfg = train_cfg(torch, num_layers)
    tc = trainer_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_loop(cfg, tc, log=lambda *a: log(" ", *a))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist, phases, step_ms = out["history"], out["phases"], out["step_ms"]
    specs, state = out["specs"], out["state"]
    n_params = sum(p.numel() for _, p in flatten(state.params))
    by_phase = {ph: [ms for ms, p in zip(step_ms, phases) if p == ph]
                for ph in ("dense", "admm", "retrain")}
    stats = dict(
        params=n_params, pruned_leaves=len(specs), losses=hist,
        phases=phases, step_ms=step_ms,
        step_ms_p50={ph: statistics.median(v) for ph, v in by_phase.items()
                     if v},
        transition_ms=out["transition_ms"], wall_s=wall,
        peak_bytes=peak)
    log(f"trainer: {json.dumps(stats)}")
    log(f"trainer peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated) on {smi}; retrain step p50 "
        f"{stats['step_ms_p50'].get('retrain', float('nan')):.1f} ms")
    check_trained(np, out, "phase 7")
    stats["profile"] = profile_train_step(torch, cfg, state, specs,
                                          markov_batch(cfg, tc))
    log(f"  every one of the {len(specs)} pruned leaves is a balanced-BCR "
        f"member; loss {hist[0]:.4f} -> {hist[-1]:.4f}")

    # the retrained weights through the serving path
    dense = tree_map(lambda p: p.detach(), state.params)
    del out, state
    torch.cuda.empty_cache()
    toks = TokenSource(DataConfig(cfg.vocab_size, tc.seq, tc.batch,
                                  seed=1, kind="markov")).device_batch(
        0, "cuda")["tokens"]
    _, serve = packed_prefill_check(torch, cfg, dense, {"tokens": toks},
                                    "phase 7")
    stats.update(serve_max_abs=serve["max_abs"], serve_scale=serve["scale"],
                 serve_near_ties=serve["near_ties"])
    torch.cuda.empty_cache()

    # the trained projections, paper-general form: unbalanced BCR, skip pack;
    # the counted runs first, then the timed ones (not counted)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    zero_counters()
    skip_rows, runs = [], []
    for name, w in (("lm_head", dense["lm_head"]["w"]),
                    ("mlp_wo", dense["layers"][0]["ffn"]["wo"]["w"]),
                    ("wq", dense["layers"][0]["mixer"]["wq"]["w"])):
        p, share, empty = skip_pack(torch, w, dtype=cfg.act_dtype)
        for m in (8, tc.batch * tc.seq):
            x = torch.randn((m, w.shape[1]), generator=gen,
                            device="cuda").to(cfg.act_dtype)
            got = SK.bcr_spmm_skip(x, p)
            want = ref.bcr_spmm_skip_ref(x, p)
            torch.cuda.synchronize()
            err = check_close(f"trained {name} {tuple(w.shape)} unbalanced "
                              f"(share {share:.4f}, empty block rows "
                              f"{empty}) M={m}", got, want, BF16_TOL)
            skip_rows.append(dict(weight=name, m=m, share=share,
                                  empty_block_rows=empty, max_abs_err=err))
            runs.append((p, x))
        del p
    launches = read_counters()["bcr_spmm_skip"]
    log(f"  bcr_spmm_skip launches on the trained weights: {launches}")
    if launches != len(skip_rows):
        raise AssertionError("bcr_spmm_skip did not launch once per run")
    timer = Timer(torch)
    for row, (p, x) in zip(skip_rows, runs):
        byts, ops = skip_bytes_ops(p, x.shape[0])
        row["ms"] = timer.ms(lambda: SK.bcr_spmm_skip(x, p))
        row["bound_ms"] = max(byts / HBM_BYTES_PER_S,
                              ops / BF16_OPS_PER_S) * 1e3
        log(f"  trained {row['weight']} M={row['m']}: {row['ms']:.4f} ms "
            f"(bound {row['bound_ms']:.4f} ms)")
    stats["trained_skip"] = skip_rows
    del runs, timer
    del dense
    torch.cuda.empty_cache()
    return stats, launches


def train_kernel_family(name: str) -> str:
    """A profiler kernel name of a train step → a coarse family."""
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "sm90_",
                              "nvjet")):      # nvjet: cuBLASLt's Hopper GEMMs
        return "matmul"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reduction"
    if "elementwise" in low or "vectorized" in low or "foreach" in low:
        return "elementwise"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def markov_batch(cfg, tc):
    """The batch ``train_loop`` would draw at step ``tc.steps`` (the step
    after its last), as a function of no arguments."""
    from repro_torch.data.pipeline import DataConfig, TokenSource

    data = TokenSource(DataConfig(cfg.vocab_size, tc.seq, tc.batch,
                                  seed=tc.seed, kind=tc.data_kind))
    return lambda: data.device_batch(tc.steps, tc.device)


def profile_train_step(torch, cfg, state, specs, make_batch):
    """Where a retrain step's time goes: one more step (frozen masks, a
    tiny learning rate) timed on the host, then one under
    ``torch.profiler`` — device time by kernel family against the wall
    (the busy share), and the host time of ``make_batch()`` on its own.
    Run after the 8 steps of a training run, on its final state. The
    profiler collects device activity only: the CPU ops of a host-bound
    recurrent step (rwkv6-3b: ~250 k launches) take it minutes to gather,
    and nothing here reads them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.adamw import AdamWConfig

    t0 = time.perf_counter()
    batch = make_batch()
    batch_ms = (time.perf_counter() - t0) * 1e3
    step = make_train_step(cfg, AdamWConfig(lr=1e-6, warmup_steps=0,
                                            total_steps=1), None, specs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        float(m["loss"])
    fams, top = {}, []
    for name, count, ms in device_events(torch, prof):
        fam = train_kernel_family(name)
        fams[fam] = fams.get(fam, 0.0) + ms
        top.append((ms, count, name[:70]))
    device_ms = sum(fams.values())
    launches = sum(ev.count for ev in prof.key_averages()
                   if getattr(ev, "device_type", None)
                   == torch.autograd.DeviceType.CUDA)
    out = dict(step_wall_ms=wall_ms, batch_host_ms=batch_ms,
               device_ms=device_ms, busy_share=device_ms / wall_ms,
               device_launches=launches, by_family_ms=fams,
               top_kernels=sorted(top, reverse=True)[:8])
    log("  retrain step profile: " + json.dumps(out))
    return out


def phase_resume(torch, np, tmp_dir):
    """2 layers, vocab cut to 8192 (the checkpoint stays ~3 GB), the same
    phases: a run stopped at step 4 (a ``save_async`` checkpoint inside the
    ADMM phase) and resumed must repeat the uninterrupted run's losses.
    fp32 tolerance 1e-4 relative: the embedding backward sums with atomics
    in a run-dependent order."""
    import shutil

    from repro_torch.launch.train import train_loop
    from repro_torch.optim.adamw import AdamWConfig

    cfg = train_cfg(torch, num_layers=2, vocab_size=8192)
    # the schedule of the 8-step run for all three (the loop's default
    # would follow each run's own step count)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    quiet = lambda *a: None                           # noqa: E731
    whole = train_loop(cfg, trainer_config(), opt, log=quiet)["history"]
    shutil.rmtree(tmp_dir, ignore_errors=True)
    t0 = time.perf_counter()
    first = train_loop(cfg, trainer_config(steps=4, ckpt_dir=str(tmp_dir),
                                           ckpt_every=4), opt, log=quiet)
    save_s = time.perf_counter() - t0
    rest = train_loop(cfg, trainer_config(ckpt_dir=str(tmp_dir),
                                          ckpt_every=100), opt, log=quiet)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    got = first["history"] + rest["history"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, whole))
    log(f"resume (2 layers, vocab 8192): uninterrupted {whole}; stopped at "
        f"4 and resumed {got}; max relative difference {rel:.2e} (first run "
        f"incl. its checkpoint {save_s:.1f} s)")
    if rest["phases"] != ["admm"] * 2 + ["retrain"] * 2 or rel > 1e-4:
        raise AssertionError("resumed losses disagree with the uninterrupted "
                             "run")
    return rel


# -- phase 13: the source paper's own workloads on the card --------------------

# the GRU at the paper's width (the reference's models/gru.py: d_model 1024
# x 2 layers is the paper's TIMIT model), the gru_rnn example's vocab and
# classes; gru_apply at B 32, S 24; the step at batch 1 and 32
GRU_D, GRU_VOCAB, GRU_CLASSES, GRU_B, GRU_S = 1024, 64, 8, 32, 24
GRU_BATCHES, GRU_REPS, GRU_PROFILED = (1, 32), 60, 10
# (name, batch, H, W, C_in, C_out) of phase 13b's 3x3 convolutions: the
# cnn_im2col example's conv2 (4 images of 8 x 8: M 256) and a VGG-16 conv3
# layer (Simonyan & Zisserman, arXiv:1409.1556, ImageNet: 56 x 56, 256 ->
# 256), at batch 1 and 8
CONVS = (("example conv2", 4, 8, 8, 16, 32),
         ("VGG-16 conv3", 1, 56, 56, 256, 256),
         ("VGG-16 conv3", 8, 56, 56, 256, 256))
# phase 13c: Listing 1's candidates beside default_candidates, and its
# layers (name, M, K, N) at the serving keep
LISTING1_BLOCKS = ((8, 8), (8, 16), (16, 16), (32, 32), (64, 64), (128, 128))
LISTING1_LAYERS = (("GRU 1024x1024", 1, 1024, 1024),
                   ("GRU 1024x1024", 32, 1024, 1024),
                   ("llama3.2-1b MLP wo 2048x8192", 8, 8192, 2048))
LISTING1_KEEP = 0.25


@contextlib.contextmanager
def plain_bcr():
    """Inside the block ``bcr_matmul`` runs ``bcr_spmm``'s plain version on
    the card's tensors: a whole model's plain forward on the same inputs."""
    from repro_torch.kernels import ops, ref
    kernel = ops.bcr_spmm
    ops.bcr_spmm = ref.bcr_spmm_packed_ref
    try:
        yield
    finally:
        ops.bcr_spmm = kernel


def packed_leaves(tree):
    """Every TBCRC of a param tree."""
    from repro_torch.core.bcrc import TBCRC
    if isinstance(tree, TBCRC):
        return [tree]
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in packed_leaves(v)]
    if isinstance(tree, list):
        return [p for v in tree for p in packed_leaves(v)]
    return []


def gru_models(torch):
    """``{dtype: (dense masked, packed)}`` for fp32 and bf16: the GRU at the
    paper's width from seed 0, masks from ``admm.finalize`` at the
    ``gru_rnn`` example's spec, packed by ``pack_params`` under the
    example's config in that dtype (the head, 8 x 1024, stays dense)."""
    from repro_torch.core import admm
    from repro_torch.examples.gru_rnn import prune_filter, serving_config
    from repro_torch.launch.serve import pack_params
    from repro_torch.models.gru import gru_init
    from repro_torch.tree import tree_map

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dense = gru_init(gen, GRU_VOCAB, GRU_D, 2, GRU_CLASSES)
    dense, _ = admm.finalize(dense, admm.specs_for(dense, prune_filter))
    models = {}
    for dt, name in ((torch.float32, "float32"),
                     (torch.bfloat16, "bfloat16")):
        d = tree_map(lambda t: t.to(dt), dense)
        packed = pack_params(serving_config(GRU_D, GRU_VOCAB, name), d)
        if len(packed_leaves(packed)) != 12:
            raise AssertionError("phase 13a: expected 12 packed GRU matrices")
        models[dt] = (d, packed)
    return models


def gru_step_stats(torch, params, batch, dtype, gen):
    """One GRU timestep at ``batch``: p50 wall over ``GRU_REPS`` warm steps
    (each ending in a synchronise), ``bcr_spmm`` launches in one step, and
    device time, launches and ``bcr_spmm`` device time a step over a
    profiled window of ``GRU_PROFILED`` steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.gru import gru_step_latency_fn

    fn = gru_step_latency_fn(params)
    h = (torch.randn((batch, GRU_D), generator=gen, device="cuda")
         * 0.5).to(dtype)
    x = (torch.randn((batch, GRU_D), generator=gen, device="cuda")
         * 0.5).to(dtype)
    for _ in range(5):
        fn(h, x)
    torch.cuda.synchronize()
    walls = []
    for _ in range(GRU_REPS):
        t0 = time.perf_counter()
        fn(h, x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    zero_counters()
    fn(h, x)
    torch.cuda.synchronize()
    bcr_launches = read_counters()["bcr_spmm"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(GRU_PROFILED):
            fn(h, x)
        torch.cuda.synchronize()
    events = list(device_events(torch, prof))
    launches = sum(ev.count for ev in prof.key_averages()
                   if getattr(ev, "device_type", None)
                   == torch.autograd.DeviceType.CUDA)
    return dict(
        wall_p50_us=statistics.median(walls),
        device_us=sum(ms for _, _, ms in events) / GRU_PROFILED * 1e3,
        bcr_device_us=sum(ms for name, _, ms in events
                          if "bcr_spmm" in name) / GRU_PROFILED * 1e3,
        device_launches=launches / GRU_PROFILED, bcr_launches=bcr_launches)


def gru_step_bound_us(torch, params, batch, dtype) -> dict:
    """The least time of one step's matmuls on the card: every packed
    matrix's tiles and index planes (or every dense weight) plus each
    launch's x and y, over 3.35 TB/s, against the kept (or dense) products
    over the dtype's peak."""
    elt = torch.empty((), dtype=dtype).element_size()
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    packs = packed_leaves(params["cells"])
    if packs:
        weights = sum(p.vals.numel() * p.vals.element_size()
                      + (p.row_idx.numel() + p.col_idx.numel()) * 4
                      for p in packs)
        macs = sum(p.vals.numel() for p in packs)
    else:
        weights = sum(lin["w"].numel() * elt for cell in params["cells"]
                      for lin in cell.values())
        macs = weights // elt
    byts = weights + 12 * 2 * batch * GRU_D * elt
    t_bytes = byts / HBM_BYTES_PER_S * 1e6
    t_ops = 2 * batch * macs / peak * 1e6
    return dict(bound_us=max(t_bytes, t_ops), bound_bytes=byts,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_gru(torch, np, timer, record):
    """Phase 13a (see the module docstring). Returns the packed fp32 step's
    ``bcr_spmm`` launches and device ms at batch 1 (the kernels line's
    ``gru_launches`` and ``gru_ms``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcr_spmm import bcr_spmm
    from repro_torch.models.gru import gru_apply

    models = gru_models(torch)
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, GRU_VOCAB, size=(GRU_B, GRU_S)), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    steps = []
    with torch.no_grad():
        for dt, tol in ((torch.float32, FP32_TOL),
                        (torch.bfloat16, BF16_TOL)):
            dense, packed = models[dt]
            zero_counters()
            got = gru_apply(packed, toks)
            torch.cuda.synchronize()
            launches = read_counters()["bcr_spmm"]
            want = gru_apply(dense, toks)
            with plain_bcr():
                plain = gru_apply(packed, toks)
            if launches != 2 * GRU_S * 6 or not bool(
                    torch.isfinite(got).all()) or got.shape != (
                        GRU_B, GRU_CLASSES):
                raise AssertionError(f"phase 13a gru_apply {dt}: launches "
                                     f"{launches}, shape {got.shape}")
            what = f"phase 13a gru_apply {dt} B={GRU_B} S={GRU_S} packed"
            check_close(f"{what} vs dense masked", got, want, tol)
            check_close(f"{what} vs plain", got, plain, tol)
            log(f"  bcr_spmm launches over gru_apply: {launches} = 2 layers "
                f"x {GRU_S} steps x 6")
            for batch in GRU_BATCHES:
                for form, params in (("dense", dense), ("packed", packed)):
                    st = gru_step_stats(torch, params, batch, dt, gen)
                    st.update(gru_step_bound_us(torch, params, batch, dt))
                    st.update(dtype=str(dt).split(".")[-1], batch=batch,
                              form=form)
                    steps.append(st)
                    log(f"phase 13a GRU step {st['dtype']} batch {batch} "
                        f"{form}: " + json.dumps(st))
            # bcr_spmm alone at the GRU's shapes, timed as phase 3's rows
            p = packed["cells"][0]["uz"]["w_packed"]
            w_dense = dense["cells"][0]["uz"]["w"]
            for m in GRU_BATCHES:
                x = torch.randn((m, GRU_D), generator=gen,
                                device="cuda").to(dt)
                shape = (f"GRU uz {GRU_D}x{GRU_D} (8,8) keep 0.1 M={m} "
                         f"{str(dt).split('.')[-1]}")
                err = check_close(shape, bcr_spmm(x, p),
                                  ref.bcr_spmm_packed_ref(x, p), tol)
                byts = (p.vals.numel() * p.vals.element_size()
                        + (p.row_idx.numel() + p.col_idx.numel()) * 4
                        + 2 * m * GRU_D * x.element_size())
                record("bcr_spmm", shape, err,
                       timer.ms(lambda: bcr_spmm(x, p)),
                       timer.ms(lambda: ref.bcr_spmm_packed_ref(x, p)),
                       byts, 2 * m * p.vals.numel(), dt,
                       timer.ms(lambda: _library_dense_matmul(x, w_dense)))
    first = next(st for st in steps if st["dtype"] == "float32"
                 and st["batch"] == 1 and st["form"] == "packed")
    if any(st["bcr_launches"] != (12 if st["form"] == "packed" else 0)
           for st in steps):
        raise AssertionError("phase 13a: a packed step did not launch "
                             "bcr_spmm once a matrix")
    del models
    torch.cuda.empty_cache()
    return first["bcr_launches"], first["device_us"] / 1e3


def phase_cnn(torch, timer, record):
    """Phase 13b (see the module docstring)."""
    from repro_torch.core.bcr import bcr_mask
    from repro_torch.core.bcrc import tbcrc_pack
    from repro_torch.examples.cnn_im2col import conv_as_gemm, im2col, spec_for
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import bcr_matmul

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    with torch.no_grad():
        for name, b, hh, ww, cin, cout in CONVS:
            k = 9 * cin
            w = torch.randn((cout, k), generator=gen, device="cuda") \
                * k ** -0.5
            spec = spec_for(w)
            mask = bcr_mask(w, spec)
            dead = int((mask.sum(0) == 0).sum())
            x = torch.randn((b, hh, ww, cin), generator=gen, device="cuda")
            for dt, tol in ((torch.float32, FP32_TOL),
                            (torch.bfloat16, BF16_TOL)):
                packed = tbcrc_pack(w, spec)
                packed.vals = packed.vals.to(dt)
                w_dense = (w * mask).to(dt)
                xd = x.to(dt)
                zero_counters()
                got = conv_as_gemm(xd, packed, 3, 3, cout)
                torch.cuda.synchronize()
                if read_counters()["bcr_spmm"] != 1:
                    raise AssertionError(f"phase 13b {name}: not one launch")
                with plain_bcr():
                    plain = conv_as_gemm(xd, packed, 3, 3, cout)
                cols = im2col(xd, 3, 3)
                m = cols.shape[0]
                shape = (f"{name} B={b} M={m} K={k} N={cout} "
                         f"{spec.block_shape} keep 0.25 "
                         f"{str(dt).split('.')[-1]}")
                err = check_close(f"{shape} vs plain", got, plain, tol)
                check_close(f"{shape} vs dense cols @ W.T", got,
                            conv_as_gemm(xd, w_dense, 3, 3, cout), tol)
                byts = ((m * k + m * cout) * cols.element_size()
                        + packed.vals.numel() * packed.vals.element_size()
                        + (packed.row_idx.numel()
                           + packed.col_idx.numel()) * 4)
                record("bcr_spmm", shape, err,
                       timer.ms(lambda: bcr_matmul(cols, packed)),
                       timer.ms(lambda: ref.bcr_spmm_packed_ref(cols, packed),
                                reps=5),
                       byts, 2 * m * packed.vals.numel(), dt,
                       timer.ms(lambda: _library_dense_matmul(cols, w_dense)))
                del cols, plain, got
            log(f"phase 13b {name} ({cout}x{k}, blocks {spec.block_shape}, "
                f"kept {tuple(packed.vals.shape[-2:])}): im2col skip "
                f"{dead}/{k} patch columns never expanded")
    torch.cuda.empty_cache()


def phase_listing1(torch):
    """Phase 13c (see the module docstring)."""
    from repro_torch.core import block_search as BS
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcr_spmm import bcr_spmm

    def run(layer):
        t = BS.wallclock_runner(layer, iters=20, device="cuda")
        if math.isfinite(t):
            x, p = BS.synth_operands(layer, device="cuda")
            check_close(f"phase 13c {layer.block_shape} M={layer.m}",
                        bcr_spmm(x, p), ref.bcr_spmm_packed_ref(x, p),
                        BF16_TOL, quiet=True)
        return t

    for name, m, k, n in LISTING1_LAYERS:
        cands = list(dict.fromkeys(LISTING1_BLOCKS
                                   + tuple(BS.default_candidates(n, k))))
        size, log_ = BS.find_opt_blk(m, k, n, LISTING1_KEEP, cands,
                                     run_layer=run)
        curve = [(list(b), t * 1e3) for b, t in log_]
        log(f"phase 13c Listing 1, {name} M={m} keep {LISTING1_KEEP} bf16: "
            f"chosen {size}; (block, ms): " + json.dumps(curve))


def phase_examples(torch):
    """Phase 13d: the port's five examples through ``main`` on their
    default device, the card (``train_lm`` at ``--preset tiny`` through
    dense, ADMM and retraining); each must end in ``OK``."""
    from repro_torch.examples import (cnn_im2col, gru_rnn, quickstart,
                                      serve_decode, train_lm)

    tiny = ["--preset", "tiny", "--steps", "60", "--admm-start", "20",
            "--retrain-start", "40"]
    for name, mod, argv in (("quickstart", quickstart, []),
                            ("gru_rnn", gru_rnn, []),
                            ("cnn_im2col", cnn_im2col, []),
                            ("serve_decode", serve_decode, []),
                            ("train_lm", train_lm, tiny)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
        lines = buf.getvalue().strip().splitlines()
        for ln in lines:
            log(f"  {name}: {ln}")
        if not lines or lines[-1] != "OK":
            raise AssertionError(f"phase 13d: {name} did not end in OK")
        log(f"phase 13d {name}: OK in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()


def phase_paper(torch, np):
    """Phase 13: (a)–(d). Returns the packed fp32 GRU step's ``bcr_spmm``
    launches and device ms at batch 1."""
    rows = []
    timer, record = Timer(torch), recorder(torch, rows)
    t0 = time.perf_counter()
    gru_launches, gru_ms = phase_gru(torch, np, timer, record)
    t1 = time.perf_counter()
    phase_cnn(torch, timer, record)
    del timer
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    phase_listing1(torch)
    t3 = time.perf_counter()
    phase_examples(torch)
    log("phase 13 kernel cases: " + json.dumps(rows))
    log(f"phase 13: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s")
    return gru_launches, gru_ms


# -- phase 14: the vlm, ssm and hybrid families -----------------------------

# the depth each family is served at on the card (full width always):
# pixtral 40 -> 4, rwkv6-3b whole (32), jamba 32 -> 8 (one period: 1
# attention + 7 mamba layers, 4 MoE layers of 16 experts)
FAMILY_LAYERS = {"pixtral-12b": 4, "rwkv6-3b": 32, "jamba-v0.1-52b": 8}
# jamba's experts at decode: 8 slots x top-2 x 1.25 / 16 experts -> 4 rows
# a expert (the floor of 4); a 2-row 512-token prefill: 2 groups x 80
JAMBA_EXPERTS, JAMBA_EXPERT_MS = 16, (4, 160)
# kernel families the three families' decode steps must launch
FAMILY_KERNELS = {
    "pixtral-12b": ("bcr_spmm", "bcr_spmm_grouped", "paged_attention"),
    "rwkv6-3b": ("bcr_spmm",),
    "jamba-v0.1-52b": ("bcr_spmm", "bcr_spmm_grouped", "paged_attention",
                       "bcr_spmm_experts", "bcr_spmm_grouped_experts"),
}


@contextlib.contextmanager
def plain_kernels():
    """Inside the block ``bcr_matmul`` and ``bcr_matmul_grouped`` run the
    plain versions of ``bcr_spmm`` and ``bcr_spmm_grouped`` on the card's
    tensors (the grouped one in the wrapper's layout)."""
    from repro_torch.kernels import ops, ref

    def grouped(x, g, bias=None, epilogue=None):
        y = ref.bcr_spmm_grouped_ref(x, g, bias=bias, epilogue=epilogue)
        return y if epilogue == "swiglu" else y.transpose(-3, -2)

    saved = ops.bcr_spmm, ops.bcr_spmm_grouped
    ops.bcr_spmm, ops.bcr_spmm_grouped = ref.bcr_spmm_packed_ref, grouped
    try:
        yield
    finally:
        ops.bcr_spmm, ops.bcr_spmm_grouped = saved


def random_pack(torch, gen, n, k, e=0):
    """A random ``n x k`` weight (``e`` of them stacked when ``e``) drawn
    on the card, packed at keep 0.25 on the blocks ``pack_params`` chooses
    (``choose_block_shape`` from 128 x 128); fp32 tiles."""
    from repro_torch.core.bcr import BCRSpec, choose_block_shape, kept_align
    from repro_torch.core.bcrc import tbcrc_pack

    block = choose_block_shape((n, k), (128, 128))
    spec = BCRSpec(block_shape=block, keep_frac=0.25, align=kept_align(block))
    shape = (e, n, k) if e else (n, k)
    return tbcrc_pack(torch.randn(shape, generator=gen, device="cuda")
                      * k ** -0.5, spec)


def packed_nbytes(p) -> int:
    """Bytes a kernel reads of a pack: tiles, indices, int8 scales."""
    scales = p.plan.block_scales if p.plan is not None else None
    return (p.vals.numel() * p.vals.element_size()
            + (p.row_idx.numel() + p.col_idx.numel()) * 4
            + (0 if scales is None else scales.numel() * 4))


def projection_cases(torch, timer, gen, record, table):
    """Phase 3's ``bcr_spmm`` / ``bcr_spmm_grouped`` cases over ``table``,
    rows ``(model, name, n, k, group, epilogue, Ms, dtype, bias, int8)``:
    :func:`random_pack` members, tiles and x in ``dtype``; a group fused
    by ``pack_group``, with a random ``(G, n)`` bias in the emit step where
    ``bias`` says; where ``int8`` says, the same weights quantized (int8
    tiles, bf16 x) run too. Each against its
    plain version (bf16 at 2e-2, fp32 at 1e-4 x the output scale), timed
    beside it, the dense library product (plus the bias) and its bound."""
    from repro_torch.core.bcrc import tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import (pack_group, quantize_grouped,
                                          quantize_packed)

    def dequantized(p, g, dt):
        if g == 1:
            return tbcrc_unpack(p).to(dt)
        # a group's members, one at a time (the int8 scales ride with each)
        return torch.cat([tbcrc_unpack(dataclasses.replace(
            p, vals=p.vals[i], row_idx=p.row_idx[i], col_idx=p.col_idx[i],
            plan=dataclasses.replace(p.plan,
                                     block_scales=p.plan.block_scales[i])))
            for i in range(g)]).to(dt)

    for model, wname, n, k, g, epi, ms, dt, has_bias, int8 in table:
        members = [random_pack(torch, gen, n, k) for _ in range(g)]
        log(f"  {model} {wname}: block {members[0].block_shape}, kept tile "
            f"{tuple(members[0].vals.shape[-2:])}, grid "
            f"{tuple(members[0].vals.shape[:2])}")
        fp = members[0] if g == 1 else pack_group(members)
        forms = [("", dataclasses.replace(fp, vals=fp.vals.to(dt)),
                  torch.cat([tbcrc_unpack(p) for p in members]).to(dt))]
        if int8:
            q = quantize_packed(fp) if g == 1 else quantize_grouped(fp)
            forms.append(("_int8", q, dequantized(q, g, dt)))
        del members, fp
        bias = (torch.randn((g, n), generator=gen, device="cuda").to(dt)
                if has_bias else None)
        tol = BF16_TOL if dt == torch.bfloat16 else FP32_TOL
        pre = "" if dt == torch.bfloat16 else "fp32 "
        for form, w, w_dense in forms:
            key = ("bcr_spmm" if g == 1 else "bcr_spmm_grouped") + form
            for m in ms:
                x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
                if g == 1:
                    def run():
                        return K.bcr_spmm(x, w)

                    def plain():
                        return ref.bcr_spmm_packed_ref(x, w)
                else:
                    def run():
                        return K.bcr_spmm_grouped(x, w, bias=bias,
                                                  epilogue=epi)

                    def plain():
                        y = ref.bcr_spmm_grouped_ref(x, w, bias=bias,
                                                     epilogue=epi)
                        return y if epi else y.transpose(0, 1)

                def library():
                    if bias is None:
                        return _library_dense_matmul(x, w_dense)
                    return torch.addmm(bias.reshape(-1), x, w_dense.T)

                shape = (f"{pre}{model} {wname} "
                         f"{f'{g}x' if g > 1 else ''}{n}x{k} M={m}")
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = check_close(f"{key} {shape}", got, want, tol)
                nb_r, nb_c, r, c = w.vals.shape[-4:]
                out_n = n if epi else g * n
                elt = x.element_size()
                record(key, shape, err, timer.ms(run), timer.ms(plain),
                       packed_nbytes(w) + (m * k + m * out_n) * elt
                       + (0 if bias is None else bias.numel() * elt),
                       2 * m * g * nb_r * nb_c * r * c, dt,
                       timer.ms(library))
                del x, got, want
        del forms, w, w_dense
        torch.cuda.empty_cache()


def family_cases(torch, timer, gen, record):
    """Phase 3's cases at the shapes phase 14 gives the kernels, new to every
    earlier phase, bf16 x and tiles at block 128 / keep 0.25 (the blocks
    ``pack_params`` chooses): pixtral-12b's wq, K/V, gate/up (SwiGLU), wo,
    MLP wo and lm_head; rwkv6-3b's 2560^2, 2560 -> 8960, 8960 -> 2560 and
    lm_head; jamba's in_proj, x_proj (288 x 8192 on 144 x 128 blocks: 72 x
    64 tiles), dt_proj (8192 x 256), out_proj and lm_head; at M = 8 (a
    decode step) and 512 (one prompt's prefill), x_proj also at M = 1024;
    jamba's 16 experts (``wo`` 4096 x 14336, ``wgi`` 2 x 14336 x 4096) at M
    = 4 and 160 a expert; fp32 x and tiles (phase 14d's CUDA-core bodies)
    at every pixtral and rwkv6-3b shape above and jamba's x_proj; paged
    decode and prefill-append at 32/8 heads, head_dim 128 (pixtral and
    jamba), bf16 and fp32 pages. Each against its plain version (bf16 at
    2e-2, fp32 at 1e-4 x the output scale), timed beside it, the dense
    library product and its bound."""
    from repro_torch.core.bcrc import tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import pack_group

    bf16, fp32 = torch.bfloat16, torch.float32
    log("phase 14's kernel shapes: bcr_spmm / bcr_spmm_grouped (block 128, "
        "keep 0.25; x_proj on 144 x 128 blocks)")
    projection_cases(torch, timer, gen, record, [
        row + (False, False) for row in (
            ("pixtral", "wq", 4096, 5120, 1, None, (8, 512), bf16),
            ("pixtral", "wkv", 1024, 5120, 2, None, (8, 512), bf16),
            ("pixtral", "wgi", 14336, 5120, 2, "swiglu", (8, 512), bf16),
            ("pixtral", "wo", 5120, 4096, 1, None, (8,), bf16),
            ("pixtral", "mlp_wo", 5120, 14336, 1, None, (8, 512), bf16),
            ("pixtral", "lm_head", 131072, 5120, 1, None, (8,), bf16),
            ("rwkv6", "wr", 2560, 2560, 1, None, (8, 512), bf16),
            ("rwkv6", "cm_wk", 8960, 2560, 1, None, (8, 512), bf16),
            ("rwkv6", "cm_wv", 2560, 8960, 1, None, (8, 512), bf16),
            ("rwkv6", "lm_head", 65536, 2560, 1, None, (8,), bf16),
            # fp32 x and tiles: phase 14d's CUDA-core bodies at full width
            ("pixtral", "wq", 4096, 5120, 1, None, (8, 512), fp32),
            ("pixtral", "wkv", 1024, 5120, 2, None, (8, 512), fp32),
            ("pixtral", "wgi", 14336, 5120, 2, "swiglu", (8, 512), fp32),
            ("pixtral", "wo", 5120, 4096, 1, None, (8, 512), fp32),
            ("pixtral", "mlp_wo", 5120, 14336, 1, None, (8, 512), fp32),
            ("pixtral", "lm_head", 131072, 5120, 1, None, (8,), fp32),
            ("rwkv6", "wr", 2560, 2560, 1, None, (8, 512), fp32),
            ("rwkv6", "cm_wk", 8960, 2560, 1, None, (8, 512), fp32),
            ("rwkv6", "cm_wv", 2560, 8960, 1, None, (8, 512), fp32),
            ("rwkv6", "lm_head", 65536, 2560, 1, None, (8,), fp32),
            ("jamba", "in_proj", 16384, 4096, 1, None, (8, 512), bf16),
            ("jamba", "x_proj", 288, 8192, 1, None, (8, 512, 1024), bf16),
            ("jamba", "dt_proj", 8192, 256, 1, None, (8, 512), bf16),
            ("jamba", "out_proj", 4096, 8192, 1, None, (8, 512), bf16),
            ("jamba", "lm_head", 65536, 4096, 1, None, (8,), bf16),
            ("jamba", "x_proj", 288, 8192, 1, None, (8,), fp32))])

    e = JAMBA_EXPERTS
    log(f"jamba's experts: expert-batched bcr_spmm / bcr_spmm_grouped "
        f"({e} experts, bf16)")
    wo = random_pack(torch, gen, 4096, 14336, e)
    wgi = pack_group([random_pack(torch, gen, 14336, 4096, e)
                      for _ in range(2)])
    wo, wgi = (dataclasses.replace(w, vals=w.vals.to(bf16))
               for w in (wo, wgi))
    w_wo = tbcrc_unpack(wo).to(bf16).transpose(1, 2)
    w_gi = tbcrc_unpack(wgi).to(bf16).reshape(e, 2 * 14336,
                                               4096).transpose(1, 2)
    for m in JAMBA_EXPERT_MS:
        for key, w, w_t, k, n, g in (
                ("bcr_spmm_experts", wo, w_wo, 14336, 4096, 1),
                ("bcr_spmm_grouped_experts", wgi, w_gi, 4096, 14336, 2)):
            x = torch.randn((e, m, k), generator=gen, device="cuda").to(bf16)
            if g == 2:
                def run():
                    return K.bcr_spmm_grouped(x, w, epilogue="swiglu")

                def plain():
                    return ref.bcr_spmm_grouped_ref(x, w, epilogue="swiglu")
            else:
                def run():
                    return K.bcr_spmm(x, w)

                def plain():
                    return ref.bcr_spmm_packed_ref(x, w)
            shape = (f"jamba experts {'wgi' if g == 2 else 'wo'} {e}x"
                     f"{f'{g}x' if g > 1 else ''}{n}x{k} M={m}")
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = check_close(f"{key} {shape}", got, want, BF16_TOL)
            nb_r, nb_c, r, c = w.vals.shape[-4:]
            record(key, shape, err, timer.ms(run), timer.ms(plain),
                   packed_nbytes(w) + e * m * (k + n) * 2,
                   2 * e * m * g * nb_r * nb_c * r * c, bf16,
                   timer.ms(lambda: _library_expert_bmm(torch, x, w_t)))
    del wo, wgi, w_wo, w_gi

    log("paged decode and prefill-append at 32/8 heads, head_dim 128 "
        "(pixtral, jamba), page 16, bf16 and fp32 pages")
    h, hkv, d, ps = 32, 8, 128, 16

    def pages(tlens, dt):
        per = [max(1, -(-int(t) // ps)) for t in tlens]
        n_pages = 1 + sum(per) + 8
        kp, vp = (torch.randn((n_pages, ps, hkv, d), generator=gen,
                              device="cuda").to(dt) for _ in range(2))
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device="cuda").cpu() + 1
        bt = torch.zeros((len(tlens), max(per)), dtype=torch.int32)
        nxt = 0
        for i, npg in enumerate(per):
            bt[i, :npg] = perm[nxt:nxt + npg]
            nxt += npg
        return kp, vp, bt.cuda()

    def library_ms(q, kp, vp, bt, qpos):
        """SDPA over the gathered pages, query row j at position qpos."""
        b, l_max = q.shape[0], bt.shape[1] * ps
        kk, vv = (p[bt.long()].reshape(b, l_max, hkv, d)
                  .repeat_interleave(h // hkv, 2).transpose(1, 2)
                  for p in (kp, vp))
        mask = (torch.arange(l_max, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        return timer.ms(lambda: _library_sdpa(torch, q.transpose(1, 2), kk,
                                              vv, mask))

    lens = torch.tensor([1, 37, 128, 200, 333, 511, 512, 0],
                        dtype=torch.int32, device="cuda")
    live = lens > 0
    # the prefix cache's append admission: a 16-row suffix over cached
    # prefixes of 0 to 496 positions
    plen = torch.tensor([0, 16, 112, 127, 208, 300, 480, 496],
                        dtype=torch.int32, device="cuda")
    tlen = plen + 16
    qpos = plen[:, None] + torch.arange(16, device="cuda")[None]
    for dt, tol, pre in ((bf16, BF16_TOL, ""), (fp32, FP32_TOL, "fp32 ")):
        elt = torch.tensor([], dtype=dt).element_size()
        kp, vp, bt = pages(lens.tolist(), dt)
        q = torch.randn((8, 1, h, d), generator=gen, device="cuda").to(dt)

        def run():
            return PA.paged_decode_attention(q, kp, vp, bt, lens)

        def plain():
            return ref.paged_decode_attention_ref(q, kp, vp, bt, lens)
        got, want = run(), plain()
        torch.cuda.synchronize()
        shape = f"{pre}decode B=8 lens 1..512 32/8 heads hd128"
        err = check_close(f"paged_attention {shape}", got[live], want[live],
                          tol)
        if not (bool(torch.isfinite(got).all())
                and int(torch.count_nonzero(got[~live])) == 0):
            raise AssertionError("inactive slot output is not finite zeros")
        record("paged_attention", shape, err, timer.ms(run), timer.ms(plain),
               PA.paged_kv_bytes(lens.cpu().numpy(), ps, hkv, d, elt, 0)
               + 2 * q.numel() * elt + bt.numel() * 4,
               4 * int(lens.sum()) * h * d, dt,
               library_ms(q, kp, vp, bt, (lens - 1)[:, None]))

        kp, vp, bt = pages(tlen.tolist(), dt)
        q = torch.randn((8, 16, h, d), generator=gen, device="cuda").to(dt)

        def run():
            return PA.paged_prefill_append_attention(q, kp, vp, bt, plen,
                                                     tlen)

        def plain():
            return ref.paged_prefill_append_ref(q, kp, vp, bt, plen, tlen)
        got, want = run(), plain()
        torch.cuda.synchronize()
        shape = f"{pre}prefill-append B=8 S=16 prefix 0..496 32/8 heads hd128"
        err = check_close(f"paged_attention {shape}", got, want, tol)
        record("paged_attention", shape, err, timer.ms(run), timer.ms(plain),
               PA.paged_kv_bytes(tlen.cpu().numpy(), ps, hkv, d, elt, 0)
               + 2 * q.numel() * elt + bt.numel() * 4,
               4 * int((qpos + 1).sum()) * h * d, dt,
               library_ms(q, kp, vp, bt, qpos))
        del kp, vp


def family_cfg(arch, **over):
    """``arch`` at full width, the depth of ``FAMILY_LAYERS`` unless
    ``over`` says otherwise, BCR keep 0.25 with 128x128 blocks; jamba's
    random weights drawn in bf16 (its 8 layers hold ~13.3 B parameters:
    53 GB as fp32, 26.6 GB as bf16)."""
    from repro_torch.configs import get_config
    over.setdefault("num_layers", FAMILY_LAYERS[arch])
    if arch == "jamba-v0.1-52b":
        over.setdefault("param_dtype", "bfloat16")
    return dataclasses.replace(get_config(arch), bcr_keep_frac=0.25,
                               bcr_block=(128, 128), **over)


def build_family_params(torch, arch):
    """One random draw (seed 0) of ``family_cfg(arch)``, packed bf16."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (pack_params, packed_fraction,
                                          tree_bytes)
    from repro_torch.models import causal_lm
    from repro_torch.tree import leaves

    cfg = family_cfg(arch)
    plan = causal_lm.layer_plan(cfg)
    log(f"{arch}: depth {get_config(arch).num_layers} -> {cfg.num_layers} "
        f"layers {plan}; full width: d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, {cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}"
        + (f", {cfg.num_experts} experts top-{cfg.top_k} of d_ff "
           f"{cfg.moe_d_ff}, mamba d_in {cfg.mamba_expand * cfg.d_model} "
           f"d_state {cfg.mamba_d_state} dt_rank {cfg.mamba_dt_rank}"
           if cfg.num_experts else "")
        + f"; random weights in {cfg.param_dtype}")
    t0 = time.perf_counter()
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    dense_bytes = tree_bytes(dense)
    n_params = sum(t.numel() for t in leaves(dense))
    params = pack_params(cfg, dense)
    frac = packed_fraction(dense, params)
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{arch}: {n_params / 1e9:.3f} B parameters ({dense_bytes / 1e9:.2f} "
        f"GB dense), init + pack {time.perf_counter() - t0:.1f} s; packed "
        f"fraction {frac:.4f}; device memory in use "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return cfg, params, frac


def _state_bytes(engine) -> int:
    """Bytes of the pool's recurrent state (slot leaves): a decode step
    reads and writes each once."""
    pool = engine.pool
    return sum(layer[k].numel() * layer[k].element_size()
               for layer, ks in zip(pool.cache, pool.slot_keys) for k in ks)


def phase_family_serving(torch, np, arch, cfg, params, frac):
    """Phase 14a/b/c: phase 4's traffic through the port's engine at full
    width (pixtral with the prefix cache on; rwkv on the capacity-dense
    pool; jamba on a paged pool with slot leaves), the counters zeroed
    before and read after; the kernels each family's decode runs must have
    launched; a profiled decode window; the decode byte floor."""
    from repro_torch.launch.serve import tree_bytes
    from repro_torch.serving import EngineConfig, InferenceEngine

    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0,
                      prefix_cache=arch == "pixtral-12b")
    label = {"pixtral-12b": "phase 14a", "rwkv6-3b": "phase 14b",
             "jamba-v0.1-52b": "phase 14c"}[arch] + f" {arch} bf16"
    stats, launches, traj, engine = serve_main_path(torch, np, cfg, params,
                                                    ec, label, frac)
    want_pool = "SlotPool" if arch == "rwkv6-3b" else "PagedSlotPool"
    if type(engine.pool).__name__ != want_pool:
        raise AssertionError(f"{label}: pool {type(engine.pool).__name__}, "
                             f"want {want_pool}")
    missing = [k for k in FAMILY_KERNELS[arch] if not launches[k]]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched: "
                             f"{launches}")
    if arch == "rwkv6-3b" and any(launches[k] for k in launches
                                  if k.startswith(("paged", "flash"))):
        raise AssertionError(f"{label}: attention kernels launched on an "
                             f"attention-free model: {launches}")
    if arch == "jamba-v0.1-52b":
        _expert_checks(cfg, stats, launches, label, False)
    state = _state_bytes(engine)
    weights = stats["packed_weight_bytes"]
    floor_ms = (weights + 2 * state) / HBM_BYTES_PER_S * 1e3
    prof = stats["decode_profile"]
    summary = dict(
        tokens_per_s=stats["tokens_per_s"], ttft_ms_p50=stats["ttft_ms_p50"],
        decode_step_ms_p50=stats["decode_step_ms_p50"],
        decode_steps=stats["decode_steps"], prefills=stats["prefills"],
        device_ms_per_step=prof["device_ms"], busy_share=prof["busy_share"],
        by_family_ms=prof["by_family_ms"],
        device_launches_per_step=prof["device_launches_per_step"],
        host_ops_per_step=prof["host_ops_per_step"],
        mixer_host_ms_cprofile={k: prof["host_fn_ms_cprofile"][k]
                                for k in MIXER_FUNCTIONS + ("step",)},
        resident_weight_bytes=tree_bytes(params),
        streamed_weight_bytes=weights, recurrent_state_bytes=state,
        decode_floor_ms=floor_ms, kv_row_bytes=engine._kv_row_bytes,
        launches={k: v for k, v in launches.items() if v})
    log(f"{label} summary: " + json.dumps(summary))
    del engine
    return summary, launches


def phase_image_prefill(torch, np, cfg, params):
    """Phase 14a's direct ``prefill`` with ``image_embeds`` through
    ``model_fns``: B 2, 256 image positions (random patch embeddings at the
    embedding table's scale) then 256 text tokens; its logits finite, of
    shape (2, 1, vocab), against the same prefill with the plain BCR
    versions on the same card tensors (5e-2 x the logit scale, as phase 4's
    append-vs-cold: four bf16 layers apart), and moved by the image."""
    from repro_torch.models.api import model_fns

    fns = model_fns(cfg)
    rng = np.random.default_rng(11)
    p = cfg.num_image_tokens
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 2 * p)),
                           dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    img = (torch.randn((2, p, cfg.d_model), generator=gen, device="cuda")
           * cfg.d_model ** -0.5).to(cfg.act_dtype)
    batch = {"tokens": toks, "image_embeds": img}
    zero_counters()
    got, _ = fns.prefill(params, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counters().items() if v}
    with plain_kernels():
        want, _ = fns.prefill(params, batch)
        zero = {k: v for k, v in read_counters().items() if v}
    if zero != launches:
        raise AssertionError(f"the plain prefill launched kernels: {zero}")
    no_img, _ = fns.prefill(params, {"tokens": toks})
    if tuple(got.shape) != (2, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"image prefill logits {tuple(got.shape)} "
                             f"not finite of shape (2, 1, vocab)")
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    moved = float((got.float() - no_img.float()).abs().max())
    log(f"phase 14a image prefill (B 2, {p} image + {p} text positions): "
        f"launches {launches}, max |kernel - plain| {err:.3e} of {scale:.3g}, "
        f"argmax equal {bool(torch.equal(got.argmax(-1), want.argmax(-1)))}, "
        f"max |image - no image| {moved:.3g}")
    if err > 5e-2 * scale or moved <= 0:
        raise AssertionError("phase 14a: the image prefill disagrees with "
                             "its plain version or ignores the image")
    return err


def phase_family_exactness(torch, np):
    """Phase 14d, fp32 on the card: the engine's greedy tokens against the
    naive ``generate`` under phase 6's 1e-4 near-tie rule for pixtral and
    rwkv6-3b at full width and 2 layers (block 128, keep 0.25; pixtral
    with the prefix cache on and a repeated prompt) and jamba at its SMOKE
    width with 8 layers (block 16, keep 0.25, capacity_factor 8.0: no
    token dropped, so batch composition cannot move one), which is also
    served under preemption in a tight page pool and through
    ``recover()``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import build_params
    from repro_torch.serving import FINISHED, EngineConfig, InferenceEngine

    gen = 16
    ties = {}
    for arch in ("pixtral-12b", "rwkv6-3b", "jamba-v0.1-52b"):
        if arch == "jamba-v0.1-52b":
            cfg = dataclasses.replace(
                get_smoke_config(arch), dtype="float32",
                cache_dtype="float32", bcr_keep_frac=0.25,
                bcr_block=(16, 16), capacity_factor=8.0)
        else:
            cfg = family_cfg(arch, num_layers=2, dtype="float32")
        params = build_params(cfg, seed=1, device="cuda", log=log)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (32, 77, 128, 300)]
        prompts.append(prompts[2].copy())
        engine = InferenceEngine(cfg, params, EngineConfig(
            n_slots=2, capacity=640, page_size=16, seed=0,
            prefix_cache=True), device="cuda")
        got = engine.generate(prompts, max_new_tokens=gen)
        engine.check_conservation()
        n = near_tie_check(torch, cfg, params, prompts, got, gen, 1e-4,
                           f"phase 14d {arch}")
        ties[arch] = n
        log(f"phase 14d {arch} engine vs naive generate (fp32, "
            f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{type(engine.pool).__name__}, prefix cache "
            f"{engine.prefix_cache}, hit tokens "
            f"{engine.stats['prefix_hit_tokens']}): tokens equal, "
            f"near-ties {n}")
        if arch != "jamba-v0.1-52b":
            del params, engine
            torch.cuda.empty_cache()
            continue
        # phase 9b's tight pool: A (3 pages) and B (4) fill 7 pages; C (3)
        # stalls and B is preempted, its mamba state re-prefilled
        pa, pb, pc = (rng.integers(0, cfg.vocab_size, size=n)
                      .astype(np.int32) for n in (32, 48, 32))
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=3, capacity=640, page_size=16, seed=0, kv_pages=8,
            preempt_after_stalls=1), device="cuda")
        rids = [eng.submit(pa, max_new_tokens=gen),
                eng.submit(pb, max_new_tokens=gen)]
        for _ in range(3):
            eng.step()
        rids += [eng.submit(pc, max_new_tokens=gen),
                 eng.submit(pa.copy(), max_new_tokens=gen)]
        done = {r.rid: r for r in eng.run()}
        if eng.stats["preemptions"] < 1 or any(
                done[r].status != FINISHED for r in rids):
            raise AssertionError(f"phase 14d jamba preemption: {eng.stats}")
        eng.check_conservation()
        eng.pool.check_consistency()
        preempted = eng.stats["preemptions"]
        n_pre = near_tie_check(torch, cfg, params, [pa, pb, pc, pa],
                               [done[r].generated for r in rids], gen, 1e-4,
                               "phase 14d jamba preemption")
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=3, capacity=640, page_size=16, seed=0), device="cuda")
        rids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
        for _ in range(4):
            eng.step()
        survivors = eng.recover()
        done = {r.rid: r for r in eng.run()}
        eng.check_conservation()
        eng.pool.check_consistency()
        n_rec = near_tie_check(torch, cfg, params, prompts,
                               [done[r].generated for r in rids], gen, 1e-4,
                               "phase 14d jamba recover")
        log(f"phase 14d jamba: preemption in a 7-page pool ({preempted} "
            f"preempted) and recover() ({survivors} requeued) give the "
            f"naive tokens, near-ties {n_pre} + {n_rec}")
    return ties


def phase_families(torch, np):
    """Phase 14: (a) pixtral-12b, (b) rwkv6-3b, (c) jamba-v0.1-52b served at
    full width, then (d) the fp32 exactness checks. Returns each kernel's
    launches over the three serving runs (a)-(c)."""
    t0 = time.perf_counter()
    total, summaries, times = {}, {}, {}
    for arch in ("pixtral-12b", "rwkv6-3b", "jamba-v0.1-52b"):
        ts = time.perf_counter()
        cfg, params, frac = build_family_params(torch, arch)
        summaries[arch], launches = phase_family_serving(torch, np, arch,
                                                         cfg, params, frac)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if arch == "pixtral-12b":
            phase_image_prefill(torch, np, cfg, params)
        del params
        torch.cuda.empty_cache()
        times[arch] = time.perf_counter() - ts
    ts = time.perf_counter()
    phase_family_exactness(torch, np)
    torch.cuda.empty_cache()
    log(f"phase 14: (a) {times['pixtral-12b']:.1f} s, (b) "
        f"{times['rwkv6-3b']:.1f} s, (c) {times['jamba-v0.1-52b']:.1f} s, "
        f"(d) {time.perf_counter() - ts:.1f} s; "
        f"{time.perf_counter() - t0:.1f} s in all")
    return total


# phase 15: whisper-large-v3 at full width, 8 utterances of its 1500 frames,
# a 4-token prompt, its 448-position text context (arXiv:2212.04356), 32
# greedy tokens; 15c's fp32 exactness at 2 + 2 layers and 4 utterances
ENC_ARCH = "whisper-large-v3"
ENC_UTTS, ENC_PROMPT, ENC_CAPACITY, ENC_GEN = 8, 4, 448, 32
ENC_FP32_LAYERS, ENC_FP32_UTTS, ENC_FP32_GEN = 2, 4, 16
# the port's functions whose host time phase 15's decode profile reports
ENC_HOST_FUNCTIONS = ("decode_step", "attention_apply", "_qkv",
                      "cross_attention_apply", "decode_attention",
                      "gelu_mlp_apply", "layernorm", "_dense_write",
                      "bcr_spmm", "bcr_spmm_grouped")


def encdec_cases(torch, timer, gen, record):
    """Phase 3's cases at the shapes phase 15 gives the kernels, bf16 x,
    fp and int8 tiles (:func:`projection_cases`): whisper-large-v3's
    ``lm_head`` (51866 x 1280: ``choose_block_shape`` takes (2, 128)
    blocks, so each kept tile is ONE row of 64 columns) at M = 8 and 32;
    the 1280 x 1280 single projections (self ``wo``, cross ``wq`` and
    ``wo``: 10 x 10 blocks) at M = 8 (a decode step), 32 (the decoder's
    prefill of 8 x 4 prompt tokens) and 12000 (the encoder's ``wo`` over 8
    utterances x 1500 frames); the self-attention's ``wqkv`` (3 x 1280 x
    1280) and the cross-attention's ``wkv`` (2 x 1280 x 1280), each with
    its (G, N) bias in the emit step, and the MLP's ``wi`` (5120 x 1280)
    and ``wo`` (1280 x 5120), at M = 8 and 12000. Then both
    ``flash_attention_fused`` shapes of a 15b prefill, B·H = 8 x 20,
    head_dim 64, chunks 1500: the encoder's non-causal S = 1500 (no
    multiple of the kernel's key tile) and the decoder's causal S = 4 over
    the prompt. Each against its plain version (2e-2 x the output scale),
    timed beside it, the library call (dense ``x @ W.T`` plus bias, or
    SDPA) and the bound."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    bf16 = torch.bfloat16
    log("phase 15's kernel shapes: whisper-large-v3's projections, bf16 x, "
        "keep 0.25 (lm_head on (2, 128) blocks: R_keep = 1)")
    projection_cases(torch, timer, gen, record, [
        ("whisper", "lm_head", 51866, 1280, 1, None, (8, 32), bf16, False,
         True),
        ("whisper", "wo|cross wq", 1280, 1280, 1, None, (8, 32, 12000),
         bf16, False, True),
        ("whisper", "wqkv+bias", 1280, 1280, 3, None, (8, 12000), bf16,
         True, True),
        ("whisper", "cross wkv+bias", 1280, 1280, 2, None, (8, 12000), bf16,
         True, True),
        ("whisper", "mlp wi", 5120, 1280, 1, None, (8, 12000), bf16, False,
         True),
        ("whisper", "mlp wo", 1280, 5120, 1, None, (8, 12000), bf16, False,
         True)])

    b, h, d, chunk = ENC_UTTS, 20, 64, 1500
    kw = dict(q_chunk=chunk, kv_chunk=chunk)
    for causal, s in ((False, chunk), (True, ENC_PROMPT)):
        log(f"phase 15's {'decoder' if causal else 'encoder'} attention: "
            f"flash_attention_fused {'' if causal else 'non-'}causal, B*H "
            f"= {b}*{h}, S = {s}, head_dim {d}, chunks {chunk} (bf16)")
        q, k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda")
                   .to(bf16) for _ in range(3))
        got = FA.flash_attention_fused(q, k, v, causal=causal, **kw)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        shape = f"{'' if causal else 'non-'}causal BH={b * h} S={s}"
        err = check_close(f"flash {shape}", got, want, BF16_TOL)
        q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
        # (q, k) pairs the function needs: under causal, row i sees keys
        # 0 .. i
        pairs = s * (s + 1) // 2 if causal else s * s
        record("flash_attention_fused", shape, err,
               timer.ms(lambda: FA.flash_attention_fused(
                   q, k, v, causal=causal, **kw)),
               timer.ms(lambda: ref.flash_attention_ref(q, k, v,
                                                        causal=causal)),
               4 * b * h * s * d * 2, 4 * b * h * pairs * d, bf16,
               timer.ms(lambda: _library_sdpa(torch, q4, k4, v4, None,
                                              is_causal=causal)))
        del q, k, v, got, want, q4, k4, v4
    torch.cuda.empty_cache()


def encdec_cfg(**over):
    """whisper-large-v3 at full width (and depth, unless ``over`` cuts it),
    BCR keep 0.25 with 128x128 blocks."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ENC_ARCH), bcr_keep_frac=0.25,
                               bcr_block=(128, 128), **over)


def build_encdec_params(torch):
    """One random draw (seed 0) of whisper-large-v3, packed twice: bf16
    tiles (15a) and int8 tiles (15b)."""
    from repro_torch.launch.serve import (pack_params, packed_fraction,
                                          tree_bytes)
    from repro_torch.models import encdec
    from repro_torch.tree import leaves

    cfg = encdec_cfg()
    log(f"{ENC_ARCH}: {cfg.encoder_layers} encoder + {cfg.num_layers} "
        f"decoder layers (nothing cut), d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.encoder_seq} frames")
    t0 = time.perf_counter()
    dense = encdec.init_params(cfg, 0, device="cuda")
    dense_bytes = tree_bytes(dense)
    n_params = sum(t.numel() for t in leaves(dense))
    params = pack_params(cfg, dense)
    params_q = pack_params(cfg, dense, weight_dtype="int8")
    fracs = packed_fraction(dense, params), packed_fraction(dense, params_q)
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"{ENC_ARCH}: {n_params / 1e9:.3f} B parameters ({dense_bytes / 1e9:.2f}"
        f" GB dense fp32), init + 2 packs {time.perf_counter() - t0:.1f} s; "
        f"packed fraction bf16 {fracs[0]:.4f}, int8 {fracs[1]:.4f}; device "
        f"memory in use {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return cfg, params, params_q, fracs


def encdec_inputs(torch, np, cfg, utts, seed=0):
    """Seeded frame embeddings ``(utts, 1500, d_model)`` (the stub
    frontend's output) and a prompt of ``ENC_PROMPT`` tokens."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    frames = torch.randn((utts, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.act_dtype)
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(utts, ENC_PROMPT)),
                             dtype=torch.int32, device="cuda")
    return frames, prompt


def encdec_decode(torch, fns, params, cache, prompt, gen_tokens):
    """Prime the prompt's self K/V through ``decode_step`` (one token a
    step, as the reference's launchers do), then decode greedily:
    ``gen_tokens`` tokens, the first from the last primed step. Each
    step's wall ends in the token's copy to the host. Returns the tokens
    ``(B, gen_tokens)``, the logits each was taken from, and the walls of
    the ``gen_tokens - 1`` greedy steps."""
    b, p = prompt.shape

    def lens(n):
        return torch.full((b,), n, dtype=torch.int32, device="cuda")

    for i in range(p):
        logits, cache = fns.decode_step(params, {
            "tokens": prompt[:, i:i + 1], "cache_len": lens(i)}, cache)
    step_logits = [logits[:, -1].float()]
    tok = step_logits[-1].argmax(-1).to(torch.int32)
    toks, walls = [tok.cpu()], []
    for j in range(gen_tokens - 1):
        t0 = time.perf_counter()
        logits, cache = fns.decode_step(params, {
            "tokens": tok[:, None], "cache_len": lens(p + j)}, cache)
        step_logits.append(logits[:, -1].float())
        tok = step_logits[-1].argmax(-1).to(torch.int32)
        toks.append(tok.cpu())
        walls.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(toks, 1), torch.stack(step_logits, 1), walls


def encdec_step_launches(params) -> tuple:
    """``(bcr_spmm, bcr_spmm_grouped)`` launches one decode step must make
    over a packed tree: every packed linear the step reads (self
    attention, the cross attention's Q and output — its K/V were computed
    at prefill — the MLP) and ``lm_head``; a fused group is one launch."""
    single = grouped = 0
    reads = {"self_attn": ("wq", "wk", "wv", "wkv", "wqkv", "wo"),
             "cross_attn": ("wq", "wo"), "mlp": ("wi", "wo")}
    for lp in params["dec_layers"]:
        for block, keys in reads.items():
            for key in keys:
                entry = lp[block].get(key, {})
                single += "w_packed" in entry
                grouped += "w_group" in entry
    return single + ("w_packed" in params["lm_head"]), grouped


def encdec_prefill_device_ms(torch, fns, params, batch) -> float:
    """Device time of one ``prefill`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fns.prefill(params, batch)
        torch.cuda.synchronize()
    return sum(ms for _, _, ms in device_events(torch, prof))


def phase_encdec_serve(torch, cfg, params, frac, label, frames, prompt,
                       forms):
    """Phase 15a / 15b: ``prefill`` of 8 utterances (wall and device
    time), the cross K/V seated into ``init_cache(8, 448)``, the prompt
    primed and 32 greedy tokens through ``decode_step``: the counters
    zeroed before and read after the run; one decode step's launches
    between zeroed counters against what the packed tree implies; a
    profiled window of 5 steps; resident weight and cross-K/V bytes; the
    decode byte floor. ``forms`` names the counter keys the run must move
    (fp or int8 BCR forms); every other BCR form must stay at 0. Returns
    (summary, launches over the run, the greedy tokens)."""
    from repro_torch.launch.serve import tree_bytes
    from repro_torch.models.api import model_fns

    fns = model_fns(cfg)
    single_key, grouped_key = forms
    batch = {"frames": frames, "tokens": prompt}
    fns.prefill(params, batch)            # warm-up: kernels loaded, plans
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    logits, cross = fns.prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {k: v for k, v in read_counters().items() if v}
    cache = fns.init_cache(ENC_UTTS, ENC_CAPACITY, device="cuda")
    for key in ("cross_k", "cross_v"):
        cache[key].copy_(cross[key])
    del cross
    toks, tok_logits, walls = encdec_decode(torch, fns, params, cache,
                                            prompt, ENC_GEN)
    torch.cuda.synchronize()
    launches = read_counters()
    if not (tuple(toks.shape) == (ENC_UTTS, ENC_GEN)
            and bool(torch.isfinite(tok_logits).all())
            and tuple(logits.shape) == (ENC_UTTS, 1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{label}: tokens {tuple(toks.shape)} or "
                             f"logits not finite of the expected shape")
    # the primed prompt's last step and the prefill give the same logits
    primed_err = float((tok_logits[:, 0] - logits[:, -1].float()).abs().max())
    pos = ENC_PROMPT + ENC_GEN - 1
    tok = toks[:, -1].to(device="cuda")

    def step():
        fns.decode_step(params, {"tokens": tok[:, None], "cache_len":
                                 torch.full((ENC_UTTS,), pos,
                                            dtype=torch.int32,
                                            device="cuda")}, cache)

    zero_counters()
    step()
    torch.cuda.synchronize()
    one = {k: v for k, v in read_counters().items() if v}
    want_single, want_grouped = encdec_step_launches(params)
    if one != {single_key: want_single, grouped_key: want_grouped}:
        raise AssertionError(f"{label}: one decode step launched {one}, the "
                             f"packed tree implies {single_key} "
                             f"{want_single}, {grouped_key} {want_grouped}")
    log(f"{label}: one decode step launched {one} (= 5 x "
        f"{cfg.num_layers} + 1 and {cfg.num_layers}: self wqkv grouped, "
        f"self wo, cross wq and wo, MLP wi and wo a layer, lm_head; no "
        f"paged or flash kernel)")
    prof = profile_window(torch, step, ENC_HOST_FUNCTIONS)
    weights = tree_bytes(params)
    cross_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in ("cross_k", "cross_v"))
    # a decode step streams the decoder's packed projections but the cross
    # K/V's (computed at prefill), the LayerNorms and lm_head, and reads
    # the whole cross cache and the live self K/V
    streamed = tree_bytes(params["lm_head"]) + tree_bytes(params["dec_norm"])
    for lp in params["dec_layers"]:
        streamed += tree_bytes({k: v for k, v in lp.items()
                                if k != "cross_attn"})
        streamed += tree_bytes({k: v for k, v in lp["cross_attn"].items()
                                if k != "wkv"})
    self_bytes = 2 * cfg.num_layers * ENC_UTTS * (pos + 1) * (
        cfg.num_kv_heads * cfg.head_dim * cache["self_k"].element_size())
    floor_ms = (streamed + cross_bytes + self_bytes) / HBM_BYTES_PER_S * 1e3
    summary = dict(
        prefill_wall_ms=prefill_ms,
        prefill_device_ms=encdec_prefill_device_ms(torch, fns, params,
                                                   batch),
        prefill_launches=prefill_launches,
        decode_step_ms_p50=statistics.median(walls),
        decode_steps=len(walls), device_ms_per_step=prof["device_ms"],
        busy_share=prof["busy_share"], by_family_ms=prof["by_family_ms"],
        device_launches_per_step=prof["device_launches_per_step"],
        host_ops_per_step=prof["host_ops_per_step"],
        top_other=prof["top_other"],
        host_fn_ms_cprofile=prof["host_fn_ms_cprofile"],
        resident_weight_bytes=weights, packed_fraction=frac,
        cross_kv_bytes=cross_bytes, streamed_weight_bytes=streamed,
        self_kv_bytes=self_bytes, decode_floor_ms=floor_ms,
        primed_vs_prefill_max_abs=primed_err,
        launches={k: v for k, v in launches.items() if v})
    log(f"{label} summary: " + json.dumps(summary))
    bad = [k for k in read_counters() if k.startswith("bcr_spmm")
           and k not in forms and launches[k]]
    if bad or not all(launches[k] for k in forms):
        raise AssertionError(f"{label}: BCR forms launched {launches}; "
                             f"want only {forms}")
    return summary, launches, toks


def encdec_exactness(torch, np):
    """Phase 15c, fp32 on the card: whisper-large-v3 at full width, the
    depth cut to 2 + 2 layers, 4 utterances of 1500 frames, packed at keep
    0.25 (fp32 tiles: the CUDA-core bodies). ``prefill``'s logits equal
    ``decode_train``'s last row; the greedy tokens of stepwise
    ``decode_step`` equal the teacher-forced argmax of ``decode_train``
    over the same sequence under phase 6's 1e-4 near-tie rule; the packed
    forward (encoder and decoder) against the same forward with the plain
    BCR versions on the same card tensors (1e-4 x the output scale)."""
    from repro_torch.launch.serve import build_params
    from repro_torch.models import encdec
    from repro_torch.models.api import model_fns

    cfg = encdec_cfg(num_layers=ENC_FP32_LAYERS,
                     encoder_layers=ENC_FP32_LAYERS, dtype="float32",
                     cache_dtype="float32")
    log(f"phase 15c: depth {encdec_cfg().encoder_layers} + "
        f"{encdec_cfg().num_layers} -> {cfg.encoder_layers} + "
        f"{cfg.num_layers} layers, fp32, {ENC_FP32_UTTS} utterances of "
        f"{cfg.encoder_seq} frames")
    params = build_params(cfg, seed=1, device="cuda", log=log)
    fns = model_fns(cfg)
    frames, prompt = encdec_inputs(torch, np, cfg, ENC_FP32_UTTS, seed=1)
    with torch.no_grad():
        zero_counters()
        logits, cross = fns.prefill(params, {"frames": frames,
                                             "tokens": prompt})
        enc = encdec.encode(cfg, params, frames)
        full = encdec.decode_train(cfg, params, prompt, enc)
        torch.cuda.synchronize()
        launched = {k: v for k, v in read_counters().items() if v}
        err_p = check_close("phase 15c prefill logits vs decode_train's "
                            "last row", logits, full[:, -1:], FP32_TOL)
        cache = fns.init_cache(ENC_FP32_UTTS, ENC_CAPACITY, device="cuda")
        cache.update(cross)
        toks, _, _ = encdec_decode(torch, fns, params, cache, prompt,
                                   ENC_FP32_GEN)
        seq = torch.cat([prompt, toks.to(device="cuda",
                                         dtype=torch.int32)], dim=1)
        tf = encdec.decode_train(cfg, params, seq[:, :-1], enc)[
            :, ENC_PROMPT - 1:].float()
        picks = tf.argmax(-1).cpu()
        near, gaps = 0, [0.0]
        for b, j in zip(*torch.nonzero(picks != toks, as_tuple=True)):
            top = float(tf[b, j].max())
            rel = (top - float(tf[b, j, toks[b, j]])) / max(abs(top), 1e-30)
            if rel >= 1e-4:
                raise AssertionError(
                    f"phase 15c: stepwise token {int(toks[b, j])} at step "
                    f"{int(j)} of utterance {int(b)}, teacher-forced "
                    f"argmax {int(picks[b, j])}: relative gap {rel:.3e}")
            near += 1
            gaps.append(rel)
        zero_counters()
        with plain_kernels():
            enc_plain = encdec.encode(cfg, params, frames)
            full_plain = encdec.decode_train(cfg, params, prompt, enc_plain)
            plain_launched = {k: v for k, v in read_counters().items() if v}
        if plain_launched:
            raise AssertionError(f"phase 15c: the plain forward launched "
                                 f"kernels: {plain_launched}")
        err_e = check_close("phase 15c packed encoder vs plain BCR", enc,
                            enc_plain, FP32_TOL)
        err_d = check_close("phase 15c packed decode_train vs plain BCR",
                            full, full_plain, FP32_TOL)
    log(f"phase 15c: prefill launched {launched}; prefill vs decode_train "
        f"{err_p:.3e}; stepwise decode_step = teacher-forced decode_train "
        f"for {ENC_FP32_UTTS} x {ENC_FP32_GEN} tokens, near-ties {near} "
        f"(largest gap {max(gaps):.3e}); packed vs plain encoder "
        f"{err_e:.3e}, decoder {err_d:.3e}")
    del params, cache, cross
    torch.cuda.empty_cache()
    return near


def flip_picks(torch, cfg, params, enc, traj):
    """Greedy picks of ``decode_train`` over a fixed trajectory at its
    generated positions."""
    from repro_torch.models import encdec
    with torch.no_grad():
        return encdec.decode_train(cfg, params, traj, enc)[
            :, ENC_PROMPT - 1:].float().argmax(-1)


def run_phase_encdec(torch, np) -> dict:
    """Phase 15d's kernel cases, then phase 15 (a)-(c). Returns each
    kernel's launches over 15a's run (the fp forms) and 15b's (the int8
    forms and flash), the kernels line's ``encdec_launches``."""
    log("phase 15's kernel shapes (phase 3's checks)")
    t0 = time.perf_counter()
    rows, timer = [], Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    encdec_cases(torch, timer, gen, recorder(torch, rows))
    log("phase 15 kernel cases: " + json.dumps(rows))
    del timer
    torch.cuda.empty_cache()
    log(f"phase 15d kernel shapes: {time.perf_counter() - t0:.1f} s")
    log(f"phase 15, the encdec family ({ENC_ARCH}: encoder, cross-attention "
        f"decoder)")
    t0 = time.perf_counter()
    launches_a, launches_b = phase_encdec(torch, np)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return {k: (launches_b if "int8" in k or k.startswith("flash")
                else launches_a)[k] for k in launches_a
            if launches_a[k] or launches_b[k]}


def phase_encdec(torch, np):
    """Phase 15: (a) bf16 and (b) int8 tiles with the flash encoder at full
    width and depth, then (c) the fp32 exactness checks. Returns each
    kernel's launches over the (a) and (b) runs."""
    from repro_torch.models import encdec
    from repro_torch.models import layers as L

    times = {}
    ts = time.perf_counter()
    cfg, params, params_q, fracs = build_encdec_params(torch)
    frames, prompt = encdec_inputs(torch, np, cfg, ENC_UTTS)
    _, launches_a, toks_a = phase_encdec_serve(
        torch, cfg, params, fracs[0], "phase 15a whisper-large-v3 bf16",
        frames, prompt, ("bcr_spmm", "bcr_spmm_grouped"))
    if launches_a["flash_attention_fused"] or any(
            v for k, v in launches_a.items() if k.startswith("paged")):
        raise AssertionError(f"phase 15a: attention kernels launched under "
                             f"attn_impl {cfg.attn_impl!r}: {launches_a}")
    with torch.no_grad():
        enc_a = encdec.encode(cfg, params, frames)
    times["a"] = time.perf_counter() - ts

    ts = time.perf_counter()
    cfg_q = dataclasses.replace(cfg, attn_impl="pallas",
                                q_chunk=cfg.encoder_seq,
                                kv_chunk=cfg.encoder_seq)
    summary_b, launches_b, _ = phase_encdec_serve(
        torch, cfg_q, params_q, fracs[1],
        "phase 15b whisper-large-v3 int8 tiles + flash encoder", frames,
        prompt, ("bcr_spmm_int8", "bcr_spmm_grouped_int8"))
    # a prefill runs flash once per encoder layer (non-causal, 1500 frames)
    # and once per decoder layer (causal, over the prompt): the reference's
    # prefill runs attention_apply under attn_impl in both stacks
    want_flash = cfg.encoder_layers + cfg.num_layers
    got_flash = summary_b["prefill_launches"].get("flash_attention_fused")
    if got_flash != want_flash:
        raise AssertionError(f"phase 15b: {got_flash} flash launches a "
                             f"prefill, want {want_flash}")
    cfg_plain = dataclasses.replace(cfg_q, attn_impl="dense")
    with torch.no_grad():
        zero_counters()
        enc_q = encdec.encode(cfg_q, params_q, frames)
        torch.cuda.synchronize()
        enc_flash = read_counters()["flash_attention_fused"]
        enc_plain = encdec.encode(cfg_plain, params_q, frames)
        # the flash kernel held to plain attention in every encoder layer:
        # the attention sublayer's own output on that layer's real normed
        # input (the plain stack's). The whole encoder's gap is printed,
        # not gated: a 32-deep bf16 stack compounds two valid roundings
        x = encdec.embed_frames(cfg_q, frames)
        layer_errs, scales = [], []
        for i, lp in enumerate(params_q["enc_layers"]):
            h = L.layernorm(lp["norm1"], x, cfg.norm_eps)
            want = encdec.encoder_attention(cfg_plain, lp, h)
            layer_errs.append(check_close(
                f"phase 15b encoder layer {i} attention: flash vs plain",
                encdec.encoder_attention(cfg_q, lp, h), want, BF16_TOL,
                quiet=True))
            scales.append(float(want.float().abs().max()))
            x = encdec.encoder_layer(cfg_plain, lp, x)
    stack_err = float((enc_q.float() - enc_plain.float()).abs().max())
    cross_err = float((enc_q.float() - enc_a.float()).abs().max())
    if enc_flash != cfg.encoder_layers:
        raise AssertionError(f"phase 15b: the encoder launched flash "
                             f"{enc_flash} times")
    worst = layer_errs.index(max(layer_errs))
    log(f"phase 15b: flash vs plain attention, int8 tiles both: every "
        f"encoder layer's attention output within {BF16_TOL} x its scale "
        f"on the same normed input (largest max |diff| "
        f"{layer_errs[worst]:.3e} of scale {scales[worst]:.3g}, layer "
        f"{worst}; scales {min(scales):.3g} to {max(scales):.3g}); the "
        f"whole {cfg.encoder_layers}-layer encoder max |diff| "
        f"{stack_err:.3e} of scale "
        f"{float(enc_plain.float().abs().max()):.3g} (not gated)")
    del enc_plain
    # teacher-forced flip rate: 15a's trajectories (prompt + tokens)
    # through decode_train on both paths, the greedy picks at the 32
    # generated positions compared
    traj = torch.cat([prompt, toks_a.to(device="cuda", dtype=torch.int32)],
                     dim=1)[:, :-1]
    picks_a = flip_picks(torch, cfg, params, enc_a, traj)
    picks_q = flip_picks(torch, cfg_q, params_q, enc_q, traj)
    flips = int((picks_a != picks_q).sum())
    log(f"phase 15b: the encoder launched flash {enc_flash} times (one a "
        f"layer); int8 + flash encoder vs 15a's bf16 plain encoder max "
        f"|diff| {cross_err:.3e} of scale "
        f"{float(enc_a.float().abs().max()):.3g} (not gated: int8 tiles "
        f"against bf16); teacher-forced flip rate, int8 + flash vs bf16 on "
        f"15a's trajectories: {flips}/{picks_a.numel()} = "
        f"{flips / picks_a.numel():.4f} (not gated)")
    del params, params_q, enc_a, enc_q, frames
    torch.cuda.empty_cache()
    times["b"] = time.perf_counter() - ts

    ts = time.perf_counter()
    encdec_exactness(torch, np)
    times["c"] = time.perf_counter() - ts
    log(f"phase 15: (a) {times['a']:.1f} s, (b) {times['b']:.1f} s, (c) "
        f"{times['c']:.1f} s")
    return launches_a, launches_b


# -- phase 16: training for every family that serves, on the card -----------

# (label, arch, depth or None for all, SMOKE config, the ShapeSpec of its
# synth_inputs batches or None for train_loop's markov batches). Depths
# are cut so the training state (24 B a parameter by arithmetic: fp32
# params, grads, m, v, Z, U) fits one 80 GB card: whisper-large-v3 whole,
# 1.64 B (~39.5 GB); deepseek-moe-16b 4 of 28 layers, ~2.2 B (~53 GB);
# rwkv6-3b 4 of 32, ~0.8 B (32 would need ~75 GB; its WKV scan, a token
# at a time and host-bound, took 160 s of the run at 16 layers and 85 s
# at 8, which keeps the run inside its time limit); pixtral-12b 2
# of 40, ~1.9 B (~45 GB); jamba at its SMOKE config, fp32: at full width
# one MoE layer alone is 16 x 3 x 4096 x 14336 = 2.8 B parameters, ~68 GB
# of state, so no full-width period of 8 layers fits one card
TRAIN_FAMILIES = (
    ("16a", "whisper-large-v3", None, False, ("whisper_train", 1500, 8)),
    ("16b", "deepseek-moe-16b", 4, False, None),
    ("16c", "rwkv6-3b", 4, False, None),
    ("16d", "pixtral-12b", 2, False, ("pixtral_train", 512, 8)),
    ("16e", "jamba-v0.1-52b", None, True, None),
)
# the kernel forms a packed tree runs: every packed projection; a fused
# group (Q/K/V, K/V, gate/up) outside the experts; the stacked experts
TRAIN_PACKED_KERNELS = (("['w_packed']", "bcr_spmm"),
                        ("['w_group']", "bcr_spmm_grouped"),
                        ("['experts']", "bcr_spmm_experts"),
                        ("['experts']", "bcr_spmm_grouped_experts"))


def train_family_cfg(arch, layers, smoke):
    """``arch`` at full width (or its SMOKE config), the depth cut to
    ``layers`` where given, BCR keep 0.25 on 128 x 128 blocks (16 x 16 at
    SMOKE width, where 128 prunes nothing), the config's own dtypes and
    ``grad_accum``."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if smoke else get_config)(arch)
    over = dict(bcr_keep_frac=0.25,
                bcr_block=(16, 16) if smoke else (128, 128))
    if layers is not None:
        over["num_layers"] = layers
    return dataclasses.replace(cfg, **over)


def synth_train_loop(torch, cfg, shape, tc, log=log):
    """Phase 7's schedule over ``synth_inputs`` batches (seed = step): the
    port's ``init_state``, ``make_train_step``, ``admm_init``,
    ``admm_dual_update`` and ``finalize`` in ``train_loop``'s order and with
    its defaults. ``train_loop`` feeds token batches only, as the
    reference's does (ROADMAP §3), so a family whose loss reads ``frames``
    (encdec) or ``image_embeds`` (vlm) trains through this loop. Returns
    what ``train_loop`` returns."""
    from repro_torch.core import admm as A
    from repro_torch.launch.train import (TrainState, default_prune_filter,
                                          init_state, make_train_step)
    from repro_torch.models.api import synth_inputs
    from repro_torch.optim import adamw

    opt_cfg = adamw.AdamWConfig(lr=1e-3,
                                warmup_steps=min(20, tc.steps // 5 + 1),
                                total_steps=tc.steps)
    admm_cfg = A.ADMMConfig(steps_per_admm=max(tc.steps // 10, 5))
    state = init_state(cfg, tc.seed, tc.device)
    specs = A.specs_for(state.params, default_prune_filter(cfg))
    step_fn = make_train_step(cfg, opt_cfg, admm_cfg, specs)
    history, step_ms, phases = [], [], []
    transition_ms = {"dual_update": []}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if key == "dual_update":
            transition_ms[key].append(ms)
        else:
            transition_ms[key] = ms
        return out

    for step in range(tc.steps):
        if step == tc.admm_start:
            state = TrainState(state.params, state.opt, timed(
                "admm_init", lambda: A.admm_init(state.params, specs)), None)
            log(f"  step {step}: ADMM phase begins ({len(specs)} pruned "
                f"tensors)")
        if step == tc.retrain_start:
            pruned, masks = timed("finalize",
                                  lambda: A.finalize(state.params, specs))
            state = TrainState(pruned, state.opt, None, masks)
            log(f"  step {step}: masks frozen; retraining")
        if (state.admm is not None and step % admm_cfg.steps_per_admm == 0
                and step > 0):
            state = TrainState(state.params, state.opt, timed(
                "dual_update", lambda: A.admm_dual_update(
                    state.params, state.admm, specs)), state.masks)
        t0 = time.perf_counter()
        batch = synth_inputs(cfg, shape, seed=step, device=tc.device)["batch"]
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = (time.perf_counter() - t0) * 1e3
        history.append(loss)
        step_ms.append(dt)
        phases.append("retrain" if state.masks is not None else
                      "admm" if state.admm is not None else "dense")
        log(f"  step {step:5d} loss {loss:8.4f} lr "
            f"{float(metrics['lr']):.2e} gnorm "
            f"{float(metrics['grad_norm']):7.3f} {dt:7.1f} ms")
    return {"state": state, "history": history, "specs": specs,
            "step_ms": step_ms, "phases": phases,
            "transition_ms": transition_ms}


def check_trained(np, out, label):
    """Phase 7's gates on a run of 8 steps: the phases in order with one
    dual update, a finite loss lower at the end, and every pruned leaf
    (each expert of a stacked one) a balanced-BCR member."""
    from repro_torch.core.bcr import is_bcr_set_member
    from repro_torch.tree import flatten

    hist, phases = out["history"], out["phases"]
    if phases != ["dense"] * 2 + ["admm"] * 4 + ["retrain"] * 2:
        raise AssertionError(f"{label}: unexpected phases {phases}")
    if len(out["transition_ms"]["dual_update"]) != 1:
        raise AssertionError(f"{label}: expected one Z/U dual update "
                             f"(step 5)")
    if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
        raise AssertionError(f"{label}: loss not finite or not lower: "
                             f"{hist}")
    flat = dict(flatten(out["state"].params))
    bad, members = [], 0
    for path, spec in out["specs"].items():
        w = flat[path].detach()
        for mat in w.reshape(-1, *w.shape[-2:]):
            members += 1
            if not is_bcr_set_member(mat, spec):
                bad.append(path)
    if bad:
        raise AssertionError(f"{label}: {len(bad)} pruned matrices are not "
                             f"BCR members: {bad[:3]}")
    return members


@contextlib.contextmanager
def moe_routing(record=None, replay=None):
    """Inside the block every MoE layer's router (``models.moe.route``)
    appends its result to ``record``, or, given ``replay``, routes the
    current tokens and then dispatches and combines them as the recorded
    calls did, in order, appending its own expert choices to ``record``:
    a dense forward so routed runs exactly the experts a packed prefill
    ran, and their gap is the kernels' own, not a top-k near-tie that a
    bf16 summation order tips to another expert (and, at capacity, shifts
    which tokens drop). Routing itself is held to the reference on the CPU
    (``tests/test_torch_moe.py``)."""
    from repro_torch.models import moe
    route, it = moe.route, None if replay is None else iter(replay)

    def routed(*a, **kw):
        out = route(*a, **kw)
        record.append(out)
        if it is None:
            return out
        want = next(it)
        return out[0], want[1], want[2], want[3], want[4]

    moe.route = routed
    try:
        yield
    finally:
        moe.route = route


def packed_prefill_check(torch, cfg, dense, batch, label):
    """The retrained weights through ``pack_params`` and the family's
    packed prefill (``model_fns``), held against the dense finalized
    weights' last-position logits (a causal LM's ``forward``, an encdec
    model's own ``prefill``) under phase 7's gate and near-tie rule; the
    kernel forms the packed tree runs must launch. Returns the launches."""
    from repro_torch.launch.serve import pack_params
    from repro_torch.models import causal_lm
    from repro_torch.models.api import model_fns
    from repro_torch.tree import flatten

    fns = model_fns(cfg)
    packed = pack_params(cfg, dense)
    paths = [p for p, _ in flatten(packed)]
    need = {k for key, k in TRAIN_PACKED_KERNELS
            if any(key in p and (k.endswith("experts")
                                 or "['experts']" not in p) for p in paths)}
    packed_routes, dense_routes = [], []
    zero_counters()
    with torch.no_grad():
        with moe_routing(record=packed_routes):
            got = fns.prefill(packed, batch)[0]
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counters().items() if v}
        if cfg.family == "encdec":
            want = fns.prefill(dense, batch)[0]
        else:
            with moe_routing(record=dense_routes, replay=packed_routes):
                want = causal_lm.forward(
                    cfg, dense, batch["tokens"],
                    image_embeds=batch.get("image_embeds"))[:, -1:]
            if packed_routes:
                own = causal_lm.forward(
                    cfg, dense, batch["tokens"],
                    image_embeds=batch.get("image_embeds"))[:, -1:]
    if packed_routes:
        # the dense forward's own top-k sets against the packed prefill's
        flips = sum(int((torch.sort(a[2], -1).values
                         != torch.sort(b[2], -1).values).any(-1).sum())
                    for a, b in zip(packed_routes, dense_routes))
        tokens = sum(a[2].shape[0] * a[2].shape[1] for a in packed_routes)
        own_err = float((got.float() - own.float()).abs().max())
        log(f"  {label}: {len(packed_routes)} MoE layers; the dense "
            f"forward's own routing picks another expert set for {flips} of "
            f"{tokens} token-layers; packed vs dense under its own routing "
            f"max |diff| {own_err:.3e} (not gated); the gate below holds "
            f"the dense forward dispatched as the packed prefill was")
        del own
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    a, b = got.float().argmax(-1), want.float().argmax(-1)
    ties = 0
    for r in torch.nonzero(a != b).tolist():
        la = float(want[r[0], r[1], a[r[0], r[1]]])
        lb = float(want[r[0], r[1], b[r[0], r[1]]])
        if abs(la - lb) > err:
            raise AssertionError(f"{label}: packed argmax differs at row {r}:"
                                 f" dense logits {la} vs {lb}, beyond the "
                                 f"max difference {err}")
        ties += 1
    rows = got.shape[0]
    log(f"  {label} packed prefill vs dense finalized weights "
        f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in batch.items())}):"
        f" launches {launches}, max |diff| {err:.3e} of {scale:.3g}, argmax "
        f"equal on {rows - ties}/{rows} rows (near-ties {ties})")
    if not (bool(torch.isfinite(got).all()) and err <= 5e-2 * scale):
        raise AssertionError(f"{label}: packed prefill disagrees with the "
                             f"dense forward of the finalized weights")
    missing = sorted(k for k in need if not launches.get(k))
    if missing:
        raise AssertionError(f"{label}: the packed prefill did not launch "
                             f"{missing} (launches {launches})")
    del packed
    return launches, dict(max_abs=err, scale=scale, near_ties=ties)


def phase_train_family(torch, np, smi, label, arch, layers, smoke, shape):
    """One family of phase 16 (see the module docstring): train, gate,
    profile a retrain step, then the packed prefill of the retrained
    weights. Returns the family's stats and the prefill's launches."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models.api import synth_inputs
    from repro_torch.tree import flatten, tree_map

    t_start = time.perf_counter()
    cfg = train_family_cfg(arch, layers, smoke)
    full = get_config(arch)
    depth = (f"{cfg.encoder_layers} + {cfg.num_layers} layers"
             if cfg.family == "encdec" else f"{cfg.num_layers} layers")
    cut = ("SMOKE config" if smoke else "full width, " + (
        f"depth {full.num_layers} -> {cfg.num_layers}"
        if cfg.num_layers != full.num_layers else "full depth"))
    if shape is not None:
        shape = ShapeSpec(shape[0], shape[1], shape[2], "train")
        tc = trainer_config(batch=shape.global_batch, seq=shape.seq_len)
        where = (f"phase 16's loop over synth_inputs {shape.name} "
                 f"(B {shape.global_batch}, S {shape.seq_len})")
    else:
        tc = trainer_config()
        where = (f"train_loop, {tc.data_kind} data, B {tc.batch} x S "
                 f"{tc.seq}")
    log(f"phase {label} {arch} ({cut}: {depth}, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, params {cfg.param_dtype}, activations "
        f"{cfg.dtype}, grad_accum {cfg.grad_accum}, BCR keep "
        f"{cfg.bcr_keep_frac} on {cfg.bcr_block} blocks) through {where}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if shape is not None:
        out = synth_train_loop(torch, cfg, shape, tc)
        make_batch = (lambda: synth_inputs(cfg, shape, seed=tc.steps,
                                           device=tc.device)["batch"])
    else:
        out = train_loop(cfg, tc, log=lambda *a: log(" ", *a))
        make_batch = markov_batch(cfg, tc)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    state, specs = out["state"], out["specs"]
    flat = dict(flatten(state.params))
    n_params = sum(p.numel() for p in flat.values())
    n_pruned = sum(flat[p].numel() for p in specs)
    # fp32 params, grads, m and v for every parameter; Z and U for the
    # pruned ones during ADMM
    state_bytes = 16 * n_params + 8 * n_pruned
    phases, step_ms = out["phases"], out["step_ms"]
    p50 = {ph: statistics.median([ms for ms, q in zip(step_ms, phases)
                                  if q == ph])
           for ph in ("dense", "admm", "retrain") if ph in phases}
    members = check_trained(np, out, f"phase {label}")
    stats = dict(arch=arch, cut=cut, depth=depth, params=n_params,
                 pruned_params=n_pruned, pruned_leaves=len(specs),
                 pruned_matrices=members, state_bytes=state_bytes,
                 peak_bytes=peak, losses=out["history"], phases=phases,
                 step_ms=step_ms, step_ms_p50=p50,
                 transition_ms=out["transition_ms"], train_s=train_s)
    log(f"  phase {label}: {n_params / 1e9:.3f} B parameters, "
        f"{n_pruned / 1e9:.3f} B pruned ({len(specs)} leaves, {members} "
        f"matrices, every one a balanced-BCR member); state 16 B x "
        f"{n_params / 1e9:.3f} B + 8 B x {n_pruned / 1e9:.3f} B (Z, U) = "
        f"{state_bytes / 1e9:.2f} GB; peak {peak / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated over the run) on {smi}; step "
        f"wall p50 {json.dumps({k: round(v, 1) for k, v in p50.items()})} "
        f"ms; loss {out['history'][0]:.4f} -> {out['history'][-1]:.4f}")
    stats["profile"] = profile_train_step(torch, cfg, state, specs,
                                          make_batch)
    dense = tree_map(lambda p: p.detach(), state.params)
    del out, state, flat
    torch.cuda.empty_cache()
    if cfg.family == "encdec":
        batch = synth_inputs(cfg, ShapeSpec("prefill", shape.seq_len,
                                            shape.global_batch, "prefill"),
                             seed=tc.steps + 1, device=tc.device)["batch"]
    else:
        batch = {k: v for k, v in make_batch().items() if k != "targets"}
    launches, stats["serve"] = packed_prefill_check(
        torch, cfg, dense, batch, f"phase {label}")
    stats["prefill_launches"] = launches
    del dense, batch
    torch.cuda.empty_cache()
    stats["wall_s"] = time.perf_counter() - t_start
    log(f"phase {label} {arch}: " + json.dumps(stats))
    log(f"phase {label}: {stats['wall_s']:.1f} s (training "
        f"{train_s:.1f} s)")
    return stats, launches


def run_phase_train(torch, np, smi):
    """Phase 16: each family of ``TRAIN_FAMILIES`` in turn. Returns each
    kernel's launches summed over the five packed prefills (the kernels
    line's ``train_launches``)."""
    log("phase 16, training for every family that serves (dense -> ADMM -> "
        "retrain at full width, then the packed prefill)")
    t0 = time.perf_counter()
    total = {}
    for label, arch, layers, smoke, shape in TRAIN_FAMILIES:
        _, launches = phase_train_family(torch, np, smi, label, arch, layers,
                                         smoke, shape)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return total


# -- phase 17: GRIM's compile step and the long prefill on one H100 ----------

# 17a's shapes (label, N, K, G, block, epilogue): every distinct packed
# shape phase 4 serves at the engine's decode hint M = 8 — llama3.2-1b's
# wq (and the attention's wo: the same 2048 x 2048), the fused K/V (GQA:
# Q is wider, so llama fuses no Q/K/V), gate/up with its SwiGLU, the MLP's
# wo and lm_head — and phase 15's whisper-large-v3 lm_head on (2, 128)
# blocks (one kept row a tile) and its self-attention wqkv (G = 3)
TUNE_M = 8
TUNE_SHAPES = (
    ("wq|wo 2048x2048", 2048, 2048, 1, (128, 128), None),
    ("wkv 2x512x2048", 512, 2048, 2, (128, 128), None),
    ("wgi+swiglu 2x8192x2048", 8192, 2048, 2, (128, 128), "swiglu"),
    ("mlp wo 2048x8192", 2048, 8192, 1, (128, 128), None),
    ("lm_head 128256x2048", 128256, 2048, 1, (128, 128), None),
    ("whisper lm_head 51866x1280", 51866, 1280, 1, (2, 128), None),
    ("whisper wqkv 3x1280x1280", 1280, 1280, 3, (128, 128), None))
# 17e: the reference's prefill_32k length (its batch of 32 cut to one
# sequence), and the length of the whole-function check against the dense
# product
LONG_PREFILL, DENSE_CHECK_S, TAIL_ROWS = 32768, 4096, 512


def take_counters(acc):
    """Add the launch counters to ``acc`` and zero them (phase 17's
    ``tune_launches`` sum every launch of the phase)."""
    for k, v in read_counters().items():
        acc[k] = acc.get(k, 0) + v
    zero_counters()


def rank_correlation(np, a, b) -> float:
    """Spearman's rho of two equal-length sequences (average ranks on
    ties)."""
    def ranks(v):
        v = np.asarray(v, dtype=np.float64)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(len(v))
        for x in np.unique(v):
            r[v == x] = r[v == x].mean()
        return r
    ra, rb = ranks(a), ranks(b)
    if len(ra) < 2 or ra.std() == 0 or rb.std() == 0:
        return float("nan")
    return float(np.corrcoef(ra, rb)[0, 1])


def tune_case(torch, np, gen, label, n, k, g, block, epi, int8):
    """17a for one shape and tile form: every legal genome of the space
    launched once against the plain version (phase 3's gate) and timed
    (median of 5 x 20 launches under CUDA events, per projection) beside
    the H100 model's prediction; then the rule's plan, the analytic pick
    and the wall-clock pick (``tuned_genome``). Returns the row and the
    (model, measured) pairs."""
    import itertools

    from repro_torch.core.bcr import BCRSpec, kept_align
    from repro_torch.core.bcrc import tbcrc_pack
    from repro_torch.core.block_search import device_seconds
    from repro_torch.core.tuner import (H100_SMS, genome_knobs, launch_cost)
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import (attach_plan, pack_group,
                                          plan_search_space,
                                          quantize_packed, tuned_genome)

    spec = BCRSpec(block_shape=block, keep_frac=0.25, align=kept_align(block))
    members = []
    for _ in range(g):
        p = tbcrc_pack(torch.randn((n, k), generator=gen, device="cuda")
                       * k ** -0.5, spec)
        members.append(quantize_packed(p) if int8 else dataclasses.replace(
            p, vals=p.vals.to(torch.bfloat16)))
    kept = members[0].kept_counts
    x = torch.randn((TUNE_M, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    wb, sb = (1, 4) if int8 else (2, 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(genome, grp):
        """(fn, plain fn) of one launch of ``grp`` members under
        ``genome`` (None: the rule)."""
        if grp > 1:
            pk = pack_group(members[:grp], genome, m=TUNE_M)
            ep = epi if grp == 2 else None
            return (lambda: K.bcr_spmm_grouped(x, pk, epilogue=ep),
                    lambda: ref.bcr_spmm_grouped_ref(x, pk, epilogue=ep))
        pk = attach_plan(members[0], genome, m=TUNE_M)
        return (lambda: K.bcr_spmm(x, pk),
                lambda: ref.bcr_spmm_packed_ref(x, pk))

    def measure(genome, grp, what):
        fn, plain = run(genome, grp)
        got, want = fn(), plain()
        if grp > 1 and not (grp == 2 and epi):
            want = want.transpose(-3, -2)
        torch.cuda.synchronize()
        err = check_close(what, got, want, BF16_TOL, quiet=True)
        ms = device_seconds(fn, x, 20, 5) / grp * 1e3
        plan = K.launch_plan(TUNE_M, n, k, grp, block, kept, sms, int8, True,
                             1, None if genome is None
                             else genome_knobs(genome))
        model_ms = launch_cost(plan, TUNE_M, k, n, kept,
                               weight_bytes_per_el=wb,
                               weight_scale_bytes=sb) / grp * 1e3
        return ms, model_ms, err, plan

    space = plan_search_space(TUNE_M, g)
    pairs, errs = [], []
    for values in itertools.product(*(space[key] for key in sorted(space))):
        genome = dict(zip(sorted(space), values))
        try:
            K.launch_plan(TUNE_M, n, k, genome["group_size"], block, kept,
                          sms, int8, True, 1, genome_knobs(genome))
        except ValueError:
            continue
        ms, model_ms, err, _ = measure(genome, genome["group_size"],
                                       f"{label} genome {genome}")
        pairs.append((model_ms, ms))
        errs.append(err)
    t0 = time.perf_counter()
    picks = {"analytic": tuned_genome(
        TUNE_M, k, n, block, *kept, max_group=g, weight_bytes_per_el=wb,
        weight_scale_bytes=sb)}
    t_an = time.perf_counter() - t0
    t0 = time.perf_counter()
    picks["wallclock"] = tuned_genome(
        TUNE_M, k, n, block, *kept, max_group=g, weight_bytes_per_el=wb,
        weight_scale_bytes=sb, fitness="wallclock")
    t_wc = time.perf_counter() - t0
    form = "int8" if int8 else "bf16"
    row = dict(shape=label, form=form, kept=list(kept), legal=len(pairs),
               max_abs_err=max(errs),
               rho=rank_correlation(np, *zip(*pairs)),
               tune_s={"analytic": t_an, "wallclock": t_wc})
    for name, genome in (("rule", None), *picks.items()):
        grp = g if genome is None else genome["group_size"]
        ms, model_ms, err, plan = measure(genome, grp, f"{label} {name}")
        row[name] = dict(genome=genome, m_tile=plan.m_tile, slabs=plan.slabs,
                         chunks=plan.chunks, splits=plan.splits,
                         grid=plan.grid, group=grp, ms=ms, model_ms=model_ms,
                         max_abs_err=err)
    slower = row["analytic"]["ms"] > row["rule"]["ms"]
    row["analytic_slower_than_rule"] = slower
    log(f"phase 17a {label} {form}: kept {tuple(kept)}; {len(pairs)} legal "
        f"genomes, rank correlation model vs measured {row['rho']:.3f}; "
        + "; ".join(f"{name} {row[name]['genome']} (M tile "
                    f"{row[name]['m_tile']}, slabs {row[name]['slabs']}, "
                    f"chunks {row[name]['chunks']}, splits "
                    f"{row[name]['splits']}, G {row[name]['group']}): "
                    f"{row[name]['ms']:.4f} ms, model "
                    f"{row[name]['model_ms']:.4f} ms"
                    for name in ("rule", "analytic", "wallclock"))
        + (" -- the analytic pick is SLOWER than the rule's plan"
           if slower else ""))
    return row, pairs


def phase_tune_shapes(torch, np):
    """17a: the tuner per served shape, bf16 and int8 tiles."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rows, pairs = [], []
    for label, n, k, g, block, epi in TUNE_SHAPES:
        for int8 in (False, True):
            row, p = tune_case(torch, np, gen, label, n, k, g, block, epi,
                               int8)
            rows.append(row)
            pairs.extend(p)
            torch.cuda.empty_cache()
    rho = rank_correlation(np, *zip(*pairs))
    log(f"phase 17a: rank correlation of the H100 model with the measured "
        f"times over all {len(pairs)} genomes: {rho:.3f}; analytic picks "
        f"slower than the rule: "
        f"{[(r['shape'], r['form']) for r in rows if r['analytic_slower_than_rule']]}")
    log("phase 17a rows: " + json.dumps(rows))
    return rows, rho


def tuned_engine_run(torch, np, cfg, dense, fitness, acc):
    """Pack the full-width model with ``plan_fitness=fitness`` and serve
    phase 4's traffic through an engine of that fitness; returns its
    stats, trajectories and packed params."""
    from repro_torch.launch.serve import pack_params, packed_fraction
    from repro_torch.serving import EngineConfig

    t0 = time.perf_counter()
    params = pack_params(cfg, dense, plan_fitness=fitness)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    take_counters(acc)
    ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0,
                      plan_fitness=fitness)
    stats, _, traj, engine = serve_main_path(
        torch, np, cfg, params, ec, f"phase 17b {fitness}",
        packed_fraction(dense, params))
    take_counters(acc)
    stats["pack_and_tune_s"] = pack_s
    del engine
    return stats, traj, params


def phase_tuned_serving(torch, np, acc):
    """17b: phase 4's engine and traffic with every launch tuned by the
    analytic model (the default) and by wall-clock times on this card; the
    wall-clock run's tokens held to the naive ``generate`` on its own
    packed tree (the near-tie rule of phases 6 and 9b)."""
    from repro_torch.configs import get_config
    from repro_torch.models import causal_lm

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=16,
                              bcr_keep_frac=0.25, bcr_block=(128, 128))
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    out = {}
    for fitness in ("analytic", "wallclock"):
        stats, traj, params = tuned_engine_run(torch, np, cfg, dense,
                                               fitness, acc)
        out[fitness] = stats
        if fitness == "wallclock":
            prompts = [p for p, _ in traj]
            got = [list(g) for _, g in traj]
            near = near_tie_check(torch, cfg, params, prompts, got, 32,
                                  BF16_TIE, "phase 17b wallclock")
            take_counters(acc)
            out[fitness]["near_ties"] = near
        del params
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()
    log(f"phase 17b: decode step p50 analytic "
        f"{out['analytic']['decode_step_ms_p50']:.2f} ms, wallclock "
        f"{out['wallclock']['decode_step_ms_p50']:.2f} ms; pack + tune "
        f"{out['analytic']['pack_and_tune_s']:.1f} / "
        f"{out['wallclock']['pack_and_tune_s']:.1f} s; wallclock tokens "
        f"equal naive generate, near-ties {out['wallclock']['near_ties']}")
    return out


def phase_auto_block(torch, np, acc):
    """17c: ``pack_params(auto_block=True)`` with the card runner (Listing
    1 over the reference's candidates per leaf shape, each timed on this
    card) and wall-clock plans, then 8 requests through the engine, held to
    the naive ``generate`` on that tree."""
    import functools

    from repro_torch.configs import get_config
    from repro_torch.core.bcrc import TBCRC
    from repro_torch.core.block_search import wallclock_runner
    from repro_torch.kernels.plan import GroupedTBCRC
    from repro_torch.launch import serve as S
    from repro_torch.models import causal_lm
    from repro_torch.serving import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=16,
                              bcr_keep_frac=0.25, bcr_block=(128, 128))
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    runner = functools.partial(wallclock_runner, device="cuda")
    t0 = time.perf_counter()
    params = S.pack_params(cfg, dense, auto_block=True, block_runner=runner,
                           plan_fitness="wallclock")
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    def packs(tree):
        if isinstance(tree, (TBCRC, GroupedTBCRC)):
            return [tree]
        nodes = (tree.values() if isinstance(tree, dict)
                 else tree if isinstance(tree, list) else ())
        return [p for v in nodes for p in packs(v)]

    picks = {f"{pk.shape[0]}x{pk.shape[1]}": list(pk.block_shape)
             for pk in packs(params)}
    del dense
    torch.cuda.empty_cache()
    take_counters(acc)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 128, 512, 64, 256, 32, 128, 16)]
    engine = InferenceEngine(cfg, params, EngineConfig(
        n_slots=8, capacity=640, page_size=16, seed=0,
        plan_fitness="wallclock"), device="cuda")
    t0 = time.perf_counter()
    got = engine.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    near = near_tie_check(torch, cfg, params, prompts, got, 16, BF16_TIE,
                          "phase 17c auto-block")
    take_counters(acc)
    log(f"phase 17c: Listing-1 blocks per leaf shape (card runner) "
        f"{json.dumps(picks)}; search + pack + tune {search_s:.1f} s; 8 "
        f"requests x 16 tokens in {serve_s:.2f} s; tokens equal naive "
        f"generate, near-ties {near}")
    del engine, params
    torch.cuda.empty_cache()
    return dict(blocks=picks, search_s=search_s, serve_s=serve_s,
                near_ties=near)


def phase_static_cli(torch, np, acc):
    """17d: ``python -m repro_torch.launch.serve --mode static`` in a
    subprocess (batch 8, prompt 128, 32 greedy tokens, full width and
    depth), its tokens held to the naive ``generate`` on the same seeded
    weights and prompts."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_params

    root = Path(__file__).resolve().parent
    out = root / "build" / "phase17d_static.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    batch, plen, gen_tokens = 8, 128, 32
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "llama3.2-1b", "--mode", "static", "--batch", str(batch),
           "--prompt-len", str(plen), "--gen", str(gen_tokens),
           "--capacity", str(plen + gen_tokens), "--bcr-keep", "0.25",
           "--bcr-block", "128", "--json-out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 17d: the static CLI exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-3000:]}")
    rec = json.loads(out.read_text())
    cfg = dataclasses.replace(get_config("llama3.2-1b"), bcr_keep_frac=0.25,
                              bcr_block=(128, 128))
    params = build_params(cfg, seed=0, device="cuda", decode_m=batch,
                          log=lambda *_: None)
    g = torch.Generator()
    g.manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen), generator=g,
                            dtype=torch.int32)
    got = [list(r) for r in rec["tokens"]]
    near = near_tie_check(torch, cfg, params, list(prompts.numpy()), got,
                          gen_tokens, BF16_TIE, "phase 17d static")
    take_counters(acc)
    log(f"phase 17d: {' '.join(cmd[1:])}: {proc.stdout.strip().splitlines()[-1]}"
        f"; exit 0 in {wall:.1f} s; tokens equal naive generate, near-ties "
        f"{near}")
    del params
    torch.cuda.empty_cache()
    return dict(prefill_ms=rec["prefill_s"] * 1e3,
                decode_ms=rec["decode_s"] * 1e3, near_ties=near, wall_s=wall)


def phase_long_prefill(torch, np, acc):
    """17e: one 32768-token sequence (the reference's prefill_32k length,
    its batch of 32 cut to 1) through ``causal_lm.prefill`` at full width
    and depth under ``attn_impl="flash"``: peak memory, wall and device
    time; layer 0's attention over the last 512 query rows against the
    plain masked softmax over those rows; the whole function against
    ``dense_attention`` at S = 4096 (bf16's gate)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pack_params
    from repro_torch.models import causal_lm
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("llama3.2-1b"), bcr_keep_frac=0.25,
                              bcr_block=(128, 128), attn_impl="flash")
    dense = causal_lm.init_params(cfg, 0, device="cuda")
    params = pack_params(cfg, dense)
    del dense
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL), generator=gen,
                         device="cuda", dtype=torch.int32)
    take_counters(acc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    with torch.no_grad():
        logits, cache = causal_lm.prefill(cfg, params, toks)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    device_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    take_counters(acc)
    if tuple(logits.shape) != (1, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 17e: prefill logits not finite")
    kv_bytes = sum(t.numel() * t.element_size() for layer in cache
                   for t in layer.values())
    del cache, logits
    # layer 0's q/k/v at full length, its attention's last rows
    lp = params["layers"][0]["mixer"]
    with torch.no_grad():
        h = L.rmsnorm(params["layers"][0]["norm1"],
                      causal_lm._embed_tokens(cfg, params, toks),
                      cfg.norm_eps)
        pos = torch.arange(LONG_PREFILL, device="cuda")[None]
        cs = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        q, k, v = L._qkv(lp, h, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cs)
        got = L.flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)[:, -TAIL_ROWS:]
        qt = q[:, -TAIL_ROWS:]
        g = cfg.num_heads // cfg.num_kv_heads
        logit = torch.einsum(
            "bqhgd,bkhd->bhgqk",
            qt.reshape(1, TAIL_ROWS, cfg.num_kv_heads, g, cfg.head_dim)
            .float(), k.float()) * cfg.head_dim ** -0.5
        qpos = torch.arange(LONG_PREFILL - TAIL_ROWS, LONG_PREFILL,
                            device="cuda")
        mask = qpos[:, None] >= torch.arange(LONG_PREFILL,
                                             device="cuda")[None]
        logit = torch.where(mask, logit, torch.full_like(logit, -1e30))
        want = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(logit, -1),
                            v.float()).reshape(1, TAIL_ROWS, cfg.num_heads,
                                               cfg.head_dim)
        del logit
        tail_err = check_close("17e flash vs masked softmax, last 512 rows "
                               "of 32768 (layer 0)", got, want, BF16_TOL)
        del q, k, v, h, got, want
        torch.cuda.empty_cache()
        qd, kd, vd = (torch.randn((1, DENSE_CHECK_S, heads, cfg.head_dim),
                                  generator=gen, device="cuda")
                      .to(torch.bfloat16)
                      for heads in (cfg.num_heads, cfg.num_kv_heads,
                                    cfg.num_kv_heads))
        dense_err = check_close(
            f"17e flash vs dense_attention, S = {DENSE_CHECK_S}",
            L.flash_attention(qd, kd, vd, causal=True, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk),
            L.dense_attention(qd, kd, vd, causal=True), BF16_TOL)
    take_counters(acc)
    bmm = ("bf16 operands, fp32 result (torch.bmm out_dtype)"
           if L._BMM_OUT_DTYPE else "operands upcast to fp32")
    out = dict(tokens=LONG_PREFILL, wall_s=wall, device_ms=device_ms,
               peak_gib=peak / 2 ** 30,
               peak_over_weights_gib=(peak - base) / 2 ** 30,
               kv_gib=kv_bytes / 2 ** 30, tail_max_abs_err=tail_err,
               dense_max_abs_err=dense_err, products=bmm)
    log(f"phase 17e: prefill of {LONG_PREFILL} tokens (batch 1; "
        f"prefill_32k's 32 cut to 1), 16 layers, attn_impl flash "
        f"(q_chunk {cfg.q_chunk}, kv_chunk {cfg.kv_chunk}; {bmm}): wall "
        f"{wall:.2f} s, device {device_ms:.1f} ms, peak "
        f"{out['peak_gib']:.2f} GiB ({out['peak_over_weights_gib']:.2f} "
        f"over the weights), K/V {out['kv_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return out


def run_phase_tune(torch, np, smi):
    """Phase 17 in order, timed per sub-phase; returns every kernel's
    launches over it (``tune_launches``)."""
    log(f"phase 17, GRIM's compile step on the card and the chunked "
        f"flash_attention at 32k ({smi})")
    acc = {}
    zero_counters()
    times, out = {}, {}
    for name, fn in (("17a", lambda: phase_tune_shapes(torch, np)),
                     ("17b", lambda: phase_tuned_serving(torch, np, acc)),
                     ("17c", lambda: phase_auto_block(torch, np, acc)),
                     ("17d", lambda: phase_static_cli(torch, np, acc)),
                     ("17e", lambda: phase_long_prefill(torch, np, acc))):
        t0 = time.perf_counter()
        out[name] = fn()
        take_counters(acc)
        times[name] = time.perf_counter() - t0
        log(f"phase {name}: {times[name]:.1f} s")
    rows, rho = out["17a"]
    summary = {"times_s": times, "rank_correlation": rho,
               "17b": {k: {kk: v[kk] for kk in
                           ("decode_step_ms_p50", "tokens_per_s",
                            "ttft_ms_p50", "pack_and_tune_s")}
                       for k, v in out["17b"].items()},
               "17c": out["17c"], "17d": out["17d"], "17e": out["17e"]}
    log("phase 17: " + json.dumps(summary))
    log(f"phase 17: {sum(times.values()):.1f} s")
    return acc


# ---------------------------------------------------------------------------
# Phase 18: tensor-parallel serving, ranks sharing the one card
# ---------------------------------------------------------------------------

# 18c's shard shapes: (name, whole N, K, group, epilogue) at M = 8, each
# the tp = 2 shard of a llama3.2-1b projection (lm_head's 1002 row blocks
# of 128 halve to 501), planned as pack_params plans the whole
TP_SHARD_CASES = (("wq", 2048, 2048, 1, None),
                  ("wkv", 512, 2048, 2, None),
                  ("wgi", 8192, 2048, 2, "swiglu"),
                  ("mlp_wo", 2048, 8192, 1, None),
                  ("lm_head", 128256, 2048, 1, None))
TP_KERNEL_ROWS = {"bcr_spmm": "lm_head 64128x2048 M=8 tp=2",
                  "bcr_spmm_grouped": "wgi 2x4096x2048 M=8 tp=2",
                  "paged_attention": "decode 16/4 heads B=8 lens 1..512 tp=2"}


def tp_shard_cases(torch, timer, record):
    """Phase 18c: the BCR kernels at the shard shapes of tp = 2 (each pack
    tuned for M = 8 as a whole, then split by ``split_packed`` /
    ``split_grouped``) and paged decode over one rank's 16/4 heads: each
    against its plain version, timed beside it, the library product and
    the bound; the launch the shard runs under equal to the whole's (M
    tile, configuration, split, stages; logged); and the two shards'
    outputs concatenated bit-equal to the whole's (the heads of the pool's
    first shard bit-equal to the whole pool's)."""
    from repro_torch.core.bcr import BCRSpec
    from repro_torch.core.bcrc import tbcrc_pack, tbcrc_unpack
    from repro_torch.kernels import bcr_spmm as K
    from repro_torch.kernels import paged_decode_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.bcr_spmm import _sm_count, launch_plan
    from repro_torch.kernels.plan import (launch_genome, pack_group,
                                          plan_shards, split_grouped,
                                          split_packed, tune_genome_for,
                                          tune_packed)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    spec = BCRSpec(block_shape=(128, 128), keep_frac=0.25, align=8)
    sms = _sm_count(torch.device("cuda"))

    def decision(p, m, g):
        nb_r, nb_c, r, c = p.vals.shape[-4:]
        lp = launch_plan(m, p.shape[0], p.shape[1], g, p.block_shape, (r, c),
                         sms, False, True, 1, launch_genome(p.plan, m),
                         plan_shards(p.plan))
        return dict(m_tile=lp.m_tile, slabs=lp.slabs, warps_m=lp.warps_m,
                    n_chunk=lp.n_chunk, splits=lp.splits, stages=lp.stages)

    m = 8
    for name, n, k, g, epi in TP_SHARD_CASES:
        members = []
        for _ in range(g):
            w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
            members.append(tbcrc_pack(w, spec))
        if g == 1:
            whole = tune_packed(members[0], m=m)
            whole.vals = whole.vals.to(torch.bfloat16)
            shards = split_packed(whole, 2)
        else:
            genome = tune_genome_for(members[0], m=m, max_group=g)
            whole = pack_group(members, genome, m=m)
            whole.vals = whole.vals.to(torch.bfloat16)
            shards = split_grouped(whole, 2)
        x = (torch.randn((m, k), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        want_dec, got_dec = decision(whole, m, g), decision(shards[0], m, g)
        if want_dec != got_dec:
            raise AssertionError(f"{name}: the shard launches {got_dec}, the "
                                 f"whole {want_dec}")
        if g == 1:
            run = lambda p: K.bcr_spmm(x, p)                    # noqa: E731
            plain = lambda p: ref.bcr_spmm_packed_ref(x, p)     # noqa: E731
        else:
            run = lambda p: K.bcr_spmm_grouped(x, p, epilogue=epi)  # noqa
            plain = lambda p: (ref.bcr_spmm_grouped_ref(        # noqa: E731
                x, p, epilogue=epi) if epi else
                ref.bcr_spmm_grouped_ref(x, p).transpose(0, 1))
        full = run(whole)
        parts = [run(s) for s in shards]
        torch.cuda.synchronize()
        if not torch.equal(torch.cat(parts, dim=-1), full):
            raise AssertionError(f"{name}: the shards' outputs do not "
                                 f"concatenate to the whole's bit for bit")
        sh = shards[0]
        ln = sh.shape[0]
        shape = (f"{name} {ln}x{k} M={m} tp=2" if g == 1
                 else f"{name} {g}x{ln}x{k} M={m} tp=2")
        err = check_close(shape, parts[0], plain(sh), BF16_TOL)
        if g == 1:
            w_dense = tbcrc_unpack(sh)
        else:
            w_dense = torch.cat([tbcrc_unpack(dataclasses.replace(
                sh, vals=sh.vals[i], row_idx=sh.row_idx[i],
                col_idx=sh.col_idx[i])) for i in range(g)])
        nb_r, nb_c, r, c = sh.vals.shape[-4:]
        out_n = ln if (g == 1 or epi) else g * ln
        tiles = (sh.vals.numel() * 2
                 + (sh.row_idx.numel() + sh.col_idx.numel()) * 4)
        record("bcr_spmm" if g == 1 else "bcr_spmm_grouped", shape, err,
               timer.ms(lambda: run(sh)), timer.ms(lambda: plain(sh)),
               tiles + (m * k + m * out_n) * 2,
               2 * m * g * nb_r * nb_c * r * c, torch.bfloat16,
               timer.ms(lambda: _library_dense_matmul(x, w_dense)))
        log(f"    launch (the whole's): {got_dec}")
        del whole, shards, members, w_dense

    # paged decode over one rank's heads: 16 of 32 q heads, 4 of 8 kv heads
    hkv, h, d, ps = 8, 32, 64, 16
    lens = torch.tensor([1, 37, 128, 200, 333, 511, 512, 0],
                        dtype=torch.int32, device="cuda")
    per = [-(-int(t) // ps) for t in lens.tolist()]
    n_pages = 1 + sum(per) + 8
    kp = torch.randn((n_pages, ps, hkv, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vp = torch.randn((n_pages, ps, hkv, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    bt = torch.zeros((8, max(per)), dtype=torch.int32)
    nxt = 1
    for i, npg in enumerate(per):
        bt[i, :npg] = torch.arange(nxt, nxt + npg)
        nxt += npg
    bt = bt.cuda()
    q = torch.randn((8, 1, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    whole = PA.paged_decode_attention(q, kp, vp, bt, lens)
    qs = q[:, :, :h // 2].contiguous()
    ks, vs = kp[:, :, :hkv // 2].contiguous(), vp[:, :, :hkv // 2].contiguous()

    def shard_run():
        return PA.paged_decode_attention(qs, ks, vs, bt, lens, head_shards=2)

    got = shard_run()
    torch.cuda.synchronize()
    if not torch.equal(got, whole[:, :, :h // 2]):
        raise AssertionError("paged decode over a rank's heads is not the "
                             "whole pool's bit for bit")
    plan_w = PA.paged_plan(8, hkv, h // hkv, bt.shape[1], ps, sms)
    plan_s = PA.paged_plan(8, hkv // 2, h // hkv, bt.shape[1], ps, sms,
                           head_shards=2)
    if (plan_w.row_tile, plan_w.splits) != (plan_s.row_tile, plan_s.splits):
        raise AssertionError(f"paged shard plan {plan_s} != whole {plan_w}")
    want = ref.paged_decode_attention_ref(qs, ks, vs, bt, lens)
    live = lens > 0
    err = check_close(TP_KERNEL_ROWS["paged_attention"], got[live],
                      want[live], BF16_TOL)
    kv_bytes = PA.paged_kv_bytes(lens.cpu().numpy(), ps, hkv // 2, d, 2)
    kk = ks[bt.long()].reshape(8, -1, hkv // 2, d).repeat_interleave(4, 2)
    vv = vs[bt.long()].reshape(8, -1, hkv // 2, d).repeat_interleave(4, 2)
    mask = (torch.arange(kk.shape[1], device="cuda")[None, None, :]
            <= (lens - 1)[:, None, None])[:, None]
    sdpa_args = (qs.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                 mask)
    record("paged_attention", TP_KERNEL_ROWS["paged_attention"], err,
           timer.ms(shard_run),
           timer.ms(lambda: ref.paged_decode_attention_ref(qs, ks, vs, bt,
                                                           lens)),
           kv_bytes + 2 * qs.numel() * 2 + bt.numel() * 4,
           4 * int(lens.sum()) * (h // 2) * d, torch.bfloat16,
           timer.ms(lambda: _library_sdpa(torch, *sdpa_args)))
    log(f"    launch (the whole pool's): row tile {plan_s.row_tile}, "
        f"{plan_s.splits} splits of {plan_s.pages_per_split} pages")


def tp_rank_reports(engine):
    """Each rank's bytes and launch counters, rank 0 first."""
    from repro_torch.serving.tp import rank_report
    mine = rank_report(engine.params, engine.pool.cache)
    if engine.group is None:
        return [mine]
    return [mine] + engine.group.query("report")


def tp_serve(torch, np, cfg, params, ec, label, n_req, gen, group=None):
    """Serve ``n_req`` of phase 4's prompts (``gen`` tokens each) through an
    engine at ``ec.mesh_model`` on ``group``, every rank's counters zeroed
    just before; keeps the first decode step's logits (rank 0's, gathered
    over the vocab). Returns the tokens in submission order, the stats, the
    logits, each rank's report and the engine (closed by the caller)."""
    from repro_torch.serving import FINISHED, InferenceEngine

    tb = time.perf_counter()
    engine = InferenceEngine(cfg, params, ec, device="cuda", group=group)
    build_s = time.perf_counter() - tb
    probe = {}
    decode = engine.fns.decode_step

    def keep_first(p, batch, cache):
        logits, cache = decode(p, batch, cache)
        probe.setdefault("logits", logits.clone())
        return logits, cache

    engine.fns = dataclasses.replace(engine.fns, decode_step=keep_first)
    rng, prompts = main_traffic(np, cfg.vocab_size)
    prompts = prompts[:n_req]
    zero_counters()
    if engine.group is not None:
        engine.group.query("zero_counters")
    rids = [engine.submit(p, max_new_tokens=gen) for p in prompts]
    done, decode_ms = [], []
    t0 = time.perf_counter()
    while engine.sched.has_work():
        prefills = engine.stats["prefills"]
        ts = time.perf_counter()
        done.extend(engine.step())
        if engine.stats["prefills"] == prefills:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reports = tp_rank_reports(engine)
    if len(done) != n_req or any(r.status != FINISHED for r in done):
        raise AssertionError(f"{label}: not every request FINISHED")
    engine.check_conservation()
    by_rid = {r.rid: list(r.generated) for r in done}
    st = engine.stats
    stats = dict(tokens_per_s=st["tokens_generated"] / wall, wall_s=wall,
                 engine_build_s=build_s,
                 decode_step_ms_p50=statistics.median(decode_ms),
                 decode_steps=st["decode_steps"],
                 kv_bytes_read=st["kv_bytes_read"],
                 kv_bytes_read_device=st["kv_bytes_read_device"])
    stats.update(tp_profile(torch, engine, rng, cfg))
    return [by_rid[r] for r in rids], stats, probe["logits"], reports, engine


def tp_profile(torch, engine, rng, cfg, steps=2):
    """Rank 0's device time a decode step over ``steps`` steady steps of 8
    live slots, against their unprofiled wall: each rank is its own
    process, so the profiler sees rank 0's kernels only."""
    from torch.profiler import ProfilerActivity, profile

    for n in (32, 128, 512, 128, 32, 512, 128, 32):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=2 * steps + 3)
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    engine.run()
    dev = sum(ms for _, _, ms in device_events(torch, prof)) / steps
    return dict(steady_step_wall_ms=wall, rank0_device_ms=dev,
                rank0_busy_share=dev / wall)


def tp_prefix(np, cfg, params, group):
    """Phase 18a's prefix run: 9a's traffic cut to its seeds and first wave
    (8 requests, 16 tokens each) with the prefix cache on, at mesh 1 and on
    ``group``'s 2 ranks: the same tokens and hit tokens, and every rank
    launched the paged kernel's prefill-append form (the adopted pages and
    the suffixes' writes live on every rank's shard of the pool)."""
    from repro_torch.serving import EngineConfig, InferenceEngine

    systems, reqs = prefix_traffic(np, cfg.vocab_size)
    out = {}
    for tp in (1, 2):
        ec = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0,
                          prefix_cache=True, mesh_model=tp,
                          mesh_devices=("cuda:0",) * tp if tp > 1 else ())
        engine = InferenceEngine(cfg, params, ec, device="cuda",
                                 group=group if tp > 1 else None)
        for p in systems:
            engine.submit(p, max_new_tokens=4)
        engine.run()
        zero_counters()
        if tp > 1:
            group.query("zero_counters")
        rids = [engine.submit(p, max_new_tokens=16) for p in reqs[:8]]
        done = {r.rid: list(r.generated) for r in engine.run()}
        engine.check_conservation()
        out[tp] = ([done[r] for r in rids], engine.stats["prefix_hit_tokens"],
                   tp_rank_reports(engine))
        engine.close()
    appends = [rep["launches"]["paged_attention_append"]
               for rep in out[2][2]]
    log(f"phase 18a prefix cache at mesh 2: tokens equal mesh 1's "
        f"{out[2][0] == out[1][0]}, hit tokens {out[2][1]} (mesh 1 "
        f"{out[1][1]}), prefill-append launches a rank {appends}")
    if out[2][0] != out[1][0] or out[2][1] != out[1][1] or not out[1][1]:
        raise AssertionError("18a: the prefix cache at mesh 2 is not mesh "
                             "1's")
    if not all(appends):
        raise AssertionError("18a: a rank never ran the prefill-append form")
    return dict(hit_tokens=out[2][1], append_launches=appends,
                reports=out[2][2])


def tp_compare(torch, label, tp, base, sharded, kernels, params):
    """18a/b's gate: tokens and the first decode step's logits bit-equal to
    mesh 1's; per-device KV traffic a tp-th of the aggregate; every rank's
    KV pool a tp-th of mesh 1's; every rank launched each kernel of
    ``kernels``. Logs the per-rank figures."""
    toks1, st1, logits1, rep1, _ = base
    toks, st, logits, reps, _ = sharded
    if toks != toks1:
        raise AssertionError(f"{label}: mesh-{tp} tokens differ from mesh "
                             f"1's")
    if not torch.equal(logits, logits1):
        raise AssertionError(f"{label}: mesh-{tp} decode logits are not "
                             f"mesh 1's bit for bit")
    if st["kv_bytes_read_device"] * tp != st["kv_bytes_read"]:
        raise AssertionError(f"{label}: kv_bytes_read_device x {tp} != "
                             f"kv_bytes_read")
    pool1 = rep1[0]["kv_pool_bytes"]
    for r, rep in enumerate(reps):
        if rep["kv_pool_bytes"] * tp != pool1:
            raise AssertionError(f"{label}: rank {r}'s pool is "
                                 f"{rep['kv_pool_bytes']} B, mesh 1's "
                                 f"{pool1}")
        missing = [k for k in kernels if not rep["launches"].get(k)]
        if missing:
            raise AssertionError(f"{label}: rank {r} never launched "
                                 f"{missing}")
    per_rank = [dict(rank=r, param_bytes=rep["param_bytes"],
                     param_ratio=rep["param_bytes"] / rep1[0]["param_bytes"],
                     kv_pool_bytes=rep["kv_pool_bytes"],
                     cuda_allocated=rep["cuda_allocated"],
                     launches={k: rep["launches"][k] for k in kernels})
                for r, rep in enumerate(reps)]
    out = dict(mesh=tp, tokens_equal=True, logits_equal=True,
               mesh1=st1, sharded=st, per_rank=per_rank,
               streamed_weight_ratio=(_weight_bytes(sharded[4].params)
                                      / _weight_bytes(params)),
               mesh1_param_bytes=rep1[0]["param_bytes"],
               mesh1_kv_pool_bytes=pool1,
               mesh1_launches={k: rep1[0]["launches"][k] for k in kernels})
    log(f"phase {label}: " + json.dumps(out))
    return out


def psum_rank():
    """One rank of 18d (``ModelGroup.call``): pod 2 x data 2 over the
    group's 4 gloo ranks on the card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.collectives import hierarchical_psum

    rank = dist.get_rank()
    mesh = make_mesh((2, 2), ("pod", "data"))
    g = np.random.default_rng(rank).standard_normal((64, 1024)).astype(
        np.float32)
    exact = hierarchical_psum({"g": torch.as_tensor(g, device="cuda")},
                              mesh)["g"].cpu().numpy()
    # the codec as the reference tests it: the same gradients on every rank
    g0 = np.random.default_rng(0).standard_normal((64, 1024)).astype(
        np.float32)
    q = hierarchical_psum({"g": torch.as_tensor(g0, device="cuda")}, mesh,
                          codec="int8")["g"].cpu().numpy()
    return exact, q


def tp_psum(np, group):
    """Phase 18d: ``hierarchical_psum`` on the 4 gloo ranks of 18b's group,
    CUDA tensors on the card (pod 2 x data 2): the full-precision reduction
    bit-equal to the numpy sum of the four ranks' gradients in its order
    (data, then pod); the int8 codec, over the same gradients on every
    rank as the reference tests it, within the reference's 2% relative
    error."""
    got = group.call(psum_rank)
    g = [np.random.default_rng(r).standard_normal((64, 1024)).astype(
        np.float32) for r in range(4)]
    want = (g[0] + g[1]) + (g[2] + g[3])
    rel = max(float(np.linalg.norm(q - 4 * g[0]) / np.linalg.norm(4 * g[0]))
              for _, q in got)
    exact_err = max(float(np.abs(e - want).max()) for e, _ in got)
    log(f"phase 18d hierarchical_psum (4 gloo ranks on the card, pod 2 x "
        f"data 2): exact max |err| {exact_err:.3e}; int8 relative error "
        f"{rel:.4f} (reference's bound 0.02)")
    if exact_err > 0 or rel >= 0.02:
        raise AssertionError("18d: hierarchical_psum disagrees")
    return dict(exact_max_abs_err=exact_err, int8_rel_err=rel)


def run_phase_tp(torch, np, smi):
    """Phase 18 in order, timed per sub-phase. Returns the launches of the
    sharded runs (rank 0's plus every other rank's), the 18c rows and the
    summary."""
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.tp import make_model_group

    log(f"phase 18, tensor-parallel serving: ranks sharing the card under "
        f"gloo ({smi})")
    times, summary = {}, {}
    t0 = time.perf_counter()
    rows, timer = [], Timer(torch)
    tp_shard_cases(torch, timer, recorder(torch, rows))
    del timer
    torch.cuda.empty_cache()
    times["18c"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, params, params_q, _ = build_main_params(torch)
    times["params"] = time.perf_counter() - t0
    acc = {}

    def take(reports):              # every rank's launches, summed
        for rep in reports:
            for k, v in rep["launches"].items():
                acc[k] = acc.get(k, 0) + v

    t0 = time.perf_counter()
    ec1 = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0)
    base = tp_serve(torch, np, cfg, params, ec1, "18a mesh 1", 16, 32)
    base[4].close()
    tg = time.perf_counter()
    with make_model_group(2, ["cuda:0"] * 2, timeout_s=300) as group:
        summary["18a_group_start_s"] = time.perf_counter() - tg
        ec2 = dataclasses.replace(ec1, mesh_model=2,
                                  mesh_devices=("cuda:0",) * 2)
        sharded = tp_serve(torch, np, cfg, params, ec2, "18a mesh 2", 16, 32,
                           group)
        take(sharded[3])
        summary["18a"] = tp_compare(torch, "18a bf16", 2, base, sharded,
                                    FP_KERNELS, params)
        sharded[4].close()
        summary["18a_prefix"] = tp_prefix(np, cfg, params, group)
        take(summary["18a_prefix"].pop("reports"))
    del sharded, base, params
    torch.cuda.empty_cache()
    times["18a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ec1q = EngineConfig(n_slots=8, capacity=640, page_size=16, seed=0,
                        kv_dtype="int8", weight_dtype="int8")
    base = tp_serve(torch, np, cfg, params_q, ec1q, "18b mesh 1", 8, 16)
    base[4].close()
    tg = time.perf_counter()
    with make_model_group(4, ["cuda:0"] * 4, timeout_s=300) as group:
        summary["18b_group_start_s"] = time.perf_counter() - tg
        ec4 = dataclasses.replace(ec1q, mesh_model=4,
                                  mesh_devices=("cuda:0",) * 4)
        sharded = tp_serve(torch, np, cfg, params_q, ec4, "18b mesh 4", 8,
                           16, group)
        take(sharded[3])
        lm = sharded[4].params["lm_head"]["w_packed"]
        if lm.shape[0] != cfg.vocab_size:
            raise AssertionError("18b: lm_head's 1002 row blocks do not "
                                 "divide 4, yet it was split")
        log("phase 18b: lm_head stays replicated (1002 row blocks, mesh 4)")
        summary["18b"] = tp_compare(torch, "18b int8", 4, base, sharded,
                                    INT8_KERNELS, params_q)
        sharded[4].close()
        del sharded, base, params_q
        torch.cuda.empty_cache()
        times["18b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        summary["18d"] = tp_psum(np, group)
        times["18d"] = time.perf_counter() - t0
    summary["times_s"] = times
    log("phase 18: " + json.dumps({k: v for k, v in summary.items()
                                   if k in ("times_s", "18d",
                                            "18a_group_start_s",
                                            "18b_group_start_s")}))
    log(f"phase 18: {sum(times.values()):.1f} s")
    return acc, rows


# phase 19a's pipeline: 4 microbatches of 2 x 128 tokens through the 16
# packed layers, at 2 and 4 stages
PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_SEQ = (2, 4), 4, 2, 128
# phase 19c's calls, held to their dry runs at mesh 1
DRY_TRAIN = ("train_8x128", 128, 8)
DRY_PREFILL = ("prefill_8x512", 512, 8)
DRY_PEAK_TOL = 0.20
_PIPE = {}


def pipe_model():
    """Phase 19a's model on this rank: llama3.2-1b at full width, 16
    layers, random weights from seed 0 packed bf16 at keep 0.25 on 128 x
    128 blocks — the same tree on every rank (init and pack are
    deterministic on one card), kept for the process."""
    if "params" not in _PIPE:
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import pack_params
        from repro_torch.models import causal_lm
        cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=16,
                                  bcr_keep_frac=0.25, bcr_block=(128, 128))
        dense = causal_lm.init_params(cfg, 0, device="cuda")
        _PIPE.update(cfg=cfg, params=pack_params(cfg, dense))
        del dense
    return _PIPE["cfg"], _PIPE["params"]


def pipe_parts(torch):
    """(cfg, the (kinds, layer) list, the microbatched input (n_micro, mb,
    S, d) bf16 from seed 19, the stage function): a stage is its layers
    through ``causal_lm.layer_apply`` with ``cache=None``, each layer's
    fresh K/V discarded, over one RoPE table every stage shares."""
    from repro_torch.models import causal_lm
    from repro_torch.models import layers as L

    cfg, params = pipe_model()
    layers = list(zip(causal_lm.layer_plan(cfg), params["layers"]))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    x = (torch.randn((PIPE_MICRO, PIPE_MB, PIPE_SEQ, cfg.d_model),
                     generator=gen, device="cuda") * 0.5).to(cfg.act_dtype)
    pos = torch.arange(PIPE_SEQ, device="cuda")[None].expand(PIPE_MB,
                                                             PIPE_SEQ)
    rope_cs = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)

    def stage(mine, xb):
        for kinds, lp in mine:
            xb, _ = causal_lm.layer_apply(kinds, lp, xb, cfg,
                                          rope_cs=rope_cs)
        return xb

    return cfg, layers, x, stage


def pipe_rank(n_stages: int):
    """One rank of 19a (``ModelGroup.call``; every rank of the 4 calls it):
    ranks ``0 .. n_stages-1`` run ``pipeline_apply`` over their own
    stage's packed layers, the launch counters zeroed just before and read
    just after. Returns the output's bf16 bits, the launches, the
    schedule's stats and the wall (None on a rank outside the pipeline)."""
    import torch
    import torch.distributed as dist

    from repro_torch.runtime.pipeline_parallel import (pipeline_apply,
                                                       split_stages)

    rank = dist.get_rank()
    group = (dist.new_group(list(range(n_stages)))
             if n_stages < dist.get_world_size() else None)
    if rank >= n_stages:
        return None
    with torch.no_grad():
        cfg, layers, x, stage = pipe_parts(torch)
        mine = split_stages(layers, n_stages)[rank]
        stats = {}
        stage(mine, x[0])          # warm: this process's first launches
        torch.cuda.synchronize()
        dist.barrier(group=group)
        zero_counters()
        t0 = time.perf_counter()
        out = pipeline_apply(stage, mine, x, group=group, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in read_counters().items() if v}
    return dict(rank=rank, bits=out.view(torch.int16).cpu().numpy(),
                launches=launches, wall_s=wall, layers=len(mine), **stats)


def phase_pipeline(torch, np):
    """Phase 19a: GPipe over ranks sharing the card under gloo (one group
    of 4; the 2-stage run on its first two ranks), each stage's packed
    layers through ``bcr_spmm`` and ``bcr_spmm_grouped``; every rank's
    output bit-equal to the same stage functions applied in sequence on
    one rank (rank 0, before the group starts). Returns the launches over
    both runs (every rank's) and the summary."""
    from repro_torch.runtime.pipeline_parallel import (
        pipeline_bubble_fraction, split_stages)
    from repro_torch.serving.tp import make_model_group

    t0 = time.perf_counter()
    with torch.no_grad():
        cfg, layers, x, stage = pipe_parts(torch)
        stage(layers, x[0])        # warm: this process's first launches
        torch.cuda.synchronize()
        ts = time.perf_counter()
        seq = torch.stack([stage(layers, x[m]) for m in range(PIPE_MICRO)])
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - ts) * 1e3
    want = seq.view(torch.int16).cpu().numpy()
    summary = dict(model_s=time.perf_counter() - t0, sequential_ms=seq_ms)
    acc = {}
    tg = time.perf_counter()
    with make_model_group(4, ["cuda:0"] * 4, timeout_s=300) as group:
        summary["group_start_s"] = time.perf_counter() - tg
        for n in PIPE_STAGES:
            got = [g for g in group.call(pipe_rank, n) if g is not None]
            for g in got:
                if not np.array_equal(g["bits"], want):
                    raise AssertionError(f"19a: {n} stages, rank "
                                         f"{g['rank']}'s output differs "
                                         f"from the sequential stages")
                for k, v in g["launches"].items():
                    acc[k] = acc.get(k, 0) + v
            for k in ("bcr_spmm", "bcr_spmm_grouped"):
                if any(not g["launches"].get(k) for g in got):
                    raise AssertionError(f"19a: a rank never launched {k}")
            summary[f"stages_{n}"] = dict(
                wall_ms=max(g["wall_s"] for g in got) * 1e3,
                bubble_fraction=pipeline_bubble_fraction(PIPE_MICRO, n),
                steps=got[0]["steps"],
                launches_per_rank=[g["launches"] for g in got],
                bytes_sent_per_step=[g["bytes_sent"] / g["steps"]
                                     for g in got],
                layers_per_rank=[g["layers"] for g in got])
            log(f"phase 19a {n} stages: bit-equal to sequential on every "
                f"rank; " + json.dumps(summary[f"stages_{n}"]))
    del seq, x
    _PIPE.clear()
    torch.cuda.empty_cache()
    log(f"phase 19a: sequential {seq_ms:.1f} ms on one rank; "
        f"{json.dumps({k: v for k, v in summary.items() if 'stages' not in k})}")
    return acc, summary


def dryrun_worker(out_path: str) -> int:
    """``--dryrun-worker OUT``: 19b and 19c's dry runs, in a process of
    their own (their fake group never becomes ``chip_smoke``'s): the
    reference's two cells (llama3.2-1b ``decode_32k`` and ``long_500k`` on
    pod16x16), then 19c's two calls at mesh 1, every layer run. Writes the
    records to OUT."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import run_cell

    out_dir = str(Path(out_path).parent / "dryrun")
    recs = {}
    t0 = time.perf_counter()
    for shape in ("decode_32k", "long_500k"):
        recs[shape] = run_cell("llama3.2-1b", shape, multi_pod=False,
                               out_dir=out_dir, force=True)
    recs["ref_s"] = time.perf_counter() - t0
    base = dataclasses.replace(get_config("llama3.2-1b"), num_layers=16)
    t0 = time.perf_counter()
    name, seq, b = DRY_TRAIN
    recs["train"] = run_cell(
        "llama3.2-1b", name, multi_pod=False, out_dir=out_dir, force=True,
        cfg_override=dataclasses.replace(base, bcr_keep_frac=0.25,
                                         bcr_block=(128, 128)),
        shape_override=ShapeSpec(name, seq, b, "train"), mesh_shape=(1, 1),
        exact=True)
    name, seq, b = DRY_PREFILL
    recs["prefill"] = run_cell(
        "llama3.2-1b", name, multi_pod=False, out_dir=out_dir, force=True,
        cfg_override=dataclasses.replace(base, param_dtype="bfloat16"),
        shape_override=ShapeSpec(name, seq, b, "prefill"),
        mesh_shape=(1, 1), exact=True)
    recs["mesh1_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(recs, default=str))
    return 0


def device_ms_of(torch, call) -> float:
    """Device time of one ``call()`` under ``torch.profiler`` (kernels and
    copies)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(ms for _, _, ms in device_events(torch, prof))


def dry_real_calls(torch, np):
    """19c's calls on the card, each from a clean allocator peak: the
    phase-7 train step (llama3.2-1b, 16 layers, fp32 params, ADMM on, 8 x
    128 tokens) and a bf16 prefill of 8 x 512, dense weights as the dry
    run's. ``max_memory_allocated`` less what was allocated before the
    call's state was built, and one more call's device time."""
    from repro_torch.core import admm as admm_mod
    from repro_torch.launch.train import (TrainState, default_prune_filter,
                                          init_state, make_train_step)
    from repro_torch.models import causal_lm
    from repro_torch.optim.adamw import AdamWConfig

    out = {}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = train_cfg(torch)
    state = init_state(cfg, 0, "cuda")
    specs = admm_mod.specs_for(state.params, default_prune_filter(cfg))
    with torch.no_grad():
        admm = admm_mod.admm_init(state.params, specs)
    state = TrainState(state.params, state.opt, admm, None)
    name, seq, b = DRY_TRAIN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    tok = torch.randint(0, cfg.vocab_size, (b, seq + 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "targets": tok[:, 1:].contiguous()}
    step = make_train_step(cfg, AdamWConfig(total_steps=1000),
                           admm_mod.ADMMConfig(), specs)
    torch.cuda.synchronize()
    # the dry run's state is the call's argument: its peak counts from the
    # state on, so the card's does too (state built, peak reset, call)
    state_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    wall = time.perf_counter() - t0
    out["train"] = dict(
        peak_bytes=torch.cuda.max_memory_allocated() - base,
        state_bytes=state_bytes, wall_ms=wall * 1e3,
        device_ms=device_ms_of(torch, lambda: step(state, batch)))
    del state, m, step, admm, specs, batch
    torch.cuda.empty_cache()

    base = torch.cuda.memory_allocated()
    pcfg = dataclasses.replace(cfg, bcr_keep_frac=0.0,
                               param_dtype="bfloat16")
    params = causal_lm.init_params(pcfg, 0, device="cuda")
    name, seq, b = DRY_PREFILL
    tokens = torch.randint(0, pcfg.vocab_size, (b, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, _ = causal_lm.prefill(pcfg, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        del logits, _
        out["prefill"] = dict(
            peak_bytes=peak, state_bytes=state_bytes, wall_ms=wall * 1e3,
            device_ms=device_ms_of(
                torch, lambda: causal_lm.prefill(pcfg, params, tokens)))
    del params
    torch.cuda.empty_cache()
    return out


def run_phase_dryrun(torch, np, smi):
    """Phase 19: 19b and 19c's dry runs in a process of their own, started
    first; 19a (GPipe over ranks sharing the card) and 19c's calls on the
    card meanwhile; then 19b's gates and 19c's comparison. Returns 19a's
    launches (every rank's)."""
    log(f"phase 19, the pod-scale dry run and pipeline parallelism ({smi})")
    times, t_all = {}, time.perf_counter()
    out_path = Path(__file__).resolve().parent / "build" / "dryrun19.json"
    out_path.parent.mkdir(exist_ok=True)
    if out_path.exists():
        out_path.unlink()
    worker = subprocess.Popen([sys.executable, __file__, "--dryrun-worker",
                               str(out_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        acc, pipe = phase_pipeline(torch, np)
        times["19a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        real = dry_real_calls(torch, np)
        times["19c_card"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stdout, stderr = worker.communicate(timeout=600)
        times["wait_dryrun"] = time.perf_counter() - t0
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    if worker.returncode != 0 or not out_path.exists():
        print(stdout[-3000:], stderr[-3000:], file=sys.stderr)
        raise RuntimeError(f"19b/19c: the dry-run process failed "
                           f"({worker.returncode})")
    recs = json.loads(out_path.read_text())

    # 19b: the reference's dry-run test, with the H100's 80 GiB
    dec, skip = recs["decode_32k"], recs["long_500k"]
    if dec["status"] != "ok":
        raise AssertionError(f"19b: decode_32k {dec['status']}: "
                             f"{dec.get('error')}")
    peak = dec["memory_analysis"]["peak_memory_in_bytes"]
    if (dec["roofline"]["n_chips"] != 256
            or dec["hlo_corrected"]["flops"] <= 0 or peak >= 80 * 2**30):
        raise AssertionError(f"19b: decode_32k record off: {dec['roofline']}"
                             f", peak {peak}")
    if skip["status"] != "skipped" or "sub-quadratic" not in skip["reason"]:
        raise AssertionError(f"19b: long_500k not skipped: {skip}")
    log(f"phase 19b: llama3.2-1b decode_32k on pod16x16 ok: 256 ranks, "
        f"peak {peak / 2**30:.3f} GiB a rank (< 80 GiB), flops "
        f"{dec['hlo_corrected']['flops']:.4e} a rank, roofline "
        f"{json.dumps(dec['roofline'])}; long_500k skipped "
        f"('{skip['reason'][:60]}...'); {recs['ref_s']:.1f} s (build "
        f"{dec['timings']['build_s']:.1f}, run {dec['timings']['run_s']:.1f})")

    # 19c: the dry run's predictions against the card
    summary = {}
    for key in ("train", "prefill"):
        rec = recs[key]
        if rec["status"] != "ok":
            raise AssertionError(f"19c {key}: dry run {rec['status']}: "
                                 f"{rec.get('error')}")
        pred = rec["memory_analysis"]["peak_memory_in_bytes"]
        held = rec["memory_analysis"]["argument_size_in_bytes"]
        r = rec["roofline"]
        row = dict(
            predicted_peak_bytes=pred, measured_peak_bytes=real[key][
                "peak_bytes"], predicted_state_bytes=held,
            measured_state_bytes=real[key]["state_bytes"],
            peak_ratio=real[key]["peak_bytes"] / pred,
            predicted_s=max(r["compute_s"], r["memory_s"]),
            compute_s=r["compute_s"], memory_s=r["memory_s"],
            measured_device_ms=real[key]["device_ms"],
            measured_wall_ms=real[key]["wall_ms"],
            dryrun_build_s=rec["timings"]["build_s"],
            dryrun_run_s=rec["timings"]["run_s"])
        summary[key] = row
        log(f"phase 19c {key}: predicted peak {pred / 2**30:.3f} GiB, "
            f"max_memory_allocated {real[key]['peak_bytes'] / 2**30:.3f} "
            f"GiB (ratio {row['peak_ratio']:.3f}); predicted "
            f"max(compute, memory) {row['predicted_s'] * 1e3:.2f} ms, "
            f"profiler device time {real[key]['device_ms']:.2f} ms; "
            + json.dumps(row))
        if abs(row["peak_ratio"] - 1) > DRY_PEAK_TOL:
            raise AssertionError(f"19c {key}: the predicted peak is off by "
                                 f"more than {DRY_PEAK_TOL:.0%}")
    times["dryrun_mesh1_s"] = recs["mesh1_s"]
    times["total"] = time.perf_counter() - t_all
    log(f"phase 19: {json.dumps(times)}")
    log(f"phase 19: {times['total']:.1f} s")
    return acc, dict(pipeline=pipe, dryrun=summary)


def bcr_worker(tree: str) -> int:
    """``--bcr-worker TREE``: :func:`bcr_cases`, :func:`paged_cases`,
    :func:`skip_cases` and :func:`flash_cases` against TREE's own
    ``repro_torch`` (built into TREE's build directory); the rows come out
    as one ``bcr rows:`` JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["bcr_spmm", "bcr_spmm_skip", "flash_attention",
                     "paged_attention"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    timer, record = Timer(torch), recorder(torch, rows)
    bcr_cases(torch, timer, gen, record)
    paged_cases(torch, timer, gen, record)
    skip_cases(torch, timer, gen, record)
    flash_cases(torch, timer, gen, record)
    print("bcr rows: " + json.dumps(rows), flush=True)
    return 0


def bcr_ab(trees) -> int:
    """``--bcr-ab TREE...``: one :func:`bcr_worker` process per TREE, in the
    order given (e.g. ``build/parent . . build/parent`` to compare a parent
    checkout with this one on one card, in turns). Prints each run's
    kernel times side by side and writes them to ``build/bcr_ab.json``."""
    import torch

    if not torch.cuda.is_available() or not trees:
        print("chip_smoke: --bcr-ab needs a CUDA device and at least one "
              "tree", file=sys.stderr)
        return 2
    smi = smi_line()
    runs = []
    for tree in trees:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--bcr-worker", tree],
                             capture_output=True, text=True, timeout=1500)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("bcr rows: ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"bcr worker for {tree} failed "
                               f"({out.returncode})")
        runs.append((tree, json.loads(lines[-1][len("bcr rows: "):])))
        log(f"{tree}: {time.perf_counter() - t0:.1f} s")
    log(smi)
    log("kernel | shape | " + " | ".join(f"{t} ms" for t, _ in runs)
        + " | bound ms | library ms")
    for i, row in enumerate(runs[0][1]):
        times = [r[i]["ms"] for _, r in runs]
        log(f"{row['kernel']} | {row['shape']} | "
            + " | ".join(f"{t:.4f}" for t in times)
            + f" | {row['bound_ms']:.4f} | {row['library_ms']:.4f}")
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "bcr_ab.json").write_text(json.dumps(
        {"device": smi, "runs": [{"tree": t, "rows": r} for t, r in runs]},
        indent=1))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--bcr-ab"]:
        return bcr_ab(sys.argv[2:])
    if sys.argv[1:2] == ["--bcr-worker"] and len(sys.argv) == 3:
        return bcr_worker(sys.argv[2])
    if sys.argv[1:2] == ["--dryrun-worker"] and len(sys.argv) == 3:
        return dryrun_worker(sys.argv[2])
    paper_only = sys.argv[1:] == ["--paper"]
    families_only = sys.argv[1:] == ["--families"]
    encdec_only = sys.argv[1:] == ["--encdec"]
    train_only = sys.argv[1:] == ["--train"]
    tune_only = sys.argv[1:] == ["--tune"]
    tp_only = sys.argv[1:] == ["--tp"]
    dryrun_only = sys.argv[1:] == ["--dryrun"]
    if len(sys.argv) > 1 and not (paper_only or families_only
                                  or encdec_only or train_only or tune_only
                                  or tp_only or dryrun_only):
        print("usage: chip_smoke.py [--bcr-ab TREE... | --bcr-worker TREE | "
              "--paper | --families | --encdec | --train | --tune | --tp | "
              "--dryrun]", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1, device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"phase 2, build: {time.perf_counter() - t0:.1f} s for "
        f"{sorted(paths)}")
    for name, path in paths.items():
        log_text = path.with_suffix(".log").read_text()
        regs = [ln.split("Used")[1].strip() for ln in log_text.splitlines()
                if "Used" in ln]
        spills = [ln.strip() for ln in log_text.splitlines()
                  if "spill" in ln and "0 bytes spill stores" not in ln]
        log(f"  {name}: ptxas {regs}; spills {spills or 'none'}")
    log("BCR instructions (cuobjdump -sass of the built library)")
    bcr_instruction_check(paths["bcr_spmm"])
    tc_instruction_check(paths["bcr_spmm_skip"], paths["flash_attention"],
                         paths["paged_attention"])
    if paper_only:
        phase_paper(torch, np)
        log(smi)
        return 0
    if families_only:
        log("phase 14's kernel shapes (phase 3's checks)")
        t0 = time.perf_counter()
        rows, timer = [], Timer(torch)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        family_cases(torch, timer, gen, recorder(torch, rows))
        log("phase 14 kernel cases: " + json.dumps(rows))
        del timer
        torch.cuda.empty_cache()
        log(f"phase 14 kernel shapes: {time.perf_counter() - t0:.1f} s")
        log("phase 14, the vlm, ssm and hybrid families")
        family_launches = phase_families(torch, np)
        log(f"phase 14 launches: {json.dumps(family_launches)}")
        log(smi)
        return 0
    if encdec_only:
        encdec_launches = run_phase_encdec(torch, np)
        log(f"phase 15 launches: {json.dumps(encdec_launches)}")
        log(smi)
        return 0
    if train_only:
        train_launches = run_phase_train(torch, np, smi)
        log(f"phase 16 launches: {json.dumps(train_launches)}")
        log(smi)
        return 0
    if tune_only:
        tune_launches = run_phase_tune(torch, np, smi)
        log(f"phase 17 launches: {json.dumps(tune_launches)}")
        log(smi)
        return 0
    if tp_only:
        tp_launches, tp_rows = run_phase_tp(torch, np, smi)
        log("phase 18 kernel cases: " + json.dumps(tp_rows))
        log(f"phase 18 launches: {json.dumps(tp_launches)}")
        log(smi)
        return 0
    if dryrun_only:
        pipe_launches, _ = run_phase_dryrun(torch, np, smi)
        log(f"phase 19 launches: {json.dumps(pipe_launches)}")
        log(smi)
        return 0

    log("phase 3, kernels against their plain versions")
    t0 = time.perf_counter()
    timer = Timer(torch)
    rows = phase_kernels(torch, timer)
    log("kernel cases: " + json.dumps(rows))
    del timer
    torch.cuda.empty_cache()
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    log("phase 4, bf16 main path")
    t0 = time.perf_counter()
    cfg, params, params_q, fracs = build_main_params(torch)
    direct, launches, traj = phase_main_path(torch, np, cfg, params,
                                             fracs[0])
    torch.cuda.empty_cache()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    log("phase 5, quantized main path (int8 tiles, int8 KV, flash prefill)")
    t0 = time.perf_counter()
    _, q_launches, _ = phase_quantized_path(torch, np, cfg, params_q,
                                            fracs[1])
    forced_flip_rate(torch, np, cfg, params, params_q, traj)
    del params, params_q
    torch.cuda.empty_cache()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    log("phase 6, engines against naive generate")
    t0 = time.perf_counter()
    phase_engine_vs_naive(torch, np)
    phase_engine_vs_naive(torch, np, quantized=True)
    torch.cuda.empty_cache()
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    log("phase 7, GRIM's pruning path at full width (train_loop, "
        "pack_params, bcr_spmm_skip)")
    t0 = time.perf_counter()
    _, skip_launches = phase_trainer(torch, np, smi)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    log("phase 8, checkpoint resume on the card")
    t0 = time.perf_counter()
    phase_resume(torch, np, Path(__file__).resolve().parent / "build"
                 / "chip_smoke_ckpt")
    torch.cuda.empty_cache()
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    log("phase 9, prefix cache and lifecycle")
    t0 = time.perf_counter()
    # phases 4 and 5's weights again (same seed; freed before phase 7 so
    # its peak memory is the trainer's own)
    cfg, params, params_q, _ = build_main_params(torch)
    _, append_launches = phase_prefix_full_width(torch, np, cfg, params,
                                                 quantized=False)
    _, append_launches_q = phase_prefix_full_width(torch, np, cfg, params_q,
                                                   quantized=True)
    del params, params_q
    torch.cuda.empty_cache()
    for kv_dtype in ("", "int8"):
        phase_prefix_correctness(torch, np, kv_dtype)
    phase_lifecycle(torch, np)
    torch.cuda.empty_cache()
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    log("phase 10, speculative decoding, the capacity-dense pool, SLO "
        "admission and tenancy")
    t0 = time.perf_counter()
    from repro_torch.launch.serve import build_draft
    cfg, params, params_q, _ = build_main_params(torch)
    draft = build_draft(cfg, bcr_keep=0.25, device="cuda", log=log)
    _, verify_launches = phase_speculative(torch, np, cfg, params, draft,
                                           quantized=False)
    _, verify_launches_q = phase_speculative(torch, np, cfg, params_q,
                                             draft, quantized=True)
    del params_q
    phase_unpaged(torch, np, cfg, params, traj)
    del draft
    torch.cuda.empty_cache()
    phase_speculative_fp32(torch, np)
    phase_admission(torch, np)
    torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    log("phase 11, the serving entry points on the card (HTTP server, "
        "open-loop traffic, launch.api)")
    t0 = time.perf_counter()
    _, serving_launches = phase_serving(torch, np, cfg, params, traj, direct)
    del params
    torch.cuda.empty_cache()
    phase_api_subprocess(torch, np)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    log(f"phase 12, the MoE family on the card ({MOE_ARCH}: expert-batched "
        f"bcr_spmm / bcr_spmm_grouped)")
    t0 = time.perf_counter()
    cfg, params, params_q, fracs = build_moe_params(torch)
    _, moe_launches, _ = phase_moe_serving(torch, np, cfg, params, fracs[0],
                                           quantized=False)
    _, moe_launches_q, _ = phase_moe_serving(torch, np, cfg, params_q,
                                             fracs[1], quantized=True)
    del params, params_q
    torch.cuda.empty_cache()
    phase_moe_engine_vs_naive(torch, np)
    torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    log("phase 13, the source paper's own workloads (the GRU, the im2col "
        "CNN, Listing 1, the examples)")
    t0 = time.perf_counter()
    gru_launches, gru_ms = phase_paper(torch, np)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")

    log("phase 14, the vlm, ssm and hybrid families (pixtral-12b, rwkv6-3b, "
        "jamba-v0.1-52b)")
    t0 = time.perf_counter()
    family_launches = phase_families(torch, np)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")

    encdec_launches = run_phase_encdec(torch, np)
    train_launches = run_phase_train(torch, np, smi)
    tune_launches = run_phase_tune(torch, np, smi)
    tp_launches, tp_rows = run_phase_tp(torch, np, smi)
    log("phase 18 kernel cases: " + json.dumps(tp_rows))
    pipe_launches, _ = run_phase_dryrun(torch, np, smi)

    # one entry per kernel form at its decode-step shape (M = 8 slots) or,
    # for flash, the largest cold-prefill bucket; launches from the main
    # path that runs it (for bcr_spmm_skip, the trained-weight runs of the
    # pruning path: the skip form is not on the serving path)
    path_launches = {**{k: launches[k] for k in FP_KERNELS},
                     **{k: q_launches[k] for k in INT8_KERNELS},
                     "flash_attention_fused":
                         q_launches["flash_attention_fused"],
                     "bcr_spmm_skip": skip_launches,
                     # the expert-batched forms run on phase 12's path only
                     **{k: (moe_launches_q if "int8" in k
                            else moe_launches)[k] for k in EXPERT_FORMS}}
    kernels = []
    for name, (source, replaces, shape) in KERNELS.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["shape"] == shape)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["kernel"] == name),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], serving_launches=serving_launches[name],
            family_launches=family_launches.get(name, 0),
            encdec_launches=encdec_launches.get(name, 0),
            train_launches=train_launches.get(name, 0),
            tune_launches=tune_launches.get(name, 0),
            tp_launches=tp_launches.get(name, 0),
            pipe_launches=pipe_launches.get(name, 0)))
        if name in TP_KERNEL_ROWS:
            # phase 18c: the kernel at its tp = 2 shard shape
            tp_row = next(r for r in tp_rows
                          if r["shape"] == TP_KERNEL_ROWS[name])
            kernels[-1].update(tp_shape=tp_row["shape"], tp_ms=tp_row["ms"],
                               tp_bound_ms=tp_row["bound_ms"])
        if name in FP_KERNELS + INT8_KERNELS + ("flash_attention_fused",):
            # phase 12's MoE path runs these too (deepseek's shapes)
            kernels[-1]["moe_launches"] = (
                moe_launches_q if "int8" in name or name.startswith("flash")
                else moe_launches)[name]
        if name in VERIFY_ROWS:
            # phase 10a's path: launches over the model-drafter run (its
            # form's run: bf16, or int8 + flash), time at the verify shape
            kernels[-1].update(
                verify_launches=(verify_launches_q if name in INT8_KERNELS
                                 else verify_launches)[name],
                verify_ms=next(r["ms"] for r in rows if r["kernel"] == name
                               and r["shape"] == VERIFY_ROWS[name]))
        if name == "flash_attention_fused":
            kernels[-1]["verify_launches"] = verify_launches_q[name]
        if name == "bcr_spmm":
            # phase 13a's path: one packed fp32 GRU step at batch 1
            kernels[-1].update(gru_launches=gru_launches, gru_ms=gru_ms)
        if name in ("paged_attention", "paged_attention_int8"):
            # the prefill-append form: its launches on phase 9a's shared
            # run, its time at phase 9a's append admission (phase 3)
            kernels[-1].update(
                append_launches=append_launches if name == "paged_attention"
                else append_launches_q,
                append_ms=next(r["ms"] for r in rows if r["kernel"] == name
                               and r["shape"] == APPEND_SHAPE))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
