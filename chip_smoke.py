#!/usr/bin/env python3
"""On-card smoke test of tensorflow_train_distributed_torch on an H100.

    python3 chip_smoke.py            # one H100

1. Device: prints the card's name and power limit, requires compute
   capability 9.0, builds the CUDA kernels from ``csrc/`` and, beside
   them, the native host libraries from ``native/src/`` (g++), and prints
   the build times.
2. Kernels against their plain PyTorch versions on the card, at the serving
   path's shapes: RMSNorm [8, 4096] and [128, 4096] bf16; paged attention
   over 8 lanes, 32 heads (MHA), head_dim 128, block 16, 64 blocks a lane,
   ragged lengths up to 1,024 rows, q_len 1, bf16 and int8 pools, and the
   engine's short lanes (90-130 rows, bf16); the paged KV gather of the
   same pool at all 8 lanes and at the engine's radix hit (one lane's 64
   blocks), and of the int8 engine's f32 scale pool, bitwise with every
   body.  Prints each kernel's error against its stated tolerance,
   median time (CUDA events, launches queued back to back behind a device
   sleep so host overhead is not timed), bound, the plain version's time
   and one PyTorch library call's time as a yardstick the port never calls.
   RMSNorm, paged attention and the gather name the body that served
   them (K1f: warp or block; K4: ring or staged; K5: bulk or block) and
   time the other body on the same inputs.
3. The serving engine on Llama-2-7B at full width and depth (bf16, random
   weights from a seed): 8 slots, chunk 8, cache_len 1024, block 16; a
   dozen greedy requests of 16-300 prompt tokens, two sharing a 64-token
   prefix, 32 new tokens each.  The kernels' launch counts are zeroed just
   before and read just after; every kernel must have run, and paged
   attention exactly layers x decode steps.  Prints decode ms/step,
   tokens/s and peak memory, and checks the engine against a re-prefill of
   prompt + generated tokens in a fresh cache.  The linear leg: the same
   weights and requests on the linear engine (``paged=False``: per-slot
   strips, decode through the masked einsum), held by the same check at
   the same bars; RMSNorm must run and neither paged attention nor the
   gather; its tokens' agreement with the paged run and its decode ms a
   step beside the paged one are logged.  The autosize leg, once both
   engines are freed: ``serve.py --kv-pool-blocks auto --hbm-headroom
   0.3`` under ``TTD_MEMCHECK=1`` in its own process on phase 3's
   requests: its pool's block count and budget must be the solve's
   (recomputed here from the config and the card's total), the
   sanitizer's peak pool and prefill bytes within the budget, no
   ``MemoryBudgetError``, the peak of allocated memory under the card's
   total, and its greedy tokens phase 3's paged engine's.
4. The same engine with an int8 KV cache at full width and 4 layers.
5. The training kernels against their plain versions at the training
   path's shapes: RMSNorm forward (writing r; its body named and the
   block body timed beside it) and backward (dx and dscale; the block
   body's backward with the einsum column sum, dx alone and
   ``F.rms_norm``'s two-gradient backward timed beside it) at [16384,
   768] bf16 and at mistral_7b_lm's rows [65536, 4096] (phase 10's path);
   cross-entropy
   forward and backward [16384, 32000] f32; flash attention forward and
   backward at llama_125m's B 8, H 12, S 2048, D 64, at Llama-2-7B's
   head (B 1, H 32, S 2048, D 128) and GQA 4:1 over packed rows, causal
   bf16.  Each is held elementwise against an f32 computation of the
   same function and against the plain version, and timed beside its
   bound, the plain version and one library call; flash attention's
   lines name the body that served it and its TFLOP/s.
6. The trainer on llama_125m_lm at full width and depth, built as the
   CLI builds it (b 8 x s 2048, bf16 compute, adamw + clip + warmup
   cosine, 20 steps from seed 0).  Counts are zeroed just before the run
   and read just after; each training kernel must have run exactly
   20 x its launches a step under full remat.  The loss must stay finite
   and fall.  Prints step ms, tokens/s, peak memory, the losses, an MFU
   (its formula beside it) and a profiled step's device time by kind.
6b. (a) One step's gradients of llama_125m cut to 2 layers, kernels
   against the plain versions on the card, at f32 and bf16; (b) five f32
   steps of a small decoder with 64-wide heads on the card against the
   same steps on the CPU.
7. The grouped-matmul kernels (gmm, tgmm) against their plain versions:
   the forward (bf16 x bf16 -> f32), the grad_lhs (f32 x bf16 read
   transposed -> bf16) and the grad_rhs (tgmm, bf16 x f32 -> bf16) at
   moe_370m's expert shapes (16,384 rows, 8 experts, 768 <-> 2048, group
   sizes from a top-2 routing of random tokens), at Mixtral-8x7B's
   (8,192 rows, 4096 <-> 14336, 8 experts) and at Qwen1.5-MoE-A2.7B's
   (8,192 rows, 2048 <-> 1408, 60 experts), and on edge cases (empty
   groups, ragged groups, k and n off the tiles, rows past the sizes'
   sum).  Each is held elementwise against an f32 computation and the
   plain version within ``K.gmm_tolerance`` (each output's own depth),
   and timed beside its bound, the plain per-group loop and
   ``F.grouped_mm`` where that call takes the operands.  Two controls
   must fall outside that bound: the plain result with 32 of one group's
   products left out, and the f32-math products run with the cotangent
   rounded to bf16.
8. The trainer on moe_370m with the dropless gmm dispatch at full width
   and depth, fed as ``tools/bench_moe.py`` feeds the JAX trainer
   (``MoeLmTask``, adamw 1e-4 b2 0.95 wd 0.1, bf16 compute over f32
   params) with ``SyntheticLM`` batches of 8 x 1024, 20 steps from seed
   0.  Counts are zeroed just before the run and read just after; every
   kernel of the path must have run exactly 20 x its launches a step.
   The loss must stay finite and its last window below its first (no
   token can be dropped: every routed row is in the group sizes by
   construction).  Prints step ms, tokens/s, peak memory, the MFU by the
   active-parameter formula and a profiled step's device time by kind.
8b. (a) One step's gradients of moe_370m cut to 2 layers, kernels against
   the plain versions, at f32 and bf16; (b) five f32 steps of
   moe_tiny_lm_gmm on the card against the same steps on the CPU.
9. The splash kernel (K7, forward and backward) against its plain
   version: Mistral-7B's attention (B 1, H 32, KVH 8, S 8192, D 128,
   window 4096, bf16), packed rows with sinks, and edge cases at small
   sizes in f32 and bf16 (window 1, windows off the tile, sinks = window,
   sinks past one tile, window >= S, which must equal K2's causal kernels
   bit for bit).  Each is held elementwise against an f32 computation of
   the same function and against the plain version; the first two are
   timed, with the body that served them (wgmma, mma.sync or FMA) and
   their TFLOP/s, beside the bound, the plain version,
   ``local_attention_chunked`` (K7's CPU path),
   SDPA with the band as a boolean mask and ``flex_attention`` with a
   sliding-window block mask (compiled where it compiles; never on the
   main path).
10. The trainer on mistral_7b_lm at full width (d 4096, 32 / 8 heads, ffn
   14336, window 4096) cut to 4 layers, built as the CLI builds it (b 8 x
   s 8192, bf16 over f32, adamw + clip + warmup cosine, 10 steps from
   seed 0).  Counts are zeroed just before the run and read just after:
   per step exactly 8 splash / 4 splash backward launches and no flash
   attention, RMSNorm 17 / 9, cross-entropy 1 / 1.  The losses must stay
   finite, and the first batch's must fall under the trained weights
   (a batch the run did not see is read before and after and reported).
   Prints step ms, tokens/s, peak memory, the MFU (its
   formula beside it, attention at the window's mean visible keys) and a
   profiled step's device time by kind.
10b. (a) One step's gradients of the phase-10 model cut to 2 layers at
   b 1 x s 8192, kernels against the plain versions, f32 and bf16; (b)
   five f32 steps of a small windowed decoder (window 128, 4 sinks, seq
   512) on the card (K7) against the same steps on the CPU
   (``local_attention_chunked``).

11. The launcher (``python -m tensorflow_train_distributed_torch``) on
   llama_125m_lm at full width and depth.  A run that is killed, or whose
   process is the point, is a subprocess; the others call ``launch.run``
   in this process under the backend switches a fresh process has (a
   process spends ~9 s importing torch on the card's machine): (a) 12
   steps with a checkpoint every 4 (keep 2), the last 100 of
   SyntheticLM's 100,000 sequences held out and evaluated for 4 batches
   every 6 steps and at the end, a JSON-lines log and
   ``--tensorboard-dir``, whose scalars, read back with the port's own
   reader, must be every step's loss and (a)'s logged losses and
   evaluations; (b+c) one ``--supervise`` command with the step-8 save
   torn and a kill -9 at step 10 (``--fault-plan``, attempt 0): the
   journal must read one crash by SIGKILL, a clean exit and ``done``,
   and the relaunch must quarantine ``corrupt/8``, restore step 4, take
   the data up mid-epoch and end with a step-12 checkpoint bit for bit
   equal to (a)'s and the same evaluations; (d) ``--eval-only`` on (a)'s
   directory, which must report (a)'s final ``loss`` and ``perplexity``;
   (k) (a)'s run with ``--steps-per-execution 4`` (a save every 6, which
   lands at the dispatch boundary 8) and ``--profile-dir`` over steps
   4-8: its step-12 checkpoint must equal (a)'s bit for bit, its launches
   (a)'s, and its trace must hold the port's kernels.  Runs (a) and (k)
   report kernel launches, which must be 12 training steps and 12
   evaluation batches' worth; each run reports its step time, save,
   restore and evaluation seconds and bytes; (e) the launcher on phase
   6's flags (20 steps, read every 5, ``--log-grad-norm``, no checkpoint
   or evaluation), whose step time stands beside phase 6's.  The LoRA
   leg: (f) 8 steps with rank-8 adapters on query and value and a save
   every 4, (g+h) the same under ``--supervise`` killed at step 6, whose
   relaunch's step-8 checkpoint must equal (f)'s bit for bit; (f)'s
   launches must be 8 x ``lora_launches_per_step``; then ``serve
   --checkpoint-dir`` on (f)'s directory (the adapters merged per its
   ``lora_spec.json``, ``serve.main`` in this process) answers 4 greedy
   requests on the card with the tokens of ``serve --params-npz`` of an
   npz of ``merge_lora(params)`` the script writes.  The checkpoint
   directories are deleted at the end, but for (a)'s, which phase 21's
   ``sample.py`` reads and deletes.

12. K2's full (non-causal) attention at BERT-base's heads (B 256, H 12,
   S 128, D 64) and Transformer-big's (B 64, H 16, S 256, D 64), f32 (as
   both configs compute) and bf16, and causal f32 at the Transformer's;
   K3f and K3b at BERT's logits [32768, 30522] f32 (V % 4 = 2: the
   kernels' scalar loads), at V 30,521 and at LeNet's [128, 10].  Each held against an f32
   computation and the plain version, timed beside its bound, the plain
   version and SDPA or ``F.cross_entropy``.
13. bert_base_mlm through the launcher at full width and depth (b 256 x
   s 128, mixed_bfloat16, 12 steps, a save every 6, 4 held-out
   evaluation batches; in this process); the same killed at step 9 and
   rerun (subprocesses), whose
   step-12 checkpoint must equal the uninterrupted run's bit for bit
   (dropout 0.1 on: the (seed, step) generator).  K2 forward and backward
   12 a step, K3f and K3b 1, exactly.
14. transformer_big_wmt through the launcher at full width and depth
   (seq 256 so attention meets K2's gate, b 64, 20 steps, a save), then
   ``--eval-only`` (both in this process) beam search (beam 4) of one batch of 8 and its BLEU.
   K2 18 forward and 18 backward a step, exactly; the beam search's
   launches counted too.
15. resnet50_imagenet through the launcher (224², b 256, bf16, SGD with
   Nesterov momentum, 12 steps, a save every 6), killed at step 9 and
   rerun, whose step-12 checkpoint must equal the uninterrupted run's
   bit for bit (the launcher pins cuDNN's deterministic algorithms; the
   uninterrupted run is in this process, as in phase 13); 5 steps each
   of the s2d and s2d_bnsub variants (in this process); each of the
   three trainers on one batch already on the card.  No hand kernel runs on this path
   (cuDNN's convolutions; the label-smoothed loss takes no K3).  The
   data-service legs: 10 steps with ``--data-workers W`` (W divides 256
   and leaves two cores; logged), images/s beside the in-process and
   card-fed figures and the share of the step the card waits on the
   host; then 512 JPEGs from seed 0 (around 500 x 375) as a TFRecord
   corpus, 10 steps on ``imagenet_train_u8_224`` through the workers and
   2 evaluation batches on ``imagenet_eval_u8_224`` (where PIL is
   missing, one line says the JPEG leg did not run); the launcher runs in
   this process, its input workers in theirs.
16. mnist (LeNet) through the launcher (in this process), 100 steps: the
   last 10 steps' mean loss at most half the first step's; K3f and K3b once a step.
17. Five f32 steps on the card against the CPU port: a BERT with 64-wide
   heads (K2, K3 at vocab 1,001) and resnet_tiny, whose BatchNorm
   running statistics are held like the params.
   Each launcher run prints its step time, examples a second, peak
   memory and the kernels' launches; checkpoints go under the
   git-ignored ``_family_smoke/``, deleted at the end.
18. llama2_7b_sft with LoRA (rank 8, query and value) at full width and
   depth through the launcher (in this process), random weights from seed
   0, 10 steps; cut
   to b 2 x s 4096 with no checkpoint.  Its kernels first, at its shapes
   (K1f and K1b's dx, the scale being frozen, [8192, 4096] bf16; K3
   [8192, 32000] f32; K2 B 2, H 32, S 4096, D 128 bf16; and K1b's dx at
   phase 11's LoRA rows); then the run, whose launches must be 10 x
   ``lora_launches_per_step``; it logs step time, tokens/s, the MFU of a
   frozen base (formula beside it), peak memory, the parameter counts and
   the losses.  Then at the same width cut to 2 layers, in process: after
   3 steps the base is bitwise unchanged, and the merged model's logits
   are within one bf16 step (relative L2 2^-7) of the unmerged model's.
19. Speculative and pipelined serving of Llama-2-7B at full width and
   depth.  (a) Paged attention at the verify's shapes (8 lanes x 32
   heads x hd 128, up to 1,024 rows, q_len 5 and 8, bf16 and int8, each
   beside q_len 1 on the same lanes) and at a llama_125m draft's (12
   heads x hd 64, q_len 1), the gather on that draft's pool at a radix
   hit, RMSNorm at the verify's [40, 4096] and the draft's [8, 768]
   rows, each held and timed as in phase 2; the host time of the ring
   body's per-call workspace allocation.  (b) Phase 3's requests (#1,
   which shares #0's prefix, moved last) served with the target as its
   own draft at depth 4, greedy, synchronous with atomic admission: the
   consistency check of phase 3 on the verify's logits, acceptance at
   least 0.9 of the drafted tokens, and paged attention launched exactly
   (32 + 32 x 5) x rounds times.  (c) The same with llama_125m_lm from
   random weights as the draft at depths (0, 2, 4): the controller must
   back off to depth 0 and probe; launches exactly target layers x
   rounds + 12 x the draft's steps; the consistency check.  (d) The
   overlap and staged prefill (budget 256) off and on, plain (in turns:
   off, on, on, off) and with the self draft: greedy tokens bit for bit
   equal within each pair, an overlap ratio above 0 on.  Each run logs
   decode time a step (plain) or a round and an emitted token (spec),
   tokens/s, acceptance, tokens a slot and round, the overlap ratio, the
   prefill stall and peak memory; the share of positions where the self
   draft's greedy tokens equal the plain engine's is reported.
20. Lane control of the engine, Llama-2-7B at full width and depth (bf16,
   random weights from seed 0), phase 3's engine shape.  (a) 12 requests
   (prefill pieces of 64): after the first step cancel a queued request
   and a decoding lane (under the overlap its chunk is in flight), after
   the next a staged prefill, on the synchronous engine with staged
   prefill and on the pipelined one: the others finish whole with the
   same tokens on both, and only radix-held blocks stay in use.  (b)
   ``preload_prefix`` of a 512-token system prompt, then 8 requests that
   extend it: all 8 hit its 512 tokens in the radix, through K5; time to
   first token beside an engine without the preload.  (c) A decoding
   lane exported twice (equal), installed into a second engine, whose
   pool rows K5 reads back bitwise equal to the blob, bf16 and int8
   pools; re-admitted with ``resume_from``, the agreement of its greedy
   tokens after the cut with the exporting engine's own continuation of
   the lane is a reading, with the teacher-forced logit gap where they
   first part; on an f32 pool, the witness, they must agree throughout.
   K1f, K4 and K5 counted on the path's legs only (not the warm-ups,
   the engine without the preload, the second export, the uninterrupted
   run or the read-back); the export and the resumed radix hit must
   each launch K5.
21. ``generate()`` at full width.  (a) mistral_7b at full width and depth
   (window 4096) on a 6,000-token prompt, whose fresh prefill pads to
   6,016 rows for K7, and 256 greedy tokens: the 4,096-row ring wraps.
   Each decode step's logits against a teacher-forced forward (K7) of
   prompt + tokens: max |diff| at most 0.25 of max(logit std, 1) at
   every position and argmax agreement at least 0.9; K7 exactly 32
   launches, no K2, K1f 65 a forward (256 forwards).  Prefill seconds,
   ms a token, tokens/s, peak memory beside the ring's memory.  (b) The
   same at 4 layers with 4 sinks; then the bars' controls, 64 tokens at
   4 layers: a ring slot off by one, stale ring rows, the sinks dropped
   and the fresh prefill without its band, each of which must fail the
   bars at a window of 64 (at 4,096 they are readings).  (c) Llama-2-7B
   ``generate()`` of 64 tokens on a
   1,000-token prompt (K2 on 1,024 rows, 32 launches), its tokens against
   teacher forcing.  (d) ``generate_speculative`` of Llama-2-7B at 4
   layers with itself as the draft, k 4: acceptance at least 0.9, and
   the share of its tokens equal to ``generate()``'s.  (e)
   ``sample.py``'s ``main`` (in this process) on phase 11's checkpoint:
   exit 0 and ``generate()``'s tokens.  K1f,
   K2 and K7 counted over (a)-(d).
22. MoE decode and serving, and int8 weight-only serving, at full width
   and depth (random weights from seed 0).  First the kernels at the
   phase's shapes: K6 at a decode step (8 slots x top-4 = 32 token copies
   padded to 128 rows over Qwen's 60 groups, most of them empty, the pad
   in the last group; Mixtral's 16 copies over 8) and at ``generate()``'s
   1,000-token prefill, each beside its byte bound (the weights of the
   groups that hold rows), the plain version and bf16-output
   ``F.grouped_mm``; K1f at Qwen's [8, 2048] and [1000, 2048], K4 over
   Qwen's 16 heads, K5 at a 4-block radix hit, K2 at the prefill.  (a)
   qwen15_moe_a27b in bf16 through ``serve.py``'s ``main`` with
   ``--dispatch gmm`` (24 layers, 60 experts top-4, the gated shared
   expert, qkv biases, vocab 151,936), phase 3's engine shape and
   requests: tokens, K4 at layers x decode steps, a radix hit through K5,
   K6 on every forward, decode logits against teacher forcing
   (``_consistency``), TPOT, tokens/s, TTFT of 8 fresh prompts, peak
   memory and the decode step's byte bound; (b) the same on the dense
   dispatch (exact-length prefill, no radix, no K5 or K6); (c) the same
   in int8, checked against its own teacher forcing, its bytes beside
   bf16's, its greedy tokens beside (b)'s, and int8 with gmm raising; (d)
   mixtral_8x7b in int8 on the dense dispatch, each weight drawn in bf16
   on the card and quantized at once, 8 requests, peak memory under the
   card's with the headroom logged (its teacher forcing re-prefills each
   prompt as the engine did and feeds the rest at a capacity that does
   not bind, as decode routes it); (e) ``generate()`` on Qwen, gmm bf16
   and dense int8, a 1,000-token prompt and 32 tokens against teacher
   forcing (``DECODE_TOL``, ``DECODE_AGREE``), prefill seconds and ms a
   token; (f) ``sample.py --dispatch gmm`` and ``--quant int8 --dispatch
   dense`` on a 2-step launcher checkpoint of moe_tiny_lm_gmm, tokens
   equal to ``generate()``'s.  K1f, K4, K5 and K6 counted over (a)-(d),
   K1f, K2 and K6 over (e).
23. The serving fleet on Llama-2-7B at full width and depth (bf16, random
   weights from seed 0), phase 3's 12 requests (16-300 tokens, #0 and #1
   sharing a 64-token prefix, 32 new, greedy), every engine built from
   ``serve_http.py``'s parsed flags (phase 3's shape: 8 slots, chunk 8,
   cache_len 1024, block 16; the default pipelined engine).  (a)
   ``ServingGateway`` over two in-process replicas on the card: #0 first,
   then the other 11 concurrently over HTTP, 4 of them streaming; every
   stream concatenates to its reply, ``/metrics`` parses and its request
   and token counters equal what was sent, #1 lands on #0's replica
   (KV affinity) and reads its prefix back through K5; K1f, K4 and K5
   counted across both driver threads (``fleet_serve``), K4 at layers x
   the decode steps of both engines.  (b) ``serve_http --replica-procs
   --replicas 2`` as a process (workers built by
   ``serve.worker_engine_factory``; the parent must not initialise CUDA):
   the 12 requests, one worker SIGKILLed once a stream on it has begun;
   every request answers 200, ``/healthz`` shows the corpse "killed", the
   failover counter moves, the pool respawns it within its restart
   budget; then 8 long streams on both workers and SIGTERM with
   ``--drain-timeout``: the draining worker's lanes migrate (the final
   metrics' migration counter >= 1, each migration installing KV rows,
   no re-prefill), every stream answers whole.  (c) ``serve_http
   --listen 127.0.0.1:0`` with one ``serve_worker --role prefill`` and one
   ``--role decode`` (the same factory): the 12 requests through the KV
   handoff, its bytes and tokens read from each request's timeline.
   Every leg's tokens are held by teacher forcing through replica 0's
   model at phase 3's bars: each generated token within 2 x 0.25 of
   max(std, 1) of the re-prefill's best logit (what phase 3's gap bar
   allows between two argmaxes), at least half of them its argmax; their
   agreement with phase 3's batch run is logged, and the fleet's mean
   inter-token time (``ttd_gateway_inter_token_seconds``) beside phase
   3's decode step.  Each leg logs its seconds.
24. ViT and HuggingFace interop.  (a) vit_b16_imagenet through the
   launcher (in this process) at full width and depth, 224², batch 256
   (the registry's 1024 cut for one card, as phase 15 cuts ResNet's),
   f32 compute (VitConfig's dtype: the launcher's bfloat16 policy rounds
   each weight to bf16 on use, the products run in f32), 12 steps with
   the final save and evaluation, then
   ``--eval-only`` of the checkpoint, which must equal the run's final
   evaluation; no kernel may run (S 196 is not a multiple of 128, so
   attention takes the dense path, as the JAX gate sends it on a TPU; the
   label-smoothed loss is plain PyTorch); step ms, images/s and peak
   memory, and the trainer fed one batch already on the card.  vit_tiny
   (label smoothing 0, K3 at [8, 10]) five f32 steps on the card against
   the CPU port, its zero-gradient parameters (the key biases) found from
   the CPU's gradient and the card's held to round-off.  (b)
   llama_125m_lm at full width and depth: phase 11's
   run (a) checkpoint exported with ``export_hf_checkpoint`` (f32
   ``pytorch_model.bin``), ``--eval-only --init-from-hf`` of it equal bit
   for bit to phase 11's evaluation, 4 ``--init-from-hf`` steps (each
   training kernel counted, path ``hf_train``), and ``sample.py`` and
   ``serve.py`` with ``--init-from-hf`` giving the ``--checkpoint-dir``
   runs' greedy tokens.  (c) Llama-2-7B at full width, 2 of 32 layers,
   random bf16 weights: ``export_llama`` (one 2.7-GB
   ``pytorch_model.bin``; ``hf_export_full_depth()``, not in the default
   run, writes all 32 layers' 5-GB shards) and ``import_llama`` back
   onto the card (seconds and bytes of each), phase 3's requests on the
   paged engine with the imported weights (path ``hf_serve``: K1f, K4 at
   layers x decode steps, K5 at the shared prefix), tokens equal to the
   same engine's on the source weights.  (d) ``export_program`` of phase
   16's mnist checkpoint (traced on the CPU), loaded and run on the card
   at two batch sizes against ``predict_fn`` on the restored weights.
25. Multi-GPU code paths on one card (the card's machine has one GPU, so
   no collective crosses two cards here).  (a) K6 with ``group_offset``
   (K6-EP: an expert shard's rows, zeros elsewhere) at Qwen1.5-MoE-A2.7B's
   width (E 60, D 2048, F 1408, 4,096 tokens x top-4, 4 shards of 15
   experts) and at moe_370m's training shapes (16,384 rows, 2 and 4
   shards): each shard's forward (bf16 -> f32), grad_lhs (f32 x bf16 ->
   bf16) and tgmm against ``gmm_reference``/``tgmm_reference`` with the
   offset within ``K.gmm_tolerance``, every row outside the shard exactly
   0, the shards' outputs summed equal to the unsharded kernel's bit for
   bit and each tgmm shard equal to its slice of the unsharded one bit
   for bit; shard 0 timed beside the unsharded kernel at the same width,
   its bound (the live groups' bytes and products) and ``F.grouped_mm``
   over the same local groups.  (b) moe_370m's MoE block (gmm, b 8 x s
   1024, bf16 over f32) with its expert group emulated in this process:
   E/4 experts a shard through ``moe.expert_rows(..., group_offset=e0)``,
   the rows summed where the expert-parallel path all-reduces them, then
   ``combine_rows``; against the unsharded block the output bit for bit,
   the tokens' gradient within relative L2 1e-4 and each shard's stack
   gradients its slice bit for bit; the K6-EP launches counted over this
   drive alone.  (c) The launcher through ``init_process_group("nccl")``
   at world size 1 (``--num-processes 1 --process-id 0
   --coordinator-address``), in this process: llama2_7b_sft LoRA under
   its registry strategy fsdp_tp (a 1x1 mesh here), phase 18's flags, its
   losses equal to phase 18's bit for bit; moe_370m (gmm) under
   ``--strategy dp_ep --zero1 --grad-quant int8`` for 5 steps, with the
   JAX data=1 warning, its losses equal to the plain single-process run's
   bit for bit.  At world size 1 the expert axis is 1: (c) runs the
   unsharded gmm dispatch and checks the NCCL init, the mesh knobs'
   no-op and the warning, not ``group_offset`` (which (a) and (b) do).
26. Sequence, pipeline and tensor-split serving on one card.  (a)
   ``parallel.ring_attention.ring_attention`` for 4 shards emulated in
   this process at Mistral-7B's attention (B 1, H 32, KVH 8, D 128, bf16,
   S 16,384), causal and window 4,096 with 4 sinks: the output and q/k/v
   gradients against an f32 computation (phase 9's bar) and against K2 or
   K7 over the whole sequence; ms a shard.  (b) Ulysses' local attention
   on each shard's 8 heads through the dispatch (K7): 4 forward and 4
   backward launches, the heads equal to one call over all 32 bit for
   bit; K7 timed at a shard's shape.  (c) llama_125m as 4 emulated GPipe
   stages (3 layers each, 8 microbatches of 1 x 2,048) through
   ``parallel.pipeline``'s tick schedule, forward and backward: the loss
   and gradients against the depth loop (phase 6b's bound) and the
   launch counts the schedule predicts (``gpipe_launches``).  (d)
   ``ServingEngine(mesh=)`` at tensor 2: Llama-2-7B at full width and
   ``SPLIT_LAYERS`` layers in two processes sharing the card over gloo,
   phase 3's requests and engine settings, phase 3's re-prefill bar on
   each rank, K4 = layers x decode steps a rank, each rank's peak memory;
   K4 and K5 timed at a rank's 16 heads.
27. The bench tools (``tensorflow_train_distributed_torch/tools/``)
   under the card lock the script holds from phase 1 on: in this process
   bench_lm (llama_125m, 8 x 2048, a traced window after the timed one),
   bench_moe (moe_370m, gmm), bench_bert (bert_base, bf16), bench_vit
   (vit_b16, bf16), each for 2 warm-up and 3 timed steps; bench_generate
   (llama_125m, 8 x 128 + 32), bench_serving (llama_125m, 8 requests) and
   a 2-client bench_gateway (llama_125m); then ``tools/bench.py
   --families lm`` in a process of its own.  Each record must name this
   card, have inherited the lock, and give a finite rate, an MFU in (0, 1)
   or an MBU in (0, 1]; bench_lm's step within 1.5x of phase 6's;
   bench.py's last line a headline under 500 bytes, its family's record
   the lock inherited; ``profile_summary`` of bench_lm's trace with 2
   steps, ``_profile_train_step``'s kinds, and time in each training
   kernel's kind.
28. The native host runtime and the data-parallel tools, under the same
   lock.  (a) The native libraries (``native/``, built by g++ in phase 1
   beside the kernels), ``tools/bench_allreduce --host --world 4`` (the
   native TCP ring over four processes, GB/s on the host clock) and its
   device leg at NCCL world size 1, whose record must carry the one-rank
   copy's rate and no bus bandwidth.  (b) ``tools/bench_grad_quant`` at
   llama_125m full width (8 x 2048, bf16 over f32, ``GQ_STEPS`` steps a
   leg) at NCCL world size 1: the four legs (each resolves to the exact
   step at one data rank, as the JAX trainer does), the kill switch bit
   for bit ``none``, loss parity within the JAX tool's bar, each leg's
   ``train/*`` spans one a step, the headline under 500 bytes; launch
   counts zeroed before and read after, the "grad_quant" path's rows.
   (c) ``tools/bench_input`` on 512 JPEGs from seed 0 without workers:
   PIL, libjpeg on 1, 2 and 4 threads and at half resolution, the
   stager's leg, and the decoder ``decode_image`` chose and why.
29. Memory planning, debug mode and the static lint, in this process under
   the same lock.  (a) ``training.memory.plan_train_memory``'s estimate
   beside the measured peaks (above what the process held before each
   trainer was built) of phase 6 (llama_125m_lm, 8 x 2048, full remat),
   phase 10 (mistral_7b_lm, 4 layers, 8 x 8192) and ``PLAN_RUNS``' two
   2-step runs (llama_125m_lm 16 x 2048 without remat;
   mistral_7b_lm at 2 layers, 8 x 8192): no estimate may fall more than
   ``memory.PLAN_MARGIN`` below its peak; Llama-2-7B's full fine-tune
   (adamw, 16 bytes a parameter) must be refused with nothing allocated.
   (b) ``runtime.debug.debug_mode`` on llama_125m_lm at full width, 1 x
   2048: one step under it equal bit for bit (loss and parameters) to the
   same step without it, its K1f, K1b, K2 and K3 launches counted (the
   "debug" path's rows: phase 5 holds each kernel against its plain
   version at this step's shapes and times it there); then a NaN planted
   in layer 3's query kernel (a row of K2's input) must raise
   ``FloatingPointError`` naming ``flash_attention``, and
   ``assert_tree_finite`` must name that leaf.  (c) ``ttd_lint`` over the
   port and this script: zero findings.  Every printed line is also
   appended to ``chiprun_out/chip_smoke.log``.

Every phase raises on failure; the last line is the JSON device record
only when all passed.  Exits non-zero without CUDA, or when run outside
the repository.
"""

import contextlib
import dataclasses
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

# The H100's peaks, the kernel bounds, the decode byte bound and the MFU
# formulas live in one module of the port.
from tensorflow_train_distributed_torch.tools.roofline import (  # noqa: E402
    ATTENTION_SPLIT_PRODUCTS,
    FORMULAS,
    PEAK_BF16_FLOPS,
    PEAK_F32_FLOPS,
    PEAK_F32_SPLIT_FLOPS,
    RESNET50_FWD_FLOPS,
    bert_flops_per_token,
    bound,
    decode_bytes_per_step,
    decoder_flops_per_token,
    lora_flops_per_token,
    moe_active_params,
    moe_flops_per_token,
    non_embedding_params,
    product_bound,
    transformer_flops_per_token,
    vit_forward_flops,
)
# One table of device-time kinds for every profile the script reads.
from tensorflow_train_distributed_torch.tools.profile_summary import (  # noqa
    KINDS,
    classify,
)

SEED = 0
_CSRC = "tensorflow_train_distributed_torch/csrc/"
_PK = "tensorflow_train_distributed_tpu/ops/pallas_kernels.py"
_FA = "jax/experimental/pallas/ops/tpu/flash_attention.py"
_MB = "jax/experimental/pallas/ops/tpu/megablox/gmm.py"
_SP = ("jax/experimental/pallas/ops/tpu/splash_attention/"
       "splash_attention_kernel.py")
# (name, source, the TPU kernel it replaces, the main path that runs it:
# "serve" (phase 3), "train" (phase 6), "moe_train" (phase 8) or
# "window_train" (phase 10)).
# RMSNorm's forward is on every path; it has a row for serving, llama_125m
# training and mistral_7b_lm training, and its backward one for each
# training path, each with that path's launches and shapes (moe_370m's
# rows are llama_125m's shape).
KERNELS = [
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290", "serve"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121", "serve"),
    # Phase 3's legs: the linear engine runs K1f alone (K4 and K5 must not
    # run); the autosized pool serves through all three.  The numbers
    # beside them are phase 2's at those shapes.
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "linear_serve"),
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "autosize_serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290",
     "autosize_serve"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121",
     "autosize_serve"),
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "train"),
    ("rms_norm_bwd", _CSRC + "rms_norm.cu", _PK + ":429", "train"),
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "train"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584", "train"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "train"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "train"),                                          # and dq, :1287
    ("gmm", _CSRC + "grouped_matmul.cu", _MB + ":314", "moe_train"),
    ("tgmm", _CSRC + "grouped_matmul.cu", _MB + ":573", "moe_train"),
    ("splash_attention", _CSRC + "flash_attention_fwd.cu", _SP + ":895",
     "window_train"),
    ("splash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _SP + ":1857",
     "window_train"),                                   # and dq, :1405
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "window_train"),
    ("rms_norm_bwd", _CSRC + "rms_norm.cu", _PK + ":429", "window_train"),
    # Phase 11: the launcher drives llama_125m_lm's kernels (training and
    # evaluation) in its own process; the numbers beside them are phase
    # 5's, at the same shapes.
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "launch"),
    ("rms_norm_bwd", _CSRC + "rms_norm.cu", _PK + ":429", "launch"),
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "launch"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584",
     "launch"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "launch"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "launch"),
] + [
    # Phases 13 and 14: BERT's full-attention encoder and fused loss at
    # vocab 30,522, and the Transformer's encoder, causal decoder and
    # cross-attention, all f32 as the configs compute; the numbers beside
    # them are phase 12's at the same shapes.
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "bert"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "bert"),
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "bert"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584", "bert"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "wmt"),
    ("flash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _FA + ":941",
     "wmt"),
    # Phase 16: LeNet's loss (no label smoothing) at [128, 10].
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "mnist"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584",
     "mnist"),
    # Phase 19: speculative serving with a self draft (both models run
    # K1f and K4; K5 reads both pools at the radix hit).  K1f's and K4's
    # numbers are phase 19's at the verify's shapes, K5's phase 2's at
    # the same lane.
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "spec_serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290",
     "spec_serve"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121",
     "spec_serve"),
    # Phase 20: lane control of the engine (cancel, preload, export and
    # install, resumed lanes) at phase 3's shapes; the numbers beside
    # them are phase 2's at those shapes.
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "lane_control"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290",
     "lane_control"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121",
     "lane_control"),
    # Phase 21: generate()'s fresh prefill (K2 for Llama-2-7B's 1,024
    # padded rows, K7 for mistral_7b's 6,016) and K1f on every forward;
    # measured at those shapes (K1f at the prefill's [6000, 4096]).
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "generate"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "generate"),
    ("splash_attention", _CSRC + "flash_attention_fwd.cu", _SP + ":895",
     "generate"),
    # Phase 22: MoE serving (qwen15_moe_a27b gmm, dense and int8; K6 on
    # the gmm leg, K5 at its radix hit), mixtral_8x7b int8 serving (K4 at
    # 4 query heads a kv head) and MoE generate() (Qwen, gmm and dense
    # int8); measured at those shapes.
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "moe_serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290",
     "moe_serve"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121",
     "moe_serve"),
    ("gmm", _CSRC + "grouped_matmul.cu", _MB + ":314", "moe_serve"),
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "mixtral_serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290",
     "mixtral_serve"),
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "moe_generate"),
    ("flash_attention", _CSRC + "flash_attention_fwd.cu", _FA + ":589",
     "moe_generate"),
    ("gmm", _CSRC + "grouped_matmul.cu", _MB + ":314", "moe_generate"),
    # Phase 23 (a): the fleet's two in-process replicas, counted across
    # both driver threads; the numbers beside them are phase 2's at phase
    # 3's shapes.
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "fleet_serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290",
     "fleet_serve"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121",
     "fleet_serve"),
] + [
    # Phase 11's LoRA leg (llama_125m_lm, rank 8 on query and value,
    # through the launcher; the numbers beside them are phase 5's at the
    # same shapes, K1b's dx alone, as the frozen scale asks) and phase 18
    # (llama2_7b_sft LoRA at full width and depth; its rows measured at
    # its shapes).
    (name, _CSRC + src, where, path)
    for path in ("lora_launch", "lora_7b")
    for name, src, where in (
        ("rms_norm", "rms_norm.cu", _PK + ":396"),
        ("rms_norm_bwd", "rms_norm.cu", _PK + ":429"),
        ("cross_entropy", "cross_entropy.cu", _PK + ":545"),
        ("cross_entropy_bwd", "cross_entropy.cu", _PK + ":584"),
        ("flash_attention", "flash_attention_fwd.cu", _FA + ":589"),
        ("flash_attention_bwd", "flash_attention_bwd.cu", _FA + ":941"))
]
# Phase 24: vit_tiny's loss (label smoothing 0) at [8, 10], measured there;
# (b)'s 4 --init-from-hf steps of llama_125m_lm (phase 5's shapes) and
# (c)'s engine on the imported Llama-2-7B-width weights (phase 2's).
KERNELS += [
    ("cross_entropy", _CSRC + "cross_entropy.cu", _PK + ":545", "vit_tiny"),
    ("cross_entropy_bwd", _CSRC + "cross_entropy.cu", _PK + ":584",
     "vit_tiny"),
] + [(name, source, where, "hf_train")
     for name, source, where, path in KERNELS if path == "launch"] + [
    (name, source, where, "hf_serve")
    for name, source, where, path in KERNELS if path == "serve"]
# Phase 11's run (k): the launcher's kernels, 4 steps a trainer call.
KERNELS += [(name, source, where, "launch_fused")
            for name, source, where, path in KERNELS if path == "launch"]
# Phase 25 (b): K6 with a group_offset (K6-EP), counted apart, over the
# one-card expert-parallel decomposition of moe_370m's block; measured in
# (a) at that block's shapes (4 shards of 2 experts).
KERNELS += [
    ("gmm_ep", _CSRC + "grouped_matmul.cu", _MB + ":314", "ep_block"),
    ("tgmm_ep", _CSRC + "grouped_matmul.cu", _MB + ":573", "ep_block"),
]
# Phase 26 (b): Ulysses' local attention, K7 over each emulated shard's 8
# of Mistral-7B's 32 heads at S 16,384; (d): the tensor-split engine's
# kernels on one rank (16 of Llama-2-7B's heads; K1f's rows are whole).
KERNELS += [
    ("splash_attention", _CSRC + "flash_attention_fwd.cu", _SP + ":895",
     "ulysses"),
    ("splash_attention_bwd", _CSRC + "flash_attention_bwd.cu", _SP + ":1857",
     "ulysses"),
    ("rms_norm", _CSRC + "rms_norm.cu", _PK + ":396", "split_serve"),
    ("paged_attention", _CSRC + "paged_attention.cu", _PK + ":290",
     "split_serve"),
    ("paged_kv_gather", _CSRC + "paged_kv_gather.cu", _PK + ":121",
     "split_serve"),
]
# Phase 28 (b): bench_grad_quant's four legs at llama_125m, phase 5's
# shapes (8 x 2048 bf16); the numbers beside them are phase 5's.
KERNELS += [(name, source, where, "grad_quant")
            for name, source, where, path in KERNELS if path == "train"]
# Phase 29 (b): one llama_125m step under debug mode at 1 x 2048; the
# numbers beside them are phase 5's cases at that shape.
KERNELS += [(name, source, where, "debug")
            for name, source, where, path in KERNELS if path == "train"]
SERVE_KERNELS = [k[0] for k in KERNELS if k[3] == "serve"]
LANE_KERNELS = [k[0] for k in KERNELS if k[3] == "lane_control"]
FLEET_KERNELS = [k[0] for k in KERNELS if k[3] == "fleet_serve"]
GENERATE_KERNELS = [k[0] for k in KERNELS if k[3] == "generate"]
SPEC_SERVE_KERNELS = [k[0] for k in KERNELS if k[3] == "spec_serve"]
LAUNCH_KERNELS = [k[0] for k in KERNELS if k[3] == "launch"]
TRAIN_KERNELS = [k[0] for k in KERNELS if k[3] == "train"]
# The MoE trainer runs the training kernels and the grouped matmuls.
MOE_TRAIN_KERNELS = TRAIN_KERNELS + [k[0] for k in KERNELS
                                     if k[3] == "moe_train"]


# Every timed case of phases 2 and 5 that the kernels' JSON line does not
# carry (the other body's time, shapes off the main path), printed as one
# JSON line.
CASES = []


_T0 = time.perf_counter()


# Every line the script prints is also appended here: a caller that keeps
# only the end of the output reads the rest from the file.
LOG_PATH = os.path.join("chiprun_out", "chip_smoke.log")


def _tee(line: str) -> None:
    print(line, flush=True)
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    with open(LOG_PATH, "a") as f:
        f.write(line + "\n")


def log(msg: str) -> None:
    """Print ``msg`` (and append it to ``LOG_PATH``); a phase's heading
    ("== ...") also gets the seconds since the script started."""
    if msg.startswith("=="):
        msg = f"{msg}  [{time.perf_counter() - _T0:.1f} s]"
    _tee(msg)


def _drain_stamps(log_every: int):
    """A trainer callback holding, in ``times``, the host time at which
    each ``log_every``-th step's metrics arrive (each drain of the
    metrics waits for the device)."""
    from tensorflow_train_distributed_torch.training.callbacks import (
        Callback,
    )

    class Stamps(Callback):
        def __init__(self):
            self.times = []

        def on_step_end(self, step, metrics):
            if step % log_every == 0 and "loss" in metrics:
                self.times.append(time.perf_counter())

    return Stamps()


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# The H100's top SM clock, cycles a second (sizes the device sleep).
SM_HZ = 1.98e9


def device_ms(fn, *, launches: int = 40, repeats: int = 5,
              warmup: int = 3) -> float:
    """Median over ``repeats`` of the mean device time of ``launches``
    back-to-back calls, timed with CUDA events.  A device sleep queued
    first keeps the stream busy while the host enqueues, so the events
    bracket device work only: twice the host's time for the launches
    (a warmup call's, the first included), within 5e6 and 5e7 cycles."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / max(warmup, 1)
    torch.cuda.synchronize()
    cycles = int(min(max(2 * launches * host_s * SM_HZ, 5e6), 5e7))
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def in_turns(fn, other_fn) -> tuple:
    """``device_ms`` of ``fn`` and of ``other_fn`` taken in turns (fn,
    other, other, fn), each the mean of its two: for two calls whose
    times lie within the drift of the card's clock over one timing."""
    a = device_ms(fn)
    b = device_ms(other_fn) + device_ms(other_fn)
    return (a + device_ms(fn)) / 2, b / 2


def _fma_note(fma) -> str:
    return "" if fma is None else f", FMA route's bound {fma[0] * 1e3:.1f} us"


# -- phase 1 ------------------------------------------------------------------


# Phase 1's build of the native host libraries (phase 28 reports it).
NATIVE_BUILD: dict = {}


def _build_native(out: dict) -> None:
    from tensorflow_train_distributed_torch import native

    t0 = time.perf_counter()
    try:
        out["core"] = native.build()
        native.load_jpeg_library()
        out["jpeg_ok"] = True
    except native.NativeUnavailable as e:
        out["error"] = str(e)
    out["seconds"] = time.perf_counter() - t0


def phase_device():
    import torch
    from tensorflow_train_distributed_torch.ops import cuda_build

    log(f"card: {smi_line()}")
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {torch.cuda.get_device_name(0)} capability {cap} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is "
                           f"sm_{cap[0]}{cap[1]}")
    t0 = time.perf_counter()
    # The native host libraries (g++) build beside the kernels (nvcc).
    native_build = {}
    thread = threading.Thread(target=_build_native, args=(native_build,))
    thread.start()
    try:
        cuda_build.library()
    finally:
        thread.join()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({cuda_build.build_info.get('path')})")
    log(f"native build: {json.dumps(native_build)}")
    if "error" in native_build:
        raise RuntimeError(f"native build: {native_build['error']}")
    NATIVE_BUILD.update(native_build)
    for line in cuda_build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")


# -- phase 2 ------------------------------------------------------------------


def _worst_ratio(got, want, allowed) -> float:
    """max |got - want| / allowed elementwise (0 where they are equal)."""
    import torch

    diff = (got.float() - want.float()).abs()
    return torch.where(diff == 0, 0.0, diff / allowed).max().item()


def _check(what, got, want, allowed, rule) -> float:
    """Elementwise ``|got - want| <= allowed``; logs and returns the max
    absolute error, raises where any element is outside."""
    worst = _worst_ratio(got, want, allowed)
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {what}: max_abs_err {err:.3e}; worst |err| / allowed "
        f"{worst:.3f} (allowed: {rule}) {'ok' if worst <= 1 else 'FAIL'}")
    if not worst <= 1:
        raise AssertionError(f"{what}: error {err:.3e} outside {rule}")
    return err


def _report(name, shape, ms, plain_ms, lib_ms, bnd, body=None):
    served = f" ({body} body)" if body else ""
    log(f"  {name} {shape}: kernel {ms * 1e3:.1f} us{served}, bound "
        f"{bnd[0] * 1e3:.1f} us ({bnd[1]}), plain {plain_ms * 1e3:.1f} us, "
        f"library {lib_ms * 1e3:.1f} us")


def _other_body_ms(other, fn) -> dict:
    """Times the kernel's body ``other``, the one the library did not
    choose, on the same inputs (``fn(other)``)."""
    ms = device_ms(lambda: fn(other))
    log(f"    the {other} body on the same inputs: {ms * 1e3:.1f} us")
    return {f"{other}_body_ms": ms}


def _paged_case(label, q, kp, vp, sc, table, lengths, c) -> dict:
    """K4 on one pool and set of lanes: held against the f32 reference
    and the plain version, timed beside both bodies, its bound, the plain
    version and SDPA over the gathered rows."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    lanes, q_len, heads, hd = q.shape
    kw = {} if sc is None else dict(k_scales=sc[0], v_scales=sc[1])
    body = K.paged_attention_body(q, kp, vp)
    out = K.paged_attention(q, kp, vp, table, lengths, **kw)
    ref = K.paged_attention_reference(q, kp, vp, table, lengths, **kw)
    # The f32 reference is the same math as the kernel's: the query is
    # rescaled so that it applies the bf16-rounded scale the bf16 path
    # applies, and int8 rows come dequantised through bf16 as the kernel
    # and the reference dequantise them.
    s_bf16 = torch.tensor(hd ** -0.5, dtype=torch.bfloat16).item()
    s_f32 = torch.tensor(hd ** -0.5, dtype=torch.float32).item()
    q32 = q.float() * (s_bf16 / s_f32)
    if sc is None:
        k32, v32 = kp.float(), vp.float()
    else:
        k32 = (kp.to(q.dtype) * sc[0][..., None].to(q.dtype)).float()
        v32 = (vp.to(q.dtype) * sc[1][..., None].to(q.dtype)).float()
    ref32 = K.paged_attention_reference(q32, k32, v32, table, lengths)
    del k32, v32
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    log(f"  paged_attention {label}: {body} body; outputs up to "
        f"{ref32.abs().max().item():.3f}, median magnitude "
        f"{ref32.abs().median().item():.3f}")
    # The kernel keeps f32 to the end and rounds its output once to bf16
    # (at most 2^-8 of the value), plus the f32 tests' 2e-5 for another
    # summation order.
    _check(f"paged_attention {label} vs f32 reference", out, ref32,
           2 ** -8 * ref32.abs() + 2e-5, "2^-8 |ref32| + 2e-5")
    # The plain version on the same inputs also rounds logits and softmax
    # weights to bf16: its own distance from the f32 math, measured here,
    # is allowed on top.
    err = _check(f"paged_attention {label} vs its plain version", out, ref,
                 (ref.float() - ref32).abs() + 2 ** -8 * ref32.abs() + 2e-5,
                 "|ref - ref32| + 2^-8 |ref32| + 2e-5")

    def call(body=None):
        return K.paged_attention(q, kp, vp, table, lengths, body=body, **kw)

    ms = device_ms(call)
    plain = device_ms(lambda: K.paged_attention_reference(
        q, kp, vp, table, lengths, **kw), launches=10)
    # SDPA over the rows the lanes can see (whole pool blocks), gathered
    # and dequantised beforehand: the same function on the same inputs.
    bs = kp.shape[1]
    rows = min(c, -(-(int(lengths.max().item()) + q_len) // bs) * bs)
    kc = K.paged_kv_gather_reference(kp, table, rows)
    vc = K.paged_kv_gather_reference(vp, table, rows)
    if sc is not None:
        kc = kc.to(q.dtype) * K.paged_kv_gather_reference(
            sc[0][..., None], table, rows).to(q.dtype)
        vc = vc.to(q.dtype) * K.paged_kv_gather_reference(
            sc[1][..., None], table, rows).to(q.dtype)
    pos = torch.arange(rows, device=q.device)
    # Query i of a lane sits at lengths + i and sees the rows up to it.
    at = lengths.long()[:, None] + torch.arange(q_len, device=q.device)
    mask = (pos[None, None, :] <= at[:, :, None])[:, None]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kc, vc))
    kvh = kp.shape[2]
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=heads != kvh))
    # Bytes: each lane's rows read once, whatever number of queries reads
    # them (those the last query sees); operations: every visible pair.
    visible = (lengths.long() + q_len).clamp(max=c).sum().item()
    pairs = (at + 1).clamp(max=c).sum().item()
    nbytes = (visible * kvh * hd * kp.element_size() * 2
              + q.numel() * 2 * 2 + table.numel() * 4 + lanes * 4
              + (visible * kvh * 4 * 2 if sc else 0))
    bnd = bound(nbytes, 4 * pairs * heads * hd, PEAK_BF16_FLOPS)
    over = f" over {kvh} kv heads" if kvh != heads else ""
    shape = (f"{lanes} lanes x {heads} heads{over} x hd {hd}, "
             f"q_len {q_len}, bs {bs}, {table.shape[1]} blocks, "
             f"{visible} visible rows, {label}")
    _report("paged_attention", shape, ms, plain, lib, bnd, body)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib)
    return dict(row, case=label, body=body, visible_rows=visible,
                **_other_body_ms("staged", call))


def phase_kernels() -> dict:
    """Kernel vs plain version at the slice's shapes; returns the rows of
    the kernels' JSON line (without launch counts)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}

    # RMSNorm: [8, 4096] (a decode step) and [128, 4096] (prefill rows).
    d = 4096
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(
        torch.bfloat16)
    for n in (8, 128):
        row = _rms_serve_case(gen, n, scale)
        if n == 8:      # the decode step's shape goes into the JSON line
            rows["rms_norm"] = row

    # Paged pool: 8 lanes x 64 blocks of 16 rows, 32 kv heads x 128.
    lanes, heads, hd, bs, n_blk = 8, 32, 128, 16, 64
    nb = 1 + lanes * n_blk
    c = n_blk * bs
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = perm[:lanes * n_blk].view(lanes, n_blk).to(torch.int32)
    lengths = torch.randint(16, c - 1, (lanes,), generator=gen, device=dev,
                            dtype=torch.int32)
    q = torch.randn(lanes, 1, heads, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    kpool = torch.randn(nb, bs, heads, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    vpool = torch.randn(nb, bs, heads, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    k8 = torch.randint(-127, 128, (nb, bs, heads, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (nb, bs, heads, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand(nb, bs, heads, generator=gen, device=dev) / 127 + 1e-4
    vs = torch.rand(nb, bs, heads, generator=gen, device=dev) / 127 + 1e-4
    # The engine's short lanes: 90-130 rows, as its profiled chunk fills
    # them (100-token prompts and the tokens decoded since).
    short = torch.randint(90, 131, (lanes,), generator=gen, device=dev,
                          dtype=torch.int32)
    for label, kp, vp, sc, lens in (
            ("bf16", kpool, vpool, None, lengths),
            ("int8", k8, v8, (ks, vs), lengths),
            ("bf16, short lanes", kpool, vpool, None, short)):
        case = _paged_case(label, q, kp, vp, sc, table, lens, c)
        CASES.append(dict(case, kernel="paged_attention"))
        if label == "bf16":      # the main path's pool type
            rows["paged_attention"] = {
                k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}

    # Gather (K5), bitwise for every body that runs, on the bf16 pool and
    # the int8 engine's f32 scale pool [nb, bs, 32, 1] (128-byte rows):
    # all 8 lanes (64 MiB of bf16 rows) and the engine's radix hit, one
    # lane's [1, 64] table (8 MiB).  The one-lane calls take the lanes in
    # turn, so each reads blocks the seven calls before it did not (cold
    # in the 50 MB L2, as the engine's 32-layer pool is).  The bf16 cases
    # are timed with every body and in turns with index_select over the
    # same blocks (the two copies run at about the same rate); the
    # engine's lane is the main path's shape.
    one_lane = [table[i:i + 1] for i in range(lanes)]
    for label, pool, tables, timed in (
            ("bf16, 8 lanes", kpool, [table], True),
            ("bf16, the engine's lane", kpool, one_lane, True),
            ("f32 scales, 8 lanes", ks[..., None], [table], False),
            ("f32 scales, the engine's lane", ks[..., None], one_lane,
             False)):
        row = _gather_case(label, pool, tables, c, timed)
        if label == "bf16, the engine's lane":
            rows["paged_kv_gather"] = row
    return rows


def _rms_serve_case(gen, n, scale) -> dict:
    """K1f at [n, d] bf16 rows: held to one bf16 step of the plain
    version, timed beside its bound, the plain version, ``F.rms_norm``
    and the other body; returns the kernels line's row."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    d = scale.shape[0]
    x = torch.randn(n, d, generator=gen, device=gen.device).to(
        torch.bfloat16)
    y = K.rms_norm(x, scale)
    ref = K.rms_norm_reference(x, scale)
    torch.cuda.synchronize()
    # Both compute in f32 and round once to bf16; f32 results a few ulps
    # apart may round to neighbouring bf16 values, and one bf16 step is
    # at most 2^-7 of the value.
    err = _check(f"rms_norm [{n}, {d}] bf16", y, ref,
                 2 ** -7 * ref.float().abs() + 1e-6,
                 "one bf16 step: 2^-7 |ref| + 1e-6")
    body = K.rms_norm_body(x, scale)
    ms = device_ms(lambda: K.rms_norm(x, scale))
    plain = device_ms(lambda: K.rms_norm_reference(x, scale))
    lib = device_ms(lambda: F.rms_norm(x, (d,), scale, 1e-5))
    bnd = bound(2 * n * d * 2 + d * 2, 4 * n * d, PEAK_F32_FLOPS)
    _report("rms_norm", f"[{n}, {d}] bf16", ms, plain, lib, bnd, body)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib)
    CASES.append(dict(row, kernel="rms_norm", case=f"[{n}, {d}] bf16",
                      body=body, **_other_body_ms(
                          "warp" if body == "block" else "block",
                          lambda b: K.rms_norm_forward(
                              x, scale, 1e-5, with_r=False, body=b))))
    return row


def _gather_case(label, pool, tables, c, timed):
    """K5 over ``pool`` through each of ``tables``, bitwise against its
    plain version with every body that runs; when ``timed``, timed in
    turns with ``index_select`` over the same blocks (the calls take the
    tables in turn, so each reads blocks the call before did not) beside
    its bound, the plain version and the other body.  Returns the row
    (None untimed)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    body = K.paged_kv_gather_body(pool)
    runs = [b for b in K.PAGED_KV_GATHER_BODIES
            if b == "block" or body != "block"]
    for b in runs:
        for t in tables:
            out = K.paged_kv_gather(pool, t, c, body=b)
            if not torch.equal(out, K.paged_kv_gather_reference(pool, t, c)):
                raise AssertionError(f"paged_kv_gather {label}, {b} body: "
                                     f"not bitwise")
    torch.cuda.synchronize()
    log(f"  paged_kv_gather {label}: {body} body; bitwise equal ok "
        f"(bodies {runs})")
    if not timed:
        return None
    turn = itertools.cycle(tables)
    flats = itertools.cycle([t.reshape(-1) for t in tables])

    def call(b=None):
        return K.paged_kv_gather(pool, next(turn), c, body=b)

    ms, lib = in_turns(call, lambda: pool.index_select(0, next(flats)))
    plain = device_ms(lambda: K.paged_kv_gather_reference(
        pool, next(turn), c))
    bnd = bound(2 * out.numel() * out.element_size()
                + tables[0].numel() * 4, 0, PEAK_BF16_FLOPS)
    shape = (f"pool {list(pool.shape)} {str(pool.dtype)[6:]} -> "
             f"[{out.shape[0]}, {c}], {label}")
    _report("paged_kv_gather", shape, ms, plain, lib, bnd, body)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib)
    others = {}
    for b in runs:
        if b != body:
            others.update(_other_body_ms(b, call))
    CASES.append(dict(row, kernel="paged_kv_gather", case=label,
                      body=body, **others))
    return row


# -- phases 3 and 4 -----------------------------------------------------------


def _requests(rng, n, lo, hi, vocab, prefix_len):
    """``n`` prompts of lo..hi tokens; #0 and #1 share a ``prefix_len``
    prefix (adjacent, so #1's admission finds #0's blocks)."""
    prefix = rng.integers(1, vocab, prefix_len).tolist()
    prompts = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        body = rng.integers(1, vocab, length).tolist()
        prompts.append(prefix + body[:max(1, length - prefix_len)]
                       if i < 2 else body)
    return prompts


def _teacher_forced(eng, toks, n_prompt, tail_model=None, split=False):
    """Logits [len(toks) - 1, V] f32 of ``toks[:-1]`` through the engine's
    model in a fresh batch-1 cache, in one call; with ``tail_model`` (the
    same weights at a routing capacity that never binds) the prompt is
    prefilled alone, as the engine prefilled it, and the generated tokens
    go through ``tail_model``, routed as decode routes them.  ``split``
    feeds the generated tokens in two calls instead of one."""
    import torch

    model = eng._model
    end = len(toks) - 1
    cuts = [0, end]
    if tail_model is not None or split:
        cuts = [0, n_prompt, end]
    if split:
        cuts.insert(2, n_prompt + (end - n_prompt) // 2)
    cache = model.init_cache(1, eng.cache_len)
    rows = []
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
            m = model if i == 0 else (tail_model or model)
            rows.append(m(torch.tensor([toks[a:b]], device="cuda"),
                          cache)[0])
    return torch.cat(rows).float()


def _consistency(eng, out, checks, max_new, tol, tail_model=None, *,
                 noise=False, floor=0.0, hold=True) -> dict:
    """Teacher-force prompt + generated tokens (all but the last) in a
    fresh batch-1 cache (A, ``_teacher_forced``); compare its last-position
    logits with the decode step that produced the last token, as max
    |diff| / max(std, 1), and count the generated tokens A's argmax agrees
    with (at least half must).  The bar on the gap is ``tol``.  A model
    whose routing flips at near-ties under bf16 rounding (Mixtral's
    renormalized top-2, PERF.md PR 15) parts from itself by more than that:
    ``noise`` teacher-forces each request a second time, the generated
    tokens in two calls (B), and the bar widens to twice the worst last-step
    |A - B| / max(std, 1), or twice ``floor`` (such a floor measured
    before), if that is more.  ``hold=False`` raises on nothing (a planted
    fault's control: ``within`` says whether the readings pass).  Returns
    dict(agree, total, worst, floor, bar, within, requests)."""
    import torch

    agree = total = 0
    worst = 0.0
    reqs = []
    for rid, prompt in checks:
        toks = out[rid]
        n_prompt = len(prompt)
        logits = _teacher_forced(eng, toks, n_prompt, tail_model)
        assert torch.isfinite(logits).all()
        dec = eng.decode_logits[rid]
        if len(dec) != max_new - 1:
            raise AssertionError(f"request {rid}: {len(dec)} decode logits "
                                 f"recorded, expected {max_new - 1}")
        diff = (logits[-1] - dec[-1].float()).abs().max().item()
        scale = logits[-1].std().item()
        pred = logits[n_prompt - 1:].argmax(-1).tolist()
        gen = toks[n_prompt:]
        rec = dict(request=rid, gap=diff / max(scale, 1.0),
                   agree=sum(int(a == b) for a, b in zip(pred, gen)),
                   total=len(gen))
        worst = max(worst, rec["gap"])
        agree += rec["agree"]
        total += rec["total"]
        line = (f"  request {rid}: last-step logits max |diff| {diff:.4f} "
                f"(logit std {scale:.3f})")
        if noise:
            b = _teacher_forced(eng, toks, n_prompt, tail_model, split=True)
            rec["noise"] = ((logits[-1] - b[-1]).abs().max().item()
                            / max(scale, 1.0))
            floor = max(floor, rec["noise"])
            line += (f", {rec['gap']:.4f} of max(std, 1) against |A - B| "
                     f"{rec['noise']:.4f}")
        log(f"{line}; teacher-forced argmax agrees on "
            f"{rec['agree']}/{rec['total']}")
        reqs.append(rec)
    bar = max(tol, 2 * floor)
    res = dict(agree=agree, total=total, worst=worst, floor=floor, bar=bar,
               within=worst <= bar and agree >= 0.5 * total, requests=reqs)
    if hold and worst > bar:
        raise AssertionError(f"decode vs re-prefill logits differ by "
                             f"{worst:.4f} x max(std, 1) > {bar:.4f}")
    log(f"  consistency: worst |diff| / max(std, 1) = {worst:.4f} "
        f"(tolerance {bar:.4f}); tokens agree {agree}/{total}")
    if hold and agree < 0.5 * total:
        raise AssertionError(f"only {agree}/{total} tokens agree")
    return res


def _profile_chunk(eng, vocab):
    """One decode chunk of ``eng.slots`` full lanes under torch.profiler
    (CUPTI): the device's busy share of the chunk's wall time and the
    kernel time by kind.  Profiling adds host time, so the share read
    here is a lower bound of the unprofiled one."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for _ in range(eng.slots):
        eng.submit(rng.integers(1, vocab, 100).tolist(), 2 * eng.chunk + 1)
    eng.serve_step()                   # admissions and the first chunk
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve_step()               # one decode chunk, no admissions
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    kinds = dict.fromkeys(KINDS, 0.0)
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us <= 0:
            continue
        kinds[classify(e.key)] += us
        top.append((us, e.count, e.key[:60]))
    busy = sum(kinds.values())
    if busy == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return None
    top.sort(reverse=True)
    out = dict(chunk_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               busy_share_profiled=busy / wall_us,
               kernel_ms_by_kind={k: v / 1e3 for k, v in kinds.items()})
    log(f"  profile (one chunk of {eng.chunk} steps, {eng.slots} lanes): "
        f"{json.dumps(out)}")
    for us, count, name in top[:8]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {name}")
    return out


def _linear_leg(eng, prompts, paged_out, rids, paged_stats, check_requests,
                tol) -> tuple:
    """Phase 3's linear leg: ``eng``'s weights (shared, not copied) on the
    linear engine (``paged=False``) at its shape, the same requests;
    returns (its launches, its stats)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.serving import ServingEngine

    max_new = len(paged_out[rids[0]]) - len(prompts[0])
    lin = ServingEngine(eng.config, dict(eng._model.state_dict()),
                        slots=eng.slots, chunk=eng.chunk,
                        cache_len=eng.cache_len, paged=False,
                        record_logits=True, overlap=False, prefill_budget=0,
                        device="cuda")
    lin.submit([1] * 16, 2)
    lin.run()
    lin.stats.update(decode_steps=0, decode_s=0.0, prefill_s=0.0,
                     prefill_tokens=0)
    lin.decode_logits.clear()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    lids = [lin.submit(p, max_new) for p in prompts]
    out = lin.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
    log(f"  linear engine launches {counts}")
    if (counts["rms_norm"] <= 0 or counts["paged_attention"]
            or counts["paged_kv_gather"]):
        raise AssertionError(f"the linear engine's launches: {counts}")
    gen = [(out[a][len(p):], paged_out[b][len(p):])
           for a, b, p in zip(lids, rids, prompts)]
    same = sum(x == y for g in gen for x, y in zip(*g))
    total = sum(len(g[0]) for g in gen)
    steps = lin.stats["decode_steps"]
    stats = dict(
        requests=len(lids), wall_s=wall,
        tokens_per_s=len(lids) * max_new / wall,
        decode_ms_per_step=lin.stats["decode_s"] / steps * 1e3,
        paged_decode_ms_per_step=paged_stats["decode_ms_per_step"],
        decode_steps=steps, tokens_equal_paged=same, tokens=total,
        requests_equal_paged=sum(g[0] == g[1] for g in gen),
        kv_blocks_total=lin.kv_blocks_total())
    log(f"  linear engine: {json.dumps(stats)}")
    c = _consistency(lin, out, [(lids[i], prompts[i])
                                for i in check_requests], max_new, tol)
    stats.update(tokens_agree=c["agree"], tokens_checked=c["total"])
    return counts, stats


def phase_autosize(run: dict, headroom: float = 0.3) -> tuple:
    """Phase 3's autosize leg (the module docstring), ``serve.py`` in its
    own process under ``TTD_MEMCHECK=1`` (the sanitizer arms at import);
    ``run`` holds phase 3's config, requests and paged tokens.  Returns
    (its launches, its stats)."""
    import os
    import shutil

    config, prompts, want = run["config"], run["prompts"], run["tokens"]
    root = os.path.abspath("_serve_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        reqs = os.path.join(root, "requests.jsonl")
        with open(reqs, "w") as f:
            for p in prompts:
                f.write(json.dumps({"prompt": p}) + "\n")
        env = dict(os.environ, TTD_MEMCHECK="1")
        env.pop("TTD_NO_MEMCHECK", None)
        env.pop("TTD_HBM_BYTES", None)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tensorflow_train_distributed_torch.serve",
             "--config", run["name"], "--requests", reqs, "--max-new",
             str(run["max_new"]), "--slots", "8", "--chunk", "8",
             "--cache-len", "1024", "--kv-block-size", "16",
             "--kv-pool-blocks", "auto", "--hbm-headroom", str(headroom),
             "--no-overlap", "--no-interleave", "--seed", str(SEED)],
            env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if proc.returncode != 0 or "MemoryBudgetError" in proc.stderr:
        raise AssertionError(f"autosized serve exited {proc.returncode}:"
                             f"\n{proc.stderr[-4000:]}")
    summary = json.loads(proc.stderr.split("serve summary: ", 1)[1]
                         .splitlines()[0])
    got = [json.loads(x)["tokens"] for x in proc.stdout.splitlines()]
    # The solve, recomputed from the config and the card's total: a block
    # is every layer's key and value rows of 16 positions; the grid's
    # constant part the scratch block, the [8, 64] table and 8 positions;
    # the transient a batch-1 linear cache of 1,024 rows and its position.
    import torch

    item = torch.empty((), dtype=config.dtype).element_size()
    block = (config.num_layers * 16 * config.kv_heads
             * config.attn_head_dim * 2 * item)
    intercept = block + 8 * 64 * 4 + 8 * 4
    trans = block * 1024 // 16 + 4
    total = summary["device_total_bytes"]
    usable = int(total * (1.0 - headroom))
    n = (usable - intercept - trans) // block
    mc = summary["memcheck"]
    peaks = mc["peak_by_pool"]
    pooled = peaks.get("kv_pool", 0) + peaks.get("prefill_cache", 0)
    counts = {k: summary["launches"].get(k, 0) for k in SERVE_KERNELS}
    stats = dict(
        card=smi_line(), headroom=headroom, device_total_bytes=total,
        hbm_budget_bytes=summary["hbm_budget_bytes"],
        kv_pool_blocks=summary["kv_pool_blocks"], solve_blocks=n,
        kv_pool_bytes=summary["kv_pool_bytes"],
        memcheck_peak_by_pool=peaks, pool_and_prefill_bytes=pooled,
        peak_mem_bytes=summary["peak_mem_bytes"],
        peak_mem_gib=summary["peak_mem_bytes"] / 2 ** 30,
        tokens_equal_phase3=got == want, launches=counts,
        decode_ms_per_step=summary["decode_s"]
        / summary["decode_steps"] * 1e3,
        prefix_hits=summary["kv_stats"]["prefix_hits"], wall_s=wall)
    log(f"  autosize: {json.dumps(stats)}")
    if (summary["hbm_budget_bytes"] != usable
            or summary["hbm_autosized_bytes"] != usable
            or summary["kv_pool_blocks"] != n):
        raise AssertionError(f"the pool ({summary['kv_pool_blocks']} "
                             f"blocks, budget {summary['hbm_budget_bytes']})"
                             f" is not the solve's ({n}, {usable})")
    if not 0 < pooled <= usable:
        raise AssertionError(f"pool and prefill bytes {pooled} against "
                             f"the budget {usable}")
    if not summary["peak_mem_bytes"] <= total:
        raise AssertionError(f"peak {summary['peak_mem_bytes']} over the "
                             f"card's {total}")
    if min(counts.values()) <= 0 or counts["paged_attention"] != (
            config.num_layers * summary["decode_steps"]):
        raise AssertionError(f"autosized serve's launches {counts}")
    if got != want:
        raise AssertionError("autosized greedy tokens differ from phase "
                             "3's paged engine's")
    return counts, stats


def phase_engine(config, *, label, n_requests, max_new, lo, hi,
                 check_requests, tol, profile_chunk=False,
                 linear_leg=False):
    import numpy as np
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.serving import ServingEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = convert.init_params(config, gen, device="cuda")
    # The synchronous engine with atomic admission, as this phase has
    # always measured it (phase 19 runs the pipelined one beside it).
    eng = ServingEngine(config, params, slots=8, chunk=8, cache_len=1024,
                        kv_block_size=16, record_logits=True, overlap=False,
                        prefill_budget=0, device="cuda")
    del params
    torch.cuda.synchronize()
    log(f"{label}: {config.num_layers} layers, d_model {config.d_model}, "
        f"weights + pool ready in {time.perf_counter() - t0:.1f} s")
    # Warm-up request (cuBLAS handles, allocator), before the counts reset.
    eng.submit([1] * 16, 2)
    eng.run()
    eng.stats.update(decode_steps=0, decode_s=0.0, prefill_s=0.0,
                     prefill_tokens=0)
    eng.decode_logits.clear()
    prompts_rng = np.random.default_rng(SEED)
    prompts = _requests(prompts_rng, n_requests, lo, hi, config.vocab_size,
                        64)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for rid, p in zip(rids, prompts):
        toks = out[rid]
        if (len(toks) != len(p) + max_new or toks[:len(p)] != p
                or not all(0 <= t < config.vocab_size for t in toks)):
            raise AssertionError(f"request {rid}: malformed output")
    steps = eng.stats["decode_steps"]
    generated = len(rids) * max_new
    log(f"  launches {counts}; decode steps {steps}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    if counts["paged_attention"] != config.num_layers * steps:
        raise AssertionError(
            f"paged_attention launches {counts['paged_attention']} != "
            f"layers x decode steps {config.num_layers * steps}")
    if eng.kv_stats["prefix_hits"] < 1:
        raise AssertionError(f"no radix prefix hit: {eng.kv_stats}")
    stats = dict(
        requests=len(rids), generated_tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall,
        decode_ms_per_step=eng.stats["decode_s"] / steps * 1e3,
        decode_steps=steps, prefill_tokens=eng.stats["prefill_tokens"],
        prefill_s=eng.stats["prefill_s"], peak_mem_gib=peak / 2 ** 30,
        kv_stats=dict(eng.kv_stats))
    log(f"  {label}: {json.dumps(stats)}")
    c = _consistency(eng, out, [(rids[i], prompts[i])
                                for i in check_requests], max_new, tol)
    stats.update(tokens_agree=c["agree"], tokens_checked=c["total"])
    run = dict(name=label.split()[0], config=config, prompts=prompts,
               max_new=max_new,
               tokens=[out[r] for r in rids])
    if linear_leg:
        run["linear_counts"], stats["linear"] = _linear_leg(
            eng, prompts, out, rids, stats, check_requests, tol)
    if profile_chunk:
        stats["profile"] = _profile_chunk(eng, config.vocab_size)
    return counts, stats, run


# -- phase 19 -----------------------------------------------------------------

SPEC_K = 4
SPEC_DRAFT = "llama_125m_lm"
SPEC_BUDGET = 256


def _spec_kernel_cases() -> tuple:
    """(a) K4 at the verify's shapes (Llama-2-7B's heads, q_len 5 and 8,
    bf16 and int8, beside q_len 1 on the same pool) and at the draft's
    (llama_125m: 12 heads x hd 64, q_len 1), K5 on the draft's pool at a
    radix hit, K1f at the verify's rows, and the host cost of the ring
    body's per-call workspace.  Returns (the spec_serve rows, that cost
    in us an allocation by size)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    rows = {}
    lanes, bs, n_blk = 8, 16, 64
    nb, c = 1 + lanes * n_blk, n_blk * bs
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = perm[:lanes * n_blk].view(lanes, n_blk).to(torch.int32)
    lengths = torch.randint(16, c - 8, (lanes,), generator=gen, device=dev,
                            dtype=torch.int32)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def pools(heads, hd):
        k8, v8 = (torch.randint(-127, 128, (nb, bs, heads, hd),
                                generator=gen, device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(nb, bs, heads, generator=gen, device=dev) / 127
                  + 1e-4 for _ in range(2))
        return {"bf16": (randn(nb, bs, heads, hd), randn(nb, bs, heads, hd),
                         None),
                "int8": (k8, v8, (ks, vs))}

    target = pools(32, 128)
    q1 = randn(lanes, 1, 32, 128)
    for label, (kp, vp, sc) in target.items():
        kw = {} if sc is None else dict(k_scales=sc[0], v_scales=sc[1])
        ms1 = device_ms(lambda: K.paged_attention(q1, kp, vp, table, lengths,
                                                  **kw))
        log(f"  paged_attention q_len 1, {label}, the same lanes: "
            f"{ms1 * 1e3:.1f} us")
        for q_len in (SPEC_K + 1, 8):
            case = _paged_case(f"verify q_len {q_len}, {label}",
                               randn(lanes, q_len, 32, 128), kp, vp, sc,
                               table, lengths, c)
            # Near q_len x the q_len-1 time, the body re-reads a lane's
            # rows for each query row.
            case.update(q_len=q_len, q_len_1_ms=ms1,
                        ratio_to_q_len_1=case["ms"] / ms1)
            log(f"    {case['ratio_to_q_len_1']:.2f} x the q_len-1 time "
                f"at q_len {q_len}")
            CASES.append(dict(case, kernel="paged_attention",
                              path="spec_serve"))
            if q_len == SPEC_K + 1 and label == "bf16":
                rows["paged_attention"] = {
                    k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}
    del target
    dk, dv, _ = pools(12, 64)["bf16"]
    case = _paged_case("the draft llama_125m, bf16", randn(lanes, 1, 12, 64),
                       dk, dv, None, table, lengths, c)
    CASES.append(dict(case, kernel="paged_attention", path="spec_serve"))
    _gather_case("the draft llama_125m's pool, one lane", dk,
                 [table[i:i + 1] for i in range(lanes)], c, True)
    scale = (1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(
        torch.bfloat16)
    rows["rms_norm"] = _rms_serve_case(gen, lanes * (SPEC_K + 1), scale)
    _rms_serve_case(gen, lanes, (1 + 0.1 * torch.randn(
        768, generator=gen, device=dev)).to(torch.bfloat16))
    # The ring body allocates its merge workspace on every call (from the
    # caching allocator): its host time, for the verify's and a draft
    # step's sizes.
    chunks = c // K.PAGED_CHUNK_ROWS
    alloc_us = {}
    for name, kvh, rows_, hd in (("verify", 32, SPEC_K + 1, 128),
                                 ("step", 32, 1, 128),
                                 ("draft_125m_step", 12, 1, 64)):
        n = kvh * lanes * chunks * rows_ * (hd + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            torch.empty(n, dtype=torch.float32, device=dev)
        alloc_us[name] = (time.perf_counter() - t0) / 2000 * 1e6
    log(f"  K4 ring workspace, host time an allocation: "
        f"{json.dumps(alloc_us)}")
    CASES.append(dict(kernel="paged_attention", path="spec_serve",
                      case="ring workspace allocation, host us",
                      **alloc_us))
    return rows, alloc_us


def _spec_prompts(vocab: int) -> list:
    """Phase 3's requests with #1, which shares #0's 64-token prefix,
    moved to the end: admitted after #0's rows are in the radix index
    under atomic and staged admission alike, so every mode reads it from
    the pool the same way."""
    import numpy as np

    prompts = _requests(np.random.default_rng(SEED), 12, 16, 300, vocab, 64)
    return [prompts[0]] + prompts[2:] + [prompts[1]]


def _spec_run(label, config, params, prompts, max_new, *, record=False,
              **kw):
    """Serve ``prompts`` through a fresh engine (8 slots, chunk 8,
    cache_len 1024, block 16); the counts are zeroed just before and read
    just after.  Returns (engine, outputs, request ids, counts, stats)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.serving import ServingEngine

    eng = ServingEngine(config, params, slots=8, chunk=8, cache_len=1024,
                        kv_block_size=16, record_logits=record,
                        device="cuda", **kw)
    eng._grids()                        # the pools, outside the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in SPEC_SERVE_KERNELS}
    for rid, p in zip(rids, prompts):
        toks = out[rid]
        if (len(toks) != len(p) + max_new or toks[:len(p)] != p
                or not all(0 <= t < config.vocab_size for t in toks)):
            raise AssertionError(f"{label}: request {rid} malformed")
    generated = len(rids) * max_new
    st = eng.stats
    stats = dict(
        wall_s=wall, tokens_per_s=generated / wall,
        decode_s=st["decode_s"], decode_forwards=st["decode_steps"],
        prefill_s=st["prefill_s"], overlap_ratio=eng.overlap_ratio(),
        prefill_stall_s=eng.prefill_stall_s(),
        prefill_stats=dict(eng.prefill_stats),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        kv_stats=dict(eng.kv_stats), launches=counts)
    sp = eng.spec_stats
    if eng.draft_config is None:
        # A plain step emits one token a lane.
        stats["decode_ms_per_step"] = st["decode_s"] / st["decode_steps"] * 1e3
    else:
        per_round = sp["emitted"] / sp["slot_rounds"]
        stats.update(
            spec_stats=dict(sp), spec_telemetry=eng.spec_telemetry(),
            acceptance=sp["drafted_accepted"] / max(sp["drafted"], 1),
            emitted_per_slot_round=per_round,
            decode_ms_per_round=st["decode_s"] / sp["rounds"] * 1e3,
            # A round's time over the tokens it gives a lane: the
            # counterpart of a plain step's time.
            decode_ms_per_emitted_token=(st["decode_s"] / sp["rounds"]
                                         / per_round * 1e3))
    log(f"  {label}: {json.dumps(stats, default=str)}")
    return eng, out, rids, counts, stats


def phase_spec_serve() -> tuple:
    """Phase 19: speculative and pipelined serving of Llama-2-7B at full
    width and depth.  (a) ``_spec_kernel_cases``; (b) a self draft at
    depth 4, greedy, synchronous with atomic admission: the consistency
    check, acceptance >= 0.9 and K4's launches exactly (target layers +
    draft layers x (k+1)) x rounds; (c) llama_125m_lm as the draft,
    random weights, depths (0, 2, 4): the controller backs off to 0 and
    probes; (d) overlap and interleave (budget 256) off and on, plain and
    with the self draft: greedy tokens bit for bit equal, overlap_ratio >
    0.  Returns (the counts of (b), the spec_serve rows, the stats)."""
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
    )

    log(f"  card: {smi_line()}")
    rows, alloc_us = _spec_kernel_cases()
    torch.cuda.empty_cache()
    cfg = LLAMA_PRESETS["llama2_7b"]
    t0 = time.perf_counter()
    params = convert.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    log(f"  llama2_7b weights (phase 3's seed) in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = _spec_prompts(cfg.vocab_size)
    max_new, layers = 32, cfg.num_layers
    self_draft = dict(draft_config=cfg, draft_params=params,
                      speculative_k=SPEC_K)
    sync = dict(overlap=False, prefill_budget=0)
    piped = dict(overlap=True, prefill_budget=SPEC_BUDGET)
    out = {}

    log(f"  (b) self draft, k {SPEC_K}, greedy, synchronous")
    eng, spec_out, rids, spec_counts, spec = _spec_run(
        "self draft", cfg, params, prompts, max_new, record=True,
        **self_draft, **sync)
    rounds = spec["spec_stats"]["rounds"]
    want = layers * rounds + layers * (SPEC_K + 1) * rounds
    if min(spec_counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: "
                             f"{spec_counts}")
    if spec_counts["paged_attention"] != want:
        raise AssertionError(f"paged_attention launches "
                             f"{spec_counts['paged_attention']} != (32 + 32 "
                             f"x {SPEC_K + 1}) x {rounds} rounds = {want}")
    if spec["acceptance"] < 0.9:
        raise AssertionError(f"self-draft acceptance {spec['acceptance']}")
    c = _consistency(eng, spec_out, [(rids[i], prompts[i])
                                     for i in (1, 5)], max_new, 0.25)
    spec.update(tokens_agree=c["agree"], tokens_checked=c["total"],
                ring_workspace_host_us_a_round=(
                    layers * alloc_us["verify"]
                    + layers * (SPEC_K + 1) * alloc_us["step"]))
    out["self_draft"] = spec
    spec_tokens = [spec_out[r] for r in rids]
    del eng, spec_out
    torch.cuda.empty_cache()

    log(f"  (c) {SPEC_DRAFT} as the draft, random weights, depths (0, 2, "
        f"{SPEC_K})")
    dcfg = registry.get_config(SPEC_DRAFT)
    dparams = convert.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(SEED + 1),
        device="cuda")
    eng, small_out, rids, counts, small = _spec_run(
        f"{SPEC_DRAFT} draft", cfg, params, prompts, max_new, record=True,
        draft_config=dcfg, draft_params=dparams, speculative_k=SPEC_K,
        spec_depths=(0, 2, SPEC_K), **sync)
    per_depth = small["spec_telemetry"]["per_depth"]
    steps = sum(v["rounds"] * (d + 1) for d, v in per_depth.items())
    want = layers * small["spec_stats"]["rounds"] + dcfg.num_layers * steps
    if counts["paged_attention"] != want:
        raise AssertionError(f"paged_attention launches "
                             f"{counts['paged_attention']} != {want}")
    if not (per_depth[0]["rounds"] and per_depth[2]["rounds"]
            and small["spec_telemetry"]["switches"] >= 3):
        raise AssertionError(f"the controller did not back off to depth 0 "
                             f"and probe: {small['spec_telemetry']}")
    c = _consistency(eng, small_out, [(rids[i], prompts[i])
                                      for i in (1, 5)], max_new, 0.25)
    small.update(tokens_agree=c["agree"], tokens_checked=c["total"])
    out["draft_125m"] = small
    del eng, small_out, dparams
    torch.cuda.empty_cache()

    log(f"  (d) overlap and interleave (budget {SPEC_BUDGET}) off and on")
    toks = {"spec_off": spec_tokens}
    # The plain pair in turns (off, on, on, off): the host-bound decode
    # drifts between runs of one process.
    for name, kw in (("plain_off", sync), ("plain_on", piped),
                     ("plain_on", piped), ("plain_off", sync),
                     ("spec_on", dict(self_draft, **piped))):
        eng, o, rids, _, stats = _spec_run(name, cfg, params, prompts,
                                           max_new, **kw)
        got = [o[r] for r in rids]
        if toks.setdefault(name, got) != got:
            raise AssertionError(f"{name}: a rerun gave other tokens")
        out.setdefault(name, []).append(stats)
        if name.endswith("_on") and not stats["overlap_ratio"] > 0:
            raise AssertionError(f"{name}: overlap_ratio "
                                 f"{stats['overlap_ratio']}")
        del eng
        torch.cuda.empty_cache()
    for on, off in (("plain_on", "plain_off"), ("spec_on", "spec_off")):
        if toks[on] != toks[off]:
            raise AssertionError(f"{on} tokens differ from {off}")
    for name in ("plain_off", "plain_on"):
        runs = out[name]
        log(f"  {name}, mean of {len(runs)} runs: "
            f"{statistics.mean(r['tokens_per_s'] for r in runs):.1f} "
            f"tokens/s, "
            f"{statistics.mean(r['decode_ms_per_step'] for r in runs):.1f} "
            f"ms a decode step")
    same = sum(a == b for s, p, pr in zip(toks["spec_off"],
                                          toks["plain_off"], prompts)
               for a, b in zip(s[len(pr):], p[len(pr):]))
    out["spec_tokens_equal_plain"] = same / (len(prompts) * max_new)
    log(f"  greedy on/off pairs bitwise equal; the self draft's generated "
        f"tokens equal the plain engine's at "
        f"{out['spec_tokens_equal_plain']:.4f} of positions")
    del params
    torch.cuda.empty_cache()
    return spec_counts, rows, out


# -- phase 20 -----------------------------------------------------------------


def _lane_engine(config, params, **kw):
    """Phase 3's engine shape (8 slots, chunk 8, cache_len 1024, block 16)
    on the card."""
    from tensorflow_train_distributed_torch.serving import ServingEngine

    return ServingEngine(config, params, slots=8, chunk=8, cache_len=1024,
                         kv_block_size=16, device="cuda", **kw)


def _lane_rows(eng, tokens, n):
    """The first ``n`` pool rows of ``tokens``' radix-held blocks read back
    by K5, in the wire recipe: the bytes an install must have written."""
    import torch

    _, shared = eng._radix.match(tokens, allow_full=True, record=False)
    table = torch.zeros(eng._kv_nblk_lane, dtype=torch.int32)
    table[:len(shared)] = torch.tensor(shared, dtype=torch.int32)
    return eng._serialize_rows(table.cuda(), n)[1]


def _cancel_leg(label, config, params, prompts, max_new, **kw) -> tuple:
    """Phase 20(a) on one engine: 12 requests; after the first step (8
    lanes decoding, 4 queued) cancel #11 (queued) and #1 (decoding: under
    the overlap its chunk is in flight); the next step stages #8 in the
    freed lane (pieces of 64 tokens, one a step behind the decoding
    lanes); cancel it there.  The rest must finish whole, and only
    radix-held blocks stay in use.  Returns (tokens by index, stats)."""
    import torch

    eng = _lane_engine(config, params, prefill_chunk=64, **kw)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.serve_step()
    if eng.queue_depth() != 4 or len(eng.progress()) != 8:
        raise AssertionError(f"{label}: after one step {eng.queue_depth()} "
                             f"queued, {len(eng.progress())} decoding")
    inflight = eng._inflight is not None
    ok = [eng.cancel(rids[11]), eng.cancel(rids[1])]
    out.update(eng.serve_step())
    staged = rids[8] in eng.staged_rids()
    ok.append(eng.cancel(rids[8]))
    ok.append(eng.cancel(rids[8]))
    while eng.pending():
        out.update(eng.serve_step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ok != [True, True, True, False] or not staged:
        raise AssertionError(f"{label}: cancels returned {ok}, #8 staged "
                             f"{staged}")
    gone = {rids[i] for i in (1, 8, 11)}
    if gone & set(out) or len(out) != 9:
        raise AssertionError(f"{label}: outputs {sorted(out)}")
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        if rid in gone:
            continue
        toks = out[rid]
        if len(toks) != len(p) + max_new or toks[:len(p)] != p:
            raise AssertionError(f"{label}: request {i} malformed")
    held = eng._radix.cached_blocks()
    if eng.kv_blocks_in_use() != held:
        raise AssertionError(f"{label}: {eng.kv_blocks_in_use()} blocks in "
                             f"use, {held} radix-held")
    stats = dict(wall_s=wall, chunk_in_flight_at_cancel=inflight,
                 kv_blocks_in_use=held, kv_stats=dict(eng.kv_stats),
                 overlap_ratio=eng.overlap_ratio())
    log(f"  (a) {label}: cancels {ok}; {json.dumps(stats)}")
    return {i: out[r] for i, r in enumerate(rids) if r in out}, stats


def _ttft(eng, prompts, max_new) -> tuple:
    """(seconds from submitting ``prompts`` to the end of the step that
    gave every one its first token — atomic admission prefills them all
    in the first step, which also decodes one chunk; the prefill's own
    seconds)."""
    import torch

    torch.cuda.synchronize()
    prefill_s = eng.stats["prefill_s"]
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    done = set()
    while True:
        done |= set(eng.serve_step())
        prog = eng.progress()
        if all(r in done or prog.get(r, 0) > len(p)
               for r, p in zip(rids, prompts)):
            break
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    eng.run()
    return ttft, eng.stats["prefill_s"] - prefill_s


def phase_lane_control() -> tuple:
    """Phase 20: lane control of the paged engine, Llama-2-7B at full
    width and depth (bf16, random weights from seed 0).  (a)
    ``_cancel_leg`` on the synchronous engine with staged prefill and on
    the pipelined one: the survivors' tokens equal; (b) ``preload_prefix``
    of a 512-token system prompt, then 8 requests extending it: radix hit
    tokens, K5 launches and time to first token beside an engine without
    the preload; (c) ``export_lane`` of a decoding lane twice (bitwise
    equal), ``install_lane`` into a second engine, the installed rows
    read back by K5 bitwise equal to the blob, bf16 and int8 pools; the
    resumed greedy tokens' agreement with the uninterrupted run (a
    reading: the suffix is re-prefilled, not decoded), and the same leg
    on an f32 pool as its witness.  K1f, K4 and K5 are counted on the
    path's own legs only (``leg``): warm-ups, the engine without the
    preload, the second export, the uninterrupted run and the read-back
    of installed rows are checks.  Returns (counts, stats)."""
    import numpy as np
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import generate as G
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
    )
    from tensorflow_train_distributed_torch.ops import kernels as K

    log(f"  card: {smi_line()}")
    cfg = LLAMA_PRESETS["llama2_7b"]
    params = convert.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    rng = np.random.default_rng(SEED + 20)
    prompts = _requests(rng, 12, 16, 300, cfg.vocab_size, 64)
    prompts[8] = rng.integers(1, cfg.vocab_size, 280).tolist()
    max_new = 32
    out = {}
    counts = dict.fromkeys(LANE_KERNELS, 0)

    def leg(fn, *a, **kw):
        """``fn`` as a leg of the path: the counts set to 0 just before
        it, read just after, and added to the phase's; returns (its
        result, its launches)."""
        K.reset_launch_counts()
        res = fn(*a, **kw)
        got = {k: K.launch_counts()[k] for k in LANE_KERNELS}
        for k in counts:
            counts[k] += got[k]
        return res, got

    t_leg = time.perf_counter()
    (sync_toks, out["cancel_sync"]), _ = leg(
        _cancel_leg, "synchronous, staged", cfg, params, prompts, max_new,
        overlap=False)
    torch.cuda.empty_cache()
    (piped_toks, out["cancel_pipelined"]), _ = leg(
        _cancel_leg, "pipelined", cfg, params, prompts, max_new)
    if piped_toks != sync_toks:
        raise AssertionError("(a) the pipelined engine's tokens differ from "
                             "the synchronous one's")
    if not out["cancel_pipelined"]["chunk_in_flight_at_cancel"]:
        raise AssertionError("(a) no chunk was in flight at the cancel")
    torch.cuda.empty_cache()
    out["leg_s"] = {"a": time.perf_counter() - t_leg}
    t_leg = time.perf_counter()

    system = rng.integers(1, cfg.vocab_size, 512).tolist()
    asks = [system + rng.integers(1, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(16, 100, 8)]
    sync = dict(overlap=False, prefill_budget=0)
    eng = _lane_engine(cfg, params, **sync)
    eng.submit([1] * 16, 2)                    # warm-up
    eng.run()
    plain_ttft, plain_prefill = _ttft(eng, asks, 8)
    plain_hits = dict(eng.kv_stats)
    del eng
    torch.cuda.empty_cache()
    eng = _lane_engine(cfg, params, **sync)
    eng.submit([1] * 16, 2)
    eng.run()

    def preload():
        t0 = time.perf_counter()
        eng.preload_prefix(system)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    preload_s, _ = leg(preload)
    (pre_ttft, pre_prefill), got = leg(_ttft, eng, asks, 8)
    k5 = got["paged_kv_gather"]
    hits = dict(eng.kv_stats)
    if hits["prefix_hit_tokens"] != 8 * 512 or k5 <= 0:
        raise AssertionError(f"(b) radix hits {hits}, K5 launches {k5}")
    out["preload"] = dict(prefix_tokens=512, requests=8,
                          preload_s=preload_s, ttft_s=pre_ttft,
                          prefill_s=pre_prefill,
                          ttft_s_without_preload=plain_ttft,
                          prefill_s_without_preload=plain_prefill,
                          kv_stats=hits, kv_stats_without=plain_hits,
                          k5_launches=k5)
    log(f"  (b) preload: {json.dumps(out['preload'])}")
    del eng
    torch.cuda.empty_cache()
    out["leg_s"]["b"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()

    prompt = prompts[3]
    out["migrate"] = {}
    for pool in ("bf16", "int8", "f32"):
        if pool == "f32":
            # The witness: the same leg on an f32 pool, where rounding
            # leaves no near-tie for a re-prefill to tip.  Both engines
            # share these weights (cast once, taken by assignment).
            params = {k: v.float() for k, v in params.items()}
        c = dataclasses.replace(
            cfg, kv_cache_int8=pool == "int8",
            dtype=torch.float32 if pool == "f32" else cfg.dtype)
        src, dst = _lane_engine(c, params, **sync), _lane_engine(c, params,
                                                                 **sync)
        rid = leg(src.submit, prompt, 64)[0]
        for _ in range(4):
            leg(src.serve_step)

        def export():
            t0 = time.perf_counter()
            return src.export_lane(rid), time.perf_counter() - t0

        ((meta, blob), export_s), got = leg(export)
        if got["paged_kv_gather"] <= 0:
            raise AssertionError(f"(c) the export ran no K5: {got}")
        if src.export_lane(rid) != (meta, blob):
            raise AssertionError("(c) two exports of one lane differ")
        full = src.run()[rid]           # the lane, uninterrupted

        def install():
            t0 = time.perf_counter()
            warm = dst.install_lane(meta, blob)
            torch.cuda.synchronize()
            return warm, time.perf_counter() - t0

        (warm, install_s), _ = leg(install)
        n = meta["kv"]["n"]
        if warm != n or _lane_rows(dst, meta["kv"]["tokens"], n) != blob:
            raise AssertionError(f"(c) installed rows differ from the blob "
                                 f"({pool} pool, warm {warm} of {n})")
        done = len(meta["tokens"]) - len(prompt)

        def resume():
            r = dst.submit(meta["tokens"], meta["remaining"],
                           resume_from=done)
            return dst.run()[r]

        got, resumed = leg(resume)
        if resumed["paged_kv_gather"] <= 0:
            raise AssertionError(f"(c) the resumed request's radix hit ran "
                                 f"no K5: {resumed}")
        cut = len(meta["tokens"])
        if got[:cut] != full[:cut] or len(got) != len(full):
            raise AssertionError("(c) the resumed request is malformed")
        agree = sum(a == b for a, b in zip(got[cut:], full[cut:])) / (
            len(full) - cut)
        rec = dict(rows=n, blob_bytes=len(blob), export_s=export_s,
                   install_s=install_s, resumed_at=done,
                   resumed_tokens_agree=agree,
                   radix_hit_tokens=dst.kv_stats["prefix_hit_tokens"],
                   k5_resumed=resumed["paged_kv_gather"])
        first = next((i for i in range(cut, len(full))
                      if got[i] != full[i]), None)
        if first is not None:
            # At the first token where the runs part: the two picks'
            # logits under a teacher-forced forward of the uninterrupted
            # tokens, over max(std, 1) — a near-tie reads close to 0.
            model = G._decode_model(c, params, device="cuda")
            logits = _forced(model, torch.tensor([full[:first]],
                                                 device="cuda"))[-1]
            top2 = logits.topk(2).values
            scale = logits.std().clamp(min=1.0)
            rec.update(first_divergence=first - cut, divergence_gap=(
                (logits[full[first]] - logits[got[first]]) / scale).item(),
                top2_margin=((top2[0] - top2[1]) / scale).item())
            del model, logits
        if pool == "f32" and agree != 1.0:
            raise AssertionError(f"(c) the resumed f32 lane parts from the "
                                 f"uninterrupted one: {rec}")
        out["migrate"][pool] = rec
        log(f"  (c) {pool} pool: installed rows bitwise equal to the blob; "
            f"{json.dumps(rec)}")
        del src, dst
        torch.cuda.empty_cache()
    out["leg_s"]["c"] = time.perf_counter() - t_leg
    log(f"  launches {counts}; legs {json.dumps(out['leg_s'])}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {counts}")
    del params
    torch.cuda.empty_cache()
    return counts, out


# -- phase 21 -----------------------------------------------------------------

SAMPLE_DIR = "_sample_smoke"      # phase 11's run (a); deleted by phase 24


def _forced(model, tokens):
    """Logits [S, V] f32 of a causal forward of ``tokens`` (the training
    path), padded at the end to a multiple of 128 for the kernels."""
    import torch

    s = tokens.shape[1]
    n = -(-s // 128) * 128
    pad = torch.zeros(1, n - s, dtype=tokens.dtype, device=tokens.device)
    with torch.no_grad():
        out = model(torch.cat([tokens, pad], 1))
    if isinstance(out, tuple):      # an MoE model's (logits, aux, stats)
        out = out[0]
    return out[0, :s].float()


RING_FAULTS = ("slot", "stale", "sinks", "band")


@contextlib.contextmanager
def _ring_fault(kind):
    """A fault planted in the rolling-window decode, for phase 21's
    controls (None plants nothing): "slot" writes each token one slot on
    (the ring step taken at position + 1), "stale" keeps the decode's own
    rows out of the ring, "sinks" drops the sink columns from the step,
    "band" drops the window and sinks from the fresh prefill's
    attention."""
    from tensorflow_train_distributed_torch.models import layers as L

    cls = L.MultiHeadAttention
    step, kernel = cls._rolling_step, L.multihead_attention_kernel

    def faulty(self, q, k, v, lc, cur):
        if kind == "slot":
            return step(self, q, k, v, lc, cur + 1)
        if kind == "stale":
            j = cur % lc["key_cache"].shape[1]
            return step(self, q, lc["key_cache"][:, j, None].clone(),
                        lc["value_cache"][:, j, None].clone(), lc, cur)
        sinks, self.sinks = self.sinks, 0
        try:
            return step(self, q, k, v, lc, cur)
        finally:
            self.sinks = sinks

    if kind in ("slot", "stale", "sinks"):
        cls._rolling_step = faulty
    elif kind == "band":
        L.multihead_attention_kernel = (
            lambda *a, window=None, sinks=0, **kw: kernel(*a, **kw))
    try:
        yield
    finally:
        cls._rolling_step, L.multihead_attention_kernel = step, kernel


# Decode logits against teacher forcing: worst max |diff| / max(std, 1)
# a position, and the least argmax agreement.  Both sit between what the
# sound decodes read and what the faults of phase 21's controls read at
# window 64 (PERF.md).
DECODE_TOL, DECODE_AGREE = 0.25, 0.9


def _decode_vs_forced(label, model, prompt, max_new, fault=None) -> dict:
    """``generate()``'s loop with its decode logits kept, against the
    teacher-forced forward of prompt + generated tokens at the same
    positions: worst and median max |diff| / max(std, 1) a position, and
    the argmax agreement, held to ``DECODE_TOL`` and ``DECODE_AGREE``
    unless a ``fault`` is planted in the decode (a control: ``within``
    says whether it passed the bars)."""
    import torch
    from tensorflow_train_distributed_torch.models import generate as G
    from tensorflow_train_distributed_torch.ops import kernels as K

    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with _ring_fault(fault):
        out = G._generate(model, prompt, max_new,
                          G._picker(0.0, None, None, None, 1, "cuda"),
                          logits_out=logs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    s = prompt.shape[1]
    forced = _forced(model, out[:, :-1])[s - 1:]
    dec = torch.cat(logs)
    ratio = ((forced - dec).abs().amax(-1)
             / forced.std(-1).clamp(min=1.0))
    agree = (forced.argmax(-1) == out[0, s:]).float().mean().item()
    rec = dict(prompt=s, new_tokens=max_new, wall_s=wall,
               worst_diff_over_std=ratio.max().item(),
               median_diff_over_std=ratio.median().item(),
               argmax_agree=agree, peak_mem_gib=peak / 2 ** 30,
               launches={k: v for k, v in counts.items() if v})
    rec["within"] = (rec["worst_diff_over_std"] <= DECODE_TOL
                     and agree >= DECODE_AGREE)
    log(f"  {label}: {json.dumps(rec)}")
    if fault is None and not rec["within"]:
        raise AssertionError(f"{label}: decode against teacher forcing "
                             f"worst {rec['worst_diff_over_std']:.4f} > "
                             f"{DECODE_TOL} or argmax agreement {agree:.3f} "
                             f"< {DECODE_AGREE}")
    return rec, counts, out


def phase_generate() -> tuple:
    """Phase 21: ``generate()`` at full width.  (a) mistral_7b at full
    width and depth (32 layers, window 4096): a 6,000-token prompt (the
    fresh prefill padded to 6,016 for K7) and 256 greedy tokens, so the
    4,096-row ring wraps; its decode logits against a teacher-forced
    forward (K7), K7 launched exactly 32 times and K1f 65 a forward;
    (b) the same width at 4 layers with 4 attention sinks, and the bars'
    controls: faults planted in the ring (``_ring_fault``), each of which
    must fail them at a window of 64; (c) Llama-2-7B
    ``generate()``: a 1,000-token prompt (K2 on 1,024) and 64 tokens,
    against teacher forcing; (d) ``generate_speculative`` of Llama-2-7B
    at 4 layers with itself as the draft, k 4, beside ``generate()`` at
    that depth; (e) ``python -m tensorflow_train_distributed_torch.sample``
    on phase 11's launcher checkpoint, whose tokens must be an in-process
    ``generate()``'s.  Returns (counts over (a)-(d), kernel rows,
    stats)."""
    import os
    import shutil

    import numpy as np
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import generate as G
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
    )
    from tensorflow_train_distributed_torch.models.speculative import (
        generate_speculative,
    )
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    log(f"  card: {smi_line()}")
    out = {"leg_s": {}}
    t_leg = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    rows = {"rms_norm": _rms_serve_case(gen, 6000, torch.ones(
        4096, dtype=torch.bfloat16, device="cuda"))}
    _rms_serve_case(gen, 1, torch.ones(4096, dtype=torch.bfloat16,
                                       device="cuda"))
    rows["flash_attention"] = _flash_case(
        gen, "llama2_7b prefill", 1, 32, 32, 1024, 128, packed=False,
        main=True)["flash_attention"]
    main = _splash_case(gen, "mistral_7b prefill", 1, 32, 8, 6016, 128, 4096,
                        0, packed=False, dtype=torch.bfloat16, timed=True,
                        flex=False)     # phase 9 times flex at 8192
    rows["splash_attention"] = {f: main[f] for f in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    torch.cuda.empty_cache()
    totals = dict.fromkeys(GENERATE_KERNELS, 0)

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    out["leg_s"]["kernels"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    cfg = LLAMA_PRESETS["mistral_7b"]
    params = convert.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    model = G._decode_model(cfg, params, device="cuda")
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size, (1, 6000)),
                          device="cuda")
    rec, counts, _ = _decode_vs_forced("(a) mistral_7b, 32 layers", model,
                                       prompt, 256)
    add(counts)
    want = dict(splash_attention=cfg.num_layers, flash_attention=0,
                rms_norm=(2 * cfg.num_layers + 1) * 256)
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"(a) launches {got}, expected {want}")
    kv = cfg.kv_heads * cfg.attn_head_dim * 2 * 2 * cfg.num_layers
    rec.update(ring_rows=cfg.sliding_window,
               ring_gib=cfg.sliding_window * kv / 2 ** 30,
               linear_cache_gib=(6000 + 256) * kv / 2 ** 30)
    # The prefill alone on a fresh cache; the decode's time a token is
    # the rest of the run's 255 single-token forwards.
    with torch.no_grad():
        cache = model.init_cache(1, 6256, shared=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(prompt, cache)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
    rec["ms_per_token"] = (rec["wall_s"] - rec["prefill_s"]) / 255 * 1e3
    rec["tokens_per_s"] = 1e3 / rec["ms_per_token"]
    out["mistral_7b"] = rec
    log(f"  (a) prefill {rec['prefill_s']:.2f} s, {rec['ms_per_token']:.2f} "
        f"ms a token, ring {rec['ring_gib']:.3f} GiB (linear would be "
        f"{rec['linear_cache_gib']:.3f})")
    del model, cache
    torch.cuda.empty_cache()
    out["leg_s"]["a"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()

    cfg4 = dataclasses.replace(cfg, num_layers=4, attention_sinks=4)
    p4 = {k: v for k, v in params.items()
          if not k.startswith("layers.") or int(k.split(".")[1]) < 4}
    model = G._decode_model(cfg4, p4, device="cuda")
    rec, counts, _ = _decode_vs_forced("(b) mistral_7b, 4 layers, 4 sinks",
                                       model, prompt, 256)
    add(counts)
    if counts["splash_attention"] != 4:
        raise AssertionError(f"(b) splash launches "
                             f"{counts['splash_attention']} != 4")
    out["mistral_7b_4_layers_sinks_4"] = rec
    out["leg_s"]["b"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()

    # The bars against faults planted in the ring, 64 tokens each.  At a
    # window of 64 (300-token prompt) each key weighs enough that every
    # fault must fail them; at (b)'s window of 4,096 random weights
    # attend close to an average, and the faults are readings.
    out["ring_faults"] = {}
    for name, c, p in (("window 4096", cfg4, prompt),
                       ("window 64", dataclasses.replace(
                           cfg4, sliding_window=64), prompt[:, :300])):
        m = G._decode_model(c, p4, device="cuda")
        res = {}
        for fault in (None, *RING_FAULTS):
            r = _decode_vs_forced(f"(b) control, {name}, fault {fault}", m,
                                  p, 64, fault=fault)[0]
            res[fault or "sound"] = {k: r[k] for k in (
                "worst_diff_over_std", "median_diff_over_std",
                "argmax_agree", "within")}
        out["ring_faults"][name] = res
        del m
    passed = [f for f in RING_FAULTS
              if out["ring_faults"]["window 64"][f]["within"]]
    if passed:
        raise AssertionError(f"(b) ring faults {passed} at window 64 pass "
                             f"the decode bars")
    out["leg_s"]["ring_faults"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    del model, params, p4
    torch.cuda.empty_cache()

    cfg = LLAMA_PRESETS["llama2_7b"]
    params = convert.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size, (1, 1000)),
                          device="cuda")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = G.generate(cfg, params, prompt, 64, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    add(counts)
    if (counts["flash_attention"] != cfg.num_layers
            or counts["rms_norm"] != (2 * cfg.num_layers + 1) * 64):
        raise AssertionError(f"(c) launches {counts}")
    model = G._decode_model(cfg, params, device="cuda")
    forced = _forced(model, toks[:, :-1])[999:]
    agree = (forced.argmax(-1) == toks[0, 1000:]).float().mean().item()
    out["llama2_7b"] = dict(prompt=1000, new_tokens=64, wall_s=wall,
                            argmax_agree=agree, launches={
                                k: v for k, v in counts.items() if v})
    log(f"  (c) llama2_7b generate(): {json.dumps(out['llama2_7b'])}")
    if agree < DECODE_AGREE:
        raise AssertionError(f"(c) teacher-forced argmax agrees on {agree}")
    del model
    torch.cuda.empty_cache()
    out["leg_s"]["c"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()

    cfg4 = dataclasses.replace(cfg, num_layers=4)
    p4 = {k: v for k, v in params.items()
          if not k.startswith("layers.") or int(k.split(".")[1]) < 4}
    del params
    short = prompt[:, :200]
    plain = G.generate(cfg4, p4, short, 64, device="cuda")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    spec, st = generate_speculative(cfg4, p4, cfg4, p4, short, 64, k=4,
                                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    add(K.launch_counts())
    same = (spec[0, 200:] == plain[0, 200:]).float().mean().item()
    out["speculative"] = dict(st, wall_s=wall, acceptance=(
        st["drafted_accepted"] / (4 * st["rounds"])),
        tokens_equal_generate=same)
    log(f"  (d) generate_speculative, llama2_7b at 4 layers, self draft: "
        f"{json.dumps(out['speculative'])}")
    if out["speculative"]["acceptance"] < 0.9:
        raise AssertionError("(d) self-draft acceptance below 0.9")
    del p4
    torch.cuda.empty_cache()
    out["leg_s"]["d"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()

    ck = os.path.abspath(os.path.join(SAMPLE_DIR, "a"))
    try:
        if not os.path.isdir(ck):
            # Run alone, without phase 11's checkpoint: a short run of its
            # flags writes one.
            rc, _, err, _, _ = _launcher(
                "a checkpoint for sample.py", "--config", "llama_125m_lm",
                "--steps", "2", "--seed", str(SEED), "--checkpoint-dir", ck)
            if rc != 0:
                raise AssertionError(f"(e) launcher failed:\n{err[-4000:]}")
        cfg = registry.get_config("llama_125m_lm")
        rows_in = [rng.integers(1, cfg.vocab_size, 24).tolist()
                   for _ in range(2)]
        t0 = time.perf_counter()
        got = _sample_leg(ck, rows_in, 16, [], config="llama_125m_lm")
        want = G.generate(cfg, CheckpointManager(ck).restore_params(),
                          rows_in, 16, device="cuda")[:, 24:].tolist()
        out["sample_cli"] = dict(wall_s=time.perf_counter() - t0,
                                 rows=len(got), equal=got == want)
        log(f"  (e) sample.py on phase 11's checkpoint: "
            f"{json.dumps(out['sample_cli'])}")
        if got != want:
            raise AssertionError(f"(e) sample.py {got} != generate() {want}")
    except BaseException:
        shutil.rmtree(os.path.abspath(SAMPLE_DIR), ignore_errors=True)
        raise
    out["leg_s"]["e"] = time.perf_counter() - t_leg
    log(f"  launches {totals}; legs {json.dumps(out['leg_s'])}")
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {totals}")
    return totals, rows, out


# -- phase 22 -----------------------------------------------------------------

MOE_DIR = "_moe_smoke"      # git-ignored; deleted at the phase's end
MOE_SERVE = "qwen15_moe_a27b"
MOE_INT8 = "mixtral_8x7b"


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _no_drop(cfg):
    """``cfg`` at a capacity that never binds (capacity = group length):
    a decode step's routing, one token a group, for a many-token call."""
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                               / cfg.top_k)


def _capacity_binds(cfg) -> bool:
    return (cfg.dispatch == "dense"
            and cfg.capacity_factor * cfg.top_k < cfg.num_experts)


def _warm_and_zero(eng) -> None:
    """One short request through ``eng`` (its first calls' allocations),
    then its step stats, radix counters and recorded logits, the card's
    peak memory and the launch counts set to 0."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    eng.submit([1] * 16, 2)
    eng.run()
    eng.stats.update(decode_steps=0, decode_s=0.0, prefill_s=0.0,
                     prefill_tokens=0)
    eng.kv_stats.update(dict.fromkeys(eng.kv_stats, 0))
    eng.decode_logits.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()


FAULT_NEW = 16      # tokens the planted fault's control decodes


@contextlib.contextmanager
def _gqa_fault():
    """A fault planted around K4's wrapper, for phase 22's control: the
    query heads grouped strided (head h reads kv head h mod kv_heads
    where the kernel reads h // group: ``repeat`` where
    ``repeat_interleave`` was meant)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    real = K.paged_attention

    def faulty(q, kp, vp, table, lengths, **kw):
        heads, kvh = q.shape[2], kp.shape[2]
        j = torch.arange(heads, device=q.device)
        perm = j // (heads // kvh) + kvh * (j % (heads // kvh))
        return real(q[:, :, perm].contiguous(), kp, vp, table, lengths,
                    **kw)[:, :, perm.argsort()]

    K.paged_attention = faulty
    try:
        yield
    finally:
        K.paged_attention = real


def _moe_engine_leg(label, cfg, params, prompts, max_new, *, scales=None,
                    check, noise=False, fault=False, ttft=True) -> tuple:
    """Phase 3's synchronous engine (8 slots, chunk 8, cache_len 1024,
    block 16) on ``prompts``: counts zeroed just before and read just
    after, the outputs' shape, paged attention exactly layers x decode
    steps, the consistency check on the requests ``check`` (a capacity
    that binds re-prefills the prompt as the engine did and
    teacher-forces the rest at decode's routing; ``noise``: its bar set
    by the model's own noise floor), the time to first token of 8 fresh
    prompts.  ``fault``: the checked requests are decoded again with a
    fault planted in K4's head grouping (``_gqa_fault``), which must fail
    the same bars.  Returns (counts, stats, tokens by prompt)."""
    import numpy as np
    import torch
    from tensorflow_train_distributed_torch.models import generate as G
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.serving import ServingEngine

    eng = ServingEngine(cfg, params, quant_scales=scales, slots=8, chunk=8,
                        cache_len=1024, kv_block_size=16, record_logits=True,
                        overlap=False, prefill_budget=0, device="cuda")
    _warm_and_zero(eng)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in K.launch_counts().items() if v}
    stats = _engine_stats(label, eng, cfg, rids, prompts, out, max_new,
                          wall, counts)
    tail = (G._decode_model(_no_drop(cfg), params, quant_scales=scales,
                            device="cuda") if _capacity_binds(cfg) else None)
    checked = [prompts[i] for i in check]
    c = _consistency(eng, out, [(rids[i], prompts[i]) for i in check],
                     max_new, 0.25, tail_model=tail, noise=noise)
    stats.update(tokens_agree=c["agree"], tokens_checked=c["total"])
    if noise:
        stats["teacher_forcing"] = {k: c[k] for k in ("worst", "floor",
                                                      "bar", "requests")}
    if fault:
        with _gqa_fault():
            frids = [eng.submit(p, FAULT_NEW) for p in checked]
            fout = eng.run()
        f = _consistency(eng, fout, list(zip(frids, checked)), FAULT_NEW,
                         0.25, tail_model=tail, floor=c["floor"], hold=False)
        stats["gqa_fault"] = {k: f[k] for k in ("worst", "bar", "agree",
                                                "total", "within")}
        log(f"  {label}, K4's head grouping faulted: "
            f"{json.dumps(stats['gqa_fault'])}")
        if f["within"]:
            raise AssertionError(f"{label}: the bars let a fault in K4's "
                                 f"head grouping through")
    del tail
    if ttft:
        fresh = _requests(np.random.default_rng(SEED + 22), 8, 16, 300,
                          cfg.vocab_size, 0)
        stats["ttft_s"], stats["ttft_prefill_s"] = _ttft(eng, fresh, 2)
        log(f"  {label}: time to first token of 8 fresh prompts "
            f"{stats['ttft_s']:.3f} s (prefill "
            f"{stats['ttft_prefill_s']:.3f})")
    return counts, stats, [out[r] for r in rids]


def _engine_stats(label, eng, cfg, rids, prompts, out, max_new, wall,
                  counts) -> dict:
    import torch

    steps = eng.stats["decode_steps"]
    for rid, p in zip(rids, prompts):
        toks = out[rid]
        if (len(toks) != len(p) + max_new or toks[:len(p)] != p
                or not all(0 <= t < cfg.vocab_size for t in toks)):
            raise AssertionError(f"{label}: request {rid} malformed")
    if counts.get("paged_attention") != cfg.num_layers * steps:
        raise AssertionError(f"{label}: paged_attention launches "
                             f"{counts.get('paged_attention')} != layers x "
                             f"decode steps {cfg.num_layers * steps}")
    generated = len(rids) * max_new
    stats = dict(requests=len(rids), generated_tokens=generated, wall_s=wall,
                 tokens_per_s=generated / wall,
                 decode_ms_per_step=eng.stats["decode_s"] / steps * 1e3,
                 decode_steps=steps,
                 prefill_tokens=eng.stats["prefill_tokens"],
                 prefill_s=eng.stats["prefill_s"],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 kv_stats=dict(eng.kv_stats),
                 launches=counts)
    log(f"  {label}: {json.dumps(stats)}")
    return stats


def _moe_kernel_cases(gen) -> dict:
    """The kernels at phase 22's shapes: K6 at a Qwen decode step (8
    slots x top-4 = 32 token copies padded to 128 rows over 60 groups,
    most of them empty, the pad in the last) and at ``generate()``'s
    1,000-token prefill (4,000 copies, 4,096 rows), K1f at Qwen's [8,
    2048] and [1000, 2048] and Mixtral's [8, 4096], K4 over Qwen's 8
    lanes x 16 heads x hd 128 and Mixtral's 8 lanes x 32 query heads over
    8 kv heads (4 a group) with the engine's lanes (16-332 rows), K5 on
    Qwen's pool at a 4-block radix hit, K2 at the prefill's B 1, H 16,
    S 1024, D 128.  Returns {path: {kernel: row}}."""
    import torch

    rows = {"moe_serve": {}, "mixtral_serve": {}, "moe_generate": {}}
    serve, gen_rows = rows["moe_serve"], rows["moe_generate"]
    mixtral = rows["mixtral_serve"]
    d = 2048
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    serve["rms_norm"] = _rms_serve_case(gen, 8, scale)
    gen_rows["rms_norm"] = _rms_serve_case(gen, 1000, scale)
    sizes = _routed_sizes(gen, 8, d, 60, 4)
    log(f"  qwen decode group sizes {sizes.tolist()} "
        f"({int((sizes > 0).sum())} of 60 groups hold rows)")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    cases = []
    for k, n in ((d, 1408), (1408, d)):
        cases.append(_gmm_case(gen, f"qwen decode {k}->{n}", "fwd", 128, k,
                               n, sizes, want_body="wgmma"))
    serve["gmm"] = {f: cases[0][f] for f in keys}
    sizes = _routed_sizes(gen, 1000, d, 60, 4)
    cases.append(_gmm_case(gen, "qwen generate() prefill", "fwd", 4096, d,
                           1408, sizes, want_body="wgmma"))
    gen_rows["gmm"] = {f: cases[-1][f] for f in keys}
    CASES.extend(dict(c, kernel="gmm") for c in cases)
    # K4 and K5 on Qwen's pool: 8 lanes of 64 blocks (16 kv heads x 128);
    # K4 on Mixtral's (8 kv heads).
    lanes, heads, hd, bs, n_blk = 8, 16, 128, 16, 64
    nb = 1 + lanes * n_blk
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    table = perm[:lanes * n_blk].view(lanes, n_blk).to(torch.int32)
    lengths = torch.randint(16, 333, (lanes,), generator=gen, device="cuda",
                            dtype=torch.int32)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q = randn(lanes, 1, heads, hd)
    kpool, vpool = randn(nb, bs, heads, hd), randn(nb, bs, heads, hd)
    case = _paged_case("qwen, the engine's lanes", q, kpool, vpool, None,
                       table, lengths, n_blk * bs)
    CASES.append(dict(case, kernel="paged_attention"))
    serve["paged_attention"] = {f: case[f] for f in keys}
    serve["paged_kv_gather"] = _gather_case(
        "qwen, a 4-block radix hit", kpool,
        [table[i:i + 1, :4].contiguous() for i in range(lanes)], 4 * bs,
        True)
    del kpool, vpool
    q = randn(lanes, 1, 32, hd)
    kpool, vpool = randn(nb, bs, 8, hd), randn(nb, bs, 8, hd)
    case = _paged_case("mixtral, the engine's lanes", q, kpool, vpool, None,
                       table, lengths, n_blk * bs)
    CASES.append(dict(case, kernel="paged_attention"))
    mixtral["paged_attention"] = {f: case[f] for f in keys}
    del kpool, vpool
    mixtral["rms_norm"] = _rms_serve_case(gen, 8, (1 + 0.1 * torch.randn(
        4096, generator=gen, device="cuda")).to(torch.bfloat16))
    gen_rows["flash_attention"] = _flash_case(
        gen, "qwen prefill", 1, heads, heads, 1024, hd, packed=False,
        main=True)["flash_attention"]
    torch.cuda.empty_cache()
    return rows


def _serve_main_leg(label, flags, prompts, max_new) -> tuple:
    """``serve.py``'s ``main`` in this process on ``prompts`` (a requests
    file under ``MOE_DIR``), its engine recording decode logits, warmed
    up and its counts zeroed as it is built.  Returns (the engine, counts,
    tokens by prompt, wall seconds)."""
    import os

    import torch
    from tensorflow_train_distributed_torch import serve, serving
    from tensorflow_train_distributed_torch.ops import kernels as K

    os.makedirs(MOE_DIR, exist_ok=True)
    req = os.path.join(MOE_DIR, f"{label}.requests.jsonl")
    res = os.path.join(MOE_DIR, f"{label}.out.jsonl")
    with open(req, "w") as f:
        f.writelines(json.dumps({"prompt": p}) + "\n" for p in prompts)
    engines = []
    plain = serving.ServingEngine

    class Recording(plain):
        def __init__(self, *a, **kw):
            super().__init__(*a, record_logits=True, **kw)
            engines.append(self)
            _warm_and_zero(self)
            self.t0 = time.perf_counter()

    serving.ServingEngine = Recording
    try:
        rc = serve.main([*flags, "--requests", req, "--max-new", str(max_new),
                         "--output", res])
    finally:
        serving.ServingEngine = plain
    torch.cuda.synchronize()
    eng = engines[0]
    wall = time.perf_counter() - eng.t0
    if rc != 0:
        raise AssertionError(f"{label}: serve.py exit {rc}")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    with open(res) as f:
        lines = [json.loads(x) for x in f]
    return eng, counts, {rec["id"]: rec["tokens"] for rec in lines}, wall


def _moe_generate_leg(label, cfg, params, prompt, max_new, scales=None):
    """``generate()`` of ``prompt`` and its decode logits against teacher
    forcing (``_decode_vs_forced``'s bars), the prefill timed alone on a
    fresh cache.  Returns (record, counts)."""
    import torch
    from tensorflow_train_distributed_torch.models import generate as G

    model = G._decode_model(cfg, params, quant_scales=scales, device="cuda")
    rec, counts, _ = _decode_vs_forced(label, model, prompt, max_new)
    with torch.no_grad():
        cache = model.init_cache(1, prompt.shape[1] + max_new, shared=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(prompt, cache)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
    rec["ms_per_token"] = ((rec["wall_s"] - rec["prefill_s"])
                           / (max_new - 1) * 1e3)
    rec["tokens_per_s"] = 1e3 / rec["ms_per_token"]
    want = {"flash_attention": cfg.num_layers,
            "rms_norm": (2 * cfg.num_layers + 1) * max_new,
            "gmm": 3 * cfg.num_layers * max_new if cfg.dispatch == "gmm"
            else 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    log(f"  {label}: prefill {rec['prefill_s']:.3f} s, "
        f"{rec['ms_per_token']:.2f} ms a token")
    del model, cache
    return rec, counts


def _sample_leg(ck, rows_in, max_new, flags,
                config="moe_tiny_lm_gmm") -> list:
    """``sample.py``'s ``main`` in this process (a process would spend ~9
    s importing torch); its completions."""
    import contextlib
    import io

    from tensorflow_train_distributed_torch import sample

    buf = io.StringIO()
    args = ["--config", config, "--checkpoint-dir", ck,
            "--max-new", str(max_new), *flags]
    for r in rows_in:
        args += ["--prompt", ",".join(map(str, r))]
    with contextlib.redirect_stdout(buf):
        rc = sample.main(args)
    if rc != 0:
        raise AssertionError(f"sample.py {config} {flags} exit {rc}")
    return [json.loads(x)["completion"] for x in buf.getvalue().splitlines()]


# Phase 22 (e)'s new tokens after its 1,000-token prompt (64 until the
# whole script's clock asked for 32).
MOE_GEN_NEW = 32


def phase_moe_serve() -> tuple:
    """Phase 22: MoE decode and serving, and int8 weight-only serving, at
    full width and depth (random weights from seed 0).  Kernel cases at
    the phase's shapes (``_moe_kernel_cases``); (a) qwen15_moe_a27b bf16
    through ``serve.py --dispatch gmm`` (phase 3's engine shape and
    requests, two sharing a 64-token prefix: a radix hit through K5);
    (b) the same model on the dense dispatch (exact-length prefill, no
    radix); (c) the same in int8 (``--quant int8``'s
    ``quantize_params``), its bytes beside bf16's, its greedy tokens
    beside (b)'s, and int8 with gmm raising; (d) mixtral_8x7b in int8,
    each tensor drawn in bf16 on the card and quantized at once (the bf16
    tree, 93 GB, is never held), 8 requests, its bar set by its own noise
    floor and a fault planted in K4 failing it (``_gqa_fault``), the
    same weights in f32 compute against phase 3's bars on the two checked
    requests; (e) ``generate()`` on
    Qwen, gmm bf16 and dense int8, a 1,000-token prompt and 32 tokens,
    against teacher forcing; (f) ``sample.py --dispatch gmm`` and
    ``--quant int8 --dispatch dense`` on a 2-step launcher checkpoint of
    moe_tiny_lm_gmm, tokens equal to ``generate()``'s.  Each engine leg
    checks its outputs, paged attention at layers x decode steps and the
    decode logits against teacher forcing (phase 3's ``_consistency``),
    and reports TPOT, tokens/s, peak memory, the decode step's byte bound
    and, but for (d), TTFT.  Returns (counts {path: {kernel: launches}},
    kernel rows, stats)."""
    import os
    import shutil

    import numpy as np
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import generate as G
    from tensorflow_train_distributed_torch.models import quant
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    log(f"  card: {smi_line()}")
    out = {"leg_s": {}}
    t_leg = time.perf_counter()
    rows = _moe_kernel_cases(torch.Generator(device="cuda").manual_seed(
        SEED + 22))
    serve_counts = dict.fromkeys(("rms_norm", "paged_attention",
                                  "paged_kv_gather", "gmm"), 0)
    mixtral_counts = dict.fromkeys(("rms_norm", "paged_attention"), 0)
    gen_counts = dict.fromkeys(("rms_norm", "flash_attention", "gmm"), 0)

    def add(totals, counts):
        for k in totals:
            totals[k] += counts.get(k, 0)

    out["leg_s"]["kernels"] = time.perf_counter() - t_leg
    t_leg = time.perf_counter()
    total_mem = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    cfg = registry.get_config(MOE_SERVE)
    prompts = _requests(np.random.default_rng(SEED), 12, 16, 300,
                        cfg.vocab_size, 64)
    max_new = 32
    try:
        eng, counts, toks, wall = _serve_main_leg(
            "a", ["--config", MOE_SERVE, "--dispatch", "gmm", "--slots", "8",
                  "--chunk", "8", "--cache-len", "1024", "--kv-block-size",
                  "16", "--no-overlap", "--no-interleave", "--seed",
                  str(SEED)], prompts, max_new)
        gcfg = eng.config
        rids = sorted(toks)
        stats = _engine_stats("(a) qwen15_moe_a27b bf16, serve.py --dispatch "
                              "gmm", eng, gcfg, rids, prompts, toks, max_new,
                              wall, counts)
        want = 3 * gcfg.num_layers * (stats["decode_steps"] + len(prompts))
        if counts.get("paged_kv_gather", 0) < 2 * gcfg.num_layers or (
                counts.get("gmm", 0) < want):
            raise AssertionError(f"(a) launches {counts}: K5 at the radix "
                                 f"hit, gmm at least {want}")
        if eng.kv_stats["prefix_hits"] < 1:
            raise AssertionError(f"(a) no radix prefix hit: {eng.kv_stats}")
        c = _consistency(eng, toks, [(rids[1], prompts[1]),
                                     (rids[5], prompts[5])], max_new, 0.25)
        stats.update(tokens_agree=c["agree"], tokens_checked=c["total"])
        fresh = _requests(np.random.default_rng(SEED + 22), 8, 16, 300,
                          cfg.vocab_size, 0)
        stats["ttft_s"], stats["ttft_prefill_s"] = _ttft(eng, fresh, 2)
        stats["decode_bound"] = decode_bytes_per_step(
            gcfg, {k: v for k, v in eng._model.state_dict().items()}, None,
            8, 150.0)
        log(f"  (a) TTFT {stats['ttft_s']:.3f} s; decode bound "
            f"{json.dumps(stats['decode_bound'])}")
        add(serve_counts, counts)
        out["a_gmm_bf16"] = stats
        del eng
        _free()
        out["leg_s"]["a"] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

        params = convert.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        gprompt = torch.tensor(np.random.default_rng(SEED + 23).integers(
            1, cfg.vocab_size, (1, 1000)), device="cuda")
        rec, counts = _moe_generate_leg(
            "(e) qwen generate(), gmm bf16",
            dataclasses.replace(cfg, dispatch="gmm"), params, gprompt,
            MOE_GEN_NEW)
        add(gen_counts, counts)
        out["e_generate_gmm_bf16"] = rec
        _free()
        out["leg_s"]["e_gmm"] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

        dcfg = dataclasses.replace(cfg, dispatch="dense")
        counts, stats, dense_toks = _moe_engine_leg(
            "(b) qwen15_moe_a27b bf16, dense dispatch", dcfg, params,
            prompts, max_new, check=[1, 5])
        if counts.get("paged_kv_gather") or counts.get("gmm"):
            raise AssertionError(f"(b) launches {counts}: no K5 or K6 on "
                                 f"the dense dispatch")
        stats["decode_bound"] = decode_bytes_per_step(dcfg, params, None, 8,
                                                      150.0)
        add(serve_counts, counts)
        out["b_dense_bf16"] = stats
        _free()
        out["leg_s"]["b"] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

        bf16_bytes = quant.quantized_bytes(params)
        qparams, scales = quant.quantize_params(params)
        del params
        _free()
        try:
            G.generate(dataclasses.replace(cfg, dispatch="gmm"), qparams,
                       gprompt[:, :16], 2, quant_scales=scales,
                       device="cuda")
            raise AssertionError("(c) int8 with the gmm dispatch ran")
        except NotImplementedError as e:
            log(f"  (c) int8 with gmm raises: {e}")
        counts, stats, int8_toks = _moe_engine_leg(
            "(c) qwen15_moe_a27b int8, dense dispatch", dcfg, qparams,
            prompts, max_new, scales=scales, check=[1, 5])
        gen_b = [t[len(p):] for t, p in zip(dense_toks, prompts)]
        gen_c = [t[len(p):] for t, p in zip(int8_toks, prompts)]
        same = sum(a == b for x, y in zip(gen_b, gen_c)
                   for a, b in zip(x, y))
        stats.update(
            int8_bytes=quant.quantized_bytes(qparams)
            + quant.quantized_bytes(scales), bf16_bytes=bf16_bytes,
            greedy_equal_to_bf16=same / sum(map(len, gen_b)),
            decode_bound=decode_bytes_per_step(dcfg, qparams, scales, 8,
                                               150.0))
        log(f"  (c) int8 {stats['int8_bytes'] / 1e9:.2f} GB against bf16 "
            f"{bf16_bytes / 1e9:.2f} GB; greedy tokens equal to (b)'s at "
            f"{stats['greedy_equal_to_bf16']:.3f} of positions")
        add(serve_counts, counts)
        out["c_dense_int8"] = stats
        out["leg_s"]["c"] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

        rec, counts = _moe_generate_leg(
            "(e) qwen generate(), dense int8", dcfg, qparams, gprompt,
            MOE_GEN_NEW, scales=scales)
        add(gen_counts, counts)
        out["e_generate_dense_int8"] = rec
        del qparams, scales
        _free()
        out["leg_s"]["e_int8"] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

        mcfg = dataclasses.replace(registry.get_config(MOE_INT8),
                                   dispatch="dense")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        qparams, scales = {}, {}
        for name, t in convert.iter_init_params(mcfg, gen, device="cuda"):
            if quant.eligible(name, t):
                qparams[name], scales[quant.scale_name(name)] = (
                    quant.quantize_tensor(t))
            else:
                qparams[name] = t
            del t
        torch.cuda.synchronize()
        init = dict(seconds=time.perf_counter() - t0,
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    int8_bytes=quant.quantized_bytes(qparams)
                    + quant.quantized_bytes(scales),
                    bf16_bytes=sum(2 * v.numel() for v in qparams.values()))
        log(f"  (d) mixtral_8x7b drawn and quantized tensor by tensor: "
            f"{json.dumps(init)}")
        mprompts = _requests(np.random.default_rng(SEED + 24), 8, 16, 300,
                             mcfg.vocab_size, 64)
        # In bf16, two correct teacher-forced computations of Mixtral's
        # continuation (one block, two blocks) part by 0.7-0.9 of max(std,
        # 1) at the last step: its renormalized top-2 gates flip at
        # near-ties under bf16 rounding.  The bar sits at twice that floor,
        # measured in this run; a fault planted in K4's head grouping must
        # fail it; the same int8 weights served in f32 compute are held to
        # phase 3's bars.
        counts, stats, _ = _moe_engine_leg(
            "(d) mixtral_8x7b int8, dense dispatch", mcfg, qparams, mprompts,
            max_new, scales=scales, check=[1, 5], noise=True, fault=True,
            ttft=False)
        stats.update(init=init, card_gib=total_mem,
                     headroom_gib=total_mem - stats["peak_mem_gib"],
                     decode_bound=decode_bytes_per_step(mcfg, qparams, scales,
                                                        8, 150.0))
        if stats["peak_mem_gib"] >= total_mem:
            raise AssertionError("(d) peak memory past the card's")
        add(mixtral_counts, counts)
        _free()
        _, stats["f32_check"], _ = _moe_engine_leg(
            "(d) mixtral_8x7b int8, f32 compute", dataclasses.replace(
                mcfg, dtype=torch.float32), qparams,
            [mprompts[1], mprompts[5]], max_new, scales=scales, check=[0, 1],
            ttft=False)
        out["d_mixtral_int8"] = stats
        del qparams, scales
        _free()
        out["leg_s"]["d"] = time.perf_counter() - t_leg
        t_leg = time.perf_counter()

        ck = os.path.abspath(os.path.join(MOE_DIR, "ck"))
        _in_process(
            "a moe_tiny_lm_gmm checkpoint for sample.py", "--config",
            "moe_tiny_lm_gmm", "--steps", "2", "--seed", str(SEED),
            "--checkpoint-dir", ck)
        tcfg = registry.get_config("moe_tiny_lm_gmm")
        rows_in = np.random.default_rng(SEED + 25).integers(
            1, tcfg.vocab_size, (2, 24)).tolist()
        tparams = CheckpointManager(ck).restore_params()
        res = {}
        for flags, c, quantized in (
                (["--dispatch", "gmm"], tcfg, False),
                (["--quant", "int8", "--dispatch", "dense"],
                 dataclasses.replace(tcfg, dispatch="dense"), True)):
            got = _sample_leg(ck, rows_in, 16, flags)
            p, s = (quant.quantize_params(tparams) if quantized
                    else (tparams, None))
            want = G.generate(c, p, rows_in, 16, quant_scales=s,
                              device="cuda")[:, 24:].tolist()
            res[" ".join(flags)] = got == want
            if got != want:
                raise AssertionError(f"(f) sample.py {flags}: {got} != "
                                     f"generate() {want}")
        out["f_sample_cli"] = res
        log(f"  (f) sample.py on a moe_tiny_lm_gmm checkpoint: "
            f"{json.dumps(res)}")
    finally:
        shutil.rmtree(os.path.abspath(MOE_DIR), ignore_errors=True)
    out["leg_s"]["f"] = time.perf_counter() - t_leg
    counts = {"moe_serve": serve_counts, "mixtral_serve": mixtral_counts,
              "moe_generate": gen_counts}
    log(f"  launches: {json.dumps(counts)}; legs {json.dumps(out['leg_s'])}")
    if min(min(c.values()) for c in counts.values()) <= 0:
        raise AssertionError("a kernel of the path never ran")
    return counts, rows, out


# -- phase 5 ------------------------------------------------------------------


def _backward_ms(out, inputs, grad, launches=20) -> float:
    """Device time of one autograd backward of an already built graph."""
    import torch

    return device_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                                 retain_graph=True),
                     launches=launches)


def _leaf(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def _rms_norm_fwd_case(gen, n: int, d: int) -> dict:
    """K1f as the training path calls it (also writing r for the backward)
    at its rows [B*S, d_model] bf16: [16384, 768] for llama_125m_lm (and
    moe_370m), [65536, 4096] for mistral_7b_lm."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    y, r = K.rms_norm_forward(x, s, 1e-5, with_r=True)
    ref = K.rms_norm_reference(x, s)
    r32 = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
    torch.cuda.synchronize()
    # As phase 2: f32 math rounded once to bf16; r is f32 in another
    # summation order.
    err = _check(f"rms_norm [{n}, {d}] bf16 (with r)", y, ref,
                 2 ** -7 * ref.float().abs() + 1e-6,
                 "one bf16 step: 2^-7 |ref| + 1e-6")
    _check("rms_norm r", r, r32, 1e-6 * r32.abs(), "1e-6 |ref|")
    del ref, r32
    body = K.rms_norm_body(x, s)

    def call(b=None):
        return K.rms_norm_forward(x, s, 1e-5, with_r=True, body=b)

    ms = device_ms(call)
    plain = device_ms(lambda: K.rms_norm_reference(x, s))
    lib = device_ms(lambda: F.rms_norm(x, (d,), s, 1e-5))
    bnd = bound(2 * n * d * 2 + n * 4 + d * 2, 4 * n * d, PEAK_F32_FLOPS)
    _report("rms_norm", f"[{n}, {d}] bf16 with r", ms, plain, lib, bnd, body)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib)
    CASES.append(dict(row, kernel="rms_norm", case=f"[{n}, {d}] bf16 with r",
                      body=body, **_other_body_ms("block", call)))
    return row


def _rms_norm_bwd_case(gen, n: int, d: int, *, dx_only: bool = False
                       ) -> dict:
    """K1b, the whole ``_rms_norm_pallas_bwd`` (dx and dscale), at the
    training path's rows [B*S, d_model], bf16 activations and scale (the
    bf16 policy casts the scale): [16384, 768] for llama_125m_lm (and
    moe_370m), [65536, 4096] for mistral_7b_lm.  Held against f32 and the
    plain version; timed with its body beside the other body's whole
    backward (the block body: its dx kernel and the einsum column sum),
    both bodies' dx alone, the plain version's two-gradient autograd,
    ``F.rms_norm``'s backward with x and the scale as leaves (the same
    function) and with x alone (dx only).  With ``dx_only`` (a frozen
    scale: the LoRA paths) the row returned is dx's alone, beside the
    plain version's and ``F.rms_norm``'s backward with x alone a leaf."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    g = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    _, r = K.rms_norm_forward(x, s, 1e-5, with_r=True)
    body = K.rms_norm_bwd_body(x, s, g)
    dx, ds = K.rms_norm_backward(x, s, r, g)
    xp, sp = _leaf(x, s)
    yp = K.rms_norm_reference(xp, sp)
    plain, plain_ds = torch.autograd.grad(yp, (xp, sp), g, retain_graph=True)
    x32, s32, g32 = x.float(), s.float(), g.float()
    (x32l,) = _leaf(x32)
    (ref32,) = torch.autograd.grad(K.rms_norm_reference(x32l, s32), x32l,
                                   g32)
    del x32l
    rr = torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-5)
    c = (g32 * s32 * x32).mean(-1, keepdim=True)
    terms = (rr * g32 * s32).abs() + (x32 * rr ** 3 * c).abs()
    ds32 = torch.einsum("nd,nd->d", g32, x32 * rr)
    mass = torch.einsum("nd,nd->d", g32.abs(), (x32 * rr).abs())
    del c, x32, g32
    torch.cuda.synchronize()
    shape = f"[{n}, {d}] bf16"
    # f32 math rounded once to bf16 (one bf16 step, at most 2^-7 of the
    # value), plus 1e-5 of the two terms of r*g*s - x*r^3*mean(g*s*x) for
    # f32 sums in another order.
    allowed = 2 ** -7 * ref32.abs() + 1e-5 * terms
    del terms
    _check(f"rms_norm_bwd {shape} dx vs f32", dx, ref32, allowed,
           "2^-7 |ref32| + 1e-5 (|r g s| + |x r^3 c|)")
    err = _check(f"rms_norm_bwd {shape} dx vs its plain version", dx, plain,
                 (plain.float() - ref32).abs() + allowed,
                 "|plain - ref32| + the above")
    del allowed, ref32, plain
    # dscale: the f32 column sum rounded once to bf16 (one bf16 step),
    # plus 1e-5 of sum_rows |g x r| for f32 sums in another order.
    ds_allowed = 2 ** -7 * ds32.abs() + 1e-5 * mass
    _check(f"rms_norm_bwd {shape} ds vs the f32 column sum", ds, ds32,
           ds_allowed, "2^-7 |ref32| + 1e-5 sum_rows |g x r|")
    err_ds = _check(f"rms_norm_bwd {shape} ds vs its plain version", ds,
                    plain_ds, (plain_ds.float() - ds32).abs() + ds_allowed,
                    "|plain - ref32| + the above")
    torch.cuda.empty_cache()

    def whole(b=None):
        return K.rms_norm_backward(x, s, r, g, body=b)

    def dx_alone(b=None):
        return K.rms_norm_backward(x, s, r, g, with_ds=False, body=b)

    other = "block" if body == "warp" else "warp"
    ms = device_ms(whole)
    other_ms = device_ms(lambda: whole(other))
    dx_ms = device_ms(dx_alone)
    dx_other_ms = device_ms(lambda: dx_alone(other))
    plain_ms = _backward_ms(yp, [xp, sp], g)
    del yp
    xl, sl = _leaf(x, s)
    yl = F.rms_norm(xl, (d,), sl, 1e-5)
    lib = _backward_ms(yl, [xl, sl], g)
    del yl
    (xl1,) = _leaf(x)
    yl1 = F.rms_norm(xl1, (d,), s, 1e-5)
    lib_dx = _backward_ms(yl1, xl1, g)
    del yl1
    bnd = bound(3 * n * d * 2 + n * 4 + 2 * d * 2, 10 * n * d,
                PEAK_F32_FLOPS)
    _report("rms_norm_bwd", f"{shape} dx + ds", ms, plain_ms, lib, bnd,
            body)
    log(f"    the {other} body's whole backward (its dx kernel"
        f"{' and the einsum column sum' if other == 'block' else ''}): "
        f"{other_ms * 1e3:.1f} us; dx alone: {body} {dx_ms * 1e3:.1f} us, "
        f"{other} {dx_other_ms * 1e3:.1f} us, F.rms_norm (x alone a leaf) "
        f"{lib_dx * 1e3:.1f} us")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=lib, max_abs_err_ds=err_ds)
    CASES.append(dict(row, kernel="rms_norm_bwd", case=f"{shape} dx + ds",
                      body=body, **{f"{other}_body_ms": other_ms},
                      dx_only_ms=dx_ms, **{f"{other}_dx_only_ms": dx_other_ms},
                      library_dx_only_ms=lib_dx))
    if not dx_only:
        return row
    (xd,) = _leaf(x)
    plain_dx = _backward_ms(K.rms_norm_reference(xd, s), xd, g)
    # Reads x, g, r and the scale, writes dx; about 8 operations a value.
    bnd = bound(3 * n * d * 2 + n * 4 + d * 2, 8 * n * d, PEAK_F32_FLOPS)
    _report("rms_norm_bwd", f"{shape} dx alone (frozen scale)", dx_ms,
            plain_dx, lib_dx, bnd, body)
    return dict(max_abs_err=err, ms=dx_ms, plain_ms=plain_dx,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_dx,
                what="dx alone: the scale is frozen")


def _cross_entropy_cases(gen, n: int = 16384, v: int = 32000) -> dict:
    """K3f and K3b at a training path's logits: [B*S, vocab] f32 (the
    task casts logits to f32 first): [16384, 32000] for llama_125m_lm,
    [32768, 30522] for bert_base_mlm (V % 4 = 2: every other row starts 8
    bytes off 16-byte alignment, so it takes a 2-element prologue)."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    logits = 3 * torch.randn(n, v, generator=gen, device="cuda")
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                           dtype=torch.int32)
    g = torch.full((n,), 1.0 / n, device="cuda")     # d(mean loss)
    loss, lse = K.cross_entropy_forward(logits, labels)
    (lp,) = _leaf(logits)
    plain = K.cross_entropy_reference(lp, labels)
    torch.cuda.synchronize()
    # One f32 logsumexp over 32,000 columns each, summed in another order.
    err_f = _check(f"cross_entropy [{n}, {v}] f32 vs plain", loss,
                   plain, 2e-5 + 1e-6 * plain.abs(), "2e-5 + 1e-6 |ref|")
    dl = K.cross_entropy_backward(logits, labels, lse, g)
    (dplain,) = torch.autograd.grad(plain, lp, g, retain_graph=True)
    pg = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True)
                   ) * g[:, None]
    torch.cuda.synchronize()
    # (p - onehot) g with p = exp(x - lse): lse within 2e-5 moves p by
    # 2e-5 of itself; 3e-5 (|ref| + p g).
    err_b = _check("cross_entropy_bwd vs plain", dl, dplain,
                   3e-5 * (dplain.abs() + pg), "3e-5 (|ref| + p g)")
    del pg
    lab64 = labels.long()
    rows = {}
    nbytes_f = 4 * n * v + 4 * n + 8 * n
    nbytes_b = 8 * n * v + 12 * n
    ms = device_ms(lambda: K.cross_entropy_forward(logits, labels),
                   launches=20)
    plain_ms = device_ms(lambda: K.cross_entropy_reference(logits, labels),
                         launches=10)
    lib = device_ms(lambda: F.cross_entropy(logits, lab64,
                                            reduction="none"), launches=10)
    bnd = bound(nbytes_f, 4 * n * v, PEAK_F32_FLOPS)
    _report("cross_entropy", f"[{n}, {v}] f32", ms, plain_ms, lib, bnd)
    rows["cross_entropy"] = dict(max_abs_err=err_f, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bnd[0], bound_by=bnd[1],
                                 library_ms=lib)
    ms = device_ms(lambda: K.cross_entropy_backward(logits, labels, lse, g),
                   launches=20)
    plain_ms = _backward_ms(plain, lp, g, launches=10)
    (ll,) = _leaf(logits)
    lib_out = F.cross_entropy(ll, lab64, reduction="none")
    lib = _backward_ms(lib_out, ll, g, launches=10)
    bnd = bound(nbytes_b, 4 * n * v, PEAK_F32_FLOPS)
    _report("cross_entropy_bwd", f"[{n}, {v}] f32", ms, plain_ms, lib, bnd)
    # What a plain stream of the same bytes reaches on this card: one
    # elementwise op reading the logits and writing a tensor of their size.
    out = torch.empty_like(logits)
    exp_ms = device_ms(lambda: torch.exp(logits, out=out), launches=20)
    log(f"    torch.exp over the same bytes: {exp_ms * 1e3:.1f} us "
        f"({nbytes_b / exp_ms / 1e6:.0f} GB/s; K3b "
        f"{nbytes_b / ms / 1e6:.0f} GB/s)")
    del out
    rows["cross_entropy_bwd"] = dict(max_abs_err=err_b, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bnd[0],
                                     bound_by=bnd[1], library_ms=lib,
                                     same_bytes_exp_ms=exp_ms)
    return rows


def _segments(gen, b, s):
    """[B, S] int32 packed rows: documents of random lengths, ids rising
    along each row."""
    import torch

    cuts = torch.sort(torch.randint(1, s, (b, 5), generator=gen,
                                    device="cuda"), dim=1).values
    pos = torch.arange(s, device="cuda")
    return (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(torch.int32)


def _flash_f32(q, k, v, do, causal, seg, scale, window=None, sinks=0):
    """The flash function (with ``window``, the splash function) in f32
    from the same (bf16) inputs, one (batch row, kv head) at a time, with
    the magnitude terms its error bounds need: the exact out/dq/dk/dv, and
    for each the sum of |terms| that bf16 rounding of p, dS and o can move
    (see ``_flash_case``).  Also returns the visible (query, key) pairs,
    summed over heads."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    rep = q.shape[1] // k.shape[1]
    names = ("out", "dq", "dk", "dv", "out_t", "dq_t", "dk_t", "dv_t")
    res = {n: [] for n in names}
    pairs = 0
    n = q.shape[2]
    for i in range(q.shape[0]):
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device)
        if causal:
            keep = keep.tril()
        if window is not None:
            keep = keep & K.splash_mask(n, window, sinks, q.device)
        if seg is not None:
            keep = keep & (seg[i][:, None] == seg[i][None, :])
        pairs += int(keep.sum()) * q.shape[1]
        mask = torch.where(keep, 0.0, K.FLASH_MASK_VALUE)
        row = {nm: [] for nm in names}
        for g in range(k.shape[1]):
            # The group's query heads [rep, S, D] against kv head g [S, D].
            q32 = q[i, g * rep:(g + 1) * rep].float()
            g32 = do[i, g * rep:(g + 1) * rep].float()
            k32, v32 = k[i, g].float(), v[i, g].float()
            p = torch.softmax((q32 @ k32.t()) * scale + mask, -1)
            out = p @ v32
            dp = g32 @ v32.t()
            di = (g32 * out).sum(-1, keepdim=True)
            ds = p * (dp - di) * scale
            del dp
            dio = (g32.abs() * out.abs()).sum(-1, keepdim=True)  # o rounding
            dsa = ds.abs()
            pt = p.transpose(-1, -2)
            row["out"].append(out)
            row["out_t"].append(p @ v32.abs())
            row["dq"].append(ds @ k32)
            row["dq_t"].append(dsa @ k32.abs()
                               + scale * dio * (p @ k32.abs()))
            # dk, dv of kv head g sum over its query group.
            row["dk"].append((ds.transpose(-1, -2) @ q32).sum(0))
            row["dk_t"].append((dsa.transpose(-1, -2) @ q32.abs()
                                + scale * pt @ (dio * q32.abs())).sum(0))
            row["dv"].append((pt @ g32).sum(0))
            row["dv_t"].append((pt @ g32.abs()).sum(0))
            del p, pt, ds, dsa
        for nm in names:
            stack = torch.cat if nm[:2] in ("ou", "dq") else torch.stack
            res[nm].append(stack(row[nm]))
    return {nm: torch.stack(v) for nm, v in res.items()}, pairs


def _flash_case(gen, label, b, h, kvh, s, d, *, packed, main,
                causal=True, dtype=None) -> dict:
    """K2 forward and backward on [B, H, S, D] views of [B, S, H, D]
    storage (the model's layout), causal or full, bf16 (default) or f32,
    against the plain version and an f32 computation of the same
    function."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32

    def bshd(heads):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda").to(
            dtype).transpose(1, 2)

    q, k, v, do = bshd(h), bshd(kvh), bshd(kvh), bshd(h)
    seg = _segments(gen, b, s) if packed else None
    scale = d ** -0.5
    o, lse = K.flash_attention_forward(q, k, v, seg, causal, scale)
    dq, dk, dv = K.flash_attention_backward(q, k, v, o, lse, do, seg,
                                            causal, scale)
    # No atomics: a second backward on the same inputs is bitwise equal.
    again = K.flash_attention_backward(q, k, v, o, lse, do, seg, causal,
                                       scale)
    if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
        raise AssertionError(f"flash {label}: the backward is not bitwise "
                             f"repeatable")
    del again
    qp, kp, vp = _leaf(q, k, v)
    op = K.flash_attention_reference(qp, kp, vp, causal=causal,
                                     segment_ids=seg, sm_scale=scale)
    gp = torch.autograd.grad(op, (qp, kp, vp), do, retain_graph=True)
    ref, pairs = _flash_f32(q, k, v, do, causal, seg, scale)
    torch.cuda.synchronize()
    rows, errs = {}, {}
    # bf16: the kernel rounds p to bf16 before p.v and dS before dS.k /
    # dS^T.q, reads o in bf16 for di, and rounds its outputs once; each
    # rounding moves a value by at most 2^-8 of itself (bf16 keeps 8
    # significant bits).  So it stays within 2^-7 of (|ref32| + the sum of
    # |terms| those roundings touch), a factor 2 for the f32 sums.  f32
    # (the split body at D 64 and 128): every product a.b runs as six
    # products of exact bf16 terms, lo.hi + mid.mid + hi.lo + mid.hi +
    # hi.mid + hi.hi; what it drops, mid.lo + lo.mid + lo.lo, is at most
    # 3 2^-27 |a||b|, so a score moves by <= 2^-25 of sum |q||k| (a
    # relative error of p, through the exp) and o, dP, dV, dK, dQ by
    # 2^-25 of their |terms|.  The tensor core truncates its f32 running
    # sum, at most one ulp (2^-23) of the magnitudes a 16-deep step, 6 S /
    # 16 steps deep: 2^-16.4 at S 256 (each tile's products start a fresh
    # sum, so S is a tile's depth past 256).  The chain (s, p, o, di, dS,
    # the gradient) at most quadruples these, inside 2^-14;
    # tests/test_torch_flash_split.py emulates the products on the CPU and
    # finds them within 0.011 of this rule and 0.08 of the f32 tolerances
    # of the card's tests (2e-5 / 1e-4 against the plain version), where
    # three products (hi and mid alone) reach 0.59 of those and bf16 alone
    # misses the rule 41-86x.  The FMA body (D 256): only the order of f32
    # sums differs, S 2^-24 <= 2^-16 at S <= 256, the same 2^-14.  Against
    # the plain version, its own measured distance from ref32 is allowed
    # on top.
    rel, rule = (2 ** -14, "2^-14") if f32 else (2 ** -7, "2^-7")
    for name, got, plain in (("out", o, op), ("dq", dq, gp[0]),
                             ("dk", dk, gp[1]), ("dv", dv, gp[2])):
        r32 = ref[name]
        allowed = rel * (r32.abs() + ref[name + "_t"]) + 1e-6
        _check(f"flash {label} {name} vs f32", got, r32, allowed,
               f"{rule} (|ref32| + |terms|) + 1e-6")
        errs[name] = _check(f"flash {label} {name} vs plain", got, plain,
                            (plain.float() - r32).abs() + allowed,
                            "|plain - ref32| + the above")
    del ref
    shape = (f"B {b} H {h} KVH {kvh} S {s} D {d} "
             f"{'causal' if causal else 'full'} {'f32' if f32 else 'bf16'}"
             + (" packed" if packed else ""))
    es = q.element_size()
    in_bytes = (q.numel() + k.numel() + v.numel()) * es
    fwd_bytes = in_bytes + o.numel() * es + lse.numel() * 4
    bwd_bytes = (in_bytes + 2 * o.numel() * es + lse.numel() * 4
                 + (dq.numel() + dk.numel() + dv.numel()) * es)
    rep = h // kvh
    kr, vr = (t.repeat_interleave(rep, 1) for t in (k, v))
    mask = None
    if seg is not None:
        mask = seg[:, None, :, None] == seg[:, None, None, :]
        if causal:
            mask = mask & torch.ones(s, s, dtype=torch.bool,
                                     device="cuda").tril()

    def lib_fwd(qq, kk, vv):
        if mask is None:
            return F.scaled_dot_product_attention(qq, kk, vv,
                                                  is_causal=causal)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    body = K.flash_attention_body(q.dtype, d)
    # The split body's f32 calls also time the FMA body (PRs 2-10's) on
    # the same inputs.
    other = "FMA" if body == "split" else None
    ms = device_ms(lambda: K.flash_attention_forward(q, k, v, seg, causal,
                                                     scale), launches=10)
    plain_ms = device_ms(lambda: K.flash_attention_reference(
        q, k, v, causal=causal, segment_ids=seg, sm_scale=scale),
        launches=3)
    lib = device_ms(lambda: lib_fwd(q, kr, vr), launches=10)
    bnd, fma = product_bound(fwd_bytes, 4 * d * pairs, f32,
                             ATTENTION_SPLIT_PRODUCTS)
    _report("flash_attention", shape, ms, plain_ms, lib, bnd, body)
    log(f"  flash_attention {shape}: {body} body, "
        f"{4 * d * pairs / ms / 1e9:.1f} TFLOP/s"
        + _fma_note(fma))
    rows["flash_attention"] = dict(
        max_abs_err=errs["out"], ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=lib, fma_bound_ms=fma and fma[0],
        body=body, **(_other_body_ms(other, lambda bd: K.flash_attention_forward(
            q, k, v, seg, causal, scale, body=bd)) if other else {}))
    ms = device_ms(lambda: K.flash_attention_backward(
        q, k, v, o, lse, do, seg, causal, scale), launches=10)
    plain_ms = _backward_ms(op, (qp, kp, vp), do, launches=3)
    ql, kl, vl = _leaf(q, kr, vr)
    lib = _backward_ms(lib_fwd(ql, kl, vl), (ql, kl, vl), do, launches=10)
    bnd, fma = product_bound(bwd_bytes, 10 * d * pairs, f32,
                             ATTENTION_SPLIT_PRODUCTS)
    _report("flash_attention_bwd", shape, ms, plain_ms, lib, bnd, body)
    log(f"  flash_attention_bwd {shape}: {body} body, "
        f"{10 * d * pairs / ms / 1e9:.1f} TFLOP/s"
        + _fma_note(fma))
    rows["flash_attention_bwd"] = dict(
        max_abs_err=max(errs["dq"], errs["dk"], errs["dv"]), ms=ms,
        plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib,
        fma_bound_ms=fma and fma[0], body=body,
        **(_other_body_ms(other, lambda bd: K.flash_attention_backward(
            q, k, v, o, lse, do, seg, causal, scale, body=bd))
           if other else {}))
    log(f"  flash {label}: {pairs} visible (query, key) pairs")
    if not main:
        for name, row in rows.items():
            CASES.append(dict(row, kernel=name, case=f"{label}: {shape}"))
        return {}
    return rows


def phase_train_kernels() -> dict:
    """The training kernels against their plain versions at the training
    path's shapes; returns their rows of the kernels' JSON line by path:
    "train" (llama_125m_lm), "window_train" (K1f and K1b at
    mistral_7b_lm's rows) and "debug" (llama_125m_lm at phase 29 (b)'s
    1 x 2048)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {"rms_norm": _rms_norm_fwd_case(gen, 16384, 768),
            "rms_norm_bwd": _rms_norm_bwd_case(gen, 16384, 768)}
    torch.cuda.empty_cache()
    rows.update(_cross_entropy_cases(gen))
    torch.cuda.empty_cache()
    # llama_125m's attention (the JSON line's shape), Llama-2-7B's head,
    # and GQA over packed rows.
    rows.update(_flash_case(gen, "llama_125m", 8, 12, 12, 2048, 64,
                            packed=False, main=True))
    torch.cuda.empty_cache()
    _flash_case(gen, "llama2_7b head", 1, 32, 32, 2048, 128, packed=False,
                main=False)
    _flash_case(gen, "gqa packed", 2, 16, 4, 1024, 128, packed=True,
                main=False)
    torch.cuda.empty_cache()
    window = {"rms_norm": _rms_norm_fwd_case(gen, 65536, 4096)}
    torch.cuda.empty_cache()
    window["rms_norm_bwd"] = _rms_norm_bwd_case(gen, 65536, 4096)
    torch.cuda.empty_cache()
    # Phase 29 (b)'s step: llama_125m_lm at 1 x 2048.
    debug = {"rms_norm": _rms_norm_fwd_case(gen, 2048, 768),
             "rms_norm_bwd": _rms_norm_bwd_case(gen, 2048, 768)}
    debug.update(_cross_entropy_cases(gen, 2048))
    debug.update(_flash_case(gen, "llama_125m 1 x 2048", 1, 12, 12, 2048,
                             64, packed=False, main=True))
    torch.cuda.empty_cache()
    return {"train": rows, "window_train": window, "debug": debug}


# -- phase 6 ------------------------------------------------------------------


def train_launches_per_step(num_layers: int) -> dict:
    """Kernel launches of one training step of a decoder under full remat:
    every block's forward runs twice (the forward, and again in the
    backward), the final norm and the loss once."""
    n = num_layers
    return {"flash_attention": 2 * n, "flash_attention_bwd": n,
            "rms_norm": 4 * n + 1, "rms_norm_bwd": 2 * n + 1,
            "cross_entropy": 1, "cross_entropy_bwd": 1}


def phase_train(steps: int = 20, log_every: int = 5) -> tuple:
    """The trainer on llama_125m_lm at full width and depth, through the
    CLI's own construction (``train.make_trainer``): b 8 x s 2048, bf16
    compute over f32 params, adamw + clip 1.0 + warmup_cosine, random
    weights from seed 0.  Counts are zeroed just before ``fit`` and read
    just after."""
    import math

    import torch
    from tensorflow_train_distributed_torch import train as T
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.ops import kernels as K

    name = "llama_125m_lm"
    args = T.build_parser().parse_args(
        ["--config", name, "--steps", str(steps), "--seed", str(SEED),
         "--log-every", str(log_every), "--log-grad-norm", "--device",
         "cuda"])
    entry = registry.get_entry(name)
    cfg = entry["config"]
    drains = _drain_stamps(log_every)
    base = torch.cuda.memory_allocated()
    _, trainer, batches = T.make_trainer(args, entry, callbacks=[drains])
    state = trainer.create_state()
    torch.cuda.synchronize()
    stamps = drains.times

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = trainer.fit(batches, steps=steps, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in TRAIN_KERNELS}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in TRAIN_KERNELS and v}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in history]
    for step, m in history:
        log(f"  step {step}: loss {m['loss']:.4f} accuracy "
            f"{m['accuracy']:.4f} lr {m['lr']:.3e} grad_norm "
            f"{m['grad_norm']:.3f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    want = {k: steps * v for k, v in
            train_launches_per_step(cfg.num_layers).items()}
    log(f"  launches {counts} (expected {want}); others {others}")
    if counts != want or others:
        raise AssertionError(f"training launches {counts}, others {others};"
                             f" expected {want}")
    # Window times between metric drains (each drain waits for the
    # device); the first window, which holds the warm-up, is left out.
    windows = [(b - a) / log_every for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(windows) if windows else wall / steps
    b, s = entry["global_batch_size"], entry["dataset_kwargs"]["seq_len"]
    tokens = b * s
    n_params = state.num_params()
    per_token, formula = decoder_flops_per_token(n_params, cfg, s)
    flops = per_token * tokens
    stats = dict(
        config=name, steps=steps, batch=b, seq=s, params=n_params,
        step_ms=step_s * 1e3, window_ms_per_step=[w * 1e3 for w in windows],
        tokens_per_s=tokens / step_s, peak_mem_gib=peak / 2 ** 30,
        base_mem_gib=base / 2 ** 30, wall_s=wall, losses=losses,
        mfu=flops / step_s / PEAK_BF16_FLOPS, mfu_formula=formula)
    stats["profile"] = _profile_train_step(trainer, state, batches)
    log(f"  training: {json.dumps(stats)}")
    return counts, stats


def _profile_train_step(trainer, state, batches):
    """One more training step under torch.profiler (CUPTI), after the
    counted run: the device's busy share of the step's wall time and the
    kernel time by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tensorflow_train_distributed_torch.data.pipeline import to_device

    batch = to_device(next(iter(batches)), "cuda")
    trainer.train_step(state, batch)            # same shapes, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds = dict.fromkeys(KINDS, 0.0)
    top, n_kernels = [], 0
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        n_kernels += e.count
        kinds[classify(e.key)] += us
        top.append((us, e.count, e.key[:70]))
    busy = sum(kinds.values())
    if busy == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return None
    top.sort(reverse=True)
    for us, count, name in top[:12]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {name}")
    return dict(step_wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                busy_share_profiled=busy / wall_us, device_kernels=n_kernels,
                kernel_ms_by_kind={k: v / 1e3 for k, v in kinds.items()})


# -- phases 6b and 8b ---------------------------------------------------------


class _plain_kernels:
    """Context in which the training kernels' wrappers compute their plain
    versions on CUDA tensors (the comparison models of phases 6b, 8b and
    10b only)."""

    NAMES = ("rms_norm", "cross_entropy", "flash_attention",
             "splash_attention", "gmm")

    def __enter__(self):
        from tensorflow_train_distributed_torch.ops import kernels as K

        self.saved = {n: getattr(K, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(K, n, getattr(K, n + "_reference"))

    def __exit__(self, *exc):
        from tensorflow_train_distributed_torch.ops import kernels as K

        for n, fn in self.saved.items():
            setattr(K, n, fn)


def _grad_check(label, make_task, host, bounds) -> dict:
    """One step's gradients of ``make_task(dtype)`` on the card, kernels
    against the same model with every training wrapper on its plain
    version, for each (precision, dtype, bound) of ``bounds``: each
    leaf's relative L2 distance, the largest held to the bound."""
    import torch
    from tensorflow_train_distributed_torch.data.pipeline import to_device
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy)
    from tensorflow_train_distributed_torch.training.trainer import Trainer

    out = {}
    for precision, dtype, tol in bounds:
        trainer = Trainer(make_task(dtype), optimizers.sgd(0.0),
                          policy=Policy.from_name(precision), device="cuda")
        state = trainer.create_state()
        params = list(state.params.values())
        batch = trainer.policy.cast_to_compute(to_device(host, "cuda"))
        got, loss_k, _ = trainer._microbatch_grads(params, batch, None)
        with _plain_kernels():
            want, loss_p, _ = trainer._microbatch_grads(params, batch, None)
        worst, worst_name = 0.0, ""
        for name, a, b in zip(state.params, got, want):
            rel = ((a.float() - b.float()).norm()
                   / b.float().norm().clamp_min(1e-30)).item()
            if rel > worst:
                worst, worst_name = rel, name
        log(f"  grads {label} {precision}: loss kernels {loss_k.item():.6f}"
            f" plain {loss_p.item():.6f}; worst leaf {worst_name} relative "
            f"L2 {worst:.3e} (bound {tol}) {'ok' if worst <= tol else 'FAIL'}")
        if not worst <= tol:
            raise AssertionError(f"{label} {precision} grads: {worst_name} "
                                 f"differs by {worst:.3e} > {tol}")
        out[precision] = dict(worst_leaf=worst_name, worst_rel_l2=worst,
                              bound=tol)
        del trainer, state, params, got, want
        torch.cuda.empty_cache()
    return out


def phase_grad_check() -> dict:
    """(a) llama_125m cut to 2 layers, b 8 x s 2048.  f32: the same math
    in other orders; bf16: the kernels and the plain versions round at
    other places (p, dS, the norms' outputs)."""
    import dataclasses

    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    src = SyntheticLM(num_examples=64, seq_len=2048, vocab_size=32_000)
    host = next(iter(HostBatches(src, 8, seed=SEED)))
    return _grad_check(
        "llama_125m[2 layers]",
        lambda dtype: CausalLmTask(dataclasses.replace(
            LLAMA_PRESETS["llama_125m"], num_layers=2, dtype=dtype),
            device="meta"), host,
        (("float32", torch.float32, 1e-4),
         ("bfloat16", torch.bfloat16, 3e-2)))


def phase_moe_grad_check() -> dict:
    """(a) moe_370m with gmm cut to 2 layers, b 8 x s 1024.  f32: other
    summation orders (1e-4).  bf16: besides the roundings at other
    places, a token whose top-2 choice is a near-tie may go to another
    expert on one side: each such row moves ~1/sqrt(rows an expert) of
    that expert's gradient, so the bound is 0.1."""
    import dataclasses

    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.moe import (
        MOE_PRESETS, MoeLmTask)

    src = SyntheticLM(num_examples=64, seq_len=1024, vocab_size=32_000)
    host = next(iter(HostBatches(src, 8, seed=SEED)))
    return _grad_check(
        "moe_370m[2 layers] gmm",
        lambda dtype: MoeLmTask(dataclasses.replace(
            MOE_PRESETS["moe_370m"], num_layers=2, dispatch="gmm",
            dtype=dtype), device="meta"), host,
        (("float32", torch.float32, 1e-4),
         ("bfloat16", torch.bfloat16, 1e-1)))


ZERO_GRAD_RATIO = 1e-6     # |a zero gradient| over its layer's largest


def _layer_of(name: str) -> str:
    """``layers.<i>`` for a parameter of block i, else the name itself."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else name


def _step_grads(trainer, state, batch) -> dict:
    """The f32 gradients of ``trainer``'s next step on ``batch`` (device
    tensors; that step's dropout draw), on the host, with no update."""
    import functools

    from tensorflow_train_distributed_torch.models import layers as L

    if state.model_state:
        raise ValueError("a training forward would move the running "
                         "statistics the comparison holds")
    trainer.task.model.train()
    with L.dropout_generator(functools.partial(trainer._generator,
                                               state.step)):
        grads, _, _ = trainer._microbatch_grads(
            list(state.params.values()), trainer.policy.cast_to_compute(
                batch), state.loss_scale)
    return {k: g.detach().float().cpu() for k, g in zip(state.params, grads)}


def _zero_grad_ratios(grads: dict) -> dict:
    """Each parameter's largest |gradient| over its layer's largest."""
    peak = {}
    for k, g in grads.items():
        peak[_layer_of(k)] = max(peak.get(_layer_of(k), 0.0),
                                 g.abs().max().item())
    return {k: g.abs().max().item() / max(peak[_layer_of(k)], 1e-30)
            for k, g in grads.items()}


def _card_vs_cpu(label, make_task, cfg, kernels, *, seq=None, vocab=None,
                 steps, source=None, zero_grad=False) -> dict:
    """``steps`` f32 steps of ``make_task()`` on the card against the same
    steps of the port on the CPU, whose plain versions the CPU tests hold
    to the JAX package, over ``source`` (default: ``SyntheticLM`` rows of
    ``seq`` tokens); every kernel in ``kernels`` must have run, and the
    model state (BatchNorm's running statistics) must agree as the
    params do.  With ``zero_grad``, the parameters whose exact gradient
    is 0 (an attention key bias: softmax ignores a shift along the keys)
    are found from the CPU's gradient on the first batch at the run's end
    (at its start a zero-initialised head leaves every other gradient
    exactly 0), every entry within ``ZERO_GRAD_RATIO`` of its layer's
    largest; there must be some.  Adam turns their round-off gradients
    into steps of up to ~lr, which two CPU runs at 1 and 8 threads already
    part on, so they are left out of the parameters' relative L2, and the
    card's gradient of each at its own run's end is held to the same
    round-off bound instead."""
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import (
        HostBatches, to_device)
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.training import (
        optimizers, schedules)
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy)
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer, TrainerConfig)

    params = convert.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device="cpu", dtype=torch.float32)
    runs, ratios = {}, {}
    src = source or SyntheticLM(num_examples=64, seq_len=seq,
                                vocab_size=vocab)
    for device in ("cpu", "cuda"):
        lr = schedules.by_name("warmup_cosine", 3e-3, steps, warmup_steps=1)
        tx = optimizers.make_optimizer("adamw", lr, weight_decay=0.01,
                                       grad_clip_norm=1.0)
        trainer = Trainer(make_task(), tx, policy=Policy.from_name("float32"),
                          config=TrainerConfig(log_every=1,
                                               log_grad_norm=True),
                          lr_schedule=lr, device=device)
        state = trainer.create_state({k: v.clone() for k, v in
                                      params.items()})
        K.reset_launch_counts()
        state, history = trainer.fit(HostBatches(src, 8, seed=SEED),
                                     steps=steps, state=state)
        runs[device] = (history, {k: p.detach().cpu() for k, p in
                                  state.params.items()},
                        K.launch_counts(),
                        {k: v.cpu() for k, v in state.model_state.items()})
        if zero_grad:
            first = next(iter(HostBatches(src, 8, seed=SEED)))
            ratios[device] = _zero_grad_ratios(_step_grads(
                trainer, state, to_device(first, trainer.device)))
    counts = {k: runs["cuda"][2][k] for k in kernels}
    if counts and min(counts.values()) <= 0:
        raise AssertionError(f"{label}: a kernel did not run: {counts}")
    dl = max(abs(a["loss"] - b["loss"]) for (_, a), (_, b) in
             zip(runs["cpu"][0], runs["cuda"][0]))
    dg = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
             for (_, a), (_, b) in zip(runs["cpu"][0], runs["cuda"][0]))
    card = {**runs["cuda"][1], **runs["cuda"][3]}
    zeros = sorted(k for k, r in ratios.get("cpu", {}).items()
                   if r <= ZERO_GRAD_RATIO)
    if zero_grad and not zeros:
        raise AssertionError(f"{label}: no parameter has a zero gradient")
    dp = max(((card[k] - p).norm() / p.norm()).item()
             for k, p in {**runs["cpu"][1], **runs["cpu"][3]}.items()
             if k not in zeros)
    zg_cpu = max((ratios["cpu"][k] for k in zeros), default=0.0)
    zg_card = max((ratios["cuda"][k] for k in zeros), default=0.0)
    losses = [(a["loss"], b["loss"]) for (_, a), (_, b) in
              zip(runs["cpu"][0], runs["cuda"][0])]
    log(f"  {label} card vs cpu, {steps} steps f32: losses {losses}")
    # f32 on both sides, other kernels and summation orders, carried
    # through five adamw steps.
    ok = (dl <= 1e-4 and dg <= 1e-3 and dp <= 1e-4
          and zg_card <= ZERO_GRAD_RATIO)
    zg = (f"; {len(zeros)} zero-gradient params ({zeros[0]}, ...): their "
          f"largest gradient at the end {zg_card:.3e} of its layer's on "
          f"the card, {zg_cpu:.3e} on the CPU (bound {ZERO_GRAD_RATIO})"
          if zeros else "")
    log(f"  max |loss diff| {dl:.3e} (bound 1e-4), grad_norm relative "
        f"{dg:.3e} (1e-3), params and model state relative L2 {dp:.3e} "
        f"(1e-4){zg}; launches "
        f"{counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's training run left the "
                             f"CPU's")
    return dict(max_loss_diff=dl, grad_norm_rel=dg, params_rel_l2=dp,
                launches=counts, **({"zero_grad_params": zeros,
                                     "zero_grad_ratio_card": zg_card,
                                     "zero_grad_ratio_cpu": zg_cpu}
                                    if zero_grad else {}))


def phase_card_vs_cpu(steps: int = 5) -> dict:
    """(b) A llama_tiny-width decoder with 64-wide heads (so the flash
    kernel takes it; GQA 2:1) at f32 and seq 128."""
    import dataclasses

    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    cfg = dataclasses.replace(LLAMA_PRESETS["llama_tiny"], num_heads=2,
                              num_kv_heads=1, head_dim=64, remat=True)
    return _card_vs_cpu("llama_tiny[hd 64]",
                        lambda: CausalLmTask(cfg, device="meta"), cfg,
                        TRAIN_KERNELS, seq=128, vocab=256, steps=steps)


def phase_moe_card_vs_cpu(steps: int = 5) -> dict:
    """(b) moe_tiny_lm_gmm (f32, seq 32: its attention takes the plain
    path, the grouped matmuls the kernels)."""
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.models.moe import MoeLmTask

    entry = registry.get_entry("moe_tiny_lm_gmm")
    cfg = entry["config"]
    return _card_vs_cpu("moe_tiny_lm_gmm",
                        lambda: MoeLmTask(cfg, device="meta"), cfg,
                        ["gmm", "tgmm"],
                        seq=entry["dataset_kwargs"]["seq_len"],
                        vocab=entry["dataset_kwargs"]["vocab_size"],
                        steps=steps)


# -- phase 7 ------------------------------------------------------------------


def _routed_sizes(gen, tokens, d, experts, top_k):
    """[E] int32 group sizes of a top-k routing of ``tokens`` random
    tokens through a random f32 router, rows padded to 128 on the last
    expert (``models/moe.py``'s pad)."""
    import torch

    x = torch.randn(tokens, d, generator=gen, device="cuda")
    w = torch.randn(d, experts, generator=gen, device="cuda") / d ** 0.5
    top = torch.topk(torch.softmax(x @ w, -1), top_k).indices.reshape(-1)
    sizes = torch.zeros(experts, dtype=torch.int64, device="cuda")
    sizes.scatter_add_(0, top, torch.ones_like(top))
    m = tokens * top_k
    sizes[-1] += -(-m // 128) * 128 - m
    return sizes.to(torch.int32)


def _library_ms(fn, **timing):
    """``device_ms`` of a library call, or None where the call does not
    take these operands (``F.grouped_mm`` wants bf16)."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"  library call refused: {str(e).splitlines()[0][:160]}")
        return None
    return device_ms(fn, **timing)


def _gmm_case(gen, label, kind, m, k, n, sizes, *, timing=None,
              timed=True, old_body=False, want_body=None) -> dict:
    """One grouped matmul as the MoE step runs it, for a forward product
    of width k -> n over ``sizes`` (``near``: where ``F.grouped_mm``
    cannot compute the function itself, its nearest call, timed as a
    yardstick and kept out of ``library_ms``):

    - ``fwd``: gmm, lhs [m, k] bf16 x rhs [E, k, n] bf16 -> [m, n] f32
      (tensor cores, depth k);
    - ``grad_lhs``: gmm, cotangent [m, n] f32 x the same rhs read
      transposed -> [m, k] bf16 (f32 math, depth n);
    - ``tgmm``: grad_rhs, lhs [m, k] bf16 (read as [k, m]) x cotangent
      [m, n] f32 -> [E, k, n] bf16 (f32 math, depth: each group's rows).

    Held against the f32 computation within ``K.gmm_tolerance``, and
    against the plain version within that plus the plain version's own
    distance from the f32 values.  Two controls show the bound is tight
    enough to catch a wrong kernel: the plain result with 32 of one
    group's summed products left out, and, for the f32-math products, the
    kernel run with the cotangent rounded to bf16 (the tensor-core
    path).  Each must fall outside the bound.

    The bound of the f32 products is that of the route the "wgmma" body
    takes: three bf16 tensor-core products (the f32 operand split
    exactly into three bf16 terms), 3 x 2mkn at 989 TFLOP/s, or the
    bytes; the FMA route's 2mkn at 67 TFLOP/s is logged beside it.
    ``old_body``: also time, forced, the older body these operands took
    before the "wgmma" body ("mma.sync" for bf16 x bf16, "FMA" for the
    f32 products).  ``want_body``: the body the library must choose."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    e = sizes.shape[0]
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    offs = torch.cumsum(sizes, 0).to(torch.int32)
    spans = K._group_spans(sizes, m)
    g0, lo, hi = max(spans, key=lambda sp: sp[2] - sp[1])  # largest group
    near = None
    if kind in ("fwd", "grad_lhs"):
        w = randn(e, k, n)
    if kind == "fwd":
        a, depth, out_dtype = randn(m, k), k, torch.float32
        run = lambda b=None: K.gmm_forward(a, w, sizes, out_dtype, False,
                                           body=b)
        body = K.gmm_body(a, w, False)
        plain = lambda aa, ww, dt: K.gmm_reference(
            aa, ww, sizes, preferred_element_type=dt)
        lib = lambda: F.grouped_mm(a, w, offs=offs, out_dtype=out_dtype)
        # The library's nearest call: the same products, bf16 output.
        near = lambda: F.grouped_mm(a, w, offs=offs)
        operands, flops = (a, w), 2 * int(sizes.sum()) * k * n
        bf16_control = None
    elif kind == "grad_lhs":
        a, depth, out_dtype = randn(m, n, dtype=torch.float32), n, bf
        run = lambda b=None: K.gmm_forward(a, w, sizes, out_dtype, True,
                                           body=b)
        body = K.gmm_body(a, w, True)
        plain = lambda aa, ww, dt: K.gmm_reference(
            aa, ww, sizes, preferred_element_type=dt, transpose_rhs=True)
        lib = lambda: F.grouped_mm(a, w.transpose(1, 2), offs=offs,
                                   out_dtype=out_dtype)
        operands, flops = (a, w), 2 * int(sizes.sum()) * k * n
        bf16_control = lambda: K.gmm_forward(a.to(bf), w, sizes, bf, True)
    else:
        x = randn(m, k)
        w = randn(m, n, dtype=torch.float32)        # the cotangent
        a, out_dtype = x, bf
        depth = torch.tensor([end - start for _, start, end in spans],
                             dtype=torch.float32, device="cuda")[:, None, None]
        run = lambda b=None: K.tgmm_forward(x, w, sizes, out_dtype, body=b)
        body = K.tgmm_body(x, w)
        plain = lambda aa, ww, dt: K.tgmm_reference(
            aa.t(), ww, sizes, preferred_element_type=dt)
        lib = lambda: F.grouped_mm(x.t(), w, offs=offs, out_dtype=out_dtype)
        operands, flops = (x, w), 2 * m * k * n
        bf16_control = lambda: K.tgmm_forward(x, w.to(bf), sizes, bf)
    tensor_cores = all(t.dtype == bf for t in operands)
    if want_body is not None and body != want_body:
        raise AssertionError(f"{kind} {label}: body {body}, expected "
                             f"{want_body}")
    got = run()
    ref32 = plain(*operands, torch.float32)
    sumsq32 = plain(*(t.float() ** 2 for t in operands), torch.float32)
    ref = plain(*operands, out_dtype)
    torch.cuda.synchronize()
    rule = (f"K.gmm_tolerance, {'tensor cores' if tensor_cores else 'f32'}"
            f"{', bf16 output' if out_dtype == bf else ''}")
    allowed = K.gmm_tolerance(got, ref32, sumsq32, depth, tensor_cores)
    _check(f"{kind} {label} vs f32", got, ref32, allowed, rule)
    err = _check(f"{kind} {label} vs its plain version", got, ref,
                 (ref.float() - ref32).abs() + allowed,
                 "|plain - ref32| + the above")
    controls, ratios = {}, {}
    if timed and hi - lo >= 32:
        # 32 products of group g0's sums left out.
        cut = [operands[0].clone(), operands[1]]
        if kind == "tgmm":
            cut[0][lo:lo + 32] = 0
        else:
            cut[0][lo:hi, :32] = 0
        controls["dropped 32 products"] = plain(*cut, out_dtype)
        del cut
    if timed and bf16_control is not None:
        controls["bf16 cotangent"] = bf16_control()
    for what, bad in controls.items():
        worst = _worst_ratio(bad, ref32, K.gmm_tolerance(
            bad, ref32, sumsq32, depth, tensor_cores))
        log(f"  control {kind} {label}, {what}: worst |err| / allowed "
            f"{worst:.3g} {'rejected' if worst > 1 else 'ACCEPTED'}")
        if not worst > 1:
            raise AssertionError(f"{kind} {label}: the bound accepts a "
                                 f"result with {what}")
        ratios[what] = worst
    del controls, sumsq32, ref32, allowed
    nbytes = (sum(t.numel() * t.element_size() for t in operands)
              + got.numel() * got.element_size() + 4 * e)
    if kind != "tgmm":
        # The groups that hold no rows need none of their weights.
        live = sum(1 for _, start, end in spans if end > start)
        nbytes -= w.numel() * w.element_size() * (e - live) // e
    bnd, fma_bnd = product_bound(nbytes, flops, not tensor_cores)
    shape = (f"{label}: m {m}, {k} -> {n}, E {e}, "
             f"{' x '.join(str(t.dtype)[6:] for t in operands)} -> "
             f"{str(out_dtype)[6:]}")
    old = "mma.sync" if tensor_cores else "FMA"
    row = dict(case=label, kind=kind, shape=shape, body=body,
               max_abs_err=err, ms=None, plain_ms=None, bound_ms=bnd[0],
               bound_by=bnd[1],
               fma_bound_ms=None if fma_bnd is None else fma_bnd[0],
               library_ms=None, near_library_ms=None,
               old_body=old if old_body else None, old_body_ms=None,
               control_worst_ratio=ratios)
    if timed:
        timing = timing or {}
        row.update(ms=device_ms(run, **timing),
                   old_body_ms=(device_ms(lambda: run(old), **timing)
                                if old_body else None),
                   plain_ms=device_ms(lambda: plain(*operands, out_dtype),
                                      **timing),
                   library_ms=_library_ms(lib, **timing))
        if near is not None and row["library_ms"] is None:
            row["near_library_ms"] = _library_ms(near, **timing)
        lib_txt = ("refused" if row["library_ms"] is None
                   else f"{row['library_ms'] * 1e3:.1f} us")
        if row["near_library_ms"] is not None:
            lib_txt += (f"; with a bf16 output "
                        f"{row['near_library_ms'] * 1e3:.1f} us")
        old_txt = (f", {old} body {row['old_body_ms'] * 1e3:.1f} us"
                   if old_body else "")
        fma_txt = ("" if fma_bnd is None else
                   f"; the FMA route's bound {fma_bnd[0] * 1e3:.1f} us")
        log(f"  {kind} {shape}: {body} body {row['ms'] * 1e3:.1f} us "
            f"({flops / row['ms'] / 1e9:.1f} TFLOP/s){old_txt}, bound "
            f"{bnd[0] * 1e3:.1f} us ({bnd[1]}"
            f"{'' if tensor_cores else ', three bf16 products'}{fma_txt}), "
            f"plain {row['plain_ms'] * 1e3:.1f} us, F.grouped_mm {lib_txt}")
    del got, ref
    torch.cuda.empty_cache()
    return row


def phase_moe_kernels() -> tuple:
    """gmm and tgmm against their plain versions at the MoE shapes.
    Returns (rows of the kernels' JSON line, every case's record)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cases = []
    # moe_370m: 8 x 1024 tokens, top-2 of 8 experts; the FFN's two widths.
    sizes = _routed_sizes(gen, 8 * 1024, 768, 8, 2)
    log(f"  moe_370m group sizes {sizes.tolist()}")
    for kind in ("fwd", "grad_lhs", "tgmm"):
        for k, n in ((768, 2048), (2048, 768)):
            cases.append(_gmm_case(gen, f"moe_370m {k}->{n}", kind, 16384,
                                   k, n, sizes, old_body=True,
                                   want_body="wgmma"))
    # Mixtral-8x7B: 4096 tokens x top-2 of 8, 4096 -> 14336 (962 GFLOP a
    # call: few timed launches).
    sizes = _routed_sizes(gen, 4096, 4096, 8, 2)
    for kind in ("fwd", "grad_lhs", "tgmm"):
        cases.append(_gmm_case(gen, "mixtral_8x7b", kind, 8192, 4096, 14336,
                               sizes, timing=dict(launches=2, repeats=3,
                                                  warmup=1),
                               want_body="wgmma"))
    # Qwen1.5-MoE-A2.7B: 2048 tokens x top-4 of 60, 2048 -> 1408.
    sizes = _routed_sizes(gen, 2048, 2048, 60, 4)
    for kind in ("fwd", "grad_lhs", "tgmm"):
        cases.append(_gmm_case(gen, "qwen15_moe_a27b", kind, 8192, 2048,
                               1408, sizes, timing=dict(launches=10),
                               want_body="wgmma"))
    # Edge cases: empty and ragged groups, k and n off the tiles, rows
    # past the sizes' sum (the kernel writes zeros there).
    for sizes_l, k, n in (([0, 37, 0, 200, 40], 72, 100),
                          ([300, 0], 200, 40), ([1, 0, 0], 16, 8)):
        sizes = torch.tensor(sizes_l, dtype=torch.int32, device="cuda")
        for kind in ("fwd", "grad_lhs", "tgmm"):
            _gmm_case(gen, f"edge {sizes_l}", kind, 320, k, n, sizes,
                      timed=False)
    rows = {"gmm": next(c for c in cases if c["kind"] == "fwd"),
            "tgmm": next(c for c in cases if c["kind"] == "tgmm")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {k: {f: v[f] for f in keys} for k, v in rows.items()}, cases


# -- phase 8 ------------------------------------------------------------------


def moe_launches_per_step(cfg) -> dict:
    """Kernel launches of one MoE training step under full remat: the
    decoder's (``train_launches_per_step``), plus for each MoE layer
    three gmm in the forward, three again in the recompute and three
    grad_lhs gmm, and three tgmm (grad_rhs) in the backward."""
    n_moe = -(-cfg.num_layers // cfg.moe_every)
    out = train_launches_per_step(cfg.num_layers)
    out.update(gmm=9 * n_moe, tgmm=3 * n_moe)
    return out


def phase_moe_train(steps: int = 20, log_every: int = 5) -> tuple:
    """The trainer on moe_370m with dispatch "gmm" at full width and depth,
    fed as ``tools/bench_moe.py`` feeds the JAX trainer: ``MoeLmTask``,
    adamw(1e-4, b1 0.9, b2 0.95, weight decay 0.1), bf16 compute over f32
    params, ``SyntheticLM`` 8 x 1024 at vocab 32000, random weights from
    seed 0.  Counts are zeroed just before ``fit`` and read just after."""
    import dataclasses
    import math

    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.moe import (
        MOE_PRESETS, MoeLmTask)
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy)
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer, TrainerConfig)

    cfg = dataclasses.replace(MOE_PRESETS["moe_370m"], dispatch="gmm")
    b, s = 8, 1024
    drains = _drain_stamps(log_every)
    trainer = Trainer(
        MoeLmTask(cfg, device="meta"),
        optimizers.adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.1),
        policy=Policy.from_name("bfloat16"),
        config=TrainerConfig(seed=SEED, log_every=log_every,
                             log_grad_norm=True), device="cuda",
        callbacks=[drains])
    state = trainer.create_state()
    batches = HostBatches(SyntheticLM(seq_len=s, vocab_size=cfg.vocab_size),
                          b, seed=SEED)
    torch.cuda.synchronize()
    stamps = drains.times

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = trainer.fit(batches, steps=steps, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in MOE_TRAIN_KERNELS}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in MOE_TRAIN_KERNELS and v}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in history]
    for step, m in history:
        log(f"  step {step}: loss {m['loss']:.4f} ce {m['ce_loss']:.4f} "
            f"aux {m['aux_loss']:.4f} accuracy {m['accuracy']:.4f} "
            f"grad_norm {m['grad_norm']:.3f} expert load "
            f"{m['expert_load_min']:.3f}-{m['expert_load_max']:.3f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    first = statistics.mean(losses[:log_every])
    last = statistics.mean(losses[-log_every:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first window {first}, "
                             f"last {last}")
    want = {k: steps * v for k, v in moe_launches_per_step(cfg).items()}
    log(f"  launches {counts} (expected {want}); others {others}")
    if counts != want or others:
        raise AssertionError(f"MoE training launches {counts}, others "
                             f"{others}; expected {want}")
    windows = [(t1 - t0_) / log_every for t0_, t1 in zip(stamps, stamps[1:])]
    step_s = statistics.median(windows) if windows else wall / steps
    tokens = b * s
    _, active = moe_active_params(
        {k: p.numel() for k, p in state.params.items()}, cfg)
    flops_per_token = moe_flops_per_token(active, cfg, s)
    stats = dict(
        config="moe_370m", dispatch="gmm", steps=steps, batch=b, seq=s,
        params=state.num_params(), active_params=int(active),
        step_ms=step_s * 1e3, window_ms_per_step=[w * 1e3 for w in windows],
        tokens_per_s=tokens / step_s, peak_mem_gib=peak / 2 ** 30,
        wall_s=wall, losses=losses, first_window_loss=first,
        last_window_loss=last,
        mfu=flops_per_token * tokens / step_s / PEAK_BF16_FLOPS,
        mfu_formula=FORMULAS["moe"])
    stats["profile"] = _profile_train_step(trainer, state, batches)
    log(f"  moe training: {json.dumps(stats)}")
    return counts, stats


# -- phase 9 ------------------------------------------------------------------


def _flex_ms(q, k, v, window, sinks, do):
    """Forward and backward times of ``flex_attention`` (compiled; the
    compile is not timed) with a sliding-window block mask on the same
    inputs, or (None, None) where it does not compile here."""
    import torch

    try:
        import torch._inductor.config as inductor_config
        from torch.nn.attention.flex_attention import (
            create_block_mask, flex_attention)

        inductor_config.compile_threads = 1     # no worker processes

        def band(b, h, qi, ki):
            return (qi >= ki) & ((qi - ki < window) | (ki < sinks))

        s = q.shape[2]
        block = create_block_mask(band, B=None, H=None, Q_LEN=s, KV_LEN=s,
                                  device="cuda")
        flex = torch.compile(flex_attention)
        t0 = time.perf_counter()
        ql, kl, vl = _leaf(q, k, v)
        out = flex(ql, kl, vl, block_mask=block, scale=1.0)
        torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)
        torch.cuda.synchronize()
        log(f"  flex_attention compiled in {time.perf_counter() - t0:.1f} s")
        fwd = device_ms(lambda: flex(q, k, v, block_mask=block, scale=1.0),
                        launches=10)
        return fwd, _backward_ms(out, (ql, kl, vl), do, launches=10)
    except Exception as e:          # any failure to build is "not run"
        log(f"  flex_attention not run: {type(e).__name__}: "
            f"{str(e).splitlines()[0][:160] if str(e) else ''}")
        return None, None


def _splash_case(gen, label, b, h, kvh, s, d, window, sinks, *, packed,
                 dtype, timed=False, flex=True) -> dict:
    """K7 forward and backward (the launch functions, on the pre-scaled
    query) on [B, H, S, D] views of [B, S, H, D] storage, held against an
    f32 computation of the same function and against the plain version;
    with ``timed``, timed beside the bound, the plain version,
    ``local_attention_chunked``, SDPA with the band as a boolean mask and
    ``flex_attention``."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import attention as TA
    from tensorflow_train_distributed_torch.ops import kernels as K

    def bshd(heads):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda").to(
            dtype).transpose(1, 2)

    q, k, v, do = bshd(h), bshd(kvh), bshd(kvh), bshd(h)
    seg = _segments(gen, b, s) if packed else None
    qs = K.splash_scaled_q(q, d ** -0.5)
    o, lse = K.splash_attention_forward(qs, k, v, seg, window, sinks)
    dq, dk, dv = K.splash_attention_backward(qs, k, v, o, lse, do, seg,
                                             window, sinks)
    ref, pairs = _flash_f32(qs, k, v, do, True, seg, 1.0, window=window,
                            sinks=sinks)
    qp, kp, vp = _leaf(qs, k, v)
    op = K.splash_attention_reference(qp, kp, vp, window=window,
                                      sinks=sinks, segment_ids=seg,
                                      sm_scale=1.0)
    gp = torch.autograd.grad(op, (qp, kp, vp), do, retain_graph=True)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    # bf16: as K2 (_flash_case): the kernel rounds p before p.v, dS before
    # its products, reads o in bf16 and rounds its outputs, each at most
    # 2^-8 of a value, so 2^-7 (|ref32| + |terms|).  f32: other summation
    # orders over up to S terms, 2^-14 of the same.  Against the plain
    # version, its measured distance from ref32 on top.
    unit = 2 ** -7 if bf16 else 2 ** -14
    errs = {}
    tag = (f"splash {label} {'bf16' if bf16 else 'f32'}")
    for name, got, plain in (("out", o, op), ("dq", dq, gp[0]),
                             ("dk", dk, gp[1]), ("dv", dv, gp[2])):
        r32 = ref[name]
        allowed = unit * (r32.abs() + ref[name + "_t"]) + 1e-6
        rule = f"2^{-7 if bf16 else -14} (|ref32| + |terms|) + 1e-6"
        _check(f"{tag} {name} vs f32", got, r32, allowed, rule)
        errs[name] = _check(f"{tag} {name} vs plain", got, plain,
                            (plain.float() - r32).abs() + allowed,
                            "|plain - ref32| + the above")
    del ref
    if window >= s:
        # Nothing but causality is masked: K2's causal kernels, bit for bit.
        o2, lse2 = K.flash_attention_forward(qs, k, v, seg, True, 1.0)
        g2 = K.flash_attention_backward(qs, k, v, o2, lse2, do, seg, True,
                                        1.0)
        same = all(torch.equal(a, c) for a, c in
                   zip((o, lse, dq, dk, dv), (o2, lse2, *g2)))
        log(f"  {tag}: window {window} >= S {s}, equal to K2 causal bit for "
            f"bit: {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{tag}: differs from K2's causal output")
    row = dict(case=label, dtype=str(dtype)[6:], shape=dict(
        b=b, h=h, kvh=kvh, s=s, d=d, window=window, sinks=sinks,
        packed=packed), pairs=pairs, max_abs_err=errs["out"],
        max_abs_err_bwd=max(errs["dq"], errs["dk"], errs["dv"]))
    if not timed:
        return row
    elem = q.element_size()
    in_bytes = (q.numel() + k.numel() + v.numel()) * elem
    fwd_bytes = in_bytes + o.numel() * elem + lse.numel() * 4
    bwd_bytes = (in_bytes + 2 * o.numel() * elem + lse.numel() * 4
                 + (dq.numel() + dk.numel() + dv.numel()) * elem)
    rep = h // kvh
    kr, vr = (t.repeat_interleave(rep, 1) for t in (k, v))
    mask = K.splash_mask(s, window, sinks, "cuda")
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              scale=1.0)

    def chunked(qq, kk, vv):
        return TA.local_attention_chunked(qq, kk, vv, window=window,
                                          segment_ids=seg, sinks=sinks,
                                          softmax_scale=1.0)

    fb = product_bound(fwd_bytes, 4 * d * pairs, not bf16,
                       ATTENTION_SPLIT_PRODUCTS)[0]
    bb = product_bound(bwd_bytes, 10 * d * pairs, not bf16,
                       ATTENTION_SPLIT_PRODUCTS)[0]
    row.update(
        ms=device_ms(lambda: K.splash_attention_forward(
            qs, k, v, seg, window, sinks), launches=10),
        plain_ms=device_ms(lambda: K.splash_attention_reference(
            qs, k, v, window=window, sinks=sinks, segment_ids=seg,
            sm_scale=1.0), launches=3),
        bound_ms=fb[0], bound_by=fb[1],
        library_ms=device_ms(lambda: sdpa(qs, kr, vr), launches=10),
        bwd_ms=device_ms(lambda: K.splash_attention_backward(
            qs, k, v, o, lse, do, seg, window, sinks), launches=10),
        plain_bwd_ms=_backward_ms(op, (qp, kp, vp), do, launches=3),
        bwd_bound_ms=bb[0], bwd_bound_by=bb[1])
    del op, gp
    ql, kl, vl = _leaf(qs, kr, vr)
    row["library_bwd_ms"] = _backward_ms(sdpa(ql, kl, vl), (ql, kl, vl), do,
                                         launches=10)
    if s % window == 0:
        row["chunked_ms"] = device_ms(lambda: chunked(qs, kr, vr),
                                      launches=3)
        ql, kl, vl = _leaf(qs, kr, vr)
        row["chunked_bwd_ms"] = _backward_ms(chunked(ql, kl, vl),
                                             (ql, kl, vl), do, launches=3)
    del ql, kl, vl
    torch.cuda.empty_cache()
    row["flex_ms"], row["flex_bwd_ms"] = (
        _flex_ms(qs, kr, vr, window, sinks, do) if seg is None and flex
        else (None, None))
    shape = (f"B {b} H {h} KVH {kvh} S {s} D {d} window {window} sinks "
             f"{sinks}{' packed' if packed else ''} {row['dtype']}")

    def us(x):
        return "not run" if x is None else f"{x * 1e3:.1f} us"

    row["body"] = K.flash_attention_body(dtype, d)
    log(f"  splash_attention {shape}: kernel {us(row['ms'])} "
        f"({row['body']} body, {4 * d * pairs / row['ms'] / 1e9:.1f} "
        f"TFLOP/s), bound "
        f"{us(fb[0])} ({fb[1]}), plain {us(row['plain_ms'])}, chunked "
        f"{us(row.get('chunked_ms'))}, SDPA (mask) {us(row['library_ms'])}"
        f", flex {us(row['flex_ms'])}")
    log(f"  splash_attention_bwd {shape}: kernel {us(row['bwd_ms'])} "
        f"({row['body']} body, {10 * d * pairs / row['bwd_ms'] / 1e9:.1f} "
        f"TFLOP/s), bound "
        f"{us(bb[0])} ({bb[1]}), plain {us(row['plain_bwd_ms'])}, chunked "
        f"{us(row.get('chunked_bwd_ms'))}, SDPA (mask) "
        f"{us(row['library_bwd_ms'])}, flex {us(row['flex_bwd_ms'])}")
    log(f"  splash {label}: {pairs} visible (query, key) pairs")
    return row


def phase_window_kernels() -> tuple:
    """K7 against its plain version: Mistral-7B's attention (the JSON
    line's shape), packed rows with sinks, and the edge cases at small
    sizes in f32 and bf16.  Returns (rows of the kernels' JSON line, every
    case's record)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf, f32 = torch.bfloat16, torch.float32
    main = _splash_case(gen, "mistral_7b head", 1, 32, 8, 8192, 128, 4096, 0,
                        packed=False, dtype=bf, timed=True)
    torch.cuda.empty_cache()
    cases = [main, _splash_case(gen, "packed sinks", 2, 16, 4, 4096, 128,
                                1024, 4, packed=True, dtype=bf, timed=True)]
    torch.cuda.empty_cache()
    # window 1 (the diagonal), windows off the tile (100, 4095, and 129
    # and 4096 at S 4224, which cut the wgmma body's 128-row kv tiles),
    # sinks = window, sinks past one tile, window >= S (K2's causal
    # output), packed rows whose boundaries fall inside the band, GQA 4:1
    # and 1:1, head_dim 64/128.
    for dtype in (bf, f32):
        for args, kw in (
                (("window 1", 1, 4, 1, 1024, 64, 1, 0), {}),
                (("window 100", 2, 4, 4, 512, 128, 100, 0), dict(
                    packed=True)),
                (("window 4095", 1, 2, 2, 4096, 64, 4095, 0), {}),
                (("window 129", 1, 4, 2, 512, 128, 129, 0), {}),
                (("window 4096 S 4224", 1, 4, 1, 4224, 64, 4096, 0), {}),
                (("sinks 130", 2, 4, 2, 1024, 64, 300, 130), dict(
                    packed=True)),
                (("sinks = window", 1, 8, 2, 1024, 128, 200, 200), {}),
                (("window >= S", 2, 4, 2, 512, 64, 600, 0), dict(
                    packed=True))):
            cases.append(_splash_case(gen, *args, dtype=dtype,
                                      packed=kw.get("packed", False)))
        torch.cuda.empty_cache()
    fwd = {f: main[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}
    bwd = dict(max_abs_err=main["max_abs_err_bwd"], ms=main["bwd_ms"],
               plain_ms=main["plain_bwd_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"],
               library_ms=main["library_bwd_ms"])
    return {"splash_attention": fwd, "splash_attention_bwd": bwd}, cases


# -- phases 10 and 10b --------------------------------------------------------


def window_launches_per_step(num_layers: int) -> dict:
    """Kernel launches of one windowed training step under full remat: the
    decoder's, with the splash kernel in the flash kernel's place."""
    out = train_launches_per_step(num_layers)
    out["splash_attention"] = out.pop("flash_attention")
    out["splash_attention_bwd"] = out.pop("flash_attention_bwd")
    return out


def phase_window_train(steps: int = 10, log_every: int = 2,
                       num_layers: int = 4) -> tuple:
    """The trainer on mistral_7b_lm at full width, cut to ``num_layers``
    layers, through the CLI's own construction (``train.make_trainer``):
    b 8 x s 8192, window 4096, bf16 compute over f32 params, adamw + clip
    1.0 + warmup_cosine, random weights from seed 0.  Counts are zeroed
    just before ``fit`` and read just after.

    The loss that must fall is the first batch's: its step-1 loss (the
    initial weights) against its loss under the trained weights.  The
    step losses themselves move with the batch (SyntheticLM rows repeat
    with periods from 4 to 8192 tokens), by more than ten steps move
    them.  A batch the run does not see is read before and after, and
    reported."""
    import math

    import torch
    from tensorflow_train_distributed_torch import train as T
    from tensorflow_train_distributed_torch.data.pipeline import to_device
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.ops import kernels as K

    name = "mistral_7b_lm"
    args = T.build_parser().parse_args(
        ["--config", name, "--steps", str(steps), "--seed", str(SEED),
         "--log-every", str(log_every), "--log-grad-norm", "--device",
         "cuda"])
    entry = registry.get_entry(name)
    cfg = dataclasses.replace(entry["config"], num_layers=num_layers)
    entry = dict(entry, config=cfg)
    drains = _drain_stamps(log_every)
    base = torch.cuda.memory_allocated()
    task, trainer, batches = T.make_trainer(args, entry, callbacks=[drains])
    state = trainer.create_state()
    order = iter(batches)
    first = next(order)
    for _ in range(steps - 1):
        next(order)
    unseen = next(order)

    def batch_loss(host):
        with torch.no_grad():
            loss, _ = task.loss_fn(trainer.policy.cast_to_compute(
                to_device(host, "cuda")))
        return loss.item()

    unseen_before = batch_loss(unseen)
    torch.cuda.synchronize()
    stamps = drains.times

    kernels = list(window_launches_per_step(num_layers))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = trainer.fit(batches, steps=steps, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts()[k] for k in kernels}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in kernels and v}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in history]
    for step, m in history:
        log(f"  step {step}: loss {m['loss']:.4f} accuracy "
            f"{m['accuracy']:.4f} lr {m['lr']:.3e} grad_norm "
            f"{m['grad_norm']:.3f}")
    first_after, unseen_after = batch_loss(first), batch_loss(unseen)
    log(f"  first batch: loss {losses[0]:.4f} at step 1, {first_after:.4f}"
        f" trained; a batch the run did not see: {unseen_before:.4f} -> "
        f"{unseen_after:.4f}")
    if not all(math.isfinite(x) for x in losses + [first_after]):
        raise AssertionError(f"non-finite loss: {losses}, {first_after}")
    if not first_after < losses[0]:
        raise AssertionError(f"the first batch's loss did not fall: "
                             f"{losses[0]} -> {first_after}")
    want = {k: steps * v for k, v in
            window_launches_per_step(num_layers).items()}
    log(f"  launches {counts} (expected {want}); others {others}")
    if counts != want or others:
        raise AssertionError(f"windowed training launches {counts}, others "
                             f"{others}; expected {want} and no flash "
                             f"attention")
    windows = [(b - a) / log_every for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(windows) if windows else wall / steps
    b, s = entry["global_batch_size"], entry["dataset_kwargs"]["seq_len"]
    w = cfg.sliding_window
    tokens = b * s
    n_params = state.num_params()
    keys = sum(min(i + 1, w) for i in range(s)) / s    # mean visible keys
    per_token, formula = decoder_flops_per_token(n_params, cfg, s)
    flops = per_token * tokens
    stats = dict(
        config=name, num_layers=num_layers, steps=steps, batch=b, seq=s,
        window=w, params=n_params, step_ms=step_s * 1e3,
        window_ms_per_step=[x * 1e3 for x in windows],
        tokens_per_s=tokens / step_s, peak_mem_gib=peak / 2 ** 30,
        base_mem_gib=base / 2 ** 30, wall_s=wall, losses=losses,
        first_batch_trained_loss=first_after,
        unseen_batch_loss=[unseen_before, unseen_after],
        mean_visible_keys=keys,
        mfu=flops / step_s / PEAK_BF16_FLOPS,
        mfu_formula=formula)
    stats["profile"] = _profile_train_step(trainer, state, batches)
    log(f"  windowed training: {json.dumps(stats)}")
    return counts, stats


def phase_window_grad_check() -> dict:
    """(a) The phase-10 model cut to 2 layers, at b 1 x s 8192 (the plain
    version's [B, 32, 8192, 8192] f32 scores take 8.6 GB a batch row).
    f32: other summation orders; bf16: the kernels round p, dS and the
    norms' outputs at other places than the plain versions."""
    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    cfg = dataclasses.replace(LLAMA_PRESETS["mistral_7b"], num_layers=2)
    src = SyntheticLM(num_examples=8, seq_len=8192,
                      vocab_size=cfg.vocab_size)
    host = next(iter(HostBatches(src, 1, seed=SEED)))
    return _grad_check(
        "mistral_7b[2 layers]",
        lambda dtype: CausalLmTask(dataclasses.replace(cfg, dtype=dtype),
                                   device="meta"), host,
        (("float32", torch.float32, 1e-4),
         ("bfloat16", torch.bfloat16, 3e-2)))


def phase_window_card_vs_cpu(steps: int = 5) -> dict:
    """(b) A small windowed decoder: d 256, 4 heads / 2 kv, head_dim 64,
    ffn 512, vocab 256, 2 layers, seq 512, window 128, 4 sinks, full
    remat, f32.  The card runs K7; the CPU runs local_attention_chunked."""
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask)

    cfg = dataclasses.replace(
        LLAMA_PRESETS["llama_tiny"], d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, ffn_size=512, num_layers=2,
        sliding_window=128, attention_sinks=4, remat=True)
    return _card_vs_cpu("windowed decoder[w 128, 4 sinks]",
                        lambda: CausalLmTask(cfg, device="meta"), cfg,
                        list(window_launches_per_step(2)), seq=512,
                        vocab=256, steps=steps)


# -- phase 11 -----------------------------------------------------------------


LAUNCH_DIR = "_launch_smoke"      # git-ignored; deleted at the phase's end
LAUNCH_FLAGS = ["--config", "llama_125m_lm", "--steps", "12",
                "--checkpoint-every", "4", "--max-to-keep", "2",
                "--eval-split", "0.001", "--eval-steps", "4",
                "--eval-every", "6", "--log-every", "2", "--seed",
                str(SEED)]
CHAOS_PLAN = "ckpt:save:partial:step=8:attempt=0;step:10:kill9:attempt=0"
# Run (e): phase 6's flags (``phase_train``'s defaults), no checkpoint and
# no evaluation, so its step time compares with phase 6's.
PHASE6_FLAGS = ["--config", "llama_125m_lm", "--steps", "20", "--seed",
                str(SEED), "--log-every", "5", "--log-grad-norm"]


def eval_launches_per_batch(num_layers: int) -> dict:
    """Kernel launches of one evaluation batch: the forward alone."""
    return {"flash_attention": num_layers, "rms_norm": 2 * num_layers + 1,
            "cross_entropy": 1}


def _launcher(label, *flags, env=None, timeout=600):
    """One launcher process; (returncode, stdout JSON lines, stderr, the
    ``launch summary`` of its log or None, wall seconds)."""
    import os

    e = dict(os.environ)
    e.pop("TTD_FAULT_PLAN", None)
    e.pop("TTD_SUPERVISE_ATTEMPT", None)
    e.update(env or {})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch",
         *flags], env=e, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    summary = None
    for x in proc.stderr.splitlines():
        if "launch summary: " in x:
            summary = json.loads(x.split("launch summary: ", 1)[1])
    log(f"  ({label}) exit {proc.returncode} in {wall:.1f} s")
    return proc.returncode, lines, proc.stderr, summary, wall


# Torch's process-wide backend switches as a fresh process has them
# (``main`` records them before it turns TF32 off for the kernel checks).
_FRESH_FLAGS: dict = {}


def _backend_flags() -> dict:
    import torch

    b = torch.backends
    return dict(matmul_tf32=b.cuda.matmul.allow_tf32,
                cudnn_tf32=b.cudnn.allow_tf32,
                deterministic=b.cudnn.deterministic,
                benchmark=b.cudnn.benchmark)


def _set_backend_flags(f: dict) -> None:
    import torch

    b = torch.backends
    b.cuda.matmul.allow_tf32 = f["matmul_tf32"]
    b.cudnn.allow_tf32 = f["cudnn_tf32"]
    b.cudnn.deterministic = f["deterministic"]
    b.cudnn.benchmark = f["benchmark"]


@contextlib.contextmanager
def _fresh_process_flags():
    """The backend switches of a fresh process for the block, this
    script's after it (the launcher also pins cuDNN's)."""
    old = _backend_flags()
    _set_backend_flags(_FRESH_FLAGS or old)
    try:
        yield
    finally:
        _set_backend_flags(old)


def _in_process(label, *flags):
    """``_launcher``'s (0, stdout JSON lines, log, summary, wall) of
    ``launch.run`` called in this process, which saves the ~9 s a
    launcher process spends importing torch on the card's machine: under
    a fresh process's backend switches, its stdout and its package's log
    captured, the kernel counts and the peak memory from 0.  A failure
    raises."""
    import io
    import logging

    import torch
    from tensorflow_train_distributed_torch import launch
    from tensorflow_train_distributed_torch.ops import kernels as K

    out, text = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(text)
    handler.setFormatter(logging.Formatter(
        "%(name)s %(levelname)s %(message)s"))
    pkg = logging.getLogger("tensorflow_train_distributed_torch")
    level = pkg.level
    pkg.addHandler(handler)
    pkg.setLevel(logging.INFO)
    _free()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with _fresh_process_flags(), contextlib.redirect_stdout(out):
            res = launch.run(launch.build_parser().parse_args(list(flags)))
        summary = res.summary
        del res
    finally:
        pkg.removeHandler(handler)
        pkg.setLevel(level)
        _free()
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    log(f"  ({label}) in process in {wall:.1f} s")
    return 0, lines, text.getvalue(), summary, wall


def _journal(path: str) -> list:
    """The supervisor journal's events as (event, class, rc)."""
    with open(path) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    return [(r["event"], r.get("class"), r.get("rc")) for r in recs]


def _last_attempt(lines: list) -> list:
    """The JSON lines of a supervised command's last attempt: its stdout
    carries every attempt's, and a relaunch's steps restart below the
    killed attempt's last."""
    start = 0
    for i in range(1, len(lines)):
        if lines[i]["step"] < lines[i - 1]["step"]:
            start = i
    return lines[start:]


def _file_digest(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _tensorboard_check(tb_dir: str, lines: list) -> dict:
    """The TensorBoard scalars of run (a), read back with the port's
    reader: a loss at every step 1..12, equal to each logged loss, and
    the evaluations' ``val_loss`` (rounded to f32) at theirs."""
    from tensorflow_train_distributed_torch.training.callbacks import (
        read_scalars,
    )

    import numpy as np

    scalars = read_scalars(tb_dir)
    loss = dict(scalars.get("loss", []))
    if sorted(loss) != list(range(1, 13)):
        raise AssertionError(f"TensorBoard loss steps {sorted(loss)}")
    # Event files hold f32; evaluations average in f64.
    logged = [(x["step"], x["loss"]) for x in lines if "loss" in x]
    val = [(x["step"], float(np.float32(x["val_loss"]))) for x in lines
           if "val_loss" in x]
    if ([(st, loss[st]) for st, _ in logged] != logged
            or scalars.get("val_loss") != val):
        raise AssertionError(f"TensorBoard scalars {scalars} differ from "
                             f"the logged {logged}, {val}")
    log(f"  TensorBoard: {len(loss)} losses, {len(val)} evaluations, "
        f"equal to the logged ones; tags {sorted(scalars)}")
    return dict(tags=sorted(scalars), losses=len(loss), equal=True)


def _profile_check(prof_dir: str) -> dict:
    """The ``--profile-dir`` trace must hold the port's kernels."""
    import os

    files = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"--profile-dir holds {files}")
    with open(os.path.join(prof_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events
             if e.get("cat") == "kernel"}
    found = {k: sum(k in n.lower() for n in names)
             for k in ("rms_norm", "flash", "ce_fwd", "ce_bwd")}
    log(f"  profile trace {files[0]}: {len(events)} events, "
        f"{len(names)} kernel names; port kernels {found}")
    if not all(found.values()):
        raise AssertionError(f"the trace lacks a port kernel: {found}")
    return dict(events=len(events), kernel_names=len(names),
                port_kernels=found)


def phase_launcher() -> tuple:
    """Phase 11 (the module docstring): the launcher's runs on
    llama_125m_lm; returns (run (a)'s kernel launches, run (k)'s, the
    stats)."""
    import os
    import shutil

    from tensorflow_train_distributed_torch.models import registry

    cfg = registry.get_entry("llama_125m_lm")["config"]
    root = os.path.abspath(LAUNCH_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    a_dir, b_dir, k_dir = (os.path.join(root, x) for x in "abk")
    try:
        ra, la, ea, sa, wa = _in_process(
            "a: uninterrupted", *LAUNCH_FLAGS, "--checkpoint-dir", a_dir,
            "--jsonl-log", os.path.join(root, "a.jsonl"),
            "--tensorboard-dir", os.path.join(root, "tb"))
        tensorboard = _tensorboard_check(os.path.join(root, "tb"), la)
        rb, lb, eb, sc, wb = _launcher(
            "b+c: --supervise, torn save at 8, kill -9 at 10",
            *LAUNCH_FLAGS, "--checkpoint-dir", b_dir, "--fault-plan",
            CHAOS_PLAN, "--supervise", "--restart-backoff", "0")
        if rb != 0 or sc is None:
            raise AssertionError(f"supervised run failed:\n{eb[-4000:]}")
        journal = _journal(os.path.join(b_dir, "supervisor.jsonl"))
        if journal != [("exit", "crash", -9), ("exit", "clean", 0),
                       ("done", None, None)]:
            raise AssertionError(f"supervisor journal {journal}")
        for want in ("restored checkpoint step 4",
                     "data stream resumed at epoch 0, batch 4"):
            if want not in eb:
                raise AssertionError(f"the relaunch did not log {want!r}")
        if not os.path.isdir(os.path.join(b_dir, "corrupt", "8")):
            raise AssertionError("the relaunch did not quarantine step 8")
        digests = {}
        for name in ("tensors.bin", "manifest.json"):
            da = _file_digest(os.path.join(a_dir, "12", name))
            if _file_digest(os.path.join(b_dir, "12", name)) != da:
                raise AssertionError(f"resumed step-12 {name} differs "
                                     f"from the uninterrupted run's")
            digests[name] = da
        lc = _last_attempt(lb)
        val_a = [x for x in la if "val_loss" in x]
        val_c = [x for x in lc if "val_loss" in x]
        if [x["step"] for x in val_a] != [6, 12] or val_c != val_a:
            raise AssertionError(f"evaluations differ: {val_a} vs {val_c}")
        if la[-1].get("eval") != lc[-1].get("eval"):
            raise AssertionError(f"final evaluations differ: {la[-1]} vs "
                                 f"{lc[-1]}")
        log(f"  journal {journal}; the relaunch's step-12 checkpoint and "
            f"evaluations equal (a)'s")
        rd, ld, ed, sd, wd = _in_process(
            "d: --eval-only on (a)", *LAUNCH_FLAGS, "--checkpoint-dir",
            a_dir, "--eval-only")
        if ld != [{"step": 12, "eval": la[-1]["eval"]}]:
            raise AssertionError(f"eval-only gave {ld}, (a) {la[-1]}")
        prof_dir = os.path.join(root, "prof")
        every = LAUNCH_FLAGS.index("--checkpoint-every") + 1
        fused_flags = [*LAUNCH_FLAGS[:every], "6", *LAUNCH_FLAGS[every + 1:]]
        rk, lk, ek, sk, wk = _in_process(
            "k: --steps-per-execution 4, --profile-dir", *fused_flags,
            "--checkpoint-dir", k_dir, "--steps-per-execution", "4",
            "--profile-dir", prof_dir, "--profile-steps", "4,8")
        if sorted(os.listdir(k_dir)) != ["12", "8"]:
            raise AssertionError(f"fused run's checkpoints "
                                 f"{os.listdir(k_dir)}, not 8 and 12")
        for name, da in digests.items():
            if _file_digest(os.path.join(k_dir, "12", name)) != da:
                raise AssertionError(f"the fused run's step-12 {name} "
                                     f"differs from (a)'s")
        if [x["step"] for x in lk if "loss" in x] != [4, 8, 12]:
            raise AssertionError(f"fused run's logged steps {lk}")
        log("  the fused run's step-12 checkpoint equals (a)'s bit for bit")
        profile = _profile_check(prof_dir)
        re_, le, ee, se, we = _in_process("e: phase 6's flags",
                                          *PHASE6_FLAGS)
        if se["step"] != 20:
            raise AssertionError(f"launcher (e) ended at {se['step']}")
        losses = [x["loss"] for x in la if "loss" in x]
        losses_e = [x["loss"] for x in le if "loss" in x]
        if not all(math.isfinite(x) for x in losses + losses_e):
            raise AssertionError(f"non-finite launcher loss: {losses}, "
                                 f"{losses_e}")
        want = {k: 12 * v for k, v in
                train_launches_per_step(cfg.num_layers).items()}
        for k, v in eval_launches_per_batch(cfg.num_layers).items():
            want[k] += 3 * 4 * v           # 3 evaluations of 4 batches
        counts = _expect_launches("launcher (a)", sa, want)
        fused_counts = _expect_launches("launcher (k)", sk, want)
        stats = dict(
            card=smi_line(), config="llama_125m_lm", steps=12,
            step_ms=sa["step_ms"],
            window_ms_per_step=sa["window_ms_per_step"],
            resumed_step_ms=sc["step_ms"], eval_s=sa["eval_s"],
            save_s=sa["save_s"] + sc["save_s"],
            save_bytes=sa["save_bytes"], restore=sc["restore"],
            eval_only_restore=sd["restore"], eval_only_eval_s=sd["eval_s"],
            phase6_flags_step_ms=se["step_ms"],
            phase6_flags_window_ms_per_step=se["window_ms_per_step"],
            fused=dict(steps_per_execution=4, step_ms=sk["step_ms"],
                       window_ms_per_step=sk["window_ms_per_step"],
                       save_s=sk["save_s"], step12="bitwise (a)'s",
                       profile=profile),
            supervisor_journal=journal, tensorboard=tensorboard,
            wall_s=dict(a=wa, bc=wb, d=wd, k=wk, e=we), val=val_a,
            eval=la[-1]["eval"], step12_sha256=digests, losses=losses)
        log(f"  launcher: {json.dumps(stats)}")
        # Run (a)'s checkpoints serve phase 21's sample.py and phase 24's
        # HF export, which deletes them.
        keep = os.path.abspath(SAMPLE_DIR)
        shutil.rmtree(keep, ignore_errors=True)
        os.makedirs(keep)
        shutil.move(a_dir, os.path.join(keep, "a"))
        return counts, fused_counts, stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 11, LoRA leg -------------------------------------------------------

LORA_FLAGS = ["--config", "llama_125m_lm", "--steps", "8", "--checkpoint-every",
              "4", "--max-to-keep", "2", "--lora-rank", "8", "--log-every",
              "2", "--seed", str(SEED)]
LORA_KILL = "step:6:kill9:attempt=0"
SERVE_FLAGS = ["--config", "llama_125m_lm", "--max-new", "16", "--slots",
               "4", "--cache-len", "256"]


def lora_launches_per_step(num_layers: int) -> dict:
    """``train_launches_per_step`` over a frozen base: the same, less the
    first block's attention-norm backward (its input, the frozen
    embedding's output, and its scale need no gradient)."""
    want = train_launches_per_step(num_layers)
    want["rms_norm_bwd"] -= 1
    return want


def _flax_flat(params: dict) -> dict:
    """The port's parameter names as the flat flax dict of an unrolled
    decoder (``layers.3.x`` → ``layer_3/x``), f32 numpy."""
    out = {}
    for name, v in params.items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        out["/".join(parts)] = v.float().numpy()
    return out


def _serve(label, *flags):
    """``serve.main`` in this process on the card, its stdout and stderr
    captured, the kernel counts from 0: (tokens per request, its
    summary)."""
    import io

    from tensorflow_train_distributed_torch import serve
    from tensorflow_train_distributed_torch.ops import kernels as K

    out, err = io.StringIO(), io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with (_fresh_process_flags(), contextlib.redirect_stdout(out),
              contextlib.redirect_stderr(err)):
            rc = serve.main([*SERVE_FLAGS, *flags])
    finally:
        _free()
    if rc != 0:
        raise AssertionError(f"serve ({label}) exited {rc}:\n"
                             f"{err.getvalue()[-4000:]}")
    summary = json.loads(err.getvalue().split("serve summary: ", 1)[1]
                         .splitlines()[0])
    tokens = [json.loads(x)["tokens"] for x in out.getvalue().splitlines()]
    log(f"  (serve {label}) {len(tokens)} requests in "
        f"{time.perf_counter() - t0:.1f} s; launches {summary['launches']}")
    return tokens, summary


def phase_launcher_lora() -> tuple:
    """Phase 11's LoRA leg: llama_125m_lm with rank-8 adapters on query
    and value through the launcher, (f) 8 steps with a save every 4 (in
    this process), (g+h) the same under ``--supervise`` killed at step 6,
    whose relaunch's step-8 checkpoint must equal (f)'s bit for bit;
    then ``serve
    --checkpoint-dir`` on (f)'s directory answers 4 greedy requests on the
    card, and its tokens must equal ``serve --params-npz`` of an npz of
    ``merge_lora(params)`` this script writes.  Returns (run (f)'s kernel
    launches, the stats)."""
    import os
    import shutil

    import numpy as np
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.models.lora import (
        LoraSpec,
        load_spec,
        merge_lora,
    )
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    cfg = registry.get_entry("llama_125m_lm")["config"]
    root = os.path.abspath(os.path.join(LAUNCH_DIR, "lora"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    f_dir, g_dir = os.path.join(root, "f"), os.path.join(root, "g")
    try:
        rf = _in_process("f: LoRA, uninterrupted", *LORA_FLAGS,
                         "--checkpoint-dir", f_dir)
        rh = _launcher("g+h: LoRA, --supervise, kill -9 at 6", *LORA_FLAGS,
                       "--checkpoint-dir", g_dir, "--fault-plan", LORA_KILL,
                       "--supervise", "--restart-backoff", "0")
        journal = _journal(os.path.join(g_dir, "supervisor.jsonl"))
        if (rh[0] != 0 or "restored checkpoint step 4" not in rh[2]
                or journal != [("exit", "crash", -9), ("exit", "clean", 0),
                               ("done", None, None)]):
            raise AssertionError(f"LoRA supervised run failed ({journal})"
                                 f":\n{rh[2][-4000:]}")
        _same_checkpoint("LoRA", f_dir, g_dir, 8)
        if load_spec(f_dir) != LoraSpec(rank=8):
            raise AssertionError(f"lora_spec.json: {load_spec(f_dir)}")
        summary = rf[3]
        counts = _expect_launches("LoRA", summary, {
            k: 8 * v for k, v in
            lora_launches_per_step(cfg.num_layers).items()})
        losses = _losses("LoRA", rf[1])
        params = CheckpointManager(f_dir).restore_params()
        npz = os.path.join(root, "merged.npz")
        np.savez(npz, **_flax_flat(merge_lora(params, LoraSpec(rank=8))))
        rng = np.random.default_rng(SEED + 11)
        prompts = []
        for n in (5, 17, 40, 90):
            prompts += ["--prompt", ",".join(
                str(int(t)) for t in rng.integers(1, cfg.vocab_size, n))]
        got, serve_summary = _serve("--checkpoint-dir", "--checkpoint-dir",
                                    f_dir, *prompts)
        want, _ = _serve("--params-npz of merge_lora", "--params-npz", npz,
                         *prompts)
        if got != want or len(got) != 4:
            raise AssertionError(f"served tokens differ: {got} vs {want}")
        for k in ("paged_attention", "rms_norm"):
            if not serve_summary["launches"].get(k):
                raise AssertionError(f"serving ran no {k}: "
                                     f"{serve_summary['launches']}")
        log("  the merged checkpoint's greedy tokens equal the npz's")
        stats = dict(
            card=smi_line(), config="llama_125m_lm", lora_rank=8,
            steps=8, step_ms=summary["step_ms"],
            resumed_step_ms=rh[3]["step_ms"], params=summary["params"],
            lora_params=summary["lora_params"],
            peak_mem_gib=summary["peak_mem_bytes"] / 2 ** 30,
            save_bytes=summary["save_bytes"], save_s=summary["save_s"],
            restore=rh[3]["restore"], losses=losses, resume="bitwise",
            supervisor_journal=journal, wall_s=dict(f=rf[4], gh=rh[4]),
            serve=dict(requests=4, tokens_equal=True,
                       launches=serve_summary["launches"],
                       decode_s=serve_summary["decode_s"],
                       prefill_s=serve_summary["prefill_s"]))
        log(f"  LoRA launcher: {json.dumps(stats)}")
        return counts, stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phases 12-17: the other model families -----------------------------------

FAMILY_DIR = "_family_smoke"      # git-ignored; deleted at the phases' end
# The kill-and-resume runs (phases 13 and 15): 12 steps, a save every 6,
# killed at 9 (cut from 20, 10 and 15 to leave phase 24 room in the
# script's time limit).
KILL_STEP, SAVE_EVERY, KILLED_STEPS = 9, 6, 12
KILL_AT = f"step:{KILL_STEP}:kill9:attempt=0"
BERT_FLAGS = ["--config", "bert_base_mlm", "--steps", str(KILLED_STEPS),
              "--precision", "mixed_bfloat16", "--checkpoint-every",
              str(SAVE_EVERY), "--max-to-keep",
              "2", "--eval-split", "0.011", "--eval-steps", "4",
              "--log-every", "5", "--seed", str(SEED)]
# Registry batch 512 cut to 64 for one card; seq 256 so that attention
# meets K2's gate; the noam multiplier and warm-up set so 20 steps train
# (the registry's warm-up 0 starts Adam at 0.0625).
WMT_FLAGS = ["--config", "transformer_big_wmt", "--dataset-kwarg",
             "seq_len=256", "--global-batch-size", "64", "--steps", "20",
             "--learning-rate", "0.2", "--warmup-steps", "20",
             "--log-every", "5", "--seed", str(SEED)]
WMT_BLEU_FLAGS = ["--eval-only", "--eval-steps", "1", "--bleu-eval", "1",
                  "--beam-size", "4", "--global-batch-size", "8"]
# Registry batch 1024 cut to 256 for one card; SGD with Nesterov
# momentum, which the registry's lr 0.4 is for (the launcher's default
# adamw at 0.4 diverges).
RESNET_FLAGS = ["--config", "resnet50_imagenet", "--global-batch-size",
                "256", "--optimizer", "momentum", "--steps",
                str(KILLED_STEPS), "--checkpoint-every", str(SAVE_EVERY),
                "--max-to-keep", "2",
                "--log-every", "5", "--seed", str(SEED)]
def bert_launches(num_layers: int, steps: int, eval_batches: int) -> dict:
    """K2 and K3 launches of ``steps`` BERT training steps and
    ``eval_batches`` evaluation batches: one full-attention forward a
    layer (and its backward in training), one fused loss."""
    n = num_layers
    return {"flash_attention": n * (steps + eval_batches),
            "flash_attention_bwd": n * steps,
            "cross_entropy": steps + eval_batches,
            "cross_entropy_bwd": steps}


def wmt_launches(cfg, steps: int, eval_batches: int = 0,
                 bleu_batches: int = 0, max_len: int = 0) -> dict:
    """K2 launches of the Transformer: a forward is the encoder's
    full self-attention, the decoder's causal self-attention and its
    cross-attention, each layer; beam decoding runs the encoder once a
    batch and the decoder at each of ``max_len`` positions.  The
    label-smoothed loss takes no K3."""
    e, d = cfg.num_encoder_layers, cfg.num_decoder_layers
    fwd = e + 2 * d
    return {"flash_attention": fwd * (steps + eval_batches)
            + bleu_batches * (e + 2 * d * max_len),
            "flash_attention_bwd": fwd * steps}


def _expect_launches(label, summary, want) -> dict:
    got = {k: summary["launches"].get(k, 0) for k in want}
    others = {k: v for k, v in summary["launches"].items() if k not in want}
    log(f"  {label} launches {got} (expected {want}); others {others}")
    if got != want or others:
        raise AssertionError(f"{label}: launches {got}, others {others}; "
                             f"expected {want}")
    return got


def _same_checkpoint(label, a_dir, c_dir, step) -> None:
    """The rerun's step checkpoint must equal the uninterrupted run's,
    bit for bit."""
    import os

    for f in ("tensors.bin", "manifest.json"):
        if (_file_digest(os.path.join(a_dir, str(step), f))
                != _file_digest(os.path.join(c_dir, str(step), f))):
            raise AssertionError(f"{label}: the resumed step-{step} {f} "
                                 f"differs from the uninterrupted run's")
    log(f"  {label}: the resumed step-{step} checkpoint equals the "
        f"uninterrupted run's bit for bit")


def _kill_and_resume(label, flags, root) -> tuple:
    """(a) the run (in this process), (b) the same killed at step
    ``KILL_STEP`` after the step-``SAVE_EVERY`` save, (c) its rerun as
    supervisor attempt 1, which must restore that step; returns ((a),
    (c)) as ``_launcher`` results and the two directories."""
    import os

    a_dir, b_dir = os.path.join(root, "a"), os.path.join(root, "b")
    ra = _in_process(f"{label} a: uninterrupted", *flags,
                     "--checkpoint-dir", a_dir)
    rb = _launcher(f"{label} b: kill -9 at step {KILL_STEP}", *flags,
                   "--checkpoint-dir", b_dir, "--fault-plan", KILL_AT)
    if rb[0] != -9:
        raise AssertionError(f"{label} (b) exited {rb[0]}, not by SIGKILL:"
                             f"\n{rb[2][-4000:]}")
    rc = _launcher(f"{label} c: rerun as attempt 1", *flags,
                   "--checkpoint-dir", b_dir, "--fault-plan", KILL_AT,
                   env={"TTD_SUPERVISE_ATTEMPT": "1"})
    if rc[0] != 0 or rc[3] is None:
        raise AssertionError(f"{label} (c) failed:\n{rc[2][-4000:]}")
    if f"restored checkpoint step {SAVE_EVERY}" not in rc[2]:
        raise AssertionError(f"{label} (c) did not restore step "
                             f"{SAVE_EVERY}")
    return ra, rc, a_dir, b_dir


def _losses(label, lines) -> list:
    losses = [x["loss"] for x in lines if "loss" in x]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    return losses


def _run_stats(label, summary, batch, wall) -> dict:
    step_s = summary["step_ms"] / 1e3
    stats = dict(step_ms=summary["step_ms"],
                 window_ms_per_step=summary["window_ms_per_step"],
                 examples_per_s=batch / step_s,
                 peak_mem_gib=summary["peak_mem_bytes"] / 2 ** 30,
                 save_s=summary["save_s"], eval_s=summary["eval_s"],
                 wall_s=wall)
    log(f"  {label}: {stats['step_ms']:.1f} ms a step, "
        f"{stats['examples_per_s']:.1f} examples/s, peak "
        f"{stats['peak_mem_gib']:.2f} GiB")
    return stats


def phase_family_kernels() -> tuple:
    """Phase 12: K2 full attention at BERT-base's (B 256, H 12, S 128) and
    Transformer-big's (B 64, H 16, S 256) heads (D 64), f32 as both
    models compute (the split body, timed beside the FMA body on the same
    inputs) and bf16, and causal f32 at the Transformer's; K3f and K3b at
    BERT's logits [32768, 30522] f32, at an odd vocabulary and V 32,000
    (the same rows) and at LeNet's [128, 10].  Returns the "bert", "wmt"
    and "mnist" rows of the kernels' JSON line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    f32 = torch.float32
    bert = _flash_case(gen, "bert_base", 256, 12, 12, 128, 64,
                       packed=False, main=True, causal=False, dtype=f32)
    torch.cuda.empty_cache()
    _flash_case(gen, "bert_base bf16", 256, 12, 12, 128, 64, packed=False,
                main=False, causal=False)
    torch.cuda.empty_cache()
    wmt = _flash_case(gen, "transformer_big", 64, 16, 16, 256, 64,
                      packed=False, main=True, causal=False, dtype=f32)
    torch.cuda.empty_cache()
    _flash_case(gen, "transformer_big bf16", 64, 16, 16, 256, 64,
                packed=False, main=False, causal=False)
    _flash_case(gen, "transformer_big decoder", 64, 16, 16, 256, 64,
                packed=False, main=False, causal=True, dtype=f32)
    torch.cuda.empty_cache()
    bert.update(_cross_entropy_cases(gen, 32768, 30522))
    torch.cuda.empty_cache()
    # Beside BERT's V 30,522 (every other row 8 bytes off 16-byte
    # alignment): an odd V (rows at all four offsets) and V 32,000 (every
    # row aligned), at the same rows.
    for v in (30521, 32000):
        for name, row in _cross_entropy_cases(gen, 32768, v).items():
            CASES.append(dict(row, kernel=name, case=f"[32768, {v}] f32"))
        torch.cuda.empty_cache()
    return bert, wmt, _cross_entropy_cases(gen, 128, 10)


def phase_bert() -> tuple:
    """Phase 13: bert_base_mlm through the launcher at full width and
    depth (b 256 x s 128, mixed_bfloat16, 12 steps, a save every 6,
    4 held-out evaluation batches), then killed at step 9 and rerun: the
    rerun's step-12 checkpoint must equal the uninterrupted run's bit for
    bit (dropout 0.1 is on, so this holds the (seed, step) generator)."""
    import os
    import shutil

    from tensorflow_train_distributed_torch.models import registry

    entry = registry.get_entry("bert_base_mlm")
    cfg = entry["config"]
    root = os.path.abspath(os.path.join(FAMILY_DIR, "bert"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        ra, rc, a_dir, b_dir = _kill_and_resume("bert", BERT_FLAGS, root)
        _same_checkpoint("bert", a_dir, b_dir, KILLED_STEPS)
        la, lc = ra[1], rc[1]
        if la[-1].get("eval") != lc[-1].get("eval"):
            raise AssertionError(f"bert evaluations differ: {la[-1]} vs "
                                 f"{lc[-1]}")
        losses = _losses("bert", la)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"bert loss did not fall: {losses}")
        counts = _expect_launches("bert", ra[3],
                                  bert_launches(cfg.num_layers,
                                                KILLED_STEPS, 4))
        b, s = entry["global_batch_size"], 128
        stats = _run_stats("bert_base_mlm", ra[3], b, ra[4])
        n_ne = non_embedding_params(cfg)
        flops = bert_flops_per_token(n_ne, cfg, s) * b * s
        step_s = stats["step_ms"] / 1e3
        stats.update(
            card=smi_line(), config="bert_base_mlm", batch=b, seq=s,
            non_embedding_params=n_ne, losses=losses, eval=la[-1]["eval"],
            resume="bitwise", resumed_step_ms=rc[3]["step_ms"],
            restore=rc[3]["restore"], save_bytes=ra[3]["save_bytes"],
            mfu=flops / step_s / PEAK_F32_SPLIT_FLOPS,
            mfu_fma=flops / step_s / PEAK_F32_FLOPS,
            mfu_formula="(6 N_non_embedding + 12 L S d) B S / step_s / "
                        "(989e12 / 3) (the config computes in f32: its "
                        "products as an exact three-way bf16 split; "
                        "mfu_fma at 67e12)")
        stats["device_fed"] = _device_fed(
            "bert_base_mlm", ["--precision", "mixed_bfloat16"],
            profile=True)
        log(f"  bert: {json.dumps(stats)}")
        return counts, stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_wmt() -> tuple:
    """Phase 14: transformer_big_wmt through the launcher at full width
    and depth (b 64 x s 256, bf16 policy over its f32 compute, 20 steps,
    a save at the end), then ``--eval-only`` beam search (beam 4, GNMT
    penalty) of one batch of 8 and its BLEU."""
    import os
    import shutil

    from tensorflow_train_distributed_torch.models import registry

    cfg = registry.get_entry("transformer_big_wmt")["config"]
    root = os.path.abspath(os.path.join(FAMILY_DIR, "wmt"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        ra = _in_process("wmt a: 20 steps", *WMT_FLAGS, "--checkpoint-dir",
                         root)
        counts = _expect_launches("wmt", ra[3], wmt_launches(cfg, 20))
        losses = _losses("wmt", ra[1])
        if not losses[-1] < losses[0]:
            raise AssertionError(f"wmt loss did not fall: {losses}")
        rb = _in_process("wmt b: --eval-only, beam 4 BLEU", *WMT_FLAGS,
                         *WMT_BLEU_FLAGS, "--checkpoint-dir", root)
        ev = rb[1][-1]["eval"]
        if not (math.isfinite(ev["loss"]) and 0.0 <= ev["bleu"] <= 100.0):
            raise AssertionError(f"wmt evaluation: {ev}")
        bleu_counts = _expect_launches("wmt bleu", rb[3], wmt_launches(
            cfg, 0, eval_batches=1, bleu_batches=1, max_len=256))
        b, s = 64, 256
        stats = _run_stats("transformer_big_wmt", ra[3], b, ra[4])
        n_ne = non_embedding_params(cfg)
        # Each parameter meets one token of its stream (source for the
        # encoder, target for the decoder): 6 N B S; the tied logits 6 d V
        # a target token; attention 12 S d a layer and token, the
        # decoder's causal self-attention half of it.
        flops = transformer_flops_per_token(n_ne, cfg, s) * b * s
        step_s = stats["step_ms"] / 1e3
        stats.update(
            card=smi_line(), config="transformer_big_wmt", batch=b, seq=s,
            tokens_per_s=b * s / step_s, non_embedding_params=n_ne,
            losses=losses, eval=ev, bleu_s=rb[3]["bleu_s"],
            bleu_launches=bleu_counts, restore=rb[3]["restore"],
            mfu=flops / step_s / PEAK_F32_SPLIT_FLOPS,
            mfu_fma=flops / step_s / PEAK_F32_FLOPS,
            mfu_formula="(6 N_non_embedding + 6 d V + 12 S d (L_enc + "
                        "1.5 L_dec)) B S / step_s / (989e12 / 3) (f32 "
                        "compute, as for bert; mfu_fma at 67e12)")
        stats["device_fed"] = _device_fed(
            "transformer_big_wmt", WMT_FLAGS[2:12], profile=True)
        log(f"  wmt: {json.dumps(stats)}")
        return counts, stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _device_fed(name: str, flags, *, steps: int = 5,
                profile: bool = False) -> dict:
    """The trainer of registry entry ``name``, built as the launcher
    builds it from ``flags``, on one batch already on the card: the step
    time without the host's data (ResNet's synthetic images take ~1.5 ms
    each to make); with ``profile``, one more step under torch.profiler."""
    import torch
    from tensorflow_train_distributed_torch import launch
    from tensorflow_train_distributed_torch.data.pipeline import to_device
    from tensorflow_train_distributed_torch.models import registry

    args = launch.build_parser().parse_args(
        ["--config", name, *flags, "--device", "cuda"])
    entry = registry.get_entry(name)
    torch.backends.cudnn.deterministic = True      # as the launcher runs
    torch.backends.cudnn.benchmark = False
    _, trainer, loader = launch.make_trainer(args, entry)
    state = trainer.create_state()
    host = next(iter(loader))
    batch = to_device(host, "cuda")
    for _ in range(2):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    b = next(iter(host.values())).shape[0]
    out = dict(step_ms=step_s * 1e3, examples_per_s=b / step_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               loss=float(m["loss"]))
    if profile:
        out["profile"] = _profile_train_step(trainer, state, [host])
    log(f"  {name} device-fed: {json.dumps(out)}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return out


def phase_resnet() -> dict:
    """Phase 15: resnet50_imagenet through the launcher (224², b 256,
    bf16, SGD with momentum, 12 steps, a save every 6), killed at step 9
    and rerun (the launcher pins cuDNN's deterministic algorithms, so the
    step-12 checkpoints must be equal bit for bit), 5 steps each of
    the s2d and s2d_bnsub variants, and each of the three trainers fed
    one batch already on the card."""
    import os
    import shutil

    root = os.path.abspath(os.path.join(FAMILY_DIR, "resnet"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        ra, rc, a_dir, b_dir = _kill_and_resume("resnet", RESNET_FLAGS,
                                                root)
        _same_checkpoint("resnet", a_dir, b_dir, KILLED_STEPS)
        _expect_launches("resnet", ra[3], {})
        losses = _losses("resnet", ra[1])
        stats = _run_stats("resnet50_imagenet", ra[3], 256, ra[4])
        stats.update(card=smi_line(), config="resnet50_imagenet", batch=256,
                     losses=losses, resume="bitwise",
                     resumed_step_ms=rc[3]["step_ms"],
                     save_bytes=ra[3]["save_bytes"],
                     mfu=3 * RESNET50_FWD_FLOPS * 256 / (
                         stats["step_ms"] / 1e3) / PEAK_BF16_FLOPS,
                     mfu_formula=FORMULAS["resnet50"])
        for name in ("resnet50_imagenet_s2d", "resnet50_imagenet_s2d_bnsub"):
            r = _in_process(name, "--config", name, *RESNET_FLAGS[2:6],
                            "--steps", "5", "--log-every", "1", "--seed",
                            str(SEED))
            _expect_launches(name, r[3], {})
            stats[name] = dict(_run_stats(name, r[3], 256, r[4]),
                               losses=_losses(name, r[1]))
        stats["device_fed"] = {
            name: _device_fed(name, RESNET_FLAGS[2:6],
                              profile=name == "resnet50_imagenet")
            for name in ("resnet50_imagenet", "resnet50_imagenet_s2d",
                         "resnet50_imagenet_s2d_bnsub")}
        for row in stats["device_fed"].values():
            row["mfu"] = (3 * RESNET50_FWD_FLOPS * row["examples_per_s"]
                          / PEAK_BF16_FLOPS)
        log(f"  resnet: {json.dumps(stats)}")
        return stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 15's data-service legs.
RESNET_SERVICE_FLAGS = ["--config", "resnet50_imagenet", "--global-batch-size",
                        "256", "--optimizer", "momentum", "--seed", str(SEED)]
JPEG_COUNT, JPEG_FILES = 512, 8


def _service_workers() -> int:
    """Input workers for b 256: the largest power of two that divides 256
    and leaves two of the host's cores to the trainer."""
    import os

    cores = len(os.sched_getaffinity(0))
    w = 1
    while 2 * w <= max(1, cores - 2) and 256 % (2 * w) == 0:
        w *= 2
    return w


def _write_jpeg_corpus(root: str) -> dict:
    """``JPEG_COUNT`` JPEGs from seed 0, around ImageNet's typical 500 x
    375 (smooth colour fields plus noise, quality 90), as a TFRecord
    corpus of ``JPEG_FILES`` files under the reference's keys
    (``image/encoded``, ``image/class/label``) with the raw-schema
    sidecar."""
    import io
    import os

    import numpy as np
    from PIL import Image
    from tensorflow_train_distributed_torch.data.tfrecord import (
        TFRecordWriter,
        write_features_sidecar,
    )

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    nbytes = 0
    per = JPEG_COUNT // JPEG_FILES
    for f in range(JPEG_FILES):
        path = os.path.join(
            root, f"train-{f:05d}-of-{JPEG_FILES:05d}.tfrecord")
        with TFRecordWriter(path) as w:
            for i in range(per):
                h = int(rng.integers(333, 418))
                wd = int(rng.integers(444, 557))
                field = rng.integers(0, 256, (6, 8, 3)).astype(np.uint8)
                img = np.asarray(Image.fromarray(field).resize(
                    (wd, h), Image.BILINEAR), np.int16)
                img = np.clip(img + rng.integers(-12, 13, img.shape), 0,
                              255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=90)
                nbytes += buf.tell()
                w.write_example({"image/encoded": buf.getvalue(),
                                 "image/class/label": np.asarray(
                                     [(f * per + i) % 1000], np.int64)})
    write_features_sidecar(root, None)
    out = dict(images=JPEG_COUNT, files=JPEG_FILES,
               mean_jpeg_kib=nbytes / JPEG_COUNT / 1024,
               write_s=time.perf_counter() - t0)
    log(f"  JPEG corpus: {json.dumps(out)}")
    return out


def _service_breakdown(workers: int) -> dict:
    """Where a service batch's time goes, each part alone in this
    process: one worker's slice of synthetic 224² f32 images built here
    (``HostDataLoader`` shard 0 of W), the client's batches with the
    trainer absent (build, transport and concatenation), and one batch's
    ``to_device`` (pinned copy and transfer, synchronised)."""
    import torch
    from tensorflow_train_distributed_torch.data.pipeline import (
        DataConfig,
        HostDataLoader,
        to_device,
    )
    from tensorflow_train_distributed_torch.data.service import (
        DataServiceDispatcher,
        SourceSpec,
    )

    spec = SourceSpec("imagenet", {})
    cfg = DataConfig(global_batch_size=256, seed=SEED)

    def per_item_ms(it, n):
        next(it)
        t0 = time.perf_counter()
        for _ in range(n):
            item = next(it)
        return (time.perf_counter() - t0) / n * 1e3, item

    slice_ms, _ = per_item_ms(iter(HostDataLoader(
        spec.build(), cfg, process_index=0, process_count=workers)), 3)
    with DataServiceDispatcher(spec, cfg, num_workers=workers) as disp:
        client_ms, batch = per_item_ms(iter(disp.client()), 5)
    t0 = time.perf_counter()
    for _ in range(3):
        to_device(batch, "cuda")
    torch.cuda.synchronize()
    out = dict(worker_slice_ms=slice_ms, client_batch_ms=client_ms,
               to_device_ms=(time.perf_counter() - t0) / 3 * 1e3,
               batch_mb=sum(v.nbytes for v in batch.values()) / 1e6)
    log(f"  one service batch, part by part: {json.dumps(out)}")
    return out


def phase_resnet_service(resnet: dict) -> dict:
    """Phase 15's data-service legs: resnet50_imagenet through the
    launcher with ``--data-workers W`` (W divides 256 and fits the cores):
    10 synthetic steps, its images/s beside phase 15's in-process and
    card-fed figures and the share of the step the card waits on the
    host; then, where PIL is installed, 512 JPEGs from seed 0 as a
    TFRecord corpus, 10 training steps on ``imagenet_train_u8_224``
    through the workers and an ``--eval-only`` of 2 batches on
    ``imagenet_eval_u8_224``."""
    import os
    import shutil

    workers = _service_workers()
    log(f"  {len(os.sched_getaffinity(0))} cores: --data-workers {workers}")
    card_fed = resnet["device_fed"]["resnet50_imagenet"]["step_ms"]
    r = _in_process("resnet, synthetic, --data-workers",
                    *RESNET_SERVICE_FLAGS, "--steps", "10", "--log-every",
                    "5", "--data-workers", str(workers))
    _expect_launches("resnet service", r[3], {})
    step = r[3]["step_ms"]
    out = dict(_run_stats("resnet50_imagenet --data-workers", r[3], 256,
                          r[4]),
               card=smi_line(), workers=workers, losses=_losses(
                   "resnet service", r[1]),
               data_service_start_s=r[3]["data_service_start_s"],
               data_wait_ms_per_step=r[3]["data_wait_ms_per_step"],
               in_process_images_per_s=256e3 / resnet["step_ms"],
               card_fed_images_per_s=256e3 / card_fed,
               card_idle_share=max(0.0, 1 - card_fed / step),
               card_idle_formula="1 - card-fed step_ms / step_ms")
    out["breakdown"] = _service_breakdown(workers)
    log(f"  images/s: workers {out['examples_per_s']:.1f}, in-process "
        f"{out['in_process_images_per_s']:.1f}, card-fed "
        f"{out['card_fed_images_per_s']:.1f}; the card waits on the host "
        f"{out['card_idle_share']:.1%} of the step; workers up in "
        f"{out['data_service_start_s']:.1f} s")
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        log(f"  JPEG leg did not run: PIL is not installed on this host "
            f"({e}); tests/test_torch_image.py holds the JPEG path on CPU")
        out["jpeg"] = "not run: no PIL"
        return out
    root = os.path.abspath(os.path.join(FAMILY_DIR, "jpeg"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "data"))
    try:
        corpus = _write_jpeg_corpus(os.path.join(root, "data"))
        data = ["--data-dir", os.path.join(root, "data"), "--checkpoint-dir",
                os.path.join(root, "ck")]
        t = _in_process("resnet, JPEG train", *RESNET_SERVICE_FLAGS,
                        *data, "--steps", "10", "--log-every", "2",
                        "--data-transform", "imagenet_train_u8_224",
                        "--data-workers", str(workers))
        _expect_launches("resnet JPEG", t[3], {})
        e = _in_process("resnet, JPEG eval-only", *RESNET_SERVICE_FLAGS,
                        *data, "--eval-only", "--eval-steps", "2",
                        "--data-transform", "imagenet_eval_u8_224")
        ev = e[1][-1]["eval"]
        if not all(math.isfinite(v) for v in ev.values()):
            raise AssertionError(f"JPEG eval: {ev}")
        out["jpeg"] = dict(
            _run_stats("resnet50_imagenet JPEG --data-workers", t[3], 256,
                       t[4]),
            corpus=corpus, steps=10, losses=_losses("resnet JPEG", t[1]),
            data_wait_ms_per_step=t[3]["data_wait_ms_per_step"],
            data_service_start_s=t[3]["data_service_start_s"],
            eval=ev, eval_s=e[3]["eval_s"])
        log(f"  JPEG: {out['jpeg']['examples_per_s']:.1f} images/s through "
            f"{workers} workers; eval {ev}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_mnist() -> dict:
    """Phase 16: mnist (LeNet) through the launcher, 100 steps of 128:
    the mean loss of the last 10 steps must be at most half the first
    step's.  Its loss (no label smoothing) takes K3 at [128, 10], once a
    step.  Its final checkpoint (``MNIST_DIR``) is phase 24 (d)'s."""
    import os
    import shutil

    ck = os.path.abspath(MNIST_DIR)
    shutil.rmtree(ck, ignore_errors=True)
    r = _in_process("mnist", "--config", "mnist", "--steps", "100",
                    "--log-every", "1", "--seed", str(SEED),
                    "--checkpoint-dir", ck)
    counts = _expect_launches("mnist", r[3], {"cross_entropy": 100,
                                              "cross_entropy_bwd": 100})
    losses = _losses("mnist", r[1])
    last = statistics.mean(losses[-10:])
    log(f"  mnist: loss {losses[0]:.4f} at step 1, mean of the last 10 "
        f"{last:.4f} (must be <= {losses[0] / 2:.4f})")
    if not last <= losses[0] / 2:
        raise AssertionError(f"mnist loss did not halve: {losses}")
    return counts, dict(_run_stats("mnist", r[3], 128, r[4]),
                        first_loss=losses[0], last10_mean_loss=last,
                        card=smi_line())


def phase_family_card_vs_cpu(steps: int = 5) -> dict:
    """Phase 17: five f32 steps on the card against the CPU port: a BERT
    with 64-wide heads at seq 128 (K2 full attention, K3 at an odd vocab
    of 1,001) and resnet_tiny (cuDNN convolutions, K3 at its 10 classes;
    its BatchNorm running statistics held like the params)."""
    import dataclasses

    from tensorflow_train_distributed_torch.data.datasets import (
        SyntheticImageNet,
        SyntheticMLM,
    )
    from tensorflow_train_distributed_torch.models import bert, registry

    bcfg = dataclasses.replace(bert.BERT_PRESETS["bert_tiny"],
                               hidden_size=128, num_heads=2,
                               intermediate_size=256, max_positions=128,
                               vocab_size=1001)
    out = {"bert[hd 64]": _card_vs_cpu(
        "bert_tiny[hd 64]", lambda: bert.BertMlmTask(bcfg, device="meta"),
        bcfg, ["flash_attention", "flash_attention_bwd", "cross_entropy",
               "cross_entropy_bwd"], steps=steps,
        source=SyntheticMLM(num_examples=64, seq_len=128, vocab_size=1001))}
    entry = registry.get_entry("resnet_tiny")
    out["resnet_tiny"] = _card_vs_cpu(
        "resnet_tiny", lambda: registry.make_task(entry, device="meta"),
        entry["config"], ["cross_entropy", "cross_entropy_bwd"],
        steps=steps,
        source=SyntheticImageNet(num_examples=64, num_classes=10,
                                 image_size=32))
    return out


# -- phase 18: llama2_7b_sft LoRA ---------------------------------------------

# Cuts, each in the phase's log line: the global batch 64 -> 2, sequence
# 4096 (Llama-2's context), no checkpoint (27 GB of base weights).
LORA_7B_FLAGS = ["--config", "llama2_7b_sft", "--lora-rank", "8",
                 "--lora-targets", "query,value", "--global-batch-size", "2",
                 "--dataset-kwarg", "seq_len=4096", "--steps", "10",
                 "--log-every", "1", "--seed", str(SEED)]
LORA_7B_CUTS = {"global_batch": "64 -> 2", "seq_len": "4096 (Llama-2's "
                "context)", "checkpoint": "none (27 GB of f32 base)"}


def phase_lora_kernels(train_rows: dict) -> tuple:
    """The kernels of the LoRA paths at their shapes.  Phase 18's: K1f
    at [8192, 4096] bf16, K1b there computing dx alone (the scale is
    frozen), K3 at [8192, 32000] f32, K2 causal bf16 at B 2, H 32, S
    4096, D 128.  Phase 11's LoRA leg: phase 5's rows (``train_rows``),
    K1b's replaced by dx alone at [16384, 768].  Returns the
    "lora_launch" and "lora_7b" rows of the kernels' JSON line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    launch = dict({k: train_rows[k] for k in LAUNCH_KERNELS},
                  rms_norm_bwd=_rms_norm_bwd_case(gen, 16384, 768,
                                                  dx_only=True))
    rows = {"rms_norm": _rms_norm_fwd_case(gen, 8192, 4096),
            "rms_norm_bwd": _rms_norm_bwd_case(gen, 8192, 4096,
                                               dx_only=True)}
    rows.update(_cross_entropy_cases(gen, 8192, 32000))
    torch.cuda.empty_cache()
    rows.update(_flash_case(gen, "llama2_7b lora", 2, 32, 32, 4096, 128,
                            packed=False, main=True))
    torch.cuda.empty_cache()
    return launch, rows


def phase_lora_7b() -> tuple:
    """Phase 18: llama2_7b_sft at full width and depth (d 4096, 32
    layers, ffn 11008, vocab 32,000) through the launcher with rank-8
    adapters on query and value, random weights from seed 0, 10 steps.
    Logs step time, tokens/s, the MFU of a frozen base, peak memory, the
    adapter and total parameter counts, the losses and the kernels'
    launches (10 x ``lora_launches_per_step``, exactly)."""
    from tensorflow_train_distributed_torch.models import registry

    cfg = registry.get_entry("llama2_7b_sft")["config"]
    log(f"  cuts: {json.dumps(LORA_7B_CUTS)}")
    r = _in_process("llama2_7b_sft LoRA", *LORA_7B_FLAGS)
    if r[0] != 0 or r[3] is None:
        raise AssertionError(f"llama2_7b_sft LoRA failed:\n{r[2][-4000:]}")
    summary = r[3]
    counts = _expect_launches("llama2_7b_sft LoRA", summary, {
        k: 10 * v for k, v in lora_launches_per_step(cfg.num_layers).items()})
    losses = _losses("llama2_7b_sft LoRA", r[1])
    b, s = 2, 4096
    step_s = summary["step_ms"] / 1e3
    n_ne = non_embedding_params(cfg)
    flops = lora_flops_per_token(n_ne, cfg, s) * b * s
    stats = dict(
        card=smi_line(), config="llama2_7b_sft", cuts=LORA_7B_CUTS,
        lora="rank 8, alpha 16, query,value", steps=10, batch=b, seq=s,
        params=summary["params"], lora_params=summary["lora_params"],
        step_ms=summary["step_ms"],
        window_ms_per_step=summary["window_ms_per_step"],
        tokens_per_s=b * s / step_s,
        peak_mem_gib=summary["peak_mem_bytes"] / 2 ** 30, losses=losses,
        mfu=flops / step_s / PEAK_BF16_FLOPS,
        mfu_formula="(4 N_non_embedding + 8 L S d) tokens / step_s / 989e12"
                    " (forward and input gradient, no weight gradient; "
                    "remat not counted)",
        wall_s=r[4])
    log(f"  llama2_7b_sft LoRA: {json.dumps(stats)}")
    return counts, stats


def phase_lora_7b_check() -> dict:
    """At llama2_7b's width cut to 2 layers (b 2 x s 1024, bf16 compute
    over f32 masters, adamw 1e-3 + clip 1.0 under ``freeze_base``): after
    3 steps the base parameters are bitwise unchanged and the adapters
    moved; the merged model's logits equal the unmerged model's within
    one bf16 step (relative L2 2^-7)."""
    import dataclasses

    import torch
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import HostBatches
    from tensorflow_train_distributed_torch.models import layers as L
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS, CausalLmTask, LlamaModel)
    from tensorflow_train_distributed_torch.models.lora import (
        LoraSpec, freeze_base, is_lora_param, merge_lora)
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy)
    from tensorflow_train_distributed_torch.training.trainer import (
        Trainer, TrainerConfig)

    spec = LoraSpec(rank=8)
    cfg = dataclasses.replace(LLAMA_PRESETS["llama2_7b"], num_layers=2,
                              lora=spec)
    trainer = Trainer(
        CausalLmTask(cfg, device="meta"),
        freeze_base(optimizers.make_optimizer("adamw", 1e-3,
                                              grad_clip_norm=1.0)),
        policy=Policy.from_name("bfloat16"),
        config=TrainerConfig(seed=SEED, log_every=1), device="cuda")
    state = trainer.create_state()
    before = {k: v.detach().clone() for k, v in state.params.items()}
    src = SyntheticLM(num_examples=16, seq_len=1024)
    state, history = trainer.fit(HostBatches(src, 2, seed=SEED), steps=3,
                                 state=state)
    frozen = [k for k in before if not is_lora_param(k)]
    changed = [k for k in frozen if not torch.equal(state.params[k],
                                                    before[k])]
    moved = [k for k in before if is_lora_param(k)
             and not torch.equal(state.params[k], before[k])]
    tokens = torch.from_numpy(src[0]["tokens"][None]).cuda()
    with trainer.inference(state):
        unmerged = trainer.task.model(tokens).float()
    merged = merge_lora({k: v.detach() for k, v in state.params.items()},
                        spec)
    plain = LlamaModel(dataclasses.replace(cfg, lora=None), device="meta")
    plain.load_state_dict(merged, strict=True, assign=True)
    L.set_compute_dtype(plain, torch.bfloat16)
    with torch.no_grad():
        got = plain(tokens).float()
    rel = ((got - unmerged).norm() / unmerged.norm()).item()
    out = dict(frozen_params=len(frozen), frozen_changed=len(changed),
               adapters_moved=len(moved), merged_vs_unmerged_rel_l2=rel,
               bound=2 ** -7, losses=[m["loss"] for _, m in history])
    log(f"  llama2_7b[2 layers] LoRA check: {json.dumps(out)}")
    if changed or not moved or not rel <= 2 ** -7:
        raise AssertionError(f"LoRA check failed: {out}; changed "
                             f"{changed[:3]}")
    del trainer, state, before, plain, merged
    torch.cuda.empty_cache()
    return out


# -- phase 23: the serving fleet ----------------------------------------------

FLEET_DIR = "_fleet_smoke"        # git-ignored; deleted at the phase's end
FLEET_CONFIG = "llama2_7b_sft"
FLEET_DEVICE = "cuda"
FLEET_FLAGS = ["--slots", "8", "--chunk", "8", "--cache-len", "1024",
               "--kv-block-size", "16", "--seed", str(SEED)]
FLEET_TOL = 0.25                  # phase 3's gap bar
FLEET_STREAMS = (0, 3, 6, 9)      # the requests that stream
FLEET_DRAIN_NEW = 64              # tokens of the drain's long streams
# One frame carries a migrated lane or a KV handoff: a Llama-2-7B bf16
# block of 16 rows is 8 MiB, a 400-token lane 200 MiB.
FLEET_MAX_FRAME = 512 << 20


def _fleet_args(*extra):
    from tensorflow_train_distributed_torch import serve_http

    return serve_http.build_parser().parse_args(
        ["--config", FLEET_CONFIG, "--device", FLEET_DEVICE, *FLEET_FLAGS,
         *extra])


def _get(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _prom(text: str) -> dict:
    out = {}
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def _fleet_request(port, prompt, max_new, stream, on_chunk=None) -> dict:
    """One /v1/generate: {"id", "tokens" (prompt + generated), "status",
    "chunks"}; a stream's tokens are the prompt and its chunks."""
    import urllib.request

    body = {"prompt": prompt, "max_new": max_new, "stream": stream}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not stream:
            obj = json.loads(r.read())
            return dict(id=obj["id"], tokens=obj["tokens"], status=r.status,
                        chunks=1)
        rid, toks, chunks, err = None, list(prompt), 0, None
        for raw in r:
            obj = json.loads(raw)
            if "id" in obj:
                rid = obj["id"]
            if "tokens" in obj:
                toks += obj["tokens"]
                chunks += 1
                if on_chunk is not None:
                    on_chunk(rid)
            if "error" in obj:
                err = obj["error"]
        if err is not None:
            raise AssertionError(f"stream {rid} ended with {err}")
        return dict(id=rid, tokens=toks, status=r.status, chunks=chunks)


def _fleet_send(port, prompts, max_new, *, first_alone=True,
                streams=FLEET_STREAMS, on_chunk=None) -> list:
    """The requests over HTTP: #0 alone to its first token (its prefix
    blocks in a radix before #1 routes), then the rest at once."""
    import threading

    out = [None] * len(prompts)
    errors = []
    first = threading.Event()

    def first_chunk(rid):
        first.set()
        if on_chunk is not None:
            on_chunk(rid)

    def client(i):
        try:
            cb = first_chunk if i == 0 and first_alone else on_chunk
            out[i] = _fleet_request(port, prompts[i], max_new,
                                    i in streams, cb)
        except BaseException as e:       # noqa: BLE001 — raised below
            errors.append(e)
        finally:
            first.set()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    start = 1 if first_alone else 0
    if first_alone:
        threads[0].start()
        first.wait(600)
    for t in threads[start:]:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for i, (o, p) in enumerate(zip(out, prompts)):
        if (o["status"] != 200 or len(o["tokens"]) != len(p) + max_new
                or o["tokens"][:len(p)] != p):
            raise AssertionError(f"request {i}: malformed reply {o}")
    return out


def _stream_whole(port, outs, prompts, max_new) -> None:
    """Each streamed reply concatenates to its full reply: prompt + its
    chunks is prompt + max_new tokens, and the gateway's timeline retired
    the request with that many generated tokens."""
    for i in FLEET_STREAMS:
        status, text = _get(port, f"/v1/requests/{outs[i]['id']}")
        if status != 200:
            raise AssertionError(f"no timeline for request {i}: {text}")
        tl = json.loads(text)
        retire = [e for e in tl["timeline"]
                  if e["name"] == "request/retire"][-1]["args"]
        if (retire.get("status") != "ok" or retire["tokens"] != max_new
                or outs[i]["chunks"] < 2):
            raise AssertionError(f"stream {i}: {retire}, "
                                 f"{outs[i]['chunks']} chunks")


def _fleet_consistency(eng, label, prompts, outs, batch_tokens) -> dict:
    """Teacher-force each reply (prompt + generated, all but the last)
    through ``eng``'s model in a fresh cache: every generated token's
    logit within 2 x FLEET_TOL of max(std, 1) of that position's best
    (two argmaxes of logits within FLEET_TOL of each other, phase 3's gap
    bar, can part by no more), and at least half the generated tokens the
    argmax.  Agreement with phase 3's batch tokens is logged."""
    import torch

    worst = 0.0
    agree = total = same = batch_pos = 0
    for p, o, b in zip(prompts, outs, batch_tokens):
        toks = o["tokens"]
        logits = _teacher_forced(eng, toks, len(p))[len(p) - 1:]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: non-finite logits")
        gen = torch.tensor(toks[len(p):], device=logits.device)
        best = logits.max(-1).values
        picked = logits.gather(1, gen[:, None])[:, 0]
        scale = logits.std(-1).clamp(min=1.0)
        worst = max(worst, ((best - picked) / scale).max().item())
        agree += int((logits.argmax(-1) == gen).sum())
        total += len(gen)
        same += int(toks == b)
        batch_pos += sum(int(x == y) for x, y in zip(toks[len(p):],
                                                     b[len(p):]))
    res = dict(worst_margin=worst, bar=2 * FLEET_TOL, agree=agree,
               total=total, requests_equal_batch=same,
               tokens_equal_batch=batch_pos)
    log(f"  {label}: worst margin below the re-prefill's best "
        f"{worst:.4f} of max(std, 1) (bar {2 * FLEET_TOL}); argmax agrees "
        f"{agree}/{total}; phase 3's batch tokens: {same}/{len(outs)} "
        f"requests whole, {batch_pos}/{total} tokens")
    if worst > 2 * FLEET_TOL or agree < 0.5 * total:
        raise AssertionError(f"{label}: fleet tokens fail phase 3's bars: "
                             f"{res}")
    return res


def _mean_inter_token_ms(metrics: dict):
    n = metrics.get("ttd_gateway_inter_token_seconds_count", 0)
    return (metrics["ttd_gateway_inter_token_seconds_sum"] / n * 1e3
            if n else None)


def _fleet_in_process(prompts, max_new) -> tuple:
    """(a): two in-process replicas behind ``ServingGateway``."""
    import torch

    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.serve import (
        build_engine,
        engine_config,
    )
    from tensorflow_train_distributed_torch.server import ServingGateway

    t0 = time.perf_counter()
    args = _fleet_args("--replicas", "2")
    cfg = engine_config(args)
    engines = [build_engine(args, cfg, []) for _ in range(2)]
    for e in engines:
        e.submit([1], 1)
        e.run()
        e.stats["decode_steps"] = 0
    built = time.perf_counter() - t0
    gw = ServingGateway(engines, host="127.0.0.1", port=0,
                        max_queue=64).start()
    try:
        K.reset_launch_counts()
        t1 = time.perf_counter()
        outs = _fleet_send(gw.port, prompts, max_new)
        wall = time.perf_counter() - t1
        if FLEET_DEVICE == "cuda":
            torch.cuda.synchronize()
        counts = {k: K.launch_counts()[k] for k in FLEET_KERNELS}
        _stream_whole(gw.port, outs, prompts, max_new)
        metrics = _prom(_get(gw.port, "/metrics")[1])
    finally:
        gw.drain(timeout=120)
    served = (metrics.get('ttd_gateway_requests_total{status="ok"}'),
              metrics.get("ttd_gateway_tokens_generated_total"))
    if served != (len(prompts), len(prompts) * max_new):
        raise AssertionError(f"(a) /metrics counted {served} requests and "
                             f"tokens; {len(prompts)} and "
                             f"{len(prompts) * max_new} were served")
    steps = [e.stats["decode_steps"] for e in engines]
    hits = [e.kv_stats["prefix_hits"] for e in engines]
    log(f"  (a) launches {counts} over both driver threads; decode steps "
        f"{steps}; radix hits {hits}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"(a) a kernel of the path never ran: {counts}")
    if counts["paged_attention"] != cfg.num_layers * sum(steps):
        raise AssertionError(
            f"(a) paged_attention launches {counts['paged_attention']} != "
            f"layers x decode steps {cfg.num_layers * sum(steps)}")
    if min(steps) <= 0 or max(hits) < 1:
        raise AssertionError(f"(a) a replica idle ({steps}) or no radix "
                             f"hit behind the affinity ({hits})")
    stats = dict(build_s=built, wall_s=wall, decode_steps=steps,
                 radix_hits=hits,
                 tokens_per_s=len(prompts) * max_new / wall,
                 mean_inter_token_ms=_mean_inter_token_ms(metrics),
                 ttft_mean_s=(metrics["ttd_gateway_ttft_seconds_sum"]
                              / metrics["ttd_gateway_ttft_seconds_count"]))
    log(f"  (a) {json.dumps(stats)}")
    # Replica 0 stays for the teacher forcing of every leg.
    keep = engines[0]
    del engines, gw
    _free()
    return counts, stats, outs, keep


def _fleet_cmd(*flags) -> list:
    """``serve_http`` with the fleet's engine flags, as a user types it."""
    return [sys.executable, "-m",
            "tensorflow_train_distributed_torch.serve_http", "--config",
            FLEET_CONFIG, "--device", FLEET_DEVICE, *FLEET_FLAGS,
            "--host", "127.0.0.1", "--port", "0", *[str(f) for f in flags]]


def _launch_gateway(*flags, log_name):
    """``serve_http`` as a process, its stderr (and its workers') to
    FLEET_DIR/<log_name>."""
    import os

    os.makedirs(FLEET_DIR, exist_ok=True)
    with open(os.path.join(FLEET_DIR, log_name), "w") as err:
        return subprocess.Popen(
            _fleet_cmd(*flags), stdout=subprocess.PIPE, stderr=err,
            text=True, env=dict(os.environ, PYTHONPATH=os.getcwd()))


def _port_line(proc, prefix: str) -> int:
    """The port of the first stdout line that starts with ``prefix``
    ("gateway listening on HOST:PORT ...", "worker listener on
    HOST:PORT; ...")."""
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip())
        if line.startswith(prefix):
            return int(line.split()[3].rstrip(";").rsplit(":", 1)[1])
    raise AssertionError(f"serve_http printed no {prefix!r}: {lines}")


def _final_metrics(log_path: str) -> tuple:
    """The drained gateway's final metrics (logged at its drain) and its
    migration log lines."""
    text = open(log_path).read()
    if "final metrics:" not in text:
        raise AssertionError(f"no final metrics in {log_path}")
    tail = text.split("final metrics:", 1)[1]
    metrics = {}
    for line in tail.splitlines()[1:]:
        if not line.startswith(("#", "ttd_")):
            if line.strip():
                break
            continue
        if line.startswith("ttd_"):
            key, val = line.rsplit(" ", 1)
            metrics[key] = float(val)
    migrations = [line for line in text.splitlines()
                  if " migrated replica " in line]
    return metrics, migrations


def _fleet_procs(prompts, max_new) -> tuple:
    """(b): ``serve_http --replica-procs --replicas 2``; SIGKILL, respawn,
    then SIGTERM's drain with live migration."""
    import os
    import signal
    import threading

    t0 = time.perf_counter()
    log_path = os.path.join(FLEET_DIR, "procs.log")
    proc = _launch_gateway(
        "--replica-procs", "--replicas", "2", "--restart-budget", "2",
        "--watchdog-timeout", "120", "--drain-timeout", "120",
        "--max-frame", FLEET_MAX_FRAME, log_name="procs.log")
    try:
        port = _port_line(proc, "gateway listening on")
        res = {"ready_s": time.perf_counter() - t0}
        killed = {}

        def kill_once():
            # SIGKILL the worker holding the most lanes, mid-decode.
            if killed:
                return
            h = json.loads(_get(port, "/healthz")[1])
            live = [r for r in h["replicas"] if r["state"] == "alive"
                    and r.get("slots_in_use", 0) > 0]
            if not live:
                return
            victim = max(live, key=lambda r: r["slots_in_use"])
            killed.update(replica=victim["replica"], pid=victim["pid"])
            os.kill(victim["pid"], signal.SIGKILL)

        lock = threading.Lock()
        begun = set()

        def on_chunk(rid):
            # Two streams under way: both workers hold lanes.
            with lock:
                begun.add(rid)
                if len(begun) >= 2:
                    kill_once()

        t1 = time.perf_counter()
        outs = _fleet_send(port, prompts, max_new, first_alone=False,
                           on_chunk=on_chunk)
        res["serve_s"] = time.perf_counter() - t1
        if not killed:
            raise AssertionError("(b) no worker was killed mid-stream")
        health = json.loads(_get(port, "/healthz")[1])
        dead = [r for r in health["replicas"] if r["state"] == "dead"]
        metrics = _prom(_get(port, "/metrics")[1])
        res.update(killed=killed, failovers=metrics.get(
            "ttd_gateway_failovers_total", 0), healthz=health["status"],
            dead=dead)
        if (len(dead) != 1 or dead[0]["pid"] != killed["pid"]
                or dead[0].get("failure_class") != "killed"
                or res["failovers"] < 1):
            raise AssertionError(f"(b) failover not seen: {res}")
        # The pool respawns the corpse within its restart budget; the new
        # worker is ready once its HELLO gave it slots.
        t2 = time.perf_counter()
        deadline = t2 + 180
        while time.perf_counter() < deadline:
            h = json.loads(_get(port, "/healthz")[1])
            if sum(r["state"] == "alive" and r["slots_total"] > 0
                   for r in h["replicas"]) >= 2:
                break
            time.sleep(0.5)
        metrics = _prom(_get(port, "/metrics")[1])
        res.update(respawn_s=time.perf_counter() - t2,
                   restarts=metrics.get(
                       "ttd_gateway_replica_restarts_total", 0),
                   replicas_alive=metrics.get("ttd_gateway_replicas_alive"))
        if not 1 <= res["restarts"] <= 2 or res["replicas_alive"] < 2:
            raise AssertionError(f"(b) no respawn within the budget: {res}")
        res["mean_inter_token_ms"] = _mean_inter_token_ms(metrics)
        # The drain: long streams on both workers, then SIGTERM.
        started = set()
        term = threading.Event()

        def on_drain_chunk(rid):
            with lock:
                started.add(rid)
                if len(started) >= len(drain_prompts) and not term.is_set():
                    term.set()
                    proc.send_signal(signal.SIGTERM)

        drain_prompts = prompts[2:10]
        t3 = time.perf_counter()
        drained = _fleet_send(port, drain_prompts, FLEET_DRAIN_NEW,
                              first_alone=False,
                              streams=range(len(drain_prompts)),
                              on_chunk=on_drain_chunk)
        rc = proc.wait(timeout=300)
        res["drain_s"] = time.perf_counter() - t3
        if not term.is_set() or rc != 0:
            raise AssertionError(f"(b) SIGTERM drain: sent "
                                 f"{term.is_set()}, exit {rc}")
        final, migrations = _final_metrics(log_path)
        warm = [int(m.split("(")[-1].split(" warm")[0]) for m in migrations]
        res.update(migrations=final.get("ttd_gateway_migrations_total", 0),
                   migrated_kv_bytes=final.get(
                       "ttd_gateway_migrated_kv_bytes_total", 0),
                   migrated_warm_tokens=warm)
        if res["migrations"] < 1 or not warm or min(warm) <= 0:
            raise AssertionError(f"(b) the drain migrated no lane with its "
                                 f"KV: {res}, {migrations}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    res["seconds"] = time.perf_counter() - t0
    log(f"  (b) {json.dumps(res)}")
    return res, outs, drain_prompts, drained


def _fleet_disagg(prompts, max_new) -> tuple:
    """(c): ``serve_http --listen`` with a prefill and a decode worker,
    all three started at once (the workers build their engines while the
    gateway imports, then dial it, re-dialing until it listens)."""
    import os
    import signal
    import socket

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        listen = sock.getsockname()[1]
    proc = _launch_gateway(
        "--listen", f"127.0.0.1:{listen}", "--replicas", "2",
        "--watchdog-timeout", "120", "--drain-timeout", "120",
        "--max-frame", FLEET_MAX_FRAME, log_name="disagg.log")
    err = open(os.path.join(FLEET_DIR, "disagg.log"), "a")
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    workers = []
    res = {}
    try:
        spec = json.dumps(vars(_fleet_args()))
        for i, role in enumerate(("prefill", "decode")):
            workers.append(subprocess.Popen(
                [sys.executable, "-m",
                 "tensorflow_train_distributed_torch.serve_worker",
                 "--dial", f"127.0.0.1:{listen}", "--factory",
                 "tensorflow_train_distributed_torch.serve:"
                 "worker_engine_factory", "--json", spec,
                 "--replica-id", str(i), "--role", role,
                 "--max-frame", str(FLEET_MAX_FRAME), "--redials", "30"],
                stdout=subprocess.DEVNULL, stderr=err, env=env))
        port = _port_line(proc, "gateway listening on")
        res["ready_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        outs = _fleet_send(port, prompts, max_new)
        res["serve_s"] = time.perf_counter() - t1
        handoffs = []
        for o in outs:
            tl = json.loads(_get(port, f"/v1/requests/{o['id']}")[1])
            handoffs += [e["args"] for e in tl["timeline"]
                         if e["name"] == "request/kv_handoff"]
        metrics = _prom(_get(port, "/metrics")[1])
        health = json.loads(_get(port, "/healthz")[1])
        res.update(handoffs=len(handoffs),
                   handoff_bytes=sum(h["bytes"] for h in handoffs),
                   handoff_tokens=sum(h["tokens"] for h in handoffs),
                   roles=sorted(r.get("role", "both")
                                for r in health["replicas"]),
                   mean_inter_token_ms=_mean_inter_token_ms(metrics))
        if (not handoffs or res["handoff_bytes"] <= 0
                or res["roles"] != ["decode", "prefill"]
                or any(h["prefill_replica"] == h["decode_replica"]
                       for h in handoffs)):
            raise AssertionError(f"(c) no KV handoff: {res}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        wrc = [w.wait(timeout=120) for w in workers]
        if rc != 0 or wrc != [0, 0]:
            err.flush()
            with open(os.path.join(FLEET_DIR, "disagg.log")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"(c) drain exits: gateway {rc}, workers "
                                 f"{wrc}; the log's tail:\n{tail}")
    finally:
        err.close()
        for p in [proc, *workers]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    res["seconds"] = time.perf_counter() - t0
    log(f"  (c) {json.dumps(res)}")
    return res, outs


def phase_fleet(run3: dict) -> tuple:
    """Phase 23 (the module docstring): (launch counts of (a), readings)."""
    import shutil

    prompts, max_new = run3["prompts"], run3["max_new"]
    fleet = {}
    t0 = time.perf_counter()
    counts, fleet["in_process"], outs_a, eng = _fleet_in_process(prompts,
                                                                max_new)
    fleet["in_process"]["seconds"] = time.perf_counter() - t0
    log(f"  (a) {fleet['in_process']['seconds']:.1f} s")
    try:
        fleet["procs"], outs_b, drain_prompts, drained = _fleet_procs(
            prompts, max_new)
        fleet["disagg"], outs_c = _fleet_disagg(prompts, max_new)
        t1 = time.perf_counter()
        checks = {
            "in_process": _fleet_consistency(eng, "(a) in process", prompts,
                                             outs_a, run3["tokens"]),
            "procs": _fleet_consistency(eng, "(b) worker processes",
                                        prompts, outs_b, run3["tokens"]),
            "procs_drain": _fleet_consistency(
                eng, "(b) drained streams", drain_prompts, drained,
                [o["tokens"] for o in drained]),
            "disagg": _fleet_consistency(eng, "(c) disaggregated", prompts,
                                         outs_c, run3["tokens"])}
        fleet["consistency"] = checks
        fleet["check_s"] = time.perf_counter() - t1
    finally:
        del eng
        _free()
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    fleet["seconds"] = time.perf_counter() - t0
    log(f"  phase 23: {fleet['seconds']:.1f} s")
    return counts, fleet


# -- phase 24: ViT and HF interop -----------------------------------------------

INTEROP_DIR = "_interop_smoke"    # git-ignored; deleted at the phase's end
MNIST_DIR = INTEROP_DIR + "/mnist"    # phase 16's checkpoint, for (d)
# Registry batch 1024 cut to 256 for one card (phase 15's cut of ResNet's).
VIT_FLAGS = ["--config", "vit_b16_imagenet", "--global-batch-size", "256",
             "--steps", "12", "--eval-split", "0.001", "--eval-steps", "2",
             "--log-every", "2", "--seed", str(SEED)]
HF_TRAIN_FLAGS = ["--config", "llama_125m_lm", "--steps", "4",
                  "--eval-split", "0.001", "--eval-steps", "4",
                  "--log-every", "1", "--seed", str(SEED)]
HF_SERVE_LAYERS = 2               # of Llama-2-7B's 32, at full width


def _vit_leg(root: str) -> tuple:
    """(a): vit_b16_imagenet through the launcher and its --eval-only;
    vit_tiny card vs CPU.  Returns (vit_tiny's launches, stats)."""
    import os

    from tensorflow_train_distributed_torch.data.datasets import (
        SyntheticImageNet,
    )
    from tensorflow_train_distributed_torch.models import registry

    ck = os.path.join(root, "vit")
    ra = _in_process("vit_b16_imagenet", *VIT_FLAGS, "--checkpoint-dir", ck)
    # S 196 misses K2's gate (a multiple of 128) and the label-smoothed
    # loss is plain PyTorch: no kernel of the port runs.
    _expect_launches("vit_b16_imagenet", ra[3], {})
    losses = _losses("vit_b16_imagenet", ra[1])
    rd = _in_process("vit_b16_imagenet --eval-only", *VIT_FLAGS,
                     "--checkpoint-dir", ck, "--eval-only")
    if rd[1] != [{"step": 12, "eval": ra[1][-1]["eval"]}]:
        raise AssertionError(f"ViT eval-only gave {rd[1]}, the run "
                             f"{ra[1][-1]}")
    cfg = registry.get_config("vit_b16_imagenet")
    fwd = vit_forward_flops(cfg)
    stats = _run_stats("vit_b16_imagenet", ra[3], 256, ra[4])
    stats.update(card=smi_line(), config="vit_b16_imagenet", batch=256,
                 batch_cut="1024 -> 256", steps=12, losses=losses,
                 eval=ra[1][-1]["eval"], eval_only="equal to the run's",
                 save_bytes=ra[3]["save_bytes"],
                 forward_gflops_per_image=fwd / 1e9)
    dev = _device_fed("vit_b16_imagenet", VIT_FLAGS[2:4], steps=5,
                      profile=True)
    dev["mfu"] = 3 * fwd * dev["examples_per_s"] / PEAK_BF16_FLOPS
    dev["mfu_formula"] = FORMULAS["vit"]
    stats["device_fed"] = dev
    log(f"  vit_b16_imagenet: {json.dumps(stats)}")
    entry = registry.get_entry("vit_tiny")
    tiny = _card_vs_cpu(
        "vit_tiny", lambda: registry.make_task(entry, device="meta"),
        entry["config"], ["cross_entropy", "cross_entropy_bwd"], steps=5,
        source=SyntheticImageNet(num_examples=64, num_classes=10,
                                 image_size=32), zero_grad=True)
    stats["vit_tiny_card_vs_cpu"] = tiny
    return tiny["launches"], stats


def _sample_cli(source_flags, rows_in, max_new) -> list:
    """``sample.py`` on llama_125m_lm in this process; its completions."""
    import io

    from tensorflow_train_distributed_torch import sample

    args = ["--config", "llama_125m_lm", *source_flags, "--max-new",
            str(max_new)]
    for r in rows_in:
        args += ["--prompt", ",".join(map(str, r))]
    buf = io.StringIO()
    with _fresh_process_flags(), contextlib.redirect_stdout(buf):
        rc = sample.main(args)
    if rc != 0:
        raise AssertionError(f"sample.py {source_flags} exit {rc}")
    return [json.loads(x)["completion"] for x in buf.getvalue().splitlines()]


def _hf_launcher_leg(root: str, phase11_eval) -> tuple:
    """(b): llama_125m_lm's checkpoint exported as HF and read back by the
    launcher, sample.py and serve.py.  Returns (the 4 --init-from-hf
    steps' launches, stats)."""
    import io
    import os

    import numpy as np
    from tensorflow_train_distributed_torch import export_hf_checkpoint
    from tensorflow_train_distributed_torch.models import hf_io, registry

    ck = os.path.abspath(os.path.join(SAMPLE_DIR, "a"))
    if not os.path.isdir(ck):
        # Run alone, without phase 11's checkpoint: 2 steps of its flags.
        rc, _, err, _, _ = _launcher(
            "a checkpoint to export", *LAUNCH_FLAGS[:2], "--steps", "2",
            "--seed", str(SEED), "--checkpoint-dir", ck)
        if rc != 0:
            raise AssertionError(f"(b) launcher failed:\n{err[-4000:]}")
    hf = os.path.join(root, "hf_125m")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if export_hf_checkpoint.main(["--config", "llama_125m_lm",
                                      "--checkpoint-dir", ck, "--out",
                                      hf]) != 0:
            raise AssertionError("export_hf_checkpoint failed")
    export_s = time.perf_counter() - t0
    ref = _in_process("eval-only --checkpoint-dir", *LAUNCH_FLAGS,
                      "--checkpoint-dir", ck, "--eval-only")[1][0]["eval"]
    got = _in_process("eval-only --init-from-hf", *LAUNCH_FLAGS,
                      "--init-from-hf", hf, "--eval-only")[1]
    if got != [{"step": 0, "eval": ref}]:
        raise AssertionError(f"--init-from-hf eval {got} != the "
                             f"checkpoint's {ref}")
    if phase11_eval is not None and ref != phase11_eval:
        raise AssertionError(f"eval {ref} != phase 11's {phase11_eval}")
    log(f"  (b) eval of the HF export equals the checkpoint's bit for bit"
        f"{' and phase 11 (d)' if phase11_eval is not None else ''}: {ref}")
    r = _in_process("4 --init-from-hf steps", *HF_TRAIN_FLAGS,
                    "--init-from-hf", hf)
    cfg = registry.get_config("llama_125m_lm")
    want = {k: 4 * v for k, v in
            train_launches_per_step(cfg.num_layers).items()}
    for k, v in eval_launches_per_batch(cfg.num_layers).items():
        want[k] += 4 * v                      # the final evaluation
    counts = _expect_launches("hf_train", r[3], want)
    losses = _losses("hf_train", r[1])
    rng = np.random.default_rng(SEED + 24)
    rows_in = [rng.integers(1, cfg.vocab_size, 24).tolist()
               for _ in range(2)]
    s_ck = _sample_cli(["--checkpoint-dir", ck], rows_in, 16)
    s_hf = _sample_cli(["--init-from-hf", hf], rows_in, 16)
    if s_hf != s_ck:
        raise AssertionError(f"sample.py --init-from-hf {s_hf} != "
                             f"--checkpoint-dir {s_ck}")
    prompts = []
    for r_ in _requests(rng, 4, 8, 40, cfg.vocab_size, 8):
        prompts += ["--prompt", ",".join(map(str, r_))]
    t_ck, _ = _serve("--checkpoint-dir", "--checkpoint-dir", ck, *prompts)
    t_hf, sum_hf = _serve("--init-from-hf", "--init-from-hf", hf, *prompts)
    if t_hf != t_ck:
        raise AssertionError(f"serve.py --init-from-hf {t_hf} != "
                             f"--checkpoint-dir {t_ck}")
    stats = dict(card=smi_line(), config="llama_125m_lm",
                 export_s=export_s, export_bytes=hf_io.checkpoint_bytes(hf),
                 eval=ref, eval_equal_phase11=phase11_eval is not None,
                 train_step_ms=r[3]["step_ms"], train_losses=losses,
                 sample_equal=True, serve_equal=True,
                 serve_launches=sum_hf["launches"])
    log(f"  (b) llama_125m_lm HF interop: {json.dumps(stats)}")
    return counts, stats


def _engine_tokens(cfg, params, prompts, max_new) -> tuple:
    """Phase 3's engine on ``params``: (tokens, launches of the requests'
    run, decode steps, prefix hits)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.serving import ServingEngine

    eng = ServingEngine(cfg, params, slots=8, chunk=8, cache_len=1024,
                        kv_block_size=16, overlap=False, prefill_budget=0,
                        device="cuda")
    eng.submit([1] * 16, 2)
    eng.run()
    eng.stats.update(decode_steps=0, decode_s=0.0)
    K.reset_launch_counts()
    rids = [eng.submit(p, max_new) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    counts = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
    res = ([out[r] for r in rids], counts, eng.stats["decode_steps"],
           eng.kv_stats["prefix_hits"])
    del eng
    _free()
    return res


def _hf_engine_leg(root: str) -> tuple:
    """(c): Llama-2-7B at full width, 2 layers, through export_llama and
    import_llama onto the card; returns (the imported engine's launches,
    stats)."""
    import os
    import shutil

    import numpy as np
    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import hf_io
    from tensorflow_train_distributed_torch.models.export_hf import (
        export_llama,
    )
    from tensorflow_train_distributed_torch.models.import_hf import (
        import_llama,
    )
    from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS

    cfg = dataclasses.replace(LLAMA_PRESETS["llama2_7b"],
                              num_layers=HF_SERVE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    src = convert.init_params(cfg, gen, device="cuda")
    out = os.path.join(root, "hf_7b")
    t0 = time.perf_counter()
    export_llama(cfg, src, out)
    export_s = time.perf_counter() - t0
    nbytes = hf_io.checkpoint_bytes(out)
    t0 = time.perf_counter()
    _, imported = import_llama(out, cfg, device="cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    same = all(torch.equal(imported[k], v) for k, v in src.items())
    if not same or set(imported) != set(src):
        raise AssertionError("(c) the import differs from the exported "
                             "weights")
    # Phase 3's requests (the same draw): 12 prompts, #0 and #1 sharing a
    # 64-token prefix, 32 new tokens.
    prompts = _requests(np.random.default_rng(SEED), 12, 16, 300,
                        cfg.vocab_size, 64)
    want, _, _, _ = _engine_tokens(cfg, src, prompts, 32)
    del src
    _free()
    got, counts, steps, hits = _engine_tokens(cfg, imported, prompts, 32)
    del imported
    _free()
    log(f"  (c) hf_serve launches {counts}; decode steps {steps}; prefix "
        f"hits {hits}")
    if got != want:
        raise AssertionError("(c) the imported engine's tokens differ from "
                             "the source weights'")
    if min(counts.values()) <= 0 or hits < 1:
        raise AssertionError(f"(c) a kernel of the path never ran: "
                             f"{counts}, prefix hits {hits}")
    if counts["paged_attention"] != cfg.num_layers * steps:
        raise AssertionError(f"(c) paged_attention {counts} != layers x "
                             f"decode steps {cfg.num_layers * steps}")
    stats = dict(card=smi_line(), config=f"llama2_7b[{cfg.num_layers} of "
                 f"32 layers]", export_s=export_s, export_bytes=nbytes,
                 export_gb_per_s=nbytes / export_s / 1e9, import_s=import_s,
                 import_gb_per_s=nbytes / import_s / 1e9,
                 tokens_equal=True, requests=len(prompts),
                 decode_steps=steps)
    log(f"  (c) Llama-2-7B width export/import: {json.dumps(stats)}")
    shutil.rmtree(out, ignore_errors=True)
    return counts, stats


def _rss() -> dict:
    """This process's resident memory now, in bytes, from
    ``/proc/self/status``: ``VmRSS`` and, where the kernel reports them,
    its anonymous and file-backed parts ``RssAnon`` and ``RssFile``."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            k, _, v = line.partition(":")
            if k in ("VmRSS", "RssAnon", "RssFile"):
                out[k] = int(v.split()[0]) * 1024
    return out


@contextlib.contextmanager
def _host_memory_peaks(every_s: float = 0.02):
    """Peaks of ``_rss()`` sampled every ``every_s`` seconds while the
    block runs; yields the dict of peaks, filled at the block's end, with
    each field's value at the start beside it (``<field>_at_start``)."""
    import threading

    start = _rss()
    peaks = dict(start)
    done = threading.Event()

    def sample():
        while not done.wait(every_s):
            for k, v in _rss().items():
                peaks[k] = max(peaks[k], v)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield peaks
    finally:
        done.set()
        t.join()
        for k, v in _rss().items():
            peaks[k] = max(peaks[k], v)
        peaks.update({f"{k}_at_start": v for k, v in start.items()})


def hf_export_full_depth(root: str = INTEROP_DIR) -> dict:
    """Not in the default run (~45 GB of disk, a few minutes): Llama-2-7B
    at full depth, random bf16 weights from SEED on the card, saved as a
    params-only port checkpoint, exported by ``export_hf_checkpoint``'s
    function (the checkpoint's file mapped, f32 written a layer at a time
    into 5-GB shards) and imported back onto the card, every tensor equal
    to the source; then exported again from the card's weights, where no
    file is mapped.  Logs the seconds and bytes of each step and the
    host's peak resident memory in each (its anonymous and file-backed
    parts where ``/proc`` reports them).

      python3 -c "import chip_smoke as c; c.hf_export_full_depth()"
    """
    import os
    import shutil

    import torch
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models import hf_io, registry
    from tensorflow_train_distributed_torch.models.export_hf import (
        export_hf_from_registry,
        export_llama,
    )
    from tensorflow_train_distributed_torch.models.import_hf import (
        import_llama,
    )
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < 45e9:
        raise RuntimeError(f"{free / 1e9:.1f} GB free under {root}; the "
                           "checkpoint and its export need ~45")
    cfg = registry.get_config("llama2_7b_sft")
    src = convert.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(SEED), device="cuda")
    ck, out = os.path.join(root, "ck_7b"), os.path.join(root, "hf_7b_full")
    shutil.rmtree(ck, ignore_errors=True)
    stats = dict(card=smi_line(),
                 config=f"llama2_7b_sft ({cfg.num_layers} layers)",
                 params=sum(v.numel() for v in src.values()))
    t0 = time.perf_counter()
    with _host_memory_peaks() as save_peaks:
        CheckpointManager(ck).save(0, {"params": src})
    stats.update(save_s=time.perf_counter() - t0,
                 checkpoint_bytes=hf_io.checkpoint_bytes(
                     os.path.join(ck, "0")), save_host_peaks=save_peaks)
    log(f"  saved: {json.dumps(stats)}")
    t0 = time.perf_counter()
    with _host_memory_peaks() as export_peaks:
        export_hf_from_registry("llama2_7b_sft", ck, out)
    stats.update(export_s=time.perf_counter() - t0,
                 export_bytes=hf_io.checkpoint_bytes(out),
                 export_shards=len([f for f in os.listdir(out)
                                    if f.endswith(".bin")]),
                 export_host_peaks=export_peaks)
    log(f"  exported: {json.dumps(stats)}")
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    with _host_memory_peaks() as import_peaks:
        _, imported = import_llama(out, cfg, device="cuda")
        torch.cuda.synchronize()
    stats.update(import_s=time.perf_counter() - t0,
                 import_host_peaks=import_peaks)
    same = set(imported) == set(src) and all(
        torch.equal(imported[k], v) for k, v in src.items())
    del imported
    _free()
    shutil.rmtree(out, ignore_errors=True)
    # From the card's weights: no file is mapped, so the resident growth
    # is the writer's own memory.
    t0 = time.perf_counter()
    with _host_memory_peaks() as card_peaks:
        export_llama(cfg, src, out)
    stats.update(export_from_card_s=time.perf_counter() - t0,
                 export_from_card_host_peaks=card_peaks)
    del src
    _free()
    shutil.rmtree(out, ignore_errors=True)
    log(f"  Llama-2-7B HF export at full depth: {json.dumps(stats)}")
    if not same:
        raise AssertionError("the full-depth import differs from the "
                             "exported weights")
    return stats


def _program_leg(root: str) -> dict:
    """(d): export_program of phase 16's mnist checkpoint, run on the
    card against predict_fn on the restored weights."""
    import os

    import numpy as np
    import torch
    from tensorflow_train_distributed_torch import export_program as EP
    from tensorflow_train_distributed_torch.data.datasets import (
        SyntheticMNIST,
    )
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    ck = os.path.abspath(MNIST_DIR)
    if not os.path.isdir(ck):
        # Run alone, without phase 16: its checkpoint takes ~3 s.
        phase_mnist()
    path = os.path.join(root, "mnist.pt2")
    t0 = time.perf_counter()
    EP.export_from_registry("mnist", ck, path)
    export_s = time.perf_counter() - t0
    served = EP.load_program(path, "cuda")
    task = registry.make_task(registry.get_entry("mnist"), device="meta")
    params = CheckpointManager(ck).restore_params()
    task.model.load_state_dict({k: v.to("cuda") for k, v in params.items()},
                               strict=True, assign=True)
    task.model.eval()
    src = SyntheticMNIST(num_examples=256)
    errs = {}
    for n in (128, 37):
        batch = {k: torch.as_tensor(np.stack([src[i][k] for i in range(n)]),
                                    device="cuda") for k in src[0]}
        with torch.no_grad():
            want = task.predict_fn(batch)
        got = served(batch)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.allclose(
                got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"(d) the program at batch {n} is not "
                                 f"predict_fn's")
        errs[n] = (got - want).abs().max().item()
    stats = dict(card=smi_line(), export_s=export_s,
                 program_bytes=os.path.getsize(path),
                 max_abs_err_by_batch=errs, tolerance="1e-5 (rtol, atol)")
    log(f"  (d) export_program mnist: {json.dumps(stats)}")
    return stats


def phase_interop(phase11_eval=None) -> tuple:
    """Phase 24 (the module docstring): returns ({path: launches} of
    vit_tiny, hf_train and hf_serve; the vit_tiny row of the kernels'
    line, K3 measured at its [8, 10]; the stats)."""
    import os
    import shutil

    import torch

    root = os.path.abspath(INTEROP_DIR)
    os.makedirs(root, exist_ok=True)
    legs, stats, counts = {}, {}, {}
    try:
        row = _cross_entropy_cases(
            torch.Generator(device="cuda").manual_seed(SEED + 24), 8, 10)
        for leg, fn in (("a", lambda: _vit_leg(root)),
                        ("b", lambda: _hf_launcher_leg(root, phase11_eval)),
                        ("c", lambda: _hf_engine_leg(root))):
            t0 = time.perf_counter()
            path = {"a": "vit_tiny", "b": "hf_train", "c": "hf_serve"}[leg]
            counts[path], stats[leg] = fn()
            legs[leg] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats["d"] = _program_leg(root)
        legs["d"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(os.path.abspath(SAMPLE_DIR), ignore_errors=True)
    stats["leg_s"] = legs
    log(f"  legs {json.dumps(legs)}")
    return counts, row, stats



# -- phase 25: multi-GPU code paths on one card -------------------------------

EP_KERNELS = ["gmm_ep", "tgmm_ep"]


def _gmm_ep_case(gen, label, kind, m, k, n, sizes, n_shards, *,
                 timing) -> dict:
    """K6-EP for one product of the MoE step (``kind`` as ``_gmm_case``)
    over ``n_shards`` expert shards of E / n_shards groups: each shard
    against the plain version with its offset within ``K.gmm_tolerance``,
    its rows outside the shard exactly 0; the shards' outputs summed
    (gmm) or concatenated (tgmm) against the unsharded kernel bit for
    bit.  Shard 0 is timed beside the unsharded kernel, its bound (the
    local rows' bytes and products, all m output rows written), the
    plain version and ``F.grouped_mm`` over the same local groups."""
    import torch
    import torch.nn.functional as F
    from tensorflow_train_distributed_torch.ops import kernels as K

    e = sizes.shape[0]
    local = e // n_shards
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    if kind == "fwd":
        a, w, out_dtype, depth = randn(m, k), randn(e, k, n), torch.float32, k
        operands, tensor_cores = (a, w), True

        def run(off=None, w_=w):
            return K.gmm_forward(a, w_, sizes, out_dtype, False,
                                 group_offset=off)

        def plain(aa, ww, dt, off):
            return K.gmm_reference(aa, ww, sizes, preferred_element_type=dt,
                                   group_offset=off)
    elif kind == "grad_lhs":
        a, w = randn(m, n, dtype=torch.float32), randn(e, k, n)
        out_dtype, depth, tensor_cores = bf, n, False
        operands = (a, w)

        def run(off=None, w_=w):
            return K.gmm_forward(a, w_, sizes, out_dtype, True,
                                 group_offset=off)

        def plain(aa, ww, dt, off):
            return K.gmm_reference(aa, ww, sizes, preferred_element_type=dt,
                                   transpose_rhs=True, group_offset=off)
    else:
        a, c = randn(m, k), randn(m, n, dtype=torch.float32)
        out_dtype, tensor_cores = bf, False
        operands = (a, c)

        def run(off=None, w_=None):
            return K.tgmm_forward(a, c, sizes, out_dtype, group_offset=off,
                                  num_actual_groups=None if off is None
                                  else local)

        def plain(aa, cc, dt, off):
            return K.tgmm_reference(aa.t(), cc, sizes,
                                    preferred_element_type=dt,
                                    group_offset=off,
                                    num_actual_groups=local)
    body = (K.gmm_body(a, w, kind == "grad_lhs") if kind != "tgmm"
            else K.tgmm_body(a, c))
    full = run()
    spans = K._group_spans(sizes, m)
    parts, errs = [], []
    for s in range(n_shards):
        off = s * local
        w_local = None if kind == "tgmm" else w[off:off + local].contiguous()
        got = run(off, w_local)
        ops = (a, w_local) if kind != "tgmm" else (a, c)
        ref32 = plain(*ops, torch.float32, off)
        sumsq32 = plain(*(t.float() ** 2 for t in ops), torch.float32, off)
        ref = plain(*ops, out_dtype, off)
        if kind == "tgmm":
            d = torch.tensor([end - start for g, start, end in spans
                              if off <= g < off + local],
                             dtype=torch.float32, device="cuda")[:, None, None]
        else:
            d = depth
        allowed = K.gmm_tolerance(got, ref32, sumsq32, d, tensor_cores)
        what = f"{kind} {label} shard {s}/{n_shards} (experts {off}-" \
               f"{off + local - 1})"
        _check(f"{what} vs f32", got, ref32, allowed,
               f"K.gmm_tolerance, {'tensor cores' if tensor_cores else 'f32'}")
        errs.append(_check(f"{what} vs its plain version", got, ref,
                           (ref.float() - ref32).abs() + allowed,
                           "|plain - ref32| + the above"))
        if kind != "tgmm":
            r0, r1 = spans[off][1], spans[off + local - 1][2]
            outside = torch.cat([got[:r0], got[r1:]])
            if outside.any():
                raise AssertionError(f"{what}: {int((outside != 0).sum())} "
                                     f"values outside the shard's rows "
                                     f"[{r0}, {r1}) are not 0 ({body} body)")
            parts.append(got)
        else:
            if not torch.equal(got, full[off:off + local]):
                raise AssertionError(
                    f"{what}: not its slice of the unsharded tgmm bit for "
                    f"bit ({body} body)")
        del ref32, sumsq32, ref, allowed
    if kind != "tgmm":
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        if not torch.equal(total, full):
            raise AssertionError(
                f"{kind} {label}: the {n_shards} shards summed differ from "
                f"the unsharded kernel ({int((total != full).sum())} values; "
                f"{body} body)")
        log(f"  {kind} {label}: {n_shards} shards summed equal the unsharded "
            f"kernel bit for bit ({body} body); rows outside each shard 0")
    else:
        log(f"  {kind} {label}: each of {n_shards} shards equals its slice "
            f"of the unsharded tgmm bit for bit ({body} body)")
    del parts
    # Shard 0: timed, with its bound and the library over its groups.
    off, r0 = 0, spans[0][1]
    r1 = spans[local - 1][2]
    rows = r1 - r0
    local_offs = torch.cumsum(sizes[:local], 0).to(torch.int32)
    w0 = None if kind == "tgmm" else w[:local].contiguous()
    el = 2 if out_dtype == bf else 4
    if kind == "fwd":
        nbytes = rows * k * 2 + local * k * n * 2 + m * n * el
        lib = lambda: F.grouped_mm(a[r0:r1], w0, offs=local_offs,
                                   out_dtype=out_dtype)
        near = lambda: F.grouped_mm(a[r0:r1], w0, offs=local_offs)
    elif kind == "grad_lhs":
        nbytes = rows * n * 4 + local * k * n * 2 + m * k * el
        lib = lambda: F.grouped_mm(a[r0:r1], w0.transpose(1, 2),
                                   offs=local_offs, out_dtype=out_dtype)
        near = None
    else:
        nbytes = rows * (k * 2 + n * 4) + local * k * n * el
        lib = lambda: F.grouped_mm(a[r0:r1].t(), c[r0:r1], offs=local_offs,
                                   out_dtype=out_dtype)
        near = None
    flops = 2 * rows * k * n
    bnd, _ = product_bound(nbytes + 4 * e, flops, not tensor_cores)
    row = dict(case=label, kind=kind, shards=n_shards, local_experts=local,
               local_rows=rows, body=body, max_abs_err=max(errs),
               ms=device_ms(lambda: run(0, w0), **timing),
               unsharded_ms=device_ms(run, **timing),
               plain_ms=device_ms(lambda: plain(
                   *((a, w0) if kind != "tgmm" else (a, c)), out_dtype, 0),
                   **timing),
               bound_ms=bnd[0], bound_by=bnd[1],
               library_ms=_library_ms(lib, **timing), near_library_ms=None)
    if near is not None and row["library_ms"] is None:
        row["near_library_ms"] = _library_ms(near, **timing)
    lib_txt = ("refused" if row["library_ms"] is None
               else f"{row['library_ms'] * 1e3:.1f} us")
    if row["near_library_ms"] is not None:
        lib_txt += f"; with a bf16 output {row['near_library_ms'] * 1e3:.1f} us"
    log(f"  {kind} {label} shard 0 of {n_shards} ({local} experts, {rows} of "
        f"{m} rows): {body} body {row['ms'] * 1e3:.1f} us, unsharded "
        f"{row['unsharded_ms'] * 1e3:.1f} us, bound {bnd[0] * 1e3:.1f} us "
        f"({bnd[1]}), plain {row['plain_ms'] * 1e3:.1f} us, F.grouped_mm "
        f"over its groups {lib_txt}")
    del full
    torch.cuda.empty_cache()
    return row


def phase_ep_kernels() -> tuple:
    """25 (a): K6-EP at Qwen1.5-MoE-A2.7B's width (4 shards of 15 of 60
    experts, 4,096 tokens x top-4) and at moe_370m's training shapes (2
    and 4 shards of 8).  Returns (the kernels' JSON-line rows, measured at
    moe_370m's 4 shards, the shapes phase 25 (b) runs, and every case)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    cases = []
    timing = dict(launches=10, repeats=3, warmup=2)
    sizes = _routed_sizes(gen, 4096, 2048, 60, 4)
    for kind, k, n in (("fwd", 2048, 1408), ("grad_lhs", 2048, 1408),
                       ("tgmm", 2048, 1408)):
        cases.append(_gmm_ep_case(gen, "qwen15_moe_a27b", kind, 16384, k, n,
                                  sizes, 4, timing=timing))
    sizes = _routed_sizes(gen, 8 * 1024, 768, 8, 2)
    for shards in (2, 4):
        for kind in ("fwd", "grad_lhs", "tgmm"):
            cases.append(_gmm_ep_case(gen, "moe_370m 768->2048", kind, 16384,
                                      768, 2048, sizes, shards,
                                      timing=timing))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    at = [c for c in cases if c["case"].startswith("moe_370m")
          and c["shards"] == 4]
    rows = {"gmm_ep": next(c for c in at if c["kind"] == "fwd"),
            "tgmm_ep": next(c for c in at if c["kind"] == "tgmm")}
    return {k: {f: v[f] for f in keys} for k, v in rows.items()}, cases


def phase_ep_block(shards: int = 4) -> tuple:
    """25 (b): moe_370m's MoE block (gmm dispatch, b 8 x s 1024, bf16
    compute over f32 stacks) forward and backward, unsharded and with its
    expert group emulated in this process (E / ``shards`` experts a shard
    through ``moe.expert_rows(..., group_offset=e0)``, the rows summed
    where the expert-parallel path all-reduces them, ``combine_rows``).
    The output bit for bit, the tokens' gradient within relative L2 1e-4
    (phase 8b's f32 bound), each shard's stack gradients its slice bit
    for bit.  The K6-EP launch counts are zeroed just before the sharded
    drive and read just after.  Returns (counts, record)."""
    import dataclasses

    import torch
    from tensorflow_train_distributed_torch.models import moe
    from tensorflow_train_distributed_torch.ops import kernels as K

    cfg = dataclasses.replace(moe.MOE_PRESETS["moe_370m"], dispatch="gmm")
    e, d, f, top_k = cfg.num_experts, cfg.d_model, cfg.ffn_size, cfg.top_k
    local = e // shards
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    tokens = 8 * 1024
    x = torch.randn(tokens, d, generator=gen, device="cuda").to(cfg.dtype)
    router = torch.randn(d, e, generator=gen, device="cuda") / d ** 0.5
    probs = torch.softmax(x.float() @ router, -1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    gate_w = top_p / top_p.sum(-1, keepdim=True) if cfg.norm_topk_prob \
        else top_p
    stacks = [torch.randn(e, *shape, generator=gen, device="cuda")
              / shape[0] ** 0.5 for shape in ((d, f), (d, f), (f, d))]
    cot = torch.randn(tokens, d, generator=gen, device="cuda").to(cfg.dtype)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    flat, ws = leaf(x), [leaf(s) for s in stacks]
    want = moe._routed_ffn_rows(flat, top_e, gate_w, e,
                                *(w.to(cfg.dtype) for w in ws),
                                dtype=cfg.dtype)
    want.backward(cot)
    torch.cuda.synchronize()
    flat2 = leaf(x)
    locs = [[leaf(s[i * local:(i + 1) * local]) for s in stacks]
            for i in range(shards)]
    K.reset_launch_counts()
    outs = [moe.expert_rows(flat2, top_e, e, *(w.to(cfg.dtype) for w in lw),
                            dtype=cfg.dtype, group_offset=i * local)
            for i, lw in enumerate(locs)]
    rows = outs[0][0]
    for o, _ in outs[1:]:
        rows = rows + o
    got = moe.combine_rows(rows, outs[0][1], gate_w, dtype=cfg.dtype)
    got.backward(cot)
    torch.cuda.synchronize()
    counts = {k: K.launch_counts()[k] for k in EP_KERNELS}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in EP_KERNELS and v}
    want_counts = {"gmm_ep": 6 * shards, "tgmm_ep": 3 * shards}
    log(f"  (b) launches {counts} (expected {want_counts}); others {others}")
    if counts != want_counts or others:
        raise AssertionError(f"(b) K6-EP launches {counts}, others {others}")
    if not torch.equal(got, want):
        raise AssertionError(
            f"(b) the {shards} shards' block output differs from the "
            f"unsharded block ({int((got != want).sum())} values)")
    rel = ((flat2.grad.float() - flat.grad.float()).norm()
           / flat.grad.float().norm()).item()
    log(f"  (b) output bit for bit; tokens' gradient relative L2 "
        f"{rel:.3e} (bound 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError(f"(b) tokens' gradient relative L2 {rel}")
    for i, lw in enumerate(locs):
        for name, w, l in zip(("wi_gate", "wi_up", "wo"), ws, lw):
            if not torch.equal(l.grad, w.grad[i * local:(i + 1) * local]):
                raise AssertionError(f"(b) shard {i} {name} gradient is not "
                                     "its slice of the unsharded one")
    log(f"  (b) each shard's stack gradients equal their slices bit for bit")
    n_moe = -(-cfg.num_layers // cfg.moe_every)
    per_step = {k + "_ep": v for k, v in moe_launches_per_step(cfg).items()
                if k in ("gmm", "tgmm")}
    rec = dict(config="moe_370m block", tokens=tokens, shards=shards,
               local_experts=local, launches=counts, tokens_grad_rel_l2=rel,
               derived_launches_per_rank_per_training_step_at_dp_ep=per_step,
               moe_layers=n_moe)
    log(f"  (b) K6-EP launches a rank would make per training step at "
        f"dp_ep (expert 2 or 4 alike), derived by moe_launches_per_step, "
        f"not counted: {per_step}")
    del flat, flat2, ws, locs, outs, rows, got, want
    _free()
    return counts, rec


def _moe_370m_entry() -> dict:
    """The launcher's entry for moe_370m with the gmm dispatch (phase 8's
    model, ``SyntheticLM`` 8 x 1024 at vocab 32,000, adamw 1e-4 constant),
    strategy dp_ep as the JAX MoE entries."""
    import dataclasses

    from tensorflow_train_distributed_torch.models.moe import MOE_PRESETS

    return dict(config=dataclasses.replace(MOE_PRESETS["moe_370m"],
                                           dispatch="gmm"),
                dataset="lm",
                dataset_kwargs=dict(vocab_size=32_000, seq_len=1024),
                global_batch_size=8, learning_rate=1e-4,
                lr_schedule="constant", warmup_ratio=0.0, grad_clip_norm=1.0,
                strategy="dp_ep")


def _nccl_flags() -> list:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return ["--num-processes", "1", "--process-id", "0",
            "--coordinator-address", f"127.0.0.1:{port}"]


def phase_nccl_launcher(lora_losses: list) -> tuple:
    """25 (c): the launcher through ``init_process_group("nccl")`` at world
    size 1, in this process.  Returns (counts, record)."""
    from tensorflow_train_distributed_torch.models import registry

    import torch.distributed as dist

    rec = {}
    r = _in_process("llama2_7b_sft LoRA, nccl world 1, fsdp_tp",
                    *LORA_7B_FLAGS, *_nccl_flags())
    if "torch.distributed (nccl) initialized" not in r[2]:
        raise AssertionError("(c) the launcher did not join an nccl group:\n"
                             + r[2][-3000:])
    if dist.is_initialized():
        raise AssertionError("(c) the launcher left its process group up")
    losses = _losses("(c) llama2_7b_sft LoRA nccl", r[1])
    if losses != lora_losses:
        raise AssertionError(f"(c) llama2_7b_sft LoRA losses at nccl world 1 "
                             f"{losses} differ from phase 18's {lora_losses}")
    log(f"  (c) llama2_7b_sft LoRA under fsdp_tp at nccl world 1: "
        f"{len(losses)} losses equal phase 18's bit for bit")
    rec["llama2_7b_sft_lora"] = dict(losses=losses, step_ms=r[3]["step_ms"],
                                     wall_s=r[4])
    # The smoke's own entry lives in the registry for this leg only.
    registry._ENTRIES["moe_370m_lm_gmm"] = _moe_370m_entry()
    flags = ["--config", "moe_370m_lm_gmm", "--steps", "5", "--log-every",
             "1", "--seed", str(SEED), "--weight-decay", "0.1"]
    try:
        plain = _in_process("moe_370m plain", *flags)
        ep = _in_process("moe_370m nccl world 1, dp_ep, zero1, int8",
                         *flags, "--strategy", "dp_ep", "--zero1",
                         "--grad-quant", "int8", *_nccl_flags())
    finally:
        del registry._ENTRIES["moe_370m_lm_gmm"]
    if "no-op on a data=1 mesh" not in ep[2]:
        raise AssertionError("(c) no grad_quant data=1 warning:\n"
                             + ep[2][-3000:])
    a, b = _losses("(c) moe plain", plain[1]), _losses("(c) moe ep", ep[1])
    if a != b:
        raise AssertionError(f"(c) moe_370m losses at nccl world 1 {b} "
                             f"differ from the plain run's {a}")
    cfg = _moe_370m_entry()["config"]
    counts = _expect_launches("(c) moe_370m dp_ep", ep[3], {
        k: 5 * v for k, v in moe_launches_per_step(cfg).items()})
    log(f"  (c) moe_370m under dp_ep --zero1 --grad-quant int8 at nccl "
        f"world 1: 5 losses equal the plain run's bit for bit, the JAX "
        f"data=1 warning logged")
    rec["moe_370m_dp_ep"] = dict(losses=b, step_ms=ep[3]["step_ms"],
                                 plain_step_ms=plain[3]["step_ms"])
    return counts, rec


def phase_multi_gpu(lora_losses: list) -> tuple:
    """Phase 25: (a), (b), (c).  Returns (the ep_block path's counts, its
    kernel rows, the record)."""
    t0 = time.perf_counter()
    rows, cases = phase_ep_kernels()
    log(f"  (a) {time.perf_counter() - t0:.1f} s")
    counts, block = phase_ep_block()
    _, launcher = phase_nccl_launcher(lora_losses)
    rec = dict(card=smi_line(), ep_kernel_cases=cases, ep_block=block,
               nccl_world_1=launcher, seconds=time.perf_counter() - t0,
               unverified="multi-rank NCCL (dp/fsdp/tp/EP across cards, the "
                          "bus-bandwidth bench): this machine has one GPU")
    return counts, rows, rec


# -- phase 26 -----------------------------------------------------------------

SP_SHARDS = 4                      # the emulated seq group (a) and (b)
SP_SEQ = 16_384                    # 4,096 rows a shard
PP_STAGES, PP_MICRO = 4, 8         # (c): llama_125m, 3 layers a stage
SPLIT_TOL = 0.25                   # (d): phase 3's re-prefill bar


def _mistral_qkv(gen, s):
    """Mistral-7B's attention operands at sequence ``s``: q [1, 32, s, 128]
    pre-scaled by D^-0.5, k/v [1, 8, s, 128] and a cotangent, bf16 views
    of [B, S, H, D] storage (the model's layout)."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    def bshd(heads):
        return torch.randn(1, s, heads, 128, generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    q, k, v, do = bshd(32), bshd(8), bshd(8), bshd(32)
    return K.splash_scaled_q(q, 128 ** -0.5), k, v, do


def _emulated_ring(q, k, v, do, *, causal, window, sinks):
    """``parallel.ring_attention.ring_attention`` (the module's per-rank
    body) for each of ``SP_SHARDS`` ranks of one sequence in this process,
    one rank after another: each hop returns the block the ring would
    hand that rank (the previous rank's, by identity, so one autograd
    graph spans the ranks and the cotangents land where the reverse hops
    would take them), and the sinks' sum-broadcast returns shard 0's
    slice.  Each rank's forward and backward (its slice of ``do``) is
    timed on the device.  Returns (out, dq, dk, dv, ms per rank)."""
    import torch
    from tensorflow_train_distributed_torch.parallel import (
        ring_attention as RA,
    )

    n = SP_SHARDS
    w = q.shape[2] // n
    ql, kl, vl = _leaf(q, k, v)
    state = dict(rank=0, bcast=0, blocks=None)

    def ring_permute(x, group, shift=1):
        for blocks in state["blocks"]:
            for j, b in enumerate(blocks):
                if x is b:
                    return blocks[(j - shift) % n]
        raise AssertionError("(a) a hop of a block the ring does not hold")

    def broadcast_from(x, group, src=0):
        kind = state["bcast"] % 2
        state["bcast"] += 1
        return state["blocks"][kind][src][:, :, :x.shape[2]]

    saved = {name: getattr(RA, name) for name in (
        "ring_permute", "broadcast_from", "group_rank", "group_size")}
    RA.ring_permute, RA.broadcast_from = ring_permute, broadcast_from
    RA.group_size = lambda g: n
    RA.group_rank = lambda g: state["rank"]
    outs, ms = [], []
    try:
        for i in range(n):
            state["rank"] = i
            state["blocks"] = [[t[:, :, j * w:(j + 1) * w] for j in range(n)]
                               for t in (kl, vl)]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            o = RA.ring_attention(
                ql[:, :, i * w:(i + 1) * w], state["blocks"][0][i],
                state["blocks"][1][i], group="seq", causal=causal,
                softmax_scale=1.0, window=window, sinks=sinks)
            o.backward(do[:, :, i * w:(i + 1) * w])
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            outs.append(o.detach())
            del o
            torch.cuda.empty_cache()
    finally:
        for name, fn in saved.items():
            setattr(RA, name, fn)
    return torch.cat(outs, 2), ql.grad, kl.grad, vl.grad, ms


def phase_ring(gen) -> dict:
    """26 (a): the ring over 4 emulated shards at Mistral-7B's attention
    (B 1, H 32, KVH 8, D 128, bf16, S 16,384: 4,096 rows a shard), causal
    (3 hops) and window 4,096 with 4 sinks (1 hop and the sink block).
    Output and q/k/v gradients held to an f32 computation of the same
    function within phase 9's bf16 bar, 2^-7 (|ref32| + |terms|) + 1e-6,
    and against K2 (causal) or K7 (window) over the whole sequence within
    that plus the kernel's own distance from ref32."""
    import torch
    from tensorflow_train_distributed_torch.ops import kernels as K

    q, k, v, do = _mistral_qkv(gen, SP_SEQ)
    rec = {}
    for label, causal, window, sinks in (("causal", True, None, 0),
                                         ("window 4096 sinks 4", True, 4096,
                                          4)):
        ref, pairs = _flash_f32(q, k, v, do, causal, None, 1.0,
                                window=window, sinks=sinks)
        if window is None:
            kname = "K2"
            o, lse = K.flash_attention_forward(q, k, v, None, True, 1.0)
            grads = K.flash_attention_backward(q, k, v, o, lse, do, None,
                                               True, 1.0)
        else:
            kname = "K7"
            o, lse = K.splash_attention_forward(q, k, v, None, window, sinks)
            grads = K.splash_attention_backward(q, k, v, o, lse, do, None,
                                                window, sinks)
        kern = dict(zip(("out", "dq", "dk", "dv"), (o, *grads)))
        del o, lse, grads
        torch.cuda.synchronize()
        got = dict(zip(("out", "dq", "dk", "dv", "ms"), _emulated_ring(
            q, k, v, do, causal=causal, window=window, sinks=sinks)))
        errs = {}
        for name in ("out", "dq", "dk", "dv"):
            r32 = ref[name]
            allowed = 2 ** -7 * (r32.abs() + ref[name + "_t"]) + 1e-6
            rule = "2^-7 (|ref32| + |terms|) + 1e-6"
            _check(f"(a) ring {label} {name} vs f32", got[name], r32,
                   allowed, rule)
            errs[name] = _check(
                f"(a) ring {label} {name} vs {kname}", got[name], kern[name],
                (kern[name].float() - r32).abs() + allowed,
                f"|{kname} - ref32| + the above")
        log(f"  (a) ring {label}: ms per shard (forward and backward) "
            f"{[round(x, 1) for x in got['ms']]}; {pairs} visible pairs")
        rec[label] = dict(max_abs_err=errs, ms_per_shard=got["ms"],
                          pairs=pairs, shards=SP_SHARDS, seq=SP_SEQ)
        del ref, kern, got
        _free()
    del q, k, v, do
    _free()
    return rec


def phase_ulysses(gen) -> tuple:
    """26 (b): Ulysses' local attention on 4 emulated shards at the same
    shapes: each shard's 8 query heads and 2 kv heads over the whole
    sequence through the kernel dispatch (K7, window 4,096, 4 sinks),
    forward and backward; the K7 counts zeroed just before and read just
    after: 4 each.  The concatenated heads and their gradients must equal
    one K7 call over all 32 heads bit for bit (heads are independent, and
    a shard's heads are whole GQA groups).  Returns (counts, the ulysses
    rows, record)."""
    import torch
    from tensorflow_train_distributed_torch.ops import attention as TA
    from tensorflow_train_distributed_torch.ops import kernels as K

    q, k, v, do = _mistral_qkv(gen, SP_SEQ)
    hq, hk = 32 // SP_SHARDS, 8 // SP_SHARDS
    kw = dict(causal=True, window=4096, sinks=4, softmax_scale=1.0)
    leaves = [_leaf(q[:, i * hq:(i + 1) * hq], k[:, i * hk:(i + 1) * hk],
                    v[:, i * hk:(i + 1) * hk]) for i in range(SP_SHARDS)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    outs = []
    for i, (qi, ki, vi) in enumerate(leaves):
        o = TA.multihead_attention_kernel(qi, ki, vi, **kw)
        o.backward(do[:, i * hq:(i + 1) * hq])
        outs.append(o.detach())
    torch.cuda.synchronize()
    counts = {n: K.launch_counts()[n]
              for n in ("splash_attention", "splash_attention_bwd")}
    log(f"  (b) launches {counts} (expected 4 each)")
    if counts != {"splash_attention": 4, "splash_attention_bwd": 4}:
        raise AssertionError(f"(b) K7 launches {counts}")
    qa, ka, va = _leaf(q, k, v)
    whole = TA.multihead_attention_kernel(qa, ka, va, **kw)
    whole.backward(do)
    same = (torch.equal(torch.cat(outs, 1), whole)
            and torch.equal(torch.cat([l[0].grad for l in leaves], 1),
                            qa.grad)
            and torch.equal(torch.cat([l[1].grad for l in leaves], 1),
                            ka.grad)
            and torch.equal(torch.cat([l[2].grad for l in leaves], 1),
                            va.grad))
    log(f"  (b) the 4 shards' heads against one K7 call over all 32 heads "
        f"(bar: bit for bit): {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("(b) Ulysses' shards differ from one K7 call "
                             "over all heads")
    del q, k, v, do, leaves, outs, whole, qa, ka, va
    _free()
    row = _splash_case(gen, "ulysses shard (8 of 32 heads)", 1, hq, hk,
                       SP_SEQ, 128, 4096, 4, packed=False,
                       dtype=torch.bfloat16, timed=True, flex=False)
    _free()
    rows = {"splash_attention": {f: row[f] for f in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")},
        "splash_attention_bwd": dict(
            max_abs_err=row["max_abs_err_bwd"], ms=row["bwd_ms"],
            plain_ms=row["plain_bwd_ms"], bound_ms=row["bwd_bound_ms"],
            bound_by=row["bwd_bound_by"],
            library_ms=row["library_bwd_ms"])}
    return counts, rows, dict(launches=counts, bitwise=same, shard=row)


def gpipe_launches(stages: int, micro: int, per: int) -> dict:
    """K1f/K1b/K2/K3 launches of (c)'s emulated schedule under full remat.
    Forward: every stage runs all M + S - 1 ticks, bubble ticks included.
    Backward: the ticks whose outputs reach the harvested microbatches,
    M a stage (a rank's own graph also carries its bubble ticks' zero
    cotangents back through the ring; one process holds no such hop).
    Each emulated stage's forward ends in the final norm; one loss."""
    fwd = stages * (micro + stages - 1) * per
    bwd = stages * micro * per
    return {"flash_attention": fwd + bwd, "flash_attention_bwd": bwd,
            "rms_norm": 2 * (fwd + bwd) + stages,
            "rms_norm_bwd": 2 * bwd + 1, "cross_entropy": 1,
            "cross_entropy_bwd": 1}


class _EmulatedStages:
    """The collectives of ``parallel.pipeline`` for stages run one after
    another in this process: a hop hands stage s the tensor stage s-1
    sent at the same call (so one autograd graph spans the stages), stage
    0 the zeros it discards; the harvest is the last stage's own value;
    the replicated input and output need no transpose (one loss)."""

    def __init__(self, n):
        self.n, self.stage, self.sent = n, 0, [[] for _ in range(n)]

    def group_rank(self, group):
        return self.stage

    def group_size(self, group):
        return self.n

    def ring_permute(self, x, group, shift=1):
        mine = self.sent[self.stage]
        mine.append(x)
        if self.stage == 0:
            return x.detach().new_zeros(x.shape)
        return self.sent[self.stage - 1][len(mine) - 1]

    def broadcast_from(self, x, group, src=0):
        return x if self.stage == src else x.detach().new_zeros(x.shape)

    @staticmethod
    def replicated_input(x, group):
        return x

    replicated_output = replicated_input


def phase_gpipe() -> tuple:
    """26 (c): llama_125m at full width and depth (12 layers, 3 a stage)
    as 4 emulated GPipe stages, 8 microbatches of 1 x 2,048, bf16 compute
    over f32 params, through the module's tick schedule (each stage's
    forward the model's own pipelined forward, ``pipeline_stages`` with
    its collectives emulated), forward and backward; the loss and every
    parameter's gradient held to the plain depth loop on the same batch
    within phase 6b's bf16 bound (relative L2 3e-2); the counts zeroed
    just before and read just after, equal to ``gpipe_launches``."""
    import torch
    from torch import nn
    from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
    from tensorflow_train_distributed_torch.data.pipeline import (
        HostBatches,
        to_device,
    )
    from tensorflow_train_distributed_torch.models.llama import (
        LLAMA_PRESETS,
        CausalLmTask,
    )
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.ops.losses import (
        softmax_cross_entropy,
    )
    from tensorflow_train_distributed_torch.parallel import pipeline as PP
    from tensorflow_train_distributed_torch.training import optimizers
    from tensorflow_train_distributed_torch.training.mixed_precision import (
        Policy,
    )
    from tensorflow_train_distributed_torch.training.trainer import Trainer

    cfg = LLAMA_PRESETS["llama_125m"]
    per = cfg.num_layers // PP_STAGES
    src = SyntheticLM(num_examples=64, seq_len=2048, vocab_size=32_000)
    host = next(iter(HostBatches(src, PP_MICRO, seed=SEED)))
    trainer = Trainer(CausalLmTask(cfg, device="meta"), optimizers.sgd(0.0),
                      policy=Policy.from_name("mixed_bfloat16"),
                      device="cuda")
    state = trainer.create_state()
    params = list(state.params.values())
    batch = trainer.policy.cast_to_compute(to_device(host, "cuda"))
    want, loss_p, _ = trainer._microbatch_grads(params, batch, None)
    model = trainer.task.model
    layers = model.layers
    emu = _EmulatedStages(PP_STAGES)
    saved_c = PP.C
    PP.C = emu
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        for s in range(PP_STAGES):
            emu.stage = s
            model.layers = nn.ModuleDict(
                (str(i), layers[i]) for i in range(s * per, (s + 1) * per))
            model.pipeline = (None, PP_STAGES, s, PP_MICRO)
            logits = model(batch["tokens"]).float()
        loss, _ = softmax_cross_entropy(logits, batch["targets"])
        got = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
    finally:
        PP.C = saved_c
        model.layers, model.pipeline = layers, None
    wall = time.perf_counter() - t0
    counts = {n: K.launch_counts()[n] for n in LAUNCH_KERNELS}
    expect = gpipe_launches(PP_STAGES, PP_MICRO, per)
    log(f"  (c) launches {counts} (the schedule's {expect})")
    if counts != expect:
        raise AssertionError(f"(c) launches {counts} != {expect}")
    rel_loss = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    worst, worst_name = 0.0, ""
    for name, a, b in zip(state.params, got, want):
        rel = ((a.float() - b.float()).norm()
               / b.float().norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    log(f"  (c) loss pipeline {loss.item():.6f} depth loop "
        f"{loss_p.item():.6f} (relative {rel_loss:.2e}); worst leaf "
        f"{worst_name} relative L2 {worst:.3e} (bound 3e-2); forward and "
        f"backward {wall:.2f} s")
    if not (rel_loss <= 3e-2 and worst <= 3e-2):
        raise AssertionError(f"(c) pipeline vs depth loop: loss {rel_loss}, "
                             f"{worst_name} {worst}")
    rec = dict(stages=PP_STAGES, microbatches=PP_MICRO, layers_a_stage=per,
               ticks=PP.num_pipeline_ticks(PP_MICRO, PP_STAGES),
               launches=counts, loss=loss.item(), depth_loop_loss=
               loss_p.item(), worst_leaf=worst_name, worst_rel_l2=worst,
               wall_s=wall)
    del trainer, state, params, batch, want, got, logits, model, layers
    _free()
    return counts, rec


def _split_rank(rank: int, port: int, job_path: str, out_path: str) -> None:
    """One rank of (d), in its own process on the card: Llama-2-7B's
    phase-3 weights (seed 0) in a ``ServingEngine(mesh=)`` at tensor 2
    over gloo (c10d stages the card's tensors through the host), phase
    3's engine settings and requests; writes its record to
    ``out_path``."""
    import torch
    import torch.distributed as dist
    from tensorflow_train_distributed_torch import convert
    from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.runtime.mesh import (
        MeshConfig,
        build_mesh,
    )
    from tensorflow_train_distributed_torch.serving import ServingEngine

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = build_mesh(MeshConfig(data=1, tensor=2))
        config = dataclasses.replace(LLAMA_PRESETS["llama2_7b"],
                                     num_layers=job["layers"])
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        params = convert.init_params(config, gen, device="cuda")
        eng = ServingEngine(config, params, slots=8, chunk=8, cache_len=1024,
                            kv_block_size=16, record_logits=True,
                            overlap=False, prefill_budget=0, device="cuda",
                            mesh=mesh)
        del params
        _free()
        weights = sum(t.numel() * t.element_size()
                      for t in eng._model.state_dict().values())
        pool = eng._grids()[0].layers[0]["key_pool"]
        eng.submit([1] * 16, 2)
        eng.run()
        eng.stats.update(decode_steps=0, decode_s=0.0, prefill_s=0.0,
                         prefill_tokens=0)
        eng.decode_logits.clear()
        ready = time.perf_counter() - t0
        prompts, max_new = job["prompts"], job["max_new"]
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        steps = eng.stats["decode_steps"]
        for rid, p in zip(rids, prompts):
            toks = out[rid]
            if (len(toks) != len(p) + max_new or toks[:len(p)] != p
                    or not all(0 <= t < config.vocab_size for t in toks)):
                raise AssertionError(f"request {rid}: malformed output")
        if min(counts.values()) <= 0:
            raise AssertionError(f"a kernel of the path never ran: {counts}")
        if counts["paged_attention"] != config.num_layers * steps:
            raise AssertionError(
                f"paged_attention launches {counts['paged_attention']} != "
                f"layers x decode steps {config.num_layers * steps}")
        c = _consistency(eng, out, [(rids[i], prompts[i])
                                    for i in job["check"]], max_new,
                         SPLIT_TOL)
        # Phase 3's greedy tokens: each generated position against its
        # (the split sums every row-split product in two halves, so a
        # near-tie can turn and the request then follows another path).
        same, whole, first = 0, 0, []
        for rid, p, ref in zip(rids, prompts, job["tokens"]):
            gen, want = out[rid][len(p):], ref[len(p):]
            agree = [a == b for a, b in zip(gen, want)]
            same += sum(agree)
            whole += int(all(agree))
            first.append(agree.index(False) if not all(agree) else None)
        rec = dict(rank=rank, launches=counts, decode_steps=steps,
                   wall_s=wall, ready_s=ready,
                   tokens_per_s=len(rids) * max_new / wall,
                   decode_ms_per_step=eng.stats["decode_s"] / steps * 1e3,
                   peak_mem_gib=peak / 2 ** 30, weights_gib=weights / 2 ** 30,
                   kv_pool_shape=list(pool.shape),
                   consistency=dict(worst=c["worst"], agree=c["agree"],
                                    total=c["total"], bar=c["bar"]),
                   phase3_generated_equal=same,
                   phase3_generated_total=len(rids) * max_new,
                   phase3_requests_equal=whole,
                   phase3_first_difference=first,
                   kv_stats=dict(eng.kv_stats))
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(rec, f)


def _split_kernel_rows(rms_row) -> dict:
    """K4 and K5 at a tensor rank's shapes (16 of Llama-2-7B's 32 heads x
    128; phase 2's 8 lanes of 64 blocks of 16 rows; K5 at the engine's
    one-lane radix hit), as phase 2 measures them; K1f's row is phase
    2's at [8, 4096], the same rows (the norm is over d_model, which the
    split keeps whole)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    lanes, heads, hd, bs, n_blk = 8, 16, 128, 16, 64
    nb = 1 + lanes * n_blk
    c = n_blk * bs
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    table = perm[:lanes * n_blk].view(lanes, n_blk).to(torch.int32)
    lengths = torch.randint(16, c - 1, (lanes,), generator=gen, device=dev,
                            dtype=torch.int32)
    q = torch.randn(lanes, 1, heads, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    kpool, vpool = (torch.randn(nb, bs, heads, hd, generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
    case = _paged_case("bf16, a tensor rank's 16 heads", q, kpool, vpool,
                       None, table, lengths, c)
    CASES.append(dict(case, kernel="paged_attention"))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    gather = _gather_case("bf16, a tensor rank's lane", kpool,
                          [table[i:i + 1] for i in range(lanes)], c, True)
    rows = {"rms_norm": rms_row,
            "paged_attention": {k: case[k] for k in keys},
            "paged_kv_gather": gather}
    del q, kpool, vpool
    _free()
    return rows


# (d) runs 16 of Llama-2-7B's 32 layers: the whole script's clock (its
# phases 1-25 took 1,015-1,125 s on the card's hosts) leaves no room for
# the full depth.
SPLIT_LAYERS = 16


def phase_split_serve(run3: dict, stats3: dict, rms_row,
                      layers: int = SPLIT_LAYERS) -> tuple:
    """26 (d): the tensor-split engine at tensor 2, two processes sharing
    the card over gloo (NCCL refuses two ranks on one device), Llama-2-7B
    at full width (16 heads and ffn 5,504 a rank) and ``layers`` layers,
    on phase 3's requests with its engine settings: phase 3's re-prefill
    bar on each rank, K4 launches = layers x decode steps a rank, each
    rank's peak memory beside phase 3's (whose engine has 32 layers),
    agreement with phase 3's tokens logged (a cut depth is another
    model: its tokens agree with phase 3's by chance alone).  Returns
    (rank 0's counts, the split_serve rows, record)."""
    _free()
    tmp = os.path.join(os.getcwd(), "_split_smoke")      # git-ignored
    os.makedirs(tmp, exist_ok=True)
    job = os.path.join(tmp, "job.json")
    with open(job, "w") as f:
        json.dump(dict(prompts=run3["prompts"], tokens=run3["tokens"],
                       max_new=run3["max_new"], check=[1, 5],
                       layers=layers), f)
    port = int(_nccl_flags()[-1].rsplit(":", 1)[1])
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        cmd = [sys.executable, "-c",
               f"import chip_smoke as c; c._split_rank({rank}, {port}, "
               f"{job!r}, {os.path.join(tmp, f'rank{rank}.json')!r})"]
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.getcwd(),
                     OMP_NUM_THREADS="4")))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines()[-40:]:
            log(f"    [rank {rank}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"(d) rank {rank} exited {p.returncode}")
    recs = []
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            recs.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    for r in recs:
        log(f"  (d) rank {r['rank']}: launches {r['launches']}, decode "
            f"steps {r['decode_steps']}, {r['decode_ms_per_step']:.1f} ms a "
            f"step (phase 3: {stats3['decode_ms_per_step']:.1f}), peak "
            f"{r['peak_mem_gib']:.2f} GiB (phase 3's one-card engine: "
            f"{stats3['peak_mem_gib']:.2f}), weights {r['weights_gib']:.2f} "
            f"GiB, pool {r['kv_pool_shape']}, re-prefill worst "
            f"{r['consistency']['worst']:.4f} (bar {SPLIT_TOL}); generated "
            f"tokens equal to phase 3's {r['phase3_generated_equal']}/"
            f"{r['phase3_generated_total']}, requests whole "
            f"{r['phase3_requests_equal']}/{len(r['phase3_first_difference'])}"
            f", first difference at {r['phase3_first_difference']}")
    if recs[0]["launches"] != recs[1]["launches"]:
        raise AssertionError(f"(d) the ranks' launches differ: "
                             f"{[r['launches'] for r in recs]}")
    log(f"  (d) {wall:.1f} s for both processes (start, weights, warm-up, "
        f"requests, checks)")
    rows = _split_kernel_rows(rms_row)
    rec = dict(ranks=recs, wall_s=wall, layers=layers, tensor=2,
               collective_backend="gloo (card tensors staged through the "
                                  "host)", phase3=dict(
                   decode_ms_per_step=stats3["decode_ms_per_step"],
                   peak_mem_gib=stats3["peak_mem_gib"]))
    return recs[0]["launches"], rows, rec


def phase_parallel(run3: dict, stats3: dict, rms_row) -> tuple:
    """Phase 26: (a) ring, (b) Ulysses, (c) GPipe, (d) the tensor-split
    engine.  Returns (path counts, kernel rows, record)."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    rec = dict(card=smi_line())
    rec["ring"] = phase_ring(gen)
    log(f"  (a) {time.perf_counter() - t0:.1f} s")
    ul_counts, ul_rows, rec["ulysses"] = phase_ulysses(gen)
    log(f"  (b) {time.perf_counter() - t0:.1f} s")
    rec["gpipe_launches"], rec["gpipe"] = phase_gpipe()
    log(f"  (c) {time.perf_counter() - t0:.1f} s")
    split_counts, split_rows, rec["split_serve"] = phase_split_serve(
        run3, stats3, rms_row)
    rec["seconds"] = time.perf_counter() - t0
    rec["unverified"] = ("multi-rank NCCL for seq, pipeline and tensor-split "
                         "serving: this machine has one GPU")
    log(f"  phase 26: {rec['seconds']:.1f} s")
    return ({"ulysses": ul_counts, "split_serve": split_counts},
            {"ulysses": ul_rows, "split_serve": split_rows}, rec)


BENCH_DIR = "_bench_smoke"         # git-ignored; deleted at phase 27's end
# (tool, arguments) of phase 27's in-process runs: each model at the size
# the bench tools' defaults run it, cut to 2 warm-up and 3 timed steps or
# a few requests.
BENCH_RUNS = (
    ("bench_lm", ["--preset", "llama_125m", "--batch-per-chip", "8",
                  "--seq", "2048", "--warmup", "2", "--iters", "3",
                  "--profile-dir", os.path.join(BENCH_DIR, "lm_trace")]),
    ("bench_moe", ["--preset", "moe_370m", "--dispatch", "gmm",
                   "--batch-per-chip", "8", "--seq", "1024", "--warmup", "2",
                   "--iters", "3"]),
    ("bench_bert", ["--preset", "bert_base", "--batch-per-chip", "32",
                    "--seq", "128", "--warmup", "2", "--iters", "3"]),
    ("bench_vit", ["--preset", "vit_b16", "--batch-per-chip", "64",
                   "--warmup", "2", "--iters", "3"]),
    ("bench_generate", ["--preset", "llama_125m", "--batch", "8",
                        "--prompt-len", "128", "--max-new", "32",
                        "--warmup", "1", "--iters", "2"]),
    ("bench_serving", ["--preset", "llama_125m", "--requests", "8",
                       "--prompt-range", "16,64", "--new-range", "16,32",
                       "--reps", "1"]),
    ("bench_gateway", ["--preset", "llama_125m", "--clients", "2",
                       "--requests-per-client", "2", "--no-ab"]),
)


def _bench_tool(name: str, argv: list) -> dict:
    """``tools/<name>.py``'s main in this process, its record parsed from
    the last line it printed; it must succeed on this card under the
    script's card lock ("inherited")."""
    import importlib
    import io

    import torch

    mod = importlib.import_module(
        f"tensorflow_train_distributed_torch.tools.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv + ["--device", "cuda"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec["seconds"] = time.perf_counter() - t0
    log(f"  {name}: {json.dumps(rec)}")
    if rc != 0 or rec.get("error"):
        raise AssertionError(f"{name}: rc {rc}, {rec.get('error')}")
    if (rec.get("card_lock") != "inherited"
            or rec.get("device_kind") != torch.cuda.get_device_name(0)):
        raise AssertionError(f"{name}: lock {rec.get('card_lock')}, "
                             f"device {rec.get('device_kind')}")
    if not (isinstance(rec["value"], float) and math.isfinite(rec["value"])
            and rec["value"] > 0):
        raise AssertionError(f"{name}: rate {rec['value']}")
    if "mfu" in rec and not 0 < rec["mfu"] < 1:
        raise AssertionError(f"{name}: MFU {rec['mfu']} outside (0, 1)")
    if "mbu" in rec and not 0 < rec["mbu"] <= 1:
        raise AssertionError(f"{name}: MBU {rec['mbu']} outside (0, 1]")
    return rec


def phase_bench(phase6_step_ms: float) -> dict:
    """Phase 27: the bench tools (``tensorflow_train_distributed_torch/
    tools/``) on the card, under the card lock this script holds: each
    tool of ``BENCH_RUNS`` in this process, then ``tools/bench.py
    --families lm`` in a process of its own, whose family subprocess
    inherits the lock; ``profile_summary`` on the trace ``bench_lm
    --profile-dir`` wrote.  Every rate finite, every MFU in (0, 1) and
    MBU in (0, 1]; bench_lm's step within 1.5x of phase 6's (the same
    batch, sequence, policy and remat; host-bound figures move by up to
    that much); the summary's kinds ``_profile_train_step``'s."""
    from tensorflow_train_distributed_torch.runtime import chip_lock
    from tensorflow_train_distributed_torch.tools import profile_summary

    t0 = time.perf_counter()
    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    try:
        out = {"card": smi_line(), "lock_holder": chip_lock.lock_holder()}
        if out["lock_holder"] != os.getpid():
            raise AssertionError(f"the card lock's holder is "
                                 f"{out['lock_holder']}, not this script")
        for name, argv in BENCH_RUNS:
            out[name] = _bench_tool(name, argv)
        ratio = out["bench_lm"]["step_time_ms"] / phase6_step_ms
        out["bench_lm_vs_phase6"] = ratio
        if not 1 / 1.5 <= ratio <= 1.5:
            raise AssertionError(f"bench_lm's step is {ratio:.2f}x phase "
                                 f"6's {phase6_step_ms:.1f} ms")
        summary = profile_summary.summarize(out["bench_lm"]["trace"])
        out["profile_summary"] = {k: v for k, v in summary.items()
                                  if k != "trace"}
        log(f"  profile_summary: {json.dumps(out['profile_summary'])}")
        busy = {k for k, v in summary["kinds"].items()
                if v["ms_per_step"] > 0}
        want = {"matmul", "flash_attention", "flash_attention_bwd",
                "cross_entropy", "rms_norm"}
        if (set(summary["kinds"]) != set(KINDS) or not want <= busy
                or summary["steps"] != 2
                or not 0 < summary["busy_share"] <= 1):
            raise AssertionError(f"profile_summary: steps "
                                 f"{summary['steps']}, kinds {busy}")
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "tensorflow_train_distributed_torch.tools.bench",
             "--families", "lm"], capture_output=True, text=True,
            timeout=600)
        lines = proc.stdout.strip().splitlines()
        head = json.loads(lines[-1])
        full = json.loads(lines[-2])
        fam = full["configs"]["llama_125m"]
        out["bench_py"] = dict(rc=proc.returncode, headline=head,
                               headline_bytes=len(lines[-1]),
                               card_lock=full.get("card_lock"),
                               family_card_lock=fam.get("card_lock"),
                               seconds=time.perf_counter() - t1)
        log(f"  bench.py --families lm: {json.dumps(out['bench_py'])}")
        if (proc.returncode != 0 or len(lines[-1]) >= 500
                or head["metric"] != "llama_125m_train_tokens_per_sec"
                or not head["value"] > 0
                or full.get("card_lock") != "inherited"
                or fam.get("card_lock") != "inherited"):
            raise AssertionError(f"bench.py: rc {proc.returncode}, "
                                 f"{proc.stderr[-2000:]}")
    finally:
        shutil.rmtree(BENCH_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 27: {out['seconds']:.1f} s")
    return out


# Phase 28 (b): steps a leg of bench_grad_quant at llama_125m (the first
# is left out of its times).  Cut first if the script nears its limit.
GQ_STEPS = 4
GQ_FLAGS = ["--preset", "llama_125m", "--batch", "8", "--seq", "2048",
            "--policy", "mixed_bfloat16", "--steps", str(GQ_STEPS)]
GQ_SPANS = ("train/data_wait", "train/step_dispatch", "train/host_callbacks")


def _tool_lines(name: str, argv: list) -> tuple:
    """``tools/<name>.py``'s main in this process: (rc, its printed JSON
    lines, seconds)."""
    import importlib
    import io

    mod = importlib.import_module(
        f"tensorflow_train_distributed_torch.tools.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv + ["--device", "cuda"])
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()
             if x.startswith("{")]
    return rc, lines, time.perf_counter() - t0


def _native_tool(name: str, argv: list) -> dict:
    import torch

    rc, lines, secs = _tool_lines(name, argv)
    rec = dict(lines[-1], seconds=secs)
    log(f"  {name} {' '.join(argv)}: {json.dumps(rec)}")
    if (rc != 0 or rec.get("error") or rec.get("card_lock") != "inherited"
            or rec.get("device_kind") != torch.cuda.get_device_name(0)):
        raise AssertionError(f"{name}: rc {rc}, {rec}")
    return rec


def phase_native_tools() -> tuple:
    """Phase 28: (a) the native ring and bench_allreduce, (b)
    bench_grad_quant at llama_125m, (c) bench_input's decode legs.
    Returns ({"grad_quant": counts}, the record)."""
    import torch
    from tensorflow_train_distributed_torch.data import image as I
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.tools import bench_grad_quant

    t0 = time.perf_counter()
    out = {"card": smi_line(), "native_build": NATIVE_BUILD}
    # (a)
    host = _native_tool("bench_allreduce", ["--host", "--world", "4"])
    if not (host["devices"] == 4 and host["value"] > 0):
        raise AssertionError(f"(a) host ring: {host}")
    dev = _native_tool("bench_allreduce", ["--world", "1"])
    if not (dev["backend"] == "nccl" and dev["devices"] == 1
            and dev["value"] is None and dev["bus_bandwidth_gbps"] is None
            and dev["copy_gbps"] > 0 and "copy" in dev["note"]):
        raise AssertionError(f"(a) the one-rank device leg: {dev}")
    out["allreduce"] = {"host_ring_world4": host, "device_nccl_world1": dev}
    # (b)
    K.reset_launch_counts()
    rc, lines, secs = _tool_lines("bench_grad_quant", GQ_FLAGS)
    counts = {k: K.launch_counts()[k] for k in TRAIN_KERNELS}
    others = {k: v for k, v in K.launch_counts().items()
              if k not in TRAIN_KERNELS and v}
    rec, head = lines[-2], lines[-1]
    head_bytes = len(json.dumps(head))
    legs = rec["legs"]
    log(f"  bench_grad_quant: {json.dumps(head)} ({head_bytes} bytes, "
        f"{secs:.1f} s); resolved "
        f"{ {k: v['grad_quant'] for k, v in legs.items()} }")
    for name, leg in dict(legs, ks=rec["killswitch"]).items():
        log(f"    {name}: losses {leg.get('losses')} ms a step "
            f"{leg['wall_per_step_ms']} spans {leg['span_counts']}")
        bad = {k: leg["span_counts"].get(k) for k in GQ_SPANS
               if leg["span_counts"].get(k) != GQ_STEPS}
        if bad:
            raise AssertionError(f"(b) {name}'s spans {bad}")
    if (rc != 0 or not head["passed"] or head_bytes >= 500
            or not rec["killswitch"]["bitwise_equal_to_none"]
            or not rec["loss_parity"]["within_tol"]
            or rec["card_lock"] != "inherited"):
        raise AssertionError(f"(b) bench_grad_quant: rc {rc}, {head}")
    want = {k: 4 * GQ_STEPS * v
            for k, v in train_launches_per_step(12).items()}
    log(f"  launches {counts} (expected {want}); others {others}")
    if counts != want or others:
        raise AssertionError(f"(b) launches {counts}, others {others}; "
                             f"expected {want}")
    out["grad_quant"] = dict(
        headline=head, headline_bytes=head_bytes, seconds=secs,
        ms={k: v["wall_per_step_ms"] for k, v in legs.items()},
        ks_ms=rec["killswitch"]["wall_per_step_ms"],
        resolved={k: v["grad_quant"] for k, v in legs.items()},
        losses={k: v["losses"] for k, v in legs.items()},
        tol=bench_grad_quant.LOSS_PARITY_TOL)
    # (c)
    inp = _native_tool("bench_input", ["--records", "512", "--workers", ""])
    if not (all(v > 0 for v in inp["decode_modes"].values())
            and len(inp["decode_modes"]) == 5
            and inp["native"]["decoder"] in ("libjpeg", "pil")):
        raise AssertionError(f"(c) bench_input: {inp}")
    out["input"] = dict(decode_modes=inp["decode_modes"],
                        modes=inp["modes"], native=inp["native"],
                        decode_image=list(I.decoder()),
                        seconds=inp["seconds"])
    log(f"  decode_image: {I.decoder()}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 28: {out['seconds']:.1f} s")
    return {"grad_quant": counts}, out


# Phase 29 (a)'s own runs: (config, layers, batch, seq, remat).  Phase 6
# pins the head's backward under full remat, phase 10 the optimizer's
# update; these pin the blocks without remat and the head at Mistral's
# width.
PLAN_RUNS = (("llama_125m_lm", 12, 16, 2048, False),
             ("mistral_7b_lm", 2, 8, 8192, True))
DEBUG_POISON = "layers.3.attention.query.kernel"


def phase_planner_debug(peaks=None) -> tuple:
    """Phase 29.  ``peaks``: {"phase 6": GiB, "phase 10": GiB}, each
    training phase's peak above what the process held before its trainer
    was built (alone, (a) has its own runs only).  Returns ({"debug":
    counts}, the record)."""
    import numpy as np
    import torch
    from tensorflow_train_distributed_torch.models import registry
    from tensorflow_train_distributed_torch.ops import kernels as K
    from tensorflow_train_distributed_torch.runtime import debug as D
    from tensorflow_train_distributed_torch.runtime.lint import run_lint
    from tensorflow_train_distributed_torch.tools import (
        memory_calibration as MC,
    )
    from tensorflow_train_distributed_torch.training import memory as M

    t0 = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    out = {"card": smi_line(), "margin": M.PLAN_MARGIN}
    # (a) the planner against the card
    points = [(src, *cfg) for src, cfg in (
        ("phase 6", ("llama_125m_lm", 12, 8, 2048, True)),
        ("phase 10", ("mistral_7b_lm", 4, 8, 8192, True)))
        if peaks and src in peaks]
    points += [("phase 29", *run) for run in PLAN_RUNS]
    rows = []
    for src, name, layers, b, s, remat in points:
        if src == "phase 29":
            # The calibration's own measurement: 2 fit steps, the peak
            # above what the process held before the trainer was built.
            rec = MC.measure(name, layers, b, s, remat, fwd_bwd=False)
            _free()
            if not all(math.isfinite(x) for x in rec["losses"]):
                raise AssertionError(f"(a) {name}: non-finite loss {rec}")
            measured = rec["peak_fit"] / 2 ** 30
        else:
            measured = peaks[src]
        plan = MC.plan(dict(config=name, layers=layers, batch=b, seq=s,
                            remat=remat), device_name=card)
        est = plan["step_bytes_per_device"] / 2 ** 30
        row = dict(source=src, config=name, layers=layers, batch=b, seq=s,
                   remat=remat, measured_gib=measured, estimate_gib=est,
                   error=(est - measured) / measured,
                   phase=plan["peak_phase"], fits=plan["fits"])
        log(f"  (a) {src} {name} L{layers} {b} x {s} remat {remat}: "
            f"measured {measured:.3f} GiB, plan {est:.3f} GiB "
            f"({100 * row['error']:+.2f}%, {plan['peak_phase']})")
        if est < measured * (1 - M.PLAN_MARGIN) or not plan["fits"]:
            raise AssertionError(f"(a) the plan says fits below the card's "
                                 f"peak by more than the margin: {row}")
        rows.append(row)
    before = torch.cuda.memory_allocated()
    task = registry.make_task(registry.get_entry("llama2_7b_sft"),
                              device="meta")
    big = M.plan_train_memory(task, {"tokens": np.zeros((2, 4096),
                                                        np.int32)},
                              "adamw", device_name=card)
    allocated = torch.cuda.memory_allocated() - before
    log(f"  (a) llama2_7b_sft full fine-tune: state "
        f"{big['state_bytes_per_device'] / 1e9:.1f} GB, step "
        f"{big['step_bytes_per_device'] / 1e9:.1f} GB of "
        f"{big['budget_bytes'] / 1e9:.0f}: fits {big['fits']}; "
        f"{allocated} bytes allocated")
    if big["fits"] or allocated:
        raise AssertionError(f"(a) llama2_7b full fine-tune: fits "
                             f"{big['fits']}, {allocated} bytes allocated")
    out["plan"] = rows
    out["llama2_7b_full_ft"] = dict(
        params=big["param_elements"],
        state_gb=big["state_bytes_per_device"] / 1e9,
        step_gb=big["step_bytes_per_device"] / 1e9, fits=big["fits"])
    out["plan_s"] = time.perf_counter() - t0
    # (b) debug mode, one llama_125m step at 1 x 2048
    t1 = time.perf_counter()
    name = "llama_125m_lm"
    cfg = registry.get_entry(name)["config"]
    at = (name, cfg.num_layers, 1, 2048, cfg.remat, 1)

    def step(debug: bool, poison: bool = False):
        _, trainer, batches = MC.trainer(*at)
        state = trainer.create_state()
        if poison:
            with torch.no_grad():
                state.params[DEBUG_POISON][5, :] = float("nan")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t = time.perf_counter()
        try:
            if debug:
                with D.debug_mode():
                    state, history = trainer.fit(batches, steps=1,
                                                 state=state)
            else:
                state, history = trainer.fit(batches, steps=1, state=state)
            torch.cuda.synchronize()
        finally:
            counts = K.launch_counts()
        return (state, history, time.perf_counter() - t, counts)

    plain, plain_hist, plain_s, _ = step(False)
    debugged, debug_hist, debug_s, counts = step(True)
    same_loss = plain_hist[0][1]["loss"] == debug_hist[0][1]["loss"]
    same_params = all(torch.equal(v, debugged.params[k])
                      for k, v in plain.params.items())
    counts = {k: v for k, v in counts.items() if v}
    want = train_launches_per_step(12)
    log(f"  (b) a clean step: loss {plain_hist[0][1]['loss']:.6f} plain, "
        f"{debug_hist[0][1]['loss']:.6f} under debug_mode; parameters "
        f"equal {same_params}; {plain_s * 1e3:.1f} ms plain, "
        f"{debug_s * 1e3:.1f} ms under debug_mode "
        f"({debug_s / plain_s:.1f}x); launches {counts} (expected {want})")
    if not (same_loss and same_params):
        raise AssertionError("(b) a step under debug_mode differs from the "
                             "same step without it")
    if counts != want:
        raise AssertionError(f"(b) debug step launches {counts}; expected "
                             f"{want}")
    del plain, debugged
    _free()
    poisoned = None
    try:
        poisoned = step(True, poison=True)
        message = None
    except FloatingPointError as e:
        message = str(e)
    log(f"  (b) a NaN row in {DEBUG_POISON}: {message}")
    if poisoned is not None or "the flash_attention kernel" not in message:
        raise AssertionError(f"(b) the poisoned step did not name "
                             f"flash_attention: {message}")
    _, trainer, _ = MC.trainer(*at)
    state = trainer.create_state()
    leaf = state.params[DEBUG_POISON]
    with torch.no_grad():
        leaf[5, :] = float("nan")
    try:
        D.assert_tree_finite(state.params, "params")
        tree = None
    except FloatingPointError as e:
        tree = str(e)
    log(f"  (b) assert_tree_finite: {tree!r}")
    want = f"{DEBUG_POISON}: {leaf.shape[1]}/{leaf.numel()} non-finite"
    if tree is None or want not in tree.splitlines()[1:][0]:
        raise AssertionError(f"(b) assert_tree_finite: {tree!r}")
    del trainer, state
    _free()
    out["debug"] = dict(step_ms=plain_s * 1e3, debug_step_ms=debug_s * 1e3,
                        slowdown=debug_s / plain_s,
                        loss=plain_hist[0][1]["loss"], bitwise=True,
                        launches=counts, poisoned=message, tree=tree,
                        seconds=time.perf_counter() - t1)
    # (c) the static lint, in process
    t2 = time.perf_counter()
    findings = run_lint()
    lint_s = time.perf_counter() - t2
    log(f"  (c) ttd_lint over the port and chip_smoke.py: "
        f"{len(findings)} findings, {lint_s:.1f} s")
    if findings:
        raise AssertionError("(c) ttd_lint: " + "; ".join(
            f.format() for f in findings[:10]))
    out["lint"] = dict(findings=0, seconds=lint_s)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 29: {out['seconds']:.1f} s")
    return {"debug": {k: counts.get(k, 0) for k in TRAIN_KERNELS}}, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an H100",
              file=sys.stderr)
        return 2
    try:
        from tensorflow_train_distributed_torch.models.llama import (
            LLAMA_PRESETS,
        )
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    from tensorflow_train_distributed_torch.runtime.chip_lock import (
        chip_lock,
    )

    # The card lock, for the whole script: no bench of this card's host
    # times beside it (phase 27's tools inherit it).
    with chip_lock():
        return _phases()


def _phases() -> int:
    import torch
    from tensorflow_train_distributed_torch.models.llama import LLAMA_PRESETS

    _FRESH_FLAGS.update(_backend_flags())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    open(LOG_PATH, "w").close()
    engines = {}
    log("== phase 1: device and build")
    phase_device()
    log("== phase 2: kernels against their plain versions")
    rows = {"serve": phase_kernels()}
    log("== phase 3: serving engine, llama2_7b full width and depth")
    counts, stats, run3 = phase_engine(
        LLAMA_PRESETS["llama2_7b"], label="llama2_7b_sft bf16",
        n_requests=12, max_new=32, lo=16, hi=300, check_requests=[1, 5],
        tol=0.25, profile_chunk=True, linear_leg=True)
    engines["llama2_7b_bf16"] = stats
    _free()
    log("== phase 3 (autosize): serve.py --kv-pool-blocks auto under "
        "TTD_MEMCHECK=1")
    autosize_counts, engines["llama2_7b_autosize"] = phase_autosize(run3)
    log("== phase 4: int8 KV cache, full width, 4 layers")
    cfg = dataclasses.replace(LLAMA_PRESETS["llama2_7b"], num_layers=4,
                              kv_cache_int8=True)
    _, stats, _ = phase_engine(cfg, label="llama2_7b[4 layers] kv int8",
                            n_requests=6, max_new=16, lo=16, hi=200,
                            check_requests=[1], tol=0.25)
    engines["llama2_7b_4layers_kv_int8"] = stats
    torch.cuda.empty_cache()
    log("== phase 5: training kernels against their plain versions")
    train_rows = phase_train_kernels()
    rows["train"] = train_rows["train"]
    rows["debug"] = train_rows["debug"]
    log("== phase 6: trainer, llama_125m_lm full width and depth")
    train_counts, training = phase_train()
    torch.cuda.empty_cache()
    log("== phase 6b: gradients against the plain versions; card vs CPU")
    training["grad_check"] = phase_grad_check()
    training["card_vs_cpu"] = phase_card_vs_cpu()
    torch.cuda.empty_cache()
    log("== phase 7: grouped-matmul kernels against their plain versions")
    rows["moe_train"], moe_cases = phase_moe_kernels()
    log("== phase 8: MoE trainer, moe_370m gmm full width and depth")
    moe_counts, moe_training = phase_moe_train()
    torch.cuda.empty_cache()
    log("== phase 8b: MoE gradients against the plain versions; card vs "
        "CPU")
    moe_training["grad_check"] = phase_moe_grad_check()
    moe_training["card_vs_cpu"] = phase_moe_card_vs_cpu()
    torch.cuda.empty_cache()
    log("== phase 9: splash kernel against its plain version")
    rows["window_train"], window_cases = phase_window_kernels()
    rows["window_train"].update(train_rows["window_train"])
    log("== phase 10: windowed trainer, mistral_7b_lm full width, 4 layers")
    window_counts, window_training = phase_window_train()
    torch.cuda.empty_cache()
    log("== phase 10b: windowed gradients against the plain versions; card "
        "vs CPU")
    window_training["grad_check"] = phase_window_grad_check()
    window_training["card_vs_cpu"] = phase_window_card_vs_cpu()
    torch.cuda.empty_cache()
    log("== phase 11: the launcher, llama_125m_lm: run, kill -9, resume, "
        "eval-only, phase 6's flags")
    launch_counts, fused_counts, launcher = phase_launcher()
    launcher["trainer_step_ms_phase6"] = training["step_ms"]
    rows["launch"] = rows["launch_fused"] = {k: rows["train"][k]
                                             for k in LAUNCH_KERNELS}
    rows["linear_serve"] = {"rms_norm": rows["serve"]["rms_norm"]}
    rows["autosize_serve"] = rows["serve"]
    log("== phase 11 (LoRA): rank 8 run, kill -9, resume; serve the "
        "merged checkpoint")
    lora_counts, launcher["lora"] = phase_launcher_lora()
    torch.cuda.empty_cache()
    log("== phase 12: K2 full attention and K3 at the new families' shapes")
    rows["bert"], rows["wmt"], rows["mnist"] = phase_family_kernels()
    log("== phase 13: the launcher, bert_base_mlm: run, kill -9, resume")
    families = {}
    bert_counts, families["bert_base_mlm"] = phase_bert()
    log("== phase 14: the launcher, transformer_big_wmt: run, beam BLEU")
    wmt_counts, families["transformer_big_wmt"] = phase_wmt()
    log("== phase 15: the launcher, resnet50_imagenet (s2d, bnsub): run, "
        "kill -9, resume")
    families["resnet50_imagenet"] = phase_resnet()
    log("== phase 15 (data service): --data-workers, synthetic and JPEG")
    families["resnet50_imagenet"]["data_service"] = phase_resnet_service(
        families["resnet50_imagenet"])
    log("== phase 16: the launcher, mnist")
    mnist_counts, families["mnist"] = phase_mnist()
    torch.cuda.empty_cache()
    log("== phase 17: bert and resnet_tiny card vs CPU")
    families["card_vs_cpu"] = phase_family_card_vs_cpu()
    torch.cuda.empty_cache()
    log("== phase 18: llama2_7b_sft LoRA, full width and depth")
    rows["lora_launch"], rows["lora_7b"] = phase_lora_kernels(rows["train"])
    lora_7b_counts, lora_7b = phase_lora_7b()
    lora_7b["check_2_layers"] = phase_lora_7b_check()
    torch.cuda.empty_cache()
    log("== phase 19: speculative and pipelined serving, llama2_7b full "
        "width and depth")
    spec_counts, spec_rows, spec_serving = phase_spec_serve()
    rows["spec_serve"] = dict(spec_rows,
                              paged_kv_gather=rows["serve"]["paged_kv_gather"])
    torch.cuda.empty_cache()
    log("== phase 20: lane control, llama2_7b full width and depth")
    lane_counts, lane_control = phase_lane_control()
    rows["lane_control"] = {k: rows["serve"][k] for k in LANE_KERNELS}
    torch.cuda.empty_cache()
    log("== phase 21: generate() (mistral_7b rolling window, llama2_7b), "
        "generate_speculative, sample.py")
    generate_counts, rows["generate"], generation = phase_generate()
    torch.cuda.empty_cache()
    log("== phase 22: MoE decode and serving, int8 weight-only serving "
        "(qwen15_moe_a27b, mixtral_8x7b)")
    moe_counts22, moe_rows22, moe_serving = phase_moe_serve()
    rows.update(moe_rows22)
    torch.cuda.empty_cache()
    log("== phase 23: the serving fleet (in process, worker processes, "
        "disaggregated), llama2_7b full width and depth")
    fleet_counts, fleet = phase_fleet(run3)
    fleet["phase3_decode_ms_per_step"] = engines["llama2_7b_bf16"][
        "decode_ms_per_step"]
    rows["fleet_serve"] = {k: rows["serve"][k] for k in FLEET_KERNELS}
    torch.cuda.empty_cache()
    log("== phase 24: ViT-B/16 through the launcher; HF export and "
        "--init-from-hf (llama_125m_lm, Llama-2-7B width); export_program")
    interop_counts, rows["vit_tiny"], interop = phase_interop(
        launcher["eval"])
    # (b)'s kernels at phase 5's shapes, (c)'s at phase 2's (the same
    # per-layer shapes as phase 3).
    rows["hf_train"] = {k: rows["train"][k] for k in LAUNCH_KERNELS}
    rows["hf_serve"] = {k: rows["serve"][k] for k in SERVE_KERNELS}
    torch.cuda.empty_cache()
    log("== phase 25: multi-GPU code paths on one card (K6-EP, the "
        "expert-parallel block, the launcher at nccl world size 1)")
    ep_counts, rows["ep_block"], multi_gpu = phase_multi_gpu(
        lora_7b["losses"])
    torch.cuda.empty_cache()
    log("== phase 26: ring and Ulysses attention, the GPipe schedule, the "
        "tensor-split engine (two processes on the card)")
    par_counts, par_rows, parallel = phase_parallel(
        run3, engines["llama2_7b_bf16"], rows["serve"]["rms_norm"])
    rows.update(par_rows)
    torch.cuda.empty_cache()
    log("== phase 27: the bench tools (bench_lm, bench_moe, bench_bert, "
        "bench_vit, bench_generate, bench_serving, bench_gateway, bench.py, "
        "profile_summary)")
    bench = phase_bench(training["step_ms"])
    torch.cuda.empty_cache()
    log("== phase 28: the native host runtime (ring, stager, libjpeg), "
        "bench_allreduce, bench_grad_quant, bench_input's decode legs")
    native_counts, native_tools = phase_native_tools()
    rows["grad_quant"] = rows["train"]
    torch.cuda.empty_cache()
    log("== phase 29: the memory planner against the card's peaks, debug "
        "mode at llama_125m_lm full width, ttd_lint")
    debug_counts, planner_debug = phase_planner_debug(
        {"phase 6": training["peak_mem_gib"] - training["base_mem_gib"],
         "phase 10": (window_training["peak_mem_gib"]
                      - window_training["base_mem_gib"])})

    paths = {"serve": counts, "linear_serve": run3["linear_counts"],
             "autosize_serve": autosize_counts, "launch_fused": fused_counts,
             "train": train_counts,
             "moe_train": moe_counts, "window_train": window_counts,
             "launch": launch_counts, "bert": bert_counts,
             "wmt": wmt_counts, "mnist": mnist_counts,
             "lora_launch": lora_counts, "lora_7b": lora_7b_counts,
             "spec_serve": spec_counts, "lane_control": lane_counts,
             "generate": generate_counts, "fleet_serve": fleet_counts,
             "ep_block": ep_counts, **moe_counts22, **interop_counts,
             **par_counts, **native_counts, **debug_counts}
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, path=path, launches=paths[path][name],
                    **rows[path][name])
               for name, source, replaces, path in KERNELS]
    _tee(json.dumps({"engines": engines}))
    _tee(json.dumps({"training": training}))
    _tee(json.dumps({"moe_training": moe_training}))
    _tee(json.dumps({"moe_kernel_cases": moe_cases}))
    _tee(json.dumps({"window_training": window_training}))
    _tee(json.dumps({"window_kernel_cases": window_cases}))
    _tee(json.dumps({"launcher": launcher}))
    _tee(json.dumps({"families": families}))
    _tee(json.dumps({"lora_7b": lora_7b}))
    _tee(json.dumps({"spec_serving": spec_serving}, default=str))
    _tee(json.dumps({"lane_control": lane_control}))
    _tee(json.dumps({"generation": generation}))
    _tee(json.dumps({"moe_serving": moe_serving}))
    _tee(json.dumps({"fleet": fleet}))
    _tee(json.dumps({"interop": interop}))
    _tee(json.dumps({"multi_gpu": multi_gpu}))
    _tee(json.dumps({"parallel": parallel}))
    _tee(json.dumps({"bench": bench}))
    _tee(json.dumps({"native_tools": native_tools}))
    _tee(json.dumps({"planner_debug": planner_debug}))
    _tee(json.dumps({"kernel_cases": CASES}))
    _tee(json.dumps({"kernels": kernels}))
    whole = time.perf_counter() - t_start
    log(f"whole script: {whole:.1f} s of 1200 s"
        + (" (past 1150 s: cut GQ_STEPS first)" if whole > 1150 else ""))
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
