#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and exits nonzero — printing no result — without one, or when the
package is not beside it. ``python3 chip_smoke.py --flash-only`` runs
phases 1 and 2 and the flash kernels' part of phase 3 (their rows and edge
cases; with ``CUDA_LAUNCH_BLOCKING=1`` a fault names its launch) and
prints no result line; ``--paged-only`` does the same for the paged-decode
kernel, ``--xent-only`` for the fused cross-entropy kernels (their rows
with the cuBLAS yardstick, a repeat call's bits, sink inputs, and their
edge cases), and ``--norm-only`` for the norm and SwiGLU kernels (forward
and backward rows, the RMSNorm backward's kernels timed apart, and their
edge cases); ``--serve-only`` runs phases 1 and 2, serve and (a)–(c),
then (e), (f), (g), (h) and (i), without the kernel rows; ``--spec-only``
runs phases 1, 2 and (h), ``--moe-only`` phases 1, 2 and (i),
``--train-moe-only`` phases 1, 2, the fused CE's edge cases and (j),
``--remat-only`` phases 1, 2 and (k), ``--multi-only`` phases 1, 2 and
(l), ``--multi-cards-only`` phases 1, 2, (l)1 and (l)4 (for a machine
with several cards), ``--tp-only`` phases 1, 2 and (m) (its 4-card parts
where the machine has 4 cards), ``--tp-cards-only`` phases 1, 2 and
(m)3-(m)6 (for a machine with 4 cards), ``--tp-roles-cards-only`` phases
1, 2 and (m)6 (4 cards), ``--order-probe-only`` phases 1, 2 and (m)6's
order probe on one card (``admission_order_probe``), ``--ep-only`` phases
1, 2 and (n)
(its 4-card parts where the machine has 4 cards), ``--ep-cards-only``
phases 1, 2, (n)2 and (n)3 (for a machine with 4 cards),
``--ep-fault-cards-only`` phases 1, 2 and (n)3 with a fault planted in
the served gang (rank 1's shard of expert 0's down weight doubled in
every layer), which (n)3's token check must catch (4 cards; it exits 0
when the check fails), ``--pp-only`` phases 1, 2 and (o)1, and
``--pp-cards-only`` phases 1, 2 and (o)2-(o)3 (4 cards), ``--vision-only``
phases 1, 2 and (p) (its 4-card part where the machine has 4 cards), and
``--vision-cards-only`` phases 1, 2 and (p)2 (4 cards). None of these
prints the result lines. Every phase prints its seconds.
Phases, each a hard failure:

1. card: the ``nvidia-smi`` name and power limit;
2. build: every hand-written kernel built from the checkout's sources (one
   ``nvcc`` per CUDA source, the Triton kernels compiled meanwhile), each
   kernel's registers and spills; a spill in the wgmma kernels (flash
   forward, dK/dV, dQ; the fused CE's forward, dl recompute, d_hidden and
   d_head), or a ptxas note that it serialized their wgmma instructions,
   fails;
3. kernels: each kernel against its plain PyTorch version on the card at
   the Llama-3-8B serving and training shapes, with its time, the plain
   version's, one library call's where there is one, and the least time
   the card could take (the larger of bytes over 3.35 TB/s and operations
   over the peak rate of their type, H100 SXM); the fused CE's forward and
   backward beside the chunked CE's and cuBLAS's h W, the d_head product
   beside cuBLAS's h^T dl over the same chunks, two calls of them
   bit-identical, and checked and timed on sink inputs (h = 0; W with
   equal columns) beside the random ones; the flash forward timed on the
   kernel layout, and the dK/dV and dQ kernels each called twice must
   give the same bits; both backward kernels on inputs with an attention
   sink (every query puts p >= 1/2 on key 0), dQ timed there and on the
   random inputs, dK/dV too, with and without its exact-score recompute;
   the RMSNorm backward without and with the residual cotangent, each
   timed whole and per kernel (row pass, dw column sum) beside its bound,
   two calls bit-identical; paged decode with the wrapper's split count
   at 8 slots (1 and 32 printed beside): one kernel launch per call (the
   last split block of each slot and kv head merges the splits), the
   ticket counters zero after every call, and 20 calls in a CUDA graph
   replayed 50 times giving an eager call's bits. Then each kernel
   against its plain version at edge shapes (ragged lengths around the
   flash tiles, a diagonal off a tile boundary, q_offset, rows that see no
   key, head_dim 64, one to eight query heads per kv head, non-causal, one
   query row, odd widths, strided inputs; for
   paged decode: length 0, page boundaries, unmapped and poisoned pages, a
   dead row, one and eight query heads per kv head, pages of 16, int8 scale
   outliers, two calls bit-identical, the counters zero after every call,
   and named split counts (1 to mpp,
   splits past a slot's length, a split all unmapped between counted ones,
   mpp = 13 under counts that do not divide it); for the fused CE: T of 1,
   300 and 4096, D of 1160 (ragged in 64), 2048 and 4096, vocabularies of
   1000, 20000, 128256 and 256000, softcap, argmax ties inside a tile and
   across a vocab-range boundary, targets 0, V-1 and out of vocab, masked
   rows that must get exactly zero d_hidden; for the norm and SwiGLU backward:
   D = 2048/3072/4096, T = 1 and 300, (1 + w), the residual cotangent
   (the RMSNorm backward called twice for the same bits), gelu, odd M, and
   the explainer's T = 37 with a bf16 weight that needs no gradient, timed,
   through the kernels and through the ``autograd.Function``s);
   then the memory probe: the fused CE's forward and
   backward at T = 4096, V = 128256 must peak within one eighth of an
   fp32 [T, V] tensor beyond its inputs and gradients;
4. serve: Llama-3-8B at full width and depth (32 layers, random bf16
   weights from a seed) behind the port's ModelServer; greedy completions
   that land in the 128/512/2048 prefill buckets, a chunked-prefill prompt,
   a streamed completion, a v1 predict and a top-k/top-p sampled completion
   over HTTP. Every kernel must have
   launched during this phase; then the bucketed prefill's last-token
   logits are held against the plain path's;
   (a) explain, on the same engine in process: ``grad_x_input`` on a
   37-token prompt through the kernels against the plain path (same target
   token, scores rel L2 <= 5e-2), with exactly 2L + 1 RMSNorm backward and
   L SwiGLU backward launches; ``leave_one_out`` finite, same target;
   (b) loadgen in process: ``bursty_qos`` of ``standard_matrix`` (16
   requests at 4 req/s, prompts up to 512 tokens, 32 new) through
   ``EngineTarget`` on the contiguous engine; every request ok or shed;
   TTFT, TPOT, req/s, tokens/s and the generator's lag beside the card;
5. paged serve: the same weights on the page pool (bf16 pages, then int8
   pages) behind a ModelServer: shared-prefix, chunked, streamed, predict
   and sampled requests at once, then a second conversation turn and a
   prompt that diverges inside a registered page. Every kernel of the path
   must launch, the radix prefix index must hit and copy a tail,
   ``/metrics`` must show resident pages and no page may leak; then one
   decode step through the paged kernel is held against the gather path
   (bf16 and int8 pages) after a 1000-token paged prefill;
6. profile: host and device time of one decode dispatch on the contiguous
   cache and on the page pool, and of one 2048-token prefill, with the
   kernels that take the device time; then the greedy tokens of the
   worker's three prompts from an in-process paged engine, and the
   serving engine is freed;
   (c) the worker: ``python -m kubeflow_tpu_torch.runtime.worker_main``
   (``KFTPU_ENTRYPOINT=model_server``, ``KFTPU_PLATFORM=gpu``) serving
   Llama-3-8B from ``random://`` (the same seed, bf16) on the page pool
   with the ``strip`` transformer and the ``grad_x_input`` explainer; its
   kernels found built (no ``nvcc``); its greedy tokens identical to the
   in-process engine's (which proves its kernels ran: the same path
   computed them); chat, streamed and not, and ``:explain`` answer;
   ``uniform`` and ``shared_prefix`` through ``ServerTarget`` with
   ``/metrics`` showing resident pages under load and none after, prefix
   hits in ``shared_prefix``; then ``mixed_interference`` (prompts of
   384, so its batch class's 1536-token prompts fit) against it, every
   request ok; SIGTERM ends it with 143 and closes its port;
7. train check (serving engines freed first): Llama-3-8B at full width, 4
   layers, one ``decoder_loss`` forward and backward through the flash
   kernels alone and through every kernel (``fused_kernels="on"``)
   against the plain path on the same weights and batch — the loss and
   the layer-0 wq/wk/wv, ln1, ln2, gate and up, embedding, final-norm and
   head gradients — then three steps on a repeated batch must lower the
   loss;
8. train: the same model through ``Trainer.run()`` (fp32 params, AdamW,
   the preset's ``fused_kernels="auto"``, which runs every kernel,
   ``nothing_saveable`` remat, synthetic 2 x 2048 batches): 6 steps
   uninterrupted; at 2 layers 6 steps uninterrupted, then 5 steps that
   checkpoint at step 3 (asynchronously: steps 4 and 5 run while it is
   written; the seconds of the save that overlapped training printed) and
   crash after step 5, waiting for the step-3 commit, then a second
   ``Trainer`` that resumes from step 3 and finishes with an asynchronous
   step-6 save; loss and grad
   norm finite every step, the resumed step-6 loss within 1e-5 relative
   of the uninterrupted one, the same optimizer count and the same layer-0
   ``wq`` Adam moments at step 6, and every kernel of the path launched at
   its per-step count derived from the code;
   (d) ``load_params("file://...")`` of the resumed step-6 checkpoint into
   the 2-layer preset with bf16 params: the same bits as the trainer's
   params cast in memory, the same greedy tokens from an engine on each,
   and ``FileNotFoundError`` for an empty directory; the checkpoint is
   then deleted; then 2 steps with ``fused_kernels="off"`` (flash kernels,
   chunked CE) with their counts; then a profile of one step of each;
9. (e) disaggregated serving and the host KV tier, on a fresh 32-layer
   paged engine (the serving seed): a prefill-role and a decode-role
   engine over its weights hand the worker's three prompts off through
   the wire format, and the tokens must equal the unified engine's (bf16
   pages, then int8 pages), with no page referenced after the acks; a
   host-tier engine (64 host pages) demotes a conversation while idle and
   promotes it on the next turn: the pages' bytes equal before demotion
   and after promotion (bf16, int8 with scales), turn 2's tokens equal an
   engine's without the tier, the paged-decode kernel runs on adopted and
   on promoted pages; ``multi_turn`` (8 requests, 4 s of think time) through
   ``EngineTarget`` on it, no request failing, pages demoted and
   promoted, none left referenced. Then a prefill and a decode worker
   process share the card: the three prompts through the prefill worker
   (the decode worker's URL in ``X-Kftpu-Decode-Backend``) must give the
   worker's tokens; ``mixed_interference`` through them, every request
   ok, one export per request with tokens to decode, as many adoptions,
   no failed or fallback handoff, no page resident after, its report
   beside (c)'s unified one; with the decode worker stopped, a prompt
   must still give its tokens by recompute and the fallback counter read
   1; both workers end with 143 on SIGTERM;
10. (f) the fleet's failure path, on a fresh 32-layer paged engine (the
   serving seed) and a store root in a temporary directory, removed at the
   end: an engine with the host and remote KV tiers (16 host pages, 0.5 s
   to demote and 0.5 s more to spill, a 2 s store deadline) serves a
   700-token turn and spills its five full pages into the artifact store
   while idle, each blob decoding to the page's bytes read before
   demotion; a second engine on the same root serves turn 2 (turn 1, its
   output and 16 tokens) with the greedy tokens of a cold engine without
   the tier, its registry hits and remote promotions at least 5 and a
   prefix hit, the paged-decode kernel running on the promoted pages; a
   ``ChaosStore`` with one truncated read counts a corrupt blob and a
   wedged one a promote timeout, both with the same tokens, the wedged
   turn's first token within the deadline plus a cold prefill; bf16 pages,
   then int8; spill seconds per page, the promote's probe, read + hash and
   upload seconds, wire bytes per page and turn 2's TTFT from the store
   against the cold one are printed with the card. Then, with the engines
   freed, two ``model_server`` workers with the tier on one shared root
   behind a port ``Router`` in this process: turn 1 through the router,
   the worker holding it SIGKILLed once five pages are in the store, turn 2
   through the router answered 200 by the survivor from the store
   (promoted bytes > 0, a prefix hit) with the tokens of the same path in
   process (one engine spills turn 1, a fresh one serves turn 2 from the
   store; a cold engine's and a copy-on-write engine's printed), 8 more
   requests with explicit statuses, at least 4 ok, the dead worker
   ejected, and the survivor's SIGTERM giving 143;
11. (g) many models and many adapters on one card. (g)1: 8 LoRA tenants
   of rank 16 over wq, wk, wv and wo (fp32 factors from seeded
   generators on the host; two published to a temporary artifact store
   and pulled at their first hot-load) on engines over one 32-layer
   engine's weights with 4 packed adapter slots: four equal-length
   prompts, two base and two under adapters, give the base rows the
   greedy tokens of a LoRA-free engine exactly (bf16 pages, then int8),
   the adapter rows printed against a merged-weights engine's; a
   512-token bucketed prefill (the flash kernel) under two adapters
   within rel L2 5e-2 of the merged weights' last-token logits and at
   least 5x that away from the base weights'; one prompt under two
   adapters shares no KV (no prefix hit across adapters, a hit on the
   first adapter's second turn); ``packed_bytes()`` 109,051,904;
   ``multi_adapter`` (16 requests at 4 req/s, 512-token prompts, 32 new,
   zipf over the 8 tenants) through ``EngineTarget`` on the page pool,
   every request ok or shed, at least 5 hot-loads and an eviction, no
   leaked page or adapter reference, the norms, SwiGLU and paged decode
   launched, per-adapter TTFT and TPOT and each hot-load's ms printed;
   the 8-step paged decode dispatch at 8 slots with and without adapters
   (host enqueue, device time, launches per step); 6 requests of the
   mix on a contiguous engine whose bucketed prefill runs the flash
   kernel under adapters. (g)2: two Llama-3-8B models (the serving seed
   and the next) behind ``ModelServer(repository=...)`` with
   ``max_loaded=1`` on the page pool: alpha, beta, alpha over HTTP, the
   v2 index after each, each eviction freeing at least the evicted
   model's weight bytes (``gc.collect()``, then the allocation at the
   next build's start), alpha's reloaded greedy tokens equal to its
   first, ``estimate_model_bytes`` printed beside the allocation, and an
   unload while a streamed request holds alpha's lease, which must end
   200 with ``[DONE]``. (g)3, where grpcio and protobuf are installed:
   ``ModelInfer`` on the same server's gRPC port gives the REST text and
   ``ModelReady`` of an unknown name is false; elsewhere it prints that
   (g)3 did not run;
12. (h) speculative decoding (k = 4) on a fresh 32-layer engine's weights
   (the serving seed), 8 slots × 2048. (h)1: one paged verify step, 8
   slots × 5 positions (rows at 1024..1030 over a prefilled 1024-token
   prompt, one at 2045 whose last positions pass max_len), through the
   paged-decode kernel over 40 virtual rows against the gather route:
   fp32 logits within rel L2 5e-2, argmax equal except at near ties,
   exactly L paged-decode, 2L + 1 RMSNorm and L SwiGLU launches, bf16 and
   int8 pages; the step's enqueue, wall and device ms beside a decode
   step's. (h)2: four random 200-token prompts P, G their 32 greedy
   tokens, then P + G + P through a spec-off engine, an ngram engine and
   a self-draft engine (the target's own tensors as the draft) on paged
   bf16, paged int8 and contiguous engines: every emitted token the
   argmax of a plain full forward over its context or a near tie
   (|Δlogit| <= 1e-2 + 2^-7·|top|), spec rounds that drafted, rows 1 and
   4 (and 12 on the page pool) launched, no page referenced after; spec
   counters, acceptance, tokens per step and TPOT p50 beside the spec-off
   engine's printed. (h)3: a random 2-layer draft of Llama-3-8B widths
   (rejects almost every draft): the same token check, no leaked page
   and 0 resident after. (h)4: a worker with ``batching.speculative``
   ngram on the page pool under ``uniform`` (64 new tokens) through
   ``ServerTarget``: every request ok,
   ``kftpu_serving_spec_tokens_per_step`` read off ``/metrics``, TPOT p50
   beside (c)'s spec-off worker's; SIGTERM -> 143;
13. (i) MoE serving and int8 weights. (i)1: one MoE block at Mixtral
   width (bf16, seeded) at T = 2048 with 1500 real rows: the dispatch
   path at capacity factor E against the dense oracle (rel L2 <= 1e-2 on
   the real rows, pad rows exactly 0); at the model's 1.25 the dropped
   pairs and no slot held by a pad row; dispatch, zero-drop dispatch and
   dense timed at T = 2048 and 8 rows. (i)2: Mixtral-8x7B at full width
   and 8 layers (random bf16, the serving seed) packed to int8:
   ``packed_param_bytes`` equal to the config's estimate,
   ``quantization_quality`` on 4 prompts x 16 tokens; int8-weight engines
   (paged on a bf16 pool, on an int8 pool, contiguous with its 2048
   bucket): every token held to two plain forwards over the same int8
   weights, bf16 and fp32, teacher-forced phase for phase (the prompt in
   the engine's windows with its pads masked, decode on the dense path;
   an int8 pool's K/V quantized as the pool holds them): the argmax or a
   near tie of either, with at most ``MOE_BEYOND_FRAC`` (1/16) of an
   engine's 4 x 64 tokens beyond both bands; the same check fails
   against forwards with a planted
   fault (one expert's down scale doubled, a layer's second choice
   dropped); no pad row of the engines' prefill windows holds an expert
   slot, and that check fails on a window whose pads claim capacity;
   rows 1, 2 and 12 (6 on the contiguous engine) launched,
   row 4 not. (i)3: Mixtral-8x7B at
   all 32 layers with int8 weights through ``runtime.worker_main`` →
   ``model_server`` (``random://`` packed per layer, never bf16 whole;
   bf16 page pool, 8 slots x 2048; its batching a ``BatchingSpec`` dump
   with ``moe_*_impl``): three completions and ``uniform`` (4 requests
   at 4 req/s, prompts of 512, 64 new) through ``ServerTarget``, every
   request ok; SIGTERM -> 143; then the same seed's int8 weights in
   process, each completion token held as in (i)2; the worker's logged
   peak memory beside ``estimate_model_bytes``; one dense decode step
   timed. (i)4: Llama-3-8B int8, paged: every token the argmax or a near
   tie of a plain full forward in bf16 or in fp32; packed bytes against
   bf16; one decode step's enqueue and device ms with int8 weights beside
   bf16's. The (i)3 worker's peak allocation (its log, in bytes) must not
   exceed ``estimate_model_bytes``;
14. (j) MoE training and the training entry points, at Mixtral width.
   (j)1: one MoE block, fp32 weights from a seed, bf16 activations,
   T = 2048, loss ``sum(out²) + 0.01·aux``: the zero-drop dispatch's
   gradients (router, gate, up, down, x) against the dense path's, rel L2
   <= 1e-2 per leaf; forward and backward ms of the dispatch (factor 1.25)
   and the dense path. (j)2: ``Trainer.run()``, 2 layers (3.17 B params,
   fp32 with AdamW), 2 x 2048 tokens, ``fused_kernels="auto"``, flash
   attention, ``nothing_saveable``: 6 steps with finite loss, grad norm and
   ``aux_loss``, each layer's balance loss within 0.9–1.5 k, rows 1–3 and
   6–11 launched at their per-step counts; 2 steps with
   ``fused_kernels="off"`` within 1e-2 of the first two losses; step ms,
   tokens/s, MFU and peak memory printed. (j)3: ``llm_pretrain`` through
   ``runtime.worker_main`` at 1 layer, 3 steps and a step-3 checkpoint (~20
   GB, under a git-ignored ``.chip_smoke_train_*/`` in the checkout,
   removed after): exit 0 and 3 metrics lines with ``aux_loss``; then a
   ``model_server`` worker on that checkpoint through ``file://`` (bf16):
   its greedy tokens for two prompts equal an in-process engine's on the
   same checkpoint; SIGTERM -> 143. (j)4: ``vision_train`` workers, ViT-L/16
   and CLIP-L/14, batch 8, 4 steps: exit 0, every metric finite, the first
   bf16 loss within 1e-2 of an fp32 evaluation in process of the same
   seeded init and batch, step ms printed. The fused CE's edge cases
   include Mixtral's vocabulary, V = 32000 (phase 3);
15. (k) the seven remat policies at the train phase's width and depth
   (Llama-3-8B, 4 layers, fp32 params and AdamW, ``fused_kernels="auto"``,
   flash attention, 2 x 2048 tokens a step from a ``kind: "grain"`` source
   over a token ``.npy`` drawn from the seed): ``Trainer.run()`` for 3
   steps under each; the step-1 and step-3 losses within 1e-5 and the
   step-1 grad norm within 1e-4 (relative) of ``"none"``'s; every
   training kernel launched at its per-step count under that policy
   (the flash forward L times a step under ``"none"`` and
   ``"dots_flash"``, 2L under the others); the activation bytes one
   forward keeps, the peak less the params' and Adam state's bytes, step
   ms, tokens/s and MFU printed.
16. (l) multi-process training: (l)1 ``llm_pretrain`` through
   ``runtime.worker_main`` with ``KFTPU_PARALLELISM_JSON={"fsdp": 1}`` (an
   NCCL world of one on the card, the mesh path with every training
   kernel): Llama-3-8B width at 4 layers, 2 x 2048 tokens, 3 steps, fused
   kernels on; each step's loss within rel 1e-6 of the in-process
   unmeshed ``Trainer``'s (bit-equality printed), the worker's launches
   per step of rows 1-11 the train phase's, step ms, tokens/s and peak
   memory; (l)2 the flash ring's step functions, 4 ranks in lockstep in
   one process, at 32/8 heads x 128, B = 1, S = 8192: o within 1e-2 +
   2^-7 |ref| and lse within 1e-3 of one flash forward over the whole
   sequence, dq/dk/dv within rel L2 1e-2 of the one-card flash backward,
   exactly 10 launches of each flash kernel (a future part launches
   nothing), the ring's kernel ms beside the single flash's; (l)3 a
   ``torch_train`` gang of 2 workers on the one card over gloo: both exit
   0, the loss falls, both ranks' final weights bit-equal; (l)4 with two
   or more cards, ``llm_pretrain`` at world min(cards, 4) over NCCL on
   ``{seq: world}`` with the flash ring and on ``{fsdp: world}``, losses
   within 1e-2 of an in-process run (fused off, as the mesh turns them
   off) on the same global batches (on one card it prints why it did not
   run).
17. (m) tensor parallelism over the ``model`` axis: (m)1 one Llama-3-8B
   block at B = 1, T = 2048 split 4 ways in lockstep on the card (each
   rank's 8 q / 2 kv heads through the flash kernels, its 3584 mlp
   columns through the SwiGLU kernels, the partial outputs summed):
   output and every gradient within rel L2 1e-2 of the unsplit block
   through the same kernels, rows 4-8 launched exactly 4 times the
   unsplit block's; (m)2 the vocab-parallel fused CE at T = 4096, D =
   4096, V = 128256 over 4 shards of 32064 columns (a ragged last tile):
   nll, lse (1e-3), correct (near ties), d_hidden and d_head against the
   whole-vocab kernels, each shard's ms beside the whole call's; with 4
   cards, (m)3 ``llm_pretrain`` on ``{model: 4}`` and ``{fsdp: 2, model:
   2}`` held as (l)4 holds its runs, (m)4 a ``{model: 4}`` ``model_server``
   gang of Llama-3-8B (bf16 and int8 pages: greedy tokens the plain
   one-card forward's argmax or a near tie, ``uniform`` TTFT and TPOT, the
   followers' op counts the leader's, SIGTERM ends every rank) and (m)5
   Llama-3-70B at 80 layers on ``{model: 4}`` (peak per card, 8 greedy
   requests held to a plain TP forward on the same cards, TPOT) and (m)6
   disaggregated serving under TP: Llama-3-8B (bf16 pages, then int8) as
   a ``{model: 2}`` prefill gang on cards 0-1 handing off to a ``{model:
   2}`` decode gang on cards 2-3 with the host and remote KV tiers (the
   KV payloads whole-model: gathered from the ranks' kv heads, each rank
   keeping its own on adoption): greedy tokens through the pair equal to
   a unified ``{model: 2}`` gang's (on int8 pages both get the prompts
   one at a time: which prompt reads another's cached first token from
   an int8 page follows the admission order, by the reference engine's
   design), and they and (bf16) those from the
   prefill gang to a one-process decode worker on card 2 held as (m)5
   holds its own, by teacher-forced TP forwards; ``mixed_interference``
   through the pair (every request ok, one export per request with tokens
   to decode, one adoption per export, no failed or fallback handoff, no
   page resident after) beside the unified gang; a turn demoted and
   spilled off the decode gang, then promoted back with the same tokens;
   each rank's launches (``ROLES_KERNELS`` on every rank) and peak, the
   followers' ops by name the leader's, the bytes an adoption sends each
   follower; with the decode gang gone the prefill gang recomputes; every
   leader ends 143 on SIGTERM and every follower 0. On one card
   (m)3-(m)6 print why they did not run.
18. (n) MoE on a mesh: (n)1 one Mixtral-width MoE block (bf16, 2 batch
   shards of 2048 tokens, capacity factor 1.0) split over ``{expert: 4}``
   and ``{expert: 2, model: 2}`` in lockstep on the card, against the
   unsplit block: the kept pairs exactly equal, output and every
   gradient (router included) within rel L2 1e-2, the aux parts' sum
   within 1e-5; a per-rank plan and an unsummed router gradient, planted,
   must each fail; with 4 cards, (n)2 ``llm_pretrain`` at Mixtral width
   on ``{expert: 4}`` and ``{data: 2, expert: 2}`` held as (l)4 holds its
   runs, then 6 layers on ``{expert: 4}`` (loss finite and falling, each
   layer's aux, peak per card), and (n)3 Mixtral-8x7B in bf16 at 32
   layers as a ``{model: 4}`` ``model_server`` gang held as (m)5; on one
   card (n)2-(n)3 print why they did not run.
19. (o) pipeline parallelism over the ``pipeline`` axis: (o)1 the 4-layer
   Llama-3-8B training step (4 x 2048, fused kernels on) staged in
   lockstep on the card, ``{pipeline: 2}`` GPipe and ``{pipeline: 4}``
   1F1B, against the unstaged step: loss (rel 1e-4), grad norm (rel
   1e-3), every gradient leaf (rel L2 1e-2), each stage's launches of
   every training kernel exact (the CE kernels on the last stage only);
   with 4 cards, (o)2 ``llm_pretrain`` over NCCL on ``{pipeline: 4}``
   1F1B and ``{pipeline: 2, data: 2}`` GPipe against one card on the
   same global batches (as (l)4 holds its runs, launches per rank
   exact), the latter's step-3 checkpoint resumed on ``{pipeline: 4}``
   with every params leaf bit-equal, and (o)3 Llama-3-8B at all 32
   layers on ``{pipeline: 4}`` (a state no card holds): 6 steps, the
   loss finite and falling, step ms, tokens/s, MFU, peak and each
   stage's idle share beside the 1F1B bubble; on one card (o)2-(o)3
   print why they did not run. (m)4's gangs also answer ``:explain``
   (``grad_x_input``, ``leave_one_out``) against the one-card kernel
   path.
20. (p) vision on a mesh, and dims that do not divide: (p)1 one ViT-L/16
   encoder block (bf16, B = 32, 197 tokens) split 4 ways over ``model``
   and 2 ways over ``seq`` (99 and 98 positions) in lockstep on the
   card, against the whole block (output and every gradient, rel L2
   1e-2); the ViT head's vocab-parallel CE over 4 shards of 1000 classes;
   one Llama-3-8B block at T = 2048 and its fused CE on a model axis of
   3, where heads, kv heads and mlp columns do not divide (each rank
   reads its part of the whole leaves), against the unsplit block and
   CE, the launches per shard printed; with 4 cards, (p)2
   ``vision_train`` over NCCL: ViT-L/16 (24 layers, 224², 1000 classes)
   on ``{fsdp: 2, model: 2}`` and ``{data: 2, seq: 2}``, CLIP-L/14 on
   ``{data: 2, model: 2}`` and ``{model: 2, seq: 2}``, 4 steps of 32
   images each in fp32 activations against a one-card run of the same
   config (losses rel 1e-4), step ms, images/s and peak per rank; on one card (p)2 prints
   why it did not run.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with every kernel's numbers.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
SEED = 0

# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise: one bf16 rounding
# of the output (2^-7 relative, with an absolute floor near zero) — the two
# versions round fp32 intermediates at different places. lse is fp32.
RTOL, ATOL = 2.0 ** -7, 1e-2
LSE_ATOL = 1e-3
# Last-token logits of a bucketed prefill, kernel path vs plain path, both
# bf16 over 32 layers: relative L2 error.
PREFILL_REL_L2 = 5e-2
# Flash backward kernels vs their plain version at the training shape:
# relative L2 error over the whole output, beside the elementwise check.
BWD_REL_L2 = 1e-2
# Training check, kernel path vs plain attention, 4 layers of random bf16
# activations: loss (relative) and gradients (relative L2).
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# Resumed run vs the uninterrupted one at step 6: the loss (relative) and
# the layer-0 wq Adam moments (relative L2). Both runs do the same work on
# the same inputs and have read bit-equal; the bands leave room for a
# reduction order that changes between runs. A resume that lost the moments
# misses half of their six terms and is off by tens of percent.
RESUME_LOSS_REL = 1e-5
RESUME_MOMENT_REL_L2 = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph and replayed ``reps`` times between CUDA events. Replay has no
    host launch gaps (a Triton launch costs tens of microseconds on the
    host, more than these kernels run), so this is the work's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def within(out: torch.Tensor, ref: torch.Tensor, name: str,
           atol: float = ATOL, rtol: float = RTOL) -> float:
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    excess = diff - (atol + rtol * ref.float().abs())
    if not torch.all(excess <= 0):
        at = int(excess.argmax())
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, tolerance {atol:g} + {rtol:g}*|ref|; "
             f"worst at flat index {at}: kernel "
             f"{float(out.flatten()[at].float()):.6g}, plain "
             f"{float(ref.flatten()[at].float()):.6g})")
    return err


# -- phases --------------------------------------------------------------------

def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return line


def phase_build() -> None:
    from kubeflow_tpu_torch.ops import _build, fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    errors: list[BaseException] = []

    def nvcc():
        try:
            _build.build_all()
        except BaseException as exc:          # re-raised on the main thread
            errors.append(exc)

    th = threading.Thread(target=nvcc, name="nvcc")
    th.start()
    # Triton compiles in this process while nvcc runs: one call per kernel
    # specialisation the serve path uses (bf16, D = 4096, silu).
    x = torch.ones((8, 4096), dtype=torch.bfloat16, device="cuda")
    w = torch.ones((4096,), dtype=torch.bfloat16, device="cuda")
    fused_norm.rmsnorm_fused(x, w, eps=1e-5)
    fused_norm.add_rmsnorm_fused(x, x, w, eps=1e-5)
    fused_norm.swiglu_fused(x, x, act="silu")
    # ... and the training path's: fp32 norm weights, both backward passes.
    w32 = w.float()
    fused_norm.add_rmsnorm_fused(x, x, w32, eps=1e-5)
    _, _, rstd = fused_norm._norm_launch(x, None, w32, 1e-5, False)
    fused_norm.rmsnorm_bwd(x, w32, rstd, x)
    fused_norm.rmsnorm_bwd(x, w32, rstd, x, dy=x)
    fused_norm.swiglu_bwd(x, x, x, act="silu")
    th.join()
    if errors:
        raise errors[0]
    q = torch.zeros((1, 64, 32, 128), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, 64, 8, 128), dtype=torch.bfloat16, device="cuda")
    flash_attention(q, k, k)
    torch.cuda.synchronize()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, in parallel: "
          f"{', '.join(_build.SOURCES)}; triton: rms_fwd, rms_bwd, "
          "rms_dw_sum, swiglu_fwd, swiglu_bwd)",
          flush=True)
    report_ptxas(_build.PTXAS)


#: Kernels whose products run on wgmma with register accumulators.
WGMMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                 "flash_bwd_dq_kernel", "xent_fwd_kernel", "xent_dl_kernel",
                 "xent_dh_kernel", "xent_dw_kernel")


def report_ptxas(logs: dict) -> None:
    """Print each kernel's registers and spills from the ``ptxas -v`` logs
    of a build, and fail if a kernel of ``WGMMA_KERNELS`` spills or if
    ptxas serialized its wgmma instructions (notes C7515, C7520)."""
    for name, log in logs.items():
        for kernel, used, spills in ptxas_kernels(log):
            print(f"  ptxas {name}: {kernel}: {used}; {spills}", flush=True)
            # The warp-specialised kernels keep their accumulators in
            # registers: a spill undoes the design.
            if kernel.startswith(WGMMA_KERNELS) and \
                    "0 bytes spill stores, 0 bytes spill loads" not in spills:
                fail(f"{name}: {kernel} spills ({spills})")
        for ln in log.splitlines():
            # Warnings, and notes that wgmma instructions were serialized.
            if "warning" in ln.lower() or "performance" in ln.lower():
                print(f"  ptxas {name}: {ln.strip()}", flush=True)
                if "wgmma" in ln and any(k in ln for k in WGMMA_KERNELS):
                    fail(f"{name}: ptxas serialized the wgmma instructions "
                         f"of a warp-specialised kernel: {ln.strip()}")


def ptxas_kernels(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, stack/spill line) of each entry function
    in a ``ptxas -v`` log, the kernel as ``name<D>`` from its mangled
    name."""
    out, kernel, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = kernel = m.group(1)
            i = 0
            while i < len(mangled):              # length-prefixed names
                k = re.match(r"\d+", mangled[i:])
                if not k:
                    i += 1
                    continue
                i += k.end()
                name = mangled[i:i + int(k.group())]
                i += len(name)
                if name.endswith("_kernel"):
                    arg = re.match(r"ILi(\d+)E", mangled[i:])
                    kernel = name + (f"<{arg.group(1)}>" if arg else "")
                    break
        elif "spill stores" in ln:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln and kernel:
            out.append((kernel, ln.split(":", 1)[-1].strip(), spills))
            kernel, spills = None, ""
    return out


def norm_fwd_rows() -> list[dict]:
    """Sites 1, 2 and 4: RMSNorm, residual + RMSNorm and SwiGLU at the
    decode (T = 8) and bucketed prefill (T = 2048) shapes; the prefill
    shape is the one recorded."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator("cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    D, M, eps = 4096, 14336, 1e-5
    rows = []

    # Sites 1 and 2: RMSNorm, residual + RMSNorm — decode (T=8) and
    # bucketed prefill (T=2048); the prefill shape is the one recorded.
    errs = {"rmsnorm_fwd": 0.0, "add_rmsnorm_fwd": 0.0}
    for T in (8, 2048):
        x, res, w = rnd(T, D), rnd(T, D), rnd(D)
        e1 = within(fn.rmsnorm_fused(x, w, eps=eps),
                    fn.rmsnorm_ref(x, w, eps=eps), f"rmsnorm T={T}")
        y, o = fn.add_rmsnorm_fused(x, res, w, eps=eps)
        yr, orf = fn.add_rmsnorm_ref(x, res, w, eps=eps)
        e2 = max(within(y, yr, f"add_rmsnorm y T={T}"),
                 within(o, orf, f"add_rmsnorm o T={T}"))
        errs["rmsnorm_fwd"] = max(errs["rmsnorm_fwd"], e1)
        errs["add_rmsnorm_fwd"] = max(errs["add_rmsnorm_fwd"], e2)
        print(f"kernel rmsnorm_fwd T={T} D={D}: max_abs_err {e1:.3e}; "
              f"add_rmsnorm_fwd: max_abs_err {e2:.3e} "
              f"(tolerance {ATOL:g} + {RTOL:g}*|ref|)", flush=True)
    T = 2048
    x, res, w = rnd(T, D), rnd(T, D), rnd(D)
    b_rms = bound(2 * T * D * 2 + D * 2 + T * 4, 4 * T * D, FP32_FLOPS)
    rows.append(dict(
        name="rmsnorm_fwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:120",
        max_abs_err=errs["rmsnorm_fwd"],
        ms=device_ms(lambda: fn.rmsnorm_fused(x, w, eps=eps)),
        plain_ms=device_ms(lambda: fn.rmsnorm_ref(x, w, eps=eps)),
        bound_ms=b_rms[0], bound_by=b_rms[1],
        library_ms=device_ms(lambda: F.rms_norm(x, (D,), w, eps))))
    b_add = bound(4 * T * D * 2 + D * 2 + T * 4, 5 * T * D, FP32_FLOPS)
    rows.append(dict(
        name="add_rmsnorm_fwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:129",
        max_abs_err=errs["add_rmsnorm_fwd"],
        ms=device_ms(lambda: fn.add_rmsnorm_fused(x, res, w, eps=eps)),
        plain_ms=device_ms(lambda: fn.add_rmsnorm_ref(x, res, w, eps=eps)),
        bound_ms=b_add[0], bound_by=b_add[1], library_ms=None))

    # Site 4: SwiGLU at the prefill shape (and GeGLU for the gelu branch).
    g, u = rnd(T, M), rnd(T, M)
    e_sw = within(fn.swiglu_fused(g, u, act="silu"),
                  fn.swiglu_ref(g, u, act="silu"), "swiglu silu")
    e_ge = within(fn.swiglu_fused(g, u, act="gelu"),
                  fn.swiglu_ref(g, u, act="gelu"), "swiglu gelu")
    print(f"kernel swiglu_fwd T={T} M={M}: max_abs_err silu {e_sw:.3e}, "
          f"gelu {e_ge:.3e}", flush=True)
    b_sw = bound(3 * T * M * 2, 6 * T * M, FP32_FLOPS)
    rows.append(dict(
        name="swiglu_fwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:283",
        max_abs_err=max(e_sw, e_ge),
        ms=device_ms(lambda: fn.swiglu_fused(g, u, act="silu")),
        plain_ms=device_ms(lambda: fn.swiglu_ref(g, u, act="silu")),
        bound_ms=b_sw[0], bound_by=b_sw[1],
        library_ms=device_ms(lambda: F.silu(g) * u)))
    return rows


def phase_kernels() -> list[dict]:
    rows = norm_fwd_rows()
    rows += flash_fwd_rows()
    rows += flash_bwd_rows()
    rows += norm_swiglu_bwd_rows()
    rows += xent_rows()
    rows += paged_kernel_rows()
    for r in rows:
        print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return rows


def flash_fwd_rows() -> list[dict]:
    """Site 6: the flash forward at the prefill shape (B=1, H=32, KH=8,
    S=2048, D=128, causal; softcap too) against its plain version, timed
    on the kernel layout (``flash_fwd_op``, like the SDPA
    yardstick beside it); the three [B, S, H, D] -> [B, H, S, D] copies
    that ``flash_attention`` adds are timed on a line of their own."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.flash_attention import (
        flash_attention, flash_fwd_op, flash_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    B, H, KH, S, Dh = 1, 32, 8, 2048, 128
    scale = Dh ** -0.5
    q, k, v = rnd(B, S, H, Dh), rnd(B, S, KH, Dh), rnd(B, S, KH, Dh)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    e_fl = 0.0
    for cap in (None, 30.0):
        o, lse = flash_attention(q, k, v, causal=True, logits_softcap=cap)
        ro, rl = flash_ref(qt, kt, vt, causal=True, sm_scale=scale,
                           softcap=cap, q_offset=0)
        e_o = within(o, ro.transpose(1, 2), f"flash o softcap={cap}")
        e_l = within(lse, rl, f"flash lse softcap={cap}", atol=LSE_ATOL,
                     rtol=0.0)
        e_fl = max(e_fl, e_o)
        print(f"kernel flash_fwd B={B} H={H} KH={KH} S={S} D={Dh} causal "
              f"softcap={cap}: max_abs_err o {e_o:.3e}, lse {e_l:.3e}",
              flush=True)
    copies = device_ms(lambda: [t.transpose(1, 2).contiguous()
                                for t in (q, k, v)])
    print(f"flash_attention layout copies (q, k, v to [B, H, S, D]): "
          f"{copies:.4f} ms, outside the kernel's time", flush=True)
    causal_pairs = S * (S + 1) / 2
    b_fl = bound(2 * (B * S * H * Dh * 2) + 2 * (B * S * KH * Dh * 2)
                 + B * H * S * 4, 4 * B * H * causal_pairs * Dh, BF16_FLOPS)
    return [dict(
        name="flash_fwd", route="cuda",
        source="kubeflow_tpu_torch/csrc/flash_fwd.cu",
        replaces="kubeflow_tpu/ops/flash_attention.py:156",
        max_abs_err=e_fl,
        ms=device_ms(lambda: flash_fwd_op(qt, kt, vt, True, scale, None, 0)),
        plain_ms=device_ms(lambda: flash_ref(qt, kt, vt, causal=True,
                                             sm_scale=scale, softcap=None,
                                             q_offset=0),
                           iters=2, reps=3),
        bound_ms=b_fl[0], bound_by=b_fl[1],
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))]


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).norm() / ref.float().norm())


def bwd_case(gen, B, H, KH, Sq, Skv, D, *, causal=True, q_offset=0,
             softcap=None):
    """Inputs of one flash-backward call on the kernel layout: bf16 q, k,
    v and dO; lse and delta from the plain forward (fp32)."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(B, H, Sq, D), rnd(B, KH, Skv, D), rnd(B, KH, Skv, D), \
        rnd(B, H, Sq, D)
    kw = dict(causal=causal, sm_scale=D ** -0.5, softcap=softcap,
              q_offset=q_offset)
    o, lse = FA.flash_ref(q, k, v, **kw)
    return (q, k, v, do, lse, FA._delta(o, do)), kw


def peaked_bwd_case(gen, B, H, KH, S, D):
    """Backward inputs whose attention has a sink, as trained heads do:
    a shared direction u (entries +-1) is added to every query and key 0
    is 1.25 u, so every query puts p >= 1/2 on key 0. Returns the inputs,
    the call's keywords and the share of query rows with p >= 1/2 there."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    (q, k, v, do, _, _), kw = bwd_case(gen, B, H, KH, S, S, D)
    u = torch.randint(0, 2, (D,), generator=gen, device="cuda").float() * 2 - 1
    q = (q.float() + u).to(torch.bfloat16)
    k = k.clone()
    k[:, :, 0] = (1.25 * u).to(torch.bfloat16)
    o, lse = FA.flash_ref(q, k, v, **kw)
    p0 = torch.exp(q.float() @ k[0, 0, 0].float() * kw["sm_scale"] - lse)
    return (q, k, v, do, lse, FA._delta(o, do)), kw, \
        float((p0 >= 0.5).float().mean())


def check_bwd(args, kw, name: str) -> tuple[dict, float, tuple]:
    """Both backward kernels against the plain backward on ``args``:
    ({"dq", "dk", "dv": max abs error}, worst relative L2, the kernels'
    outputs)."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    dk, dv = FA.flash_bwd_dkdv(*args, **kw)
    dq = FA.flash_bwd_dq(*args, **kw)
    ref = FA._bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    errs, rel = {}, 0.0
    for part, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        errs[part] = within(got, want, f"{name} {part}")
        if float(want.float().norm()) > 0:
            rel = max(rel, rel_l2(got, want))
    return errs, rel, (dq, dk, dv)


def flash_bwd_rows() -> list[dict]:
    """Sites 7 and 8: the dK/dV and dQ kernels against the plain backward
    at the training shape (B=2, H=32, KH=8, S=2048, D=128, causal), each
    called twice on the same inputs for the same bits, then on inputs with
    an attention sink, where both are timed too. The plain version and the
    library call (the backward of SDPA) each compute dq, dk and dv
    together; their times stand in both rows."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    B, H, KH, S, D = 2, 32, 8, 2048, 128
    args, kw = bwd_case(gen, B, H, KH, S, S, D)
    errs, rel, (dq, dk, dv) = check_bwd(args, kw, "flash_bwd S=2048")
    dk2, dv2 = FA.flash_bwd_dkdv(*args, **kw)
    if not (torch.equal(dk2, dk) and torch.equal(dv2, dv)):
        fail("flash_bwd_dkdv: two calls on the same inputs differ (the GQA "
             "sum must not depend on timing)")
    if not torch.equal(FA.flash_bwd_dq(*args, **kw), dq):
        fail("flash_bwd_dq: two calls on the same inputs differ (the kv sum "
             "must not depend on timing)")
    print("kernels flash_bwd_dkdv and flash_bwd_dq: a second call is "
          "bit-identical", flush=True)
    print(f"kernel flash_bwd B={B} H={H} KH={KH} S={S} D={D} causal: "
          f"max_abs_err dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv "
          f"{errs['dv']:.3e}, worst rel L2 {rel:.3e} (tolerance "
          f"{BWD_REL_L2:g})", flush=True)
    if not rel <= BWD_REL_L2:
        fail(f"flash backward kernels: rel L2 {rel:.3e} > {BWD_REL_L2:g}")
    # The dK/dV kernel recomputes, from exact scores, the p >= 1/4 that lie
    # near a bf16 midpoint; attention with a sink has a p >= 1/4 in every
    # query row. Its cost: the kernel against a build without the
    # recompute, on those inputs and on the random ones.
    pk_args, _, share = peaked_bwd_case(gen, B, H, KH, S, D)
    if share < 0.99:
        fail(f"peaked backward inputs: only {share:.3f} of the query rows "
             "put p >= 1/2 on key 0")
    pk_errs, pk_rel, _ = check_bwd(pk_args, kw, "flash_bwd S=2048 peaked")
    if not pk_rel <= BWD_REL_L2:
        fail(f"flash backward kernels, peaked: rel L2 {pk_rel:.3e} > "
             f"{BWD_REL_L2:g}")
    no_exact = ("FLASH_DKDV_EXACT_P=0",)
    times = {(data, variant): device_ms(
                 (lambda a=a: FA.flash_bwd_dkdv(*a, **kw)) if variant == "with"
                 else (lambda a=a: FA._launch_bwd("dkdv", *a, **kw,
                                                  defines=no_exact)))
             for data, a in (("peaked", pk_args), ("random", args))
             for variant in ("with", "without")}
    print(f"kernel flash_bwd_dkdv peaked (p >= 1/2 on key 0 in "
          f"{share:.4f} of the query rows): max_abs_err "
          f"{max(pk_errs.values()):.3e}, rel L2 {pk_rel:.3e}; ms with the "
          f"exact-score recompute {times['peaked', 'with']:.4f}, without "
          f"{times['peaked', 'without']:.4f}; random inputs: with "
          f"{times['random', 'with']:.4f}, without "
          f"{times['random', 'without']:.4f}", flush=True)
    dq_ms = {data: device_ms(lambda a=a: FA.flash_bwd_dq(*a, **kw))
             for data, a in (("peaked", pk_args), ("random", args))}
    print(f"kernel flash_bwd_dq: max_abs_err peaked {pk_errs['dq']:.3e}; ms "
          f"peaked {dq_ms['peaked']:.4f}, random {dq_ms['random']:.4f}",
          flush=True)
    plain_ms = device_ms(lambda: FA._bwd_ref(*args, **kw), iters=2, reps=3)
    # The library yardstick: SDPA's backward on the same tensors.
    q, k, v, do = (t.detach().clone().requires_grad_(i < 3)
                   for i, t in enumerate(args[:4]))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    grad = lambda: torch.autograd.grad(out, (q, k, v), do,  # noqa: E731
                                       retain_graph=True)
    for _ in range(3):
        grad()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(10):
        grad()
    t1.record()
    t1.synchronize()
    library_ms = t0.elapsed_time(t1) / 10
    pairs = S * (S + 1) / 2                      # causal (q, k) pairs
    product = 2.0 * B * H * pairs * D            # one product's FLOPs
    in_bytes = 2 * (B * H * S * D * 2) + 2 * (B * KH * S * D * 2) \
        + 2 * (B * H * S * 4)
    rows = []
    for name, n_products, out_bytes, ms, site, err in (
            ("flash_bwd_dkdv", 4, 2 * B * KH * S * D * 2,
             times["random", "with"], 331, max(errs["dk"], errs["dv"])),
            ("flash_bwd_dq", 3, B * H * S * D * 2, dq_ms["random"], 372,
             errs["dq"])):
        b = bound(in_bytes + out_bytes, n_products * product, BF16_FLOPS)
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"kubeflow_tpu/ops/flash_attention.py:{site}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=library_ms))
    return rows


def event_ms(fn, iters: int = 3) -> float:
    """Device time of one ``fn()`` call between CUDA events, after one warm
    call: for work a CUDA graph cannot capture (autograd's own backward)
    or whose temporaries are too large to keep for a graph's replays."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def grad_ms(make, inputs, cotangent) -> float:
    """Device time of the backward alone of ``make(*inputs)`` for
    ``cotangent`` (the library yardstick of a backward kernel)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = make(*leaves)
    return event_ms(lambda: torch.autograd.grad(out, leaves, cotangent,
                                                retain_graph=True), iters=10)


def clocks_during(fn, seconds: float = 0.8) -> tuple[float, float]:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    while ``fn()`` runs back to back for about ``seconds``: the card lowers
    its clock under load near its power limit, by how much depending on the
    operands' bits."""
    samples: list[tuple[float, float]] = []
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=60).stdout.strip().splitlines()
            except (OSError, subprocess.SubprocessError):
                return
            try:
                clk, watts = (float(x) for x in out[0].split(","))
            except (IndexError, ValueError):
                continue
            samples.append((clk, watts))

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=sample, name="nvidia-smi")
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or (len(samples) < 3
                                                  and th.is_alive()):
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 10 * seconds:
            break
    stop.set()
    th.join()
    if not samples:
        return math.nan, math.nan
    return (sorted(c for c, _ in samples)[len(samples) // 2],
            sorted(w for _, w in samples)[len(samples) // 2])


def argmax_agrees(got: torch.Tensor, want: torch.Tensor, logits, name: str):
    """``correct`` from the kernel against the plain version's: a row may
    differ only where the plain logits' two largest values lie within 1e-4
    of each other (fp32 sums in another order may break such a near-tie
    either way). Returns the number of rows that differ."""
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        top = logits[diff].topk(2, dim=-1).values
        if torch.any(top[:, 0] - top[:, 1] > 1e-4 * top[:, 0].abs().clamp_min(1)):
            fail(f"{name}: correct differs from the plain version on a row "
                 "whose maximum is not a near-tie")
    return int(diff.numel())


def norm_swiglu_bwd_rows() -> list[dict]:
    """Sites 3 and 5 at the training shapes: the RMSNorm backward (T = B·S
    = 4096 rows of D = 4096, bf16 activations, the fp32 weight and its fp32
    dw, as the trainer holds them) and the SwiGLU backward (M = 14336)."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator("cuda").manual_seed(SEED + 8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    T, D, M, eps = 4096, 4096, 14336, 1e-5
    x, dh = rnd(T, D), rnd(T, D)
    w = 1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
    _, _, rstd = fn._norm_launch(x, None, w, eps, False)
    e_rms, timed = 0.0, {}
    # Without and with the residual cotangent dy (the residual norm ln2,
    # 4 of the 9 launches of a training step): each held against the
    # plain version, called twice for the same bits, timed whole and per
    # kernel (the row pass and the dw column sum).
    for label, kw in (("", {}), (" dy", {"dy": rnd(T, D)})):
        dx, dw = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
        rdx, rdw = fn.rmsnorm_bwd_ref(x, w, rstd, dh, **kw)
        e_dx = within(dx, rdx, f"rmsnorm_bwd{label} dx")
        e_dw = within(dw, rdw, f"rmsnorm_bwd{label} dw")
        e_rms = max(e_rms, e_dx, e_dw)
        dx2, dw2 = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
        if not (torch.equal(dx2, dx) and torch.equal(dw2, dw)):
            fail(f"rmsnorm_bwd{label}: two calls on the same inputs differ")
        reads = (4 if kw else 3) * T * D * 2
        b = bound(reads + 2 * D * 4 + T * 4, (9 if kw else 8) * T * D,
                  FP32_FLOPS)
        ms = device_ms(lambda kw=kw: fn.rmsnorm_bwd(x, w, rstd, dh, **kw))
        parts = kernel_parts(lambda kw=kw: fn.rmsnorm_bwd(x, w, rstd, dh,
                                                          **kw))
        print(f"kernel rmsnorm_bwd{label} T={T} D={D}: max_abs_err dx "
              f"{e_dx:.3e}, dw {e_dw:.3e}; a second call is bit-identical; "
              f"ms {ms:.6f}, bound_ms {b[0]:.6f} ({b[1]}), "
              f"{b[0] / ms:.1%} of it; per kernel (profiler): "
              + ", ".join(f"{k} {v:.6f} ms x{n:g}"
                          for k, v, n in parts), flush=True)
        timed[label] = (ms, b)
        del dx, dw, rdx, rdw, dx2, dw2
    ms, b_rms = timed[""]
    rows = [dict(
        name="rmsnorm_bwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:146", max_abs_err=e_rms,
        ms=ms, plain_ms=event_ms(lambda: fn.rmsnorm_bwd_ref(x, w, rstd, dh)),
        bound_ms=b_rms[0], bound_by=b_rms[1],
        # The library call takes the weight in x's dtype: its fused path
        # refuses an fp32 weight beside bf16 x.
        library_ms=grad_ms(lambda x, w: F.rms_norm(x, (D,), w, eps),
                           (x, w.to(x.dtype)), dh))]
    del x, dh
    g, u, do = rnd(T, M), rnd(T, M), rnd(T, M)
    e_sw = 0.0
    for act in ("silu", "gelu"):
        dg, du = fn.swiglu_bwd(g, u, do, act=act)
        rdg, rdu = fn.swiglu_bwd_ref(g, u, do, act=act)
        e = max(within(dg, rdg, f"swiglu_bwd {act} dg"),
                within(du, rdu, f"swiglu_bwd {act} du"))
        e_sw = max(e_sw, e)
        print(f"kernel swiglu_bwd {act} T={T} M={M}: max_abs_err {e:.3e}",
              flush=True)
    b_sw = bound(5 * T * M * 2, 10 * T * M, FP32_FLOPS)
    rows.append(dict(
        name="swiglu_bwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:301", max_abs_err=e_sw,
        ms=device_ms(lambda: fn.swiglu_bwd(g, u, do, act="silu")),
        plain_ms=event_ms(lambda: fn.swiglu_bwd_ref(g, u, do, act="silu")),
        bound_ms=b_sw[0], bound_by=b_sw[1],
        library_ms=grad_ms(lambda g, u: F.silu(g) * u, (g, u), do)))
    return rows


def xent_case(gen, T, D, V, *, softcap=None, ties=True):
    """Inputs of one fused-CE call: bf16 h [T, D] and W [D, V] (scale
    D^-1/2), int32 targets with 0 and V-1 in them, and an nll cotangent
    (1/T, zero on a few rows as a loss mask gives). With ``ties``, pairs of
    equal head columns are made the maxima of rows 2-5: columns 5 and 77
    (one 128-column tile), and two columns on either side of the first
    forward range boundary (or of a tile boundary when there is one range);
    rows 2 and 4 target the lower column, rows 3 and 5 the higher. Row 6
    targets V + 5, outside the vocab. Returns (h, W, t, g, expected correct
    {row: value})."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    h = torch.randn((T, D), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((D, V), generator=gen, device="cuda")
         * D ** -0.5).to(torch.bfloat16)
    t = torch.randint(0, V, (T,), generator=gen, device="cuda",
                      dtype=torch.int32)
    g = torch.full((T,), 1.0 / T, device="cuda")
    t[0] = 0
    if T > 1:
        t[1] = V - 1
    expect = {}
    if ties and T > 6:
        slots = fx.forward_slots(torch.device("cuda", 0))
        edge = fx._tiles_per_range(T, V, slots) * fx.TILE
        edge = edge if edge < V else fx.TILE
        for row, (a, b) in ((2, (5, 77)), (4, (edge - 3, edge + 5))):
            w[:, b] = w[:, a]
            h[row] = h[row + 1] = (8.0 * w[:, a].float()).to(torch.bfloat16)
            t[row], t[row + 1] = a, b
            expect[row], expect[row + 1] = 1.0, 0.0
        t[6] = V + 5
        expect[6] = 0.0
    if T > 9:
        g[7:10] = 0.0
    return h, w, t, g, expect


def check_xent(gen, T, D, V, *, softcap=None, name=None, keep=False):
    """The fused CE kernels against their plain versions on one case;
    returns ({"nll", "lse", "dh", "dw": max abs error}, the case when
    ``keep``). The cotangent 1/T makes d_hidden and d_head small (about
    1e-6 to 1e-3 at T = 4096), so their absolute floor is ATOL times the
    plain output's largest magnitude, and each whole output is also held
    to BWD_REL_L2: a zeroed or misplaced output fails both."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    name = name or f"fused_xent T={T} D={D} V={V} softcap={softcap}"
    h, w, t, g, expect = xent_case(gen, T, D, V, softcap=softcap)
    nll, lse, cor = fx.xent_fwd(h, w, t, softcap)
    dh, dw = fx.xent_bwd(h, w, t, lse, g, softcap)
    rn, rl, rc = fx.xent_fwd_ref(h, w, t, softcap)
    errs = {"nll": within(nll, rn, f"{name} nll"),
            "lse": within(lse, rl, f"{name} lse", atol=LSE_ATOL, rtol=0.0)}
    logits = fx._logits_ref(h, w, softcap)
    n_diff = argmax_agrees(cor, rc, logits, name)
    del logits
    for row, want in expect.items():
        if float(cor[row]) != want:
            fail(f"{name}: row {row} correct {float(cor[row])}, expected "
                 f"{want} (argmax ties go to the lowest index)")
    if T > 6 and float(nll[6]) != float(lse[6]):
        fail(f"{name}: an out-of-vocab target must give nll = lse")
    rdh, rdw = fx.xent_bwd_ref(h, w, t, rl, g, softcap)
    rels = {}
    for part, got, want in (("dh", dh, rdh), ("dw", dw, rdw)):
        scale = float(want.float().abs().max())
        errs[part] = within(got, want, f"{name} {part}", atol=ATOL * scale)
        rels[part] = rel_l2(got, want) if scale > 0 else 0.0
        if not rels[part] <= BWD_REL_L2:
            fail(f"{name} {part}: rel L2 {rels[part]:.3e} > {BWD_REL_L2:g}")
        # The bound must tell a wrong output from this one: zeros, and the
        # output shifted by one column.
        for bad in (torch.zeros_like(got), got.roll(1, -1)):
            if scale > 0 and rel_l2(bad, want) <= BWD_REL_L2:
                fail(f"{name} {part}: the rel L2 bound does not reject a "
                     "zeroed or shifted output")
    if T > 9 and torch.count_nonzero(dh[7:10]):
        fail(f"{name}: rows with a zero loss mask have a nonzero dh")
    print(f"{name}: max_abs_err nll {errs['nll']:.3e}, lse "
          f"{errs['lse']:.3e}, dh {errs['dh']:.3e}, dw {errs['dw']:.3e}; "
          f"rel L2 dh {rels['dh']:.3e}, dw {rels['dw']:.3e} (tolerance "
          f"{BWD_REL_L2:g}); "
          f"correct differs on {n_diff} near-tie rows"
          + ("; ties, targets 0 / V-1 / out of vocab and masked rows hold"
             if expect else ""), flush=True)
    del rdh, rdw
    return errs, ((h, w, t, g, lse) if keep else None)


def xent_bwd_parts(h, w, t, lse, g, calls: int = 2) -> dict:
    """Device ms per ``xent_bwd`` call of each of its kernels (dl
    recompute, d_hidden, d_head), from a profile of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops import fused_xent as fx

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fx.xent_bwd(h, w, t, lse, g)
        torch.cuda.synchronize()
    _, kernels = _kernel_times(prof)
    part = {k: sum(ms for key, ms, _ in kernels
                   if f"xent_{k}_kernel" in key) / calls
            for k in ("dl", "dh", "dw")}
    if not all(part.values()):
        fail(f"the CE backward's profile lacks one of its kernels: {part}")
    return part


def xent_repeat(h, w, t, g, name: str) -> None:
    """A second ``xent_fwd`` and ``xent_bwd`` on the same inputs must give
    the same bits: no atomics, fixed orders of every sum."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    outs = []
    for _ in range(2):
        nll, lse, cor = fx.xent_fwd(h, w, t)
        outs.append((nll, lse, cor, *fx.xent_bwd(h, w, t, lse, g)))
    for part, a, b in zip(("nll", "lse", "correct", "dh", "dw"), *outs):
        if not torch.equal(a, b):
            fail(f"{name}: a second call gave other bits in {part}")
    print(f"{name}: a second xent_fwd and xent_bwd gave the same bits (nll, "
          "lse, correct, dh, dw)", flush=True)


def xent_rows() -> list[dict]:
    """Sites 9-11 at the training shape (T = 2 x 2048 tokens, D = 4096,
    V = 128256). The backward launches, per vocab chunk, the dl recompute
    and then the d_hidden and d_head products from it; a profile of it
    splits its device time: row 10 is the recompute and d_hidden (2
    passes over the logits), row 11 the d_head product (1 pass), and the
    two bounds add up to the backward's 3. No one PyTorch call fuses the
    projection with the CE, so rows 9 and 10 have no library_ms. Row 11's
    is cuBLAS on the same work: ``torch.matmul(h.t(), dl_c)`` ([D, vc]
    bf16 out) for each vocab chunk at its width, the chunks' products in
    one timed call, on each chunk's dl from the plain recompute (the
    values the kernel writes to its scratch, up to the rounding of exp).
    The port's own
    ``_chunked_ce`` (forward and backward, cuBLAS products, the path with
    fused kernels off) is timed beside them, and so is cuBLAS's product
    h W alone (``torch.matmul``, one pass, [T, V] bf16 out) as a yardstick
    of the card's GEMM rate. Then the same calls twice must give the same
    bits, and the forward and backward are timed on sink inputs, where
    every logit of a row is equal and every tile's maximum a tie (h = 0,
    and W with all columns equal), beside the random ones, after a check
    of each against the plain version (correct is then exactly
    target == 0); cuBLAS's product is timed on them too, and the SM clock
    is read under the forward, as the card's own speed on such operands."""
    import dataclasses

    from kubeflow_tpu_torch.models import decoder as dec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator("cuda").manual_seed(SEED + 9)
    T, D, V = 4096, 4096, 128256
    errs, (h, w, t, g, lse) = check_xent(gen, T, D, V, keep=True)
    unit = 2.0 * T * D * V                   # one pass over the logits
    io = T * D * 2 + D * V * 2 + T * 4       # h, W, targets
    fwd_ms = device_ms(lambda: fx.xent_fwd(h, w, t), iters=2, reps=2)
    plain_fwd = event_ms(lambda: fx.xent_fwd_ref(h, w, t), iters=2)
    plain_bwd = event_ms(lambda: fx.xent_bwd_ref(h, w, t, lse, g), iters=2)
    both_ms = device_ms(lambda: fx.xent_bwd(h, w, t, lse, g), iters=2,
                        reps=2)
    part = xent_bwd_parts(h, w, t, lse, g)
    rows = []
    b = bound(io + 3 * T * 4, unit, BF16_FLOPS)
    rows.append(dict(
        name="fused_xent_fwd", route="cuda",
        source="kubeflow_tpu_torch/csrc/fused_xent.cu",
        replaces="kubeflow_tpu/ops/fused_xent.py:149",
        max_abs_err=max(errs["nll"], errs["lse"]), ms=fwd_ms,
        plain_ms=plain_fwd, bound_ms=b[0], bound_by=b[1], library_ms=None))
    ht, dls = h.t(), []
    for c0 in range(0, V, fx.VOCAB_CHUNK):
        logits = fx._logits_ref(h, w[:, c0:c0 + fx.VOCAB_CHUNK], None)
        dls.append(fx._dlogits_ref(logits, t - c0, lse, g, None).to(
            torch.bfloat16))
        del logits
    dw_cublas = event_ms(lambda: [torch.matmul(ht, d) for d in dls], iters=5)
    del dls
    torch.cuda.empty_cache()
    # Row 10 reads h, W, targets, lse and g and writes dh; row 11 reads h
    # and the recompute's dl and writes dW.
    for name, site, ms, nbytes, passes, err, library_ms in (
            ("fused_xent_bwd_dh", 245, part["dl"] + part["dh"],
             io + 2 * T * 4 + T * D * 2, 2, errs["dh"], None),
            ("fused_xent_bwd_dw", 262, part["dw"],
             T * D * 2 + T * V * 2 + D * V * 2, 1, errs["dw"], dw_cublas)):
        b = bound(nbytes, passes * unit, BF16_FLOPS)
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/fused_xent.cu",
            replaces=f"kubeflow_tpu/ops/fused_xent.py:{site}",
            max_abs_err=err, ms=ms, plain_ms=plain_bwd, bound_ms=b[0],
            bound_by=b[1], library_ms=library_ms))
    b_both = bound(io + 2 * T * 4 + T * D * 2 + D * V * 2, 3 * unit,
                   BF16_FLOPS)
    # The chunked CE of the fused-off path at the same shape: forward and
    # backward to hidden and head, 4 chunks of 512 positions.
    cfg = dataclasses.replace(preset("llama3-8b"), loss_chunk_size=512)
    hb = h.reshape(2, 2048, D).detach().clone().requires_grad_(True)
    wb = w.detach().clone().requires_grad_(True)
    tb = t.long().reshape(2, 2048).clamp(0, V - 1)

    def chunked():
        nll, _ = dec._chunked_ce(hb, wb, tb, cfg)
        torch.autograd.grad(nll.sum() / T, (hb, wb))

    chunked_ms = event_ms(chunked)
    del hb, wb, tb
    torch.cuda.empty_cache()
    cublas_ms = event_ms(lambda: torch.matmul(h, w), iters=5)
    torch.cuda.empty_cache()
    tflops = lambda passes, ms: passes * unit / (ms * 1e-3) / 1e12  # noqa: E731
    print(f"kernel fused_xent T={T} D={D} V={V}: forward {fwd_ms:.3f} ms "
          f"({tflops(1, fwd_ms):.0f} TFLOP/s; bound "
          f"{rows[0]['bound_ms']:.3f}); backward {both_ms:.3f} ms (bound "
          f"{b_both[0]:.3f}, 3 passes), profiled as dl recompute "
          f"{part['dl']:.3f} ({tflops(1, part['dl']):.0f} TFLOP/s) + "
          f"d_hidden {part['dh']:.3f} ({tflops(1, part['dh']):.0f}) + "
          f"d_head {part['dw']:.3f} ({tflops(1, part['dw']):.0f}) ms, "
          f"cuBLAS h^T dl over the same {len(range(0, V, fx.VOCAB_CHUNK))} "
          f"chunks {dw_cublas:.3f} ms ({tflops(1, dw_cublas):.0f} TFLOP/s); "
          f"forward + backward {fwd_ms + both_ms:.3f} ms against the chunked "
          f"CE's {chunked_ms:.3f} ms (cuBLAS, 4 passes); yardstick: "
          f"torch.matmul(h, W) [{T}, {D}] x [{D}, {V}] {cublas_ms:.3f} ms "
          f"({tflops(1, cublas_ms):.0f} TFLOP/s, one pass, [T, V] bf16 "
          "written)", flush=True)
    xent_repeat(h, w, t, g, f"fused_xent T={T} D={D} V={V}")
    clk = clocks_during(lambda: fx.xent_fwd(h, w, t))
    # Sink inputs, every row one long tie: h = 0 (every logit 0, zero
    # operands), and W with every column equal (random nonzero operands).
    sinks = (("h = 0", torch.zeros_like(h), w),
             ("equal columns", h, w[:, :1].expand(D, V).contiguous()))
    for label, hs, ws in sinks:
        nll0, lse0, cor0 = fx.xent_fwd(hs, ws, t)
        rn, rl, rc = fx.xent_fwd_ref(hs, ws, t)
        within(nll0, rn, f"sink ({label}) fused_xent nll")
        within(lse0, rl, f"sink ({label}) fused_xent lse", atol=LSE_ATOL,
               rtol=0.0)
        if not torch.equal(cor0, (t == 0).float()) or \
                not torch.equal(cor0, rc):
            fail(f"sink ({label}) fused_xent: with every logit of a row "
                 "equal, correct must be exactly target == 0 (the lowest "
                 "index)")
        rdh, rdw = fx.xent_bwd_ref(hs, ws, t, rl, g)
        dh0, dw0 = fx.xent_bwd(hs, ws, t, lse0, g)
        for grad, got, want in (("dh", dh0, rdh), ("dw", dw0, rdw)):
            within(got, want, f"sink ({label}) fused_xent {grad}",
                   atol=ATOL * float(want.float().abs().max()))
        del rn, rl, rc, rdh, rdw, dh0, dw0
        sink_fwd = device_ms(lambda: fx.xent_fwd(hs, ws, t), iters=2, reps=2)
        sink = xent_bwd_parts(hs, ws, t, lse0, g)
        sink_mm = event_ms(lambda: torch.matmul(hs, ws), iters=5)
        sink_clk = clocks_during(lambda: fx.xent_fwd(hs, ws, t))
        print(f"kernel fused_xent sink inputs ({label}): forward "
              f"{sink_fwd:.3f} ms ({sink_fwd / fwd_ms:.3f}x random), dl "
              f"recompute + d_hidden {sink['dl'] + sink['dh']:.3f} ms "
              f"({(sink['dl'] + sink['dh']) / (part['dl'] + part['dh']):.3f}"
              f"x random), d_head {sink['dw']:.3f} ms; cuBLAS's h W "
              f"{sink_mm:.3f} ms ({sink_mm / cublas_ms:.3f}x random); SM "
              f"clock under the forward {sink_clk[0]:.0f} MHz at "
              f"{sink_clk[1]:.0f} W (random: {clk[0]:.0f} MHz at "
              f"{clk[1]:.0f} W); the results match the plain version",
              flush=True)
        del hs, ws
        torch.cuda.empty_cache()
    return rows


def phase_xent_edges(gen=None) -> None:
    """The fused CE away from the training shape, against its plain
    version: T in {1, 300, 3000, 4096}, V in {1000, 128256, 256000, 20000,
    32000} (32000: Mixtral's vocabulary, at its training shape T = 4096,
    D = 4096 and at a T ragged in the row tiles)
    (ragged last tile, one tile, many ranges, the backward's last chunk of
    13568 columns at 128256, and at 20000 a last chunk of 3616, ragged in
    its tiles and in the d_hidden product's K, after one whole chunk),
    32064: a vocab shard of Llama-3's 128256 over 4 ranks, a multiple of 8
    and not of 256, whose last forward tile is a quarter full and whose
    backward's last chunk of 15680 columns is ragged in its tiles),
    D in {1160, 2048, 4096} (1160, a multiple of 8 and not of 64: ragged K
    in the forward and dl, ragged N in d_hidden, and in d_head ragged A
    boxes, one wholly past D, and ragged output rows), softcap 30, with
    argmax ties inside a tile and across a range boundary, targets 0, V-1
    and out of vocab, and masked rows (exactly zero dh)."""
    gen = gen or torch.Generator("cuda").manual_seed(SEED + 10)
    for T, D, V, cap in ((1, 2048, 1000, None), (300, 4096, 1000, 30.0),
                         (4096, 2048, 1000, None), (1, 4096, 128256, 30.0),
                         (300, 2048, 128256, None), (300, 4096, 256000, 30.0),
                         (4096, 2048, 256000, None), (300, 2048, 20000, None),
                         (300, 1160, 20000, None), (4096, 4096, 32000, None),
                         (3000, 4096, 32000, None), (4096, 4096, 32064, None),
                         (300, 2048, 32064, 30.0)):
        check_xent(gen, T, D, V, softcap=cap,
                   name=f"edge fused_xent T={T} D={D} V={V} softcap={cap}")
        torch.cuda.empty_cache()


def phase_train_edges() -> None:
    """The training kernels away from the training shape, each against its
    plain version: the fused CE (``phase_xent_edges``); the RMSNorm
    backward at D in {2048, 3072, 4096} (3072: a masked row block), T in
    {1, 300}, with and without (1 + w) and the residual cotangent; the
    SwiGLU backward (silu, gelu) at odd M."""
    gen = torch.Generator("cuda").manual_seed(SEED + 10)
    phase_xent_edges(gen)
    phase_norm_bwd_edges(gen)


def phase_norm_bwd_edges(gen=None) -> None:
    """The RMSNorm backward at D in {2048, 3072, 4096} (3072: a masked row
    block), T in {1, 300}, with and without (1 + w) and the residual
    cotangent, each called twice for the same bits; the SwiGLU backward
    (silu, gelu) at odd M."""
    from kubeflow_tpu_torch.ops import fused_norm as fn

    gen = gen or torch.Generator("cuda").manual_seed(SEED + 10)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for T in (1, 300):
        for D, plus_one, residual in ((2048, False, True), (3072, True, False),
                                      (4096, True, True)):
            x, dh, dy = rnd(T, D), rnd(T, D), rnd(T, D)
            w = 0.1 * torch.randn((D,), generator=gen, device="cuda")
            _, _, rstd = fn._norm_launch(x, None, w, 1e-6, plus_one)
            kw = dict(plus_one=plus_one, dy=dy if residual else None)
            dx, dw = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
            rdx, rdw = fn.rmsnorm_bwd_ref(x, w, rstd, dh, **kw)
            name = (f"edge rmsnorm_bwd T={T} D={D} plus_one={plus_one} "
                    f"residual={residual}")
            e = max(within(dx, rdx, name + " dx"), within(dw, rdw, name + " dw"))
            dx2, dw2 = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
            if not (torch.equal(dx2, dx) and torch.equal(dw2, dw)):
                fail(f"{name}: two calls on the same inputs differ")
            print(f"{name}: max_abs_err {e:.3e}; a second call is "
                  "bit-identical", flush=True)
        for M in (1001, 14336):
            g, u, do = rnd(T, M), rnd(T, M), rnd(T, M)
            for act in ("silu", "gelu"):
                dg, du = fn.swiglu_bwd(g, u, do, act=act)
                rdg, rdu = fn.swiglu_bwd_ref(g, u, do, act=act)
                name = f"edge swiglu_bwd {act} T={T} M={M}"
                e = max(within(dg, rdg, name + " dg"),
                        within(du, rdu, name + " du"))
                print(f"{name}: max_abs_err {e:.3e}", flush=True)
    explain_bwd_edges(gen)


def explain_bwd_edges(gen) -> None:
    """The explainer's backward shapes: a 37-token prompt (a multiple of no
    tile) through serving weights — bf16 and needing no gradient, so the
    RMSNorm backward neither stores dw partials nor sums them. Each kernel
    against its plain version, timed (the kernel table's T = 37 note); then
    the norm and SwiGLU ``autograd.Function``s with only the activation
    requiring grad must give the weight no gradient and the plain
    backward's dx."""
    from kubeflow_tpu_torch.ops import fused_norm as fn

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    T, D, M, eps = 37, 4096, 14336, 1e-5
    w = (1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(
        torch.bfloat16)
    x, dh, dy = rnd(T, D), rnd(T, D), rnd(T, D)
    _, _, rstd = fn._norm_launch(x, None, w, eps, False)
    for label, kw in (("", {}), (" dy", {"dy": dy})):
        name = f"edge rmsnorm_bwd{label} T={T} D={D} bf16 w"
        dx, dw = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
        rdx, rdw = fn.rmsnorm_bwd_ref(x, w, rstd, dh, **kw)
        e = max(within(dx, rdx, name + " dx"), within(dw, rdw, name + " dw"))
        dx2, none = fn.rmsnorm_bwd(x, w, rstd, dh, need_dw=False, **kw)
        if none is not None or not torch.equal(dx2, dx):
            fail(f"{name}: need_dw=False changed dx or returned a dw")
        b = bound((4 if kw else 3) * T * D * 2 + D * 2 + T * 4,
                  (9 if kw else 8) * T * D, FP32_FLOPS)
        ms = device_ms(lambda kw=kw: fn.rmsnorm_bwd(x, w, rstd, dh,
                                                    need_dw=False, **kw))
        print(f"{name}: max_abs_err {e:.3e}; without dw (the explainer's "
              f"call) bit-identical dx, ms {ms:.6f}, bound_ms {b[0]:.6f} "
              f"({b[1]})", flush=True)
    g, u, do = rnd(T, M), rnd(T, M), rnd(T, M)
    dg, du = fn.swiglu_bwd(g, u, do, act="silu")
    rdg, rdu = fn.swiglu_bwd_ref(g, u, do, act="silu")
    name = f"edge swiglu_bwd silu T={T} M={M}"
    e = max(within(dg, rdg, name + " dg"), within(du, rdu, name + " du"))
    b = bound(5 * T * M * 2, 10 * T * M, FP32_FLOPS)
    ms = device_ms(lambda: fn.swiglu_bwd(g, u, do, act="silu"))
    print(f"{name}: max_abs_err {e:.3e}, ms {ms:.6f}, bound_ms {b[0]:.6f} "
          f"({b[1]})", flush=True)
    # The autograd Functions, weight without grad: dx of the plain backward.
    xg = x[None].clone().requires_grad_(True)
    (got,) = torch.autograd.grad(fn.rmsnorm_fused(xg, w, eps=eps), xg,
                                 dh[None])
    within(got[0], fn.rmsnorm_bwd_ref(x, w, rstd, dh)[0],
           "edge rmsnorm_fused autograd, bf16 w without grad")
    yg, hg = fn.add_rmsnorm_fused(xg, dy[None], w, eps=eps)
    (got,) = torch.autograd.grad((yg, hg), xg, (dy[None], dh[None]))
    _, _, rstd_y = fn._norm_launch(x + dy, None, w, eps, False)
    within(got[0], fn.rmsnorm_bwd_ref(x + dy, w, rstd_y, dh, dy=dy)[0],
           "edge add_rmsnorm_fused autograd, bf16 w without grad")
    gg = g.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(fn.swiglu_fused(gg, u), gg, do)
    within(got, rdg, "edge swiglu_fused autograd, up without grad")
    if w.grad is not None or u.grad is not None:
        fail("edge autograd: a tensor that needs no gradient got one")
    print(f"edge norm and SwiGLU autograd.Functions T={T}: weights without "
          "grad get none; dx equals the plain backward's", flush=True)


def phase_memory_probe() -> None:
    """The fused CE never holds [T, V] logits: the peak allocation of its
    forward and backward at T = 4096, D = 4096, V = 128256 (bf16), less
    what was allocated before the call and the two gradients it must
    return, stays within one eighth of one fp32 [T, V] tensor. The plain
    path's peak is printed beside it."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    T, D, V = 4096, 4096, 128256
    h, w, t, g, _ = xent_case(gen, T, D, V, ties=False)
    mask = (g > 0).float()
    limit = T * V * 4 / 8
    peaks = {}
    for name, fn in (("fused", fx.fused_cross_entropy),
                     ("plain", fx.reference_cross_entropy)):
        hl = h.detach().clone().requires_grad_(True)
        wl = w.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        nll, _ = fn(hl, wl, t)
        loss = (nll * mask).sum() / mask.sum()
        grads = torch.autograd.grad(loss, (hl, wl))
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - before
                       - sum(x.numel() * x.element_size() for x in grads))
        del hl, wl, nll, loss, grads
        torch.cuda.empty_cache()
    print(f"memory probe T={T} D={D} V={V}: fused CE forward+backward peak "
          f"beyond its inputs and gradients {peaks['fused'] / 1e6:.1f} MB "
          f"(limit {limit / 1e6:.1f} MB, one eighth of an fp32 [T, V]); the "
          f"plain path's {peaks['plain'] / 1e6:.1f} MB", flush=True)
    if not peaks["fused"] <= limit:
        fail("the fused CE allocated more than its memory bound")


def paged_case(gen, B, H, KH, D, page, lengths, *, quant=False, mpp=None,
               spare=3, unmapped=()):
    """Inputs of one paged-decode call: bf16 q, a pool with ``spare`` pages
    no table names (plus the engine's sink page last), a table that scatters
    each slot's pages over the pool in random order, and ``lengths``.
    ``unmapped`` lists (slot, page slot) entries set to -1. An int8 pool is
    quantized from bf16 K/V by ``quantize_kv``, as the engine writes it."""
    from kubeflow_tpu_torch.ops.quantization import quantize_kv

    mpp = mpp or max(-(-(int(max(lengths)) + 1) // page), 1)
    P = B * mpp + spare + 1
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((P, page, KH, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((P, page, KH, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    perm = torch.argsort(torch.rand(B * mpp, generator=gen, device="cuda"))
    table = perm.reshape(B, mpp).to(torch.int32)
    for b, j in unmapped:
        table[b, j] = -1
    lens = torch.tensor(lengths, dtype=torch.int64, device="cuda")
    case = {"q": q, "pool_k": k, "pool_v": v, "table": table, "lengths": lens}
    if quant:
        case["pool_k"], case["pool_ks"] = quantize_kv(k)
        case["pool_v"], case["pool_vs"] = quantize_kv(v)
    return case


def paged_call(fn, case):
    return fn(case["q"], case["pool_k"], case["pool_v"], case["table"],
              case["lengths"], pool_ks=case.get("pool_ks"),
              pool_vs=case.get("pool_vs"))


def paged_bytes(case) -> int:
    """Bytes one call must move: the K/V rows (and int8 scales) of every
    position 0..lengths[b] of every slot, read once, plus q, the table,
    the lengths and the output."""
    _, page, KH, D = case["pool_k"].shape
    pos = int((case["lengths"] + 1).sum())
    row = 2 * KH * D * case["pool_k"].element_size()
    if "pool_ks" in case:
        row += 2 * KH * 4
    q = case["q"]
    return (pos * row + 2 * q.numel() * q.element_size()
            + case["table"].numel() * 4 + case["lengths"].numel() * 8)


def paged_flops(case) -> float:
    """QK and PV products over every attended position (2 FLOP each per
    multiply-add), in fp32 on the CUDA cores."""
    _, _, H, D = case["q"].shape
    return 4.0 * H * D * float((case["lengths"] + 1).sum())


def tickets_zero(name: str) -> None:
    """Fail unless every ticket counter the paged-decode kernel has been
    given is back at zero (the last split block of each (slot, kv head)
    resets its own; one left nonzero breaks every later call there)."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    torch.cuda.synchronize()
    for held in PA._TICKETS.values():
        for buf in held:
            if torch.count_nonzero(buf):
                fail(f"{name}: the paged-decode kernel left a ticket "
                     "counter nonzero")


def paged_checked(fn, case, name: str) -> torch.Tensor:
    """``paged_call`` of the kernel's wrapper, then the counters checked."""
    out = paged_call(fn, case)
    tickets_zero(name)
    return out


def paged_one_launch(case, name: str) -> None:
    """One call of the wrapper runs exactly one CUDA kernel, the split
    kernel, which merges its own splits (the profiler's count)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops import paged_attention as PA

    paged_call(PA.paged_decode_attention, case)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        paged_call(PA.paged_decode_attention, case)
        torch.cuda.synchronize()
    _, kernels = _kernel_times(prof)
    if [("paged_decode_split_kernel" in k, n) for k, _, n in kernels] != \
            [(True, 1)]:
        fail(f"{name}: one call ran {kernels}, not the split kernel once")
    tickets_zero(name)


def paged_graph_repeat(case, name: str, calls: int = 20,
                       replays: int = 50) -> None:
    """``calls`` calls of ``case`` captured in one CUDA graph and replayed
    ``replays`` times: every call of every replay must give the bits of an
    eager call (a counter left nonzero, or a block that merges before its
    peers' partials land, shows here), and the counters end at zero."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    want = paged_checked(PA.paged_decode_attention, case, name)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            paged_call(PA.paged_decode_attention, case)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [paged_call(PA.paged_decode_attention, case)
                for _ in range(calls)]
    differ = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(replays):
        graph.replay()
        differ += (torch.stack(outs) != want).sum()
    if int(differ):
        fail(f"{name}: {int(differ)} output elements over {replays} graph "
             f"replays of {calls} calls differ from an eager call")
    tickets_zero(name)
    print(f"kernel {name}: {calls} calls in a CUDA graph, replayed "
          f"{replays} times, give an eager call's bits every time; the "
          "counters end at zero", flush=True)


def paged_kernel_rows() -> list[dict]:
    """Site 12: the paged-decode kernel (the split kernel, whose last block
    of each (slot, kv head) merges the splits) against its plain version at
    the serving shape (8 slots, 32 query over 8 kv heads of 128, pages of
    128, 16 page slots), bf16 and int8 pools, with the split count the
    wrapper chose: one kernel launch per call, the ticket counters zero
    after every call, and a CUDA graph of the recorded case whose replays
    repeat its bits. The recorded time is at length 2047, whose ~67 MB of
    bf16 K/V exceeds the 50 MB L2; length 1024 (~34 MB, served from L2 on
    back-to-back replays) is printed beside it, and so are 1 and 32 slots
    at length 2047 and the recorded case at named split counts."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    H, KH, D, page, mpp = 32, 8, 128, 128, 16
    rows, recorded = [], {}
    for name, quant in (("paged_decode", False), ("paged_decode_int8", True)):
        slots = PA._slots(0, D, page, H // KH, quant)
        print(f"kernel {name}: the card holds {slots} split blocks at once",
              flush=True)
        err, timed = 0.0, None
        for B, length in ((8, 2047), (8, 1024), (1, 2047), (32, 2047)):
            case = paged_case(gen, B, H, KH, D, page, [length] * B,
                              quant=quant, mpp=mpp)
            label = f"{name} B={B} length {length}"
            e = within(paged_checked(PA.paged_decode_attention, case, label),
                       paged_call(PA.paged_decode_ref, case), label)
            err = max(err, e)
            ms = device_ms(lambda: paged_call(PA.paged_decode_attention,
                                              case))
            tickets_zero(label)
            b = bound(paged_bytes(case), paged_flops(case), FP32_FLOPS)
            print(f"kernel {name} B={B} H={H} KH={KH} D={D} page={page} "
                  f"length={length} splits "
                  f"{PA._num_splits(B, KH, mpp, slots)}: max_abs_err "
                  f"{e:.3e}, ms {ms:.4f}, bound_ms {b[0]:.4f} ({b[1]}, "
                  f"{paged_bytes(case) / 1e6:.1f} MB"
                  f"{', fits the 50 MB L2' if length == 1024 else ''})",
                  flush=True)
            if timed is None:
                timed = (case, ms, b)
        case, ms, b = timed
        recorded[name] = case
        paged_one_launch(case, name)
        paged_graph_repeat(case, name)
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/paged_decode.cu",
            replaces="kubeflow_tpu/ops/paged_attention.py:169",
            max_abs_err=err, ms=ms,
            plain_ms=device_ms(lambda: paged_call(PA.paged_decode_ref, case),
                               iters=2, reps=3),
            bound_ms=b[0], bound_by=b[1],
            # No single PyTorch call attends over a page table.
            library_ms=None))
    # The recorded bf16 case at named split counts (the wrapper's choice
    # from shapes is printed above).
    case = recorded["paged_decode"]
    sweep = {n: device_ms(lambda n=n: PA._launch(
        case["q"], case["pool_k"], case["pool_v"], case["table"],
        case["lengths"], None, None, D ** -0.5, splits=n))
        for n in (1, 2, 4, 8, 16)}
    tickets_zero("paged_decode split sweep")
    print("kernel paged_decode B=8 length=2047 ms by split count: "
          + ", ".join(f"{n}: {ms:.4f}" for n, ms in sweep.items()),
          flush=True)
    return rows


def phase_edges() -> None:
    """The kernels away from the serving shapes, each against its plain
    version: ragged edges (lengths not a multiple of a tile or block), a
    static q_offset, head_dim 64, a non-causal Sq != Skv block with softcap
    and an explicit scale, one query row, the (1 + w) norm, odd widths and
    strided inputs."""
    phase_norm_edges()
    phase_flash_edges()
    phase_flash_bwd_edges()
    phase_train_edges()
    phase_paged_edges()


def phase_norm_edges() -> None:
    """The norm and SwiGLU forwards away from the serving shapes: T of 1, 5
    and 37, D of 1000 and 3072 (masked row blocks), the (1 + w) norm, and
    SwiGLU/GeGLU on strided [6, 1000] views."""
    from kubeflow_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator("cuda").manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for T, D, plus_one in ((1, 4096, True), (37, 1000, False),
                           (5, 3072, True)):
        x, res, w = rnd(T, D), rnd(T, D), rnd(D)
        e = within(fn.rmsnorm_fused(x, w, eps=1e-6, plus_one=plus_one),
                   fn.rmsnorm_ref(x, w, eps=1e-6, plus_one=plus_one),
                   f"rmsnorm T={T} D={D}")
        y, o = fn.add_rmsnorm_fused(x, res, w, eps=1e-6, plus_one=plus_one)
        yr, orf = fn.add_rmsnorm_ref(x, res, w, eps=1e-6, plus_one=plus_one)
        e = max(e, within(y, yr, f"add_rmsnorm y T={T} D={D}"),
                within(o, orf, f"add_rmsnorm o T={T} D={D}"))
        print(f"edge norms T={T} D={D} plus_one={plus_one}: max_abs_err "
              f"{e:.3e}", flush=True)
    wide = rnd(6, 2 * 1000)
    g, u = wide[:, :1000], wide[:, 1000:]          # strided views
    for act in ("silu", "gelu"):
        e = within(fn.swiglu_fused(g, u, act=act),
                   fn.swiglu_ref(g, u, act=act), f"swiglu {act} 6x1000")
        print(f"edge swiglu {act} [6, 1000] strided: max_abs_err {e:.3e}",
              flush=True)


def phase_flash_edges() -> None:
    """The flash forward against its plain version away from the prefill
    shape: ragged lengths around its 128-row tiles (127, 128, 129, 255,
    257), a static q_offset, a causal diagonal that crosses a q tile off
    its boundary (Sq = 200, Skv = 328, q_offset = 128), head_dim 64 with
    one and four query heads per kv head, eight query heads per kv head at
    B = 3, a non-causal Sq != Skv block with softcap and an explicit scale,
    one query row, and rows that see no key (q_offset -5, -70, and -200,
    where a whole 128-row tile sees none): they average V over every key
    and their lse is NEG_INF, as in the plain version."""
    from kubeflow_tpu_torch.ops.flash_attention import (
        flash_attention, flash_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    # (B, H, KH, Sq, Skv, D, causal, q_offset, softcap, sm_scale)
    cases = ((2, 4, 2, 200, 200, 128, True, 0, None, None),
             (1, 8, 8, 130, 200, 64, True, 70, None, None),
             (1, 8, 2, 77, 333, 128, False, 0, 20.0, 0.1),
             (3, 32, 8, 1, 517, 128, True, 516, None, None),
             *((1, 8, 2, n, n, 128, True, 0, None, None)
               for n in (127, 128, 129, 255, 257)),
             (1, 8, 2, 200, 328, 128, True, 128, None, None),
             (2, 8, 8, 257, 257, 64, True, 0, 30.0, None),
             (1, 8, 2, 129, 129, 64, True, 0, None, None),
             (3, 32, 4, 129, 129, 128, True, 0, None, None),
             (1, 8, 2, 200, 200, 128, True, -5, None, None),
             (1, 4, 2, 200, 200, 128, True, -70, None, None),
             (1, 4, 2, 300, 300, 64, True, -200, None, None))
    for B, H, KH, Sq, Skv, Dh, causal, off, cap, scale in cases:
        q, k, v =rnd(B, Sq, H, Dh), rnd(B, Skv, KH, Dh), rnd(B, Skv, KH, Dh)
        o, lse = flash_attention(q, k, v, causal=causal, q_offset=off,
                                 logits_softcap=cap, sm_scale=scale)
        ro, rl = flash_ref(*(t.transpose(1, 2).contiguous()
                             for t in (q, k, v)),
                           causal=causal, sm_scale=scale or Dh ** -0.5,
                           softcap=cap, q_offset=off)
        name = (f"flash B={B} H={H} KH={KH} Sq={Sq} Skv={Skv} D={Dh} "
                f"causal={causal} q_offset={off} softcap={cap}")
        e_o = within(o, ro.transpose(1, 2), name)
        e_l = within(lse, rl, name + " lse", atol=LSE_ATOL, rtol=0.0)
        print(f"edge {name}: max_abs_err o {e_o:.3e}, lse {e_l:.3e}",
              flush=True)


# Edge cases of the flash backward, in the order phase_flash_bwd_edges draws
# their inputs from one generator: (B, H, KH, Sq, Skv, D, causal, q_offset,
# softcap).
FLASH_BWD_EDGES = (
    (1, 8, 2, 1, 1, 128, True, 0, None),
    (1, 8, 2, 63, 63, 128, True, 0, None),
    (1, 8, 2, 64, 64, 64, True, 0, None),
    (1, 8, 8, 65, 65, 128, True, 0, None),
    (1, 8, 1, 1000, 1000, 128, True, 0, 30.0),
    (1, 4, 2, 2047, 2047, 128, True, 0, None),
    (2, 4, 2, 300, 1000, 64, True, 700, None),
    (1, 4, 2, 200, 200, 128, False, 0, 20.0),
    (1, 4, 2, 128, 128, 64, True, -5, None),
    *((1, 8, 2, n, n, 128, True, 0, None)
      for n in (127, 128, 129, 255, 257)),
    (1, 8, 2, 200, 328, 128, True, 128, None),
    (1, 8, 8, 257, 257, 64, True, 0, None),
    (3, 32, 4, 129, 129, 128, True, 0, None),
    (1, 4, 2, 200, 200, 128, True, -70, None))


def phase_flash_bwd_edges() -> None:
    """The two backward kernels against the plain backward away from the
    training shape: S = 1, 63, 64, 65, 127, 128, 129, 255, 257, 1000 and
    2047 (ragged tiles of both kernels), a causal diagonal that crosses a
    kv tile off its boundary (Sq = 200, Skv = 328, q_offset = 128),
    head_dim 64, one, four and eight query heads per kv head (eight at
    B = 3), softcap, Sq < Skv at q_offset = Skv - Sq, a non-causal block,
    and rows that see no key (negative q_offset: lse is NEG_INF; their dq
    must be zero and their cotangents must not move dk or dv)."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    for B, H, KH, Sq, Skv, D, causal, off, cap in FLASH_BWD_EDGES:
        args, kw = bwd_case(gen, B, H, KH, Sq, Skv, D, causal=causal,
                            q_offset=off, softcap=cap)
        name = (f"flash_bwd B={B} H={H} KH={KH} Sq={Sq} Skv={Skv} D={D} "
                f"causal={causal} q_offset={off} softcap={cap}")
        errs, rel, (dq, dk, dv) = check_bwd(args, kw, name)
        note = ""
        if off < 0:
            if torch.count_nonzero(dq[:, :, :-off]):
                fail(f"{name}: rows that see no key have a nonzero dq")
            do = args[3].clone()
            do[:, :, :-off] = 100.0
            dk2, dv2 = FA.flash_bwd_dkdv(*args[:3], do, *args[4:], **kw)
            if not (torch.equal(dk2, dk) and torch.equal(dv2, dv)):
                fail(f"{name}: the cotangents of rows that see no key move "
                     "dk or dv")
            note = "; rows with no key give zero dq and move no dk/dv"
        print(f"edge {name}: max_abs_err {max(errs.values()):.3e}, rel L2 "
              f"{rel:.3e}{note}", flush=True)


def phase_paged_edges() -> None:
    """The paged-decode kernel against its plain version away from the
    serving shape: length 0, lengths on and one short of page boundaries,
    unmapped table entries, a dead row (no mapped page: zeros), pages no
    table names poisoned with 999 (the output must not move), head_dim 64,
    one and eight query heads per kv head, pages of 16, and int8 pools
    whose scale planes carry outliers. The ticket counters must be zero
    after every call."""
    from kubeflow_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    # (B, H, KH, D, page, lengths, quant, unmapped (slot, page slot))
    cases = (
        (6, 32, 8, 128, 128, [0, 127, 128, 255, 256, 1000], False,
         ((5, 3),)),
        (6, 32, 8, 128, 128, [0, 127, 128, 255, 256, 1000], True,
         ((5, 3),)),
        (3, 8, 8, 64, 16, [15, 16, 100], False, ((2, 1),)),
        (3, 64, 8, 128, 16, [31, 32, 299], True, ()),
        (2, 16, 2, 64, 32, [63, 64], True, ()),
        (4, 8, 1, 128, 48, [47, 48, 95, 200], False, ()),
    )
    for B, H, KH, D, page, lengths, quant, unmapped in cases:
        case = paged_case(gen, B, H, KH, D, page, lengths, quant=quant,
                          unmapped=unmapped)
        name = (f"paged_decode B={B} H={H} KH={KH} D={D} page={page} "
                f"lengths={lengths} int8={quant} unmapped={list(unmapped)}")
        if quant:
            # Outlier tokens: a few scale entries 1000x their neighbours.
            for plane in ("pool_ks", "pool_vs"):
                s = case[plane]
                idx = torch.randint(0, s.numel(), (max(s.numel() // 97, 1),),
                                    generator=gen, device="cuda")
                s.view(-1)[idx] *= 1000.0
        out = paged_checked(paged_decode_attention, case, name)
        e = within(out, paged_call(paged_decode_ref, case), name)
        if not torch.equal(paged_checked(paged_decode_attention, case, name),
                           out):
            fail(f"{name}: two calls on the same inputs differ")
        poison_spare_pages(case)
        if not torch.equal(paged_checked(paged_decode_attention, case, name),
                           out):
            fail(f"{name}: the output moved when unmapped pages changed")
        # A dead row: every table entry unmapped, so the output is zeros.
        case["table"][0] = -1
        dead = paged_checked(paged_decode_attention, case, name)[0]
        if torch.count_nonzero(dead):
            fail(f"{name}: a row with no mapped page is not all zeros")
        print(f"edge {name}: max_abs_err {e:.3e}; a second call is "
              "bit-identical; poisoned unmapped pages change nothing; a dead "
              "row is zeros; the counters are zero after every call", flush=True)
    phase_paged_split_edges()


def poison_spare_pages(case) -> None:
    """Fill the pages no table entry names (the spare pages and the sink)
    with 999 (99 in int8 pages, which hold at most 127; their scales with
    999): a kernel that reads none of them gives the same bits."""
    named = case["table"][case["table"] >= 0].long().unique()
    spare = torch.ones(case["pool_k"].shape[0], dtype=torch.bool,
                       device="cuda")
    spare[named] = False
    poison = 99 if "pool_ks" in case else 999
    for plane in ("pool_k", "pool_v"):
        case[plane][spare] = poison
    for plane in ("pool_ks", "pool_vs"):
        if plane in case:
            case[plane][spare] = 999.0


# Edge cases of the split over pages, each run at the split counts listed
# (the wrapper's own choice aside): (B, H, KH, D, page, mpp, lengths, int8,
# unmapped (slot, page slot), split counts).
PAGED_SPLIT_EDGES = (
    # Slots whose later splits all start past their length.
    (4, 32, 8, 128, 128, 16, [100, 700, 2047, 128], False, (),
     (1, 2, 3, 5, 16)),
    # With 3 splits of 4 page slots, slot 0's split 1 is all unmapped
    # between counted splits 0 and 2.
    (2, 8, 2, 128, 16, 12, [190, 100], False,
     ((0, 4), (0, 5), (0, 6), (0, 7)), (3, 4)),
    # mpp = 13 under split counts that do not divide it.
    (3, 16, 4, 64, 16, 13, [207, 150, 0], False, ((1, 6),),
     (2, 3, 4, 5, 6, 13)),
    (3, 16, 4, 128, 16, 13, [207, 150, 0], True, ((1, 6),), (4, 5)),
)


def phase_paged_split_edges() -> None:
    """The split kernel, merging in its last block, against the plain
    version at split counts the caller names: every count must agree with
    ``paged_decode_ref``, repeat its bits on a second call, keep them when
    the pages no table names are poisoned, and leave the ticket counters
    zero after every call."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    for (B, H, KH, D, page, mpp, lengths, quant, unmapped,
         counts) in PAGED_SPLIT_EDGES:
        case = paged_case(gen, B, H, KH, D, page, lengths, quant=quant,
                          mpp=mpp, unmapped=unmapped)
        name = (f"paged_decode split B={B} H={H} KH={KH} D={D} page={page} "
                f"mpp={mpp} lengths={lengths} int8={quant} "
                f"unmapped={list(unmapped)}")

        def run(n):
            out = PA._launch(case["q"], case["pool_k"], case["pool_v"],
                             case["table"], case["lengths"],
                             case.get("pool_ks"), case.get("pool_vs"),
                             D ** -0.5, splits=n)
            tickets_zero(f"{name} splits={n}")
            return out

        ref = paged_call(PA.paged_decode_ref, case)
        outs, err = {}, 0.0
        for n in counts:
            outs[n] = run(n)
            err = max(err, within(outs[n], ref, f"{name} splits={n}"))
            if not torch.equal(run(n), outs[n]):
                fail(f"{name} splits={n}: two calls on the same inputs "
                     "differ")
        poison_spare_pages(case)
        for n in counts:
            if not torch.equal(run(n), outs[n]):
                fail(f"{name} splits={n}: the output moved when unmapped "
                     "pages changed")
        print(f"edge {name}: splits {list(counts)} max_abs_err {err:.3e}; "
              "each bit-identical on a second call and with poisoned "
              "unmapped pages; the counters zero after every call",
              flush=True)


def _post(url: str, body: dict, timeout: float = 600.0,
          headers: dict | None = None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def text(n_tokens: int, salt: int) -> str:
    """A prompt of ``n_tokens`` tokens under the byte tokenizer (one token
    per byte plus BOS)."""
    return "".join(chr(97 + (i * 7 + salt) % 26) for i in range(n_tokens - 1))


def _series(url: str, name: str) -> float:
    """One series of a replica's ``/metrics`` (its single model's sample)."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        for ln in resp.read().decode().splitlines():
            if ln.startswith(name + "{") or ln.startswith(name + " "):
                return float(ln.rsplit(" ", 1)[1])
    return 0.0


def _resident_pages(url: str) -> float:
    """``kftpu_engine_kv_pages_resident`` as ``/metrics`` shows it."""
    return _series(url, "kftpu_engine_kv_pages_resident")


def serve_http(engine, calls, wrappers: dict, label: str,
               watch_pages: bool = False) -> dict:
    """Serve ``calls`` ([(name, path, body)], all at once) over HTTP from a
    ModelServer in front of ``engine``. Every launch count is set to 0 just
    before and read just after. Each reply must be 200 and each stream
    well-formed SSE; each request must finish with tokens in the
    vocabulary. With ``watch_pages``, ``/metrics`` is polled meanwhile for
    the most KV pages it showed resident."""
    from kubeflow_tpu_torch.serve.server import ModelServer
    from kubeflow_tpu_torch.serve.tokenizer import ByteTokenizer

    submitted = []
    submit = engine.submit

    def recording_submit(*a, **kw):
        req = submit(*a, **kw)
        submitted.append(req)
        return req

    engine.submit = recording_submit
    server = ModelServer("llama3-8b", engine)
    results: dict[str, tuple] = {}
    resident = [0.0]
    done = threading.Event()

    def run(name, path, body):
        try:
            results[name] = _post(server.url + path, body)
        except Exception as exc:          # reported and failed below
            results[name] = (None, repr(exc).encode())

    def watch():
        while not done.is_set():
            try:
                resident[0] = max(resident[0], _resident_pages(server.url))
            except OSError:
                pass                      # the maximum is checked by the caller
            done.wait(0.05)

    for wrapper in wrappers.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    server.start()
    try:
        threads = [threading.Thread(target=run, args=c) for c in calls]
        if watch_pages:
            threads.append(threading.Thread(target=watch))
        for th in threads:
            th.start()
        for th in threads[:len(calls)]:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        snap = engine.metrics.snapshot()
    finally:
        done.set()
        for th in threads[len(calls):]:
            th.join(timeout=60)
        server.stop()
        engine.submit = submit
    for name, path, body in calls:
        status, payload = results.get(name, (None, b"no response"))
        if status != 200:
            fail(f"{label} {name}: HTTP {status}: {payload[:300]!r}")
        if body.get("stream"):
            chunks = [ln for ln in payload.decode().split("\n")
                      if ln.startswith("data: ")]
            if not chunks or chunks[-1] != "data: [DONE]":
                fail(f"{label} {name}: malformed SSE stream")
    by_prompt = {tuple(r.prompt_tokens[:len(r.prompt_tokens)
                                       - r.resumed_from]): r
                 for r in submitted}
    reqs, total = {}, 0
    for name, path, body in calls:
        prompt = body.get("prompt") or body["instances"][0]
        req = by_prompt.get(tuple(ByteTokenizer().encode(prompt)))
        if req is None or not req.done.is_set():
            fail(f"{label} {name}: no finished engine request")
        reqs[name] = req
        n = len(req.output_tokens)
        total += n
        print(f"{label} request {name}: status 200, prompt "
              f"{len(req.prompt_tokens) - req.resumed_from} tokens, {n} "
              f"tokens returned ({req.finish_reason}), ttft "
              f"{req.ttft * 1e3:.1f} ms", flush=True)
        if n == 0 or not all(0 <= t < engine.cfg.vocab_size
                             for t in req.output_tokens):
            fail(f"{label} {name}: bad output tokens {req.output_tokens}")
    print(f"{label}: {len(calls)} requests, {total} tokens in {wall:.2f} s "
          f"({total / wall:.1f} tok/s end to end), engine ttft p50 "
          f"{snap.get('ttft_p50_ms', 0):.1f} ms, tpot p50 "
          f"{snap.get('tpot_p50_ms', 0):.2f} ms, preemptions "
          f"{snap.get('preemptions', 0)}", flush=True)
    print(f"{label} kernels " + json.dumps(launches), flush=True)
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} never launched during {label}")
    return {"reqs": reqs, "results": results, "launches": launches,
            "resident": resident[0]}


def phase_serve(rows: list[dict]):
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import decoder_forward
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    wrappers = {"rmsnorm_fwd": fused_norm.rmsnorm_fused,
                "add_rmsnorm_fwd": fused_norm.add_rmsnorm_fused,
                "swiglu_fwd": fused_norm.swiglu_fused,
                "flash_fwd": flash_attention}
    cfg = preset("llama3-8b")
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, BatchingSpec(
        max_batch_size=8, max_seq_len=2048, prefill_attn_impl="pallas",
        chunked_prefill_tokens=1024, weights_dtype="bfloat16"),
        seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: llama3-8b {cfg.n_layers} layers hidden {cfg.hidden} "
          f"params {cfg.num_params() / 1e9:.2f} B bf16, engine ready in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    calls = [
        ("greedy_100", "/v1/completions",
         {"prompt": text(100, 1), "max_tokens": 16}),
        ("greedy_400", "/v1/completions",
         {"prompt": text(400, 2), "max_tokens": 16}),
        ("greedy_800", "/v1/completions",
         {"prompt": text(800, 3), "max_tokens": 16}),
        ("chunked_1500", "/v1/completions",
         {"prompt": text(1500, 4), "max_tokens": 16}),
        ("stream_300", "/v1/completions",
         {"prompt": text(300, 5), "max_tokens": 16, "stream": True}),
        ("predict_200", "/v1/models/llama3-8b:predict",
         {"instances": [text(200, 6)], "max_tokens": 16}),
        ("sampled_150", "/v1/completions",
         {"prompt": text(150, 7), "max_tokens": 16, "temperature": 0.8,
          "top_k": 50, "top_p": 0.9}),
    ]

    launches = serve_http(engine, calls, wrappers, "serve")["launches"]
    for r in rows:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]

    # Bucketed prefill through the kernels vs the plain ops, same weights.
    gen = torch.Generator().manual_seed(SEED + 1)
    toks = torch.randint(3, 259, (1, 512), generator=gen).to("cuda")
    import dataclasses
    plain_cfg = dataclasses.replace(cfg, fused_kernels="off")
    with torch.no_grad():
        outs = []
        for c, impl in ((cfg, "pallas"), (plain_cfg, "xla")):
            shape = (c.n_layers, 1, 512, c.n_kv_heads, c.head_dim)
            scratch = {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                        device="cuda"),
                       "v": torch.zeros(shape, dtype=torch.bfloat16,
                                        device="cuda"),
                       "len": 0, "prefill": True}
            logits, _ = decoder_forward(engine.params, toks, c,
                                        kv_caches=scratch, attn_impl=impl)
            outs.append(logits[0, -1].float())
    rel = float((outs[0] - outs[1]).norm() / outs[1].norm())
    same = int(outs[0].argmax()) == int(outs[1].argmax())
    print(f"prefill check: last-token logits kernel path vs plain path, "
          f"rel L2 {rel:.3e} (tolerance {PREFILL_REL_L2:g}), max abs "
          f"{float((outs[0] - outs[1]).abs().max()):.3e}, argmax "
          f"{'agrees' if same else 'differs'}", flush=True)
    if not rel <= PREFILL_REL_L2:
        fail("prefill through the kernels disagrees with the plain path")
    return engine


#: The page pool every paged engine here runs (and the worker of phase (c)):
#: 8 slots of up to 2048 tokens over 64 pages of 128, chunks of 512, the
#: paged-decode kernel, the radix prefix index.
PAGED_SPEC = dict(paged=True, page_size=128, max_pages=64, max_batch_size=8,
                  max_seq_len=2048, chunked_prefill_tokens=512,
                  paged_attn_impl="pallas", weights_dtype="bfloat16")


def paged_engine(engine, params=None, draft_params=None, **overrides):
    """A paged LLMEngine (``PAGED_SPEC``) over the contiguous engine's
    weights (shared, not copied), or over ``params``; ``draft_params`` goes
    to a ``draft_model`` spec engine."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    spec = dict(PAGED_SPEC)
    spec.update(overrides)
    return LLMEngine(engine.cfg, BatchingSpec(**spec),
                     params=engine.params if params is None else params,
                     seed=SEED, device="cuda", draft_params=draft_params)


def phase_paged_serve(engine, rows: list[dict]) -> None:
    """The paged path over HTTP: Llama-3-8B on the page pool (bf16 pages,
    then int8 pages). Concurrent requests, three of them sharing a 600-token
    prefix; then a second turn of one conversation (it must match pages)
    and a prompt that leaves a registered one inside a page (copy-on-write
    of the shared tail). Every kernel of the path must launch, the prefix
    index must hit, ``/metrics`` must show resident pages, and no page may
    stay referenced at the end."""
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention

    wrappers = {"rmsnorm_fwd": fused_norm.rmsnorm_fused,
                "add_rmsnorm_fwd": fused_norm.add_rmsnorm_fused,
                "swiglu_fwd": fused_norm.swiglu_fused,
                "paged_decode": paged_decode_attention}
    prefix = text(601, 11)                   # 600 tokens with the BOS
    calls = [
        ("shared_a", "/v1/completions",
         {"prompt": prefix + text(101, 21), "max_tokens": 16}),
        ("shared_b", "/v1/completions",
         {"prompt": prefix + text(101, 22), "max_tokens": 16}),
        ("shared_c", "/v1/completions",
         {"prompt": prefix + text(101, 23), "max_tokens": 16}),
        ("chunked_1500", "/v1/completions",
         {"prompt": text(1500, 4), "max_tokens": 16}),
        ("stream_300", "/v1/completions",
         {"prompt": text(300, 5), "max_tokens": 16, "stream": True}),
        ("predict_200", "/v1/models/llama3-8b:predict",
         {"instances": [text(200, 6)], "max_tokens": 16}),
        ("sampled_150", "/v1/completions",
         {"prompt": text(150, 7), "max_tokens": 16, "temperature": 0.8,
          "top_k": 50, "top_p": 0.9}),
    ]
    t0 = time.perf_counter()
    peng = paged_engine(engine)
    torch.cuda.synchronize()
    dens = peng.kv_pool_density()
    print(f"paged serve: pool of {peng._num_pages} pages of "
          f"{peng.page_size} tokens + the sink, {dens['pool_bytes'] / 1e9:.2f}"
          f" GB, engine ready in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    run = serve_http(peng, calls, wrappers, "paged serve", watch_pages=True)
    launches = run["launches"]
    # One after the other: a second turn of conversation a, then a prompt
    # that leaves conversation b's registered prompt 60 tokens into its
    # sixth page.
    turn1 = calls[0][2]["prompt"]
    said = json.loads(run["results"]["shared_a"][1])["choices"][0]["text"]
    follow = [
        ("turn2_a", {"prompt": turn1 + said + text(51, 31),
                     "max_tokens": 16}),
        ("diverge_b", {"prompt": calls[1][2]["prompt"][:659] + text(101, 41),
                       "max_tokens": 16}),
    ]
    seen = {}
    for name, body in follow:
        before = peng.kv_tier_stats()
        r = serve_http(peng, [(name, "/v1/completions", body)], wrappers,
                       "paged serve")
        for k, v in r["launches"].items():
            launches[k] += v
        after = peng.kv_tier_stats()
        seen[name] = {k: after[k] - before[k]
                      for k in ("tokens_matched", "tokens_cow", "cow_copies")}
        print(f"paged serve {name}: {seen[name]}", flush=True)
    stats = peng.kv_tier_stats()
    snap = peng.metrics.snapshot()
    leaks = peng._allocator.leak_report()
    print(f"paged serve: prefix hits {stats['prefix_hits']} of "
          f"{stats['prefix_queries']} queries, {stats['tokens_matched']} "
          f"tokens matched, {stats['tokens_cow']} COW tokens in "
          f"{stats['cow_copies']} copies, preemptions "
          f"{snap.get('preemptions', 0)}, most pages resident on /metrics "
          f"{run['resident']:.0f}, leak report {leaks}", flush=True)
    print("paged serve kernels " + json.dumps(launches), flush=True)
    if stats["prefix_hits"] <= 0:
        fail("paged serve: the prefix index never hit")
    if seen["turn2_a"]["tokens_matched"] <= 0:
        fail("paged serve: the second turn matched no pages")
    if seen["diverge_b"]["tokens_cow"] <= 0:
        fail("paged serve: the diverging prompt took no copy-on-write tail")
    if run["resident"] <= 0:
        fail("paged serve: /metrics never showed a resident KV page")
    if leaks:
        fail(f"paged serve: pages still referenced at the end: {leaks}")
    del peng
    torch.cuda.empty_cache()

    # int8 pages: four of the requests on a second paged engine.
    qeng = paged_engine(engine, kv_cache_dtype="int8")
    qrun = serve_http(qeng, calls[:3] + calls[4:5], wrappers,
                      "paged int8 serve", watch_pages=True)
    qleaks = qeng._allocator.leak_report()
    print(f"paged int8 serve: {qeng.kv_pool_density()}, prefix hits "
          f"{qeng.kv_tier_stats()['prefix_hits']}, leak report {qleaks}",
          flush=True)
    if qleaks:
        fail(f"paged int8 serve: pages still referenced: {qleaks}")
    del qeng
    torch.cuda.empty_cache()
    for r in rows:
        if r["name"] == "paged_decode":
            r["launches"] = launches["paged_decode"]
        elif r["name"] == "paged_decode_int8":
            r["launches"] = qrun["launches"]["paged_decode"]
    tickets_zero("paged serve")


def phase_paged_check(engine) -> None:
    """One 1000-token prompt prefilled into pages (``paged_chunk_prefill``),
    then one decode step through the kernel and one through the gather
    path on the same pool, 32 layers: last-token logits within rel L2
    5e-2 with the same argmax. bf16 pages, then int8 pages (the gather path
    dequantizing)."""
    from kubeflow_tpu_torch.serve.paged import (
        _paged_decode_step, context_bucket, paged_chunk_prefill,
    )

    cfg, pg, mpp, chunk, n = engine.cfg, 128, 16, 512, 1000
    gen = torch.Generator().manual_seed(SEED + 5)
    prompt = torch.randint(3, 259, (n,), generator=gen).to("cuda")
    pages = -(-(n + 1) // pg)
    for quant in (False, True):
        shape = (cfg.n_layers, pages + 1, pg, cfg.n_kv_heads, cfg.head_dim)
        dt = torch.int8 if quant else torch.bfloat16
        cache = {"k": torch.zeros(shape, dtype=dt, device="cuda"),
                 "v": torch.zeros(shape, dtype=dt, device="cuda")}
        if quant:
            cache["ks"] = torch.zeros(shape[:-1], device="cuda")
            cache["vs"] = torch.zeros(shape[:-1], device="cuda")
        table = torch.full((1, mpp), -1, dtype=torch.int32, device="cuda")
        table[0, :pages] = torch.arange(pages, dtype=torch.int32)
        with torch.no_grad():
            for start in range(0, n, chunk):
                real = min(chunk, n - start)
                toks = torch.zeros((1, chunk), dtype=torch.int64,
                                   device="cuda")
                toks[0, :real] = prompt[start:start + real]
                logits = paged_chunk_prefill(
                    engine.params, cache, toks, table[0], start, real, cfg,
                    context_pages=context_bucket(start, chunk, pg, mpp))
            nxt = logits[real - 1].argmax().reshape(1)
            outs = {}
            for impl in ("pallas", "gather"):
                outs[impl] = _paged_decode_step(
                    engine.params, {**cache, "table": table}, nxt,
                    torch.tensor([n], device="cuda"),
                    torch.tensor([True], device="cuda"), cfg,
                    attn_impl=impl)[0].float()
        a, b = outs["pallas"], outs["gather"]
        rel = float((a - b).norm() / b.norm())
        same = int(a.argmax()) == int(b.argmax())
        kind = "int8" if quant else "bf16"
        print(f"paged decode check ({kind} pages, {n}-token prompt, "
              f"{cfg.n_layers} layers): last-token logits kernel vs gather, "
              f"rel L2 {rel:.3e} (tolerance {PREFILL_REL_L2:g}), argmax "
              f"{'agrees' if same else 'differs'}", flush=True)
        if not (rel <= PREFILL_REL_L2 and same):
            fail(f"paged decode through the kernel disagrees with the "
                 f"gather path ({kind} pages)")


def _kernel_times(prof) -> tuple[float, list[tuple[str, float, int]]]:
    """(total device ms, [(kernel, device ms, launches)] by time) of the
    CUDA kernels a profile recorded."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    return total, [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in kernels]


def kernel_parts(fn, calls: int = 20) -> list[tuple[str, float, float]]:
    """(kernel, device ms per call, launches per call) of every CUDA kernel
    that ``calls`` eager calls of ``fn`` run, from ``torch.profiler``
    (each kernel's own execution time, whatever the host's launch gaps)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, kernels = _kernel_times(prof)
    return [(key[:60], ms / calls, count / calls)
            for key, ms, count in kernels]


def phase_profile(engine) -> None:
    """Where the serve path's time goes: one 8-step decode dispatch at 8
    live slots (cache position 1024) on the contiguous cache, the same on
    the page pool through the paged-decode kernel, and one 2048-token
    bucketed prefill, each timed on the host (enqueue, and wall to a
    synchronize) and under torch.profiler (device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serve import engine as E
    from kubeflow_tpu_torch.serve.paged import paged_decode_multi

    cfg, dev, b = engine.cfg, engine.device, engine.num_slots
    steps = 8
    st = {"tokens": torch.full((b,), 5, device=dev),
          "lengths": torch.full((b,), 1024, device=dev),
          "live": torch.ones((b,), dtype=torch.bool, device=dev),
          "temps": torch.zeros((b,), device=dev),
          "top_k": torch.zeros((b,), dtype=torch.long, device=dev),
          "top_p": torch.ones((b,), device=dev),
          "stops": torch.full((b,), -1, device=dev),
          "budgets": torch.full((b,), 1 << 20, device=dev)}
    names = ("tokens", "lengths", "live", "temps", "top_k", "top_p",
             "stops", "budgets")

    def decode():
        E._decode_multi(engine.params, engine.cache,
                        *(st[n] for n in names), engine._gen, cfg, steps,
                        sample_mode="greedy")

    # The page pool of the paged dispatch: 9 pages of 128 per slot cover
    # positions 0..1031, plus the sink page.
    pg, mpp, per_slot = 128, 16, 9
    shape = (cfg.n_layers, b * per_slot + 1, pg, cfg.n_kv_heads, cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "table": torch.full((b, mpp), -1, dtype=torch.int32, device=dev)}
    pool["table"][:, :per_slot] = torch.arange(
        b * per_slot, dtype=torch.int32, device=dev).reshape(b, per_slot)

    def paged_decode():
        paged_decode_multi(engine.params, pool, *(st[n] for n in names),
                           engine._gen, cfg, steps, sample_mode="greedy",
                           attn_impl="pallas")

    toks = torch.randint(3, 259, (1, 2048), device=dev)
    slots = torch.zeros((1,), dtype=torch.long, device=dev)
    plens = torch.full((1,), 2048, device=dev)

    def prefill():
        E._prefill_step(engine.params, engine.cache, toks, slots, plens, cfg,
                        "pallas")

    for name, fn, per in (("decode", decode, steps),
                          ("paged decode", paged_decode, steps),
                          ("prefill", prefill, 1)):
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t_enq = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        total, kernels = _kernel_times(prof)
        unit = "per step" if per > 1 else "per call"
        dev_ms = f"{total / per:.2f}" if total else "not measured"
        print(f"profile {name} ({unit}): host enqueue {t_enq * 1e3 / per:.2f} "
              f"ms, wall {t_wall * 1e3 / per:.2f} ms, device {dev_ms} ms",
              flush=True)
        for key, ms, count in kernels[:6]:
            print(f"  {ms / per:8.3f} ms  {count // per:4d}x  {key[:90]}",
                  flush=True)


# -- the predictor replica: explain, loadgen, the worker, file:// ------------

# grad_x_input's per-token scores, kernel path vs plain path over 32 bf16
# layers: relative L2, the prefill's band.
EXPLAIN_REL_L2 = PREFILL_REL_L2
#: The offered traffic of every loadgen phase (``standard_matrix``): 16
#: requests of up to 32 new tokens a mix keep the whole script well inside
#: its time limit.
LOADGEN = dict(num_requests=16, rate_rps=4.0, prompt_len=512, max_new=32,
               seed=SEED)
#: The worker's greedy prompts: a 128-bucket prompt, a 512-bucket one and a
#: chunked one.
WORKER_PROMPTS = ((60, 51), (300, 52), (700, 53))


class TokenIdText:
    """The byte tokenizer's encoding, with every token id decoded as decimal
    text ("17 4093 "): a served random-weight model's greedy ids come back
    over HTTP exactly, where the byte tokenizer drops every id past 258.
    The worker of phase (c) loads it as ``chip_smoke:TokenIdText``."""

    PAD, BOS, EOS, OFFSET = 0, 1, 2, 3
    bos_id, eos_id, vocab_size = BOS, EOS, 256 + OFFSET

    def encode(self, text: str) -> list[int]:
        return [self.BOS] + [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        return "".join(f"{i} " for i in ids)


def phase_explain(engine) -> None:
    """(a) The explainer hop on the 32-layer serving engine, in process, on
    a 37-token prompt: ``grad_x_input`` through the kernels (the norm and
    SwiGLU backward on serving weights that need no gradient; each kernel's
    count set to 0 just before and read just after: 2L + 1 RMSNorm backward
    calls — ln1, the residual ln2, the final norm — and L SwiGLU backward
    calls) against the plain path (``fused_kernels="off"``) on the same
    weights: the same target token, scores within ``EXPLAIN_REL_L2``. Then
    ``leave_one_out``: finite scores and the same target."""
    import dataclasses

    from kubeflow_tpu_torch.ops import fused_norm as fn
    from kubeflow_tpu_torch.serve.explain import grad_x_input, leave_one_out

    cfg = engine.cfg
    gen = torch.Generator().manual_seed(SEED + 20)
    prompt = torch.randint(3, 259, (37,), generator=gen).tolist()
    wrappers = {"rmsnorm_fwd": fn.rmsnorm_fused,
                "add_rmsnorm_fwd": fn.add_rmsnorm_fused,
                "swiglu_fwd": fn.swiglu_fused,
                "rmsnorm_bwd": fn.rmsnorm_bwd, "swiglu_bwd": fn.swiglu_bwd}
    grad_x_input(prompt, params=engine.params, cfg=cfg)       # warm
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    kern = grad_x_input(prompt, params=engine.params, cfg=cfg)
    t_kern = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    plain = grad_x_input(prompt, params=engine.params,
                         cfg=dataclasses.replace(cfg, fused_kernels="off"))
    a = torch.tensor(kern["scores"], dtype=torch.float64)
    b = torch.tensor(plain["scores"], dtype=torch.float64)
    rel = float((a - b).norm() / b.norm())
    t0 = time.perf_counter()
    loo = leave_one_out(prompt, params=engine.params, cfg=cfg)
    t_loo = time.perf_counter() - t0
    print(f"explain grad_x_input ({len(prompt)} tokens, {cfg.n_layers} "
          f"layers): {t_kern:.3f} s, target {kern['target_token']} (plain "
          f"path {plain['target_token']}), scores rel L2 {rel:.3e} "
          f"(tolerance {EXPLAIN_REL_L2:g}), kernels " + json.dumps(launches),
          flush=True)
    print(f"explain leave_one_out ([{len(prompt)}, {len(prompt)}] forward): "
          f"{t_loo:.3f} s, target {loo['target_token']}, scores "
          f"[{min(loo['scores']):.4f}, {max(loo['scores']):.4f}]", flush=True)
    if kern["target_token"] != plain["target_token"]:
        fail("explain: the kernel path's target token differs from the "
             "plain path's")
    if not rel <= EXPLAIN_REL_L2:
        fail("explain: grad_x_input through the kernels disagrees with the "
             "plain path")
    want = {"rmsnorm_bwd": 2 * cfg.n_layers + 1, "swiglu_bwd": cfg.n_layers}
    for name, count in launches.items():
        if count != want.get(name, count) or count <= 0:
            fail(f"explain: {name} launched {count} times, expected "
                 f"{want.get(name, '> 0')}")
    if len(loo["scores"]) != len(prompt) or not all(
            math.isfinite(v) for v in loo["scores"] + kern["scores"]):
        fail("explain: non-finite or missing scores")
    if loo["target_token"] != kern["target_token"]:
        fail("explain: leave_one_out's target differs from grad_x_input's")


def report_line(label: str, rep: dict, card: str) -> None:
    """Print one loadgen report's client-side numbers on a line, with the
    card."""
    ttft, tpot, lag = rep["ttft_ms"], rep["tpot_ms"], rep["schedule_lag_ms"]
    line = (f"loadgen {label}: {rep['requests']} requests "
            f"{json.dumps(rep['by_status'])}, TTFT p50 {ttft.get('p50')} p95 "
            f"{ttft.get('p95')} ms, TPOT p50 {tpot.get('p50')} p95 "
            f"{tpot.get('p95')} ms, {rep['req_s']} req/s, "
            f"{rep['tokens_per_sec']} tokens/s, generator lag p50 "
            f"{lag.get('p50')} p95 {lag.get('p95')} ms; {card}")
    print(line, flush=True)


def check_statuses(label: str, rep: dict) -> None:
    bad = {k: v for k, v in rep["by_status"].items() if k not in ("ok", "shed")}
    if bad or not rep["by_status"].get("ok"):
        fail(f"loadgen {label}: statuses {rep['by_status']}")


def phase_loadgen_engine(engine, card: str) -> None:
    """(b) The open-loop load generator in process (``EngineTarget``) on the
    contiguous serving engine: ``bursty_qos`` of ``standard_matrix``
    (``LOADGEN``). Every request ok or shed; the report's TTFT, TPOT,
    req/s, tokens/s and the generator's own lag."""
    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.serve.server import serving_metrics_registry

    sc = next(x for x in loadgen.standard_matrix(**LOADGEN)
              if x.name == "bursty_qos")
    engine.start()
    try:
        run = loadgen.run_scenario(
            loadgen.EngineTarget(engine), sc, vocab_size=engine.cfg.vocab_size,
            max_prompt_len=engine.max_len - sc.output_len.value - 1)
        text = serving_metrics_registry([("llama3-8b", engine)]).render()
    finally:
        engine.stop()
    rep = loadgen.build_report(run, metrics_text=text)
    report_line("bursty_qos (EngineTarget, contiguous cache)", rep, card)
    print(f"loadgen bursty_qos phases {json.dumps(rep['phases'])}, per class "
          f"{json.dumps(rep.get('qos', {}))}", flush=True)
    check_statuses("bursty_qos", rep)


def worker_reference(engine) -> list[list[int]]:
    """The greedy tokens phase (c)'s worker must give its three prompts: a
    paged engine of the worker's spec (``PAGED_SPEC``) over the serving
    weights, which ``random://`` with the same seed reproduces in the
    worker; each prompt alone, as the worker gets them."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams

    tok = TokenIdText()
    peng = paged_engine(engine)
    out = []
    for n, salt in WORKER_PROMPTS:
        got = peng.generate(tok.encode(text(n, salt)), SamplingParams(
            max_new_tokens=16, temperature=0.0, stop_token=tok.eos_id))
        out.append([t for t in got if t != tok.eos_id])
    del peng
    torch.cuda.empty_cache()
    return out


def _get(url: str, timeout: float = 30.0) -> tuple[int, str]:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


#: The workers' model and platform: Llama-3-8B in bf16 on the card.
WORKER_MODEL = {"preset": "llama3-8b", "overrides": {"param_dtype": "bfloat16"}}
WORKER_PLATFORM = "gpu"


def spawn_worker(batching: dict, label: str, model: dict = WORKER_MODEL,
                 service: str = "llama", storage_uri: str = "random://",
                 env_extra: dict | None = None):
    """Start ``python -m kubeflow_tpu_torch.runtime.worker_main`` serving
    ``model`` (default Llama-3-8B) from ``storage_uri`` (default
    ``random://``: bf16, the serving seed) with ``batching``, the ``strip``
    transformer, the
    ``grad_x_input`` explainer and the ``chip_smoke:TokenIdText``
    tokenizer, on a free port of this host (``env_extra`` added to its
    environment). Returns (process, url, log file)."""
    import tempfile

    from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv, free_port

    repo = Path(__file__).resolve().parent
    port = free_port()
    conf = {"model": model,
            "storage_uri": storage_uri,
            "batching": batching, "port": port, "service": service,
            "explainer": {"handler": "grad_x_input"},
            "transformer": {"handler": "strip"},
            "tokenizer": "chip_smoke:TokenIdText"}
    wenv = WorkerEnv(coordinator_address="127.0.0.1:0", num_processes=1,
                     process_id=0, job=f"default/llama-{label}",
                     replica_index=0, entrypoint="model_server", config=conf,
                     parallelism={}, platform=WORKER_PLATFORM)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KFTPU_")}
    env.update(wenv.to_env())
    env.update(env_extra or {})
    env["PYTHONPATH"] = str(repo)
    log = tempfile.NamedTemporaryFile(prefix=f"chip_smoke_{label}_",
                                      suffix=".log", delete=False)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
        cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log


def wait_ready(proc, url: str, label: str, t0: float) -> float:
    """Seconds from ``t0`` until the worker answers its readiness probe."""
    while True:
        if proc.poll() is not None:
            fail(f"{label} exited {proc.returncode} before it was ready")
        try:
            if _get(url + "/v2/health/ready", timeout=2.0)[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > 300:
            fail(f"{label} not ready after 300 s")
        time.sleep(0.5)


def sigterm_worker(proc, url: str, label: str) -> None:
    """SIGTERM must end the worker with 143 within 30 s and close its
    port."""
    import signal

    proc.send_signal(signal.SIGTERM)
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        fail(f"{label}: still alive 30 s after SIGTERM")
    print(f"{label}: SIGTERM -> exit code {rc} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 143:
        fail(f"{label}: SIGTERM gave exit code {rc}, not 143")
    try:
        _get(url + "/v2/health/ready", timeout=2.0)
        fail(f"{label}: its port still answers after SIGTERM")
    except OSError:
        pass


def reap_worker(proc, log, label: str, ok: bool) -> None:
    """Kill a worker still running (a failed phase) and drop its log,
    printing its tail when the phase failed."""
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)
    log.close()
    if not ok:
        print(f"{label} log (tail):\n" + Path(log.name).read_text()[-4000:],
              file=sys.stderr, flush=True)
    os.unlink(log.name)


#: ``mixed_interference``'s offered traffic: LOADGEN with 384-token prompts,
#: so its batch class's 4 x 384 = 1536-token prompts fit ``PAGED_SPEC``'s
#: max_seq_len of 2048 (at 512 they would be 2048 and every one refused).
MIXED = dict(LOADGEN, prompt_len=384)


def run_mixed(target, label: str, card: str, metrics_url: str) -> tuple:
    """``mixed_interference`` through ``target``; prints its report line
    and per-class split. Returns (run, report)."""
    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.obs import stats

    sc = next(x for x in loadgen.standard_matrix(**MIXED)
              if x.name == "mixed_interference")
    run = loadgen.run_scenario(target, sc, vocab_size=128256,
                               max_prompt_len=PAGED_SPEC["max_seq_len"]
                               - sc.output_len.value - 1)
    rep = loadgen.build_report(run, metrics_text=_get(metrics_url
                                                      + "/metrics")[1])
    # The report splits TTFT by class; TPOT per class from the outcomes.
    for cls, entry in rep.get("qos", {}).items():
        entry["tpot_ms"] = stats.quantiles_ms(
            [t for o in run.outcomes if o.ok and o.qos == cls
             for t in [o.tpot_s()] if t is not None], qs=(0.5, 0.95))
    report_line(f"mixed_interference ({label})", rep, card)
    print(f"loadgen mixed_interference ({label}) per class "
          f"{json.dumps(rep.get('qos', {}))}", flush=True)
    return run, rep


def phase_worker(want: list[list[int]], card: str) -> dict:
    """(c) The predictor replica as a process: ``python -m
    kubeflow_tpu_torch.runtime.worker_main`` with ``KFTPU_ENTRYPOINT=
    model_server``, ``KFTPU_PLATFORM=gpu``, Llama-3-8B from ``random://``
    (bf16, the serving seed) on the page pool, the ``strip`` transformer and
    the ``grad_x_input`` explainer. Its kernels must already be built (no
    ``nvcc`` in the worker). Greedy completions must give ``want`` token for
    token; chat (streamed and not) and ``:explain`` must answer; then
    ``uniform`` and ``shared_prefix`` through ``ServerTarget``, with
    ``/metrics`` showing resident pages under load and none after it, and
    prefix hits in ``shared_prefix``. SIGTERM must end it with 143 and
    close its port. Before the SIGTERM, ``mixed_interference`` (``MIXED``)
    runs against it, the unified side of (e)'s comparison. Returns its
    report and ``uniform``'s client TPOT p50 (ms, (h)4's spec-off side)."""
    from kubeflow_tpu_torch import loadgen

    t0 = time.perf_counter()
    proc, url, log = spawn_worker(PAGED_SPEC, "worker")
    ok = False
    try:
        t_ready = wait_ready(proc, url, "worker", t0)
        logged = Path(log.name).read_text()
        m = re.search(r"CUDA kernels ready in ([0-9.]+) s \(compiled here: "
                      r"([^)]*)\)", logged)
        if m is None:
            fail("worker: no kernel build line in its log")
        print(f"worker: ready in {t_ready:.1f} s; kernels ready in "
              f"{m.group(1)} s, compiled in the worker: {m.group(2)}",
              flush=True)
        if m.group(2) != "none":
            fail("worker: ran nvcc for kernels the checkout already built")

        tok = TokenIdText()
        for (n, salt), ref in zip(WORKER_PROMPTS, want):
            status, raw = _post(url + "/v1/completions",
                                {"prompt": text(n, salt), "max_tokens": 16})
            out = json.loads(raw)
            got = [int(t) for t in out["choices"][0]["text"].split()]
            print(f"worker greedy {n} tokens: {got} "
                  f"({'identical to' if got == ref else 'differs from'} the "
                  f"in-process paged engine's)", flush=True)
            if got != ref:
                fail(f"worker: greedy tokens {got} differ from the "
                     f"in-process engine's {ref}")
        msgs = {"messages": [{"role": "user", "content": text(40, 54)}],
                "max_tokens": 8}
        out = json.loads(_post(url + "/v1/chat/completions", msgs)[1])
        if out["object"] != "chat.completion" or not \
                out["choices"][0]["message"]["content"].split():
            fail(f"worker: chat completion {out}")
        raw = _post(url + "/v1/chat/completions",
                    {**msgs, "stream": True})[1].decode()
        chunks = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
        if not chunks or chunks[-1] != "[DONE]" or not all(
                "delta" in json.loads(c)["choices"][0] for c in chunks[:-1]):
            fail("worker: malformed chat stream")
        prompt = text(40, 55)
        (exp,) = json.loads(_post(url + "/v1/models/llama:explain",
                                  {"instances": [prompt]})[1])["explanations"]
        if len(exp["scores"]) != len(tok.encode(prompt)) or not all(
                math.isfinite(v) for v in exp["scores"]):
            fail(f"worker: explain gave {len(exp['scores'])} scores for "
                 f"{len(tok.encode(prompt))} tokens")
        print(f"worker: chat {len(chunks) - 1} streamed chunks; explain "
              f"{exp['method']} {len(exp['scores'])} scores, target "
              f"{exp['target_token']}", flush=True)

        hits = {}
        for name in ("uniform", "shared_prefix"):
            sc = next(x for x in loadgen.standard_matrix(**LOADGEN)
                      if x.name == name)
            resident, done = [0.0], threading.Event()

            def watch():
                while not done.is_set():
                    try:
                        resident[0] = max(resident[0], _resident_pages(url))
                    except OSError:
                        pass
                    done.wait(0.05)

            th = threading.Thread(target=watch)
            th.start()
            try:
                run = loadgen.run_scenario(
                    loadgen.ServerTarget(url, model="llama"), sc,
                    vocab_size=128256, max_prompt_len=1024)
            finally:
                done.set()
                th.join(timeout=60)
            metrics = _get(url + "/metrics")[1]
            rep = loadgen.build_report(run, metrics_text=metrics)
            report_line(f"{name} (ServerTarget, worker, page pool)", rep,
                        card)
            check_statuses(name, rep)
            if name == "uniform":
                uniform_tpot = rep["tpot_ms"].get("p50")
            hits[name] = rep["engine"].get("kv_tier", {}).get(
                "prefix_hits", 0)
            # No leak: once the last stream ended, the scheduler releases
            # its pages within a step or two.
            for _ in range(50):
                after = _resident_pages(url)
                if after == 0:
                    break
                time.sleep(0.1)
            print(f"worker {name}: most pages resident on /metrics "
                  f"{resident[0]:.0f}, after the run {after:.0f}, prefix "
                  f"hits so far {hits[name]}", flush=True)
            if resident[0] <= 0:
                fail(f"worker {name}: /metrics never showed a resident page")
            if after:
                fail(f"worker {name}: pages still resident after the run")
        if hits["shared_prefix"] - hits["uniform"] <= 0:
            fail("worker shared_prefix: the prefix index never hit")
        _, mixed = run_mixed(loadgen.ServerTarget(url, model="llama"),
                             "ServerTarget, unified worker", card, url)
        check_statuses("mixed_interference (unified worker)", mixed)
        sigterm_worker(proc, url, "worker")
        ok = True
    finally:
        reap_worker(proc, log, "worker", ok)
    return mixed, uniform_tpot


# -- (e) disaggregated prefill/decode and the host KV tier -------------------

#: The host tier's engine: PAGED_SPEC with 64 host pages and a short demote
#: time; ``multi_turn`` thinks longer than that between turns.
HOST_TIER = dict(host_kv_pages=64, kv_demote_after_s=0.5)
#: The host tier's conversation: turn 1's prompt, and the new text of turn
#: 2 ((tokens, salt) of ``text``).
HOST_TURNS = ((700, 71), (61, 72))
MULTI_TURN_THINK_S = 4.0
#: ``multi_turn``'s offered requests: two sessions of 3 turns (cut from 16
#: to keep the script inside its time limit).
MULTI_TURN_REQUESTS = 8


def _drive(eng, req, timeout: float = 600.0):
    """Step an engine without its thread until ``req`` finishes."""
    t0 = time.perf_counter()
    while not req.done.is_set():
        eng.step()
        if time.perf_counter() - t0 > timeout:
            fail(f"request {req.id} did not finish in {timeout} s")
    return req


def _settle(eng, label: str) -> None:
    """Step until no page is referenced and no hold or round is left; then
    every page of the pool must be free or cached, with no owner left."""
    t0 = time.perf_counter()
    while eng.kv_pages_in_use() or eng._handoff_holds or eng._rounds:
        eng.step()
        if time.perf_counter() - t0 > 60:
            fail(f"{label}: pages still referenced after 60 s")
    alloc = eng._allocator
    leaks = alloc.leak_report_by_owner()
    if leaks or alloc.available() != alloc.num_pages:
        fail(f"{label}: {alloc.num_pages - alloc.available()} pages neither "
             f"free nor cached, owners {leaks}")


def _timed(obj, name: str, sink: list, when=lambda: True) -> None:
    """Wrap ``obj.name`` to append its synchronized seconds to ``sink``
    (only for calls where ``when()`` holds)."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        if not when():
            return fn(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, run)


def _planes(eng, pages: list[int]) -> dict:
    names = ("k", "v", "ks", "vs") if eng.kv_quant else ("k", "v")
    return {n: eng.cache[n][:, pages].clone() for n in names}


def handoff_in_process(uni) -> int:
    """(e) 1. A prefill-role and a decode-role engine over ``uni``'s weights
    (``PAGED_SPEC``): the worker's three greedy prompts exported, sent
    through ``to_wire`` → ``from_wire`` and adopted must give the unified
    paged engine's tokens exactly, bf16 pages and int8 pages; after the
    acks no page is referenced on either engine. Returns the paged-decode
    launches on adopted pages."""
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
    from kubeflow_tpu_torch.serve.engine import SamplingParams
    from kubeflow_tpu_torch.serve.handoff import HandoffPayload

    tok = TokenIdText()
    params = SamplingParams(max_new_tokens=16, temperature=0.0,
                            stop_token=tok.eos_id)
    total = 0
    for quant in (None, "int8"):
        label = "handoff in process " + ("int8" if quant else "bf16")
        ref = uni if quant is None else paged_engine(uni,
                                                     kv_cache_dtype=quant)
        pre = paged_engine(uni, role="prefill", kv_cache_dtype=quant)
        dec = paged_engine(uni, role="decode", kv_cache_dtype=quant)
        t_export, t_adopt = [], []
        _timed(pre, "_export_handoff", t_export)
        _timed(pre, "_flush_handoffs", t_export,
               when=lambda: bool(pre._pending_exports))
        _timed(dec, "_adopt_handoff", t_adopt)
        launches = 0
        for n, salt in WORKER_PROMPTS:
            prompt = tok.encode(text(n, salt))
            want = ref.generate(prompt, params)
            t_export.clear()
            t_adopt.clear()
            p_req = _drive(pre, pre.submit(prompt, params))
            if p_req.finish_reason != "handoff":
                fail(f"{label}: the prefill engine finished "
                     f"{p_req.finish_reason!r}, not with a handoff")
            wire = p_req.handoff.to_wire()
            payload = HandoffPayload.from_wire(wire)
            paged_decode_attention.launches = 0
            d_req = _drive(dec, dec.submit_handoff(payload))
            launches += paged_decode_attention.launches
            got = [payload.first_token] + d_req.output_tokens
            pre.complete_handoff(p_req.id)
            print(f"{label}: {len(prompt)}-token prompt, wire "
                  f"{len(wire)} bytes ({payload.wire_bytes} of KV), export "
                  f"{sum(t_export) * 1e3:.2f} ms, adopt "
                  f"{sum(t_adopt) * 1e3:.2f} ms, {len(got)} tokens "
                  f"{'identical to' if got == want else 'differ from'} the "
                  f"unified paged engine's", flush=True)
            if got != want:
                fail(f"{label}: tokens {got} differ from {want}")
        _settle(pre, label + " (prefill engine)")
        _settle(dec, label + " (decode engine)")
        print(f"{label}: paged_decode launches on adopted pages {launches}; "
              f"no page referenced on either engine after the acks",
              flush=True)
        if launches <= 0:
            fail(f"{label}: the paged-decode kernel never ran on adopted "
                 "pages")
        total += launches
        del pre, dec, ref
        torch.cuda.empty_cache()
    return total


def host_tier_in_process(uni, card: str) -> int:
    """(e) 2. A paged engine with the host tier (``HOST_TIER``): turn 1,
    an idle gap past the demote time, turn 2. The pages' bytes before
    demotion and after promotion must be equal, bf16 and int8 pools with
    their scales, and turn 2's tokens must equal those of an engine
    without the tier (where the prefix hits on the device). Then
    ``multi_turn`` through ``EngineTarget`` on the bf16 engine, thinking
    ``MULTI_TURN_THINK_S`` between turns: no request errors, pages demote
    and promote, none stays referenced. Returns the paged-decode launches
    on promoted pages."""
    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
    from kubeflow_tpu_torch.serve.engine import SamplingParams
    from kubeflow_tpu_torch.serve.kvtier import TIER_DEVICE
    from kubeflow_tpu_torch.serve.server import serving_metrics_registry

    tok = TokenIdText()
    params = SamplingParams(max_new_tokens=16, temperature=0.0,
                            stop_token=tok.eos_id)
    turn1 = tok.encode(text(*HOST_TURNS[0]))
    total = 0
    for quant in (None, "int8"):
        label = "host tier " + ("int8" if quant else "bf16")
        teng = paged_engine(uni, kv_cache_dtype=quant, **HOST_TIER)
        base = paged_engine(uni, kv_cache_dtype=quant)
        out1 = teng.generate(turn1, params)
        torch.cuda.synchronize()
        nodes = {p: teng._kvtier._by_page[p]
                 for p in teng._allocator.reclaimable_lru()}
        before = _planes(teng, list(nodes))
        # The index holds the engine's closures: time them there.
        fetched = []
        fetch = teng._kvtier._fetch_pages

        def timed_fetch(ids, fetch=fetch, fetched=fetched):
            fetched.append(time.perf_counter())
            return fetch(ids)

        teng._kvtier._fetch_pages = timed_fetch
        t0 = time.perf_counter()
        while teng.kv_pages_host() < len(nodes):
            teng.step()
            teng._kvtier.drain_migrations(60.0)
            if time.perf_counter() - t0 > 60:
                fail(f"{label}: {teng.kv_pages_host()} of {len(nodes)} "
                     "pages demoted after 60 s")
            time.sleep(0.02)
        t_demote = time.perf_counter() - fetched[0]
        turn2 = turn1 + out1 + tok.encode(text(*HOST_TURNS[1]))[1:]
        t_up = []
        _timed(teng._kvtier, "_upload_pages", t_up)
        paged_decode_attention.launches = 0
        out2 = teng.generate(turn2, params)
        launches = paged_decode_attention.launches
        after = {old: n.page for old, n in nodes.items()
                 if n.tier == TIER_DEVICE}
        now = _planes(teng, list(after.values()))
        idx = [list(nodes).index(old) for old in after]
        equal = bool(after) and all(torch.equal(now[n], t[:, idx])
                                    for n, t in before.items())
        base.generate(turn1, params)
        want2 = base.generate(turn2, params)
        stats = teng.kv_tier_stats()
        print(f"{label}: {len(nodes)} pages demoted ({stats['demote_wire_bytes']}"
              f" wire bytes) in {t_demote:.3f} s from the gather to the last "
              f"blob; {len(after)} promoted and {stats['cow_copies']} "
              f"copy-on-write tail from the host ({stats['promote_wire_bytes']}"
              f" wire bytes) in {sum(t_up):.4f} s; page bytes "
              f"{'equal' if equal else 'DIFFER'} after promotion "
              f"({', '.join(before)}); turn 2 tokens "
              f"{'identical to' if out2 == want2 else 'differ from'} the "
              f"engine without the tier; paged_decode launches on promoted "
              f"pages {launches}", flush=True)
        if not equal:
            fail(f"{label}: promoted page bytes differ from the demoted "
                 "ones")
        if out2 != want2:
            fail(f"{label}: turn 2 tokens {out2} differ from {want2}")
        if stats["pages_demoted"] <= 0 or stats["pages_promoted"] <= 0 \
                or launches <= 0:
            fail(f"{label}: demoted {stats['pages_demoted']}, promoted "
                 f"{stats['pages_promoted']}, decode launches {launches}")
        total += launches
        _settle(base, label + " (without the tier)")
        del base
        if quant is None:
            sc = next(x for x in loadgen.standard_matrix(
                **dict(LOADGEN, num_requests=MULTI_TURN_REQUESTS),
                multi_turn_think_s=MULTI_TURN_THINK_S)
                if x.name == "multi_turn")
            before_run = teng.kv_tier_stats()
            teng.start()
            try:
                run = loadgen.run_scenario(
                    loadgen.EngineTarget(teng), sc,
                    vocab_size=teng.cfg.vocab_size,
                    max_prompt_len=teng.max_len - sc.output_len.value - 1)
                metrics = serving_metrics_registry(
                    [("llama3-8b", teng)]).render()
                t0 = time.perf_counter()
                while teng.kv_pages_in_use() and \
                        time.perf_counter() - t0 < 30:
                    time.sleep(0.05)
            finally:
                teng.stop()
            rep = loadgen.build_report(run, metrics_text=metrics)
            report_line("multi_turn (EngineTarget, page pool, host tier)",
                        rep, card)
            st = teng.kv_tier_stats()
            moved = {k: st[k] - before_run[k]
                     for k in ("pages_demoted", "pages_promoted",
                               "demote_wire_bytes", "promote_wire_bytes",
                               "tokens_matched")}
            print(f"multi_turn host tier: {json.dumps(moved)}, pages on the "
                  f"host after the run {teng.kv_pages_host()}, resident "
                  f"{teng.kv_pages_in_use()}, phases "
                  f"{json.dumps(rep['phases'])}", flush=True)
            bad = {k: v for k, v in rep["by_status"].items()
                   if k not in ("ok", "shed")}
            if bad or not rep["by_status"].get("ok"):
                fail(f"multi_turn: statuses {rep['by_status']}")
            if moved["pages_demoted"] <= 0 or moved["pages_promoted"] <= 0:
                fail(f"multi_turn: no demotion or promotion: {moved}")
            if teng.kv_pages_in_use():
                fail("multi_turn: pages still referenced after the run")
        teng.stop()             # ends its migration thread, which holds it
        del teng
        torch.cuda.empty_cache()
    return total


def _decode_backend_target(url: str, decode_url: str):
    """A ``ServerTarget`` that stamps ``X-Kftpu-Decode-Backend`` on its
    requests, as the router would (the loadgen itself stays the JAX
    package's): while its requests are issued, ``http.client``'s connection
    class is a subclass that adds the header for the issuing thread only."""
    import http.client

    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    local = threading.local()
    base = http.client.HTTPConnection

    class Stamped(base):
        def request(self, method, url, body=None, headers=None, **kw):
            extra = getattr(local, "headers", None)
            headers = {**(headers or {}), **(extra or {})}
            return super().request(method, url, body, headers, **kw)

    class Target(loadgen.ServerTarget):
        def issue(self, sr, root, timeout_s, prompt=None):
            local.headers = {DECODE_BACKEND_HEADER: decode_url}
            try:
                return super().issue(sr, root, timeout_s, prompt=prompt)
            finally:
                local.headers = None

    return Target(url, model="llama"), Stamped, base


def phase_worker_pair(want: list[list[int]], unified: dict,
                      card: str) -> None:
    """(e) 3. A prefill-role and a decode-role worker process on the one
    card, each as (c)'s worker with its ``batching.role``: the three
    greedy prompts through the prefill worker (with the decode worker's URL
    in ``X-Kftpu-Decode-Backend``) must give ``want``; ``mixed_interference``
    (``MIXED``) through them must be all ok, with one export per request
    that had tokens to decode, one adoption per export, no failed or
    fallback handoff and no page resident after; its report sits beside
    the unified worker's from (c). Then the fallback: with the decode
    worker gone, a prompt still gives ``want[0]`` and the fallback counter
    reads 1. Both workers end with 143 on SIGTERM."""
    import http.client

    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    t0 = time.perf_counter()
    pre, pre_url, pre_log = spawn_worker(dict(PAGED_SPEC, role="prefill"),
                                         "prefill-worker")
    dec, dec_url, dec_log = spawn_worker(dict(PAGED_SPEC, role="decode"),
                                         "decode-worker")
    ok = False
    try:
        t_pre = wait_ready(pre, pre_url, "prefill worker", t0)
        t_dec = wait_ready(dec, dec_url, "decode worker", t0)
        print(f"worker pair: prefill ready in {t_pre:.1f} s, decode ready in "
              f"{t_dec:.1f} s", flush=True)
        hdr = {DECODE_BACKEND_HEADER: dec_url}
        for (n, salt), ref in zip(WORKER_PROMPTS, want):
            raw = _post(pre_url + "/v1/completions",
                        {"prompt": text(n, salt), "max_tokens": 16},
                        headers=hdr)[1]
            got = [int(t) for t in
                   json.loads(raw)["choices"][0]["text"].split()]
            print(f"worker pair greedy {n} tokens: "
                  f"{'identical to' if got == ref else 'differs from'} the "
                  f"in-process paged engine's", flush=True)
            if got != ref:
                fail(f"worker pair: tokens {got} differ from {ref}")
        names = ("exported", "adopted", "failed", "fallback")

        def counters():
            return {k: _series(pre_url if k != "adopted" else dec_url,
                               f"kftpu_engine_handoffs_{k}_total")
                    for k in names}

        c0 = counters()
        target, stamped, base = _decode_backend_target(pre_url, dec_url)
        http.client.HTTPConnection = stamped
        try:
            run, rep = run_mixed(target, "ServerTarget, prefill + decode "
                                 "workers", card, pre_url)
        finally:
            http.client.HTTPConnection = base
        c1 = counters()
        moved = {k: c1[k] - c0[k] for k in names}
        multi = sum(1 for o in run.outcomes if o.tokens > 1)
        for _ in range(100):
            resident = (_resident_pages(pre_url), _resident_pages(dec_url))
            if resident == (0.0, 0.0):
                break
            time.sleep(0.1)
        print(f"worker pair mixed_interference: handoffs {json.dumps(moved)}"
              f", requests with tokens to decode {multi}, pages resident "
              f"after the run (prefill, decode) {resident}", flush=True)
        if rep["by_status"] != {"ok": rep["requests"]}:
            fail(f"worker pair: statuses {rep['by_status']}")
        if not (moved["exported"] == moved["adopted"] == multi) or \
                moved["failed"] or moved["fallback"]:
            fail(f"worker pair: handoff counters {moved} against {multi} "
                 "requests with tokens to decode")
        if resident != (0.0, 0.0):
            fail(f"worker pair: pages resident after the run {resident}")
        for label, r in (("unified worker", unified),
                         ("prefill + decode workers", rep)):
            cls = {k: {"completed": v["completed"], "ttft_ms": v["ttft_ms"],
                       "tpot_ms": v["tpot_ms"]}
                   for k, v in r.get("qos", {}).items()}
            print(f"mixed_interference side by side, {label}: TTFT p50 "
                  f"{r['ttft_ms'].get('p50')} p95 {r['ttft_ms'].get('p95')} "
                  f"ms, TPOT p50 {r['tpot_ms'].get('p50')} p95 "
                  f"{r['tpot_ms'].get('p95')} ms, {r['tokens_per_sec']} "
                  f"tokens/s, per class {json.dumps(cls)}; {card}",
                  flush=True)

        sigterm_worker(dec, dec_url, "decode worker")
        raw = _post(pre_url + "/v1/completions",
                    {"prompt": text(*WORKER_PROMPTS[0]), "max_tokens": 16},
                    headers=hdr)[1]
        got = [int(t) for t in json.loads(raw)["choices"][0]["text"].split()]
        fb = _series(pre_url, "kftpu_engine_handoffs_fallback_total")
        print(f"worker pair fallback with the decode worker gone: tokens "
              f"{'identical to' if got == want[0] else 'differ from'} "
              f"want[0], fallback counter {fb:.0f}", flush=True)
        if got != want[0] or fb != 1:
            fail(f"worker pair fallback: tokens {got}, counter {fb}")
        sigterm_worker(pre, pre_url, "prefill worker")
        ok = True
    finally:
        reap_worker(dec, dec_log, "decode worker", ok)
        reap_worker(pre, pre_log, "prefill worker", ok)


def phase_disaggregated(want: list[list[int]], unified: dict,
                        card: str) -> None:
    """(e): the handoff and the host tier in process on a fresh 32-layer
    engine (the serving seed, so the same weights as the workers'), then
    the prefill/decode worker pair once those engines are freed."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    uni = LLMEngine(preset("llama3-8b"), BatchingSpec(**PAGED_SPEC),
                    seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"disaggregated: unified paged engine ready in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    adopted = handoff_in_process(uni)
    promoted = host_tier_in_process(uni, card)
    print(f"disaggregated kernels: paged_decode launches on adopted pages "
          f"{adopted}, on promoted pages {promoted}", flush=True)
    del uni
    gc.collect()
    torch.cuda.empty_cache()
    phase_worker_pair(want, unified, card)


# -- (f) the fleet's failure path: the remote KV tier, the router, chaos -----

#: The remote tier's engines: PAGED_SPEC with 16 host pages, 0.5 s to
#: demote and 0.5 s more to spill, and an explicit store deadline. The
#: default deadline (0.5 s, the JAX package's, left as it is) bounds all of
#: one match's probes and reads; one bf16 page blob of Llama-3-8B holds
#: 16,777,216 B of KV, so a 700-token turn reads and hashes ~84 MB inside
#: it. 2 s leaves a loaded host room, so the phase measures the promote
#: instead of cutting it; the printed promote time says whether 0.5 s would
#: have.
FLEET_TIER = dict(host_kv_pages=16, kv_demote_after_s=0.5,
                  kv_remote_after_s=0.5, kv_remote_deadline_s=2.0)
#: (f)1's conversation: turn 1 (700 tokens: five full 128-token pages and a
#: partial one), then turn 1 + its output + 16 new tokens.
FLEET_TURNS = ((700, 81), (17, 82))
#: (f)2's conversation over HTTP: turn 2 is turn 1's text and 16 more
#: characters (``TokenIdText`` encodes bytes, so the random model's output
#: ids cannot ride in a prompt; the five stored pages are the same prefix).
FLEET_HTTP_TURNS = ((700, 91), (17, 92))
#: A wedged store may cost at most the deadline plus a cold prefill, and
#: this much more for the scheduler step around the match.
WEDGE_SLACK_S = 0.5
EXPLICIT_STATUSES = {200, 429, 500, 502, 503, 504}


def _host_timed(obj, name: str, sink: list) -> None:
    """Wrap ``obj.name`` to append its host seconds to ``sink`` (no device
    sync: the store's work is host work, some of it on the migration
    thread)."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            sink.append(time.perf_counter() - t0)

    setattr(obj, name, run)


def _wait_spilled(eng, pages: int, label: str) -> float:
    """Step the idle engine until ``pages`` pages are in the store and no
    spill is in flight; returns the seconds it took."""
    t0 = time.perf_counter()
    while eng.kv_tier_stats()["pages_demoted_remote"] < pages:
        eng.step()
        time.sleep(0.02)
        if time.perf_counter() - t0 > 60:
            fail(f"{label}: not {pages} pages spilled after 60 s: "
                 f"{eng.kv_tier_stats()}")
    eng._kvtier.drain_migrations(60.0)
    return time.perf_counter() - t0


def _first_difference(a: list, b: list) -> str:
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             None if len(a) == len(b) else min(len(a), len(b)))
    return "equal" if i is None else f"first different at token {i}"


def _blobs_equal_planes(nodes: dict, before: dict, store) -> int:
    """Every node of ``nodes`` (old page -> node) that reached the store:
    its blob must decode to the planes read before demotion. Returns how
    many were checked."""
    from kubeflow_tpu_torch.serve.handoff import pages_from_wire, to_torch
    from kubeflow_tpu_torch.serve.kvtier import TIER_REMOTE

    checked = 0
    for j, node in enumerate(nodes.values()):
        if node.tier != TIER_REMOTE:
            continue
        planes = pages_from_wire(store.get_bytes(node.blob))
        for name, arr in zip(("k", "v", "ks", "vs"), planes):
            if name not in before:
                continue
            if arr is None or not torch.equal(to_torch(arr),
                                              before[name][:, j].cpu()):
                fail(f"store blob {node.blob}: plane {name} differs from "
                     "the page read before demotion")
        checked += 1
    return checked


def fleet_in_process(uni, root: str, card: str) -> int:
    """(f)1. Engine A (``FLEET_TIER`` on ``root``) serves a 700-token turn,
    demotes and spills it while idle: five full pages reach the store (the
    partial page stays on the host), each blob decoding to the page's bytes
    read before demotion. A closes; engine B on the same weights and root
    serves turn 2, whose greedy tokens must equal a cold engine's without
    the tier, adopting the prefix from the store (registry hits, remote
    promotions >= 5, a prefix hit) with the paged-decode kernel running on
    the promoted pages. Then a ``ChaosStore`` under a fresh engine: one
    truncated read counts a corrupt blob, a wedged store a promote timeout,
    both with the same tokens, the wedged turn's TTFT within the deadline
    plus a cold prefill. bf16 pages, then int8. Returns the paged-decode
    launches on promoted pages."""
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
    from kubeflow_tpu_torch.pipelines.artifacts import ArtifactStore
    from kubeflow_tpu_torch.serve.engine import SamplingParams
    from kubeflow_tpu_torch.serve.faults import ChaosStore

    tok = TokenIdText()
    params = SamplingParams(max_new_tokens=16, temperature=0.0,
                            stop_token=tok.eos_id)
    turn1 = tok.encode(text(*FLEET_TURNS[0]))
    store = ArtifactStore(root)
    deadline_s = FLEET_TIER["kv_remote_deadline_s"]
    total = 0
    for quant in (None, "int8"):
        label = "fleet " + ("int8" if quant else "bf16")

        def tiered():
            return paged_engine(uni, kv_cache_dtype=quant,
                                remote_kv_root=root, **FLEET_TIER)

        a = tiered()
        spills: list = []
        _host_timed(a._kvtier, "_remote_publish", spills)
        out1 = _drive(a, a.submit(turn1, params)).output_tokens
        torch.cuda.synchronize()
        nodes = {p: a._kvtier._by_page[p]
                 for p in a._allocator.reclaimable_lru()}
        before = _planes(a, list(nodes))
        t_spill = _wait_spilled(a, 5, label)
        st_a = a.kv_tier_stats()
        checked = _blobs_equal_planes(nodes, before, store)
        if checked < 5:
            fail(f"{label}: {checked} of {len(nodes)} pages in the store")
        wire = st_a["remote_demote_bytes"] / st_a["pages_demoted_remote"]
        _settle(a, label + " (engine A)")
        a.stop()
        del a, before
        torch.cuda.empty_cache()

        turn2 = turn1 + out1 + tok.encode(text(*FLEET_TURNS[1]))[1:]
        base = paged_engine(uni, kv_cache_dtype=quant)
        cold = _drive(base, base.submit(turn2, params))
        want = cold.output_tokens
        _settle(base, label + " (without the tier)")
        del base

        b = tiered()
        probe, fetch, upload = [], [], []
        _host_timed(b._kvtier, "_probe_remote_child", probe)
        _host_timed(b._kvtier, "_fetch_remote_blob", fetch)
        _timed(b._kvtier, "_upload_pages", upload)
        paged_decode_attention.launches = 0
        hot = _drive(b, b.submit(turn2, params))
        launches = paged_decode_attention.launches
        st_b = b.kv_tier_stats()
        print(f"{label}: turn 1 {len(turn1)} tokens, {checked} pages spilled "
              f"to the store in {t_spill:.3f} s after the turn (idle timers "
              f"{FLEET_TIER['kv_demote_after_s']} + "
              f"{FLEET_TIER['kv_remote_after_s']} s included), each blob "
              f"equal to its page's bytes; spill {sum(spills) / len(spills):.4f}"
              f" s per page (put + sha256 + register; the migration thread "
              f"is busy {sum(spills):.3f} s, which a demotion batch queued "
              f"behind the spill waits), {wire:.0f} wire bytes per page; "
              f"turn 2 ({len(turn2)} tokens) promoted "
              f"{st_b['pages_promoted_remote']} pages "
              f"({st_b['remote_promote_bytes']} bytes): probe "
              f"{sum(probe):.4f} s, read + sha256 {sum(fetch):.4f} s, upload "
              f"{sum(upload):.4f} s (deadline {deadline_s} s; the 0.5 s "
              f"default {'holds' if sum(probe) + sum(fetch) < 0.5 else 'would cut it'}"
              f"); TTFT {hot.ttft:.4f} s from the store against "
              f"{cold.ttft:.4f} s cold without the tier; tokens "
              f"{'identical to' if hot.output_tokens == want else 'differ from'}"
              f" the cold engine's; registry hits "
              f"{st_b['remote_registry_hits']}, prefix hits "
              f"{st_b['prefix_hits']}; paged_decode launches on promoted "
              f"pages {launches}; {card}", flush=True)
        if hot.output_tokens != want:
            fail(f"{label}: turn 2 tokens {hot.output_tokens} differ from "
                 f"{want}")
        if st_b["remote_registry_hits"] < 5 or \
                st_b["pages_promoted_remote"] < 5 or st_b["prefix_hits"] < 1 \
                or launches <= 0:
            fail(f"{label}: store hit counters {st_b}, decode launches "
                 f"{launches}")
        total += launches
        _settle(b, label + " (engine B)")
        b.stop()
        del b

        for fault, counter in (("truncate", "remote_blobs_corrupt"),
                               ("wedge", "remote_promote_timeouts")):
            c = tiered()
            chaos = ChaosStore(c._kvtier._remote_store)
            c._kvtier._remote_store = chaos
            if fault == "truncate":
                chaos.truncate_next(1)
            else:
                chaos.wedge_promote()
            try:
                r = _drive(c, c.submit(turn2, params))
            finally:
                chaos.unwedge()
                chaos.truncate_next(0)
            st_c = c.kv_tier_stats()
            print(f"{label} chaos {fault}: {counter} {st_c[counter]}, "
                  f"chaos {json.dumps(chaos.stats)}, TTFT {r.ttft:.4f} s, "
                  f"tokens {'identical to' if r.output_tokens == want else 'differ from'}"
                  f" the cold engine's", flush=True)
            if st_c[counter] < 1 or r.output_tokens != want:
                fail(f"{label} chaos {fault}: {counter} {st_c[counter]}, "
                     f"tokens {r.output_tokens} against {want}")
            if fault == "wedge" and \
                    r.ttft > deadline_s + cold.ttft + WEDGE_SLACK_S:
                fail(f"{label}: the wedged turn's TTFT {r.ttft:.3f} s is over "
                     f"the deadline {deadline_s} s + the cold prefill "
                     f"{cold.ttft:.3f} s + {WEDGE_SLACK_S} s")
            _settle(c, f"{label} chaos {fault}")
            c.stop()
            del c
        torch.cuda.empty_cache()
    return total


def _ask(url: str, prompt: str, timeout: float = 600.0):
    """(status, token ids) of one completion; a connection-level failure is
    the explicit 502."""
    try:
        status, raw = _post(url + "/v1/completions",
                            {"prompt": prompt, "max_tokens": 16},
                            timeout=timeout)
    except urllib.error.HTTPError as exc:
        exc.read()
        return exc.code, None
    except OSError:
        return 502, None
    return status, [int(t) for t in
                    json.loads(raw)["choices"][0]["text"].split()]


def fleet_workers(want: list[list[int]], root: str, card: str) -> None:
    """(f)2. Two ``model_server`` workers (unified, page pool,
    ``FLEET_TIER`` on one shared ``root``) behind a port ``Router`` in this
    process. Turn 1 through the router; the home worker (the one whose
    ``kftpu_engine_kv_pages_remote`` reaches 5) is SIGKILLed; turn 2
    through the router must answer 200 with ``want[1]``, served by the
    survivor from the store (promoted bytes > 0, a prefix hit). Then 8
    requests: every status explicit, at least 4 ok, the dead backend
    ejected. SIGTERM ends the survivor with 143."""
    from kubeflow_tpu_torch.serve.router import Router

    batching = dict(PAGED_SPEC, remote_kv_root=root, **FLEET_TIER)
    t0 = time.perf_counter()
    workers = [spawn_worker(batching, f"fleet-worker-{i}") for i in (0, 1)]
    router = Router(queue_timeout=30.0, eject_threshold=2, eject_period=60.0,
                    max_retries=2, upstream_timeout=600.0)
    ok = False
    try:
        for i, (proc, url, _log) in enumerate(workers):
            wait_ready(proc, url, f"fleet worker {i}", t0)
        urls = [url for _, url, _ in workers]
        router.set_backends({"latest": urls})
        router.start()
        print(f"fleet workers ready in {time.perf_counter() - t0:.1f} s "
              f"behind the router at {router.url}", flush=True)
        turn1 = text(*FLEET_HTTP_TURNS[0])
        st, got = _ask(router.url, turn1)
        if st != 200 or got != want[0]:
            fail(f"fleet turn 1: status {st}, tokens {got} against {want[0]}")
        t1 = time.perf_counter()
        while True:
            remote = [_series(u, "kftpu_engine_kv_pages_remote") for u in urls]
            if max(remote) >= 5:
                break
            if time.perf_counter() - t1 > 60:
                fail(f"fleet: no worker spilled five pages in 60 s: {remote}")
            time.sleep(0.2)
        home = remote.index(max(remote))
        hproc, hurl, _ = workers[home]
        surv_url = urls[1 - home]
        t_spill = time.perf_counter() - t1
        hproc.kill()
        rc = hproc.wait(timeout=60)
        print(f"fleet: worker {home} held the conversation ({remote[home]:.0f}"
              f" pages in the store {t_spill:.2f} s after turn 1); SIGKILL ->"
              f" exit code {rc}", flush=True)
        turn2 = turn1 + text(*FLEET_HTTP_TURNS[1])
        t2 = time.perf_counter()
        st, got = _ask(router.url, turn2)
        t_turn2 = time.perf_counter() - t2
        promoted = _series(surv_url, "kftpu_engine_kv_remote_promoted_bytes_total")
        hits = _series(surv_url, "kftpu_engine_kv_prefix_hits_total")
        print(f"fleet turn 2 through the router: status {st}, tokens "
              f"{'identical to' if got == want[1] else 'differ from'} the "
              f"in-process engine's, {t_turn2:.3f} s; the survivor promoted "
              f"{promoted:.0f} bytes from the store, prefix hits {hits:.0f}; "
              f"router {json.dumps(router.snapshot())}; {card}", flush=True)
        if st != 200 or got != want[1]:
            fail(f"fleet turn 2: status {st}, tokens {got} against {want[1]}")
        if promoted <= 0 or hits < 1:
            fail(f"fleet: the survivor did not adopt from the store "
                 f"(promoted bytes {promoted}, prefix hits {hits})")
        statuses = [_ask(router.url, text(60, 100 + i))[0] for i in range(8)]
        snap = router.snapshot()
        print(f"fleet: 8 requests after the kill {statuses}; router "
              f"{json.dumps(snap)}", flush=True)
        if not set(statuses) <= EXPLICIT_STATUSES or \
                statuses.count(200) < 4:
            fail(f"fleet: statuses {statuses}")
        if snap["ejections"] < 1 or snap["ejected"] < 1:
            fail(f"fleet: the dead worker was not ejected: {snap}")
        sproc, _, _ = workers[1 - home]
        sigterm_worker(sproc, surv_url, "fleet survivor")
        ok = True
    finally:
        router.stop()
        for i, (proc, _url, log) in enumerate(workers):
            # The SIGKILLed worker's log is dropped like a clean one's.
            reap_worker(proc, log, f"fleet worker {i}", ok)


def phase_fleet(card: str) -> None:
    """(f): the remote KV tier in process on a fresh 32-layer engine (the
    serving seed), bf16 and int8 pages, then — with that engine freed —
    two worker processes behind the router, one SIGKILLed. The store roots
    are a temporary directory, removed at the end."""
    import tempfile

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_kv_store_")
    try:
        uni = LLMEngine(preset("llama3-8b"), BatchingSpec(**PAGED_SPEC),
                        seed=SEED, device="cuda")
        promoted = fleet_in_process(uni, os.path.join(root, "engines"), card)
        # (f)2's reference: the survivor's path in process on its own
        # store root — one engine serves turn 1 and spills it, a fresh one
        # serves turn 2 from the store (five full pages adopted, the rest
        # prefilled). Greedy bf16 tokens of a random-weight model follow
        # the prefill's chunk boundaries, so a cold engine (chunks from 0)
        # and one that saw turn 1 (a copy-on-write tail) may pick others:
        # both are printed beside it, not held. Tokens equal to this
        # reference show the survivor adopted the stored KV; a recompute
        # would give the cold engine's.
        tok = TokenIdText()
        params = SamplingParams(max_new_tokens=16, temperature=0.0,
                                stop_token=tok.eos_id)
        turns = [text(*FLEET_HTTP_TURNS[0])]
        turns.append(turns[0] + text(*FLEET_HTTP_TURNS[1]))

        def greedy(eng, prompt):
            return [t for t in eng.generate(tok.encode(prompt), params)
                    if t != tok.eos_id]

        ref_root = os.path.join(root, "reference")
        home = paged_engine(uni, remote_kv_root=ref_root, **FLEET_TIER)
        want = [greedy(home, turns[0])]
        _wait_spilled(home, 5, "fleet reference")
        home.stop()
        survivor = paged_engine(uni, remote_kv_root=ref_root, **FLEET_TIER)
        want.append(greedy(survivor, turns[1]))
        if survivor.kv_tier_stats()["pages_promoted_remote"] < 5:
            fail(f"fleet reference: turn 2 missed the store: "
                 f"{survivor.kv_tier_stats()}")
        survivor.stop()
        cold = paged_engine(uni, enable_prefix_caching=False)
        warm = paged_engine(uni)
        cow = [greedy(warm, p) for p in turns][1]
        print(f"fleet reference turn 2 from the store against a cold "
              f"engine: {_first_difference(want[1], greedy(cold, turns[1]))};"
              f" against an engine that saw turn 1 (copy-on-write tail of "
              f"{warm.kv_tier_stats()['tokens_cow']} tokens): "
              f"{_first_difference(want[1], cow)}; {card}", flush=True)
        del home, survivor, cold, warm, uni
        gc.collect()
        torch.cuda.empty_cache()
        print(f"fleet: paged_decode launches on pages promoted from the "
              f"store {promoted}; in-process engines freed, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
        fleet_workers(want, os.path.join(root, "workers"), card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- (g) many models and many adapters on one card: LoRA, repository, gRPC --

#: The adapters of (g)1: 8 registered tenants of rank 16 over all four
#: attention projections, 4 packed slots (so the traffic evicts).
LORA_IDS = tuple(f"tenant-{i}" for i in range(8))
LORA_TARGETS = ("wq", "wk", "wv", "wo")
LORA_SPEC = dict(max_adapters=4, rank=16, alpha=16.0, targets=LORA_TARGETS)
#: Tenants published to the artifact store and pulled at hot-load.
LORA_FROM_STORE = ("tenant-6", "tenant-7")
#: 4 slots x 32 layers x rank 16 x (8192 + 5120 + 5120 + 8192) x 2 B.
LORA_PACKED_BYTES = 109_051_904
#: Last-token prefill logits under an adapter against the merged weights'.
LORA_MERGED_REL_L2 = 5e-2
#: The adapter's move of those logits off the base's, in units of that error.
LORA_MOVE_FACTOR = 5.0


def lora_specs(cfg, store) -> list:
    """The 8 tenants' specs: factors drawn in fp32 on the host from a seeded
    ``torch.Generator`` (as adapters arrive from storage); two of them
    published to ``store`` as the JAX package's npz blob and registered by
    name, so their weights are read only at hot-load."""
    from kubeflow_tpu_torch.serve.lora import (
        AdapterSpec, adapter_spec_from_store, adapter_to_bytes,
        init_adapter_weights,
    )

    rank, alpha = LORA_SPEC["rank"], LORA_SPEC["alpha"]
    specs = []
    for i, name in enumerate(LORA_IDS):
        gen = torch.Generator().manual_seed(SEED + 100 + i)
        w = init_adapter_weights(gen, cfg, rank, LORA_TARGETS)
        if name in LORA_FROM_STORE:
            uri = store.put_bytes(adapter_to_bytes(w, rank=rank, alpha=alpha))
            store.register(name, "1", uri)
            specs.append(adapter_spec_from_store(
                store, name, f"artifact://{name}", rank=rank, alpha=alpha))
        else:
            specs.append(AdapterSpec(name, rank=rank, alpha=alpha, weights=w))
    return specs


def lora_engine(uni, specs, **overrides):
    """A LoRA engine over ``uni``'s weights (``PAGED_SPEC`` unless
    overridden) with every spec registered."""
    from kubeflow_tpu_torch.core.serving import LoRASpec

    eng = paged_engine(uni, lora=LoRASpec(**LORA_SPEC), **overrides)
    for s in specs:
        eng._lora.register(s)
    return eng


def _drive_all(eng, reqs, timeout: float = 600.0) -> list[list[int]]:
    t0 = time.perf_counter()
    while not all(r.done.is_set() for r in reqs):
        eng.step()
        if time.perf_counter() - t0 > timeout:
            fail(f"requests not finished in {timeout} s")
    return [r.output_tokens for r in reqs]


def _lora_wrappers() -> dict:
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention

    return {"rmsnorm_fwd": fused_norm.rmsnorm_fused,
            "add_rmsnorm_fwd": fused_norm.add_rmsnorm_fused,
            "swiglu_fwd": fused_norm.swiglu_fused,
            "flash_fwd": flash_attention,
            "paged_decode": paged_decode_attention}


def lora_base_rows(uni, specs, kv_dtype, card: str) -> None:
    """(g)1, base rows and adapter tokens: four equal-length prompts in four
    slots, two base and two under adapters, against the same four on a
    LoRA-free engine, all base. The base rows' greedy tokens must be
    identical (the delta of an index -1 row is an exact zero; equal lengths
    give equal page tables and split counts). The adapter rows beside a
    merged-weights engine's: the first differing token is printed (bf16
    rounds the factored and the merged product differently)."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams
    from kubeflow_tpu_torch.serve.lora import merged_params

    label = f"lora {kv_dtype or 'bf16'} pages"
    prompts = [[3 + (i * 7 + 13 * k) % 50000 for i in range(300)]
               for k in range(4)]
    adapters = [None, None, LORA_IDS[0], LORA_IDS[1]]
    params = SamplingParams(max_new_tokens=32, temperature=0.0)
    eng = lora_engine(uni, specs, kv_cache_dtype=kv_dtype)
    got = _drive_all(eng, [eng.submit(p, params, adapter=a)
                           for p, a in zip(prompts, adapters)])
    eng._lora.assert_quiescent()
    eng._allocator.assert_quiescent()
    bare = paged_engine(uni, kv_cache_dtype=kv_dtype)
    want = _drive_all(bare, [bare.submit(p, params) for p in prompts])
    for k in (0, 1):
        if got[k] != want[k]:
            fail(f"{label}: base row {k} differs from the LoRA-free engine: "
                 f"{_first_difference(got[k], want[k])}")
    for k in (2, 3):
        if got[k] == want[k]:
            fail(f"{label}: adapter {adapters[k]} left its row unchanged")
    merged = []
    for k in (2, 3):
        spec = next(s for s in specs if s.name == adapters[k])
        meng = paged_engine(uni, kv_cache_dtype=kv_dtype,
                            params=merged_params(uni.params, uni.cfg, spec))
        ref = _drive_all(meng, [meng.submit(prompts[k], params)])[0]
        merged.append(f"{adapters[k]} against its merged weights: "
                      f"{_first_difference(got[k], ref)}")
        del meng
    print(f"{label}: base rows 0 and 1 identical to the LoRA-free engine "
          f"(32 tokens each); {'; '.join(merged)}; {card}", flush=True)
    del eng, bare
    gc.collect()


def lora_merged_logits(ceng, specs, card: str) -> None:
    """(g)1, adapter logits: the last-token logits of a 512-token bucketed
    prefill (the flash kernel, the engine's ``_prefill_step``) under an
    adapter, against the same prefill on its merged weights (merged in
    fp32, cast to bf16) and on the base weights."""
    from kubeflow_tpu_torch.serve import engine as E
    from kubeflow_tpu_torch.serve.lora import merged_params

    cfg, dev = ceng.cfg, ceng.device
    gen = torch.Generator().manual_seed(SEED + 7)
    toks = torch.randint(3, 50000, (1, 512), generator=gen).to(dev)
    slots = torch.zeros((1,), dtype=torch.long, device=dev)
    plens = torch.full((1,), 512, device=dev)
    for name in LORA_IDS[:2]:
        slot, _ = ceng._lora.acquire(name, owner="chip_smoke")
        spec = next(s for s in specs if s.name == name)
        with torch.no_grad():
            lora = E._prefill_step(ceng.params, ceng.cache, toks, slots,
                                   plens, cfg, "pallas",
                                   lora=ceng._lora_rows([slot]))[0].float()
            mp = merged_params(ceng.params, cfg, spec)
            ref = E._prefill_step(mp, ceng.cache, toks, slots, plens, cfg,
                                  "pallas")[0].float()
            base = E._prefill_step(ceng.params, ceng.cache, toks, slots,
                                   plens, cfg, "pallas")[0].float()
        del mp
        ceng._lora.release(name)
        err = float((lora - ref).norm() / ref.norm())
        move = float((lora - base).norm() / base.norm())
        same = int(lora.argmax()) == int(ref.argmax())
        print(f"lora logits {name}: rel L2 against the merged weights "
              f"{err:.3e} (tolerance {LORA_MERGED_REL_L2:g}), against the "
              f"base weights {move:.3e} ({move / max(err, 1e-12):.1f}x the "
              f"merge error), argmax {'agrees' if same else 'differs'} with "
              f"the merged; {card}", flush=True)
        if not err <= LORA_MERGED_REL_L2:
            fail(f"lora logits {name}: off the merged weights' by {err:.3e}")
        if not move >= LORA_MOVE_FACTOR * err:
            fail(f"lora logits {name}: the adapter moved the logits by "
                 f"{move:.3e}, under {LORA_MOVE_FACTOR}x the merge error")
    ceng._lora.assert_quiescent()


def lora_no_shared_kv(eng) -> None:
    """(g)1, KV isolation: one 600-token prompt under tenant 0, then under
    tenant 1 (no prefix hit: another namespace), then tenant 0's second
    turn (it hits its own)."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams

    params = SamplingParams(max_new_tokens=16, temperature=0.0)
    prompt = [3 + (i * 11) % 60000 for i in range(600)]
    a, b = LORA_IDS[0], LORA_IDS[1]

    def matched(tokens, adapter) -> tuple[int, list]:
        before = eng.kv_tier_stats()["tokens_matched"]
        out = _drive_all(eng, [eng.submit(tokens, params, adapter=adapter)])
        return eng.kv_tier_stats()["tokens_matched"] - before, out[0]

    first, out_a = matched(prompt, a)
    other, _ = matched(prompt, b)
    turn2, _ = matched(prompt + out_a + prompt[:50], a)
    print(f"lora KV isolation: {a} first turn matched {first} tokens, {b} on "
          f"the same prompt {other}, {a}'s second turn {turn2}", flush=True)
    if first or other:
        fail(f"lora KV isolation: a prefix crossed adapters ({first}, "
             f"{other} tokens matched)")
    if turn2 < 512:
        fail(f"lora KV isolation: {a}'s second turn matched {turn2} tokens")
    eng._lora.assert_quiescent()
    eng._allocator.assert_quiescent()


def lora_traffic(eng, card: str, label: str, num_requests: int,
                 want_rows: tuple, churn: bool) -> None:
    """(g)1, traffic: ``multi_adapter`` (zipf over the 8 tenants) through
    ``EngineTarget``; every status ok or shed, no leaked page or adapter
    reference, each of ``want_rows``' kernels launched (counts set to 0
    just before), and with ``churn`` at least 5 hot-loads and an
    eviction."""
    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.serve.server import serving_metrics_registry

    sc = next(x for x in loadgen.standard_matrix(
        **dict(LOADGEN, num_requests=num_requests), adapter_ids=LORA_IDS)
        if x.name == "multi_adapter")
    loads: list[float] = []
    _timed(eng._lora, "_load_slot", loads)
    wrappers = _lora_wrappers()
    before = dict(eng.adapter_stats())
    for w in wrappers.values():
        w.launches = 0
    eng.start()
    try:
        run = loadgen.run_scenario(
            loadgen.EngineTarget(eng), sc, vocab_size=eng.cfg.vocab_size,
            max_prompt_len=eng.max_len - sc.output_len.value - 1)
        launches = {n: w.launches for n, w in wrappers.items()}
        metrics = serving_metrics_registry([("llama3-8b", eng)]).render()
    finally:
        eng.stop()
    rep = loadgen.build_report(run, metrics_text=metrics)
    report_line(f"multi_adapter ({label})", rep, card)
    stats = eng.adapter_stats()
    got = {k: stats[k] - before.get(k, 0) for k in ("loads", "evictions",
                                                     "hits", "acquires")}
    print(f"lora traffic {label}: per adapter "
          f"{json.dumps(rep.get('adapters', {}))}; phases "
          f"{json.dumps(rep['phases'])}; registry {json.dumps(got)}; "
          f"hot-loads {len(loads)}: "
          f"{', '.join(f'{x * 1e3:.2f}' for x in loads)} ms", flush=True)
    print(f"lora traffic {label} kernels {json.dumps(launches)}", flush=True)
    check_statuses(f"multi_adapter ({label})", rep)
    if churn and (got["loads"] < 5 or got["evictions"] < 1):
        fail(f"lora traffic {label}: {got['loads']} loads, "
             f"{got['evictions']} evictions")
    for name in want_rows:
        if launches[name] <= 0:
            fail(f"lora traffic {label}: kernel {name} never launched")
    eng._lora.assert_quiescent()
    if eng.paged:
        _settle(eng, f"lora traffic {label}")


def lora_step_cost(eng, card: str) -> None:
    """(g)1, the decode step's cost: one 8-step paged decode dispatch at 8
    live slots (position 1024) with and without the adapters (rows on the
    4 packed slots), host enqueue and device time (profiler) per step."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serve.paged import paged_decode_multi

    cfg, dev, b, steps = eng.cfg, eng.device, 8, 8
    st = {"tokens": torch.full((b,), 5, device=dev),
          "lengths": torch.full((b,), 1024, device=dev),
          "live": torch.ones((b,), dtype=torch.bool, device=dev),
          "temps": torch.zeros((b,), device=dev),
          "top_k": torch.zeros((b,), dtype=torch.long, device=dev),
          "top_p": torch.ones((b,), device=dev),
          "stops": torch.full((b,), -1, device=dev),
          "budgets": torch.full((b,), 1 << 20, device=dev)}
    # 9 pages of 128 per slot cover positions 0..1031; then the sink page.
    pg, mpp, per_slot = 128, 16, 9
    shape = (cfg.n_layers, b * per_slot + 1, pg, cfg.n_kv_heads, cfg.head_dim)
    table = torch.full((b, mpp), -1, dtype=torch.int32, device=dev)
    table[:, :per_slot] = torch.arange(
        b * per_slot, dtype=torch.int32, device=dev).reshape(b, per_slot)
    pool = {"k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
            "table": table}
    aidx = torch.arange(b, device=dev) % eng._lora.max_adapters
    out = {}
    for label, lora in (("without adapters", None),
                        ("with adapters", {**eng._lora.buffers,
                                           "aidx": aidx})):
        def fn():
            paged_decode_multi(eng.params, pool, *st.values(), eng._gen, cfg,
                               steps, sample_mode="greedy",
                               attn_impl="pallas", lora=lora)
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enq = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        total, kernels = _kernel_times(prof)
        launches = sum(c for _, _, c in kernels) // steps
        out[label] = total / steps
        print(f"lora decode step {label} (8 slots, position 1024): host "
              f"enqueue {enq * 1e3 / steps:.2f} ms, wall "
              f"{wall * 1e3 / steps:.2f} ms, device "
              f"{total / steps:.2f} ms, {launches} kernel launches per step; "
              f"{card}", flush=True)
    print(f"lora decode step: adapters add "
          f"{out['with adapters'] - out['without adapters']:.2f} ms of device "
          f"time per step", flush=True)


def phase_adapters(card: str) -> None:
    """(g)1: multi-tenant LoRA in process over one 32-layer paged engine's
    weights (the serving seed): base rows exact and adapter tokens beside
    the merged weights' (bf16 pages, then int8), adapter logits against
    the merged weights', KV isolation, the packed bytes, ``multi_adapter``
    traffic on the page pool and through the bucketed prefill, and the
    decode step's cost with and without adapters."""
    import tempfile

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.pipelines.artifacts import ArtifactStore
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_adapters_")
    try:
        t0 = time.perf_counter()
        uni = LLMEngine(preset("llama3-8b"), BatchingSpec(**PAGED_SPEC),
                        seed=SEED, device="cuda")
        specs = lora_specs(uni.cfg, ArtifactStore(root))
        torch.cuda.synchronize()
        print(f"adapters: base engine and {len(specs)} adapters ready in "
              f"{time.perf_counter() - t0:.1f} s "
              f"({len(LORA_FROM_STORE)} in the artifact store), "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
              flush=True)
        for kv_dtype in (None, "int8"):
            lora_base_rows(uni, specs, kv_dtype, card)
        eng = lora_engine(uni, specs)
        packed = eng._lora.packed_bytes()
        print(f"lora packed buffers: {packed} B (want {LORA_PACKED_BYTES}), "
              f"one slot {packed // LORA_SPEC['max_adapters']} B", flush=True)
        if packed != LORA_PACKED_BYTES:
            fail(f"lora packed buffers hold {packed} B")
        lora_no_shared_kv(eng)
        del eng
        paged = lora_engine(uni, specs)
        lora_traffic(paged, card, "page pool", LOADGEN["num_requests"],
                     ("rmsnorm_fwd", "add_rmsnorm_fwd", "swiglu_fwd",
                      "paged_decode"), churn=True)
        lora_step_cost(paged, card)
        del paged
        gc.collect()
        ceng = lora_engine(uni, specs, paged=False, max_pages=None,
                           prefill_attn_impl="pallas")
        lora_merged_logits(ceng, specs, card)
        # The page pool prefills in chunks through the plain attention (as
        # the JAX engine does), so the flash kernel runs under adapters in
        # the contiguous engine's bucketed prefill.
        lora_traffic(ceng, card, "contiguous, bucketed prefill", 6,
                     ("rmsnorm_fwd", "add_rmsnorm_fwd", "swiglu_fwd",
                      "flash_fwd"), churn=False)
        del ceng, uni
        gc.collect()
        torch.cuda.empty_cache()
        print(f"adapters: engines freed, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.nbytes


def _index_states(url: str) -> dict:
    status, raw = _get(url + "/v2/repository/index")
    if status != 200:
        fail(f"repository index: HTTP {status}")
    return {m["name"]: m["state"] for m in json.loads(raw)["models"]}


def phase_repository(card: str) -> None:
    """(g)2: two Llama-3-8B models (alpha: the serving seed; beta: the next)
    behind ``ModelServer(repository=...)`` with ``max_loaded=1`` on the page
    pool; requests alpha → beta → alpha over HTTP, each switch an LRU
    eviction whose freed bytes (after ``gc.collect()``, at the start of the
    next build) must cover the evicted model's weights; alpha's reloaded
    greedy tokens equal its first answer; then an unload while a streamed
    request holds alpha's lease, which must finish 200. (g)3 where grpcio is
    installed: ``ModelInfer`` on the same server gives the REST text, and
    ``ModelReady`` of an unknown name is false."""
    import importlib.util

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine
    from kubeflow_tpu_torch.serve.repository import (
        ModelRepository, estimate_model_bytes,
    )
    from kubeflow_tpu_torch.serve.server import ModelServer

    gc.collect()
    torch.cuda.empty_cache()
    has_grpc = all(importlib.util.find_spec(m) is not None
                   for m in ("grpc", "google.protobuf"))
    # bf16 weights in the config, so estimate_model_bytes books them at 2 B.
    cfg = preset("llama3-8b", param_dtype="bfloat16")
    spec = BatchingSpec(**PAGED_SPEC)
    repo = ModelRepository(max_loaded=1, device="cuda")
    builds: list[tuple[str, float, int]] = []   # name, seconds, bytes at start

    for name, seed in (("alpha", SEED), ("beta", SEED + 1)):
        def make(name=name, seed=seed):
            gc.collect()
            at_start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eng = LLMEngine(cfg, spec, seed=seed, device="cuda")
            torch.cuda.synchronize()
            builds.append((name, time.perf_counter() - t0, at_start))
            return eng

        repo.register(name, cfg, make_engine=make, tokenizer=TokenIdText(),
                      batching=spec)
    estimate = estimate_model_bytes(cfg, spec)
    server = ModelServer("alpha", repository=repo,
                         grpc_port=0 if has_grpc else None)
    server.start()
    prompt = text(300, 61)
    body = {"prompt": prompt, "max_tokens": 16, "temperature": 0.0}
    answers: list[str] = []
    try:
        if _index_states(server.url) != {"alpha": "UNLOADED",
                                         "beta": "UNLOADED"}:
            fail("repository: models loaded before any request")
        weights = {}
        for k, name in enumerate(("alpha", "beta", "alpha")):
            gc.collect()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            status, raw = _post(server.url + "/v1/completions",
                                {**body, "model": name})
            wall = time.perf_counter() - t0
            if status != 200:
                fail(f"repository {name}: HTTP {status}")
            answers.append(json.loads(raw)["choices"][0]["text"])
            states = _index_states(server.url)
            other = "beta" if name == "alpha" else "alpha"
            if states != {name: "READY", other: "UNLOADED"}:
                fail(f"repository after {name}: index {states}")
            weights[name] = _tree_bytes(repo.peek(name).engine.params)
            bname, build_s, at_start = builds[-1]
            line = (f"repository request {k + 1} ({name}): 200 in "
                    f"{wall:.2f} s, build {build_s:.2f} s, index {states}")
            if k:
                freed = held - at_start
                line += (f", eviction of {other} freed {freed} B against its "
                         f"{weights[other]} B of weights")
                if freed < weights[other]:
                    fail(f"repository: evicting {other} freed {freed} B, "
                         f"under its weights' {weights[other]} B")
            print(line + f"; {card}", flush=True)
        print(f"repository: estimate_model_bytes {estimate} B per model, "
              f"weights {weights['alpha']} B, "
              f"{torch.cuda.memory_allocated()} B allocated with one loaded",
              flush=True)
        if answers[2] != answers[0]:
            fail("repository: alpha's reloaded tokens differ: "
                 + _first_difference(answers[2].split(), answers[0].split()))
        if has_grpc:
            grpc_check(server, body, answers[0])
        else:
            print("grpc: not installed on this machine; (g)3 not run",
                  flush=True)
        leased_unload(server, repo, body)
    finally:
        server.stop()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"repository: server stopped, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)


def grpc_check(server, body: dict, want: str) -> None:
    """(g)3: ``ModelInfer`` of alpha on the server's gRPC port gives the
    REST completion's text; ``ModelReady`` is true for alpha and false for
    an unknown name."""
    from kubeflow_tpu_torch.serve.grpc_server import oip_connect
    from kubeflow_tpu_torch.serve.protos import oip_pb2 as pb

    channel, stub = oip_connect(server.grpc_server.target)
    try:
        req = pb.ModelInferRequest(model_name="alpha")
        req.parameters["max_tokens"].int64_param = body["max_tokens"]
        req.parameters["temperature"].double_param = body["temperature"]
        tin = req.inputs.add(name="text", datatype="BYTES", shape=[1])
        tin.contents.bytes_contents.append(body["prompt"].encode())
        t0 = time.perf_counter()
        got = stub.ModelInfer(req, timeout=600).outputs[0] \
            .contents.bytes_contents[0].decode()
        wall = time.perf_counter() - t0
        ready = stub.ModelReady(pb.ModelReadyRequest(name="alpha")).ready
        ghost = stub.ModelReady(pb.ModelReadyRequest(name="ghost")).ready
    finally:
        channel.close()
    print(f"grpc: ModelInfer alpha {wall:.2f} s, text "
          f"{'equals' if got == want else 'differs from'} the REST "
          f"completion's; ModelReady alpha {ready}, ghost {ghost}", flush=True)
    if got != want or not ready or ghost:
        fail("grpc: ModelInfer or ModelReady disagrees with the server")


def leased_unload(server, repo, body: dict) -> None:
    """(g)2: unload alpha while a streamed completion holds its lease; the
    stream must finish 200 with ``[DONE]`` and the detached engine stop
    when the lease releases."""
    entry = repo.peek("alpha")
    reply: list = []
    th = threading.Thread(target=lambda: reply.append(_post(
        server.url + "/v1/completions",
        {**body, "model": "alpha", "max_tokens": 64, "stream": True})))
    th.start()
    t0 = time.perf_counter()
    while entry.refs < 1:
        if time.perf_counter() - t0 > 60 or not th.is_alive():
            fail("repository: the streamed request never took its lease")
        time.sleep(0.005)
    engine = entry.engine
    status, raw = _post(server.url + "/v2/repository/models/alpha/unload", {})
    states = _index_states(server.url)
    if status != 200 or states["alpha"] != "UNLOADED":
        fail(f"repository unload: HTTP {status}, index {states}")
    th.join(timeout=600)
    ok = bool(reply) and reply[0][0] == 200 \
        and reply[0][1].rstrip().endswith(b"data: [DONE]")
    t0 = time.perf_counter()
    while entry.draining and time.perf_counter() - t0 < 60:
        time.sleep(0.01)
    print(f"repository leased unload: the stream finished "
          f"{reply[0][0] if reply else None} with [DONE] {ok}, draining "
          f"{len(entry.draining)}, engine stopped {engine.stopped_clean}",
          flush=True)
    if not ok or entry.draining or engine.stopped_clean is not True:
        fail("repository: the leased unload did not drain cleanly")


def phase_many_models(card: str) -> None:
    """(g): adapters in process, then the repository and gRPC over HTTP."""
    timed_phase("adapters", phase_adapters, card)
    timed_phase("repository", phase_repository, card)


# -- (h) speculative decoding: ngram and draft model, dense and paged verify --

#: Drafts per spec round in every (h) engine.
SPEC_K = 4
#: (h)4's traffic: ``LOADGEN`` with 64 new tokens, where random weights'
#: greedy text starts to repeat and the n-gram drafter first proposes.
SPEC_LOADGEN = dict(LOADGEN, max_new=64)
#: (h)2 and (h)3's replay prompts: four random prompts P of 200 tokens, each
#: run as P + G + P with G its 32 greedy tokens, so the n-gram drafter
#: proposes G from the first round.
SPEC_PROMPTS, SPEC_PROMPT_LEN, SPEC_NEW = 4, 200, 32
#: An emitted token may differ from the full-forward reference's argmax only
#: where the reference's logit for it is within this of the top one: bf16
#: sums in another order (a verify over T rows, the split count of B·T
#: virtual rows) may break such a near tie either way.
NEAR_TIE_ATOL, NEAR_TIE_RTOL = 1e-2, 2.0 ** -7


def _spec_wrappers(paged: bool) -> dict:
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention

    out = {"rmsnorm_fwd": fused_norm.rmsnorm_fused,
           "swiglu_fwd": fused_norm.swiglu_fused}
    if paged:
        out["paged_decode"] = paged_decode_attention
    return out


def _launches_zero(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0


def _timed_step(fn) -> tuple[float, float, float]:
    """(host enqueue ms, wall ms to a synchronize, device ms from the
    profiler) of one call of ``fn`` after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, _ = _kernel_times(prof)
    return enq * 1e3, wall * 1e3, total


def spec_verify_check(uni, card: str) -> None:
    """(h)1: one paged verify step (8 slots × k + 1 = 5 positions) through
    the paged-decode kernel over 40 virtual rows against the gather route,
    on the same pool: a 1024-token prompt prefilled into 8 shared pages,
    rows at positions 1024..1030 and one at 2045 whose last two positions
    pass max_len (the sink takes their writes, the kernel's rows clamp).
    fp32 logits within rel L2 5e-2 and the same argmax except at near
    ties; exactly L paged-decode, 2L + 1 RMSNorm and L SwiGLU launches in
    the kernel route's step. bf16 pages, then int8. The step's enqueue,
    wall and device ms beside one decode step's."""
    from kubeflow_tpu_torch.serve.paged import (
        _paged_decode_step, context_bucket, paged_chunk_prefill,
    )
    from kubeflow_tpu_torch.serve.spec_decode import _paged_verify_logits

    cfg, pg, mpp, t_len, b = uni.cfg, 128, 16, SPEC_K + 1, 8
    gen = torch.Generator().manual_seed(SEED + 30)
    prompt = torch.randint(3, 259, (1024,), generator=gen).to("cuda")
    tokens = torch.randint(3, 128256, (b, t_len), generator=gen).to("cuda")
    lengths = torch.tensor([1024 + i for i in range(b - 1)] + [2045],
                           device="cuda")
    live = torch.ones((b,), dtype=torch.bool, device="cuda")
    npages = 8 + (b - 1) + 8
    table = torch.full((b, mpp), -1, dtype=torch.int32, device="cuda")
    table[:, :8] = torch.arange(8, dtype=torch.int32)
    for i in range(b - 1):
        table[i, 8] = 8 + i
    table[b - 1, 8:] = torch.arange(15, 23, dtype=torch.int32)
    wrappers = _spec_wrappers(True)
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        shape = (cfg.n_layers, npages + 1, pg, cfg.n_kv_heads, cfg.head_dim)
        if quant:
            cache = {n: torch.randint(-127, 128, shape, generator=gen,
                                      dtype=torch.int8).to("cuda")
                     for n in ("k", "v")}
            for n in ("ks", "vs"):
                cache[n] = torch.full(shape[:-1], 2.0 / 127, device="cuda")
        else:
            cache = {n: torch.randn(shape, generator=gen).to(
                device="cuda", dtype=torch.bfloat16) for n in ("k", "v")}
        with torch.no_grad():
            for start in range(0, 1024, 512):
                paged_chunk_prefill(
                    uni.params, cache, prompt[start:start + 512][None],
                    table[0], start, 512, cfg,
                    context_pages=context_bucket(start, 512, pg, mpp))
            logits = {}
            for impl in ("pallas", "gather"):
                pool = {n: c.clone() for n, c in cache.items()}
                pool["table"] = table
                _launches_zero(wrappers)
                logits[impl] = _paged_verify_logits(
                    uni.params, pool, tokens, lengths, live, cfg,
                    attn_impl=impl)
                torch.cuda.synchronize()
                if impl == "pallas":
                    got = {n: w.launches for n, w in wrappers.items()}
            pool = {**cache, "table": table}
            verify = _timed_step(lambda: _paged_verify_logits(
                uni.params, pool, tokens, lengths, live, cfg,
                attn_impl="pallas"))
            decode = _timed_step(lambda: _paged_decode_step(
                uni.params, pool, tokens[:, 0], lengths, live, cfg,
                attn_impl="pallas"))
        want = {"rmsnorm_fwd": 2 * cfg.n_layers + 1,
                "swiglu_fwd": cfg.n_layers, "paged_decode": cfg.n_layers}
        a, r = logits["pallas"], logits["gather"]
        rel = float((a - r).norm() / r.norm())
        rel_edge = float((a[-1] - r[-1]).norm() / r[-1].norm())
        ties = argmax_near_ties(a.argmax(-1).flatten(),
                                r.reshape(-1, r.shape[-1]),
                                f"(h)1 verify ({kind} pages)")
        print(f"(h)1 paged verify ({kind} pages, 8 slots x {t_len} "
              f"positions, 40 virtual rows, {cfg.n_layers} layers): logits "
              f"kernel vs gather rel L2 {rel:.3e} (row at 2045: "
              f"{rel_edge:.3e}; tolerance {PREFILL_REL_L2:g}), argmax "
              f"departures {ties} (near ties), launches {json.dumps(got)}",
              flush=True)
        print(f"(h)1 step ms ({kind} pages): verify enqueue {verify[0]:.2f} "
              f"wall {verify[1]:.2f} device {verify[2]:.2f}; decode step "
              f"enqueue {decode[0]:.2f} wall {decode[1]:.2f} device "
              f"{decode[2]:.2f}; {card}", flush=True)
        if not rel <= PREFILL_REL_L2 or not rel_edge <= PREFILL_REL_L2:
            fail(f"(h)1: the kernel route's verify disagrees with the "
                 f"gather route ({kind} pages)")
        if got != want:
            fail(f"(h)1: verify launches {got}, want {want}")
        del cache, pool
    tickets_zero("(h)1")


def argmax_near_ties(got: torch.Tensor, logits: torch.Tensor,
                     name: str) -> int:
    """Rows of ``logits`` [N, V] (fp32, the reference's) whose argmax is not
    ``got`` [N]: each must be a near tie (the reference's logit for ``got``
    within NEAR_TIE_ATOL + NEAR_TIE_RTOL·|top| of its top one). Returns
    their number."""
    want = logits.argmax(-1)
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        top = logits[diff, want[diff]]
        mine = logits[diff, got[diff]]
        gap = top - mine
        if torch.any(gap > NEAR_TIE_ATOL + NEAR_TIE_RTOL * top.abs()):
            fail(f"{name}: a token is not the reference's argmax and no near "
                 f"tie: gaps {gap.tolist()[:8]}")
    return int(diff.numel())


def plain_logits(params, cfg, prompt, out, dtype: str = "bfloat16"):
    """The plain full forward (no cache, kernels off) in ``dtype`` over
    prompt + ``out[:-1]``: the fp32 logits [len(out), V] that chose each
    token of ``out``."""
    import dataclasses

    from kubeflow_tpu_torch.models.decoder import decoder_forward, lm_head

    cfg = dataclasses.replace(cfg, dtype=dtype, fused_kernels="off")
    with torch.no_grad():
        ctx = torch.tensor([list(prompt) + list(out[:-1])], device="cuda")
        hid, _ = decoder_forward(params, ctx, cfg, skip_head=True)
        return lm_head(params, hid[0, len(prompt) - 1:], cfg)


def spec_reference(eng, prompts, outs, name: str) -> int:
    """Every emitted token against a plain full forward (no cache, plain
    kernels off) over prompt + the tokens emitted before it: the argmax,
    or a near tie. Returns the near-tie departures."""
    departs = 0
    for p, out in zip(prompts, outs):
        departs += argmax_near_ties(
            torch.tensor(out, device="cuda"),
            plain_logits(eng.params, eng.cfg, p, out), name)
    return departs


def int8_reference(eng, prompts, outs, name: str) -> tuple[int, int]:
    """Every emitted token against two plain full forwards over the
    engine's weights, one in bf16 (its dtype) and one in fp32: the argmax
    or a near tie of either. The kernels under test run in neither.
    Returns (departures from the bf16 forward's argmax, those of them that
    are a near tie of the fp32 forward only)."""
    departs = fp32_only = 0
    for p, out in zip(prompts, outs):
        got = torch.tensor(out, device="cuda")
        ties = {}
        for dtype in ("bfloat16", "float32"):
            logits = plain_logits(eng.params, eng.cfg, p, out, dtype)
            top = logits.max(-1).values
            gap = top - logits.gather(1, got[:, None])[:, 0]
            ties[dtype] = (gap, gap <= NEAR_TIE_ATOL
                           + NEAR_TIE_RTOL * top.abs())
        (g16, t16), (g32, t32) = ties["bfloat16"], ties["float32"]
        if not torch.all(t16 | t32):
            bad = (~t16 & ~t32).nonzero().flatten()
            fail(f"{name}: a token is no near tie of either plain forward: "
                 f"gaps bf16 {g16[bad].tolist()[:8]} fp32 "
                 f"{g32[bad].tolist()[:8]}")
        departs += int((g16 > 0).sum())
        fp32_only += int((~t16).sum())
    return departs, fp32_only


def _tpot_p50(reqs) -> float:
    from kubeflow_tpu_torch.obs.stats import quantile

    return quantile(sorted(
        (r.finish_time - r.first_token_time) / (len(r.output_tokens) - 1)
        for r in reqs if len(r.output_tokens) > 1), 0.5) * 1e3


def _spec_run(eng, prompts, wrappers: dict):
    """The main path: greedy requests through ``eng``'s scheduler, every
    launch count 0 just before and read just after. Returns (requests,
    launches)."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams

    _launches_zero(wrappers)
    reqs = [eng.submit(list(p), SamplingParams(max_new_tokens=SPEC_NEW))
            for p in prompts]
    _drive_all(eng, reqs)
    torch.cuda.synchronize()
    return reqs, {n: w.launches for n, w in wrappers.items()}


SPEC_LAYOUTS = {"paged bf16": {}, "paged int8": {"kv_cache_dtype": "int8"},
                "contiguous": {"paged": False, "max_pages": None}}


def spec_replay(uni, rows: list[dict], card: str) -> None:
    """(h)2 and (h)3 on the serving weights. Per layout (paged bf16, paged
    int8, contiguous): G from a spec-off engine, then P + G + P through the
    spec-off engine, an ngram engine and a self-draft engine (the target's
    own tensors as the draft: no second copy). Every emitted token is the
    reference's argmax or a near tie; each spec engine ran rounds, drafted,
    launched rows 1 and 4 (and 12 on the page pool) and left no page
    referenced. (h)3: a 2-layer random draft of Llama-3-8B widths on the
    page pool: acceptance near 0, tokens as above, no leak, 0 resident."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams

    gen = torch.Generator().manual_seed(SEED + 40)
    prompts = torch.randint(3, 128256, (SPEC_PROMPTS, SPEC_PROMPT_LEN),
                            generator=gen).tolist()
    ngram = {"mode": "ngram", "k": SPEC_K}
    self_draft = {"mode": "draft_model", "k": SPEC_K,
                  "draft": {"preset": "llama3-8b"}}
    bad_draft = {"mode": "draft_model", "k": SPEC_K,
                 "draft": {"preset": "llama3-8b",
                           "overrides": {"n_layers": 2}}}
    cases = [(layout, name, spec) for layout in SPEC_LAYOUTS
             for name, spec in (("ngram", ngram), ("self-draft", self_draft))]
    cases.append(("paged bf16", "2-layer draft", bad_draft))
    replays = {}
    for layout, name, spec in cases:
        over = SPEC_LAYOUTS[layout]
        paged = over.get("paged", True)
        if layout not in replays:
            plain = paged_engine(uni, **over)
            gs = _drive_all(plain, [plain.submit(p, SamplingParams(
                max_new_tokens=SPEC_NEW)) for p in prompts])
            replay = [p + g + p for p, g in zip(prompts, gs)]
            preqs, _ = _spec_run(plain, replay, {})
            replays[layout] = (replay, _tpot_p50(preqs))
            del plain
        replay, plain_tpot = replays[layout]
        eng = paged_engine(uni, speculative=spec,
                           draft_params=uni.params if name == "self-draft"
                           else None, **over)
        wrappers = _spec_wrappers(paged)
        reqs, launches = _spec_run(eng, replay, wrappers)
        outs = [r.output_tokens for r in reqs]
        snap = eng.metrics.snapshot()
        departs = spec_reference(eng, replay, outs, f"(h) {layout} {name}")
        resident = eng.kv_pages_in_use()
        leaks = {} if eng._allocator is None \
            else eng._allocator.leak_report()
        label = "(h)3" if name == "2-layer draft" else "(h)2"
        print(f"{label} {layout} {name}: spec_rounds "
              f"{snap.get('spec_rounds')}"
              f", drafted {eng.metrics.spec_drafted}, accepted "
              f"{eng.metrics.spec_accepted}, acceptance "
              f"{snap.get('spec_acceptance_rate', 0):.4f}, tokens per step "
              f"{snap.get('spec_tokens_per_step', 0):.3f}, draft overhead "
              f"{snap.get('spec_draft_overhead', 0):.3f}; TPOT p50 "
              f"{_tpot_p50(reqs):.2f} ms against the spec-off engine's "
              f"{plain_tpot:.2f} ms on the same prompts; "
              f"{sum(map(len, outs))} tokens, {departs} near-tie departures "
              f"from the reference; launches {json.dumps(launches)}; "
              f"resident pages {resident}, leaks {leaks}; {card}", flush=True)
        if not snap.get("spec_rounds") or not eng.metrics.spec_drafted:
            fail(f"{label} {layout} {name}: no spec round drafted")
        if any(len(o) != SPEC_NEW for o in outs):
            fail(f"{label} {layout} {name}: lengths {list(map(len, outs))}")
        for n, count in launches.items():
            if count <= 0:
                fail(f"{label} {layout} {name}: {n} never launched")
        if resident or leaks:
            fail(f"{label} {layout} {name}: pages still referenced: {leaks}")
        if eng._allocator is not None:
            eng._allocator.assert_quiescent()
        for r in rows:
            if r["name"] == "paged_decode" and layout == "paged bf16" \
                    or r["name"] == "paged_decode_int8" \
                    and layout == "paged int8":
                r["launches"] = r.get("launches", 0) \
                    + launches["paged_decode"]
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def spec_worker(card: str, plain_tpot=None) -> None:
    """(h)4: ``runtime.worker_main`` with ``batching.speculative`` ngram on
    the page pool (``PAGED_SPEC``), ``uniform`` through ``ServerTarget``:
    every request ok, ``kftpu_serving_spec_tokens_per_step`` and the
    acceptance rate read off ``/metrics``, TPOT p50 beside ``plain_tpot``
    ((c)'s spec-off worker's in this run, when (c) ran); SIGTERM gives
    143."""
    from kubeflow_tpu_torch import loadgen

    t0 = time.perf_counter()
    batching = dict(PAGED_SPEC, speculative={"mode": "ngram", "k": SPEC_K})
    proc, url, log = spawn_worker(batching, "spec_worker")
    ok = False
    try:
        t_ready = wait_ready(proc, url, "spec worker", t0)
        sc = next(x for x in loadgen.standard_matrix(**SPEC_LOADGEN)
                  if x.name == "uniform")
        run = loadgen.run_scenario(loadgen.ServerTarget(url, model="llama"),
                                   sc, vocab_size=128256, max_prompt_len=1024)
        rep = loadgen.build_report(run, metrics_text=_get(url + "/metrics")[1])
        report_line("uniform (ServerTarget, spec worker, ngram k=4, page "
                    "pool)", rep, card)
        tps = _series(url, "kftpu_serving_spec_tokens_per_step")
        acc = _series(url, "kftpu_serving_spec_acceptance_rate")
        over = _series(url, "kftpu_serving_spec_draft_overhead")
        without = ("not measured" if plain_tpot is None
                   else f"{plain_tpot} ms")
        print(f"(h)4 spec worker: ready in {t_ready:.1f} s; /metrics spec "
              f"tokens per step {tps}, acceptance {acc}, draft overhead "
              f"{over}; TPOT p50 {rep['tpot_ms'].get('p50')} ms with spec, "
              f"{without} without ((c)'s worker in this run); {card}",
              flush=True)
        if rep["by_status"] != {"ok": rep["requests"]}:
            fail(f"(h)4 uniform: statuses {rep['by_status']}")
        if tps < 1.0:
            fail("(h)4: /metrics shows no spec round")
        sigterm_worker(proc, url, "spec worker")
        ok = True
    finally:
        reap_worker(proc, log, "spec worker", ok)


def phase_spec(rows: list[dict], card: str, plain_tpot=None) -> None:
    """(h): speculative decoding on one 32-layer engine's weights (the
    serving seed), then the spec worker (``plain_tpot``: (c)'s
    ``uniform`` TPOT p50)."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    gc.collect()
    torch.cuda.empty_cache()
    uni = LLMEngine(preset("llama3-8b"), BatchingSpec(**PAGED_SPEC),
                    seed=SEED, device="cuda")
    timed_phase("spec verify", spec_verify_check, uni, card)
    timed_phase("spec replay", spec_replay, uni, rows, card)
    del uni
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("spec worker", spec_worker, card, plain_tpot)


#: (i): Mixtral-8x7B (32 layers, hidden 4096, 32/8 heads of 128, 8 experts
#: of MLP 14336, top 2, vocab 32000), random bf16 weights from a seed.
MOE_MODEL = {"preset": "mixtral-8x7b", "overrides": {"param_dtype": "bfloat16"}}
#: The int8 engines: ``PAGED_SPEC`` with int8 weights, prefix caching off
#: (every prompt prefills from position 0 in 512-token chunks, the windows
#: the plain reference replays: capacity, so drops, depends on them).
MOE_SPEC = dict(PAGED_SPEC, quantize="int8", enable_prefix_caching=False)
#: (i)1: the bucket and the real rows of the one-block check.
MOE_BLOCK_T, MOE_BLOCK_VALID = 2048, 1500
MOE_REL_L2 = 1e-2
#: A Mixtral token is held to two plain forwards over the same int8 weights
#: (``moe_witness``): one in bf16, the engine's dtype, and one in fp32. The
#: argmax or a near tie (as (h)) of either passes. Beyond that, two bf16
#: paths that differ only in rounding still route a near-tied token to
#: other experts, or drop another token's pair from a shifted capacity
#: queue, and so move that position's logits (and later ones through its
#: K/V) as far as a fault does (one correct token read 0.97 below the
#: fp32 top, more than any one token of a fault). So the check counts: at
#: most MOE_BEYOND_FRAC of an engine's tokens may lie beyond both bands,
#: and each engine decodes MOE_NEW tokens a request so that the count can
#: separate. On the H100 the three 8-layer engines read 6, 6 and 5 of 256
#: (2.3%), the 32-layer worker 7 of 192 (3.6%); the planted faults of
#: ``moe_fault_controls`` read 31 (12.1%) and 97 of 256. The limit lies
#: 1.7x above the worst correct rate and 1.9x below the smaller fault.
MOE_BEYOND_FRAC = 1 / 16
#: (i)2: prompt lengths (one in the contiguous 2048 bucket, the flash
#: kernel's) and the quality gate's prompts.
MOE_PROMPT_LENS = (40, 300, 700, 1000)
MOE_NEW = 64
#: (i)3: the worker's completions and traffic.
MOE_WORKER_PROMPTS = ((60, 61), (300, 62), (500, 63))
MOE_LOADGEN = dict(num_requests=4, rate_rps=4.0, prompt_len=512, max_new=64,
                   seed=0)


def _moe_wrappers() -> dict:
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention

    return {"rmsnorm_fwd": fused_norm.rmsnorm_fused,
            "add_rmsnorm_fwd": fused_norm.add_rmsnorm_fused,
            "swiglu_fwd": fused_norm.swiglu_fused,
            "flash_fwd": flash_attention,
            "paged_decode": paged_decode_attention}


def moe_block_check(card: str) -> None:
    """(i)1: one MoE block at Mixtral width (bf16, seeded): at T = 2048 with
    1500 real rows, the dispatch path at capacity factor E (nothing drops)
    against the dense oracle on the real rows, pad rows exactly zero; at
    the model's 1.25 the dropped pairs counted and no slot held by a pad
    row; dispatch and dense timed at T = 2048 and at 8 decode rows."""
    import dataclasses

    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import preset

    cfg = preset("mixtral-8x7b")
    e, k, t, vl = (cfg.num_experts, cfg.experts_per_token, MOE_BLOCK_T,
                   MOE_BLOCK_VALID)
    gen = torch.Generator("cuda").manual_seed(SEED + 50)
    p = L.init_moe(gen, cfg, torch.bfloat16)
    x = torch.randn((1, t, cfg.hidden), generator=gen,
                    device="cuda").to(torch.bfloat16)
    ample = dataclasses.replace(cfg, capacity_factor=float(e))
    dense = dataclasses.replace(cfg, moe_impl="dense")
    with torch.no_grad():
        got, _ = L.moe_block(p, x, ample, valid_len=vl)
        want, _ = L.moe_block(p, x, dense)
        trained, _ = L.moe_block(p, x, cfg, valid_len=vl)
        plan = L.dispatch_plan(L.moe_route(p, x, cfg)[2], cfg, vl)
    rel = rel_l2(got[0, :vl], want[0, :vl])
    pads = float(got[0, vl:].abs().max())
    c = plan["capacity"]
    kept = int((plan["rows"] < e * c).sum())
    held = plan["row_of_slot"][plan["row_of_slot"] < t]
    pad_slots = int((held >= vl).sum())
    per_expert = torch.bincount(plan["rows"][plan["rows"] < e * c] // c,
                                minlength=e).tolist()
    print(f"(i)1 MoE block (Mixtral width, bf16, T={t}, valid_len {vl}): "
          f"dispatch at capacity factor {e} vs dense rel L2 {rel:.3e} "
          f"(tolerance {MOE_REL_L2:g}), pad rows max |out| {pads}; at "
          f"capacity factor {cfg.capacity_factor}: C = {c}, "
          f"{k * vl - kept} of {k * vl} real pairs dropped, slots used per "
          f"expert {per_expert}, {pad_slots} slots held by pad rows, output "
          f"rel L2 {rel_l2(trained[0, :vl], want[0, :vl]):.3e} from dense",
          flush=True)
    if not rel <= MOE_REL_L2 or pads != 0.0:
        fail("(i)1: the dispatch path disagrees with the dense oracle")
    if pad_slots:
        fail(f"(i)1: {pad_slots} expert slots were claimed by pad rows")
    for rows in (t, 8):
        xs = x[:, :rows].contiguous()
        with torch.no_grad():
            t_disp = event_ms(lambda: L.moe_block(p, xs, cfg))
            t_zero = event_ms(lambda: L.moe_block(p, xs, ample))
            t_dense = event_ms(lambda: L.moe_block(p, xs, dense))
        print(f"(i)1 MoE block T={rows}: dispatch (factor "
              f"{cfg.capacity_factor}) {t_disp:.3f} ms, zero-drop dispatch "
              f"(factor {e}) {t_zero:.3f} ms, dense {t_dense:.3f} ms "
              f"(CUDA events); {card}", flush=True)
    del got, want, trained, p, x


class _MoeHooks:
    """While active, wraps ``layers.moe_block`` (each forward calls it once
    per layer, in order) and records each call's routing margin per
    position: the gap between the k-th and (k+1)-th router logits (fp32 of
    the product in the block's dtype) in units of the near-tie band. With
    ``drop_layer`` (a planted fault) that layer routes each token to its
    first choice alone. ``take()`` returns the [layers, S] margins of the
    forward since the last take."""

    def __init__(self, drop_layer: int | None = None):
        from kubeflow_tpu_torch.models import layers as L

        self.L, self.drop, self.calls = L, drop_layer, []

    def __enter__(self):
        import dataclasses

        L, orig = self.L, self.L.moe_block
        self.orig = orig

        def hooked(p, x, cfg, **kw):
            k = cfg.experts_per_token
            logits = (x @ L.weight(p["router"], cfg.activation_dtype)).float()
            top = torch.sort(logits, dim=-1, descending=True).values
            gap = top[..., k - 1] - top[..., k]
            band = NEAR_TIE_ATOL + NEAR_TIE_RTOL * top[..., k - 1].abs()
            if len(self.calls) == self.drop:
                cfg = dataclasses.replace(cfg, experts_per_token=1)
            self.calls.append((gap / band)[0])
            return orig(p, x, cfg, **kw)

        L.moe_block = hooked
        return self

    def __exit__(self, *exc):
        self.L.moe_block = self.orig

    def take(self) -> torch.Tensor:
        out, self.calls = torch.stack(self.calls), []
        return out


def moe_witness(params, cfg, prompt: list[int], out: list[int], chunk: int,
                dtype: str, *, kv_quant: bool = False,
                drop_layer: int | None = None):
    """The plain forward (plain ops, the plain attention) in ``dtype`` over
    ``params``, teacher-forced and phase for phase as the engine runs them:
    the prompt in ``chunk``-token windows from position 0, each padded to
    ``chunk`` with its real rows as ``valid_len`` (the model's dispatch
    path: the same capacity and drops), then ``out[:-1]`` on the dense path
    (the engine's decode) over that cache. ``kv_quant`` (an int8 pool):
    every forward reads the K/V of earlier positions quantized per token
    and head and dequantized, as the pool holds them, so the decode tokens
    go one forward each. ``drop_layer`` plants a control's fault.
    Returns the [len(out), V]
    fp32 logits and, per token, the smallest routing margin over the
    layers at its position (``_MoeHooks``)."""
    import dataclasses

    from kubeflow_tpu_torch.models.decoder import decoder_forward
    from kubeflow_tpu_torch.ops.quantization import (
        dequantize_kv, quantize_kv,
    )

    pre = dataclasses.replace(cfg, dtype=dtype, fused_kernels="off")
    dec = dataclasses.replace(pre, moe_impl="dense")
    dt = pre.activation_dtype
    n = len(prompt)
    span = -(-n // chunk) * chunk + len(out)
    shape = (cfg.n_layers, 1, span, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device="cuda"),
             "v": torch.zeros(shape, dtype=dt, device="cuda")}

    def forward(toks: list[int], c, start: int, **kw):
        view = cache
        if kv_quant:
            view = {m: t.clone() for m, t in cache.items()}
            for m in view:
                view[m][:, :, :start] = dequantize_kv(
                    *quantize_kv(cache[m][:, :, :start]), dt)
        logits, _ = decoder_forward(
            params, torch.tensor([toks], device="cuda"), c,
            kv_caches={**view, "len": start}, **kw)
        if kv_quant:
            for m in view:
                cache[m][:, :, start:start + len(toks)] = \
                    view[m][:, :, start:start + len(toks)]
        return logits[0]

    rows, margins = [], []
    with torch.no_grad(), _MoeHooks(drop_layer) as rec:
        for c0 in range(0, n, chunk):
            real = min(chunk, n - c0)
            logits = forward(prompt[c0:c0 + real] + [0] * (chunk - real),
                             pre, c0, valid_len=real)
            m = rec.take()
        rows.append(logits[real - 1])
        margins.append(m[:, real - 1].min())
        steps = [out[:-1]] if not kv_quant else [[t] for t in out[:-1]]
        pos = n
        for toks in steps if len(out) > 1 else []:
            rows.extend(forward(toks, dec, pos))
            margins.extend(rec.take().min(dim=0).values)
            pos += len(toks)
    return torch.stack(rows), torch.stack(margins)


def moe_witnesses(params, cfg, prompts, outs, chunks, **kw) -> dict:
    """``moe_witness`` in bf16 and in fp32 for each request, concatenated
    over the requests: {dtype: (logits [N, V], margins [N])}."""
    got = {}
    for dtype in ("bfloat16", "float32"):
        runs = [moe_witness(params, cfg, p, o, c, dtype, **kw)
                for p, o, c in zip(prompts, outs, chunks)]
        got[dtype] = tuple(torch.cat(x) for x in zip(*runs))
    return got


def moe_judge(outs, witnesses: dict) -> dict:
    """An engine's tokens (``outs``, one list per request) against the two
    witnesses (``moe_witnesses``): the tokens that depart from the bf16
    witness's argmax, those of them that are a near tie of either witness,
    and those beyond (with their gaps below each witness's top, their ranks
    and routing margins). ``ok``: at most MOE_BEYOND_FRAC of the tokens
    (``limit``) lie beyond."""
    got = torch.tensor([t for o in outs for t in o], device="cuda")
    st = {}
    for dtype, (logits, margins) in witnesses.items():
        top = logits.max(-1).values
        mine = logits.gather(1, got[:, None])[:, 0]
        st[dtype] = {"gap": top - mine, "rank": (logits > mine[:, None]).sum(-1),
                     "tie": top - mine <= NEAR_TIE_ATOL
                     + NEAR_TIE_RTOL * top.abs(), "margin": margins,
                     "std": float(logits.std(-1).mean())}
    b16, b32 = st["bfloat16"], st["float32"]
    depart = b16["rank"] > 0
    beyond = depart & ~b16["tie"] & ~b32["tie"]
    idx = beyond.nonzero().flatten()
    limit = int(MOE_BEYOND_FRAC * got.numel())

    def vals(t):
        return [round(float(x), 4) for x in t[idx]]

    return {"tokens": int(got.numel()), "departs": int(depart.sum()),
            "tie_bf16": int((depart & b16["tie"]).sum()),
            "tie_fp32_only": int((depart & ~b16["tie"] & b32["tie"]).sum()),
            "beyond": int(idx.numel()), "gap_bf16": vals(b16["gap"]),
            "gap_fp32": vals(b32["gap"]),
            "rank_bf16": [int(x) for x in b16["rank"][idx]],
            "rank_fp32": [int(x) for x in b32["rank"][idx]],
            "margin": vals(b16["margin"]), "std": round(b16["std"], 3),
            "fp32_agrees": int((b32["rank"] == 0).sum()),
            "limit": limit, "ok": idx.numel() <= limit}


def moe_judge_line(j: dict) -> str:
    return (f"{j['tokens']} tokens, {j['departs']} depart from the bf16 "
            f"witness's argmax: {j['tie_bf16']} near ties of it, "
            f"{j['tie_fp32_only']} of the fp32 witness only, {j['beyond']} "
            f"beyond both (limit {j['limit']}, {MOE_BEYOND_FRAC:.2%} of "
            f"the tokens): gaps bf16 {j['gap_bf16']} fp32 "
            f"{j['gap_fp32']}, ranks bf16 {j['rank_bf16']} fp32 "
            f"{j['rank_fp32']}, routing margins {j['margin']} (logits' std "
            f"{j['std']}); the fp32 witness's argmax is the token at "
            f"{j['fp32_agrees']} of {j['tokens']}")


def moe_token_check(params, cfg, prompts, outs, chunks, name: str,
                    **kw) -> dict:
    """``moe_judge`` of ``outs`` against the two witnesses; fails unless
    ``ok``. Returns the judgement."""
    j = moe_judge(outs, moe_witnesses(params, cfg, prompts, outs, chunks,
                                      **kw))
    print(f"{name}: {moe_judge_line(j)}", flush=True)
    if not j["ok"]:
        fail(f"{name}: more than {j['limit']} tokens lie beyond both plain "
             f"forwards' near ties")
    return j


#: The token check's controls: one expert's down-projection scale doubled
#: in one layer, and one layer's second choice dropped. Pad rows that claim
#: expert capacity are held by ``_PadSlots`` and its own control.
MOE_FAULT_LAYER, MOE_FAULT_EXPERT = 3, 5


def moe_fault_controls(qp, cfg, prompts, outs, chunks, kv_quant: bool,
                       card: str) -> None:
    """The Mixtral token check must reject an engine's tokens against
    witnesses that carry a planted fault: each fault goes into both
    witnesses (so it stands for an engine that computes the fault-free
    model while the model is the faulty one) and ``moe_judge`` must say
    not ``ok``."""
    scale = qp["layers"]["mlp"]["down"].scale
    faults = (("down scale x2", {}), ("second choice dropped",
                                      {"drop_layer": MOE_FAULT_LAYER}))
    for name, kw in faults:
        if name == "down scale x2":
            scale[MOE_FAULT_LAYER, MOE_FAULT_EXPERT] *= 2
        try:
            j = moe_judge(outs, moe_witnesses(qp, cfg, prompts, outs, chunks,
                                              kv_quant=kv_quant, **kw))
        finally:
            if name == "down scale x2":
                scale[MOE_FAULT_LAYER, MOE_FAULT_EXPERT] /= 2
        print(f"(i)2 control, planted fault '{name}' (layer "
              f"{MOE_FAULT_LAYER}): {moe_judge_line(j)}; check "
              f"{'passes' if j['ok'] else 'fails'}; {card}", flush=True)
        if j["ok"]:
            fail(f"(i)2 control: the token check passes with the planted "
                 f"fault '{name}'")


def _held_by_pads(row_of_slot: torch.Tensor, valid: torch.Tensor) -> int:
    """How many of a dispatch plan's expert slots hold a pad row."""
    flat = valid.reshape(-1)
    held = row_of_slot[row_of_slot < flat.numel()]
    return int((~flat[held]).sum())


class _PadSlots:
    """While active, records every dispatch plan that an engine's prefill
    makes with pad rows (``valid_len``): ``check(name)`` fails unless some
    window had pads and no pad row held an expert slot in any of them,
    and unless the same count, on the padded windows' plans remade with
    their pads claiming capacity (the planted fault), finds held slots."""

    def __enter__(self):
        from kubeflow_tpu_torch.models import layers as L

        self.L, self.orig, self.plans = L, L.dispatch_plan, []

        def recorded(topk_idx, cfg, valid_len=None, *args):
            plan = self.orig(topk_idx, cfg, valid_len, *args)
            if plan["valid"] is not None:
                self.plans.append((plan, (topk_idx, cfg)))
            return plan

        L.dispatch_plan = recorded
        return self

    def __exit__(self, *exc):
        self.L.dispatch_plan = self.orig

    def check(self, name: str) -> None:
        padded = [(plan, args) for plan, args in self.plans
                  if not bool(plan["valid"].all())]
        held = sum(_held_by_pads(plan["row_of_slot"], plan["valid"])
                   for plan, _ in self.plans)
        planted = sum(_held_by_pads(self.orig(*args)["row_of_slot"],
                                    plan["valid"]) for plan, args in padded)
        print(f"{name}: {len(self.plans)} dispatch plans with valid_len, "
              f"{len(padded)} with pad rows, {held} expert slots held by "
              f"pad rows; control, the padded windows with pads claiming "
              f"capacity: {planted} held", flush=True)
        if not padded or held:
            fail(f"{name}: pad rows held expert slots, or no window had pads")
        if not planted:
            fail(f"{name}: the pad-slot check finds no slot held by pads "
                 f"that claim capacity")


def _moe_run(eng, prompts, wrappers: dict):
    """The main path: greedy requests through ``eng``'s scheduler, every
    launch count 0 just before and read just after."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams

    _launches_zero(wrappers)
    reqs = [eng.submit(list(p), SamplingParams(max_new_tokens=MOE_NEW))
            for p in prompts]
    outs = _drive_all(eng, reqs)
    torch.cuda.synchronize()
    return outs, {n: w.launches for n, w in wrappers.items()}


def _add_launches(rows: list[dict], name: str, n: int) -> None:
    for r in rows:
        if r["name"] == name:
            r["launches"] = r.get("launches", 0) + n


def moe_eight_layers(rows: list[dict], card: str) -> None:
    """(i)2: Mixtral-8x7B at full width and 8 layers, random bf16 weights
    from the serving seed, packed to int8: packed bytes against the
    config's estimate (exact); ``quantization_quality`` on 4 prompts × 16
    tokens; then int8-weight engines (paged on a bf16 pool, on an int8
    pool, contiguous): every greedy token held to the plain forwards in
    bf16 and fp32 (``moe_token_check``), the check shown to reject planted
    faults (``moe_fault_controls``), no pad row holding an expert slot in
    the engines' prefill windows (``_PadSlots``), rows 1, 2 (and 12 on the
    pool, 6 on the contiguous 2048 bucket) launched, no page left
    referenced."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import init_decoder_params
    from kubeflow_tpu_torch.ops.quantization import (
        packed_param_bytes, packed_param_bytes_estimate, quantization_quality,
        quantize_params_int8,
    )
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    cfg = preset("mixtral-8x7b", n_layers=8, param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_decoder_params(torch.Generator("cuda").manual_seed(SEED),
                                 cfg)
    qp = quantize_params_int8(params, cfg)
    torch.cuda.synchronize()
    full, packed = packed_param_bytes(params), packed_param_bytes(qp)
    est = packed_param_bytes_estimate(cfg)
    print(f"(i)2 mixtral-8x7b, {cfg.n_layers} layers: bf16 {full / 1e9:.3f} "
          f"GB, int8 packed {packed / 1e9:.3f} GB (estimate {est / 1e9:.3f} "
          f"GB), drawn and packed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if packed != est:
        fail(f"(i)2: packed_param_bytes {packed} != estimate {est}")
    gen = torch.Generator().manual_seed(SEED + 51)
    qprompts = torch.randint(3, cfg.vocab_size, (4, 64),
                             generator=gen).tolist()
    t1 = time.perf_counter()
    q = quantization_quality(cfg, params, qp, qprompts, max_new=16)
    print(f"(i)2 quantization_quality (4 prompts x 16 tokens, teacher-"
          f"forced): greedy match rate {q['greedy_match_rate']:.4f}, mean "
          f"|dlogprob| {q['mean_abs_logprob_delta']:.5f} over "
          f"{q['tokens_compared']} tokens in {time.perf_counter() - t1:.1f} "
          f"s; {card}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in MOE_PROMPT_LENS]
    wrappers = _moe_wrappers()
    for layout, over in (("paged bf16 pool", {}),
                         ("paged int8 pool", {"kv_cache_dtype": "int8"}),
                         ("contiguous", {"paged": False, "max_pages": None,
                                         "chunked_prefill_tokens": 2048})):
        eng = LLMEngine(cfg, BatchingSpec(**dict(MOE_SPEC, **over)),
                        params=qp, device="cuda")
        with _PadSlots() as pads:
            outs, launches = _moe_run(eng, prompts, wrappers)
        pads.check(f"(i)2 {layout} pads")
        chunks = [eng.chunk_size if eng.paged else
                  next(b for b in eng.buckets if b >= len(p))
                  for p in prompts]
        moe_token_check(qp, cfg, prompts, outs, chunks, f"(i)2 {layout}",
                        kv_quant=eng.kv_quant)
        if layout == "paged bf16 pool":
            moe_fault_controls(qp, cfg, prompts, outs, chunks, False, card)
        leaks = {} if eng._allocator is None \
            else eng._allocator.leak_report()
        print(f"(i)2 {layout}: launches {json.dumps(launches)}; leaks "
              f"{leaks}; {card}", flush=True)
        need = ["rmsnorm_fwd", "add_rmsnorm_fwd"] + (
            ["paged_decode"] if eng.paged else ["flash_fwd"])
        for n in need:
            if launches[n] <= 0:
                fail(f"(i)2 {layout}: {n} never launched")
        if launches["swiglu_fwd"]:
            fail(f"(i)2 {layout}: the experts ran the fused SwiGLU")
        if any(len(o) != MOE_NEW for o in outs) or leaks:
            fail(f"(i)2 {layout}: lengths {list(map(len, outs))}, "
                 f"leaks {leaks}")
        _add_launches(rows, "rmsnorm_fwd", launches["rmsnorm_fwd"])
        _add_launches(rows, "add_rmsnorm_fwd", launches["add_rmsnorm_fwd"])
        _add_launches(rows, "flash_fwd", launches["flash_fwd"])
        _add_launches(rows, "paged_decode_int8" if over.get("kv_cache_dtype")
                      else "paged_decode", launches["paged_decode"])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del qp
    gc.collect()
    torch.cuda.empty_cache()


def moe_worker(card: str) -> None:
    """(i)3: Mixtral-8x7B at all 32 layers with int8 weights through
    ``runtime.worker_main`` → ``model_server`` (``random://``: each layer
    packed as it is drawn, so the bf16 model never exists; page pool of
    bf16 KV, 8 slots × 2048), its batching a dump of the port's
    ``BatchingSpec`` (the JAX spec's fields, ``moe_*_impl`` included).
    Three completions, then ``uniform`` (``MOE_LOADGEN``) through
    ``ServerTarget``: every status ok. SIGTERM gives 143. Then the same
    seed's int8 weights in process (packed per layer): the completion
    tokens held to the plain forwards in bf16 and fp32, teacher-forced
    (``moe_token_check``). The worker's peak memory from its log, beside
    ``estimate_model_bytes``."""
    import dataclasses

    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import init_decoder_params
    from kubeflow_tpu_torch.ops.quantization import packed_param_bytes
    from kubeflow_tpu_torch.serve.repository import estimate_model_bytes

    cfg = preset(MOE_MODEL["preset"], **MOE_MODEL["overrides"])
    spec = BatchingSpec(**MOE_SPEC)
    batching = dataclasses.asdict(spec)
    if not {"moe_prefill_impl", "moe_decode_impl"} <= set(batching):
        fail("(i)3: the batching dump has no moe_*_impl fields")
    tok = TokenIdText()
    t0 = time.perf_counter()
    proc, url, log = spawn_worker(batching, "moe_worker", model=MOE_MODEL,
                                  service="mixtral")
    ok = False
    try:
        t_ready = wait_ready(proc, url, "moe worker", t0)

        def complete(n: int, salt: int) -> tuple[list[int], float]:
            t1 = time.perf_counter()
            raw = _post(url + "/v1/completions",
                        {"prompt": text(n, salt), "max_tokens": MOE_NEW})[1]
            return ([int(x) for x in
                     json.loads(raw)["choices"][0]["text"].split()],
                    time.perf_counter() - t1)

        # The three at once: the worker batches their decode.
        done: dict = {}
        threads = [threading.Thread(
            target=lambda ns=ns: done.__setitem__(ns, complete(*ns)))
            for ns in MOE_WORKER_PROMPTS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if len(done) != len(MOE_WORKER_PROMPTS):
            fail("(i)3: a worker completion raised")
        outs = [done[ns][0] for ns in MOE_WORKER_PROMPTS]
        for (n, salt), got in zip(MOE_WORKER_PROMPTS, outs):
            print(f"(i)3 worker completion, {n}-token prompt: {len(got)} "
                  f"tokens in {done[(n, salt)][1]:.2f} s (the three at "
                  f"once)", flush=True)
        sc = next(x for x in loadgen.standard_matrix(**MOE_LOADGEN)
                  if x.name == "uniform")
        run = loadgen.run_scenario(loadgen.ServerTarget(url, model="mixtral"),
                                   sc, vocab_size=cfg.vocab_size,
                                   max_prompt_len=1024)
        rep = loadgen.build_report(run, metrics_text=_get(url + "/metrics")[1])
        report_line("uniform (ServerTarget, Mixtral-8x7B int8 worker, page "
                    "pool)", rep, card)
        if rep["by_status"] != {"ok": rep["requests"]}:
            fail(f"(i)3 uniform: statuses {rep['by_status']}")
        sigterm_worker(proc, url, "moe worker")
        logged = Path(log.name).read_text()
        ok = True
    finally:
        reap_worker(proc, log, "moe worker", ok)
    mem = re.findall(r"device memory ([0-9.]+) GiB allocated, peak "
                     r"([0-9.]+) GiB \((\d+) bytes\)", logged)
    if len(mem) != 2:
        fail("(i)3: the worker logged no device memory at ready and stop")
    est = estimate_model_bytes(cfg, spec)
    peak = max(int(m[2]) for m in mem)
    print(f"(i)3 mixtral-8x7b worker, {cfg.n_layers} layers int8: ready in "
          f"{t_ready:.1f} s; device memory at ready {mem[0][0]} GiB "
          f"(peak {mem[0][1]}), at stop {mem[1][0]} GiB (peak {mem[1][1]} "
          f"GiB, {peak} bytes) against estimate_model_bytes {est} bytes "
          f"({est / 2**30:.2f} GiB; with each layer's whole draw alive at "
          f"once the worker peaked at 52.50 GiB); "
          f"{card}", flush=True)
    if peak > est:
        fail(f"(i)3: the worker's peak allocation {peak} bytes exceeds "
             f"estimate_model_bytes {est}")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    qp = init_decoder_params(torch.Generator("cuda").manual_seed(SEED), cfg,
                             quantize="int8")
    torch.cuda.synchronize()
    # A completion ends early only at the tokenizer's end token.
    if any(not out or len(out) > MOE_NEW for out in outs):
        fail(f"(i)3: completions gave {list(map(len, outs))} tokens")
    moe_token_check(qp, cfg, [tok.encode(text(n, salt))
                              for n, salt in MOE_WORKER_PROMPTS], outs,
                    [spec.chunked_prefill_tokens] * len(outs), "(i)3 worker")
    print(f"(i)3 in process: the same seed's int8 weights "
          f"({packed_param_bytes(qp) / 1e9:.3f} GB, packed per layer in "
          f"{time.perf_counter() - t1:.1f} s), {sum(map(len, outs))} worker "
          f"tokens held to both plain forwards; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    step = _decode_step_ms(qp, cfg, torch.Generator().manual_seed(SEED + 53))
    print(f"(i)3 one dense decode step of the 32-layer int8 model (8 slots "
          f"at 1024, paged): enqueue {step[0]:.2f} wall {step[1]:.2f} device "
          f"{step[2]:.2f} ms (whole dequantized expert stacks, before the "
          f"one-at-a-time dequant: enqueue 164.69, device 233.84 ms); "
          f"{card}", flush=True)
    del qp
    gc.collect()
    torch.cuda.empty_cache()


def _decode_step_ms(params, cfg, gen) -> tuple[float, float, float]:
    """(enqueue, wall, device) ms of one paged decode step over ``params``
    (8 slots at position 1024 of a random bf16 pool, the paged-decode
    kernel; an MoE model on its serving decode path, dense)."""
    import dataclasses

    from kubeflow_tpu_torch.serve.paged import _paged_decode_step

    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_impl="dense")
    b, pg, mpp = 8, 128, 16
    shape = (cfg.n_layers, b * mpp + 1, pg, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: torch.randn(shape, generator=gen).to(
        device="cuda", dtype=torch.bfloat16) for n in ("k", "v")}
    pool["table"] = torch.arange(b * mpp, dtype=torch.int32,
                                 device="cuda").reshape(b, mpp)
    tokens = torch.randint(3, cfg.vocab_size, (b,), generator=gen).to("cuda")
    lengths = torch.full((b,), 1024, device="cuda")
    live = torch.ones((b,), dtype=torch.bool, device="cuda")
    with torch.no_grad():
        return _timed_step(lambda: _paged_decode_step(
            params, pool, tokens, lengths, live, cfg, attn_impl="pallas"))


def moe_llama_int8(rows: list[dict], card: str) -> None:
    """(i)4: Llama-3-8B, 32 layers, int8 weights on the page pool: greedy
    tokens the plain int8 forward's argmax or a near tie; packed bytes
    against bf16; one paged decode step's device and enqueue ms with int8
    weights beside bf16's, in this run."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import init_decoder_params
    from kubeflow_tpu_torch.ops.quantization import (
        packed_param_bytes, packed_param_bytes_estimate, quantize_params_int8,
    )
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    cfg = preset("llama3-8b", param_dtype="bfloat16")
    params = init_decoder_params(torch.Generator("cuda").manual_seed(SEED),
                                 cfg)
    qp = quantize_params_int8(params, cfg)
    full, packed = packed_param_bytes(params), packed_param_bytes(qp)
    if packed != packed_param_bytes_estimate(cfg):
        fail("(i)4: packed bytes differ from the estimate")
    gen = torch.Generator().manual_seed(SEED + 52)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (200, 200, 200, 200)]
    wrappers = _moe_wrappers()
    eng = LLMEngine(cfg, BatchingSpec(**MOE_SPEC), params=qp, device="cuda")
    outs, launches = _moe_run(eng, prompts, wrappers)
    departs, fp32_only = int8_reference(eng, prompts, outs,
                                        "(i)4 llama int8")
    for n in ("rmsnorm_fwd", "add_rmsnorm_fwd", "swiglu_fwd", "paged_decode"):
        if launches[n] <= 0:
            fail(f"(i)4: {n} never launched")
    for n in ("rmsnorm_fwd", "add_rmsnorm_fwd", "swiglu_fwd"):
        _add_launches(rows, n, launches[n])
    _add_launches(rows, "paged_decode", launches["paged_decode"])
    eng._allocator.assert_quiescent()
    del eng
    steps = {name: _decode_step_ms(p, cfg, gen)
             for name, p in (("bf16", params), ("int8", qp))}
    print(f"(i)4 llama3-8b int8 weights, paged: {sum(map(len, outs))} tokens, "
          f"{departs} depart from the plain bf16 forward's argmax, each a "
          f"near tie of it or ({fp32_only} of them) of the plain fp32 "
          f"forward's; "
          f"launches {json.dumps(launches)}; packed {packed / 1e9:.3f} GB "
          f"against bf16 {full / 1e9:.3f} GB; one decode step (8 slots at "
          f"1024): int8 enqueue {steps['int8'][0]:.2f} wall "
          f"{steps['int8'][1]:.2f} device {steps['int8'][2]:.2f} ms, bf16 "
          f"enqueue {steps['bf16'][0]:.2f} wall {steps['bf16'][1]:.2f} device "
          f"{steps['bf16'][2]:.2f} ms; {card}", flush=True)
    del params, qp
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(rows: list[dict], card: str) -> None:
    """(i): MoE serving and int8 weights — the block, Mixtral at 8 layers,
    the 32-layer int8 Mixtral worker, and int8 Llama-3-8B."""
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("moe block", moe_block_check, card)
    timed_phase("moe 8 layers", moe_eight_layers, rows, card)
    timed_phase("moe worker", moe_worker, card)
    timed_phase("moe llama int8", moe_llama_int8, rows, card)


TRAIN_MODEL = dict(n_layers=4, remat_policy="nothing_saveable")
#: The crash-and-resume pair and the ``file://`` serve of its checkpoint run
#: at 2 layers: a step's checkpoint (params and Adam state) is 17.84 GB
#: there against 23.08 GB at 4 (the embedding and head hold 12.6 GB).
TRAIN_RESUME_MODEL = dict(TRAIN_MODEL, n_layers=2)
TRAIN_DATA = dict(seq_len=2048, global_batch=2)


def _train_wrappers() -> dict:
    """The launch counters of the training path: the flash kernels, and
    with fused kernels on the norm, SwiGLU and CE kernels."""
    from kubeflow_tpu_torch.ops import flash_attention as FA
    from kubeflow_tpu_torch.ops import fused_norm as fn
    from kubeflow_tpu_torch.ops import fused_xent as fx

    return {"flash_fwd": FA.flash_attention,
            "flash_bwd_dkdv": FA.flash_bwd_dkdv,
            "flash_bwd_dq": FA.flash_bwd_dq,
            "rmsnorm_fwd": fn.rmsnorm_fused,
            "add_rmsnorm_fwd": fn.add_rmsnorm_fused,
            "swiglu_fwd": fn.swiglu_fused,
            "rmsnorm_bwd": fn.rmsnorm_bwd,
            "swiglu_bwd": fn.swiglu_bwd,
            "fused_xent_fwd": fx.xent_fwd,
            "fused_xent_bwd_dh": fx.dh_kernel,
            "fused_xent_bwd_dw": fx.dw_kernel}


def _want_per_step(fused: bool, n_layers: int, moe: bool = False,
                   policy: str = "nothing_saveable") -> dict:
    """Launches per training step, derived from the code: under every remat
    policy but ``"none"`` a layer's forward kernels launch twice (the
    forward and the backward's replay, which must reach the down
    projection: it saves the SwiGLU output; an MoE block's replay must
    reach its balance loss, the block's last product; ``block_outs``
    replays each of its three stages, and each holds one of the kernels);
    a selective policy keeps the products' outputs but replays the
    kernels, and ``dots_flash`` also keeps the flash forward's ``(o,
    lse)``, so that kernel launches once. The final norm and the CE run
    once, outside the layers. Backward: one RMSNorm backward per norm (ln1,
    the residual ln2, the final norm), one SwiGLU, dK/dV and dQ per layer,
    one CE backward (its d_hidden and d_head kernels) per step. MoE experts
    run the plain activation, as the JAX experts do: no SwiGLU kernel."""
    L = n_layers
    fwd = L if policy == "none" else 2 * L
    want = {"flash_fwd": L if policy in ("none", "dots_flash") else 2 * L,
            "flash_bwd_dkdv": L, "flash_bwd_dq": L}
    fused_counts = {"rmsnorm_fwd": fwd + 1, "add_rmsnorm_fwd": fwd,
                    "swiglu_fwd": 0 if moe else fwd,
                    "rmsnorm_bwd": 2 * L + 1, "swiglu_bwd": 0 if moe else L,
                    "fused_xent_fwd": 1, "fused_xent_bwd_dh": 1,
                    "fused_xent_bwd_dw": 1}
    for k, v in fused_counts.items():
        want[k] = v if fused else 0
    return want


def phase_train_check() -> None:
    """Kernel paths vs the plain path on the training slice: Llama-3-8B
    widths, 4 layers, fp32 params from a seed, one synthetic 2 x 2048
    batch; one ``decoder_loss`` forward and backward three ways: plain
    (``fused_kernels="off"``, ``attn_impl="xla"``), the flash kernels
    alone (``"off"``, ``"pallas"``), and every kernel (``"on"``,
    ``"pallas"``). Loss and gradients are held against the plain run's:
    layer-0 wq/wk/wv and the embedding for the flash kernels; those and
    layer-0 ln1, ln2, mlp gate and up, the final norm and the head for
    every kernel. Then three steps of the preset configuration
    (``fused_kernels="auto"``: on) on that batch, repeated, must lower the
    loss."""
    import dataclasses

    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import decoder_loss
    from kubeflow_tpu_torch.train.data import DataConfig, SyntheticLM
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.step import setup_train

    cfg = preset("llama3-8b", **TRAIN_MODEL)
    task = setup_train(cfg, OptimizerConfig(warmup_steps=0, total_steps=10),
                       device="cuda", seed=SEED, attn_impl="pallas")
    batch = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seed=SEED, **TRAIN_DATA)).batch_at(0))
    batch = batch.to("cuda")
    p = task.state["params"]
    lay = p["layers"]
    leaves = {"wq[0]": lay["attn"]["wq"], "wk[0]": lay["attn"]["wk"],
              "wv[0]": lay["attn"]["wv"], "embed": p["embed"],
              "ln1[0]": lay["ln1"], "ln2[0]": lay["ln2"],
              "gate[0]": lay["mlp"]["gate"], "up[0]": lay["mlp"]["up"],
              "final_norm": p["final_norm"], "lm_head": p["lm_head"]}
    stacked = {"wq[0]", "wk[0]", "wv[0]", "ln1[0]", "ln2[0]", "gate[0]",
               "up[0]"}
    flash_leaves = ("wq[0]", "wk[0]", "wv[0]", "embed")

    def run(fused: str, impl: str):
        loss, _ = decoder_loss(p, batch, dataclasses.replace(
            cfg, fused_kernels=fused), attn_impl=impl)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), {n: (g[0] if n in stacked else g)
                             for n, g in zip(leaves, grads)}

    lp, gp = run("off", "xla")
    for label, fused, names in (("flash kernels", "off", flash_leaves),
                                ("every kernel", "on", tuple(leaves))):
        lk, gk = run(fused, "pallas")
        loss_rel = abs(lk - lp) / abs(lp)
        rels = {n: rel_l2(gk[n], gp[n]) for n in names}
        print(f"train check ({label}, fused_kernels={fused!r}, "
              f"attn_impl='pallas'): loss {lk:.6f} vs plain {lp:.6f} (rel "
              f"{loss_rel:.3e}, tolerance {TRAIN_LOSS_REL:g}); grad rel L2 "
              + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
              + f" (tolerance {TRAIN_GRAD_REL_L2:g})", flush=True)
        if not loss_rel <= TRAIN_LOSS_REL:
            fail(f"training loss through the {label} disagrees with the "
                 "plain path")
        bad = [n for n, r in rels.items() if not r <= TRAIN_GRAD_REL_L2]
        if bad:
            fail(f"training gradients through the {label} disagree: {bad}")
        del gk
    del gp
    losses = []
    for _ in range(3):
        _, m = task.step_fn(task.state, batch)
        losses.append(float(m["loss"]))
    print(f"train check: a repeated batch over 3 steps (fused_kernels "
          f"{cfg.fused_kernels!r}): losses {[round(x, 4) for x in losses]}",
          flush=True)
    if not losses[-1] < losses[0]:
        fail("three steps on a repeated batch did not lower the loss")
    del task, p, lay, leaves
    gc.collect()
    torch.cuda.empty_cache()


class _Crash(Exception):
    """Ends a training run right after its step-3 checkpoint."""


def _trainer_cfg(ckpt_dir=None, steps: int = 6, name: str = "llama3-8b",
                 base: dict = TRAIN_MODEL, data: dict = TRAIN_DATA, **model):
    from kubeflow_tpu_torch.train.trainer import TrainerConfig

    return TrainerConfig(
        model=name, model_overrides={**base, **model},
        data=dict(data), steps=steps, log_every=1, seed=SEED,
        attn_impl="pallas",
        optimizer={"learning_rate": 3e-4, "warmup_steps": 2,
                   "clip_norm": 1.0},
        checkpoint_dir=ckpt_dir, checkpoint_every=3 if ckpt_dir else 0,
        max_checkpoints=1)


def _train_run(cfg, workdir: str, crash_at=None,
               keep_params: bool = False) -> tuple[dict, float]:
    """One ``Trainer.run()``; returns ({step: metrics}, seconds). A
    ``crash_at`` step raises after that step (and its checkpoint, if it
    takes one). The last step's entry also holds ``opt_state``: the
    optimizer count and the layer-0 wq Adam moments, on the host; with
    ``keep_params``, ``params16``: the params cast to bf16 in memory, on
    the card. ``seen["save"]`` holds the interval tier's last save's times
    (``CheckpointManager.last_save``), where it saved, and
    ``seen["crash"]`` the crash's time."""
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.trainer import Trainer

    seen: dict = {}

    def on_step(step, metrics):
        seen[step] = dict(metrics)
        if step == cfg.steps:
            opt = trainer.task.state["opt_state"]
            seen[step]["opt_state"] = {
                "count": int(opt["count"]),
                **{k: opt[k]["layers"]["attn"]["wq"][0].float().cpu()
                   for k in ("mu", "nu")}}
            if keep_params:
                seen[step]["params16"] = T.map_tree(
                    lambda t: t.detach().to(torch.bfloat16),
                    trainer.task.state["params"])
        if step == crash_at:
            seen["crash"] = time.perf_counter()
            raise _Crash()

    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda", workdir=workdir)
    try:
        trainer.run(on_step=on_step)
    except _Crash:
        pass
    finally:
        if trainer.ckpt is not None and trainer.ckpt.last_save:
            seen["save"] = dict(trainer.ckpt.last_save)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return seen, time.perf_counter() - t0


def _counted_run(cfg, workdir: str, label: str) -> dict:
    """``_train_run`` with every training kernel's count set to 0 just
    before and read just after; checks finite losses, the steps taken and
    the per-step launches derived by ``_want_per_step``. Returns the
    metrics by step and the launches."""
    from kubeflow_tpu_torch.models.config import preset

    wrappers = _train_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    seen, secs = _train_run(cfg, workdir)
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for step, m in sorted(seen.items()):
        print(f"{label} step {step}: loss {m['loss']:.6f} aux_loss "
              f"{m['aux_loss']:.6f} grad_norm "
              f"{m['grad_norm']:.4f} step_time_ms "
              f"{m.get('step_time_ms', float('nan')):.1f} tokens/s "
              f"{m.get('tokens_per_sec', float('nan')):.0f} mfu "
              f"{m.get('mfu', float('nan')):.4f}", flush=True)
    print(f"{label}: {cfg.steps} steps in {secs:.1f} s (init included), "
          f"peak {peak / 2**30:.2f} GiB allocated; kernels "
          + json.dumps(launches), flush=True)
    if sorted(seen) != list(range(1, cfg.steps + 1)):
        fail(f"{label}: steps {sorted(seen)} reported, not 1..{cfg.steps}")
    for step, m in seen.items():
        if not all(math.isfinite(m[k])
                   for k in ("loss", "grad_norm", "aux_loss")):
            fail(f"{label} step {step}: non-finite loss, grad norm or aux "
                 f"loss {m}")
    mcfg = preset(cfg.model, **cfg.model_overrides)
    fused = mcfg.fused_kernels in ("on", "auto")      # auto: on, on a card
    want = {n: c * cfg.steps for n, c in _want_per_step(
        fused, mcfg.n_layers, mcfg.is_moe).items()}
    if launches != want:
        fail(f"{label}: kernel launches {launches}, expected {want}")
    return {"steps": seen, "launches": launches, "peak": peak}


def save_line(times: dict) -> str:
    """A ``CheckpointManager.last_save`` as seconds: to the snapshot (what
    training waited), to the commit, and the part of the write that
    overlapped training (until the commit, or until training stopped to
    wait for it)."""
    if "committed" not in times:
        return f"step {times.get('step')}'s save did not commit"
    t0 = times["called"]
    end = min(times["committed"], times.get("waited", times["committed"]))
    return (f"step {times['step']}'s save: snapshot {times['returned'] - t0:.2f}"
            f" s, committed after {times['committed'] - t0:.2f} s, "
            f"{end - times['returned']:.2f} s of it overlapped training")


def phase_train(rows: list[dict]) -> None:
    """The training slice through its entry point, ``Trainer.run()``: the
    preset configuration (``fused_kernels="auto"``, every kernel) for 6
    steps; at ``TRAIN_RESUME_MODEL``'s depth 6 uninterrupted steps, then
    steps 1–5 with the step-3 checkpoint written while steps 4 and 5 run,
    a crash, and a resume from step 3, held to them; then 2
    steps with ``fused_kernels="off"`` (the flash kernels, chunked CE)."""
    import tempfile

    # Under the checkout (git-ignored), not $TMPDIR: a step-3 checkpoint of
    # the resumed model is 17.84 GB, more than a small temporary filesystem
    # holds.
    work = tempfile.mkdtemp(prefix=".chip_smoke_train_",
                            dir=Path(__file__).resolve().parent)
    try:
        for sub in ("whole", "whole2", "resume", "off"):
            os.makedirs(os.path.join(work, sub))
        run = _counted_run(_trainer_cfg(), os.path.join(work, "whole"),
                           "train")
        launches = run["launches"]
        for r in rows:
            if r["name"] in ("flash_bwd_dkdv", "flash_bwd_dq", "rmsnorm_bwd",
                             "swiglu_bwd", "fused_xent_fwd",
                             "fused_xent_bwd_dh", "fused_xent_bwd_dw"):
                r["launches"] = launches[r["name"]]

        short = _train_run(_trainer_cfg(base=TRAIN_RESUME_MODEL),
                           os.path.join(work, "whole2"))[0]
        ckpt = os.path.join(work, "ckpt")
        resume_dir = os.path.join(work, "resume")
        first, secs_a = _train_run(_trainer_cfg(ckpt, base=TRAIN_RESUME_MODEL),
                                   resume_dir, crash_at=5)
        save_a, crash = first.pop("save", {}), first.pop("crash")
        saved = sorted(os.listdir(ckpt))
        size = sum(os.path.getsize(os.path.join(ckpt, "3", f))
                   for f in os.listdir(os.path.join(ckpt, "3")))
        print(f"train resume ({TRAIN_RESUME_MODEL['n_layers']} layers): "
              f"first run took steps {sorted(first)} and stopped after step "
              f"5 in {secs_a:.1f} s; checkpoint dir {saved}, step 3 holds "
              f"{size / 1e9:.2f} GB; " + save_line(save_a), flush=True)
        if sorted(first) != [1, 2, 3, 4, 5] or save_a.get("step") != 3:
            fail(f"train resume: the first run took steps {sorted(first)} "
                 f"and saved {save_a}")
        if not save_a.get("committed", 0) > crash:
            fail("train resume: the step-3 save was not in flight while "
                 "steps 4 and 5 ran")
        resumed, secs_b = _train_run(
            _trainer_cfg(ckpt, base=TRAIN_RESUME_MODEL), resume_dir,
            keep_params=True)
        save_b = resumed.pop("save", {})
        print(f"train resume: second run resumed and took steps "
              f"{sorted(resumed)} in {secs_b:.1f} s; " + save_line(save_b),
              flush=True)
        if sorted(resumed) != [4, 5, 6]:
            fail(f"train resume: the second run took steps {sorted(resumed)}")
        a, b = short[6]["loss"], resumed[6]["loss"]
        rel = abs(a - b) / abs(a)
        print(f"train resume: step-6 loss uninterrupted {a:.6f}, resumed "
              f"{b:.6f}, rel {rel:.3e} (tolerance {RESUME_LOSS_REL:g})",
              flush=True)
        if not rel <= RESUME_LOSS_REL:
            fail("train resume: the resumed run diverged")
        sa, sb = short[6].pop("opt_state"), resumed[6].pop("opt_state")
        moments = {k: rel_l2(sb[k], sa[k]) for k in ("mu", "nu")}
        print(f"train resume: step-6 optimizer count uninterrupted "
              f"{sa['count']}, resumed {sb['count']}; layer-0 wq moments rel "
              f"L2 mu {moments['mu']:.3e}, nu {moments['nu']:.3e} (tolerance "
              f"{RESUME_MOMENT_REL_L2:g})", flush=True)
        if sa["count"] != sb["count"]:
            fail("train resume: the optimizer count was not restored")
        if not all(r <= RESUME_MOMENT_REL_L2 for r in moments.values()):
            fail("train resume: the Adam moments were not restored")
        params16 = resumed[6].pop("params16")
        for step, m in {**first, **resumed}.items():
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                fail(f"train resume step {step}: non-finite {m}")
        timed_phase("file:// serve", phase_file_params, ckpt, params16)
        del params16
        shutil.rmtree(ckpt, ignore_errors=True)
        _counted_run(_trainer_cfg(steps=2, fused_kernels="off"),
                     os.path.join(work, "off"), "train fused_kernels='off'")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_file_params(ckpt: str, params16: dict) -> None:
    """(d) ``load_params("file://...")`` of the resumed run's step-6
    checkpoint into the 2-layer preset with bf16 params: the same bits as
    the trainer's params cast to bf16 in memory, and the same greedy tokens
    from an engine on each (three prompts: a 128-bucket, a 512-bucket and a
    chunked one). An empty directory must raise ``FileNotFoundError``."""
    import tempfile

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serve.storage import load_params
    from kubeflow_tpu_torch.train import tree as T

    cfg = preset("llama3-8b", n_layers=TRAIN_RESUME_MODEL["n_layers"],
                 param_dtype="bfloat16")
    t0 = time.perf_counter()
    loaded = load_params(f"file://{ckpt}", cfg, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    fl, fm = T.flatten(loaded), T.flatten(params16)
    same = list(fl) == list(fm) and all(
        fl[k].dtype == fm[k].dtype and torch.equal(fl[k], fm[k]) for k in fl)
    spec = dict(max_batch_size=8, max_seq_len=2048, prefill_attn_impl="pallas",
                chunked_prefill_tokens=1024)
    tok = TokenIdText()
    prompts = [tok.encode(text(n, salt))
               for n, salt in ((90, 71), (400, 72), (1200, 73))]
    outs = {}
    for label, params in (("file://", loaded), ("in memory", params16)):
        eng = LLMEngine(cfg, BatchingSpec(**spec), params=params,
                        device="cuda")
        outs[label] = [eng.generate(p, SamplingParams(max_new_tokens=16))
                       for p in prompts]
        del eng
        torch.cuda.empty_cache()
    print(f"file:// serve: step-6 params loaded in {t_load:.1f} s "
          f"({sum(t.numel() for t in fl.values()) / 1e9:.3f} B bf16), "
          f"{'the same bits as' if same else 'NOT the same bits as'} the "
          f"trainer's params cast in memory; greedy tokens "
          f"{'identical' if outs['file://'] == outs['in memory'] else 'DIFFER'}"
          f": {outs['file://']}", flush=True)
    if not same:
        fail("file:// serve: the loaded params differ from the trainer's")
    if outs["file://"] != outs["in memory"]:
        fail("file:// serve: greedy tokens differ from the in-memory params'")
    with tempfile.TemporaryDirectory() as empty:
        try:
            load_params(f"file://{empty}", cfg, device="cuda")
        except FileNotFoundError as exc:
            print(f"file:// serve: an empty directory raises "
                  f"FileNotFoundError: {exc}", flush=True)
        else:
            fail("file:// serve: an empty directory gave params")
    del loaded
    torch.cuda.empty_cache()


def phase_train_profile(fused: str) -> None:
    """One training step (after two warm ones) at the train phase's
    configuration with ``fused_kernels=fused``: host enqueue, wall and
    device ms, the kernels that take the device time, tokens/s and MFU
    against the card's bf16 peak, and the peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.train.data import DataConfig, SyntheticLM
    from kubeflow_tpu_torch.train.metrics import bf16_peak_flops
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.step import setup_train

    cfg = preset("llama3-8b", **TRAIN_MODEL, fused_kernels=fused)
    task = setup_train(cfg, OptimizerConfig(), device="cuda", seed=SEED,
                       attn_impl="pallas")
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seed=SEED,
                                 **TRAIN_DATA))
    batches = [torch.from_numpy(src.batch_at(i)).to("cuda") for i in range(4)]
    for b in batches[:2]:
        task.step_fn(task.state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task.step_fn(task.state, batches[2])
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        task.step_fn(task.state, batches[3])
        torch.cuda.synchronize()
    total, kernels = _kernel_times(prof)
    tokens = TRAIN_DATA["global_batch"] * TRAIN_DATA["seq_len"]
    tps = tokens / t_wall
    peak = bf16_peak_flops(torch.cuda.get_device_name(0))
    mfu = (f"{cfg.flops_per_token() * tps / peak:.4f}" if peak
           else "not measured (unknown card)")
    dev_ms = f"{total:.2f} ms" if total else "not measured"
    print(f"profile train step fused_kernels={fused!r} (llama3-8b widths, "
          f"{cfg.n_layers} layers, {TRAIN_DATA['global_batch']} x "
          f"{TRAIN_DATA['seq_len']} tokens): host enqueue "
          f"{t_enq * 1e3:.2f} ms, wall {t_wall * 1e3:.2f} ms, device "
          f"{dev_ms}, {tps:.0f} tokens/s, MFU {mfu}, peak "
          f"{peak_mem / 2**30:.2f} GiB allocated", flush=True)
    # The ten largest, and the flash and CE kernels wherever they rank.
    for rank, (key, ms, count) in enumerate(kernels):
        if rank < 10 or "flash" in key or "xent" in key:
            print(f"  {ms:8.3f} ms  {count:4d}x  {key[:90]}", flush=True)
    del task, batches
    gc.collect()
    torch.cuda.empty_cache()


#: (k): 3 steps under each remat policy; the step-1 and step-3 losses and
#: the step-1 grad norm against ``"none"``'s, relative. The policies change
#: what is kept, not what is computed: the same kernels on the same inputs.
REMAT_STEPS = 3
REMAT_LOSS_REL = 1e-5
REMAT_GRAD_NORM_REL = 1e-4


def remat_run(policy: str, tokens: str, workdir: str) -> dict:
    """(k): ``Trainer.run()`` for ``REMAT_STEPS`` steps under ``policy`` on
    the grain source over ``tokens``: its metrics by step, the training
    kernels' launches, the peak allocation, the state's bytes (params and
    Adam moments), the bytes one more forward keeps for its backward, one
    more step's host enqueue and wall ms, and the device ms of one more,
    profiled."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.decoder import decoder_loss
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.trainer import Trainer

    cfg = _trainer_cfg(steps=REMAT_STEPS, remat_policy=policy,
                       data=dict(TRAIN_DATA, kind="grain", path=tokens))
    wrappers = _train_wrappers()
    out: dict = {"steps": {}}
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0

    def on_step(step, metrics):
        out["steps"][step] = dict(metrics)
        if step < REMAT_STEPS:
            return
        out["launches"] = {n: w.launches for n, w in wrappers.items()}
        out["peak"] = torch.cuda.max_memory_allocated()
        out["state"] = sum(t.numel() * t.element_size()
                           for t in T.leaves(trainer.task.state)
                           if isinstance(t, torch.Tensor))
        batch = torch.from_numpy(trainer.data.batch_at(0)).to("cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loss, _ = decoder_loss(trainer.task.params, batch, trainer.model_cfg,
                               attn_impl="pallas")
        out["kept"] = torch.cuda.memory_allocated() - base
        del loss
        # One more step, timed to its return (the host's enqueue) and to
        # a synchronisation.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.task.step_fn(trainer.task.state, batch)
        out["enqueue_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.task.step_fn(trainer.task.state, batch)
            torch.cuda.synchronize()
        out["device_ms"] = _kernel_times(prof)[0]

    trainer = Trainer(cfg, device="cuda", workdir=workdir)
    try:
        trainer.run(on_step=on_step)
    finally:
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_remat(rows: list[dict], card: str) -> None:
    """(k): the seven remat policies through ``Trainer.run()`` at the train
    phase's configuration, each against ``"none"``: losses and grad norm,
    launches per step derived by ``_want_per_step``, memory and speed."""
    import tempfile

    import numpy as np

    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import REMAT_POLICIES

    work = tempfile.mkdtemp(prefix=".chip_smoke_train_",
                            dir=Path(__file__).resolve().parent)
    try:
        tokens = os.path.join(work, "tokens.npy")
        mcfg = preset("llama3-8b", **TRAIN_MODEL)
        n = 4 * REMAT_STEPS * TRAIN_DATA["global_batch"] * (
            TRAIN_DATA["seq_len"] + 1)
        np.save(tokens, np.random.default_rng(SEED).integers(
            0, mcfg.vocab_size, n).astype(np.int32))
        runs = {}
        for policy in REMAT_POLICIES:
            os.makedirs(os.path.join(work, policy))
            runs[policy] = remat_run(policy, tokens,
                                     os.path.join(work, policy))
        ref = runs["none"]["steps"]
        base_kept = runs["nothing_saveable"]["kept"]
        for policy, r in runs.items():
            st = r["steps"]
            if sorted(st) != list(range(1, REMAT_STEPS + 1)):
                fail(f"(k) {policy}: steps {sorted(st)}")
            rel = {f"loss{s}": abs(st[s]["loss"] - ref[s]["loss"])
                   / abs(ref[s]["loss"]) for s in (1, REMAT_STEPS)}
            rel["grad_norm1"] = (abs(st[1]["grad_norm"] - ref[1]["grad_norm"])
                                 / abs(ref[1]["grad_norm"]))
            want = {k: v * REMAT_STEPS for k, v in _want_per_step(
                True, mcfg.n_layers, False, policy).items()}
            last = st[REMAT_STEPS]
            print(f"(k) remat {policy}: loss step 1 {st[1]['loss']:.6f}, "
                  f"step {REMAT_STEPS} {last['loss']:.6f}, grad norm step 1 "
                  f"{st[1]['grad_norm']:.6f}; against none: "
                  + ", ".join(f"{k} rel {v:.3e}" for k, v in rel.items())
                  + f" (tolerance {REMAT_LOSS_REL:g} / "
                  f"{REMAT_GRAD_NORM_REL:g}); flash_fwd "
                  f"{r['launches']['flash_fwd'] // REMAT_STEPS} a step; "
                  f"one forward keeps {r['kept'] / 2**30:.3f} GiB "
                  f"({(r['kept'] - base_kept) / 2**20:+.1f} MiB against "
                  f"nothing_saveable); peak {r['peak'] / 2**30:.2f} GiB, "
                  f"{(r['peak'] - r['state']) / 2**30:.2f} GiB past the "
                  f"params and Adam state ({r['state'] / 2**30:.2f} GiB); "
                  f"step {last['step_time_ms']:.1f} ms (one more: enqueue "
                  f"{r['enqueue_ms']:.1f}, wall {r['wall_ms']:.1f} ms; one "
                  f"profiled: device {r['device_ms']:.1f} ms), "
                  f"{last['tokens_per_sec']:.0f} tokens/s, MFU "
                  f"{last.get('mfu', float('nan')):.4f}; {card}", flush=True)
            if not (rel["loss1"] <= REMAT_LOSS_REL
                    and rel[f"loss{REMAT_STEPS}"] <= REMAT_LOSS_REL
                    and rel["grad_norm1"] <= REMAT_GRAD_NORM_REL):
                fail(f"(k) {policy}: losses or grad norm differ from none's: "
                     f"{rel}")
            if r["launches"] != want:
                fail(f"(k) {policy}: kernel launches {r['launches']}, "
                     f"expected {want}")
            for name, count in r["launches"].items():
                _add_launches(rows, name, count)
    finally:
        shutil.rmtree(work, ignore_errors=True)


#: (j): MoE training at Mixtral width (hidden 4096, 32/8 heads, 8 experts
#: of MLP 14336, top 2, vocab 32000), fp32 params and Adam, bf16
#: activations. The depth is cut to what one card holds with Adam: 2 layers
#: are 3.17 B parameters, 50.7 GB at 16 B each (3 layers need 73.9 GB).
TRAIN_MOE_MODEL = dict(n_layers=2, remat_policy="nothing_saveable")
#: (j)1: dispatch vs dense gradients of one block, rel L2 per leaf (bf16
#: activations, fp32 weights).
MOE_GRAD_REL_L2 = 1e-2
#: (j)2: each layer's balance loss at a near-uniform router lies near k.
MOE_AUX_PER_LAYER = (0.9, 1.5)       # times k
#: (j)4: a vision worker's first bf16 loss against the fp32 evaluation of
#: the same init and batch, relative.
VISION_LOSS_REL = 1e-2
VISION_JOBS = (("vit", "vit-l16"), ("clip", "clip-l14"))
VISION_STEPS, VISION_BATCH = 4, 8


def moe_train_block(card: str) -> None:
    """(j)1: one MoE block at Mixtral width, fp32 weights from a seed, bf16
    activations, B = 1, T = 2048, loss ``sum(out²) + 0.01·aux`` (the JAX
    package's own dispatch-vs-dense gradient check): the zero-drop dispatch
    (capacity factor E) against the dense path, rel L2 per gradient leaf
    (router, gate, up, down, x); forward and backward ms of the dispatch at
    the model's factor 1.25 and of the dense path."""
    import dataclasses

    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import preset

    cfg = preset("mixtral-8x7b")
    e = cfg.num_experts
    gen = torch.Generator("cuda").manual_seed(SEED + 60)
    p = L.init_moe(gen, cfg)
    x = torch.randn((1, MOE_BLOCK_T, cfg.hidden), generator=gen,
                    device="cuda").to(torch.bfloat16)
    names = ("router", "gate", "up", "down")

    def loss_of(c):
        leaves = {n: p[n].detach().requires_grad_(True) for n in names}
        xx = x.detach().requires_grad_(True)
        out, aux = L.moe_block(leaves, xx, c)
        return (out.float() ** 2).sum() + 0.01 * aux, \
            [leaves[n] for n in names] + [xx]

    grads = {}
    for label, c in (("zero-drop", dataclasses.replace(
            cfg, capacity_factor=float(e))),
            ("dense", dataclasses.replace(cfg, moe_impl="dense"))):
        loss, leaves = loss_of(c)
        grads[label] = dict(zip(names + ("x",),
                                torch.autograd.grad(loss, leaves)))
        del loss, leaves
    rels = {n: rel_l2(grads["zero-drop"][n], grads["dense"][n])
            for n in names + ("x",)}
    print(f"(j)1 MoE block backward (Mixtral width, fp32 weights, bf16 "
          f"activations, T={MOE_BLOCK_T}): zero-drop dispatch vs dense "
          f"gradient rel L2 " + ", ".join(f"{n} {r:.3e}"
                                          for n, r in rels.items())
          + f" (tolerance {MOE_GRAD_REL_L2:g})", flush=True)
    bad = [n for n, r in rels.items() if not r <= MOE_GRAD_REL_L2]
    if bad:
        fail(f"(j)1: dispatch gradients disagree with dense: {bad}")
    del grads
    times = {}
    for label, c in (("dispatch", cfg),
                     ("dense", dataclasses.replace(cfg, moe_impl="dense"))):
        fwd = event_ms(lambda c=c: loss_of(c))
        loss, leaves = loss_of(c)
        bwd = event_ms(lambda: torch.autograd.grad(loss, leaves,
                                                   retain_graph=True))
        times[label] = (fwd, bwd)
        del loss, leaves
    print("(j)1 MoE block T=2048 forward / backward (CUDA events): "
          + "; ".join(f"{k} {f:.3f} / {b:.3f} ms" for k, (f, b)
                      in times.items())
          + f" (dispatch at capacity factor {cfg.capacity_factor}); {card}",
          flush=True)
    del p, x
    gc.collect()
    torch.cuda.empty_cache()


def moe_train_steps(rows: list[dict], card: str) -> None:
    """(j)2: ``Trainer.run()`` at Mixtral width, 2 layers (fp32 params,
    AdamW, ``fused_kernels="auto"``, ``attn_impl="pallas"``,
    ``nothing_saveable`` remat, synthetic 2 x 2048 batches), 6 steps: loss,
    grad norm and ``aux_loss`` finite every step, each layer's balance loss
    near k, rows 1–3 and 6–11 launched at their per-step counts; then 2
    steps with ``fused_kernels="off"`` (flash kernels, the plain CE) whose
    losses track the first two within TRAIN_LOSS_REL."""
    import tempfile

    from kubeflow_tpu_torch.models.config import preset

    mcfg = preset("mixtral-8x7b", **TRAIN_MOE_MODEL)
    k = mcfg.experts_per_token
    work = tempfile.mkdtemp(prefix=".chip_smoke_train_",
                            dir=Path(__file__).resolve().parent)
    try:
        runs = {}
        for fused, steps in (("auto", 6), ("off", 2)):
            label = f"(j)2 mixtral train fused_kernels={fused!r}"
            os.makedirs(os.path.join(work, fused))
            runs[fused] = _counted_run(
                _trainer_cfg(steps=steps, name="mixtral-8x7b",
                             base=TRAIN_MOE_MODEL, fused_kernels=fused),
                os.path.join(work, fused), label)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    on, off = runs["auto"], runs["off"]
    for step, m in on["steps"].items():
        per_layer = m["aux_loss"] / mcfg.n_layers / k
        if not MOE_AUX_PER_LAYER[0] <= per_layer <= MOE_AUX_PER_LAYER[1]:
            fail(f"(j)2 step {step}: aux_loss {m['aux_loss']:.4f} is "
                 f"{per_layer:.3f} k per layer, outside {MOE_AUX_PER_LAYER}")
    rels = [abs(off["steps"][s]["loss"] - on["steps"][s]["loss"])
            / abs(on["steps"][s]["loss"]) for s in (1, 2)]
    last = on["steps"][6]
    billions = mcfg.num_params() / 1e9
    print(f"(j)2 mixtral-8x7b train, {mcfg.n_layers} layers ({billions:.3f} "
          f"B params), 2 x 2048 tokens a step: step "
          f"{last.get('step_time_ms', float('nan')):.1f} ms, "
          f"{last.get('tokens_per_sec', float('nan')):.0f} tokens/s, MFU "
          f"{last.get('mfu', float('nan')):.4f}, peak "
          f"{on['peak'] / 2**30:.2f} GiB allocated; aux_loss "
          f"{[round(m['aux_loss'], 4) for _, m in sorted(on['steps'].items())]}"
          f"; fused off vs on, loss rel at steps 1, 2: "
          f"{rels[0]:.3e}, {rels[1]:.3e} (tolerance {TRAIN_LOSS_REL:g}); "
          f"{card}", flush=True)
    if not all(r <= TRAIN_LOSS_REL for r in rels):
        fail("(j)2: the fused-off steps do not track the fused-on steps")
    for name, n in on["launches"].items():
        _add_launches(rows, name, n)


def run_train_worker(entrypoint: str, config: dict, workdir: str,
                     label: str, timeout: float = 600.0) -> tuple:
    """``python -m kubeflow_tpu_torch.runtime.worker_main`` with
    ``entrypoint`` and ``config`` on the card, to its exit; returns (rows
    of its ``metrics.jsonl``, seconds). Fails unless it exits 0."""
    import tempfile

    from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv

    repo = Path(__file__).resolve().parent
    wenv = WorkerEnv(coordinator_address="127.0.0.1:0", num_processes=1,
                     process_id=0, job=f"default/{label}", replica_index=0,
                     entrypoint=entrypoint, config=config, parallelism={},
                     platform=WORKER_PLATFORM, workdir=workdir)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KFTPU_")}
    env.update(wenv.to_env())
    env["PYTHONPATH"] = str(repo)
    t0 = time.perf_counter()
    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
            cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
            rc = None
        if rc != 0:
            log.seek(0)
            print(f"{label} log (tail):\n"
                  + log.read().decode(errors="replace")[-4000:],
                  file=sys.stderr, flush=True)
            fail(f"{label}: exit code {rc}")
    path = Path(workdir) / "metrics.jsonl"
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    return rows, time.perf_counter() - t0


def moe_train_worker(card: str) -> None:
    """(j)3: ``llm_pretrain`` through ``runtime.worker_main`` at Mixtral
    width and 1 layer (its step-3 checkpoint, params and Adam state, is
    20.56 GB, a 4-layer Llama-3-8B's size): 3 steps, a checkpoint at step 3, exit 0,
    ``metrics.jsonl`` with 3 lines of finite ``loss`` and ``aux_loss``.
    Then a ``model_server`` worker loads the checkpoint's params through
    ``file://`` as bf16 and serves two prompts; its greedy tokens must
    equal an in-process engine's on the same checkpoint."""
    import tempfile

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serve.storage import load_params

    work = tempfile.mkdtemp(prefix=".chip_smoke_train_",
                            dir=Path(__file__).resolve().parent)
    ckpt = os.path.join(work, "ckpt")
    overrides = {"n_layers": 1}
    conf = {"model": "mixtral-8x7b",
            "model_overrides": {**TRAIN_MOE_MODEL, **overrides},
            "data": dict(TRAIN_DATA), "steps": 3, "log_every": 1,
            "seed": SEED, "attn_impl": "pallas",
            "optimizer": {"learning_rate": 3e-4, "warmup_steps": 1},
            "checkpoint_dir": ckpt, "checkpoint_every": 3,
            "max_checkpoints": 1, "emergency_checkpointing": False}
    model = {"preset": "mixtral-8x7b",
             "overrides": {**overrides, "param_dtype": "bfloat16"}}
    batching = dict(max_batch_size=2, max_seq_len=1024,
                    prefill_attn_impl="pallas", weights_dtype="bfloat16")
    tok = TokenIdText()
    texts = [text(90, 95), text(400, 96)]
    try:
        os.makedirs(os.path.join(work, "train"))
        rows, secs = run_train_worker("llm_pretrain", conf,
                                      os.path.join(work, "train"),
                                      "moe pretrain worker", timeout=900)
        size = sum(f.stat().st_size for f in Path(ckpt).rglob("*")
                   if f.is_file())
        print(f"(j)3 llm_pretrain worker (mixtral-8x7b width, 1 layer): exit "
              f"0 in {secs:.1f} s; checkpoint steps {sorted(os.listdir(ckpt))}"
              f" ({size / 1e9:.2f} GB); metrics "
              + "; ".join(f"step {r['step']} loss {r['loss']:.5f} aux_loss "
                          f"{r['aux_loss']:.5f}" for r in rows), flush=True)
        if [r["step"] for r in rows] != [1, 2, 3] or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["aux_loss"])
                for r in rows):
            fail(f"(j)3: metrics.jsonl has {rows}")
        t0 = time.perf_counter()
        proc, url, log = spawn_worker(batching, "moe_file_worker",
                                      model=model, service="mixtral",
                                      storage_uri=f"file://{ckpt}")
        ok = False
        try:
            # The in-process reference loads the same checkpoint while the
            # worker starts.
            cfg = preset(model["preset"], **model["overrides"])
            params = load_params(f"file://{ckpt}", cfg, device="cuda")
            eng = LLMEngine(cfg, BatchingSpec(**batching), params=params,
                            device="cuda")
            want = [eng.generate(tok.encode(b),
                                 SamplingParams(max_new_tokens=16))
                    for b in texts]
            del eng, params
            t_ready = wait_ready(proc, url, "moe file:// worker", t0)
            served = []
            for body in texts:
                raw = _post(url + "/v1/completions",
                            {"prompt": body, "max_tokens": 16})[1]
                served.append([int(x) for x in json.loads(raw)[
                    "choices"][0]["text"].split()])
            sigterm_worker(proc, url, "moe file:// worker")
            ok = True
        finally:
            reap_worker(proc, log, "moe file:// worker", ok)
        print(f"(j)3 model_server worker on the file:// checkpoint (bf16): "
              f"ready in {t_ready:.1f} s; greedy tokens "
              f"{'identical to' if served == want else 'DIFFER from'} the "
              f"in-process engine's: {served}", flush=True)
        if served != want:
            fail(f"(j)3: worker tokens {served} != in-process {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def vision_workers(card: str) -> None:
    """(j)4: ``vision_train`` through ``runtime.worker_main``: ViT-L/16 and
    CLIP-L/14, batch 8, 4 steps each, exit 0 and every ``metrics.jsonl``
    value finite; the first step's bf16 loss within VISION_LOSS_REL of an
    fp32 evaluation in process of the same seeded init and batch; step ms
    of each."""
    import dataclasses
    import tempfile

    from kubeflow_tpu_torch.models import vision as V
    from kubeflow_tpu_torch.train import vision_task as VT

    for family, name in VISION_JOBS:
        with tempfile.TemporaryDirectory() as wd:
            rows, secs = run_train_worker(
                "vision_train", {"family": family, "model": name,
                                 "steps": VISION_STEPS,
                                 "batch": VISION_BATCH}, wd,
                f"vision {name} worker")
        if len(rows) != VISION_STEPS or not all(
                math.isfinite(v) for r in rows for v in r.values()):
            fail(f"(j)4 {name}: metrics {rows}")
        if family == "vit":
            cfg = V.vit_preset(name)
            f32 = dataclasses.replace(cfg, dtype="float32")
            init, loss_fn, batch = (V.init_vit_params, V.vit_loss,
                                    VT.vit_batch(cfg, VISION_BATCH, 0))
        else:
            cfg = V.clip_preset(name)
            f32 = dataclasses.replace(cfg, dtype="float32", image=(
                dataclasses.replace(cfg.image, dtype="float32")))
            init, loss_fn, batch = (V.init_clip_params, V.clip_loss,
                                    VT.clip_batch(cfg, VISION_BATCH, 0))
        params = init(torch.Generator("cuda").manual_seed(0), cfg)
        with torch.no_grad():
            ref, _ = loss_fn(params, {k: torch.from_numpy(v).cuda()
                                      for k, v in batch.items()}, f32)
        ref = float(ref)
        rel = abs(rows[0]["loss"] - ref) / abs(ref)
        del params
        torch.cuda.empty_cache()
        print(f"(j)4 vision_train {name} worker: exit 0 in {secs:.1f} s; "
              f"losses {[round(r['loss'], 5) for r in rows]}; step ms "
              f"{[round(r['step_time_ms'], 1) for r in rows]}; first loss "
              f"{rows[0]['loss']:.6f} vs fp32 in process {ref:.6f} (rel "
              f"{rel:.3e}, tolerance {VISION_LOSS_REL:g}); {card}",
              flush=True)
        if not rel <= VISION_LOSS_REL:
            fail(f"(j)4 {name}: the worker's first loss is off the fp32 one")


def phase_train_moe(rows: list[dict], card: str) -> None:
    """(j): MoE training and the training entry points — the block's
    gradients, Mixtral-width training through ``Trainer.run()``,
    ``llm_pretrain`` and a ``file://`` serve of its checkpoint, and
    ``vision_train``."""
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("train moe block", moe_train_block, card)
    timed_phase("train moe steps", moe_train_steps, rows, card)
    timed_phase("train moe worker", moe_train_worker, card)
    timed_phase("vision workers", vision_workers, card)


# -- (l) multi-process training ------------------------------------------------

MULTI_STEPS = 3
#: (l)1: the NCCL world-1 worker's losses against the in-process unmeshed
#: Trainer's, relative: the same program on the same card and seed.
MULTI_LOSS_REL = 1e-6
#: (l)2: the flash ring driven in lockstep on one card, at Llama-3-8B's
#: attention width over one 8192-token sequence cut into 4 parts.
RING_N, RING_B, RING_S, RING_H, RING_KH, RING_D = 4, 1, 8192, 32, 8, 128
#: (l)3: the ``torch_train`` gang's steps.
GANG_STEPS = 20
#: (l)4: a multi-card world's losses, and its step-1 grad norm, against an
#: in-process run on the same global batches, relative (bf16 activations).
#: Sound runs read ~1e-5 on the losses; a gradient summed over too few or
#: too many ranks moves the grad norm by tens of percent.
MULTI_CARD_LOSS_REL = 1e-4
MULTI_CARD_GRAD_NORM_REL = 1e-3


def counted_llm_pretrain(ctx) -> int:
    """(l)'s worker entrypoint (``chip_smoke:counted_llm_pretrain``):
    ``llm_pretrain`` with every training kernel's count set to 0 before
    and written after, with the peak allocation and the world it joined,
    to ``counts.json`` in the worker's workdir."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.train.entrypoints import llm_pretrain

    wrappers = _train_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rc = llm_pretrain(ctx)
    out = {"launches": {n: w.launches for n, w in wrappers.items()},
           "peak": torch.cuda.max_memory_allocated(),
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "device": str(torch.cuda.current_device())}
    Path(ctx.env.workdir, "counts.json").write_text(json.dumps(out))
    return rc


def start_workers(entrypoint: str, config: dict, workdirs: list,
                  parallelism: dict, label: str,
                  env_extra: dict | None = None) -> dict:
    """One ``runtime.worker_main`` process per workdir, as one world on the
    card(s) (``KFTPU_PLATFORM=gpu``; ``env_extra``, such as
    ``CUDA_VISIBLE_DEVICES``, added to each process's environment),
    started; ``wait_workers`` ends them."""
    import tempfile

    from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv, free_port

    repo = Path(__file__).resolve().parent
    n = len(workdirs)
    addr = f"127.0.0.1:{free_port()}"
    procs = []
    for r, wd in enumerate(workdirs):
        wenv = WorkerEnv(coordinator_address=addr, num_processes=n,
                         process_id=r, job=f"default/{label}",
                         replica_index=r, entrypoint=entrypoint,
                         config=config, parallelism=parallelism,
                         platform=WORKER_PLATFORM, workdir=str(wd),
                         rendezvous_timeout_seconds=300.0)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("KFTPU_")}
        env.update(wenv.to_env())
        env.update(env_extra or {})
        env["PYTHONPATH"] = str(repo)
        log = tempfile.TemporaryFile()
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
            cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return {"procs": procs, "label": label, "t0": time.perf_counter()}


def wait_workers(gang: dict, timeout: float = 600.0) -> float:
    """Wait for a ``start_workers`` world; returns its seconds from start
    to the last exit. Fails unless every process exits 0."""
    procs, label = gang["procs"], gang["label"]
    deadline = time.monotonic() + timeout
    rcs = []
    for proc, log in procs:
        try:
            rcs.append(proc.wait(timeout=max(1.0, deadline
                                             - time.monotonic())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for r, ((proc, log), rc) in enumerate(zip(procs, rcs)):
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        if rc != 0:
            log.seek(0)
            print(f"{label} rank {r} log (tail):\n"
                  + log.read().decode(errors="replace")[-4000:],
                  file=sys.stderr, flush=True)
        log.close()
    if any(rc != 0 for rc in rcs):
        fail(f"{label}: exit codes {rcs}")
    return time.perf_counter() - gang["t0"]


def spawn_workers(entrypoint: str, config: dict, workdirs: list,
                  parallelism: dict, label: str,
                  env_extra: dict | None = None) -> float:
    """``start_workers`` then ``wait_workers``."""
    return wait_workers(start_workers(entrypoint, config, workdirs,
                                      parallelism, label, env_extra))


def multi_worker_world1(card: str) -> list[float]:
    """(l)1: ``llm_pretrain`` through ``runtime.worker_main`` with
    ``KFTPU_PARALLELISM_JSON={"fsdp": 1}``: an NCCL world of one on the
    card, Llama-3-8B width at 4 layers, 2 x 2048 tokens, 3 steps, fused
    kernels on. Each step's loss against the in-process unmeshed
    ``Trainer``'s on the same seed; the worker's launches per step of
    rows 1-11 exactly the train phase's. Returns the worker's losses."""
    import dataclasses
    import tempfile

    cfg = _trainer_cfg(steps=MULTI_STEPS)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_train_") as wd:
        torch.cuda.empty_cache()
        secs = spawn_workers("chip_smoke:counted_llm_pretrain",
                             dataclasses.asdict(cfg), [wd], {"fsdp": 1},
                             "(l)1 llm_pretrain")
        rows = [json.loads(x) for x in
                Path(wd, "metrics.jsonl").read_text().splitlines()]
        counts = json.loads(Path(wd, "counts.json").read_text())
    if counts["world"] != 1 or counts["backend"] != "nccl":
        fail(f"(l)1: the worker joined {counts['world']} ranks over "
             f"{counts['backend']}, not an NCCL world of one")
    from kubeflow_tpu_torch.models.config import preset

    mcfg = preset(cfg.model, **cfg.model_overrides)
    want = {n: c * MULTI_STEPS for n, c in _want_per_step(
        True, mcfg.n_layers).items()}
    if counts["launches"] != want:
        fail(f"(l)1: the worker's launches {counts['launches']}, expected "
             f"{want}")
    with tempfile.TemporaryDirectory() as wd:
        ref = _counted_run(cfg, wd, "(l)1 in-process reference")["steps"]
    losses = [r["loss"] for r in rows]
    refs = [ref[s]["loss"] for s in range(1, MULTI_STEPS + 1)]
    nan = float("nan")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, refs))
    print(f"(l)1 llm_pretrain worker, NCCL world 1, {{fsdp: 1}}: exit 0 in "
          f"{secs:.1f} s; losses {losses} vs in-process {refs} (max rel "
          f"{rel:.3e}, tolerance {MULTI_LOSS_REL:g}; bit-equal "
          f"{losses == refs}); launches per step "
          + json.dumps({n: c // MULTI_STEPS
                        for n, c in counts["launches"].items()})
          + f"; step ms {[round(r.get('step_time_ms', nan), 1) for r in rows]}"
          f"; tokens/s {[round(r.get('tokens_per_sec', nan), 1) for r in rows]}"
          f"; peak "
          f"{counts['peak'] / 2**30:.2f} GiB allocated; {card}", flush=True)
    if not rel <= MULTI_LOSS_REL:
        fail("(l)1: the worker's losses are off the in-process run's")
    return losses


def ring_one_card(card: str) -> None:
    """(l)2: the flash ring's step functions, 4 ranks driven in lockstep in
    one process (``ring_flash_lockstep``), at Llama-3-8B attention width
    (32/8 heads x 128), B = 1, S = 8192: o and lse against one flash
    forward over the whole sequence, dq/dk/dv against the one-card flash
    backward, exactly 10 launches of each flash kernel (no future part
    launches), and the ring's kernel ms beside the single flash's."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops import flash_attention as FA
    from kubeflow_tpu_torch.parallel.ring_attention import (
        ring_flash_lockstep,
    )

    gen = torch.Generator("cuda").manual_seed(SEED)
    B, S, H, KH, D = RING_B, RING_S, RING_H, RING_KH, RING_D

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D), \
        rnd(B, S, H, D)
    scale = D ** -0.5
    kw = dict(causal=True, sm_scale=scale, softcap=None, q_offset=0)

    def t(x):
        return x.transpose(1, 2).contiguous()

    def single():
        o, lse = FA.flash_attention(q, k, v, causal=True)
        return (o, lse) + FA.flash_bwd(t(q), t(k), t(v), t(o), lse, t(do),
                                       **kw)

    o_ref, lse_ref, dq_ref, dk_ref, dv_ref = single()
    wrappers = {"flash_fwd": FA.flash_attention,
                "flash_bwd_dkdv": FA.flash_bwd_dkdv,
                "flash_bwd_dq": FA.flash_bwd_dq}
    for w in wrappers.values():
        w.launches = 0
    o, lse, (dq, dk, dv) = ring_flash_lockstep(q, k, v, RING_N, do=do)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    want = RING_N * (RING_N + 1) // 2
    if launches != {n: want for n in wrappers}:
        fail(f"(l)2: ring launches {launches}, expected {want} of each "
             "(a future part must launch nothing)")
    err_o = within(o, o_ref, "(l)2 ring o")
    err_lse = within(lse, lse_ref, "(l)2 ring lse", atol=LSE_ATOL, rtol=0.0)
    rels = {n: rel_l2(got, t(want_)) for n, got, want_ in (
        ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    if not all(r <= BWD_REL_L2 for r in rels.values()):
        fail(f"(l)2: ring gradients rel L2 {rels} > {BWD_REL_L2}")

    def flash_share(fn) -> str:
        """The flash kernels' device ms of one ``fn()`` from a profile."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms = sum(m for key, m, _ in _kernel_times(prof)[1] if "flash" in key)
        return f"{ms:.3f}" if ms > 0 else "not measured (empty profile)"

    def ring():
        return ring_flash_lockstep(q, k, v, RING_N, do=do)

    ring_ms, one_ms = event_ms(ring), event_ms(single)
    print(f"(l)2 flash ring on one card, {RING_N} ranks in lockstep, B={B} "
          f"S={S} H={H}/{KH} D={D}: launches {json.dumps(launches)}; o max "
          f"abs err {err_o:.3e}, lse {err_lse:.3e}; grads rel L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
          + f"; forward+backward ms (CUDA events): ring {ring_ms:.3f} vs "
          f"one flash {one_ms:.3f}; the ring's flash kernels "
          f"{flash_share(ring)} ms, one flash's {flash_share(single)} ms "
          f"(profiler); {card}", flush=True)


def start_torch_train_gang(base: str) -> dict:
    """(l)3's gang, started: ``torch_train``, 2 workers on the one card
    (gloo, the JAX adapter's design), in sibling workdirs under ``base``."""
    dirs = [Path(base, "job", f"worker-{r}") for r in range(2)]
    gang = start_workers("torch_train", {"steps": GANG_STEPS, "batch": 64},
                         dirs, {}, "(l)3 torch_train")
    gang["dirs"] = dirs
    return gang


def check_torch_train_gang(gang: dict, card: str) -> None:
    """(l)3: both workers exit 0, the loss falls, both ranks' final
    weights are bit-equal."""
    secs = wait_workers(gang)
    dirs = gang["dirs"]
    rows = [json.loads(x) for x in
            (dirs[0] / "metrics.jsonl").read_text().splitlines()]
    w0 = torch.load(dirs[0] / "checkpoint.pt")
    w1 = torch.load(dirs[1] / "checkpoint.rank1.pt")
    losses = [r["loss"] for r in rows]
    equal = all(torch.equal(w0[k], w1[k]) for k in w0)
    print(f"(l)3 torch_train gang, 2 workers on one card over gloo: exit 0 "
          f"in {secs:.1f} s (beside (l)1); loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} over {len(losses)} steps; final weights "
          f"bit-equal {equal}; {card}", flush=True)
    if len(losses) != GANG_STEPS or not losses[-1] < losses[0]:
        fail(f"(l)3: losses {losses}")
    if not equal:
        fail("(l)3: the two ranks' final weights differ")


class _GlobalBatches:
    """The global batch of each step: the data shards ``0..n-1`` of
    ``data_cfg``, concatenated (what ``n`` ranks over the batch axes read
    between them)."""

    def __init__(self, data_cfg, n: int):
        from kubeflow_tpu_torch.train.data import make_data_source

        self.srcs = [make_data_source(data_cfg, shard=i, num_shards=n)
                     for i in range(n)]

    def batch_at(self, step: int):
        import numpy as np

        return np.concatenate([s.batch_at(step) for s in self.srcs])


def _global_batch_run(cfg, n: int) -> tuple[list[float], list[float]]:
    """The losses and grad norms of an in-process unmeshed ``Trainer`` of
    ``cfg`` whose batches are the global batches of ``n`` batch shards."""
    import tempfile

    from kubeflow_tpu_torch.train.trainer import Trainer

    losses: list[float] = []
    norms: list[float] = []

    def on_step(step, m):
        losses.append(m["loss"])
        norms.append(m["grad_norm"])

    with tempfile.TemporaryDirectory() as wd:
        tr = Trainer(cfg, device="cuda", workdir=wd)
        tr.data = _GlobalBatches(tr.data_cfg, n)
        try:
            tr.run(on_step=on_step)
        finally:
            del tr
            gc.collect()
            torch.cuda.empty_cache()
    return losses, norms


def multi_card_world(card: str, world1_losses: list[float]) -> None:
    """(l)4: with two or more cards, ``llm_pretrain`` at world =
    min(cards, 4) over NCCL, 3 steps each, on ``{seq: world}`` with the
    flash ring (the K/V parts rotating between cards) and on ``{fsdp:
    world}`` (the params sharded, gathered per layer), fused kernels on
    each rank's local blocks (``card_world_runs``). (l)1's losses are
    printed beside them."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"(l)4 multi-card NCCL world: not run — this machine has "
              f"{count} card (NCCL takes one rank per card); {card}",
              flush=True)
        return
    world = min(count, 4)
    card_world_runs("(l)4", card, (({"seq": world}, "ring_flash"),
                                   ({"fsdp": world}, "pallas")),
                    world1_losses)


def card_world_runs(label: str, card: str, cases, world1_losses=None,
                    every_kernel: bool = False) -> None:
    """``llm_pretrain`` over NCCL on each ``(axes, attn_impl)`` of
    ``cases`` (one process per card), Llama-3-8B width at 4 layers, 3
    steps, fused kernels on each rank's local blocks. The trainer rounds
    the global batch up to a multiple of the processes (JAX's rule), so
    each run is held to an in-process unmeshed run, fused on, on the same
    global batches: losses within ``MULTI_CARD_LOSS_REL``, the step-1 grad
    norm within ``MULTI_CARD_GRAD_NORM_REL``. Prints step ms, tokens/s,
    peak per rank and the kernels' launches per rank; with
    ``every_kernel`` each training kernel must have launched on every
    rank."""
    import dataclasses
    import tempfile

    nan = float("nan")
    for axes, attn in cases:
        world = math.prod(axes.values())
        cfg = dataclasses.replace(_trainer_cfg(steps=MULTI_STEPS),
                                  attn_impl=attn)
        with tempfile.TemporaryDirectory(
                dir=Path(__file__).resolve().parent,
                prefix=".chip_smoke_train_") as base:
            dirs = [Path(base, f"w{r}") for r in range(world)]
            secs = spawn_workers("chip_smoke:counted_llm_pretrain",
                                 dataclasses.asdict(cfg), dirs, axes,
                                 f"{label} llm_pretrain {axes}")
            rows = [json.loads(x) for x in
                    (dirs[0] / "metrics.jsonl").read_text().splitlines()]
            counts = [json.loads((d / "counts.json").read_text())
                      for d in dirs]
        # The trainer rounds the global batch up to lcm(processes, batch
        # shards), as JAX's does: the reference reads the same rows.
        ref_cfg = dataclasses.replace(
            cfg, data=dict(cfg.data, global_batch=math.lcm(
                cfg.data["global_batch"], world)))
        refs, ref_norms = _global_batch_run(ref_cfg, axes.get("fsdp", 1))
        ref_name = "in-process, fused on, same global batches"
        losses = [r["loss"] for r in rows]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, refs))
        norm1 = rows[0]["grad_norm"]
        rel_norm = abs(norm1 - ref_norms[0]) / abs(ref_norms[0])
        extra = "" if world1_losses is None else f"; (l)1 {world1_losses}"
        print(f"{label} llm_pretrain over NCCL, {world} cards, {axes}, "
              f"attn {attn}: exit 0 in {secs:.1f} s; devices "
              f"{[c['device'] for c in counts]}, backends "
              f"{sorted({c['backend'] for c in counts})}; losses {losses} "
              f"vs {ref_name} {refs} (max rel {rel:.3e}, tolerance "
              f"{MULTI_CARD_LOSS_REL:g}{extra}); step-1 "
              f"grad norm {norm1} vs {ref_norms[0]} (rel {rel_norm:.3e}, "
              f"tolerance {MULTI_CARD_GRAD_NORM_REL:g}); step ms "
              f"{[round(r.get('step_time_ms', nan), 1) for r in rows]}; "
              f"tokens/s "
              f"{[round(r.get('tokens_per_sec', nan), 1) for r in rows]}; "
              f"peak per rank "
              f"{[round(c['peak'] / 2**30, 2) for c in counts]} GiB; "
              f"launches per rank "
              f"{[c['launches'] for c in counts]}; {card}",
              flush=True)
        if len({c["device"] for c in counts}) != world or any(
                c["world"] != world or c["backend"] != "nccl"
                for c in counts):
            fail(f"{label} {axes}: ranks {counts} are not one NCCL world "
                 "over distinct cards")
        if every_kernel and any(n == 0 for c in counts
                                for n in c["launches"].values()):
            fail(f"{label} {axes}: a kernel of the path launched no time "
                 "on a rank")
        if not rel <= MULTI_CARD_LOSS_REL:
            fail(f"{label} {axes}: the multi-card losses are off "
                 f"{ref_name}'s")
        if not rel_norm <= MULTI_CARD_GRAD_NORM_REL:
            fail(f"{label} {axes}: the step-1 grad norm is off {ref_name}'s")


def phase_multi(card: str) -> None:
    """(l): multi-process training — the NCCL worker path at world 1, the
    flash ring's step maths at full width on one card, a two-process gloo
    gang on one card, and a multi-card world where there is one."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as base:
        # The small gang runs beside (l)1 (both start processes); it ends
        # before (l)2's timings.
        gang = start_torch_train_gang(base)
        losses = timed_phase("multi world 1", multi_worker_world1, card)
        timed_phase("multi torch_train gang", check_torch_train_gang, gang,
                    card)
    timed_phase("multi ring", ring_one_card, card)
    timed_phase("multi cards", multi_card_world, card, losses)


# -- (m) tensor parallelism over the model axis -------------------------------

#: (m)1 and (m)2: the model axis's degree, run in lockstep on one card.
TP_WAYS = 4
#: (m)1: split block vs the unsplit one, output and every gradient.
TP_REL_L2 = 1e-2
TP_T = 2048
#: (m)3-(m)5's worlds: one process per card; (m)4 and (m)5 serve on
#: ``PAGED_SPEC``'s page pool.
TP_CARDS = 4
#: (m)5: Llama-3-70B at every layer and full width, bf16 weights.
TP_MODEL_70B = {"preset": "llama3-70b",
                "overrides": {"param_dtype": "bfloat16"}}
#: (m)5's greedy requests: (tokens, salt) of ``text``.
TP_70B_PROMPTS = tuple((n, 120 + i) for i, n in enumerate(
    (40, 90, 150, 200, 260, 300, 350, 400)))
TP_NEW = 16
#: (m)4's explanations: the handler each gang serves, and the prompt's
#: tokens (phase (a)'s length).
TP_EXPLAINERS = {"bf16": "grad_x_input", "int8": "leave_one_out"}
TP_EXPLAIN_TOKENS = 37


def _tp_cut(tree: dict, specs: dict, r: int) -> dict:
    """Rank ``r``'s shards of a block's leaves on ``{model: TP_WAYS}``
    (``parallel.sharding.cut_local``; differentiable in the whole leaf)."""
    from kubeflow_tpu_torch.parallel.sharding import cut_local

    return {k: cut_local(v, specs[k], {"model": TP_WAYS}, {"model": r})
            for k, v in tree.items()}


def tp_block_lockstep(rows: list[dict], card: str) -> None:
    """(m)1: one Llama-3-8B block (bf16) at B = 1, T = 2048, split
    ``TP_WAYS`` ways as the model axis splits it, the ranks run one after
    another on this card: each rank's 8 q and 2 kv heads through the flash
    forward and backward (rows 6-8) and its 3584 mlp columns through the
    SwiGLU kernels (rows 4-5), on its cut of ``wq/wk/wv/wo`` and
    ``gate/up/down`` (``parallel.sharding.cut_local``, the training
    rules' specs); the ranks' partial outputs of ``wo`` and ``down`` are
    summed (the all-reduce of ``reduce_from_model``), the norms (rows 1-3)
    run once. The forward output and every gradient (input, norms and each
    whole weight, the ranks' cuts assembled by autograd) against the
    unsplit block through the same kernels: rel L2 <= ``TP_REL_L2``; the
    launches of rows 4-8 exactly ``TP_WAYS`` times the unsplit block's,
    rows 1-3 the same."""
    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import preset

    cfg = preset("llama3-8b", n_layers=1, param_dtype="bfloat16")
    gen = torch.Generator("cuda").manual_seed(SEED + 90)
    attn = L.init_attention(gen, cfg)
    mlp = L.init_mlp(gen, cfg)
    norms = [(1.0 + 0.1 * torch.randn((cfg.hidden,), generator=gen,
                                      device="cuda")).to(torch.bfloat16)
             for _ in range(2)]
    leaves = [*attn.values(), *mlp.values(), *norms]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.randn((1, TP_T, cfg.hidden), generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    dy = torch.randn((1, TP_T, cfg.hidden), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    pos = torch.arange(TP_T, device="cuda")[None]
    specs = {"wq": (None, "model", None), "wk": (None, "model", None),
             "wv": (None, "model", None), "wo": ("model", None, None),
             "gate": (None, "model"), "up": (None, "model"),
             "down": ("model", None)}

    def block(split: bool, parts=None):
        if parts is None:
            parts = ([(_tp_cut(attn, specs, r), _tp_cut(mlp, specs, r))
                      for r in range(TP_WAYS)] if split else [(attn, mlp)])
        h = L.rmsnorm(x, norms[0], cfg)
        out = 0
        for a, _ in parts:
            q, k, v = L.attention_qkv(a, h, pos, cfg)
            out = out + L.attention_out(a, q, k, v, cfg, attn_impl="pallas")
        y, h2 = L.add_rmsnorm(x, out, norms[1], cfg)
        mlp_out = 0
        for _, m in parts:
            mlp_out = mlp_out + L.mlp_block(m, h2, cfg)
        return y + mlp_out

    def run(split: bool):
        for w in wrappers.values():
            w.launches = 0
        out = block(split)
        grads = torch.autograd.grad(out, [x, *leaves], dy)
        return out.detach(), grads, {n: w.launches
                                     for n, w in wrappers.items()}

    wrappers = {k: v for k, v in _train_wrappers().items()
                if not k.startswith("fused_xent")}
    out1, g1, n1 = run(False)
    out4, g4, n4 = run(True)
    names = ["x", *(f"attn.{k}" for k in attn), *(f"mlp.{k}" for k in mlp),
             "ln1", "ln2"]
    rels = {"out": rel_l2(out4, out1)}
    rels.update({n: rel_l2(a, b) for n, a, b in zip(names, g4, g1)})
    # Timed on the ranks' cuts made once, as each rank holds them.
    cuts = [tuple({k: v.detach().requires_grad_(True) for k, v in
                   _tp_cut(tree, specs, r).items()} for tree in (attn, mlp))
            for r in range(TP_WAYS)]
    cut_leaves = [v for a, m in cuts for v in (*a.values(), *m.values())]
    ms1 = event_ms(lambda: torch.autograd.grad(block(False), [x, *leaves],
                                               dy))
    ms4 = event_ms(lambda: torch.autograd.grad(
        block(True, cuts), [x, *norms, *cut_leaves], dy))
    print(f"(m)1 Llama-3-8B block, B=1 T={TP_T}, {TP_WAYS} ranks in "
          f"lockstep ({cfg.n_heads // TP_WAYS} q / "
          f"{cfg.n_kv_heads // TP_WAYS} kv heads, "
          f"{cfg.mlp_dim // TP_WAYS} mlp columns each) vs unsplit: rel L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tolerance {TP_REL_L2:g}); launches split {n4} vs unsplit "
          f"{n1}; fwd+bwd ms split {ms4:.3f} vs unsplit {ms1:.3f}; {card}",
          flush=True)
    bad = {k: v for k, v in rels.items() if not v <= TP_REL_L2}
    if bad:
        fail(f"(m)1: the split block is off the unsplit one: {bad}")
    per_rank = ("swiglu_fwd", "swiglu_bwd", "flash_fwd", "flash_bwd_dkdv",
                "flash_bwd_dq")
    for n, c in n4.items():
        want = TP_WAYS * n1[n] if n in per_rank else n1[n]
        if c != want or c == 0:
            fail(f"(m)1: {n} launched {c} times, expected {want} (unsplit "
                 f"{n1[n]})")
        _add_launches(rows, n, c)


def tp_xent_lockstep(rows: list[dict], card: str) -> None:
    """(m)2: the vocab-parallel fused CE at T = 4096, D = 4096, V = 128256
    over ``TP_WAYS`` shards of 32064 columns (125 1/4 vocab tiles: the
    ragged last tile), run one after another on this card
    (``vocab_parallel.vocab_parallel_lockstep``: row 9 on each shard with
    its shifted targets, the shards' statistics combined, rows 10 and 11
    on each shard with the global lse). nll, lse, correct, d_hidden and d_head
    against the whole-vocab kernels on the same inputs: lse |diff| <=
    LSE_ATOL, the rest within the kernel phase's bounds, correct equal but
    at near ties (argmax ties to the lowest index, also across a shard
    boundary). Each shard's ms beside the whole call's."""
    from kubeflow_tpu_torch.ops import fused_xent as fx
    from kubeflow_tpu_torch.parallel import vocab_parallel as vp

    T, D, V = 4096, 4096, 128256
    name = f"(m)2 vocab-parallel fused_xent T={T} D={D} V={V} / {TP_WAYS}"
    gen = torch.Generator("cuda").manual_seed(SEED + 91)
    h, w, t, g, expect = xent_case(gen, T, D, V)
    shard = V // TP_WAYS
    for row, (a, b) in ((10, (shard - 2, shard + 2)),):
        # A tie across the first shard boundary: the lower column wins.
        w[:, b] = w[:, a]
        h[row] = h[row + 1] = (8.0 * w[:, a].float()).to(torch.bfloat16)
        t[row], t[row + 1] = a, b
        expect[row], expect[row + 1] = 1.0, 0.0
    nll, lse, cor = fx.xent_fwd(h, w, t)
    dh, dw = fx.xent_bwd(h, w, t, lse, g)
    wrappers = {k: v for k, v in _train_wrappers().items()
                if k.startswith("fused_xent")}
    for v in wrappers.values():
        v.launches = 0
    tn, tl, tc, tdh, tdw = vp.vocab_parallel_lockstep(h, w, t, TP_WAYS, g=g)
    launches = {k: v.launches for k, v in wrappers.items()}
    if any(n != TP_WAYS for n in launches.values()):
        fail(f"{name}: launches {launches}, expected {TP_WAYS} each")
    for k, n in launches.items():
        _add_launches(rows, k, n)
    lse_err = float((tl - lse).abs().max())
    if not lse_err <= LSE_ATOL:
        fail(f"{name}: lse off the whole-vocab kernel's by {lse_err:.3e}")
    errs = {"nll": within(tn, nll, f"{name} nll")}
    rels = {}
    for part, got, want in (("dh", tdh, dh), ("dw", tdw, dw)):
        scale = float(want.float().abs().max())
        errs[part] = within(got, want, f"{name} {part}", atol=ATOL * scale)
        rels[part] = rel_l2(got, want)
        if not rels[part] <= BWD_REL_L2:
            fail(f"{name} {part}: rel L2 {rels[part]:.3e} > {BWD_REL_L2:g}")
    logits = fx._logits_ref(h, w, None)
    n_diff = argmax_agrees(tc, cor, logits, name)
    del logits
    for row, want in expect.items():
        if float(tc[row]) != want:
            fail(f"{name}: row {row} correct {float(tc[row])}, expected "
                 f"{want} (argmax ties go to the lowest index)")
    parts = [w[:, r * shard:(r + 1) * shard].contiguous()
             for r in range(TP_WAYS)]
    local = [(t - r * shard).contiguous() for r in range(TP_WAYS)]

    def one(r: int):
        _, l_r, _ = fx.xent_fwd(h, parts[r], local[r])
        fx.xent_bwd(h, parts[r], local[r], l_r, g)

    def whole():
        _, l_w, _ = fx.xent_fwd(h, w, t)
        fx.xent_bwd(h, w, t, l_w, g)

    shard_ms = [event_ms(lambda r=r: one(r), iters=2) for r in range(TP_WAYS)]
    whole_ms = event_ms(whole, iters=2)
    print(f"{name}: lse max |diff| {lse_err:.3e} (tolerance {LSE_ATOL:g}), "
          f"max_abs_err nll {errs['nll']:.3e}, dh {errs['dh']:.3e}, dw "
          f"{errs['dw']:.3e}; rel L2 dh {rels['dh']:.3e}, dw "
          f"{rels['dw']:.3e} (tolerance {BWD_REL_L2:g}); correct differs "
          f"on {n_diff} near-tie rows, ties within and across shards hold; "
          f"fwd+bwd ms per shard {[round(x, 3) for x in shard_ms]} vs the "
          f"whole vocabulary {whole_ms:.3f}; {card}", flush=True)


def counted_model_server(ctx) -> int:
    """(m)4's and (m)5's worker entrypoint (``chip_smoke:
    counted_model_server``): ``model_server`` with the serving kernels'
    counts set to 0 before and written after, with the rank's peak
    allocation, to ``counts.json`` in its workdir — also when SIGTERM ends
    it."""
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.serve import storage
    from kubeflow_tpu_torch.serve.model_server import model_server

    # The backward kernels run only for an explainer (``grad_x_input``).
    wrappers = {**_moe_wrappers(), "rmsnorm_bwd": fused_norm.rmsnorm_bwd,
                "swiglu_bwd": fused_norm.swiglu_bwd}
    for w in wrappers.values():
        w.launches = 0
    ctx.mesh                  # join first: it picks this rank's card
    plant = ctx.config.get("plant")
    if plant and plant["rank"] == ctx.env.process_id:
        # A test-only fault (``--ep-fault-cards-only``): this rank's shard
        # of one expert's down weight, every layer, scaled.
        load = storage.load_params

        def planted(*args, **kwargs):
            params = load(*args, **kwargs)
            params["layers"]["mlp"]["down"][:, plant["expert"]] *= \
                plant["scale"]
            return params

        storage.load_params = planted
    card = ctx.device.startswith("cuda")
    if card:
        torch.cuda.reset_peak_memory_stats()
    try:
        return model_server(ctx)
    finally:
        Path(ctx.env.workdir, "counts.json").write_text(json.dumps({
            "launches": {n: w.launches for n, w in wrappers.items()},
            "peak": torch.cuda.max_memory_allocated() if card else 0,
            "device": str(torch.cuda.current_device()) if card else "cpu"}))


#: (m)5's depths at which the layer-by-layer drift is printed.
TP_DRIFT_LAYERS = (1, 10, 20, 40, 60, 80)


def _tp_layer_trace(params, cfg, ids: torch.Tensor, n_out: int,
                    cached: bool):
    """Teacher-forced forward of ``ids`` [1, S] layer by layer: the
    residual stream after the embedding and after each block, fp32
    [n_out, D] at the last ``n_out`` positions, and the whole
    vocabulary's fp32 logits there. ``cached``: as the engine serves, the
    first S - n_out + 1 tokens at once into a contiguous KV cache, then
    one token at a time (the decode's one-row products); else the whole
    sequence at once, no cache."""
    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.decoder import (
        _block_forward, init_kv_caches, layer_view, lm_head,
    )

    s, dev = ids.shape[1], ids.device
    first = s - n_out
    segs = ([(0, first + 1)] + [(t, t + 1) for t in range(first + 1, s)]
            if cached else [(0, s)])
    caches = init_kv_caches(cfg, 1, s, dev) if cached else None
    states = [[] for _ in range(cfg.n_layers + 1)]
    finals = []
    for a, b in segs:
        keep = max(a, first) - a
        x = L.embed(params["embed"], ids[:, a:b], cfg)
        if cfg.embed_scale:
            x = x * L.embed_scale_value(cfg)
        pos = torch.arange(a, b, device=dev)[None]
        states[0].append(x[0, keep:].float())
        for i in range(cfg.n_layers):
            cache = None if caches is None else {
                "k": caches["k"][i], "v": caches["v"][i], "len": a}
            x, _, _ = _block_forward(layer_view(params["layers"], i), x,
                                     pos, cfg, kv_cache=cache)
            states[i + 1].append(x[0, keep:].float())
        finals.append(L.rmsnorm(x, params["final_norm"], cfg)[0, keep:])
    logits = lm_head(params, torch.cat(finals), cfg)
    return [torch.cat(st) for st in states], logits


def tp_teacher_forced(ctx) -> int:
    """(m)5's checking entrypoint (``chip_smoke:tp_teacher_forced``): the
    same random weights on the same cards (``load_params(random://, mesh=
    )``) and three teacher-forced tensor-parallel forwards over each
    prompt + its served tokens, layer by layer (``_tp_layer_trace``):
    ``plain`` (bf16, kernels off, the whole sequence at once), ``fp32``
    (the same in fp32 activations over the bf16 weights: the reference)
    and ``served`` (bf16, the fused kernels, the prompt then one token at
    a time through a KV cache: the engine's arithmetic but for its paged
    decode kernel). Rank 0 writes to ``teacher.json``: each bf16
    forward's relative L2 from ``fp32`` after every block; each row's
    largest |logit − fp32 logit| of the two bf16 forwards (its bf16
    noise); the argmax departures of the served tokens and of each bf16
    forward from each other forward; and the served tokens whose fp32
    gap to the top logit is past the near-tie band plus twice the row's
    bf16 noise."""
    import dataclasses

    from kubeflow_tpu_torch.models.config import preset, with_model_axis
    from kubeflow_tpu_torch.parallel.collectives import model_axis
    from kubeflow_tpu_torch.serve.storage import load_params

    conf = ctx.config
    mesh, dev = ctx.mesh, ctx.device
    cfg = preset(conf["model"]["preset"], **conf["model"]["overrides"])
    tp = model_axis(mesh)
    params = load_params("random://", cfg, device=dev, mesh=mesh)
    cfgs = {"plain": dataclasses.replace(cfg, fused_kernels="off"),
            "fp32": dataclasses.replace(cfg, dtype="float32",
                                        fused_kernels="off"),
            "served": dataclasses.replace(cfg, fused_kernels="on")}
    names = list(cfgs)
    sq = {f"{a}-{b}": [0.0] * (cfg.n_layers + 1)
          for a, b in (("plain", "fp32"), ("served", "fp32"),
                       ("plain", "served"))}
    norm = [0.0] * (cfg.n_layers + 1)
    departs = {k: 0 for k in ["tokens-" + n for n in names]
               + ["plain-fp32", "served-fp32", "plain-served"]}
    noise, gaps, bad, tokens = [], [], [], 0
    for p, out in zip(conf["prompts"], conf["outputs"]):
        got = torch.tensor(out, device=dev)
        ids = torch.tensor([list(p) + list(out[:-1])], device=dev)
        states, logits = {}, {}
        with torch.no_grad():
            for n, c in cfgs.items():
                states[n], logits[n] = _tp_layer_trace(
                    params, with_model_axis(c, tp), ids, len(out),
                    cached=n == "served")
        for pair in sq:
            a, b = pair.split("-")
            for i, (x, y) in enumerate(zip(states[a], states[b])):
                sq[pair][i] += float((x - y).square().sum())
        for i, y in enumerate(states["fp32"]):
            norm[i] += float(y.square().sum())
        top = {n: lg.argmax(-1) for n, lg in logits.items()}
        for n in names:
            departs["tokens-" + n] += int((got != top[n]).sum())
        for pair in ("plain-fp32", "served-fp32", "plain-served"):
            a, b = pair.split("-")
            departs[pair] += int((top[a] != top[b]).sum())
        ref = logits["fp32"]
        row_noise = torch.maximum(
            (logits["plain"] - ref).abs().amax(-1),
            (logits["served"] - ref).abs().amax(-1))
        hi = ref.max(-1).values
        gap = hi - ref.gather(1, got[:, None])[:, 0]
        band = NEAR_TIE_ATOL + NEAR_TIE_RTOL * hi.abs() + 2 * row_noise
        noise += row_noise.tolist()
        gaps += gap[gap > 0].tolist()
        bad += [(float(g), float(b)) for g, b in zip(gap[gap > band],
                                                      band[gap > band])]
        tokens += len(out)
    if ctx.env.process_id == 0:
        Path(ctx.env.workdir, "teacher.json").write_text(json.dumps({
            "rel_l2": {k: [math.sqrt(v[i] / norm[i]) for i in range(
                len(norm))] for k, v in sq.items()},
            "noise": noise, "gaps": gaps, "departs": departs,
            "bad": bad, "tokens": tokens}))
    return 0


def tp_step_probe(ctx) -> int:
    """(m)4's profiling entrypoint (``chip_smoke:tp_step_probe``): every
    rank of a ``{model: 4}`` world runs, in lockstep with the others and
    outside any engine, one 8-step paged decode dispatch of Llama-3-8B on
    its shards at 8 live slots (cache position 1024, as ``phase_profile``
    on one card), and 64 bare all-reduces of one decode step's [8, 1,
    4096] bf16 partial sums; each timed on the host (enqueue, and wall to
    a synchronize) and under torch.profiler (device time by kernel). Rank
    0 writes them to ``probe.json``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import preset, with_model_axis
    from kubeflow_tpu_torch.parallel.collectives import model_axis
    from kubeflow_tpu_torch.serve.paged import paged_decode_multi
    from kubeflow_tpu_torch.serve.storage import load_params

    mesh, dev = ctx.mesh, ctx.device
    cfg = preset(WORKER_MODEL["preset"], **WORKER_MODEL["overrides"])
    tcfg = with_model_axis(cfg, model_axis(mesh))
    params = load_params("random://", cfg, device=dev, mesh=mesh)
    b, steps, pg, mpp, per_slot = 8, 8, 128, 16, 9
    st = [torch.full((b,), 5, device=dev),
          torch.full((b,), 1024, device=dev),
          torch.ones((b,), dtype=torch.bool, device=dev),
          torch.zeros((b,), device=dev),
          torch.zeros((b,), dtype=torch.long, device=dev),
          torch.ones((b,), device=dev),
          torch.full((b,), -1, device=dev),
          torch.full((b,), 1 << 20, device=dev)]
    shape = (cfg.n_layers, b * per_slot + 1, pg, len(L.local_kv_heads(tcfg)),
             cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "table": torch.full((b, mpp), -1, dtype=torch.int32,
                                device=dev)}
    pool["table"][:, :per_slot] = torch.arange(
        b * per_slot, dtype=torch.int32, device=dev).reshape(b, per_slot)
    gen = torch.Generator(dev).manual_seed(SEED)
    x = torch.zeros((b, 1, cfg.hidden), dtype=torch.bfloat16, device=dev)

    def decode():
        paged_decode_multi(params, pool, *st, gen, tcfg, steps,
                           sample_mode="greedy", attn_impl="pallas")

    def reduces():
        for _ in range(64):
            dist.all_reduce(x, group=tcfg.tp.group)

    out = {}
    with torch.no_grad():
        for name, fn, per in (("paged decode step", decode, steps),
                              ("all-reduce", reduces, 64)):
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            t_enq = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
            dist.barrier()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            total, kernels = _kernel_times(prof)
            out[name] = {"enqueue_ms": t_enq * 1e3 / per,
                         "wall_ms": t_wall * 1e3 / per,
                         "device_ms": total / per,
                         "kernels": [(k[:70], ms / per, n / per)
                                     for k, ms, n in kernels[:6]]}
    if ctx.env.process_id == 0:
        Path(ctx.env.workdir, "probe.json").write_text(json.dumps(out))
    return 0


def tp_profile(card: str) -> None:
    """(m)4's profile: ``tp_step_probe`` on a ``{model: 4}`` world of 4
    cards, printed as ``phase_profile`` prints one card's."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_tp_") as base:
        dirs = [Path(base, f"w{r}") for r in range(TP_CARDS)]
        spawn_workers("chip_smoke:tp_step_probe", {}, dirs,
                      {"model": TP_CARDS}, "(m)4 TP step probe")
        res = json.loads((dirs[0] / "probe.json").read_text())
    for name, r in res.items():
        print(f"(m)4 profile {name}, Llama-3-8B on {{model: {TP_CARDS}}}, "
              f"rank 0 (per step or call): host enqueue "
              f"{r['enqueue_ms']:.3f} ms, wall {r['wall_ms']:.3f} ms, device "
              f"{r['device_ms']:.3f} ms; {card}", flush=True)
        for key, ms, n in r["kernels"]:
            print(f"  {ms:8.3f} ms  {n:6.1f}x  {key}", flush=True)


def _tp_gang(model: dict, batching: dict, label: str, base: str,
             plant: dict | None = None, explainer: str | None = None
             ) -> dict:
    """A ``{model: TP_CARDS}`` ``counted_model_server`` gang serving
    ``model`` from ``random://`` with ``batching``, the ids-as-text
    tokenizer (and the ``explainer`` handler, when given); returns it with
    its url once rank 0 answers its readiness probe. ``plant``: a
    test-only fault (``counted_model_server``)."""
    return _tp_gang_ready(_tp_gang_start(model, batching, label, base,
                                         plant=plant, explainer=explainer))


def _tp_gang_start(model: dict, batching: dict, label: str, base: str, *,
                   ways: int = TP_CARDS, cards: str | None = None,
                   plant: dict | None = None,
                   explainer: str | None = None) -> dict:
    """``_tp_gang``'s gang on ``{model: ways}``, started (on the cards
    ``cards`` names, ``CUDA_VISIBLE_DEVICES``, when given)."""
    from kubeflow_tpu_torch.runtime.bootstrap import free_port

    port = free_port()
    conf = {"model": model, "storage_uri": "random://", "batching": batching,
            "port": port, "service": "llama",
            "tokenizer": "chip_smoke:TokenIdText"}
    if plant:
        conf["plant"] = plant
    if explainer:
        conf["explainer"] = {"handler": explainer}
    dirs = [Path(base, re.sub(r"[^\w.-]", "_", label), f"w{r}")
            for r in range(ways)]
    gang = start_workers("chip_smoke:counted_model_server", conf, dirs,
                         {"model": ways}, label,
                         None if cards is None
                         else {"CUDA_VISIBLE_DEVICES": cards})
    gang["url"], gang["dirs"] = f"http://127.0.0.1:{port}", dirs
    return gang


def _tp_gang_ready(gang: dict) -> dict:
    """``gang`` once rank 0 answers its readiness probe (``ready_s``: the
    seconds since it started)."""
    label = gang["label"]
    t0 = gang["t0"]
    while True:
        dead = [r for r, (p, _) in enumerate(gang["procs"])
                if p.poll() is not None]
        if dead:
            _tp_gang_logs(gang)
            fail(f"{label}: ranks {dead} exited before rank 0 was ready")
        try:
            if _get(gang["url"] + "/v2/health/ready", timeout=2.0)[0] == 200:
                break
        except OSError:
            pass
        if time.perf_counter() - t0 > 600:
            _tp_gang_logs(gang)
            fail(f"{label}: not ready after 600 s")
        time.sleep(0.5)
    gang["ready_s"] = time.perf_counter() - t0
    return gang


def _tp_gang_logs(gang: dict) -> list[str]:
    """Every rank's log so far (and its tail printed to stderr)."""
    out = []
    for r, (_, log) in enumerate(gang["procs"]):
        log.seek(0)
        out.append(log.read().decode(errors="replace"))
        print(f"{gang['label']} rank {r} log (tail):\n{out[-1][-3000:]}",
              file=sys.stderr, flush=True)
    return out


def _tp_stop(gang: dict, card: str) -> dict:
    """SIGTERM to rank 0: it must exit 143 and every follower 0, within
    60 s; the followers' op counts (their logs) must equal the leader's.
    Returns {"ops": [...], "counts": [counts.json of each rank]}."""
    import signal

    procs = [p for p, _ in gang["procs"]]
    procs[0].send_signal(signal.SIGTERM)
    t0 = time.perf_counter()
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(1.0, 60 - (time.perf_counter()
                                                      - t0))))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    secs = time.perf_counter() - t0
    logs = [None] * len(procs)
    for r, (p, log) in enumerate(gang["procs"]):
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
        log.seek(0)
        logs[r] = log.read().decode(errors="replace")
        log.close()
    if rcs != [143] + [0] * (len(procs) - 1):
        for r, text_ in enumerate(logs):
            print(f"{gang['label']} rank {r} log (tail):\n{text_[-3000:]}",
                  file=sys.stderr, flush=True)
        fail(f"{gang['label']}: SIGTERM to rank 0 gave exit codes {rcs}")
    m = re.search(r"(\d+) ops dispatched to the model axis \(([0-9.]+) ms "
                  r"sending; by op (\{.*?\}); bytes each follower received "
                  r"by op (\{.*?\})\)", logs[0])
    ops = [int(m.group(1)) if m else -1]
    send_ms = float(m.group(2)) if m else float("nan")
    by_op = [json.loads(m.group(3)) if m else None]
    sent = json.loads(m.group(4)) if m else {}
    for r in range(1, len(procs)):
        m = re.search(rf"follower rank {r} ran (\d+) ops \(by op "
                      r"(\{.*?\})\)", logs[r])
        ops.append(int(m.group(1)) if m else -1)
        by_op.append(json.loads(m.group(2)) if m else None)
    counts = [json.loads((d / "counts.json").read_text())
              for d in gang["dirs"]]
    print(f"{gang['label']}: SIGTERM -> exit codes {rcs} in {secs:.1f} s; "
          f"ops dispatched / run per rank {ops}; the leader's host ms "
          f"sending them {send_ms:.3f} ({send_ms / max(ops[0], 1):.3f} an "
          f"op); {card}", flush=True)
    if ops[0] <= 0 or len(set(ops)) != 1 or by_op[0] is None or \
            any(b != by_op[0] for b in by_op[1:]):
        fail(f"{gang['label']}: the followers' op counts {ops[1:]} (by op "
             f"{by_op[1:]}) are not the leader's {ops[0]} ({by_op[0]})")
    return {"ops": ops, "counts": counts, "by_op": by_op[0], "sent": sent}


def _tp_greedy(url: str, prompts, new: int = TP_NEW,
               headers: dict | None = None,
               one_at_a_time: bool = False) -> list[list[int]]:
    """Greedy completions of ``prompts`` ((tokens, salt) of ``text``),
    sent at once (the engine batches them), or with ``one_at_a_time`` each
    after the one before has finished, as token ids."""
    from concurrent.futures import ThreadPoolExecutor

    def ask(ps):
        raw = _post(url + "/v1/completions",
                    {"prompt": text(*ps), "max_tokens": new},
                    headers=headers)[1]
        return [int(x) for x in json.loads(raw)["choices"][0]["text"].split()]

    if one_at_a_time:
        return [ask(ps) for ps in prompts]
    with ThreadPoolExecutor(len(prompts)) as pool:
        return list(pool.map(ask, prompts))


def tp_serve_8b(card: str) -> None:
    """(m)4: a ``{model: 4}`` ``model_server`` gang of Llama-3-8B (32
    layers, bf16, ``random://``) on the page pool, bf16 pages then int8:
    greedy tokens of ``WORKER_PROMPTS`` each the argmax or a near tie of a
    plain one-card forward (kernels off) over the same weights, and
    compared with the one-card paged engine's; ``uniform`` (16 requests)
    through ``ServerTarget`` on the bf16 gang (TTFT, TPOT); the followers'
    op counts equal the leader's; SIGTERM ends rank 0 with 143 and every
    follower with 0; each rank's kernel launches and peak. Each gang also
    serves ``:explain`` on a ``TP_EXPLAIN_TOKENS``-token prompt, every
    rank computing on its shards (``TP_EXPLAINERS``: ``grad_x_input`` on
    the bf16 gang, ``leave_one_out`` on the int8 one), held to the
    one-card kernel-path explanation of the same weights: the same
    target, scores within ``EXPLAIN_REL_L2`` (rel L2); each rank launches
    2L + 1 RMSNorm backward and L SwiGLU backward kernels a
    ``grad_x_input``, and none for ``leave_one_out``."""
    import tempfile

    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serve.explain import (
        attribution_cfg, explainer_registry,
    )
    from kubeflow_tpu_torch.serve.storage import load_params

    outs, explained = {}, {}
    prompt = text(TP_EXPLAIN_TOKENS, 31)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_tp_") as base:
        for pool, over in (("bf16", {}), ("int8", {"kv_cache_dtype": "int8"})):
            label = f"(m)4 8B TP gang {pool} pages"
            gang = _tp_gang(WORKER_MODEL, dict(PAGED_SPEC, **over), label,
                            base, explainer=TP_EXPLAINERS[pool])
            ok = False
            try:
                t0 = time.perf_counter()
                outs[pool] = _tp_greedy(gang["url"], WORKER_PROMPTS)
                print(f"{label}: ready in {gang['ready_s']:.1f} s; greedy "
                      f"{outs[pool]} in {time.perf_counter() - t0:.1f} s; "
                      f"{card}", flush=True)
                t0 = time.perf_counter()
                raw = _post(gang["url"] + "/v1/models/llama:explain",
                            {"instances": [prompt]})[1]
                (explained[pool],) = json.loads(raw)["explanations"]
                print(f"{label}: :explain ({TP_EXPLAINERS[pool]}, "
                      f"{TP_EXPLAIN_TOKENS} tokens) answered in "
                      f"{time.perf_counter() - t0:.3f} s, target "
                      f"{explained[pool]['target_token']}; {card}",
                      flush=True)
                if pool == "bf16":
                    sc = next(x for x in loadgen.standard_matrix(**LOADGEN)
                              if x.name == "uniform")
                    run = loadgen.run_scenario(
                        loadgen.ServerTarget(gang["url"], model="llama"), sc,
                        vocab_size=128256, max_prompt_len=1024)
                    rep = loadgen.build_report(
                        run, metrics_text=_get(gang["url"] + "/metrics")[1])
                    report_line(f"uniform ({label}, ServerTarget)", rep, card)
                    check_statuses(f"uniform ({label})", rep)
                ok = True
            finally:
                if not ok:
                    _tp_gang_logs(gang)
                    for p, _ in gang["procs"]:
                        p.kill()
            got = _tp_stop(gang, card)
            print(f"{label}: launches per rank "
                  f"{[c['launches'] for c in got['counts']]}; peak per rank "
                  f"{[round(c['peak'] / 2**30, 2) for c in got['counts']]} "
                  f"GiB; {card}", flush=True)
            for c in got["counts"]:
                if not all(c["launches"][k] for k in (
                        "rmsnorm_fwd", "add_rmsnorm_fwd", "swiglu_fwd",
                        "paged_decode")):
                    fail(f"{label}: a serving kernel launched no time on a "
                         f"rank: {c['launches']}")
            n_layers = preset(WORKER_MODEL["preset"]).n_layers
            grads = TP_EXPLAINERS[pool] == "grad_x_input"
            want = {"rmsnorm_bwd": 2 * n_layers + 1 if grads else 0,
                    "swiglu_bwd": n_layers if grads else 0}
            bwd = [{k: c["launches"][k] for k in want} for c in got["counts"]]
            print(f"{label}: :explain backward launches per rank {bwd} "
                  f"(expected {want} on each)", flush=True)
            if any(b != want for b in bwd):
                fail(f"{label}: the explainer's backward launches {bwd} "
                     f"per rank, expected {want}")
    cfg = preset(WORKER_MODEL["preset"], **WORKER_MODEL["overrides"])
    params = load_params("random://", cfg, device="cuda")
    tok = TokenIdText()
    for pool, method in TP_EXPLAINERS.items():
        one = explainer_registry[method](tok.encode(prompt), params=params,
                                         cfg=attribution_cfg(cfg))
        a = torch.tensor(explained[pool]["scores"], dtype=torch.float64)
        b = torch.tensor(one["scores"], dtype=torch.float64)
        rel = float((a - b).norm() / b.norm())
        print(f"(m)4 {pool} gang :explain {method}: target "
              f"{explained[pool]['target_token']} vs one card "
              f"{one['target_token']}; scores rel L2 {rel:.3e} against the "
              f"one-card kernel path (tolerance {EXPLAIN_REL_L2:g}); {card}",
              flush=True)
        if explained[pool]["target_token"] != one["target_token"]:
            fail(f"(m)4 {pool} gang :explain: the target differs from the "
                 "one-card explanation's")
        if not rel <= EXPLAIN_REL_L2:
            fail(f"(m)4 {pool} gang :explain: {method}'s scores disagree "
                 "with the one-card explanation's")
    for pool, over in (("bf16", {}), ("int8", {"kv_cache_dtype": "int8"})):
        eng = LLMEngine(cfg, BatchingSpec(**dict(PAGED_SPEC, **over)),
                        params=params, seed=SEED, device="cuda")
        one = [eng.generate(tok.encode(text(*p)), SamplingParams(
            max_new_tokens=TP_NEW, temperature=0.0)) for p in WORKER_PROMPTS]
        del eng
        departs = 0
        for p, out in zip(WORKER_PROMPTS, outs[pool]):
            departs += argmax_near_ties(
                torch.tensor(out, device="cuda"),
                plain_logits(params, cfg, tok.encode(text(*p)), out),
                f"(m)4 {pool} pages")
        same = sum(a == b for a, b in zip(one, outs[pool]))
        print(f"(m)4 {pool} pages: the gang's greedy tokens are each the "
              f"plain one-card forward's argmax or a near tie ({departs} "
              f"near-tie departures); {same} of {len(one)} completions "
              f"identical to the one-card paged engine's", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def tp_serve_70b(card: str) -> None:
    """(m)5: Llama-3-70B at all 80 layers and full width (bf16, 141 GB:
    more than one card holds), ``tp_serve_checked``."""
    tp_serve_checked(card, "(m)5", "70B", TP_MODEL_70B)


def tp_serve_checked(card: str, tag: str, name: str, model: dict,
                     plant: dict | None = None) -> None:
    """``tag``: ``model`` (``name``) as a ``{model: 4}`` ``model_server``
    gang on ``PAGED_SPEC``'s page pool:
    each rank's peak beside ``estimate_model_bytes / 4`` (weights and the
    pool's KV); ``TP_70B_PROMPTS`` greedy, sent at once, and held to a
    teacher-forced fp32 tensor-parallel forward over the same weights on
    the same cards (a second gang, ``tp_teacher_forced``): each token's
    gap to the top logit within the near-tie band plus twice its row's
    bf16 noise (the largest logit error of a bf16 forward, measured
    there), and the tokens' departures from its argmax at most twice a
    bf16 forward's, plus 2; the layer-by-layer drift of the bf16 forwards
    printed; ``uniform`` with 8 requests for TTFT and TPOT."""
    import tempfile

    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.repository import estimate_model_bytes

    cfg = preset(model["preset"], **model["overrides"])
    est = estimate_model_bytes(cfg, BatchingSpec(**PAGED_SPEC))
    label = f"{tag} {name} TP gang"
    tok = TokenIdText()
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_tp_") as base:
        gang = _tp_gang(model, PAGED_SPEC, label, base, plant=plant)
        ok = False
        try:
            t0 = time.perf_counter()
            outs = _tp_greedy(gang["url"], TP_70B_PROMPTS)
            print(f"{label}: ready in {gang['ready_s']:.1f} s; "
                  f"{len(outs)} greedy requests in "
                  f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
            sc = next(x for x in loadgen.standard_matrix(
                **dict(LOADGEN, num_requests=8)) if x.name == "uniform")
            run = loadgen.run_scenario(
                loadgen.ServerTarget(gang["url"], model="llama"), sc,
                vocab_size=cfg.vocab_size, max_prompt_len=1024)
            rep = loadgen.build_report(
                run, metrics_text=_get(gang["url"] + "/metrics")[1])
            report_line(f"uniform ({label}, ServerTarget)", rep, card)
            check_statuses(f"uniform ({label})", rep)
            ok = True
        finally:
            if not ok:
                _tp_gang_logs(gang)
                for p, _ in gang["procs"]:
                    p.kill()
        got = _tp_stop(gang, card)
        peaks = [c["peak"] for c in got["counts"]]
        print(f"{label}: peak per rank {[round(p / 2**30, 2) for p in peaks]}"
              f" GiB vs estimate_model_bytes / {TP_CARDS} "
              f"{est / TP_CARDS / 2**30:.2f} GiB (weights + KV at "
              f"{PAGED_SPEC['max_batch_size']} x "
              f"{PAGED_SPEC['max_seq_len']}); launches per rank "
              f"{[c['launches'] for c in got['counts']]}; {card}", flush=True)
        if max(peaks) > 80 * 2**30:
            fail(f"{label}: a rank's peak is past one card")
        dirs = [Path(base, "teacher", f"w{r}") for r in range(TP_CARDS)]
        secs = spawn_workers(
            "chip_smoke:tp_teacher_forced",
            {"model": model, "outputs": outs,
             "prompts": [tok.encode(text(*p)) for p in TP_70B_PROMPTS]},
            dirs, {"model": TP_CARDS}, f"{tag} teacher-forced TP forwards")
        res = json.loads((dirs[0] / "teacher.json").read_text())
    teacher_verdict(tag, cfg, res, secs, card)


def teacher_verdict(tag: str, cfg, res: dict, secs: float,
                    card: str) -> None:
    """``tp_teacher_forced``'s findings (``res``) printed, and its check:
    no served token's fp32 gap past the near-tie band plus twice its row's
    bf16 noise, and departures from the fp32 argmax at most twice a bf16
    forward's, plus 2."""
    depths = [i for i in TP_DRIFT_LAYERS if i <= cfg.n_layers]
    rel = {k: [f"{v[i]:.3e}" for i in depths]
           for k, v in res["rel_l2"].items()}
    d = res["departs"]
    noise = sorted(res["noise"])
    print(f"{tag} drift, rel L2 of the residual stream after blocks "
          f"{depths} (plain-fp32, served-fp32: each bf16 forward "
          f"from the fp32 one; plain-served: the two bf16 forwards): "
          f"{rel}; a row's largest bf16 logit error median "
          f"{noise[len(noise) // 2]:.4f}, max {noise[-1]:.4f}; fp32 gaps "
          f"of the served tokens that are not its argmax "
          f"{sorted(round(g, 4) for g in res['gaps'])}; {card}", flush=True)
    print(f"{tag}: argmax departures of {res['tokens']} tokens: served "
          f"tokens from the plain {d['tokens-plain']}, fp32 "
          f"{d['tokens-fp32']} and served-arithmetic {d['tokens-served']} "
          f"forwards; plain bf16 from fp32 {d['plain-fp32']}, served "
          f"arithmetic from fp32 {d['served-fp32']}, plain from served "
          f"arithmetic {d['plain-served']}; tokens past the fp32 near-tie "
          f"band plus twice their row's bf16 noise {res['bad'][:8]}; check "
          f"gang {secs:.1f} s; {card}", flush=True)
    if res["bad"]:
        fail(f"{tag}: a served token's fp32 gap to the top logit is past the "
             "near-tie band plus twice its row's bf16 noise")
    limit = 2 * max(d["plain-fp32"], d["served-fp32"]) + 2
    if d["tokens-fp32"] > limit:
        fail(f"{tag}: the served tokens depart from the fp32 forward's "
             f"argmax {d['tokens-fp32']} times, past {limit} (twice a bf16 "
             f"forward's departures, plus 2)")


# -- (m)6 disaggregated serving under tensor parallelism --------------------

#: (m)6's gangs are ``{model: ROLES_WAYS}``: the prefill gang on cards 0-1,
#: the decode gang on cards 2-3 (separate prefill and decode pools, the
#: layout disaggregated deployments run), the one-process decode worker
#: on card 2 and the unified gang on cards 0-1 beside the prefill gang.
ROLES_WAYS = 2
ROLES_CARDS = {"prefill": "0,1", "decode": "2,3", "worker": "2",
               "unified": "0,1"}
#: The decode gang's tiers: 64 host pages, 0.5 s to demote and 0.5 s more
#: to spill into a store under the phase's directory, a store deadline a
#: loaded host meets (one bf16 page blob of the 8B holds 16.8 MB).
ROLES_TIER = dict(host_kv_pages=64, kv_demote_after_s=0.5,
                  kv_remote_after_s=1.0, kv_remote_deadline_s=5.0)
#: The tier check's conversation: 700 tokens, 5 full pages of 128.
ROLES_TURN = (700, 97)
#: The serving kernels every rank of each gang must launch: a decode gang
#: runs no prefill, so no fused residual norm; the prefill gang decodes
#: in ``roles_fallback``. The paged chunk prefill attends its gathered
#: context plainly, as JAX's ``paged_chunk_prefill`` does, so the flash
#: forward's launches are printed, not required.
ROLES_KERNELS = {
    "prefill": ("rmsnorm_fwd", "add_rmsnorm_fwd", "swiglu_fwd",
                "paged_decode"),
    "decode": ("rmsnorm_fwd", "swiglu_fwd", "paged_decode"),
    "unified": ("rmsnorm_fwd", "add_rmsnorm_fwd", "swiglu_fwd",
                "paged_decode")}


def _handoff_counters(pre: str, dec: str) -> dict:
    """The pair's handoff counters: exported, failed and fallback on the
    prefill side, adopted on the decode side, and the KV bytes of each
    side's payloads."""
    out = {k: _series(pre if k != "adopted" else dec,
                      f"kftpu_engine_handoffs_{k}_total")
           for k in ("exported", "adopted", "failed", "fallback")}
    for k, url in (("exported", pre), ("adopted", dec)):
        out[f"bytes_{k}"] = _series(
            url, f"kftpu_engine_kv_handoff_bytes_{k}_total")
    return out


def _tier_counters(url: str) -> dict:
    return {k: _series(url, f"kftpu_engine_kv_{k}") for k in (
        "pages_demoted_total", "pages_promoted_total",
        "wire_bytes_promoted_total", "remote_demoted_bytes_total",
        "remote_promoted_bytes_total")}


def _resident_after(*urls) -> tuple:
    """Pages resident (in use or held for a handoff) on each server once
    its scheduler has applied the last acks (polled up to 10 s)."""
    for _ in range(100):
        got = tuple(_resident_pages(u) for u in urls)
        if not any(got):
            break
        time.sleep(0.1)
    return got


def roles_mixed(pre: str, dec: str, uni: str, card: str) -> dict:
    """``mixed_interference`` through the TP pair (the decode gang in
    ``X-Kftpu-Decode-Backend``) and then through the unified TP gang:
    every request of the pair ok, one export per request with tokens to
    decode and one adoption per export, no failed or fallback handoff, no
    page resident on either leader after; both report lines side by
    side."""
    import http.client

    from kubeflow_tpu_torch import loadgen

    c0 = _handoff_counters(pre, dec)
    target, stamped, base = _decode_backend_target(pre, dec)
    http.client.HTTPConnection = stamped
    try:
        run, rep = run_mixed(target, f"ServerTarget, (m)6 {{model: "
                             f"{ROLES_WAYS}}} prefill + decode gangs", card,
                             pre)
    finally:
        http.client.HTTPConnection = base
    c1 = _handoff_counters(pre, dec)
    moved = {k: c1[k] - c0[k] for k in c0}
    multi = sum(1 for o in run.outcomes if o.tokens > 1)
    resident = _resident_after(pre, dec)
    print(f"(m)6 mixed_interference through the pair: handoffs "
          f"{json.dumps(moved)}, requests with tokens to decode {multi}, "
          f"pages resident after (prefill, decode leaders) {resident}",
          flush=True)
    if rep["by_status"] != {"ok": rep["requests"]}:
        fail(f"(m)6 pair: statuses {rep['by_status']}")
    if not (moved["exported"] == moved["adopted"] == multi) or \
            moved["failed"] or moved["fallback"] or \
            moved["bytes_exported"] != moved["bytes_adopted"]:
        fail(f"(m)6 pair: handoff counters {moved} against {multi} requests "
             "with tokens to decode")
    if any(resident):
        fail(f"(m)6 pair: pages resident after the run {resident}")
    _, urep = run_mixed(loadgen.ServerTarget(uni, model="llama"),
                        f"ServerTarget, (m)6 unified {{model: {ROLES_WAYS}}} "
                        "gang", card, uni)
    check_statuses("(m)6 unified gang", urep)
    for label, r in (("unified gang", urep), ("prefill + decode gangs", rep)):
        print(f"(m)6 mixed_interference side by side, {{model: "
              f"{ROLES_WAYS}}} {label}: TTFT p50 {r['ttft_ms'].get('p50')} "
              f"p95 {r['ttft_ms'].get('p95')} ms, TPOT p50 "
              f"{r['tpot_ms'].get('p50')} p95 {r['tpot_ms'].get('p95')} ms, "
              f"{r['req_s']} req/s, {r['tokens_per_sec']} tokens/s; {card}",
              flush=True)
    return moved


def roles_tiers(pre: str, dec: str, label: str, card: str) -> None:
    """The decode gang's tiers: ``ROLES_TURN`` through the pair, then,
    once every cached page has left the decode gang's cards (demoted, and
    spilled to the store), the same turn again: the decode gang adopts it
    over the prefix it promotes back. The tokens must be the first pass's;
    the demote and promote counts and bytes are printed."""
    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    hdr = {DECODE_BACKEND_HEADER: dec}
    first = _tp_greedy(pre, [ROLES_TURN], headers=hdr)[0]
    c0 = _tier_counters(dec)
    t0 = time.perf_counter()
    while (_series(dec, "kftpu_engine_kv_pages_cached") > 0
           or _tier_counters(dec)["remote_demoted_bytes_total"]
           <= c0["remote_demoted_bytes_total"]):
        if time.perf_counter() - t0 > 60:
            fail(f"{label}: the decode gang's pages were not demoted and "
                 f"spilled within 60 s: {_tier_counters(dec)}")
        time.sleep(0.1)
    waited = time.perf_counter() - t0
    c1 = _tier_counters(dec)
    second = _tp_greedy(pre, [ROLES_TURN], headers=hdr)[0]
    c2 = _tier_counters(dec)
    demoted = {k: c1[k] - c0[k] for k in c0}
    promoted = {k: c2[k] - c1[k] for k in c0}
    print(f"{label} tiers: turn of {ROLES_TURN[0]} tokens, then demoted and "
          f"spilled in {waited:.1f} s ({json.dumps(demoted)}), then the "
          f"same turn promoted back ({json.dumps(promoted)}); tokens "
          f"{'identical' if first == second else 'DIFFERENT'}; {card}",
          flush=True)
    if second != first:
        fail(f"{label}: tokens after promotion {second} differ from {first}")
    if promoted["wire_bytes_promoted_total"] <= 0:
        fail(f"{label}: the second pass promoted nothing: {promoted}")


def roles_stop(gang: dict, role: str, card: str, label: str) -> dict:
    """``_tp_stop``, then each rank's launches and peak: the serving
    kernels of ``role`` (``ROLES_KERNELS``) must have launched on every
    rank."""
    got = _tp_stop(gang, card)
    print(f"{label}: launches per rank "
          f"{[c['launches'] for c in got['counts']]}; peak per rank "
          f"{[round(c['peak'] / 2**30, 2) for c in got['counts']]} GiB; ops "
          f"by name {json.dumps(got['by_op'])}; {card}", flush=True)
    for c in got["counts"]:
        if not all(c["launches"][k] for k in ROLES_KERNELS[role]):
            fail(f"{label}: a serving kernel launched no time on a rank: "
                 f"{c['launches']}")
    return got


def roles_fallback(pre: str, dec: str, want: list[int], label: str) -> None:
    """With the decode gang gone, a prompt through the prefill gang still
    gives its tokens (recomputed there) and counts one fallback."""
    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    fb0 = _series(pre, "kftpu_engine_handoffs_fallback_total")
    got = _tp_greedy(pre, WORKER_PROMPTS[:1],
                     headers={DECODE_BACKEND_HEADER: dec})[0]
    fb = _series(pre, "kftpu_engine_handoffs_fallback_total") - fb0
    print(f"{label} fallback with the decode gang gone: tokens "
          f"{'identical to' if got == want else 'differ from'} the pair's, "
          f"fallback counter +{fb:.0f}", flush=True)
    if got != want or fb != 1:
        fail(f"{label} fallback: tokens {got}, counter +{fb}")


def roles_round(pool: str, spec: dict, base: str, card: str) -> dict:
    """One pool dtype of (m)6: the prefill and decode gangs (and, for bf16
    pages, the one-process decode worker and the unified gang) started
    together; ``WORKER_PROMPTS`` greedy through the pair (bf16: through
    the prefill gang to the worker, and through the unified gang);
    ``roles_mixed`` (bf16); ``roles_tiers``; every server stopped (the
    decode side first, then ``roles_fallback``). Returns the greedy
    completions by route."""
    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    full = pool == "bf16"
    label = f"(m)6 {pool} pages"
    gangs = {"prefill": _tp_gang_start(
        WORKER_MODEL, dict(spec, role="prefill"), f"{label} prefill gang",
        base, ways=ROLES_WAYS, cards=ROLES_CARDS["prefill"]),
        "decode": _tp_gang_start(
        WORKER_MODEL, dict(spec, role="decode", **ROLES_TIER,
                           remote_kv_root=str(Path(base, f"kv-{pool}"))),
        f"{label} decode gang", base, ways=ROLES_WAYS,
        cards=ROLES_CARDS["decode"])}
    gangs["unified"] = _tp_gang_start(
        WORKER_MODEL, spec, f"{label} unified gang", base, ways=ROLES_WAYS,
        cards=ROLES_CARDS["unified"])
    worker = None
    if full:
        worker = spawn_worker(dict(spec, role="decode"), "roles-decode",
                              env_extra={"CUDA_VISIBLE_DEVICES":
                                         ROLES_CARDS["worker"]})
    t0 = time.perf_counter()
    outs, ok, stopped = {}, False, set()
    try:
        for g in gangs.values():
            _tp_gang_ready(g)
        ready = {k: round(g["ready_s"], 1) for k, g in gangs.items()}
        if worker is not None:
            ready["worker"] = round(wait_ready(worker[0], worker[1],
                                               "(m)6 decode worker", t0), 1)
        pre, dec = gangs["prefill"]["url"], gangs["decode"]["url"]
        t1 = time.perf_counter()
        # On int8 pages a prompt's tokens depend on whether its first token
        # hit another prompt's cached prefix (read quantized from the pool)
        # or was computed in its own chunk, so on the admission order (the
        # JAX engine's design: tests/test_torch_admission_order.py): the
        # pair and the unified gang get the prompts one at a time, in one
        # order, for their exact comparison.
        seq = not full
        outs["pair"] = _tp_greedy(pre, WORKER_PROMPTS,
                                  headers={DECODE_BACKEND_HEADER: dec},
                                  one_at_a_time=seq)
        print(f"{label}: ready in {json.dumps(ready)} s; greedy through the "
              f"pair {outs['pair']} in {time.perf_counter() - t1:.1f} s; "
              f"{card}", flush=True)
        outs["unified"] = _tp_greedy(gangs["unified"]["url"],
                                     WORKER_PROMPTS, one_at_a_time=seq)
        if full:
            outs["cross"] = _tp_greedy(
                pre, WORKER_PROMPTS,
                headers={DECODE_BACKEND_HEADER: worker[1]})
        for route, what in (("unified", "the unified gang's"),
                            ("cross", "the prefill gang to the one-process "
                                      "worker's")):
            if route in outs:
                same = sum(a == b for a, b in zip(outs[route], outs["pair"]))
                print(f"{label}: {same} of {len(WORKER_PROMPTS)} completions "
                      f"of the pair identical to {what}", flush=True)
        if outs["pair"] != outs["unified"]:
            # The same TP arithmetic on the same weights: only where the
            # KV lives differs.
            fail(f"{label}: the pair's greedy tokens are not the unified "
                 "gang's")
        if full:
            roles_mixed(pre, dec, gangs["unified"]["url"], card)
        roles_tiers(pre, dec, label, card)
        stopped.add("unified")
        roles_stop(gangs["unified"], "unified", card, f"{label} unified gang")
        if full:
            sigterm_worker(worker[0], worker[1], "(m)6 decode worker")
        stopped.add("decode")   # _tp_stop closes the logs, pass or fail
        got = roles_stop(gangs["decode"], "decode", card,
                         f"{label} decode gang")
        ups = got["by_op"].get("upload_pages", 0)
        moved = got["sent"].get("upload_pages", 0)
        print(f"{label} decode gang: {ups} page uploads (adoptions and "
              f"promotions) sent {moved} bytes to each follower, "
              f"{moved / max(ups, 1):.0f} an upload: whole-model blocks, "
              f"padded to a power of two of pages (each rank keeps 1/"
              f"{ROLES_WAYS} of the heads); the export gathers read "
              f"{got['by_op'].get('gather_pages', 0)} times on the decode "
              f"gang (demotions); {card}", flush=True)
        roles_fallback(pre, dec, outs["pair"][0], label)
        stopped.add("prefill")
        roles_stop(gangs["prefill"], "prefill", card,
                   f"{label} prefill gang")
        ok = True
    finally:
        if not ok:
            for k, g in gangs.items():
                if k not in stopped:
                    _tp_gang_logs(g)
                    for p, _ in g["procs"]:
                        p.kill()
        if worker is not None:
            reap_worker(worker[0], worker[2], "(m)6 decode worker", ok)
    return outs


def tp_roles_serve(card: str) -> None:
    """(m)6: disaggregated serving under tensor parallelism, Llama-3-8B at
    full width and depth (``WORKER_MODEL``, bf16 weights from the serving
    seed, ``PAGED_SPEC``) on bf16 pages and then int8 pages
    (``roles_round``): a ``{model: 2}`` prefill gang on cards 0-1 hands
    off to a ``{model: 2}`` decode gang on cards 2-3 with the host and
    remote KV tiers, and (bf16) to a one-process decode worker on card 2,
    beside a unified ``{model: 2}`` gang, whose greedy tokens the pair's
    must equal. Then the greedy tokens of the pair (both pools) and of the
    cross-layout route are held as (m)5 holds its own
    (``tp_teacher_forced`` on a ``{model: 2}`` check gang,
    ``teacher_verdict``): a plain one-card forward's near-tie band is
    tighter than the distance between two bf16 forwards that sum their
    partial products in different orders."""
    import tempfile

    from kubeflow_tpu_torch.models.config import preset

    outs = {}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_tp_") as base:
        for pool, over in (("bf16", {}), ("int8", {"kv_cache_dtype": "int8"})):
            outs[pool] = roles_round(pool, dict(PAGED_SPEC, **over), base,
                                     card)
        routes = (("bf16 pages, pair", outs["bf16"]["pair"]),
                  ("bf16 pages, prefill gang to worker",
                   outs["bf16"]["cross"]),
                  ("int8 pages, pair", outs["int8"]["pair"]))
        tok = TokenIdText()
        dirs = [Path(base, "teacher", f"w{r}") for r in range(ROLES_WAYS)]
        secs = spawn_workers(
            "chip_smoke:tp_teacher_forced",
            {"model": WORKER_MODEL,
             "outputs": [o for _, got in routes for o in got],
             "prompts": [tok.encode(text(*p)) for _ in routes
                         for p in WORKER_PROMPTS]},
            dirs, {"model": ROLES_WAYS}, "(m)6 teacher-forced TP forwards",
            {"CUDA_VISIBLE_DEVICES": ROLES_CARDS["prefill"]})
        res = json.loads((dirs[0] / "teacher.json").read_text())
    print(f"(m)6 teacher-forced check over {', '.join(n for n, _ in routes)}"
          f" ({len(routes) * len(WORKER_PROMPTS)} completions)", flush=True)
    teacher_verdict("(m)6", preset(WORKER_MODEL["preset"],
                                   **WORKER_MODEL["overrides"]),
                    res, secs, card)


#: The order probe's co-residents of prompt 0 in one decode step: (row,
#: prompt, pages) of the other two ``WORKER_PROMPTS``.
ORDER_PROBE_OTHERS = ((1, 1, (20, 21, 22)), (2, 2, (30, 31, 32, 33, 34, 35)))


def admission_order_probe(card: str) -> None:
    """(m)6's order probe, one card, no gang: whether the paged engine's greedy
    output for a prompt depends on the order its requests are admitted in,
    as concurrent HTTP requests race to a gang. The 8B at full depth
    (``WORKER_MODEL``, random weights, ``PAGED_SPEC``), int8 and bf16 pages:
    the ``WORKER_PROMPTS`` one at a time, then all three submitted before
    the first scheduler step in each of the six orders; the completions
    equal to the one-at-a-time ones are counted, the first departing
    position printed, and beside them each prompt's cached tokens at
    admission: a prompt admitted after another's prefill reads the shared
    first token's K/V from that prompt's page (quantized on int8 pages), one
    admitted in the same round computes it in its own chunk, as JAX's engine
    does (tests/test_torch_admission_order.py). Then one decode step of
    prompt 0 at its first decode position, its KV on page 0 or 7, in row 0,
    1 or 2, alone or with the other two prompts live, must give bitwise the
    same logits: the order dependence does not enter through a row, a page
    or a co-resident of one step."""
    import itertools

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serve.paged import (
        _paged_decode_step, context_bucket, paged_chunk_prefill,
    )
    from kubeflow_tpu_torch.serve.storage import load_params

    cfg = preset(WORKER_MODEL["preset"], **WORKER_MODEL["overrides"])
    params = load_params("random://", cfg, device="cuda")
    tok = TokenIdText()
    prompts = [tok.encode(text(*p)) for p in WORKER_PROMPTS]
    sp = SamplingParams(max_new_tokens=TP_NEW, temperature=0.0)
    i32 = dict(dtype=torch.int32, device="cuda")
    for pool, over in (("int8", {"kv_cache_dtype": "int8"}), ("bf16", {})):
        spec = BatchingSpec(**dict(PAGED_SPEC, **over))

        def engine(covered: dict):
            """A fresh engine recording each prompt's cached tokens (its
            prefix read from another prompt's pages) at admission."""
            eng = LLMEngine(cfg, spec, params=params, seed=SEED,
                            device="cuda")
            match = eng._kv_match

            def recorded(req, **kw):
                pages, n = match(req, **kw)
                covered[prompts.index(list(req.prompt_tokens))] = n
                return pages, n

            eng._kv_match = recorded
            return eng

        alone_cov: dict = {}
        eng = engine(alone_cov)
        alone = [eng.generate(p, sp) for p in prompts]
        departs, same_cov, covs = [], 0, {}
        for order in itertools.permutations(range(len(prompts))):
            cov: dict = {}
            eng = engine(cov)
            reqs = {i: eng.submit(prompts[i], sp) for i in order}
            while not all(r.done.is_set() for r in reqs.values()):
                eng.step()
            covs["".join(map(str, order))] = [cov[i] for i in range(3)]
            for i, r in sorted(reqs.items()):
                got = r.result(1)
                if got != alone[i]:
                    at = next(j for j, (a, b) in enumerate(zip(got, alone[i]))
                              if a != b)
                    departs.append((order, i, at))
                    same_cov += cov[i] == alone_cov[i]
        print(f"(m)6 order probe, {pool} pages: {len(departs)} of "
              f"{6 * len(prompts)} completions over the six admission "
              f"orders differ from the one-at-a-time ones, (order, prompt, "
              f"first departing token) {departs}; each prompt's cached "
              f"tokens at admission (its first token's K/V read from "
              f"another prompt's page, or computed in its own chunk) one at "
              f"a time {[alone_cov[i] for i in range(3)]}, by order {covs}; "
              f"departing completions whose prompt was cached as it was one "
              f"at a time: {same_cov}; {card}", flush=True)
        if pool == "bf16" and departs:
            fail("(m)6 order probe: bf16 pages' greedy tokens depend on the "
                 "admission order")
        cache, chunk = eng.cache, eng.chunk_size
        mpp, pg = eng._mpp, eng.page_size
        b = PAGED_SPEC["max_batch_size"]

        def prefill(p: int, pages) -> int:
            row = torch.full((mpp,), -1, **i32)
            row[:len(pages)] = torch.tensor(pages, **i32)
            toks, first = prompts[p], None
            for start in range(0, len(toks), chunk):
                real = min(chunk, len(toks) - start)
                logits = paged_chunk_prefill(
                    params, cache, torch.tensor(
                        [toks[start:start + real] + [0] * (chunk - real)],
                        device="cuda"), row, start, real, eng._cfg_prefill,
                    context_pages=context_bucket(start, chunk, pg, mpp))
                first = int(logits[real - 1].argmax())
            return first

        def step(rows: dict) -> dict:
            table = torch.full((b, mpp), -1, **i32)
            toks = torch.zeros(b, dtype=torch.int64, device="cuda")
            lengths = torch.zeros(b, dtype=torch.int64, device="cuda")
            live = torch.zeros(b, dtype=torch.bool, device="cuda")
            for r, (p, pages, t) in rows.items():
                table[r, :len(pages)] = torch.tensor(pages, **i32)
                toks[r], lengths[r], live[r] = t, len(prompts[p]), True
            out = _paged_decode_step(params, {**cache, "table": table}, toks,
                                     lengths, live, eng._cfg_decode,
                                     attn_impl=eng.paged_attn_impl)
            return {r: out[r].clone() for r in rows}

        with torch.no_grad():
            first = prefill(0, (0,))
            if prefill(0, (7,)) != first:
                fail(f"(m)6 order probe, {pool} pages: prompt 0's first "
                     "token depends on its page")
            others = {r: (p, pages, prefill(p, pages))
                      for r, p, pages in ORDER_PROBE_OTHERS}
            want = step({0: (0, (0,), first)})[0]
            same = []
            for r, page, crowd in itertools.product((0, 1, 2), (0, 7),
                                                    (False, True)):
                rows = {r: (0, (page,), first)}
                if crowd:
                    free = [x for x in range(b) if x != r]
                    rows.update({free[k]: v for k, v in
                                 enumerate(others.values())})
                same.append(torch.equal(step(rows)[r], want))
        print(f"(m)6 order probe, {pool} pages: one decode step of prompt 0 "
              f"bitwise equal in {sum(same)} of {len(same)} placements (row "
              f"0-2, page 0 or 7, alone or with the other prompts live); "
              f"{card}", flush=True)
        if not all(same):
            fail(f"(m)6 order probe, {pool} pages: one decode step depends "
                 "on its row, page or co-residents")
        del eng, cache
        gc.collect()
        torch.cuda.empty_cache()


def phase_tp(rows: list[dict], card: str, *, cards_only: bool = False
             ) -> None:
    """(m): tensor parallelism over the model axis — (m)1 and (m)2 in
    lockstep on one card (not with ``cards_only``), then on a machine of
    ``TP_CARDS`` cards or more: (m)4 and (m)5 the TP serving gangs, (m)6
    disaggregated serving over two TP gangs, then (m)3 ``llm_pretrain`` on
    ``{model: 4}`` and ``{fsdp: 2, model: 2}``."""
    if not cards_only:
        timed_phase("tp block", tp_block_lockstep, rows, card)
        timed_phase("tp xent", tp_xent_lockstep, rows, card)
    count = torch.cuda.device_count()
    if count < TP_CARDS:
        print(f"(m)3-(m)6 tensor parallelism over {TP_CARDS} cards: not run "
              f"— this machine has {count} card; {card}", flush=True)
        return
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("tp serve 8b", tp_serve_8b, card)
    timed_phase("tp profile", tp_profile, card)
    timed_phase("tp serve 70b", tp_serve_70b, card)
    timed_phase("tp roles", tp_roles_serve, card)
    timed_phase("tp train", card_world_runs, "(m)3", card,
                (({"model": TP_CARDS}, "pallas"),
                 ({"fsdp": 2, "model": 2}, "pallas")), None, True)


# -- (n) MoE on a mesh: the expert axis ---------------------------------------

#: (n)1: a Mixtral-width MoE block (bf16) on 2 batch shards of EP_T tokens
#: each, capacity factor 1.0 (pairs drop), split over expert (and model),
#: the ranks run one after another on this card.
EP_T = 2048
EP_SHARDS = 2
#: (n)1's splits: (expert ways, model ways).
EP_SPLITS = ((4, 1), (2, 2))
EP_REL_L2 = 1e-2
EP_AUX_REL = 1e-5
#: (n)2: ``llm_pretrain`` at Mixtral width over NCCL, fused on, 3 steps of
#: 4 x 1024 tokens, against an in-process one-card run on the same global
#: batches (the limits of (l)4 and (m)3); then {expert: 4} at EP_DEEP
#: layers for EP_DEEP_STEPS steps.
EP_TRAIN_MODEL = dict(n_layers=2, remat_policy="nothing_saveable")
EP_TRAIN_DATA = dict(seq_len=1024, global_batch=4)
EP_DEEP = 6
EP_DEEP_STEPS = 6
#: (n)3: Mixtral-8x7B at 32 layers in bf16 (93.4 GB: more than one card
#: holds) on {model: 4}, every expert's columns split four ways. Prefill
#: and decode run the drop-free dense expert path, as vLLM's fused MoE
#: drops no token; the teacher-forced check's forwards take the same path.
EP_MODEL_MIXTRAL = {"preset": "mixtral-8x7b",
                    "overrides": {"param_dtype": "bfloat16",
                                  "moe_impl": "dense"}}


def _ep_cut(p: dict, ways: tuple[int, int], e: int, m: int) -> dict:
    """Rank (e, m)'s expert leaves of an MoE block on ``{expert: ways[0],
    model: ways[1]}`` (the training rules' specs; differentiable in the
    whole leaf); the router stays whole."""
    from kubeflow_tpu_torch.parallel.sharding import cut_local

    specs = {"gate": ("expert", None, "model"), "up": ("expert", None,
                                                       "model"),
             "down": ("expert", "model", None)}
    sizes = {"expert": ways[0], "model": ways[1]}
    coords = {"expert": e, "model": m}
    return {k: cut_local(v, specs[k], sizes, coords) if k in specs else v
            for k, v in p.items()}


def ep_split_block(p: dict, x: torch.Tensor, cfg, ways: tuple[int, int], *,
                   per_rank_plan: bool = False, own_router: bool = False):
    """The ranks of ``{data: EP_SHARDS, expert, model}`` in lockstep on one
    card: each batch shard routes once (the router and its input are
    whole on the ranks of one expert × model group, so autograd sums the
    ranks' gradients of them as ``collectives.copy_to``'s backward does);
    the shards' expert ids are put together in the global (b, s) order
    (``layers.global_choices``' all-gather), and each rank plans its
    pairs over the global batch (``layers.dispatch_plan``) and computes
    its experts' columns for its shard (``layers.expert_dispatch``); the
    partial outputs are summed (``reduce_from``'s all-reduce). The balance
    loss is each shard's part, the claim counts summed over the shards
    (``layers._moe_aux_loss``). Returns (out [B, S, D], summed aux parts,
    each shard's keep [k, S], the router's gradient leaves).

    Planted faults: ``per_rank_plan`` plans each shard's pairs alone, at
    its own capacity; ``own_router`` gives every rank its own router
    (whose combine weights see only its experts) and keeps the gradient
    of rank (shard, 0, 0)'s alone, as a mesh does whose router gradient is
    not summed over the expert × model group."""
    from kubeflow_tpu_torch.models import layers as L

    k, e = cfg.experts_per_token, cfg.num_experts
    shards = x.chunk(EP_SHARDS, dim=0)
    b = shards[0].shape[0]
    routers = []

    def route(xs):
        r = p["router"]
        if own_router:
            r = r.detach().requires_grad_(True)
            routers.append(r)
        return L.moe_route({"router": r}, xs, cfg)

    shared = [route(xs) for xs in shards]
    ids = torch.cat([idx for _, _, idx in shared]).reshape(-1, k)
    tg = ids.shape[0]
    counts = torch.nn.functional.one_hot(ids, e).float().sum(dim=(0, 1))
    outs, keeps, aux = [], [], 0.0
    cuts = {(em, mm): _ep_cut(p, ways, em, mm) for em in range(ways[0])
            for mm in range(ways[1])}
    for si, xs in enumerate(shards):
        logits, w, idx = shared[si]
        t = idx.shape[0] * idx.shape[1]
        mine = torch.arange(si * t, (si + 1) * t, device=x.device)
        choices = ((idx.reshape(-1, k), None) if per_rank_plan
                   else (ids, mine))
        out = 0
        for (em, mm), pc in cuts.items():
            if own_router and (em, mm) != (0, 0):
                w = route(xs)[1]
            plan = L.dispatch_plan(idx, cfg, None, L.MoEAxes(
                expert=em, experts=ways[0]), choices)
            out = out + L.expert_dispatch(pc, xs, w, plan, cfg)
            if (em, mm) == (0, 0):
                keeps.append(plan["keep"].reshape(k, -1))
        outs.append(out)
        probs = torch.softmax(logits, dim=-1).sum(dim=(0, 1))
        aux = aux + e * torch.sum(counts / tg * probs / tg)
    # The shards' own routes came first: rank (shard, 0, 0)'s routers.
    grads = routers[:EP_SHARDS] if own_router else [p["router"]]
    return torch.cat(outs), aux, keeps, grads


def ep_block_lockstep(card: str) -> None:
    """(n)1: one Mixtral-width MoE block (D 4096, M 14336, 8 experts,
    top-2, bf16 weights and activations) on T = EP_SHARDS x EP_T tokens,
    capacity factor 1.0, split over ``{expert: 4}`` and ``{expert: 2,
    model: 2}`` with EP_SHARDS batch shards (``ep_split_block``), against
    the unsplit block over the whole batch (``layers.moe_block``): the
    kept-pair set exactly equal, the output and every gradient of
    ``sum(out · dy) + 0.01 · aux`` (x, router, gate, up, down) within rel
    L2 EP_REL_L2, the aux parts' sum within EP_AUX_REL. Both planted
    faults must fail their check: a per-rank plan (the kept set), and an
    unsummed router gradient (its rel L2)."""
    import dataclasses

    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import preset

    cfg = dataclasses.replace(preset("mixtral-8x7b"), capacity_factor=1.0)
    k = cfg.experts_per_token
    gen = torch.Generator("cuda").manual_seed(SEED + 95)
    p = {n: t.requires_grad_(True)
         for n, t in L.init_moe(gen, cfg, torch.bfloat16).items()}
    x = torch.randn((EP_SHARDS, EP_T, cfg.hidden), generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_(True)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    names = ("x", "router", "gate", "up", "down")
    leaves = [x] + [p[n] for n in names[1:]]

    def grads_of(out, aux, extra=()):
        loss = (out.float() * dy.float()).sum() + 0.01 * aux
        return torch.autograd.grad(loss, leaves + list(extra),
                                   allow_unused=True)

    out1, aux1 = L.moe_block(p, x, cfg)
    g1 = grads_of(out1, aux1)
    aux_ref = float(aux1.detach())
    with torch.no_grad():
        keep1 = L.dispatch_plan(L.moe_route(p, x, cfg)[2], cfg)["keep"]
    keep1 = keep1.reshape(k, EP_SHARDS, EP_T)
    dropped = int((~keep1).sum())
    for ways in EP_SPLITS:
        name = f"(n)1 {{data: {EP_SHARDS}, expert: {ways[0]}" + (
            f", model: {ways[1]}}}" if ways[1] > 1 else "}")
        out, aux, keeps, _ = ep_split_block(p, x, cfg, ways)
        g = grads_of(out, aux)
        differ = sum(int((kp != keep1[:, i]).sum())
                     for i, kp in enumerate(keeps))
        rels = {"out": rel_l2(out.detach(), out1.detach())}
        rels.update({n: rel_l2(a, b) for n, a, b in zip(names, g, g1)})
        aux = float(aux.detach())
        aux_rel = abs(aux - aux_ref) / abs(aux_ref)
        # The planted faults.
        _, _, bad_keeps, _ = ep_split_block(p, x, cfg, ways,
                                            per_rank_plan=True)
        bad_differ = sum(int((kp != keep1[:, i]).sum())
                         for i, kp in enumerate(bad_keeps))
        out_f, aux_f, _, routers = ep_split_block(p, x, cfg, ways,
                                                  own_router=True)
        gf = grads_of(out_f, aux_f, routers)
        bad_router = rel_l2(sum(gf[len(leaves):]), g1[1])
        del out_f, aux_f, gf
        print(f"{name} in lockstep vs the unsplit block (Mixtral width, "
              f"bf16, T={EP_SHARDS}x{EP_T}, capacity factor "
              f"{cfg.capacity_factor}: {dropped} of {keep1.numel()} pairs "
              f"dropped): kept pairs differing {differ}; rel L2 "
              + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
              + f" (tolerance {EP_REL_L2:g}); aux {aux:.6f} vs "
              f"{aux_ref:.6f} (rel {aux_rel:.3e}, tolerance "
              f"{EP_AUX_REL:g}); planted faults: a per-rank plan keeps "
              f"{bad_differ} pairs differently, an unsummed router "
              f"gradient reads rel L2 {bad_router:.3e}; {card}", flush=True)
        if differ:
            fail(f"{name}: the split plan keeps other pairs than the "
                 f"unsplit block's")
        bad = {n: v for n, v in rels.items() if not v <= EP_REL_L2}
        if bad or not aux_rel <= EP_AUX_REL:
            fail(f"{name}: the split block is off the unsplit one: {bad}, "
                 f"aux rel {aux_rel:.3e}")
        if not bad_differ:
            fail(f"{name}: the kept-set check passes a per-rank plan")
        if bad_router <= EP_REL_L2:
            fail(f"{name}: the gradient check passes an unsummed router "
                 "gradient")
    if not dropped:
        fail("(n)1: no pair dropped; the plans cannot differ")
    del p, x, dy, g1, out1
    gc.collect()
    torch.cuda.empty_cache()


def counted_ep_pretrain(ctx) -> int:
    """(n)2's worker entrypoint (``chip_smoke:counted_ep_pretrain``):
    ``counted_llm_pretrain`` with each MoE block's balance loss recorded
    (the forward's and the backward's replay), written per step and layer
    to ``aux.json`` in the workdir."""
    from kubeflow_tpu_torch.models import layers as L

    block, seen = L.moe_block, []

    def recorded(*args, **kwargs):
        out, aux = block(*args, **kwargs)
        seen.append(aux.detach())
        return out, aux

    L.moe_block = recorded
    try:
        rc = counted_llm_pretrain(ctx)
    finally:
        L.moe_block = block
    n = ctx.config["model_overrides"]["n_layers"]
    vals = [float(a) for a in seen]
    steps = [vals[i:i + n] for i in range(0, len(vals), 2 * n)]
    Path(ctx.env.workdir, "aux.json").write_text(json.dumps(steps))
    return rc


def _ep_trainer_cfg(n_layers: int, steps: int):
    return _trainer_cfg(steps=steps, name="mixtral-8x7b",
                        base=dict(EP_TRAIN_MODEL, n_layers=n_layers),
                        data=EP_TRAIN_DATA, fused_kernels="on")


def _ep_gang(cfg, axes: dict, label: str) -> dict:
    """``counted_ep_pretrain`` of ``cfg`` over NCCL on ``axes``: the
    coordinator's metrics rows, every rank's counts and aux rows, and the
    gang's seconds."""
    import dataclasses
    import tempfile

    world = math.prod(axes.values())
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_train_") as base:
        dirs = [Path(base, f"w{r}") for r in range(world)]
        secs = spawn_workers("chip_smoke:counted_ep_pretrain",
                             dataclasses.asdict(cfg), dirs, axes, label)
        return {"rows": [json.loads(x) for x in (dirs[0] / "metrics.jsonl")
                         .read_text().splitlines()],
                "counts": [json.loads((d / "counts.json").read_text())
                           for d in dirs],
                "aux": [json.loads((d / "aux.json").read_text())
                        for d in dirs],
                "secs": secs, "world": world}


def ep_train(card: str) -> None:
    """(n)2: ``llm_pretrain`` over NCCL at Mixtral width (2 layers, fused
    on, ``nothing_saveable``, 3 steps of 4 x 1024 tokens) on ``{expert:
    4}`` (two experts a card, the batch whole on each) and ``{data: 2,
    expert: 2}``, each against an in-process one-card run on the same
    global batches: losses within MULTI_CARD_LOSS_REL, the step-1 grad
    norm within MULTI_CARD_GRAD_NORM_REL, every training kernel of the
    MoE path launched on every rank. Then ``{expert: 4}`` at EP_DEEP
    layers, which one card cannot hold, for EP_DEEP_STEPS steps: the loss
    finite and falling; each layer's balance loss, and the peak per card
    beside ``estimate_model_bytes``."""
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.repository import estimate_model_bytes

    want = {n for n, c in _want_per_step(True, 2, moe=True).items() if c}
    nan = float("nan")
    for axes in ({"expert": TP_CARDS}, {"data": 2, "expert": 2}):
        cfg = _ep_trainer_cfg(2, MULTI_STEPS)
        label = f"(n)2 llm_pretrain {axes}"
        got = _ep_gang(cfg, axes, label)
        rows, counts = got["rows"], got["counts"]
        dp = axes.get("data", 1)
        refs, ref_norms = _global_batch_run(cfg, dp)
        losses = [r["loss"] for r in rows]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, refs))
        rel_norm = abs(rows[0]["grad_norm"] - ref_norms[0]) / ref_norms[0]
        print(f"{label} over NCCL, Mixtral width, 2 layers, fused on: exit "
              f"0 in {got['secs']:.1f} s; backends "
              f"{sorted({c['backend'] for c in counts})}; losses {losses} vs "
              f"in-process one card on the same global batches {refs} (max "
              f"rel {rel:.3e}, tolerance {MULTI_CARD_LOSS_REL:g}); step-1 "
              f"grad norm {rows[0]['grad_norm']} vs {ref_norms[0]} (rel "
              f"{rel_norm:.3e}, tolerance {MULTI_CARD_GRAD_NORM_REL:g}); "
              f"aux_loss {[r['aux_loss'] for r in rows]}; step ms "
              f"{[round(r.get('step_time_ms', nan), 1) for r in rows]}; "
              f"peak per rank "
              f"{[round(c['peak'] / 2**30, 2) for c in counts]} GiB; "
              f"launches per rank {[c['launches'] for c in counts]}; {card}",
              flush=True)
        if len({c["device"] for c in counts}) != got["world"] or any(
                c["backend"] != "nccl" for c in counts):
            fail(f"{label}: the ranks are not one NCCL world over distinct "
                 "cards")
        if any(not c["launches"][n] for c in counts for n in want):
            fail(f"{label}: a training kernel of the MoE path launched no "
                 "time on a rank")
        if not rel <= MULTI_CARD_LOSS_REL:
            fail(f"{label}: the losses are off the one-card run's")
        if not rel_norm <= MULTI_CARD_GRAD_NORM_REL:
            fail(f"{label}: the step-1 grad norm is off the one-card run's")
    cfg = _ep_trainer_cfg(EP_DEEP, EP_DEEP_STEPS)
    label = f"(n)2 llm_pretrain {{expert: {TP_CARDS}}} at {EP_DEEP} layers"
    got = _ep_gang(cfg, {"expert": TP_CARDS}, label)
    losses = [r["loss"] for r in got["rows"]]
    mcfg = preset("mixtral-8x7b", **cfg.model_overrides)
    whole = estimate_model_bytes(mcfg)
    e = mcfg.num_experts
    local = mcfg.num_params() - mcfg.n_layers * (e - e // TP_CARDS) * 3 \
        * mcfg.hidden * mcfg.mlp_dim
    print(f"{label} ({mcfg.num_params() / 1e9:.3f} B params, "
          f"{local / 1e9:.3f} B on a rank; estimate_model_bytes "
          f"{whole / 2**30:.2f} GiB (fp32 weights with 10% headroom), a "
          f"rank's params, grads and Adam moments at 16 B "
          f"{local * 16 / 2**30:.2f} GiB): losses "
          f"{losses}; aux per layer, rank 0, by step {got['aux'][0]}; step "
          f"ms {[round(r.get('step_time_ms', nan), 1) for r in got['rows']]}"
          f"; tokens/s "
          f"{[round(r.get('tokens_per_sec', nan), 1) for r in got['rows']]}"
          f"; peak per rank "
          f"{[round(c['peak'] / 2**30, 2) for c in got['counts']]} GiB; "
          f"{got['secs']:.1f} s; {card}", flush=True)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < \
            losses[0]:
        fail(f"{label}: the loss is not finite and falling: {losses}")
    ref = [v for step in got["aux"][0] for v in step]
    for a in got["aux"][1:]:
        if any(abs(u - v) > 1e-6 * abs(v)
               for u, v in zip([v for step in a for v in step], ref)):
            fail(f"{label}: the ranks' balance losses differ")


def ep_serve_mixtral(card: str) -> None:
    """(n)3: Mixtral-8x7B at all 32 layers in bf16 (93.4 GB) as a
    ``{model: 4}`` ``model_server`` gang, ``tp_serve_checked``."""
    tp_serve_checked(card, "(n)3", "Mixtral-8x7B", EP_MODEL_MIXTRAL)


#: The planted fault of ``--ep-fault-cards-only``: rank 1's shard of
#: expert 0's down weight, in every layer, doubled (a partial summed twice).
EP_FAULT = {"rank": 1, "expert": 0, "scale": 2.0}


def ep_fault_mixtral(card: str) -> None:
    """(n)3 with ``EP_FAULT`` planted in the served gang (the check gang
    loads the clean weights): (n)3's token check must fail. Exits 0 when
    it does, nonzero when the check passes the fault."""
    try:
        tp_serve_checked(card, "(n)3 planted", "Mixtral-8x7B",
                         EP_MODEL_MIXTRAL, plant=EP_FAULT)
    except SystemExit:
        print(f"(n)3 planted fault {json.dumps(EP_FAULT)}: the token check "
              f"failed, as it must; {card}", flush=True)
        return
    fail(f"(n)3's token check passed with the fault {EP_FAULT} planted")


def phase_ep(card: str, *, cards_only: bool = False) -> None:
    """(n): MoE on a mesh — (n)1 in lockstep on one card (not with
    ``cards_only``), then on a machine of ``TP_CARDS`` cards or more:
    (n)2 MoE training over NCCL on the expert axis, (n)3 Mixtral-8x7B
    served in bf16 over ``{model: 4}``."""
    if not cards_only:
        timed_phase("ep block", ep_block_lockstep, card)
    count = torch.cuda.device_count()
    if count < TP_CARDS:
        print(f"(n)2-(n)3 MoE over {TP_CARDS} cards: not run — this machine "
              f"has {count} card; {card}", flush=True)
        return
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("ep train", ep_train, card)
    timed_phase("ep serve mixtral", ep_serve_mixtral, card)


# -- (o) pipeline parallelism over the pipeline axis --------------------------

#: (o)1: Llama-3-8B at full width and TRAIN_MODEL's depth, fused kernels
#: on, one 4 x 2048 batch, staged in lockstep on the card: (stages,
#: schedule). Both run m = 4 microbatches (JAX's rule).
PP_LOCKSTEP = ((2, "gpipe"), (4, "1f1b"))
PP_DATA = dict(seq_len=2048, global_batch=4)
#: (o)1's limits against the unstaged step (the staged and unstaged runs
#: do the same products on the same rows, one microbatch at a time): the
#: loss (relative), the grad norm (relative), each leaf (relative L2).
PP_LOSS_REL = 1e-4
PP_NORM_REL = 1e-3
PP_LEAF_REL_L2 = 1e-2
#: (o)2: llm_pretrain over NCCL at TRAIN_MODEL's depth on 4 cards: (axes,
#: schedule), each against an in-process one-card run (fused on) on the
#: same global batches; then a {pipeline: 2, data: 2} step-3 checkpoint
#: resumed on {pipeline: 4}.
PP_CARD_CASES = (({"pipeline": 4}, "1f1b"),
                 ({"pipeline": 2, "data": 2}, "gpipe"))
PP_CARDS = 4
#: (o)3: Llama-3-8B at all 32 layers on {pipeline: 4}, 1F1B, 8 x 2048 a
#: step (m = 8): 8.03 B params, 128 GB of fp32 weights, gradients and Adam
#: moments, which no one card holds.
PP_DEEP_DATA = dict(seq_len=2048, global_batch=8)
PP_DEEP_STEPS = 6


def _pp_want(per: int, m: int, last: bool) -> dict:
    """A stage's launches of every training kernel over one step, derived
    from the code: ``per`` layers on each of ``m`` microbatches, the
    stage's forward replayed in its backward (``remat_policy`` is not
    "none": JAX's ``checkpoint_stages``), so each layer's forward kernels
    launch twice and its backward kernels once; the last stage adds the
    final norm (forward and backward) and the fused CE's three kernels
    once a microbatch, outside the replayed stage."""
    want = _want_per_step(True, per)
    want = {k: v * m for k, v in want.items()}
    tail = 1 if last else 0
    for k in ("rmsnorm_fwd", "rmsnorm_bwd"):
        want[k] = want[k] - m + tail * m
    for k in ("fused_xent_fwd", "fused_xent_bwd_dh", "fused_xent_bwd_dw"):
        want[k] = tail * m
    return want


class _StageCounts:
    """``around(stage)`` for ``staged_loss``'s lockstep run: each stretch
    of a stage's work adds the training kernels' launches it made to that
    stage's counts."""

    def __init__(self, wrappers: dict, n: int):
        self.wrappers = wrappers
        self.counts = [{k: 0 for k in wrappers} for _ in range(n)]

    @contextlib.contextmanager
    def __call__(self, stage: int):
        before = {k: w.launches for k, w in self.wrappers.items()}
        yield
        for k, w in self.wrappers.items():
            self.counts[stage][k] += w.launches - before[k]


def pp_lockstep(rows: list[dict], card: str) -> None:
    """(o)1: the staged step in lockstep on one card, every stage in this
    process: Llama-3-8B width at TRAIN_MODEL's depth, fp32 params from a
    seed, fused kernels on, one 4 x 2048 batch, on ``PP_LOCKSTEP``'s
    stages and schedules, held to the unstaged ``decoder_loss`` on the
    same batch: the loss, the grad norm and every gradient leaf within
    their limits; each stage's launches of every training kernel exactly
    ``_pp_want``'s (the CE kernels on the last stage only), counted from
    0 just before the staged step."""
    import dataclasses

    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import (
        decoder_loss, init_decoder_params, staged_loss,
    )
    from kubeflow_tpu_torch.parallel.pipeline import microbatches
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.data import DataConfig, SyntheticLM
    from kubeflow_tpu_torch.train.optim import global_norm

    gc.collect()
    torch.cuda.empty_cache()
    cfg = preset("llama3-8b", **TRAIN_MODEL)
    params = init_decoder_params(torch.Generator("cuda").manual_seed(SEED),
                                 cfg)
    leaves = T.flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    batch = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seed=SEED, **PP_DATA)).batch_at(0))
    batch = batch.to("cuda")
    loss, _ = decoder_loss(params, batch, cfg, attn_impl="pallas")
    ref = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref_loss, ref_norm = float(loss.detach()), float(global_norm(ref))
    del loss
    wrappers = _train_wrappers()
    for n, schedule in PP_LOCKSTEP:
        c = dataclasses.replace(cfg, pipeline_schedule=schedule)
        m = microbatches(batch.shape[0], 1, n, schedule)
        counts = _StageCounts(wrappers, n)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, metrics = staged_loss(params, batch, c, attn_impl="pallas",
                                    stages=n, around=counts)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got_loss, got_norm = float(loss.detach()), float(global_norm(grads))
        loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
        norm_rel = abs(got_norm - ref_norm) / abs(ref_norm)
        rels = {p: rel_l2(grads[p], ref[p]) for p in leaves}
        worst = max(rels, key=rels.get)
        per = cfg.n_layers // n
        want = [_pp_want(per, m, s == n - 1) for s in range(n)]
        print(f"(o)1 {cfg.n_layers} layers on {{pipeline: {n}}} {schedule} "
              f"in lockstep, m = {m}: loss {got_loss:.6f} vs unstaged "
              f"{ref_loss:.6f} (rel {loss_rel:.3e}, tolerance "
              f"{PP_LOSS_REL:g}); grad norm {got_norm:.6f} vs {ref_norm:.6f}"
              f" (rel {norm_rel:.3e}, tolerance {PP_NORM_REL:g}); worst "
              f"leaf {worst} rel L2 {rels[worst]:.3e} (tolerance "
              f"{PP_LEAF_REL_L2:g}); step {secs * 1e3:.1f} ms; launches per "
              f"stage {counts.counts}; {card}", flush=True)
        if not loss_rel <= PP_LOSS_REL:
            fail(f"(o)1 {schedule} on {n} stages: the loss is off the "
                 "unstaged one's")
        if not norm_rel <= PP_NORM_REL:
            fail(f"(o)1 {schedule} on {n} stages: the grad norm is off the "
                 "unstaged one's")
        bad = [p for p, r in rels.items() if not r <= PP_LEAF_REL_L2]
        if bad:
            fail(f"(o)1 {schedule} on {n} stages: gradients off the "
                 f"unstaged ones: {bad}")
        for s in range(n):
            if counts.counts[s] != want[s]:
                fail(f"(o)1 {schedule} stage {s}: kernel launches "
                     f"{counts.counts[s]}, expected {want[s]}")
            for name, count in counts.counts[s].items():
                _add_launches(rows, name, count)
        del loss, grads
    del params, leaves, ref
    gc.collect()
    torch.cuda.empty_cache()


def _param_digests(trainer) -> dict:
    """Each params leaf's digest over the whole leaf, from the ranks'
    blocks: the sum over its elements of their fp32 bits times a hash of
    their global index, modulo a prime, each block counted once (the
    ranks that write it, ``ShardLayout.writes``), summed over the world.
    Two states with equal digests hold the same bits, whatever their
    layouts."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.train import tree as T

    p = 2 ** 31 - 1
    lay = trainer.shard_layout
    out = {}
    for path, t in T.flatten(trainer.task.state["params"]).items():
        key = f"params/{path}"
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        if lay.writes(key):
            shape = lay.global_shape(key, t.shape)
            block = lay.block(key, shape)
            strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
            bits = t.detach().float().contiguous().view(torch.int32)
            rows = max(1, 2 ** 24 // max(1, math.prod(t.shape[1:])))
            for i0 in range(0, bits.shape[0], rows):
                i1 = min(i0 + rows, bits.shape[0])
                g = torch.arange(block[0].start + i0, block[0].start + i1,
                                 device=t.device) * strides[0]
                for d in range(1, len(shape)):
                    ar = torch.arange(block[d].start, block[d].stop,
                                      device=t.device) * strides[d]
                    g = g[..., None] + ar
                h = (g * 2654435761 + 97) % p
                v = (bits[i0:i1].long() % p) * h % p
                total += v.sum() % p
        dist.all_reduce(total)
        out[path] = int(total) % p
    return out


def pp_digest_pretrain(ctx) -> int:
    """(o)2's checkpoint worker (``chip_smoke:pp_digest_pretrain``):
    ``counted_llm_pretrain`` that also writes, to ``digests.json`` in its
    workdir, ``_param_digests`` of the state its ``Trainer`` restored (with
    the step it resumed from) and of the state it ended with."""
    from kubeflow_tpu_torch.train.trainer import Trainer

    out: dict = {}
    run, resume = Trainer.run, Trainer.try_resume

    def resumed(self):
        step = resume(self)
        out["resumed"] = {"step": step, "params": _param_digests(self)}
        return step

    def ran(self, **kwargs):
        result = run(self, **kwargs)
        out["end"] = _param_digests(self)
        return result

    Trainer.run, Trainer.try_resume = ran, resumed
    try:
        rc = counted_llm_pretrain(ctx)
    finally:
        Trainer.run, Trainer.try_resume = run, resume
    Path(ctx.env.workdir, "digests.json").write_text(json.dumps(out))
    return rc


def pp_timed_pretrain(ctx) -> int:
    """(o)3's worker (``chip_smoke:pp_timed_pretrain``):
    ``counted_llm_pretrain`` with this rank's stage timed at every step:
    the schedule's wall seconds (``pipeline.run_stage``) and the seconds
    its forwards and backwards kept the card busy (the card synchronized
    around each), written to ``stage_times.json`` in its workdir."""
    from kubeflow_tpu_torch.parallel import pipeline as PP

    walls, busy = [], []
    run_stage, fwd, bwd = PP.run_stage, PP.Stage.forward, PP.Stage.backward

    def timed(fn):
        def inner(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            busy[-1] += time.perf_counter() - t0
            return out
        return inner

    def staged(program, link):
        busy.append(0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_stage(program, link)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    PP.run_stage = staged
    PP.Stage.forward, PP.Stage.backward = timed(fwd), timed(bwd)
    try:
        rc = counted_llm_pretrain(ctx)
    finally:
        PP.run_stage, PP.Stage.forward, PP.Stage.backward = (
            run_stage, fwd, bwd)
    Path(ctx.env.workdir, "stage_times.json").write_text(json.dumps(
        {"wall_s": walls, "busy_s": busy}))
    return rc


def _pp_card_want(cfg, axes: dict, schedule: str, steps: int) -> list[dict]:
    """Each rank's launches over ``steps`` steps of ``cfg`` on ``axes``
    (``_pp_want`` of its stage), by rank: the pipeline axis is outside the
    data axis (``runtime/mesh.MESH_AXES``)."""
    from kubeflow_tpu_torch.parallel.pipeline import microbatches

    n, dp = axes["pipeline"], axes.get("data", 1)
    m = microbatches(cfg.data["global_batch"], dp, n, schedule)
    per = TRAIN_MODEL["n_layers"] // n
    out = []
    for s in range(n):
        want = {k: v * steps for k, v in _pp_want(per, m, s == n - 1)
                .items()}
        out += [want] * dp
    return out


def pp_train_cards(card: str) -> None:
    """(o)2: ``llm_pretrain`` over NCCL on ``PP_CARD_CASES`` (one process
    per card), Llama-3-8B width at TRAIN_MODEL's depth, 3 steps of 4 x
    2048 tokens, fused kernels on, each held to an in-process one-card run
    (fused on) on the same global batches: losses within
    ``MULTI_CARD_LOSS_REL``, the step-1 grad norm within
    ``MULTI_CARD_GRAD_NORM_REL``; every rank's launches exactly its
    stage's (``_pp_want``). Then the ``{pipeline: 2, data: 2}`` run's
    step-3 checkpoint resumed by a ``{pipeline: 4}`` gang: every params
    leaf bit-equal to the state the first gang ended on
    (``_param_digests``), then 2 more steps, finite."""
    import dataclasses
    import tempfile

    nan = float("nan")
    refs: dict = {}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_train_") as base:
        for axes, schedule in PP_CARD_CASES:
            cfg = _trainer_cfg(steps=MULTI_STEPS, data=PP_DATA,
                               pipeline_schedule=schedule)
            ckpt = (str(Path(base, "ckpt")) if axes.get("data", 1) > 1
                    else None)
            if ckpt:
                cfg = dataclasses.replace(cfg, checkpoint_dir=ckpt,
                                          checkpoint_every=MULTI_STEPS)
            dirs = [Path(base, f"{schedule}{PP_CARDS}", f"w{r}")
                    for r in range(PP_CARDS)]
            secs = spawn_workers(
                "chip_smoke:pp_digest_pretrain" if ckpt
                else "chip_smoke:counted_llm_pretrain",
                dataclasses.asdict(cfg), dirs, axes,
                f"(o)2 llm_pretrain {axes}")
            logged = [json.loads(x) for x in
                      (dirs[0] / "metrics.jsonl").read_text().splitlines()]
            counts = [json.loads((d / "counts.json").read_text())
                      for d in dirs]
            if ckpt:
                ended = json.loads((dirs[0] / "digests.json").read_text())
            dp = axes.get("data", 1)
            if dp not in refs:
                # The global batches of dp batch shards, in one process.
                refs[dp] = _global_batch_run(dataclasses.replace(
                    cfg, checkpoint_dir=None, checkpoint_every=0), dp)
            ref_losses, ref_norms = refs[dp]
            losses = [r["loss"] for r in logged]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, ref_losses))
            norm_rel = abs(logged[0]["grad_norm"] - ref_norms[0]) \
                / ref_norms[0]
            want = _pp_card_want(cfg, axes, schedule, MULTI_STEPS)
            launches = [c["launches"] for c in counts]
            print(f"(o)2 llm_pretrain over NCCL, {PP_CARDS} cards, {axes} "
                  f"{schedule}: exit 0 in {secs:.1f} s; devices "
                  f"{[c['device'] for c in counts]}; losses {losses} vs "
                  f"in-process, fused on, same global batches {ref_losses}"
                  f" (max rel {rel:.3e}, tolerance {MULTI_CARD_LOSS_REL:g}); "
                  f"step-1 grad norm {logged[0]['grad_norm']} vs "
                  f"{ref_norms[0]} (rel {norm_rel:.3e}, tolerance "
                  f"{MULTI_CARD_GRAD_NORM_REL:g}); step ms "
                  f"{[round(r.get('step_time_ms', nan), 1) for r in logged]}"
                  f"; tokens/s "
                  f"{[round(r.get('tokens_per_sec', nan), 1) for r in logged]}"
                  f"; peak per rank "
                  f"{[round(c['peak'] / 2**30, 2) for c in counts]} GiB; "
                  f"launches per rank {launches}; {card}", flush=True)
            if len({c["device"] for c in counts}) != PP_CARDS or any(
                    c["world"] != PP_CARDS or c["backend"] != "nccl"
                    for c in counts):
                fail(f"(o)2 {axes}: ranks {counts} are not one NCCL world "
                     "over distinct cards")
            if not rel <= MULTI_CARD_LOSS_REL:
                fail(f"(o)2 {axes}: the losses are off the one-card run's")
            if not norm_rel <= MULTI_CARD_GRAD_NORM_REL:
                fail(f"(o)2 {axes}: the step-1 grad norm is off the "
                     "one-card run's")
            if launches != want:
                fail(f"(o)2 {axes}: launches per rank {launches}, "
                     f"expected {want}")
        cfg = _trainer_cfg(steps=MULTI_STEPS + 2, data=PP_DATA,
                           pipeline_schedule="1f1b")
        cfg = dataclasses.replace(cfg, checkpoint_dir=str(Path(base, "ckpt")),
                                  checkpoint_every=MULTI_STEPS)
        dirs = [Path(base, "resume", f"w{r}") for r in range(PP_CARDS)]
        secs = spawn_workers("chip_smoke:pp_digest_pretrain",
                             dataclasses.asdict(cfg), dirs,
                             {"pipeline": PP_CARDS}, "(o)2 resume")
        got = json.loads((dirs[0] / "digests.json").read_text())
        logged = [json.loads(x) for x in
                  (dirs[0] / "metrics.jsonl").read_text().splitlines()]
        same = sum(got["resumed"]["params"][p] == d
                   for p, d in ended["end"].items())
        print(f"(o)2 the {{pipeline: 2, data: 2}} step-{MULTI_STEPS} "
              f"checkpoint resumed on {{pipeline: {PP_CARDS}}} at step "
              f"{got['resumed']['step']}: {same} of {len(ended['end'])} "
              f"params leaves bit-equal (digests); then steps "
              f"{[r['step'] for r in logged]}, losses "
              f"{[r['loss'] for r in logged]}, in {secs:.1f} s; {card}",
              flush=True)
        if got["resumed"]["step"] != MULTI_STEPS or same != len(ended["end"]):
            fail("(o)2: the resumed stage-sharded checkpoint is not the "
                 "state the first gang saved")
        if [r["step"] for r in logged] != list(range(MULTI_STEPS + 1,
                                                      MULTI_STEPS + 3)) or \
                not all(math.isfinite(r["loss"]) for r in logged):
            fail(f"(o)2: the resumed run's steps {logged}")


def pp_deep(card: str) -> None:
    """(o)3: Llama-3-8B at all 32 layers on ``{pipeline: 4}`` (1F1B, 8 x
    2048 tokens a step, m = 8), fused kernels on, ``PP_DEEP_STEPS``
    steps: the loss finite every step and lower at the last; step ms,
    tokens/s, MFU, each stage's peak allocation, and each stage's measured
    idle share of its schedule (1 - busy / wall, steps 2 on) beside the
    1F1B bubble (n - 1) / (m + n - 1)."""
    import dataclasses
    import tempfile

    from kubeflow_tpu_torch.parallel.pipeline import microbatches

    nan = float("nan")
    n = PP_CARDS
    cfg = _trainer_cfg(steps=PP_DEEP_STEPS, data=PP_DEEP_DATA, n_layers=32,
                       pipeline_schedule="1f1b")
    m = microbatches(PP_DEEP_DATA["global_batch"], 1, n, "1f1b")
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_train_") as base:
        dirs = [Path(base, f"w{r}") for r in range(n)]
        secs = spawn_workers("chip_smoke:pp_timed_pretrain",
                             dataclasses.asdict(cfg), dirs, {"pipeline": n},
                             "(o)3 llm_pretrain 32 layers")
        logged = [json.loads(x) for x in
                  (dirs[0] / "metrics.jsonl").read_text().splitlines()]
        counts = [json.loads((d / "counts.json").read_text()) for d in dirs]
        times = [json.loads((d / "stage_times.json").read_text())
                 for d in dirs]
    idle = [1 - sum(t["busy_s"][1:]) / sum(t["wall_s"][1:]) for t in times]
    bubble = (n - 1) / (m + n - 1)
    losses = [r["loss"] for r in logged]
    print(f"(o)3 Llama-3-8B 32 layers on {{pipeline: {n}}} 1f1b, m = {m}, "
          f"{PP_DEEP_DATA['global_batch']} x {PP_DEEP_DATA['seq_len']} "
          f"tokens a step: exit 0 in {secs:.1f} s; losses {losses}; step ms "
          f"{[round(r.get('step_time_ms', nan), 1) for r in logged]}; "
          f"tokens/s {[round(r.get('tokens_per_sec', nan), 1) for r in logged]}"
          f"; MFU {[round(r.get('mfu', nan), 4) for r in logged]}; peak per "
          f"stage {[round(c['peak'] / 2**30, 2) for c in counts]} GiB; "
          f"schedule wall s per stage (steps 2 on) "
          f"{[round(sum(t['wall_s'][1:]), 3) for t in times]}, busy "
          f"{[round(sum(t['busy_s'][1:]), 3) for t in times]}, idle share "
          f"{[round(x, 4) for x in idle]} vs the 1F1B bubble (n - 1) / (m + "
          f"n - 1) = {bubble:.4f}; launches per stage "
          f"{[c['launches'] for c in counts]}; {card}", flush=True)
    if [r["step"] for r in logged] != list(range(1, PP_DEEP_STEPS + 1)):
        fail(f"(o)3: steps {[r['step'] for r in logged]} logged")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"(o)3: losses {losses} are not finite and falling")


def phase_pp(rows: list[dict], card: str, *, cards_only: bool = False
             ) -> None:
    """(o): pipeline parallelism over the pipeline axis — (o)1 in lockstep
    on one card (not with ``cards_only``), then on a machine of
    ``PP_CARDS`` cards or more (o)2 and (o)3 over NCCL."""
    if not cards_only:
        timed_phase("pp lockstep", pp_lockstep, rows, card)
    count = torch.cuda.device_count()
    if count < PP_CARDS:
        print(f"(o)2-(o)3 pipeline parallelism over {PP_CARDS} cards: not "
              f"run — this machine has {count} card; {card}", flush=True)
        return
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("pp train cards", pp_train_cards, card)
    timed_phase("pp deep", pp_deep, card)


# -- (p) vision on a mesh, and dims that do not divide ------------------------

#: (p)1: ViT-L/16's block split over ``model`` and ``seq`` in lockstep on
#: one card (bf16, the training batch), vs the whole block; rel L2.
VIS_WAYS, VIS_SEQ, VIS_B = 4, 2, 32
VIS_REL_L2 = 1e-2
#: (p)1: the model degree of the 9g check (Llama-3-8B: 32 heads, 8 kv heads
#: and 14336 mlp columns do not divide by 3; 128256 = 3 x 42752 does).
NONDIV_WAYS = 3
#: (p)2: 4-card vision training, each case held to a one-card run of the
#: same config: (family, preset, mesh axes).
VISION_CARDS = 4
VISION_CARD_CASES = (("vit", "vit-l16", {"fsdp": 2, "model": 2}),
                     ("vit", "vit-l16", {"data": 2, "seq": 2}),
                     ("clip", "clip-l14", {"data": 2, "model": 2}),
                     ("clip", "clip-l14", {"model": 2, "seq": 2}))
VISION_CARD_BATCH = 32
VISION_CARD_STEPS = 4
#: (p)2's activations in its cases above: fp32 (``model_overrides``; CLIP's
#: image tower through its ``image`` entry), so that the 1e-4 check reads
#: the gang's arithmetic. In bf16 the first loss of a correct gang sits
#: 2.3e-04 (rel) from one card's (ViT-L/16 on {fsdp: 2, model: 2}, H100;
#: PERF.md §6), about bf16's own distance from fp32 on one card ((j)4:
#: 1.4e-04 ViT-L, 3.4e-04 CLIP-L).
VISION_CARD_DTYPE = "float32"
#: (p)2's bf16 case: the preset as committed (bf16 activations), held to a
#: one-card bf16 run within ``VISION_BF16_LOSS_REL``. The limit sits above
#: the gap of a sound bf16 gang on this case (2.26e-04, H100, PERF.md §6)
#: and must sit below the gap of a faulted control in the same run: the
#: same gang with ``copy_to_model``'s backward sum over ``model`` taken
#: out (the input gradients of the column-parallel products then miss the
#: other rank's heads and mlp columns).
VISION_BF16_CASE = ("vit", "vit-l16", {"fsdp": 2, "model": 2})
VISION_BF16_LOSS_REL = 1e-3


def _vision_block(gen, cfg) -> dict:
    """One encoder block's leaves on the card (fp32, the JAX init), the
    norms and biases drawn away from 1 and 0, each needing a gradient."""
    from kubeflow_tpu_torch.models import vision as V

    p = V._init_encoder_block(gen, cfg)

    def jitter(t, base):
        return base + 0.1 * torch.randn(t.shape, generator=gen,
                                        device="cuda")

    for ln in ("ln1", "ln2"):
        p[ln] = {"scale": jitter(p[ln]["scale"], 1.0),
                 "bias": jitter(p[ln]["bias"], 0.0)}
    p["b1"], p["b2"] = jitter(p["b1"], 0.0), jitter(p["b2"], 0.0)
    for t in _leaves(p):
        t.requires_grad_(True)
    return p


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def vision_block_lockstep(card: str) -> None:
    """(p)1a: one ViT-L/16 encoder block (``vit-l16``: bf16 activations,
    fp32 leaves, B = ``VIS_B``, 197 tokens) as the mesh splits it, the
    ranks run one after another on this card: over ``model``
    (``VIS_WAYS`` ranks of 4 heads and 1024 mlp columns, each from the
    whole leaves: ``block_qkv``, ``block_attend``, ``block_mlp``; the
    ranks' partial outputs summed where ``reduce_from_model`` sums them)
    and over ``seq`` (``VIS_SEQ`` ranks of 99 and 98 positions, each
    rank's queries over every rank's K and V). Output and every gradient
    (input, norms, each weight) against the whole block (``_encoder_block``
    on one device): rel L2 <= ``VIS_REL_L2``."""
    from kubeflow_tpu_torch.models import vision as V
    from kubeflow_tpu_torch.parallel.collectives import ModelAxis

    cfg = V.vit_preset("vit-l16")
    gen = torch.Generator("cuda").manual_seed(SEED + 120)
    p = _vision_block(gen, cfg)
    s = cfg.seq_len
    x = torch.randn((VIS_B, s, cfg.hidden), generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    dy = torch.randn((VIS_B, s, cfg.hidden), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    ln = V._layernorm
    eps = cfg.norm_eps
    b2 = p["b2"].to(cfg.activation_dtype)

    def whole():
        return V._encoder_block(p, x, cfg)

    def model_split():
        axes = [V.VisionAxes(tp=ModelAxis(None, r, VIS_WAYS))
                for r in range(VIS_WAYS)]
        h = ln(p["ln1"], x, eps)
        y = x + sum(V.block_attend(p, *V.block_qkv(p, h, cfg, a), cfg, a)
                    for a in axes)
        h2 = ln(p["ln2"], y, eps)
        return y + (sum(V.block_mlp(p, h2, cfg, a) for a in axes) + b2)

    def seq_split():
        axes = [V.VisionAxes(seq_rank=r, seq_size=VIS_SEQ)
                for r in range(VIS_SEQ)]
        spans = [a.span(s) for a in axes]
        qkv = [V.block_qkv(p, ln(p["ln1"], x[:, a:b], eps), cfg)
               for a, b in spans]
        kf = torch.cat([t[1] for t in qkv], dim=1)
        vf = torch.cat([t[2] for t in qkv], dim=1)
        outs = []
        for (a, b), (q, _, _) in zip(spans, qkv):
            y = x[:, a:b] + V.block_attend(p, q, kf, vf, cfg, q_offset=a)
            h2 = ln(p["ln2"], y, eps)
            outs.append(y + (V.block_mlp(p, h2, cfg) + b2))
        return torch.cat(outs, dim=1)

    leaves = [x, *_leaves(p)]
    names = ["x", "ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias", "wqkv",
             "wo", "w1", "b1", "w2", "b2"]
    ref = whole()
    ref_g = torch.autograd.grad(ref, leaves, dy)
    out = {}
    widths = [b - a for a, b in (V.VisionAxes(seq_rank=r, seq_size=VIS_SEQ)
                                 .span(s) for r in range(VIS_SEQ))]
    for label, fn in ((f"model {VIS_WAYS}", model_split),
                      (f"seq {VIS_SEQ} (positions {widths})", seq_split)):
        got = fn()
        g = torch.autograd.grad(got, leaves, dy)
        rels = {"out": rel_l2(got, ref)}
        rels.update({n: rel_l2(a, b) for n, a, b in zip(names, g, ref_g)})
        ms = event_ms(lambda fn=fn: torch.autograd.grad(fn(), leaves, dy))
        out[label] = (rels, ms)
    whole_ms = event_ms(lambda: torch.autograd.grad(whole(), leaves, dy))
    for label, (rels, ms) in out.items():
        print(f"(p)1 ViT-L/16 block, B={VIS_B} S={s}, split over {label} in "
              f"lockstep vs whole: rel L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (tolerance {VIS_REL_L2:g}); fwd+bwd ms split {ms:.3f} vs "
              f"whole {whole_ms:.3f}; {card}", flush=True)
        bad = {k: v for k, v in rels.items() if not v <= VIS_REL_L2}
        if bad:
            fail(f"(p)1 ViT block over {label}: off the whole block: {bad}")


def vision_head_lockstep(card: str) -> None:
    """(p)1b: the ViT head's vocab-parallel CE (ViT-L/16's 1024-wide
    features, B = ``VIS_B``, 1000 classes over ``VIS_WAYS`` shards of 250)
    in lockstep: each shard's fp32 logits and statistics
    (``vocab_parallel.logit_stats`` with its shifted labels), the combine
    (``combine_shards``), each shard's gradient with the global lse. nll,
    accuracy and both gradients against ``log_softmax`` over the whole
    head: rel L2 <= ``VIS_REL_L2``, accuracy equal."""
    from kubeflow_tpu_torch.parallel import vocab_parallel as VP

    d, c = 1024, 1000
    gen = torch.Generator("cuda").manual_seed(SEED + 121)
    feats = torch.randn((VIS_B, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    head = (torch.randn((d, c), generator=gen, device="cuda")
            * d ** -0.5).requires_grad_(True)
    labels = torch.randint(0, c, (VIS_B,), generator=gen, device="cuda")
    f = feats.float().requires_grad_(True)
    logits = f @ head.to(torch.bfloat16).float()
    nll = -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    acc = float((logits.argmax(-1) == labels).float().mean())
    df, dh = torch.autograd.grad(nll.mean(), [f, head])
    w = c // VIS_WAYS
    parts = [(f.detach() @ head.detach()[:, r * w:(r + 1) * w].to(
        torch.bfloat16).float()) for r in range(VIS_WAYS)]
    local = [labels - r * w for r in range(VIS_WAYS)]
    snll, lse, correct = VP.combine_shards(torch.stack(
        [VP.logit_stats(lg, t) for lg, t in zip(parts, local)]))
    from kubeflow_tpu_torch.ops import fused_xent

    dls = [(torch.exp(lg - lse[:, None]) - fused_xent._onehot(t, w))
           / VIS_B for lg, t in zip(parts, local)]
    sdf = sum(dl @ head.detach()[:, r * w:(r + 1) * w].to(
        torch.bfloat16).float().T for r, dl in enumerate(dls))
    sdh = torch.cat([f.detach().T @ dl for dl in dls], dim=1)
    rels = {"nll": rel_l2(snll, nll), "d_feats": rel_l2(sdf, df),
            "d_head": rel_l2(sdh, dh)}
    sacc = float(correct.mean())
    print(f"(p)1 ViT head CE, B={VIS_B}, {c} classes over {VIS_WAYS} shards "
          f"of {w} in lockstep vs the whole head: rel L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tolerance {VIS_REL_L2:g}); accuracy {sacc} vs {acc}; {card}",
          flush=True)
    if any(not v <= VIS_REL_L2 for v in rels.values()) or sacc != acc:
        fail(f"(p)1 ViT head CE: off the whole head: {rels}, accuracy "
             f"{sacc} vs {acc}")


def nondiv_block_lockstep(rows: list[dict], card: str) -> None:
    """(p)1c: 9g at full width. One Llama-3-8B block (bf16) at B = 1,
    T = ``TP_T`` and its fused CE, on a model axis of ``NONDIV_WAYS``
    where the 32 heads, 8 kv heads and 14336 mlp columns do not divide:
    every rank reads its part of the whole leaves (``layers.head_owners``:
    8, 12 and 12 q heads along the GQA groups, 2, 3 and 3 kv heads; mlp
    columns 4778, 4779, 4779) through the flash and SwiGLU kernels; the
    vocabulary divides (3 x 42752), so the CE runs over 3 shards
    (``vocab_parallel_lockstep``: rows 9-11 on each). The ranks run one
    after another on this card, their partial outputs summed. nll and
    every gradient (input, norms, each whole weight, the head) against the
    unsplit block and fused CE: rel L2 <= ``TP_REL_L2``; the launches per
    shard printed, rows 4-11 ``NONDIV_WAYS`` times the unsplit ones."""
    from kubeflow_tpu_torch.models import layers as L
    from kubeflow_tpu_torch.models.config import preset, with_model_axis
    from kubeflow_tpu_torch.ops import fused_xent as fx
    from kubeflow_tpu_torch.parallel import vocab_parallel as vp
    from kubeflow_tpu_torch.parallel.collectives import ModelAxis

    cfg = preset("llama3-8b", n_layers=1, param_dtype="bfloat16")
    n = NONDIV_WAYS
    cfgs = [with_model_axis(cfg, ModelAxis(None, r, n)) for r in range(n)]
    gen = torch.Generator("cuda").manual_seed(SEED + 122)
    attn = L.init_attention(gen, cfg)
    mlp = L.init_mlp(gen, cfg)
    norms = [(1.0 + 0.1 * torch.randn((cfg.hidden,), generator=gen,
                                      device="cuda")).to(torch.bfloat16)
             for _ in range(2)]
    head = (torch.randn((cfg.hidden, cfg.vocab_size), generator=gen,
                        device="cuda") * cfg.hidden ** -0.5).to(
        torch.bfloat16)
    leaves = [*attn.values(), *mlp.values(), *norms, head]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.randn((1, TP_T, cfg.hidden), generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    t = torch.randint(0, cfg.vocab_size, (TP_T,), generator=gen,
                      device="cuda")
    pos = torch.arange(TP_T, device="cuda")[None]

    def block(split: bool):
        parts = cfgs if split else [cfg]
        h = L.rmsnorm(x, norms[0], cfg)
        out = 0
        for c in parts:
            q, k, v = L.attention_qkv(attn, h, pos, c)
            out = out + L.attention_out(attn, q, k, v, c, attn_impl="pallas")
        y, h2 = L.add_rmsnorm(x, out, norms[1], cfg)
        return y + sum(L.mlp_block(mlp, h2, c) for c in parts)

    def run(split: bool):
        for w in wrappers.values():
            w.launches = 0
        out = block(split)
        h2 = out.reshape(TP_T, cfg.hidden)
        if split:
            nll, _, _, dh, dw = vp.vocab_parallel_lockstep(
                h2.detach().contiguous(), head.detach(), t.to(torch.int32),
                n)
            grads = (*torch.autograd.grad(out, [x, *leaves[:-1]],
                                          dh.reshape(out.shape)), dw)
        else:
            nll, _ = fx.fused_cross_entropy(h2, head, t)
            grads = torch.autograd.grad(nll.float().sum(), [x, *leaves])
        return nll.detach().float(), grads, {
            k: w.launches for k, w in wrappers.items()}

    wrappers = _train_wrappers()
    nll1, g1, n1 = run(False)
    nll3, g3, n3 = run(True)
    names = ["x", *(f"attn.{k}" for k in attn), *(f"mlp.{k}" for k in mlp),
             "ln1", "ln2", "head"]
    rels = {"nll": rel_l2(nll3, nll1)}
    rels.update({k: rel_l2(a, b) for k, a, b in zip(names, g3, g1)})
    heads = L.head_owners(cfgs[0])
    kv = L.kv_head_owners(cfgs[0])
    cols = [L.model_part(cfg.mlp_dim, c) for c in cfgs]
    print(f"(p)1 9g: Llama-3-8B block + fused CE, B=1 T={TP_T}, model = {n} "
          f"in lockstep (q heads {heads}, kv heads {kv}, mlp columns {cols}, "
          f"vocab shards of {cfg.vocab_size // n}) vs unsplit: rel L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tolerance {TP_REL_L2:g}); launches split {n3} (each shard "
          f"{ {k: c // n for k, c in n3.items() if 'rmsnorm' not in k} }, "
          f"the norms once) vs unsplit {n1}; {card}", flush=True)
    bad = {k: v for k, v in rels.items() if not v <= TP_REL_L2}
    if bad:
        fail(f"(p)1 9g: the split block is off the unsplit one: {bad}")
    per_rank = ("swiglu_fwd", "swiglu_bwd", "flash_fwd", "flash_bwd_dkdv",
                "flash_bwd_dq")
    for k, c in n3.items():
        want = n * n1[k] if k in per_rank else n1[k]
        if c == 0 or (not k.startswith("fused_xent") and c != want):
            fail(f"(p)1 9g: {k} launched {c} times in the split run, "
                 f"expected {want} (unsplit {n1[k]})")
        _add_launches(rows, k, c)


def counted_vision_train(ctx) -> int:
    """(p)2's worker entrypoint (``chip_smoke:counted_vision_train``):
    ``vision_train`` with the peak allocation and the world it joined
    written to ``counts.json`` in the worker's workdir. With ``"fault":
    "copy_to_model"`` in the config (the bf16 control), ``copy_to_model``
    is the identity both ways in this process."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import collectives as C
    from kubeflow_tpu_torch.train.entrypoints import vision_train

    if ctx.config.get("fault") == "copy_to_model":
        C.copy_to_model = lambda x, tp: x
    torch.cuda.reset_peak_memory_stats()
    rc = vision_train(ctx)
    out = {"peak": torch.cuda.max_memory_allocated(),
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "device": str(torch.cuda.current_device())}
    Path(ctx.env.workdir, "counts.json").write_text(json.dumps(out))
    return rc


def _vision_conf(family: str, name: str, dtype: str | None) -> dict:
    """``vision_train``'s config for (p)2: the preset's activations in
    ``dtype`` (CLIP's two towers), or as committed with None."""
    over = {} if dtype is None else {"dtype": dtype}
    if dtype is not None and family == "clip":
        over["image"] = {"dtype": dtype}
    return {"family": family, "model": name, "steps": VISION_CARD_STEPS,
            "batch": VISION_CARD_BATCH, "model_overrides": over}


def _vision_one_card(base: str, conf: dict, tag: str, card: str) -> list:
    """A one-card ``vision_train`` worker of ``conf``; its logged rows."""
    d = [Path(base, f"{tag}-one", "w0")]
    secs = spawn_workers("chip_smoke:counted_vision_train", conf, d,
                         {"fsdp": 1}, f"(p)2 {tag} one card")
    rows = [json.loads(x) for x in
            (d[0] / "metrics.jsonl").read_text().splitlines()]
    one = json.loads((d[0] / "counts.json").read_text())
    ms = [round(r.get("step_time_ms", float("nan")), 1) for r in rows]
    print(f"(p)2 {tag} on one card: exit 0 in {secs:.1f} s; losses "
          f"{[r['loss'] for r in rows]}; step ms {ms}; peak "
          f"{one['peak'] / 2**30:.2f} GiB; {card}", flush=True)
    return rows


def _vision_gang(base: str, conf: dict, tag: str, axes: dict, ref: list,
                 tol: float, card: str) -> float:
    """A ``VISION_CARDS``-rank NCCL gang of ``conf`` on ``axes``, printed
    beside the one-card rows ``ref``; fails unless it is one NCCL world
    over distinct cards. Returns the largest relative loss gap."""
    nan = float("nan")
    mesh_tag = "_".join(f"{a}{n}" for a, n in axes.items())
    dirs = [Path(base, f"{tag}-{mesh_tag}", f"w{r}")
            for r in range(VISION_CARDS)]
    secs = spawn_workers("chip_smoke:counted_vision_train", conf, dirs, axes,
                         f"(p)2 {tag} {axes}")
    logged = [json.loads(x) for x in
              (dirs[0] / "metrics.jsonl").read_text().splitlines()]
    counts = [json.loads((d / "counts.json").read_text()) for d in dirs]
    losses = [r["loss"] for r in logged]
    want = [r["loss"] for r in ref]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    ms = [r.get("step_time_ms", nan) for r in logged]
    print(f"(p)2 vision_train {tag} over NCCL, {VISION_CARDS} cards, "
          f"{axes}: exit 0 in {secs:.1f} s; devices "
          f"{[c['device'] for c in counts]}; losses {losses} vs one card "
          f"{want} (max rel {gap:.3e}, tolerance {tol:g}); grad norms "
          f"{[r.get('grad_norm') for r in logged]} vs "
          f"{[r.get('grad_norm') for r in ref]}; step ms "
          f"{[round(m, 1) for m in ms]}; images/s "
          f"{[round(VISION_CARD_BATCH * 1e3 / m, 1) for m in ms]}; peak per "
          f"rank {[round(c['peak'] / 2**30, 2) for c in counts]} GiB; "
          f"{card}", flush=True)
    if len(logged) != VISION_CARD_STEPS or len({
            c["device"] for c in counts}) != VISION_CARDS or any(
            c["world"] != VISION_CARDS or c["backend"] != "nccl"
            for c in counts):
        fail(f"(p)2 {tag} {axes}: {len(logged)} steps logged, ranks "
             f"{counts}: not one NCCL world over distinct cards")
    return gap


def vision_train_cards(card: str) -> None:
    """(p)2: ``vision_train`` over NCCL, one process per card, each gang
    held to a one-card worker of the same config from the same seeded
    init, ``VISION_CARD_STEPS`` steps of ``VISION_CARD_BATCH`` images:

    - ``VISION_CARD_CASES`` in ``VISION_CARD_DTYPE``: ViT-L/16 at full
      width (24 layers, 224², 1000 classes) on ``{fsdp: 2, model: 2}``
      and ``{data: 2, seq: 2}`` (197 tokens: 99 and 98 a rank), CLIP-L/14
      at the repo's preset (the ViT-L/16-shaped image tower, the 768-wide
      12-layer text tower of 77 tokens and 49408 ids) on ``{data: 2,
      model: 2}`` and ``{model: 2, seq: 2}``; losses within
      ``MULTI_CARD_LOSS_REL``;
    - ``VISION_BF16_CASE`` as committed (bf16): within
      ``VISION_BF16_LOSS_REL``, and the faulted control beyond it.

    Step ms, images/s and peak GiB per rank printed."""
    import tempfile

    refs: dict = {}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent,
                                     prefix=".chip_smoke_train_") as base:
        for family, name, axes in VISION_CARD_CASES:
            conf = _vision_conf(family, name, VISION_CARD_DTYPE)
            tag = f"{name} {VISION_CARD_DTYPE}"
            if name not in refs:
                refs[name] = _vision_one_card(base, conf, tag, card)
            gap = _vision_gang(base, conf, tag, axes, refs[name],
                               MULTI_CARD_LOSS_REL, card)
            if not gap <= MULTI_CARD_LOSS_REL:
                fail(f"(p)2 {tag} {axes}: the losses are off the one-card "
                     "run's")
        family, name, axes = VISION_BF16_CASE
        conf = _vision_conf(family, name, None)
        tag = f"{name} bf16"
        ref = _vision_one_card(base, conf, tag, card)
        gap = _vision_gang(base, conf, tag, axes, ref, VISION_BF16_LOSS_REL,
                           card)
        bad = _vision_gang(base, {**conf, "fault": "copy_to_model"},
                           f"{tag} faulted (copy_to_model without its sum)",
                           axes, ref, VISION_BF16_LOSS_REL, card)
        print(f"(p)2 {tag} {axes}: gang {gap:.3e} <= limit "
              f"{VISION_BF16_LOSS_REL:g} < faulted control {bad:.3e}: "
              f"{gap <= VISION_BF16_LOSS_REL < bad}; {card}", flush=True)
        if not gap <= VISION_BF16_LOSS_REL:
            fail(f"(p)2 {tag} {axes}: the losses are off the one-card run's")
        if not bad > VISION_BF16_LOSS_REL:
            fail(f"(p)2 {tag} {axes}: the faulted control is within the "
                 "limit, which then shows nothing")


def phase_vision(rows: list[dict], card: str, *, cards_only: bool = False
                 ) -> None:
    """(p): vision on a mesh and dims that do not divide — (p)1 in
    lockstep on one card (not with ``cards_only``), then on a machine of
    ``VISION_CARDS`` cards or more (p)2 over NCCL."""
    if not cards_only:
        timed_phase("vision block", vision_block_lockstep, card)
        timed_phase("vision head", vision_head_lockstep, card)
        timed_phase("nondivisible block", nondiv_block_lockstep, rows, card)
    count = torch.cuda.device_count()
    if count < VISION_CARDS:
        print(f"(p)2 vision training over {VISION_CARDS} cards: not run — "
              f"this machine has {count} card; {card}", flush=True)
        return
    gc.collect()
    torch.cuda.empty_cache()
    timed_phase("vision train cards", vision_train_cards, card)


def timed_phase(name: str, fn, *args, **kwargs):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def serve_phases(rows: list[dict], card: str, *, full: bool) -> tuple:
    """Phases 4 on: serve, (a) explain, (b) loadgen in process, then (with
    ``full``) the paged serve, paged check and profile; then the engine is
    freed and (c) the worker runs. Returns the worker's greedy tokens, its
    ``mixed_interference`` report (for (e)) and its ``uniform`` TPOT p50
    (for (h))."""
    engine = timed_phase("serve", phase_serve, rows)
    timed_phase("explain", phase_explain, engine)
    timed_phase("loadgen in process", phase_loadgen_engine, engine, card)
    if full:
        timed_phase("paged serve", phase_paged_serve, engine, rows)
        timed_phase("paged check", phase_paged_check, engine)
        timed_phase("profile", phase_profile, engine)
    want = timed_phase("worker reference", worker_reference, engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serving engines freed: {torch.cuda.memory_allocated() / 2**30:.2f}"
          " GiB still allocated", flush=True)
    mixed, uniform_tpot = timed_phase("worker", phase_worker, want, card)
    return want, mixed, uniform_tpot


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "kubeflow_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: kubeflow_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    t0 = time.perf_counter()
    card = phase_card()
    timed_phase("build", phase_build)
    if sys.argv[1:] == ["--serve-only"]:
        want, mixed, uniform_tpot = serve_phases([], card, full=False)
        timed_phase("disaggregated", phase_disaggregated, want, mixed, card)
        timed_phase("fleet", phase_fleet, card)
        timed_phase("many models", phase_many_models, card)
        timed_phase("spec", phase_spec, [], card, uniform_tpot)
        timed_phase("moe", phase_moe, [], card)
        print(f"chip_smoke: serve-only phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--spec-only"]:
        timed_phase("spec", phase_spec, [], card)
        print(f"chip_smoke: spec phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--moe-only"]:
        timed_phase("moe", phase_moe, [], card)
        print(f"chip_smoke: moe phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--remat-only"]:
        timed_phase("remat", phase_remat, [], card)
        print(f"chip_smoke: remat phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--multi-cards-only"]:
        # Only what needs several cards, and what it is held to.
        losses = timed_phase("multi world 1", multi_worker_world1, card)
        timed_phase("multi cards", multi_card_world, card, losses)
        print(f"chip_smoke: multi-card phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--tp-roles-cards-only"]:
        if torch.cuda.device_count() < TP_CARDS:
            fail(f"(m)6 needs {TP_CARDS} cards; this machine has "
                 f"{torch.cuda.device_count()}")
        timed_phase("tp roles", tp_roles_serve, card)
        print(f"chip_smoke: tp-roles-cards-only phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--order-probe-only"]:
        timed_phase("order probe", admission_order_probe, card)
        print(f"chip_smoke: order-probe phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--ep-fault-cards-only"]:
        if torch.cuda.device_count() < TP_CARDS:
            fail(f"the planted (n)3 needs {TP_CARDS} cards; this machine "
                 f"has {torch.cuda.device_count()}")
        timed_phase("ep fault", ep_fault_mixtral, card)
        print(f"chip_smoke: ep-fault-cards-only phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] in (["--tp-only"], ["--tp-cards-only"]):
        timed_phase("tp", phase_tp, [], card,
                    cards_only=sys.argv[1] == "--tp-cards-only")
        print(f"chip_smoke: {sys.argv[1][2:]} phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] in (["--ep-only"], ["--ep-cards-only"]):
        timed_phase("ep", phase_ep, card,
                    cards_only=sys.argv[1] == "--ep-cards-only")
        print(f"chip_smoke: {sys.argv[1][2:]} phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] in (["--pp-only"], ["--pp-cards-only"]):
        cards = sys.argv[1] == "--pp-cards-only"
        if cards and torch.cuda.device_count() < PP_CARDS:
            fail(f"(o)2-(o)3 need {PP_CARDS} cards; this machine has "
                 f"{torch.cuda.device_count()}")
        timed_phase("pp", phase_pp, [], card, cards_only=cards)
        print(f"chip_smoke: {sys.argv[1][2:]} phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] in (["--vision-only"], ["--vision-cards-only"]):
        cards = sys.argv[1] == "--vision-cards-only"
        if cards and torch.cuda.device_count() < VISION_CARDS:
            fail(f"(p)2 needs {VISION_CARDS} cards; this machine has "
                 f"{torch.cuda.device_count()}")
        timed_phase("vision", phase_vision, [], card, cards_only=cards)
        print(f"chip_smoke: {sys.argv[1][2:]} phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--multi-only"]:
        timed_phase("multi", phase_multi, card)
        print(f"chip_smoke: multi phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] == ["--train-moe-only"]:
        timed_phase("xent edges", phase_xent_edges)
        timed_phase("train moe", phase_train_moe, [], card)
        print(f"chip_smoke: train-moe phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] in (["--flash-only"], ["--paged-only"],
                        ["--xent-only"], ["--norm-only"]):
        # One family of kernels alone: its rows, then its edge cases.
        if sys.argv[1] == "--flash-only":
            rows = flash_fwd_rows() + flash_bwd_rows()
            phase_flash_edges()
            phase_flash_bwd_edges()
        elif sys.argv[1] == "--xent-only":
            rows = xent_rows()
            phase_xent_edges()
        elif sys.argv[1] == "--norm-only":
            rows = norm_fwd_rows() + norm_swiglu_bwd_rows()
            phase_norm_edges()
            phase_norm_bwd_edges()
        else:
            rows = paged_kernel_rows()
            phase_paged_edges()
        for r in rows:
            print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
                  f"{r['plain_ms']:.4f} library_ms {r['library_ms']} "
                  f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})",
                  flush=True)
        print(f"chip_smoke: {sys.argv[1][2:]} phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    rows = timed_phase("kernels", phase_kernels)
    timed_phase("edges", phase_edges)
    timed_phase("memory probe", phase_memory_probe)
    want, mixed, uniform_tpot = serve_phases(rows, card, full=True)
    timed_phase("train check", phase_train_check)
    timed_phase("train", phase_train, rows)
    timed_phase("train profile auto", phase_train_profile, "auto")
    timed_phase("train profile off", phase_train_profile, "off")
    timed_phase("disaggregated", phase_disaggregated, want, mixed, card)
    timed_phase("fleet", phase_fleet, card)
    timed_phase("many models", phase_many_models, card)
    timed_phase("spec", phase_spec, rows, card, uniform_tpot)
    timed_phase("moe", phase_moe, rows, card)
    timed_phase("train moe", phase_train_moe, rows, card)
    timed_phase("remat", phase_remat, rows, card)
    timed_phase("multi", phase_multi, card)
    timed_phase("tp", phase_tp, rows, card)
    timed_phase("ep", phase_ep, card)
    timed_phase("pp", phase_pp, rows, card)
    timed_phase("vision", phase_vision, rows, card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} "
          f"s on {card}", flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
