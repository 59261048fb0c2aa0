#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code 1) on failure:

1. build: every CUDA kernel of the port from ``analytics_zoo_tpu_torch/
   ops/csrc``, one ``nvcc`` per source, all started together;
2. kernels: the tensor-core instructions of the built ``flash_fwd.cu``
   (``cuobjdump -sass``: HGMMA in its bf16 instances, HMMA in its f32
   ones, neither 0); then the kernel against its plain PyTorch version on
   the card, at the shapes BERT-base serving gives it (B=32, H=12, T=128,
   D=64), in f32 and bf16, for a ragged padding mask with one fully masked
   row, causal attention with Tq < Tk, dropout 0.1 (the keep-mask compared
   bit for bit), the fused-QKV head views, D 32 and 128, and row / key
   counts that are no tile multiple; then its device time (CUDA graph
   replay) and TFLOP/s, with and without dropout, beside the plain
   version's, beside ``scaled_dot_product_attention`` (a yardstick the
   port never calls) and beside its bound on an H100;
3. serve: BERT-base (hidden 768, 12 blocks, 12 heads, seq 128, vocab
   30522) with random weights from a numpy seed, through
   ``InferenceModel.load_keras`` -> ``ClusterServing`` (classic mode,
   in-memory broker) -> ``InputQueue`` / ``OutputQueue``; 64 requests of
   ragged lengths, every answer checked against the same model with the
   plain attention on the card, and the kernel's launch count checked
   (12 per forward).

4. backward: the tensor-core instructions of the built ``flash_bwd.cu``
   (HGMMA in its bf16 instances, HMMA in its f32 ones); ``flash_bwd``,
   given the forward kernel's lse, against the plain backward
   ``_reference_attention_bwd`` on the card at the BERT-base training
   shape (B=32, H=12, T=128, D=64), f32 and bf16: a ragged mask with one
   fully masked row, causal with Tq < Tk and Tq > Tk, dropout 0.1, and a
   long case (Tk=1024, the regime of the JAX package's blockwise
   backward); ``flash_bwd_lse`` against the plain ring block
   ``_block_grads`` at the ring's block shapes (full and diagonal 4,096-row
   blocks, D 32 / 128 at T 1000), adding onto nonzero f32 accumulators;
   dq, dk and dv checked, a second run bit-identical; both timed beside
   their plain versions, the backward of ``scaled_dot_product_attention``
   (a yardstick the port never calls) and the bound on an H100;
5. train: BERT-base (dropout 0.1, 2 classes) from random weights of a
   numpy seed, batch 32, through ``TFDataset.from_ndarrays`` ->
   ``BERTClassifier(optimizer=AdamWeightDecay(...))`` -> ``.train``: 12
   ``flash_fwd`` and 12 ``flash_bwd`` launches per step, one step's loss
   and every gradient against the same step with the plain attention, the
   loss falling over 10 steps on a fixed batch in f32 and in mixed
   precision (bf16 kernels), the step time and a profiler breakdown; then
   with tracing on, f32, an eager epoch and a graph epoch (K = 4) of 8
   steps: the ``train.epoch`` / ``train.step`` / ``train.prefetch`` span
   counts (one ``train.step`` a dispatch), ``zoo_train_steps_total``, the
   launches, and the ``train_state`` pool of the memory ledger equal to
   the parameter and optimizer bytes summed from the tensors; and one
   planned ``checkpoint_write`` fault, retried from the latest checkpoint
   (one ``train.retry`` span) to the weights of a run without the fault.
5b. train_bench: BERT-base training as ``bench.py:322-346`` builds it,
   through ``BERTClassifier.train``: the bench's 8,192 sequences of
   ``RandomState(0)`` (learnable labels), batch 256 on the DEVICE tier
   (``memory_type="DEVICE"``), ``AdamWeightDecay(lr=1e-4,
   state_dtype="bfloat16")``, mixed precision with the bf16 gradient tree,
   ``steps_per_dispatch=32`` (one CUDA graph of a whole step, replayed 32
   times a dispatch), 8 epochs.  Checked: exactly 12 ``flash_fwd`` and 12
   ``flash_bwd`` launches a step counted through the replays; the epoch
   losses fall and the first 32 steps agree with ``steps_per_dispatch=1``
   within ``BENCH_BF16_RTOL``; in f32 at batch 32 with dropout, 8 steps
   through the graph (K = 4) equal 8 eager steps (losses 1e-5 relative,
   weights 1e-5 of max|p|); a checkpoint at an epoch end restored into a
   new estimator (``resume=True``) trains the next epoch to the
   uninterrupted run's losses within 1e-6 relative.  Reported at batch
   256, graph against K = 1: step ms, samples/s, the device-busy share of
   a dispatch (profiler), peak memory and the model-FLOPs share of the
   bf16 dense peak.
6. paged: the tensor-core instructions of the built ``paged_chunk.cu``
   (HGMMA in its bf16 instances, HMMA in its f32 ones); ``paged_decode``
   and ``paged_chunk`` against their plain versions on the card at the
   shapes GPT-2-small serving gives them (decode: B=32, H=Hkv=12, D=64,
   bs=16, 64-entry tables, lengths 0..1024; chunk: 256 rows after 512
   cached tokens), f32 and bf16, with GQA, dead lanes, ragged lengths,
   tables that run past the sequence into a scratch page of garbage and a
   padded chunk tail, a repeat of each bit-identical; then their times
   (eager, and device time by CUDA graph replay with GB/s or TFLOP/s, also
   with the split rule forced to one split) beside the plain versions,
   beside ``scaled_dot_product_attention`` over the same K/V laid out
   contiguously (a yardstick the port never calls: no single PyTorch call
   computes paged attention) and beside the bound; decode also at the
   ragged lengths (bound from the visible tokens), the chunk also at start
   0 and 256;
7. llm: a decoder LM at the published widths of GPT-2 small (vocab 50257,
   768 wide, 12 heads, 12 layers, FFN 3072, 1024 positions) with random
   weights from a numpy seed, served through ``LLMServing`` (32 decode
   slots, 2048 blocks of 16 tokens, 256-token prefill chunks, radix prefix
   cache, in-memory broker) and ``GenerationClient``: one burst of 64
   requests (prompts 16..768 tokens, half behind one shared 256-token
   prefix, 32 new tokens each).  Checked: every request ``ok`` with 32
   tokens, no live table left, prefix hits, 12 ``paged_decode`` launches
   per decode call and 12 ``paged_chunk`` launches per prefill chunk, each
   served token's logit within 1e-3 of the best under a teacher-forced
   dense forward with plain attention, and one decode step's logits
   against the dense forward; reported: tokens/s, TTFT, inter-token
   latency, occupancy, the decode step at 32 live slots and profiler
   breakdowns of a decode step and a prefill chunk, with each paged
   kernel's device time in them.
7b. mp_llm: model-parallel serving: the llm phase's GPT-2-small weights
   served through ``LLMServing(model_parallel=mp)`` over a model sharded
   along KV heads on ``Mesh(["cuda:0"] * mp, ("model",))``, mp 2 and 4,
   beside the unsharded engine: 16 requests (prompts 16..768 tokens, half
   behind one prefix, 16 new tokens each), all queued before the engine
   starts, so each run follows one schedule.  Checked: every token equal
   to the unsharded engine's, 12 x mp ``paged_decode`` launches per decode
   call and 12 x mp ``paged_chunk`` launches per prefill chunk, no input
   copied, each shard's KV pages exactly 1/mp of the unsharded pool's
   bytes, no live table left; then 16 lanes prefilled through the model's
   entry points, each prefill chunk's and one decode step's logits equal
   to the unsharded ones (``MP_LOGIT_ATOL``), with exactly 12 x mp launches
   in that step and in one chunk.  Reported: KV bytes per shard, tokens/s
   and the p50 decode-step ms beside the unsharded engine's.
7c. mesh2d: the serve phase's BERT-base classifier (numpy seed 0, f32)
   through ``InferenceModel.predict`` at batch 32 inside ``context_scope``
   of a context over ``data`` 2 x ``model`` 2 on ``["cuda:0"] * 4``:
   exactly 48 ``flash_fwd`` launches (12 layers x 4 blocks) a forward, no
   input copied, answers within ``MESH2D_ATOL`` of the same model without
   the context; ``sharded_flash_attention`` with dropout 0.1 at B32 H12
   T128 D64: its keep-mask equal, bit for bit, to its plain version's
   with the same seed; predict ms with and without the context.
7d. parallel: ``moe_ffn`` at d 768, d_ff 3072, 8 experts, 4,096 tokens
   over ``Mesh(["cuda:0"] * 4, ("expert",))`` and ``pipeline_apply`` of 4
   residual MLP stages (768 / 3072) over 8 microbatches of a batch of 256
   on ``Mesh(["cuda:0"] * 4, ("pipeline",))``: each against its unsharded
   form on the card and against the CPU (``PARALLEL_ATOL``), and their ms.
7e. mesh_train: sharded training.  The train_bench phase's BERT-base
   configuration (dropout 0.1, ``AdamWeightDecay(lr=1e-4,
   state_dtype="bfloat16")`` with its schedule over the run's 16 steps,
   mixed precision, bf16 gradients, DEVICE tier, batch 256) through
   ``BERTClassifier(shard_optimizer=True).train`` inside
   ``context_scope`` of a data 2 x model 2 context on ``["cuda:0"] * 4``,
   2 epochs of 8 steps at K = 8: exactly 48 ``flash_fwd`` and 48
   ``flash_bwd`` launches a step counted through the replays, no input
   copied, the second epoch's loss below the first, and the weights' and
   optimizer state's bytes a position equal to what the Megatron and ZeRO
   specs give from the shapes (ratios against replicated printed); the
   same run unsharded beside it (step ms, samples/s, peak memory).  Then
   f32 at batch 32, dropout off, SGD, 4 steps: data 2 x model 2 with
   ZeRO, data 4 with ZeRO, two microbatches and K = 4 graph replays, each
   against the unsharded estimator (losses 1e-5 relative, weights 1e-5 of
   max|p|), the replays also against eager; the main path's own update
   (the bench's ``AdamWeightDecay`` with a bf16 first moment, mixed
   precision, bf16 gradients) through ``BERTClassifier.train`` at batch
   32, dropout off, one dispatch of 4 graph replays, data 2 x model 2
   with ZeRO against the unsharded classifier: losses, weights and both
   moments within ``MESH_TRAIN_BF16_TOL`` (the epoch-loss check above
   cannot tell a wrong update from a right one over 16 steps); a per-host
   checkpoint written at the end of epoch 1 of a sharded run and resumed
   by a new estimator: its weights after epoch 2 equal to the
   uninterrupted run's (0 difference).
7f. multiproc: training over processes.  ``RayContext(num_workers=2)``
   starts two workers (``spawn``); each calls ``init_zoo_context`` with
   the coordinator, ``num_processes=2`` and its rank: on a one-card
   machine both drive ``cuda:0`` and the collectives go over gloo (NCCL
   when each has a card of its own); the backend, each rank's device and
   whether gloo reduce-scatters CUDA tensors are printed.  The workers
   train the BERT-base classifier at full width.  (a) f32, dropout off,
   ``SGD(lr=0.05, momentum=0.9)``, global batch 32 (16 a rank), 4 steps
   through ``BERTClassifier.train``: losses and weights against the
   one-process data-2 run of the same classifier on the same weights and
   data (``MULTIPROC_RTOL``), and the same run with ``shard_optimizer=
   True`` against it (``MULTIPROC_ZERO_TOL``), each rank holding half the
   momentum.  (a') the main path's update, dropout off: the bench's
   classifier (AdamWeightDecay with a bf16 first moment, mixed precision,
   bf16 gradients all-reduced over the backend) at global batch 32 for 4
   steps, its losses, weights and both moments against the one-process
   data-2 run (``MULTIPROC_BF16_TOL``), and the backend's sum of the
   ranks' seeded bf16 CUDA tensors equal to torch's sum of them.  (b) dropout 0.1 with one int
   seed: each rank's training
   forward on its 16 rows against the rows of the forward of all 32 in
   one process (``MULTIPROC_FWD_ATOL``), its hidden keep-mask and the
   ``flash_fwd`` kernel's attention keep-mask (at its ``bh_offset``)
   equal to its rows of the global masks bit for bit, and 2 training
   steps with dropout: 12 ``flash_fwd`` and 12 ``flash_bwd`` launches a
   step on each rank.  (c) the main path: the train_bench configuration
   (global batch 256, 128 a rank, bf16, the bench's AdamWeightDecay over
   the run's steps, DEVICE tier) through ``BERTClassifier.train``, 2
   calls of one 8-step epoch: launches, the step ms of the second (steps
   run eager: a gloo collective cannot sit in a CUDA graph) with the host
   time of its all-reduces, and the bytes each rank all-reduced a step,
   over gloo through the host on one shared card (not an NCCL figure).
8. ring: ``flash_fwd_lse`` against its plain version on the card at the
   block shapes of sequence-parallel ring attention at GPT-2-small /
   BERT-base attention width (H=12, D=64; B=2, T=16,384 over four shards,
   so 4,096-row blocks): a full block, the diagonal causal block,
   end-aligned causal with Tq < Tk, a ragged T and D 32 / 128, f32 and
   bf16, output and log-sum-exp; its time and TFLOP/s on a full and on a
   diagonal causal block beside the plain version's, the bound and
   ``scaled_dot_product_attention`` (a yardstick the port never calls,
   which returns no log-sum-exp).  Then ``ring_attention`` over
   ``Mesh(["cuda:0"] * 4, ("sequence",))``, forward and backward through
   its ``autograd.Function``, f32 and bf16, causal and not: exactly 10 /
   16 ``flash_fwd_lse`` launches per causal / full forward and as many
   ``flash_bwd_lse`` per backward; output, lse and gradients against the
   ring with plain blocks at T=16,384, and against dense plain attention
   and its autograd gradients at T=4,096; forward and forward+backward
   times, a profiler breakdown of one forward, and one of a backward in
   which no library GEMM may run.
9. ncf: NeuralCF at MovieLens-1M width (6040 users, 3706 items, 64-wide
   tables, MLP 128-64-32, fused tables) with random weights from a numpy
   seed, served through ``InferenceModel.load_keras`` -> classic
   ``ClusterServing`` (in-memory broker): a burst of request batches of
   1..1024 (user, item) pairs, every answer within 1e-5 of the same model
   on the CPU, one batch with out-of-range ids answered with the CPU's NaN
   rows and the requests after it still answered (no device assert), and
   ``recommend_for_user`` over all items giving the CPU's top 10; then NCF
   and WideAndDeep (MovieLens-1M columns) trained through ``compile`` /
   ``fit`` at batch 65,536 for 10 steps, the first 3 losses within 1e-4
   relative of the same steps on the CPU; predict ms, requests/s, step ms,
   samples/s and one training step's device-busy share.  The path runs
   no kernel of the port (checked: every launch count stays 0).
9b. zoo: TextClassifier at its full default width (vocab 20,000, 200-wide
   tokens, 500 steps, a 256-wide encoder, 20 classes) with each encoder,
   cnn / lstm / gru, random weights from a numpy seed, f32 with TF32 off:
   served through ``InferenceModel.load_keras`` -> ``ClusterServing(
   ServingConfig())`` (pipelined, in-memory broker), one burst of 64
   requests of 500 token ids, every answer within 1e-4 of the same model
   on the CPU, requests/s and p50 / p99; trained with ``compile(Adagrad(
   lr=0.01), "sparse_categorical_crossentropy")`` / ``fit`` at batch 128
   from the DEVICE tier (4,096 sequences of ``RandomState(0)``, the label
   a class token planted at a random position), 2 epochs of 32 steps, 32
   steps a dispatch (CUDA graph replays), and one epoch again with one
   step a dispatch: the first 3 steps within 1e-4 relative of the CPU's
   (dropout on, the same seeds), the graph's first epoch within 1e-5 of
   eager (losses relative, weights of max|p|), the last epoch's loss below
   the first's; step ms, samples/s, the device-busy share of 2 profiled
   graph replays and of 1 profiled eager step, peak memory, and the LSTM
   step's top device operations.
   SessionRecommender (3706 items, history), AnomalyDetector((24, 1)) and
   ImageClassifier (lenet 28x28x1, vgg and resnet 32x32x3, 10 classes):
   predictions within 1e-5 of the CPU, 3 SGD steps within 1e-4 relative.  A Sequential of
   Convolution2D -> BatchNormalization -> relu -> global average pool ->
   Dense: 8 steps through the graph (K = 4) against 8 eager steps, losses
   1e-5 relative, weights and moving statistics 1e-5 of max.  No kernel of
   the port launches on this path (checked: every count stays 0).
9c. heads: BERT token tagging (NER) and extractive QA (SQuAD) at BERT-base
   width (vocab 30522, hidden 768, 12 blocks, 12 heads, FFN 3072, its
   512-position table, dropout 0.1) from random weights of a numpy seed:
   NER at seq 128, batch 32, the 9 CoNLL-2003 BIO tags (a fixed function
   of the token id), ``AdamWeightDecay(lr=1e-4)``; SQuAD at Google BERT's
   README settings for SQuAD 1.1 with BERT-Base (seq 384, batch 12,
   ``AdamWeightDecay(lr=3e-5)``), its features written under
   ``run_squad.py``'s names to a TFRecord file with the port's
   ``build_example`` / ``write_records``, read back with
   ``read_example_file`` and checked equal; valid lengths ragged (16..128,
   128..384), the answer span planted in the valid part.  Each head,
   through ``BERTNER`` / ``BERTSQuAD`` and ``TFDataset``: 12 ``flash_fwd``
   launches a forward and 12 + 12 a training step (eager, and through CUDA
   graph replays); one step with the kernels against plain attention (loss
   1e-5, gradients 1e-3 of max|g|, f32), and repeated with the same bits;
   predictions against plain
   attention (NER 1e-4, SQuAD 1e-4 x max(1, max|ref|), ``predict``'s
   list of two (N, 384) arrays); 8 f32 steps through the graph
   (``steps_per_dispatch=4``) against 8 eager steps (losses 1e-5 relative,
   weights 1e-5 of max|p|); mixed precision from the DEVICE tier, 2 epochs
   of one dispatch each, the last epoch's loss below the first's.  Step
   ms, samples/s, device-busy share and peak memory (graph and eager),
   predict ms.  ``flash_fwd`` / ``flash_bwd`` at B12 H12 T384 D64 with a
   ragged padding mask, f32 and bf16, against their plain versions and
   timed beside them, ``scaled_dot_product_attention`` given the same mask
   (its backward) and the bound.  Then, against the same models on the
   CPU, with no port kernel launched: KNRM (vocab 20,000, embed 300, 21
   kernels, texts of 10 and 40 tokens; scores within 1e-5 of the f32
   reference, logged beside the card's and the f32 reference's distance
   to a float64 reference on the CPU; the pooling
   constants made on the card equal to numpy's f32 values, 3 SGD steps
   1e-4 relative, NDCG@3 and MAP equal), Seq2seq (vocab 20,000, embed 64,
   hidden 128, 2 layers, 30 tokens; probabilities 1e-5, ``infer``'s tokens
   equal or each chosen logit within 1e-4 of its step's best, 3 SGD steps
   1e-4), ``LocalEstimator`` and a ``CustomLoss`` in ``fit`` (losses 1e-4
   relative).
10. http: the pipelined engine and the HTTP frontend.  BERT-base (as in
   serve, random weights from numpy seed 0, f32) behind
   ``ClusterServing(ServingConfig())`` (pipelined, in-memory broker): 64
   requests in one burst through the broker, then the same 64 over
   ``ServingFrontend(port=0)`` from 4 client threads, half JSON, half
   ``FastWireHttpClient``; a malformed frame first (400, the next request
   on that connection answered); every answer within 1e-4 of the model
   with the plain attention on the card, exactly 12 ``flash_fwd``
   launches per dispatched forward; requests/s, p50 / p99 latency and
   the dispatched batch sizes.  Then the GPT-2-small-width decoder LM of
   the llm phase behind ``ServingFrontend(llm=...)``: 16 prompts (half
   behind one 256-token prefix, 32 new tokens each) through the broker
   and then streamed over HTTP, 4 client threads each; every stream the
   broker path's tokens, one frame per token in order; 12 ``paged_chunk``
   launches per prefill chunk and 12 ``paged_decode`` per decode step; a
   1 ms deadline raising ``ServingDeadlineError`` and the same client
   serving the next stream; ``leak_check`` zero after; TTFT p50 / p99
   over HTTP and through the broker, mean inter-token latency over HTTP.
   With observability (every request carries ``X-Zoo-Trace`` from
   ``new_trace_context()``): the JSON answers echo it and every request's
   trace holds its ``http.predict`` span; ``/metrics`` parses as
   Prometheus text, ``zoo_http_requests_total`` and
   ``zoo_serving_records_total`` move by the requests sent and
   ``zoo_llm_tokens_total`` by the tokens streamed; four requests sent
   one at a time have exactly ``http.predict`` -> ``serving.decode`` ->
   ``serving.dispatch`` -> ``serving.sink`` under ``/spans?trace_id=``;
   two streams are ``http.generate`` -> ``llm.prefill`` with one
   ``llm.token`` event per token; ``/debug/memory``'s ``kv_blocks``
   books equal the blocks held x bytes per block, within
   ``torch.cuda.memory_allocated()``, its device section within the
   card's memory.  The BERT burst runs again with ``set_enabled(False)``
   (both rates and p50s logged, no bar).  The chaos checks ride on the
   same engines (``[obs]`` lines): one ``raise`` at ``device_execute``
   fails exactly its client batch of 8, its dump under
   ``/debug/flightrecorder`` holds the faulted ``serving.dispatch`` with
   the injection event, and the next 8 answers hold against the plain
   attention; one ``raise`` at ``decode_step`` errors the 4 decoding
   sequences, after which no table is left and the memory ledger's sweep
   reads clean.

11. ingest: the sharded ingest path.  SQuAD as the heads phase makes it
   (BERT-base, seq 384, batch 12, ``AdamWeightDecay(lr=3e-5)``, dropout
   0.1, mixed precision), its 192 features under ``run_squad.py``'s names
   written as 8 TFRecord shards, read by ``ShardedFeatureSet(shuffle=True,
   seed=0, window_shards=2)`` with ``Transforms().cast("int32", ...)`` on
   the id fields fused into the step, trained through ``Estimator`` with
   4 steps a dispatch (CUDA graph replays), 2 epochs of 16 steps; the net
   reads the shards' dict of columns through a small adapter module.
   Checked, each to 0 difference in the per-step losses and the weights:
   ``fuse=False`` against ``fuse=True``; a run stopped after dispatch 2 of
   epoch 1 and resumed in a fresh ``Estimator`` (``resume=True``, the
   checkpoint's ``data_cursor``) against the uninterrupted run; one
   planned ``shard_read`` raise in epoch 1 retried from the latest
   checkpoint (no ``zoo-data-*`` thread left); ``shuffle=False`` shards
   against the DEVICE tier of the same records in the same order.  Each
   epoch sees every ``unique_ids`` once (across the restart too), 12 + 12
   launches a step through the replays, ``zoo_data_shards_read_total``
   8 decoded in epoch 0 and 8 staged in epoch 1, and a profiled epoch
   holds no pageable host-to-device copy.  Step ms, samples/s, data-wait
   ms a step and the device-busy share, beside the heads phase's
   DEVICE-tier SQuAD step.  NeuralCF (MovieLens-1M width) from the
   1,000,209 records of 8 ``.npz`` shards at batch 8,192, 3 epochs, in
   bench.py's three legs (eager: no prefetch, no staging, transforms on
   the host; prefetch: the pipeline and staging; fused): equal weights
   (0 difference), warm-epoch samples/s and data wait per leg.
12. multimodel: a ``ModelRegistry`` holding BERT-base ``bert_a`` (the
   serve phase's weights, pinned), BERT-base ``bert_b`` (another seed),
   the ncf phase's NeuralCF and the zoo phase's TextClassifier(cnn), the
   last three staged in pinned host memory, under a budget of exactly
   ``bert_a`` + ``bert_b`` bytes, behind ``ClusterServing(registry,
   ServingConfig())`` and ``ServingFrontend(port=0)``: each page-in timed;
   evicting ``bert_b`` frees its bytes of ``memory_allocated`` and a
   re-placed copy equals its host copy bit for bit; 128 requests from 4
   threads round-robin over the models and over ``/predict/<model>``,
   ``X-Zoo-Model`` and the JSON ``"model"`` key: 12 ``flash_fwd``
   launches per BERT forward and none else, the books equal to the
   resident models' bytes at every sample, the ledger's sweep clean, at
   least 2 evictions, every answer against the same model alone on the
   card (BERT 1e-4, NCF 1e-5, TextClassifier 1e-4); ``bert_a``'s p50
   idle and while ``bert_b`` pages in; ``weight_page`` raises, armed
   while ``ncf``'s requests are out, fail only them and open its breaker
   while the other three models answer.
13. tenancy: the http phase's BERT-base behind
   ``ServingConfig(tenants=(("gold", 64, 1.0), ("free", 8, 1.0)))``:
   ``free`` floods from 3 threads (8 requests in flight each; the
   frontend's coalescer off, so each request meets the gate alone) while
   ``gold`` sends 16 from one; every ``gold`` request answered within
   1e-4 of plain attention, ``free``'s excess shed with 429, and the
   per-tenant books equal to what was sent and answered.
14. health: ``HealthMonitor(device="cuda:0")``: a probe reads healthy;
   three planned ``health_probe`` raises open the card's breaker and fire
   ``on_failure`` once; a probe issued during a 32-replay training
   dispatch of the train_bench configuration reads ``ok``.
15. batching: the http phase's BERT-base (numpy seed 0, f32) as an
   ``InferenceModel`` taking the three inputs packed in one (N, 3, 128)
   int32 array, behind ``BatchingService(max_batch=32, max_delay_ms=5)``
   (the native request queue): 64 single requests of valid lengths 8..128
   from 8 threads, every answer within 1e-4 of the model with the plain
   attention, exactly 12 ``flash_fwd`` launches per batched forward;
   requests/s, p50 / p99 and the batch sizes.  Then one planned
   ``device_execute`` raise fails its batch and opens the service's
   breaker (threshold 1), the next request fails fast with
   ``CircuitOpenError``, and after the recovery time a probe is answered
   and closes it.
16. native: the same model behind the pipelined
   ``ClusterServing(ServingConfig(redis_url="native://"))`` over
   ``get_broker("native://")`` (the C++ queue broker): 64 requests through
   ``InputQueue`` / ``OutputQueue``, answers within 1e-4 of plain
   attention, 12 launches per dispatched forward.  (The ingest phase's
   shards stage through the native ``NativeSampleCache``, which it checks
   and prints.)
17. fleet and durable, in a fresh interpreter of this script (a process
   that has initialised CUDA cannot fork replicas that use the card):
   ``FleetSupervisor`` with 2 frontend workers on one SO_REUSEPORT port
   and 2 replicas, each building BERT-base on ``cuda:0`` after the fork
   and reporting its ``flash_fwd`` launches to the bridge; 64 requests
   over HTTP from 4 threads, half JSON, half fast-wire; the launches
   summed over the replicas exactly 12 per dispatched forward;
   ``/metrics`` on a worker showing ``zoo_serving_records_total`` 64 and
   ``zoo_fleet_routed_total``; one traced request's 5-span chain
   (``http.predict`` -> ``fleet.route``, ``http.predict`` ->
   ``serving.decode`` -> ``serving.dispatch`` -> ``serving.sink``) under
   ``/spans?trace_id=``; ``kill_replica(1)``, then 12 requests homed on
   it with ``deadline_ms=800`` on one connection: at most the breaker
   threshold (3) fail, the rest divert and are answered.  Then
   ``FleetConfig(durable=True)``: 64 requests enqueued through
   ``InputQueue`` over ``fleet://`` from 4 threads, each thread retrying
   a call that fails, ``kill_broker_owner()`` once half are acknowledged,
   the standby promoted: every acknowledged request answered (none lost)
   and its acknowledged entry's ``dedup_id`` once in the WALs (none
   duplicated); the requests that a caller's retry put in twice, and the
   failover ms, are printed.
   Once both fleets have stopped, every answer against the plain
   attention on the card (1e-4).

The serve, train, llm, ring, heads, http, ingest and mesh_train phases
also check that no kernel input was copied before a launch (the
wrappers' ``copies``).  It prints one JSON line of kernel numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the port beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --ring-cards 4     # on a host with 4 cards

builds the kernels and runs only ring attention at the ring phase's shapes
with one shard on each of the first N cards (the rotation a peer copy),
against the same ring as N shards of ``cuda:0``: outputs and gradients
compared, forward and forward+backward host times of both (every card
synchronised), in turns.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=128, intermediate_size=3072)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and dense
# FLOP/s by operand type.  f32: products accurate to f32 are fastest as
# 3xTF32 on the tensor cores, three TF32 products for one (495 / 3 = 165
# TFLOP/s); the 67 TFLOP/s of the f32 SIMT pipes would put a 3xTF32
# kernel above 100 % of its bound
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 165e12, torch.bfloat16: 989e12}
# kernel vs plain: f32 accumulation order; bf16 two output ulps
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 2.0 ** -7)}
# served probabilities, kernel vs plain attention through 12 f32 blocks
SERVE_ATOL = 1e-4
# backward kernel vs plain: f32 relative to the gradient's scale (five
# products, other summation orders); bf16 as the forward plus one more ulp
# (Z and dS round to bf16 before their products)
BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2.0 ** -6)}
# one training step, kernels vs plain attention, through 12 f32 blocks
TRAIN_LOSS_ATOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3        # of max|g| of each parameter's gradient
BATCH = 32
# the bench's BERT training leg (bench.py:322-346): batch, steps an epoch,
# epochs, steps per dispatch
BENCH = dict(batch=256, steps=32, epochs=8, spd=32)
# graph vs eager steps in f32 (the same kernels; cuBLAS and the f32
# backward sum in a fixed order): losses relative, weights of max|p|
GRAPH_LOSS_RTOL = 1e-5
GRAPH_WEIGHT_RTOL = 1e-5
# graph vs eager in bf16 over the first 32 steps: the same kernels on the
# same inputs in the same order (flash_bwd sums dq in a fixed order, with
# no float atomics), so the losses agree to the bit (0 in every run so
# far); this allows one f32 rounding of a mean loss, where one step's
# wrong dropout mask moves it by 1e-4 or more
BENCH_BF16_RTOL = 1e-6
RESUME_RTOL = 1e-6            # a resumed epoch vs the uninterrupted one
# the public gpt2 checkpoint's config.json: vocab_size, n_embd, n_head,
# n_layer, n_positions; FFN 4 x n_embd
GPT2_SMALL = dict(vocab=50257, hidden=768, n_head=12, n_layers=12,
                  intermediate=3072, max_pos=1024)
PAGED = dict(B=32, H=12, D=64, bs=16, nb=64)   # decode at 32 live slots
CHUNK = dict(Tc=256, start=512)                # one prefill chunk
# served tokens vs a teacher-forced dense forward (f32, 12 blocks): the
# served token's logit within this of the best logit at its position
TEACHER_ATOL = 1e-3
DECODE_ATOL = 1e-3            # one decode step's logits vs the dense ones
# model-parallel serving (7b): mp 2 and 4 beside the unsharded engine.
# Every head's attention is the same kernel on the same data with the same
# key splits (rule_heads), and everything else runs unsharded, so logits
# agree to the bit
MP_LLM = dict(requests=16, new_tokens=16, mps=(2, 4))
MP_LOGIT_ATOL = 0.0
# BERT-base under data 2 x model 2 (7c): flash_fwd's f32 bar (a block's
# rows are the unsharded kernel's; expect 0)
MESH2D_ATOL = 2e-5
# sharded training (7e): the bench's BERT-base under data 2 x model 2 with
# the ZeRO update, 2 epochs of 8 steps at K = 8; sharded vs unsharded f32
# steps (SGD, dropout off): losses relative, weights of max|p|
MESH_TRAIN = dict(steps=8, epochs=2, spd=8)
MESH_TRAIN_RTOL = 1e-5
# the main path's update (AdamW, bf16 first moment and gradients, mixed
# precision) sharded against unsharded: the same kernels on the same
# inputs, the update elementwise on blocks, so the bits should agree; a
# wrong decay mask moves a weight by lr * 0.01 * |p| a step, 1e-6 of
# max|p|, which a looser bar would pass
MESH_TRAIN_BF16_TOL = 0.0
# training over two processes on the card (7f): f32 losses relative and
# weights of max|p| against the one-process data-2 run (each rank's
# weight gradient the sum of a half batch's, where one process multiplies
# the whole batch at once: summation order only); ZeRO over the ranks
# against the ranks without it (the same all-reduced gradient, an
# elementwise update, a copied exchange: the same bits); a rank's dropout
# forward on its rows against those rows of the one-process forward (GEMMs
# of another row count)
MULTIPROC = dict(workers=2, steps=8, epochs=2, timeout_s=900)
MULTIPROC_RTOL = 1e-5
MULTIPROC_ZERO_TOL = 0.0
MULTIPROC_FWD_ATOL = 1e-5
# the main path's update over two processes against one process at data
# 2 (bf16 gradients of half batches, each rounded to bf16, then summed in
# bf16 by the all-reduce, where one process rounds the whole batch's
# once): losses relative, weights and both moments of max|.| per leaf.
# Set at about 2.5x the readings on an H100 (1.152e-3, 1.875e-3,
# 2.027e-2, 1.834e-2, the same in two runs); a dropped or doubled 1/P
# moves the first moment by 1 and the second by 3 of themselves
MULTIPROC_BF16_TOL = dict(loss=3e-3, weights=5e-3, mu=5e-2, nu=5e-2)
# MoE and the pipeline at BERT-base FFN width (7d): against the unsharded
# form on the card (f32, TF32 off: other GEMM shapes), against the CPU
# (sums of 3072 products in another order)
MOE = dict(d=768, d_ff=3072, experts=8, tokens=4096, groups=4)
PIPE = dict(stages=4, d=768, d_ff=3072, batch=256, microbatches=8)
PARALLEL_ATOL = {"card": 1e-5, "cpu": 1e-4}
# sequence-parallel ring attention at GPT-2-small / BERT-base attention
# width: a context long enough to need the split, over four shards
RING = dict(B=2, H=12, T=16384, D=64, sp=4)
RING_DENSE_T = 4096           # the ring against dense attention
LSE_RTOL = 1e-5               # lse (f32 in both versions): x max(1, |lse|)
# the recommendation models at MovieLens-1M width: NCF as bench.py:722-726,
# WideAndDeep's columns as bench.py:980-986, both trained at bench's batch
NCF_ML1M = dict(user_count=6040, item_count=3706, class_num=2,
                user_embed=64, item_embed=64, hidden_layers=(128, 64, 32),
                mf_embed=64)
WND_ML1M = dict(
    wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
    wide_cross_cols=["age-gender"], wide_cross_dims=[100],
    indicator_cols=["occupation", "gender"], indicator_dims=[21, 3],
    embed_cols=["userId", "itemId"], embed_in_dims=[6040, 3952],
    embed_out_dims=[64, 64], continuous_cols=["age"])
REC_BATCH = 65536
REC_SERVE_ATOL = 1e-5         # served probabilities vs the CPU forward
REC_LOSS_RTOL = 1e-4          # training losses, card vs CPU (f32)
# TextClassifier at its full default width (models/textclassification.py's
# defaults), 20 classes: the news20 groups of the upstream example
TEXT_NEWS20 = dict(class_num=20, vocab_size=20000, token_length=200,
                   sequence_length=500, encoder_output_dim=256)
# its training run: the upstream news20 example's batch (and Adagrad), 2
# epochs of 32 steps from the DEVICE tier, 32 steps a dispatch; the burst
ZOO = dict(n=4096, batch=128, steps=32, epochs=2, spd=32, requests=64)
ZOO_SESSION = dict(item_count=3706, include_history=True)  # MovieLens-1M
# the sharded ingest path (11): SQuAD at the heads phase's settings, its
# 192 features in 8 TFRecord shards read in windows of 2, 4 steps a
# dispatch, 2 epochs; NCF from MovieLens-1M's 1,000,209 ratings in 8 .npz
# shards at batch 8,192 (bench.py's ingest legs)
INGEST = dict(features=192, shards=8, window=2, spd=4, epochs=2)
INGEST_NCF = dict(records=1000209, shards=8, batch=8192, epochs=3)
# multi-model serving (12): 128 requests from 4 threads over 4 models
MULTI = dict(requests=128, threads=4, fault_requests=4)
# tenancy (13): gold's 16 requests against free flooding from 3 threads,
# each with 8 requests in flight, 4 rounds
TENANTS = (("gold", 64, 1.0), ("free", 8, 1.0))
TENANCY = dict(gold=16, free_threads=3, free_conns=8, free_rounds=4)
# the rest of serving (15-17): BatchingService, the native-queue broker, the
# fleet (2 frontend workers x 2 BERT-base replicas on the card) and the
# durable fleet across kill_broker_owner()
BATCHING = dict(requests=64, threads=8, max_batch=32, max_delay_ms=5)
FLEET = dict(requests=64, threads=4, workers=2, replicas=2, after_kill=12,
             kill_deadline_ms=800, timeout_s=420)
ZOO_SERVE_ATOL = 1e-4         # served probabilities vs the CPU forward
ZOO_PREDICT_ATOL = 1e-5       # the other zoo models' predictions vs CPU
ZOO_LOSS_RTOL = 1e-4          # training losses, card vs CPU (f32)
ZOO_GRAPH_RTOL = 1e-5         # graph replays vs eager steps (f32)
# the BERT heads at BERT-base width with its 512-position table (dropout
# 0.1): NER at seq 128, batch 32, the 9 CoNLL-2003 BIO tags; SQuAD 1.1 at
# Google BERT's README settings for BERT-Base (run_squad.py
# --max_seq_length=384 --train_batch_size=12 --learning_rate=3e-5)
NER_TAGS = ("O", "B-PER", "I-PER", "B-LOC", "I-LOC", "B-ORG", "I-ORG",
            "B-MISC", "I-MISC")
HEADS = {"ner": dict(seq=128, batch=32, lr=1e-4, min_len=16),
         "squad": dict(seq=384, batch=12, lr=3e-5, min_len=128)}
HEADS_STEPS = 8               # steps an epoch of each head's training set
SQUAD_KEYS = ("unique_ids", "input_ids", "input_mask", "segment_ids",
              "start_positions", "end_positions")   # run_squad.py's names
HEADS_PREDICT_ATOL = 1e-4     # x max(1, max|ref|) for SQuAD's logits
SHIFT_FREE_NOISE = 1e-5       # a gradient 0 in exact arithmetic, of max|g|
# the heads' CPU-comparable models (no kernel): KNRM (vocab, embed, kernels
# and sigmas of models/textmatching.py's defaults; the text lengths are
# this phase's choice), Seq2seq (the JAX defaults' widths, 2 layers)
KNRM_CFG = dict(text1_length=10, text2_length=40, vocab_size=20000,
                embed_size=300, kernel_num=21, sigma=0.1, exact_sigma=0.001)
SEQ2SEQ_CFG = dict(vocab_size=20000, embed_dim=64, hidden=128, num_layers=2)
SEQ2SEQ_T = 30
HEADS_CPU_ATOL = 1e-5         # predictions vs the CPU (f32, TF32 off)
HEADS_CPU_LOSS_RTOL = 1e-4    # training losses vs the CPU
SEQ2SEQ_TIE_ATOL = 1e-4       # a chosen token's logit vs the step's best


def log(*args):
    print(*args, flush=True)


def card_line(every=False) -> str:
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return "\n".join(lines) if every else lines[0]


def cuda_ms(fn, iters=50, warmup=5) -> float:
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


def graph_ms(fn, calls=20, replays=5) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    launch overhead (Python wrappers, one launch each) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def sass_counts(library: str) -> dict:
    """``{kernel function: [HGMMA, HMMA]}``: the tensor-core instructions
    of each kernel in a built library, read with the toolkit's
    ``cuobjdump -sass``."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            op = line.split("*/", 1)[-1]
            if "HGMMA" in op:
                counts[fn][0] += 1
            elif "HMMA" in op:
                counts[fn][1] += 1
    return counts


def wall_ms(fn, cards, iters) -> float:
    """Host time per call of ``fn`` after one warm-up, with the first
    ``cards`` devices synchronised (CUDA events on one device would miss
    the others' work)."""
    def sync():
        for dev in range(cards):
            torch.cuda.synchronize(dev)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters=20, warmup=3, attempts=3) -> float:
    """Device time per call of ``fn``: the profiler's sum of the kernels
    (and memsets / copies) it ran, over ``iters`` calls; host gaps between
    launches are not counted.  A profiler session now and then records
    no device activity at all; such a session is logged and made again,
    at most ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3
        log(f"[profile] session {attempt} of {attempts} recorded no device "
            "time")
    raise AssertionError("the profiler recorded no device time")


def phase_build():
    from analytics_zoo_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    paths = _kernels.build()
    secs = time.perf_counter() - t0
    for src, path in paths.items():
        log(f"[build] {src} -> {os.path.relpath(path, ROOT)}")
    log(f"[build] {len(paths)} kernel source(s) in {secs:.2f} s")


def _attention_inputs(dtype, B, H, Tq, Tk, D, gen):
    mk = lambda T: torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
    return mk(Tq), mk(Tk), mk(Tk)


def _ragged_mask(B, Tk, gen):
    lens = torch.randint(1, Tk + 1, (B,), generator=gen)
    lens[0] = 0                                   # one fully masked row
    return (torch.arange(Tk)[None] < lens[:, None]).to("cuda", torch.int32)


def _extract_keep_mask(flash_attention, B, H, T, D, rate, seed):
    """The kernel's own keep-mask: with q = 0 every score is equal, so
    with V's row j = one-hot(j) output column j is keep[j] * scale / T."""
    q = torch.zeros(B, H, T, D, device="cuda")
    keep = torch.empty(B, H, T, T, dtype=torch.bool, device="cuda")
    idx = torch.arange(D, device="cuda")
    for lo in range(0, T, D):
        v = torch.zeros(B, H, T, D, device="cuda")
        v[:, :, lo + idx, idx] = 1.0
        out = flash_attention(q, q, v, dropout_rate=rate, dropout_seed=seed)
        keep[..., lo:lo + D] = out > 0
    return keep


def _fused_qkv_heads(dtype, B, T, H, D, gen):
    """q, k, v as the BERT layer hands them over: (B, H, T, D) head views
    of one (B, T, 3 * H * D) projection, read in place."""
    qkv = torch.randn(B, T, 3 * H * D, generator=gen).to("cuda", dtype)
    return tuple(t.view(B, T, H, D).transpose(1, 2)
                 for t in qkv.split(H * D, dim=-1))


def flash_sass(name="flash_fwd", phase="kernel") -> dict:
    """HGMMA counts of the bf16 instances and HMMA counts of the f32
    instances (``<name>_bf16`` / ``<name>_f32``) of the built
    ``<name>.cu``; fails if either is 0."""
    from analytics_zoo_tpu_torch.ops import _kernels
    source = f"{name}.cu"
    counts = sass_counts(_kernels.build([source])[source])
    got = {"hgmma_bf16": sum(c[0] for f, c in counts.items()
                             if f"{name}_bf16" in f),
           "hmma_f32": sum(c[1] for f, c in counts.items()
                           if f"{name}_f32" in f),
           "instances": sum(f"{name}_bf16" in f or f"{name}_f32" in f
                            for f in counts)}
    log(f"[{phase}] {source} SASS: {got['instances']} kernel instances, "
        f"HGMMA {got['hgmma_bf16']} in the bf16 ones, HMMA "
        f"{got['hmma_f32']} in the f32 ones (tensor cores reached)")
    if not got["hgmma_bf16"] or not got["hmma_f32"]:
        raise AssertionError(f"{source} misses the tensor cores: {got}")
    return got


def no_copies(phase: str) -> None:
    """The main path hands every kernel its views in place: the fused-QKV
    head views and the ring's shards are aligned for TMA / cp.async."""
    from analytics_zoo_tpu_torch.ops import _kernels
    copies = {k: w.copies for k, w in _kernels.KERNELS.items()}
    log(f"[{phase}] inputs copied before a launch: {copies}")
    if any(copies.values()):
        raise AssertionError(f"{phase}: the main path copied inputs before "
                             f"a launch: {copies}")


def phase_kernels():
    from analytics_zoo_tpu_torch.ops.attention import (
        _hash_keep_mask, flash_attention)
    F = torch.nn.functional
    sass = flash_sass()
    B, H, T, D = 32, 12, 128, 64
    gen = torch.Generator().manual_seed(SEED)
    # at BERT-base serving width, then the head dims and row / key counts
    # that are no tile multiple (bf16 tiles: 64 rows, 64 or 128 keys; f32:
    # 16-row warps, 64 keys)
    cases = {
        "ragged padding mask": dict(Tq=T, mask=True),
        "causal Tq=100 < Tk=128": dict(Tq=100, causal=True),
        "dropout 0.1 + mask": dict(Tq=T, mask=True, dropout_rate=0.1,
                                   dropout_seed=1234),
        "fused QKV head views": dict(Tq=T, mask=True, fused=True),
        "D32 causal Tq=77 Tk=150": dict(Tq=77, Tk=150, D=32, causal=True),
        "D128 mask Tq=129 Tk=200": dict(Tq=129, Tk=200, D=128, mask=True),
        "Tq=1 Tk=191 mask": dict(Tq=1, Tk=191, mask=True),
        "Tq=63 Tk=63 dropout": dict(Tq=63, Tk=63, dropout_rate=0.1,
                                    dropout_seed=7),
    }
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for name, case in cases.items():
            case = dict(case)
            Tq, Tk, d = case.pop("Tq"), case.pop("Tk", T), case.pop("D", D)
            if case.pop("fused", False):
                q, k, v = _fused_qkv_heads(dtype, B, T, H, d, gen)
            else:
                q, k, v = _attention_inputs(dtype, B, H, Tq, Tk, d, gen)
            mask = _ragged_mask(B, Tk, gen) if case.pop("mask", False) \
                else None
            out = flash_attention(q, k, v, padding_mask=mask, **case)
            ref = flash_attention(q, k, v, padding_mask=mask,
                                  backend="plain", **case)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            bad = (diff > atol + rtol * ref.float().abs()).sum().item()
            log(f"[kernel] flash_fwd {str(dtype)[6:]:8s} {name:24s} "
                f"max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}"
                f" -> {'ok' if not bad else f'{bad} elements out'}")
            if bad or not torch.isfinite(out).all():
                raise AssertionError(f"flash_fwd disagrees with its plain "
                                     f"version: {dtype} {name}")
            errs.setdefault(dtype, 0.0)
            errs[dtype] = max(errs[dtype], err)
    keep = _extract_keep_mask(flash_attention, B, H, T, D, 0.1, 1234)
    want = _hash_keep_mask(1234, (B, H, T, T), 0.1, device="cuda")
    if not torch.equal(keep, want):
        raise AssertionError("flash_fwd keep-mask differs from the counter "
                             "hash")
    log(f"[kernel] flash_fwd keep-mask bit-identical to the plain version's "
        f"({keep.numel()} positions, kept {keep.float().mean().item():.4f})")

    # timing at the serving shapes; an all-valid mask, so the work the
    # bound counts is the full T x T per head.  ms, plain_ms, library_ms:
    # back-to-back eager calls (CUDA events, host overhead included where
    # it exceeds the kernel), as in every earlier row; *device_ms: device
    # time per call by CUDA graph replay, the wrapper's host time left out
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _attention_inputs(dtype, B, H, T, T, D, gen)
        mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
        bool_mask = (mask != 0)[:, None, None, :]
        kernel = lambda: flash_attention(q, k, v, padding_mask=mask)
        plain = lambda: flash_attention(q, k, v, padding_mask=mask,
                                        backend="plain")
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=bool_mask)
        ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(sdpa)
        dev_ms = graph_ms(kernel)
        drop_ms = graph_ms(lambda: flash_attention(
            q, k, v, padding_mask=mask, dropout_rate=0.1, dropout_seed=5))
        plain_dev_ms, lib_dev_ms = graph_ms(plain), graph_ms(sdpa)
        nbytes = 4 * B * H * T * D * q.element_size() + mask.numel() * 4
        flops = 4 * B * H * T * T * D
        bound, by, t_bytes, t_ops = _bound(nbytes, flops, dtype)
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, bound_by=by,
                           max_abs_err=errs[dtype], device_ms=dev_ms,
                           dropout_device_ms=drop_ms,
                           plain_device_ms=plain_dev_ms,
                           library_device_ms=lib_dev_ms,
                           device_tflops=flops / dev_ms / 1e9, **sass)
        log(f"[kernel] flash_fwd {str(dtype)[6:]:8s} B{B} H{H} T{T} D{D}: "
            f"eager calls: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa"
            f" {lib_ms:.4f} ms; device time (graph replay): kernel "
            f"{dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s; dropout "
            f"0.1 {drop_ms:.4f} ms), plain {plain_dev_ms:.4f} ms, sdpa "
            f"{lib_dev_ms:.4f} ms; bound {bound:.4f} ms ({by}; bytes "
            f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms at "
            f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s)")
        del q, k, v
    return rows


def _random_tree(net, rng):
    """Weights from a numpy seed in the JAX tree layout (std 0.02; LayerNorm
    gains around 1)."""
    tree = {}
    for path, p in net.state_dict().items():
        w = rng.standard_normal(tuple(p.shape), dtype=np.float32) * 0.02
        if path.endswith("gamma"):
            w += 1.0
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = w
    return tree


def _requests(n, rng, cfg):
    T = cfg["seq_len"]
    reqs = {}
    for i in range(n):
        length = int(rng.integers(8, T + 1))
        ids = rng.integers(1, cfg["vocab"], T).astype(np.int32)
        ids[length:] = 0
        reqs[f"req-{i:03d}"] = {
            "input_ids": ids,
            "token_type_ids": (np.arange(T) >= length // 2).astype(np.int32),
            "input_mask": (np.arange(T) < length).astype(np.int32)}
    return reqs


def phase_serve(cfg=BERT_BASE, device="cuda", n_requests=64,
                batch_size=32):
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    rng = np.random.default_rng(SEED)
    clf = BERTClassifier(num_classes=2, bert_config=cfg, device=device)
    tree = _random_tree(clf.net, rng)
    names = ("input_ids", "token_type_ids", "input_mask")
    im = InferenceModel(device=device).load_keras(
        clf.net, (tree, {}),
        preprocessor=lambda d: [d[n] for n in names])
    log(f"[serve] BERT classifier {cfg}, {clf.net.param_count():,} "
        f"parameters (f32) on {device}")
    reqs = _requests(n_requests, rng, cfg)
    stacked = {n: np.stack([r[n] for r in reqs.values()]) for n in names}
    im.warmup(stacked, [2 ** i for i in range(batch_size.bit_length())])

    forwards = [0]
    hook = clf.net.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    broker = InMemoryBroker()
    serving = ClusterServing(im, ServingConfig(
        pipeline=False, batch_size=batch_size, redis_url="memory://"),
        broker=broker).start()
    iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
    sent, done, results = {}, {}, {}
    try:
        _kernels.reset_launches()
        forwards[0] = 0
        t_start = time.perf_counter()
        for uri, data in reqs.items():
            sent[uri] = time.perf_counter()
            iq.enqueue(uri, **data)
        for uri in reqs:
            results[uri] = oq.query_blocking(uri, timeout=300)
            done[uri] = time.perf_counter()
        t_end = time.perf_counter()
        launches = _kernels.flash_fwd.launches
        n_forwards = forwards[0]
        no_copies("serve")
    finally:
        serving.stop()
        hook.remove()
    missing = [u for u, r in results.items() if r is None]
    if missing:
        raise AssertionError(f"no result for {missing}")
    lat = np.array([done[u] - sent[u] for u in reqs]) * 1e3
    rps = n_requests / (t_end - t_start)
    log(f"[serve] {n_requests} requests (burst) in {t_end - t_start:.4f} s: "
        f"{rps:.2f} req/s, latency p50 {np.percentile(lat, 50):.3f} ms, "
        f"p99 {np.percentile(lat, 99):.3f} ms, in {n_forwards} forwards")
    log(f"[serve] flash_fwd launches {launches} = "
        f"{launches / max(n_forwards, 1):g} per forward")
    if n_forwards == 0 or launches != cfg["n_block"] * n_forwards:
        raise AssertionError(f"expected {cfg['n_block']} flash_fwd "
                             f"launches per forward, got {launches} in "
                             f"{n_forwards} forwards")

    # every answer against the same model with the plain attention
    served = np.stack([np.asarray(results[u]).ravel() for u in reqs])
    set_attention_backend(clf.net, "plain")
    try:
        want = np.concatenate([
            im.predict({n: v[s:s + batch_size] for n, v in stacked.items()})
            for s in range(0, n_requests, batch_size)])
    finally:
        set_attention_backend(clf.net, None)
    err = float(np.abs(served - want).max())
    ok = (served.shape == (n_requests, 2) and np.isfinite(served).all()
          and np.allclose(served.sum(-1), 1.0, atol=1e-5)
          and err <= SERVE_ATOL)
    log(f"[serve] served probabilities vs plain attention on the card: "
        f"max_abs_err={err:.3e} tol={SERVE_ATOL:g} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("served results disagree with the plain path")

    x = {n: v[:batch_size] for n, v in stacked.items()}
    fwd_ms = cuda_ms(lambda: im.predict(x), iters=10, warmup=2)
    set_attention_backend(clf.net, "plain")
    try:
        plain_fwd_ms = cuda_ms(lambda: im.predict(x), iters=10, warmup=2)
    finally:
        set_attention_backend(clf.net, None)
    log(f"[serve] InferenceModel.predict at batch {batch_size}: "
        f"{fwd_ms:.3f} ms with the kernel, {plain_fwd_ms:.3f} ms with the "
        f"plain attention")
    profile_breakdown(lambda: im.predict(x), f"predict at batch {batch_size}")
    return launches


def _bwd_inputs(dtype, B, H, Tq, Tk, D, gen, mask=False):
    q, k, v = _attention_inputs(dtype, B, H, Tq, Tk, D, gen)
    go = torch.randn(B, H, Tq, D, generator=gen).to("cuda", dtype)
    return q, k, v, go, (_ragged_mask(B, Tk, gen) if mask else None)


def phase_backward():
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops.attention import (
        _reference_attention_bwd)
    sass = flash_sass("flash_bwd", "backward")
    B, H, T, D = 32, 12, 128, 64
    gen = torch.Generator().manual_seed(SEED + 1)
    cases = {
        "ragged padding mask": dict(Tq=T, Tk=T, mask=True),
        "causal Tq=100 < Tk=128": dict(Tq=100, Tk=T, causal=True),
        "causal Tq=128 > Tk=100": dict(Tq=T, Tk=100, causal=True),
        "dropout 0.1 + mask": dict(Tq=T, Tk=T, mask=True, dropout_rate=0.1,
                                   dropout_seed=4321),
        "long Tk=1024 + mask": dict(Tq=T, Tk=1024, mask=True),
    }
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = BWD_TOL[dtype]
        for name, case in cases.items():
            case = dict(case)
            q, k, v, go, mask = _bwd_inputs(dtype, B, H, case.pop("Tq"),
                                            case.pop("Tk"), D, gen,
                                            case.pop("mask", False))
            kw = dict(causal=case.get("causal", False), sm_scale=D ** -0.5,
                      dropout_p=case.get("dropout_rate", 0.0),
                      seed=case.get("dropout_seed"))
            # o and lse as a training forward hands them to the backward
            o, lse = _kernel_fwd(_kernels, q, k, v, mask, **kw)
            got = _kernel_bwd(_kernels, q, k, v, o, go, lse, mask, **kw)
            again = _kernel_bwd(_kernels, q, k, v, o, go, lse, mask, **kw)
            ref = _reference_attention_bwd(
                q, k, v, o, go, mask, kw["causal"], kw["sm_scale"],
                kw["dropout_p"], kw["seed"])
            torch.cuda.synchronize()
            worst = _check_grads(f"flash_bwd {dtype} {name}", got, ref,
                                 dtype)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"flash_bwd {dtype} {name}: a repeat "
                                     f"is not bit-identical")
            log(f"[backward] flash_bwd {str(dtype)[6:]:8s} {name:24s} "
                f"max_abs_err={worst:.3e} (dq, dk, dv) tol=atol {atol:g}"
                f"{' x max(1, max|ref|)' if dtype == torch.float32 else ''}"
                f" + rtol {rtol:g}; repeat bit-identical -> ok")
            errs[dtype] = max(errs.get(dtype, 0.0), worst)
    lse_errs = _ring_block_cases(gen)

    # timing at the training shape, all-valid mask: the bound counts the
    # full T x T per head
    rows = {}
    F = torch.nn.functional
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, go, _ = _bwd_inputs(dtype, B, H, T, T, D, gen)
        mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
        bool_mask = (mask != 0)[:, None, None, :]
        kw = dict(causal=False, sm_scale=D ** -0.5, dropout_p=0.0, seed=None)
        o, lse = _kernel_fwd(_kernels, q, k, v, mask, **kw)
        kernel = lambda: _kernel_bwd(_kernels, q, k, v, o, go, lse, mask,
                                     **kw)
        plain = lambda: _reference_attention_bwd(q, k, v, o, go, mask,
                                                 False, D ** -0.5)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves,
                                                      attn_mask=bool_mask)
        sdpa_fwd_bwd = lambda: torch.autograd.grad(sdpa(), leaves, go)
        ms = cuda_ms(kernel)
        # the plain backward and SDPA's run many small launches under
        # autograd, whose host time CUDA events would count: their
        # columns are device time from the profiler (the kernel's too, to
        # show the two clocks agree on it, and by CUDA graph replay)
        kernel_dev = device_ms(kernel)
        graph_dev = graph_ms(kernel)
        plain_ms = device_ms(plain)
        fwd_bwd_ms, fwd_ms = device_ms(sdpa_fwd_bwd), device_ms(sdpa)
        nbytes = 8 * B * H * T * D * q.element_size() + mask.numel() * 4 \
            + lse.numel() * 4
        flops = 10 * B * H * T * T * D
        bound, by, t_bytes, t_ops = _bound(nbytes, flops, dtype)
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms,
                           library_ms=fwd_bwd_ms - fwd_ms, bound_ms=bound,
                           bound_by=by, max_abs_err=errs[dtype],
                           device_ms=kernel_dev, graph_device_ms=graph_dev,
                           device_tflops=flops / graph_dev / 1e9, **sass)
        log(f"[backward] flash_bwd {str(dtype)[6:]:8s} B{B} H{H} T{T} D{D}: "
            f"kernel {ms:.4f} ms (device {kernel_dev:.4f} ms profiler, "
            f"{graph_dev:.4f} ms graph replay, "
            f"{flops / graph_dev / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms (device), sdpa backward "
            f"{fwd_bwd_ms - fwd_ms:.4f} ms (device: forward+backward "
            f"{fwd_bwd_ms:.4f} - forward {fwd_ms:.4f}), bound "
            f"{bound:.4f} ms ({by}; bytes {t_bytes:.4f} ms, operations "
            f"{t_ops:.4f} ms)")
    return rows, _time_ring_block(gen, lse_errs, sass)


def _kernel_fwd(kernels, q, k, v, mask, causal, sm_scale, dropout_p, seed):
    """The forward kernel's (o, lse), as a training forward keeps them."""
    from analytics_zoo_tpu_torch.ops.attention import _drop_args
    return kernels.flash_fwd(q, k, v, mask, causal=causal, sm_scale=sm_scale,
                             with_lse=True, **_drop_args(dropout_p, seed))


def _kernel_bwd(kernels, q, k, v, o, go, lse, mask, causal, sm_scale,
                dropout_p, seed):
    """One direct call of the backward kernel's wrapper."""
    from analytics_zoo_tpu_torch.ops.attention import _drop_args
    return kernels.flash_bwd(q, k, v, o, go, lse, mask, causal=causal,
                             sm_scale=sm_scale,
                             **_drop_args(dropout_p, seed))


def _ring_block(dtype, T, D, causal, gen, B=RING["B"], H=RING["H"]):
    """One ring block: q, k, v, g, the block's own lse and delta, and
    random nonzero f32 accumulators."""
    from analytics_zoo_tpu_torch.ops.attention import (
        _reference_attention_with_lse, _row_delta)
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
                  for _ in range(4))
    o, lse = _reference_attention_with_lse(q, k, v, causal, D ** -0.5)
    acc = [torch.randn(B, H, T, D, generator=gen).to("cuda")
           for _ in range(3)]
    return q, k, v, g, lse, _row_delta(o, g), acc


def _ring_block_cases(gen):
    """``flash_bwd_lse`` against the plain ``_block_grads`` at the ring's
    block shapes, adding onto nonzero accumulators, a repeat
    bit-identical; returns {dtype: max abs error}."""
    from analytics_zoo_tpu_torch.parallel.ring import _block_grads
    T_loc, D = RING["T"] // RING["sp"], RING["D"]
    cases = {
        f"full block T{T_loc} D{D}": dict(T=T_loc, D=D, causal=False),
        f"diagonal block T{T_loc} D{D}": dict(T=T_loc, D=D, causal=True),
        "diagonal T1000 D32": dict(T=1000, D=32, causal=True),
        "full T1000 D128": dict(T=1000, D=128, causal=False),
    }
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = BWD_TOL[dtype]
        for name, case in cases.items():
            q, k, v, g, lse, delta, acc0 = _ring_block(dtype, gen=gen, **case)
            out = []
            for impl in ("cuda", "plain", "cuda"):
                acc = [t.clone() for t in acc0]
                _block_grads(q, g, lse, delta, k, v,
                             0 if case["causal"] else None,
                             case["D"] ** -0.5, *acc, impl=impl)
                out.append(acc)
            torch.cuda.synchronize()
            what = f"flash_bwd_lse {dtype} {name} vs its plain version"
            err = _check_grads(what, out[0], out[1], dtype)
            if not all(torch.equal(a, c) for a, c in zip(out[0], out[2])):
                raise AssertionError(f"{what}: a repeat is not "
                                     f"bit-identical")
            log(f"[backward] flash_bwd_lse {str(dtype)[6:]:8s} {name:24s} "
                f"onto nonzero f32 accumulators: max_abs_err={err:.3e} "
                f"(dq, dk, dv) tol=atol {atol:g}"
                f"{' x max(1, max|ref|)' if dtype == torch.float32 else ''}"
                f" + rtol {rtol:g}; repeat bit-identical -> ok")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            del q, k, v, g, lse, delta, acc0, out
    return errs


def _time_ring_block(gen, errs, sass):
    """``flash_bwd_lse`` on one full and one diagonal ring block beside
    the plain ``_block_grads``, SDPA's backward on the same block (its
    forward + backward less its forward) and the bound."""
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.parallel.ring import _block_grads
    F = torch.nn.functional
    B, H, D = RING["B"], RING["H"], RING["D"]
    T = RING["T"] // RING["sp"]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g, lse, delta, acc = _ring_block(dtype, T, D, False, gen)
        kernel = lambda causal: lambda: _kernels.flash_bwd_lse(
            q, k, v, g, lse, delta, *acc, causal=causal, sm_scale=D ** -0.5)
        ms = cuda_ms(kernel(False), iters=10, warmup=2)
        diag_ms = cuda_ms(kernel(True), iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: _block_grads(
            q, g, lse, delta, k, v, None, D ** -0.5, *acc, impl="plain"),
            iters=3, warmup=1)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib = {}
        for causal in (False, True):
            sdpa = lambda: F.scaled_dot_product_attention(*leaves,
                                                          is_causal=causal)
            lib[causal] = cuda_ms(lambda: torch.autograd.grad(
                sdpa(), leaves, g), iters=5, warmup=1) - cuda_ms(
                    sdpa, iters=5, warmup=1)
        es = q.element_size()
        nbytes = 4 * B * H * T * D * es + 2 * B * H * T * 4 \
            + 2 * 3 * B * H * T * D * 4       # the accumulators: read, write
        flops = 10 * B * H * T * T * D
        diag_flops = 10 * B * H * T * (T + 1) // 2 * D   # seen pairs
        bound, by, t_bytes, t_ops = _bound(nbytes, flops, dtype)
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib[False],
                           bound_ms=bound, bound_by=by,
                           max_abs_err=errs[dtype], diag_causal_ms=diag_ms,
                           diag_library_ms=lib[True],
                           tflops=flops / ms / 1e9,
                           diag_tflops=diag_flops / diag_ms / 1e9, **sass)
        log(f"[backward] flash_bwd_lse {str(dtype)[6:]:8s} B{B} H{H} T{T} "
            f"D{D}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; "
            f"diagonal causal block {diag_ms:.4f} ms, "
            f"{diag_flops / diag_ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, sdpa backward {lib[False]:.4f} ms (causal "
            f"{lib[True]:.4f} ms), bound {bound:.4f} ms ({by}; bytes "
            f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms at "
            f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s)")
        del q, k, v, g, lse, delta, acc, leaves
    return rows


def _train_batches(n_batches, rng, cfg):
    """``n_batches * BATCH`` BERT inputs with learnable labels (the first
    token's parity, as ``bench.py`` makes them), as a TFDataset."""
    from analytics_zoo_tpu_torch.tfpark import TFDataset
    n, T = n_batches * BATCH, cfg["seq_len"]
    ids = rng.integers(0, cfg["vocab"], (n, T)).astype(np.int32)
    lens = rng.integers(T // 2, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int32)
    labels = (ids[:, 0] % 2).astype(np.int32)
    return TFDataset.from_ndarrays(((ids * mask, seg, mask), labels),
                                   batch_size=BATCH)


def _classifier(cfg, tree, mixed_precision=False):
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    clf = BERTClassifier(
        num_classes=2, bert_config=cfg, mixed_precision=mixed_precision,
        optimizer=AdamWeightDecay(lr=1e-4, warmup_portion=0.1, total=10),
        device="cuda")
    return clf.load_weights(tree)


def _step_loss_and_grads(est, x, y, seed, unused=False):
    """One training forward and backward (no update) of a BERT estimator
    with its loss: loss, gradients by name.  Every parameter must get a
    gradient, but with ``unused`` the pooler's, which a head reading the
    sequence output never reaches: those are zeros, as the estimator
    takes them."""
    from analytics_zoo_tpu_torch.keras import losses
    net = est.net
    net.train()
    try:
        loss = losses.get(est.loss_name)(net(x, seed=seed), y)
        named = list(net.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    finally:
        net.eval()
    out = {}
    for (name, p), g in zip(named, grads):
        if g is None:
            if not (unused and ".pooler." in name):
                raise AssertionError(f"{name}: the loss does not reach it")
            g = torch.zeros_like(p)
        out[name] = g
    return loss.item(), out


def _worst_grad(grads_k, grads_p, skip=()):
    """The largest |d| / max|g| over the gradients (but ``skip``'s), and
    where."""
    worst, worst_name = 0.0, ""
    for name, gk in grads_k.items():
        if name in skip:
            continue
        gp = grads_p[name]
        rel = ((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30)
               ).item()
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def _train_run(clf, ds, steps, what):
    """``steps`` steps of ``clf.train`` on ``ds`` (one batch an epoch),
    launches counted from zero around it; returns (losses, launches)."""
    from analytics_zoo_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    clf.train(ds, epochs=steps, seed=SEED)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
    no_copies("train")
    losses = [h["loss"] for h in clf._train_est.history[-steps:]]
    log(f"[train] {what}: per-step loss "
        f"{' '.join(f'{v:.4f}' for v in losses)}; launches {launches}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: the loss did not fall over {steps} "
                             f"steps on a fixed batch: {losses}")
    return losses, launches


def phase_train(cfg=None, steps=10):
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    from analytics_zoo_tpu_torch.ops import _kernels
    cfg = cfg or dict(BERT_BASE, hidden_drop=0.1, attn_drop=0.1)
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    rng = np.random.default_rng(SEED)
    tree = _random_tree(BERTClassifier(2, bert_config=cfg,
                                            device="cpu").net, rng)
    fixed = _train_batches(1, rng, cfg)
    many = _train_batches(8, rng, cfg)
    n_block = cfg["n_block"]
    log(f"[train] BERT classifier {cfg}, batch {BATCH}, AdamWeightDecay"
        f"(lr=1e-4, warmup 1 of 10 steps), dropout seed {SEED}")

    # 1. launches of one step through the user's entry point
    clf = _classifier(cfg, tree)
    _kernels.reset_launches()
    clf.train(fixed, epochs=1, seed=SEED)
    torch.cuda.synchronize()
    one = (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches)
    log(f"[train] one step: flash_fwd {one[0]}, flash_bwd {one[1]} launches")
    if one != (n_block, n_block):
        raise AssertionError(f"expected {n_block} + {n_block} launches per "
                             f"step, got {one}")

    # 2. one step with the kernels against one with the plain attention,
    # same weights, batch and dropout seed
    x, y = next(iter(fixed.get_training_data().batches(BATCH,
                                                       device="cuda")))
    clf = _classifier(cfg, tree)
    loss_k, grads_k = _step_loss_and_grads(clf, x, y, seed=7)
    set_attention_backend(clf.net, "plain")
    loss_p, grads_p = _step_loss_and_grads(clf, x, y, seed=7)
    set_attention_backend(clf.net, None)
    worst, worst_name = _worst_grad(grads_k, grads_p)
    log(f"[train] kernels vs plain attention, one step: loss {loss_k:.7f} vs "
        f"{loss_p:.7f} (|d| {abs(loss_k - loss_p):.2e}, tol "
        f"{TRAIN_LOSS_ATOL:g}); worst gradient |d|/max|g| {worst:.2e} at "
        f"{worst_name} (tol {TRAIN_GRAD_RTOL:g}) over {len(grads_k)} tensors")
    if abs(loss_k - loss_p) > TRAIN_LOSS_ATOL or worst > TRAIN_GRAD_RTOL:
        raise AssertionError("a training step with the kernels disagrees "
                             "with the plain attention")
    del grads_k, grads_p

    # 3. and 4. the loss falls over 10 steps on a fixed batch, f32 and
    # mixed precision; the f32 run is the main path whose launches count
    runs = {}
    for mixed in (False, True):
        what = "mixed precision (bf16)" if mixed else "f32"
        clf = _classifier(cfg, tree, mixed_precision=mixed)
        losses, launches = _train_run(clf, fixed, steps, what)
        want = dict.fromkeys(_kernels.KERNELS, 0)   # the paged ones: none
        want.update(flash_fwd=steps * n_block, flash_bwd=steps * n_block)
        if launches != want:
            raise AssertionError(f"{what}: expected {want} launches, got "
                                 f"{launches}")
        runs[what] = dict(losses=losses, launches=launches)

    # 5. step time over 8 distinct batches (one host read at the end),
    # after a warm-up epoch, and a device breakdown of one step, in f32
    # and in mixed precision
    step_ms = {}
    for mixed in (False, True):
        what = "mixed precision (bf16)" if mixed else "f32"
        clf = _classifier(cfg, tree, mixed_precision=mixed)
        clf.train(many, epochs=1, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.train(many, epochs=1, seed=SEED + 1)
        torch.cuda.synchronize()
        step_ms[what] = (time.perf_counter() - t0) * 1e3 / 8
        log(f"[train] {what} step at batch {BATCH}: {step_ms[what]:.3f} ms "
            f"({BATCH * 1e3 / step_ms[what]:.2f} samples/s) over 8 steps")
        profile_breakdown(lambda: clf.train(fixed, epochs=1, seed=SEED),
                          f"one {what} training step at batch {BATCH}",
                          top=16)
    _train_observed(cfg, tree, fixed, many)
    return runs["f32"]["launches"], dict(step_ms=step_ms, runs=runs)


def _counter(name, labels=()):
    """A counter's value in the port's registry (0 before its first use)."""
    from analytics_zoo_tpu_torch import observability as obs
    fam = obs.get_registry().snapshot().get(name)
    return 0.0 if fam is None else fam["series"].get(tuple(labels), 0.0)


def _tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _opt_state_tensors(state):
    out = []
    for v in state.values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            out.extend(t for t in v.values() if isinstance(t, torch.Tensor))
    return out


def _train_observed(cfg, tree, fixed, many):
    """Training with tracing on (f32): the span counts and step counter of
    an eager epoch and of a graph epoch (K = 4: one span a dispatch of
    four replays), the ``train_state`` pool's books against the tensors,
    and one planned ``checkpoint_write`` fault, retried from the latest
    checkpoint to the weights of a run without the fault."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.testing import chaos
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    n_block, steps = cfg["n_block"], 8
    obs.set_enabled(True)
    for spd in (1, 4):
        what = "eager" if spd == 1 else f"graph (K = {spd})"
        clf = BERTClassifier(
            num_classes=2, bert_config=cfg, steps_per_dispatch=spd,
            optimizer=AdamWeightDecay(lr=1e-4, warmup_portion=0.1,
                                      total=10),
            device="cuda").load_weights(tree)
        obs.get_tracer().clear()
        before = _counter("zoo_train_steps_total")
        _kernels.reset_launches()
        clf.train(many, epochs=1, seed=SEED)
        torch.cuda.synchronize()
        names = [s["name"] for s in obs.get_tracer().export()]
        counts = {n: names.count(n) for n in sorted(set(names))}
        moved = _counter("zoo_train_steps_total") - before
        fwd, bwd = _kernels.flash_fwd.launches, _kernels.flash_bwd.launches
        est = clf._train_est
        params = list(clf.net.parameters())
        opt = _opt_state_tensors(est.opt_state)
        want = _tensor_bytes(params) + _tensor_bytes(opt)
        pool = obs.get_memory_ledger().snapshot()["pools"]["train_state"]
        log(f"[train] traced {what} epoch of {steps} steps: spans {counts}, "
            f"zoo_train_steps_total +{moved:g}, launches flash_fwd {fwd} "
            f"flash_bwd {bwd}; train_state pool used {pool['used_bytes']:,} "
            f"B ({pool['blocks']} tensors) vs parameters + optimizer "
            f"{want:,} B, capacity {pool['capacity_bytes']:,} B")
        if counts != {"train.epoch": 1, "train.prefetch": 1,
                      "train.step": steps // spd} or moved != steps:
            raise AssertionError(f"{what}: spans {counts}, steps +{moved}")
        if (fwd, bwd) != (steps * n_block, steps * n_block):
            raise AssertionError(f"{what}: launches {fwd} / {bwd}")
        if (pool["used_bytes"] != want
                or pool["blocks"] != len(params) + len(opt)
                or pool["capacity_bytes"]
                != torch.cuda.get_device_properties(0).total_memory):
            raise AssertionError(f"train_state pool {pool} vs {want}")
        del clf, est
        _release()

    # one planned checkpoint_write fault: write 0 is the bootstrap before
    # the loop, write 1 (the first epoch's end) raises, and the epoch is
    # retried from the bootstrap checkpoint
    runs = {}
    ckdir = tempfile.mkdtemp(prefix="zoo-smoke-ck-")
    try:
        for name, model_dir, inj in (
                ("clean", None, chaos.ChaosInjector()),
                ("faulted", ckdir, chaos.ChaosInjector().plan(
                    "checkpoint_write", at=[1]))):
            clf = BERTClassifier(
                num_classes=2, bert_config=cfg, model_dir=model_dir,
                optimizer=AdamWeightDecay(lr=1e-4, warmup_portion=0.1,
                                          total=10),
                device="cuda").load_weights(tree)
            obs.get_tracer().clear()
            t0 = time.perf_counter()
            with chaos.installed(inj):
                clf.train(fixed, epochs=2, seed=SEED)
            torch.cuda.synchronize()
            spans = [s["name"] for s in obs.get_tracer().export()]
            runs[name] = dict(
                weights={n: p.detach().clone()
                         for n, p in clf.net.named_parameters()},
                fired=inj.injected("checkpoint_write"),
                writes=inj.count("checkpoint_write"),
                retries=spans.count("train.retry"),
                step=clf._train_est.global_step,
                s=time.perf_counter() - t0)
            del clf
            _release()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    worst = max(((runs["faulted"]["weights"][n] - w).abs().max()
                 / w.abs().max().clamp_min(1e-30)).item()
                for n, w in runs["clean"]["weights"].items())
    f = runs["faulted"]
    log(f"[train] checkpoint_write fault at write 1: fired {f['fired']}, "
        f"{f['writes']} write calls, {f['retries']} train.retry span, "
        f"global step {f['step']} ({runs['clean']['step']} without the "
        f"fault), {f['s']:.1f} s with checkpoints; weights vs the run "
        f"without the fault: worst |d|/max|p| {worst:.3e}")
    if (f["fired"], f["writes"], f["retries"], f["step"]) != (1, 4, 1, 2) \
            or runs["clean"]["step"] != 2 or worst > 1e-6:
        raise AssertionError(f"the checkpoint_write retry: {f}, worst "
                             f"{worst}")
    obs.get_tracer().clear()


class _DispatchLosses:
    """Records every training step's loss while active: the losses each
    dispatch hands ``Estimator._post_dispatch`` (device tensors, read
    after the run)."""

    def __enter__(self):
        from analytics_zoo_tpu_torch.estimator import estimator as est_mod
        self._cls = est_mod.Estimator
        self._orig = orig = est_mod.Estimator._post_dispatch
        self.losses = seen = []

        def spy(est, n, k, lv, *args, **kw):
            seen.append(lv)
            return orig(est, n, k, lv, *args, **kw)
        self._cls._post_dispatch = spy
        return self

    def __exit__(self, *exc):
        self._cls._post_dispatch = self._orig
        self.losses = [float(v) for lv in self.losses
                       for v in lv.float().cpu().reshape(-1)]


def _bench_data(cfg):
    """``bench.py:322-330``: 8,192 sequences from ``RandomState(0)``, no
    padding, one segment, labels the first token's parity."""
    n, T = BENCH["batch"] * BENCH["steps"], cfg["seq_len"]
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg["vocab"], (n, T)).astype(np.int32)
    return ((ids, np.zeros((n, T), np.int32), np.ones((n, T), np.int32)),
            (ids[:, 0] % 2).astype(np.int32))


def _bench_clf(cfg, tree, spd, mixed=True, model_dir=None, total=1000,
               **kw):
    """The bench's classifier (f32 masters; bf16 forward, gradients and
    first moment under mixed precision) from the weights ``tree``; its
    schedule warms up over a tenth of ``total`` steps (the bench's 1000)
    and decays to 0 at ``total``."""
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    low = "bfloat16" if mixed else None
    clf = BERTClassifier(
        num_classes=2, bert_config=cfg,
        optimizer=AdamWeightDecay(lr=1e-4, state_dtype=low, total=total),
        mixed_precision=mixed, steps_per_dispatch=spd, grad_dtype=low,
        model_dir=model_dir, device="cuda", **kw)
    return clf.load_weights(tree)


def _release():
    """Free what the caller dropped: an estimator and its captured graph
    hold each other, so the cycle collector runs before the cache is
    emptied."""
    import gc
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()


def _close(what, got, want, rtol, phase="train_bench"):
    """Per-step losses against a reference within ``rtol`` relative;
    returns the worst difference."""
    worst = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))
    log(f"[{phase}] {what}: worst relative loss difference {worst:.3e} "
        f"over {len(got)} steps (tol {rtol:g})")
    if len(got) != len(want) or not np.isfinite(got).all() or worst > rtol:
        raise AssertionError(f"{what}: {got} vs {want}")
    return worst


def _step_flops(net, cfg, batch):
    """One training step's model FLOPs as model-FLOPs shares count them:
    6 x tokens x the encoder blocks' parameters, 6 x sequences x the
    pooler's and the head's (they read the first token only), plus the
    attention products (forward 4 B H T^2 D a layer, backward twice).
    The embedding tables and their LayerNorm are left out: a gather and
    elementwise work, not products."""
    T, H = cfg["seq_len"], cfg["n_head"]
    D = cfg["hidden_size"] // H
    per_token = per_seq = 0
    for name, p in net.named_parameters():
        if "_block" in name:
            per_token += p.numel()
        elif "embed" not in name:
            per_seq += p.numel()
    attn = 12 * batch * H * T * T * D * cfg["n_block"]
    return 6 * (per_token * batch * T + per_seq * batch) + attn


def phase_train_bench():
    """The bench's BERT training leg on the card; see the module
    docstring (5b).  Returns (launches of the bench run, numbers)."""
    import shutil
    import tempfile
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier, TFDataset
    cfg = dict(BERT_BASE, hidden_drop=0.1, attn_drop=0.1)
    n_block = cfg["n_block"]
    tree = _random_tree(BERTClassifier(2, bert_config=cfg,
                                       device="cpu").net,
                        np.random.default_rng(SEED + 5))
    x, y = _bench_data(cfg)
    bench_ds = TFDataset.from_ndarrays((x, y), batch_size=BENCH["batch"],
                                       memory_type="DEVICE")
    small = ((tuple(a[:8 * BATCH] for a in x)), y[:8 * BATCH])
    small_ds = TFDataset.from_ndarrays(small, batch_size=BATCH,
                                       memory_type="DEVICE")
    out = {}

    # check 2: 8 f32 steps with dropout through the graph (K = 4) against
    # 8 eager steps, from the same weights and seed
    runs = {}
    for k in (4, 1):
        clf = _bench_clf(cfg, tree, k, mixed=False)
        _kernels.reset_launches()
        with _DispatchLosses() as rec:
            clf.train(lambda: small_ds, epochs=1)
        torch.cuda.synchronize()
        runs[k] = (rec.losses, {n: p.detach().clone()
                                for n, p in clf.net.named_parameters()},
                   (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches))
        del clf
        _release()
    _close("f32 batch 32, 8 steps: graph (K=4) vs eager (K=1)",
           runs[4][0], runs[1][0], GRAPH_LOSS_RTOL)
    worst = max(((runs[4][1][n] - p).abs().max()
                 / p.abs().max().clamp_min(1e-30)).item()
                for n, p in runs[1][1].items())
    log(f"[train_bench] ... weights: worst |d|/max|p| {worst:.3e} (tol "
        f"{GRAPH_WEIGHT_RTOL:g}); launches graph {runs[4][2]}, eager "
        f"{runs[1][2]}")
    if worst > GRAPH_WEIGHT_RTOL or runs[4][2] != (8 * n_block,
                                                   8 * n_block) \
            or runs[1][2] != runs[4][2]:
        raise AssertionError("the graph's steps differ from eager steps")
    del runs

    # check 4: checkpoint at an epoch end, restore into a new estimator,
    # train the next epoch; against the uninterrupted run (f32, K = 4)
    tmp = tempfile.mkdtemp(prefix="zoo_ckpt_")
    try:
        clf = _bench_clf(cfg, tree, 4, mixed=False)
        with _DispatchLosses() as whole:
            clf.train(lambda: small_ds, epochs=2)
        clf = _bench_clf(cfg, tree, 4, mixed=False, model_dir=tmp)
        clf.train(lambda: small_ds, epochs=1)
        del clf
        _release()
        net = BERTClassifier(2, bert_config=cfg, device="cuda").net
        est = Estimator(net, AdamWeightDecay(lr=1e-4),
                        "sparse_categorical_crossentropy",
                        checkpoint_dir=tmp, steps_per_dispatch=4,
                        device="cuda")
        with _DispatchLosses() as resumed:
            est.train(small_ds.get_training_data(), BATCH, epochs=2,
                      resume=True)
        log(f"[train_bench] resumed at step 8 from {sorted(os.listdir(tmp))}"
            f" -> global step {est.global_step}")
        _close("resume: the epoch after a restored checkpoint vs the "
               "uninterrupted run", resumed.losses, whole.losses[8:],
               RESUME_RTOL)
        del est, net
        _release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # checks 1 and 3: the bench's run, counted from zero: 12 + 12 launches
    # a step through the replays, the epoch losses falling
    steps = BENCH["steps"] * BENCH["epochs"]
    clf = _bench_clf(cfg, tree, BENCH["spd"])
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    with _DispatchLosses() as bench:
        clf.train(lambda: bench_ds, epochs=BENCH["epochs"])
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
    no_copies("train_bench")
    hist = clf._train_est.history
    epoch_losses = [h["loss"] for h in hist]
    log(f"[train_bench] bench run: {steps} steps in {len(hist)} epochs of "
        f"one {BENCH['spd']}-step dispatch; epoch losses "
        f"{' '.join(f'{v:.4f}' for v in epoch_losses)}; launches "
        f"{launches}")
    want = dict.fromkeys(_kernels.KERNELS, 0)
    want.update(flash_fwd=steps * n_block, flash_bwd=steps * n_block)
    if launches != want:
        raise AssertionError(f"bench run: expected {want} launches through "
                             f"the replays, got {launches}")
    if not (np.isfinite(epoch_losses).all()
            and epoch_losses[-1] < epoch_losses[0]):
        raise AssertionError(f"bench run: the loss did not fall: "
                             f"{epoch_losses}")
    graph_peak = torch.cuda.max_memory_allocated()
    graph_ms = (np.mean([h["seconds"] for h in hist[1:]]) * 1e3
                / BENCH["steps"])
    busy = profile_breakdown(lambda: clf.train(lambda: bench_ds, epochs=1),
                             f"one {BENCH['spd']}-step dispatch (CUDA graph "
                             f"replays) at batch {BENCH['batch']}", top=12)
    flops = _step_flops(clf.net, cfg, BENCH["batch"])
    first = bench.losses[:BENCH["steps"]]
    del clf
    _release()

    # K = 1 in the same call: the first 32 steps against the graph's, then
    # a timed epoch and a profile
    clf = _bench_clf(cfg, tree, 1)
    torch.cuda.reset_peak_memory_stats()
    with _DispatchLosses() as eager:
        clf.train(lambda: bench_ds, epochs=1)
    _close(f"bf16 bench configuration, first {BENCH['steps']} steps: graph "
           f"(K={BENCH['spd']}) vs eager (K=1)", first, eager.losses,
           BENCH_BF16_RTOL)
    clf.train(lambda: bench_ds, epochs=1)
    eager_ms = (clf._train_est.history[-1]["seconds"] * 1e3
                / BENCH["steps"])
    eager_peak = torch.cuda.max_memory_allocated()
    busy_eager = profile_breakdown(
        lambda: clf.train(lambda: bench_ds, epochs=1),
        f"{BENCH['steps']} eager steps (K=1) at batch {BENCH['batch']}",
        top=12)
    del clf
    _release()
    for what, ms, peak, prof in (
            (f"graph (K={BENCH['spd']})", graph_ms, graph_peak, busy),
            ("eager (K=1)", eager_ms, eager_peak, busy_eager)):
        share = (f"{100 * prof[1] / prof[0]:.1f}%" if prof
                 else "not measured")
        out[what] = dict(step_ms=ms,
                         samples_s=BENCH["batch"] * 1e3 / ms,
                         busy_share=prof[1] / prof[0] if prof else None,
                         peak_gib=peak / 2 ** 30,
                         mfu=flops / (ms * 1e-3) / PEAK_FLOPS[torch.bfloat16])
        log(f"[train_bench] {what} at batch {BENCH['batch']}: "
            f"{ms:.3f} ms a step ({out[what]['samples_s']:.1f} samples/s), "
            f"device busy {share} of a dispatch, peak memory "
            f"{out[what]['peak_gib']:.2f} GiB, model FLOPs "
            f"{flops / 1e12:.2f} TFLOP a step = "
            f"{100 * out[what]['mfu']:.1f}% of the bf16 dense peak "
            f"({PEAK_FLOPS[torch.bfloat16] / 1e12:g} TFLOP/s)")
    out["epoch_losses"] = epoch_losses
    return launches, out


def _paged_pools(dtype, P, bs, Hkv, D, gen):
    """K/V page pools with finite garbage (1e4) in the scratch page 0."""
    kp = torch.randn(P, bs, Hkv, D, generator=gen)
    vp = torch.randn(P, bs, Hkv, D, generator=gen)
    kp[0], vp[0] = 1e4, -1e4
    return kp.to("cuda", dtype), vp.to("cuda", dtype)


def _decode_case(dtype, lengths, Hkv, gen, B, H, D, bs, nb):
    """Decode inputs: every sequence on its own random pages, table
    entries past ``ceil(len / bs)`` pointing at the scratch page."""
    P = B * nb + 1
    q = torch.randn(B, H, D, generator=gen).to("cuda", dtype)
    kp, vp = _paged_pools(dtype, P, bs, Hkv, D, gen)
    tables = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).int()
    tables = tables.view(B, nb)
    used = (lengths[:, None] + bs - 1) // bs
    tables[torch.arange(nb)[None, :] >= used] = 0
    return q, kp, vp, lengths.int().to("cuda"), tables.to("cuda")


def _chunk_case(dtype, Hkv, start, n, gen, Tc, H, D, bs, nb):
    """Chunk inputs: ``n`` true rows at ``start`` (rows past ``n`` are a
    padded tail), the table's tail pointing at the scratch page."""
    P = 3 * nb + 1
    q = torch.randn(Tc, H, D, generator=gen).to("cuda", dtype)
    kp, vp = _paged_pools(dtype, P, bs, Hkv, D, gen)
    used = -(-(start + n) // bs)
    table = torch.zeros(nb, dtype=torch.int32)
    table[:used] = torch.randperm(P - 1, generator=gen)[:used].int() + 1
    return q, kp, vp, table.to("cuda")


def _max_err(what, out, ref, dtype):
    """Max abs error of ``out`` against ``ref``; raises when an element is
    out of ``TOL[dtype]`` or ``out`` is not finite."""
    atol, rtol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    bad = (diff > atol + rtol * ref.float().abs()).sum().item()
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f"{what}: {bad} elements out of tolerance "
                             f"(atol {atol:g} + rtol {rtol:g}), max_abs_err "
                             f"{diff.max().item():.3e}")
    return diff.max().item()


def _check_close(name, what, out, ref, dtype):
    err = _max_err(f"{name} {dtype} {what} vs its plain version", out, ref,
                   dtype)
    atol, rtol = TOL[dtype]
    log(f"[paged] {name} {str(dtype)[6:]:8s} {what:34s} max_abs_err="
        f"{err:.3e} tol=atol {atol:g} + rtol {rtol:g} -> ok")
    return err


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def _repeat_identical(name, fn, out):
    """A second run of a kernel equals the first bit for bit (the split
    merges run in a fixed order, with no float atomics)."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        raise AssertionError(f"{name}: a repeat is not bit-identical")


def _forced_splits(rule, value):
    """``_kernels``' split rule ``rule`` replaced by one returning
    ``value``, for timing the kernel without its split (a context)."""
    from contextlib import contextmanager

    from analytics_zoo_tpu_torch.ops import _kernels

    @contextmanager
    def forced():
        saved = getattr(_kernels, rule)
        setattr(_kernels, rule, lambda *args: value)
        try:
            yield
        finally:
            setattr(_kernels, rule, saved)
    return forced()


def phase_paged():
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops.paged_attention import (
        paged_chunk_attention, paged_decode_attention)
    F = torch.nn.functional
    sass = flash_sass("paged_chunk", phase="paged")
    B, H, D, bs, nb = (PAGED[k] for k in ("B", "H", "D", "bs", "nb"))
    Tc, start = CHUNK["Tc"], CHUNK["start"]
    L = nb * bs
    n_sms = _kernels.sm_count(torch.device("cuda"))
    gen = torch.Generator().manual_seed(SEED + 2)
    ragged = torch.randint(0, L + 1, (B,), generator=gen)
    ragged[:3] = torch.tensor([0, L, 1000])   # dead lane, full, not x16
    decode_cases = {"ragged lengths 0..1024": dict(Hkv=H),
                    "GQA Hkv=4, ragged lengths": dict(Hkv=4)}
    chunk_cases = {f"start {start}, {Tc} rows": dict(Hkv=H, start=start,
                                                     n=Tc),
                   f"start {start}, padded tail n=200": dict(
                       Hkv=H, start=start, n=200),
                   "GQA Hkv=4, start 0": dict(Hkv=4, start=0, n=Tc)}
    errs = {"paged_decode": {}, "paged_chunk": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (what, case) in enumerate(decode_cases.items()):
            args = _decode_case(dtype, ragged, case["Hkv"], gen, B, H, D,
                                bs, nb)
            out = paged_decode_attention(*args)
            ref = paged_decode_attention(*args, backend="plain")
            torch.cuda.synchronize()
            err = _check_close("paged_decode", what, out, ref, dtype)
            if not torch.all(out[0] == 0):
                raise AssertionError("paged_decode: a dead lane is not 0")
            if i == 0:
                _repeat_identical("paged_decode",
                                  lambda: paged_decode_attention(*args), out)
            errs["paged_decode"][dtype] = max(
                errs["paged_decode"].get(dtype, 0.0), err)
        for i, (what, case) in enumerate(chunk_cases.items()):
            q, kp, vp, table = _chunk_case(dtype, case["Hkv"],
                                           case["start"], case["n"], gen,
                                           Tc, H, D, bs, nb)
            out = paged_chunk_attention(q, kp, vp, table, case["start"])
            ref = paged_chunk_attention(q, kp, vp, table, case["start"],
                                        backend="plain")
            torch.cuda.synchronize()
            n = case["n"]
            err = _check_close("paged_chunk", what, out[:n], ref[:n], dtype)
            if i == 0:
                _repeat_identical("paged_chunk", lambda: paged_chunk_attention(
                    q, kp, vp, table, case["start"]), out)
            errs["paged_chunk"][dtype] = max(
                errs["paged_chunk"].get(dtype, 0.0), err)
    log(f"[paged] a repeat of each kernel (split merges in fixed order) is "
        f"bit-identical, f32 and bf16")

    # timing: decode with all 32 sequences at 1024 tokens, then at the
    # ragged lengths above; the chunk at its serving shape (start 512),
    # then at start 0 and 256.  ms, plain_ms, library_ms: back-to-back
    # eager calls (CUDA events, the wrapper's host time included), as in
    # earlier rows; *device_ms: device time per call by CUDA graph replay.
    # The yardstick is SDPA over the same K/V copied out into contiguous
    # (B, H, T, D) tensors.  unsplit_device_ms: the same kernel with its
    # split rule forced to one block per (sequence, head) / row block.
    rows = {"paged_decode": {}, "paged_chunk": {}}
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        full = torch.full((B,), L, dtype=torch.int32)
        q, kp, vp, lens, tables = _decode_case(dtype, full, H, gen, B, H, D,
                                               bs, nb)
        kernel = lambda: paged_decode_attention(q, kp, vp, lens, tables)
        ms, dev_ms = cuda_ms(kernel), graph_ms(kernel)
        with _forced_splits("decode_splits", (1, nb)):
            unsplit_ms = graph_ms(kernel)
        plain_ms = cuda_ms(lambda: paged_decode_attention(
            q, kp, vp, lens, tables, backend="plain"), iters=10)
        k, v = (p[tables.long()].reshape(B, L, H, D).transpose(1, 2)
                .contiguous() for p in (kp, vp))
        sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None], k, v)
        lib_ms, lib_dev_ms = cuda_ms(sdpa), graph_ms(sdpa)
        nbytes = 2 * B * L * H * D * es + 2 * B * H * D * es \
            + tables.numel() * 4 + B * 4
        bound, by, t_bytes, t_ops = _bound(nbytes, 4 * B * H * L * D, dtype)
        splits = _kernels.decode_splits(B, H, nb, bs, n_sms)
        del k, v
        rq, rkp, rvp, rlens, rtables = _decode_case(dtype, ragged, H, gen, B,
                                                    H, D, bs, nb)
        ragged_ms = graph_ms(lambda: paged_decode_attention(
            rq, rkp, rvp, rlens, rtables))
        seen = int(ragged.sum())
        r_bytes = 2 * seen * H * D * es + 2 * B * H * D * es \
            + int(((ragged + bs - 1) // bs).sum()) * 4 + B * 4
        r_bound, r_by, _, _ = _bound(r_bytes, 4 * seen * H * D, dtype)
        rows["paged_decode"][dtype] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bound_by=by, max_abs_err=errs["paged_decode"][dtype],
            device_ms=dev_ms, library_device_ms=lib_dev_ms,
            device_gbs=nbytes / dev_ms / 1e6, unsplit_device_ms=unsplit_ms,
            splits=splits[0], split_keys=splits[1] * bs,
            ragged_device_ms=ragged_ms, ragged_bound_ms=r_bound,
            ragged_tokens=seen)
        log(f"[paged] paged_decode {str(dtype)[6:]:8s} B{B} H{H} D{D} "
            f"len {L} bs {bs}: eager calls: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa over contiguous K/V {lib_ms:.4f} ms; "
            f"device time (graph replay): kernel {dev_ms:.4f} ms "
            f"({nbytes / dev_ms / 1e6:.1f} GB/s; {splits[0]} splits of "
            f"{splits[1] * bs} keys, {B * H * splits[0]} blocks; one split "
            f"{unsplit_ms:.4f} ms), sdpa {lib_dev_ms:.4f} ms; bound "
            f"{bound:.4f} ms ({by}; bytes {t_bytes:.4f} ms, operations "
            f"{t_ops:.4f} ms)")
        log(f"[paged] paged_decode {str(dtype)[6:]:8s} at the ragged lengths "
            f"({seen} visible tokens in all): device {ragged_ms:.4f} ms, "
            f"bound {r_bound:.4f} ms ({r_by}, from the visible tokens)")
        del rkp, rvp

        chunk = {}
        for s0 in (0, 256, start):
            q, kp, vp, table = _chunk_case(dtype, H, s0, Tc, gen, Tc, H, D,
                                           bs, nb)
            kernel = lambda: paged_chunk_attention(q, kp, vp, table, s0)
            S = s0 + Tc
            k, v = (p[table.long()].reshape(nb * bs, H, D)[:S]
                    .transpose(0, 1)[None].contiguous() for p in (kp, vp))
            qq = q.transpose(0, 1)[None].contiguous()
            mask = (torch.arange(S, device="cuda")[None, :]
                    <= s0 + torch.arange(Tc, device="cuda")[:, None])
            sdpa = lambda: F.scaled_dot_product_attention(qq, k, v,
                                                          attn_mask=mask)
            keys_seen = Tc * s0 + Tc * (Tc + 1) // 2   # causal pairs
            flops = 4 * H * D * keys_seen
            nbytes = 2 * Tc * H * D * es + 2 * S * H * D * es + nb * 4
            bound, by, t_bytes, t_ops = _bound(nbytes, flops, dtype)
            dev_ms = graph_ms(kernel)
            with _forced_splits("chunk_splits", 1):
                unsplit_ms = graph_ms(kernel)
            chunk[s0] = dict(device_ms=dev_ms, unsplit_device_ms=unsplit_ms,
                             library_device_ms=graph_ms(sdpa),
                             bound_ms=bound, bound_by=by,
                             splits=_kernels.chunk_splits(H, Tc, s0, nb, bs,
                                                          n_sms))
            log(f"[paged] paged_chunk {str(dtype)[6:]:8s} Tc{Tc} start {s0}"
                f" H{H} D{D}: device time (graph replay): kernel "
                f"{dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s; "
                f"{chunk[s0]['splits']} split(s); one split "
                f"{unsplit_ms:.4f} ms), sdpa "
                f"{chunk[s0]['library_device_ms']:.4f} ms; bound "
                f"{bound:.4f} ms ({by}; bytes {t_bytes:.4f} ms, operations "
                f"{t_ops:.4f} ms)")
            if s0 == start:
                ms = cuda_ms(kernel)
                plain_ms = cuda_ms(lambda: paged_chunk_attention(
                    q, kp, vp, table, s0, backend="plain"), iters=10)
                lib_ms = cuda_ms(sdpa)
                log(f"[paged] paged_chunk {str(dtype)[6:]:8s} Tc{Tc} start "
                    f"{s0}: eager calls: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, sdpa over contiguous K/V "
                    f"{lib_ms:.4f} ms")
                rows["paged_chunk"][dtype] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound, bound_by=by,
                    max_abs_err=errs["paged_chunk"][dtype],
                    device_ms=dev_ms,
                    library_device_ms=chunk[s0]["library_device_ms"],
                    device_tflops=flops / dev_ms / 1e9,
                    unsplit_device_ms=unsplit_ms,
                    splits=chunk[s0]["splits"], **sass)
            del k, v
        rows["paged_chunk"][dtype].update(
            {f"start{s0}": chunk[s0] for s0 in (0, 256)})
    return rows


def _llm_requests(n, rng, vocab):
    """``n`` prompts of 16..768 tokens; every second one starts with one
    shared 256-token system prefix (cut to the prompt's length)."""
    prefix = rng.integers(0, vocab, 256)
    reqs = {}
    for i in range(n):
        toks = rng.integers(0, vocab, int(rng.integers(16, 769)))
        if i % 2 == 0:
            m = min(256, toks.size)
            toks[:m] = prefix[:m]
        reqs[f"llm-{i:03d}"] = toks.astype(np.int32)
    return reqs


def _prefill(model, cache, uri, toks, chunk, width):
    """Prefill one prompt in chunks through the model's entry point;
    returns the final chunk's logits."""
    pos, logits = 0, None
    while pos < len(toks):
        n = min(chunk, len(toks) - pos)
        slots = cache.append_tokens(uri, n)
        t = np.zeros((chunk,), np.int32)
        t[:n] = toks[pos:pos + n]
        s = np.arange(chunk, dtype=np.int32) % cache.block_size
        s[:n] = slots
        logits, cache.k_pages, cache.v_pages = model.prefill_chunk(
            t, pos, n, cache.page_table(uri, width), cache.k_pages,
            cache.v_pages, s)
        pos += n
    return logits


def _wait_idle(eng, timeout=120.0):
    deadline = time.monotonic() + timeout
    while eng.scheduler.has_work():
        if time.monotonic() > deadline:
            raise AssertionError("the engine did not go idle")
        time.sleep(0.01)


def phase_llm(n_requests=64, new_tokens=32):
    from analytics_zoo_tpu_torch import interop
    from analytics_zoo_tpu_torch.common.config import LLMServingConfig
    from analytics_zoo_tpu_torch.llm import (
        GenerationClient, LLMServing, PagedKVCache)
    from analytics_zoo_tpu_torch.models.generation import (
        DecoderLM, dense_logits)
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker

    cfg = GPT2_SMALL
    n_layers, n_head = cfg["n_layers"], cfg["n_head"]
    rng = np.random.default_rng(SEED)
    model = DecoderLM(**cfg, device="cuda")
    interop.load_jax_params(model, _random_tree(model, rng))
    scfg = LLMServingConfig(max_active=32, block_size=16, num_blocks=2048,
                            max_model_len=1024, prefill_chunk_tokens=256,
                            prefix_cache=True)
    eng = LLMServing(model, scfg, broker=InMemoryBroker())
    pages = eng.cache.k_pages
    log(f"[llm] DecoderLM {cfg}, "
        f"{sum(p.numel() for p in model.parameters()):,} parameters (f32); "
        f"KV pages 2 x {tuple(pages.shape)} = "
        f"{2 * pages.numel() * pages.element_size() / 1e9:.3f} GB")
    reqs = _llm_requests(n_requests, rng, cfg["vocab"])
    calls = {"decode": 0, "prefill_chunk": 0}

    def counted(name):
        inner = getattr(model, name)

        def call(*args):
            calls[name] += 1
            return inner(*args)
        return call

    cli = GenerationClient(broker=eng.broker)
    served = {}
    eng.start()
    try:
        # warm-up (cuBLAS handles, first launches): not counted
        cli.generate("warmup", rng.integers(0, cfg["vocab"], 40), 4,
                     timeout=300)
        _wait_idle(eng)
        eng.reset_stats()
        model.decode = counted("decode")
        model.prefill_chunk = counted("prefill_chunk")
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for uri, toks in reqs.items():
            cli.submit(uri, toks, new_tokens)
        for uri in reqs:
            served[uri] = [t for _, t in cli.stream_tokens(uri,
                                                           timeout=600)]
        burst_s = time.perf_counter() - t0
        _wait_idle(eng)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
        n_calls = dict(calls)
        metrics = eng.metrics()
        ttft = np.array([s for u, s in eng.ttft_samples() if u in reqs])
        leak = eng.cache.leak_check()
    finally:
        eng.stop()
        for name in ("decode", "prefill_chunk"):
            model.__dict__.pop(name, None)
    short = [u for u, t in served.items() if len(t) != new_tokens]
    if short or len(served) != n_requests:
        raise AssertionError(f"requests without {new_tokens} tokens: "
                             f"{short}")
    no_copies("llm")
    pc = metrics["prefix_cache"]
    tok_s = n_requests * new_tokens / burst_s
    log(f"[llm] burst of {n_requests} requests (prompts "
        f"{min(map(len, reqs.values()))}..{max(map(len, reqs.values()))} "
        f"tokens, {sum(map(len, reqs.values()))} in all), {new_tokens} new "
        f"tokens each: all ok in {burst_s:.4f} s = {tok_s:.2f} generated "
        f"tokens/s; TTFT p50 {1e3 * np.percentile(ttft, 50):.3f} ms, p99 "
        f"{1e3 * np.percentile(ttft, 99):.3f} ms; mean inter-token latency "
        f"{metrics['mean_itl_ms']:.3f} ms; mean batch occupancy "
        f"{metrics['mean_batch_occupancy']:.4f}; {n_calls['decode']} decode "
        f"calls, {n_calls['prefill_chunk']} prefill chunks, "
        f"{metrics['preemptions']} preemptions")
    log(f"[llm] prefix cache: {pc}; after the burst {leak}")
    log(f"[llm] launches {launches}: paged_decode "
        f"{launches['paged_decode'] / max(n_calls['decode'], 1):g} per "
        f"decode call, paged_chunk "
        f"{launches['paged_chunk'] / max(n_calls['prefill_chunk'], 1):g} "
        f"per prefill chunk")
    if leak["tables"] or leak["held_blocks"]:
        raise AssertionError(f"live tables after the burst: {leak}")
    if not pc["hits"]:
        raise AssertionError("the radix prefix cache reported no hit")
    if (not n_calls["decode"] or not n_calls["prefill_chunk"]
            or launches["paged_decode"] != n_layers * n_calls["decode"]
            or launches["paged_chunk"]
            != n_layers * n_calls["prefill_chunk"]):
        raise AssertionError(f"expected {n_layers} launches per call: "
                             f"{launches} for {n_calls}")

    # teacher-forced check: the dense forward with plain attention over
    # prompt + served tokens; each served token against the best logit
    worst, exact = 0.0, 0
    with torch.inference_mode():
        for uri, toks in reqs.items():
            ctx = np.concatenate([toks, served[uri]]).astype(np.int64)
            lg = dense_logits(model, torch.from_numpy(ctx[None]).cuda(),
                              n_head)[0]
            rows = lg[len(toks) - 1:len(toks) - 1 + new_tokens]
            tok = torch.tensor(served[uri], device="cuda")
            gap = rows.max(-1).values - rows.gather(1, tok[:, None])[:, 0]
            worst = max(worst, gap.max().item())
            exact += bool((rows.argmax(-1) == tok).all())
    log(f"[llm] teacher-forced dense forward (plain attention) over each "
        f"prompt + served tokens: worst (best logit - served token's "
        f"logit) {worst:.3e} (tol {TEACHER_ATOL:g}); {exact}/{n_requests} "
        f"sequences equal the dense greedy choice at every position")
    if worst > TEACHER_ATOL:
        raise AssertionError("served tokens disagree with the dense forward")
    del eng

    # one decode step at 32 live slots: its logits against the dense
    # forward, its time, and profiles of it and of one prefill chunk
    cache = PagedKVCache(n_layers, 1024, 16, n_head,
                         cfg["hidden"] // n_head, device="cuda")
    width = -(-scfg.max_model_len // 16)
    lanes = list(reqs.items())[:32]
    first, tables, slots = [], [], []
    for uri, toks in lanes:
        logits = _prefill(model, cache, uri, toks, 256, width)
        first.append(int(logits.argmax()))
        slots.append(int(cache.append_tokens(uri, 1)[0]))
        tables.append(cache.page_table(uri, width))
    lens = np.array([len(t) + 1 for _, t in lanes], np.int32)
    args = (np.array(first, np.int32), lens - 1, lens, np.stack(tables))
    logits = model.decode(*args, cache.k_pages, cache.v_pages,
                          np.array(slots, np.int32))[0]
    err = 0.0
    with torch.inference_mode():
        for i, (uri, toks) in enumerate(lanes):
            ctx = torch.tensor(np.append(toks, first[i])[None],
                               device="cuda", dtype=torch.long)
            want = dense_logits(model, ctx, n_head)[0, -1]
            err = max(err, (logits[i] - want).abs().max().item())
    log(f"[llm] one decode step at 32 live slots (lengths "
        f"{lens.min()}..{lens.max()}) vs the dense forward: max_abs_err "
        f"{err:.3e} (tol {DECODE_ATOL:g})")
    if err > DECODE_ATOL:
        raise AssertionError("decode logits disagree with the dense forward")

    def step():
        out = model.decode(*args, cache.k_pages, cache.v_pages,
                           np.array(slots, np.int32))[0]
        return out.argmax(dim=-1).cpu()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    step_ms = (time.perf_counter() - t0) * 1e3 / 20
    log(f"[llm] decode step at 32 live slots (model.decode + argmax + host "
        f"read): {step_ms:.3f} ms over 20 steps = "
        f"{32 * 1e3 / step_ms:.2f} tokens/s")
    decode_prof = profile_breakdown(step, "one decode step at 32 live slots",
                                    top=10)
    # the longest prompt's last 256 tokens again (rewrites the same slots)
    uri, toks = max(lanes, key=lambda kv: len(kv[1]))
    s0 = max(0, len(toks) - 256)
    n = len(toks) - s0
    t = np.zeros((256,), np.int32)
    t[:n] = toks[s0:]
    table = cache.page_table(uri, width)
    tslots = np.arange(256, dtype=np.int32) % 16
    tslots[:n] = [table[p // 16] * 16 + p % 16 for p in range(s0, s0 + n)]

    def chunk():
        out = model.prefill_chunk(t, s0, n, cache.page_table(uri, width),
                                  cache.k_pages, cache.v_pages, tslots)[0]
        return int(out.argmax())

    chunk_prof = profile_breakdown(
        chunk, f"one prefill chunk ({n} tokens after {s0} cached)", top=10)
    # each paged kernel's device time in that decode step / prefill chunk
    # (its split and merge kernels; 12 launches)
    paged = {}
    for name, prof, call in (("paged_decode", decode_prof, "decode step"),
                             ("paged_chunk", chunk_prof, "prefill chunk")):
        if prof is None:
            continue
        ms = sum(t for k, t, _ in prof[2] if name in k) / 1e3
        paged[name] = dict(device_ms=ms, busy_ms=prof[1],
                           share=ms / prof[1])
        log(f"[llm] {name} in one {call}: {ms:.4f} ms of {prof[1]:.4f} ms "
            f"device busy ({100 * ms / prof[1]:.1f}%), "
            f"{ms / n_layers:.4f} ms a launch")
    return launches, dict(tokens_per_s=tok_s, burst_s=burst_s,
                          step_ms=step_ms, decode_prof=decode_prof,
                          chunk_prof=chunk_prof, calls=n_calls, paged=paged)


def _mp_shards(model, mp):
    """Shard ``model`` over ``mp`` shards of cuda:0, or unshard it (1)."""
    from analytics_zoo_tpu_torch.parallel import Mesh
    if mp == 1:
        model.mesh = model.page_sharding = None
    else:
        model.shard(Mesh(["cuda:0"] * mp, ("model",)))


def _pool_bytes(pages):
    """Bytes of one page pool (k or v): the whole tensor, or its shards'
    sizes (one entry per distinct shard)."""
    tensors = ([t for _, t in pages.unique_shards()]
               if hasattr(pages, "unique_shards") else [pages])
    return [t.numel() * t.element_size() for t in tensors]


def _mp_engine_run(model, reqs, mp, new_tokens, calls):
    """One burst through ``LLMServing(model_parallel=mp)``, every request
    queued before the engine starts; returns the served tokens and the
    run's books."""
    from analytics_zoo_tpu_torch.common.config import LLMServingConfig
    from analytics_zoo_tpu_torch.llm import GenerationClient, LLMServing
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    scfg = LLMServingConfig(max_active=16, block_size=16, num_blocks=1024,
                            max_model_len=1024, prefill_chunk_tokens=256,
                            prefix_cache=True, model_parallel=mp)
    eng = LLMServing(model, scfg, broker=InMemoryBroker())
    cli = GenerationClient(broker=eng.broker)
    for uri, toks in reqs.items():
        cli.submit(uri, toks, new_tokens)
    for name in calls:
        calls[name] = 0
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    eng.start()
    try:
        served = {uri: [t for _, t in cli.stream_tokens(uri, timeout=600)]
                  for uri in reqs}
        burst_s = time.perf_counter() - t0
        _wait_idle(eng)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
        copies = {k: w.copies for k, w in _kernels.KERNELS.items()}
        leak = eng.cache.leak_check()
        metrics = eng.metrics()
    finally:
        eng.stop()
    return dict(served=served, burst_s=burst_s, calls=dict(calls),
                launches=launches, copies=copies, leak=leak,
                pool=_pool_bytes(eng.cache.k_pages),
                shards=[tuple(t.shape) for _, t in
                        eng.cache.k_pages.unique_shards()]
                if mp > 1 else [tuple(eng.cache.k_pages.shape)],
                tokens_per_s=len(reqs) * new_tokens / burst_s,
                itl_ms=metrics["mean_itl_ms"])


def _mp_steps(model, lanes, width=64, steps=20):
    """16 lanes prefilled through the model's entry points (256-token
    chunks) into a cache placed as the model says, then one decode step:
    each lane's final-chunk logits, the step's logits, the launches of
    that step and of one chunk, and the p50 ms of ``steps`` decode steps
    (decode + argmax + host read)."""
    from analytics_zoo_tpu_torch.llm import PagedKVCache
    from analytics_zoo_tpu_torch.ops import _kernels
    cfg = GPT2_SMALL
    n_head = cfg["n_head"]
    cache = PagedKVCache(cfg["n_layers"], 1024, 16, n_head,
                         cfg["hidden"] // n_head, device="cuda",
                         page_sharding=model.page_sharding)
    chunk_logits, first, tables, slots = [], [], [], []
    for uri, toks in lanes:
        lg = _prefill(model, cache, uri, toks, 256, width)
        chunk_logits.append(lg.clone())
        first.append(int(lg.argmax()))
        slots.append(int(cache.append_tokens(uri, 1)[0]))
        tables.append(cache.page_table(uri, width))
    lens = np.array([len(t) + 1 for _, t in lanes], np.int32)
    args = (np.array(first, np.int32), lens - 1, lens, np.stack(tables))
    slots = np.array(slots, np.int32)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    logits = model.decode(*args, cache.k_pages, cache.v_pages, slots)[0]
    torch.cuda.synchronize()
    step_launches = _kernels.paged_decode.launches
    # the longest lane's last chunk again (rewrites the same slots)
    i = max(range(len(lanes)), key=lambda j: len(lanes[j][1]))
    uri, toks = lanes[i]
    s0 = (len(toks) - 1) // 256 * 256
    n = len(toks) - s0
    t = np.zeros((256,), np.int32)
    t[:n] = toks[s0:]
    table = cache.page_table(uri, width)
    tslots = np.arange(256, dtype=np.int32) % 16
    tslots[:n] = [table[p // 16] * 16 + p % 16 for p in range(s0, s0 + n)]
    _kernels.reset_launches()
    again = model.prefill_chunk(t, s0, n, table, cache.k_pages,
                                cache.v_pages, tslots)[0]
    torch.cuda.synchronize()
    chunk_launches = _kernels.paged_chunk.launches
    if not torch.equal(again, chunk_logits[i]):
        raise AssertionError("a repeated prefill chunk changed its logits")
    times = []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        model.decode(*args, cache.k_pages, cache.v_pages,
                     slots)[0].argmax(dim=-1).cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    copies = {k: w.copies for k, w in _kernels.KERNELS.items()}
    return dict(chunk_logits=torch.stack(chunk_logits), logits=logits,
                step_launches=step_launches, chunk_launches=chunk_launches,
                step_ms=float(np.percentile(times[1:], 50)), copies=copies)


def phase_mp_llm(card):
    from analytics_zoo_tpu_torch import interop
    from analytics_zoo_tpu_torch.models.generation import DecoderLM

    cfg = GPT2_SMALL
    n_layers = cfg["n_layers"]
    rng = np.random.default_rng(SEED)
    model = DecoderLM(**cfg, device="cuda")
    interop.load_jax_params(model, _random_tree(model, rng))  # llm's weights
    reqs = _llm_requests(MP_LLM["requests"], rng, cfg["vocab"])
    new = MP_LLM["new_tokens"]
    calls = {"decode": 0, "prefill_chunk": 0}

    def counted(name):
        inner = getattr(model, name)

        def call(*args):
            calls[name] += 1
            return inner(*args)
        return call

    mps = (1,) + MP_LLM["mps"]
    runs, steps = {}, {}
    model.decode = counted("decode")
    model.prefill_chunk = counted("prefill_chunk")
    try:
        # warm-up (the model's first launches at these shapes): not kept
        _mp_engine_run(model, dict(list(reqs.items())[:2]), 1, 4, calls)
        for mp in mps:
            _mp_shards(model, mp)
            runs[mp] = _mp_engine_run(model, reqs, mp, new, calls)
    finally:
        for name in ("decode", "prefill_chunk"):
            model.__dict__.pop(name, None)
    lanes = list(reqs.items())
    for mp in mps:
        _mp_shards(model, mp)
        steps[mp] = _mp_steps(model, lanes)
    _mp_shards(model, 1)
    base, base_step = runs[1], steps[1]
    whole = base["pool"][0]
    log(f"[mp_llm] DecoderLM {cfg} (the llm phase's weights); "
        f"{len(reqs)} requests of "
        f"{min(map(len, reqs.values()))}..{max(map(len, reqs.values()))} "
        f"tokens, {new} new tokens each, queued before the engine starts")
    report = {}
    for mp in mps:
        r, st = runs[mp], steps[mp]
        per_shard = 2 * r["pool"][0]           # k + v of one shard
        log(f"[mp_llm] mp {mp}: KV pages (k + v) {len(r['pool'])} "
            f"shard(s) of 2 x {r['shards'][0]} = {per_shard / 1e9:.4f} GB "
            f"each (unsharded {2 * whole / 1e9:.4f} GB); "
            f"{r['tokens_per_s']:.2f} generated tokens/s "
            f"({r['burst_s']:.4f} s), mean ITL {r['itl_ms']:.3f} ms; "
            f"decode step at 16 lanes p50 {st['step_ms']:.3f} ms; "
            f"{r['calls']['decode']} decode calls, "
            f"{r['calls']['prefill_chunk']} prefill chunks, launches "
            f"paged_decode {r['launches']['paged_decode']}, paged_chunk "
            f"{r['launches']['paged_chunk']}; one step / chunk: "
            f"{st['step_launches']} / {st['chunk_launches']}")
        want = n_layers * mp
        if (r["launches"]["paged_decode"] != want * r["calls"]["decode"]
                or r["launches"]["paged_chunk"]
                != want * r["calls"]["prefill_chunk"]
                or not r["calls"]["decode"]
                or st["step_launches"] != want
                or st["chunk_launches"] != want):
            raise AssertionError(f"mp {mp}: expected {want} launches per "
                                 f"decode call and per prefill chunk: "
                                 f"{r['launches']} for {r['calls']}; one "
                                 f"step {st['step_launches']}, one chunk "
                                 f"{st['chunk_launches']}")
        if any(r["copies"].values()) or any(st["copies"].values()):
            raise AssertionError(f"mp {mp}: inputs copied before a launch: "
                                 f"{r['copies']} / {st['copies']}")
        if r["leak"]["tables"] or r["leak"]["held_blocks"]:
            raise AssertionError(f"mp {mp}: live tables after the burst: "
                                 f"{r['leak']}")
        short = [u for u, t in r["served"].items() if len(t) != new]
        if short:
            raise AssertionError(f"mp {mp}: requests without {new} tokens: "
                                 f"{short}")
        report[mp] = dict(kv_bytes_per_shard=per_shard,
                          tokens_per_s=r["tokens_per_s"],
                          step_ms=st["step_ms"], itl_ms=r["itl_ms"],
                          launches=r["launches"], calls=r["calls"])
        if mp == 1:
            continue
        if len(r["pool"]) != mp or any(b * mp != whole for b in r["pool"]):
            raise AssertionError(f"mp {mp}: shard pools {r['pool']} bytes, "
                                 f"not 1/{mp} of {whole}")
        diff = [u for u in reqs if r["served"][u] != base["served"][u]]
        chunk_err = (st["chunk_logits"] - base_step["chunk_logits"]
                     ).abs().max().item()
        step_err = (st["logits"] - base_step["logits"]).abs().max().item()
        log(f"[mp_llm] mp {mp} vs unsharded: {len(reqs) - len(diff)}/"
            f"{len(reqs)} sequences token-identical; max |logit "
            f"difference| final chunks {chunk_err:.3e}, decode step "
            f"{step_err:.3e} (bar {MP_LOGIT_ATOL:g})")
        if diff:
            raise AssertionError(f"mp {mp}: tokens differ from the "
                                 f"unsharded engine's for {diff}")
        if chunk_err > MP_LOGIT_ATOL or step_err > MP_LOGIT_ATOL:
            raise AssertionError(f"mp {mp}: logits differ from the "
                                 f"unsharded ones")
    del model
    torch.cuda.empty_cache()
    return report


def phase_mesh2d(card, cfg=BERT_BASE, batch=32):
    from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
    from analytics_zoo_tpu_torch.common.context import (
        ZooContext, context_scope)
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops.attention import (
        sharded_flash_attention)
    from analytics_zoo_tpu_torch.parallel import Mesh
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    rng = np.random.default_rng(SEED)
    clf = BERTClassifier(num_classes=2, bert_config=cfg, device="cuda")
    tree = _random_tree(clf.net, rng)                 # the serve phase's
    names = ("input_ids", "token_type_ids", "input_mask")
    im = InferenceModel(device="cuda").load_keras(
        clf.net, (tree, {}), preprocessor=lambda d: [d[n] for n in names])
    reqs = _requests(batch, rng, cfg)
    x = {n: np.stack([r[n] for r in reqs.values()]) for n in names}
    mesh = Mesh(np.full((2, 2), "cuda:0", dtype=object), ("data", "model"))
    ctx = ZooContext(ZooConfig(mesh=MeshConfig(data=2, model=2)), mesh)
    want = im.predict(x)
    torch.cuda.synchronize()
    with context_scope(ctx):
        im.predict(x)                                 # warm-up
        torch.cuda.synchronize()
        _kernels.reset_launches()
        got = im.predict(x)
        torch.cuda.synchronize()
        launches = _kernels.flash_fwd.launches
        no_copies("mesh2d")
        sharded_ms = cuda_ms(lambda: im.predict(x), iters=10, warmup=2)
    alone_ms = cuda_ms(lambda: im.predict(x), iters=10, warmup=2)
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    log(f"[mesh2d] BERT-base classifier ({cfg}) under data 2 x model 2 on "
        f"4 shards of cuda:0, batch {batch}: {launches} flash_fwd launches "
        f"in one forward (want {4 * cfg['n_block']}); answers vs the same "
        f"model without the context max_abs_err={err:.3e} (bar "
        f"{MESH2D_ATOL:g}); predict {sharded_ms:.3f} ms sharded, "
        f"{alone_ms:.3f} ms without the context")
    if launches != 4 * cfg["n_block"]:
        raise AssertionError(f"expected {4 * cfg['n_block']} flash_fwd "
                             f"launches per forward, got {launches}")
    if (got.shape != (batch, 2) or not np.isfinite(got).all()
            or err > MESH2D_ATOL):
        raise AssertionError("answers under the 2D context disagree with "
                             "the model without it")
    B, H, T = BATCH, cfg["n_head"], cfg["seq_len"]
    D = cfg["hidden_size"] // H
    masks = {}
    for backend in (None, "plain"):
        fa = lambda q, k, v, backend=backend, **kw: sharded_flash_attention(
            mesh, q, k, v, backend=backend, **kw)
        masks[backend] = _extract_keep_mask(fa, B, H, T, D, 0.1, 1234)
    same = torch.equal(masks[None], masks["plain"])
    kept = masks[None].float().mean().item()
    log(f"[mesh2d] sharded_flash_attention dropout 0.1 at B{B} H{H} T{T} "
        f"D{D} over the 2 x 2 mesh: keep-mask "
        f"{'identical to' if same else 'DIFFERS from'} the plain "
        f"version's (kept {kept:.4f})")
    if not same:
        raise AssertionError("sharded dropout keep-mask differs from the "
                             "plain version's")
    return dict(launches=launches, err=err, ms=sharded_ms,
                alone_ms=alone_ms)


def _mesh_ctx(data, model):
    """A context whose mesh lays ``data`` x ``model`` positions on
    ``cuda:0``."""
    from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
    from analytics_zoo_tpu_torch.common.context import (ZooContext,
                                                        _build_mesh)
    mc = MeshConfig(data=data, model=model)
    return ZooContext(ZooConfig(mesh=mc), _build_mesh(
        [torch.device("cuda", 0)] * (data * model), mc))


def _spec_bytes(est, ctx, zshard):
    """Per-position bytes of the weights and of the optimizer state as the
    specs give them from the shapes alone (meta tensors, the JAX step's
    rules: Megatron over "model", ZeRO over "data" composed with it), and
    of the Megatron-matched leaves, replicated and placed."""
    from analytics_zoo_tpu_torch.parallel.sharding import (
        DEFAULT_TP_RULES, named_shardings, partition_specs)
    from analytics_zoo_tpu_torch.parallel.zero import (
        bytes_per_device, tree_bytes, zero_shardings)
    mesh = ctx.mesh
    meta = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for n, p in est.model.named_parameters()}
    opt = {k: v for k, v in est.optimizer.init(meta).items()
           if k != "decayed"}
    pspecs = partition_specs(meta, mesh)
    ospecs = partition_specs(opt, mesh)
    osh = (zero_shardings(opt, mesh, "data", base_specs=ospecs) if zshard
           else named_shardings(mesh, ospecs))
    psh = named_shardings(mesh, pspecs)

    def per_position(tree, shardings):
        total = 0
        for (_, leaf), (_, sh) in zip(_leaves(tree), _leaves(shardings)):
            total += int(np.prod(sh.shard_shape(leaf.shape))) \
                * leaf.element_size()
        return total

    matched = lambda n: any(r.matches(n.replace(".", "/"))
                            for r in DEFAULT_TP_RULES)
    mp_names = [n for n in meta if matched(n)]
    sub = lambda t: {n: t[n] for n in mp_names}
    return dict(
        weights=per_position(meta, psh), opt=per_position(opt, osh),
        weights_all=tree_bytes(meta), opt_all=tree_bytes(opt),
        matched_w=(bytes_per_device(sub(est.params)),
                   tree_bytes(sub(meta))),
        matched_opt=(bytes_per_device(sub(est.opt_state["nu"])),
                     tree_bytes(sub(opt["nu"]))))


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict in sorted order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def _mesh_train_parity(cfg, tree, data):
    """f32 at batch 32, dropout off, SGD: the unsharded estimator against
    the sharded ones over 4 steps (losses relative, weights of max|p|),
    and K = 4 graph replays against eager under the mesh."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    fs = data.get_training_data()
    runs = {}
    cases = (("unsharded", None, {}),
             ("data 2 x model 2, ZeRO", (2, 2), dict(shard_optimizer=True)),
             ("data 4, ZeRO", (4, 1), dict(shard_optimizer=True)),
             ("data 2 x model 2, ZeRO, 2 microbatches", (2, 2),
              dict(shard_optimizer=True, grad_accum_steps=2)),
             ("data 2 x model 2, ZeRO, K=4 graph", (2, 2),
              dict(shard_optimizer=True, steps_per_dispatch=4)))
    for what, mesh, kw in cases:
        net = BERTClassifier(2, bert_config=cfg, device="cuda").net
        net.set_weights(tree)
        ctx = _mesh_ctx(*mesh) if mesh else None
        est = Estimator(net, SGD(lr=0.05), "sparse_categorical_crossentropy",
                        ctx=ctx, device="cuda", **kw)
        with _DispatchLosses() as rec:
            est.train(fs, BATCH, epochs=1)
        torch.cuda.synchronize()
        runs[what] = (rec.losses, {n: p.detach().clone()
                                   for n, p in net.named_parameters()})
        del est, net
        _release()
    out = {}
    ref_l, ref_w = runs["unsharded"]
    pairs = [(w, "unsharded") for w, _, _ in cases[1:]]
    pairs.append(("data 2 x model 2, ZeRO, K=4 graph",
                  "data 2 x model 2, ZeRO"))
    for what, against in pairs:
        got_l, got_w = runs[what]
        want_l, want_w = runs[against]
        lw = _close(f"{what} vs {against}", got_l, want_l,
                    MESH_TRAIN_RTOL, phase="mesh_train")
        ww = max(((got_w[n] - p).abs().max()
                  / p.abs().max().clamp_min(1e-30)).item()
                 for n, p in want_w.items())
        log(f"[mesh_train] ... weights: worst |d|/max|p| {ww:.3e} (tol "
            f"{MESH_TRAIN_RTOL:g})")
        if ww > MESH_TRAIN_RTOL:
            raise AssertionError(f"{what}: weights differ from {against}")
        out[f"{what} vs {against}"] = dict(loss=lw, weights=ww)
    return out


def _mesh_train_main_update(cfg, tree, data):
    """The main path's optimizer and precision under the mesh: the bench's
    classifier (AdamWeightDecay with a bf16 first moment, mixed
    precision, bf16 gradients; dropout off) through
    ``BERTClassifier.train``, one dispatch of 4 graph replays at batch
    32, under data 2 x model 2 with ZeRO against the unsharded one:
    losses relative, weights and both moments of max|.|."""
    from analytics_zoo_tpu_torch.common.context import context_scope
    from analytics_zoo_tpu_torch.parallel.zero import (bytes_per_device,
                                                       tree_bytes)
    runs = {}
    for what in ("unsharded", "sharded"):
        clf = _bench_clf(cfg, tree, 4, total=4,
                         shard_optimizer=what == "sharded")
        scope = (context_scope(_mesh_ctx(2, 2)) if what == "sharded"
                 else contextlib.nullcontext())
        with scope, _DispatchLosses() as rec:
            clf.train(lambda: data, epochs=1)
        torch.cuda.synchronize()
        est = clf._train_est
        mu = {k: v for k, v in est.opt_state["mu"].items()}
        if what == "sharded" and not (
                est._plan.masters is not None
                and bytes_per_device(mu) < tree_bytes(mu)):
            raise AssertionError("mesh_train: the bf16 AdamW run was not "
                                 "placed by the Megatron and ZeRO specs")
        runs[what] = (rec.losses, _adam_state(est))
        del clf, est
        _release()
    (got_l, got), (want_l, want) = runs["sharded"], runs["unsharded"]
    what = "data 2 x model 2, ZeRO, AdamW bf16 (the main path's update)"
    lw = _close(f"{what} vs unsharded", got_l, want_l, MESH_TRAIN_BF16_TOL,
                phase="mesh_train")
    worst = _worst_by_kind(got, want)
    log(f"[mesh_train] ... worst |d|/max|.| weights {worst['weights']:.3e}, "
        f"first moment {worst['mu']:.3e}, second moment {worst['nu']:.3e} "
        f"(tol {MESH_TRAIN_BF16_TOL:g})")
    if max(worst.values()) > MESH_TRAIN_BF16_TOL:
        raise AssertionError(f"{what}: the update differs from the "
                             f"unsharded one: {worst}")
    return dict(loss=lw, **worst)


def _adam_state(est):
    """An Adam estimator's weights and both moments, whole (a sharded
    moment gathered), as f32 tensors: ``{name}``, ``mu.{name}``,
    ``nu.{name}``."""
    from analytics_zoo_tpu_torch.parallel import ShardedTensor
    full = lambda t: t.gather() if isinstance(t, ShardedTensor) else t
    state = {f"{k}.{n}": full(t).float().clone() for k in ("mu", "nu")
             for n, t in est.opt_state[k].items()}
    state.update({n: p.detach().float().clone()
                  for n, p in est.model.named_parameters()})
    return state


def _worst_by_kind(got, want, where=None):
    """The worst ``max|d| / max|w|`` over the leaves of two
    ``_adam_state`` dicts (tensors or arrays), by kind: weights, first
    and second moment; ``where`` (a dict) takes each kind's worst leaf."""
    worst = dict.fromkeys(("weights", "mu", "nu"), 0.0)
    where = {} if where is None else where
    for n, w in want.items():
        g, w = torch.as_tensor(got[n]), torch.as_tensor(w)
        kind = n.split(".")[0] if n.split(".")[0] in worst else "weights"
        d = ((g - w.to(g.device)).abs().max()
             / w.abs().max().clamp_min(1e-30)).item()
        if d >= worst[kind]:
            worst[kind], where[kind] = d, n
    return worst


def _mesh_train_resume(cfg, tree, data):
    """A per-host checkpoint written at the end of epoch 1 of a sharded
    f32 run (data 2 x model 2, ZeRO, K = 4) and restored by a new
    estimator, which trains epoch 2: its weights against the
    uninterrupted run's, to 0 difference."""
    import shutil
    import tempfile
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.estimator import checkpoint as ckpt
    from analytics_zoo_tpu_torch.estimator import estimator as est_mod
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    fs = data.get_training_data()

    def run(epochs, ckdir=None, resume=False):
        net = BERTClassifier(2, bert_config=cfg, device="cuda").net
        net.set_weights(tree)
        est = Estimator(net, SGD(lr=0.05, momentum=0.9),
                        "sparse_categorical_crossentropy",
                        ctx=_mesh_ctx(2, 2), shard_optimizer=True,
                        steps_per_dispatch=4, checkpoint_dir=ckdir)
        est.train(fs, BATCH, epochs=epochs, resume=resume)
        torch.cuda.synchronize()
        return est, {n: p.detach().clone() for n, p in net.named_parameters()}

    whole = run(2)[1]
    _release()
    tmp = tempfile.mkdtemp(prefix="zoo_mesh_ckpt_")
    save = est_mod.save_checkpoint
    est_mod.save_checkpoint = (lambda d, s, b, keep=3:
                               save(d, s, b, keep=keep, per_host=True))
    try:
        run(1, tmp)
    finally:
        est_mod.save_checkpoint = save
    try:
        ck = ckpt.latest_checkpoint(tmp)
        files = sorted(os.listdir(ck))
        if "shards.h0.npz" not in files:
            raise AssertionError(f"no per-host shard file in {ck}: {files}")
        est, resumed = run(2, tmp, resume=True)
        diff = max((resumed[n] - p).abs().max().item()
                   for n, p in whole.items())
        log(f"[mesh_train] per-host checkpoint {os.path.basename(ck)} "
            f"({', '.join(files)}) restored at step {4} -> global step "
            f"{est.global_step}: weights vs the uninterrupted run max "
            f"|d| {diff:.3e} (bar 0)")
        if est.global_step != 8 or diff != 0.0:
            raise AssertionError("the resumed sharded run differs from the "
                                 "uninterrupted one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _release()
    return diff


def phase_mesh_train(card):
    """Sharded training on the card; see the module docstring (7e)."""
    from analytics_zoo_tpu_torch.common.context import context_scope
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.parallel.zero import bytes_per_device
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier, TFDataset
    cfg = dict(BERT_BASE, hidden_drop=0.1, attn_drop=0.1)
    n_block = cfg["n_block"]
    tree = _random_tree(BERTClassifier(2, bert_config=cfg,
                                       device="cpu").net,
                        np.random.default_rng(SEED + 5))
    x, y = _bench_data(cfg)
    n = MESH_TRAIN["steps"] * BENCH["batch"]
    ds = TFDataset.from_ndarrays((tuple(a[:n] for a in x), y[:n]),
                                 batch_size=BENCH["batch"],
                                 memory_type="DEVICE")
    steps = MESH_TRAIN["steps"] * MESH_TRAIN["epochs"]
    ctx = _mesh_ctx(2, 2)
    out = {}

    # the main path: the bench's configuration under data 2 x model 2 with
    # the ZeRO update, through BERTClassifier.train under the context
    for what in ("sharded", "unsharded"):
        # the schedule spans the cut run (the bench's 100 warmup steps
        # would hold the learning rate near 0 for all 16)
        clf = _bench_clf(cfg, tree, MESH_TRAIN["spd"], total=steps,
                         shard_optimizer=what == "sharded")
        scope = (context_scope(ctx) if what == "sharded"
                 else contextlib.nullcontext())
        torch.cuda.reset_peak_memory_stats()
        with scope:
            _kernels.reset_launches()
            clf.train(lambda: ds, epochs=MESH_TRAIN["epochs"])
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
        est = clf._train_est
        hist = est.history
        ms = hist[-1]["seconds"] * 1e3 / MESH_TRAIN["steps"]
        row = dict(step_ms=ms, samples_s=BENCH["batch"] * 1e3 / ms,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   epoch_losses=[h["loss"] for h in hist],
                   launches=launches,
                   weight_bytes=bytes_per_device(est.params),
                   opt_bytes=bytes_per_device(
                       {k: v for k, v in est.opt_state.items()
                        if k != "decayed"}))
        log(f"[mesh_train] {what}: BERT-base bench configuration, "
            f"{steps} steps ({MESH_TRAIN['epochs']} epochs of one "
            f"{MESH_TRAIN['spd']}-replay dispatch) at batch "
            f"{BENCH['batch']}: {ms:.3f} ms a step "
            f"({row['samples_s']:.1f} samples/s), peak "
            f"{row['peak_gib']:.2f} GiB; epoch losses "
            f"{' '.join(f'{v:.4f}' for v in row['epoch_losses'])}; "
            f"launches {launches}; {card}")
        if what == "sharded":
            no_copies("mesh_train")
            want = dict.fromkeys(_kernels.KERNELS, 0)
            want.update(flash_fwd=steps * 4 * n_block,
                        flash_bwd=steps * 4 * n_block)
            if launches != want:
                raise AssertionError(f"mesh_train: expected {want} "
                                     f"launches through the replays, got "
                                     f"{launches}")
            losses = row["epoch_losses"]
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                raise AssertionError(f"mesh_train: the loss did not fall: "
                                     f"{losses}")
            specs = _spec_bytes(est, ctx, zshard=True)
            log(f"[mesh_train] bytes a position: weights "
                f"{row['weight_bytes']} (specs {specs['weights']}, "
                f"{row['weight_bytes'] / specs['weights_all']:.4f} of "
                f"replicated; Megatron leaves "
                f"{specs['matched_w'][0] / specs['matched_w'][1]:.4f}), "
                f"optimizer state {row['opt_bytes']} (specs "
                f"{specs['opt']}, {row['opt_bytes'] / specs['opt_all']:.4f}"
                f" of replicated; the second moment of those leaves "
                f"{specs['matched_opt'][0] / specs['matched_opt'][1]:.4f})")
            if (row["weight_bytes"], row["opt_bytes"]) != \
                    (specs["weights"], specs["opt"]):
                raise AssertionError("mesh_train: per-position bytes differ "
                                     "from the specs'")
            row["bytes"] = specs
        prof = profile_breakdown(
            lambda: clf.train(lambda: ds, epochs=1),
            f"mesh_train {what}: one {MESH_TRAIN['spd']}-replay dispatch "
            f"at batch {BENCH['batch']}", top=12)
        row["busy_share"] = prof[1] / prof[0] if prof else None
        out[what] = row
        del clf, est
        _release()

    cfg0 = dict(BERT_BASE, hidden_drop=0.0, attn_drop=0.0)
    small = ((tuple(a[:4 * BATCH] for a in x)), y[:4 * BATCH])
    data = TFDataset.from_ndarrays(small, batch_size=BATCH,
                                   memory_type="DEVICE")
    out["parity"] = _mesh_train_parity(cfg0, tree, data)
    out["main_update"] = _mesh_train_main_update(cfg0, tree, data)
    out["resume_diff"] = _mesh_train_resume(cfg0, tree, data)
    return out


def _flat_weights(net):
    """``{name: f32 numpy}`` of a module's parameters."""
    return {n: p.detach().float().cpu().numpy()
            for n, p in net.named_parameters()}


def _worst_rel(got, want):
    """The worst ``max|d| / max|w|`` over the leaves of two weight dicts."""
    return max(float(np.abs(got[n] - w).max()
                     / max(float(np.abs(w).max()), 1e-30))
               for n, w in want.items())


def _probe_gloo_reduce_scatter(group):
    """Whether this gloo build reduce-scatters CUDA tensors, as an answer
    string: what a ZeRO step's reduce-scatter of its gradient would need
    (the port's step all-reduces it)."""
    import torch.distributed as dist
    parts = [torch.full((4,), float(group.rank + 1), device="cuda")
             for _ in range(group.size)]
    out = torch.empty(4, device="cuda")
    try:
        group._wait(group.pg.reduce_scatter(
            [out], [parts], dist.ReduceScatterOptions()), "reduce_scatter")
        torch.cuda.synchronize()
        want = float(sum(range(1, group.size + 1)))
        return "yes" if bool((out == want).all()) else "wrong result"
    except Exception as exc:
        return f"no ({type(exc).__name__}: {str(exc).splitlines()[0][:120]})"


def _probe_bf16_all_reduce(group):
    """The largest difference between the backend's sum of every rank's
    bf16 CUDA tensor (a seeded draw a rank) and the same sum taken on this
    card (0: the gradients' all-reduce adds as torch does)."""
    draw = lambda r: torch.randn(1 << 16, generator=torch.Generator()
                                 .manual_seed(SEED + r)).bfloat16().cuda()
    got = group.all_reduce(draw(group.rank).clone())
    want = draw(0)
    for r in range(1, group.size):
        want = want + draw(r)
    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max())


def _multiproc_worker(rank, ref_path, ref_losses, upd_path, upd_losses):
    """One worker of the multiproc phase (7f), inside its rendezvoused
    context: the four legs; returns its readings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
    from analytics_zoo_tpu_torch.common.context import (
        ZooContext, _build_mesh, context_scope, current_context)
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops import attention as TA
    from analytics_zoo_tpu_torch.ops.dropout import _mask, process_offset
    from analytics_zoo_tpu_torch.parallel import distributed
    from analytics_zoo_tpu_torch.parallel.zero import bytes_per_device
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier, TFDataset
    ctx = current_context()
    group = ctx.group
    dev = ctx.mesh.local_devices[0]
    out = dict(rank=rank, device=str(dev), backend=ctx.backend,
               processes=ctx.process_count,
               gloo_cuda_reduce_scatter=_probe_gloo_reduce_scatter(group))
    cfg0 = dict(BERT_BASE, hidden_drop=0.0, attn_drop=0.0)
    tree = _random_tree(BERTClassifier(2, bert_config=cfg0,
                                       device="cpu").net,
                        np.random.default_rng(SEED + 5))
    x, y = _bench_data(cfg0)
    fwd = lambda a: _kernels.KERNELS[a].launches

    # (a) parity: against the one-process data-2 run, then ZeRO
    small = (tuple(a[:4 * BATCH] for a in x), y[:4 * BATCH])
    runs = {}
    for zero in (False, True):
        clf = BERTClassifier(2, bert_config=cfg0,
                             optimizer=SGD(lr=0.05, momentum=0.9),
                             shard_optimizer=zero, device="cuda")
        clf.load_weights(tree)
        data = TFDataset.from_ndarrays(small, batch_size=BATCH,
                                       memory_type="DEVICE")
        _kernels.reset_launches()
        with _DispatchLosses() as rec:
            clf.train(lambda: data, epochs=1)
        torch.cuda.synchronize()
        est = clf._train_est
        runs[zero] = (rec.losses, _flat_weights(clf.net),
                      bytes_per_device(est.opt_state["trace"]),
                      (fwd("flash_fwd"), fwd("flash_bwd")))
        del clf, est
        _release()
    ref = dict(np.load(ref_path))
    (pl, pw, pb, pla), (zl, zw, zb, zla) = runs[False], runs[True]
    out["a"] = dict(
        losses=pl, loss_rel=max(abs(a - b) / abs(b)
                                for a, b in zip(pl, ref_losses)),
        weight_rel=_worst_rel(pw, ref), zero_loss_rel=max(
            abs(a - b) / abs(b) for a, b in zip(zl, pl)),
        zero_weight_rel=_worst_rel(zw, pw), trace_bytes=(pb, zb),
        launches=pla, zero_launches=zla)
    del ref, runs, pw, zw

    # (a') the main path's update: against the one-process data-2 run
    clf = _bench_clf(cfg0, tree, 4, total=4, shard_optimizer=False)
    data = TFDataset.from_ndarrays(small, batch_size=BATCH,
                                   memory_type="DEVICE")
    _kernels.reset_launches()
    with _DispatchLosses() as rec:
        clf.train(lambda: data, epochs=1)
    torch.cuda.synchronize()
    got = _adam_state(clf._train_est)
    where = {}
    out["u"] = dict(
        losses=rec.losses, ref_losses=upd_losses,
        loss_rel=max(abs(a - b) / abs(b)
                     for a, b in zip(rec.losses, upd_losses)),
        launches=(fwd("flash_fwd"), fwd("flash_bwd")),
        **_worst_by_kind(got, dict(np.load(upd_path)), where), where=where,
        bf16_sum=_probe_bf16_all_reduce(group))
    del clf, got
    _release()

    # (b) dropout: this rank's rows of the one-process forward and masks
    cfgd = dict(BERT_BASE, hidden_drop=0.1, attn_drop=0.1)
    clf = BERTClassifier(2, bert_config=cfgd, device="cuda")
    clf.load_weights(tree)
    clf.net.train()
    B, T, D, H = BATCH, cfgd["seq_len"], cfgd["hidden_size"], cfgd["n_head"]
    lb = B // ctx.process_count
    rows = slice(rank * lb, (rank + 1) * lb)
    xb = [torch.from_numpy(a[:B]).cuda() for a in x]
    one = ZooContext(ZooConfig(), _build_mesh([dev], MeshConfig(data=1)))
    drop_seed = 1234
    with torch.no_grad():
        with context_scope(one):
            whole = clf.net(xb, seed=drop_seed)
        local = clf.net([a[rows] for a in xb], seed=drop_seed)
    torch.cuda.synchronize()
    hidden = torch.equal(
        _mask((lb, T, D), drop_seed, 0.1, dev,
              offset=process_offset((lb, T, D))),
        _mask((B, T, D), drop_seed, 0.1, dev)[rows])
    z = torch.zeros(B, H, T, T, device=dev)
    eye = torch.eye(T, device=dev).expand(B, H, T, T).contiguous()
    kw = dict(dropout_rate=0.1, dropout_seed=drop_seed)
    attn_whole = TA.flash_attention(z, z, eye, **kw) > 0
    attn_local = TA.flash_attention(
        z[rows], z[rows], eye[rows], **kw,
        bh_offset=distributed.batch_offset(lb) * H) > 0
    plain = TA._hash_keep_mask(drop_seed, (B, H, T, T), 0.1, dev)
    del z, eye
    opt = SGD(lr=0.05)
    clf2 = BERTClassifier(2, bert_config=cfgd, optimizer=opt, device="cuda")
    clf2.load_weights(tree)
    data = TFDataset.from_ndarrays((tuple(a[:2 * B] for a in x), y[:2 * B]),
                                   batch_size=B)
    _kernels.reset_launches()
    clf2.train(lambda: data, epochs=1, seed=drop_seed)
    torch.cuda.synchronize()
    out["b"] = dict(
        fwd_err=float((local - whole[rows]).abs().max()),
        hidden_equal=hidden,
        attn_equal=bool(torch.equal(attn_local, attn_whole[rows])),
        attn_plain_equal=bool(torch.equal(attn_whole, plain)),
        kept=float(attn_local.float().mean()),
        launches=(fwd("flash_fwd"), fwd("flash_bwd")), steps=2)
    del clf, clf2, whole, local, attn_whole, attn_local, plain
    _release()

    # (c) the main path at the bench's configuration
    cfgb = dict(BERT_BASE, hidden_drop=0.1, attn_drop=0.1)
    steps = MULTIPROC["steps"] * MULTIPROC["epochs"]
    n = MULTIPROC["steps"] * BENCH["batch"]
    ds = TFDataset.from_ndarrays((tuple(a[:n] for a in x), y[:n]),
                                 batch_size=BENCH["batch"],
                                 memory_type="DEVICE")
    clf = _bench_clf(cfgb, tree, BENCH["spd"], total=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    bytes0 = group.reduced_bytes
    for _ in range(MULTIPROC["epochs"]):          # one epoch a call
        reduce0 = group.reduce_seconds
        clf.train(lambda: ds, epochs=1)
        torch.cuda.synchronize()
    hist = clf._train_est.history
    out["c"] = dict(
        reduce_ms=(group.reduce_seconds - reduce0) * 1e3
        / MULTIPROC["steps"],
        step_ms=hist[-1]["seconds"] * 1e3 / MULTIPROC["steps"],
        first_epoch_step_ms=hist[0]["seconds"] * 1e3 / MULTIPROC["steps"],
        epoch_losses=[h["loss"] for h in hist],
        bytes_a_step=(group.reduced_bytes - bytes0) / steps,
        launches=(fwd("flash_fwd"), fwd("flash_bwd")), steps=steps,
        graphs=clf._train_est._graphs_on,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del clf
    _release()
    return out


def phase_multiproc(card):
    """Training over two processes; see the module docstring (7f)."""
    import shutil
    import tempfile
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.orca import RayContext
    from analytics_zoo_tpu_torch.common.context import context_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier, TFDataset
    t0 = time.perf_counter()
    cfg0 = dict(BERT_BASE, hidden_drop=0.0, attn_drop=0.0)
    tree = _random_tree(BERTClassifier(2, bert_config=cfg0,
                                       device="cpu").net,
                        np.random.default_rng(SEED + 5))
    x, y = _bench_data(cfg0)
    small = (tuple(a[:4 * BATCH] for a in x), y[:4 * BATCH])
    # the one-process data-2 run the workers are held to
    clf = BERTClassifier(2, bert_config=cfg0,
                         optimizer=SGD(lr=0.05, momentum=0.9),
                         device="cuda")
    clf.load_weights(tree)
    data = TFDataset.from_ndarrays(small, batch_size=BATCH,
                                   memory_type="DEVICE")
    with context_scope(_mesh_ctx(2, 1)), _DispatchLosses() as rec:
        clf.train(lambda: data, epochs=1)
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="zoo_multiproc_")
    ref_path = os.path.join(tmp, "ref.npz")
    np.savez(ref_path, **_flat_weights(clf.net))
    ref_losses = rec.losses
    del clf
    _release()
    # and the one the main path's update (a') is held to
    clf = _bench_clf(cfg0, tree, 4, total=4, shard_optimizer=False)
    with context_scope(_mesh_ctx(2, 1)), _DispatchLosses() as rec:
        clf.train(lambda: data, epochs=1)
    torch.cuda.synchronize()
    upd_path = os.path.join(tmp, "update.npz")
    np.savez(upd_path, **{n: t.cpu().numpy() for n, t
                          in _adam_state(clf._train_est).items()})
    upd_losses = rec.losses
    del clf, tree
    _release()
    t_ref = time.perf_counter() - t0
    rc = RayContext(num_workers=MULTIPROC["workers"]).init()
    try:
        res = rc.run(_multiproc_worker, args=(ref_path, ref_losses, upd_path,
                                              upd_losses),
                     timeout=MULTIPROC["timeout_s"])
    finally:
        rc.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t0
    n_block = BERT_BASE["n_block"]
    for r in res:
        a, u, b, c = r["a"], r["u"], r["b"], r["c"]
        log(f"[multiproc] rank {r['rank']} of {r['processes']} on "
            f"{r['device']} over {r['backend']}; gloo reduce_scatter of "
            f"CUDA tensors: {r['gloo_cuda_reduce_scatter']}")
        log(f"[multiproc] rank {r['rank']} (a) BERT-base f32, dropout off, "
            f"SGD momentum, global batch {BATCH}, 4 steps: losses "
            f"{' '.join(f'{v:.6f}' for v in a['losses'])}; vs the "
            f"one-process data-2 run: losses {a['loss_rel']:.3e} rel, "
            f"weights {a['weight_rel']:.3e} of max|p| (bar "
            f"{MULTIPROC_RTOL:g}); ZeRO vs not: losses "
            f"{a['zero_loss_rel']:.3e}, weights {a['zero_weight_rel']:.3e} "
            f"(bar {MULTIPROC_ZERO_TOL:g}); momentum bytes on this rank "
            f"{a['trace_bytes'][1]} with ZeRO, {a['trace_bytes'][0]} "
            f"without; launches {a['launches']} / {a['zero_launches']}")
        log(f"[multiproc] rank {r['rank']} (a') the main path's update "
            f"(AdamWeightDecay with a bf16 first moment, mixed precision, "
            f"bf16 gradients all-reduced over {r['backend']}), dropout off, "
            f"global batch {BATCH}, 4 steps: losses "
            f"{' '.join(f'{v:.6f}' for v in u['losses'])} (one process "
            f"{' '.join(f'{v:.6f}' for v in u['ref_losses'])}): "
            f"{u['loss_rel']:.3e} rel; worst |d|/max|.| of a leaf: weights "
            f"{u['weights']:.3e} ({u['where'].get('weights')}), first "
            f"moment {u['mu']:.3e} ({u['where'].get('mu')}), second moment "
            f"{u['nu']:.3e} ({u['where'].get('nu')}) (bars "
            f"{MULTIPROC_BF16_TOL}); launches {u['launches']}; the "
            f"backend's bf16 CUDA all-reduce vs torch's sum of the ranks' "
            f"draws: max|d| {u['bf16_sum']:g}")
        log(f"[multiproc] rank {r['rank']} (b) dropout 0.1: forward rows vs "
            f"the one-process forward max|d| {b['fwd_err']:.3e} (bar "
            f"{MULTIPROC_FWD_ATOL:g}); hidden keep-mask "
            f"{'equal' if b['hidden_equal'] else 'DIFFERENT'}, flash_fwd "
            f"attention keep-mask at its bh_offset "
            f"{'equal' if b['attn_equal'] else 'DIFFERENT'} to its rows of "
            f"the global masks (global kernel mask vs plain: "
            f"{'equal' if b['attn_plain_equal'] else 'DIFFERENT'}, kept "
            f"{b['kept']:.4f}); {b['steps']} training steps: launches "
            f"{b['launches']}")
        log(f"[multiproc] rank {r['rank']} (c) the bench's configuration at "
            f"global batch {BENCH['batch']} ({BENCH['batch'] // len(res)} "
            f"a rank), bf16, {c['steps']} steps "
            f"({'CUDA graphs' if c['graphs'] else 'eager steps'}): "
            f"{c['step_ms']:.3f} ms a step in epoch 2 "
            f"({c['first_epoch_step_ms']:.3f} in epoch 1), of which "
            f"{c['reduce_ms']:.3f} ms in the all-reduces, "
            f"{c['bytes_a_step']:.0f} bytes all-reduced a step over "
            f"{r['backend']} through the host on one shared card (not an "
            f"NCCL figure), epoch losses "
            f"{' '.join(f'{v:.4f}' for v in c['epoch_losses'])}, launches "
            f"{c['launches']}, peak {c['peak_gib']:.2f} GiB; {card}")
    log(f"[multiproc] phase {secs:.1f} s (the one-process reference "
        f"{t_ref:.1f} s)")
    for r in res:
        a, u, b, c = r["a"], r["u"], r["b"], r["c"]
        want_dev = f"cuda:{r['rank'] % torch.cuda.device_count()}"
        if r["processes"] != MULTIPROC["workers"] or r["device"] != want_dev:
            raise AssertionError(f"multiproc: rank {r['rank']} saw "
                                 f"{r['processes']} processes on "
                                 f"{r['device']}")
        if (a["loss_rel"] > MULTIPROC_RTOL or a["weight_rel"] > MULTIPROC_RTOL
                or a["zero_loss_rel"] > MULTIPROC_ZERO_TOL
                or a["zero_weight_rel"] > MULTIPROC_ZERO_TOL
                or not a["trace_bytes"][1] < a["trace_bytes"][0]):
            raise AssertionError(f"multiproc: parity failed on rank "
                                 f"{r['rank']}: {a}")
        if any(u[k] > MULTIPROC_BF16_TOL[k] for k in
               ("weights", "mu", "nu")) or \
                u["loss_rel"] > MULTIPROC_BF16_TOL["loss"] or \
                u["bf16_sum"] != 0:
            raise AssertionError(f"multiproc: the main path's update "
                                 f"differs on rank {r['rank']}: {u}")
        if (b["fwd_err"] > MULTIPROC_FWD_ATOL or not b["hidden_equal"]
                or not b["attn_equal"] or not b["attn_plain_equal"]):
            raise AssertionError(f"multiproc: dropout rows differ on rank "
                                 f"{r['rank']}: {b}")
        for leg, steps in ((a["launches"], 4), (a["zero_launches"], 4),
                           (u["launches"], 4),
                           (b["launches"], b["steps"]),
                           (c["launches"], c["steps"])):
            if tuple(leg) != (steps * n_block, steps * n_block):
                raise AssertionError(f"multiproc: expected {n_block} + "
                                     f"{n_block} launches a step, got "
                                     f"{leg} in {steps} steps")
        if not np.isfinite(c["epoch_losses"]).all():
            raise AssertionError(f"multiproc: {c['epoch_losses']}")
    if res[0]["a"]["losses"] != res[1]["a"]["losses"]:
        raise AssertionError("multiproc: the ranks report other losses")
    return dict(seconds=secs, ranks=res,
                launches={k: res[0]["c"]["launches"][i]
                          for i, k in enumerate(("flash_fwd",
                                                 "flash_bwd"))})


def _mlp_stage(p, h):
    F = torch.nn.functional
    return h + F.gelu(h @ p["W1"] + p["b1"], approximate="tanh") @ p["W2"] \
        + p["b2"]


def phase_parallel(card):
    from analytics_zoo_tpu_torch.parallel import (
        Mesh, init_moe_params, moe_ffn, pipeline_apply, stack_stage_params)

    gen = torch.Generator().manual_seed(SEED)
    cpu = lambda tree: {k: v.cpu() for k, v in tree.items()}  # noqa: E731

    def errs(what, got, card_ref, cpu_ref):
        e_card = (got - card_ref).abs().max().item()
        e_cpu = (got.cpu() - cpu_ref).abs().max().item()
        log(f"[parallel] {what}: vs unsharded on the card "
            f"{e_card:.3e} (bar {PARALLEL_ATOL['card']:g}), vs the CPU "
            f"{e_cpu:.3e} (bar {PARALLEL_ATOL['cpu']:g})")
        if (not torch.isfinite(got).all() or e_card > PARALLEL_ATOL["card"]
                or e_cpu > PARALLEL_ATOL["cpu"]):
            raise AssertionError(f"{what} disagrees")

    m = MOE
    params = init_moe_params(gen, m["d"], m["d_ff"], m["experts"],
                             device="cuda")
    x = torch.randn(m["tokens"], m["d"], generator=gen).cuda()
    mesh = Mesh(["cuda:0"] * m["groups"], ("expert",))
    with torch.inference_mode():
        y, aux = moe_ffn(params, x, mesh=mesh)
        y1, aux1 = moe_ffn(params, x)
        yc, auxc = moe_ffn(cpu(params), x.cpu())
        errs(f"moe_ffn d {m['d']} d_ff {m['d_ff']} E {m['experts']} "
             f"{m['tokens']} tokens over {m['groups']} expert shards",
             y, y1, yc)
        errs("its aux loss", aux.reshape(1), aux1.reshape(1),
             auxc.reshape(1))
        moe_ms = cuda_ms(lambda: moe_ffn(params, x, mesh=mesh), iters=10,
                         warmup=2)
        moe_whole_ms = cuda_ms(lambda: moe_ffn(params, x), iters=10,
                               warmup=2)
    p = PIPE
    stages = [{"W1": torch.randn(p["d"], p["d_ff"], generator=gen)
               / p["d"] ** 0.5, "b1": torch.zeros(p["d_ff"]),
               "W2": torch.randn(p["d_ff"], p["d"], generator=gen)
               / p["d_ff"] ** 0.5, "b2": torch.zeros(p["d"])}
              for _ in range(p["stages"])]
    stacked = {k: v.cuda() for k, v in stack_stage_params(stages).items()}
    xb = torch.randn(p["batch"], p["d"], generator=gen)
    xg = xb.cuda()
    pmesh = Mesh(["cuda:0"] * p["stages"], ("pipeline",))
    run = lambda: pipeline_apply(  # noqa: E731
        _mlp_stage, stacked, xg, mesh=pmesh,
        n_microbatches=p["microbatches"])
    with torch.inference_mode():
        y = run()
        seq, seq_cpu = xg, xb
        for s in range(p["stages"]):
            seq = _mlp_stage({k: v[s] for k, v in stacked.items()}, seq)
            seq_cpu = _mlp_stage(stages[s], seq_cpu)
        errs(f"pipeline_apply {p['stages']} stages x {p['microbatches']} "
             f"microbatches, batch {p['batch']}", y, seq, seq_cpu)
        pipe_ms = cuda_ms(run, iters=10, warmup=2)
    log(f"[parallel] moe_ffn {moe_ms:.3f} ms over {m['groups']} expert "
        f"shards ({moe_whole_ms:.3f} ms unsharded); pipeline_apply "
        f"{pipe_ms:.3f} ms ({p['stages']} stages on cuda:0, "
        f"{p['stages'] + p['microbatches'] - 1} ticks)")
    return dict(moe_ms=moe_ms, moe_whole_ms=moe_whole_ms, pipe_ms=pipe_ms)


def _check_lse(what, lse, ref):
    """lse within LSE_RTOL * max(1, |ref|); rows that see no key exactly
    -1e30 in both."""
    bad = ((lse - ref).abs() > LSE_RTOL * ref.abs().clamp_min(1.0)).sum()
    empty = ref == -1e30
    if bad.item() or not torch.equal(lse[empty], ref[empty]) \
            or not torch.isfinite(lse).all():
        raise AssertionError(f"{what}: lse disagrees with its plain version "
                             f"({bad.item()} rows out of tolerance)")
    return (lse - ref).abs().max().item()


def _ring_fwd_bwd(fn, q, k, v, go):
    """(o, (dq, dk, dv)) of ``fn`` through autograd."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, go)


def _check_grads(what, got, want, dtype):
    atol, rtol = BWD_TOL[dtype]
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(1.0, b.float().abs().max().item()) \
            if dtype == torch.float32 else 1.0
        diff = (a.float() - b.float()).abs()
        bad = (diff > atol * scale + rtol * b.float().abs()).sum().item()
        if bad or not torch.isfinite(a).all():
            raise AssertionError(f"{what} {name}: {bad} elements out of "
                                 f"tolerance, max_abs_err "
                                 f"{diff.max().item():.3e}")
        worst = max(worst, diff.max().item())
    return worst


def phase_ring():
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops.attention import (
        _reference_attention, flash_forward_with_lse)
    from analytics_zoo_tpu_torch.parallel import Mesh, ring_attention
    from analytics_zoo_tpu_torch.parallel import ring as ring_mod
    F = torch.nn.functional
    B, H, T, D, sp = (RING[k] for k in ("B", "H", "T", "D", "sp"))
    T_loc = T // sp
    gen = torch.Generator().manual_seed(SEED + 3)

    # 1. the kernel against its plain version at the ring's block shapes
    cases = {
        f"full block T{T_loc} D{D}": dict(Tq=T_loc, Tk=T_loc),
        f"diagonal causal T{T_loc} D{D}": dict(Tq=T_loc, Tk=T_loc,
                                               causal=True),
        f"causal Tq=1000 < Tk={T_loc}": dict(Tq=1000, Tk=T_loc,
                                             causal=True),
        "causal Tq=1000 > Tk=700 D32": dict(Tq=1000, Tk=700, D=32,
                                            causal=True),
        "ragged T=1000 D128": dict(Tq=1000, Tk=1000, D=128),
    }
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for name, case in cases.items():
            q, k, v = _attention_inputs(dtype, B, H, case["Tq"], case["Tk"],
                                        case.get("D", D), gen)
            causal = case.get("causal", False)
            o, lse = flash_forward_with_lse(q, k, v, causal=causal)
            ro, rlse = flash_forward_with_lse(q, k, v, causal=causal,
                                              backend="plain")
            torch.cuda.synchronize()
            what = f"flash_fwd_lse {dtype} {name} vs its plain version"
            err = _max_err(what, o, ro, dtype)
            lse_err = _check_lse(what, lse, rlse)
            log(f"[ring] flash_fwd_lse {str(dtype)[6:]:8s} {name:30s} "
                f"o max_abs_err={err:.3e} (tol atol {atol:g} + rtol "
                f"{rtol:g}), lse max_abs_err={lse_err:.3e} (tol "
                f"{LSE_RTOL:g} x max(1, |lse|)) -> ok")
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            del q, k, v, o, lse, ro, rlse

    # 2. times of one full ring block (the bound counts its full
    # T_loc x T_loc per head) and of the diagonal causal block
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        q, k, v = _attention_inputs(dtype, B, H, T_loc, T_loc, D, gen)
        ms = cuda_ms(lambda: flash_forward_with_lse(q, k, v), iters=10,
                     warmup=2)
        diag_ms = cuda_ms(lambda: flash_forward_with_lse(q, k, v,
                                                         causal=True),
                          iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: flash_forward_with_lse(
            q, k, v, backend="plain"), iters=5, warmup=1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                         iters=10, warmup=2)
        lib_diag_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=10, warmup=2)
        nbytes = 4 * B * H * T_loc * D * es + B * H * T_loc * 4
        flops = 4 * B * H * T_loc * T_loc * D
        diag_flops = 4 * B * H * T_loc * (T_loc + 1) // 2 * D  # seen pairs
        bound, by, t_bytes, t_ops = _bound(nbytes, flops, dtype)
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, bound_by=by,
                           max_abs_err=errs[dtype], diag_causal_ms=diag_ms,
                           diag_library_ms=lib_diag_ms,
                           tflops=flops / ms / 1e9,
                           diag_tflops=diag_flops / diag_ms / 1e9)
        log(f"[ring] flash_fwd_lse {str(dtype)[6:]:8s} B{B} H{H} "
            f"T{T_loc} D{D}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s; diagonal causal block {diag_ms:.4f} ms, "
            f"{diag_flops / diag_ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (causal "
            f"{lib_diag_ms:.4f} ms; no lse), bound {bound:.4f} ms ({by}; "
            f"bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms at "
            f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s)")
        del q, k, v

    # 3. the main path: the ring through its autograd.Function on four
    # shards of one card, forward and backward, its launches counted from
    # zero; then each run against the ring with plain blocks
    mesh = Mesh(["cuda:0"] * sp, ("sequence",))
    configs = [(dtype, causal) for dtype in (torch.float32, torch.bfloat16)
               for causal in (False, True)]
    per_fwd = lambda causal: sp * (sp + 1) // 2 if causal else sp * sp
    inputs = {c: _bwd_inputs(c[0], B, H, T, T, D, gen)[:4]
              for c in configs}
    runs, counted = {}, {}
    ring_kernels = ("flash_fwd_lse", "flash_bwd_lse")
    _kernels.reset_launches()
    for dtype, causal in configs:
        before = [_kernels.KERNELS[n].launches for n in ring_kernels]
        runs[dtype, causal] = _ring_fwd_bwd(
            lambda *t: ring_attention(*t, mesh, causal=causal),
            *inputs[dtype, causal])
        counted[dtype, causal] = tuple(
            _kernels.KERNELS[n].launches - b
            for n, b in zip(ring_kernels, before))
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in _kernels.KERNELS.items()}
    no_copies("ring")
    want = dict.fromkeys(_kernels.KERNELS, 0)
    for name in ring_kernels:
        want[name] = sum(per_fwd(c) for _, c in configs)
    log(f"[ring] main path: ring_attention forward + backward, f32 and bf16,"
        f" full and causal, B{B} H{H} T{T} D{D} over {sp} shards of cuda:0:"
        f" launches {launches}")
    if launches != want or any(counted[c] != (per_fwd(c[1]),) * 2
                               for c in configs):
        raise AssertionError(f"expected {want} launches ({per_fwd(False)} "
                             f"per full and {per_fwd(True)} per causal "
                             f"forward and backward), got {launches}, per "
                             f"run (forward, backward) {counted}")

    for dtype, causal in configs:
        what = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
        q, k, v, go = inputs[dtype, causal]
        o, grads = runs.pop((dtype, causal))
        ref_o, ref_grads = _ring_fwd_bwd(
            lambda *t: ring_attention(*t, mesh, causal=causal,
                                      impl="plain"), q, k, v, go)
        torch.cuda.synchronize()
        err = _max_err(f"ring {what} T{T} output vs plain blocks", o,
                       ref_o, dtype)
        g_err = _check_grads(f"ring {what} T{T}", grads, ref_grads, dtype)
        del o, grads, ref_o, ref_grads
        layout = ring_mod._Layout(mesh, "sequence", None, B, T)
        with torch.no_grad():
            _, lse = ring_mod._forward(q, k, v, layout, D ** -0.5, causal,
                                       "cuda")
            _, ref_lse = ring_mod._forward(q, k, v, layout, D ** -0.5,
                                           causal, "plain")
        lse_err = _check_lse(f"ring {what} T{T}", lse, ref_lse)
        del lse, ref_lse
        log(f"[ring] ring_attention {what:13s} T{T}: "
            f"{counted[dtype, causal][0]} flash_fwd_lse launches per "
            f"forward, {counted[dtype, causal][1]} flash_bwd_lse per "
            f"backward; vs the ring with plain blocks: o "
            f"max_abs_err {err:.3e}, lse {lse_err:.3e}, dq/dk/dv "
            f"{g_err:.3e} -> ok")

        fwd = lambda: ring_attention(q, k, v, mesh, causal=causal)
        with torch.no_grad():
            fwd_ms = cuda_ms(fwd, iters=3, warmup=1)
        fwd_bwd_ms = cuda_ms(lambda: _ring_fwd_bwd(
            lambda *t: ring_attention(*t, mesh, causal=causal), q, k, v,
            go), iters=2, warmup=1)
        log(f"[ring] ring_attention {what:13s} B{B} H{H} T{T} D{D}: "
            f"forward {fwd_ms:.3f} ms, forward+backward {fwd_bwd_ms:.3f} ms")
        if dtype == torch.float32 and causal:
            with torch.no_grad():
                profile_breakdown(fwd, f"one causal f32 ring forward, "
                                       f"T{T} over {sp} shards", top=8)
            _no_gemm_in_backward(
                lambda *t: ring_attention(*t, mesh, causal=causal),
                q, k, v, go, f"one causal f32 ring backward, T{T} over "
                             f"{sp} shards")
        del q, k, v, go
        inputs.pop((dtype, causal))

    # 4. against dense plain attention and its autograd gradients
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            what = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
            q, k, v, go, _ = _bwd_inputs(dtype, B, H, RING_DENSE_T,
                                         RING_DENSE_T, D, gen)
            o, grads = _ring_fwd_bwd(
                lambda *t: ring_attention(*t, mesh, causal=causal),
                q, k, v, go)
            ref_o, ref_grads = _ring_fwd_bwd(
                lambda *t: _reference_attention(*t, causal=causal),
                q, k, v, go)
            torch.cuda.synchronize()
            err = _max_err(f"ring {what} T{RING_DENSE_T} vs dense", o,
                           ref_o, dtype)
            g_err = _check_grads(f"ring {what} T{RING_DENSE_T} vs dense",
                                 grads, ref_grads, dtype)
            log(f"[ring] ring_attention {what:13s} T{RING_DENSE_T} vs dense "
                f"plain attention: o max_abs_err {err:.3e}, autograd "
                f"dq/dk/dv max_abs_err {g_err:.3e} -> ok")
            del q, k, v, go, o, grads, ref_o, ref_grads
    return launches, rows


def _no_gemm_in_backward(fn, q, k, v, go, what, attempts=3):
    """Profiles the backward alone of ``fn``'s autograd graph and fails if
    a library GEMM ran in it (every product must be in the kernels); a
    session that records no device time is made again."""
    from torch.profiler import ProfilerActivity, profile
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    for attempt in range(1, attempts + 1):
        out = fn(*leaves)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, leaves, go)
            torch.cuda.synchronize()
        dev = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if sum(dev.values()) > 0:
            break
        log(f"[profile] session {attempt} of {attempts} recorded no device "
            "time")
    else:
        raise AssertionError(f"{what}: the profiler recorded no device time")
    total = sum(dev.values())
    log(f"[ring] {what}: device busy {total / 1e3:.3f} ms")
    for key, t in sorted(dev.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[profile]   {100 * t / total:5.1f}%  {t / 1e3:8.3f} ms  "
            f"{key[:90]}")
    gemms = [key for key in dev if any(
        w in key.lower() for w in ("gemm", "xmma", "cutlass", "gemv"))]
    if gemms or not any("flash_bwd" in key for key in dev):
        raise AssertionError(f"{what}: library GEMMs {gemms} ran, or no "
                             f"flash_bwd kernel: {sorted(dev)}")


def phase_ring_cards(n):
    """The ring over n cards, one shard each, against the same ring as n
    shards of cuda:0; returns {case: {mesh: (fwd ms, fwd+bwd ms)}}."""
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.parallel import Mesh, ring_attention
    B, H, T, D = (RING[k] for k in ("B", "H", "T", "D"))
    gen = torch.Generator().manual_seed(SEED + 4)
    meshes = {"1 card": Mesh(["cuda:0"] * n, ("sequence",)),
              f"{n} cards": Mesh([f"cuda:{i}" for i in range(n)],
                                 ("sequence",))}
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            what = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
            q, k, v, go, _ = _bwd_inputs(dtype, B, H, T, T, D, gen)
            runs = {}
            for name, mesh in meshes.items():
                before = _kernels.flash_fwd_lse.launches
                runs[name] = _ring_fwd_bwd(
                    lambda *t: ring_attention(*t, mesh, causal=causal),
                    q, k, v, go)
                n_launch = _kernels.flash_fwd_lse.launches - before
                if n_launch != (n * (n + 1) // 2 if causal else n * n):
                    raise AssertionError(f"ring {what} on {name}: "
                                         f"{n_launch} launches")
            for dev in range(n):
                torch.cuda.synchronize(dev)
            (o1, g1), (on, gn) = runs.values()
            err = _max_err(f"ring {what}: {n} cards vs 1 card", on, o1,
                           dtype)
            g_err = _check_grads(f"ring {what}: {n} cards vs 1 card", gn,
                                 g1, dtype)
            del runs, o1, g1, on, gn

            def timed(mesh):
                with torch.no_grad():
                    fwd_ms = wall_ms(lambda: ring_attention(
                        q, k, v, mesh, causal=causal), n, iters=3)
                both_ms = wall_ms(lambda: _ring_fwd_bwd(
                    lambda *t: ring_attention(*t, mesh, causal=causal),
                    q, k, v, go), n, iters=2)
                return fwd_ms, both_ms
            names = list(meshes)
            order = names + names[::-1]             # 1, n, n, 1 cards
            got = {name: [] for name in names}
            for name in order:
                got[name].append(timed(meshes[name]))
            times[what] = {name: tuple(float(np.mean(c)) for c in
                                       zip(*got[name])) for name in names}
            log(f"[ring-cards] {what:13s} B{B} H{H} T{T} D{D}: {n} cards "
                f"vs 1 card: o max_abs_err {err:.3e}, dq/dk/dv "
                f"{g_err:.3e} -> ok; " + "; ".join(
                    f"{name}: forward {' / '.join(f'{f:.3f}' for f, _ in ts)}"
                    f" ms, forward+backward "
                    f"{' / '.join(f'{b:.3f}' for _, b in ts)} ms"
                    for name, ts in got.items()))
            del q, k, v, go
    return times


def profile_breakdown(fn, what, top=8):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time; returns (wall ms,
    device busy ms, [(kernel name, device us, calls)]), or None when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(t for _, t, _ in dev)
    if total <= 0:
        log(f"[profile] {what}: the profiler recorded no device time "
            "(device breakdown not measured)")
        return None
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{total / 1e3:.3f} ms ({100 * total / wall_us:.1f}% of wall)")
    for key, t, n in sorted(dev, key=lambda r: -r[1])[:top]:
        log(f"[profile]   {100 * t / total:5.1f}%  {t / 1e3:8.3f} ms  "
            f"x{n:<4d} {key[:90]}")
    return wall_us / 1e3, total / 1e3, dev


def _keras_tree(net, rng):
    """Weights from a numpy seed in the JAX tree layout: embedding tables
    N(0, 0.5), dense kernels glorot-uniform, biases 0 (wide enough apart
    that a top-10 ranking is not a run of near-ties)."""
    tree = {}
    for path, p in net.state_dict().items():
        shape = tuple(p.shape)
        if path.endswith("embeddings"):
            w = rng.normal(0.0, 0.5, shape)
        elif path.endswith(".W"):
            limit = np.sqrt(6.0 / sum(shape))
            w = rng.uniform(-limit, limit, shape)
        else:
            w = np.zeros(shape)
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = w.astype(np.float32)
    return tree


def _rec_pair(build, rng, device, weights=_keras_tree):
    """The same model on ``device`` and on the CPU, random weights
    (``weights(cpu_net, rng)``)."""
    from analytics_zoo_tpu_torch.keras import engine
    engine.reset_uids()
    card = build(device)
    engine.reset_uids()
    cpu = build("cpu")
    tree = weights(cpu, rng)
    card.set_weights(tree)
    cpu.set_weights(tree)
    return card, cpu


def _train_rec(what, card, cpu, x, y, card_name, steps=10, compare=3):
    """``fit`` on the card for ``steps`` steps of REC_BATCH (the first
    ``compare`` against the same steps on the CPU), then a timed warm
    ``fit`` and a profile of one step."""
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.data.featureset import tree_map
    B = REC_BATCH
    n = B * steps
    head = lambda t: tree_map(lambda a: a[:B * compare], t)
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False)
    for m in (card, cpu):
        m.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    with _DispatchLosses() as on_card:
        card.fit(fs, batch_size=B, nb_epoch=1)
        torch.cuda.synchronize()
    with _DispatchLosses() as on_cpu:
        cpu.fit(FeatureSet.from_ndarrays(head(x), head(y), shuffle=False),
                batch_size=B, nb_epoch=1)
    got, want = np.array(on_card.losses), np.array(on_cpu.losses)
    rel = float(np.max(np.abs(got[:compare] - want) / np.abs(want)))
    log(f"[ncf] {what} fit, batch {B}: per-step loss "
        f"{' '.join(f'{v:.6f}' for v in got)}; CPU "
        f"{' '.join(f'{v:.6f}' for v in want)}; first {compare} max rel "
        f"diff {rel:.3e} (tol {REC_LOSS_RTOL:g})")
    if (len(got) != steps or len(want) != compare
            or not np.isfinite(got).all() or rel > REC_LOSS_RTOL):
        raise AssertionError(f"{what}: training on the card disagrees with "
                             "the CPU")
    t0 = time.perf_counter()
    card.fit(fs, batch_size=B, nb_epoch=1, warm_start=True)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    # the host feed alone: the same batches sliced and copied to the card
    t0 = time.perf_counter()
    for _ in fs.batches(B, device=card.device):
        pass
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t0) * 1e3 / steps
    log(f"[ncf] {what} training step at batch {B}: {step_ms:.3f} ms, "
        f"{B * 1e3 / step_ms:.1f} samples/s over {steps} steps "
        f"(host batches), of it the host feed {feed_ms:.3f} ms a batch, on "
        f"{card_name}")
    first = lambda t: tree_map(lambda a: a[:B], t)
    one = FeatureSet.from_ndarrays(first(x), first(y), shuffle=False)
    one_step = lambda: card.fit(one, batch_size=B, nb_epoch=1,
                                warm_start=True)
    prof = profile_breakdown(one_step, f"{what}: one training step at "
                             f"batch {B} on {card_name}", top=10)
    return dict(step_ms=step_ms, samples_s=B * 1e3 / step_ms,
                feed_ms=feed_ms, losses=got.tolist(), cpu_losses=want.tolist(),
                busy_share=None if prof is None else prof[1] / prof[0])


def phase_ncf(card_name, n_requests=48, device="cuda"):
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import (
        ColumnFeatureInfo, NeuralCF, WideAndDeep, assemble_feature_dict)
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing

    rng = np.random.default_rng(SEED)
    ncf, ncf_cpu = _rec_pair(lambda d: NeuralCF(device=d, **NCF_ML1M), rng,
                             device)
    log(f"[ncf] NeuralCF {NCF_ML1M}, {ncf.param_count():,} parameters (f32)")
    _kernels.reset_launches()

    # 1. serve: a burst of request batches of 1..1024 pairs; one batch in
    # the middle carries ids past either end of the user table
    users, items = NCF_ML1M["user_count"], NCF_ML1M["item_count"]
    sizes = rng.integers(1, 1025, n_requests)
    sizes[:2] = (1, 1024)
    bad = n_requests // 2
    reqs = []
    for r, n in enumerate(sizes):
        u = rng.integers(1, users + 1, (n, 1)).astype(np.int32)
        i = rng.integers(1, items + 1, (n, 1)).astype(np.int32)
        if r == bad:
            u[:2, 0] = (users + 1, -(users + 2))
        reqs.append((u, i))
    im = InferenceModel(device=device).load_keras(ncf)
    im.warmup({"user": reqs[1][0], "item": reqs[1][1]},
              [2 ** k for k in range(16)])
    broker = InMemoryBroker()
    serving = ClusterServing(im, ServingConfig(
        pipeline=False, batch_size=32, redis_url="memory://"),
        broker=broker).start()
    uris = [[f"r{r}-{j}" for j in range(len(u))]
            for r, (u, _) in enumerate(reqs)]
    try:
        iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
        t0 = time.perf_counter()
        for (u, i), names in zip(reqs, uris):
            iq.enqueue_batch(names, user=u, item=i)
        got = [np.stack([oq.query_blocking(name, timeout=300)
                         for name in names]) for names in uris]
        secs = time.perf_counter() - t0
    finally:
        serving.stop()
    pairs = int(sizes.sum())
    want = [ncf_cpu.predict([u, i], batch_size=1024) for u, i in reqs]
    nan_ok = all(np.array_equal(np.isnan(g), np.isnan(w))
                 for g, w in zip(got, want))
    err = max(float(np.nanmax(np.abs(g - w))) for g, w in zip(got, want))
    nan_rows = np.isnan(got[bad]).any(axis=1)
    ok = (nan_ok and err <= REC_SERVE_ATOL and nan_rows[:2].all()
          and not nan_rows[2:].any()
          and all(not np.isnan(g).any() for r, g in enumerate(got)
                  if r != bad))
    log(f"[ncf] served {n_requests} request batches ({pairs} pairs, sizes "
        f"1..1024) in {secs:.4f} s: {n_requests / secs:.2f} requests/s, "
        f"{pairs / secs:.1f} pairs/s on {card_name}; vs the CPU forward "
        f"max_abs_err={err:.3e} tol={REC_SERVE_ATOL:g}; out-of-range ids "
        f"(request {bad}) NaN as on the CPU, {n_requests - bad - 1} later "
        f"requests answered -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("served NCF answers disagree with the CPU")
    top = ncf.recommend_for_user(17, 10)
    top_cpu = ncf_cpu.recommend_for_user(17, 10)
    score = dict(ncf_cpu.recommend_for_user(17, items))
    same = all(a == b or abs(score[a] - score[b]) <= REC_SERVE_ATOL
               for (a, _), (b, _) in zip(top, top_cpu))
    log(f"[ncf] recommend_for_user(17, 10) over {items} items: "
        f"{[a for a, _ in top]} (CPU {[b for b, _ in top_cpu]}) -> "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("recommend_for_user differs from the CPU")
    predict_ms = {b: cuda_ms(lambda b=b: im.predict(
        {"user": reqs[1][0][:b], "item": reqs[1][1][:b]}), iters=50,
        warmup=5) for b in (1, 1024)}
    log(f"[ncf] InferenceModel.predict: batch 1 {predict_ms[1]:.4f} ms, "
        f"batch 1024 {predict_ms[1024]:.4f} ms on {card_name}")

    # 2. train NCF and WideAndDeep at bench's batch (host batches)
    steps = 10
    rs = np.random.RandomState(0)            # drawn as bench.py:730-735
    n = REC_BATCH * steps
    x = [rs.randint(1, users + 1, (n, 1)).astype(np.int32),
         rs.randint(1, items + 1, (n, 1)).astype(np.int32)]
    y = rs.randint(0, 2, (n,)).astype(np.int32)
    train = {"NeuralCF": _train_rec("NeuralCF", ncf, ncf_cpu, x, y,
                                    card_name, steps)}
    del x, y
    ci = ColumnFeatureInfo(**WND_ML1M)
    rs = np.random.RandomState(0)            # drawn as bench.py:988-994
    columns = {"occupation": rs.randint(0, 21, n),
               "gender": rs.randint(0, 3, n),
               "age-gender": rs.randint(0, 100, n),
               "userId": rs.randint(1, 6041, n),
               "itemId": rs.randint(1, 3953, n),
               "age": rs.randint(18, 60, n).astype(np.float32)}
    feats = assemble_feature_dict(columns, ci, "wide_n_deep")
    labels = rs.randint(0, 2, n).astype(np.int32)
    wnd, wnd_cpu = _rec_pair(
        lambda d: WideAndDeep("wide_n_deep", class_num=2, column_info=ci,
                              device=d), rng, device)
    log(f"[ncf] WideAndDeep (wide_n_deep, MovieLens-1M columns), "
        f"{wnd.param_count():,} parameters (f32)")
    train["WideAndDeep"] = _train_rec("WideAndDeep", wnd, wnd_cpu, feats,
                                      labels, card_name, steps)
    launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
    if any(launches.values()):
        raise AssertionError(f"the ncf path launched port kernels: "
                             f"{launches}")
    log(f"[ncf] port kernel launches in the phase: {launches} (none "
        "expected: embedding gathers and dense products are PyTorch calls)")
    return dict(requests_s=n_requests / secs, pairs_s=pairs / secs,
                predict_ms=predict_ms, train=train)


def _zoo_tree(net, rng):
    """Weights from a numpy seed in the JAX tree layout: embedding tables
    uniform in +-0.05 (Keras-1's ``uniform``), kernels (``W``, ``U``,
    ``depthwise`` / ``pointwise``) glorot-uniform over their fans as the
    initializers count them, every other leaf (biases, BatchNorm's gamma /
    beta and statistics, an LSTM's forget bias of 1) as the model's own
    initialisation leaves it."""
    params, state = net.get_weights()

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
                continue
            shape = val.shape
            if key == "embeddings":
                w = rng.uniform(-0.05, 0.05, shape)
            elif key in ("W", "U", "depthwise", "pointwise") and \
                    len(shape) >= 2:
                recept = int(np.prod(shape[:-2]))
                fan_in, fan_out = shape[-2] * recept, shape[-1] * recept
                limit = np.sqrt(6.0 / (fan_in + fan_out))
                w = rng.uniform(-limit, limit, shape)
            else:
                w = val
            out[key] = np.asarray(w, np.float32)
        return out
    return fill(params), state


def _weights_close(what, a, b, rtol):
    """Every tensor of two state dicts within ``rtol`` of its largest
    magnitude (parameters and buffers)."""
    worst = 0.0
    for k, t in b.items():
        scale = max(float(t.abs().max()), 1e-30)
        worst = max(worst, float((a[k].cpu() - t.cpu()).abs().max()) / scale)
    log(f"[zoo] {what}: weights and buffers, worst |d| / max|p| "
        f"{worst:.3e} (tol {rtol:g})")
    if worst > rtol:
        raise AssertionError(f"{what}: weights disagree")
    return worst


def _zoo_data():
    """The training set: ZOO['n'] sequences of TEXT_NEWS20's length from
    ``RandomState(0)``, the label a class token planted at one random
    position (tokens 1..20 are the class tokens; the rest are drawn from
    21..vocab-1)."""
    n, T, C = ZOO["n"], TEXT_NEWS20["sequence_length"], TEXT_NEWS20[
        "class_num"]
    rs = np.random.RandomState(0)
    x = rs.randint(C + 1, TEXT_NEWS20["vocab_size"], (n, T)).astype(np.int32)
    y = rs.randint(0, C, n).astype(np.int32)
    x[np.arange(n), rs.randint(0, T, n)] = y + 1
    return x, y


def _fit_record(net, fs, epochs, spd=None, warm_start=False):
    """``fit`` at ZOO's batch; returns every step's loss.  A cold fit
    takes ``spd``; a warm start continues the last fit's estimator."""
    kw = {} if warm_start else {"steps_per_dispatch": spd}
    with _DispatchLosses() as rec:
        net.fit(fs, batch_size=ZOO["batch"], nb_epoch=epochs,
                warm_start=warm_start, **kw)
        torch.cuda.synchronize()
    return rec.losses


def _serve_text(card, cpu, card_name, rng_np, enc):
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    T, V = TEXT_NEWS20["sequence_length"], TEXT_NEWS20["vocab_size"]
    n = ZOO["requests"]
    reqs = rng_np.integers(1, V, (n, T)).astype(np.int32)
    im = InferenceModel(device="cuda").load_keras(card)
    im.warmup({"tokens": reqs[:1]}, [1, 2, 4, 8, 16, 32, 64])
    config = ServingConfig()
    assert config.pipeline
    broker = InMemoryBroker()
    serving = ClusterServing(im, config, broker=broker).start()
    try:
        iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
        sent = []
        t0 = time.perf_counter()
        for i in range(n):
            sent.append(time.perf_counter())
            iq.enqueue(f"{enc}-{i}", tokens=reqs[i])
        got, done = [], []
        for i in range(n):
            got.append(oq.query_blocking(f"{enc}-{i}", timeout=300))
            done.append(time.perf_counter())
        secs = time.perf_counter() - t0
    finally:
        serving.stop()
    got = np.stack(got)
    want = cpu.predict(reqs, batch_size=n)
    err = float(np.max(np.abs(got - want)))
    lat = [1e3 * (d - s) for s, d in zip(sent, done)]
    ok = got.shape == want.shape and np.isfinite(got).all() and \
        err <= ZOO_SERVE_ATOL
    log(f"[zoo] TextClassifier({enc}) served {n} requests of {T} tokens "
        f"through the pipelined ClusterServing in {secs:.4f} s: "
        f"{n / secs:.2f} requests/s, latency p50 {_pct(lat, 50):.3f} ms, "
        f"p99 {_pct(lat, 99):.3f} ms (enqueue to the result read, read in "
        f"request order) on {card_name}; vs the CPU forward max_abs_err="
        f"{err:.3e} tol={ZOO_SERVE_ATOL:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"served TextClassifier({enc}) answers "
                             "disagree with the CPU")
    return dict(requests_s=n / secs, p50_ms=_pct(lat, 50),
                p99_ms=_pct(lat, 99), max_abs_err=err)


def _train_text(card, cpu, card_name, enc, x, y, build, tree, t0):
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.keras import engine
    from analytics_zoo_tpu_torch.keras.optimizers import Adagrad
    B, steps, epochs = ZOO["batch"], ZOO["steps"], ZOO["epochs"]
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False).cache_device(
        shuffle_batches=False)
    compare = 3
    out = {}
    # the graph run (K = 32): epoch 1 (the capture, then 32 replays), its
    # weights kept, then epoch 2 continuing it (warm start): step time,
    # peak memory
    card.compile(Adagrad(lr=0.01), "sparse_categorical_crossentropy",
                 ["accuracy"])
    torch.cuda.reset_peak_memory_stats()
    graph_losses = _fit_record(card, fs, 1, ZOO["spd"])
    graph_state = {k: v.detach().clone() for k, v in
                   card.state_dict().items()}
    graph_losses += _fit_record(card, fs, epochs - 1, warm_start=True)
    graph_peak = torch.cuda.max_memory_allocated()
    hist = card._last_estimator.history
    graph_ms = hist[-1]["seconds"] * 1e3 / steps
    log(f"[zoo] TextClassifier({enc}) graph run: {len(graph_losses)} steps "
        f"({time.perf_counter() - t0:.1f} s into the phase)")
    # the CPU: the same first steps (dropout on, the same seeds)
    cpu.compile(Adagrad(lr=0.01), "sparse_categorical_crossentropy")
    head = FeatureSet.from_ndarrays(x[:B * compare], y[:B * compare],
                                    shuffle=False)
    with _DispatchLosses() as on_cpu:
        cpu.fit(head, batch_size=B, nb_epoch=1)
    out["cpu_rel"] = _close(
        f"TextClassifier({enc}) first {compare} steps, card (graph) vs CPU",
        graph_losses[:compare], on_cpu.losses, ZOO_LOSS_RTOL, "zoo")
    log(f"[zoo] TextClassifier({enc}) CPU steps done "
        f"({time.perf_counter() - t0:.1f} s into the phase)")
    # eager (K = 1) from the same weights, one epoch: against the graph's
    # first epoch
    engine.reset_uids()
    eager = build("cuda")
    eager.set_weights(tree)
    eager.compile(Adagrad(lr=0.01), "sparse_categorical_crossentropy",
                  ["accuracy"])
    torch.cuda.reset_peak_memory_stats()
    eager_losses = _fit_record(eager, fs, 1, 1)
    eager_peak = torch.cuda.max_memory_allocated()
    eager_ms = eager._last_estimator.history[-1]["seconds"] * 1e3 / steps
    out["graph_rel"] = _close(
        f"TextClassifier({enc}) {steps} steps, graph (K={ZOO['spd']}) vs "
        f"eager (K=1)", graph_losses[:steps], eager_losses, ZOO_GRAPH_RTOL,
        "zoo")
    out["graph_weights"] = _weights_close(
        f"TextClassifier({enc}) graph vs eager after {steps} steps",
        graph_state, eager.state_dict(), ZOO_GRAPH_RTOL)
    epoch_losses = [h["loss"] for h in hist]
    log(f"[zoo] TextClassifier({enc}) epoch losses "
        f"{' '.join(f'{v:.4f}' for v in epoch_losses)} "
        f"({time.perf_counter() - t0:.1f} s into the phase)")
    if not (len(epoch_losses) == epochs and np.isfinite(epoch_losses).all()
            and epoch_losses[-1] < epoch_losses[0]):
        raise AssertionError(f"TextClassifier({enc}): the loss did not "
                             f"fall: {epoch_losses}")
    # one dispatch of 2 replays profiled, and 1 eager step (a 32-step
    # dispatch of a recurrent encoder is some 400,000 kernels, past what
    # the profiler holds; an eager step of one is some 30,000 launches
    # with their host ops, whose tally takes the profiler about 10 s)
    profs = {}
    for what, net, spd in (("graph", card, 2), ("eager", eager, 1)):
        small = FeatureSet.from_ndarrays(x[:spd * B], y[:spd * B],
                                         shuffle=False).cache_device(
            shuffle_batches=False)
        net.fit(small, batch_size=B, nb_epoch=1, steps_per_dispatch=spd)
        torch.cuda.synchronize()
        profs[what] = profile_breakdown(
            lambda: net.fit(small, batch_size=B, nb_epoch=1,
                            warm_start=True),
            f"TextClassifier({enc}): {spd} training step(s) at batch {B}, "
            f"{what} (K={spd}), on {card_name}",
            top=10 if enc == "lstm" else 4)
    for what, ms, peak, n in (("graph", graph_ms, graph_peak, 2),
                              ("eager", eager_ms, eager_peak, 1)):
        prof = profs[what]
        share = prof[1] / prof[0] if prof else None
        out[what] = dict(step_ms=ms, samples_s=B * 1e3 / ms,
                         busy_share=share, peak_gib=peak / 2 ** 30)
        log(f"[zoo] TextClassifier({enc}) {what} at batch {B}: {ms:.3f} ms "
            f"a step ({B * 1e3 / ms:.1f} samples/s over an epoch of "
            f"{steps} steps), device busy "
            f"{'not measured' if share is None else f'{100 * share:.1f}%'}"
            f" of {n} profiled step(s), peak memory "
            f"{peak / 2 ** 30:.3f} GiB, "
            f"on {card_name}")
    out["epoch_losses"] = epoch_losses
    del eager
    return out


def _zoo_other(what, build, x, y, loss, rng, card_name, batch=128):
    """Predict against the CPU (1e-5 abs) and 3 training steps against the
    CPU's (1e-4 relative), dropout on with the same seeds."""
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    card, cpu = _rec_pair(build, rng, "cuda", _zoo_tree)
    want = cpu.predict(x, batch_size=batch)
    t0 = time.perf_counter()
    got = card.predict(x, batch_size=batch)
    predict_s = time.perf_counter() - t0
    err = float(np.max(np.abs(got - want)))
    n = len(y)
    log(f"[zoo] {what}: {card.param_count():,} parameters; predict "
        f"{n} rows in {1e3 * predict_s:.3f} ms on {card_name}, vs the CPU "
        f"max_abs_err={err:.3e} tol={ZOO_PREDICT_ATOL:g}")
    if err > ZOO_PREDICT_ATOL or not np.isfinite(got).all():
        raise AssertionError(f"{what}: predictions disagree with the CPU")
    fs = lambda: FeatureSet.from_ndarrays(x, y, shuffle=False)
    # SGD: Adam's first steps are m / sqrt(v), about +-lr for every
    # gradient near 0, so a last-bit difference of such a gradient between
    # two summation orders becomes a full step (VGG's third loss moved
    # 2.1e-4 under Adam in the first chip run of this phase)
    for m in (card, cpu):
        m.compile("sgd", loss)
    with _DispatchLosses() as on_card:
        card.fit(fs(), batch_size=batch, nb_epoch=1)
        torch.cuda.synchronize()
    with _DispatchLosses() as on_cpu:
        cpu.fit(fs(), batch_size=batch, nb_epoch=1)
    rel = _close(f"{what}: 3 training steps at batch {batch}, card vs CPU",
                 on_card.losses, on_cpu.losses, ZOO_LOSS_RTOL, "zoo")
    return dict(max_abs_err=err, loss_rel=rel)


def _bn_graph(card_name):
    """Conv -> BatchNorm -> relu -> GAP -> Dense at (32, 32, 3): 8 steps
    through the graph (K = 4) against 8 eager steps."""
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.keras import engine
    from analytics_zoo_tpu_torch.keras import layers as L

    def build(d):
        # no bias before the BatchNorm (it would cancel: its gradient is
        # rounding noise around 0)
        return engine.Sequential([
            L.Convolution2D(32, 3, 3, border_mode="same", bias=False,
                            input_shape=(32, 32, 3)),
            L.BatchNormalization(), L.Activation("relu"),
            L.GlobalAveragePooling2D(), L.Dense(10, activation="softmax")],
            device=d)
    rs = np.random.RandomState(0)
    x = (rs.randn(512, 32, 32, 3) * 2.0 + 0.5).astype(np.float32)
    y = rs.randint(0, 10, 512).astype(np.int32)
    engine.reset_uids()
    tree = _zoo_tree(build("cpu"), np.random.default_rng(SEED + 7))
    runs = {}
    for spd in (4, 1):
        engine.reset_uids()
        net = build("cuda")
        if net.device.type != "cuda":
            raise AssertionError(f"the Sequential's weights are on "
                                 f"{net.device}, not the card")
        net.set_weights(tree)
        net.compile("sgd", "sparse_categorical_crossentropy")
        fs = FeatureSet.from_ndarrays(x, y, shuffle=False).cache_device()
        with _DispatchLosses() as rec:
            net.fit(fs, batch_size=128, nb_epoch=2, steps_per_dispatch=spd)
            torch.cuda.synchronize()
        runs[spd] = (rec.losses, {k: v.detach().clone()
                                  for k, v in net.state_dict().items()})
    rel = _close("BatchNorm Sequential, 8 steps: graph (K=4) vs eager",
                 runs[4][0], runs[1][0], ZOO_GRAPH_RTOL, "zoo")
    worst = _weights_close("BatchNorm Sequential graph vs eager", runs[4][1],
                           runs[1][1], ZOO_GRAPH_RTOL)
    mm = runs[4][1]["batchnormalization_1.moving_mean"]
    if not bool(mm.abs().max() > 0):
        raise AssertionError("the replays left BatchNorm's moving mean at 0")
    log(f"[zoo] BatchNorm moving mean after 8 replays: max |m| "
        f"{float(mm.abs().max()):.4e} (f32: {mm.dtype}) on {card_name}")
    return dict(loss_rel=rel, weights=worst)


def phase_zoo(card_name):
    """TextClassifier at its full default width (cnn / lstm / gru) served
    and trained, the other three zoo models against the CPU, BatchNorm in
    a captured step; see the module docstring (9b)."""
    from analytics_zoo_tpu_torch.models import (
        AnomalyDetector, ImageClassifier, SessionRecommender, TextClassifier)
    from analytics_zoo_tpu_torch.ops import _kernels
    t_phase = time.perf_counter()
    _kernels.reset_launches()
    x, y = _zoo_data()
    out = {}
    for enc in ("cnn", "lstm", "gru"):
        rng = np.random.default_rng(SEED)
        build = lambda d, enc=enc: TextClassifier(encoder=enc, device=d,
                                                  **TEXT_NEWS20)
        card, cpu = _rec_pair(build, rng, "cuda", _zoo_tree)
        tree = card.get_weights()
        log(f"[zoo] TextClassifier({enc}) {TEXT_NEWS20}: "
            f"{card.param_count():,} parameters (f32, TF32 off)")
        serve = _serve_text(card, cpu, card_name, rng, enc)
        train = _train_text(card, cpu, card_name, enc, x, y, build, tree,
                            t_phase)
        out[enc] = dict(serve=serve, train=train)
        del card, cpu
        _release()
    rng = np.random.default_rng(SEED + 1)
    rs = np.random.RandomState(1)
    n = 384
    items = ZOO_SESSION["item_count"]
    sess = [rs.randint(1, items + 1, (n, 10)).astype(np.int32),
            rs.randint(1, items + 1, (n, 5)).astype(np.int32)]
    out["session"] = _zoo_other(
        f"SessionRecommender{ZOO_SESSION}",
        lambda d: SessionRecommender(device=d, **ZOO_SESSION), sess,
        rs.randint(0, items + 1, n).astype(np.int32),
        "sparse_categorical_crossentropy", rng, card_name)
    series = np.sin(np.arange(n + 24) / 6.0).astype(np.float32) \
        + 0.1 * rs.randn(n + 24).astype(np.float32)
    wx, wy = AnomalyDetector.unroll(series, 24)
    out["anomaly"] = _zoo_other(
        "AnomalyDetector(feature_shape=(24, 1))",
        lambda d: AnomalyDetector((24, 1), device=d), wx[:n], wy[:n], "mse",
        rng, card_name)
    for backbone, shape in (("lenet", (28, 28, 1)), ("vgg", (32, 32, 3)),
                            ("resnet", (32, 32, 3))):
        out[backbone] = _zoo_other(
            f"ImageClassifier(10, {shape}, {backbone!r})",
            lambda d, b=backbone, s=shape: ImageClassifier(10, s, b,
                                                           device=d),
            rs.randn(n, *shape).astype(np.float32),
            rs.randint(0, 10, n).astype(np.int32),
            "sparse_categorical_crossentropy", rng, card_name)
        _release()
    log(f"[zoo] the other models done ({time.perf_counter() - t_phase:.1f}"
        f" s into the phase)")
    out["batchnorm"] = _bn_graph(card_name)
    launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
    if any(launches.values()):
        raise AssertionError(f"the zoo path launched port kernels: "
                             f"{launches}")
    log(f"[zoo] port kernel launches in the phase: {launches} (none "
        "expected: no TPU kernel lies on the layer catalogue's path)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[zoo] phase time {out['seconds']:.1f} s on {card_name}")
    return out


def _heads_inputs(head, n, rng):
    """``n`` BERT inputs at the head's length: ragged valid lengths, the
    rest padding (id 0), ids drawn from 1000 up (the low ids are BERT's
    [unused] tokens, which the SQuAD set plants as span markers)."""
    h = HEADS[head]
    T = h["seq"]
    ids = rng.integers(1000, BERT_BASE["vocab"], (n, T)).astype(np.int32)
    lens = rng.integers(h["min_len"], T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 3)[:, None]).astype(np.int32)
    return ids * mask, seg, mask, lens


def _ner_data(n, rng):
    """Tags a fixed function of the token id (so the loss can fall), over
    every token: padding (id 0) is "O", as the JAX loss counts it."""
    ids, seg, mask, _ = _heads_inputs("ner", n, rng)
    return (ids, seg, mask), (ids % len(NER_TAGS)).astype(np.int32)


def _squad_file(n, rng, tmp):
    """``n`` SQuAD features under run_squad.py's names (int64), the answer
    span planted in the valid part and marked by tokens 1 / 2, written to a
    TFRecord file, read back and checked equal; returns the arrays as
    run_squad.py's input_fn casts them (int32)."""
    from analytics_zoo_tpu_torch.data.tfrecord import (
        build_example, examples_to_arrays, read_example_file, write_records)
    ids, seg, mask, lens = _heads_inputs("squad", n, rng)
    start = rng.integers(lens // 3, lens - 8)
    end = start + rng.integers(0, 8, n)
    ids[np.arange(n), start] = 1
    ids[np.arange(n), end] = 2
    written = [{"unique_ids": np.array([1000000000 + i], np.int64),
                "input_ids": ids[i].astype(np.int64),
                "input_mask": mask[i].astype(np.int64),
                "segment_ids": seg[i].astype(np.int64),
                "start_positions": np.array([start[i]], np.int64),
                "end_positions": np.array([end[i]], np.int64)}
               for i in range(n)]
    path = os.path.join(tmp, "train.tf_record")
    t0 = time.perf_counter()
    write_records(path, [build_example(ex) for ex in written])
    back = read_example_file(path)
    secs = time.perf_counter() - t0
    if len(back) != n or any(
            sorted(b) != sorted(SQUAD_KEYS) or any(
                b[k].dtype != np.int64 or not np.array_equal(b[k], w[k])
                for k in SQUAD_KEYS) for b, w in zip(back, written)):
        raise AssertionError("the SQuAD TFRecord file read back differs "
                             "from what was written")
    a = {k: v.astype(np.int32)
         for k, v in examples_to_arrays(back, SQUAD_KEYS).items()}
    log(f"[heads] squad: {n} features written to a TFRecord file "
        f"({os.path.getsize(path):,} bytes) and read back equal in "
        f"{1e3 * secs:.1f} ms")
    return ((a["input_ids"], a["segment_ids"], a["input_mask"]),
            [a["start_positions"][:, 0], a["end_positions"][:, 0]])


def _head_est(head, cfg, tree, mixed=False, spd=1):
    """The head's estimator on the card from the weights ``tree``:
    AdamWeightDecay at the head's learning rate."""
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.tfpark import BERTNER, BERTSQuAD
    kw = dict(bert_config=cfg,
              optimizer=AdamWeightDecay(lr=HEADS[head]["lr"]),
              mixed_precision=mixed, steps_per_dispatch=spd, device="cuda")
    est = (BERTNER(len(NER_TAGS), **kw) if head == "ner"
           else BERTSQuAD(**kw))
    return est.load_weights(tree)


def _as_list(out):
    return out if isinstance(out, list) else [out]


def _head_run(head, cfg, tmp, card_name):
    """One head at BERT-base width through its user entry points; see the
    module docstring (9c).  Returns its numbers."""
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.tfpark import BERTNER, BERTSQuAD, TFDataset
    h = HEADS[head]
    B, T, n_block = h["batch"], h["seq"], cfg["n_block"]
    n = HEADS_STEPS * B
    rng = np.random.default_rng(SEED + (11 if head == "ner" else 12))
    x, y = _ner_data(n, rng) if head == "ner" else _squad_file(n, rng, tmp)
    cpu_net = (BERTNER(len(NER_TAGS), bert_config=cfg, device="cpu")
               if head == "ner" else BERTSQuAD(bert_config=cfg,
                                               device="cpu")).net
    tree = _random_tree(cpu_net, rng)
    del cpu_net
    take = lambda t: [a[:B] for a in t] if isinstance(t, list) else t[:B]
    first = (tuple(take(list(x))), take(y))
    one_ds = TFDataset.from_ndarrays(first, batch_size=B)
    dev_ds = lambda: TFDataset.from_ndarrays((x, y), batch_size=B,
                                             memory_type="DEVICE")
    out = {}
    log(f"[heads] {head}: BERT-base {cfg}, seq {T}, batch {B}, "
        f"AdamWeightDecay(lr={h['lr']:g}), valid lengths {h['min_len']}"
        f"..{T}, {n} sequences ({HEADS_STEPS} steps an epoch) on "
        f"{card_name}")

    # launches of one forward and of one training step (eager, f32)
    est = _head_est(head, cfg, tree)
    xb = [torch.from_numpy(a).cuda() for a in first[0]]
    yb = [torch.from_numpy(a).cuda() for a in _as_list(first[1])]
    yb = yb if head == "squad" else yb[0]
    _kernels.reset_launches()
    with torch.inference_mode():
        est.net(xb)
    torch.cuda.synchronize()
    fwd = _kernels.flash_fwd.launches
    _kernels.reset_launches()
    est.train(one_ds, epochs=1, seed=SEED)
    torch.cuda.synchronize()
    step = (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches)
    log(f"[heads] {head}: one forward {fwd} flash_fwd launches; one eager "
        f"training step flash_fwd {step[0]}, flash_bwd {step[1]}")
    if fwd != n_block or step != (n_block, n_block):
        raise AssertionError(f"{head}: expected {n_block} launches a "
                             f"forward and {n_block} + {n_block} a step")

    # predictions with the kernels against plain attention (same weights)
    got = est.predict(list(x), batch_size=B)
    set_attention_backend(est.net, "plain")
    ref = est.predict(list(x), batch_size=B)
    set_attention_backend(est.net, None)
    shapes = [a.shape for a in _as_list(got)]
    want_shapes = ([(n, T, len(NER_TAGS))] if head == "ner"
                   else [(n, T)] * 2)
    err = max(float(np.max(np.abs(g - r))) for g, r in zip(
        _as_list(got), _as_list(ref)))
    scale = 1.0 if head == "ner" else max(1.0, max(
        float(np.max(np.abs(r))) for r in _as_list(ref)))
    log(f"[heads] {head}: predict {shapes} vs plain attention max_abs_err="
        f"{err:.3e} (tol {HEADS_PREDICT_ATOL:g} x {scale:.3g})")
    if shapes != want_shapes or err > HEADS_PREDICT_ATOL * scale or not all(
            np.isfinite(a).all() for a in _as_list(got)):
        raise AssertionError(f"{head}: predictions disagree with plain "
                             f"attention or have shapes {shapes}")
    est.predict(list(first[0]), batch_size=B)
    t0 = time.perf_counter()
    for _ in range(5):
        est.predict(list(first[0]), batch_size=B)
    out["predict_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    out["predict_err"] = err

    # one training step with the kernels against plain attention (f32)
    loss_k, grads_k = _step_loss_and_grads(est, xb, yb, seed=7, unused=True)
    # the same step again gives the same bits (Adam steps a gradient that
    # is 0 in exact arithmetic on its rounding noise, so noise that
    # changed from run to run made the graph-vs-eager check below vary)
    again = _step_loss_and_grads(est, xb, yb, seed=7, unused=True)[1]
    differ = sorted(nm for nm, g in grads_k.items()
                    if not torch.equal(g, again[nm]))
    log(f"[heads] {head}: one step repeated: {len(differ)} of {len(again)} "
        f"gradients differ in any bit {differ[:4]}")
    if differ:
        raise AssertionError(f"{head}: a repeated step's gradients differ")
    del again
    set_attention_backend(est.net, "plain")
    loss_p, grads_p = _step_loss_and_grads(est, xb, yb, seed=7, unused=True)
    set_attention_backend(est.net, None)
    # SQuAD's softmax runs over positions, so a parameter that adds the
    # same vector to every position's output shifts a row's start (end)
    # logits by one constant, which cancels: the head's bias and the last
    # block's LayerNorm shift (post-LN: it adds beta to every token's
    # output).  Their gradients are 0 in exact arithmetic and rounding
    # noise in both versions; they are held to that (both below
    # SHIFT_FREE_NOISE of the largest gradient), not to their own scale
    shift_free = ({nm for nm in grads_p if nm == "head.b" or nm.endswith(
        f"_block{n_block - 1}.ln2.beta")} if head == "squad" else set())
    top = max(float(g.abs().max()) for g in grads_p.values())
    noise = max((float(g.abs().max()) for nm in shift_free
                 for g in (grads_k[nm], grads_p[nm])), default=0.0)
    worst, worst_name = _worst_grad(grads_k, grads_p, shift_free)
    log(f"[heads] {head}: one step kernels vs plain attention: loss "
        f"{loss_k:.7f} vs {loss_p:.7f} (|d| {abs(loss_k - loss_p):.2e}, tol "
        f"{TRAIN_LOSS_ATOL:g}); worst gradient |d|/max|g| {worst:.2e} at "
        f"{worst_name} (tol {TRAIN_GRAD_RTOL:g})"
        + (f"; {sorted(shift_free)} (0 in exact arithmetic) max|g| "
           f"{noise:.2e} = {noise / top:.1e} of the largest gradient (tol "
           f"{SHIFT_FREE_NOISE:g})" if shift_free else ""))
    if abs(loss_k - loss_p) > TRAIN_LOSS_ATOL or worst > TRAIN_GRAD_RTOL \
            or noise > SHIFT_FREE_NOISE * top:
        raise AssertionError(f"{head}: a training step with the kernels "
                             f"disagrees with plain attention")
    out.update(step_loss_err=abs(loss_k - loss_p), step_grad_rel=worst)
    del est, grads_k, grads_p, xb, yb
    _release()

    # 8 f32 steps through the graph (K = 4) against 8 eager steps, from
    # the DEVICE tier with the same weights and dropout seed
    runs = {}
    for k in (4, 1):
        est = _head_est(head, cfg, tree, spd=k)
        _kernels.reset_launches()
        with _DispatchLosses() as rec:
            est.train(dev_ds(), epochs=1, seed=SEED)
        torch.cuda.synchronize()
        runs[k] = (rec.losses, {nm: p.detach().clone()
                                for nm, p in est.net.named_parameters()},
                   (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches))
        del est
        _release()
    out["graph_loss_rel"] = _close(
        f"{head} f32, {HEADS_STEPS} steps: graph (K=4) vs eager (K=1)",
        runs[4][0], runs[1][0], GRAPH_LOSS_RTOL, "heads")
    worst, worst_name = max((((runs[4][1][nm] - p).abs().max()
                              / p.abs().max().clamp_min(1e-30)).item(), nm)
                            for nm, p in runs[1][1].items())
    log(f"[heads] {head} ... weights: worst |d|/max|p| {worst:.3e} at "
        f"{worst_name} (tol {GRAPH_WEIGHT_RTOL:g}); launches graph "
        f"{runs[4][2]}, eager {runs[1][2]}")
    want = (HEADS_STEPS * n_block,) * 2
    if worst > GRAPH_WEIGHT_RTOL or runs[4][2] != want or runs[1][2] != want:
        raise AssertionError(f"{head}: the graph's steps differ from eager "
                             f"steps")
    out["graph_weight_rel"] = worst
    del runs
    _release()

    # the main path: mixed precision from the DEVICE tier, one dispatch an
    # epoch (K = the epoch's steps), 2 epochs; launches counted from 0
    ds = dev_ds()
    est = _head_est(head, cfg, tree, mixed=True, spd=HEADS_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    est.train(ds, epochs=2, seed=SEED)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
    no_copies("heads")
    epoch_losses = [hh["loss"] for hh in est._train_est.history]
    log(f"[heads] {head} main path (bf16, DEVICE tier, {HEADS_STEPS} steps "
        f"a dispatch, 2 epochs): epoch losses "
        f"{' '.join(f'{v:.4f}' for v in epoch_losses)}; launches {launches}")
    want = dict.fromkeys(_kernels.KERNELS, 0)
    want.update(flash_fwd=2 * HEADS_STEPS * n_block,
                flash_bwd=2 * HEADS_STEPS * n_block)
    if launches != want:
        raise AssertionError(f"{head} main path: expected {want} launches "
                             f"through the replays, got {launches}")
    if not (np.isfinite(epoch_losses).all()
            and epoch_losses[-1] < epoch_losses[0]):
        raise AssertionError(f"{head}: the loss did not fall: "
                             f"{epoch_losses}")
    out.update(launches=launches, epoch_losses=epoch_losses)
    graph_peak = torch.cuda.max_memory_allocated()
    graph_ms = (est._train_est.history[-1]["seconds"] * 1e3 / HEADS_STEPS)
    busy = profile_breakdown(lambda: est.train(ds, epochs=1, seed=SEED),
                             f"{head}: one {HEADS_STEPS}-step dispatch "
                             f"(CUDA graph replays, bf16) at batch {B}",
                             top=10)
    del est
    _release()
    est = _head_est(head, cfg, tree, mixed=True, spd=1)
    torch.cuda.reset_peak_memory_stats()
    est.train(ds, epochs=1, seed=SEED)
    est.train(ds, epochs=1, seed=SEED)
    eager_ms = est._train_est.history[-1]["seconds"] * 1e3 / HEADS_STEPS
    eager_peak = torch.cuda.max_memory_allocated()
    busy_eager = profile_breakdown(
        lambda: est.train(ds, epochs=1, seed=SEED),
        f"{head}: {HEADS_STEPS} eager steps (K=1, bf16) at batch {B}",
        top=10)
    del est, ds
    _release()
    for what, ms, peak, prof in (
            (f"graph (K={HEADS_STEPS})", graph_ms, graph_peak, busy),
            ("eager (K=1)", eager_ms, eager_peak, busy_eager)):
        out[what] = dict(step_ms=ms, samples_s=B * 1e3 / ms,
                         busy_share=prof[1] / prof[0] if prof else None,
                         peak_gib=peak / 2 ** 30)
        share = (f"{100 * prof[1] / prof[0]:.1f}%" if prof
                 else "not measured")
        log(f"[heads] {head} {what} at batch {B}, seq {T}: {ms:.3f} ms a "
            f"step ({B * 1e3 / ms:.1f} samples/s), device busy {share}, "
            f"peak memory {peak / 2 ** 30:.2f} GiB; predict "
            f"{out['predict_ms']:.3f} ms a batch of {B} (f32) on "
            f"{card_name}")
    return out


def _time_t384(card_name):
    """``flash_fwd`` and ``flash_bwd`` at SQuAD's shape, B12 H12 T384 D64
    with a ragged padding mask (valid lengths 128..384), f32 and bf16:
    checked against their plain versions, then timed beside them,
    ``scaled_dot_product_attention`` given the same mask (its backward for
    the backward) and the bound (the work of this mask's valid keys)."""
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops.attention import (
        _reference_attention_bwd, flash_attention)
    F = torch.nn.functional
    B, H, T, D = HEADS["squad"]["batch"], 12, HEADS["squad"]["seq"], 64
    gen = torch.Generator().manual_seed(SEED + 13)
    lens = torch.randint(HEADS["squad"]["min_len"], T + 1, (B,),
                         generator=gen)
    mask = (torch.arange(T)[None] < lens[:, None]).to("cuda", torch.int32)
    bool_mask = (mask != 0)[:, None, None, :]
    keys = int(lens.sum())                  # valid keys, over the batch
    rows = {"flash_fwd": {}, "flash_bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, k, v, go, _ = _bwd_inputs(dtype, B, H, T, T, D, gen)
        kernel = lambda: flash_attention(q, k, v, padding_mask=mask)
        plain = lambda: flash_attention(q, k, v, padding_mask=mask,
                                        backend="plain")
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=bool_mask)
        err = _max_err(f"flash_fwd {name} B{B} H{H} T{T} ragged mask",
                       kernel(), plain(), dtype)
        ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(sdpa)
        dev, plain_dev, lib_dev = graph_ms(kernel), graph_ms(plain), \
            graph_ms(sdpa)
        # Q read and O written over every row; K and V read over the
        # valid keys only (keys past a row's length never reach O)
        nbytes = (2 * B * T + 2 * keys) * H * D * q.element_size() \
            + mask.numel() * 4
        flops = 4 * H * T * D * keys
        bound, by, t_bytes, t_ops = _bound(nbytes, flops, dtype)
        rows["flash_fwd"][dtype] = dict(
            ms=ms, device_ms=dev, plain_ms=plain_ms,
            plain_device_ms=plain_dev, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
            max_abs_err=err, device_tflops=flops / dev / 1e9)
        log(f"[heads] flash_fwd {name:8s} B{B} H{H} T{T} D{D} ragged mask "
            f"(valid keys {keys} of {B * T}): max_abs_err={err:.3e}; eager "
            f"calls: kernel {ms:.4f} ms, plain {plain_ms:.4f}, sdpa "
            f"{lib_ms:.4f}; device (graph replay): kernel {dev:.4f} ms "
            f"({flops / dev / 1e9:.1f} TFLOP/s), plain {plain_dev:.4f}, sdpa "
            f"{lib_dev:.4f}; bound {bound:.4f} ms ({by}; bytes "
            f"{t_bytes:.4f}, operations {t_ops:.4f}) on {card_name}")
        kw = dict(causal=False, sm_scale=D ** -0.5, dropout_p=0.0, seed=None)
        o, lse = _kernel_fwd(_kernels, q, k, v, mask, **kw)
        kb = lambda: _kernel_bwd(_kernels, q, k, v, o, go, lse, mask, **kw)
        pb = lambda: _reference_attention_bwd(q, k, v, o, go, mask, False,
                                              D ** -0.5)
        err = _check_grads(f"flash_bwd {name} T{T} ragged mask", kb(), pb(),
                           dtype)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa_l = lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=bool_mask)
        sdpa_fb = lambda: torch.autograd.grad(sdpa_l(), leaves, go)
        ms = cuda_ms(kb)
        dev = graph_ms(kb)
        plain_ms = device_ms(pb)
        fb_ms, f_ms = device_ms(sdpa_fb), device_ms(sdpa_l)
        # Q, O, dO read and dQ, dK, dV written over every row (the zeros
        # past a row's length are part of dK, dV); K and V read over the
        # valid keys only
        nbytes = (6 * B * T + 2 * keys) * H * D * q.element_size() \
            + mask.numel() * 4 + lse.numel() * 4
        flops = 10 * H * T * D * keys
        bound, by, t_bytes, t_ops = _bound(nbytes, flops, dtype)
        rows["flash_bwd"][dtype] = dict(
            ms=ms, device_ms=dev, plain_ms=plain_ms,
            library_ms=fb_ms - f_ms, bound_ms=bound, bound_by=by,
            max_abs_err=err, device_tflops=flops / dev / 1e9)
        log(f"[heads] flash_bwd {name:8s} B{B} H{H} T{T} D{D} ragged mask: "
            f"max_abs_err={err:.3e} (dq, dk, dv); kernel {ms:.4f} ms (device "
            f"{dev:.4f} ms graph replay, {flops / dev / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms (device), sdpa backward "
            f"{fb_ms - f_ms:.4f} ms (device: forward+backward {fb_ms:.4f} - "
            f"forward {f_ms:.4f}), bound {bound:.4f} ms ({by}; bytes "
            f"{t_bytes:.4f}, operations {t_ops:.4f}) on {card_name}")
        del q, k, v, go, o, lse, leaves
    return rows


class _Groups:
    """Listwise ranking groups as the Ranker reads a TextSet:
    ``features[i]["sample"] = (x, labels)``, x the query's ids then a
    candidate's, one row per candidate."""

    def __init__(self, groups):
        self.features = [{"sample": g} for g in groups]


def _seq2seq_logits(model, src, tokens, start):
    """Each step's logits of a greedy decode that chose ``tokens``, fed
    back token by token (``infer``'s arithmetic)."""
    from analytics_zoo_tpu_torch.keras.layers.embedding import take_rows
    dev = model.device
    out = []
    with torch.inference_mode():
        states = model._encode(torch.from_numpy(src).to(dev))
        token = torch.full((len(src),), start, dtype=torch.int32, device=dev)
        for t in range(tokens.shape[1]):
            d = take_rows(model.dec_embed, token)
            new = []
            for cell, carry in zip(model._dec_cells, states):
                d, carry = cell._step(torch.matmul(d, cell.W), carry)
                new.append(carry)
            states = new
            out.append(model.head(d).float().cpu().numpy())
            token = torch.from_numpy(tokens[:, t].astype(np.int32)).to(dev)
    return np.stack(out, axis=1)


def _cpu_capability():
    """The vector ISA PyTorch's CPU kernels dispatch to here."""
    get = getattr(torch.backends.cpu, "get_cpu_capability", None)
    return get() if get else "ISA not reported"


def _fit_losses(net, x, y, batch, epochs=1):
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    with _DispatchLosses() as rec:
        net.fit(FeatureSet.from_ndarrays(x, y, shuffle=False),
                batch_size=batch, nb_epoch=epochs)
        if net.device.type == "cuda":
            torch.cuda.synchronize()
    return rec.losses


def _heads_cpu_models(card_name):
    """KNRM with the Ranker metrics, Seq2seq, LocalEstimator and a
    CustomLoss in ``fit``, each against the same model on the CPU; none
    launches a port kernel."""
    from analytics_zoo_tpu_torch import autograd as A
    from analytics_zoo_tpu_torch.estimator import LocalEstimator
    from analytics_zoo_tpu_torch.keras import engine
    from analytics_zoo_tpu_torch.keras import layers as L
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.models import KNRM, Seq2seq
    from analytics_zoo_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    out = {}
    rng = np.random.default_rng(SEED + 14)
    rs = np.random.RandomState(14)

    # KNRM: predictions, 3 SGD steps, NDCG@3 and MAP
    c = KNRM_CFG
    card, cpu = _rec_pair(lambda d: KNRM(device=d, **c), rng, "cuda",
                          _zoo_tree)
    n = 384
    x = {"text1": rs.randint(1, c["vocab_size"], (n, c["text1_length"])),
         "text2": rs.randint(1, c["vocab_size"], (n, c["text2_length"]))}
    x = {k: v.astype(np.int32) for k, v in x.items()}
    y = rs.randint(0, 2, n).astype(np.float32)
    want = cpu.predict(x, batch_size=128)
    card.predict(x, batch_size=128)
    t0 = time.perf_counter()
    got = card.predict(x, batch_size=128)
    ms = (time.perf_counter() - t0) * 1e3
    err = float(np.max(np.abs(got - want)))
    # the same model in float64 on the CPU: which side a high reading
    # moved (the card, or the f32 reference's reduction order)
    import copy
    cpu64 = copy.deepcopy(cpu).double()
    with torch.no_grad():
        want64 = np.concatenate([cpu64({
            k: torch.from_numpy(v[s:s + 128]) for k, v in x.items()})
            .numpy() for s in range(0, n, 128)])
    err64 = float(np.max(np.abs(got - want64)))
    ref_err = float(np.max(np.abs(want - want64)))
    del cpu64
    # the pooling's centres and widths, made on the card, are numpy's f32
    # values; the cosine matrix, the one product, is logged beside the
    # scores
    from analytics_zoo_tpu_torch.models.textmatching import _pool_consts
    K = c["kernel_num"]
    mus = np.asarray(np.linspace(-1.0 + 1.0 / K, 1.0 - 1.0 / K,
                                 K - 1).tolist() + [1.0], np.float32)
    sig = np.asarray([c["sigma"]] * (K - 1) + [c["exact_sigma"]],
                     np.float32)
    got_mus, got_denom = (t.cpu().numpy() for t in _pool_consts(
        card.device, K, c["sigma"], c["exact_sigma"]))
    if not (np.array_equal(got_mus, mus)
            and np.array_equal(got_denom, 2 * np.square(sig))):
        raise AssertionError("KNRM: the pooling constants made on the card "
                             "differ from numpy's f32 values")
    cos = [torch.einsum("bqe,bde->bqd", *(
        torch.nn.functional.normalize(m.embed.embeddings[torch.from_numpy(
            x[k][:128]).long().to(m.device)], dim=-1) for k in x)).cpu()
        for m in (card, cpu)]
    log(f"[heads] KNRM {c}: {card.param_count():,} parameters; predict "
        f"{n} pairs in {ms:.3f} ms on {card_name}, vs the CPU max_abs_err="
        f"{err:.3e} tol={HEADS_CPU_ATOL:g}; |card - f32 ref| {err:.3e}, "
        f"|card - f64 ref| {err64:.3e}, |f32 ref - f64 ref| {ref_err:.3e} "
        f"(max |score| "
        f"{float(np.max(np.abs(want))):.3g}; pooling constants equal to "
        f"numpy's; cosine matrix max |d| "
        f"{float((cos[0] - cos[1]).abs().max()):.2e}; the CPU reference on "
        f"{torch.get_num_threads()} threads, {_cpu_capability()})")
    if err > HEADS_CPU_ATOL or not np.isfinite(got).all():
        raise AssertionError("KNRM: predictions disagree with the CPU")
    groups = []
    for g in range(32):
        q = np.repeat(x["text1"][g * 8:g * 8 + 1], 8, axis=0)
        groups.append((np.concatenate([q, x["text2"][g * 8:(g + 1) * 8]],
                                      axis=1), rs.randint(0, 3, 8)))
    ts = _Groups(groups)
    ranks = {m: (net.evaluate_ndcg(ts, 3), net.evaluate_map(ts))
             for m, net in (("card", card), ("cpu", cpu))}
    log(f"[heads] KNRM ranking over 32 queries x 8 candidates: NDCG@3 / MAP"
        f" card {ranks['card']}, CPU {ranks['cpu']}")
    if ranks["card"] != ranks["cpu"]:
        raise AssertionError("KNRM: ranking metrics differ from the CPU's")
    for m in (card, cpu):
        m.compile(SGD(lr=1e-3), "mse")
    out["knrm"] = dict(max_abs_err=err, ndcg_map=ranks["card"],
                       loss_rel=_close(
                           "KNRM: 3 SGD steps at batch 128, card vs CPU",
                           _fit_losses(card, x, y, 128),
                           _fit_losses(cpu, x, y, 128),
                           HEADS_CPU_LOSS_RTOL, "heads"))
    del card, cpu
    _release()

    # Seq2seq: teacher-forced probabilities, greedy infer, 3 SGD steps
    c, T = SEQ2SEQ_CFG, SEQ2SEQ_T
    card, cpu = _rec_pair(lambda d: Seq2seq(device=d, **c), rng, "cuda",
                          _zoo_tree)
    src = rs.randint(3, c["vocab_size"], (48, T)).astype(np.int32)
    dec = np.concatenate([np.ones((48, 1), np.int32), src[:, :-1]], axis=1)
    xs = {"enc": src[:32], "dec": dec[:32]}
    err = float(np.max(np.abs(card.predict(xs, batch_size=16)
                              - cpu.predict(xs, batch_size=16))))
    toks, want = card.infer(src[:8], 1, T), cpu.infer(src[:8], 1, T)
    gap = 0.0
    if not np.array_equal(toks, want):
        logits = _seq2seq_logits(cpu, src[:8], toks, 1)
        chosen = np.take_along_axis(logits, toks[..., None], -1)[..., 0]
        gap = float(np.max(logits.max(-1) - chosen))
    same = np.array_equal(toks, want)
    log(f"[heads] Seq2seq {c}, {T} tokens in and out: probabilities vs the "
        f"CPU max_abs_err={err:.3e} tol={HEADS_CPU_ATOL:g}; infer tokens "
        + ("equal to the CPU's" if same else
           f"differ from the CPU's, worst chosen-logit gap {gap:.2e} (tol "
           f"{SEQ2SEQ_TIE_ATOL:g})"))
    if err > HEADS_CPU_ATOL or gap > SEQ2SEQ_TIE_ATOL:
        raise AssertionError("Seq2seq disagrees with the CPU")
    for m in (card, cpu):
        m.compile("sgd", "sparse_categorical_crossentropy")
    x3 = {"enc": src, "dec": dec}
    out["seq2seq"] = dict(max_abs_err=err, tie_gap=gap, loss_rel=_close(
        "Seq2seq: 3 SGD steps at batch 16, card vs CPU",
        _fit_losses(card, x3, src, 16), _fit_losses(cpu, x3, src, 16),
        HEADS_CPU_LOSS_RTOL, "heads"))
    del card, cpu
    _release()

    # LocalEstimator (3 epochs) and a CustomLoss in KerasNet.fit
    def build(d):
        engine.reset_uids()
        return engine.Sequential([L.Dense(64, activation="relu",
                                          input_shape=(32,)),
                                  L.Dense(10, activation="softmax")],
                                 device=d)
    xl = rs.randn(512, 32).astype(np.float32)
    yl = (np.abs(xl[:, :10]).argmax(1)).astype(np.int32)
    card, cpu = _rec_pair(build, rng, "cuda", _zoo_tree)
    hists = [LocalEstimator(m, "sparse_categorical_crossentropy",
                            SGD(lr=0.1)).fit((xl, yl), 64, epochs=3)
             for m in (card, cpu)]
    out["local_estimator"] = _close(
        "LocalEstimator: 3 epochs at batch 64, card vs CPU (epoch losses)",
        [h["loss"] for h in hists[0]], [h["loss"] for h in hists[1]],
        HEADS_CPU_LOSS_RTOL, "heads")
    loss = lambda: A.CustomLoss(
        lambda yt, yp: A.mean(A.square(yt - yp) + 0.01 * A.abs(yp), axis=1),
        (10,))
    yc = np.eye(10, dtype=np.float32)[yl]
    for m in (card, cpu):
        m.compile(SGD(lr=0.1), loss())
    out["custom_loss"] = _close(
        "CustomLoss in KerasNet.fit: 8 steps at batch 64, card vs CPU",
        _fit_losses(card, xl, yc, 64), _fit_losses(cpu, xl, yc, 64),
        HEADS_CPU_LOSS_RTOL, "heads")
    del card, cpu
    _release()
    launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
    log(f"[heads] port kernel launches of KNRM, Seq2seq, LocalEstimator and "
        f"CustomLoss: {launches} (none expected)")
    if any(launches.values()):
        raise AssertionError(f"the no-kernel paths launched port kernels: "
                             f"{launches}")
    return out


def phase_heads(card_name):
    """BERT NER (T 128) and SQuAD (T 384, a TFRecord feed) trained and
    served on the flash kernels at BERT-base width, the kernels timed at
    SQuAD's shape, and the heads' no-kernel modules against the CPU; see
    the module docstring (9c).  Returns (launches of each head's main
    path, the T 384 rows, numbers)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    cfg = dict(BERT_BASE, seq_len=512, hidden_drop=0.1, attn_drop=0.1)
    out = {}
    tmp = tempfile.mkdtemp(prefix="zoo_squad_")
    try:
        for head in HEADS:
            out[head] = _head_run(head, cfg, tmp, card_name)
            log(f"[heads] {head} done ({time.perf_counter() - t_phase:.1f} s"
                f" into the phase)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t384 = _time_t384(card_name)
    out["cpu_models"] = _heads_cpu_models(card_name)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[heads] phase time {out['seconds']:.1f} s on {card_name}")
    launches = {head: out[head]["launches"] for head in HEADS}
    return launches, t384, out


def _pct(ms, q):
    return float(np.percentile(np.asarray(ms), q))


def _batch_recorder(im):
    """Wrap ``im.predict_async`` (the pipelined engine's dispatch) to record
    each dispatched batch's record count, before bucket padding."""
    from analytics_zoo_tpu_torch.inference.inference_model import (
        example_x_shape0)
    sizes = []
    inner = im.predict_async

    def dispatch(x, *args, **kw):
        sizes.append(int(example_x_shape0(x)))
        return inner(x, *args, **kw)
    im.predict_async = dispatch
    return sizes


def _get(port, path):
    """One GET on the frontend: (status, body bytes)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _scrape(port) -> dict:
    """``GET /metrics`` parsed as Prometheus text (each line a comment or
    ``name{labels} value``): ``{(name, labels): value}``."""
    import re
    status, body = _get(port, "/metrics")
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? '
                        r'(-?[0-9.eE+-]+|[+-]Inf|NaN)$')
    out = {}
    for line in body.decode().splitlines():
        if line.startswith(("# HELP ", "# TYPE ")) or not line:
            continue
        m = sample.match(line)
        if status != 200 or m is None:
            raise AssertionError(f"/metrics: {status}, unparsable line "
                                 f"{line!r}")
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _moved(port, before, key, want, timeout=10.0):
    """Scrape until ``key`` has moved by ``want`` (the sink counts a record
    just after the client can read its result); returns the last scrape
    and the move."""
    deadline = time.monotonic() + timeout
    while True:
        now = _scrape(port)
        moved = now.get(key, 0.0) - before.get(key, 0.0)
        if moved >= want or time.monotonic() > deadline:
            return now, moved
        time.sleep(0.02)


def _spans_of(port, trace_id, names, timeout=10.0):
    """``/spans?trace_id=``, once the trace holds every one of ``names``."""
    deadline = time.monotonic() + timeout
    while True:
        status, body = _get(port, f"/spans?trace_id={trace_id}")
        spans = json.loads(body)["spans"]
        if status != 200:
            raise AssertionError(f"/spans: {status} {body[:200]!r}")
        if {s["name"] for s in spans} >= set(names) \
                or time.monotonic() > deadline:
            return spans
        time.sleep(0.02)


def _check_chain(spans, names, what):
    """Exactly ``names``, each the parent of the next."""
    by = {s["name"]: s for s in spans}
    if len(spans) != len(names) or set(by) != set(names):
        raise AssertionError(f"{what}: spans {[s['name'] for s in spans]}")
    if by[names[0]]["parent_id"] is not None:
        raise AssertionError(f"{what}: {names[0]} has a parent")
    for child, parent in zip(names[1:], names):
        if by[child]["parent_id"] != by[parent]["span_id"]:
            raise AssertionError(f"{what}: {child} is not under {parent}")


def _http_observed(port, scrape0, traces, n_requests, launches,
                   n_forwards, sizes, cfg):
    """After the traced HTTP burst: /metrics parses and counts every
    request and record; every request's trace holds its http.predict."""
    from analytics_zoo_tpu_torch import observability as obs
    ok_key = ("zoo_http_requests_total", '{route="/predict",code="200"}')
    rec_key = ("zoo_serving_records_total", "")
    scrape1, records = _moved(port, scrape0, rec_key, n_requests)
    answered = scrape1.get(ok_key, 0.0) - scrape0.get(ok_key, 0.0)
    fill = ("zoo_serving_batch_fill_ratio_count", "")
    dispatches = scrape1.get(fill, 0.0) - scrape0.get(fill, 0.0)
    tracer = obs.get_tracer()
    chains, predict_spans = 0, 0
    for ctx in traces.values():
        names = [s["name"] for s in tracer.export(trace_id=ctx[0])]
        predict_spans += names.count("http.predict")
        chains += {"serving.decode", "serving.dispatch",
                   "serving.sink"} <= set(names)
    log(f"[http] /metrics ({len(scrape1)} series) over the traced burst: "
        f"zoo_http_requests_total{{/predict, 200}} +{answered:g}, "
        f"zoo_serving_records_total +{records:g}, dispatches +"
        f"{dispatches:g} ({n_forwards} forwards, {len(sizes)} batches); "
        f"{n_requests} X-Zoo-Trace contexts, {predict_spans} http.predict "
        f"spans under them, {chains} carrying the engine's chain (a "
        f"coalesced entry carries its first record's trace)")
    if (answered, records) != (n_requests, n_requests):
        raise AssertionError("the registry's request / record counts "
                             "disagree with the burst")
    if predict_spans != n_requests or not chains:
        raise AssertionError("a traced request lost its spans")
    if launches != cfg["n_block"] * dispatches:
        raise AssertionError(f"{launches} flash_fwd launches for "
                             f"{dispatches} dispatches in the registry")


def _sampled_chains(port, reqs, uris):
    """Four requests one at a time (JSON, then fast-wire, in turn), each
    with its own X-Zoo-Trace: the answer echoes the trace, and its spans
    are exactly http.predict -> serving.decode -> serving.dispatch ->
    serving.sink.  Returns the answers."""
    import http.client

    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.serving.codec import (
        decode_items_bytes, encode_items_bytes)
    names = ("http.predict", "serving.decode", "serving.dispatch",
             "serving.sink")
    out = {}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        for i, uri in enumerate(uris):
            ctx = obs.new_trace_context()
            hdr = {"X-Zoo-Trace": obs.encode_trace_context(ctx),
                   "X-Zoo-Uri": f"sampled-{uri}"}
            if i % 2:
                hdr["Content-Type"] = "application/x-zoo-fastwire"
                body = encode_items_bytes(reqs[uri])
            else:
                hdr["Content-Type"] = "application/json"
                body = json.dumps({"uri": f"sampled-{uri}", "inputs": {
                    n: v.tolist() for n, v in reqs[uri].items()}})
            conn.request("POST", "/predict", body, hdr)
            resp = conn.getresponse()
            blob = resp.read()
            echo = obs.decode_trace_context(resp.headers.get("X-Zoo-Trace"))
            if resp.status != 200 or echo is None or echo[0] != ctx[0]:
                raise AssertionError(f"sampled {uri}: {resp.status}, "
                                     f"X-Zoo-Trace {ctx} -> {echo}")
            out[uri] = (decode_items_bytes(blob)["prediction"] if i % 2
                        else np.asarray(json.loads(blob)["prediction"],
                                        np.float32))
            spans = _spans_of(port, ctx[0], names)
            _check_chain(spans, names, f"sampled request {uri}")
            if spans[0]["trace_id"] != ctx[0] or not any(
                    s["span_id"] == echo[1] and s["name"] == names[0]
                    for s in spans):
                raise AssertionError(f"sampled {uri}: the echo {echo} is "
                                     f"not its http.predict span")
    finally:
        conn.close()
    log(f"[http] 4 sampled requests (2 JSON, 2 fast-wire), each alone: "
        f"X-Zoo-Trace echoed, /spans?trace_id= exactly {' -> '.join(names)}"
        f" linked parent to child")
    return out


def _obs_serving(port, broker, reqs, uris, n=8):
    """One planned ``raise`` at ``device_execute`` on the pipelined
    BERT-base engine: the batch it hits (``n`` records in one client
    batch) fails whole, the flight-recorder dump served by
    /debug/flightrecorder holds the faulted serving.dispatch with its
    injection event, and the next requests are served (their answers are
    returned, to hold against the plain attention)."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.serving.client import (
        InputQueue, OutputQueue, ServingError)
    from analytics_zoo_tpu_torch.testing import chaos
    t0 = time.perf_counter()
    rec_dir = tempfile.mkdtemp(prefix="zoo-smoke-fr-")
    obs.configure_flight_recorder(dir=rec_dir)
    iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
    names = list(reqs[uris[0]])
    try:
        inj = chaos.ChaosInjector().plan("device_execute", times=1)
        failed = []
        with chaos.installed(inj):
            iq.enqueue_batch([f"fault-{u}" for u in uris[:n]], **{
                k: np.stack([reqs[u][k] for u in uris[:n]]) for k in names})
            for u in uris[:n]:
                try:
                    oq.query_blocking(f"fault-{u}", timeout=300)
                except ServingError:
                    failed.append(u)
        status, body = _get(port, "/debug/flightrecorder")
        dumps = [d for d in json.loads(body)["dumps"]
                 if d["reason"] == "chaos"]
        if status != 200 or len(dumps) != 1:
            raise AssertionError(f"/debug/flightrecorder: {status} {body!r}")
        status, body = _get(port, "/debug/flightrecorder?name="
                            + dumps[0]["file"])
        dump = json.loads(body)
        sp = dump["active_span"] or {}
        after = {}
        for u in uris[:n]:
            iq.enqueue(f"after-{u}", **reqs[u])
        for u in uris[:n]:
            after[u] = oq.query_blocking(f"after-{u}", timeout=300)
    finally:
        obs.configure_flight_recorder()
        shutil.rmtree(rec_dir, ignore_errors=True)
    log(f"[obs] device_execute raise planned once on the pipelined "
        f"BERT-base engine: fired {inj.injected('device_execute')} of "
        f"{inj.count('device_execute')} calls, {len(failed)}/{n} records of "
        f"the client batch failed; /debug/flightrecorder: 1 chaos dump "
        f"({dump['detail']}), active span {sp.get('name')} "
        f"{sp.get('attrs')} events {[e[1] for e in sp.get('events', [])]}"
        f", {len(dump['spans'])} recent spans; the next {n} served "
        f"({time.perf_counter() - t0:.2f} s)")
    if (len(failed) != n or inj.injected("device_execute") != 1
            or inj.count("device_execute") != 1):
        raise AssertionError("the device_execute fault did not fail "
                             "exactly its batch")
    if (dump["detail"] != "device_execute:raise"
            or sp.get("name") != "serving.dispatch"
            or (sp.get("attrs") or {}).get("records") != n
            or [e[1] for e in sp.get("events", [])] != ["chaos.raise"]):
        raise AssertionError(f"the chaos dump: {dump['detail']}, {sp}")
    if any(v is None for v in after.values()):
        raise AssertionError("a request after the fault was not served")
    return after


def _http_bert(cfg, n_requests, threads):
    """BERT-base behind the pipelined ClusterServing and ServingFrontend:
    a pipelined burst through the broker, then the same requests over HTTP
    (half JSON, half fast-wire, from ``threads`` client threads), every
    answer against the plain attention on the card."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import (
        FastWireHttpClient, InputQueue, OutputQueue)
    from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    rng = np.random.default_rng(SEED)
    clf = BERTClassifier(num_classes=2, bert_config=cfg, device="cuda")
    names = ("input_ids", "token_type_ids", "input_mask")
    im = InferenceModel(device="cuda").load_keras(
        clf.net, (_random_tree(clf.net, rng), {}),
        preprocessor=lambda d: [d[n] for n in names])
    reqs = _requests(n_requests, rng, cfg)
    uris = list(reqs)
    stacked = {n: np.stack([reqs[u][n] for u in uris]) for n in names}
    im.warmup(stacked, [1, 2, 4, 8, 16, 32, 64])
    forwards = [0]
    hook = clf.net.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sizes = _batch_recorder(im)
    config = ServingConfig()
    assert config.pipeline
    broker = InMemoryBroker()
    serving = ClusterServing(im, config, broker=broker).start()
    served, lat = {}, {}
    try:
        # the pipelined engine alone: one burst through the broker
        iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
        t0 = time.perf_counter()
        for uri in uris:
            iq.enqueue(f"burst-{uri}", **reqs[uri])
        burst = {u: oq.query_blocking(f"burst-{u}", timeout=300)
                 for u in uris}
        burst_s = time.perf_counter() - t0
        burst_sizes = list(sizes)
        fe = ServingFrontend(serving, port=0).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                              timeout=300)
            conn.request("POST", "/predict", b"\x00not a frame",
                         {"Content-Type": "application/x-zoo-fastwire"})
            resp = conn.getresponse()
            bad = (resp.status, resp.read())
            conn.request("POST", "/predict", encode_items_bytes(reqs[uris[0]]),
                         {"Content-Type": "application/x-zoo-fastwire"})
            resp = conn.getresponse()
            after_bad = resp.status
            resp.read()
            conn.close()
            if bad[0] != 400 or after_bad != 200:
                raise AssertionError(f"malformed frame: {bad}, then "
                                     f"{after_bad} on the same connection")
            log(f"[http] a malformed frame: 400 {bad[1][:60]!r}; the next "
                f"request on that connection: {after_bad}")

            def client(k, tag, out, lat, traces):
                """Closed-loop requests, half JSON, half fast-wire; with
                ``traces``, each carries a fresh X-Zoo-Trace and the
                JSON answers must echo it."""
                conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                                  timeout=300)
                with FastWireHttpClient(port=fe.port, timeout=300) as fw:
                    for i in range(k, n_requests, threads):
                        uri, t = tag + uris[i], time.perf_counter()
                        ctx = None
                        if traces is not None:
                            ctx = obs.new_trace_context()
                            traces[uri] = ctx
                        wire = ctx and obs.encode_trace_context(ctx)
                        if i % 2:
                            out[uris[i]] = fw.predict(
                                uri=uri, trace_ctx=wire, **reqs[uris[i]])
                        else:
                            hdr = {"Content-Type": "application/json"}
                            if wire:
                                hdr["X-Zoo-Trace"] = wire
                            conn.request("POST", "/predict", json.dumps(
                                {"uri": uri, "inputs": {
                                    n: v.tolist()
                                    for n, v in reqs[uris[i]].items()}}),
                                hdr)
                            resp = conn.getresponse()
                            body = json.loads(resp.read())
                            if resp.status != 200 or body["uri"] != uri:
                                raise AssertionError(f"{uri}: {resp.status} "
                                                     f"{body}")
                            echo = obs.decode_trace_context(
                                resp.headers.get("X-Zoo-Trace"))
                            if ctx is not None and (
                                    echo is None or echo[0] != ctx[0]):
                                raise AssertionError(
                                    f"{uri}: X-Zoo-Trace {ctx} answered "
                                    f"with {echo}")
                            out[uris[i]] = np.asarray(body["prediction"],
                                                      np.float32)
                        lat[uri] = (time.perf_counter() - t) * 1e3
                conn.close()

            def burst_over_http(tag, out, lat, traces=None):
                t0 = time.perf_counter()
                with ThreadPoolExecutor(threads) as pool:
                    for f in [pool.submit(client, k, tag, out, lat, traces)
                              for k in range(threads)]:
                        f.result()
                return time.perf_counter() - t0

            obs.get_tracer().clear()
            scrape0 = _scrape(fe.port)
            _kernels.reset_launches()
            forwards[0] = 0
            del sizes[:]
            traces = {}
            http_s = burst_over_http("", served, lat, traces)
            torch.cuda.synchronize()
            launches, n_forwards = _kernels.flash_fwd.launches, forwards[0]
            http_sizes = list(sizes)
            no_copies("http")
            _http_observed(fe.port, scrape0, traces, n_requests,
                           launches, n_forwards, http_sizes, cfg)
            sampled = _sampled_chains(fe.port, reqs, uris[:4])
            # the same burst with observability off: the rates beside the
            # traced run's, no bar held
            obs.set_enabled(False)
            try:
                off_lat = {}
                off_s = burst_over_http("off-", {}, off_lat)
                t0 = time.perf_counter()
                for uri in uris:
                    iq.enqueue(f"off-burst-{uri}", **reqs[uri])
                for uri in uris:
                    oq.query_blocking(f"off-burst-{uri}", timeout=300)
                off_burst_s = time.perf_counter() - t0
            finally:
                obs.set_enabled(True)
            faulted = _obs_serving(fe.port, broker, reqs, uris)
        finally:
            fe.stop()
    finally:
        serving.stop()
        hook.remove()
        del im.predict_async
    metrics = serving.metrics()
    if metrics["admission"]["in_flight"] or metrics["records_shed"]:
        raise AssertionError(f"engine books after the run: {metrics}")
    log(f"[http] pipelined engine, {n_requests} requests in one burst "
        f"through the broker: {burst_s:.4f} s = "
        f"{n_requests / burst_s:.2f} req/s; dispatched batches "
        f"{burst_sizes}")
    log(f"[http] {n_requests} requests over HTTP ({threads} client threads, "
        f"half JSON, half fast-wire): {http_s:.4f} s = "
        f"{n_requests / http_s:.2f} req/s, latency p50 {_pct(list(lat.values()), 50):.3f} "
        f"ms, p99 {_pct(list(lat.values()), 99):.3f} ms; dispatched batches "
        f"{http_sizes}")
    off_lats = list(off_lat.values())
    log(f"[http] observability on / off ({card_line()}): over HTTP "
        f"{n_requests / http_s:.2f} / {n_requests / off_s:.2f} req/s, p50 "
        f"{_pct(list(lat.values()), 50):.3f} / {_pct(off_lats, 50):.3f} ms; "
        f"the pipelined burst through the broker {n_requests / burst_s:.2f}"
        f" / {n_requests / off_burst_s:.2f} req/s (one run each, no bar)")
    log(f"[http] flash_fwd launches {launches} in {n_forwards} dispatched "
        f"forwards = {launches / max(n_forwards, 1):g} per forward")
    if (n_forwards != len(http_sizes)
            or launches != cfg["n_block"] * n_forwards):
        raise AssertionError(f"expected {cfg['n_block']} flash_fwd launches "
                             f"per forward: {launches} in {n_forwards} "
                             f"forwards, {len(http_sizes)} dispatches")
    set_attention_backend(clf.net, "plain")
    try:
        want = np.concatenate([
            im.predict({n: v[s:s + 32] for n, v in stacked.items()})
            for s in range(0, n_requests, 32)])
    finally:
        set_attention_backend(clf.net, None)
    got = np.stack([np.asarray(served[u]).ravel() for u in uris])
    got_burst = np.stack([np.asarray(burst[u]).ravel() for u in uris])
    err = float(np.abs(got - want).max())
    err_burst = float(np.abs(got_burst - want).max())
    err_sampled = float(np.abs(np.stack([
        np.asarray(sampled[u]).ravel() for u in uris[:4]]) - want[:4]).max())
    err_after = float(np.abs(np.stack([
        np.asarray(faulted[u]).ravel() for u in uris[:8]]) - want[:8]).max())
    ok = (got.shape == (n_requests, 2) and np.isfinite(got).all()
          and max(err, err_burst, err_sampled, err_after) <= SERVE_ATOL)
    log(f"[http] answers vs plain attention on the card: max_abs_err "
        f"{err:.3e} over HTTP, {err_burst:.3e} through the broker, "
        f"{err_sampled:.3e} for the 4 sampled, {err_after:.3e} for the 8 "
        f"after the device_execute fault (tol {SERVE_ATOL:g}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("HTTP answers disagree with the plain path")
    return launches, dict(
        http_rps=n_requests / http_s, burst_rps=n_requests / burst_s,
        p50_ms=_pct(list(lat.values()), 50),
        p99_ms=_pct(list(lat.values()), 99), batches=http_sizes)


def _stream(fw, toks, new_tokens, uri, trace_ctx=None):
    """One streamed generation: (tokens, ms to the first frame, ms between
    frames); the frames must come one per token, in order."""
    t0 = time.perf_counter()
    stamps, tokens = [], []
    for k, tok in fw.generate(toks, uri=uri, max_new_tokens=new_tokens,
                              trace_ctx=trace_ctx):
        stamps.append(time.perf_counter())
        if k != len(tokens):
            raise AssertionError(f"{uri}: frame {k} after {len(tokens)}")
        tokens.append(tok)
    gaps = np.diff(stamps) * 1e3
    return tokens, (stamps[0] - t0) * 1e3, gaps.tolist()


def _llm_observed(port, eng, scrape0, traces, sampled, n_tokens,
                  new_tokens):
    """After the traced streams: two streams' traces are http.generate ->
    llm.prefill with one llm.token event per token; /metrics counts the
    tokens; /debug/memory's kv_blocks books equal the blocks held and sit
    within what the allocator holds, and its device section within the
    card's memory."""
    from analytics_zoo_tpu_torch import observability as obs
    tracer = obs.get_tracer()
    for uri in sampled:
        tid = traces[uri][0]
        spans = _spans_of(port, tid, ("http.generate", "llm.prefill"))
        gen = [s for s in spans if s["name"] == "http.generate"]
        pre = [s for s in spans if s["name"] == "llm.prefill"]
        tokens = [e for e in tracer.export_events(trace_id=tid)
                  if e["kind"] == "llm.token"]
        log(f"[http] stream {uri}: spans {[s['name'] for s in spans]}, "
            f"{len(tokens)} llm.token events")
        if (len(gen) != 1 or not pre or len(spans) != 1 + len(pre)
                or any(s["parent_id"] != gen[0]["span_id"] for s in pre)
                or [e["attrs"]["idx"] for e in tokens]
                != list(range(new_tokens))):
            raise AssertionError(f"stream {uri}: spans {spans}, "
                                 f"{len(tokens)} token events")
    key = ("zoo_llm_tokens_total", "")
    _, moved = _moved(port, scrape0, key, n_tokens)
    status, body = _get(port, "/debug/memory?topk=4")
    mem = json.loads(body)
    pool = mem["pools"]["kv_blocks"]
    devs = mem["devices"]
    allocated = torch.cuda.memory_allocated()
    held = eng.cache.pool.blocks_in_use
    log(f"[http] /metrics: zoo_llm_tokens_total +{moved:g} for {n_tokens} "
        f"streamed tokens; /debug/memory kv_blocks: {pool['blocks']} blocks"
        f" ({held} held by the pool) x {eng.cache.block_bytes:,} B = "
        f"{pool['used_bytes']:,} B used of {pool['capacity_bytes']:,} B, "
        f"owners {pool['owners']}; torch.cuda.memory_allocated "
        f"{allocated:,} B; devices {devs}")
    if moved != n_tokens:
        raise AssertionError(f"zoo_llm_tokens_total moved {moved}, "
                             f"{n_tokens} tokens were streamed")
    if (status != 200 or pool["blocks"] != held
            or pool["used_bytes"] != held * eng.cache.block_bytes
            or pool["used_bytes"] > allocated):
        raise AssertionError(f"/debug/memory kv_blocks: {pool}")
    if not devs or any(d["bytes_in_use"] > d["bytes_limit"] for d in devs):
        raise AssertionError(f"/debug/memory devices: {devs}")


def _obs_llm(eng, reqs, uris, new_tokens):
    """One planned ``raise`` at ``decode_step`` while ``len(uris)``
    sequences decode: each finishes with ``error``; then no table is
    left, the ledger's sweep reads clean and a new request is served."""
    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.llm import GenerationClient
    from analytics_zoo_tpu_torch.serving.client import ServingError
    from analytics_zoo_tpu_torch.testing import chaos
    t0 = time.perf_counter()
    cli = GenerationClient(broker=eng.broker)
    streams = {}
    for u in uris:
        cli.submit(f"obs-{u}", reqs[u], new_tokens)
        streams[u] = cli.stream_tokens(f"obs-{u}", timeout=300)
    for s in streams.values():
        next(s)                       # every sequence is decoding
    inj = chaos.ChaosInjector().plan("decode_step", times=1)
    errors = 0
    with chaos.installed(inj):
        for s in streams.values():
            try:
                for _ in s:
                    pass
            except ServingError:
                errors += 1
    _wait_idle(eng)
    leak = eng.cache.leak_check()
    sweep = obs.get_memory_ledger().reconcile_once()
    after = cli.generate("obs-after", reqs[uris[0]], 4, timeout=300)
    log(f"[obs] decode_step raise planned once with {len(uris)} sequences "
        f"decoding: fired {inj.injected('decode_step')}, {errors}/"
        f"{len(uris)} finished with an error; after: {leak}, the ledger's "
        f"sweep {sweep or 'clean'}; the next request served "
        f"{len(after)} tokens ({time.perf_counter() - t0:.2f} s)")
    if inj.injected("decode_step") != 1 or errors != len(uris):
        raise AssertionError("the decode_step fault did not error its "
                             "step's sequences")
    if leak["tables"] or leak["held_blocks"] or sweep or len(after) != 4:
        raise AssertionError(f"after the decode_step fault: {leak}, "
                             f"{sweep}, {after}")


def _http_llm(n_requests, new_tokens, threads):
    """The GPT-2-small-width decoder LM behind ServingFrontend(llm=): the
    same prompts through the broker and over HTTP, from ``threads`` client
    threads each."""
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch import interop
    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.common.config import LLMServingConfig
    from analytics_zoo_tpu_torch.llm import GenerationClient, LLMServing
    from analytics_zoo_tpu_torch.models.generation import DecoderLM
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import (
        FastWireHttpClient, ServingDeadlineError)
    from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend

    cfg = GPT2_SMALL
    n_layers = cfg["n_layers"]
    rng = np.random.default_rng(SEED)
    model = DecoderLM(**cfg, device="cuda")
    interop.load_jax_params(model, _random_tree(model, rng))
    eng = LLMServing(model, LLMServingConfig(
        max_active=32, block_size=16, num_blocks=2048, max_model_len=1024,
        prefill_chunk_tokens=256, prefix_cache=True),
        broker=InMemoryBroker()).start()
    reqs = _llm_requests(n_requests, rng, cfg["vocab"])
    uris = list(reqs)
    calls = {"decode": 0, "prefill_chunk": 0}
    traces = {}

    def counted(name):
        inner = getattr(model, name)

        def call(*args):
            calls[name] += 1
            return inner(*args)
        return call

    def broker_client(k, out, ttft):
        cli = GenerationClient(broker=eng.broker)
        for i in range(k, n_requests, threads):
            uri = uris[i]
            t0 = time.perf_counter()
            cli.submit(f"b-{uri}", reqs[uri], new_tokens)
            toks = []
            for _, tok in cli.stream_tokens(f"b-{uri}", timeout=300):
                if not toks:
                    ttft[uri] = (time.perf_counter() - t0) * 1e3
                toks.append(tok)
            out[uri] = toks

    def http_client(k, out, ttft, itl, port):
        with FastWireHttpClient(port=port, timeout=300) as fw:
            for i in range(k, n_requests, threads):
                uri = uris[i]
                traces[uri] = obs.new_trace_context()
                out[uri], ttft[uri], gaps = _stream(
                    fw, reqs[uri], new_tokens, uri,
                    obs.encode_trace_context(traces[uri]))
                itl.extend(gaps)

    def run(fn, *args):
        with ThreadPoolExecutor(threads) as pool:
            for f in [pool.submit(fn, k, *args) for k in range(threads)]:
                f.result()

    fe = None
    try:
        cli = GenerationClient(broker=eng.broker)
        cli.generate("warmup", rng.integers(0, cfg["vocab"], 40), 4,
                     timeout=300)
        via_broker, broker_ttft = {}, {}
        run(broker_client, via_broker, broker_ttft)
        _wait_idle(eng)
        fe = ServingFrontend(llm=eng, port=0).start()
        via_http, http_ttft, itl = {}, {}, []
        model.decode = counted("decode")
        model.prefill_chunk = counted("prefill_chunk")
        obs.get_tracer().clear()
        scrape0 = _scrape(fe.port)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        run(http_client, via_http, http_ttft, itl, fe.port)
        http_s = time.perf_counter() - t0
        _wait_idle(eng)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
        n_calls = dict(calls)
        no_copies("http")
        for name in calls:
            model.__dict__.pop(name, None)
        _llm_observed(fe.port, eng, scrape0, traces, uris[:2],
                      n_requests * new_tokens, new_tokens)
        _obs_llm(eng, reqs, uris[:4], new_tokens)
        # a deadline too short for the first token: 504, then the same
        # client serves the next request
        with FastWireHttpClient(port=fe.port, timeout=300) as fw:
            try:
                list(fw.generate(reqs[uris[0]], max_new_tokens=new_tokens,
                                 deadline_ms=1))
                raise AssertionError("a 1 ms deadline was served")
            except ServingDeadlineError as exc:
                log(f"[http] deadline_ms=1: {type(exc).__name__}: {exc}")
            again, _, _ = _stream(fw, reqs[uris[1]], new_tokens, "again")
        _wait_idle(eng)
        leak = eng.cache.leak_check()
    finally:
        for name in calls:
            model.__dict__.pop(name, None)
        if fe is not None:
            fe.stop()
        eng.stop()
    differ = [u for u in uris if via_http[u] != via_broker[u]
              or len(via_http[u]) != new_tokens]
    log(f"[http] {n_requests} streamed generations ({threads} client "
        f"threads, {new_tokens} new tokens each, prompts "
        f"{min(map(len, reqs.values()))}..{max(map(len, reqs.values()))} "
        f"tokens, half behind one 256-token prefix): "
        f"{n_requests - len(differ)}/{n_requests} equal the broker path's "
        f"tokens, in {http_s:.4f} s = "
        f"{n_requests * new_tokens / http_s:.2f} tokens/s")
    log(f"[http] TTFT over HTTP p50 {_pct(list(http_ttft.values()), 50):.3f} "
        f"ms, p99 {_pct(list(http_ttft.values()), 99):.3f} ms; through the "
        f"broker p50 {_pct(list(broker_ttft.values()), 50):.3f} ms, p99 "
        f"{_pct(list(broker_ttft.values()), 99):.3f} ms; mean inter-token "
        f"latency over HTTP {float(np.mean(itl)):.3f} ms")
    log(f"[http] launches {launches}: paged_decode "
        f"{launches['paged_decode'] / max(n_calls['decode'], 1):g} per "
        f"decode call ({n_calls['decode']}), paged_chunk "
        f"{launches['paged_chunk'] / max(n_calls['prefill_chunk'], 1):g} per "
        f"prefill chunk ({n_calls['prefill_chunk']}); after the phase "
        f"{leak}")
    if differ:
        raise AssertionError(f"HTTP streams differ from the broker path: "
                             f"{differ}")
    if again != via_broker[uris[1]]:
        raise AssertionError("the request after the deadline case differs")
    if (not n_calls["decode"] or not n_calls["prefill_chunk"]
            or launches["paged_decode"] != n_layers * n_calls["decode"]
            or launches["paged_chunk"]
            != n_layers * n_calls["prefill_chunk"]):
        raise AssertionError(f"expected {n_layers} launches per call: "
                             f"{launches} for {n_calls}")
    if leak["tables"] or leak["held_blocks"]:
        raise AssertionError(f"live tables after the phase: {leak}")
    return launches, dict(
        tokens_per_s=n_requests * new_tokens / http_s,
        ttft_p50_ms=_pct(list(http_ttft.values()), 50),
        ttft_p99_ms=_pct(list(http_ttft.values()), 99),
        broker_ttft_p50_ms=_pct(list(broker_ttft.values()), 50),
        itl_ms=float(np.mean(itl)), calls=n_calls)


def phase_http(n_requests=64, n_streams=16, new_tokens=32, threads=4):
    """The pipelined engine and the HTTP frontend on the card: BERT-base
    one-shot, the GPT-2-small-width decoder LM streaming."""
    bert_launches, bert = _http_bert(BERT_BASE, n_requests, threads)
    llm_launches, llm = _http_llm(n_streams, new_tokens, threads)
    return {"flash_fwd": bert_launches,
            "paged_decode": llm_launches["paged_decode"],
            "paged_chunk": llm_launches["paged_chunk"]}, bert, llm


# ---------------------------------------------------------------- ingest
class _SquadRecords(torch.nn.Module):
    """BERTSQuAD's net over a batch as the shards hold it: a dict of
    ``run_squad.py``'s feature columns in (``unique_ids`` unused), the
    net's ``[start, end]`` logits out."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, seed=None):
        return self.net([x["input_ids"], x["segment_ids"], x["input_mask"]],
                        seed=seed)


def _squad_record_loss(preds, labels):
    """The SQuAD loss over the shards' label columns ((B, 1) each)."""
    from analytics_zoo_tpu_torch.tfpark.text_estimators import _squad_loss
    return _squad_loss(preds, [labels["start_positions"],
                               labels["end_positions"]])


def _squad_shards(rng, tmp):
    """``INGEST['features']`` SQuAD features made as the heads phase makes
    them (the answer span planted in the ragged valid part), under
    ``run_squad.py``'s names as int64, written in order as
    ``INGEST['shards']`` TFRecord shards; returns the paths and the
    columns."""
    from analytics_zoo_tpu_torch.data.tfrecord import (build_example,
                                                       write_records)
    n, k = INGEST["features"], INGEST["shards"]
    ids, seg, mask, lens = _heads_inputs("squad", n, rng)
    start = rng.integers(lens // 3, lens - 8)
    end = start + rng.integers(0, 8, n)
    ids[np.arange(n), start] = 1
    ids[np.arange(n), end] = 2
    cols = {"unique_ids": 1000000000 + np.arange(n)[:, None],
            "input_ids": ids, "input_mask": mask, "segment_ids": seg,
            "start_positions": start[:, None], "end_positions": end[:, None]}
    cols = {c: np.asarray(v, np.int64) for c, v in cols.items()}
    per, paths = n // k, []
    for s in range(k):
        path = os.path.join(tmp, f"train-{s:05d}-of-{k:05d}.tf_record")
        write_records(path, [build_example({c: v[i] for c, v in cols.items()})
                             for i in range(s * per, (s + 1) * per)])
        paths.append(path)
    return paths, cols


SQUAD_FEATURES = ["unique_ids", "input_ids", "segment_ids", "input_mask"]
SQUAD_LABELS = ["start_positions", "end_positions"]


def _squad_set(paths, shuffle=True, fuse=True):
    from analytics_zoo_tpu_torch.data import ShardedFeatureSet, Transforms
    tf = Transforms(fuse=fuse)
    for field in SQUAD_FEATURES[1:]:
        tf = tf.cast("int32", field=field)
    return ShardedFeatureSet(paths, feature_keys=SQUAD_FEATURES,
                             label_keys=SQUAD_LABELS, shuffle=shuffle,
                             seed=0, window_shards=INGEST["window"],
                             transforms=tf)


class _SeenIds:
    """Records the ``unique_ids`` of every batch a sharded set hands the
    estimator (device tensors, read after the run)."""

    def __init__(self, fs):
        self.batches = []
        orig = fs.batches

        def spy(*a, **kw):
            for x, y in orig(*a, **kw):
                self.batches.append(x["unique_ids"])
                yield x, y
        fs.batches = spy

    def epochs(self, steps):
        ids = [b.reshape(-1).cpu().numpy() for b in self.batches]
        return [np.concatenate(ids[e * steps:(e + 1) * steps])
                for e in range(len(ids) // steps)]


def _squad_est(net, tree, ckdir=None, trigger=None):
    """A fresh estimator at the ingest configuration over ``net``, its
    weights reset to ``tree``."""
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    net.set_weights(tree)
    return Estimator(_SquadRecords(net),
                     AdamWeightDecay(lr=HEADS["squad"]["lr"]),
                     _squad_record_loss, mixed_precision=True,
                     steps_per_dispatch=INGEST["spd"], checkpoint_dir=ckdir,
                     checkpoint_trigger=trigger, device="cuda")


def _squad_train(net, tree, fs, ckdir=None, trigger=None, inj=None,
                 **train_kw):
    """One SQuAD run from ``fs`` at the ingest configuration, from the
    weights ``tree``; returns (per-step losses, weights, the estimator's
    history)."""
    from analytics_zoo_tpu_torch.testing import chaos
    est = _squad_est(net, tree, ckdir, trigger)
    with _DispatchLosses() as rec, chaos.installed(
            inj or chaos.ChaosInjector()):
        est.train(fs, HEADS["squad"]["batch"], epochs=INGEST["epochs"],
                  seed=SEED, **train_kw)
    torch.cuda.synchronize()
    weights = {n: p.detach().clone() for n, p in net.named_parameters()}
    history = list(est.history)
    del est
    _release()
    return rec.losses, weights, history


def _same_run(what, got, want):
    """Two runs' per-step losses and final weights, held to 0 difference."""
    dl = max((abs(a - b) for a, b in zip(got[0], want[0])),
             default=float("inf"))
    dw = max(float((got[1][n] - w).abs().max()) for n, w in want[1].items())
    ok = len(got[0]) == len(want[0]) and dl == 0.0 and dw == 0.0
    log(f"[ingest] {what}: {len(got[0])} vs {len(want[0])} steps, losses "
        f"max |d| {dl:.3e}, weights max |d| {dw:.3e} (held to 0) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the runs differ")


def _shard_reads():
    from analytics_zoo_tpu_torch import observability as obs
    series = obs.get_registry().snapshot().get(
        "zoo_data_shards_read_total", {}).get("series", {})
    return {src: series.get((("source", src),), 0.0)
            for src in ("decode", "stage")}


def _counter_total(name):
    from analytics_zoo_tpu_torch import observability as obs
    return sum(obs.get_registry().snapshot().get(name, {}).get(
        "series", {}).values())


def _pageable_h2d(fn):
    """``fn`` under the profiler: (wall ms, device busy ms, names of the
    host-to-device copies from pageable memory)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    pageable = sorted({e.name for e in prof.events()
                       if "HtoD" in e.name and "Pageable" in e.name})
    copies = sorted({e.name for e in prof.events() if "Memcpy" in e.name})
    return wall, busy, pageable, copies


def _ingest_squad(card_name, heads):
    """SQuAD from TFRecord shards; see the module docstring (11)."""
    import shutil
    import tempfile
    from analytics_zoo_tpu_torch.common.triggers import (MaxIteration,
                                                         SeveralIteration)
    from analytics_zoo_tpu_torch.data import FeatureSet
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.testing import chaos
    from analytics_zoo_tpu_torch.tfpark import BERTSQuAD
    cfg = dict(BERT_BASE, seq_len=512, hidden_drop=0.1, attn_drop=0.1)
    B, n_block = HEADS["squad"]["batch"], cfg["n_block"]
    steps = INGEST["features"] // B
    rng = np.random.default_rng(SEED + 12)
    tmp = tempfile.mkdtemp(prefix="zoo_ingest_")
    out = {}
    try:
        paths, cols = _squad_shards(rng, tmp)
        net = BERTSQuAD(bert_config=cfg, device="cuda").net
        tree = _random_tree(net, rng)
        log(f"[ingest] squad: {INGEST['features']} features in "
            f"{len(paths)} TFRecord shards, ShardedFeatureSet(shuffle=True,"
            f" seed=0, window_shards={INGEST['window']}), int32 casts of "
            f"the id fields fused into the step; BERT-base seq "
            f"{HEADS['squad']['seq']}, batch {B}, bf16, "
            f"{INGEST['spd']} steps a dispatch, {INGEST['epochs']} epochs "
            f"of {steps} steps on {card_name}")

        # A: the main path, launches, shard reads and data wait per epoch
        fs = _squad_set(paths)
        fs.evict()      # the probe's staged shard: epoch 0 reads every file
        from analytics_zoo_tpu_torch.native import NativeSampleCache
        if fs._stage is None or not isinstance(fs._stage.cache,
                                               NativeSampleCache):
            raise AssertionError("ingest: the shards do not stage through "
                                 "the native sample cache")
        log(f"[ingest] the stage store is native: NativeSampleCache "
            f"({fs._stage.capacity:,} B of DRAM before the disk spill)")
        seen = _SeenIds(fs)
        reads, waits = [], []
        from analytics_zoo_tpu_torch.estimator import estimator as est_mod
        orig_epoch = est_mod.Estimator._run_epoch

        def at_epoch(est, *a, **kw):
            reads.append(_shard_reads())
            waits.append(_counter_total("zoo_train_data_wait_seconds_total"))
            return orig_epoch(est, *a, **kw)
        est_mod.Estimator._run_epoch = at_epoch
        _kernels.reset_launches()
        try:
            main = _squad_train(net, tree, fs)
        finally:
            est_mod.Estimator._run_epoch = orig_epoch
        reads.append(_shard_reads())
        # the warm epoch's wait (epoch 0 decodes every file)
        waited = _counter_total("zoo_train_data_wait_seconds_total") \
            - waits[-1]
        launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
        no_copies("ingest")
        want = dict.fromkeys(_kernels.KERNELS, 0)
        want.update(flash_fwd=INGEST["epochs"] * steps * n_block,
                    flash_bwd=INGEST["epochs"] * steps * n_block)
        per_epoch = [{s: reads[e + 1][s] - reads[e][s] for s in reads[e]}
                     for e in range(len(reads) - 1)]
        losses = [h["loss"] for h in main[2]]
        log(f"[ingest] squad main path: epoch losses "
            f"{' '.join(f'{v:.4f}' for v in losses)}; launches {launches}; "
            f"zoo_data_shards_read_total per epoch {per_epoch}")
        if launches != want:
            raise AssertionError(f"ingest: expected {want} launches through"
                                 f" the replays, got {launches}")
        if per_epoch != [{"decode": 8.0, "stage": 0.0},
                         {"decode": 0.0, "stage": 8.0}]:
            raise AssertionError(f"ingest: shard reads per epoch "
                                 f"{per_epoch}, expected 8 decoded in epoch"
                                 f" 0 and 8 staged in epoch 1")
        ids = seen.epochs(steps)
        every = np.sort(cols["unique_ids"][:, 0])
        if len(ids) != INGEST["epochs"] or any(
                not np.array_equal(np.sort(e), every) for e in ids):
            raise AssertionError("ingest: an epoch did not see every "
                                 "feature exactly once")
        log(f"[ingest] squad: each of {len(ids)} epochs saw all "
            f"{len(every)} unique_ids exactly once")
        step_ms = main[2][-1]["seconds"] * 1e3 / steps
        out.update(launches=launches, shard_reads=per_epoch,
                   epoch_losses=losses)

        # B: the chain applied on the host instead of in the step
        _same_run("fuse=False against fuse=True",
                  _squad_train(net, tree, _squad_set(paths, fuse=False)),
                  main)

        # C: stop after dispatch 2 of epoch 1, resume in a new estimator
        ck = os.path.join(tmp, "ck")
        fs_c = _squad_set(paths)
        seen_c = _SeenIds(fs_c)
        first = _squad_train(net, tree, fs_c, ckdir=ck,
                             trigger=SeveralIteration(2 * INGEST["spd"]),
                             end_trigger=MaxIteration(steps + steps // 2))
        rest = _squad_train(net, tree, fs_c, ckdir=ck, resume=True)
        _same_run(f"stopped at step {steps + steps // 2} and resumed "
                  f"against the uninterrupted run",
                  (first[0] + rest[0], rest[1]), main)
        resumed = [b.reshape(-1).cpu().numpy() for b in seen_c.batches]
        epoch1 = np.concatenate(resumed[steps:])
        if len(resumed) != 2 * steps or not np.array_equal(
                np.sort(epoch1), every):
            raise AssertionError("ingest: the resumed epoch dropped or "
                                 "repeated a feature")
        log(f"[ingest] squad: the interrupted epoch saw all {len(every)} "
            "unique_ids exactly once across the restart")

        # D: one planned shard_read raise in epoch 1, retried
        inj = chaos.ChaosInjector()
        inj.plan("shard_read", fault="raise", at=[len(paths) + 4])
        fault = _squad_train(net, tree, _squad_set(paths),
                             ckdir=os.path.join(tmp, "ck_fault"),
                             trigger=SeveralIteration(2 * INGEST["spd"]),
                             inj=inj)
        stranded = [t.name for t in __import__("threading").enumerate()
                    if t.name.startswith("zoo-data")]
        log(f"[ingest] squad: {inj.injected('shard_read')} planned "
            f"shard_read raise in epoch 1, retried from the latest "
            f"checkpoint; zoo-data threads left: {stranded}")
        if inj.injected("shard_read") != 1 or stranded:
            raise AssertionError("ingest: the shard_read fault was not "
                                 "injected once, or left a thread")
        # the steps after the restored checkpoint re-run: the last 8
        # always do (the fault lies before them)
        _same_run("a shard_read fault retried against the fault-free run",
                  (fault[0][-8:], fault[1]), (main[0][-8:], main[1]))

        # E: shuffle=False shards against the DEVICE tier of the same
        # records in the same order
        ordered = _squad_train(net, tree, _squad_set(paths, shuffle=False))
        x = {c: cols[c].astype(np.int32) if c in SQUAD_FEATURES[1:]
             else cols[c] for c in SQUAD_FEATURES}
        y = {c: cols[c] for c in SQUAD_LABELS}
        dev = FeatureSet(x, y, shuffle=False).cache_device(
            shuffle_batches=False)
        _same_run("shuffle=False shards against the DEVICE tier",
                  _squad_train(net, tree, dev), ordered)

        # F: one profiled epoch of the sharded run
        est = _squad_est(net, tree)
        fs_f = _squad_set(paths)
        est.train(fs_f, B, epochs=1, seed=SEED)
        wall, busy, pageable, copies = _pageable_h2d(
            lambda: est.train(fs_f, B, epochs=1, seed=SEED))
        del est, net
        _release()
        log(f"[ingest] squad: one profiled epoch ({steps} steps, "
            f"{steps // INGEST['spd']} dispatches): wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); copies "
            f"{copies}; pageable host-to-device copies {pageable}")
        if pageable:
            raise AssertionError(f"ingest: pageable host-to-device copies "
                                 f"in the sharded run: {pageable}")
        dev_step = heads["squad"][f"graph (K={HEADS_STEPS})"]["step_ms"]
        out.update(step_ms=step_ms, samples_s=B * 1e3 / step_ms,
                   data_wait_ms=waited * 1e3 / steps,
                   busy_share=busy / wall, device_tier_step_ms=dev_step)
        log(f"[ingest] squad from shards (graph, K={INGEST['spd']}): "
            f"{step_ms:.3f} ms a step ({B * 1e3 / step_ms:.1f} samples/s), "
            f"data wait {out['data_wait_ms']:.3f} ms a step (the warm "
            f"epoch), device busy "
            f"{100 * busy / wall:.1f}%; the heads phase's DEVICE-tier SQuAD "
            f"step (K={HEADS_STEPS}): {dev_step:.3f} ms on {card_name}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _ingest_ncf(card_name):
    """NeuralCF from .npz shards in three legs; see the module docstring
    (11)."""
    import shutil
    import tempfile
    from analytics_zoo_tpu_torch.data import (ShardedFeatureSet, Transforms,
                                              write_npz_shards)
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.keras import engine
    from analytics_zoo_tpu_torch.models import NeuralCF
    n, B = INGEST_NCF["records"], INGEST_NCF["batch"]
    rs = np.random.RandomState(0)
    users = rs.randint(1, NCF_ML1M["user_count"] + 1, (n, 1)).astype(np.int64)
    items = rs.randint(1, NCF_ML1M["item_count"] + 1, (n, 1)).astype(np.int64)
    labels = rs.randint(0, 2, n).astype(np.int32)
    engine.reset_uids()
    tree = _keras_tree(NeuralCF(device="cpu", **NCF_ML1M),
                       np.random.default_rng(SEED))
    tmp = tempfile.mkdtemp(prefix="zoo_ingest_ncf_")
    out, weights = {}, {}
    try:
        t0 = time.perf_counter()
        paths = write_npz_shards(tmp, (users, items), labels,
                                 INGEST_NCF["shards"])
        log(f"[ingest] ncf: {n:,} records (MovieLens-1M's ratings) in "
            f"{len(paths)} .npz shards written in "
            f"{time.perf_counter() - t0:.2f} s; NeuralCF {NCF_ML1M}, batch "
            f"{B}, {INGEST_NCF['epochs']} epochs")
        for leg, prefetch, stage, fuse in (("eager", 0, False, False),
                                           ("prefetch", 2, True, False),
                                           ("fused", 2, True, True)):
            tf = (Transforms(fuse=fuse).cast("int32", field=0)
                  .cast("int32", field=1))
            fs = ShardedFeatureSet(paths, shuffle=True, seed=0,
                                   transforms=tf, prefetch=prefetch,
                                   stage_cache=stage)
            engine.reset_uids()
            net = NeuralCF(device="cuda", **NCF_ML1M)
            net.set_weights(tree)
            est = Estimator(net, "adam", "sparse_categorical_crossentropy",
                            device="cuda")
            est.train(fs, B, epochs=1, seed=SEED)      # the cold epoch
            torch.cuda.synchronize()
            w0 = _counter_total("zoo_train_data_wait_seconds_total")
            t0 = time.perf_counter()
            est.train(fs, B, epochs=INGEST_NCF["epochs"] - 1, seed=SEED)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            warm_steps = (INGEST_NCF["epochs"] - 1) * fs.steps_per_epoch(B)
            wait = _counter_total("zoo_train_data_wait_seconds_total") - w0
            out[leg] = dict(samples_s=warm_steps * B / secs,
                            data_wait_ms=wait * 1e3 / warm_steps)
            weights[leg] = {k: v.detach().clone()
                            for k, v in net.state_dict().items()}
            log(f"[ingest] ncf {leg} (prefetch {prefetch}, staging "
                f"{stage}, fuse {fuse}): warm epochs "
                f"{out[leg]['samples_s']:,.0f} samples/s, data wait "
                f"{out[leg]['data_wait_ms']:.3f} ms a step on {card_name}")
            del est, net, fs
            _release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for leg in ("prefetch", "fused"):
        d = max(float((weights[leg][k] - w).abs().max())
                for k, w in weights["eager"].items())
        log(f"[ingest] ncf {leg} against eager: weights max |d| {d:.3e} "
            f"(held to 0) -> {'ok' if d == 0.0 else 'FAIL'}")
        if d != 0.0:
            raise AssertionError(f"ingest: the ncf {leg} leg's weights "
                                 f"differ from eager")
    return out


def phase_ingest(card_name, heads):
    """The sharded ingest path; see the module docstring (11)."""
    t_phase = time.perf_counter()
    out = {"squad": _ingest_squad(card_name, heads)}
    out["ncf"] = _ingest_ncf(card_name)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[ingest] phase time {out['seconds']:.1f} s on {card_name}")
    return out


# ------------------------------------------------------------ multimodel
def _mm_models(cfg):
    """(name -> InferenceModel, references) for the multimodel phase:
    bert_a loaded on the card (pinned), the others staged on the host."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras import engine
    from analytics_zoo_tpu_torch.models import NeuralCF, TextClassifier
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    names = ("input_ids", "token_type_ids", "input_mask")
    pre = lambda d: [d[n] for n in names]
    a = BERTClassifier(2, bert_config=cfg, device="cuda").net
    a_tree = _random_tree(a, np.random.default_rng(SEED))
    im_a = InferenceModel(device="cuda").load_keras(a, (a_tree, {}),
                                                    preprocessor=pre)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    b = BERTClassifier(2, bert_config=cfg, device="cpu").net
    b_tree = _random_tree(b, np.random.default_rng(SEED + 1))
    engine.reset_uids()
    ncf = NeuralCF(device="cpu", **NCF_ML1M)
    ncf_tree = _keras_tree(ncf, np.random.default_rng(SEED))
    ncf.set_weights(ncf_tree)
    engine.reset_uids()
    text = TextClassifier(encoder="cnn", device="cpu", **TEXT_NEWS20)
    text_tree = _zoo_tree(text, np.random.default_rng(SEED))
    text.set_weights(text_tree)
    cold = lambda: InferenceModel(place_on_load=False, device="cuda")
    ims = {"bert_a": im_a,
           "bert_b": cold().load_keras(b, (b_tree, {}), preprocessor=pre),
           "ncf": cold().load_keras(ncf),
           "textcnn": cold().load_keras(text)}
    torch.cuda.synchronize()
    trees = {"bert_b": b_tree, "ncf": ncf_tree, "textcnn": text_tree}
    return (ims, trees, {"bert_a": a, "bert_b": b},
            torch.cuda.memory_allocated() - before)


def _mm_alone(name, cfg, trees, ims):
    """The same model alone on the card, for the served answers' check."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras import engine
    from analytics_zoo_tpu_torch.models import NeuralCF, TextClassifier
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    if name == "bert_a":
        return ims["bert_a"]
    if name == "bert_b":
        net = BERTClassifier(2, bert_config=cfg, device="cuda").net
        net.set_weights((trees[name], {}))
        return InferenceModel(device="cuda").load_keras(
            net, preprocessor=ims["bert_b"].preprocessor)
    engine.reset_uids()
    net = (NeuralCF(device="cuda", **NCF_ML1M) if name == "ncf" else
           TextClassifier(encoder="cnn", device="cuda", **TEXT_NEWS20))
    net.set_weights(trees[name])
    return InferenceModel(device="cuda").load_keras(net)


def _mm_inputs(name, n, rng):
    if name.startswith("bert"):
        return list(_requests(n, rng, BERT_BASE).values())
    if name == "ncf":
        return [{"user": rng.integers(1, NCF_ML1M["user_count"] + 1,
                                      1).astype(np.int32),
                 "item": rng.integers(1, NCF_ML1M["item_count"] + 1,
                                      1).astype(np.int32)}
                for _ in range(n)]
    return [{"tokens": rng.integers(1, TEXT_NEWS20["vocab_size"],
                                    TEXT_NEWS20["sequence_length"])
             .astype(np.int32)} for _ in range(n)]


def _mm_ask(port, name, route, uri, inputs):
    """One request to model ``name`` over ``route`` (the /predict/<model>
    path, the X-Zoo-Model header, or the JSON "model" key)."""
    import http.client
    from analytics_zoo_tpu_torch.serving.client import FastWireHttpClient
    from analytics_zoo_tpu_torch.serving.codec import (decode_items_bytes,
                                                       encode_items_bytes)
    if route == "path":
        cli = FastWireHttpClient(port=port, timeout=300)
        try:
            return np.asarray(cli.predict(uri=uri, model=name, **inputs))
        finally:
            cli.close()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        if route == "header":
            conn.request("POST", "/predict", encode_items_bytes(inputs),
                         {"Content-Type": "application/x-zoo-fastwire",
                          "X-Zoo-Model": name, "X-Zoo-Uri": uri})
            resp = conn.getresponse()
            blob = resp.read()
            if resp.status != 200:
                raise AssertionError(f"{uri}: {resp.status} {blob[:200]}")
            return np.asarray(decode_items_bytes(blob)["prediction"])
        body = {"uri": uri, "model": name,
                "inputs": {k: v.tolist() for k, v in inputs.items()}}
        conn.request("POST", "/predict", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        blob = resp.read()
        if resp.status != 200:
            raise AssertionError(f"{uri}: {resp.status} {blob[:200]}")
        return np.asarray(json.loads(blob)["prediction"], np.float32)
    finally:
        conn.close()


def phase_multimodel(card_name):
    """Four models behind one registry and one frontend; see the module
    docstring (12)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
    from analytics_zoo_tpu_torch.serving.model_zoo import (
        DEVICE, PAGING, ModelRegistry)
    from analytics_zoo_tpu_torch.testing import chaos
    t_phase = time.perf_counter()
    cfg = BERT_BASE
    ims, trees, berts, cold_bytes = _mm_models(cfg)
    order = ("bert_a", "bert_b", "ncf", "textcnn")
    nbytes = {m: ims[m].weight_nbytes for m in order}
    budget = nbytes["bert_a"] + nbytes["bert_b"]
    log(f"[multimodel] weight bytes {nbytes}; budget {budget:,} bytes "
        f"(bert_a + bert_b: bert_b never fits beside a small model); the "
        f"three cold models took {cold_bytes:,} bytes of the card's memory")
    if cold_bytes != 0:
        raise AssertionError("multimodel: a cold model took card memory")
    reg = ModelRegistry(hbm_budget_bytes=budget, page_timeout_s=120.0,
                        breaker_failure_threshold=2, breaker_recovery_s=1.0)
    broker = InMemoryBroker()
    serving = fe = None
    out = {}
    try:
        for m in order:
            reg.register(m, ims[m], pinned=(m == "bert_a"))
        # page-in times, one model at a time
        pagein = {}
        for m in order[1:]:
            t0 = time.perf_counter()
            reg.ensure_resident(m)
            pagein[m] = (time.perf_counter() - t0) * 1e3
        log(f"[multimodel] page-in ms (host pinned -> card, the pager's "
            f"stream): {', '.join(f'{m} {v:.2f}' for m, v in pagein.items())}"
            f" on {card_name}")
        out["pagein_ms"] = pagein

        # a model placed, unplaced and placed again equals its host copy
        reg.ensure_resident("bert_b")
        im_b = ims["bert_b"]
        before = torch.cuda.memory_allocated()
        if not reg.evict("bert_b"):
            raise AssertionError("multimodel: bert_b could not be evicted")
        freed = before - torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        reg.ensure_resident("bert_b")
        pagein["bert_b again"] = (time.perf_counter() - t0) * 1e3
        dev = im_b._tensors()
        same = all(torch.equal(dev[q].cpu(), h) for q, h in
                   im_b._host.items())
        log(f"[multimodel] evicting bert_b freed {freed:,} bytes of "
            f"memory_allocated (its weights {nbytes['bert_b']:,}); placed "
            f"again in {pagein['bert_b again']:.2f} ms: weights equal the "
            f"host copy bit for bit: {same}")
        if freed < nbytes["bert_b"] or not same:
            raise AssertionError("multimodel: eviction did not free the "
                                 "weights, or a re-placed copy differs")

        serving = ClusterServing(reg, ServingConfig(),
                                 broker=broker).start()
        fe = ServingFrontend(serving, port=0).start()
        rng = np.random.default_rng(SEED + 21)
        per = MULTI["requests"] // len(order)
        inputs = {m: _mm_inputs(m, per, rng) for m in order}
        jobs = []
        for j in range(MULTI["requests"]):
            m = order[j % len(order)]
            jobs.append((m, ("path", "header", "json")[j % 3],
                         f"mm-{j}", inputs[m][j // len(order)]))
        forwards = {m: 0 for m in berts}
        hooks = [net.register_forward_hook(
            lambda *_, m=m: forwards.__setitem__(m, forwards[m] + 1))
            for m, net in berts.items()]
        books, stop = [], threading.Event()

        def sample():
            # under the registry's lock: the books equal the bytes of the
            # models resident or being placed (booked at reservation),
            # every resident model booked in full, within the budget
            while not stop.is_set():
                with reg._space:
                    owners = {o: b for o, (b, _) in
                              reg._owner_books.items()}
                    ents = {n: (e.state, e.nbytes)
                            for n, e in reg._entries.items()}
                    used = reg.used_bytes
                ok = (sum(owners.values()) == used <= budget
                      and all(owners.get(n) == nb for n, (st, nb)
                              in ents.items() if st == DEVICE)
                      and all(ents[o][0] in (DEVICE, PAGING)
                              and b == ents[o][1]
                              for o, b in owners.items()))
                books.append((ok, used, owners))
                time.sleep(0.002)
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        _kernels.reset_launches()
        ev0 = reg.evictions
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(MULTI["threads"]) as pool:
                got = list(pool.map(
                    lambda job: _mm_ask(fe.port, *job[:2], job[2], job[3]),
                    jobs))
        finally:
            secs = time.perf_counter() - t0
            stop.set()
            sampler.join(timeout=5)
            for h in hooks:
                h.remove()
        launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
        n_fwd = sum(forwards.values())
        bad = [b[1:] for b in books if not b[0]]
        evictions = reg.evictions - ev0
        leaks = obs.get_memory_ledger().reconcile_once()
        log(f"[multimodel] {len(jobs)} requests, {MULTI['threads']} "
            f"threads, round-robin over {order} and over /predict/<model>, "
            f"X-Zoo-Model and the JSON key, in {secs:.3f} s; evictions "
            f"{evictions}; BERT forwards {forwards}; launches {launches}; "
            f"books sampled {len(books)} times, {len(bad)} off; ledger "
            f"sweep {leaks or 'clean'}")
        if launches["flash_fwd"] != cfg["n_block"] * n_fwd or n_fwd == 0 \
                or sum(launches.values()) != launches["flash_fwd"]:
            raise AssertionError(f"multimodel: expected {cfg['n_block']} "
                                 f"flash_fwd launches per BERT forward")
        if bad or not books or "model_weights" in leaks or evictions < 2:
            raise AssertionError(f"multimodel: books off {bad[:3]}, ledger"
                                 f" {leaks}, evictions {evictions}")
        # every answer against the same model alone on the card
        errs = {}
        for m in order:
            idx = [j for j, job in enumerate(jobs) if job[0] == m]
            if m != "bert_a":
                reg.evict(m)
            ref_im = _mm_alone(m, cfg, trees, ims)
            batch = {k: np.stack([jobs[j][3][k] for j in idx])
                     for k in jobs[idx[0]][3]}
            if len(batch) == 1:        # one input: the engine's bare array
                batch = next(iter(batch.values()))
            want = np.asarray(ref_im.predict(batch))
            served = np.stack([got[j].reshape(want.shape[1:]) for j in idx])
            errs[m] = float(np.max(np.abs(served - want)))
            del ref_im
            _release()
        tol = {"bert_a": SERVE_ATOL, "bert_b": SERVE_ATOL,
               "ncf": REC_SERVE_ATOL, "textcnn": ZOO_SERVE_ATOL}
        ok = all(errs[m] <= tol[m] for m in order)
        log(f"[multimodel] served vs each model alone on the card: "
            f"{', '.join(f'{m} {errs[m]:.3e} (tol {tol[m]:g})' for m in order)}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("multimodel: served answers disagree")
        out.update(launches=launches, bert_forwards=n_fwd, errors=errs,
                   evictions=evictions, requests_s=len(jobs) / secs)

        # bert_a's latency alone, and while a cold page-in runs
        x_a = inputs["bert_a"][0]
        lat = {"idle": [], "paging": []}
        for _ in range(8):
            t0 = time.perf_counter()
            _mm_ask(fe.port, "bert_a", "path", f"lat-{len(lat['idle'])}", x_a)
            lat["idle"].append((time.perf_counter() - t0) * 1e3)
        for k in range(8):
            reg.evict("bert_b")
            reg.prefetch("bert_b")
            t0 = time.perf_counter()
            _mm_ask(fe.port, "bert_a", "path", f"latp-{k}", x_a)
            lat["paging"].append((time.perf_counter() - t0) * 1e3)
            reg.ensure_resident("bert_b")
        out["bert_a_p50_ms"] = {k: _pct(v, 50) for k, v in lat.items()}
        log(f"[multimodel] bert_a p50 over HTTP: "
            f"{out['bert_a_p50_ms']['idle']:.3f} ms idle, "
            f"{out['bert_a_p50_ms']['paging']:.3f} ms with bert_b paging "
            f"in on {card_name}")

        # a planned weight_page raise fails only that model's requests:
        # the injector is armed while an ncf request is out (the only
        # page-in then is ncf's; its reservation evicts bert_b first, as
        # any page-in that needs the room does), and the other three
        # models answer between them
        inj = chaos.ChaosInjector()
        inj.plan("weight_page", fault="raise", times=None)
        reg.evict("ncf")
        fails, served = 0, 0
        for k in range(MULTI["fault_requests"]):
            with chaos.installed(inj):
                try:
                    _mm_ask(fe.port, "ncf", "path", f"f-{k}",
                            inputs["ncf"][k])
                except Exception:
                    fails += 1
            for m in ("bert_a", "bert_b", "textcnn"):
                _mm_ask(fe.port, m, "path", f"f-{m}-{k}", inputs[m][k])
                served += 1
        brk = reg.resolve("ncf").breaker.state
        log(f"[multimodel] weight_page raises ({inj.injected('weight_page')}"
            f" injected) while ncf's requests were out: ncf {fails} of "
            f"{MULTI['fault_requests']} requests failed, its breaker {brk};"
            f" bert_a / bert_b / textcnn answered {served} of {served}")
        if fails != MULTI["fault_requests"] or brk == "closed" or any(
                reg.resolve(m).breaker.state != "closed"
                for m in ("bert_a", "bert_b", "textcnn")):
            raise AssertionError("multimodel: the weight_page fault was "
                                 "not contained to its model")
    finally:
        if fe is not None:
            fe.stop()
        if serving is not None:
            serving.stop()
        reg.stop()
    del ims, berts
    _release()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[multimodel] phase time {out['seconds']:.1f} s on {card_name}")
    return out


# ---------------------------------------------------------------- tenancy
def phase_tenancy(card_name):
    """Per-tenant admission over HTTP; see the module docstring (13)."""
    import http.client
    import threading
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import FastWireHttpClient
    from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    t_phase = time.perf_counter()
    cfg = BERT_BASE
    names = ("input_ids", "token_type_ids", "input_mask")
    rng = np.random.default_rng(SEED)
    clf = BERTClassifier(num_classes=2, bert_config=cfg, device="cuda")
    im = InferenceModel(device="cuda").load_keras(
        clf.net, (_random_tree(clf.net, rng), {}),
        preprocessor=lambda d: [d[n] for n in names])
    reqs = list(_requests(TENANCY["gold"], rng, cfg).values())
    im.warmup({n: np.stack([r[n] for r in reqs]) for n in names},
              [1, 2, 4, 8, 16, 32, 64])
    # the frontend's coalescer off: each request one stream entry, so
    # free's flood meets its credit gate request by request
    serving = ClusterServing(im, ServingConfig(tenants=TENANTS,
                                               http_coalesce=False),
                             broker=InMemoryBroker()).start()
    fe = ServingFrontend(serving, port=0).start()
    sent = {"gold": 0, "free": 0}
    codes = {"gold": {}, "free": {}}
    lock = threading.Lock()
    gold = []
    try:
        frame = encode_items_bytes(reqs[0])
        stop = threading.Event()

        def flood(t):
            # each round sends one request on each of its connections
            # before reading any answer: many in flight at once
            conns = [http.client.HTTPConnection("127.0.0.1", fe.port,
                                                timeout=300)
                     for _ in range(TENANCY["free_conns"])]
            try:
                for r in range(TENANCY["free_rounds"]):
                    for c, conn in enumerate(conns):
                        conn.request("POST", "/predict", frame, {
                            "Content-Type": "application/x-zoo-fastwire",
                            "X-Zoo-Tenant": "free",
                            "X-Zoo-Uri": f"free-{t}-{r}-{c}"})
                    for conn in conns:
                        resp = conn.getresponse()
                        resp.read()
                        with lock:
                            sent["free"] += 1
                            codes["free"][resp.status] = codes["free"].get(
                                resp.status, 0) + 1
            finally:
                for conn in conns:
                    conn.close()

        floods = [threading.Thread(target=flood, args=(t,))
                  for t in range(TENANCY["free_threads"])]
        for t in floods:
            t.start()
        cli = FastWireHttpClient(port=fe.port, timeout=300)
        for i, r in enumerate(reqs):
            gold.append(np.asarray(cli.predict(uri=f"gold-{i}",
                                               tenant="gold", **r)))
            sent["gold"] += 1
            codes["gold"][200] = codes["gold"].get(200, 0) + 1
        cli.close()
        for t in floods:
            t.join(timeout=300)
        usage = serving.tenancy.usage()
    finally:
        fe.stop()
        serving.stop()
    set_attention_backend(clf.net, "plain")
    want = np.concatenate([im.predict({n: np.stack([r[n] for r in reqs])
                                       for n in names})])
    set_attention_backend(clf.net, None)
    err = float(np.max(np.abs(np.stack(gold).reshape(want.shape) - want)))
    log(f"[tenancy] tenants {TENANTS}: gold {sent['gold']} requests from 1 "
        f"thread, free {sent['free']} from {TENANCY['free_threads']} threads"
        f" x {TENANCY['free_conns']} connections; HTTP codes {codes}; "
        f"usage {usage}; gold vs plain attention max_abs_err={err:.3e} "
        f"(tol {SERVE_ATOL:g}) on {card_name}")
    ok = (codes["gold"] == {200: sent["gold"]} and err <= SERVE_ATOL
          and codes["free"].get(429, 0) > 0
          and set(codes["free"]) <= {200, 429})
    for t in ("gold", "free"):
        u = usage[t]
        ok = ok and (u["admitted"] + u["shed"] == sent[t]
                     and u["served"] == u["admitted"]
                     == codes[t].get(200, 0)
                     and u["shed"] == codes[t].get(429, 0)
                     and u["in_flight"] == 0 and u["errors"] == 0)
    if not ok:
        raise AssertionError("tenancy: gold was not served in full, free "
                             "was not shed, or the books disagree")
    del im, clf
    _release()
    secs = time.perf_counter() - t_phase
    log(f"[tenancy] phase time {secs:.1f} s on {card_name}")
    return dict(codes=codes, usage=usage, gold_err=err, seconds=secs)


# ----------------------------------------------------------------- health
def phase_health(card_name):
    """Device probes; see the module docstring (14)."""
    import threading
    from analytics_zoo_tpu_torch.common.health import HealthMonitor
    from analytics_zoo_tpu_torch.estimator import estimator as est_mod
    from analytics_zoo_tpu_torch.testing import chaos
    from analytics_zoo_tpu_torch.tfpark import TFDataset
    t_phase = time.perf_counter()
    fired = []
    # 5 s: a probe issued during the dispatch below has taken 0.1-1.0 s
    # on the card; the dispatch itself takes about 7 s, so a probe that
    # waited for all of it would still read "timeout"
    mon = HealthMonitor(interval_s=3600, probe_timeout_s=5.0,
                        breaker_failures=3, device="cuda:0",
                        on_failure=fired.append)
    try:
        first = mon.probe_once()
        inj = chaos.ChaosInjector()
        inj.plan("health_probe", fault="raise", times=3)
        with chaos.installed(inj):
            faulted = [mon.probe_once() for _ in range(3)]
        brk = mon.breaker_for("cuda:0")._state
        log(f"[health] probe {first['devices']}; 3 planned health_probe "
            f"raises -> healthy {[s['healthy'] for s in faulted]}, breaker "
            f"{brk}, on_failure fired {len(fired)} time(s)")
        if not first["healthy"] or any(s["healthy"] for s in faulted) \
                or brk != "open" or len(fired) != 1:
            raise AssertionError("health: the probe or its breaker "
                                 "misbehaved")
        # a probe while a training dispatch of train_bench runs
        cfg = dict(BERT_BASE, hidden_drop=0.1, attn_drop=0.1)
        x, y = _bench_data(cfg)
        ds = TFDataset.from_ndarrays((x, y), batch_size=BENCH["batch"],
                                     memory_type="DEVICE")
        from analytics_zoo_tpu_torch.tfpark import BERTClassifier
        probe_net = BERTClassifier(2, bert_config=cfg, device="cuda").net
        tree = _random_tree(probe_net, np.random.default_rng(SEED + 5))
        del probe_net
        clf = _bench_clf(cfg, tree, BENCH["spd"])
        replaying = threading.Event()
        orig = est_mod._CapturedStep.replay

        def replay(self, n):
            replaying.set()
            return orig(self, n)
        est_mod._CapturedStep.replay = replay
        result = {}
        try:
            trainer = threading.Thread(
                target=lambda: clf.train(lambda: ds, epochs=1))
            t0 = time.perf_counter()
            trainer.start()
            if not replaying.wait(600):
                raise AssertionError("health: the dispatch never started")
            time.sleep(0.05)
            t_probe = time.perf_counter()
            result = mon.probe_once()
            probe_ms = (time.perf_counter() - t_probe) * 1e3
            trainer.join(timeout=600)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            est_mod._CapturedStep.replay = orig
        dev = result["devices"]["cuda:0"]
        log(f"[health] a probe during a {BENCH['spd']}-replay training "
            f"dispatch (train_bench's configuration, batch "
            f"{BENCH['batch']}): {dev} in {probe_ms:.3f} ms; the epoch took "
            f"{train_s:.2f} s on {card_name}")
        if not dev["ok"] or probe_ms >= 1e3 * train_s:
            raise AssertionError("health: the probe during a dispatch did "
                                 "not read ok")
        del clf, ds
        _release()
    finally:
        mon.stop()
    secs = time.perf_counter() - t_phase
    log(f"[health] phase time {secs:.1f} s on {card_name}")
    return dict(probe_during_dispatch_ms=probe_ms, seconds=secs)


BERT_INPUTS = ("input_ids", "token_type_ids", "input_mask")


def _bert_serving_models(device="cuda"):
    """The Serve / HTTP cell's BERT-base (numpy seed 0) with two faces:
    ``im`` takes the dict of three inputs, ``packed`` one int32 array
    (N, 3, T) of them (``BatchingService`` concatenates one array); and
    the rng after the weights, from which the requests are drawn."""
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    rng = np.random.default_rng(SEED)
    clf = BERTClassifier(num_classes=2, bert_config=BERT_BASE, device=device)
    im = InferenceModel(device=device).load_keras(
        clf.net, (_random_tree(clf.net, rng), {}),
        preprocessor=lambda d: [d[n] for n in BERT_INPUTS])
    packed = InferenceModel(device=device).load_keras(
        clf.net, preprocessor=lambda x: [x[:, i].contiguous()
                                         for i in range(3)])
    return clf, im, packed, rng


def _pack(req):
    """One request's three inputs as a (1, 3, T) int32 array."""
    return np.stack([req[n] for n in BERT_INPUTS])[None]


def _plain_answers(clf, im, reqs, uris):
    """The model with the plain attention on the card, over ``uris``."""
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    set_attention_backend(clf.net, "plain")
    try:
        return np.concatenate([
            im.predict({n: np.stack([reqs[u][n] for u in uris[s:s + 32]])
                        for n in BERT_INPUTS})
            for s in range(0, len(uris), 32)])
    finally:
        set_attention_backend(clf.net, None)


def _answer_err(got, want):
    return float(np.abs(np.stack([np.asarray(g).ravel() for g in got])
                        - want.reshape(len(got), -1)).max())


def phase_batching(card_name, clf, packed, reqs, want):
    """BatchingService over BERT-base: 64 single requests from 8 threads,
    then a device_execute fault opening the breaker and a probe closing
    it; see the module docstring (15)."""
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch.common.resilience import (
        CircuitBreaker, CircuitOpenError)
    from analytics_zoo_tpu_torch.inference import BatchingService
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.testing import chaos
    t_phase = time.perf_counter()
    uris = list(reqs)
    n, threads = BATCHING["requests"], BATCHING["threads"]
    packed.warmup(np.concatenate([_pack(reqs[u]) for u in uris]),
                  [1, 2, 4, 8, 16, 32])
    sizes, inner = [], packed.predict

    def predict(x, *a, **kw):
        sizes.append(len(x))
        return inner(x, *a, **kw)
    packed.predict = predict
    now = [0.0]
    breaker = CircuitBreaker("batching-bert", failure_threshold=1,
                             recovery_s=1.0, clock=lambda: now[0])
    svc = BatchingService(packed, max_batch=BATCHING["max_batch"],
                          max_delay_ms=BATCHING["max_delay_ms"],
                          breaker=breaker)
    got, lat = {}, {}
    try:
        def client(k):
            for i in range(k, n, threads):
                t = time.perf_counter()
                got[uris[i]] = svc.predict(_pack(reqs[uris[i]]),
                                           timeout_ms=300000)
                lat[uris[i]] = (time.perf_counter() - t) * 1e3
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            for f in [pool.submit(client, k) for k in range(threads)]:
                f.result()
        burst_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches, batches = _kernels.flash_fwd.launches, list(sizes)
        # one device_execute fault opens the breaker (threshold 1); the
        # open circuit fails fast; after recovery_s a probe closes it
        inj = chaos.ChaosInjector()
        inj.plan("device_execute", fault="raise", times=1)
        x0 = _pack(reqs[uris[0]])
        outcomes = []
        with chaos.installed(inj):
            for _ in range(2):      # the faulted batch, then the open one
                try:
                    svc.predict(x0, timeout_ms=300000)
                    outcomes.append("answered")
                except CircuitOpenError:
                    outcomes.append("circuit open")
                except RuntimeError as exc:
                    outcomes.append(str(exc).split(":")[0])
                if not breaker.state == "open":
                    break
            opened = breaker.state
            now[0] = 2.0
            probe = svc.predict(x0, timeout_ms=300000)
            closed = breaker.state
    finally:
        svc.stop()
        del packed.predict
    err = _answer_err([got[u] for u in uris], want)
    err_probe = float(np.abs(np.asarray(probe).ravel() - want[0]).max())
    ms = list(lat.values())
    log(f"[batching] BatchingService(max_batch={BATCHING['max_batch']}, "
        f"max_delay_ms={BATCHING['max_delay_ms']}) over BERT-base: {n} "
        f"single requests (valid lengths 8..128) from {threads} threads in "
        f"{burst_s:.4f} s = {n / burst_s:.2f} req/s, latency p50 "
        f"{_pct(ms, 50):.3f} ms, p99 {_pct(ms, 99):.3f} ms; dispatched "
        f"batches {batches} on {card_name}")
    log(f"[batching] flash_fwd launches {launches} in {len(batches)} "
        f"batched forwards = {launches / max(len(batches), 1):g} per "
        f"forward; answers vs plain attention max_abs_err={err:.3e}, the "
        f"probe's {err_probe:.3e} (tol {SERVE_ATOL:g}); a device_execute "
        f"fault, then one more request: {outcomes}; breaker {opened!r}, "
        f"after the probe {closed!r}")
    if (sum(batches) != n or launches != BERT_BASE["n_block"] * len(batches)
            or max(err, err_probe) > SERVE_ATOL or opened != "open"
            or outcomes != ["batched inference failed", "circuit open"]
            or closed != "closed" or inj.injected("device_execute") != 1):
        raise AssertionError("batching: launches, answers or the breaker "
                             "are wrong")
    secs = time.perf_counter() - t_phase
    log(f"[batching] phase time {secs:.1f} s on {card_name}")
    return dict(launches=launches, forwards=len(batches),
                rps=n / burst_s, p50_ms=_pct(ms, 50), p99_ms=_pct(ms, 99),
                batches=batches, seconds=secs)


def phase_native(card_name, clf, im, reqs, want):
    """The pipelined engine over ``get_broker("native://")``; see the
    module docstring (16)."""
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import (
        NativeQueueBroker, get_broker)
    from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    t_phase = time.perf_counter()
    uris = list(reqs)
    n = len(uris)
    im.warmup({k: np.stack([reqs[u][k] for u in uris]) for k in BERT_INPUTS},
              [1, 2, 4, 8, 16, 32, 64])
    forwards = [0]
    hook = clf.net.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sizes = _batch_recorder(im)
    broker = get_broker("native://")
    serving = ClusterServing(im, ServingConfig(redis_url="native://")).start()
    try:
        if not isinstance(serving.broker, NativeQueueBroker) \
                or serving.broker is not broker:
            raise AssertionError("native: the engine is not on native://")
        iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
        _kernels.reset_launches()
        forwards[0] = 0
        t0 = time.perf_counter()
        for u in uris:
            iq.enqueue(u, **reqs[u])
        got = [oq.query_blocking(u, timeout=300) for u in uris]
        burst_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches, n_forwards = _kernels.flash_fwd.launches, forwards[0]
        batches = list(sizes)
    finally:
        serving.stop()
        hook.remove()
        del im.predict_async
        broker.close()
    missing = [u for u, g in zip(uris, got) if g is None]
    if missing:
        raise AssertionError(f"native: no result for {missing}")
    err = _answer_err(got, want)
    log(f"[native] pipelined ClusterServing(ServingConfig(redis_url="
        f"\"native://\")) over the C++ queue broker: {n} requests in one "
        f"burst through InputQueue / OutputQueue in {burst_s:.4f} s = "
        f"{n / burst_s:.2f} req/s; dispatched batches {batches}; flash_fwd "
        f"launches {launches} in {n_forwards} forwards; answers vs plain "
        f"attention max_abs_err={err:.3e} (tol {SERVE_ATOL:g}) on "
        f"{card_name}")
    if (n_forwards != len(batches) or n_forwards == 0
            or launches != BERT_BASE["n_block"] * n_forwards
            or err > SERVE_ATOL):
        raise AssertionError("native: launches or answers are wrong")
    secs = time.perf_counter() - t_phase
    log(f"[native] phase time {secs:.1f} s on {card_name}")
    return dict(launches=launches, forwards=n_forwards, rps=n / burst_s,
                batches=batches, seconds=secs)


def phase_host_serving(card_name):
    """The batching and native phases over one BERT-base on the card."""
    clf, im, packed, rng = _bert_serving_models()
    reqs = _requests(BATCHING["requests"], rng, BERT_BASE)
    want = _plain_answers(clf, im, reqs, list(reqs))
    out = {"batching": phase_batching(card_name, clf, packed, reqs, want),
           "native": phase_native(card_name, clf, im, reqs, want)}
    del clf, im, packed
    _release()
    return out


# ---- the fleet phases, in a fresh interpreter (17) -------------------------

def _fleet_factory(address):
    """The replicas' model factory: BERT-base on ``cuda:0`` built after the
    fork, warmed up, its ``flash_fwd`` launches and forwards reported to
    the bridge at ``address`` after every fetch (``smoke:<pid>``)."""
    def factory():
        import threading

        from analytics_zoo_tpu_torch.ops import _kernels
        from analytics_zoo_tpu_torch.serving.fleet import RemoteBroker
        clf, im, _, rng = _bert_serving_models()
        reqs = _requests(8, rng, BERT_BASE)
        im.warmup({k: np.stack([r[k] for r in reqs.values()])
                   for k in BERT_INPUTS}, [1, 2, 4, 8, 16, 32, 64])
        torch.cuda.synchronize()
        _kernels.reset_launches()
        forwards = [0]
        clf.net.register_forward_hook(
            lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        rb, lock, fetch = RemoteBroker(address), threading.Lock(), im.fetch
        key = f"smoke:{os.getpid()}"

        def reporting_fetch(pending):
            out = fetch(pending)
            with lock:
                try:
                    rb.ctl_set(key, [_kernels.flash_fwd.launches,
                                     forwards[0]])
                except Exception:
                    pass    # a failover gap: the next fetch reports again
            return out
        im.fetch = reporting_fetch
        return im
    return factory


def _fleet_http(port, reqs, uris, threads):
    """``uris`` over HTTP from ``threads`` client threads, half JSON and
    half fast-wire: {uri: answer}, {uri: latency ms}."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    from analytics_zoo_tpu_torch.serving.client import FastWireHttpClient
    out, lat = {}, {}

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        with FastWireHttpClient(port=port, timeout=300) as fw:
            for i in range(k, len(uris), threads):
                u, t = uris[i], time.perf_counter()
                if i % 2:
                    out[u] = fw.predict(uri=u, **reqs[u])
                else:
                    conn.request("POST", "/predict", json.dumps(
                        {"uri": u, "inputs": {n: v.tolist() for n, v in
                                              reqs[u].items()}}),
                        {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    body = json.loads(resp.read())
                    if resp.status != 200:
                        raise AssertionError(f"fleet: {u} {resp.status} "
                                             f"{body}")
                    out[u] = np.asarray(body["prediction"], np.float32)
                lat[u] = (time.perf_counter() - t) * 1e3
        conn.close()
    with ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(client, k) for k in range(threads)]:
            f.result()
    return out, lat


def _fleet_launches(rb):
    """Launches and forwards summed over the replicas' reports."""
    rows = [v for k, v in rb.ctl_all().items() if k.startswith("smoke:")]
    return sum(r[0] for r in rows), sum(r[1] for r in rows), len(rows)


def phase_fleet(card_name, reqs):
    """FleetSupervisor over BERT-base replicas; see the module docstring
    (17).  Returns the numbers and every answer, checked against the
    plain attention by the caller once no process will fork again."""
    import http.client

    from analytics_zoo_tpu_torch import observability as obs
    from analytics_zoo_tpu_torch.common.config import (FleetConfig,
                                                       ServingConfig)
    from analytics_zoo_tpu_torch.serving.client import (FastWireHttpClient,
                                                        ServingError)
    from analytics_zoo_tpu_torch.serving.codec import encode_items_bytes
    from analytics_zoo_tpu_torch.serving.fleet import (
        FleetSupervisor, RemoteBroker, _free_port, partition_for)
    t_phase = time.perf_counter()
    uris = list(reqs)
    address = ("127.0.0.1", _free_port())
    fcfg = FleetConfig(frontend_workers=FLEET["workers"],
                       replicas=FLEET["replicas"], bridge_port=address[1])
    sup = FleetSupervisor(_fleet_factory(address),
                          ServingConfig(redis_url="memory://"), fcfg,
                          http_port=0, autoscale=False)
    t0 = time.perf_counter()
    sup.start(wait_ready_s=600)
    up_s = time.perf_counter() - t0
    rb = RemoteBroker(address)
    try:
        port = sup.http_port
        t0 = time.perf_counter()
        got, lat = _fleet_http(port, reqs, uris, FLEET["threads"])
        http_s = time.perf_counter() - t0
        launches, n_forwards, reporters = _fleet_launches(rb)
        # the merge reads each process's snapshot of the last publish
        served = routed = 0.0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (served < len(uris)
                                               or routed < len(uris)):
            scrape = _scrape(port)
            served = sum(v for (k, _), v in scrape.items()
                         if k == "zoo_serving_records_total")
            routed = sum(v for (k, _), v in scrape.items()
                         if k == "zoo_fleet_routed_total")
            time.sleep(0.1)
        # one traced request: its 5-span chain across the two processes
        ctx = obs.new_trace_context()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/predict", encode_items_bytes(reqs[uris[0]]),
                     {"Content-Type": "application/x-zoo-fastwire",
                      "X-Zoo-Uri": "traced-0",
                      "X-Zoo-Trace": obs.encode_trace_context(ctx)})
        resp = conn.getresponse()
        resp.read()
        worker = resp.headers.get("X-Zoo-Fleet-Worker")
        conn.close()
        chain = ("http.predict", "fleet.route", "serving.decode",
                 "serving.dispatch", "serving.sink")
        spans = _spans_of(port, ctx[0], chain, timeout=30)
        by = {sp["name"]: sp for sp in spans}
        chain_ok = (resp.status == 200 and len(spans) == 5
                    and set(by) == set(chain)
                    and {sp["trace_id"] for sp in spans} == {ctx[0]}
                    and by["fleet.route"]["parent_id"]
                    == by["http.predict"]["span_id"]
                    and by["serving.decode"]["parent_id"]
                    == by["http.predict"]["span_id"]
                    and by["serving.dispatch"]["parent_id"]
                    == by["serving.decode"]["span_id"]
                    and by["serving.sink"]["parent_id"]
                    == by["serving.dispatch"]["span_id"])
        # kill replica 1: requests homed there on one connection (one
        # worker's breakers) time out until its breaker opens, then divert
        homed = [f"kill-{i}" for i in range(400)
                 if partition_for(f"kill-{i}", FLEET["replicas"]) == 1]
        homed = homed[:FLEET["after_kill"]]
        sup.kill_replica(1)
        after, failed = {}, 0           # uri -> (request index, answer)
        with FastWireHttpClient(port=port, timeout=300) as fw:
            for i, u in enumerate(homed):
                try:
                    after[u] = (i, fw.predict(
                        uri=u, deadline_ms=FLEET["kill_deadline_ms"],
                        **reqs[uris[i]]))
                except ServingError:
                    failed += 1
        # the fleet-wide merge lags the routers by a snapshot interval
        diverted, deadline = 0.0, time.monotonic() + 15
        while (time.monotonic() < deadline
               and diverted < len(homed) - failed):
            diverted = sum(v for (k, lab), v in _scrape(port).items()
                           if k == "zoo_fleet_diverted_total")
            time.sleep(0.1)
    finally:
        rb.close()
        sup.stop()
    secs = time.perf_counter() - t_phase
    ms = list(lat.values())
    n = len(uris)
    log(f"[fleet] FleetSupervisor: {FLEET['workers']} frontend workers on "
        f"one SO_REUSEPORT port, {FLEET['replicas']} BERT-base replicas on "
        f"cuda:0 (up in {up_s:.1f} s); {n} requests over HTTP from "
        f"{FLEET['threads']} threads, half JSON, half fast-wire, in "
        f"{http_s:.4f} s = {n / http_s:.2f} req/s, p50 {_pct(ms, 50):.3f} "
        f"ms, p99 {_pct(ms, 99):.3f} ms on {card_name}")
    log(f"[fleet] flash_fwd launches summed over {reporters} replicas "
        f"{launches} in {n_forwards} forwards = "
        f"{launches / max(n_forwards, 1):g} per forward; /metrics on a "
        f"worker: zoo_serving_records_total {served:g}, "
        f"zoo_fleet_routed_total {routed:g}; the traced request "
        f"(answered by {worker}): spans {sorted(by)} "
        f"{'chained' if chain_ok else 'NOT chained'}")
    log(f"[fleet] kill_replica(1), then {len(homed)} requests homed on it "
        f"with deadline_ms={FLEET['kill_deadline_ms']}: {failed} failed "
        f"(breaker threshold {fcfg.breaker_failure_threshold}), "
        f"{len(after)} answered; zoo_fleet_diverted_total {diverted:g}; "
        f"phase time {secs:.1f} s")
    if (reporters != FLEET["replicas"] or n_forwards == 0
            or launches != BERT_BASE["n_block"] * n_forwards
            or served != n or routed < n or not chain_ok
            or not 1 <= failed <= fcfg.breaker_failure_threshold
            or len(after) != len(homed) - failed
            or diverted < len(homed) - failed or len(got) != n):
        raise AssertionError("fleet: launches, metrics, the span chain or "
                             "the diversion are wrong")
    return dict(launches=launches, forwards=n_forwards, rps=n / http_s,
                p50_ms=_pct(ms, 50), p99_ms=_pct(ms, 99),
                failed_after_kill=failed, seconds=secs), got, after


def _wal_entries(wal_root):
    """{uri: {(stream, sid): dedup_id}} over every broker generation's WAL
    under ``wal_root`` (a standby's ``repl`` records unwrapped)."""
    from analytics_zoo_tpu_torch.serving.durability import replay_dir
    seen = {}
    for gen in sorted(os.listdir(wal_root)):
        for _, rec in replay_dir(os.path.join(wal_root, gen)):
            while rec[0] == "repl":
                rec = rec[2]
            if rec[0] == "xadd":
                _, stream, sid, fields = rec
                seen.setdefault(fields.get("uri"), {})[(stream, sid)] = \
                    fields.get("dedup_id")
    return seen


def phase_durable(card_name, reqs):
    """The durable fleet across ``kill_broker_owner()``; see the module
    docstring (17)."""
    import shutil
    import tempfile
    import threading

    from analytics_zoo_tpu_torch.common.config import (FleetConfig,
                                                       ServingConfig)
    from analytics_zoo_tpu_torch.serving.broker import get_broker
    from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.fleet import (
        FleetSupervisor, _free_port, partition_for, partition_stream)
    t_phase = time.perf_counter()
    uris = list(reqs)
    wal_root = tempfile.mkdtemp(prefix="zoo_smoke_wal_")
    address = ("127.0.0.1", _free_port())
    fcfg = FleetConfig(frontend_workers=1, replicas=FLEET["replicas"],
                       durable=True, wal_dir=wal_root,
                       broker_port=address[1], failover_poll_s=0.1)
    sup = FleetSupervisor(_fleet_factory(address),
                          ServingConfig(redis_url="memory://"), fcfg,
                          http_port=0, autoscale=False)
    sup.start(wait_ready_s=600)
    rb = get_broker(f"fleet://{address[0]}:{address[1]}")
    acked, lock, caller_retries = {}, threading.Lock(), [0]
    half = threading.Event()
    retries0 = _counter_total("zoo_resilience_retries_total")
    try:
        def enqueue(k):
            # the client's own entry point: its RetryPolicy resends one
            # dedup_id; a call that still fails is retried by this caller,
            # as a user would, and that call mints a new dedup_id
            queues = {p: InputQueue(broker=rb, stream=partition_stream(
                "serving_stream", p)) for p in range(FLEET["replicas"])}
            for i in range(k, len(uris), FLEET["threads"]):
                u = uris[i]
                iq = queues[partition_for(u, FLEET["replicas"])]
                for _attempt in range(400):
                    try:
                        sid = iq.enqueue_items(u, reqs[u])
                        break
                    except Exception:
                        with lock:
                            caller_retries[0] += 1
                        time.sleep(0.1)
                else:
                    raise AssertionError(f"durable: {u} never acknowledged")
                with lock:
                    acked[u] = (iq.stream, sid)
                    if len(acked) >= len(uris) // 2:
                        half.set()
        clients = [threading.Thread(target=enqueue, args=(k,))
                   for k in range(FLEET["threads"])]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        half.wait(300)
        at_kill = len(acked)
        sup.kill_broker_owner()
        for t in clients:
            t.join(timeout=300)
        oq = OutputQueue(broker=rb)
        got = {}
        for u in uris:
            for _attempt in range(400):
                try:
                    got[u] = oq.query_blocking(u, timeout=5.0)
                except Exception:
                    got[u] = None
                if got[u] is not None:
                    break
                time.sleep(0.1)
        burst_s = time.perf_counter() - t0
        failover_ms = sup.last_failover_ms
        launches, n_forwards, reporters = _fleet_launches(rb)
    finally:
        rb.close()
        sup.stop()
    policy_retries = _counter_total("zoo_resilience_retries_total") - retries0
    entries = _wal_entries(wal_root)
    lost = [u for u in acked if got.get(u) is None]
    unjournaled = [u for u in acked if acked[u] not in entries.get(u, {})]
    # an acknowledged enqueue is its dedup_id: the barrier lets it land
    # once, however often the client's policy resent it
    duplicated = [u for u in acked if u not in unjournaled and list(
        entries[u].values()).count(entries[u][acked[u]]) > 1]
    # a caller's retry is a new enqueue with a new dedup_id: where the
    # failed call's entry was journaled after all, the request lands twice
    twice = [u for u in acked if len(entries.get(u, ())) > 1]
    shutil.rmtree(wal_root, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[durable] FleetConfig(durable=True): {len(acked)} of {len(uris)} "
        f"requests acknowledged through InputQueue over fleet:// from "
        f"{FLEET['threads']} threads, kill_broker_owner() after {at_kill}; "
        f"{policy_retries:g} retries inside the client's RetryPolicy (one "
        f"dedup_id), {caller_retries[0]} caller retries (a new dedup_id "
        f"each); standby promoted, failover {failover_ms} ms; lost "
        f"{len(lost)}, acknowledged enqueues duplicated {len(duplicated)}, "
        f"unjournaled {len(unjournaled)}; requests with more than one "
        f"stream entry in the WALs (a caller retry after a journaled "
        f"attempt) {len(twice)}; {len(uris)} answered in {burst_s:.2f} s; "
        f"flash_fwd launches {launches} in {n_forwards} forwards over "
        f"{reporters} replica reports on {card_name}; phase time "
        f"{secs:.1f} s")
    if (len(acked) != len(uris) or lost or duplicated or unjournaled
            or failover_ms is None):
        raise AssertionError("durable: an acknowledged request was lost or "
                             "duplicated, or no failover ran")
    return dict(failover_ms=failover_ms, lost=len(lost),
                duplicated=len(duplicated), landed_twice=len(twice),
                policy_retries=policy_retries,
                caller_retries=caller_retries[0], seconds=secs), got


def fleet_main() -> int:
    """The fleet and durable phases, run by ``main`` in a fresh
    interpreter: nothing here touches CUDA before the supervisors have
    stopped (their replicas fork and build their models on the card);
    then the answers are checked against the plain attention.  Prints one
    JSON line of numbers last."""
    torch.backends.cuda.matmul.allow_tf32 = False   # flags: no CUDA init
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    reqs = _requests(FLEET["requests"], np.random.default_rng(SEED + 17),
                     BERT_BASE)
    fleet, got, after = phase_fleet(card, reqs)
    durable, dgot = phase_durable(card, reqs)
    if torch.cuda.is_initialized():
        raise AssertionError("fleet: this process touched CUDA")
    clf, im, _, _ = _bert_serving_models()
    uris = list(reqs)
    want = _plain_answers(clf, im, reqs, uris)
    err = _answer_err([got[u] for u in uris], want)
    err_durable = _answer_err([dgot[u] for u in uris], want)
    err_after = _answer_err([a for _, a in after.values()],
                         want[[i for i, _ in after.values()]]) \
        if after else 0.0
    log(f"[fleet] answers vs plain attention on the card: max_abs_err "
        f"{err:.3e} over HTTP, {err_after:.3e} after the kill, "
        f"{err_durable:.3e} through the durable fleet (tol {SERVE_ATOL:g})")
    if max(err, err_durable, err_after) > SERVE_ATOL:
        raise AssertionError("fleet: answers disagree with the plain path")
    print(json.dumps({"fleet_phases": {"fleet": fleet, "durable": durable}}),
          flush=True)
    return 0


def phase_fleets(card_name):
    """Runs ``fleet_main`` in a fresh interpreter of this script (its own
    session, so every process it forks is stopped with it); its output
    passes through, a nonzero exit fails the run."""
    import signal
    _release()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-phases"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
        env={**os.environ, "PYTORCH_NVML_BASED_CUDA_CHECK": "1"})
    try:
        out, err = proc.communicate(timeout=FLEET["timeout_s"])
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"fleet: the phases took over "
                             f"{FLEET['timeout_s']} s:\n{err[-4000:]}")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)   # anything left behind
        except ProcessLookupError:
            pass
    lines = out.splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        sys.stderr.write(err[-20000:])
        raise AssertionError(f"fleet: the fresh interpreter exited "
                             f"{proc.returncode}")
    result = json.loads(lines[-1])["fleet_phases"]
    log(f"[fleet] the fleet and durable phases in a fresh interpreter: "
        f"{time.perf_counter() - t0:.1f} s on {card_name}")
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ring-cards", type=int, default=0, metavar="N",
                        help="run only ring attention over N cards")
    parser.add_argument("--fleet-phases", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.fleet_phases:
        sys.path.insert(0, ROOT)
        return fleet_main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import analytics_zoo_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    phase_build()
    if args.ring_cards:
        if torch.cuda.device_count() < args.ring_cards:
            raise SystemExit(f"chip_smoke: --ring-cards {args.ring_cards} "
                             f"needs as many cards, found "
                             f"{torch.cuda.device_count()}")
        times = phase_ring_cards(args.ring_cards)
        print(json.dumps({"ring_cards": times}), flush=True)
        return _finish(card_line(every=True))
    rows = phase_kernels()
    serve_launches = phase_serve()
    bwd_rows, bwd_lse_rows = phase_backward()
    train_launches, _ = phase_train()
    bench_launches, _ = phase_train_bench()
    paged_rows = phase_paged()
    llm_launches, llm = phase_llm()
    mp_llm = phase_mp_llm(card)
    mesh2d = phase_mesh2d(card)
    phase_parallel(card)
    mesh_train = phase_mesh_train(card)
    multiproc = phase_multiproc(card)
    ring_launches, ring_rows = phase_ring()
    phase_ncf(card)
    phase_zoo(card)
    heads_launches, t384, heads = phase_heads(card)
    http_launches, _, http_llm = phase_http()
    ingest = phase_ingest(card, heads)
    multimodel = phase_multimodel(card)
    phase_tenancy(card)
    phase_health(card)
    host = phase_host_serving(card)
    fleets = phase_fleets(card)

    def entry(name, source, replaces, rows, launches,
              shape="B32 H12 T128 D64 float32", **extra):
        f32 = dict(rows[torch.float32])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": f32.pop("max_abs_err"), "ms": f32.pop("ms"),
                "plain_ms": f32.pop("plain_ms"),
                "bound_ms": f32.pop("bound_ms"),
                "bound_by": f32.pop("bound_by"),
                "library_ms": f32.pop("library_ms"), "shape": shape, **f32,
                "bf16": dict(rows[torch.bfloat16]), **extra}

    csrc = "analytics_zoo_tpu_torch/ops/csrc/"
    HEADS_RUN = (f"each BERT head's main path: 2 epochs of {HEADS_STEPS} "
                 f"steps, one dispatch of {HEADS_STEPS} CUDA graph replays "
                 f"an epoch, bf16")
    t384_shape = (f"B{HEADS['squad']['batch']} H12 T{HEADS['squad']['seq']}"
                  f" D64, ragged padding mask")
    t384_rows = lambda name: {"shape": t384_shape, **{
        str(dt)[6:]: row for dt, row in t384[name].items()}}
    INGEST_RUN = (f"SQuAD from TFRecord shards: {INGEST['epochs']} epochs"
                  f" of {INGEST['features'] // HEADS['squad']['batch']} "
                  f"steps, {INGEST['spd']} CUDA graph replays a dispatch, "
                  f"bf16")
    BENCH_RUN = (f"the bench's BERT training: "
                 f"{BENCH['steps'] * BENCH['epochs']} steps, "
                 f"{BENCH['epochs']} dispatches of {BENCH['spd']} CUDA "
                 f"graph replays")
    MESH_TRAIN_RUN = (f"the bench's BERT training under data 2 x model 2 "
                      f"with ZeRO: "
                      f"{MESH_TRAIN['steps'] * MESH_TRAIN['epochs']} steps "
                      f"of 12 layers x 4 blocks, {MESH_TRAIN['epochs']} "
                      f"dispatches of {MESH_TRAIN['spd']} CUDA graph "
                      f"replays")
    MULTIPROC_RUN = (f"rank 0 of {MULTIPROC['workers']} processes on one "
                     f"card (gloo): the bench's BERT training, "
                     f"{MULTIPROC['steps'] * MULTIPROC['epochs']} eager "
                     f"steps at {BENCH['batch'] // MULTIPROC['workers']} "
                     f"rows a rank")
    paged_lib = "scaled_dot_product_attention over the same K/V made contiguous"
    kernels = [
        entry("flash_fwd", csrc + "flash_fwd.cu",
              "analytics_zoo_tpu/ops/attention.py:169", rows,
              bench_launches["flash_fwd"], launches_in=BENCH_RUN,
              f32_train_launches=train_launches["flash_fwd"],
              serve_launches=serve_launches,
              http_launches=http_launches["flash_fwd"],
              heads_launches={h: heads_launches[h]["flash_fwd"]
                              for h in HEADS},
              heads_launches_in=HEADS_RUN, t384=t384_rows("flash_fwd"),
              ingest_launches=ingest["squad"]["launches"]["flash_fwd"],
              ingest_launches_in=INGEST_RUN,
              multimodel_launches=multimodel["launches"]["flash_fwd"],
              multimodel_launches_in=f"{MULTI['requests']} requests over "
                                     f"4 models "
                                     f"({multimodel['bert_forwards']} BERT "
                                     f"forwards)",
              batching_launches=host["batching"]["launches"],
              batching_launches_in=f"{BATCHING['requests']} requests "
                                   f"through BatchingService "
                                   f"({host['batching']['forwards']} "
                                   f"batched forwards)",
              native_launches=host["native"]["launches"],
              native_launches_in=f"{BATCHING['requests']} requests over "
                                 f"native:// "
                                 f"({host['native']['forwards']} forwards)",
              fleet_launches=fleets["fleet"]["launches"],
              fleet_launches_in=f"{FLEET['requests']} HTTP requests over "
                                f"{FLEET['replicas']} fleet replicas, summed "
                                f"({fleets['fleet']['forwards']} forwards)",
              mesh2d_launches=mesh2d["launches"],
              mesh2d_launches_in="one BERT-base forward at batch 32 under "
                                 "data 2 x model 2 (12 layers x 4 blocks)",
              mesh_train_launches=mesh_train["sharded"]["launches"][
                  "flash_fwd"],
              mesh_train_launches_in=MESH_TRAIN_RUN,
              multiproc_launches=multiproc["launches"]["flash_fwd"],
              multiproc_launches_in=MULTIPROC_RUN),
        entry("flash_bwd", csrc + "flash_bwd.cu",
              "analytics_zoo_tpu/ops/attention.py:407", bwd_rows,
              bench_launches["flash_bwd"], launches_in=BENCH_RUN,
              f32_train_launches=train_launches["flash_bwd"],
              library="backward of scaled_dot_product_attention",
              heads_launches={h: heads_launches[h]["flash_bwd"]
                              for h in HEADS},
              heads_launches_in=HEADS_RUN, t384=t384_rows("flash_bwd"),
              ingest_launches=ingest["squad"]["launches"]["flash_bwd"],
              ingest_launches_in=INGEST_RUN,
              mesh_train_launches=mesh_train["sharded"]["launches"][
                  "flash_bwd"],
              mesh_train_launches_in=MESH_TRAIN_RUN,
              multiproc_launches=multiproc["launches"]["flash_bwd"],
              multiproc_launches_in=MULTIPROC_RUN),
        entry("paged_decode", csrc + "paged_decode.cu",
              "analytics_zoo_tpu/ops/paged_attention.py:79",
              paged_rows["paged_decode"], llm_launches["paged_decode"],
              shape="B32 H12 Hkv12 D64 bs16 len1024 float32",
              launches_in=f"the 64-request burst "
                          f"({llm['calls']['decode']} decode calls)",
              library=paged_lib,
              in_decode_step=llm["paged"].get("paged_decode"),
              http_launches=http_launches["paged_decode"],
              http_calls=http_llm["calls"]["decode"],
              mp_launches=_mp_launches(mp_llm, "paged_decode", "decode")),
        entry("paged_chunk", csrc + "paged_chunk.cu",
              "analytics_zoo_tpu/ops/paged_attention.py:134",
              paged_rows["paged_chunk"], llm_launches["paged_chunk"],
              shape="Tc256 start512 H12 Hkv12 D64 bs16 float32",
              launches_in=f"the 64-request burst "
                          f"({llm['calls']['prefill_chunk']} prefill chunks)",
              library=paged_lib,
              in_prefill_chunk=llm["paged"].get("paged_chunk"),
              http_launches=http_launches["paged_chunk"],
              http_calls=http_llm["calls"]["prefill_chunk"],
              mp_launches=_mp_launches(mp_llm, "paged_chunk",
                                       "prefill_chunk")),
        entry("flash_fwd_lse", csrc + "flash_fwd.cu",
              "analytics_zoo_tpu/ops/attention.py:307", ring_rows,
              ring_launches["flash_fwd_lse"],
              shape=f"B{RING['B']} H{RING['H']} "
                    f"T{RING['T'] // RING['sp']} D{RING['D']} float32 (one "
                    f"full ring block)",
              launches_in=f"4 ring_attention forwards + backwards at "
                          f"T{RING['T']} over {RING['sp']} shards (f32 and "
                          f"bf16, full and causal)",
              library="scaled_dot_product_attention, which returns no "
                      "log-sum-exp"),
        entry("flash_bwd_lse", csrc + "flash_bwd.cu",
              "analytics_zoo_tpu/parallel/ring.py:115 (_block_grads, jnp: "
              "no TPU kernel)", bwd_lse_rows,
              ring_launches["flash_bwd_lse"],
              shape=f"B{RING['B']} H{RING['H']} "
                    f"T{RING['T'] // RING['sp']} D{RING['D']} float32 (one "
                    f"full ring block, f32 accumulators)",
              launches_in=f"4 ring_attention forwards + backwards at "
                          f"T{RING['T']} over {RING['sp']} shards (f32 and "
                          f"bf16, full and causal)",
              library="backward of scaled_dot_product_attention on the "
                      "same block (forward + backward less forward)"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    return _finish(card)


def _mp_launches(report, kernel, call):
    """``{mp: {"launches": n, "calls": n}}`` of one kernel in the mp_llm
    phase's bursts, for the kernels line."""
    return {str(mp): {"launches": r["launches"][kernel],
                      "calls": r["calls"][call]}
            for mp, r in report.items() if mp > 1}


def _finish(card: str) -> int:
    """The card line(s) and, last, the result line."""
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
