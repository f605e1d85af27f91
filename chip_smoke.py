#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (nothing is caught):

1. card      — require CUDA; print the card's name and power limit
               (nvidia-smi) and switch TF32 off for matmul and cuDNN.
2. build     — compile every CUDA kernel of the port from its source with
               nvcc for sm_90a, all sources at once; print the seconds and,
               per instance of the flash-attention kernels (the forward,
               dK/dV and dQ: fp32 3xTF32, 16-bit wgmma and mma.sync
               m16n8k16), ptxas's registers, stack and spill bytes and the
               dynamic shared memory of a CTA, and any ptxas warning that
               names wgmma; fail if a wgmma forward instance spills.
3. kernel K1 — hold the conv-epilogue kernel against its plain PyTorch
               version on the card: ResNet-50 v1's own epilogue shapes at
               batch 8 and ragged ones; row, column and none modes; with
               and without a residual; all five activations; float32 and
               bfloat16. Per case: max error, tolerance, kernel and plain
               times (CUDA graphs of back-to-back launches over enough
               input copies to exceed the 50 MB L2, timed with CUDA events
               after warm-up) and the bytes bound at 3.35 TB/s.
4. serve     — full-width ResNet-50 v1 (224x224x3, 1000 classes, seeded
   ResNet      random weights and BatchNorm statistics) behind the port's
               Server on cuda:0, batch buckets 1-8, float32, serving from
               CUDA graphs: start() captures one predictor graph per
               bucket (ServerConfig.aot_prewarm) before traffic, and each
               graph's capture seconds and pool MiB are printed. 32
               single-image requests from 4 threads must all be answered;
               K1 must run 48 times per batch forward, counted across
               graph replays; the logits must match the same model and
               weights run on the CPU, and the graphed batch-8 logits the
               eager forward on the card within 1e-6 of max |value|. The
               profile times the eager forward, the graph's replay and
               both with the host copies, in turns, and profiles each:
               device ms, launches, busy share, host launch calls per
               forward; the graphed trace must hold K1's 48 launches.
5. kernel K2 — hold the matmul-epilogue kernel against its plain version
               on the card: BERT-base's own epilogue shapes at batch 8,
               sequence 128, and ragged ones; all five activations; column
               and row bias; dropout p in {0, 0.1, 0.5} with seeded bits;
               float32 and bfloat16. Per case as for K1, plus the time of
               torch.add(y, bias), the one PyTorch call that computes the
               identity case without dropout.
6. serve     — full-width BERT-base (bert_12_768_12 without the MLM
   BERT        decoder: 12 layers, 768 units, 3072 hidden, 12 heads, vocab
               30522, max_length 512, seeded Normal(0.02) weights) behind
               the Server on cuda:0, batch buckets 1-8, int32 token ids of
               128 per request, from CUDA graphs captured at start() as
               in phase 4. 32 requests from 4 threads must all be
               answered; K2 must run 25 times per batch forward (across
               replays); every output (seq_out, pooled, nsp) must match
               the same model and weights run on the CPU, and the graphed
               ones the eager forward on the card within 1e-6; profiled
               eager and graphed as in phase 4.
7. kernel K3 — hold the flash-attention kernel against its plain version
               on the card: the long-context slice's own call (q, k, v as
               strided views of a (4, 4096, 2304) fused QKV, 12 heads, D
               64), the contiguous [B, H, S, D] form, causal and not, S_q
               != S_kv both ways (causal S_q > S_kv gives zero rows, also
               beside non-empty rows in one CTA), ragged S (1025, 1100, 1,
               7; S_q 127, 128 and 129 against S_kv 1100, at the edge of a
               128-row CTA, and 63, 64 and 65, at that of a 64-row one),
               D 16, 40, 64, 80, 100, 128 and 256 (40 and
               100 causal and not), 3-D inputs, float32, bfloat16 and
               float16; tolerance 1e-5 (fp32) and 1e-2 (16-bit) of max
               |out|; the 16-bit error also against the plain version with
               round_to the input dtype and 128-key blocks (the function
               the 16-bit kernels compute: p rounded before p v), logged
               only. Times of the slice's call (CUDA events after warm-up)
               for the kernel, the plain version and torch's
               scaled_dot_product_attention (backend printed) per dtype:
               fp32 beside two operations bounds, fp32 on CUDA cores at 67
               TFLOP/s and 3xTF32 (three tf32 passes per product) at 495
               TFLOP/s; bf16 and fp16 beside the 16-bit tensor cores' 989
               TFLOP/s; the achieved TFLOP/s of the two products, the
               kernel's share of its bounds and its ratio to SDPA.
8. serve     — full-width BERT-base at S 4096 (bert_12_768_12 without the
   long BERT   MLM decoder, max_length 4096, seeded as in phase 6) behind
               the Server on cuda:0, batch buckets 1/2/4, int32 ids, from
               CUDA graphs captured at start() as in phase 4. 8
               requests from 4 threads must all be answered; per batch
               forward flash_attention must run 12 times and K2 25 times
               (across replays); seq_out, pooled and nsp of served
               requests 0 and 1 must match the same model and weights run
               on the CPU, and the graphed batch-4 outputs the eager
               forward on the card within 1e-6. The
               default deadline is raised to 10 s for this phase: a batch-4
               forward here takes about 160 ms on an H100 at 700 W, and a
               request may wait behind two of them.
9. kernel K3 — hold the flash-attention backward kernels (dK/dV and dQ)
   backward    against flash_attention_bwd_plain on the card, fed the
               kernel forward's out and row log-sum-exp: the slice's own
               call (gradients written into one fused (4, 4096, 2304)
               buffer), causal and not, S_q > S_kv (empty rows get zero
               gradients) and S_q < S_kv, ragged S, D 16, 32, 40, 64, 100,
               128 and 256 (40 and 100 causal and not), 3-D inputs,
               float32, bfloat16 and float16; tolerance 1e-4 (fp32) and
               2e-2 (16-bit) of each gradient's max |value|; the 16-bit
               error also against the plain version with round_to the
               input dtype (the function the 16-bit kernels compute: p
               and scale * ds rounded before the gradient products), logged
               only; the forward's lse against the plain forward's. Times
               of the slice's call (CUDA events after warm-up) for each
               kernel, the delta reduction, the plain version and the
               backward of scaled_dot_product_attention (kernel printed),
               per dtype. fp32 beside two operations bounds: fp32 on CUDA
               cores at 67 TFLOP/s, and 3xTF32 (three tf32 passes per
               product) at 495 TFLOP/s; bf16 and fp16 beside the 16-bit
               tensor cores' 989 TFLOP/s, each kernel against its own
               bound; the pair's TFLOP/s and its ratio to SDPA's backward.
10. kernel K2 — ffn_2's training call at (16384, 768) with dropout bits
    training    drawn on the card: bit-equal to the plain version on the
               same bits, keeping 1 - p within 1%; K2's backward against
               the plain version's autograd at ffn_1's and ffn_2's shapes
               (1e-5 of max |grad|).
11. train     — full-width BERT-base masked LM (bert_12_768_12 with
    long BERT   max_length 4096, no pooler or NSP classifier: the decoder
               over every position, vocab 30522, dropout 0.1) at batch 4,
               S 4096, fp32, through record -> SoftmaxCrossEntropyLoss ->
               autograd.backward -> Trainer("adam", lr 1e-4).step(4): 6
               steps on one seeded batch (labels = the ids, as
               examples/pretrain_bert.py), the first a warm-up. Per step
               flash_attention and each backward kernel must run 12
               times and K2 24 times; the losses must be finite and fall.
               Step time, sequences/s, tokens/s, peak memory, and one
               profiled step's device busy share and top kernels. Gate:
               one batch-1 step from the same weights on the card and on
               the CPU with the card's dropout bits replayed; the loss
               and the gradients of word_embed, the first and last
               cell's qkv and ffn_1 weights and the decoder's last Dense
               within 1e-3 of each one's max |value|. Then, after
               torch.cuda.empty_cache(), the model hybridized: 4 steps,
               the first capturing the forward graph (K2 with dropout
               bits drawn inside it, K3) and the backward graph (both K3
               backward kernels); launches counted across replays and the
               capture's warm-up passes; step ms, peak memory beside the
               eager peak, one profiled graphed step. Two consecutive
               steps must draw different masks and two replays after
               mx.random.seed equal ones; one graphed forward + backward
               recorded with a bits tape must equal an eager one
               replaying those bits: the loss and the six gradients
               within 1e-5 of max |value|.
12. kernel K1 — the conv epilogue under autograd at ResNet-50's own
    training   epilogue shapes at batch 128 (BatchNorm + relu in row mode
               with and without a residual, the residual-only form, one
               gelu case), float32 and bfloat16: the kernel-backed
               Function's output (bit-equal in float32) and its gradients
               dy, dscale, dbias, dres against the plain version's
               autograd (1e-5 of max |grad| in float32, 1e-2 in
               bfloat16); the forward + backward time of the 48
               epilogues of one training step beside its bytes bound.
13. train     — full-width ResNet-50 v1 (224x224x3, 1000 classes, Xavier
    ResNet      weights from SEED) at batch 128, fp32, TF32 off, through
               record -> SoftmaxCrossEntropyLoss -> autograd.backward ->
               Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4).step(128) on
               examples/train_imagenet.py's synthetic batch
               (RandomState(0): randn images, randint labels): 6 steps,
               the first a warm-up. Per step K1 must run 48 times and
               every other kernel 0; the losses must be finite and fall.
               Step time, images/s, peak memory, one profiled step's busy
               share and top kernels (K1's forward, the cuDNN
               convolutions), the step's fp32 FLOP (convolutions and
               Dense from their shapes, forward x 3) and its share of
               the 67 TFLOP/s peak. Gate: one batch-1 step from the same
               weights and running statistics on the card and on the
               CPU (the card's relu decisions and stem max pool choices
               replayed there: ReluTape, PoolTape); the loss, five
               gradients and two BatchNorms' running mean and var within
               1e-3 of each one's max |value|. Then net.hybridize() from the eager run's initial weights and
               running statistics with a fresh SGD: 6 graphed steps, the
               first capturing the forward graph (BatchNorm's running
               statistics updated in place in it, K1) and the backward
               graph; launches (48 K1 per step and per warm-up pass of
               the capture), step ms, images/s, peak memory, a profiled
               step's busy share. Last, with cuDNN deterministic, one
               graphed forward + backward from that initial state against
               an eager one: the loss, the five gradients and the two
               BatchNorms' statistics within 1e-4 of max |value|.
14. kernel    — K1 and K2 in bfloat16 at phase 15's shapes: the 48
    bf16        epilogues of a ResNet-50 forward at batch 256 and the 24
               of a BERT-base MLM training forward at batch 64, S 128
               (ffn_1 bias + gelu, ffn_2 bias + dropout 0.1), each held
               against its plain version (1e-2) and timed beside its
               bytes bound at 2-byte elements (K2's GB/s and share of the
               bound printed); torch.add(y, bias) beside ffn_2, the bias
               add alone (4 of K2's 5 bytes per element: no PyTorch call
               computes K2's function). (Phases 7 and 9 time K3 and its
               backward in bfloat16 and float16 too, beside
               scaled_dot_product_attention in the same dtype and the
               operations bound at the 16-bit tensor cores' 989 TFLOP/s.)
15. train-    — examples/train_imagenet.py and examples/pretrain_bert.py
    sharded     as written on one card: mx.parallel.ShardedTrainer(...,
               mesh=make_mesh({"data": 1, "model": 1}), compute_dtype=
               "bfloat16"), each step one CUDA graph replay (captured at
               the first step). (a) resnet50_v1, batch 256, SGD lr 0.1
               momentum 0.9 wd 1e-4, 6 steps, 48 K1 per step; (b)
               bert_12_768_12 MLM (vocab 30522, no pooler or classifier,
               dropout 0.1, Normal(0.02)), batch 64, S 128, Adam lr 1e-4,
               6 steps, 24 K2 per step; (c) the same at batch 4, S 4096,
               4 steps, 12 K3, 12 + 12 K3-bwd and 24 K2 per step. Seeded
               weights, RandomState(0) batches (the ids as labels), put
               on the card once. Per configuration: losses (finite,
               falling), median step ms after the capturing step,
               images/s or sequences/s and tokens/s, peak memory, graph
               pool and capture seconds, launches counted from 0 across
               the steps (per step x (steps + the capture's 2 warm-up
               passes)), and one profiled step's busy share, top kernels
               and host launch calls (1 required); for (c) the step time
               and K3's share of it in the profiled step. Gates: one graphed
               step against an eager one on the card from one state
               (cuDNN deterministic for (a), the graph's dropout bits
               replayed for (b) and (c)): the loss, the gated weights
               after the update and (a) two BatchNorms' statistics
               within 1e-5 of max |value|; one batch-1 bf16 step's loss
               and gradients through the trainer's differentiated
               function on the card and on the CPU from the same weights
               (the card's relu decisions or dropout bits replayed),
               within 3e-2 of max |value|; for (a) and (b), the bf16
               losses of the first 3 steps within 5% of the same
               trainer's fp32 ones (compute_dtype None, same weights and
               batch), whose step time is printed beside them.
16. train-   — (d) the BERT pretraining recipe on (b)'s model and batch
    recipe     (bert_12_768_12 MLM, batch 64, S 128, dropout 0.1, bf16
               compute, fp32 masters): LAMB lr 1e-4 wd 0.01 with
               PolyScheduler(max_update=1000, base_lr=1e-4, pwr=1,
               warmup_steps=10), wd multiplier 0 on every bias, gamma
               and beta (by trainable index), GuardConfig(clip_norm=1.0),
               steps taken as ShardedTrainer.run_steps(num_steps=8), each
               window one CUDA graph replay. The first window captures; 3
               timed windows with the launches counted from 0 (24 K2 per
               inner step, nothing else); the lrs each window's graph read
               must equal PolyScheduler's on the host; the losses finite
               and falling. Printed: window and per-step ms, tokens/s,
               capture s, pool, peak and reserved memory, one profiled
               window's busy share, host launch calls (1 graph launch plus
               the dropout generator's 2 fills required) and K2 launches,
               the update of one inner step alone (a CUDA graph of the
               trainer's _update, CUDA events) and its share of the
               window, and graphed step() ms beside run_steps. Gates: at
               dropout 0, run_steps(8) bit-equal to 8 graphed step() calls
               from one state; (d) at batch 1, card against CPU within
               3e-2 (the card's dropout bits replayed); for each of the 13
               optimizers with a functional rule, fp32 and bf16, one
               graphed step of an MLP bit-equal to an eager one (with a
               scheduler, wd, clip_gradient and multipliers); a guarded
               graphed step fed an Inf leaves weights, optimizer state and
               BatchNorm statistics bit-unchanged, journals
               nonfinite_grad, and the third in a row raises
               TrainingDiverged.
17. train-   — (e) the checkpoint family on (d)'s model, batch and
    checkpoint trainer: 4 run_steps(8) windows, each followed by
               checkpoint(keep_last=3) into build/chip_smoke_ckpt
               (removed at the end), K2 counted from 0 over windows 2-4
               (192 per window). Gates: a fresh trainer from another
               seed restores step 16 and its windows 3-4 (lrs
               PolyScheduler(t), t = 17..32) are bit-equal to the
               uninterrupted ones in the losses, every fp32 master
               weight and LAMB's m and v; the first trainer, which has
               captured, restores the newest step in place and its next
               window is bit-equal to the fresh trainer's window from
               that step, with the same program (no new capture); a
               byte flipped in the newest step's ckpt.states makes
               restore() fall back one step with a journaled
               ckpt_fallback; under GuardConfig(clip_norm=1.0,
               ckpt_root=, max_consecutive_skips=2) an inf written into
               a weight after a committed step makes the window skip and
               roll back to that step (divergence_rollback, lr_backoff
               0.5), the restored weights finite and the next window's
               lrs backed off. Printed: bytes per step directory, save
               seconds and GB/s, restore seconds (fresh and in place),
               the fresh trainer's capture seconds, the steps lost.
18. train-   — (f) ShardedTrainer(remat=) on (c) (examples/pretrain_
    remat      bert.py at --seq-length 4096 --batch-size 4: full-width
               BERT-base MLM, bf16 compute, fp32 masters, Adam) under
               remat None, "full", "dots" and "dots_no_batch", each
               trainer on a copy of one model. Per policy, from the same
               state and dropout seed: the capturing graphed step's loss,
               every fp32 master and Adam moment bit-equal to the
               remat=None step's; then 5 graphed steps timed (median),
               the launches counted from 0 over them: per step K3 12,
               K3-bwd 12 + 12 and K2 24 under None, and under remat K3 24
               and K2 48 (the recompute runs the hand-written kernels
               again: no selective policy sees a ctypes launch); one
               program; graphed equal to eager under remat (the graph's
               dropout bits replayed; 1e-5, bit-equality printed).
               Printed: step ms, tokens/s, capture seconds, graph pool
               and the peak over the capturing step (its 2 eager warm-up
               passes and the capture). Then (a), ResNet-50 v1 at batch
               256, one graphed step under "dots" against one under None
               from one state, cuDNN deterministic: the BatchNorm running
               statistics bit-equal (folded once: the fold waits for the
               recompute), the weights compared; capture, pool, peak and
               K1 launches printed.
19. serve-   — (g) hot reload. (d)'s trainer commits a checkpoint into
    reload     build/chip_smoke_reload (removed at the end) after each of
               3 run_steps(8) windows; a Server on cuda:0 serves, in fp32
               from CUDA graphs prewarmed at start() for buckets 1/2/4/8,
               the serve phase's BERT-base block if its parameters are a
               subset of the checkpoint's, else (as here: the trainer
               wraps its model as inner.*) the MLM block, with
               ParamStore(root) and reload_poll_s=0. 32-request bursts:
               A after the first commit, B with the second commit
               adopted between its batches (polling resumes once its
               first answer is out; the step loads on the server's
               loader thread while the worker answers, and B's rounds of
               32 follow each other until the worker has applied it), C
               after it; launches from 0 per burst (K2 the same count
               per batch forward, nothing else). Gates: A's and C's answers carry the newest step
               and requests 0-1 match the CPU's forward with that step's
               weights within 1e-3 of max |value| (TF32 off); B's steps
               rise once, in serving order; a byte flipped in the third
               step's ckpt.params is skipped (ckpt_fallback, corrupt_seen
               1) and the server stays; a committed narrower BERT
               journals serving_reload_failed with no parameter changed;
               pin_params(first step) rolls the server back at its next
               turn (8 answers checked against the CPU), unpinning brings
               the newest valid step back; 4 reloads in all, and no
               graph captured after prewarm. Printed: each reload's
               validate-and-load and check-and-copy seconds and bytes,
               p50/p99 of the bursts with and without a reload, K2 per
               served forward.
20. serve-   — (h) the replica tier. Two LocalReplicas r0 and r1, each a
    pool       Server of phase 6's full-width BERT-base (S 128, int32
               ids, fp32, buckets 1/2/4/8 prewarmed, TF32 off, a TinyLM
               decode engine with 8 slots) on cuda:0 whose ParamStore
               reads committed step 1 of one seeded set of weights from
               build/chip_smoke_pool (removed at the end), in a
               ReplicaPool (heartbeat 0.25 s, deadline 2 s, monitor
               0.25 s) behind a Router (3 retries). Burst 1: 64 requests
               from 8 threads through Router.call, both replicas
               answering, every answer (16 distinct sequences) within
               1e-3 of max |value| of the CPU forward, K2 25 times per
               batch forward across replays and nothing else; p50/p99
               and sequences/s printed beside phase 6's one server.
               Burst 2: with monitor_start(), r1.kill() after 8 answers;
               the clients go on until the monitor has journaled
               replica_lost (idle within deadline + 2 monitor intervals)
               and r1's fresh Server, built and captured on the monitor's
               thread while r0 serves, is ready; every request answered,
               r0 answering while r1 captures, r0 capturing nothing;
               respawn seconds, p99 and peak memory printed. Burst 3:
               step 2 (each weight times a seeded factor in [0.9, 1.1])
               committed and pool.reload(surge=1) rolled under load;
               every request answered with step 1 or 2 and checked
               against the CPU under its step; both beacons at step 2
               after it. The reload and phase 21 route through a Router
               whose breakers open on heartbeat stalls only: the
               reference's router counts a draining replica's
               ServerStopped and a full one's SlotsExhausted as failures,
               and with two replicas and breaker_k 3 a roll sheds once
               the first restarted replica's breaker has opened. Then
               two ProcReplica workers (python -m
               mxnet_tpu_torch.serving worker --model mlp --dim 64, each
               its own process and CUDA context, loading the kernels
               phase 2 built) behind a router: 64 requests within 1e-5
               of max |value| of the CPU mlp, K2 once per batch forward
               in each worker (its stats frames), no worker building a
               kernel; one worker SIGKILLed in a burst and respawned by
               the monitor with every request answered; seconds to
               ready printed.
21. serve-   — (i) continuous-batching decode beside BERT-base on (h)'s
    decode     replicas: 64 TinyLM streams (seeded prompts of 1-200
               tokens, max_new_tokens 1-56) from 8 threads on r0's
               engine while 64 BERT requests go through the router;
               every stream's tokens equal TinyLM.reference, the engine
               holds 7 programs (1 step, 6 prefill chunk buckets, CUDA
               graphs captured at start()) after the streams as after
               warmup(); steps, tokens/s, step p50/p99 and the BERT
               burst's p99 printed. A stream cancelled mid-decode and
               one with a 1 ms deadline end in RequestError and
               DeadlineExceeded (not retryable) and the next 8 streams
               are exact. With r0's 8 slots held by long streams and
               queue_on_busy=False on both engines, 24 concurrent
               streams through Router.decode_call each finish exactly
               (some on r1 after SlotsExhausted on r0) or end in
               SlotsExhausted / ServerOverloaded.
22. trace    — span tracing (mxnet_tpu_torch.observability). (a) phase
               6's burst (full-width BERT-base, S 128, 32 requests from 4
               threads) in rounds under MXNET_TPU_TRACE off, ring and
               journal: sequences/s, p50 and p99 per mode, K2 25 launches
               per batch forward in each (and the same count in each for
               4 batches of 8 sent one at a time), every answer within
               1e-5 of max |value| of the first burst's. (b) every answered request of the ring and journal
               bursts owns a serving_request tree (enqueue, execute,
               respond) under its batch, and no execute span is shorter
               than its predictor graph's replay timed with CUDA events.
               (c) the BERT-base MLM at batch 8, S 128, bf16 through
               ShardedTrainer: 4 graphed steps off, then 4 under journal,
               each under torch.cuda.set_sync_debug_mode("warn"): the same
               number of synchronizing calls, one
               sharded_trainer.compiled_step span per step and one
               mxnet_tpu_xla_compiles_total per capture. (d) a traced pod
               (MXNET_TPU_TRACE=journal, PoolConfig(trace_dir=)): 64
               requests from 8 clients through a Router over two
               BERT-base LocalReplicas of phase 6's weights (phase 21
               stops phase 20's pool), split per request into router,
               queue wait, execute and respond; then two ProcReplica mlp
               workers, one SIGKILLed mid-burst and respawned; the run
               directory merged by observability.aggregate: one trace_id
               in the router's journal and a worker's, the killed worker's
               flight dump read back, and critical paths printed span by
               span.
23. serve-   — (k) the tenant fleet. One Fleet on cuda:0 (buckets 1-8,
    fleet      int32 ids, S 128, max_hot_tenants 2) serving three
               full-width BERT-base tenants registered with block=:
               bert_a and bert_b (fp32, seeds SEED+23 and SEED+24, each
               on its own commit root, step 1) and bert_bf16 (seed
               SEED+25, cast by contrib.amp.convert_hybrid_block to
               bfloat16, SLO silver). 96 requests in rounds of 16 (4
               threads) ordered a, b, bf16, a, b, bf16, so the LRU pages
               in 6 times: every answer within 1e-3 of max |value| of
               its tenant's weights run on the CPU in fp32 (bert_bf16:
               3e-2 of the CPU's bf16 run of its cast weights, the
               same function; its errors against fp32 runs of the cast
               and the pre-cast weights printed), no batch
               mixing tenants (the serving_batch records' tenant counts),
               K2 25 per batch forward and per warm-up pass of each
               capture. Per page-in its cost (the copy back, the reload,
               the first batch's capture), capture seconds and bytes; per
               page-out its ms, bytes and the bytes
               torch.cuda.memory_allocated() got back (>= 0.9 of the
               tenant's parameters), and the memory beside the hot
               tenants' parameters after each page-out within 64 MiB of
               the first's; hot batches' exec_ms p50/p99. Then a fault
               hook raises at bert_b's serving_tenant seam for 3
               batches: bert_b is quarantined (TenantQuarantined, not
               retryable, at admission) while bert_a and bert_bf16
               requests are all answered and right; after the 1 s
               cooldown one probe re-admits it. A step 2 committed to
               bert_a's root (one encoder layer x 1.1) and
               reload_tenant("bert_a"): answers stamped 2 match the CPU
               with step 2, bert_b stamps 1. metrics_text holds the
               three tenant families; serving_report's page-ins,
               page-outs and quarantines equal tenant_stats().
24. serve-   — (l) canary deployment. Two LocalReplicas of full-width
    deploy     BERT-base's encoder (S 128, the sequence output only: the
               router's mirror compares one array; 24 K2 per forward)
               over one commit root behind the Router, 4 client threads
               through both deploys. The mirror's tolerance comes from
               the largest difference of one sequence served from
               different buckets with equal weights (16x it, at most
               1e-3 of max |value|, rtol 0). DeployConfig(canary_k=1,
               window_s=1.0, promote_after=2, min_samples=20,
               mirror_fraction=0.25): step 2 (step 1's values) is
               promoted, pool.reload() mid-canary raises
               DeployInProgress, every answer stamped 1 or 2 and within
               1e-3 of the CPU's; step 3 (one encoder layer x 1.5,
               CRC-valid) is rolled back on parity, the canary ends on
               step 2 with its pin installed, step-3 answers only from
               the canary and equal to the CPU's with step 3's weights,
               none lost. Seconds to promote and to roll back, the gate
               evaluations, canary and control p99 printed.
25. layers   — every nn layer, contrib.nn block and loss of the rest of
               Gluon (transposed convolutions with output_padding and
               groups, Conv1D/3D, the 1-D and 3-D pools in ceil mode and
               without counting padding, the global max pools,
               ReflectionPad2D, GroupNorm, InstanceNorm, SyncBatchNorm,
               each LeakyReLU mode, PReLU, ELU, SELU, Swish, Lambda,
               HybridLambda, the ten losses, CTCLoss with lengths and
               with padded labels) on cuda:0 against the same module on
               the CPU under record(): outputs, input and parameter
               gradients and running statistics within 1e-5 of max
               |value| (fp32, TF32 off, cuDNN deterministic). The DCGAN
               generator and discriminator and the VAE, built as
               examples/train_dcgan.py and train_vae.py build them, one
               Adam step each through gluon.Trainer: losses and
               gradients within 1e-5, then the weights after the CPU's
               step from the card's gradients. clip_global_norm on
               device tensors: 1 host read with check_isfinite, 0
               without (set_sync_debug_mode counts).
26. serve-   — (m) one full-width model of each vision family behind the
    zoo        Server on cuda:0 (resnet50_v2, vgg16, alexnet,
               densenet121, mobilenetv2_1.0, squeezenet1.1 at 224x224x3,
               inceptionv3 at 299x299x3; 1000 classes, fp32, seeded
               Xavier weights and BatchNorm statistics), buckets 1-8
               captured at start(): 16 requests from 4 threads answered,
               K2 2 per batch forward in vgg16 and alexnet (fc6, fc7) and
               0 elsewhere, K1 0; requests 0 and 1 against the CPU (1e-3
               of max |value|), the graphed batch-8 logits against the
               eager forward (1e-6); images/s, p50/p99, capture and pool
               per bucket, peak memory, the graphed forward's device ms
               and busy share; each model freed before the next, its
               memory back within 64 MiB (cuBLAS workspaces cleared).
27. train-   — (n) examples/train_imagenet.py's configuration (batch 256,
    zoo        224x224, the RandomState(0) batch, SGD lr 0.1 momentum 0.9
               wd 1e-4, ShardedTrainer(compute_dtype="bfloat16") on the
               {"data": 1, "model": 1} mesh) for --network
               mobilenetv2_1.0 and vgg16_bn: 6 graphed steps (losses
               finite and falling, K2 2 per step for vgg16_bn and 0 for
               MobileNetV2, step ms, images/s, peak memory, pool, capture
               s, a profiled step); a graphed step against an eager one
               (cuDNN deterministic, 1e-5); a batch-1 bf16 step against
               the CPU (3e-2) with the card's relu and relu6 decisions,
               max pool windows and every convolution's, BatchNorm's and
               K2's output replayed; 3 eager bf16 steps against 3 fp32
               ones on the same dropout bits (5%).
28. nd      — mx.nd on the card. (a) every registered operator name (300)
               through its mx.nd wrapper on cuda:0 against the same call
               on the CPU, with the inputs and per-op tolerances of
               tools/nd_op_cases.py (the CPU tests' table: exact, 1e-6 of
               max |value|, 1e-5 relative, 1e-4 for the inverse and the
               triangular solve), TF32 off; the samplers by their
               moments on the card. The whole phase runs with cuDNN
               deterministic. (b) at full width,
               each output bit-equal to the port's ops call on the same
               inputs and its kernel's launches counted:
               nd.contrib.flash_attention at batch 4, 12 heads, S 4096,
               D 64, fp32 and bf16, forward (K3 1) and backward under
               record() (K3-bwd 1 + 1); nd.contrib.matmul_epilogue on
               (1024, 3072) gelu with dropout 0.1 in training, the same
               seeded bits (K2 1); nd.BatchNorm(act_type="relu") and
               nd.contrib.conv_epilogue at (8, 64, 112, 112) (K1 1 each).
               (c) full-width ResNet-50 v1 hybridized, called with an
               nd.array batch of 8: NDArray logits bit-equal to the
               tensor call, 48 K1 per forward. (d) examples/train_dcgan.py
               (200 steps) and train_vae.py (400 steps) at their defaults
               with the port's mx, hybridized (CUDA graphs): the gates of
               tests/test_examples.py (L1 < 0.12 and both losses > 0.05;
               rec < 0.05, 0.5 < KL < 100, prior L1 < 0.1) and ms per
               step.
29. item 6   — the rest of mx.nd, cuDNN deterministic. (k) K2 at BERT's
               ffn_1 shape (16384, 3072) and K1 at a ResNet-50 BatchNorm
               shape (128, 64, 112, 112) with the vectors at another dtype
               than y's ((bf16, fp32), (fp16, fp32), (fp32, bf16)): each
               bit-equal to its plain version, timed against its bytes
               bound. (a1) the BERT-base MLM of phase 11 (batch 4, S 4096,
               eager Adam lr 1e-4) 3 steps under amp.init("bfloat16",
               target_precision_ops=["FullyConnected", "Convolution"])
               with amp.init_trainer and amp.scale_loss, then 3 steps in
               fp32 from the same state with the same dropout bits: every
               Dense output bf16, the loss and the weights fp32, per step
               K2 24 (bf16 y, fp32 bias), K3 12 and K3-bwd 12 + 12 (bf16);
               each step's loss within 2e-2 of fp32's and the weights'
               change within 0.5 (rel L2 over all weights). (a2) the same
               for ResNet-50 v1 at batch 128 with SGD (K1 48 per step,
               BatchNorm's scale and offset in y's dtype as the JAX op
               casts them). (b) a hybridized foreach (an Elman cell,
               Dense(768, tanh), T 32, batch 64; K2 32 per forward)
               trained 3 Adam steps as CUDA graphs and eagerly, bit-equal,
               both within 1e-4 of max |value| of the CPU; a greedy decode
               through while_loop (max_iterations 8, EOS at step 5) and a
               cond, captured, equal to eager. (c) Embedding(500000, 64,
               sparse_grad=True) -> Dense(256, relu) -> Dense(64), L2,
               Adam, 20 steps of 8192 ids: untouched rows bit-unchanged,
               touched rows within 1e-5 of the CPU run (the card's relu
               decisions replayed), ms per step against sparse_grad=False.
               (d) every case of tools/np_cases.py (mx.np, linalg, fft,
               mx.npx) on the card against the CPU; a CustomOp forward and
               backward on card tensors; Custom refused inside a capture.
30. symbol   — mx.sym, mx.mod and export (item 7a). (a) phase 4's
               ResNet-50 v1 exported (HybridBlock.export, traced on meta
               tensors) and served by Server.from_checkpoint from CUDA
               graphs captured at start(), buckets 1-8: 32 requests from 4
               threads, K1 48 per batch forward across replays, logits
               within 1e-6 of max |value| of the hybridized Gluon net's on
               the card and 1e-3 of the CPU's; images/s and p50/p99
               beside phase 4's. (b) BERT-base (no decoder) exported,
               imported by SymbolBlock.imports and hybridized, at batch 4,
               S 4096: K3 12 and K2 25 launches per forward, the Gluon
               model's; outputs within 1e-6 of max |value| of its. (c)
               batch_dot(softmax(batch_dot(q, k^T) * 0.125), v) at q, k, v
               (48, 4096, 64) fp32 bound with and without
               MXNET_SUBGRAPH_BACKEND=FuseAttention: one K3 launch, within
               1e-5 of max |out| of the unfused graph, both timed with CUDA
               events. (d) Module.fit of (a)'s symbol + SoftmaxOutput over
               examples/train_imagenet.py's synthetic batch at batch 64,
               fp32, SGD lr 0.01 momentum 0.9, 2 epochs of 4 batches with
               checkpoint_prefix and keep_last=1: one step's parameter
               changes (lr 0.1) within 1e-3 of each tensor's max |change|
               of gluon.Trainer's from the same state and batch (cuDNN
               deterministic), 48 K1 per training forward, finite losses,
               step ms, host launch calls per step, and fit(resume=True)
               restoring every parameter bit for bit. (e)
               examples/train_mnist.py --module as written (lenet_symbol,
               the synthetic stand-in, batch 128, 3 epochs, lr 0.05,
               Speedometer), then score: accuracy >= 0.99.

Each serve phase sets the launch counts to 0 just before its burst and
reads them just after, and each training phase just before its steps
(eager, then graphed; phase 15 per configuration; phases 16 and 17
after the capturing window; phase 18 per policy after the capturing
step; phase 19 per burst; phase 20 per burst, in a worker from its
stats frames; phase 21 over the decode streams and the BERT burst
beside them; phase 22 per burst and per mode; phase 23 over the fleet
burst; phase 24 over the good deploy's traffic; phase 26 per model's
burst; phase 27 per network before its graphed steps; phase 28 per mx.nd
call; phase 30 per burst, per forward and over Module.fit's steps after
the capturing one). A graph's replay
calls no kernel wrapper: each replay adds the launches its capture
recorded (mxnet_tpu_torch/gluon/cached_graph.py,
mxnet_tpu_torch/parallel/sharded.py), so the counts stay the kernels the
card ran.
The line before the last lists every kernel as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside this file, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
FP32_OPS_PER_S = 67e12               # H100 SXM float32 outside tensor cores
TF32_OPS_PER_S = 495e12              # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12              # H100 SXM bf16 tensor cores, dense
BATCH = 8
SEED = 0
N_REQUESTS = 32
LOGIT_RTOL = 1e-3                    # of max |output|, TF32 off
BERT_SEQ = 128                       # benchmarks/bert.py's sequence length
BERT_VOCAB = 30522
BERT_K2_PER_FORWARD = 25             # ffn_1 and ffn_2 of 12 cells, pooler
LONG_SEQ = 4096                      # benchmarks/long_context.py's rung
LONG_BATCH = 4
LONG_HEADS = 12
LONG_K3_PER_FORWARD = 12             # one flash attention per cell
LONG_REQUESTS = 8
LONG_CHECKED = (0, 1)                # served requests held against the CPU
LONG_DEADLINE_MS = 10000.0
GRAPH_RTOL = 1e-6                    # graphed vs eager on the card, of max


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# -- phase 1: card -----------------------------------------------------------
def phase_card(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


# -- phase 2: build ----------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    outputs = _build.build_all()
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
    regs, spills = [], 0
    for text in outputs.values():
        for line in text.splitlines():
            if "Used" in line and "registers" in line:
                regs.append(int(line.split("Used")[1].split()[0]))
            if "spill stores" in line:
                spills += int(line.split("bytes spill stores")[0]
                              .split()[-1])
    log(f"build: {list(_build.SOURCES)} in {secs:.2f} s with "
        f"{os.path.basename(_build.nvcc_path())} (sm_90a); kernels "
        f"compiled {len(regs)}, max registers {max(regs, default=0)}, "
        f"spill-store bytes {spills}")
    ptxas_report(outputs)
    return secs


_FA_KERNEL = re.compile(r"flash_attention_(bwd_dkv_|bwd_dq_|fwd_|)"
                        r"(mma16_|wgmma_|)kernelI"
                        r"(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?Lb([01])E")
_FA_DTYPES = {"f": ("float32", 0), "13__nv_bfloat16": ("bfloat16", 1),
              "6__half": ("float16", 2)}


def ptxas_instances(outputs):
    """{(which, design, dtype, D, causal): {"regs", "stack", "spills"}}
    for each instance of the flash-attention kernels in nvcc's output
    (``which`` "" or "fwd_" for the forward, "bwd_dkv_" or "bwd_dq_";
    the forward's mma.sync instance has D 256 in its tiles, not in its
    name), and the ptxas warnings that name wgmma."""
    found, warnings = {}, []
    for source in ("flash_attention", "flash_attention_bwd"):
        current = None
        for line in outputs.get(source, "").splitlines():
            if "wgmma" in line and "warning" in line.lower():
                warnings.append(line.strip())
            m = _FA_KERNEL.search(line)
            if m and ("Compiling entry" in line
                      or "Function properties" in line):
                which, design, dt, dp, causal = m.groups()
                current = (which, design, dt, dp or "256", causal)
                found.setdefault(current, {})
            elif current is None:
                continue
            elif "spill stores" in line:
                found[current]["stack"] = int(line.split()[0])
                found[current]["spills"] = int(
                    line.split("bytes spill stores")[0].split()[-1])
            elif "Used" in line and "registers" in line:
                found[current]["regs"] = int(
                    line.split("Used")[1].split()[0])
    return found, warnings


def ptxas_report(outputs):
    """One line per instance of the flash-attention kernels (the forward,
    dK/dV and dQ): ptxas's registers and spill bytes, and the dynamic
    shared memory of one CTA from the libraries' own size queries. Fails
    if a wgmma forward instance spills."""
    import ctypes
    from mxnet_tpu_torch.kernels import _build
    fwd = _build.load("flash_attention").flash_attention_smem_bytes
    fwd.argtypes = [ctypes.c_int] * 2
    fwd.restype = ctypes.c_longlong
    bwd = _build.load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    bwd.argtypes = [ctypes.c_int] * 3
    bwd.restype = ctypes.c_longlong
    for source in ("flash_attention", "flash_attention_bwd"):
        if not outputs.get(source):
            log(f"ptxas: {source} was not rebuilt in this run")
    found, warnings = ptxas_instances(outputs)
    for line in warnings:
        log(f"ptxas warning: {line}")
    spilled = []
    for (which, design, dt, dp, causal), info in sorted(found.items()):
        name, code = _FA_DTYPES[dt]
        smem = fwd(code, int(dp)) if which in ("", "fwd_") else bwd(
            0 if which == "bwd_dkv_" else 1, code, int(dp))
        log(f"ptxas: flash_attention_{which}{design}kernel<{name}, D {dp}, "
            f"causal {causal}>: {info.get('regs')} registers, "
            f"{info.get('stack')} bytes stack frame, {info.get('spills')} "
            f"spill-store bytes, {smem} bytes of "
            "dynamic shared memory per CTA")
        if which == "fwd_" and design == "wgmma_" and info.get("spills"):
            spilled.append(f"{name} D {dp} causal {causal}")
    if any(w == "fwd_" for w, *_ in found) and not any(
            w == "fwd_" and d == "wgmma_" for w, d, *_ in found):
        fail("ptxas: no wgmma forward instance in the build output")
    if spilled:
        fail(f"ptxas: the wgmma forward spills in {spilled}")
    return found


# -- phase 3: kernel K1 ------------------------------------------------------
def resnet50_epilogues(batch):
    """(name, shape, vectors?, residual?) of the 48 conv-epilogue calls of
    one ResNet-50 v1 forward at 224x224: per bottleneck two BatchNorm+relu
    (row mode over NCHW) and one residual add+relu (no vectors)."""
    calls = []
    for stage, (blocks, channels, side) in enumerate(
            [(3, 256, 56), (4, 512, 28), (6, 1024, 14), (3, 2048, 7)], 1):
        for b in range(blocks):
            for k in (1, 3):
                calls.append((f"s{stage}.{b}.bn{k}_relu",
                              (batch, channels // 4, side, side), True,
                              False))
            calls.append((f"s{stage}.{b}.residual_relu",
                          (batch, channels, side, side), False, True))
    return calls


def _bytes(shape, dtype_size, vectors, with_res, channels):
    n = math.prod(shape)
    return dtype_size * (n * (2 + int(with_res))
                         + (2 * channels if vectors else 0))


_ACT_OPS = {"identity": 0, "relu": 1, "gelu": 8, "tanh": 6, "sigmoid": 4}


def bound_ms(shape, dtype_size, vectors, with_res, channels, act):
    """The larger of bytes / HBM rate and operations / fp32 rate, in ms;
    returns (ms, "bytes" or "operations")."""
    n = math.prod(shape)
    by = _bytes(shape, dtype_size, vectors, with_res, channels) \
        / HBM_BYTES_PER_S
    ops = n * (2 * int(vectors) + int(with_res) + _ACT_OPS[act]) \
        / FP32_OPS_PER_S
    return (by * 1e3, "bytes") if by >= ops else (ops * 1e3, "operations")


def graph_ms(torch, launch, n_copies, reps=5):
    """Device time of one ``launch(i)`` (i cycles over the input copies),
    from CUDA graphs of back-to-back launches timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(3, n_copies)):       # warm-up
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    n_launch = max(n_copies, 32)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_launch):
            launch(i % n_copies)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n_launch)
    del graph
    return ms


def run_case(torch, ce, case):
    name, shape, axis, vectors, with_res, act, dtype = case
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    channels = shape[axis]
    esize = torch.tensor([], dtype=dtype).element_size()
    per_launch = _bytes(shape, esize, vectors, with_res, channels)
    n_copies = max(1, min(64, math.ceil(160e6 / per_launch)))

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    xs = [rnd(*shape) for _ in range(n_copies)]
    rs = [rnd(*shape) for _ in range(n_copies)] if with_res else None
    s = (torch.rand(channels, generator=gen, device=dev) + 0.5).to(dtype) \
        if vectors else None
    b = rnd(channels, scale=0.1) if vectors else None
    with torch.inference_mode():
        got = ce.fused_conv_epilogue(xs[0], s, b, rs[0] if rs else None,
                                     channel_axis=axis, act_type=act)
        want = ce.fused_conv_epilogue_plain(xs[0], s, b,
                                            rs[0] if rs else None,
                                            channel_axis=axis, act_type=act)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * want.float().abs()).all()) \
            and got.shape == want.shape and got.dtype == want.dtype
        k_ms = graph_ms(torch, lambda i: ce.fused_conv_epilogue(
            xs[i], s, b, rs[i] if rs else None, channel_axis=axis,
            act_type=act), n_copies)
        p_ms = graph_ms(torch, lambda i: ce.fused_conv_epilogue_plain(
            xs[i], s, b, rs[i] if rs else None, channel_axis=axis,
            act_type=act), n_copies)
    bnd, by = bound_ms(shape, esize, vectors, with_res, channels, act)
    mode = "none" if not vectors else (
        "col" if axis in (-1, len(shape) - 1) else "row")
    log(f"  {name:24s} {str(tuple(shape)):22s} {mode:4s} "
        f"res={int(with_res)} {act:8s} {str(dtype)[6:]:8s} "
        f"max_err={err:.3e} tol={tol:g} kernel_ms={k_ms:.6f} "
        f"plain_ms={p_ms:.6f} bound_ms={bnd:.6f} ({by}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"conv_epilogue disagrees with its plain version on {name} "
             f"{tuple(shape)} {act} {dtype}: max_err {err} > tol {tol}")
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd,
            "bound_by": by}


def phase_kernel_k1(torch, ce):
    log("kernel: conv_epilogue vs its plain version on the card")
    calls = resnet50_epilogues(BATCH)
    if len(calls) != 48:
        fail(f"expected 48 epilogue calls per forward, listed {len(calls)}")
    per_shape = {}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, vectors, with_res in calls:
            key = (shape, vectors, with_res, dtype)
            if key not in per_shape:
                per_shape[key] = run_case(torch, ce, (
                    name, shape, 1, vectors, with_res, "relu", dtype))
    # ragged shapes, every mode, residual or not, every activation
    ragged = [("ragged_row", (3, 5, 7, 11), 1, True),
              ("ragged_col", (77, 13), -1, True),
              ("ragged_none", (1, 2048, 7, 7), 1, False),
              ("batch1_bn_row", (1, 512, 7, 7), 1, True)]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for act in ("identity", "relu", "gelu", "tanh", "sigmoid"):
            for name, shape, axis, vectors in ragged:
                for with_res in ((False, True) if vectors else (True,)):
                    r = run_case(torch, ce, (name, shape, axis, vectors,
                                             with_res, act, dtype))
                    errs[dtype] = max(errs[dtype], r["err"])
    f32 = [per_shape[(shape, v, res, torch.float32)]
           for _, shape, v, res in calls]
    bf16 = [per_shape[(shape, v, res, torch.bfloat16)]
            for _, shape, v, res in calls]
    results["ms"] = sum(r["ms"] for r in f32)
    results["plain_ms"] = sum(r["plain_ms"] for r in f32)
    results["bound_ms"] = sum(r["bound_ms"] for r in f32)
    results["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in f32) else "operations"
    results["max_abs_err"] = max(r["err"] for r in f32)
    results["max_abs_err_bf16"] = max(max(r["err"] for r in bf16),
                                      errs[torch.bfloat16])
    results["max_abs_err_ragged_fp32"] = errs[torch.float32]
    total_bytes = sum(_bytes(shape, 4, v, res, shape[1])
                      for _, shape, v, res in calls)
    log(f"kernel: one ResNet-50 forward at batch {BATCH}, float32, 48 "
        f"launches: kernel {results['ms']:.6f} ms, plain "
        f"{results['plain_ms']:.6f} ms, bound {results['bound_ms']:.6f} ms "
        f"({total_bytes / 1e9:.4f} GB at 3.35 TB/s)")
    return results


# -- serving helpers ---------------------------------------------------------
def burst(server, payloads, indices, n_threads):
    """Submit ``payloads[indices]`` from ``n_threads`` threads, each
    submitting its share at once, and wait for every answer. Returns
    ({index: answer}, wall seconds); fails unless all are answered."""
    results, errors = {}, []

    def client(idx):
        try:
            pending = [(i, server.submit(payloads[i])) for i in idx]
            for i, p in pending:
                results[i] = p.result(120)
        except Exception as exc:      # reported below, then fail
            errors.append(repr(exc))

    indices = list(indices)
    threads = [threading.Thread(target=client, args=(indices[k::n_threads],))
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) \
            or len(results) != len(indices):
        fail(f"serving failed: {len(results)} of {len(indices)} answered; "
             f"errors {errors}")
    return results, wall


def serve_burst(torch, server, payloads, per_forward, card, unit,
                n_requests=N_REQUESTS, max_batch=BATCH):
    """Warm every batch bucket on the server's worker thread (it keeps
    its own per-thread cuDNN and cuBLAS state), then serve ``n_requests``
    from 4 threads with the launch counts set to 0 just before and read
    just after. ``per_forward`` maps each kernel of the path to the
    launches it must make per batch forward."""
    from mxnet_tpu_torch import kernels
    b = max_batch
    while b >= 1:
        burst(server, payloads, range(b), 1)
        b //= 2
    # one full batch at a time: the predictor call on the worker thread
    # with no other request in flight, beside the burst's below
    server.exec_ms.reset()
    for k in range(n_requests // max_batch):
        burst(server, payloads, range(max_batch * k, max_batch * (k + 1)),
              1)
    alone = server.exec_ms.summary()
    _sync(torch)
    before = server.stats()
    server.latency.reset()
    server.exec_ms.reset()
    kernels.reset_launch_counts()
    results, wall = burst(server, payloads, range(n_requests), 4)
    launches = kernels.launch_counts()
    after = server.stats()
    server.stop()
    batches = after["batches"] - before["batches"]
    if after["served"] - before["served"] != n_requests:
        fail(f"only {after['served'] - before['served']} of {n_requests} "
             "requests answered")
    for kernel, n in per_forward.items():
        if launches[kernel] != n * batches:
            fail(f"{kernel} launched {launches[kernel]} times for {batches} "
                 f"batch forwards (want {n} each)")
    counted = ", ".join(f"{k} launches {launches[k]} (= {n} x {batches})"
                        for k, n in per_forward.items())
    lat, ex = after["latency_ms"], after["exec_ms"]
    log(f"serve: {n_requests} requests (4 threads, each submitting "
        f"{n_requests // 4} at once) answered in {batches} batches, "
        f"{counted}; latency p50 {lat['p50']:.3f} ms, p99 "
        f"{lat['p99']:.3f} ms; {n_requests / wall:.2f} {unit}/s "
        f"({wall * 1e3:.3f} ms wall) on {card}")
    log(f"serve: predictor call per batch (worker thread): p50 "
        f"{ex['p50']:.3f} ms, max {ex['max']:.3f} ms over {ex['count']} "
        f"batches in the burst; one batch at a time p50 "
        f"{alone['p50']:.3f} ms, max {alone['max']:.3f} ms over "
        f"{alone['count']} batches")
    return [results[i] for i in range(n_requests)], launches, {
        "p50": lat["p50"], "p99": lat["p99"],
        "per_s": n_requests / wall, "wall_s": wall}


def check_against_cpu(name, served, ref):
    """Fail unless ``served`` is finite, of ``ref``'s shape and within
    LOGIT_RTOL of max |ref| of ``ref``."""
    import numpy as np
    if served.shape != ref.shape or not np.isfinite(served).all():
        fail(f"{name} has shape {served.shape} (want {ref.shape}) or is "
             "not finite")
    scale = float(np.abs(ref).max())
    err = float(np.abs(served - ref).max())
    log(f"serve: {name} vs the CPU run: max abs err {err:.6e}, max |value| "
        f"{scale:.6e}, relative {err / scale:.3e} (tolerance {LOGIT_RTOL:g} "
        f"of max |value|, TF32 off)")
    if not err <= LOGIT_RTOL * scale:
        fail(f"served {name} differs from the CPU run by {err} > "
             f"{LOGIT_RTOL} x {scale}")


def report_prewarm(server, card):
    """Fail unless start() captured one CUDA graph per batch bucket
    before traffic; print each predictor's capture seconds and pool."""
    warm = server.stats()["prewarm"]
    entries = server.cache.entries()
    if not warm or warm["warmed"] != len(server.grid.batch_buckets) \
            or warm["compiled"] != warm["warmed"] \
            or not all(pred.ready for _, pred in entries):
        fail(f"prewarm {warm} did not capture every batch bucket")
    log(f"serve: prewarm {warm} (one CUDA graph per batch bucket, captured "
        f"by start() before traffic) on {card}")
    per = {}
    for (bucket, key, _), pred in entries:
        mib = None if pred.pool_bytes is None else pred.pool_bytes / 2**20
        per[bucket] = {"capture_s": pred.capture_s, "pool_mib": mib}
        log(f"serve: graph of bucket {bucket} x {key}: capture "
            f"{pred.capture_s:.3f} s (warm-up and capture), pool "
            f"{'not measured' if mib is None else f'{mib:.1f} MiB'}")
    return per


def graphed_vs_eager(torch, server, net, x, names):
    """The server's graphed predictor at ``x``'s padded shape against the
    eager forward of the same block on the card: each output within
    GRAPH_RTOL of its max |value|. Returns the worst relative error."""
    key = (x.shape[0], tuple(x.shape[1:]), x.dtype.str)
    pred = dict(server.cache.entries())[key]
    got, _ = pred(x)
    with torch.inference_mode():
        want = net(torch.from_numpy(x).to(server.device))
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    worst = 0.0
    for name, g, w in zip(names, got, want):
        w = w.cpu().numpy()
        scale = float(abs(w).max())
        rel = float(abs(g - w).max()) / scale
        worst = max(worst, rel)
        log(f"serve: graphed {name} vs the eager forward on the card: "
            f"relative {rel:.3e} of max |value| {scale:.6e} (tolerance "
            f"{GRAPH_RTOL:g}; bit-equal {bool((g == w).all())})")
        if not rel <= GRAPH_RTOL:
            fail(f"graphed {name} differs from the eager forward by {rel} "
                 f"of max |value|")
    return worst


# -- phase 4: serve ResNet ----------------------------------------------------
def seeded_resnet50(torch, mx, ctx, size=224):
    """Phase 4's model and requests: ResNet-50 v1 on ``ctx`` with Xavier
    weights and seeded BatchNorm statistics, every batch bucket warmed;
    N_REQUESTS seeded images of ``size`` x ``size``."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    import numpy as np

    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    with torch.inference_mode():
        for b in (1, 2, 4, 8):          # materialize and warm every bucket
            net(torch.zeros(b, 3, size, size, device=ctx.torch_device))
    _sync(torch)
    rng = np.random.RandomState(SEED)
    stats = {}
    for name, t in net.collect_params().items():
        shape = tuple(t.shape)
        if name.endswith("running_mean") or name.endswith("beta"):
            stats[name] = rng.randn(*shape).astype(np.float32) * 0.1
        elif name.endswith("running_var") or name.endswith("gamma"):
            stats[name] = rng.rand(*shape).astype(np.float32) + 0.5
    params = {k: v.detach().cpu().numpy()
              for k, v in net.collect_params().items()}
    params.update(stats)
    net.load_dict(params)
    return net, rng.randn(N_REQUESTS, 3, size, size).astype(np.float32)


def phase_serve_resnet(torch, mx, card, ctx, size=224):
    """Serve ResNet-50 v1 on ``ctx`` at ``size`` x ``size`` inputs."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.serving import Server, ServerConfig
    import numpy as np

    net, images = seeded_resnet50(torch, mx, ctx, size)
    server = Server(net, ServerConfig(max_batch=8,
                                      aot_prewarm=((3, size, size),)),
                    ctx=ctx).start()
    graphs = report_prewarm(server, card)
    results, launches, stats = serve_burst(torch, server, images,
                                           {"conv_epilogue": 48}, card,
                                           "images")
    graph_rel = graphed_vs_eager(torch, server, net, images[:BATCH],
                                 ("logits",))
    prof = profile_forward(torch, net, torch.randn(
        BATCH, 3, size, size, device=ctx.torch_device), "conv_epilogue", 48)

    # the same model and weights on the CPU: the plain versions
    cpu_net = resnet50_v1()
    cpu_net.load_dict({k: v.detach().cpu().numpy()
                       for k, v in net.collect_params().items()},
                      ctx=mx.cpu())
    with torch.inference_mode():
        ref = np.concatenate([
            cpu_net(torch.from_numpy(images[i:i + 8])).numpy()
            for i in range(0, N_REQUESTS, 8)])
    if ref.shape != (N_REQUESTS, 1000):
        fail(f"CPU logits have shape {ref.shape}")
    check_against_cpu("logits", np.stack(results), ref)
    return {"launches": launches, "profile": prof, "graphs": graphs,
            "graph_rel": graph_rel, "burst": stats}


# -- phase 5: kernel K2 ------------------------------------------------------
def bert_epilogues(batch, seq=BERT_SEQ):
    """(name, (R, C), act) of the 25 matmul-epilogue calls of one
    BERT-base forward: per cell ffn_1's bias + gelu and ffn_2's bias
    (identity; its dropout is off in predict mode), then the pooler's
    bias + tanh on the [CLS] rows. Every bias is along the last axis."""
    rows = batch * seq
    return ([("ffn_1.gelu", (rows, 3072), "gelu")] * 12
            + [("ffn_2.identity", (rows, 768), "identity")] * 12
            + [("pooler.tanh", (batch, 768), "tanh")])


def k2_bytes(shape, dtype_size, vec, drop):
    r, c = shape
    return dtype_size * (2 * r * c + (c if vec == "col" else r)) \
        + (r * c if drop else 0)


def k2_bound_ms(shape, dtype_size, vec, drop, act):
    """The larger of bytes / HBM rate and operations / fp32 rate, in ms;
    returns (ms, "bytes" or "operations")."""
    n = math.prod(shape)
    by = k2_bytes(shape, dtype_size, vec, drop) / HBM_BYTES_PER_S
    ops = n * (1 + _ACT_OPS[act] + 2 * int(drop)) / FP32_OPS_PER_S
    return (by * 1e3, "bytes") if by >= ops else (ops * 1e3, "operations")


def run_case_k2(torch, me, case, library=False):
    name, shape, vec, act, p, dtype = case
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    r, c = shape
    drop = p > 0
    esize = torch.tensor([], dtype=dtype).element_size()
    n_copies = max(1, min(64, math.ceil(
        160e6 / k2_bytes(shape, esize, vec, drop))))
    ys = [(torch.randn(r, c, generator=gen, device=dev) * 2).to(dtype)
          for _ in range(n_copies)]
    bias = (torch.randn(*((1, c) if vec == "col" else (r, 1)),
                        generator=gen, device=dev) * 0.5).to(dtype)
    bits = [torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8) for _ in range(n_copies)] \
        if drop else [None] * n_copies
    with torch.inference_mode():
        got = me.matmul_epilogue_2d(ys[0], bias, bits[0], act_type=act, p=p)
        want = me.matmul_epilogue_plain(ys[0], bias, bits[0], act_type=act,
                                        p=p)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * want.float().abs()).all()) \
            and got.shape == want.shape and got.dtype == want.dtype
        k_ms = graph_ms(torch, lambda i: me.matmul_epilogue_2d(
            ys[i], bias, bits[i], act_type=act, p=p), n_copies)
        p_ms = graph_ms(torch, lambda i: me.matmul_epilogue_plain(
            ys[i], bias, bits[i], act_type=act, p=p), n_copies)
        lib_ms = graph_ms(torch, lambda i: torch.add(ys[i], bias),
                          n_copies) if library else None
    bnd, by = k2_bound_ms(shape, esize, vec, drop, act)
    log(f"  {name:18s} {str(tuple(shape)):12s} {vec:3s} p={p:<4g} "
        f"{act:8s} {str(dtype)[6:]:8s} max_err={err:.3e} tol={tol:g} "
        f"kernel_ms={k_ms:.6f} plain_ms={p_ms:.6f} bound_ms={bnd:.6f} "
        f"({by})" + (f" torch.add_ms={lib_ms:.6f}" if library else "")
        + f" {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"matmul_epilogue disagrees with its plain version on {name} "
             f"{tuple(shape)} {act} p={p} {dtype}: max_err {err} > tol "
             f"{tol}")
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib_ms}


def phase_kernel_k2(torch, me):
    log("kernel: matmul_epilogue vs its plain version on the card")
    calls = bert_epilogues(BATCH)
    if len(calls) != BERT_K2_PER_FORWARD:
        fail(f"expected {BERT_K2_PER_FORWARD} epilogue calls per forward, "
             f"listed {len(calls)}")
    per_shape = {}
    errs = {"fp32": 0.0, "fp32_p0": 0.0, "bf16": 0.0}

    def record(r, dtype, p):
        if dtype == torch.float32:
            errs["fp32"] = max(errs["fp32"], r["err"])
            if p == 0:
                errs["fp32_p0"] = max(errs["fp32_p0"], r["err"])
        else:
            errs["bf16"] = max(errs["bf16"], r["err"])

    # BERT-base's shapes in predict mode (p = 0), then with dropout
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, act in calls:
            if (shape, act, dtype) not in per_shape:
                r = run_case_k2(torch, me, (name, shape, "col", act, 0.0,
                                            dtype),
                                library=act == "identity")
                per_shape[(shape, act, dtype)] = r
                record(r, dtype, 0.0)
        for name, shape, act in calls[11:13]:
            for p in (0.1, 0.5):
                record(run_case_k2(torch, me, (name, shape, "col", act, p,
                                               dtype)), dtype, p)
    # ragged shapes, both bias modes, every activation and rate
    ragged = [("ragged_col", (77, 13), "col"),
              ("ragged_row", (77, 13), "row"),
              ("minor_dim_5", (1000, 5), "col"),
              ("one_column_row", (9, 1), "row")]
    for dtype in (torch.float32, torch.bfloat16):
        for act in ("identity", "relu", "gelu", "tanh", "sigmoid"):
            for p in (0.0, 0.1, 0.5):
                for name, shape, vec in ragged:
                    record(run_case_k2(torch, me, (name, shape, vec, act, p,
                                                   dtype)), dtype, p)
    f32 = [per_shape[(shape, act, torch.float32)] for _, shape, act in calls]
    ident = [r for r, (_, _, act) in zip(f32, calls) if act == "identity"]
    results = {
        "ms": sum(r["ms"] for r in f32),
        "plain_ms": sum(r["plain_ms"] for r in f32),
        "bound_ms": sum(r["bound_ms"] for r in f32),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in f32)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in ident),
        "ms_identity": sum(r["ms"] for r in ident),
        "max_abs_err": errs["fp32"], "max_abs_err_p0_fp32": errs["fp32_p0"],
        "max_abs_err_bf16": errs["bf16"]}
    if errs["fp32_p0"] != 0.0:
        fail(f"matmul_epilogue is not bit-equal to its plain version at "
             f"p = 0 in float32 (max err {errs['fp32_p0']})")
    total_bytes = sum(k2_bytes(shape, 4, "col", False)
                      for _, shape, _ in calls)
    log(f"kernel: one BERT-base forward at batch {BATCH}, sequence "
        f"{BERT_SEQ}, float32, {len(calls)} launches: kernel "
        f"{results['ms']:.6f} ms, plain {results['plain_ms']:.6f} ms, bound "
        f"{results['bound_ms']:.6f} ms ({total_bytes / 1e9:.4f} GB at "
        f"3.35 TB/s); the 12 identity launches {results['ms_identity']:.6f}"
        f" ms vs torch.add {results['library_ms']:.6f} ms")
    return results


# -- phase 6: serve BERT -----------------------------------------------------
def seeded_bert(torch, mx, ctx, seq, buckets, seed=SEED, **kwargs):
    """Full-width BERT-base without the MLM decoder on ``ctx``:
    Normal(0.02) weights, every batch bucket materialized and warmed at
    sequence ``seq``, then seeded biases and LayerNorms, all from one
    generator seeded with ``seed``."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    dev = ctx.torch_device
    gen = mx.random.generator(seed, device=dev)
    net = bert_12_768_12(use_decoder=False, **kwargs)
    net.initialize(mx.init.Normal(0.02), ctx=ctx, generator=gen)
    with torch.inference_mode():        # materialize and warm every bucket
        for b in buckets:
            net(torch.zeros(b, seq, dtype=torch.int32, device=dev))
    with torch.no_grad():               # seeded biases and LayerNorms too
        for name, t in net.collect_params().items():
            if name.endswith(("bias", "beta")):
                t.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("gamma"):
                t.normal_(1.0, 0.02, generator=gen)
    _sync(torch)
    return net


def phase_serve_bert(torch, mx, card, ctx):
    """Serve full-width BERT-base (no MLM decoder) on ``ctx``."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.serving import Server, ServerConfig
    import numpy as np

    dev = ctx.torch_device
    net = seeded_bert(torch, mx, ctx, BERT_SEQ, (1, 2, 4, 8))
    ids = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (N_REQUESTS, BERT_SEQ)).astype(np.int32)

    server = Server(net, ServerConfig(max_batch=8, dtype="int32",
                                      aot_prewarm=((BERT_SEQ,),)),
                    ctx=ctx).start()
    graphs = report_prewarm(server, card)
    results, launches, burst = serve_burst(
        torch, server, ids, {"matmul_epilogue": BERT_K2_PER_FORWARD}, card,
        "sequences")
    graph_rel = graphed_vs_eager(torch, server, net, ids[:BATCH],
                                 ("seq_out", "pooled", "nsp"))
    prof = profile_forward(torch, net, torch.from_numpy(ids[:BATCH]).to(dev),
                           "matmul_epilogue", BERT_K2_PER_FORWARD)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        net(torch.from_numpy(ids[:BATCH]).to(dev))
    log(f"serve: peak device memory of a batch-{BATCH} forward "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # the same model and weights on the CPU: the plain versions
    cpu_net = bert_12_768_12(use_decoder=False)
    cpu_net.load_dict({k: v.detach().cpu().numpy()
                       for k, v in net.collect_params().items()},
                      ctx=mx.cpu())
    with torch.inference_mode():
        refs = [cpu_net(torch.from_numpy(ids[i:i + 8]))
                for i in range(0, N_REQUESTS, 8)]
    for k, (name, shape) in enumerate([
            ("seq_out", (BERT_SEQ, 768)), ("pooled", (768,)),
            ("nsp", (2,))]):
        ref = np.concatenate([r[k].numpy() for r in refs])
        if ref.shape != (N_REQUESTS,) + shape:
            fail(f"CPU {name} has shape {ref.shape}")
        check_against_cpu(name, np.stack([res[k] for res in results]), ref)
    return {"launches": launches, "profile": prof, "graphs": graphs,
            "graph_rel": graph_rel, "burst": burst}


def _ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _median(values):
    return sorted(values)[len(values) // 2]


def _launch_calls(prof_rows):
    """Host calls that launch work on the device (kernels or a graph)."""
    return sum(e.count for e in prof_rows
               if not str(e.device_type).endswith("CUDA")
               and re.search(r"LaunchKernel|GraphLaunch|cuLaunch", e.key))


PROFILE_TRIES = 3


def profiled(what, attempt, complete):
    """``attempt()``, run again up to PROFILE_TRIES times while
    ``complete(result)`` is false. torch.profiler (CUPTI) has dropped
    some of a graph replay's kernel records on the H100: 547 of a
    BERT-base forward's 580, every kernel type short by about 5%, while
    the graph's outputs stayed bit-equal to the eager forward's. A
    dropped record would read as a missing launch, and a graph that
    really lacks a kernel is short on every try. Each short reading is
    printed; the caller fails if the last one is short too."""
    for i in range(1, PROFILE_TRIES + 1):
        result = attempt()
        if complete(result) or i == PROFILE_TRIES:
            return result
        log(f"profile: {what}: the profiler saw fewer launches than the "
            f"graph holds; profiling again ({i + 1} of {PROFILE_TRIES})")


def _is_kernel(name, kernel):
    """Whether the device function ``name`` is the kernel whose launch
    count is ``kernel`` (any of its designs: flash_attention_bwd_dkv is
    flash_attention_bwd_dkv_kernel, _wgmma_kernel or _mma16_kernel;
    flash_attention is flash_attention_kernel, _fwd_wgmma_kernel or
    _fwd_mma16_kernel; matmul_epilogue is matmul_epilogue_kernel or
    _vec_kernel)."""
    return re.search(rf"\b{kernel}_(?:fwd_|vec_)?(?:wgmma_|mma16_)?kernel\b",
                     name) is not None


def _kernel_count(dev, kernel):
    return sum(c for k, (c, _) in dev.items() if _is_kernel(k, kernel))


def profile_forward(torch, net, x, kernel, per_forward, reps=10):
    """Where one batch forward's time goes, eager and graphed in turns
    (each rep runs all four, so all see the same host): the eager forward
    and the graph's replay alone (host clock around the call and a
    synchronize), and each with the host copy in and the outputs out (the
    graphed one a Predictor call, the server's path); then the graphed
    predictor call on another thread (the server's worker is one);
    medians of ``reps``. Then torch.profiler over 3 forwards of each:
    device time, kernel launches, busy share of the median wall time,
    host launch calls per forward and ``kernel``'s time and launches. A
    graph's kernels must include ``per_forward`` of ``kernel``'s."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.serving import Predictor
    batch = x.shape[0]
    padded = x.cpu().numpy()
    pred = Predictor(net, x.device, tuple(x.shape), padded.dtype)
    captured = pred.replay(x).fwd_launches.get(kernel, 0)
    if captured != per_forward:
        fail(f"the graph captured {captured} {kernel} launches, want "
             f"{per_forward}")

    def eager():
        with torch.inference_mode():
            net(x)
        torch.cuda.synchronize()

    def graphed():
        pred.replay()
        torch.cuda.synchronize()

    def eager_call():
        with torch.inference_mode():
            out = net(torch.from_numpy(padded).to(x.device))
        for o in [out] if isinstance(out, torch.Tensor) else out:
            o.cpu().numpy()

    runs = {"eager": eager, "graphed": graphed,
            "eager + copies": eager_call,
            "graphed + copies": lambda: pred(padded)}
    for fn in runs.values():
        for _ in range(3):
            fn()
    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, fn in runs.items():
            times[name].append(_ms(fn))
    other = []
    worker = threading.Thread(target=lambda: other.extend(
        _ms(lambda: pred(padded)) for _ in range(reps + 3)))
    worker.start()
    worker.join(timeout=300)
    wall = {name: _median(t) for name, t in times.items()}
    log(f"profile: batch {batch}, medians of {reps} in turns: "
        + ", ".join(f"{name} {ms:.3f} ms (min {min(times[name]):.3f})"
                    for name, ms in wall.items())
        + f"; graphed + copies on another thread {_median(other[3:]):.3f}"
        " ms")
    result = {"wall_ms": wall, "thread_ms": _median(other[3:])}
    for mode, fn in (("eager", eager), ("graphed", graphed)):
        def measure(fn=fn):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                for _ in range(3):
                    fn()
            rows = prof.key_averages()
            return rows, {e.key: (e.count / 3, e.self_device_time_total / 3e3)
                          for e in rows
                          if str(e.device_type).endswith("CUDA")}

        rows, dev = profiled(
            f"{mode} batch {batch} forward", measure,
            lambda r: mode != "graphed" or not r[1]
            or _kernel_count(r[1], kernel) == per_forward)
        device_ms = sum(ms for _, ms in dev.values())
        calls = _launch_calls(rows) / 3
        k_ms = sum(ms for k, (_, ms) in dev.items() if _is_kernel(k, kernel))
        k_n = sum(c for k, (c, _) in dev.items() if _is_kernel(k, kernel))
        n = sum(c for c, _ in dev.values())
        result[mode] = {"device_ms": device_ms, "launches": n,
                        "host_launch_calls": calls, "kernel_ms": k_ms,
                        "kernel_launches": k_n,
                        "busy": device_ms / wall[mode]}
        if device_ms <= 0:
            log(f"profile: {mode} batch {batch} forward {wall[mode]:.3f} "
                "ms wall; device time not measured (the profiler saw no "
                f"kernels); {calls:.0f} host launch calls per forward")
            result[mode]["device_ms"] = result[mode]["kernel_ms"] = None
            continue
        log(f"profile: {mode} batch {batch} forward {wall[mode]:.3f} ms "
            f"wall, kernels {device_ms:.3f} ms on the device ({n:.0f} "
            f"launches), busy {device_ms / wall[mode]:.3f}; {calls:.0f} host "
            f"launch calls per forward; {kernel} {k_ms:.3f} ms in {k_n:.0f} "
            f"launches, {k_ms / device_ms:.3f} of the device time")
        for key, (c, ms) in sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]:
            log(f"  {ms:9.4f} ms {c:5.0f}x  {key[:90]}")
        if mode == "graphed" and k_n != per_forward:
            fail(f"the profiler saw {k_n} {kernel} launches in a graphed "
                 f"forward, want {per_forward}")
    pred.close()
    return result


# -- phase 7: kernel K3 ------------------------------------------------------
def flash_cases():
    """(name, B, H, S_q, S_kv, D, causal, form). ``form`` "qkv" reads
    strided (B, S, H, D) views of one fused (B, S, 3HD) tensor, as
    fused_self_attention passes them; "bhsd" is contiguous [B, H, S, D];
    "3d" is [B, S, D] (H = 1). S_q 127, 128 and 129 sit at the edge of a
    128-row CTA (the fp32 forward, the 16-bit one at D 128), S_q 63, 64
    and 65 at that of the 16-bit forward's 64-row CTA at D 64; S_q 300
    against S_kv 200 under causal puts empty and non-empty rows in one
    CTA; D 40 and 100 are not multiples of 8 (16-bit rows of 80 and 200
    bytes)."""
    return [
        ("slice", LONG_BATCH, LONG_HEADS, LONG_SEQ, LONG_SEQ, 64, False,
         "qkv"),
        ("slice_causal", LONG_BATCH, LONG_HEADS, LONG_SEQ, LONG_SEQ, 64,
         True, "qkv"),
        ("bhsd", 2, 12, 2048, 2048, 64, False, "bhsd"),
        ("bhsd_causal", 2, 3, 1100, 1100, 64, True, "bhsd"),
        ("q_shorter_causal", 2, 3, 200, 1100, 64, True, "bhsd"),
        ("q_shorter", 2, 3, 200, 1100, 64, False, "bhsd"),
        ("q_longer_causal", 2, 3, 1100, 200, 64, True, "bhsd"),
        ("q_longer", 2, 3, 1100, 200, 64, False, "bhsd"),
        ("ragged_1025_qkv", 1, 4, 1025, 1025, 64, True, "qkv"),
        ("ragged_1100_d16", 2, 2, 1100, 1100, 16, False, "bhsd"),
        ("ragged_1_d128", 1, 2, 1, 1100, 128, False, "bhsd"),
        ("ragged_7_d128", 1, 2, 7, 7, 128, True, "bhsd"),
        ("d16_causal", 2, 3, 1100, 1100, 16, True, "bhsd"),
        ("d128", 1, 4, 2048, 2048, 128, False, "bhsd"),
        ("d80_ragged_causal", 2, 2, 300, 1030, 80, True, "bhsd"),
        ("d256", 1, 2, 130, 1100, 256, False, "bhsd"),
        ("3d_causal", 3, 1, 1100, 1100, 16, True, "3d"),
        ("3d_short_keys", 3, 1, 1025, 7, 64, False, "3d"),
        ("d40", 2, 3, 1100, 1100, 40, False, "bhsd"),
        ("d40_causal", 2, 3, 1100, 1100, 40, True, "bhsd"),
        ("d100", 1, 2, 1100, 1100, 100, False, "bhsd"),
        ("d100_causal", 1, 2, 1100, 1100, 100, True, "bhsd"),
        ("q127", 1, 2, 127, 1100, 64, False, "bhsd"),
        ("q127_causal", 1, 2, 127, 1100, 64, True, "bhsd"),
        ("q128", 1, 2, 128, 1100, 64, False, "bhsd"),
        ("q128_causal", 1, 2, 128, 1100, 64, True, "bhsd"),
        ("q129", 1, 2, 129, 1100, 64, False, "bhsd"),
        ("q129_causal", 1, 2, 129, 1100, 64, True, "bhsd"),
        ("q_longer_straddle", 1, 2, 300, 200, 64, True, "bhsd"),
        ("q63", 1, 2, 63, 1100, 64, False, "bhsd"),
        ("q64_causal", 1, 2, 64, 1100, 64, True, "bhsd"),
        ("q65_causal", 1, 2, 65, 1100, 64, True, "bhsd"),
    ]


def flash_inputs(torch, case, dtype):
    _, b, h, s_q, s_kv, d, _, form = case
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    if form == "qkv":
        qkv = rnd(b, s_q, 3 * h * d)
        return tuple(qkv[:, :, i * h * d:(i + 1) * h * d]
                     .reshape(b, s_q, h, d) for i in range(3))
    lead = (b,) if form == "3d" else (b, h)
    return rnd(*lead, s_q, d), rnd(*lead, s_kv, d), rnd(*lead, s_kv, d)


def product_flops(case):
    """Flops of one product of the forward or the backward: 2 B H S_q
    S_kv D, half under causal."""
    _, b, h, s_q, s_kv, d, causal, _ = case
    return 2 * b * h * s_q * s_kv * d * (0.5 if causal else 1.0)


def k3_bound_ms(case, dtype_size, tf32=False, rate=None):
    """The larger of operations / peak rate (two products, 4 B H S_q S_kv
    D, half under causal) and bytes / HBM rate (q, k, v read once, out
    written once), in ms. The rate is fp32 on CUDA cores (67 TFLOP/s),
    with ``tf32`` three tf32 passes per product (3xTF32) at 495 TFLOP/s,
    or ``rate`` (the bf16 tensor cores' 989 TFLOP/s for bf16 inputs).
    Returns (ms, "bytes" or "operations")."""
    _, b, h, s_q, s_kv, d, _, _ = case
    ops = 2 * product_flops(case)
    rate = rate or (TF32_OPS_PER_S / 3 if tf32 else FP32_OPS_PER_S)
    by = dtype_size * b * h * d * (2 * s_q + 2 * s_kv)
    ops_s, by_s = ops / rate, by / HBM_BYTES_PER_S
    return (by_s * 1e3, "bytes") if by_s > ops_s else (ops_s * 1e3,
                                                       "operations")


def event_ms(torch, fn, reps):
    """Device time of one ``fn()`` from CUDA events around ``reps`` calls,
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_ms(torch, q, k, v):
    """Time of torch's scaled_dot_product_attention on [B, H, S, D]
    inputs (a yardstick; the port never calls it) and the name of the
    device kernel it ran."""
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = event_ms(torch, lambda: sdpa(q, k, v), 5)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        sdpa(q, k, v)
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    return ms, (rows[0].key if rows else "not seen by the profiler")


def run_case_k3(torch, fa, case, dtype, timed=False):
    """The kernel against flash_attention_plain on the same inputs (the
    gate) and, on 16-bit inputs, against the plain version with p rounded
    to the input dtype per 128-key block (the function the 16-bit kernels
    compute; logged)."""
    name, b, h, s_q, s_kv, d, causal, form = case
    q, k, v = flash_inputs(torch, case, dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    sixteen = dtype != torch.float32
    with torch.inference_mode():
        if form == "qkv":
            def kernel():
                return fa.flash_attention_bshd(q, k, v, causal=causal)

            def plain(**kw):
                return fa.flash_attention_plain(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, **kw).transpose(1, 2)
        else:
            def kernel():
                return fa.flash_attention(q, k, v, causal=causal)

            def plain(**kw):
                return fa.flash_attention_plain(q, k, v, causal=causal, **kw)
        got, want = kernel(), plain()
        rounded = plain(block_size=128, round_to=dtype) if sixteen else None
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        scale = float(want.float().abs().max())
        ok = err <= tol * scale and got.shape == want.shape \
            and got.dtype == want.dtype and bool(torch.isfinite(got).all())
        if causal and s_q > s_kv:       # rows with no allowed key: zeros
            ok = ok and not bool(got[..., :s_q - s_kv, :].any())
        res = {"err": err, "rel": err / scale, "rel_round": 0.0}
        if sixteen:
            res["rel_round"] = float((got.float() - rounded.float()).abs()
                                     .max()) / float(rounded.float().abs()
                                                     .max())
        del got, want, diff, rounded
        if timed:
            res["ms"] = event_ms(torch, kernel, 5)
            res["plain_ms"] = event_ms(torch, plain, 2)
            qh, kh, vh = (t.transpose(1, 2).contiguous() if form == "qkv"
                          else t for t in (q, k, v))
            res["library_ms"], res["library_kernel"] = sdpa_ms(
                torch, qh, kh, vh)
    esize = torch.tensor([], dtype=dtype).element_size()
    res["bound_ms"], res["bound_by"] = k3_bound_ms(case, esize)
    res["bound_ms_3xtf32"], res["bound_by_3xtf32"] = k3_bound_ms(
        case, esize, tf32=True)
    res["bound_ms_bf16_cores"], res["bound_by_bf16_cores"] = k3_bound_ms(
        case, esize, rate=BF16_OPS_PER_S)
    res["flops"] = 2 * product_flops(case)
    times = (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
             f"sdpa_ms={res['library_ms']:.4f}" if timed else "")
    log(f"  {name:18s} B={b} H={h} S_q={s_q} S_kv={s_kv} D={d} "
        f"causal={int(causal)} {form:4s} {str(dtype)[6:]:8s} "
        f"max_err={err:.3e} max|out|={scale:.3e} tol={tol:g} of max|out|"
        + (f" (rel to the round_to version {res['rel_round']:.3e})"
           if sixteen else "")
        + f"{times} bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
        f"bound_3xtf32_ms={res['bound_ms_3xtf32']:.4f} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"flash_attention disagrees with its plain version on {name} "
             f"{dtype}: max_err {err} > {tol} x {scale}")
    return res


def phase_kernel_k3(torch, fa):
    log("kernel: flash_attention vs its plain version on the card")
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    errs = {dt: {"err": 0.0, "rel": 0.0, "rel_round": 0.0} for dt in dtypes}
    timed = {}
    for dtype in dtypes:
        for case in flash_cases():
            want_times = case[0] == "slice"
            r = run_case_k3(torch, fa, case, dtype, timed=want_times)
            for key in errs[dtype]:
                errs[dtype][key] = max(errs[dtype][key], r[key])
            if want_times:
                timed[dtype] = r
    n = LONG_K3_PER_FORWARD
    sixteen = {}
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        t16, name = timed[dtype], str(dtype)[6:]
        row = {"ms": n * t16["ms"], "plain_ms": n * t16["plain_ms"],
               "library_ms": n * t16["library_ms"],
               "library_kernel": t16["library_kernel"],
               "bound_ms": n * t16["bound_ms_bf16_cores"],
               "bound_by": t16["bound_by_bf16_cores"],
               "max_abs_err": errs[dtype]["err"],
               "max_rel_err": errs[dtype]["rel"],
               "max_rel_err_vs_round_to": errs[dtype]["rel_round"]}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["tflops"] = n * t16["flops"] / (row["ms"] * 1e-3) / 1e12
        row["vs_library"] = row["ms"] / row["library_ms"]
        sixteen[key] = row
        log(f"kernel: the same attention in {name} ({n} launches): kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"scaled_dot_product_attention {row['library_ms']:.3f} ms (its "
            f"kernel: {row['library_kernel'][:80]}), bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']} at the 16-bit "
            f"tensor cores' 989 TFLOP/s), share {row['bound_share']:.3f}, "
            f"{row['tflops']:.1f} TFLOP/s over the 2 products; kernel / SDPA "
            f"{row['vs_library']:.3f}; max relative error "
            f"{row['max_rel_err']:.3e} of max|out| against the plain version,"
            f" {row['max_rel_err_vs_round_to']:.3e} against its round_to="
            f"{name} version (128-key blocks)")
    timed = timed[torch.float32]
    results = {"ms": n * timed["ms"], "plain_ms": n * timed["plain_ms"],
               "bound_ms": n * timed["bound_ms"],
               "bound_by": timed["bound_by"],
               "bound_ms_3xtf32": n * timed["bound_ms_3xtf32"],
               "bound_by_3xtf32": timed["bound_by_3xtf32"],
               "library_ms": n * timed["library_ms"],
               "library_kernel": timed["library_kernel"],
               "max_abs_err": errs[torch.float32]["err"], **sixteen}
    log(f"kernel: one long-context BERT-base forward's attention (batch "
        f"{LONG_BATCH}, S {LONG_SEQ}, 12 heads, D 64, float32, {n} "
        f"launches): kernel {results['ms']:.3f} ms, plain "
        f"{results['plain_ms']:.3f} ms, bound {results['bound_ms']:.3f} ms "
        f"({results['bound_by']} at 67 TFLOP/s), scaled_dot_product_"
        f"attention {results['library_ms']:.3f} ms (its kernel: "
        f"{results['library_kernel'][:80]})")
    results["bound_share"] = results["bound_ms"] / results["ms"]
    results["bound_share_3xtf32"] = results["bound_ms_3xtf32"] / results["ms"]
    log(f"kernel: the forward's 2 products ({n * timed['flops'] / 1e12:.3f} "
        f"TFLOP) at {n * timed['flops'] / (results['ms'] * 1e-3) / 1e12:.2f} "
        f"TFLOP/s; 3xTF32 bound (3 tf32 passes per product at 495 TFLOP/s) "
        f"{results['bound_ms_3xtf32']:.3f} ms ({results['bound_by_3xtf32']});"
        f" share of the fp32 / 3xTF32 bound {results['bound_share']:.3f} / "
        f"{results['bound_share_3xtf32']:.3f}; kernel / scaled_dot_product_"
        f"attention {results['ms'] / results['library_ms']:.3f}")
    return results


# -- phase 8: serve long-context BERT ----------------------------------------
def phase_serve_long_bert(torch, mx, card, ctx):
    """Serve full-width BERT-base at S 4096 on ``ctx``."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.serving import Server, ServerConfig
    import numpy as np

    dev = ctx.torch_device
    net = seeded_bert(torch, mx, ctx, LONG_SEQ, (1, 2, LONG_BATCH),
                      max_length=LONG_SEQ)
    ids = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (LONG_REQUESTS, LONG_SEQ)).astype(np.int32)
    log(f"serve: default_deadline_ms set to {LONG_DEADLINE_MS:g} for this "
        "phase (the server's default is 2000)")
    server = Server(net, ServerConfig(max_batch=LONG_BATCH, dtype="int32",
                                      default_deadline_ms=LONG_DEADLINE_MS,
                                      aot_prewarm=((LONG_SEQ,),)),
                    ctx=ctx).start()
    graphs = report_prewarm(server, card)
    results, launches, _ = serve_burst(
        torch, server, ids, {"flash_attention": LONG_K3_PER_FORWARD,
                             "matmul_epilogue": BERT_K2_PER_FORWARD},
        card, "sequences", n_requests=LONG_REQUESTS, max_batch=LONG_BATCH)
    graph_rel = graphed_vs_eager(torch, server, net, ids[:LONG_BATCH],
                                 ("seq_out", "pooled", "nsp"))
    x = torch.from_numpy(ids[:LONG_BATCH]).to(dev)
    prof = profile_forward(torch, net, x, "flash_attention",
                           LONG_K3_PER_FORWARD, reps=3)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        net(x)
    dense_gb = LONG_BATCH * LONG_HEADS * LONG_SEQ ** 2 * 4 / 1e9
    log(f"serve: peak device memory of a batch-{LONG_BATCH} forward "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; dense "
        f"attention's fp32 score tensor alone would be {dense_gb:.2f} GB "
        "per layer")

    # the same model and weights on the CPU: the plain versions
    cpu_net = bert_12_768_12(use_decoder=False, max_length=LONG_SEQ)
    cpu_net.load_dict({k: v.detach().cpu().numpy()
                       for k, v in net.collect_params().items()},
                      ctx=mx.cpu())
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_net(torch.from_numpy(ids[list(LONG_CHECKED)]))
    log(f"serve: CPU forward of requests {list(LONG_CHECKED)} took "
        f"{time.perf_counter() - t0:.1f} s")
    for k, (name, shape) in enumerate([
            ("seq_out", (LONG_SEQ, 768)), ("pooled", (768,)),
            ("nsp", (2,))]):
        want = ref[k].numpy()
        if want.shape != (len(LONG_CHECKED),) + shape:
            fail(f"CPU {name} has shape {want.shape}")
        check_against_cpu(name, np.stack([results[i][k]
                                          for i in LONG_CHECKED]), want)
    return {"launches": launches, "profile": prof, "graphs": graphs,
            "graph_rel": graph_rel}


# -- phase 9: kernel K3 backward ---------------------------------------------
def bwd_cases():
    """(name, B, H, S_q, S_kv, D, causal, form) of the backward check, in
    flash_cases' forms: the slice's own call (gradients written into one
    fused (4, 4096, 2304) buffer), causal, S_q > S_kv with empty rows,
    S_q < S_kv, ragged S, D 16, 32, 128 and 256, D 40 and 100 (not
    multiples of 8; 16-bit rows of 200 bytes), 3-D inputs."""
    return [
        ("slice", LONG_BATCH, LONG_HEADS, LONG_SEQ, LONG_SEQ, 64, False,
         "qkv"),
        ("slice_causal", LONG_BATCH, LONG_HEADS, LONG_SEQ, LONG_SEQ, 64,
         True, "qkv"),
        ("q_longer_causal", 2, 3, 1100, 200, 64, True, "bhsd"),
        ("q_shorter_causal", 2, 3, 200, 1100, 64, True, "bhsd"),
        ("ragged_1025_qkv", 1, 4, 1025, 1025, 64, True, "qkv"),
        ("d32", 2, 4, 1100, 1100, 32, False, "bhsd"),
        ("d128_causal", 1, 4, 2048, 2048, 128, True, "bhsd"),
        ("d256", 1, 2, 130, 1100, 256, False, "bhsd"),
        ("d256_q_longer_causal", 1, 2, 1100, 300, 256, True, "bhsd"),
        ("3d_causal", 3, 1, 1100, 1100, 16, True, "3d"),
        ("d40", 2, 3, 1100, 1100, 40, False, "bhsd"),
        ("d40_causal", 2, 3, 1100, 1100, 40, True, "bhsd"),
        ("d100", 1, 2, 1100, 1100, 100, False, "bhsd"),
        ("d100_causal", 1, 2, 1100, 1100, 100, True, "bhsd"),
    ]


def k3_bwd_bound_ms(case, dtype_size, which, tf32=False, rate=None):
    """The larger of operations / peak rate and bytes / HBM rate of one
    backward kernel, in ms. ``which`` "dkv": s, dp, dv and dk, four
    products, reading q, k, v, dout, lse and delta and writing dk, dv;
    "dq": s, dp and dq, three products, writing dq; "both": the five
    products the three gradients need at least, every input read and
    every gradient written once. The rate is fp32 on CUDA cores (67
    TFLOP/s), or with ``tf32`` three tf32 passes per product (3xTF32) at
    495 TFLOP/s. Returns (ms, "bytes" or "operations")."""
    _, b, h, s_q, s_kv, d, _, _ = case
    products = {"dkv": 4, "dq": 3, "both": 5}[which]
    ops = products * product_flops(case)
    rate = rate or (TF32_OPS_PER_S / 3 if tf32 else FP32_OPS_PER_S)
    written = {"dkv": 2 * s_kv, "dq": s_q, "both": s_q + 2 * s_kv}[which]
    by = b * h * (dtype_size * d * (2 * s_q + 2 * s_kv + written)
                  + 8 * s_q)
    ops_s, by_s = ops / rate, by / HBM_BYTES_PER_S
    return (by_s * 1e3, "bytes") if by_s > ops_s else (ops_s * 1e3,
                                                       "operations")


def sdpa_bwd_ms(torch, q, k, v, dout):
    """Time of the backward of torch's scaled_dot_product_attention on
    [B, H, S, D] inputs (a yardstick; the port never calls it) and the
    name of the device kernel that took most of it."""
    from torch.profiler import ProfilerActivity, profile
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves)

    def bwd():
        torch.autograd.grad(out, leaves, dout, retain_graph=True)

    ms = event_ms(torch, bwd, 3)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        bwd()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    return ms, (rows[0].key if rows else "not seen by the profiler")


def run_case_k3_bwd(torch, fa, case, dtype, timed=False):
    """The backward kernels against flash_attention_bwd_plain on the
    same q, k, v, dout and the kernel forward's out and lse; the forward's
    lse against the plain forward's."""
    name, b, h, s_q, s_kv, d, causal, form = case
    q, k, v = flash_inputs(torch, case, dtype)
    bshd = form == "qkv"
    if timed and not bshd:
        fail(f"{name}: only the fused-QKV form is timed")
    scale = fa.default_scale(d, dtype)
    gen = torch.Generator(device=q.device)
    gen.manual_seed(SEED + 1)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2

    def plain_layout(t):
        return t.transpose(1, 2) if bshd else t

    res = {}
    with torch.no_grad():
        out, lse = fa._attend(q, k, v, causal, scale, 512, True, bshd)
        _, want_lse = fa.flash_attention_plain(
            *(plain_layout(t) for t in (q, k, v)), causal=causal,
            scale=scale, return_lse=True)
        lse = lse.view(want_lse.shape)
        finite = torch.isfinite(want_lse)
        lse_err = float((lse[finite] - want_lse[finite]).abs().max())
        lse_ok = torch.equal(finite, torch.isfinite(lse)) \
            and bool((lse[~finite] > 0).all()) \
            and lse_err <= 1e-5 * float(want_lse[finite].abs().max())
        if bshd:
            fused = torch.empty(b, s_q, 3 * h * d, dtype=dtype,
                                device=q.device)
            grads = fa._split_qkv(fused, h)
        else:
            grads = [torch.empty_like(t) for t in (q, k, v)]
        fa._attend_bwd(q, k, v, out, lse, dout, grads, causal, scale, 512,
                       bshd)
        plain_args = [plain_layout(t) for t in (q, k, v, out)] + [
            lse, plain_layout(dout)]
        want = fa.flash_attention_bwd_plain(*plain_args, causal=causal,
                                            scale=scale)
        # the 16-bit kernels round p and scale * ds to the input dtype
        # before the gradient products, as the TPU kernels do: the plain
        # version with the same rounding, logged beside the gate
        rounded = None if dtype == torch.float32 else \
            fa.flash_attention_bwd_plain(*plain_args, causal=causal,
                                         scale=scale, round_to=dtype)
        torch.cuda.synchronize()
        errs, rels, rels_round, ok = [], [], [], lse_ok
        for i, (g, w) in enumerate(zip(grads, want)):
            g = plain_layout(g)
            diff = float((g.float() - w.float()).abs().max())
            top = float(w.float().abs().max())
            errs.append(diff)
            rels.append(diff / top)
            ok = ok and diff <= tol * top and g.dtype == dtype \
                and bool(torch.isfinite(g).all())
            if rounded is not None:
                w = rounded[i].float()
                rels_round.append(float((g.float() - w).abs().max())
                                  / float(w.abs().max()))
        if causal and s_q > s_kv:       # rows with no allowed key: zeros
            ok = ok and not bool(plain_layout(grads[0])[
                ..., :s_q - s_kv, :].any())
        res.update(err_dq=errs[0], err_dkv=max(errs[1:]), rel=max(rels),
                   rel_round=max(rels_round, default=0.0), lse_err=lse_err)
        if timed:                       # the slice's fused-QKV call
            delta = fa._bwd_delta(out, dout)
            lse4 = lse.view(b, h, s_q)
            res["dkv_ms"] = event_ms(torch, lambda: fa._launch_bwd_kernel(
                "dkv", q, k, v, dout, lse4, delta, grads[1:], causal,
                scale), 3)
            res["dq_ms"] = event_ms(torch, lambda: fa._launch_bwd_kernel(
                "dq", q, k, v, dout, lse4, delta, grads[:1], causal,
                scale), 3)
            res["delta_ms"] = event_ms(
                torch, lambda: fa._bwd_delta(out, dout), 5)
            res["plain_ms"] = event_ms(
                torch, lambda: fa.flash_attention_bwd_plain(
                    *plain_args, causal=causal, scale=scale), 2)
    if timed:
        res["library_ms"], res["library_kernel"] = sdpa_bwd_ms(
            torch, *(plain_layout(t).contiguous() for t in (q, k, v, dout)))
    esize = torch.tensor([], dtype=dtype).element_size()
    for which in ("dkv", "dq", "both"):
        res[f"bound_{which}_bf16_cores"], res["bound_by_bf16_cores"] = \
            k3_bwd_bound_ms(case, esize, which, rate=BF16_OPS_PER_S)
        res[f"bound_{which}"], res["bound_by"] = k3_bwd_bound_ms(
            case, esize, which)
        res[f"bound_{which}_3xtf32"], res["bound_by_3xtf32"] = \
            k3_bwd_bound_ms(case, esize, which, tf32=True)
    res["flops_7"] = 7 * product_flops(case)
    times = (f" dkv_ms={res['dkv_ms']:.4f} dq_ms={res['dq_ms']:.4f} "
             f"delta_ms={res['delta_ms']:.4f} plain_ms="
             f"{res['plain_ms']:.4f} sdpa_bwd_ms={res['library_ms']:.4f}"
             if timed else "")
    log(f"  {name:20s} B={b} H={h} S_q={s_q} S_kv={s_kv} D={d} "
        f"causal={int(causal)} {form:4s} {str(dtype)[6:]:8s} "
        f"max_err dq={errs[0]:.3e} dk={errs[1]:.3e} dv={errs[2]:.3e} "
        f"rel={res['rel']:.3e} tol={tol:g} of max|grad|"
        + (f" (rel to the round_to version {res['rel_round']:.3e})"
           if rounded is not None else "") + "; lse_err="
        f"{lse_err:.3e}{times} bound_ms={res['bound_both']:.4f} "
        f"({res['bound_by']}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"flash attention backward disagrees with its plain version "
             f"on {name} {dtype}: relative {res['rel']} > {tol}, or lse "
             f"error {lse_err}")
    return res


def phase_kernel_k3_bwd(torch, fa):
    log("kernel: flash attention backward (dK/dV and dQ kernels) vs "
        "flash_attention_bwd_plain on the card")
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    errs = {dt: [0.0, 0.0, 0.0, 0.0] for dt in dtypes}
    timed, lse_err = {}, 0.0
    for dtype in dtypes:
        for case in bwd_cases():
            want_times = case[0] == "slice"
            r = run_case_k3_bwd(torch, fa, case, dtype, timed=want_times)
            e = errs[dtype]
            e[0] = max(e[0], r["err_dq"])
            e[1] = max(e[1], r["err_dkv"])
            e[2] = max(e[2], r["rel"])
            e[3] = max(e[3], r["rel_round"])
            lse_err = max(lse_err, r["lse_err"])
            if want_times:
                timed[dtype] = r
    n = LONG_K3_PER_FORWARD
    sixteen = {}
    for dtype in dtypes[1:]:
        t16, name = timed[dtype], str(dtype)[6:]
        row = {"dkv_ms": n * t16["dkv_ms"], "dq_ms": n * t16["dq_ms"],
               "plain_ms": n * t16["plain_ms"],
               "library_ms": n * t16["library_ms"],
               "library_kernel": t16["library_kernel"],
               "bound_dkv": n * t16["bound_dkv_bf16_cores"],
               "bound_dq": n * t16["bound_dq_bf16_cores"],
               "bound_both": n * t16["bound_both_bf16_cores"],
               "bound_by": t16["bound_by_bf16_cores"],
               "err_dq": errs[dtype][0], "err_dkv": errs[dtype][1],
               "rel": errs[dtype][2], "rel_round": errs[dtype][3]}
        pair = row["dkv_ms"] + row["dq_ms"]
        row["share_dkv"] = row["bound_dkv"] / row["dkv_ms"]
        row["share_dq"] = row["bound_dq"] / row["dq_ms"]
        row["tflops_7"] = n * t16["flops_7"] / (pair * 1e-3) / 1e12
        row["tflops_5"] = n * 5 / 7 * t16["flops_7"] / (pair * 1e-3) / 1e12
        row["vs_library"] = pair / row["library_ms"]
        sixteen[name] = row
        log(f"kernel: the same backward in {name} ({n} launches of each): "
            f"dK/dV {row['dkv_ms']:.3f} ms (bound {row['bound_dkv']:.3f}, "
            f"share {row['share_dkv']:.3f}), dQ {row['dq_ms']:.3f} ms "
            f"(bound {row['bound_dq']:.3f}, share {row['share_dq']:.3f}), "
            f"bounds at the 16-bit tensor cores' 989 TFLOP/s "
            f"({row['bound_by']}); the pair {pair:.3f} ms against the "
            f"five-product bound {row['bound_both']:.3f} ms, at "
            f"{row['tflops_7']:.1f} TFLOP/s over its 7 products "
            f"({row['tflops_5']:.1f} over the 5 the gradients need); plain "
            f"{row['plain_ms']:.3f} ms; scaled_dot_product_attention "
            f"backward {row['library_ms']:.3f} ms (its kernel: "
            f"{row['library_kernel'][:80]}); the pair / SDPA "
            f"{row['vs_library']:.3f}; max relative error "
            f"{row['rel']:.3e} of max|grad| against the plain version, "
            f"{row['rel_round']:.3e} against its round_to={name} version")
    timed = timed[torch.float32]
    f32 = errs[torch.float32]
    results = {
        "dkv_ms": n * timed["dkv_ms"], "dq_ms": n * timed["dq_ms"],
        "delta_ms": n * timed["delta_ms"],
        "plain_ms": n * timed["plain_ms"],
        "library_ms": n * timed["library_ms"],
        "library_kernel": timed["library_kernel"],
        "bound_dkv": n * timed["bound_dkv"], "bound_dq": n * timed["bound_dq"],
        "bound_both": n * timed["bound_both"], "bound_by": timed["bound_by"],
        "bound_dkv_3xtf32": n * timed["bound_dkv_3xtf32"],
        "bound_dq_3xtf32": n * timed["bound_dq_3xtf32"],
        "bound_both_3xtf32": n * timed["bound_both_3xtf32"],
        "bound_by_3xtf32": timed["bound_by_3xtf32"],
        "err_dq": f32[0], "err_dkv": f32[1], "rel": f32[2],
        "lse_err": lse_err, **sixteen}
    pair_ms = results["dkv_ms"] + results["dq_ms"]
    results["tflops_7"] = n * timed["flops_7"] / (pair_ms * 1e-3) / 1e12
    for which in ("dkv", "dq"):
        ms = results[f"{which}_ms"]
        results[f"share_{which}"] = results[f"bound_{which}"] / ms
        results[f"share_{which}_3xtf32"] = \
            results[f"bound_{which}_3xtf32"] / ms
    log(f"kernel: one long-context BERT-base training step's attention "
        f"backward (batch {LONG_BATCH}, S {LONG_SEQ}, 12 heads, D 64, "
        f"float32, {n} launches of each kernel): dK/dV "
        f"{results['dkv_ms']:.3f} ms (bound {results['bound_dkv']:.3f}), "
        f"dQ {results['dq_ms']:.3f} ms (bound {results['bound_dq']:.3f}), "
        f"together {results['dkv_ms'] + results['dq_ms']:.3f} ms against "
        f"the five-product bound {results['bound_both']:.3f} ms "
        f"({results['bound_by']} at 67 TFLOP/s); delta reduction "
        f"{results['delta_ms']:.3f} ms; plain {results['plain_ms']:.3f} ms; "
        f"scaled_dot_product_attention backward "
        f"{results['library_ms']:.3f} ms (its kernel: "
        f"{results['library_kernel'][:80]})")
    log(f"kernel: the pair's 7 products ({n * timed['flops_7'] / 1e12:.3f} "
        f"TFLOP, s and dp in both kernels) at {results['tflops_7']:.2f} "
        f"TFLOP/s; 3xTF32 bounds (3 tf32 passes per product at 495 "
        f"TFLOP/s): dK/dV {results['bound_dkv_3xtf32']:.3f} ms, dQ "
        f"{results['bound_dq_3xtf32']:.3f} ms, five products "
        f"{results['bound_both_3xtf32']:.3f} ms "
        f"({results['bound_by_3xtf32']}); share of the fp32 / 3xTF32 "
        f"bound: dK/dV {results['share_dkv']:.3f} / "
        f"{results['share_dkv_3xtf32']:.3f}, dQ {results['share_dq']:.3f} / "
        f"{results['share_dq_3xtf32']:.3f}; the pair "
        f"{results['bound_both'] / pair_ms:.3f} / "
        f"{results['bound_both_3xtf32'] / pair_ms:.3f} of the five-product "
        "bounds")
    return results


# -- phase 10: kernel K2 training --------------------------------------------
def phase_kernel_k2_train(torch, mx, me):
    """ffn_2's training call with bits drawn on the card, bit-equal to the
    plain version on the same bits, keeping 1 - p; and K2's backward
    against the plain version's autograd at the slice's two shapes."""
    from mxnet_tpu_torch.ops import contrib
    log("kernel: matmul_epilogue in training on the card")
    dev = torch.device("cuda", 0)
    gen = mx.random.generator(SEED, device=dev)
    rows = LONG_BATCH * LONG_SEQ
    y = torch.randn(rows, 768, generator=gen, device=dev)
    b = torch.randn(768, generator=gen, device=dev) * 0.1
    with torch.no_grad(), mx.random.bits_tape() as tape:
        out = contrib.matmul_epilogue(y, b, act_type="identity", p=0.1,
                                      training=True, generator=gen)
    (bits,) = tape.drawn
    want = me.matmul_epilogue_plain(y, b.reshape(1, -1), bits, "identity",
                                    0.1)
    bit_equal = torch.equal(out, want)
    keep = float((bits >= me.keep_threshold(0.1)).float().mean())
    zeros = float((out == 0).float().mean())
    log(f"  ffn_2 ({rows}, 768) identity p=0.1, bits drawn on the card: "
        f"bit-equal to the plain version {bit_equal}; kept {keep:.6f} "
        f"(1 - p = 0.9, keep_threshold {me.keep_threshold(0.1)}/256); "
        f"zeros in the output {zeros:.6f}")
    if not bit_equal or abs(keep - 0.9) > 0.009:
        fail(f"matmul_epilogue training: bit-equal {bit_equal}, kept share "
             f"{keep} not within 1% of 0.9")
    worst = 0.0
    for shape, act, p in (((rows, 3072), "gelu", 0.0),
                          ((rows, 768), "identity", 0.1)):
        y = torch.randn(*shape, generator=gen, device=dev)
        bb = torch.randn(1, shape[1], generator=gen, device=dev) * 0.1
        bits = mx.random.bits(shape, dev, gen)
        g = torch.randn(*shape, generator=gen, device=dev)
        grads = []
        for fn in (me.matmul_epilogue_2d, me.matmul_epilogue_plain):
            ty, tb = y.clone().requires_grad_(), bb.clone().requires_grad_()
            out = fn(ty, tb, bits, act_type=act, p=p)
            grads.append(torch.autograd.grad(out, (ty, tb), g))
        torch.cuda.synchronize()
        for name, got, ref in zip(("dy", "dbias"), *grads):
            rel = float((got - ref).abs().max() / ref.abs().max())
            worst = max(worst, rel)
            log(f"  backward {str(shape):14s} {act:8s} p={p:<4g} {name:5s} "
                f"max err {rel:.3e} of max |grad| (tolerance 1e-5)")
    if worst > 1e-5:
        fail(f"matmul_epilogue backward differs from the plain version's "
             f"autograd by {worst} of max |grad|")
    return {"keep": keep, "grad_rel": worst}


# -- phase 11: train long BERT -----------------------------------------------
TRAIN_STEPS = 6                      # 1 warm-up + 5 timed
TRAIN_LR = 1e-4
TRAIN_PER_STEP = {"flash_attention": 12, "flash_attention_bwd_dkv": 12,
                  "flash_attention_bwd_dq": 12, "matmul_epilogue": 24}
GATE_RTOL = 1e-3                     # of max |value|, TF32 off
GATE_PARAMS = ("word_embed.weight",
               "encoder.transformer_cells.0.attention.qkv.weight",
               "encoder.transformer_cells.11.attention.qkv.weight",
               "encoder.transformer_cells.0.ffn.ffn_1.weight",
               "encoder.transformer_cells.11.ffn.ffn_1.weight",
               "decoder.3.weight")


def seeded_mlm(torch, mx, ctx):
    """Full-width BERT-base masked LM at max_length 4096 (the MLM decoder
    over every position, no pooler, no NSP classifier) on ``ctx``:
    Normal(0.02) weights, then seeded biases and LayerNorms, all from one
    generator seeded with SEED."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    dev = ctx.torch_device
    gen = mx.random.generator(SEED, device=dev)
    net = bert_12_768_12(max_length=LONG_SEQ, use_pooler=False,
                         use_classifier=False)
    net.initialize(mx.init.Normal(0.02), ctx=ctx, generator=gen)
    with torch.no_grad():               # materialize the deferred shapes
        net(torch.zeros(1, 8, dtype=torch.int32, device=dev))
        for name, t in net.collect_params().items():
            if name.endswith(("bias", "beta")):
                t.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("gamma"):
                t.normal_(1.0, 0.02, generator=gen)
    _sync(torch)
    return net


def train_step(mx, net, loss_fn, trainer, tokens, labels):
    """One step of the canonical loop: record, per-sample loss, backward,
    Trainer.step(batch size). Returns the per-sample loss."""
    with mx.autograd.record():
        mlm = net(tokens)[1]                    # (B, S, V) logits
        loss = loss_fn(mlm, labels)
    mx.autograd.backward(loss)
    trainer.step(tokens.shape[0])
    return loss


def profile_step(torch, step, wall_ms):
    """Device time of one training step by kernel (torch.profiler) and the
    device's busy share of ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        step()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    dev = {e.key: (e.count, e.self_device_time_total / 1e3) for e in rows}
    device_ms = sum(ms for _, ms in dev.values())
    if device_ms <= 0:
        log("profile: device time not measured (the profiler saw no "
            "kernels)")
        return None, {}
    log(f"profile: one training step: kernels {device_ms:.3f} ms on the "
        f"device ({sum(c for c, _ in dev.values()):.0f} launches), busy "
        f"{device_ms / wall_ms:.3f} of the median step's {wall_ms:.3f} ms")
    for key, (calls, ms) in sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {ms:9.4f} ms {calls:5.0f}x  {key[:90]}")
    return device_ms, dev


def phase_train_long_bert(torch, mx, card, ctx):
    """Train full-width BERT-base MLM at batch 4, S 4096 on ``ctx``, then
    hold one batch-1 step's loss and gradients against the CPU."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    import numpy as np

    dev = ctx.torch_device
    net = seeded_mlm(torch, mx, ctx)
    ids = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (LONG_BATCH, LONG_SEQ)).astype(np.int32)
    tokens = torch.from_numpy(ids).to(dev)
    labels = tokens          # examples/pretrain_bert.py: every position's id
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": TRAIN_LR})
    n_params = sum(t.numel() for t in trainer._params)
    mx.random.seed(SEED)

    def step():
        return train_step(mx, net, loss_fn, trainer, tokens, labels)

    losses, times = [], []
    _sync(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach().mean()))
        del loss
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for kernel, n in TRAIN_PER_STEP.items():
        if launches[kernel] != n * TRAIN_STEPS:
            fail(f"{kernel} launched {launches[kernel]} times in "
                 f"{TRAIN_STEPS} training steps (want {n} each)")
    if launches["conv_epilogue"]:
        fail("conv_epilogue launched on the BERT training path")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"training losses {losses} are not finite or did not fall")
    step_ms = _median(times[1:])
    counted = ", ".join(f"{k} {launches[k]} (= {n} x {TRAIN_STEPS})"
                        for k, n in TRAIN_PER_STEP.items())
    log(f"train: BERT-base MLM, batch {LONG_BATCH}, S {LONG_SEQ}, fp32, "
        f"Adam lr {TRAIN_LR:g}, {n_params} trained parameters, on {card}")
    log(f"train: mean per-sample loss by step "
        f"{[round(x, 6) for x in losses]}")
    log(f"train: step ms {[round(t, 3) for t in times]} (the first warms "
        f"up); median of the last {TRAIN_STEPS - 1} {step_ms:.3f} ms, "
        f"{LONG_BATCH * 1e3 / step_ms:.3f} sequences/s, "
        f"{LONG_BATCH * LONG_SEQ * 1e3 / step_ms:.1f} tokens/s")
    log(f"train: launches in {TRAIN_STEPS} steps: {counted}")
    log(f"train: peak device memory {peak / 2**30:.3f} GiB "
        f"({peak / 2**20:.1f} MiB) over the {TRAIN_STEPS} steps")
    device_ms, _ = profile_step(torch, step, step_ms)

    # the gate: one batch-1 step on the card and on the CPU (plain
    # versions) from the same weights with the same dropout bits
    weights = {k: v.detach().cpu().numpy()
               for k, v in net.collect_params().items()}
    with mx.random.bits_tape() as tape:
        with mx.autograd.record():
            card_loss = loss_fn(net(tokens[:1])[1], labels[:1])
        mx.autograd.backward(card_loss)
    params = net.collect_params()
    card = {k: params[k].grad.detach().cpu().numpy() for k in GATE_PARAMS}
    card["loss"] = card_loss.detach().cpu().numpy()
    del card_loss, params
    cpu_net = bert_12_768_12(max_length=LONG_SEQ, use_pooler=False,
                             use_classifier=False)
    cpu_net.load_dict(weights, ctx=mx.cpu())
    t0 = time.perf_counter()
    with mx.random.bits_tape(replay=tape.drawn):
        with mx.autograd.record():
            cpu_loss = loss_fn(cpu_net(tokens[:1].cpu())[1],
                               labels[:1].cpu())
        mx.autograd.backward(cpu_loss)
    log(f"train: the CPU step at batch 1 took "
        f"{time.perf_counter() - t0:.1f} s ({len(tape.drawn)} dropout "
        "draws replayed from the card)")
    cpu_params = cpu_net.collect_params()
    ref = {k: cpu_params[k].grad.numpy() for k in GATE_PARAMS}
    ref["loss"] = cpu_loss.detach().numpy()
    worst = gate(card, ref)
    del cpu_net, cpu_params, cpu_loss
    graphed = train_long_bert_graphed(torch, mx, net, step, tokens, labels,
                                      loss_fn, card, step_ms)
    return {"launches": launches, "step_ms": step_ms, "losses": losses,
            "peak_bytes": peak, "device_ms": device_ms, "gate_rel": worst,
            "graphed": graphed}


GRAPH_TRAIN_STEPS = 4                # the first captures
GRAPH_TRAIN_PER = ("launches: the hybridized training steps' replays and "
                   "the capture's eager warm-up passes; ms: the profiler's "
                   "sum over one graphed step")


def _gib(n):
    return "not measured" if n is None else f"{n / 2**30:.3f} GiB"


def train_long_bert_graphed(torch, mx, net, step, tokens, labels, loss_fn,
                            card, eager_ms):
    """The MLM hybridized: GRAPH_TRAIN_STEPS steps, the first capturing
    the forward and the backward graphs (dropout drawn inside the
    forward graph); two consecutive replays must draw different masks,
    two replays after mx.random.seed(SEED) equal ones; then one graphed
    forward + backward recorded with a bits tape against an eager one
    replaying those bits, loss and the gated gradients within 1e-5 of
    max |value| (same kernels, same bits)."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.cached_graph import WARMUP_ITERS
    import numpy as np
    eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net.hybridize()
    kernels.reset_launch_counts()
    times, losses, masks = [], [], []
    for i in range(GRAPH_TRAIN_STEPS):
        t0 = time.perf_counter()
        with mx.random.bits_tape() as tape:
            loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach().mean()))
        masks.append(tape.drawn[0].clone())
        del loss, tape
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    runs = GRAPH_TRAIN_STEPS + WARMUP_ITERS
    for kernel, n in TRAIN_PER_STEP.items():
        if launches[kernel] != n * runs:
            fail(f"graphed: {kernel} launched {launches[kernel]} times, want "
                 f"{n} x ({GRAPH_TRAIN_STEPS} steps + {WARMUP_ITERS} warm-up "
                 "passes of the capture)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"graphed training losses {losses} are not finite")
    if torch.equal(masks[-1], masks[-2]):
        fail("two consecutive graphed steps drew the same dropout mask")
    step_ms = _median(times[1:])
    progs = net._graphs.programs()
    log(f"train: hybridized BERT-base MLM: step ms "
        f"{[round(t, 3) for t in times]} (the first warms up and captures "
        f"the forward and backward graphs); median of the last "
        f"{GRAPH_TRAIN_STEPS - 1} {step_ms:.3f} ms against {eager_ms:.3f} "
        f"eager, {LONG_BATCH * 1e3 / step_ms:.3f} sequences/s; losses "
        f"{[round(v, 6) for v in losses]}; {len(progs)} program(s), pool "
        f"{_gib(progs[0].pool_bytes)}, capture {progs[0].capture_s:.3f} s")
    log(f"train: launches in {GRAPH_TRAIN_STEPS} graphed steps and the "
        f"capture's {WARMUP_ITERS} warm-up passes: "
        + ", ".join(f"{k} {launches[k]} (= {n} x {runs})"
                    for k, n in TRAIN_PER_STEP.items()))
    log(f"train: peak device memory eager {eager_peak / 2**30:.3f} GiB, "
        f"graphed {peak / 2**30:.3f} GiB (empty_cache between the halves)")
    device_ms, dev_rows = profile_step(torch, step, step_ms)

    def recorded():
        with mx.random.bits_tape() as tape:
            with mx.autograd.record():
                loss = loss_fn(net(tokens)[1], labels)
            mx.autograd.backward(loss)
        params = net.collect_params()
        got = {k: params[k].grad.detach().cpu().numpy() for k in GATE_PARAMS}
        got["loss"] = loss.detach().cpu().numpy()
        return got, [b.clone() for b in tape.drawn]

    mx.random.seed(SEED)
    _, first = recorded()
    mx.random.seed(SEED)
    graph_q, bits = recorded()
    same = all(torch.equal(a, b) for a, b in zip(first, bits))
    log(f"train: {len(bits)} dropout draws per graphed forward; two replays "
        f"after mx.random.seed({SEED}) drew equal masks: {same}; two "
        "consecutive steps drew different ones: True")
    if not same:
        fail("reseeding did not reproduce the graphed dropout masks")
    net.hybridize(active=False)
    with mx.random.bits_tape(replay=bits):
        with mx.autograd.record():
            loss = loss_fn(net(tokens)[1], labels)
        mx.autograd.backward(loss)
    params = net.collect_params()
    eager_q = {k: params[k].grad.detach().cpu().numpy() for k in GATE_PARAMS}
    eager_q["loss"] = loss.detach().cpu().numpy()
    worst = gate(graph_q, eager_q, 1e-5, "the eager step on the card")
    return {"step_ms": step_ms, "times": times, "losses": losses,
            "launches": launches, "peak_bytes": peak,
            "eager_peak_bytes": eager_peak, "device_ms": device_ms,
            "dev_rows": dev_rows, "pool_bytes": progs[0].pool_bytes,
            "capture_s": progs[0].capture_s, "gate_rel": worst,
            "masks_reproduced": same}


def gate(card, ref, tol=GATE_RTOL, against="the CPU"):
    """Fail unless each quantity of ``card`` is finite and within ``tol``
    of max |value| of the same one in ``ref`` (the CPU's, or ``against``);
    returns the worst relative error."""
    import numpy as np
    worst, bad = 0.0, []
    for name, want in ref.items():
        got = card[name]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        rel = err / scale
        worst = max(worst, rel)
        log(f"train: gate {name} vs {against}: max abs err {err:.6e}, max "
            f"|value| {scale:.6e}, relative {rel:.3e} (tolerance {tol:g})")
        if not (np.isfinite(got).all() and rel <= tol):
            bad.append(f"{name}: {rel}")
    if bad:
        fail(f"training step on the card differs from {against} by more "
             f"than {tol} of max |value| in {bad}")
    return worst


# -- phase 12: kernel K1 training --------------------------------------------
RN_BATCH = 128                       # GluonCV's per-device ResNet-50 batch
RN_SIZE = 224
RN_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RN_GATE_PARAMS = ("features.0.weight", "features.4.0.body.0.weight",
                  "features.4.0.body.1.gamma", "features.7.2.body.4.weight",
                  "output.weight")
RN_GATE_STATS = ("features.1.running_mean", "features.1.running_var",
                 "features.7.2.body.5.running_mean",
                 "features.7.2.body.5.running_var")
K1_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # of max |grad|


def k1_train_bytes(shape, vectors, with_res, dtype_size=4):
    """Bytes of one epilogue's forward and backward, each input read once
    and each output written once: forward y [, res], scale, bias -> out;
    backward g, y [, res], scale, bias -> dy [, dres], dscale, dbias."""
    n = math.prod(shape)
    vec = 2 * shape[1] if vectors else 0
    r = int(with_res)
    return dtype_size * (n * (2 + r) + vec + n * (3 + 2 * r) + 2 * vec)


def k1_leaves(torch, shape, vectors, with_res, dtype, gen):
    """Seeded (y, scale, bias, res, g) on the card; None where absent."""
    dev = torch.device("cuda", 0)
    c = shape[1]

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    scale = (torch.rand(c, generator=gen, device=dev) + 0.5).to(dtype) \
        if vectors else None
    return (rnd(*shape), scale, rnd(c, scale=0.1) if vectors else None,
            rnd(*shape) if with_res else None, rnd(*shape))


def k1_fwd_bwd(torch, fn, inputs, act):
    """``fn``'s output and the gradients of the inputs given, on fresh
    leaves of ``inputs`` = (y, scale, bias, res, g)."""
    *args, g = inputs
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in args]
    out = fn(*leaves, channel_axis=1, act_type=act)
    return out.detach(), torch.autograd.grad(
        out, [t for t in leaves if t is not None], g)


def phase_kernel_k1_train(torch, ce):
    """K1 under autograd at ResNet-50's epilogue shapes at batch RN_BATCH:
    the kernel-backed Function against the plain version's autograd
    (output bit-equal in float32, gradients within K1_GRAD_TOL of max
    |grad|), then forward + backward timed per training step."""
    log("kernel: conv_epilogue under autograd vs the plain version on "
        "the card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    calls = resnet50_epilogues(RN_BATCH)
    bn = sorted({shape for _, shape, v, _ in calls if v})
    res = sorted({shape for _, shape, v, _ in calls if not v})
    cases = [(shape, True, False, "relu") for shape in bn] \
        + [(shape, True, True, "relu") for shape in bn] \
        + [(shape, False, True, "relu") for shape in res] \
        + [(bn[0], True, False, "gelu")]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        tol = K1_GRAD_TOL[name]
        for shape, vectors, with_res, act in cases:
            inputs = k1_leaves(torch, shape, vectors, with_res, dtype, gen)
            kernels_before = ce.launch_count.value
            got, got_g = k1_fwd_bwd(torch, ce.fused_conv_epilogue, inputs,
                                    act)
            if ce.launch_count.value != kernels_before + 1:
                fail("conv_epilogue under autograd did not launch its "
                     "kernel exactly once")
            want, want_g = k1_fwd_bwd(torch, ce.fused_conv_epilogue_plain,
                                      inputs, act)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            names = [n for n, t in zip(("dy", "dscale", "dbias", "dres"),
                                       inputs[:4]) if t is not None]
            rel = {n: float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                   for n, a, b in zip(names, got_g, want_g)}
            worst[name] = max(worst[name], *rel.values())
            log(f"  {str(shape):22s} vectors={int(vectors)} "
                f"res={int(with_res)} {act:5s} {name:8s} out max_err "
                f"{err:.3e}; gradients, max err of max |grad|: "
                + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
                + f" (tolerance {tol:g})")
            if (dtype == torch.float32 and err != 0.0) or any(
                    r > tol for r in rel.values()):
                fail(f"conv_epilogue under autograd differs from the plain "
                     f"version at {shape} {act} {name}: out {err}, "
                     f"gradients {rel}")
            del inputs, got, got_g, want, want_g
    # forward + backward of the 48 epilogues of one training step, fp32
    torch.cuda.empty_cache()
    per_shape = {}
    for _, shape, vectors, with_res in calls:
        key = (shape, vectors, with_res)
        if key in per_shape:
            continue
        inputs = k1_leaves(torch, shape, vectors, with_res, torch.float32,
                           gen)
        per_shape[key] = [event_ms(torch, lambda fn=fn: k1_fwd_bwd(
            torch, fn, inputs, "relu"), 10)
            for fn in (ce.fused_conv_epilogue, ce.fused_conv_epilogue_plain)]
        del inputs
    ms = sum(per_shape[(s, v, r)][0] for _, s, v, r in calls)
    plain_ms = sum(per_shape[(s, v, r)][1] for _, s, v, r in calls)
    total_bytes = sum(k1_train_bytes(s, v, r) for _, s, v, r in calls)
    bound = total_bytes / HBM_BYTES_PER_S * 1e3
    log(f"kernel: forward + backward of the 48 epilogues of one ResNet-50 "
        f"training step at batch {RN_BATCH}, float32: {ms:.3f} ms (the "
        f"kernel forward and the plain VJP), plain {plain_ms:.3f} ms, bytes "
        f"bound {bound:.3f} ms ({total_bytes / 1e9:.3f} GB at 3.35 TB/s); "
        f"max gradient error of max |grad| fp32 {worst['float32']:.3e}, "
        f"bf16 {worst['bfloat16']:.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "grad_rel": worst["float32"], "grad_rel_bf16": worst["bfloat16"]}


# -- phase 13: train ResNet --------------------------------------------------
def product_flops_per_image(torch, net, size):
    """fp32 operations of one forward of one image through every Conv2D
    and Dense of ``net``, from the shapes a batch-1 forward gives."""
    from mxnet_tpu_torch.gluon import nn
    total = [0]

    def hook(module, _, out):
        w = module.weight
        per_out = math.prod(w.shape[1:])         # C_in/groups*kh*kw or in
        total[0] += 2 * out.numel() * per_out

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2D, nn.Dense))]
    with torch.no_grad():
        net(torch.zeros(1, 3, size, size, device=net.output.weight.device))
    for h in handles:
        h.remove()
    return total[0]


class ReluTape:
    """The relu decisions of one ResNet step, recorded on the card and
    replayed on the CPU, as the BERT gate replays the card's dropout bits.

    Two fp32 runs of ResNet-50 (cuDNN and the CPU's convolutions sum in
    other orders) give some relu inputs within rounding of 0 opposite
    signs: tens per image, and each moves the early layers' gradients by
    up to percents (PERF.md §6, PR 7). Replaying the card's signs on the
    CPU keeps every discrete decision equal and every value computed
    apart. Sites: each relu Activation (forward order), each relu6
    Activation (its masks below 0 and above 6) and each conv or matmul
    epilogue's relu, which on the card runs in the kernel and is recorded
    where the backward (the plain VJP) recomputes it, in reverse order;
    the CPU's epilogue applies it in its forward and again in its
    backward. The two kernels share the one act_fn of kernels/_common.py
    and one list here."""

    def __init__(self, torch):
        self.torch = torch
        self.act, self.k1 = [], []
        self.replay = False
        self.differ = self.total = 0

    def _decide(self, p, mask):
        if not self.replay:
            return mask
        own = p > 0
        mask = mask.to(p.device)
        if mask.shape != own.shape:
            fail(f"relu tape: recorded {tuple(mask.shape)}, replayed at "
                 f"{tuple(own.shape)}")
        self.differ += int((own != mask).sum())
        self.total += own.numel()
        return mask

    def __enter__(self):
        from mxnet_tpu_torch.kernels import conv_epilogue as ce
        from mxnet_tpu_torch.kernels import matmul_epilogue as me
        from mxnet_tpu_torch.ops import nn as ops_nn
        torch, tape = self.torch, self
        self._saved = (ce.act_fn, ops_nn.activation)
        act_fn, activation = self._saved
        fwd = iter(self.k1[::-1]) if self.replay else None
        bwd = iter(self.k1) if self.replay else None

        def k1_act(what, act_type):
            if act_type != "relu":
                return act_fn(what, act_type)

            def relu(p):
                if tape.replay:
                    mask = tape._decide(p, next(
                        bwd if torch.is_grad_enabled() else fwd))
                else:
                    mask = p > 0
                    if torch.is_grad_enabled():       # the VJP's recompute
                        tape.k1.append(mask.cpu())
                return torch.where(mask, p, torch.zeros((), dtype=p.dtype,
                                                        device=p.device))
            return relu

        acts = iter(self.act) if self.replay else None

        def stem_act(x, act_type=None):
            if act_type == "relu6":
                return relu6(x)
            if act_type != "relu":
                return activation(x, act_type)
            if tape.replay:
                mask = tape._decide(x, next(acts))
            else:
                mask = x > 0
                tape.act.append(mask.cpu())
            return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

        def relu6(x):
            """clamp(x, 0, 6) deciding at both ends: the masks of x < 0
            and x > 6 (the gradient passes where neither holds, as
            clamp's does) recorded on the card and replayed."""
            if tape.replay:
                low = tape._decide(-x, next(acts))
                high = tape._decide(x - 6, next(acts))
            else:
                low, high = x < 0, x > 6
                tape.act += [low.cpu(), high.cpu()]
            return torch.where(low, torch.zeros((), dtype=x.dtype,
                                                device=x.device),
                               torch.where(high, torch.full(
                                   (), 6, dtype=x.dtype, device=x.device),
                                   x))

        ce.act_fn, me.act_fn, ops_nn.activation = k1_act, k1_act, stem_act
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.kernels import conv_epilogue as ce
        from mxnet_tpu_torch.kernels import matmul_epilogue as me
        from mxnet_tpu_torch.ops import nn as ops_nn
        ce.act_fn, ops_nn.activation = self._saved
        me.act_fn = self._saved[0]


class PoolTape:
    """The window each 2-D max pool output took its value from (either
    convention), recorded on the card (``return_indices``) and replayed
    on the CPU, as ReluTape replays the relu decisions. The CPU's own choices are counted against
    the card's; with ``apply`` the card's are taken by a gather, so the
    gradient reaches the position the card chose. An fp32 ResNet-50's
    stem max pool has, now and then, a window whose two largest inputs
    the card and the CPU order differently: one such choice in 200704
    moves features.0.weight's batch-1 gradient by 1.3e-2 of its max
    |value| (``python3 tools/resnet_probes.py gate-flips`` on the card,
    1 trial of 8; the others 0 choices and <= 9.5e-5)."""

    def __init__(self, torch):
        self.torch = torch
        self.choices = []
        self.replay = self.apply = False
        self.differ = self.total = 0

    def __enter__(self):
        from mxnet_tpu_torch.ops import nn as ops_nn
        torch, tape = self.torch, self
        F = torch.nn.functional
        self._saved = ops_nn.pooling
        pooling = self._saved
        recorded = iter(self.choices) if self.replay else None

        def pool(x, kernel=(), pool_type="max", global_pool=False,
                 stride=None, pad=None, **kwargs):
            if pool_type != "max" or global_pool or x.ndim != 4:
                return pooling(x, kernel, pool_type, global_pool, stride,
                               pad, **kwargs)
            pad = ops_nn._pair(pad or 0, 2)
            kernel = ops_nn._pair(kernel, 2)
            stride = ops_nn._pair(stride or 1, 2)
            hi = list(pad)
            if kwargs.get("pooling_convention", "valid") == "full":
                for i in range(2):      # the ceil convention's extra pad
                    rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) \
                        % stride[i]
                    hi[i] += (stride[i] - rem) % stride[i]
            xp = F.pad(x, (pad[1], hi[1], pad[0], hi[0]),
                       value=-float("inf"))
            out, idx = F.max_pool2d(xp, kernel, stride, return_indices=True)
            if not tape.replay:
                tape.choices.append(idx.cpu())
                return out
            card = next(recorded).to(x.device)
            tape.differ += int((idx != card).sum())
            tape.total += idx.numel()
            if not tape.apply:
                return out
            return xp.flatten(2).gather(2, card.flatten(2)).view_as(out)

        ops_nn.pooling = pool
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.ops import nn as ops_nn
        ops_nn.pooling = self._saved


def phase_train_resnet(torch, mx, card, ctx):
    """Train full-width ResNet-50 v1 at batch RN_BATCH on ``ctx`` through
    record -> SoftmaxCrossEntropyLoss -> backward -> Trainer("sgd"), then
    hold one batch-1 step against the CPU."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    import numpy as np

    dev = ctx.torch_device
    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    flops = product_flops_per_image(torch, net, RN_SIZE) * RN_BATCH * 3
    init_state = {k: v.detach().cpu().numpy().copy()
                  for k, v in net.collect_params().items()}
    # examples/train_imagenet.py's synthetic batch
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(RN_BATCH, 3, RN_SIZE, RN_SIZE)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, (RN_BATCH,))
                         .astype(np.float32)).to(dev)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(RN_SGD))
    n_params = sum(t.numel() for t in trainer._params)

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        mx.autograd.backward(loss)
        trainer.step(RN_BATCH)
        return loss

    losses, times = [], []
    torch.cuda.empty_cache()
    _sync(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach().mean()))
        del loss
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want["conv_epilogue"] = 48 * TRAIN_STEPS
    if launches != want:
        fail(f"launches in {TRAIN_STEPS} ResNet-50 training steps "
             f"{launches}, want {want} (48 conv_epilogue per step)")
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"ResNet-50 training losses {losses} are not finite or did "
             "not fall")
    step_ms = _median(times[1:])
    log(f"train: ResNet-50 v1, batch {RN_BATCH}, {RN_SIZE}x{RN_SIZE}, "
        f"1000 classes, fp32 (TF32 off), SGD lr {RN_SGD['learning_rate']:g} "
        f"momentum {RN_SGD['momentum']:g} wd {RN_SGD['wd']:g}, {n_params} "
        f"trained parameters, on {card}")
    log(f"train: mean per-sample loss by step "
        f"{[round(v, 6) for v in losses]}")
    log(f"train: step ms {[round(t, 3) for t in times]} (the first warms "
        f"up); median of the last {TRAIN_STEPS - 1} {step_ms:.3f} ms, "
        f"{RN_BATCH * 1e3 / step_ms:.3f} images/s")
    log(f"train: launches in {TRAIN_STEPS} steps: conv_epilogue "
        f"{launches['conv_epilogue']} (= 48 x {TRAIN_STEPS}), every other "
        "kernel 0")
    log(f"train: peak device memory {peak / 2**30:.3f} GiB "
        f"({peak / 2**20:.1f} MiB) over the {TRAIN_STEPS} steps")
    device_ms, dev_rows = profile_step(torch, step, step_ms)
    k1 = [(c, ms) for k, (c, ms) in dev_rows.items()
          if "conv_epilogue_kernel" in k]
    conv = [(c, ms) for k, (c, ms) in dev_rows.items()
            if "conv_epilogue" not in k and re.search(
                r"conv|fprop|dgrad|wgrad|xmma|implicit|cudnn", k, re.I)]
    k1_ms, conv_ms = sum(ms for _, ms in k1), sum(ms for _, ms in conv)
    log(f"profile: conv_epilogue_kernel (K1's forward) {k1_ms:.3f} ms in "
        f"{sum(c for c, _ in k1):.0f} launches; cuDNN convolutions (fprop, "
        f"dgrad, wgrad) {conv_ms:.3f} ms in {sum(c for c, _ in conv):.0f} "
        "launches")
    log(f"train: {flops / 1e12:.4f} TFLOP per step (convolutions and Dense "
        f"from their shapes, forward x 3): {flops / step_ms / 1e9:.2f} "
        f"TFLOP/s over the step, {flops / step_ms / 1e9 / 67:.3f} of the "
        f"67 TFLOP/s fp32 peak; over the convolutions' device time "
        f"{flops / conv_ms / 1e9 if conv_ms else float('nan'):.2f} TFLOP/s")

    # the gate: one batch-1 step on the card and on the CPU from the same
    # weights and running statistics
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in net.collect_params().items()}

    def gate_step(model, xb, yb):
        with mx.autograd.record():
            loss = loss_fn(model(xb), yb)
        mx.autograd.backward(loss)
        params = model.collect_params()
        got = {k: params[k].grad.detach().cpu().numpy().copy()
               for k in RN_GATE_PARAMS}
        got.update({k: params[k].detach().cpu().numpy().copy()
                    for k in RN_GATE_STATS})
        got["loss"] = loss.detach().cpu().numpy()
        return got

    tape, pool = ReluTape(torch), PoolTape(torch)
    with tape, pool:
        card_q = gate_step(net, x[:1], y[:1])
    cpu_net = resnet50_v1()
    cpu_net.load_dict(state, ctx=mx.cpu())
    t0 = time.perf_counter()
    tape.replay = pool.replay = pool.apply = True
    with tape, pool:
        cpu_q = gate_step(cpu_net, x[:1].cpu(), y[:1].cpu())
    log(f"train: the CPU step at batch 1 took "
        f"{time.perf_counter() - t0:.1f} s; {len(tape.act)} stem and "
        f"{len(tape.k1)} epilogue relu decisions replayed from the card, "
        f"{tape.differ} of {tape.total} relu inputs the CPU alone would "
        f"have decided the other way; {len(pool.choices)} max pool's "
        f"choices replayed, {pool.differ} of {pool.total} windows the CPU "
        "alone would have taken from another position")
    worst = gate(card_q, cpu_q)
    del cpu_net
    graphed = train_resnet_graphed(torch, mx, net, x, y, loss_fn,
                                   init_state, card, step_ms, losses)
    return {"launches": launches, "step_ms": step_ms, "losses": losses,
            "peak_bytes": peak, "device_ms": device_ms, "k1_ms": k1_ms,
            "conv_ms": conv_ms, "flops": flops, "gate_rel": worst,
            "graphed": graphed}


RN_GRAPH_RTOL = 1e-4                 # graphed vs eager step, of max


def train_resnet_graphed(torch, mx, net, x, y, loss_fn, state, card,
                         eager_ms, eager_losses):
    """ResNet-50 hybridized from the eager run's initial weights and
    running statistics (``state``) with a fresh SGD, as the eager run
    began: TRAIN_STEPS steps, the first
    capturing the forward graph (BatchNorm's running statistics updated
    in place inside it) and the backward graph; then, with cuDNN
    deterministic, one graphed forward + backward from that same state
    against an eager one: the loss, the gated gradients and running
    statistics within RN_GRAPH_RTOL of max |value|."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.cached_graph import WARMUP_ITERS
    eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net.load_dict(state)                     # in place
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(RN_SGD))
    net.hybridize()

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        mx.autograd.backward(loss)
        trainer.step(RN_BATCH)
        return loss

    kernels.reset_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach().mean()))
        del loss
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    runs = TRAIN_STEPS + WARMUP_ITERS
    want = dict.fromkeys(launches, 0)
    want["conv_epilogue"] = 48 * runs
    if launches != want:
        fail(f"graphed: launches {launches}, want {want} (48 conv_epilogue "
             f"x ({TRAIN_STEPS} steps + {WARMUP_ITERS} warm-up passes of "
             "the capture))")
    if not all(math.isfinite(v) for v in losses):
        fail(f"graphed ResNet-50 losses {losses} are not finite")
    step_ms = _median(times[1:])
    progs = net._graphs.programs()
    log(f"train: hybridized ResNet-50: step ms {[round(t, 3) for t in times]}"
        f" (the first warms up and captures); median of the last "
        f"{TRAIN_STEPS - 1} {step_ms:.3f} ms against {eager_ms:.3f} eager, "
        f"{RN_BATCH * 1e3 / step_ms:.3f} images/s; {len(progs)} program(s),"
        f" pool {_gib(progs[0].pool_bytes)}, capture "
        f"{progs[0].capture_s:.3f} s")
    log(f"train: graphed losses {[round(v, 6) for v in losses]}, eager "
        f"{[round(v, 6) for v in eager_losses]} (same start, same batch)")
    log(f"train: launches in {TRAIN_STEPS} graphed steps and the capture's "
        f"{WARMUP_ITERS} warm-up passes: conv_epilogue "
        f"{launches['conv_epilogue']} (= 48 x {runs}), every other kernel 0")
    log(f"train: peak device memory eager {eager_peak / 2**30:.3f} GiB, "
        f"graphed {peak / 2**30:.3f} GiB (empty_cache between the halves)")
    device_ms, dev_rows = profiled(
        "graphed step", lambda: profile_step(torch, step, step_ms),
        lambda r: not r[1] or _kernel_count(r[1], "conv_epilogue") == 48)
    k1 = [(c, ms) for k, (c, ms) in dev_rows.items()
          if "conv_epilogue_kernel" in k]
    k1_ms, k1_n = sum(ms for _, ms in k1), sum(c for c, _ in k1)
    if dev_rows:
        log(f"profile: graphed step: conv_epilogue_kernel {k1_ms:.3f} ms in "
            f"{k1_n:.0f} launches (captured: "
            f"{progs[0].fwd_launches.get('conv_epilogue', 0)} per forward)")
        if k1_n != 48:
            fail(f"the profiler saw {k1_n} conv_epilogue launches in a "
                 "graphed step, want 48")

    # graphed vs eager from one state, cuDNN deterministic
    def quantities():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        mx.autograd.backward(loss)
        params = net.collect_params()
        got = {k: params[k].grad.detach().cpu().numpy().copy()
               for k in RN_GATE_PARAMS}
        got.update({k: params[k].detach().cpu().numpy().copy()
                    for k in RN_GATE_STATS})
        got["loss"] = loss.detach().cpu().numpy()
        return got

    torch.backends.cudnn.deterministic = True
    try:
        net.hybridize(active=False)
        net.load_dict(state)
        eager_q = quantities()
        net.load_dict(state)
        net.hybridize()
        graph_q = quantities()
    finally:
        torch.backends.cudnn.deterministic = False
        net.hybridize(active=False)
    worst = gate(graph_q, eager_q, RN_GRAPH_RTOL,
                 "the eager step on the card")
    return {"step_ms": step_ms, "times": times, "losses": losses,
            "launches": launches, "peak_bytes": peak,
            "eager_peak_bytes": eager_peak, "device_ms": device_ms,
            "k1_ms": k1_ms if dev_rows else None,
            "pool_bytes": progs[0].pool_bytes,
            "capture_s": progs[0].capture_s, "gate_rel": worst}


# -- phase 14: train through ShardedTrainer in bf16 ----------------------------
SH_GATE_RTOL = 3e-2                  # card vs CPU, bf16, of max |value|
SH_GRAPH_RTOL = 1e-5                 # graphed vs eager step, of max |value|
SH_LOSS_RTOL = 0.05                  # bf16 vs fp32 losses, relative
SH_FP32_STEPS = 4                    # the first captures
SH_RN_BATCH = 256                    # examples/train_imagenet.py's default
SH_BERT = {"b": (64, 128, 6), "c": (4, 4096, 4)}   # batch, S, steps
SH_RN_STEPS = 6


def sh_mesh(mx, ctx):
    """examples/train_imagenet.py's mesh on one card ({"data": 1,
    "model": 1}); the CPU's for the gate."""
    devices = None if ctx.device_type == "gpu" else [ctx]
    return mx.parallel.make_mesh({"data": 1, "model": 1}, devices=devices)


def sh_resnet(torch, mx, ctx, dtype, state=None):
    """examples/train_imagenet.py's trainer for its default network,
    resnet50_v1 (see :func:`tz_trainer`)."""
    return tz_trainer(torch, mx, ctx, "resnet50_v1", dtype, state)


def mlm_model(torch, mx, ctx, seq, state=None, dropout=0.1, seed=SEED):
    """examples/pretrain_bert.py's model: bert_12_768_12, vocab 30522,
    max_length max(512, S), no pooler or classifier, Normal(0.02) from
    ``seed`` (or ``state``), the MLM logits kept 3-D by its wrapper."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert_model

    class MLMWrapper(mx.gluon.HybridBlock):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, tokens):
            return self.inner(tokens)[1]

    net = get_bert_model("bert_12_768_12", vocab_size=BERT_VOCAB,
                         max_length=max(512, seq), dropout=dropout,
                         use_pooler=False, use_classifier=False)
    net.initialize(mx.init.Normal(0.02), ctx=ctx,
                   generator=mx.random.generator(seed))
    model = MLMWrapper(net)
    if state is not None:
        with torch.no_grad():
            model(torch.zeros(1, 8, dtype=torch.int32,
                              device=ctx.torch_device))
        model.load_dict(state)
    return model


def sh_bert(torch, mx, ctx, dtype, seq, state=None):
    """examples/pretrain_bert.py's trainer: :func:`mlm_model` at dropout
    0.1, Adam lr 1e-4."""
    model = mlm_model(torch, mx, ctx, seq, state)
    trainer = mx.parallel.ShardedTrainer(
        model, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        optimizer_params={"learning_rate": TRAIN_LR}, mesh=sh_mesh(mx, ctx),
        compute_dtype=dtype)
    return model, trainer


def sh_release(torch, trainer):
    """Free a trainer's graphs and their pools (its last outputs live in
    the pool of the graph that made them)."""
    trainer.last_outputs = None
    trainer._release()
    torch.cuda.empty_cache()


def sh_snapshot(trainer):
    tensors = list(trainer._trainable) + [s for st in trainer._states
                                          for s in st] + list(trainer._aux)
    return tensors, [t.detach().clone() for t in tensors], \
        trainer._num_update


def sh_restore(torch, snap):
    tensors, saved, _ = snap
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)


def sh_params(trainer, names):
    params = trainer._block.collect_params()
    return {k: params[k].detach().float().cpu().numpy().copy()
            for k in names}


def sh_profile(torch, step, wall_ms, what="step"):
    """One profiled step (or ``what``): device time, busy share of
    ``wall_ms``, host launch calls and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev = {e.key: (e.count, e.self_device_time_total / 1e3) for e in rows
           if str(e.device_type).endswith("CUDA")}
    device_ms = sum(ms for _, ms in dev.values())
    calls = _launch_calls(rows)
    graphs = sum(e.count for e in rows
                 if not str(e.device_type).endswith("CUDA")
                 and "GraphLaunch" in e.key)
    if device_ms <= 0:
        log(f"profile: device time not measured (the profiler saw no "
            f"kernels); {calls} host launch calls per {what} ({graphs} "
            "graph launches)")
        return {"device_ms": None, "busy": None, "host_launch_calls": calls,
                "graph_launches": graphs, "rows": {}}
    log(f"profile: one graphed {what}: kernels {device_ms:.3f} ms on the "
        f"device ({sum(c for c, _ in dev.values()):.0f} launches), busy "
        f"{device_ms / wall_ms:.3f} of the median {what}'s {wall_ms:.3f} ms;"
        f" {calls} host launch calls per {what}, {graphs} of them graph "
        "launches")
    for key, (c, ms) in sorted(dev.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"  {ms:9.4f} ms {c:5.0f}x  {key[:90]}")
    return {"device_ms": device_ms, "busy": device_ms / wall_ms,
            "host_launch_calls": calls, "graph_launches": graphs,
            "rows": dev}


def sh_train(torch, mx, name, trainer, batch, steps, per_step, unit,
             per_unit, card):
    """``steps`` ShardedTrainer steps (the first captures the graph),
    timed; launches counted from 0 across them; profiled after."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.cached_graph import WARMUP_ITERS
    mx.random.seed(SEED)
    _sync(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = trainer.step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    runs = steps + WARMUP_ITERS
    want = dict.fromkeys(launches, 0)
    want.update({k: n * runs for k, n in per_step.items()})
    if launches != want:
        fail(f"train-sharded {name}: launches {launches}, want {want} "
             f"({per_step} x ({steps} steps + {WARMUP_ITERS} warm-up passes "
             "of the capture))")
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"train-sharded {name}: losses {losses} are not finite or did "
             "not fall")
    progs = list(trainer._programs.values())
    if len(progs) != 1:
        fail(f"train-sharded {name}: {len(progs)} programs, want 1")
    step_ms = _median(times[1:])
    rate = per_unit * 1e3 / step_ms
    log(f"train-sharded {name}: losses {[round(v, 6) for v in losses]}; "
        f"step ms {[round(t, 3) for t in times]} (the first warms up and "
        f"captures the step); median of the last {steps - 1} {step_ms:.3f} "
        f"ms, {rate:.3f} {unit}/s on {card}")
    log(f"train-sharded {name}: capture {progs[0].capture_s:.3f} s, graph "
        f"pool {_gib(progs[0].pool_bytes)}, peak device memory "
        f"{peak / 2**30:.3f} GiB; launches over the steps and the "
        f"capture's {WARMUP_ITERS} warm-up passes: "
        + ", ".join(f"{k} {launches[k]} (= {n} x {runs})"
                    for k, n in per_step.items()) + ", every other kernel 0")
    prof = profiled(
        f"train-sharded {name} step",
        lambda: sh_profile(torch, lambda: trainer.step(*batch), step_ms),
        lambda p: not p["rows"] or all(
            _kernel_count(p["rows"], k) == n for k, n in per_step.items()))
    # one graph launch; a graph that draws dropout bits also makes
    # PyTorch write each registered generator's seed and offset before
    # the replay (two fill kernels per generator)
    want_calls = 1 + 2 * progs[0].generators
    log(f"train-sharded {name}: host launch calls per step: 1 graph launch"
        f" + {2 * progs[0].generators} for the seed and offset of "
        f"{progs[0].generators} dropout generator(s) = {want_calls}")
    if prof["host_launch_calls"] != want_calls \
            or prof["graph_launches"] != 1:
        fail(f"train-sharded {name}: {prof['host_launch_calls']} host launch "
             f"calls ({prof['graph_launches']} graph launches) per graphed "
             f"step, want {want_calls} (1)")
    for kernel, n in per_step.items():
        seen = sum(c for k, (c, _) in prof["rows"].items()
                   if _is_kernel(k, kernel))
        if prof["rows"] and seen != n:
            fail(f"train-sharded {name}: the profiler saw {seen} {kernel} "
                 f"launches in a graphed step, want {n}")
    kernel_ms = {k: sum(ms for key, (_, ms) in prof["rows"].items()
                        if _is_kernel(key, k)) for k in per_step}
    return {"losses": losses, "times": times, "step_ms": step_ms,
            "rate": rate, "peak_bytes": peak, "launches": launches,
            "capture_s": progs[0].capture_s,
            "pool_bytes": progs[0].pool_bytes, "device_ms": prof["device_ms"],
            "busy": prof["busy"],
            "host_launch_calls": prof["host_launch_calls"],
            "generators": progs[0].generators, "kernel_ms": kernel_ms}


def sh_graph_vs_eager(torch, mx, trainer, batch, names, deterministic):
    """One graphed step and one eager step on the card from the same
    state (cuDNN deterministic for the ResNet, the graph's dropout bits
    replayed for BERT): the loss, the gated weights after the update and
    every running statistic within SH_GRAPH_RTOL of max |value|."""
    snap = sh_snapshot(trainer)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        if deterministic:
            sh_release(torch, trainer)      # capture under determinism
        with mx.random.bits_tape() as tape:
            loss = trainer.step(*batch)
        graph_q = sh_params(trainer, names)
        graph_q["loss"] = loss.cpu().numpy()
        bits = [b.clone() for b in tape.drawn]
        del loss
        if deterministic:
            sh_release(torch, trainer)      # room for the eager step
        sh_restore(torch, snap)
        trainer._num_update = snap[2]
        backend, trainer._backend = trainer._backend, None
        try:
            with mx.random.bits_tape(replay=bits):
                loss = trainer.step(*batch)
        finally:
            trainer._backend = backend
        eager_q = sh_params(trainer, names)
        eager_q["loss"] = loss.cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic = old
        sh_restore(torch, snap)
        trainer._num_update = snap[2]
        if deterministic:
            sh_release(torch, trainer)
    import numpy as np
    equal = all(np.array_equal(graph_q[k], eager_q[k]) for k in graph_q)
    log(f"train-sharded: graphed vs eager step on the card from one state "
        f"({len(bits)} dropout draws replayed, cuDNN deterministic "
        f"{deterministic}): bit-equal {equal}")
    return gate(graph_q, eager_q, SH_GRAPH_RTOL,
                "the eager step on the card"), equal


class ValueTape:
    """The output of every BatchNorm, residual epilogue and matmul
    epilogue (and, with ``convs``, convolution) of one step, and the
    gradient arriving at it, recorded on the card and replayed on the
    CPU.

    In bf16 ResNet-50 is a chaotic amplifier of rounding: an H100 and
    the CPU, which round a convolution differently, part by 0.13% at the
    first BatchNorm and by 59% at the last, with every relu decision
    replayed (``tools/resnet_probes.py bf16-divergence``), where fp32
    runs part by about 1e-5. So the gate
    teacher-forces it: at each site the CPU takes the card's value
    (``card + (own - own.detach())``: the CPU's own computation stays in
    the graph) and, in its backward, the card's gradient. Every layer's
    forward and backward on the CPU then starts from the card's inputs,
    and the gated gradients hold each layer's own arithmetic. Each site
    is gated too: before it is replaced, the CPU's own value, and the
    gradient the CPU computed arriving at the site, against the card's
    (``parted`` and ``grad_parted``: the worst relative difference, of
    the card's max |value| at that site, and the site's index).

    With ``convs`` each convolution's output is a site too, so that a
    BatchNorm's own arithmetic starts from the card's convolution: at
    batch 1 a channel whose variance is small against its mean turns
    the one-ulp bf16 difference of two devices' convolutions into
    percents of the normalized output (phase 27's vgg16_bn: 2.956e-2 at
    its third BatchNorm without them)."""

    def __init__(self, torch, convs=False):
        self.torch = torch
        self.convs = convs
        self.values, self.grads = [], {}
        self.replay = False
        self.parted = self.grad_parted = (0.0, 0)
        self.grads_compared = 0

    @staticmethod
    def _worst(worst, own, card, i):
        scale = max(float(card.float().abs().max()), 1e-30)
        rel = float((own.detach().float() - card.float()).abs().max()) / scale
        return max(worst, (rel, i), key=lambda w: w[0])

    def _grad(self, i, g):
        card = self.grads[i].to(g.device, g.dtype)
        self.grad_parted = self._worst(self.grad_parted, g, card, i)
        self.grads_compared += 1
        return card

    def _site(self, out):
        i = self._n
        self._n += 1
        if not self.replay:
            self.values.append(out.detach().cpu())
            if out.requires_grad:
                out.register_hook(lambda g, i=i: self.grads.__setitem__(
                    i, g.detach().cpu()))
            return out
        card = self.values[i].to(out.device)
        if card.shape != out.shape:
            fail(f"value tape: recorded {tuple(card.shape)}, replayed at "
                 f"{tuple(out.shape)}")
        self.parted = self._worst(self.parted, out, card, i)
        new = card + (out - out.detach())
        if new.requires_grad and i in self.grads:
            new.register_hook(lambda g, i=i: self._grad(i, g))
        return new

    def __enter__(self):
        from mxnet_tpu_torch.ops import contrib
        from mxnet_tpu_torch.ops import nn as ops_nn
        self._n = 0
        self._saved = (ops_nn.batch_norm, contrib.conv_epilogue,
                       contrib.matmul_epilogue, ops_nn.convolution)
        batch_norm, conv_epilogue, matmul_epilogue, convolution = \
            self._saved
        tape = self

        def bn(*args, **kwargs):
            out, mean, var = batch_norm(*args, **kwargs)
            return tape._site(out), mean, var

        ops_nn.batch_norm = bn
        contrib.conv_epilogue = lambda *a, **k: tape._site(
            conv_epilogue(*a, **k))
        contrib.matmul_epilogue = lambda *a, **k: tape._site(
            matmul_epilogue(*a, **k))
        if self.convs:
            ops_nn.convolution = lambda *a, **k: tape._site(
                convolution(*a, **k))
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.ops import contrib
        from mxnet_tpu_torch.ops import nn as ops_nn
        (ops_nn.batch_norm, contrib.conv_epilogue, contrib.matmul_epilogue,
         ops_nn.convolution) = self._saved


def sh_card_vs_cpu(torch, mx, trainer, make_cpu, batch1, grads, stats,
                   resnet, pools=False, convs=False):
    """One batch-1 bf16 step's loss and gradients (the trainer's own
    differentiated function) on the card and on the CPU from the same
    weights and statistics, and the running statistics after the
    forward. BERT replays the card's dropout bits; the ResNet its relu
    decisions (ReluTape) and each BatchNorm's and residual epilogue's
    value and gradient (ValueTape)."""
    snap = sh_snapshot(trainer)
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in trainer._block.collect_params().items()}

    def quantities(tr, xs):
        dev = tr.device
        loss, gs, _ = tr._loss_and_grads(
            [x.to(dev) for x in xs[:-1]], xs[-1].to(dev))
        by_name = dict(zip((n for n, _ in tr._named), gs))
        got = {k: by_name[k].float().cpu().numpy() for k in grads}
        got.update(sh_params(tr, stats))
        got["loss"] = loss.cpu().numpy()
        return got

    tapes = [ReluTape(torch), ValueTape(torch, convs)] if resnet else []
    if pools:
        tapes.append(PoolTape(torch))
    with mx.random.bits_tape() as bits, contextlib.ExitStack() as stack:
        for tape in tapes:
            stack.enter_context(tape)
        card_q = quantities(trainer, batch1)
    sh_restore(torch, snap)
    cpu_tr = make_cpu(state)
    cpu_tr.prepare(*[x.cpu() for x in batch1[:-1]])
    t0 = time.perf_counter()
    with mx.random.bits_tape(replay=[b.cpu() for b in bits.drawn]), \
            contextlib.ExitStack() as stack:
        for tape in tapes:
            tape.replay = True
            tape.apply = True           # PoolTape: take the card's windows
            stack.enter_context(tape)
        cpu_q = quantities(cpu_tr, [x.cpu() for x in batch1])
    extra = ""
    if resnet:
        relu, value = tapes[:2]
        extra = (f"; {relu.differ} of {relu.total} relu inputs the CPU "
                 f"alone would have decided the other way; {value._n} "
                 f"BatchNorm, epilogue{' and convolution' * convs} "
                 "outputs and "
                 f"{value.grads_compared} of their gradients replayed")
    if pools:
        extra += (f"; {tapes[2].differ} of {tapes[2].total} max pool "
                  "windows the CPU alone would have taken from another "
                  "position")
    log(f"train-sharded: the CPU's batch-1 bf16 step took "
        f"{time.perf_counter() - t0:.1f} s ({len(bits.drawn)} dropout "
        f"draws replayed from the card{extra})")
    worst = gate(card_q, cpu_q, SH_GATE_RTOL)
    if resnet:
        bad = []
        for what, (rel, site), n in (
                ("output", value.parted, value._n),
                ("incoming gradient", value.grad_parted,
                 value.grads_compared)):
            log(f"train: gate each BatchNorm and residual epilogue's "
                f"{what} vs the card's, the CPU's own before it is "
                f"replaced: worst relative {rel:.3e} at site {site} of {n} "
                f"(tolerance {SH_GATE_RTOL:g})")
            if not rel <= SH_GATE_RTOL:
                bad.append(f"{what} at site {site}: {rel}")
        if not value.grads_compared:
            bad.append("no incoming gradient was compared")
        if bad:
            fail(f"train-sharded: a layer's own bf16 arithmetic on the CPU "
                 f"differs from the card's by more than {SH_GATE_RTOL} of "
                 f"max |value| in {bad}")
        worst = max(worst, value.parted[0], value.grad_parted[0])
    return worst


def sh_fp32(torch, mx, name, make, batch, bf16_losses, unit, per_unit):
    """The same trainer in fp32 (compute_dtype None) from the same initial
    weights and batch: SH_FP32_STEPS graphed steps; the first 3 losses
    against the bf16 run's within SH_LOSS_RTOL."""
    mx.random.seed(SEED)
    _, trainer = make()
    losses, times = [], []
    for _ in range(SH_FP32_STEPS):
        t0 = time.perf_counter()
        loss = trainer.step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    step_ms = _median(times[1:])
    rel = [abs(a - b) / abs(b) for a, b in zip(bf16_losses[:3], losses[:3])]
    log(f"train-sharded {name}: fp32 losses {[round(v, 6) for v in losses]}"
        f" vs bf16 {[round(v, 6) for v in bf16_losses[:3]]}: relative "
        f"{[round(r, 5) for r in rel]} (tolerance {SH_LOSS_RTOL}); fp32 "
        f"step ms {[round(t, 3) for t in times]}, median of the last "
        f"{SH_FP32_STEPS - 1} {step_ms:.3f} ms, {per_unit * 1e3 / step_ms:.3f}"
        f" {unit}/s")
    sh_release(torch, trainer)
    del trainer
    torch.cuda.empty_cache()
    if max(rel) > SH_LOSS_RTOL:
        fail(f"train-sharded {name}: bf16 losses differ from fp32 ones by "
             f"{max(rel)} > {SH_LOSS_RTOL}")
    return {"losses": losses, "step_ms": step_ms, "rel": max(rel)}


def phase_train_sharded(torch, mx, card, ctx):
    """examples/train_imagenet.py and examples/pretrain_bert.py as written
    on one card, through mx.parallel.ShardedTrainer(..., mesh=make_mesh(
    {...}), compute_dtype="bfloat16"): (a) ResNet-50 v1 at batch 256, (b)
    the BERT-base MLM at batch 64, S 128, (c) at batch 4, S 4096."""
    import numpy as np
    out = {}
    dev = ctx.torch_device
    torch.cuda.empty_cache()

    # (a) ResNet-50 v1, batch 256
    rng = np.random.RandomState(0)      # train_imagenet.py's synthetic batch
    x = rng.randn(SH_RN_BATCH, 3, RN_SIZE, RN_SIZE).astype(np.float32)
    y = rng.randint(0, 1000, (SH_RN_BATCH,))
    batch = (torch.from_numpy(x).to(dev),
             torch.from_numpy(y.astype(np.int32)).to(dev))
    del x
    net, trainer = sh_resnet(torch, mx, ctx, "bfloat16")
    trainer.prepare(batch[0])           # the deferred shapes
    init = {k: v.detach().cpu().numpy().copy()
            for k, v in net.collect_params().items()}
    log(f"train-sharded (a): resnet50_v1, batch {SH_RN_BATCH}, "
        f"{RN_SIZE}x{RN_SIZE}, bf16 compute, fp32 masters, SGD "
        f"lr {RN_SGD['learning_rate']:g} momentum {RN_SGD['momentum']:g} "
        f"wd {RN_SGD['wd']:g}, mesh {mx.parallel.mesh_signature(trainer.mesh)}")
    res = sh_train(torch, mx, "(a)", trainer, batch, SH_RN_STEPS,
                   {"conv_epilogue": 48}, "images", SH_RN_BATCH, card)
    names = RN_GATE_PARAMS + RN_GATE_STATS
    res["graph_rel"], res["graph_equal"] = sh_graph_vs_eager(
        torch, mx, trainer, batch, names, deterministic=True)
    res["gate_rel"] = sh_card_vs_cpu(
        torch, mx, trainer,
        lambda state: sh_resnet(torch, mx, mx.cpu(), "bfloat16", state)[1],
        [b[:1] for b in batch], RN_GATE_PARAMS, RN_GATE_STATS, resnet=True)
    sh_release(torch, trainer)
    del net, trainer
    torch.cuda.empty_cache()
    res["fp32"] = sh_fp32(torch, mx, "(a)",
                          lambda: sh_resnet(torch, mx, ctx, None, init),
                          batch, res["losses"], "images", SH_RN_BATCH)
    out["a"] = res
    del batch, init
    torch.cuda.empty_cache()

    # (b), (c): the BERT-base MLM
    grads = tuple(f"inner.{k}" for k in GATE_PARAMS)
    per = {"b": {"matmul_epilogue": 24},
           "c": dict(TRAIN_PER_STEP)}
    for cfg, (b, seq, steps) in SH_BERT.items():
        tokens = np.random.RandomState(0).randint(0, BERT_VOCAB, (b, seq))
        ids = torch.from_numpy(tokens.astype(np.int32)).to(dev)
        batch = (ids, ids)              # pretrain_bert.py: the ids as labels
        model, trainer = sh_bert(torch, mx, ctx, "bfloat16", seq)
        trainer.prepare(ids)
        init = {k: v.detach().cpu().numpy().copy()
                for k, v in model.collect_params().items()} \
            if cfg == "b" else None
        log(f"train-sharded ({cfg}): bert_12_768_12 MLM, batch {b}, S {seq}"
            f", vocab {BERT_VOCAB}, dropout 0.1, bf16 compute, fp32 masters,"
            f" Adam lr {TRAIN_LR:g}")
        res = sh_train(torch, mx, f"({cfg})", trainer, batch, steps,
                       per[cfg], "sequences", b, card)
        log(f"train-sharded ({cfg}): {b * seq * 1e3 / res['step_ms']:.1f} "
            "tokens/s")
        if cfg == "c":
            km = {k: v or 0.0 for k, v in res["kernel_ms"].items()}
            fwd = km["flash_attention"]
            dkv, dq = km["flash_attention_bwd_dkv"], km[
                "flash_attention_bwd_dq"]
            res["k3_share"] = fwd / res["step_ms"]
            log(f"train-sharded (c): step {res['step_ms']:.3f} ms; in one "
                f"profiled graphed step flash_attention {fwd:.3f} ms "
                f"({res['k3_share']:.3f} of the step), "
                f"flash_attention_bwd_dkv {dkv:.3f} ms + _dq {dq:.3f} ms "
                f"({(dkv + dq) / res['step_ms']:.3f})")
        res["graph_rel"], res["graph_equal"] = sh_graph_vs_eager(
            torch, mx, trainer, batch, grads, deterministic=False)
        res["gate_rel"] = sh_card_vs_cpu(
            torch, mx, trainer,
            lambda state: sh_bert(torch, mx, mx.cpu(), "bfloat16", seq,
                                  state)[1],
            [t[:1] for t in batch], grads, (), resnet=False)
        sh_release(torch, trainer)
        del model, trainer
        torch.cuda.empty_cache()
        if cfg == "b":
            res["fp32"] = sh_fp32(
                torch, mx, f"({cfg})",
                lambda: sh_bert(torch, mx, ctx, None, seq, init), batch,
                res["losses"], "sequences", b)
        out[cfg] = res
        del batch, ids
        torch.cuda.empty_cache()
    return out


# -- phase 16: train-recipe --------------------------------------------------
RC_BATCH, RC_SEQ = SH_BERT["b"][:2]  # examples/pretrain_bert.py's defaults
RC_WINDOW = 8                        # run_steps(num_steps=8)
RC_WINDOWS = 3                       # timed windows after the capturing one
RC_STEPS = 5                         # graphed step() calls; the first captures
RC_LAMB = {"learning_rate": 1e-4, "wd": 0.01}
RC_SCHED = {"max_update": 1000, "base_lr": 1e-4, "pwr": 1,
            "warmup_steps": 10}
RC_CLIP = 1.0                        # GuardConfig(clip_norm=)
RC_NO_DECAY = r".*bias|.*gamma|.*beta"
RC_K2 = 24                           # K2 launches per inner step
RC_MLP = (32, 128, 256, 64)          # batch, in, hidden, out
RC_OPTIMIZERS = {                    # the functional rules, as in
    "sgd": {"learning_rate": 0.1, "momentum": 0.9},   # tests/test_torch_
    "nag": {"learning_rate": 0.1, "momentum": 0.9},   # optimizers.py
    "adam": {"learning_rate": 0.01},
    "adamw": {"learning_rate": 0.01},
    "lamb": {"learning_rate": 0.01},
    "rmsprop": {"learning_rate": 0.01},
    "adagrad": {"learning_rate": 0.1},
    "ftrl": {"learning_rate": 0.1},
    "signum": {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 0.01},
    "adadelta": {"rho": 0.9},
    "nadam": {"learning_rate": 0.01},
    "dcasgd": {"learning_rate": 0.1, "momentum": 0.9},
    "ftml": {"learning_rate": 0.01},
}


def rc_trainer(torch, mx, ctx, dropout=0.1, state=None, seed=SEED,
               guard=None):
    """The recipe: :func:`mlm_model`, bf16 compute and fp32 masters on a
    one-device mesh; LAMB (lr 1e-4, wd 0.01) with PolyScheduler
    (max_update 1000, pwr 1, warm-up 10); wd multiplier 0 on every
    bias, gamma and beta, by trainable index; GuardConfig(clip_norm=1),
    or ``guard``."""
    model = mlm_model(torch, mx, ctx, RC_SEQ, state, dropout, seed)
    opt = mx.optimizer.create(
        "lamb", **RC_LAMB,
        lr_scheduler=mx.lr_scheduler.PolyScheduler(**RC_SCHED))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    opt.set_wd_mult({i: 0.0 for i, n in enumerate(names)
                     if re.fullmatch(RC_NO_DECAY, n)})
    trainer = mx.parallel.ShardedTrainer(
        model, mx.gluon.loss.SoftmaxCrossEntropyLoss(), opt,
        mesh=sh_mesh(mx, ctx), compute_dtype="bfloat16",
        guard=guard or mx.guardrails.GuardConfig(clip_norm=RC_CLIP))
    return model, trainer


def rc_program(trainer, steps):
    progs = [p for k, p in trainer._programs.items() if k[0] == steps]
    if len(progs) != 1:
        fail(f"train-recipe: {len(progs)} programs of {steps} steps, want 1")
    return progs[0]


def rc_update_ms(torch, trainer, batch, reps=20):
    """Device ms of one inner step's update of every weight (the
    trainer's own ``_update``: LAMB with the multipliers and the guard's
    select) captured alone in a CUDA graph, CUDA events around ``reps``
    replays: as the trainer runs it, each step's powers of t computed
    once (``_Powers``), and with every weight computing its own, in turns
    (shared, own, own, shared). Returns the two means; the weights and
    the state are put back."""
    from mxnet_tpu_torch.parallel import sharded
    snap = sh_snapshot(trainer)
    dev = trainer.device
    _, grads, _ = trainer._loss_and_grads(list(batch[:-1]), batch[-1])
    scalars = [torch.tensor(v, device=dev) for v in (1e-4, 20.0, 1.0)]
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def timed():
        with torch.no_grad():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                trainer._update(grads, *scalars, finite)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                trainer._update(grads, *scalars, finite)
            return event_ms(torch, graph.replay, reps)

    memo = sharded._Powers.get
    times = {True: [], False: []}
    for shared in (True, False, False, True):
        sharded._Powers.get = memo if shared else \
            (lambda self, key, fn: fn(self.t))
        try:
            times[shared].append(timed())
        finally:
            sharded._Powers.get = memo
    sh_restore(torch, snap)
    del grads
    torch.cuda.empty_cache()
    return sum(times[True]) / 2, sum(times[False]) / 2


def rc_replays_ms(torch, trainer, batch, reps=3):
    """Median ms per inner step of RC_WINDOW back-to-back replays of
    step()'s program, each after writing its lr and t, with one host read
    of the steps' (loss, flag, norm) rows at the end: run_steps made of
    step()'s program instead of an unrolled graph. The steps count as
    updates; the monitor is not fed."""
    from mxnet_tpu_torch.guardrails import fused
    from mxnet_tpu_torch.parallel import sharded
    prog, opt = rc_program(trainer, 1), trainer._optimizer
    times = []
    for _ in range(reps):
        t = trainer.num_update + 1
        t0 = time.perf_counter()
        rows = []
        for i, lr in enumerate(sharded._lr_sequence(opt, t, RC_WINDOW)):
            prog.load(list(batch) + [trainer._scalar_tensor(
                [lr], t + i, opt.rescale_grad, 1.0)])
            prog.replay_forward()
            rows.append(prog.out[0].clone())
        fused.host_fetch(torch.stack(rows))
        times.append((time.perf_counter() - t0) * 1e3 / RC_WINDOW)
        trainer._num_update = opt.num_update = t + RC_WINDOW - 1
    return _median(times)


def rc_card_vs_cpu(torch, mx, trainer, batch1):
    """One full batch-1 step() of the recipe on the card (its graph, the
    dropout bits it drew recorded) against the CPU trainer from the same
    weights, LAMB moments and update count: the loss and the gated
    weights' gradients, the CPU's own from the card's bits; then every
    weight, both LAMB moments and each weight's update (new - old) after
    the CPU's step() given the card's loss and gradients (the update
    alone: clip_norm in the rescale, the wd multipliers, LAMB's two
    phases, the guard's select), each within SH_GATE_RTOL of max |value|.
    The card's gradients are its eager step's with the graph's bits,
    which the update gate then checks against the graph's own result."""
    def host(t):                        # a copy, also of a CPU tensor
        return t.detach().to("cpu", torch.float32, copy=True)

    snap = sh_snapshot(trainer)
    count = trainer.num_update
    names = [n for n, _ in trainer._named]
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in trainer._block.collect_params().items()}
    moments = [[host(s) for s in st] for st in trainer._states]
    old = [host(w) for w in trainer._trainable]
    with mx.random.bits_tape() as rec:
        trainer.step(*batch1)
        drawn = [b.to("cpu", copy=True) for b in rec.drawn]
    card = [[host(w)] + [host(s) for s in st]
            for w, st in zip(trainer._trainable, trainer._states)]
    sh_restore(torch, snap)
    trainer._num_update = trainer._optimizer.num_update = count
    dev = trainer.device
    with mx.random.bits_tape(replay=drawn):
        loss, grads, _ = trainer._loss_and_grads(
            [x.to(dev) for x in batch1[:-1]], batch1[-1].to(dev))
    card_loss, card_grads = loss.cpu(), [g.cpu() for g in grads]
    del loss, grads
    cpu_tr = rc_trainer(torch, mx, mx.cpu(), state=state)[1]
    xs = [x.cpu() for x in batch1]
    cpu_tr.prepare(xs[0])
    if [n for n, _ in cpu_tr._named] != names:
        fail("train-recipe: the CPU trainer's weights are not the card's")
    with torch.no_grad():
        for st, saved in zip(cpu_tr._states, moments):
            for a, b in zip(st, saved):
                a.copy_(b)
    cpu_tr._num_update = cpu_tr._optimizer.num_update = count
    t0 = time.perf_counter()
    with mx.random.bits_tape(replay=drawn):
        loss, grads, _ = cpu_tr._loss_and_grads(xs[:-1], xs[-1])
    by_name = dict(zip(names, grads))
    gated = {f"inner.{k}" for k in GATE_PARAMS}
    grad_card = {n: g.float().numpy() for n, g in zip(names, card_grads)
                 if n in gated}
    grad_cpu = {n: by_name[n].float().numpy() for n in grad_card}
    grad_card["loss"], grad_cpu["loss"] = card_loss.numpy(), loss.numpy()
    log(f"train-recipe: the CPU's batch-1 forward and backward took "
        f"{time.perf_counter() - t0:.1f} s ({len(drawn)} dropout draws "
        "replayed from the card's graph)")
    worst = gate(grad_card, grad_cpu, SH_GATE_RTOL)
    cpu_tr._loss_and_grads = lambda inputs, label, lscale=1.0: (
        card_loss, card_grads, [])
    cpu_tr.step(*xs)
    worst_of = dict.fromkeys(("weight", "update", "mean", "var"),
                             (0.0, None))
    bad = []
    for n, w0, got, w, st in zip(names, old, card, cpu_tr._trainable,
                                 cpu_tr._states):
        want = [w.detach().float()] + [s.detach().float() for s in st]
        pairs = {"weight": (got[0], want[0]),
                 "update": (got[0] - w0, want[0] - w0),
                 "mean": (got[1], want[1]), "var": (got[2], want[2])}
        for what, (a, b) in pairs.items():
            scale = max(float(b.abs().max()), 1e-30)
            rel = float((a - b).abs().max()) / scale
            if not (bool(torch.isfinite(a).all()) and rel <= SH_GATE_RTOL):
                bad.append(f"{what} of {n}: {rel}")
            if rel >= worst_of[what][0]:
                worst_of[what] = (rel, n)
    for what, (rel, n) in worst_of.items():
        log(f"train-recipe: gate each weight's {what} after one batch-1 "
            f"step() on the card vs the CPU's step() from the card's loss "
            f"and gradients ({len(names)} weights): worst relative "
            f"{rel:.3e} of max |value|, at {n} (tolerance {SH_GATE_RTOL:g})")
    if bad:
        fail(f"train-recipe: the update on the card differs from the CPU's "
             f"by more than {SH_GATE_RTOL} of max |value| in {bad[:8]} "
             f"({len(bad)} in all)")
    del cpu_tr
    return max([worst] + [w for w, _ in worst_of.values()])


def rc_window_vs_steps(torch, mx, ctx, batch, init):
    """The recipe at dropout 0 from ``init``: one run_steps(8) window
    against eight graphed step() calls from the same state, bit for bit
    in the last loss, every weight and every optimizer state."""
    model, trainer = rc_trainer(torch, mx, ctx, dropout=0.0, state=init)
    trainer.prepare(batch[0])
    snap = sh_snapshot(trainer)
    window_loss = trainer.run_steps(*batch, num_steps=RC_WINDOW)
    after = [t.detach().clone() for t in snap[0]]
    sh_restore(torch, snap)
    trainer._num_update = trainer._optimizer.num_update = snap[2]
    losses = [trainer.step(*batch) for _ in range(RC_WINDOW)]
    differ = sum(not torch.equal(a, b) for a, b in zip(after, snap[0]))
    equal = torch.equal(window_loss, losses[-1]) and differ == 0
    log(f"train-recipe: dropout 0, run_steps({RC_WINDOW}) vs {RC_WINDOW} "
        f"graphed step() calls from one state: last loss "
        f"{float(window_loss):.6f} vs {float(losses[-1]):.6f}, "
        f"{differ} of {len(after)} weights and states differ; bit-equal "
        f"{equal}")
    sh_release(torch, trainer)
    del model, trainer, after
    torch.cuda.empty_cache()
    if not equal:
        fail("train-recipe: run_steps differs from the same number of "
             "step() calls")
    return equal


def rc_mlp(mx, ctx, batchnorm=False):
    _, n_in, hidden, n_out = RC_MLP
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(hidden, in_units=n_in, activation="relu"))
    if batchnorm:
        net.add(mx.gluon.nn.BatchNorm(in_channels=hidden))
    net.add(mx.gluon.nn.Dense(n_out, in_units=hidden))
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    return net


def rc_mlp_batch(torch, dev):
    import numpy as np
    b, n_in, _, n_out = RC_MLP
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randn(b, n_in).astype(np.float32)).to(dev),
            torch.from_numpy(rng.randn(b, n_out).astype(np.float32)).to(dev))


def rc_optimizers(torch, mx, ctx):
    """Each functional optimizer, in fp32 and bf16 compute, with a
    PolyScheduler, wd 1e-3, clip_gradient 0.1 and the multipliers lr 2,
    wd 0 and wd 2: one graphed ShardedTrainer step of the MLP against
    one eager step from the same weights on the card, bit for bit in
    the loss, the weights and the optimizer state."""
    dev = ctx.torch_device
    x, y = rc_mlp_batch(torch, dev)
    bad, rows = [], {}
    for dtype in ("float32", "bfloat16"):
        for name, hyper in RC_OPTIMIZERS.items():
            got = []
            for graphed in (True, False):
                net = rc_mlp(mx, ctx)
                lr = hyper.get("learning_rate", 1.0)
                opt = mx.optimizer.create(
                    name, **hyper, wd=1e-3, clip_gradient=0.1,
                    lr_scheduler=mx.lr_scheduler.PolyScheduler(
                        max_update=10, pwr=1, warmup_steps=2,
                        warmup_begin_lr=lr / 4))
                opt.set_lr_mult({0: 2.0})
                opt.set_wd_mult({1: 0.0, 2: 2.0})
                tr = mx.parallel.ShardedTrainer(
                    net, mx.gluon.loss.L2Loss(), opt, mesh=sh_mesh(mx, ctx),
                    compute_dtype=None if dtype == "float32" else dtype)
                if not graphed:
                    tr._backend = None
                loss = tr.step(x, y)
                got.append([loss] + list(tr._trainable)
                           + [s for st in tr._states for s in st])
                if graphed and len(tr._programs) != 1:
                    fail(f"train-recipe: {name} {dtype} captured "
                         f"{len(tr._programs)} programs")
                tr._release()
            equal = all(torch.equal(a, b) for a, b in zip(*got))
            rows[f"{name} {dtype}"] = equal
            if not equal:
                bad.append(f"{name} {dtype}")
    log(f"train-recipe: graphed vs eager ShardedTrainer step on the card, "
        f"{len(rows)} (optimizer, dtype) pairs: "
        f"{sum(rows.values())} bit-equal" + (f"; differ: {bad}" if bad
                                              else ""))
    if bad:
        fail(f"train-recipe: a graphed step differs from the eager one for "
             f"{bad}")
    return rows


def rc_guard(torch, mx, ctx):
    """A guarded graphed step (Adam, GuardConfig(max_consecutive_skips=3))
    of the MLP with a BatchNorm, fed a batch with an Inf after a finite
    step: weights, optimizer state and BatchNorm statistics
    bit-unchanged, one nonfinite_grad record per step, and
    TrainingDiverged at the third."""
    from mxnet_tpu_torch.diagnostics import journal
    from mxnet_tpu_torch.guardrails import GuardConfig, TrainingDiverged
    dev = ctx.torch_device
    x, y = rc_mlp_batch(torch, dev)
    bad = x.clone()
    bad[0, 0] = float("inf")
    jr = journal.reset_journal("off")
    try:
        net = rc_mlp(mx, ctx, batchnorm=True)
        tr = mx.parallel.ShardedTrainer(
            net, mx.gluon.loss.L2Loss(), "adam", mesh=sh_mesh(mx, ctx),
            guard=GuardConfig(max_consecutive_skips=3))
        tr.step(x, y)
        tensors = list(net.parameters()) + list(net.buffers()) \
            + [s for st in tr._states for s in st]
        before = [t.detach().clone() for t in tensors]
        diverged = False
        for i in range(1, 4):
            try:
                tr.step(bad, y)
            except TrainingDiverged as err:
                diverged = i == 3
                log(f"train-recipe: guarded step {i + 1} raised "
                    f"TrainingDiverged: {err}")
            unchanged = all(torch.equal(a, b)
                            for a, b in zip(tensors, before))
            records = [r for r in jr.recent()
                       if r["kind"] == "nonfinite_grad"]
            if not unchanged or len(records) != i:
                fail(f"train-recipe: guarded non-finite step {i}: state "
                     f"unchanged {unchanged}, {len(records)} nonfinite_grad "
                     "records")
        programs, skipped = len(tr._programs), tr.skipped_steps
        tr._release()
    finally:
        journal.reset_journal()
    log(f"train-recipe: 3 guarded graphed steps on a batch with an Inf: "
        f"weights, state and BatchNorm statistics bit-unchanged, 3 "
        f"nonfinite_grad records, {skipped} skipped, TrainingDiverged at the"
        f" third {diverged}, {programs} program")
    if not diverged or skipped != 3 or programs != 1:
        fail("train-recipe: the guard did not skip three steps and raise "
             "TrainingDiverged at the third in one graph")
    return {"skipped": skipped, "diverged": diverged,
            "records": [{k: v for k, v in r.items()
                         if k not in ("ts", "up_s")} for r in records]}


def phase_train_recipe(torch, mx, card, ctx):
    """(d) examples/pretrain_bert.py's model and batch through the BERT
    pretraining recipe of :func:`rc_trainer`, RC_WINDOW steps per
    run_steps window, each window one CUDA graph replay; then the gates."""
    import numpy as np
    from mxnet_tpu_torch import kernels
    dev = ctx.torch_device
    torch.cuda.empty_cache()
    tokens = np.random.RandomState(0).randint(0, BERT_VOCAB,
                                              (RC_BATCH, RC_SEQ))
    ids = torch.from_numpy(tokens.astype(np.int32)).to(dev)
    batch = (ids, ids)                  # pretrain_bert.py: the ids as labels
    model, trainer = rc_trainer(torch, mx, ctx)
    trainer.prepare(ids)
    init = {k: v.detach().cpu().numpy().copy()
            for k, v in model.collect_params().items()}
    no_decay = trainer._optimizer.wd_mult
    log(f"train-recipe (d): bert_12_768_12 MLM, batch {RC_BATCH}, S {RC_SEQ},"
        f" vocab {BERT_VOCAB}, dropout 0.1, bf16 compute, fp32 masters; LAMB "
        f"lr {RC_LAMB['learning_rate']:g} wd {RC_LAMB['wd']:g}, "
        f"PolyScheduler({RC_SCHED}), wd_mult 0 on {len(no_decay)} of "
        f"{len(trainer._trainable)} weights ({RC_NO_DECAY}), "
        f"GuardConfig(clip_norm={RC_CLIP}); run_steps(num_steps={RC_WINDOW})"
        f" on {card}")
    host = mx.lr_scheduler.PolyScheduler(**RC_SCHED)
    lrs_seen = []

    def check_lrs(prog, start):
        seen = prog.static_in[-1][:RC_WINDOW].tolist()
        want = [float(np.float32(host(start + i))) for i in range(RC_WINDOW)]
        lrs_seen.append({"first_step": start, "lrs": seen})
        if seen != want:
            fail(f"train-recipe: the window from step {start} saw lrs {seen},"
                 f" PolyScheduler gives {want}")

    mx.random.seed(SEED)
    t0 = time.perf_counter()
    first = float(trainer.run_steps(*batch, num_steps=RC_WINDOW))
    first_ms = (time.perf_counter() - t0) * 1e3
    prog = rc_program(trainer, RC_WINDOW)
    check_lrs(prog, 1)
    _sync(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times = [], []
    for _ in range(RC_WINDOWS):
        start = trainer.num_update + 1
        t0 = time.perf_counter()
        loss = trainer.run_steps(*batch, num_steps=RC_WINDOW)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        check_lrs(prog, start)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want["matmul_epilogue"] = RC_K2 * RC_WINDOW * RC_WINDOWS
    if launches != want:
        fail(f"train-recipe: launches {launches} over {RC_WINDOWS} windows, "
             f"want {want}")
    if not all(math.isfinite(v) for v in [first] + losses) \
            or not losses[-1] < first:
        fail(f"train-recipe: window losses {[first] + losses} are not "
             "finite or did not fall")
    window_ms = _median(times)
    step_ms = window_ms / RC_WINDOW
    rate = RC_BATCH * RC_SEQ * 1e3 / step_ms
    log(f"train-recipe (d): last loss of each window "
        f"{[round(v, 6) for v in [first] + losses]} (the first window "
        f"captures, {first_ms:.1f} ms); window ms "
        f"{[round(t, 3) for t in times]}, median {window_ms:.3f} ms, "
        f"{step_ms:.3f} ms per inner step, "
        f"{RC_BATCH * 1e3 / step_ms:.3f} sequences/s, {rate:.1f} tokens/s "
        f"on {card}")
    log(f"train-recipe (d): capture {prog.capture_s:.3f} s, graph pool "
        f"{_gib(prog.pool_bytes)}; over the timed windows peak allocated "
        f"{peak / 2**30:.3f} GiB (the pool's blocks not counted), reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB; matmul_epilogue {launches['matmul_epilogue']} launches (= "
        f"{RC_K2} x {RC_WINDOW} x {RC_WINDOWS}), every other kernel 0; "
        f"lrs seen in every window equal PolyScheduler's (steps 1-"
        f"{trainer.num_update}: {lrs_seen[0]['lrs'][0]:.3e} .. "
        f"{lrs_seen[-1]['lrs'][-1]:.6e})")
    prof = profiled(
        "train-recipe window",
        lambda: sh_profile(torch, lambda: trainer.run_steps(
            *batch, num_steps=RC_WINDOW), window_ms, what="window"),
        lambda p: not p["rows"] or _kernel_count(
            p["rows"], "matmul_epilogue") == RC_K2 * RC_WINDOW)
    want_calls = 1 + 2 * prog.generators
    if prof["host_launch_calls"] != want_calls \
            or prof["graph_launches"] != 1:
        fail(f"train-recipe: {prof['host_launch_calls']} host launch calls "
             f"({prof['graph_launches']} graph launches) per window, want "
             f"{want_calls} (1)")
    k2_seen = _kernel_count(prof["rows"], "matmul_epilogue")
    if prof["rows"] and k2_seen != RC_K2 * RC_WINDOW:
        fail(f"train-recipe: the profiler saw {k2_seen} matmul_epilogue "
             f"launches in a window, want {RC_K2 * RC_WINDOW}")
    k2_ms = sum(ms for k, (_, ms) in prof["rows"].items()
                if _is_kernel(k, "matmul_epilogue"))
    update_ms, own_powers_ms = rc_update_ms(torch, trainer, batch)
    share = (None if not prof["device_ms"]
             else RC_WINDOW * update_ms / prof["device_ms"])
    log(f"train-recipe (d): host launch calls per window {want_calls} (1 "
        f"graph launch + {2 * prog.generators} for the seed and offset of "
        f"{prog.generators} dropout generator(s)); K2 {k2_seen} launches, "
        f"{k2_ms:.3f} ms in the profiled window; the update of one inner "
        f"step alone (LAMB over {len(trainer._trainable)} weights, graphed, "
        f"CUDA events) {update_ms:.3f} ms, x {RC_WINDOW} = "
        f"{RC_WINDOW * update_ms:.3f} ms"
        + ("" if share is None else
           f", {share:.3f} of the profiled window's device time")
        + f"; with every weight computing its own powers of t "
          f"{own_powers_ms:.3f} ms")
    step_times = []
    for _ in range(RC_STEPS):
        t0 = time.perf_counter()
        trainer.step(*batch)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t0) * 1e3)
    single = rc_program(trainer, 1)
    single_ms = _median(step_times[1:])
    log(f"train-recipe (d): step() ms {[round(t, 3) for t in step_times]} "
        f"(the first captures, {single.capture_s:.3f} s, pool "
        f"{_gib(single.pool_bytes)}), median {single_ms:.3f} ms, "
        f"{RC_BATCH * RC_SEQ * 1e3 / single_ms:.1f} tokens/s; run_steps "
        f"saves {single_ms - step_ms:.3f} ms per step")
    replays_ms = rc_replays_ms(torch, trainer, batch)
    log(f"train-recipe (d): {RC_WINDOW} replays of step()'s program with "
        f"one host read at the end: {replays_ms:.3f} ms per inner step, "
        f"against the unrolled window's {step_ms:.3f}")
    gate_rel = rc_card_vs_cpu(torch, mx, trainer, [t[:1] for t in batch])
    res = {"losses": [first] + losses, "window_ms": window_ms,
           "step_ms": step_ms, "tokens_per_s": rate,
           "single_step_ms": single_ms, "launches": launches,
           "capture_s": prog.capture_s, "pool_bytes": prog.pool_bytes,
           "single_capture_s": single.capture_s,
           "single_pool_bytes": single.pool_bytes, "peak_bytes": peak,
           "host_launch_calls": prof["host_launch_calls"],
           "device_ms": prof["device_ms"], "busy": prof["busy"],
           "k2_ms": k2_ms, "update_ms": update_ms,
           "update_own_powers_ms": own_powers_ms,
           "step_replays_ms": replays_ms, "lrs": lrs_seen,
           "gate_rel": gate_rel}
    sh_release(torch, trainer)
    del model, trainer
    torch.cuda.empty_cache()
    res["window_equal"] = rc_window_vs_steps(torch, mx, ctx, batch, init)
    res["optimizers"] = rc_optimizers(torch, mx, ctx)
    res["guard"] = rc_guard(torch, mx, ctx)
    return res


# -- phase 17: train-checkpoint -----------------------------------------------
CK_WINDOWS = 4                       # uninterrupted run_steps(8) windows
CK_KEEP = 3                          # keep_last: steps 16, 24 and 32 stay
CK_RESUME = 16                       # the fresh trainer's restored step
CK_SEED = 1                          # the fresh trainer's initial weights
CK_POISON = "inner.encoder.transformer_cells.0.ffn.ffn_1.weight"
CK_ROOT = os.path.join(ROOT, "build", "chip_smoke_ckpt")


def ck_tensors(trainer):
    """The trainable weights (fp32 masters) and LAMB's m and v."""
    return list(trainer._trainable) + [s for st in trainer._states
                                       for s in st]


def ck_differ(torch, got, want):
    """How many tensors of ``got`` differ from ``want`` in any bit."""
    return sum(not torch.equal(a, b) for a, b in zip(got, want))


def ck_dir_bytes(root, step):
    from mxnet_tpu_torch.resilience import commit
    d = commit.step_dir(root, step)
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))


def phase_train_checkpoint(torch, mx, card, ctx):
    """(e) the checkpoint family on (d)'s model, batch and trainer:
    commit, bit-equal resume in a fresh trainer, an in-place restore of a
    trainer that has captured, fallback past a torn step, and rollback
    under GuardConfig(ckpt_root=). The checkpoints go to CK_ROOT, removed
    at the end."""
    import shutil

    from mxnet_tpu_torch.diagnostics import journal
    try:
        shutil.rmtree(CK_ROOT, ignore_errors=True)
        jr = journal.reset_journal("off")
        return _train_checkpoint(torch, mx, card, ctx, jr)
    finally:
        journal.reset_journal()
        shutil.rmtree(CK_ROOT, ignore_errors=True)


def _train_checkpoint(torch, mx, card, ctx, jr):
    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.resilience import commit
    dev = ctx.torch_device
    torch.cuda.empty_cache()
    tokens = np.random.RandomState(0).randint(0, BERT_VOCAB,
                                              (RC_BATCH, RC_SEQ))
    ids = torch.from_numpy(tokens.astype(np.int32)).to(dev)
    batch = (ids, ids)
    host = mx.lr_scheduler.PolyScheduler(**RC_SCHED)
    lrs_seen = []

    def window(trainer, backoff=1.0):
        """One run_steps window; the lrs its graph read must be
        PolyScheduler's (times the rollback's backoff)."""
        start = trainer.num_update + 1
        loss = float(trainer.run_steps(*batch, num_steps=RC_WINDOW))
        seen = rc_program(trainer, RC_WINDOW).static_in[-1][:RC_WINDOW] \
            .tolist()
        want = [float(np.float32(host(start + i) * backoff))
                for i in range(RC_WINDOW)]
        lrs_seen.append({"first_step": start, "backoff": backoff,
                         "lrs": seen})
        if seen != want:
            fail(f"train-checkpoint: the window from step {start} saw lrs "
                 f"{seen}, PolyScheduler x {backoff} gives {want}")
        return loss

    def events(kind):
        return [r for r in jr.recent() if r["kind"] == kind]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 1. uninterrupted: 4 windows, a checkpoint after each
    model, trainer = rc_trainer(torch, mx, ctx)
    trainer.prepare(ids)
    n_bytes = 4 * sum(t.numel() for t in ck_tensors(trainer))
    log(f"train-checkpoint (e): (d)'s model, batch and trainer on {card}; "
        f"{len(trainer._trainable)} fp32 master weights and LAMB's m and v"
        f" = {n_bytes / 1e9:.3f} GB of tensors per step; checkpoint("
        f"keep_last={CK_KEEP}) after each of {CK_WINDOWS} windows of "
        f"run_steps({RC_WINDOW}) into {CK_ROOT}")
    mx.random.seed(SEED)
    losses, saves = [], []
    for w in range(CK_WINDOWS):
        if w == 1:                   # after the capturing window
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        losses.append(window(trainer))
        saves.append(timed(lambda: trainer.checkpoint(
            CK_ROOT, keep_last=CK_KEEP))[1])
    launches = kernels.launch_counts()
    want = dict.fromkeys(launches, 0)
    want["matmul_epilogue"] = RC_K2 * RC_WINDOW * (CK_WINDOWS - 1)
    if launches != want:
        fail(f"train-checkpoint: launches {launches} over windows 2-"
             f"{CK_WINDOWS}, want {want}")
    kept = commit.committed_steps(CK_ROOT)
    newest = RC_WINDOW * CK_WINDOWS
    if kept != [newest - RC_WINDOW * i for i in range(CK_KEEP)][::-1] \
            or not all(math.isfinite(v) for v in losses):
        fail(f"train-checkpoint: committed steps {kept}, losses {losses}")
    step_bytes = ck_dir_bytes(CK_ROOT, newest)
    final = [t.detach().clone() for t in ck_tensors(trainer)]
    prog = rc_program(trainer, RC_WINDOW)
    log(f"train-checkpoint (e): window losses {losses}; committed steps "
        f"{kept}; {step_bytes} bytes per step directory; save s "
        f"{[round(v, 3) for v in saves]}, median {_median(saves):.3f} s, "
        f"{step_bytes / 1e9 / _median(saves):.3f} GB/s; K2 "
        f"{launches['matmul_epilogue'] // (CK_WINDOWS - 1)} launches per "
        "window, every other kernel 0")

    # 2. resumed: a fresh trainer from another seed restores step 16
    model2, tr2 = rc_trainer(torch, mx, ctx, seed=CK_SEED)
    tr2.prepare(ids)
    before = ck_differ(torch, ck_tensors(tr2), final)
    got, restore_fresh_s = timed(lambda: tr2.restore(CK_ROOT,
                                                     step=CK_RESUME))
    if got != CK_RESUME or tr2.num_update != CK_RESUME:
        fail(f"train-checkpoint: restore(step={CK_RESUME}) gave {got}, "
             f"num_update {tr2.num_update}")
    resumed = [window(tr2) for _ in range(CK_WINDOWS - 2)]
    capture_s = rc_program(tr2, RC_WINDOW).capture_s
    differ = ck_differ(torch, ck_tensors(tr2), final)
    log(f"train-checkpoint (e): a fresh trainer (seed {CK_SEED}, {before} "
        f"of {len(final)} tensors differing) restored step {got} in "
        f"{restore_fresh_s:.3f} s; windows 3-{CK_WINDOWS} (the first "
        f"captures, {capture_s:.3f} s): losses {resumed} against {losses[2:]}"
        f", {differ} of {len(final)} weights, m and v differ; lrs = "
        f"PolyScheduler(t), t = {CK_RESUME + 1}..{newest}")
    if resumed != losses[2:] or differ:
        fail("train-checkpoint: the resumed windows are not bit-equal to "
             "the uninterrupted ones")

    # 3. in place: the first trainer, which has captured, restores
    ref_loss = window(tr2)           # window 5 from step 32: the reference
    ref = [t.detach().clone() for t in ck_tensors(tr2)]
    sh_release(torch, tr2)
    del model2, tr2
    torch.cuda.empty_cache()
    replaced = window(trainer)       # steps 33-40 from other dropout bits
    got, restore_inplace_s = timed(lambda: trainer.restore(CK_ROOT))
    again = window(trainer)
    same_prog = (len(trainer._programs) == 1
                 and rc_program(trainer, RC_WINDOW) is prog)
    differ = ck_differ(torch, ck_tensors(trainer), ref)
    log(f"train-checkpoint (e): in place on the captured trainer: "
        f"restore() gave step {got} in {restore_inplace_s:.3f} s; the next "
        f"window's loss {again} against the reference's {ref_loss} (the "
        f"window it replaces: {replaced}); {differ} of {len(ref)} tensors "
        f"differ; the same program, no new capture: {same_prog}")
    if got != newest or again != ref_loss or differ or not same_prog:
        fail("train-checkpoint: an in-place restore did not reach the "
             "captured program")

    # 4. a torn newest step: the restore falls back
    path = os.path.join(commit.step_dir(CK_ROOT, newest), "ckpt.states")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)[0]
        f.seek(size // 2)
        f.write(bytes([byte ^ 0xFF]))
    n_fallback = len(events("ckpt_fallback"))
    got = trainer.restore(CK_ROOT)
    fallback = events("ckpt_fallback")[n_fallback:]
    log(f"train-checkpoint (e): a byte of step {newest}'s ckpt.states "
        f"flipped: restore() gave step {got}, journaled "
        f"{[(r['step'], r['detail']) for r in fallback]}")
    if got != newest - RC_WINDOW or [r["step"] for r in fallback] \
            != [newest]:
        fail("train-checkpoint: no fallback past the torn step")
    sh_release(torch, trainer)
    del model, trainer, final, ref
    torch.cuda.empty_cache()

    # 5. rollback under GuardConfig(ckpt_root=)
    guard = mx.guardrails.GuardConfig(clip_norm=RC_CLIP, ckpt_root=CK_ROOT,
                                      max_consecutive_skips=2)
    model3, tr3 = rc_trainer(torch, mx, ctx, guard=guard)
    tr3.prepare(ids)
    tr3.restore(CK_ROOT)             # step 24: 32 is torn
    window(tr3)
    prog3 = rc_program(tr3, RC_WINDOW)
    committed = tr3.checkpoint(CK_ROOT, keep_last=CK_KEEP)  # 32 anew
    with torch.no_grad():
        model3.collect_params()[CK_POISON].view(-1)[0] = float("inf")
    n_rb = len(events("divergence_rollback"))
    bad = float(tr3.run_steps(*batch, num_steps=RC_WINDOW))
    lost = committed + RC_WINDOW - tr3.num_update
    rollbacks = events("divergence_rollback")[n_rb:]
    finite = all(bool(torch.isfinite(t).all()) for t in ck_tensors(tr3))
    after = window(tr3, backoff=guard.lr_backoff)
    same_prog = (len(tr3._programs) == 1
                 and rc_program(tr3, RC_WINDOW) is prog3)
    rec = rollbacks[0] if rollbacks else {}
    log(f"train-checkpoint (e): step {committed} committed, inf written "
        f"into {CK_POISON}[0, 0]: the guarded window's loss {bad}, "
        f"divergence_rollback {({k: rec.get(k) for k in ('step', 'restored_step', 'lr_backoff', 'reason')})}"
        f"; restored weights finite {finite}; the next window's loss {after}"
        f" with lrs x {guard.lr_backoff}, the same program (no new capture)"
        f" {same_prog}; steps lost {lost} (the poisoned window's)")
    if len(rollbacks) != 1 or rec["restored_step"] != committed \
            or rec["lr_backoff"] != guard.lr_backoff or not finite \
            or not math.isfinite(after) or not same_prog:
        fail("train-checkpoint: the guard did not roll back to the "
             "committed step with a backed-off lr")
    sh_release(torch, tr3)
    del model3, tr3
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "resumed": resumed,
            "step_bytes": step_bytes, "tensor_bytes": n_bytes,
            "save_s": saves, "save_gb_per_s": step_bytes / 1e9
            / _median(saves), "restore_fresh_s": restore_fresh_s,
            "restore_inplace_s": restore_inplace_s,
            "fresh_capture_s": capture_s, "steps_lost": lost,
            "rollback": {k: rec.get(k) for k in ("step", "restored_step",
                                                 "lr_backoff")},
            "lrs": lrs_seen}


# -- phase 18: train-remat ----------------------------------------------------
RM_POLICIES = (None, "full", "dots", "dots_no_batch")
RM_STEPS = 6                         # the first captures; median of the rest
RM_RECOMPUTE = {"flash_attention": 24, "flash_attention_bwd_dkv": 12,
                "flash_attention_bwd_dq": 12, "matmul_epilogue": 48}


def rm_trainer(mx, ctx, block, remat, resnet):
    """examples/train_imagenet.py's (SGD) or examples/pretrain_bert.py's
    (Adam) trainer on ``block`` under ``remat``: bf16 compute, fp32
    masters, the one-device mesh."""
    opt, params = (("sgd", dict(RN_SGD)) if resnet
                   else ("adam", {"learning_rate": TRAIN_LR}))
    return mx.parallel.ShardedTrainer(
        block, mx.gluon.loss.SoftmaxCrossEntropyLoss(), opt,
        optimizer_params=params, mesh=sh_mesh(mx, ctx),
        compute_dtype="bfloat16", remat=remat)


def rm_step_state(trainer):
    """The fp32 masters and the optimizer state, cloned."""
    return [t.detach().clone() for t in ck_tensors(trainer)]


def rm_max_rel(torch, got, want):
    """The largest difference of ``got`` from ``want``, each tensor's
    relative to its max |value|."""
    worst = 0.0
    for a, b in zip(got, want):
        scale = float(b.abs().max()) or 1.0
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def phase_train_remat(torch, mx, card, ctx):
    """(f) ShardedTrainer(remat=) on (c), the BERT-base MLM at batch 4, S
    4096, under None, "full", "dots" and "dots_no_batch"; then (a),
    ResNet-50 v1 at batch 256, one graphed step under "dots"."""
    import copy

    import numpy as np
    from mxnet_tpu_torch import kernels
    dev = ctx.torch_device
    torch.cuda.empty_cache()
    b, seq = SH_BERT["c"][:2]
    tokens = np.random.RandomState(0).randint(0, BERT_VOCAB, (b, seq))
    ids = torch.from_numpy(tokens.astype(np.int32)).to(dev)
    batch = (ids, ids)
    base = mlm_model(torch, mx, ctx, seq)
    with torch.no_grad():
        base(ids[:1, :8])                # materialize every parameter
    grads = tuple(f"inner.{k}" for k in GATE_PARAMS)
    log(f"train-remat (f): (c) bert_12_768_12 MLM, batch {b}, S {seq}, "
        f"dropout 0.1, bf16 compute, fp32 masters, Adam lr {TRAIN_LR:g}, "
        f"under remat {list(RM_POLICIES)}: from one state and dropout seed "
        f"{SEED}, the capturing step held against remat=None's, then "
        f"{RM_STEPS - 1} timed graphed steps on {card}")
    out, ref = {}, None
    for remat in RM_POLICIES:
        model = copy.deepcopy(base)
        trainer = rm_trainer(mx, ctx, model, remat, resnet=False)
        trainer.prepare(ids)
        mx.random.seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(trainer.step(*batch))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        state = [loss] + rm_step_state(trainer)
        if ref is None:
            ref = state
        differ = sum(not torch.equal(a, b) for a, b in
                     zip(state[1:], ref[1:])) + (loss != ref[0])
        rel = rm_max_rel(torch, state[1:], ref[1:])
        kernels.reset_launch_counts()
        times = []
        for _ in range(RM_STEPS - 1):
            t0 = time.perf_counter()
            trainer.step(*batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        per_step = {k: counts[k] // (RM_STEPS - 1)
                    for k in RM_RECOMPUTE}
        want = TRAIN_PER_STEP if remat is None else RM_RECOMPUTE
        prog = list(trainer._programs.values())
        name = "None" if remat is None else remat
        log(f"train-remat (f) remat={name}: the capturing step's loss "
            f"{loss!r} (None's {ref[0]!r}); {differ} of {len(state)} "
            f"(loss, {len(state) - 1} masters and Adam moments) differ in "
            f"any bit from remat=None's step, max {rel:.3e} of max |value|;"
            f" step ms {[round(t, 3) for t in times]}, median "
            f"{_median(times):.3f} ms ({b * seq * 1e3 / _median(times):.1f} "
            f"tokens/s); capture {prog[0].capture_s:.3f} s, graph pool "
            f"{_gib(prog[0].pool_bytes)}, peak {peak / 2**30:.3f} GiB over "
            f"the capturing step (2 eager warm-up passes and the capture); "
            f"launches per step {per_step}")
        if differ:
            fail(f"train-remat: the remat={name} step is not bit-equal to "
                 f"the remat=None step ({differ} differ, max {rel:.3e})")
        if per_step != {k: want[k] for k in per_step} or len(prog) != 1 \
                or any(counts[k] for k in counts if k not in per_step):
            fail(f"train-remat: remat={name} launched {counts} over "
                 f"{RM_STEPS - 1} steps ({len(prog)} programs), want "
                 f"{want} per step")
        graph_rel, graph_equal = sh_graph_vs_eager(
            torch, mx, trainer, batch, grads, deterministic=False)
        out[name] = {"loss": loss, "differ": differ, "max_rel": rel,
                     "times": times, "step_ms": _median(times),
                     "peak_bytes": peak, "pool_bytes": prog[0].pool_bytes,
                     "capture_s": prog[0].capture_s, "launches": counts,
                     "per_step": per_step, "graph_rel": graph_rel,
                     "graph_equal": graph_equal}
        sh_release(torch, trainer)
        del model, trainer
        torch.cuda.empty_cache()
    del base, ref, batch, ids
    torch.cuda.empty_cache()
    out["resnet"] = rm_resnet(torch, mx, ctx, card)
    return out


def rm_resnet(torch, mx, ctx, card):
    """(a) one graphed step under "dots" against one under None, from one
    state, cuDNN deterministic: the BatchNorm running statistics
    bit-equal (folded once), the weights compared."""
    import copy

    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    dev = ctx.torch_device
    rng = np.random.RandomState(0)
    x = rng.randn(SH_RN_BATCH, 3, RN_SIZE, RN_SIZE).astype(np.float32)
    y = rng.randint(0, 1000, (SH_RN_BATCH,))
    batch = (torch.from_numpy(x).to(dev),
             torch.from_numpy(y.astype(np.int32)).to(dev))
    del x
    base = resnet50_v1(classes=1000)
    base.initialize(mx.init.Xavier(), ctx=ctx,
                    generator=mx.random.generator(SEED))
    with torch.no_grad():
        base(batch[0][:1])               # materialize every parameter
    res = {}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (None, "dots"):
            net = copy.deepcopy(base)
            trainer = rm_trainer(mx, ctx, net, remat, resnet=True)
            trainer.prepare(batch[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            loss = float(trainer.step(*batch))
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            prog = list(trainer._programs.values())[0]
            res[remat] = {
                "loss": loss, "stats": [a.detach().clone()
                                        for a in trainer._aux],
                "weights": rm_step_state(trainer)[:len(trainer._trainable)],
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "pool_bytes": prog.pool_bytes, "capture_s": prog.capture_s,
                "first_s": first_s, "launches": kernels.launch_counts()}
            sh_release(torch, trainer)
            del net, trainer
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old
    plain, dots = res[None], res["dots"]
    stats_differ = sum(not torch.equal(a, b)
                       for a, b in zip(dots["stats"], plain["stats"]))
    w_differ = sum(not torch.equal(a, b)
                   for a, b in zip(dots["weights"], plain["weights"]))
    w_rel = rm_max_rel(torch, dots["weights"], plain["weights"])
    k1 = {k: r["launches"]["conv_epilogue"] for k, r in res.items()}
    log(f"train-remat (a) resnet50_v1, batch {SH_RN_BATCH}, bf16, one "
        f"graphed step (it captures) under remat=dots against None, cuDNN "
        f"deterministic: loss {dots['loss']!r} (None's {plain['loss']!r}); "
        f"{stats_differ} of {len(plain['stats'])} BatchNorm running "
        f"statistics differ in any bit; {w_differ} of "
        f"{len(plain['weights'])} weights differ, max {w_rel:.3e} of max "
        f"|value|; capture {dots['capture_s']:.3f} s (None "
        f"{plain['capture_s']:.3f}), pool {_gib(dots['pool_bytes'])} (None "
        f"{_gib(plain['pool_bytes'])}), peak {dots['peak_bytes'] / 2**30:.3f}"
        f" GiB (None {plain['peak_bytes'] / 2**30:.3f}); K1 launches over "
        f"the capture's warm-up passes and the step {k1['dots']} (None "
        f"{k1[None]}) on {card}")
    if stats_differ or not math.isfinite(dots["loss"]):
        fail("train-remat: under remat=dots the BatchNorm running "
             "statistics differ from the remat=None step's")
    return {"loss": dots["loss"], "stats_differ": stats_differ,
            "weights_differ": w_differ, "weights_rel": w_rel,
            "pool_bytes": {str(k): r["pool_bytes"] for k, r in res.items()},
            "peak_bytes": {str(k): r["peak_bytes"] for k, r in res.items()},
            "capture_s": {str(k): r["capture_s"] for k, r in res.items()},
            "k1_launches": {str(k): v for k, v in k1.items()}}


# -- phase 19: serve-reload ---------------------------------------------------
RL_ROOT = os.path.join(ROOT, "build", "chip_smoke_reload")
RL_CHECKED = (0, 1)                  # answers of a burst held against the CPU
RL_SMALL = 8                         # requests of the torn, drift, pin checks
RL_NARROW = {"units": 384, "hidden_size": 1536, "num_heads": 6}
RL_MAX_ROUNDS = 50                   # burst B's rounds before it fails


def phase_serve_reload(torch, mx, card, ctx):
    """(g) hot reload: (d)'s trainer commits a checkpoint after each of 3
    run_steps(8) windows into RL_ROOT (removed at the end); a Server of
    the BERT-base MLM on ``ctx``, fp32, with ParamStore(RL_ROOT),
    reloads them between batches."""
    import shutil

    from mxnet_tpu_torch.diagnostics import journal
    try:
        shutil.rmtree(RL_ROOT, ignore_errors=True)
        jr = journal.reset_journal("off")
        return _serve_reload(torch, mx, card, ctx, jr)
    finally:
        journal.reset_journal()
        shutil.rmtree(RL_ROOT, ignore_errors=True)


def rl_burst(server, payloads, n, n_threads=4, during=None):
    """``n`` single-sample requests from ``n_threads`` threads, each
    submitting its share at once; ``during()`` runs once they have
    started. Returns (the answers of RL_CHECKED, [(served time,
    params_step)] in request order, wall s); fails unless every answer is
    finite and of one shape."""
    import numpy as np
    kept, stamps, shapes, errors = {}, {}, set(), []

    def client(idx):
        try:
            pending = [(i, server.submit(payloads[i])) for i in idx]
            for i, p in pending:
                a = p.result(120)
                if not np.isfinite(a).all():
                    errors.append(f"answer {i} is not finite")
                shapes.add(a.shape)
                stamps[i] = (p._request.served_t, p.params_step)
                if i in RL_CHECKED:
                    kept[i] = a
        except Exception as exc:      # reported below, then fail
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(range(k, n, n_threads),))
               for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if during is not None:
        during()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors or len(stamps) != n or len(shapes) != 1:
        fail(f"serve-reload: {len(stamps)} of {n} answered, shapes {shapes}"
             f", errors {errors[:3]}")
    return kept, [stamps[i] for i in range(n)], wall


def rl_wait(cond, what, timeout_s=120.0):
    t_end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > t_end:
            fail(f"serve-reload: timed out waiting for {what}")
        time.sleep(0.01)


def _serve_reload(torch, mx, card, ctx, jr):
    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.gluon.model_zoo.bert import (bert_12_768_12,
                                                      get_bert_model)
    from mxnet_tpu_torch.resilience import commit
    from mxnet_tpu_torch.serving import ParamStore, Server, ServerConfig
    dev = ctx.torch_device
    torch.cuda.empty_cache()
    tokens = np.random.RandomState(0).randint(
        0, BERT_VOCAB, (RC_BATCH, RC_SEQ)).astype(np.int32)
    ids = torch.from_numpy(tokens).to(dev)
    batch = (ids, ids)
    model, trainer = rc_trainer(torch, mx, ctx)
    trainer.prepare(ids)
    mx.random.seed(SEED)

    def events(kind):
        return [r for r in jr.recent() if r["kind"] == kind]

    def commit_window():
        trainer.run_steps(*batch, num_steps=RC_WINDOW)
        return trainer.checkpoint(RL_ROOT)

    def params_file(step):
        return os.path.join(commit.step_dir(RL_ROOT, step), "ckpt.params")

    # the block to serve: the serve phase's BERT-base if the checkpoint
    # holds all its parameters, else the trainer's MLM model itself
    first = commit_window()
    ckpt_keys = {k.partition(":")[2] for k in nd.load(params_file(first))
                 if not k.startswith("__")}
    serve_keys = set(bert_12_768_12(use_decoder=False).collect_params())
    subset = serve_keys <= ckpt_keys
    block = (seeded_bert(torch, mx, ctx, RC_SEQ, (1,)) if subset
             else mlm_model(torch, mx, ctx, RC_SEQ))
    with torch.no_grad():
        block(ids[:1])                   # materialize every parameter
    log(f"serve-reload (g): the serve phase's block's {len(serve_keys)} "
        f"parameters are {'' if subset else 'not '}a subset of the "
        f"checkpoint's {len(ckpt_keys)} (its model is wrapped as inner.*): "
        f"serving the {'serve phase' if subset else 'MLM'} block, fp32, on "
        f"{card}; (d)'s trainer commits into {RL_ROOT} after each "
        f"run_steps({RC_WINDOW}) window")
    store = ParamStore(RL_ROOT)
    server = Server(block, ServerConfig(
        max_batch=8, dtype="int32", aot_prewarm=((RC_SEQ,),),
        reload_poll_s=0.0), param_store=store, ctx=ctx).start()
    graphs = report_prewarm(server, card)

    def live():
        return server.stats()["params_step"]

    captured = {key: pred._program for key, pred in server.cache.entries()}
    misses = server.cache.stats()["misses"]
    if live() != first:
        fail(f"serve-reload: start() served step {live()}, "
             f"want {first}")

    cpu = mlm_model(torch, mx, mx.cpu(), RC_SEQ)
    refs = {}

    def reference(step):
        if step not in refs:
            cpu.load_parameters(params_file(step), ignore_extra=True)
            with torch.inference_mode():
                refs[step] = cpu(torch.from_numpy(
                    tokens[list(RL_CHECKED)])).numpy()
        return refs[step]

    for b in (8, 4, 2, 1):               # each bucket on the worker thread
        rl_burst(server, tokens, b, 1)
    bursts = {}

    def timed_burst(name, n, newest=None, during=None, until=None):
        """A burst with the launch counts from 0; with ``newest``, every
        answer must carry that step and match the CPU's forward with
        that step's weights. With ``until``, rounds of ``n`` requests
        follow each other until ``until()`` holds after one."""
        before = server.stats()
        server.latency.reset()
        kernels.reset_launch_counts()
        kept, stamps, wall = rl_burst(server, tokens, n, during=during)
        rounds = 1
        while until is not None and not until():
            if rounds == RL_MAX_ROUNDS:
                fail(f"serve-reload: {name}: no reload after {rounds} "
                     f"rounds of {n}")
            _, more, more_wall = rl_burst(server, tokens, n)
            stamps, wall, rounds = stamps + more, wall + more_wall, rounds + 1
        n *= rounds
        launches = kernels.launch_counts()
        after = server.stats()
        n_batches = after["batches"] - before["batches"]
        k2 = launches["matmul_epilogue"]
        per_fwd = k2 // max(n_batches, 1)
        lat = after["latency_ms"]
        steps = [s for _, s in stamps]
        log(f"serve-reload (g) {name}: {n} requests in {n_batches} batches"
            f"{f' ({rounds} rounds)' if until is not None else ''},"
            f" params_step {sorted(set(steps))}, latency p50 "
            f"{lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms, "
            f"{n / wall:.2f} sequences/s; K2 {k2} launches (= {per_fwd} x "
            f"{n_batches}), every other kernel "
            f"{sum(v for k, v in launches.items() if k != 'matmul_epilogue')}")
        if k2 != per_fwd * n_batches or not per_fwd \
                or any(v for k, v in launches.items()
                       if k != "matmul_epilogue"):
            fail(f"serve-reload: launches {launches} over {n_batches} "
                 "batches")
        if newest is not None:
            if set(steps) != {newest}:
                fail(f"serve-reload: {name}'s answers carry steps "
                     f"{sorted(set(steps))}, want {newest}")
            ref = reference(newest)
            check_against_cpu(f"{name} MLM logits (step {newest})",
                              np.stack([kept[i] for i in RL_CHECKED]), ref)
        bursts[name] = {"p50": lat["p50"], "p99": lat["p99"],
                        "requests": n, "rounds": rounds,
                        "steps": sorted(set(steps)), "batches": n_batches,
                        "k2_per_forward": per_fwd, "wall_s": wall}
        return stamps

    timed_burst("burst A (no reload)", N_REQUESTS, first)

    # a reload inside a burst: the server polls again once the burst's
    # first batch is answered; the step loads on the loader thread while
    # the worker answers, so rounds of the burst follow each other until
    # the worker has applied it
    server.config.reload_poll_s = -1.0
    second = commit_window()
    served = server.stats()["served"]

    def poll_again():
        rl_wait(lambda: server.stats()["served"] > served,
                "burst B's first answers")
        server.config.reload_poll_s = 0.0

    stamps = timed_burst("burst B (a reload in it)", N_REQUESTS,
                         during=poll_again, until=lambda: live() == second)
    order = [s for _, s in sorted(stamps)]
    if set(order) != {first, second} or order != sorted(order) \
            or live() != second:
        fail(f"serve-reload: burst B's steps in serving order {order}, "
             f"want steps {first} then {second}")
    timed_burst("burst C (no reload)", N_REQUESTS, second)

    # a torn newest step: skipped, journaled, the server stays
    server.config.reload_poll_s = -1.0
    third = commit_window()
    path = params_file(third)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)[0]
        f.seek(size // 2)
        f.write(bytes([byte ^ 0xFF]))
    n_fallback = len(events("ckpt_fallback"))
    server.config.reload_poll_s = 0.0
    rl_wait(lambda: store.corrupt_seen == 1, "the torn step's skip")
    fallback = [r for r in events("ckpt_fallback")[n_fallback:]
                if r.get("consumer") == "serving"]
    log(f"serve-reload (g): a byte of step {third}'s ckpt.params flipped: "
        f"journaled {[(r['step'], r['detail'][:60]) for r in fallback]}, "
        f"corrupt_seen {store.corrupt_seen}, serving step "
        f"{live()}")
    if [r["step"] for r in fallback] != [third] \
            or live() != second:
        fail("serve-reload: the torn step was not skipped")
    timed_burst("after the torn step", RL_SMALL, second)

    # a checkpoint of a narrower BERT: refused before any tensor moves
    narrow = get_bert_model("bert_12_768_12", vocab_size=BERT_VOCAB,
                            use_pooler=False, use_classifier=False,
                            **RL_NARROW)
    narrow.initialize(mx.init.Normal(0.02), ctx=mx.cpu(),
                      generator=mx.random.generator(SEED))
    with torch.no_grad():
        narrow(torch.zeros(1, 8, dtype=torch.int32))
    drift = third + RC_WINDOW
    stage = commit.prepare_stage(RL_ROOT, drift)
    nd.save(os.path.join(stage, "ckpt.params"),
            {f"arg:inner.{k}": v for k, v in narrow.collect_params().items()})
    before = {k: v.detach().clone() for k, v in block.collect_params().items()}
    n_failed = len(events("serving_reload_failed"))
    commit.finalize(RL_ROOT, drift)
    rl_wait(lambda: len(events("serving_reload_failed")) > n_failed,
            "the drifted step's refusal")
    changed = sum(not torch.equal(v, before[k])
                  for k, v in block.collect_params().items())
    rec = events("serving_reload_failed")[n_failed]
    log(f"serve-reload (g): step {drift} holds a narrower BERT "
        f"({RL_NARROW}): serving_reload_failed for step {rec['step']} "
        f"({rec['detail'][:90]}); {changed} of {len(before)} parameters "
        f"changed; serving step {live()}")
    if rec["step"] != drift or changed or live() != second:
        fail("serve-reload: the drifted checkpoint was not refused intact")
    del before

    # the deploy pin: back to the first step at the next turn
    server.pin_params(first)
    rl_wait(lambda: live() == first, "the pinned step")
    timed_burst("pinned back", RL_SMALL, first)
    server.pin_params(None)              # unpinned: the newest valid again
    rl_wait(lambda: live() == second, "the unpinned step")

    reloads = events("serving_reload")
    server.stop()
    same = {key: pred._program for key, pred in server.cache.entries()}
    recaptured = server.cache.stats()["misses"] - misses
    summary = [(r["step"], r["prev_step"], round(r["load_s"], 3),
                round(r["apply_s"], 3), r["bytes"]) for r in reloads]
    log(f"serve-reload (g): reloads {summary} "
        f"(step, from, validate and load s, check and copy s, bytes); "
        f"graphs captured after prewarm: {recaptured} new, "
        f"{sum(same[k] is not captured[k] for k in captured)} replaced")
    want = [first, second, first, second]
    if recaptured or any(same[k] is not captured[k] for k in captured) \
            or [r["step"] for r in reloads] != want \
            or server.counters["reloads"] != len(want):
        fail(f"serve-reload: {recaptured} graphs captured after prewarm; "
             f"reloads to {[r['step'] for r in reloads]} (counted "
             f"{server.counters['reloads']}), want 0 and {want} (start, "
             "burst B, the pin, the unpin)")
    sh_release(torch, trainer)
    del model, trainer, server, block, cpu
    torch.cuda.empty_cache()
    return {"bursts": bursts, "graphs": graphs,
            "reloads": [{k: r[k] for k in ("step", "prev_step", "load_s",
                                           "apply_s", "bytes")}
                        for r in reloads],
            "k2_per_forward": bursts["burst A (no reload)"]["k2_per_forward"],
            "launches": bursts["burst A (no reload)"]["batches"]
            * bursts["burst A (no reload)"]["k2_per_forward"]}


# -- phases 20-21: the replica tier and the decode engine -------------------
PL_ROOT = os.path.join(ROOT, "build", "chip_smoke_pool")
PL_REQUESTS = 64                     # requests of a burst
PL_THREADS = 8                       # client threads of a burst
PL_DISTINCT = 16                     # distinct sequences among them
PL_POOL = {"heartbeat_s": 0.25, "deadline_s": 2.0, "monitor_s": 0.25,
           "spawn_s": 120.0}
PL_RETRIES = 3
PL_DEADLINE_MS = 30000.0             # a routed request's deadline
PL_KILL_AFTER = 8                    # answers of a burst before a kill
PL_SCALE = (0.9, 1.1)                # step 2: each weight times a factor
PL_MLP_DIM = 64                      # the workers' mlp (--dim)
PL_MLP_RTOL = 1e-5                   # worker answers vs the CPU mlp
DC_STREAMS = 64                      # decode streams of phase 21
DC_SLOTS, DC_CHUNK = 8, 32           # DecodeConfig (the reference's defaults)
DC_MAX_PROMPT, DC_MAX_NEW = 200, 56
DC_ROUTED = 24                       # concurrent streams through the router
DC_PIN_NEW = 250                     # tokens of the streams holding r0's slots
DC_COMPILES = 7                      # 1 step + 6 prefill programs
# the router of the reload burst and of the routed decode streams: its
# breakers open on heartbeat stalls only. The reference's router counts a
# draining replica's ServerStopped and a full one's SlotsExhausted as
# failures (its docstrings say busy and draining are not broken); with
# two replicas and the default breaker_k of 3, a reload then sheds at
# no_capacity once the first restarted replica's breaker has opened
PL_BUSY_BREAKER_K = 1 << 20


def pl_burst(router, payloads, n, n_threads=PL_THREADS, during=None,
             until=None, what="burst"):
    """``n`` requests through ``router.call`` from ``n_threads`` threads,
    request ``i`` carrying ``payloads[i % len(payloads)]``; with ``until``
    the threads go on sending (a closed loop) until ``until()`` holds.
    ``during()`` runs once the burst has started. Returns ([(i, value,
    replica, params_step, attempts, latency ms, answered at)], wall s);
    fails unless every request is answered."""
    records, errors = [], []
    lock = threading.Lock()
    counter = iter(range(1 << 30))

    def client():
        while True:
            with lock:
                i = next(counter)
            if i >= n and (until is None or until()):
                return
            try:
                resp = router.call(payloads[i % len(payloads)],
                                   deadline_ms=PL_DEADLINE_MS)
            except Exception as exc:      # reported below, then fail
                errors.append(f"request {i}: {exc!r}")
                return
            with lock:
                records.append((i, resp.value, resp.replica,
                                resp.params_step, resp.attempts,
                                resp.latency_ms, time.monotonic()))

    threads = [threading.Thread(target=client) for _ in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if during is not None:
        during(records)
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or len(records) < n:
        fail(f"serve-pool: {what}: {len(records)} answered, errors "
             f"{errors[:3]}")
    records.sort(key=lambda r: r[0])
    return records, wall


def pl_wait(cond, what, timeout_s=180.0):
    t_end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > t_end:
            fail(f"serve-pool: timed out waiting for {what}")
        time.sleep(0.02)


def pl_latency(records):
    lat = sorted(r[5] for r in records)
    return {"p50": lat[len(lat) // 2],
            "p99": lat[min(int(math.ceil(0.99 * len(lat))) - 1,
                           len(lat) - 1)]}


def pl_check(name, records, refs):
    """Every answer of ``records`` against the CPU outputs of its
    sequence under the step that served it (``refs[step]``: seq_out,
    pooled, nsp of the PL_DISTINCT sequences)."""
    import numpy as np
    for step in sorted({r[3] for r in records}):
        rows = [r for r in records if r[3] == step]
        if step not in refs:
            fail(f"serve-pool: {name}: answers served by step {step}")
        for k, out in enumerate(("seq_out", "pooled", "nsp")):
            got = np.stack([r[1][k] for r in rows])
            want = np.stack([refs[step][k][r[0] % PL_DISTINCT]
                             for r in rows])
            check_against_cpu(f"{name} {out} ({len(rows)} answers, step "
                              f"{step})", got, want)


def pl_commit(root, step, params):
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.resilience import commit
    stage = commit.prepare_stage(root, step)
    nd.save(os.path.join(stage, "model.params"), params)
    commit.finalize(root, step)


def pl_events(path, kind):
    """The journal's records of ``kind`` (None: all), in order."""
    with open(path, encoding="utf-8") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if kind is None or r.get("kind") == kind]


def phase_serve_pool(torch, mx, card, ctx, single):
    """(h) Two full-width BERT-base LocalReplicas behind the Router on
    ``ctx``, then two subprocess mlp workers; ``single`` is phase 6's
    one-server burst. Returns the pool and router for phase 21."""
    import shutil

    from mxnet_tpu_torch.diagnostics import journal
    shutil.rmtree(PL_ROOT, ignore_errors=True)
    os.makedirs(PL_ROOT)
    jpath = os.path.join(PL_ROOT, "journal.jsonl")
    journal.reset_journal(jpath)
    return _serve_pool(torch, mx, card, ctx, single, jpath)


def _serve_pool(torch, mx, card, ctx, single, jpath):
    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.diagnostics.journal import get_journal
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.serving import (DecodeConfig, ParamStore,
                                         PoolConfig, ReplicaPool, Router,
                                         RouterConfig, Server, ServerConfig,
                                         TinyLM)
    dev = ctx.torch_device
    ckpt = os.path.join(PL_ROOT, "ckpt")
    net = seeded_bert(torch, mx, ctx, BERT_SEQ, (1,))
    step1 = {k: v.detach().cpu().clone()
             for k, v in net.collect_params().items()}
    del net
    pl_commit(ckpt, 1, step1)
    rng = np.random.RandomState(SEED + 20)
    step2 = {k: v * float(rng.uniform(*PL_SCALE))
             for k, v in sorted(step1.items())}
    ids = np.random.RandomState(SEED + 20).randint(
        0, BERT_VOCAB, (PL_DISTINCT, BERT_SEQ)).astype(np.int32)

    cpu_net = bert_12_768_12(use_decoder=False)
    refs = {}
    for step, weights in ((1, step1), (2, step2)):
        cpu_net.load_dict({k: v.numpy() for k, v in weights.items()},
                          ctx=mx.cpu())
        with torch.inference_mode():
            outs = [cpu_net(torch.from_numpy(ids[i:i + 8]))
                    for i in range(0, PL_DISTINCT, 8)]
        refs[step] = [np.concatenate([o[k].numpy() for o in outs])
                      for k in range(3)]
    del cpu_net

    def factory():
        bert = bert_12_768_12(use_decoder=False)
        bert.initialize(mx.init.Normal(0.02), ctx=ctx,
                        generator=mx.random.generator(SEED, device=dev))
        with torch.inference_mode():       # materialize every parameter
            bert(torch.zeros(1, BERT_SEQ, dtype=torch.int32, device=dev))
        return Server(bert, ServerConfig(
            max_batch=8, dtype="int32", aot_prewarm=((BERT_SEQ,),),
            reload_poll_s=-1.0, decode_model=TinyLM(),
            decode=DecodeConfig(slots=DC_SLOTS, prefill_chunk=DC_CHUNK)),
            param_store=ParamStore(ckpt), ctx=ctx)

    cfg = PoolConfig(**PL_POOL)
    pool = ReplicaPool(os.path.join(PL_ROOT, "pool"), cfg)
    pool.add_local("r0", factory).add_local("r1", factory)
    t0 = time.perf_counter()
    pool.start()
    log(f"serve-pool (h): 2 LocalReplicas of full-width BERT-base (S "
        f"{BERT_SEQ}, int32 ids, fp32, buckets 1/2/4/8 prewarmed, TF32 off, "
        f"TinyLM decode with {DC_SLOTS} slots) on {card}, each loading "
        f"committed step 1 through a ParamStore; ready in "
        f"{time.perf_counter() - t0:.2f} s; pool {PL_POOL}")
    router = Router(pool, RouterConfig(retries=PL_RETRIES))

    def servers():
        return {rid: rep.server for rid, rep in pool.replicas.items()}

    for rid, srv in servers().items():
        report_prewarm(srv, card)
        if srv.stats()["params_step"] != 1:
            fail(f"serve-pool: {rid} serves step "
                 f"{srv.stats()['params_step']}, want 1")
    misses = {rid: srv.cache.stats()["misses"]
              for rid, srv in servers().items()}

    # 1. the burst
    for b in (8, 4, 2, 1):
        pl_burst(router, ids, b, n_threads=1, what="warm")
    before = {rid: srv.stats()["batches"] for rid, srv in servers().items()}
    kernels.reset_launch_counts()
    recs, wall = pl_burst(router, ids, PL_REQUESTS, what="burst 1")
    launches = kernels.launch_counts()
    batches = sum(srv.stats()["batches"] - before[rid]
                  for rid, srv in servers().items())
    used = {r[2]: sum(1 for x in recs if x[2] == r[2]) for r in recs}
    lat = pl_latency(recs)
    log(f"serve-pool (h) burst 1: {PL_REQUESTS} requests from {PL_THREADS} "
        f"threads through router.call answered by {used} in {batches} "
        f"batches; latency p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} "
        f"ms, {PL_REQUESTS / wall:.2f} sequences/s ({wall * 1e3:.1f} ms "
        f"wall); phase 6's single server: p50 {single['p50']:.3f} ms, p99 "
        f"{single['p99']:.3f} ms, {single['per_s']:.2f} sequences/s (32 "
        f"requests from 4 threads); K2 {launches['matmul_epilogue']} "
        f"launches (= {BERT_K2_PER_FORWARD} x {batches})")
    if set(used) != {"r0", "r1"}:
        fail(f"serve-pool: burst 1 answered only by {sorted(used)}")
    if launches["matmul_epilogue"] != BERT_K2_PER_FORWARD * batches \
            or any(n for k, n in launches.items() if k != "matmul_epilogue"):
        fail(f"serve-pool: launches {launches} for {batches} batch "
             "forwards")
    pl_check("burst 1", recs, refs)
    burst1 = {**lat, "per_s": PL_REQUESTS / wall, "batches": batches,
              "k2": launches["matmul_epilogue"], "replicas": used}

    # 2. kill r1 in a burst; the monitor respawns it
    pool.monitor_start()
    r1 = pool.replicas["r1"]
    kill = {}

    def kill_r1(records):
        pl_wait(lambda: len(records) >= PL_KILL_AFTER, "burst 2's answers")
        get_journal().event("smoke_kill", replica="r1")
        kill["t"] = time.monotonic()
        kill["n"] = len(records)
        r1.kill()

    def respawned():
        if "t" not in kill:
            return False
        if "lost" not in kill and pl_events(jpath, "replica_lost"):
            kill["lost"] = time.monotonic()
        st = {s.id: s for s in pool.view()}["r1"]
        if "lost" in kill and st.ready and r1.server is not None \
                and "ready" not in kill:
            kill["ready"] = time.monotonic()
        return "ready" in kill

    torch.cuda.reset_peak_memory_stats()
    recs2, wall2 = pl_burst(router, ids, PL_REQUESTS, during=kill_r1,
                            until=respawned, what="burst 2 (r1 killed)")
    peak = torch.cuda.max_memory_allocated()
    lost = pl_events(jpath, "replica_lost")
    kill_rec = pl_events(jpath, "smoke_kill")[0]
    if [r["replica"] for r in lost] != ["r1"]:
        fail(f"serve-pool: replica_lost records {lost}")
    lag = lost[0]["up_s"] - kill_rec["up_s"]
    in_window = sum(1 for r in recs2
                    if kill["t"] <= r[6] <= kill["ready"] and r[2] == "r0")
    new_r1 = r1.server
    lat2 = pl_latency(recs2)
    log(f"serve-pool (h) burst 2: r1.kill() after {kill['n']} answers; the "
        f"monitor journaled replica_lost {lag:.3f} s after the kill "
        f"(idle_s {lost[0]['idle_s']} on its clock; deadline_s "
        f"{cfg.deadline_s:g} + monitor_s {cfg.monitor_s:g} = "
        f"{cfg.deadline_s + cfg.monitor_s:g}) and restarted r1: ready "
        f"{kill['ready'] - kill['t']:.2f} s after the kill; "
        f"{len(recs2)} requests answered ({sum(r[4] > 1 for r in recs2)} "
        f"after a retry), {in_window} by r0 while r1 was away and "
        f"captured its graphs; latency p50 {lat2['p50']:.3f} ms, p99 "
        f"{lat2['p99']:.3f} ms; r1's new prewarm {new_r1.last_prewarm}; "
        f"peak device memory {peak / 2**30:.2f} GiB (the killed server "
        "stops on a background thread)")
    if lost[0]["idle_s"] > cfg.deadline_s + 2 * cfg.monitor_s:
        fail(f"serve-pool: r1 declared lost at idle {lost[0]['idle_s']} s")
    if not in_window:
        fail("serve-pool: r0 answered nothing while r1 respawned")
    if new_r1.last_prewarm["compiled"] != 4:
        fail(f"serve-pool: r1's respawn captured {new_r1.last_prewarm}")
    pl_check("burst 2", recs2, refs)
    if servers()["r0"].cache.stats()["misses"] != misses["r0"]:
        fail("serve-pool: r0 captured a graph after prewarm")
    pool.monitor_stop()
    # r1's breaker opened on its failures after the kill: requests until
    # its half-open probe has closed it, so the reload below has both
    # replicas in rotation (with one breaker open and the other replica
    # draining, the router sheds at no_capacity, as the reference does)
    pl_wait(lambda: pl_burst(router, ids, 1, n_threads=1, what="settle")
            and all(r["breaker"] == "closed"
                    for r in router.stats()["replicas"].values()),
            "the breakers to close")

    # 3. rolling reload onto step 2
    pl_commit(ckpt, 2, step2)
    default_router, router = router, Router(
        pool, RouterConfig(retries=PL_RETRIES, breaker_k=PL_BUSY_BREAKER_K))
    roll = {}

    def reload(records):
        def run():
            roll["steps"] = pool.reload(surge=1)
            roll["t"] = time.monotonic()
        roll["thread"] = threading.Thread(target=run)
        roll["t0"] = time.monotonic()
        roll["thread"].start()

    recs3, wall3 = pl_burst(router, ids, PL_REQUESTS, during=reload,
                            until=lambda: "t" in roll,
                            what="burst 3 (rolling reload)")
    roll["thread"].join()
    beacons = {rid: srv.beacon()["params_step"]
               for rid, srv in servers().items()}
    stamps = sorted({r[3] for r in recs3})
    lat3 = pl_latency(recs3)
    log(f"serve-pool (h) burst 3: pool.reload(surge=1) took "
        f"{roll['t'] - roll['t0']:.2f} s under load; {len(recs3)} requests "
        f"answered, none lost, stamped with steps {stamps} "
        f"({sum(r[3] == 2 for r in recs3)} by step 2); latency p50 "
        f"{lat3['p50']:.3f} ms, p99 {lat3['p99']:.3f} ms; reload returned "
        f"{roll['steps']}, beacons {beacons}")
    if set(beacons.values()) != {2} or set(roll["steps"].values()) != {2}:
        fail(f"serve-pool: after the reload the replicas serve {beacons}")
    pl_check("burst 3", recs3, refs)
    recs4, _ = pl_burst(router, ids, PL_DISTINCT, what="after the reload")
    if {r[3] for r in recs4} != {2}:
        fail("serve-pool: answers after the reload not from step 2")
    pl_check("after the reload", recs4, refs)
    default_router.stop()
    restarts = pl_events(jpath, "pool_restart")
    log(f"serve-pool (h): pool_restart records "
        f"{[(r['replica'], r['residual'], r['ready']) for r in restarts]}")

    # 4. subprocess replicas
    procs = pl_procs(torch, mx, card, ctx)
    return {"pool": pool, "router": router, "burst1": burst1,
            "respawn_s": kill["ready"] - kill["t"], "lost_after_s": lag,
            "burst2_p99": lat2["p99"], "burst3_p99": lat3["p99"],
            "peak_gib": peak / 2**30, "procs": procs, "jpath": jpath,
            "k2_per_forward": BERT_K2_PER_FORWARD, "refs": refs,
            "launches": launches["matmul_epilogue"]}


def pl_stats(pool, rid):
    header, _ = pool.replicas[rid]._roundtrip({"cmd": "stats"},
                                              budget_s=30.0)
    return header["stats"]


def pl_procs(torch, mx, card, ctx):
    """Part 4: two ProcReplica workers (--model mlp, each its own process
    and CUDA context) behind a router; one SIGKILLed in a burst."""
    import signal

    import numpy as np
    from mxnet_tpu_torch.serving import (PoolConfig, ReplicaPool, Router,
                                         RouterConfig)
    from mxnet_tpu_torch.serving.worker import _build_block
    env = dict(os.environ, MXNET_TPU_JOURNAL="off",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    pool = ReplicaPool(os.path.join(PL_ROOT, "procs"),
                       PoolConfig(**PL_POOL))
    for rid in ("w0", "w1"):
        pool.add_proc(rid, {"--model": "mlp", "--dim": PL_MLP_DIM,
                            "--ctx": ctx.device_type, "--window-ms": 2.0,
                            "--reload-poll-s": -1.0}, env=env)
    t0 = time.monotonic()
    pool.start(wait_ready=False)
    ready = {}

    def all_ready():
        for s in pool.view():
            if s.ready and s.id not in ready:
                ready[s.id] = time.monotonic() - t0
        return len(ready) == 2

    pl_wait(all_ready, "the workers")
    router = Router(pool, RouterConfig(retries=PL_RETRIES))
    x = np.random.RandomState(SEED + 24).randn(
        PL_REQUESTS, PL_MLP_DIM).astype(np.float32)
    cpu = _build_block("mlp", PL_MLP_DIM, mx.cpu())
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x)).numpy()

    def check(name, records):
        got = np.stack([r[1] for r in records])
        want = ref[[r[0] % PL_REQUESTS for r in records]]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        log(f"serve-pool (h) workers {name}: {len(records)} answers vs the "
            f"CPU mlp: max abs err {err:.3e}, relative {err / scale:.3e} "
            f"(tolerance {PL_MLP_RTOL:g} of max |value|)")
        if not err <= PL_MLP_RTOL * scale:
            fail(f"serve-pool: worker answers differ from the CPU mlp by "
                 f"{err}")

    def counted(name, run):
        """Run a burst with each worker's stats frame read before and
        after: K2 once per batch forward of the mlp, in each worker."""
        before = {rid: pl_stats(pool, rid) for rid in pool.replicas}
        records, wall = run()
        after = {rid: pl_stats(pool, rid) for rid in pool.replicas}
        rows = {}
        for rid in pool.replicas:
            k2 = after[rid]["kernel_launches"]["matmul_epilogue"] \
                - before[rid]["kernel_launches"]["matmul_epilogue"]
            n = after[rid]["batches"] - before[rid]["batches"]
            rows[rid] = {"k2": k2, "batches": n,
                         "built": after[rid]["kernels_built"]}
            if k2 != n or after[rid]["kernels_built"]:
                fail(f"serve-pool: worker {rid}: K2 {k2} for {n} batches, "
                     f"built {after[rid]['kernels_built']}")
        log(f"serve-pool (h) workers {name}: {len(records)} requests in "
            f"{wall * 1e3:.1f} ms; per worker (K2 launches = batch "
            f"forwards of the mlp, from its stats frames; kernels it "
            f"built): {rows}")
        check(name, records)
        return rows

    rows_a = counted("burst A", lambda: pl_burst(
        router, x, PL_REQUESTS, what="workers burst A"))
    pool.monitor_start()
    victim = pool.replicas["w1"]
    killed = {}

    def sigkill(records):
        pl_wait(lambda: len(records) >= PL_KILL_AFTER, "the workers' answers")
        killed["pid"] = victim.pid()
        killed["t"] = time.monotonic()
        os.kill(killed["pid"], signal.SIGKILL)

    def back():
        if "t" not in killed:
            return False
        st = {s.id: s for s in pool.view()}["w1"]
        if st.ready and victim.pid() != killed["pid"] \
                and "ready" not in killed:
            killed["ready"] = time.monotonic()
        return "ready" in killed

    recs, _ = pl_burst(router, x, PL_REQUESTS, during=sigkill, until=back,
                       what="workers burst (SIGKILL)")
    check("SIGKILL burst", recs)
    log(f"serve-pool (h) workers: w1 (pid {killed['pid']}) SIGKILLed after "
        f"{PL_KILL_AFTER} answers; the monitor respawned it as pid "
        f"{victim.pid()}, ready {killed['ready'] - killed['t']:.2f} s after "
        f"the kill; {len(recs)} requests answered "
        f"({sum(r[4] > 1 for r in recs)} after a retry); seconds to ready "
        f"at start {ready}")
    rows_b = counted("burst B", lambda: pl_burst(
        router, x, PL_REQUESTS, what="workers burst B"))
    router.stop()
    pool.stop()
    return {"ready_s": ready, "respawn_s": killed["ready"] - killed["t"],
            "burst_a": rows_a, "burst_b": rows_b,
            "k2": sum(r["k2"] for r in rows_a.values())}


def phase_serve_decode(torch, mx, card, pl):
    """(i) TinyLM decode beside BERT-base on phase 20's replicas: 64
    streams on r0 with a BERT burst beside them, a cancelled and an
    expired stream, then 24 streams through Router.decode_call with
    queue_on_busy=False while r0's slots are held."""
    import shutil
    try:
        return _serve_decode(torch, mx, card, pl)
    finally:
        pl["router"].stop()
        pl["pool"].stop()
        from mxnet_tpu_torch.diagnostics import journal
        journal.reset_journal()
        shutil.rmtree(PL_ROOT, ignore_errors=True)
        torch.cuda.empty_cache()


def _serve_decode(torch, mx, card, pl):
    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.serving import (RequestError, ServerOverloaded,
                                         SlotsExhausted)
    pool, router = pl["pool"], pl["router"]
    srv = pool.replicas["r0"].server
    dec = srv.decoder
    model = dec.model
    rng = np.random.RandomState(SEED + 21)
    specs = []
    for _ in range(DC_STREAMS):
        n_prompt = int(rng.randint(1, DC_MAX_PROMPT + 1))
        n_new = int(rng.randint(1, min(DC_MAX_NEW,
                                       model.max_len - n_prompt) + 1))
        specs.append((rng.randint(0, model.vocab, n_prompt).tolist(),
                      n_new))
    compiles0 = dec.stats()["compiles"]
    if compiles0 != DC_COMPILES:
        fail(f"serve-decode: {compiles0} programs after warmup(), want "
             f"{DC_COMPILES}")
    got, errors = {}, []

    def client(idx):
        try:
            streams = [(i, srv.decode_submit(specs[i][0],
                                             max_new_tokens=specs[i][1],
                                             deadline_ms=60000))
                       for i in idx]
            for i, s in streams:
                got[i] = s.result(120)
        except Exception as exc:
            errors.append(repr(exc))

    ids = np.random.RandomState(SEED + 20).randint(
        0, BERT_VOCAB, (PL_DISTINCT, BERT_SEQ)).astype(np.int32)
    dec.step_latency.reset()
    st0 = dec.stats()
    before = {rid: rep.server.stats()["batches"]
              for rid, rep in pool.replicas.items()}
    kernels.reset_launch_counts()
    threads = [threading.Thread(target=client,
                                args=(range(k, DC_STREAMS, PL_THREADS),))
               for k in range(PL_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    bert, _ = pl_burst(router, ids, PL_REQUESTS, what="BERT beside decode")
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    batches = sum(rep.server.stats()["batches"] - before[rid]
                  for rid, rep in pool.replicas.items())
    st = dec.stats()
    if errors or len(got) != DC_STREAMS:
        fail(f"serve-decode: {len(got)} of {DC_STREAMS} streams finished, "
             f"errors {errors[:3]}")
    wrong = [i for i in range(DC_STREAMS)
             if got[i] != model.reference(*specs[i])]
    tokens = st["tokens_out"] - st0["tokens_out"]
    steps = st["steps"] - st0["steps"]
    blat = pl_latency(bert)
    log(f"serve-decode (i): {DC_STREAMS} TinyLM streams (prompts "
        f"{min(len(p) for p, _ in specs)}-{max(len(p) for p, _ in specs)} "
        f"tokens, max_new_tokens {min(n for _, n in specs)}-"
        f"{max(n for _, n in specs)}) from {PL_THREADS} threads on r0 "
        f"({DC_SLOTS} slots, chunk buckets {list(dec.prefill_buckets)}) "
        f"in {wall:.3f} s: {len(wrong)} differ from TinyLM.reference; "
        f"{steps} steps, {tokens} tokens, {tokens / wall:.1f} tokens/s, "
        f"step p50 {st['step_ms']['p50']:.3f} ms, p99 "
        f"{st['step_ms']['p99']:.3f} ms; programs {st['programs']}, "
        f"compiles {compiles0} after warmup() and {st['compiles']} now; "
        f"beside it {len(bert)} BERT requests through the router: p50 "
        f"{blat['p50']:.3f} ms, p99 {blat['p99']:.3f} ms, K2 "
        f"{launches['matmul_epilogue']} launches (= "
        f"{BERT_K2_PER_FORWARD} x {batches}) on {card}")
    if wrong:
        fail(f"serve-decode: streams {wrong[:5]} differ from the reference")
    if st["compiles"] != DC_COMPILES:
        fail(f"serve-decode: {st['compiles']} programs after the streams")
    if launches["matmul_epilogue"] != BERT_K2_PER_FORWARD * batches:
        fail(f"serve-decode: K2 {launches} for {batches} BERT forwards")
    pl_check("BERT beside decode", bert, pl["refs"])

    # a cancelled and an expired stream; their slots serve the next ones
    long = srv.decode_submit([1, 2, 3], max_new_tokens=DC_PIN_NEW)
    while len(long.tokens) < 4 and not long.done.is_set():
        time.sleep(0.0005)
    long.cancel()
    outcomes = {}
    for name, stream in (("cancelled", long), ("deadline 1 ms", srv.
                         decode_submit([5, 6, 7], max_new_tokens=100,
                                       deadline_ms=1))):
        try:
            stream.result(60)
            fail(f"serve-decode: the {name} stream finished")
        except RequestError as exc:
            outcomes[name] = (type(exc).__name__, exc.retryable, str(exc))
    if outcomes["cancelled"][:2] != ("RequestError", False) \
            or outcomes["deadline 1 ms"][:2] != ("DeadlineExceeded", False):
        fail(f"serve-decode: outcomes {outcomes}")
    after = [srv.decode_submit(p, max_new_tokens=n) for p, n in specs[:8]]
    if [s.result(60) for s in after] != [model.reference(p, n)
                                         for p, n in specs[:8]]:
        fail("serve-decode: streams after the cancel differ")
    pl_wait(lambda: dec.occupancy() == 0, "the freed slots")
    log(f"serve-decode (i): {outcomes}; the next 8 streams exact, "
        f"occupancy back to {dec.occupancy()}")

    # Router.decode_call with queue_on_busy=False while r0's slots are
    # held (phase 20's reload router: with the default breaker_k both
    # breakers open on SlotsExhausted within the first submissions)
    pins = [srv.decode_submit([2, 3], max_new_tokens=DC_PIN_NEW)
            for _ in range(DC_SLOTS)]
    pl_wait(lambda: dec.occupancy() == DC_SLOTS, "r0's held slots")
    for rep in pool.replicas.values():
        rep.server.decoder.config.queue_on_busy = False
    routed = [(rng.randint(0, model.vocab, int(rng.randint(1, 33))).tolist(),
               int(rng.randint(8, 41))) for _ in range(DC_ROUTED)]
    results = {}

    def route(i):
        try:
            results[i] = router.decode_call(routed[i][0],
                                            max_new_tokens=routed[i][1],
                                            deadline_ms=30000)
        except (SlotsExhausted, ServerOverloaded) as exc:
            results[i] = exc
        except Exception as exc:          # reported below, then fail
            results[i] = repr(exc)

    threads = [threading.Thread(target=route, args=(i,))
               for i in range(DC_ROUTED)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    done = {i: r for i, r in results.items() if hasattr(r, "value")}
    shed = {i: type(r).__name__ for i, r in results.items()
            if isinstance(r, RequestError)}
    bad = [i for i, r in done.items()
           if r.value != model.reference(*routed[i])]
    moved = sum(1 for r in done.values() if r.attempts > 1)
    retries = [r for r in pl_events(pl["jpath"], "router_retry")
               if r.get("op") == "decode"]
    log(f"serve-decode (i) routed: {DC_ROUTED} concurrent streams through "
        f"Router.decode_call (queue_on_busy=False, r0's {DC_SLOTS} slots "
        f"held): {len(done)} finished ({moved} on another replica after "
        f"SlotsExhausted, by replica "
        f"{ {k: sum(r.replica == k for r in done.values()) for k in pool.replicas} }"
        f"), {len(shed)} shed {sorted(set(shed.values()))}; router_retry "
        f"(decode) errors {sorted({r['error'] for r in retries})}")
    if len(done) + len(shed) != DC_ROUTED or bad or not moved:
        fail(f"serve-decode: routed streams: {len(done)} finished "
             f"({bad} wrong, {moved} moved), shed {shed}, other "
             f"{[r for r in results.values() if isinstance(r, str)]}")
    if [p.result(60) for p in pins] != [model.reference([2, 3], DC_PIN_NEW)
                                        ] * DC_SLOTS:
        fail("serve-decode: the held streams differ from the reference")
    for rid, rep in pool.replicas.items():
        n = rep.server.decoder.stats()["compiles"]
        misses = rep.server.cache.stats()["misses"]
        if n != DC_COMPILES or misses != len(rep.server.grid.batch_buckets):
            fail(f"serve-decode: {rid} built {n} decode programs and "
                 f"{misses} predictors")
    return {"tokens_per_s": tokens / wall, "steps": steps,
            "step_p50": st["step_ms"]["p50"],
            "step_p99": st["step_ms"]["p99"], "bert_p99": blat["p99"],
            "k2": launches["matmul_epilogue"], "batches": batches,
            "routed_done": len(done), "routed_moved": moved,
            "routed_shed": len(shed)}

# -- phase 22: trace -----------------------------------------------------------
TR_ROOT = os.path.join(ROOT, "build", "chip_smoke_trace")
TR_MODES = ("off", "ring", "journal")
TR_ROUNDS = 3                        # interleaved bursts per mode
TR_REPLAY_REPS = 5                   # CUDA-event timings of a graph replay
TR_TRAIN_BATCH = 8                   # (c): the BERT-base MLM at S 128
TR_STEPS = 4                         # counted graphed steps per mode
TR_CLIENTS = 8                       # (d): client threads of the routed burst
TR_FLIGHT_S = "0.5"                  # the workers' flight-recorder flush
TR_SYNC_WARNING = "called a synchronizing CUDA operation"
TR_ANSWER_RTOL = 1e-5                # a burst's answers vs the first's


def phase_trace(torch, mx, card, ctx, pl):
    """Span tracing on the card; ``pl`` is phase 20's result (its burst
    1 is (h)'s untraced rate). The trace mode is set back to off at the
    end."""
    import shutil

    from mxnet_tpu_torch.observability import trace
    shutil.rmtree(TR_ROOT, ignore_errors=True)
    os.makedirs(TR_ROOT)
    try:
        out = tr_cost_and_trees(torch, mx, card, ctx)
        out["sync"] = tr_sync(torch, mx, card, ctx)
        out["pod"] = tr_pod(torch, mx, card, ctx, pl["burst1"])
    finally:
        trace.configure(mode="off")
    return out


def tr_children(spans):
    """{parent span id: [span dicts]} of a span list."""
    kids = {}
    for sp in spans:
        kids.setdefault(sp.get("parent_id"), []).append(sp)
    return kids


def tr_trees(spans, n_requests, batches, what):
    """Fail unless ``spans`` (one burst's ring) hold ``n_requests``
    serving_request roots, each closed "ok" with exactly one enqueue,
    execute and respond child, each execute naming one of the burst's
    ``batches`` serving_batch spans. Returns the execute spans."""
    kids = tr_children(spans)
    roots = [sp for sp in spans if sp["name"] == "serving_request"]
    batch_ids = {sp["span_id"] for sp in spans
                 if sp["name"] == "serving_batch"}
    executes = []
    for root in roots:
        names = sorted(c["name"] for c in kids.get(root["span_id"], ()))
        ex = [c for c in kids.get(root["span_id"], ())
              if c["name"] == "execute"]
        if root.get("parent_id") is not None \
                or (root.get("attrs") or {}).get("status") != "ok" \
                or names != ["enqueue", "execute", "respond"] \
                or ex[0]["attrs"]["batch_span"] not in batch_ids:
            fail(f"trace (b) {what}: request tree {root} with children "
                 f"{names}")
        executes.append(ex[0])
    if len(roots) != n_requests or len(batch_ids) != batches:
        fail(f"trace (b) {what}: {len(roots)} serving_request trees and "
             f"{len(batch_ids)} serving_batch spans for {n_requests} "
             f"requests in {batches} batches")
    return executes


def tr_replay_ms(torch, pred):
    """The least of TR_REPLAY_REPS replays of a predictor's graph timed
    with CUDA events on this thread's stream."""
    times = []
    for _ in range(TR_REPLAY_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pred.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def tr_cost_and_trees(torch, mx, card, ctx):
    """(a) and (b) on a fresh phase-6 server."""
    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.diagnostics import journal
    from mxnet_tpu_torch.observability import trace
    from mxnet_tpu_torch.observability.metrics import LatencySummary
    from mxnet_tpu_torch.serving import Server, ServerConfig
    net = seeded_bert(torch, mx, ctx, BERT_SEQ, (1, 2, 4, 8))
    ids = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (N_REQUESTS, BERT_SEQ)).astype(np.int32)
    server = Server(net, ServerConfig(max_batch=8, dtype="int32",
                                      aot_prewarm=((BERT_SEQ,),)),
                    ctx=ctx).start()
    b = BATCH
    while b >= 1:                          # every bucket on the worker
        burst(server, ids, range(b), 1)
        b //= 2
    # one journal sink for every mode: the serving_batch records go to it
    # in all three, the spans only under journal
    journal.reset_journal(os.path.join(TR_ROOT, "journal-cost.jsonl"))
    rows = {m: {"wall_s": 0.0, "n": 0, "k2": 0, "batches": 0,
                "lat": LatencySummary(f"trace_{m}_ms")} for m in TR_MODES}
    first, executes, n_trees, worst = None, [], 0, 0.0
    for _ in range(TR_ROUNDS):
        for mode in TR_MODES:
            tracer = trace.configure(mode=mode)
            row = rows[mode]
            server.latency = row["lat"]
            before = server.stats()["batches"]
            kernels.reset_launch_counts()
            results, wall = burst(server, ids, range(N_REQUESTS), 4)
            launches = kernels.launch_counts()
            batches = server.stats()["batches"] - before
            if launches["matmul_epilogue"] != BERT_K2_PER_FORWARD * batches \
                    or any(n for k, n in launches.items()
                           if k != "matmul_epilogue"):
                fail(f"trace (a) {mode}: launches {launches} for {batches} "
                     "batch forwards")
            got = [np.stack([results[i][k] for i in range(N_REQUESTS)])
                   for k in range(3)]
            if first is None:
                first = got
            # batches form differently from burst to burst, and a bucket
            # is its own graph: the answers agree to rounding
            rel = max(float(np.abs(u - v).max() / np.abs(v).max())
                      for u, v in zip(got, first))
            worst = max(worst, rel)
            if not rel <= TR_ANSWER_RTOL:
                fail(f"trace (a) {mode}: answers differ from the first "
                     f"burst's by {rel:.3e} of max |value|")
            row["wall_s"] += wall
            row["n"] += N_REQUESTS
            row["k2"] += launches["matmul_epilogue"]
            row["batches"] += batches
            if mode != "off":
                spans = tracer.spans()
                executes += tr_trees(spans, N_REQUESTS, batches, mode)
                n_trees += N_REQUESTS
            elif tracer.spans():
                fail("trace (a) off: the ring holds spans")
    # the same batches in every mode: one batch of BATCH at a time
    fixed = {}
    for mode in TR_MODES:
        trace.configure(mode=mode)
        kernels.reset_launch_counts()
        for k in range(N_REQUESTS // BATCH):
            burst(server, ids, range(BATCH * k, BATCH * (k + 1)), 1)
        fixed[mode] = kernels.launch_counts()["matmul_epilogue"]
    trace.configure(mode="off")
    log(f"trace (a): K2 launches over {N_REQUESTS // BATCH} batches of "
        f"{BATCH} submitted one batch at a time: {fixed}; every burst's "
        f"answers within {worst:.3e} of max |value| of the first burst's "
        f"(tolerance {TR_ANSWER_RTOL:g})")
    if set(fixed.values()) != {BERT_K2_PER_FORWARD * (N_REQUESTS // BATCH)}:
        fail(f"trace (a): K2 launches {fixed} for the same batches")
    cost = {}
    for mode, row in rows.items():
        lat = row["lat"].summary()
        cost[mode] = {"per_s": row["n"] / row["wall_s"], "p50": lat["p50"],
                      "p99": lat["p99"], "k2": row["k2"],
                      "k2_fixed": fixed[mode],
                      "batches": row["batches"],
                      "k2_per_batch": row["k2"] / row["batches"]}
        log(f"trace (a) MXNET_TPU_TRACE={mode}: {row['n']} requests in "
            f"{TR_ROUNDS} bursts of {N_REQUESTS} (4 threads, 8 at once), "
            f"rounds interleaved with the other modes: "
            f"{cost[mode]['per_s']:.2f} sequences/s, latency p50 "
            f"{lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms; K2 "
            f"{row['k2']} launches over {row['batches']} batch forwards "
            f"({cost[mode]['k2_per_batch']:g} each) on {card}")
    # (b): each execute span against its graph's replay on the card
    floor = {}
    for (bucket, _key, _dt), pred in server.cache.entries():
        if any(e["attrs"]["bucket"] == bucket for e in executes):
            floor[bucket] = tr_replay_ms(torch, pred)
    short = [e for e in executes
             if e["dur_s"] * 1e3 < floor[e["attrs"]["bucket"]]]
    by_bucket = {bk: sorted(e["dur_s"] * 1e3 for e in executes
                            if e["attrs"]["bucket"] == bk) for bk in floor}
    log(f"trace (b): {n_trees} answered requests of the ring and journal "
        f"bursts, each a serving_request tree (enqueue, execute, respond) "
        f"under a serving_batch span; execute ms per bucket (min / median "
        f"over requests) against the graph replay's CUDA-event ms (least "
        f"of {TR_REPLAY_REPS}): "
        + ", ".join(f"bucket {bk}: {v[0]:.3f} / {v[len(v) // 2]:.3f} vs "
                    f"{floor[bk]:.3f}" for bk, v in sorted(by_bucket.items()))
        + f" on {card}")
    if short:
        fail(f"trace (b): {len(short)} execute spans shorter than their "
             f"graph's replay: {short[:2]}")
    server.stop()
    del server, net
    torch.cuda.empty_cache()
    return {"cost": cost, "execute_vs_replay": {
        bk: {"execute_min_ms": v[0], "replay_ms": floor[bk]}
        for bk, v in by_bucket.items()}}


def tr_syncs(torch, fn):
    """(synchronizing calls that torch.cuda.set_sync_debug_mode("warn")
    reports while ``fn`` runs, seconds)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _sync(torch)
        wall = time.perf_counter() - t0
    return sum(TR_SYNC_WARNING in str(w.message) for w in caught), wall


def tr_sync(torch, mx, card, ctx):
    """(c) Graphed ShardedTrainer steps of the BERT-base MLM, off against
    journal, counting synchronizing calls."""
    import numpy as np
    from mxnet_tpu_torch import kernels, observability
    from mxnet_tpu_torch.diagnostics import journal
    from mxnet_tpu_torch.observability import metrics, trace
    dev = ctx.torch_device
    tokens = np.random.RandomState(0).randint(
        0, BERT_VOCAB, (TR_TRAIN_BATCH, BERT_SEQ))
    ids = torch.from_numpy(tokens.astype(np.int32)).to(dev)
    model, trainer = sh_bert(torch, mx, ctx, "bfloat16", BERT_SEQ)
    trainer.prepare(ids)
    metrics.reset_metrics()
    trace.configure(mode="off")
    trainer.step(ids, ids)                 # the capture
    _sync(torch)
    # the detector's control: one host read it must see
    control = tr_syncs(torch, lambda: torch.ones(1, device=dev).item())[0]
    if control < 1:
        fail(f"trace (c): a .item() read counted {control} synchronizing "
             "calls")
    jpath = os.path.join(TR_ROOT, "journal-train.jsonl")
    journal.reset_journal(jpath)
    rows = {}

    def steps():
        for _ in range(TR_STEPS):
            trainer.step(ids, ids)

    for mode in ("off", "journal"):
        trace.configure(mode=mode)
        kernels.reset_launch_counts()
        syncs, wall = tr_syncs(torch, steps)
        rows[mode] = {"syncs": syncs, "step_ms": wall * 1e3 / TR_STEPS,
                      "k2": kernels.launch_counts()["matmul_epilogue"]}
    trace.configure(mode="off")
    spans = pl_events(jpath, "span")
    names = [sp["name"] for sp in spans]
    stats = observability.compile_stats()
    phases = metrics.default_registry().snapshot()[
        "mxnet_tpu_step_phase_ms"]["values"]
    replays = phases["trainer=sharded_trainer,phase=compiled_step"]["count"]
    log(f"trace (c): BERT-base MLM, batch {TR_TRAIN_BATCH}, S {BERT_SEQ}, "
        f"bf16, ShardedTrainer.step as a graph replay: {TR_STEPS} steps "
        f"per mode under torch.cuda.set_sync_debug_mode(\"warn\"): "
        + "; ".join(f"{m}: {r['syncs']} synchronizing calls, "
                    f"{r['step_ms']:.3f} ms per step, K2 {r['k2']}"
                    for m, r in rows.items())
        + f" (a control .item(): {control}); journal spans: "
        f"{names.count('sharded_trainer.step')} sharded_trainer.step, "
        f"{names.count('sharded_trainer.compiled_step')} compiled_step; "
        f"compiled_step phases {replays} (the capture's and "
        f"{2 * TR_STEPS} replays); program builds {stats['by_site']} "
        f"for {len(trainer._programs)} captured program(s) on {card}")
    if rows["off"]["syncs"] != rows["journal"]["syncs"] \
            or rows["off"]["k2"] != rows["journal"]["k2"]:
        fail(f"trace (c): off and journal steps differ: {rows}")
    if names.count("sharded_trainer.compiled_step") != TR_STEPS \
            or names.count("sharded_trainer.step") != TR_STEPS \
            or replays != 1 + 2 * TR_STEPS:
        fail(f"trace (c): {names.count('sharded_trainer.compiled_step')} "
             f"compiled_step spans, {replays} phases for {TR_STEPS} steps")
    if stats["compiles"] != len(trainer._programs) \
            or len(trainer._programs) != 1:
        fail(f"trace (c): {stats['compiles']} program builds for "
             f"{len(trainer._programs)} captures")
    sh_release(torch, trainer)
    del model, trainer
    torch.cuda.empty_cache()
    return rows


def tr_split(spans):
    """Per routed request of ``spans`` (one process's ring): router_ms
    (router_request minus its serving_request), queue_ms (serving_request
    start to execute start: admission, queue, batching window, padding),
    execute_ms and respond_ms (execute end to serving_request end), and
    the request's trace id and total."""
    kids = tr_children(spans)
    rows = []
    for root in (sp for sp in spans if sp["name"] == "router_request"):
        att = [c for c in kids.get(root["span_id"], ())
               if c["name"] == "router_attempt"]
        req = [c for a in att for c in kids.get(a["span_id"], ())
               if c["name"] == "serving_request"
               and (c.get("attrs") or {}).get("status") == "ok"]
        if len(req) != 1:
            fail(f"trace (d): router_request {root['trace_id']} has "
                 f"{len(req)} answered serving_request spans")
        req = req[0]
        ex = [c for c in kids.get(req["span_id"], ())
              if c["name"] == "execute"][0]
        end_req = req["start_s"] + req["dur_s"]
        rows.append({
            "trace_id": root["trace_id"], "total_ms": root["dur_s"] * 1e3,
            "router_ms": (root["dur_s"] - req["dur_s"]) * 1e3,
            "queue_ms": (ex["start_s"] - req["start_s"]) * 1e3,
            "execute_ms": ex["dur_s"] * 1e3,
            "respond_ms": (end_req - ex["start_s"] - ex["dur_s"]) * 1e3})
    return rows


def tr_print_path(what, path, card):
    if not path.get("ok"):
        fail(f"trace (d): critical path of {what}: {path}")
    log(f"trace (d) critical path of {what} (trace {path['trace_id']}, "
        f"{path['wall_ms']:.3f} ms wall, processes {path['processes']}) on "
        f"{card}:")
    for st in path["steps"]:
        log(f"    {st['name']:<20} {st['proc']:<24} start "
            f"{st['start_ms']:9.3f} ms  dur {st['dur_ms']:9.3f} ms"
            + (f"  gap {st['gap_ms']:.3f} ms" if "gap_ms" in st else ""))


def tr_bert_pool(torch, mx, card, ctx):
    """(h)'s replicas again (phase 21 stopped phase 20's pool): two
    full-width BERT-base LocalReplicas of phase 6's seeded weights, every
    bucket captured at start(); the CPU outputs of the PL_DISTINCT
    sequences, keyed by the served step (None: no ParamStore)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.serving import (PoolConfig, ReplicaPool, Server,
                                         ServerConfig)

    def factory():
        return Server(seeded_bert(torch, mx, ctx, BERT_SEQ, (1,)),
                      ServerConfig(max_batch=8, dtype="int32",
                                   aot_prewarm=((BERT_SEQ,),),
                                   reload_poll_s=-1.0), ctx=ctx)

    pool = ReplicaPool(os.path.join(TR_ROOT, "bert"), PoolConfig(**PL_POOL))
    pool.add_local("r0", factory).add_local("r1", factory)
    t0 = time.perf_counter()
    pool.start()
    log(f"trace (d): 2 LocalReplicas of full-width BERT-base (phase 6's "
        f"seeded weights, buckets 1/2/4/8 captured) ready in "
        f"{time.perf_counter() - t0:.2f} s on {card}")
    ids = np.random.RandomState(SEED + 20).randint(
        0, BERT_VOCAB, (PL_DISTINCT, BERT_SEQ)).astype(np.int32)
    cpu_net = bert_12_768_12(use_decoder=False)
    cpu_net.load_dict({k: v.detach().cpu().numpy() for k, v in
                       pool.replicas["r0"].server.block.collect_params()
                       .items()}, ctx=mx.cpu())
    with torch.inference_mode():
        outs = [cpu_net(torch.from_numpy(ids[i:i + 8]))
                for i in range(0, PL_DISTINCT, 8)]
    refs = {None: [np.concatenate([o[k].numpy() for o in outs])
                   for k in range(3)]}
    return pool, ids, refs


def tr_routed_bert(torch, mx, card, ctx, tracer, untraced):
    """(d) 1: BERT-base through a journal-traced router at TR_CLIENTS
    clients, each request's time split by its spans. Returns the split's
    medians and p99s, the rate, the p99 and the median request's trace
    id."""
    from mxnet_tpu_torch.serving import Router, RouterConfig
    pool, ids, refs = tr_bert_pool(torch, mx, card, ctx)
    router = Router(pool, RouterConfig(retries=PL_RETRIES))
    try:
        for b in (8, 4, 2, 1):
            pl_burst(router, ids, b, n_threads=1, what="traced warm")
        tracer.clear()
        recs, wall = pl_burst(router, ids, PL_REQUESTS,
                              n_threads=TR_CLIENTS, what="traced burst")
        split = tr_split(tracer.spans())
    finally:
        router.stop()
        pool.stop()
    pl_check("traced burst", recs, refs)
    if len(split) != PL_REQUESTS:
        fail(f"trace (d): {len(split)} routed request trees for "
             f"{PL_REQUESTS} requests")
    lat = pl_latency(recs)
    parts = ("router_ms", "queue_ms", "execute_ms", "respond_ms",
             "total_ms")
    med = {k: _median([r[k] for r in split]) for k in parts}
    p99 = {k: sorted(r[k] for r in split)[
        min(int(math.ceil(0.99 * len(split))) - 1, len(split) - 1)]
        for k in parts}
    log(f"trace (d) (h) traced: {PL_REQUESTS} requests from {TR_CLIENTS} "
        f"clients through router.call over the two BERT-base "
        f"LocalReplicas, MXNET_TPU_TRACE=journal: {PL_REQUESTS / wall:.2f} "
        f"sequences/s, latency p50 {lat['p50']:.3f} ms, p99 "
        f"{lat['p99']:.3f} ms (phase 20's burst 1 untraced: "
        f"{untraced['per_s']:.2f} sequences/s, p99 "
        f"{untraced['p99']:.3f} ms); per request, median / p99 ms: "
        + ", ".join(f"{k[:-3]} {med[k]:.3f} / {p99[k]:.3f}" for k in parts)
        + f" on {card}")
    median = sorted(split, key=lambda r: r["total_ms"])[len(split) // 2]
    return {"split_median_ms": med, "split_p99_ms": p99,
            "per_s": PL_REQUESTS / wall, "p99": lat["p99"],
            "median_trace": median["trace_id"]}


def tr_workers(torch, mx, ctx, run_dir):
    """(d) 2: two mlp workers with PoolConfig(trace_dir=run_dir) behind
    the traced router; w1 SIGKILLed mid-burst and respawned by the
    monitor. Returns the killed pid."""
    import signal

    import numpy as np
    from mxnet_tpu_torch.serving import (PoolConfig, ReplicaPool, Router,
                                         RouterConfig)
    from mxnet_tpu_torch.serving.worker import _build_block
    env = dict(os.environ, MXNET_TPU_JOURNAL="off",
               MXNET_TPU_TRACE_FLIGHT_S=TR_FLIGHT_S,
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    pool = ReplicaPool(os.path.join(TR_ROOT, "procs"),
                       PoolConfig(**PL_POOL, trace_dir=run_dir))
    for rid in ("w0", "w1"):
        pool.add_proc(rid, {"--model": "mlp", "--dim": PL_MLP_DIM,
                            "--ctx": ctx.device_type, "--window-ms": 2.0,
                            "--reload-poll-s": -1.0}, env=env)
    x = np.random.RandomState(SEED + 24).randn(
        PL_REQUESTS, PL_MLP_DIM).astype(np.float32)
    cpu = _build_block("mlp", PL_MLP_DIM, mx.cpu())
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x)).numpy()

    def check(name, records):
        got = np.stack([r[1] for r in records])
        want = ref[[r[0] % PL_REQUESTS for r in records]]
        err = float(np.abs(got - want).max())
        if not err <= PL_MLP_RTOL * float(np.abs(want).max()):
            fail(f"trace (d): {name}: worker answers differ from the CPU "
                 f"mlp by {err}")

    router = Router(pool, RouterConfig(retries=PL_RETRIES))
    killed = {}
    try:
        pool.start(wait_ready=False)
        pl_wait(lambda: all(s.ready for s in pool.view()),
                "the traced workers")
        check("burst A", pl_burst(router, x, PL_REQUESTS,
                                  what="traced workers burst A")[0])
        # two flush intervals: a periodic flight dump holds burst A's
        # spans before the kill
        time.sleep(2 * float(TR_FLIGHT_S))
        pool.monitor_start()
        victim = pool.replicas["w1"]

        def sigkill(records):
            pl_wait(lambda: len(records) >= PL_KILL_AFTER,
                    "the workers' answers")
            killed["pid"] = victim.pid()
            os.kill(killed["pid"], signal.SIGKILL)

        def back():
            return "pid" in killed and victim.pid() != killed["pid"] and \
                {s.id: s for s in pool.view()}["w1"].ready

        check("SIGKILL burst", pl_burst(
            router, x, PL_REQUESTS, during=sigkill, until=back,
            what="traced workers burst (SIGKILL)")[0])
        check("burst B", pl_burst(router, x, PL_REQUESTS,
                                  what="traced workers burst B")[0])
    finally:
        router.stop()
        pool.stop()
    return killed["pid"]


def tr_pod(torch, mx, card, ctx, untraced):
    """(d) The traced pod: (h)'s BERT-base replicas behind a traced
    router, two subprocess workers with PoolConfig(trace_dir=), one
    SIGKILLed; the run directory merged. ``untraced`` is phase 20's
    burst 1."""
    from mxnet_tpu_torch.diagnostics import journal
    from mxnet_tpu_torch.observability import aggregate, flight, trace
    run_dir = os.path.join(TR_ROOT, "run")
    os.makedirs(run_dir)
    journal.reset_journal(os.path.join(run_dir, "journal-router.jsonl"))
    tracer = trace.configure(mode="journal")
    try:
        out = tr_routed_bert(torch, mx, card, ctx, tracer, untraced)
        killed_pid = tr_workers(torch, mx, ctx, run_dir)
    finally:
        trace.configure(mode="off")

    # 3. the run directory, merged
    t0 = time.perf_counter()
    procs = aggregate.scan_run_dir(run_dir)
    doc = aggregate.aggregate_chrome(run_dir)
    merge_s = time.perf_counter() - t0
    with open(os.path.join(TR_ROOT, "pod_trace.json"), "w") as f:
        json.dump(doc, f)
    routers = [p for p in procs if p.identity.get("replica") is None]
    workers = {p.identity.get("replica"): p for p in procs
               if p.identity.get("replica") is not None}
    if len(routers) != 1 or sorted(workers) != ["w0", "w1"]:
        fail(f"trace (d): processes {[p.label for p in procs]}")
    routed = {sp["trace_id"] for sp in routers[0].spans
              if sp["name"] == "router_request"}
    crossing = sorted(routed & {sp["trace_id"] for w in workers.values()
                                for sp in w.spans
                                if sp["name"] == "serving_request"})
    # whole dumps only, as the aggregator reads them: the SIGKILL may land
    # mid-flush and leave the writer's `<dump>.tmp.<pid>.<n>` staging file
    dumps = {}
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("flight-replica-w1") and name.endswith(".json"):
            doc_f = flight.read_flight(os.path.join(run_dir, name))
            dumps[doc_f["pid"]] = (name, doc_f)
    if killed_pid not in dumps:
        fail(f"trace (d): no flight dump of the killed worker "
             f"(pid {killed_pid}) among {sorted(os.listdir(run_dir))}")
    kname, kdoc = dumps[killed_pid]
    log(f"trace (d) pod run directory: {sorted(os.listdir(run_dir))}; "
        f"merged in {merge_s:.3f} s into {len(doc['traceEvents'])} events "
        f"over processes {doc['metadata']['processes']}; {len(crossing)} "
        f"trace ids cross from the router's journal into a worker's; the "
        f"killed w1 (pid {killed_pid}): {kname}, reason "
        f"{kdoc['reason']!r}, seq {kdoc['seq']}, {len(kdoc['spans'])} spans, "
        f"{len(kdoc['journal_tail'])} journal records, last phase "
        f"{kdoc['last_phase']!r}; ring {kdoc['trace']} on {card}")
    if not crossing or not kdoc["spans"]:
        fail("trace (d): no trace spans the router and a worker, or the "
             "killed worker's dump holds no span")
    report = aggregate.timeline_report(run_dir, trace_id=crossing[-1])
    path = report.get("critical_path") or {}
    if not report["ok"] or len(path.get("processes", ())) < 2:
        fail(f"trace (d): timeline report {report}")
    tr_print_path("a routed request of BERT-base at 8 clients (the median "
                  "total)", aggregate.critical_path(
                      procs, trace_id=out["median_trace"]), card)
    tr_print_path("a routed request to a subprocess worker", path, card)
    return {**out, "crossing": len(crossing), "merge_s": merge_s,
            "killed_dump": {"reason": kdoc["reason"],
                            "spans": len(kdoc["spans"])}}


FL_ROOT = os.path.join(ROOT, "build", "chip_smoke_fleet")
# (tenant, weights seed, dtype, SLO class): three full-width BERT-base
# families on one Fleet, the third cast to bf16 for serving
FL_TENANTS = (("bert_a", SEED + 23, "float32", "gold"),
              ("bert_b", SEED + 24, "float32", "gold"),
              ("bert_bf16", SEED + 25, "bfloat16", "silver"))
FL_HOT = 2                           # max_hot_tenants
FL_ROUNDS = ("bert_a", "bert_b", "bert_bf16", "bert_a", "bert_b",
             "bert_bf16")            # 16 requests each: 6 page-ins
FL_PER_ROUND = 16
FL_THREADS = 4
FL_DISTINCT = 8                      # distinct sequences per tenant
FL_BF16_RTOL = 3e-2                  # bf16 tenant vs the CPU's bf16 run
FL_BREAKER_K = 3
FL_COOLDOWN_S = 1.0
FL_DEADLINE_MS = 30000.0             # page-ins stall a batch: no misses
FL_LEAK_BYTES = 64 << 20             # residual drift across page cycles
FL_FREED = 0.9                       # a page-out frees >= this share
FL_SKEW_LAYER = "encoder.transformer_cells.3."
DP_ROOT = os.path.join(ROOT, "build", "chip_smoke_deploy")
DP_THREADS = 4
DP_CFG = {"canary_k": 1, "window_s": 1.0, "promote_after": 2,
          "min_samples": 20, "mirror_fraction": 0.25, "rollback_s": 60.0,
          "deadline_s": 120.0}
DP_SKEW = 1.5                        # one encoder layer's weights x 1.5
DP_K2_PER_FORWARD = 24               # no pooler: ffn_1 and ffn_2 of 12 cells


def fl_weights(torch, net):
    """{structural name: CPU fp32 copy} of a block's tensors."""
    return {k: v.detach().float().cpu().clone()
            for k, v in net.collect_params().items()}


def fl_cpu_outputs(torch, mx, weights, ids, dtype=None, **kwargs):
    """The CPU forward (the plain versions; fp32, or cast to ``dtype``)
    of BERT-base with ``weights`` on ``ids``: a list of arrays, one per
    output."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    net = bert_12_768_12(use_decoder=False, **kwargs)
    net.load_dict({k: v.numpy() for k, v in weights.items()}, ctx=mx.cpu())
    if dtype is not None:
        net.cast(dtype)
    with torch.inference_mode():
        out = net(torch.from_numpy(ids))
    outs = [out] if isinstance(out, torch.Tensor) else list(out)
    return [o.float().numpy().astype(np.float64) for o in outs]


def fl_check(name, answers, refs, rtol):
    """Each (row, answer, ...) against output k of ``refs`` at that row,
    within ``rtol`` of the output's max |value|; returns the largest
    relative error."""
    import numpy as np
    worst = 0.0
    for k, ref in enumerate(refs):
        got = np.stack([np.asarray(a[1][k] if isinstance(a[1], (tuple,
                                                                list))
                                   else a[1], dtype=np.float64)
                        for a in answers])
        want = np.stack([ref[a[0]] for a in answers])
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"{name}: output {k} has shape {got.shape} (want "
                 f"{want.shape}) or is not finite")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        worst = max(worst, err / scale)
        if not err <= rtol * scale:
            fail(f"{name}: output {k} differs from the CPU run by {err} > "
                 f"{rtol} x {scale}")
    return worst


def fl_send(fleet, tenant, ids, rows, n_threads, errors=None):
    """``ids[rows]`` to ``tenant`` from ``n_threads`` threads, each
    submitting its share at once; returns [(row, answer, params_step)].
    Fails unless every request is answered (``errors`` collects the
    failures instead, when given)."""
    out, errs = [], []
    lock = threading.Lock()

    def client(part):
        for r in part:
            try:
                resp = fleet.submit(ids[r], tenant=tenant,
                                    deadline_ms=FL_DEADLINE_MS)
                value = resp.result(120)
            except Exception as exc:  # reported below, then fail
                errs.append(f"{tenant} row {r}: {exc!r}")
                continue
            with lock:
                out.append((r, value, resp.params_step))

    threads = [threading.Thread(target=client, args=(rows[k::n_threads],))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors is not None:
        errors.extend(errs)
    elif errs or len(out) != len(rows):
        fail(f"serve-fleet: {len(out)} of {len(rows)} {tenant} requests "
             f"answered; errors {errs[:3]}")
    return out


def phase_serve_fleet(torch, mx, card, ctx):
    """(k) Three full-width BERT-base tenants on one Fleet on ``ctx``,
    two hot at a time."""
    import shutil

    from mxnet_tpu_torch.diagnostics import journal
    shutil.rmtree(FL_ROOT, ignore_errors=True)
    os.makedirs(FL_ROOT)
    jpath = os.path.join(FL_ROOT, "journal.jsonl")
    journal.reset_journal(jpath)
    try:
        return _serve_fleet(torch, mx, card, ctx, jpath)
    finally:
        journal.reset_journal()
        shutil.rmtree(FL_ROOT, ignore_errors=True)
        torch.cuda.empty_cache()


def _serve_fleet(torch, mx, card, ctx, jpath):
    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.cached_graph import WARMUP_ITERS
    from mxnet_tpu_torch.resilience import atomic
    from mxnet_tpu_torch.serving import (Fleet, FleetConfig,
                                         TenantQuarantined, serving_report)
    t_phase = time.perf_counter()
    ids = np.random.RandomState(SEED + 23).randint(
        0, BERT_VOCAB, (FL_DISTINCT, BERT_SEQ)).astype(np.int32)
    fleet = Fleet(FleetConfig(
        max_batch=8, dtype="int32", max_hot_tenants=FL_HOT,
        tenant_breaker_k=FL_BREAKER_K, tenant_cooldown_s=FL_COOLDOWN_S,
        default_deadline_ms=FL_DEADLINE_MS, reload_poll_s=3600.0),
        ctx=ctx)
    weights, refs, nbytes, blocks = {}, {}, {}, {}
    for name, seed, dtype, slo in FL_TENANTS:
        net = seeded_bert(torch, mx, ctx, BERT_SEQ, (1,), seed=seed)
        weights[name] = fl_weights(torch, net)
        root = None
        if dtype == "float32":      # its own commit root, step 1
            root = os.path.join(FL_ROOT, name)
            pl_commit(root, 1, weights[name])
        else:
            # bf16 BERT-base is ~3e-2 of max |value| off its fp32 self on
            # the CPU too: the gate holds the card to the CPU's bf16 run
            # of the same function, the fp32 runs are printed beside it
            fp32_refs = {"the fp32 weights before the cast": fl_cpu_outputs(
                torch, mx, weights[name], ids)}
            amp.convert_hybrid_block(net, dtype)
            weights[name] = fl_weights(torch, net)
            fp32_refs["the cast weights in fp32"] = fl_cpu_outputs(
                torch, mx, weights[name], ids)
        nbytes[name] = sum(t.numel() * t.element_size()
                           for t in net.collect_params().values())
        blocks[name] = net
        fleet.add_tenant(name, block=net, ckpt_root=root, slo=slo)
        refs[name] = fl_cpu_outputs(
            torch, mx, weights[name], ids,
            dtype=None if dtype == "float32" else dtype)
    _sync(torch)
    fleet.start()
    log(f"serve-fleet (k): Fleet(max_hot_tenants={FL_HOT}, buckets 1/2/4/"
        f"8, int32 ids, S {BERT_SEQ}) on {card} with tenants "
        + ", ".join(f"{n} ({d}, SLO {s}, {nbytes[n]} parameter bytes)"
                    for n, _, d, s in FL_TENANTS)
        + "; bert_a and bert_b hot-reload from their own commit roots")

    # 1. the burst: rounds of one tenant each, so the LRU pages
    _sync(torch)
    before = fleet.stats()
    kernels.reset_launch_counts()
    answers = {n: [] for n, *_ in FL_TENANTS}
    t0 = time.perf_counter()
    for k, name in enumerate(FL_ROUNDS):
        rows = [(k * FL_PER_ROUND + i) % FL_DISTINCT
                for i in range(FL_PER_ROUND)]
        answers[name] += fl_send(fleet, name, ids, rows, FL_THREADS)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    after = fleet.stats()
    batches = after["batches"] - before["batches"]
    captures = after["cache"]["misses"] - before["cache"]["misses"]
    want_k2 = BERT_K2_PER_FORWARD * (batches + WARMUP_ITERS * captures)
    log(f"serve-fleet (k) burst: {len(FL_ROUNDS) * FL_PER_ROUND} requests "
        f"({FL_PER_ROUND} per round, rounds {list(FL_ROUNDS)}, "
        f"{FL_THREADS} threads) answered in {batches} batches with "
        f"{captures} graph captures, {wall:.2f} s wall on {card}; K2 "
        f"{launches['matmul_epilogue']} launches (= {BERT_K2_PER_FORWARD} "
        f"x ({batches} batch forwards + {WARMUP_ITERS} warm-up passes x "
        f"{captures} captures))")
    if launches["matmul_epilogue"] != want_k2 or any(
            n for k, n in launches.items() if k != "matmul_epilogue"):
        fail(f"serve-fleet: launches {launches}, want K2 {want_k2}")
    errs = {}
    for name, _, dtype, _ in FL_TENANTS:
        rtol = LOGIT_RTOL if dtype == "float32" else FL_BF16_RTOL
        errs[name] = fl_check(f"serve-fleet {name}", answers[name],
                              refs[name], rtol)
        steps = {s for _, _, s in answers[name]}
        extra = ""
        if dtype != "float32":
            extra = "".join(
                f", {fl_check(name, answers[name], ref, 1.0):.3e} "
                f"against {what} run in fp32 (not gated)"
                for what, ref in fp32_refs.items())
            own = fl_check(name, [(r, [o[r] for o in refs[name]])
                                  for r in range(FL_DISTINCT)],
                           fp32_refs["the cast weights in fp32"], 1.0)
            extra += (f"; the CPU's {dtype} run itself is {own:.3e} off "
                      "its fp32 run")
        log(f"serve-fleet (k): {name} ({dtype}) {len(answers[name])} "
            f"answers, max relative error {errs[name]:.3e} against its "
            f"weights run on the CPU in {dtype} (tolerance {rtol:g} of max "
            f"|value|){extra}, stamped {sorted(steps, key=str)}")
        if steps != ({1} if dtype == "float32" else {None}):
            fail(f"serve-fleet: {name} answers stamped {steps}")
    per_tenant = {}
    for rec in pl_events(jpath, "serving_batch"):
        per_tenant[rec["tenant"]] = per_tenant.get(rec["tenant"], 0) \
            + rec["batch"]
    if per_tenant != {n: len(a) for n, a in answers.items()}:
        fail(f"serve-fleet: batches per tenant {per_tenant}: a batch "
             "mixed tenants")

    # 2. paging: what each page-in cost and each page-out freed
    ins = pl_events(jpath, "tenant_page_in")
    outs = pl_events(jpath, "tenant_page_out")
    hot_exec = sorted(r["exec_ms"] for r in pl_events(jpath, "serving_batch")
                      if r["cache_hit"])
    for r in ins:
        log(f"serve-fleet (k) page-in {r['tenant']}: cost {r['cost_ms']} "
            f"ms (build, {r['bytes']} bytes host-to-device, reload, the "
            f"first batch's capture {r['capture_s']} s), evicted "
            f"{r['evicted']}, hot {r['hot']} on {card}")
    if len(ins) < 4:
        fail(f"serve-fleet: {len(ins)} page-ins, want >= 4")
    residual = []
    order = [r for r in pl_events(jpath, None)
             if r["kind"] in ("tenant_page_in", "tenant_page_out")]
    for i, r in enumerate(order):
        if r["kind"] != "tenant_page_out":
            continue
        # the page-in that evicted this tenant: its hot set is what
        # stays on the card after the page-out
        nxt = next(p for p in order[i:] if p["kind"] == "tenant_page_in")
        resident = r["allocated"] - sum(nbytes[n] for n in nxt["hot"])
        residual.append(resident)
        log(f"serve-fleet (k) page-out {r['tenant']}: {r['ms']} ms, "
            f"{r['bytes']} bytes to pinned host memory, "
            f"{r['freed_bytes']} bytes freed on the card "
            f"({r['freed_bytes'] / nbytes[r['tenant']]:.3f} of its "
            f"parameters); allocated after {r['allocated']} bytes, "
            f"{resident} beside the hot tenants' parameters {nxt['hot']} "
            f"on {card}")
        if r["freed_bytes"] < FL_FREED * nbytes[r["tenant"]]:
            fail(f"serve-fleet: a page-out of {r['tenant']} freed "
                 f"{r['freed_bytes']} of {nbytes[r['tenant']]} bytes")
    drift = [x - residual[0] for x in residual[1:]]
    if any(abs(d) > FL_LEAK_BYTES for d in drift):
        fail(f"serve-fleet: allocated memory beside the hot parameters "
             f"drifted by {drift} bytes across page cycles")
    p50 = hot_exec[len(hot_exec) // 2]
    p99 = hot_exec[min(int(math.ceil(0.99 * len(hot_exec))) - 1,
                       len(hot_exec) - 1)]
    log(f"serve-fleet (k): hot batches' exec_ms p50 {p50:.2f}, p99 "
        f"{p99:.2f} over {len(hot_exec)} batches, beside page-in costs "
        f"{[r['cost_ms'] for r in ins]} ms; residual drift {drift} bytes "
        f"(limit {FL_LEAK_BYTES}) on {card}")

    # 3. quarantine: bert_b's predictor fails at its seam, the others serve
    left = [FL_BREAKER_K]

    def poison(point, path=None, nbytes=None, size=None):
        if point == "serving_tenant" and path == "bert_b" and left[0] > 0:
            left[0] -= 1
            raise RuntimeError("bert_b's predictor poisoned")

    side, side_errs = {}, []

    def others():
        for name in ("bert_a", "bert_bf16"):
            side[name] = fl_send(fleet, name, ids, list(range(FL_DISTINCT)),
                                 2, errors=side_errs)

    prev = atomic.set_fault_hook(poison)
    bystander = threading.Thread(target=others)
    bystander.start()
    b_errors = []
    try:
        for r in range(FL_BREAKER_K):
            try:
                fleet.predict(ids[r], tenant="bert_b", timeout_s=120)
            except Exception as exc:   # the poisoned batches, expected
                b_errors.append(type(exc).__name__)
        try:
            fleet.predict(ids[0], tenant="bert_b", timeout_s=120)
            fail("serve-fleet: bert_b admitted while quarantined")
        except TenantQuarantined as exc:
            refused = (exc.tenant, exc.retryable)
    finally:
        atomic.set_fault_hook(prev)
        bystander.join(timeout=300)
    if side_errs:
        fail(f"serve-fleet: bystander tenants failed: {side_errs[:3]}")
    for name, got in side.items():
        fl_check(f"serve-fleet quarantine window {name}", got, refs[name],
                 LOGIT_RTOL if name == "bert_a" else FL_BF16_RTOL)
    time.sleep(FL_COOLDOWN_S)
    probe = fleet.predict(ids[1], tenant="bert_b", timeout_s=120)
    fl_check("serve-fleet probe bert_b", [(1, probe)], refs["bert_b"],
             LOGIT_RTOL)
    stats = fleet.tenant_stats()
    log(f"serve-fleet (k) quarantine: bert_b's {FL_BREAKER_K} poisoned "
        f"batches failed ({b_errors}), then admission refused it with "
        f"TenantQuarantined (tenant, retryable) = {refused}; meanwhile "
        f"bert_a and bert_bf16 answered {sum(map(len, side.values()))} "
        "requests, all within tolerance; after the "
        f"{FL_COOLDOWN_S:g} s cooldown one probe re-admitted it: state "
        f"{stats['bert_b']['state']}, readmissions "
        f"{stats['bert_b']['readmissions']}")
    if b_errors != ["RequestError"] * FL_BREAKER_K or \
            refused != ("bert_b", False) or \
            stats["bert_b"]["state"] != "admitted" or \
            stats["bert_b"]["readmissions"] != 1 or \
            any(stats[n]["quarantines"] for n in ("bert_a", "bert_bf16")):
        fail(f"serve-fleet: quarantine {b_errors}, {refused}, {stats}")

    # 4. a per-tenant reload: bert_a's root gets step 2
    step2 = {k: v * 1.1 if k.startswith(FL_SKEW_LAYER) else v
             for k, v in weights["bert_a"].items()}
    pl_commit(os.path.join(FL_ROOT, "bert_a"), 2, step2)
    ref2 = fl_cpu_outputs(torch, mx, step2, ids)
    fleet.reload_tenant("bert_a")
    t_end = time.monotonic() + 120
    while True:
        got = fl_send(fleet, "bert_a", ids, list(range(FL_DISTINCT)), 2)
        if all(s == 2 for _, _, s in got):
            break
        if time.monotonic() > t_end:
            fail("serve-fleet: bert_a never served step 2")
    err2 = fl_check("serve-fleet bert_a step 2", got, ref2, LOGIT_RTOL)
    b_steps = {s for _, _, s in fl_send(fleet, "bert_b", ids, [0, 1], 1)}
    log(f"serve-fleet (k) reload: bert_a serves step 2 (max relative error "
        f"{err2:.3e} against the CPU with step 2's weights); bert_b still "
        f"stamps {b_steps}")
    if b_steps != {1}:
        fail(f"serve-fleet: bert_b's stamp moved to {b_steps}")

    # 5. the reports
    text = fleet.metrics_text()
    stats = fleet.tenant_stats()
    fleet.stop()
    families = sorted({ln.split("{")[0] for ln in text.splitlines()
                       if ln.startswith("mxnet_tpu_serving_tenant")})
    rep = serving_report(jpath)["tenants"]
    counts = {n: (rep[n]["page_ins"], rep[n]["page_outs"],
                  sum(t["to"] == "quarantined"
                      for t in rep[n]["quarantine_trail"]))
              for n in stats}
    want = {n: (r["page_ins"], r["page_outs"], r["quarantines"])
            for n, r in stats.items()}
    log(f"serve-fleet (k): metrics_text families {families}; "
        f"serving_report (page-ins, page-outs, quarantines) {counts}, "
        f"tenant_stats {want}")
    if families != ["mxnet_tpu_serving_tenant_events",
                    "mxnet_tpu_serving_tenant_latency_ms",
                    "mxnet_tpu_serving_tenant_state"] or counts != want:
        fail("serve-fleet: the reports disagree with tenant_stats")
    del fleet, blocks
    seconds = time.perf_counter() - t_phase
    log(f"serve-fleet (k): {seconds:.1f} s on {card}")
    return {"launches": launches["matmul_epilogue"], "batches": batches,
            "captures": captures, "warmup": WARMUP_ITERS, "errs": errs,
            "page_in_ms": [r["cost_ms"] for r in ins],
            "capture_s": [r["capture_s"] for r in ins],
            "page_out_ms": [r["ms"] for r in outs],
            "freed": [r["freed_bytes"] for r in outs],
            "drift": drift, "exec_p50": p50, "exec_p99": p99,
            "seconds": seconds}


def dp_burst(router, ids, until, what):
    """Requests through ``router.call`` from DP_THREADS threads until
    ``until()``; every request answered or the phase fails. Returns
    [(row, value, replica, params_step)]."""
    recs, _ = pl_burst(router, ids, DP_THREADS, n_threads=DP_THREADS,
                       until=until, what=f"serve-deploy {what}")
    return [(r[0] % len(ids), r[1], r[2], r[3]) for r in recs]


def dp_check(what, recs, refs, steps):
    import numpy as np
    got = {r[3] for r in recs}
    if not got <= set(steps):
        fail(f"serve-deploy: {what}: answers stamped {got}, want {steps}")
    for step in sorted(got):
        rows = [(r[0], r[1]) for r in recs if r[3] == step]
        fl_check(f"serve-deploy {what} step {step}", rows, [refs[step]],
                 LOGIT_RTOL)
    return {s: sum(r[3] == s for r in recs) for s in sorted(got)}


def phase_serve_deploy(torch, mx, card, ctx):
    """(l) A canary deploy over two BERT-base replicas on ``ctx``."""
    import shutil

    from mxnet_tpu_torch.diagnostics import journal
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    os.makedirs(DP_ROOT)
    jpath = os.path.join(DP_ROOT, "journal.jsonl")
    journal.reset_journal(jpath)
    try:
        return _serve_deploy(torch, mx, card, ctx, jpath)
    finally:
        journal.reset_journal()
        shutil.rmtree(DP_ROOT, ignore_errors=True)
        torch.cuda.empty_cache()


def _serve_deploy(torch, mx, card, ctx, jpath):
    import numpy as np
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.serving import (DeployConfig, DeployController,
                                         DeployInProgress, ParamStore,
                                         PoolConfig, ReplicaPool, Router,
                                         RouterConfig, Server, ServerConfig)
    t_phase = time.perf_counter()
    dev = ctx.torch_device
    ckpt = os.path.join(DP_ROOT, "ckpt")
    # the encoder's sequence output alone: the router's mirror compares
    # one array per answer
    arch = {"use_pooler": False, "use_classifier": False}
    net = seeded_bert(torch, mx, ctx, BERT_SEQ, (1,), seed=SEED + 24,
                      **arch)
    good = fl_weights(torch, net)
    del net
    skewed = {k: v * DP_SKEW if k.startswith(FL_SKEW_LAYER) else v
              for k, v in good.items()}
    ids = np.random.RandomState(SEED + 24).randint(
        0, BERT_VOCAB, (FL_DISTINCT, BERT_SEQ)).astype(np.int32)
    ref_good = fl_cpu_outputs(torch, mx, good, ids, **arch)[0]
    refs = {1: ref_good, 2: ref_good,
            3: fl_cpu_outputs(torch, mx, skewed, ids, **arch)[0]}
    pl_commit(ckpt, 1, good)

    def factory():
        bert = bert_12_768_12(use_decoder=False, **arch)
        bert.initialize(mx.init.Normal(0.02), ctx=ctx,
                        generator=mx.random.generator(SEED, device=dev))
        with torch.inference_mode():
            bert(torch.zeros(1, BERT_SEQ, dtype=torch.int32, device=dev))
        return Server(bert, ServerConfig(
            max_batch=8, dtype="int32", aot_prewarm=((BERT_SEQ,),),
            reload_poll_s=-1.0), param_store=ParamStore(ckpt), ctx=ctx)

    pool = ReplicaPool(os.path.join(DP_ROOT, "pool"), PoolConfig(**PL_POOL))
    pool.add_local("r0", factory).add_local("r1", factory)
    pool.start()
    router = Router(pool, RouterConfig(retries=PL_RETRIES))
    try:
        return _deploy_runs(torch, card, pool, router, ckpt, ids, refs,
                            good, skewed, jpath, t_phase, kernels,
                            DeployConfig, DeployController,
                            DeployInProgress)
    finally:
        router.stop()
        pool.stop()


def _deploy_runs(torch, card, pool, router, ckpt, ids, refs, good, skewed,
                 jpath, t_phase, kernels, DeployConfig, DeployController,
                 DeployInProgress):
    import numpy as np
    servers = {rid: rep.server for rid, rep in pool.replicas.items()}
    # the mirror's tolerance: one sequence served from different batch
    # buckets on the two replicas differs by this much with equal weights
    diff, scale = 0.0, float(np.abs(refs[1]).max())
    for rid, srv in servers.items():
        preds = {k[0]: p for k, p in srv.cache.entries()}
        for r in range(FL_DISTINCT):
            rows = {}
            for b, p in preds.items():
                padded = np.zeros((b, BERT_SEQ), np.int32)
                padded[0] = ids[r]
                rows[b] = p(padded)[0][0][0]
            base = rows[min(rows)]
            diff = max([diff] + [float(np.abs(v - base).max())
                                 for v in rows.values()])
    atol = min(LOGIT_RTOL * scale, max(16.0 * diff, 1e-6 * scale))
    log(f"serve-deploy (l): two LocalReplicas of full-width BERT-base (the "
        f"encoder's sequence output, S {BERT_SEQ}, int32 ids, fp32, buckets "
        f"1/2/4/8 prewarmed) on {card} over one commit root; the same "
        f"sequences served from every bucket differ by at most {diff:.3e} "
        f"(max |value| {scale:.3e}), so the mirror compares with rtol 0, "
        f"atol {atol:.3e} (16x that, at most {LOGIT_RTOL:g} of max "
        "|value|, the serving gate)")
    cfg = DeployConfig(**DP_CFG, mirror_rtol=0.0, mirror_atol=atol)
    for b in (8, 4, 2, 1):
        pl_burst(router, ids, b, n_threads=1, what="serve-deploy warm")

    def deploy(step):
        """ctl.deploy(step) under load; returns (result, records)."""
        ctl = DeployController(pool, router, ckpt, cfg)
        box = {}
        th = threading.Thread(target=lambda: box.update(ctl.deploy(step)))
        th.start()
        recs = dp_burst(router, ids, lambda: not th.is_alive(),
                        f"deploy of step {step}")
        th.join()
        return box, recs

    # 1. a good step (the same values) is promoted
    pl_commit(ckpt, 2, good)
    refused = []

    def reload_mid_canary():
        pl_wait(lambda: pl_events(jpath, "canary_up"), "canary_up")
        try:
            pool.reload()
        except DeployInProgress as exc:
            refused.append(exc.op)

    watcher = threading.Thread(target=reload_mid_canary)
    watcher.start()
    kernels.reset_launch_counts()
    before = sum(s.stats()["batches"] for s in servers.values())
    res1, recs1 = deploy(2)
    launches = kernels.launch_counts()
    batches = sum(s.stats()["batches"] for s in servers.values()) - before
    watcher.join()
    stamps1 = dp_check("good deploy", recs1, refs, (1, 2))
    evals1 = pl_events(jpath, "gate_eval")
    steps = {s.id: s.params_step for s in pool.view()}
    log(f"serve-deploy (l) good deploy: {res1}; {len(recs1)} requests "
        f"answered, none lost, stamps {stamps1}; pool.reload() mid-canary "
        f"refused {refused}; gate evaluations "
        + "; ".join(f"{e['verdict']} canary p99 {e['canary_p99_ms']} / "
                    f"control p99 {e['control_p99_ms']} ms, mirrors "
                    f"{e['mirrors']} (mismatch {e['mirror_mismatch']})"
                    for e in evals1)
        + f"; promoted in {res1.get('deploy_ms')} ms on {card}; replicas "
        f"{steps}; K2 {launches['matmul_epilogue']} launches (= "
        f"{DP_K2_PER_FORWARD} x {batches})")
    if res1.get("result") != "promoted" or refused != ["reload"] or \
            set(steps.values()) != {2}:
        fail(f"serve-deploy: the good deploy: {res1}, {refused}, {steps}")
    if launches["matmul_epilogue"] != DP_K2_PER_FORWARD * batches or any(
            n for k, n in launches.items() if k != "matmul_epilogue"):
        fail(f"serve-deploy: launches {launches} for {batches} batches")

    # 2. a skewed step (CRC-valid, one layer x 1.5) is rolled back
    pl_commit(ckpt, 3, skewed)
    res2, recs2 = deploy(3)
    stamps2 = dp_check("skewed deploy", recs2, refs, (2, 3))
    canary = res2.get("canary", ["?"])[0]
    evals2 = pl_events(jpath, "gate_eval")[len(evals1):]
    steps = {s.id: s.params_step for s in pool.view()}
    pinned = (pool.replicas[canary]._pin,
              servers[canary].param_store.pinned_step)
    wrong = {r[2] for r in recs2 if r[3] == 3}
    log(f"serve-deploy (l) skewed deploy: {res2}; {len(recs2)} requests "
        f"answered, none lost, stamps {stamps2} (step 3 only from "
        f"{sorted(wrong)}); gate evaluations "
        + "; ".join(f"{e['verdict']} {e['reasons']} canary p99 "
                    f"{e['canary_p99_ms']} / control p99 "
                    f"{e['control_p99_ms']} ms, mirrors {e['mirrors']} "
                    f"(mismatch {e['mirror_mismatch']})" for e in evals2)
        + f"; rolled back in {res2.get('rollback_ms')} ms (deploy "
        f"{res2.get('deploy_ms')} ms) on {card}; replicas {steps}; canary "
        f"pins {pinned}")
    if res2.get("result") != "rolled_back" or res2.get("reason") != \
            "parity" or set(steps.values()) != {2} or pinned != (2, 2) \
            or not wrong <= {canary}:
        fail(f"serve-deploy: the skewed deploy: {res2}, {steps}, {pinned}")
    seconds = time.perf_counter() - t_phase
    log(f"serve-deploy (l): {seconds:.1f} s on {card}")
    return {"launches": launches["matmul_epilogue"], "batches": batches,
            "promote_ms": res1.get("deploy_ms"),
            "rollback_ms": res2.get("rollback_ms"),
            "rollback_deploy_ms": res2.get("deploy_ms"),
            "evals": (len(evals1), len(evals2)), "mirror_atol": atol,
            "bucket_diff": diff, "seconds": seconds}


def phase_kernel_bf16(torch, ce, me):
    """K1 and K2 in bfloat16 at this phase's shapes: the 48 epilogues of a
    ResNet-50 forward at batch 256 and the 24 of a BERT-base MLM training
    forward at batch 64, S 128 (ffn_1 bias + gelu, ffn_2 bias + dropout
    0.1), each against its plain version, with the bytes bound at 2-byte
    elements and, for ffn_2, torch.add(y, bias)."""
    log("kernel: conv_epilogue and matmul_epilogue in bfloat16 at the "
        "train-sharded shapes")
    per_shape = {}
    calls = resnet50_epilogues(SH_RN_BATCH)
    for name, shape, vectors, with_res in calls:
        key = (shape, vectors, with_res)
        if key not in per_shape:
            per_shape[key] = run_case(torch, ce, (
                name, shape, 1, vectors, with_res, "relu", torch.bfloat16))
    k1 = [per_shape[(shape, v, res)] for _, shape, v, res in calls]
    rows = SH_BERT["b"][0] * SH_BERT["b"][1]
    ffn1 = run_case_k2(torch, me, ("ffn_1.gelu", (rows, 3072), "col",
                                   "gelu", 0.0, torch.bfloat16))
    ffn2 = run_case_k2(torch, me, ("ffn_2.dropout", (rows, 768), "col",
                                   "identity", 0.1, torch.bfloat16),
                       library=True)
    out = {"k1": {"ms": sum(r["ms"] for r in k1),
                  "plain_ms": sum(r["plain_ms"] for r in k1),
                  "bound_ms": sum(r["bound_ms"] for r in k1),
                  "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                             for r in k1) else "operations",
                  "err": max(r["err"] for r in k1)},
           "k2": {"ms": 12 * (ffn1["ms"] + ffn2["ms"]),
                  "plain_ms": 12 * (ffn1["plain_ms"] + ffn2["plain_ms"]),
                  "bound_ms": 12 * (ffn1["bound_ms"] + ffn2["bound_ms"]),
                  "bound_by": "bytes" if ffn1["bound_by"] == ffn2[
                      "bound_by"] == "bytes" else "operations",
                  "library_ms": None,
                  "bias_add_ms": 12 * ffn2["library_ms"],
                  "bias_add_covers": "torch.add(y, bias) on the 12 ffn_2 "
                                     "shapes: the bias add alone, 4 of K2's 5 "
                                     "bytes per element, not K2's function",
                  "ms_dropout": 12 * ffn2["ms"],
                  "bytes": 12 * (k2_bytes((rows, 3072), 2, "col", False)
                                 + k2_bytes((rows, 768), 2, "col", True)),
                  "err": max(ffn1["err"], ffn2["err"])}}
    out["k2"]["bound_share"] = out["k2"]["bound_ms"] / out["k2"]["ms"]
    out["k2"]["gb_per_s"] = out["k2"]["bytes"] / (out["k2"]["ms"] * 1e-3) \
        / 1e9
    log(f"kernel: one ResNet-50 forward at batch {SH_RN_BATCH}, bfloat16, 48 "
        f"launches: kernel {out['k1']['ms']:.6f} ms, plain "
        f"{out['k1']['plain_ms']:.6f} ms, bound {out['k1']['bound_ms']:.6f} "
        f"ms (bytes at 3.35 TB/s)")
    log(f"kernel: one BERT-base MLM training forward at batch "
        f"{SH_BERT['b'][0]}, S {SH_BERT['b'][1]}, bfloat16, 24 launches: "
        f"kernel {out['k2']['ms']:.6f} ms, plain {out['k2']['plain_ms']:.6f} "
        f"ms, bound {out['k2']['bound_ms']:.6f} ms (bytes at 3.35 TB/s), "
        f"share {out['k2']['bound_share']:.3f}, "
        f"{out['k2']['gb_per_s']:.1f} GB/s over its "
        f"{out['k2']['bytes'] / 1e6:.3f} MB; the 12 ffn_2 launches "
        f"{out['k2']['ms_dropout']:.6f} ms beside torch.add(y, bias) "
        f"{out['k2']['bias_add_ms']:.6f} ms (the bias add alone, 4 of K2's 5 "
        "bytes per element: no PyTorch call computes K2's function)")
    return out


# -- phase 25: layers --------------------------------------------------------
LY_RTOL = 1e-5                       # card vs CPU, fp32, of max |value|


def ly_layers(mx):
    """name -> (factory of one layer of this slice, input shapes), at
    small shapes: every new nn and contrib.nn class and each LeakyReLU
    mode of the operator."""
    nn, cnn = mx.gluon.nn, mx.gluon.contrib.nn

    def lrelu(act_type):
        return nn.HybridLambda(lambda F, x: F.LeakyReLU(
            x, act_type=act_type, slope=0.3))

    def concurrent(block, first):
        block.add(first, nn.Activation("tanh"), cnn.Identity())
        return block

    return {
        "Conv1D": (lambda: nn.Conv1D(6, 3, strides=2, padding=1, dilation=2,
                                     groups=2), [(4, 4, 33)]),
        "Conv3D": (lambda: nn.Conv3D(8, (2, 3, 3), strides=(1, 2, 1),
                                     padding=1, activation="relu"),
                   [(2, 4, 6, 12, 10)]),
        "Conv1DTranspose": (lambda: nn.Conv1DTranspose(
            4, 3, strides=2, padding=1, output_padding=2, groups=2),
            [(4, 6, 17)]),
        "Conv2DTranspose": (lambda: nn.Conv2DTranspose(
            8, 4, strides=2, padding=1, output_padding=1, groups=2),
            [(4, 6, 9, 8)]),
        "Conv3DTranspose": (lambda: nn.Conv3DTranspose(
            4, 3, strides=2, padding=1, output_padding=1, groups=2,
            activation="tanh"), [(2, 4, 3, 4, 5)]),
        "MaxPool1D": (lambda: nn.MaxPool1D(3, 2, padding=1, ceil_mode=True),
                      [(4, 5, 30)]),
        "MaxPool3D": (lambda: nn.MaxPool3D(3, 2, ceil_mode=True),
                      [(2, 3, 8, 9, 10)]),
        "AvgPool1D": (lambda: nn.AvgPool1D(3, 2, padding=1, ceil_mode=True,
                                           count_include_pad=False),
                      [(4, 5, 30)]),
        "AvgPool3D": (lambda: nn.AvgPool3D(3, 2, padding=1, ceil_mode=True,
                                           count_include_pad=False),
                      [(2, 3, 8, 9, 10)]),
        "GlobalMaxPool1D": (lambda: nn.GlobalMaxPool1D(), [(4, 5, 30)]),
        "GlobalMaxPool2D": (lambda: nn.GlobalMaxPool2D(), [(4, 5, 9, 7)]),
        "GlobalMaxPool3D": (lambda: nn.GlobalMaxPool3D(),
                            [(2, 3, 4, 5, 6)]),
        "GlobalAvgPool1D": (lambda: nn.GlobalAvgPool1D(), [(4, 5, 30)]),
        "GlobalAvgPool3D": (lambda: nn.GlobalAvgPool3D(),
                            [(2, 3, 4, 5, 6)]),
        "ReflectionPad2D": (lambda: nn.ReflectionPad2D(3), [(2, 3, 9, 8)]),
        "GroupNorm": (lambda: nn.GroupNorm(num_groups=4), [(4, 8, 6, 5)]),
        "InstanceNorm": (lambda: nn.InstanceNorm(), [(4, 6, 7, 5)]),
        "SyncBatchNorm": (lambda: nn.SyncBatchNorm(momentum=0.8),
                          [(8, 6, 5, 4)]),
        "LeakyReLU": (lambda: nn.LeakyReLU(0.2), [(16, 33)]),
        "PReLU": (lambda: nn.PReLU(in_channels=5), [(4, 5, 9)]),
        "ELU": (lambda: nn.ELU(alpha=0.7), [(16, 33)]),
        "SELU": (lambda: nn.SELU(), [(16, 33)]),
        "Swish": (lambda: nn.Swish(beta=1.5), [(16, 33)]),
        "LeakyReLU op: rrelu": (lambda: lrelu("rrelu"), [(16, 33)]),
        "LeakyReLU op: gelu": (lambda: lrelu("gelu"), [(16, 33)]),
        "Lambda": (lambda: nn.Lambda("tanh"), [(16, 33)]),
        "HybridLambda": (lambda: nn.HybridLambda(
            lambda F, x: F.reshape(F.relu(x), (-1, 3, 0))), [(6, 4, 11)]),
        "HybridConcurrent": (lambda: concurrent(cnn.HybridConcurrent(
            axis=-1), nn.Dense(5, flatten=False)), [(4, 6, 7)]),
        "Concurrent": (lambda: concurrent(cnn.Concurrent(axis=1),
                                          nn.GroupNorm(num_groups=2)),
                       [(4, 6, 7)]),
    }


def ly_losses(mx):
    """name -> (factory of one loss, its inputs as numpy arrays): the ten
    losses of this slice (CTCLoss with lengths and with padded labels)."""
    import numpy as np
    loss = mx.gluon.loss
    rng = np.random.RandomState(SEED + 25)

    def randn(*shape):
        return rng.randn(*shape).astype(np.float32)

    def bits(*shape):
        return rng.randint(0, 2, shape).astype(np.float32)

    def probs(*shape):
        e = np.exp(randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    label = rng.randint(0, 9, (6, 5)).astype(np.float32)
    label[0, 3:] = -1                   # padded labels
    label[4, 1:] = -1
    return {
        "L1Loss": (lambda: loss.L1Loss(), [randn(16, 8), randn(16, 8)]),
        "SigmoidBinaryCrossEntropyLoss": (
            lambda: loss.SigmoidBinaryCrossEntropyLoss(),
            [randn(16, 8) * 3, bits(16, 8), None,
             np.abs(randn(8)) + 0.5]),
        "SigmoidBCE from_sigmoid": (
            lambda: loss.SigmoidBCELoss(from_sigmoid=True),
            [1 / (1 + np.exp(-randn(16, 8))), bits(16, 8)]),
        "KLDivLoss": (lambda: loss.KLDivLoss(from_logits=False),
                      [randn(16, 10), probs(16, 10)]),
        "HuberLoss": (lambda: loss.HuberLoss(rho=0.7),
                      [randn(16, 8), randn(16, 8)]),
        "HingeLoss": (lambda: loss.HingeLoss(),
                      [randn(16, 8), np.sign(randn(16, 8))]),
        "SquaredHingeLoss": (lambda: loss.SquaredHingeLoss(),
                             [randn(16, 8), np.sign(randn(16, 8))]),
        "LogisticLoss": (lambda: loss.LogisticLoss(label_format="binary"),
                         [randn(16, 8) * 2, bits(16, 8)]),
        "TripletLoss": (lambda: loss.TripletLoss(),
                        [randn(16, 8), randn(16, 8), randn(16, 8)]),
        "CosineEmbeddingLoss": (
            lambda: loss.CosineEmbeddingLoss(margin=0.2),
            [randn(16, 8), randn(16, 8), np.sign(randn(16))]),
        "CTCLoss NTC, lengths": (
            lambda: loss.CTCLoss(),
            [randn(6, 20, 10), label,
             np.array([20, 17, 12, 20, 9, 15], np.float32),
             np.array([3, 5, 4, 2, 1, 5], np.float32)]),
        "CTCLoss TNC, padded labels": (
            lambda: loss.CTCLoss(layout="TNC", label_layout="TN"),
            [randn(20, 6, 10), label.T.copy()]),
    }


def ly_run(torch, mx, block, inputs, dev, heads=None):
    """``block`` under record() on ``inputs`` put on ``dev`` (the first
    float inputs require grad; None is passed through), then backward
    from ``heads`` (seeded normals of the outputs' shapes when None).
    Returns (quantities, heads): every output, each input's gradient,
    every parameter and running statistic and each parameter's
    gradient, as numpy arrays."""
    import numpy as np
    xs = [None if a is None else torch.from_numpy(a) for a in inputs]
    if dev is not None:
        xs = [None if x is None else x.to(dev) for x in xs]
    for x in xs[:1]:
        x.requires_grad_()
    with mx.autograd.record():
        outs = block(*xs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if heads is None:
        rng = np.random.RandomState(SEED + 26)
        heads = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    torch.autograd.backward(outs, [torch.from_numpy(h).to(dev)
                                   for h in heads])
    q = {f"out{i}": o.detach().cpu().numpy() for i, o in enumerate(outs)}
    q["dx0"] = xs[0].grad.cpu().numpy()
    for name, t in block.collect_params().items():
        q[name] = t.detach().cpu().numpy()
        if t.grad is not None:
            q[f"grad:{name}"] = t.grad.cpu().numpy()
    return q, heads


def ly_compare(what, got, want, tol=LY_RTOL):
    """Worst relative difference of ``got`` from ``want`` (each quantity
    of max |value|; an all-zero one exactly); fails past ``tol``."""
    import numpy as np
    if sorted(got) != sorted(want):
        fail(f"layers: {what}: card quantities {sorted(got)} vs CPU "
             f"{sorted(want)}")
    worst, where = 0.0, None
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or not np.isfinite(g).all():
            fail(f"layers: {what}: {key} is {g.shape}, not finite or not "
                 f"the CPU's {w.shape}")
        scale = float(np.abs(w).max()) if w.size else 0.0
        err = float(np.abs(g - w).max()) if w.size else 0.0
        rel = err / scale if scale else (0.0 if err == 0 else math.inf)
        if rel >= worst:
            worst, where = rel, key
    if not worst <= tol:
        fail(f"layers: {what}: {where} differs from the CPU by {worst} of "
             f"max |value| > {tol}")
    return worst, where


def ly_pair(torch, mx, make, shapes, ctx):
    """The same layer on the CPU (seeded Xavier, BatchNorm and PReLU
    parameters drawn from SEED) and on ``ctx`` (its state loaded)."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    inputs = [rng.randn(*s).astype(np.float32) for s in shapes]
    cpu = make()
    cpu.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                   generator=mx.random.generator(SEED))
    with torch.no_grad():               # parameters autograd may save
        cpu(*[torch.from_numpy(a) for a in inputs])
    state = {}
    for name, t in cpu.collect_params().items():
        if name.endswith(("gamma", "running_var", "alpha")):
            state[name] = (rng.rand(*t.shape) + 0.5).astype(np.float32)
        else:
            state[name] = t.detach().numpy().copy()
    cpu.load_dict(state)
    card = make()
    card.load_dict(state, ctx=ctx)
    return cpu, card, inputs


def ly_examples(torch, mx, ctx):
    """examples/train_dcgan.py's generator and discriminator and
    examples/train_vae.py's VAE, built as the examples build them, one
    Adam step each (lr 2e-3; beta1 0.5 for DCGAN) through gluon.Trainer
    on the card and on the CPU from the same weights and batch: the
    losses and every gradient within 1e-5 of max |value|; then the CPU's
    Trainer steps from the card's gradients, and the weights after the
    step agree within 1e-5 (Adam's first step, lr * g / (|g| + eps),
    turns a gradient near eps's size into a step that two devices'
    rounding of g moves by a share of lr)."""
    import numpy as np
    nn, F = mx.gluon.nn, mx.nd
    rng = np.random.RandomState(SEED + 27)
    batch, nz = 32, 16

    def generator():
        net = nn.HybridSequential()
        net.add(nn.Dense(16 * 2 * 4 * 4, use_bias=False),
                nn.HybridLambda(lambda F, x: F.reshape(x, (-1, 32, 4, 4))),
                nn.Conv2DTranspose(16, 4, strides=2, padding=1,
                                   use_bias=False),
                nn.Activation("relu"),
                nn.Conv2DTranspose(1, 4, strides=2, padding=1,
                                   use_bias=False),
                nn.Activation("tanh"))
        return net

    def discriminator():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(16, 4, strides=2, padding=1), nn.LeakyReLU(0.2),
                nn.Conv2D(32, 4, strides=2, padding=1), nn.LeakyReLU(0.2),
                nn.Dense(1))
        return net

    class VAE(mx.gluon.HybridBlock):
        def __init__(self, nz=8, nf=16):
            super().__init__()
            self._nz = nz
            self.enc = nn.HybridSequential()
            self.enc.add(nn.Conv2D(nf, 4, strides=2, padding=1),
                         nn.Activation("relu"),
                         nn.Conv2D(nf * 2, 4, strides=2, padding=1),
                         nn.Activation("relu"), nn.Dense(2 * nz))
            self.dec = nn.HybridSequential()
            self.dec.add(nn.Dense(nf * 2 * 4 * 4, activation="relu"),
                         nn.HybridLambda(
                             lambda F, x: F.reshape(x, (-1, nf * 2, 4, 4))),
                         nn.Conv2DTranspose(nf, 4, strides=2, padding=1),
                         nn.Activation("relu"),
                         nn.Conv2DTranspose(1, 4, strides=2, padding=1),
                         nn.Activation("tanh"))

        def forward(self, x, eps):
            h = self.enc(x)
            mu = F.slice_axis(h, axis=1, begin=0, end=self._nz)
            logvar = F.slice_axis(h, axis=1, begin=self._nz,
                                  end=2 * self._nz)
            return self.dec(mu + F.exp(0.5 * logvar) * eps), mu, logvar

    real = np.tanh(rng.randn(batch, 1, 16, 16)).astype(np.float32)
    z = rng.randn(batch, nz).astype(np.float32)
    eps = rng.randn(batch, 8).astype(np.float32)
    bce = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones, zeros = np.ones(batch, np.float32), np.zeros(batch, np.float32)

    def d_loss(nets, t):
        gen, dis = nets
        fake = gen(t(z)).detach()
        return (bce(dis(t(real)).reshape(-1), t(ones))
                + bce(dis(fake).reshape(-1), t(zeros))).mean()

    def g_loss(nets, t):
        gen, dis = nets
        return bce(dis(gen(t(z))).reshape(-1), t(ones)).mean()

    def vae_loss(nets, t):
        x = t(real)
        xh, mu, logvar = nets[0](x, t(eps))
        kl = (-0.5 * (1 + logvar - mu * mu - torch.exp(logvar))).sum(
            axis=1).mean()
        return ((xh - x) ** 2).mean() + 5e-3 * kl

    def build(makers, shapes):
        """The nets on the CPU (seeded Xavier) and the same on ``ctx``
        (their state loaded into fresh blocks there)."""
        cpu = []
        for make, shape in zip(makers, shapes):
            net = make()
            net.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                           generator=mx.random.generator(SEED))
            with torch.no_grad():
                net(*[torch.zeros(s) for s in shape])
            cpu.append(net)
        card = []
        for make, net in zip(makers, cpu):
            card.append(make())
            card[-1].load_dict({k: v.detach().numpy() for k, v in
                                net.collect_params().items()}, ctx=ctx)
        return card, cpu

    cases = (("dcgan", (generator, discriminator),
              ((batch, nz),), ((batch, 1, 16, 16),),
              (("discriminator", 1, d_loss, {"beta1": 0.5}),
               ("generator", 0, g_loss, {"beta1": 0.5}))),
             ("vae", (VAE,), ((batch, 1, 16, 16), (batch, 8)), None,
              (("vae", 0, vae_loss, {}),)))
    worst = 0.0
    for name, makers, shape0, shape1, steps in cases:
        shapes = (shape0,) if shape1 is None else (shape0, shape1)
        card, cpu = build(makers, shapes)
        for what, which, loss_fn, opt in steps:
            opt = {"learning_rate": 2e-3, **opt}
            q = {}
            for nets, dev in ((card, ctx.torch_device), (cpu, None)):
                def t(a, dev=dev):
                    x = torch.from_numpy(a)
                    return x if dev is None else x.to(dev)
                for n in nets:
                    for p in n.collect_params().values():
                        p.grad = None
                with mx.autograd.record():
                    loss = loss_fn(nets, t)
                mx.autograd.backward(loss)
                params = nets[which].collect_params()
                q[dev is None] = {"loss": loss.detach().cpu().numpy(), **{
                    f"grad:{k}": p.grad.cpu().numpy()
                    for k, p in params.items() if p.grad is not None}}
            rel, key = ly_compare(f"{name} {what} step's gradients",
                                  q[False], q[True])
            worst = max(worst, rel)
            with torch.no_grad():
                for (k, tp), cp in zip(card[which].collect_params().items(),
                                       cpu[which].collect_params().values()):
                    if tp.grad is not None:
                        cp.grad.copy_(tp.grad.cpu())
            for nets in (card, cpu):
                mx.gluon.Trainer(nets[which].collect_params(), "adam",
                                 opt).step(batch)
            after = [{k: v.detach().cpu().numpy() for k, v in
                      nets[which].collect_params().items()}
                     for nets in (card, cpu)]
            rel_w, key_w = ly_compare(f"{name} {what} Adam step",
                                      after[0], after[1])
            worst = max(worst, rel_w)
            log(f"layers: {name} {what}: loss {float(q[False]['loss']):.6f}"
                f" (CPU {float(q[True]['loss']):.6f}); gradients worst "
                f"{rel:.3e} ({key}), weights after one Adam step (the CPU "
                f"given the card's gradients) worst {rel_w:.3e} ({key_w})")
    return worst


def phase_layers(torch, mx, card, ctx):
    """Every layer class and loss of this slice on ``ctx`` against the
    same module on the CPU (fp32, TF32 off, cuDNN deterministic); the
    DCGAN and VAE examples' blocks one Adam step each; clip_global_norm
    on device tensors with its host reads counted."""
    import numpy as np
    dev = ctx.torch_device
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    worst = {}
    try:
        for name, (make, shapes) in ly_layers(mx).items():
            cpu, card_block, inputs = ly_pair(torch, mx, make, shapes, ctx)
            want, heads = ly_run(torch, mx, cpu, inputs, None)
            got, _ = ly_run(torch, mx, card_block, inputs, dev, heads)
            worst[name] = ly_compare(name, got, want)
        for name, (make, inputs) in ly_losses(mx).items():
            want, heads = ly_run(torch, mx, make(), inputs, None)
            got, _ = ly_run(torch, mx, make(), inputs, dev, heads)
            worst[name] = ly_compare(name, got, want)
        for name, (rel, key) in worst.items():
            log(f"layers: {name}: card vs CPU worst {rel:.3e} of max |value|"
                f" ({key}; tolerance {LY_RTOL:g})")
        worst["examples"] = (ly_examples(torch, mx, ctx), "")
    finally:
        torch.backends.cudnn.deterministic = old
    # clip_global_norm on device tensors: one host read with
    # check_isfinite, none without
    rng = np.random.RandomState(SEED + 28)
    arrays = [rng.randn(*s).astype(np.float32)
              for s in ((512, 256), (4096,), (64, 3, 7, 7))]
    clip = {}
    for check in (True, False):
        on_card = [torch.from_numpy(a.copy()).to(dev) for a in arrays]
        on_cpu = [torch.from_numpy(a.copy()) for a in arrays]
        box = []
        syncs, _ = tr_syncs(torch, lambda: box.append(
            mx.gluon.utils.clip_global_norm(on_card, 1.0,
                                            check_isfinite=check)))
        want = mx.gluon.utils.clip_global_norm(on_cpu, 1.0,
                                               check_isfinite=check)
        got = box[0]
        if check != isinstance(got, float) or syncs != (1 if check else 0):
            fail(f"layers: clip_global_norm(check_isfinite={check}) made "
                 f"{syncs} host reads and returned {type(got)}")
        rel, key = ly_compare(
            f"clip_global_norm(check_isfinite={check})",
            {"norm": np.float32(float(got)),
             **{f"a{i}": t.cpu().numpy() for i, t in enumerate(on_card)}},
            {"norm": np.float32(float(want)),
             **{f"a{i}": t.numpy() for i, t in enumerate(on_cpu)}})
        clip[check] = syncs
        log(f"layers: clip_global_norm(check_isfinite={check}) on the card: "
            f"norm {float(got):.6f} (CPU {float(want):.6f}), {syncs} host "
            f"read(s), scaled arrays worst {rel:.3e} ({key})")
    return {"worst": max(r for r, _ in worst.values()),
            "cases": len(worst), "clip_syncs": clip}


# -- phase 26: serve-zoo -----------------------------------------------------
SZ_MODELS = (("resnet50_v2", 224, 0), ("vgg16", 224, 2), ("alexnet", 224, 2),
             ("densenet121", 224, 0), ("mobilenetv2_1.0", 224, 0),
             ("squeezenet1.1", 224, 0), ("inceptionv3", 299, 0))
SZ_REQUESTS = 16
SZ_CHECKED = 2                       # served requests held against the CPU
SZ_LEAK_BYTES = 64 << 20             # memory left after a model is freed


def sz_profile(torch, server, x, k2):
    """The graphed batch-8 forward of the served model: its replay's wall
    time (host clock around the replay and a synchronize, median of 10)
    and device span (CUDA events around 10 back-to-back replays, the
    mean), and one profiled replay's kernel time, launches, busy share and top
    kernels. CUPTI has dropped a replay's records late in a long run
    (PROFILE_TRIES): a profile whose kernels sum to less than half the
    event span is taken again."""
    from torch.profiler import ProfilerActivity, profile
    key = (x.shape[0], tuple(x.shape[1:]), x.dtype.str)
    pred = dict(server.cache.entries())[key]
    pred.replay(torch.from_numpy(x).to(server.device))
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.replay()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall, span = _median(walls), event_ms(torch, pred.replay, 10)

    def measure():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            pred.replay()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}

    def complete(dev):
        return sum(ms for _, ms in dev.values()) >= 0.5 * span \
            and _kernel_count(dev, "matmul_epilogue") == k2

    dev = profiled("serve-zoo graphed forward", measure, complete)
    device_ms = sum(ms for _, ms in dev.values())
    k2_seen = _kernel_count(dev, "matmul_epilogue")
    log(f"serve-zoo: graphed batch-8 forward {wall:.3f} ms wall, {span:.3f}"
        f" ms on the device between CUDA events (10 replays); "
        f"one profiled replay: kernels {device_ms:.3f} ms "
        f"({sum(c for c, _ in dev.values()):.0f} launches), busy "
        f"{device_ms / wall:.3f}; matmul_epilogue {k2_seen} launches"
        + ("" if complete(dev) else "; the profiler dropped records"))
    for name, (c, ms) in sorted(dev.items(), key=lambda kv: -kv[1][1])[:5]:
        log(f"  {ms:9.4f} ms {c:5.0f}x  {name[:90]}")
    if dev and k2_seen != k2:
        fail(f"serve-zoo: the profiler saw {k2_seen} matmul_epilogue "
             f"launches in a graphed forward, want {k2}")
    return {"wall_ms": wall, "event_ms": span, "device_ms": device_ms,
            "busy": device_ms / wall}


def sz_allocated(torch):
    """Device bytes allocated once garbage is collected and PyTorch's
    cached cuBLAS workspaces are released: cuBLAS keeps one 32 MiB
    workspace per (thread, stream) it ran on for the process's life, so
    a server's first worker thread and the capture warm-up stream would
    read as a model that was not freed."""
    import gc
    gc.collect()
    _sync(torch)
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def sz_model(torch, mx, card, ctx, name, size, k2):
    """One full-width model behind the Server on ``ctx``, then freed."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.serving import Server, ServerConfig
    dev = ctx.torch_device
    base = sz_allocated(torch)
    torch.cuda.reset_peak_memory_stats()
    net = get_model(name, classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    with torch.inference_mode():
        net(torch.zeros(1, 3, size, size, device=dev))
    rng = np.random.RandomState(SEED)
    params = {}
    for key, t in net.collect_params().items():
        shape = tuple(t.shape)
        if key.endswith(("running_mean", "beta")):
            params[key] = rng.randn(*shape).astype(np.float32) * 0.1
        elif key.endswith(("running_var", "gamma")):
            params[key] = rng.rand(*shape).astype(np.float32) + 0.5
        else:
            params[key] = t.detach().cpu().numpy()
    net.load_dict(params)
    images = rng.randn(SZ_REQUESTS, 3, size, size).astype(np.float32)
    log(f"serve-zoo {name}: {size}x{size}x3, 1000 classes, "
        f"{sum(v.size for v in params.values())} parameters and statistics,"
        f" fp32, buckets 1/2/4/8 captured at start()")
    server = Server(net, ServerConfig(max_batch=BATCH,
                                      aot_prewarm=((3, size, size),)),
                    ctx=ctx).start()
    graphs = report_prewarm(server, card)
    per_forward = {"conv_epilogue": 0, "matmul_epilogue": k2}
    results, launches, stats = serve_burst(
        torch, server, images, per_forward, card, "images",
        n_requests=SZ_REQUESTS)
    stray = {k: n for k, n in launches.items()
             if k not in per_forward and n}
    if stray:
        fail(f"serve-zoo {name}: kernels off the path launched: {stray}")
    graph_rel = graphed_vs_eager(torch, server, net, images[:BATCH],
                                 ("logits",))
    prof = sz_profile(torch, server, images[:BATCH], k2)
    peak = torch.cuda.max_memory_allocated()
    cpu_net = get_model(name, classes=1000)
    cpu_net.load_dict(params, ctx=mx.cpu())
    with torch.inference_mode():
        ref = cpu_net(torch.from_numpy(images[:SZ_CHECKED])).numpy()
    check_against_cpu(f"{name} logits of requests 0-{SZ_CHECKED - 1}",
                      np.stack(results[:SZ_CHECKED]), ref)
    server.cache.clear()
    del server, net, cpu_net
    left = sz_allocated(torch) - base
    log(f"serve-zoo {name}: peak device memory {peak / 2**30:.3f} GiB; "
        f"after the model, its server and its graphs are freed "
        f"{left / 2**20:+.1f} MiB allocated against before (cuBLAS "
        "workspaces cleared both times)")
    if left > SZ_LEAK_BYTES:
        fail(f"serve-zoo {name}: {left} bytes still allocated after the "
             "model was freed")
    return {"launches": launches, "graphs": graphs, "graph_rel": graph_rel,
            "profile": prof, "peak_bytes": peak, "left_bytes": left,
            **stats}


def phase_serve_zoo(torch, mx, card, ctx):
    """One full-width representative of each vision family behind the
    Server on ``ctx``, one after the other."""
    out = {}
    for name, size, k2 in SZ_MODELS:
        t0 = time.perf_counter()
        out[name] = sz_model(torch, mx, card, ctx, name, size, k2)
        log(f"serve-zoo {name}: {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 27: train-zoo -----------------------------------------------------
TZ_NETWORKS = {                       # network -> K2 launches per step
    "mobilenetv2_1.0": {},
    "vgg16_bn": {"matmul_epilogue": 2},
}
TZ_GATE = {                           # gated weights, BatchNorm statistics
    "mobilenetv2_1.0": (
        ("features.0.weight", "features.3.out.3.weight",
         "features.10.out.4.gamma", "features.20.weight", "output.0.weight"),
        ("features.1.running_mean", "features.1.running_var",
         "features.19.out.7.running_mean", "features.19.out.7.running_var")),
    "vgg16_bn": (
        ("features.0.weight", "features.24.weight", "features.35.gamma",
         "features.44.weight", "features.46.bias", "output.weight"),
        ("features.1.running_mean", "features.1.running_var",
         "features.41.running_mean", "features.41.running_var")),
}


def tz_trainer(torch, mx, ctx, name, dtype, state=None):
    """examples/train_imagenet.py's trainer for ``--network name``: 1000
    classes, Xavier from SEED (or ``state``), SGD lr 0.1 momentum 0.9 wd
    1e-4 on the {"data": 1, "model": 1} mesh."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    net = get_model(name, classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    if state is not None:
        net.load_dict(state)
    trainer = mx.parallel.ShardedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        optimizer_params=dict(RN_SGD), mesh=sh_mesh(mx, ctx),
        compute_dtype=dtype)
    return net, trainer


def tz_fp32(torch, mx, ctx, name, init, batch):
    """The bf16 trainer and the same trainer in fp32 (compute_dtype
    None), each from ``init`` for 3 eager steps on ``batch``, the fp32
    steps replaying the bf16 steps' dropout bits: the losses within
    SH_LOSS_RTOL. Eager, as graphed-vs-eager is gated bit for bit
    apart: vgg16_bn's fp32 step graph at batch 256 would not fit beside
    its pool (51 GiB for the bf16 step on the H100)."""
    runs = {}
    bits = None
    for dtype in ("bfloat16", None):
        mx.random.seed(SEED)
        _, trainer = tz_trainer(torch, mx, ctx, name, dtype, init)
        trainer._backend = None
        losses, times = [], []
        with mx.random.bits_tape(replay=bits) as tape:
            for _ in range(3):
                t0 = time.perf_counter()
                losses.append(float(trainer.step(*batch)))
                times.append((time.perf_counter() - t0) * 1e3)
        bits = bits if bits is not None else [b.clone() for b in tape.drawn]
        runs[dtype] = (losses, times)
        sh_release(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
    (bf16, bf16_ms), (fp32, fp32_ms) = runs["bfloat16"], runs[None]
    rel = [abs(a - b) / abs(b) for a, b in zip(bf16, fp32)]
    log(f"train-zoo {name}: eager fp32 losses {[round(v, 6) for v in fp32]}"
        f" vs eager bf16 {[round(v, 6) for v in bf16]} ({len(bits)} dropout "
        f"draws replayed): relative {[round(r, 5) for r in rel]} (tolerance "
        f"{SH_LOSS_RTOL}); eager step ms fp32 "
        f"{[round(t, 3) for t in fp32_ms]}, bf16 "
        f"{[round(t, 3) for t in bf16_ms]}")
    if max(rel) > SH_LOSS_RTOL:
        fail(f"train-zoo {name}: bf16 losses differ from fp32 ones by "
             f"{max(rel)} > {SH_LOSS_RTOL}")
    return {"losses": fp32, "bf16_losses": bf16, "rel": max(rel),
            "eager_ms": fp32_ms}


def phase_train_zoo(torch, mx, card, ctx):
    """examples/train_imagenet.py's configuration (batch 256, 224x224,
    the RandomState(0) batch) for --network mobilenetv2_1.0 and vgg16_bn
    through ShardedTrainer(compute_dtype="bfloat16"), gated as phase 15
    (a)."""
    import numpy as np
    dev = ctx.torch_device
    torch.cuda.empty_cache()
    rng = np.random.RandomState(0)      # train_imagenet.py's synthetic batch
    x = rng.randn(SH_RN_BATCH, 3, RN_SIZE, RN_SIZE).astype(np.float32)
    y = rng.randint(0, 1000, (SH_RN_BATCH,))
    batch = (torch.from_numpy(x).to(dev),
             torch.from_numpy(y.astype(np.int32)).to(dev))
    del x
    out = {}
    for name, per_step in TZ_NETWORKS.items():
        t0 = time.perf_counter()
        net, trainer = tz_trainer(torch, mx, ctx, name, "bfloat16")
        trainer.prepare(batch[0])
        init = {k: v.detach().cpu().numpy().copy()
                for k, v in net.collect_params().items()}
        log(f"train-zoo {name}: batch {SH_RN_BATCH}, {RN_SIZE}x{RN_SIZE}, "
            f"bf16 compute, fp32 masters, SGD lr "
            f"{RN_SGD['learning_rate']:g} momentum {RN_SGD['momentum']:g} "
            f"wd {RN_SGD['wd']:g}, mesh "
            f"{mx.parallel.mesh_signature(trainer.mesh)}")
        res = sh_train(torch, mx, name, trainer, batch, SH_RN_STEPS,
                       per_step, "images", SH_RN_BATCH, card)
        params, stats = TZ_GATE[name]
        res["graph_rel"], res["graph_equal"] = sh_graph_vs_eager(
            torch, mx, trainer, batch, params + stats, deterministic=True)
        res["gate_rel"] = sh_card_vs_cpu(
            torch, mx, trainer,
            lambda state, name=name: tz_trainer(torch, mx, mx.cpu(), name,
                                                "bfloat16", state)[1],
            [b[:1] for b in batch], params, stats, resnet=True, pools=True,
            convs=True)
        sh_release(torch, trainer)
        del net, trainer
        torch.cuda.empty_cache()
        res["fp32"] = tz_fp32(torch, mx, ctx, name, init, batch)
        out[name] = res
        del init
        torch.cuda.empty_cache()
        log(f"train-zoo {name}: {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 28: nd ------------------------------------------------------------
ND_SEQ = 4096                        # (b): BERT-base's long-context rung
ND_FFN = (1024, 3072)                # (b): BERT-base's ffn_1 output rows
ND_STAGE = (8, 64, 112, 112)         # (b): ResNet-50's first stage, batch 8
ND_DCGAN_STEPS = 200                 # examples/train_dcgan.py's default
ND_VAE_STEPS = 400                   # examples/train_vae.py's default
ND_EX_BATCH = 32                     # both examples' default batch


def nd_ops_card_vs_cpu(torch, mx, ctx):
    """(a) Every registered operator through its ``mx.nd`` wrapper on
    ``ctx`` against the same call on the CPU, the inputs and tolerances
    of tools/nd_op_cases.py (the CPU tests' table), TF32 off; the
    samplers by their moments on the card (the thresholds of
    tests/test_random_samplers.py)."""
    import numpy as np
    from mxnet_tpu_torch.ops import registry
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import nd_op_cases as cases
    nd = mx.nd
    worst, n_ops = {}, 0
    training = {"BatchNorm", "_contrib_BatchNormWithReLU"}
    for name in registry.list_ops():
        p = registry.get(name).name
        if p in cases.RANDOM or p == "Custom":    # Custom: phase 29 (d)
            continue
        make, params, tol = cases.spec(p)
        inputs = make(cases.rng_for(p))
        outs = []
        for dev in (ctx, mx.cpu()):
            arrays = [nd.array(a, ctx=dev) for a in inputs]
            scope = mx.autograd.train_mode() if p in training \
                else contextlib.nullcontext()
            with scope:
                out = cases.nd_fn(nd, name)(*arrays, **params)
            out = out if isinstance(out, list) else [out]
            if dev is ctx and any(o.ctx != ctx for o in out):
                fail(f"nd: {name} left {ctx}")
            outs.append([o.asnumpy() if o.dtype != torch.bfloat16 else
                         ("bfloat16", o.asnumpy()) for o in out])
        for g, w in zip(*outs):
            if isinstance(g, tuple):
                g, w = g[1], w[1]
            try:
                cases.check(g, w, tol, name)
            except AssertionError as e:
                fail(f"nd: {name} on the card vs the CPU, tolerance "
                     f"{tol}: {str(e)[:400]}")
            if g.size and g.dtype.kind == "f":
                scale = max(float(np.nanmax(np.abs(w))), 1e-30)
                err = float(np.nanmax(np.abs(g.astype(np.float64) - w)))
                key = str(tol)
                worst[key] = max(worst.get(key, 0.0), err / scale)
        n_ops += 1
    moments = {}
    mx.random.seed(SEED)
    for name in sorted(cases.SAMPLER_MOMENTS):
        x = cases.draw_sampler(nd, name, ctx)
        if x.ctx != ctx:
            fail(f"nd: sampler {name} drew on {x.ctx}")
        ok, mean, var = cases.moments_ok(name, x.asnumpy())
        if not ok:
            fail(f"nd: sampler {name} on the card: mean {mean}, var {var} "
                 f"outside its thresholds")
        moments[name] = (mean, var)
    alpha = nd.array(np.float32([[1, 2, 3]]), ctx=ctx)
    d = nd.random.sample_dirichlet(alpha, shape=(500,)).asnumpy()
    if d.shape != (1, 500, 3) or not np.allclose(d.sum(-1), 1, atol=1e-5):
        fail("nd: sample_dirichlet on the card")
    perm = nd.random.shuffle(nd.arange(64, ctx=ctx)).asnumpy()
    if sorted(perm.tolist()) != list(range(64)):
        fail("nd: shuffle on the card is not a permutation")
    log(f"nd (a): {n_ops} operator names on {ctx} vs the CPU, every one "
        f"within its tolerance; worst share of max |value| per class "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()))
        + f"; {len(moments)} samplers' moments on the card within their "
        "thresholds, dirichlet and shuffle supported")
    return {"ops": n_ops, "worst": worst, "moments": moments}


def _nd_counted(torch, mx, fn):
    """(fn(), launch counts of the kernels during it)."""
    _sync(torch)
    mx.kernels.reset_launch_counts()
    out = fn()
    _sync(torch)
    return out, {k: v for k, v in mx.kernels.launch_counts().items() if v}


def nd_kernels_full_width(torch, mx, ctx):
    """(b) The kernel-bearing operators through ``mx.nd`` at full width,
    each output bit-equal to the port's ``ops`` call on the same inputs,
    with its kernel's launches: flash_attention at BERT-base S 4096 (fp32
    and bf16, forward and the backward under record()),
    matmul_epilogue on ffn_1's output with dropout 0.1 (training, the
    same seeded bits), BatchNorm(act_type="relu") and conv_epilogue at
    ResNet-50's first stage."""
    nd, ops = mx.nd, mx.ops
    dev = ctx.torch_device
    gen = mx.random.generator(SEED + 28, dev)
    launches = {}

    def equal(what, a, b):
        a = a.handle if isinstance(a, nd.NDArray) else a
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"nd (b): {what} through mx.nd differs from the ops call")

    def want(what, got, counts):
        if got != counts:
            fail(f"nd (b): {what} launched {got}, want {counts}")
        launches[what] = got

    b, h, s, d = LONG_BATCH, LONG_HEADS, ND_SEQ, 64
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(3))
        head = torch.randn(b, h, s, d, device=dev, generator=gen).to(dtype)
        got, c = _nd_counted(torch, mx, lambda: nd.contrib.flash_attention(
            nd.NDArray(q), nd.NDArray(k), nd.NDArray(v)))
        want(f"flash_attention {name}", c, {"flash_attention": 1})
        equal(f"flash_attention {name}", got,
              ops.contrib.flash_attention(q, k, v))
        arrays = [nd.NDArray(t.clone()) for t in (q, k, v)]
        for a in arrays:
            a.attach_grad()

        def nd_backward():
            with mx.autograd.record():
                out = nd.contrib.flash_attention(*arrays)
            out.backward(nd.NDArray(head))
        _, c = _nd_counted(torch, mx, nd_backward)
        want(f"flash_attention {name} forward+backward", c,
             {"flash_attention": 1, "flash_attention_bwd_dkv": 1,
              "flash_attention_bwd_dq": 1})
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.autograd.backward(ops.contrib.flash_attention(*leaves), head)
        for a, t, g in zip(arrays, leaves, "qkv"):
            equal(f"flash_attention {name} d{g}", a.grad, t.grad)
        del q, k, v, head, arrays, leaves
    y = torch.randn(*ND_FFN, device=dev, generator=gen)
    bias = torch.randn(ND_FFN[1], device=dev, generator=gen)

    def k2_nd():
        mx.random.seed(SEED + 29)
        with mx.autograd.train_mode():
            return nd.contrib.matmul_epilogue(nd.NDArray(y), nd.NDArray(bias),
                                              act_type="gelu", p=0.1)
    got, c = _nd_counted(torch, mx, k2_nd)
    want("matmul_epilogue", c, {"matmul_epilogue": 1})
    mx.random.seed(SEED + 29)
    ref = ops.contrib.matmul_epilogue(y, bias, act_type="gelu", p=0.1,
                                      training=True)
    equal("matmul_epilogue (dropout 0.1, the same seeded bits)", got, ref)
    kept = float((ref != 0).float().mean())
    x = torch.randn(*ND_STAGE, device=dev, generator=gen)
    res = torch.randn(*ND_STAGE, device=dev, generator=gen)
    c_ = ND_STAGE[1]
    gamma, beta = (torch.rand(c_, device=dev, generator=gen) + 0.5,
                   torch.randn(c_, device=dev, generator=gen))
    mean, var = (torch.randn(c_, device=dev, generator=gen) * 0.1,
                 torch.rand(c_, device=dev, generator=gen) + 0.5)
    got, c = _nd_counted(torch, mx, lambda: nd.BatchNorm(
        *[nd.NDArray(t) for t in (x, gamma, beta, mean, var)],
        fix_gamma=False, act_type="relu"))
    want("BatchNorm(act_type=relu)", c, {"conv_epilogue": 1})
    equal("BatchNorm(act_type=relu)", got[0], ops.nn.batch_norm(
        x, gamma, beta, mean, var, fix_gamma=False, act_type="relu")[0])
    got, c = _nd_counted(torch, mx, lambda: nd.contrib.conv_epilogue(
        nd.NDArray(x), nd.NDArray(res), act_type="relu"))
    want("conv_epilogue", c, {"conv_epilogue": 1})
    equal("conv_epilogue", got, ops.contrib.conv_epilogue(x, res))
    log(f"nd (b): flash_attention at batch {b}, {h} heads, S {s}, D {d} "
        f"(fp32, bf16; forward, and backward under record()), "
        f"matmul_epilogue on {ND_FFN} gelu with dropout 0.1 (kept "
        f"{kept:.4f}), BatchNorm(act_type=relu) and conv_epilogue at "
        f"{ND_STAGE}: every output bit-equal to the ops call; launches "
        + "; ".join(f"{k}: {v}" for k, v in launches.items()))
    return launches


def nd_serve_resnet(torch, mx, ctx):
    """(c) Full-width ResNet-50 v1 hybridized, called with an nd.array
    batch of 8: an NDArray of logits bit-equal to the tensor call (the
    same captured graph), 48 K1 launches per forward."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    net.hybridize()
    x = np.random.RandomState(SEED + 28).randn(BATCH, 3, 224, 224).astype(
        np.float32)
    tensor_out = net(torch.from_numpy(x).to(ctx.torch_device))   # captures
    got, c = _nd_counted(torch, mx, lambda: net(mx.nd.array(x, ctx=ctx)))
    if not isinstance(got, mx.nd.NDArray) or got.shape != (BATCH, 1000):
        fail(f"nd (c): the hybridized ResNet-50 returned {type(got)}")
    if not torch.equal(got.handle, tensor_out):
        fail("nd (c): the NDArray call's logits differ from the tensor "
             "call's")
    if c != {"conv_epilogue": 48}:
        fail(f"nd (c): {c} launches per forward, want 48 conv_epilogue")
    log(f"nd (c): hybridized ResNet-50 v1 on an nd.array batch of {BATCH}: "
        f"logits bit-equal to the tensor call, launches {c}")
    return c


def real_batch(rng, n, size=16):
    """examples/train_dcgan.py's data: soft blobs at random positions in
    [-1, 1) (that file imports the JAX package, so it is copied here)."""
    import numpy as np
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = rng.uniform(4, size - 4, (n, 1, 1))
    cy = rng.uniform(4, size - 4, (n, 1, 1))
    r2 = (xx[None] - cx) ** 2 + (yy[None] - cy) ** 2
    img = np.exp(-r2 / 8.0) * 2.0 - 1.0
    return img[:, None].astype(np.float32)


def nd_example_blocks(mx):
    """The blocks of examples/train_dcgan.py and train_vae.py with the
    port's gluon (the VAE's ``hybrid_forward(F, ...)`` as ``forward``
    with ``F = mx.nd``)."""
    nn, F = mx.gluon.nn, mx.nd

    def generator(ngf=16):
        net = nn.HybridSequential()
        net.add(nn.Dense(ngf * 2 * 4 * 4, use_bias=False),
                nn.HybridLambda(lambda F, x: F.reshape(x, (-1, 32, 4, 4))),
                nn.Conv2DTranspose(ngf, 4, strides=2, padding=1,
                                   use_bias=False),
                nn.Activation("relu"),
                nn.Conv2DTranspose(1, 4, strides=2, padding=1,
                                   use_bias=False),
                nn.Activation("tanh"))
        return net

    def discriminator(ndf=16):
        net = nn.HybridSequential()
        net.add(nn.Conv2D(ndf, 4, strides=2, padding=1), nn.LeakyReLU(0.2),
                nn.Conv2D(ndf * 2, 4, strides=2, padding=1),
                nn.LeakyReLU(0.2), nn.Dense(1))
        return net

    class VAE(mx.gluon.HybridBlock):
        def __init__(self, nz=8, nf=16):
            super().__init__()
            self._nz = nz
            self.enc = nn.HybridSequential()
            self.enc.add(nn.Conv2D(nf, 4, strides=2, padding=1),
                         nn.Activation("relu"),
                         nn.Conv2D(nf * 2, 4, strides=2, padding=1),
                         nn.Activation("relu"), nn.Dense(2 * nz))
            self.dec = nn.HybridSequential()
            self.dec.add(nn.Dense(nf * 2 * 4 * 4, activation="relu"),
                         nn.HybridLambda(
                             lambda F, x: F.reshape(x, (-1, nf * 2, 4, 4))),
                         nn.Conv2DTranspose(nf, 4, strides=2, padding=1),
                         nn.Activation("relu"),
                         nn.Conv2DTranspose(1, 4, strides=2, padding=1),
                         nn.Activation("tanh"))

        def forward(self, x, eps):
            h = self.enc(x)
            mu = F.slice_axis(h, axis=1, begin=0, end=self._nz)
            logvar = F.slice_axis(h, axis=1, begin=self._nz,
                                  end=2 * self._nz)
            z = mu + F.exp(0.5 * logvar) * eps
            return self.dec(z), mu, logvar

    return generator, discriminator, VAE


def nd_dcgan(torch, mx, steps=ND_DCGAN_STEPS, batch=ND_EX_BATCH, nz=16,
             lr=2e-3):
    """examples/train_dcgan.py's main() with the port's mx, on the
    current context: its gate (pixel-mean-map L1 < 0.12, both losses
    > 0.05, tests/test_examples.py) and its ms per step."""
    import numpy as np
    autograd, gluon = mx.autograd, mx.gluon
    generator, discriminator, _ = nd_example_blocks(mx)
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    gen, dis = generator(), discriminator()
    gen.initialize(mx.init.Normal(0.05))
    dis.initialize(mx.init.Normal(0.05))
    gen.hybridize()
    dis.hybridize()
    gt = gluon.Trainer(gen.collect_params(), "adam",
                       {"learning_rate": lr, "beta1": 0.5})
    dt = gluon.Trainer(dis.collect_params(), "adam",
                       {"learning_rate": lr, "beta1": 0.5})
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones = mx.nd.ones((batch,))
    zeros = mx.nd.zeros((batch,))
    last = {}

    def step():
        real = mx.nd.array(real_batch(rng, batch))
        z = mx.nd.array(rng.randn(batch, nz).astype(np.float32))
        fake = gen(z).detach()
        with autograd.record():
            d_loss = (bce(dis(real).reshape(-1), ones)
                      + bce(dis(fake).reshape(-1), zeros)).mean()
        d_loss.backward()
        dt.step(batch)
        with autograd.record():
            g_loss = bce(dis(gen(z)).reshape(-1), ones).mean()
        g_loss.backward()
        gt.step(batch)
        last.update(g=float(g_loss.asscalar()), d=float(d_loss.asscalar()))

    ms, prof = nd_timed_steps(torch, step, steps, "DCGAN step (D and G)")
    z = mx.nd.array(rng.randn(256, nz).astype(np.float32))
    fake_mean = gen(z).asnumpy().mean(axis=0)[0]
    real_mean = real_batch(rng, 256).mean(axis=0)[0]
    err = float(np.abs(fake_mean - real_mean).mean())
    return {"mean_map_l1": err, "d_loss": last["d"], "g_loss": last["g"],
            "ms_per_step": ms, "profile": prof,
            "captures": gen._graphs.captures + dis._graphs.captures}


def nd_timed_steps(torch, step, steps, what):
    """Run ``steps`` calls of ``step`` (each ends in a host read of its
    losses), the last one profiled: (median ms of the others, the
    profile of the last; the first calls capture the graphs)."""
    times = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = _median(times)
    return ms, sh_profile(torch, step, ms, what)


def nd_vae(torch, mx, steps=ND_VAE_STEPS, batch=ND_EX_BATCH, nz=8, lr=2e-3,
           kl_weight=5e-3):
    """examples/train_vae.py's main() with the port's mx, on the current
    context: its gate (rec < 0.05, 0.5 < KL < 100, prior-sample L1 <
    0.1, tests/test_examples.py) and its ms per step."""
    import numpy as np
    autograd, gluon = mx.autograd, mx.gluon
    _, _, VAE = nd_example_blocks(mx)
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    net = VAE(nz=nz)
    net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})
    last = {}

    def step():
        x = mx.nd.array(real_batch(rng, batch))
        eps = mx.nd.array(rng.randn(batch, nz).astype(np.float32))
        with autograd.record():
            xh, mu, logvar = net(x, eps)
            rec_l = ((xh - x) ** 2).mean()
            kl_l = (-0.5 * (1 + logvar - mu * mu -
                            mx.nd.exp(logvar))).sum(axis=1).mean()
            loss = rec_l + kl_weight * kl_l
        loss.backward()
        trainer.step(batch)
        last.update(rec=float(rec_l.asscalar()), kl=float(kl_l.asscalar()))

    ms, prof = nd_timed_steps(torch, step, steps, "VAE step")
    z = mx.nd.array(rng.randn(256, nz).astype(np.float32))
    gen = net.dec(z).asnumpy().mean(axis=0)[0]
    real_mean = real_batch(rng, 256).mean(axis=0)[0]
    l1 = float(np.abs(gen - real_mean).mean())
    return {"rec": last["rec"], "kl": last["kl"], "prior_l1": l1,
            "ms_per_step": ms, "profile": prof}


def phase_nd(torch, mx, card, ctx):
    """Phase 28: mx.nd on the card, (a)-(d), cuDNN deterministic (the
    examples' runs repeat bit for bit on one card and software)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ops = nd_ops_card_vs_cpu(torch, mx, ctx)
        kern = nd_kernels_full_width(torch, mx, ctx)
        resnet = nd_serve_resnet(torch, mx, ctx)
        with ctx:
            dcgan = nd_dcgan(torch, mx)
            vae = nd_vae(torch, mx)
    finally:
        torch.backends.cudnn.deterministic = old
    if not (dcgan["mean_map_l1"] < 0.12 and dcgan["d_loss"] > 0.05
            and dcgan["g_loss"] > 0.05):
        fail(f"nd (d): train_dcgan's gate missed: {dcgan}")
    if not (vae["rec"] < 0.05 and 0.5 < vae["kl"] < 100
            and vae["prior_l1"] < 0.1):
        fail(f"nd (d): train_vae's gate missed: {vae}")
    log(f"nd (d): examples/train_dcgan.py ({ND_DCGAN_STEPS} steps, batch "
        f"{ND_EX_BATCH}, hybridized): pixel-mean-map L1 "
        f"{dcgan['mean_map_l1']:.4f} (< 0.12), d_loss {dcgan['d_loss']:.3f},"
        f" g_loss {dcgan['g_loss']:.3f} (> 0.05), median "
        f"{dcgan['ms_per_step']:.3f} ms per step (D and G), "
        f"{dcgan['captures']} captures; examples/train_vae.py "
        f"({ND_VAE_STEPS} steps): rec {vae['rec']:.4f} (< 0.05), kl "
        f"{vae['kl']:.2f} (0.5-100), prior-sample L1 {vae['prior_l1']:.4f} "
        f"(< 0.1), median {vae['ms_per_step']:.3f} ms per step; {card}")
    return {"ops": ops, "kernels": kern, "resnet": resnet, "dcgan": dcgan,
            "vae": vae}


# -- phase 29: item 6's rest --------------------------------------------------
AM_FFN1 = (LONG_BATCH * LONG_SEQ, 3072)      # BERT-base ffn_1 at S 4096
AM_BN = (128, 64, 112, 112)                  # ResNet-50 v1 bn1, batch 128
AM_MIXED = (("bfloat16", "float32"), ("float16", "float32"),
            ("float32", "bfloat16"))         # (y, the vectors)


def am_mixed_kernels(torch, ce, me):
    """Phase 29 (k): K2 at BERT's ffn_1 shape and K1 at a ResNet-50
    BatchNorm shape with the vectors at a dtype other than y's, each
    bit-equal to its plain version, timed against its bytes bound."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = []
    for ydt, vdt in AM_MIXED:
        yt, vt = getattr(torch, ydt), getattr(torch, vdt)
        ysz = torch.tensor([], dtype=yt).element_size()
        vsz = torch.tensor([], dtype=vt).element_size()
        for kern in ("K2", "K1"):
            shape = AM_FFN1 if kern == "K2" else AM_BN
            c = shape[-1] if kern == "K2" else shape[1]
            n = math.prod(shape)
            nbytes = 2 * n * ysz + (1 if kern == "K2" else 2) * c * vsz
            n_copies = max(1, min(8, math.ceil(160e6 / nbytes)))
            ys = [(torch.randn(*shape, generator=gen, device=dev) * 2)
                  .to(yt) for _ in range(n_copies)]
            bias = (torch.randn(c, generator=gen, device=dev) * 0.5).to(vt)
            scale = (torch.rand(c, generator=gen, device=dev) + 0.5).to(vt)
            if kern == "K2":
                def run(i, plain=False):
                    f = me.matmul_epilogue_plain if plain else \
                        me.matmul_epilogue_2d
                    return f(ys[i], bias.reshape(1, c), None,
                             act_type="gelu")
                lib = lambda i: torch.add(ys[i], bias)
            else:
                def run(i, plain=False):
                    f = ce.fused_conv_epilogue_plain if plain else \
                        ce.fused_conv_epilogue
                    return f(ys[i], scale, bias, None, channel_axis=1,
                             act_type="relu")
                lib = None
            with torch.inference_mode():
                got, want = run(0), run(0, plain=True)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                if got.dtype != yt or not torch.equal(got, want):
                    fail(f"phase 29 (k): {kern} {shape} y {ydt}, vectors "
                         f"{vdt}: not bit-equal to its plain version "
                         f"(max err {err}, dtype {got.dtype})")
                k_ms = graph_ms(torch, run, n_copies)
                p_ms = graph_ms(torch, lambda i: run(i, plain=True),
                                n_copies)
                l_ms = graph_ms(torch, lib, n_copies) if lib else None
            bnd = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append({"kernel": kern, "shape": shape, "y": ydt,
                         "vectors": vdt, "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": bnd, "library_ms": l_ms,
                         "max_abs_err": err})
            log(f"  {kern} {str(shape):22s} y {ydt:8s} vectors {vdt:8s} "
                f"bit-equal kernel_ms={k_ms:.6f} plain_ms={p_ms:.6f} "
                f"bound_ms={bnd:.6f} (bytes) share {bnd / k_ms:.3f}"
                + (f" torch.add_ms={l_ms:.6f}" if l_ms else ""))
    return rows


AM_LIST = ["FullyConnected", "Convolution"]  # MXNet 1.x's BF16_FUNCS
AM_STEPS = 3
AM_LOSS_RTOL = 2e-2          # bf16 list vs fp32, each step's mean loss
AM_DELTA_RTOL = 0.5          # |dW_bf16 - dW_fp32| / |dW_fp32|, all weights
AM_BERT_PER_STEP = {"matmul_epilogue": 24, "flash_attention": 12,
                    "flash_attention_bwd_dkv": 12,
                    "flash_attention_bwd_dq": 12}
AM_RESNET_PER_STEP = {"conv_epilogue": 48}


@contextlib.contextmanager
def am_dtype_tap():
    """Within the scope, every launch of K1, K2, K3 and K3-bwd records
    (kernel, y's dtype, the vectors' dtypes) in the yielded list."""
    from mxnet_tpu_torch.kernels import conv_epilogue as ce
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import matmul_epilogue as me
    seen = []
    old = (ce._launch, me._launch, fa._launch, fa._launch_bwd_kernel)

    def k1(y, scale, bias, res, *a):
        seen.append(("conv_epilogue", y.dtype,
                     None if scale is None else scale.dtype))
        return old[0](y, scale, bias, res, *a)

    def k2(y, bias, *a):
        seen.append(("matmul_epilogue", y.dtype, bias.dtype))
        return old[1](y, bias, *a)

    def k3(q, *a):
        seen.append(("flash_attention", q.dtype, None))
        return old[2](q, *a)

    def k3b(which, q, *a):
        seen.append((f"flash_attention_bwd_{which}", q.dtype, None))
        return old[3](which, q, *a)

    ce._launch, me._launch, fa._launch, fa._launch_bwd_kernel = \
        k1, k2, k3, k3b
    try:
        yield seen
    finally:
        ce._launch, me._launch, fa._launch, fa._launch_bwd_kernel = old


def am_train(torch, mx, net, loss_fn, make_trainer, batch, listed, steps,
             per_step, what):
    """``steps`` eager Trainer steps from the net's current state, under
    amp.init("bfloat16", target_precision_ops=AM_LIST) with
    amp.init_trainer / amp.scale_loss (``listed``) or in fp32; returns
    (losses, step ms, launches, the kernels' dtypes, the weights)."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.contrib import amp
    x, y = batch
    trainer = make_trainer()
    if listed:
        amp.init("bfloat16", target_precision_ops=AM_LIST)
        amp.init_trainer(trainer)
    dense_dtypes = []
    hooks = [m.register_forward_hook(
        lambda mod, i, o: dense_dtypes.append(o.dtype))
        for m in net.modules() if isinstance(m, mx.gluon.nn.Dense)]
    losses, times = [], []
    mx.random.seed(SEED)
    try:
        _sync(torch)
        kernels.reset_launch_counts()
        with am_dtype_tap() as seen:
            for i in range(steps):
                t0 = time.perf_counter()
                with mx.autograd.record():
                    out = net(x)
                    out = out[1] if isinstance(out, tuple) else out
                    loss = loss_fn(out, y)
                if listed and i == 0:
                    if loss.dtype != torch.float32 or \
                            out.dtype != torch.bfloat16:
                        fail(f"phase 29 {what}: loss {loss.dtype}, output "
                             f"{out.dtype} under the op list (want "
                             "float32, bfloat16)")
                    if set(dense_dtypes) != {torch.bfloat16}:
                        fail(f"phase 29 {what}: Dense outputs "
                             f"{set(dense_dtypes)} under the op list")
                if listed:
                    with amp.scale_loss(loss, trainer) as scaled:
                        mx.autograd.backward(scaled)
                else:
                    mx.autograd.backward(loss)
                trainer.step(x.shape[0])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss.detach().mean()))
                del out, loss
        launches = kernels.launch_counts()
    finally:
        for h in hooks:
            h.remove()
        amp.reset()
    for kernel, n in per_step.items():
        if launches[kernel] != n * steps:
            fail(f"phase 29 {what}: {kernel} launched {launches[kernel]} "
                 f"times in {steps} steps (want {n} per step)")
    if any(n and k not in per_step for k, n in launches.items()):
        fail(f"phase 29 {what}: launches {launches} beyond {per_step}")
    weights = {k: v.detach().clone()
               for k, v in net.collect_params().items()}
    if any(w.dtype != torch.float32 for w in weights.values()):
        fail(f"phase 29 {what}: a parameter left float32")
    del trainer
    return losses, times, launches, seen, weights


def am_compare(torch, what, init, listed, plain, card):
    """Hold the op-list run against the fp32 run from the same state: each
    step's loss within AM_LOSS_RTOL, the weights' change within
    AM_DELTA_RTOL (L2 over every weight); returns the figures."""
    l_b, l_f = listed[0], plain[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_b, l_f))
    num = den = 0.0
    worst = (0.0, None)
    for k, w0 in init.items():
        if not w0.is_floating_point():
            continue
        db = listed[4][k].double() - w0.double()
        df = plain[4][k].double() - w0.double()
        n, d = float((db - df).norm()) ** 2, float(df.norm()) ** 2
        num, den = num + n, den + d
        if d > 0 and (n / d) ** 0.5 > worst[0]:
            worst = ((n / d) ** 0.5, k)
    delta_rel = (num / den) ** 0.5 if den else 0.0
    log(f"  {what}: losses bf16 list {[round(v, 6) for v in l_b]} vs fp32 "
        f"{[round(v, 6) for v in l_f]}: worst rel {loss_rel:.3e} (gate "
        f"{AM_LOSS_RTOL:g}); weight change rel L2 {delta_rel:.4f} (gate "
        f"{AM_DELTA_RTOL:g}), worst tensor {worst[1]} {worst[0]:.4f}; "
        f"step ms bf16 list {[round(t, 3) for t in listed[1]]}, fp32 "
        f"{[round(t, 3) for t in plain[1]]}; {card}")
    if not loss_rel <= AM_LOSS_RTOL or not delta_rel <= AM_DELTA_RTOL:
        fail(f"phase 29 {what}: the op-list run left the fp32 run "
             f"(loss rel {loss_rel}, weight change rel {delta_rel})")
    return {"loss_rel": loss_rel, "delta_rel": delta_rel,
            "ms_listed": _median(listed[1][1:]),
            "ms_fp32": _median(plain[1][1:]), "losses": l_b}


def am_kernel_dtypes(what, seen, want):
    """Every launch of the op-list run at the dtypes ``want`` gives
    ({kernel: (y dtype, vector dtype)})."""
    got = {}
    for kernel, ydt, vdt in seen:
        got.setdefault(kernel, set()).add((ydt, vdt))
    for kernel, pairs in got.items():
        if not pairs <= want.get(kernel, set()):
            fail(f"phase 29 {what}: {kernel} launched at {pairs}, want "
                 f"{want.get(kernel)}")
    log(f"  {what}: launch dtypes (y, vectors) "
        + "; ".join(f"{k} {sorted(str(p) for p in v)}"
                    for k, v in sorted(got.items())))


def am_bert(torch, mx, card, ctx):
    """(a1) BERT-base MLM, batch 4, S 4096, Adam, under the op list and in
    fp32 from the same state."""
    import numpy as np
    net = seeded_mlm(torch, mx, ctx)
    ids = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (LONG_BATCH, LONG_SEQ)).astype(np.int32)
    tokens = torch.from_numpy(ids).to(ctx.torch_device)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    init = {k: v.detach().clone() for k, v in net.collect_params().items()}

    def trainer():
        return mx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": TRAIN_LR})

    runs = {}
    for listed in (True, False):
        with torch.no_grad():
            for k, v in net.collect_params().items():
                v.copy_(init[k])
        runs[listed] = am_train(torch, mx, net, loss_fn, trainer,
                                (tokens, tokens), listed, AM_STEPS,
                                AM_BERT_PER_STEP, "(a1) BERT-base")
    bf16, f32 = torch.bfloat16, torch.float32
    am_kernel_dtypes("(a1) BERT-base", runs[True][3], {
        "matmul_epilogue": {(bf16, f32)},
        "flash_attention": {(bf16, None)},
        "flash_attention_bwd_dkv": {(bf16, None)},
        "flash_attention_bwd_dq": {(bf16, None)}})
    out = am_compare(torch, "(a1) BERT-base MLM, batch 4, S 4096, Adam",
                     init, runs[True], runs[False], card)
    out["launches"] = runs[True][2]
    del net, init, runs
    torch.cuda.empty_cache()
    return out


def am_resnet(torch, mx, card, ctx):
    """(a2) ResNet-50 v1, batch 128, SGD, under the op list and in fp32
    from the same state (cuDNN deterministic)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    dev = ctx.torch_device
    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(RN_BATCH, 3, RN_SIZE, RN_SIZE)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, (RN_BATCH,))
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        net(x[:1])
    init = {k: v.detach().clone() for k, v in net.collect_params().items()}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def trainer():
        return mx.gluon.Trainer(net.collect_params(), "sgd", dict(RN_SGD))

    runs = {}
    for listed in (True, False):
        with torch.no_grad():
            for k, v in net.collect_params().items():
                v.copy_(init[k])
        runs[listed] = am_train(torch, mx, net, loss_fn, trainer, (x, y),
                                listed, AM_STEPS, AM_RESNET_PER_STEP,
                                "(a2) ResNet-50")
    # BatchNorm folds its statistics, gamma and beta in fp32 and casts the
    # scale and offset to x's dtype before the epilogue, as the JAX op
    # does (mxnet_tpu/ops/nn.py:358-373): bf16 vectors beside a bf16 y
    bf16 = torch.bfloat16
    am_kernel_dtypes("(a2) ResNet-50", runs[True][3], {
        "conv_epilogue": {(bf16, bf16), (bf16, None)}})
    with_vectors = sum(1 for k, ydt, vdt in runs[True][3] if vdt is not None)
    if with_vectors != 32 * AM_STEPS:
        fail(f"phase 29 (a2): {with_vectors} K1 launches with vectors in "
             f"{AM_STEPS} steps, want 32 per step (the BatchNorm+relu "
             "pairs)")
    out = am_compare(torch, f"(a2) ResNet-50 v1, batch {RN_BATCH}, SGD",
                     init, runs[True], runs[False], card)
    out["launches"] = runs[True][2]
    del net, init, runs
    torch.cuda.empty_cache()
    return out


CF_T, CF_B, CF_U = 32, 64, 768      # (b): steps, batch, Elman width
CF_STEPS = 3
CF_RTOL = 1e-4                      # card vs CPU, of max |value|
SP_VOCAB, SP_DIM, SP_IDS, SP_STEPS = 500000, 64, 8192, 20
SP_ATOL = 1e-5                      # touched rows, card vs CPU


def cf_elman(mx):
    """(b)'s block: foreach over time of an Elman cell, one
    Dense(768, tanh) on [x_t, h] (K2: bias + tanh) per step."""
    import torch

    class ElmanScan(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.cell = mx.gluon.nn.Dense(CF_U, activation="tanh",
                                          flatten=False, in_units=2 * CF_U)

        def forward(self, x):
            h0 = torch.zeros(x.shape[1], CF_U, dtype=x.dtype,
                             device=x.device)

            def step(xt, h):
                h = self.cell(torch.cat([xt, h], dim=-1))
                return h, h
            outs, h = mx.nd.contrib.foreach(step, x, h0)
            return outs, h
    return ElmanScan()


def cf_train(torch, mx, net, x, y, steps):
    """``steps`` eager-Trainer Adam steps of an L2 loss on the scan's
    outputs; returns (losses, the weights, the gradients of the last)."""
    seq_loss = mx.gluon.loss.L2Loss(batch_axis=1)      # (T, B, U) -> (B,)
    last_loss = mx.gluon.loss.L2Loss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            outs, h = net(x)
            loss = seq_loss(outs, y) + last_loss(h, y[-1])
        mx.autograd.backward(loss)
        grads = {k: v.grad.detach().cpu().clone()
                 for k, v in net.collect_params().items()}
        trainer.step(x.shape[1])
        losses.append(loss.detach().cpu())
    return losses, {k: v.detach().cpu().clone()
                    for k, v in net.collect_params().items()}, grads


def cf_beam(mx, trans, L=8, eos=0):
    """(b)'s while_loop: the greedy decode of tests/test_control_flow.py
    (an argmax chain with an EOS exit) on tensors."""
    import torch
    v = trans.shape[0]

    def cond(step, toks, fin):
        return (step < L) & (fin.sum() < 1)

    def body(step, toks, fin):
        cur = toks[step.long()]
        nxt = trans[cur.long()].reshape(1, v).argmax(-1)
        col = torch.nn.functional.one_hot(step.long() + 1, L + 1)
        toks = (toks.reshape(1, L + 1) * (1 - col)
                + nxt.reshape(1, 1) * col).reshape(L + 1).int()
        fin = torch.maximum(fin, (nxt == eos).float())
        return [], [step + 1, toks, fin]

    dev = trans.device
    _, (steps, toks, fin) = mx.nd.contrib.while_loop(
        cond, body, [torch.zeros(1, device=dev),
                     torch.full((L + 1,), 2, dtype=torch.int32, device=dev),
                     torch.zeros(1, device=dev)], max_iterations=L)
    return steps, toks


def phase29_control_flow(torch, mx, card, ctx):
    """(b) foreach trained hybridized (graph) and eager on the card, both
    held against the CPU; while_loop and cond captured against eager."""
    import numpy as np
    from mxnet_tpu_torch import kernels
    dev = ctx.torch_device
    rng = np.random.RandomState(SEED)
    x_np = (rng.randn(CF_T, CF_B, CF_U) * 0.5).astype(np.float32)
    y_np = (rng.randn(CF_T, CF_B, CF_U) * 0.5).astype(np.float32)
    base = cf_elman(mx)
    base.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                    generator=mx.random.generator(SEED))
    with torch.no_grad():
        base(torch.from_numpy(x_np[:, :1]))
    state = {k: v.detach().numpy().copy()
             for k, v in base.collect_params().items()}
    runs = {}
    for mode in ("graph", "eager", "cpu"):
        net = cf_elman(mx)
        on = mx.cpu() if mode == "cpu" else ctx
        net.load_dict(state, ctx=on)
        if mode == "graph":
            net.hybridize()
        d = on.torch_device
        x, y = torch.from_numpy(x_np).to(d), torch.from_numpy(y_np).to(d)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[mode] = cf_train(torch, mx, net, x, y, CF_STEPS)
        _sync(torch)
        runs[mode] += ((time.perf_counter() - t0) * 1e3 / CF_STEPS,
                       kernels.launch_counts()["matmul_epilogue"])
        del net
    if runs["eager"][4] != CF_T * CF_STEPS:
        fail(f"phase 29 (b): K2 launched {runs['eager'][4]} times in "
             f"{CF_STEPS} eager steps, want {CF_T} per forward")
    if runs["graph"][4] < CF_T * CF_STEPS:
        fail(f"phase 29 (b): K2 launched {runs['graph'][4]} times in the "
             f"graphed steps, want at least {CF_T} per step")
    g, e, c = runs["graph"], runs["eager"], runs["cpu"]
    for what in (0, 1, 2):
        a, b = (g[what], e[what]) if what else (dict(enumerate(g[0])),
                                                dict(enumerate(e[0])))
        if not all(torch.equal(a[k], b[k]) for k in b):
            fail(f"phase 29 (b): the graphed foreach training differs from "
                 f"the eager one ({('losses', 'weights', 'grads')[what]})")
    worst = 0.0
    for what in (1, 2):
        for k, want in c[what].items():
            scale = float(want.abs().max()) or 1.0
            worst = max(worst, float((e[what][k] - want).abs().max())
                        / scale)
    for a, b in zip(e[0], c[0]):
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    if worst > CF_RTOL:
        fail(f"phase 29 (b): card vs CPU {worst:.3e} of max (tolerance "
             f"{CF_RTOL})")
    # while_loop and cond inside a capture against eager: a transition
    # table whose greedy chain 2 -> 3 -> 4 -> 5 -> 1 -> 0 reaches EOS (0)
    # at step 5 of 8, so the last 3 steps run masked
    trans_np = rng.rand(6, 6).astype(np.float32)
    for a, b in ((2, 3), (3, 4), (4, 5), (5, 1), (1, 0), (0, 0)):
        trans_np[a, b] = 2.0

    class Beam(mx.gluon.HybridBlock):
        def forward(self, trans):
            return cf_beam(mx, trans)

    class Select(mx.gluon.HybridBlock):
        def forward(self, a, b):
            return mx.nd.contrib.cond((a.sum() > b.sum()).reshape(()),
                                      lambda: a * 2, lambda: b * 3)

    trans = torch.from_numpy(trans_np).to(dev)
    beam = Beam()
    eager_b = beam(trans)
    beam.hybridize()
    graph_b = [beam(trans) for _ in range(2)][-1]
    sel = Select()
    pairs = [(torch.tensor([2.0], device=dev), torch.tensor([5.0],
                                                          device=dev)),
             (torch.tensor([9.0], device=dev), torch.tensor([5.0],
                                                          device=dev))]
    eager_s = [sel(a, b) for a, b in pairs]
    sel.hybridize()
    graph_s = [sel(a, b) for a, b in pairs]
    if not (all(torch.equal(a, b) for a, b in zip(eager_b, graph_b))
            and all(torch.equal(a, b) for a, b in zip(eager_s, graph_s))):
        fail("phase 29 (b): a captured while_loop or cond differs from "
             "eager")
    if dev.type == "cuda" and not len(beam._graphs):
        fail("phase 29 (b): the hybridized decode captured no program")
    log(f"  (b) foreach: Elman Dense({CF_U}, tanh) over T {CF_T}, batch "
        f"{CF_B}, {CF_STEPS} Adam steps: graphed bit-equal to eager "
        f"(losses, weights, gradients), card vs CPU {worst:.3e} of max "
        f"(gate {CF_RTOL:g}); K2 {e[4]} eager launches ({CF_T} per "
        f"forward), {g[4]} graphed (the capture's warm-ups included); ms "
        f"per step (the first captures) graphed {g[3]:.3f}, eager "
        f"{e[3]:.3f}; while_loop beam decode ({int(graph_b[0].item())} "
        f"steps of 8, masked past the exit) and cond captured: equal to "
        f"eager; {card}")
    if int(graph_b[0].item()) != 5:
        fail(f"phase 29 (b): the decode ran {int(graph_b[0].item())} steps, "
             "want 5")
    return {"worst": worst, "k2": e[4], "graph_ms": g[3],
            "eager_ms": e[3]}


def sp_net(mx, ctx, sparse, state=None):
    """(c)'s model: Embedding(500000, 64) -> Dense(256, relu) (K2) ->
    Dense(64), seeded Xavier weights (or ``state``)."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Embedding(SP_VOCAB, SP_DIM, sparse_grad=sparse),
            nn.Dense(256, activation="relu", flatten=False, in_units=SP_DIM),
            nn.Dense(64, flatten=False, in_units=256))
    if state is None:
        net.initialize(mx.init.Xavier(), ctx=ctx,
                       generator=mx.random.generator(SEED))
    else:
        net.load_dict(state, ctx=ctx)
    return net


def sp_train(torch, mx, net, ids, targets):
    """SP_STEPS Adam steps of an L2 loss; returns the step ms."""
    loss_fn = mx.gluon.loss.L2Loss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    times = []
    for i in range(len(ids)):
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(ids[i]), targets[i])
        mx.autograd.backward(loss)
        trainer.step(ids[i].shape[0])
        _sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


class StepReluTape:
    """The relu decisions of K2's epilogue, one site per training step:
    recorded where the card's backward recomputes them (the plain VJP)
    and replayed on the CPU in the forward and the backward of each step
    in turn, as ReluTape does within one ResNet step. A relu input within
    rounding of 0 takes opposite signs on the card and the CPU, which
    moves a row's gradient; replaying the signs keeps every decision equal
    and every value computed apart."""

    def __init__(self, torch):
        self.torch, self.masks, self.replay = torch, [], False
        self.differ = self.total = 0

    def __enter__(self):
        from mxnet_tpu_torch.kernels import matmul_epilogue as me
        torch, tape = self.torch, self
        self._saved = me.act_fn
        fwd, bwd = iter(self.masks), iter(self.masks)

        def act(what, act_type):
            if act_type != "relu":
                return tape._saved(what, act_type)

            def relu(p):
                if tape.replay:
                    mask = next(bwd if torch.is_grad_enabled() else fwd) \
                        .to(p.device)
                    tape.differ += int((mask != (p > 0)).sum())
                    tape.total += p.numel()
                else:
                    mask = p > 0
                    if torch.is_grad_enabled():
                        tape.masks.append(mask.cpu())
                return torch.where(mask, p, torch.zeros((), dtype=p.dtype,
                                                        device=p.device))
            return relu

        me.act_fn = act
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.kernels import matmul_epilogue as me
        me.act_fn = self._saved


def phase29_sparse(torch, mx, card, ctx):
    """(c) Embedding(500000, 64, sparse_grad=True) trained 20 Adam steps of
    8192 ids on the card: untouched rows bit-unchanged, touched rows equal
    to the same run on the CPU (the card's relu decisions replayed:
    StepReluTape); ms per step against sparse_grad=False."""
    import numpy as np
    from mxnet_tpu_torch import kernels
    dev = ctx.torch_device
    rng = np.random.RandomState(SEED)
    ids_np = rng.randint(0, SP_VOCAB, (SP_STEPS, SP_IDS)).astype(np.int32)
    tg_np = rng.randn(SP_STEPS, SP_IDS, 64).astype(np.float32)
    net = sp_net(mx, ctx, True)
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in net.collect_params().items()}
    table0 = net[0].weight.detach().clone()
    ids = [torch.from_numpy(a).to(dev) for a in ids_np]
    tgs = [torch.from_numpy(a).to(dev) for a in tg_np]
    kernels.reset_launch_counts()
    tape = StepReluTape(torch)
    with tape:
        sparse_ms = sp_train(torch, mx, net, ids, tgs)
    k2 = kernels.launch_counts()["matmul_epilogue"]
    if k2 != SP_STEPS:
        fail(f"phase 29 (c): K2 launched {k2} times in {SP_STEPS} steps "
             "(want 1 per step)")
    table = net[0].weight.detach()
    touched = torch.zeros(SP_VOCAB, dtype=torch.bool, device=dev)
    touched[torch.from_numpy(ids_np.reshape(-1).astype(np.int64))
            .to(dev)] = True
    if not torch.equal(table[~touched], table0[~touched]):
        fail("phase 29 (c): a row no batch touched changed")
    cpu = sp_net(mx, mx.cpu(), True, state)
    tape.replay = True
    with tape:
        sp_train(torch, mx, cpu, [torch.from_numpy(a) for a in ids_np],
                 [torch.from_numpy(a) for a in tg_np])
    rows = touched.nonzero().reshape(-1)
    err = float((table[rows].cpu() - cpu[0].weight.detach()[rows.cpu()])
                .abs().max())
    if err > SP_ATOL:
        fail(f"phase 29 (c): touched rows card vs CPU {err:.3e} (gate "
             f"{SP_ATOL:g})")
    del net, cpu
    dense = sp_net(mx, ctx, False, state)
    dense_ms = sp_train(torch, mx, dense, ids, tgs)
    del dense
    torch.cuda.empty_cache()
    s_ms, d_ms = _median(sparse_ms[1:]), _median(dense_ms[1:])
    log(f"  (c) Embedding({SP_VOCAB}, {SP_DIM}, sparse_grad=True) -> "
        f"Dense(256, relu) -> Dense(64), L2, Adam, {SP_STEPS} steps of "
        f"{SP_IDS} ids: {int(touched.sum())} rows touched, the other "
        f"{SP_VOCAB - int(touched.sum())} bit-unchanged; touched rows vs "
        f"the CPU run {err:.3e} (gate {SP_ATOL:g}; the card's relu "
        f"decisions replayed on the CPU, {tape.differ} of {tape.total} "
        f"would have differed); K2 {k2}; median ms per "
        f"step sparse {s_ms:.3f}, dense {d_ms:.3f} (dense / sparse "
        f"{d_ms / s_ms:.3f}); {card}")
    return {"sparse_ms": s_ms, "dense_ms": d_ms, "err": err, "k2": k2,
            "relu_differ": tape.differ}


def phase29_np(torch, mx, card, ctx):
    """(d) every mx.np / mx.npx case of tools/np_cases.py on the card
    against the CPU; a CustomOp's forward and backward on card tensors;
    Custom refused inside a capture."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import np_cases as cases

    def call(ns, name, args, kw, on):
        fn = ns
        for part in name.split("."):
            fn = getattr(fn, part)
        with on:
            return fn(*cases.args_of(args, lambda a: mx.np.array(a, ctx=on)),
                      **kw)

    def host(x):
        if isinstance(x, (tuple, list)):
            return tuple(host(e) for e in x)
        return x.asnumpy() if hasattr(x, "asnumpy") else x

    n = 0
    for table, ns in ((cases.CASES, mx.np), (cases.NPX_CASES, mx.npx)):
        for name, (make, tol) in sorted(table.items()):
            args, kw = make(cases.rng_for(name))
            got = call(ns, name, args, kw, ctx)
            for x in (got if isinstance(got, tuple) else (got,)):
                if hasattr(x, "ctx") and x.ctx != ctx:
                    fail(f"phase 29 (d): {name} left {ctx}")
            want = call(ns, name, args, kw, mx.cpu())
            try:
                cases.check(host(got), host(want), tol, name)
            except AssertionError as e:
                fail(f"phase 29 (d): {name} on the card vs the CPU, "
                     f"tolerance {tol}: {str(e)[:400]}")
            n += 1

    @mx.operator.register("chip_scaled_square")
    class Prop(mx.operator.CustomOpProp):
        def create_operator(self, c, shapes, dtypes):
            class Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], 3.0 * in_data[0] ** 2)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                6.0 * in_data[0] * out_grad[0])
            return Op()

    x = mx.nd.array(np.float32([[1, -2, 3], [0.5, 0, -1]]), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="chip_scaled_square")
        loss = mx.nd.tanh(y).sum()
    loss.backward()
    xn = x.asnumpy()
    if y.ctx != ctx or not np.allclose(y.asnumpy(), 3 * xn ** 2) or \
            not np.allclose(x.grad.asnumpy(), (1 - np.tanh(3 * xn ** 2)
                                               ** 2) * 6 * xn, atol=1e-6):
        fail("phase 29 (d): the CustomOp's forward or backward on the card")
    graph = torch.cuda.CUDAGraph()
    refused = None
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        try:
            with torch.cuda.graph(graph):
                mx.nd.Custom(x._data, op_type="chip_scaled_square")
        except mx.MXNetError as e:
            refused = str(e)
    torch.cuda.synchronize()
    if not refused or "chip_scaled_square" not in refused:
        fail("phase 29 (d): Custom inside a capture did not raise naming "
             "the op")
    log(f"  (d) {n} mx.np / mx.npx cases on the card vs the CPU within "
        f"tools/np_cases.py's tolerances; CustomOp forward and backward "
        f"on card tensors; Custom inside a capture raises: {refused[:60]}")
    return {"cases": n}


def phase_item6(torch, mx, card, ctx, ce, me):
    """Phase 29: item 6's rest on the card — the K1/K2 mixed-dtype repair
    (k), training under amp.init's bf16 list (a1, a2), control flow (b),
    sparse (c), mx.np and CustomOp (d). TF32 off; cuDNN deterministic
    (the graphed-vs-eager and list-vs-fp32 comparisons)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for key, fn in (("k", lambda: am_mixed_kernels(torch, ce, me)),
                        ("a1", lambda: am_bert(torch, mx, card, ctx)),
                        ("a2", lambda: am_resnet(torch, mx, card, ctx)),
                        ("b", lambda: phase29_control_flow(torch, mx, card,
                                                           ctx)),
                        ("c", lambda: phase29_sparse(torch, mx, card, ctx)),
                        ("d", lambda: phase29_np(torch, mx, card, ctx))):
            t0 = time.perf_counter()
            out[key] = fn()
            log(f"phase 29 ({key}): {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = old
    return out


# -- phase 30: symbol --------------------------------------------------------
SY_ROOT = os.path.join(ROOT, "build", "chip_smoke_symbol")
SY_FIT_BATCH = 64                    # (d): Module.fit's batch
SY_FIT_BATCHES = 4                   # (d): batches per epoch
SY_FIT_EPOCHS = 2
SY_SGD = {"learning_rate": 0.01, "momentum": 0.9}  # (d): fit
# (d)'s one step at phase 13's lr: a change is stored in float32 beside
# its weight, one ulp of which is 6e-4 of a BatchNorm gamma's change at
# lr 0.1, 6e-3 at 0.01 (measured on the H100: gradients within 7e-5)
SY_STEP_SGD = {"learning_rate": 0.1, "momentum": 0.9}
SY_STEP_RTOL = 1e-3                  # (d): Module vs Trainer, of max |change|
SY_FUSE = (48, 4096, 64)             # (c): q, k, v
SY_FUSE_SCALE = 0.125
SY_FUSE_RTOL = 1e-5                  # (c): fused vs unfused, of max |out|
SY_MNIST = {"batch_size": 128, "epochs": 3, "lr": 0.05}
SY_MNIST_ACC = 0.99


def sy_rel(got, want):
    """max |got - want| / max |want| of two tensors or arrays."""
    import numpy as np
    got, want = (np.asarray(t.detach().float().cpu()) if hasattr(t, "detach")
                 else np.asarray(t) for t in (got, want))
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def sy_serve_resnet(torch, mx, card, ctx, phase4):
    """(a): phase 4's ResNet-50 exported and served by
    Server.from_checkpoint from CUDA graphs."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.serving import Server, ServerConfig
    import numpy as np
    dev = ctx.torch_device
    net, images = seeded_resnet50(torch, mx, ctx)
    net.hybridize()
    with torch.inference_mode():         # the Gluon net's graphed logits
        want = np.concatenate([
            net(torch.from_numpy(images[i:i + BATCH]).to(dev)).cpu().numpy()
            for i in range(0, N_REQUESTS, BATCH)])
    net.hybridize(False)
    prefix = os.path.join(SY_ROOT, "resnet50_v1")
    t0 = time.perf_counter()
    files = net.export(prefix, 0, input_specs=[((1, 3, 224, 224),
                                                "float32")])
    log(f"symbol (a): export of ResNet-50 v1 (traced on meta tensors) "
        f"{time.perf_counter() - t0:.3f} s; {os.path.getsize(files[0])} "
        f"bytes of JSON, {os.path.getsize(files[1])} bytes of params")
    server = Server.from_checkpoint(prefix, 0, config=ServerConfig(
        max_batch=BATCH, aot_prewarm=((3, 224, 224),)), ctx=ctx).start()
    graphs = report_prewarm(server, card)
    results, launches, stats = serve_burst(torch, server, images,
                                           {"conv_epilogue": 48}, card,
                                           "images", n_requests=N_REQUESTS)
    served = np.stack(results)
    rel = sy_rel(served, want)
    log(f"symbol (a): exported logits vs the Gluon net's graphed logits on "
        f"the card: relative {rel:.3e} of max |value| (tolerance "
        f"{GRAPH_RTOL:g})")
    if not rel <= GRAPH_RTOL:
        fail(f"exported ResNet-50 logits differ from the Gluon net's by "
             f"{rel} of max |value|")
    p4 = phase4["burst"]
    log(f"symbol (a): exported {stats['per_s']:.2f} images/s, p50 "
        f"{stats['p50']:.3f} ms, p99 {stats['p99']:.3f} ms; phase 4's "
        f"Gluon net {p4['per_s']:.2f} images/s, p50 {p4['p50']:.3f} ms, "
        f"p99 {p4['p99']:.3f} ms, on {card}")
    cpu_net = resnet50_v1()
    cpu_net.load_dict({k: v.detach().cpu().numpy()
                       for k, v in net.collect_params().items()},
                      ctx=mx.cpu())
    with torch.inference_mode():
        ref = np.concatenate([
            cpu_net(torch.from_numpy(images[i:i + BATCH])).numpy()
            for i in range(0, N_REQUESTS, BATCH)])
    check_against_cpu("exported logits", served, ref)
    return {"launches": launches, "burst": stats, "graphs": graphs,
            "rel_gluon": rel, "prefix": prefix}


def sy_bert(torch, mx, card, ctx):
    """(b): BERT-base exported, imported as a SymbolBlock and hybridized,
    at batch LONG_BATCH, S LONG_SEQ: the Gluon model's launches and
    outputs."""
    from mxnet_tpu_torch import kernels
    import numpy as np
    dev = ctx.torch_device
    net = seeded_bert(torch, mx, ctx, LONG_SEQ, (LONG_BATCH,),
                      max_length=LONG_SEQ)
    ids = np.random.RandomState(SEED).randint(
        0, BERT_VOCAB, (LONG_BATCH, LONG_SEQ)).astype(np.int32)
    x = torch.from_numpy(ids).to(dev)

    def counted(block):
        with torch.inference_mode():
            block(x)                     # captures the graph
            _sync(torch)
            kernels.reset_launch_counts()
            out = block(x)
            _sync(torch)
            launches = kernels.launch_counts()
            ms = event_ms(torch, lambda: block(x), 3)
        return out, launches, ms
    net.hybridize()
    want, gl_launches, gl_ms = counted(net)
    net.hybridize(False)
    prefix = os.path.join(SY_ROOT, "bert_12_768_12")
    net.export(prefix, 0, input_specs=[((LONG_BATCH, LONG_SEQ), "int32")])
    del net
    torch.cuda.empty_cache()
    block = mx.gluon.SymbolBlock.imports(
        f"{prefix}-symbol.json", ["data"], f"{prefix}-0000.params", ctx=ctx)
    block.hybridize()
    got, sy_launches, sy_ms = counted(block)
    for kernel, n in (("flash_attention", LONG_K3_PER_FORWARD),
                      ("matmul_epilogue", BERT_K2_PER_FORWARD)):
        if sy_launches[kernel] != gl_launches[kernel] or \
                sy_launches[kernel] != n:
            fail(f"imported BERT-base launched {kernel} "
                 f"{sy_launches[kernel]} times per forward, the Gluon model "
                 f"{gl_launches[kernel]} (want {n})")
    worst = 0.0
    for name, g, w in zip(("seq_out", "pooled", "nsp"), got, want):
        rel = sy_rel(g, w)
        worst = max(worst, rel)
        if not rel <= GRAPH_RTOL:
            fail(f"imported BERT-base {name} differs from the Gluon model's "
                 f"by {rel} of max |value|")
    log(f"symbol (b): BERT-base exported and imported (SymbolBlock, "
        f"hybridized) at batch {LONG_BATCH}, S {LONG_SEQ}: flash_attention "
        f"{sy_launches['flash_attention']}, matmul_epilogue "
        f"{sy_launches['matmul_epilogue']} launches per forward (the Gluon "
        f"model's: {gl_launches['flash_attention']}, "
        f"{gl_launches['matmul_epilogue']}); outputs within {worst:.3e} of "
        f"max |value| (tolerance {GRAPH_RTOL:g}); graphed forward "
        f"{sy_ms:.3f} ms (the Gluon model's {gl_ms:.3f} ms, CUDA events) "
        f"on {card}")
    del block, got, want
    torch.cuda.empty_cache()
    return {"launches": sy_launches, "rel": worst, "ms": sy_ms,
            "gluon_ms": gl_ms}


def sy_fuse_attention(torch, mx, card, ctx):
    """(c): batch_dot(softmax(batch_dot(q, k^T) * s), v) bound with and
    without MXNET_SUBGRAPH_BACKEND=FuseAttention at SY_FUSE."""
    from mxnet_tpu_torch import kernels
    S = mx.sym
    dev = ctx.torch_device
    q, k, v = S.var("q"), S.var("k"), S.var("v")
    scores = S.batch_dot(q, k, transpose_b=True) * SY_FUSE_SCALE
    att = S.batch_dot(S.softmax(scores, axis=-1), v)
    gen = mx.random.generator(SEED, device=dev)
    feed = {n: mx.nd.NDArray(torch.randn(SY_FUSE, device=dev,
                                         generator=gen)) for n in "qkv"}
    plain = att.bind(ctx, feed, grad_req="null")
    old = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "FuseAttention"
    try:
        fused = att.bind(ctx, feed, grad_req="null")
    finally:
        if old is None:
            del os.environ["MXNET_SUBGRAPH_BACKEND"]
        else:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    ops = sorted(n.op for n in fused._symbol._topo() if n.op)
    if ops != ["_contrib_flash_attention"]:
        fail(f"FuseAttention left {ops}")
    fused.forward()                       # captures
    plain.forward()
    _sync(torch)
    kernels.reset_launch_counts()
    out_f = fused.forward()[0]._data.clone()
    _sync(torch)
    launches = kernels.launch_counts()
    out_p = plain.forward()[0]._data
    if launches["flash_attention"] != 1:
        fail(f"the fused graph launched flash_attention "
             f"{launches['flash_attention']} times (want 1)")
    rel = sy_rel(out_f, out_p)
    if not rel <= SY_FUSE_RTOL:
        fail(f"fused attention differs from the unfused graph by {rel} of "
             "max |out|")
    fused_ms = event_ms(torch, fused.forward, 5)
    plain_ms = event_ms(torch, plain.forward, 5)
    log(f"symbol (c): FuseAttention at q, k, v {SY_FUSE} fp32: flash_"
        f"attention 1 launch, fused vs unfused {rel:.3e} of max |out| "
        f"(tolerance {SY_FUSE_RTOL:g}); bound executor forward fused "
        f"{fused_ms:.3f} ms, unfused {plain_ms:.3f} ms (CUDA events) on "
        f"{card}")
    del plain, fused, out_f, out_p, feed
    torch.cuda.empty_cache()
    return {"launches": launches, "rel": rel, "fused_ms": fused_ms,
            "plain_ms": plain_ms}


def sy_param_changes(torch, before, after):
    return {n: (after[n].detach().float() - before[n].float())
            for n in before}


def sy_module_fit(torch, mx, card, ctx, prefix):
    """(d): Module.fit on (a)'s exported ResNet-50 symbol + SoftmaxOutput
    over examples/train_imagenet.py's synthetic batch."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from torch.profiler import ProfilerActivity, profile
    import numpy as np
    dev = ctx.torch_device
    sym = mx.sym.SoftmaxOutput(mx.sym.load(f"{prefix}-symbol.json"),
                               name="softmax")
    arg_params, aux_params = mx.model.load_params(prefix, 0)
    rng = np.random.RandomState(0)      # examples/train_imagenet.py's batch
    x = rng.randn(SY_FIT_BATCH, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, (SY_FIT_BATCH,)).astype(np.float32)

    def iterator(n):
        return mx.io.NDArrayIter(np.concatenate([x] * n),
                                 np.concatenate([y] * n),
                                 batch_size=SY_FIT_BATCH)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # one step from the same state and batch: Module vs Trainer
        mod = mx.mod.Module(sym, context=ctx)
        it = iterator(1)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=arg_params, aux_params=aux_params)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(SY_STEP_SGD))
        before = {n: mod._exec.arg_dict[n]._data.clone()
                  for n in mod._param_names}
        batch = next(iter(it))
        mod.forward_backward(batch)
        g_mod = {n: mod._exec.grad_dict[n]._data.clone() for n in before}
        mod.update()
        d_mod = sy_param_changes(torch, before, {
            n: mod._exec.arg_dict[n]._data for n in before})
        # a change is stored in float32 beside its weight: its resolution
        # is one ulp of the weight, eps * max |w| of max |change|
        floor = max(float(torch.finfo(torch.float32).eps
                          * before[n].abs().max()
                          / d_mod[n].abs().max().clamp_min(1e-30))
                    for n in before)
        del mod, before
        net = resnet50_v1()
        net.load_dict({k: v.asnumpy() for k, v in
                       {**arg_params, **aux_params}.items()}, ctx=ctx)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(SY_STEP_SGD))
        params = dict(net.collect_params())
        before = {n: params[n].detach().clone() for n in d_mod}
        xb = torch.from_numpy(x).to(dev)
        yb = torch.from_numpy(y).to(dev)
        with mx.autograd.record():
            loss = loss_fn(net(xb), yb)
        mx.autograd.backward(loss)
        g_rel = max(sy_rel(g_mod[n], params[n].grad) for n in g_mod)
        trainer.step(SY_FIT_BATCH)
        d_gl = sy_param_changes(torch, before, params)
        worst, name = max((sy_rel(d_mod[n], d_gl[n]), n) for n in d_gl)
        if not worst <= SY_STEP_RTOL:
            fail(f"Module's step differs from the Trainer's by {worst} of "
                 f"max |change| ({name})")
        log(f"symbol (d): one step from the same state and batch: Module "
            f"vs gluon.Trainer parameter changes within {worst:.3e} of each "
            f"tensor's max |change| (worst {name}; {len(d_gl)} tensors; "
            f"tolerance {SY_STEP_RTOL:g}; float32 storage's floor "
            f"{floor:.3e}); gradients within {g_rel:.3e} of max |grad|; "
            "cuDNN deterministic")
        del net, trainer, loss, d_mod, d_gl, before, params, g_mod
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old

    fit_prefix = os.path.join(SY_ROOT, "fit")
    mod = mx.mod.Module(sym, context=ctx)
    marks, losses, counts = [], [], {}
    yi = torch.from_numpy(y.astype(np.int64)).to(dev)

    def batch_end(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        p = mod.get_outputs()[0]._data
        losses.append(float(-torch.log(
            p[torch.arange(SY_FIT_BATCH, device=dev), yi]).mean()))
        if len(marks) == 1:              # the first step captured
            kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mod.fit(iterator(SY_FIT_BATCHES), num_epoch=SY_FIT_EPOCHS,
            optimizer="sgd", optimizer_params=dict(SY_SGD),
            arg_params=arg_params, aux_params=aux_params,
            checkpoint_prefix=fit_prefix, keep_last=1,
            batch_end_callback=batch_end)
    fit_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    steps = SY_FIT_EPOCHS * SY_FIT_BATCHES
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"Module.fit losses {losses} are not {steps} finite values")
    want = dict.fromkeys(counts, 0)
    want["conv_epilogue"] = 48 * (steps - 1)
    if counts != want:
        fail(f"launches in Module.fit's {steps - 1} steps after the capture "
             f"{counts}, want {want} (48 conv_epilogue per training "
             "forward)")
    if mx.model.list_checkpoint_epochs(fit_prefix) != [SY_FIT_EPOCHS]:
        fail(f"checkpoints {mx.model.list_checkpoint_epochs(fit_prefix)} "
             f"with keep_last=1, want [{SY_FIT_EPOCHS}]")
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    final = {n: t._data.clone() for n, t in {
        **mod._exec.arg_dict, **mod._exec.aux_dict}.items()
        if n in mod._param_names or n in mod._aux_names}
    # the step alone, on a resident batch
    it = iterator(1)
    batch = next(iter(it))

    def step():
        mod.forward_backward(batch)
        mod.update()
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        step()
        torch.cuda.synchronize()
    calls = _launch_calls(prof.key_averages())
    step_ms = _median(times)
    log(f"symbol (d): Module.fit of exported ResNet-50 v1 + SoftmaxOutput, "
        f"batch {SY_FIT_BATCH}, fp32 (TF32 off), SGD lr "
        f"{SY_SGD['learning_rate']:g} momentum {SY_SGD['momentum']:g}, "
        f"{SY_FIT_EPOCHS} epochs of {SY_FIT_BATCHES} batches in "
        f"{fit_s:.1f} s: losses {[round(v, 4) for v in losses]}")
    log(f"symbol (d): per batch in fit (data, step, metric) after the "
        f"capture: median {_median(gaps):.3f} ms; the step alone "
        f"(forward_backward + update) median {step_ms:.3f} ms of "
        f"{[round(t, 3) for t in times]}, {SY_FIT_BATCH * 1e3 / step_ms:.1f} "
        f"images/s; conv_epilogue {counts['conv_epilogue'] // (steps - 1)} "
        f"launches per training forward; {calls} host launch calls per "
        f"step (graph replays and the per-parameter updates) on {card}")
    del mod
    torch.cuda.empty_cache()
    fresh = mx.mod.Module(sym, context=ctx)
    fresh.fit(iterator(SY_FIT_BATCHES), num_epoch=SY_FIT_EPOCHS,
              optimizer="sgd", optimizer_params=dict(SY_SGD),
              checkpoint_prefix=fit_prefix, keep_last=1, resume=True)
    got = {**fresh._exec.arg_dict, **fresh._exec.aux_dict}
    differ = [n for n, t in final.items() if not torch.equal(got[n]._data, t)]
    if differ:
        fail(f"fit(resume=True) restored {differ[:3]} not bit for bit")
    log(f"symbol (d): fit(resume=True) in a fresh Module restored all "
        f"{len(final)} parameters and statistics bit for bit")
    del fresh, got, final
    torch.cuda.empty_cache()
    return {"launches": counts, "steps_counted": steps - 1,
            "step_ms": step_ms, "fit_batch_ms": _median(gaps),
            "launch_calls": calls, "losses": losses, "step_rel": worst,
            "grad_rel": g_rel}


def sy_lenet(mx):
    """examples/train_mnist.py's lenet_symbol, with the port's mx."""
    sym = mx.sym
    data = sym.var("data")
    c1 = sym.Activation(sym.Convolution(data, kernel=(5, 5), num_filter=20),
                        act_type="tanh")
    p1 = sym.Pooling(c1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Activation(sym.Convolution(p1, kernel=(5, 5), num_filter=50),
                        act_type="tanh")
    p2 = sym.Pooling(c2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = sym.Flatten(p2)
    fc1 = sym.Activation(sym.FullyConnected(f, num_hidden=500),
                         act_type="tanh")
    fc2 = sym.FullyConnected(fc1, num_hidden=10)
    return sym.SoftmaxOutput(fc2, name="softmax")


def sy_mnist_iters(mx, batch_size):
    """examples/train_mnist.py's get_iters without MNIST files: its
    synthetic stand-in."""
    import numpy as np
    rng = np.random.RandomState(0)
    n = 2048
    x = rng.rand(n, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    for i in range(n):
        c = int(y[i])
        x[i, 0, (c // 4) * 7:(c // 4) * 7 + 7,
          (c % 4) * 7:(c % 4) * 7 + 7] += 2.0
    split = n - 512
    return (mx.io.NDArrayIter(x[:split], y[:split], batch_size,
                              shuffle=True),
            mx.io.NDArrayIter(x[split:], y[split:], batch_size))


def sy_mnist(torch, mx, card):
    """(e): examples/train_mnist.py --module as the example writes it."""
    import numpy as np
    np.random.seed(SEED)
    torch.manual_seed(SEED)
    cfg = SY_MNIST
    train, val = sy_mnist_iters(mx, cfg["batch_size"])
    t0 = time.perf_counter()
    mod = mx.mod.Module(sy_lenet(mx),
                        context=mx.context.current_context())
    mod.fit(train, eval_data=val, num_epoch=cfg["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"], "momentum": 0.9},
            initializer=mx.init.Xavier(),
            batch_end_callback=mx.callback.Speedometer(cfg["batch_size"],
                                                       50))
    acc = mod.score(val, "acc")[0][1]
    secs = time.perf_counter() - t0
    log(f"symbol (e): examples/train_mnist.py --module (lenet_symbol, the "
        f"synthetic stand-in, batch {cfg['batch_size']}, {cfg['epochs']} "
        f"epochs, lr {cfg['lr']:g}) on {mx.context.current_context()}: "
        f"final accuracy {acc:.4f} in {secs:.1f} s on {card}")
    if not acc >= SY_MNIST_ACC:
        fail(f"LeNet --module accuracy {acc} < {SY_MNIST_ACC}")
    return {"acc": acc, "seconds": secs}


def phase_symbol(torch, mx, card, ctx, phase4):
    """Phase 30: mx.sym, mx.mod and export on the card (a)-(e)."""
    import shutil
    shutil.rmtree(SY_ROOT, ignore_errors=True)
    os.makedirs(SY_ROOT)
    out = {}
    try:
        for key, fn in (("a", lambda: sy_serve_resnet(torch, mx, card, ctx,
                                                      phase4)),
                        ("b", lambda: sy_bert(torch, mx, card, ctx)),
                        ("c", lambda: sy_fuse_attention(torch, mx, card,
                                                        ctx)),
                        ("d", lambda: sy_module_fit(torch, mx, card, ctx,
                                                    out["a"]["prefix"])),
                        ("e", lambda: sy_mnist(torch, mx, card))):
            t0 = time.perf_counter()
            out[key] = fn()
            log(f"phase 30 ({key}): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(SY_ROOT, ignore_errors=True)
    return out


def main():
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        fail(f"no mxnet_tpu_torch package beside {__file__}: run from the "
             "root of a checkout")
    sys.path.insert(0, ROOT)
    import torch
    card = phase_card(torch)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import conv_epilogue as ce
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.kernels import matmul_epilogue as me
    out = {}
    t_start = time.perf_counter()

    def run(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")

    run("build", phase_build)
    run("kernel K1", lambda: phase_kernel_k1(torch, ce))
    run("serve ResNet", lambda: phase_serve_resnet(torch, mx, card,
                                                   mx.gpu(0)))
    run("kernel K2", lambda: phase_kernel_k2(torch, me))
    run("serve BERT", lambda: phase_serve_bert(torch, mx, card, mx.gpu(0)))
    run("kernel K3", lambda: phase_kernel_k3(torch, fa))
    run("serve long BERT", lambda: phase_serve_long_bert(torch, mx, card,
                                                         mx.gpu(0)))
    run("kernel K3 backward", lambda: phase_kernel_k3_bwd(torch, fa))
    run("kernel K2 training", lambda: phase_kernel_k2_train(torch, mx, me))
    run("train long BERT", lambda: phase_train_long_bert(torch, mx, card,
                                                         mx.gpu(0)))
    run("kernel K1 training", lambda: phase_kernel_k1_train(torch, ce))
    run("train ResNet", lambda: phase_train_resnet(torch, mx, card,
                                                   mx.gpu(0)))
    run("kernel bf16", lambda: phase_kernel_bf16(torch, ce, me))
    run("train-sharded", lambda: phase_train_sharded(torch, mx, card,
                                                     mx.gpu(0)))
    run("train-recipe", lambda: phase_train_recipe(torch, mx, card,
                                                   mx.gpu(0)))
    run("train-checkpoint", lambda: phase_train_checkpoint(torch, mx, card,
                                                           mx.gpu(0)))
    run("train-remat", lambda: phase_train_remat(torch, mx, card,
                                                 mx.gpu(0)))
    run("serve-reload", lambda: phase_serve_reload(torch, mx, card,
                                                   mx.gpu(0)))
    run("serve-pool", lambda: phase_serve_pool(
        torch, mx, card, mx.gpu(0), out["serve BERT"]["burst"]))
    run("serve-decode", lambda: phase_serve_decode(torch, mx, card,
                                                   out["serve-pool"]))
    run("trace", lambda: phase_trace(torch, mx, card, mx.gpu(0),
                                     out["serve-pool"]))
    run("serve-fleet", lambda: phase_serve_fleet(torch, mx, card,
                                                 mx.gpu(0)))
    run("serve-deploy", lambda: phase_serve_deploy(torch, mx, card,
                                                   mx.gpu(0)))
    run("layers", lambda: phase_layers(torch, mx, card, mx.gpu(0)))
    run("serve-zoo", lambda: phase_serve_zoo(torch, mx, card, mx.gpu(0)))
    run("train-zoo", lambda: phase_train_zoo(torch, mx, card, mx.gpu(0)))
    run("nd", lambda: phase_nd(torch, mx, card, mx.gpu(0)))
    run("item 6", lambda: phase_item6(torch, mx, card, mx.gpu(0), ce, me))
    run("symbol", lambda: phase_symbol(torch, mx, card, mx.gpu(0),
                                       out["serve ResNet"]))
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    k1, s1 = out["kernel K1"], out["serve ResNet"]
    k2, s2 = out["kernel K2"], out["serve BERT"]
    k3, s3 = out["kernel K3"], out["serve long BERT"]
    k1_launches, k2_launches, k3_launches = (s["launches"]
                                             for s in (s1, s2, s3))
    k3b, train = out["kernel K3 backward"], out["train long BERT"]
    k1t, rn = out["kernel K1 training"], out["train ResNet"]
    kb, sh = out["kernel bf16"], out["train-sharded"]
    rc, ck = out["train-recipe"], out["train-checkpoint"]
    rm, rl = out["train-remat"], out["serve-reload"]
    pl, dc = out["serve-pool"], out["serve-decode"]
    tr, fl, dp = out["trace"], out["serve-fleet"], out["serve-deploy"]
    sz, tz = out["serve-zoo"], out["train-zoo"]
    ndk = out["nd"]
    it6 = out["item 6"]
    sy = out["symbol"]

    def symbolic(kernel):
        """The kernel's launches on phase 30's symbolic path: (a) the
        exported ResNet-50's served burst, (b) one forward of the imported
        BERT-base, (c) one fused-attention forward, (d) Module.fit's
        steps after the capture."""
        runs = {"a_served_exported_resnet50": sy["a"]["launches"][kernel],
                "b_imported_bert_per_forward": sy["b"]["launches"][kernel],
                "c_fused_attention_per_forward":
                    sy["c"]["launches"][kernel],
                "d_module_fit": sy["d"]["launches"][kernel]}
        return {"symbol_launches": runs,
                "symbol_per": f"phase 30: (a) {N_REQUESTS} requests of "
                              "Server.from_checkpoint(ResNet-50 v1), 48 "
                              "per batch forward; (b) batch "
                              f"{LONG_BATCH}, S {LONG_SEQ}; (c) q, k, v "
                              f"{SY_FUSE}; (d) {sy['d']['steps_counted']} "
                              f"training steps at batch {SY_FIT_BATCH}"}

    def item6(kernel):
        """The kernel in phase 29: launches under amp.init's bf16 list in
        (a1) BERT-base and (a2) ResNet-50 over AM_STEPS steps, in (b)'s
        eager foreach and (c)'s sparse model; K1/K2's times with vectors
        at another dtype than y's (k)."""
        runs = {"a1_bert_bf16_list": it6["a1"]["launches"][kernel],
                "a2_resnet_bf16_list": it6["a2"]["launches"][kernel]}
        if kernel == "matmul_epilogue":
            runs["b_foreach_eager"] = it6["b"]["k2"]
            runs["c_sparse"] = it6["c"]["k2"]
        row = {"item6_launches": runs,
               "item6_per": f"phase 29: {AM_STEPS} eager Trainer steps of "
                            "(a1) and (a2) under amp.init('bfloat16', "
                            "target_precision_ops=['FullyConnected', "
                            f"'Convolution']); (b) {CF_STEPS} eager steps; "
                            f"(c) {SP_STEPS} steps"}
        mixed = [r for r in it6["k"]
                 if r["kernel"] == {"conv_epilogue": "K1",
                                    "matmul_epilogue": "K2"}.get(kernel)]
        if mixed:
            row["mixed_dtype"] = [
                {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in r.items()} for r in mixed]
        return row

    def nd_launches(kernel):
        """The kernel's launches through mx.nd in phase 28: per call of
        (b), and per forward of (c)'s hybridized ResNet-50 on an
        nd.array."""
        calls = {what: c[kernel] for what, c in ndk["kernels"].items()
                 if kernel in c}
        if kernel in ndk["resnet"]:
            calls["hybridized ResNet-50 v1, nd.array batch 8, per "
                  "forward"] = ndk["resnet"][kernel]
        return {"nd_launches": calls,
                "nd_per": "phase 28: one mx.nd call of each (b) case at "
                          "full width, bit-equal to the ops call"}

    def remat(kernel):
        """The kernel's launches per graphed step of (c) under each remat
        policy (phase 18): the recompute launches the forward kernels
        again."""
        return {"train_remat_launches_per_step": {
                    p: r["per_step"][kernel] for p, r in rm.items()
                    if p != "resnet"},
                "train_remat_per": "one graphed step of (c), BERT-base MLM "
                                   f"at batch 4, S {LONG_SEQ}, bf16, by "
                                   "remat policy"}

    def sharded(kernel, cfgs):
        """The kernel in the train-sharded phase: launches across each
        configuration's steps (and the capture's warm-up passes), its
        time in one profiled graphed step."""
        return {"train_sharded_launches": {
                    c: sh[c]["launches"][kernel] for c in cfgs},
                "train_sharded_ms": {c: sh[c]["kernel_ms"][kernel]
                                     for c in cfgs},
                "train_sharded_per": "launches: the ShardedTrainer steps "
                                     "and the capture's warm-up passes; ms: "
                                     "one profiled graphed step, bfloat16"}

    def bf16_row(r, per):
        return {"bf16": {**{k: v for k, v in r.items()
                            if k != "library_kernel"}, "per": per,
                         "bound_rate": "bytes at 3.35 TB/s with 2-byte "
                                       "elements, operations at 989 "
                                       "TFLOP/s (bf16 tensor cores)"}}

    def graphed_fields(serve, kernel):
        """The kernel inside the served graphs: launches across replays
        in the burst (every served batch replayed a graph) and its device
        time per graphed forward (None where the profiler saw no
        graph kernels)."""
        prof = serve["profile"]
        return {"graph_launches": serve["launches"][kernel],
                "graph_ms": prof["graphed"]["kernel_ms"],
                "eager_ms_in_forward": prof["eager"]["kernel_ms"],
                "graph_per": "one graphed (CUDA graph replay) forward of "
                             "the served model, the profiler's sum"}

    def graphed_train(run, kernel):
        rows = run["graphed"].get("dev_rows") or {}
        ms = [v[1] for k, v in rows.items() if _is_kernel(k, kernel)]
        return {"graph_train_launches": run["graphed"]["launches"][kernel],
                "graph_train_ms": sum(ms) if ms else None,
                "graph_train_per": GRAPH_TRAIN_PER}

    def half_rows(which):
        """One backward kernel's 16-bit design (wgmma at the slice's D 64):
        its bf16 and fp16 rows at the slice shape."""
        rows = {}
        for key, name in (("bf16", "bfloat16"), ("fp16", "float16")):
            r = k3b[name]
            rows[key] = {
                "ms": r[f"{which}_ms"], "bound_ms": r[f"bound_{which}"],
                "bound_by": r["bound_by"], "bound_share": r[f"share_{which}"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "max_abs_err": r[f"err_{which}"], "max_rel_err": r["rel"],
                "max_rel_err_vs_round_to": r["rel_round"],
                "pair_tflops_7_products": r["tflops_7"],
                "pair_vs_library": r["vs_library"],
                "per": f"one training step at batch 4, S 4096, {name} (12 "
                       "launches); plain and library: dq, dk and dv "
                       "together",
                "bound_rate": "bytes at 3.35 TB/s with 2-byte elements, "
                              "operations at 989 TFLOP/s (16-bit tensor "
                              "cores)"}
        return rows

    def k3_half_rows():
        """The forward's 16-bit design (wgmma at the slice's D 64): its
        bf16 and fp16 rows at the slice shape."""
        rows = {}
        for key, name in (("bf16", "bfloat16"), ("fp16", "float16")):
            r = k3[key]
            rows[key] = {
                **{k: v for k, v in r.items() if k != "library_kernel"},
                "per": f"one BERT-base forward at batch {LONG_BATCH}, S "
                       f"{LONG_SEQ}, {name} ({LONG_K3_PER_FORWARD} "
                       "launches); library: scaled_dot_product_attention "
                       f"in {name}",
                "bound_rate": "bytes at 3.35 TB/s with 2-byte elements, "
                              "operations at 989 TFLOP/s (16-bit tensor "
                              "cores)"}
        return rows

    bwd_per = (f"one BERT-base training step at batch {LONG_BATCH}, "
               f"sequence {LONG_SEQ}, float32 ({LONG_K3_PER_FORWARD} "
               "launches)")
    bwd_common = {
        "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_attention_bwd.cu",
        "plain_ms": k3b["plain_ms"], "bound_by": k3b["bound_by"],
        "library_ms": k3b["library_ms"], "status": "ok", "per": bwd_per,
        "plain_covers": "flash_attention_bwd_plain computes dq, dk and dv "
                        "together: the same time on both backward rows",
        "library_covers": "the backward of torch.nn.functional.scaled_dot_"
                          "product_attention on the same inputs as [B, H, "
                          "S, D], dq, dk and dv together; its kernel: "
                          + k3b["library_kernel"][:80],
        "bound_ms_both_kernels": k3b["bound_both"],
        "bound_ms_3xtf32_both_kernels": k3b["bound_both_3xtf32"],
        "tflops_7_products": k3b["tflops_7"],
        "delta_ms": k3b["delta_ms"]}
    line = {"kernels": [{
        "name": "conv_epilogue", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/conv_epilogue.cu",
        "replaces": "mxnet_tpu/pallas/kernels.py:126",
        "launches": k1_launches["conv_epilogue"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "status": "ok",
        "per": f"one ResNet-50 v1 forward at batch {BATCH}, float32 "
               "(48 launches)",
        "max_abs_err_bf16": k1["max_abs_err_bf16"],
        "max_abs_err_ragged_fp32": k1["max_abs_err_ragged_fp32"],
        "train_launches": rn["launches"]["conv_epilogue"],
        "train_launches_per_step": rn["launches"]["conv_epilogue"]
        // TRAIN_STEPS,
        "train_per": f"one ResNet-50 v1 training step at batch {RN_BATCH}, "
                     "float32",
        "backward_route": "VJP of the plain version in PyTorch ops "
                          "(launches no kernel of its own)",
        "train_fwd_bwd_ms": k1t["ms"], "train_fwd_bwd_plain_ms":
        k1t["plain_ms"], "train_fwd_bwd_bound_ms": k1t["bound_ms"],
        "train_fwd_bwd_bound_by": "bytes",
        "train_grad_max_rel_err": k1t["grad_rel"],
        "train_grad_max_rel_err_bf16": k1t["grad_rel_bf16"],
        **graphed_fields(s1, "conv_epilogue"),
        "graph_train_launches": rn["graphed"]["launches"]["conv_epilogue"],
        "graph_train_ms": rn["graphed"]["k1_ms"],
        "graph_train_per": GRAPH_TRAIN_PER,
        **bf16_row(kb["k1"], f"one ResNet-50 v1 forward at batch "
                   f"{SH_RN_BATCH}, bfloat16 (48 launches)"),
        **sharded("conv_epilogue", ("a",)),
        "train_remat_launches": rm["resnet"]["k1_launches"],
        "train_remat_per": "the capturing graphed step of (a), ResNet-50 "
                           f"v1 at batch {SH_RN_BATCH}, bf16, under None "
                           "and remat=\"dots\" (its 2 eager warm-up passes "
                           "and the capture's replay)",
        **nd_launches("conv_epilogue"),
        **item6("conv_epilogue"), **symbolic("conv_epilogue")}, {
        "name": "matmul_epilogue", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "replaces": "mxnet_tpu/pallas/kernels.py:285",
        "launches": k2_launches["matmul_epilogue"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
        "status": "ok",
        "per": f"one BERT-base forward at batch {BATCH}, sequence "
               f"{BERT_SEQ}, float32 ({BERT_K2_PER_FORWARD} launches)",
        "library_covers": "torch.add(y, bias) for the 12 identity "
                          "launches of a forward; no single PyTorch call "
                          "computes the gelu and tanh epilogues",
        "ms_identity": k2["ms_identity"],
        "max_abs_err_p0_fp32": k2["max_abs_err_p0_fp32"],
        "max_abs_err_bf16": k2["max_abs_err_bf16"],
        **graphed_fields(s2, "matmul_epilogue"),
        **graphed_train(train, "matmul_epilogue"),
        **bf16_row(kb["k2"], f"one BERT-base MLM training forward at batch "
                   f"{SH_BERT['b'][0]}, S {SH_BERT['b'][1]}, bfloat16 (12 "
                   "ffn_1 gelu, 12 ffn_2 dropout 0.1); no PyTorch call "
                   "computes dropout(act(y + bias)) with given bits: "
                   "library_ms null, bias_add_ms beside it"),
        **sharded("matmul_epilogue", ("b", "c")),
        "train_recipe_launches": rc["launches"]["matmul_epilogue"],
        "train_recipe_ms": rc["k2_ms"],
        "train_recipe_per": f"launches: {RC_WINDOWS} run_steps windows of "
                            f"{RC_WINDOW} steps of the BERT-base LAMB recipe "
                            "(one graph replay each); ms: one profiled "
                            "window",
        "train_checkpoint_launches": ck["launches"]["matmul_epilogue"],
        "train_checkpoint_per": f"windows 2-{CK_WINDOWS} of the recipe, "
                                "each followed by a committed checkpoint",
        **remat("matmul_epilogue"),
        "serve_reload_launches": rl["launches"],
        "serve_reload_per_forward": rl["k2_per_forward"],
        "serve_reload_per": "launches: the 32-request burst of the "
                            "hot-reloading BERT-base MLM server at S "
                            f"{RC_SEQ}, fp32, before any reload",
        "serve_pool_launches": pl["launches"],
        "serve_pool_per_forward": pl["k2_per_forward"],
        "serve_pool_worker_launches": pl["procs"]["k2"],
        "serve_decode_launches": dc["k2"],
        "trace_launches": {m: r["k2"] for m, r in tr["cost"].items()},
        "trace_launches_fixed": {m: r["k2_fixed"]
                                 for m, r in tr["cost"].items()},
        "trace_train_launches": {m: r["k2"] for m, r in tr["sync"].items()},
        "serve_fleet_launches": fl["launches"],
        "serve_fleet_per": f"the fleet burst: {fl['batches']} batch "
                           f"forwards of three BERT-base tenants at S "
                           f"{BERT_SEQ} (fp32 and bf16) and the "
                           f"{fl['warmup']} warm-up passes of each of "
                           f"{fl['captures']} captures, 25 each",
        "serve_zoo_launches": {m: r["launches"]["matmul_epilogue"]
                               for m, r in sz.items()},
        "serve_zoo_per": f"{SZ_REQUESTS} single-image requests per model "
                         "of phase 26, fp32: 2 per batch forward in vgg16 "
                         "and alexnet (fc6 and fc7), 0 elsewhere",
        "train_zoo_launches": {m: r["launches"]["matmul_epilogue"]
                               for m, r in tz.items()},
        "train_zoo_per": f"{SH_RN_STEPS} bf16 ShardedTrainer steps at "
                         f"batch {SH_RN_BATCH} and the capture's warm-up "
                         "passes: 2 per step in vgg16_bn, 0 in "
                         "mobilenetv2_1.0",
        "serve_deploy_launches": dp["launches"],
        "serve_deploy_per": f"the good deploy's traffic: {dp['batches']} "
                            "batch forwards of the BERT-base encoder at S "
                            f"{BERT_SEQ} on two replicas, "
                            f"{DP_K2_PER_FORWARD} each",
        "trace_per": f"launches: {TR_ROUNDS} bursts of phase 6's "
                     f"{N_REQUESTS} requests per MXNET_TPU_TRACE mode; "
                     f"fixed: {N_REQUESTS // BATCH} batches of {BATCH} "
                     "sent one at a time, per mode; "
                     f"train: {TR_STEPS} graphed steps of the BERT-base MLM "
                     f"at batch {TR_TRAIN_BATCH}, S {BERT_SEQ}, bf16, per "
                     "mode",
        "serve_pool_per": f"launches: burst 1 of {PL_REQUESTS} requests "
                          "through the Router over two BERT-base "
                          f"LocalReplicas at S {BERT_SEQ}, fp32 (graph "
                          "replays on both); worker: the subprocess mlp "
                          "replicas' burst A, 1 per batch forward, read "
                          "from their stats frames; decode: the BERT "
                          "burst beside 64 TinyLM streams",
        **nd_launches("matmul_epilogue"),
        **item6("matmul_epilogue"), **symbolic("matmul_epilogue")}, {
        "name": "flash_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/ops/contrib.py:316 (K3); "
                    "mxnet_tpu/pallas/kernels.py:483 (K3')",
        "launches": k3_launches["flash_attention"],
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
        "status": "ok",
        "bound_ms_3xtf32": k3["bound_ms_3xtf32"],
        "bound_share": k3["bound_share"],
        "bound_share_3xtf32": k3["bound_share_3xtf32"],
        "per": f"one BERT-base forward at batch {LONG_BATCH}, sequence "
               f"{LONG_SEQ}, float32 ({LONG_K3_PER_FORWARD} launches)",
        "library_covers": "torch.nn.functional.scaled_dot_product_attention"
                          " on the same inputs as [B, H, S, D]; its kernel: "
                          + k3["library_kernel"][:80],
        **graphed_fields(s3, "flash_attention"),
        **graphed_train(train, "flash_attention"),
        **k3_half_rows(),
        **sharded("flash_attention", ("c",)),
        **remat("flash_attention"), **nd_launches("flash_attention"),
        **item6("flash_attention"), **symbolic("flash_attention")}, {
        "name": "flash_attention_bwd_dkv",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:"
                    "1121 (_flash_attention_bwd_dkv) via "
                    "mxnet_tpu/ops/contrib.py:316",
        "launches": train["launches"]["flash_attention_bwd_dkv"],
        "max_abs_err": k3b["err_dkv"], "ms": k3b["dkv_ms"],
        "bound_ms": k3b["bound_dkv"], **bwd_common,
        "bound_ms_3xtf32": k3b["bound_dkv_3xtf32"],
        "bound_share": k3b["share_dkv"],
        "bound_share_3xtf32": k3b["share_dkv_3xtf32"],
        "max_rel_err": k3b["rel"],
        **graphed_train(train, "flash_attention_bwd_dkv"),
        **half_rows("dkv"),
        **sharded("flash_attention_bwd_dkv", ("c",)),
        **remat("flash_attention_bwd_dkv"),
        **nd_launches("flash_attention_bwd_dkv"),
        **item6("flash_attention_bwd_dkv"),
        **symbolic("flash_attention_bwd_dkv")}, {
        "name": "flash_attention_bwd_dq",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:"
                    "1456 (_flash_attention_bwd_dq) via "
                    "mxnet_tpu/ops/contrib.py:316",
        "launches": train["launches"]["flash_attention_bwd_dq"],
        "max_abs_err": k3b["err_dq"], "ms": k3b["dq_ms"],
        "bound_ms": k3b["bound_dq"], **bwd_common,
        "bound_ms_3xtf32": k3b["bound_dq_3xtf32"],
        "bound_share": k3b["share_dq"],
        "bound_share_3xtf32": k3b["share_dq_3xtf32"],
        "max_rel_err": k3b["rel"],
        **graphed_train(train, "flash_attention_bwd_dq"),
        **half_rows("dq"),
        **sharded("flash_attention_bwd_dq", ("c",)),
        **remat("flash_attention_bwd_dq"),
        **nd_launches("flash_attention_bwd_dq"),
        **item6("flash_attention_bwd_dq"),
        **symbolic("flash_attention_bwd_dq")}]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
