"""On-card smoke run of the PyTorch/CUDA port (mxnet_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, for the sm_90a kernels) and nvcc; exits
non-zero, printing no result, without them.  Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compiles the hand-written CUDA kernels from the checkout, one
   nvcc per source, with each kernel's registers, spills and static
   shared memory from ptxas, and the number of kernels that spill;
3. kernels: each compression kernel against its plain PyTorch version on
   the card (bit-exact), as a batch of one at 1000, 16384, 16384*7+3
   elements and at the element count of resnet50_v1's trainable
   parameters, with CUDA-event times beside the HBM bound; then one launch
   of each over a ragged batch of 1, 3, 127, 16385 and 16384*7+3 elements
   whose gradients sit 0, 1 and 2 elements past a 16-byte boundary of one
   buffer (the misaligned ones shown to take the kernel's element-by-
   element path), for two pushes that carry the residual arena over; and
   a KVStore push of one key twice in one list, twice, on the card and
   on the CPU, bit for bit;
4. slice: resnet50_v1 (full width, f32, TF32 off), batch 32 of 3x224x224
   synthetic data from a seed, 5 steps of gluon Trainer + KVStore('device')
   + 2-bit compression (t 0.5) with update_on_kvstore: loss finite and
   falling, each kernel launched once a step (one batched launch per
   push over all 193 keys), both kernels bit-exact with the batched plain
   version on the real step-1 gradients of all 193 keys in one call
   (codes, residual arena, dequantized values), the times of one batched
   launch of each over those keys, and a small ResNet's logits on the
   card agreeing with the port on the CPU;
5. flash: both flash-attention kernels (flash_attention.cu, f32
   arithmetic on the CUDA cores, for f32 inputs and for bf16 inputs with
   D > 256; flash_attention_bf16.cu, tensor cores, for bf16 up to D 256)
   against their plain version (TF32 off, f32 matmuls "highest") at the
   LM config's width (d_model 512, 8 heads: D 64, tools/bench_lm.py) at
   (32, 512, 8, 64) causal and not and at the long context
   (1, 16384, 8, 64), at D 16 and 128, and at the wide head dims
   (1, 1024, 4, 320) and (2, 512, 2, 512) causal and not; each call
   launching its kernel exactly once; f32 within 5e-5 (o) and 1e-4
   (lse); bf16 o within 3e-2 of the f32 plain version on the same values
   and within 2^-8 (|o| + (P/l)|V|) + 5e-5 of it elementwise, bf16 lse
   within 1e-4; dq/dk/dv through the autograd Function within 5e-4 of
   plain autograd;
6. sp: the sequence-parallel path on a one-card mesh make_mesh({"sp": 1}):
   ulysses_attention_sharded(use_flash=True) and
   ring_attention_sharded(use_flash=True) at the long context in f32 and
   in bf16, each within the kernel's bound of local_attention on the same
   values in f32 (5e-5 in f32, the elementwise bf16 bound in bf16) and
   each call launching its type's kernel exactly once; with telemetry on
   for those calls, COLLECTIVE_BYTES{sp} equal to the engines' counts
   (4 x q's bytes an all_to_all call, K + V a ppermute call) and
   MESH_DEVICES{sp} 1;
7. sharded: the benchmark of record's training path (bench.py:40-99):
   resnet50_v1 (full width, classes 1000, Xavier), SoftmaxCrossEntropyLoss,
   sgd lr 0.1 momentum 0.9, batch 256 of 3x224x224 synthetic data from
   RandomState(0), through parallel.ShardedTrainer under bf16_mixed: 2
   warm-up steps, 8 synchronous steps (the loss read each step), then
   configure_overlap(async_metrics=True, steps_per_call=4), one warm
   step_many and 2 timed step_many calls under
   torch.cuda.set_sync_debug_mode("error") (no host sync on the dispatch
   path); images/s per phase, step-time median, peak memory, losses, the
   loss scale and skips; every loss finite, the last below the first
   kept one, the trainer's state on the card; one more step_many(4)
   under torch.profiler for the split of a step's kernel time into the
   trainer's forward, backward and update ranges, the card's idle share
   against the timed async steps, and the kernel time by kind; then
   the small ResNet's f32 ShardedTrainer losses on
   the card against the CPU (rtol 1e-5), the non-finite guard on a NaN
   batch, and step_many(3) bit for bit equal to 3 steps with
   deterministic cuDNN.  Then the same trainer with the observability
   layer: 4 sync steps with it off, then telemetry, tracing, events and
   a goodput ledger on (the MFU peak set to the data sheet's dense bf16
   989 TFLOP/s), one step (which also counts the step's FLOPs), 4 sync
   steps and one step_many(4) under the sync-debug mode: TRAIN_STEPS
   equal to the steps run, step_breakdown()'s five buckets within 1% of
   span + gap, TRAIN_STEP_FLOPS and TRAIN_MFU set, one train_step event
   a dispatch, the goodput report's steps; then one step between
   profiler.start() and stop() and dump(): profile.json holds the
   ShardedTrainer.step span and the <filename>_trace/ device trace
   cuDNN/cuBLAS kernel events; an 'observed' line with the step median
   off and on;
8. decode: the LM serving path at tools/bench_decode.py's accelerator
   width (vocab 32000, d_model 512, 8 heads, 8 layers, d_ff 2048,
   max_len 256; Xavier from a seed): GenerationEngine(slots=16,
   cache_len=256) greedy, 16 prompts of 16 tokens, one a slot, then 48
   decode steps, in f32 (TF32 off) and under bf16_mixed.  f32: every
   step's logits within 1e-4 + 1e-4 |ref| of net(tokens) at that
   position over the prompt and the tokens so far, each prefill's too
   (and whether the padded bucket gave them bit for bit), and the tokens
   equal to the full forward's argmax wherever its top-2 gap is above
   1e-3 (the positions left out counted); a lane with cache_len 64 runs
   to at_capacity past the ring.  bf16_mixed: a bf16 cache, and logits
   within 0.12 + 0.05 |ref| of the policy's prefill of the same
   sequences.  A TokenServer over the bf16 engine answers 16 requests of
   max_new_tokens 32, all finishing by 'length' with the engine's own
   tokens, with telemetry, tracing and events on: 16 'ok' token_request
   wide events with queue, prefill and decode stages, and DECODE_TOKENS
   the tokens served less each request's first (its prefill's);
   tests/test_generate.py's small LM gives the same f32 logits
   (within 1e-5 of the largest) and greedy tokens on the card as on the
   CPU; the path launches no hand-written kernel.  A 'decode' line per
   policy: prefill ms per admit (median), step ms (median), tokens/s
   (16 x steps / their time), the profile of 8 more steps (kernels a
   step, the card's kernel time against the host's step, idle share),
   peak memory;
9. paged: the paged KV-cache path on phase 8's LM: PagedGenerationEngine(
   slots=16, cache_len=256, page_size=16, prefill_chunk=32) greedy f32 on
   phase 8's prompts for 48 steps, every logit within 1e-4 + 1e-4 |ref|
   of phase 8's ring engine and the tokens equal where the ring's top-2
   gap is above 1e-3 (the positions left out counted; where two paths
   part at such a tie a pair is compared no further); a 160-token prompt
   in chunks of 16 against one chunk of 160, within the same bound;
   bench_decode --prefix-share's shape through a TokenServer (8 users,
   a 112-token system prompt + 8-token tails, 32 new tokens) at 4 slots,
   its CPU value (8 on an accelerator, :422-423; cut), tokens equal with
   sharing on and off, the hit rate; --spec's shape (2 slots, a
   repetitive 24-token prompt, 160 tokens, k 4, ngram 3), greedy
   tokens equal to spec off, accepted tokens a verify step, and a sampled
   run (temperature 0.8, top_k 40) bit-equal with spec on and off under
   one seed; bf16_mixed with a bf16 pool, logits within 0.12 + 0.05
   |ref| of the policy's prefill; a TokenServer with every lever on
   answering the 16 prompts with a ring server's tokens; no hand-written
   kernel launched.  A 'paged' line: prefill-chunk ms, step ms (beside
   the ring's), tokens/s, pages in use, the profile of 8 steps, peak
   memory;
9b. serve: the serving tier (serving, serving_async, gateway,
   tools.quantize_model) with telemetry and events on.  (a) resnet50_v1
   at full width (classes 1000, Xavier from seed 0) through
   Predictor.from_block on uint8 (32, 3, 224, 224) batches from
   RandomState(0) normalized on the card (uint8_normalizer), chain 8: 16
   batches and a ragged one of 5 rows, in order, the ragged one 5 rows;
   f32 (TF32 off) logits within 1e-5 x max|logit| of the eager forward on
   the same normalized batch; under bf16_mixed the top-5 postprocess
   equal to the top-5 of the bf16 logits, and bf16 top-1 equal to f32's
   on every row whose f32 top-1/top-2 gap exceeds twice the largest
   |bf16 - f32| logit difference (and on at least that share of rows);
   images/s host-fed uint8 and card-resident, the forward's ms at batch
   32; no host sync flagged over one chunk by set_sync_debug_mode("warn").
   (b) python -m mxnet_tpu_torch.tools.quantize_model --model resnet50
   --batch 32 on the card (its own process, beside (a)'s checks): exit
   0, --check passing; the artifact through Predictor.from_symbol: one
   int8 forward launching int8_conv once per quantized layer, each
   distinct layer shape bit-equal to int8_conv_plain at batch 2 and at
   the route's batch 32, the int8 forward's ms.  (c) AsyncPredictor over two bf16 replicas on the
   card: 64 requests of 1-8 rows from 4 threads, each answer's top-5
   equal to the direct Predictor's, p50/p99 latency; a full queue
   failing Overloaded("queue") and an expired request
   DeadlineExceeded("queue") on a replica stalled through
   testing.faults.StallingCallable; a stalled replica ejected and its
   request answered by the other; close() draining a burst.  (d)
   serve_gateway(port=0) with /v1/predict/resnet50 (the bf16 replicas
   behind serving_async.ContractRows, rows sent as JSON numbers 0..255),
   /v1/predict/resnet50_int8 and
   /v1/generate/lm (a TokenServer(slo_ms=2000) on phase 8's LM, greedy)
   through urllib: 8 requests of 2 rows 200 with the in-process top-5, a
   32-row int8 request 200 bit-equal to the int8 Predictor, an SSE
   stream of the TokenServer.submit tokens, 404, 413, 429 with
   Retry-After for a tenant over its quota, /healthz 200 and then 503
   while stop_gateway(drain=True) drains an open stream, /metrics with
   the GATEWAY_* and SERVING_* series, gateway_request events.  A
   'serve' line of these numbers and peak memory; int8_conv's launches
   on this path (the kernel-vs-plain check's left out) are the kernels
   line's serve_launches, no other kernel launched;
10. zoo: one network per vision family at ImageNet width (alexnet,
   vgg16, resnet50_v2, densenet121, squeezenet1.1, mobilenet1.0 and
   mobilenetv2_1.0 at 3x224x224, inceptionv3 at 3x299x299; classes 1000,
   Xavier from a seed, batch 32, f32 with TF32 off) through the port's
   examples/train_imagenet.py entry, --benchmark 1, eager
   (train(hybridize=False); phase 13 measures hybridize()), sgd lr 0.01 momentum
   0.9, 1 warm-up + 5 steps: every loss finite, the last below the first
   for the families without Dropout, every step on the fused SGD update,
   parameters, gradients and optimizer states on the card; a 'zoo' line
   each with images/s, the step median, trainer.step ms, kernels a step
   and trainer.step's share of them and the card's idle share
   (torch.profiler, one more step), peak memory, and its predict-mode
   logits at batch 2 within 1e-4 x max|ref| of the port on the CPU from
   the same weights.  On mobilenet1.0's real gradients: one fused SGD
   update against the per-parameter loop within 1e-6 x max|w| (the
   kernels of each); the 15 optimizers, 3 steps on the card against the
   CPU within 1e-5 relative, multi_precision f16 for SGD and Adam, SGLD
   on its deterministic part (its noise drawn again from the seed) and
   the noise's mean and spread.  Then
   Trainer.save_states -> load_states -> 2 steps bit-equal to 4 steps
   (resnet18_v2, batch 8, deterministic cuDNN), and no hand-written
   kernel launched in the phase;
11. imperative: the imperative core and the weight store at resnet50_v1's
   full width (classes 1000, 3x224x224, Xavier from a seed, f32, TF32
   off).  Weight store: save_parameters (npz) and nd.save(format=
   "binary") to a temporary root, get_model(pretrained=True, root=...)
   from each with no mirror and no registered SHA-1, and once more
   through MXNET_GLUON_REPO=file://<dir> into an empty root (download +
   check_sha1); each leg's file checked by SHA-1 after its load; predict
   logits at batch 32 bit for bit the source's; file sizes, save and
   load ms.  Fine-tuning: a
   Dense(100) head grafted on, backbone lr_mult 0.1
   (collect_params().setattr), reset_ctx(gpu(0)), sgd lr 0.01 momentum
   0.9 at batch 64, 1 warm-up + 5 steps on batches cropped and flipped on
   the card (mx.random.uniform, nd.slice, nd.flip): losses finite, the
   head's lr 10x the backbone's and its relative step larger, every
   parameter, gradient and state on the card; img/s, step median, peak
   memory.  One more step by hand (w -= lr * lr_mult * grad in place,
   zero_grad) against a momentum-free sgd Trainer step on the same
   gradients within 1e-6 x max|w|.  Second order: autograd.grad(loss,
   [x], create_graph=True) and backward of |dx|^2 at batch 16, parameter
   gradients finite; a small ResNet's the same on the card vs the CPU
   within 1e-4 x max|ref|.  cast("float16"): BatchNorm parameters stay
   f32, logits within 5e-2 + 5e-2|ref| of f32.  Every deterministic op
   of this slice (68 aliases, 35 tensor ops, 22 linalg names) card vs
   CPU within 1e-5 relative (potrf, potri, trsm 1e-4; gelqf and syevd by
   reconstruction and up to sign); each mx.random sampler's 2^20 draws
   within 6 standard errors of its mean and variance, a reseed bit-equal;
   ops/extended.py's other 56 names: the 44 deterministic ones card vs
   CPU within 1e-5 relative, and each of its 12 samplers' 10^5 draws of
   the expected shape and dtype within 5 standard errors of its mean and
   variance, a reseed bit-equal;
   examples/dcgan.py's port 24 steps with D's loss falling; faults 4-6
   on the card; no hand-written kernel launched;
12. data: the data pipeline on 512 JPEG images at ImageNet's shape
   (short side 256, long 256-341, quality 90, labels from a seed) that
   the port's recordio writes with PIL (the codec, file size and write
   time printed).  ImageRecordIter at examples/train_imagenet.py's
   settings (3x224x224, batch 128, shuffle, rand_crop, rand_mirror,
   prefetch_buffer 4) over 2 epochs on the card: images/s by epoch,
   preprocess_threads, os.cpu_count() and the batches each decoder
   produced; every batch (pixels, labels, pad) bit for bit the same
   iterator's on the CPU; an epoch normalized with ImageNet's mean/std
   and a scale within 1e-6 x max|ref| of the CPU's; then the native
   decoder's centre-crop configuration (images/s) or, where the native
   runtime did not build, native.load_error().  The example's
   --data-train loop, eager (hybridize=False), at full width
   (resnet50_v1, classes 1000, Xavier,
   sgd lr 0.1 momentum 0.9 wd 1e-4, kvstore device, batch 128, 2 epochs,
   f32 with TF32 off): images/s by epoch, step and next() medians,
   accuracy in [0, 1], every loss finite, state on the card, peak
   memory; the loop's steps 1-3 under torch.profiler (the card's idle
   share, the host's wait in next() a step); --benchmark 1 at the same network and
   batch beside it.  A DataLoader(ImageRecordDataset(rec).transform_first(
   CenterCrop, ToTensor, Normalize), batch 64, 4 workers, pin_memory,
   device_prefetch 2) into the one-card ShardedTrainer (resnet50_v1,
   bf16_mixed) for 4 steps: batches on the card bit-equal to the same
   loader's on the CPU, losses finite, images/s.  No hand-written kernel
   launched;
13. symbolic: the symbolic API and hybridize(), f32 with TF32 off, on
   idx-ubyte files of 2048 seeded digits whose labels can be learnt.
   examples/train_mnist.py --api module: Module.fit of the MLP
   (784-128-64-10, SoftmaxOutput, batch 64, sgd lr 0.05 momentum 0.9,
   Xavier magnitude 2, a Speedometer) for 2 epochs, validation accuracy
   above chance, the last epoch's img/s, and its first 3 updates'
   parameters against the same updates of the port on the CPU (rtol
   1e-5).  --api gluon: the hybridized LeNet's step 1 against the eager
   block (logits within 1e-4 + 1e-4 |ref|, each gradient within 1e-3 of
   its norm, floored at 1e-3 of the largest norm for the gradients whose
   exact value is 0), then 1 warm-up + 30 steps with finite, falling
   losses.
   resnet50_v1 cut in depth to one bottleneck unit a stage (its widths
   64-256-512-1024-2048 and its biased 1x1 convolutions; whole before
   phases 14-15 came, cut for the script's time) and squeezenet1.1 cut
   in depth to one fire module of each of its four widths (4 of 8; its
   stem, pools, Dropout and head; cut for the script's time), both at
   full width (classes 1000, batch 32, 3x224x224 from a seed, sgd lr
   0.01 momentum 0.9), eager against
   hybridize(): compile seconds, graph breaks (0), the step median over
   5 steps and img/s, kernels a step and the idle share over one
   profiled step each way, step 1's logits and gradients (squeezenet1.1
   in predict mode, its Dropout masks coming from two generators), and
   BatchNorm's moving stats after 3 steps (the eager net taking the
   hybridized net's weights before each) within 1e-4 + 1e-4 |ref|; each
   of these within its bound or within 4x the same measure between the
   eager net and an eager run with cuDNN off.
   A ResNet of the same cut (Xavier from seed 0, 3 eager sgd steps on
   that batch) exported, loaded with SymbolBlock.imports (logits within
   1e-5 + 1e-5 |ref| of the source's) and bound in a Module under a
   SoftmaxOutput head, MXNET_FUSION unset (add_act fired at each
   residual join and nothing else; one forward_backward's gradients
   against the gluon path's, as above), each also against an eager run
   with cuDNN off; no hand-written kernel launched.  squeezenet1.1 and
   the export check run in a side process (this script with --side)
   beside the rest of this phase and phases 14-15, which measure on
   (started with this phase since PR 19); their lines print once phase
   15 has ended, and a failure there ends the script non-zero;
14. recurrent: f32 with TF32 off.  The RNN op (cuDNN's RNN a layer:
   torch._VF eagerly; compiled with inductor, fullgraph, the rnn_layer
   custom op over _cudnn_rnn and _cudnn_rnn_backward) against its plain
   composition (ops/nn.py rnn_plain) on the card at the word LM's width
   (T 35, N 32, C = H = 650, 2 layers): lstm, gru, rnn_tanh, rnn_relu and
   a bidirectional lstm, each route's outputs and final states within
   1e-5 + 1e-5 |ref|, the gradients of data, parameters and states
   within 1e-4 of each one's norm, one forward+backward timed each way
   (CUDA events), the compile seconds, the kernels of each cuDNN route
   and the eager one's top ones by card time; a small case (T 5,
   N 3, C 4, H 6) on the card against the port on the CPU.  The port's
   examples/word_language_model.py at upstream's medium configuration
   (LSTM 2 x 650, emsize 650, bptt 35, batch 32, lr 20, clip 0.25,
   dropout 0.2) at WikiText-2's vocabulary (33278) on the example's
   seeded Markov corpus: 1 warm-up + 30 steps eager and hybridized:
   compile seconds (the network's first compile in the process), graph
   breaks (0), step median and tokens/s, kernels a step and the idle
   share over one more profiled step, peak memory, losses finite and
   the perplexity falling; then step 1's logits (1e-4 + 1e-4|ref|) and
   gradients (1e-3 of each norm) hybridized against eager with dropout
   0.  rnn_bucketing --cells at upstream
   lstm_bucketing.py's width (2 x mx.rnn.LSTMCell(200), embed 200,
   vocabulary 10000, batch 32) over BucketSentenceIter with buckets 3
   and 4 (cut in depth from upstream's 10-60 for inductor's compile
   time: 4 and 8, then 4 and 6, then 3 and 4 once phase 23 came; in the
   whole script in a side process, --examples, beside phases 13-15), one
   epoch of a seeded corpus: compile
   seconds per bucket,
   batches/s, perplexity finite and falling; no hand-written kernel
   launched;
15. fusion: each of the five patterns' microbench on the card, fused
   against unfused (conv_bn_relu at (32, 64, 56, 56), norm_act, add_act
   and act_scale_add at (32, 256, 56, 56), layer_norm_fast at
   (16384, 512)), written into a CostTable by save_table and read back
   by load_table, and which patterns the default plan then fires; a
   resnet50_v1 bottleneck (256->64->64->256, 56x56, batch 32, a
   1000-way head) as a symbol bound with fusion off, default and all:
   the fired rewrites, one training forward/backward each with outputs
   (1e-4 + 1e-4|ref|), gradients (1e-3 of each norm) and moving stats
   (1e-4 + 1e-4|ref|) against off, step time, compile and kernels a
   step; fold_batchnorm's logits in predict mode within 1e-4 + 1e-4
   |ref| of the unfolded graph; no hand-written kernel launched;
16. detection: BASELINE config 5 through the port's
   examples/ssd_detect_quant.py (the main path of the int8_conv and nms
   kernels, counted from 0 across it): build_ssd at VGG16's widths
   (width 64), VOC's 20 classes, 300x300, batch 32 (27,976 anchors),
   ImageDetIter over the example's synthetic-JPEG .rec of 128 images,
   30 Module steps (compiled Executor, f32, TF32 off), then the fp32
   MultiBoxDetection forward (nms once) and quantize_model's int8 forward
   (int8_conv 11 times, nms once); a 'detection train' line (compile,
   step median, img/s, next() wait, kernels and idle share of a profiled
   step, peak memory, finite losses) and a 'detection forward' line
   (compile and ms of each forward, launches, the top-1 class agreement
   and box error fp32 against int8, printed, not gated).  int8_conv
   bit-equal to its plain version (an f64 convolution) at the 11 layer
   shapes at batch 2 (conv1_1's 3 channels padded to 16) and with groups
   2, stride 2 and dilation 2, on data at a storage offset of 1 byte, at
   two ragged fully connected layers (M and N off the tiles, one with K
   off 16), and on the 1-D and 3-D routes
   of the registered quantized_conv (one launch, and one a kernel depth);
   each of the 11 layers at batch 32 bit-equal and timed beside its bound,
   one call and in runs of 10 calls (the plain version timed at conv1_2
   (32, 64, 300, 300) -> 64), and VGG16's fc7 (256 x 4096 -> 4096) beside
   torch._int_mm; nms's keep
   masks equal to its plain version at MultiBoxDetection's call (32
   images, nms_topk 100), box_nms over one image's 27,976 boxes,
   Proposal's pre_n 6000 and a tie at the threshold, each timed, and in
   passes over row ranges (a workspace cap below the mask's size) on
   box_nms's and Proposal's boxes with a fifth of the rows dead; the
   small case (width 8, image 64, batch 2, 4 objects) on the card
   against the port on the CPU, both through the aot_eager backend
   (MultiBoxTarget, the fp32 and the int8 detections, the int8 codes
   that differ); both quantize_calibrate modes passing their gate;
17. dist: BASELINE config 4's parameter-server path, two worker
   processes on the card started by the port's launcher
   (`python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local`, each
   worker this script with --dist-worker, one JSON line each; the server
   a host process that sees no card), after the card's cache is emptied.
   Leg A: examples/train_imagenet.py --kv-store dist_device_sync
   --benchmark 1, resnet50_v1 at full width (classes 1000, 3x224x224,
   Xavier from seed 0), batch 32 a worker, f32 with TF32 off, eager, sgd
   lr 0.01 momentum 0.9 on the server, 1 warm-up + 5 steps: every loss
   finite and the last below the first, both workers' trainable
   parameters bit-equal (SHA-1), parameters and gradients on the card; a
   'dist' line with images/s per worker and summed, the step median, the
   push and pull host ms a step, bytes a push, the server's ms per op
   over one more step (its profiler through send_command_to_servers),
   each worker's kernel ms over that step under torch.profiler and the
   card's idle share with both, peak memory, each worker's start-up and
   run seconds.  Leg B: a gluon Trainer at the same width with
   compression_params 2bit (t 0.5) and update_on_kvstore=False, each
   worker on a batch of its own, 1 warm-up + 3 steps: each worker
   launching quantize_2bit and dequantize_2bit exactly once a push, rank
   0's first push of the 193 keys bit-exact with the batched plain
   version (codes' dequantized values and the residual arena), every
   element of every pulled sum in {-2t, -t, 0, t, 2t}, the pulls
   bit-equal on both workers.  The small case: an MLP 192-64-10 on 2
   workers, 2 steps through a dist_device_sync Trainer, on the card and
   on the CPU, parameters within 1e-5 x max|ref|.  The four launches
   start together once phase 16's timed work is done (their imports
   overlap its small case and calibration); each worker waits, once
   imported, for a go file: leg A's when this phase starts, the others'
   when leg A has ended.  Leg B's workers meet in one MXNET_FLEET_SPOOL
   (FleetPublisher.attach), report their loop's steps (TRAIN_STEPS and
   TRAIN_STEP_SECONDS under loop "gluon": no producer sits in a gluon
   Trainer loop) and publish; the parent's fleet.fleetz() sees 2 ranks,
   none stale, and the merged counters equal to the sum over the ranks.
   A worker or launcher that fails, or any check,
   ends the script non-zero, and every process of the phase is stopped;
18. flash times: each kernel, the plain version and
   scaled_dot_product_attention (timed only, as the yardstick) beside the
   bound, at the long context and the LM shape, and the wide head dim
   (1, 4096, 4, 512) in both types on flash_attention.cu; kernel and SDPA
   also per call in runs of 10 calls, which leaves out the host's time;
19. observe: telemetry.serve_scrape(host "127.0.0.1", port 0) answers
   /metrics and /statusz through urllib, and an exception forced in a
   small ShardedTrainer's step writes one flight-recorder bundle
   (trace.json, telemetry.json, stacks.txt, info.json);
20. sparse: ndarray.sparse, the row-sparse KVStore and SGD's lazy update
   on the card, every array there.  A 1,000,000 x 64 f32 table (the
   feature count of LIBSVM Avazu, which upstream MXNet 1.5's
   example/sparse/linear_classification trains on; N(0, 0.01) from a
   seed) and its momentum in KVStore('device') with SGD(lr 0.1,
   momentum 0.9, wd 1e-5, lazy_update); CSR batches of 8192 rows with 32
   distinct features a row, Zipf(1.1) folded into range, labels from a
   hidden linear model; h = relu(sparse.dot(X, W)), a dense 64 -> 1 head
   in the same store, a logistic loss.  Each of 1 warm-up + 10 timed
   steps: the batch's unique rows pulled into a RowSparseNDArray
   (bit-equal to W's rows), the forward on its dense view,
   dW = sparse.dot(X, dh, transpose_a=True) cast to row_sparse for each
   half of the batch, both pushed as one list (add_rsp_rsp, then the
   lazy update), all with RuntimeWarning as an error (no densification).
   Each step recomputed in float64 on the card with plain torch from the
   same components: the gradient's rows equal, W's and the momentum's
   rows and the head (its 64 weights and bias together) within 1e-5 x
   max|ref|; at the end every touched
   row within that bound and every untouched row of W and the momentum
   bit-unchanged.  A small case (5000 x 8, batch 64, 3 steps) on the
   card against the port on the CPU within 1e-5 x max|ref|;
   dgl_csr_neighbor_uniform_sample and dgl_subgraph on card components
   equal to the CPU's under one seed.  A 'sparse' line: the step median
   and its split (pull, forward dot, backward dot and cast, push with
   update), unique rows a batch, examples/s, peak memory; no
   hand-written kernel launched;
21. compile and memory.  The script (run with no arguments) compiles
   into a fresh persistent compile cache (MXNET_COMPILE_CACHE_DIR, a
   temporary directory made before the port is imported, removed at the
   end), so phases 13-16 compile cold.  (a) rematerialisation on phase
   7's path: resnet50_v1 at full width, 1000 classes, bf16_mixed, batch
   256, sgd lr 0.1 momentum 0.9 through ShardedTrainer with remat_policy
   none, dots_saveable and full, each from the same weights (seed 0)
   with deterministic cuDNN, 2 warm-up + 5 synchronous steps: the step
   median, img/s and torch.cuda.max_memory_allocated after a reset; step
   1's loss and every parameter and moving stat after step 1 bit-equal
   to none's (the worst |diff| printed), full's peak below none's; a
   'remat' line.  (b) train_mnist's hybridized LeNet (phase 13) under
   hybridize(remat_policy="dots_saveable"): no graph break, step 1's
   logits and gradients against the eager block within phase 13's
   bounds; a 'remat compiled' line.  (c) once phase 13 has run, a child
   process (this script with --warm-compile) rebuilds phase 13's
   hybridized resnet50_v1 cut from the same seed and shape and runs its
   first training call, beside phases 14-15: at least one FX-graph cache
   hit and no miss, its logits bit-equal to phase 13's; a 'compile
   cache' line with the parent's cold and the child's warm compile
   seconds and both processes' hit and miss counts.  (d) the port's
   examples/fine_tune.py for one epoch of 8 batches in a side process
   (--examples, after phase 14's bucketing) beside phases 13-15: finite
   losses, the accuracy printed; a 'finetune' line.  No
   hand-written kernel launched;
22. checkpoint: fault-tolerant checkpointing on phase 21a's path
   (resnet50_v1 at full width, 1000 classes, bf16_mixed, batch 256, sgd
   lr 0.1 momentum 0.9 through ShardedTrainer, deterministic cuDNN).
   (a) 6 steps from seed-0 weights, the losses kept.  (b) From the same
   weights, CheckpointManager(keep_last=2, async_save=True) attached with
   period 2 (its goodput recorder begins there under MXNET_GOODPUT_DIR),
   4 steps, then SIGTERM to this process: the handler flushes step 4 and
   sets manager.preempted.  (c) A trainer from seed-1 weights attached
   with auto_resume returns 4, with every parameter, momentum leaf,
   moving statistic and the random stream bit-equal to (b)'s after step
   4; steps 5-6 give losses and a final state bit-equal to (a)'s; then 3
   steps alone and 3 with an async save in flight, each save's blocking
   snapshot and background write timed.  (d) flip_bit on step 4's data
   file: a fresh load falls back to step 2 with a CORRUPT warning and
   CHECKPOINT_DIGEST_FAILURES rises by 1; the port's goodputz CLI reads
   the ledger: a fresh incarnation ended by the preemption at step 4 and
   a resumed one, with ckpt_save and ckpt_restore time.  (e) A sharded
   save validated by validate_sharded_checkpoint and loaded with a
   restrict map, bit-equal.  (f) train_mnist's Module (phase 13's MLP)
   fit 1 epoch with a checkpoint manager, a fresh Module resumed to 2
   epochs, bit-equal to an uninterrupted fit.  The SIGTERM handler is
   restored and SIGTERM left unblocked; no hand-written kernel launched;
   a 'checkpoint' line with the bytes of a checkpoint, the blocking
   snapshot ms, the background write s, the load-and-restore s, and the
   step ms alone and with a save in flight;
23. interop: Custom operators, ONNX, the C ABI and rtc at resnet50_v1's
   full width (classes 1000, Xavier from seed 0), in a side process of
   its own (this script with --interop, on phase 9b's int8 artifact)
   beside phases 13-15, whose lines print once phase 15 has ended (a
   failure there ends the script non-zero); the Executor's resnet50_v1
   graphs on aot_eager (jit._BACKEND), the hybridized block and the api
   worker's Executor on inductor, the default.  (a) upstream's
   custom_softmax example (a CustomOp: softmax forward, p - onehot
   backward, need_top_grad False) as the loss head of the symbolic
   resnet50_v1 through the Executor at batch 64, 3 SGD steps (lr 0.01)
   with deterministic cuDNN, against the same net with SoftmaxOutput:
   probabilities, step 1's gradients, the updated weights and moving
   stats within 1e-6 x max|ref|; the logits' gradients of both heads
   within 1e-6 of softmax(z) - onehot; the user's forward handed arrays
   on the card; the op after a Dense(1000) in a hybridized block
   compiled by inductor (the mxnet_tpu_torch::custom op, no graph break)
   against eager.  (b) export_model of resnet50_v1's symbol and params at
   batch 32, get_model_metadata, import_model (parameters on gpu(0)),
   bound on the card: logits within 1e-4 x max|ref| of the gluon
   forward; the file's bytes and the export and import seconds.  (c) the
   port's libmxtpu_runtime.so and the unchanged cpp/test_predict.c and
   cpp/test_api_train.c built from the checkout (native.capi_library,
   capi_client); test_predict on the exported net at (1, 3, 224, 224)
   against the eager forward (printed logits within 1e-5 x max|ref| +
   5e-7), and on the int8 artifact at its batch 32 (printed top-1 and
   logits equal to the in-process Predictor's), the same two through the
   library's C calls (ctypes: the f32 output within 1e-5 x max|ref|, the
   int8 output bit-equal, 10 timed round trips each against the
   in-process forward), the references on torch's default cuDNN TF32
   setting, which the workers keep; each int8 worker launching int8_conv
   once per quantized layer a forward (its MXTPU_WORKER_STATS record);
   test_api_train's MLP through the api worker on the card, its loss
   falling 10x.  (d) a CudaModule(kernels=...) kernel on card tensors
   bit-equal to the function called directly; CUDA source refused.  An
   'interop' line per part and one of the numbers; in the process
   itself no hand-written kernel launched but the int8_conv launches of
   (c)'s in-process int8 Predictor, the reference;
24. the whole script's wall time, then a {"kernels": [...]} line (the
   compression rows' launches: phase 4's and each phase-17 worker's;
   int8_conv's: phase 16's, det_launches, phase 9b's, serve_launches,
   and phase 23's C ABI workers', capi_launches);
25. last line: {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero.
"""
import atexit
import collections
import contextlib
import ctypes
import functools
import gc
import hashlib
import json
import logging
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# the whole script (no arguments) compiles into a fresh persistent
# compile cache, so phases 13-16 compile cold as they did before the
# cache; the side, warm-compile and dist processes inherit it through the
# environment (phase 21)
COMPILE_DIR = None
if __name__ == "__main__" and len(sys.argv) == 1:
    COMPILE_DIR = tempfile.mkdtemp(prefix="chip_smoke_compile_")
    atexit.register(shutil.rmtree, COMPILE_DIR, True)
    os.environ["MXNET_COMPILE_CACHE"] = "1"
    os.environ["MXNET_COMPILE_CACHE_DIR"] = COMPILE_DIR

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import (events, fleet, generate, goodput, kernels,
                             parallel, profiler, telemetry, tracing)
from mxnet_tpu_torch.contrib import compression as comp
from mxnet_tpu_torch.examples.transformer_lm import TransformerLM
from mxnet_tpu_torch.gluon import utils as gutils
from mxnet_tpu_torch.gluon.model_zoo import model_store, vision
from mxnet_tpu_torch.ops import attention as attn, registry

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
T = 0.5
BATCH = 32
IMAGE = 224
STEPS = 5
REPS = 25                        # timed runs per measurement (median)
RUN = 10     # calls per timed run where the host's time is left out
SOURCE = "mxnet_tpu_torch/kernels/compression_2bit.cu"
# the ragged batch of the kernel phase and the element offsets of its
# gradients in one buffer: 1 and 6 are 1 and 2 floats past a 16-byte
# boundary, so those entries take the element-by-element path
RAGGED_SIZES = (1, 3, 127, 16385, 16384 * 7 + 3)
RAGGED_STARTS = (0, 1, 6, 136, 16524)
REPLACES = {"quantize_2bit": "mxnet_tpu/contrib/compression.py:50",
            "dequantize_2bit": "mxnet_tpu/contrib/compression.py:68"}
# The least work of the function on n real elements packed into a padded
# (rows, 128) layout: f32 bytes per real element, each input read once and
# each output written once (quantize reads the gradient and the residual
# and writes the new residual; dequantize writes the values), plus the
# 2-bit codes, 0.25 B per padded element; operations per real element
# (add, 2 compares, 2 selects, 2 adds/subs, shift and or for quantize;
# shift, and, 2 compares and a select for dequantize).  The zero padding
# is a cost of this layout, not of the function, and is not counted.
F32_BYTES_PER_ELT = {"quantize_2bit": 12, "dequantize_2bit": 4}
CODE_BYTES_PER_PADDED_ELT = 0.25
OPS_PER_ELT = {"quantize_2bit": 9, "dequantize_2bit": 5}
FLASH_SOURCES = {
    "flash_attention": "mxnet_tpu_torch/kernels/flash_attention.cu",
    "flash_attention_bf16": "mxnet_tpu_torch/kernels/flash_attention_bf16.cu"}
FLASH_REPLACES = "mxnet_tpu/ops/attention_pallas.py:30"
# the LM config of tools/bench_lm.py on an accelerator: d_model 512 over
# 8 heads (D 64), batch 32, seq 512; and the long context the
# sequence-parallel engines exist for
LM_SHAPE = (32, 512, 8, 64)
LONG_SHAPE = (1, 16384, 8, 64)
# head dims past the tensor-core kernel's 256, on flash_attention.cu's
# wide variant in both types
WIDE_CASES = ((1, 1024, 4, 320), (2, 512, 2, 512))
WIDE_TIME_SHAPE = (1, 4096, 4, 512)
# the JAX suite's bounds (tests/test_flash_attention.py) at unit-normal
# inputs; lse 1e-4 because at T 16384 it is ~10 and f32 spacing there
# is 1e-6; bf16 o also within BF16_O_REL (|o| + obar) + F32_O_TOL of the
# f32 plain version elementwise (derived at bf16_share), bf16 lse within
# F32_LSE_TOL
F32_O_TOL, F32_LSE_TOL, BF16_TOL, GRAD_TOL = 5e-5, 1e-4, 3e-2, 5e-4
BF16_O_REL = 2.0 ** -8
# the sharded phase: bench.py's batch, its synchronous phase cut from 40
# steps to 8 and its async phase to 2 calls of step_many(4)
SHARDED_BATCH = 256
SYNC_STEPS = 8
ASYNC_CALLS = 2
# tests/test_torch_sharded_trainer.py's sgd settings for the small ResNet
SMALL_SGD = {"learning_rate": 3e-5, "momentum": 0.9, "wd": 1e-4}
OBS_STEPS = 4                    # sync steps with the layer off, then on
H100_BF16_PEAK = 989e12          # data sheet, SXM, dense bf16 (700 W)
BREAKDOWN_TOL = 0.01             # buckets against span + gap, relative
# the decode phase: tools/bench_decode.py's LM on an accelerator
# (:182-200, d_ff 4 x d_model), 16 slots x 256 positions, 16 prompts of 16
# tokens (:248), 48 steps (:87); then 8 steps under the profiler
DECODE_LM = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=8,
                 d_ff=2048, max_len=256)
DECODE_SLOTS, DECODE_CACHE, DECODE_PROMPT, DECODE_STEPS = 16, 256, 16, 48
DECODE_PROFILE_STEPS = 8
WRAP_CACHE = 64
SERVER_NEW = 32
# f32 with TF32 off: decode logits within 1e-4 + 1e-4 |ref| of the full
# forward's; tokens compared where the full forward's top-2 gap exceeds
# 1e-3; bf16_mixed within 0.12 + 0.05 |ref| of the policy's prefill
# (tests/test_generate.py:140-168)
F32_LOGIT_TOL, GAP_TOL = 1e-4, 1e-3
BF16_ATOL, BF16_RTOL = 0.12, 0.05
# tests/test_generate.py:44's LM, card against CPU: max |d| within 1e-5 of
# the largest |logit|
SMALL_LM = dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2,
                max_len=24)
SMALL_LM_RTOL = 1e-5
# the paged phase, at the decode phase's LM and slots: page 16, chunk 32
# (the MXNET_DECODE_* defaults); a 160-token prompt in chunks of 16 and
# in one, 8 steps after; bench_decode --prefix-share's shape (:408-430:
# 8 users, a 112-token system prompt + 8-token tails, 32 new tokens) cut
# to 4 slots, its CPU value (8 on an accelerator, :422-423), and
# --spec's (:562-580: 2 slots, a 24-token prompt tiled from 6 tokens,
# 160 tokens, k 4, ngram 3), its sampled run at temperature
# 0.8, top_k 40 under one seed; bf16_mixed for 16 steps
PAGE, PAGED_CHUNK = 16, 32
LONG_PROMPT, LONG_CHUNK, LONG_STEPS = 160, 16, 8
SHARE_USERS, SHARE_SYSTEM, SHARE_TAIL, SHARE_SLOTS, SHARE_NEW = \
    8, 112, 8, 4, 32
SPEC_SLOTS, SPEC_PROMPT, SPEC_NEW, SPEC_K, SPEC_NGRAM, SPEC_SEED = \
    2, 24, 160, 4, 3, 7
BF16_PAGED_STEPS = 16
# the zoo phase: one network per vision family at ImageNet width through
# the port's examples/train_imagenet.py entry, --benchmark 1, batch 32,
# classes 1000, f32 with TF32 off, sgd momentum 0.9 at lr 0.01 (AlexNet
# and VGG have no BatchNorm and start from Xavier), 1 warm-up + 5 steps
ZOO = (("alexnet", 224), ("vgg16", 224), ("resnet50_v2", 224),
       ("densenet121", 224), ("squeezenet1.1", 224), ("inceptionv3", 299),
       ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224))
ZOO_DROPOUT = ("alexnet", "vgg16", "squeezenet1.1", "inceptionv3")
ZOO_BATCH, ZOO_STEPS, ZOO_LR = 32, 5, 0.01
# card against CPU: logits within 1e-4 x max|ref|; the fused SGD update
# within 1e-6 x max|w| of the loop; optimizers within 1e-5 relative
ZOO_LOGIT_REL, ZOO_FUSED_REL, ZOO_OPT_REL = 1e-4, 1e-6, 1e-5
# the imperative phase: resnet50_v1 at full width (classes 1000, Xavier
# from seed 0, f32 with TF32 off), its weights saved and loaded back
# through the model store with predict logits at batch 32; fine-tuning
# with a 100-class head at batch 64 (crops of 240x240 data at random
# offsets, random flips), backbone lr_mult 0.1, sgd lr 0.01 momentum 0.9,
# 1 warm-up + 5 steps; second order at batch 16; 2^20 draws a sampler;
# DCGAN 24 steps at batch 32.  Bounds: the hand update within 1e-6 x
# max|w| of the sgd Trainer; the small ResNet's double backward card vs
# CPU within 1e-4 x max|ref|; f16 logits within 5e-2 + 5e-2|ref|; ops
# card vs CPU within 1e-5 relative (potrf, potri, trsm 1e-4); sample
# moments within 6 standard errors
IMP_NET, IMP_CLASSES, IMP_SIDE, IMP_PAD = "resnet50_v1", 1000, 224, 16
IMP_PRED_BATCH, IMP_FT_BATCH, IMP_SO_BATCH = 32, 64, 16
IMP_FT_CLASSES, IMP_FT_STEPS, IMP_FT_LR, IMP_BACKBONE_MULT = 100, 5, 0.01, 0.1
IMP_DRAWS, IMP_SE = 1 << 20, 6.0
IMP_EXT_DRAWS, IMP_EXT_SE = 10 ** 5, 5.0   # ops/extended.py's samplers
IMP_DCGAN_STEPS, IMP_DCGAN_BATCH = 24, 32
IMP_UPDATE_REL, IMP_SO_REL, IMP_F16_TOL, IMP_OP_REL = 1e-6, 1e-4, 5e-2, 1e-5
IMP_LINALG_REL = {"linalg_potrf": 1e-4, "linalg_potri": 1e-4,
                  "linalg_trsm": 1e-4}
# the data phase: 512 JPEG images at ImageNet's shape (3 channels, short
# side 256, long side 256-341, quality 90, labels in [0, 1000) from a
# seed; smooth colour fields plus noise, ~40 KB each), read by
# ImageRecordIter at examples/train_imagenet.py's settings (3x224x224,
# batch 128, shuffle, rand_crop, rand_mirror) over 2 epochs with
# prefetch_buffer 4; its normalized run uses ImageNet's mean and std and
# a scale.  The example's --data-train loop at full width (resnet50_v1,
# classes 1000, sgd lr 0.1 momentum 0.9 wd 1e-4, kvstore device, f32 with
# TF32 off) for 2 epochs, 3 more steps under the profiler, and
# --benchmark 1 at the same network and batch for 8 steps; a DataLoader
# (4 workers, pinned, device_prefetch 2) at batch 64 into the one-card
# ShardedTrainer under bf16_mixed for 4 steps.  Bounds: card batches
# bit-equal to the CPU's (pixels, labels, the loader's batches); the
# normalized data within 1e-6 x max|ref| of the CPU's
DATA_IMAGES, DATA_SHORT, DATA_LONG, DATA_QUALITY = 512, 256, (256, 342), 90
DATA_SHAPE, DATA_BATCH, DATA_EPOCHS, DATA_PREFETCH = (3, 224, 224), 128, 2, 4
DATA_MEAN, DATA_STD, DATA_SCALE = (123.68, 116.28, 103.53), \
    (58.395, 57.12, 57.375), 1.0 / 0.95
DATA_PROFILE_STEPS, DATA_BENCH_STEPS = 3, 8
DATA_LOADER_BATCH, DATA_LOADER_WORKERS, DATA_LOADER_STEPS = 64, 4, 4
DATA_NORM_REL = 1e-6
# the symbolic phase: examples/train_mnist.py's two paths (the MLP
# 784-128-64-10 with SoftmaxOutput through Module.fit, Xavier magnitude
# 2, and the hybridized LeNet), batch 64, sgd lr 0.05 momentum 0.9, over
# idx-ubyte files of 2048 seeded digits (a class's prototype plus noise)
# the phase writes: Module.fit 2 epochs, its first 3 updates again on
# the CPU; LeNet 1 warm-up + 30 steps (at 10 its loss has barely left
# ln 10 and falls within a batch's noise).  Then resnet50_v1 and
# squeezenet1.1 at full width, cut in depth (classes 1000, batch 32,
# 3x224x224 from a seed, sgd lr 0.01 momentum 0.9), eager against
# hybridize(): 3 steps
# compared, 5 timed, 1 profiled each way; resnet50_v1 exported and
# loaded back.  f32 with TF32 off.  Bounds: parameters card vs CPU
# within 1e-5 x |ref| + 1e-6 x max|ref|; logits within 1e-4 + 1e-4 |ref|;
# each gradient within 1e-3 of its norm, the norm floored at 1e-3 of the
# largest (grad_rel); moving stats within 1e-4 + 1e-4 |ref|; the export's
# logits within 1e-5 + 1e-5 |ref|.  For the zoo networks each measure
# holds within its bound or within SYM_YARD x the same measure between
# two eager runs of the network, cuDNN's and torch's own convolutions
# (resnet50_v1 from Xavier is that sensitive to f32 rounding: PERF.md,
# PR 13)
SYM_IMAGES, SYM_BATCH, SYM_LR, SYM_EPOCHS = 2048, 64, 0.05, 2
SYM_CPU_UPDATES, SYM_GLUON_STEPS = 3, 30
# resnet50_v1 cut in depth only, where this phase ran resnet50_v1 whole
# before phases 14-15 (they add about 500 s, mostly inductor's
# compiles; PERF.md section 4): its stem, bottleneck units at its widths
# (64-256-512-1024-2048, the biased 1x1 convolutions) and head, one
# unit a stage in place of 3-4-6-3
SYM_RESNET = "resnet50_v1 1-1-1-1"
# squeezenet1.1 cut in depth only, for the same reason: its stem, pools,
# Dropout and head, and one fire module of each of its four widths
# (squeeze-expand 16-64, 32-128, 48-192, 64-256) in place of its eight
SYM_SQUEEZE = "squeezenet1.1 1-1-2"
SQUEEZE_CUT = ["P", (16, 64), "P", (32, 128), "P", (48, 192), (64, 256)]
SYM_NETS = (SYM_RESNET, SYM_SQUEEZE)


def squeezenet_cut():
    """squeezenet1.1's layers (model_zoo SqueezeNet) with SQUEEZE_CUT's
    fire modules."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import squeezenet as sq

    net = sq.Classifier(prefix="squeezenet_cut_")
    with net.name_scope():
        f = nn.HybridSequential(prefix="")
        f.add(nn.Conv2D(64, kernel_size=3, strides=2, activation="relu"))
        for item in SQUEEZE_CUT:
            f.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)
                  if item == "P" else sq._Fire(*item))
        f.add(nn.Dropout(0.5))
        net.features = f
        out = nn.HybridSequential(prefix="")
        out.add(nn.Conv2D(1000, kernel_size=1, activation="relu"))
        out.add(nn.GlobalAvgPool2D())
        out.add(nn.Flatten())
        net.output = out
    return net


def sym_build(name):
    if name == SYM_RESNET:
        return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                               [64, 256, 512, 1024, 2048], classes=1000)
    if name == SYM_SQUEEZE:
        return squeezenet_cut()
    return vision.get_model(name, classes=1000)
SYM_NET_BATCH, SYM_NET_LR, SYM_COMPARE_STEPS, SYM_TIMED_STEPS = \
    32, 0.01, 3, 5
SYM_PARAM_RTOL, SYM_LOGIT_TOL, SYM_GRAD_REL, SYM_STAT_TOL, SYM_EXPORT_TOL = \
    1e-5, 1e-4, 1e-3, 1e-4, 1e-5
SYM_YARD = 4.0
# the dist phase, BASELINE config 4 (example/distributed_training's
# dist_device_sync) on the one card: 2 worker processes started by the
# port's launcher (tools/launch.py), each chip_smoke.py itself with
# --dist-worker, the parameter server a host process.  Leg A: the port's
# examples/train_imagenet.py --kv-store dist_device_sync --benchmark 1 at
# resnet50_v1's full width (classes 1000, 3x224x224, Xavier from seed 0),
# batch 32 a worker, f32 with TF32 off, eager, sgd momentum 0.9 on the
# server at phase 10's lr 0.01 (the server steps on the sum of the two
# workers' batch means; at lr 0.1 and 0.05 the loss on the one fixed
# batch rises from step 2: PERF.md, section 6), 1 warm-up + 5 steps,
# then one more under torch.profiler with the server's profiler on.
# Leg B: a
# gluon Trainer at the same width, sgd lr 0.1 momentum 0.9, kvstore
# dist_device_sync, 2-bit compression (threshold T) on the workers and
# update_on_kvstore=False, each worker on a batch of its own, 1 warm-up +
# 3 steps.  The small case: an MLP 192-64-10 (weights from
# seed 0), 2 workers with batches of their own, sgd lr 0.1 momentum 0.9
# on the server, 2 steps on the card and on the CPU, parameters within
# 1e-5 x max|ref|
DIST_WORKERS, DIST_STEPS, DIST_B_STEPS, DIST_LR, DIST_B_LR = \
    2, 5, 3, 0.01, 0.1
DIST_SMALL_REL, DIST_TIMEOUT_S = 1e-5, 420
SIDE_TIMEOUT_S = 900    # phase 15's end waits this long for the side process
DIST_WORKER_SCRIPT = os.path.abspath(__file__)
DIST_ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def bound_ms(name, n_elts, padded_elts):
    t_bytes = (F32_BYTES_PER_ELT[name] * n_elts
               + CODE_BYTES_PER_PADDED_ELT * padded_elts) / HBM_BYTES_PER_S
    t_ops = OPS_PER_ELT[name] * n_elts / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, calls=1):
    """Median over REPS CUDA-event timings of `calls` calls of fn() in a
    row, per call, after two warm-ups.  With one call the time includes
    the host's work before the launch (the card idles through it); with
    several, that work overlaps the card's work on the previous call."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def compare_kernels(g2d, r2d):
    """Both kernels vs the plain versions on one padded input; returns
    the max |difference| over codes, residuals and dequantized values
    (checked to be zero)."""
    codes, new_res = kernels.quantize_2bit(g2d, r2d, T)
    deq = kernels.dequantize_2bit(codes, T)
    rcodes, rres = comp.quantize_2bit_ref(g2d, r2d, T)
    rdeq = comp.dequantize_2bit_ref(codes, T)
    torch.cuda.synchronize()
    check(torch.equal(codes, rcodes), "codes differ at %s" % (g2d.shape,))
    check(same_bits(new_res, rres), "residuals differ at %s" % (g2d.shape,))
    check(same_bits(deq, rdeq), "dequantized values differ at %s"
          % (g2d.shape,))
    return max(float((codes.to(torch.int64) - rcodes).abs().max()),
               float((new_res - rres).abs().max()),
               float((deq - rdeq).abs().max()))


def padded(flat):
    rows = comp._padded_rows(flat.numel())
    return comp._pad2d(flat, rows)


def batch_launch_ms(layout, grads, residual_in, residual_out):
    """Per kernel, the time of one launch over the batch, in runs of RUN
    launches (the host's work of each launch overlaps the card's work on
    the one before)."""
    codes = torch.empty(layout.n_code_words, dtype=torch.int32,
                        device="cuda")
    out = torch.empty(layout.n_values, device="cuda")
    quantize = kernels.quantize_2bit_batch_launcher(
        layout, grads, residual_in, residual_out, codes, T)
    quantize()
    dequantize = kernels.dequantize_2bit_batch_launcher(layout, codes, out,
                                                        T)
    return {"quantize_2bit": time_ms(quantize, RUN),
            "dequantize_2bit": time_ms(dequantize, RUN)}


def check_batch(layout, grads, arena, label):
    """One launch of each batched kernel against the batched plain version
    on the same batch, both updating their own copy of the residual arena
    in place; codes, arena and every entry's dequantized values checked
    bit for bit.  Returns the max |difference| (zero)."""
    ref_arena = arena.clone()
    before = dict(kernels.launch_counts)
    codes = comp.quantize_batch(layout, grads, arena, arena, T)
    deq = comp.dequantize_batch(layout, codes, T)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(launched["quantize_2bit"] == launched["dequantize_2bit"] == 1,
          "%s: launches %s, expected one of each" % (label, launched))
    rcodes = torch.empty_like(codes)
    comp.quantize_batch_ref(layout, grads, ref_arena, ref_arena, rcodes, T)
    rdeq = torch.empty_like(deq)
    comp.dequantize_batch_ref(layout, rcodes, rdeq, T)
    torch.cuda.synchronize()
    check(torch.equal(codes, rcodes), "%s: codes differ" % label)
    check(same_bits(arena, ref_arena), "%s: residual arenas differ" % label)
    worst = max(float((codes.to(torch.int64) - rcodes).abs().max()),
                float((arena - ref_arena).abs().max()))
    for e in range(len(grads)):
        a, b = layout.values(deq, e), layout.values(rdeq, e)
        check(same_bits(a, b), "%s: dequantized values of entry %d differ"
              % (label, e))
        worst = max(worst, float((a - b).abs().max()))
    return worst


def vector_flags(layout, grads, arena):
    """The vector field of each entry as the kernel reads it: from the
    device copy of the entry table."""
    table = kernels._device_table(layout, arena.device, grads, arena,
                                  arena).cpu().numpy()
    width = len(kernels.COMPRESSION_FIELDS)
    return table[:len(grads) * width].reshape(-1, width)[:, 7].tolist()


def check_ragged_batch(gen, card):
    """The ragged, misaligned batch for two pushes; returns the max
    |difference| (zero)."""
    sizes = RAGGED_SIZES
    layout = comp.batch_layout(sizes)
    shared = torch.empty(RAGGED_STARTS[-1] + sizes[-1], device="cuda")
    grads = [shared[s:s + n] for s, n in zip(RAGGED_STARTS, sizes)]
    arena = torch.zeros(layout.n_values, device="cuda")
    worst = 0.0
    for push in range(2):
        for g in grads:
            g.copy_(make_inputs(g.numel(), gen)[0])
        worst = max(worst, check_batch(layout, grads, arena,
                                       "ragged batch, push %d" % push))
    flags = vector_flags(layout, grads, arena)
    offsets = [g.data_ptr() % 16 // 4 for g in grads]
    check(flags == [int(o == 0) for o in offsets] and 1 in offsets
          and 2 in offsets, "ragged batch: vector flags %s for entries "
          "%s floats past a 16-byte boundary" % (flags, offsets))
    print("kernels: ragged batch %s at %s floats past a 16-byte boundary, "
          "2 pushes, one launch of each per push, bit-exact | vector flags "
          "%s (0: element-by-element path) | %s"
          % (list(sizes), offsets, flags, card), flush=True)
    return worst


def check_repeated_key(card):
    """KVStore.push(["w", "w"]) twice with compression, on the card and on
    the CPU (the plain version): the updater sees the same aggregates bit
    for bit, and the card launches each kernel once per run of the list
    in which no key repeats."""
    n = 16384 * 7 + 3
    rng = np.random.RandomState(3)
    values = [[rng.randn(n).astype(np.float32) * 0.6 for _ in range(2)]
              for _ in range(2)]
    seen = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        kv = mx.kv.create("device")
        kv.init("w", mx.nd.zeros((n,), ctx=ctx))
        kv.set_gradient_compression({"type": "2bit", "threshold": T})
        seen[ctx] = []
        kv.set_updater(lambda k, agg, w, out=seen[ctx]:
                       out.append(agg._data.cpu().clone()))
        before = dict(kernels.launch_counts)
        for push in values:
            kv.push(["w", "w"], [mx.nd.array(v, ctx=ctx) for v in push])
        launched = {k: c - before[k] for k, c in kernels.launch_counts.items()}
        if ctx == mx.gpu(0):
            check(launched["quantize_2bit"] == launched["dequantize_2bit"]
                  == 4, "repeated key: launches %s, expected 4 of each"
                  % launched)
    card_aggs, cpu_aggs = seen[mx.gpu(0)], seen[mx.cpu()]
    check(len(card_aggs) == len(cpu_aggs) == 4
          and all(same_bits(a, b) for a, b in zip(card_aggs, cpu_aggs)),
          "repeated key: aggregates differ between the card and the CPU")
    print("kernels: KVStore push of one key twice in a list, 2 pushes: 4 "
          "aggregates bit-exact with the CPU's plain version | %s" % card,
          flush=True)


def phase_device():
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, "nvidia-smi failed: %s" % smi.stderr)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: %s | torch %s cuda %s | count %d"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()), flush=True)
    return card


def ptxas_summary(report):
    """One 'kernel: regs, spills, static smem' entry per compiled kernel
    of an nvcc -Xptxas -v report, under its mangled name."""
    out = []
    for block in report.split("Compiling entry function")[1:]:
        name = re.search(r"'(\w+)'", block).group(1)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out.append("%s %s regs, spill %s/%s B, smem %s B"
                   % (name, regs.group(1) if regs else "?",
                      *(spill.groups() if spill else ("?", "?")),
                      smem.group(1) if smem else "0"))
    return "; ".join(out)


def phase_build():
    seconds, reports = kernels.build()
    parts = ["%s: %s" % (name, ptxas_summary(out) if out
                         else "reused from mxnet_tpu_torch/_build")
             for name, out in reports.items()]
    spilling = sum(1 for out in reports.values()
                   for st, ld in re.findall(r"(\d+) bytes spill stores, "
                                            r"(\d+) bytes spill loads", out)
                   if int(st) or int(ld))
    print("build: %.2f s (nvcc, sm_90a, one process per source) | kernels "
          "that spill: %d | %s" % (seconds, spilling, " | ".join(parts)),
          flush=True)


def make_inputs(n, gen):
    """Gradient and nonzero residual on the card with +-t exactly and
    elements that set bit 31 (code 2 at bit pair 15)."""
    grad = torch.randn(n, generator=gen, device="cuda") * 2.0
    res = torch.randn(n, generator=gen, device="cuda") * 0.3
    grad[::7] = T
    res[::7] = 0.0
    grad[3::11] = -T
    res[3::11] = 0.0
    pos = torch.arange(n, device="cuda")
    grad[(pos // 128) % 16 == 15] = -2.0
    return grad, res


def phase_kernels(n_resnet, card):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst = 0.0
    flat = {}
    for n in (1000, 16384, 16384 * 7 + 3, n_resnet):
        grad, res = make_inputs(n, gen)
        g2d, r2d = padded(grad), padded(res)
        worst = max(worst, compare_kernels(g2d, r2d))
        codes, _ = kernels.quantize_2bit(g2d, r2d, T)
        elts = g2d.numel()
        launch_ms = batch_launch_ms(comp.batch_layout((elts,)),
                                    [g2d.view(-1)], r2d.view(-1),
                                    torch.empty_like(r2d).view(-1))
        line = []
        for name, plain in (
                ("quantize_2bit", lambda: comp.quantize_2bit_ref(g2d, r2d, T)),
                ("dequantize_2bit",
                 lambda: comp.dequantize_2bit_ref(codes, T))):
            ms, pms = launch_ms[name], time_ms(plain)
            bms, _ = bound_ms(name, n, elts)
            line.append("%s %.4f ms (plain %.4f, bound %.4f, %.0f%% of HBM"
                        " peak)" % (name, ms, pms, bms, 100 * bms / ms))
            if n == n_resnet:
                flat[name] = {"flat_elements": n,
                              "flat_padded_elements": elts, "flat_ms": ms,
                              "flat_plain_ms": pms, "flat_bound_ms": bms}
        print("kernels: n=%d (padded %d) bit-exact, a batch of one | kernel "
              "per launch in runs of %d launches: %s | %s"
              % (n, elts, RUN, "; ".join(line), card), flush=True)
    worst = max(worst, check_ragged_batch(gen, card))
    check_repeated_key(card)
    return worst, flat


def build_resnet50():
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 3, IMAGE, IMAGE), ctx=mx.gpu(0)))  # shapes
    trainable = [p for p in net.collect_params().values()
                 if p.grad_req != "null"]
    check(len(trainable) == 193, "resnet50_v1 has %d trainable parameters"
          % len(trainable))
    return net, trainable


def phase_slice(net, trainable, card):
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(BATCH, 3, IMAGE, IMAGE).astype(np.float32),
                    ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(
        net.collect_params(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        kvstore=mx.kv.create("device"),
        compression_params={"type": "2bit", "threshold": T},
        update_on_kvstore=True)
    losses, step_s, fb_s, ts_s, step1_grads = [], [], [], [], None
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for step in range(STEPS):
        t0 = time.perf_counter()
        with mx.autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        torch.cuda.synchronize()
        fb_s.append(time.perf_counter() - t0)
        if step == 0:
            step1_grads = [p.grad()._data.detach().clone() for p in trainable]
        t1 = time.perf_counter()  # the clone above is not timed
        trainer.step(BATCH)
        torch.cuda.synchronize()
        ts_s.append(time.perf_counter() - t1)
        step_s.append(fb_s[-1] + ts_s[-1])
        losses.append(float(loss.mean().asscalar()))
    launches = dict(kernels.launch_counts)
    check(out.shape == (BATCH, 1000), "logits shape %s" % (out.shape,))
    check(all(np.isfinite(losses)), "non-finite loss %s" % losses)
    # lr 0.1 with momentum 0.9 overshoots on a fixed batch: here the loss
    # rises again from step 4, so "falls" is checked over steps 1-3.  The
    # JAX package overshoots the same way at these settings on a small
    # ResNet (tests/test_torch_resnet_train.py, smoke-settings tests)
    check(losses[0] > losses[1] > losses[2],
          "loss did not fall over steps 1-3: %s" % losses)
    # one push a step: one launch of each kernel over all 193 keys
    for name in ("quantize_2bit", "dequantize_2bit"):
        check(launches[name] == STEPS, "%s launched %d times, expected %d"
              % (name, launches[name], STEPS))
    # the batched kernels against the batched plain version on the real
    # step-1 gradients of all 193 keys in one call, from zero residuals
    grads = [g.reshape(-1) for g in step1_grads]
    layout = comp.batch_layout(tuple(g.numel() for g in grads))
    worst = check_batch(layout, grads,
                        torch.zeros(layout.n_values, device="cuda"),
                        "step-1 gradients of the 193 keys")
    steady = sum(step_s[1:]) / (STEPS - 1)
    print("slice: resnet50_v1 f32 batch %d, %d steps Trainer+KVStore(device)"
          "+2bit | loss %s | step s %s = fwd+bwd %s + trainer.step %s | "
          "%.1f img/s (steps 2-%d) | launches %s | step-1 grads of the 193 "
          "keys bit-exact in one batched call | %s"
          % (BATCH, STEPS, ["%.4f" % v for v in losses],
             ["%.4f" % s for s in step_s], ["%.4f" % s for s in fb_s],
             ["%.4f" % s for s in ts_s], BATCH / steady, STEPS, launches,
             card), flush=True)
    return launches, worst, (layout, grads), ts_s


def time_step_set(step_inputs, card):
    """Times of one step's batched launch of each kernel over the 193 keys'
    step-1 gradients: the kernel (per launch, in runs of RUN launches, so
    the host's work overlaps the card's), the whole wrapper call (one
    call, host work included), the batched plain version, and the
    bounds."""
    layout, grads = step_inputs
    arena = torch.zeros(layout.n_values, device="cuda")
    launch_ms = batch_launch_ms(layout, grads, arena, arena)
    codes = comp.quantize_batch(layout, grads, arena, arena, T)
    out = torch.empty(layout.n_values, device="cuda")
    ref_arena = arena.clone()
    ref_codes = torch.empty_like(codes)
    elts = sum(layout.sizes)
    padded_elts = 128 * 128 * layout.n_tiles
    res = {}
    for name, call, plain in (
            ("quantize_2bit",
             lambda: comp.quantize_batch(layout, grads, arena, arena, T),
             lambda: comp.quantize_batch_ref(layout, grads, ref_arena,
                                             ref_arena, ref_codes, T)),
            ("dequantize_2bit",
             lambda: comp.dequantize_batch(layout, codes, T),
             lambda: comp.dequantize_batch_ref(layout, codes, out, T))):
        bms, by = bound_ms(name, elts, padded_elts)
        res[name] = {"ms": launch_ms[name], "call_ms": time_ms(call),
                     "plain_ms": time_ms(plain), "bound_ms": bms,
                     "bound_by": by, "elements": elts,
                     "padded_elements": padded_elts,
                     "entries": len(layout.sizes), "blocks": layout.n_tiles}
        print("kernels time: %s, one launch over the %d keys (%d blocks) | "
              "kernel %.4f ms (runs of %d launches), %.1f%% of the bound "
              "%.4f ms (%s) | wrapper call %.4f ms (host included) | plain "
              "%.3f ms | %s"
              % (name, len(layout.sizes), layout.n_tiles, res[name]["ms"],
                 RUN, 100 * bms / res[name]["ms"], bms, by,
                 res[name]["call_ms"], res[name]["plain_ms"], card),
              flush=True)
    return res


def check_small_net_against_cpu():
    """A small ResNet's logits on the card agree with the port on the
    CPU from the same weights (f32, TF32 off)."""
    nets = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        with mx.name.NameManager():
            nets[ctx] = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                                        [16, 32, 64, 128, 256], classes=10)
        nets[ctx].initialize(mx.init.Xavier(), ctx=ctx)
    x = np.random.RandomState(1).randn(4, 3, 32, 32).astype(np.float32)
    cpu_net, gpu_net = nets[mx.cpu()], nets[mx.gpu(0)]
    cpu_net(mx.nd.array(x, ctx=mx.cpu()))
    gpu_net(mx.nd.array(x, ctx=mx.gpu(0)))
    mx.convert.load_from_numpy(
        gpu_net, {n: p.data().asnumpy()
                  for n, p in cpu_net.collect_params().items()})
    with mx.autograd.train_mode():
        a = cpu_net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
        b = gpu_net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    err = float(np.abs(a - b).max())
    check(err <= 1e-4 * float(np.abs(a).max()) + 1e-5,
          "small ResNet logits: card vs CPU differ by %g" % err)
    return err


def timed_s(fn):
    """Host seconds of fn() through a synchronize, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def bench_trainer():
    """bench.py's build_trainer on the card: resnet50_v1, Xavier,
    SoftmaxCrossEntropyLoss, sgd lr 0.1 momentum 0.9, bf16_mixed, and a
    synthetic batch from RandomState(0)."""
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = parallel.ShardedTrainer(
        net, lambda o, l: loss_fn(o, l), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        dtype_policy="bf16_mixed")
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(SHARDED_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, SHARDED_BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    return trainer, x, y


def _self_device_us(ev):
    return getattr(ev, "self_device_time_total", None) or \
        getattr(ev, "self_cuda_time_total", 0.0)


def kernel_kind(name):
    name = name.lower()
    if any(k in name for k in ("conv", "cudnn", "xmma", "gemm", "sm90")):
        return "conv/gemm"
    if "norm" in name:
        return "batchnorm"
    if "foreach" in name or "multi_tensor" in name:
        return "foreach/update"
    if "cat" in name or "copy" in name:
        return "cat/copy/cast"
    return "elementwise/other"


def profile_step(trainer, x, y, step_s):
    """One step_many call under torch.profiler: the card's kernel time per
    step and its idle share against ``step_s`` (a step's time measured
    without the profiler), the spans on the card of the trainer's forward
    and update ranges (the backward runs on autograd's own thread, so it
    is the rest), the host time of each range, and the kernel time by
    kind.  A measurement only: a profiler failure is reported, not
    raised."""
    batches = [([x], y)] * trainer.steps_per_call
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.step_many(batches)
            torch.cuda.synchronize()
        trainer.drain()
        averages = prof.key_averages()
    except Exception as e:  # noqa: BLE001 - the profile is optional
        trainer.drain()
        return "not measured (torch.profiler failed: %r)" % (e,)
    k = trainer.steps_per_call
    kernels_, span, host = [], {}, {}
    for ev in averages:
        on_card = getattr(ev, "device_type", None) == DeviceType.CUDA
        if ev.key.startswith("ShardedTrainer."):
            # a range: its span on the card's timeline, and its host time
            name = ev.key.split(".", 1)[1]
            if on_card:
                span[name] = _self_device_us(ev) / 1e3 / k
            else:
                host[name] = ev.cpu_time_total / 1e3 / k
        elif on_card and _self_device_us(ev):
            kernels_.append((_self_device_us(ev), ev.key))
    total = sum(us for us, _ in kernels_)
    if not total:
        return "not measured (torch.profiler recorded no device time)"
    nan = float("nan")
    fwd, upd = span.get("forward", nan), span.get("update", nan)
    per_step = total / 1e3 / k
    kinds = {}
    for us, key in kernels_:
        kinds[kernel_kind(key)] = kinds.get(kernel_kind(key), 0.0) + us
    return ("per step: kernels %.2f ms = forward %.2f + backward %.2f + "
            "update %.2f (the forward's and the update's spans on the card; "
            "the backward is the rest), card idle %.1f%% of the timed "
            "async step's %.1f ms | host per step: forward %.2f, backward "
            "%.2f, update %.2f ms | kernel time by kind: %s | top: %s"
            % (per_step, fwd, per_step - fwd - upd, upd,
               100 * max(0.0, 1 - per_step / (1e3 * step_s)),
               1e3 * step_s,
               host.get("forward", nan), host.get("backward", nan),
               host.get("update", nan),
               ", ".join("%s %.1f%%" % (kind, 100 * v / total)
                         for kind, v in sorted(kinds.items(),
                                               key=lambda kv: -kv[1])),
               "; ".join("%s %.2f ms" % (key[:50], us / 1e3 / k)
                         for us, key in sorted(kernels_, reverse=True)[:5])))


def phase_sharded(card):
    """The benchmark of record's path through ShardedTrainer (see the
    module doc, phase 7)."""
    torch.cuda.reset_peak_memory_stats()
    trainer, x, y = bench_trainer()
    losses, kept, step_s = [], [], []

    def sync_step():
        skipped = trainer.skipped_steps
        dt, loss = timed_s(lambda: trainer.step([x], y))
        losses.append(float(loss))
        kept.append(trainer.skipped_steps == skipped)
        step_s.append(dt)

    for _ in range(2):
        sync_step()
    warm_s = list(step_s)
    del step_s[:]
    for _ in range(SYNC_STEPS):
        sync_step()
    sync_ips = SHARDED_BATCH * SYNC_STEPS / sum(step_s)
    trainer.configure_overlap(async_metrics=True, steps_per_call=4)
    batches = [([x], y)] * 4
    trainer.step_many(batches)
    torch.cuda.synchronize()
    trainer.drain()
    async_losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dispatch = []
        for _ in range(ASYNC_CALLS):
            t1 = time.perf_counter()
            async_losses.append(trainer.step_many(batches))
            dispatch.append(time.perf_counter() - t1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    async_s = time.perf_counter() - t0
    trainer.drain()
    async_steps = ASYNC_CALLS * 4
    async_ips = SHARDED_BATCH * async_steps / async_s
    async_losses = [float(v) for t in async_losses for v in t]
    peak = torch.cuda.max_memory_allocated()
    scale = trainer.loss_scale()
    check(all(np.isfinite(losses + async_losses)),
          "non-finite loss %s %s" % (losses, async_losses))
    check(True in kept, "every synchronous step was skipped: %s" % kept)
    first = losses[kept.index(True)]
    check(async_losses[-1] < first, "loss did not fall: first kept %.4f, "
          "last %.4f" % (first, async_losses[-1]))
    check(all(t.is_cuda for t in trainer.state_tensors()),
          "trainer state is not on the card")
    profile = profile_step(trainer, x, y, async_s / async_steps)
    print("sharded: resnet50_v1 bf16_mixed batch %d ShardedTrainer sgd lr "
          "0.1 momentum 0.9 | warm-up steps s %s (img/s %s) | sync %d "
          "steps %.1f img/s (step s median %.4f) | async step_many(4) x %d %.1f img/s "
          "(%.4f s per step, dispatch s per call %s, no host sync) | peak "
          "memory %.2f GB | losses sync %s async %s | loss scale %s | "
          "skipped %d | profile of one step_many(4): %s | %s"
          % (SHARDED_BATCH, ["%.3f" % s for s in warm_s],
             ["%.1f" % (SHARDED_BATCH / s) for s in warm_s], SYNC_STEPS,
             sync_ips, statistics.median(step_s), ASYNC_CALLS, async_ips,
             async_s / async_steps, ["%.4f" % s for s in dispatch],
             peak / 1e9, ["%.4f" % v for v in losses],
             ["%.4f" % v for v in async_losses], scale,
             trainer.skipped_steps, profile, card), flush=True)
    sharded_observed(trainer, x, y, card)
    trainer.close()
    return {"sync_ips": sync_ips, "async_ips": async_ips}


def _trace_kernels(path):
    """(kernel events, their names) of a torch.profiler Chrome trace."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in evs
             if e.get("cat") == "kernel" and e.get("ph") == "X"]
    return len(names), names


def sharded_observed(trainer, x, y, card):
    """Phase 7 with the observability layer on (see the module doc): the
    sync step median with the layer off and on, then step_many(4) under
    the sync-debug mode with it on (one metric flush a step); the
    counters, the step breakdown,
    the MFU gauge, the wide events and the goodput ledger checked; then
    one step under profiler.start/stop/dump and both trace files read."""
    obs = tempfile.mkdtemp(prefix="obs_")
    batches = [([x], y)] * trainer.steps_per_call
    rec = None

    def sync_steps(n):
        out = []
        for _ in range(n):
            dt, _ = timed_s(lambda: trainer.step([x], y))
            out.append(dt)
        return out

    try:
        # sync steps: each reads its loss (a flush a step)
        trainer.configure_overlap(async_metrics=False, metrics_every=1)
        off_s = sync_steps(OBS_STEPS)
        telemetry.reset()
        tracing.reset()
        events.reset()
        telemetry.set_peak_flops(H100_BF16_PEAK)
        telemetry.enable()
        tracing.enable()
        events.enable(path="", sample=1.0)
        # the ledger's wall starts here, not at the process's start
        rec = goodput.GoodputRecorder(os.path.join(obs, "goodput"), rank=0,
                                      n_procs=1).begin(start_reason="fresh",
                                                       started_at=time.time())
        # the first step with the layer on also counts the step's FLOPs
        # (FlopCounterMode over a throwaway step, after its window)
        warm_s, _ = timed_s(lambda: trainer.step([x], y))
        on_s = sync_steps(OBS_STEPS)
        trainer.configure_overlap(async_metrics=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer.step_many(batches)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        bd = trainer.step_breakdown()
        run = 1 + OBS_STEPS + trainer.steps_per_call
        steps = telemetry.TRAIN_STEPS.value(loop="sharded")
        check(steps == run, "TRAIN_STEPS %s after %d steps" % (steps, run))
        total = sum(bd.buckets().values())
        wall = bd.span_s + bd.gap_s
        check(bd.steps == run and abs(total - wall) <= BREAKDOWN_TOL * wall,
              "step_breakdown: %d steps, buckets %.6f s vs span + gap %.6f s"
              % (bd.steps, total, wall))
        flops = telemetry.TRAIN_STEP_FLOPS.value()
        mfu = telemetry.TRAIN_MFU.value()
        check(flops > 0 and mfu > 0, "TRAIN_STEP_FLOPS %s, TRAIN_MFU %s"
              % (flops, mfu))
        kinds = [e["kind"] for e in events.recent()]
        check(kinds == ["train_step"] * (2 + OBS_STEPS),
              "wide events %s" % kinds)
        loss = telemetry.TRAIN_LOSS.value()
        check(np.isfinite(loss) and loss > 0, "TRAIN_LOSS %s" % loss)
        rec.end("clean", step=trainer.global_step)
        gp = goodput.goodputz(dir=rec.dir)
        check(gp["active"] and gp["steps"] == run and gp["kills"] == 0,
              "goodput report: %s" % {k: gp.get(k) for k in
                                      ("active", "steps", "kills")})
        # profiler window: one step, both trace files
        profiler.set_config(filename=os.path.join(obs, "profile.json"))
        trainer.configure_overlap(async_metrics=False)
        torch.cuda.synchronize()
        profiler.start()
        check(profiler.last_error() is None, "profiler.start failed: %r"
              % (profiler.last_error(),))
        prof_s, _ = timed_s(lambda: trainer.step([x], y))
        profiler.stop()
        host_path = profiler.dump()
        with open(host_path) as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "span"]
        check(any(e["name"] == "ShardedTrainer.step" for e in spans),
              "profile.json holds no ShardedTrainer.step span")
        n_kern, names = _trace_kernels(profiler.device_trace_path())
        lib = [n for n in names if any(k in n.lower() for k in (
            "cudnn", "conv", "gemm", "sm90", "xmma", "cutlass", "nchw"))]
        check(n_kern > 0 and lib, "the device trace holds %d kernel events, "
              "%d of cuDNN/cuBLAS" % (n_kern, len(lib)))
        heartbeat = mx.monitor.TelemetryHeartbeat().line()
    finally:
        if rec is not None:
            rec.end("clean")
        goodput.set_dir(None)
        telemetry.disable()
        tracing.disable()
        events.disable()
        telemetry.set_peak_flops(None)
        profiler.set_config(filename="profile.json")
        shutil.rmtree(obs, ignore_errors=True)
    b = bd.as_dict()
    print("sharded observed: the same trainer, sync steps with the layer off "
          "%s s (median %.4f) and with telemetry, tracing, events and a "
          "goodput ledger on %s s (median %.4f; the first on-step %.4f s "
          "also counts the FLOPs) | step_many(4) under sync-debug 'error' "
          "with the layer on | TRAIN_STEPS %d = steps run | step breakdown "
          "ms a step %s, buckets sum %.4f vs span + gap %.4f | "
          "TRAIN_STEP_FLOPS %.4g (FlopCounterMode), TRAIN_MFU %.4f against "
          "%.0f TFLOP/s (data sheet, dense bf16, 700 W) | %d train_step "
          "events | goodput %.2f%% of %.2f s | heartbeat: %s | profiler "
          "window of one step %.4f s: profile.json %d spans, device trace "
          "%d kernel events, %d cuDNN/cuBLAS | %s"
          % (["%.4f" % v for v in off_s], statistics.median(off_s),
             ["%.4f" % v for v in on_s], statistics.median(on_s), warm_s,
             steps, b["buckets_ms_per_step"], 1e3 * total, 1e3 * wall,
             flops, mfu, H100_BF16_PEAK / 1e12, len(kinds),
             gp["goodput_pct"] or 0.0, gp["wall_s"], heartbeat, prof_s,
             len(spans), n_kern, len(lib), card), flush=True)
    return {"off_median_s": statistics.median(off_s),
            "on_median_s": statistics.median(on_s)}


def small_trainer(ctx, weights, **kw):
    with mx.name.NameManager():
        net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                              [16, 32, 64, 128, 256], classes=10)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(mx.nd.zeros((1, 3, 32, 32), ctx=ctx))
    if weights is not None:
        mx.convert.load_from_numpy(net, weights)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return net, parallel.ShardedTrainer(
        net, lambda o, l: loss_fn(o, l), optimizer="sgd",
        optimizer_params=dict(SMALL_SGD), **kw)


def check_small_sharded():
    """The small ResNet of tests/test_torch_sharded_trainer.py through
    ShardedTrainer: f32 losses on the card against the CPU, the guard on
    a NaN batch, and step_many(3) against 3 steps."""
    rng = np.random.RandomState(0)
    xs = [rng.randn(4, 3, 32, 32).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, 10, 4).astype(np.float32) for _ in range(3)]
    cpu_net, cpu_tr = small_trainer(mx.cpu(), None, on_nonfinite="skip")
    weights = {n: p.data().asnumpy()
               for n, p in cpu_net.collect_params().items()}
    _, gpu_tr = small_trainer(mx.gpu(0), weights, on_nonfinite="skip")
    losses = {}
    for ctx, tr in ((mx.cpu(), cpu_tr), (mx.gpu(0), gpu_tr)):
        losses[ctx] = [float(tr.step([mx.nd.array(x, ctx=ctx)],
                                     mx.nd.array(y, ctx=ctx)))
                       for x, y in zip(xs, ys)]
    a, b = np.array(losses[mx.cpu()]), np.array(losses[mx.gpu(0)])
    rel = float(np.max(np.abs(b - a) / np.abs(a)))
    check(rel <= 1e-5, "small ShardedTrainer losses card %s vs CPU %s"
          % (b, a))
    before = [t.clone() for t in gpu_tr.state_tensors()]
    bad = xs[0].copy()
    bad[0, 0, 0, 0] = np.nan
    loss = gpu_tr.step([mx.nd.array(bad, ctx=mx.gpu(0))],
                       mx.nd.array(ys[0], ctx=mx.gpu(0)))
    after = gpu_tr.state_tensors()
    check(not np.isfinite(float(loss)), "NaN batch gave a finite loss")
    check(len(before) == len(after)
          and all(torch.equal(u, v) for u, v in zip(before, after)),
          "the guard changed the state on a NaN batch")
    check(gpu_tr.skipped_steps == 1, "skipped %d steps, expected 1"
          % gpu_tr.skipped_steps)
    # step_many(3) against 3 steps: bit for bit with deterministic cuDNN
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, many = small_trainer(mx.gpu(0), weights, steps_per_call=3)
        _, one = small_trainer(mx.gpu(0), weights)
        batches = [([mx.nd.array(x, ctx=mx.gpu(0))],
                    mx.nd.array(y, ctx=mx.gpu(0))) for x, y in zip(xs, ys)]
        lm = many.step_many(batches)
        lo = torch.stack([one.step(*b) for b in batches])
        same = torch.equal(lm, lo) and all(
            torch.equal(u, v) for u, v in zip(many.state_tensors(),
                                              one.state_tensors()))
    finally:
        torch.backends.cudnn.deterministic = prev
    check(same, "step_many(3) differs from 3 steps: %s vs %s" % (lm, lo))
    print("sharded small: f32 losses card %s vs CPU %s (max rel %.3g) | NaN "
          "batch: state unchanged, skipped 1 | step_many(3) bit-equal to 3 "
          "steps (cudnn.deterministic)"
          % (["%.6f" % v for v in b], ["%.6f" % v for v in a], rel),
          flush=True)


def flash_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))


def flash_plain(q, k, v, causal):
    """The plain version on (B, T, H, D): (o, lse) in f32."""
    o, lse = attn._ref_attention_lse(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), q.shape[-1] ** -0.5,
                                     causal)
    return o.transpose(1, 2), lse.transpose(1, 2)


def bf16_share(o, ro, obar):
    """Worst share of the bf16 kernel's elementwise bound of the f32 plain
    version ro.  The kernel rounds each probability P to bf16 before P.V
    (relative error at most 2^-8) and sums l from the f32 P, so before
    its last rounding o is off by at most 2^-8 (P/l).|V| = 2^-8 obar,
    obar being the plain version run on |V|; rounding o to bf16 adds at
    most 2^-8 |o|.  Hence |o - ro| <= 2^-8 (|ro| + obar) + 5e-5, where
    5e-5 (the f32 bound) covers the f32 arithmetic and the second-order
    2^-16 obar."""
    return float(((o.float() - ro).abs()
                  / (BF16_O_REL * (ro.abs() + obar) + F32_O_TOL)).max())


def flash_bound_ms(shape, dtype, causal):
    """Least time of the forward: 4*B*H*D flops per live (q, k) pair over
    the peak of its type, or q, k, v read and o, lse written once over
    HBM, whichever is larger."""
    B, T, H, D = shape
    pairs = T * (T + 1) // 2 if causal else T * T
    t_ops = 4 * B * H * D * pairs / (F32_OPS_PER_S if dtype == torch.float32
                                     else BF16_OPS_PER_S)
    elt = torch.finfo(dtype).bits // 8
    t_bytes = (4 * B * T * H * D * elt + 4 * B * T * H) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_flash(shape, dtype, causal, seed, card):
    """Kernel vs plain version on one input; returns (max |do|, max |dlse|,
    worst share of the bf16 bound)."""
    q, k, v = flash_inputs(shape, dtype, seed)
    kernel = kernels.flash_kernel(dtype, shape[-1])
    before = dict(kernels.launch_counts)
    o, lse = kernels.flash_attention_fwd(q, k, v, shape[-1] ** -0.5, causal)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(launched == {n: int(n == kernel) for n in launched},
          "%s %s: launches %s, expected one of %s"
          % (dtype, shape, launched, kernel))
    qf, kf, vf = (t.float() for t in (q, k, v))
    ro, rlse = flash_plain(qf, kf, torch.cat([vf, vf.abs()], -1), causal)
    ro, obar = ro.chunk(2, dim=-1)
    torch.cuda.synchronize()
    err_o = float((o.float() - ro).abs().max())
    err_lse = float((lse - rlse).abs().max())
    share = bf16_share(o, ro, obar)
    del qf, kf, vf, ro, rlse, obar
    check(bool(torch.isfinite(o).all()), "non-finite flash output at %s"
          % (shape,))
    name = "f32" if dtype == torch.float32 else "bf16"
    check(err_lse <= F32_LSE_TOL, "flash %s %s causal=%s: |dlse| %g"
          % (name, shape, causal, err_lse))
    if dtype == torch.float32:
        check(err_o <= F32_O_TOL, "flash f32 %s causal=%s: |do| %g"
              % (shape, causal, err_o))
        reading = ("max|do| %.3g (limit %g), max|dlse| %.3g (limit %g)"
                   % (err_o, F32_O_TOL, err_lse, F32_LSE_TOL))
    else:
        check(err_o <= BF16_TOL and share <= 1.0,
              "flash bf16 %s causal=%s: |do| %g, |do|/(2^-8(|o|+obar)+%g) "
              "%g vs the f32 plain version" % (shape, causal, err_o,
                                               F32_O_TOL, share))
        reading = ("max|do| vs f32 plain %.3g (limit %g), max|do|/(2^-8"
                   "(|o|+obar)+%g) %.3g (limit 1), max|dlse| %.3g (limit %g)"
                   % (err_o, BF16_TOL, F32_O_TOL, share, err_lse,
                      F32_LSE_TOL))
    print("flash: %s %s causal=%s on %s | %s | %s"
          % (name, shape, causal, kernel, reading, card), flush=True)
    return err_o, err_lse, share


def phase_flash(card):
    torch.set_float32_matmul_precision("highest")
    # per (kernel, input type): worst |do| or |dlse|, worst bf16 share
    worst, bf16_worst_share = {}, {}
    cases = [(LM_SHAPE, c) for c in (False, True)] + [(LONG_SHAPE, False)]
    cases += [((2, 1024, 4, d), c) for d in (16, 128) for c in (False, True)]
    cases += [(shape, c) for shape in WIDE_CASES for c in (False, True)]
    for i, (shape, causal) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            err_o, err_lse, share = check_flash(shape, dtype, causal, i, card)
            key = kernels.flash_kernel(dtype, shape[-1]), dtype
            worst[key] = max(worst.get(key, 0.0), err_o, err_lse)
            if dtype == torch.bfloat16:
                bf16_worst_share[key] = max(bf16_worst_share.get(key, 0.0),
                                            share)
    # gradient through the autograd Function, loss on both o and lse
    q, k, v = (t.requires_grad_() for t in flash_inputs(LM_SHAPE,
                                                        torch.float32, 99))
    w_o = torch.randn(LM_SHAPE, device="cuda")
    w_l = torch.randn(LM_SHAPE[:3], device="cuda")
    grads = []
    for fn in (lambda: attn.flash_attention_with_lse(q, k, v, causal=True),
               lambda: flash_plain(q, k, v, True)):
        o, lse = fn()
        grads.append(torch.autograd.grad((o * w_o).sum() + (lse * w_l).sum(),
                                         (q, k, v)))
    err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    check(err <= GRAD_TOL, "flash gradients differ by %g" % err)
    print("flash grad: %s causal f32, dq/dk/dv via the Function vs plain "
          "autograd | max|dg| %.3g (limit %g) | %s"
          % (LM_SHAPE, err, GRAD_TOL, card), flush=True)
    return worst, bf16_worst_share


def phase_sp(card):
    """The sequence-parallel path on a one-card mesh at the long context,
    in f32 and in bf16: returns the launch counts of this run, and per
    type the worst |difference| from local_attention, the worst share of
    the bf16 bound and the engines' times."""
    telemetry.reset()
    telemetry.enable()      # the mesh gauge and the engines' bytes
    try:
        mesh = parallel.make_mesh({"sp": 1})
        inputs = {dtype: flash_inputs(LONG_SHAPE, dtype, 7)
                  for dtype in (torch.float32, torch.bfloat16)}
        engines = (("ulysses", functools.partial(
                        parallel.ulysses_attention_sharded, mesh,
                        use_flash=True)),
                   ("ring", functools.partial(
                        parallel.ring_attention_sharded, mesh,
                        use_flash=True)))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs, per_call = {}, {}
        for dtype, qkv in inputs.items():
            for name, fn in engines:
                before = dict(kernels.launch_counts)
                outs[dtype, name] = fn(*qkv)
                per_call[dtype, name] = {n: c - before[n] for n, c
                                         in kernels.launch_counts.items()}
        torch.cuda.synchronize()
        coll = {op: telemetry.COLLECTIVE_BYTES.value(axis="sp", op=op)
                for op in ("all_to_all", "ppermute")}
        mesh_sp = telemetry.MESH_DEVICES.value(axis="sp")
    finally:
        telemetry.disable()
        telemetry.reset()
    # each ulysses call counts q, k, v and the output (4 x q's bytes
    # here); each ring call its K and V
    want_coll = {"all_to_all": sum(4 * q.nbytes for q, _, _
                                   in inputs.values()),
                 "ppermute": sum(k.nbytes + v.nbytes for _, k, v
                                 in inputs.values())}
    check(coll == want_coll and mesh_sp == 1,
          "sp: COLLECTIVE_BYTES %s, expected %s; MESH_DEVICES{sp} %s"
          % (coll, want_coll, mesh_sp))
    launches = dict(kernels.launch_counts)
    errs, shares, times = {}, {}, {}
    for dtype, (q, k, v) in inputs.items():
        qf, kf, vf = (t.float() for t in (q, k, v))
        # local_attention in f32 on the same values, on v and |v| at once
        ref, obar = parallel.local_attention(
            qf, kf, torch.cat([vf, vf.abs()], -1),
            scale=LONG_SHAPE[-1] ** -0.5).chunk(2, dim=-1)
        del qf, kf, vf
        for name, _ in engines:
            want = {n: int(n == kernels.flash_kernel(dtype, LONG_SHAPE[-1]))
                    for n in launches}
            check(per_call[dtype, name] == want, "%s %s launched %s, expected "
                  "%s" % (name, dtype, per_call[dtype, name], want))
            out = outs.pop((dtype, name))
            check(out.shape == LONG_SHAPE and out.dtype == dtype,
                  "%s output %s %s" % (name, tuple(out.shape), out.dtype))
            errs[dtype, name] = float((out.float() - ref).abs().max())
            if dtype == torch.float32:
                check(errs[dtype, name] <= F32_O_TOL, "%s f32 differs from "
                      "local_attention by %g" % (name, errs[dtype, name]))
            else:
                shares[name] = bf16_share(out, ref, obar)
                check(errs[dtype, name] <= BF16_TOL and shares[name] <= 1.0,
                      "%s bf16 differs from local_attention by %g, %g of the "
                      "bf16 bound" % (name, errs[dtype, name], shares[name]))
        del ref, obar
        times[dtype] = {name: time_ms(functools.partial(fn, q, k, v))
                        for name, fn in engines}
    dist.destroy_process_group()
    for dtype in inputs:
        tn = "f32" if dtype == torch.float32 else "bf16"
        print("sp: make_mesh({'sp': 1}) %s %s, use_flash=True | %s | %s"
              % (LONG_SHAPE, tn, "; ".join(
                  "%s max|do| vs local_attention %.3g (limit %g)%s, %.3f ms"
                  % (n, errs[dtype, n],
                     F32_O_TOL if dtype == torch.float32 else BF16_TOL,
                     "" if dtype == torch.float32 else
                     ", %.3g of the bf16 bound (limit 1)" % shares[n],
                     times[dtype][n]) for n, _ in engines), card),
              flush=True)
    print("sp: launches %s (one per engine call per type) | telemetry on "
          "for the checked calls: COLLECTIVE_BYTES{sp} %s (the engines' "
          "calls, as counted), MESH_DEVICES{sp} %d | %s"
          % (launches, {k: int(v) for k, v in coll.items()}, mesh_sp, card),
          flush=True)
    worst = {dtype: max(e for (d, _), e in errs.items() if d == dtype)
             for dtype in inputs}
    return launches, worst, max(shares.values()), times


def build_lm(cfg, ctx, seed=0):
    """The port's LM, Xavier from a seeded generator; names start at
    transformerlm0 (parameters deferred until the first forward)."""
    mx.random.seed(seed)
    with mx.name.NameManager():
        lm = TransformerLM(**cfg)
    lm.initialize(mx.init.Xavier(), ctx=ctx)
    return lm


def drive_engine(eng, prompts, steps):
    """Admit every prompt, then run ``steps`` decode steps; each admit
    and step timed on the host clock (both end in a host read of the
    tokens, which waits for the card).  Returns the tokens per slot, the
    logits of each admit and step, and the times in ms."""
    toks, first_logits, admit_ms, step_ms, logits = {}, {}, [], [], []
    for p in prompts:
        t0 = time.perf_counter()
        slot, tok = eng.admit(p)
        admit_ms.append(1e3 * (time.perf_counter() - t0))
        toks[slot] = [tok]
        first_logits[slot] = eng.last_logits[0]
    for _ in range(steps):
        t0 = time.perf_counter()
        out = eng.decode_step()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        for slot, tok in out.items():
            toks[slot].append(tok)
        logits.append(eng.last_logits)
    return toks, first_logits, logits, admit_ms, step_ms


def fed_sequences(prompts, toks, steps):
    """Per slot, the prompt and the tokens fed back by ``steps`` steps."""
    return np.stack([np.concatenate([p, toks[s][:steps]])
                     for s, p in enumerate(prompts)])


def profile_decode(eng, step_ms):
    """DECODE_PROFILE_STEPS decode steps under torch.profiler: kernels a
    step, the card's kernel time a step and its idle share against the
    unprofiled median step.  A measurement only: a profiler failure is
    reported, not raised."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(DECODE_PROFILE_STEPS):
                eng.decode_step()
            torch.cuda.synchronize()
        averages = prof.key_averages()
    except Exception as e:  # noqa: BLE001 - the profile is optional
        return "not measured (torch.profiler failed: %r)" % (e,)
    n = DECODE_PROFILE_STEPS
    rows = [(_self_device_us(ev), ev.count, ev.key) for ev in averages
            if getattr(ev, "device_type", None) == DeviceType.CUDA
            and _self_device_us(ev)]
    total = sum(us for us, _, _ in rows)
    if not total:
        return "not measured (torch.profiler recorded no device time)"
    kernel_ms = total / 1e3 / n
    step = statistics.median(step_ms)
    return ("kernels %.1f a step, card kernel time %.3f ms a step against "
            "the host's %.3f ms step (median, unprofiled): card idle "
            "%.1f%% | top: %s"
            % (sum(c for _, c, _ in rows) / n, kernel_ms, step,
               100 * max(0.0, 1 - kernel_ms / step),
               "; ".join("%s %.3f ms" % (key[:40], us / 1e3 / n)
                         for us, _, key in sorted(rows, reverse=True)[:4])))


def decode_line(tag, eng, admit_ms, step_ms, profile, card):
    steps = len(step_ms)
    print("decode %s: LM %s, GenerationEngine(slots=%d, cache_len=%d, "
          "buckets %s) greedy, cache %s | %d prompts of %d tokens, prefill "
          "ms per admit median %.3f | %d steps over %d slots: step ms "
          "median %.3f (min %.3f, max %.3f), %.1f tokens/s | profile of "
          "%d steps: %s | peak memory %.3f GB | %s"
          % (tag, DECODE_LM, eng.slots, eng.cache_len, eng.buckets,
             str(eng.cache_dtype)[6:], DECODE_SLOTS, DECODE_PROMPT,
             statistics.median(admit_ms), steps, DECODE_SLOTS,
             statistics.median(step_ms), min(step_ms), max(step_ms),
             DECODE_SLOTS * steps / (sum(step_ms) / 1e3),
             DECODE_PROFILE_STEPS, profile,
             torch.cuda.max_memory_allocated() / 1e9, card), flush=True)


def check_small_lm_against_cpu():
    """tests/test_generate.py's LM on the card and on the CPU from the
    same weights: f32 logits and greedy engine tokens."""
    cpu_lm = build_lm(SMALL_LM, mx.cpu(), seed=3)
    tokens = np.random.RandomState(3).randint(
        0, SMALL_LM["vocab_size"], (2, 12))
    a = cpu_lm(mx.nd.array(tokens, ctx=mx.cpu(), dtype="float32")).asnumpy()
    weights = {n: p.data().asnumpy()
               for n, p in cpu_lm.collect_params().items()}
    gpu_lm = build_lm(SMALL_LM, mx.gpu(0), seed=4)
    mx.convert.load_from_numpy(gpu_lm, weights)
    b = gpu_lm(mx.nd.array(tokens, ctx=mx.gpu(0), dtype="float32")).asnumpy()
    err = float(np.abs(a - b).max())
    check(err <= SMALL_LM_RTOL * float(np.abs(a).max()),
          "small LM logits: card vs CPU differ by %g" % err)
    greedy = []
    for lm, dev in ((cpu_lm, mx.cpu()), (gpu_lm, mx.gpu(0))):
        eng = generate.GenerationEngine(lm, slots=2, cache_len=24,
                                        buckets=[8, 24], device=dev,
                                        dtype_policy="f32")
        slot, tok = eng.admit(tokens[0, :6])
        greedy.append([tok] + [eng.decode_step()[slot] for _ in range(8)])
    check(greedy[0] == greedy[1], "small LM greedy tokens: CPU %s, card %s"
          % tuple(greedy))
    return err / float(np.abs(a).max())


def phase_decode(card):
    """The LM serving path at bench_decode's full width (module doc,
    phase 8)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    before = dict(kernels.launch_counts)
    greedy = generate.SamplingConfig(greedy=True)
    prompts = list(np.random.RandomState(0).randint(
        0, DECODE_LM["vocab_size"], (DECODE_SLOTS, DECODE_PROMPT)))
    lm = build_lm(DECODE_LM, mx.gpu(0))

    # f32: decode and prefill logits against the full forward
    torch.cuda.reset_peak_memory_stats()
    eng = generate.GenerationEngine(lm, slots=DECODE_SLOTS,
                                    cache_len=DECODE_CACHE,
                                    sampling=greedy, dtype_policy="f32")
    n_params = sum(p.data().size for p in lm.collect_params().values())
    check(eng.device.type == "cuda" and eng.cache_dtype == torch.float32,
          "f32 engine on %s, cache %s" % (eng.device, eng.cache_dtype))
    toks, first, logits, admit_ms, step_ms = drive_engine(
        eng, prompts, DECODE_STEPS)
    ring = {"prompts": prompts, "toks": toks, "first": first,
            "logits": logits, "step_ms": step_ms}
    profile = profile_decode(eng, step_ms)
    decode_line("f32", eng, admit_ms, step_ms, profile, card)
    seqs = fed_sequences(prompts, toks, DECODE_STEPS)
    with torch.inference_mode():
        full = lm(mx.nd.array(seqs, ctx=mx.gpu(0),
                              dtype="float32")).asnumpy()
    top2 = np.sort(full, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    err, err_prefill, excluded, compared = 0.0, 0.0, 0, 0
    prefill_equal = True
    for s in range(DECODE_SLOTS):
        ref = full[s, DECODE_PROMPT - 1]
        d = np.abs(first[s] - ref)
        prefill_equal &= bool(np.array_equal(first[s], ref))
        err_prefill = max(err_prefill, float(d.max()))
        check(np.all(d <= F32_LOGIT_TOL + F32_LOGIT_TOL * np.abs(ref)),
              "slot %d prefill logits differ from the full forward by %g"
              % (s, float(d.max())))
        for j in range(DECODE_STEPS + 1):
            pos = DECODE_PROMPT - 1 + j
            if j:
                ref = full[s, pos]
                got = logits[j - 1][s]
                d = np.abs(got - ref)
                err = max(err, float(d.max()))
                check(np.all(d <= F32_LOGIT_TOL + F32_LOGIT_TOL
                             * np.abs(ref)),
                      "slot %d step %d logits differ from the full forward "
                      "by %g" % (s, j, float(d.max())))
            if gap[s, pos] > GAP_TOL:
                compared += 1
                check(toks[s][j] == int(full[s, pos].argmax()),
                      "slot %d token %d: engine %d, full forward %d (top-2 "
                      "gap %g)" % (s, j, toks[s][j], full[s, pos].argmax(),
                                   gap[s, pos]))
            else:
                excluded += 1
    del full
    print("decode f32 check: %d slots x %d steps, decode logits vs net(tokens) "
          "max|d| %.3g (limit %g + %g|ref|), prefill (bucket %d) vs net(tokens) "
          "max|d| %.3g, bit-equal %s | greedy tokens equal to the full "
          "forward's argmax at %d positions, %d left out (top-2 gap <= %g) "
          "| %d parameters | %s"
          % (DECODE_SLOTS, DECODE_STEPS, err, F32_LOGIT_TOL, F32_LOGIT_TOL,
             eng.bucket_for(DECODE_PROMPT), err_prefill, prefill_equal,
             compared, excluded, GAP_TOL, n_params, card), flush=True)
    del eng

    # the ring wraps: cache 64 < max_len, one lane up to at_capacity
    wrap = generate.GenerationEngine(lm, slots=1, cache_len=WRAP_CACHE,
                                     sampling=greedy, dtype_policy="f32")
    slot, tok = wrap.admit(prompts[0])
    produced = [tok]
    while not wrap.at_capacity(slot):
        produced.append(wrap.decode_step()[slot])
        check(np.all(np.isfinite(wrap.last_logits)), "wrap logits not finite")
    want = DECODE_LM["max_len"] - DECODE_PROMPT + 1
    check(len(produced) == want and all(0 <= t < DECODE_LM["vocab_size"]
                                        for t in produced),
          "wrap lane produced %d tokens, expected %d" % (len(produced), want))
    print("decode wrap: cache_len %d, one lane from %d to max_len %d: %d "
          "tokens, logits finite | %s"
          % (WRAP_CACHE, DECODE_PROMPT, DECODE_LM["max_len"], len(produced),
             card), flush=True)
    del wrap

    # bf16_mixed: decode logits against the policy's prefill
    torch.cuda.reset_peak_memory_stats()
    eng = generate.GenerationEngine(lm, slots=DECODE_SLOTS,
                                    cache_len=DECODE_CACHE,
                                    sampling=greedy,
                                    dtype_policy="bf16_mixed")
    check(eng.cache_dtype == torch.bfloat16 and
          eng.dtype_policy_tag == "bf16_mixed",
          "bf16_mixed cache %s tag %s" % (eng.cache_dtype,
                                          eng.dtype_policy_tag))
    toks16, _, logits16, admit_ms, step_ms = drive_engine(
        eng, prompts, DECODE_STEPS)
    profile = profile_decode(eng, step_ms)
    decode_line("bf16_mixed", eng, admit_ms, step_ms, profile, card)
    policy = mx.dtype_policy.get_policy("bf16_mixed")
    params = list(lm.collect_params().values())
    cast = [policy.cast_compute(p.name, p.data()._data) for p in params]
    seqs = fed_sequences(prompts, toks16, DECODE_STEPS)
    with torch.inference_mode(), mx.dtype_policy.scope(policy), \
            mx.gluon.block.swapped_params(params, cast):
        ref_nd, _ = lm.prefill_forward(mx.nd.array(seqs, ctx=mx.gpu(0),
                                                   dtype="int64"))
        ref = policy.cast_output(ref_nd._data).cpu().numpy()
    del cast, ref_nd
    err16, agree = 0.0, 0
    for j in range(1, DECODE_STEPS + 1):
        r = ref[:, DECODE_PROMPT - 1 + j]
        d = np.abs(logits16[j - 1] - r)
        err16 = max(err16, float(d.max()))
        check(np.all(d <= BF16_ATOL + BF16_RTOL * np.abs(r)),
              "bf16 step %d logits differ from the policy's prefill by %g"
              % (j, float(d.max())))
        agree += int((logits16[j - 1].argmax(-1) == r.argmax(-1)).sum())
    print("decode bf16_mixed check: cache bfloat16, decode logits vs the "
          "policy's prefill of the same sequences max|d| %.3g (limit %g + "
          "%g|ref|), argmax equal at %d of %d | %s"
          % (err16, BF16_ATOL, BF16_RTOL, agree, DECODE_SLOTS * DECODE_STEPS,
             card), flush=True)

    # the server over the bf16 engine answers with the engine's tokens;
    # evicting in reverse order frees the lanes so that the requests take
    # slots 0, 1, ... as the engine's own run did
    for s in reversed(eng.active_slots()):
        eng.evict(s, "length")
    telemetry.reset()
    events.reset()
    telemetry.enable()
    tracing.enable()
    events.enable(path="", sample=1.0)
    try:
        t0 = time.perf_counter()
        with generate.TokenServer(eng, queue_depth=DECODE_SLOTS) as srv:
            futs = [srv.submit(p, max_new_tokens=SERVER_NEW)
                    for p in prompts]
            results = [f.result(timeout=120) for f in futs]
        server_s = time.perf_counter() - t0
        evs = [e for e in events.recent() if e["kind"] == "token_request"]
        decode_tokens = telemetry.DECODE_TOKENS.value()
        finished = telemetry.DECODE_REQUESTS_FINISHED.value(reason="length")
    finally:
        telemetry.disable()
        tracing.disable()
        events.disable()
        telemetry.reset()
        events.reset()
    served = sum(len(r.tokens) for r in results)
    check(len(evs) == len(results)
          and all(e["outcome"] == "ok" and e.get("reason") == "length"
                  and set(e["stages_s"]) == {"queue", "prefill", "decode"}
                  for e in evs)
          and sorted(e["tokens"] for e in evs)
          == sorted(len(r.tokens) for r in results),
          "decode server wide events: %s" % [(e["outcome"], e.get("reason"),
                                              sorted(e.get("stages_s", {})))
                                             for e in evs])
    # each request's first token comes from its prefill, the rest from
    # decode steps (DECODE_TOKENS counts those)
    check(decode_tokens == served - len(results)
          and finished == len(results),
          "DECODE_TOKENS %s for %d tokens served to %d requests; finished %s"
          % (decode_tokens, served, len(results), finished))
    for i, r in enumerate(results):
        check(r.finish_reason == "length" and len(r.tokens) == SERVER_NEW,
              "request %d finished %s with %d tokens"
              % (i, r.finish_reason, len(r.tokens)))
        check(r.tokens == toks16[i][:SERVER_NEW], "request %d: server tokens "
              "differ from the engine's alone" % i)
    print("decode server: TokenServer over the bf16_mixed engine, %d "
          "requests of max_new_tokens %d: all 'length', tokens equal to the "
          "engine's alone | %.3f s, %.1f tokens/s, ttft s median %.4f "
          "(telemetry, tracing and events on) | %d 'ok' token_request "
          "events with queue/prefill/decode stages, DECODE_TOKENS %d = %d "
          "served less %d first tokens from the prefills | %s"
          % (len(results), SERVER_NEW, server_s,
             len(results) * SERVER_NEW / server_s,
             statistics.median(r.ttft_s for r in results), len(evs),
             decode_tokens, served, len(results), card), flush=True)
    del eng

    rel = check_small_lm_against_cpu()
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the decode path launched %s"
          % launched)
    print("decode reference: small LM %s card vs CPU logits max|d| %.3g of "
          "max|logit| (limit %g), greedy tokens equal | hand-written kernels "
          "launched on the decode path: %s (none is on it) | %s"
          % (SMALL_LM, rel, SMALL_LM_RTOL, launched, card), flush=True)
    return lm, ring


def drive_paged(eng, prompts, steps):
    """drive_engine for the paged engine: each admit is one prefill chunk
    here (prompts shorter than the chunk); decode steps return lists.
    Returns the tokens per slot, the logits of each admit's last prompt
    position and of each step, and the times in ms."""
    toks, first, chunk_ms, step_ms, logits = {}, {}, [], [], []
    for p in prompts:
        t0 = time.perf_counter()
        slot, tok = eng.admit(p)
        chunk_ms.append(1e3 * (time.perf_counter() - t0))
        toks[slot] = [tok]
        first[slot] = eng.last_logits[0, len(p) - 1]
    for _ in range(steps):
        t0 = time.perf_counter()
        out = eng.decode_step()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        for slot, got in out.items():
            toks[slot].extend(got)
        logits.append(eng.last_logits[:, 0])
    return toks, first, logits, chunk_ms, step_ms


def top2_gap(lm, prompt, toks):
    """The full forward's top-2 gap at the position after ``prompt`` +
    ``toks`` (f32, TF32 off)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(toks, np.int64)])
    with torch.inference_mode():
        row = lm(mx.nd.array(seq[None], ctx=mx.gpu(0), dtype="float32")
                 )._data[0, -1].float().cpu().numpy()
    top2 = np.sort(row)[-2:]
    return float(top2[1] - top2[0])


def same_tokens(lm, prompt, got, want, what):
    """``got`` equals ``want``, or the two part where the full forward of
    ``want``'s sequence has a top-2 gap <= GAP_TOL (a tie the two paths
    may break apart; such a pair is compared no further).  Returns 1
    when they parted at a tie, else 0."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            gap = top2_gap(lm, prompt, want[:j])
            check(gap <= GAP_TOL, "%s: token %d is %d, expected %d (top-2 "
                  "gap %g)" % (what, j, a, b, gap))
            return 1
    check(len(got) == len(want), "%s: %d tokens, expected %d"
          % (what, len(got), len(want)))
    return 0


def paged_f32_check(eng, ring, toks, first, logits):
    """Every paged logit within 1e-4 + 1e-4 |ref| of the ring engine's
    at the same position while the two slots were fed the same tokens;
    tokens equal wherever the ring's top-2 gap exceeds 1e-3.  Returns the
    largest |d|, the positions compared and left out, and the slots whose
    tokens parted at a tie."""
    err, compared, excluded, parted = 0.0, 0, 0, 0
    for s in range(DECODE_SLOTS):
        for j in range(DECODE_STEPS + 1):
            ref = ring["first"][s] if j == 0 else ring["logits"][j - 1][s]
            got = first[s] if j == 0 else logits[j - 1][s]
            d = np.abs(got - ref)
            err = max(err, float(d.max()))
            check(np.all(d <= F32_LOGIT_TOL + F32_LOGIT_TOL * np.abs(ref)),
                  "paged slot %d step %d logits differ from the ring "
                  "engine's by %g" % (s, j, float(d.max())))
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] <= GAP_TOL:
                excluded += 1
                if toks[s][j] != ring["toks"][s][j]:
                    parted += 1
                    break
                continue
            compared += 1
            check(toks[s][j] == ring["toks"][s][j],
                  "paged slot %d token %d: %d, ring %d" % (
                      s, j, toks[s][j], ring["toks"][s][j]))
    return err, compared, excluded, parted


def run_server(eng, prompts, max_new):
    """``prompts`` through a TokenServer over ``eng``; results in order
    and the wall time."""
    t0 = time.perf_counter()
    with generate.TokenServer(eng, queue_depth=len(prompts)) as srv:
        futs = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
        results = [f.result(timeout=300) for f in futs]
    return results, time.perf_counter() - t0


def gen_paged(eng, prompt, n):
    """``n`` tokens of one sequence through admit and decode steps;
    returns them and the decode steps taken."""
    slot, tok = eng.admit(prompt)
    out, steps = [tok], 0
    while len(out) < n:
        out.extend(eng.decode_step()[slot])
        steps += 1
    eng.evict(slot, "length")
    return out[:n], steps


def phase_paged(card, lm, ring):
    """The paged engine at bench_decode's full width (module doc, phase
    9); ``lm`` and ``ring`` are phase 8's LM and its f32 ring run."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    before = dict(kernels.launch_counts)
    greedy = generate.SamplingConfig(greedy=True)
    prompts = ring["prompts"]
    vocab = DECODE_LM["vocab_size"]

    # f32 decode against the ring engine
    torch.cuda.reset_peak_memory_stats()
    eng = generate.PagedGenerationEngine(
        lm, slots=DECODE_SLOTS, cache_len=DECODE_CACHE, page_size=PAGE,
        prefill_chunk=PAGED_CHUNK, sampling=greedy, dtype_policy="f32")
    check(eng.device.type == "cuda" and eng.cache_dtype == torch.float32
          and eng.num_pages == DECODE_SLOTS * DECODE_CACHE // PAGE + 1,
          "paged engine on %s, cache %s, %d pages"
          % (eng.device, eng.cache_dtype, eng.num_pages))
    toks, first, logits, chunk_ms, step_ms = drive_paged(
        eng, prompts, DECODE_STEPS)
    pages = eng.pages_in_use()
    check(pages == DECODE_SLOTS * DECODE_CACHE // PAGE,
          "%d pages in use with %d slots live" % (pages, DECODE_SLOTS))
    err, compared, excluded, parted = paged_f32_check(eng, ring, toks,
                                                      first, logits)
    profile = profile_decode(eng, step_ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print("paged: LM %s, PagedGenerationEngine(slots=%d, cache_len=%d, "
          "page_size=%d, prefill_chunk=%d) greedy f32, %d pages | %d "
          "prompts of %d tokens, prefill-chunk ms median %.3f | %d steps "
          "over %d slots: step ms median %.3f (min %.3f, max %.3f; the "
          "ring engine's in phase 8: %.3f), %.1f tokens/s | pages in use %d "
          "| profile of %d steps: %s | peak memory %.3f GB | %s"
          % (DECODE_LM, eng.slots, eng.cache_len, eng.page_size,
             eng.prefill_chunk, eng.num_pages, DECODE_SLOTS, DECODE_PROMPT,
             statistics.median(chunk_ms), DECODE_STEPS, DECODE_SLOTS,
             statistics.median(step_ms), min(step_ms), max(step_ms),
             statistics.median(ring["step_ms"]),
             DECODE_SLOTS * DECODE_STEPS / (sum(step_ms) / 1e3), pages,
             DECODE_PROFILE_STEPS, profile, peak, card), flush=True)
    print("paged f32 check: logits vs the ring engine's max|d| %.3g (limit "
          "%g + %g|ref|) | greedy tokens equal at %d positions, %d left out "
          "(ring top-2 gap <= %g), %d slots parted at such a tie | %s"
          % (err, F32_LOGIT_TOL, F32_LOGIT_TOL, compared, excluded,
             GAP_TOL, parted, card), flush=True)
    del eng

    # chunked prefill: one long prompt in chunks of 16 and in one chunk
    long_prompt = np.random.RandomState(1).randint(0, vocab, LONG_PROMPT)
    runs = []
    for chunk in (LONG_CHUNK, LONG_PROMPT):
        e = generate.PagedGenerationEngine(
            lm, slots=1, cache_len=DECODE_CACHE, page_size=PAGE,
            prefill_chunk=chunk, sampling=greedy, dtype_policy="f32")
        t0 = time.perf_counter()
        slot, tok = e.admit(long_prompt)
        ms = 1e3 * (time.perf_counter() - t0)
        rows = [e.last_logits[0, (LONG_PROMPT - 1) % chunk]]
        out = [tok]
        for _ in range(LONG_STEPS):
            out.extend(e.decode_step()[slot])
            rows.append(e.last_logits[slot, 0])
        runs.append((ms, e._chunks_run, out, rows))
        del e
    (c_ms, c_n, c_toks, c_rows), (s_ms, s_n, s_toks, s_rows) = runs
    check(c_n == LONG_PROMPT // LONG_CHUNK + LONG_STEPS and
          s_n == 1 + LONG_STEPS, "chunks run %d / %d" % (c_n, s_n))
    long_err = 0.0
    for j, (a, b) in enumerate(zip(c_rows, s_rows)):
        d = np.abs(a - b)
        long_err = max(long_err, float(d.max()))
        check(np.all(d <= F32_LOGIT_TOL + F32_LOGIT_TOL * np.abs(b)),
              "chunked prefill logits %d differ from one chunk's by %g"
              % (j, float(d.max())))
        if c_toks[j] != s_toks[j]:
            break
    long_parted = same_tokens(lm, long_prompt, c_toks, s_toks,
                              "chunked prefill")
    print("paged chunked prefill: a %d-token prompt in %d chunks of %d "
          "(%.3f ms) against one chunk of %d (%.3f ms): first-token and "
          "%d decode logits max|d| %.3g (limit %g + %g|ref|), tokens "
          "equal%s | %s"
          % (LONG_PROMPT, LONG_PROMPT // LONG_CHUNK, LONG_CHUNK, c_ms,
             LONG_PROMPT, s_ms, LONG_STEPS, long_err, F32_LOGIT_TOL,
             F32_LOGIT_TOL, " (parted at a tie)" if long_parted else "",
             card), flush=True)

    # prefix sharing: bench_decode --prefix-share's shape through a server
    rng = np.random.RandomState(0)
    system = rng.randint(0, vocab, SHARE_SYSTEM)
    users = [np.concatenate([system, rng.randint(0, vocab, SHARE_TAIL)])
             for _ in range(SHARE_USERS)]
    share = {}
    for on in (True, False):
        e = generate.PagedGenerationEngine(
            lm, slots=SHARE_SLOTS, cache_len=DECODE_CACHE, page_size=PAGE,
            prefill_chunk=PAGED_CHUNK, prefix_share=on, sampling=greedy,
            dtype_policy="f32")
        results, secs = run_server(e, users, SHARE_NEW)
        share[on] = ([r.tokens for r in results], secs, e.prefix_hit_rate(),
                     e._chunks_run)
        check(e.pages_in_use() == 0 and e.free_slots() == SHARE_SLOTS,
              "the server left %d pages, %d free slots"
              % (e.pages_in_use(), e.free_slots()))
        del e
    share_parted = sum(same_tokens(lm, u, a, b, "prefix share user %d" % i)
                       for i, (u, a, b) in enumerate(zip(
                           users, share[True][0], share[False][0])))
    hit = share[True][2]
    check(hit is not None and hit > 0 and share[False][2] is None,
          "prefix hit rate %r with sharing, %r without" % (hit,
                                                           share[False][2]))
    total = SHARE_USERS * (SHARE_SYSTEM + SHARE_TAIL + SHARE_NEW)
    print("paged prefix share: %d users behind one %d-token system prompt "
          "+ %d-token tails, %d slots, %d new tokens, through TokenServer: "
          "tokens equal with sharing on and off (%d parted at a tie) | hit "
          "rate %.4f | %d / %d dispatches (prefill chunks + steps) | %.3f / "
          "%.3f s, %.1f / %.1f tokens/s (prompt + generated) on / off | %s"
          % (SHARE_USERS, SHARE_SYSTEM, SHARE_TAIL, SHARE_SLOTS, SHARE_NEW,
             share_parted, hit, share[True][3], share[False][3],
             share[True][1], share[False][1], total / share[True][1],
             total / share[False][1], card), flush=True)

    # speculation: bench_decode --spec's shape, greedy then sampled
    base = np.random.RandomState(0).randint(0, vocab, 6)
    spec_prompt = np.tile(base, -(-SPEC_PROMPT // 6))[:SPEC_PROMPT]
    spec = {}
    for tag, sampling, ngram in (
            ("greedy", greedy, SPEC_NGRAM),
            ("sampled", generate.SamplingConfig(
                greedy=False, temperature=0.8, top_k=40), SPEC_NGRAM),
            # near-greedy, so that sampled drafts verify
            ("sampled top_k 2", generate.SamplingConfig(
                greedy=False, temperature=0.5, top_k=2), 1)):
        for k in (SPEC_K, 0):
            e = generate.PagedGenerationEngine(
                lm, slots=SPEC_SLOTS, cache_len=DECODE_CACHE,
                page_size=PAGE, prefill_chunk=PAGED_CHUNK, spec_k=k,
                spec_ngram=ngram, prefix_share=False,
                sampling=sampling, dtype_policy="f32")
            mx.random.seed(SPEC_SEED)
            t0 = time.perf_counter()
            out, steps = gen_paged(e, spec_prompt, SPEC_NEW)
            secs = time.perf_counter() - t0
            spec[tag, k] = (out, steps, secs, e.spec_accepted_per_step(),
                            e.spec_accept_rate(), e._spec_drafted,
                            e._spec_accepted)
            del e
    spec_parted = same_tokens(lm, spec_prompt, spec["greedy", SPEC_K][0],
                              spec["greedy", 0][0], "speculative greedy")
    for tag in ("sampled", "sampled top_k 2"):
        check(spec[tag, SPEC_K][0] == spec[tag, 0][0],
              "%s: speculative tokens differ from plain sampling's" % tag)
        check(all(0 <= t < vocab for t in spec[tag, 0][0]),
              "%s: token out of range" % tag)

    def spec_desc(tag):
        on, off = spec[tag, SPEC_K], spec[tag, 0]
        return ("%s: %d tokens in %d / %d steps, %.3f / %.3f s on / off, "
                "accepted a verify step %s, accept rate %s, %d drafted, %d "
                "accepted" % (tag, SPEC_NEW, on[1], off[1], on[2], off[2],
                              "%.4f" % on[3] if on[3] is not None
                              else "none",
                              "%.4f" % on[4] if on[4] is not None
                              else "none", on[5], on[6]))
    print("paged spec: %d slots, a repetitive %d-token prompt, k %d, ngram "
          "%d | %s, tokens equal to spec off%s | %s and %s (ngram 1), "
          "tokens bit-equal to spec off under seed %d | %s"
          % (SPEC_SLOTS, SPEC_PROMPT, SPEC_K, SPEC_NGRAM, spec_desc("greedy"),
             " (parted at a tie)" if spec_parted else "",
             spec_desc("sampled"), spec_desc("sampled top_k 2"), SPEC_SEED,
             card), flush=True)

    # bf16_mixed: a bf16 pool, logits against the policy's prefill
    e = generate.PagedGenerationEngine(
        lm, slots=DECODE_SLOTS, cache_len=DECODE_CACHE, page_size=PAGE,
        prefill_chunk=PAGED_CHUNK, sampling=greedy,
        dtype_policy="bf16_mixed")
    check(e.cache_dtype == torch.bfloat16 and e._pool_k.dtype ==
          torch.bfloat16, "bf16_mixed pool %s" % e._pool_k.dtype)
    toks16, _, logits16, _, _ = drive_paged(e, prompts, BF16_PAGED_STEPS)
    del e
    policy = mx.dtype_policy.get_policy("bf16_mixed")
    params = list(lm.collect_params().values())
    cast = [policy.cast_compute(p.name, p.data()._data) for p in params]
    seqs = np.stack([np.concatenate([p, toks16[s][:BF16_PAGED_STEPS]])
                     for s, p in enumerate(prompts)])
    with torch.inference_mode(), mx.dtype_policy.scope(policy), \
            mx.gluon.block.swapped_params(params, cast):
        ref_nd, _ = lm.prefill_forward(mx.nd.array(seqs, ctx=mx.gpu(0),
                                                   dtype="int64"))
        ref = policy.cast_output(ref_nd._data).cpu().numpy()
    del cast, ref_nd
    err16 = 0.0
    for j in range(1, BF16_PAGED_STEPS + 1):
        r = ref[:, DECODE_PROMPT - 1 + j]
        d = np.abs(logits16[j - 1] - r)
        err16 = max(err16, float(d.max()))
        check(np.all(d <= BF16_ATOL + BF16_RTOL * np.abs(r)),
              "paged bf16 step %d logits differ from the policy's prefill "
              "by %g" % (j, float(d.max())))
    print("paged bf16_mixed: pool bfloat16, %d steps over %d slots, logits "
          "vs the policy's prefill of the same sequences max|d| %.3g "
          "(limit %g + %g|ref|) | %s"
          % (BF16_PAGED_STEPS, DECODE_SLOTS, err16, BF16_ATOL, BF16_RTOL,
             card), flush=True)

    # TokenServer with every lever on against the ring server (f32)
    ring_eng = generate.GenerationEngine(
        lm, slots=DECODE_SLOTS, cache_len=DECODE_CACHE, sampling=greedy,
        dtype_policy="f32")
    ring_res, ring_s = run_server(ring_eng, prompts, SERVER_NEW)
    del ring_eng
    e = generate.PagedGenerationEngine(
        lm, slots=DECODE_SLOTS, cache_len=DECODE_CACHE, page_size=PAGE,
        prefill_chunk=PAGED_CHUNK, spec_k=SPEC_K, spec_ngram=SPEC_NGRAM,
        prefix_share=True, sampling=greedy, dtype_policy="f32")
    paged_res, paged_s = run_server(e, prompts, SERVER_NEW)
    srv_parted = 0
    for i, (a, b) in enumerate(zip(paged_res, ring_res)):
        check(a.finish_reason == "length" and len(a.tokens) == SERVER_NEW,
              "paged request %d finished %s with %d tokens"
              % (i, a.finish_reason, len(a.tokens)))
        check(b.tokens == ring["toks"][i][:SERVER_NEW],
              "ring request %d: server tokens differ from the engine's" % i)
        srv_parted += same_tokens(lm, prompts[i], a.tokens, b.tokens,
                                  "paged server request %d" % i)
    print("paged server: TokenServer over PagedGenerationEngine(spec_k=%d, "
          "spec_ngram=%d, prefix_share, prefill_chunk %d) f32, %d requests "
          "of max_new_tokens %d: all 'length', tokens equal to the ring "
          "server's (%d parted at a tie) | %.3f s (ring %.3f s), ttft s "
          "median %.4f (ring %.4f), accepted a verify step %s | %s"
          % (SPEC_K, SPEC_NGRAM, PAGED_CHUNK, len(paged_res), SERVER_NEW,
             srv_parted, paged_s, ring_s,
             statistics.median(r.ttft_s for r in paged_res),
             statistics.median(r.ttft_s for r in ring_res),
             e.spec_accepted_per_step(), card), flush=True)
    del e

    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the paged path launched %s"
          % launched)
    print("paged: hand-written kernels launched on the paged path: %s "
          "(none is on it) | phase %.1f s | %s"
          % (launched, time.perf_counter() - t_phase, card), flush=True)


def device_kernels(fn, top=3):
    """fn() under torch.profiler: (kernels launched, their card time in
    ms, the ``top`` kernels by card time as (name cut, ms)), or the
    reason it was not measured.  A measurement only: a profiler failure
    is reported, not raised."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(ev.count, _self_device_us(ev), ev.key[:48])
                for ev in prof.key_averages()
                if getattr(ev, "device_type", None) == DeviceType.CUDA
                and _self_device_us(ev)]
    except Exception as e:  # noqa: BLE001 - the profile is optional
        return "not measured (torch.profiler failed: %r)" % (e,)
    if not rows:
        return "not measured (torch.profiler recorded no device time)"
    ranked = sorted(rows, key=lambda r: -r[1])[:top]
    return (sum(r[0] for r in rows), sum(r[1] for r in rows) / 1e3,
            [(name, us / 1e3) for _, us, name in ranked])


def kernels_text(res, top=False):
    """device_kernels' result as text, with its top kernels if asked."""
    if not isinstance(res, tuple):
        return res
    text = "%d kernels, %.3f ms on the card" % res[:2]
    if top:
        text += "; top: " + ", ".join("%s %.3f ms" % r for r in res[2])
    return text


def zoo_step(net, trainer, x, y, loss_fn):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(ZOO_BATCH)


def on_card(trainer, net):
    """Every parameter, gradient and optimizer state on the card."""
    tensors = [p.data()._data for p in net.collect_params().values()]
    tensors += [p.grad()._data for p in net.collect_params().values()
                if p.grad_req != "null"]
    for st in trainer._updaters[0].states.values():
        tensors += [st._data] if st is not None else []
    return all(t.is_cuda for t in tensors)


def zoo_logits_against_cpu(name, side, net):
    """Predict-mode logits at batch 2 on the card against the port on the
    CPU from the same weights: max |d| / max |ref|."""
    x = np.random.RandomState(1).rand(2, 3, side, side).astype(np.float32)
    with mx.name.NameManager():
        cpu_net = vision.get_model(name, classes=1000)
    cpu_net.initialize(mx.init.Zero(), ctx=mx.cpu())
    with mx.autograd.pause():
        cpu_net(mx.nd.array(x, ctx=mx.cpu()))
    # the card net's prefix counts the networks the process built before
    # it (`_resnet2_` after phases 4 and 7); the names match past it
    mx.convert.load_from_numpy(cpu_net, {
        cpu_net.prefix + n[len(net.prefix):]: p.data().asnumpy()
        for n, p in net.collect_params().items()})
    with mx.autograd.predict_mode():
        ref = cpu_net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
        got = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    err = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
    check(err <= ZOO_LOGIT_REL, "%s logits card vs CPU: %g of max|ref|"
          % (name, err))
    return err


class LoopSGD(mx.optimizer.SGD):
    """SGD itself, but not the class that gluon.Trainer fuses: its
    updates run the per-parameter loop (sgd_mom_update a parameter)."""


def check_fused_against_loop(net, trainer, card):
    """One fused SGD update on the card over the network's real gradients
    against the per-parameter loop from the same weights and momentum:
    within ZOO_FUSED_REL x max|w| per tensor; the kernels each launches."""
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    w0 = [p.data()._data.detach().clone() for p in params]
    states = trainer._updaters[0].states
    m0 = {i: st._data.clone() for i, st in states.items()}
    fused_k = device_kernels(lambda: trainer.step(ZOO_BATCH))
    fused = [p.data()._data.detach().clone() for p in params]
    with torch.no_grad():
        for p, w in zip(params, w0):
            p.data()._data.copy_(w)
    loop = mx.gluon.Trainer(params, LoopSGD(learning_rate=ZOO_LR,
                                            momentum=0.9))
    upd = loop._updaters[0]
    idx = {p.name: i for i, p in enumerate(trainer._params)}
    for j, p in enumerate(params):
        upd.states[j] = mx.nd.NDArray(m0[idx[p.name]].clone())
        upd.states_synced[j] = True
    loop_k = device_kernels(lambda: loop.step(ZOO_BATCH))
    check(loop._fused_updates == 0, "the loop took the fused update")
    worst = 0.0
    for p, f in zip(params, fused):
        w = p.data()._data.detach()
        err = float((w - f).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, err)
    check(worst <= ZOO_FUSED_REL, "fused SGD vs the loop: %g of max|w|"
          % worst)
    print("zoo fused: one fused SGD update over mobilenet1.0's %d "
          "gradients vs the per-parameter loop from the same weights and "
          "momentum: max |d| %.3g of max|w| (bound %g) | fused %s | loop %s "
          "| %s" % (len(params), worst, ZOO_FUSED_REL, kernels_text(fused_k),
                    kernels_text(loop_k), card), flush=True)


ZOO_OPTIMIZERS = (
    ("sgd", {"momentum": 0.9}), ("lbsgd", {"momentum": 0.9}),
    ("signum", {}), ("ftml", {}), ("dcasgd", {"momentum": 0.9}),
    ("adam", {}), ("adagrad", {}), ("rmsprop", {"centered": True}),
    ("adadelta", {}), ("ftrl", {}), ("adamax", {}), ("nadam", {}),
    ("nag", {"momentum": 0.9}), ("test", {}))


def run_optimizer(name, kw, weights, grads, ctx, steps, dtype=np.float32):
    opt = mx.optimizer.create(name, learning_rate=0.01, wd=1e-4,
                              clip_gradient=1.0, rescale_grad=1.0 / ZOO_BATCH,
                              **kw)
    upd = mx.optimizer.get_updater(opt)
    ws = [mx.nd.array(w.astype(dtype), ctx=ctx, dtype=dtype)
          for w in weights]
    gs = [mx.nd.array(g.astype(dtype), ctx=ctx, dtype=dtype) for g in grads]
    for _ in range(steps):
        for i, (w, g) in enumerate(zip(ws, gs)):
            upd(i, g, w)
    return ws, upd


def rel_err(got, want):
    """max over tensors of max|got - want| / max|want|."""
    return max(float(np.abs(g.asnumpy().astype(np.float64)
                            - w.asnumpy().astype(np.float64)).max())
               / max(float(np.abs(w.asnumpy()).max()), 1e-30)
               for g, w in zip(got, want))


def check_optimizers(net, card):
    """The 15 optimizers over mobilenet1.0's parameters and gradients, 3
    steps on the card against the port on the CPU; multi_precision f16
    for SGD and Adam; SGLD on its deterministic part and its noise."""
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    weights = [p.data().asnumpy() for p in params]
    grads = [p.grad().asnumpy() for p in params]
    errs = {}
    for name, kw in ZOO_OPTIMIZERS:
        card_w, _ = run_optimizer(name, kw, weights, grads, mx.gpu(0), 3)
        cpu_w, _ = run_optimizer(name, kw, weights, grads, mx.cpu(), 3)
        errs[name] = rel_err(card_w, cpu_w)
        check(errs[name] <= ZOO_OPT_REL, "%s card vs CPU: %g relative"
              % (name, errs[name]))
    for name, kw in (("sgd", {"momentum": 0.9}), ("adam", {})):
        kw = dict(kw, multi_precision=True)
        card_w, card_u = run_optimizer(name, kw, weights, grads, mx.gpu(0),
                                       3, np.float16)
        cpu_w, cpu_u = run_optimizer(name, kw, weights, grads, mx.cpu(), 3,
                                     np.float16)
        check(card_w[0].dtype == np.float16, "mp weights not f16")
        masters = [card_u.states[i][1] for i in range(len(params))]
        cpu_masters = [cpu_u.states[i][1] for i in range(len(params))]
        errs["mp_" + name] = rel_err(masters, cpu_masters)
        check(errs["mp_" + name] <= ZOO_OPT_REL, "multi_precision %s card "
              "vs CPU: %g relative" % (name, errs["mp_" + name]))
        # the f16 weights are the masters rounded: one f16 step apart at
        # most, 2^-10 of the largest |w|
        f16 = max(float(np.abs(a.asnumpy().astype(np.float32)
                               - b.asnumpy().astype(np.float32)).max())
                  / max(float(np.abs(b.asnumpy()).max()), 1e-30)
                  for a, b in zip(card_w, cpu_w))
        check(f16 <= 2.0 ** -10, "multi_precision %s f16 weights differ "
              "by %g of max|w|" % (name, f16))
    # SGLD, 3 steps: w - lr/2 (clip(g / batch) + wd w) + N(0, lr).  Its
    # noise is drawn again from the same seed on the card (same order:
    # step by step, tensor by tensor) and the steps recomputed in float64
    # from it: the deterministic part within ZOO_OPT_REL, the noise N(0,
    # 0.01) by its mean and spread
    mx.random.seed(5)
    card_w, _ = run_optimizer("sgld", {}, weights, grads, mx.gpu(0), 3)
    mx.random.seed(5)
    dev = mx.gpu(0).torch_device
    gen = mx.random.generator(dev)
    ws = [w.astype(np.float64) for w in weights]
    noise = []
    for _ in range(3):
        for k, (w, g) in enumerate(zip(ws, grads)):
            n = torch.normal(0.0, math.sqrt(0.01), tuple(w.shape),
                             generator=gen, device=dev).cpu().numpy()
            g = np.clip(g.astype(np.float64) / ZOO_BATCH, -1.0, 1.0)
            ws[k] = w - 0.01 / 2 * (g + 1e-4 * w) + n
            noise.append(n.ravel())
    errs["sgld"] = max(float(np.abs(got.asnumpy() - want).max())
                       / float(np.abs(want).max())
                       for got, want in zip(card_w, ws))
    check(errs["sgld"] <= ZOO_OPT_REL, "SGLD's deterministic part: %g "
          "relative" % errs["sgld"])
    noise = np.concatenate(noise)
    mean, std = float(noise.mean()), float(noise.std())
    n = noise.size
    check(abs(mean) <= 4 * 0.1 / np.sqrt(n) and abs(std - 0.1) <= 1e-3,
          "SGLD noise mean %g std %g over %d values (N(0, 0.01) expected)"
          % (mean, std, n))
    print("zoo optimizers: 3 steps over mobilenet1.0's %d tensors (%d "
          "values), card vs CPU (sgld: vs its float64 recomputation from "
          "the redrawn noise) max relative difference %s (bound %g); "
          "SGLD noise mean %.3g std %.5f (0.1 expected) over %d values | %s"
          % (len(params), sum(w.size for w in weights),
             ", ".join("%s %.2g" % kv for kv in errs.items()), ZOO_OPT_REL,
             mean, std, n, card), flush=True)


def check_resume(card):
    """Trainer.save_states -> load_states -> 2 steps equals 4 steps bit
    for bit (resnet18_v2, batch 8, deterministic cuDNN)."""
    import shutil
    import tempfile

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.RandomState(2)
    x = mx.nd.array(rng.rand(8, 3, IMAGE, IMAGE).astype(np.float32),
                    ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, 8).astype(np.float32),
                    ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def run(weights, steps, load=None, save=None):
        with mx.name.NameManager():
            net = vision.resnet18_v2(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        with mx.autograd.pause():
            net(x)
        if weights is not None:
            mx.convert.load_from_numpy(net, weights)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": ZOO_LR, "momentum": 0.9,
                               "wd": 1e-4})
        if load:
            tr.load_states(load)
        for _ in range(steps):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
        if save:
            tr.save_states(save)
        return {n: p.data().asnumpy() for n, p in
                net.collect_params().items()}

    tmp = tempfile.mkdtemp()
    try:
        mx.random.seed(3)
        w0 = run(None, 0)
        straight = run(w0, 4)
        fname = tmp + "/trainer.states"
        half = run(w0, 2, save=fname)
        resumed = run(half, 2, load=fname)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic = prev
    same = all(np.array_equal(resumed[n], straight[n]) for n in straight)
    check(same, "save_states/load_states + 2 steps != 4 steps")
    print("zoo resume: resnet18_v2 batch 8, save_states after 2 steps, "
          "load_states into a new Trainer, 2 more steps: all %d parameters "
          "bit-equal to 4 uninterrupted steps (deterministic cuDNN) | %s"
          % (len(straight), card), flush=True)


def phase_zoo(card):
    """One network per vision family through the port's train_imagenet
    entry at ImageNet width (see the module doc, phase 10)."""
    from mxnet_tpu_torch.examples import train_imagenet

    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    for name, side in ZOO:
        mx.random.seed(0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = train_imagenet.train(
            ["--benchmark", "1", "--network", name, "--batch-size",
             str(ZOO_BATCH), "--num-classes", "1000", "--image-shape",
             "3,%d,%d" % (side, side), "--steps", str(ZOO_STEPS), "--lr",
             str(ZOO_LR)], hybridize=False)
        net, trainer, losses = res["net"], res["trainer"], res["losses"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(np.isfinite(losses).all(), "%s: non-finite loss %s"
              % (name, losses))
        if name not in ZOO_DROPOUT:
            check(losses[-1] < losses[0], "%s: loss did not fall: %s"
                  % (name, losses))
        check(trainer._fused_updates == 1 + ZOO_STEPS,
              "%s: %d of %d steps took the fused SGD update"
              % (name, trainer._fused_updates, 1 + ZOO_STEPS))
        check(on_card(trainer, net), "%s: state off the card" % name)
        rng = np.random.RandomState(0)  # the entry's batch again
        x = mx.nd.array(rng.rand(ZOO_BATCH, 3, side, side)
                        .astype(np.float32), ctx=mx.gpu(0))
        y = mx.nd.array(rng.randint(0, 1000, ZOO_BATCH)
                        .astype(np.float32), ctx=mx.gpu(0))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        step_ms = 1e3 * statistics.median(res["step_s"])
        whole = device_kernels(lambda: zoo_step(net, trainer, x, y, loss_fn))
        upd = device_kernels(lambda: trainer.step(ZOO_BATCH))
        ts_ms = 1e3 * statistics.median(
            timed_s(lambda: trainer.step(ZOO_BATCH))[0] for _ in range(3))
        if isinstance(whole, tuple) and isinstance(upd, tuple):
            prof = ("kernels a step %d (trainer.step %d, %.1f%%), card "
                    "kernel time %.2f ms a step: idle %.1f%% of the step"
                    % (whole[0], upd[0], 100.0 * upd[0] / whole[0], whole[1],
                       100 * max(0.0, 1 - whole[1] / step_ms)))
        else:
            prof = "profile %s / %s" % (whole, upd)
        err = zoo_logits_against_cpu(name, side, net)
        print("zoo: %s 3x%dx%d batch %d f32 (TF32 off), sgd lr %g momentum "
              "0.9, 1 warm-up + %d steps | %.1f img/s | step median %.2f ms "
              "| trainer.step %.2f ms (fused) | %s | peak %.2f GB | loss %s "
              "| logits card vs CPU %.2g of max|ref| | %s"
              % (name, side, side, ZOO_BATCH, ZOO_LR, ZOO_STEPS,
                 res["images_per_sec"], step_ms, ts_ms, prof, peak,
                 ["%.4f" % v for v in losses], err, card), flush=True)
        if name == "mobilenet1.0":
            check_fused_against_loop(net, trainer, card)
            check_optimizers(net, card)
        del net, trainer, res
    torch.cuda.empty_cache()
    check_resume(card)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the zoo path launched %s" % launched)
    print("zoo: hand-written kernels launched on the zoo path: %s (none is "
          "on it) | phase %.1f s | %s"
          % (launched, time.perf_counter() - t_phase, card), flush=True)


# ---------------------------------------------------------------------------
# phase 11: the imperative core and the weight store
# ---------------------------------------------------------------------------


def imp_peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def imp_file_mb(path):
    return os.path.getsize(path) / 2 ** 20


def imp_sha1(path):
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def imp_store(card, root):
    """save_parameters (npz) and nd.save(binary) of a Xavier resnet50_v1;
    get_model(pretrained=True) from each local root and through a file://
    mirror into an empty root; predict-mode logits bit-equal to the
    source's.  Returns the net loaded through the mirror and a batch."""
    gpu = mx.gpu(0)
    mx.random.seed(0)
    with mx.name.NameManager():
        src = vision.get_model(IMP_NET, classes=IMP_CLASSES)
    src.initialize(mx.init.Xavier(), ctx=gpu)
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(IMP_PRED_BATCH, 3, IMP_SIDE, IMP_SIDE)
                    .astype(np.float32), ctx=gpu)
    with mx.autograd.predict_mode():
        ref = src(x)._data.clone()
    dirs = {k: os.path.join(root, k) for k in ("npz", "bin", "mirror",
                                               "empty")}
    for d in dirs.values():
        os.makedirs(d)
    fname = IMP_NET + ".params"
    npz_s, _ = timed_s(lambda: src.save_parameters(
        os.path.join(dirs["npz"], fname)))
    bin_s, _ = timed_s(lambda: mx.nd.save(
        os.path.join(dirs["bin"], fname),
        {k: p._reduce() for k, p in src._collect_params_with_prefix()
         .items()}, format="binary"))
    shutil.copy(os.path.join(dirs["bin"], fname),
                os.path.join(dirs["mirror"], fname))
    digest = {k: imp_sha1(os.path.join(dirs[k], fname))
              for k in ("npz", "bin", "mirror")}
    sizes = {k: imp_file_mb(os.path.join(dirs[k], fname))
             for k in ("npz", "bin")}
    check(digest["npz"] != digest["bin"], "the npz and binary files are "
          "the same bytes")
    # the local legs run with no mirror and no registered SHA-1, so each
    # reads the file in its root or raises; the mirror leg registers the
    # binary file's SHA-1 and fetches it into an empty root
    legs = (("npz", "npz", None), ("binary", "bin", None),
            ("mirror", "empty", digest["mirror"]))
    loads = {}
    prev_repo = os.environ.pop("MXNET_GLUON_REPO", None)
    try:
        for label, key, sha1 in legs:
            if sha1 is not None:
                model_store._model_sha1[IMP_NET] = sha1
                os.environ["MXNET_GLUON_REPO"] = "file://" + dirs["mirror"]

            def load(key=key):
                with mx.name.NameManager():
                    return vision.get_model(IMP_NET, classes=IMP_CLASSES,
                                            pretrained=True,
                                            root=dirs[key], ctx=gpu)
            try:
                load_s, net = timed_s(load)
            finally:
                model_store._model_sha1.pop(IMP_NET, None)
                os.environ.pop("MXNET_GLUON_REPO", None)
            want = digest["mirror"] if key == "empty" else digest[key]
            check(gutils.check_sha1(os.path.join(dirs[key], fname), want),
                  "%s: the %s leg's file is not the one written for it"
                  % (IMP_NET, label))
            with mx.autograd.predict_mode():
                same = torch.equal(net(x)._data, ref)
            check(same, "%s: logits of the %s load differ from the source's"
                  % (IMP_NET, label))
            loads[label] = load_s
    finally:
        if prev_repo is not None:
            os.environ["MXNET_GLUON_REPO"] = prev_repo
    print("imperative store: %s full width (classes %d, Xavier seed 0) | "
          "npz %.1f MB saved in %.1f ms | binary %.1f MB saved in %.1f ms | "
          "get_model(pretrained=True) from npz %.1f ms, binary %.1f ms, "
          "file:// mirror (download + sha1 + load) %.1f ms; each leg's file "
          "unchanged after its load | predict logits at batch %d bit-equal "
          "to the source's for all three | %s"
          % (IMP_NET, IMP_CLASSES, sizes["npz"], 1e3 * npz_s, sizes["bin"],
             1e3 * bin_s, 1e3 * loads["npz"], 1e3 * loads["binary"],
             1e3 * loads["mirror"], IMP_PRED_BATCH, card), flush=True)
    del src
    return net, x


def imp_augment(raw):
    """A crop at a random offset (mx.random.uniform) through nd.slice and
    a random horizontal flip (nd.flip), on the card."""
    off = mx.random.uniform(0, IMP_PAD, shape=(2,), ctx=mx.gpu(0))
    oy, ox = (int(v) for v in off.asnumpy())
    crop = mx.nd.slice(raw, begin=(None, None, oy, ox),
                       end=(None, None, oy + IMP_SIDE, ox + IMP_SIDE))
    coin = mx.random.uniform(shape=(1,), ctx=mx.gpu(0))
    return mx.nd.flip(crop, axis=3) if coin.asscalar() > 0.5 else crop


def imp_finetune(card, net):
    """Graft a 100-class head, lr_mult 0.1 on the backbone, reset_ctx,
    then 1 warm-up + 5 timed sgd steps (momentum 0.9) at batch 64 on
    augmented batches."""
    gpu = mx.gpu(0)
    with net.name_scope():
        net.output = mx.gluon.nn.Dense(IMP_FT_CLASSES)
    net.output.initialize(mx.init.Xavier(), ctx=gpu)
    net.features.collect_params().setattr("lr_mult", IMP_BACKBONE_MULT)
    net.collect_params().reset_ctx(mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": IMP_FT_LR, "momentum": 0.9})
    rng = np.random.RandomState(1)
    raw = mx.nd.array(rng.rand(IMP_FT_BATCH, 3, IMP_SIDE + IMP_PAD,
                               IMP_SIDE + IMP_PAD).astype(np.float32),
                      ctx=gpu)
    y = mx.nd.array(rng.randint(0, IMP_FT_CLASSES, IMP_FT_BATCH)
                    .astype(np.float32), ctx=gpu)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    head = net.output.weight
    back = next(iter(net.features.collect_params().values()))  # stem conv
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []

    def step():
        x = imp_augment(raw)
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(IMP_FT_BATCH)
        return loss.mean().asscalar()

    with mx.autograd.predict_mode():
        net(imp_augment(raw))       # the head's deferred initialization
    w_start = {p: p.data()._data.detach().clone() for p in (head, back)}
    for i in range(1 + IMP_FT_STEPS):
        if i == 1:
            # the warm-up step started from zero momentum: its update is
            # -lr * lr_mult * grad / batch, so the step per unit gradient
            # is each parameter's learning rate as the Trainer applied it
            applied = {p: float(-((p.data()._data.detach() - w_start[p])
                                  * p.grad()._data).sum()
                                / (p.grad()._data ** 2).sum()
                                * IMP_FT_BATCH) for p in (head, back)}
            w0 = {p: p.data()._data.detach().clone() for p in (head, back)}
        s, loss = timed_s(step)
        losses.append(loss)
        if i:
            step_s.append(s)
    moved = {p: float(torch.linalg.norm(p.data()._data.detach() - w0[p])
                      / torch.linalg.norm(w0[p])) for p in (head, back)}
    check(np.isfinite(losses).all(), "fine-tune: non-finite loss %s"
          % losses)
    ratio = applied[head] / applied[back]
    check(abs(applied[head] / IMP_FT_LR - 1) < 1e-3
          and abs(ratio * IMP_BACKBONE_MULT - 1) < 1e-3,
          "fine-tune: applied learning rates head %g, backbone %g"
          % (applied[head], applied[back]))
    check(on_card(trainer, net), "fine-tune: state off the card")
    print("imperative finetune: %s + Dense(%d) head, backbone lr_mult %g, "
          "reset_ctx(gpu(0)), sgd lr %g momentum 0.9, batch %d of 3x%dx%d "
          "crops (mx.random.uniform offsets, nd.slice, nd.flip on the card), "
          "1 warm-up + %d steps | %.1f img/s | step median %.2f ms | loss %s "
          "| the warm-up step's update per unit gradient: head %.6g, stem "
          "conv %.6g (%.4fx) | relative step over the %d steps: head %.3g, "
          "stem conv %.3g | state on the card | peak %.2f GB | %s"
          % (IMP_NET, IMP_FT_CLASSES, IMP_BACKBONE_MULT, IMP_FT_LR,
             IMP_FT_BATCH, IMP_SIDE, IMP_SIDE, IMP_FT_STEPS,
             IMP_FT_BATCH * IMP_FT_STEPS / sum(step_s),
             1e3 * statistics.median(step_s),
             ["%.4f" % v for v in losses], applied[head], applied[back],
             ratio, IMP_FT_STEPS, moved[head], moved[back], imp_peak_gb(),
             card), flush=True)
    return trainer, raw, y, loss_fn


def imp_hand_update(card, net, raw, y, loss_fn):
    """One more step by hand, w -= lr * lr_mult * grad in place, against a
    momentum-free sgd Trainer step on the same gradients."""
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    x = imp_augment(raw)
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    w0 = [p.data()._data.detach().clone() for p in params]
    g0 = [p.grad()._data.detach().clone() for p in params]
    ptrs = [p.data()._data.data_ptr() for p in params]
    for p in params:
        w = p.data()
        w -= IMP_FT_LR * p.lr_mult * p.grad()
        p.zero_grad()
    hand = [p.data()._data.detach().clone() for p in params]
    check(all(p.data()._data.data_ptr() == q for p, q in zip(params, ptrs)),
          "hand update: a parameter got a new buffer")
    changed = sum(not torch.equal(h, w) for h, w in zip(hand, w0))
    check(changed and not torch.equal(hand[params.index(net.output.weight)],
                                      w0[params.index(net.output.weight)]),
          "hand update: the parameters did not change")
    check(not any(bool(p.grad()._data.any()) for p in params),
          "hand update: zero_grad left a gradient")
    sgd = mx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": IMP_FT_LR, "wd": 0.0})
    with torch.no_grad():
        for p, w, g in zip(params, w0, g0):
            p.data()._data.copy_(w)
            p.grad()._data.copy_(g)
    sgd.step(1)
    with torch.no_grad():
        worst = max(float((p.data()._data - h).abs().max()
                          / w.abs().max().clamp_min(1e-30))
                    for p, h, w in zip(params, hand, w0))
    check(worst <= IMP_UPDATE_REL, "hand update vs sgd Trainer: %g of "
          "max|w|" % worst)
    print("imperative update: w -= lr * lr_mult * grad by hand over %d "
          "parameters, in place (no new buffer; %d changed), zero_grad after "
          "| against a momentum-free sgd Trainer step on the same gradients: "
          "%.3g of max|w| (bound %g) | %s"
          % (len(params), changed, worst, IMP_UPDATE_REL, card), flush=True)


def imp_double_backward(net, x, y, loss_fn):
    """Parameter gradients of |d loss / d x|^2 (autograd.grad with
    create_graph, then backward)."""
    x = mx.nd.array(x, ctx=x.context)
    x.attach_grad()
    with mx.autograd.record():
        loss = loss_fn(net(x), y).mean()
        (gx,) = mx.autograd.grad(loss, [x], create_graph=True)
        penalty = (gx * gx).sum()
    penalty.backward()
    return {n: p.grad() for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def imp_small_resnet(ctx):
    with mx.name.NameManager():
        net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                              [16, 32, 64, 128, 256], classes=10)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def imp_second_order(card, net, raw, loss_fn):
    gpu = mx.gpu(0)
    rng = np.random.RandomState(2)
    x = mx.nd.array(raw.asnumpy()[:IMP_SO_BATCH, :, :IMP_SIDE, :IMP_SIDE],
                    ctx=gpu)
    y = mx.nd.array(rng.randint(0, IMP_FT_CLASSES, IMP_SO_BATCH)
                    .astype(np.float32), ctx=gpu)
    torch.cuda.reset_peak_memory_stats()
    so_s, grads = timed_s(lambda: imp_double_backward(net, x, y, loss_fn))
    finite = all(bool(torch.isfinite(g._data).all()) for g in grads.values())
    check(finite, "second order: non-finite parameter gradient")
    check(any(bool(g._data.any()) for g in grads.values()),
          "second order: every parameter gradient is zero")
    peak = imp_peak_gb()
    # the same double backward on a small ResNet, card against CPU
    xs = np.random.RandomState(3).randn(4, 3, 64, 64).astype(np.float32)
    ys = np.array([0, 3, 1, 9], np.float32)
    small = {c: imp_small_resnet(c) for c in (mx.cpu(), gpu)}
    small[mx.cpu()](mx.nd.array(xs, ctx=mx.cpu()))
    small[gpu](mx.nd.array(xs, ctx=gpu))
    mx.convert.load_from_numpy(small[gpu], {
        n: p.data().asnumpy() for n, p in small[mx.cpu()].collect_params()
        .items()})
    got, want = (
        {n: g.asnumpy() for n, g in imp_double_backward(
            small[c], mx.nd.array(xs, ctx=c), mx.nd.array(ys, ctx=c),
            loss_fn).items()} for c in (gpu, mx.cpu()))
    scale = max(float(np.abs(w).max()) for w in want.values())
    err = max(float(np.abs(got[n] - want[n]).max()) for n in want) / scale
    check(err <= IMP_SO_REL, "small ResNet double backward card vs CPU: "
          "%g of max|ref|" % err)
    print("imperative second order: autograd.grad(loss, [x], "
          "create_graph=True) then backward of |dx|^2 through %s "
          "(training-mode BatchNorm) at batch %d | %.1f ms | every parameter "
          "gradient finite | peak %.2f GB | small ResNet card vs CPU %.3g of "
          "max|ref| (bound %g) | %s"
          % (IMP_NET, IMP_SO_BATCH, 1e3 * so_s, peak, err, IMP_SO_REL, card),
          flush=True)


def imp_cast(card, net, raw):
    gpu = mx.gpu(0)
    x = mx.nd.array(raw.asnumpy()[:IMP_SO_BATCH, :, :IMP_SIDE, :IMP_SIDE],
                    ctx=gpu)
    with mx.autograd.predict_mode():
        ref = net(x).asnumpy()
    net.cast("float16")
    for n, p in net.collect_params().items():
        want = np.float32 if "batchnorm" in n else np.float16
        check(p.data().dtype == want, "cast: %s is %s" % (n, p.data().dtype))
    with mx.autograd.predict_mode():
        got = net(x.astype("float16")).asnumpy()
    check(got.dtype == np.float16, "cast: logits are %s" % got.dtype)
    err = np.abs(got.astype(np.float32) - ref)
    worst = float((err / (IMP_F16_TOL + IMP_F16_TOL * np.abs(ref))).max())
    check(worst <= 1.0, "cast: f16 logits off by %g of the bound" % worst)
    print("imperative cast: net.cast('float16'), BatchNorm parameters kept "
          "f32 | f16 logits vs f32 at batch %d: max |d| %.4g, %.3f of the "
          "bound %g + %g|ref| | %s"
          % (IMP_SO_BATCH, float(err.max()), worst, IMP_F16_TOL,
             IMP_F16_TOL, card), flush=True)


# the deterministic registry ops of this slice, one case each on the card
# against the port on the CPU; shapes large enough for real launches
def imp_op_cases():
    r = np.random.RandomState(0)

    def a(*s):
        return r.randn(*s).astype(np.float32)

    def pos(*s):
        return (r.rand(*s) * 0.8 + 0.3).astype(np.float32)

    def spd(n, *batch):
        m = a(*batch, n, n)
        return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n)).astype(
            np.float32)

    def separated(n, *batch):
        """Symmetric, eigenvalues 1..n: eigenvectors stable to ~n eps."""
        q = np.linalg.qr(a(*batch, n, n))[0]
        return ((q * np.arange(1, n + 1)) @ np.swapaxes(q, -1, -2))\
            .astype(np.float32)

    def lower(n):
        m = np.tril(a(n, n)) * (0.3 / math.sqrt(n))
        return (m + np.diag(np.where(np.diag(m) >= 0, 2.0, -2.0))).astype(
            np.float32)

    x = a(48, 64)
    distinct = (r.permutation(48 * 64).astype(np.float32) / 3072 - 0.5)\
        .reshape(48, 64)
    nan = a(48, 64)
    nan[::3, ::5] = np.nan
    idx = r.randint(0, 64, 48).astype(np.float32)
    cases = [
        ("cbrt", [np.sign(x) * (np.abs(x) + 0.2)], {}),
        ("rcbrt", [np.sign(x) * (np.abs(x) + 0.2)], {}),
        ("nansum", [nan], {"axis": 1}), ("nanprod", [nan], {"axis": 0}),
        ("hard_sigmoid", [x * 4], {}),
        ("moveaxis", [a(8, 16, 32)], {"source": 0, "destination": 2}),
        ("slice", [x], {"begin": (4, 60), "end": (40, None),
                        "step": (2, -3)}),
        ("crop", [x], {"begin": (1, 2), "end": (30, 50)}),
        ("slice_like", [x, a(20, 30)], {}),
        ("SliceChannel", [x], {"num_outputs": 4}),
        ("split", [x], {"num_outputs": 3, "axis": 0}),
        ("tile", [x], {"reps": (2, 3)}),
        ("repeat", [x], {"repeats": 3, "axis": 1}),
        ("reverse", [x], {"axis": 1}), ("flip", [a(4, 8, 16)],
                                        {"axis": (0, 2)}),
        ("depth_to_space", [a(4, 16, 8, 8)], {"block_size": 2}),
        ("space_to_depth", [a(4, 4, 16, 16)], {"block_size": 4}),
        ("diag", [x], {"k": 3}), ("shape_array", [x], {}),
        ("size_array", [x], {}), ("batch_take", [x, idx], {}),
        ("one_hot", [idx], {"depth": 64, "on_value": 2.0}),
        ("gather_nd", [x, np.stack([idx % 48, idx])], {}),
        ("scatter_nd", [a(48), np.stack([np.arange(48), idx])
                        .astype(np.float32)], {"shape": (48, 64)}),
        ("_linspace", [], {"start": -3.0, "stop": 5.0, "num": 1000}),
        ("_eye", [], {"N": 300, "M": 200, "k": 5}),
        ("sort", [distinct], {"axis": 1, "is_ascend": False}),
        ("argsort", [distinct], {"axis": 0}),
        ("topk", [distinct], {"k": 5, "ret_typ": "both"}),
        ("smooth_l1", [x * 3], {"scalar": 2.0}),
        ("softmin", [x], {"axis": 1}),
        ("khatri_rao", [a(16, 32), a(24, 32)], {}),
        ("_scatter_elemwise_div", [x, pos(48, 64)], {}),
        ("_scatter_plus_scalar", [x], {"scalar": 1.5}),
        ("_scatter_minus_scalar", [x], {"scalar": 1.5}),
    ]
    for p in ("_", ""):
        cases += [
            (p + "linalg_gemm", [a(8, 64, 32), a(8, 32, 48), a(8, 64, 48)],
             {"alpha": 1.5, "beta": 0.5}),
            (p + "linalg_gemm2", [a(8, 32, 64), a(8, 32, 48)],
             {"transpose_a": True}),
            (p + "linalg_potrf", [spd(64, 4)], {}),
            (p + "linalg_potri", [np.linalg.cholesky(spd(64))
                                  .astype(np.float32)], {}),
            (p + "linalg_trmm", [lower(64), a(64, 32)], {"alpha": 2.0}),
            (p + "linalg_trsm", [lower(64), a(32, 64)],
             {"rightside": True, "transpose": True}),
            (p + "linalg_syrk", [a(8, 32, 64)], {"transpose": True}),
            (p + "linalg_sumlogdiag", [spd(32, 4)], {}),
            (p + "linalg_extractdiag", [a(8, 32, 32)], {"offset": 2}),
            (p + "linalg_gelqf", [a(4, 32, 64)], {}),
            (p + "linalg_syevd", [separated(32, 4)], {}),
        ]
    s = x + 1.5
    ints = r.randint(0, 4, (48, 64)).astype(np.float32)
    by_canonical = {
        "elemwise": [x, a(48, 64)], "broadcast": [x, pos(1, 64)],
        "cmp": [ints, r.randint(0, 3, (1, 64)).astype(np.float32)],
        "power": [pos(48, 64), a(1, 64)], "scalar": [np.abs(s)],
        "BatchNorm": [a(8, 16, 12, 12), pos(16), a(16), a(16), pos(16)],
        "Convolution": [a(8, 16, 12, 12), a(32, 16, 3, 3), a(32)],
        "Pooling": [a(8, 16, 12, 12)],
        "Embedding": [idx.reshape(6, 8), a(64, 32)], "pick": [x, idx[:48]],
        "Concat": [x, a(16, 64)]}
    attrs = {"BatchNorm": {"fix_gamma": False},
             "Convolution": {"kernel": (3, 3), "num_filter": 32,
                             "pad": (1, 1)},
             "Pooling": {"kernel": (2, 2), "stride": (2, 2)},
             "Embedding": {"input_dim": 64, "output_dim": 32},
             "Concat": {"dim": 0}}
    for name in imp_new_aliases():
        canonical = registry.get_op(name).name
        if canonical.endswith("_scalar"):
            kind = "cmp" if any(c in canonical for c in (
                "equal", "greater", "lesser", "logical")) else "scalar"
            inputs = [ints] if kind == "cmp" else by_canonical["scalar"]
            cases.append((name, inputs, {"scalar": 2.0}))
            continue
        if canonical.startswith("elemwise_"):
            key = "elemwise"
        elif canonical == "broadcast_power":
            key = "power"
        elif canonical.startswith("broadcast_logical") or any(
                canonical == "broadcast_" + c for c in (
                    "equal", "not_equal", "greater", "greater_equal",
                    "lesser", "lesser_equal")):
            key = "cmp"
        elif canonical.startswith("broadcast_"):
            key = "broadcast"
        else:
            key = canonical
        cases.append((name, by_canonical[key], attrs.get(key, {})))
    return cases + imp_ext_cases()


# the aliases the port had before this slice (held by earlier phases), and
# the ops new in this slice whose other names come with them
IMP_EARLIER_ALIASES = (
    "SwapAxis", "_adamw_update", "_add", "_contrib_CTCLoss",
    "_contrib_adamw_update", "_contrib_ctc_loss", "_div", "_mul", "_sub",
    "broadcast_axes", "cast", "concat", "ctc_loss", "flatten", "max_axis",
    "min_axis", "pad", "reshape", "stop_gradient", "sum_axis")


# aliases that later slices registered: SoftmaxOutput's Softmax (its own
# checks are in tests/test_torch_output_ops.py) and the detection and
# int8 ops' other names (tests/test_torch_ssd_ops.py, test_torch_contrib_
# ops.py, test_torch_quantization.py; phase 16)
IMP_LATER_ALIASES = (
    "Softmax", "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
    "PSROIPooling", "Proposal", "_contrib_MultiProposal",
    "_contrib_box_non_maximum_suppression", "_contrib_nms",
    "_contrib_quadratic", "_quantized_concat", "ElementWiseSum",
    "boolean_mask", "ravel_multi_index", "unravel_index", "_crop_assign",
    "_crop_assign_scalar")


def imp_ext_cases():
    """Every deterministic name of ops/extended.py's other 56 at the JAX
    suite's shapes (tests/test_extended_ops.py, test_op_parity2.py)."""
    r = np.random.RandomState(1)

    def a(*s):
        return np.asarray(r.randn(*s), np.float32)

    def pos(*s):
        return (r.rand(*s) + 0.5).astype(np.float32)

    def img(*s):
        return r.randint(0, 256, s).astype(np.uint8)

    def multi(per, mp):
        out = []
        for shape in ((4,), (3, 2)):
            w32 = a(*shape)
            out += [w32.astype(np.float16) if mp else w32,
                    a(*shape).astype(np.float16 if mp else np.float32)]
            out += [0.1 * a(*shape)] if per == 3 else []
            out += [w32.copy()] if mp else []
        return out

    theta = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1)) \
        + 0.1 * a(2, 6)
    lr2 = {"num_weights": 2, "lrs": (0.1, 0.2), "wds": (0.01, 0.0),
           "rescale_grad": 0.5, "clip_gradient": 0.3}
    corr = {"kernel_size": 3, "max_displacement": 2, "stride1": 2,
            "stride2": 1, "pad_size": 2, "is_multiply": True}
    return [
        ("add_n", [a(2, 3), a(2, 3), a(2, 3)], {}),
        ("ElementWiseSum", [a(2, 3), a(2, 3)], {}),
        ("round", [a(3, 4) * 3], {}),
        ("reshape_like", [a(2, 3), a(3, 2)], {}),
        ("_identity_with_attr_like_rhs", [a(2, 3), a(3, 2)], {}),
        ("_zeros_without_dtype", [], {"shape": (2, 3)}),
        ("_histogram", [a(50)], {"bin_cnt": 5}),
        ("_ravel_multi_index", [np.array([[0, 1, 2], [2, 0, 3]],
                                         np.float32)], {"shape": (3, 4)}),
        ("ravel_multi_index", [np.array([[1, 0], [2, 3], [0, 4]],
                                        np.float32)], {"shape": (2, 4, 5)}),
        ("_unravel_index", [np.array([2, 4, 11], np.float32)],
         {"shape": (3, 4)}),
        ("unravel_index", [np.array([0, 17, 39], np.float32)],
         {"shape": (2, 4, 5)}),
        ("_square_sum", [a(3, 4)], {"axis": 1, "keepdims": True}),
        ("_split_v2", [a(3, 4)], {"indices": (1, 2), "axis": 0}),
        ("_slice_assign", [a(4, 5), a(2, 2)], {"begin": (0, 1),
                                               "end": (2, 3)}),
        ("_crop_assign", [a(4, 5), a(2, 3)],
         {"begin": (3, 4), "end": (0, 1), "step": (-2, -1)}),
        ("_slice_assign_scalar", [a(3, 4)],
         {"scalar": -1.0, "begin": (0, 0), "end": (2, 2)}),
        ("_crop_assign_scalar", [a(4, 5)],
         {"scalar": 2.5, "begin": (1, 0), "end": (4, 5), "step": (2, 2)}),
        ("cast_storage", [a(2, 3)], {"stype": "default"}),
        ("_contrib_gradientmultiplier", [a(2, 3)], {"scalar": -2.0}),
        ("IdentityAttachKLSparseReg", [a(2, 3)], {}),
        ("BilinearSampler", [a(2, 3, 5, 6), (r.rand(2, 2, 4, 3) * 2.2
                                             - 1.1).astype(np.float32)],
         {}),
        ("GridGenerator", [theta], {"transform_type": "affine",
                                    "target_shape": (3, 4)}),
        ("SpatialTransformer", [a(2, 3, 5, 5), theta],
         {"target_shape": (4, 4), "transform_type": "affine",
          "sampler_type": "bilinear"}),
        ("Crop", [a(1, 2, 7, 6)], {"h_w": (3, 4), "center_crop": True}),
        ("_contrib_AdaptiveAvgPooling2D", [a(1, 2, 7, 5)],
         {"output_size": (3, 2)}),
        ("_contrib_fft", [a(2, 8)], {}),
        ("_contrib_ifft", [a(2, 16)], {}),
        ("_contrib_boolean_mask", [a(4, 3), np.array([1, 0, 1, 0],
                                                      np.float32)], {}),
        ("boolean_mask", [a(2, 3), np.array([0, 1, 1], np.float32)],
         {"axis": 1}),
        ("_contrib_bipartite_matching", [r.rand(2, 4, 3).astype(
            np.float32)], {"threshold": 0.3}),
        ("_image_to_tensor", [img(2, 6, 8, 3)], {}),
        ("_image_normalize", [r.rand(3, 6, 8).astype(np.float32)],
         {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.3, 0.4)}),
        ("_image_resize", [img(6, 8, 3)], {"size": (4, 3)}),
        ("_image_crop", [img(6, 8, 3)], {"x": 1, "y": 2, "width": 4,
                                         "height": 3}),
        ("multi_sgd_update", multi(2, False), lr2),
        ("multi_sgd_mom_update", multi(3, False), dict(lr2, momentum=0.9)),
        ("multi_mp_sgd_update", multi(2, True), lr2),
        ("multi_mp_sgd_mom_update", multi(3, True), dict(lr2,
                                                          momentum=0.9)),
        ("_mp_adamw_update", [a(3).astype(np.float16),
                              (0.1 * a(3)).astype(np.float16), 0.01 * a(3),
                              0.01 * pos(3), a(3)],
         {"lr": 0.1, "wd": 0.01, "eta": 0.5, "clip_gradient": 0.05,
          "rescale_grad": 2.0}),
        ("_contrib_group_adagrad_update", [a(4, 3), a(4, 3), pos(4, 1)],
         {"lr": 0.1, "rescale_grad": 0.5, "clip_gradient": 0.4}),
        ("_scatter_set_nd", [np.zeros((3, 4), np.float32),
                             np.array([[0, 2], [1, 3]], np.float32),
                             np.array([5.0, 7.0], np.float32)],
         {"shape": (3, 4)}),
        ("Correlation", [r.rand(2, 3, 7, 7).astype(np.float32),
                         r.rand(2, 3, 7, 7).astype(np.float32)], corr),
        ("_sparse_retain", [a(5, 3), np.array([0, 3], np.float32)], {}),
        ("_sparse_adagrad_update", [a(4, 3), a(4, 3), pos(4, 3)],
         {"lr": 0.1, "wd": 0.01, "epsilon": 1e-7, "clip_gradient": 0.5}),
    ]


def imp_new_aliases():
    """The 68 names this slice gave to ops the port had."""
    out = []
    for name in registry.list_ops():
        info = registry.get_op(name)
        if info.name == name or name in IMP_EARLIER_ALIASES \
                or name in IMP_LATER_ALIASES:
            continue
        new_op = info.name.lstrip("_").startswith("linalg") \
            or info.name in ("slice", "SliceChannel", "reverse") \
            or info.fn.__module__.endswith("random_ops")
        if not new_op:
            out.append(name)
    return out


def imp_run_op(name, inputs, attrs, ctx):
    kw = dict(attrs)
    if not inputs:
        kw["ctx"] = ctx
    out = getattr(mx.nd, name)(*[mx.nd.array(v, ctx=ctx, dtype=v.dtype)
                                  for v in inputs], **kw)
    return [o.asnumpy() for o in (out if isinstance(out, list) else [out])]


def imp_rel(got, want):
    scale = max(float(np.nanmax(np.abs(want))), 1e-30) if want.size else 1.0
    same_nan = np.array_equal(np.isnan(got), np.isnan(want))
    if not same_nan:
        return np.inf
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(np.nanmax(d)) / scale if d.size else 0.0


def imp_ops(card):
    gpu = mx.gpu(0)
    cases = imp_op_cases()
    names = {c[0] for c in cases}
    worst = {}
    for name, inputs, attrs in cases:
        got = imp_run_op(name, inputs, attrs, gpu)
        want = imp_run_op(name, inputs, attrs, mx.cpu())
        base = name.lstrip("_")
        if base in ("linalg_gelqf", "linalg_syevd"):
            a = inputs[0]
            if base == "linalg_gelqf":
                (q, low), (q_ref, _) = got, want
                recon = low @ q
            else:
                (q, lam), (q_ref, lam_ref) = got, want
                recon = np.swapaxes(q, -1, -2) @ (lam[..., :, None] * q)
                check(imp_rel(lam, lam_ref) <= IMP_OP_REL,
                      "%s eigenvalues card vs CPU" % name)
            sign = np.sign(np.sum(q * q_ref, -1, keepdims=True))
            err = max(imp_rel(recon, a), imp_rel(q * sign, q_ref))
        else:
            check(all(g.dtype == w.dtype and g.shape == w.shape
                      for g, w in zip(got, want)),
                  "%s: card %s vs CPU %s" % (
                      name, [(g.dtype, g.shape) for g in got],
                      [(w.dtype, w.shape) for w in want]))
            err = max(imp_rel(g, w) for g, w in zip(got, want))
        bound = IMP_LINALG_REL.get(base, IMP_OP_REL)
        check(err <= bound, "%s card vs CPU: %g relative (bound %g)"
              % (name, err, bound))
        worst[name] = err
    aliases = imp_new_aliases()
    check(len(aliases) == 68, "%d new aliases, not 68" % len(aliases))
    ext = {c[0] for c in imp_ext_cases()}
    check(len(ext) == 44, "%d names of ops/extended.py, not 44" % len(ext))
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    print("imperative ops: %d deterministic op names (68 aliases, 35 "
          "tensor ops, 22 linalg names, and %d of ops/extended.py's other "
          "56, its 12 samplers checked below) on the card vs the port on "
          "the CPU | all within %g relative (linalg potrf/potri/trsm %g; "
          "gelqf and syevd by reconstruction and up to each row's sign) | "
          "worst %s | registry %d names | %s"
          % (len(names), len(ext), IMP_OP_REL,
             IMP_LINALG_REL["linalg_potrf"],
             ", ".join("%s %.2g" % kv for kv in top),
             len(registry.list_ops()), card), flush=True)


def imp_samplers():
    gpu = mx.gpu(0)
    n = (IMP_DRAWS,)
    return [
        ("uniform", lambda: mx.random.uniform(-1.0, 3.0, shape=n, ctx=gpu),
         1.0, 16.0 / 12),
        ("normal", lambda: mx.random.normal(0.5, 2.0, shape=n, ctx=gpu),
         0.5, 4.0),
        ("randint", lambda: mx.random.randint(-3, 7, shape=n, ctx=gpu),
         1.5, 99 / 12.0),
        ("randn", lambda: mx.random.randn(*n, loc=1.0, scale=0.5, ctx=gpu),
         1.0, 0.25),
        ("exponential", lambda: mx.random.exponential(2.0, shape=n,
                                                      ctx=gpu), 0.5, 0.25),
        ("gamma", lambda: mx.random.gamma(2.5, 1.5, shape=n, ctx=gpu),
         3.75, 5.625),
        ("poisson", lambda: mx.random.poisson(3.5, shape=n, ctx=gpu),
         3.5, 3.5),
        ("negative_binomial", lambda: mx.random.negative_binomial(
            3, 0.4, shape=n, ctx=gpu), 4.5, 11.25),
        ("generalized_negative_binomial",
         lambda: mx.random.generalized_negative_binomial(
             2.0, 0.5, shape=n, ctx=gpu), 2.0, 4.0),
        ("shuffle", lambda: mx.random.shuffle(mx.nd.arange(
            IMP_DRAWS, ctx=gpu)), (IMP_DRAWS - 1) / 2.0,
         (IMP_DRAWS ** 2 - 1) / 12.0),
        ("multinomial", lambda: mx.random.multinomial(
            mx.nd.array([0.1, 0.2, 0.3, 0.4], ctx=gpu), shape=n),
         2.0, 1.0),
    ]


def imp_ext_samplers():
    """ops/extended.py's per-row and *_like samplers on the card: one row
    of IMP_EXT_DRAWS draws each, with the expected shape and dtype."""
    gpu = mx.gpu(0)
    n = IMP_EXT_DRAWS

    def one(v):
        return mx.nd.array(np.array([v], np.float32), ctx=gpu)

    like = mx.nd.zeros((n,), ctx=gpu)
    nd = mx.nd
    return [
        ("_sample_exponential", lambda: nd._sample_exponential(
            one(2.0), shape=(n,)), 0.5, 0.25, (1, n)),
        ("_sample_gamma", lambda: nd._sample_gamma(
            one(2.5), one(1.5), shape=(n,)), 3.75, 5.625, (1, n)),
        ("_sample_poisson", lambda: nd._sample_poisson(
            one(3.5), shape=(n,)), 3.5, 3.5, (1, n)),
        ("_sample_negative_binomial", lambda: nd._sample_negative_binomial(
            one(3.0), one(0.4), shape=(n,)), 4.5, 11.25, (1, n)),
        ("_sample_generalized_negative_binomial",
         lambda: nd._sample_generalized_negative_binomial(
             one(2.0), one(0.5), shape=(n,)), 2.0, 4.0, (1, n)),
        ("_random_uniform_like", lambda: nd._random_uniform_like(
            like, low=-1.0, high=3.0), 1.0, 16.0 / 12, (n,)),
        ("_random_normal_like", lambda: nd._random_normal_like(
            like, loc=0.5, scale=2.0), 0.5, 4.0, (n,)),
        ("_random_exponential_like", lambda: nd._random_exponential_like(
            like, lam=2.0), 0.5, 0.25, (n,)),
        ("_random_gamma_like", lambda: nd._random_gamma_like(
            like, alpha=2.5, beta=1.5), 3.75, 5.625, (n,)),
        ("_random_poisson_like", lambda: nd._random_poisson_like(
            like, lam=3.5), 3.5, 3.5, (n,)),
        ("_random_negative_binomial_like",
         lambda: nd._random_negative_binomial_like(like, k=3, p=0.4), 4.5,
         11.25, (n,)),
        ("_random_generalized_negative_binomial_like",
         lambda: nd._random_generalized_negative_binomial_like(
             like, mu=2.0, alpha=0.5), 2.0, 4.0, (n,)),
    ]


def imp_random(card):
    imp_moments(card, [s[:4] for s in imp_samplers()], IMP_DRAWS, IMP_SE,
                "imperative random: 2^%d draws a sampler on the card"
                % int(math.log2(IMP_DRAWS)))
    ext = imp_ext_samplers()
    imp_moments(card, [s[:4] for s in ext], IMP_EXT_DRAWS, IMP_EXT_SE,
                "imperative samplers: ops/extended.py's %d, %d draws each "
                "on the card (shape and dtype as expected)"
                % (len(ext), IMP_EXT_DRAWS), shapes={
                    s[0]: s[4] for s in ext})


def imp_moments(card, samplers, draws, se, head, shapes=None):
    rows = []
    for name, draw, mean, var in samplers:
        mx.random.seed(17)
        t_s, x = timed_s(draw)
        check(x.context == mx.gpu(0), "%s drew off the card" % name)
        if shapes is not None:
            check(x.shape == shapes[name] and x.dtype == np.float32,
                  "%s: shape %s dtype %s" % (name, x.shape, x.dtype))
        v = x.asnumpy().astype(np.float64).ravel()
        m = v.mean()
        se_m = math.sqrt(var / v.size)
        dev2 = (v - m) ** 2
        se_v = dev2.std() / math.sqrt(v.size)
        zm, zv = abs(m - mean) / se_m, abs(dev2.mean() - var) / se_v
        if name == "shuffle":
            check(np.array_equal(np.sort(v), np.arange(IMP_DRAWS)),
                  "shuffle is not a permutation")
        check(zm <= se and zv <= se, "%s: mean %g (want %g, %.1f "
              "SE), variance %g (want %g, %.1f SE)"
              % (name, m, mean, zm, dev2.mean(), var, zv))
        mx.random.seed(17)
        check(np.array_equal(draw().asnumpy(), x.asnumpy()),
              "%s: a reseed did not repeat the draws" % name)
        rows.append("%s %.1f/%.1f SE %.2f ms" % (name, zm, zv, 1e3 * t_s))
    print("%s, mean / variance off by (standard errors, bound %g), then a "
          "reseed bit-equal | %s | %s"
          % (head, se, " | ".join(rows), card), flush=True)


def imp_dcgan(card):
    from mxnet_tpu_torch.examples import dcgan

    with mx.name.NameManager():
        t_s, (_, _, hist) = timed_s(lambda: dcgan.train(
            epochs=1, batch_size=IMP_DCGAN_BATCH,
            steps_per_epoch=IMP_DCGAN_STEPS, verbose=False, ctx=mx.gpu(0)))
    d = hist["d_steps"]
    check(len(d) == IMP_DCGAN_STEPS and np.isfinite(d + hist["g_steps"])
          .all(), "dcgan: losses %s" % hist)
    first, last = np.mean(d[:4]), np.mean(d[-4:])
    check(last < first, "dcgan: D's loss did not fall (%g -> %g)"
          % (first, last))
    print("imperative dcgan: examples/dcgan.py's port, %d steps at batch %d "
          "(two Adam Trainers, detach) | %.1f ms a step | D loss %.4f -> "
          "%.4f (first / last 4 steps), G loss %.4f -> %.4f | %s"
          % (IMP_DCGAN_STEPS, IMP_DCGAN_BATCH, 1e3 * t_s / IMP_DCGAN_STEPS,
             first, last, np.mean(hist["g_steps"][:4]),
             np.mean(hist["g_steps"][-4:]), card), flush=True)


def imp_faults(card):
    gpu = mx.gpu(0)
    # fault 4: the hand-written update changes the parameter
    net = mx.gluon.nn.Dense(1, in_units=2)
    net.initialize(mx.init.One(), ctx=gpu)
    x = mx.nd.array(np.ones((1, 2), np.float32), ctx=gpu)
    with mx.autograd.record():
        y = net(x).sum()
    y.backward()
    for p in net.collect_params().values():
        w = p.data()
        w -= 0.1 * p.grad()
    check(np.allclose(net.weight.data().asnumpy(), [[0.9, 0.9]], rtol=1e-6),
          "fault 4: weight %s" % net.weight.data().asnumpy())
    # fault 5: nd.array's dtype and context
    lst = mx.nd.array([[1, 2]], ctx=gpu)
    narrow = mx.nd.array(np.arange(3), ctx=gpu)
    kept = mx.nd.array(lst)
    check(lst.dtype == np.float32 and narrow.dtype == np.int32
          and kept.context == gpu, "fault 5: %s %s %s"
          % (lst.dtype, narrow.dtype, kept.context))
    # fault 6: iteration ends after the last row; np.asarray reads it
    rows = mx.nd.array(np.arange(6, dtype=np.float32).reshape(3, 2), ctx=gpu)
    check(len(list(rows)) == 3 and np.asarray(rows).shape == (3, 2),
          "fault 6: iteration")
    try:
        rows[3]
        check(False, "fault 6: rows[3] did not raise")
    except IndexError:
        pass
    print("imperative faults: 4 (w -= 0.1 g gives [[0.9, 0.9]]), 5 (list -> "
          "float32, int64 -> int32, array(ndarray) keeps gpu(0)) and 6 (3 "
          "rows, then IndexError) hold on the card | %s" % card, flush=True)


def phase_imperative(card):
    """The imperative core and the weight store at resnet50_v1's full
    width (see the module doc, phase 11)."""
    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp(prefix="imperative_")
    try:
        net, _ = imp_store(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.backends.cudnn.deterministic = prev_det
    trainer, raw, y, loss_fn = imp_finetune(card, net)
    imp_hand_update(card, net, raw, y, loss_fn)
    del trainer
    torch.cuda.empty_cache()
    imp_second_order(card, net, raw, loss_fn)
    imp_cast(card, net, raw)
    del net, raw
    torch.cuda.empty_cache()
    imp_ops(card)
    imp_random(card)
    imp_dcgan(card)
    imp_faults(card)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the imperative path launched %s"
          % launched)
    print("imperative: hand-written kernels launched on the imperative "
          "path: %s (none is on it) | phase %.1f s | %s"
          % (launched, time.perf_counter() - t_phase, card), flush=True)


# ---------------------------------------------------------------------------
# phase 12: the data pipeline
# ---------------------------------------------------------------------------


def data_image(rng):
    """One ImageNet-shaped image: a smooth random colour field (bicubic
    from a 32x coarser grid) plus uniform noise of +-34 levels."""
    from PIL import Image

    long_side = int(rng.randint(*DATA_LONG))
    h, w = (DATA_SHORT, long_side) if rng.rand() < 0.5 else \
        (long_side, DATA_SHORT)
    base = (rng.rand(h // 32 + 1, w // 32 + 1, 3) * 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC),
                     np.float32)
    img += rng.randint(-34, 35, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def data_records(card, root):
    """The phase's .rec/.idx through the port's recordio (PIL's JPEG
    encoder); returns the .rec path."""
    import PIL
    from PIL import features

    from concurrent.futures import ThreadPoolExecutor

    rec, idx = os.path.join(root, "train.rec"), os.path.join(root,
                                                              "train.idx")
    labels = np.random.RandomState(0).randint(1000, size=DATA_IMAGES)

    def record(i):  # image i from its own seed; PIL releases the GIL
        return mx.recordio.pack_img(
            (0, float(labels[i]), i, 0),
            data_image(np.random.RandomState(1 + i)), quality=DATA_QUALITY)

    t0 = time.perf_counter()
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        for i, buf in enumerate(pool.map(record, range(DATA_IMAGES))):
            w.write_idx(i, buf)
    w.close()
    write_s = time.perf_counter() - t0
    try:
        import cv2
        cv = "cv2 %s" % cv2.__version__
    except ImportError:
        cv = "no cv2"
    print("data records: %d JPEG images, short side %d, long %d-%d, quality "
          "%d, labels in [0, 1000) from a seed | written by PIL %s (libjpeg "
          "%s; mx.image.imdecode would use %s) | .rec %.1f MB in %.2f s | "
          "%s" % (DATA_IMAGES, DATA_SHORT, DATA_LONG[0], DATA_LONG[1] - 1,
                  DATA_QUALITY, PIL.__version__, features.version("jpg"),
                  cv, os.path.getsize(rec) / 2 ** 20, write_s, card),
          flush=True)
    return rec


def data_epochs(it, epochs, keep):
    """``epochs`` epochs of ``it``, each after reset(): (images/s per
    epoch, the batches as host (data, label, pad) when ``keep``)."""
    rates, out = [], []
    for _ in range(epochs):
        it.reset()
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for b in it:
            n += b.data[0].shape[0]
            if keep:
                out.append((b.data[0]._data.cpu(), b.label[0]._data.cpu(),
                            b.pad))
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return rates, out


def data_iter_check(card, rec):
    """ImageRecordIter alone on the card against the same iterator on the
    CPU: the example's settings bit for bit over 2 epochs, a normalized
    epoch within DATA_NORM_REL, then the native decoder's configuration."""
    common = dict(path_imgrec=rec, data_shape=DATA_SHAPE,
                  batch_size=DATA_BATCH, shuffle=True, rand_crop=True,
                  rand_mirror=True, prefetch_buffer=DATA_PREFETCH)
    card_it = mx.io.ImageRecordIter(ctx=mx.gpu(0), **common)
    rates, got = data_epochs(card_it, DATA_EPOCHS, True)
    cpu_it = mx.io.ImageRecordIter(ctx=mx.cpu(), **common)
    _, want = data_epochs(cpu_it, DATA_EPOCHS, True)
    check(len(got) == len(want) == DATA_EPOCHS * -(-DATA_IMAGES
                                                   // DATA_BATCH),
          "iterator: %d card and %d CPU batches" % (len(got), len(want)))
    for k, ((gd, gl, gp), (wd, wl, wp)) in enumerate(zip(got, want)):
        check(torch.equal(gd, wd) and torch.equal(gl, wl) and gp == wp,
              "iterator: batch %d on the card differs from the CPU's" % k)
    check(bool(((got[0][0] >= 0) & (got[0][0] <= 255)
                & (got[0][0] == got[0][0].round())).all()),
          "iterator: the example's batch is not its uint8 pixels")
    norm = dict(common, mean_r=DATA_MEAN[0], mean_g=DATA_MEAN[1],
                mean_b=DATA_MEAN[2], std_r=DATA_STD[0], std_g=DATA_STD[1],
                std_b=DATA_STD[2], scale=DATA_SCALE)
    _, gn = data_epochs(mx.io.ImageRecordIter(ctx=mx.gpu(0), **norm), 1,
                        True)
    _, wn = data_epochs(mx.io.ImageRecordIter(ctx=mx.cpu(), **norm), 1,
                        True)
    norm_err = max(float((g[0] - w[0]).abs().max() / w[0].abs().max())
                   for g, w in zip(gn, wn))
    check(norm_err <= DATA_NORM_REL, "iterator: normalized data %.3g of "
          "max|ref| from the CPU's" % norm_err)
    print("data iter: ImageRecordIter 3x%dx%d batch %d shuffle rand_crop "
          "rand_mirror, prefetch_buffer %d, preprocess_threads %d, "
          "os.cpu_count() %d | %s img/s by epoch | decoders: %s | %d "
          "batches bit-equal to the CPU iterator's (pixels, labels, pad) | "
          "normalized (ImageNet mean/std, scale %.4f) within %.2g of "
          "max|ref| of the CPU's | %s"
          % (DATA_SHAPE[1], DATA_SHAPE[2], DATA_BATCH, DATA_PREFETCH,
             card_it._nthreads, os.cpu_count(),
             " / ".join("%.1f" % r for r in rates), card_it._decoded,
             len(got), DATA_SCALE, norm_err, card), flush=True)
    card_it.close()
    cpu_it.close()
    if mx.native.available():
        nat = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=DATA_SHAPE,
                                    batch_size=DATA_BATCH, ctx=mx.gpu(0))
        nat_rates, _ = data_epochs(nat, 1, False)
        check(nat._decoded["native"] > 0, "the native configuration "
              "decoded no batch natively: %s" % nat._decoded)
        print("data native: centre-crop 3x%dx%d batch %d on the native "
              "decoder (libjpeg on %d C++ threads) | %.1f img/s | decoders: "
              "%s | pool %s | %s"
              % (DATA_SHAPE[1], DATA_SHAPE[2], DATA_BATCH, nat._nthreads,
                 nat_rates[0], nat._decoded, mx.storage.pool_stats(), card),
              flush=True)
        nat.close()
    else:
        print("data native: the native runtime did not build, so every "
              "configuration takes the Python (PIL) decoder: %s | %s"
              % (mx.native.load_error(), card), flush=True)
    return rates


def data_loop(card, rec):
    """examples/train_imagenet.py --data-train at full width, beside
    --benchmark 1; the loop's own steps 1-DATA_PROFILE_STEPS (the first
    epoch after its first batch) under torch.profiler, started and
    stopped by train()'s step_hook."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.examples import train_imagenet

    window = range(1, 1 + DATA_PROFILE_STEPS)
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])

    def step_hook(i):  # after step i's synchronize
        if i == window[0] - 1:
            prof.start()
        elif i == window[-1]:
            prof.stop()

    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train_imagenet.train(
        ["--data-train", rec, "--network", "resnet50_v1", "--batch-size",
         str(DATA_BATCH), "--num-epochs", str(DATA_EPOCHS)],
        step_hook=step_hook, hybridize=False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, epochs = res["losses"], res["epochs"]
    check(np.isfinite(losses).all(), "data loop: non-finite loss %s"
          % losses)
    check(all(0.0 <= e["accuracy"] <= 1.0 for e in epochs),
          "data loop: accuracy outside [0, 1]: %s" % epochs)
    steps = DATA_EPOCHS * -(-DATA_IMAGES // DATA_BATCH)
    check(losses.shape == (steps,), "data loop: %d steps, not %d"
          % (losses.size, steps))
    net, trainer = res["net"], res["trainer"]
    check(on_card(trainer, net), "data loop: state off the card")
    wall_ms = 1e3 * sum(res["step_s"][i] for i in window)
    wait_ms = 1e3 * sum(res["data_wait_s"][i] for i in window)
    rows = [(ev.count, _self_device_us(ev)) for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA]
    card_ms = sum(us for _, us in rows) / 1e3
    if card_ms:
        prof_text = ("steps %d-%d under torch.profiler: %d kernels, %.1f ms "
                     "on the card of %.1f ms: idle %.1f%%; next() waited "
                     "%.2f ms a step"
                     % (window[0], window[-1], sum(c for c, us in rows if us),
                        card_ms, wall_ms,
                        100 * max(0.0, 1 - card_ms / wall_ms),
                        wait_ms / len(window)))
    else:
        prof_text = "profile not measured (torch.profiler recorded no " \
                    "device time)"
    plain_s = [t for i, t in enumerate(res["step_s"]) if i not in window]
    del net, trainer, res["iterator"]
    torch.cuda.empty_cache()
    bench = train_imagenet.train(
        ["--benchmark", "1", "--network", "resnet50_v1", "--batch-size",
         str(DATA_BATCH), "--steps", str(DATA_BENCH_STEPS)],
        hybridize=False)
    check(np.isfinite(bench["losses"]).all(), "data loop: --benchmark 1 "
          "gave a non-finite loss")
    print("data loop: train_imagenet --data-train resnet50_v1 3x%dx%d batch "
          "%d, %d epochs of %d images (f32, TF32 off, sgd lr 0.1 momentum "
          "0.9 wd 1e-4, kvstore device) | %s img/s by epoch (the first "
          "carries the first step and the profiler's start and stop) | "
          "first step "
          "%.2f s, step median %.2f ms (unprofiled steps), next() median "
          "%.2f ms, at each epoch's first batch %s ms | accuracy %s | peak "
          "%.2f GB | %s "
          "| --benchmark 1 at the same network and batch: %.1f img/s, step "
          "median %.2f ms | losses %s | %s"
          % (DATA_SHAPE[1], DATA_SHAPE[2], DATA_BATCH, DATA_EPOCHS,
             DATA_IMAGES, " / ".join("%.1f" % e["images_per_sec"]
                                     for e in epochs),
             res["step_s"][0], 1e3 * statistics.median(plain_s),
             1e3 * statistics.median(res["data_wait_s"]),
             " / ".join("%.1f" % (1e3 * res["data_wait_s"][i])
                        for i in range(0, steps, steps // DATA_EPOCHS)),
             ["%.4f" % e["accuracy"] for e in epochs], peak, prof_text,
             bench["images_per_sec"], 1e3 * statistics.median(
                 bench["step_s"]), ["%.3f" % v for v in losses], card),
          flush=True)
    del bench
    torch.cuda.empty_cache()


def data_loader(card, rec):
    """DataLoader(ImageRecordDataset(rec).transform_first(...), pinned, 4
    workers, device_prefetch 2) into the one-card ShardedTrainer under
    bf16_mixed; its card batches against the same loader's on the CPU."""
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import (ImageRecordDataset,
                                                   transforms)

    tf = transforms.Compose([
        transforms.CenterCrop(DATA_SHAPE[1]), transforms.ToTensor(),
        transforms.Normalize([m / 255 for m in DATA_MEAN],
                             [s / 255 for s in DATA_STD])])
    ds = ImageRecordDataset(rec).transform_first(tf)
    n = DATA_LOADER_STEPS * DATA_LOADER_BATCH
    sub = ds.take(n)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = parallel.ShardedTrainer(
        net, lambda o, l: loss_fn(o, l), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        dtype_policy="bf16_mixed")
    loader = DataLoader(sub, batch_size=DATA_LOADER_BATCH,
                        num_workers=DATA_LOADER_WORKERS, pin_memory=True,
                        device_prefetch=2)
    got, losses = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in loader:
        check(x.is_cuda and y.is_cuda, "loader: a batch off the card")
        losses.append(trainer.step([x], y))
        got.append((x.cpu(), y.cpu()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    check(len(got) == DATA_LOADER_STEPS, "loader: %d batches" % len(got))
    check(np.isfinite(losses).all(), "loader: non-finite loss %s" % losses)
    t0 = time.perf_counter()
    want = list(DataLoader(sub, batch_size=DATA_LOADER_BATCH,
                           num_workers=DATA_LOADER_WORKERS))
    loader_rate = n / (time.perf_counter() - t0)
    for k, ((gx, gy), (wx, wy)) in enumerate(zip(got, want)):
        check(torch.equal(gx, wx._data) and torch.equal(gy, wy._data),
              "loader: batch %d on the card differs from the CPU's" % k)
    print("data loader: DataLoader(ImageRecordDataset.transform_first("
          "CenterCrop %d, ToTensor, Normalize), batch %d, %d workers, "
          "pin_memory, device_prefetch 2) -> ShardedTrainer resnet50_v1 "
          "bf16_mixed, %d steps | %.1f img/s (the first step builds the "
          "trainer); the same loader alone on the host %.1f img/s | batches "
          "bit-equal to the loader's on the CPU | losses %s | %s"
          % (DATA_SHAPE[1], DATA_LOADER_BATCH, DATA_LOADER_WORKERS,
             DATA_LOADER_STEPS, n / wall, loader_rate,
             ["%.4f" % v for v in losses], card), flush=True)
    del net, trainer
    torch.cuda.empty_cache()


def phase_data(card):
    """The data pipeline: records, ImageRecordIter, the example's
    --data-train loop and a DataLoader into ShardedTrainer (see the
    module doc, phase 12)."""
    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    root = tempfile.mkdtemp(prefix="data_")
    try:
        rec = data_records(card, root)
        data_iter_check(card, rec)
        data_loop(card, rec)
        data_loader(card, rec)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the data path launched %s"
          % launched)
    print("data: hand-written kernels launched on the data path: %s (none "
          "is on it) | phase %.1f s | %s"
          % (launched, time.perf_counter() - t_phase, card), flush=True)


# ---------------------------------------------------------------------------
# phase 13: the symbolic API and hybridize()
# ---------------------------------------------------------------------------


def write_mnist(root, n, seed=0):
    """idx-ubyte image and label files of ``n`` digits whose labels can
    be learnt: a class's prototype plus noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    protos = rng.rand(10, 28, 28)
    imgs = np.clip(protos[labels] + rng.rand(n, 28, 28) * 0.5, 0, 1)
    with open(os.path.join(root, "train-images-idx3-ubyte"), "wb") as f:
        f.write(np.array([2051, n, 28, 28], ">u4").tobytes()
                + (imgs * 255).astype(np.uint8).tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(np.array([2049, n], ">u4").tobytes() + labels.tobytes())


class RecordingXavier(mx.init.Xavier):
    """Xavier that keeps a host copy of every value it draws."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.values = {}

    def __call__(self, desc, arr):
        super().__call__(desc, arr)
        self.values[str(desc)] = arr.asnumpy().copy()


def graph_breaks():
    from torch._dynamo.utils import counters
    return sum(counters["graph_break"].values())


def close(got, ref, atol, rtol):
    """max |got - ref| / (atol + rtol |ref|) over the elements: <= 1 holds."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / (atol + rtol * np.abs(ref))).max())


def grad_rel(got, ref):
    """The worst ||got - ref||_2 / max(||ref||_2, 1e-3 x the largest
    ||ref||_2) over the gradients, and its parameter.  The floor holds a
    gradient whose exact value is 0 (a convolution's bias before a
    BatchNorm in training: f32 noise in both runs) against the largest
    instead of against its own noise."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    floor = max(1e-3 * max(norms.values()), 1e-30)
    rel = {k: float(np.linalg.norm(got[k] - ref[k])) / max(norms[k], floor)
           for k in ref}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def cache_counts():
    """dynamo's persistent-cache counters (inductor's FX-graph cache,
    AOTAutograd's cache), as jit.Compiled reads them."""
    from torch._dynamo.utils import counters
    return {name: counters[group][name]
            for group, name in mx.jit._CACHE_COUNTERS}


def counts_text(c):
    return "fx-graph hits %d misses %d bypasses %d, aot-autograd hits %d " \
        "misses %d bypasses %d" % (
            c["fxgraph_cache_hit"], c["fxgraph_cache_miss"],
            c["fxgraph_cache_bypass"], c["autograd_cache_hit"],
            c["autograd_cache_miss"], c["autograd_cache_bypass"])


def sym_module(card, root, ex):
    """The Module path: fit 2 epochs, accuracy, img/s of epoch 2, and the
    first 3 updates' parameters against the same updates on the CPU."""
    args = ex.parse_args(["--data-dir", root, "--epochs", str(SYM_EPOCHS),
                          "--batch-size", str(SYM_BATCH), "--lr",
                          str(SYM_LR)])
    init = RecordingXavier(magnitude=2.0)
    seen, stamps, speeds = [], [], []

    class Speeds(logging.Handler):
        def emit(self, record):
            if "Speed:" in record.getMessage():
                speeds.append(record.getMessage().split("\t")[1])

    def on_batch(param):
        stamps.append((param.epoch, time.perf_counter()))
        if param.epoch == 0 and param.nbatch < SYM_CPU_UPDATES:
            batch = param.locals["batch"]
            arg, _ = param.locals["self"].get_params()
            seen.append((batch.data[0].asnumpy(), batch.label[0].asnumpy(),
                         {k: v.asnumpy() for k, v in arg.items()}))

    handler, root_log = Speeds(), logging.getLogger()
    prev_level = root_log.level
    root_log.addHandler(handler)
    root_log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        # the example's Speedometer logs every 50 batches, past this
        # run's 32 an epoch; this one every 10
        mod, score = ex.train_module(
            args, ctx=mx.gpu(0), initializer=init, batch_end_callback=[
                mx.callback.Speedometer(SYM_BATCH, 10), on_batch])
    finally:
        root_log.removeHandler(handler)
        root_log.setLevel(prev_level)
    fit_s = time.perf_counter() - t0
    acc = dict(score)["accuracy"]
    check(acc > 0.5, "Module.fit accuracy %.3f (chance 0.1)" % acc)
    last = [t for e, t in stamps if e == SYM_EPOCHS - 1]
    img_s = SYM_BATCH * (len(last) - 1) / (last[-1] - last[0])
    ex_compile = sum(e.compile_seconds for e in mod._exec_group.execs)
    # the same first updates on the CPU, from the same initial values
    prev_backend = mx.jit._BACKEND
    mx.jit._BACKEND = "aot_eager"   # inductor's CPU code generation: slow
    try:
        cpu = mx.mod.Module(ex.mlp_symbol(), context=mx.cpu())
        cpu.bind(data_shapes=[("data", (SYM_BATCH, 1, 28, 28))],
                 label_shapes=[("softmax_label", (SYM_BATCH,))])
        cpu.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in init.values.items()})
        cpu.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": SYM_LR, "momentum": 0.9})
        worst = 0.0
        for x, y, card_params in seen:
            cpu.forward_backward(mx.io.DataBatch(
                [mx.nd.array(x, ctx=mx.cpu())], [mx.nd.array(y, ctx=mx.cpu())]))
            cpu.update()
            for k, v in cpu.get_params()[0].items():
                ref = v.asnumpy()
                worst = max(worst, close(card_params[k], ref, 1e-6 * np.abs(
                    ref).max(), SYM_PARAM_RTOL))
    finally:
        mx.jit._BACKEND = prev_backend
    check(len(seen) == SYM_CPU_UPDATES and worst <= 1.0,
          "Module updates card vs CPU: %g of the bound" % worst)
    print("symbolic module: train_mnist --api module, MLP 784-128-64-10 "
          "SoftmaxOutput, %d images batch %d, sgd lr %g momentum 0.9, "
          "Xavier magnitude 2, %d epochs | fit %.1f s (executor compile "
          "%.1f s) | epoch %d %.1f img/s | Speedometer %s | validation "
          "accuracy %.4f (chance 0.1) | first %d updates card vs CPU %.3g "
          "of the bound | %s"
          % (SYM_IMAGES, SYM_BATCH, SYM_LR, SYM_EPOCHS, fit_s, ex_compile,
             SYM_EPOCHS, img_s, speeds[-1:] or "none", acc, SYM_CPU_UPDATES,
             worst, card), flush=True)
    return img_s


def grads_of(net, full_names=False):
    """{name: gradient}: structural names (the same in two instances of
    one network), or the parameters' own."""
    params = net.collect_params() if full_names \
        else net._collect_params_with_prefix()
    return {k: p.grad().asnumpy() for k, p in params.items()
            if p.grad_req != "null"}


def copy_weights(src, dst):
    for p, q in zip(src.collect_params().values(),
                    dst.collect_params().values()):
        q.set_data(p.data())


def fwd_bwd(net, x, y, loss_fn, train_mode=True):
    with mx.autograd.record(train_mode=train_mode):
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward()
    return out.asnumpy()


def sym_gluon(card, root, ex):
    """The gluon path: step 1 hybridized against eager, then the
    example's loop for 1 warm-up + SYM_GLUON_STEPS steps."""
    args = ex.parse_args(["--data-dir", root, "--batch-size",
                          str(SYM_BATCH), "--lr", str(SYM_LR)])
    train, _ = ex.get_iters(SYM_BATCH, root, mx.gpu(0))
    batch = next(iter(train))
    x, y = batch.data[0], batch.label[0]
    nets = []
    for _ in range(2):
        net = ex.lenet_gluon()
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        with mx.autograd.pause():
            net(x)
        nets.append(net)
    eager, hyb = nets
    copy_weights(hyb, eager)
    hyb.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    breaks = graph_breaks()
    t0 = time.perf_counter()
    logits_h = fwd_bwd(hyb, x, y, loss_fn)
    first_s = time.perf_counter() - t0
    logits_e = fwd_bwd(eager, x, y, loss_fn)
    lerr = close(logits_h, logits_e, SYM_LOGIT_TOL, SYM_LOGIT_TOL)
    gerr, gworst = grad_rel(grads_of(hyb), grads_of(eager))
    check(lerr <= 1.0 and gerr <= SYM_GRAD_REL,
          "LeNet hybridized vs eager: logits %g of the bound, gradients %g "
          "(%s)" % (lerr, gerr, gworst))
    res = ex.train_gluon(args, ctx=mx.gpu(0), net=hyb,
                         max_steps=1 + SYM_GLUON_STEPS)
    losses = res["losses"]
    breaks = graph_breaks() - breaks
    check(np.isfinite(losses).all() and losses[-3:].mean()
          < losses[1:4].mean(), "LeNet losses %s" % losses)
    check(breaks == 0, "LeNet: %d graph breaks" % breaks)
    med = statistics.median(res["step_s"][1:])
    print("symbolic gluon: train_mnist --api gluon, hybridized LeNet, batch "
          "%d, sgd lr %g momentum 0.9, 1 warm-up + %d steps | first call "
          "(compile) %.1f s | graph breaks %d | step median %.2f ms, %.1f "
          "img/s | step 1 vs eager: logits %.3g of the bound, gradients "
          "%.3g of their norm (%s) | losses %s | %s"
          % (SYM_BATCH, SYM_LR, SYM_GLUON_STEPS, first_s, breaks, 1e3 * med,
             SYM_BATCH / med, lerr, gerr, gworst,
             ["%.4f" % v for v in losses], card), flush=True)


def sym_step(net, trainer, x, y, loss_fn):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(SYM_NET_BATCH)


def moving_stats(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()
            if k.endswith(("running_mean", "running_var"))}


def sync_weights(src, dst):
    """dst's trainable parameters take src's values, in place."""
    with torch.no_grad():
        for p, q in zip(src.collect_params().values(),
                        dst.collect_params().values()):
            if p.grad_req != "null":
                q.data()._data.copy_(p.data()._data)


def cudnn_off(fn):
    """fn() with cuDNN off: the same network through torch's own
    convolution kernels, a second valid f32 run (the yardstick)."""
    with torch.backends.cudnn.flags(enabled=False):
        return fn()


def within(value, bound, yard):
    """value holds if within its bound, or within SYM_YARD x the same
    measure between two eager runs (``yard``)."""
    return value <= max(bound, SYM_YARD * yard)


def sym_network(name, card, problems):
    """``name`` eager against hybridize() at full width: step 1's logits
    and gradients, moving stats after 3 steps from shared weights,
    compile time, step medians, kernels a step and the idle share.  A
    comparison that fails is added to ``problems`` (the phase raises
    after its last line).  Returns the row and (hybridized net, x, y)
    for the export check."""
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(SYM_NET_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, SYM_NET_BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    mx.random.seed(0)
    nets = []
    for _ in range(3):
        net = sym_build(name)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        with mx.autograd.pause():
            net(x[0:2])
        nets.append(net)
    eager, hyb, alt = nets
    copy_weights(eager, hyb)
    copy_weights(eager, alt)
    hyb.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    breaks = graph_breaks()
    first = []      # the wall of each compiled key's first call
    # step 1 compared without an update: squeezenet1.1's Dropout draws
    # its masks from two different generators (eager: the framework's;
    # compiled: inductor's), so it is compared in predict mode
    train_mode = name != SYM_SQUEEZE
    torch.cuda.synchronize()
    counts0 = cache_counts()
    t0 = time.perf_counter()
    logits_h = fwd_bwd(hyb, x, y, loss_fn, train_mode)
    first.append(time.perf_counter() - t0)
    counts = {k: v - counts0[k] for k, v in cache_counts().items()}
    logits_e = fwd_bwd(eager, x, y, loss_fn, train_mode)
    logits_a = cudnn_off(lambda: fwd_bwd(alt, x, y, loss_fn, train_mode))
    grads_e = grads_of(eager)
    lerr = close(logits_h, logits_e, SYM_LOGIT_TOL, SYM_LOGIT_TOL)
    lyard = close(logits_a, logits_e, SYM_LOGIT_TOL, SYM_LOGIT_TOL)
    gerr, gworst = grad_rel(grads_of(hyb), grads_e)
    gyard, _ = grad_rel(grads_of(alt), grads_e)
    if not (within(lerr, 1.0, lyard) and within(gerr, SYM_GRAD_REL, gyard)):
        problems.append("%s step 1 hybridized vs eager: logits %g of the "
                        "bound (eager with cuDNN off %g), gradients %g (%s; "
                        "eager with cuDNN off %g)"
                        % (name, lerr, lyard, gerr, gworst, gyard))
    copy_weights(eager, hyb)   # undo step 1's moving-stat updates
    copy_weights(eager, alt)
    trainers = [mx.gluon.Trainer(n.collect_params(), "sgd", {
        "learning_rate": SYM_NET_LR, "momentum": 0.9}) for n in nets]
    # 3 steps, the eager nets taking the hybridized net's weights before
    # each: resnet50_v1 from Xavier amplifies f32 rounding step by step
    # (on their own weights, hybridized and eager moving stats parted by
    # 479 x their bound after 3 steps, PERF.md PR 13), which would hide
    # a fault of the compiled path's moving-stat update
    for i in range(SYM_COMPARE_STEPS):
        sync_weights(hyb, eager)
        sync_weights(hyb, alt)
        dt, _ = timed_s(lambda: sym_step(hyb, trainers[1], x, y, loss_fn))
        if i == 0 and not train_mode:
            first.append(dt)
        sym_step(eager, trainers[0], x, y, loss_fn)
        cudnn_off(lambda: sym_step(alt, trainers[2], x, y, loss_fn))
    stats_e = moving_stats(eager)
    serr = max([close(moving_stats(hyb)[k], stats_e[k], SYM_STAT_TOL,
                      SYM_STAT_TOL) for k in stats_e] or [0.0])
    syard = max([close(moving_stats(alt)[k], stats_e[k], SYM_STAT_TOL,
                       SYM_STAT_TOL) for k in stats_e] or [0.0])
    if not within(serr, 1.0, syard):
        problems.append("%s moving stats after %d steps: %g of the bound "
                        "(eager with cuDNN off %g)"
                        % (name, SYM_COMPARE_STEPS, serr, syard))
    del alt, trainers[2]
    row = {"network": name, "batch": SYM_NET_BATCH,
           "logits_first": logits_h, "cache_counts": counts,
           "first_call_s": first[0]}
    for tag, net, tr in (("eager", eager, trainers[0]),
                         ("hybridized", hyb, trainers[1])):
        steps = [timed_s(lambda: sym_step(net, tr, x, y, loss_fn))[0]
                 for _ in range(SYM_TIMED_STEPS)]
        med = statistics.median(steps)
        prof = device_kernels(lambda: sym_step(net, tr, x, y, loss_fn))
        row[tag] = {"step_ms": 1e3 * med, "img_s": SYM_NET_BATCH / med,
                    "kernels": prof[0] if isinstance(prof, tuple) else None,
                    "idle": (max(0.0, 1 - prof[1] / (1e3 * med))
                             if isinstance(prof, tuple) else None),
                    "profile": kernels_text(prof)}
    breaks = graph_breaks() - breaks
    check(breaks == 0, "%s: %d graph breaks" % (name, breaks))
    med_s = row["hybridized"]["step_ms"] / 1e3
    row["compile_s"] = sum(f - med_s for f in first)
    row["forward_compile_s"] = hyb._cached_op.compile_seconds
    row["graph_breaks"] = breaks
    e, h = row["eager"], row["hybridized"]

    def pct(v):
        return "not measured" if v is None else "%.1f%%" % (100 * v)
    print("symbolic %s: batch %d 3x%dx%d f32 (TF32 off), sgd lr %g momentum "
          "0.9 | compile %.1f s (first calls less a step; forward %.1f s) | "
          "graph breaks %d | eager %.2f ms %.1f img/s, %s kernels a step, "
          "idle %s | hybridized %.2f ms %.1f img/s, %s kernels a step, idle "
          "%s | step 1 (%s mode) logits %.3g of the bound, gradients %.3g "
          "of their norm (%s) | moving stats after %d steps %.3g of the "
          "bound | eager with cuDNN off against eager: logits %.3g, "
          "gradients %.3g, moving stats %.3g | %s"
          % (name, SYM_NET_BATCH, IMAGE, IMAGE, SYM_NET_LR,
             row["compile_s"], row["forward_compile_s"], breaks,
             e["step_ms"], e["img_s"], e["kernels"], pct(e["idle"]),
             h["step_ms"], h["img_s"], h["kernels"], pct(h["idle"]),
             "train" if train_mode else "predict", lerr, gerr, gworst,
             SYM_COMPARE_STEPS, serr, lyard, gyard, syard, card), flush=True)
    return row, (hyb, x, y)


def sym_export(card, root, hyb, x, y, problems):
    """SYM_NETS[0] exported and loaded back as a SymbolBlock, and bound
    in a Module under a SoftmaxOutput head."""
    prefix = os.path.join(root, "resnet")
    t0 = time.perf_counter()
    pfile = hyb.export(prefix)
    export_s = time.perf_counter() - t0
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                       pfile, ctx=mx.gpu(0))
    hyb.hybridize(False)    # the source's logits from the same weights
    with mx.autograd.predict_mode():
        ref = hyb(x).asnumpy()
        ref_alt = cudnn_off(lambda: hyb(x).asnumpy())
        t0 = time.perf_counter()
        got = blk(x).asnumpy()
        blk_s = time.perf_counter() - t0
    err = close(got, ref, SYM_EXPORT_TOL, SYM_EXPORT_TOL)
    yard = close(ref_alt, ref, SYM_EXPORT_TOL, SYM_EXPORT_TOL)
    if not within(err, 1.0, yard):
        problems.append("SymbolBlock logits: %g of the bound (eager with "
                        "cuDNN off %g)" % (err, yard))
    sym = mx.sym.load(prefix + "-symbol.json")
    head = mx.sym.SoftmaxOutput(sym, mx.sym.var("softmax_label"),
                                name="softmax")
    mod = mx.mod.Module(head, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", tuple(x.shape))],
             label_shapes=[("softmax_label", tuple(y.shape))])
    saved = mx.nd.load(pfile, ctx=mx.cpu())
    mod.set_params({k[4:]: v for k, v in saved.items() if k[:4] == "arg:"},
                   {k[4:]: v for k, v in saved.items() if k[:4] == "aux:"})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    cudnn_off(lambda: fwd_bwd(hyb, x, y, loss_fn))
    want_alt = grads_of(hyb, full_names=True)
    fwd_bwd(hyb, x, y, loss_fn)    # the gluon path's gradients
    want = grads_of(hyb, full_names=True)
    t0 = time.perf_counter()
    mod.forward_backward(mx.io.DataBatch([x], [y]))
    got_g = {k: mod._exec_group.execs[0].grad_dict[k].asnumpy()
             for k in want}
    mod_s = time.perf_counter() - t0
    # MXNET_FUSION unset: the Module's Executor fires the default-on
    # add_act at each residual join (relu(x + body(x)))
    fired = mod._exec_group.execs[0].fusion_fired
    names = sorted({f[0] for f in fired})
    check(names == ["add_act"], "Module on the export fired %s, not "
          "add_act alone" % names)
    gerr, gworst = grad_rel(got_g, want)
    gyard, _ = grad_rel(want_alt, want)
    if not within(gerr, SYM_GRAD_REL, gyard):
        problems.append("Module on the export: gradients %g (%s; eager with "
                        "cuDNN off %g)" % (gerr, gworst, gyard))
    print("symbolic export: %s export %.2f s (%d arguments, %d aux "
          "states) | SymbolBlock.imports logits vs the source %.3g of the "
          "bound (first call %.1f s) | Module(SoftmaxOutput head) "
          "forward_backward gradients vs the gluon path %.3g of their norm "
          "(%s; first call %.1f s; fusion default: %s at %d sites) | eager "
          "with cuDNN off against eager: logits %.3g, gradients %.3g | %s"
          % (SYM_NETS[0], export_s, len(sym.list_arguments()),
             len(sym.list_auxiliary_states()), err, blk_s, gerr, gworst,
             mod_s, ",".join(names), len(fired), yard, gyard, card),
          flush=True)


def export_source(card):
    """A resnet50_v1 1-1-1-1 (SYM_RESNET, Xavier from seed 0) after
    SYM_COMPARE_STEPS eager sgd steps on sym_network's batch (weights
    and moving stats off their start), hybridized, with that batch."""
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(SYM_NET_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, SYM_NET_BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    mx.random.seed(0)
    net = sym_build(SYM_RESNET)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": SYM_NET_LR, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(SYM_COMPARE_STEPS):
        sym_step(net, trainer, x, y, loss_fn)
    net.hybridize()
    return net, x, y


def symbolic_aside(card):
    """Phase 13's part that measures least: SYM_NETS[1:] eager against
    hybridized and the export check on export_source's net.  In the
    whole script it runs in the side process (SideChecks) beside phases
    13-15; its lines print when phase 15 has ended."""
    before = dict(kernels.launch_counts)
    problems = []
    root = tempfile.mkdtemp(prefix="symbolic_aside_")
    try:
        for name in SYM_NETS[1:]:
            torch.cuda.empty_cache()
            sym_network(name, card, problems)
        torch.cuda.empty_cache()
        sym_export(card, root, *export_source(card), problems)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not problems, "; ".join(problems))
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the symbolic path (%s and the "
          "export) launched %s" % (", ".join(SYM_NETS[1:]), launched))


def phase_symbolic(card, aside=False):
    """The symbolic API and hybridize(): both paths of train_mnist,
    SYM_NETS eager against hybridized, and the export check (see the
    module doc, phase 13); with ``aside``, SYM_NETS[0] alone, and
    symbolic_aside's part is left to the side process."""
    from mxnet_tpu_torch.examples import train_mnist as ex

    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    root = tempfile.mkdtemp(prefix="symbolic_")
    try:
        write_mnist(root, SYM_IMAGES)
        module_img_s = sym_module(card, root, ex)
        sym_gluon(card, root, ex)
        problems = []
        torch.cuda.empty_cache()
        row, held = sym_network(SYM_NETS[0], card, problems)
        del held
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not problems, "; ".join(problems))
    if not aside:
        symbolic_aside(card)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the symbolic path launched %s"
          % launched)
    print("symbolic: hand-written kernels launched on the symbolic path: %s "
          "(none is on it) | Module img/s %.1f | phase %.1f s%s | %s"
          % (launched, module_img_s, time.perf_counter() - t_phase,
             " (%s and the export in the side process)"
             % ", ".join(SYM_NETS[1:]) if aside else "", card), flush=True)
    return row


class SideChecks:
    """A side process of this script (``chip_smoke.py MODE CARD ...``)
    beside the main process's phases 13-15: ``--side`` (symbolic_aside),
    ``--interop`` (phase 23) or ``--examples`` (phase 14's bucketing and
    phase 21d); its lines and
    errors go to files, printed by finish(), which fails if the process
    failed and returns its standard output."""

    def __init__(self, mode, *args):
        self.mode, self.args = mode, list(args)
        self.dir = tempfile.mkdtemp(prefix="side_")
        self.proc = None

    def start(self, card):
        self.card = card
        self.started = time.perf_counter()
        self.out = open(os.path.join(self.dir, "out"), "w+")
        self.err = open(os.path.join(self.dir, "err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, DIST_WORKER_SCRIPT, self.mode, card]
            + self.args, cwd=DIST_ROOT, stdout=self.out, stderr=self.err,
            text=True)

    def finish(self):
        wait_start = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=SIDE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        self.out.seek(0)
        self.err.seek(0)
        out = self.out.read()
        sys.stdout.write(out)
        check(rc == 0, "the side process (%s) %s:\n%s"
              % (self.mode, "exited %d" % rc if rc is not None
                 else "did not finish", self.err.read()[-6000:]))
        waited = time.perf_counter() - wait_start
        # a process that had ended before finish() ended at an unknown
        # time before it
        print("side: %s %s %.1f s after it started; phase 15's end "
              "waited %.1f s for it | %s"
              % (self.mode, "ended" if waited >= 0.5 else "had ended by",
                 time.perf_counter() - self.started, waited, self.card),
              flush=True)
        return out

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for f in (getattr(self, "out", None), getattr(self, "err", None)):
            if f is not None:
                f.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def side_settings():
    """phase_device's settings, in a side process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def side_main(card):
    """Entry of the --side process: symbolic_aside."""
    side_settings()
    symbolic_aside(card)


def interop_main(card, art):
    """Entry of the --interop process: phase 23 on phase 9b's artifact,
    its int8_conv launches on an INTEROP_LAUNCHES line."""
    side_settings()
    launches = phase_interop(card, art)
    print("INTEROP_LAUNCHES %d" % launches, flush=True)


def examples_main(card):
    """Entry of the --examples process: phase 14's bucketing run and the
    fine-tuning example (phase 21d), neither launching a hand-written
    kernel."""
    side_settings()
    before = dict(kernels.launch_counts)
    rec_bucketing(card)
    fine_tune_check(card)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "bucketing and fine-tuning launched "
          "%s" % launched)


# phase 21d: the port's examples/fine_tune.py at its defaults
# (resnet18_v1 "pretrained" on 10 classes, grafted to 20, 3x32x32,
# batch 32, sgd lr 0.05 momentum 0.9, backbone lr_mult 0.1), one epoch
# of 8 batches and 2 validation batches, on the card
FT_ARGS = ["--epochs", "1", "--train-batches", "8", "--val-batches", "2"]


def fine_tune_check(card):
    from mxnet_tpu_torch.examples import fine_tune

    t0 = time.perf_counter()
    out = fine_tune.train(FT_ARGS, ctx=mx.gpu(0))
    wall = time.perf_counter() - t0
    check(len(out["losses"]) == 8 and np.all(np.isfinite(out["losses"])),
          "fine_tune losses %s" % out["losses"])
    print("finetune: examples/fine_tune.py %s | cut at flatten, new head "
          "20 classes, backbone lr_mult 0.1 | losses %s | train accuracy "
          "%.3f, validation accuracy %.3f | %.1f s (two compiles: the "
          "training and the predict graph) | %s"
          % (" ".join(FT_ARGS), ["%.3f" % v for v in out["losses"]],
             out["train_acc"][-1], out["val_acc"], wall, card), flush=True)


# phase 21c: the persistent compile cache.  A child process (this script
# with --warm-compile) rebuilds phase 13's hybridized resnet50_v1 cut
# (the same seed, batch and first training call) after phase 13 has
# compiled it into the script's fresh cache directory
WARM_TIMEOUT_S = 600


def warm_main(card, out_dir):
    """Entry of the warm-compile process: phase 13's settings, its
    hybridized SYM_NETS[0] from seed 0, one training forward and
    backward; the logits and the cache counters go to ``out_dir``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(SYM_NET_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, SYM_NET_BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    mx.random.seed(0)
    net = sym_build(SYM_RESNET)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.pause():
        net(x[0:2])
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    counts0 = cache_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = fwd_bwd(net, x, y, loss_fn, True)
    first_s = time.perf_counter() - t0
    np.save(os.path.join(out_dir, "warm_logits.npy"), logits)
    with open(os.path.join(out_dir, "warm.json"), "w") as f:
        json.dump({"first_call_s": first_s,
                   "forward_compile_s": net._cached_op.compile_seconds,
                   "counts": {k: v - counts0[k]
                              for k, v in cache_counts().items()},
                   "dir": mx.config.get("MXNET_COMPILE_CACHE_DIR")}, f)


class WarmCompile:
    """warm_main in a process of its own, started once phase 13 has
    compiled and run beside phases 14-15; finish() holds its logits and
    cache counters against phase 13's."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="warm_")
        self.proc = None

    def start(self, card, row):
        self.card, self.row = card, row
        self.err = open(os.path.join(self.dir, "err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, DIST_WORKER_SCRIPT, "--warm-compile", card,
             self.dir], cwd=DIST_ROOT, stdout=self.err,
            stderr=subprocess.STDOUT, text=True)

    def finish(self):
        try:
            rc = self.proc.wait(timeout=WARM_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        self.err.seek(0)
        check(rc == 0, "the warm-compile process %s:\n%s"
              % ("exited %d" % rc if rc is not None else "did not finish",
                 self.err.read()[-6000:]))
        with open(os.path.join(self.dir, "warm.json")) as f:
            warm = json.load(f)
        logits = np.load(os.path.join(self.dir, "warm_logits.npy"))
        cold, c = self.row["cache_counts"], warm["counts"]
        diff = float(np.abs(logits.astype(np.float64)
                            - self.row["logits_first"]).max())
        print("compile cache: %s hybridized, batch %d, the first training "
              "call | parent (cold, phase 13): compile %.1f s (first call "
              "%.1f s, forward %.1f s), %s | child (--warm-compile): first "
              "call %.1f s (forward %.1f s), %s | child logits against "
              "the parent's: max |diff| %g | cache %s | %s"
              % (SYM_RESNET, SYM_NET_BATCH, self.row["compile_s"],
                 self.row["first_call_s"], self.row["forward_compile_s"],
                 counts_text(cold), warm["first_call_s"],
                 warm["forward_compile_s"], counts_text(c), diff,
                 warm["dir"], self.card), flush=True)
        check(warm["dir"] == COMPILE_DIR,
              "the child's cache is %s, not %s" % (warm["dir"], COMPILE_DIR))
        check(c["fxgraph_cache_hit"] >= 1 and c["fxgraph_cache_miss"] == 0,
              "the warm child did not hit the compile cache: %s"
              % counts_text(c))
        check(np.array_equal(logits, self.row["logits_first"]),
              "the warm child's logits differ from the parent's by %g"
              % diff)

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if getattr(self, "err", None) is not None:
            self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


# phase 21a: rematerialisation on phase 7's path (resnet50_v1 at full
# width, 1000 classes, bf16_mixed, batch 256, sgd lr 0.1 momentum 0.9,
# ShardedTrainer), each policy from the same weights (seed 0) with
# deterministic cuDNN: 2 warm-up + 5 synchronous steps
REMAT_POLICIES = ("none", "dots_saveable", "full")
REMAT_WARM, REMAT_STEPS = 2, 5


def resnet_trainer(x, seed=0, remat_policy=None):
    """Phases 21a and 22's trainer: resnet50_v1 at full width, 1000
    classes, Xavier from ``seed``, bf16_mixed, sgd lr 0.1 momentum 0.9
    through ShardedTrainer."""
    mx.random.seed(seed)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.pause():      # deferred shapes: Xavier draws here
        net(x[0:2])
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return parallel.ShardedTrainer(
        net, lambda o, l: loss_fn(o, l), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        dtype_policy="bf16_mixed", remat_policy=remat_policy)


def remat_run(policy, x, y):
    trainer = resnet_trainer(x, remat_policy=policy)
    torch.cuda.synchronize()
    gc.collect()      # an earlier policy's trainer and graph (cycles)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, first = [], [], None
    for i in range(REMAT_WARM + REMAT_STEPS):
        dt, loss = timed_s(lambda: trainer.step([x], y))
        losses.append(float(loss))
        step_s.append(dt)
        if i == 0:
            first = [t.clone() for t in trainer.param_arrays]
    peak = torch.cuda.max_memory_allocated()
    trainer.close()
    med = statistics.median(step_s[REMAT_WARM:])
    return {"losses": losses, "first": first, "step_ms": 1e3 * med,
            "img_s": SHARDED_BATCH / med, "peak_gb": peak / 1e9,
            "activation_gb": (peak - base) / 1e9,
            "warm_ms": [1e3 * s for s in step_s[:REMAT_WARM]]}


def remat_hybridized(card):
    """21b: phase 13's hybridized LeNet under hybridize(remat_policy=
    "dots_saveable") against the eager block, step 1's logits and
    gradients within phase 13's bounds."""
    from mxnet_tpu_torch.examples import train_mnist as ex

    root = tempfile.mkdtemp(prefix="remat_")
    try:
        write_mnist(root, SYM_BATCH * 2)
        train, _ = ex.get_iters(SYM_BATCH, root, mx.gpu(0))
        batch = next(iter(train))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    x, y = batch.data[0], batch.label[0]
    nets = []
    for _ in range(2):
        net = ex.lenet_gluon()
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        with mx.autograd.pause():
            net(x)
        nets.append(net)
    eager, hyb = nets
    copy_weights(hyb, eager)
    hyb.hybridize(remat_policy="dots_saveable")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    breaks = graph_breaks()
    t0 = time.perf_counter()
    logits_h = fwd_bwd(hyb, x, y, loss_fn)
    first_s = time.perf_counter() - t0
    breaks = graph_breaks() - breaks
    logits_e = fwd_bwd(eager, x, y, loss_fn)
    lerr = close(logits_h, logits_e, SYM_LOGIT_TOL, SYM_LOGIT_TOL)
    gerr, gworst = grad_rel(grads_of(hyb), grads_of(eager))
    check(hyb._cached_op._remat, "hybridize(remat_policy=...) is not on")
    check(breaks == 0, "remat LeNet: %d graph breaks" % breaks)
    check(lerr <= 1.0 and gerr <= SYM_GRAD_REL,
          "remat LeNet hybridized vs eager: logits %g of the bound, "
          "gradients %g (%s)" % (lerr, gerr, gworst))
    print("remat compiled: train_mnist's LeNet hybridize(remat_policy="
          "'dots_saveable'), batch %d | first call (compile) %.1f s | graph "
          "breaks %d | step 1 vs eager: logits %.3g of the bound, gradients "
          "%.3g of their norm (%s) | %s"
          % (SYM_BATCH, first_s, breaks, lerr, gerr, gworst, card),
          flush=True)


def phase_remat(card):
    """Phase 21a-b (module doc)."""
    before = dict(kernels.launch_counts)
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(SHARDED_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, SHARDED_BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = {}
    try:
        for policy in REMAT_POLICIES:
            runs[policy] = remat_run(policy, x, y)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev
    ref = runs["none"]
    worst = {}
    for policy in REMAT_POLICIES[1:]:
        r = runs[policy]
        worst[policy] = max(float((a.double() - b.double()).abs().max())
                            for a, b in zip(r["first"], ref["first"]))
        check(r["losses"][0] == ref["losses"][0],
              "remat %s: step 1 loss %r against none's %r"
              % (policy, r["losses"][0], ref["losses"][0]))
        check(all(torch.equal(a, b) for a, b in zip(r["first"],
                                                    ref["first"])),
              "remat %s: parameters after step 1 differ from none's by %g"
              % (policy, worst[policy]))
        check(all(np.isfinite(r["losses"])), "remat %s: losses %s"
              % (policy, r["losses"]))
    check(runs["full"]["peak_gb"] < ref["peak_gb"],
          "remat full's peak %.3f GB is not below none's %.3f GB"
          % (runs["full"]["peak_gb"], ref["peak_gb"]))
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the remat path launched %s"
          % launched)
    print("remat: resnet50_v1 bf16_mixed batch %d ShardedTrainer sgd lr 0.1 "
          "momentum 0.9, cuDNN deterministic, %d warm-up + %d steps | %s | "
          "step 1 loss and every parameter and moving stat after step 1 "
          "bit-equal to none's (worst |diff| %s) | losses %s | %s"
          % (SHARDED_BATCH, REMAT_WARM, REMAT_STEPS, " | ".join(
              "%s: step median %.2f ms, %.1f img/s, peak %.3f GB (above "
              "the state %.3f GB), warm-up ms %s"
              % (p, runs[p]["step_ms"], runs[p]["img_s"], runs[p]["peak_gb"],
                 runs[p]["activation_gb"],
                 ["%.1f" % v for v in runs[p]["warm_ms"]])
              for p in REMAT_POLICIES), worst,
             {p: ["%.4f" % v for v in runs[p]["losses"]]
              for p in REMAT_POLICIES}, card), flush=True)
    del runs
    torch.cuda.empty_cache()
    remat_hybridized(card)


# phase 22 (checkpoint): fault-tolerant checkpointing on phase 21a's path
# (resnet_trainer, deterministic cuDNN, one fixed batch from seed 0): a
# reference run of CKPT_STEPS steps; a run from the same weights with an
# async CheckpointManager (keep CKPT_KEEP, a save every CKPT_PERIOD steps)
# stopped by SIGTERM after CKPT_PREEMPT steps; a resume on a trainer from
# seed 1; then CKPT_TIMED steps alone and as many with a save in flight.
# The Module check: phase 13's train_mnist MLP (Module.fit, sgd lr SYM_LR
# momentum 0.9, Xavier magnitude 2, batch SYM_BATCH) over CKPT_MNIST
# digits, unshuffled (the iterator's shuffle draws from numpy's global
# generator, which no checkpoint holds), 1 epoch then a resumed fit to
# CKPT_MNIST_EPOCHS, against an uninterrupted fit; and a fit stopped by
# SIGTERM at batch CKPT_MNIST_STOP of epoch 1, resumed, against a fit
# started by hand from its flush
CKPT_STEPS, CKPT_PREEMPT, CKPT_PERIOD, CKPT_KEEP = 6, 4, 2, 2
CKPT_TIMED = 3
CKPT_MNIST, CKPT_MNIST_EPOCHS, CKPT_MNIST_STOP = 1024, 2, 7


def ckpt_equal(got, want):
    """Tensors bit for bit, and the largest |difference| for the log."""
    same = len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    worst = max((float((a.double() - b.double()).abs().max())
                 for a, b in zip(got, want) if a.shape == b.shape),
                default=float("nan"))
    return same, worst


def ckpt_module(root):
    """22f: train_mnist's Module through fit(checkpoint_manager=).  One
    epoch, then a fresh Module resumed to CKPT_MNIST_EPOCHS, against an
    uninterrupted fit; then a fit stopped by SIGTERM from its
    batch_end_callback at batch CKPT_MNIST_STOP of epoch 1: the flush
    holds the params it stopped at, and a fresh Module's auto-resume
    equals a fit started by hand from the flushed params, optimizer
    state and epoch.  Returns (seconds, worst |diff|)."""
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.examples import train_mnist as ex

    data_dir = os.path.join(root, "mnist")
    os.makedirs(data_dir)
    write_mnist(data_dir, CKPT_MNIST)
    opt_params = {"learning_rate": SYM_LR, "momentum": 0.9}

    def fit(epochs, manager=None, callback=None, start=None):
        _, data = ex.get_iters(SYM_BATCH, data_dir, mx.gpu(0))
        mx.random.seed(0)
        mod = mx.mod.Module(ex.mlp_symbol(), context=mx.gpu(0))
        kw = {}
        if start is not None:       # (epoch, arg, aux, optimizer bytes)
            arg, aux = ({k: mx.nd.array(v, ctx=mx.gpu(0))
                         for k, v in d.items()} for d in start[1:3])
            mod.bind(data.provide_data, data.provide_label)
            mod.init_params(arg_params=arg, aux_params=aux)
            mod.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
            mod.set_optimizer_states_bytes(start[3])
            kw = dict(begin_epoch=start[0] + 1, arg_params=arg,
                      aux_params=aux, force_init=True)
        mod.fit(data, optimizer="sgd", optimizer_params=opt_params,
                num_epoch=epochs, initializer=mx.init.Xavier(magnitude=2.0),
                checkpoint_manager=manager, batch_end_callback=callback,
                **kw)
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    def diff(got, want):
        worst = max(float(np.abs(got[k].astype(np.float64) - v).max())
                    for k, v in want.items())
        return sorted(got) == sorted(want) and all(
            np.array_equal(got[k], v) for k, v in want.items()), worst

    t0 = time.perf_counter()
    full = fit(CKPT_MNIST_EPOCHS)
    mdir = os.path.join(root, "module")
    m1 = mx.CheckpointManager(mdir, async_save=False)
    fit(1, m1)
    check(m1.steps() == [0], "Module.fit saved steps %s, want [0]"
          % m1.steps())
    m2 = mx.CheckpointManager(mdir, async_save=False)
    resumed = fit(CKPT_MNIST_EPOCHS, m2)
    check(m2.steps() == list(range(CKPT_MNIST_EPOCHS)),
          "the resumed Module.fit saved steps %s" % m2.steps())
    check(m2.read_manifest(0)["meta"]["kind"] == "module",
          "Module checkpoint kind %r" % m2.read_manifest(0)["meta"])
    same, worst = diff(resumed, full)
    check(same, "the resumed Module.fit differs from the uninterrupted one "
          "by %g" % worst)
    # the preemption flush in the middle of epoch 1
    pdir = os.path.join(root, "module_preempted")
    mp = mx.CheckpointManager(pdir, async_save=False)
    seen = []

    def stop(param):
        seen.append((param.epoch, param.nbatch))
        if (param.epoch, param.nbatch) == (1, CKPT_MNIST_STOP):
            os.kill(os.getpid(), signal.SIGTERM)

    stopped = fit(CKPT_MNIST_EPOCHS, mp, callback=stop)
    check(mp.preempted and seen[-1] == (1, CKPT_MNIST_STOP),
          "SIGTERM at epoch 1 batch %d: preempted %s, the last batch %s"
          % (CKPT_MNIST_STOP, mp.preempted, seen[-1:]))
    check(mp.steps() == [0, 1], "the preempted Module.fit saved steps %s"
          % mp.steps())
    flushed = mp.load()
    check(flushed.step == 1 and flushed.meta.get("partial") is True
          and flushed.meta.get("preempted") is True,
          "the flushed Module checkpoint: step %d meta %s"
          % (flushed.step, flushed.meta))
    start = ck.split_module_payload(flushed)
    check(start[0] == 0 and start[3], "the flushed checkpoint's epoch %d, "
          "optimizer state %s" % (start[0], bool(start[3])))
    same, worst_p = diff(start[1], stopped)
    check(same, "the flushed params differ from those the fit stopped at "
          "by %g" % worst_p)
    mr = mx.CheckpointManager(pdir, async_save=False)
    after = fit(CKPT_MNIST_EPOCHS, mr)
    check(not mr.preempted and mr.read_manifest(1)["meta"].get("partial")
          is None, "the resumed Module.fit left step 1 partial: %s"
          % mr.read_manifest(1)["meta"])
    same, worst_r = diff(after, fit(CKPT_MNIST_EPOCHS, start=start))
    check(same, "the Module resumed after SIGTERM differs from a fit "
          "started by hand from the flush by %g" % worst_r)
    check(not diff(after, start[1])[0], "the resumed Module.fit did not "
          "train past the flush")
    return time.perf_counter() - t0, max(worst, worst_p, worst_r)


def ckpt_sharded(root, trainer):
    """22e: a single-process sharded save of the trainer, validated
    offline, then loaded with a restrict map: every array bit-equal."""
    from mxnet_tpu_torch import checkpoint as ck

    sdir = os.path.join(root, "sharded")
    msh = ck.CheckpointManager(sdir, sharded=True, async_save=False)
    t0 = time.perf_counter()
    step = trainer.save_checkpoint(msh)
    save_s = time.perf_counter() - t0
    vstep, problems = ck.validate_sharded_checkpoint(sdir)
    check(vstep == step and problems == [],
          "sharded checkpoint step %s: %s" % (vstep, problems))
    _, arrays, _, _ = trainer._checkpoint_payload()
    # the map a restore on this process asks for: every array whole
    full = {k: [[[0, int(d)] for d in np.shape(v)]] for k, v in
            arrays.items()}
    c = msh.load(restrict=full)
    check(c.sharded and c.shards_read == 1 and set(c.arrays) == set(arrays),
          "restricted sharded load: %d shard(s) read, arrays %d of %d"
          % (c.shards_read, len(c.arrays), len(arrays)))
    for k, v in arrays.items():
        if k == "rng":
            same = np.array_equal(c.arrays[k], v)
        else:
            same = torch.equal(c.tensor(k), v.detach().cpu())
        check(same, "sharded %s is not bit-equal to the trainer's" % k)
    # a map that leaves an array out reads none of it
    skip = dict(full, **{"param:0000": [[[0, 0]] * len(full["param:0000"][0])]})
    check("param:0000" not in msh.load(restrict=skip).arrays,
          "the restrict map did not leave param:0000 out")
    return save_s


def ckpt_corrupt(root, m_dir):
    """22d: flip a bit of step CKPT_PREEMPT's data file: a fresh load falls
    back to the step before, warns, and CHECKPOINT_DIGEST_FAILURES rises
    by one.  Returns the fallback load's seconds."""
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.testing import faults

    m = ck.CheckpointManager(m_dir)
    faults.flip_bit(m.data_path(CKPT_PREEMPT))
    was_on = telemetry.enabled()
    telemetry.enable()
    try:
        f0 = telemetry.CHECKPOINT_DIGEST_FAILURES.value()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            c = ck.CheckpointManager(m_dir).load()
            load_s = time.perf_counter() - t0
        f1 = telemetry.CHECKPOINT_DIGEST_FAILURES.value()
    finally:
        if not was_on:
            telemetry.disable()
    want = CKPT_PREEMPT - CKPT_PERIOD
    check(c is not None and c.step == want,
          "after the bit flip the load gave step %s, want %d"
          % (c and c.step, want))
    check(any("CORRUPT" in str(w.message) for w in rec),
          "no CORRUPT warning on the fallback")
    check(f1 - f0 == 1, "CHECKPOINT_DIGEST_FAILURES rose by %s" % (f1 - f0))
    return load_s


def ckpt_goodput(gp_dir):
    """22d: the goodput ledger of runs (b) and (c), read by the port's
    goodputz CLI: a preempted and a resumed incarnation, committed
    ckpt_save segments and a ckpt_restore segment."""
    cli = os.path.join(DIST_ROOT, "mxnet_tpu_torch", "tools", "goodputz.py")
    r = subprocess.run([sys.executable, cli, gp_dir, "--json"],
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0, "goodputz exited %d: %s"
          % (r.returncode, r.stderr[-500:]))
    rep = json.loads(r.stdout)
    incs = sorted(rep["incarnations"], key=lambda i: i["start_time"])
    check([(i["start_reason"], i["exit_reason"]) for i in incs]
          == [("fresh", "preempt"), ("resume", "clean")],
          "goodput incarnations %s" % [(i["start_reason"], i["exit_reason"])
                                       for i in incs])
    check(incs[0]["last_ckpt_step"] == CKPT_PREEMPT
          and incs[1]["resumed_from_step"] == CKPT_PREEMPT,
          "goodput checkpoint steps %s / %s"
          % (incs[0]["last_ckpt_step"], incs[1]["resumed_from_step"]))
    check(incs[0]["buckets_s"]["ckpt_save"] > 0
          and incs[1]["buckets_s"]["ckpt_restore"] > 0,
          "goodput ckpt buckets %s / %s" % (incs[0]["buckets_s"],
                                             incs[1]["buckets_s"]))
    return rep


def phase_checkpoint(card):
    """Phase 22 (module doc)."""
    from mxnet_tpu_torch import checkpoint as ck

    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    prev_term = signal.getsignal(signal.SIGTERM)
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(SHARDED_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, SHARDED_BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    root = tempfile.mkdtemp(prefix="ckpt_")
    m_dir = os.path.join(root, "dense")
    gp_dir = os.path.join(root, "goodput")
    prev_gp = os.environ.get("MXNET_GOODPUT_DIR")
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # (a) the reference run
        ref = resnet_trainer(x)
        ref_losses, alone_s = [], []
        for _ in range(CKPT_STEPS):
            dt, loss = timed_s(lambda: ref.step([x], y))
            ref_losses.append(float(loss))
            alone_s.append(dt)
        ref_state = [t.clone() for t in ref.state_tensors()]
        ref.close()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        # (b) the preempted run, its goodput recorder begun at attach
        os.environ["MXNET_GOODPUT_DIR"] = gp_dir
        tb = resnet_trainer(x)
        mb = ck.CheckpointManager(m_dir, keep_last=CKPT_KEEP,
                                  async_save=True)
        check(tb.attach_checkpoint_manager(mb, period=CKPT_PERIOD) == 0,
              "a fresh directory resumed a step")
        b_losses, b_steps = [], []
        try:
            for _ in range(CKPT_PREEMPT):
                busy = mb._thread is not None and mb._thread.is_alive()
                dt, loss = timed_s(lambda: tb.step([x], y))
                b_losses.append(float(loss))
                b_steps.append((1e3 * dt, busy))
            os.kill(os.getpid(), signal.SIGTERM)   # the handler flushes
            check(mb.preempted, "SIGTERM did not set manager.preempted")
        finally:
            mb.uninstall_preemption_handler()
        check(mb.steps() == [CKPT_PREEMPT - CKPT_PERIOD, CKPT_PREEMPT],
              "committed steps %s" % mb.steps())
        meta = mb.read_manifest(CKPT_PREEMPT)["meta"]
        check(meta.get("preempted") is True
              and meta["step"] == CKPT_PREEMPT
              and meta["kind"] == "sharded_trainer",
              "the flushed checkpoint's meta: %s"
              % {k: meta.get(k) for k in ("preempted", "step", "kind")})
        b_state = [t.clone() for t in tb.state_tensors()]
        b_rng = mx.random.get_key_data()
        ckpt_bytes = os.path.getsize(mb.data_path(CKPT_PREEMPT)) + \
            os.path.getsize(mb.manifest_path(CKPT_PREEMPT))
        tb.close()
        del tb
        gc.collect()
        torch.cuda.empty_cache()
        # (c) the resume, on a trainer from other weights
        tc = resnet_trainer(x, seed=1)
        mc = ck.CheckpointManager(m_dir, keep_last=CKPT_KEEP,
                                  async_save=True)
        try:
            load_s, start = timed_s(
                lambda: tc.attach_checkpoint_manager(mc))
            check(start == CKPT_PREEMPT, "attach resumed step %s, want %d"
                  % (start, CKPT_PREEMPT))
            same, worst_b = ckpt_equal(tc.state_tensors(), b_state)
            check(same, "the restored state differs from run (b)'s after "
                  "step %d by %g" % (CKPT_PREEMPT, worst_b))
            check(np.array_equal(mx.random.get_key_data(), b_rng),
                  "the restored random stream differs from run (b)'s")
            c_losses = [float(tc.step([x], y))
                        for _ in range(CKPT_PREEMPT, CKPT_STEPS)]
        finally:
            mc.uninstall_preemption_handler()
        goodput.note_exit("clean", step=tc.global_step)
        os.environ.pop("MXNET_GOODPUT_DIR")
        check(b_losses + c_losses == ref_losses,
              "losses preempted %s + resumed %s against the reference %s"
              % (b_losses, c_losses, ref_losses))
        same, worst_c = ckpt_equal(tc.state_tensors(), ref_state)
        check(same, "the state after step %d differs from the reference's "
              "by %g" % (CKPT_STEPS, worst_c))
        del ref_state, b_state
        # (g) a save's blocking snapshot and background write, and steps
        # alone against steps with a save in flight
        mt = ck.CheckpointManager(os.path.join(root, "timing"), keep_last=1,
                                  async_save=True)
        snap_ms, write_s, quiet_ms, busy_ms = [], [], [], []
        for _ in range(CKPT_TIMED):
            dt, _ = timed_s(lambda: tc.step([x], y))
            quiet_ms.append(1e3 * dt)
            dt, _ = timed_s(lambda: tc.save_checkpoint(mt))
            snap_ms.append(1e3 * dt)
            check(mt._thread is not None and mt._thread.is_alive(),
                  "the save finished before the step it should overlap")
            dt, _ = timed_s(lambda: tc.step([x], y))
            busy_ms.append(1e3 * dt)
            mt.wait()
            write_s.append(mt.last_save_s)
        # (d) corruption, and the goodput ledger
        fallback_s = ckpt_corrupt(root, m_dir)
        gp = ckpt_goodput(gp_dir)
        # (e) a single-process sharded save
        sharded_s = ckpt_sharded(root, tc)
        tc.close()
        del tc
        gc.collect()
        torch.cuda.empty_cache()
        # (f) the Module path
        module_s, module_worst = ckpt_module(root)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = prev
        if goodput.active():
            goodput.note_exit("clean")
        if prev_gp is None:
            os.environ.pop("MXNET_GOODPUT_DIR", None)
        else:
            os.environ["MXNET_GOODPUT_DIR"] = prev_gp
        shutil.rmtree(root, ignore_errors=True)
    check(signal.getsignal(signal.SIGTERM) is prev_term,
          "SIGTERM's handler was not restored")
    check(signal.SIGTERM not in signal.pthread_sigmask(signal.SIG_BLOCK, []),
          "SIGTERM is left blocked in the main thread")
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the checkpoint path launched %s"
          % launched)
    print("checkpoint: resnet50_v1 bf16_mixed batch %d ShardedTrainer sgd lr "
          "0.1 momentum 0.9, cuDNN deterministic | %.1f MB a checkpoint "
          "(data + manifest) | blocking snapshot ms %s | background "
          "serialise + digest + fsync s %s | load + restore %.3f s | "
          "corrupt-latest fallback load %.3f s | sharded save %.3f s | step "
          "ms alone %s, with a save in flight %s | run (b) step ms (save in "
          "flight) %s | losses %s, preempted at %d and resumed bit-equal "
          "(state, random stream, steps %d-%d) | goodput %.2f%% over %d "
          "incarnations | Module resumed bit-equal at an epoch boundary "
          "and, after SIGTERM at epoch 1 batch %d, from its partial flush, "
          "in %.1f s (worst |diff| %g) | phase %.1f s | %s"
          % (SHARDED_BATCH, ckpt_bytes / 1e6,
             ["%.1f" % v for v in snap_ms], ["%.3f" % v for v in write_s],
             load_s, fallback_s, sharded_s,
             ["%.2f" % v for v in quiet_ms], ["%.2f" % v for v in busy_ms],
             ["%.2f (%s)" % (ms, "yes" if busy else "no")
              for ms, busy in b_steps],
             ["%.4f" % v for v in ref_losses], CKPT_PREEMPT,
             CKPT_PREEMPT + 1, CKPT_STEPS, gp["goodput_pct"] or 0.0,
             gp["n_incarnations"], CKPT_MNIST_STOP, module_s, module_worst,
             time.perf_counter() - t_phase, card), flush=True)


# phase 14 (recurrent): the RNN op at the word LM's width, each mode on
# the card against its plain composition on the card (f32, TF32 off)
REC_T, REC_N, REC_C, REC_LAYERS = 35, 32, 650, 2
REC_CASES = (("lstm", False), ("gru", False), ("rnn_tanh", False),
             ("rnn_relu", False), ("lstm", True))
REC_OUT_TOL, REC_GRAD_REL = 1e-5, 1e-4
REC_SMALL = (5, 3, 4, 6)        # T, N, C, H of the card-vs-CPU case
REC_DEVICE = "cuda"
# upstream example/gluon/word_language_model's medium configuration, at
# WikiText-2's vocabulary, on the example's seeded Markov corpus
LM_ARGS = ["--model", "lstm", "--vocab", "33278", "--emsize", "650",
           "--nhid", "650", "--nlayers", "2", "--bptt", "35",
           "--batch-size", "32", "--lr", "20", "--clip", "0.25",
           "--dropout", "0.2", "--epochs", "1", "--corpus-len", "40000"]
LM_STEPS = 31                    # 1 warm-up + 30 timed
LM_LOGIT_TOL, LM_GRAD_REL = 1e-4, 1e-3
# upstream example/rnn/bucketing/lstm_bucketing.py's width (2 x
# LSTMCell(200), embed 200, vocabulary 10000, batch 32), cut in depth
# to buckets 3 and 4 (unrolled steps) in place of its 10-60: inductor
# takes about 6-7 s a step to compile a bucket (buckets 10 and 20: 62.7
# and 117.5 s, PERF.md section 4; bucket 8 29.8-58.4 s in PR 19's runs,
# so 6 from then; buckets 4 and 6 took 28.9 and 44.6 s, PERF.md section
# 7, so 3 and 4 since phase 23 came); upstream's lr
# 0.01, with the example's momentum 0.9 (the example's own lr 0.2
# diverges at this vocabulary)
BUCKET_ARGS = ["--cells", "--vocab", "10000", "--num-embed", "200",
               "--num-hidden", "200", "--batch-size", "32", "--buckets",
               "3,4", "--epochs", "1", "--lr", "0.01"]


def rec_inputs(mode, bidir, T, N, C, H, device, seed=0):
    """Data, flat parameters (torch's default RNN init, U(-1/sqrt(H),
    1/sqrt(H))) and states, from a seed."""
    from mxnet_tpu_torch.ops import nn as tnn

    D = 2 if bidir else 1
    g = tnn._GATES[mode]
    n = sum(D * g * H * ((C if layer == 0 else H * D) + H)
            for layer in range(REC_LAYERS)) + REC_LAYERS * D * 2 * g * H
    rng = np.random.RandomState(seed)
    k = 1.0 / math.sqrt(H)
    ins = [rng.randn(T, N, C), rng.uniform(-k, k, n),
           rng.randn(REC_LAYERS * D, N, H) * 0.5]
    if mode == "lstm":
        ins.append(rng.randn(REC_LAYERS * D, N, H) * 0.5)
    attrs = dict(state_size=H, num_layers=REC_LAYERS, bidirectional=bidir,
                 mode=mode, state_outputs=True)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in ins], attrs


def rec_fwd_bwd(fn, ins, attrs, cots):
    leaves = [t.detach().requires_grad_(True) for t in ins]
    outs = fn(*leaves, **attrs)
    grads = torch.autograd.grad(list(outs), leaves, cots)
    return [o.detach() for o in outs], list(grads)


def rec_op(card):
    """The RNN op (cuDNN a layer) against rnn_plain on the card, each
    mode at the word LM's width, forward and gradients, eagerly
    (torch._VF) and compiled (the rnn_layer custom op: _cudnn_rnn and
    _cudnn_rnn_backward), with the time of one forward+backward each
    way; the small case card vs CPU."""
    from mxnet_tpu_torch.ops import nn as tnn

    op = registry.get_op("RNN").fn
    rows = []
    for mode, bidir in REC_CASES:
        ins, attrs = rec_inputs(mode, bidir, REC_T, REC_N, REC_C, REC_C,
                                REC_DEVICE)
        dev = ins[0].device
        gen = torch.Generator(device=dev).manual_seed(1)
        cots = [torch.randn(o.shape, generator=gen, device=dev)
                for o in op(*ins, **attrs)]
        compiled = torch.compile(functools.partial(op, **attrs),
                                 fullgraph=True)

        def run_compiled(*a, **k):
            return compiled(*a)
        want, want_g = rec_fwd_bwd(tnn.rnn_plain, ins, attrs, cots)
        t0 = time.perf_counter()
        rec_fwd_bwd(run_compiled, ins, attrs, cots)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        errs = {}
        for route, fn in (("eager", op), ("compiled", run_compiled)):
            got, got_g = rec_fwd_bwd(fn, ins, attrs, cots)
            errs[route] = (
                max(close(g.cpu().numpy(), w.cpu().numpy(), REC_OUT_TOL,
                          REC_OUT_TOL) for g, w in zip(got, want)),
                max(float((g - w).norm() / w.norm().clamp_min(1e-30))
                    for g, w in zip(got_g, want_g)))
            check(errs[route][0] <= 1.0, "RNN %s bidir=%s %s: outputs %g of "
                  "the bound" % (mode, bidir, route, errs[route][0]))
            check(errs[route][1] <= REC_GRAD_REL, "RNN %s bidir=%s %s: "
                  "gradients %g of their norm" % (mode, bidir, route,
                                                  errs[route][1]))
        ms = time_ms(lambda: rec_fwd_bwd(op, ins, attrs, cots))
        compiled_ms = time_ms(lambda: rec_fwd_bwd(run_compiled, ins, attrs,
                                                  cots))
        plain_ms = time_ms(lambda: rec_fwd_bwd(tnn.rnn_plain, ins, attrs,
                                               cots))
        prof = device_kernels(lambda: rec_fwd_bwd(op, ins, attrs, cots))
        prof_c = device_kernels(lambda: rec_fwd_bwd(run_compiled, ins,
                                                    attrs, cots))
        row = {"mode": mode, "bidirectional": bidir, "ms": ms,
               "compiled_ms": compiled_ms, "plain_ms": plain_ms,
               "compile_s": compile_s, "errs": errs}
        rows.append(row)
        print("recurrent op: %s%s T %d N %d C=H %d, %d layers | forward+"
              "backward: cuDNN eager %.3f ms, cuDNN compiled %.3f ms "
              "(compile %.1f s), plain composition %.3f ms (%.1fx eager) | "
              "outputs eager %.3g / compiled %.3g of 1e-5 + 1e-5|ref|, "
              "gradients %.3g / %.3g of their norm (bound 1e-4) | eager: "
              "%s | compiled: %s | %s"
              % (mode, " bidirectional" if bidir else "", REC_T, REC_N,
                 REC_C, REC_LAYERS, ms, compiled_ms, compile_s, plain_ms,
                 plain_ms / ms, errs["eager"][0], errs["compiled"][0],
                 errs["eager"][1], errs["compiled"][1],
                 kernels_text(prof, top=True), kernels_text(prof_c),
                 card), flush=True)
    T, N, C, H = REC_SMALL
    out_worst = grad_worst = 0.0
    for mode, bidir in REC_CASES:
        ins, attrs = rec_inputs(mode, bidir, T, N, C, H, "cpu", seed=2)
        cots = [torch.ones(o.shape) for o in op(*ins, **attrs)]
        want, want_g = rec_fwd_bwd(op, ins, attrs, cots)
        got, got_g = rec_fwd_bwd(op, [t.to(REC_DEVICE) for t in ins],
                                 attrs, [c.to(REC_DEVICE) for c in cots])
        for g, w in zip(got, want):
            out_worst = max(out_worst, close(g.cpu().numpy(), w.numpy(),
                                             REC_OUT_TOL, REC_OUT_TOL))
        for g, w in zip(got_g, want_g):
            grad_worst = max(grad_worst, float(
                (g.cpu() - w).norm() / w.norm().clamp_min(1e-30)))
    check(out_worst <= 1.0 and grad_worst <= REC_GRAD_REL,
          "RNN small case card vs CPU: outputs %g of the bound, gradients "
          "%g of their norm" % (out_worst, grad_worst))
    print("recurrent op small: T %d N %d C %d H %d, each case card against "
          "the port on the CPU: outputs %.3g of 1e-5 + 1e-5|ref|, "
          "gradients %.3g of their norm (bound 1e-4) | %s"
          % (T, N, C, H, out_worst, grad_worst, card), flush=True)
    return rows


def lm_batch(args, data, i, ctx):
    return (mx.nd.array(data[i:i + args.bptt], ctx=ctx),
            mx.nd.array(data[i + 1:i + 1 + args.bptt], ctx=ctx))


def lm_models(wlm, args, n, ctx):
    """n models with the same Xavier weights (from mx.random.seed(0))."""
    models = []
    for _ in range(n):
        with mx.name.NameManager():
            m = wlm.build(args, ctx)
        with mx.autograd.pause():   # the decoder's input width
            m(mx.nd.zeros((args.bptt, args.batch_size), ctx=ctx),
              *m.begin_state(args.batch_size, ctx=ctx))
        models.append(m)
    for m in models[1:]:
        copy_weights(models[0], m)
    return models


def lm_parity(wlm, card):
    """Dropout 0: step 1's logits and gradients, hybridized against
    eager on the card."""
    args = wlm.parse_args(LM_ARGS + ["--dropout", "0"])
    ctx = mx.gpu(0)
    mx.random.seed(0)
    eager, hyb = lm_models(wlm, args, 2, ctx)
    hyb.hybridize()
    data = wlm.corpus(args)
    x, y = lm_batch(args, data, 0, ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    res = []
    for m in (eager, hyb):
        states = m.begin_state(args.batch_size, ctx=ctx)
        with mx.autograd.record():
            out, _ = m(x, *states)
            loss = loss_fn(out.reshape((-1, args.vocab)), y.reshape((-1,)))
        loss.backward()
        res.append((out.asnumpy(), grads_of(m)))
    lerr = close(res[1][0], res[0][0], LM_LOGIT_TOL, LM_LOGIT_TOL)
    gerr, gworst = grad_rel(res[1][1], res[0][1])
    check(lerr <= 1.0, "word LM step 1 logits hybridized vs eager: %g of "
          "the bound" % lerr)
    check(gerr <= LM_GRAD_REL, "word LM step 1 gradients hybridized vs "
          "eager: %g of their norm (%s)" % (gerr, gworst))
    del eager, hyb
    return lerr, gerr, gworst


def lm_run(wlm, args, model, hybridize):
    """The example's train() for LM_STEPS steps, one more step profiled;
    step median, tokens/s, compile seconds, kernels and idle share."""
    torch.cuda.reset_peak_memory_stats()
    breaks = graph_breaks()
    res = wlm.train(args, ctx=mx.gpu(0), model=model, hybridize=hybridize,
                    max_steps=LM_STEPS)
    breaks = graph_breaks() - breaks
    med = statistics.median(res["step_s"][1:])
    i = LM_STEPS * args.bptt
    x, y = lm_batch(args, res["data"], i, mx.gpu(0))
    prof = device_kernels(lambda: res["step"](x, y, res["states"]))
    losses = res["losses"]
    return {"step_ms": 1e3 * med,
            "tokens_s": args.batch_size * args.bptt / med,
            "compile_s": res["step_s"][0] - med, "graph_breaks": breaks,
            "kernels": prof[0] if isinstance(prof, tuple) else None,
            "idle": (max(0.0, 1 - prof[1] / (1e3 * med))
                     if isinstance(prof, tuple) else None),
            "profile": kernels_text(prof),
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "finite": bool(np.isfinite(losses).all()),
            "ppl_first": math.exp(losses[1:6].mean()),
            "ppl_last": math.exp(losses[-5:].mean())}


def rec_lm(card):
    """The port's word_language_model at the medium configuration, eager
    against hybridized (see the module doc, phase 14)."""
    from mxnet_tpu_torch.examples import word_language_model as wlm

    args = wlm.parse_args(LM_ARGS)
    mx.random.seed(0)
    eager, hyb = lm_models(wlm, args, 2, mx.gpu(0))
    rows = {"eager": lm_run(wlm, args, eager, False)}
    del eager
    torch.cuda.empty_cache()
    # timed before lm_parity compiles the dropout-0 copy of this network
    rows["hybridized"] = lm_run(wlm, args, hyb, True)
    h = rows["hybridized"]
    h["forward_compile_s"] = hyb._cached_op.compile_seconds
    del hyb
    torch.cuda.empty_cache()
    lerr, gerr, gworst = lm_parity(wlm, card)
    check(h["graph_breaks"] == 0, "word LM: %d graph breaks"
          % h["graph_breaks"])
    for tag, r in rows.items():
        check(r["finite"], "word LM %s: a loss is not finite" % tag)
        check(r["ppl_last"] < r["ppl_first"], "word LM %s: perplexity did "
              "not fall (%.1f -> %.1f)" % (tag, r["ppl_first"],
                                           r["ppl_last"]))

    def pct(v):
        return "not measured" if v is None else "%.1f%%" % (100 * v)
    for tag, r in rows.items():
        print("recurrent lm %s: LSTM 2x650, emsize 650, vocabulary 33278, "
              "bptt 35, batch 32, dropout 0.2, sgd lr 20 clip 0.25, f32 "
              "(TF32 off) | step %.2f ms (median of %d), %.0f tokens/s | "
              "compile %.1f s (first step less the median; this network's "
              "first compile in the process) | graph breaks "
              "%d | %s a step, idle %s | peak %.2f GB | losses finite %s, "
              "perplexity %.1f (steps 2-6) -> %.1f (last 5) | %s"
              % (tag, r["step_ms"], LM_STEPS - 1, r["tokens_s"],
                 r["compile_s"], r["graph_breaks"], r["profile"],
                 pct(r["idle"]), r["peak_gb"], r["finite"], r["ppl_first"],
                 r["ppl_last"], card), flush=True)
    print("recurrent lm parity (dropout 0): step 1 hybridized against "
          "eager, logits %.3g of 1e-4 + 1e-4|ref|, gradients %.3g of their "
          "norm (%s; bound 1e-3) | hybridized forward compile %.1f s | %s"
          % (lerr, gerr, gworst, h["forward_compile_s"], card), flush=True)
    return rows


def rec_bucketing(card):
    """rnn_bucketing --cells: two mx.rnn.LSTMCell(200) in a
    BucketingModule over BucketSentenceIter, BUCKET_ARGS' buckets."""
    from mxnet_tpu_torch.examples import rnn_bucketing as rb

    args = rb.parse_args(BUCKET_ARGS)
    breaks = graph_breaks()
    res = rb.train(args, ctx=mx.gpu(0))
    breaks = graph_breaks() - breaks
    per = {}
    for key, s in zip(res["buckets"], res["batch_s"]):
        per.setdefault(key, []).append(s)
    compile_s = {k: v[0] - statistics.median(v[1:] or v)
                 for k, v in sorted(per.items())}
    steady = [t for v in per.values() for t in v[1:]]
    ppl = np.array(res["batch_ppl"])
    fifth = max(1, len(ppl) // 5)
    first, last = ppl[:fifth].mean(), ppl[-fifth:].mean()
    print("recurrent bucketing: rnn_bucketing --cells, 2 x mx.rnn.LSTMCell"
          "(200), embed 200, vocabulary 10000, batch 32, sgd lr %g "
          "momentum 0.9, buckets %s | %d batches (%s) | compile %s "
          "| %.2f batches/s after the compiles | graph breaks %d | "
          "perplexity %.1f (first fifth of the batches) -> %.1f (last "
          "fifth), epoch %.1f | %s"
          % (args.lr, " and ".join(args.buckets.split(",")),
             len(res["batch_s"]),
             ", ".join("bucket %d: %d" % (k, len(v))
                       for k, v in sorted(per.items())),
             ", ".join("bucket %d %.1f s" % kv
                       for kv in compile_s.items()),
             len(steady) / sum(steady), breaks, first, last, res["ppl"][0],
             card), flush=True)
    check(breaks == 0, "bucketing: %d graph breaks" % breaks)
    check(np.isfinite(ppl).all(), "bucketing: perplexity not finite")
    check(last < first, "bucketing: perplexity did not fall (%.1f -> "
          "%.1f)" % (first, last))
    return {"compile_s": compile_s, "batches_s": len(steady) / sum(steady)}


def phase_recurrent(card, aside=False):
    """Phase 14 (see the module doc); with ``aside`` the bucketing run is
    left to the --examples side process."""
    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    rec_op(card)
    torch.cuda.empty_cache()
    rec_lm(card)
    torch.cuda.empty_cache()
    if not aside:
        rec_bucketing(card)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the recurrent path launched %s"
          % launched)
    print("recurrent: hand-written kernels launched: %s (none is on it) | "
          "phase %.1f s | %s" % (launched, time.perf_counter() - t_phase,
                                 card), flush=True)


# phase 15 (fusion): each pattern's microbench at a resnet50_v1 or LM
# shape, and a resnet50_v1 bottleneck bound with fusion off/default/all
FUSION_SHAPES = (("conv_bn_relu", (32, 64, 56, 56)),
                 ("norm_act", (32, 256, 56, 56)),
                 ("add_act", (32, 256, 56, 56)),
                 ("act_scale_add", (32, 256, 56, 56)),
                 ("layer_norm_fast", (32 * 512, 512)))
BOTTLENECK = (32, 256, 64, 56, 1000)    # batch, in/out, mid, side, classes


def fusion_micro(card, root):
    from mxnet_tpu_torch import fusion_cost as fc
    from mxnet_tpu_torch.symbol import fusion as fus

    table = fc.CostTable(meta={"device": card,
                               "measured_by": "chip_smoke.py"})
    rows = []
    for name, shape in FUSION_SHAPES:
        r = fus.microbench(name, shape, iters=10, warmup=2, repeats=3,
                           ctx=mx.gpu(0))
        check(r["fired"] and r["key"], "microbench %s: no site" % name)
        table.add(r["key"], r["fused_train_ms"], r["unfused_train_ms"],
                  fused_fwd_ms=r["fused_fwd_ms"],
                  unfused_fwd_ms=r["unfused_fwd_ms"])
        rows.append(r)
        print("fusion microbench %s %s f32: train (forward+backward) fused "
              "%.3f ms, unfused %.3f ms, speedup %.3f | forward fused %.3f "
              "ms, unfused %.3f ms, speedup %.3f | key %s | %s"
              % (name, list(shape), r["fused_train_ms"],
                 r["unfused_train_ms"], r["speedup"], r["fused_fwd_ms"],
                 r["unfused_fwd_ms"], r["speedup_infer"], r["key"], card),
              flush=True)
    path = os.path.join(root, "fusion_cost.json")
    fc.save_table(path, table)
    back = fc.load_table(path)
    check(back.entries == table.entries, "cost table: read back differs")
    plan = fc.FusionPlan(table=back)
    fires = {r["pattern"]: plan.decide(r["pattern"],
                                       fus.get_pattern(r["pattern"])
                                       .default_on, r["key"])
             for r in rows}
    print("fusion table: %d entries saved and loaded back equal | the "
          "default plan with this table fires: %s | %s"
          % (len(back.entries), fires, card), flush=True)
    return rows


def bottleneck_symbol():
    """A resnet50_v1 bottleneck (1x1, 3x3, 1x1, BatchNorm after each,
    the identity shortcut and relu), average pool, a 1000-way head:
    (logits symbol, SoftmaxOutput symbol)."""
    n, c, mid, side, classes = BOTTLENECK
    S = mx.sym
    x = S.var("data")

    def cbn(h, nf, k, name, act=True):
        h = S.Convolution(h, kernel=(k, k), pad=(k // 2, k // 2),
                          num_filter=nf, no_bias=True, name=name + "_conv")
        h = S.BatchNorm(h, fix_gamma=False, name=name + "_bn")
        return S.Activation(h, act_type="relu", name=name + "_relu") \
            if act else h

    body = cbn(cbn(cbn(x, mid, 1, "a"), mid, 3, "b"), c, 1, "c", act=False)
    y = S.Activation(body + x, act_type="relu", name="join")
    y = S.Flatten(S.Pooling(y, kernel=(side, side), pool_type="avg",
                            global_pool=True, name="pool"))
    logits = S.FullyConnected(y, num_hidden=classes, name="fc")
    return logits, S.SoftmaxOutput(logits, S.var("softmax_label"),
                                   name="softmax")


def bottleneck_values(sym, feeds):
    arg_shapes, _, aux_shapes = sym.infer_shape(**feeds)
    rng = np.random.RandomState(0)
    vals = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name == "softmax_label":
            v = rng.randint(0, BOTTLENECK[4], shape)
        elif name.endswith("weight"):
            v = rng.randn(*shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("gamma"):
            v = 1 + 0.1 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) * (1.0 if name == "data" else 0.1)
        vals[name] = v.astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        vals[name] = (np.ones(shape) if name.endswith("var")
                      else np.zeros(shape)).astype(np.float32)
    return vals


def bind_with(sym, feeds, vals, fusion, grad=True):
    req = {n: "write" if grad and n not in feeds else "null"
           for n in sym.list_arguments()}
    ex = sym.simple_bind(ctx=mx.gpu(0), grad_req=req, fusion=fusion,
                         **feeds)
    for d in (ex.arg_dict, ex.aux_dict):
        for name, arr in d.items():
            arr[:] = mx.nd.array(vals[name], ctx=mx.gpu(0))
    return ex


def fusion_bottleneck(card):
    from mxnet_tpu_torch.symbol import fusion as fus

    n, c, _, side, _ = BOTTLENECK
    logits_sym, sym = bottleneck_symbol()
    feeds = {"data": (n, c, side, side), "softmax_label": (n,)}
    vals = bottleneck_values(sym, feeds)
    res = {}
    for fusion in ("off", "default", "all"):
        ex = bind_with(sym, feeds, vals, fusion)
        dt, _ = timed_s(lambda: (ex.forward(is_train=True), ex.backward()))
        out = ex.outputs[0].asnumpy()
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if k not in feeds}
        aux = {k: a.asnumpy() for k, a in ex.aux_dict.items()}
        steps = [timed_s(lambda: (ex.forward(is_train=True),
                                  ex.backward()))[0] for _ in range(5)]
        med = statistics.median(steps)
        prof = device_kernels(lambda: (ex.forward(is_train=True),
                                       ex.backward()))
        res[fusion] = {"out": out, "grads": grads, "aux": aux,
                       "fired": sorted({f[0] for f in ex.fusion_fired}),
                       "sites": len(ex.fusion_fired),
                       "step_ms": 1e3 * med, "compile_s": dt - med,
                       "profile": kernels_text(prof)}
        del ex
    ref = res["off"]
    for fusion in ("default", "all"):
        r = res[fusion]
        oerr = close(r["out"], ref["out"], 1e-4, 1e-4)
        gerr, gworst = grad_rel(r["grads"], ref["grads"])
        serr = max(close(r["aux"][k], ref["aux"][k], 1e-4, 1e-4)
                   for k in ref["aux"])
        check(oerr <= 1.0 and gerr <= 1e-3 and serr <= 1.0,
              "bottleneck fusion=%s against off: outputs %g, gradients %g "
              "(%s), moving stats %g" % (fusion, oerr, gerr, gworst, serr))
        r["errs"] = (oerr, gerr, gworst, serr)
    check(res["default"]["fired"] == ["add_act"], "fusion=default fired %s"
          % res["default"]["fired"])
    for fusion, r in res.items():
        errs = ("outputs %.3g of 1e-4 + 1e-4|ref|, gradients %.3g of their "
                "norm (%s), moving stats %.3g of the bound against off | "
                % r["errs"]) if "errs" in r else ""
        print("fusion bottleneck %s: resnet50_v1 bottleneck %d->%d->%d->%d "
              "at %dx%d, batch %d, classes 1000, f32 (TF32 off) | fired %s "
              "(%d sites) | %sforward+backward %.2f ms (median of 5), "
              "compile %.1f s, %s a step | %s"
              % (fusion, c, BOTTLENECK[2], BOTTLENECK[2], c, side, side, n,
                 r["fired"], r["sites"], errs, r["step_ms"], r["compile_s"],
                 r["profile"], card), flush=True)
    # prediction: BatchNorm folded into the convolutions
    lfeeds = {"data": feeds["data"]}
    args = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in vals.items()
            if k in logits_sym.list_arguments() and k not in lfeeds}
    aux = {k: mx.nd.array(vals[k], ctx=mx.gpu(0))
           for k in logits_sym.list_auxiliary_states()}
    folded, fargs, faux = fus.fold_batchnorm(logits_sym, args, aux)
    check(fus.count_ops(folded, "BatchNorm") == 0, "fold left a BatchNorm")
    outs = []
    for s, a, x in ((logits_sym, args, aux), (folded, fargs, faux)):
        ex = s.simple_bind(ctx=mx.gpu(0), grad_req="null", fusion="off",
                           **lfeeds)
        ex.copy_params_from(a, x)
        ex.arg_dict["data"][:] = mx.nd.array(vals["data"], ctx=mx.gpu(0))
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    ferr = close(outs[1], outs[0], 1e-4, 1e-4)
    check(ferr <= 1.0, "fold_batchnorm: logits %g of the bound" % ferr)
    print("fusion fold: fold_batchnorm of the bottleneck in predict mode, "
          "logits %.3g of 1e-4 + 1e-4|ref| of the unfolded graph | %s"
          % (ferr, card), flush=True)
    return res


def phase_fusion(card):
    """Phase 15 (see the module doc)."""
    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    root = tempfile.mkdtemp(prefix="fusion_")
    try:
        fusion_micro(card, root)
        torch.cuda.empty_cache()
        fusion_bottleneck(card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the fusion path launched %s"
          % launched)
    print("fusion: hand-written kernels launched: %s (none is on it) | "
          "phase %.1f s | %s" % (launched, time.perf_counter() - t_phase,
                                 card), flush=True)



# phase 16 (detection): BASELINE config 5 through the port's
# examples/ssd_detect_quant.py at VGG16's widths (build_ssd width 64: the
# 64x2, 128x2 and 256x3 convolutions of its three stages), VOC's 20
# classes, SSD300's 300x300 input, batch 32 (4 x (75^2 + 37^2) = 27,976
# anchors), the example's synthetic-JPEG .rec of 4 x 32 images through
# ImageDetIter, 30 Module steps, f32 with TF32 off; then the int8 graph of
# quantize_model.  Bounds: int8_conv's int32 outputs bit-equal to the
# plain version, nms's keep masks equal to it; the small case (width 8,
# image 64, batch 2, 3 classes, 4 objects an image) card against the
# port on the CPU: the heads within 1e-4 + 1e-4 |ref|; MultiBoxTarget
# and MultiBoxDetection on the same inputs, class targets and ids exact,
# loc targets within 1e-5, scores and boxes within 1e-4; end to end the
# sorted fp32 scores within 1e-4 and the int8 ones within one int8 step
# of a value in [0, 1] (2^-7 > 1/127: a code parts from the CPU's only
# where an f32 product lands on a rounding tie, by one step)
DET_ARGS = ["--num-classes", "20", "--width", "64", "--image-size", "300",
            "--batch-size", "32", "--train-steps", "30"]
DET_CLASSES, DET_WIDTH, DET_SIDE, DET_BATCH = 20, 64, 300, 32
DET_ANCHORS = 4 * (75 * 75 + 37 * 37)
DET_TOPK, DET_NMS_THRESH = 100, 0.45
INT8_OPS_PER_S = 1979e12         # H100 SXM int8 tensor cores, dense
INT8_FC = (256, 4096, 4096)      # VGG16's fc7: batch 256, 4096 -> 4096
INT8_EXTRA = (                   # (N, C, H, W, F, k, stride, pad, dilate, g)
    (2, 64, 75, 75, 128, 3, 1, 1, 1, 2),
    (2, 64, 75, 75, 64, 3, 2, 1, 1, 1),
    (2, 64, 75, 75, 64, 3, 1, 2, 2, 1))
INT8_RAGGED_FC = ((300, 4096, 1000), (77, 1000, 333))   # (M, K, N)
INT8_RANKS = (     # quantized_conv: (shape, kernel, stride, pad, dilate, F, g)
    ((2, 64, 1000), (5,), (2,), (2,), (2,), 64, 2),
    ((2, 32, 8, 28, 28), (3, 3, 3), (2, 1, 1), (1, 1, 1), (2, 1, 1), 32, 2))
# nms: Proposal's defaults (rpn_pre_nms_top_n 6000, threshold 0.7,
# min_size 16, scales 4-32, ratios 0.5-2, stride 16) on a (1, 24, 38, 50)
# score map of a 600 x 800 image; box_nms over one image's anchors
PROP_SHAPE, PROP_INFO, PROP_PRE_N, PROP_THRESH = (1, 24, 38, 50), \
    (600.0, 800.0, 1.0), 6000, 0.7
IOU_OPS = 14                     # f32 operations of one IoU
NMS_PASS_CAPS = (16 << 20, 1 << 20)   # workspace caps that force passes:
NMS_DEAD = 0.2                   # box_nms, Proposal; a fifth of rows dead
PLAIN_REPS = 3                   # timed runs of a slow plain version
DET_SMALL = dict(classes=3, width=8, side=64, batch=2, objects=4)
DET_F32_TOL, DET_INT8_TOL, DET_TARGET_TOL = 1e-4, 2.0 ** -7, 1e-5


def time_few(fn, reps=PLAIN_REPS):
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def det_layer_shapes(batch):
    """(name, (N, C, H, W), filters) of the SSD's 11 convolutions at
    DET_SIDE, DET_WIDTH and DET_CLASSES."""
    w, s, heads = DET_WIDTH, DET_SIDE, 4 * (DET_CLASSES + 1)
    return [("stage1_conv0", (batch, 3, s, s), w),
            ("stage1_conv1", (batch, w, s, s), w),
            ("stage2_conv0", (batch, w, s // 2, s // 2), 2 * w),
            ("stage2_conv1", (batch, 2 * w, s // 2, s // 2), 2 * w),
            ("stage3_conv0", (batch, 2 * w, s // 4, s // 4), 4 * w),
            ("stage3_conv1", (batch, 4 * w, s // 4, s // 4), 4 * w),
            ("stage3_conv2", (batch, 4 * w, s // 4, s // 4), 4 * w),
            ("cls_head0", (batch, 2 * w, s // 4, s // 4), heads),
            ("loc_head0", (batch, 2 * w, s // 4, s // 4), 16),
            ("cls_head1", (batch, 4 * w, s // 8, s // 8), heads),
            ("loc_head1", (batch, 4 * w, s // 8, s // 8), 16)]


def int8_case(gen, shape, filters, k, stride, pad, dilate, groups):
    x = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (filters, shape[1] // groups, k, k),
                      generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    args = ((stride, stride), (pad, pad), (dilate, dilate), groups)
    return x, w, args


def int8_bound_ms(x, w, out):
    macs = out.numel() * w[0].numel()
    t_ops = 2 * macs / INT8_OPS_PER_S
    t_bytes = (x.numel() + w.numel() + 4 * out.numel()) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_layer_times(gen):
    """Each of the 11 SSD layers at batch 32: int8_conv bit-equal to the
    plain version, timed beside its bound; the plain version timed at
    conv1_2 only.  Returns the rows and conv1_2's plain ms."""
    from mxnet_tpu_torch.ops import quantization as quant

    rows, plain_ms = [], None
    for name, shape, f in det_layer_shapes(DET_BATCH):
        x, w, args = int8_case(gen, shape, f, 3, 1, 1, 1, 1)
        out = kernels.int8_conv(x, w, *args)
        want = quant.int8_conv_plain(x, w, *args)
        check(torch.equal(out, want), "int8_conv %s %s at batch %d: differs "
              "from the plain version in %d of %d" % (
                  name, shape, DET_BATCH, int((out != want).sum()),
                  want.numel()))
        del want
        ms = time_ms(lambda: kernels.int8_conv(x, w, *args))
        run_ms = time_ms(lambda: kernels.int8_conv(x, w, *args), RUN)
        if name == "stage1_conv1":
            plain_ms = time_few(lambda: quant.int8_conv_plain(x, w, *args))
        bms, by = int8_bound_ms(x, w, out)
        rows.append({"layer": name, "shape": list(shape), "filters": f,
                     "ms": ms, "run_ms": run_ms, "bound_ms": bms,
                     "bound_by": by})
        del x, w, out
        torch.cuda.empty_cache()
    return rows, plain_ms


def int8_registered_ranks(gen):
    """quantized_conv's 1-D and 3-D routes through the registry on the
    card: int32 bit-equal to an f64 conv1d / conv3d, one int8_conv launch
    for 1-D and one a kernel depth for 3-D."""
    op = registry.get_op("_contrib_quantized_conv").fn
    one = torch.ones((), device="cuda")
    done = []
    for shape, k, stride, pad, dilate, f, g in INT8_RANKS:
        nd = len(k)
        x = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (f, shape[1] // g) + k, generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.int8)
        before = kernels.launch_counts["int8_conv"]
        got = op(x, w, -one, one, -one, one, kernel=k, stride=stride,
                 pad=pad, dilate=dilate, num_filter=f, num_group=g)[0]
        launched = kernels.launch_counts["int8_conv"] - before
        conv = F.conv1d if nd == 1 else F.conv3d
        want = conv(x.double(), w.double(), None, stride, pad, dilate,
                    g).to(torch.int32)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              "quantized_conv %d-D %s kernel %s: differs from the f64 conv "
              "in %d of %d" % (nd, shape, k, int((got != want).sum()),
                               want.numel()))
        check(launched == (1 if nd == 1 else k[0]),
              "quantized_conv %d-D launched int8_conv %d times" % (nd,
                                                                  launched))
        done.append("%d-D %s kernel %s: %d launch%s" % (
            nd, list(shape), list(k), launched, "" if launched == 1
            else "es"))
    return done


def det_int8_kernel(card):
    """int8_conv against its plain version: bit-equal at the 11 layer
    shapes at batch 2, with groups, stride and dilation, at ragged fully
    connected layers and on quantized_conv's 1-D and 3-D routes; each
    layer at batch 32 bit-equal and timed (the plain version at conv1_2),
    and VGG16's fc7 beside torch._int_mm."""
    from mxnet_tpu_torch.ops import quantization as quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    cases = [(name, shape, f, 3, 1, 1, 1, 1)
             for name, shape, f in det_layer_shapes(2)]
    cases += [("extra %s" % (c,), c[:4], *c[4:]) for c in INT8_EXTRA]
    for name, shape, f, k, s, p, d, g in cases:
        x, w, args = int8_case(gen, shape, f, k, s, p, d, g)
        got = kernels.int8_conv(x, w, *args)
        want = quant.int8_conv_plain(x, w, *args)
        check(got.dtype == torch.int32 and torch.equal(got, want),
              "int8_conv %s %s: differs from the plain version in %d of %d"
              % (name, shape, int((got != want).sum()), want.numel()))
    x, w, args = int8_case(gen, (2, 64, 75, 76), 64, 3, 1, 1, 1, 1)
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device="cuda")
    xv = buf[1:].view(x.shape)   # contiguous, 1 byte past an aligned start
    xv.copy_(x)
    got = kernels.int8_conv(xv, w, *args)
    check(torch.equal(got, quant.int8_conv_plain(x, w, *args)),
          "int8_conv on data at a storage offset of 1 byte: differs from "
          "the plain version")
    del x, w, buf, xv
    fc_args = ((1, 1), (0, 0), (1, 1), 1)
    for m, kdim, n in INT8_RAGGED_FC:
        a = torch.randint(-127, 128, (m, kdim, 1, 1), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.int8)
        b = torch.randint(-127, 128, (n, kdim, 1, 1), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.int8)
        got = kernels.int8_conv(a, b, *fc_args)
        want = quant.int8_conv_plain(a, b, *fc_args)
        check(torch.equal(got, want), "int8_conv ragged fc %d x %d -> %d: "
              "differs in %d of %d" % (m, kdim, n, int((got != want).sum()),
                                       want.numel()))
    ranks = int8_registered_ranks(gen)
    layers, plain_ms = int8_layer_times(gen)
    conv12 = layers[1]
    m, kdim, n = INT8_FC
    a = torch.randint(-127, 128, (m, kdim), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-127, 128, (n, kdim), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)

    def fc():
        return kernels.int8_conv(a.view(m, kdim, 1, 1), b.view(n, kdim, 1, 1),
                                 *fc_args).view(m, n)

    got = fc()
    want = quant.int8_conv_plain(a.view(m, kdim, 1, 1), b.view(n, kdim, 1, 1),
                                 *fc_args).view(m, n)
    lib = torch._int_mm(a, b.t())
    check(torch.equal(got, want) and torch.equal(lib, want),
          "int8_conv fc7 %s: kernel %d, torch._int_mm %d elements off the "
          "plain version" % (INT8_FC, int((got != want).sum()),
                             int((lib != want).sum())))
    fc_ms, fc_run_ms = time_ms(fc), time_ms(fc, RUN)
    fc_plain_ms = time_ms(lambda: quant.int8_conv_plain(
        a.view(m, kdim, 1, 1), b.view(n, kdim, 1, 1), *fc_args))
    fc_lib_ms = time_ms(lambda: torch._int_mm(a, b.t()))
    fc_lib_run_ms = time_ms(lambda: torch._int_mm(a, b.t()), RUN)
    fc_bms, fc_by = int8_bound_ms(a, b, got)
    layer_text = ", ".join("%s %.4f [%.4f] ms (bound %.4f, %s, %.1f%%)" % (
        r["layer"], r["ms"], r["run_ms"], r["bound_ms"], r["bound_by"][0],
        100 * r["bound_ms"] / r["ms"]) for r in layers)
    total = sum(r["ms"] for r in layers)
    total_run = sum(r["run_ms"] for r in layers)
    total_bound = sum(r["bound_ms"] for r in layers)
    print("detection int8_conv: int32 bit-equal to the plain version (f64 "
          "convolution) at the 11 layer shapes at batch 2 and 32 (conv1_1's "
          "3 channels padded to 16), with groups 2, stride 2, dilation 2, "
          "on data at a storage offset of 1 byte, "
          "at the ragged fc layers %s and on quantized_conv's routes (%s) | "
          "conv1_2 (32, 64, 300, 300) -> 64: kernel %.4f ms [runs of %d: "
          "%.4f], plain %.3f ms, bound %.4f ms (%s), kernel at %.1f%% of the "
          "bound | the 11 layers at batch 32 (one call [runs of %d]): %.3f "
          "[%.3f] ms against %.3f ms of bounds (%s) | fc7 %s: kernel %.4f "
          "[%.4f] ms, plain %.4f ms, torch._int_mm %.4f [%.4f] ms, bound %.4f "
          "ms (%s), kernel at %.1f%% | %s"
          % (list(INT8_RAGGED_FC), "; ".join(ranks), conv12["ms"], RUN,
             conv12["run_ms"], plain_ms, conv12["bound_ms"],
             conv12["bound_by"], 100 * conv12["bound_ms"] / conv12["ms"],
             RUN, total, total_run, total_bound, layer_text, INT8_FC, fc_ms,
             fc_run_ms, fc_plain_ms, fc_lib_ms, fc_lib_run_ms, fc_bms, fc_by,
             100 * fc_bms / fc_ms, card), flush=True)
    return {"ms": conv12["ms"], "run_ms": conv12["run_ms"],
            "plain_ms": plain_ms, "bound_ms": conv12["bound_ms"],
            "bound_by": conv12["bound_by"], "library_ms": None,
            "shape": conv12["shape"], "filters": DET_WIDTH, "layers": layers,
            "layers_ms": total, "layers_run_ms": total_run,
            "layers_bound_ms": total_bound, "fc_shape": list(INT8_FC),
            "fc_ms": fc_ms, "fc_run_ms": fc_run_ms,
            "fc_plain_ms": fc_plain_ms, "fc_library_ms": fc_lib_ms,
            "fc_library_run_ms": fc_lib_run_ms, "fc_bound_ms": fc_bms,
            "fc_bound_by": fc_by, "max_abs_err": 0.0}


def split_text(fn, reps=5):
    """Device ms a call of fn() by kernel (device_kernels over ``reps``
    calls after a warm-up), the largest first."""
    fn()
    res = device_kernels(lambda: [fn() for _ in range(reps)], top=4)
    if not isinstance(res, tuple):
        return res
    return ", ".join("%s %.4f" % (name.replace("void ", "").replace(
        "(anonymous namespace)::", ""), ms / reps) for name, ms in res[2])


def det_kernel_split(card):
    """Where a call's device time goes, by kernel (torch.profiler): the
    layout pass against the convolution at conv1_2, stage3_conv1 and fc7
    (and torch._int_mm's kernel at fc7); the mask against the walk at
    box_nms's and Proposal's calls.  Not a phase; run it on its own:
    python3 -c 'import chip_smoke as s; s.det_kernel_split(s.phase_device())'
    """
    from mxnet_tpu_torch.ops import ssd as ssd_ops
    from mxnet_tpu_torch.ops.ssd_ops import _base_anchors

    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    parts = []
    for name, shape, f in det_layer_shapes(DET_BATCH):
        if name in ("stage1_conv1", "stage3_conv1"):
            x, w, args = int8_case(gen, shape, f, 3, 1, 1, 1, 1)
            parts.append("%s: %s" % (name, split_text(
                lambda: kernels.int8_conv(x, w, *args))))
            del x, w
    m, kdim, n = INT8_FC
    a = torch.randint(-127, 128, (m, kdim, 1, 1), generator=gen,
                      device="cuda", dtype=torch.int32).to(torch.int8)
    b = torch.randint(-127, 128, (n, kdim, 1, 1), generator=gen,
                      device="cuda", dtype=torch.int32).to(torch.int8)
    parts.append("fc7: %s" % split_text(
        lambda: kernels.int8_conv(a, b, (1, 1), (0, 0), (1, 1), 1)))
    a2, b2 = a.view(m, kdim), b.view(n, kdim)
    parts.append("fc7 by torch._int_mm (the yardstick): %s" % split_text(
        lambda: torch._int_mm(a2, b2.t())))
    anchors = det_anchors("cuda")
    prob = torch.softmax(torch.randn((1, DET_CLASSES + 1, DET_ANCHORS),
                                     generator=gen, device="cuda") * 2, 1)
    loc = torch.randn((1, DET_ANCHORS * 4), generator=gen,
                      device="cuda") * 0.5
    _, score, boxes = ssd_ops.detection_candidates(
        prob, loc, anchors, True, 0.01, 0, (0.1, 0.1, 0.2, 0.2), True)
    parts.append("box_nms: %s" % split_text(
        lambda: kernels.nms(boxes, score, score > 0, 0.5, False, False,
                            False)))
    cls = torch.rand(PROP_SHAPE, generator=gen, device="cuda")
    deltas = (torch.rand((1, 2 * PROP_SHAPE[1]) + PROP_SHAPE[2:],
                         generator=gen, device="cuda") - 0.5) * 0.2
    top_score, top_boxes = ssd_ops.proposal_candidates(
        cls, deltas, torch.tensor([PROP_INFO], device="cuda"),
        _base_anchors(16, (4.0, 8.0, 16.0, 32.0), (0.5, 1.0, 2.0)), 16,
        PROP_PRE_N, 16.0)
    top_boxes, top_score = top_boxes.contiguous(), top_score.contiguous()
    parts.append("Proposal: %s" % split_text(
        lambda: kernels.nms(top_boxes, top_score,
                            torch.ones_like(top_score, dtype=torch.bool),
                            PROP_THRESH, False, False, True)))
    print("detection split (device ms a call by kernel, torch.profiler): %s "
          "| %s" % (" | ".join(parts), card), flush=True)


def det_anchors(device):
    """The SSD's 27,976 anchors at DET_SIDE, from MultiBoxPrior on its
    two feature maps (build_ssd's sizes and ratios)."""
    feats = [(DET_SIDE // 4, (0.2, 0.35)), (DET_SIDE // 8, (0.5, 0.75))]
    out = [registry.get_op("MultiBoxPrior").fn(
        torch.zeros((1, 1, s, s), device=device), sizes=sz,
        ratios=(1.0, 2.0, 0.5)) for s, sz in feats]
    return torch.cat(out, dim=1)


def nms_bound_ms(boxes, ids, keep, class_aware):
    """The least work of these inputs' greedy pass: every kept box read
    (16 B), its id (4 B) and mask in and out (2 B), and an IoU (IOU_OPS
    f32 operations) for each later kept box of its class and for each
    suppressed box, at the f32 rate."""
    k = keep.cpu().numpy()
    n_boxes = keep.numel()
    evals = 0
    idn = ids.cpu().numpy()
    for b in range(k.shape[0]):
        kept = np.nonzero(k[b])[0]
        if class_aware:
            for c in np.unique(idn[b, kept]):
                n = int((idn[b, kept] == c).sum())
                evals += n * (n - 1) // 2
        else:
            evals += len(kept) * (len(kept) - 1) // 2
    evals += int((~keep).sum())
    t_bytes = 22 * n_boxes / HBM_BYTES_PER_S
    t_ops = IOU_OPS * evals / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), evals


@contextlib.contextmanager
def nms_cap(cap):
    """kernels.NMS_WORKSPACE_BYTES set to ``cap`` inside the block."""
    old = kernels.NMS_WORKSPACE_BYTES
    kernels.NMS_WORKSPACE_BYTES = cap
    try:
        yield
    finally:
        kernels.NMS_WORKSPACE_BYTES = old


def det_nms_case(label, boxes, ids, alive, thresh, class_aware, inclusive,
                 plus_one, card):
    from mxnet_tpu_torch.ops import ssd as ssd_ops

    boxes, ids = boxes.contiguous(), ids.contiguous()
    alive = alive.contiguous()
    got = kernels.nms(boxes, ids, alive, thresh, class_aware, inclusive,
                      plus_one)
    want = ssd_ops.nms_plain(boxes, ids, alive, thresh, class_aware,
                             inclusive, plus_one)
    check(torch.equal(got, want), "nms %s: keep masks differ in %d of %d"
          % (label, int((got != want).sum()), want.numel()))
    def call():
        return kernels.nms(boxes, ids, alive, thresh, class_aware, inclusive,
                           plus_one)

    ms, run_ms = time_ms(call), time_ms(call, RUN)
    plain_ms = time_few(lambda: ssd_ops.nms_plain(
        boxes, ids, alive, thresh, class_aware, inclusive, plus_one), 1)
    bms, by, evals = nms_bound_ms(boxes, ids, got, class_aware)
    print("detection nms %s: %s boxes, %d alive, %d kept, keep mask equal to "
          "the plain version | kernel %.4f ms [runs of %d: %.4f], plain %.1f "
          "ms, bound %.5f ms (%s; %d IoUs), kernel at %.2f%% of the bound | %s"
          % (label, list(alive.shape), int(alive.sum()), int(got.sum()), ms,
             RUN, run_ms, plain_ms, bms, by, evals, 100 * bms / ms, card),
          flush=True)
    return {"label": label, "shape": list(alive.shape), "ms": ms,
            "run_ms": run_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "kept": int(got.sum())}


def det_nms_kernel(card):
    """nms against its plain version at MultiBoxDetection's call (32
    images of 27,976 candidates, nms_topk 100), box_nms over one image's
    27,976 boxes, Proposal's pre_n 6000 and a tie at the threshold; then
    box_nms's and Proposal's boxes with a fifth of the rows dead, in
    passes over row ranges under NMS_PASS_CAPS."""
    from mxnet_tpu_torch.ops import ssd as ssd_ops
    from mxnet_tpu_torch.ops.ssd_ops import _base_anchors

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    anchors = det_anchors("cuda")
    logits = torch.randn((DET_BATCH, DET_CLASSES + 1, DET_ANCHORS),
                         generator=gen, device="cuda") * 2
    cls_prob = torch.softmax(logits, dim=1)
    loc = torch.randn((DET_BATCH, DET_ANCHORS * 4), generator=gen,
                      device="cuda") * 0.5
    oid, score, boxes = ssd_ops.detection_candidates(
        cls_prob, loc, anchors, True, 0.01, 0, (0.1, 0.1, 0.2, 0.2), True)
    alive = (oid >= 0) & (torch.arange(DET_ANCHORS, device="cuda")
                          < DET_TOPK)[None]
    rows = [det_nms_case("MultiBoxDetection (nms_topk 100, >=, per class)",
                         boxes[:, :DET_TOPK], oid[:, :DET_TOPK],
                         alive[:, :DET_TOPK], DET_NMS_THRESH, True, True,
                         False, card)]
    rows.append(det_nms_case(
        "box_nms (one image, all anchors, >, any class)", boxes[:1],
        score[:1], score[:1] > 0, 0.5, False, False, False, card))
    cls = torch.rand(PROP_SHAPE, generator=gen, device="cuda")
    A = PROP_SHAPE[1] // 2
    deltas = (torch.rand((1, 4 * A) + PROP_SHAPE[2:], generator=gen,
                         device="cuda") - 0.5) * 0.2
    info = torch.tensor([PROP_INFO], device="cuda")
    base = _base_anchors(16, (4.0, 8.0, 16.0, 32.0), (0.5, 1.0, 2.0))
    top_score, top_boxes = ssd_ops.proposal_candidates(
        cls, deltas, info, base, 16, PROP_PRE_N, 16.0)
    rows.append(det_nms_case(
        "Proposal (pre_n 6000, >, +1 pixel IoU)", top_boxes, top_score,
        torch.ones_like(top_score, dtype=torch.bool), PROP_THRESH, False,
        False, True, card))
    passes = []
    for (label, bx, sc, thresh, plus_one), cap in zip(
            (("box_nms", boxes[:1], score[:1], 0.5, False),
             ("Proposal", top_boxes.contiguous(), top_score.contiguous(),
              PROP_THRESH, True)),
            NMS_PASS_CAPS):
        dead = torch.rand(sc.shape, generator=gen, device="cuda") < NMS_DEAD
        live = (sc > 0) & ~dead
        n = sc.shape[1]
        whole = kernels.nms(bx, sc, live, thresh, False, False, plus_one)
        with nms_cap(cap):
            per_pass = kernels.nms_rows_per_pass(sc.shape[0], n)
            check(per_pass < n, "nms %s: a cap of %d bytes leaves one pass"
                  % (label, cap))
            got = kernels.nms(bx, sc, live, thresh, False, False, plus_one)
            ms = time_ms(lambda: kernels.nms(bx, sc, live, thresh, False,
                                             False, plus_one))
        want = ssd_ops.nms_plain(bx, sc, live, thresh, False, False,
                                 plus_one)
        check(torch.equal(got, want) and torch.equal(whole, want),
              "nms %s in passes of %d rows: keep masks differ in %d (one "
              "pass: %d) of %d" % (label, per_pass,
                                   int((got != want).sum()),
                                   int((whole != want).sum()), n))
        passes.append("%s %d boxes, %d alive, %d kept: %d passes of %d rows "
                      "(cap %d MiB) %.4f ms" % (label, n, int(live.sum()),
                                                int(want.sum()),
                                                -(-n // per_pass),
                                                per_pass, cap >> 20, ms))
    print("detection nms passes: keep masks equal to the plain version and "
          "to one pass | %s | %s" % ("; ".join(passes), card), flush=True)
    pair = torch.tensor([[[0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.5, 0.5],
                          [0.3, 0.3, 0.7, 0.7], [0.3, 0.3, 0.7, 0.7]]],
                        device="cuda")
    ones = torch.ones((1, 4), device="cuda")
    keep = kernels.nms(pair, ones, ones > 0, 1.0, True, True, False)
    check(keep.tolist() == [[True, False, True, False]],
          "nms at the threshold: identical boxes at 1.0 (>=) kept %s"
          % keep.tolist())
    keep = kernels.nms(pair, ones, ones > 0, 1.0, True, False, False)
    check(keep.all(), "nms at the threshold: > 1.0 suppressed %s"
          % keep.tolist())
    print("detection nms tie: identical boxes at threshold 1.0 suppress "
          "under >= and not under > | %s" % card, flush=True)
    return rows


def det_train(card):
    """The example at DET_ARGS: returns its result and the training
    line's numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.examples import ssd_detect_quant as ex

    args = ex.parse_args(DET_ARGS)
    last = args.train_steps - 1
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def step_hook(i):   # after step i's synchronize: profile the last one
        if i == last - 1:
            prof.start()
        elif i == last:
            prof.stop()

    mx.random.seed(0)
    torch.manual_seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = ex.run(args, ctx=mx.gpu(0), step_hook=step_hook)
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows = [(ev.count, _self_device_us(ev)) for ev in prof.key_averages()
            if getattr(ev, "device_type", None) == DeviceType.CUDA]
    card_ms = sum(us for _, us in rows) / 1e3
    step_ms = 1e3 * res["step_s"][last]
    prof_text = ("step %d under torch.profiler: %d kernels, %.1f ms on the "
                 "card of %.1f ms: idle %.1f%%"
                 % (last, sum(c for c, us in rows if us), card_ms, step_ms,
                    100 * max(0.0, 1 - card_ms / step_ms))) if card_ms \
        else "profile not measured (torch.profiler recorded no device time)"
    return res, peak, prof_text


def det_forward_launches(ex_):
    """kernels launched by one more forward of executor ``ex_``."""
    before = dict(kernels.launch_counts)
    ex_.forward()
    torch.cuda.synchronize()
    return {n: c - before[n] for n, c in kernels.launch_counts.items()
            if c - before[n]}


def det_main(card):
    """The main path (the example), its launches, times and checks."""
    kernels.reset_launch_counts()
    res, peak, prof_text = det_train(card)
    launches = dict(kernels.launch_counts)
    loss, cmax = res["loc_loss"], res["cls_prob_max"]
    check(np.isfinite(loss).all() and np.isfinite(cmax).all(),
          "detection training: non-finite losses %s / %s" % (loss, cmax))
    check(len(loss) == 30, "detection training: %d steps" % len(loss))
    check(res["n_q"] == 11, "quantize_model: %d int8 layers, not 11"
          % res["n_q"])
    for key in ("det_fp32", "det_int8"):
        det = res[key]
        check(det.shape == (DET_BATCH, DET_ANCHORS, 6)
              and np.isfinite(det).all(), "%s: shape %s, finite %s"
              % (key, det.shape, np.isfinite(det).all()))
    fp32_l = det_forward_launches(res["dex"])
    int8_l = det_forward_launches(res["qex"])
    check(fp32_l == {"nms": 1}, "fp32 detection forward launched %s" % fp32_l)
    check(int8_l == {"int8_conv": 11, "nms": 1},
          "int8 detection forward launched %s" % int8_l)
    check(launches["int8_conv"] == 22 and launches["nms"] == 4,
          "the example launched %s (2 fp32 and 2 int8 forwards)" % launches)
    dex, qex = res["dex"], res["qex"]
    fp32_ms = time_ms(lambda: dex.forward())
    int8_ms = time_ms(lambda: qex.forward())
    med = statistics.median(res["step_s"][1:])
    wait = statistics.median(res["wait_s"][1:])
    n_valid = [int((res[k][:, :, 0] >= 0).sum()) for k in ("det_fp32",
                                                          "det_int8")]
    print("detection train: ssd_detect_quant %s | build_ssd width %d, %d "
          "classes, %dx%d, batch %d, %d anchors, ImageDetIter over the "
          "example's synthetic-JPEG .rec of %d images | compile %.1f s | step "
          "median %.2f ms (steps 1-29), %.1f img/s | next() median %.2f ms a "
          "step | %s | peak %.2f GB | loc_loss %s | mean max class prob %s "
          "| %s" % (" ".join(DET_ARGS), DET_WIDTH, DET_CLASSES, DET_SIDE,
                    DET_SIDE, DET_BATCH, DET_ANCHORS, 4 * DET_BATCH,
                    res["train_compile_s"], 1e3 * med, DET_BATCH / med,
                    1e3 * wait, prof_text, peak,
                    ["%.4f" % v for v in loss[::6]],
                    ["%.3f" % v for v in cmax[::6]], card), flush=True)
    print("detection forward: fp32 MultiBoxDetection compile %.1f s, %.3f ms "
          "(median of %d), launches %s | int8 (quantize_model, %d int8 "
          "layers) compile %.1f s, %.3f ms, launches %s | valid detections "
          "fp32 %d, int8 %d | top-1 of image 0: same class %s, box err %s | "
          "%s" % (res["fp32_first_s"], fp32_ms, REPS, fp32_l, res["n_q"],
                  res["int8_first_s"], int8_ms, int8_l, n_valid[0],
                  n_valid[1], res["same_cls"], res["box_err"], card),
          flush=True)
    return launches


def det_small_values(sym, shapes):
    """Seeded weights for ``sym`` at ``shapes`` (He-scaled convolutions,
    small biases)."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(8)
    vals = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("weight"):
            v = rng.randn(*shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        else:
            v = rng.randn(*shape) * 0.1
        vals[name] = v.astype(np.float32)
    return vals


def det_small_labels(rng, batch, objects, classes):
    lab = np.full((batch, objects, 5), -1, np.float32)
    for b in range(batch):
        for m in range(objects - b):     # a padding row from image 1 on
            xy = rng.uniform(0, 0.6, 2)
            wh = rng.uniform(0.1, 0.4, 2)
            lab[b, m] = [rng.randint(classes), *xy, *(xy + wh)]
    return lab


def det_scores_close(got, ref, tol, what):
    """Detections (B, N, 6) card against CPU, end to end: the sorted
    score column within ``tol`` row for row (two detections whose scores
    lie within the bound may trade places, so ids and boxes are compared
    on the same inputs instead, by det_small).  Returns (the worst score
    error, rows whose id and box agree too)."""
    s_err = float(np.abs(got[:, :, 1] - ref[:, :, 1]).max())
    check(s_err <= tol, "%s: scores differ by %g (bound %g)"
          % (what, s_err, tol))
    same = (got[:, :, 0] == ref[:, :, 0]) & \
        (np.abs(got[:, :, 2:] - ref[:, :, 2:]) <= tol).all(axis=2)
    return s_err, int(same.sum())


def det_op_both(op, ins, **attrs):
    """Registry op ``op`` through mx.nd.contrib on the card and on the CPU
    with the same numpy inputs: {device: [numpy outputs]}."""
    out = {}
    for dev, ctx in (("gpu", mx.gpu(0)), ("cpu", mx.cpu())):
        res = getattr(mx.nd.contrib, op)(
            *[mx.nd.array(v, ctx=ctx) for v in ins], **attrs)
        out[dev] = [o.asnumpy() for o in
                    (res if isinstance(res, (list, tuple)) else [res])]
    return out


def det_small(card):
    """The small case on the card against the port on the CPU, both
    through the aot_eager backend: the SSD's heads (1e-4 + 1e-4 |ref|),
    the fp32 and int8 detections end to end (det_scores_close), and
    MultiBoxTarget and MultiBoxDetection on the same inputs (the CPU's
    heads) on both devices: class targets, masks and ids exact, loc
    targets within 1e-5, scores and boxes within 1e-4."""
    from mxnet_tpu_torch.contrib import quantization as qmod
    from mxnet_tpu_torch.examples import ssd_detect_quant as ex

    c = DET_SMALL
    rng = np.random.RandomState(9)
    data = rng.rand(c["batch"], 3, c["side"], c["side"]).astype(np.float32)
    label = det_small_labels(rng, c["batch"], c["objects"], c["classes"])
    anchors, cls_preds, loc_preds = ex.build_ssd(c["classes"],
                                                 width=c["width"])
    heads = mx.sym.Group([anchors, cls_preds, loc_preds])
    dsym = ex.detection_symbol(c["classes"], width=c["width"])
    vals = det_small_values(dsym, {"data": data.shape})
    outs = {}
    prev_backend = mx.jit._BACKEND
    # both devices on aot_eager (the CPU has no inductor codegen here):
    # the port's ops card against CPU, the graphs captured alike; the
    # example above runs these graphs through inductor on the card
    mx.jit._BACKEND = "aot_eager"
    try:
        for dev in ("gpu", "cpu"):
            ctx = mx.gpu(0) if dev == "gpu" else mx.cpu()
            args = {k: mx.nd.array(v, ctx=ctx) for k, v in vals.items()}
            feed = dict(args, data=mx.nd.array(data, ctx=ctx))
            with ctx:
                # one graph (one compile) each: the heads with the fp32
                # detections, the int8 codes with the int8 detections
                both = mx.sym.Group(list(heads) + [dsym])
                fv = [o.asnumpy() for o in both.bind(ctx=ctx, args={
                    k: feed[k] for k in both.list_arguments()}).forward()]
                qsym, qargs, _ = qmod.quantize_model(dsym, args, {},
                                                     calib_mode="none")
                qfeed = dict(qargs, data=feed["data"])
                internals = qsym.get_internals()
                names = [n for n in internals.list_outputs()
                         if n.endswith("_data_quantize_output0")]
                qboth = mx.sym.Group([internals[n] for n in names] + [qsym])
                qv = [o.asnumpy() for o in qboth.bind(ctx=ctx, args={
                    k: qfeed[k] for k in qboth.list_arguments()}).forward()]
                outs[dev] = {"heads": fv[:3], "det": fv[3], "qdet": qv[-1],
                             "codes": qv[:-1]}
    finally:
        mx.jit._BACKEND = prev_backend
    g, r = outs["gpu"], outs["cpu"]
    h_err = max(close(gh, rh, DET_F32_TOL, DET_F32_TOL)
                for gh, rh in zip(g["heads"], r["heads"]))
    check(h_err <= 1.0, "SSD heads card vs CPU: %g of 1e-4 + 1e-4|ref|"
          % h_err)
    a, cp, loc = r["heads"]
    t = det_op_both("MultiBoxTarget", (a, label, cp), overlap_threshold=0.5,
                    negative_mining_ratio=3.0, negative_mining_thresh=0.5)
    loc_err = float(np.abs(t["gpu"][0] - t["cpu"][0]).max())
    check(np.array_equal(t["gpu"][2], t["cpu"][2])
          and np.array_equal(t["gpu"][1], t["cpu"][1])
          and loc_err <= DET_TARGET_TOL,
          "MultiBoxTarget card vs CPU: class targets equal %s, loc %g"
          % (np.array_equal(t["gpu"][2], t["cpu"][2]), loc_err))
    e = np.exp(cp - cp.max(axis=1, keepdims=True))
    prob = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    d = det_op_both("MultiBoxDetection", (prob, loc, a), nms_threshold=0.45,
                    nms_topk=100)
    dg, dc = d["gpu"][0], d["cpu"][0]
    d_err = float(np.abs(dg[:, :, 1:] - dc[:, :, 1:]).max())
    check(np.array_equal(dg[:, :, 0], dc[:, :, 0]) and d_err <= DET_F32_TOL,
          "MultiBoxDetection card vs CPU on the same inputs: ids equal %s, "
          "scores and boxes %g" % (np.array_equal(dg[:, :, 0], dc[:, :, 0]),
                                   d_err))
    f32 = det_scores_close(g["det"], r["det"], DET_F32_TOL,
                           "fp32 detections card vs CPU")
    i8 = det_scores_close(g["qdet"], r["qdet"], DET_INT8_TOL,
                          "int8 detections card vs CPU")
    n_codes = sum(o.size for o in r["codes"])
    differ = sum(int((gc != rc).sum()) for gc, rc in zip(g["codes"],
                                                         r["codes"]))
    rows = dc.shape[0] * dc.shape[1]
    print("detection small: width %d, image %d, batch %d, %d classes, %d "
          "objects an image (a padding row from image 1), card against the "
          "port on the CPU | heads %.3g of 1e-4 + 1e-4|ref| | on the same "
          "inputs: MultiBoxTarget class targets and masks equal, loc "
          "targets within %.3g (bound %g), %d positives; MultiBoxDetection "
          "ids equal, scores and boxes within %.3g (bound %g), %d valid | "
          "end to end: fp32 scores within %.3g (bound %g), id and box equal "
          "at %d of %d rows; int8 scores within %.3g (bound 2^-7, one int8 "
          "step of a value in [0, 1]), id and box equal at %d of %d rows | "
          "int8 activation codes (the %d quantize_v2 nodes): %d of %d "
          "differ | %s"
          % (c["width"], c["side"], c["batch"], c["classes"], c["objects"],
             h_err, loc_err, DET_TARGET_TOL, int((t["cpu"][2] > 0).sum()),
             d_err, DET_F32_TOL, int((dc[:, :, 0] >= 0).sum()), f32[0],
             DET_F32_TOL, f32[1], rows, i8[0], i8[1], rows, len(names),
             differ, n_codes, card), flush=True)


def det_calibrate(card):
    from mxnet_tpu_torch.examples import quantize_calibrate as qc

    for mode in ("naive", "entropy"):
        t0 = time.perf_counter()
        rc = qc.main(["--calib-mode", mode], ctx=mx.gpu(0))
        check(rc == 0, "quantize_calibrate --calib-mode %s: exit %d (its "
              "gate: fp32 > 0.9, drop <= 0.02, >= 3 int8 layers)" % (mode, rc))
        print("detection calibrate: quantize_calibrate --calib-mode %s "
              "passed its gate in %.1f s | %s"
              % (mode, time.perf_counter() - t0, card), flush=True)


def phase_detection(card, after_timed=None):
    """Phase 16 (see the module doc): returns the two kernels' rows.
    ``after_timed()`` runs once the phase's timed work is done, before
    its small case and calibration."""
    t_phase = time.perf_counter()
    laps = []

    def lap(name):
        laps.append("%s %.1f" % (name, time.perf_counter() - t_phase
                                 - sum(float(x.split()[-1]) for x in laps)))

    launches = det_main(card)
    lap("example")
    torch.cuda.empty_cache()
    int8_row = det_int8_kernel(card)
    lap("int8_conv")
    torch.cuda.empty_cache()
    nms_rows = det_nms_kernel(card)
    lap("nms")
    torch.cuda.empty_cache()
    if after_timed:
        after_timed()
    det_small(card)
    lap("small case")
    det_calibrate(card)
    lap("calibrate")
    print("detection: phase %.1f s (%s s) | %s"
          % (time.perf_counter() - t_phase, ", ".join(laps), card),
          flush=True)
    first = nms_rows[0]
    return [dict(int8_row, **{
        "name": "int8_conv", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/int8_conv.cu",
        "replaces": "mxnet_tpu/contrib/quantization.py:352",
        "launches": launches["int8_conv"], "card": card}),
        {"name": "nms", "route": "cuda",
         "source": "mxnet_tpu_torch/kernels/nms.cu",
         "replaces": "mxnet_tpu/ops/ssd_jax.py:226",
         "launches": launches["nms"], "max_abs_err": 0.0,
         "ms": first["ms"], "run_ms": first["run_ms"],
         "plain_ms": first["plain_ms"],
         "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
         "library_ms": None, "shape": first["shape"],
         "times": nms_rows[1:], "card": card}]


def dist_sha(tensors):
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def dist_timed_store():
    """KVStoreDist's push and pull with each call's host seconds recorded,
    the card synchronized first (so a push's time leaves out the backward
    still running on the card)."""
    times = {"push": [], "pull": []}
    for name, out in times.items():
        orig = getattr(mx.kv.KVStoreDist, name)

        def timed(self, *a, _orig=orig, _out=out, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _orig(self, *a, **k)
            _out.append(time.perf_counter() - t0)
            return res
        setattr(mx.kv.KVStoreDist, name, timed)
    return times


def dist_leg_a(rank, out_dir):
    """Leg A in a worker: train_imagenet's entry with --kv-store
    dist_device_sync, then one profiled step."""
    from mxnet_tpu_torch.examples import train_imagenet

    times = dist_timed_store()
    mx.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    res = train_imagenet.train(
        ["--kv-store", "dist_device_sync", "--benchmark", "1", "--network",
         "resnet50_v1", "--batch-size", str(BATCH), "--steps",
         str(DIST_STEPS), "--lr", str(DIST_LR), "--image-shape",
         "3,%d,%d" % (IMAGE, IMAGE)], ctx=mx.gpu(0), hybridize=False)
    net, trainer = res["net"], res["trainer"]
    kv = trainer._kvstore
    check(isinstance(kv, mx.kv.KVStoreDist) and kv.type == "dist_device_sync"
          and trainer._update_on_kvstore and kv.num_workers == DIST_WORKERS,
          "leg A: the trainer's store is %r (update_on_kvstore %s)"
          % (kv, trainer._update_on_kvstore))
    params = list(net.collect_params().values())
    trainable = [p for p in params if p.grad_req != "null"]
    check(len(trainable) == 193, "leg A: %d trainable parameters"
          % len(trainable))
    check(all(p.data()._data.is_cuda and p.grad()._data.is_cuda
              for p in trainable), "leg A: parameters or gradients are not "
          "on the card")
    # one push a step; one pull at the first step's init and one a step
    check(len(times["push"]) == 1 + DIST_STEPS
          and len(times["pull"]) == 2 + DIST_STEPS,
          "leg A: %d pushes and %d pulls" % (len(times["push"]),
                                             len(times["pull"])))
    losses = [float(v) for v in res["losses"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "leg A: losses %s" % losses)
    # one more step with the server's profiler on, under torch.profiler
    prof_path = os.path.join(out_dir, "server_profile.json")
    if rank == 0:
        kv.send_command_to_servers("profiler_set_config", prof_path)
        kv.send_command_to_servers("profiler_state", "1")
    kv.barrier()
    rng = np.random.RandomState(0)      # train()'s synthetic batch
    x = mx.nd.array(rng.rand(BATCH, 3, IMAGE, IMAGE).astype(np.float32),
                    ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(BATCH)

    prof_s, prof = timed_s(lambda: device_kernels(step))
    kv.barrier()
    server = None
    if rank == 0:
        kv.send_command_to_servers("profiler_dump", "")
        with open(prof_path) as f:
            server = json.load(f)
    out = {"losses": losses, "step_s": res["step_s"],
           "ips": res["images_per_sec"],
           "push_s": times["push"][1:1 + DIST_STEPS],
           "pull_s": times["pull"][2:2 + DIST_STEPS],
           "push_bytes": sum(p.data()._data.numel() * 4 for p in trainable),
           "kernels": prof[:2] if isinstance(prof, tuple) else prof,
           "profiled_step_s": prof_s, "server": server,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "sha": dist_sha([p.data()._data for p in trainable]),
           "aux_sha": dist_sha([p.data()._data for p in params
                                if p.grad_req == "null"])}
    kv.close()
    return out


def dist_leg_b(rank, out_dir):
    """Leg B in a worker: 2-bit compression on each push, the sum pulled
    back into the gradients, the updates local."""
    captured = {}
    orig = comp.GradientCompression.compress_dequantize_batch

    def capture(self, keys, grads_nd):
        first = not captured
        if first:
            captured["grads"] = [g._data.detach().reshape(-1).clone()
                                 for g in grads_nd]
        res = orig(self, keys, grads_nd)
        if first:
            captured["deq"] = [o._data.reshape(-1).clone() for o in res]
            captured["arena"] = self._arena[2].clone()
        return res
    comp.GradientCompression.compress_dequantize_batch = capture
    # the fleet observatory: this worker reports its loop's steps (no
    # producer sits in a gluon Trainer loop, in either package) and
    # publishes to the spool the parent reads
    telemetry.enable()
    pub = fleet.FleetPublisher(os.path.join(out_dir, "spool"), rank=rank,
                               n_procs=DIST_WORKERS, loop="gluon")
    pub.attach(timeout=120)
    mx.random.seed(0)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rng = np.random.RandomState(1 + rank)     # a batch of its own
    x = mx.nd.array(rng.rand(BATCH, 3, IMAGE, IMAGE).astype(np.float32),
                    ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, BATCH).astype(np.float32),
                    ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.predict_mode():
        net(x)                                  # shapes
    trainer = mx.gluon.Trainer(
        net.collect_params(), "sgd",
        {"learning_rate": DIST_B_LR, "momentum": 0.9},
        kvstore="dist_device_sync",
        compression_params={"type": "2bit", "threshold": T},
        update_on_kvstore=False)
    trainable = [p for p in net.collect_params().values()
                 if p.grad_req != "null"]
    losses, step_s, agg_sha, nonzero = [], [], [], []
    kernels.reset_launch_counts()
    for _ in range(1 + DIST_B_STEPS):
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(BATCH)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        telemetry.TRAIN_STEP_SECONDS.observe(step_s[-1], loop="gluon")
        telemetry.TRAIN_STEPS.inc(loop="gluon")
        losses.append(float(loss.mean().asscalar()))
        flat = torch.cat([p.grad()._data.reshape(-1) for p in trainable])
        mag = flat.abs()
        check(bool(((mag == 0) | (mag == T) | (mag == 2 * T)).all()),
              "leg B: a pulled sum lies outside {-2t, -t, 0, t, 2t}")
        nonzero.append(float((mag > 0).float().mean()))
        agg_sha.append(dist_sha([flat]))
    launches = dict(kernels.launch_counts)
    kv = trainer._kvstore
    check(isinstance(kv, mx.kv.KVStoreDist) and not trainer._update_on_kvstore,
          "leg B: the trainer's store is %r" % (kv,))
    check(launches["quantize_2bit"] == launches["dequantize_2bit"]
          == 1 + DIST_B_STEPS, "leg B: launches %s over %d pushes"
          % (launches, 1 + DIST_B_STEPS))
    check(all(p.data()._data.is_cuda and p.grad()._data.is_cuda
              for p in trainable), "leg B: state is not on the card")
    worst = None
    if rank == 0:
        # the first push's compression of the 193 keys against the batched
        # plain version on the same gradients, from zero residuals
        grads = captured["grads"]
        check(len(grads) == 193, "leg B: %d keys a push" % len(grads))
        dev = grads[0].device
        layout = comp.batch_layout(tuple(g.numel() for g in grads))
        ref_arena = torch.zeros(layout.n_values, device=dev)
        rcodes = torch.empty(layout.n_code_words, dtype=torch.int32,
                             device=dev)
        comp.quantize_batch_ref(layout, grads, ref_arena, ref_arena, rcodes,
                                T)
        rdeq = torch.empty(layout.n_values, device=dev)
        comp.dequantize_batch_ref(layout, rcodes, rdeq, T)
        check(same_bits(captured["arena"], ref_arena),
              "leg B: step-1 residuals differ from the plain version")
        worst = float((captured["arena"] - ref_arena).abs().max())
        for e, got in enumerate(captured["deq"]):
            want = layout.values(rdeq, e)
            check(same_bits(got, want), "leg B: step-1 dequantized values "
                  "of key %d differ from the plain version" % e)
            worst = max(worst, float((got - want).abs().max()))
    check(pub.publish_once() is not None, "leg B: fleet publish failed")
    out = {"losses": losses, "step_s": step_s, "agg_sha": agg_sha,
           "nonzero": nonzero, "launches": launches, "worst": worst,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "train_steps": telemetry.TRAIN_STEPS.value(loop="gluon"),
           "step_count": telemetry.TRAIN_STEP_SECONDS.count(loop="gluon")}
    kv.close()
    return out


def dist_small(rank, out_dir, ctx, tag):
    """The small case in a worker: an MLP through a dist_device_sync
    Trainer on ``ctx``; its parameters saved to out_dir under ``tag``."""
    rng = np.random.RandomState(0)
    w = [rng.randn(64, 192) * 0.1, rng.randn(64) * 0.1,
         rng.randn(10, 64) * 0.1, rng.randn(10) * 0.1]
    net = mx.gluon.nn.Sequential()
    net.add(mx.gluon.nn.Dense(64, activation="relu", in_units=192),
            mx.gluon.nn.Dense(10, in_units=64))
    net.initialize(ctx=ctx)
    params = list(net.collect_params().values())
    for p, v in zip(params, w):
        p.set_data(mx.nd.array(v.astype(np.float32), ctx=ctx))
    data = np.random.RandomState(10 + rank)
    x = mx.nd.array(data.randn(8, 192).astype(np.float32), ctx=ctx)
    y = mx.nd.array(data.randint(0, 10, 8).astype(np.float32), ctx=ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore="dist_device_sync")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(8)
    np.savez(os.path.join(out_dir, "small_%s_%d.npz" % (tag, rank)),
             *[p.data().asnumpy() for p in params])
    out = {"sha": dist_sha([p.data()._data for p in params]),
           "on_card": all(p.data()._data.is_cuda for p in params)}
    trainer._kvstore.close()
    return out


def dist_worker(mode, out_dir):
    """Entry of a worker process (``chip_smoke.py --dist-worker MODE DIR``
    under the launcher): waits, once imported, for the file DIST_WAIT_FOR
    names where it is set (exiting if the launching script has gone),
    then runs its leg and prints one DIST_WORKER line."""
    start_s = time.time() - float(os.environ["DIST_LAUNCH_TIME"])
    go = os.environ.get("DIST_WAIT_FOR")
    parent = int(os.environ["DIST_PARENT_PID"])
    while go and not os.path.exists(go):
        try:        # the script that launched it is gone: give up
            os.kill(parent, 0)
        except ProcessLookupError:
            sys.exit(3)
        time.sleep(0.1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["DMLC_WORKER_RANK"])
    t0 = time.perf_counter()
    if mode == "a":
        out = dist_leg_a(rank, out_dir)
    elif mode == "b":
        out = dist_leg_b(rank, out_dir)
    elif mode == "small":
        out = dist_small(rank, out_dir, mx.gpu(0), "gpu")
    else:
        out = dist_small(rank, out_dir, mx.cpu(), "cpu")
    out.update(rank=rank, start_s=start_s, leg_s=time.perf_counter() - t0)
    print("DIST_WORKER " + json.dumps(out), flush=True)


def dist_launch(mode, out_dir, cpu=False, wait_for=None):
    """The port's launcher over DIST_WORKERS copies of this script in
    worker ``mode``, in a process group of its own; its workers start
    their leg once the file ``wait_for`` exists."""
    env = dict(os.environ, DIST_LAUNCH_TIME=repr(time.time()),
               DIST_PARENT_PID=str(os.getpid()))
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    if wait_for:
        env["DIST_WAIT_FOR"] = wait_for
    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
         str(DIST_WORKERS), "--launcher", "local", sys.executable,
         DIST_WORKER_SCRIPT, "--dist-worker", mode, out_dir],
        cwd=DIST_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def dist_results(proc, mode, deadline):
    """Each worker's DIST_WORKER line, by rank; fails if the launcher did
    not exit 0 before ``deadline``."""
    try:
        out, err = proc.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        check(False, "dist %s: the launcher did not finish in time" % mode)
    check(proc.returncode == 0, "dist %s: the launcher exited %d:\n%s"
          % (mode, proc.returncode, err[-6000:]))
    res = {}
    # each DIST_WORKER line is one write of under PIPE_BUF bytes, but a
    # library's own output to stdout may share its line
    for chunk in out.split("DIST_WORKER ")[1:]:
        r, _end = json.JSONDecoder().raw_decode(chunk)
        res[r["rank"]] = r
    check(sorted(res) == list(range(DIST_WORKERS)),
          "dist %s: results from ranks %s" % (mode, sorted(res)))
    return [res[r] for r in range(DIST_WORKERS)]


def dist_small_check(out_dir, small, small_cpu):
    """The small case: each context's workers bit-equal, the card's
    parameters within DIST_SMALL_REL x max|ref| of the CPU's, and moved
    from their start by more than that."""
    check(len({r["sha"] for r in small}) == 1
          and len({r["sha"] for r in small_cpu}) == 1,
          "dist small: the workers of one context differ")
    check(all(r["on_card"] for r in small) and
          not any(r["on_card"] for r in small_cpu),
          "dist small: parameters not where they were asked for")
    card = np.load(os.path.join(out_dir, "small_gpu_0.npz"))
    ref = np.load(os.path.join(out_dir, "small_cpu_0.npz"))
    rng = np.random.RandomState(0)
    start = [rng.randn(64, 192) * 0.1, rng.randn(64) * 0.1,
             rng.randn(10, 64) * 0.1, rng.randn(10) * 0.1]
    worst = 0.0
    for i, w0 in enumerate(start):
        a, b = card["arr_%d" % i], ref["arr_%d" % i]
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max()) / scale
        moved = float(np.abs(b - w0.astype(np.float32)).max()) / scale
        check(err <= DIST_SMALL_REL < moved, "dist small: parameter %d card "
              "vs CPU %g of max|ref|, moved %g" % (i, err, moved))
        worst = max(worst, err)
    return worst


def dist_idle(a):
    """Each worker's kernel ms over one profiled step against its step
    median, and the card's idle share with both workers' kernels."""
    med = [1e3 * statistics.median(r["step_s"]) for r in a]
    ks = [r["kernels"] for r in a]
    if not all(isinstance(k, list) for k in ks):
        return "not measured (%s)" % ks
    return ("kernels a step %s ms (%s kernels) against step medians %s ms; "
            "card idle %.1f%% with both workers' kernels"
            % (["%.2f" % k[1] for k in ks], [k[0] for k in ks],
               ["%.1f" % m for m in med],
               100 * max(0.0, 1 - sum(k[1] for k in ks) / max(med))))


def dist_server_text(server):
    return "; ".join("%s %d x %.2f ms" % (op, n, 1e3 * s / n)
                     for op, (n, s) in sorted(server.items()))


class DistJobs:
    """Phase 17's four launches.  start() may come before the phase (main
    calls it once phase 16's timed work is done, so the workers' imports
    overlap its small case and calibration); each worker waits, once
    imported, for its go file: leg A's for the phase, the others' for
    leg A's end.  stop() ends every process of the launches."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="dist_")
        self.go_a = os.path.join(self.dir, "go_leg_a")
        self.go_rest = os.path.join(self.dir, "leg_a_done")
        self.procs = []
        self.started = None

    def start(self):
        self.started = time.perf_counter()
        self.procs.append(dist_launch("a", self.dir, wait_for=self.go_a))
        self.procs += [dist_launch("b", self.dir, wait_for=self.go_rest),
                       dist_launch("small", self.dir, wait_for=self.go_rest),
                       dist_launch("small-cpu", self.dir, cpu=True,
                                   wait_for=self.go_rest)]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
        shutil.rmtree(self.dir, ignore_errors=True)


def touch(path):
    with open(path, "w"):
        pass


def phase_dist(card, jobs=None):
    """BASELINE config 4 on two workers of the card (see the module doc,
    phase 17), over ``jobs`` (a DistJobs, started here if it was not
    before).  Returns the compression kernels' launches on each worker
    of leg B and the largest difference from the plain version."""
    own = jobs is None
    jobs = jobs or DistJobs()
    try:
        if not jobs.procs:
            jobs.start()
        head_start = time.perf_counter() - jobs.started
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        # leg A has the card to itself: leg B and the small cases start
        # once it has ended
        touch(jobs.go_a)
        a = dist_results(jobs.procs[0], "leg A", deadline)
        a_s = time.perf_counter() - t0
        touch(jobs.go_rest)
        b, small, small_cpu = [
            dist_results(p, m, deadline) for p, m in
            zip(jobs.procs[1:], ("leg B", "small", "small on the CPU"))]
        small_err = dist_small_check(jobs.dir, small, small_cpu)
        fz = fleet.fleetz(spool=os.path.join(jobs.dir, "spool"),
                          stale_after=DIST_TIMEOUT_S)
    finally:
        if own:
            jobs.stop()
    merged = {name: fz.get("merged_metrics", {}).get(name, {}).get(
                  "series", []) for name in ("mxnet_tpu_train_steps_total",
                                             "mxnet_tpu_train_step_seconds")}
    m_steps = sum(s["value"] for s in merged["mxnet_tpu_train_steps_total"]
                  if s["labels"] == {"loop": "gluon"})
    m_count = sum(s["count"] for s in merged["mxnet_tpu_train_step_seconds"]
                  if s["labels"] == {"loop": "gluon"})
    ranks = fz.get("ranks", {})
    check(fz.get("active") and sorted(ranks) == ["0", "1"]
          and not any(r["stale"] for r in ranks.values())
          and m_steps == sum(r["train_steps"] for r in b)
          == DIST_WORKERS * (1 + DIST_B_STEPS)
          and m_count == sum(r["step_count"] for r in b),
          "fleetz: ranks %s, stale %s, merged TRAIN_STEPS %s and step count "
          "%s against the workers' %s, %s"
          % (sorted(ranks), [r["stale"] for r in ranks.values()], m_steps,
             m_count, [r["train_steps"] for r in b],
             [r["step_count"] for r in b]))
    check(a[0]["sha"] == a[1]["sha"], "leg A: the workers' parameters differ")
    check(b[0]["agg_sha"] == b[1]["agg_sha"],
          "leg B: the workers pulled different sums")
    ips = [r["ips"] for r in a]
    server = a[0]["server"]
    print("dist: resnet50_v1 f32 batch %d x %d workers on one card, "
          "train_imagenet --kv-store dist_device_sync (the port's launcher, "
          "the server on the host), sgd lr %g momentum 0.9 on the server, "
          "eager | losses %s | img/s per worker %s, summed %.1f | step s "
          "median %s | push / pull host ms a step (median) %s / %s | %d "
          "bytes a push | server, one profiled step: %s | %s | peak memory "
          "GB %s | trainable parameters bit-equal (SHA-1 %s), running stats "
          "%s | worker start-up s %s, worker run s %s, leg %.1f s | %s"
          % (BATCH, DIST_WORKERS, DIST_LR,
             [["%.4f" % v for v in r["losses"]] for r in a],
             ["%.1f" % v for v in ips], sum(ips),
             ["%.4f" % statistics.median(r["step_s"]) for r in a],
             ["%.1f" % (1e3 * statistics.median(r["push_s"])) for r in a],
             ["%.1f" % (1e3 * statistics.median(r["pull_s"])) for r in a],
             a[0]["push_bytes"], dist_server_text(server), dist_idle(a),
             ["%.2f" % r["peak_gb"] for r in a], a[0]["sha"][:12],
             "bit-equal" if a[0]["aux_sha"] == a[1]["aux_sha"]
             else "differ", ["%.1f" % r["start_s"] for r in a],
             ["%.1f" % r["leg_s"] for r in a], a_s, card), flush=True)
    print("dist compression: resnet50_v1 batch %d x %d workers, Trainer "
          "dist_device_sync + 2bit (t %g), update_on_kvstore=False (sgd lr "
          "%g momentum 0.9 on each worker), %d pushes | launches "
          "(quantize, dequantize) per worker %s | step-1 push of the 193 "
          "keys bit-exact with the batched plain version | every pulled sum in "
          "{-2t, -t, 0, t, 2t}, nonzero share %s, bit-equal on both "
          "workers | losses %s | step s %s | worker start-up s %s, run s "
          "%s | %s"
          % (BATCH, DIST_WORKERS, T, DIST_B_LR, 1 + DIST_B_STEPS,
             [[r["launches"][k] for k in ("quantize_2bit", "dequantize_2bit")]
              for r in b], ["%.4f" % v for v in b[0]["nonzero"]],
             [["%.4f" % v for v in r["losses"]] for r in b],
             [["%.3f" % v for v in r["step_s"]] for r in b],
             ["%.1f" % r["start_s"] for r in b],
             ["%.1f" % r["leg_s"] for r in b], card), flush=True)
    print("dist small: MLP 192-64-10, %d workers, 2 steps: card vs CPU "
          "parameters within %.3g of max|ref| (bound %g), workers bit-equal "
          "| dist phase %.1f s (the launches started %.1f s before it) | %s"
          % (DIST_WORKERS, small_err, DIST_SMALL_REL,
             time.perf_counter() - t0, head_start, card), flush=True)
    strag = fz["straggler"]
    print("dist fleet: leg B's %d workers published to one MXNET_FLEET_SPOOL "
          "after its rendezvous | fleetz: ranks %s, stale 0, torn %d, clock "
          "offsets s %s | merged TRAIN_STEPS{gluon} %d = %s summed over the "
          "ranks, step-seconds count %d | skew %s (straggler rank %s) | %s"
          % (DIST_WORKERS, sorted(ranks), fz["torn_snapshots"],
             fz["clock_offsets_s"], m_steps,
             [r["train_steps"] for r in b], m_count, strag.get("skew"),
             strag.get("straggler"), card), flush=True)
    return ({name: [r["launches"][name] for r in b]
             for name in ("quantize_2bit", "dequantize_2bit")},
            b[0]["worst"])


# ---------------------------------------------------------------------------
# phase 9b: the serving tier
# ---------------------------------------------------------------------------

# resnet50_v1 as the JAX package serves it (tools/prewarm.py:129-197):
# classes 1000, uint8 (32, 3, 224, 224) batches normalized on the card,
# chain 8, a top-5 postprocess under bf16_mixed; 16 batches plus a ragged
# one of 5 rows from RandomState(0); the int8 artifact of the
# quantize_model CLI at batch 32.  Bounds: f32 logits (TF32 off) within
# SERVE_F32_REL x max|logit| of the eager forward; bf16 top-1 equal to
# f32's on every row whose f32 top-1/top-2 gap exceeds twice the largest
# |bf16 - f32| logit difference seen (a flip needs that much error on the
# two logits), and on at least that share of all rows; top-5 indices
# equal where a request's answer is compared with the direct Predictor's;
# the int8 route's logits bit-equal to the int8 Predictor's on the same
# batch; int8_conv bit-equal to its plain version at every distinct
# quantized layer shape at batch 2 and at the route's batch 32
SERVE_BATCH, SERVE_CHAIN, SERVE_FEED, SERVE_RAGGED = 32, 8, 16, 5
SERVE_CHECK_BATCHES = (2, SERVE_BATCH)
SERVE_SHAPE = (3, 224, 224)
SERVE_F32_REL = 1e-5
SERVE_ASYNC_REQUESTS, SERVE_ASYNC_THREADS, SERVE_ASYNC_ROWS = 64, 4, 8
SERVE_SLO_MS = 2000.0            # the LM route's TTFT SLO
SERVE_GEN_PROMPT, SERVE_GEN_NEW = 12, 16
SERVE_HTTP_REQUESTS, SERVE_HTTP_ROWS = 8, 2
SERVE_QUOTA_BURST = 2
SERVE_MAX_BODY = 64 << 20        # the int8 route's 32-row JSON bodies


def serve_top5(logits):
    return torch.topk(logits, 5).indices


def serve_net():
    """resnet50_v1 at full width, Xavier from seed 0, on the card."""
    mx.random.seed(0)
    with mx.name.NameManager():
        net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    return net


def serve_bf16(net, raw, postprocess=serve_top5):
    """A bf16_mixed predictor of ``net`` on the contract of ``raw[0]``."""
    from mxnet_tpu_torch.serving import Predictor, uint8_normalizer

    return Predictor.from_block(net, raw[0], chain=SERVE_CHAIN,
                                preprocess=uint8_normalizer(),
                                postprocess=postprocess,
                                dtype_policy="bf16_mixed")[0]


def serve_imgs_per_s(pred, batches):
    """Images/s of one pass of ``batches`` through ``pred`` (outputs on
    the host at the end), after one warm pass."""
    list(pred.predict(batches[:SERVE_CHAIN]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = list(pred.predict(batches))
    dt = time.perf_counter() - t0
    return sum(len(o) for o in outs) / dt


def serve_sync_warnings(pred, batches):
    """Host syncs torch flags over one chunk of ``pred``
    (set_sync_debug_mode "warn"): their count and the first message."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            list(pred.predict(batches[:SERVE_CHAIN]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # torch's own words for a flagged sync; the mode's first-use notice
    # ("a prototype feature and does not yet detect all synchronizing
    # operations") is not one
    msgs = [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    return len(msgs), (msgs[0] if msgs else "")


def serve_predictor(card, net, raw):
    """(a): the f32 logits against the eager forward, bf16 top-5 against
    bf16 logits and f32, outputs in order and the ragged batch; images/s
    host-fed and card-resident.  Returns the bf16 top-5 predictor and
    the numbers."""
    from mxnet_tpu_torch.serving import Predictor, uint8_normalizer

    prep32 = uint8_normalizer(dtype="float32")
    f32 = Predictor.from_block(net, raw[0], chain=SERVE_CHAIN,
                               preprocess=prep32, dtype_policy="f32")[0]
    bf16 = serve_bf16(net, raw)
    bf16_logits = serve_bf16(net, raw, postprocess=None)
    outs = list(f32.predict(raw))
    check(len(outs) == len(raw) and outs[-1].shape == (SERVE_RAGGED, 1000)
          and all(o.shape == (SERVE_BATCH, 1000) for o in outs[:-1]),
          "serve: f32 outputs %s" % [o.shape for o in outs])
    worst = 0.0
    with mx.autograd.predict_mode(), torch.no_grad():
        for r, o in zip(raw, outs):
            x = prep32(torch.from_numpy(r).cuda())
            ref = net(mx.nd.NDArray(x)).asnumpy()
            err = float(np.abs(o - ref).max() / np.abs(ref).max())
            worst = max(worst, err)
    check(worst <= SERVE_F32_REL, "serve: f32 logits %.3g x max|logit| "
          "from the eager forward (bound %g)" % (worst, SERVE_F32_REL))
    top5 = list(bf16.predict(raw))
    lg16 = list(bf16_logits.predict(raw))
    check(len(top5) == len(raw) and top5[-1].shape == (SERVE_RAGGED, 5),
          "serve: bf16 top-5 shapes %s" % [t.shape for t in top5])
    for t, lg in zip(top5, lg16):
        # bf16 logits tie often: compare the values the indices pick
        want = -np.sort(-lg, axis=1)[:, :5]
        check(np.array_equal(np.take_along_axis(lg, t, 1), want),
              "serve: bf16 top-5 differs from the top-5 of the bf16 "
              "logits")
    f32_all, b16_all = np.concatenate(outs), np.concatenate(lg16)
    err16 = float(np.abs(b16_all - f32_all).max())
    srt = np.sort(f32_all, axis=1)
    gap = srt[:, -1] - srt[:, -2]
    decided = gap > 2 * err16
    agree = np.argmax(b16_all, 1) == np.argmax(f32_all, 1)
    t1 = np.concatenate(top5)[:, 0] == np.argmax(f32_all, 1)
    check(bool(np.all(agree[decided])) and bool(np.all(t1[decided])),
          "serve: bf16 top-1 flips on %d rows whose f32 gap exceeds 2 x "
          "%.3g" % (int((~agree & decided).sum()), err16))
    share, need = float(t1.mean()), float(decided.mean())
    check(share >= need, "serve: bf16 top-1 agreement %.3f < %.3f"
          % (share, need))
    print("serve predictor: f32 logits %.3g x max|logit| of eager (bound "
          "%g) over %d batches + %d rows, in order | bf16 top-5 = top-5 of "
          "the bf16 logits | bf16 top-1 = f32 on %.4f of rows (>= %.4f: "
          "gap > 2 x max|bf16 - f32| = %.4g) | %s"
          % (worst, SERVE_F32_REL, SERVE_FEED, SERVE_RAGGED, share, need,
             2 * err16, card), flush=True)
    return bf16, f32, {"f32_rel_err": worst, "bf16_top1_share": share,
                       "bf16_top1_need": need, "bf16_max_logit_err": err16}


def serve_timing(card, bf16, f32, raw):
    """(a)'s numbers, with the card to itself: images/s host-fed and
    card-resident, the forward's ms at batch 32, the host syncs torch
    flags over one chunk."""
    dev = [torch.from_numpy(r).cuda() for r in raw[:SERVE_FEED]]
    host_ips = serve_imgs_per_s(bf16, raw[:SERVE_FEED])
    dev_ips = serve_imgs_per_s(bf16, dev)
    f32_ips = serve_imgs_per_s(f32, raw[:SERVE_FEED])
    syncs, first_sync = serve_sync_warnings(bf16, raw)
    # the one host wait is the output event's synchronize(), which the
    # mode does not flag
    check(syncs == 0, "serve: %d host syncs over one chunk, the first: %s"
          % (syncs, first_sync))
    x = torch.from_numpy(raw[0]).cuda()
    with torch.inference_mode():
        bf16_ms = time_ms(lambda: bf16._one(x, bf16._params))
        f32_ms = time_ms(lambda: f32._one(x, f32._params))
    print("serve predictor times: bf16 top-5 img/s host uint8 %.1f, "
          "card-resident %.1f, f32 logits host %.1f | forward at batch %d: "
          "bf16 %.3f ms, f32 %.3f ms | host syncs flagged over one chunk "
          "%d %s | %s"
          % (host_ips, dev_ips, f32_ips, SERVE_BATCH, bf16_ms, f32_ms,
             syncs, first_sync[:120], card), flush=True)
    return {"bf16_host_img_s": host_ips, "bf16_card_img_s": dev_ips,
            "f32_host_img_s": f32_ips, "bf16_fwd_ms": bf16_ms,
            "f32_fwd_ms": f32_ms, "sync_warnings": syncs}


def serve_quantize_start(root):
    """(b), the CLI: start quantize_model --model resnet50 --batch 32 on
    the card into ``root``, in its own process.  Returns the process,
    the artifact's directory and the start time."""
    art = os.path.join(root, "resnet50_int8")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.quantize_model",
         "--model", "resnet50", "--batch", str(SERVE_BATCH), "--out", art,
         "--json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, art, time.perf_counter()


def serve_quantize_finish(card, proc, art, t0):
    """Wait for the CLI: exit 0, its JSON report, then --check on the
    artifact.  Returns the report and the CLI's seconds."""
    from mxnet_tpu_torch.tools import quantize_model as qm

    out, err = proc.communicate(timeout=900)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, "serve: quantize_model exited %d: %s"
          % (proc.returncode, err[-2000:]))
    report = json.loads(out.strip().splitlines()[-1])
    check(report["status"] == "emitted", "serve: quantize_model %s"
          % report)
    check(qm.main(["--check", art]) == 0, "serve: --check failed on %s"
          % art)
    print("serve quantize_model: --model resnet50 --batch %d on the card "
          "in %.1f s (its own process, beside (a)'s checks), exit 0, "
          "--check OK | %s" % (SERVE_BATCH, secs, card), flush=True)
    return report, secs


def serve_int8(card, art):
    """(b), serving: the artifact through Predictor.from_symbol, one
    forward's int8_conv launches (= its quantized layers), each distinct
    layer shape bit-equal to the plain version at batch 2 and at the
    route's batch 32 (where the persistent tile loop wraps), the int8
    forward's ms.  Returns the predictor, its batch, the launches the
    kernel-vs-plain check made and the numbers."""
    from mxnet_tpu_torch.contrib import quantization as tq
    from mxnet_tpu_torch.ops import quantization as quant
    from mxnet_tpu_torch.serving import Predictor

    qsym, qargs, qaux, meta = tq.load_artifact(art)
    pred = Predictor.from_symbol(
        qsym, qargs, qaux, data_name=meta["data_name"], chain=SERVE_CHAIN,
        batch_shape=tuple(meta["data_shape"]),
        batch_dtype=meta["data_dtype"], aot_policy_tag="int8")
    check(tuple(meta["data_shape"]) == (SERVE_BATCH,) + SERVE_SHAPE,
          "serve: artifact contract %s" % meta["data_shape"])
    batch = np.random.RandomState(7).rand(SERVE_BATCH, *SERVE_SHAPE) \
        .astype(np.float32)
    shapes = []
    inner = kernels.int8_conv

    def recording(x, w, stride, pad, dilate, groups):
        shapes.append((tuple(x.shape[1:]), tuple(w.shape), tuple(stride),
                       tuple(pad), tuple(dilate), groups))
        return inner(x, w, stride, pad, dilate, groups)

    kernels.int8_conv = recording
    try:
        before = kernels.launch_counts["int8_conv"]
        out = list(pred.predict([batch]))[0]
        launched = kernels.launch_counts["int8_conv"] - before
    finally:
        kernels.int8_conv = inner
    n_q = meta["quantized_layers"]
    check(launched == n_q == len(shapes), "serve: one int8 forward launched "
          "int8_conv %d times for %d quantized layers" % (launched, n_q))
    check(out.shape == (SERVE_BATCH, 1000) and np.isfinite(out).all(),
          "serve: int8 output %s finite %s" % (out.shape,
                                               np.isfinite(out).all()))
    conv0 = "conv0_weight_quantized" in qargs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    distinct = sorted(set(shapes))
    compared = kernels.launch_counts["int8_conv"]
    for n in SERVE_CHECK_BATCHES:
        for xs, ws, stride, pad, dilate, groups in distinct:
            x = torch.randint(-127, 128, (n,) + xs, generator=gen,
                              device="cuda", dtype=torch.int32) \
                .to(torch.int8)
            w = torch.randint(-127, 128, ws, generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
            got = kernels.int8_conv(x, w, stride, pad, dilate, groups)
            want = quant.int8_conv_plain(x, w, stride, pad, dilate, groups)
            check(torch.equal(got, want), "serve: int8_conv batch %d x %s "
                  "w %s stride %s differs from the plain version in %d of "
                  "%d" % (n, xs, ws, stride, int((got != want).sum()),
                          want.numel()))
    compared = kernels.launch_counts["int8_conv"] - compared
    x = torch.from_numpy(batch).cuda()
    with torch.inference_mode():
        int8_ms = time_ms(lambda: pred._one(x, pred._params))
    print("serve int8: artifact %s (top-%d agreement %.4f, delta %.4f <= "
          "%.4f, %d quantized layers, conv0 %s) | one forward launched "
          "int8_conv %d times | %d distinct layer shapes bit-equal to the "
          "plain version at batch %s | int8 forward at batch %d %.3f ms | %s"
          % (os.path.basename(art), meta["topk"], meta["agreement"],
             meta["delta"], meta["max_delta"], n_q,
             "quantized (3 channels padded to 16)" if conv0 else "f32",
             launched, len(distinct),
             " and ".join(map(str, SERVE_CHECK_BATCHES)), SERVE_BATCH,
             int8_ms, card), flush=True)
    return pred, batch, compared, {
        "quantized_layers": n_q, "conv0_quantized": conv0,
        "distinct_shapes": len(distinct),
        "check_batches": list(SERVE_CHECK_BATCHES), "int8_fwd_ms": int8_ms,
        "gate": {k: meta[k] for k in ("topk", "agreement", "delta",
                                      "max_delta")}}


def serve_requests(raw, n, rows_max, seed):
    """``n`` requests of 1..rows_max rows cut from ``raw``'s full batches."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = raw[rng.randint(SERVE_FEED)]
        k = int(rng.randint(1, rows_max + 1))
        s = int(rng.randint(0, SERVE_BATCH - k + 1))
        out.append(b[s:s + k])
    return out


def serve_async(card, net, raw, bf16):
    """(c): two replicas on the card, 64 requests from 4 threads equal to
    the direct Predictor's answers, a full queue, an expired deadline, a
    stalled replica ejected with its request answered by the other, and
    a drained close().  Returns the AsyncPredictor for the gateway (a
    fresh one over the same replicas) and the numbers."""
    from mxnet_tpu_torch.serving_async import (AsyncPredictor,
                                               DeadlineExceeded, Overloaded)
    from mxnet_tpu_torch.testing import faults

    second = serve_bf16(net, raw)
    reqs = serve_requests(raw, SERVE_ASYNC_REQUESTS, SERVE_ASYNC_ROWS, 3)
    ap = AsyncPredictor([bf16, second], queue_depth=SERVE_ASYNC_REQUESTS,
                        batch_window_ms=2.0)
    answers, lat = [None] * len(reqs), [None] * len(reqs)

    def client(k):
        for i in range(k, len(reqs), SERVE_ASYNC_THREADS):
            t0 = time.monotonic()
            fut = ap.submit(reqs[i], block=True, timeout=120)
            answers[i] = fut.result(timeout=120)
            lat[i] = fut.resolved_at - t0

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVE_ASYNC_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(all(a is not None for a in answers), "serve: %d async requests "
          "unanswered" % sum(a is None for a in answers))
    stats = ap.stats()
    # drained close: a burst admitted and close() right after
    burst = [ap.submit(r) for r in reqs[:8]]
    ap.close(drain=True, timeout=120)
    check(all(f.done() and f.exception(0) is None for f in burst),
          "serve: close() did not drain the burst")
    direct = list(bf16.predict(reqs))
    for i, (a, d) in enumerate(zip(answers, direct)):
        check(a.shape == d.shape and np.array_equal(a, d), "serve: async "
              "request %d (%d rows) top-5 differs from the direct "
              "Predictor's" % (i, len(reqs[i])))
    for f, d in zip(burst, direct):
        check(np.array_equal(f.result(0), d), "serve: burst answer differs")
    # a full queue and an expired deadline on a stalled third replica
    third = serve_bf16(net, raw)
    stall = faults.StallingCallable(third._jit_chain)
    third._jit_chain = stall
    ap_q = AsyncPredictor(third, queue_depth=1, batch_window_ms=1.0,
                          sweep_interval_s=10.0)
    try:
        held = ap_q.submit(reqs[0])
        check(stall.stalled.wait(60), "serve: the stall never engaged")
        doomed = ap_q.submit(reqs[1], deadline_ms=50.0)
        try:
            ap_q.submit(reqs[2])
            check(False, "serve: a full queue admitted a request")
        except Overloaded as e:
            check(e.reason == "queue", "serve: shed reason %s" % e.reason)
        ap_q.sweep(now=time.monotonic() + 1.0)
        try:
            doomed.result(timeout=10)
            check(False, "serve: an expired request was answered")
        except DeadlineExceeded as e:
            check(e.stage == "queue", "serve: deadline stage %s" % e.stage)
        stall.release()
        check(np.array_equal(held.result(timeout=60), direct[0]),
              "serve: the held request's answer differs")
    finally:
        stall.release()
        ap_q.close(timeout=60)
    # a stalled replica ejected, its request answered by the other
    stall = faults.StallingCallable(stall._fn)
    third._jit_chain = stall
    ap_s = AsyncPredictor([third, second], batch_window_ms=1.0,
                          sweep_interval_s=10.0, stall_timeout_s=1.0,
                          max_retries=2)
    try:
        with ap_s._cond:                  # the stalled replica claims
            ap_s._eject_locked(ap_s._replicas[1], "test")
        victim = ap_s.submit(reqs[3])
        check(stall.stalled.wait(60), "serve: the stall never engaged")
        ap_s.heal(1)
        ej = telemetry.SERVING_REPLICA_EJECTIONS.value(reason="stall")
        ap_s.sweep(now=time.monotonic() + 5.0)
        check(not ap_s._replicas[0].healthy and
              telemetry.SERVING_REPLICA_EJECTIONS.value(reason="stall")
              == ej + 1, "serve: the stalled replica was not ejected")
        check(np.array_equal(victim.result(timeout=60), direct[3]),
              "serve: the rerouted request's answer differs")
    finally:
        stall.release()
        ap_s.close(timeout=60)
    lat_ms = 1e3 * np.asarray(lat)
    p50, p99 = float(np.percentile(lat_ms, 50)), \
        float(np.percentile(lat_ms, 99))
    rows = sum(len(r) for r in reqs)
    print("serve async: %d requests (%d rows) from %d threads over 2 "
          "replicas on one card in %.3f s (%.1f img/s), latency p50 %.2f "
          "ms p99 %.2f ms, ewma dispatch %.2f ms | equal to the direct "
          "Predictor | full queue -> Overloaded(queue), expired -> "
          "DeadlineExceeded(queue), stalled replica ejected and its request "
          "rerouted, close() drained 8 | %s"
          % (len(reqs), rows, SERVE_ASYNC_THREADS, wall, rows / wall, p50,
             p99, 1e3 * (stats["ewma_dispatch_s"] or 0.0), card),
          flush=True)
    return second, {"async_p50_ms": p50, "async_p99_ms": p99,
                    "async_img_s": rows / wall}


def serve_http(port, path, body=None, headers=None, timeout=120):
    """(status, headers, body bytes) of one request through urllib."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode("utf-8")
    req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                 data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def serve_sse_tokens(raw):
    frames = [json.loads(p[len(b"data: "):]) for p in raw.split(b"\n\n")
              if p.startswith(b"data: ")]
    check(frames and frames[-1].get("done") is True, "serve: SSE stream "
          "did not end done: %s" % frames[-1:])
    return [f["token"] for f in frames[:-1]]


def serve_gateway(card, lm, raw, replicas, int8_pred, int8_batch):
    """(d): the three routes over HTTP, 404, 413, 429, /healthz 200 then
    503 while stop_gateway(drain=True) drains an open stream, /metrics
    and the gateway_request events.  Returns the numbers."""
    from mxnet_tpu_torch import gateway as gw_mod
    from mxnet_tpu_torch.serving_async import AsyncPredictor, ContractRows
    from mxnet_tpu_torch.testing import faults

    ap16 = AsyncPredictor(replicas, batch_window_ms=2.0)
    ap8 = AsyncPredictor(int8_pred, batch_window_ms=2.0)
    eng = generate.GenerationEngine(
        lm, slots=4, cache_len=DECODE_CACHE,
        sampling=generate.SamplingConfig(greedy=True))
    srv = generate.TokenServer(eng, queue_depth=16, slo_ms=SERVE_SLO_MS)
    prompt = np.random.RandomState(11).randint(
        0, DECODE_LM["vocab_size"], SERVE_GEN_PROMPT).tolist()
    want_tokens = srv.submit(prompt, max_new_tokens=SERVE_GEN_NEW) \
        .result(timeout=120).tokens
    gw = gw_mod.serve_gateway(port=0, max_body=SERVE_MAX_BODY,
                              quota_qps=0.001,
                              quota_burst=SERVE_QUOTA_BURST)
    try:
        gw.add_route("resnet50", ContractRows(ap16), kind="predict")
        gw.add_route("resnet50_int8", ap8, kind="predict")
        gw.add_route("lm", srv, kind="generate")
        port = gw.port
        reqs = serve_requests(raw, SERVE_HTTP_REQUESTS, SERVE_HTTP_ROWS, 5)
        direct = list(replicas[0].predict(reqs))
        t0 = time.perf_counter()
        for i, (r, d) in enumerate(zip(reqs, direct)):
            st, _h, body = serve_http(port, "/v1/predict/resnet50",
                                      {"rows": r.tolist()},
                                      {"X-Tenant": "client-%d" % i})
            check(st == 200, "serve: bf16 route answered %d: %s"
                  % (st, body[:200]))
            got = np.asarray(json.loads(body)["outputs"])
            check(np.array_equal(got, d), "serve: bf16 route request %d "
                  "top-5 differs from the in-process answer" % i)
        http16_ms = 1e3 * (time.perf_counter() - t0) / len(reqs)
        rows8 = np.round(int8_batch.astype(np.float64), 2)
        want8 = list(int8_pred.predict([rows8.astype(np.float32)]))[0]
        t0 = time.perf_counter()
        st, _h, body = serve_http(port, "/v1/predict/resnet50_int8",
                                  {"rows": rows8.tolist()},
                                  {"X-Tenant": "client-int8"})
        http8_s = time.perf_counter() - t0
        check(st == 200, "serve: int8 route answered %d: %s"
              % (st, body[:200]))
        got8 = np.asarray(json.loads(body)["outputs"], np.float32)
        check(got8.shape == want8.shape and np.array_equal(got8, want8),
              "serve: int8 route differs from the int8 Predictor by %s"
              % (np.abs(got8 - want8).max() if got8.shape == want8.shape
                 else got8.shape))
        st, h, body = serve_http(port, "/v1/generate/lm",
                                 {"tokens": prompt,
                                  "max_new_tokens": SERVE_GEN_NEW},
                                 {"X-Tenant": "client-lm"})
        check(st == 200 and h.get("Content-Type") == "text/event-stream",
              "serve: generate answered %d %s" % (st, h.get("Content-Type")))
        got_tokens = serve_sse_tokens(body)
        check(got_tokens == list(want_tokens), "serve: SSE tokens %s != "
              "TokenServer.submit's %s" % (got_tokens, list(want_tokens)))
        st, _h, _b = serve_http(port, "/v1/predict/ghost", {"rows": [[0]]})
        check(st == 404, "serve: unknown model answered %d" % st)
        st, _raw = faults.oversized_post("127.0.0.1", port,
                                         "/v1/predict/resnet50",
                                         claim_bytes=SERVE_MAX_BODY + 1)
        check(st == 413, "serve: oversized body answered %d" % st)
        codes = []
        for _ in range(SERVE_QUOTA_BURST + 1):
            st, h, _b = serve_http(port, "/v1/generate/lm",
                                   {"tokens": prompt[:4],
                                    "max_new_tokens": 1},
                                   {"X-Tenant": "hog"})
            codes.append(st)
        check(codes == [200] * SERVE_QUOTA_BURST + [429]
              and int(h.get("Retry-After", 0)) >= 1,
              "serve: over-quota tenant codes %s" % codes)
        st, _h, _b = serve_http(port, "/healthz")
        check(st == 200, "serve: /healthz answered %d before drain" % st)
        st, _h, metrics = serve_http(port, "/metrics")
        check(st == 200 and b"mxnet_tpu_gateway_responses_total" in metrics
              and b"mxnet_tpu_serving_requests_total" in metrics
              and b"mxnet_tpu_serving_request_seconds" in metrics,
              "serve: /metrics lacks the gateway or serving series")
        # drain: an open stream holds the listener while /healthz is 503
        stream = {}

        def long_stream():
            stream["r"] = serve_http(port, "/v1/generate/lm",
                                     {"tokens": prompt,
                                      "max_new_tokens": 160},
                                     {"X-Tenant": "client-drain"})

        ts = threading.Thread(target=long_stream)
        ts.start()
        deadline = time.monotonic() + 60
        while telemetry.GATEWAY_OPEN_STREAMS.value() < 1:
            check(time.monotonic() < deadline, "serve: stream never opened")
            time.sleep(0.002)
        stopper = threading.Thread(target=gw_mod.stop_gateway,
                                   kwargs={"drain": True, "timeout": 120})
        stopper.start()
        seen = None
        while stopper.is_alive():
            try:
                st, _h, _b = serve_http(port, "/healthz", timeout=10)
            except OSError:              # the listener already stopped
                break
            if st == 503:
                seen = st
                break
        ts.join(timeout=120)
        stopper.join(timeout=120)
        check(seen == 503, "serve: /healthz never read 503 during drain")
        check(stream["r"][0] == 200 and len(serve_sse_tokens(
            stream["r"][2])) > 0, "serve: the drained stream was cut")
    finally:
        gw_mod.stop_gateway(drain=False)
        srv.close(timeout=60)
        ap16.close(timeout=60)
        ap8.close(timeout=60)
    evs = [e for e in events.recent() if e["kind"] == "gateway_request"]
    by_code = collections.Counter(e["http_status"] for e in evs)
    check(by_code[200] >= SERVE_HTTP_REQUESTS + 3 and by_code[404] >= 1
          and by_code[413] >= 1 and by_code[429] >= 1,
          "serve: gateway_request events by code %s" % dict(by_code))
    print("serve gateway: %d bf16 predict requests of %d rows 200 with the "
          "in-process top-5 (%.1f ms each over HTTP), a %d-row int8 "
          "request 200 bit-equal to the int8 Predictor (%.2f s over HTTP, "
          "JSON both ways), SSE %d tokens = TokenServer.submit (slo_ms "
          "%g), 404, 413, 429 with Retry-After, /healthz 200 then 503 "
          "while draining an open stream, /metrics with GATEWAY_* and "
          "SERVING_*, gateway_request events by code %s | %s"
          % (SERVE_HTTP_REQUESTS, SERVE_HTTP_ROWS, http16_ms, SERVE_BATCH,
             http8_s, len(got_tokens), SERVE_SLO_MS,
             dict(sorted(by_code.items())), card), flush=True)
    return {"http_bf16_ms": http16_ms, "http_int8_s": http8_s,
            "events_by_code": {str(k): v for k, v in by_code.items()}}


def phase_serve(card, lm=None, keep_art=None):
    """Phase 9b (see the module doc), on phase 8's LM (built here when the
    phase runs alone); its int8 artifact is copied to ``keep_art`` when
    given (phase 23 serves it through the C ABI).  Returns the int8_conv
    launches of the serving path."""
    t_phase = time.perf_counter()
    if lm is None:                       # the phase alone
        lm = build_lm(DECODE_LM, mx.gpu(0))
        lm(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    tel_on, ev_on = telemetry.enabled(), events.enabled()
    telemetry.enable()
    events.enable(path="", sample=1.0)
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="serve_")
    proc = None
    try:
        before = dict(kernels.launch_counts)
        # the CLI runs in its own process beside (a)'s checks
        proc, art, t_cli = serve_quantize_start(root)
        net = serve_net()
        rng = np.random.RandomState(0)
        raw = [rng.randint(0, 256, (SERVE_BATCH,) + SERVE_SHAPE)
               .astype(np.uint8) for _ in range(SERVE_FEED)]
        raw.append(rng.randint(0, 256, (SERVE_RAGGED,) + SERVE_SHAPE)
                   .astype(np.uint8))
        bf16, f32, nums = serve_predictor(card, net, raw)
        _report, cli_s = serve_quantize_finish(card, proc, art, t_cli)
        nums.update(serve_timing(card, bf16, f32, raw))
        del f32
        int8_pred, int8_batch, compared, nums8 = serve_int8(card, art)
        if keep_art is not None:
            shutil.copytree(art, keep_art)
        second, nums_async = serve_async(card, net, raw, bf16)
        nums_gw = serve_gateway(card, lm, raw, [bf16, second], int8_pred,
                                int8_batch)
        launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
        # the kernel-vs-plain check's launches are not the serving path's
        launched["int8_conv"] -= compared
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
        if not tel_on:
            telemetry.disable()
        if not ev_on:
            events.disable()
    others = {n: c for n, c in launched.items() if n != "int8_conv" and c}
    check(not others, "serve: kernels other than int8_conv launched: %s"
          % others)
    line = dict(nums, **nums8, **nums_async, **nums_gw)
    line.update({"int8_conv_launches": launched["int8_conv"],
                 "quantize_model_s": cli_s,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "phase_s": time.perf_counter() - t_phase, "card": card})
    print("serve " + json.dumps(line), flush=True)
    return launched["int8_conv"]


def phase_observe(card):
    """The closing leg: the scrape endpoint answers /metrics and /statusz
    over HTTP, and an exception in a small trainer's step writes one
    flight-recorder bundle."""
    import urllib.request

    telemetry.enable()
    srv = telemetry.serve_scrape(port=0, host="127.0.0.1")
    try:
        base = "http://127.0.0.1:%d" % srv.port
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(base + "/statusz", timeout=30) as r:
            status = json.loads(r.read())
    finally:
        telemetry.stop_scrape()
        telemetry.disable()
    check("# TYPE mxnet_tpu_train_steps_total counter" in metrics
          and status.get("ready") is True
          and "decode" in status.get("subsystems", {}),
          "scrape endpoint: /metrics %d bytes, /statusz %s"
          % (len(metrics), sorted(status)))
    root = tempfile.mkdtemp(prefix="flight_")
    try:
        tracing.enable()
        tracing.enable_flight_recorder(root)
        tracing.rearm_flight_recorder()
        _, tr = small_trainer(mx.gpu(0), None)
        bad = mx.nd.array(np.zeros((2, 3, 8), np.float32), ctx=mx.gpu(0))
        raised = None
        try:
            tr.step([bad], mx.nd.array(np.zeros(2, np.float32),
                                       ctx=mx.gpu(0)))
        except Exception as e:  # noqa: BLE001 - the forced fault
            raised = e
        bundles = tracing.bundles(root)
        files = sorted(os.listdir(bundles[0])) if len(bundles) == 1 else []
    finally:
        tracing.disable_flight_recorder()
        tracing.disable()
        shutil.rmtree(root, ignore_errors=True)
    check(raised is not None and len(bundles) == 1
          and {"trace.json", "telemetry.json", "stacks.txt",
               "info.json"} <= set(files),
          "flight recorder: raised %r, bundles %s, files %s"
          % (raised, bundles, files))
    print("observe: serve_scrape(127.0.0.1, port 0) answered /metrics "
          "(%d bytes) and /statusz (ready, %d subsystems) | a forced "
          "exception in a small ShardedTrainer step (%s) wrote 1 "
          "flight-recorder bundle: %s | %s"
          % (len(metrics), len(status["subsystems"]),
             type(raised).__name__, files, card), flush=True)


# ---------------------------------------------------------------------------
# phase 20: sparse storage on a 1,000,000-row table
# ---------------------------------------------------------------------------

# LIBSVM Avazu's 1,000,000 features (upstream MXNet 1.5's
# example/sparse/linear_classification trains on that set); batches of
# 8192 rows, 32 distinct features a row (value 1) drawn Zipf(1.1) and
# folded into range, so that rows repeat within and across batches as in
# click logs; a 1,000,000 x 64 f32 table W and its momentum in
# KVStore('device') with SGD(lr 0.1, momentum 0.9, wd 1e-5, lazy_update);
# h = relu(sparse.dot(X, W)), a dense 64 -> 1 head (its weight and bias
# in the same store, dense), a logistic loss; 1 warm-up + 10 timed steps
SPARSE = dict(features=1_000_000, width=64, batch=8192, steps=11)
SPARSE_SMALL = dict(features=5000, width=8, batch=64, steps=3)
SPARSE_NNZ, SPARSE_ZIPF_A, SPARSE_WARM = 32, 1.1, 1
SPARSE_OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-5,
                  lazy_update=True)
SPARSE_REL = 1e-5                 # f32 against the f64 recompute, relative
SPARSE_AMBIGUOUS = 1e-5           # |z| below this x max|z|: either sign


def sparse_data(cfg, seed):
    """The run's CSR batches as host components (ascending columns a row),
    labels from a hidden linear model over the features (its score above
    the batch's median), the initial table (N(0, 0.01)) and head."""
    rng = np.random.RandomState(seed)
    hidden = rng.randn(cfg["features"])
    batches = []
    for _ in range(cfg["steps"]):
        cols = np.zeros((cfg["batch"], SPARSE_NNZ), np.int64)
        todo = np.arange(cfg["batch"])
        while len(todo):
            # the first 32 distinct ids of each row's draws, in draw order
            d = (rng.zipf(SPARSE_ZIPF_A, (len(todo), 2 * SPARSE_NNZ)) - 1) \
                % cfg["features"]
            order = np.argsort(d, axis=1, kind="stable")
            srt = np.take_along_axis(d, order, 1)
            first = np.ones_like(srt, bool)
            first[:, 1:] = srt[:, 1:] != srt[:, :-1]
            keep = np.zeros_like(first)
            np.put_along_axis(keep, order, first, 1)
            keep &= np.cumsum(keep, 1) <= SPARSE_NNZ
            full = keep.sum(1) == SPARSE_NNZ
            cols[todo[full]] = np.sort(
                d[full][keep[full]].reshape(-1, SPARSE_NNZ), 1)
            todo = todo[~full]
        score = hidden[cols].sum(1)
        y = (score > np.median(score)).astype(np.float32)
        batches.append((cols, y))
    w0 = (0.01 * rng.randn(cfg["features"], cfg["width"])).astype(np.float32)
    v0 = (0.1 * rng.randn(cfg["width"], 1)).astype(np.float32)
    return batches, w0, v0


def sparse_csr(cols, lo, hi, ctx, features):
    """Rows lo..hi of a batch as a CSRNDArray on ctx, values 1."""
    part = cols[lo:hi]
    n = part.shape[0]
    indptr = np.arange(0, n * SPARSE_NNZ + 1, SPARSE_NNZ, dtype=np.int64)
    return mx.nd.sparse.csr_matrix(
        (np.ones(part.size, np.float32), part.reshape(-1), indptr),
        shape=(n, features), ctx=ctx)


def sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    return time.perf_counter()


class SparseRef:
    """The model recomputed in float64 with plain torch on the port's
    device, from the same components: gather and index_add_, the lazy
    update over the rows the gradient holds, the head's dense momentum
    SGD."""

    def __init__(self, w0, v0, device):
        self.w = torch.as_tensor(w0, device=device).double()
        self.m = torch.zeros_like(self.w)
        self.v = torch.as_tensor(v0, device=device).double()
        self.mv = torch.zeros_like(self.v)
        self.b = torch.zeros(1, dtype=torch.float64, device=device)
        self.mb = torch.zeros_like(self.b)
        self.ambiguous = 0

    def step(self, cols, y, z32):
        lr, mom, wd = (SPARSE_OPT["learning_rate"], SPARSE_OPT["momentum"],
                       SPARSE_OPT["wd"])
        dev = self.w.device
        c = torch.as_tensor(cols, device=dev).reshape(-1)
        rid = torch.arange(cols.shape[0], device=dev).repeat_interleave(
            cols.shape[1])
        z = torch.zeros(cols.shape[0], self.w.shape[1], dtype=torch.float64,
                        device=dev).index_add_(0, rid, self.w[c])
        # an entry within f32's rounding of 0 takes the port's sign
        near = z.abs() <= SPARSE_AMBIGUOUS * z.abs().max()
        self.ambiguous += int(near.sum())
        mask = torch.where(near, z32 > 0, z > 0).double()
        h = z * mask
        logit = h @ self.v + self.b
        yt = torch.as_tensor(y, device=dev).double()[:, None]
        dlogit = (torch.sigmoid(logit) - yt) / cols.shape[0]
        dv, db = h.t() @ dlogit, dlogit.sum(0)
        dh = dlogit * self.v.t() * mask
        rows = torch.unique(c)
        dw = torch.zeros(len(rows), self.w.shape[1], dtype=torch.float64,
                         device=dev).index_add_(
            0, torch.searchsorted(rows, c), dh[rid])
        keep = (dw != 0).any(1)
        rows, g = rows[keep], dw[keep] + wd * self.w[rows[keep]]
        new_m = mom * self.m[rows] - lr * g
        self.m[rows] = new_m
        self.w[rows] += new_m
        for p, m, gp in ((self.v, self.mv, dv), (self.b, self.mb, db)):
            m.copy_(mom * m - lr * (gp + wd * p))
            p += m
        return rows


def sparse_rel(got, want):
    scale = float(want.abs().max()) or 1.0
    return float((got.double() - want).abs().max()) / scale


def sparse_train(cfg, ctx, seed, ref=False, measure=False):
    """The port's sparse path: per step, pull the batch's unique rows of
    W into a RowSparseNDArray, forward with sparse.dot on the pulled dense
    view, dW = sparse.dot(X, dh, transpose_a=True) cast to row_sparse for
    each half of the batch, and both halves pushed as a list (add_rsp_rsp
    sums them; SGD's lazy update applies the sum), the head pushed dense.
    Every step runs with RuntimeWarning as an error, so a densification
    fails it.  With ``ref`` each step is checked against SparseRef; with
    ``measure`` the phase's times are taken."""
    batches, w0, v0 = sparse_data(cfg, seed)
    feats, width, bsz = cfg["features"], cfg["width"], cfg["batch"]
    xs = [(sparse_csr(c, 0, bsz, ctx, feats),
           sparse_csr(c, 0, bsz // 2, ctx, feats),
           sparse_csr(c, bsz // 2, bsz, ctx, feats), y) for c, y in batches]
    kv = mx.kv.create("device")
    kv.init("W", mx.nd.array(w0, ctx=ctx))
    kv.init("v", mx.nd.array(v0, ctx=ctx))
    kv.init("b", mx.nd.zeros((1,), ctx=ctx))
    kv.set_optimizer(mx.optimizer.SGD(**SPARSE_OPT))
    w_init = kv._store["W"]._data.clone()
    v_nd, b_nd = mx.nd.zeros((width, 1), ctx=ctx), mx.nd.zeros((1,), ctx=ctx)
    out = mx.nd.sparse.zeros_sparse("row_sparse", (feats, width), ctx=ctx)
    sr = SparseRef(w0, v0, w_init.device) if ref else None
    touched = torch.zeros(feats, dtype=torch.bool, device=w_init.device)
    times, uniq, losses, worst = [], [], [], 0.0
    if measure:
        torch.cuda.reset_peak_memory_stats()
    for step, (x, xa, xb, y) in enumerate(xs):
        yt = mx.nd.array(y.reshape(-1, 1), ctx=ctx)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            t0 = sync(ctx)
            kv.pull(["v", "b"], out=[v_nd, b_nd])
            rows = mx.nd.NDArray(torch.unique(x.indices._data))
            kv.row_sparse_pull("W", out=out, row_ids=rows)
            t1 = sync(ctx)
            n_rows = rows.shape[0]
            check(out.data.shape == (n_rows, width)
                  and torch.equal(out.indices._data, rows._data)
                  and torch.equal(out.data._data,
                                  kv._store["W"]._data[rows._data]),
                  "step %d: the pulled rows (%s) are not W's %d rows bit "
                  "for bit" % (step, out.data.shape, n_rows))
            t1b = sync(ctx)
            z = mx.nd.sparse.dot(x, out.tostype("default"))
            h = mx.nd.relu(z)
            logit = mx.nd.dot(h, v_nd) + b_nd
            t2 = sync(ctx)
            dlogit = (mx.nd.sigmoid(logit) - yt) / bsz
            dh = mx.nd.dot(dlogit, v_nd, transpose_b=True) * (z > 0)
            half = bsz // 2
            grads = [mx.nd.sparse.dot(xp, dh[lo:hi], transpose_a=True)
                     .tostype("row_sparse")
                     for xp, lo, hi in ((xa, 0, half), (xb, half, bsz))]
            t3 = sync(ctx)
            kv.push("W", grads)
            kv.push(["v", "b"], [mx.nd.dot(h, dlogit, transpose_a=True),
                                 dlogit.sum(axis=0)])
            t4 = sync(ctx)
        lt = logit._data.double()
        losses.append(float((torch.nn.functional.softplus(lt)
                             - lt * yt._data.double()).mean()))
        grad_rows = torch.unique(torch.cat([g.indices._data for g in grads]))
        touched[grad_rows] = True
        if ref:
            ref_rows = sr.step(batches[step][0], y, z._data)
            check(torch.equal(ref_rows, grad_rows),
                  "step %d: the gradient's %d rows against the f64 "
                  "recompute's %d" % (step, len(grad_rows), len(ref_rows)))
            w, m = kv._store["W"]._data, kv._updater.states["W"]._data
            # the head (64 weights and the bias) as one parameter set
            head = torch.cat([kv._store["v"]._data.reshape(-1),
                              kv._store["b"]._data])
            errs = (sparse_rel(w[grad_rows], sr.w[grad_rows]),
                    sparse_rel(m[grad_rows], sr.m[grad_rows]),
                    sparse_rel(head, torch.cat([sr.v.reshape(-1), sr.b])))
            worst = max(worst, *errs)
            check(max(errs) <= SPARSE_REL,
                  "step %d: W, momentum, head against the f64 recompute "
                  "%s (bound %g)" % (step, errs, SPARSE_REL))
        if step >= SPARSE_WARM:
            times.append((t1 - t0, t2 - t1b, t3 - t2, t4 - t3))
            uniq.append(n_rows)
    w, m = kv._store["W"]._data, kv._updater.states["W"]._data
    res = {"W": w, "M": m, "head": torch.cat([
        kv._store["v"]._data.reshape(-1), kv._store["b"]._data]),
           "losses": losses, "times": times,
           "unique_rows": uniq, "worst": worst}
    if ref:
        errs = (sparse_rel(w[touched], sr.w[touched]),
                sparse_rel(m[touched], sr.m[touched]))
        check(max(errs) <= SPARSE_REL, "all touched rows of W and the "
              "momentum against the f64 recompute: %s" % (errs,))
        res["worst"] = max(worst, *errs)
        res["ambiguous"] = sr.ambiguous
        still = ~touched
        res["untouched"] = int(still.sum())
        check(torch.equal(w[still], w_init[still])
              and not bool(m[still].any()),
              "rows no gradient touched changed (W or momentum)")
    if measure:
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def sparse_dgl(card):
    """dgl_csr_neighbor_uniform_sample and dgl_subgraph on a graph whose
    components are on the card give the same call's output on CPU
    components, under one host_rng seed."""
    rng = np.random.RandomState(9)
    n, cols, indptr = 200, [], [0]
    for v in range(n):
        nbr = np.sort(rng.choice(np.setdiff1d(np.arange(n), [v]),
                                 rng.randint(1, 12), replace=False))
        cols.extend(nbr)
        indptr.append(len(cols))
    parts = (np.arange(1, len(cols) + 1, dtype=np.int64),
             np.array(cols, np.int64), np.array(indptr, np.int64))
    got = []
    for ctx in (mx.gpu(0), mx.cpu()):
        g = mx.nd.sparse.csr_matrix(parts, shape=(n, n), ctx=ctx)
        seeds = mx.nd.array(np.array([0, 17, 42], np.int64), ctx=ctx)
        mx.random.seed(5)
        sample = mx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            g, seeds, num_args=2, num_hops=2, num_neighbor=3,
            max_num_vertices=60)
        verts = mx.nd.array(np.arange(0, n, 3, dtype=np.int64), ctx=ctx)
        sub = mx.nd.contrib.dgl_subgraph(g, verts, num_args=2,
                                         return_mapping=True)
        arrays = []
        for o in sample + sub:
            check(o.context == ctx, "dgl output on %s, not %s"
                  % (o.context, ctx))
            arrays += ([o.data, o.indices, o.indptr] if o.stype == "csr"
                       else [o])
        got.append([a.asnumpy() for a in arrays])
    check(all(np.array_equal(a, b) for a, b in zip(*got)),
          "dgl: card components gave other output than CPU components")
    return len(got[0])


def phase_sparse(card):
    """Phase 20 (see the module doc)."""
    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    big = sparse_train(SPARSE, mx.gpu(0), seed=0, ref=True, measure=True)
    check(all(math.isfinite(v) for v in big["losses"]),
          "sparse losses %s" % big["losses"])
    small = [sparse_train(SPARSE_SMALL, ctx, seed=1)
             for ctx in (mx.gpu(0), mx.cpu())]
    small_err = max(sparse_rel(small[0][k].cpu(), small[1][k].double())
                    for k in ("W", "M", "head"))
    check(small_err <= SPARSE_REL, "sparse small case card vs CPU %g "
          "(bound %g)" % (small_err, SPARSE_REL))
    n_dgl = sparse_dgl(card)
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the sparse path launched %s"
          % launched)
    split = [1e3 * statistics.median(t[i] for t in big["times"])
             for i in range(4)]
    step_ms = statistics.median(1e3 * sum(t) for t in big["times"])
    print("sparse: %d x %d f32 table (KVStore device, SGD lr 0.1 momentum "
          "0.9 wd 1e-5 lazy_update), CSR batches of %d rows x %d Zipf(%g) "
          "features | step median %.2f ms (%d timed after %d warm-up): pull "
          "%.2f, forward dot %.2f, backward dot and cast %.2f, push with "
          "update %.2f ms | unique rows a batch %d-%d (median %d) | %.0f "
          "examples/s | peak %.2f GB | losses %.4f -> %.4f | f32 vs the f64 "
          "recompute worst %.3g relative (bound %g; %d pre-activations "
          "within rounding of 0 took the port's sign) | %d rows untouched "
          "bit-unchanged, pulled rows bit-exact, no RuntimeWarning | small "
          "case (%d x %d, batch %d, %d steps) card vs CPU %.3g | dgl on "
          "card components = CPU's (%d arrays) | hand-written kernels "
          "launched: none | phase %.1f s | %s"
          % (SPARSE["features"], SPARSE["width"], SPARSE["batch"],
             SPARSE_NNZ, SPARSE_ZIPF_A, step_ms, len(big["times"]),
             SPARSE_WARM, *split, min(big["unique_rows"]),
             max(big["unique_rows"]),
             statistics.median(big["unique_rows"]),
             SPARSE["batch"] / step_ms * 1e3, big["peak_gb"],
             big["losses"][0], big["losses"][-1], big["worst"], SPARSE_REL,
             big["ambiguous"], big["untouched"], SPARSE_SMALL["features"],
             SPARSE_SMALL["width"], SPARSE_SMALL["batch"],
             SPARSE_SMALL["steps"], small_err, n_dgl,
             time.perf_counter() - t_phase, card), flush=True)


# the interop phase (23): (a) upstream's custom_softmax example
# (example/numpy-ops/custom_softmax.py: softmax forward, p - onehot
# backward, no top gradient; its forward here is mx.nd.softmax, the
# example's numpy formula on the card) as resnet50_v1's loss head in the
# Executor at batch 64, 3 SGD steps (lr 0.01, rescale 1/64), deterministic
# cuDNN, against the same net with SoftmaxOutput: the probabilities, step
# 1's gradients, the updated weights and moving stats within
# INTEROP_REL x max|ref| (both heads compute p and p - onehot with the
# same kernels: 0 is expected), the logits' gradients of both heads
# against softmax(z) - onehot; the same op after a Dense(1000) in a
# hybridized block against eager; (b) resnet50_v1 to ONNX and back at
# batch 32, the imported graph's logits within INTEROP_ONNX_REL x
# max|ref| of the gluon forward (phase 10's card bound: BatchNorm's
# kernels differ between eager and the compiled graph); (c) the C ABI:
# the unchanged cpp/ clients against the port's library, test_predict at
# (1, 3, 224, 224) on the exported f32 net (printed logits within
# INTEROP_CAPI_REL x max|ref| + the print's rounding of the eager
# forward) and on phase 9b's int8 artifact at its batch 32 (printed
# logits equal; the whole output through the library's C calls bit-equal
# to the in-process int8 Predictor), INTEROP_TRIPS timed round trips of
# each through ctypes, test_api_train's MLP on the card; the references
# on torch's default cuDNN TF32 setting, which the workers keep; (d) rtc.
# The Executor's resnet50_v1 training graphs run on aot_eager
# (jit._BACKEND) for the script's time: inductor takes minutes for them.
# The hybridized Custom block and the api worker's Executor run on the
# default, inductor
INTEROP_BATCH, INTEROP_STEPS, INTEROP_LR = 64, 3, 0.01
INTEROP_ONNX_BATCH, INTEROP_TRIPS = 32, 10
INTEROP_REL, INTEROP_ONNX_REL, INTEROP_CAPI_REL = 1e-6, 1e-4, 1e-5
INTEROP_BACKEND = "aot_eager"
INTEROP_TIMEOUT_S = 600


@mx.operator.register("chip_softmax")
class ChipSoftmaxProp(mx.operator.CustomOpProp):
    """Upstream's custom_softmax (module doc's phase 23)."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return ChipSoftmax()


class ChipSoftmax(mx.operator.CustomOp):
    devices = set()    # the device types the user's forward was handed

    def forward(self, is_train, req, in_data, out_data, aux):
        ChipSoftmax.devices.add(in_data[0].context.device_type)
        self.assign(out_data[0], req[0], mx.nd.softmax(in_data[0], axis=-1))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        y = out_data[0]
        self.assign(in_grad[0], req[0],
                    y - mx.nd.one_hot(in_data[1], depth=y.shape[1]))


def interop_rel(got, ref):
    """max|got - ref| / max|ref| (f64), 0 for equal all-zero arrays."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    diff = float(np.abs(got - ref).max())
    return diff / scale if scale else diff


def interop_executor(sym, params, x, y):
    """``sym`` bound on the card with copies of ``params``, gradients for
    every parameter: (executor, arguments, gradients, aux states)."""
    dev = mx.gpu(0)
    args = {n: params[n].copy() for n in sym.list_arguments()
            if n in params}
    grads = {n: mx.nd.zeros(a.shape, ctx=dev) for n, a in args.items()}
    args.update(data=x, softmax_label=y)
    aux = {n: params[n].copy() for n in sym.list_auxiliary_states()}
    ex = sym.bind(dev, args=args, args_grad=grads, aux_states=aux,
                  grad_req={n: "write" if n in grads else "null"
                            for n in sym.list_arguments()})
    return ex, args, grads, aux


def interop_custom(card, net):
    """(a): the Custom head against SoftmaxOutput in the Executor, the
    logits' gradients, the hybridized block against eager."""
    dev = mx.gpu(0)
    s = mx.sym
    logits = net(s.var("data"))
    label = s.var("softmax_label")
    heads = {"custom": s.Custom(data=logits, label=label,
                                op_type="chip_softmax", name="softmax"),
             "softmax_output": s.SoftmaxOutput(logits, label,
                                               name="softmax")}
    params = {n: p.data() for n, p in net.collect_params().items()}
    rng = np.random.RandomState(23)
    x = mx.nd.array(rng.rand(INTEROP_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32), ctx=dev)
    y = mx.nd.array(rng.randint(0, 1000, INTEROP_BATCH).astype(np.float32),
                    ctx=dev)
    ChipSoftmax.devices.clear()
    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind, head in heads.items():
            sym = s.Group([head, s.BlockGrad(logits)])
            ex, args, grads, aux = interop_executor(sym, params, x, y)
            step_s, losses = [], []
            for step in range(INTEROP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prob, z = ex.forward(is_train=True)
                ex.backward()
                for n, g in grads.items():
                    mx.nd.sgd_update(args[n], g, lr=INTEROP_LR,
                                     rescale_grad=1.0 / INTEROP_BATCH)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                p = prob.asnumpy()
                losses.append(float(-np.log(np.maximum(p[np.arange(
                    INTEROP_BATCH), y.asnumpy().astype(int)], 1e-30))
                    .mean()))
                if step == 0:
                    first = {"prob": p, "z": z,
                             "grads": {n: g.asnumpy()
                                       for n, g in grads.items()}}
            runs[kind] = dict(first, losses=losses, step_s=step_s,
                              compile_s=ex.compile_seconds,
                              weights={n: args[n].asnumpy() for n in grads},
                              aux={n: a.asnumpy() for n, a in aux.items()})
            del ex, args, grads, aux
    finally:
        torch.backends.cudnn.deterministic = prev
    check(ChipSoftmax.devices == {"gpu"}, "custom: the user's forward was "
          "handed arrays on %s" % sorted(ChipSoftmax.devices))
    c, r = runs["custom"], runs["softmax_output"]
    check(all(math.isfinite(v) for v in c["losses"] + r["losses"]),
          "custom: losses %s %s" % (c["losses"], r["losses"]))
    errs = {"prob": interop_rel(c["prob"], r["prob"]),
            "grads": max(interop_rel(c["grads"][n], r["grads"][n])
                         for n in r["grads"]),
            "weights": max(interop_rel(c["weights"][n], r["weights"][n])
                           for n in r["weights"]),
            "aux": max(interop_rel(c["aux"][n], r["aux"][n])
                       for n in r["aux"])}
    for what, e in errs.items():
        check(e <= INTEROP_REL, "custom: %s %.3g x max|ref| from "
              "SoftmaxOutput's (bound %g)" % (what, e, INTEROP_REL))
    # the logits' gradients: each head alone on step 1's logits
    z = c["z"]
    onehot = F.one_hot(y._data.long(), 1000).float()
    dz_plain = (torch.softmax(z._data, -1) - onehot).cpu().numpy()
    dz = {}
    for kind in heads:
        zv = s.var("z")
        head = s.Custom(data=zv, label=label, op_type="chip_softmax") \
            if kind == "custom" else s.SoftmaxOutput(zv, label)
        g = mx.nd.zeros(z.shape, ctx=dev)
        ex = head.bind(dev, args={"z": z, "softmax_label": y},
                       args_grad={"z": g},
                       grad_req={"z": "write", "softmax_label": "null"})
        ex.forward(is_train=True)
        ex.backward()
        dz[kind] = g.asnumpy()
    dz_err = max(interop_rel(v, dz_plain) for v in dz.values())
    check(dz_err <= INTEROP_REL, "custom: the logits' gradients %.3g x "
          "max|ref| from softmax(z) - onehot" % dz_err)
    hyb = interop_custom_block()
    print("interop custom: upstream's custom_softmax as resnet50_v1's loss "
          "head (1000 classes, Xavier from seed 0) in the Executor, batch "
          "%d, %d SGD steps (lr %g), deterministic cuDNN, %s | against "
          "SoftmaxOutput: probabilities %.3g, step 1 gradients %.3g, "
          "updated weights %.3g, moving stats %.3g x max|ref| (bound %g) | "
          "logits' gradients of both heads against softmax(z) - onehot "
          "%.3g | the user's forward got %s arrays | losses Custom %s, "
          "SoftmaxOutput %s | step ms Custom %s, SoftmaxOutput %s (compile "
          "%.1f / %.1f s) | hybridized block on inductor against eager: "
          "outputs %.3g, gradients %.3g x max|ref|, graph breaks %d | %s"
          % (INTEROP_BATCH, INTEROP_STEPS, INTEROP_LR, INTEROP_BACKEND,
             errs["prob"], errs["grads"], errs["weights"], errs["aux"],
             INTEROP_REL, dz_err, "/".join(sorted(ChipSoftmax.devices)),
             ["%.4f" % v for v in c["losses"]],
             ["%.4f" % v for v in r["losses"]],
             ["%.1f" % (1e3 * t) for t in c["step_s"][1:]],
             ["%.1f" % (1e3 * t) for t in r["step_s"][1:]],
             c["compile_s"], r["compile_s"], hyb["out"], hyb["grad"],
             hyb["breaks"], card), flush=True)
    return {"prob_err": errs["prob"], "grad_err": errs["grads"],
            "weight_err": errs["weights"], "aux_err": errs["aux"],
            "dz_err": dz_err, "losses": c["losses"],
            "step_ms": [1e3 * t for t in c["step_s"]],
            "softmax_output_step_ms": [1e3 * t for t in r["step_s"]],
            "compile_s": c["compile_s"], "hybrid": hyb}


def interop_custom_block():
    """(a), gluon: Dense(1000) then the Custom head in a block, hybridized
    against eager on the same weights and batch."""
    from mxnet_tpu_torch.gluon import nn

    class Head(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc = nn.Dense(1000, in_units=2048)

        def hybrid_forward(self, F_, x, label):
            return F_.Custom(data=self.fc(x), label=label,
                             op_type="chip_softmax")

    dev = mx.gpu(0)
    rng = np.random.RandomState(24)
    w = (rng.randn(1000, 2048) * 0.02).astype(np.float32)
    b = np.zeros(1000, np.float32)
    x = mx.nd.array(rng.rand(INTEROP_BATCH, 2048).astype(np.float32),
                    ctx=dev)
    y = mx.nd.array(rng.randint(0, 1000, INTEROP_BATCH).astype(np.float32),
                    ctx=dev)
    res = []
    breaks = graph_breaks()
    prev_backend = mx.jit._BACKEND
    mx.jit._BACKEND = None   # inductor, the default
    try:
        for hybrid in (False, True):
            blk = Head()
            blk.initialize(ctx=dev)
            blk.fc.weight.set_data(mx.nd.array(w, ctx=dev))
            blk.fc.bias.set_data(mx.nd.array(b, ctx=dev))
            if hybrid:
                blk.hybridize()
            with mx.autograd.record():
                out = blk(x, y)
            out.backward()
            res.append((out.asnumpy(), blk.fc.weight.grad().asnumpy()))
    finally:
        mx.jit._BACKEND = prev_backend
    breaks = graph_breaks() - breaks
    out_err = interop_rel(res[1][0], res[0][0])
    grad_err = interop_rel(res[1][1], res[0][1])
    check(out_err <= INTEROP_REL and grad_err <= INTEROP_REL,
          "custom block: hybridized against eager, outputs %.3g, "
          "gradients %.3g x max|ref| (bound %g)" % (out_err, grad_err,
                                                   INTEROP_REL))
    check(breaks == 0, "custom block: %d graph breaks" % breaks)
    return {"out": out_err, "grad": grad_err, "breaks": breaks}


def interop_onnx(card, net, prefix):
    """(b): resnet50_v1 exported to ONNX, read back, imported and bound on
    the card, its logits against the gluon forward."""
    from mxnet_tpu_torch.contrib import onnx as onnx_mx

    dev = mx.gpu(0)
    sym = mx.sym.load(prefix + "-symbol.json")
    params = mx.nd.load(prefix + "-0000.params", ctx=dev)
    path = prefix + ".onnx"
    shape = (INTEROP_ONNX_BATCH, 3, IMAGE, IMAGE)
    t0 = time.perf_counter()
    onnx_mx.export_model(sym, params, shape, onnx_file_path=path)
    export_s = time.perf_counter() - t0
    meta = onnx_mx.get_model_metadata(path)
    check(meta["input_tensor_data"] == [("data", shape)] and
          [s for _, s in meta["output_tensor_data"]]
          == [(INTEROP_ONNX_BATCH, 1000)], "onnx: metadata %s" % meta)
    t0 = time.perf_counter()
    sym2, arg2, aux2 = onnx_mx.import_model(path)
    import_s = time.perf_counter() - t0
    ctxs = {str(a.context) for a in list(arg2.values())
            + list(aux2.values())}
    check(ctxs == {"gpu(0)"}, "onnx: imported parameters on %s" % ctxs)
    x = mx.nd.array(np.random.RandomState(25).rand(*shape)
                    .astype(np.float32), ctx=dev)
    ex = sym2.bind(dev, args=dict(arg2, data=x), aux_states=aux2,
                   grad_req="null")
    t0 = time.perf_counter()
    out = ex.forward()[0].asnumpy()
    first_s = time.perf_counter() - t0
    with mx.autograd.predict_mode():
        ref = net(x).asnumpy()
    err = interop_rel(out, ref)
    check(out.shape == ref.shape and err <= INTEROP_ONNX_REL,
          "onnx: imported logits %.3g x max|ref| from the gluon forward "
          "(bound %g)" % (err, INTEROP_ONNX_REL))
    onnx_ms = time_ms(lambda: ex.forward())
    with mx.autograd.predict_mode():
        gluon_ms = time_ms(lambda: net(x))
    nbytes = os.path.getsize(path)
    print("interop onnx: resnet50_v1 (1000 classes) export_model at %s: "
          "%d bytes, %d initializers read back, export %.2f s, import %.2f "
          "s | metadata %s -> %s | imported graph bound on the card "
          "(parameters on gpu(0)), logits %.3g x max|ref| of the gluon "
          "forward (bound %g), first call %.1f s | forward at batch %d: "
          "imported %.3f ms, gluon eager %.3f ms | %s"
          % (shape, nbytes, len(arg2) + len(aux2), export_s, import_s,
             meta["input_tensor_data"], meta["output_tensor_data"], err,
             INTEROP_ONNX_REL, first_s, INTEROP_ONNX_BATCH, onnx_ms,
             gluon_ms, card), flush=True)
    return {"bytes": nbytes, "export_s": export_s, "import_s": import_s,
            "logit_err": err, "onnx_fwd_ms": onnx_ms,
            "gluon_fwd_ms": gluon_ms}


def capi_bind(lib):
    """The predict ABI's C calls (cpp/mxtpu_predict.h) on ``lib``."""
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mxtpu_predict_create.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_char_p), u32p, u32p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.mxtpu_predict_set_input.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.mxtpu_predict_forward.argtypes = [ctypes.c_void_p]
    lib.mxtpu_predict_get_output.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
    lib.mxtpu_predict_free.argtypes = [ctypes.c_void_p]
    lib.mxtpu_predict_last_error.restype = ctypes.c_char_p
    return lib


def capi_session(lib, files, x, n_out, stats):
    """One predictor through the library's C calls on ``files`` (symbol
    json, params) for ``x``: (its output, the round trips' ms (set input,
    forward, get output), the worker's record from ``stats``)."""
    sym_json = open(files[0], "rb").read()
    params = open(files[1], "rb").read()
    shape = (ctypes.c_uint32 * x.ndim)(*x.shape)
    indptr = (ctypes.c_uint32 * 2)(0, x.ndim)
    keys = (ctypes.c_char_p * 1)(b"data")
    h = ctypes.c_void_p()
    prev = os.environ.get("MXTPU_WORKER_STATS")
    os.environ["MXTPU_WORKER_STATS"] = stats
    try:
        check(lib.mxtpu_predict_create(sym_json, params, len(params), 1,
                                       keys, indptr, shape,
                                       ctypes.byref(h)) == 0,
              "capi: create failed: %s" % lib.mxtpu_predict_last_error())
    finally:
        if prev is None:
            os.environ.pop("MXTPU_WORKER_STATS")
        else:
            os.environ["MXTPU_WORKER_STATS"] = prev
    out = np.empty(n_out, np.float32)
    x = np.ascontiguousarray(x)

    def trip():
        check(lib.mxtpu_predict_set_input(h, b"data", x.ctypes.data,
                                          x.size) == 0 and
              lib.mxtpu_predict_forward(h) == 0 and
              lib.mxtpu_predict_get_output(h, 0, out.ctypes.data,
                                           out.size) == 0,
              "capi: round trip failed: %s" % lib.mxtpu_predict_last_error())

    try:
        trip()
        ms = []
        for _ in range(INTEROP_TRIPS):
            t0 = time.perf_counter()
            trip()
            ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        lib.mxtpu_predict_free(h)
    with open(stats) as f:
        rec = json.loads(f.read().strip().splitlines()[-1])
    return out.copy(), ms, rec


def capi_printed(stdout):
    """test_predict's TOP1 index and score and its three logits, as
    printed."""
    lines = dict(ln.split(" ", 1) for ln in stdout.splitlines()
                 if " " in ln)
    top1, score = lines["TOP1"].split()
    return int(top1), score, lines["LOGITS"].split()


def capi_start(argv, env, stats):
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(env, MXTPU_WORKER_STATS=stats))


def capi_wait(proc, what):
    out, err = proc.communicate(timeout=INTEROP_TIMEOUT_S)
    check(proc.returncode == 0, "capi: %s exited %d: %s %s"
          % (what, proc.returncode, out[-1000:], err[-2000:]))
    return out


def interop_capi(card, net, prefix, art, root):
    """(c): the unchanged clients against the port's library on the
    card, the C calls' round trips, the int8 artifact bit-equal to the
    in-process Predictor.  Returns the numbers and the int8_conv
    launches the workers made."""
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.contrib import quantization as tq
    from mxnet_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    lib_path = native.capi_library()
    clients = {n: str(native.capi_client(n))
               for n in ("test_predict", "test_api_train")}
    build_s = time.perf_counter() - t0
    lib = capi_bind(ctypes.CDLL(str(lib_path)))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXTPU_PYTHON=sys.executable,
               PYTHONPATH=os.pathsep.join(
                   [here] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    env.pop("MXTPU_PREDICT_CPU", None)
    env.pop("MXTPU_API_CPU", None)
    rng = np.random.RandomState(26)
    x1 = rng.rand(1, 3, IMAGE, IMAGE).astype(np.float32)
    qsym, qargs, qaux, meta = tq.load_artifact(art)
    xq = rng.rand(*meta["data_shape"]).astype(np.float32)
    files = {"f32": (prefix + "-symbol.json", prefix + "-0000.params"),
             "int8": tuple(os.path.join(art, "%s%s" % (
                 tq.ARTIFACT_PREFIX, sfx)) for sfx in ("-symbol.json",
                                                      "-0000.params"))}
    inputs = {"f32": os.path.join(root, "x1.f32"),
              "int8": os.path.join(root, "xq.f32")}
    x1.tofile(inputs["f32"])
    xq.tofile(inputs["int8"])
    data = mx.sym.var("data")
    mlp = mx.sym.LinearRegressionOutput(mx.sym.FullyConnected(
        mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=16,
                                                name="fc1"),
                          act_type="relu", name="relu1"),
        num_hidden=1, name="fc2"), mx.sym.var("label"), name="lro")
    mlp_json = os.path.join(root, "mlp-symbol.json")
    mlp.save(mlp_json)
    stats = {k: os.path.join(root, "stats_%s.jsonl" % k)
             for k in ("f32", "int8", "train", "f32_c", "int8_c")}
    t_clients = time.perf_counter()
    procs = {k: capi_start([clients["test_predict"], *files[k], inputs[k],
                            *[str(d) for d in (x1 if k == "f32"
                                               else xq).shape]],
                           env, stats[k]) for k in ("f32", "int8")}
    procs["train"] = capi_start([clients["test_api_train"], mlp_json], env,
                                stats["train"])
    try:
        # the in-process references, on the workers' cuDNN TF32 setting
        prev_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            def eager_f32():
                with mx.autograd.predict_mode():
                    return net(mx.nd.array(x1, ctx=mx.gpu(0))).asnumpy()

            ref1 = eager_f32()
            pred = Predictor.from_symbol(
                qsym, qargs, qaux, data_name=meta["data_name"], chain=1,
                batch_shape=tuple(meta["data_shape"]),
                batch_dtype=meta["data_dtype"], aot_policy_tag="int8")
            ref_before = kernels.launch_counts["int8_conv"]
            refq = list(pred.predict([xq]))[0]
            # the clients first: the timings below have the card to
            # themselves (within this process)
            outs = {k: capi_wait(p, k) for k, p in procs.items()}
            clients_s = time.perf_counter() - t_clients
            eager_ms, pred_ms = [], []
            for fn, acc in ((eager_f32, eager_ms),
                            (lambda: list(pred.predict([xq])), pred_ms)):
                fn()
                for _ in range(INTEROP_TRIPS):
                    t0 = time.perf_counter()
                    fn()
                    acc.append(1e3 * (time.perf_counter() - t0))
            ref_launches = kernels.launch_counts["int8_conv"] - ref_before
            out1, trip1, rec1 = capi_session(lib, files["f32"], x1, 1000,
                                             stats["f32_c"])
            outq, tripq, recq = capi_session(lib, files["int8"], xq,
                                             refq.size, stats["int8_c"])
        finally:
            torch.backends.cudnn.allow_tf32 = prev_tf32
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    # test_predict on the f32 net: its printed top-1 and logits
    top1, score, logits = capi_printed(outs["f32"])
    r1 = ref1.ravel()
    tol = INTEROP_CAPI_REL * float(np.abs(r1).max()) + 5e-7
    check(top1 == int(np.argmax(r1)) and
          abs(float(score) - float(r1.max())) <= tol and
          max(abs(float(v) - float(r)) for v, r in zip(logits, r1[:3]))
          <= tol, "capi: test_predict f32 TOP1 %d %s LOGITS %s against "
          "%d %.6f %s" % (top1, score, logits, int(np.argmax(r1)), r1.max(),
                          r1[:3]))
    err1 = interop_rel(out1, r1)
    check(err1 <= INTEROP_CAPI_REL, "capi: f32 output through the C calls "
          "%.3g x max|ref| of the eager forward" % err1)
    # the int8 artifact: printed as the Predictor's values print, and the
    # whole output bit-equal
    rq = refq.ravel()
    topq, scoreq, logitsq = capi_printed(outs["int8"])
    check(topq == int(np.argmax(rq)) and scoreq == "%.6f" % rq.max() and
          logitsq == ["%.6f" % v for v in rq[:3]],
          "capi: test_predict int8 TOP1 %d %s LOGITS %s against the "
          "Predictor's %d %.6f %s" % (topq, scoreq, logitsq,
                                      int(np.argmax(rq)), rq.max(), rq[:3]))
    check(np.array_equal(outq, rq), "capi: int8 output through the C calls "
          "differs from the in-process Predictor in %d of %d"
          % (int((outq != rq).sum()), rq.size))
    # test_api_train: the MLP trained through the api worker on the card
    lines = outs["train"].splitlines()
    done = [ln for ln in lines if ln.startswith("TRAIN OK")]
    check(done and any(ln.startswith("INFER n_args=6 n_outs=1")
                       for ln in lines), "capi: test_api_train: %s"
          % outs["train"][-500:])
    first = float(done[0].split("first=")[1].split()[0])
    last = float(done[0].split("last=")[1])
    check(last < first / 10.0, "capi: MLP loss %g -> %g" % (first, last))
    # the workers' records: their own process's kernel launches
    recs = {k: json.loads(open(stats[k]).read().strip().splitlines()[-1])
            for k in ("f32", "int8", "train")}
    recs.update(f32_c=rec1, int8_c=recq)
    n_q = meta["quantized_layers"]
    forwards = {k: len(r["op_ms"].get("1", [])) + len(r["op_ms"].get(
        "3", [])) for k, r in recs.items() if k != "train"}
    launched = {k: r["launches"].get("int8_conv", 0)
                for k, r in recs.items()}
    for k in ("int8", "int8_c"):
        check(launched[k] == n_q * forwards[k], "capi: the %s worker "
              "launched int8_conv %d times over %d forwards of %d quantized "
              "layers" % (k, launched[k], forwards[k], n_q))
    others = {k: {n: c for n, c in r["launches"].items()
                  if c and not (n == "int8_conv" and k.startswith("int8"))}
              for k, r in recs.items()}
    check(not any(others.values()), "capi: workers launched %s" % others)
    nums = {"build_s": build_s, "clients_s": clients_s,
            "f32_trip_ms": statistics.median(trip1),
            "f32_eager_ms": statistics.median(eager_ms),
            "int8_trip_ms": statistics.median(tripq),
            "int8_predictor_ms": statistics.median(pred_ms),
            "f32_err": err1, "mlp_loss": [first, last],
            "int8_conv_launches": launched["int8"] + launched["int8_c"],
            "reference_int8_conv": ref_launches,
            "worker_fwd_ms": {k: statistics.median(recs[k]["op_ms"]["3"])
                              for k in ("f32_c", "int8_c")}}
    print("interop capi: the port's libmxtpu_runtime.so and the unchanged "
          "cpp/ clients built in %.1f s | test_predict f32 resnet50_v1 "
          "%s on the card: TOP1 %d = eager's, logits within "
          "%g x max|ref| + 5e-7 | int8 artifact (%d quantized layers) at "
          "%s: printed TOP1 and logits = the in-process Predictor's, the "
          "whole output through the C calls bit-equal | test_api_train's "
          "MLP on the card: loss %.6f -> %.6f | round trips (set input, "
          "forward, get output; median of %d) f32 %.2f ms against the "
          "eager forward from the host %.2f ms, int8 %.2f ms against the "
          "Predictor %.2f ms | int8_conv launches in the workers %d (%s; "
          "the in-process reference's %d apart) | the three clients' wall "
          "%.1f s | %s"
          % (build_s, x1.shape, top1, INTEROP_CAPI_REL, n_q,
             tuple(meta["data_shape"]),
             first, last, INTEROP_TRIPS, nums["f32_trip_ms"],
             nums["f32_eager_ms"], nums["int8_trip_ms"],
             nums["int8_predictor_ms"], nums["int8_conv_launches"],
             ", ".join("%s %d over %d forwards" % (k, launched[k],
                                                   forwards[k])
                       for k in ("int8", "int8_c")), ref_launches,
             clients_s, card),
          flush=True)
    return nums, nums["int8_conv_launches"]


def interop_rtc(card):
    """(d): a CudaModule kernel on card tensors against the function
    called directly; CUDA source refused."""
    def axpy(a, x, y):
        return a * x + y

    rng = np.random.RandomState(27)
    a, x, y = (mx.nd.array(rng.randn(1 << 20).astype(np.float32),
                           ctx=mx.gpu(0)) for _ in range(3))
    k = mx.rtc.CudaModule(kernels={"axpy": axpy}).get_kernel("axpy")
    got = k.launch([a, x, y], mx.gpu(0), (1, 1, 1), (256, 1, 1))
    want = axpy(a._data, x._data, y._data)
    check(got._data.is_cuda and torch.equal(got._data, want),
          "rtc: the kernel's output differs from the function's")
    try:
        mx.rtc.CudaModule("extern \"C\" __global__ void k(float *x) {}")
        refused = False
    except mx.base.MXNetError:
        refused = True
    check(refused, "rtc: CUDA source was not refused")
    print("interop rtc: CudaModule(kernels={'axpy': fn}) launched on 2^20 "
          "card elements, bit-equal to the function called directly | CUDA "
          "C source refused with MXNetError | %s" % card, flush=True)


def phase_interop(card, art=None):
    """Phase 23 (module doc): (a) Custom, (b) ONNX, (c) the C ABI, (d) rtc.
    ``art`` is phase 9b's int8 artifact; alone, the phase makes its own
    with quantize_model.  Returns the int8_conv launches of its path (the
    workers')."""
    t_phase = time.perf_counter()
    before = dict(kernels.launch_counts)
    prev_backend = mx.jit._BACKEND
    mx.jit._BACKEND = INTEROP_BACKEND
    root = tempfile.mkdtemp(prefix="interop_")
    proc = None
    try:
        if art is None:
            proc, art, t_cli = serve_quantize_start(root)
        net = serve_net()
        with mx.autograd.predict_mode():
            net(mx.nd.zeros((1, 3, IMAGE, IMAGE), ctx=mx.gpu(0)))
        prefix = os.path.join(root, "resnet50_v1")
        net.export(prefix)
        if proc is not None:
            serve_quantize_finish(card, proc, art, t_cli)
        t = {}
        t0 = time.perf_counter()
        custom = interop_custom(card, net)
        t["custom"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        onnx_nums = interop_onnx(card, net, prefix)
        t["onnx"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        capi, capi_launches = interop_capi(card, net, prefix, art, root)
        t["capi"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        interop_rtc(card)
        t["rtc"] = time.perf_counter() - t0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
        mx.jit._BACKEND = prev_backend
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    # in this process only the in-process int8 Predictor, the reference
    # the C ABI is held against, launches a kernel
    check(launched.pop("int8_conv") == capi["reference_int8_conv"]
          and not any(launched.values()), "interop: this process launched "
          "%s beside the reference's %d int8_conv"
          % (launched, capi["reference_int8_conv"]))
    line = {"custom": custom, "onnx": onnx_nums, "capi": capi,
            "seconds": t, "phase_s": time.perf_counter() - t_phase,
            "card": card}
    print("interop " + json.dumps(line), flush=True)
    return capi_launches


def time_flash(shape, dtype, causal, card):
    q, k, v = flash_inputs(shape, dtype, 5)
    scale = shape[-1] ** -0.5
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    def kern():
        return kernels.flash_attention_fwd(q, k, v, scale, causal)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    ms, library_ms = time_ms(kern), time_ms(sdpa)
    plain_ms = time_ms(lambda: flash_plain(q, k, v, causal))
    run_ms, library_run_ms = time_ms(kern, RUN), time_ms(sdpa, RUN)
    bms, by = flash_bound_ms(shape, dtype, causal)
    name = "f32" if dtype == torch.float32 else "bf16"
    kernel = kernels.flash_kernel(dtype, shape[-1])
    res = {"shape": list(shape), "dtype": name, "causal": causal,
           "kernel": kernel, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "run_ms": run_ms, "library_run_ms": library_run_ms}
    extra = ""
    if dtype == torch.bfloat16 and kernel == "flash_attention":
        # bf16 on the CUDA cores: also the bound at the f32 rate
        res["f32_rate_bound_ms"] = flash_bound_ms(shape, torch.float32,
                                                  causal)[0]
        extra = ", %.1f%% of the bound at the f32 rate (%.4f ms)" % (
            100 * res["f32_rate_bound_ms"] / ms, res["f32_rate_bound_ms"])
    print("flash time: %s %s causal=%s on %s | kernel %.4f ms, plain %.4f "
          "ms, sdpa %.4f ms, bound %.4f ms (%s), kernel at %.1f%% of the "
          "bound%s | in runs of %d calls: kernel %.4f ms, sdpa %.4f ms | %s"
          % (name, shape, causal, kernel, ms, plain_ms, library_ms, bms, by,
             100 * bms / ms, extra, RUN, run_ms, library_run_ms, card),
          flush=True)
    return res


def main():
    t_start = time.perf_counter()
    laps = []        # (phase, seconds since the previous lap)

    def lap(name):
        laps.append((name, time.perf_counter() - t_start
                     - sum(t for _, t in laps)))

    card = phase_device()
    phase_build()
    lap("1-2")
    net, trainable = build_resnet50()
    n_resnet = sum(p.data().size for p in trainable)
    worst3, flat = phase_kernels(n_resnet, card)
    launches, worst4, step_inputs, ts_s = phase_slice(net, trainable, card)
    small_err = check_small_net_against_cpu()
    print("reference: small ResNet logits card vs CPU max |diff| %.3g"
          % small_err, flush=True)
    timing = time_step_set(step_inputs, card)
    del net, trainable, step_inputs
    torch.cuda.empty_cache()
    lap("3-4")
    phase_sharded(card)
    check_small_sharded()
    torch.cuda.empty_cache()
    lap("7")
    flash_worst, flash_share = phase_flash(card)
    sp_launches, sp_worst, sp_share, sp_times = phase_sp(card)
    torch.cuda.empty_cache()
    lap("5-6")
    lm, ring = phase_decode(card)
    torch.cuda.empty_cache()
    lap("8")
    phase_paged(card, lm, ring)
    del ring
    torch.cuda.empty_cache()
    lap("9")
    art_root = tempfile.mkdtemp(prefix="interop_art_")
    atexit.register(shutil.rmtree, art_root, True)
    int8_art = os.path.join(art_root, "resnet50_int8")
    serve_launches = phase_serve(card, lm, keep_art=int8_art)
    del lm
    torch.cuda.empty_cache()
    lap("9b")
    phase_zoo(card)
    torch.cuda.empty_cache()
    lap("10")
    phase_imperative(card)
    torch.cuda.empty_cache()
    lap("11")
    phase_data(card)
    torch.cuda.empty_cache()
    lap("12")
    side, jobs, warm = SideChecks("--side"), DistJobs(), WarmCompile()
    interop = SideChecks("--interop", int8_art)
    examples = SideChecks("--examples")
    try:
        # phase 13's squeezenet and export check (inductor's compiles,
        # the least measurement), phase 23, and phase 14's bucketing with
        # phase 21d's fine-tuning, each in a process of its own beside
        # phases 13-15
        side.start(card)
        interop.start(card)
        examples.start(card)
        sym_row = phase_symbolic(card, aside=True)
        torch.cuda.empty_cache()
        # phase 21c: a second process compiles phase 13's resnet from the
        # cache, beside phases 14-15
        warm.start(card, sym_row)
        lap("13")
        phase_recurrent(card, aside=True)
        torch.cuda.empty_cache()
        phase_fusion(card)
        torch.cuda.empty_cache()
        side.finish()
        examples.finish()
        warm.finish()
        capi_launches = int(re.search(r"^INTEROP_LAUNCHES (\d+)$",
                                      interop.finish(), re.M).group(1))
        shutil.rmtree(art_root, ignore_errors=True)
        lap("14-15")
        # phase 17's workers import during phase 16's small case
        det_rows = phase_detection(card, after_timed=jobs.start)
        torch.cuda.empty_cache()
        lap("16")
        dist_launches, dist_worst = phase_dist(card, jobs)
        lap("17")
    finally:
        side.stop()
        interop.stop()
        examples.stop()
        jobs.stop()
        warm.stop()
    rows = []
    for name in ("quantize_2bit", "dequantize_2bit"):
        t = timing[name]
        rows.append(dict({
            "name": name, "route": "cuda", "source": SOURCE,
            # phase 4's one-process pushes and phase 17's, each worker's
            "replaces": REPLACES[name],
            "launches": launches[name] + sum(dist_launches[name]),
            "slice_launches": launches[name],
            "dist_launches": dist_launches[name],
            "max_abs_err": max(worst3, worst4, dist_worst), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "call_ms": t["call_ms"], "launches_per_step": 1,
            "entries": t["entries"], "blocks": t["blocks"],
            "elements": t["elements"],
            "padded_elements": t["padded_elements"],
            "trainer_step_s": ts_s, "card": card}, **flat[name]))
    # f32 inputs and bf16 past D 256 run flash_attention.cu: its row's
    # times also hold the wide head dim in both types
    wide_times = [time_flash(WIDE_TIME_SHAPE, dtype, False, card)
                  for dtype in (torch.float32, torch.bfloat16)]
    for dtype in (torch.float32, torch.bfloat16):
        kernel = kernels.flash_kernel(dtype, LONG_SHAPE[-1])
        # the sp path's shape first: long context, non-causal
        times = [time_flash(shape, dtype, causal, card)
                 for shape, causal in ((LONG_SHAPE, False),
                                       (LM_SHAPE, False), (LM_SHAPE, True))]
        if kernel == "flash_attention":
            times += wide_times
        main_path = times[0]
        row = {
            "name": kernel, "route": "cuda", "source": FLASH_SOURCES[kernel],
            "replaces": FLASH_REPLACES, "launches": sp_launches[kernel],
            "max_abs_err": max(flash_worst[kernel, dtype], sp_worst[dtype]),
            "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"],
            "bound_by": main_path["bound_by"],
            "library_ms": main_path["library_ms"],
            "shape": main_path["shape"], "dtype": str(dtype)[6:],
            "causal": False, "engine_ms": sp_times[dtype],
            "times": times[1:], "card": card}
        if dtype == torch.bfloat16:
            row["bf16_bound_share"] = max(flash_share[kernel, dtype],
                                          sp_share)
        else:  # the wide head dims in bf16 ran this kernel too
            row["bf16_max_abs_err"] = flash_worst[kernel, torch.bfloat16]
            row["bf16_bound_share"] = flash_share[kernel, torch.bfloat16]
        rows.append(row)
    # the int8_conv row: phase 16's launches and the serving path's
    det_rows[0]["det_launches"] = det_rows[0]["launches"]
    det_rows[0]["serve_launches"] = serve_launches
    det_rows[0]["launches"] += serve_launches
    # phase 23's C ABI workers serve the same artifact on the same kernel
    det_rows[0]["capi_launches"] = capi_launches
    det_rows[0]["launches"] += capi_launches
    rows += det_rows
    phase_observe(card)
    lap("18-19")
    phase_sparse(card)
    torch.cuda.empty_cache()
    lap("20")
    phase_remat(card)
    torch.cuda.empty_cache()
    lap("21")
    phase_checkpoint(card)
    torch.cuda.empty_cache()
    lap("22")
    print("wall: the whole script %.1f s (by phase: %s) | %s"
          % (time.perf_counter() - t_start,
             ", ".join("%s %.1f" % lp for lp in laps), card), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--side"]:
        side_main(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--interop"]:
        interop_main(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--examples"]:
        examples_main(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--warm-compile"]:
        warm_main(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    main()
