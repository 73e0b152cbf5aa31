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
   ulysses_attention_sharded(use_flash=True) and shard_map(ring_attention,
   use_flash=True) at the long context in f32 and in bf16, each within
   the kernel's bound of local_attention on the same values in f32 (5e-5
   in f32, the elementwise bf16 bound in bf16) and each call launching
   its type's kernel exactly once;
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
   deterministic cuDNN;
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
   tokens; tests/test_generate.py's small LM gives the same f32 logits
   (within 1e-5 of the largest) and greedy tokens on the card as on the
   CPU; the path launches no hand-written kernel.  A 'decode' line per
   policy: prefill ms per admit (median), step ms (median), tokens/s
   (16 x steps / their time), the profile of 8 more steps (kernels a
   step, the card's kernel time against the host's step, idle share),
   peak memory;
9. flash times: each kernel, the plain version and
   scaled_dot_product_attention (timed only, as the yardstick) beside the
   bound, at the long context and the LM shape, and the wide head dim
   (1, 4096, 4, 512) in both types on flash_attention.cu; kernel and SDPA
   also per call in runs of 10 calls, which leaves out the host's time;
10. a {"kernels": [...]} line;
11. last line: {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero.
"""
import functools
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import generate, kernels, parallel
from mxnet_tpu_torch.contrib import compression as comp
from mxnet_tpu_torch.examples.transformer_lm import TransformerLM
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.ops import attention as attn

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
    trainer.close()
    return {"sync_ips": sync_ips, "async_ips": async_ips}


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
    mesh = parallel.make_mesh({"sp": 1})
    spec = parallel.P(None, "sp", None, None)
    ring = parallel.shard_map(
        functools.partial(parallel.ring_attention, axis_name="sp",
                          use_flash=True),
        mesh, (spec, spec, spec), spec)
    inputs = {dtype: flash_inputs(LONG_SHAPE, dtype, 7)
              for dtype in (torch.float32, torch.bfloat16)}
    engines = (("ulysses", functools.partial(
                    parallel.ulysses_attention_sharded, mesh, use_flash=True)),
               ("ring", ring))
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
    print("sp: launches %s (one per engine call per type) | %s"
          % (launches, card), flush=True)
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
    t0 = time.perf_counter()
    with generate.TokenServer(eng, queue_depth=DECODE_SLOTS) as srv:
        futs = [srv.submit(p, max_new_tokens=SERVER_NEW) for p in prompts]
        results = [f.result(timeout=120) for f in futs]
    server_s = time.perf_counter() - t0
    for i, r in enumerate(results):
        check(r.finish_reason == "length" and len(r.tokens) == SERVER_NEW,
              "request %d finished %s with %d tokens"
              % (i, r.finish_reason, len(r.tokens)))
        check(r.tokens == toks16[i][:SERVER_NEW], "request %d: server tokens "
              "differ from the engine's alone" % i)
    print("decode server: TokenServer over the bf16_mixed engine, %d "
          "requests of max_new_tokens %d: all 'length', tokens equal to the "
          "engine's alone | %.3f s, %.1f tokens/s, ttft s median %.4f | %s"
          % (len(results), SERVER_NEW, server_s,
             len(results) * SERVER_NEW / server_s,
             statistics.median(r.ttft_s for r in results), card), flush=True)
    del eng

    rel = check_small_lm_against_cpu()
    launched = {n: c - before[n] for n, c in kernels.launch_counts.items()}
    check(not any(launched.values()), "the decode path launched %s"
          % launched)
    print("decode reference: small LM %s card vs CPU logits max|d| %.3g of "
          "max|logit| (limit %g), greedy tokens equal | hand-written kernels "
          "launched on the decode path: %s (none is on it) | %s"
          % (SMALL_LM, rel, SMALL_LM_RTOL, launched, card), flush=True)


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
    card = phase_device()
    phase_build()
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
    phase_sharded(card)
    check_small_sharded()
    torch.cuda.empty_cache()
    flash_worst, flash_share = phase_flash(card)
    sp_launches, sp_worst, sp_share, sp_times = phase_sp(card)
    torch.cuda.empty_cache()
    phase_decode(card)
    torch.cuda.empty_cache()
    rows = []
    for name in ("quantize_2bit", "dequantize_2bit"):
        t = timing[name]
        rows.append(dict({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(worst3, worst4), "ms": t["ms"],
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    main()
